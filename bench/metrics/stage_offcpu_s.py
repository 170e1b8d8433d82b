"""stage_offcpu_s: seconds per query that the consumer thread spent off
the CPU inside the program's ``device/stage`` spans: the spans' wall less
their thread-CPU time (``cpu``), that is GIL and lock waits, blocking CUDA
calls and descheduling.  Read as ``stage_offcpu_s.count``."""


def read(ctx):
    ns = [ev["dur"] - ev["cpu"] for ev in ctx.spans
          if ev["name"] == "device/stage" and "cpu" in ev]
    total = sum(ns) / 1e9
    return total / len(ctx.queries) if ctx.queries and total > 0 else None
