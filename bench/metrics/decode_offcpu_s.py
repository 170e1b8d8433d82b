"""decode_offcpu_s: seconds per query that the decode worker spent off
the CPU inside the program's ``decode`` spans: the spans' wall less their
thread-CPU time (``cpu``).  Read as ``decode_offcpu_s.list``."""


def read(ctx):
    ns = [ev["dur"] - ev["cpu"] for ev in ctx.spans
          if ev["name"] == "decode" and "cpu" in ev]
    total = sum(ns) / 1e9
    return total / len(ctx.queries) if ctx.queries and total > 0 else None
