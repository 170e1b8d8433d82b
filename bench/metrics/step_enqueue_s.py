"""step_enqueue_s: seconds per query inside the program's ``count/step``
spans, the consumer's enqueue of each batch's count step (the 2-plex
statistics, the DFS kernel's launch and the copies back).  Read as
``step_enqueue_s.count``."""


def read(ctx):
    ns = [ev["dur"] for ev in ctx.spans if ev["name"] == "count/step"]
    return sum(ns) / 1e9 / len(ctx.queries) if ns and ctx.queries else None
