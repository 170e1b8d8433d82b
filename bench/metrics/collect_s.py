"""collect_s: seconds per query inside the program's ``list/collect``
spans, the front door's gathering of a listing's rows into one array.
Read as ``collect_s.list``."""


def read(ctx):
    ns = [ev["dur"] for ev in ctx.spans if ev["name"] == "list/collect"]
    return sum(ns) / 1e9 / len(ctx.queries) if ns and ctx.queries else None
