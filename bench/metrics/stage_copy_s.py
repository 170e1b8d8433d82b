"""stage_copy_s: seconds per query inside the program's ``stage/copy``
spans, the consumer's staging of each batch onto its lane (pinning and the
copies to the device).  Read as ``stage_copy_s.count``."""


def read(ctx):
    ns = [ev["dur"] for ev in ctx.spans if ev["name"] == "stage/copy"]
    return sum(ns) / 1e9 / len(ctx.queries) if ns and ctx.queries else None
