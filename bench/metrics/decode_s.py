"""decode_s: seconds per query inside the program's ``decode`` spans
(``repro_torch.obs.trace``), the host's decode of kernel rows.  Read as
``decode_s.list``."""


def read(ctx):
    ns = [ev["dur"] for ev in ctx.spans if ev["name"] == "decode"]
    return sum(ns) / 1e9 / len(ctx.queries) if ns and ctx.queries else None
