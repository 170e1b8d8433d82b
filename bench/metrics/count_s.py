"""count_s: the window's seconds over the whole count queries it held
(host clock): the time to an exact whole-graph count."""


def read(ctx):
    return ctx.window_s / len(ctx.queries) if ctx.queries else None
