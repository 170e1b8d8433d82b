"""setup_s: process start to the first timed query (host clock): imports,
the kernel library, the graph, the plan and the warm-up query."""


def read(ctx):
    return ctx.setup_s
