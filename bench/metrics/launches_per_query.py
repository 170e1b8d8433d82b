"""launches_per_query: kernel launches per query, from the program's
launch counters (``kernels.ops.launch_counts``), reset before the window.
Read as ``launches_per_query.count`` and ``launches_per_query.list``."""


def read(ctx):
    if not ctx.queries:
        return None
    total = sum(q.launches for q in ctx.queries)
    return total / len(ctx.queries) if total else None
