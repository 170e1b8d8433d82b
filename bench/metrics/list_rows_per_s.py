"""list_rows_per_s: clique rows delivered by the window's whole list
queries over the window's seconds (host clock)."""


def read(ctx):
    rows = sum(len(q.rows) for q in ctx.queries if q.rows is not None)
    return rows / ctx.window_s if rows else None
