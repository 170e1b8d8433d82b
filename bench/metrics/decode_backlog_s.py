"""decode_backlog_s: seconds per query that the listing consumer blocked
on the decode worker's backlog and its final drain
(``Stats.decode_backlog_s``).  Read as ``decode_backlog_s.list``."""


def read(ctx):
    done = [getattr(q.stats, "decode_backlog_s", 0.0) for q in ctx.queries
            if q.stats is not None]
    total = sum(done)
    return total / len(done) if total > 0 else None
