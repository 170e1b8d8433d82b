"""frontend_worker_s: the front end's extract and pack seconds per query,
summed over its pack workers (``Stats.frontend_s``).  Read as
``frontend_worker_s.count`` and ``frontend_worker_s.list``."""


def read(ctx):
    done = [q.stats.frontend_s for q in ctx.queries if q.stats is not None]
    return sum(done) / len(done) if done else None
