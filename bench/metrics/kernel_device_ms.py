"""kernel_device_ms: device milliseconds per query between the CUDA
timing events that the program's dispatchers record around each kernel
call (``Stats.kernel_device_s``; 0 on CPU lanes).  Read as
``kernel_device_ms.count``."""


def read(ctx):
    done = [getattr(q.stats, "kernel_device_s", 0.0) for q in ctx.queries
            if q.stats is not None]
    total = sum(done)
    return 1e3 * total / len(done) if total > 0 else None
