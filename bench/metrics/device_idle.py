"""device_idle: percent of the traced window in which no operation ran on
the device (the union of the profiler's device intervals).  Read as
``device_idle.count`` and ``device_idle.list``."""


def read(ctx):
    dev = ctx.device
    if dev is None or not dev.op_n:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
