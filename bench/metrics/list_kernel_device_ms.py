"""list_kernel_device_ms: device milliseconds per query of the list
kernel, ``clique_list_tiles`` (emit and scan passes), from the profiler."""

KERNELS = ("list_emit_kernel", "list_scan_kernel", "list_emit_wide")


def read(ctx):
    if ctx.device is None or not ctx.queries:
        return None
    seconds, events = ctx.device.device_s(KERNELS)
    return 1e3 * seconds / len(ctx.queries) if events else None
