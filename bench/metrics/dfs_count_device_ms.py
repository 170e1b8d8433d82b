"""dfs_count_device_ms: device milliseconds per query of the DFS count
kernel, ``clique_count_tiles`` (its branch and item passes), from the
profiler."""

KERNELS = ("branch_kernel", "item_kernel", "branch_wide", "item_wide")


def read(ctx):
    if ctx.device is None or not ctx.queries:
        return None
    seconds, events = ctx.device.device_s(KERNELS)
    return 1e3 * seconds / len(ctx.queries) if events else None
