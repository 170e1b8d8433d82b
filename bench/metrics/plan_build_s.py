"""plan_build_s: seconds of ``pipeline.build_plan`` in set-up (host
clock around the call)."""


def read(ctx):
    return ctx.plan_build_s
