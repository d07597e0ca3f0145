"""Device time per stage-1 step of the kernels launched inside the
guidance span (the VAE encode forward, the UNet's CFG call, the SDS
arithmetic), matched by the profiler's correlation ids over the traced
stretch."""

LAYER = "guidance"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "stage1" or not t:
        return None
    value = t["span_kernel_s"].get("portbench.guidance", 0.0)
    return value / t["steps"] * 1e3 if value > 0 else None
