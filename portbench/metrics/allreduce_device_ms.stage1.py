"""Device time per stage-1 step of the collective kernels (NCCL's, by
kernel name) on rank 0, over the traced stretch: the gradients' packed
all-reduce and the radii's."""

LAYER = "sharding"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "stage1" or not t:
        return None
    device_s = sum(v for k, v in t["kernel_s"].items() if "nccl" in k.lower())
    return device_s / t["steps"] * 1e3 if device_s > 0 else None
