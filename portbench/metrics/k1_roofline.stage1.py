"""K1's share of its roofline over the traced stretch: the least time the
stretch's renders need (``work.k1_bound_s`` of the pairs counted by the
reference's plain compositing) over K1's device time by kernel name,
against the H100 SXM published float32 and HBM peaks."""

LAYER = "gaussian render kernels"
UNIT = "%"
MOVES = "stage1_step_ms"
KERNEL = "composite_fwd"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "stage1" or not t:
        return None
    device_s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    return 100.0 * t["k1_bound_s"] / device_s if device_s > 0 else None
