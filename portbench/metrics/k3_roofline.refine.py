"""K3's share of its roofline over the traced stretch: the least time the
stretch's renders' z-tests need (``work.k3_bound_s`` of the pairs counted
by the reference's plain visibility on the same cameras and sizes) over
K3's device time by kernel name, against the H100 SXM published peaks."""

LAYER = "mesh render kernel"
UNIT = "%"
MOVES = "refine_step_ms"
KERNEL = "ztest"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "refine" or not t:
        return None
    device_s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    return 100.0 * t["k3_bound_s"] / device_s if device_s > 0 else None
