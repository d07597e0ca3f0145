"""Runtime calls that start device work (kernel and graph launches; a
graph launch counts as one) per stage-1 step, over the traced stretch."""

LAYER = "stage-1 step: host dispatch"
UNIT = "count"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "stage1" or not t:
        return None
    return t["launches"] / t["steps"]
