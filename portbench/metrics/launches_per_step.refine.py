"""Runtime calls that start device work (kernel and graph launches; a
graph launch counts as one) per stage-2 step, over the traced stretch
(steps from the middle of a job, near its mean UNet calls)."""

LAYER = "stage-2 step"
UNIT = "count"
MOVES = "refine_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "refine" or not t:
        return None
    return t["launches"] / t["steps"]
