"""Mean stage-1 step time: the whole window over the steps completed in it
(densify steps included). Host clock; the window ends after a
synchronisation."""

LAYER = "stage-1 step"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    if ctx.get("kind") != "stage1" or not ctx.get("steps"):
        return None
    return ctx["window_s"] / ctx["steps"] * 1e3
