"""Mean stage-2 step time: the whole window over its steps. The window
holds whole 50-step refine jobs only, so every job's schedule of 10 to 3
UNet calls is in it. Host clock; the window ends after a synchronisation."""

LAYER = "stage-2 step"
UNIT = "ms"
MOVES = "refine_step_ms"


def read(ctx):
    if ctx.get("kind") != "refine" or not ctx.get("steps"):
        return None
    return ctx["window_s"] / ctx["steps"] * 1e3
