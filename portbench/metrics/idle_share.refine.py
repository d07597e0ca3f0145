"""Share of the traced stretch in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
MOVES = "refine_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "refine" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
