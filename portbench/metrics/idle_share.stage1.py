"""Share of the traced stretch in which no operation ran on the device: 1
minus the union of device activity over the stretch's length."""

LAYER = "device"
UNIT = "%"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "stage1" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
