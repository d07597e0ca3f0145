"""Host time per stage-1 step inside the port's ``imagedream.views`` spans
(ImageDream's identity views: the 4 -> 5 padding of the latents and
timesteps before the UNet call, the strip after it), over the traced
stretch with the port's tracing on. Absent where the port has no such
span."""

LAYER = "guidance"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    host_s = (ctx.get("port_span_host_s") or {}).get("imagedream.views")
    if ctx.get("kind") != "stage1" or not t or not host_s:
        return None
    return host_s / t["steps"] * 1e3
