"""Device time of one call of the port's UNet in a stage-1 step (at
ImageDream's widths the batch-10 call: joint attention over 5 x 32^2
tokens, the IP path): the kernels launched inside the port's ``unet`` span
over the traced stretch, matched by the profiler's correlation ids (a graph
replay's kernels carry its launch's), over the stretch's ``unet.calls``.
The VAE that ``unet_device_ms.stage1`` includes is left out. Absent where
the runner does not switch the port's tracing on in the stretch."""

LAYER = "guidance"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    t = ctx.get("trace")
    calls = (ctx.get("port_counters") or {}).get("unet.calls")
    if ctx.get("kind") != "stage1" or not t or not calls:
        return None
    value = t["span_kernel_s"].get("unet", 0.0)
    return value / calls * 1e3 if value > 0 else None
