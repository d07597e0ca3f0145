"""``torch.cuda.max_memory_allocated`` over the window, in GiB."""

LAYER = "device"
UNIT = "GiB"
MOVES = "refine_step_ms"


def read(ctx):
    if ctx.get("kind") != "refine" or "window_peak_bytes" not in ctx:
        return None
    return ctx["window_peak_bytes"] / 2**30
