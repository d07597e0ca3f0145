"""``torch.cuda.max_memory_allocated`` over the window, in GiB: the memory
a change may trade for step time (graph pools, caches)."""

LAYER = "device"
UNIT = "GiB"
MOVES = "stage1_step_ms"


def read(ctx):
    if ctx.get("kind") != "stage1" or "window_peak_bytes" not in ctx:
        return None
    return ctx["window_peak_bytes"] / 2**30
