"""95th percentile of the window's per-step times (the gap between CUDA
events recorded on the stream after consecutive steps), over every step of
the window."""

import numpy as np

LAYER = "stage-1 step"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    if ctx.get("kind") != "stage1" or not ctx.get("step_ms_each"):
        return None
    return float(np.percentile(np.asarray(ctx["step_ms_each"]), 95))
