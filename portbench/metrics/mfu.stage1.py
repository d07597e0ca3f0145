"""The whole stage-1 step's share of the H100's bf16 dense peak (989
TFLOP/s): the model operations per step (``work.stage1_step_flops``: the
UNet's CFG call, the VAE encoder forward and its backward to the images)
times the window's steps, over the window. The gaussian render's work is
left out (the rooflines cover it)."""

from portbench.work import PEAKS

LAYER = "whole step"
UNIT = "%"
MOVES = "stage1_step_ms"


def read(ctx):
    if ctx.get("kind") != "stage1" or not ctx.get("steps") or "flops_per_step" not in ctx:
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] / (ctx["window_s"] * PEAKS["bf16_flops"])
