"""The whole stage-2 step's share of the H100's bf16 dense peak: a job's
model operations (each step's UNet calls at the CFG batch, its VAE encode
and decode) per step, times the window's steps, over the window. The mesh
render and the texture gradient are left out (K3's roofline covers the
z-test)."""

from portbench.work import PEAKS

LAYER = "whole step"
UNIT = "%"
MOVES = "refine_step_ms"


def read(ctx):
    if ctx.get("kind") != "refine" or not ctx.get("steps") or "flops_per_step" not in ctx:
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] / (ctx["window_s"] * PEAKS["bf16_flops"])
