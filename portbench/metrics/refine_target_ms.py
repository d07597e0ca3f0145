"""Mean time of a stage-2 step's target phase (render, the img2img refine:
VAE encode, the DDIM UNet calls, VAE decode; the resize) by the trainer's
``phase_timing`` (host clock with a synchronisation on both sides), over
the traced run's first job (all 50 steps, 10 to 3 UNet calls)."""

LAYER = "stage-2 target phase"
UNIT = "ms"
MOVES = "refine_step_ms"


def read(ctx):
    phases = ctx.get("phase_s")
    if ctx.get("kind") != "refine" or not phases:
        return None
    return sum(p[0] for p in phases) / len(phases) * 1e3
