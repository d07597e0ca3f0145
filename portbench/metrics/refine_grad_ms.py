"""Mean time of a stage-2 step's grad phase (the mesh renders, the texture
gradient, Adam) by the trainer's ``phase_timing``, over the traced run's
first job."""

LAYER = "stage-2 grad phase"
UNIT = "ms"
MOVES = "refine_step_ms"


def read(ctx):
    phases = ctx.get("phase_s")
    if ctx.get("kind") != "refine" or not phases:
        return None
    return sum(p[1] for p in phases) / len(phases) * 1e3
