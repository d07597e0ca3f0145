"""Process start to the first timed step: imports, CUDA start-up, kernels
loaded from the build cache, weights and inputs made from the seed, the
compared steps and the warm-up. Host clock."""

LAYER = "run"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return ctx.get("setup_s")
