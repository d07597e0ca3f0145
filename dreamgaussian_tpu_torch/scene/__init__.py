from .gaussians import (  # noqa: F401
    GaussianAux,
    accumulate_stats,
    densify_and_prune,
    init_random,
    load_ply,
    num_alive,
    prune_only,
    reset_opacity,
    save_ply,
)
from .optim import AdamState, adam_init, adam_update, expon_lr  # noqa: F401
