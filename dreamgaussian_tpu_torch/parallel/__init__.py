"""Data and tile sharding over ``torch.distributed`` (port of
``dreamgaussian_tpu/parallel/``)."""

from .dp import make_data_mesh, make_dp_train_step, shard_cameras  # noqa: F401
from .multihost import (  # noqa: F401
    Mesh2D,
    initialize_multihost,
    make_mesh_2d,
    rays_per_second,
)
