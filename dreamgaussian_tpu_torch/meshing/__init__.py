from .marching_cubes import marching_cubes  # noqa: F401
from .occupancy import OccupancyTransform, extract_occupancy_field  # noqa: F401
