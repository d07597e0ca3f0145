from .scheduler import DDIMScheduler  # noqa: F401
from .sds import Zero123Guidance, sds_grad_loss  # noqa: F401
