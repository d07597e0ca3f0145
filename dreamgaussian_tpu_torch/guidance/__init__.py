from .scheduler import DDIMScheduler  # noqa: F401
from .sds import (  # noqa: F401
    ImageDreamGuidance,
    MVDreamGuidance,
    StableDiffusionGuidance,
    Zero123Guidance,
    sds_grad_loss,
)
