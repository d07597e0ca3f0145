from .stage1 import Stage1Trainer  # noqa: F401
from .stage2 import Stage2Trainer  # noqa: F401
