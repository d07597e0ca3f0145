from .stage1 import Stage1Trainer  # noqa: F401
