"""PyTorch/CUDA port of dreamgaussian_tpu for one NVIDIA H100.

The package mirrors ``dreamgaussian_tpu``'s layout (``ops/``, ``scene/``,
``guidance/``, ``train/``, ``utils/``) and public names. It imports
``torch`` and never JAX, flax or the JAX package.

Device policy: every entry point takes ``device="cuda"`` by default and
raises when no card is present, unless the caller asks for the CPU with
``device="cpu"`` (as the CPU tests do). Nothing falls back on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on; raises for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
