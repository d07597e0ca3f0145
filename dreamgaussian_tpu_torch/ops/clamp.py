"""Clamp whose gradient at a tie is one half.

``torch.clamp`` passes the whole gradient where the value equals a bound;
``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` pass half of it (the two
arguments of a tie share it). ``torch.maximum`` / ``torch.minimum`` split a
tie the same way, so the port clamps through them wherever a gradient
flows, and its gradients equal the JAX package's on a bound too.
"""

from __future__ import annotations

import torch


def clamp_tie(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``min(max(x, lo), hi)`` with half the gradient at ``x == lo`` or
    ``x == hi``. Bounds are floats or tensors that broadcast against ``x``."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x
