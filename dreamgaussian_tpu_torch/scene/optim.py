"""Grouped Adam with per-group learning rates (torch.optim.Adam semantics).

Port of ``dreamgaussian_tpu/scene/optim.py``. The state is a transparent
``AdamState`` whose ``mu``/``nu`` mirror the params dict, so the density
controller can zero moment rows of freed or new capacity slots.
Update: ``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``
with the reference's eps = 1e-15.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    mu: dict     # first moments, same keys as params
    nu: dict     # second moments
    count: int   # steps taken (shared across groups)


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamState,
    lrs: Mapping[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step. ``lrs`` maps param-group name -> learning rate."""
    count = state.count + 1
    # Bias corrections in float32, as the JAX package computes them.
    t = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    new_params, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        m = b1 * state.mu[name] + (1.0 - b1) * g
        v = b2 * state.nu[name] + (1.0 - b2) * (g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_params[name] = p - lrs[name] * update
        new_mu[name] = m
        new_nu[name] = v
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def expon_lr(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
) -> Callable[[float], float]:
    """Log-lerp decay with optional reverse-cosine warm-up delay, evaluated
    in float32 like the JAX schedule."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if lr_init == lr_final:
            return float(f32(lr_init))
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
            )
        else:
            delay = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
        log_lerp = np.exp(f32(math.log(lr_init)) * (f32(1.0) - t) + f32(math.log(lr_final)) * t)
        return 0.0 if step < 0 else float(delay * log_lerp)

    return schedule
