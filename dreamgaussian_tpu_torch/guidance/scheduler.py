"""Diffusion noise schedule (the training side of DDIM) in torch.

Port of the SDS part of ``dreamgaussian_tpu/guidance/scheduler.py``:
``alphas_cumprod`` serves both the SDS weight ``w = 1 - alpha_t`` and
``add_noise``. The DDIM sampling step waits for stage 2.
"""

from __future__ import annotations

import numpy as np
import torch


class DDIMScheduler:
    """The noise table of the reference's DDIMScheduler: scaled-linear
    betas from 0.00085 to 0.012 over 1000 train timesteps."""

    num_train_timesteps = 1000

    def __init__(self, device: str | torch.device = "cpu"):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, self.num_train_timesteps,
                            dtype=np.float64) ** 2
        # float32 table on the host, for host-side lookups, and on `device`.
        self.alphas_np = np.cumprod(1.0 - betas, axis=0).astype(np.float32)
        self.alphas_cumprod = torch.from_numpy(self.alphas_np).to(device)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; t: int [B] on
        the scheduler's device."""
        a = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (sample.dim() - 1)
        return torch.sqrt(a).reshape(shape) * sample + torch.sqrt(1.0 - a).reshape(shape) * noise
