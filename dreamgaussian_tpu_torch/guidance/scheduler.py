"""Diffusion noise schedule (the training side of DDIM) in torch.

Port of ``dreamgaussian_tpu/guidance/scheduler.py``: ``alphas_cumprod``
serves the SDS weight ``w = 1 - alpha_t``, ``add_noise``, and the
deterministic DDIM step (eta 0, "leading" timestep spacing, epsilon
prediction) of stage 2's img2img refine.
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
        # set_alpha_to_one=False: the step past t = 0 lands on alpha[0].
        self.final_alpha_cumprod = self.alphas_cumprod[0]
        self.timesteps = None
        self.num_inference_steps = None

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; t: int [B] on
        the scheduler's device."""
        a = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (sample.dim() - 1)
        return torch.sqrt(a).reshape(shape) * sample + torch.sqrt(1.0 - a).reshape(shape) * noise

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """diffusers "leading" spacing: t = i * (1000 // steps), descending."""
        self.num_inference_steps = num_inference_steps
        step = self.num_train_timesteps // num_inference_steps
        self.timesteps = np.arange(0, num_inference_steps)[::-1] * step
        return self.timesteps

    def step(self, noise_pred: torch.Tensor, t: int, sample: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM update x_t -> x_{t - spacing} (eta 0)."""
        if self.num_inference_steps is None:
            raise RuntimeError("call set_timesteps() first")
        return self.step_with_spacing(noise_pred, t, sample,
                                      self.num_train_timesteps // self.num_inference_steps)

    def step_with_spacing(self, noise_pred: torch.Tensor, t: int, sample: torch.Tensor,
                          spacing: int) -> torch.Tensor:
        """``step`` with the spacing passed explicitly (no scheduler state)."""
        prev_t = t - spacing
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        x0 = (sample - torch.sqrt(1.0 - a_t) * noise_pred) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * noise_pred
