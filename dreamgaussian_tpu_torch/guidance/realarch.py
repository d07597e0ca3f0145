"""Real-architecture Zero123 guidance with random weights.

Port of ``random_zero123_guidance`` from
``dreamgaussian_tpu/guidance/realarch.py``: the full Zero123 UNet (SD1.5
class, 8-channel input, 320/640/1280/1280 blocks, about 860M weights) and
the KL-VAE encoder, in bf16, with random weights. It is meaningless as a
prior but exact in work and memory, so it measures the real per-step
cost of Zero123 SDS. The weights are made on the device from a seeded
``torch.Generator`` (no host copy of 860M weights): kernels and dense
weights ~ N(0, 1/fan_in), biases 0, norms scale 1 and bias 0.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from .sds import Zero123Guidance
from .unet import ZERO123_CONFIG, UNet
from .vae import AutoencoderKL, VAEConfig


@torch.no_grad()
def _init_on_device(module: nn.Module, device, gen: torch.Generator) -> nn.Module:
    module = module.to_empty(device=device)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:        # norm scale
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
    return module.eval().requires_grad_(False)


def random_zero123_guidance(image_size: int = 256, seed: int = 0,
                            device: str | torch.device = "cuda") -> Zero123Guidance:
    """Zero123 guidance with the real architecture and random bf16 weights:
    clip_emb [1, 768], vae_latent [1, s/8, s/8, 4], cam_proj [772, 768]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):   # shapes only; the weights are made on `dev`
        unet = UNet(ZERO123_CONFIG).to(torch.bfloat16)
        vae = AutoencoderKL(VAEConfig()).to(torch.bfloat16)
    unet = _init_on_device(unet, dev, gen)
    vae = _init_on_device(vae, dev, gen)
    latent = image_size // 8
    ctx = ZERO123_CONFIG.cross_attention_dim
    return Zero123Guidance(
        unet, vae,
        clip_emb=torch.randn((1, ctx), generator=gen, device=dev) * 0.1,
        vae_latent=torch.randn((1, latent, latent, 4), generator=gen, device=dev) * 0.1,
        cam_proj=(torch.randn((ctx + 4, ctx), generator=gen, device=dev) * 0.02,
                  torch.zeros(ctx, device=dev)),
        image_size=image_size,
    )
