"""Real-architecture Zero123, MVDream and ImageDream guidance with random weights.

Port of ``random_zero123_guidance``, ``random_mvdream_guidance`` and
``random_imagedream_guidance`` from ``dreamgaussian_tpu/guidance/realarch.py``:
the full Zero123 UNet (SD1.5 class, 8-channel input, 320/640/1280/1280
blocks, about 860M weights), MVDream's (SD 2.1 with 4-view joint attention
and the camera MLP) or ImageDream's (MVDream's over 5 views, with the
resampler and the ip projections), and the KL-VAE (encoder and decoder), in bf16, with random weights. It is
meaningless as a prior but exact in work and memory, so it measures the
real per-step cost of SDS and refine. The weights are made on the device from a seeded
``torch.Generator`` (no host copy of 860M weights): kernels and dense
weights ~ N(0, 1/fan_in), biases 0, norms scale 1 and bias 0, the
resampler's latents ~ N(0, 1/dim).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from .sds import ImageDreamGuidance, MVDreamGuidance, Zero123Guidance
from .unet import IMAGEDREAM_CONFIG, MVDREAM_CONFIG, ZERO123_CONFIG, UNet
from .vae import AutoencoderKL, VAEConfig


@torch.no_grad()
def init_on_device(module: nn.Module, device, gen: torch.Generator) -> nn.Module:
    """Materialize a module built on the meta device on ``device`` with
    seeded random weights, frozen and in eval mode."""
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


def _random_backbone(config, dev, gen):
    with torch.device("meta"):   # shapes only; the weights are made on `dev`
        unet = UNet(config).to(torch.bfloat16)
        vae = AutoencoderKL(VAEConfig()).to(torch.bfloat16)
    return init_on_device(unet, dev, gen), init_on_device(vae, dev, gen)


def random_zero123_guidance(image_size: int = 256, seed: int = 0,
                            device: str | torch.device = "cuda") -> Zero123Guidance:
    """Zero123 guidance with the real architecture and random bf16 weights
    (the UNet, then the VAE's encoder and decoder): clip_emb [1, 768],
    vae_latent [1, s/8, s/8, 4], cam_proj [772, 768]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet, vae = _random_backbone(ZERO123_CONFIG, dev, gen)
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


def random_mvdream_guidance(image_size: int = 256, seed: int = 0,
                            device: str | torch.device = "cuda") -> MVDreamGuidance:
    """MVDream guidance with the real 4-view architecture (sd-v2.1-base-4view
    class) and random bf16 weights; states [77, 1024], 'neg' zeros."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet, vae = _random_backbone(MVDREAM_CONFIG, dev, gen)
    d = MVDREAM_CONFIG.cross_attention_dim
    emb = {"pos": torch.randn((77, d), generator=gen, device=dev) * 0.1,
           "neg": torch.zeros((77, d), device=dev)}
    return MVDreamGuidance(unet, vae, emb, image_size=image_size)


def random_imagedream_guidance(image_size: int = 256, seed: int = 0,
                               device: str | torch.device = "cuda") -> ImageDreamGuidance:
    """ImageDream guidance with the real 5-view IP-adapter architecture
    (sd-v2.1-base-4view-ipmv class) and random bf16 weights; states [77,
    1024] ('neg' zeros), CLIP ViT-H tokens [257, 1280] and an identity
    latent [s/8, s/8, 4], random."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet, vae = _random_backbone(IMAGEDREAM_CONFIG, dev, gen)
    d, latent = IMAGEDREAM_CONFIG.cross_attention_dim, image_size // 8
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return ImageDreamGuidance(
        unet, vae,
        {"pos": randn(77, d) * 0.1, "neg": torch.zeros((77, d), device=dev)},
        {"pos": randn(257, IMAGEDREAM_CONFIG.ip_embed_dim) * 0.1,
         "ip_img": randn(latent, latent, 4) * 0.1},
        image_size=image_size)
