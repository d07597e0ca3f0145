"""Fake Zero123, SD, MVDream and ImageDream guidance: a tiny random-weight
denoiser in place of the real prior, for runs without weights
(``fake_guidance=True`` in the CLIs, ``--fake`` in ``cli.dream``) and for
tests.

Port of ``dreamgaussian_tpu/guidance/fake.py``: the "VAE" average-pools the image to an 8x8 latent (its first channel
repeated as the fourth) and decodes by nearest upsampling of the first
three latent channels; the UNet is ``TinyUNet``. It runs every code path
of SDS and refine and carries no semantic prior. The weights and
embeddings are drawn from a seeded ``torch.Generator`` on the device as
``realarch`` draws them (the JAX package draws its own from a JAX key);
the text "embeddings" are [2, 32] random states (MVDream's and
ImageDream's negative one zeros); ImageDream's image tokens are [5, 16]
random values and its identity latent zeros, which ``TinyUNet`` ignores
as the JAX fake's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .realarch import init_on_device
from .sds import ImageDreamGuidance, MVDreamGuidance, StableDiffusionGuidance, Zero123Guidance
from .unet import TinyUNet


class PoolVAE(nn.Module):
    """encode: NHWC images -> [B, L, L, 4] block means (channels 0, 1, 2, 0);
    decode: NHWC latents -> [B, S, S, 3], nearest upsampling of channels 0-2."""

    def __init__(self, latent_size: int, image_size: int):
        super().__init__()
        self.latent_size = latent_size
        self.image_size = image_size

    def encode(self, imgs):
        b, h, w, c = imgs.shape
        f = h // self.latent_size
        lat = imgs.reshape(b, self.latent_size, f, self.latent_size, f, c).mean((2, 4))
        return torch.cat([lat, lat[..., :1]], dim=-1)

    def decode(self, z):
        x = F.interpolate(z[..., :3].permute(0, 3, 1, 2), size=(self.image_size,) * 2,
                          mode="nearest-exact")
        return x.permute(0, 2, 3, 1)

    def latent_side(self, image_size: int) -> int:
        return self.latent_size


def _tiny_unet(in_channels: int, dev, gen):
    with torch.device("meta"):
        unet = TinyUNet(in_channels=in_channels, channels=16, context_dim=32, out_channels=4)
    return init_on_device(unet, dev, gen)


def fake_sd_guidance(image_size: int = 64, seed: int = 0,
                     device: str | torch.device = "cuda") -> StableDiffusionGuidance:
    """SD guidance with ``TinyUNet`` (context 32) and the pooling VAE at an
    8x8 latent; states for pos, neg, front, side and back."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = _tiny_unet(4, dev, gen)
    emb = {k: torch.randn((2, 32), generator=gen, device=dev) * 0.1
           for k in ("pos", "neg", "front", "side", "back")}
    return StableDiffusionGuidance(unet, PoolVAE(latent_size=8, image_size=image_size), emb,
                                   image_size=image_size)


def fake_mvdream_guidance(image_size: int = 64, seed: int = 0,
                          device: str | torch.device = "cuda") -> MVDreamGuidance:
    """MVDream guidance with ``TinyUNet`` (which ignores the camera) and the
    pooling VAE at an 8x8 latent."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = _tiny_unet(4, dev, gen)
    emb = {"pos": torch.randn((2, 32), generator=gen, device=dev) * 0.1,
           "neg": torch.zeros((2, 32), device=dev)}
    return MVDreamGuidance(unet, PoolVAE(latent_size=8, image_size=image_size), emb,
                           image_size=image_size)


def fake_imagedream_guidance(image_size: int = 64, seed: int = 0,
                             device: str | torch.device = "cuda") -> ImageDreamGuidance:
    """ImageDream guidance with ``TinyUNet`` (which ignores the camera, the
    image tokens and the identity latent) and the pooling VAE at an 8x8
    latent: tokens [5, 16], identity latent [8, 8, 4] of zeros."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = _tiny_unet(4, dev, gen)
    emb = {"pos": torch.randn((2, 32), generator=gen, device=dev) * 0.1,
           "neg": torch.zeros((2, 32), device=dev)}
    img_emb = {"pos": torch.randn((5, 16), generator=gen, device=dev) * 0.1,
               "ip_img": torch.zeros((8, 8, 4), device=dev)}
    return ImageDreamGuidance(unet, PoolVAE(latent_size=8, image_size=image_size), emb, img_emb,
                              image_size=image_size)


def fake_zero123_guidance(image_size: int = 64, seed: int = 0, stable: bool = False,
                          default_elevation: float = 0.0,
                          device: str | torch.device = "cuda") -> Zero123Guidance:
    """Zero123 guidance with ``TinyUNet`` (8-channel input, context 32) and
    the pooling VAE at an 8x8 latent: clip_emb [1, 24], vae_latent [1, 8, 8,
    4], cam_proj [28, 32]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = _tiny_unet(8, dev, gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return Zero123Guidance(
        unet, PoolVAE(latent_size=8, image_size=image_size),
        clip_emb=randn(1, 24) * 0.1,
        vae_latent=randn(1, 8, 8, 4) * 0.1,
        cam_proj=(randn(28, 32) * 0.05, torch.zeros(32, device=dev)),
        image_size=image_size, stable=stable, default_elevation=default_elevation,
    )
