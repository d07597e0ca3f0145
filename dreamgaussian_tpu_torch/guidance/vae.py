"""AutoencoderKL (SD VAE) in torch.

Port of ``dreamgaussian_tpu/guidance/vae.py``: ``encode`` takes NHWC
images in [-1, 1] and returns the posterior mean times ``scaling_factor``
(the deterministic choice SDS uses), NHWC; it sits in the SDS gradient
graph, so it is differentiable. ``decode`` divides by ``scaling_factor``
and returns NHWC images in [-1, 1] (stage 2's refine, under no_grad).
Submodules carry the flax names (``encoder.down_0_res_0``,
``decoder.up_0_res_0``, ``decoder.post_quant_conv``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import trace
from .unet import GroupNorm32, attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out_0 = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = attention(self.to_q(y), self.to_k(y), self.to_v(y), heads=1)
        y = self.to_out_0(y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.n_levels = len(chans)
        self.layers_per_block = cfg.layers_per_block
        h_ch = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(h_ch, ch))
                h_ch = ch
            if i < self.n_levels - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(ch, ch, 3, stride=2))
        self.mid_res_0 = VAEResnet(h_ch, h_ch)
        self.mid_attn = VAEAttention(h_ch)
        self.mid_res_1 = VAEResnet(h_ch, h_ch)
        self.conv_norm_out = GroupNorm32(h_ch, eps=1e-6)
        self.conv_out = nn.Conv2d(h_ch, 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def forward(self, x):
        """NCHW images -> NCHW float32 moments [B, 2*latent, H/8, W/8]."""
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for i in range(self.n_levels):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < self.n_levels - 1:
                # diffusers pads asymmetrically ((0,1),(0,1)) for stride 2.
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(h).float()


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_res_0 = VAEResnet(rev[0], rev[0])
        self.mid_attn = VAEAttention(rev[0])
        self.mid_res_1 = VAEResnet(rev[0], rev[0])
        self.n_levels = len(rev)
        self.n_res = cfg.layers_per_block + 1
        h_ch = rev[0]
        for i, ch in enumerate(rev):
            for j in range(self.n_res):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(h_ch, ch))
                h_ch = ch
            if i < self.n_levels - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1))
        self.conv_norm_out = GroupNorm32(h_ch, eps=1e-6)
        self.conv_out = nn.Conv2d(h_ch, cfg.in_channels, 3, padding=1)

    def forward(self, z):
        """NCHW latents -> NCHW float32 images [B, 3, 8h, 8w]."""
        z = self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        for i in range(self.n_levels):
            for j in range(self.n_res):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < self.n_levels - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """encode(imgs NHWC in [-1,1]) -> scaled posterior-mean latents NHWC;
    decode(latents NHWC) -> imgs NHWC in [-1,1]."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)

    def encode(self, x):
        with trace.span("vae.encode"):
            moments = self.encoder(x.permute(0, 3, 1, 2))
            mean = moments[:, : self.config.latent_channels]
            return (mean * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z):
        with trace.span("vae.decode"):
            x = self.decoder((z / self.config.scaling_factor).permute(0, 3, 1, 2))
            return x.permute(0, 2, 3, 1)

    def latent_side(self, image_size: int) -> int:
        """Side of the latents of an image_size^2 image."""
        return image_size // 2 ** (len(self.config.block_out_channels) - 1)
