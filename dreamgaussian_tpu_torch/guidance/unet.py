"""Stable-Diffusion-family denoising UNet in torch (Zero123 configuration).

Port of the stage-1 part of ``dreamgaussian_tpu/guidance/unet.py``. The
public ``UNet.forward`` takes and returns NHWC tensors, like the flax
module; inside it runs NCHW. Submodules carry the flax module names
(``down_0_res_0.conv1``, ``mid_attn.transformer_blocks_0.attn2.to_k``,
...), so ``weights.load_unet`` maps a flax tree onto it by name.

Numerics kept from the JAX package: GroupNorm with float32 statistics and
``gcd(32, C)`` groups; LayerNorm with epsilon 1e-5 and float32 statistics;
GEGLU with the exact (erf) GELU; ``flip_sin_to_cos`` timestep embedding;
attention scores and softmax in float32. Only the Zero123 variant (conv
projections, a fixed head count) is ported; the SD 2.1 / MVDream /
ImageDream variants wait for the slice of the other priors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet shape. The defaults are Zero123's (SD1.5 class, 8-channel
    input, 8 heads, conv projections in the transformers)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int = 8
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )


ZERO123_CONFIG = UNetConfig()


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, diffusers convention with
    flip_sin_to_cos (cos first) and no frequency shift. t: [B]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    emb = torch.exp(exponent / half)[None, :] * t.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics whatever the activation dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups = math.gcd(32, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNorm32(nn.Module):
    """LayerNorm over the last dim with float32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def attention(q, k, v, heads: int):
    """Multi-head attention on [B, N, C] tensors (already projected):
    scores and softmax in float32, the value product in the input dtype."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // heads
    q = q.reshape(b, n, heads, d).transpose(1, 2)
    k = k.reshape(b, m, heads, d).transpose(1, 2)
    v = v.reshape(b, m, heads, d).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, context_dim: int | None = None):
        super().__init__()
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out_0 = nn.Linear(query_dim, query_dim)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads)
        return self.to_out_0(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net_0_proj = nn.Linear(dim, dim * 8)
        self.net_2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        h, gate = self.net_0_proj(x).chunk(2, dim=-1)
        return self.net_2(h * F.gelu(gate))   # GEGLU, exact (erf) GELU


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int):
        super().__init__()
        # diffusers / ldm build this norm with eps 1e-6.
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks_0 = TransformerBlock(channels, heads, context_dim)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.transformer_blocks_0(h, context)
        return self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class UNet(nn.Module):
    """Denoising UNet: NHWC latents, [B] timesteps, [B,L,D] context ->
    NHWC float32 noise prediction. Runs in the dtype of its weights."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        ctx = cfg.cross_attention_dim
        heads = cfg.num_attention_heads
        self.time_embedding = TimeEmbedding(ch0, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        n_levels = len(cfg.block_out_channels)
        h_ch, skips = ch0, [ch0]
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(h_ch, ch, temb_dim))
                h_ch = ch
                if btype == "CrossAttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(ch, heads, ctx))
                skips.append(ch)
            if i < n_levels - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
                skips.append(ch)
        ch = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock(h_ch, ch, temb_dim)
        self.mid_attn = Transformer2D(ch, heads, ctx)
        self.mid_res_1 = ResnetBlock(ch, ch, temb_dim)
        h_ch = ch
        for i, (btype, ch) in enumerate(zip(cfg.up_block_types,
                                             reversed(cfg.block_out_channels))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(h_ch + skips.pop(), ch, temb_dim))
                h_ch = ch
                if btype == "CrossAttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, heads, ctx))
            if i < n_levels - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm32(h_ch)
        self.conv_out = nn.Conv2d(h_ch, cfg.out_channels, 3, padding=1)

    def _block(self, name):
        return getattr(self, name, None)

    def forward(self, sample, timesteps, context):
        cfg = self.config
        dt = self.conv_in.weight.dtype
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt)
        temb = self.time_embedding(temb)
        context = context.to(dt)
        h = self.conv_in(sample.permute(0, 3, 1, 2).to(dt))
        skips = [h]
        n_levels = len(cfg.block_out_channels)
        for i in range(n_levels):
            for j in range(cfg.layers_per_block):
                h = self._block(f"down_{i}_res_{j}")(h, temb)
                attn = self._block(f"down_{i}_attn_{j}")
                if attn is not None:
                    h = attn(h, context)
                skips.append(h)
            if i < n_levels - 1:
                h = self._block(f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), context), temb)
        for i in range(n_levels):
            for j in range(cfg.layers_per_block + 1):
                h = self._block(f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                attn = self._block(f"up_{i}_attn_{j}")
                if attn is not None:
                    h = attn(h, context)
            if i < n_levels - 1:
                h = self._block(f"up_{i}_upsample")(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1).float()
