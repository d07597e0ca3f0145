"""Stable-Diffusion-family denoising UNet in torch: Zero123, SD 2.x, MVDream, ImageDream.

Port of ``dreamgaussian_tpu/guidance/unet.py``. The public ``UNet.forward``
takes and returns NHWC tensors, like the flax module; inside it runs
NCHW. Submodules carry the flax module names (``down_0_res_0.conv1``,
``mid_attn.transformer_blocks_0.attn2.to_k``, ``camera_embedding.linear_1``,
``image_embed.layers_0_attn.to_kv``, ...), so ``weights.load_unet`` maps a
flax tree onto it by name.

Variants: Zero123 (8-channel input, conv projections in the transformers,
8 heads, context 768); SD 2.x (linear projections, 64-wide heads, context
1024); MVDream (SD 2.x whose self-attention attends jointly over the
``num_views`` views of a group, plus a camera MLP whose output is added to
the time embedding); ImageDream (MVDream over groups of 5 views, the last
the identity view, plus the IP-adapter path: a perceiver ``Resampler``
turns the CLIP image tokens into ``ip_dim`` context tokens, which every
cross-attention reads through its own ``to_k_ip`` / ``to_v_ip``).

Numerics kept from the JAX package: GroupNorm with float32 statistics and
``gcd(32, C)`` groups; LayerNorm with epsilon 1e-5 and float32 statistics;
GEGLU with the exact (erf) GELU; ``flip_sin_to_cos`` timestep embedding;
attention scores and softmax in float32 (at SD's 64^2 latents, or
MVDream's 4 x 32^2 joint tokens, 0.67 GB of scores per first-level call;
ImageDream's 5 x 32^2, 1.05 GB).
``TinyUNet`` is the small denoiser of the runs without weights
(``guidance/fake.py``).

On a card, ``UNet.forward`` replays a CUDA graph of its body: one launch
in place of about 1,800 at Zero123-XL's widths. A call is graphed when
every tensor argument is on a CUDA device, autograd is off and no capture
is under way on the current stream; any other call (the CPU, a call that
takes gradients, a call inside another capture) runs the body eagerly. The graphs are kept
per input signature: the (shape, dtype) of each argument, ``None`` kept
as ``None``, and the card's index. A new signature is warmed up eagerly
on a side stream, captured on static input buffers into a memory pool of
its own (counter ``unet.graph_captures``) and replayed from then on: the
arguments are copied into the buffers, the graph replays on the current
stream and the call returns a copy of the graph's output (counter
``unet.graph_replays``). Weights copied in place keep their addresses and
are seen by the replays; ``.to()``, ``.cuda()``, dtype casts and
``load_state_dict`` drop the graphs, since they may give the weights new
storage.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import trace


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet shape. The defaults are Zero123's (SD1.5 class, 8-channel
    input, 8 heads, conv projections in the transformers).

    Heads: ``num_attention_heads`` when set; else ``attention_head_dim``,
    an int head width (``channels // width`` heads, as the JAX package
    reads it) or a per-level tuple of head counts (as diffusers reads the
    list of an SD 2.x ``config.json``: ``[5, 10, 20, 20]``)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int | None = 8
    attention_head_dim: int | Sequence[int] = 64
    use_linear_projection: bool = False
    num_views: int = 1            # > 1: joint self-attention, and the camera MLP
    # ImageDream's IP-adapter path (ip_dim > 0): a Resampler from CLIP image
    # tokens [L, ip_embed_dim] to ip_dim context tokens, read by to_k_ip /
    # to_v_ip in every cross-attention (the JAX package's ip_weight, 1).
    ip_dim: int = 0
    ip_embed_dim: int = 1280       # CLIP ViT-H/14 token width
    ip_resampler_dim: int = 1280
    ip_resampler_depth: int = 4
    ip_resampler_heads: int = 20   # heads of width 64
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )

    def heads_for(self, level: int) -> int:
        """Heads of the transformers at ``level`` (the mid block is the last)."""
        if self.num_attention_heads is not None:
            return self.num_attention_heads
        if not isinstance(self.attention_head_dim, int):
            return int(self.attention_head_dim[level])
        return max(1, self.block_out_channels[level] // self.attention_head_dim)


ZERO123_CONFIG = UNetConfig()
SD21_CONFIG = UNetConfig(in_channels=4, cross_attention_dim=1024, num_attention_heads=None,
                         attention_head_dim=64, use_linear_projection=True)
MVDREAM_CONFIG = dataclasses.replace(SD21_CONFIG, num_views=4)
# sd-v2.1-base-4view-ipmv: 4 views and the identity view, 16 resampled image tokens.
IMAGEDREAM_CONFIG = dataclasses.replace(SD21_CONFIG, num_views=5, ip_dim=16)
CAMERA_DIM = 16                   # MVDream's flattened 4x4 camera


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
    """Multi-head (cross-)attention. With ``ip`` (ImageDream) it also has
    ``to_k_ip`` / ``to_v_ip``: called with ``n_ip`` > 0, the last ``n_ip``
    context tokens are image tokens, attended through those projections,
    and their output is added."""

    def __init__(self, query_dim: int, heads: int, context_dim: int | None = None,
                 ip: bool = False):
        super().__init__()
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        if ip:
            self.to_k_ip = nn.Linear(ctx, query_dim, bias=False)
            self.to_v_ip = nn.Linear(ctx, query_dim, bias=False)
        self.to_out_0 = nn.Linear(query_dim, query_dim)

    def forward(self, x, context=None, n_ip: int = 0):
        ctx = x if context is None else context
        q = self.to_q(x)
        if n_ip:
            ctx, ip = ctx[:, :-n_ip], ctx[:, -n_ip:]
        out = attention(q, self.to_k(ctx), self.to_v(ctx), self.heads)
        if n_ip:
            out = out + attention(q, self.to_k_ip(ip), self.to_v_ip(ip), self.heads)
        return self.to_out_0(out)


class PerceiverAttention(nn.Module):
    """The Resampler's attention: the latents attend to [tokens ++ latents]
    through no-bias projections."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_kv = nn.Linear(dim, 2 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        return self.to_out(attention(self.to_q(latents), k, v, self.heads))


class Resampler(nn.Module):
    """ImageDream's ``image_embed`` (the IP-adapter perceiver resampler):
    CLIP image tokens [B, L, embed_dim] -> [B, num_queries, output_dim].
    ``latents`` [num_queries, dim] is the flax layout; each layer is the
    attention, then LayerNorm -> Linear x4 -> exact GELU -> Linear, both
    with residuals."""

    def __init__(self, dim: int, depth: int, heads: int, num_queries: int, embed_dim: int,
                 output_dim: int):
        super().__init__()
        self.depth = depth
        self.latents = nn.Parameter(torch.empty(num_queries, dim))
        self.proj_in = nn.Linear(embed_dim, dim)
        for i in range(depth):
            self.add_module(f"layers_{i}_attn", PerceiverAttention(dim, heads))
            self.add_module(f"layers_{i}_ff_norm", LayerNorm32(dim))
            self.add_module(f"layers_{i}_ff_in", nn.Linear(dim, 4 * dim, bias=False))
            self.add_module(f"layers_{i}_ff_out", nn.Linear(4 * dim, dim, bias=False))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm32(output_dim)

    def forward(self, x):
        x = self.proj_in(x.to(self.proj_in.weight.dtype))
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        for i in range(self.depth):
            latents = latents + getattr(self, f"layers_{i}_attn")(x, latents)
            h = getattr(self, f"layers_{i}_ff_norm")(latents)
            h = getattr(self, f"layers_{i}_ff_out")(F.gelu(getattr(self, f"layers_{i}_ff_in")(h)))
            latents = latents + h
        return self.norm_out(self.proj_out(latents))


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net_0_proj = nn.Linear(dim, dim * 8)
        self.net_2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        h, gate = self.net_0_proj(x).chunk(2, dim=-1)
        return self.net_2(h * F.gelu(gate))   # GEGLU, exact (erf) GELU


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, num_views: int = 1,
                 ip: bool = False):
        super().__init__()
        self.num_views = num_views
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim, ip)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, n_ip: int = 0):
        h = self.norm1(x)
        if self.num_views > 1:
            # The views of a group attend jointly: [B*V, N, C] -> [B, V*N, C].
            bv, n, c = h.shape
            h = self.attn1(h.reshape(bv // self.num_views, self.num_views * n, c))
            h = h.reshape(bv, n, c)
        else:
            h = self.attn1(h)
        x = x + h
        x = x + self.attn2(self.norm2(x), context, n_ip)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm, proj_in, one transformer block, proj_out, residual. The
    projections are 1x1 convolutions (Zero123) or ``Linear`` on the
    flattened tokens (SD 2.x, ``linear``)."""

    def __init__(self, channels: int, heads: int, context_dim: int, linear: bool = False,
                 num_views: int = 1, ip: bool = False):
        super().__init__()
        self.linear = linear
        # diffusers / ldm build this norm with eps 1e-6.
        self.norm = GroupNorm32(channels, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if linear else \
            (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks_0 = TransformerBlock(channels, heads, context_dim, num_views, ip)
        self.proj_out = proj()

    def forward(self, x, context, n_ip: int = 0):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
            h = self.proj_out(self.transformer_blocks_0(h, context, n_ip))
            return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x
        h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.transformer_blocks_0(h, context, n_ip)
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


def graphable(args) -> bool:
    """Whether a UNet call with these arguments replays a CUDA graph: every
    tensor on a CUDA device, autograd off, and no capture under way on the
    current stream (a call inside another capture runs eagerly)."""
    return (not torch.is_grad_enabled()
            and all(a is None or a.is_cuda for a in args)
            and not torch.cuda.is_current_stream_capturing())


def signature(args) -> tuple:
    """The graph cache's key: each argument's (shape, dtype), ``None`` kept
    as ``None``, and the card's index."""
    return (tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args),
            args[0].device.index)


class CapturedForward:
    """``fn`` captured as a CUDA graph on static copies of ``args``.

    The capture runs on a side stream of its own after one eager warm-up
    there, so that cuDNN and cuBLAS make that stream's handles and
    workspaces outside the capture. It takes a memory pool of its own.
    Other threads may make CUDA calls meanwhile (autograd's, NCCL's
    watchdog): the capture checks the capturing thread alone."""

    def __init__(self, fn, args):
        with torch.cuda.device(args[0].device):
            self.inputs = [None if a is None else a.clone(memory_format=torch.contiguous_format)
                           for a in args]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self.inputs)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    self.output = fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)

    def __call__(self, args):
        """Copy ``args`` into the buffers, replay on the current stream, and
        return a copy of the output that the next replay leaves alone."""
        for buf, a in zip(self.inputs, args):
            if a is not None:
                buf.copy_(a)
        self.graph.replay()
        return self.output.clone()


def _drop_graphs_after_load(module, incompatible_keys) -> None:
    # load_state_dict(assign=True) puts new tensors at new addresses.
    module._drop_graphs()


class UNet(nn.Module):
    """Denoising UNet: NHWC latents, [B] timesteps, [B,L,D] context and,
    for MVDream and ImageDream, the raw [B, 16] camera -> NHWC float32 noise
    prediction. Runs in the dtype of its weights. With ``num_views`` V > 1
    the batch holds whole groups of V consecutive views.

    ImageDream (``ip_dim`` > 0): ``ip`` [B, L, ip_embed_dim] CLIP image
    tokens go through the ``image_embed`` Resampler and are appended to the
    context for the cross-attentions' ip path; ``ip_img`` [B // V, h, w, C]
    replaces the last view of every group of V (the identity view)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self._graphs: dict = {}       # signature(args) -> CapturedForward
        self.register_load_state_dict_post_hook(_drop_graphs_after_load)
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        ctx = cfg.cross_attention_dim
        n_levels = len(cfg.block_out_channels)

        def transformer(ch, level):
            return Transformer2D(ch, cfg.heads_for(level), ctx, cfg.use_linear_projection,
                                 cfg.num_views, cfg.ip_dim > 0)

        self.time_embedding = TimeEmbedding(ch0, temb_dim)
        if cfg.num_views > 1:
            self.camera_embedding = TimeEmbedding(CAMERA_DIM, temb_dim)
        if cfg.ip_dim > 0:
            self.image_embed = Resampler(cfg.ip_resampler_dim, cfg.ip_resampler_depth,
                                         cfg.ip_resampler_heads, cfg.ip_dim, cfg.ip_embed_dim,
                                         ctx)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        h_ch, skips = ch0, [ch0]
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(h_ch, ch, temb_dim))
                h_ch = ch
                if btype == "CrossAttnDownBlock2D":
                    self.add_module(f"down_{i}_attn_{j}", transformer(ch, i))
                skips.append(ch)
            if i < n_levels - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
                skips.append(ch)
        ch = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock(h_ch, ch, temb_dim)
        self.mid_attn = transformer(ch, n_levels - 1)
        self.mid_res_1 = ResnetBlock(ch, ch, temb_dim)
        h_ch = ch
        for i, (btype, ch) in enumerate(zip(cfg.up_block_types,
                                             reversed(cfg.block_out_channels))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(h_ch + skips.pop(), ch, temb_dim))
                h_ch = ch
                if btype == "CrossAttnUpBlock2D":
                    self.add_module(f"up_{i}_attn_{j}", transformer(ch, n_levels - 1 - i))
            if i < n_levels - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm32(h_ch)
        self.conv_out = nn.Conv2d(h_ch, cfg.out_channels, 3, padding=1)

    def _block(self, name):
        return getattr(self, name, None)

    def _apply(self, fn, recurse=True):
        # .to(), .cuda() and dtype casts come through here.
        self._drop_graphs()
        return super()._apply(fn, recurse)

    def _drop_graphs(self) -> None:
        """Forget the captured graphs, once their replays have finished."""
        for index in {key[1] for key in self._graphs}:
            torch.cuda.synchronize(index)
        self._graphs.clear()

    def forward(self, sample, timesteps, context, camera=None, ip=None, ip_img=None):
        with trace.span("unet", count="unet.calls"):
            args = (sample, timesteps, context, camera, ip, ip_img)
            if not graphable(args):
                return self._forward(*args)
            key = signature(args)
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = CapturedForward(self._forward, args)
                trace.count("unet.graph_captures")
            trace.count("unet.graph_replays")
            return graph(args)

    def _forward(self, sample, timesteps, context, camera=None, ip=None, ip_img=None):
        cfg = self.config
        dt = self.conv_in.weight.dtype
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt)
        temb = self.time_embedding(temb)
        if camera is not None:
            temb = temb + self.camera_embedding(camera.to(dt))
        context = context.to(dt)
        sample = sample.to(dt)
        if ip_img is not None:
            grouped = sample.reshape((-1, cfg.num_views) + tuple(sample.shape[1:]))
            sample = torch.cat([grouped[:, :-1], ip_img.to(dt)[:, None]],
                               1).reshape(sample.shape)
        n_ip = 0
        if ip is not None:
            if cfg.ip_dim == 0:
                raise ValueError(
                    "ip tokens given to a UNet without the IP-adapter path (ip_dim 0)")
            context = torch.cat([context, self.image_embed(ip)], dim=1)
            n_ip = cfg.ip_dim
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        n_levels = len(cfg.block_out_channels)
        for i in range(n_levels):
            for j in range(cfg.layers_per_block):
                h = self._block(f"down_{i}_res_{j}")(h, temb)
                attn = self._block(f"down_{i}_attn_{j}")
                if attn is not None:
                    h = attn(h, context, n_ip)
                skips.append(h)
            if i < n_levels - 1:
                h = self._block(f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), context, n_ip), temb)
        for i in range(n_levels):
            for j in range(cfg.layers_per_block + 1):
                h = self._block(f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                attn = self._block(f"up_{i}_attn_{j}")
                if attn is not None:
                    h = attn(h, context, n_ip)
            if i < n_levels - 1:
                h = self._block(f"up_{i}_upsample")(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1).float()


class TinyUNet(nn.Module):
    """Small UNet-shaped denoiser for tests and the fake guidance: NHWC in
    and out, the flax module's auto-named children (``Dense_0``, ``Conv_0``,
    ``GroupNorm_0``, ``Dense_1``, ``Conv_1``, ``Conv_2``). It takes and
    ignores the multi-view priors' ``camera``, ``ip`` and ``ip_img``, as the
    JAX fake backbone drops every keyword."""

    def __init__(self, in_channels: int = 4, channels: int = 16, context_dim: int = 32,
                 out_channels: int = 4):
        super().__init__()
        self.channels = channels
        self.Dense_0 = nn.Linear(channels, channels)
        self.Conv_0 = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.GroupNorm_0 = nn.GroupNorm(4, channels, eps=1e-6)
        self.Dense_1 = nn.Linear(context_dim, channels)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.Conv_2 = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, camera=None, ip=None, ip_img=None):
        with trace.span("unet", count="unet.calls"):
            temb = self.Dense_0(timestep_embedding(timesteps, self.channels))
            h = self.Conv_0(sample.permute(0, 3, 1, 2).float()) + temb[:, :, None, None]
            h = F.silu(self.GroupNorm_0(h)) + self.Dense_1(context.mean(1))[:, :, None, None]
            h = F.silu(self.Conv_1(h))
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            return self.Conv_2(h).permute(0, 2, 3, 1)
