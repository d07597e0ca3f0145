"""Random checkpoints in the real layouts, for tests and smoke runs.

The port's copy of ``synth_diffusers_unet`` / ``synth_diffusers_vae`` /
``synth_ldm_unet`` / ``synth_ldm_vae`` / ``synth_open_clip_text`` from
``dreamgaussian_tpu/guidance/synthetic.py``, plus the CLIP towers in
transformers' layout, Zero123's camera projection and a CLIP BPE
tokenizer with merges learned from a small corpus. Four checkpoints:
a Zero123 diffusers snapshot, an SD 2.1-base diffusers snapshot (its
``unet/config.json`` with ``attention_head_dim: [5, 10, 20, 20]``, as the
published one has it), MVDream's single LDM file (``torch.save``) and
ImageDream's (the ipmv UNet with its resampler and ``to_k_ip`` /
``to_v_ip``), with a CLIP ViT-H/14 ``image_encoder/`` folder beside it. The
key names and torch shapes follow the diffusers ``UNet2DConditionModel`` /
``AutoencoderKL``, transformers ``CLIPVisionModelWithProjection`` /
``CLIPVisionModel`` / ``CLIPTextModel``, ldm ``UNetModel`` (ImageDream's
``Resampler`` as the IP-adapter's) / ``AutoencoderKL`` and open_clip
text-tower module structures, written out here independently of
``convert.py``'s renaming, so that a wrong mapping fails the strict load
instead of cancelling itself out.

Values are drawn tensor by tensor from a seeded ``torch.Generator`` on a
given device (a full-width snapshot is about 1.25 B values): weights ~
N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases and embeddings
N(0, 0.02^2). ``write_safetensors`` writes each tensor as it is drawn
(header, then the raw bytes; F32, F16 or BF16), so host memory holds one
tensor at a time; ``torch.save`` of an LDM file holds the whole state
dict on the host (2.6 GB for MVDream, 2.8 GB for ImageDream in fp16 at
full width).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Iterable

import torch

from .. import resolve_device
from .clip import CLIPTextConfig, CLIPVisionConfig
from .tokenizer import BOS, EOS, bytes_to_unicode, clean_text, split_words
from .unet import CAMERA_DIM, UNetConfig
from .vae import VAEConfig

Spec = list[tuple[str, tuple[int, ...]]]

# The public openai/clip-vit-large-patch14 vision tower (Zero123's image encoder).
CLIP_VIT_L14 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                                num_attention_heads=16, image_size=224, patch_size=14,
                                projection_dim=768, hidden_act="quick_gelu")
# The OpenCLIP ViT-H/14 vision tower in transformers' CLIPVisionModel layout
# (ImageDream's image encoder: 257 tokens of width 1280).
CLIP_VIT_H14 = CLIPVisionConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                                num_attention_heads=16, image_size=224, patch_size=14,
                                projection_dim=1024, hidden_act="gelu")
# The public stabilityai/stable-diffusion-2-1-base text tower (OpenCLIP ViT-H
# without its last block, in transformers' layout); MVDream's OpenCLIP tower
# has all 24 blocks.
SD21_TEXT = CLIPTextConfig(vocab_size=49408, hidden_size=1024, intermediate_size=4096,
                           num_hidden_layers=23, num_attention_heads=16,
                           max_position_embeddings=77, hidden_act="gelu")
OPEN_CLIP_H_LAYERS = 24
SAFETENSORS_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
# Text the test tokenizers learn their merges from.
CORPUS = ("a hamburger, a photo of a hamburger on a plate; front view, side view, back view. "
          "ugly, bad anatomy, blurry, pixelated obscure, unnatural colors, poor lighting, "
          "dull, and unclear, cropped, lowres, low quality, artifacts, duplicate, morbid, "
          "mutilated, poorly drawn face, deformed, dehydrated, bad proportions. "
          "A DSLR photo of a corgi wearing a beret, 3D render of a castle.")


def _linear(spec: Spec, p: str, out_d: int, in_d: int, bias: bool = True) -> None:
    spec.append((p + ".weight", (out_d, in_d)))
    if bias:
        spec.append((p + ".bias", (out_d,)))


def _conv(spec: Spec, p: str, out_c: int, in_c: int, k: int = 3, bias: bool = True) -> None:
    spec.append((p + ".weight", (out_c, in_c, k, k)))
    if bias:
        spec.append((p + ".bias", (out_c,)))


def _norm(spec: Spec, p: str, c: int) -> None:
    spec += [(p + ".weight", (c,)), (p + ".bias", (c,))]


def _df_resnet(spec: Spec, p: str, in_c: int, out_c: int, temb: int | None) -> None:
    _norm(spec, p + ".norm1", in_c)
    _conv(spec, p + ".conv1", out_c, in_c)
    if temb is not None:
        _linear(spec, p + ".time_emb_proj", out_c, temb)
    _norm(spec, p + ".norm2", out_c)
    _conv(spec, p + ".conv2", out_c, out_c)
    if in_c != out_c:
        _conv(spec, p + ".conv_shortcut", out_c, in_c, k=1)


def _df_transformer(spec: Spec, p: str, ch: int, ctx: int, linear: bool = False) -> None:
    """Transformer2DModel with conv (or linear) projections and one
    BasicTransformerBlock (the same inner names in ldm's SpatialTransformer)."""
    _norm(spec, p + ".norm", ch)
    proj = (lambda name: _linear(spec, name, ch, ch)) if linear else \
        (lambda name: _conv(spec, name, ch, ch, k=1))
    proj(p + ".proj_in")
    tp = p + ".transformer_blocks.0"
    _norm(spec, tp + ".norm1", ch)
    for name in ("to_q", "to_k", "to_v"):
        _linear(spec, f"{tp}.attn1.{name}", ch, ch, bias=False)
    _linear(spec, tp + ".attn1.to_out.0", ch, ch)
    _norm(spec, tp + ".norm2", ch)
    _linear(spec, tp + ".attn2.to_q", ch, ch, bias=False)
    _linear(spec, tp + ".attn2.to_k", ch, ctx, bias=False)
    _linear(spec, tp + ".attn2.to_v", ch, ctx, bias=False)
    _linear(spec, tp + ".attn2.to_out.0", ch, ch)
    _norm(spec, tp + ".norm3", ch)
    _linear(spec, tp + ".ff.net.0.proj", ch * 8, ch)      # GEGLU: 2 x 4 x
    _linear(spec, tp + ".ff.net.2", ch, ch * 4)
    proj(p + ".proj_out")


def diffusers_unet_spec(cfg: UNetConfig) -> Spec:
    """(key, shape) of a UNet2DConditionModel state dict for ``cfg``."""
    spec: Spec = []
    ch = list(cfg.block_out_channels)
    temb = ch[0] * 4
    ctx = cfg.cross_attention_dim
    lin = cfg.use_linear_projection
    _conv(spec, "conv_in", ch[0], cfg.in_channels)
    _linear(spec, "time_embedding.linear_1", temb, ch[0])
    _linear(spec, "time_embedding.linear_2", temb, temb)
    if cfg.num_views > 1:
        _linear(spec, "camera_embedding.linear_1", temb, CAMERA_DIM)
        _linear(spec, "camera_embedding.linear_2", temb, temb)
    h = ch[0]
    skips = [h]
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            _df_resnet(spec, f"down_blocks.{i}.resnets.{j}", h, ch[i], temb)
            h = ch[i]
            if btype == "CrossAttnDownBlock2D":
                _df_transformer(spec, f"down_blocks.{i}.attentions.{j}", h, ctx, lin)
            skips.append(h)
        if i < len(ch) - 1:
            _conv(spec, f"down_blocks.{i}.downsamplers.0.conv", h, h)
            skips.append(h)
    _df_resnet(spec, "mid_block.resnets.0", h, ch[-1], temb)
    _df_transformer(spec, "mid_block.attentions.0", ch[-1], ctx, lin)
    _df_resnet(spec, "mid_block.resnets.1", ch[-1], ch[-1], temb)
    for i, (btype, c) in enumerate(zip(cfg.up_block_types, reversed(ch))):
        for j in range(cfg.layers_per_block + 1):
            _df_resnet(spec, f"up_blocks.{i}.resnets.{j}", h + skips.pop(), c, temb)
            h = c
            if btype == "CrossAttnUpBlock2D":
                _df_transformer(spec, f"up_blocks.{i}.attentions.{j}", h, ctx, lin)
        if i < len(ch) - 1:
            _conv(spec, f"up_blocks.{i}.upsamplers.0.conv", h, h)
    _norm(spec, "conv_norm_out", h)
    _conv(spec, "conv_out", cfg.out_channels, h)
    return spec


def diffusers_vae_spec(cfg: VAEConfig) -> Spec:
    """(key, shape) of an AutoencoderKL state dict for ``cfg``."""
    spec: Spec = []
    chans = list(cfg.block_out_channels)
    lat = cfg.latent_channels

    def mid(p: str, c: int) -> None:
        _df_resnet(spec, p + ".resnets.0", c, c, None)
        _norm(spec, p + ".attentions.0.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            _linear(spec, f"{p}.attentions.0.{name}", c, c)
        _df_resnet(spec, p + ".resnets.1", c, c, None)

    _conv(spec, "encoder.conv_in", chans[0], cfg.in_channels)
    h = chans[0]
    for i, c in enumerate(chans):
        for j in range(cfg.layers_per_block):
            _df_resnet(spec, f"encoder.down_blocks.{i}.resnets.{j}", h, c, None)
            h = c
        if i < len(chans) - 1:
            _conv(spec, f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
    mid("encoder.mid_block", h)
    _norm(spec, "encoder.conv_norm_out", h)
    _conv(spec, "encoder.conv_out", 2 * lat, h)
    _conv(spec, "quant_conv", 2 * lat, 2 * lat, k=1)
    _conv(spec, "post_quant_conv", lat, lat, k=1)
    _conv(spec, "decoder.conv_in", chans[-1], lat)
    h = chans[-1]
    mid("decoder.mid_block", h)
    for i, c in enumerate(reversed(chans)):
        for j in range(cfg.layers_per_block + 1):
            _df_resnet(spec, f"decoder.up_blocks.{i}.resnets.{j}", h, c, None)
            h = c
        if i < len(chans) - 1:
            _conv(spec, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
    _norm(spec, "decoder.conv_norm_out", h)
    _conv(spec, "decoder.conv_out", cfg.in_channels, h)
    return spec


def clip_vision_spec(cfg: CLIPVisionConfig, projection: bool = True) -> Spec:
    """(key, shape) of a CLIPVisionModelWithProjection state dict, or of a
    CLIPVisionModel's without ``projection``."""
    d, p = cfg.hidden_size, cfg.patch_size
    vm = "vision_model"
    spec: Spec = [
        (f"{vm}.embeddings.class_embedding", (d,)),
        (f"{vm}.embeddings.patch_embedding.weight", (d, cfg.num_channels, p, p)),
        (f"{vm}.embeddings.position_embedding.weight", ((cfg.image_size // p) ** 2 + 1, d)),
    ]
    _norm(spec, f"{vm}.pre_layrnorm", d)
    for i in range(cfg.num_hidden_layers):
        lp = f"{vm}.encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(spec, f"{lp}.self_attn.{name}", d, d)
        _norm(spec, f"{lp}.layer_norm1", d)
        _linear(spec, f"{lp}.mlp.fc1", cfg.intermediate_size, d)
        _linear(spec, f"{lp}.mlp.fc2", d, cfg.intermediate_size)
        _norm(spec, f"{lp}.layer_norm2", d)
    _norm(spec, f"{vm}.post_layernorm", d)
    if projection:
        _linear(spec, "visual_projection", cfg.projection_dim, d, bias=False)
    return spec


def clip_text_spec(cfg: CLIPTextConfig) -> Spec:
    """(key, shape) of a transformers CLIPTextModel state dict."""
    d, tm = cfg.hidden_size, "text_model"
    spec: Spec = [(f"{tm}.embeddings.token_embedding.weight", (cfg.vocab_size, d)),
                  (f"{tm}.embeddings.position_embedding.weight", (cfg.max_position_embeddings, d))]
    for i in range(cfg.num_hidden_layers):
        lp = f"{tm}.encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(spec, f"{lp}.self_attn.{name}", d, d)
        _norm(spec, f"{lp}.layer_norm1", d)
        _linear(spec, f"{lp}.mlp.fc1", cfg.intermediate_size, d)
        _linear(spec, f"{lp}.mlp.fc2", d, cfg.intermediate_size)
        _norm(spec, f"{lp}.layer_norm2", d)
    _norm(spec, f"{tm}.final_layer_norm", d)
    return spec


def _ldm_resnet(spec: Spec, p: str, in_c: int, out_c: int, temb: int) -> None:
    _norm(spec, p + ".in_layers.0", in_c)
    _conv(spec, p + ".in_layers.2", out_c, in_c)
    _linear(spec, p + ".emb_layers.1", out_c, temb)
    _norm(spec, p + ".out_layers.0", out_c)
    _conv(spec, p + ".out_layers.3", out_c, out_c)
    if in_c != out_c:
        _conv(spec, p + ".skip_connection", out_c, in_c, k=1)


def _ldm_resampler(spec: Spec, p: str, cfg: UNetConfig) -> None:
    """ImageDream's ``image_embed``: the IP-adapter Resampler (latents [1, Q,
    D]; per layer a PerceiverAttention of no-bias Linears and a feed-forward
    Sequential [LayerNorm, Linear, GELU, Linear])."""
    d = cfg.ip_resampler_dim
    spec.append((p + ".latents", (1, cfg.ip_dim, d)))
    _linear(spec, p + ".proj_in", d, cfg.ip_embed_dim)
    _linear(spec, p + ".proj_out", cfg.cross_attention_dim, d)
    _norm(spec, p + ".norm_out", cfg.cross_attention_dim)
    for i in range(cfg.ip_resampler_depth):
        lp = f"{p}.layers.{i}"
        _norm(spec, lp + ".0.norm1", d)
        _norm(spec, lp + ".0.norm2", d)
        _linear(spec, lp + ".0.to_q", d, d, bias=False)
        _linear(spec, lp + ".0.to_kv", 2 * d, d, bias=False)
        _linear(spec, lp + ".0.to_out", d, d, bias=False)
        _norm(spec, lp + ".1.0", d)
        _linear(spec, lp + ".1.1", 4 * d, d, bias=False)
        _linear(spec, lp + ".1.3", d, 4 * d, bias=False)


def _ldm_transformer(spec: Spec, p: str, ch: int, ctx: int, linear: bool, ip: bool) -> None:
    """ldm's SpatialTransformer; with ``ip`` the ipmv cross-attention's
    ``to_k_ip`` / ``to_v_ip``."""
    _df_transformer(spec, p, ch, ctx, linear)
    if ip:
        tp = p + ".transformer_blocks.0.attn2"
        _linear(spec, tp + ".to_k_ip", ch, ctx, bias=False)
        _linear(spec, tp + ".to_v_ip", ch, ctx, bias=False)


def ldm_unet_spec(cfg: UNetConfig) -> Spec:
    """(key, shape) of an ldm / MVDream / ImageDream ``UNetModel`` state dict:
    ``input_blocks`` (conv_in, per level [ResBlock, SpatialTransformer?] and
    a Downsample ``op``), ``middle_block``, ``output_blocks`` (the Upsample
    last in a level's last block), ``time_embed``, ``camera_embed`` (views
    > 1), ``image_embed`` and the ip projections (``ip_dim`` > 0), ``out``."""
    spec: Spec = []
    g = lambda name: "model.diffusion_model." + name  # noqa: E731
    ch = list(cfg.block_out_channels)
    temb, ctx, lin = ch[0] * 4, cfg.cross_attention_dim, cfg.use_linear_projection
    ip = cfg.ip_dim > 0
    _linear(spec, g("time_embed.0"), temb, ch[0])
    _linear(spec, g("time_embed.2"), temb, temb)
    if cfg.num_views > 1:
        _linear(spec, g("camera_embed.0"), temb, CAMERA_DIM)
        _linear(spec, g("camera_embed.2"), temb, temb)
    if ip:
        _ldm_resampler(spec, g("image_embed"), cfg)
    _conv(spec, g("input_blocks.0.0"), ch[0], cfg.in_channels)
    h, skips, ib = ch[0], [ch[0]], 1
    for i, btype in enumerate(cfg.down_block_types):
        for _ in range(cfg.layers_per_block):
            _ldm_resnet(spec, g(f"input_blocks.{ib}.0"), h, ch[i], temb)
            h = ch[i]
            if btype == "CrossAttnDownBlock2D":
                _ldm_transformer(spec, g(f"input_blocks.{ib}.1"), h, ctx, lin, ip)
            skips.append(h)
            ib += 1
        if i < len(ch) - 1:
            _conv(spec, g(f"input_blocks.{ib}.0.op"), h, h)
            skips.append(h)
            ib += 1
    _ldm_resnet(spec, g("middle_block.0"), h, h, temb)
    _ldm_transformer(spec, g("middle_block.1"), h, ctx, lin, ip)
    _ldm_resnet(spec, g("middle_block.2"), h, h, temb)
    ob = 0
    for i, (btype, c) in enumerate(zip(cfg.up_block_types, reversed(ch))):
        for j in range(cfg.layers_per_block + 1):
            _ldm_resnet(spec, g(f"output_blocks.{ob}.0"), h + skips.pop(), c, temb)
            h, sub = c, 1
            if btype == "CrossAttnUpBlock2D":
                _ldm_transformer(spec, g(f"output_blocks.{ob}.1"), h, ctx, lin, ip)
                sub = 2
            if j == cfg.layers_per_block and i < len(ch) - 1:
                _conv(spec, g(f"output_blocks.{ob}.{sub}.conv"), h, h)
            ob += 1
    _norm(spec, g("out.0"), h)
    _conv(spec, g("out.2"), cfg.out_channels, h)
    return spec


def ldm_vae_spec(cfg: VAEConfig) -> Spec:
    """(key, shape) of an ldm ``AutoencoderKL`` state dict (the decoder's
    ``up`` list indexed by resolution level; 1x1-conv mid attention)."""
    spec: Spec = []
    g = lambda name: "first_stage_model." + name  # noqa: E731
    chans, lat = list(cfg.block_out_channels), cfg.latent_channels
    n = len(chans)

    def res(p: str, in_c: int, out_c: int) -> None:
        _norm(spec, p + ".norm1", in_c)
        _conv(spec, p + ".conv1", out_c, in_c)
        _norm(spec, p + ".norm2", out_c)
        _conv(spec, p + ".conv2", out_c, out_c)
        if in_c != out_c:
            _conv(spec, p + ".nin_shortcut", out_c, in_c, k=1)

    def mid(p: str, c: int) -> None:
        res(p + ".block_1", c, c)
        _norm(spec, p + ".attn_1.norm", c)
        for name in ("q", "k", "v", "proj_out"):
            _conv(spec, f"{p}.attn_1.{name}", c, c, k=1)
        res(p + ".block_2", c, c)

    _conv(spec, g("encoder.conv_in"), chans[0], cfg.in_channels)
    h = chans[0]
    for i, c in enumerate(chans):
        for j in range(cfg.layers_per_block):
            res(g(f"encoder.down.{i}.block.{j}"), h, c)
            h = c
        if i < n - 1:
            _conv(spec, g(f"encoder.down.{i}.downsample.conv"), c, c)
    mid(g("encoder.mid"), h)
    _norm(spec, g("encoder.norm_out"), h)
    _conv(spec, g("encoder.conv_out"), 2 * lat, h)
    _conv(spec, g("quant_conv"), 2 * lat, 2 * lat, k=1)
    _conv(spec, g("post_quant_conv"), lat, lat, k=1)
    _conv(spec, g("decoder.conv_in"), chans[-1], lat)
    h = chans[-1]
    mid(g("decoder.mid"), h)
    for i, c in enumerate(reversed(chans)):
        for j in range(cfg.layers_per_block + 1):
            res(g(f"decoder.up.{n - 1 - i}.block.{j}"), h, c)
            h = c
        if i < n - 1:
            _conv(spec, g(f"decoder.up.{n - 1 - i}.upsample.conv"), c, c)
    _norm(spec, g("decoder.norm_out"), h)
    _conv(spec, g("decoder.conv_out"), cfg.in_channels, h)
    return spec


def open_clip_text_spec(width: int, layers: int, vocab_size: int = 49408,
                        context_length: int = 77) -> Spec:
    """(key, shape) of an open_clip text tower as ldm's FrozenOpenCLIPEmbedder
    holds it (the visual tower dropped; ``text_projection`` and
    ``logit_scale`` kept)."""
    g = lambda name: "cond_stage_model.model." + name  # noqa: E731
    spec: Spec = [(g("token_embedding.weight"), (vocab_size, width)),
                  (g("positional_embedding"), (context_length, width))]
    for i in range(layers):
        bp = g(f"transformer.resblocks.{i}")
        _norm(spec, bp + ".ln_1", width)
        spec += [(bp + ".attn.in_proj_weight", (3 * width, width)),
                 (bp + ".attn.in_proj_bias", (3 * width,))]
        _linear(spec, bp + ".attn.out_proj", width, width)
        _norm(spec, bp + ".ln_2", width)
        _linear(spec, bp + ".mlp.c_fc", 4 * width, width)
        _linear(spec, bp + ".mlp.c_proj", width, 4 * width)
    _norm(spec, g("ln_final"), width)
    spec += [(g("text_projection"), (width, width)), (g("logit_scale"), ())]
    return spec


# The DDPM schedule buffers an ldm LatentDiffusion state dict holds (1000 steps).
LDM_SCHEDULE = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


def camera_projection_spec(dim: int) -> Spec:
    """Zero123's CLIPCameraProjection: Linear(dim + 4 -> dim)."""
    spec: Spec = []
    _linear(spec, "proj", dim, dim + 4)
    return spec


def random_tensor(key: str, shape: tuple[int, ...], gen: torch.Generator,
                  device) -> torch.Tensor:
    """The float32 value of one snapshot tensor (see the module docstring)."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if key.endswith(".weight") and len(shape) == 1:          # a norm's scale
        return 1.0 + 0.1 * x
    if key.endswith("weight") and not key.endswith("position_embedding.weight"):
        return x * (math.prod(shape[1:]) ** -0.5)
    return x * 0.02                          # biases, class and position embeddings


def write_safetensors(path: str, spec: Spec, make: Callable[[str, tuple], torch.Tensor],
                      dtype: torch.dtype) -> int:
    """Write the tensors of ``spec``, each made by ``make(key, shape)`` and
    cast to ``dtype``, as a safetensors file; returns its size in bytes."""
    name = SAFETENSORS_NAMES[dtype]
    itemsize = torch.empty((), dtype=dtype).element_size()
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for key, shape in spec:
        n = math.prod(shape) * itemsize
        header[key] = {"dtype": name, "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for key, shape in spec:
            t = make(key, shape).to(dtype).contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def _made(gen: torch.Generator, device):
    return lambda k, s: random_tensor(k, s, gen, device)


def _write_model(folder: str, weights_name: str, config: dict, spec: Spec,
                 gen: torch.Generator, device, dtype) -> tuple[int, int]:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    size = write_safetensors(os.path.join(folder, weights_name), spec, _made(gen, device), dtype)
    return size, sum(math.prod(s) for _, s in spec)


def _vae_model(cfg: VAEConfig) -> tuple:
    return ("vae", "diffusion_pytorch_model.safetensors", {
        "_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
        "out_channels": cfg.in_channels, "latent_channels": cfg.latent_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block, "scaling_factor": cfg.scaling_factor,
    }, diffusers_vae_spec(cfg))


def _unet_json(cfg: UNetConfig) -> dict:
    return {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block,
            "cross_attention_dim": cfg.cross_attention_dim,
            "down_block_types": list(cfg.down_block_types),
            "up_block_types": list(cfg.up_block_types),
            "use_linear_projection": cfg.use_linear_projection, "flip_sin_to_cos": True,
            "freq_shift": 0}


def _clip_vision_model(cfg: CLIPVisionConfig) -> tuple:
    """A transformers CLIPVisionModelWithProjection folder's (subfolder,
    weights file, config, spec)."""
    return ("image_encoder", "model.safetensors", {
        "architectures": ["CLIPVisionModelWithProjection"],
        "model_type": "clip_vision_model", **cfg.__dict__,
    }, clip_vision_spec(cfg))


def write_clip_vision(folder: str, cfg: CLIPVisionConfig = CLIP_VIT_L14,
                      dtype: torch.dtype = torch.float16, seed: int = 0,
                      device="cuda") -> tuple[int, int]:
    """A random CLIPVisionModelWithProjection folder (``config.json`` and
    ``model.safetensors``), as a Zero123 snapshot's ``image_encoder/``.
    Returns (bytes, values)."""
    device = resolve_device(device)
    _, name, config, spec = _clip_vision_model(cfg)
    return _write_model(folder, name, config, spec,
                        torch.Generator(device=device).manual_seed(seed), device, dtype)


def write_zero123_snapshot(root: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                           clip_cfg: CLIPVisionConfig, dtype: torch.dtype = torch.float16,
                           seed: int = 0, device="cuda") -> dict:
    """A random Zero123 diffusers snapshot under ``root``: ``unet/``,
    ``vae/``, ``image_encoder/`` and ``clip_camera_projection/``, each with
    its ``config.json`` and a safetensors file in ``dtype``, drawn on
    ``device``. Returns {folder: (bytes, values)}."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = unet_cfg.cross_attention_dim
    if clip_cfg.projection_dim != ctx:
        raise ValueError(f"the CLIP projection ({clip_cfg.projection_dim}) must have the "
                         f"UNet's cross-attention width ({ctx})")
    models: Iterable = (
        # SD1.x configs name the head count attention_head_dim.
        ("unet", "diffusion_pytorch_model.safetensors",
         {**_unet_json(unet_cfg), "attention_head_dim": unet_cfg.num_attention_heads},
         diffusers_unet_spec(unet_cfg)),
        _vae_model(vae_cfg),
        _clip_vision_model(clip_cfg),
        ("clip_camera_projection", "diffusion_pytorch_model.safetensors", {
            "_class_name": "CLIPCameraProjection", "embedding_dim": ctx,
            "additional_embeddings": 4,
        }, camera_projection_spec(ctx)),
    )
    return {sub: _write_model(os.path.join(root, sub), name, config, spec, gen, device, dtype)
            for sub, name, config, spec in models}


def write_sd_snapshot(root: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                      text_cfg: CLIPTextConfig, dtype: torch.dtype = torch.float16, seed: int = 0,
                      device="cuda") -> dict:
    """A random SD 2.x diffusers snapshot under ``root``: ``unet/`` (its
    config.json giving the heads per level as diffusers reads SD 2.1-base's
    list, ``[5, 10, 20, 20]`` at full width), ``vae/``, ``text_encoder/``
    (transformers' CLIPTextModel) and ``tokenizer/``, drawn on ``device``.
    Returns {folder: (bytes, values)}."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    heads = [unet_cfg.heads_for(i) for i in range(len(unet_cfg.block_out_channels))]
    models = (
        ("unet", "diffusion_pytorch_model.safetensors",
         {**_unet_json(unet_cfg), "attention_head_dim": heads}, diffusers_unet_spec(unet_cfg)),
        _vae_model(vae_cfg),
        ("text_encoder", "model.safetensors",
         {"architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
          **dataclasses.asdict(text_cfg)}, clip_text_spec(text_cfg)),
    )
    out = {sub: _write_model(os.path.join(root, sub), name, config, spec, gen, device, dtype)
           for sub, name, config, spec in models}
    write_clip_tokenizer(os.path.join(root, "tokenizer"),
                         model_max_length=text_cfg.max_position_embeddings)
    return out


def write_mvdream_checkpoint(path: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                             text_width: int = 1024, text_layers: int = OPEN_CLIP_H_LAYERS,
                             vocab_size: int = 49408, dtype: torch.dtype = torch.float16,
                             seed: int = 0,
                             device="cuda") -> tuple[int, int]:
    """A random single-file MVDream LDM checkpoint at ``path`` (``torch.save``
    of the UNet with ``camera_embed``, the VAE, the OpenCLIP text tower and
    the schedule buffers, in ``dtype``), with a ``tokenizer/`` folder beside
    it. Returns (bytes, values)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = (ldm_unet_spec(unet_cfg) + ldm_vae_spec(vae_cfg)
            + open_clip_text_spec(text_width, text_layers, vocab_size)
            + [(name, (1000,)) for name in LDM_SCHEDULE])
    make = _made(gen, device)
    sd = {k: make(k, shape).to(dtype).cpu() for k, shape in spec}
    torch.save(sd, path)
    write_clip_tokenizer(os.path.join(os.path.dirname(path), "tokenizer"))
    return os.path.getsize(path), sum(math.prod(s) for _, s in spec)


def write_imagedream_checkpoint(path: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                                clip_cfg: CLIPVisionConfig = CLIP_VIT_H14,
                                text_width: int = 1024, text_layers: int = OPEN_CLIP_H_LAYERS,
                                vocab_size: int = 49408, dtype: torch.dtype = torch.float16,
                                seed: int = 0, device="cuda") -> dict:
    """A random single-file ImageDream checkpoint at ``path``
    (``write_mvdream_checkpoint`` with the ipmv UNet of ``unet_cfg``, whose
    ``ip_dim`` must be > 0), its ``tokenizer/`` and an ``image_encoder/``
    folder (a transformers CLIPVisionModel of ``clip_cfg``, whose width the
    resampler takes) beside it. Returns {"ldm" | "image_encoder": (bytes,
    values)}."""
    if unet_cfg.ip_dim <= 0 or clip_cfg.hidden_size != unet_cfg.ip_embed_dim:
        raise ValueError(f"an ImageDream UNet needs ip_dim > 0 and ip_embed_dim equal to the "
                         f"image encoder's width {clip_cfg.hidden_size}; got ip_dim "
                         f"{unet_cfg.ip_dim}, ip_embed_dim {unet_cfg.ip_embed_dim}")
    out = {"ldm": write_mvdream_checkpoint(path, unet_cfg, vae_cfg, text_width, text_layers,
                                           vocab_size, dtype, seed, device)}
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out["image_encoder"] = _write_model(
        os.path.join(os.path.dirname(path), "image_encoder"), "model.safetensors",
        {"architectures": ["CLIPVisionModel"], "model_type": "clip_vision_model",
         **dataclasses.asdict(clip_cfg)},
        clip_vision_spec(clip_cfg, projection=False), gen, device, dtype)
    return out


def learn_merges(corpus: str, n_merges: int) -> list[tuple[str, str]]:
    """Byte-level BPE merges learned from the pieces that the tokenizer
    splits ``corpus`` into, the most frequent pair first (ties to the pair
    seen first)."""
    enc = bytes_to_unicode()
    words: dict = {}
    for w in split_words(clean_text(corpus)):
        chars = [enc[b] for b in w.encode("utf-8")]
        key = tuple(chars[:-1]) + (chars[-1] + "</w>",)
        words[key] = words.get(key, 0) + 1
    merges: list = []
    while len(merges) < n_merges:
        counts: dict = {}
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                counts[pair] = counts.get(pair, 0) + n
        if not counts:
            break
        best = max(counts, key=counts.get)
        merges.append(best)
        merged = {}
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    return merges


def write_clip_tokenizer(path: str, n_merges: int = 200, model_max_length: int = 77,
                         pad_token: str = EOS) -> str:
    """CLIP tokenizer files in transformers' layout, with real merges: the
    vocabulary is CLIP's (the 256 byte characters, the same with ``</w>``,
    one token per merge, then the start and end tokens)."""
    os.makedirs(path, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    merges = learn_merges(CORPUS, n_merges)
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges] + [BOS, EOS]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": pad_token}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({**special, "model_max_length": model_max_length,
                   "tokenizer_class": "CLIPTokenizer"}, f)
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump(special, f)
    return path


# The apps' metric and matting models, as torch.save'd state dicts.
VGG16_FEATURES = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
                  (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
                  (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512))
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def _save_state(path: str, spec: Spec, make: Callable[[str, tuple], torch.Tensor]) -> int:
    sd = {k: make(k, shape).cpu() for k, shape in spec}
    torch.save(sd, path)
    return sum(math.prod(shape) for _, shape in spec)


def write_u2net(path: str, full: bool = True, seed: int = 0, device="cuda") -> int:
    """A random ``u2net.pth`` (``full``) or ``u2netp.pth`` state dict in the
    official layout, float32, with positive BatchNorm variances. Returns the
    number of values."""
    from ..preprocess.u2net import FULL_CFG, SMALL_CFG, U2NET

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        sd = U2NET(FULL_CFG if full else SMALL_CFG).state_dict()

    def make(key, shape):
        if key.endswith("num_batches_tracked"):
            return torch.zeros(shape, dtype=torch.int64)
        x = random_tensor(key, shape, gen, device)
        return 1.0 + x.abs() if key.endswith("running_var") else x

    return _save_state(path, [(k, tuple(v.shape)) for k, v in sd.items()], make)


def write_vgg16_features(path: str, seed: int = 0, device="cuda") -> int:
    """A random torchvision ``vgg16`` state dict's ``features.N`` convolutions
    (the ``vgg16-397923af.pth`` keys LPIPS reads), float32."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    spec: Spec = []
    for i, cin, cout in VGG16_FEATURES:
        _conv(spec, f"features.{i}", cout, cin)
    return _save_state(path, spec, _made(gen, device))


def write_lpips_lins(path: str, seed: int = 0, device="cuda") -> int:
    """A random lpips ``vgg.pth``: ``lin{k}.model.1.weight`` [1, C, 1, 1],
    non-negative as lpips keeps them, float32."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    spec: Spec = [(f"lin{k}.model.1.weight", (1, c, 1, 1)) for k, c in enumerate(LPIPS_CHANNELS)]
    return _save_state(path, spec, lambda k, s: torch.rand(s, generator=gen, device=device) / s[1])
