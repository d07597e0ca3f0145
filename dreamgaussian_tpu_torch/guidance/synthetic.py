"""Random Zero123 snapshots in the diffusers layout, for tests and smoke runs.

The port's copy of ``synth_diffusers_unet`` / ``synth_diffusers_vae`` from
``dreamgaussian_tpu/guidance/synthetic.py``, plus a CLIP vision tower in
transformers' layout and Zero123's camera projection. The key names and
torch shapes follow the diffusers ``UNet2DConditionModel`` /
``AutoencoderKL`` and transformers ``CLIPVisionModelWithProjection``
module structures, written out here independently of ``convert.py``'s
renaming, so that a wrong mapping fails the strict load instead of
cancelling itself out.

Values are drawn tensor by tensor from a seeded ``torch.Generator`` on a
given device (a full-width snapshot is about 1.25 B values): weights ~
N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases and embeddings
N(0, 0.02^2). ``write_safetensors`` writes each tensor as it is drawn
(header, then the raw bytes; F32, F16 or BF16), so host memory holds one
tensor at a time.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Iterable

import torch

from .. import resolve_device
from .clip import CLIPVisionConfig
from .unet import UNetConfig
from .vae import VAEConfig

Spec = list[tuple[str, tuple[int, ...]]]

# The public openai/clip-vit-large-patch14 vision tower (Zero123's image encoder).
CLIP_VIT_L14 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                                num_attention_heads=16, image_size=224, patch_size=14,
                                projection_dim=768, hidden_act="quick_gelu")
SAFETENSORS_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


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


def _df_transformer(spec: Spec, p: str, ch: int, ctx: int) -> None:
    """Transformer2DModel with conv projections and one BasicTransformerBlock."""
    _norm(spec, p + ".norm", ch)
    _conv(spec, p + ".proj_in", ch, ch, k=1)
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
    _conv(spec, p + ".proj_out", ch, ch, k=1)


def diffusers_unet_spec(cfg: UNetConfig) -> Spec:
    """(key, shape) of a UNet2DConditionModel state dict for ``cfg``."""
    spec: Spec = []
    ch = list(cfg.block_out_channels)
    temb = ch[0] * 4
    ctx = cfg.cross_attention_dim
    _conv(spec, "conv_in", ch[0], cfg.in_channels)
    _linear(spec, "time_embedding.linear_1", temb, ch[0])
    _linear(spec, "time_embedding.linear_2", temb, temb)
    h = ch[0]
    skips = [h]
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            _df_resnet(spec, f"down_blocks.{i}.resnets.{j}", h, ch[i], temb)
            h = ch[i]
            if btype == "CrossAttnDownBlock2D":
                _df_transformer(spec, f"down_blocks.{i}.attentions.{j}", h, ctx)
            skips.append(h)
        if i < len(ch) - 1:
            _conv(spec, f"down_blocks.{i}.downsamplers.0.conv", h, h)
            skips.append(h)
    _df_resnet(spec, "mid_block.resnets.0", h, ch[-1], temb)
    _df_transformer(spec, "mid_block.attentions.0", ch[-1], ctx)
    _df_resnet(spec, "mid_block.resnets.1", ch[-1], ch[-1], temb)
    for i, (btype, c) in enumerate(zip(cfg.up_block_types, reversed(ch))):
        for j in range(cfg.layers_per_block + 1):
            _df_resnet(spec, f"up_blocks.{i}.resnets.{j}", h + skips.pop(), c, temb)
            h = c
            if btype == "CrossAttnUpBlock2D":
                _df_transformer(spec, f"up_blocks.{i}.attentions.{j}", h, ctx)
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


def clip_vision_spec(cfg: CLIPVisionConfig) -> Spec:
    """(key, shape) of a CLIPVisionModelWithProjection state dict."""
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
    _linear(spec, "visual_projection", cfg.projection_dim, d, bias=False)
    return spec


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
    if key.endswith(".weight") and not key.endswith("position_embedding.weight"):
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


def _write_model(folder: str, weights_name: str, config: dict, spec: Spec,
                 gen: torch.Generator, device, dtype) -> tuple[int, int]:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    size = write_safetensors(os.path.join(folder, weights_name), spec,
                             lambda k, s: random_tensor(k, s, gen, device), dtype)
    return size, sum(math.prod(s) for _, s in spec)


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
        ("unet", "diffusion_pytorch_model.safetensors", {
            "_class_name": "UNet2DConditionModel",
            "in_channels": unet_cfg.in_channels, "out_channels": unet_cfg.out_channels,
            "block_out_channels": list(unet_cfg.block_out_channels),
            "layers_per_block": unet_cfg.layers_per_block, "cross_attention_dim": ctx,
            # SD1.x configs name the head count attention_head_dim.
            "attention_head_dim": unet_cfg.num_attention_heads,
            "down_block_types": list(unet_cfg.down_block_types),
            "up_block_types": list(unet_cfg.up_block_types),
            "use_linear_projection": False, "flip_sin_to_cos": True, "freq_shift": 0,
        }, diffusers_unet_spec(unet_cfg)),
        ("vae", "diffusion_pytorch_model.safetensors", {
            "_class_name": "AutoencoderKL", "in_channels": vae_cfg.in_channels,
            "out_channels": vae_cfg.in_channels, "latent_channels": vae_cfg.latent_channels,
            "block_out_channels": list(vae_cfg.block_out_channels),
            "layers_per_block": vae_cfg.layers_per_block,
            "scaling_factor": vae_cfg.scaling_factor,
        }, diffusers_vae_spec(vae_cfg)),
        ("image_encoder", "model.safetensors", {
            "architectures": ["CLIPVisionModelWithProjection"],
            "model_type": "clip_vision_model", **clip_cfg.__dict__,
        }, clip_vision_spec(clip_cfg)),
        ("clip_camera_projection", "diffusion_pytorch_model.safetensors", {
            "_class_name": "CLIPCameraProjection", "embedding_dim": ctx,
            "additional_embeddings": 4,
        }, camera_projection_spec(ctx)),
    )
    return {sub: _write_model(os.path.join(root, sub), name, config, spec, gen, device, dtype)
            for sub, name, config, spec in models}
