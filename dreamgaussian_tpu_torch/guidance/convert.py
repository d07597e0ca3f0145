"""Diffusers snapshots and single-file LDM checkpoints into the port's modules.

Port of ``dreamgaussian_tpu/guidance/convert.py``.
``load_torch_state_dict`` finds a model's weights file in a snapshot
folder (the JAX package's search order) and returns its tensors on the
CPU without reading the file into memory first:

- ``.safetensors`` is parsed here (8-byte little-endian header length, a
  JSON header with each tensor's dtype, shape and ``data_offsets``, then
  the raw bytes) and mapped copy-on-write with ``numpy.memmap``, so each
  tensor is a view of the file: F32, F16 and BF16 (through torch, as
  numpy has no bfloat16), and I64 (the ``position_ids`` buffer that some
  CLIP snapshots ship);
- ``.bin`` is read with ``torch.load(weights_only=True, mmap=True)``,
  unwrapping a ``state_dict`` entry.

The port's modules keep torch's layouts, so unlike the JAX package's
conversion (transposes into flax trees) the mapping is a renaming of keys:
``down_blocks.{i}.resnets.{j}`` -> ``down_{i}_res_{j}``, ``to_out.0`` ->
``to_out_0``, ``ff.net.0.proj`` -> ``ff.net_0_proj`` and so on.
``load_into`` copies each tensor straight into its parameter, casting to
the parameter's dtype and device one tensor at a time, and is strict: a
key that no parameter takes, a parameter that no key fills, or a shape
that differs raises.

The single-file LDM layout (MVDream's ``sd-v2.1-base-4view.pt``,
ImageDream's ``sd-v2.1-base-4view-ipmv.pt``) holds three models under
``model.diffusion_model.`` (the UNet, with MVDream's ``camera_embed`` and
ImageDream's ``image_embed`` resampler and ``attn2.to_k_ip`` /
``to_v_ip``), ``first_stage_model.`` (the VAE) and
``cond_stage_model.model.`` (the OpenCLIP text tower). ``split_ldm``
splits it and ignores by name what no model uses (the diffusion schedule
buffers, the text tower's projection, logit scale and causal-mask
buffer); any other key raises. ``ldm_unet_config`` / ``ldm_vae_config``
read the architecture from the tensors' shapes; ``ldm_unet_state``,
``ldm_vae_state`` and ``open_clip_text_state`` rename the tensors onto the
port's modules as views (the VAE attention's 1x1 convolutions as
matrices, OpenCLIP's ``in_proj_weight`` split into q, k and v; the
OpenCLIP tower becomes ``clip.CLIPTextModel`` without its last block,
which the penultimate-layer conditioning skips).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)
# safetensors dtype -> numpy dtype of the stored bytes (BF16 is read as int16
# and viewed as torch.bfloat16).
SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.int16, "I64": np.int64}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, each a CPU view of the file
    mapped copy-on-write (nothing is read until a tensor is used)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if n <= 0 or 8 + n > size:
            raise ValueError(f"{path}: not a safetensors file (header length {n})")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    start = 8 + n
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start) if size > start
            else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        kind, shape = info["dtype"], tuple(info["shape"])
        lo, hi = info["data_offsets"]
        if kind not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {kind}")
        np_dtype = np.dtype(SAFETENSORS_DTYPES[kind])
        if not 0 <= lo <= hi <= len(data) or hi - lo != math.prod(shape) * np_dtype.itemsize:
            raise ValueError(f"{path}: tensor {name} has bad data_offsets {lo, hi} for "
                             f"{kind} {list(shape)}")
        t = torch.from_numpy(data[lo:hi].view(np_dtype))
        if kind == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(shape)
    return out


def load_torch_state_dict(path_or_dir: str, subfolder: str = "") -> dict[str, torch.Tensor]:
    """A state dict from a ``.safetensors`` / ``.bin`` file or a diffusers
    model folder (``path_or_dir/subfolder``), as CPU tensors in their
    stored dtypes."""
    root = os.path.join(path_or_dir, subfolder) if subfolder else path_or_dir
    if os.path.isdir(root):
        for name in WEIGHT_FILES:
            p = os.path.join(root, name)
            if os.path.exists(p):
                root = p
                break
        else:
            raise FileNotFoundError(f"no model weights found under {root}")
    elif not os.path.exists(root):
        raise FileNotFoundError(f"no model weights found at {root}")
    if root.endswith(".safetensors"):
        return read_safetensors(root)
    sd = torch.load(root, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def _renamer(rules: Iterable[tuple[str, str]]) -> Callable[[str], str]:
    compiled = [(re.compile(pattern), repl) for pattern, repl in rules]

    def rename(key: str) -> str:
        for pattern, repl in compiled:
            key = pattern.sub(repl, key)
        return key
    return rename


_ATTENTION_RULES = (
    (r"\.transformer_blocks\.(\d+)\.", r".transformer_blocks_\1."),
    (r"\.to_out\.0\.", ".to_out_0."),
    (r"\.ff\.net\.0\.proj\.", ".ff.net_0_proj."),
    (r"\.ff\.net\.2\.", ".ff.net_2."),
)
# diffusers UNet2DConditionModel -> guidance/unet.py UNet.
unet_key = _renamer((
    (r"^down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down_\1_res_\2."),
    (r"^down_blocks\.(\d+)\.attentions\.(\d+)\.", r"down_\1_attn_\2."),
    (r"^down_blocks\.(\d+)\.downsamplers\.0\.", r"down_\1_downsample."),
    (r"^up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up_\1_res_\2."),
    (r"^up_blocks\.(\d+)\.attentions\.(\d+)\.", r"up_\1_attn_\2."),
    (r"^up_blocks\.(\d+)\.upsamplers\.0\.", r"up_\1_upsample."),
    (r"^mid_block\.resnets\.(\d+)\.", r"mid_res_\1."),
    (r"^mid_block\.attentions\.0\.", "mid_attn."),
    *_ATTENTION_RULES,
))
# diffusers AutoencoderKL -> guidance/vae.py AutoencoderKL (whose encoder
# holds quant_conv and whose decoder holds post_quant_conv).
vae_key = _renamer((
    (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.", r"encoder.down_\1_res_\2."),
    (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"encoder.down_\1_downsample."),
    (r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.", r"decoder.up_\1_res_\2."),
    (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"decoder.up_\1_upsample."),
    (r"^(encoder|decoder)\.mid_block\.resnets\.(\d+)\.", r"\1.mid_res_\2."),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.", r"\1.mid_attn."),
    (r"^quant_conv\.", "encoder.quant_conv."),
    (r"^post_quant_conv\.", "decoder.post_quant_conv."),
    (r"\.to_out\.0\.", ".to_out_0."),
))


@torch.no_grad()
def load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
              rename: Callable[[str], str] = lambda k: k,
              skip: tuple[str, ...] = ()) -> torch.nn.Module:
    """Copy ``sd`` into ``module``'s parameters under ``rename`` (strict;
    keys ending in one of ``skip`` are buffers the module computes itself)."""
    params = dict(module.named_parameters())
    filled = set()
    for key, t in sd.items():
        if key.endswith(skip):
            continue
        name = rename(key)
        p = params.get(name)
        if p is None:
            raise KeyError(f"snapshot key {key!r} (as {name!r}) is no parameter of "
                           f"{type(module).__name__}")
        if tuple(p.shape) != tuple(t.shape):
            raise ValueError(f"snapshot key {key!r} has shape {tuple(t.shape)}, parameter "
                             f"{name!r} {tuple(p.shape)}")
        p.copy_(t)
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"{len(missing)} parameters of {type(module).__name__} have no "
                       f"snapshot key, first {missing[:5]}")
    return module


def camera_projection(sd: Mapping[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero123's ``clip_camera_projection`` Linear as ``(w.T [in, out], b)``."""
    (wk,) = [k for k in sd if k.endswith("weight")]
    (bk,) = [k for k in sd if k.endswith("bias")]
    return sd[wk].T.contiguous(), sd[bk]


# -- the single-file LDM layout ---------------------------------------------------

LDM_PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                "text": "cond_stage_model.model."}
# What the checkpoint holds and no model of the port uses: the DDPM schedule
# (the port's scheduler computes its own), the text tower's projection and
# logit scale (the conditioning reads hidden states), its causal-mask buffer.
LDM_UNUSED = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "cond_stage_model.model.text_projection", "cond_stage_model.model.logit_scale",
    "cond_stage_model.model.attn_mask",
))


def is_ldm_layout(sd: Mapping) -> bool:
    return any(k.startswith(LDM_PREFIXES["unet"]) for k in sd)


def split_ldm(sd: Mapping[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """{"unet", "vae", "text"}: each model's tensors with its prefix taken off;
    raises for a key of no model that is not in ``LDM_UNUSED``."""
    out: dict = {name: {} for name in LDM_PREFIXES}
    for key, t in sd.items():
        name = next((n for n, p in LDM_PREFIXES.items() if key.startswith(p)), None)
        if name is not None and key not in LDM_UNUSED:
            out[name][key[len(LDM_PREFIXES[name]):]] = t
        elif key not in LDM_UNUSED:
            raise KeyError(f"LDM checkpoint key {key!r} belongs to no model the port loads")
    return out


def _ldm_levels(sd: Mapping, blocks: str) -> list[list[tuple[int, bool]]]:
    """The UNet's levels read from ``input_blocks``: per level, its resnets'
    (output channels, has a transformer)."""
    levels: list = [[]]
    i = 1
    while f"{blocks}.{i}.0.op.weight" in sd or f"{blocks}.{i}.0.in_layers.2.weight" in sd:
        if f"{blocks}.{i}.0.op.weight" in sd:
            levels.append([])
        else:
            levels[-1].append((sd[f"{blocks}.{i}.0.in_layers.2.weight"].shape[0],
                               f"{blocks}.{i}.1.norm.weight" in sd))
        i += 1
    return levels


# The IP-adapter Resampler's heads are 64 wide (ImageDream's 12 make 768).
IP_HEAD_WIDTH = 64


def _ldm_ip_config(sd: Mapping[str, torch.Tensor]) -> dict:
    """ImageDream's IP-adapter fields read from an LDM UNet's ``image_embed``
    (``ip_dim`` 0 without one): the query count and width of ``latents``
    [1, Q, D], the attention width ``to_q`` gives in heads of width
    ``IP_HEAD_WIDTH`` (no head width of its own where it is D's), the token
    width ``proj_in`` takes, the layers."""
    if "image_embed.latents" not in sd:
        return {"ip_dim": 0}
    depth = 0
    while f"image_embed.layers.{depth}.0.to_q.weight" in sd:
        depth += 1
    _, queries, dim = sd["image_embed.latents"].shape
    inner = sd["image_embed.layers.0.0.to_q.weight"].shape[0]
    heads = max(1, inner // IP_HEAD_WIDTH)
    return {"ip_dim": queries, "ip_resampler_dim": dim, "ip_resampler_depth": depth,
            "ip_resampler_heads": heads,
            "ip_resampler_dim_head": None if inner == dim else inner // heads,
            "ip_embed_dim": sd["image_embed.proj_in.weight"].shape[1]}


def ldm_unet_config(sd: Mapping[str, torch.Tensor], default):
    """``default`` (a ``unet.UNetConfig``) with the architecture of an LDM
    UNet state dict (``split_ldm(...)["unet"]``): channels, blocks, context
    width, projections, ImageDream's resampler (its widths, depth and heads
    of width 64; no IP-adapter path without one). The UNet's heads and the
    views stay ``default``'s."""
    levels = _ldm_levels(sd, "input_blocks")
    attn = next(k for k in sd if k.endswith("attn2.to_k.weight"))
    proj = next(k for k in sd if k.endswith(".proj_in.weight"))
    up_types, ob = [], 0
    for lvl in reversed(levels):
        up_types.append("CrossAttnUpBlock2D" if f"output_blocks.{ob}.1.norm.weight" in sd
                        else "UpBlock2D")
        ob += len(lvl) + 1
    return dataclasses.replace(
        default,
        in_channels=sd["input_blocks.0.0.weight"].shape[1],
        out_channels=sd["out.2.weight"].shape[0],
        block_out_channels=tuple(lvl[0][0] for lvl in levels),
        layers_per_block=len(levels[0]),
        cross_attention_dim=sd[attn].shape[1],
        use_linear_projection=sd[proj].dim() == 2,
        down_block_types=tuple("CrossAttnDownBlock2D" if lvl[0][1] else "DownBlock2D"
                               for lvl in levels),
        up_block_types=tuple(up_types),
        **_ldm_ip_config(sd),
    )


_LDM_RESNET = _renamer((
    (r"^in_layers\.0\.", "norm1."), (r"^in_layers\.2\.", "conv1."),
    (r"^emb_layers\.1\.", "time_emb_proj."), (r"^out_layers\.0\.", "norm2."),
    (r"^out_layers\.3\.", "conv2."), (r"^skip_connection\.", "conv_shortcut."),
))


def _ldm_transformer(rest: str) -> str:
    return _renamer(_ATTENTION_RULES)("." + rest)[1:]


def _same(rest: str) -> str:
    return rest


# ImageDream's resampler: layers.{i}.0 is the PerceiverAttention, layers.{i}.1
# the feed-forward Sequential (0 LayerNorm, 1 Linear, 2 GELU, 3 Linear).
_LDM_RESAMPLER = _renamer((
    (r"^layers\.(\d+)\.0\.", r"layers_\1_attn."),
    (r"^layers\.(\d+)\.1\.0\.", r"layers_\1_ff_norm."),
    (r"^layers\.(\d+)\.1\.1\.", r"layers_\1_ff_in."),
    (r"^layers\.(\d+)\.1\.3\.", r"layers_\1_ff_out."),
))


def ldm_unet_state(sd: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """An LDM UNet state dict (``split_ldm(...)["unet"]``) under the names of
    ``unet.UNet(cfg)``: ``input_blocks``, ``middle_block`` and
    ``output_blocks`` in SD 2.x's order, ``time_embed.0/2``, MVDream's
    ``camera_embed.0/2``, ``out.0/2``, ImageDream's ``image_embed`` (its
    ``latents`` [1, Q, D] as [Q, D]; ``attn2.to_k_ip`` / ``to_v_ip`` keep
    their names)."""
    blocks = {"input_blocks.0.0": ("conv_in", _same), "out.0": ("conv_norm_out", _same),
              "out.2": ("conv_out", _same),
              "time_embed.0": ("time_embedding.linear_1", _same),
              "time_embed.2": ("time_embedding.linear_2", _same),
              "camera_embed.0": ("camera_embedding.linear_1", _same),
              "camera_embed.2": ("camera_embedding.linear_2", _same),
              "middle_block.0": ("mid_res_0", _LDM_RESNET),
              "middle_block.1": ("mid_attn", _ldm_transformer),
              "middle_block.2": ("mid_res_1", _LDM_RESNET)}
    n = len(cfg.block_out_channels)
    ib = 1
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            blocks[f"input_blocks.{ib}.0"] = (f"down_{i}_res_{j}", _LDM_RESNET)
            if btype == "CrossAttnDownBlock2D":
                blocks[f"input_blocks.{ib}.1"] = (f"down_{i}_attn_{j}", _ldm_transformer)
            ib += 1
        if i < n - 1:
            blocks[f"input_blocks.{ib}.0"] = (f"down_{i}_downsample",
                                              lambda r: re.sub(r"^op\.", "conv.", r))
            ib += 1
    ob = 0
    for i, btype in enumerate(cfg.up_block_types):
        for j in range(cfg.layers_per_block + 1):
            blocks[f"output_blocks.{ob}.0"] = (f"up_{i}_res_{j}", _LDM_RESNET)
            sub = 1
            if btype == "CrossAttnUpBlock2D":
                blocks[f"output_blocks.{ob}.1"] = (f"up_{i}_attn_{j}", _ldm_transformer)
                sub = 2
            if j == cfg.layers_per_block and i < n - 1:
                blocks[f"output_blocks.{ob}.{sub}"] = (f"up_{i}_upsample", _same)
            ob += 1
    pattern = re.compile(r"^((?:input_blocks|output_blocks)\.\d+\.\d+|middle_block\.\d+|"
                         r"(?:time_embed|camera_embed|out)\.\d+)\.(.+)$")
    out = {}
    for key, t in sd.items():
        if key.startswith("image_embed."):
            rest = key[len("image_embed."):]
            out["image_embed." + _LDM_RESAMPLER(rest)] = t[0] if rest == "latents" else t
            continue
        m = pattern.match(key)
        if m is None or m.group(1) not in blocks:
            raise KeyError(f"LDM UNet key {key!r} has no place in the port's UNet")
        name, inner = blocks[m.group(1)]
        out[f"{name}.{inner(m.group(2))}"] = t
    return out


def ldm_vae_config(sd: Mapping[str, torch.Tensor], default):
    """``default`` (a ``vae.VAEConfig``) with the architecture of an LDM VAE
    state dict (``split_ldm(...)["vae"]``); the scaling factor stays."""
    n = 0
    while f"encoder.down.{n}.block.0.conv1.weight" in sd:
        n += 1
    layers = 0
    while f"encoder.down.0.block.{layers}.conv1.weight" in sd:
        layers += 1
    return dataclasses.replace(
        default, in_channels=sd["encoder.conv_in.weight"].shape[1],
        latent_channels=sd["post_quant_conv.weight"].shape[0], layers_per_block=layers,
        block_out_channels=tuple(sd[f"encoder.down.{i}.block.0.conv1.weight"].shape[0]
                                 for i in range(n)))


def ldm_vae_state(sd: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """An LDM VAE state dict under the names of ``vae.AutoencoderKL(cfg)``.
    The decoder's ``up`` list is indexed by resolution level and applied in
    reverse: the port's ``up_{i}`` is ``up.{n-1-i}``. The mid attention's
    1x1 convolutions ``q, k, v, proj_out`` become ``Linear`` weights."""
    n = len(cfg.block_out_channels)
    rename = _renamer((
        (r"^(encoder|decoder)\.mid\.attn_1\.norm\.", r"\1.mid_attn.group_norm."),
        (r"^(encoder|decoder)\.mid\.attn_1\.proj_out\.", r"\1.mid_attn.to_out_0."),
        (r"^(encoder|decoder)\.mid\.attn_1\.(q|k|v)\.", r"\1.mid_attn.to_\2."),
        (r"^(encoder|decoder)\.mid\.block_1\.", r"\1.mid_res_0."),
        (r"^(encoder|decoder)\.mid\.block_2\.", r"\1.mid_res_1."),
        (r"^encoder\.down\.(\d+)\.block\.(\d+)\.", r"encoder.down_\1_res_\2."),
        (r"^encoder\.down\.(\d+)\.downsample\.conv\.", r"encoder.down_\1_downsample."),
        (r"^decoder\.up\.(\d+)\.block\.(\d+)\.",
         lambda m: f"decoder.up_{n - 1 - int(m.group(1))}_res_{m.group(2)}."),
        (r"^decoder\.up\.(\d+)\.upsample\.conv\.",
         lambda m: f"decoder.up_{n - 1 - int(m.group(1))}_upsample."),
        (r"^(encoder|decoder)\.norm_out\.", r"\1.conv_norm_out."),
        (r"^quant_conv\.", "encoder.quant_conv."),
        (r"^post_quant_conv\.", "decoder.post_quant_conv."),
        (r"\.nin_shortcut\.", ".conv_shortcut."),
    ))
    out = {}
    for key, t in sd.items():
        name = rename(key)
        if ".mid_attn.to_" in name and name.endswith(".weight"):
            t = t.reshape(t.shape[0], -1)
        out[name] = t
    return out


def open_clip_text_state(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An OpenCLIP text tower (``split_ldm(...)["text"]``) under the names of
    ``clip.CLIPTextModel``, without its last block (the penultimate-layer
    conditioning skips it): ``in_proj_weight`` / ``in_proj_bias`` split
    into q, k and v, ``ln_1/ln_2`` -> ``layer_norm1/2``, ``c_fc/c_proj`` ->
    ``fc1/fc2``, ``ln_final`` -> ``final_layer_norm``."""
    last = open_clip_text_layers(sd) - 1
    enc = "text_model.encoder.layers"
    rename = _renamer((
        (r"^token_embedding\.", "text_model.embeddings.token_embedding."),
        (r"^positional_embedding$", "text_model.embeddings.position_embedding.weight"),
        (r"^ln_final\.", "text_model.final_layer_norm."),
        (r"^transformer\.resblocks\.(\d+)\.ln_(1|2)\.", enc + r".\1.layer_norm\2."),
        (r"^transformer\.resblocks\.(\d+)\.attn\.out_proj\.", enc + r".\1.self_attn.out_proj."),
        (r"^transformer\.resblocks\.(\d+)\.mlp\.c_fc\.", enc + r".\1.mlp.fc1."),
        (r"^transformer\.resblocks\.(\d+)\.mlp\.c_proj\.", enc + r".\1.mlp.fc2."),
    ))
    out = {}
    for key, t in sd.items():
        if key.startswith(f"transformer.resblocks.{last}."):
            continue
        m = re.match(r"^transformer\.resblocks\.(\d+)\.attn\.in_proj_(weight|bias)$", key)
        if m:
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                out[f"{enc}.{m.group(1)}.self_attn.{part}_proj.{m.group(2)}"] = chunk
        else:
            out[rename(key)] = t
    return out


def open_clip_text_layers(sd: Mapping) -> int:
    """Blocks of an OpenCLIP text tower state dict, the one it skips included."""
    n = 0
    while f"transformer.resblocks.{n}.ln_1.weight" in sd:
        n += 1
    return n
