"""Diffusers snapshot state dicts into the port's modules.

Port of the diffusers part of ``dreamgaussian_tpu/guidance/convert.py``.
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
"""

from __future__ import annotations

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
