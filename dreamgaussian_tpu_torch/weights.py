"""Carry the JAX package's parameters over to the port.

Takes nested dicts of numpy arrays (as ``jax.device_get`` returns them)
and returns the port's tensors, so both packages can run on identical
weights. Imports neither JAX nor flax.

- gaussians: the ``params`` dict with the ``GaussianAux`` fields, or with
  the ``alive`` mask alone;
- flax modules: conv kernels HWIO -> OIHW, ``Dense`` kernels [in, out] ->
  ``Linear`` [out, in], GroupNorm/LayerNorm ``scale`` -> ``weight``; the
  flax module path becomes the torch parameter name (GroupNorm32 wraps
  flax's ``GroupNorm_0``, which has no counterpart level in torch); the
  UNet's linear projections, camera MLP and ImageDream's resampler (its
  ``latents`` [Q, D] as they are) come along by name;
- the JAX package's ``OpenCLIPTextEncoder`` onto the port's
  ``clip.CLIPTextModel`` (its fused ``in_proj`` split into q, k and v).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from . import resolve_device
from .scene.gaussians import GaussianAux


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def gaussians_from_numpy(params: Mapping, aux, device="cuda") -> tuple[dict, GaussianAux]:
    """JAX ``(params, GaussianAux)`` as numpy -> the port's tensors."""
    device = resolve_device(device)
    new_params = {k: _tensor(v, device).float() for k, v in params.items()}
    fields = aux._asdict() if hasattr(aux, "_asdict") else dict(aux)
    new_aux = GaussianAux(
        alive=_tensor(fields["alive"], device).bool(),
        max_radii2d=_tensor(fields["max_radii2d"], device).float(),
        grad_accum=_tensor(fields["grad_accum"], device).float(),
        denom=_tensor(fields["denom"], device).float(),
    )
    return new_params, new_aux


def cloud_from_numpy(params: Mapping, alive, device="cuda") -> tuple[dict, torch.Tensor]:
    """JAX padded ``params`` and ``alive`` mask as numpy -> the port's
    tensors, for the entry points that take a cloud without its statistics
    (the mesh export)."""
    device = resolve_device(device)
    return ({k: _tensor(v, device).float() for k, v in params.items()},
            _tensor(alive, device).bool())


def flax_state_dict(tree: Mapping, device="cuda") -> dict[str, torch.Tensor]:
    """A flax parameter tree ({"params": {...}} or its inside) -> a torch
    state dict keyed by module path."""
    device = resolve_device(device)
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path if key == "GroupNorm_0" else path + [key])
                continue
            t = _tensor(val, device)
            if key == "kernel":
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
                name = "weight"
            elif key == "scale":
                name = "weight"
            elif key in ("bias", "latents"):
                name = key
            else:
                raise KeyError(f"unexpected flax leaf {'/'.join(path + [key])}")
            out[".".join(path + [name])] = t.contiguous()

    walk(tree, [])
    return out


def load_unet(unet: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load a flax UNet tree into the port's ``UNet`` (strict)."""
    unet.load_state_dict(flax_state_dict(flax_params, next(unet.parameters()).device))
    return unet


def load_vae(vae: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load a flax AutoencoderKL tree, encoder and decoder (strict)."""
    vae.load_state_dict(flax_state_dict(flax_params, next(vae.parameters()).device))
    return vae


def load_vae_encoder(vae: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load the encoder half of a flax AutoencoderKL tree into ``vae.encoder``
    (strict); the decoder keeps its weights."""
    sd = flax_state_dict(flax_params, next(vae.parameters()).device)
    vae.encoder.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                                 if k.startswith("encoder.")})
    return vae


def load_tiny_unet(unet: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load a flax ``TinyUNet`` tree (strict). Its modules are flax's
    auto-named children (``Conv_0``, ``GroupNorm_0``, ...), each converted on
    its own: a top-level ``GroupNorm_0`` is a module of its own here, not
    GroupNorm32's inner level."""
    tree = flax_params["params"] if set(flax_params) == {"params"} else flax_params
    dev = next(unet.parameters()).device
    unet.load_state_dict({f"{name}.{k}": v for name, sub in tree.items()
                          for k, v in flax_state_dict(sub, dev).items()})
    return unet


def load_open_clip_text(tower: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load a flax ``OpenCLIPTextEncoder`` tree into ``clip.CLIPTextModel``
    (strict): ``resblocks_i`` -> ``text_model.encoder.layers.i``."""
    tree = dict(flax_params["params"] if set(flax_params) == {"params"} else flax_params)
    dev = next(tower.parameters()).device
    tm, enc = "text_model", "text_model.encoder.layers"
    sd = {f"{tm}.embeddings.token_embedding.weight": _tensor(tree.pop("token_embedding"), dev),
          f"{tm}.embeddings.position_embedding.weight":
              _tensor(tree.pop("positional_embedding"), dev)}
    names = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "out_proj": "self_attn.out_proj",
             "c_fc": "mlp.fc1", "c_proj": "mlp.fc2"}
    for key, t in flax_state_dict(tree, dev).items():
        if key.startswith("ln_final."):
            sd[f"{tm}.final_layer_norm.{key[len('ln_final.'):]}"] = t
            continue
        i, module, leaf = re.fullmatch(r"resblocks_(\d+)\.(\w+)\.(weight|bias)", key).groups()
        if module == "in_proj":
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                sd[f"{enc}.{i}.self_attn.{part}_proj.{leaf}"] = chunk.contiguous()
        else:
            sd[f"{enc}.{i}.{names[module]}.{leaf}"] = t
    tower.load_state_dict(sd)
    return tower
