"""Carry the JAX package's parameters over to the port.

Takes nested dicts of numpy arrays (as ``jax.device_get`` returns them)
and returns the port's tensors, so both packages can run on identical
weights. Imports neither JAX nor flax.

- gaussians: the ``params`` dict with the ``GaussianAux`` fields, or with
  the ``alive`` mask alone;
- flax modules: conv kernels HWIO -> OIHW, ``Dense`` kernels [in, out] ->
  ``Linear`` [out, in], GroupNorm/LayerNorm ``scale`` -> ``weight``; the
  flax module path becomes the torch parameter name (GroupNorm32 wraps
  flax's ``GroupNorm_0``, which has no counterpart level in torch).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .scene.gaussians import GaussianAux


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def gaussians_from_numpy(params: Mapping, aux, device="cpu") -> tuple[dict, GaussianAux]:
    """JAX ``(params, GaussianAux)`` as numpy -> the port's tensors."""
    new_params = {k: _tensor(v, device).float() for k, v in params.items()}
    fields = aux._asdict() if hasattr(aux, "_asdict") else dict(aux)
    new_aux = GaussianAux(
        alive=_tensor(fields["alive"], device).bool(),
        max_radii2d=_tensor(fields["max_radii2d"], device).float(),
        grad_accum=_tensor(fields["grad_accum"], device).float(),
        denom=_tensor(fields["denom"], device).float(),
    )
    return new_params, new_aux


def cloud_from_numpy(params: Mapping, alive, device="cpu") -> tuple[dict, torch.Tensor]:
    """JAX padded ``params`` and ``alive`` mask as numpy -> the port's
    tensors, for the entry points that take a cloud without its statistics
    (the mesh export)."""
    return ({k: _tensor(v, device).float() for k, v in params.items()},
            _tensor(alive, device).bool())


def flax_state_dict(tree: Mapping, device="cpu") -> dict[str, torch.Tensor]:
    """A flax parameter tree ({"params": {...}} or its inside) -> a torch
    state dict keyed by module path."""
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
            elif key == "bias":
                name = "bias"
            else:
                raise KeyError(f"unexpected flax leaf {'/'.join(path + [key])}")
            out[".".join(path + [name])] = t.contiguous()

    walk(tree, [])
    return out


def load_unet(unet: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load a flax UNet tree into the port's ``UNet`` (strict)."""
    unet.load_state_dict(flax_state_dict(flax_params, next(unet.parameters()).device))
    return unet


def load_vae_encoder(vae: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Load the encoder half of a flax AutoencoderKL tree (strict)."""
    sd = flax_state_dict(flax_params, next(vae.parameters()).device)
    vae.load_state_dict({k: v for k, v in sd.items() if k.startswith("encoder.")})
    return vae
