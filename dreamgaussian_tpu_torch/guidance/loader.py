"""Zero123 guidance from a local diffusers snapshot.

Port of the diffusers-layout part of ``dreamgaussian_tpu/guidance/loader.py``
(``_config_from_json``, ``_build_backbone``, ``load_zero123``) for the
snapshots ``configs/image.yaml`` and ``configs/image_sai.yaml`` are
written for (``ashawkey/zero123-xl-diffusers``,
``ashawkey/stable-zero123-diffusers``)::

    <dir>/unet/{config.json, diffusion_pytorch_model.safetensors | .bin}
    <dir>/vae/...
    <dir>/image_encoder/{config.json, model.safetensors | pytorch_model.bin}
    <dir>/clip_camera_projection/...

Each folder's ``config.json`` overrides the architecture as the JAX
loader's does. The UNet keeps ``ZERO123_CONFIG``'s 8 heads whatever the
file's ``attention_head_dim`` says (the JAX config's fixed head count wins
over it too); values the port's modules cannot build
(``use_linear_projection: true``, ``flip_sin_to_cos: false``, a
``freq_shift``, an unknown block type) raise. The weights are copied from
the mapped files into modules built on the device in ``dtype``, one
tensor at a time (``convert.load_into``), so no whole host copy of the
UNet is made. The single-file LDM layout and the SD, MVDream and
ImageDream loaders wait for the slice of the text priors.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import resolve_device
from .clip import clip_image_embed
from .convert import camera_projection, load_into, load_torch_state_dict, unet_key, vae_key
from .sds import Zero123Guidance, _resize
from .unet import ZERO123_CONFIG, UNet, UNetConfig
from .vae import AutoencoderKL, VAEConfig

UNET_JSON_FIELDS = (
    "in_channels", "out_channels", "block_out_channels", "layers_per_block",
    "cross_attention_dim", "down_block_types", "up_block_types",
)
VAE_JSON_FIELDS = (
    "in_channels", "latent_channels", "block_out_channels", "layers_per_block",
    "scaling_factor",
)
# UNet config.json values the port's modules are built for; another value raises.
UNET_FIXED = {"use_linear_projection": False, "flip_sin_to_cos": True, "freq_shift": 0}
UNET_BLOCK_TYPES = {
    "down_block_types": ("CrossAttnDownBlock2D", "DownBlock2D"),
    "up_block_types": ("UpBlock2D", "CrossAttnUpBlock2D"),
}


def _read_json(ckpt_dir: str, subfolder: str) -> dict | None:
    p = os.path.join(ckpt_dir, subfolder, "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _config_from_json(ckpt_dir: str, subfolder: str, default, fields):
    """``default`` with the ``fields`` that ``<subfolder>/config.json`` sets
    (lists as tuples); ``default`` itself without a config.json."""
    raw = _read_json(ckpt_dir, subfolder)
    if raw is None:
        return default
    kw = {k: tuple(raw[k]) if isinstance(raw[k], list) else raw[k] for k in fields if k in raw}
    return dataclasses.replace(default, **kw)


def _unet_config(ckpt_dir: str, default: UNetConfig) -> UNetConfig:
    """``_config_from_json`` for the UNet, refusing what the port cannot build."""
    raw = _read_json(ckpt_dir, "unet") or {}
    for key, want in UNET_FIXED.items():
        if key in raw and raw[key] != want:
            raise ValueError(f"unet/config.json sets {key}={raw[key]!r}; the port's UNet is "
                             f"built for {want!r} only")
    for key, allowed in UNET_BLOCK_TYPES.items():
        bad = [b for b in raw.get(key, ()) if b not in allowed]
        if bad:
            raise ValueError(f"unet/config.json {key} has {bad}; the port's UNet builds "
                             f"{list(allowed)}")
    return _config_from_json(ckpt_dir, "unet", default, UNET_JSON_FIELDS)


def _on_device(build, device, dtype):
    """A module built on the meta device, then allocated on ``device`` in
    ``dtype`` with no values (``load_into`` fills it)."""
    with torch.device("meta"):
        module = build().to(dtype)
    return module.to_empty(device=device)


def _build_backbone(ckpt_dir: str, unet_config: UNetConfig, device="cuda",
                    dtype=torch.bfloat16) -> tuple[UNet, AutoencoderKL]:
    """The snapshot's UNet and VAE (encoder and decoder) in ``dtype`` on
    ``device``, frozen and in eval mode."""
    dev = resolve_device(device)
    ucfg = _unet_config(ckpt_dir, unet_config)
    unet = load_into(_on_device(lambda: UNet(ucfg), dev, dtype),
                     load_torch_state_dict(ckpt_dir, "unet"), unet_key)
    vcfg = _config_from_json(ckpt_dir, "vae", VAEConfig(), VAE_JSON_FIELDS)
    vae = load_into(_on_device(lambda: AutoencoderKL(vcfg), dev, dtype),
                    load_torch_state_dict(ckpt_dir, "vae"), vae_key)
    return unet.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def load_zero123(
    ckpt_dir: str,
    ref_image: np.ndarray | None = None,
    stable: bool = False,
    default_elevation: float = 0.0,
    image_size: int = 256,
    anneal: bool = True,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Zero123Guidance:
    """Zero123-XL / stable-zero123 guidance from a local snapshot.

    ref_image: RGB [H, W, 3] in [0, 1], the conditioning view (required).
    The UNet and VAE run in ``dtype`` (bfloat16, the JAX loader's default);
    the CLIP tower runs once, in float32.
    """
    if ref_image is None:
        raise ValueError("load_zero123 requires the reference image")
    dev = resolve_device(device)
    unet, vae = _build_backbone(ckpt_dir, ZERO123_CONFIG, dev, dtype)
    clip_emb = clip_image_embed(os.path.join(ckpt_dir, "image_encoder"), ref_image, dev)

    # Unscaled VAE posterior mean of the reference view (zero123_utils.py:63:
    # encode / scaling_factor). The encoder scales by the snapshot's factor;
    # the division is by the default one, as the JAX loader divides.
    img = torch.as_tensor(np.asarray(ref_image, np.float32), device=dev)[None]
    with torch.no_grad():
        vae_latent = vae.encode(_resize(img, image_size) * 2.0 - 1.0) / VAEConfig().scaling_factor

    w, b = camera_projection(load_torch_state_dict(ckpt_dir, "clip_camera_projection"))
    return Zero123Guidance(
        unet, vae,
        clip_emb=clip_emb,
        vae_latent=vae_latent,
        cam_proj=(w.to(dev, torch.float32), b.to(dev, torch.float32)),
        image_size=image_size,
        stable=stable,
        default_elevation=default_elevation,
        anneal=anneal,
    )
