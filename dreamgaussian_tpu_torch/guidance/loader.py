"""Zero123, SD 2.1, MVDream and ImageDream guidance from local checkpoints.

Port of ``dreamgaussian_tpu/guidance/loader.py``. Two layouts:

1. diffusers snapshot folders, as ``ashawkey/zero123-xl-diffusers``,
   ``ashawkey/stable-zero123-diffusers`` and
   ``stabilityai/stable-diffusion-2-1-base`` ship them::

       <dir>/unet/{config.json, diffusion_pytorch_model.safetensors | .bin}
       <dir>/vae/...
       <dir>/image_encoder/ + <dir>/clip_camera_projection/    (Zero123)
       <dir>/text_encoder/ + <dir>/tokenizer/                  (SD, MVDream)

2. the single-file LDM checkpoint that MVDream and ImageDream ship
   (``sd-v2.1-base-4view.pt`` / ``sd-v2.1-base-4view-ipmv.pt``: the UNet
   with ``camera_embed`` and, for ImageDream, its ``image_embed``
   resampler, the VAE and the OpenCLIP text tower in one ``torch.save``
   file), read with ``torch.load(weights_only=True, mmap=True)``; its
   tokenizer is a ``tokenizer/`` folder beside the file unless one is
   named, and ImageDream's CLIP ViT-H/14 image encoder an
   ``image_encoder/`` folder (transformers' ``CLIPVisionModel``) beside
   it unless one is named. ImageDream is loaded from this layout only: a
   diffusers folder has no place for the resampler and the ip projections
   (the JAX loader builds one without them, and its UNet then fails at its
   first call with image tokens), so a folder raises.

Each folder's ``config.json`` overrides the architecture as the JAX
loader's does; an LDM file's architecture is read from its tensors'
shapes. The UNet's heads: Zero123 keeps its fixed 8 whatever the file's
``attention_head_dim`` says (the JAX config's fixed head count wins over
it too); SD 2.x reads an int as the head width and a list as heads per
level, as diffusers reads SD 2.1-base's ``[5, 10, 20, 20]`` (the JAX
package cannot build that list). Values the port's modules cannot build
(a ``use_linear_projection`` other than the prior's,
``flip_sin_to_cos: false``, a ``freq_shift``, an unknown block type)
raise. The weights are copied from the mapped files into modules built on
the device in ``dtype``, one tensor at a time (``convert.load_into``), so
no whole host copy of the UNet is made. The text is encoded once, in
float32, and its tower freed.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import resolve_device
from .clip import clip_image_embed, clip_image_tokens
from .convert import (camera_projection, is_ldm_layout, ldm_unet_config, ldm_unet_state,
                      ldm_vae_config, ldm_vae_state, load_into, load_torch_state_dict, split_ldm,
                      unet_key, vae_key)
from .sds import (ImageDreamGuidance, MVDreamGuidance, StableDiffusionGuidance,
                  Zero123Guidance, _resize)
from .text_encoder import encode_open_clip_text, encode_text
from .unet import IMAGEDREAM_CONFIG, MVDREAM_CONFIG, SD21_CONFIG, ZERO123_CONFIG, UNet, UNetConfig
from .vae import AutoencoderKL, VAEConfig

UNET_JSON_FIELDS = (
    "in_channels", "out_channels", "block_out_channels", "layers_per_block",
    "cross_attention_dim", "attention_head_dim", "down_block_types", "up_block_types",
)
VAE_JSON_FIELDS = (
    "in_channels", "latent_channels", "block_out_channels", "layers_per_block",
    "scaling_factor",
)
# UNet config.json values the port's modules are built for; another value
# raises (``use_linear_projection`` must be the prior's own).
UNET_FIXED = {"flip_sin_to_cos": True, "freq_shift": 0}
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
    for key, want in {**UNET_FIXED, "use_linear_projection": default.use_linear_projection}.items():
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


def _build_backbone_ldm(sd: dict, unet_config: UNetConfig, vae_config: VAEConfig, device,
                        dtype) -> tuple[UNet, AutoencoderKL]:
    """The UNet and VAE of a split LDM checkpoint (``convert.split_ldm``), their
    architecture read from the tensors over the given defaults."""
    ucfg = ldm_unet_config(sd["unet"], unet_config)
    unet = load_into(_on_device(lambda: UNet(ucfg), device, dtype),
                     ldm_unet_state(sd["unet"], ucfg))
    vcfg = ldm_vae_config(sd["vae"], vae_config)
    vae = load_into(_on_device(lambda: AutoencoderKL(vcfg), device, dtype),
                    ldm_vae_state(sd["vae"], vcfg))
    return unet.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def load_stable_diffusion(
    ckpt_dir: str,
    prompt: str,
    negative_prompt: str = "",
    mvdream: bool = False,
    image_size: int | None = None,
    anneal: bool = True,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """SD 2.1 SDS guidance from a diffusers snapshot, or MVDream's
    (``load_mvdream``) when ``mvdream``. SD encodes the prompt, the negative
    prompt and the three directional prompts ``"<prompt>, front view"``,
    ``side`` and ``back`` (sd_utils.py:84-94)."""
    if mvdream:
        return load_mvdream(ckpt_dir, prompt, negative_prompt=negative_prompt,
                            image_size=image_size or 256, anneal=anneal, device=device,
                            dtype=dtype)
    dev = resolve_device(device)
    unet, vae = _build_backbone(ckpt_dir, SD21_CONFIG, dev, dtype)
    dirs = [f"{prompt}, {d} view" for d in ("front", "side", "back")]
    embs = encode_text(ckpt_dir, [prompt, negative_prompt or ""] + dirs, dev)
    embeddings = dict(zip(("pos", "neg", "front", "side", "back"), embs))
    return StableDiffusionGuidance(unet, vae, embeddings, image_size=image_size or 512,
                                   anneal=anneal)


def load_mvdream(
    ckpt: str,
    prompt: str,
    negative_prompt: str = "",
    tokenizer_dir: str | None = None,
    image_size: int = 256,
    anneal: bool = True,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> MVDreamGuidance:
    """MVDream 4-view guidance from a diffusers snapshot folder (the camera
    MLP as the UNet's ``camera_embedding``; ``MVDREAM_CONFIG`` with its
    ``config.json``) or the single LDM file (its UNet and VAE architecture
    read from the tensors, heads of width 64), whose tokenizer is
    ``tokenizer_dir`` or a ``tokenizer/`` folder beside it."""
    dev = resolve_device(device)
    prompts = [prompt, negative_prompt or ""]
    if os.path.isfile(ckpt):
        sd = load_torch_state_dict(ckpt)
        if not is_ldm_layout(sd):
            raise ValueError(f"{ckpt} is not an LDM-layout checkpoint")
        sd = split_ldm(sd)
        unet, vae = _build_backbone_ldm(sd, MVDREAM_CONFIG, VAEConfig(), dev, dtype)
        tok_dir = tokenizer_dir or os.path.join(os.path.dirname(ckpt), "tokenizer")
        embs = encode_open_clip_text(sd["text"], tok_dir, prompts, dev)
    else:
        unet, vae = _build_backbone(ckpt, MVDREAM_CONFIG, dev, dtype)
        embs = encode_text(ckpt, prompts, dev)
    return MVDreamGuidance(unet, vae, {"pos": embs[0], "neg": embs[1]}, image_size=image_size,
                           anneal=anneal)


def load_imagedream(
    ckpt: str,
    ref_image: np.ndarray | None,
    prompt: str,
    negative_prompt: str = "",
    tokenizer_dir: str | None = None,
    image_encoder_dir: str | None = None,
    image_size: int = 256,
    anneal: bool = True,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> ImageDreamGuidance:
    """ImageDream 4(+1)-view guidance (imagedream_utils.py) from the single
    ``sd-v2.1-base-4view-ipmv.pt`` LDM file: the UNet (``IMAGEDREAM_CONFIG``
    with its widths, the resampler's and its depth read from the file;
    heads of width 64 in both, 5 views) and VAE in ``dtype``,
    the text states as ``load_mvdream``'s, the CLIP tokens [257, 1280] of
    ``ref_image`` (RGB [H, W, 3] in [0, 1], required) from
    ``image_encoder_dir`` or the ``image_encoder/`` folder beside the file,
    and ``ip_img``, the VAE latent of ``ref_image`` resized to
    ``image_size``^2. The file's map is released before the image
    encoder's is made, so the host holds one at a time."""
    dev = resolve_device(device)
    if ref_image is None:
        raise ValueError("load_imagedream requires the reference image")
    if not os.path.isfile(ckpt):
        raise ValueError(f"{ckpt} is not a file: ImageDream loads the single-file LDM layout "
                         f"(sd-v2.1-base-4view-ipmv.pt) only, as a diffusers folder has no "
                         f"image_embed resampler or to_k_ip / to_v_ip projections")
    base = os.path.dirname(ckpt)
    sd = load_torch_state_dict(ckpt)
    if not is_ldm_layout(sd):
        raise ValueError(f"{ckpt} is not an LDM-layout checkpoint")
    sd = split_ldm(sd)
    if "image_embed.latents" not in sd["unet"]:
        raise ValueError(f"{ckpt} has no image_embed resampler: not an ImageDream checkpoint")
    unet, vae = _build_backbone_ldm(sd, IMAGEDREAM_CONFIG, VAEConfig(), dev, dtype)
    embs = encode_open_clip_text(sd["text"], tokenizer_dir or os.path.join(base, "tokenizer"),
                                 [prompt, negative_prompt or ""], dev)
    del sd
    tokens = clip_image_tokens(image_encoder_dir or os.path.join(base, "image_encoder"),
                               ref_image, dev)
    img = torch.as_tensor(np.asarray(ref_image, np.float32), device=dev)[None]
    with torch.no_grad():
        ip_img = vae.encode(_resize(img, image_size) * 2.0 - 1.0)[0]
    return ImageDreamGuidance(unet, vae, {"pos": embs[0], "neg": embs[1]},
                              {"pos": tokens, "ip_img": ip_img}, image_size=image_size,
                              anneal=anneal)


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
