"""Text conditioning for SD 2.1 and MVDream: prompts -> [N, 77, 1024] states.

Port of the text side of ``dreamgaussian_tpu/guidance/loader.py``
(``_encode_text``, ``_tokenize_open_clip``, ``_encode_text_open_clip``)
and of ``guidance/text_encoder.py``'s OpenCLIP tower:

- a diffusers snapshot ships the CLIP text tower in transformers' layout
  (``text_encoder/``, which for SD 2.1 already stops at the penultimate
  OpenCLIP block: 23 layers) and its ``tokenizer/``; the prompts are
  padded to ``model_max_length`` with the pad token;
- an LDM checkpoint ships the OpenCLIP ViT-H text tower
  (``cond_stage_model.model.*``: token and positional embeddings, pre-LN
  causal blocks with the exact GELU, ``ln_final``); ldm's
  ``FrozenOpenCLIPEmbedder(layer="penultimate")`` runs every block but the
  last, then ``ln_final``. It is converted onto the same
  ``clip.CLIPTextModel`` (``convert.open_clip_text_state``), with 64-wide
  heads, and the prompts are zero-padded after EOT.

Both towers run once per run in float32 and are freed when the states
exist.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch

from .clip import CLIPTextConfig, CLIPTextModel, load_clip_text
from .convert import load_into, open_clip_text_layers, open_clip_text_state
from .tokenizer import CLIPTokenizer


def open_clip_text_config(sd: Mapping[str, torch.Tensor]) -> CLIPTextConfig:
    """The text tower that ``convert.open_clip_text_state`` fills, from the
    shapes of an OpenCLIP state dict (``convert.split_ldm(...)["text"]``)."""
    width = sd["ln_final.weight"].shape[0]
    return CLIPTextConfig(
        vocab_size=sd["token_embedding.weight"].shape[0], hidden_size=width,
        intermediate_size=sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        num_hidden_layers=open_clip_text_layers(sd) - 1,
        num_attention_heads=max(1, width // 64),
        max_position_embeddings=sd["positional_embedding"].shape[0], hidden_act="gelu")


def load_open_clip_text(sd: Mapping[str, torch.Tensor], device) -> CLIPTextModel:
    """The OpenCLIP tower of an LDM checkpoint, float32 on ``device``."""
    with torch.device("meta"):
        tower = CLIPTextModel(open_clip_text_config(sd))
    tower = tower.to_empty(device=device)
    load_into(tower, open_clip_text_state(sd))
    return tower.eval().requires_grad_(False)


@torch.no_grad()
def encode_text(ckpt_dir: str, prompts: list[str], device) -> torch.Tensor:
    """``last_hidden_state`` [N, model_max_length, D] of a diffusers
    snapshot's text tower for ``prompts``."""
    tok = CLIPTokenizer(os.path.join(ckpt_dir, "tokenizer"))
    ids = torch.tensor(tok.encode(prompts, padding="max_length"), device=device)
    return load_clip_text(os.path.join(ckpt_dir, "text_encoder"), device)(ids)


@torch.no_grad()
def encode_open_clip_text(sd: Mapping[str, torch.Tensor], tokenizer_dir: str,
                          prompts: list[str], device) -> torch.Tensor:
    """Penultimate-block states [N, context_length, width] of an LDM
    checkpoint's OpenCLIP tower for ``prompts`` (zero-padded after EOT)."""
    tower = load_open_clip_text(sd, device)
    ids = CLIPTokenizer(tokenizer_dir).encode(
        prompts, max_length=tower.config.max_position_embeddings, padding="zeros")
    return tower(torch.tensor(ids, device=device))
