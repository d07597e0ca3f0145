"""CLIP towers: Zero123's and ImageDream's image conditioning, the text conditioning.

The port's own counterparts of ``transformers.CLIPVisionModelWithProjection``,
``transformers.CLIPVisionModel`` and ``transformers.CLIPTextModel``, which
the JAX package runs on the host in ``guidance/loader.py``
(``_clip_image_embed``, ``_clip_image_tokens``, ``_encode_text``). Their
parameters carry the names of the state dicts that a snapshot's
``image_encoder/`` and ``text_encoder/`` ship
(``vision_model.embeddings.patch_embedding.weight``,
``vision_model.pre_layrnorm`` with the upstream spelling,
``text_model.encoder.layers.N.self_attn.q_proj``, ``visual_projection``,
``text_model.final_layer_norm``, ...), so ``convert.load_into`` loads them
without renaming; the ``position_ids`` buffer of some snapshots is
recomputed, not loaded. Both share the pre-norm encoder layers
(``quick_gelu`` or ``gelu``).

Both run in float32, once per run. The vision tower: the CLS token
through ``post_layernorm``, then the projection without bias ->
``image_embeds`` [B, projection_dim]; its patch embedding is a matmul over
the unfolded patches (the same sum as the stride-p convolution), so on the
card it takes the float32 matmul path rather than cuDNN's TF32
convolutions. The token tower (ImageDream) is the same tower without the
projection: ``last_hidden_state`` [B, 1 + patches, hidden], the encoder's
output before ``post_layernorm``; it loads a ``CLIPVisionModel`` folder or
a ``...WithProjection`` one, whose projection it leaves unused, as
transformers' ``from_pretrained`` does. The text tower: token and position embeddings, causal
self-attention and no padding mask (the JAX side passes only
``input_ids``), ``final_layer_norm`` -> ``last_hidden_state`` [B, L,
hidden]. The OpenCLIP tower of an LDM checkpoint is converted onto the
text tower (``guidance/text_encoder.py``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .sds import _resize

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class _FromJson:
    @classmethod
    def from_json(cls, path: str):
        with open(path) as f:
            raw = json.load(f)
        cfg = cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls) if f.name in raw})
        if cfg.hidden_act not in ACTIVATIONS:
            raise ValueError(f"{path}: hidden_act {cfg.hidden_act!r} is not one of "
                             f"{sorted(ACTIVATIONS)}")
        return cfg


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig(_FromJson):
    """The fields of transformers' ``CLIPVisionConfig`` the tower uses, with
    its defaults (a ``config.json`` may leave out a default value)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig(_FromJson):
    """The fields of transformers' ``CLIPTextConfig`` the text tower uses,
    with its defaults."""

    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": F.gelu,
}


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch = cfg.patch_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)

    def forward(self, pixel_values):
        b, c, h, w = pixel_values.shape
        p = self.patch
        patches = (pixel_values.reshape(b, c, h // p, p, w // p, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), c * p * p))
        w = self.patch_embedding.weight
        x = patches @ w.reshape(w.shape[0], -1).T
        cls = self.class_embedding.expand(b, 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPAttention(nn.Module):
    def __init__(self, cfg, causal: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.causal = causal
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.heads
        split = lambda t: t.reshape(b, n, self.heads, hd).transpose(1, 2)  # noqa: E731
        q = split(self.q_proj(x)) * (hd ** -0.5)
        scores = q @ split(self.k_proj(x)).transpose(-1, -2)
        if self.causal:
            above = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
            scores = scores.masked_fill(above, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = (probs @ split(self.v_proj(x))).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg, causal: bool = False):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, causal)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, causal: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def hidden_states(self, pixel_values):
        """NCHW pixel values -> the encoder's output [B, 1 + patches, hidden]."""
        return self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))

    def forward(self, pixel_values):
        """NCHW pixel values -> the pooled (CLS) output [B, hidden]."""
        return self.post_layernorm(self.hidden_states(pixel_values)[:, 0])


class CLIPVisionModelWithProjection(nn.Module):
    """pixel_values [B, 3, S, S] -> image_embeds [B, projection_dim]."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values.float()))


class CLIPVisionModel(nn.Module):
    """pixel_values [B, 3, S, S] -> last_hidden_state [B, 1 + patches, hidden]."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixel_values):
        return self.vision_model.hidden_states(pixel_values.float())


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids):
        return self.token_embedding(ids) + self.position_embedding.weight[None, :ids.shape[1]]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg, causal=True)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids):
        return self.final_layer_norm(self.encoder(self.embeddings(ids)))


class CLIPTextModel(nn.Module):
    """input_ids [B, L] -> last_hidden_state [B, L, hidden] (float32)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)


def clip_pixel_values(image, size: int, device) -> torch.Tensor:
    """RGB [H, W, 3] in [0, 1] -> CLIP's normalised NCHW input at ``size``^2
    (bilinear, antialiased when downsampling, as ``jax.image.resize``)."""
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
    img = _resize(img, size)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=device)
    std = torch.tensor(CLIP_IMAGE_STD, device=device)
    return ((img - mean) / std).permute(0, 3, 1, 2)


def _load_tower(folder: str, config_cls, model_cls, device, skip=("position_ids",)):
    from .convert import load_into, load_torch_state_dict

    cfg = config_cls.from_json(f"{folder}/config.json")
    with torch.device("meta"):
        tower = model_cls(cfg)
    tower = tower.to_empty(device=device)
    load_into(tower, load_torch_state_dict(folder), skip=skip)
    return tower.eval().requires_grad_(False)


def load_clip_vision(encoder_dir: str, device) -> CLIPVisionModelWithProjection:
    """The tower of a snapshot's ``image_encoder/`` folder, float32 on ``device``."""
    return _load_tower(encoder_dir, CLIPVisionConfig, CLIPVisionModelWithProjection, device)


def load_clip_vision_tokens(encoder_dir: str, device) -> CLIPVisionModel:
    """The token tower of a ``CLIPVisionModel`` (or ``...WithProjection``,
    its projection skipped) folder, float32 on ``device``."""
    return _load_tower(encoder_dir, CLIPVisionConfig, CLIPVisionModel, device,
                       skip=("position_ids", "visual_projection.weight"))


def load_clip_text(encoder_dir: str, device) -> CLIPTextModel:
    """The tower of a snapshot's ``text_encoder/`` folder, float32 on ``device``."""
    return _load_tower(encoder_dir, CLIPTextConfig, CLIPTextModel, device)


@torch.no_grad()
def clip_image_embed(encoder_dir: str, image, device) -> torch.Tensor:
    """CLIP image embedding [1, projection_dim] (float32, on ``device``) of an
    RGB [H, W, 3] image in [0, 1]; the tower is freed afterwards."""
    tower = load_clip_vision(encoder_dir, device)
    return tower(clip_pixel_values(image, tower.config.image_size, device))


@torch.no_grad()
def clip_image_tokens(encoder_dir: str, image, device) -> torch.Tensor:
    """CLIP token sequence [1 + patches, hidden] (float32, on ``device``) of an
    RGB [H, W, 3] image in [0, 1]: ImageDream's ip conditioning ([257, 1280]
    for ViT-H/14); the tower is freed afterwards."""
    tower = load_clip_vision_tokens(encoder_dir, device)
    return tower(clip_pixel_values(image, tower.config.image_size, device))[0]
