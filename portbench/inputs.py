"""Everything a run feeds the port and the reference, made from ``--seed``.

The same seed gives the same inputs; every seed gives inputs of the same
sizes. Streams are split from the seed by ``numpy.random.SeedSequence``,
so the weights, the cloud, the image, the conditioning states and the
trainer's draws are independent of each other.

- Guidance weights: one ``normal_`` call over a flat bfloat16 buffer on the
  card, then each weight scaled to N(0, 1/fan_in); biases 0, norm scales 1
  (the random-weight rule of the port's ``guidance/realarch.py``). The
  shapes come from the reference networks built on the meta device.
- The start cloud: ``n`` gaussians in a ball of radius 0.9 (uniform in
  volume), scales exp(U(-4, -2.5)), random rotations, opacity U(0.1, 0.9),
  SH DC N(0, 0.5^2): a cloud that covers a 512^2 frame from radius 2.
- The reference view: a shaded disc on white, with its mask.
- The stage-2 mesh: a closed blob (a sphere of radius 0.6 whose radius
  moves by low-frequency seeded terms) as a latitude-longitude grid of
  200 x 250 quads, 100,000 triangles (a stage-1 export's count), its UVs
  the grid's own parametrisation, vertex normals from the faces; the
  albedo a 1024^2 texture of smooth seeded colour.
- The conditioning states at the real encoders' scale: Zero123's CLIP
  embedding, reference latent and camera projection; MVDream's positive
  text states (negative zeros).
- ``Draws``: the trainer's random numbers (SDS noise, split jitter) from a
  seeded generator on the card, recorded while the reference needs them.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("weights", "cloud", "image", "states", "draws", "order", "mesh")


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed of the stream ``name`` of the run's seed."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS.index(name)]).generate_state(2)
    return int((int(words[0]) << 31) ^ int(words[1])) & (2**63 - 1)


def reference_nets(arch: dict, device="meta"):
    """The reference UNet and VAE of a configuration's ``unet`` and ``vae``
    widths, on ``device`` (float32)."""
    from .reference.unet import UNet, UNetConfig
    from .reference.vae import AutoencoderKL, VAEConfig

    with torch.device(device):
        return UNet(UNetConfig(**arch["unet"])), AutoencoderKL(VAEConfig(**arch["vae"]))


def guidance_weights(arch: dict, seed: int, device) -> dict:
    """{"unet": state dict, "vae": state dict} of bfloat16 tensors on
    ``device``, views into one buffer."""
    unet, vae = reference_nets(arch)
    specs = [(net, name, tuple(p.shape)) for net, mod in (("unet", unet), ("vae", vae))
             for name, p in mod.named_parameters()]
    total = sum(int(np.prod(s)) for _, _, s in specs)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.normal_(generator=gen)
    out, at = {"unet": {}, "vae": {}}, 0
    with torch.no_grad():
        for net, name, shape in specs:
            n = int(np.prod(shape))
            w = flat[at:at + n].view(shape)
            at += n
            if name.endswith("bias"):
                w.zero_()
            elif len(shape) == 1:
                w.fill_(1.0)
            else:
                w.mul_(float(np.prod(shape[1:])) ** -0.5)
            out[net][name] = w
    return out


def cloud(seed: int, n: int) -> dict:
    """Raw parameters (numpy float32) of the start cloud: xyz, f_dc
    [n, 1, 3], f_rest [n, 0, 3], opacity logits [n, 1], log-scales,
    rotations (w first, unnormalised)."""
    rng = np.random.default_rng(stream_seed(seed, "cloud"))
    u = rng.uniform(size=(n, 3))
    r = 0.9 * np.cbrt(u[:, 0])
    phi, cos_t = 2 * np.pi * u[:, 1], 2 * u[:, 2] - 1
    sin_t = np.sqrt(1 - cos_t ** 2)
    xyz = np.stack([r * sin_t * np.cos(phi), r * sin_t * np.sin(phi), r * cos_t], 1)
    opacity = rng.uniform(0.1, 0.9, size=(n, 1))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {"xyz": f32(xyz), "f_dc": f32(rng.normal(size=(n, 1, 3)) * 0.5),
            "f_rest": np.zeros((n, 0, 3), np.float32),
            "opacity": f32(np.log(opacity / (1.0 - opacity))),
            "scaling": f32(rng.uniform(-4.0, -2.5, size=(n, 3))),
            "rotation": f32(rng.normal(size=(n, 4)))}


def reference_view(seed: int, size: int):
    """(rgb [S, S, 3] on white, mask [S, S]) float32: a shaded disc."""
    rng = np.random.default_rng(stream_seed(seed, "image"))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    r = size * rng.uniform(0.25, 0.35)
    d2 = ((xx - c) ** 2 + (yy - c) ** 2) / (r * r)
    mask = (d2 < 1.0).astype(np.float32)
    shade = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))[..., None]
    rgb = rng.uniform(0.2, 0.9, size=3).astype(np.float32) * (0.4 + 0.6 * shade)
    rgb = rgb * mask[..., None] + (1.0 - mask[..., None])
    return rgb.astype(np.float32), mask


def states(kind: str, arch: dict, seed: int, device) -> dict:
    """The prior's conditioning states (float32 on ``device``), at the
    scale of the real encoders' outputs: a CLIP image embedding and the
    OpenCLIP text states of a prompt N(0, 1) per entry (LayerNorm-scale),
    Zero123's reference latent the VAE's unscaled posterior mean, N(0, 1)
    over the scaling factor (0.18215); the negative text states zeros."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "states"))
    randn = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    ctx = arch["unet"]["cross_attention_dim"]
    if kind == "zero123":
        side = arch["image_size"] // 8
        return {"clip_emb": randn(1, ctx), "vae_latent": randn(1, side, side, 4) / 0.18215,
                "cam_proj_w": randn(ctx + 4, ctx) * (ctx + 4) ** -0.5,
                "cam_proj_b": torch.zeros(ctx, device=device)}
    return {"text_pos": randn(77, ctx), "text_neg": torch.zeros((77, ctx), device=device)}


class Draws:
    """The trainer's ``draw(name, shape, dist)`` from a seeded generator on
    the card. While ``recording`` it keeps each draw as (name, tensor)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(stream_seed(seed, "draws"))
        self.recording = True
        self.record: list = []

    def __call__(self, name: str, shape: tuple, dist: str, low: int = 0, high=None):
        if dist == "uniform":
            out = torch.rand(shape, generator=self.gen, device=self.device)
        elif dist == "normal":
            out = torch.randn(shape, generator=self.gen, device=self.device)
        elif dist == "randint":
            out = torch.randint(low, high, shape, generator=self.gen, device=self.device)
        else:
            raise ValueError(f"unknown distribution {dist!r} for draw {name!r}")
        if self.recording:
            self.record.append((name, out.clone()))
        return out


def mesh(seed: int, nlat: int = 200, nlon: int = 250, texture: int = 1024) -> dict:
    """numpy arrays v [V, 3], f [F, 3] int32, vn [V, 3], vt [V, 2], ft = f,
    albedo [T, T, 3] in (0, 1)."""
    rng = np.random.default_rng(stream_seed(seed, "mesh"))
    theta = np.linspace(0.0, np.pi, nlat + 1)[:, None]
    phi = np.linspace(0.0, 2.0 * np.pi, nlon + 1)[None, :]
    r = np.full((nlat + 1, nlon + 1), 0.6)
    for l in range(1, 4):
        for m in range(0, 4):
            a, p1, p2 = rng.normal() * 0.04, rng.uniform(0, 2 * np.pi), rng.uniform(0, 2 * np.pi)
            r = r + a * np.cos(l * theta + p1) * np.cos(m * phi + p2)
    r[0], r[-1] = r[0].mean(), r[-1].mean()
    r[:, -1] = r[:, 0]
    v = np.stack([r * np.sin(theta) * np.cos(phi), r * np.cos(theta) * np.ones_like(phi),
                  r * np.sin(theta) * np.sin(phi)], -1).reshape(-1, 3)
    idx = np.arange((nlat + 1) * (nlon + 1)).reshape(nlat + 1, nlon + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    f = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    length = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(length > 1e-12, vn / np.maximum(length, 1e-12), v / np.linalg.norm(v, axis=1, keepdims=True))
    jj, ii = np.meshgrid(np.arange(nlon + 1) / nlon, np.arange(nlat + 1) / nlat)
    vt = np.stack([jj, ii], -1).reshape(-1, 2)
    low = rng.uniform(0.15, 0.85, size=(1, 3, 16, 16))
    albedo = torch.nn.functional.interpolate(torch.from_numpy(low), size=(texture, texture),
                                             mode="bicubic", align_corners=False)
    albedo = albedo.clamp(0.05, 0.95)[0].permute(1, 2, 0).numpy()
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return {"v": f32(v), "f": f, "vn": f32(vn), "vt": f32(vt), "ft": f.copy(),
            "albedo": f32(albedo)}
