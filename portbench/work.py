"""The benchmark's yardstick of work: peaks, operations and bytes.

- ``PEAKS``: one NVIDIA H100 SXM as published (NVIDIA's data sheet, dense
  rates at the 700 W limit). A share is stated against them with the
  card's power limit beside it.
- ``unet_flops`` / ``vae_flops``: the operations of a configuration's networks per call,
  counted by ``torch.utils.flop_counter`` on the reference networks built
  on the meta device (convolutions, linear layers and both attention
  products; two operations per multiply-add), so the same work counts
  whatever implements it.
- ``k1_bound_s`` / ``k2_bound_s``: the least time the gaussian compositing
  of one render can take, from the pairs its inputs need (counted by the
  reference's plain compositing, ``reference.render.pair_counts``): the
  larger of the operations over the float32 peak and the bytes over HBM's;
  ``k3_bound_s`` the same for the triangle z-test, from the reference's
  plain visibility (``reference.mesh.visibility``).
"""

from __future__ import annotations

import torch

PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

# float32 operations per (gaussian, pixel) pair that contributes: the
# forward evaluates the quadratic (10), the exp, clamp and skip tests (4),
# the stop test (3) and accumulates colour and depth (9); the backward adds
# the transmittance rebuild, the colour dot, d_alpha, the suffix sum and
# the 10 gradient terms. The pair that stops a pixel costs the quadratic
# and the two skip tests.
K1_FLOPS_PER_PAIR = 26
K2_FLOPS_PER_PAIR = 52
STOP_FLOPS_PER_PAIR = 12
# A gaussian's 10 float32 features, read once per tile it contributes to;
# the backward writes as many gradients per such slot.
FEATURE_BYTES = 40
# Per pixel: the forward writes colour, depth, transmittance and the
# contributor count (6 floats); the backward reads them and the 5
# cotangents of colour, depth and transmittance.
K1_PIXEL_BYTES = 6 * 4
K2_PIXEL_BYTES = (6 + 5) * 4


def k1_bound_s(c: dict) -> float:
    ops = c["contributing_pairs"] * K1_FLOPS_PER_PAIR + c["stopping_pixels"] * STOP_FLOPS_PER_PAIR
    byts = c["feature_slots"] * FEATURE_BYTES + c["pixels"] * K1_PIXEL_BYTES
    return max(ops / PEAKS["f32_flops"], byts / PEAKS["hbm_bytes_per_s"])


def k2_bound_s(c: dict) -> float:
    ops = c["contributing_pairs"] * K2_FLOPS_PER_PAIR
    byts = 2 * c["feature_slots"] * FEATURE_BYTES + c["pixels"] * K2_PIXEL_BYTES
    return max(ops / PEAKS["f32_flops"], byts / PEAKS["hbm_bytes_per_s"])


# K3, per (triangle, pixel) pair whose pixel centre lies in the triangle's
# bounding box: the three edge functions (15) and the inside test (3); a
# covering pair adds the barycentric products, the z sum and the depth
# compare (10). A triangle's 10 float32 features are read once per tile
# whose pixels fall in its box; each pixel writes its id and depth.
K3_FLOPS_PER_BOX_PAIR = 18
K3_FLOPS_PER_COVER_PAIR = 10
K3_PIXEL_BYTES = 8


def k3_bound_s(c: dict) -> float:
    ops = c["box_pairs"] * K3_FLOPS_PER_BOX_PAIR + c["cover_pairs"] * K3_FLOPS_PER_COVER_PAIR
    byts = c["slots"] * FEATURE_BYTES + c["pixels"] * K3_PIXEL_BYTES
    return max(ops / PEAKS["f32_flops"], byts / PEAKS["hbm_bytes_per_s"])


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def unet_flops(arch: dict, batch: int, camera: bool) -> int:
    """One UNet call on ``batch`` latents of the configuration's side."""
    from .inputs import reference_nets

    unet, _ = reference_nets(arch)
    side = arch["image_size"] // 8
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    ctx = meta(batch, arch["context_tokens"], arch["unet"]["cross_attention_dim"])
    kw = {"camera": meta(batch, 16)} if camera else {}
    with torch.no_grad():
        return _count(lambda: unet(meta(batch, side, side, arch["unet"]["in_channels"]),
                                   torch.zeros(batch, dtype=torch.int64, device="meta"), ctx,
                                   **kw))


def vae_flops(arch: dict, batch: int, side: int, part: str) -> int:
    """The VAE's ``encode`` forward, its backward to the input (the weights
    are frozen: no weight gradients), or ``decode`` forward, on ``batch``
    images of ``side``^2."""
    from .inputs import reference_nets

    _, vae = reference_nets(arch)
    vae.requires_grad_(False)
    if part == "decode":
        z = torch.zeros(batch, side // 8, side // 8, 4, device="meta")
        with torch.no_grad():
            return _count(lambda: vae.decode(z))
    x = torch.zeros(batch, side, side, 3, device="meta")
    if part == "encode":
        with torch.no_grad():
            return _count(lambda: vae.encode(x))
    out = vae.encode(x.requires_grad_(True))
    return _count(lambda: out.backward(torch.zeros_like(out)))


def stage1_step_flops(arch: dict, views: int) -> int:
    """A stage-1 step's model operations: the UNet at the CFG batch of the
    step's views, the VAE encoder forward and backward to the images."""
    side = arch["image_size"]
    return (unet_flops(arch, 2 * views, camera=arch["kind"] == "mvdream")
            + vae_flops(arch, views, side, "encode") + vae_flops(arch, views, side, "backward"))
