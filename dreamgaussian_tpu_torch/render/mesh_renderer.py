"""Differentiable mesh renderer for stage-2 texture refinement.

Port of ``dreamgaussian_tpu/render/mesh_renderer.py``: renders a
fixed-topology mesh with a trainable UV albedo, stored as logits and
passed through the sigmoid after texture filtering, and optional trainable
vertex offsets (normals recomputed when the geometry trains). The z-test
of every render runs in kernel K3 on the card (``ops/mesh_raster.py``).

Order of a render: rasterize at the SSAA size, interpolate depth and
normals, sample the albedo logits (trilinear over a mip chain by default,
LOD from the barycentrics' screen derivatives), sigmoid, antialias the
silhouettes, blend with the background by the hard coverage, resize to
the asked size, clamp the image to [0, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.clamp import clamp_tie
from ..ops.mesh_raster import (
    antialias,
    build_mip_chain,
    interpolate,
    interpolate_with_derivs,
    rasterize,
    sample_texture,
    sample_texture_mip,
    scale_img,
)


def trunc_rev_sigmoid(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = clamp_tie(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def _safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x * torch.rsqrt(clamp_tie((x * x).sum(-1, keepdim=True), eps))


def make_divisible(x: float, m: int = 32) -> int:
    return int(math.ceil(x / m) * m)


class MeshRendererState(NamedTuple):
    """Mesh topology and trainable parameters, as tensors on one device."""

    v: torch.Tensor           # [V, 3] base vertices
    f: torch.Tensor           # [F, 3] int64
    vn: torch.Tensor          # [V, 3] normals (train_geo recomputes them)
    vt: torch.Tensor          # [Vt, 2]
    ft: torch.Tensor          # [F, 3] int64
    raw_albedo: torch.Tensor  # [TH, TW, 3] logits (trainable)
    v_offsets: torch.Tensor   # [V, 3] (trainable when train_geo)

    @classmethod
    def from_mesh(cls, mesh, device: str | torch.device) -> "MeshRendererState":
        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        v = t(mesh.v, torch.float32)
        return cls(v=v, f=t(mesh.f, torch.int64), vn=t(mesh.vn, torch.float32),
                   vt=t(mesh.vt, torch.float32), ft=t(mesh.ft, torch.int64),
                   raw_albedo=trunc_rev_sigmoid(t(mesh.albedo, torch.float32)),
                   v_offsets=torch.zeros_like(v))

    def trainable(self, train_geo: bool) -> dict:
        p = {"raw_albedo": self.raw_albedo}
        if train_geo:
            p["v_offsets"] = self.v_offsets
        return p

    def with_params(self, params: dict) -> "MeshRendererState":
        return self._replace(raw_albedo=params.get("raw_albedo", self.raw_albedo),
                             v_offsets=params.get("v_offsets", self.v_offsets))


def _recompute_normals(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]
    fn = _safe_normalize(torch.linalg.cross(v[i1] - v[i0], v[i2] - v[i0]))
    vn = torch.zeros_like(v).index_add(0, i0, fn).index_add(0, i1, fn).index_add(0, i2, fn)
    up = torch.tensor([0.0, 0.0, 1.0], device=v.device)
    return torch.where((vn * vn).sum(-1, keepdim=True) > 1e-20, vn, up)


def render_mesh(
    state: MeshRendererState,
    cam_arrays: dict,
    pose_rot: torch.Tensor,
    h0: int,
    w0: int,
    ssaa: float = 1.0,
    bg_color=1.0,
    train_geo: bool = False,
    tile: int = 32,
    texture_filter: str = "linear-mipmap-linear",
    edge_aa: bool = True,
) -> dict:
    """Render the mesh through one camera.

    cam_arrays: ``Camera.arrays()`` as tensors on the state's device (view,
    full_proj). pose_rot: [3,3] camera-to-world rotation (for viewcos).
    Returns dict(image, alpha, depth, normal, viewcos) at (h0, w0),
    differentiable w.r.t. raw_albedo (and v_offsets when train_geo).
    ``texture_filter``: 'linear-mipmap-linear' or 'bilinear'.
    """
    if ssaa != 1:
        h = make_divisible(h0 * ssaa, tile)
        w = make_divisible(w0 * ssaa, tile)
    else:
        h, w = h0, w0
    mip = texture_filter == "linear-mipmap-linear"

    v = state.v + state.v_offsets if train_geo else state.v
    v_h = torch.cat([v, torch.ones((v.shape[0], 1), device=v.device)], dim=1)
    v_clip = v_h @ cam_arrays["full_proj"].T
    v_cam_z = (v_h @ cam_arrays["view"].T)[:, 2:3]     # rectified, +z forward

    rast = rasterize(v_clip, state.f, w, h, tile=tile, derivs=mip)
    alpha = rast.mask.float()[..., None]
    # Depth and normals share the face index set: one interpolate.
    vn = _recompute_normals(v, state.f) if train_geo else state.vn
    dn = interpolate(torch.cat([v_cam_z, vn], dim=1), state.f, rast)
    depth = dn[..., 0:1]

    # Filter the logits, sigmoid after.
    if mip:
        texc, texc_dx, texc_dy = interpolate_with_derivs(state.vt, state.ft, rast)
        logits = sample_texture_mip(build_mip_chain(state.raw_albedo), texc, texc_dx, texc_dy)
    else:
        logits = sample_texture(state.raw_albedo, interpolate(state.vt, state.ft, rast))
    albedo = torch.sigmoid(logits)

    normal = _safe_normalize(dn[..., 1:4])
    viewcos = (normal @ pose_rot)[..., 2:3]

    if edge_aa:
        # Antialias the albedo, then blend with the background by the hard alpha.
        albedo = antialias(albedo, rast, v_clip, state.f, w, h)
    image = alpha * albedo + (1.0 - alpha) * bg_color

    if (h, w) != (h0, w0):
        image, alpha, depth, normal, viewcos = (
            scale_img(x, h0, w0) for x in (image, alpha, depth, normal, viewcos))
    return {
        "image": clamp_tie(image, 0.0, 1.0),
        "alpha": alpha,
        "depth": depth,
        "normal": (normal + 1.0) / 2.0,
        "viewcos": viewcos,
    }
