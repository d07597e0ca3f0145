"""Gaussian projection: EWA splatting of 3D Gaussians to screen space.

Port of ``dreamgaussian_tpu/ops/project.py`` with torch autograd. The
rules of the CUDA preprocess of ``diff-gaussian-rasterization`` are kept:
view-space z cull at 0.2, 1.3*tanfov frustum clamp for the EWA Jacobian,
+0.3 pixel covariance dilation, conic from the dilated covariance,
radius = ceil(3*sqrt(max eigenvalue)), pixel coords ((ndc+1)*size-1)/2,
SH colours clamped at 0 after +0.5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sh as sh_ops
from .clamp import clamp_tie
from .quat import build_covariance6


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities for one camera."""

    mean2d: torch.Tensor   # [N, 2] pixel coords
    depth: torch.Tensor    # [N] view-space z
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    color: torch.Tensor    # [N, 3] RGB from SH (clamped >= 0)
    opacity: torch.Tensor  # [N] in (0, 1)
    radius: torch.Tensor   # [N] int32 pixel radius (0 => culled)


def project_gaussians(
    xyz: torch.Tensor,
    scale: torch.Tensor,
    quat: torch.Tensor,
    opacity: torch.Tensor,
    shs: torch.Tensor,
    view: torch.Tensor,
    full_proj: torch.Tensor,
    campos: torch.Tensor,
    tanfov: torch.Tensor,
    width: int,
    height: int,
    sh_degree: int = 0,
    alive: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project gaussians into one camera (activated scale and opacity,
    unnormalized w-first quaternions, ``[N,K,3]`` SH)."""
    tanfovx, tanfovy = tanfov[0], tanfov[1]
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    gx, gy, gz = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    def row(mat, r):
        return gx * mat[r, 0] + gy * mat[r, 1] + gz * mat[r, 2] + mat[r, 3]

    pv_x = row(view, 0)
    pv_y = row(view, 1)
    depth = row(view, 2)
    in_front = depth > 0.2

    p_w = 1.0 / (row(full_proj, 3) + 1e-7)
    mean2d = torch.stack([
        ((row(full_proj, 0) * p_w + 1.0) * width - 1.0) * 0.5,
        ((row(full_proj, 1) * p_w + 1.0) * height - 1.0) * 0.5,
    ], dim=-1)

    c00, c01, c02, c11, c12, c22 = build_covariance6(scale, quat)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = depth
    txtz = clamp_tie(pv_x / tz, -limx, limx)
    tytz = clamp_tie(pv_y / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2
    W = view[:3, :3]
    t00 = j00 * W[0, 0] + j02 * W[2, 0]
    t01 = j00 * W[0, 1] + j02 * W[2, 1]
    t02 = j00 * W[0, 2] + j02 * W[2, 2]
    t10 = j11 * W[1, 0] + j12 * W[2, 0]
    t11 = j11 * W[1, 1] + j12 * W[2, 1]
    t12 = j11 * W[1, 2] + j12 * W[2, 2]
    u00 = t00 * c00 + t01 * c01 + t02 * c02
    u01 = t00 * c01 + t01 * c11 + t02 * c12
    u02 = t00 * c02 + t01 * c12 + t02 * c22
    u10 = t10 * c00 + t11 * c01 + t12 * c02
    u11 = t10 * c01 + t11 * c11 + t12 * c12
    u12 = t10 * c02 + t11 * c12 + t12 * c22
    cxx = u00 * t00 + u01 * t01 + u02 * t02 + 0.3
    cxy = u00 * t10 + u01 * t11 + u02 * t12
    cyy = u10 * t10 + u11 * t11 + u12 * t12 + 0.3

    det = cxx * cyy - cxy * cxy
    det_valid = det != 0.0
    inv_det = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
        valid = in_front & det_valid
        if alive is not None:
            valid = valid & alive
        radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    dirs = xyz - campos[None, :]
    dirs = dirs / clamp_tie(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    color = clamp_tie(sh_ops.eval_sh(sh_degree, shs, dirs) + 0.5, 0.0)

    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, color=color,
        opacity=opacity, radius=radius,
    )
