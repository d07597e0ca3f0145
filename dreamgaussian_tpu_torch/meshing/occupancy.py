"""Gaussian-cloud occupancy field for mesh extraction.

Port of ``dreamgaussian_tpu/meshing/occupancy.py``: evaluate
``occ(p) = sum_g opacity_g * exp(-0.5 (p-mu_g)^T Sigma_g^{-1} (p-mu_g))``
on a regular grid over the normalized [-1, 1] bounding cube, after
filtering gaussians with opacity <= 0.005.

The quadratic form is factorized into a 10-feature matrix product: with
A = Sigma^{-1},

  (p-mu)^T A (p-mu) = [1, px, py, pz, px^2, py^2, pz^2, pxpy, pxpz, pypz]
                      . G(A, mu)

so a [M, 10] x [10, G] product gives every point-gaussian quadratic form
at once; the exp and the opacity product follow. Both products are plain
``torch.matmul`` in full float32 (TF32 off). Eager PyTorch materialises
the [M, G] plane, so the grid streams through in blocks of M points sized
to keep that plane at ``plane_bytes`` (256 MiB by default).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.quat import normalize_quat, quat_to_rotmat


class OccupancyTransform(NamedTuple):
    """Mapping between world space and the normalized field cube."""

    center: np.ndarray  # [3]
    scale: float

    def grid_to_world(self, verts: np.ndarray, resolution: int) -> np.ndarray:
        """Marching-cubes grid coords -> world coords."""
        v = verts / (resolution - 1.0) * 2.0 - 1.0
        return v / self.scale + self.center


def _inv_cov_features(cov: torch.Tensor, eps: float = 1e-24):
    """Inverse-covariance entries [G, 6] (xx, xy, xz, yy, yz, zz) and the
    mask of invertible covariances. Degenerate covariances (det ~ 0) get
    zero entries => zero density."""
    a = cov[:, 0, 0]
    b = cov[:, 0, 1]
    c = cov[:, 0, 2]
    d = cov[:, 1, 1]
    e = cov[:, 1, 2]
    f = cov[:, 2, 2]
    det = a * d * f + 2 * b * c * e - a * e * e - b * b * f - c * c * d
    ok = det > eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    ia = (d * f - e * e) * inv_det
    ib = (c * e - b * f) * inv_det
    ic = (b * e - c * d) * inv_det
    id_ = (a * f - c * c) * inv_det
    ie = (b * c - a * e) * inv_det
    if_ = (a * d - b * b) * inv_det
    return torch.stack([ia, ib, ic, id_, ie, if_], dim=-1), ok


def _features(mu: torch.Tensor, inv6: torch.Tensor) -> torch.Tensor:
    """[G, 10] gaussian-side features for the factorized quad form."""
    ia, ib, ic, id_, ie, if_ = (inv6[:, i] for i in range(6))
    mx, my, mz = mu[:, 0], mu[:, 1], mu[:, 2]
    const = (
        ia * mx * mx + id_ * my * my + if_ * mz * mz
        + 2 * ib * mx * my + 2 * ic * mx * mz + 2 * ie * my * mz
    )
    gx = -2 * (ia * mx + ib * my + ic * mz)
    gy = -2 * (ib * mx + id_ * my + ie * mz)
    gz = -2 * (ic * mx + ie * my + if_ * mz)
    return torch.stack(
        [const, gx, gy, gz, ia, id_, if_, 2 * ib, 2 * ic, 2 * ie], dim=-1
    )


def _phi(pts: torch.Tensor) -> torch.Tensor:
    """[M, 10] point-side monomial features."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return torch.stack(
        [torch.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z],
        dim=-1,
    )


@torch.no_grad()
def _field_on_grid(mu, inv6, opa, resolution: int, plane_bytes: int = 1 << 28):
    """Occupancy [R, R, R] (x, y, z index order) of the normalized cloud."""
    dev = mu.device
    feats_t = _features(mu, inv6).T.contiguous()             # [10, G]
    lin = torch.from_numpy(np.linspace(-1.0, 1.0, resolution).astype(np.float32)).to(dev)
    total = resolution ** 3
    block = max(1, plane_bytes // (4 * max(1, mu.shape[0])))
    out = torch.empty(total, dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, total, block):
            idx = torch.arange(start, min(start + block, total), device=dev)
            pts = torch.stack([lin[idx // (resolution * resolution)],
                               lin[(idx // resolution) % resolution],
                               lin[idx % resolution]], dim=-1)
            power = torch.matmul(_phi(pts), feats_t).mul_(-0.5)   # [M, G]
            positive = power > 0
            w = power.clamp_(max=0.0).exp_().masked_fill_(positive, 0.0)
            out[start:start + idx.numel()] = torch.matmul(w, opa)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.reshape(resolution, resolution, resolution)


@torch.no_grad()
def extract_occupancy_field(
    params: dict,
    alive: torch.Tensor,
    resolution: int = 128,
    opacity_min: float = 0.005,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, OccupancyTransform]:
    """Occupancy grid [R,R,R] + world transform from padded scene params.

    Dead or near-transparent gaussians contribute zero (the mask is folded
    into the opacity vector). The tensors must lie on ``device``.
    """
    dev = resolve_device(device)
    xyz = params["xyz"]
    if xyz.device.type != dev.type:
        raise ValueError(f"extract_occupancy_field(device={dev}) got tensors on {xyz.device}")
    opa = torch.sigmoid(params["opacity"][:, 0])
    use = alive & (opa > opacity_min)
    opa = torch.where(use, opa, torch.zeros_like(opa))

    # Bounding box over used gaussians only, normalized to ~[-1, 1] with
    # 1.8 / extent.
    big = 1e9
    mn = torch.where(use[:, None], xyz, torch.full_like(xyz, big)).amin(0)
    mx = torch.where(use[:, None], xyz, torch.full_like(xyz, -big)).amax(0)
    center = (mn + mx) / 2.0
    scale = 1.8 / (mx - mn).amax()

    mu = (xyz - center) * scale
    stds = torch.exp(params["scaling"]) * scale
    m = quat_to_rotmat(normalize_quat(params["rotation"])) * stds[:, None, :]
    cov = (m[:, :, None, :] * m[:, None, :, :]).sum(-1)        # M M^T, [G, 3, 3]
    inv6, ok = _inv_cov_features(cov)
    opa = torch.where(ok, opa, torch.zeros_like(opa))
    occ = _field_on_grid(mu, inv6, opa, resolution)
    return (
        occ.cpu().numpy(),
        OccupancyTransform(center=center.cpu().numpy(), scale=float(scale)),
    )
