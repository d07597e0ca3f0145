"""Quaternion / covariance math for 3D Gaussians (torch, differentiable).

Port of ``dreamgaussian_tpu/ops/quat.py``: w-first quaternions stored
unnormalized and normalized on use; ``Sigma = R S S^T R^T`` packed as
its six upper-triangular entries (xx, xy, xz, yy, yz, zz).
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions ``[..., 4]`` (w, x, y, z)."""
    norm = torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), eps))
    return q / norm


def _rot_entries(q: torch.Tensor):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
        2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
        2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``."""
    r = _rot_entries(q)
    return torch.stack(
        [torch.stack(r[0:3], -1), torch.stack(r[3:6], -1), torch.stack(r[6:9], -1)],
        dim=-2,
    )


def build_covariance6(scale: torch.Tensor, quat: torch.Tensor) -> tuple:
    """Packed covariance (xx, xy, xz, yy, yz, zz) as six ``[...]`` tensors
    from activated scales ``[..., 3]`` and unnormalized quaternions."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rot_entries(normalize_quat(quat))
    s0 = scale[..., 0] * scale[..., 0]
    s1 = scale[..., 1] * scale[..., 1]
    s2 = scale[..., 2] * scale[..., 2]
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return xx, xy, xz, yy, yz, zz
