"""Camera math: orbit poses, GS projection matrices and the interactive
orbit camera (numpy, host side).

The port's copy of ``dreamgaussian_tpu/utils/camera.py``; the two give
exactly equal arrays. Conventions, kept verbatim because
trained checkpoints depend on them:

- ``orbit_camera`` gives an OpenGL-convention camera-to-world pose from
  (elevation, azimuth, radius); elevation > 0 looks down from above,
  azimuth 0 is on +z.
- ``Camera.from_pose`` applies the NeRF->GS rectification (negate rows
  1:3 of the w2c rotation and the whole translation) and the quirky
  ``campos = -c2w[:3, 3]``.
- ``gs_projection`` is the z-forward GS projection with z_sign = +1.
- ``OrbitCamera.perspective`` has the flipped-y row of the mesh pipeline.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _normalize(x: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    return x / np.sqrt(np.maximum(np.sum(x * x, axis=-1, keepdims=True), eps))


def look_at(campos: np.ndarray, target: np.ndarray, opengl: bool = True) -> np.ndarray:
    """Rotation matrix [3,3] whose columns are (right, up, forward)."""
    if opengl:
        # Camera forward is +z (points from target toward the camera).
        forward = _normalize(campos - target)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _normalize(np.cross(up, forward))
        up = _normalize(np.cross(forward, right))
    else:
        forward = _normalize(target - campos)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _normalize(np.cross(forward, up))
        up = _normalize(np.cross(right, forward))
    return np.stack([right, up, forward], axis=1).astype(np.float32)


def orbit_camera(
    elevation: float,
    azimuth: float,
    radius: float = 1.0,
    is_degree: bool = True,
    target: np.ndarray | None = None,
    opengl: bool = True,
) -> np.ndarray:
    """Camera-to-world pose [4,4] on an orbit around ``target``."""
    if is_degree:
        elevation = math.radians(elevation)
        azimuth = math.radians(azimuth)
    x = radius * math.cos(elevation) * math.sin(azimuth)
    y = -radius * math.sin(elevation)
    z = radius * math.cos(elevation) * math.cos(azimuth)
    if target is None:
        target = np.zeros(3, dtype=np.float32)
    campos = np.array([x, y, z], dtype=np.float32) + target
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = look_at(campos, target, opengl)
    pose[:3, 3] = campos
    return pose


def gs_projection(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """GS-convention perspective projection (z forward, z_sign=+1), [4,4]."""
    tan_x = math.tan(fovx / 2)
    tan_y = math.tan(fovy / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One render camera. ``p_cam = view @ p_world_homog``,
    ``full_proj = proj @ view``."""

    view: np.ndarray        # [4,4] rectified world-to-camera
    full_proj: np.ndarray   # [4,4] projection @ view
    campos: np.ndarray      # [3]
    tanfovx: float
    tanfovy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @classmethod
    def from_pose(
        cls,
        c2w: np.ndarray,
        width: int,
        height: int,
        fovy: float,
        fovx: float,
        znear: float = 0.01,
        zfar: float = 100.0,
    ) -> "Camera":
        """Build from a NeRF-convention (OpenGL) camera-to-world pose."""
        w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float32))
        w2c[1:3, :3] *= -1
        w2c[:3, 3] *= -1
        proj = gs_projection(znear, zfar, fovx, fovy)
        return cls(
            view=w2c.astype(np.float32),
            full_proj=(proj @ w2c).astype(np.float32),
            campos=(-np.asarray(c2w, dtype=np.float32)[:3, 3]).copy(),
            tanfovx=math.tan(fovx / 2),
            tanfovy=math.tan(fovy / 2),
            width=int(width),
            height=int(height),
            znear=znear,
            zfar=zfar,
        )

    def arrays(self) -> dict:
        """Dense array form consumed by the renderer."""
        return {
            "view": np.asarray(self.view, dtype=np.float32),
            "full_proj": np.asarray(self.full_proj, dtype=np.float32),
            "campos": np.asarray(self.campos, dtype=np.float32),
            "tanfov": np.array([self.tanfovx, self.tanfovy], dtype=np.float32),
        }


def stack_cameras(cams: list[Camera]) -> dict:
    """Stack same-resolution cameras into batched arrays."""
    assert len({(c.width, c.height) for c in cams}) == 1, "mixed resolutions"
    ds = [c.arrays() for c in cams]
    return {k: np.stack([d[k] for d in ds], axis=0) for k in ds[0]}


class OrbitCamera:
    """Interactive orbit camera: a rotation, a radius and a target centre."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0,
                 near: float = 0.01, far: float = 100.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = math.radians(fovy)
        self.near = near
        self.far = far
        self.center = np.zeros(3, dtype=np.float32)
        self.up = np.array([0, 1, 0], dtype=np.float32)
        self._rotmat = np.eye(3, dtype=np.float32)

    @property
    def fovx(self) -> float:
        return 2 * math.atan(math.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self._rotmat
        pose = rot @ pose
        pose[:3, 3] -= self.center
        return pose

    @property
    def campos(self) -> np.ndarray:
        return self.pose[:3, 3]

    @property
    def view(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    @property
    def perspective(self) -> np.ndarray:
        """OpenGL perspective with flipped y (the mesh pipeline's convention)."""
        y = math.tan(self.fovy / 2)
        aspect = self.W / self.H
        return np.array(
            [
                [1 / (y * aspect), 0, 0, 0],
                [0, -1 / y, 0, 0],
                [0, 0, -(self.far + self.near) / (self.far - self.near),
                 -(2 * self.far * self.near) / (self.far - self.near)],
                [0, 0, -1, 0],
            ],
            dtype=np.float32,
        )

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * math.tan(self.fovy / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], dtype=np.float32)

    @property
    def mvp(self) -> np.ndarray:
        return self.perspective @ np.linalg.inv(self.pose)

    def orbit(self, dx: float, dy: float) -> None:
        """Turn about the up axis by -0.05 dx degrees and about the camera's
        side axis by -0.05 dy degrees."""
        from scipy.spatial.transform import Rotation as R

        side = self._rotmat[:3, 0]
        rot_x = R.from_rotvec(self.up * math.radians(-0.05 * dx))
        rot_y = R.from_rotvec(side * math.radians(-0.05 * dy))
        self._rotmat = (rot_x * rot_y * R.from_matrix(self._rotmat)).as_matrix()

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center += 0.0005 * self._rotmat @ np.array([-dx, -dy, dz], dtype=np.float32)
