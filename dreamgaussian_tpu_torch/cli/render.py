"""Orbit rendering and turntable export of a result.

Port of ``dreamgaussian_tpu/cli/render.py``: renders a gaussian PLY
(through the stage-1 renderer, kernel K1 on the card) or a mesh (through
``render/mesh_renderer.py``, kernel K3) from ``--num_frames`` azimuths
evenly spaced from -180 degrees at ``--elevation`` and ``--radius``, and
saves them as a PNG grid, a GIF (``utils/gif.py``) or an H.264 MP4
(``utils/mp4.py``, the port's own intra encoder in ``csrc/h264_intra.cpp``,
where the JAX CLI goes through imageio and libx264). A mesh without UVs is
unwrapped and one without a texture is shaded with a 0.7 grey albedo.
``--device`` picks the card (default) or the CPU.

    python -m dreamgaussian_tpu_torch.cli.render logs/name_model.ply --out o.gif
    python -m dreamgaussian_tpu_torch.cli.render logs/name.obj --out turntable.mp4
    python -m dreamgaussian_tpu_torch.cli.render logs/name.obj --num_frames 8 --out grid.png

The viewer (``cli/serve.py``) and the metrics (``cli/eval.py``) render
through the same functions.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..utils.camera import Camera, orbit_camera


def load_artifact(path: str, device) -> tuple[str, object]:
    """("gaussians", (params, aux, sh_degree)) for a ``.ply``, else
    ("mesh", MeshRendererState) for a mesh file."""
    if os.path.splitext(path)[1].lower() == ".ply":
        from ..scene import load_ply

        return "gaussians", load_ply(path, device=device)
    from ..meshing.mesh import Mesh
    from ..render.mesh_renderer import MeshRendererState

    mesh = Mesh.load(path, resize=False)
    if mesh.vt is None:
        mesh.auto_uv()
        mesh.auto_normal()
    if mesh.albedo is None:
        mesh.albedo = np.full((512, 512, 3), 0.7, np.float32)
    return "mesh", MeshRendererState.from_mesh(mesh, device)


@torch.no_grad()
def render_view(kind: str, artifact, cam: Camera, device) -> tuple:
    """(image [H, W, 3], depth [H, W], alpha [H, W]) tensors of one camera,
    on a white background."""
    arrays = {k: torch.from_numpy(v).to(device) for k, v in cam.arrays().items()}
    if kind == "gaussians":
        from ..train.step import render_one

        params, aux, sh_degree = artifact
        out = render_one(params, arrays, torch.ones(3, device=device), cam.width, cam.height,
                         sh_degree, aux.alive)
        return out.image, out.depth, out.alpha
    from ..render.mesh_renderer import render_mesh

    w2c = np.asarray(cam.view[:3, :3]).copy()
    w2c[1:3] *= -1
    out = render_mesh(artifact, arrays, torch.from_numpy(np.ascontiguousarray(w2c.T)).to(device),
                      cam.height, cam.width)
    return out["image"], out["depth"][..., 0], out["alpha"][..., 0]


def orbit_frames(path: str, frames: int, size: int, elevation: float, radius: float,
                 fovy: float, device="cuda") -> list:
    """RGB [size, size, 3] float32 frames of the artifact at ``path`` from
    ``frames`` azimuths evenly spaced from -180 degrees."""
    device = resolve_device(device)
    kind, artifact = load_artifact(path, device)
    out = []
    for hor in np.linspace(-180, 180, frames, endpoint=False):
        cam = Camera.from_pose(orbit_camera(elevation, hor, radius), size, size, fovy, fovy)
        out.append(render_view(kind, artifact, cam, device)[0].cpu().numpy())
    return out


def render_gaussian_frames(ply_path, frames, size, elevation, radius, fovy, device="cuda"):
    return orbit_frames(ply_path, frames, size, elevation, radius, fovy, device)


def render_mesh_frames(mesh_path, frames, size, elevation, radius, fovy, device="cuda"):
    return orbit_frames(mesh_path, frames, size, elevation, radius, fovy, device)


def save_frames(frames: list, out_path: str, fps: int = 15) -> str:
    """Frames in [0, 1] as a PNG grid, a GIF or an H.264 MP4 (``.mp4``, at
    imageio's settings: QP 25, yuv420p, sizes scaled up to multiples of 16);
    returns the path written. An encoder that does not build or an encode
    that fails raises: nothing else is written in the MP4's place."""
    from ..utils.gif import write_gif
    from ..utils.mp4 import write_mp4
    from ..utils.png import write_png

    imgs = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    ext = os.path.splitext(out_path)[1].lower()
    if ext == ".png":
        cols = int(math.ceil(math.sqrt(len(imgs))))
        rows = int(math.ceil(len(imgs) / cols))
        h, w = imgs[0].shape[:2]
        grid = np.full((rows * h, cols * w, 3), 255, np.uint8)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
        write_png(out_path, grid)
    elif ext == ".gif":
        write_gif(out_path, imgs, fps=fps)
    elif ext == ".mp4":
        write_mp4(out_path, imgs, fps)
    else:
        raise ValueError(f"unsupported output format: {ext}")
    return out_path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch orbit renders")
    ap.add_argument("path", help=".ply (gaussians) or .obj/.glb (mesh)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--num_frames", type=int, default=36)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--elevation", type=float, default=0.0)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--fovy", type=float, default=49.1)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not os.path.exists(args.path):
        raise SystemExit(f"error: no such file: {args.path}")
    frames = orbit_frames(args.path, args.num_frames, args.size, args.elevation, args.radius,
                          math.radians(args.fovy), args.device)
    out = save_frames(frames, args.out or os.path.splitext(args.path)[0] + "_orbit.gif", args.fps)
    print(f"[INFO] wrote {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
