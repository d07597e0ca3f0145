"""Stage-1 export: gaussians -> cleaned mesh -> baked UV texture.

Port of ``dreamgaussian_tpu/meshing/export.py``:

- occupancy field + marching tetrahedra + native clean/smooth/remesh/
  decimate;
- UV unwrap + 26 fixed orbit views; each view renders the gaussians and
  rasterizes the mesh with the SAME camera matrices (pixel-aligned by
  construction), masks texels by coverage and viewing angle
  (viewcos > 0.5), scatters colours into the texture with the mipmap
  grid_put, first-view-wins accumulation;
- unseen texels are filled by dilate + nearest-neighbour inpaint.

The whole bake loop stays on the device: the mesh tensors, each view's
raster, interpolation, normalisation, viewcos, the mask, the mipmap
scatter and the first-view-wins merge. ``render_view_fn`` hands back a
device tensor, and nothing is read to the host per view beyond the
binning's pair totals. Only the final inpaint (scipy) runs on the host,
once.

Each entry point takes an optional ``stats`` dict and records in it the
seconds of its stages and the sizes it produced.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.grid_put import mipmap_linear_grid_put_2d
from ..ops.mesh_raster import interpolate, rasterize
from ..utils.camera import Camera, orbit_camera
from .marching_cubes import marching_cubes
from .mesh import Mesh
from .occupancy import extract_occupancy_field

# 26 fixed bake views: three rings of eight plus the two poles.
BAKE_VERS = [0] * 8 + [-45] * 8 + [45] * 8 + [-89.9, 89.9]
BAKE_HORS = [0, 45, -45, 90, -90, 135, -135, 180] * 3 + [0, 0]


class _Stages:
    """Seconds per named stage into ``stats`` (a dict or None)."""

    def __init__(self, stats):
        self.stats = stats
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        if self.stats is not None:
            self.stats[name] = self.stats.get(name, 0.0) + now - self.t
        self.t = now


def extract_mesh(
    params: dict,
    alive: torch.Tensor,
    density_thresh: float = 1.0,
    resolution: int = 128,
    decimate_target: int = 100_000,
    smooth_iters: int = 2,
    remesh_size: float = 0.015,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> Mesh:
    """Gaussians -> world-space cleaned/remeshed/decimated triangle mesh.

    ``remesh_size`` > 0 runs the isotropic remesh toward that target edge
    length between cleanup and decimation; 0 leaves Laplacian smoothing
    only."""
    from .. import native

    stages = _Stages(stats)
    occ, tf = extract_occupancy_field(params, alive, resolution=resolution, device=device)
    stages.done("field_s")
    verts, faces = marching_cubes(occ, density_thresh)
    if len(faces) == 0:
        raise ValueError(
            f"empty isosurface at density_thresh={density_thresh} "
            f"(occ max {occ.max():.4f})"
        )
    stages.done("isosurface_s")
    world = tf.grid_to_world(verts, resolution)
    v, f = native.clean_mesh(world, faces, weld_eps=1e-6, min_comp_frac=0.1)
    if smooth_iters:
        v = native.laplacian_smooth(v, f, smooth_iters, 0.5)
    if remesh_size:
        v, f = native.isotropic_remesh(v, f, remesh_size, n_iter=5)
    if decimate_target and len(f) > decimate_target:
        v, f = native.decimate_mesh(v, f, decimate_target)
    mesh = Mesh(v=v.astype(np.float32), f=f.astype(np.int32))
    mesh.auto_normal()
    stages.done("clean_remesh_decimate_s")
    if stats is not None:
        stats["isosurface_faces"] = int(len(faces))
        stats["occ_max"] = float(occ.max())
    return mesh


def _safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps))


@torch.no_grad()
def bake_texture(
    mesh: Mesh,
    render_view_fn,
    fovy: float,
    radius: float = 2.0,
    texture_size: int = 1024,
    render_resolution: int = 512,
    viewcos_thresh: float = 0.5,
    min_resolution: int = 256,
    inpaint: bool = True,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> np.ndarray:
    """Bake a UV albedo from multi-view gaussian renders.

    render_view_fn(cam: Camera) -> [H, W, 3] in [0, 1], the gaussian render
    for one camera, as a tensor on ``device`` (an array is moved there).
    The mesh must already have vt/ft (auto_uv) and vn.
    """
    dev = resolve_device(device)
    stages = _Stages(stats)
    h = w = texture_size
    albedo = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((h, w), dtype=torch.float32, device=dev)

    def on_device(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    v = on_device(mesh.v, torch.float32)
    f = on_device(mesh.f, torch.int64)
    vt = on_device(mesh.vt, torch.float32)
    ft = on_device(mesh.ft, torch.int64)
    vn = on_device(mesh.vn, torch.float32)
    v_h = torch.cat([v, torch.ones((v.shape[0], 1), device=dev)], dim=1)

    for ver, hor in zip(BAKE_VERS, BAKE_HORS):
        pose = orbit_camera(ver, hor, radius)
        cam = Camera.from_pose(pose, render_resolution, render_resolution, fovy, fovy)
        rgb = torch.as_tensor(render_view_fn(cam), dtype=torch.float32, device=dev)

        v_clip = v_h @ on_device(cam.arrays()["full_proj"], torch.float32).T
        rast = rasterize(v_clip, f, render_resolution, render_resolution, tile=32)
        uvs = interpolate(vt, ft, rast)                     # [R, R, 2]
        normal = _safe_normalize(interpolate(vn, f, rast))
        # viewcos: cosine between the surface normal and the view direction
        # (camera-facing z after rotating into the camera frame).
        viewcos = (normal @ on_device(pose[:3, :3], torch.float32))[..., 2]
        mask = rast.mask & (viewcos > viewcos_thresh)
        # Every pixel goes into the scatter with weight 0 or 1.
        cur_albedo, cur_cnt = mipmap_linear_grid_put_2d(
            h, w, uvs.reshape(-1, 2) * 2.0 - 1.0, rgb.reshape(-1, 3),
            min_resolution=min_resolution, return_count=True,
            weights=mask.reshape(-1).float(),
        )
        # First-view-wins: only texels not yet covered take new data (raw
        # sums + counts, normalized once at the end).
        fresh = cnt < 0.1
        albedo = torch.where(fresh[..., None], albedo + cur_albedo, albedo)
        cnt = torch.where(fresh, cnt + cur_cnt, cnt)

    seen_d = cnt > 0
    albedo = albedo / torch.where(seen_d, cnt, torch.ones_like(cnt))[..., None]
    albedo = albedo.cpu().numpy()
    seen = seen_d.cpu().numpy()
    stages.done("bake_s")
    if stats is not None:
        stats["covered_share"] = float(seen.mean())

    if inpaint and seen.any() and not seen.all():
        from scipy.ndimage import binary_dilation, binary_erosion
        from scipy.spatial import cKDTree

        inpaint_region = binary_dilation(seen, iterations=32)
        inpaint_region[seen] = 0
        search_region = seen.copy()
        interior = binary_erosion(search_region, iterations=3)
        search_region[interior] = 0
        search_coords = np.argwhere(search_region)
        inpaint_coords = np.argwhere(inpaint_region)
        if len(search_coords) and len(inpaint_coords):
            tree = cKDTree(search_coords)
            _, idx = tree.query(inpaint_coords, k=1)
            albedo[tuple(inpaint_coords.T)] = albedo[
                tuple(search_coords[idx].T)
            ]
    stages.done("inpaint_s")
    return albedo


def export_textured_mesh(
    params: dict,
    alive: torch.Tensor,
    render_view_fn,
    path: str,
    fovy: float,
    radius: float = 2.0,
    density_thresh: float = 1.0,
    texture_size: int = 1024,
    bake_resolution: int = 512,
    mc_resolution: int = 128,
    decimate_target: int = 100_000,
    remesh_size: float = 0.015,
    uv_cache_path: str | None = None,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> Mesh:
    """Full geo+tex export: mesh extraction + UV + bake + write."""
    mesh = extract_mesh(
        params, alive, density_thresh=density_thresh,
        resolution=mc_resolution, decimate_target=decimate_target,
        remesh_size=remesh_size, device=device, stats=stats,
    )
    stages = _Stages(stats)
    mesh.auto_uv(cache_path=uv_cache_path)
    mesh.auto_normal()
    stages.done("uv_s")
    mesh.albedo = bake_texture(
        mesh, render_view_fn, fovy=fovy, radius=radius,
        texture_size=texture_size, render_resolution=bake_resolution,
        min_resolution=min(256, texture_size // 4), device=device, stats=stats,
    )
    stages = _Stages(stats)
    mesh.write(path)
    stages.done("write_s")
    if stats is not None:
        stats.update(vertices=int(len(mesh.v)), faces=int(len(mesh.f)),
                     uv_vertices=int(len(mesh.vt)))
    return mesh
