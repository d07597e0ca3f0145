"""Differentiable triangle rasterization (nvdiffrast replacement).

Port of the rasterize/interpolate half of
``dreamgaussian_tpu/ops/mesh_raster.py``, in the same two phases:

1. **Visibility (kernel K3, no gradient):** triangles are binned to
   screen tiles (``binning.bin_rects``) and the z-test kernel picks the
   nearest covering triangle per pixel (``mesh_raster_cuda.ztest``).
2. **Deferred shading (autograd):** screen barycentrics of each pixel's
   winning triangle are re-derived from the clip-space vertices in plain
   torch ops, so gradients reach vertex positions and every interpolated
   attribute through autograd; occlusion boundaries carry no gradient.

Perspective-correct interpolation uses clip-space w; depth uses
screen-affine NDC z like OpenGL. Texture sampling, the mip chain and
antialiasing belong to stage 2 and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import bin_rects
from .clamp import clamp_tie
from .mesh_raster_cuda import ROWS, ztest


class RastOut(NamedTuple):
    tri_id: torch.Tensor   # [H, W] int32, 0 = miss, else face index + 1
    bary: torch.Tensor     # [H, W, 3] perspective-correct, differentiable
    zbuf: torch.Tensor     # [H, W] NDC depth (0 where miss)
    mask: torch.Tensor     # [H, W] bool coverage
    # Screen-space derivatives of the barycentrics (the same winning
    # triangle re-evaluated at the +1px pixel centres); for mip level
    # selection, non-None only when rasterize(..., derivs=True).
    bary_dx: torch.Tensor | None = None  # [H, W, 3]
    bary_dy: torch.Tensor | None = None  # [H, W, 3]


def _screen_coords(v_clip: torch.Tensor, width: int, height: int):
    """Clip -> pixel coords with the pixel-centre convention of the gaussian
    renderer (pixel i centre at ndc (2i+1)/size - 1)."""
    w = v_clip[:, 3:4]
    ndc = v_clip[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    sizes = torch.tensor([width, height], dtype=v_clip.dtype, device=v_clip.device)
    xy = ((ndc[:, :2] + 1.0) * sizes - 1.0) * 0.5
    return xy, ndc[:, 2], w[:, 0]


def triangle_features(v_clip, faces, width: int, height: int, tile: int):
    """Per-triangle z-test features and tile rects, without gradient:
    (feat_cols [ROWS, F+1] with an all-zero padding column F, xmin, ymin,
    xmax, ymax int32 tile rects [min, max), ok [F] bool)."""
    grid_x = width // tile
    grid_y = height // tile
    nf = faces.shape[0]
    with torch.no_grad():
        xy, z_ndc, w_clip = _screen_coords(v_clip.detach(), width, height)
        tv = xy[faces]                         # [F, 3, 2]
        tz = z_ndc[faces]                      # [F, 3]
        tw = w_clip[faces]
        # Cull: behind-camera (any w <= eps) or degenerate bbox; off-screen
        # bboxes give empty rects through the clamp.
        ok = (tw > 1e-6).all(dim=1)
        fx = tv[..., 0]
        fy = tv[..., 1]
        xmin = torch.clamp((fx.amin(1) / tile).to(torch.int32), 0, grid_x)
        ymin = torch.clamp((fy.amin(1) / tile).to(torch.int32), 0, grid_y)
        xmax = torch.clamp(((fx.amax(1) + tile) / tile).to(torch.int32), 0, grid_x)
        ymax = torch.clamp(((fy.amax(1) + tile) / tile).to(torch.int32), 0, grid_y)
        ok = ok & (xmax > xmin) & (ymax > ymin)
        ids = torch.arange(1, nf + 1, device=v_clip.device, dtype=torch.float32)
        rows = torch.cat([tv.reshape(nf, 6).T.float(), tz.T.float(), ids[None, :]], dim=0)
        feat_cols = torch.nn.functional.pad(rows, (0, 1, 0, ROWS - rows.shape[0]))
    return feat_cols, xmin, ymin, xmax, ymax, ok


def rasterize(
    v_clip: torch.Tensor,
    faces: torch.Tensor,
    width: int,
    height: int,
    tile: int = 32,
    chunk: int = 128,
    derivs: bool = False,
) -> RastOut:
    """Rasterize clip-space triangles; differentiable barycentrics.

    v_clip: [V, 4]; faces: [F, 3] integer. ``derivs``: also produce
    screen-space barycentric derivatives for mip selection. On CUDA tensors
    the z-test runs in kernel K3.
    """
    if width % tile or height % tile:
        raise ValueError(f"image size must be {tile}-aligned, got {width}x{height}")
    faces = faces.long()
    nf = faces.shape[0]
    grid_x = width // tile
    grid_y = height // tile
    num_tiles = grid_x * grid_y

    feat_cols, xmin, ymin, xmax, ymax, ok = triangle_features(
        v_clip, faces, width, height, tile)
    bins = bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=grid_x,
                     num_tiles=num_tiles, chunk=chunk)
    dup_feat = feat_cols.index_select(1, bins.dup_map)
    ids, z = ztest(dup_feat, bins.chunk_starts, bins.n_chunks, grid_x=grid_x,
                   num_tiles=num_tiles, chunk=chunk, tile=tile)

    def to_image(planes):
        hw = planes.reshape(grid_y, grid_x, tile, tile)
        return hw.permute(0, 2, 1, 3).reshape(height, width)

    tri_id = to_image(ids)
    zbuf = to_image(z)
    mask = tri_id > 0

    # ---- Deferred differentiable barycentrics for the winners.
    xy, _, w_clip = _screen_coords(v_clip, width, height)
    fidx = torch.clamp(tri_id.long() - 1, 0, nf - 1)          # [H, W]
    fa = _take_rows(_face_attrs(torch.cat([xy, w_clip[:, None]], dim=1), faces), fidx)
    fa = fa.reshape(fa.shape[:-1] + (3, 3))
    p = fa[..., :2]                                # [H, W, 3, 2]
    pw = fa[..., 2]                                # [H, W, 3]

    pxx = torch.arange(width, dtype=torch.float32, device=v_clip.device)[None, :]
    pyy = torch.arange(height, dtype=torch.float32, device=v_clip.device)[:, None]
    x0, y0 = p[..., 0, 0], p[..., 0, 1]
    x1, y1 = p[..., 1, 0], p[..., 1, 1]
    x2, y2 = p[..., 2, 0], p[..., 2, 1]

    def bary_at(qx, qy):
        e0 = (x2 - x1) * (qy - y1) - (y2 - y1) * (qx - x1)
        e1 = (x0 - x2) * (qy - y2) - (y0 - y2) * (qx - x2)
        e2 = (x1 - x0) * (qy - y0) - (y1 - y0) * (qx - x0)
        area = e0 + e1 + e2
        inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, torch.full_like(area, 1e-12))
        b = torch.stack([e0, e1, e2], dim=-1) * inv_area[..., None]
        # Perspective correction: weight by 1/w.
        pc = b / clamp_tie(pw, 1e-12)
        pc = pc / clamp_tie(pc.sum(dim=-1, keepdim=True), 1e-12)
        return torch.where(mask[..., None], pc, torch.zeros_like(pc))

    bary = bary_at(pxx, pyy)
    bary_dx = bary_dy = None
    if derivs:
        # Same triangle, neighbouring pixel centres: an exact finite
        # difference of the barycentric field, no neighbour-pixel reads.
        with torch.no_grad():
            bary_dx = bary_at(pxx + 1.0, pyy) - bary
            bary_dy = bary_at(pxx, pyy + 1.0) - bary
    return RastOut(tri_id=tri_id, bary=bary,
                   zbuf=torch.where(mask, zbuf, torch.zeros_like(zbuf)),
                   mask=mask, bary_dx=bary_dx, bary_dy=bary_dy)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: [R, ...] rows by an integer index tensor."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def _face_attrs(attrs: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Pack per-vertex attrs face-major: [V, A] -> [F, 3*A], so that the
    per-pixel lookup is one row gather."""
    return attrs.index_select(0, faces.reshape(-1).long()).reshape(
        faces.shape[0], 3 * attrs.shape[-1])


def _pixel_attrs(attrs, faces, rast: RastOut):
    nf = faces.shape[0]
    fidx = torch.clamp(rast.tri_id.long() - 1, 0, nf - 1)
    fa = _take_rows(_face_attrs(attrs, faces), fidx)  # [H, W, 3A]
    return fa.reshape(fa.shape[:-1] + (3, attrs.shape[-1]))


def interpolate(attrs: torch.Tensor, faces: torch.Tensor, rast: RastOut) -> torch.Tensor:
    """Perspective-correct per-pixel attribute interpolation.

    attrs: [V, A] -> [H, W, A]; zero where no coverage.
    """
    a = _pixel_attrs(attrs, faces, rast)
    out = (a * rast.bary[..., None]).sum(dim=-2)
    return torch.where(rast.mask[..., None], out, torch.zeros_like(out))


def interpolate_with_derivs(attrs: torch.Tensor, faces: torch.Tensor, rast: RastOut):
    """interpolate() plus screen-space attribute derivatives (nvdiffrast's
    ``diff_attrs='all'`` analogue). Requires rasterize(..., derivs=True).
    Returns (attr [H,W,A], d/dx, d/dy)."""
    if rast.bary_dx is None:
        raise ValueError("rasterize(..., derivs=True) required")
    a = _pixel_attrs(attrs, faces, rast)
    m = rast.mask[..., None]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    out = (a * rast.bary[..., None]).sum(dim=-2)
    ddx = (a * rast.bary_dx[..., None]).sum(dim=-2)
    ddy = (a * rast.bary_dy[..., None]).sum(dim=-2)
    return torch.where(m, out, zero), torch.where(m, ddx, zero), torch.where(m, ddy, zero)
