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
screen-affine NDC z like OpenGL. Stage 2 adds texture sampling (bilinear,
nearest, and trilinear over a mip chain), silhouette antialiasing and the
SSAA resize. Texel taps are row gathers (``index_select``) whose backward
is autograd's ``index_add_`` scatter; the JAX package's per-channel
scatter is a TPU layout workaround for the same sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def _tap(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[S, C] texels at integer ids [H, W] -> [H, W, C]; the backward
    scatter-adds into the [S, C] table."""
    return _take_rows(flat, idx.long())


def _bilinear(flat, x, y, lw, lh, offset=0):
    """Bilinear taps of a [lh, lw] level stored row-major in ``flat`` from
    ``offset`` at texel coordinates (x, y); ``lw``/``lh``/``offset`` are ints
    or integer tensors shaped like x."""
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.minimum(x0 + 1, torch.as_tensor(lw - 1, device=x.device))
    y1 = torch.minimum(y0 + 1, torch.as_tensor(lh - 1, device=x.device))
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    t00 = _tap(flat, offset + y0 * lw + x0)
    t01 = _tap(flat, offset + y0 * lw + x1)
    t10 = _tap(flat, offset + y1 * lw + x0)
    t11 = _tap(flat, offset + y1 * lw + x1)
    return (t00 * (1 - fx) * (1 - fy) + t01 * fx * (1 - fy)
            + t10 * (1 - fx) * fy + t11 * fx * fy)


def build_mip_chain(tex: torch.Tensor, min_size: int = 4) -> list:
    """2x2 average-pooled mip pyramid [full, half, ...] down to ``min_size``;
    differentiable (gradients average-splat back up)."""
    chain = [tex]
    while min(chain[-1].shape[0], chain[-1].shape[1]) > min_size:
        t = chain[-1]
        h2, w2 = t.shape[0] // 2, t.shape[1] // 2
        chain.append(t[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, -1).mean((1, 3)))
    return chain


def sample_texture_mip(chain: list, uv: torch.Tensor, uv_dx: torch.Tensor,
                       uv_dy: torch.Tensor) -> torch.Tensor:
    """Trilinear (linear-mipmap-linear) texture lookup.

    chain: ``build_mip_chain`` output; uv [H,W,2] in [0,1]; uv_dx/uv_dy its
    screen-space derivatives. Per-pixel LOD = log2 of the largest footprint
    in texels, clipped to the chain; the result blends the bilinear samples
    of levels floor(LOD) and floor(LOD) + 1. The chain is one flat [S, C]
    atlas with per-level offsets and sizes, so each pixel gathers 8 texels
    whatever the chain's depth. The blend is continuous in LOD: at an
    integer LOD both sides of the floor give level LOD's sample.
    """
    th, tw = chain[0].shape[0], chain[0].shape[1]
    n_levels = len(chain)
    c = chain[0].shape[-1]
    dev = uv.device
    sizes = torch.tensor([tw, th], dtype=torch.float32, device=dev)
    rho = torch.maximum(torch.linalg.vector_norm(uv_dx * sizes, dim=-1),
                        torch.linalg.vector_norm(uv_dy * sizes, dim=-1))
    lod = clamp_tie(torch.log2(clamp_tie(rho, 1e-12)), 0.0, n_levels - 1.0)

    flat = torch.cat([t.reshape(-1, c) for t in chain], dim=0)
    offs, off = [], 0
    for t in chain:
        offs.append(off)
        off += t.shape[0] * t.shape[1]
    as_table = lambda vals: torch.tensor(vals, dtype=torch.int64, device=dev)  # noqa: E731
    offs = as_table(offs)
    ths = as_table([t.shape[0] for t in chain])
    tws = as_table([t.shape[1] for t in chain])

    l0 = torch.floor(lod).long()
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    frac = (lod - l0.float())[..., None]
    u = clamp_tie(uv[..., 0], 0.0, 1.0)
    v = clamp_tie(uv[..., 1], 0.0, 1.0)

    def sample_level(lidx):
        lw, lh = tws[lidx], ths[lidx]
        return _bilinear(flat, u * (lw - 1).float(), v * (lh - 1).float(), lw, lh,
                         offs[lidx])

    return sample_level(l0) * (1 - frac) + sample_level(l1) * frac


def sample_texture(tex: torch.Tensor, uv: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Differentiable texture lookup. tex [th, tw, C], uv [H, W, 2] in
    [0, 1] (u -> width axis, v -> height axis)."""
    th, tw = tex.shape[0], tex.shape[1]
    x = clamp_tie(uv[..., 0], 0.0, 1.0) * (tw - 1)
    y = clamp_tie(uv[..., 1], 0.0, 1.0) * (th - 1)
    flat = tex.reshape(th * tw, -1)
    if mode == "nearest":
        return _tap(flat, torch.round(y).long() * tw + torch.round(x).long())
    return _bilinear(flat, x, y, tw, th)


def _aa_axis(color, tri_id, zbuf, mask, xy, faces, horizontal: bool, z_eps: float):
    """Additive antialias adjustment from one pass of adjacent pixel pairs
    (horizontal: (y,x)-(y,x+1), else (y,x)-(y+1,x)); see ``antialias``."""
    h, w = tri_id.shape
    nf = faces.shape[0]
    if horizontal:
        sl_a = (slice(None), slice(0, w - 1))
        sl_b = (slice(None), slice(1, None))
    else:
        sl_a = (slice(0, h - 1), slice(None))
        sl_b = (slice(1, None), slice(None))

    id_a, id_b = tri_id[sl_a], tri_id[sl_b]
    m_a, m_b = mask[sl_a], mask[sl_b]
    inf = torch.full_like(zbuf[sl_a], float("inf"))
    z_a = torch.where(m_a, zbuf[sl_a], inf)
    z_b = torch.where(m_b, zbuf[sl_b], inf)

    # Silhouette proxy: ids differ and (background on one side or a depth
    # discontinuity); interior shared edges have continuous depth.
    pair = (id_a != id_b) & ((~m_a) | (~m_b) | ((z_a - z_b).abs() > z_eps))
    win_a = z_a <= z_b                        # the closer side owns the edge
    wid = torch.where(win_a, id_a, id_b)
    fidx = torch.clamp(wid.long() - 1, 0, nf - 1)
    p = _take_rows(xy, faces[fidx])           # [h', w', 3, 2], differentiable

    # Pixel centres of the winner (t=0) and the loser (t=1).
    ys, xs = torch.meshgrid(
        torch.arange(id_a.shape[0], dtype=torch.float32, device=xy.device),
        torch.arange(id_a.shape[1], dtype=torch.float32, device=xy.device),
        indexing="ij")
    off = win_a.logical_not().float()
    if horizontal:
        qwx, qwy, qlx, qly = xs + off, ys, xs + (1.0 - off), ys
    else:
        qwx, qwy, qlx, qly = xs, ys + off, xs, ys + (1.0 - off)

    def edges(qx, qy):
        # e_i inside-positive through the area's sign; pairs (1,2), (2,0),
        # (0,1) as the barycentrics' e0, e1, e2.
        e = torch.stack([
            (p[..., i2, 0] - p[..., i1, 0]) * (qy - p[..., i1, 1])
            - (p[..., i2, 1] - p[..., i1, 1]) * (qx - p[..., i1, 0])
            for i1, i2 in ((1, 2), (2, 0), (0, 1))], dim=-1)
        area = e.sum(-1, keepdim=True)
        return e * torch.where(area >= 0, 1.0, -1.0)

    # Each edge is owned by one pair orientation: mostly-vertical edges
    # (|dy| >= |dx|) by horizontal pairs, the others by vertical pairs.
    dxy = (p[..., (2, 0, 1), :] - p[..., (1, 2, 0), :]).abs()
    owned = dxy[..., 1] >= dxy[..., 0] if horizontal else dxy[..., 0] > dxy[..., 1]

    e_w = edges(qwx, qwy)
    e_l = edges(qlx, qly)
    # Crossing of each exiting edge along winner -> loser; the first exit wins.
    crossing = (e_w >= 0) & (e_l < 0) & owned
    t_i = e_w / clamp_tie(e_w - e_l, 1e-12)
    t = torch.where(crossing, t_i, torch.full_like(t_i, 2.0)).amin(-1)
    has = crossing.any(-1) & pair
    # t = 1/2 is the fixed point (no blend either way): pairs that are not
    # silhouettes or have no crossing land exactly there.
    t = clamp_tie(torch.where(has, t, torch.full_like(t, 0.5)), 0.0, 1.0)

    c_a, c_b = color[sl_a], color[sl_b]
    wa = win_a[..., None]
    c_w = torch.where(wa, c_a, c_b)
    c_l = torch.where(wa, c_b, c_a)
    w_l = clamp_tie(t - 0.5, 0.0)[..., None]   # the winner spills past the middle
    w_w = clamp_tie(0.5 - t, 0.0)[..., None]   # the winner retreats
    adj_w = w_w * (c_l - c_w)
    adj_l = w_l * (c_w - c_l)
    adj_a = torch.where(wa, adj_w, adj_l)
    adj_b = torch.where(wa, adj_l, adj_w)
    if horizontal:
        return F.pad(adj_a, (0, 0, 0, 1)) + F.pad(adj_b, (0, 0, 1, 0))
    return F.pad(adj_a, (0, 0, 0, 0, 0, 1)) + F.pad(adj_b, (0, 0, 0, 0, 1, 0))


def antialias(color: torch.Tensor, rast: RastOut, v_clip: torch.Tensor, faces: torch.Tensor,
              width: int, height: int, z_eps: float = 1e-3) -> torch.Tensor:
    """Analytic silhouette-edge antialiasing (nvdiffrast ``antialias``).

    For every horizontally or vertically adjacent pixel pair whose triangle
    ids differ at a silhouette, the closer triangle's exiting edge is
    intersected with the segment between the two pixel centres; the
    crossing parameter t (0 at the winner's centre, 1 at the loser's) gives
    the blend: t > 1/2 blends the winner's colour into the loser pixel with
    weight t - 1/2, t < 1/2 the loser's colour into the winner pixel with
    weight 1/2 - t. The selection (ids, winner, crossings) carries no
    gradient; t and the colours do, so gradients reach the occluding
    geometry through its silhouettes.
    """
    xy, _, _ = _screen_coords(v_clip, width, height)
    faces = faces.long()
    args = (color, rast.tri_id, rast.zbuf, rast.mask, xy, faces)
    return (color + _aa_axis(*args, horizontal=True, z_eps=z_eps)
            + _aa_axis(*args, horizontal=False, z_eps=z_eps))


def scale_img(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize [..., H, W, C] -> [..., h, w, C] with a triangle
    filter that widens when shrinking (``jax.image.resize(..., "bilinear")``)."""
    lead, (hi, wi, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, hi, wi, c).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, c)
