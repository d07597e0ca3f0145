"""Inverse grid-sample: scatter values into 2D/3D grids (texture baking).

Port of ``dreamgaussian_tpu/ops/grid_put.py``: nearest/bilinear/trilinear
scatter-add with counts, the mipmap variants that fill texels unseen at
full resolution from coarser levels, and the ``grid_put`` mode dispatcher.
The 2D bilinear path carries the stage-1 texture bake; ``knn_inpaint``
fills on the host what no view ever saw.

Every scatter is one ``index_add_`` on the flat grid (atomic adds on the
card, so sums of many taps on one texel may differ in the last bits from
run to run). The coarse levels of the mipmap variants are upsampled with
``F.interpolate(mode="bilinear"/"trilinear", align_corners=False)``,
which equals ``jax.image.resize`` when upsampling.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _scatter_add(shape, idx, values, wgt):
    """Flat scatter: accum[idx] += values * wgt, count[idx] += wgt."""
    c = values.shape[-1]
    size = int(np.prod(shape))
    accum = torch.zeros((size, c), dtype=values.dtype, device=values.device)
    count = torch.zeros((size,), dtype=values.dtype, device=values.device)
    accum.index_add_(0, idx, values * wgt[:, None])
    count.index_add_(0, idx, wgt)
    return accum, count


def _bilinear_scatter(h: int, w: int, coords, values, weights=None):
    """Scatter values [N, C] at coords [N, 2] in [-1, 1] (xy order: x -> W
    axis, y -> H axis) -> (accum [H, W, C], count [H, W]).

    ``weights`` [N] scales every tap of a point; a weight of 0 is an exact
    no-op, so callers can scatter a fixed point set under a mask.
    """
    x = (coords[:, 0] * 0.5 + 0.5) * (w - 1)
    y = (coords[:, 1] * 0.5 + 0.5) * (h - 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    idx, wgt = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            tap = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            if weights is not None:
                tap = tap * weights
            xi = torch.clamp(x0 + dx, 0, w - 1)
            yi = torch.clamp(y0 + dy, 0, h - 1)
            idx.append(yi * w + xi)
            wgt.append(tap)
    accum, count = _scatter_add((h, w), torch.cat(idx), values.repeat(4, 1), torch.cat(wgt))
    return accum.reshape(h, w, -1), count.reshape(h, w)


def _normalized(accum, count):
    return accum / torch.clamp_min(count[..., None], 1e-10)


def linear_grid_put_2d(h: int, w: int, coords, values, return_count=False,
                       weights=None):
    """Bilinear scatter. With return_count: RAW (sum [H,W,C], count [H,W]),
    the accumulate-across-views contract. Otherwise the normalized mean."""
    accum, count = _bilinear_scatter(h, w, coords, values, weights)
    if return_count:
        return accum, count
    return _normalized(accum, count)


def _upsample(grid, size):
    """Channel-last grid [*dims, C] -> [*size, C], half-pixel-centre linear."""
    mode = "bilinear" if len(size) == 2 else "trilinear"
    nd = len(size)
    x = grid.permute(nd, *range(nd))[None]
    x = F.interpolate(x, size=tuple(size), mode=mode, align_corners=False)
    return x[0].permute(*range(1, nd + 1), 0)


def mipmap_linear_grid_put_2d(
    h: int,
    w: int,
    coords,
    values,
    min_resolution: int = 128,
    return_count: bool = False,
    weights=None,
):
    """Bilinear scatter with coarse-to-fine hole filling: texels unseen at
    full resolution take the (upsampled) raw sums of the first coarser mip
    that saw them. Every level runs (no host read per level); the hole mask
    makes coarser levels no-ops for texels already seen. With return_count:
    raw (sum, count); else the normalized mean."""
    result = torch.zeros((h, w, values.shape[-1]), dtype=values.dtype, device=values.device)
    count = torch.zeros((h, w), dtype=values.dtype, device=values.device)
    cur_h, cur_w = h, w
    while min(cur_h, cur_w) > min_resolution:
        grid, cnt = _bilinear_scatter(cur_h, cur_w, coords, values, weights)
        if (cur_h, cur_w) != (h, w):
            grid = _upsample(grid, (h, w))
            cnt = _upsample(cnt[..., None], (h, w))[..., 0]
        hole = count == 0
        result = torch.where(hole[..., None], result + grid, result)
        count = torch.where(hole, count + cnt, count)
        cur_h //= 2
        cur_w //= 2
    if return_count:
        return result, count
    return _normalized(result, count)


def _nearest_index(coords, dims):
    """Row-major flat index of the nearest cell; coord dim i -> grid dim i."""
    flat = torch.zeros(coords.shape[0], dtype=torch.long, device=coords.device)
    for axis, dim in enumerate(dims):
        i = torch.round((coords[:, axis] * 0.5 + 0.5) * (dim - 1)).long()
        flat = flat * dim + torch.clamp(i, 0, dim - 1)
    return flat


def _nearest_grid_put(dims, coords, values, return_count):
    accum, count = _scatter_add(dims, _nearest_index(coords, dims), values,
                                torch.ones_like(values[:, 0]))
    accum = accum.reshape(*dims, -1)
    count = count.reshape(*dims)
    if return_count:
        return accum, count
    return _normalized(accum, count)


def nearest_grid_put_2d(h: int, w: int, coords, values, return_count=False):
    """Nearest-cell scatter. Coord dim i -> grid dim i ((h, w) order); the
    bilinear 2D functions take (x, y) order instead."""
    return _nearest_grid_put((h, w), coords, values, return_count)


def nearest_grid_put_3d(h: int, w: int, d: int, coords, values,
                        return_count=False):
    """Nearest-cell 3D scatter."""
    return _nearest_grid_put((h, w, d), coords, values, return_count)


def _trilinear_scatter(h: int, w: int, d: int, coords, values):
    """Scatter values [N, C] at coords [N, 3] in [-1, 1] ((h, w, d) axis
    order) -> (accum [H,W,D,C], count [H,W,D]).

    The base corner is clamped to dim-2 BEFORE the fractions are taken, so
    the +1 corner never clamps and edge samples put full weight on the last
    cell.
    """
    dims = (h, w, d)
    fs, base = [], []
    for axis, dim in enumerate(dims):
        pos = (coords[:, axis] * 0.5 + 0.5) * (dim - 1)
        i0 = torch.clamp(torch.floor(pos).long(), 0, dim - 2)
        base.append(i0)
        fs.append(pos - i0.to(values.dtype))
    idx, wgt = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt.append(
                    (fs[0] if dz else 1 - fs[0])
                    * (fs[1] if dy else 1 - fs[1])
                    * (fs[2] if dx else 1 - fs[2])
                )
                idx.append(((base[0] + dz) * w + (base[1] + dy)) * d + (base[2] + dx))
    accum, count = _scatter_add(dims, torch.cat(idx), values.repeat(8, 1), torch.cat(wgt))
    return accum.reshape(h, w, d, -1), count.reshape(h, w, d)


def linear_grid_put_3d(h: int, w: int, d: int, coords, values,
                       return_count=False):
    """Trilinear scatter."""
    accum, count = _trilinear_scatter(h, w, d, coords, values)
    if return_count:
        return accum, count
    return _normalized(accum, count)


def mipmap_linear_grid_put_3d(
    h: int,
    w: int,
    d: int,
    coords,
    values,
    min_resolution: int = 32,
    return_count: bool = False,
):
    """Trilinear scatter with coarse-to-fine hole filling; every level runs,
    as in the 2D variant."""
    result = torch.zeros((h, w, d, values.shape[-1]), dtype=values.dtype, device=values.device)
    count = torch.zeros((h, w, d), dtype=values.dtype, device=values.device)
    cur = [h, w, d]
    while min(cur) > min_resolution:
        grid, cnt = _trilinear_scatter(*cur, coords, values)
        if tuple(cur) != (h, w, d):
            grid = _upsample(grid, (h, w, d))
            cnt = _upsample(cnt[..., None], (h, w, d))[..., 0]
        hole = count == 0
        result = torch.where(hole[..., None], result + grid, result)
        count = torch.where(hole, count + cnt, count)
        cur = [m // 2 for m in cur]
    if return_count:
        return result, count
    return _normalized(result, count)


def grid_put(shape, coords, values, mode: str = "linear-mipmap",
             min_resolution: int = 32, return_raw: bool = False):
    """Mode dispatcher.

    shape: (H, W) or (H, W, D); coords [N, len(shape)] in [-1, 1] with
    coord dim i -> grid dim i; values [N, C]. mode in {nearest, linear,
    linear-mipmap}. The bilinear-2D functions take (x, y) order, so the 2D
    linear paths swap here.
    """
    dim = len(shape)
    if dim not in (2, 3):
        raise ValueError(f"only 2D/3D grids supported, got {dim}D")
    if mode == "nearest":
        fn = nearest_grid_put_2d if dim == 2 else nearest_grid_put_3d
        return fn(*shape, coords, values, return_count=return_raw)
    if mode == "linear":
        if dim == 2:
            return linear_grid_put_2d(*shape, coords.flip(1), values,
                                      return_count=return_raw)
        return linear_grid_put_3d(*shape, coords, values,
                                  return_count=return_raw)
    if mode == "linear-mipmap":
        if dim == 2:
            return mipmap_linear_grid_put_2d(
                *shape, coords.flip(1), values,
                min_resolution=min_resolution, return_count=return_raw,
            )
        return mipmap_linear_grid_put_3d(
            *shape, coords, values, min_resolution=min_resolution,
            return_count=return_raw,
        )
    raise ValueError(f"unknown grid_put mode {mode!r}")


def knn_inpaint(grid: np.ndarray, mask: np.ndarray, k: int = 1) -> np.ndarray:
    """Fill texels where ``mask`` is False from the nearest True texel
    (host-side, scipy kd-tree)."""
    from scipy.spatial import cKDTree

    grid = np.asarray(grid)
    mask = np.asarray(mask).astype(bool)
    if mask.all() or not mask.any():
        return grid
    seen = np.argwhere(mask)
    unseen = np.argwhere(~mask)
    _, idx = cKDTree(seen).query(unseen, k=k)
    src = seen[idx]
    out = grid.copy()
    if k == 1:
        out[unseen[:, 0], unseen[:, 1]] = grid[src[:, 0], src[:, 1]]
    else:
        out[unseen[:, 0], unseen[:, 1]] = grid[src[..., 0], src[..., 1]].mean(axis=1)
    return out
