"""Tile binning for the Gaussian and triangle rasterizers (plain torch ops).

Port of ``dreamgaussian_tpu/ops/binning.py`` in the CUDA reference's
design, without the static slot classes that XLA's fixed shapes needed:

1. depth pre-sort of the gaussians (index tie-break) -> depth rank;
2. each visible gaussian's tile rect, and its cell count;
3. ``repeat_interleave`` into one (gaussian, tile) pair per rect cell,
   with the exact ellipse-vs-tile cull marking pairs that cannot reach
   alpha 1/255 anywhere in the tile;
4. one ``torch.sort`` over the int64 key ``tile * N + depth_rank``
   (culled pairs get tile ``T`` and sort last);
5. per-tile counts and a chunk-aligned layout: every tile's list is
   padded to a multiple of ``chunk`` and the lists lie back to back, the
   compositing kernels' input layout.

One host read per render, of the rect-cell total, sizes the pair arrays
(as the CUDA reference reads its duplicate count). Binning is exact:
nothing is dropped, so ``overflow`` is always 0.

``bin_rects`` bins any elements with integer tile rects in index order
(the mesh rasterizer's triangles) through the same expansion, sort and
layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16  # default tile size (CUDA-parity); the trainer passes 32


class BinnedTiles(NamedTuple):
    """Chunk-aligned per-tile gaussian lists.

    dup_map: [K] int64 gaussian index per slot (N = padding sentinel). K
        bounds the aligned length: slots past the last tile's range are
        padding too.
    chunk_starts: [T] int32 first chunk index of each tile.
    n_chunks: [T] int32 chunk count of each tile.
    num_dups: [] int64 total real (unpadded) duplicates.
    overflow: [] int32 dropped duplicates; always 0 (exact binning).
    """

    dup_map: torch.Tensor
    chunk_starts: torch.Tensor
    n_chunks: torch.Tensor
    num_dups: torch.Tensor
    overflow: torch.Tensor


def ellipse_tile_keep(lx, hx, ly, hy, ca, cb, cc, q_budget):
    """Exact ellipse-vs-tile cull test (output-invariant pair dropping).

    Keeps a pair unless the minimum of ``q = ca*dx^2 + 2*cb*dx*dy +
    cc*dy^2`` over the tile's pixel rect ``dx in [lx,hx], dy in [ly,hy]``
    exceeds ``q_budget = 2*(log_op - log(1/255))``: such pairs have alpha
    below 1/255 at every pixel and the compositor skips them anyway.
    Non-PSD conics are never culled.
    """
    inside_x = (lx <= 0.0) & (hx >= 0.0)
    inside_y = (ly <= 0.0) & (hy >= 0.0)
    safe_a = torch.where(ca > 0.0, ca, torch.ones_like(ca))
    safe_c = torch.where(cc > 0.0, cc, torch.ones_like(cc))

    def edge_x(ex):
        dy = torch.minimum(torch.maximum(-cb * ex / safe_c, ly), hy)
        return (ca * ex + 2.0 * cb * dy) * ex + cc * dy * dy

    def edge_y(ey):
        dx = torch.minimum(torch.maximum(-cb * ey / safe_a, lx), hx)
        return (cc * ey + 2.0 * cb * dx) * ey + ca * dx * dx

    q_min = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)),
    )
    q_min = torch.where(inside_x & inside_y, torch.zeros_like(q_min), q_min)
    psd = (ca > 0.0) & (cc > 0.0) & (ca * cc - cb * cb >= 0.0)
    return ~psd | (q_min <= q_budget)


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor, width: int,
              height: int, tile: int = TILE):
    """Integer tile rect [min, max) per gaussian (matches CUDA getRect)."""
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    r = radius.to(mean2d.dtype)
    xmin = torch.clamp(((mean2d[:, 0] - r) / tile).to(torch.int32), 0, grid_x)
    ymin = torch.clamp(((mean2d[:, 1] - r) / tile).to(torch.int32), 0, grid_y)
    xmax = torch.clamp(((mean2d[:, 0] + r + tile - 1) / tile).to(torch.int32), 0, grid_x)
    ymax = torch.clamp(((mean2d[:, 1] + r + tile - 1) / tile).to(torch.int32), 0, grid_y)
    return xmin, ymin, xmax, ymax


@torch.no_grad()
def bin_gaussians(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    width: int,
    height: int,
    chunk: int = 128,
    tile: int = TILE,
    conic: torch.Tensor | None = None,
    log_opacity: torch.Tensor | None = None,
) -> BinnedTiles:
    """Bin projected gaussians into chunk-aligned per-tile depth-sorted lists.

    With ``conic`` [N,3] and ``log_opacity`` [N] given, (gaussian, tile)
    pairs whose peak alpha over the tile is provably < 1/255 are dropped
    (see ellipse_tile_keep).
    """
    dev = mean2d.device
    n = mean2d.shape[0]
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    num_tiles = grid_x * grid_y

    # Depth pre-sort: a stable sort keeps the index tie-break; culled
    # gaussians sort last via +inf depth.
    valid_g = radius > 0
    dkey = torch.where(valid_g, depth.float(), torch.full_like(depth, math.inf, dtype=torch.float32))
    order = torch.sort(dkey, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int64, device=dev)

    xmin, ymin, xmax, ymax = tile_rect(mean2d, radius, width, height, tile)
    gid, tx, ty = _expand_rects(xmin, ymin, xmax, ymax, valid_g)
    tile_id = ty * grid_x + tx

    if conic is not None and log_opacity is not None:
        m = mean2d.float()[gid]
        c = conic.float()[gid]
        q_budget = 2.0 * (log_opacity.float()[gid] - math.log(1.0 / 255.0)) + 1e-3
        lx = tx.float() * tile - m[:, 0]
        ly = ty.float() * tile - m[:, 1]
        keep = ellipse_tile_keep(lx, lx + (tile - 1), ly, ly + (tile - 1),
                                 c[:, 0], c[:, 1], c[:, 2], q_budget)
        tile_id = torch.where(keep, tile_id, torch.full_like(tile_id, num_tiles))

    return _aligned_lists(tile_id, gid, rank[gid], n, num_tiles, chunk)


def _expand_rects(xmin, ymin, xmax, ymax, valid):
    """One (element, tile) pair per cell of each valid element's rect
    [min, max): (element index [P], tile x [P], tile y [P]), int64. Reads
    the pair total back to the host, the one read of a binning call."""
    dev = xmin.device
    n = xmin.shape[0]
    rect_w = (xmax - xmin).to(torch.int64)
    cells = torch.where(valid, rect_w * (ymax - ymin).to(torch.int64),
                        torch.zeros_like(rect_w))
    total = int(cells.sum())                      # the one host read
    gid = torch.repeat_interleave(torch.arange(n, device=dev), cells,
                                  output_size=total)
    first = torch.cumsum(cells, 0) - cells
    local = torch.arange(total, device=dev) - first[gid]
    w_g = torch.clamp_min(rect_w[gid], 1)
    ty = ymin[gid].to(torch.int64) + local // w_g
    tx = xmin[gid].to(torch.int64) + local % w_g
    return gid, tx, ty


def _aligned_lists(tile_id, gid, rank, n: int, num_tiles: int, chunk: int) -> BinnedTiles:
    """Sort pairs by (tile, rank) and lay the per-tile lists out chunk
    aligned. ``tile_id == num_tiles`` marks a culled pair; ``rank`` < n."""
    dev = tile_id.device
    total = tile_id.shape[0]
    key = tile_id * n + rank
    skey, perm = torch.sort(key)
    s_tile = skey // n
    s_gid = gid[perm]

    # Per-tile counts from the sorted tiles (bincount would read the max
    # back to the host).
    bounds = torch.searchsorted(s_tile, torch.arange(num_tiles + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    aligned = (counts + chunk - 1) // chunk * chunk
    astart = torch.cumsum(aligned, 0) - aligned
    ustart = torch.cumsum(counts, 0) - counts
    # Bound on the aligned length: every tile pads fewer than `chunk` slots.
    k_cap = total + num_tiles * chunk
    real = s_tile < num_tiles
    t_safe = torch.clamp_max(s_tile, num_tiles - 1)
    pos = astart[t_safe] + torch.arange(total, device=dev) - ustart[t_safe]
    pos = torch.where(real, pos, torch.full_like(pos, k_cap))
    dup_map = torch.full((k_cap + 1,), n, dtype=torch.int64, device=dev)
    dup_map[pos] = s_gid
    return BinnedTiles(
        dup_map=dup_map[:k_cap],
        chunk_starts=(astart // chunk).to(torch.int32),
        n_chunks=(aligned // chunk).to(torch.int32),
        num_dups=counts.sum(),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def bin_rects(xmin, ymin, xmax, ymax, valid, *, grid_x: int, num_tiles: int,
              chunk: int = 128) -> BinnedTiles:
    """Bin elements by their integer tile rects [min, max) into chunk-aligned
    per-tile lists in element-index order (the mesh rasterizer's triangle
    binning). ``valid`` [F] bool drops elements. Nothing is truncated: an
    element reaches every tile of its rect.
    """
    gid, tx, ty = _expand_rects(xmin, ymin, xmax, ymax, valid)
    return _aligned_lists(ty * grid_x + tx, gid, gid, xmin.shape[0], num_tiles, chunk)
