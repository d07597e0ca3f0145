"""Differentiable Gaussian-splat rendering: projection + binning + tile kernels.

Port of ``dreamgaussian_tpu/ops/rasterize.py``. :func:`render_gaussians`
is the entry point. The 2D-mean gradient tap for densification is the
explicit ``mean2d_tap`` input, as in the JAX package.

The compositing core is a ``torch.autograd.Function`` whose forward
gathers per-gaussian feature columns into the chunk-aligned duplicate
layout and runs K1, and whose backward runs K2 and reduces the
per-duplicate gradients to per-gaussian ones with ``index_add_`` over the
duplicate map. The projection math before it is ordinary autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from .binning import TILE, bin_gaussians
from .clamp import clamp_tie
from .project import project_gaussians
from .rasterize_cuda import (
    FEAT_ROWS,
    OUT_CH,
    Q_SENTINEL,
    REAL_FEAT_ROWS,
    composite_backward,
    composite_forward,
)


CHUNK = 128  # gaussians per staged chunk of a tile's list (kernel MAX_CHUNK)


class GaussianRender(NamedTuple):
    image: torch.Tensor     # [H, W, 3] (bg-blended, clamped to [0,1])
    depth: torch.Tensor     # [H, W]
    alpha: torch.Tensor     # [H, W]
    radii: torch.Tensor     # [N] int32 (0 => culled/invisible)
    overflow: torch.Tensor  # [] int32 dropped binning duplicates (always 0)


class _CompositeCols(torch.autograd.Function):
    """Duplicate gather + K1 forward; K2 + per-gaussian reduction backward.

    Composites the ``tile_count`` tiles of the frame from ``tile_start`` on:
    ``chunk_starts`` and ``n_chunks`` are sliced to them and K1/K2 take
    ``tile_start`` as their tile offset, while ``dup_feat`` stays whole (the
    slab's chunk starts index into it). With a ``group`` (the tile axis of a
    tile-sharded render) the per-gaussian gradient of the slab is a partial
    sum; one all-reduce over the group completes it."""

    @staticmethod
    def forward(ctx, feat_cols, dup_map, chunk_starts, n_chunks, grid_x,
                tile_start, tile_count, chunk, tile, group):
        cs = chunk_starts[tile_start:tile_start + tile_count].contiguous()
        nc = n_chunks[tile_start:tile_start + tile_count].contiguous()
        dup_feat = feat_cols.index_select(1, dup_map)
        out = composite_forward(dup_feat, cs, nc, grid_x=grid_x, num_tiles=tile_count,
                                chunk=chunk, tile=tile, tile_offset=tile_start)
        ctx.save_for_backward(dup_feat, dup_map, cs, nc, out)
        ctx.geometry = (grid_x, tile_start, tile_count, chunk, tile, feat_cols.shape[1])
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g_out):
        dup_feat, dup_map, cs, nc, out = ctx.saved_tensors
        grid_x, tile_start, tile_count, chunk, tile, cols = ctx.geometry
        d_feat = composite_backward(
            dup_feat, cs, nc, out, g_out.contiguous(), grid_x=grid_x,
            num_tiles=tile_count, chunk=chunk, tile=tile, tile_offset=tile_start,
        )
        g_cols = torch.zeros((FEAT_ROWS, cols), dtype=d_feat.dtype, device=d_feat.device)
        g_cols[:REAL_FEAT_ROWS].index_add_(1, dup_map, d_feat[:REAL_FEAT_ROWS])
        g_cols[:, cols - 1] = 0.0    # the sentinel column is a constant
        if ctx.group is not None:
            import torch.distributed as dist

            dist.all_reduce(g_cols, group=ctx.group)
        return g_cols, None, None, None, None, None, None, None, None, None


def build_feature_cols(mean2d, depth, conic, color, opacity):
    """Raw per-gaussian feature rows [FEAT_ROWS, N+1] for the kernels.

    Rows: mean2d, conic, LOG-opacity, colours, depth, zero padding.
    Column N is the inert sentinel that padding slots read
    (log_opacity = -1e10 => alpha exactly 0, no NaNs).
    """
    n = mean2d.shape[0]
    log_op = torch.log(torch.clamp_min(opacity.float(), 1e-30)).reshape(1, n)
    rows = torch.cat([
        mean2d.T.float(), conic.T.float(), log_op, color.T.float(),
        depth.reshape(1, n).float(),
    ], dim=0)
    feat_cols = torch.nn.functional.pad(rows, (0, 1, 0, FEAT_ROWS - rows.shape[0]))
    sentinel = torch.zeros_like(feat_cols)
    sentinel[5, n] = Q_SENTINEL
    return feat_cols + sentinel


def composite_tiles(mean2d, depth, conic, color, opacity, radius, width: int,
                    height: int, tile: int = TILE, tile_start: int = 0,
                    tile_count: int | None = None, group=None):
    """Bin already-projected gaussians over the whole frame and composite the
    ``tile_count`` tiles from ``tile_start`` on (all of them by default).

    Returns (tiles [tile_count, OUT_CH, tile^2] channel-planar, overflow[]
    int32). ``group``: the process group whose ranks composite the frame's
    other tiles (see ``_CompositeCols``); None when this call renders alone.
    """
    if width % tile or height % tile:
        raise ValueError(f"image size must be {tile}-aligned, got {width}x{height}")
    grid_x = width // tile
    num_tiles = grid_x * (height // tile)
    if tile_count is None:
        tile_count = num_tiles - tile_start
    if not (0 <= tile_start and 0 < tile_count and tile_start + tile_count <= num_tiles):
        raise ValueError(f"tiles {tile_start}..{tile_start + tile_count} outside the "
                         f"frame's {num_tiles}")
    bins = bin_gaussians(
        mean2d.detach(), depth.detach(), radius, width, height, chunk=CHUNK,
        tile=tile, conic=conic.detach(),
        log_opacity=torch.log(torch.clamp_min(opacity.detach().float(), 1e-30)),
    )
    feat_cols = build_feature_cols(mean2d, depth, conic, color, opacity)
    out = _CompositeCols.apply(feat_cols, bins.dup_map, bins.chunk_starts, bins.n_chunks,
                               grid_x, tile_start, tile_count, CHUNK, tile, group)
    return out, bins.overflow


def tiles_to_image(out, width: int, height: int, tile: int, bg):
    """The frame's tiles [T, OUT_CH, tile^2] -> (image[H,W,3] on ``bg``
    without clamp, depth[H,W], alpha[H,W])."""
    grid_x, grid_y = width // tile, height // tile
    hw = out.reshape(grid_y, grid_x, OUT_CH, tile, tile)
    hw = hw.permute(0, 3, 1, 4, 2).reshape(height, width, OUT_CH)
    t_final = hw[..., 4]
    image = hw[..., 0:3] + t_final[..., None] * bg[None, None, :]
    return image, hw[..., 3], 1.0 - t_final


def rasterize_projected(mean2d, depth, conic, color, opacity, radius,
                        width: int, height: int, bg, tile: int = TILE):
    """Composite already-projected gaussians into an image.

    ``tile``: screen-tile edge in pixels; 16 reproduces the CUDA
    reference's tile-rect culling, 32 is the trainer's choice.

    Returns (image[H,W,3] without clamp, depth[H,W], alpha[H,W],
    overflow[] int32).
    """
    out, overflow = composite_tiles(mean2d, depth, conic, color, opacity, radius,
                                    width, height, tile=tile)
    return (*tiles_to_image(out, width, height, tile, bg), overflow)


def render_gaussians(
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
    bg: torch.Tensor,
    sh_degree: int = 0,
    alive: torch.Tensor | None = None,
    mean2d_tap: torch.Tensor | None = None,
    tile: int = TILE,
    device: str | torch.device = "cuda",
) -> GaussianRender:
    """Render a gaussian cloud through one camera (activated parameters).

    ``mean2d_tap``: optional [N,2] zeros; its gradient is dL/d(pixel
    mean2d), used by the density controller (scale by (W/2, H/2) for the
    NDC-halved units the reference thresholds on). Every tensor must lie
    on ``device``.
    """
    dev = resolve_device(device)
    if xyz.device.type != dev.type:
        raise ValueError(f"render_gaussians(device={dev}) got tensors on {xyz.device}")
    proj = project_gaussians(
        xyz, scale, quat, opacity, shs, view, full_proj, campos, tanfov,
        width, height, sh_degree=sh_degree, alive=alive,
    )
    mean2d = proj.mean2d if mean2d_tap is None else proj.mean2d + mean2d_tap
    image, dep, alpha, overflow = rasterize_projected(
        mean2d, proj.depth, proj.conic, proj.color, proj.opacity, proj.radius,
        width, height, bg, tile=tile,
    )
    return GaussianRender(
        image=clamp_tie(image, 0.0, 1.0), depth=dep, alpha=alpha,
        radii=proj.radius, overflow=overflow,
    )
