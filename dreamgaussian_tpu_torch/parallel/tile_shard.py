"""Tile-sharded rendering: the sequence-parallel axis of this workload.

Port of ``dreamgaussian_tpu/parallel/tile_shard.py``. The tile grid of one
render is sharded over the ranks of a mesh's ``tile`` axis:

- projection and binning run replicated (every rank of the tile group
  holds the same cloud and camera);
- each rank composites its contiguous slab of tile rows, with K1 and K2
  told the slab's first tile (``tile_offset``);
- the slabs are gathered into the full image, which every rank then holds;
- backward: the gather hands each rank its own slab of the image's
  cotangent (every rank computes the same loss from the gathered image, so
  the cotangent is the same on all of them and is not summed); K2 gives the
  gradients of the slab's duplicates, and their reduction to per-gaussian
  gradients is a partial sum, completed by ONE all-reduce over the tile
  group (``ops/rasterize._CompositeCols``). The projection's backward then
  runs on the full gradient, alike on every rank.

The gather is an all-reduce of each rank's slab written into a zeroed full
buffer: exact (a sum with zeros), and a collective that gloo runs on CUDA
tensors as well as NCCL does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.binning import TILE
from ..ops.clamp import clamp_tie
from ..ops.project import project_gaussians
from ..ops.rasterize import GaussianRender, composite_tiles, tiles_to_image
from .multihost import Axis, Mesh2D


class _GatherSlabs(torch.autograd.Function):
    """[tiles_per, C, P] slab of rank ``index`` -> [size * tiles_per, C, P];
    backward returns this rank's slab of the cotangent, once."""

    @staticmethod
    def forward(ctx, local, axis: Axis):
        n = local.shape[0]
        full = local.new_zeros((axis.size * n,) + tuple(local.shape[1:]))
        full[axis.index * n:(axis.index + 1) * n] = local
        if axis.size > 1:
            dist.all_reduce(full, group=axis.group)
        ctx.slab = (axis.index * n, (axis.index + 1) * n)
        return full

    @staticmethod
    def backward(ctx, g_full):
        lo, hi = ctx.slab
        return g_full[lo:hi], None


def rasterize_projected_tile_sharded(mean2d, depth, conic, color, opacity, radius,
                                     width: int, height: int, bg, axis: Axis,
                                     tile: int = TILE):
    """``ops.rasterize.rasterize_projected`` with the tile rows sharded over
    ``axis`` (a mesh's tile axis). All inputs are replicated over the axis;
    the returned image, depth and alpha are the full frame's, on every rank.
    """
    if width % tile or height % tile:
        raise ValueError(f"image size must be {tile}-aligned, got {width}x{height}")
    grid_x, grid_y = width // tile, height // tile
    if grid_y % axis.size:
        raise ValueError(f"tile rows {grid_y} must divide over {axis.size} shards")
    tiles_per = (grid_y // axis.size) * grid_x
    local, overflow = composite_tiles(
        mean2d, depth, conic, color, opacity, radius, width, height, tile=tile,
        tile_start=axis.index * tiles_per, tile_count=tiles_per, group=axis.group,
    )
    out = _GatherSlabs.apply(local, axis)
    # Binning is replicated: overflow is the same global count on every rank.
    return (*tiles_to_image(out, width, height, tile, bg), overflow)


def render_gaussians_tile_sharded(xyz, scale, quat, opacity, shs, view, full_proj, campos,
                                  tanfov, width: int, height: int, bg, axis: Axis,
                                  sh_degree: int = 0, alive=None, mean2d_tap=None,
                                  tile: int = TILE) -> GaussianRender:
    """``ops.rasterize.render_gaussians`` with the tiles sharded over ``axis``
    (every tensor on this rank's device)."""
    proj = project_gaussians(
        xyz, scale, quat, opacity, shs, view, full_proj, campos, tanfov,
        width, height, sh_degree=sh_degree, alive=alive,
    )
    mean2d = proj.mean2d if mean2d_tap is None else proj.mean2d + mean2d_tap
    image, dep, alpha, overflow = rasterize_projected_tile_sharded(
        mean2d, proj.depth, proj.conic, proj.color, proj.opacity, proj.radius,
        width, height, bg, axis, tile=tile,
    )
    return GaussianRender(image=clamp_tie(image, 0.0, 1.0), depth=dep, alpha=alpha,
                          radii=proj.radius, overflow=overflow)


def make_tile_sharded_render(mesh: Mesh2D, width: int, height: int, sh_degree: int = 0,
                             tile: int = 32):
    """A render over ``mesh``'s tile axis: activated parameters and camera
    in, the full image out (white background), as JAX's
    ``make_tile_sharded_render``."""

    def fn(xyz, scale, quat, opacity, shs, view, full_proj, campos, tanfov):
        out = render_gaussians_tile_sharded(
            xyz, scale, quat, opacity, shs, view, full_proj, campos, tanfov, width, height,
            torch.ones(3, device=xyz.device), mesh.tile, sh_degree=sh_degree, tile=tile,
        )
        return out.image

    return fn
