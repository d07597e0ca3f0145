"""Triangle z-test kernel K3 with its plain PyTorch version.

The CUDA kernel (``csrc/ztest.cu``) replaces
``dreamgaussian_tpu/ops/mesh_raster_pallas.py``'s ``_ztest_kernel``: per
pixel of a screen tile, the nearest (smallest NDC depth) covering triangle
of the tile's binned list. It only picks winners and has no gradient; the
differentiable barycentrics are re-derived from the winner ids in
``mesh_raster.rasterize``. The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Feature row layout (ROWS x K, f32, K minor):
  0 x0, 1 y0, 2 x1, 3 y1, 4 x2, 5 y2  (screen-pixel coords)
  6 z0, 7 z1, 8 z2                    (NDC depth, screen-affine)
  9 tri_id+1 (as f32, exact below 2^24; 0 = padding slot)
  10..15 zero.

Output: ``(tri_id [T, PIX] int32, z [T, PIX] float32)``; ``tri_id`` is the
face index + 1 (0 = miss) and ``z`` is 0 on a miss. (The TPU kernel packs
both as float32 channels of one ``[T, PIX, 8]`` array, which its compiler
needs; two planes of their own types serve the card better.)

Rules, in both versions: edge functions at the pixel centre, either
winding, ``area != 0``; a centre exactly on an edge is inside; ``1/area``
then multiply; ``z = b0*z0 + b1*z1 + b2*z2`` left to right. Within a chunk
of a tile's list equal z goes to the larger id (and a NaN z of a covering
triangle makes the chunk's minimum NaN, so the pixel takes nothing from
that chunk); across chunks only a strictly smaller z replaces the winner.
None of this depends on the order of the ids within a chunk.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

ROWS = 16
REAL_ROWS = 10
BIG = 3.4e38
MAX_CHUNK = 128            # shared-memory staging size of the kernel

# Kernel launches, counted by the wrapper where it launches.
LAUNCHES = {"ztest": 0}
# Blocks of the kernel's last launch: the grid the library gave the launch.
LAST_GRID = {"ztest": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# feat, k_total, chunk_starts, n_chunks, out_id, out_z, part, done,
# num_tiles, grid_x, chunk, tile, stream, blocks_launched
_ARGTYPES = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
             ctypes.POINTER(_I)]


def _pixel_centres(num_tiles, grid_x, tile, device):
    """Absolute pixel coordinates of every tile's pixels: (px, py) [T, PIX, 1]."""
    tid = torch.arange(num_tiles, device=device)
    pid = torch.arange(tile * tile, device=device)
    ty = tid // grid_x
    tx = tid - ty * grid_x
    px = (tx[:, None] * tile + pid[None, :] % tile).float()[:, :, None]
    py = (ty[:, None] * tile + pid[None, :] // tile).float()[:, :, None]
    return px, py


def _chunk_coverage(dup_feat, chunk_starts, n_chunks, j, chunk, px, py):
    """Every tile's j-th chunk against every pixel of the tile: (valid
    [T, PIX, C] bool, z [T, PIX, C], ids [T, 1, C] as f32, 0 for padding
    and for tiles with fewer chunks)."""
    dev = dup_feat.device
    active = j < n_chunks
    start = torch.where(active, chunk_starts.long() + j, torch.zeros_like(chunk_starts, dtype=torch.long))
    cols = start[:, None] * chunk + torch.arange(chunk, device=dev)
    f = dup_feat[:REAL_ROWS][:, cols][:, :, None, :]                       # [10, T, 1, C]
    x0, y0, x1, y1, x2, y2, z0, z1, z2, ids = f
    ids = torch.where(active[:, None, None], ids, torch.zeros_like(ids))
    e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)                     # [T, PIX, C]
    e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)                   # [T, 1, C]
    smin = torch.minimum(torch.minimum(e0, e1), e2)
    smax = torch.maximum(torch.maximum(e0, e1), e2)
    inside = torch.where(area > 0.0, smin, -smax)
    valid = (inside >= 0.0) & (area != 0.0) & (ids > 0.0)
    inv_a = 1.0 / torch.where(area != 0.0, area, torch.ones_like(area))
    z = (e0 * inv_a) * z0 + (e1 * inv_a) * z1 + (e2 * inv_a) * z2
    return valid, z, ids


def ztest_ref(dup_feat, chunk_starts, n_chunks, *, grid_x, num_tiles, chunk, tile):
    """Plain PyTorch K3, vectorised over every tile's j-th chunk at once."""
    dev = dup_feat.device
    pix = tile * tile
    zbest = torch.full((num_tiles, pix), BIG, dtype=torch.float32, device=dev)
    idbest = torch.zeros((num_tiles, pix), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return idbest.to(torch.int32), idbest
    px, py = _pixel_centres(num_tiles, grid_x, tile, dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(int(n_chunks.max())):
        valid, z, ids = _chunk_coverage(dup_feat, chunk_starts, n_chunks, j, chunk, px, py)
        zc = torch.where(valid, z, big)
        zmin = zc.amin(2, keepdim=True)
        hit = (zc <= zmin) & valid
        idw = torch.where(hit, ids, zero).amax(2)
        zmin = zmin[..., 0]
        better = (zmin < zbest) & (idw > 0.0)
        zbest = torch.where(better, zmin, zbest)
        idbest = torch.where(better, idw, idbest)
    return idbest.to(torch.int32), torch.where(idbest > 0.0, zbest, zero)


def _check_inputs(dup_feat, chunk_starts, n_chunks, num_tiles, chunk, tile):
    dev = dup_feat.device
    if dev.type != "cuda":
        raise ValueError(f"the z-test kernel runs on CUDA or CPU tensors, got {dev}")
    if dup_feat.dtype != torch.float32 or dup_feat.dim() != 2 \
            or dup_feat.shape[0] != ROWS or not dup_feat.is_contiguous():
        raise ValueError("dup_feat must be a contiguous float32 [16, K] tensor")
    for name, t in (("chunk_starts", chunk_starts), ("n_chunks", n_chunks)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (num_tiles,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{num_tiles}] tensor on {dev}")
    if tile not in (16, 32):
        raise ValueError(f"the kernel takes tile 16 or 32, got {tile}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in (0, {MAX_CHUNK}], got {chunk}")


def ztest(dup_feat, chunk_starts, n_chunks, *, grid_x, num_tiles, chunk, tile):
    """K3: nearest covering triangle per pixel of every tile ->
    (tri_id [T, PIX] int32, z [T, PIX] float32)."""
    if dup_feat.device.type == "cpu":
        return ztest_ref(dup_feat, chunk_starts, n_chunks, grid_x=grid_x,
                         num_tiles=num_tiles, chunk=chunk, tile=tile)
    _check_inputs(dup_feat, chunk_starts, n_chunks, num_tiles, chunk, tile)
    pix = tile * tile
    out_id = torch.empty((num_tiles, pix), dtype=torch.int32, device=dup_feat.device)
    out_z = torch.empty((num_tiles, pix), dtype=torch.float32, device=dup_feat.device)
    if num_tiles == 0:
        return out_id, out_z
    lib = cuda_build.load("ztest", _ARGTYPES)
    # A quadrant whose list the kernel cuts into segments keeps each
    # segment's winners in `part` and counts the segments done in `done`.
    quads = num_tiles * (tile // 16) ** 2
    part = torch.empty((quads * lib.ztest_max_segments() * 256, 2), dtype=torch.float32,
                       device=dup_feat.device)
    done = torch.zeros(quads, dtype=torch.int32, device=dup_feat.device)
    blocks = ctypes.c_int(0)
    rc = lib.ztest(
        dup_feat.data_ptr(), dup_feat.shape[1], chunk_starts.data_ptr(),
        n_chunks.data_ptr(), out_id.data_ptr(), out_z.data_ptr(), part.data_ptr(),
        done.data_ptr(), num_tiles, grid_x, chunk, tile,
        torch.cuda.current_stream(dup_feat.device).cuda_stream, ctypes.byref(blocks),
    )
    if rc != 0:
        raise RuntimeError(f"ztest kernel launch failed with CUDA error {rc}")
    LAUNCHES["ztest"] += 1
    LAST_GRID["ztest"] = blocks.value
    return out_id, out_z
