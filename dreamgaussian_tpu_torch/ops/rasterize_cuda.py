"""Tile-compositing kernels K1 (forward) and K2 (backward) with their plain
PyTorch versions.

The CUDA kernels (``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``)
replace ``dreamgaussian_tpu/ops/rasterize_pallas.py``'s ``_fwd_kernel``
and ``_bwd_kernel``. Each wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.

Feature/gradient row layout (FEAT_ROWS x K, f32, K minor):
  0 mean_x, 1 mean_y, 2 conic_a, 3 conic_b, 4 conic_c, 5 log_opacity,
  6 color_r, 7 color_g, 8 color_b, 9 depth, 10..15 zero.
Padding slots read a column with log_opacity -1e10 (alpha exactly 0).

Forward per-tile output layout ([T, OUT_CH, PIX], channel-planar):
  0..2 rgb (premultiplied, no background), 3 depth, 4 T_final,
  5 n_contrib (1-based position of the last contributor in the tile's
  list), 6..7 zero.

Semantics (the CUDA reference's, as the JAX kernels keep them): the
exponent ``powero = power + log(opacity)`` is a quadratic form in
tile-centre-relative pixel coordinates; a pair is skipped when
``powero > log_op`` (power > 0) or ``powero < log(1/255)``;
``alpha = min(0.99, exp(powero))``; a pixel stops at the first pair with
``T * (1 - alpha) < 1e-4``, which does not contribute. The backward
treats the 0.99 clamp as straight-through (``d_powero = exp(powero) *
d_alpha``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

TILE = 16
FEAT_ROWS = 16
REAL_FEAT_ROWS = 10
OUT_CH = 8
TERM_EPS = 1e-4
LOG_ALPHA_SKIP = math.log(1.0 / 255.0)
ALPHA_MAX = 0.99
Q_SENTINEL = -1e10
MAX_CHUNK = 128            # shared-memory staging size of the kernels

# Kernel launches, counted by the wrappers where they launch.
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0}
# Blocks of each kernel's last launch: the grid the library gave the launch.
LAST_GRID = {"composite_fwd": 0, "composite_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # feat, k_total, chunk_starts, n_chunks, out, num_tiles, grid_x,
    # tile_offset, chunk, tile, stream, blocks_launched
    "composite_fwd": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                      ctypes.POINTER(_I)],
    # feat, k_total, chunk_starts, n_chunks, fwd_out, g_out, d_feat,
    # num_tiles, grid_x, tile_offset, chunk, tile, stream, blocks_launched
    "composite_bwd": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _P, ctypes.POINTER(_I)],
}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (vectorised over every tile's j-th chunk at once)
# ---------------------------------------------------------------------------


def _tile_centers(num_tiles, grid_x, tile, device, tile_offset=0, dtype=torch.float32):
    """Centres of the tiles ``tile_offset .. tile_offset + num_tiles - 1`` of
    a frame ``grid_x`` tiles wide (a tile-sharded render's local slab)."""
    tid = torch.arange(num_tiles, device=device) + tile_offset
    ty = tid // grid_x
    tx = tid - ty * grid_x
    half = (tile - 1) / 2.0
    return (tx * tile).to(dtype)[:, None] + half, (ty * tile).to(dtype)[:, None] + half


def _pixel_coords(tile, device, dtype=torch.float32):
    pid = torch.arange(tile * tile, device=device)
    half = (tile - 1) / 2.0
    return (pid % tile).to(dtype) - half, (pid // tile).to(dtype) - half


def _chunk_features(dup_feat, chunk_starts, n_chunks, j, chunk):
    """Feature columns of every tile's j-th chunk: ([10, T, C], active [T])."""
    active = j < n_chunks
    start = torch.where(active, chunk_starts.long() + j, torch.zeros_like(chunk_starts, dtype=torch.long))
    cols = start[:, None] * chunk + torch.arange(chunk, device=dup_feat.device)
    return dup_feat[:REAL_FEAT_ROWS][:, cols], active, cols


def _chunk_alpha(f, cx, cy, x, y):
    """alpha, alpha_raw [T, C, PIX] and the local-quadratic columns."""
    mx_l = f[0] - cx
    my_l = f[1] - cy
    ca, cb, cc, log_op = f[2], f[3], f[4], f[5]
    qx_l = ca * mx_l + cb * my_l
    qy_l = cc * my_l + cb * mx_l
    q0_l = -0.5 * (mx_l * qx_l + my_l * qy_l) + log_op
    col = lambda v: v[:, :, None]  # noqa: E731
    powero = (
        (col(q0_l) + col(qx_l) * x) + (col(qy_l) * y + col(ca) * (-0.5 * x * x))
        + (col(cb) * (-(x * y)) + col(cc) * (-0.5 * y * y))
    )
    alpha_raw = torch.exp(powero)
    skip = (powero > col(log_op)) | (powero < LOG_ALPHA_SKIP)
    alpha = torch.where(skip, torch.zeros_like(powero), torch.clamp_max(alpha_raw, ALPHA_MAX))
    return alpha, alpha_raw, (mx_l, my_l, qx_l, qy_l)


def composite_forward_ref(dup_feat, chunk_starts, n_chunks, *, grid_x,
                          num_tiles, chunk, tile=TILE, tile_offset=0):
    """Plain PyTorch K1: [FEAT_ROWS, K] features -> [T, OUT_CH, PIX]. The
    T tiles are the frame's tiles from ``tile_offset`` on."""
    dev = dup_feat.device
    pix = tile * tile
    out = torch.zeros((num_tiles, OUT_CH, pix), dtype=torch.float32, device=dev)
    out[:, 4] = 1.0
    if num_tiles == 0:
        return out
    cx, cy = _tile_centers(num_tiles, grid_x, tile, dev, tile_offset)
    x, y = _pixel_coords(tile, dev)
    sub = torch.arange(chunk, device=dev)
    t_naive = torch.ones((num_tiles, pix), device=dev)
    t_true = torch.ones((num_tiles, pix), device=dev)
    rgbd = torch.zeros((num_tiles, 4, pix), device=dev)
    ncontrib = torch.zeros((num_tiles, pix), device=dev)
    for j in range(int(n_chunks.max())):
        f, active, _ = _chunk_features(dup_feat, chunk_starts, n_chunks, j, chunk)
        alpha, _, _ = _chunk_alpha(f, cx, cy, x, y)
        alpha = alpha * active[:, None, None]
        one_m = 1.0 - alpha
        # Naive transmittance before each pair (ignores the stop rule);
        # the contributors are the pairs it keeps above the threshold.
        prefix = torch.cumprod(one_m, dim=1)
        t_g = t_naive[:, None] * torch.cat([torch.ones_like(prefix[:, :1]), prefix[:, :-1]], 1)
        m = (t_g * one_m >= TERM_EPS) & (alpha > 0.0)
        w = alpha * t_g * m
        rgbd = rgbd + torch.einsum("ktc,tcp->tkp", f[6:10], w)
        gpos = (j * chunk + sub + 1).float()[None, :, None]
        ncontrib = torch.maximum(ncontrib, torch.where(w > 0.0, gpos, 0.0).amax(1))
        t_naive = t_g[:, -1] * one_m[:, -1]
        t_true = t_true * torch.where(m, one_m, torch.ones_like(one_m)).prod(1)
    out[:, 0:4] = rgbd
    out[:, 4] = t_true
    out[:, 5] = ncontrib
    return out


def _chunk_alpha_f32_branches(f, cx, cy, x, y):
    """``_chunk_alpha`` in the inputs' dtype, with each pair's skip and 0.99
    clamp decided as float32 decides them: at those branches the function
    jumps, and a gaussian centred on a pixel sits exactly on one."""
    a32, raw32, _ = _chunk_alpha(f.float(), cx.float(), cy.float(), x.float(), y.float())
    _, raw, cols = _chunk_alpha(f, cx, cy, x, y)
    alpha = torch.where(a32 == 0, 0.0, torch.where(raw32 > ALPHA_MAX, ALPHA_MAX, raw))
    return alpha, raw, cols


def composite_backward_f64(dup_feat, chunk_starts, n_chunks, fwd_out, g_out, **geo):
    """K2's function in float64 on the float64 casts of the same inputs,
    with the branches taken as float32 takes them
    (``_chunk_alpha_f32_branches``): the oracle that K2 and its float32
    plain version are each held to. Returns float64 [FEAT_ROWS, K]."""
    f64 = torch.float64
    return composite_backward_ref(dup_feat.to(f64), chunk_starts, n_chunks, fwd_out.to(f64),
                                  g_out.to(f64), alpha_fn=_chunk_alpha_f32_branches, **geo)


def composite_backward_ref(dup_feat, chunk_starts, n_chunks, fwd_out, g_out, *,
                           grid_x, num_tiles, chunk, tile=TILE, tile_offset=0, alpha_fn=None):
    """Plain PyTorch K2: per-duplicate feature gradients [FEAT_ROWS, K].

    Slots outside every tile's chunk range get zero (under tile sharding,
    the slots of other ranks' tiles among them). It computes in the dtype
    of its inputs (float32 as K2 does; float64 through
    ``composite_backward_f64`` is the oracle). ``alpha_fn`` stands in for
    ``_chunk_alpha``."""
    dev, dt = dup_feat.device, dup_feat.dtype
    d_feat = torch.zeros((FEAT_ROWS, dup_feat.shape[1]), dtype=dt, device=dev)
    if num_tiles == 0:
        return d_feat
    cx, cy = _tile_centers(num_tiles, grid_x, tile, dev, tile_offset, dt)
    x, y = _pixel_coords(tile, dev, dt)
    p6 = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y])   # [6, PIX]
    sub = torch.arange(chunk, device=dev)
    t_final = fwd_out[:, 4]
    ncontrib = fwd_out[:, 5]
    gd = g_out[:, 0:4]
    kt = (g_out[:, 4] * t_final)[:, None]
    max_nc = ncontrib.amax(1)
    t_run = t_final
    s_run = torch.zeros_like(t_final)
    for j in reversed(range(int(n_chunks.max()))):
        f, active, cols = _chunk_features(dup_feat, chunk_starts, n_chunks, j, chunk)
        live = active & (j * chunk < max_nc)
        alpha, alpha_raw, (mx_l, my_l, qx_l, qy_l) = (alpha_fn or _chunk_alpha)(f, cx, cy, x, y)
        gpos = (j * chunk + sub).float()[None, :, None]
        m = (gpos < ncontrib[:, None]) & (alpha > 0.0) & live[:, None, None]
        am = alpha * m
        one_m = 1.0 - am
        # Inclusive suffix product of (1 - alpha) over contributors: T
        # before pair g is T after the chunk divided by it.
        suffix = torch.flip(torch.cumprod(torch.flip(one_m, [1]), 1), [1])
        t_g = t_run[:, None] / suffix
        w = am * t_g
        e = torch.einsum("ktc,tkp->tcp", f[6:10], gd)
        u = w * e
        s_g = s_run[:, None] + torch.flip(torch.cumsum(torch.flip(u, [1]), 1), [1]) - u
        d_alpha = e * t_g - (s_g + kt) / one_m
        d_powero = torch.where(m, alpha_raw * d_alpha, torch.zeros_like(d_alpha))
        s = torch.einsum("tcp,kp->ktc", d_powero, p6)                    # [6, T, C]
        ca, cb, cc = f[2], f[3], f[4]
        rows = torch.stack([
            -qx_l * s[0] + ca * s[1] + cb * s[2],
            -qy_l * s[0] + cb * s[1] + cc * s[2],
            -0.5 * mx_l * mx_l * s[0] + mx_l * s[1] - 0.5 * s[3],
            -mx_l * my_l * s[0] + my_l * s[1] + mx_l * s[2] - s[4],
            -0.5 * my_l * my_l * s[0] + my_l * s[2] - 0.5 * s[5],
            s[0],
        ] + list(torch.einsum("tcp,tkp->ktc", w, gd)))                   # [10, T, C]
        d_feat[:REAL_FEAT_ROWS, cols[active].reshape(-1)] = rows[:, active].reshape(REAL_FEAT_ROWS, -1)
        t_run = t_g[:, 0]
        s_run = s_g[:, 0] + u[:, 0]
    return d_feat


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(dup_feat, chunk_starts, n_chunks, num_tiles, chunk, tile, tile_offset):
    dev = dup_feat.device
    if dev.type != "cuda":
        raise ValueError(f"compositing kernels run on CUDA or CPU tensors, got {dev}")
    if dup_feat.dtype != torch.float32 or dup_feat.dim() != 2 \
            or dup_feat.shape[0] != FEAT_ROWS or not dup_feat.is_contiguous():
        raise ValueError("dup_feat must be a contiguous float32 [16, K] tensor")
    for name, t in (("chunk_starts", chunk_starts), ("n_chunks", n_chunks)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (num_tiles,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{num_tiles}] tensor on {dev}")
    if tile not in (16, 32):
        raise ValueError(f"the kernels take tile 16 or 32, got {tile}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in (0, {MAX_CHUNK}], got {chunk}")
    if tile_offset < 0:
        raise ValueError(f"tile_offset must be >= 0, got {tile_offset}")


def _check_tiles(name, t, dev, num_tiles, pix):
    if t.device != dev or t.dtype != torch.float32 or t.shape != (num_tiles, OUT_CH, pix) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [{num_tiles}, {OUT_CH}, {pix}] tensor on {dev}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _launched(name: str, blocks: ctypes.c_int) -> None:
    LAUNCHES[name] += 1
    LAST_GRID[name] = blocks.value


def composite_forward(dup_feat, chunk_starts, n_chunks, *, grid_x, num_tiles,
                      chunk, tile=TILE, tile_offset=0):
    """K1: front-to-back compositing of every tile -> [T, OUT_CH, PIX].

    ``tile_offset``: the frame's tile that the first of the T tiles is (a
    host int; nonzero on the ranks of a tile-sharded render after the
    first); ``chunk_starts`` and ``n_chunks`` are the T tiles' own."""
    if dup_feat.device.type == "cpu":
        return composite_forward_ref(
            dup_feat, chunk_starts, n_chunks, grid_x=grid_x,
            num_tiles=num_tiles, chunk=chunk, tile=tile, tile_offset=tile_offset,
        )
    _check_inputs(dup_feat, chunk_starts, n_chunks, num_tiles, chunk, tile, tile_offset)
    out = torch.empty((num_tiles, OUT_CH, tile * tile), dtype=torch.float32,
                      device=dup_feat.device)
    if num_tiles == 0:
        return out
    lib = cuda_build.load("composite_fwd", _ARGTYPES["composite_fwd"])
    blocks = ctypes.c_int(0)
    # The tensors' card is current for the launch (a kernel launches only
    # on a stream of the current device; a rank's card may not be cuda:0).
    with torch.cuda.device(dup_feat.device):
        rc = lib.composite_fwd(
            dup_feat.data_ptr(), dup_feat.shape[1], chunk_starts.data_ptr(),
            n_chunks.data_ptr(), out.data_ptr(), num_tiles, grid_x, tile_offset, chunk, tile,
            torch.cuda.current_stream(dup_feat.device).cuda_stream, ctypes.byref(blocks),
        )
    _raise_on(rc, "composite_fwd")
    _launched("composite_fwd", blocks)
    return out


def composite_backward(dup_feat, chunk_starts, n_chunks, fwd_out, g_out, *,
                       grid_x, num_tiles, chunk, tile=TILE, tile_offset=0):
    """K2: per-duplicate feature gradients [FEAT_ROWS, K] from the forward
    output and its cotangent (both [T, OUT_CH, PIX]); slots outside every
    tile's range are zero. ``tile_offset`` as for K1."""
    if dup_feat.device.type == "cpu":
        return composite_backward_ref(
            dup_feat, chunk_starts, n_chunks, fwd_out, g_out, grid_x=grid_x,
            num_tiles=num_tiles, chunk=chunk, tile=tile, tile_offset=tile_offset,
        )
    _check_inputs(dup_feat, chunk_starts, n_chunks, num_tiles, chunk, tile, tile_offset)
    _check_tiles("fwd_out", fwd_out, dup_feat.device, num_tiles, tile * tile)
    _check_tiles("g_out", g_out, dup_feat.device, num_tiles, tile * tile)
    # The kernel writes rows 0-9 of live chunks only; these zeros are the
    # rest (dead chunks, rows 10-15, slots outside every tile's range).
    d_feat = torch.zeros((FEAT_ROWS, dup_feat.shape[1]), dtype=torch.float32,
                         device=dup_feat.device)
    if num_tiles == 0:
        return d_feat
    lib = cuda_build.load("composite_bwd", _ARGTYPES["composite_bwd"])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dup_feat.device):
        rc = lib.composite_bwd(
            dup_feat.data_ptr(), dup_feat.shape[1], chunk_starts.data_ptr(),
            n_chunks.data_ptr(), fwd_out.data_ptr(), g_out.data_ptr(),
            d_feat.data_ptr(), num_tiles, grid_x, tile_offset, chunk, tile,
            torch.cuda.current_stream(dup_feat.device).cuda_stream, ctypes.byref(blocks),
        )
    _raise_on(rc, "composite_bwd")
    _launched("composite_bwd", blocks)
    return d_feat
