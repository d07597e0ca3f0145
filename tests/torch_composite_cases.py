"""Hand-built inputs of the tile compositor (numpy only), shared by the CPU
parity tests (test_torch_rasterize.py) and the card tests (test_torch_cuda.py).

Each case is a dict of the kernels' arguments: ``feat`` [16, K] float32 in
the chunk-aligned duplicate layout (padding slots carry log_opacity -1e10),
``chunk_starts`` / ``n_chunks`` int32 [T], and ``geo`` (grid_x, num_tiles,
chunk, tile). Positions scale with the tile, so a case means the same at
tile 16 and 32.
"""

import numpy as np

CHUNK = 128
CASES = ("quadrant_stops_early", "empty_beside_full", "long_list")


def _columns(xy, sigma, opacity, rng):
    """Feature columns [10, n] of isotropic gaussians at pixel positions xy."""
    n = len(xy)
    inv = 1.0 / np.square(np.broadcast_to(sigma, n))
    return np.stack([
        xy[:, 0], xy[:, 1], inv, np.zeros(n), inv, np.log(np.broadcast_to(opacity, n)),
        *rng.uniform(0.05, 1.0, size=(3, n)), rng.uniform(1.0, 3.0, size=n),
    ]).astype(np.float32)


def _layout(lists, grid_x, tile):
    """Per-tile lists of columns -> the aligned duplicate layout."""
    n_chunks = np.array([-(-cols.shape[1] // CHUNK) for cols in lists], np.int32)
    starts = (np.cumsum(n_chunks) - n_chunks).astype(np.int32)
    feat = np.zeros((16, int(n_chunks.sum()) * CHUNK + CHUNK), np.float32)
    feat[5] = -1e10
    for cols, s in zip(lists, starts):
        feat[:10, s * CHUNK:s * CHUNK + cols.shape[1]] = cols
    geo = dict(grid_x=grid_x, num_tiles=len(lists), chunk=CHUNK, tile=tile)
    return {"feat": feat, "chunk_starts": starts, "n_chunks": n_chunks, "geo": geo}


def _faint(n, lo, hi, tile, rng):
    """n faint gaussians scattered over [lo, hi)^2: no pixel under them stops."""
    xy = rng.uniform(lo, hi, size=(n, 2))
    return _columns(xy, 0.09 * tile, rng.uniform(0.03, 0.08, size=n), rng)


def composite_case(name: str, tile: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if name == "quadrant_stops_early":
        # One tile. The first chunk is a dense lattice of opaque gaussians
        # over the tile's top-left quadrant: every pixel there stops inside
        # that chunk. Five chunks of faint gaussians over the other three
        # quadrants follow, which those quadrants' pixels walk to the end.
        half = tile // 2
        side = np.linspace(0.0, half - 1.0, 8)
        lattice = np.stack(np.meshgrid(side, side), -1).reshape(-1, 2)
        opaque = _columns(np.concatenate([lattice, lattice]), 0.07 * tile, 0.99, rng)
        xy = rng.uniform(0.0, tile, size=(5 * CHUNK, 2))
        xy = xy[(xy[:, 0] > half + 0.2 * tile) | (xy[:, 1] > half + 0.2 * tile)]
        faint = _columns(xy, 0.07 * tile, rng.uniform(0.03, 0.08, size=len(xy)), rng)
        # Gaussians far outside the tile fill the five chunks up, mixed
        # among the faint ones so that every chunk holds some of both.
        far = _columns(np.full((5 * CHUNK - len(xy), 2), 3.0 * tile), 0.01 * tile, 0.5, rng)
        rest = np.concatenate([faint, far], 1)[:, rng.permutation(5 * CHUNK)]
        return _layout([np.concatenate([opaque, rest], 1)], 1, tile)
    if name == "empty_beside_full":
        # Four tiles in a row: empty, three chunks, empty, one gaussian.
        full = _faint(3 * CHUNK, tile, 2 * tile, tile, rng)
        one = _columns(np.array([[3.4 * tile, 0.5 * tile]]), 0.2 * tile, 0.7, rng)
        empty = np.zeros((10, 0), np.float32)
        return _layout([empty, full, empty, one], 4, tile)
    if name == "long_list":
        # One tile whose list is six chunks, the last one partly padding:
        # longer than the kernels' two staging buffers, walked to its end.
        return _layout([_faint(5 * CHUNK + 37, 0.0, tile, tile, rng)], 1, tile)
    raise ValueError(name)
