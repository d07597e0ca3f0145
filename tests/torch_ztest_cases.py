"""Hand-built one-tile lists for the triangle z-test (K3), made with numpy.

Both the CPU parity tests (the plain version against the Pallas kernel in
interpret mode) and the card tests (the kernel against the plain version)
use them; this module imports neither JAX nor the port.

- ``ties_unordered``: copies of one triangle at equal z whose ids do not
  ascend in slot order. Within the first chunk the larger id sits in the
  earlier slot; the second chunk holds a copy with a still larger id, which
  must not replace the first chunk's winner.
- ``near_ulp``: a lattice of triangles whose vertices lie a few ulps above
  or below integer pixel centres (so the edges pass within rounding of
  many centres), ids shuffled, and two slivers whose rounded edge
  functions cover pixel centres outside their bounding boxes. The x
  coordinates stay on the lattice's integers and the slivers' lengths are
  powers of two: XLA on the CPU contracts the first product of each edge
  function, and the products of the edge differences that the Pallas
  kernel multiplies with a row offset, and of the slivers' z, are then
  exact, so the contraction changes no bit and the two packages can be
  held to equal ids.
- ``near_ulp_xy`` (card tests only, the kernel against the plain version,
  neither contracting): the same with the x coordinates moved by a few
  ulps as well.
"""

import numpy as np

CASES = ("ties_unordered", "near_ulp")
CARD_CASES = CASES + ("near_ulp_xy",)
ROWS = 16


def _ulps(v, k):
    """``v`` moved by ``k`` ulps (float32), elementwise."""
    v = np.asarray(v, np.float32).copy()
    k = np.broadcast_to(np.asarray(k), v.shape)
    for _ in range(int(np.abs(k).max(initial=0))):
        step = k != 0
        v[step] = np.nextafter(v[step], np.where(k[step] > 0, np.inf, -np.inf).astype(np.float32))
        k = k - np.sign(k)
    return v


def tile_list(tris, zs, ids, chunk, tile):
    """One tile's list: (feat [16, K] f32, chunk_starts, n_chunks, geo).
    ``tris`` [n, 3, 2] pixel coords, ``zs`` [n, 3], ``ids`` [n] (face + 1;
    0 leaves a padding slot)."""
    n = len(tris)
    k = max(1, -(-n // chunk)) * chunk
    feat = np.zeros((ROWS, k), np.float32)
    feat[0:6, :n] = np.asarray(tris, np.float32).reshape(n, 6).T
    feat[6:9, :n] = np.asarray(zs, np.float32).T
    feat[9, :n] = np.asarray(ids, np.float32)
    geo = dict(grid_x=1, num_tiles=1, chunk=chunk, tile=tile)
    return feat, np.zeros(1, np.int32), np.array([k // chunk], np.int32), geo


def sliver(x, y, length, ulps):
    """A triangle from (x, y) along a diagonal to (x, y) + length, its third
    vertex ``ulps`` ulps above the second (below for negative ``ulps``, which
    turns the winding): almost no area, and the rounded edge functions of
    the pixel centres on the diagonal before (x, y), outside the bounding
    box, are all >= 0 (or all <= 0)."""
    bx, by = np.float32(x + length), np.float32(y + length)
    return [[x, y], [bx, by], [bx, _ulps(by, ulps)]]


def ztest_case(name, tile):
    if name == "ties_unordered":
        tri = [[3, 3], [12, 4], [6, 13]]
        other = [[1, 8], [14, 9], [2, 15]]       # overlaps tri's lower part
        far = [[100, 100], [101, 100], [100, 101]]
        tris = [tri, tri] + [far] * 6 + [tri, other]
        ids = [7, 3, 11, 1, 2, 4, 5, 6, 12, 9]
        zs = [[0.25] * 3] * 9 + [[0.5] * 3]
        return tile_list(tris, zs, ids, 8, tile)
    if name in ("near_ulp", "near_ulp_xy"):
        rng = np.random.default_rng(7)
        step = 4
        grid = np.arange(0, tile + 1, step, dtype=np.float32)
        gx, gy = np.meshgrid(grid, grid)
        # Not at 0, whose neighbours are subnormal (flushed to 0 by XLA on the CPU).
        vy = _ulps(gy, rng.integers(-3, 4, gy.shape) * (gy != 0))
        vx = _ulps(gx, rng.integers(-3, 4, gx.shape) * (gx != 0)) if name == "near_ulp_xy" else gx
        tris = []
        for i in range(len(grid) - 1):
            for j in range(len(grid) - 1):
                a, b = (vx[i, j], vy[i, j]), (vx[i, j + 1], vy[i, j + 1])
                c, d = (vx[i + 1, j + 1], vy[i + 1, j + 1]), (vx[i + 1, j], vy[i + 1, j])
                tris += [[a, b, c], [a, c, d]] if (i + j) % 2 else [[a, b, d], [b, c, d]]
        zs = rng.uniform(0.3, 0.8, size=(len(tris), 3))
        # Two slivers in front of the lattice: one of each winding.
        tris += [sliver(tile / 2, tile / 2, 1024.0, 2), sliver(tile / 2 + 3, tile / 2 - 2, 1024.0, -2)]
        zs = np.concatenate([zs, np.full((2, 3), 0.25)])
        ids = rng.permutation(len(tris)) + 1
        return tile_list(tris, zs, ids, 32, tile)
    raise KeyError(name)
