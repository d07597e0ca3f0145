"""Triangle binning, the z-test's plain version and rasterize/interpolate of
the PyTorch port against the JAX package (the Pallas z-test in interpret
mode on the CPU), on the same numpy inputs. The JAX side bins with a slot
cap wide enough that it reports overflow == 0, the regime where both
binnings are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.ops import binning as jbin
from dreamgaussian_tpu.ops import mesh_raster as jmr
from dreamgaussian_tpu.ops import mesh_raster_pallas as jzp
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.ops import binning as tbin
from dreamgaussian_tpu_torch.ops import mesh_raster as tmr
from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as tzc


def _np(x):
    return torch.from_numpy(np.array(x))


def _sphere(n_lat=10, n_lon=14, seed=0, bump=0.15):
    """A closed, bumpy UV sphere: (v [V,3] f32, f [F,3] i32)."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)), np.outer(np.cos(lat), np.ones_like(lon)),
                     np.outer(np.sin(lat), np.sin(lon))], -1).reshape(-1, 3)
    v = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]).astype(np.float64)
    v *= 0.6 * (1.0 + bump * rng.uniform(-1, 1, size=(len(v), 1)))
    f = []
    idx = lambda i, j: 1 + i * n_lon + j % n_lon  # noqa: E731
    for j in range(n_lon):
        f.append([0, idx(0, j + 1), idx(0, j)])
        f.append([len(v) - 1, idx(n_lat - 2, j), idx(n_lat - 2, j + 1)])
        for i in range(n_lat - 2):
            f.append([idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)])
            f.append([idx(i, j), idx(i + 1, j + 1), idx(i + 1, j)])
    return v.astype(np.float32), np.asarray(f, np.int32)


def _clip(v, size, elev=20.0, azim=35.0):
    cam = Camera.from_pose(orbit_camera(elev, azim, 2.0), size, size, 0.86, 0.86)
    v_h = np.concatenate([v, np.ones((len(v), 1), np.float32)], 1)
    return (v_h @ cam.arrays()["full_proj"].T).astype(np.float32)


def _both_ztests(dup_feat, chunk_starts, n_chunks, **geo):
    j = np.asarray(jzp.ztest(jnp.asarray(dup_feat), jnp.asarray(chunk_starts),
                             jnp.asarray(n_chunks), **geo))
    ids, z = tzc.ztest_ref(_np(dup_feat), _np(chunk_starts), _np(n_chunks), **geo)
    return j[..., 0].astype(np.int32), j[..., 1], ids.numpy(), z.numpy()


def _single_tile_feat(tris, zs, chunk, tile=16):
    """dup_feat of one tile whose list is ``tris`` ([n, 3, 2] pixel coords)
    at depths ``zs`` ([n, 3]), ids 1..n in list order."""
    n = len(tris)
    k = -(-n // chunk) * chunk
    feat = np.zeros((16, k), np.float32)
    feat[0:6, :n] = np.asarray(tris, np.float32).reshape(n, 6).T
    feat[6:9, :n] = np.asarray(zs, np.float32).T
    feat[9, :n] = np.arange(1, n + 1)
    geo = dict(grid_x=1, num_tiles=1, chunk=chunk, tile=tile)
    return feat, np.zeros(1, np.int32), np.array([k // chunk], np.int32), geo


def test_ztest_ref_matches_pallas_on_small_triangles():
    """A mesh of small triangles at 64^2, tile 32, chunk 128. Ids equal on
    every pixel; z to 1e-6 (the same float32 expression on both sides)."""
    size, tile, chunk = 64, 32, 128
    v, f = _sphere(16, 24, seed=1)
    feat_cols, xmin, ymin, xmax, ymax, ok = tmr.triangle_features(
        _np(_clip(v, size)), _np(f).long(), size, size, tile)
    bins = tbin.bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=2, num_tiles=4, chunk=chunk)
    assert int(bins.n_chunks.max()) >= 2          # the winner crosses chunks
    dup = feat_cols.index_select(1, bins.dup_map).numpy()
    j_id, j_z, t_id, t_z = _both_ztests(dup, bins.chunk_starts.numpy(), bins.n_chunks.numpy(),
                                        grid_x=2, num_tiles=4, chunk=chunk, tile=tile)
    assert (j_id > 0).mean() > 0.2
    np.testing.assert_array_equal(t_id, j_id)
    np.testing.assert_allclose(t_z, j_z, rtol=0, atol=1e-6)


def test_ztest_pixel_centre_on_shared_edge():
    """A square split along its diagonal, vertices on pixel centres: the
    diagonal's pixels lie exactly on the shared edge, are inside both
    triangles at equal z, and go to the larger id; so do the pixels on the
    outer edges, which are inside."""
    tris = [[[2, 2], [10, 2], [10, 10]], [[2, 2], [10, 10], [2, 10]]]
    zs = [[0.1, 0.3, 0.5], [0.1, 0.5, 0.2]]
    feat, cs, nc, geo = _single_tile_feat(tris, zs, chunk=8)
    j_id, j_z, t_id, t_z = _both_ztests(feat, cs, nc, **geo)
    np.testing.assert_array_equal(t_id, j_id)
    np.testing.assert_allclose(t_z, j_z, rtol=0, atol=1e-6)
    img = t_id.reshape(16, 16)
    assert all(img[d, d] == 2 for d in range(2, 11))     # the shared edge
    assert img[2, 6] == 1 and img[6, 2] == 2             # outer edges are inside
    assert img[1, 6] == 0 and img[6, 11] == 0


@pytest.mark.parametrize("gap,winner", [(0, 2), (7, 1)])
def test_ztest_equal_z_ties(gap, winner):
    """Two copies of one triangle at equal z. In one chunk (ids 1 and 2)
    the larger id wins; with seven far-away triangles between them at chunk
    8 the copy falls into the second chunk, and only a strictly smaller z
    replaces the first chunk's winner."""
    tri = [[3, 3], [12, 4], [6, 13]]
    far = [[100, 100], [101, 100], [100, 101]]
    tris = [tri] + [far] * gap + [tri]
    zs = [[0.25, 0.25, 0.25]] * len(tris)
    feat, cs, nc, geo = _single_tile_feat(tris, zs, chunk=8)
    assert nc[0] == (2 if gap else 1)
    j_id, j_z, t_id, t_z = _both_ztests(feat, cs, nc, **geo)
    np.testing.assert_array_equal(t_id, j_id)
    np.testing.assert_allclose(t_z, j_z, rtol=0, atol=1e-6)
    hit = t_id[t_id > 0]
    assert hit.size > 20 and (hit == winner).all()


def test_ztest_wrapper_takes_plain_version_on_cpu():
    feat, cs, nc, geo = _single_tile_feat([[[1, 1], [9, 2], [4, 12]]], [[0.1, 0.2, 0.3]], chunk=8)
    before = dict(tzc.LAUNCHES)
    ids, z = tzc.ztest(_np(feat), _np(cs), _np(nc), **geo)
    r_ids, r_z = tzc.ztest_ref(_np(feat), _np(cs), _np(nc), **geo)
    assert torch.equal(ids, r_ids) and torch.equal(z, r_z)
    assert ids.dtype == torch.int32 and z.dtype == torch.float32
    assert tzc.LAUNCHES == before      # no kernel launched on the CPU


def _tile_lists(dup_map, chunk_starts, n_chunks, n, chunk):
    dup_map, cs, nc = (np.asarray(x) for x in (dup_map, chunk_starts, n_chunks))
    out = []
    for s, c in zip(cs, nc):
        ids = dup_map[s * chunk:(s + c) * chunk]
        out.append(ids[ids < n])
    return out


@pytest.mark.parametrize("chunk", [8, 128])
def test_triangle_binning_same_lists_per_tile(chunk):
    """Random rects on an 8x6 tile grid, some invalid, some empty. JAX gets a
    slot cap of the whole grid, so its overflow is 0 and both binnings are
    exact: the same lists in the same (index) order in every tile."""
    rng = np.random.default_rng(2)
    n, gx, gy = 200, 8, 6
    xmin = rng.integers(0, gx, n).astype(np.int32)
    ymin = rng.integers(0, gy, n).astype(np.int32)
    xmax = np.minimum(xmin + rng.integers(0, 4, n), gx).astype(np.int32)
    ymax = np.minimum(ymin + rng.integers(0, 4, n), gy).astype(np.int32)
    valid = (rng.uniform(size=n) > 0.1) & (xmax > xmin) & (ymax > ymin)
    jb = jbin.bin_rects(jnp.asarray(xmin), jnp.asarray(ymin), jnp.asarray(xmax),
                        jnp.asarray(ymax), jnp.arange(n, dtype=jnp.int32), jnp.asarray(valid), n,
                        grid_x=gx, num_tiles=gx * gy, max_tiles=gx * gy, chunk=chunk)
    assert int(jb.overflow) == 0
    tb = tbin.bin_rects(_np(xmin), _np(ymin), _np(xmax), _np(ymax), _np(valid),
                        grid_x=gx, num_tiles=gx * gy, chunk=chunk)
    np.testing.assert_array_equal(tb.n_chunks.numpy(), np.asarray(jb.n_chunks))
    np.testing.assert_array_equal(tb.chunk_starts.numpy(), np.asarray(jb.chunk_starts))
    assert int(tb.num_dups) == int(jb.num_dups) and int(tb.overflow) == 0
    for t_list, j_list in zip(_tile_lists(tb.dup_map, tb.chunk_starts, tb.n_chunks, n, chunk),
                              _tile_lists(jb.dup_map, jb.chunk_starts, jb.n_chunks, n, chunk)):
        np.testing.assert_array_equal(t_list, j_list)


def _rasterize_both(size=64, derivs=True):
    v, f = _sphere(10, 14, seed=3)
    v_clip = _clip(v, size)
    j = jmr.rasterize(jnp.asarray(v_clip), jnp.asarray(f), size, size, tile=32, derivs=derivs)
    t = tmr.rasterize(_np(v_clip), _np(f), size, size, tile=32, derivs=derivs)
    return v, f, v_clip, j, t


def test_rasterize_matches_jax():
    """tri_id and mask equal on every pixel; bary, zbuf and the barycentric
    derivatives to 1e-5 (the same float32 expressions)."""
    _, _, _, j, t = _rasterize_both()
    assert 0.2 < float(np.asarray(j.mask).mean()) < 0.9
    np.testing.assert_array_equal(t.tri_id.numpy(), np.asarray(j.tri_id))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    for k in ("bary", "zbuf", "bary_dx", "bary_dy"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_interpolate_values_and_derivs_match_jax():
    v, f, _, j, t = _rasterize_both()
    attrs = np.random.default_rng(4).normal(size=(len(v), 5)).astype(np.float32)
    np.testing.assert_allclose(tmr.interpolate(_np(attrs), _np(f), t).numpy(),
                               np.asarray(jmr.interpolate(jnp.asarray(attrs), jnp.asarray(f), j)),
                               rtol=0, atol=1e-5)
    for a, b in zip(tmr.interpolate_with_derivs(_np(attrs), _np(f), t),
                    jmr.interpolate_with_derivs(jnp.asarray(attrs), jnp.asarray(f), j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_interpolate_gradients_match_jax():
    """d(sum(interpolate * w)) / d(v_clip, attrs): to 1e-4 of the largest
    gradient entry (float32 sums over a triangle's pixels in another order)."""
    size = 64
    v, f = _sphere(10, 14, seed=3)
    v_clip = _clip(v, size)
    rng = np.random.default_rng(5)
    attrs = rng.normal(size=(len(v), 4)).astype(np.float32)
    w = rng.normal(size=(size, size, 4)).astype(np.float32)

    def jloss(vc, at):
        rast = jmr.rasterize(vc, jnp.asarray(f), size, size, tile=32)
        return jnp.sum(jmr.interpolate(at, jnp.asarray(f), rast) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v_clip), jnp.asarray(attrs))
    vc, at = _np(v_clip).requires_grad_(True), _np(attrs).requires_grad_(True)
    rast = tmr.rasterize(vc, _np(f), size, size, tile=32)
    torch.sum(tmr.interpolate(at, _np(f), rast) * _np(w)).backward()
    for name, tg, ref in (("v_clip", vc.grad, jg[0]), ("attrs", at.grad, jg[1])):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(tg.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_ztest_pair_work_counts_match_a_pixel_walk():
    """chip_smoke.py's K3 bound counts the pixels inside each triangle's
    bounding box within its tile and the covering pairs; both equal a walk
    over every slot and pixel, one at a time."""
    from chip_smoke import ztest_pair_work

    size, tile, chunk = 64, 16, 8
    v, f = _sphere(8, 10, seed=6)
    feat_cols, xmin, ymin, xmax, ymax, ok = tmr.triangle_features(
        _np(_clip(v, size)), _np(f).long(), size, size, tile)
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=chunk, tile=tile)
    bins = tbin.bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=geo["grid_x"],
                          num_tiles=geo["num_tiles"], chunk=chunk)
    dup = feat_cols.index_select(1, bins.dup_map)
    slots = box = cover = 0
    for t in range(geo["num_tiles"]):
        ty, tx = divmod(t, geo["grid_x"])
        start, n = int(bins.chunk_starts[t]) * chunk, int(bins.n_chunks[t]) * chunk
        for col in dup[:, start:start + n].numpy().T:
            if col[9] <= 0:
                continue
            slots += 1
            xs, ys = col[0:6:2], col[1:6:2]
            area = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (ys[1] - ys[0]) * (xs[2] - xs[0])
            for py in range(ty * tile, ty * tile + tile):
                for px in range(tx * tile, tx * tile + tile):
                    if not (xs.min() <= px <= xs.max() and ys.min() <= py <= ys.max()):
                        continue
                    box += 1
                    e = [(xs[b] - xs[a]) * (py - ys[a]) - (ys[b] - ys[a]) * (px - xs[a])
                         for a, b in ((1, 2), (2, 0), (0, 1))]
                    cover += bool(area != 0 and (min(e) >= 0 if area > 0 else max(e) <= 0))
    assert slots > 100 and cover > 500
    assert ztest_pair_work(dup, bins, **geo) == (slots, box, cover)
