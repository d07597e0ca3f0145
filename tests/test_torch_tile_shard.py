"""Tile sharding of the PyTorch port against the JAX package: K1/K2's plain
versions with a tile offset against the Pallas kernels (interpret mode) on
a slab of tiles; the port's tile2 and tile4 renders and their gradients,
in four gloo ranks on the CPU, against JAX's tile-sharded render on the
virtual CPU devices (256^2, tile 32, within the bounds of
tests/test_tile_shard.py); and the port's sharded render against its own
unsharded one."""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dreamgaussian_tpu.ops import rasterize as jras
from dreamgaussian_tpu.ops import rasterize_pallas as jpal
from dreamgaussian_tpu.parallel.tile_shard import (
    make_tile_sharded_render,
    render_gaussians_tile_sharded,
)
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.ops import rasterize_cuda as tcu
from test_torch_rasterize import CHUNK, _jax_bins, _np
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import SIZE, TILE, loss_weights, run_ranks, scene

GRAD_NAMES = ("xyz", "scale", "quat", "opacity", "shs")


@pytest.fixture(scope="module", autouse=True)
def started_ranks(tmp_path_factory):
    """Four gloo ranks on the CPU: tile2 (a data2xtile2 mesh) and tile4
    renders, forward and gradients; rank 0 also unsharded. Started with
    the module's first test, so that they run while the tests before the
    sharded ones do."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, [("tile_render", str(tmp_path_factory.mktemp("tile_render")))],
                          4)


@pytest.fixture(scope="module")
def port_ranks(started_ranks):
    return started_ranks.result()[0]


@pytest.mark.parametrize("tile", [16, 32])
def test_plain_versions_with_tile_offset_match_pallas(tile):
    """The second half of a 64^2 frame's tile rows as a slab: chunk lists
    sliced to it, the slab's first tile as the offset."""
    size = 64
    p, jb = _jax_bins(size, tile, seed=1)
    grid_x = size // tile
    t0 = grid_x * grid_x // 2
    count = grid_x * grid_x - t0
    feat = jras.build_feature_cols(p.mean2d, p.depth, p.conic, p.color, p.opacity)
    dup = jnp.take(feat, jb.dup_map, axis=1)
    cs, nc = jb.chunk_starts[t0:], jb.n_chunks[t0:]
    geo = dict(grid_x=grid_x, num_tiles=count, chunk=CHUNK, tile=tile)
    off = jnp.asarray([t0], jnp.int32)
    j_out = np.asarray(jpal.composite_forward(dup, cs, nc, off, **geo))
    t_out = tcu.composite_forward_ref(_np(dup), _np(cs), _np(nc), tile_offset=t0, **geo)
    assert j_out[:, 5].max() > 0, "the slab must hold contributors"
    # As test_composite_plain_versions_match_pallas: n_contrib equal, the
    # rest float32 with another association of the transmittance product.
    np.testing.assert_array_equal(t_out[:, 5].numpy(), j_out[:, 5])
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5, atol=2e-5)
    # The slab's tiles are the whole frame's tiles t0.. as the unsharded
    # plain version composites them: the offset places them, exactly.
    whole = tcu.composite_forward_ref(_np(dup), _np(jb.chunk_starts), _np(jb.n_chunks),
                                      **dict(geo, num_tiles=grid_x * grid_x))
    assert torch.equal(t_out, whole[t0:])
    # Without the offset the centres are the first tiles': another image.
    assert not torch.equal(t_out, tcu.composite_forward_ref(_np(dup), _np(cs), _np(nc), **geo))

    g_out = np.random.default_rng(3).normal(size=j_out.shape).astype(np.float32)
    j_d = np.asarray(jpal.composite_backward(dup, cs, nc, j_out, jnp.asarray(g_out), off,
                                             **geo))
    t_d = tcu.composite_backward_ref(_np(dup), _np(cs), _np(nc), _np(j_out), _np(g_out),
                                     tile_offset=t0, **geo).numpy()
    covered = np.zeros(j_d.shape[1], bool)
    for s, c in zip(np.asarray(cs), np.asarray(nc)):
        covered[s * CHUNK:(s + c) * CHUNK] = True
    # Slots of the other tiles (another rank's under tile sharding) are
    # real gaussians; the port leaves them zero, the Pallas kernel unwritten.
    assert not t_d[:, ~covered].any()
    scale = np.abs(j_d[:, covered]).max()
    np.testing.assert_allclose(t_d[:, covered], j_d[:, covered], rtol=1e-4, atol=2e-6 * scale)




def _cam():
    fov = np.radians(49.1)
    c = Camera.from_pose(orbit_camera(15, 30, 2.0), SIZE, SIZE, fov, fov)
    return {k: jnp.asarray(v) for k, v in c.arrays().items()}


@pytest.fixture(scope="module")
def jax_image():
    """JAX's make_tile_sharded_render over four tile devices."""
    a = _cam()
    fn = make_tile_sharded_render(Mesh(np.array(jax.devices()[:4]), ("tile",)), SIZE, SIZE)
    return np.asarray(fn(*map(jnp.asarray, scene(200, 0)), a["view"], a["full_proj"],
                         a["campos"], a["tanfov"]))


@pytest.fixture(scope="module")
def jax_grads():
    """Gradients of sum(image * w) + sum(alpha) of JAX's tile-sharded
    render over two tile devices (tests/test_tile_shard.py's loss)."""
    a = _cam()
    wr = jnp.asarray(loss_weights())

    @functools.partial(jax.shard_map, mesh=Mesh(np.array(jax.devices()[:2]), ("tile",)),
                       in_specs=(P(),) * 5, out_specs=P(), check_vma=False)
    def loss(xyz, scale, quat, op, shs):
        out = render_gaussians_tile_sharded(
            xyz, scale, quat, op, shs, a["view"], a["full_proj"], a["campos"], a["tanfov"],
            SIZE, SIZE, jnp.ones(3), tile=TILE, max_tiles=12)
        return jnp.sum(out.image * wr) + jnp.sum(out.alpha)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, scene(120, 3)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("label", ["tile2", "tile4"])
def test_sharded_render_matches_jax(port_ranks, jax_image, label):
    for rank in port_ranks:
        # tests/test_tile_shard.py's bound: near-exact for the mass, a rare
        # pixel flips one near-terminal contribution at the 1e-4 stop rule.
        d = np.abs(rank[f"{label}_image"] - jax_image)
        assert (d > 1e-5).mean() < 1e-4, f"{(d > 1e-5).sum()} pixels differ"
        assert d.max() < 2e-2, f"max diff {d.max()} exceeds the flip bound"


@pytest.mark.parametrize("label", ["tile2", "tile4"])
def test_sharded_gradients_match_jax(port_ranks, jax_grads, label):
    for rank in port_ranks:
        for name, ref in zip(GRAD_NAMES, jax_grads):
            got = rank[f"{label}_g_{name}"]
            # tests/test_tile_shard.py's gradient bound.
            mag = np.abs(ref).max() + 1e-6
            np.testing.assert_allclose(got, ref, atol=1e-4 * mag, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("label", ["tile2", "tile4"])
def test_sharded_render_equals_unsharded_on_the_cpu(port_ranks, label):
    """On the CPU each slab goes through the same plain K1 as the whole
    frame, tile by tile, and the gather adds zeros: the image, depth and
    alpha are equal bit for bit on every rank. The gradients are equal on
    every rank; against the unsharded ones they agree to float32 rounding:
    the plain K2's sums over a tile's pixels are batched matrix products
    whose blocking follows the number of tiles in the call, and the
    per-gaussian sums of the slabs are added in another order."""
    single = port_ranks[0]
    for rank in port_ranks:
        # make_tile_sharded_render is the same render.
        np.testing.assert_array_equal(rank[f"{label}_made_image"], rank[f"{label}_image"])
        for k in ("image", "depth", "alpha"):
            np.testing.assert_array_equal(rank[f"{label}_{k}"], single[f"single_{k}"],
                                          err_msg=k)
        for n in GRAD_NAMES:
            got, ref = rank[f"{label}_g_{n}"], single[f"single_g_{n}"]
            np.testing.assert_array_equal(got, port_ranks[-1][f"{label}_g_{n}"], err_msg=n)
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=n)
