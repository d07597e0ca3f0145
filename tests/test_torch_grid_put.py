"""The grid_put scatter family of the PyTorch port against the JAX package on
the same numpy inputs: every mode, with and without ``weights``, raw sums
and counts as well as the normalized mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dreamgaussian_tpu.ops import grid_put as jgp
from dreamgaussian_tpu_torch.ops import grid_put as tgp

# float32 sums of a few taps per cell in another order.
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return torch.from_numpy(np.array(x))


def _points(n, dim, c=3, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1.0, 1.0, size=(n, dim)).astype(np.float32)
    coords[:4] = np.array([[-1.0] * dim, [1.0] * dim, [0.0] * dim, [1.0] + [-1.0] * (dim - 1)])
    return coords, rng.uniform(size=(n, c)).astype(np.float32)


def _close(t_out, j_out):
    if isinstance(j_out, tuple):
        for a, b in zip(t_out, j_out):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [(2, 2), (4, 4), (2, 4)])
def test_bilinear_upsample_equals_jax_resize(scale):
    """The mipmap variants rely on it: ``F.interpolate(bilinear,
    align_corners=False)`` equals ``jax.image.resize(bilinear)`` when
    upsampling, to float32 rounding."""
    x = np.random.default_rng(0).normal(size=(12, 10, 3)).astype(np.float32)
    size = (12 * scale[0], 10 * scale[1])
    j = np.asarray(jax.image.resize(jnp.asarray(x), size + (3,), "bilinear"))
    t = F.interpolate(_np(x).permute(2, 0, 1)[None], size=size, mode="bilinear",
                      align_corners=False)[0].permute(1, 2, 0)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgp._upsample(_np(x), size).numpy(), j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("return_count", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_linear_grid_put_2d(return_count, weighted):
    coords, values = _points(500, 2)
    w = np.random.default_rng(1).uniform(size=500).astype(np.float32) if weighted else None
    j = jgp.linear_grid_put_2d(24, 20, jnp.asarray(coords), jnp.asarray(values),
                               return_count=return_count,
                               weights=None if w is None else jnp.asarray(w))
    t = tgp.linear_grid_put_2d(24, 20, _np(coords), _np(values), return_count=return_count,
                               weights=None if w is None else _np(w))
    _close(t, j)


@pytest.mark.parametrize("return_count", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_mipmap_linear_grid_put_2d(return_count, weighted):
    """Few points on a 64^2 grid, so that most texels are holes which the
    32^2 and 16^2 levels fill."""
    coords, values = _points(150, 2, seed=2)
    w = (np.random.default_rng(3).uniform(size=150) > 0.3).astype(np.float32) if weighted else None
    kw = dict(min_resolution=8, return_count=return_count)
    j = jgp.mipmap_linear_grid_put_2d(64, 64, jnp.asarray(coords), jnp.asarray(values),
                                      weights=None if w is None else jnp.asarray(w), **kw)
    t = tgp.mipmap_linear_grid_put_2d(64, 64, _np(coords), _np(values),
                                      weights=None if w is None else _np(w), **kw)
    _close(t, j)


def test_weight_zero_is_an_exact_no_op():
    """Points of weight 0 leave sums and counts bit for bit as if they had
    not been scattered, at every mip level."""
    coords, values = _points(300, 2, seed=4)
    w = (np.arange(300) % 3 != 0).astype(np.float32)
    keep = w > 0
    for fn, kw in ((tgp.linear_grid_put_2d, {}),
                   (tgp.mipmap_linear_grid_put_2d, {"min_resolution": 8})):
        a = fn(32, 32, _np(coords), _np(values), return_count=True, weights=_np(w), **kw)
        b = fn(32, 32, _np(coords[keep]), _np(values[keep]), return_count=True, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("return_count", [False, True])
@pytest.mark.parametrize("name,dim", [("nearest_grid_put_2d", 2), ("nearest_grid_put_3d", 3),
                                      ("linear_grid_put_3d", 3),
                                      ("mipmap_linear_grid_put_3d", 3)])
def test_nearest_and_3d_families(name, dim, return_count):
    coords, values = _points(400, dim, seed=5)
    shape = (12, 10) if dim == 2 else (16, 16, 16)
    kw = {"min_resolution": 3} if name.startswith("mipmap") else {}
    j = getattr(jgp, name)(*shape, jnp.asarray(coords), jnp.asarray(values),
                           return_count=return_count, **kw)
    t = getattr(tgp, name)(*shape, _np(coords), _np(values), return_count=return_count, **kw)
    _close(t, j)


@pytest.mark.parametrize("return_raw", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "linear", "linear-mipmap"])
@pytest.mark.parametrize("shape", [(20, 28), (16, 16, 16)])
def test_grid_put_dispatcher(shape, mode, return_raw):
    coords, values = _points(300, len(shape), seed=6)
    j = jgp.grid_put(shape, jnp.asarray(coords), jnp.asarray(values), mode=mode,
                     min_resolution=4, return_raw=return_raw)
    t = tgp.grid_put(shape, _np(coords), _np(values), mode=mode, min_resolution=4,
                     return_raw=return_raw)
    _close(t, j)


def test_grid_put_rejects_bad_arguments():
    coords, values = _points(10, 2)
    with pytest.raises(ValueError):
        tgp.grid_put((8,), _np(coords[:, :1]), _np(values))
    with pytest.raises(ValueError):
        tgp.grid_put((8, 8), _np(coords), _np(values), mode="cubic")


@pytest.mark.parametrize("k", [1, 3])
def test_knn_inpaint(k):
    rng = np.random.default_rng(7)
    grid = rng.uniform(size=(24, 24, 3)).astype(np.float32)
    mask = rng.uniform(size=(24, 24)) > 0.6
    np.testing.assert_array_equal(tgp.knn_inpaint(grid, mask, k=k),
                                  jgp.knn_inpaint(grid, mask, k=k))
