"""Binning, the compositing kernels' plain versions and render_gaussians of
the PyTorch port against the JAX package (Pallas in interpret mode on the
CPU), on the same numpy inputs. The JAX side bins with a slot cap wide
enough that it reports overflow == 0, the regime where both are exact.
Tests marked ``cuda`` hold the CUDA kernels against the plain versions and
skip without a card."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.ops import binning as jbin
from dreamgaussian_tpu.ops import project as jproj
from dreamgaussian_tpu.ops import rasterize as jras
from dreamgaussian_tpu.ops import rasterize_pallas as jpal
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.ops import binning as tbin
from dreamgaussian_tpu_torch.ops import rasterize as tras
from dreamgaussian_tpu_torch.ops import rasterize_cuda as tcu
from torch_composite_cases import CASES, composite_case

CHUNK = 128
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "cuda_parity")


def _scene(n, seed, spread=0.5, log_scale=(-3.5, -2.0)):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        (rng.normal(size=(n, 3)) * spread).astype(f),
        np.exp(rng.uniform(*log_scale, size=(n, 3))).astype(f),
        rng.normal(size=(n, 4)).astype(f),
        rng.uniform(0.05, 0.95, size=n).astype(f),
        (rng.normal(size=(n, 1, 3)) * 0.5).astype(f),
    )


def _camera(size, elev=10.0, azim=25.0):
    return Camera.from_pose(orbit_camera(elev, azim, 2.5), size, size, 0.8, 0.8).arrays()


@functools.lru_cache(maxsize=None)
def _jax_bins(size, tile, seed, n=300):
    xyz, scale, quat, op, shs = _scene(n, seed)
    a = _camera(size)
    p = jproj.project_gaussians(xyz, scale, quat, op, shs, a["view"], a["full_proj"],
                                a["campos"], a["tanfov"], size, size)
    bins = jbin.bin_gaussians(p.mean2d, p.depth, p.radius, size, size, max_tiles=256,
                              chunk=CHUNK, tile=tile, conic=p.conic,
                              log_opacity=jnp.log(p.opacity))
    assert int(bins.overflow) == 0
    return p, bins


def _tile_lists(dup_map, chunk_starts, n_chunks, n):
    dup_map, cs, nc = (np.asarray(x) for x in (dup_map, chunk_starts, n_chunks))
    out = []
    for s, c in zip(cs, nc):
        ids = dup_map[s * CHUNK:(s + c) * CHUNK]
        out.append(ids[ids < n])
    return out


def _np(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("tile", [16, 32])
def test_binning_same_lists_per_tile(tile):
    p, jb = _jax_bins(64, tile, seed=1)
    tb = tbin.bin_gaussians(_np(p.mean2d), _np(p.depth), _np(p.radius), 64, 64,
                            chunk=CHUNK, tile=tile, conic=_np(p.conic),
                            log_opacity=torch.log(_np(p.opacity)))
    n = p.mean2d.shape[0]
    np.testing.assert_array_equal(tb.n_chunks.numpy(), np.asarray(jb.n_chunks))
    np.testing.assert_array_equal(tb.chunk_starts.numpy(), np.asarray(jb.chunk_starts))
    assert int(tb.num_dups) == int(jb.num_dups) and int(tb.overflow) == 0
    for t_list, j_list in zip(_tile_lists(tb.dup_map, tb.chunk_starts, tb.n_chunks, n),
                              _tile_lists(jb.dup_map, jb.chunk_starts, jb.n_chunks, n)):
        np.testing.assert_array_equal(t_list, j_list)


@pytest.mark.parametrize("tile", [16, 32])
def test_composite_plain_versions_match_pallas(tile):
    size = 64
    p, jb = _jax_bins(size, tile, seed=1)
    feat = jras.build_feature_cols(p.mean2d, p.depth, p.conic, p.color, p.opacity)
    dup = jnp.take(feat, jb.dup_map, axis=1)
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    j_out = np.asarray(jpal.composite_forward(dup, jb.chunk_starts, jb.n_chunks, **geo))
    t_out = tcu.composite_forward_ref(_np(dup), _np(jb.chunk_starts), _np(jb.n_chunks), **geo)
    # n_contrib is an integer position: exactly equal. The rest is float32
    # compositing with another association of the transmittance product;
    # the depth channel sums depths of about 2.5, hence the 2e-5 floor.
    np.testing.assert_array_equal(t_out[:, 5].numpy(), j_out[:, 5])
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5, atol=2e-5)

    g_out = np.random.default_rng(3).normal(size=j_out.shape).astype(np.float32)
    j_d = np.asarray(jpal.composite_backward(dup, jb.chunk_starts, jb.n_chunks, j_out,
                                             jnp.asarray(g_out), **geo))
    t_d = tcu.composite_backward_ref(_np(dup), _np(jb.chunk_starts), _np(jb.n_chunks),
                                     _np(j_out), _np(g_out), **geo).numpy()
    # Compare the slots inside tile ranges: the Pallas kernel leaves the
    # rest unwritten (the JAX wrapper masks them), the port writes zeros.
    cs, nc = np.asarray(jb.chunk_starts), np.asarray(jb.n_chunks)
    covered = np.zeros(j_d.shape[1], bool)
    for s, c in zip(cs, nc):
        covered[s * CHUNK:(s + c) * CHUNK] = True
    assert not t_d[:, ~covered].any()
    # Sums over the tile's pixels in another order, with T rebuilt from a
    # suffix product instead of exp(sum log): relative 1e-5 of the largest.
    scale = np.abs(j_d[:, covered]).max()
    np.testing.assert_allclose(t_d[:, covered], j_d[:, covered], rtol=1e-4, atol=2e-6 * scale)


@pytest.mark.parametrize("case", CASES)
def test_composite_cases_match_pallas(case):
    """The hand-built cases that the card tests give the CUDA kernels (a
    quadrant that stops in the first chunk beside quadrants that walk six,
    empty tiles beside full ones, a list of six chunks), here through the
    port's plain K1 and K2 against the Pallas kernels, at tile 32."""
    c = composite_case(case, 32)
    geo, cs, nc = c["geo"], c["chunk_starts"], c["n_chunks"]
    dup = jnp.asarray(c["feat"])
    j_out = np.asarray(jpal.composite_forward(dup, jnp.asarray(cs), jnp.asarray(nc), **geo))
    t_out = tcu.composite_forward_ref(_np(c["feat"]), _np(cs), _np(nc), **geo)
    n_contrib = t_out[:, 5].numpy()
    if case == "quadrant_stops_early":
        quad = n_contrib.reshape(32, 32)
        assert quad[:16, :16].max() <= CHUNK and t_out[0, 4].reshape(32, 32)[:16, :16].max() < 1e-2
        assert min(quad[:16, 16:].max(), quad[16:, :16].max(), quad[16:, 16:].max()) > 5 * CHUNK
    elif case == "empty_beside_full":
        assert not n_contrib[[0, 2]].any() and n_contrib[1].max() > 2 * CHUNK
    else:
        assert n_contrib.max() > 5 * CHUNK
    # As test_composite_plain_versions_match_pallas: n_contrib equal, the
    # rest float32 with another association of the transmittance product.
    np.testing.assert_array_equal(n_contrib, j_out[:, 5])
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5, atol=2e-5)

    g_out = np.random.default_rng(3).normal(size=j_out.shape).astype(np.float32)
    j_d = np.asarray(jpal.composite_backward(dup, jnp.asarray(cs), jnp.asarray(nc), j_out,
                                             jnp.asarray(g_out), **geo))
    t_d = tcu.composite_backward_ref(_np(c["feat"]), _np(cs), _np(nc), _np(j_out), _np(g_out),
                                     **geo).numpy()
    covered = np.zeros(j_d.shape[1], bool)
    for s, n in zip(cs, nc):
        covered[s * CHUNK:(s + n) * CHUNK] = True
    assert not t_d[:, ~covered].any()
    # Each float32 gradient (Pallas and port alike) is held to the float64
    # evaluation of the same function, within K2_UNITS units of float32
    # rounding times a forward-error scale that _k2_oracle derives from it.
    want, scale = _k2_oracle(c, j_out, g_out)
    for name, got in (("pallas", j_d), ("port", t_d)):
        err = np.abs(got[:10, covered] - want[:10, covered])
        units = err / (F32_EPS * scale[:10, covered] + 1e-300)
        rows = np.unique(np.nonzero(units > K2_UNITS)[0])
        assert units.max() <= K2_UNITS, (f"{name}: rows {rows} off the float64 result by up "
                                         f"to {units.max():.2f} units of rounding")
    assert not t_d[10:].any()


F32_EPS = float(np.finfo(np.float32).eps)
# Units of float32 rounding allowed per unit of _k2_oracle's scale. Seen on
# one AVX-512 machine: up to 5.8 (Pallas) and 5.7 (port), both in the
# colour rows of quadrant_stops_early, where 1 - alpha is 0.01.
K2_UNITS = 16.0


def _k2_oracle(c, fwd_out, g_out):
    """K2 of a case in float64, and the scale of its float32 forward error.

    The oracle is the port's plain K2 run on the float64 casts of the same
    inputs, with the pair-skip and 0.99-clamp branches taken as float32
    takes them (at those branches the function jumps, and a gaussian centred
    on a pixel sits exactly on one). The scale of each gradient entry has
    two parts: the summation's, the float64 sum over the pixels (and the
    six moments of the conic rows) of the absolute terms; and the terms'
    own, the root sum of squares over the pixels (whose roundings are
    independent) of each pixel's term times its condition: 4, plus the
    magnitudes of its exponent's terms (exp's relative error), plus, over
    the pairs its T is rebuilt through, 1 + alpha / (1 - alpha)."""
    f64 = torch.float64
    feat, cs, nc = _np(c["feat"]).to(f64), _np(c["chunk_starts"]), _np(c["n_chunks"])
    fwd, g = _np(fwd_out).to(f64), _np(g_out).to(f64)
    geo = c["geo"]
    branches_of_f32 = tcu._chunk_alpha_f32_branches
    want = tcu.composite_backward_f64(feat, cs, nc, fwd, g, **geo).numpy()
    summed, rss = torch.zeros_like(feat), torch.zeros_like(feat)
    tile, chunk = geo["tile"], geo["chunk"]
    cx, cy = tcu._tile_centers(geo["num_tiles"], geo["grid_x"], tile, "cpu", 0, f64)
    x, y = tcu._pixel_coords(tile, "cpu", f64)
    p6 = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y])
    sub = torch.arange(chunk)
    gd, kt = g[:, 0:4], (g[:, 4] * fwd[:, 4])[:, None]
    t_run = fwd[:, 4]
    s_run, sa_run, k_run = (torch.zeros_like(t_run) for _ in range(3))
    flip_cumsum = lambda v: torch.flip(torch.cumsum(torch.flip(v, [1]), 1), [1])  # noqa: E731
    col = lambda v: v[:, :, None]  # noqa: E731
    for j in reversed(range(int(nc.max()))):
        f, active, cols = tcu._chunk_features(feat, cs, nc, j, chunk)
        live = active & (j * chunk < fwd[:, 5].amax(1))
        alpha, raw, (mx, my, qx, qy) = branches_of_f32(f, cx, cy, x, y)
        m = ((j * chunk + sub).to(f64)[None, :, None] < fwd[:, 5][:, None]) \
            & (alpha > 0) & live[:, None, None]
        am = alpha * m
        one_m = 1.0 - am
        t_g = t_run[:, None] / torch.flip(torch.cumprod(torch.flip(one_m, [1]), 1), [1])
        ca, cb, cc = f[2], f[3], f[4]
        q0 = -0.5 * (mx * qx + my * qy) + f[5]
        k_g = k_run[:, None] + flip_cumsum((1.0 + am / one_m) * m)
        k_run = k_g[:, 0]
        cond = 4.0 + k_g + (col(q0).abs() + (col(qx) * x).abs() + (col(qy) * y).abs()
                            + (col(ca) * 0.5 * x * x).abs() + (col(cb) * x * y).abs()
                            + (col(cc) * 0.5 * y * y).abs())
        w = am * t_g
        e = torch.einsum("ktc,tkp->tcp", f[6:10], gd)
        e_abs = torch.einsum("ktc,tkp->tcp", f[6:10].abs(), gd.abs())
        u, u_abs = w * e, w * e_abs
        s_g = s_run[:, None] + flip_cumsum(u) - u
        sa_g = sa_run[:, None] + flip_cumsum(u_abs) - u_abs
        d_powero = torch.where(m, raw * (e * t_g - (s_g + kt) / one_m), 0.0)
        d_abs = torch.where(m, raw * (e_abs * t_g + (sa_g + kt.abs()) / one_m), 0.0)
        zero = torch.zeros_like(ca)
        coef = [[-qx, ca, cb], [-qy, cb, cc], [-0.5 * mx * mx, mx, zero, zero - 0.5],
                [-mx * my, my, mx, zero, zero - 1.0], [-0.5 * my * my, zero, my, zero, zero, zero - 0.5],
                [zero + 1.0]]
        rows_sum, rows_rss = [], []
        for row in coef:
            term = sum(col(a) * p6[k] for k, a in enumerate(row)) * d_powero
            rows_sum.append((sum(col(a).abs() * p6[k].abs() for k, a in enumerate(row))
                             * d_abs).sum(-1))
            rows_rss.append((cond * term).square().sum(-1).sqrt())
        for q in range(4):
            rows_sum.append((w * gd[:, q].abs()[:, None, :]).sum(-1))
            rows_rss.append((cond * w * gd[:, q][:, None, :]).square().sum(-1).sqrt())
        at = cols[active].reshape(-1)
        summed[:10, at] = torch.stack(rows_sum)[:, active].reshape(10, -1)
        rss[:10, at] = torch.stack(rows_rss)[:, active].reshape(10, -1)
        t_run, s_run, sa_run = t_g[:, 0], s_g[:, 0] + u[:, 0], sa_g[:, 0] + u_abs[:, 0]
    return want, (summed + rss).numpy()


def _render_pair(args, cam, size, tile, weights):
    """(JAX outputs, JAX grads, port outputs, port grads) for
    loss = sum(image*w_img) + sum(depth*w_d) + sum(alpha*w_a)."""
    w_img, w_d, w_a = weights
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    tap = np.zeros((args[0].shape[0], 2), np.float32)

    def jrun(xyz, scale, quat, op, shs, tap):
        out = jras.render_gaussians(xyz, scale, quat, op, shs, cam["view"], cam["full_proj"],
                                    cam["campos"], cam["tanfov"], size, size, jnp.asarray(bg),
                                    mean2d_tap=tap, max_tiles=256, chunk=CHUNK, tile=tile)
        loss = jnp.sum(out.image * w_img) + jnp.sum(out.depth * w_d) + jnp.sum(out.alpha * w_a)
        return loss, out

    (_, jout), jg = jax.value_and_grad(jrun, argnums=tuple(range(6)), has_aux=True)(*args, tap)
    assert int(jout.overflow) == 0
    targs = [_np(x).requires_grad_(True) for x in (*args, tap)]
    tout = tras.render_gaussians(
        *targs[:5], *(_np(cam[k]) for k in ("view", "full_proj", "campos", "tanfov")),
        size, size, _np(bg), mean2d_tap=targs[5], tile=tile, device="cpu")
    loss = (torch.sum(tout.image * _np(w_img)) + torch.sum(tout.depth * _np(w_d))
            + torch.sum(tout.alpha * _np(w_a)))
    loss.backward()
    return jout, jg, tout, [t.grad for t in targs]


def test_render_gaussians_values_and_grads():
    """At the trainer's tile 32; tile 16 is held by the golden below."""
    size, tile = 64, 32
    args = _scene(250, seed=4)
    rng = np.random.default_rng(7)
    weights = (rng.normal(size=(size, size, 3)).astype(np.float32),
               rng.normal(size=(size, size)).astype(np.float32),
               rng.normal(size=(size, size)).astype(np.float32))
    jout, jg, tout, tg = _render_pair(args, _camera(size), size, tile, weights)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert int(tout.overflow) == 0
    for k in ("image", "depth", "alpha"):
        np.testing.assert_allclose(getattr(tout, k).detach().numpy(),
                                   np.asarray(getattr(jout, k)), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # Per-gaussian gradients chain the per-duplicate ones through the
    # projection; float32 reassociation stays within 1e-4 of the largest.
    for name, t, j in zip(("xyz", "scale", "quat", "opacity", "shs", "mean2d_tap"), tg, jg):
        ref = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_cuda_parity_golden_small_front():
    """The hash-pinned small_front golden (tile 16), with the tolerances of
    tests/test_cuda_parity.py."""
    from dreamgaussian_tpu_torch.utils.camera import Camera as TCamera
    from dreamgaussian_tpu_torch.utils.camera import orbit_camera as torbit

    d = np.load(os.path.join(FIXTURES, "small_front.npz"))
    size, fov = int(d["size"]), float(d["fovy"])
    cam = TCamera.from_pose(torbit(float(d["elev"]), float(d["azim"]), float(d["radius"])),
                            size, size, fov, fov).arrays()
    args = [_np(d[k]).requires_grad_(True) for k in ("xyz", "scale", "quat", "opacity", "shs")]
    tap = torch.zeros((args[0].shape[0], 2), requires_grad=True)
    out = tras.render_gaussians(*args, *(_np(cam[k]) for k in ("view", "full_proj", "campos", "tanfov")),
                                size, size, torch.ones(3), mean2d_tap=tap, tile=16, device="cpu")
    np.testing.assert_allclose(out.image.detach().numpy().transpose(2, 0, 1), d["image"], atol=2e-4)
    np.testing.assert_allclose(out.alpha.detach().numpy()[None], d["alpha"], atol=2e-4)
    np.testing.assert_array_equal(out.radii.numpy() > 0, d["radii"] > 0)
    loss = (torch.sum(out.image * _np(d["w_img"]).permute(1, 2, 0))
            + torch.sum(out.alpha * _np(d["w_alpha"])[0]))
    loss.backward()
    for t, key in zip(args, ("g_xyz", "g_scale", "g_quat", "g_opacity", "g_shs")):
        ref = d[key].reshape(t.grad.shape)
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=5e-4 * (np.abs(ref).max() + 1e-6),
                                   rtol=5e-3, err_msg=key)
    ref2d = d["g_means2d"][:, :2]
    np.testing.assert_allclose(tap.grad.numpy() * (size / 2.0), ref2d,
                               atol=1e-3 * (np.abs(ref2d).max() + 1e-6), rtol=1e-2)


def test_pair_work_counts_match_pixel_walk():
    """chip_smoke.py's bound counts the pairs each kernel must evaluate;
    they equal a front-to-back walk of every pixel, one pair at a time."""
    from chip_smoke import pair_work

    size, tile = 64, 16
    p, _ = _jax_bins(size, tile, seed=1)
    args = [_np(x) for x in (p.mean2d, p.depth, p.radius, p.conic, p.color, p.opacity)]
    bins = tbin.bin_gaussians(*args[:3], size, size, chunk=CHUNK, tile=tile, conic=args[3],
                              log_opacity=torch.log(args[5]))
    dup = tras.build_feature_cols(args[0], args[1], args[3], args[4], args[5])
    dup = dup.index_select(1, bins.dup_map).contiguous()
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    out = tcu.composite_forward_ref(dup, bins.chunk_starts, bins.n_chunks, **geo)

    contrib = k1 = k2 = k1_slots = k2_slots = 0
    x, y = (v.numpy() for v in tcu._pixel_coords(tile, "cpu"))
    for t in range(geo["num_tiles"]):
        start, n = int(bins.chunk_starts[t]) * CHUNK, int(bins.n_chunks[t]) * CHUNK
        f = dup[:tcu.REAL_FEAT_ROWS, start:start + n].numpy()
        f = f[:, f[5] > tcu.Q_SENTINEL / 2]            # the real (unpadded) list
        cy, cx = divmod(t, geo["grid_x"])
        mx, my = f[0] - (cx * tile + (tile - 1) / 2), f[1] - (cy * tile + (tile - 1) / 2)
        walked = np.full(tile * tile, f.shape[1])
        last = np.zeros(tile * tile, np.int64)
        trans = np.ones(tile * tile, np.float32)
        running = np.ones(tile * tile, bool)
        for g in range(f.shape[1]):
            dx, dy = x - mx[g], y - my[g]
            powero = -0.5 * (f[2, g] * dx * dx + f[4, g] * dy * dy) - f[3, g] * dx * dy + f[5, g]
            hit = running & (powero <= f[5, g]) & (powero >= tcu.LOG_ALPHA_SKIP)
            one_m = 1.0 - np.minimum(np.exp(powero), tcu.ALPHA_MAX)
            stops = hit & (trans * one_m < tcu.TERM_EPS)
            adds = hit & ~stops
            walked[stops] = g + 1
            running &= ~stops
            trans = np.where(adds, trans * one_m, trans)
            last[adds] = g + 1
            contrib += int(adds.sum())
        k1, k2 = k1 + int(walked.sum()), k2 + int(last.sum())
        k1_slots, k2_slots = k1_slots + int(walked.max()), k2_slots + int(last.max())
    np.testing.assert_array_equal(out[:, 5].long().numpy().sum(), k2)
    assert pair_work(dup, bins, out, **geo) == (contrib, k1 - contrib, k2 - contrib,
                                                k1_slots, k2_slots)


def test_wrappers_take_plain_version_on_cpu():
    p, jb = _jax_bins(64, 16, seed=1)
    feat = jras.build_feature_cols(p.mean2d, p.depth, p.conic, p.color, p.opacity)
    dup = _np(jnp.take(feat, jb.dup_map, axis=1))
    geo = dict(grid_x=4, num_tiles=16, chunk=CHUNK, tile=16)
    before = dict(tcu.LAUNCHES)
    out = tcu.composite_forward(dup, _np(jb.chunk_starts), _np(jb.n_chunks), **geo)
    ref = tcu.composite_forward_ref(dup, _np(jb.chunk_starts), _np(jb.n_chunks), **geo)
    assert torch.equal(out, ref)
    assert tcu.LAUNCHES == before      # no kernel launched on the CPU


def test_empty_scene_renders_background():
    """Every gaussian behind the camera: no duplicates, every tile empty;
    the image is the background and the gradients are zero and finite."""
    xyz, scale, quat, op, shs = (_np(a).requires_grad_(True) for a in _scene(50, seed=8))
    cam = _camera(32)
    # Camera.campos is minus the camera's position (the reference's quirk):
    # -2 * campos lies as far behind the camera as the origin is before it.
    behind = -2.0 * _np(cam["campos"])
    bg = torch.tensor([0.2, 0.4, 0.6])
    out = tras.render_gaussians(xyz + behind, scale, quat, op, shs,
                                *(_np(cam[k]) for k in ("view", "full_proj", "campos", "tanfov")),
                                32, 32, bg, tile=32, device="cpu")
    assert int((out.radii > 0).sum()) == 0
    assert torch.equal(out.image, bg.expand(32, 32, 3)) and not out.alpha.any()
    (out.image.sum() + out.alpha.sum()).backward()
    for t in (xyz, scale, quat, op, shs):
        assert t.grad is None or (torch.isfinite(t.grad).all() and not t.grad.any())


def _zero_colour_sh():
    """A float32 SH DC coefficient c with fl(C0 * c) + 0.5 == 0 exactly."""
    c0 = np.float32(0.28209479177387814)
    c = np.float32(-0.5) / c0
    for _ in range(64):
        if c0 * c + np.float32(0.5) == 0:
            return c
        c = np.nextafter(c, np.float32(0.0 if c0 * c < np.float32(-0.5) else -10.0))
    raise AssertionError("no float32 coefficient gives a colour of exactly 0")


def test_image_clamp_tie_gradient_matches_jax():
    """Gaussians whose colour is exactly 0 over a black background: every
    pixel is exactly 0.0 and sits on the image clamp's lower bound, where
    jnp.clip passes half of the gradient, and the colour's own floor passes
    half again. The port's gradients equal JAX's there too."""
    size, tile = 32, 32
    xyz, scale, quat, op, shs = _scene(40, seed=11, log_scale=(-2.5, -1.5))
    shs = np.full_like(shs, _zero_colour_sh())
    cam = _camera(size)
    w = np.random.default_rng(12).normal(size=(size, size, 3)).astype(np.float32)
    bg = np.zeros(3, np.float32)

    def jloss(shs, op):
        out = jras.render_gaussians(xyz, scale, quat, op, shs, cam["view"], cam["full_proj"],
                                    cam["campos"], cam["tanfov"], size, size, jnp.asarray(bg),
                                    max_tiles=256, chunk=CHUNK, tile=tile)
        return jnp.sum(out.image * w), out

    (_, jout), (jg_shs, jg_op) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(shs, op)
    assert not np.asarray(jout.image).any() and float(np.asarray(jout.alpha).max()) > 0.3
    t_shs, t_op = _np(shs).requires_grad_(True), _np(op).requires_grad_(True)
    tout = tras.render_gaussians(
        _np(xyz), _np(scale), _np(quat), t_op, t_shs,
        *(_np(cam[k]) for k in ("view", "full_proj", "campos", "tanfov")),
        size, size, _np(bg), tile=tile, device="cpu")
    assert not tout.image.any()
    torch.sum(tout.image * _np(w)).backward()
    ref = np.asarray(jg_shs)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(t_shs.grad.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    # Colours of 0 give the opacity no gradient on either side.
    np.testing.assert_allclose(t_op.grad.numpy(), np.asarray(jg_op), rtol=1e-3, atol=1e-7)


def test_overflowing_exp_outside_the_contributors():
    """A non-PSD conic whose exp(powero) overflows on pairs that are skipped
    (power > 0 at every pixel, so the gaussian contributes nothing). The
    Pallas backward writes inf * 0 = NaN into that pair's rows, and its
    transposed write carries the NaN to the position and opacity rows of the
    chunk's other pairs; the port's K2 and its plain version write 0 for
    the pair and leave the others alone. Held here: after the trainers'
    nan_to_num the non-PSD gaussian's gradient is 0 in both packages; the
    colour rows agree as they are; and every gradient of the port equals
    JAX's on the scene without that gaussian."""
    size, tile, n, bad = 64, 32, 30, 7
    rng = np.random.default_rng(13)
    mean2d = rng.uniform(4, 60, size=(n, 2)).astype(np.float32)
    depth = rng.uniform(1, 3, size=n).astype(np.float32)
    s = rng.uniform(0.02, 0.1, size=n).astype(np.float32)
    conic = np.stack([s, 0.2 * s, 1.5 * s], 1).astype(np.float32)
    conic[bad] = [-1.0, 0.0, -1.0]            # power = +0.5 |d|^2: exp overflows
    mean2d[bad] = [10.3, 12.7]                # off every pixel centre
    color = rng.uniform(size=(n, 3)).astype(np.float32)
    op = rng.uniform(0.2, 0.9, size=n).astype(np.float32)
    radius = np.full(n, 40, np.int32)
    culled = radius.copy()
    culled[bad] = 0
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    w = rng.normal(size=(size, size, 3)).astype(np.float32)

    def jgrads(radius):
        def loss(mean2d, conic, color, op):
            img, _, alpha, overflow = jras.rasterize_projected(
                mean2d, depth, conic, color, op, radius, size, size, jnp.asarray(bg),
                max_tiles=256, chunk=CHUNK, tile=tile)
            return jnp.sum(img * w) + jnp.sum(alpha), overflow

        (_, overflow), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            mean2d, conic, color, op)
        assert int(overflow) == 0
        return [np.asarray(x) for x in g]

    raw, clean = jgrads(radius), jgrads(culled)
    targs = [_np(a).requires_grad_(True) for a in (mean2d, conic, color, op)]
    img, _, alpha, _ = tras.rasterize_projected(targs[0], _np(depth), targs[1], targs[2],
                                                targs[3], _np(radius), size, size, _np(bg),
                                                tile=tile)
    (torch.sum(img * _np(w)) + torch.sum(alpha)).backward()
    assert np.isnan(raw[0][bad]).all() and np.isnan(raw[1][bad]).all()   # JAX: NaN rows
    assert all(np.isfinite(g).all() for g in clean)
    for name, t, j_raw, j_clean in zip(("mean2d", "conic", "color", "opacity"), targs, raw, clean):
        assert torch.isfinite(t.grad).all(), name                         # the port: no NaN
        assert not t.grad[bad].any() and not np.nan_to_num(j_raw)[bad].any(), name
        np.testing.assert_allclose(t.grad.numpy(), j_clean, rtol=1e-3,
                                   atol=1e-4 * np.abs(j_clean).max(), err_msg=name)
    np.testing.assert_allclose(targs[2].grad.numpy(), raw[2], rtol=1e-3,
                               atol=1e-4 * np.abs(raw[2]).max())
