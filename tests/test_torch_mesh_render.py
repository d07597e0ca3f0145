"""Stage-2 mesh rendering of the PyTorch port against the JAX package on the
same numpy inputs: texture sampling (bilinear, nearest, trilinear over the
mip chain), silhouette antialiasing, the SSAA resize at each factor the
trainer uses, and ``render_mesh`` at every SSAA choice, both texture
filters, with and without antialiasing and with trainable geometry; values
and gradients. The JAX z-test runs its Pallas kernel in interpret mode.

Tolerances: values within 1e-5 absolute; a gradient tensor within
``GRAD_RTOL |ref| + GRAD_ATOL max |ref|`` elementwise, the absolute part
scaled to that tensor's largest value (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.ops import mesh_raster as jmr
from dreamgaussian_tpu.render import MeshRendererState as JState
from dreamgaussian_tpu.render import render_mesh as j_render_mesh
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.ops import mesh_raster as tmr
from dreamgaussian_tpu_torch.render import MeshRendererState as TState
from dreamgaussian_tpu_torch.render import render_mesh as t_render_mesh
from dreamgaussian_tpu_torch.train.stage2 import SSAA_CHOICES
from test_stage2 import sphere_mesh_uv
from torch_cpu_cases import one_torch_thread  # noqa: F401

VALUE_ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-5
FOV = np.radians(49.1)


def _np(x):
    return torch.from_numpy(np.array(x))


def assert_grad_close(got, ref, name, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, f"{name}: the reference gradient is zero"
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale, err_msg=name)


def _vjp_both(jfn, tfn, inputs, seed):
    """Values and input gradients of ``sum(out * g)`` with a seeded
    cotangent ``g``, through JAX and through the port."""
    jout, jvjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in inputs])
    g = np.random.default_rng(seed).normal(size=jout.shape).astype(np.float32)
    jgrads = jvjp(jnp.asarray(g))
    tin = [_np(a).requires_grad_(True) for a in inputs]
    tout = tfn(*tin)
    (tout * _np(g)).sum().backward()
    return (np.asarray(jout), tout.detach().numpy(), jgrads,
            [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in tin])


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_texture(mode):
    rng = np.random.default_rng(0)
    tex = rng.normal(size=(16, 24, 3)).astype(np.float32)
    # u, v beyond [0, 1] on both sides exercise the clamp.
    uv = rng.uniform(-0.1, 1.1, size=(20, 18, 2)).astype(np.float32)
    uv[0, 0] = [1.0, 0.0]
    j, t, jg, tg = _vjp_both(lambda a, b: jmr.sample_texture(a, b, mode),
                             lambda a, b: tmr.sample_texture(a, b, mode), (tex, uv), 1)
    np.testing.assert_allclose(t, j, atol=VALUE_ATOL)
    assert_grad_close(tg[0], jg[0], "tex")
    if mode == "bilinear":
        assert_grad_close(tg[1], jg[1], "uv")
    else:                       # rounding: no gradient reaches uv
        assert not tg[1].any() and not np.asarray(jg[1]).any()


def test_mip_chain_and_trilinear_sampling():
    """Trilinear sampling over a 64^2 chain (5 levels) at footprints from 1/4
    to 40 texels. A pixel whose LOD lies within float32 rounding of an
    integer may floor to either neighbouring level in the two packages;
    the blend is continuous in LOD (both sides give that level's sample),
    so such pixels are held to the same tolerance as the rest, and the
    test counts them to show the case is met."""
    rng = np.random.default_rng(2)
    tex = rng.normal(size=(64, 64, 3)).astype(np.float32)
    h = w = 32
    uv = rng.uniform(0, 1, size=(h, w, 2)).astype(np.float32)
    # Footprints 2**lod / 64 with lod in [-2, 5.3]; a third of the pixels
    # sit exactly on an integer LOD, where the floor is decided by rounding.
    lod = rng.uniform(-2, 5.3, size=(h, w)).astype(np.float32)
    lod[::3] = np.round(lod[::3])
    ang = rng.uniform(0, 2 * np.pi, size=(h, w))
    dx = np.stack([np.cos(ang), np.sin(ang)], -1) * (2.0 ** lod / 64)[..., None]
    dy = np.stack([-np.sin(ang), np.cos(ang)], -1) * (0.5 * 2.0 ** lod / 64)[..., None]
    dx, dy = dx.astype(np.float32), dy.astype(np.float32)

    jchain = jax.jit(jmr.build_mip_chain)(jnp.asarray(tex))
    tchain = tmr.build_mip_chain(_np(tex))
    assert [tuple(c.shape) for c in tchain] == [c.shape for c in jchain]
    for jc, tc in zip(jchain, tchain):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)

    j, t, jg, tg = _vjp_both(
        lambda a, b: jmr.sample_texture_mip(jmr.build_mip_chain(a), b, dx, dy),
        lambda a, b: tmr.sample_texture_mip(tmr.build_mip_chain(a), b, _np(dx), _np(dy)),
        (tex, uv), 3)
    rho = np.maximum(np.linalg.norm(dx * 64, axis=-1), np.linalg.norm(dy * 64, axis=-1))
    at_integer = np.abs(np.log2(rho) - np.round(np.log2(rho))) < 1e-5
    assert at_integer.sum() >= h * w // 4, at_integer.sum()
    np.testing.assert_allclose(t, j, atol=VALUE_ATOL)
    assert_grad_close(tg[0], jg[0], "tex")
    assert_grad_close(tg[1], jg[1], "uv")


def _sphere_clip(size, elev=15.0, azim=30.0):
    m = sphere_mesh_uv()
    cam = Camera.from_pose(orbit_camera(elev, azim, 2.0), size, size, FOV, FOV)
    v_h = np.concatenate([m.v, np.ones((len(m.v), 1), np.float32)], 1)
    return (v_h @ cam.arrays()["full_proj"].T).astype(np.float32), m.f.astype(np.int32)


def test_antialias_values_and_gradients():
    """Colour and clip-space vertex gradients through the silhouette blend
    of a sphere at 64^2 (both rasterizations agree pixel for pixel)."""
    size = 64
    v_clip, f = _sphere_clip(size)
    jr = jmr.rasterize(jnp.asarray(v_clip), jnp.asarray(f), size, size)
    tr = tmr.rasterize(_np(v_clip), _np(f).long(), size, size)
    np.testing.assert_array_equal(tr.tri_id.numpy(), np.asarray(jr.tri_id))
    color = np.random.default_rng(4).uniform(size=(size, size, 3)).astype(np.float32)
    j, t, jg, tg = _vjp_both(
        lambda c, v: jmr.antialias(c, jr, v, jnp.asarray(f), size, size),
        lambda c, v: tmr.antialias(c, tr, v, _np(f), size, size), (color, v_clip), 5)
    changed = np.abs(j - color).max(-1) > 0
    assert changed.sum() > 50, changed.sum()            # silhouettes were blended
    np.testing.assert_allclose(t, j, atol=VALUE_ATOL)
    assert_grad_close(tg[0], jg[0], "color")
    assert_grad_close(tg[1], jg[1], "v_clip")


@pytest.mark.parametrize("src", [128, 384, 640, 896])
def test_scale_img_at_each_ssaa_factor(src):
    """The resize of a render at each SSAA choice to the 512^2 novel view:
    plain bilinear up (128, 384), a widened triangle filter down (640, 896)."""
    img = np.random.default_rng(src).uniform(size=(src, src, 3)).astype(np.float32)
    j, t, jg, tg = _vjp_both(lambda a: jmr.scale_img(a, 512, 512),
                             lambda a: tmr.scale_img(a, 512, 512), (img,), 6)
    assert t.shape == (512, 512, 3)
    np.testing.assert_allclose(t, j, atol=VALUE_ATOL)
    assert_grad_close(tg[0], jg[0], "image")


def _camera(size, elev=10.0, azim=30.0):
    cam = Camera.from_pose(orbit_camera(elev, azim, 2.0), size, size, FOV, FOV)
    w2c = np.asarray(cam.view[:3, :3]).copy()
    w2c[1:3] *= -1
    arr = {k: cam.arrays()[k] for k in ("view", "full_proj")}
    return arr, w2c.T.astype(np.float32)


def _textured_sphere():
    """The sphere with a smooth colour pattern of a few periods. A texture of
    independent random texels would turn the last-bit differences of the
    two packages' clip-space matmuls (uv moves by ~1e-8) into value
    differences above 1e-5 at the texel scale; a real albedo is smooth."""
    m = sphere_mesh_uv()
    yy, xx = np.mgrid[0:1:64j, 0:1:64j]
    m.albedo = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * xx + k) + 5 * yy * k)
                         for k in range(3)], -1).astype(np.float32)
    return m


RENDER_CASES = [
    *[dict(ssaa=s) for s in (1.0, *SSAA_CHOICES)],
    dict(ssaa=1.25, texture_filter="bilinear"),
    dict(ssaa=1.0, edge_aa=False),
    dict(ssaa=0.75, train_geo=True),
    dict(ssaa=1.75, train_geo=True, texture_filter="bilinear"),
]


@pytest.mark.parametrize("kw", RENDER_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_render_mesh(kw):
    """Every output of one render at 64^2 and the gradients of a seeded
    linear function of them w.r.t. raw_albedo (and v_offsets)."""
    size = 64
    m = _textured_sphere()
    arr, rot = _camera(size)
    js = JState.from_mesh(m)
    ts = TState.from_mesh(m, "cpu")
    np.testing.assert_allclose(ts.raw_albedo.numpy(), np.asarray(js.raw_albedo), atol=1e-6)
    train_geo = kw.get("train_geo", False)
    # A small offset field, so that the geometry path is not at its rest state.
    offs = (np.random.default_rng(8).normal(size=m.v.shape) * 2e-3).astype(np.float32)
    names = ("image", "alpha", "depth", "normal", "viewcos")
    rng = np.random.default_rng(9)
    gs = {k: rng.normal(size=(size, size, 3 if k in ("image", "normal") else 1)).astype(np.float32)
          for k in names}

    def jloss(raw, vo):
        out = j_render_mesh(js._replace(raw_albedo=raw, v_offsets=vo),
                            {k: jnp.asarray(v) for k, v in arr.items()}, jnp.asarray(rot),
                            size, size, **kw)
        return sum(jnp.sum(out[k] * gs[k]) for k in names), out

    (jl, jout), (jg_raw, jg_off) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        js.raw_albedo, jnp.asarray(offs))
    raw = ts.raw_albedo.clone().requires_grad_(True)
    vo = _np(offs).requires_grad_(True)
    tout = t_render_mesh(ts._replace(raw_albedo=raw, v_offsets=vo),
                         {k: _np(v) for k, v in arr.items()}, _np(rot), size, size, **kw)
    sum((tout[k] * _np(gs[k])).sum() for k in names).backward()

    assert float(np.asarray(jout["alpha"]).mean()) > 0.05
    for k in names:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=VALUE_ATOL,
                                   err_msg=k)
    assert_grad_close(raw.grad.numpy(), jg_raw, "raw_albedo")
    if train_geo:
        assert_grad_close(vo.grad.numpy(), jg_off, "v_offsets")
    else:
        assert vo.grad is None and not np.asarray(jg_off).any()


def test_on_axis_view_edge_pixels():
    """An intended difference (ROADMAP section 3): viewed along its axis at
    32^2, the lattice sphere puts a few pixel centres exactly on shared
    edges (edge function 0 in float64). XLA on the CPU contracts the JAX
    z-test's edge products into multiply-adds, which moves such a pixel off
    the near triangle's edge, so the JAX side shows a triangle of the far
    side there, or another triangle at the same depth; the port, which
    contracts nothing (as K3 on the card), keeps the nearest covering
    triangle. Everywhere else the ids agree."""
    size = 32
    m = sphere_mesh_uv()
    cam = Camera.from_pose(orbit_camera(0.0, 0.0, 2.0), size, size, FOV, FOV)
    full = cam.arrays()["full_proj"]
    v_h = np.concatenate([m.v, np.ones((len(m.v), 1), np.float32)], 1)
    v_clip = (v_h @ full.T).astype(np.float32)
    jr = jmr.rasterize(jnp.asarray(v_clip), jnp.asarray(m.f), size, size)
    tr = tmr.rasterize(_np(v_clip), _np(m.f).long(), size, size)
    j_ids, t_ids = np.asarray(jr.tri_id), tr.tri_id.numpy()
    differ = np.argwhere(j_ids != t_ids)
    assert 0 < len(differ) <= 8, len(differ)
    # The same projection in float64, pixel centres at integer coordinates.
    c64 = v_h.astype(np.float64) @ full.astype(np.float64).T
    xy = ((c64[:, :2] / c64[:, 3:] + 1.0) * size - 1.0) * 0.5
    for y, x in differ:
        assert t_ids[y, x] > 0
        # The port's triangle is nearer, or as near (a shared vertex).
        assert tr.zbuf.numpy()[y, x] <= np.asarray(jr.zbuf)[y, x]
        p = xy[m.f[t_ids[y, x] - 1]]
        e = [(p[b, 0] - p[a, 0]) * (y - p[a, 1]) - (p[b, 1] - p[a, 1]) * (x - p[a, 0])
             for a, b in ((1, 2), (2, 0), (0, 1))]
        assert min(abs(v) for v in e) < 1e-9, e                       # on an edge
