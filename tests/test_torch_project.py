"""SH, quaternion and projection math of the PyTorch port against the JAX
package: forward values, and jax.grad against torch autograd, on the same
numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.ops import project as jproj
from dreamgaussian_tpu.ops import quat as jquat
from dreamgaussian_tpu.ops import sh as jsh
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.ops import project as tproj
from dreamgaussian_tpu_torch.ops import quat as tquat
from dreamgaussian_tpu_torch.ops import sh as tsh

# Both sides evaluate the same float32 expressions; XLA and torch may
# order a few sums differently, so values agree to a few float32 ulps.
RTOL, ATOL = 2e-5, 2e-6


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_value_and_grad(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(size=(50, 25, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    w = rng.normal(size=(50, 3)).astype(np.float32)
    jv, (jgc, jgd) = jax.value_and_grad(
        lambda c, d: jnp.sum(jsh.eval_sh(deg, c, d) * w), argnums=(0, 1)
    )(coeffs, dirs)
    c, d = _t(coeffs, True), _t(dirs, True)
    tv = torch.sum(tsh.eval_sh(deg, c, d) * _t(w))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=RTOL, atol=ATOL)
    # Degree 0 does not read the directions: torch leaves no gradient.
    d_grad = d.grad.numpy() if d.grad is not None else np.zeros_like(dirs)
    np.testing.assert_allclose(d_grad, np.asarray(jgd), rtol=1e-4, atol=1e-5)


def test_quat_functions():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = np.exp(rng.normal(size=(40, 3))).astype(np.float32)
    np.testing.assert_allclose(tquat.normalize_quat(_t(q)).numpy(),
                               np.asarray(jquat.normalize_quat(q)), rtol=RTOL, atol=ATOL)
    qn = np.asarray(jquat.normalize_quat(q))
    np.testing.assert_allclose(tquat.quat_to_rotmat(_t(qn)).numpy(),
                               np.asarray(jquat.quat_to_rotmat(qn)), rtol=RTOL, atol=ATOL)
    for a, b in zip(tquat.build_covariance6(_t(s), _t(q)), jquat.build_covariance6(s, q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def _scene(n=120, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        (rng.normal(size=(n, 3)) * 0.5).astype(f),
        np.exp(rng.uniform(-4, -2, size=(n, 3))).astype(f),
        rng.normal(size=(n, 4)).astype(f),
        rng.uniform(0.05, 0.95, size=n).astype(f),
        (rng.normal(size=(n, 4, 3)) * 0.3).astype(f),
    )


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_project_values_and_grads(sh_degree):
    xyz, scale, quat, op, shs = _scene()
    alive = np.arange(xyz.shape[0]) % 7 != 0
    cam = Camera.from_pose(orbit_camera(15, 40, 2.0), 64, 48, 0.9, 0.8)
    a = cam.arrays()
    rng = np.random.default_rng(5)
    w = {k: rng.normal(size=s).astype(np.float32)
         for k, s in (("mean2d", (120, 2)), ("depth", (120,)), ("conic", (120, 3)),
                      ("color", (120, 3)))}

    def jloss(xyz, scale, quat, shs):
        p = jproj.project_gaussians(xyz, scale, quat, op, shs, a["view"], a["full_proj"],
                                    a["campos"], a["tanfov"], 64, 48, sh_degree=sh_degree,
                                    alive=alive)
        return sum(jnp.sum(getattr(p, k) * v) for k, v in w.items()), p

    (jl, jp), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        xyz, scale, quat, shs)
    targs = [_t(x, True) for x in (xyz, scale, quat, shs)]
    tp = tproj.project_gaussians(targs[0], targs[1], targs[2], _t(op), targs[3],
                                 *(_t(a[k]) for k in ("view", "full_proj", "campos", "tanfov")),
                                 64, 48, sh_degree=sh_degree, alive=_t(alive))
    tl = sum(torch.sum(getattr(tp, k) * _t(v)) for k, v in w.items())
    tl.backward()
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    for k in ("mean2d", "depth", "conic", "color"):
        np.testing.assert_allclose(getattr(tp, k).detach().numpy(), np.asarray(getattr(jp, k)),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    # Conics of small gaussians reach 1e2..1e3: their gradients carry
    # relative float32 error of a few 1e-5 through the 2x2 inverse.
    for name, tg, jgr in zip(("xyz", "scale", "quat", "shs"), targs, jg):
        ref = np.asarray(jgr)
        np.testing.assert_allclose(tg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


def _zero_colour_sh():
    """A float32 SH DC coefficient c with fl(C0 * c) + 0.5 == 0 exactly, so
    the colour sits on its floor of 0."""
    c0 = np.float32(0.28209479177387814)
    c = np.float32(-0.5) / c0
    for _ in range(64):
        if c0 * c + np.float32(0.5) == 0:
            return c
        c = np.nextafter(c, np.float32(0.0 if c0 * c < np.float32(-0.5) else -10.0))
    raise AssertionError("no float32 coefficient gives a colour of exactly 0")


def test_gradient_at_clamp_ties_matches_jax():
    """Values exactly on a bound: jnp.clip / jnp.maximum pass half of the
    gradient there and the port's clamp does the same. Gaussian 0 has
    pv_x / tz exactly on the frustum clamp +1.3*tanfovx (identity view);
    gaussian 1 has a colour of exactly 0."""
    view = np.eye(4, dtype=np.float32)
    tan = np.float32(0.5)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[3, 2] = 1.0
    proj[2, 2], proj[2, 3] = 100 / 99.99, -1.0 / 99.99
    lim = np.float32(1.3) * tan
    xyz = np.array([[lim, 0.1, 1.0], [0.2, -0.1, 2.0], [-0.3, 0.2, 1.5]], np.float32)
    scale = np.full((3, 3), 0.05, np.float32) * np.array([[1.0, 2.0, 0.5]], np.float32)
    quat = np.array([[1, 0.2, 0.1, 0.3], [0.5, 0.5, 0.1, 0.2], [1, 0, 0, 0]], np.float32)
    shs = np.full((3, 1, 3), 0.4, np.float32)
    shs[1] = _zero_colour_sh()
    op = np.full(3, 0.5, np.float32)
    campos, tanfov = np.zeros(3, np.float32), np.array([tan, tan], np.float32)
    rng = np.random.default_rng(0)
    w_conic = rng.normal(size=(3, 3)).astype(np.float32)
    w_color = rng.normal(size=(3, 3)).astype(np.float32)

    def jloss(xyz, shs):
        p = jproj.project_gaussians(xyz, scale, quat, op, shs, view, proj, campos, tanfov, 64, 64)
        return jnp.sum(p.conic * w_conic) + jnp.sum(p.color * w_color), p

    (_, jp), (jg_xyz, jg_shs) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(xyz, shs)
    assert float(xyz[0, 0] / xyz[0, 2]) == float(lim) and not np.asarray(jp.color)[1].any()
    t_xyz, t_shs = _t(xyz, True), _t(shs, True)
    tp = tproj.project_gaussians(t_xyz, _t(scale), _t(quat), _t(op), t_shs, _t(view), _t(proj),
                                 _t(campos), _t(tanfov), 64, 64)
    assert not tp.color[1].any()
    (torch.sum(tp.conic * _t(w_conic)) + torch.sum(tp.color * _t(w_color))).backward()
    assert np.abs(np.asarray(jg_shs)[1]).min() > 0       # half, not zero
    np.testing.assert_allclose(t_shs.grad.numpy(), np.asarray(jg_shs), rtol=1e-5)
    ref = np.asarray(jg_xyz)
    np.testing.assert_allclose(t_xyz.grad.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    # The tie is live: off the bound the gradient of the same gaussian differs.
    off = xyz.copy()
    off[0, 0] *= np.float32(0.999)
    g_off = np.asarray(jax.grad(lambda x: jloss(x, shs)[0])(off))
    assert np.abs(g_off[0] - ref[0]).max() > 1e-3 * np.abs(ref[0]).max()
