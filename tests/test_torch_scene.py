"""Scene state and optimizer of the PyTorch port against the JAX package:
knn, Adam and expon_lr, random init, densify/prune/reset with the same
injected random samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.ops.knn import mean_knn_sq_dist as j_knn
from dreamgaussian_tpu.scene import gaussians as jg
from dreamgaussian_tpu.scene import optim as jo
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.ops.knn import mean_knn_sq_dist as t_knn
from dreamgaussian_tpu_torch.scene import gaussians as tg
from dreamgaussian_tpu_torch.scene import optim as to

def _np(x):
    return torch.from_numpy(np.array(x))


def _assert_tree_close(t_tree, j_tree, rtol=1e-6, atol=1e-6):
    for k in j_tree:
        np.testing.assert_allclose(t_tree[k].numpy(), np.asarray(j_tree[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_knn_matches():
    pts = np.random.default_rng(0).normal(size=(700, 3)).astype(np.float32)
    # Same |a|^2 + |b|^2 - 2ab formula; the matmul sums in another order.
    np.testing.assert_allclose(t_knn(_np(pts), block_size=256).numpy(),
                               np.asarray(j_knn(pts, k=3, block_size=256)), rtol=1e-5, atol=1e-7)


def test_expon_lr_matches():
    j = jo.expon_lr(1e-2, 2e-4, lr_delay_mult=0.02, max_steps=500)
    t = to.expon_lr(1e-2, 2e-4, lr_delay_mult=0.02, max_steps=500)
    for step in (0, 1, 7, 250, 499, 500, 800):
        np.testing.assert_allclose(t(step), float(j(float(step))), rtol=1e-6)
    jd = jo.expon_lr(1e-3, 1e-5, lr_delay_steps=10, lr_delay_mult=0.1, max_steps=100)
    td = to.expon_lr(1e-3, 1e-5, lr_delay_steps=10, lr_delay_mult=0.1, max_steps=100)
    for step in (0, 3, 10, 60):
        np.testing.assert_allclose(td(step), float(jd(float(step))), rtol=1e-6)


def test_adam_matches_over_steps():
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=(20, 3)).astype(np.float32) for k in ("a", "b")}
    lrs = {"a": 1e-2, "b": 5e-3}
    jp, js = dict(params), jo.adam_init(params)
    tp = {k: _np(v) for k, v in params.items()}
    ts = to.adam_init(tp)
    for i in range(4):
        grads = {k: (rng.normal(size=(20, 3)) * 10.0 ** -i).astype(np.float32) for k in params}
        jp, js = jo.adam_update(jp, grads, js, {k: jnp.float32(v) for k, v in lrs.items()})
        tp, ts = to.adam_update(tp, {k: _np(v) for k, v in grads.items()}, ts, lrs)
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-7)
    _assert_tree_close(ts.nu, js.nu, rtol=1e-6, atol=1e-12)
    assert ts.count == int(js.count) == 4


def _init_samples(key, num_pts):
    """The uniforms JAX's init_random draws from ``key``, by draw name."""
    k_phi, k_cos, k_mu, k_col = jax.random.split(key, 4)
    return {
        "init_phi": np.asarray(jax.random.uniform(k_phi, (num_pts,))),
        "init_cos": np.asarray(jax.random.uniform(k_cos, (num_pts,))),
        "init_mu": np.asarray(jax.random.uniform(k_mu, (num_pts,))),
        "init_col": np.asarray(jax.random.uniform(k_col, (num_pts, 3))),
    }


def _injected(samples):
    return lambda name, shape, dist: _np(samples[name]).reshape(shape)


def test_init_random_matches_with_injected_uniforms():
    key = jax.random.PRNGKey(3)
    jp, ja = jg.init_random(key, num_pts=300, capacity=512, radius=0.5, sh_degree=1)
    tp, ta = tg.init_random(_injected(_init_samples(key, 300)), num_pts=300, capacity=512,
                            radius=0.5, sh_degree=1, device="cpu")
    # cbrt against pow(1/3) and the knn matmul order: float32 ulps.
    _assert_tree_close(tp, jp, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))


def _trained_state(seed=4, cap=256, n=200):
    """A JAX state with live densify stats and varied scales/opacities."""
    rng = np.random.default_rng(seed)
    params, aux = jg.init_random(jax.random.PRNGKey(seed), num_pts=n, capacity=cap)
    params = dict(params)
    params["scaling"] = params["scaling"].at[:n].add(
        jnp.asarray(rng.uniform(-1.5, 1.5, size=(n, 3)), jnp.float32))
    params["opacity"] = params["opacity"].at[:n].set(
        jnp.asarray(rng.normal(size=(n, 1)) * 3.0, jnp.float32))
    params["rotation"] = params["rotation"].at[:n].set(
        jnp.asarray(rng.normal(size=(n, 4)), jnp.float32))
    aux = aux._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 0.05, size=cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 4, size=cap), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 3, size=cap), jnp.float32),
    )
    adam = jo.adam_init(params)
    adam = adam._replace(mu={k: v + 0.1 for k, v in adam.mu.items()},
                         nu={k: v + 0.2 for k, v in adam.nu.items()})
    return params, adam, aux


def _to_port(params, adam, aux):
    tp, ta = weights.gaussians_from_numpy(jax.device_get(params), jax.device_get(aux))
    ts = to.AdamState(mu={k: _np(v) for k, v in adam.mu.items()},
                      nu={k: _np(v) for k, v in adam.nu.items()}, count=int(adam.count))
    return tp, ts, ta


@pytest.mark.parametrize("cap", [200, 600])   # full (drops candidates) and roomy
def test_densify_and_prune_matches_with_injected_jitter(cap):
    jp, jadam, jaux = _trained_state(cap=cap)
    if cap == 200:   # every slot taken and most gaussians hot: candidates drop
        jaux = jaux._replace(grad_accum=jaux.grad_accum * 10.0)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (2,) + jp["scaling"].shape))
    kw = dict(grad_threshold=0.01, min_opacity=0.01, extent=4.0, percent_dense=0.01)
    jp2, jadam2, jaux2, jdropped = jg.densify_and_prune(jp, jadam, jaux, key, **kw)
    tp, tadam, taux = _to_port(jp, jadam, jaux)
    tp2, tadam2, taux2, tdropped = tg.densify_and_prune(tp, tadam, taux, _np(noise), **kw)
    assert int(tdropped) == int(jdropped)
    if cap == 200:
        assert int(tdropped) > 0
    np.testing.assert_array_equal(taux2.alive.numpy(), np.asarray(jaux2.alive))
    # Same selections and slots; the split offsets are a 3x3 product.
    _assert_tree_close(tp2, jp2, rtol=1e-6, atol=1e-6)
    _assert_tree_close(tadam2.mu, jadam2.mu, atol=0)
    for f in ("max_radii2d", "grad_accum", "denom"):
        assert not getattr(taux2, f).any()


def test_prune_reset_and_stats_match():
    jp, jadam, jaux = _trained_state(seed=5)
    tp, tadam, taux = _to_port(jp, jadam, jaux)
    jp2, jadam2, jaux2 = jg.prune_only(jp, jadam, jaux, min_opacity=0.01, extent=1.0,
                                       max_screen_size=1.0)
    tp2, tadam2, taux2 = tg.prune_only(tp, tadam, taux, min_opacity=0.01, extent=1.0,
                                       max_screen_size=1.0)
    np.testing.assert_array_equal(taux2.alive.numpy(), np.asarray(jaux2.alive))
    _assert_tree_close(tadam2.nu, jadam2.nu, atol=0)

    jp3, jadam3 = jg.reset_opacity(jp, jadam)
    tp3, tadam3 = tg.reset_opacity(tp, tadam)
    _assert_tree_close(tp3, jp3, rtol=1e-6, atol=1e-6)
    assert not tadam3.mu["opacity"].any() and not tadam3.nu["opacity"].any()

    rng = np.random.default_rng(6)
    g2d = rng.normal(size=(256, 2)).astype(np.float32)
    radii = rng.integers(0, 3, size=256).astype(np.int32)
    ja = jg.accumulate_stats(jaux, jnp.asarray(g2d), jnp.asarray(radii))
    ta = tg.accumulate_stats(taux, _np(g2d), _np(radii))
    for f in ("max_radii2d", "grad_accum", "denom"):
        np.testing.assert_allclose(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)),
                                   rtol=1e-6, err_msg=f)
