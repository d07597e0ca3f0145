"""Stage 2 of the PyTorch port against the JAX package: the DDIM step at
every timestep of a 50-step schedule, the VAE decoder and the fake
guidance's nets on carried-across weights, Zero123's img2img refine with
the same injected noise (including the float32 first-step rule), three
``Stage2Trainer`` steps against the JAX trainer with the same cameras and
refine noise, the refined mesh's export and the checkpoint round trip, and
the device policy of the stage-2 entry points."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance import fake as jfake
from dreamgaussian_tpu.guidance import scheduler as jsch
from dreamgaussian_tpu.guidance import sds as jsds
from dreamgaussian_tpu.guidance.loader import _backbone_from_params
from dreamgaussian_tpu.guidance.unet import TinyUNet as JTinyUNet
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu.train import Stage2Trainer as JTrainer
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance import fake as tfake
from dreamgaussian_tpu_torch.guidance import scheduler as tsch
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet as TTinyUNet
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig
from dreamgaussian_tpu_torch.meshing.mesh import Mesh as TMesh
from dreamgaussian_tpu_torch.train import Stage2Trainer as TTrainer
from test_stage2 import sphere_mesh_uv, tiny_opt
from test_torch_guidance import UNET_KW, VAE_KW, flax_random_params
from torch_cpu_cases import one_torch_thread  # noqa: F401

REFINE_SIZE = 32            # Zero123's image_size in the tiny runs (latent 4x4)


def _np(x):
    return torch.from_numpy(np.array(x))


def test_ddim_step_at_every_timestep_of_a_50_step_schedule():
    js, ts = jsch.DDIMScheduler(), tsch.DDIMScheduler()
    steps = 50
    jt = js.set_timesteps(steps)
    np.testing.assert_array_equal(ts.set_timesteps(steps), jt)
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    rng = np.random.default_rng(0)
    for t in jt:
        x = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
        eps = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
        ref = np.asarray(js.step_with_spacing(eps, int(t), x, 1000 // steps))
        np.testing.assert_allclose(ts.step(_np(eps), int(t), _np(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


@functools.lru_cache(maxsize=None)
def nets():
    """Narrow flax UNet + VAE (encoder and decoder) and their torch twins."""
    latent = REFINE_SIZE // 8
    junet = JUNet(JUNetConfig(**UNET_KW, use_linear_projection=False))
    up = flax_random_params(junet, jnp.zeros((1, latent, latent, 8)), jnp.zeros((1,)),
                            jnp.zeros((1, 1, 16)), seed=0)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, REFINE_SIZE, REFINE_SIZE, 3)), seed=1)
    tunet = weights.load_unet(TUNet(TUNetConfig(**UNET_KW)), up)
    tvae = weights.load_vae(TVAE(TVAEConfig(**VAE_KW)), vp)
    return junet, up, jvae, vp, tunet, tvae


def test_vae_decoder_matches_on_carried_weights():
    _, _, jvae, vp, _, tvae = nets()
    z = np.random.default_rng(1).normal(size=(2, 6, 5, 4)).astype(np.float32)
    j = np.asarray(jax.jit(lambda p, z: jvae.apply(p, z, method=jvae.decode))(vp, z))
    with torch.no_grad():
        t = tvae.decode(_np(z)).numpy()
    assert t.shape == (2, 48, 40, 3)
    # float32 convolutions summed in another order.
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def test_encoder_alone_still_loads():
    _, _, _, vp, _, tvae = nets()
    enc_only = weights.load_vae_encoder(TVAE(TVAEConfig(**VAE_KW)), vp)
    for k, v in tvae.encoder.state_dict().items():
        assert torch.equal(enc_only.encoder.state_dict()[k], v), k


def test_fake_guidance_nets_match_on_carried_weights():
    """TinyUNet on weights carried over from a flax init, and the pooling
    VAE, against the JAX package's fake backbone pieces."""
    jnet = JTinyUNet(channels=16, context_dim=32, out_channels=4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    tt = np.array([30.0, 700.0], np.float32)
    ctx = rng.normal(size=(2, 1, 32)).astype(np.float32)
    p = flax_random_params(jnet, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,)),
                           jnp.zeros((1, 2, 32)), seed=4)
    tnet = weights.load_tiny_unet(TTinyUNet(in_channels=8), p)
    j = np.asarray(jax.jit(jnet.apply)(p, x, tt, ctx))
    with torch.no_grad():
        t = tnet(_np(x), _np(tt), _np(ctx)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())

    imgs = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    vae = tfake.PoolVAE(latent_size=8, image_size=64)
    np.testing.assert_allclose(vae.encode(_np(imgs)).numpy(),
                               np.asarray(jfake._pool_encode(8)(imgs)), atol=1e-6)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(vae.decode(_np(z)).numpy(),
                                  np.asarray(jfake._resize_decode(64)(z)))


def test_init_step_is_taken_in_float32():
    """At 50 refine steps, step_ratio 0.4 and 0.8 of the trainer give the
    float32 strengths 0.86 and 0.92: the first DDIM steps 43 and 46."""
    for ratio, first in ((0.4, 43), (0.8, 46), (0.02, 40), (1.0, 47)):
        strength = np.float32(ratio * 0.15 + 0.8)
        j = int(jnp.clip(jnp.floor(50 * jnp.float32(strength)).astype(jnp.int32), 0, 49))
        assert tsds.refine_init_step(50, strength) == j == first, (ratio, j)


def _guidances(stable=False):
    junet, up, jvae, vp, tunet, tvae = nets()
    rng = np.random.default_rng(2)
    latent = REFINE_SIZE // 8
    clip = (rng.normal(size=(1, 16)) * 0.1).astype(np.float32)
    vlat = (rng.normal(size=(1, latent, latent, 4)) * 0.1).astype(np.float32)
    cam = ((rng.normal(size=(20, 16)) * 0.05).astype(np.float32), np.zeros(16, np.float32))
    kw = dict(image_size=REFINE_SIZE, stable=stable, default_elevation=-10.0)
    jg = jsds.Zero123Guidance(_backbone_from_params(junet, up, jvae, vp, REFINE_SIZE), clip,
                              vlat, cam, **kw)
    tg = tsds.Zero123Guidance(tunet, tvae, _np(clip), _np(vlat), (_np(cam[0]), _np(cam[1])),
                              **kw)
    return jg, tg


class JaxRefineDraws:
    """The port's draw answering "refine_noise" with the samples the JAX
    trainer's fused refine takes: per step ``key_r`` from ``split(key)``,
    ``keys = split(key_r, n_fns)``, then ``normal(split(keys[i])[0])``."""

    def __init__(self, seed, n_fns=1):
        self.key = jax.random.PRNGKey(seed)
        self.n_fns = n_fns
        self.pending = []
        self.names = []

    def __call__(self, name, shape, dist):
        self.names.append(name)
        assert name == "refine_noise" and dist == "normal"
        if not self.pending:
            self.key, key_r = jax.random.split(self.key)
            self.pending = list(jax.random.split(key_r, self.n_fns))
        k_n, _ = jax.random.split(self.pending.pop(0))
        return _np(jax.random.normal(k_n, shape))


@pytest.mark.parametrize("strength", [0.803, 0.86, 0.92])
def test_zero123_refine_with_injected_noise(strength):
    """The img2img refine of a 64^2 batch of two at three strengths (10, 7
    and 4 UNet calls), stable-zero123 conditioning, the same noise."""
    jg, tg = _guidances(stable=True)
    rng = np.random.default_rng(int(strength * 1000))
    images = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    cond = {"vers": np.array([12.0, -20.0], np.float32),
            "hors": np.array([-70.0, 100.0], np.float32), "radii": np.zeros(2, np.float32)}
    key = jax.random.PRNGKey(11)
    jfn, gp = jg.refine_args(steps=50)
    j = np.asarray(jfn(images, {k: jnp.asarray(v) for k, v in cond.items()},
                       jnp.float32(strength), key, gp))
    k_n, _ = jax.random.split(key)

    def draw(name, shape, dist):
        assert name == "refine_noise" and dist == "normal"
        return _np(jax.random.normal(k_n, shape))

    tfn = tg.refine_fn(steps=50)
    t = tfn(_np(images), {k: _np(v) for k, v in cond.items()}, np.float32(strength), draw)
    assert t.shape == (2, REFINE_SIZE, REFINE_SIZE, 3) and not t.requires_grad
    # Up to ten narrow-UNet calls in float32 summed in another order, each
    # difference amplified by CFG (x9 at scale 5) and by the DDIM step's
    # 1/sqrt(alpha_t) (x14 at t = 980), then the decoder; images in [0, 1].
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)


def _disc_ref(size=32):
    yy, xx = np.mgrid[0:size, 0:size]
    c = (size - 1) / 2
    disc = ((xx - c) ** 2 + (yy - c) ** 2) < (size * 0.3) ** 2
    rgb = np.ones((size, size, 3), np.float32)
    rgb[disc] = [0.9, 0.2, 0.1]
    return rgb, disc.astype(np.float32)


STEPS = 3


def test_trainer_steps_follow_jax_trainer(tmp_path):
    """Three steps from the same sphere (texture 64^2, known view 32^2,
    novel views 64^2) with the known-view loss and Zero123 refine: the
    cameras and SSAA factors come from the same seed, the refine noise is
    injected. Loss and texture logits held after each step."""
    m = sphere_mesh_uv()
    rgb, mask = _disc_ref()
    jg, tg = _guidances()
    # Elevation 3: at 0 the known view looks along the lattice sphere's
    # axis, and a few pixel centres lie exactly on shared edges, where the
    # JAX z-test on the CPU differs (test_torch_mesh_render.py::
    # test_on_axis_view_edge_pixels).
    opt = tiny_opt(iters_refine=50, refine_steps=50, elevation=3)
    jt = JTrainer(opt, m, ref_rgb=rgb, ref_mask=mask, refine_fns=((0.7,) + jg.refine_args(steps=50),),
                  refine_image_size=REFINE_SIZE, seed=3)
    draws = JaxRefineDraws(3)
    tt = TTrainer(opt, sphere_mesh_uv(), ref_rgb=rgb, ref_mask=mask,
                  refine_fns=((0.7, tg.refine_fn(steps=50)),), refine_image_size=REFINE_SIZE,
                  seed=3, device="cpu", draw=draws)
    np.testing.assert_array_equal(tt.params["raw_albedo"].numpy(),
                                  np.asarray(jt.params["raw_albedo"]))
    lr = opt["texture_lr"]
    for step in range(1, STEPS + 1):
        jl = float(jt.train_step())
        tl = float(tt.train_step())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step}")
        ref = np.asarray(jt.params["raw_albedo"])
        got = tt.params["raw_albedo"].numpy()
        # Adam divides by sqrt(v): where a texel's gradient is within float32
        # noise of zero, the noise decides its step. Every texel stays
        # within 1% of one learning rate of the JAX texel; the typical one
        # agrees to float32 rounding.
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.01 * lr, err_msg=f"step {step}")
        moved = np.abs(ref - np.asarray(jt.state.raw_albedo)) > 0
        assert moved.mean() > 0.05, moved.mean()
        assert np.median(np.abs(got - ref)[moved]) <= 1e-5, step
    assert draws.names == ["refine_noise"] * STEPS
    assert tt.adam.count == STEPS


def test_export_mesh_and_checkpoint_round_trip(tmp_path):
    m = sphere_mesh_uv()
    tg = tfake.fake_zero123_guidance(image_size=32, device="cpu")
    opt = tiny_opt(train_geo=True)
    entry = ((1.0, tg.refine_fn(steps=10)),)
    tt = TTrainer(opt, m, refine_fns=entry, refine_image_size=32, seed=0, device="cpu")
    a0 = torch.sigmoid(tt.params["raw_albedo"]).numpy()
    v0 = m.v.copy()             # export_mesh writes into the trainer's mesh
    for _ in range(2):
        assert np.isfinite(float(tt.train_step()))
    path = str(tmp_path / "s2.npz")
    tt.save_checkpoint(path)
    with np.load(path) as data:
        assert sorted(data) == ["adam_count", "draw_state", "mu_raw_albedo", "mu_v_offsets",
                                "nu_raw_albedo", "nu_v_offsets", "p_raw_albedo", "p_v_offsets",
                                "step"]
    t2 = TTrainer(opt, sphere_mesh_uv(), refine_fns=entry, refine_image_size=32, seed=9,
                  device="cpu")
    t2.load_checkpoint(path)
    assert t2.step == 2 and t2.adam.count == 2
    for k in tt.params:
        assert torch.equal(t2.params[k], tt.params[k]), k
        assert torch.equal(t2.adam.mu[k], tt.adam.mu[k]) and torch.equal(t2.adam.nu[k], tt.adam.nu[k])
    # The draw resumes where it stood: both trainers take the same next step.
    torch.testing.assert_close(t2.draw("x", (5,), "normal"), tt.draw("x", (5,), "normal"))

    out = tt.export_mesh(str(tmp_path / "refined.obj"))
    assert np.abs(out.albedo - a0).max() > 0 and np.abs(out.v - v0).max() > 0
    back = TMesh.load(str(tmp_path / "refined.obj"), resize=False)
    np.testing.assert_array_equal(back.f, out.f)
    np.testing.assert_allclose(back.v, out.v, atol=1e-6)
    assert back.albedo.shape == (64, 64, 3)
    np.testing.assert_allclose(back.albedo, out.albedo, atol=1 / 255)


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrainer(tiny_opt(), sphere_mesh_uv())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfake.fake_zero123_guidance()
    TTrainer(tiny_opt(), sphere_mesh_uv(), device="cpu")
    g = tfake.fake_zero123_guidance(device="cpu")
    assert g.num_parameters() > 0
