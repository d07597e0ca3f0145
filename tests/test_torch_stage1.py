"""Stage-1 trainer of the PyTorch port against the JAX Stage1Trainer: a few
train_steps (known-view RGB/mask loss plus Zero123 SDS, a densify and an
opacity reset) from the same carried-over initial params, the same cameras
and the same injected noise; the PLY bytes; that the port imports no JAX;
and the device policy of its entry points."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance.loader import _backbone_from_params
from dreamgaussian_tpu.guidance.sds import Zero123Guidance as JZero123
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu.train import Stage1Trainer as JTrainer
from dreamgaussian_tpu.utils.config import Config
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance.sds import Zero123Guidance as TZero123
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig
from dreamgaussian_tpu_torch.scene.optim import adam_init
from dreamgaussian_tpu_torch.train import Stage1Trainer as TTrainer
from test_torch_guidance import UNET_KW, flax_random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CAP, NUM_PTS, STEPS, SEED = 32, 256, 160, 4, 0
VAE_KW = dict(block_out_channels=(4, 8), layers_per_block=1)   # latents at 1/2


def _opt():
    return Config(dict(
        iters=10, ref_size=SIZE, num_pts=NUM_PTS, sh_degree=0, batch_size=1,
        novel_resolutions=[SIZE, SIZE, SIZE], warmup_rgb_loss=True,
        density_start_iter=2, density_end_iter=10, densification_interval=3,
        opacity_reset_interval=4, elevation=0, radius=2.0, fovy=49.1,
        min_ver=-30, max_ver=30, invert_bg_prob=0.5,
    ))


def _target():
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    c = (SIZE - 1) / 2
    disc = ((xx - c) ** 2 + (yy - c) ** 2) < (SIZE * 0.3) ** 2
    rgb = np.ones((SIZE, SIZE, 3), np.float32)
    rgb[disc] = [0.9, 0.2, 0.1]
    return rgb, disc.astype(np.float32)


def _guidances():
    latent = SIZE // 2
    junet = JUNet(JUNetConfig(**UNET_KW, use_linear_projection=False))
    up = flax_random_params(junet, jnp.zeros((1, latent, latent, 8)), jnp.zeros((1,)),
                            jnp.zeros((1, 1, 16)), seed=0)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, SIZE, SIZE, 3)), seed=1)
    rng = np.random.default_rng(2)
    clip = (rng.normal(size=(1, 16)) * 0.1).astype(np.float32)
    vlat = (rng.normal(size=(1, latent, latent, 4)) * 0.1).astype(np.float32)
    cam = ((rng.normal(size=(20, 16)) * 0.05).astype(np.float32), np.zeros(16, np.float32))
    jg = JZero123(_backbone_from_params(junet, up, jvae, vp, SIZE), clip, vlat, cam,
                  image_size=SIZE)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tg = TZero123(weights.load_unet(TUNet(TUNetConfig(**UNET_KW)), up),
                  weights.load_vae_encoder(TVAE(TVAEConfig(**VAE_KW)), vp),
                  t(clip), t(vlat), (t(cam[0]), t(cam[1])), image_size=SIZE)
    return jg, tg


class JaxDraws:
    """The port's draw function answering with the samples the JAX trainer
    takes from its key, in the JAX trainer's split order."""

    def __init__(self, seed, num_pts):
        self.key, k_init = jax.random.split(jax.random.PRNGKey(seed))
        ks = dict(zip(("init_phi", "init_cos", "init_mu", "init_col"),
                      jax.random.split(k_init, 4)))
        self.init = {name: jax.random.uniform(k, (num_pts, 3) if name == "init_col" else (num_pts,))
                     for name, k in ks.items()}
        self.names = []

    def step_key(self):
        self.key, k_step = jax.random.split(self.key)
        return k_step

    def densify_key(self):
        self.key, k_d = jax.random.split(self.key)
        return k_d

    def __call__(self, name, shape, dist):
        self.names.append(name)
        if name in self.init:
            return torch.from_numpy(np.array(self.init[name]))
        if name == "sds_noise":     # step key, then the guidance fn's k_n
            key = jax.random.split(self.step_key())[1]
        elif name == "split":       # densify key
            key = self.densify_key()
        else:
            raise KeyError(name)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))


class JaxTrainDraws(JaxDraws):
    """JaxDraws for a whole ``train()`` of the JAX trainer, which runs its
    steps in host-split segments: chunks of at most ``scan_chunk`` steps at
    one novel-view size, cut after each densify or opacity-reset step. Each
    segment splits ``sub -> keys[k]`` for its steps, then ``sub -> dkeys[k]``
    (taken even though densify runs on the host), and each densify step
    after it splits ``k_d`` (dreamgaussian_tpu/train/stage1.py ``train``,
    ``train_segment``, ``_scan_segment``)."""

    def __init__(self, seed, num_pts, opt, scan_chunk=50):
        super().__init__(seed, num_pts)
        iters = opt.get("iters", 500)
        ladder = opt.get("novel_resolutions", [128, 256, 512])

        def size(s):
            ratio = min(1.0, s / iters)
            return ladder[0] if ratio < 0.3 else (ladder[1] if ratio < 0.6 else ladder[2])

        def flags(s):
            win = opt.get("density_start_iter", 100) <= s <= opt.get("density_end_iter", 3000)
            return (win and s % opt.get("densification_interval", 100) == 0,
                    win and s % opt.get("opacity_reset_interval", 700) == 0)

        self.step_keys, self.densify_keys = [], []
        step = 0
        while step < iters:
            k = 1
            while k < scan_chunk and step + k < iters and size(step + k + 1) == size(step + 1):
                k += 1
            end = step + k
            while step < end:
                nxt = step + 1
                while nxt < end and not any(flags(nxt)):
                    nxt += 1
                self.key, sub = jax.random.split(self.key)
                self.step_keys += list(jax.random.split(sub, nxt - step))
                self.key, _ = jax.random.split(self.key)       # dkeys
                step = nxt
                if flags(step)[0]:
                    self.key, k_d = jax.random.split(self.key)
                    self.densify_keys.append(k_d)

    def step_key(self):
        return self.step_keys.pop(0)

    def densify_key(self):
        return self.densify_keys.pop(0)


def test_train_steps_follow_jax_trainer(tmp_path):
    rgb, mask = _target()
    jg, tg = _guidances()
    jt = JTrainer(_opt(), ref_rgb=rgb, ref_mask=mask, capacity=CAP, seed=SEED,
                  guidance_fns=((1.0, jg.guidance_fn()),))
    draws = JaxDraws(SEED, NUM_PTS)
    tt = TTrainer(_opt(), ref_rgb=rgb, ref_mask=mask, capacity=CAP, seed=SEED,
                  guidance_fns=((1.0, tg.guidance_fn()),), device="cpu", draw=draws)
    # The port's own init from the injected uniforms agrees to float32 ulps;
    # then carry the JAX params over exactly.
    for k, v in jt.params.items():
        np.testing.assert_allclose(tt.params[k].numpy(), np.asarray(v), rtol=2e-5, atol=1e-6)
    tt.params, tt.aux = weights.gaussians_from_numpy(jax.device_get(jt.params),
                                                      jax.device_get(jt.aux), device="cpu")
    tt.adam = adam_init(tt.params)

    for step in range(1, STEPS + 1):
        jl = float(jt.train_step())
        tl = float(tt.train_step())
        # float32 renders, nets and reductions in another order: 1e-4.
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step}")
    assert draws.names.count("sds_noise") == STEPS and draws.names.count("split") == 1
    np.testing.assert_array_equal(tt.aux.alive.numpy(), np.asarray(jt.aux.alive))
    # Adam divides by sqrt(v): where a gradient is within float32 noise of
    # zero, the noise decides part of that step. Every parameter stays
    # within 1% of the distance its group's learning rate allows over the
    # steps (a sign flip of a whole step would exceed it); the typical one
    # agrees to float32 rounding.
    lr = {"xyz": 1e-2, "f_dc": 1e-2, "f_rest": 5e-4, "opacity": 5e-2,
          "scaling": 5e-3, "rotation": 5e-3}
    for k, v in jt.params.items():
        ref, got = np.asarray(v), tt.params[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.01 * STEPS * lr[k], err_msg=k)
        if ref.size:
            assert np.median(np.abs(got - ref)) <= 1e-6, k

    # PLY bytes: the port writes the JAX trainer's state byte for byte.
    tt.params, tt.aux = weights.gaussians_from_numpy(jax.device_get(jt.params),
                                                      jax.device_get(jt.aux), device="cpu")
    jt.save_ply(str(tmp_path / "j.ply"))
    tt.save_ply(str(tmp_path / "t.ply"))
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def test_rgb_alpha_training_approaches_target():
    """Without guidance, 40 steps on the known view pull the render toward
    the reference (the JAX suite's overfit check, on the port)."""
    rgb, mask = _target()
    opt = _opt()
    opt.update(iters=40, num_pts=256, warmup_rgb_loss=False, density_start_iter=10,
               density_end_iter=30, densification_interval=10, opacity_reset_interval=10000)
    tt = TTrainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=512, device="cpu")
    err0 = float(torch.mean((tt.render_view(tt.fixed_cam).image - tt.ref_rgb) ** 2))
    losses = [float(tt.train_step()) for _ in range(40)]
    err1 = float(torch.mean((tt.render_view(tt.fixed_cam).image - tt.ref_rgb) ** 2))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert err1 < 0.5 * err0, (err0, err1)


def test_ladder_and_render_view():
    opt = _opt()
    opt["novel_resolutions"] = [32, 64, 128]
    tt = TTrainer(opt, capacity=CAP, device="cpu")
    assert [tt.novel_size_for(s) for s in (1, 2, 3, 5, 6, 10)] == [32, 32, 64, 64, 128, 128]
    out = tt.render_view(tt.fixed_cam)
    assert out.image.shape == (SIZE, SIZE, 3) and bool(torch.isfinite(out.image).all())


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dreamgaussian_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dreamgaussian_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('dreamgaussian_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20, res.stdout


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dreamgaussian_tpu_torch.guidance.realarch import random_zero123_guidance
    from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrainer(_opt(), capacity=CAP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_zero123_guidance()
    z = torch.zeros
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_gaussians(z(4, 3), z(4, 3), z(4, 4), z(4), z(4, 1, 3), z(4, 4), z(4, 4),
                         z(3), z(2), 32, 32, z(3))
    TTrainer(_opt(), capacity=CAP, device="cpu")
