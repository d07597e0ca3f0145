"""Zero123 guidance of the PyTorch port against the JAX package: UNet and
VAE encoder on weights carried across from a narrow flax init, the noise
schedule, and the SDS loss and its image gradient with the same injected
noise, at a 512->256 (antialiased) and a 128->256 resize."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance import scheduler as jsch
from dreamgaussian_tpu.guidance import sds as jsds
from dreamgaussian_tpu.guidance.loader import _backbone_from_params
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance import scheduler as tsch
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig

UNET_KW = dict(   # one level: every block kind, little to compile
    in_channels=8, block_out_channels=(8,), layers_per_block=1,
    cross_attention_dim=16, num_attention_heads=2,
    down_block_types=("CrossAttnDownBlock2D",), up_block_types=("CrossAttnUpBlock2D",),
)
VAE_KW = dict(block_out_channels=(4, 4, 4, 8), layers_per_block=1)
IMAGE = 256


def _np(x):
    return torch.from_numpy(np.array(x))


def flax_random_params(module, *init_args, seed=0):
    """Random flax parameters of ``module`` in its init's tree, as numpy:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), biases ~
    N(0, 0.1^2). The tree comes from ``jax.eval_shape`` of the flax init
    (nothing to compile); unlike the init's values (scales 1, biases 0),
    these also test that norm and bias parameters are carried across."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            x = 0.1 * x + (1.0 if name == "scale" else 0.0)
        return x.astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def nets():
    """Narrow flax UNet + VAE and their torch twins on the same weights."""
    latent = IMAGE // 8
    junet = JUNet(JUNetConfig(**UNET_KW, use_linear_projection=False))
    up = flax_random_params(junet, jnp.zeros((1, latent, latent, 8)), jnp.zeros((1,)),
                            jnp.zeros((1, 1, 16)), seed=0)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, 64, 64, 3)), seed=1)
    tunet = weights.load_unet(TUNet(TUNetConfig(**UNET_KW)), up)
    tvae = weights.load_vae_encoder(TVAE(TVAEConfig(**VAE_KW)), vp)
    return junet, up, jvae, vp, tunet, tvae


def test_unet_matches_on_carried_weights():
    junet, up, _, _, tunet, _ = nets()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    ctx = rng.normal(size=(2, 1, 16)).astype(np.float32)
    j = np.asarray(jax.jit(junet.apply)(up, x, t, ctx))
    with torch.no_grad():
        tt = tunet(_np(x), _np(t), _np(ctx)).numpy()
    # float32 convolutions and attention summed in another order.
    np.testing.assert_allclose(tt, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def test_vae_encoder_matches_on_carried_weights():
    _, _, jvae, vp, _, tvae = nets()
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    j = np.asarray(jax.jit(lambda p, x: jvae.apply(p, x, method=jvae.encode))(vp, x))
    with torch.no_grad():
        tt = tvae.encode(_np(x)).numpy()
    np.testing.assert_allclose(tt, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def test_scheduler_add_noise_matches():
    js, ts = jsch.DDIMScheduler(), tsch.DDIMScheduler()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    n = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    t = np.array([20, 500, 980], np.int32)
    np.testing.assert_allclose(ts.add_noise(_np(x), _np(n), _np(t).long()).numpy(),
                               np.asarray(js.add_noise(x, n, t)), rtol=1e-6, atol=1e-6)
    for ratio in (0.0, 0.3, 0.5123, 1.0):
        assert tsds.anneal_t(ratio, 1000, 20, 980) == int(jsds.anneal_t(jnp.float32(ratio), 1000, 20, 980))


@pytest.mark.parametrize("render", [512, 128])
def test_zero123_sds_loss_and_image_grad(render):
    junet, up, jvae, vp, tunet, tvae = nets()
    rng = np.random.default_rng(render)
    latent = IMAGE // 8
    clip = (rng.normal(size=(1, 16)) * 0.1).astype(np.float32)
    vlat = (rng.normal(size=(1, latent, latent, 4)) * 0.1).astype(np.float32)
    cam_w = (rng.normal(size=(20, 16)) * 0.05).astype(np.float32)
    cam_b = np.zeros(16, np.float32)
    jg = jsds.Zero123Guidance(_backbone_from_params(junet, up, jvae, vp, IMAGE), clip, vlat,
                              (cam_w, cam_b), image_size=IMAGE)
    tg = tsds.Zero123Guidance(tunet, tvae, _np(clip), _np(vlat), (_np(cam_w), _np(cam_b)),
                              image_size=IMAGE)
    images = rng.uniform(size=(1, render, render, 3)).astype(np.float32)
    cond = {"vers": np.array([12.0], np.float32), "hors": np.array([-70.0], np.float32),
            "radii": np.zeros(1, np.float32)}
    key = jax.random.PRNGKey(5)
    step_ratio = 0.37
    jfn = jg.guidance_fn()
    jl, jgrad = jax.value_and_grad(
        lambda im: jfn(im, {k: jnp.asarray(v) for k, v in cond.items()}, step_ratio, key)
    )(images)
    # The noise JAX draws inside the guidance fn (k_t, k_n = split(key)).
    _, k_n = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_n, (1, latent, latent, 4)))
    draws = []

    def draw(name, shape, dist):
        draws.append(name)
        assert name == "sds_noise" and tuple(shape) == noise.shape and dist == "normal"
        return _np(noise)

    t_images = _np(images).requires_grad_(True)
    tl = tg.guidance_fn()(t_images, {k: _np(v) for k, v in cond.items()}, step_ratio, draw)
    tl.backward()
    assert draws == ["sds_noise"]
    # The bilinear resize agrees to 1e-7 (antialiased downsampling); the
    # nets run float32 convolutions in another summation order.
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    ref = np.asarray(jgrad)
    np.testing.assert_allclose(t_images.grad.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
