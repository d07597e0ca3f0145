"""MVDream text-to-3D of the PyTorch port against the JAX package: the
4-view UNet (joint self-attention, camera MLP) on carried weights,
``mvdream_camera``, ``MVDreamGuidance`` (SDS loss and image gradient with
one shared timestep and no w(t); the [uncond, cond] refine), the single-file
LDM conversions (UNet, VAE, OpenCLIP text tower) against JAX's
``convert_ldm_*`` / ``convert_open_clip_text`` with the strict load both
ways, and ``load_mvdream`` on a tiny ``.pt`` against JAX's. The trainers
and the CLIs on ``configs/text_mv.yaml``: ``test_torch_text_trainers.py``."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance import convert as jconvert
from dreamgaussian_tpu.guidance import loader as jloader
from dreamgaussian_tpu.guidance import sds as jsds
from dreamgaussian_tpu.guidance import synthetic as jsynth
from dreamgaussian_tpu.guidance.loader import _backbone_from_params
from dreamgaussian_tpu.guidance.text_encoder import OpenCLIPTextConfig, OpenCLIPTextEncoder
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance import convert as tconvert
from dreamgaussian_tpu_torch.guidance import loader as tloader
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.clip import CLIPTextConfig, CLIPTextModel
from dreamgaussian_tpu_torch.guidance.text_encoder import encode_open_clip_text
from dreamgaussian_tpu_torch.guidance.unet import MVDREAM_CONFIG
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig
from dreamgaussian_tpu_torch.utils.camera import orbit_camera
from test_torch_guidance import flax_random_params
from torch_cpu_cases import one_torch_thread  # noqa: F401

CTX = 24
IMAGE = 32                 # guidance image size; VAE (4, 8) gives 16^2 latents
MV_KW = dict(in_channels=4, block_out_channels=(32, 64), layers_per_block=1,
             cross_attention_dim=CTX, num_attention_heads=2, use_linear_projection=True,
             down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), num_views=4)
VAE_KW = dict(block_out_channels=(4, 8), layers_per_block=1)
TEXT = OpenCLIPTextConfig(vocab_size=1024, width=CTX, heads=1, layers=3, context_length=16)


def _np(x):
    return torch.from_numpy(np.array(x))


def _poses(groups, seed):
    """Orbit poses of ``groups`` 4-view groups (hor + 90 i), [4 groups, 4, 4]."""
    rng = np.random.default_rng(seed)
    return np.stack([orbit_camera(float(ver), float(hor + 90 * i), 2.5)
                     for ver, hor in zip(rng.uniform(-30, 30, groups), rng.uniform(-180, 180, groups))
                     for i in range(4)]).astype(np.float32)


# -- the 4-view UNet and the camera ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def nets():
    latent = IMAGE // 2
    junet = JUNet(JUNetConfig(**MV_KW))
    up = flax_random_params(junet, jnp.zeros((4, latent, latent, 4)), jnp.zeros((4,)),
                            jnp.zeros((4, 5, CTX)), jnp.zeros((4, 16)), seed=20)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, IMAGE, IMAGE, 3)), seed=21)
    tunet = weights.load_unet(TUNet(TUNetConfig(**MV_KW)), up)
    tvae = weights.load_vae(TVAE(TVAEConfig(**VAE_KW)), vp)
    return junet, up, jvae, vp, tunet, tvae


def test_mvdream_camera_matches_jax():
    poses = _poses(3, 0)
    got = tsds.mvdream_camera(_np(poses)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsds.mvdream_camera(poses)), atol=1e-7)
    assert got.shape == (12, 16)
    np.testing.assert_allclose(np.linalg.norm(got.reshape(12, 4, 4)[:, :3, 3], axis=-1), 1.0,
                               rtol=1e-6)


def test_mvdream_unet_matches_on_carried_weights():
    """Two groups of 4 views (joint self-attention) with the camera MLP; the
    views of a group change each other's prediction, other groups' do not,
    and the camera changes it (at 64 channels: GroupNorm over single
    channels, as at 32 and fewer, would take the time embedding out)."""
    junet, up, _, _, tunet, _ = nets()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    t = np.full(8, 420.0, np.float32)
    ctx = rng.normal(size=(8, 5, CTX)).astype(np.float32)
    cam = np.asarray(jsds.mvdream_camera(_poses(2, 1)))
    j = np.asarray(jax.jit(junet.apply)(up, x, t, ctx, cam))
    with torch.no_grad():
        got = tunet(_np(x), _np(t), _np(ctx), camera=_np(cam)).numpy()
        np.testing.assert_allclose(got, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())
        x2 = x.copy()
        x2[1] += 1.0                                      # another view of group 0
        moved = tunet(_np(x2), _np(t), _np(ctx), camera=_np(cam)).numpy()
        no_cam = tunet(_np(x), _np(t), _np(ctx)).numpy()
    assert np.abs(moved[0] - got[0]).max() > 1e-4 and np.array_equal(moved[4:], got[4:])
    assert np.abs(no_cam - got).max() > 1e-4


# -- MVDreamGuidance ----------------------------------------------------------------------


def _mv_guidances():
    junet, up, jvae, vp, tunet, tvae = nets()
    rng = np.random.default_rng(4)
    emb = {"pos": (rng.normal(size=(5, CTX)) * 0.5).astype(np.float32),
           "neg": (rng.normal(size=(5, CTX)) * 0.5).astype(np.float32)}
    jg = jsds.MVDreamGuidance(_backbone_from_params(junet, up, jvae, vp, IMAGE), emb,
                              image_size=IMAGE)
    tg = tsds.MVDreamGuidance(tunet, tvae, {k: _np(v) for k, v in emb.items()},
                              image_size=IMAGE)
    return jg, tg


@pytest.mark.parametrize("anneal", [True, False], ids=["anneal", "drawn_t"])
def test_mvdream_guidance_loss_and_image_grad(anneal):
    """Two groups of 4 views from 48^2 renders: one shared timestep, CFG 100
    [cond, uncond], no w(t). float32, CFG x100 on a difference of the
    nets' summation orders: the loss to 1e-4 (seen 1e-6), the gradient to
    2e-4 of its largest entry (seen 3e-5)."""
    from test_torch_text import _hold_sds

    jg, tg = _mv_guidances()
    jg.anneal = tg.anneal = anneal
    images = np.random.default_rng(5).uniform(size=(8, 48, 48, 3)).astype(np.float32)
    cond = {"poses": _poses(2, 2)}
    draws = _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, cond, 0.35,
                      jax.random.PRNGKey(8), tg, 1e-4, 2e-4)
    assert draws == (["sds_noise"] if anneal else ["sds_t", "sds_noise"])


@pytest.mark.parametrize("strength", [0.8, 0.95])
def test_mvdream_refine_with_injected_noise(strength):
    """The 4-view img2img refine, [uncond, cond] CFG at 100, against JAX's
    fused refine with the same noise; images in [0, 1]: 1e-4."""
    from test_torch_text import _refine_draw

    jg, tg = _mv_guidances()
    images = np.random.default_rng(6).uniform(size=(4, 48, 48, 3)).astype(np.float32)
    poses = _poses(1, 3)
    key = jax.random.PRNGKey(13)
    j = np.asarray(jg.refine_fn(steps=10)(images, {"poses": jnp.asarray(poses)},
                                          jnp.float32(strength), key))
    t = tg.refine_fn(steps=10)(_np(images), {"poses": _np(poses)}, np.float32(strength),
                               _refine_draw(key))
    assert t.shape == (4, IMAGE, IMAGE, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)


# -- the LDM layout ---------------------------------------------------------------------

TINY_UNET = JUNetConfig(**MV_KW)
TINY_VAE = JVAEConfig(block_out_channels=(8, 16), layers_per_block=1)


@functools.lru_cache(maxsize=None)
def ldm_state():
    """JAX's synthetic MVDream LDM checkpoint (the OpenCLIP tower with a
    1024-token vocabulary) as torch tensors, with the schedule buffers and the
    text tower's projection and logit scale a real file holds."""
    sd = jsynth.synth_ldm_checkpoint(TINY_UNET, TINY_VAE, TEXT, seed=30)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    for name in tsynth.LDM_SCHEDULE:
        sd[name] = torch.linspace(1e-4, 2e-2, 1000)
    sd["cond_stage_model.model.logit_scale"] = torch.tensor(4.6)
    return sd


def test_port_writer_spells_the_jax_ldm_keys():
    t_unet = TUNetConfig(**MV_KW)
    t_vae = TVAEConfig(block_out_channels=(8, 16), layers_per_block=1)
    want = {k: tuple(v.shape) for k, v in ldm_state().items()}
    got = dict(tsynth.ldm_unet_spec(t_unet) + tsynth.ldm_vae_spec(t_vae)
               + tsynth.open_clip_text_spec(CTX, TEXT.layers, TEXT.vocab_size, 16)
               + [(n, (1000,)) for n in tsynth.LDM_SCHEDULE])
    assert got == want


def test_ldm_conversions_equal_the_jax_conversions():
    """UNet, VAE and OpenCLIP tower renamed onto the port's modules and loaded
    strictly, against JAX's convert_ldm_unet / convert_ldm_vae /
    convert_open_clip_text carried over: every parameter equal. The
    architecture read from the shapes is the one written."""
    sd = ldm_state()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    parts = tconvert.split_ldm(sd)
    ucfg = tconvert.ldm_unet_config(parts["unet"], TUNetConfig(num_views=4, num_attention_heads=2))
    assert ucfg == TUNetConfig(**MV_KW)
    unet = tconvert.load_into(TUNet(ucfg), tconvert.ldm_unet_state(parts["unet"], ucfg))
    ref = weights.load_unet(TUNet(ucfg), jconvert.convert_ldm_unet(np_sd, TINY_UNET))
    vcfg = tconvert.ldm_vae_config(parts["vae"], TVAEConfig())
    assert vcfg == TVAEConfig(block_out_channels=(8, 16), layers_per_block=1)
    vae = tconvert.load_into(TVAE(vcfg), tconvert.ldm_vae_state(parts["vae"], vcfg))
    ref_vae = weights.load_vae(TVAE(vcfg), jconvert.convert_ldm_vae(np_sd, TINY_VAE))
    text_cfg = CLIPTextConfig(vocab_size=1024, hidden_size=CTX, intermediate_size=4 * CTX,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=16, hidden_act="gelu")
    text = tconvert.load_into(CLIPTextModel(text_cfg), tconvert.open_clip_text_state(parts["text"]))
    ref_text = weights.load_open_clip_text(CLIPTextModel(text_cfg),
                                           jconvert.convert_open_clip_text(np_sd, TEXT))
    for got, want in ((unet, ref), (vae, ref_vae), (text, ref_text)):
        want_sd = want.state_dict()
        assert sorted(got.state_dict()) == sorted(want_sd)
        for k, v in got.state_dict().items():
            assert torch.equal(v, want_sd[k]), k


def test_open_clip_tower_matches_jax():
    """The OpenCLIP tower on the port's text model (penultimate: the last of
    three blocks skipped, 2 heads) against JAX's OpenCLIPTextEncoder through
    convert_open_clip_text, float32: 1e-5 of the largest state."""
    np_sd = {k: v.numpy() for k, v in ldm_state().items()}
    jcfg = OpenCLIPTextConfig(vocab_size=1024, width=CTX, heads=2, layers=3, context_length=16)
    ids = np.random.default_rng(7).integers(0, 1024, size=(3, 16)).astype(np.int32)
    j = np.asarray(OpenCLIPTextEncoder(jcfg).apply(jconvert.convert_open_clip_text(np_sd, jcfg),
                                                   jnp.asarray(ids)))
    cfg = CLIPTextConfig(vocab_size=1024, hidden_size=CTX, intermediate_size=4 * CTX,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
                         hidden_act="gelu")
    tower = tconvert.load_into(CLIPTextModel(cfg),
                               tconvert.open_clip_text_state(tconvert.split_ldm(ldm_state())["text"]))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, j, atol=1e-5 * np.abs(j).max(), rtol=0)


def test_full_width_mvdream_layout_reads_as_mvdream_config():
    """The full-width file's shapes (on the meta device) give MVDREAM_CONFIG
    and fill every parameter of its UNet and VAE, and an OpenCLIP ViT-H tower
    of 23 used blocks."""
    from dreamgaussian_tpu_torch.guidance.text_encoder import open_clip_text_config

    spec = (tsynth.ldm_unet_spec(MVDREAM_CONFIG) + tsynth.ldm_vae_spec(TVAEConfig())
            + tsynth.open_clip_text_spec(1024, tsynth.OPEN_CLIP_H_LAYERS))
    parts = tconvert.split_ldm({k: torch.empty(s, device="meta") for k, s in spec})
    cfg = tconvert.ldm_unet_config(parts["unet"], MVDREAM_CONFIG)
    assert cfg == MVDREAM_CONFIG
    assert tconvert.ldm_vae_config(parts["vae"], TVAEConfig()) == TVAEConfig()
    with torch.device("meta"):
        for module, state in ((TUNet(cfg), tconvert.ldm_unet_state(parts["unet"], cfg)),
                              (TVAE(TVAEConfig()), tconvert.ldm_vae_state(parts["vae"],
                                                                         TVAEConfig()))):
            params = {k: tuple(v.shape) for k, v in module.named_parameters()}
            assert {k: tuple(v.shape) for k, v in state.items()} == params
    text = open_clip_text_config(parts["text"])
    assert (text.num_hidden_layers, text.hidden_size, text.num_attention_heads,
            text.vocab_size) == (23, 1024, 16, 49408)


def test_ldm_load_is_strict():
    sd = dict(ldm_state())
    with pytest.raises(KeyError, match="belongs to no model"):
        tconvert.split_ldm({**sd, "model_ema.decay": torch.tensor(0.9)})
    parts = tconvert.split_ldm({**sd, "model.diffusion_model.extra.weight": torch.zeros(2)})
    cfg = TUNetConfig(**MV_KW)
    with pytest.raises(KeyError, match="extra.weight"):
        tconvert.ldm_unet_state(parts["unet"], cfg)
    parts = tconvert.split_ldm(sd)
    state = tconvert.ldm_vae_state(parts["vae"], TVAEConfig(block_out_channels=(8, 16),
                                                            layers_per_block=1))
    state.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="no snapshot key"):
        tconvert.load_into(TVAE(TVAEConfig(block_out_channels=(8, 16), layers_per_block=1)),
                           state)


# -- load_mvdream against JAX's ---------------------------------------------------------


@pytest.fixture(scope="module")
def mv_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvdream")
    torch.save(ldm_state(), root / "sd-v2.1-base-4view.pt")
    tsynth.write_clip_tokenizer(str(root / "tokenizer"))
    return str(root / "sd-v2.1-base-4view.pt")


def test_load_mvdream_matches_jax(mv_file):
    """Both loaders in float32 on the same .pt (mapped, torch.load with
    weights_only): the text states (zero-padded ids, penultimate block, 1
    head at width 24 as both read it) to 1e-5 of their largest entry, and
    the SDS loss and gradient. The port reads the architecture from the
    file; the JAX loader is given it, with MVDream's 64-wide heads."""
    from test_torch_text import _hold_sds

    prompt, neg = "a hamburger", "ugly, blurry, low quality"
    jg = jloader.load_mvdream(mv_file, prompt, neg, image_size=IMAGE,
                              unet_config=dataclasses.replace(TINY_UNET, num_attention_heads=None),
                              vae_config=TINY_VAE, dtype=jnp.float32)
    tg = tloader.load_mvdream(mv_file, prompt, neg, image_size=IMAGE, device="cpu",
                              dtype=torch.float32)
    assert tg.unet.config == TUNetConfig(**{**MV_KW, "num_attention_heads": None})
    assert tg.unet.down_0_attn_0.transformer_blocks_0.attn1.heads == 1
    for k in ("pos", "neg"):
        want = np.asarray(jg.emb[k])
        np.testing.assert_allclose(tg.emb[k].numpy(), want, atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)
    tokens = encode_open_clip_text(tconvert.split_ldm(ldm_state())["text"],
                                   os.path.join(os.path.dirname(mv_file), "tokenizer"),
                                   [prompt], "cpu")
    assert torch.equal(tokens[0], tg.emb["pos"])
    images = np.random.default_rng(8).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, {"poses": _poses(1, 4)}, 0.6,
              jax.random.PRNGKey(9), tg, 1e-4, 2e-4)
