"""ImageDream of the PyTorch port against the JAX package: the resampler and
the ip cross-attention on carried weights, the whole 4+1-view UNet (camera,
ip tokens, identity latent), the CLIP token tower against JAX's
``_clip_image_tokens`` (transformers ``CLIPVisionModel``), the ipmv LDM
conversion and the port's writer against JAX's ``convert_ldm_unet`` /
``synth_ldm_unet``, the full-width layout read as ``IMAGEDREAM_CONFIG``,
``load_imagedream`` on a tiny ``.pt`` against JAX's, the diffusers folder
that the JAX loader takes and cannot run, ``ImageDreamGuidance`` (SDS loss
and image gradient, annealed and drawn; the refine at two strengths). The
samplers and ``cli.dream``: ``test_torch_dream.py``; the trainers and the
CLIs on ``configs/imagedream.yaml``: ``test_torch_imagedream_trainers.py``."""

import dataclasses
import functools
import json
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
from dreamgaussian_tpu.guidance.unet import CrossAttention as JCrossAttention
from dreamgaussian_tpu.guidance.unet import Resampler as JResampler
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance import clip as tclip
from dreamgaussian_tpu_torch.guidance import convert as tconvert
from dreamgaussian_tpu_torch.guidance import loader as tloader
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.unet import IMAGEDREAM_CONFIG
from dreamgaussian_tpu_torch.guidance.unet import CrossAttention as TCrossAttention
from dreamgaussian_tpu_torch.guidance.unet import Resampler as TResampler
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig
from test_torch_guidance import flax_random_params
from test_torch_mvdream import TEXT, _poses
from torch_cpu_cases import one_torch_thread  # noqa: F401

CTX = 24
IMAGE = 32                 # guidance image size; VAE (4, 8) gives 16^2 latents
# TINY_IMAGEDREAM_CONFIG's IP-adapter widths (tokens of width 20, a 16-wide
# resampler of 2 layers and 2 heads, 4 image tokens) on 64/128-channel levels:
# GroupNorm over single channels, as at 32 channels and fewer, would take the
# time embedding out, and would normalise the uncond half's zero identity
# view (a constant per channel) to its rounding noise, which then differs
# between the packages.
IP_KW = dict(ip_dim=4, ip_embed_dim=20, ip_resampler_dim=16, ip_resampler_depth=2,
             ip_resampler_heads=2)
ID_KW = dict(in_channels=4, block_out_channels=(64, 128), layers_per_block=1,
             cross_attention_dim=CTX, num_attention_heads=2, use_linear_projection=True,
             down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), num_views=5, **IP_KW)
VAE_KW = dict(block_out_channels=(4, 8), layers_per_block=1)
N_TOKENS = 7               # CLIP image tokens per image in the module tests


def _np(x):
    return torch.from_numpy(np.array(x))


def _hold(got, want):
    """Module outputs: 1e-5 of the largest reference entry."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- the IP-adapter modules ---------------------------------------------------------


def test_resampler_matches_on_carried_weights():
    """Two layers of perceiver attention over [tokens ++ latents] and the
    exact-GELU feed-forward, from 20-wide tokens to 4 context tokens of 24."""
    jm = JResampler(dim=16, depth=2, heads=2, num_queries=4, output_dim=CTX)
    x = np.random.default_rng(0).normal(size=(3, N_TOKENS, 20)).astype(np.float32)
    p = flax_random_params(jm, jnp.zeros((1, N_TOKENS, 20)), seed=1)
    tm = TResampler(16, 2, 2, 4, 20, CTX)
    tm.load_state_dict(weights.flax_state_dict(p, "cpu"))
    with torch.no_grad():
        got = tm(_np(x)).numpy()
    assert got.shape == (3, 4, CTX)
    _hold(got, np.asarray(jm.apply(p, x)))


def test_ip_cross_attention_matches_on_carried_weights():
    """The last 4 context tokens through to_k_ip / to_v_ip; without them the
    ip path is not taken."""
    jm = JCrossAttention(32, 2, CTX, ip_dim=4)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 6 + 4, CTX)).astype(np.float32)
    p = flax_random_params(jm, jnp.zeros((2, 9, 32)), jnp.zeros((2, 10, CTX)), seed=3)
    tm = TCrossAttention(32, 2, CTX, ip=True)
    tm.load_state_dict(weights.flax_state_dict(p, "cpu"))
    with torch.no_grad():
        got = tm(_np(x), _np(ctx), n_ip=4).numpy()
        plain = tm(_np(x), _np(ctx[:, :6])).numpy()
    _hold(got, np.asarray(jm.apply(p, x, ctx)))
    assert np.abs(got - plain).max() > 1e-3


@functools.lru_cache(maxsize=None)
def nets():
    latent = IMAGE // 2
    junet = JUNet(JUNetConfig(**ID_KW))
    up = flax_random_params(junet, jnp.zeros((5, latent, latent, 4)), jnp.zeros((5,)),
                            jnp.zeros((5, 5, CTX)), jnp.zeros((5, 16)),
                            jnp.zeros((5, N_TOKENS, 20)), jnp.zeros((1, latent, latent, 4)),
                            seed=40)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, IMAGE, IMAGE, 3)), seed=41)
    tunet = weights.load_unet(TUNet(TUNetConfig(**ID_KW)), up)
    tvae = weights.load_vae(TVAE(TVAEConfig(**VAE_KW)), vp)
    return junet, up, jvae, vp, tunet, tvae


def test_imagedream_unet_matches_on_carried_weights():
    """Two groups of 4+1 views with the camera, the ip tokens and the
    identity latent written into each group's fifth view; the ip tokens and
    the identity latent each move the real views' prediction."""
    junet, up, _, _, tunet, _ = nets()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 8, 8, 4)).astype(np.float32)
    t = np.full(10, 420.0, np.float32)
    ctx = rng.normal(size=(10, 5, CTX)).astype(np.float32)
    cam = rng.normal(size=(10, 16)).astype(np.float32)
    ip = rng.normal(size=(10, N_TOKENS, 20)).astype(np.float32)
    ip_img = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    j = np.asarray(jax.jit(junet.apply)(up, x, t, ctx, cam, ip, ip_img))
    with torch.no_grad():
        run = lambda **kw: tunet(_np(x), _np(t), _np(ctx), camera=_np(cam),  # noqa: E731
                                 **{"ip": _np(ip), "ip_img": _np(ip_img), **kw}).numpy()
        got = run()
        no_ip = run(ip=torch.zeros(10, N_TOKENS, 20))
        other_img = run(ip_img=torch.zeros(2, 8, 8, 4))
    _hold(got, j)
    real = [i for i in range(10) if i % 5 != 4]
    assert np.abs(no_ip - got)[real].max() > 1e-4
    assert np.abs(other_img - got)[real].max() > 1e-4


# -- the CLIP token tower -----------------------------------------------------------------

TINY_CLIP = dict(hidden_size=20, intermediate_size=40, num_hidden_layers=2,
                 num_attention_heads=2, image_size=16, patch_size=8, projection_dim=12)


def hf_image_encoder(path, projection: bool, seed: int = 0):
    """A tiny transformers CLIPVisionModel (or ...WithProjection) folder:
    5 tokens of width 20."""
    from transformers import CLIPVisionConfig, CLIPVisionModel, CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    cls = CLIPVisionModelWithProjection if projection else CLIPVisionModel
    model = cls(CLIPVisionConfig(**TINY_CLIP, hidden_act="gelu"))
    with torch.no_grad():
        for p in model.parameters():      # norms and biases away from 1 and 0
            p.add_(torch.randn_like(p) * 0.1)
    model.save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("projection", [False, True], ids=["vision_model", "with_projection"])
def test_clip_tokens_match_jax(tmp_path, projection):
    """last_hidden_state [5, 20] (the encoder's output, before
    post_layernorm) of both towers on a 40^2 image resized to 16^2: 1e-5 of
    the largest token entry; the projection of a WithProjection folder is
    left unused, as transformers' from_pretrained leaves it."""
    folder = hf_image_encoder(tmp_path / "image_encoder", projection)
    image = np.random.default_rng(6).uniform(size=(40, 40, 3)).astype(np.float32)
    got = tclip.clip_image_tokens(folder, image, "cpu").numpy()
    assert got.shape == (5, 20)
    _hold(got, jloader._clip_image_tokens(folder, image))


# -- the ipmv LDM layout ----------------------------------------------------------------

TINY_UNET = jsynth.TINY_IMAGEDREAM_CONFIG
TINY_VAE = JVAEConfig(block_out_channels=(8, 16), layers_per_block=1)
# The JAX package's fields; the port's Resampler head width stays at its
# default, the JAX layout.
T_TINY_UNET = TUNetConfig(**{f.name: getattr(TINY_UNET, f.name)
                             for f in dataclasses.fields(TUNetConfig)
                             if hasattr(TINY_UNET, f.name)})


@functools.lru_cache(maxsize=None)
def ldm_state():
    """JAX's synthetic ImageDream LDM checkpoint as torch tensors, with the
    schedule buffers and the text tower's projection and logit scale."""
    sd = jsynth.synth_ldm_checkpoint(TINY_UNET, TINY_VAE, TEXT, seed=50)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    for name in tsynth.LDM_SCHEDULE:
        sd[name] = torch.linspace(1e-4, 2e-2, 1000)
    sd["cond_stage_model.model.logit_scale"] = torch.tensor(4.6)
    return sd


def test_port_writer_spells_the_jax_ipmv_keys():
    got = dict(tsynth.ldm_unet_spec(T_TINY_UNET))
    want = {k: tuple(v.shape) for k, v in jsynth.synth_ldm_unet(TINY_UNET, seed=0).items()}
    assert got == want
    assert any(".attn2.to_k_ip." in k for k in got) and "model.diffusion_model.image_embed.latents" in got


def test_ipmv_conversion_equals_the_jax_conversion():
    """The UNet with its resampler and ip projections renamed onto the port's
    module and loaded strictly, against JAX's convert_ldm_unet carried over:
    every parameter equal. The architecture read from the shapes is the one
    written, the resampler's heads 64 wide."""
    sd = ldm_state()
    parts = tconvert.split_ldm(sd)
    ucfg = tconvert.ldm_unet_config(parts["unet"], TUNetConfig(num_views=5, num_attention_heads=2))
    assert ucfg == dataclasses.replace(T_TINY_UNET, ip_resampler_heads=1)
    unet = tconvert.load_into(TUNet(ucfg), tconvert.ldm_unet_state(parts["unet"], ucfg))
    ref = weights.load_unet(TUNet(ucfg), jconvert.convert_ldm_unet(
        {k: v.numpy() for k, v in sd.items()}, TINY_UNET))
    want = ref.state_dict()
    assert sorted(unet.state_dict()) == sorted(want) and "image_embed.latents" in want
    for k, v in unet.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_full_width_ipmv_layout_reads_as_imagedream_config():
    """The full-width file's shapes (on the meta device) give IMAGEDREAM_CONFIG
    and fill every parameter of its UNet: 941,672,900 values, of which
    48,541,696 in the resampler (1024 wide, 12 heads of width 64) and
    25,559,040 in to_k_ip / to_v_ip; the ViT-H/14 image encoder has
    630,766,080."""
    spec = tsynth.ldm_unet_spec(IMAGEDREAM_CONFIG)
    parts = tconvert.split_ldm({k: torch.empty(s, device="meta") for k, s in spec})
    cfg = tconvert.ldm_unet_config(parts["unet"], IMAGEDREAM_CONFIG)
    assert cfg == IMAGEDREAM_CONFIG
    with torch.device("meta"):
        params = {k: tuple(v.shape) for k, v in TUNet(cfg).named_parameters()}
    state = tconvert.ldm_unet_state(parts["unet"], cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == params
    count = lambda pred: sum(int(np.prod(s)) for k, s in params.items() if pred(k))  # noqa: E731
    assert count(lambda k: True) == 941_672_900
    assert count(lambda k: k.startswith("image_embed.")) == 48_541_696
    assert count(lambda k: "_ip." in k) == 25_559_040
    vit = tsynth.clip_vision_spec(tsynth.CLIP_VIT_H14, projection=False)
    assert sum(int(np.prod(s)) for _, s in vit) == 630_766_080
    assert ("vision_model.embeddings.position_embedding.weight", (257, 1280)) in vit


# -- load_imagedream against JAX's ----------------------------------------------------------


@pytest.fixture(scope="module")
def ipmv_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagedream")
    torch.save(ldm_state(), root / "sd-v2.1-base-4view-ipmv.pt")
    tsynth.write_clip_tokenizer(str(root / "tokenizer"))
    hf_image_encoder(root / "image_encoder", projection=False, seed=1)
    return str(root / "sd-v2.1-base-4view-ipmv.pt")


REF = np.random.default_rng(7).uniform(size=(48, 48, 3)).astype(np.float32)


def test_load_imagedream_matches_jax(ipmv_file):
    """Both loaders in float32 on the same .pt: the text states, the CLIP
    tokens and the identity latent to 1e-5 of their largest entry, and the
    SDS loss and gradient. The port reads the architecture from the file
    (heads of width 64: one in the UNet, one in the 16-wide resampler); the
    JAX loader is given it."""
    from test_torch_text import _hold_sds

    prompt, neg = "a hamburger", "ugly, blurry, low quality"
    jcfg = dataclasses.replace(TINY_UNET, num_attention_heads=None, ip_resampler_heads=1)
    jg = jloader.load_imagedream(ipmv_file, REF, prompt, neg, image_size=IMAGE, unet_config=jcfg,
                                 vae_config=TINY_VAE, dtype=jnp.float32)
    tg = tloader.load_imagedream(ipmv_file, REF, prompt, neg, image_size=IMAGE, device="cpu",
                                 dtype=torch.float32)
    assert tg.unet.config == dataclasses.replace(T_TINY_UNET, num_attention_heads=None,
                                                 ip_resampler_heads=1)
    for got, want in ((tg.emb["pos"], jg.emb["pos"]), (tg.emb["neg"], jg.emb["neg"]),
                      (tg.img_emb["pos"], jg.img_emb["pos"]),
                      (tg.img_emb["ip_img"], jg.img_emb["ip_img"])):
        assert tuple(got.shape) == tuple(want.shape)
        _hold(got.numpy(), np.asarray(want))
    assert tuple(tg.img_emb["ip_img"].shape) == (16, 16, 4)
    images = np.random.default_rng(8).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, {"poses": _poses(1, 4)}, 0.6,
              jax.random.PRNGKey(9), tg, 1e-4, 2e-4)


def test_diffusers_folder_is_refused(tmp_path):
    """A diffusers folder has no place for the resampler or the ip
    projections: the JAX loader builds the guidance from one and its UNet
    fails at the first call with image tokens; the port's load_imagedream
    refuses the folder."""
    from test_torch_text import CLI_TEXT, CLI_UNET

    root = tmp_path / "snapshot"
    cfg = dataclasses.replace(CLI_UNET, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), num_views=5)
    tsynth.write_sd_snapshot(str(root), cfg, TVAEConfig(**VAE_KW), CLI_TEXT,
                             dtype=torch.float32, seed=3, device="cpu")
    with open(root / "unet" / "config.json") as f:
        unet_json = json.load(f)
    with open(root / "unet" / "config.json", "w") as f:     # a head width both packages read
        json.dump({**unet_json, "attention_head_dim": 4}, f)
    hf_image_encoder(root / "image_encoder", projection=False)
    jg = jloader.load_imagedream(str(root), REF, "a cup", image_size=IMAGE,
                                 unet_config=TINY_UNET, dtype=jnp.float32)
    with pytest.raises(Exception, match="image_embed"):
        jg.guidance_fn()(jnp.full((4, IMAGE, IMAGE, 3), 0.5), {"poses": jnp.asarray(_poses(1, 0))},
                         0.5, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="single-file LDM layout"):
        tloader.load_imagedream(str(root), REF, "a cup", device="cpu")


# -- ImageDreamGuidance ----------------------------------------------------------------------


def id_guidances():
    """Both packages' ImageDream guidance on the carried nets, with the same
    text states, CLIP tokens and identity latent."""
    junet, up, jvae, vp, tunet, tvae = nets()
    rng = np.random.default_rng(9)
    emb = {"pos": (rng.normal(size=(5, CTX)) * 0.5).astype(np.float32),
           "neg": (rng.normal(size=(5, CTX)) * 0.5).astype(np.float32)}
    img = {"pos": rng.normal(size=(N_TOKENS, 20)).astype(np.float32),
           "ip_img": rng.normal(size=(IMAGE // 2, IMAGE // 2, 4)).astype(np.float32)}
    jg = jsds.ImageDreamGuidance(_backbone_from_params(junet, up, jvae, vp, IMAGE), emb, img,
                                 image_size=IMAGE)
    tg = tsds.ImageDreamGuidance(tunet, tvae, {k: _np(v) for k, v in emb.items()},
                                 {k: _np(v) for k, v in img.items()}, image_size=IMAGE)
    return jg, tg


@pytest.mark.parametrize("anneal", [True, False], ids=["anneal", "drawn_t"])
def test_imagedream_guidance_loss_and_image_grad(anneal):
    """Two groups of 4 views from 48^2 renders, each padded with its identity
    view: one shared timestep (repeated into the fifth view), CFG 5
    [uncond, cond] with zero ip tokens and identity latent in the uncond
    half, no w(t). float32: the loss to 1e-4, the gradient to 2e-4 of its
    largest entry."""
    from test_torch_text import _hold_sds

    jg, tg = id_guidances()
    jg.anneal = tg.anneal = anneal
    images = np.random.default_rng(10).uniform(size=(8, 48, 48, 3)).astype(np.float32)
    draws = _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, {"poses": _poses(2, 11)}, 0.35,
                      jax.random.PRNGKey(12), tg, 1e-4, 2e-4)
    assert draws == (["sds_noise"] if anneal else ["sds_t", "sds_noise"])


@pytest.mark.parametrize("strength", [0.8, 0.95])
def test_imagedream_refine_with_injected_noise(strength):
    """The 4(+1)-view img2img refine, CFG 5, against JAX's fused refine with
    the same noise; images in [0, 1]: 1e-4."""
    from test_torch_text import _refine_draw

    jg, tg = id_guidances()
    images = np.random.default_rng(13).uniform(size=(4, 48, 48, 3)).astype(np.float32)
    poses = _poses(1, 14)
    key = jax.random.PRNGKey(15)
    j = np.asarray(jg.refine_fn(steps=10)(images, {"poses": jnp.asarray(poses)},
                                          jnp.float32(strength), key))
    t = tg.refine_fn(steps=10)(_np(images), {"poses": _np(poses)}, np.float32(strength),
                               _refine_draw(key))
    assert t.shape == (4, IMAGE, IMAGE, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)
