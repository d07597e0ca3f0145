"""SD 2.1 text-to-3D of the PyTorch port against the JAX package and
transformers: the port's CLIP BPE tokenizer (against
``transformers.CLIPTokenizer`` and JAX's ``_tokenize_open_clip``), the CLIP
text tower (against JAX's ``_encode_text`` on a random transformers
``CLIPTextModel``, ``gelu`` and ``quick_gelu``), the SD 2.x UNet with linear
projections on carried weights, the head-count reading of an SD 2.1-base
``config.json``, the diffusers conversion and writer, ``StableDiffusionGuidance``
(SDS loss and image gradient with directional prompts, refine) on carried
weights and through ``load_stable_diffusion`` against JAX's, and both CLIs
on ``configs/text.yaml`` with the fake and on a tiny snapshot the port
writes."""

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
from dreamgaussian_tpu.guidance.unet import UNet as JUNet
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import AutoencoderKL as JVAE
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.guidance import loader as tloader
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.clip import CLIPTextConfig
from dreamgaussian_tpu_torch.guidance.text_encoder import encode_text
from dreamgaussian_tpu_torch.guidance.tokenizer import CLIPTokenizer
from dreamgaussian_tpu_torch.guidance.unet import SD21_CONFIG
from dreamgaussian_tpu_torch.guidance.unet import UNet as TUNet
from dreamgaussian_tpu_torch.guidance.unet import UNetConfig as TUNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL as TVAE
from dreamgaussian_tpu_torch.guidance.vae import VAEConfig as TVAEConfig
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.scene import load_ply
from test_torch_guidance import flax_random_params
from torch_cpu_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX = 24                  # tiny text width == the UNet's cross-attention width
IMAGE = 32                # guidance image size; VAE (4, 8) gives 16^2 latents
UNET_KW = dict(in_channels=4, block_out_channels=(8, 16), layers_per_block=1,
               cross_attention_dim=CTX, use_linear_projection=True,
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
VAE_KW = dict(block_out_channels=(4, 8), layers_per_block=1)
PROMPTS = [
    "a hamburger",
    "A  DSLR Photo,of   a CORGI!! wearing a beret...",
    "it's 12 dogs' toys, they're 3D-printed: déjà vu; 中文 ok",
    "\tleading and trailing\n whitespace   ",
    "",
    tsynth.CORPUS,        # longer than any model_max_length below: truncated
]


def _np(x):
    return torch.from_numpy(np.array(x))


# -- the tokenizer ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {"eos_pad": tsynth.write_clip_tokenizer(str(root / "eos"), model_max_length=16),
            "bang_pad": tsynth.write_clip_tokenizer(str(root / "bang"), model_max_length=24,
                                                    pad_token="!", n_merges=300)}


@pytest.mark.parametrize("which", ["eos_pad", "bang_pad"])
def test_tokenizer_matches_transformers_and_jax(tokenizers, which):
    """Case, punctuation, runs of spaces, contractions, accents, CJK, digits,
    the empty prompt and truncation that keeps EOT: the ids of
    transformers' CLIPTokenizer (no ftfy here, as on the card machine) with
    the pad token, and JAX's _tokenize_open_clip (zeros after EOT)."""
    from transformers import CLIPTokenizer as HFTokenizer

    folder = tokenizers[which]
    hf, tok = HFTokenizer.from_pretrained(folder), CLIPTokenizer(folder)
    assert tok.model_max_length == hf.model_max_length and tok.pad_id == hf.pad_token_id
    want = hf(PROMPTS, padding="max_length", max_length=hf.model_max_length,
              truncation=True)["input_ids"]
    assert tok.encode(PROMPTS) == want
    assert len(set(map(tuple, want))) == len(PROMPTS)
    for ctx in (8, 77):
        np.testing.assert_array_equal(np.array(tok.encode(PROMPTS, ctx, padding="zeros")),
                                      jloader._tokenize_open_clip(folder, PROMPTS, ctx))
    merged = [t for t in hf.tokenize(PROMPTS[0]) if len(t.replace("</w>", "")) > 1]
    assert merged, "the test vocabulary's merges are used"


def test_text_mv_negative_prompt_truncates_like_transformers(tokenizers):
    from transformers import CLIPTokenizer as HFTokenizer

    from dreamgaussian_tpu_torch.utils.config import load

    neg = load(os.path.join(REPO, "configs", "text_mv.yaml"))["negative_prompt"]
    folder = tokenizers["eos_pad"]
    hf = HFTokenizer.from_pretrained(folder)
    ids = CLIPTokenizer(folder).encode([neg])
    assert ids == hf([neg], padding="max_length", max_length=16, truncation=True)["input_ids"]
    assert ids[0][-1] == hf.eos_token_id and len(hf.tokenize(neg)) > 14


# -- the CLIP text tower -------------------------------------------------------------

TEXT_KW = dict(vocab_size=1024, hidden_size=CTX, intermediate_size=40, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=16)


def _hf_text_encoder(folder, act, seed):
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel

    torch.manual_seed(seed)
    enc = CLIPTextModel(HFConfig(**TEXT_KW, hidden_act=act)).eval()
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    enc.save_pretrained(folder, safe_serialization=True)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_tower_matches_jax_encode_text(tokenizers, tmp_path, act):
    """The port's encode_text against the JAX package's _encode_text
    (transformers' tokenizer and CLIPTextModel) on the same snapshot folder:
    float32 both, the layers summed in another order (1e-5 of the largest
    state)."""
    import shutil

    shutil.copytree(tokenizers["eos_pad"], tmp_path / "tokenizer")
    _hf_text_encoder(str(tmp_path / "text_encoder"), act, seed=len(act))
    want = jloader._encode_text(str(tmp_path), PROMPTS)
    got = encode_text(str(tmp_path), PROMPTS, "cpu").numpy()
    assert got.shape == (len(PROMPTS), 16, CTX)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_clip_text_spec_matches_transformers():
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel

    hf = CLIPTextModel(HFConfig(**TEXT_KW, hidden_act="gelu"))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items() if not k.endswith("position_ids")}
    assert dict(tsynth.clip_text_spec(CLIPTextConfig(**TEXT_KW, hidden_act="gelu"))) == want


# -- the SD 2.x UNet -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def nets():
    """Tiny SD 2.x flax UNet (linear projections, 2 heads) and VAE with their
    torch twins on carried weights."""
    latent = IMAGE // 2
    jcfg = JUNetConfig(**UNET_KW, num_attention_heads=2)
    junet = JUNet(jcfg)
    up = flax_random_params(junet, jnp.zeros((1, latent, latent, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 5, CTX)), seed=10)
    jvae = JVAE(JVAEConfig(**VAE_KW))
    vp = flax_random_params(jvae, jnp.zeros((1, IMAGE, IMAGE, 3)), seed=11)
    tunet = weights.load_unet(TUNet(TUNetConfig(**UNET_KW, num_attention_heads=2)), up)
    tvae = weights.load_vae(TVAE(TVAEConfig(**VAE_KW)), vp)
    return junet, up, jvae, vp, tunet, tvae


@pytest.mark.parametrize("heads", ["fixed 2", "width 4"])
def test_sd_unet_matches_on_carried_weights(heads):
    """Linear projections, two levels; the heads fixed (2) or from a head
    width (4: 2 and 4 heads)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([15.0, 870.0], np.float32)
    ctx = rng.normal(size=(2, 5, CTX)).astype(np.float32)
    kw = dict(num_attention_heads=2) if heads == "fixed 2" else \
        dict(num_attention_heads=None, attention_head_dim=4)
    junet = JUNet(JUNetConfig(**UNET_KW, **kw))
    up = flax_random_params(junet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 5, CTX)), seed=2)
    tunet = weights.load_unet(TUNet(TUNetConfig(**UNET_KW, **kw)), up)
    assert tunet.up_1_attn_0.transformer_blocks_0.attn1.heads == 2
    assert tunet.mid_attn.transformer_blocks_0.attn1.heads == (2 if heads == "fixed 2" else 4)
    j = np.asarray(jax.jit(junet.apply)(up, x, t, ctx))
    with torch.no_grad():
        got = tunet(_np(x), _np(t), _np(ctx)).numpy()
    np.testing.assert_allclose(got, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


SD21_BASE_UNET_JSON = {   # stabilityai/stable-diffusion-2-1-base unet/config.json
    "_class_name": "UNet2DConditionModel", "act_fn": "silu", "attention_head_dim": [5, 10, 20, 20],
    "block_out_channels": [320, 640, 1280, 1280], "center_input_sample": False,
    "cross_attention_dim": 1024,
    "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                         "DownBlock2D"],
    "downsample_padding": 1, "dual_cross_attention": False, "flip_sin_to_cos": True,
    "freq_shift": 0, "in_channels": 4, "layers_per_block": 2, "mid_block_scale_factor": 1,
    "norm_eps": 1e-05, "norm_num_groups": 32, "out_channels": 4, "sample_size": 64,
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "CrossAttnUpBlock2D"],
    "use_linear_projection": True,
}


def test_sd21_base_head_list_reads_as_head_width_64(tmp_path):
    """The published SD 2.1-base config's attention_head_dim [5, 10, 20, 20]
    (heads per level, as diffusers reads it) builds the UNet that head width
    64 builds: every transformer's heads equal. The JAX package's config
    cannot take that list (a fault of the reference, ROADMAP section 3)."""
    os.makedirs(tmp_path / "unet")
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump(SD21_BASE_UNET_JSON, f)
    cfg = tloader._unet_config(str(tmp_path), SD21_CONFIG)
    assert cfg.attention_head_dim == (5, 10, 20, 20)
    with torch.device("meta"):
        listed, width = TUNet(cfg), TUNet(SD21_CONFIG)
    heads = lambda m: {n: x.heads for n, x in m.named_modules() if n.endswith(("attn1", "attn2"))}  # noqa: E731
    assert heads(listed) == heads(width) and len(heads(width)) == 32
    assert sorted(set(heads(width).values())) == [5, 10, 20]
    assert [p.shape for p in listed.parameters()] == [p.shape for p in width.parameters()]
    with pytest.raises(TypeError):
        JUNetConfig(attention_head_dim=(5, 10, 20, 20)).heads_for(320)


def test_diffusers_sd_unet_loads_as_the_jax_conversion(tmp_path):
    """A .bin UNet with linear projections (JAX's synthetic state dict):
    the port's strict load against convert_unet carried over, every
    parameter equal; the port's writer spells the same keys and shapes."""
    jcfg = JUNetConfig(**UNET_KW, num_attention_heads=2)
    sd = jsynth.synth_diffusers_unet(jcfg, seed=4)
    assert dict(tsynth.diffusers_unet_spec(TUNetConfig(**UNET_KW))) == \
        {k: v.shape for k, v in sd.items()}
    for sub, state in (("unet", sd), ("vae", jsynth.synth_diffusers_vae(JVAEConfig(**VAE_KW)))):
        os.makedirs(tmp_path / sub)
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                   tmp_path / sub / "diffusion_pytorch_model.bin")
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump({"block_out_channels": [8, 16], "layers_per_block": 1, "in_channels": 4,
                   "cross_attention_dim": CTX, "attention_head_dim": [2, 2],
                   "down_block_types": list(UNET_KW["down_block_types"]),
                   "up_block_types": list(UNET_KW["up_block_types"]),
                   "use_linear_projection": True}, f)
    with open(tmp_path / "vae" / "config.json", "w") as f:
        json.dump({"block_out_channels": [4, 8], "layers_per_block": 1}, f)
    unet, _ = tloader._build_backbone(str(tmp_path), SD21_CONFIG, "cpu", torch.float32)
    ref = weights.load_unet(TUNet(unet.config), jconvert.convert_unet(sd, jcfg))
    ref_sd = ref.state_dict()
    assert sorted(unet.state_dict()) == sorted(ref_sd)
    for k, v in unet.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k
    with open(tmp_path / "unet" / "config.json") as f:
        raw = json.load(f)
    with open(tmp_path / "unet" / "config.json", "w") as f:
        json.dump({**raw, "use_linear_projection": False}, f)
    with pytest.raises(ValueError, match="use_linear_projection"):
        tloader._build_backbone(str(tmp_path), SD21_CONFIG, "cpu", torch.float32)


# -- StableDiffusionGuidance ---------------------------------------------------------

HORS = np.array([-170.0, -90.0, 0.0, 45.0, 100.0, 150.0], np.float32)


def _embeddings(seed=7, length=5):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(length, CTX)) * 0.5).astype(np.float32)
            for k in ("pos", "neg", "front", "side", "back")}


def _sd_guidances(emb):
    junet, up, jvae, vp, tunet, tvae = nets()
    jg = jsds.StableDiffusionGuidance(_backbone_from_params(junet, up, jvae, vp, IMAGE), emb,
                                      image_size=IMAGE)
    tg = tsds.StableDiffusionGuidance(tunet, tvae, {k: _np(v) for k, v in emb.items()},
                                      image_size=IMAGE)
    return jg, tg


def _hold_sds(jfn, tfn, images, cond, ratio, key, tg, l_tol, g_tol):
    """SDS loss and image gradient of both packages with JAX's draws injected."""
    k_t, k_n = jax.random.split(key)
    draws = []

    def draw(name, shape, dist, low=0, high=None):
        draws.append(name)
        if name == "sds_t":
            assert dist == "randint" and (low, high) == (tg.t_min, tg.t_max + 1)
            return torch.tensor(int(jax.random.randint(k_t, (), low, high)))
        assert name == "sds_noise" and dist == "normal"
        return _np(jax.random.normal(k_n, shape))

    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    jl, jgrad = jax.value_and_grad(lambda im: jfn(im, jcond, ratio, key))(jnp.asarray(images))
    x = _np(images).requires_grad_(True)
    tl = tfn(x, {k: _np(v) for k, v in cond.items()}, ratio, draw)
    tl.backward()
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=l_tol)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, atol=g_tol * np.abs(jgrad).max(), rtol=0)
    return draws


# float32, CFG 100: the nets' summation order differs at 1e-6 of a value and
# CFG multiplies the difference of the two predictions by 100; seen about
# 2e-6 (loss) and 3e-5 (gradient, of its largest entry).
SD_TOL = (1e-4, 2e-4)


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "pos"])
def test_sd_guidance_loss_and_image_grad(directional):
    """Six views at hors -170, -90, 0, 45, 100 and 150 (back, side, front,
    front, side, back) from 64^2 renders, annealed at two step ratios and
    with a drawn timestep."""
    emb = _embeddings()
    if not directional:
        emb = {k: emb[k] for k in ("pos", "neg")}
    jg, tg = _sd_guidances(emb)
    if directional:
        idx = tg._directional_embeds(_np(HORS), len(HORS))
        for got, want in zip(idx, ["back", "side", "front", "front", "side", "back"]):
            assert torch.equal(got, tg.emb[want])
    images = np.random.default_rng(8).uniform(size=(len(HORS), 64, 64, 3)).astype(np.float32)
    cond = {"hors": HORS}
    for ratio, seed in ((0.1, 3), (0.75, 4)):
        assert _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, cond, ratio,
                         jax.random.PRNGKey(seed), tg, *SD_TOL) == ["sds_noise"]
    jg.anneal = tg.anneal = False
    assert _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, cond, 0.5,
                     jax.random.PRNGKey(5), tg, *SD_TOL) == ["sds_t", "sds_noise"]


def _refine_draw(key):
    k_n, _ = jax.random.split(key)

    def draw(name, shape, dist):
        assert name == "refine_noise" and dist == "normal"
        return _np(jax.random.normal(k_n, shape))
    return draw


@pytest.mark.parametrize("strength", [0.8, 0.95])
def test_sd_refine_with_injected_noise(strength):
    """The img2img refine of three views (10 and 3 UNet calls) against the
    JAX package's fused refine, [pos, neg] CFG at 100, the same noise. Each
    DDIM step amplifies the nets' float32 differences by CFG 100 and
    1/sqrt(alpha_t); images in [0, 1]: 1e-4 (seen 2e-6)."""
    jg, tg = _sd_guidances(_embeddings())
    images = np.random.default_rng(9).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    cond = {"hors": HORS[:3]}
    key = jax.random.PRNGKey(12)
    j = np.asarray(jg.refine_fn(steps=10)(images, {"hors": jnp.asarray(cond["hors"])},
                                          jnp.float32(strength), key))
    t = tg.refine_fn(steps=10)(_np(images), {"hors": _np(cond["hors"])}, np.float32(strength),
                               _refine_draw(key))
    assert t.shape == (3, IMAGE, IMAGE, 3) and not t.requires_grad
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)


# -- load_stable_diffusion against JAX's --------------------------------------------


@pytest.fixture(scope="module")
def sd_snapshot(tmp_path_factory, tokenizers):
    """A tiny SD 2.x diffusers snapshot in JAX's synthetic layout (.bin),
    with a random transformers text tower and the test tokenizer; its
    UNet config gives an int head width (4), which both packages read."""
    import shutil

    root = tmp_path_factory.mktemp("sd_snapshot")
    jcfg = JUNetConfig(**UNET_KW, attention_head_dim=4)
    for sub, state in (("unet", jsynth.synth_diffusers_unet(jcfg, seed=5)),
                       ("vae", jsynth.synth_diffusers_vae(JVAEConfig(**VAE_KW), seed=6))):
        os.makedirs(root / sub)
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                   root / sub / "diffusion_pytorch_model.bin")
    with open(root / "unet" / "config.json", "w") as f:
        json.dump({**{k: list(v) if isinstance(v, tuple) else v for k, v in UNET_KW.items()},
                   "attention_head_dim": 4}, f)
    with open(root / "vae" / "config.json", "w") as f:
        json.dump({"block_out_channels": [4, 8], "layers_per_block": 1}, f)
    shutil.copytree(tokenizers["eos_pad"], root / "tokenizer")
    _hf_text_encoder(str(root / "text_encoder"), "gelu", seed=3)
    return str(root)


def test_load_stable_diffusion_matches_jax(sd_snapshot, monkeypatch):
    """Both loaders in float32 on the same snapshot: the five text states
    (prompt, negative, front/side/back views) and the SDS loss and gradient."""
    monkeypatch.setattr(jloader, "_build_backbone",
                        functools.partial(jloader._build_backbone, dtype=jnp.float32))
    prompt, neg = "a hamburger", "ugly, blurry"
    jg = jloader.load_stable_diffusion(sd_snapshot, prompt, neg, image_size=IMAGE)
    tg = tloader.load_stable_diffusion(sd_snapshot, prompt, neg, image_size=IMAGE, device="cpu",
                                       dtype=torch.float32)
    assert sorted(tg.emb) == sorted(jg.emb)
    for k, v in jg.emb.items():
        np.testing.assert_allclose(tg.emb[k].numpy(), np.asarray(v),
                                   atol=1e-5 * float(np.abs(v).max()), err_msg=k)
    assert tg.unet.mid_attn.transformer_blocks_0.attn1.heads == 4
    images = np.random.default_rng(10).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    _hold_sds(jg.guidance_fn(), tg.guidance_fn(), images, {"hors": HORS[3:]}, 0.3,
              jax.random.PRNGKey(6), tg, *SD_TOL)


# -- the CLIs on configs/text.yaml ---------------------------------------------------

OVERRIDES = [
    "save_path=text", "prompt=a hamburger", "iters=4", "num_pts=256", "capacity=1024",
    "novel_resolutions=[32,32,32]", "density_start_iter=2", "density_end_iter=4",
    "densification_interval=2", "opacity_reset_interval=10000", "texture_size=64",
    "bake_resolution=32", "mc_resolution=32", "decimate_target=2000", "iters_refine=2",
    "novel_resolution=64", "refine_steps=4", "density_thresh=0.2", "device=cpu",
]
# The CLI's SD snapshot: SD's 512^2 input through a VAE that downsamples 8
# times, transformers only at the 32^2 level.
CLI_UNET = TUNetConfig(in_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                       cross_attention_dim=CTX, num_attention_heads=2, use_linear_projection=True,
                       down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                       up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"))
CLI_VAE = TVAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1)
CLI_TEXT = CLIPTextConfig(**{**TEXT_KW, "max_position_embeddings": 77}, hidden_act="gelu")


def read_cli_outputs(outdir, save_path):
    """The stage-1 PLY and both meshes read back and checked."""
    params, aux, _ = load_ply(os.path.join(outdir, f"{save_path}_model.ply"), capacity=4096,
                              device="cpu")
    n = int(aux.alive.sum())
    assert n > 0 and all(bool(torch.isfinite(v[:n]).all()) for v in params.values())
    meshes = [Mesh.load(os.path.join(outdir, f), resize=False)
              for f in (f"{save_path}_mesh.obj", f"{save_path}.obj")]
    for m in meshes:
        assert len(m.f) > 0 and np.isfinite(m.v).all() and m.albedo.shape == (64, 64, 3)
    np.testing.assert_array_equal(meshes[1].f, meshes[0].f)
    assert np.abs(meshes[1].albedo - meshes[0].albedo).max() > 0     # the texture was refined


@pytest.mark.parametrize("prior", ["fake", "snapshot"])
def test_both_clis_on_text_yaml(tmp_path, prior):
    """``cli.main`` then ``cli.main2`` on configs/text.yaml: the fake SD, or
    a tiny SD 2.x snapshot the port writes (head list, transformers text
    tower, tokenizer); the refine's 512^2 input renders the target at SSAA 1."""
    extra = ["fake_guidance=True"]
    if prior == "snapshot":
        tsynth.write_sd_snapshot(str(tmp_path / "sd"), CLI_UNET, CLI_VAE, CLI_TEXT,
                                 dtype=torch.float16, seed=1, device="cpu")
        extra = [f"sd_ckpt={tmp_path / 'sd'}"]
    argv = ["--config", "configs/text.yaml", f"outdir={tmp_path}", *OVERRIDES, *extra]
    stats = tcli1.main(argv)
    assert stats["step"] == 4 and np.isfinite(stats["loss"])
    refines, size = tcli2.build_refiners(_opt(argv), None, "cpu")
    assert size == (512 if prior == "snapshot" else 64) and len(refines) == 1
    assert np.isfinite(tcli2.main(argv)["loss"])
    read_cli_outputs(str(tmp_path), "text")


def _opt(argv):
    from dreamgaussian_tpu_torch.utils.config import load_with_cli

    return load_with_cli(argv[1], argv[2:])


def test_text_clis_warn_without_a_prior(tmp_path, capsys):
    opt = _opt(["--config", "configs/text.yaml", f"outdir={tmp_path}", *OVERRIDES])
    assert tcli1.build_guidances(opt, None, "cpu") == ()
    assert "skipping SD guidance" in capsys.readouterr().out

