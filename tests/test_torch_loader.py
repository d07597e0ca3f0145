"""Zero123 from a local diffusers snapshot: the port's loader against the JAX
package's on a tiny snapshot that this file writes in the real layout
(the JAX package's synthetic diffusers UNet and VAE state dicts, a
transformers CLIP vision tower, the camera projection), as ``.bin``, F32,
F16 and BF16 safetensors. Held: the state dicts read, the UNet and VAE
weights against the JAX package's conversion, the CLIP tower against
transformers, and the guidance (CLIP embedding, reference latent, SDS loss
and image gradient, random timestep, refine) against the JAX
``load_zero123`` in float32 and bfloat16, for zero123-xl and stable-zero123
conditioning. Also: the port's own synthetic snapshot writer against the
diffusers and transformers layouts, strictness, and the config.json
values the port refuses."""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance import convert as jconvert
from dreamgaussian_tpu.guidance import loader as jloader
from dreamgaussian_tpu.guidance import synthetic as jsynth
from dreamgaussian_tpu.guidance.unet import ZERO123_CONFIG as J_ZERO123_CONFIG
from dreamgaussian_tpu.guidance.unet import UNetConfig as JUNetConfig
from dreamgaussian_tpu.guidance.vae import VAEConfig as JVAEConfig
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.guidance import convert as tconvert
from dreamgaussian_tpu_torch.guidance import loader as tloader
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.clip import (CLIPVisionConfig, clip_pixel_values,
                                                   load_clip_vision)
from dreamgaussian_tpu_torch.guidance.unet import ZERO123_CONFIG, UNet
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig
from torch_cpu_cases import one_torch_thread  # noqa: F401

CTX = 16                  # tiny cross-attention width == the CLIP projection width
IMAGE = 32                # guidance image size: VAE (8, 16) gives 16^2 latents
UNET_JSON = {
    "in_channels": 8, "out_channels": 4, "block_out_channels": [8, 16], "layers_per_block": 1,
    "cross_attention_dim": CTX, "attention_head_dim": 4,
    "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "use_linear_projection": False,
}
VAE_JSON = {"in_channels": 3, "latent_channels": 4, "block_out_channels": [8, 16],
            "layers_per_block": 1, "scaling_factor": 0.18215}
CLIP_KW = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
               image_size=32, patch_size=16, projection_dim=CTX)
FORMATS = ("bin", "f32", "f16", "bf16")
ST_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def _jax_unet_config():
    return JUNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in UNET_JSON.items()})


@functools.lru_cache(maxsize=None)
def _state_dicts():
    """The snapshot's four state dicts (numpy float32), in the diffusers and
    transformers layouts; the CLIP tower's comes from transformers itself."""
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(0)
    tower = CLIPVisionModelWithProjection(HFConfig(**CLIP_KW))
    # Nonzero biases and non-unit norms, so that a swapped pair would show.
    with torch.no_grad():
        for p in tower.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    rng = np.random.default_rng(0)
    proj = {"proj.weight": (rng.normal(size=(CTX, CTX + 4)) * 0.05).astype(np.float32),
            "proj.bias": (rng.normal(size=CTX) * 0.05).astype(np.float32)}
    return {
        "unet": jsynth.synth_diffusers_unet(_jax_unet_config(), seed=0),
        "vae": jsynth.synth_diffusers_vae(JVAEConfig(block_out_channels=(8, 16),
                                                     layers_per_block=1), seed=1),
        "image_encoder": {k: v.numpy() for k, v in tower.state_dict().items()},
        "clip_camera_projection": proj,
    }, tower.config.to_dict()


def write_snapshot(root: str, fmt: str) -> str:
    """The tiny snapshot under ``root`` in ``fmt``: torch .bin files (as
    diffusers and transformers save them without safetensors) or
    safetensors written by the safetensors library in F32, F16 or BF16."""
    from safetensors.torch import save_file

    sds, clip_cfg = _state_dicts()
    configs = {"unet": UNET_JSON, "vae": VAE_JSON, "image_encoder": clip_cfg,
               "clip_camera_projection": {"embedding_dim": CTX, "additional_embeddings": 4}}
    for sub, sd in sds.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(configs[sub], f)
        tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        if fmt == "bin":
            name = "pytorch_model.bin" if sub == "image_encoder" else "diffusion_pytorch_model.bin"
            torch.save(tensors, os.path.join(root, sub, name))
        else:
            name = "model.safetensors" if sub == "image_encoder" else \
                "diffusion_pytorch_model.safetensors"
            save_file({k: v.to(ST_DTYPES[fmt]).contiguous() for k, v in tensors.items()},
                      os.path.join(root, sub, name))
    return root


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero123_snapshots")
    return {fmt: write_snapshot(str(root / fmt), fmt) for fmt in FORMATS}


def _ref_image(size=64):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    rgb = np.stack([0.2 + 0.6 * xx, 0.8 - 0.5 * yy, 0.5 + 0.3 * np.sin(6 * xx * yy)], -1)
    disc = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.12
    return np.where(disc[..., None], rgb, 1.0).astype(np.float32)


# -- state dicts and weights ---------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("sub", ["unet", "vae", "image_encoder", "clip_camera_projection"])
def test_state_dict_matches_jax_reader(snapshots, fmt, sub):
    """Bit for bit, in the stored dtype. The JAX reader returns .bin tensors
    as float32 and cannot read BF16 (numpy has no bfloat16), so BF16 is held
    against the safetensors library's own torch reader."""
    t = tconvert.load_torch_state_dict(snapshots[fmt], sub)
    if fmt == "bf16":
        from safetensors.torch import load_file

        folder = os.path.join(snapshots[fmt], sub)
        (name,) = [n for n in os.listdir(folder) if n.endswith(".safetensors")]
        ref = load_file(os.path.join(folder, name))
        assert sorted(t) == sorted(ref)
        for k, v in ref.items():
            assert t[k].dtype == torch.bfloat16 and torch.equal(t[k], v), k
        return
    j = jconvert.load_torch_state_dict(snapshots[fmt], sub)
    assert sorted(t) == sorted(j)
    for k, v in j.items():
        got = t[k].float().numpy() if fmt == "bin" else t[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_unet_and_vae_weights_equal_the_jax_conversion(snapshots):
    """The port's strict load of the .bin snapshot against the JAX package's
    convert_unet / convert_vae carried over by weights.load_unet/load_vae:
    every parameter equal."""
    root = snapshots["bin"]
    unet, vae = tloader._build_backbone(root, ZERO123_CONFIG, "cpu", torch.float32)
    jcfg = jloader._config_from_json(root, "unet", J_ZERO123_CONFIG, jloader._UNET_JSON_FIELDS)
    sd = jconvert.load_torch_state_dict(root, "unet")
    ref_unet = weights.load_unet(UNet(unet.config), jconvert.convert_unet(sd, jcfg))
    jvcfg = jloader._config_from_json(root, "vae", JVAEConfig(), jloader._VAE_JSON_FIELDS)
    ref_vae = weights.load_vae(AutoencoderKL(vae.config),
                               jconvert.convert_vae(jconvert.load_torch_state_dict(root, "vae"),
                                                    jvcfg))
    for got, ref in ((unet, ref_unet), (vae, ref_vae)):
        ref_sd = ref.state_dict()
        assert sorted(got.state_dict()) == sorted(ref_sd)
        for k, v in got.state_dict().items():
            assert torch.equal(v, ref_sd[k]), k


def test_head_count_matches_jax(snapshots):
    """The snapshot's attention_head_dim 4 is overridden by Zero123's fixed
    8 heads in both packages."""
    root = snapshots["bin"]
    unet, _ = tloader._build_backbone(root, ZERO123_CONFIG, "cpu", torch.float32)
    jcfg = jloader._config_from_json(root, "unet", J_ZERO123_CONFIG, jloader._UNET_JSON_FIELDS)
    got = {name: m.heads for name, m in unet.named_modules() if name.endswith("attn1")}
    assert len(got) == 4
    for name, heads in got.items():
        level = 0 if name.startswith(("down_0", "up_1")) else 1
        assert heads == jcfg.heads_for(jcfg.block_out_channels[level]) == 8, name


@pytest.mark.parametrize("fmt", ["f16", "bf16"])
def test_half_snapshot_loads_cast_into_each_dtype(snapshots, fmt):
    """A half-precision snapshot into float32 and bfloat16 modules: every
    parameter is its snapshot tensor cast to the module's dtype."""
    root = snapshots[fmt]
    sd = tconvert.load_torch_state_dict(root, "unet")
    for dtype in (torch.float32, torch.bfloat16):
        unet, _ = tloader._build_backbone(root, ZERO123_CONFIG, "cpu", dtype)
        params = dict(unet.named_parameters())
        assert len(params) == len(sd)
        for k, v in sd.items():
            p = params[tconvert.unet_key(k)]
            assert p.dtype == dtype and torch.equal(p, v.to(dtype)), k


# -- the CLIP tower --------------------------------------------------------------


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_tower_matches_transformers(tmp_path, act):
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(1)
    ref = CLIPVisionModelWithProjection(HFConfig(**CLIP_KW, hidden_act=act)).eval()
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    ref.save_pretrained(str(tmp_path), safe_serialization=True)
    tower = load_clip_vision(str(tmp_path), "cpu")
    assert tower.config == CLIPVisionConfig(**CLIP_KW, hidden_act=act)
    pix = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = ref(pixel_values=pix).image_embeds
        got = tower(pix)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_clip_pixel_values_match_jax():
    """The 64^2 reference shrunk to the tower's 32^2 with antialias (a
    plain bilinear resize misses by far more), normalised, NCHW."""
    img = _ref_image()
    j = jloader._clip_pixel_values(img, 32)
    t = clip_pixel_values(img, 32, "cpu").numpy()
    np.testing.assert_allclose(t, j, atol=2e-6)


# -- the guidance against JAX's load_zero123 ------------------------------------


def _jax_guidance(root, stable, anneal, dtype, monkeypatch):
    if dtype == "fp32":
        monkeypatch.setattr(jloader, "_build_backbone",
                            functools.partial(jloader._build_backbone, dtype=jnp.float32))
    return jloader.load_zero123(root, ref_image=_ref_image(), stable=stable,
                                default_elevation=-10.0, image_size=IMAGE, anneal=anneal)


def _port_guidance(root, stable, anneal, dtype):
    return tloader.load_zero123(root, ref_image=_ref_image(), stable=stable,
                                default_elevation=-10.0, image_size=IMAGE, anneal=anneal,
                                device="cpu",
                                dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)


# Tolerances, each relative to the largest entry of the JAX value: the
# reference latent, the loss, the image gradient, the refine output (in
# [0, 1], absolute). float32: the nets summed in another order (about 1e-5
# seen). bfloat16: XLA and torch round each bf16 convolution, matmul and
# activation at other points (8 bits of mantissa); seen about 0.018, 0.004,
# 0.074 and 0.025, held at about twice that.
TOL = {"fp32": (1e-4, 1e-4, 1e-4, 1e-4), "bf16": (0.04, 0.02, 0.15, 0.05)}
COND = {"vers": np.array([12.0], np.float32), "hors": np.array([-70.0], np.float32),
        "radii": np.zeros(1, np.float32)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("stable", [False, True], ids=["xl", "stable"])
def test_guidance_matches_jax_load_zero123(snapshots, monkeypatch, stable, dtype):
    """Both packages load the same .bin snapshot. Held: the CLIP embedding
    and reference latent; the SDS loss and its image gradient at two step
    ratios with the same noise (annealed timestep), and with the same
    randomly drawn timestep (anneal=False); the refine output."""
    root = snapshots["bin"]
    z_tol, l_tol, g_tol, r_tol = TOL[dtype]
    jg = _jax_guidance(root, stable, True, dtype, monkeypatch)
    tg = _port_guidance(root, stable, True, dtype)
    np.testing.assert_allclose(tg.clip_emb.numpy(), np.asarray(jg.clip_emb), atol=1e-5)
    np.testing.assert_allclose(tg.vae_latent.float().numpy(), np.asarray(jg.vae_latent, np.float32),
                               atol=z_tol * float(np.abs(jg.vae_latent).max()))
    images = np.random.default_rng(5).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    jcond = {k: jnp.asarray(v) for k, v in COND.items()}
    tcond = {k: torch.from_numpy(v) for k, v in COND.items()}

    def hold(jfn, tfn, ratio, key):
        k_t, k_n = jax.random.split(key)

        def draw(name, shape, dist, low=0, high=None):
            if name == "sds_t":
                assert dist == "randint" and (low, high) == (tg.t_min, tg.t_max + 1)
                return torch.tensor(int(jax.random.randint(k_t, (), low, high)))
            assert name == "sds_noise" and dist == "normal"
            return torch.from_numpy(np.array(jax.random.normal(k_n, shape)))

        jl, jgrad = jax.value_and_grad(lambda im: jfn(im, jcond, ratio, key))(jnp.asarray(images))
        x = torch.from_numpy(images).requires_grad_(True)
        tl = tfn(x, tcond, ratio, draw)
        tl.backward()
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=l_tol)
        np.testing.assert_allclose(x.grad.numpy(), jgrad, atol=g_tol * np.abs(jgrad).max())

    for ratio, seed in ((0.1, 3), (0.7, 4)):
        hold(jg.guidance_fn(), tg.guidance_fn(), ratio, jax.random.PRNGKey(seed))
    jg.anneal = tg.anneal = False
    hold(jg.guidance_fn(), tg.guidance_fn(), 0.5, jax.random.PRNGKey(7))

    key = jax.random.PRNGKey(11)
    j = np.asarray(jg.refine_fn(steps=5)(images, jcond, jnp.float32(0.8), key))
    k_n, _ = jax.random.split(key)
    t = tg.refine_fn(steps=5)(torch.from_numpy(images), tcond, np.float32(0.8),
                              lambda name, shape, dist: torch.from_numpy(
                                  np.array(jax.random.normal(k_n, shape))))
    assert t.shape == (1, IMAGE, IMAGE, 3)
    np.testing.assert_allclose(t.float().numpy(), j, atol=r_tol)


# -- the port's own snapshot writer, strictness, refused configs -----------------

TINY_UNET = dict(in_channels=8, block_out_channels=(8, 16), layers_per_block=1,
                 cross_attention_dim=CTX,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))


def test_synthetic_layout_matches_diffusers_and_transformers():
    """The port's snapshot writer names and shapes every tensor as the JAX
    package's synthetic diffusers state dicts and transformers' CLIP tower do."""
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    from dreamgaussian_tpu_torch.guidance.unet import UNetConfig

    j_unet = jsynth.synth_diffusers_unet(JUNetConfig(**TINY_UNET, num_attention_heads=2,
                                                     use_linear_projection=False))
    assert dict(tsynth.diffusers_unet_spec(UNetConfig(**TINY_UNET))) == \
        {k: v.shape for k, v in j_unet.items()}
    j_vae = jsynth.synth_diffusers_vae(JVAEConfig(block_out_channels=(8, 16), layers_per_block=1))
    assert dict(tsynth.diffusers_vae_spec(VAEConfig(block_out_channels=(8, 16),
                                                    layers_per_block=1))) == \
        {k: v.shape for k, v in j_vae.items()}
    hf = CLIPVisionModelWithProjection(HFConfig(**CLIP_KW))
    assert dict(tsynth.clip_vision_spec(CLIPVisionConfig(**CLIP_KW))) == \
        {k: tuple(v.shape) for k, v in hf.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_synthetic_snapshot_loads_strictly(tmp_path, dtype):
    """A snapshot the port writes reads back through the safetensors
    library bit for bit, and loads strictly into bfloat16 guidance."""
    from safetensors.torch import load_file

    from dreamgaussian_tpu_torch.guidance.unet import UNetConfig

    sizes = tsynth.write_zero123_snapshot(
        str(tmp_path), UNetConfig(**TINY_UNET), VAEConfig(block_out_channels=(8, 16),
                                                          layers_per_block=1),
        CLIPVisionConfig(**CLIP_KW), dtype=dtype, seed=3, device="cpu")
    for sub, (nbytes, values) in sizes.items():
        folder = tmp_path / sub
        (name,) = [n for n in os.listdir(folder) if n.endswith(".safetensors")]
        assert os.path.getsize(folder / name) == nbytes
        ref, got = load_file(str(folder / name)), tconvert.load_torch_state_dict(str(tmp_path), sub)
        assert sum(v.numel() for v in ref.values()) == values and sorted(ref) == sorted(got)
        for k, v in ref.items():
            assert v.dtype == dtype and torch.equal(got[k], v), k
    g = tloader.load_zero123(str(tmp_path), ref_image=_ref_image(), image_size=IMAGE,
                             device="cpu")
    sd = tconvert.load_torch_state_dict(str(tmp_path), "vae")
    params = dict(g.vae.named_parameters())
    for k, v in sd.items():
        assert torch.equal(params[tconvert.vae_key(k)], v.to(torch.bfloat16)), k
    assert g.clip_emb.shape == (1, CTX) and bool(torch.isfinite(g.vae_latent).all())


def test_strict_load_refuses_extra_and_missing_keys(snapshots, tmp_path):
    root = str(tmp_path / "snap")
    shutil.copytree(snapshots["bin"], root)
    path = os.path.join(root, "vae", "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    torch.save({**sd, "decoder.extra.weight": torch.zeros(2)}, path)
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        tloader._build_backbone(root, ZERO123_CONFIG, "cpu", torch.float32)
    sd.pop("decoder.conv_out.bias")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="no snapshot key"):
        tloader._build_backbone(root, ZERO123_CONFIG, "cpu", torch.float32)


@pytest.mark.parametrize("key,value", [("use_linear_projection", True),
                                       ("flip_sin_to_cos", False), ("freq_shift", 1),
                                       ("down_block_types", ["SimpleDownBlock2D", "DownBlock2D"])])
def test_unsupported_unet_config_raises(snapshots, tmp_path, key, value):
    root = str(tmp_path / "snap")
    shutil.copytree(snapshots["bin"], root)
    with open(os.path.join(root, "unet", "config.json"), "w") as f:
        json.dump({**UNET_JSON, key: value}, f)
    with pytest.raises(ValueError, match=key):
        tloader._build_backbone(root, ZERO123_CONFIG, "cpu", torch.float32)
