"""The text-to-image samplers of the PyTorch port against the JAX package's
(``sample_fn`` of SD, MVDream and ImageDream on carried weights, JAX's
initial noise injected), and ``cli.dream`` in every mode, with ``--fake``
and on tiny checkpoints the port writes, each PNG read back."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu_torch.cli import dream as tdream
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.clip import CLIPVisionConfig
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet, UNet
from dreamgaussian_tpu_torch.utils.png import read_png
from test_torch_imagedream import IMAGE as ID_IMAGE
from test_torch_imagedream import id_guidances
from test_torch_mvdream import IMAGE as MV_IMAGE
from test_torch_mvdream import _mv_guidances, _poses
from test_torch_text import CLI_TEXT, CLI_UNET, CLI_VAE, CTX
from test_torch_text import IMAGE as SD_IMAGE
from test_torch_text import _embeddings, _sd_guidances
from torch_cli_cases import disc_png
from torch_cpu_cases import one_torch_thread  # noqa: F401


def _np(x):
    return torch.from_numpy(np.array(x))


def _guidances(mode):
    """Both packages' guidance of ``mode`` on carried tiny nets. The VAE (4,
    8) halves the side: the JAX backbone's latent side is set to it."""
    jg, tg = {"sd": lambda: _sd_guidances(_embeddings()), "mvdream": _mv_guidances,
              "imagedream": id_guidances}[mode]()
    size = {"sd": SD_IMAGE, "mvdream": MV_IMAGE, "imagedream": ID_IMAGE}[mode]
    jg.backbone = jg.backbone._replace(latent_size=size // 2)
    assert tg.latent_size == size // 2
    return jg, tg


@pytest.mark.parametrize("mode", ["sd", "mvdream", "imagedream"])
def test_sampler_matches_jax(mode):
    """Eight DDIM steps from JAX's initial noise with CFG 7.5 (SD [pos, neg],
    one image; MVDream [neg, pos], one group of 4 views) or 5 (ImageDream,
    4 views with the identity view): the decoded images in [0, 1] to 1e-4.
    The first steps divide the float32 difference of the nets by
    sqrt(alpha_t) (about 1/15 at t = 875) after CFG amplifies it."""
    jg, tg = _guidances(mode)
    key = jax.random.PRNGKey(21)
    draws = []

    def draw(name, shape, dist):
        draws.append(name)
        assert name == "sample_noise" and dist == "normal"
        return _np(jax.random.normal(key, shape))

    if mode == "sd":
        j = np.asarray(jg.sample_fn(steps=8)(key))
        t = tg.sample_fn(steps=8)(draw)
    else:
        poses = _poses(1, 22)
        j = np.asarray(jg.sample_fn(steps=8)(jnp.asarray(poses), key))
        t = tg.sample_fn(steps=8)(_np(poses), draw)
    assert draws == ["sample_noise"] and tuple(t.shape) == j.shape
    assert j.shape[0] == (1 if mode == "sd" else 4)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4)


def _ckpt(tmp_path, mode):
    """A tiny checkpoint of ``mode`` in its real layout: SD's diffusers
    snapshot (512^2 images through a VAE of 8x), MVDream's and ImageDream's
    single LDM files (256^2 views; ImageDream's with a CLIP image encoder of
    5 tokens of width 20 beside it)."""
    root = tmp_path / mode
    root.mkdir()
    if mode == "sd":
        tsynth.write_sd_snapshot(str(root), CLI_UNET, CLI_VAE, CLI_TEXT, dtype=torch.float16,
                                 seed=1, device="cpu")
        return str(root)
    path = str(root / f"{mode}.pt")
    kw = dict(text_width=CTX, text_layers=3, vocab_size=1024, dtype=torch.float16, seed=2,
              device="cpu")
    if mode == "mvdream":
        tsynth.write_mvdream_checkpoint(path, dataclasses.replace(CLI_UNET, num_views=4),
                                        CLI_VAE, **kw)
    else:
        cfg = dataclasses.replace(CLI_UNET, num_views=5, ip_dim=4, ip_embed_dim=20,
                                  ip_resampler_dim=16, ip_resampler_depth=2, ip_resampler_heads=1)
        clip = CLIPVisionConfig(hidden_size=20, intermediate_size=40, num_hidden_layers=2,
                                num_attention_heads=2, image_size=16, patch_size=8,
                                hidden_act="gelu")
        tsynth.write_imagedream_checkpoint(path, cfg, CLI_VAE, clip, **kw)
    return path


@pytest.mark.parametrize("prior", ["fake", "ckpt"])
@pytest.mark.parametrize("mode", ["sd", "mvdream", "imagedream"])
def test_dream_cli(tmp_path, monkeypatch, mode, prior):
    """``cli.dream`` at 3 steps: one UNet call per step, the PNG read back as
    one image (SD) or a 2x2 grid of the 4 views (MVDream, ImageDream): 64^2
    images with the fake, the priors' 512^2 and 256^2 on a checkpoint."""
    calls = []
    for cls in (UNet, TinyUNet):
        shipped = cls.forward
        monkeypatch.setattr(cls, "forward", lambda self, *a, _f=shipped, **kw: (
            calls.append(a[0].shape), _f(self, *a, **kw))[1])
    out = str(tmp_path / "out.png")
    argv = ["a hamburger", "--mode", mode, "--steps", "3", "--device", "cpu", "--out", out,
            "--image", disc_png(tmp_path / "disc.png", size=256), "--seed", "4"]
    argv += ["--fake"] if prior == "fake" else ["--ckpt", _ckpt(tmp_path, mode)]
    assert tdream.main(argv) == out
    view = 64 if prior == "fake" else (512 if mode == "sd" else 256)
    side = view if mode == "sd" else 2 * view
    img = read_png(out)
    assert img.shape == (side, side, 3) and img.dtype == np.uint8
    assert len(calls) == 3 and img.std() > 0
