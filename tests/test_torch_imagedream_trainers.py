"""The port's trainers and CLIs on ``configs/imagedream.yaml`` against the JAX
package: two ``Stage1Trainer`` steps and one ``Stage2Trainer`` step with the
fake ImageDream on carried weights (4-view camera groups at hor + 90 i,
poses in ``cond``, the input image taken by the guidance and no known
view, the known camera of stage 2 at azimuth 90, JAX's SDS and refine noise
injected); both CLIs on ``imagedream.yaml`` with the fake and on a tiny
ipmv ``.pt`` the port writes, with and without a prompt; the warning
without a prior; the device policy of the new entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.guidance import fake as jfake
from dreamgaussian_tpu.guidance.unet import TinyUNet as JTinyUNet
from dreamgaussian_tpu.train import Stage1Trainer as JStage1
from dreamgaussian_tpu.train import Stage2Trainer as JStage2
from dreamgaussian_tpu.utils.config import load_with_cli as j_load_with_cli
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.cli import dream as tdream
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.guidance import fake as tfake
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.clip import CLIPVisionConfig
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet as TTinyUNet
from dreamgaussian_tpu_torch.scene.optim import adam_init
from dreamgaussian_tpu_torch.train import Stage1Trainer as TStage1
from dreamgaussian_tpu_torch.train import Stage2Trainer as TStage2
from dreamgaussian_tpu_torch.utils.config import load_with_cli as t_load_with_cli
from test_stage2 import sphere_mesh_uv
from test_torch_stage1 import JaxDraws
from test_torch_stage2 import JaxRefineDraws
from test_torch_text import CLI_UNET, CLI_VAE, CTX, OVERRIDES, read_cli_outputs
from torch_cli_cases import disc_png
from torch_cpu_cases import one_torch_thread  # noqa: F401

YAML = "configs/imagedream.yaml"


def _np(x):
    return torch.from_numpy(np.array(x))


# -- the trainers on configs/imagedream.yaml ----------------------------------------------

TRAIN_OVERRIDES = ["iters=10", "num_pts=160", "novel_resolutions=[32,32,32]",
                   "density_start_iter=100", "novel_resolution=32", "iters_refine=10",
                   "ref_size=32", "prompt=a plush toy"]
REF = np.random.default_rng(3).uniform(size=(32, 32, 3)).astype(np.float32)


def _fake_pair():
    """The JAX fake ImageDream and the port's on its carried weights (the
    flax TinyUNet the JAX fake inits from its seed, its text states, image
    tokens and identity latent)."""
    jg = jfake.fake_imagedream_guidance()
    p = JTinyUNet(channels=16, context_dim=32, out_channels=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 2, 32)))
    x = np.random.default_rng(0).normal(size=(10, 8, 8, 4)).astype(np.float32)
    ctx = np.asarray(jg.emb["pos"])[None].repeat(10, 0)
    np.testing.assert_array_equal(
        np.asarray(jg.backbone.unet_apply(x, jnp.full(10, 3.0), ctx, camera=jnp.ones((10, 16)))),
        np.asarray(JTinyUNet(16, 32, 4).apply(p, x, jnp.full(10, 3.0), ctx)))
    unet = weights.load_tiny_unet(TTinyUNet(in_channels=4), jax.device_get(p))
    tg = tsds.ImageDreamGuidance(unet, tfake.PoolVAE(8, 64),
                                 {k: _np(v) for k, v in jg.emb.items()},
                                 {k: _np(v) for k, v in jg.img_emb.items()}, image_size=64)
    return jg, tg


def test_stage1_steps_on_imagedream_follow_jax():
    """Two steps from the same carried-over cloud with an input image: 4 views
    per sampled camera (hor + 90 i, poses in cond), no known view, the same
    SDS noise: loss to 1e-4 and every parameter as test_torch_stage1 holds
    them."""
    jg, tg = _fake_pair()
    jopt = j_load_with_cli(YAML, TRAIN_OVERRIDES)
    topt = t_load_with_cli(YAML, TRAIN_OVERRIDES)
    jt = JStage1(jopt, ref_rgb=REF, ref_mask=REF[..., 0], capacity=256, seed=1,
                 guidance_fns=((1.0, jg.guidance_fn()),))
    draws = JaxDraws(1, 160)
    tt = TStage1(topt, ref_rgb=REF, ref_mask=REF[..., 0], capacity=256, seed=1,
                 guidance_fns=((1.0, tg.guidance_fn()),), device="cpu", draw=draws)
    assert tt.n_views == 4 and not tt.use_known_view and not jt.use_known_view
    tt.params, tt.aux = weights.gaussians_from_numpy(jax.device_get(jt.params),
                                                      jax.device_get(jt.aux), device="cpu")
    tt.adam = adam_init(tt.params)
    for step in (1, 2):
        jl, tl = float(jt.train_step()), float(tt.train_step())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step}")
    assert draws.names.count("sds_noise") == 2
    lr = {"xyz": 1e-2, "f_dc": 1e-2, "f_rest": 5e-4, "opacity": 5e-2, "scaling": 5e-3,
          "rotation": 5e-3}
    for k, v in jt.params.items():
        ref, got = np.asarray(v), tt.params[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.02 * lr[k], err_msg=k)


def test_stage2_step_on_imagedream_follows_jax():
    """One step on the sphere with an input image: 4 novel views at
    hor + 90 i, the ImageDream refine with JAX's noise, no known view, the
    known camera at azimuth 90; the loss to 1e-4 and the texture logits to
    1% of one learning rate."""
    jg, tg = _fake_pair()
    over = TRAIN_OVERRIDES + ["refine_steps=10"]
    jopt, topt = j_load_with_cli(YAML, over), t_load_with_cli(YAML, over)
    jt = JStage2(jopt, sphere_mesh_uv(), ref_rgb=REF, ref_mask=REF[..., 0],
                 refine_fns=((0.5,) + jg.refine_args(steps=10),), refine_image_size=64, seed=2)
    draws = JaxRefineDraws(2)
    tt = TStage2(topt, sphere_mesh_uv(), ref_rgb=REF, ref_mask=REF[..., 0],
                 refine_fns=((0.5, tg.refine_fn(steps=10)),), refine_image_size=64, seed=2,
                 device="cpu", draw=draws)
    assert tt.n_views == 4 and not tt.use_known_view and not jt.use_known_view
    np.testing.assert_array_equal(tt.fixed_cam.view, jt.fixed_cam.view)
    jl, tl = float(jt.train_step()), float(tt.train_step())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert draws.names == ["refine_noise"]
    np.testing.assert_allclose(tt.params["raw_albedo"].numpy(), np.asarray(jt.params["raw_albedo"]),
                               rtol=1e-4, atol=0.01 * topt["texture_lr"])


# -- the CLIs on configs/imagedream.yaml -----------------------------------------------------

# An ipmv UNet at the CLI's widths: 4 image tokens from a 16-wide resampler
# (one head of 64 or less, as the loader reads it) of the tiny image
# encoder's 5 tokens of width 20.
CLI_IMAGEDREAM = dataclasses.replace(CLI_UNET, num_views=5, ip_dim=4, ip_embed_dim=20,
                                     ip_resampler_dim=16, ip_resampler_depth=2,
                                     ip_resampler_heads=1)
CLI_CLIP = CLIPVisionConfig(hidden_size=20, intermediate_size=40, num_hidden_layers=2,
                            num_attention_heads=2, image_size=16, patch_size=8, hidden_act="gelu")


def write_tiny_ipmv(folder) -> str:
    path = str(folder / "sd-v2.1-base-4view-ipmv.pt")
    folder.mkdir()
    tsynth.write_imagedream_checkpoint(path, CLI_IMAGEDREAM, CLI_VAE, CLI_CLIP, text_width=CTX,
                                       text_layers=3, vocab_size=1024, dtype=torch.float16,
                                       seed=2, device="cpu")
    return path


@pytest.mark.parametrize("prior,prompt", [("fake", True), ("ldm_file", False)])
def test_both_clis_on_imagedream_yaml(tmp_path, prior, prompt):
    """``cli.main`` then ``cli.main2`` on configs/imagedream.yaml with a disc
    RGBA input: the fake ImageDream, or a tiny ipmv .pt with its tokenizer
    and image encoder beside it; the branch is taken with an empty prompt
    too."""
    extra = ["fake_guidance=True"] if prior == "fake" else \
        [f"sd_ckpt={write_tiny_ipmv(tmp_path / 'ipmv')}"]
    over = [o for o in OVERRIDES if prompt or not o.startswith("prompt=")]
    argv = ["--config", YAML, f"outdir={tmp_path}", f"input={disc_png(tmp_path / 'd.png', 256)}",
            *over, "save_path=id", *extra]
    opt = t_load_with_cli(argv[1], argv[2:])
    assert bool(opt.get("prompt", None)) == prompt
    (weight, _), = tcli1.build_guidances(opt, np.ones((256, 256, 3), np.float32), "cpu")
    assert weight == 1
    stats = tcli1.main(argv)
    assert stats["step"] == 4 and np.isfinite(stats["loss"])
    assert np.isfinite(tcli2.main(argv)["loss"])
    read_cli_outputs(str(tmp_path), "id")


def test_imagedream_clis_warn_without_a_prior(tmp_path, capsys):
    opt = t_load_with_cli(YAML, [f"outdir={tmp_path}", *OVERRIDES])
    assert tcli1.build_guidances(opt, REF, "cpu") == ()
    assert tcli2.build_refiners(opt, REF, "cpu") == ((), None)
    assert capsys.readouterr().out.count("imagedream needs sd_ckpt or fake_guidance") == 2


def test_imagedream_entry_points_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dreamgaussian_tpu_torch.guidance import loader
    from dreamgaussian_tpu_torch.guidance.realarch import random_imagedream_guidance

    path = str(tmp_path / "ipmv.pt")
    calls = (tfake.fake_imagedream_guidance, random_imagedream_guidance,
             lambda: loader.load_imagedream(path, REF, "a cup"),
             lambda: tsynth.write_imagedream_checkpoint(path, CLI_IMAGEDREAM, CLI_VAE, CLI_CLIP),
             lambda: tdream.main(["a cup", "--mode", "sd", "--fake"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tfake.fake_imagedream_guidance(device="cpu").num_parameters() > 0
