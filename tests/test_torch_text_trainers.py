"""The port's trainers and CLIs on ``configs/text_mv.yaml`` against the JAX
package: two ``Stage1Trainer`` steps and one ``Stage2Trainer`` step with the
fake MVDream on carried weights (the 4-view camera groups at hor + 90 i,
poses in ``cond``, no known view, JAX's SDS and refine noise injected);
both CLIs on ``text_mv.yaml`` with the fake and on a tiny single-file LDM
checkpoint the port writes; the device policy of the text entry points."""

import dataclasses
import os

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
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.guidance import fake as tfake
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance import synthetic as tsynth
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet as TTinyUNet
from dreamgaussian_tpu_torch.scene.optim import adam_init
from dreamgaussian_tpu_torch.train import Stage1Trainer as TStage1
from dreamgaussian_tpu_torch.train import Stage2Trainer as TStage2
from dreamgaussian_tpu_torch.utils.config import load_with_cli as t_load_with_cli
from test_stage2 import sphere_mesh_uv
from test_torch_stage1 import JaxDraws
from test_torch_stage2 import JaxRefineDraws
from test_torch_text import CLI_UNET, CLI_VAE, CTX, OVERRIDES, read_cli_outputs
from torch_cpu_cases import one_torch_thread  # noqa: F401


def _np(x):
    return torch.from_numpy(np.array(x))


# -- the trainers on configs/text_mv.yaml -------------------------------------------------

TRAIN_OVERRIDES = ["iters=10", "num_pts=160", "novel_resolutions=[32,32,32]",
                   "density_start_iter=100", "novel_resolution=32", "iters_refine=10",
                   "prompt=a hamburger"]


def _fake_pair():
    """The JAX fake MVDream and the port's on its carried weights (the flax
    TinyUNet init the JAX fake makes from its seed, its embeddings)."""
    jg = jfake.fake_mvdream_guidance()
    p = JTinyUNet(channels=16, context_dim=32, out_channels=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 2, 32)))
    x = np.random.default_rng(0).normal(size=(4, 8, 8, 4)).astype(np.float32)
    ctx = np.asarray(jg.emb["pos"])[None].repeat(4, 0)
    np.testing.assert_array_equal(np.asarray(jg.backbone.unet_apply(x, jnp.full(4, 3.0), ctx)),
                                  np.asarray(JTinyUNet(16, 32, 4).apply(p, x, jnp.full(4, 3.0),
                                                                        ctx)))
    unet = weights.load_tiny_unet(TTinyUNet(in_channels=4), jax.device_get(p))
    tg = tsds.MVDreamGuidance(unet, tfake.PoolVAE(8, 64),
                              {k: _np(v) for k, v in jg.emb.items()}, image_size=64)
    return jg, tg


def test_stage1_steps_on_text_mv_follow_jax():
    """Two steps from the same carried-over cloud: 4 views per sampled
    camera (hor + 90 i, poses in cond), no known view, the same SDS noise:
    loss to 1e-4 and every parameter as test_torch_stage1 holds them."""
    jg, tg = _fake_pair()
    jopt = j_load_with_cli("configs/text_mv.yaml", TRAIN_OVERRIDES)
    topt = t_load_with_cli("configs/text_mv.yaml", TRAIN_OVERRIDES)
    jt = JStage1(jopt, capacity=256, seed=1, guidance_fns=((1.0, jg.guidance_fn()),))
    draws = JaxDraws(1, 160)
    tt = TStage1(topt, capacity=256, seed=1, guidance_fns=((1.0, tg.guidance_fn()),),
                 device="cpu", draw=draws)
    assert tt.n_views == 4 and not tt.use_known_view
    tt.params, tt.aux = weights.gaussians_from_numpy(jax.device_get(jt.params),
                                                      jax.device_get(jt.aux), device="cpu")
    tt.adam = adam_init(tt.params)
    cams_t, _, hors_t, poses_t = tt._sample_novel_cameras(32)
    cams_j, _, hors_j, poses_j = jt._sample_novel_cameras(32)
    np.testing.assert_array_equal(poses_t, poses_j)
    assert len(cams_t) == 4 and len(hors_t) == 1
    for step in (1, 2):
        jl, tl = float(jt.train_step()), float(tt.train_step())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step}")
    assert draws.names.count("sds_noise") == 2
    lr = {"xyz": 1e-2, "f_dc": 1e-2, "f_rest": 5e-4, "opacity": 5e-2, "scaling": 5e-3,
          "rotation": 5e-3}
    for k, v in jt.params.items():
        ref, got = np.asarray(v), tt.params[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.02 * lr[k], err_msg=k)


def test_stage2_step_on_text_mv_follows_jax():
    """One step on the sphere: 4 novel views at hor + 90 i, the MVDream
    refine with JAX's noise, no known view; the loss to 1e-4 and the texture
    logits to 1% of one learning rate."""
    jg, tg = _fake_pair()
    jopt = j_load_with_cli("configs/text_mv.yaml", TRAIN_OVERRIDES + ["refine_steps=10"])
    topt = t_load_with_cli("configs/text_mv.yaml", TRAIN_OVERRIDES + ["refine_steps=10"])
    jt = JStage2(jopt, sphere_mesh_uv(), refine_fns=((0.5,) + jg.refine_args(steps=10),),
                 refine_image_size=64, seed=2)
    draws = JaxRefineDraws(2)
    tt = TStage2(topt, sphere_mesh_uv(), refine_fns=((0.5, tg.refine_fn(steps=10)),),
                 refine_image_size=64, seed=2, device="cpu", draw=draws)
    assert tt.n_views == 4
    np.testing.assert_array_equal(tt.fixed_cam.view, jt.fixed_cam.view)
    jl, tl = float(jt.train_step()), float(tt.train_step())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert draws.names == ["refine_noise"]
    np.testing.assert_allclose(tt.params["raw_albedo"].numpy(), np.asarray(jt.params["raw_albedo"]),
                               rtol=1e-4, atol=0.01 * topt["texture_lr"])


# -- the CLIs on configs/text_mv.yaml ----------------------------------------------------


@pytest.mark.parametrize("prior", ["fake", "ldm_file"])
def test_both_clis_on_text_mv_yaml(tmp_path, prior):
    """``cli.main`` then ``cli.main2`` on configs/text_mv.yaml: the fake
    MVDream, or a tiny single-file LDM checkpoint the port writes (its
    architecture read from the file, its tokenizer beside it)."""
    extra = ["fake_guidance=True"]
    if prior == "ldm_file":
        path = str(tmp_path / "mv" / "sd-v2.1-base-4view.pt")
        os.makedirs(os.path.dirname(path))
        cfg = dataclasses.replace(CLI_UNET, num_views=4)
        tsynth.write_mvdream_checkpoint(path, cfg, CLI_VAE, text_width=CTX, text_layers=3,
                                        vocab_size=1024, dtype=torch.float16, seed=2,
                                        device="cpu")
        extra = [f"sd_ckpt={path}"]
    argv = ["--config", "configs/text_mv.yaml", f"outdir={tmp_path}", *OVERRIDES,
            "save_path=mv", *extra]
    stats = tcli1.main(argv)
    assert stats["step"] == 4 and np.isfinite(stats["loss"])
    assert np.isfinite(tcli2.main(argv)["loss"])
    read_cli_outputs(str(tmp_path), "mv")


def test_text_entry_points_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dreamgaussian_tpu_torch.guidance import loader
    from dreamgaussian_tpu_torch.guidance.realarch import random_mvdream_guidance

    calls = (tfake.fake_sd_guidance, tfake.fake_mvdream_guidance, random_mvdream_guidance,
             lambda: loader.load_stable_diffusion(str(tmp_path), "a cup"),
             lambda: loader.load_mvdream(str(tmp_path), "a cup"),
             lambda: tsynth.write_sd_snapshot(str(tmp_path), CLI_UNET, CLI_VAE, None),
             lambda: tsynth.write_mvdream_checkpoint(str(tmp_path / "m.pt"), CLI_UNET, CLI_VAE))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tfake.fake_sd_guidance(device="cpu").num_parameters() > 0
