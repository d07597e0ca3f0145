"""Stage-1 checkpoints, the YAML reader without PyYAML, and the CLIs on a
snapshot: a run stopped, saved and resumed equals the uninterrupted run bit
for bit (with a densify before the save, with a capacity that grew, with
candidates waiting for room); ``final_prune=False`` against the JAX
trainer; the CLIs' resume rules; ``utils.config`` against PyYAML on every
``configs/*.yaml``; and both CLIs through ``--config configs/image.yaml``
on a tiny Zero123 snapshot with ``yaml`` unimportable."""

import functools
import glob
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.train import Stage1Trainer as JTrainer
from dreamgaussian_tpu.utils import config as jcfg
from dreamgaussian_tpu.utils.config import Config
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.guidance.fake import fake_zero123_guidance
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.scene.optim import adam_init
from dreamgaussian_tpu_torch.train import Stage1Trainer as TTrainer
from dreamgaussian_tpu_torch.utils import config as tcfg
from dreamgaussian_tpu_torch.utils.checkpoint import checkpoint_file
from test_torch_cli import OVERRIDES as GOLDEN_OVERRIDES
from test_torch_stage1 import _target
from torch_cli_cases import IMAGE_YAML, disc_png, image_options
from torch_cpu_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
SIZE = 32          # test_torch_stage1's reference size


# -- stop, save, resume ----------------------------------------------------------

# case: (capacity, log_every). "fixed": room for every densify. "grown": the
# densify at step 3 finds too few free slots and the check after that step
# doubles the capacity before the save at step 5. "pending": the same drops,
# but no check until the end of each train(): the checkpoint carries them.
RESUME_CASES = {"fixed": (512, 0), "grown": (176, 1), "pending": (176, 0)}
STOP, ITERS = 5, 8


def _trainer(capacity, guidance):
    opt = Config(dict(
        iters=ITERS, ref_size=SIZE, num_pts=160, sh_degree=0, batch_size=1,
        novel_resolutions=[SIZE, SIZE, SIZE], warmup_rgb_loss=True, density_start_iter=2,
        density_end_iter=8, densification_interval=3, opacity_reset_interval=7,
        densify_grad_threshold=0.0, elevation=0, radius=2.0, fovy=49.1,
    ))
    rgb, mask = _target()
    return TTrainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=capacity, seed=3,
                    guidance_fns=((1.0, guidance.guidance_fn()),), device="cpu")


def _state(t):
    return {**{f"p_{k}": v for k, v in t.params.items()},
            **{f"mu_{k}": v for k, v in t.adam.mu.items()},
            **{f"nu_{k}": v for k, v in t.adam.nu.items()},
            **{f"aux_{k}": v for k, v in t.aux._asdict().items()},
            "draw": t.draw.get_state()}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_equals_uninterrupted_run(tmp_path, case):
    """Fake Zero123 guidance, so that the SDS noise comes from the draw; a
    densify at step 3, before the save at step 5."""
    capacity, log_every = RESUME_CASES[case]
    guidance = fake_zero123_guidance(device="cpu")
    whole = _trainer(capacity, guidance)
    whole.train(ITERS, log_every=log_every)

    stopped = _trainer(capacity, guidance)
    stopped.train(STOP, log_every=log_every, checkpoint_every=STOP, checkpoint_dir=str(tmp_path))
    with np.load(checkpoint_file(str(tmp_path)), allow_pickle=False) as saved:
        saved_capacity = saved["p_xyz"].shape[0]
        assert int(saved["step"]) == STOP and saved["p_f_rest"].shape == (saved_capacity, 0, 3)
        assert (int(saved["densify_dropped"]) > 0) == (case == "pending")
    assert saved_capacity == (2 * capacity if case == "grown" else capacity)

    resumed = _trainer(capacity, guidance)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.step == STOP and resumed.capacity == saved_capacity
    stats = resumed.train(ITERS - STOP, log_every=log_every)
    assert stats["step"] == ITERS and stats["alive"] == int(whole.aux.alive.sum())

    assert resumed.capacity == whole.capacity
    assert resumed.adam.count == whole.adam.count == ITERS
    assert resumed.rng.bit_generator.state == whole.rng.bit_generator.state
    a, b = _state(resumed), _state(whole)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_restore_takes_every_saved_value(tmp_path):
    """A fresh trainer restored from a file holds exactly what was saved."""
    guidance = fake_zero123_guidance(device="cpu")
    src = _trainer(176, guidance)
    for _ in range(4):
        src.train_step()
    src._check_overflow()
    src.save_checkpoint(str(tmp_path))
    dst = _trainer(512, guidance)
    dst.load_checkpoint(str(tmp_path))
    assert dst.step == 4 and dst.capacity == src.capacity == 352
    assert dst.rng.bit_generator.state == src.rng.bit_generator.state
    a, b = _state(dst), _state(src)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # The two trainers draw the same next camera and the same next noise.
    assert dst.rng.integers(0, 1 << 30) == src.rng.integers(0, 1 << 30)
    assert torch.equal(dst.draw("x", (4,), "normal"), src.draw("x", (4,), "normal"))


# -- final_prune against the JAX trainer --------------------------------------------


def _prune_opt(final_prune):
    # No step is in the density window: the live screen radii stay 0 (with
    # them, the prune takes every gaussian of so short a run), and the prune
    # removes the gaussians whose world scale exceeds a tenth of the extent.
    return Config(dict(
        iters=4, ref_size=SIZE, num_pts=160, sh_degree=0, batch_size=1,
        novel_resolutions=[SIZE, SIZE, SIZE], warmup_rgb_loss=True, density_start_iter=100,
        elevation=0, radius=2.0, fovy=49.1, final_prune=final_prune,
    ))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX trainer's 4 steps without the final prune, then the prune as
    its train() applies it with final_prune=True: (initial state, alive
    without, alive with)."""
    rgb, mask = _target()
    jt = JTrainer(_prune_opt(False), ref_rgb=rgb, ref_mask=mask, capacity=256, seed=0)
    init = (jax.device_get(jt.params), jax.device_get(jt.aux))
    jt.train(4, log_every=0, scan_chunk=0)
    without = np.asarray(jt.aux.alive)
    _, _, aux = jt._prune_final(jt.params, jt.adam, jt.aux)
    return init, without, np.asarray(aux.alive)


@pytest.mark.parametrize("final_prune", [True, False])
def test_final_prune_matches_jax(final_prune):
    init, without, pruned = _jax_run()
    rgb, mask = _target()
    tt = TTrainer(_prune_opt(final_prune), ref_rgb=rgb, ref_mask=mask, capacity=256, device="cpu")
    tt.params, tt.aux = weights.gaussians_from_numpy(*init, device="cpu")
    tt.adam = adam_init(tt.params)
    stats = tt.train(4, log_every=0)
    want = pruned if final_prune else without
    assert 0 < int(pruned.sum()) < int(without.sum()) == 160     # the prune removes some
    np.testing.assert_array_equal(tt.aux.alive.numpy(), want)
    assert stats["alive"] == int(want.sum())


# -- the CLIs' resume rules -----------------------------------------------------------

CLI_ARGS = ["save_path=s", "ref_size=32", "num_pts=256", "capacity=512",
            "novel_resolutions=[32,32,32]", "density_start_iter=2", "density_end_iter=12",
            "densification_interval=2", "opacity_reset_interval=10000", "texture_size=64",
            "bake_resolution=32", "mc_resolution=32", "decimate_target=2000",
            "density_thresh=0.2", "iters_refine=2", "novel_resolution=64", "refine_steps=3",
            "device=cpu"]


def test_resume_without_checkpoint_dir_trains_from_step_0(tmp_path):
    """As the JAX CLI: resume=True resumes only from an existing
    checkpoint_dir; without one (or with a missing one) it trains from 0."""
    png = disc_png(tmp_path / "d.png")
    base = ["--config", str(IMAGE_YAML), f"input={png}", f"outdir={tmp_path}", *CLI_ARGS,
            "fake_guidance=True", "iters=3", "save_mesh=False", "resume=True",
            "checkpoint_every=2"]
    assert tcli1.main(base)["step"] == 3
    assert tcli1.main(base + [f"checkpoint_dir={tmp_path / 'none'}"])["step"] == 3
    assert os.path.exists(checkpoint_file(str(tmp_path / "none")))   # written at step 2


def test_both_clis_on_a_snapshot_without_pyyaml(tmp_path, monkeypatch):
    """``python -m ...cli.main --config configs/image.yaml ... zero123_ckpt=``
    on a tiny F16 snapshot, with ``yaml`` unimportable: stage 1 stopped at
    its checkpoint, resumed to ``iters`` with the export, then ``cli.main2``
    with the same snapshot (which takes resume and checkpoint_every and
    leaves them to stage 1)."""
    from dreamgaussian_tpu_torch.guidance.clip import CLIPVisionConfig
    from dreamgaussian_tpu_torch.guidance.synthetic import write_zero123_snapshot
    from dreamgaussian_tpu_torch.guidance.unet import UNetConfig
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig

    monkeypatch.setitem(sys.modules, "yaml", None)
    snap = str(tmp_path / "snap")
    # Four VAE levels: 32^2 latents at the CLIs' 256^2 guidance images.
    write_zero123_snapshot(
        snap, UNetConfig(in_channels=8, block_out_channels=(8, 16), layers_per_block=1,
                         cross_attention_dim=16,
                         down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                         up_block_types=("UpBlock2D", "CrossAttnUpBlock2D")),
        VAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1),
        CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2, image_size=32, patch_size=16, projection_dim=16),
        dtype=torch.float16, seed=1, device="cpu")
    ckpt = tmp_path / "ckpt"
    argv = ["--config", str(IMAGE_YAML), f"input={disc_png(tmp_path / 'd.png')}",
            f"outdir={tmp_path}", f"zero123_ckpt={snap}", *CLI_ARGS, "checkpoint_every=4",
            f"checkpoint_dir={ckpt}"]
    first = tcli1.main(argv + ["iters=4", "save_mesh=False"])
    assert first["step"] == 4 and os.path.exists(checkpoint_file(str(ckpt)))
    second = tcli1.main(argv + ["iters=6", "resume=True"])
    assert second["step"] == 6 and np.isfinite(second["loss"])
    refined = tcli2.main(argv + ["iters=6", "resume=True"])
    assert np.isfinite(refined["loss"])
    stage1 = Mesh.load(str(tmp_path / "s_mesh.obj"), resize=False)
    mesh = Mesh.load(str(tmp_path / "s.obj"), resize=False)
    assert len(mesh.f) > 0 and np.array_equal(mesh.f, stage1.f)
    assert mesh.albedo.shape == (64, 64, 3) and np.abs(mesh.albedo - stage1.albedo).max() > 0


# -- the YAML subset -----------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_matches_pyyaml_without_pyyaml(path, monkeypatch):
    """Every configs/*.yaml with the golden run's overrides, read by the
    port with ``yaml`` unimportable, against the JAX package's reader
    (PyYAML)."""
    want = jcfg.load_with_cli(path, GOLDEN_OVERRIDES)
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = tcfg.load_with_cli(path, GOLDEN_OVERRIDES)
    assert dict(got) == dict(want) and type(got["novel_resolutions"]) is list


def test_image_options_read_through_the_port():
    assert image_options() == dict(tcfg.load(IMAGE_YAML))


SCALARS = ["", "null", "True", "false", "0", "-12", "0.5", "-0.5", "5.", "1.5e-3", "0.00002",
           "abc", "a photo of a cat", "x#y", "a #comment", "'???'", "'a, b' # c", '"a, b"',
           "[32,32,32]", "[1, c, true]", "[]"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_matches_pyyaml(text):
    import yaml

    want = yaml.safe_load(text)
    got = tcfg.parse_scalar(text)
    assert got == want and type(got) is type(want)


def test_dotless_exponent_is_a_float():
    """YAML 1.1 reads ``1e-3`` as a string; the configs' readers take it as
    the number it is (the JAX CLI parses dotlist values so, too)."""
    assert tcfg.parse_scalar("1e-3") == 0.001 == jcfg.from_cli(["x=1e-3"])["x"]


@pytest.mark.parametrize("text", ["007", "0x1f", "1:30", "2001-12-14", "{a: 1}", "a: b",
                                  "- x", "&anchor", "!tag x", "[a, [b]]", "[1,,2]", "'open",
                                  "'a' b", "'it''s'", '"a\\tb"', "[1, 'a,b']"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        tcfg.parse_scalar(text)


@pytest.mark.parametrize("doc", ["a:\n  b: 1\n", "  a: 1\n", "- a\n", "a 1\n", "---\na: 1\n"])
def test_nested_or_block_yaml_raises(doc):
    with pytest.raises(ValueError):
        tcfg.parse_yaml(doc)
