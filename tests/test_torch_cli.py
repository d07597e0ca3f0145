"""The port's CLIs: ``load_rgba`` against the JAX package's (which decodes
with cv2 and shrinks with ``cv2.INTER_AREA``), both CLIs end to end on the
CPU at the golden run's sizes with every output file read back, a
missing snapshot, the device mesh that is not ported yet, and the device
policy."""

import numpy as np
import pytest
import torch

from dreamgaussian_tpu.cli.process import load_rgba as j_load_rgba
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.cli.process import load_rgba as t_load_rgba
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.scene import load_ply
from dreamgaussian_tpu_torch.utils.config import load_with_cli
from dreamgaussian_tpu_torch.utils.png import write_png
from torch_cli_cases import IMAGE_YAML, disc_png, image_options
from torch_cpu_cases import one_torch_thread  # noqa: F401


def test_image_options_read_as_yaml_reads_them():
    """The card tests read configs/image.yaml without PyYAML."""
    import yaml

    with open(IMAGE_YAML) as f:
        assert image_options() == yaml.safe_load(f)


@pytest.mark.parametrize("src,dst", [(512, 256), (300, 256), (64, 32)])
def test_load_rgba_matches_jax(tmp_path, src, dst):
    rng = np.random.default_rng(src)
    rgba = rng.integers(0, 256, size=(src, src, 4), dtype=np.uint8)
    path = str(tmp_path / "in.png")
    write_png(path, rgba)
    t = t_load_rgba(path, size=dst)
    assert t.shape == (dst, dst, 4) and t.dtype == np.float32
    np.testing.assert_array_equal(t, j_load_rgba(path, size=dst))
    np.testing.assert_array_equal(t_load_rgba(path), rgba.astype(np.float32) / 255.0)


def test_load_rgba_refuses_what_needs_matting(tmp_path):
    path = str(tmp_path / "rgb.png")
    write_png(path, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="matting"):
        t_load_rgba(path)


OVERRIDES = [   # tests/test_golden_e2e.py's run, on the CPU
    "save_path=golden", "iters=16", "ref_size=32", "num_pts=256", "capacity=512",
    "novel_resolutions=[32,32,32]", "density_start_iter=4", "density_end_iter=12",
    "densification_interval=4", "opacity_reset_interval=10000", "fake_guidance=True",
    "texture_size=64", "bake_resolution=32", "mc_resolution=32", "decimate_target=2000",
    "iters_refine=3", "novel_resolution=64", "refine_steps=3", "density_thresh=0.2",
    "device=cpu",
]


def test_both_clis_end_to_end_on_the_cpu(tmp_path):
    argv = ["--config", "configs/image.yaml", f"input={disc_png(tmp_path / 'disc.png')}",
            f"outdir={tmp_path}", *OVERRIDES]
    tcli1.main(argv)
    tcli2.main(argv)

    params, aux, _ = load_ply(str(tmp_path / "golden_model.ply"), capacity=1024, device="cpu")
    n = int(aux.alive.sum())
    assert n > 0 and all(bool(torch.isfinite(v[:n]).all()) for v in params.values())
    for name in ("golden_mesh.obj", "golden.obj"):
        mesh = Mesh.load(str(tmp_path / name), resize=False)
        assert len(mesh.f) > 0 and np.isfinite(mesh.v).all(), name
        assert mesh.f.max() < len(mesh.v) and mesh.ft.max() < len(mesh.vt), name
        assert mesh.albedo.shape == (64, 64, 3), name
    stage1 = Mesh.load(str(tmp_path / "golden_mesh.obj"), resize=False)
    refined = Mesh.load(str(tmp_path / "golden.obj"), resize=False)
    np.testing.assert_array_equal(refined.f, stage1.f)
    assert np.abs(refined.albedo - stage1.albedo).max() > 0      # the texture was refined


@pytest.mark.parametrize("config,key", [("configs/image.yaml", "zero123_ckpt"),
                                        ("configs/text.yaml", "sd_ckpt")])
def test_missing_snapshot_raises(tmp_path, config, key):
    opt = load_with_cli(config, [f"input={disc_png(tmp_path / 'd.png')}", "prompt=a cup",
                                 f"outdir={tmp_path}", *OVERRIDES, f"{key}={tmp_path / 'none'}"])
    for cli in (tcli1, tcli2):
        with pytest.raises(FileNotFoundError, match="no model weights"):
            cli.run(opt)


def test_stage1_device_mesh_raises(tmp_path):
    opt = load_with_cli("configs/image.yaml", [f"outdir={tmp_path}", *OVERRIDES, "mesh=data4"])
    with pytest.raises(NotImplementedError, match="sharding"):
        tcli1.run(opt)


def test_clis_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    opt = load_with_cli("configs/image.yaml", [f"outdir={tmp_path}", *OVERRIDES[:-1]])
    for cli in (tcli1, tcli2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.run(opt)
