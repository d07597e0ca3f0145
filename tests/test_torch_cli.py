"""The port's CLIs: ``load_rgba`` against the JAX package's (which decodes
with cv2 and shrinks with ``cv2.INTER_AREA``), both CLIs end to end on the
CPU at the golden run's sizes with every output file read back and their
renders held against the JAX package's golden renders, a missing
snapshot, a device mesh whose size is not the number of ranks, and the
device policy.

The golden run (``tests/test_golden_e2e.py``) is the JAX CLIs' stage 1,
export and stage 2 on its fake Zero123 guidance at seed 0. The port's run
here gets the same numbers: the JAX fake's weights carried over, and the
JAX run's random samples injected in its order (``JaxTrainDraws``,
``JaxRefineDraws``). Its renders are held to the golden test's own bound,
PSNR >= 40 dB: stage 1's against ``golden_e2e/stage1_render.npy``.
Stage 2 refines the JAX run's own export (``tests/fixtures/port_golden``,
from ``scripts/port_make_golden_fixtures.py``) and is held against the JAX
run's stage-2 render there: the trained clouds agree to float32 rounding,
and the export's isotropic remesh turns that into other meshes; and
``golden_e2e/stage2_render.npy`` is 26.87 dB from the JAX package's own
stage 2 (``port_golden/jax_run.json``)."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.cli.process import load_rgba as j_load_rgba
from dreamgaussian_tpu.guidance import fake as jfake
from dreamgaussian_tpu.guidance.unet import TinyUNet as JTinyUNet
from dreamgaussian_tpu_torch import weights
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import main2 as tcli2
from dreamgaussian_tpu_torch.cli.process import load_rgba as t_load_rgba
from dreamgaussian_tpu_torch.guidance import fake as tfake
from dreamgaussian_tpu_torch.guidance import sds as tsds
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet as TTinyUNet
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians
from dreamgaussian_tpu_torch.scene import load_ply
from dreamgaussian_tpu_torch.train import Stage2Trainer
from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera
from dreamgaussian_tpu_torch.utils.config import load_with_cli
from dreamgaussian_tpu_torch.utils.png import write_png
from test_golden_e2e import GOLDEN_DIR, psnr
from test_torch_stage1 import JaxTrainDraws
from test_torch_stage2 import JaxRefineDraws
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


def test_load_rgba_refuses_what_needs_matting(tmp_path, monkeypatch):
    """An RGB input is matted by GrabCut without weights; one too small for
    its rect (inset by 4 on each side) is refused, as cv2.grabCut asserts."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = str(tmp_path / "rgb.png")
    write_png(path, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="no background or no foreground"):
        t_load_rgba(path, device="cpu")


OVERRIDES = [   # tests/test_golden_e2e.py's run, on the CPU
    "save_path=golden", "iters=16", "ref_size=32", "num_pts=256", "capacity=512",
    "novel_resolutions=[32,32,32]", "density_start_iter=4", "density_end_iter=12",
    "densification_interval=4", "opacity_reset_interval=10000", "fake_guidance=True",
    "texture_size=64", "bake_resolution=32", "mc_resolution=32", "decimate_target=2000",
    "iters_refine=3", "novel_resolution=64", "refine_steps=3", "density_thresh=0.2",
    "device=cpu",
]


JAX_GOLDEN = Path(__file__).resolve().parent / "fixtures" / "port_golden"
JAX_EXPORT = JAX_GOLDEN / "golden_mesh.obj"


def jax_fake_zero123(opt):
    """The port's Zero123 guidance on the JAX CLI's fake one's weights: the
    TinyUNet of ``make_fake_backbone`` (seed 0, 8 input channels, an 8x8
    latent), then clip_emb, vae_latent and cam_proj as the JAX fake drew
    them, and the same pooling VAE."""
    kw = dict(stable=opt.get("stable_zero123", False),
              default_elevation=opt.get("elevation", 0))
    jg = jfake.fake_zero123_guidance(**kw)
    unet = JTinyUNet(channels=16, context_dim=32, out_channels=4)
    params = unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,)),
                       jnp.zeros((1, 2, 32)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tsds.Zero123Guidance(
        weights.load_tiny_unet(TTinyUNet(in_channels=8), params),
        tfake.PoolVAE(latent_size=8, image_size=jg.image_size), t(jg.clip_emb),
        t(jg.vae_latent), (t(jg.cam_proj[0]), t(jg.cam_proj[1])), image_size=jg.image_size,
        **kw)


def run_port_clis(outdir, mesh=JAX_EXPORT, stage1=True):
    """The port's ``cli.main`` (unless ``stage1`` is false) and ``cli.main2``
    in ``outdir``, as ``main`` reads the golden run's arguments, with the
    JAX fake guidance's weights and the JAX run's draws injected; stage 2
    refines ``mesh`` (None: the port's own export). Returns stage 2's
    options."""
    outdir = Path(outdir)
    args = [f"input={disc_png(outdir / 'disc.png')}", f"outdir={outdir}", *OVERRIDES]
    opt = load_with_cli(str(IMAGE_YAML), args)
    g = jax_fake_zero123(opt)
    lam, seed = opt.get("lambda_zero123", 0), opt.get("seed", 0)
    if stage1:
        draw1 = JaxTrainDraws(seed, opt.num_pts, opt)
        tcli1.run(opt, guidance_fns=((lam, g.guidance_fn()),), draw=draw1)
        assert not draw1.step_keys and not draw1.densify_keys      # every JAX draw taken
    opt2 = load_with_cli(str(IMAGE_YAML), args + ([f"mesh={mesh}"] if mesh else []))
    draw2 = JaxRefineDraws(seed)
    tcli2.run(opt2, refiners=(((lam, g.refine_fn(steps=opt.refine_steps)),), g.image_size),
              draw=draw2)
    assert draw2.names == ["refine_noise"] * opt.iters_refine
    return opt2


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Both CLIs once; stage 2 on the JAX golden run's export."""
    tmp = tmp_path_factory.mktemp("cli")
    return tmp, run_port_clis(tmp)


def _golden_camera():
    """tests/test_golden_e2e.py's view: 64^2, elevation 10, azimuth 35,
    radius 2, fov 49.1."""
    fov = math.radians(49.1)
    return Camera.from_pose(orbit_camera(10.0, 35.0, 2.0), 64, 64, fov, fov)


def _hold_to(path, img):
    assert np.isfinite(img).all()
    p = psnr(np.asarray(img, np.float16), np.load(path))
    assert p >= 40.0, f"PSNR {p:.2f} dB against the JAX render {path}"


def test_stage1_render_holds_to_the_jax_golden(cli_run):
    tmp, _ = cli_run
    params, aux, sh_degree = load_ply(str(tmp / "golden_model.ply"), capacity=1024, device="cpu")
    cam = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in _golden_camera().arrays().items()}
    with torch.no_grad():
        out = render_gaussians(
            params["xyz"], torch.exp(params["scaling"]), params["rotation"],
            torch.sigmoid(params["opacity"][:, 0]),
            torch.cat([params["f_dc"], params["f_rest"]], 1), cam["view"], cam["full_proj"],
            cam["campos"], cam["tanfov"], 64, 64, torch.ones(3), sh_degree=sh_degree,
            alive=aux.alive, device="cpu")
    _hold_to(f"{GOLDEN_DIR}/stage1_render.npy", out.image.numpy())


def test_stage2_render_holds_to_the_jax_run(cli_run):
    tmp, opt = cli_run
    mesh = Mesh.load(str(tmp / "golden.obj"), resize=False)
    with torch.no_grad():
        out = Stage2Trainer(opt, mesh, seed=0, device="cpu").render_view(_golden_camera())
    _hold_to(JAX_GOLDEN / "stage2_render.npy", out["image"].numpy())


def test_both_clis_end_to_end_on_the_cpu(cli_run):
    tmp_path, _ = cli_run
    params, aux, _ = load_ply(str(tmp_path / "golden_model.ply"), capacity=1024, device="cpu")
    n = int(aux.alive.sum())
    assert n > 0 and all(bool(torch.isfinite(v[:n]).all()) for v in params.values())
    for name in ("golden_mesh.obj", "golden.obj"):
        mesh = Mesh.load(str(tmp_path / name), resize=False)
        assert len(mesh.f) > 0 and np.isfinite(mesh.v).all(), name
        assert mesh.f.max() < len(mesh.v) and mesh.ft.max() < len(mesh.vt), name
        assert mesh.albedo.shape == (64, 64, 3), name
    stage1 = Mesh.load(str(JAX_EXPORT), resize=False)          # the mesh stage 2 refined
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


def test_stage1_device_mesh_raises(tmp_path, monkeypatch):
    """A mesh whose size is not the run's number of ranks (one process,
    not started by torchrun) is refused, naming both numbers."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    opt = load_with_cli("configs/image.yaml", [f"outdir={tmp_path}", *OVERRIDES, "mesh=data4"])
    with pytest.raises(ValueError, match="needs 4 ranks, this run has 1"):
        tcli1.run(opt)


def test_clis_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    opt = load_with_cli("configs/image.yaml", [f"outdir={tmp_path}", *OVERRIDES[:-1]])
    for cli in (tcli1, tcli2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.run(opt)
