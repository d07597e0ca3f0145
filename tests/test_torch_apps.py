"""The port's apps against the JAX package's on the same inputs (a seeded
gaussian PLY, a textured UV sphere, a disc RGBA PNG): the orbit renders,
the metrics, the viewer's three modes and its HTTP routes, and the device
policy of every new entry point (the jobs: ``test_torch_apps_jobs.py``).

Tolerances: gaussian frames within rtol 1e-5 and atol 2e-5 (as
``test_torch_rasterize.py``), mesh frames within 1e-5 absolute (as
``test_torch_mesh_render.py``, viewed from elevation 3 for the edge pixels
of ``ROADMAP.md`` section 3); PSNR within 1e-3 dB, MAE and CLIP similarity
within 1e-5, LPIPS within 1e-4 relative; the viewer's uint8 images within
one level. The JAX mesh renderer is jitted here (the JAX CLIs call it
eagerly, which takes seconds per frame on the CPU)."""

import json
import math
import os
from urllib.error import HTTPError

import jax
import numpy as np
import pytest
import torch

from dreamgaussian_tpu.cli import eval as jeval
from dreamgaussian_tpu.cli import render as jrender
from dreamgaussian_tpu.cli import serve as jserve
from dreamgaussian_tpu.cli.process import load_rgba as j_load_rgba
from dreamgaussian_tpu.render import mesh_renderer as jmesh_renderer
from dreamgaussian_tpu.utils.lpips import LPIPS as JLPIPS
from dreamgaussian_tpu_torch.cli import eval as teval
from dreamgaussian_tpu_torch.cli import novel_view as tnv
from dreamgaussian_tpu_torch.cli import render as trender
from dreamgaussian_tpu_torch.cli import serve as tserve
from dreamgaussian_tpu_torch.cli import webapp as twebapp
from dreamgaussian_tpu_torch.guidance import synthetic
from dreamgaussian_tpu_torch.guidance.clip import CLIPVisionConfig
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.utils.gif import read_gif
from dreamgaussian_tpu_torch.utils.mp4 import read_mp4
from dreamgaussian_tpu_torch.utils.png import decode_png, read_png
from torch_apps_cases import get, http, port_runall, write_cloud_ply, write_sphere_obj  # noqa: F401
from torch_cli_cases import disc_png
from torch_cpu_cases import one_torch_thread  # noqa: F401

FOV = math.radians(49.1)
TINY_CLIP = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, image_size=32, patch_size=8, projection_dim=16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    out = {"ply": write_cloud_ply(d / "cloud.ply"), "obj": write_sphere_obj(d / "sphere.obj"),
           "png": disc_png(d / "disc_rgba.png", size=64), "clip": str(d / "clip"),
           "vgg": str(d / "vgg16.pth")}
    synthetic.write_clip_vision(out["clip"], TINY_CLIP, dtype=torch.float32, seed=0, device="cpu")
    synthetic.write_vgg16_features(out["vgg"], seed=0, device="cpu")
    return out


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_mesh_render():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh_renderer, "render_mesh",
                   jax.jit(jmesh_renderer.render_mesh, static_argnums=(3, 4)))
        yield


def test_gaussian_frames_match_jax(files):
    ref = jrender.render_gaussian_frames(files["ply"], 3, 32, 10.0, 2.0, FOV)
    got = trender.render_gaussian_frames(files["ply"], 3, 32, 10.0, 2.0, FOV, device="cpu")
    assert len(got) == 3 and got[0].shape == (32, 32, 3)
    for k, (t, j) in enumerate(zip(got, ref)):
        assert np.asarray(j).std() > 0.05, k
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=2e-5, err_msg=f"frame {k}")


def test_mesh_frames_match_jax(files):
    ref = jrender.render_mesh_frames(files["obj"], 2, 64, 3.0, 2.0, FOV)
    got = trender.render_mesh_frames(files["obj"], 2, 64, 3.0, 2.0, FOV, device="cpu")
    for k, (t, j) in enumerate(zip(got, ref)):
        assert np.asarray(j).std() > 0.05, k
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, err_msg=f"frame {k}")


def test_mesh_without_uvs_renders_grey(tmp_path, files):
    """A mesh without UVs or texture is unwrapped and shaded 0.7 grey."""
    m = Mesh.load(files["obj"], resize=False)
    bare = Mesh(v=m.v, f=m.f)
    path = str(tmp_path / "bare.obj")
    bare.write(path)
    img = trender.render_mesh_frames(path, 1, 32, 3.0, 2.0, FOV, device="cpu")[0]
    inside = img[12:20, 12:20]
    np.testing.assert_allclose(inside, 0.7, atol=1e-5)


def test_save_frames_outputs(tmp_path, capsys):
    frames = [np.full((8, 12, 3), v, np.float32) for v in (0.1, 0.5, 0.9)]
    trender.save_frames(frames, str(tmp_path / "g.png"))
    assert read_png(str(tmp_path / "g.png")).shape == (16, 24, 3)
    out = trender.save_frames(frames, str(tmp_path / "v.mp4"))
    assert out == str(tmp_path / "v.mp4") and not (tmp_path / "v.gif").exists()
    assert "[WARN] no mp4 backend" not in capsys.readouterr().out
    info = read_mp4(out)
    assert len(info["sample_sizes"]) == 3 and (info["width"], info["height"]) == (16, 16)
    with pytest.raises(ValueError, match="unsupported"):
        trender.save_frames(frames, str(tmp_path / "x.bmp"))


def test_render_main_writes_the_gif(tmp_path, files):
    out = trender.main([files["ply"], "--num_frames", "3", "--size", "32",
                        "--out", str(tmp_path / "o.gif"), "--device", "cpu"])
    frames, _ = read_gif(out)
    assert frames.shape == (3, 32, 32, 3)


def test_eval_matches_jax(files):
    got = teval.main([files["png"], files["ply"], "--clip_ckpt", files["clip"], "--vgg_ckpt",
                      files["vgg"], "--size", "32", "--device", "cpu"])
    rgba = j_load_rgba(files["png"], size=32)
    ref = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    views = [np.asarray(v) for v in jrender.render_gaussian_frames(files["ply"], 8, 32, 0.0,
                                                                     2.0, FOV)]
    np.testing.assert_allclose(got["front_psnr"], jeval.psnr(ref, views[4]), atol=1e-3)
    np.testing.assert_allclose(got["front_mae"], float(np.mean(np.abs(ref - views[4]))),
                               atol=1e-5)
    np.testing.assert_allclose(got["clip_sim"], jeval.clip_similarity(files["clip"], ref, views),
                               atol=1e-5)
    lpips = float(JLPIPS(files["vgg"])(ref[None], views[4][None])[0])
    np.testing.assert_allclose(got["front_lpips"], lpips, rtol=1e-4)
    assert got["front_lpips"] > 0


@pytest.mark.parametrize("kind", ["ply", "obj"])
def test_viewer_modes_match_jax(files, kind):
    size = 32 if kind == "ply" else 64
    j = jserve.ViewerState(files[kind], size=size)
    t = tserve.ViewerState(files[kind], size=size, device="cpu")
    target = np.array([0.05, -0.02, 0.0], np.float32)
    for mode in ("image", "depth", "alpha"):
        ref = j.render(3.0, 30.0, 2.2, mode, target=target)
        got = t.render(3.0, 30.0, 2.2, mode, target=target)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref).max() <= 1, mode
        assert ref.std() > 5, mode


def test_viewer_http_routes(files, http):
    state = tserve.ViewerState(files["ply"], size=32, device="cpu")
    url = http(tserve.make_handler(state))
    assert b"viewer" in get(url + "/") and b"mode" in get(url + "/")
    for mode in ("image", "depth", "alpha"):
        png = decode_png(get(f"{url}/render?elev=10&azim=20&radius=2.5&mode={mode}&tx=0.1"))
        np.testing.assert_array_equal(png, state.render(10.0, 20.0, 2.5, mode,
                                                        target=np.array([0.1, 0, 0], np.float32)))
    st = json.loads(get(url + "/status"))
    assert st == {"live": False, "training": False, "step": 0, "loss": None}
    assert get(url + "/train?on=1") == b"ok" and json.loads(get(url + "/status"))["training"]
    with pytest.raises(HTTPError):
        get(url + "/nothing")


def test_apps_need_a_card_unless_cpu(tmp_path, files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = [
        lambda: trender.main([files["ply"], "--out", str(tmp_path / "o.gif")]),
        lambda: teval.main([files["png"], files["ply"]]),
        lambda: tnv.main([files["png"], "--fake"]),
        lambda: tserve.ViewerState(files["ply"]),
        lambda: tserve.make_live_state("configs/image.yaml", [f"input={files['png']}"], 32),
        lambda: twebapp.AppState(str(tmp_path), str(tmp_path), []),
        lambda: port_runall().main(["--dir", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
