"""The port's app jobs against the JAX package's where it has one: the
viewer's live training on the CPU, a web-app stage-1 job at the golden
run's sizes, Zero123 novel views with the fake prior (the same
conditioning as the JAX CLI's), and the batch script on one input."""

import json
import os
import time
from urllib.error import HTTPError

import numpy as np
import pytest

from dreamgaussian_tpu.cli import novel_view as jnv
from dreamgaussian_tpu.guidance.sds import Zero123Guidance as JZero123
from dreamgaussian_tpu_torch.cli import novel_view as tnv
from dreamgaussian_tpu_torch.cli import serve as tserve
from dreamgaussian_tpu_torch.cli import webapp as twebapp
from dreamgaussian_tpu_torch.guidance.sds import Zero123Guidance as TZero123
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.train import Stage1Trainer
from dreamgaussian_tpu_torch.utils.config import Config
from dreamgaussian_tpu_torch.utils.gif import read_gif
from dreamgaussian_tpu_torch.utils.png import decode_png, read_png
from test_torch_cli import OVERRIDES
from torch_apps_cases import get, http, port_runall  # noqa: F401
from torch_cli_cases import disc_png
from torch_cpu_cases import one_torch_thread  # noqa: F401


def test_live_viewer_trains_on_the_cpu(http):
    opt = Config(dict(iters=40, ref_size=32, num_pts=64, sh_degree=0, batch_size=1,
                      novel_resolutions=[32, 32, 32], density_start_iter=1000,
                      density_end_iter=2000, warmup_rgb_loss=False, elevation=0, radius=2.0,
                      fovy=49.1))
    rng = np.random.default_rng(0)
    trainer = Stage1Trainer(opt, ref_rgb=rng.random((32, 32, 3)).astype(np.float32),
                            ref_mask=np.ones((32, 32), np.float32), capacity=128, seed=0,
                            device="cpu")
    state = tserve.ViewerState(None, size=32, trainer=trainer)
    try:
        url = http(tserve.make_handler(state))
        st = json.loads(get(url + "/status"))
        assert st["live"] is True and st["training"] is False and st["step"] == 0
        get(url + "/train?on=1")
        deadline = time.time() + 60
        while time.time() < deadline and json.loads(get(url + "/status"))["step"] < 3:
            time.sleep(0.1)
        st = json.loads(get(url + "/status"))
        assert st["training"] and st["step"] >= 3 and np.isfinite(st["loss"]), st
        assert decode_png(get(url + "/render?elev=10&azim=30&mode=alpha")).shape == (32, 32, 3)
        get(url + "/train?on=0")
        time.sleep(0.3)
        s1 = json.loads(get(url + "/status"))["step"]
        time.sleep(0.4)
        assert json.loads(get(url + "/status"))["step"] - s1 <= 1
    finally:
        state.close()
    assert not state._thread.is_alive()


def test_webapp_stage1_job(tmp_path, http, monkeypatch):
    """One stage-1 job at the golden run's sizes, through the HTTP routes;
    its orbit GIF cut to 2 frames of 32^2 (12 frames of 256^2 take about 20
    s on one CPU thread)."""
    monkeypatch.setattr(twebapp, "ORBIT_FRAMES", 2)
    monkeypatch.setattr(twebapp, "ORBIT_SIZE", 32)
    data, outdir = tmp_path / "data", tmp_path / "out"
    data.mkdir()
    outdir.mkdir()
    png = disc_png(data / "disc_rgba.png")
    extra = [o for o in OVERRIDES if not o.startswith(("save_path=", "device="))]
    state = twebapp.AppState(str(data), str(outdir), extra, device="cpu")
    url = http(twebapp.make_handler(state))
    assert b"disc_rgba.png" in get(url + "/")
    assert json.loads(get(f"{url}/run?stage=1&input={png}")) == {"error": None}
    assert json.loads(get(f"{url}/run?stage=1&input={png}"))["error"] == "a job is already running"
    state.thread.join(timeout=120)
    st = json.loads(get(url + "/status"))
    assert not st["running"] and st["log"].endswith("[webapp] done"), st["log"]
    frames, _ = read_gif(st["artifact"])
    assert frames.shape == (2, 32, 32, 3)
    assert st["mesh"].endswith("disc_mesh.obj") and os.path.exists(st["mesh"])
    assert get(f"{url}/artifact?path={st['artifact']}")[:6] == b"GIF89a"
    with pytest.raises(HTTPError, match="403"):
        get(f"{url}/artifact?path={png}")


def test_novel_view_fake_uses_jax_cond(tmp_path, monkeypatch):
    png = disc_png(tmp_path / "in_rgba.png")
    seen = {}

    def spy(cls, key, to_np):
        orig = cls.refine_fn

        def refine_fn(self, *a, **k):
            fn = orig(self, *a, **k)

            def run(images, cond, strength, *rest):
                seen[key] = ({n: to_np(v) for n, v in cond.items()}, float(strength),
                             tuple(images.shape))
                return fn(images, cond, strength, *rest)
            return run
        monkeypatch.setattr(cls, "refine_fn", refine_fn)

    spy(JZero123, "jax", np.asarray)
    spy(TZero123, "torch", lambda v: v.numpy())
    argv = [png, "--fake", "--vers", "10", "--hors", "30", "-90", "--steps", "3"]
    jnv.main(argv + ["--out", str(tmp_path / "j")])
    paths = tnv.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    (jc, js, jshape), (tc, ts, tshape) = seen["jax"], seen["torch"]
    assert js == ts == 0.0 and jshape == tshape == (2, 256, 256, 3)
    for name in ("vers", "hors", "radii"):
        np.testing.assert_array_equal(tc[name], jc[name], err_msg=name)
    names = sorted(os.path.basename(p) for p in paths)
    assert names == ["t_nv_v10_h-90.png", "t_nv_v10_h30.png"]
    assert sorted(f[1:] for f in os.listdir(tmp_path) if f.startswith("j_nv")) == \
        sorted(n[1:] for n in names)
    assert all(read_png(p).shape == (256, 256, 3) for p in paths)


def test_port_runall_on_one_input(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    disc_png(data / "a_rgba.png")
    extra = [o for o in OVERRIDES if not o.startswith(("save_path=", "device="))]
    written = port_runall().main(["--dir", str(data), "--out", str(tmp_path / "logs"),
                                   "--device", "cpu", "--extra", *extra])
    assert written == [str(tmp_path / "logs" / "a.obj")]
    for name in ("a_model.ply", "a_mesh.obj", "a.obj"):
        assert (tmp_path / "logs" / name).exists(), name
    assert Mesh.load(written[0], resize=False).albedo.shape == (64, 64, 3)
