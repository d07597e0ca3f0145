"""Host utilities of the PyTorch port against the JAX package: config,
camera and PLY give exactly equal values and bytes."""

import os

import numpy as np
import pytest
import torch

from dreamgaussian_tpu.scene import gaussians as jg
from dreamgaussian_tpu.utils import camera as jcam
from dreamgaussian_tpu.utils import config as jcfg
from dreamgaussian_tpu_torch.scene import gaussians as tg
from dreamgaussian_tpu_torch.utils import camera as tcam
from dreamgaussian_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_YAML = os.path.join(REPO, "configs", "image.yaml")


def test_config_load_and_cli_match():
    args = ["iters=7", "position_lr_init=1e-3", "a.b=true", "name=x"]
    j = jcfg.load_with_cli(IMAGE_YAML, args)
    t = tcfg.load_with_cli(IMAGE_YAML, args)
    assert dict(t) == dict(j)
    assert t.get("save_path", "dflt") == j.get("save_path", "dflt") == "dflt"
    assert t.iters == 7 and t.a.b is True


def test_chip_smoke_options_equal_image_yaml():
    import chip_smoke

    assert chip_smoke.image_options() == dict(jcfg.load(IMAGE_YAML))


@pytest.mark.parametrize("elev,azim,radius", [(0, 0, 2.0), (-30, 135, 2.5), (45, -170, 1.3)])
def test_camera_exactly_equal(elev, azim, radius):
    pj = jcam.orbit_camera(elev, azim, radius)
    pt = tcam.orbit_camera(elev, azim, radius)
    np.testing.assert_array_equal(pt, pj)
    cj = jcam.Camera.from_pose(pj, 128, 96, 0.8, 0.7)
    ct = tcam.Camera.from_pose(pt, 128, 96, 0.8, 0.7)
    for k, v in cj.arrays().items():
        np.testing.assert_array_equal(ct.arrays()[k], v)
    stacked_j = jcam.stack_cameras([cj, cj])
    stacked_t = tcam.stack_cameras([ct, ct])
    for k in stacked_j:
        np.testing.assert_array_equal(stacked_t[k], stacked_j[k])


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_save_ply_bytes_identical_and_load(tmp_path, sh_degree):
    rng = np.random.default_rng(3)
    cap, n_rest = 64, (sh_degree + 1) ** 2 - 1
    params = {
        "xyz": rng.normal(size=(cap, 3)), "f_dc": rng.normal(size=(cap, 1, 3)),
        "f_rest": rng.normal(size=(cap, n_rest, 3)), "opacity": rng.normal(size=(cap, 1)),
        "scaling": rng.normal(size=(cap, 3)), "rotation": rng.normal(size=(cap, 4)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = rng.uniform(size=cap) < 0.7
    zeros = np.zeros(cap, np.float32)
    jaux = jg.GaussianAux(alive=alive, max_radii2d=zeros, grad_accum=zeros, denom=zeros)
    taux = tg.GaussianAux(alive=torch.from_numpy(alive), max_radii2d=torch.zeros(cap),
                          grad_accum=torch.zeros(cap), denom=torch.zeros(cap))
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    nj = jg.save_ply(pj, params, jaux)
    nt = tg.save_ply(pt, {k: torch.from_numpy(v) for k, v in params.items()}, taux)
    assert nj == nt == int(alive.sum())
    assert open(pj, "rb").read() == open(pt, "rb").read()
    lp, la, deg = tg.load_ply(pt, capacity=80, device="cpu")
    jp, ja, jdeg = jg.load_ply(pj, capacity=80)
    assert deg == jdeg == sh_degree
    for k in params:
        np.testing.assert_array_equal(lp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_array_equal(la.alive.numpy(), np.asarray(ja.alive))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port, and chip_smoke.py, imports in a process
    where JAX, flax, the JAX package, cv2, PIL, yaml, transformers and
    safetensors cannot be imported."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "dreamgaussian_tpu", "cv2", "PIL", "yaml", "transformers",
           "safetensors"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this test: " + name)
sys.meta_path.insert(0, Block())
import dreamgaussian_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


# -- the kernels' build: flags per source, all of them in the library's name --


def test_cuda_build_flags_per_source():
    """K3 is built without multiply-add contraction (its gate is equality with
    its plain version); K1 and K2 are not; a caller's flags come last."""
    from dreamgaussian_tpu_torch.ops import cuda_build

    assert "--fmad=false" in cuda_build.flags_for("ztest")
    for name in ("composite_fwd", "composite_bwd"):
        assert "--fmad=false" not in cuda_build.flags_for(name)
        assert (cuda_build.CSRC_DIR / f"{name}.cu").exists()
    flags = cuda_build.flags_for("composite_bwd", ("-DCOMPOSITE_SIFT=0",))
    assert flags[-1] == "-DCOMPOSITE_SIFT=0" and flags[:len(cuda_build.NVCC_FLAGS)] == cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags


def test_cuda_build_library_name_follows_source_headers_and_flags(tmp_path, monkeypatch):
    """The library's name carries the hash of the source, of the headers
    beside it and of the flags: a change of any of them is a rebuild."""
    from dreamgaussian_tpu_torch.ops import cuda_build

    real = (cuda_build.library_path("composite_fwd"), cuda_build.library_path("composite_bwd"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// one\n")
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("k-")
    assert cuda_build.library_path("k", ("-DX=1",)) != first
    (tmp_path / "k.cuh").write_text("// two\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n// edited\n')
    assert cuda_build.library_path("k") not in (first, second)
    # The port's own sources: the shared header is part of both compositors' names.
    assert real[0] != real[1]


# -- weights.py: the port's device policy --


def _carry_over(name, device=None):
    from dreamgaussian_tpu_torch import weights

    params = {"xyz": np.zeros((4, 3), np.float32)}
    aux = {k: np.zeros(4, np.float32) for k in ("alive", "max_radii2d", "grad_accum", "denom")}
    kw = {} if device is None else {"device": device}
    if name == "gaussians_from_numpy":
        return weights.gaussians_from_numpy(params, aux, **kw)[0]["xyz"]
    if name == "cloud_from_numpy":
        return weights.cloud_from_numpy(params, np.ones(4, bool), **kw)[0]["xyz"]
    return weights.flax_state_dict({"params": {"conv": {"bias": np.zeros(3, np.float32)}}},
                                   **kw)["conv.bias"]


@pytest.mark.parametrize("name", ["gaussians_from_numpy", "cloud_from_numpy", "flax_state_dict"])
def test_weights_carry_over_to_the_card_by_default(name, monkeypatch):
    """Without a device the JAX package's arrays go to the card, through
    resolve_device, which raises where no card is present; the CPU is taken
    only when the caller asks for it."""
    from dreamgaussian_tpu_torch import resolve_device, weights

    asked = []

    def spy(device="cuda"):
        asked.append(str(device))
        return resolve_device(device)

    monkeypatch.setattr(weights, "resolve_device", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _carry_over(name)
    assert asked == ["cuda"]
    assert _carry_over(name, "cpu").device.type == "cpu"
    assert asked == ["cuda", "cpu"]
