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

    assert chip_smoke.IMAGE_OPTIONS == dict(jcfg.load(IMAGE_YAML))


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
    where JAX, flax, the JAX package, cv2, PIL and yaml cannot be imported."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "dreamgaussian_tpu", "cv2", "PIL", "yaml"}
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
