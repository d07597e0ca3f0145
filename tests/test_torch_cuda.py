"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it runs
on a machine without them:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import K2_ATOL, K2_RTOL, grad_rows_agree
from dreamgaussian_tpu_torch.ops import rasterize_cuda as tcu
from dreamgaussian_tpu_torch.ops.binning import bin_gaussians
from dreamgaussian_tpu_torch.ops.project import project_gaussians
from dreamgaussian_tpu_torch.ops.rasterize import build_feature_cols, render_gaussians
from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

CHUNK = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compositing kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(n, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(n, 3)) * 0.4,
        np.exp(rng.uniform(-4.0, -2.5, size=(n, 3))),
        rng.normal(size=(n, 4)),
        rng.uniform(0.05, 0.95, size=n),
        rng.normal(size=(n, 1, 3)) * 0.5,
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _camera(size, device):
    cam = Camera.from_pose(orbit_camera(10.0, 25.0, 2.5), size, size,
                           math.radians(49.1), math.radians(49.1)).arrays()
    return [torch.from_numpy(cam[k]).to(device) for k in ("view", "full_proj", "campos", "tanfov")]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
def test_kernels_match_plain_versions(cuda_device, tile):
    size = 128
    xyz, scale, quat, op, shs = _scene(3000, 6, cuda_device)
    p = project_gaussians(xyz, scale, quat, op, shs, *_camera(size, cuda_device), size, size)
    bins = bin_gaussians(p.mean2d, p.depth, p.radius, size, size, chunk=CHUNK, tile=tile,
                         conic=p.conic, log_opacity=torch.log(p.opacity))
    dup = build_feature_cols(p.mean2d, p.depth, p.conic, p.color, p.opacity)
    dup = dup.index_select(1, bins.dup_map).contiguous()
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    out = tcu.composite_forward(dup, bins.chunk_starts, bins.n_chunks, **geo)
    ref = tcu.composite_forward_ref(dup, bins.chunk_starts, bins.n_chunks, **geo)
    # Another association of the transmittance product: a pixel's stop can
    # move by one pair only at the 1e-4 threshold.
    assert float((out[:, 5] != ref[:, 5]).float().mean()) <= 1e-3
    assert float((out[:, :5] - ref[:, :5]).abs().max()) <= 1e-3
    g = torch.randn(out.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    d_k = tcu.composite_backward(dup, bins.chunk_starts, bins.n_chunks, ref, g, **geo)
    d_r = tcu.composite_backward_ref(dup, bins.chunk_starts, bins.n_chunks, ref, g, **geo)
    # chip_smoke.py's K2 gate: elementwise in each gradient row, the
    # absolute part scaled to that row's own largest |grad|.
    assert grad_rows_agree(d_k, d_r, K2_RTOL, K2_ATOL)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    size = 96
    cpu = _scene(1500, 7, "cpu")
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        args = [a.detach().to(dev).requires_grad_(True) for a in cpu]
        tap = torch.zeros((1500, 2), device=dev, requires_grad=True)
        before = dict(tcu.LAUNCHES)
        out = render_gaussians(*args, *_camera(size, dev), size, size,
                               torch.ones(3, device=dev), mean2d_tap=tap, tile=32,
                               device=dev)
        (out.image.sum() + out.alpha.sum()).backward()
        launched = {k: tcu.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"composite_fwd": 0, "composite_bwd": 0} if dev == "cpu"
                            else {"composite_fwd": 1, "composite_bwd": 1})
        outs.append(out.image.detach().cpu())
        grads.append([t.grad.cpu() for t in (*args, tap)])
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-3
    # Per-gaussian gradients chain the per-duplicate ones through the
    # projection: elementwise, as the CPU render test holds the port to JAX.
    for g_cpu, g_card in zip(*grads):
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-3, atol=1e-4 * float(g_cpu.abs().max()))


@pytest.mark.cuda
def test_empty_scene_on_card(cuda_device):
    """No duplicates at all: every tile is empty in both kernels."""
    args = [a.detach().requires_grad_(True) for a in _scene(200, 9, cuda_device)]
    cam = _camera(64, cuda_device)
    behind = -2.0 * cam[2]            # campos is minus the camera position
    out = render_gaussians(args[0] + behind, *args[1:], *cam, 64, 64,
                           torch.ones(3, device=cuda_device), tile=32, device=cuda_device)
    assert int((out.radii > 0).sum()) == 0
    assert bool((out.image == 1.0).all()) and not bool(out.alpha.any())
    out.image.sum().backward()
    for t in args:
        assert t.grad is None or (bool(torch.isfinite(t.grad).all()) and not bool(t.grad.any()))
