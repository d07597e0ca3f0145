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
from dreamgaussian_tpu_torch.ops import mesh_raster as tmr
from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as tzc
from dreamgaussian_tpu_torch.ops import rasterize_cuda as tcu
from dreamgaussian_tpu_torch.ops.binning import bin_rects
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


def _bumpy_sphere(n_lat, n_lon, seed):
    """A closed, bumpy UV sphere: (v [V,3] f32, f [F,3] i64)."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)), np.outer(np.cos(lat), np.ones_like(lon)),
                     np.outer(np.sin(lat), np.sin(lon))], -1).reshape(-1, 3)
    v = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * 0.6
    v = v * (1.0 + 0.15 * rng.uniform(-1, 1, size=(len(v), 1)))
    idx = lambda i, j: 1 + i * n_lon + j % n_lon  # noqa: E731
    f = []
    for j in range(n_lon):
        f.append([0, idx(0, j + 1), idx(0, j)])
        f.append([len(v) - 1, idx(n_lat - 2, j), idx(n_lat - 2, j + 1)])
        for i in range(n_lat - 2):
            f.append([idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)])
            f.append([idx(i, j), idx(i + 1, j + 1), idx(i + 1, j)])
    return v.astype(np.float32), np.asarray(f, np.int64)


def _clip_vertices(v, size, device):
    cam = Camera.from_pose(orbit_camera(20.0, 35.0, 2.0), size, size, 0.86, 0.86).arrays()
    v_h = np.concatenate([v, np.ones((len(v), 1), np.float32)], 1)
    return torch.from_numpy((v_h @ cam["full_proj"].T).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
def test_ztest_kernel_matches_plain_version(cuda_device, tile):
    """K3 on a mesh of small triangles: ids equal on every pixel, z to 1e-6
    (the kernel keeps the plain version's operation order, without fused
    multiply-add)."""
    size = 128
    v, f = _bumpy_sphere(40, 60, seed=3)
    faces = torch.from_numpy(f).to(cuda_device)
    feat, xmin, ymin, xmax, ymax, ok = tmr.triangle_features(
        _clip_vertices(v, size, cuda_device), faces, size, size, tile)
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    bins = bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=geo["grid_x"],
                     num_tiles=geo["num_tiles"], chunk=CHUNK)
    dup = feat.index_select(1, bins.dup_map).contiguous()
    before = tzc.LAUNCHES["ztest"]
    ids, z = tzc.ztest(dup, bins.chunk_starts, bins.n_chunks, **geo)
    assert tzc.LAUNCHES["ztest"] == before + 1
    r_ids, r_z = tzc.ztest_ref(dup, bins.chunk_starts, bins.n_chunks, **geo)
    assert int(bins.n_chunks.max()) >= 2 and float((r_ids > 0).float().mean()) > 0.2
    assert torch.equal(ids, r_ids)
    assert float((z - r_z).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shared_edge", "tie_one_chunk", "tie_two_chunks"])
def test_ztest_kernel_ties(cuda_device, case):
    """The tie rules on the card: a pixel centre on a shared edge is inside
    both triangles and goes to the larger id of the chunk; across chunks
    only a strictly smaller z replaces the winner."""
    tri, far = [[3, 3], [12, 4], [6, 13]], [[100, 100], [101, 100], [100, 101]]
    if case == "shared_edge":
        tris = [[[2, 2], [10, 2], [10, 10]], [[2, 2], [10, 10], [2, 10]]]
        zs = [[0.1, 0.3, 0.5], [0.1, 0.5, 0.2]]
    else:
        tris = [tri] + [far] * (7 if case == "tie_two_chunks" else 0) + [tri]
        zs = [[0.25, 0.25, 0.25]] * len(tris)
    chunk, n = 8, len(tris)
    k = -(-n // chunk) * chunk
    feat = np.zeros((16, k), np.float32)
    feat[0:6, :n] = np.asarray(tris, np.float32).reshape(n, 6).T
    feat[6:9, :n] = np.asarray(zs, np.float32).T
    feat[9, :n] = np.arange(1, n + 1)
    args = (torch.from_numpy(feat).to(cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device),
            torch.full((1,), k // chunk, dtype=torch.int32, device=cuda_device))
    geo = dict(grid_x=1, num_tiles=1, chunk=chunk, tile=16)
    ids, z = tzc.ztest(*args, **geo)
    r_ids, r_z = tzc.ztest_ref(*args, **geo)
    assert torch.equal(ids, r_ids) and torch.equal(z, r_z)
    hit = ids[ids > 0]
    if case == "shared_edge":
        img = ids.reshape(16, 16)
        assert all(int(img[d, d]) == 2 for d in range(2, 11))
    else:
        assert hit.numel() > 20 and bool((hit == (1 if case == "tie_two_chunks" else 2)).all())


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda_device):
    """rasterize + interpolate on the card (K3) against the CPU (plain
    version): the same winners, barycentrics to 1e-5."""
    size = 128
    v, f = _bumpy_sphere(24, 36, seed=4)
    attrs = torch.from_numpy(np.random.default_rng(5).normal(size=(len(v), 3)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        before = tzc.LAUNCHES["ztest"]
        rast = tmr.rasterize(_clip_vertices(v, size, dev), torch.from_numpy(f).to(dev), size, size)
        assert tzc.LAUNCHES["ztest"] - before == (0 if dev == "cpu" else 1)
        outs.append((rast, tmr.interpolate(attrs.to(dev), torch.from_numpy(f).to(dev), rast)))
    (r_cpu, a_cpu), (r_card, a_card) = outs
    assert torch.equal(r_card.tri_id.cpu(), r_cpu.tri_id)
    assert float((r_card.bary.cpu() - r_cpu.bary).abs().max()) <= 1e-5
    assert float((r_card.zbuf.cpu() - r_cpu.zbuf).abs().max()) <= 1e-6
    assert float((a_card.cpu() - a_cpu).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_ztest_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    feat = torch.zeros((16, 128), device=cuda_device)
    cs = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    nc = torch.ones(1, dtype=torch.int32, device=cuda_device)
    geo = dict(grid_x=1, num_tiles=1, chunk=128, tile=32)
    tzc.ztest(feat, cs, nc, **geo)
    with pytest.raises(ValueError):
        tzc.ztest(feat.double(), cs, nc, **geo)
    with pytest.raises(ValueError):
        tzc.ztest(feat, cs.long(), nc, **geo)
    with pytest.raises(ValueError):
        tzc.ztest(feat, cs, nc, **{**geo, "tile": 8})
    with pytest.raises(ValueError):
        tzc.ztest(feat, cs, nc, **{**geo, "chunk": 256})
