"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it runs
on a machine without them:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import ctypes
import functools
import json
import math
import os

import numpy as np
import pytest
import torch

from chip_smoke import K2_ATOL, K2_RTOL, grad_rows_agree
from dreamgaussian_tpu_torch.ops import mesh_raster as tmr
from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as tzc
from dreamgaussian_tpu_torch.ops import cuda_build
from dreamgaussian_tpu_torch.ops import rasterize_cuda as tcu
from dreamgaussian_tpu_torch.ops.binning import bin_rects
from dreamgaussian_tpu_torch.ops.binning import bin_gaussians
from dreamgaussian_tpu_torch.ops.project import project_gaussians
from dreamgaussian_tpu_torch.ops.rasterize import build_feature_cols, render_gaussians
from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera
from torch_cli_cases import disc_png, image_options
from torch_composite_cases import CASES, composite_case
from torch_ztest_cases import CARD_CASES as ZTEST_CASES
from torch_ztest_cases import ztest_case

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


def _binned(n, seed, size, tile, device):
    """A seeded cloud projected and binned: (dup_feat, chunk_starts, n_chunks, geo)."""
    xyz, scale, quat, op, shs = _scene(n, seed, device)
    p = project_gaussians(xyz, scale, quat, op, shs, *_camera(size, device), size, size)
    bins = bin_gaussians(p.mean2d, p.depth, p.radius, size, size, chunk=CHUNK, tile=tile,
                         conic=p.conic, log_opacity=torch.log(p.opacity))
    dup = build_feature_cols(p.mean2d, p.depth, p.conic, p.color, p.opacity)
    dup = dup.index_select(1, bins.dup_map).contiguous()
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    return dup, bins.chunk_starts, bins.n_chunks, geo


def _hold_kernels(dup, cs, nc, geo, device):
    """K1 and K2 against their plain versions with chip_smoke.py's gates;
    K2 twice, for equal bits. Returns the plain forward output."""
    before = dict(tcu.LAUNCHES)
    out = tcu.composite_forward(dup, cs, nc, **geo)
    ref = tcu.composite_forward_ref(dup, cs, nc, **geo)
    # Another association of the transmittance product: a pixel's stop can
    # move by one pair only at the 1e-4 threshold.
    assert float((out[:, 5] != ref[:, 5]).float().mean()) <= 1e-3
    assert float((out[:, :5] - ref[:, :5]).abs().max()) <= 1e-3
    assert not bool(out[:, 6:].any())
    g = torch.randn(out.shape, device=device, generator=torch.Generator(device).manual_seed(0))
    d_k = tcu.composite_backward(dup, cs, nc, ref, g, **geo)
    again = tcu.composite_backward(dup, cs, nc, ref, g, **geo)
    d_r = tcu.composite_backward_ref(dup, cs, nc, ref, g, **geo)
    torch.cuda.synchronize()
    assert {k: tcu.LAUNCHES[k] - before[k] for k in before} == {"composite_fwd": 1, "composite_bwd": 2}
    # chip_smoke.py's K2 gate: elementwise in each gradient row, the
    # absolute part scaled to that row's own largest |grad|.
    assert grad_rows_agree(d_k, d_r, K2_RTOL, K2_ATOL)
    # Every sum of K2 has a fixed order: two launches give equal bits.
    assert torch.equal(d_k, again)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
def test_kernels_match_plain_versions(cuda_device, tile):
    _hold_kernels(*_binned(3000, 6, 128, tile, cuda_device), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [128, 1024])
def test_kernels_on_small_and_large_frames(cuda_device, size):
    """16 tiles (fewer blocks than the card has SMs, even at four per tile)
    and 1,024 tiles (4,096 blocks), at the trainer's tile 32."""
    dup, cs, nc, geo = _binned(6000, 11, size, 32, cuda_device)
    assert geo["num_tiles"] == (16 if size == 128 else 1024)
    tcu.LAST_GRID.update(composite_fwd=0, composite_bwd=0)
    _hold_kernels(dup, cs, nc, geo, cuda_device)
    # The grids that the libraries gave their launches: four blocks per tile.
    assert tcu.LAST_GRID == {"composite_fwd": 4 * geo["num_tiles"], "composite_bwd": 4 * geo["num_tiles"]}


@pytest.mark.cuda
def test_tile_16_launches_one_block_per_tile(cuda_device):
    dup, cs, nc, geo = _binned(3000, 6, 128, 16, cuda_device)
    tcu.LAST_GRID.update(composite_fwd=0, composite_bwd=0)
    _hold_kernels(dup, cs, nc, geo, cuda_device)
    assert tcu.LAST_GRID == {"composite_fwd": 64, "composite_bwd": 64}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", CASES)
def test_kernels_on_hand_built_tiles(cuda_device, case, tile):
    """A quadrant that stops in the first chunk while the others walk all
    six (more chunks than the kernels have staging buffers); empty tiles
    beside full ones; a list of six chunks walked to its end."""
    c = composite_case(case, tile)
    dup, cs, nc = (torch.from_numpy(c[k]).to(cuda_device) for k in ("feat", "chunk_starts", "n_chunks"))
    ref = _hold_kernels(dup, cs, nc, c["geo"], cuda_device)
    n_contrib = ref[:, 5]
    if case == "quadrant_stops_early":
        quad, half = n_contrib.reshape(tile, tile), tile // 2
        assert float(quad[:half, :half].max()) <= CHUNK
        assert float(ref[0, 4].reshape(tile, tile)[:half, :half].max()) < 1e-2
        assert float(quad[half:, half:].max()) > 5 * CHUNK
    elif case == "empty_beside_full":
        assert not bool(n_contrib[[0, 2]].any()) and float(n_contrib[1].max()) > 2 * CHUNK
        out = tcu.composite_forward(dup, cs, nc, **c["geo"])
        assert bool((out[[0, 2], 4] == 1.0).all()) and not bool(out[[0, 2], :4].any())
    else:
        assert float(n_contrib.max()) > 5 * CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cloud", *CASES])
def test_sift_changes_no_bit(cuda_device, scene, monkeypatch):
    """A warp walks only the gaussians that its sift lets through. The sift
    may let through too many, never too few: built without it
    (COMPOSITE_SIFT=0) both kernels give the same bits."""
    if scene == "cloud":
        dup, cs, nc, geo = _binned(6000, 12, 256, 32, cuda_device)
    else:
        c = composite_case(scene, 32)
        dup, cs, nc = (torch.from_numpy(c[k]).to(cuda_device) for k in ("feat", "chunk_starts", "n_chunks"))
        geo = c["geo"]
    out = tcu.composite_forward(dup, cs, nc, **geo)
    g = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(1))
    d = tcu.composite_backward(dup, cs, nc, out, g, **geo)
    # From here on the wrappers load the libraries built without the sift.
    monkeypatch.setattr(cuda_build, "load",
                        functools.partial(cuda_build.load, extra=("-DCOMPOSITE_SIFT=0",)))
    assert torch.equal(out, tcu.composite_forward(dup, cs, nc, **geo))
    assert torch.equal(d, tcu.composite_backward(dup, cs, nc, out, g, **geo))
    assert bool(d.any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["composite_fwd", "composite_bwd"])
def test_refused_launch_raises_and_does_not_fall_back(cuda_device, name, monkeypatch):
    """A launch that the library or the card refuses raises from the
    wrapper; the plain version is not taken in its place, no launch is
    counted, and the card goes on working."""
    dup, cs, nc, geo = _binned(500, 3, 64, 32, cuda_device)
    ref = tcu.composite_forward_ref(dup, cs, nc, **geo)
    lib = cuda_build.load(name, tcu._ARGTYPES[name])
    blocks = ctypes.c_int(-1)
    # The library's own refusal: a chunk larger than its staging buffers
    # (the wrapper checks this before it calls; here the call goes straight in).
    stream = torch.cuda.current_stream().cuda_stream
    args = [dup.data_ptr(), dup.shape[1], cs.data_ptr(), nc.data_ptr()]
    args += [ref.data_ptr()] if name == "composite_fwd" else [ref.data_ptr(), ref.data_ptr(), dup.data_ptr()]
    assert getattr(lib, name)(*args, geo["num_tiles"], geo["grid_x"], 4 * CHUNK, 32, stream,
                              ctypes.byref(blocks)) != 0
    assert blocks.value == -1

    # The card's refusal, through the wrapper and the real library: the call
    # is passed on with a tile count whose grid (four blocks per tile, 2^31)
    # is one more than a launch may have, so the launch itself fails before
    # any block runs.
    tiles_at = 5 if name == "composite_fwd" else 7
    codes = []

    class TooManyTiles:
        def __getattr__(self, entry):
            def call(*a):
                codes.append(getattr(lib, entry)(*a[:tiles_at], 2 ** 29, *a[tiles_at + 1:]))
                return codes[-1]
            return call

    def never(*a, **k):
        raise AssertionError("the wrapper fell back to the plain version")

    monkeypatch.setattr(cuda_build, "load", lambda *a, **k: TooManyTiles())
    monkeypatch.setattr(tcu, "composite_forward_ref", never)
    monkeypatch.setattr(tcu, "composite_backward_ref", never)
    before = dict(tcu.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        if name == "composite_fwd":
            tcu.composite_forward(dup, cs, nc, **geo)
        else:
            tcu.composite_backward(dup, cs, nc, ref, torch.ones_like(ref), **geo)
    assert tcu.LAUNCHES == before and len(codes) == 1 and codes[0] != 0
    # The refusal is not left behind for the next CUDA call to find.
    monkeypatch.undo()
    torch.cuda.synchronize()
    out = tcu.composite_forward(dup, cs, nc, **geo)
    assert float((out[:, :5] - ref[:, :5]).abs().max()) <= 1e-3


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


def _ztest_grid(geo):
    """The grid K3's design launches: persistent blocks, six to an SM (what
    its registers and shared memory let an SM hold), or one per segment slot
    (every quadrant of a tile cut into at most ztest_max_segments() runs of
    its list) where those are fewer."""
    lib = cuda_build.load("ztest", tzc._ARGTYPES)
    slots = geo["num_tiles"] * (geo["tile"] // 16) ** 2 * lib.ztest_max_segments()
    return min(slots, 6 * torch.cuda.get_device_properties(0).multi_processor_count)


def _hold_ztest(dup, cs, nc, geo, min_covered=0.2):
    """K3 against its plain version: one counted launch of the designed
    grid, ids and z equal on every pixel. Returns the kernel's output."""
    before = tzc.LAUNCHES["ztest"]
    tzc.LAST_GRID["ztest"] = 0
    ids, z = tzc.ztest(dup, cs, nc, **geo)
    r_ids, r_z = tzc.ztest_ref(dup, cs, nc, **geo)
    torch.cuda.synchronize()
    assert tzc.LAUNCHES["ztest"] == before + 1
    assert tzc.LAST_GRID["ztest"] == _ztest_grid(geo)
    assert float((r_ids > 0).float().mean()) > min_covered
    assert torch.equal(ids, r_ids) and torch.equal(z, r_z)
    return ids, z


def _ztest_case_on(case, tile, device):
    feat, cs, nc, geo = ztest_case(case, tile)
    return (*(torch.from_numpy(a).to(device) for a in (feat, cs, nc)), geo)


def _sphere_ztest_inputs(n_lat, n_lon, size, tile, device):
    """A bumpy sphere's triangles binned at size^2: (dup, chunk_starts, n_chunks, geo)."""
    v, f = _bumpy_sphere(n_lat, n_lon, seed=3)
    feat, xmin, ymin, xmax, ymax, ok = tmr.triangle_features(
        _clip_vertices(v, size, device), torch.from_numpy(f).to(device), size, size, tile)
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=CHUNK, tile=tile)
    bins = bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=geo["grid_x"],
                     num_tiles=geo["num_tiles"], chunk=CHUNK)
    return feat.index_select(1, bins.dup_map).contiguous(), bins.chunk_starts, bins.n_chunks, geo


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", ZTEST_CASES)
def test_ztest_kernel_on_hand_built_lists(cuda_device, case, tile):
    """Ids that do not ascend in slot order (ties within and across
    chunks), and vertices a few ulps to either side of pixel centres with
    slivers that cover pixel centres outside their bounding boxes: the
    kernel's ids and z equal the plain version's on every pixel."""
    dup, cs, nc, geo = _ztest_case_on(case, tile, cuda_device)
    ids, _ = _hold_ztest(dup, cs, nc, geo, min_covered=0.05)
    if case == "ties_unordered":
        assert set(ids.unique().tolist()) == {0, 7, 9}


@pytest.mark.cuda
def test_ztest_kernel_on_a_dense_mesh(cuda_device):
    """240,000 faces at 512^2, tile 32 (1,024 quadrants): the longest
    tile's list has at least 8 chunks."""
    dup, cs, nc, geo = _sphere_ztest_inputs(300, 400, 512, 32, cuda_device)
    assert int(nc.max()) >= 8
    _hold_ztest(dup, cs, nc, geo)
    assert tzc.LAST_GRID["ztest"] == 6 * torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["sphere", *ZTEST_CASES])
def test_ztest_sift_changes_no_bit(cuda_device, scene, monkeypatch):
    """A warp walks only the triangles that its sift lets through. The sift
    may let through too many, never too few: built without it
    (ZTEST_SIFT=0) the kernel gives the same bits."""
    if scene == "sphere":
        dup, cs, nc, geo = _sphere_ztest_inputs(120, 160, 256, 32, cuda_device)
    else:
        dup, cs, nc, geo = _ztest_case_on(scene, 32, cuda_device)
    ids, z = tzc.ztest(dup, cs, nc, **geo)
    # From here on the wrapper loads the library built without the sift.
    monkeypatch.setattr(cuda_build, "load",
                        functools.partial(cuda_build.load, extra=("-DZTEST_SIFT=0",)))
    again_ids, again_z = tzc.ztest(dup, cs, nc, **geo)
    assert torch.equal(ids, again_ids) and torch.equal(z, again_z)
    assert bool(ids.any())


def _cudart():
    """The CUDA runtime that PyTorch loaded, for what torch does not expose."""
    try:
        return ctypes.CDLL("libcudart.so.12")
    except OSError:
        import glob
        import os
        import sys
        found = [p for d in sys.path for p in glob.glob(os.path.join(d, "nvidia/cuda_runtime/lib/libcudart.so*"))]
        return ctypes.CDLL(found[0])


@pytest.mark.cuda
def test_ztest_refused_launch_raises_and_does_not_fall_back(cuda_device, monkeypatch):
    """A launch that the library or the card refuses raises from the
    wrapper; the plain version is not taken in its place, no launch is
    counted, the grid is not recorded, and the card goes on working."""
    dup, cs, nc, geo = _ztest_case_on("near_ulp", 32, cuda_device)
    lib = cuda_build.load("ztest", tzc._ARGTYPES)
    out_id = torch.empty((1, 1024), dtype=torch.int32, device=cuda_device)
    out_z = torch.empty((1, 1024), device=cuda_device)
    part = torch.empty((4 * lib.ztest_max_segments() * 256, 2), device=cuda_device)
    done = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    blocks = ctypes.c_int(-1)
    stream = torch.cuda.current_stream().cuda_stream
    # The library's own refusal: a chunk larger than its staging buffers.
    assert lib.ztest(dup.data_ptr(), dup.shape[1], cs.data_ptr(), nc.data_ptr(), out_id.data_ptr(),
                     out_z.data_ptr(), part.data_ptr(), done.data_ptr(), 1, 1, 4 * CHUNK, 32, stream,
                     ctypes.byref(blocks)) != 0
    assert blocks.value == -1

    # The card's refusal, through the wrapper and the real library. The
    # grid is at most six blocks per SM, so no tile count takes it past the
    # card's limit; instead the launch is passed on to the legacy default
    # stream while a blocking stream is being captured in global mode, which
    # the card refuses (cudaErrorStreamCaptureImplicit) before any block
    # runs. The wrapper's own allocations run on a side stream, warmed first.
    codes = []

    class OnTheLegacyStream:
        def __getattr__(self, entry):
            if entry != "ztest":
                return getattr(lib, entry)

            def call(*a):
                codes.append(lib.ztest(*a[:12], None, *a[13:]))
                return codes[-1]
            return call

    def never(*a, **k):
        raise AssertionError("the wrapper fell back to the plain version")

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        tzc.ztest(dup, cs, nc, **geo)
    torch.cuda.synchronize()
    monkeypatch.setattr(cuda_build, "load", lambda *a, **k: OnTheLegacyStream())
    monkeypatch.setattr(tzc, "ztest_ref", never)
    before, grid_before = dict(tzc.LAUNCHES), dict(tzc.LAST_GRID)
    rt = _cudart()
    capturing, graph = ctypes.c_void_p(), ctypes.c_void_p()
    assert rt.cudaStreamCreate(ctypes.byref(capturing)) == 0
    assert rt.cudaStreamBeginCapture(capturing, 0) == 0          # cudaStreamCaptureModeGlobal
    try:
        with torch.cuda.stream(side), pytest.raises(RuntimeError, match="launch failed"):
            tzc.ztest(dup, cs, nc, **geo)
    finally:
        ended = rt.cudaStreamEndCapture(capturing, ctypes.byref(graph))
        rt.cudaGetLastError()      # the capture's own error, not the launch's
        rt.cudaStreamDestroy(capturing)
    assert ended != 0 and codes and codes[0] != 0 and len(codes) == 1
    assert tzc.LAUNCHES == before and tzc.LAST_GRID == grid_before
    # The refusal is not left behind for the next CUDA call to find.
    monkeypatch.undo()
    torch.cuda.synchronize()
    _hold_ztest(dup, cs, nc, geo)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
def test_ztest_kernel_matches_plain_version(cuda_device, tile):
    """K3 on a mesh of small triangles: ids and z equal on every pixel (the
    kernel keeps the plain version's operation order, without fused
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
    _hold_ztest(dup, bins.chunk_starts, bins.n_chunks, geo)
    assert int(bins.n_chunks.max()) >= 2


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


def _uv_sphere_mesh(n_lat=40, n_lon=60, tex=256):
    """The bumpy sphere as a textured mesh: spherical uv per vertex and a
    smooth colour pattern, for the stage-2 renderer."""
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh

    v, f = _bumpy_sphere(n_lat, n_lon, seed=6)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    vt = np.stack([0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi),
                   np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi], 1).astype(np.float32)
    yy, xx = np.mgrid[0:1:tex * 1j, 0:1:tex * 1j]
    albedo = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * xx + k) + 5 * yy * k)
                       for k in range(3)], -1).astype(np.float32)
    m = Mesh(v=v, f=f.astype(np.int32), vt=vt, ft=f.astype(np.int32), albedo=albedo)
    m.auto_normal()
    return m


STAGE2_SHAPES = [(256, 1.0)] + [(512, s) for s in (0.25, 0.75, 1.25, 1.75)]


@pytest.mark.cuda
@pytest.mark.parametrize("size,ssaa", STAGE2_SHAPES)
def test_render_mesh_on_card_matches_cpu(cuda_device, size, ssaa):
    """render_mesh on the card (K3) against the CPU (plain version) at the
    five stage-2 z-test shapes: 256^2 and 512^2 at every SSAA choice
    (128^2 to 896^2). Outputs within 1e-4 on all but 0.1% of the values
    (an antialiased silhouette pair may flip on a contracted edge
    product), the raw_albedo gradient within 1e-3 in relative norm
    (the card's index_add_ sums in another order)."""
    from dreamgaussian_tpu_torch.render import MeshRendererState, render_mesh

    m = _uv_sphere_mesh()
    cam = Camera.from_pose(orbit_camera(-15.0, 60.0, 2.0), size, size, 0.857, 0.857)
    w2c = cam.view[:3, :3].copy()
    w2c[1:3] *= -1
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        st = MeshRendererState.from_mesh(m, dev)
        raw = st.raw_albedo.clone().requires_grad_(True)
        arr = {k: torch.from_numpy(cam.arrays()[k]).to(dev) for k in ("view", "full_proj")}
        before = tzc.LAUNCHES["ztest"]
        out = render_mesh(st._replace(raw_albedo=raw), arr, torch.from_numpy(w2c.T.copy()).to(dev),
                          size, size, ssaa=ssaa)
        assert tzc.LAUNCHES["ztest"] - before == (0 if dev == "cpu" else 1)
        g = torch.Generator().manual_seed(size + int(ssaa * 4))
        out["image"].mul(torch.randn(out["image"].shape, generator=g).to(dev)).sum().backward()
        outs.append({k: v.detach().cpu() for k, v in out.items()})
        grads.append(raw.grad.cpu())
    assert float(outs[0]["alpha"].mean()) > 0.05
    for k in outs[0]:
        bad = (outs[1][k] - outs[0][k]).abs() > 1e-4
        assert float(bad.float().mean()) <= 1e-3, (k, int(bad.sum()))
    rel = float((grads[1] - grads[0]).norm() / grads[0].norm())
    assert rel <= 1e-3, rel


@pytest.mark.cuda
def test_stage2_step_on_card_launches_k3_three_times(cuda_device):
    """One Stage2Trainer step on the card with the known view and the fake
    Zero123 refine: the target render, the known view and the novel view
    go through K3; the loss is finite and the texture moves."""
    from dreamgaussian_tpu_torch.guidance.fake import fake_zero123_guidance
    from dreamgaussian_tpu_torch.train import Stage2Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    g = fake_zero123_guidance(image_size=64)
    opt = Config(dict(iters_refine=10, ref_size=64, novel_resolution=128, texture_lr=0.2))
    ref = np.full((64, 64, 3), 0.3, np.float32)
    tr = Stage2Trainer(opt, _uv_sphere_mesh(), ref_rgb=ref, ref_mask=np.ones((64, 64), np.float32),
                       refine_fns=((1.0, g.refine_fn(steps=50)),), refine_image_size=64)
    raw0 = tr.params["raw_albedo"].clone()
    before = tzc.LAUNCHES["ztest"]
    loss = float(tr.train_step())
    assert tzc.LAUNCHES["ztest"] - before == 3
    assert math.isfinite(loss) and loss > 0
    assert float((tr.params["raw_albedo"] - raw0).abs().max()) > 0


@pytest.mark.cuda
def test_clis_default_to_the_card(cuda_device, tmp_path):
    """Both CLIs at the golden run's sizes without a device key: they run on
    the card (K1 and K3 launched), writing the PLY and both meshes."""
    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.utils.config import Config

    png = disc_png(tmp_path / "disc.png")
    opt = Config({**image_options(), "input": png, "save_path": "g", "outdir": str(tmp_path),
                  "iters": 16, "ref_size": 32, "num_pts": 256, "capacity": 512,
                  "novel_resolutions": [32, 32, 32], "fake_guidance": True, "texture_size": 64,
                  "bake_resolution": 32, "mc_resolution": 32, "decimate_target": 2000,
                  "iters_refine": 3, "novel_resolution": 64, "refine_steps": 3,
                  "density_thresh": 0.2})
    k1, k3 = tcu.LAUNCHES["composite_fwd"], tzc.LAUNCHES["ztest"]
    cli1.run(opt)
    cli2.run(opt)
    assert tcu.LAUNCHES["composite_fwd"] > k1 and tzc.LAUNCHES["ztest"] >= k3 + 26 + 3 * 3
    assert (tmp_path / "g_model.ply").exists()
    for name in ("g_mesh.obj", "g.obj"):
        assert len(Mesh.load(str(tmp_path / name), resize=False).f) > 0


# -- the weights day on the card: snapshot loading and stage-1 checkpoints --


def _tiny_snapshot(root, dtype):
    """A tiny Zero123 snapshot written by the port's own writer on the card."""
    from dreamgaussian_tpu_torch.guidance.clip import CLIPVisionConfig
    from dreamgaussian_tpu_torch.guidance.synthetic import write_zero123_snapshot
    from dreamgaussian_tpu_torch.guidance.unet import UNetConfig
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig

    write_zero123_snapshot(
        str(root), UNetConfig(in_channels=8, block_out_channels=(8, 16), layers_per_block=1,
                              cross_attention_dim=16,
                              down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D")),
        VAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1),
        CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2, image_size=32, patch_size=16, projection_dim=16),
        dtype=dtype, seed=2, device="cuda")
    return str(root)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_load_zero123_on_the_card_is_strict(cuda_device, tmp_path, dtype):
    """A snapshot written on the card loads into bf16 modules on the card,
    every parameter its snapshot tensor cast to bf16; the CLIP embedding
    agrees with the CPU's; a stray key is refused."""
    from dreamgaussian_tpu_torch.guidance import convert, loader

    snap = _tiny_snapshot(tmp_path / "snap", dtype)
    ref = np.full((64, 64, 3), 0.5, np.float32)
    ref[16:48, 16:48] = [0.9, 0.2, 0.1]
    g = loader.load_zero123(snap, ref_image=ref, device="cuda")
    for module, sub, rename in ((g.unet, "unet", convert.unet_key),
                                (g.vae, "vae", convert.vae_key)):
        params = dict(module.named_parameters())
        sd = convert.load_torch_state_dict(snap, sub)
        assert sorted(rename(k) for k in sd) == sorted(params)
        for k, v in sd.items():
            p = params[rename(k)]
            assert p.is_cuda and p.dtype == torch.bfloat16
            assert torch.equal(p, v.to("cuda").to(torch.bfloat16)), k
    cpu = loader.load_zero123(snap, ref_image=ref, device="cpu")
    torch.testing.assert_close(g.clip_emb.cpu(), cpu.clip_emb, atol=1e-5, rtol=1e-5)
    with open(os.path.join(snap, "unet", "config.json")) as f:
        cfg = json.load(f)
    cfg["out_channels"] = 5      # conv_out's snapshot tensors no longer fit
    with open(os.path.join(snap, "unet", "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="conv_out"):
        loader.load_zero123(snap, ref_image=ref, device="cuda")


@pytest.mark.cuda
def test_stage1_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A card trainer's state round-trips bit for bit, both random states
    included, and the resumed trainer carries on (the card's float-atomic
    scatters make the continued run itself not bit-exact)."""
    from dreamgaussian_tpu_torch.guidance.fake import fake_zero123_guidance
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    opt = Config(dict(iters=8, ref_size=32, num_pts=256, novel_resolutions=[32, 32, 32],
                      density_start_iter=2, densification_interval=2))
    g = fake_zero123_guidance(device="cuda")
    rgb = np.ones((32, 32, 3), np.float32)
    mask = np.zeros((32, 32), np.float32)

    def make(capacity):
        return Stage1Trainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=capacity, seed=1,
                             guidance_fns=((1.0, g.guidance_fn()),), device="cuda")

    def state(t):
        return {**{f"p_{k}": v for k, v in t.params.items()},
                **{f"mu_{k}": v for k, v in t.adam.mu.items()},
                **{f"nu_{k}": v for k, v in t.adam.nu.items()},
                **{f"aux_{k}": v for k, v in t.aux._asdict().items()}}

    src = make(512)
    for _ in range(4):
        src.train_step()
    src.save_checkpoint(str(tmp_path))
    dst = make(300)
    dst.load_checkpoint(str(tmp_path))
    assert dst.step == 4 and dst.capacity == 512 and dst.adam.count == src.adam.count
    assert dst.rng.bit_generator.state == src.rng.bit_generator.state
    assert np.array_equal(dst.draw.get_state(), src.draw.get_state())
    a, b = state(src), state(dst)
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        assert b[k].is_cuda and torch.equal(v, b[k]), k
    before = tcu.LAUNCHES["composite_bwd"]
    stats = dst.train(4, log_every=0)
    assert stats["step"] == 8 and np.isfinite(stats["loss"])
    assert tcu.LAUNCHES["composite_bwd"] >= before + 4


# -- the text priors on the card: SD 2.x, MVDream and ImageDream at small width --


def _tiny_text_guidance(prior, device):
    """SD, MVDream or ImageDream guidance on tiny float32 nets with seeded
    weights (the same on every device): linear projections, 2 heads, for
    MVDream 4-view joint attention and the camera MLP, for ImageDream 4+1
    views, the camera MLP and the IP-adapter path (7 image tokens of width
    20, 4 resampled; 64/128 channels, so that GroupNorm does not normalise
    the constant identity view of the uncond half over single channels);
    VAE (4, 8)."""
    from dreamgaussian_tpu_torch.guidance.realarch import init_on_device
    from dreamgaussian_tpu_torch.guidance.sds import (ImageDreamGuidance, MVDreamGuidance,
                                                      StableDiffusionGuidance)
    from dreamgaussian_tpu_torch.guidance.unet import UNet, UNetConfig
    from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    kw = {"sd": {}, "mvdream": {"num_views": 4},
          "imagedream": {"num_views": 5, "block_out_channels": (64, 128), "ip_dim": 4,
                         "ip_embed_dim": 20, "ip_resampler_dim": 16, "ip_resampler_depth": 2,
                         "ip_resampler_heads": 2}}[prior]
    cfg = UNetConfig(**{"in_channels": 4, "block_out_channels": (32, 64), "layers_per_block": 1,
                        "cross_attention_dim": 24, "num_attention_heads": 2,
                        "use_linear_projection": True,
                        "down_block_types": ("CrossAttnDownBlock2D", "DownBlock2D"),
                        "up_block_types": ("UpBlock2D", "CrossAttnUpBlock2D"), **kw})
    gen = torch.Generator().manual_seed(3)
    with torch.device("meta"):
        unet, vae = UNet(cfg), AutoencoderKL(VAEConfig(block_out_channels=(4, 8),
                                                       layers_per_block=1))
    unet, vae = (init_on_device(m, "cpu", gen).to(device) for m in (unet, vae))
    names = ("pos", "neg") if prior != "sd" else ("pos", "neg", "front", "side", "back")
    emb = {k: (torch.randn((5, 24), generator=gen) * 0.5).to(device) for k in names}
    if prior == "imagedream":
        img = {"pos": torch.randn((7, 20), generator=gen).to(device),
               "ip_img": torch.randn((16, 16, 4), generator=gen).to(device)}
        return ImageDreamGuidance(unet, vae, emb, img, image_size=32)
    cls = MVDreamGuidance if prior == "mvdream" else StableDiffusionGuidance
    return cls(unet, vae, emb, image_size=32)


@pytest.mark.cuda
@pytest.mark.parametrize("prior", ["sd", "mvdream", "imagedream"])
def test_text_guidance_on_card_matches_cpu(cuda_device, prior):
    """SDS loss and image gradient (float32, CFG 100, the same noise and
    timestep) and the refine on the card against the same guidance on the
    CPU: 1e-4 of the loss, 2e-4 of the largest gradient, 1e-4 in the
    refined images."""
    rng = np.random.default_rng(4)
    b = 6 if prior == "sd" else 8
    images = torch.from_numpy(rng.uniform(size=(b, 48, 48, 3)).astype(np.float32))
    poses = np.stack([orbit_camera(10.0, 30.0 + 90 * i + 45 * (i // 4), 2.5)
                      for i in range(b)]).astype(np.float32)
    cond = {"hors": torch.tensor([-170.0, -90.0, 0.0, 45.0, 100.0, 150.0, 10.0, 20.0][:b]),
            "poses": torch.from_numpy(poses)}
    noise = torch.from_numpy(rng.normal(size=(b, 16, 16, 4)).astype(np.float32))

    def draw(name, shape, dist, low=0, high=None):
        return torch.tensor(377) if name == "sds_t" else noise[:shape[0]]

    out = {}
    for dev in ("cpu", "cuda"):
        g = _tiny_text_guidance(prior, dev)
        g.anneal = False
        x = images.clone().to(dev).requires_grad_(True)
        loss = g.guidance_fn()(x, {k: v.to(dev) for k, v in cond.items()}, 0.4, draw)
        loss.backward()
        refined = g.refine_fn(steps=10)(images.to(dev), {k: v.to(dev) for k, v in cond.items()},
                                        np.float32(0.8), lambda n, s, d: noise[:s[0]])
        out[dev] = (float(loss.detach()), x.grad.cpu(), refined.cpu())
    (l_c, g_c, r_c), (l_g, g_g, r_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c)
    assert float((g_g - g_c).abs().max()) <= 2e-4 * float(g_c.abs().max())
    assert float((r_g - r_c).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_four_view_stage1_step_holds_k1_k2(cuda_device):
    """One Stage1Trainer step on configs/text_mv.yaml's keys with the fake
    MVDream on the card: 4 views per sampled camera, each through K1 and K2;
    every call held against the plain versions with chip_smoke.py's gates."""
    from chip_smoke import hold_composite_calls, tapped
    from dreamgaussian_tpu_torch.guidance.fake import fake_mvdream_guidance
    from dreamgaussian_tpu_torch.ops import rasterize
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config, load

    text_mv = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "text_mv.yaml")
    opt = Config({**dict(load(text_mv)), "prompt": "a cup", "novel_resolutions": [256, 256, 256]})
    g = fake_mvdream_guidance(device="cuda")
    tr = Stage1Trainer(opt, capacity=opt["capacity"], seed=2,
                       guidance_fns=((1.0, g.guidance_fn()),), device="cuda")
    fwd, bwd = [], []
    with (tapped(rasterize, "composite_forward", fwd, tcu.LAST_GRID, "composite_fwd"),
          tapped(rasterize, "composite_backward", bwd, tcu.LAST_GRID, "composite_bwd")):
        loss = float(tr.train_step())
    assert math.isfinite(loss) and len(fwd) == 4 and len(bwd) == 4
    rows = hold_composite_calls("4-view step", fwd, bwd)
    assert [r["calls"] for r in rows["composite_fwd"]] == [4]


@pytest.mark.cuda
def test_random_mvdream_guidance_steps_on_the_card(cuda_device):
    """The full-width 4-view architecture with random bf16 weights: one SDS
    step on a group of 4 views at 256^2 gives a finite loss and gradient."""
    from dreamgaussian_tpu_torch.guidance.realarch import random_mvdream_guidance

    g = random_mvdream_guidance(seed=1)
    assert 0.9e9 < g.num_parameters() < 1.0e9
    poses = np.stack([orbit_camera(0.0, 90.0 * i, 2.5) for i in range(4)]).astype(np.float32)
    x = torch.rand(4, 256, 256, 3, device="cuda", requires_grad=True)
    gen = torch.Generator("cuda").manual_seed(0)
    loss = g.guidance_fn()(x, {"poses": torch.from_numpy(poses).cuda()}, 0.5,
                           lambda n, s, d, *a: torch.randn(s, device="cuda", generator=gen))
    loss.backward()
    assert math.isfinite(float(loss.detach())) and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0


@pytest.mark.cuda
def test_four_plus_one_view_stage1_step_holds_k1_k2(cuda_device, tmp_path):
    """One Stage1Trainer step on configs/imagedream.yaml's keys with the fake
    ImageDream on the card and a disc input: the input conditions the
    guidance (no known view), 4 views per sampled camera, each through K1
    and K2; every call held against the plain versions with chip_smoke.py's
    gates."""
    from chip_smoke import hold_composite_calls, tapped
    from dreamgaussian_tpu_torch.cli.main import load_reference
    from dreamgaussian_tpu_torch.guidance.fake import fake_imagedream_guidance
    from dreamgaussian_tpu_torch.ops import rasterize
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config, load

    yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "imagedream.yaml")
    opt = Config({**dict(load(yaml)), "input": disc_png(tmp_path / "d.png", 256),
                  "novel_resolutions": [256, 256, 256]})
    rgb, mask = load_reference(opt)
    g = fake_imagedream_guidance(device="cuda")
    tr = Stage1Trainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=opt["capacity"], seed=2,
                       guidance_fns=((1.0, g.guidance_fn()),), device="cuda")
    assert not tr.use_known_view and tr.n_views == 4
    fwd, bwd = [], []
    with (tapped(rasterize, "composite_forward", fwd, tcu.LAST_GRID, "composite_fwd"),
          tapped(rasterize, "composite_backward", bwd, tcu.LAST_GRID, "composite_bwd")):
        loss = float(tr.train_step())
    assert math.isfinite(loss) and len(fwd) == 4 and len(bwd) == 4
    rows = hold_composite_calls("4+1-view step", fwd, bwd)
    assert [r["calls"] for r in rows["composite_fwd"]] == [4]


@pytest.mark.cuda
def test_random_imagedream_guidance_steps_on_the_card(cuda_device):
    """The full-width 4+1-view IP-adapter architecture with random bf16
    weights: one SDS step on a group of 4 views at 256^2 gives a finite loss
    and gradient, and one refine step finite images."""
    from dreamgaussian_tpu_torch.guidance.realarch import random_imagedream_guidance

    g = random_imagedream_guidance(seed=1)
    assert 1.0e9 < g.num_parameters() < 1.1e9
    poses = torch.from_numpy(np.stack([orbit_camera(0.0, 90.0 * i, 2.5)
                                       for i in range(4)]).astype(np.float32)).cuda()
    x = torch.rand(4, 256, 256, 3, device="cuda", requires_grad=True)
    gen = torch.Generator("cuda").manual_seed(0)
    draw = lambda n, s, d, *a: torch.randn(s, device="cuda", generator=gen)  # noqa: E731
    loss = g.guidance_fn()(x, {"poses": poses}, 0.5, draw)
    loss.backward()
    assert math.isfinite(float(loss.detach())) and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0
    out = g.refine_fn(steps=50)(x.detach(), {"poses": poses}, np.float32(0.98), draw)
    assert tuple(out.shape) == (4, 256, 256, 3) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("prior", ["sd", "mvdream", "imagedream"])
def test_sampler_on_card_matches_cpu(cuda_device, prior):
    """The fake prior's sampler (its tiny denoiser made on the CPU, then
    moved) at 10 steps from the same noise on the card and on the CPU:
    the images in [0, 1] to 1e-4."""
    from dreamgaussian_tpu_torch.guidance import fake

    cpu = {"sd": fake.fake_sd_guidance, "mvdream": fake.fake_mvdream_guidance,
           "imagedream": fake.fake_imagedream_guidance}[prior](device="cpu")
    poses = torch.from_numpy(np.stack([orbit_camera(10.0, 30.0 + 90 * i, 2.0)
                                       for i in range(4)]).astype(np.float32))
    noise = torch.randn((1 if prior == "sd" else 4, 8, 8, 4),
                        generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", "cuda"):
        g = type(cpu)(cpu.unet.to(dev), cpu.vae, {k: v.to(dev) for k, v in cpu.emb.items()},
                      *([{k: v.to(dev) for k, v in cpu.img_emb.items()}]
                        if prior == "imagedream" else []), image_size=64)
        fn = g.sample_fn(steps=10)
        draw = lambda n, s, d: noise  # noqa: E731
        out[dev] = (fn(draw) if prior == "sd" else fn(poses.to(dev), draw)).cpu()
    assert out["cpu"].shape == out["cuda"].shape
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4
