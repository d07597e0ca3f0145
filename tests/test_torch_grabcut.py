"""The port's GrabCut matting without weights (``preprocess/grabcut.py``
with the max-flow of ``csrc/image_tools.cpp``) against cv2's, reached
through the JAX package's ``remove_background`` without U2Net weights.

Tolerances: the min-cut's flow equal to scipy's exactly on integer
capacities, and the cut of its source side equal to the flow; the blur
equal to ``cv2.GaussianBlur`` bit for bit; the GMMs equal to OpenCV's
formulas in float64 bit for bit on the same labels; the matte's
``alpha >= 128`` mask at IoU >= 0.95 against cv2's (k-means draws differ:
OpenCV draws from its own RNG). Then ``cli.process`` and ``cli.main`` on a
JPEG without weights."""

import cv2
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_flow

from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.preprocess import grabcut as tgc
from dreamgaussian_tpu_torch.utils.png import read_png
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import JPEG_FIXTURES, SCENES, iou, scene

IOU_MIN = 0.95


def _grid_graph(h, w, seed):
    """A random 8-neighbour grid with integer capacities, edges in GrabCut's
    order, some of them 0, both directions drawn apart."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 20, (4, h, w)).astype(np.float64)
    src, dst, cap = tgc._neighbour_edges(h, w, planes)
    rev = rng.integers(0, 20, cap.shape).astype(np.float64)
    source_w = rng.integers(0, 40, h * w) * (rng.random(h * w) < 0.6)
    sink_w = rng.integers(0, 40, h * w) * (rng.random(h * w) < 0.6)
    return source_w.astype(np.float64), sink_w.astype(np.float64), src, dst, cap, rev


def _scipy_flow(source_w, sink_w, src, dst, cap, rev):
    n = len(source_w)
    s, t = n, n + 1
    rows = np.concatenate([src, dst, np.full(n, s), np.arange(n)])
    cols = np.concatenate([dst, src, np.arange(n), np.full(n, t)])
    vals = np.concatenate([cap, rev, source_w, sink_w]).astype(np.int32)
    graph = csr_matrix((vals, (rows, cols)), shape=(n + 2, n + 2))
    return maximum_flow(graph, s, t).flow_value


@pytest.mark.parametrize("h,w,seed", [(1, 7, 0), (5, 5, 1), (12, 9, 2), (24, 31, 3),
                                      (40, 40, 4)])
def test_min_cut_flow_equals_scipys(h, w, seed):
    graph = _grid_graph(h, w, seed)
    side, flow = tgc.min_cut(*graph)
    assert flow == _scipy_flow(*graph)
    source_w, sink_w, src, dst, cap, rev = graph
    cut = (sink_w[side].sum() + source_w[~side].sum()
           + cap[side[src] & ~side[dst]].sum() + rev[side[dst] & ~side[src]].sum())
    assert cut == flow


def test_min_cut_refuses_edges_outside_the_graph():
    ones = np.ones(3)
    with pytest.raises(ValueError):
        tgc.min_cut(ones, ones, np.array([0]), np.array([3]), ones[:1], ones[:1])
    with pytest.raises(ValueError):
        tgc.min_cut(ones, ones, np.array([1]), np.array([1]), ones[:1], ones[:1])


@pytest.mark.parametrize("h,w", [(5, 5), (3, 7), (17, 23), (33, 9), (63, 41), (101, 77)])
def test_blur_equals_cv2_bit_for_bit(h, w):
    rng = np.random.default_rng(h * w)
    mask = ((rng.random((h, w)) < 0.5) * 255).astype(np.uint8)
    levels = rng.integers(0, 256, (h, w), dtype=np.uint8)
    for a in (mask, levels):
        got = tgc.gaussian_blur5(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(got, cv2.GaussianBlur(a, (5, 5), 0))


def test_gmm_equals_opencvs_formulas():
    """endLearning and calcInverseCovAndDeterm in float64 on given labels,
    one component singular (one colour), one empty."""
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 256, (500, 3)).astype(np.float64)
    comp = rng.integers(0, 3, 500)
    colors[comp == 2] = (10, 200, 30)
    g = tgc.GMM(torch.from_numpy(colors), torch.from_numpy(comp))
    for ci in range(tgc.COMPONENTS):
        x = colors[comp == ci]
        if len(x) == 0:
            assert g.weight[ci] == 0
            continue
        n = len(x)
        inv_n = 1.0 / n
        m = x.sum(0) * inv_n
        c = np.array([(x[:, i] * x[:, j]).sum() * inv_n - m[i] * m[j]
                      for i in range(3) for j in range(3)])
        d = c[0] * (c[4] * c[8] - c[5] * c[7]) - c[1] * (c[3] * c[8] - c[5] * c[6]) \
            + c[2] * (c[3] * c[7] - c[4] * c[6])
        if d <= 1e-6:
            c[[0, 4, 8]] += 0.01
            d = c[0] * (c[4] * c[8] - c[5] * c[7]) - c[1] * (c[3] * c[8] - c[5] * c[6]) \
                + c[2] * (c[3] * c[7] - c[4] * c[6])
        assert g.weight[ci].item() == n / 500
        np.testing.assert_array_equal(g.mean[ci].numpy(), m)
        np.testing.assert_array_equal(g.cov[ci].numpy(), c)
        assert g.det[ci].item() == d
        assert g.inv[ci, 0, 0].item() == (c[4] * c[8] - c[5] * c[7]) * (1.0 / d)


def test_kmeans_leaves_no_cluster_empty():
    """Fewer distinct colours than clusters: OpenCV's step that moves the
    farthest sample of the largest cluster into an empty one runs."""
    x = torch.tensor([[10.0, 10, 10]] * 30 + [[200.0, 0, 0]] * 20 + [[0.0, 90, 90]] * 5)
    labels = tgc.kmeans(x, 5, torch.Generator().manual_seed(0))
    assert sorted(set(labels.tolist())) == [0, 1, 2, 3, 4]


def test_kmeans_finds_separated_clusters():
    rng = np.random.default_rng(1)
    centres = np.array([[0, 0, 0], [250, 0, 0], [0, 250, 0], [0, 0, 250], [250, 250, 250]])
    truth = rng.integers(0, 5, 2000)
    x = torch.from_numpy((centres[truth] + rng.normal(0, 5, (2000, 3))).astype(np.float32))
    labels = tgc.kmeans(x, 5, torch.Generator().manual_seed(0)).numpy()
    assert labels.min() == 0 and labels.max() == 4
    # each true cluster is one label, and no two share one
    pairs = {(t, lab) for t, lab in zip(truth, labels)}
    assert len(pairs) == 5 and len({lab for _, lab in pairs}) == 5


@pytest.mark.parametrize("h,w", [(96, 128), (120, 90)])
@pytest.mark.parametrize("kind", SCENES)
def test_grabcut_matte_matches_cv2s(monkeypatch, kind, h, w):
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    img = scene(kind, h, w, seed=h + w)
    cv2.setRNGSeed(0)
    ref = jproc.remove_background(img)
    got = tproc.remove_background(img, device="cpu")
    np.testing.assert_array_equal(got[..., :3], img)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    assert iou(got[..., 3], ref[..., 3]) >= IOU_MIN
    assert 0.05 < (got[..., 3] >= 128).mean() < 0.6


def test_grabcut_refuses_an_image_smaller_than_its_rect():
    """The rect inset by 4 on each side leaves no probable foreground; cv2
    asserts there, the port raises."""
    with pytest.raises(ValueError, match="no background or no foreground"):
        tgc.grabcut_alpha(np.zeros((8, 8, 3), np.uint8), device="cpu")


def _jpeg(path, img):
    assert cv2.imwrite(str(path), np.ascontiguousarray(img[..., ::-1]))
    return str(path)


def test_process_main_mats_a_jpeg_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = _jpeg(tmp_path / "photo.jpg", scene("ellipse", 90, 120, seed=3))
    out = tproc.main([path, "--size", "64", "--device", "cpu"])
    assert out == str(tmp_path / "photo_rgba.png")
    written = read_png(out)
    want = tproc.load_rgba(path, size=64, device="cpu")
    np.testing.assert_array_equal(written, (want * 255).astype(np.uint8))
    assert written[..., 3].max() == 255 and written[0, 0, 3] == 0     # matted and recentred
    cv2.setRNGSeed(0)
    ref = jproc.load_rgba(path, size=64)
    assert iou(written[..., 3], (ref[..., 3] * 255).astype(np.uint8)) >= IOU_MIN


def test_stage1_cli_on_a_jpeg_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = _jpeg(tmp_path / "toy.jpg", scene("disc", 96, 96, seed=4))
    tcli1.main(["--config", "configs/image.yaml", f"input={path}", f"outdir={tmp_path}",
                "save_path=toy", "iters=3", "ref_size=32", "num_pts=256", "capacity=512",
                "novel_resolutions=[32,32,32]", "fake_guidance=True", "save_mesh=False",
                "device=cpu"])
    assert (tmp_path / "toy_model.ply").stat().st_size > 0


def test_grabcut_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgc.grabcut_alpha(scene("disc", 32, 32, seed=0))


def test_stored_matte_is_the_jax_remove_backgrounds(monkeypatch):
    """The fixture the card run holds GrabCut against is what the JAX
    package's remove_background gives on the decoded 512^2 photo."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    img = tproc.read_image(str(JPEG_FIXTURES / "photo_512.jpg"))
    cv2.setRNGSeed(0)
    ref = jproc.remove_background(img)[..., 3]
    np.testing.assert_array_equal(read_png(str(JPEG_FIXTURES / "photo_512_alpha.png")), ref)
