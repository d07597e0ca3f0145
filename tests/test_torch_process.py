"""Input preprocessing of the PyTorch port against the JAX package's
(U2Net in torch on the CPU, cv2 for decoding and resizing) on the same
inputs: U2Net's matte, ``recenter``, ``load_rgba`` of RGB and grey PNGs,
``cli.process.main``, and what still raises (JPEGs and GrabCut:
``test_torch_jpeg.py``, ``test_torch_grabcut.py``).

Tolerances: the matte within 1e-5 absolute; recentred images equal;
loaded RGB equal and alpha within one level of 255."""

import numpy as np
import pytest
import torch
from PIL import Image

from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu.preprocess.u2net import u2net_alpha as j_u2net_alpha
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.guidance import synthetic
from dreamgaussian_tpu_torch.preprocess.u2net import u2net_alpha as t_u2net_alpha
from dreamgaussian_tpu_torch.utils.png import read_png
from torch_cpu_cases import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def u2net_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("u2net")
    paths = {"full": str(d / "u2net.pth"), "small": str(d / "u2netp.pth")}
    synthetic.write_u2net(paths["full"], full=True, seed=0, device="cpu")
    synthetic.write_u2net(paths["small"], full=False, seed=1, device="cpu")
    return paths


def _photo(h, w, seed):
    """An RGB 'photo': a bright blob on a darker textured background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((yy - 0.45 * h) / (0.2 * h)) ** 2 + ((xx - 0.55 * w) / (0.25 * w)) ** 2))
    img = 60 + 150 * blob[..., None] * np.array([1.0, 0.7, 0.4]) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("variant,h,w,size", [("full", 48, 40, 64), ("small", 90, 70, 320),
                                              ("small", 400, 300, 320)])
def test_u2net_alpha_matches_jax(u2net_files, variant, h, w, size):
    rgb = _photo(h, w, h)
    ref = j_u2net_alpha(rgb, u2net_files[variant], size=size)
    got = t_u2net_alpha(rgb, u2net_files[variant], size=size, device="cpu")
    assert got.shape == (h, w) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() - got.min() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-5)


# (canvas H, W, box y0, y1, x0, x1, output size): boxes that recentring
# shrinks and ones that it enlarges, wide and tall.
RECENTER_CASES = [(200, 160, 20, 180, 30, 140, 128), (64, 64, 10, 30, 20, 28, 256),
                  (120, 300, 50, 70, 10, 290, 96), (40, 40, 0, 40, 0, 40, 40)]


@pytest.mark.parametrize("h,w,y0,y1,x0,x1,size", RECENTER_CASES)
def test_recenter_matches_jax(h, w, y0, y1, x0, x1, size):
    rng = np.random.default_rng(h + w)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba[..., 3] = 0
    rgba[y0:y1, x0:x1, 3] = rng.integers(1, 256, (y1 - y0, x1 - x0))
    np.testing.assert_array_equal(tproc.recenter(rgba, size), jproc.recenter(rgba, size))


@pytest.mark.parametrize("grey", [False, True])
def test_load_rgba_of_rgb_and_grey_matches_jax(tmp_path, u2net_files, grey):
    rgb = _photo(150, 110, 7)
    path = str(tmp_path / "photo.png")
    Image.fromarray(rgb[..., 0] if grey else rgb).save(path)
    ref = jproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.shape == (64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


def test_grey_alpha_png_keeps_its_alpha(tmp_path):
    la = np.random.default_rng(2).integers(0, 256, (24, 20, 2), dtype=np.uint8)
    path = str(tmp_path / "la.png")
    Image.fromarray(la, mode="LA").save(path)
    np.testing.assert_array_equal(tproc.load_rgba(path), jproc.load_rgba(path))


def test_process_main_writes_rgba(tmp_path, u2net_files):
    path = str(tmp_path / "cat.png")
    Image.fromarray(_photo(80, 100, 3)).save(path)
    out = tproc.main([path, "--size", "64", "--u2net", u2net_files["small"], "--device", "cpu"])
    assert out == str(tmp_path / "cat_rgba.png")
    written = read_png(out)
    want = tproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"], device="cpu")
    np.testing.assert_array_equal(written, (want * 255).astype(np.uint8))
    assert written[..., 3].max() > 128 and written[0, 0, 3] == 0     # matted and recentred


def test_missing_weights_and_formats_raise(tmp_path, monkeypatch):
    """What still raises since JPEGs, GrabCut, WebP, TIFF and JPEG 2000 are ported: a named
    U2Net file that is missing (the JAX package falls back to GrabCut
    silently) and the formats cv2 reads that the port does not."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = str(tmp_path / "rgb.png")
    Image.fromarray(_photo(16, 16, 1)).save(path)
    with pytest.raises(FileNotFoundError, match="U2Net"):
        tproc.load_rgba(path, u2net_ckpt=str(tmp_path / "none.pth"), device="cpu")
    monkeypatch.setenv("DG_U2NET_CKPT", str(tmp_path / "none.pth"))
    with pytest.raises(FileNotFoundError, match="U2Net"):
        tproc.load_rgba(path, device="cpu")
    other = str(tmp_path / "x.avif")
    Image.fromarray(_photo(16, 16, 1)).save(other)
    with pytest.raises(NotImplementedError, match="AVIF"):
        tproc.load_rgba(other, device="cpu")
    rgb_jp2 = str(tmp_path / "x.jp2")                # read now: matted, by the missing U2Net
    Image.fromarray(_photo(16, 16, 1)).save(rgb_jp2)
    with pytest.raises(FileNotFoundError, match="U2Net"):
        tproc.load_rgba(rgb_jp2, device="cpu")


def test_process_needs_a_card_unless_cpu(tmp_path, u2net_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "p.png")
    Image.fromarray(_photo(16, 16, 1)).save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproc.main([path, "--u2net", u2net_files["small"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_u2net_alpha(_photo(16, 16, 1), u2net_files["small"])
