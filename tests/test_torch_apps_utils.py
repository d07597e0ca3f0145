"""The apps' utilities in the PyTorch port against their references on the
same numpy inputs: ``OrbitCamera`` against the JAX package's, the resizes
against OpenCV's, the GIF writer against Pillow's reader, and LPIPS
against the JAX package's.

Tolerances: the orbit camera's matrices within 1e-6 absolute; resized
uint8 images equal, float32 maps within 1e-6; LPIPS within 1e-5 relative."""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from dreamgaussian_tpu.utils.camera import OrbitCamera as JOrbit
from dreamgaussian_tpu.utils.lpips import LPIPS as JLPIPS
from dreamgaussian_tpu_torch.guidance import synthetic
from dreamgaussian_tpu_torch.utils import gif
from dreamgaussian_tpu_torch.utils.camera import OrbitCamera as TOrbit
from dreamgaussian_tpu_torch.utils.lpips import LPIPS as TLPIPS
from dreamgaussian_tpu_torch.utils.resize import resize_area, resize_linear
from torch_cpu_cases import one_torch_thread  # noqa: F401

ORBIT_MOVES = [("orbit", (30.0, -12.0)), ("scale", (2.0,)), ("pan", (40.0, -25.0, 5.0)),
               ("orbit", (-170.0, 55.0)), ("scale", (-1.5,)), ("pan", (-3.0, 8.0)),
               ("orbit", (12.5, 300.0))]


def test_orbit_camera_matches_jax():
    j, t = JOrbit(320, 240, r=2.5, fovy=55.0), TOrbit(320, 240, r=2.5, fovy=55.0)
    for name, args in ORBIT_MOVES:
        getattr(j, name)(*args)
        getattr(t, name)(*args)
        for prop in ("pose", "campos", "view", "perspective", "intrinsics", "mvp"):
            np.testing.assert_allclose(getattr(t, prop), getattr(j, prop), atol=1e-6,
                                       err_msg=f"{prop} after {name}{args}")
        assert t.fovx == j.fovx and t.radius == j.radius


# (source H, W, destination H, W): enlarging, shrinking by integer factors
# (2x2 and others) and by other factors, and one axis each way.
RESIZE_CASES = [(20, 30, 57, 71), (37, 23, 320, 320), (64, 64, 32, 32), (90, 60, 30, 30),
                (128, 96, 32, 24), (301, 207, 100, 70), (50, 50, 49, 49), (400, 200, 320, 320),
                (320, 320, 48, 40), (320, 320, 333, 700)]


@pytest.mark.parametrize("src_h,src_w,h,w", RESIZE_CASES)
def test_resizes_match_opencv(src_h, src_w, h, w):
    rng = np.random.default_rng(src_h * 1000 + w)
    for c in (3, 4):
        img = rng.integers(0, 256, size=(src_h, src_w, c), dtype=np.uint8)
        np.testing.assert_array_equal(resize_area(img, h, w),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
    m = rng.random((src_h, src_w)).astype(np.float32)
    got = resize_linear(m, h, w)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR),
                               atol=1e-6)


def _frames():
    """A smooth gradient (more than 256 colours), noise, a flat two-colour
    frame and a shaded disc on white, as a turntable frame looks."""
    yy, xx = np.mgrid[0:96, 0:128]
    rng = np.random.default_rng(3)
    disc = np.full((96, 128, 3), 255, np.uint8)
    inside = (yy - 48) ** 2 + (xx - 64) ** 2 < 40 ** 2
    shade = 0.5 + 0.5 * np.cos(xx / 9.0) * np.sin(yy / 13.0)
    disc[inside] = np.stack([200 * shade, 120 * shade + 40, 60 + 0 * shade], -1)[inside]
    flat = np.full((96, 128, 3), 255, np.uint8)
    flat[20:60, 30:90] = [200, 10, 10]
    return [np.stack([xx * 2, yy * 2, (xx + yy) % 256], -1).astype(np.uint8),
            rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), flat, disc]


# Mean absolute error of a median-cut palette frame against its source, in
# levels of 255. The gradient's 12,288 colours lie on a surface that 256
# colours cover to 3.11 levels whichever box median cut splits first (the
# widest range, the largest squared error, range times pixels); the noise
# (12,288 random colours in 256 boxes) to about 11; the shaded disc's few
# hundred to under 0.01.
GIF_MEAN_ERR = {0: 4.0, 1: 12.0, 2: 0.0, 3: 1.0}


def test_gif_reads_back_in_pillow(tmp_path):
    frames = _frames()
    path = str(tmp_path / "t.gif")
    gif.write_gif(path, frames, fps=15)
    ours, delay = gif.read_gif(path)
    im = Image.open(path)
    assert im.n_frames == len(frames) and im.info["loop"] == 0
    assert delay == 6 and im.info["duration"] == 60      # int(1000 / 15 / 10) centiseconds
    for k, f in enumerate(frames):
        palette, idx = gif.quantize(f)
        held = palette[idx]
        im.seek(k)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), held, err_msg=f"frame {k}")
        np.testing.assert_array_equal(ours[k], held, err_msg=f"frame {k}")
        assert np.abs(held.astype(int) - f).mean() <= GIF_MEAN_ERR[k], k


def test_gif_long_frame_clears_the_code_table(tmp_path):
    """A frame with more than 4093 distinct strings makes the LZW table fill
    and clear mid-frame; Pillow and the port's reader still agree."""
    frame = np.random.default_rng(1).integers(0, 256, (300, 300, 3), dtype=np.uint8)
    data = gif.encode_gif([frame])
    palette, idx = gif.quantize(frame)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                  palette[idx])
    np.testing.assert_array_equal(gif.decode_gif(data)[0][0], palette[idx])


@pytest.fixture(scope="module")
def vgg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    vgg, lins = str(d / "vgg16.pth"), str(d / "vgg.pth")
    synthetic.write_vgg16_features(vgg, seed=0, device="cpu")
    synthetic.write_lpips_lins(lins, seed=1, device="cpu")
    return vgg, lins


@pytest.mark.parametrize("with_lins", [False, True])
def test_lpips_matches_jax(vgg_files, with_lins):
    vgg, lins = vgg_files
    rng = np.random.default_rng(4)
    a = rng.random((2, 32, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = np.asarray(JLPIPS(vgg, lins if with_lins else None)(a, b))
    got = TLPIPS(vgg, lins if with_lins else None, device="cpu")(a, b).numpy()
    assert got.shape == (2,) and (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(TLPIPS(vgg, device="cpu")(a, a).numpy(), 0.0, atol=1e-12)


def test_lpips_needs_a_card_unless_cpu(vgg_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLPIPS(vgg_files[0])
