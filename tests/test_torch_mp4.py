"""The port's H.264 MP4 turntables (``utils/mp4.py`` over
``csrc/h264_intra.cpp``) read back through ffmpeg's own H.264 decoder, by
way of ``cv2.VideoCapture(path, cv2.CAP_FFMPEG)``; no JAX (the frames
themselves are held against the JAX package by ``test_torch_apps.py``).

With ``CAP_PROP_CONVERT_RGB`` 0 the decoder hands back the luma plane,
which must equal the encoder's reconstruction bit for bit (the loop filter
is off, so the reconstruction is what any decoder outputs). With it on,
cv2 converts the decoded yuv420p to BGR through its bundled swscale
(bicubic flags); the same swscale call (through ctypes) on the encoder's
reconstructed planes must give that BGR bit for bit, which holds the
chroma planes too. Against the input frames: a flat colour within 4
levels per channel, the turntable at PSNR >= 30 dB."""

import ctypes
import glob
import math
import os

import cv2
import numpy as np
import pytest

from dreamgaussian_tpu_torch import native
from dreamgaussian_tpu_torch.cli import render as trender
from dreamgaussian_tpu_torch.utils import mp4
from torch_apps_cases import write_sphere_obj
from torch_cpu_cases import one_torch_thread  # noqa: F401

FOV = math.radians(49.1)
TURNTABLE = (4, 64)   # frames, size
IMAGEIO_WARNING = (
    "IMAGEIO FFMPEG_WRITER WARNING: input image is not divisible by macro_block_size=16, "
    "resizing from {} to {} to ensure video compatibility with most codecs and players. To "
    "prevent resizing, make your input image divisible by the macro_block_size or set the "
    "macro_block_size to 1 (risking incompatibility).")


def decode(path, rgb=False):
    """(frames, CAP_PROP_FRAME_COUNT, CAP_PROP_FPS) of ffmpeg's decode:
    luma planes, or RGB with ``rgb``."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    assert cap.isOpened(), path
    if not rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1] if rgb else f)
    count, fps = cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, count, fps


def swscale_bgr(y, cb, cr):
    """yuv420p planes to BGR as cv2's FFMPEG capture converts them:
    ``sws_getContext(w, h, YUV420P, w, h, BGR24, SWS_BICUBIC)`` of the
    swscale that cv2 carries."""
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                                  "opencv_python.libs", "libswscale-*.so*"))
    assert libs, "cv2 carries no libswscale"
    lib = ctypes.CDLL(libs[0])
    lib.sws_getContext.restype = ctypes.c_void_p
    lib.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    lib.sws_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.sws_freeContext.argtypes = [ctypes.c_void_p]
    h, w = y.shape
    planes = [np.ascontiguousarray(p) for p in (y, cb, cr)]
    out = np.zeros((h, w, 3), np.uint8)
    ctx = lib.sws_getContext(w, h, 0, w, h, 3, 4, None, None, None)   # YUV420P, BGR24, BICUBIC
    assert ctx
    try:
        lib.sws_scale(ctx, (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None),
                      (ctypes.c_int * 4)(w, w // 2, w // 2, 0), 0, h,
                      (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None),
                      (ctypes.c_int * 4)(3 * w, 0, 0, 0))
    finally:
        lib.sws_freeContext(ctx)
    return out


def assert_decodes_to(path, rec):
    """The decoded luma, and the decoded BGR, equal the reconstruction's."""
    got, count, _ = decode(path)
    assert len(got) == count == len(rec[0])
    for k, g in enumerate(got):
        np.testing.assert_array_equal(np.asarray(g).reshape(rec[0][k].shape), rec[0][k],
                                      err_msg=f"luma of frame {k}")
    got, _, _ = decode(path, rgb=True)
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g[..., ::-1], swscale_bgr(rec[0][k], rec[1][k], rec[2][k]),
                                      err_msg=f"BGR of frame {k}")


def psnr(a, b):
    err = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * math.log10(255.0 ** 2 / err)


def frame_set(kind, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = lambda a: [(np.stack([4 * a, 255 - 3 * a, 2 * a + 40], -1) % 256).astype(np.uint8),
                      np.repeat((3 * a % 256).astype(np.uint8)[..., None], 3, -1)]
    if kind == "flat":
        return [np.full((h, w, 3), v, np.uint8) for v in (0, 128, 255)]
    if kind == "ramp_horizontal":          # each row a ramp: vertical prediction
        return ramp(xx)
    if kind == "ramp_vertical":            # horizontal prediction
        return ramp(yy)
    if kind == "ramp_diagonal":            # plane prediction
        return [(np.stack([2 * xx + yy, 3 * yy, xx + 2 * yy], -1) % 256).astype(np.uint8),
                np.stack([255 - xx - yy, 64 + xx, 200 - yy], -1).astype(np.uint8)]
    if kind == "noise":
        return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(3)]
    if kind == "binary_noise":
        return [(rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8) for _ in range(2)]
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["flat", "ramp_horizontal", "ramp_vertical", "ramp_diagonal",
                                  "noise", "binary_noise"])
def test_decode_is_the_reconstruction(tmp_path, kind):
    frames = frame_set(kind)
    path = tmp_path / "v.mp4"
    rec = mp4.write_mp4(str(path), frames, 15)
    assert_decodes_to(path, rec)


@pytest.mark.parametrize("qp", [0, 6, 12, 18, 36, 51])
def test_every_qp_decodes_to_the_reconstruction(tmp_path, qp):
    """Every branch of the scaling (qP / 6 against 4 and 6), the nC >= 8
    table, the I_PCM escapes and the emulation prevention bytes: binary
    noise at QP 0 costs more than its samples in every macroblock; a flat
    255 frame's first luma DC level needs a level_prefix past Baseline's 15;
    the seeded noise at QP 12 puts 00 00 03 into its slices."""
    frames = (frame_set("noise", 64, 64) + frame_set("binary_noise", 64, 64)
              + frame_set("ramp_diagonal", 64, 64) + [np.full((64, 64, 3), 255, np.uint8)])
    sps, pps, slices, rec, pcm = mp4.encode_h264(frames, 15, qp=qp)
    path = tmp_path / "q.mp4"
    path.write_bytes(mp4.mux_mp4(sps, pps, slices, 15))
    assert_decodes_to(path, rec)
    if qp == 0:
        assert pcm[3:5].tolist() == [16, 16] and pcm[-1] == 1, pcm
    if qp == 12:
        assert any(b"\x00\x00\x03" in s for s in slices)
    if qp >= 18:
        assert not pcm.any(), pcm


@pytest.mark.parametrize("qp", range(52))
def test_each_qp_and_its_chroma_qp(tmp_path, qp):
    """Every QP's scaling (QP % 6 and QP / 6) and its chroma QP (Table
    8-15 from QP 30 on) on ramps and noise."""
    frames = frame_set("ramp_diagonal", 32, 32) + frame_set("noise", 32, 32)[:1]
    sps, pps, slices, rec, _ = mp4.encode_h264(frames, 15, qp=qp)
    path = tmp_path / "q.mp4"
    path.write_bytes(mp4.mux_mp4(sps, pps, slices, 15))
    assert_decodes_to(path, rec)


def test_container_reads_back(tmp_path):
    frames = frame_set("ramp_diagonal", 32, 48) * 3
    path = tmp_path / "c.mp4"
    mp4.write_mp4(str(path), frames, 12)
    got, count, fps = decode(path)
    assert len(got) == count == 6 and fps == 12.0
    info = mp4.read_mp4(str(path))
    assert info["brand"] == b"isom" and not info["mdat_before_moov"]
    assert len(info["sample_sizes"]) == 6 and info["nal_types"] == [[5]] * 6
    assert info["durations"] == [info["timescale"] // 12] * 6
    assert (info["width"], info["height"]) == info["track_size"] == (48, 32)
    assert info["profile_idc"] == 66 and info["level_idc"] == 10
    assert sum(info["sample_sizes"]) < path.stat().st_size


@pytest.mark.parametrize("size, fps, rate, level", [
    ((64, 64), 15, 5e4, 10), ((64, 64), 15, 1e5, 11), ((512, 512), 15, 1e6, 22),
    ((512, 512), 15, 6e6, 30),
    ((1920, 1088), 30, 1e7, 40), ((1920, 1088), 30, 4e7, 41)])
def test_level_by_table_a1(size, fps, rate, level):
    sizes = np.full(30, int(rate / 8 / fps))
    assert mp4.level_idc(*size, fps, sizes) == level


@pytest.mark.parametrize("rgb, yuv", [((255, 255, 255), (235, 128, 128)),
                                      ((0, 0, 0), (16, 128, 128)),
                                      ((255, 0, 0), (81, 90, 240)),
                                      ((0, 255, 0), (145, 54, 34)),
                                      ((0, 0, 255), (41, 240, 110))])
def test_bt601_limited_range(rgb, yuv):
    """The primaries' 8-bit BT.601 codes; back to RGB within one level (the
    codes are rounded)."""
    planes = mp4.rgb_to_yuv420p(np.tile(np.array(rgb, np.uint8), (4, 4, 1)))
    assert [int(p[0, 0]) for p in planes] == list(yuv)
    back = mp4.yuv420p_to_rgb(*planes)
    assert back.shape == (4, 4, 3) and np.abs(back.astype(int) - rgb).max() <= 1


def test_flat_colour_decodes_within_four_levels(tmp_path):
    path = tmp_path / "flat.mp4"
    mp4.write_mp4(str(path), [np.tile(np.array([200, 40, 90], np.uint8), (32, 32, 1))] * 2, 15)
    got, _, _ = decode(path, rgb=True)
    assert len(got) == 2
    for g in got:
        assert np.abs(g.astype(int) - [200, 40, 90]).max() <= 4, g[0, 0]


@pytest.fixture(scope="module")
def turntable(tmp_path_factory):
    """``cli.render`` of the apps tests' textured sphere to an MP4, and the
    same frames rendered apart."""
    d = tmp_path_factory.mktemp("mp4")
    obj = write_sphere_obj(d / "sphere.obj")
    n, size = TURNTABLE
    out = trender.main([obj, "--num_frames", str(n), "--size", str(size), "--out",
                        str(d / "t.mp4"), "--device", "cpu"])
    frames = trender.render_mesh_frames(obj, n, size, 0.0, 2.0, FOV, device="cpu")
    return out, [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]


def test_turntable_through_the_cli(turntable, capsys):
    path, frames = turntable
    assert path.endswith("t.mp4") and "[WARN]" not in capsys.readouterr().out
    data, rec = mp4.encode_mp4(frames, 15)
    with open(path, "rb") as f:
        assert f.read() == data
    assert_decodes_to(path, rec)
    got, count, fps = decode(path, rgb=True)
    assert count == len(frames) and fps == 15.0
    for k, (g, f) in enumerate(zip(got, frames)):
        assert f.std() > 10, k
        assert psnr(g, f) >= 30.0, (k, psnr(g, f))
    raw = len(frames) * frames[0].shape[0] * frames[0].shape[1] * 3 // 2
    assert len(data) < raw / 4, (len(data), raw)
    info = mp4.read_mp4(path)
    assert (info["width"], info["height"]) == (TURNTABLE[1],) * 2
    assert len(info["sample_sizes"]) == TURNTABLE[0]


@pytest.mark.parametrize("w, h", [(8, 12), (100, 100), (40, 16)])
def test_sizes_scale_up_to_macroblocks(tmp_path, capsys, w, h):
    frames = [np.full((h, w, 3), v, np.float32) for v in (0.2, 0.6)]
    out = trender.save_frames(frames, str(tmp_path / "s.mp4"))
    up = (-(-w // 16) * 16, -(-h // 16) * 16)
    assert IMAGEIO_WARNING.format((w, h), up) in capsys.readouterr().err
    info = mp4.read_mp4(out)
    assert (info["width"], info["height"]) == up and len(info["sample_sizes"]) == 2
    got, _, _ = decode(out)
    assert [np.asarray(g).reshape(up[1], up[0]).shape for g in got] == [up[::-1]] * 2


def test_no_warning_at_multiples_of_16(tmp_path, capsys):
    trender.save_frames([np.full((32, 48, 3), 0.5, np.float32)], str(tmp_path / "m.mp4"))
    assert "IMAGEIO" not in capsys.readouterr().err


def test_no_gif_in_the_mp4s_place(tmp_path, monkeypatch, capsys):
    def no_library():
        raise RuntimeError("building h264_intra.cpp failed")

    monkeypatch.setattr(native, "h264_intra", no_library)
    frames = [np.full((16, 16, 3), 0.5, np.float32)]
    with pytest.raises(RuntimeError, match="h264_intra"):
        trender.save_frames(frames, str(tmp_path / "v.mp4"))
    assert sorted(p.name for p in tmp_path.iterdir()) == []
    assert "[WARN]" not in capsys.readouterr().out


def test_encoder_refuses_bad_input():
    with pytest.raises(ValueError, match="one size"):
        mp4.encode_mp4([np.zeros((16, 16, 3), np.uint8), np.zeros((32, 16, 3), np.uint8)], 15)
    with pytest.raises(ValueError, match="uint8"):
        mp4.encode_mp4([np.zeros((16, 16, 3), np.float32)], 15)
    with pytest.raises(RuntimeError, match="QP"):
        mp4.encode_h264([np.zeros((16, 16, 3), np.uint8)], 15, qp=52)
