"""The port's JPEG decoder (``utils/jpeg.py`` with ``csrc/image_tools.cpp``)
against ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` (libjpeg-turbo), and
``cli.process.read_image``'s choice of decoder by content.

Tolerance: every decode equal to cv2's bit for bit (channels in RGB order),
on cv2's and Pillow's files and on the checked-in fixtures of
``scripts/port_make_jpeg_fixtures.py``. ``load_rgba`` of a JPEG against the
JAX package's at ``test_torch_process.py``'s tolerances."""

import hashlib
import io
import json

import cv2
import numpy as np
import pytest
from PIL import Image

from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.utils.jpeg import decode_jpeg
from dreamgaussian_tpu_torch.utils.png import write_png
from test_torch_process import _photo, u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import JPEG_FIXTURES

Q, PROG, OPT, RST, SF = (cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_PROGRESSIVE,
                         cv2.IMWRITE_JPEG_OPTIMIZE, cv2.IMWRITE_JPEG_RST_INTERVAL,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR)
CV2_VARIANTS = {
    "q50": [Q, 50], "q95": [Q, 95], "progressive": [PROG, 1], "optimized": [OPT, 1],
    "restart": [RST, 3],
    "s444": [SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "s422": [SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "s420": [SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    "s440": [SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "s411": [SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
    "progressive_s440_restart": [PROG, 1, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, RST, 2],
    "optimized_s411_q30": [OPT, 1, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, Q, 30],
}
SIZES = [(1, 1), (17, 33), (255, 129)]


def _image(h, w, seed):
    """uint8 [h, w, 3] with detail at every scale: waves, edges, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / (3.0 + c) + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    img[(xx // 7 + yy // 5) % 3 == 0] = (250, 20, 90)
    return np.clip(img + rng.normal(0, 15, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_decode(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _cv2_jpeg(img, flags=()) -> bytes:
    bgr = img if img.ndim == 2 else img[..., ::-1]
    return cv2.imencode(".jpg", np.ascontiguousarray(bgr), list(flags))[1].tobytes()


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _same_as_cv2(data: bytes):
    got, want = decode_jpeg(data), _cv2_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", list(CV2_VARIANTS))
def test_cv2_jpegs_decode_bit_for_bit(variant, size):
    _same_as_cv2(_cv2_jpeg(_image(*size, seed=size[0] * size[1]), CV2_VARIANTS[variant]))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("flags", [[], [PROG, 1], [RST, 1]], ids=["baseline", "progressive",
                                                                 "restart"])
def test_grey_jpegs_decode_bit_for_bit(flags, size):
    _same_as_cv2(_cv2_jpeg(_image(*size, seed=5)[..., 1], flags))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_cmyk_jpeg_decodes_as_cv2_turns_it_into_bgr(size):
    data = _pil_jpeg(Image.fromarray(_image(*size, seed=3)).convert("CMYK"), quality=90)
    assert decode_jpeg(data).shape == size + (3,)
    _same_as_cv2(data)


def test_pillow_jpegs_with_exif_orientation_and_progressive_subsampling():
    """The EXIF orientation tag is ignored, as IMREAD_UNCHANGED ignores it."""
    img = Image.fromarray(_image(40, 70, seed=4))
    exif = Image.Exif()
    exif[0x0112] = 6                                   # rotate 90 degrees clockwise
    data = _pil_jpeg(img, quality=85, exif=exif.tobytes())
    assert decode_jpeg(data).shape == (40, 70, 3)
    _same_as_cv2(data)
    _same_as_cv2(_pil_jpeg(img, quality=70, progressive=True, subsampling=1))


FIXTURE_DIGESTS = json.loads((JPEG_FIXTURES / "decodes.json").read_text())


@pytest.mark.parametrize("name", sorted(FIXTURE_DIGESTS))
def test_checked_in_fixtures_decode_as_cv2_decoded_them(name):
    data = (JPEG_FIXTURES / name).read_bytes()
    got = decode_jpeg(data)
    want = FIXTURE_DIGESTS[name]
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    npy = JPEG_FIXTURES / name.replace(".jpg", ".npy")
    if npy.exists():
        np.testing.assert_array_equal(got, np.load(npy))
    np.testing.assert_array_equal(got, _cv2_decode(data))


def test_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in JPEG_FIXTURES.iterdir()) < 1 << 20


@pytest.mark.parametrize("marker,what", [(0xC3, "lossless"), (0xC9, "arithmetic-coded"),
                                         (0xCA, "arithmetic-coded"), (0xC5, "hierarchical")])
def test_unsupported_jpeg_processes_are_refused(marker, what):
    data = bytearray(_cv2_jpeg(_image(16, 16, seed=1)))
    sof = bytes(data).index(b"\xff\xc0")
    data[sof + 1] = marker
    with pytest.raises(NotImplementedError, match=what):
        decode_jpeg(bytes(data))


def test_twelve_bit_samples_are_refused():
    data = bytearray(_cv2_jpeg(_image(16, 16, seed=1)))
    sof = bytes(data).index(b"\xff\xc0")
    data[sof + 4] = 12                                 # the frame's sample precision
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(bytes(data))


@pytest.mark.parametrize("ext,name", [(".hdr", "Radiance HDR"), (".jp2", "JPEG 2000"),
                                      (".ras", "Sun raster")])
def test_other_formats_cv2_writes_are_refused_by_name(tmp_path, ext, name):
    """Formats cv2 writes and reads that the port does not read (WebP, BMP,
    TIFF and JPEG 2000, once here, are read now: test_torch_image_formats.py,
    test_torch_tiff.py, test_torch_jp2.py; cv2's JPEG 2000, whose Part 1 is
    read in full, is refused here with SIZ's Rsiz claiming Part 2
    extensions, which cv2 reads and the port refuses by name)."""
    import torch_image_files as F

    path = tmp_path / f"x{ext}"
    assert cv2.imwrite(str(path), _image(64, 64, seed=2))
    if ext == ".jp2":
        data = path.read_bytes()
        cs = F.j2k_set_rsiz(F.jp2_codestream(data), 0x8000)
        path.write_bytes(F.jp2_rebuild(data, codestream=cs))
    path = str(path)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None
    with pytest.raises(NotImplementedError, match=name):
        tproc.read_image(path)
    with pytest.raises(NotImplementedError, match=name):
        tproc.load_rgba(path, device="cpu")


def test_unrecognised_and_missing_files_raise_file_not_found(tmp_path):
    garbage = tmp_path / "x.jpg"
    garbage.write_bytes(b"\x00\x01 this is no image" * 4)
    for path in (garbage, tmp_path / "none.png"):
        with pytest.raises(FileNotFoundError):
            tproc.read_image(str(path))
        with pytest.raises(FileNotFoundError):
            jproc.load_rgba(str(path))


def test_decoder_follows_content_not_the_name(tmp_path):
    rgba = np.random.default_rng(3).integers(0, 256, (12, 10, 4), dtype=np.uint8)
    png_named_jpg = str(tmp_path / "x.jpg")
    write_png(png_named_jpg, rgba)
    np.testing.assert_array_equal(tproc.read_image(png_named_jpg), rgba)
    jpeg_named_png = tmp_path / "y.png"
    data = _cv2_jpeg(_image(12, 10, seed=6))
    jpeg_named_png.write_bytes(data)
    np.testing.assert_array_equal(tproc.read_image(str(jpeg_named_png)), _cv2_decode(data))


@pytest.mark.parametrize("grey", [False, True])
def test_load_rgba_of_a_jpeg_matches_jax(tmp_path, u2net_files, grey):  # noqa: F811
    rgb = _photo(150, 110, 7)
    path = str(tmp_path / "photo.jpg")
    cv2.imwrite(path, rgb[..., 0] if grey else np.ascontiguousarray(rgb[..., ::-1]))
    ref = jproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.shape == (64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)
