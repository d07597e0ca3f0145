"""The port's JPEG decoder (``utils/jpeg.py`` with ``csrc/image_tools.cpp``)
against ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` (libjpeg-turbo), and
``cli.process.read_image``'s choice of decoder by content.

Tolerance: every decode equal to cv2's bit for bit (channels in RGB order),
on cv2's and Pillow's files, on files cut off at every few bytes and on
files with broken restart intervals (each held against ``cv2.imread`` of
the file: ``cv2.imdecode`` reads a cut-off file otherwise), and on the
checked-in fixtures of ``scripts/port_make_jpeg_fixtures.py`` under both
flags; cv2's None is the port's ValueError. ``load_rgba`` of a JPEG, whole
or cut off, against the JAX package's at ``test_torch_process.py``'s
tolerances."""

import hashlib
import io
import json

import cv2
import numpy as np
import pytest
from PIL import Image

from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, decode_image, read_image
from dreamgaussian_tpu_torch.utils.jpeg import decode_jpeg
from dreamgaussian_tpu_torch.utils.png import write_png
from test_torch_process import _photo, u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import JPEG_FIXTURES, iou, scene

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


def _cv2_read(path, flags=cv2.IMREAD_UNCHANGED):
    img = cv2.imread(str(path), flags)
    return img if img is None or img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


@pytest.mark.parametrize("name", sorted(FIXTURE_DIGESTS))
def test_checked_in_fixtures_decode_as_cv2_decoded_them(name):
    """Against the stored digest and array, and cv2.imread of the file."""
    data = (JPEG_FIXTURES / name).read_bytes()
    want = FIXTURE_DIGESTS[name]
    if want["shape"] is None:                  # cv2's None: no scan before the cut
        assert _cv2_read(JPEG_FIXTURES / name) is None
        with pytest.raises(ValueError):
            decode_jpeg(data)
        return
    got = decode_jpeg(data)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    npy = JPEG_FIXTURES / name.replace(".jpg", ".npy")
    if npy.exists():
        np.testing.assert_array_equal(got, np.load(npy))
    np.testing.assert_array_equal(got, _cv2_read(JPEG_FIXTURES / name))


@pytest.mark.parametrize("name", sorted(FIXTURE_DIGESTS))
def test_checked_in_fixtures_read_in_colour_as_cv2_reads_them(name):
    """read_image under IMREAD_COLOR against the stored digest and cv2."""
    path = JPEG_FIXTURES / name
    want = FIXTURE_DIGESTS[name]["color"]
    if want is None:
        assert _cv2_read(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError):
            read_image(str(path), IMREAD_COLOR)
        return
    got = read_image(str(path), IMREAD_COLOR)
    assert [list(got.shape), hashlib.sha256(got.tobytes()).hexdigest()] == [want["shape"],
                                                                            want["sha256"]]
    np.testing.assert_array_equal(got, _cv2_read(path, cv2.IMREAD_COLOR))


CUT_VARIANTS = {     # flags, image size; each file cut at every STRIDE-th byte
    "baseline": ([], (61, 83)),
    "progressive": ([PROG, 1], (61, 83)),
    "restart": ([RST, 2], (61, 83)),
    "progressive_restart": ([PROG, 1, RST, 3], (61, 83)),
    "progressive_s444": ([PROG, 1, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], (40, 24)),
    "progressive_s440": ([PROG, 1, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440], (17, 33)),
    # A last iMCU row of one block row: libjpeg-turbo's smoothing counts the
    # image's block rows with that row's count.
    "progressive_short_last_row": ([PROG, 1], (24, 40)),
    "progressive_q20": ([PROG, 1, Q, 20], (130, 77)),
}
STRIDE = 97


@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
@pytest.mark.parametrize("variant", list(CUT_VARIANTS))
def test_cut_off_jpegs_decode_as_cv2_imread_reads_them(tmp_path, variant, grey):
    """libjpeg-turbo's out-of-data rule (the MCU under way finishes on zero
    bits, later ones stay unset), its interblock smoothing of unrefined
    progressive coefficients, a cut inside a marker segment read on
    through the FF D9 pairs its source hands out, and its SIMD IDCT's
    saturation on the blocks zero bits decode to."""
    flags, size = CUT_VARIANTS[variant]
    img = _image(*size, seed=size[0] + size[1])
    data = _cv2_jpeg(img[..., 1] if grey else img, flags)
    path = tmp_path / "cut.jpg"
    for n in range(3, len(data), STRIDE):
        path.write_bytes(data[:n])
        want = _cv2_read(path)
        if want is None:
            with pytest.raises(ValueError):
                decode_jpeg(data[:n])
        else:
            np.testing.assert_array_equal(decode_jpeg(data[:n]), want, err_msg=f"cut at {n}")


def _markers(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


@pytest.mark.parametrize("flags", [[RST, 1], [RST, 2, PROG, 1]], ids=["baseline", "progressive"])
@pytest.mark.parametrize("damage", ["short", "dropped", "far", "earlier", "next"])
def test_damaged_restart_intervals_decode_as_cv2_reads_them(tmp_path, flags, damage):
    """An interval whose data runs out before its RSTn (the out-of-data
    flag, cleared at the marker), a missing RSTn, and one numbered three
    ahead, one behind or one ahead (jdmarker.c jpeg_resync_to_restart)."""
    data = _cv2_jpeg(_image(61, 83, seed=9), flags)
    path = tmp_path / "damaged.jpg"
    for k in (3, 7, 12):
        a, b = _markers(data)[k:k + 2]
        n = data[a + 1] - 0xD0
        renumber = {"far": 3, "earlier": -1, "next": 1}
        if damage == "short":
            bad = data[:a + 2 + (b - a) // 3] + data[b:]
        elif damage == "dropped":
            bad = data[:a] + data[a + 2:]
        else:
            bad = data[:a + 1] + bytes([0xD0 + ((n + renumber[damage]) & 7)]) + data[a + 2:]
        path.write_bytes(bad)
        np.testing.assert_array_equal(decode_jpeg(bad), _cv2_read(path), err_msg=f"RST {k}")


def test_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in JPEG_FIXTURES.iterdir()) < 1 << 20


@pytest.mark.parametrize("marker,what", [(0xC3, "lossless"), (0xC9, "arithmetic-coded"),
                                         (0xCA, "arithmetic-coded"), (0xC5, "hierarchical")])
def test_unsupported_jpeg_processes_are_refused(marker, what):
    """Once refused by the port, now answered as cv2 answers, under both
    flags: a Huffman file's frame header marked SOF9 or SOF10 decodes as
    cv2 decodes it (its data read by the QM decoder, bad arithmetic codes
    and all); where cv2 gives None (SOF3 with a baseline scan header, SOF5,
    SOF10 with a baseline one) the port raises ValueError naming the
    process. Baseline and progressive files."""
    for progressive in (False, True):
        data = bytearray(_cv2_jpeg(_image(16, 16, seed=1), [PROG, 1] if progressive else []))
        sof = bytes(data).index(b"\xff\xc2" if progressive else b"\xff\xc0")
        data[sof + 1] = marker
        for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            want = cv2.imdecode(np.frombuffer(bytes(data), np.uint8), flags)
            if want is None:
                with pytest.raises(ValueError, match=what):
                    decode_image(bytes(data), flags)
                continue
            np.testing.assert_array_equal(decode_image(bytes(data), flags), want[..., ::-1])
    if marker in (0xC9, 0xCA):                          # whole files: cv2 reads them
        assert want is not None


def test_twelve_bit_samples_are_refused():
    """cv2 reads 8-bit lossy samples (libjpeg-turbo's 8-bit interface): a
    12-bit SOF1 is its None under both flags, the port's ValueError."""
    data = bytearray(_cv2_jpeg(_image(16, 16, seed=1)))
    sof = bytes(data).index(b"\xff\xc0")
    data[sof + 1] = 0xC1
    data[sof + 4] = 12                                 # the frame's sample precision
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), flags) is None
        with pytest.raises(ValueError, match="12-bit"):
            decode_image(bytes(data), flags)


@pytest.mark.parametrize("ext,name", [(".hdr", "Radiance HDR"), (".jp2", "JPEG 2000"),
                                      (".ras", "Sun raster")])
def test_other_formats_cv2_writes_are_refused_by_name(tmp_path, monkeypatch, ext, name):
    """Formats cv2 writes and reads (WebP, BMP, TIFF and JPEG 2000, once
    here, are read now: test_torch_image_formats.py, test_torch_tiff.py,
    test_torch_jp2.py; cv2's JPEG 2000, whose Part 1 is read in full, is
    refused here with SIZ's Rsiz claiming Part 2 extensions, which cv2
    reads and the port refuses by name). Radiance HDR and Sun raster, once
    refused here too, read as cv2.imread reads them
    (test_torch_hdr_pfm_ras.py), and ``load_rgba`` of them goes as the JAX
    package's: the HDR's float colours refused by GrabCut on both sides,
    the Sun raster matted."""
    import torch_image_files as F

    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = tmp_path / f"x{ext}"
    # the Sun raster a scene GrabCut mattes (test_torch_grabcut.py's), in BGR
    assert cv2.imwrite(str(path), scene("disc", 64, 64, 2)[..., ::-1].copy() if ext == ".ras"
                       else _image(64, 64, seed=2))
    if ext == ".jp2":
        data = path.read_bytes()
        cs = F.j2k_set_rsiz(F.jp2_codestream(data), 0x8000)
        path.write_bytes(F.jp2_rebuild(data, codestream=cs))
    path = str(path)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None
    if ext == ".jp2":
        with pytest.raises(NotImplementedError, match=name):
            tproc.read_image(path)
        with pytest.raises(NotImplementedError, match=name):
            tproc.load_rgba(path, device="cpu")
        return
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        want = np.ascontiguousarray(cv2.imread(path, flags)[..., ::-1])
        got = tproc.read_image(path, flags)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if ext == ".ras":
        cv2.setRNGSeed(0)
        ref, got = jproc.load_rgba(path, size=32), tproc.load_rgba(path, size=32, device="cpu")
        assert got.shape == ref.shape == (32, 32, 4)
        assert iou((got[..., 3] * 255).astype(np.uint8), (ref[..., 3] * 255).astype(np.uint8)) >= 0.98
        return
    with pytest.raises(cv2.error):
        jproc.load_rgba(path)
    with pytest.raises(ValueError, match="8-bit"):
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


@pytest.mark.parametrize("cut", [0.4, 0.75])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_load_rgba_of_a_cut_off_jpeg_matches_jax(tmp_path, u2net_files, progressive,  # noqa: F811
                                                 cut):
    rgb = _photo(150, 110, 7)
    data = _cv2_jpeg(rgb, [PROG, 1] if progressive else [])
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as fh:
        fh.write(data[:int(len(data) * cut)])
    ref = jproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=64, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.shape == (64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


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
