"""The port's Radiance HDR, PFM and Sun raster readers (``utils/hdr.py``
with ``dg_hdr_decode`` of ``csrc/image_codecs.cpp``, ``utils/pfm.py``,
``utils/sunras.py``) against cv2 (OpenCV 5.0's ``HdrDecoder``,
``PFMDecoder`` and ``SunRasterDecoder``), the float32 INTER_AREA resize
against ``cv2.resize``, and what reads through them against the JAX
package: ``load_rgba`` and the textures of ``Mesh.load``.

Tolerance: every decode equal to cv2's bit for bit (dtype, shape, float32
bit patterns; channels in RGB order) under ``IMREAD_UNCHANGED`` and
``IMREAD_COLOR``, through ``cv2.imdecode`` and ``cv2.imread``, on the
checked-in fixtures of ``scripts/port_make_image_fixtures.py --set hdr``
(and their stored digests) and on files made here from numpy seeds; where
cv2 returns None or raises, the port raises ValueError naming the format.
Resizes equal bit for bit. ``load_rgba`` with U2Net: RGB equal exactly,
alpha within 1/255 (``test_torch_process.py``'s tolerance); through
GrabCut: alpha >= 128 IoU at least 0.98 (``test_torch_grabcut.py``'s);
``Mesh.load`` albedos equal exactly."""

import hashlib
import json
import struct

import cv2
import numpy as np
import pytest

import torch_image_files as F
from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu.meshing.mesh import Mesh as JMesh
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.meshing.mesh import Mesh as TMesh
from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, IMREAD_UNCHANGED, decode_image
from dreamgaussian_tpu_torch.utils.resize import resize_area
from test_torch_image_formats import _glb_with_image
from test_torch_process import u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import HDR_FIXTURES, iou

DIGESTS = json.loads((HDR_FIXTURES / "decodes.json").read_text())
FLAGS = {"unchanged": IMREAD_UNCHANGED, "color": IMREAD_COLOR}
FORMAT = {".hdr": "Radiance HDR", ".pfm": "PFM", ".ras": "Sun raster"}
IOU_MIN = 0.98


def _rgb(img):
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def _cv2_or_none(read):
    """cv2's decode, None where it returns None or raises (cv2.error)."""
    try:
        return _rgb(read())
    except cv2.error:
        return None


def _same_as_cv2(data: bytes, tmp_path, ext: str):
    """Under both flags, ``decode_image`` equals cv2.imdecode and
    ``read_image`` equals cv2.imread of the file (float32 bit patterns
    included), or both sides give none (the port: ValueError naming the
    format)."""
    path = tmp_path / f"x{ext}"
    path.write_bytes(data)
    for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
        for want, read in ((_cv2_or_none(lambda: cv2.imdecode(np.frombuffer(data, np.uint8), f)),
                            lambda: decode_image(data, f)),
                           (_cv2_or_none(lambda: cv2.imread(str(path), f)),
                            lambda: tproc.read_image(str(path), f))):
            if want is None:
                with pytest.raises(ValueError, match=FORMAT[ext]):
                    read()
                continue
            got = read()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _hdr_image(h, w, seed):
    """float32 [h, w, 3] spanning many RGBE exponents, with flat runs."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)) ** 3 * rng.choice([1e-3, 1.0, 50.0], (h, w, 1))
    img[:, : w // 2] = img[0, 0]
    img[h // 2] = 0
    return img.astype(np.float32)


def _cv2_hdr(img, rle=True):
    mode = cv2.IMWRITE_HDR_COMPRESSION_RLE if rle else cv2.IMWRITE_HDR_COMPRESSION_NONE
    return cv2.imencode(".hdr", np.ascontiguousarray(img[..., ::-1]),
                        [cv2.IMWRITE_HDR_COMPRESSION, mode])[1].tobytes()


# ------------------------------------------------------------------ fixtures

@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_reads_as_cv2_read_it(name, key):
    path = HDR_FIXTURES / name
    want = DIGESTS[name][key]
    live = _cv2_or_none(lambda: cv2.imread(str(path), FLAGS[key]))
    if want is None:
        assert live is None
        with pytest.raises(ValueError, match=FORMAT[path.suffix]):
            tproc.read_image(str(path), FLAGS[key])
        return
    got = tproc.read_image(str(path), FLAGS[key])
    assert [list(got.shape), str(got.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got.view(np.uint8), live.view(np.uint8))


# ------------------------------------------------------------------ Radiance HDR

@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
@pytest.mark.parametrize("w", [1, 7, 8, 9, 33, 130])
def test_hdr_written_by_cv2(tmp_path, w, rle):
    """RLE needs widths of 8 to 32767: narrower files are flat either way."""
    data = _cv2_hdr(_hdr_image(5, w, w), rle)
    _same_as_cv2(data, tmp_path, ".hdr")
    _same_as_cv2(data.replace(b"#?RADIANCE", b"#?RGBE", 1), tmp_path, ".hdr")


PIXELS = bytes([128, 64, 32, 129] * 6)
FMT = b"FORMAT=32-bit_rle_rgbe\n"
RES = b"-Y 2 +X 3\n"
HEADERS = {
    "radiance": b"#?RADIANCE\n" + FMT + b"\n" + RES,
    "rgbe": b"#?RGBE\n" + FMT + b"\n" + RES,
    "no magic line end": b"#?RADIANCEX\n" + FMT + b"\n" + RES,
    "no format": b"#?RADIANCE\n\n" + RES,
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n" + RES,
    "xyze then rgbe": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n" + FMT + b"\n" + RES,
    "comments and exposure": b"#?RADIANCE\n# a comment\nEXPOSURE=2.0\nGAMMA=2\n" + FMT + b"\n" + RES,
    "lines after format": b"#?RADIANCE\n" + FMT + b"EXPOSURE=2.0\n\n" + RES,
    "blank before format": b"#?RADIANCE\n\n" + FMT + b"\n" + RES,
    "two blank lines": b"#?RADIANCE\n" + FMT + b"\n\n" + RES,
    "nul line": b"#?RADIANCE\n\0abc\n" + FMT + b"\n" + RES,
    "nul before format": b"#?RADIANCE\n\0" + FMT + b"\n" + RES,
    "format trailing space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n" + RES,
    "crlf": b"#?RADIANCE\r\n" + FMT[:-1] + b"\r\n\r\n" + RES,
    "line of 126": b"#?RADIANCE" + b"x" * 116 + b"\n" + FMT + b"\n" + RES,
    "line of 127": b"#?RADIANCE" + b"x" * 117 + b"\n" + FMT + b"\n" + RES,
    "line of 210": b"#?RADIANCE" + b"x" * 200 + b"\n" + FMT + b"\n" + RES,
    "+Y": b"#?RADIANCE\n" + FMT + b"\n+Y 2 +X 3\n",
    "-X": b"#?RADIANCE\n" + FMT + b"\n-Y 2 -X 3\n",
    "column major": b"#?RADIANCE\n" + FMT + b"\n+X 3 +Y 2\n",
    "no spaces": b"#?RADIANCE\n" + FMT + b"\n-Y2+X3\n",
    "tabs and signs": b"#?RADIANCE\n" + FMT + b"\n-Y\t+2\t+X\t3\n",
    "leading space": b"#?RADIANCE\n" + FMT + b"\n -Y 2 +X 3\n",
    "trailing words": b"#?RADIANCE\n" + FMT + b"\n-Y 2 +X 3 tail\n",
    "zero height": b"#?RADIANCE\n" + FMT + b"\n-Y 0 +X 3\n",
    "negative width": b"#?RADIANCE\n" + FMT + b"\n-Y 2 +X -3\n",
    "long resolution line": b"#?RADIANCE\n" + FMT + b"\n-Y 2 +X 3" + b" " * 130 + b"\n",
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_hdr_headers_read_as_cv2_reads_them(tmp_path, case):
    """RGBE_ReadHeader without its info block: 127-byte fgets lines up to
    the first empty one, a FORMAT=32-bit_rle_rgbe line among them, then
    sscanf("-Y %d +X %d")."""
    _same_as_cv2(HEADERS[case] + PIXELS, tmp_path, ".hdr")


def _scanline(w, channels):
    """A new-style RLE scanline: 2, 2, the width, then each channel's codes."""
    return bytes([2, 2, w >> 8, w & 255]) + b"".join(channels)


def _literal(values):
    return bytes([len(values)]) + bytes(values)


RLE_ROWS = {
    "runs and literals": lambda w: [_scanline(w, [bytes([128 + w, c]) for c in (60, 70, 80, 129)])],
    "mixed codes": lambda w: [_scanline(w, [_literal(range(1, 4)) + bytes([128 + w - 3, 9])] * 4)],
    "run of zero": lambda w: [_scanline(w, [b"\x80\x05" + bytes([128 + w, 1])] + [bytes([128 + w, 1])] * 3)],
    "literal of zero": lambda w: [_scanline(w, [b"\x00" + bytes([128 + w, 1])] * 4)],
    "run past the channel": lambda w: [_scanline(w, [bytes([128 + w + 1, 7])] * 4)],
    "literal past the channel": lambda w: [_scanline(w, [_literal(range(w + 1))] * 4)],
    "wrong width": lambda w: [bytes([2, 2, 0, w - 1]) + bytes([128 + w - 1, 7]) * 4],
    "high bit width": lambda w: [bytes([2, 2, 0x80, w]) + bytes(4 * w)],
    "second row flat": lambda w: [_scanline(w, [bytes([128 + w, 99])] * 4),
                                  bytes(i % 256 for i in range(4 * w))],
    "cut in a literal": lambda w: [_scanline(w, [_literal(range(w))] * 3 + [_literal(range(w))[:-2]])],
    "cut in a run": lambda w: [_scanline(w, [bytes([128 + w, 3])] * 3 + [bytes([128 + w])])],
    "cut at a scanline": lambda w: [_scanline(w, [bytes([128 + w, 3])] * 4), b"\x02\x02"],
}


@pytest.mark.parametrize("w", [8, 12, 100])
@pytest.mark.parametrize("case", list(RLE_ROWS))
def test_hdr_rle_scanlines_read_as_cv2_reads_them(tmp_path, case, w):
    """RGBE_ReadPixels_RLE: runs of 129 to 255 and literals of 1 to 128
    per channel, a run or literal of 0 or past the channel a format error,
    a scanline of another width an error, a first pair other than 2, 2 (or
    a width with its high bit) flat pixels for the rest of the file."""
    rows = RLE_ROWS[case](min(w, 127))
    width = min(w, 127)
    data = b"#?RADIANCE\n" + FMT + b"\n" + f"-Y {len(rows)} +X {width}\n".encode() + b"".join(rows)
    _same_as_cv2(data, tmp_path, ".hdr")


@pytest.mark.parametrize("cut", [1, 3, 4, 5, 17, 100])
@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
def test_cut_hdr_is_none_on_both_sides(tmp_path, rle, cut):
    _same_as_cv2(_cv2_hdr(_hdr_image(6, 40, cut), rle)[:-cut], tmp_path, ".hdr")


@pytest.mark.parametrize("w", [32767, 32768])
def test_hdr_at_the_rle_width_limit(tmp_path, w):
    """32768 pixels wide: no RLE, flat pixels; 32767: a flat first pixel
    pair falls back to flat."""
    rng = np.random.default_rng(w)
    data = (b"#?RADIANCE\n" + FMT + b"\n" + f"-Y 1 +X {w}\n".encode()
            + rng.integers(0, 256, 4 * w, dtype=np.uint8).tobytes())
    _same_as_cv2(data, tmp_path, ".hdr")


def test_hdr_exponents_and_the_colour_conversion(tmp_path):
    """Every exponent: mantissa x 2^(e - 136), 0 for e = 0; IMREAD_COLOR
    multiplies by 255 in float32 and rounds, a product past int32 giving 0."""
    px = [bytes([m, 255 - m, (3 * m) % 256, e]) for e in range(256) for m in (1, 128, 255)]
    data = b"#?RADIANCE\n" + FMT + b"\n" + f"-Y 1 +X {len(px)}\n".encode() + b"".join(px)
    _same_as_cv2(data, tmp_path, ".hdr")
    halves = [bytes([m, m + 1, m + 2, 128]) for m in range(0, 250, 3)]
    data = b"#?RADIANCE\n" + FMT + b"\n" + f"-Y 1 +X {len(halves)}\n".encode() + b"".join(halves)
    _same_as_cv2(data, tmp_path, ".hdr")


# ------------------------------------------------------------------ PFM

@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, 3.0, -1.0000000000000002, -7.25, 1e-30])
@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_byte_orders_scales_and_channels(tmp_path, channels, scale):
    """Negative scales little-endian, others big-endian; rows bottom-up;
    samples times 1/|scale| unless that is 1 (then -0.0, NaN and inf
    kept); IMREAD_COLOR unscaled, rounded and saturated, a grey file one
    channel through cv2.imdecode and None through cv2.imread."""
    rng = np.random.default_rng(channels)
    img = (rng.standard_normal((4, 5, channels)) * 300).astype(np.float32)
    img[0, 0], img[0, 1], img[1, 1], img[1, 2], img[2, 2] = -0.0, np.inf, 2.5, 3.5, -2e9
    img[3, 4] = np.nan
    data = (b"PF\n" if channels == 3 else b"Pf\n") + f"5 4\n{scale!r}\n".encode() \
        + img[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()
    _same_as_cv2(data, tmp_path, ".pfm")


PFM_HEADERS = {
    "space separated": b"Pf\n2 1 -1\n",
    "two spaces": b"Pf\n2  1\n-1\n",
    "leading space": b"Pf\n 2 1\n-1\n",
    "signed width": b"Pf\n+2 1\n-1\n",
    "width with junk": b"Pf\n2x 1\n-1\n",
    "tabs": b"Pf\n2\t1\t-1\n",
    "crlf": b"Pf\r\n2 1\r\n-1\r\n",
    "type then space": b"Pf 2 1\n-1\n",
    "zero width": b"Pf\n0 1\n-1\n",
    "negative width": b"Pf\n-2 1\n-1\n",
    "huge width": b"Pf\n3000000000 1\n-1\n",
    "scale 0": b"Pf\n2 1\n0\n",
    "scale -0": b"Pf\n2 1\n-0\n",
    "scale nan": b"Pf\n2 1\nnan\n",
    "scale -inf": b"Pf\n2 1\n-inf\n",
    "scale hex": b"Pf\n2 1\n-0x1.8p1\n",
    "scale exponent": b"Pf\n2 1\n-1e0\n",
    "scale bare point": b"Pf\n2 1\n-.5\n",
    "scale with a nul": b"Pf\n2 1\n-1\x002\n",
    "scale underflows": b"Pf\n2 1\n1e-400\n",
    "scale overflows": b"Pf\n2 1\n-1e400\n",
    "scale ends at a byte of 128": b"Pf\n2 1\n-1\x80",
}


@pytest.mark.parametrize("case", list(PFM_HEADERS))
def test_pfm_headers_read_as_cv2_reads_them(tmp_path, case):
    """Each number up to the next whitespace byte, by atoi and atof."""
    body = np.array([1.5, -2.25], "<f4").tobytes() + np.array([1.5, -2.25], ">f4").tobytes()
    _same_as_cv2(PFM_HEADERS[case] + body, tmp_path, ".pfm")


@pytest.mark.parametrize("cut", [1, 4, 30])
def test_cut_pfm_is_none_on_both_sides(tmp_path, cut):
    img = np.arange(60, dtype=np.float32).reshape(4, 5, 3)
    data = cv2.imencode(".pfm", img)[1].tobytes()
    _same_as_cv2(data[:-cut], tmp_path, ".pfm")


def test_grey_pfm_under_imread_color_differs_by_route(tmp_path):
    """cv2.imdecode gives a one-channel PFM one channel of uint8 under
    IMREAD_COLOR; cv2.imread returns None, its check that the decoder
    filled the 3-channel matrix failing. The port follows each."""
    data = (HDR_FIXTURES / "pfm_grey.pfm").read_bytes()
    assert cv2.imread(str(HDR_FIXTURES / "pfm_grey.pfm"), cv2.IMREAD_COLOR) is None
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = decode_image(data, IMREAD_COLOR)
    assert want.shape == got.shape == (61, 83) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="PFM"):
        tproc.read_image(str(HDR_FIXTURES / "pfm_grey.pfm"), IMREAD_COLOR)


# ------------------------------------------------------------------ Sun raster

def _ras(w, h, depth, kind, rows, maptype=0, cmap=b""):
    pad = np.pad(rows, ((0, 0), (0, rows.shape[1] & 1))).tobytes()
    return struct.pack(">8I", 0x59A66A95, w & 0xFFFFFFFF, h, depth, len(pad), kind, maptype,
                       len(cmap)) + cmap + pad


def _ras_cases(w, seed):
    h = 3
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (h, w), dtype=np.uint8)
    bits = np.packbits(rng.integers(0, 2, (h, w), dtype=np.uint8), axis=1)
    pal = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    ramp = bytes(range(256)) * 3
    return {
        "8 no map": (8, g, 0, b""), "8 grey map": (8, g, 1, ramp), "8 colour map": (8, g, 1, pal),
        "8 short map": (8, g, 1, pal[:31]), "8 raw map": (8, g, 2, pal),
        "8 map type without map": (8, g, 1, b""), "8 map without map type": (8, g, 0, pal),
        "1 no map": (1, bits, 0, b""), "1 colour map": (1, bits, 1, pal[:6]),
        "1 grey map": (1, bits, 1, bytes([7, 99]) * 3), "1 map of 5": (1, bits, 1, pal[:5]),
        "1 map of 7": (1, bits, 1, pal[:7]),
        "24": (24, rng.integers(0, 256, (h, 3 * w), dtype=np.uint8), 0, b""),
        "24 with a map": (24, rng.integers(0, 256, (h, 3 * w), dtype=np.uint8), 1, pal[:3]),
        "32": (32, rng.integers(0, 256, (h, 4 * w), dtype=np.uint8), 0, b""),
        "16": (16, rng.integers(0, 256, (h, 2 * w), dtype=np.uint8), 0, b""),
        "4": (4, g, 0, b""),
    }


@pytest.mark.parametrize("w", [1, 2, 5, 13])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 5])
def test_sun_raster_types_depths_and_colormaps(tmp_path, kind, w):
    """RT_OLD and RT_STANDARD at depths 1, 8, 24 and 32 with no colormap or
    an RMT_EQUAL_RGB one, rows padded to 16 bits; cv2 refuses the rest,
    RT_BYTE_ENCODED (2) and RT_FORMAT_RGB (3) among them."""
    for name, (depth, rows, maptype, cmap) in _ras_cases(w, 10 * kind + w).items():
        _same_as_cv2(_ras(w, 3, depth, kind, rows, maptype, cmap), tmp_path, ".ras")


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
def test_sun_raster_byte_encoded_is_none_on_both_sides(tmp_path, depth):
    """A well-formed RT_BYTE_ENCODED file (0x80 escapes for runs and for
    literal 0x80 bytes): cv2's header check compares the type with its
    matrix type, so it returns None for every such file."""
    w, h = 11, 4
    rows = np.full((h, ((w * depth + 7) // 8 + 1) & -2), 0x80, np.uint8)
    rows[:, ::3] = 7
    data = F.sunras(w, h, depth, 1, rows)
    encoded = data[:20] + struct.pack(">I", 2) + data[24:32] + F.sunras_rle(data[32:])
    assert cv2.imdecode(np.frombuffer(data, np.uint8), -1) is not None
    _same_as_cv2(encoded, tmp_path, ".ras")


@pytest.mark.parametrize("cut", [1, 2, 40])
@pytest.mark.parametrize("depth", [8, 24])
def test_cut_sun_raster_is_none_on_both_sides(tmp_path, depth, cut):
    img = np.random.default_rng(cut).integers(0, 256, (6, 9) + ((3,) if depth == 24 else ()),
                                              dtype=np.uint8)
    data = cv2.imencode(".ras", img)[1].tobytes()
    _same_as_cv2(data[:-cut], tmp_path, ".ras")


# ------------------------------------------------------------------ float resize

@pytest.mark.parametrize("shape", [(64, 64, 3, 320, 320), (48, 40, 4, 37, 30), (50, 50, 4, 64, 64),
                                   (100, 90, 4, 51, 46), (33, 45, 4, 33, 45), (64, 64, 4, 32, 32),
                                   (66, 70, 1, 33, 35), (60, 60, 4, 20, 20), (60, 60, 3, 30, 20),
                                   (311, 257, 4, 205, 169), (7, 5, 4, 3, 2)])
def test_float_resize_area_equals_cv2(shape):
    """INTER_AREA on float32: bilinear-area enlarging, the integer-factor
    shrink (2x2 of 1 and 4 channels by OpenCV's vector order), the area
    table; the identity a copy (-0.0 kept)."""
    H, W, C, h, w = shape
    rng = np.random.default_rng(H * W + C)
    img = (rng.random((H, W, C)) * rng.choice([1.0, 300.0])).astype(np.float32)
    img[0, 0] = -0.0
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA).reshape(h, w, C)
    got = resize_area(img, h, w)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------------ load_rgba and Mesh.load

@pytest.mark.parametrize("size", [64, None])
@pytest.mark.parametrize("ext", [".hdr", ".pfm"])
def test_load_rgba_of_a_float_input_with_u2net_matches_jax(tmp_path, u2net_files, ext, size):  # noqa: F811
    """A float32 image matted by U2Net (normalised by its max), its uint8
    alpha stacked on the float colours, recentred and resized by INTER_AREA
    in float32, then divided by 255 whatever the range (the reference's
    fault, kept)."""
    from test_torch_process import _photo

    rgb = _photo(150, 110, 7).astype(np.float32) / 255 * np.float32(1.7)
    path = str(tmp_path / f"photo{ext}")
    cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]))
    ref = jproc.load_rgba(path, size=size, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=size, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)
    assert got[..., :3].max() < 0.01                  # the divide by 255 of a [0, 1.7] image


@pytest.mark.parametrize("name", ["hdr_rle.hdr", "pfm_rgb.pfm"])
def test_float_input_without_u2net_raises_on_both_sides(monkeypatch, name):
    """cv2.grabCut takes 8UC3 only: the JAX package raises cv2.error, the
    port ValueError naming the 8-bit input it needs."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    path = str(HDR_FIXTURES / name)
    with pytest.raises(cv2.error):
        jproc.load_rgba(path)
    with pytest.raises(ValueError, match="8-bit"):
        tproc.load_rgba(path, device="cpu")


@pytest.mark.parametrize("name", ["ras_rgb.ras", "ras_colormap.ras", "ras_grey.ras"])
def test_load_rgba_of_a_sun_raster_through_grabcut_matches_jax(monkeypatch, tmp_path, name):
    from torch_image_cases import scene

    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    img = scene("disc", 96, 128, seed=5)
    path = str(tmp_path / name)
    if name == "ras_grey.ras":           # 8-bit with a grey colormap: one channel
        ramp = np.arange(256, dtype=np.uint8).tobytes() * 3
        (tmp_path / name).write_bytes(F.sunras(128, 96, 8, 1, img[..., 1], ramp))
    elif name == "ras_colormap.ras":
        idx = img[..., 1] // 2
        ramp = np.arange(128)
        cmap = np.concatenate([ramp * 2, 255 - ramp, ramp]).astype(np.uint8).tobytes()
        (tmp_path / name).write_bytes(F.sunras(128, 96, 8, 1, idx, cmap))
    if name == "ras_rgb.ras":
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
    cv2.setRNGSeed(0)
    ref = jproc.load_rgba(path, size=64)
    got = tproc.load_rgba(path, size=64, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (64, 64, 4)
    assert iou((got[..., 3] * 255).astype(np.uint8), (ref[..., 3] * 255).astype(np.uint8)) >= IOU_MIN


@pytest.mark.parametrize("tex", ["hdr_rle.hdr", "pfm_rgb_be.pfm", "ras_32bit.ras", "ras_1bit.ras"])
def test_textured_obj_matches_jax(tmp_path, tex):
    (tmp_path / tex).write_bytes((HDR_FIXTURES / tex).read_bytes())
    (tmp_path / "m.mtl").write_text(f"newmtl m\nmap_Kd {tex}\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    ref = JMesh.load(str(tmp_path / "m.obj"), resize=False).albedo
    got = TMesh.load(str(tmp_path / "m.obj"), resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)


def test_hdr_sphere_matches_jax():
    path = str(HDR_FIXTURES / "sphere_hdr.obj")
    ref = JMesh.load(path, resize=False)
    got = TMesh.load(path, resize=False)
    assert ref.albedo is not None and got.albedo.shape == ref.albedo.shape == (128, 128, 3)
    np.testing.assert_array_equal(got.albedo, ref.albedo)
    np.testing.assert_array_equal(np.asarray(got.v), np.asarray(ref.v))


@pytest.mark.parametrize("tex", ["hdr_flat.hdr", "pfm_rgb.pfm", "ras_colormap.ras"])
def test_glb_with_an_hdr_pfm_or_sun_raster_image_matches_jax(tmp_path, tex):
    path = _glb_with_image(tmp_path, (HDR_FIXTURES / tex).read_bytes())
    ref = JMesh.load(path, resize=False).albedo
    got = TMesh.load(path, resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)


def test_grey_pfm_texture_as_the_jax_loader_takes_it(tmp_path):
    """A one-channel PFM: cv2.imread returns None for an OBJ's texture under
    IMREAD_COLOR, and the JAX loader's cvtColor raises, as the port does;
    cv2.imdecode gives a GLB's one channel, which OpenCV 5's
    cvtColor(BGR2RGB) repeats to three: the albedos are equal."""
    tex = (HDR_FIXTURES / "pfm_grey.pfm").read_bytes()
    (tmp_path / "g.pfm").write_bytes(tex)
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd g.pfm\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    with pytest.raises(cv2.error):
        JMesh.load(str(tmp_path / "m.obj"), resize=False)
    with pytest.raises(ValueError, match="PFM"):
        TMesh.load(str(tmp_path / "m.obj"), resize=False)
    glb = _glb_with_image(tmp_path, tex)
    ref = JMesh.load(glb, resize=False).albedo
    got = TMesh.load(glb, resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)
