"""The port's TIFF reader (``utils/tiff.py`` with the LZW, PackBits, CCITT
and predictor code of ``csrc/image_codecs.cpp``) against cv2 (OpenCV 5.0
with its libtiff 4.7), and what reads through it against the JAX package:
``load_rgba`` and the textures of ``Mesh.load``.

Tolerance: every decode equal to cv2's bit for bit (dtype, shape, values;
channels in RGB order) under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``, on
the checked-in fixtures of ``scripts/port_make_tiff_fixtures.py`` (and their
stored digests) and on files written here from numpy seeds; where cv2
returns None the port raises ValueError. ``load_rgba`` of a 4-channel TIFF
equal to the JAX package's exactly, of an RGB TIFF matted by the same random
U2Net at ``test_torch_image_formats.py``'s tolerances (RGB equal, alpha
within 1/255); ``Mesh.load`` albedos equal exactly."""

import hashlib
import io
import json

import cv2
import numpy as np
import pytest

import torch_image_files as F
from dreamgaussian_tpu.cli import process as jproc
from dreamgaussian_tpu.meshing.mesh import Mesh as JMesh
from dreamgaussian_tpu_torch.cli import process as tproc
from dreamgaussian_tpu_torch.meshing.mesh import Mesh as TMesh
from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, IMREAD_UNCHANGED, decode_image
from test_torch_image_formats import _glb_with_image, u2net_at_64  # noqa: F401
from test_torch_process import u2net_files  # noqa: F401
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_image_cases import TIFF_CODEC_FIXTURES, TIFF_FIXTURES

DIGESTS = json.loads((TIFF_FIXTURES / "decodes.json").read_text())
IMAGES = sorted(DIGESTS)
CODEC_DIGESTS = json.loads((TIFF_CODEC_FIXTURES / "decodes.json").read_text())
FLAGS = {"unchanged": IMREAD_UNCHANGED, "color": IMREAD_COLOR}


def _rgb(img):
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def _same_as_cv2(data: bytes, path=None):
    """Both flags: the port's decode equals cv2.imdecode's (with ``path``,
    also read_image against cv2.imread of that file), or both give none."""
    for f in (IMREAD_UNCHANGED, IMREAD_COLOR):
        cases = [(_rgb(cv2.imdecode(np.frombuffer(data, np.uint8), f)),
                  lambda: decode_image(data, f))]
        if path is not None:
            with open(path, "wb") as fh:
                fh.write(data)
            cases.append((_rgb(cv2.imread(str(path), f)), lambda: tproc.read_image(str(path), f)))
        for want, read in cases:
            if want is None:
                with pytest.raises(ValueError, match="TIFF"):
                    read()
                continue
            got = read()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fixtures

@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", IMAGES)
def test_fixture_reads_as_cv2_read_it(name, key):
    path = TIFF_FIXTURES / name
    want = DIGESTS[name][key]
    live = _rgb(cv2.imread(str(path), FLAGS[key]))
    if want is None:
        assert live is None
        with pytest.raises(ValueError, match="TIFF"):
            tproc.read_image(str(path), FLAGS[key])
        return
    got = tproc.read_image(str(path), FLAGS[key])
    assert [list(got.shape), str(got.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, live)
    if key == "unchanged":
        with np.load(TIFF_FIXTURES / "small_decodes.npz") as small:
            if name in small.files:
                np.testing.assert_array_equal(got, small[name])


def test_fixture_directory_stays_small():
    assert sum(f.stat().st_size for f in TIFF_FIXTURES.iterdir()) < 1.5 * 2**20


def test_cv2_rules_the_fixtures_pin():
    """The rules the fixtures pin, spelled out: unassociated alpha
    premultiplied, LA as one channel, CMYK with alpha 255, 16-bit grey by
    v >> 8 under IMREAD_COLOR, float32 kept, the orientation applied."""
    import sys

    sys.path.insert(0, str(TIFF_FIXTURES.parents[2] / "scripts"))
    from port_make_image_fixtures import toy_alpha
    from port_make_jpeg_fixtures import photo

    src = np.load(TIFF_FIXTURES / "small_decodes.npz")
    rgba = src["tiff_rgba_lzw.tif"].astype(np.int64)
    rgb = photo(61, 83, seed=1)
    raw = np.dstack([rgb, toy_alpha(61, 83)]).astype(np.int64)
    np.testing.assert_array_equal(rgba[..., 3], raw[..., 3])
    np.testing.assert_array_equal(rgba[..., :3], (raw[..., :3] * raw[..., 3:] + 127) // 255)
    assert src["tiff_grey_alpha.tif"].shape == (61, 83)
    assert (src["tiff_cmyk.tif"][..., 3] == 255).all()
    grey16 = tproc.read_image(str(TIFF_FIXTURES / "tiff_grey16.tif"))
    np.testing.assert_array_equal(tproc.read_image(str(TIFF_FIXTURES / "tiff_grey16.tif"),
                                                   IMREAD_COLOR)[..., 0], grey16 >> 8)
    assert tproc.read_image(str(TIFF_FIXTURES / "tiff_grey32f.tif")).dtype == np.float32
    np.testing.assert_array_equal(src["tiff_orient3.tif"], rgb[::-1, ::-1])


@pytest.mark.parametrize("flags", [IMREAD_UNCHANGED, IMREAD_COLOR])
@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_transposing_orientation_is_none_in_imread_and_turns_in_imdecode(tmp_path, orientation,
                                                                         flags):
    """OpenCV 5.0's imread returns None for a TIFF whose orientation swaps
    its sides, unless it is square (it checks that the decoder filled the
    matrix it was given); imdecode turns it. The port does each where each
    is called."""
    for h, w in ((5, 7), (8, 8)):
        img = F.photo(h, w, orientation)
        for bps in (8, 16):
            data = F.tiff(img.astype(np.uint16) * (257 if bps == 16 else 1), bps, 2,
                          tags={274: (3, orientation)})
            _same_as_cv2(data, tmp_path / "o.tif")
            assert decode_image(data, flags).shape[:2] == (w, h)


@pytest.mark.parametrize("key", list(FLAGS))
@pytest.mark.parametrize("name", sorted(CODEC_DIGESTS))
def test_codec_fixture_reads_as_cv2_read_it(name, key):
    """The codec set of ``port_make_tiff_fixtures.py --set codecs``: SGILog,
    SGILog24, LogL, tiled LogLuv, ThunderScan, NeXT, 10/12/14-bit."""
    path = TIFF_CODEC_FIXTURES / name
    want = CODEC_DIGESTS[name][key]
    live = _rgb(cv2.imread(str(path), FLAGS[key]))
    if want is None:
        assert live is None
        with pytest.raises(ValueError, match="TIFF"):
            tproc.read_image(str(path), FLAGS[key])
        return
    got = tproc.read_image(str(path), FLAGS[key])
    assert [list(got.shape), str(got.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got.view(np.uint8), live.view(np.uint8))


# ------------------------------------------------------------------ seeded files

TYPE_CASES = [(ph, bps, sf) for ph in (0, 1, 2, 3, 5, 6, 8)
              for bps, sf in ((1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (16, 1), (16, 2), (16, 3),
                              (32, 1), (32, 2), (32, 3), (64, 3))]


@pytest.mark.parametrize("ph,bps,sf", TYPE_CASES)
def test_photometric_depth_and_format_read_as_cv2_reads_them(ph, bps, sf):
    """Every photometric cv2 takes (MinIsWhite, MinIsBlack, RGB, palette,
    CMYK, YCbCr, CIELab) at every depth and sample format, with 1 to 5
    samples, both planar configurations and each ExtraSamples kind: cv2's
    dtype and channel rules, its RGBA route or its direct one, or None."""
    rng = np.random.default_rng(ph * 100 + bps + sf)
    for spp in (1, 2, 3, 4, 5):
        for planar in (1, 2):
            if planar == 2 and spp == 1:
                continue
            s = (rng.integers(0, 1 << bps, (6, 9, spp)) if bps < 8 else rng.random((6, 9, spp))
                 if sf == 3 else rng.integers(0, 1 << min(bps, 16), (6, 9, spp)))
            kw = {"colormap": rng.integers(0, 65536, (1 << bps, 3))} if ph == 3 and bps <= 16 else {}
            for extra in (None, [2], [1], [0]):
                if extra and spp < 2:
                    continue
                data = F.tiff(s, bps, ph, sample_format=sf, rows_per_strip=4, planar=planar,
                              extra_samples=extra, **kw)
                if planar == 2 and bps >= 16 and spp > 1 and _direct(ph, spp, bps, sf):
                    # cv2 reads the first plane as if interleaved and leaves
                    # the rest of its buffer unset: the port refuses it.
                    assert cv2.imdecode(np.frombuffer(data, np.uint8), -1) is not None
                    with pytest.raises(NotImplementedError, match="separate planes"):
                        decode_image(data, IMREAD_UNCHANGED)
                    continue
                _same_as_cv2(data)


def _direct(ph, spp, bps, sf):
    """Whether cv2 reads these samples as stored (its 16/32/64-bit route)."""
    return spp in (1, 3, 4) and ((bps == 16 and ph in (0, 1, 2) and sf != 3)
                                 or (bps in (32, 64) and ph in (0, 1, 2, 3)))


@pytest.mark.parametrize("orientation", range(0, 10))
def test_orientation_with_strips_and_tiles(orientation):
    """libtiff mirrors each tile it is asked for in place; OpenCV turns
    the whole: a tiled page mirrored by its orientation keeps that seam."""
    img = F.photo(37, 29, 3, channels=4)
    rng = np.random.default_rng(orientation)
    for bps, ph, spp in ((8, 2, 3), (8, 2, 4), (16, 2, 3), (8, 1, 1), (16, 1, 1), (32, 1, 1),
                         (1, 0, 1), (8, 3, 1)):
        s = img[..., :spp].astype(np.int64)
        s = s * 257 + 3 if bps == 16 else s.astype(np.float32) / 7 if bps == 32 else \
            s > 100 if bps == 1 else s
        kw = {"colormap": rng.integers(0, 65536, (256, 3))} if ph == 3 else {}
        for lay in ({"rows_per_strip": 5}, {"tile": (16, 16), "compression": 5},
                    {"tile": (32, 16), "compression": 8}):
            _same_as_cv2(F.tiff(s, bps, ph, sample_format=3 if bps == 32 else 1,
                                tags={274: (3, orientation)} if orientation else None,
                                extra_samples=[2] if spp == 4 else None, **kw, **lay))


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("predictor", [1, 2, 3])
def test_codecs_predictors_byte_orders_and_bigtiff(compression, predictor):
    """Each codec with each predictor, 8 to 64 bits, both byte orders,
    classic TIFF and BigTIFF, strips and tiles. A Predictor tag beside
    PackBits or no compression is one libtiff does not know, and ignores."""
    img = F.photo(37, 29, 3, channels=4)
    for bps, sf in ((8, 1), (16, 1), (32, 3), (64, 3), (32, 1), (16, 2)):
        if predictor == 3 and sf != 3:
            continue
        for be, big in ((False, False), (True, False), (False, True), (True, True)):
            for lay in ({"rows_per_strip": 7}, {"tile": (16, 32)}):
                for spp, ph in ((1, 1), (3, 2), (4, 2)):
                    if spp == 4 and bps == 64:
                        continue
                    s = img[..., :spp].astype(np.float64)
                    s = (s * 257 + 11 if bps == 16 else s * 1e6 if bps == 32 and sf == 1
                         else s / 3 if sf == 3 else s)
                    _same_as_cv2(F.tiff(s, bps, ph, sample_format=sf, compression=compression,
                                        predictor=predictor, big_endian=be, bigtiff=big,
                                        extra_samples=[2] if spp == 4 else None, **lay))


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (4, 1), (1, 2), (2, 4)])
def test_uncompressed_ycbcr_with_its_subsampling_and_references(sub):
    """Blocks of luma then Cb, Cr; libtiff's TIFFYCbCrtoRGB with the
    ReferenceBlackWhite and YCbCrCoefficients tags (2x4 has no put routine:
    None)."""
    img = F.photo(37, 29, 3)
    hs, vs = sub
    for rows in (4, 8, 37):
        for compression in (1, 5):
            for tags in ({}, {532: (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])},
                         {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
                         {529: (5, [2126, 10000, 7152, 10000, 722, 10000])}):
                if rows % vs:
                    continue
                chunks = F.ycbcr_chunks(img, hs, vs, rows,
                                        F.tiff_lzw if compression == 5 else (lambda b: b))
                _same_as_cv2(F.tiff(img, 8, 6, rows_per_strip=rows, compression=compression,
                                    chunks=chunks, tags={**tags, 530: (3, [hs, vs])}))


@pytest.mark.parametrize("bps", [1, 2, 4, 8])
def test_palettes_and_minis_white_and_black(bps):
    """Palettes through the 16-bit colormap or as 8-bit where no entry
    passes 255; grey at low depths through libtiff's maps, MinIsWhite
    inverted, FillOrder 2, strips and tiles."""
    rng = np.random.default_rng(bps)
    idx = rng.integers(0, 1 << bps, (37, 29))
    for cmap in (rng.integers(0, 65536, (1 << bps, 3)), rng.integers(0, 256, (1 << bps, 3))):
        for compression in (1, 5, 32773):
            _same_as_cv2(F.tiff(idx, bps, 3, colormap=cmap, rows_per_strip=6,
                                compression=compression))
    for ph in (0, 1):
        for fill in (1, 2):
            for compression in (1, 5, 8):
                _same_as_cv2(F.tiff(idx, bps, ph, rows_per_strip=5, fill_order=fill,
                                    compression=compression))
        _same_as_cv2(F.tiff(idx, bps, ph, tile=(16, 16), compression=5))


@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("planar", [1, 2])
def test_alpha_kinds_in_both_planar_configurations(bps, planar):
    """Grey and RGB with associated, unassociated and unspecified extra
    samples; libtiff's grey put routines step over an edge tile's unread
    columns by a count of pixels, where they should count bytes."""
    img = F.photo(37, 29, 3, channels=4)
    for spp, ph in ((2, 1), (2, 0), (4, 2), (3, 2)):
        s = img[..., [0, 3] if spp == 2 else slice(0, spp)].astype(np.int64) * (
            257 if bps == 16 else 1)
        for extra in (None, [0], [1], [2]):
            if spp == 3 and extra:
                continue
            for lay in ({"rows_per_strip": 5}, {"tile": (16, 16), "compression": 5}):
                data = F.tiff(s, bps, ph, planar=planar, extra_samples=extra, **lay)
                if planar == 2 and bps == 16 and _direct(ph, spp, bps, 1):
                    continue
                _same_as_cv2(data)


def test_cmyk_pages_gaps_and_uncompressed_tiles():
    rng = np.random.default_rng(5)
    cmyk = rng.integers(0, 256, (37, 29, 4))
    img = F.photo(37, 29, 3, channels=4)
    for planar in (1, 2):
        for compression in (1, 5):
            _same_as_cv2(F.tiff(cmyk, 8, 5, planar=planar, rows_per_strip=8,
                                compression=compression))
        _same_as_cv2(F.tiff(cmyk, 8, 5, planar=planar, rows_per_strip=8, tags={332: (3, 2)}))
        _same_as_cv2(F.tiff(np.dstack([cmyk, cmyk[..., :1]]), 8, 5, planar=planar,
                            rows_per_strip=8, extra_samples=[2]))
    _same_as_cv2(F.tiff(img[..., :3], 8, 2, pages=[{"samples": img[..., 1], "bps": 8,
                                                    "photometric": 1}]))
    _same_as_cv2(F.tiff(img[..., :3], 8, 2, rows_per_strip=3, gap=3, compression=5))
    # Uncompressed tiles through the RGBA route: libtiff 4.7 refuses one whose
    # byte count, rounded up to 1 KiB, is not the tile's size.
    for tile in ((16, 16), (32, 32), (16, 64)):
        for spp in (1, 3, 4):
            _same_as_cv2(F.tiff(img[..., :spp], 8, 1 if spp == 1 else 2, tile=tile))


@pytest.mark.parametrize("bps", [8, 12, 16])
@pytest.mark.parametrize("spp", [1, 3])
def test_single_uncompressed_strip_with_a_short_byte_count(tmp_path, bps, spp):
    """libtiff's TIFFReadDirectory calls the StripByteCounts of a single
    uncompressed strip bogus when it is short of the image
    (BYTECOUNTLOOKSBAD) and takes the whole strip's size, reading on into
    the file's next bytes (its IFD here); where that runs past the end of
    the file, cv2 gives None. Both flags, cv2.imread and cv2.imdecode."""
    img = F.photo(37, 29, 3)[..., :spp].astype(np.int64) * {8: 1, 12: 16, 16: 257}[bps]
    if bps == 12:
        raw = F.pack_samples(img.reshape(37, -1), 12)
    else:
        raw = img.astype("<u2" if bps == 16 else np.uint8).tobytes()
    for cut in (0.5, 0.9, 0.97, 0.999):
        data = F.tiff(img, bps, 1 if spp == 1 else 2, chunks=[raw[:int(len(raw) * cut)]])
        _same_as_cv2(data, tmp_path / "short.tif")
    # The whole strip inside the file: read, not None, under IMREAD_UNCHANGED.
    assert tproc.read_image(str(tmp_path / "short.tif")).shape[:2] == (37, 29)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (16, 48)])
def test_uncompressed_palette_and_grey_tiles_under_imread_and_imdecode(tmp_path, tile):
    """An uncompressed 4-bit palette TIFF in tiles (and 8-bit grey tiles):
    libtiff 4.7 reads a tile whose byte count is its size where cv2.imread
    maps the file, and refuses one whose count, rounded up to its read
    buffer's 1 KiB, is not, as cv2.imdecode reads from memory (None)."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 16, (37, 29))
    cmap = rng.integers(0, 65536, (16, 3))
    for name, data in (("pal.tif", F.tiff(idx, 4, 3, colormap=cmap, tile=tile)),
                       ("grey.tif", F.tiff(idx * 16, 8, 1, tile=tile))):
        _same_as_cv2(data, tmp_path / name)
        assert tproc.read_image(str(tmp_path / name), IMREAD_COLOR).shape == (37, 29, 3)


def _bilevel(h, w, seed):
    """Rows of random runs, 1 to 3000 pixels: every terminating, make-up
    and extended make-up code."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), bool)
    for y in range(h):
        x, c = 0, bool(rng.integers(2))
        while x < w:
            n = int(rng.choice([1, 2, 3, 5, 8, 13, 40, 63, 64, 65, 127, 200, 700, 1800, 2600,
                                3000]))
            out[y, x:x + n] = c
            x, c = x + n, not c
    return out


def _pillow_tiff(img, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt", "tiff_raw_16"])
def test_ccitt_as_libtiff_writes_it(compression, tmp_path):
    """Modified Huffman (2), its word-aligned variant (32771), T.4 1-D and
    2-D with and without byte-aligned EOLs (3) and T.6 (4), as Pillow's
    libtiff writes them, in either fill order and moved to odd offsets:
    cv2.imread aligns 32771's rows to the file's offsets (it maps the
    file), cv2.imdecode to the strip's own."""
    from dreamgaussian_tpu_torch.utils.tiff import _Ifd

    for img in (_bilevel(40, 3100, 4), _bilevel(17, 301, 5), F.photo(61, 83, 1)[..., 1] > 120):
        for info in ({}, {292: 1}, {292: 5}, {266: 2}, {278: 5}):
            if compression != "group3" and 292 in info:
                continue
            data = _pillow_tiff(img, compression=compression, tiffinfo=info)
            _same_as_cv2(data)
            d = _Ifd(data)
            chunks = [data[o:o + c] for o, c in zip(d.all(273), d.all(279))]
            rows = d.get(278, img.shape[0])
            moved = F.tiff(img, 1, d.get(262), compression=d.get(259), chunks=chunks,
                           rows_per_strip=rows, gap=1, fill_order=d.get(266, 1),
                           tags={292: (4, d.get(292))} if 292 in d.fields else None)
            _same_as_cv2(moved, tmp_path / "moved.tif")


@pytest.mark.parametrize("size", [(61, 83), (64, 64), (37, 100)])
def test_jpeg_in_tiff_strips_and_tiles(size):
    """Abbreviated JPEG streams with the JPEGTables spliced in: YCbCr turned
    to RGB by libjpeg (fancy upsampling kept) at 4:2:0, 4:2:2 and 4:4:4, an
    RGB stream left as it is, grey; a YCbCrSubsampling tag the stream
    contradicts is None, a missing one is taken from the stream."""
    h, w = size
    img = F.photo(h, w, 7)
    for sub, ss in ((2, (2, 2)), (0, (1, 1)), (1, (2, 1))):
        for lay in ({"rows": 16}, {"rows": h}, {"tile": (32, 32)}, {"tile": (16, 48)}):
            chunks, tables = F.jpeg_tiff_chunks(img, quality=85, subsampling=sub, **lay)
            kw = {"tile": lay["tile"]} if "tile" in lay else {"rows_per_strip": lay["rows"]}
            for tags in ({530: (3, list(ss)), 274: (3, 3)}, {}, {530: (3, [2, 1] if ss != (2, 1)
                                                                    else [2, 2])}):
                _same_as_cv2(F.tiff(img, 8, 6, compression=7, chunks=chunks,
                                    tags={347: (7, tables), **tags}, **kw))
    chunks, tables = F.jpeg_tiff_chunks(img, rows=16, quality=85, subsampling=0, keep_rgb=True)
    _same_as_cv2(F.tiff(img, 8, 2, compression=7, chunks=chunks, rows_per_strip=16,
                        tags={347: (7, tables)}))
    chunks, tables = F.jpeg_tiff_chunks(img[..., 1], rows=16, quality=70)
    _same_as_cv2(F.tiff(img[..., 1], 8, 1, compression=7, chunks=chunks, rows_per_strip=16,
                        tags={347: (7, tables)}))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9])
@pytest.mark.parametrize("lay", [{"rows": 16}, {"tile": (32, 32)}], ids=["strips", "tiles"])
def test_cut_off_jpeg_in_tiff_chunk(tmp_path, lay, cut):
    """A JPEG strip or tile whose stream stops part-way (the TIFF's byte
    counts say so): libtiff's source hands libjpeg a fake EOI as cv2.imread's
    does, so the chunk's MCUs after the data are flat grey before the
    colour conversion, and cv2.imdecode and cv2.imread agree."""
    img = F.photo(61, 83, 7)
    chunks, tables = F.jpeg_tiff_chunks(img, quality=85, subsampling=2, **lay)
    chunks[1] = chunks[1][:int(len(chunks[1]) * cut)]
    kw = {"tile": lay["tile"]} if "tile" in lay else {"rows_per_strip": lay["rows"]}
    _same_as_cv2(F.tiff(img, 8, 6, compression=7, chunks=chunks, tags={347: (7, tables)}, **kw),
                 tmp_path / "cut.tif")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "CMYK", "I;16", "F", "I", "LAB", "P",
                                  "1"])
def test_pillow_and_cv2_writes(mode):
    from PIL import Image

    rgb = F.photo(61, 83, 1)
    rgba = F.photo(61, 83, 1, channels=4)
    img = {"L": lambda: Image.fromarray(rgb[..., 1]),
           "LA": lambda: Image.frombytes("LA", (83, 61), rgba[..., [1, 3]].tobytes()),
           "RGB": lambda: Image.fromarray(rgb), "RGBA": lambda: Image.fromarray(rgba),
           "CMYK": lambda: Image.fromarray(rgb).convert("CMYK"),
           "I;16": lambda: Image.fromarray(rgb[..., 0].astype(np.uint16) * 257 + 5),
           "F": lambda: Image.fromarray(rgb[..., 0].astype(np.float32) / 3),
           "I": lambda: Image.fromarray(rgb[..., 0].astype(np.int32) * 1000 - 5),
           "LAB": lambda: Image.fromarray(rgb).convert("LAB"),
           "P": lambda: Image.fromarray(rgb).quantize(64),
           "1": lambda: Image.fromarray(rgb[..., 1] > 120)}[mode]()
    for compression in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_deflate"):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **({"compression": compression} if compression else {}))
        _same_as_cv2(buf.getvalue())
    arr = {"RGB": rgb, "RGBA": rgba, "L": rgb[..., 0], "I;16": rgb.astype(np.uint16) * 200,
           "F": rgb.astype(np.float32) / 255}.get(mode)
    if arr is not None:
        for params in ([], [cv2.IMWRITE_TIFF_COMPRESSION, 1],
                       [cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 2],
                       [cv2.IMWRITE_TIFF_COMPRESSION, 8], [cv2.IMWRITE_TIFF_COMPRESSION, 32773]):
            ok, enc = cv2.imencode(".tiff", _rgb(arr) if arr.ndim == 3 else arr, params)
            if ok:
                _same_as_cv2(enc.tobytes())


def test_lzw_and_packbits_round_trip_through_the_native_codecs():
    """Long inputs: LZW past its table's 4094 entries (a clear code
    mid-stream), PackBits runs of 1 to 200 bytes."""
    import ctypes

    from dreamgaussian_tpu_torch import native

    rng = np.random.default_rng(9)
    data = np.repeat(rng.integers(0, 256, 20000, dtype=np.uint8), rng.integers(1, 5, 20000))
    data = data.tobytes()
    for comp, code in ((5, F.tiff_lzw(data)), (32773, F.packbits(data))):
        src = np.frombuffer(code, np.uint8).copy()
        out = np.zeros(len(data), np.uint8)
        done = ctypes.c_int64(0)
        assert native.image_codecs().dg_tiff_decompress(
            src.ctypes.data, len(src), comp, out.ctypes.data, len(out), 0, 0, 0,
            ctypes.byref(done)) == 0
        assert done.value == len(data) and out.tobytes() == data


# ------------------------------------------------------------------ refusals and None

def _codec_file(compression: int, seed: int) -> bytes:
    """A 16x16 file each of these codecs decodes: LogLuv (SGILog), LogLuv24
    (SGILog24), 2-bit grey (NeXT), a 4-bit palette (ThunderScan)."""
    rng = np.random.default_rng(seed)
    if compression in (34676, 34677):
        return F.sgilog_tiff(_luv_codes(16, 16, seed, compression), 32845, compression,
                             rows_per_strip=5)
    if compression == 32766:
        grey = rng.integers(0, 4, (16, 16))
        return F.tiff(grey, 2, 1, compression=compression,
                      chunks=[b"".join(F.next_row(r) for r in grey)])
    idx = np.clip(np.cumsum(rng.integers(-2, 3, (16, 16)), axis=1) + 8, 0, 15)
    return F.tiff(idx, 4, 3, compression=compression, colormap=rng.integers(0, 65536, (16, 3)),
                  chunks=[b"".join(F.thunder_row(r) for r in idx)])


@pytest.mark.parametrize("compression,name", [(34676, "SGILog"), (34677, "SGILog24"),
                                              (32766, "NeXT"), (32809, "ThunderScan")])
def test_codecs_cv2_reads_and_the_port_does_not_are_refused_by_name(tmp_path, monkeypatch,
                                                                    compression, name):
    """Once refused by name, these codecs now read as cv2 reads them: SGILog
    and SGILog24 as float32 RGB (and 8-bit RGB under IMREAD_COLOR),
    ThunderScan through its palette, NeXT as None (libtiff's NeXT decoder
    takes only 2-bit samples, which OpenCV's header check refuses); and
    ``load_rgba`` as the JAX package's: None a missing file on both sides,
    float32 refused by GrabCut on both sides, the palette image matted."""
    monkeypatch.delenv("DG_U2NET_CKPT", raising=False)
    data = _codec_file(compression, compression)
    _same_as_cv2(data, tmp_path / "x.tif")
    path = str(tmp_path / "x.tif")
    if compression == 32766:
        for load in (jproc.load_rgba, lambda p: tproc.load_rgba(p, device="cpu")):
            with pytest.raises(FileNotFoundError):
                load(path)
    elif compression in (34676, 34677):
        with pytest.raises(cv2.error):
            jproc.load_rgba(path)
        with pytest.raises(ValueError, match="8-bit"):
            tproc.load_rgba(path, device="cpu")
    else:
        assert tproc.load_rgba(path, device="cpu").shape == jproc.load_rgba(path).shape


def _luv_codes(h, w, seed, compression=34676):
    """LogLuv32 codes (compression 34676: 16-bit signed log luminance, 8-bit
    u and v) or LogLuv24 codes (10-bit luminance, 14-bit uv cell), with
    zero and negative luminance and flat runs among them."""
    rng = np.random.default_rng(seed)
    if compression == 34677:
        codes = rng.integers(1, 1024, (h, w)) << 14 | rng.integers(0, 16384, (h, w))
        codes[0, :2] = [0, 1023 << 14 | 16383]
    else:
        lum = rng.integers(0x2000, 0x5800, (h, w))
        lum[0, :3] = [0, 0x8000 | 0x3000, 0x7FFF]
        codes = lum << 16 | rng.integers(40, 220, (h, w)) << 8 | rng.integers(40, 220, (h, w))
    codes[-1, w // 3:] = codes[-1, w // 3]
    return codes


def _logl_codes(h, w, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-0x7FFF, 0x7FFF, (h, w))
    codes[0, :4] = [0, 0x4000, 0x3F00, -0x4000]
    codes[-1, 1:] = codes[-1, 1]
    return codes


SGILOG_KINDS = {"luv32": (32845, 34676), "luv24": (32845, 34677), "logl": (32844, 34676),
                "logl_sgilog24": (32844, 34677)}
LAYOUTS = {"one strip": {}, "strips of 2": {"rows_per_strip": 2}, "tiles": {"tile": (16, 16)}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("size", [(4, 5), (7, 21), (3, 130)])
@pytest.mark.parametrize("kind", list(SGILOG_KINDS))
def test_sgilog_reads_as_cv2_reads_it(tmp_path, kind, size, layout):
    """libtiff's tif_luv.c decode: LogLuv under IMREAD_UNCHANGED to float
    XYZ, then OpenCV's float cvtColor(XYZ2BGR) (its 4-lane and tail sums
    per row); under IMREAD_COLOR, and LogL always, the 8-bit conversion of
    the RGBA route (LogL with SampleFormat 2 as int8); LogL coded as
    SGILog24 None; literal-only and run-length rows."""
    ph, comp = SGILOG_KINDS[kind]
    h, w = size
    seed = h * w + comp
    codes = _logl_codes(h, w, seed) if ph == 32844 else _luv_codes(h, w, seed, comp)
    for runs in (True, False):
        _same_as_cv2(F.sgilog_tiff(codes, ph, comp, runs=runs, **LAYOUTS[layout]),
                     tmp_path / "x.tif")


@pytest.mark.parametrize("bps,sf", [(8, 1), (16, 1), (16, 2), (32, 1), (32, 3)])
@pytest.mark.parametrize("kind", ["luv32", "logl"])
def test_sgilog_bits_and_sample_formats(kind, bps, sf):
    """The file's BitsPerSample and SampleFormat: LogLuv is float32 under
    IMREAD_UNCHANGED whatever they say, its RGBA route refuses 32-bit and
    float; LogL's dtype follows OpenCV's 8-bit rule for photometric > 2."""
    ph, comp = SGILOG_KINDS[kind]
    codes = _logl_codes(5, 9, bps) if ph == 32844 else _luv_codes(5, 9, bps)
    _same_as_cv2(F.sgilog_tiff(codes, ph, comp, bps=bps, sample_format=sf, rows_per_strip=2))


@pytest.mark.parametrize("cut", [1, 9, 30])
@pytest.mark.parametrize("strip", [0, 1, 2])
@pytest.mark.parametrize("kind", ["luv32", "luv24", "logl"])
def test_cut_sgilog_strips(kind, strip, cut):
    """A strip that ends short: None from cv2's float route; on the RGBA
    route the rows libtiff decoded before it stopped, the rest zero (a
    strip of 0 bytes fails to read: None)."""
    ph, comp = SGILOG_KINDS[kind]
    codes = _logl_codes(5, 9, cut) if ph == 32844 else _luv_codes(5, 9, cut, comp)
    nbytes = 2 if ph == 32844 else 4
    chunks = []
    for y in range(0, 5, 2):
        rows = codes[y:y + 2]
        chunks.append(F.logluv24(rows) if comp == 34677 else b"".join(
            F.sgilog_row(r.astype(np.int64) & ((1 << 8 * nbytes) - 1), nbytes) for r in rows))
    chunks[strip] = chunks[strip][:max(0, len(chunks[strip]) - cut)]
    _same_as_cv2(F.sgilog_tiff(codes, ph, comp, rows_per_strip=2, chunks=chunks))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_sgilog_orientations(orientation):
    """The float route converts XYZ after the page is oriented (its vector
    and tail pixels counted along the oriented rows)."""
    codes = _luv_codes(5, 9, orientation)
    _same_as_cv2(F.sgilog_tiff(codes, 32845, 34676, rows_per_strip=2,
                               tags={274: (3, orientation)}))


@pytest.mark.parametrize("variant", ["planar", "big-endian", "fill order 2", "no SGILog"])
def test_sgilog_layout_variants(variant):
    codes = _luv_codes(6, 10, 3)
    kw = {"planar": {"planar": 2}, "big-endian": {"big_endian": True},
          "fill order 2": {"fill_order": 2}, "no SGILog": {}}[variant]
    data = F.sgilog_tiff(codes, 32845, 1 if variant == "no SGILog" else 34676,
                         rows_per_strip=3, **kw)
    _same_as_cv2(data)


@pytest.mark.parametrize("compression", [34676, 34677])
@pytest.mark.parametrize("channels", [1, 3])
def test_sgilog_written_by_cv2(tmp_path, compression, channels):
    """cv2 writes float32 RGB as LogLuv; one channel as LogL with 16-bit
    signed samples (SGILog), which it reads back as int8 (OpenCV's header
    check reads a photometric above 2 as 8-bit data of its SampleFormat),
    and refuses as SGILog24."""
    img = (np.random.default_rng(channels).random((6, 11, 3)) * 3).astype(np.float32)
    img[0, 0], img[1, 1] = 0, 100
    img = img if channels == 3 else np.ascontiguousarray(img[..., 0])
    ok, buf = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
    if not ok:
        assert channels == 1 and compression == 34677
        return
    _same_as_cv2(buf.tobytes(), tmp_path / "x.tif")


def _walk4(h, w, seed):
    """4-bit samples that move by small steps, with runs."""
    rng = np.random.default_rng(seed)
    s = np.clip(np.cumsum(rng.integers(-3, 4, (h, w)), axis=1) + 7, 0, 15).astype(np.uint8)
    s[:, : w // 3] = s[:, :1]
    s[-1, w // 2:] = 15
    return s


@pytest.mark.parametrize("size", [(6, 23), (5, 8), (4, 3), (9, 64), (2, 1)])
@pytest.mark.parametrize("case", ["strip", "strips of 2", "cut by 2", "cut by half", "extra codes",
                                  "empty", "overrun", "tiles", "grey", "8-bit", "fill order 2"])
def test_thunderscan_reads_as_cv2_reads_it(size, case):
    """tif_thunder.c's codes (runs, 2- and 3-bit deltas with their skips,
    raw pixels) into a 4-bit palette; a row that ends short zeroed from the
    byte it reached, the rows after it left zero; an empty strip None;
    tiles not decoded at all (libtiff's codec has no tile decoder: every
    pixel palette entry 0); grey and 8-bit samples None."""
    h, w = size
    s = _walk4(h, w, h * w)
    pal = np.random.default_rng(w).integers(0, 65536, (16, 3))
    rows = [F.thunder_row(r) for r in s]
    chunk = b"".join(rows)
    kw = {"colormap": pal, "compression": 32809}
    data = {
        "strip": lambda: F.tiff(s, 4, 3, chunks=[chunk], **kw),
        "strips of 2": lambda: F.tiff(s, 4, 3, rows_per_strip=2, **kw, chunks=[
            b"".join(rows[y:y + 2]) for y in range(0, h, 2)]),
        "cut by 2": lambda: F.tiff(s, 4, 3, chunks=[chunk[:-2]], **kw),
        "cut by half": lambda: F.tiff(s, 4, 3, chunks=[chunk[:len(chunk) // 2]], **kw),
        "extra codes": lambda: F.tiff(s, 4, 3, chunks=[chunk + b"\xc1\xc2"], **kw),
        "empty": lambda: F.tiff(s, 4, 3, chunks=[b""], **kw),
        "overrun": lambda: F.tiff(s, 4, 3, chunks=[b"".join(r[:-1] + b"\x3f" for r in rows)],
                                  **kw),
        "tiles": lambda: F.tiff(s, 4, 3, tile=(16, 16), **kw, chunks=[
            b"".join(F.thunder_row(r) for r in np.pad(s[y:y + 16, x:x + 16], (
                (0, 16 - s[y:y + 16, x:x + 16].shape[0]), (0, 16 - s[y:y + 16, x:x + 16].shape[1]))))
            for y in range(0, h, 16) for x in range(0, w, 16)]),
        "grey": lambda: F.tiff(s, 4, 1, chunks=[chunk], compression=32809),
        "8-bit": lambda: F.tiff(s, 8, 3, chunks=[chunk], compression=32809,
                                colormap=np.random.default_rng(1).integers(0, 65536, (256, 3))),
        "fill order 2": lambda: F.tiff(s, 4, 3, chunks=[chunk], fill_order=2, **kw),
    }[case]()
    _same_as_cv2(data)


@pytest.mark.parametrize("photometric", [0, 1, 3])
@pytest.mark.parametrize("kind", ["runs", "literal", "span"])
def test_next_is_none_on_both_sides(kind, photometric):
    """NeXT's 2-bit coding (whole literal rows, literal spans, runs): cv2
    refuses 2-bit samples, and libtiff's NeXT decoder any other depth."""
    rng = np.random.default_rng(photometric)
    s = rng.integers(0, 4, (5, 13)).astype(np.uint8)
    kw = {"colormap": rng.integers(0, 65536, (4, 3))} if photometric == 3 else {}
    _same_as_cv2(F.tiff(s, 2, photometric, compression=32766,
                        chunks=[b"".join(F.next_row(r, kind) for r in s)], **kw))
    _same_as_cv2(F.tiff(s * 60, 8, 1, compression=32766, chunks=[(s * 60).tobytes()]))


PACKED_TYPES = [(spp, ph, sf) for spp, ph in ((3, 2), (1, 1), (4, 2), (2, 1), (1, 0), (1, 3),
                                              (3, 1), (4, 1)) for sf in (1, 2, 3)]


@pytest.mark.parametrize("spp,ph,sf", PACKED_TYPES)
@pytest.mark.parametrize("bps", [10, 12, 14])
def test_packed_samples_read_as_cv2_reads_them(bps, spp, ph, sf):
    """10-, 12- and 14-bit samples: OpenCV's unpacking to uint16, shifted
    left to 16 bits after its grey conversion (signed: saturated to int16);
    None under IMREAD_COLOR (libtiff's RGBA interface refuses them), for a
    palette, 2 samples and floats."""
    rng = np.random.default_rng(bps * 100 + spp * 10 + ph)
    s = rng.integers(0, 1 << bps, (5, 7, spp))
    kw = {"colormap": rng.integers(0, 65536, (1 << bps, 3))} if ph == 3 else {}
    _same_as_cv2(F.tiff(s, bps, ph, sample_format=sf, **kw))


@pytest.mark.parametrize("layout", ["strips", "big-endian", "lzw", "deflate", "packbits",
                                    "lzw predictor 2", "lzw predictor 3", "fill order 2",
                                    "cut lzw", "orientation 3", "tiles 16", "tiles 32x16",
                                    "lzw tiles"])
@pytest.mark.parametrize("bps", [10, 12, 14])
def test_packed_sample_layouts(tmp_path, bps, layout):
    """Strips and tiles, both byte orders (packed samples are not swapped),
    the codecs, the predictors (libtiff's horizontal predictor refuses these
    depths: None), FillOrder 2, a cut LZW strip (None) and orientation."""
    s = np.random.default_rng(bps).integers(0, 1 << bps, (9, 13, 3))
    kw = {"strips": {"rows_per_strip": 4}, "big-endian": {"big_endian": True},
          "lzw": {"compression": 5}, "deflate": {"compression": 8},
          "packbits": {"compression": 32773}, "lzw predictor 2": {"compression": 5},
          "lzw predictor 3": {"compression": 5}, "fill order 2": {"fill_order": 2},
          "cut lzw": {"compression": 5}, "orientation 3": {"tags": {274: (3, 3)}},
          "tiles 16": {"tile": (16, 16)}, "tiles 32x16": {"tile": (32, 16)},
          "lzw tiles": {"tile": (16, 16), "compression": 5}}[layout]
    data = F.tiff(s, bps, 2, **kw)
    if layout.startswith("lzw predictor"):
        data = F.tiff(s, bps, 2, predictor=int(layout[-1]), **kw)
    if layout == "cut lzw":
        chunk = F.tiff_lzw(F.pack_samples(s.reshape(9, -1), bps))
        data = F.tiff(s, bps, 2, chunks=[chunk[:-5]], **kw)
    _same_as_cv2(data, tmp_path / "x.tif")


@pytest.mark.parametrize("compression", [6, 32909, 34925, 50000, 50001, 34887, 34661])
def test_codecs_this_cv2_lacks_are_none_on_both_sides(tmp_path, compression):
    """Old-style JPEG, PixarLog, LZMA, ZSTD, WebP, LERC and JBIG: not
    configured in cv2's libtiff, so cv2 returns None, and the JAX package
    raises FileNotFoundError from load_rgba; so does the port."""
    img = F.photo(20, 20, 1)
    data = F.tiff(img, 8, 2, chunks=[img.tobytes()], tags={259: (3, compression)})
    _same_as_cv2(data, tmp_path / "x.tif")
    path = str(tmp_path / "x.tif")
    for load in (jproc.load_rgba, lambda p: tproc.load_rgba(p, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load(path)


@pytest.mark.parametrize("compression", [34712, 9, 65000])
def test_schemes_libtiff_does_not_know_give_cv2s_zeroed_image(compression):
    """No codec at all (JPEG 2000's 34712 among them): libtiff's strip
    reads fail, and cv2 returns its zeroed raster on the 8-bit route and
    None on the direct one; so does the port."""
    img = F.photo(20, 20, 1, channels=4)
    for spp in (3, 4):
        _same_as_cv2(F.tiff(img[..., :spp], 8, 2, chunks=[img[..., :spp].tobytes()],
                            tags={259: (3, compression)}, extra_samples=[2] if spp == 4 else None))
        deep = img[..., :spp].astype(np.uint16)
        _same_as_cv2(F.tiff(deep, 16, 2, chunks=[deep.tobytes()], tags={259: (3, compression)}))


# ------------------------------------------------------------------ load_rgba and Mesh.load

@pytest.mark.parametrize("name", ["photo_512_rgba.tif", "tiff_rgba16.tif", "tiff_tiled_lzw.tif",
                                  "tiff_planar.tif"])
def test_load_rgba_of_a_four_channel_tiff_matches_jax(name):
    """The premultiplied colours cv2 gives an unassociated-alpha TIFF reach
    stage 1 in the JAX package, and in the port (16-bit: divided by 255)."""
    path = str(TIFF_FIXTURES / name)
    ref = jproc.load_rgba(path, size=64)
    got = tproc.load_rgba(path, size=64, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (64, 64, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["tiff_rgb_lzw.tif", "tiff_jpeg_420.tif", "tiff_palette.tif",
                                  "tiff_grey8.tif"])
def test_load_rgba_of_an_rgb_or_grey_tiff_matches_jax(name, u2net_files, u2net_at_64):  # noqa: F811
    path = str(TIFF_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


@pytest.mark.parametrize("name", ["tiff_logluv.tif", "tiff_logluv24.tif", "tiff_rgb12_lzw.tif"])
def test_load_rgba_of_a_logluv_or_12bit_tiff_matches_jax(name, u2net_files, u2net_at_64):  # noqa: F811
    """Float32 (LogLuv) and uint16 (12-bit, shifted to 16 bits) colours
    matted by U2Net, divided by 255 whatever their range, as the JAX
    package does."""
    path = str(TIFF_CODEC_FIXTURES / name)
    ref = jproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"])
    got = tproc.load_rgba(path, size=48, u2net_ckpt=u2net_files["small"], device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (48, 48, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=1 / 255 + 1e-7)


def test_tiff_textured_obj_matches_jax():
    path = str(TIFF_FIXTURES / "sphere_tiff.obj")
    ref = JMesh.load(path, resize=False)
    got = TMesh.load(path, resize=False)
    assert ref.albedo is not None and got.albedo.shape == ref.albedo.shape == (128, 128, 3)
    np.testing.assert_array_equal(got.albedo, ref.albedo)
    np.testing.assert_array_equal(np.asarray(got.v), np.asarray(ref.v))


def test_glb_with_a_tiff_image_matches_jax(tmp_path):
    image = (TIFF_FIXTURES / "tiff_jpeg_420.tif").read_bytes()
    path = _glb_with_image(tmp_path, image)
    ref = JMesh.load(path, resize=False).albedo
    got = TMesh.load(path, resize=False).albedo
    assert ref is not None and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)


def test_float_tiff_texture_raises_on_both_sides_and_a_glb_keeps_no_albedo(tmp_path, capsys):
    """cv2.imread of a float32 TIFF under IMREAD_COLOR is None: the JAX
    Mesh.load raises in cv2.cvtColor for an OBJ, and leaves a GLB's albedo
    unset; the port raises ValueError naming TIFF, and leaves it unset."""
    tex = (TIFF_FIXTURES / "tiff_grey32f.tif").read_bytes()
    (tmp_path / "f.tif").write_bytes(tex)
    (tmp_path / "m.mtl").write_text("newmtl m\nmap_Kd f.tif\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nusemtl m\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                    "vt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    with pytest.raises(cv2.error):
        JMesh.load(str(tmp_path / "m.obj"), resize=False)
    with pytest.raises(ValueError, match="TIFF"):
        TMesh.load(str(tmp_path / "m.obj"), resize=False)
    glb = _glb_with_image(tmp_path, tex)
    assert JMesh.load(glb, resize=False).albedo is None
    capsys.readouterr()
    assert TMesh.load(glb, resize=False).albedo is None
    assert "does not decode" in capsys.readouterr().out
