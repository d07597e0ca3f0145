"""TIFF reader of the port's own (no cv2, no PIL, no libtiff), on the host.

``decode_tiff(data, flags)`` returns what ``cv2.imdecode`` (OpenCV 5.0 with
its libtiff 4.7) returns for ``IMREAD_UNCHANGED`` (-1) and ``IMREAD_COLOR``
(1), channels in RGB(A) order. Python reads the container: both byte
orders, classic TIFF and BigTIFF, the first IFD (cv2 reads page 0), strips
and tiles (edge tiles cropped), PlanarConfiguration 1 and 2, FillOrder 2,
BitsPerSample 1, 2, 4, 8, 10, 12, 14, 16, 32 and 64, SampleFormat uint,
int and IEEE float, ExtraSamples. Decompression: none, PackBits, LZW, CCITT (Modified
Huffman, its word-aligned variant, T.4 1-D and 2-D, T.6), ThunderScan and
SGILog / SGILog24 in ``csrc/image_codecs.cpp`` with the horizontal and
floating-point predictors; Deflate through ``zlib``; JPEG through
``utils/jpeg.py`` with the JPEGTables spliced in front of each strip or
tile.

cv2 takes one of two routes, and so does the port:

- an 8-bit destination (every ``IMREAD_COLOR`` decode, and 1-, 4- and
  8-bit data and some 16-bit data under ``IMREAD_UNCHANGED``) goes through
  libtiff's RGBA interface (``TIFFReadRGBAStrip``/``Tile``): MinIsWhite
  inverted, 1-, 2- and 4-bit samples widened by libtiff's maps, a palette
  through its 16-bit colormap (or as 8-bit, where no entry exceeds 255),
  CMYK as R = (255 - C)(255 - K) / 255, YCbCr through
  ``TIFFYCbCrtoRGB`` (subsampled chroma repeated over its block), CIELab
  through ``TIFFCIELabToRGB``, 16-bit samples to 8 by (v + 128) / 257 (grey
  by v >> 8), unassociated alpha premultiplied by libtiff's ``UaToAa``;
  one channel is OpenCV's fixed-point grey of the RGBA result;
- 16-, 32- and 64-bit data under ``IMREAD_UNCHANGED`` is read as stored
  (grey from 3 or 4 samples by OpenCV's fixed-point weights); 10-, 12- and
  14-bit samples are unpacked (most significant bit first, rows padded to
  a byte) as OpenCV's ``_unpack10To16`` and its kin do and shifted left
  to 16 bits after any grey conversion (signed samples saturated to
  int16), and have no 8-bit decode
  (libtiff's RGBA interface refuses them: None under ``IMREAD_COLOR``).

LogLuv data (photometric 32845, 3 samples, SGILog or SGILog24) under
``IMREAD_UNCHANGED`` is decoded by libtiff's ``SGILOGDATAFMT_FLOAT`` to
float32 CIE XYZ and converted by OpenCV's ``cvtColor(XYZ2BGR)``; under
``IMREAD_COLOR``, and for LogL (32844), it takes the RGBA route, where
libtiff's 8-bit LogLuv conversion gives RGB (``XYZtoRGB24``) and grey
(``L16toGry``). OpenCV's header check reads a LogL file as 8-bit data of
its SampleFormat, so a LogL file that libtiff wrote from 16-bit signed
LogL (as cv2 writes a one-channel float image with SGILog) comes out as
int8, the grey bytes reinterpreted. Rows that an SGILog or ThunderScan
strip or tile does not hold stay zero on the RGBA route, as libtiff's
zeroed strip buffer leaves them.

The Orientation tag is applied under both flags (by cv2.imdecode; cv2.imread
returns None where it transposes a page that is not square). Where cv2
returns None (libtiff refuses the layout, a codec this build lacks, 32-bit
data under ``IMREAD_COLOR``, every NeXT file: libtiff's NeXT decoder
takes only 2-bit samples, which OpenCV's header check refuses)
``decode_tiff`` raises ValueError; a compression scheme libtiff does not
know at all gives cv2's zeroed image on the 8-bit route.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from .. import native
from .jpeg import decode_jpeg

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1

# Field types: struct code and size of one value.
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_PAIRED = (5, 10)                   # rationals: two values each
_DECODED = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946, 32809, 34676, 34677)
_SGILOG = (34676, 34677)
_LOGL, _LOGLUV = 32844, 32845
_PACKED = (10, 12, 14)              # sample depths OpenCV unpacks to 16 bits
# Codecs libtiff knows and cv2's build leaves out: old-style JPEG, JBIG,
# PixarLog, LZMA, ZSTD, WebP, LERC.
_UNCONFIGURED = (6, 34661, 32909, 34925, 50000, 50001, 34887)
_FAX = (2, 3, 4, 32771)
_PREDICTED = (5, 8, 32946)          # the codecs libtiff gives a Predictor tag
_TILE_ROUND = 1024                  # libtiff's raw read buffer granularity
_D50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class _Ifd:
    """The first IFD's fields: tag -> tuple of values (bytes for ASCII and
    UNDEFINED)."""

    def __init__(self, data: bytes, imread: bool = False):
        self.imread, self.size = imread, len(data)
        if data[:4] in (b"II*\0", b"MM\0*"):
            self.e, self.big = "<>"[data[0] == 0x4D], False
            at = struct.unpack_from(self.e + "I", data, 4)[0]
        elif data[:4] in (b"II+\0", b"MM\0+"):
            self.e, self.big = "<>"[data[0] == 0x4D], True
            size, zero, at = struct.unpack_from(self.e + "HHQ", data, 4)
            if size != 8 or zero != 0:
                raise ValueError("a BigTIFF header with an offset size other than 8")
        else:
            raise ValueError("not a TIFF file")
        e = self.e
        count_fmt, entry, inline = ("Q", 20, 8) if self.big else ("H", 12, 4)
        n = struct.unpack_from(e + count_fmt, data, at)[0]
        self.fields: dict[int, object] = {}
        for k in range(n):
            pos = at + (8 if self.big else 2) + entry * k
            tag, typ = struct.unpack_from(e + "HH", data, pos)
            count = struct.unpack_from(e + ("Q" if self.big else "I"), data, pos + 4)[0]
            if typ not in _TYPES:
                continue                                # libtiff skips unknown types
            code, size = _TYPES[typ]
            total = count * size * (2 if typ in _PAIRED else 1)
            where = pos + (12 if self.big else 8)
            if total > inline:
                where = struct.unpack_from(e + ("Q" if self.big else "I"), data, where)[0]
            raw = data[where:where + total]
            if len(raw) != total:
                raise ValueError(f"TIFF tag {tag}: its values lie outside the file")
            if typ in (2, 7):
                self.fields[tag] = bytes(raw)
                continue
            vals = struct.unpack(e + code * (count * (2 if typ in _PAIRED else 1)), raw)
            if typ in _PAIRED:
                vals = tuple(np.float32(a) / np.float32(b) if b else np.float32(0)
                             for a, b in zip(vals[::2], vals[1::2]))
            self.fields[tag] = vals

    def get(self, tag: int, default=None):
        v = self.fields.get(tag)
        return default if v is None or len(v) == 0 else v[0]

    def all(self, tag: int, default=()):
        return self.fields.get(tag, default)


def _refuse_codec(compression: int) -> None:
    if compression == 32766:
        raise ValueError("cv2 reads no NeXT-coded TIFF: libtiff's NeXT decoder takes only "
                         "2-bit samples, which OpenCV's TIFF header check refuses")
    if compression in _UNCONFIGURED:
        raise ValueError(f"TIFF compression {compression} is not configured in cv2's libtiff")


def _cv_type(photometric: int, spp: int, bps: int, sample_format: int):
    """OpenCV's TiffDecoder::readHeader: the dtype and channel count of
    ``IMREAD_UNCHANGED``; ValueError where it refuses the file."""
    if not 1 <= spp <= 4:
        raise ValueError(f"a TIFF with {spp} samples per pixel (1 to 4 are read)")
    signed = sample_format == 2
    if sample_format not in (1, 2) and bps in (1, 4, 8, *_PACKED, 16):
        raise ValueError(f"{bps}-bit TIFF samples of SampleFormat {sample_format}")
    if bps == 1:
        return np.int8 if signed else np.uint8, spp if photometric > 1 else 1
    if bps == 4:
        if photometric != 3:
            raise ValueError("4-bit TIFF samples outside a palette")
        return np.int8 if signed else np.uint8, 3
    if bps == 8:
        return np.int8 if signed else np.uint8, 3 if photometric == 3 else \
            (spp if photometric > 1 else 1)
    if bps in (*_PACKED, 16):
        channels = spp if photometric > 1 else 1
        if photometric in (0, 1, 2) and spp != 2:
            return np.int16 if signed else np.uint16, channels
        return np.int8 if signed else np.uint8, channels
    if bps in (32, 64):
        if photometric not in (0, 1, 2, 3) or spp == 2:
            raise ValueError(f"a {bps}-bit TIFF of photometric {photometric} with {spp} samples")
        if bps == 64:
            if sample_format != 3:
                raise ValueError("64-bit TIFF samples that are not floating point")
            return np.float64, spp
        return {1: np.uint32, 2: np.int32, 3: np.float32}[sample_format], spp
    raise ValueError(f"{bps}-bit TIFF samples (1, 4, 8, 10, 12, 14, 16, 32 or 64 are read)")


class _Layout:
    """Where a page's samples lie: strips or tiles, per plane."""

    def __init__(self, d: _Ifd):
        self.w, self.h = d.get(256), d.get(257)
        if not self.w or not self.h:
            raise ValueError("a TIFF without its image size")
        self.spp = d.get(277, 1)
        bps = d.all(258, (1,))
        if len(set(bps)) > 1:
            raise ValueError("a TIFF whose samples differ in bit depth")
        self.bps = bps[0]
        self.planar = d.get(284, 1)
        self.plane_spp = self.spp if self.planar == 1 or self.spp == 1 else 1
        self.planes = 1 if self.plane_spp == self.spp else self.spp
        self.tiled = 322 in d.fields
        if self.tiled:
            self.cw, self.ch = d.get(322), d.get(323)
            if not self.cw or not self.ch:
                raise ValueError("a TIFF tile of zero size")
            self.across = -(-self.w // self.cw)
            self.down = -(-self.h // self.ch)
            offsets, counts = d.all(324), d.all(325)
        else:
            rps = d.get(278, 0xFFFFFFFF)
            self.cw, self.ch = self.w, min(rps or self.h, self.h)
            self.across, self.down = 1, -(-self.h // self.ch)
            offsets, counts = d.all(273), d.all(279)
        n = self.across * self.down * self.planes
        if len(offsets) < n or len(counts) < n:
            raise ValueError(f"a TIFF with {len(offsets)} of its {n} strips or tiles")
        self.offsets, self.counts = offsets[:n], counts[:n]
        self.row_bytes = -(-self.cw * self.plane_spp * self.bps // 8)
        scanline = self.row_bytes                         # TIFFScanlineSize64
        sub = tuple(d.all(530, (2, 2))[:2])
        if d.get(262) == 6 and self.planar == 1 and self.spp == 3 and set(sub) <= {1, 2, 4}:
            block = sub[0] * sub[1] + 2                   # YCbCr: a row of sampling blocks
            scanline = -(-self.w // sub[0]) * block * self.bps // 8 // sub[1]
        whole = scanline * self.h
        if (n == 1 and not self.tiled and offsets[0] and d.get(259, 1) == 1
                and (counts[0] < whole or counts[0] > d.size - offsets[0])):
            # libtiff's TIFFReadDirectory calls the count of one uncompressed
            # strip bogus (BYTECOUNTLOOKSBAD) and takes the whole strip's
            # size in its place, reading on into the file's next bytes.
            if offsets[0] + whole > d.size:
                raise ValueError("a TIFF strip whose size, as libtiff re-estimates it, runs "
                                 "past the end of the file")
            self.counts = (whole,)

    def chunks(self):
        """(index, plane, y, x, rows stored, rows and columns in the image)."""
        k = 0
        for p in range(self.planes):
            for ty in range(self.down):
                for tx in range(self.across):
                    y, x = ty * self.ch, tx * self.cw
                    stored = self.ch if self.tiled else min(self.ch, self.h - y)
                    yield k, p, y, x, stored, min(self.ch, self.h - y), min(self.cw, self.w - x)
                    k += 1


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _chunk(d: _Ifd, lay: _Layout, data: bytes, k: int, rows: int,
           size: int | None = None) -> tuple[np.ndarray, bool]:
    """Chunk ``k``'s ``rows`` rows (``size`` bytes) decompressed, with the
    fill order, the predictor and the byte order undone (samples native),
    and whether its data ended short (the rest zeros)."""
    comp, fill = d.get(259, 1), d.get(266, 1)
    size = rows * lay.row_bytes if size is None else size
    raw, off = _raw(d, lay, data, k), lay.offsets[k]
    out = np.zeros(size, np.uint8)
    done = ctypes.c_int64(0)
    if comp == 32809:
        if lay.bps != 4:
            raise ValueError(f"ThunderScan data of {lay.bps}-bit samples (4 are decoded)")
        if lay.tiled:       # libtiff's ThunderScan codec has no tile decoder: nothing decoded
            return out, True
        scanline = -(-lay.w * lay.plane_spp * lay.bps // 8)
        native.image_codecs().dg_tiff_decompress(_ptr(raw), len(raw), comp, _ptr(out), size,
                                                 lay.w, 0, scanline, ctypes.byref(done))
        return out, done.value < size
    if comp == 1:
        got = min(len(raw), size)
        out[:got] = raw[:got]
    elif comp in (8, 32946):
        try:
            buf = zlib.decompressobj().decompress(raw.tobytes(), size)
        except zlib.error as err:
            raise ValueError(f"a TIFF strip's Deflate data does not decode ({err})") from err
        got = len(buf)
        out[:got] = np.frombuffer(buf, np.uint8)
    elif comp in (5, 32773):
        if native.image_codecs().dg_tiff_decompress(_ptr(raw), len(raw), comp, _ptr(out), size,
                                                    0, 0, 0, ctypes.byref(done)):
            raise ValueError("a TIFF strip's LZW data does not decode")
        got = done.value
    else:                                                   # CCITT
        if lay.bps != 1:
            raise ValueError("CCITT-coded TIFF samples of more than 1 bit")
        t4 = d.get(292, 0)
        if comp == 3 and t4 & 2:
            raise ValueError("T.4 data in uncompressed mode")
        # Compression 32771 aligns each row to 16 bits of memory: the file's
        # offsets where cv2.imread maps the file, the strip's own in a copy
        # (cv2.imdecode).
        odd = off & 1 and d.imread
        options = (t4 & 1 if comp == 3 else 0) | (2 if fill == 2 else 0) | (4 if odd else 0)
        native.image_codecs().dg_tiff_decompress(_ptr(raw), len(raw), comp, _ptr(out), size,
                                                 lay.cw * lay.plane_spp, rows, options,
                                                 ctypes.byref(done))
        got = done.value * lay.row_bytes
    pred = d.get(317, 1) if comp in _PREDICTED else 1
    nbytes = lay.bps // 8
    swap = d.e == ">" and lay.bps in (16, 32, 64)
    if pred in (1, 2) and swap:
        out = out.view(f">u{nbytes}").astype(f"<u{nbytes}").view(np.uint8)
    if pred != 1:
        if pred == 2 and lay.bps not in (8, 16, 32, 64):
            raise ValueError(f"the horizontal predictor on {lay.bps}-bit TIFF samples")
        if pred == 3 and (d.get(339, 1) != 3 or lay.bps not in (16, 32, 64)):
            raise ValueError("the floating-point predictor on samples that are not floats")
        if pred not in (2, 3) or native.image_codecs().dg_tiff_unpredict(
                _ptr(out), rows, lay.row_bytes, pred, lay.bps, lay.plane_spp):
            raise ValueError(f"TIFF rows that Predictor {pred} cannot undo")
    return out, got < size


def _raw(d: _Ifd, lay: _Layout, data: bytes, k: int) -> np.ndarray:
    """Chunk ``k``'s stored bytes, with FillOrder 2 undone (but for CCITT,
    whose decoder reads the bits in either order)."""
    off, count = lay.offsets[k], lay.counts[k]
    if off >= len(data):
        raise ValueError(f"a TIFF strip or tile at offset {off}, past the end of the file")
    comp = d.get(259, 1)
    if count == 0 and comp in (32809, *_SGILOG):
        raise ValueError("a TIFF strip or tile of 0 bytes (libtiff fails to read it)")
    raw = np.frombuffer(data, np.uint8, count=min(count, len(data) - off), offset=off)
    if d.get(266, 1) == 2 and comp not in _FAX:
        raw = _REVERSE[raw]
    return np.ascontiguousarray(raw)


def _unpack(rows: np.ndarray, bps: int, n: int) -> np.ndarray:
    """[rows, row_bytes] of ``bps``-bit samples (MSB first) -> [rows, n]."""
    if bps == 8:
        return rows[:, :n]
    per = 8 // bps
    shifts = (8 - bps * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bps) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :n]


def _unpack16(rows: np.ndarray, bps: int, n: int) -> np.ndarray:
    """[rows, row_bytes] of ``bps``-bit samples (MSB first) -> uint16 [rows,
    n] (OpenCV's ``_unpack10To16`` and its kin)."""
    bits = np.unpackbits(rows, axis=1)[:, :n * bps].reshape(rows.shape[0], n, bps)
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.uint32)
    return (bits.astype(np.uint32) @ weights).astype(np.uint16)


def _dtype(lay: _Layout, sample_format: int) -> np.dtype:
    """The samples' numpy type (native order; bps < 8 widened to uint8,
    10 to 14 to uint16)."""
    if lay.bps < 8:
        return np.dtype(np.uint8)
    if lay.bps in _PACKED:
        return np.dtype(np.uint16)
    kind = {2: "i", 3: "f"}.get(sample_format, "u")
    if kind == "f" and lay.bps < 32:        # 16-bit floats: refused before they are read
        kind = "u"
    return np.dtype(f"<{kind}{lay.bps // 8}")


def _jpeg_chunk(d: _Ifd, lay: _Layout, data: bytes, k: int, rows: int, ycbcr: bool) -> np.ndarray:
    """A JPEG-compressed strip or tile: libtiff hands libjpeg the
    JPEGTables stream, then the chunk's abbreviated stream, and asks for
    RGB out of YCbCr (JPEGCOLORMODE_RGB) or no conversion at all."""
    off, count = lay.offsets[k], lay.counts[k]
    chunk = data[off:off + count]
    tables = d.all(347, b"")
    if isinstance(tables, bytes) and tables.startswith(b"\xff\xd8") and chunk.startswith(b"\xff\xd8"):
        end = len(tables) - 2 if tables.endswith(b"\xff\xd9") else len(tables)
        chunk = tables[:end] + chunk[2:]
    sampling = _jpeg_sampling(chunk)
    if sampling is not None:
        # JPEGPreDecode's check; without the tag libtiff takes the stream's.
        want = (tuple(d.all(530)[:2]) if 530 in d.fields else sampling[0]) if ycbcr else (1, 1)
        if want != sampling[0] or any(s != (1, 1) for s in sampling[1:]):
            raise ValueError(f"improper JPEG sampling factors {sampling} in a TIFF")
    img = decode_jpeg(chunk, 1 if ycbcr else 2)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[:2] != (rows, lay.cw) or img.shape[2] != lay.plane_spp:
        raise ValueError(f"a JPEG strip or tile of {img.shape} where {(rows, lay.cw)} belongs")
    return img


def _jpeg_sampling(stream: bytes):
    """The frame's sampling factors per component, if a SOF is found."""
    at = 2
    while at + 4 <= len(stream) and stream[at] == 0xFF:
        marker = stream[at + 1]
        length = struct.unpack_from(">H", stream, at + 2)[0]
        if marker in (0xC0, 0xC1, 0xC2):
            n = stream[at + 9]
            return [(stream[at + 11 + 3 * c] >> 4, stream[at + 11 + 3 * c] & 15) for c in range(n)]
        if marker == 0xDA:
            break
        at += 2 + length
    return None


def _samples(d: _Ifd, lay: _Layout, data: bytes, ycbcr_blocks,
             unsigned: bool = False, skew: bool = False) -> tuple[np.ndarray, bool]:
    """Every sample of the page: [H, W, spp] (native dtype, or unsigned as
    libtiff's RGBA interface reads them; bps < 8 as uint8 values), and
    whether any chunk ended short. ``ycbcr_blocks``: the (h, v)
    subsampling of contiguous YCbCr, whose chunks hold blocks. ``skew``:
    read an edge tile's rows as libtiff's grey put routines (putgreytile,
    putagreytile, put16bitbwtile) do, which step over the unread part of
    each tile row by its count of pixels where it should count bytes."""
    comp = d.get(259, 1)
    dtype = _dtype(lay, 1 if unsigned else d.get(339, 1))
    out = np.zeros((lay.h, lay.w, lay.spp), dtype if lay.bps >= 8 else np.uint8)
    short = False
    for k, p, y, x, stored, rows, cols in lay.chunks():
        if comp == 7:
            part = _jpeg_chunk(d, lay, data, k, stored, d.get(262) == 6 and lay.planar == 1)
        elif ycbcr_blocks is not None:
            part, s = _ycbcr_chunk(d, lay, data, k, stored, ycbcr_blocks)
            short |= s
        else:
            buf, s = _chunk(d, lay, data, k, stored)
            short |= s
            if skew and lay.tiled and cols < lay.cw:
                pixel = lay.spp * lay.bps // 8
                step = pixel * cols + lay.cw - cols
                part = np.zeros((stored, lay.cw, lay.spp), dtype)
                for r in range(rows):
                    row = buf[r * step:r * step + pixel * cols]
                    part[r, :cols] = np.frombuffer(row.tobytes(), dtype).reshape(cols, lay.spp)
                out[y:y + rows, x:x + cols, p:p + lay.plane_spp] = part[:rows, :cols]
                continue
            buf = buf.reshape(stored, lay.row_bytes)
            if lay.bps in _PACKED:
                part = _unpack16(buf, lay.bps, lay.cw * lay.plane_spp).reshape(
                    stored, lay.cw, lay.plane_spp)
            elif lay.bps >= 8:
                part = buf.view(dtype).reshape(stored, lay.cw, lay.plane_spp)
            else:
                part = _unpack(buf, lay.bps, lay.cw * lay.plane_spp).reshape(
                    stored, lay.cw, lay.plane_spp)
        out[y:y + rows, x:x + cols, p:p + lay.plane_spp] = part[:rows, :cols]
    return out, short


def _ycbcr_chunk(d: _Ifd, lay: _Layout, data: bytes, k: int, rows: int, sub) -> tuple:
    """A chunk of subsampled YCbCr: blocks of hs x vs luma samples then
    Cb and Cr (TIFF 6.0 section 21), each chroma pair repeated over its
    block as libtiff's putcontig8bitYCbCr tiles do."""
    hs, vs = sub
    bw, bh = -(-lay.cw // hs), -(-rows // vs)
    block = hs * vs + 2
    if d.get(259, 1) in _PREDICTED and d.get(317, 1) != 1:
        raise NotImplementedError("a predictor on subsampled YCbCr TIFF data is not read")
    buf, short = _chunk(d, lay, data, k, rows, bw * block * bh)
    blocks = buf.reshape(bh, bw, block)
    luma = blocks[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3)
    luma = luma.reshape(bh * vs, bw * hs)
    cb = np.repeat(np.repeat(blocks[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(blocks[..., -1], vs, 0), hs, 1)
    return np.stack([luma, cb, cr], -1)[:rows, :lay.cw], short


# ---------------------------------------------------------------- the 8-bit route

def _ua_to_aa(v: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libtiff's UaToAa table: unassociated alpha premultiplied."""
    return ((v.astype(np.int32) * a + 127) // 255).astype(np.uint8)


def _b16_to_8(v: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8 table."""
    return ((v.astype(np.int32) + 128) // 257).astype(np.uint8)


def _grey_map(photometric: int, bps: int) -> np.ndarray:
    """libtiff's setupMap for MinIsWhite / MinIsBlack (16-bit samples go
    through their high byte, as put16bitbwtile does)."""
    top = 255 if bps == 16 else (1 << bps) - 1
    x = np.arange(top + 1)
    return ((top - x if photometric == 0 else x) * 255 // top).astype(np.uint8)


def _ycbcr_to_rgb(d: _Ifd, ycc: np.ndarray) -> np.ndarray:
    """TIFFYCbCrToRGBInit's tables and TIFFYCbCrtoRGB, in libtiff's float
    and 16-bit fixed-point arithmetic."""
    f = np.float32
    luma = [f(v) for v in d.all(529, (f(0.299), f(0.587), f(0.114)))]
    ref = [f(v) for v in d.all(532, (0, 255, 128, 255, 128, 255))]
    if len(luma) < 3 or len(ref) < 6 or any(np.isnan(luma)) or abs(luma[1]) < 1e-10:
        raise ValueError("invalid YCbCrCoefficients or ReferenceBlackWhite in a TIFF")

    def fix(x):                                  # FIX(CLAMP(x, 0, 2))
        return int(float(f(min(max(x, f(0)), f(2))) * f(65536)) + 0.5)

    def table(c, rb, rw, cr):                   # CLAMPw(Code2V(c, rb, rw, cr)), truncated
        den = f(rw - rb) if f(rw - rb) != 0 else f(1)
        v = ((c - int(np.trunc(rb))).astype(f) * f(cr)) / den
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    f1 = f(2) - f(2) * luma[0]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    f3 = f(2) - f(2) * luma[2]
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])
    one_half = 1 << 15
    x = np.arange(-128, 128)
    cr = table(x, ref[4] - f(128), ref[5] - f(128), 127)
    cb = table(x, ref[2] - f(128), ref[3] - f(128), 127)
    cr_r, cb_b = (d1 * cr + one_half) >> 16, (d3 * cb + one_half) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + one_half
    y_tab = table(x + 128, ref[0], ref[1], 255)
    y, b, r = (ycc[..., i].astype(np.int64) for i in range(3))
    out = np.stack([y_tab[y] + cr_r[r], y_tab[y] + ((cb_g[b] + cr_g[r]) >> 16),
                    y_tab[y] + cb_b[b]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _cielab_to_rgb(d: _Ifd, lab: np.ndarray, bps: int) -> np.ndarray:
    """TIFFCIELabToRGBInit with libtiff's sRGB display and the WhitePoint
    (D50 by default), TIFFCIELab16ToXYZ and TIFFXYZToRGB, in float."""
    f = np.float32
    x0, y0, z0 = _D50
    wp = d.all(318, (x0 / (x0 + y0 + z0), y0 / (x0 + y0 + z0)))
    wx, wy = f(wp[0]), f(wp[1])
    if wy == 0:
        raise ValueError("a TIFF WhitePoint of zero luminance")
    ref_y = f(100)
    ref_x = wx / wy * ref_y
    ref_z = (f(1) - wx - wy) / wy * ref_y
    rng = 1500
    table = (f(255) * np.power(np.arange(rng + 1) / rng, 1.0 / float(f(2.4))).astype(f)).astype(f)
    step = (f(100) - f(1)) / f(rng)
    if bps == 8:
        l_ = lab[..., 0].astype(np.int64) * 257
        a_, b_ = (lab[..., c].view(np.int8).astype(np.int64) * 256 for c in (1, 2))
    else:
        l_ = lab[..., 0].astype(np.int64)
        a_, b_ = (lab[..., c].view(np.int16).astype(np.int64) for c in (1, 2))
    L = l_.astype(f) * f(100) / f(65535)
    low = L < f(8.856)
    Y = np.where(low, (L * ref_y) / f(903.292), f(0))
    cby = np.where(low, f(7.787) * (Y / ref_y) + f(16) / f(116), (L + f(16)) / f(116))
    Y = np.where(low, Y, ref_y * cby * cby * cby).astype(f)

    def xz(t, ref):
        return np.where(t < f(0.2069), ref * (t - f(0.13793)) / f(7.787), ref * t * t * t).astype(f)

    X = xz(a_.astype(f) / f(256) / f(500) + cby, ref_x)
    Z = xz(cby - b_.astype(f) / f(256) / f(200), ref_z)
    m = [[f(3.2410), f(-1.5374), f(-0.4986)], [f(-0.9692), f(1.8760), f(0.0416)],
         [f(0.0556), f(-0.2040), f(1.0570)]]
    out = []
    for row in m:
        v = row[0] * X + row[1] * Y + row[2] * Z
        v = np.minimum(np.maximum(v, f(1)), f(100))
        i = np.minimum(((v - f(1)) / step).astype(np.int64), rng)
        c = (table[i].astype(np.float64) + 0.5).astype(np.int64)
        out.append(np.minimum(c, 255))
    return np.stack(out, -1).astype(np.uint8)


def _rgba(d: _Ifd, lay: _Layout, data: bytes) -> np.ndarray:
    """What OpenCV's TIFFReadRGBAStrip / TIFFReadRGBATile calls assemble:
    uint8 [H, W, 4] RGBA. ValueError where TIFFRGBAImageOK or
    TIFFRGBAImageBegin refuses the page, or no put routine exists."""
    comp, bps, spp = d.get(259, 1), lay.bps, lay.spp
    ph = d.get(262)
    extra = d.all(338, ())
    colour = spp - len(extra)
    if bps not in (1, 2, 4, 8, 16):
        raise ValueError(f"TIFFRGBAImageOK: can not handle images with {bps}-bit samples")
    if d.get(339, 1) == 3:
        raise ValueError("TIFFRGBAImageOK: can not handle IEEE floating-point samples")
    if ph in (_LOGL, _LOGLUV):
        return _orient_rgba(d, lay, _sgilog_rgba(d, lay, data, colour))
    if ph in (0, 1, 3) and lay.planar == 1 and spp != 1 and bps < 8:
        raise ValueError(f"TIFFRGBAImageOK: contiguous {bps}-bit data with {spp} samples")
    if ph == 2 and colour < 3:
        raise ValueError(f"TIFFRGBAImageOK: an RGB image with {colour} colour channels")
    if ph == 5 and (d.get(332, 1) != 1 or spp < 4):
        raise ValueError("TIFFRGBAImageOK: a separated image that is not CMYK")
    if ph == 8 and (spp != 3 or colour != 3 or bps not in (8, 16)):
        raise ValueError("TIFFRGBAImageOK: CIELab with other than 3 samples of 8 or 16 bits")
    if ph not in (0, 1, 2, 3, 5, 6, 8):
        raise ValueError(f"TIFFRGBAImageOK: can not handle photometric {ph}")
    alpha = 0
    if extra:
        alpha = 1 if extra[0] == 0 and spp > 3 else (extra[0] if extra[0] in (1, 2) else 0)
    elif spp == 4 and ph == 2:
        alpha = 1                               # DEFAULT_EXTRASAMPLE_AS_ALPHA
    contig = not (lay.planar == 2 and spp > 1)
    if comp == 7 and ph == 6 and contig:
        ph = 2                                  # libjpeg gave RGB (JPEGCOLORMODE_RGB)
    sub = tuple(d.all(530, (2, 2))[:2])
    blocks = sub if ph == 6 and contig and comp != 7 and sub != (1, 1) else None
    if ph == 6 and (bps != 8 or spp != 3 or
                    (sub not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
                     if contig else sub != (1, 1))):
        raise ValueError(f"libtiff has no put routine for YCbCr {bps}-bit {sub} data")
    if comp == 1 and lay.tiled:
        # libtiff 4.7 refuses an uncompressed tile whose byte count is not the
        # tile's size: the count itself where cv2.imread maps the file, the
        # count rounded up to its read buffer's 1 KiB where cv2.imdecode
        # reads from memory.
        tile = lay.ch * lay.row_bytes
        for count in lay.counts:
            got = count if d.imread else -(-count // _TILE_ROUND) * _TILE_ROUND
            if got != tile:
                raise ValueError(f"invalid tile byte count: expected {tile}, got {got}")
    if not contig and ph in (3, 8):
        raise ValueError(f"libtiff has no put routine for separate planes of photometric {ph}")
    if (ph == 2 and bps not in (8, 16)) or (ph == 5 and bps != 8) or (ph == 3 and bps == 16) or \
            (ph == 0 or ph == 1) and not contig and bps not in (8, 16) or \
            (ph == 5 and not contig and spp != 4):
        raise ValueError(f"libtiff has no put routine for {bps}-bit data of photometric {ph}")
    if ph == 3:
        cmap = d.all(320, ())
        n = 1 << bps
        if len(cmap) != 3 * n:
            raise ValueError("a palette TIFF without its Colormap")
    if comp not in _DECODED:
        # A scheme libtiff has no codec for: every strip fails to decode and
        # OpenCV keeps its zeroed raster.
        return np.zeros((lay.h, lay.w, 4), np.uint8)
    S, _ = _samples(d, lay, data, blocks, unsigned=True,
                    skew=ph in (0, 1) and bps in (8, 16) and contig)
    h, w = S.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if ph in (0, 1, 2) and not contig:          # gtStripSeparate: grey planes as RGB, no map
        planes = [0, 0, 0] if ph in (0, 1) else [0, 1, 2]
        rgb = S[..., planes]
        a = S[..., 1 if ph in (0, 1) else 3] if alpha and spp > (1 if ph < 2 else 3) else None
        if bps == 16:
            rgb = _b16_to_8(rgb)
            a = None if a is None else _b16_to_8(a)
        out[..., :3] = rgb
        if a is not None:
            out[..., 3] = a
            if alpha == 2:
                out[..., :3] = _ua_to_aa(rgb, a[..., None].astype(np.int32))
    elif ph == 2:
        rgb = S[..., :3] if bps == 8 else _b16_to_8(S[..., :3])
        out[..., :3] = rgb
        if alpha and spp >= 4:
            a = S[..., 3] if bps == 8 else _b16_to_8(S[..., 3])
            out[..., 3] = a
            if alpha == 2:
                out[..., :3] = _ua_to_aa(rgb, a[..., None].astype(np.int32))
    elif ph == 5:
        k = 255 - S[..., 3].astype(np.int32)
        out[..., :3] = (k[..., None] * (255 - S[..., :3].astype(np.int32)) // 255).astype(np.uint8)
    elif ph == 3:
        cmap = np.asarray(d.all(320), np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        out[..., :3] = (cmap.T[S[..., 0]] & 0xFF).astype(np.uint8)
    elif ph in (0, 1):
        v = S[..., 0] >> 8 if bps == 16 else S[..., 0]
        out[..., :3] = _grey_map(ph, bps)[v][..., None]
        if alpha and spp == 2 and bps == 8:
            out[..., 3] = S[..., 1]
    elif ph == 6:
        out[..., :3] = _ycbcr_to_rgb(d, S)
    else:
        out[..., :3] = _cielab_to_rgb(d, S, bps)
    return _orient_rgba(d, lay, out)


def _orient_rgba(d: _Ifd, lay: _Layout, out: np.ndarray) -> np.ndarray:
    """The RGBA route's mirroring of an Orientation of 2, 3, 6 or 7."""
    if d.get(274, 1) in (2, 3, 6, 7):
        # libtiff mirrors each strip or tile it is asked for (FLIP_HORIZONTALLY),
        # in place; OpenCV then orients the whole as if the page had been mirrored.
        for _, plane, y, x, _, rows, cols in lay.chunks():
            if plane == 0:
                out[y:y + rows, x:x + cols] = out[y:y + rows, x:x + cols][:, ::-1]
        out = out[:, ::-1]
    return out


def _sgilog_chunks(d: _Ifd, lay: _Layout, data: bytes, fmt: int, strict: bool):
    """Every strip or tile of SGILog data decoded by ``dg_sgilog_decode``
    (``fmt`` 0: float32 XYZ; 1: uint8 RGB for LogLuv, grey for LogL):
    yields (y, x, rows, cols, decoded chunk). ``strict``: a chunk whose data
    ends short raises (cv2's float route fails), else its missing rows
    stay zero (the RGBA route's zeroed strip buffer)."""
    comp, ph = d.get(259, 1), d.get(262)
    mode = 0 if ph == _LOGL else (1 if comp == 34676 else 2)
    shape = (3,) if ph == _LOGLUV else ()
    for k, _, y, x, stored, rows, cols in lay.chunks():
        raw = _raw(d, lay, data, k)
        out = np.zeros((stored, lay.cw) + shape, np.float32 if fmt == 0 else np.uint8)
        done = ctypes.c_int32(0)
        if native.image_codecs().dg_sgilog_decode(_ptr(raw), len(raw), mode, fmt, lay.cw, stored,
                                                  _ptr(out), ctypes.byref(done)) and strict:
            raise ValueError(f"SGILog data that ends short at row {y + done.value}")
        yield y, x, rows, cols, out


def _sgilog_float(d: _Ifd, lay: _Layout, data: bytes) -> np.ndarray:
    """LogLuv under IMREAD_UNCHANGED: libtiff's float XYZ, then OpenCV's
    ``cvtColor(XYZ2BGR)`` (float32 [H, W, 3], RGB order)."""
    if d.get(259, 1) not in _SGILOG:
        raise ValueError("LogLuv data without SGILog compression: libtiff has no "
                         "SGILOGDATAFMT to set")
    if lay.planar != 1:
        raise ValueError("SGILog compression cannot handle non-contiguous data")
    img = np.zeros((lay.h, lay.w, 3), np.float32)
    for y, x, rows, cols, part in _sgilog_chunks(d, lay, data, 0, strict=True):
        img[y:y + rows, x:x + cols] = part[:rows, :cols]
    img = orient(img, d.get(274, 1))
    native.image_codecs().dg_xyz_to_rgb(_ptr(img), img.shape[0], img.shape[1])
    return img


def _sgilog_rgba(d: _Ifd, lay: _Layout, data: bytes, colour: int) -> np.ndarray:
    """LogL or LogLuv through libtiff's RGBA interface: its 8-bit LogLuv
    conversion (SGILOGDATAFMT_8BIT) read as grey or RGB, alpha 255."""
    comp, ph = d.get(259, 1), d.get(262)
    if ph == _LOGL and comp != 34676:
        raise ValueError("TIFFRGBAImageOK: LogL data must have Compression=34676")
    if ph == _LOGLUV and (comp not in _SGILOG or lay.planar != 1 or lay.spp != 3
                          or colour != 3):
        raise ValueError("TIFFRGBAImageOK: LogLuv data must be SGILog-coded, contiguous, "
                         "3 samples")
    if ph == _LOGL and lay.spp != 1:
        raise ValueError("libtiff can not handle a LogL image of more than 1 sample")
    out = np.full((lay.h, lay.w, 4), 255, np.uint8)
    for y, x, rows, cols, part in _sgilog_chunks(d, lay, data, 1, strict=False):
        part = part[:rows, :cols]
        out[y:y + rows, x:x + cols, :3] = part if ph == _LOGLUV else part[..., None]
    return out


def _grey(rgb: np.ndarray, dtype) -> np.ndarray:
    """OpenCV's icvCvt_BGRA2Gray_*: 14-bit fixed-point 0.299 R + 0.587 G +
    0.114 B."""
    v = rgb.astype(np.int64)
    g = (v[..., 0] * 4899 + v[..., 1] * 9617 + v[..., 2] * 1868 + 8192) >> 14
    return g.astype(dtype)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An EXIF or TIFF Orientation applied (its eight cases), as OpenCV's
    ApplyExifOrientation applies it."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    for axis in {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_tiff(data: bytes, flags: int = IMREAD_UNCHANGED, imread: bool = False) -> np.ndarray:
    """TIFF bytes -> ``cv2.imdecode(data, flags)``'s array, RGB(A) order;
    with ``imread``, ``cv2.imread``'s of a file holding ``data``. The two
    differ twice: cv2.imread returns None for an Orientation of 5 to 8 on a
    page that is not square (its check that the decoder filled the matrix
    it was given fails on the transposed one), and it maps the file, so that word-aligned CCITT rows
    align to the file's offsets."""
    d = _Ifd(data, imread)
    _refuse_codec(d.get(259, 1))
    lay = _Layout(d)
    ph = d.get(262)
    if ph is None:
        raise ValueError("a TIFF without its PhotometricInterpretation")
    orientation = d.get(274, 1)
    if imread and orientation in (5, 6, 7, 8) and lay.w != lay.h:
        raise ValueError(f"cv2.imread returns None for a TIFF of Orientation {orientation} "
                         f"that is not square")
    if ph == _LOGLUV and lay.spp == 3 and flags == IMREAD_UNCHANGED:
        return _sgilog_float(d, lay, data)
    dtype, channels = _cv_type(ph, lay.spp, lay.bps, d.get(339, 1))
    if flags == IMREAD_COLOR:
        dtype, channels = np.uint8, 3
    if np.dtype(dtype).itemsize == 1:
        rgba = _rgba(d, lay, data)
        img = rgba if channels == 4 else rgba[..., :3] if channels == 3 else \
            _grey(rgba, np.uint8)
        img = img.view(dtype)
    else:
        if lay.planes > 1:
            raise NotImplementedError(
                f"a {lay.bps}-bit TIFF in separate planes: cv2 reads its first plane as if "
                f"interleaved and leaves the rest of its buffer unset, which the port does "
                f"not copy")
        if d.get(259, 1) not in _DECODED:
            raise ValueError(f"TIFF compression {d.get(259, 1)} is not one libtiff knows")
        S, short = _samples(d, lay, data, None)
        if short:
            raise ValueError("a TIFF strip or tile whose data ends short")
        if lay.bps in (*_PACKED, 16) and channels == 1 and lay.spp > 1:
            img = _grey(S.view(np.uint16), np.uint16).view(dtype)
        else:
            img = S[..., 0] if channels == 1 else S.astype(dtype)
        if lay.bps in _PACKED:          # scaled to 16 bits last, saturated to int16
            img = np.minimum(img.view(np.uint16).astype(np.int64) << (16 - lay.bps),
                             np.iinfo(dtype).max)
        img = img.astype(dtype)
    return orient(img, orientation)
