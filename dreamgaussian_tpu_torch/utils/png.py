"""PNG writer and reader of the port's own (zlib, no cv2, no PIL).

The writer emits 8-bit RGB or RGBA with filter type 0 (None) on every row.
The reader takes every PNG of the specification: colour types 0, 2, 3, 4
and 6 at each of their bit depths (1, 2, 4, 8 and 16), Adam7 interlacing,
``tRNS`` and ``PLTE``; ``csrc/image_codecs.cpp`` undoes the five row
filters. It returns what ``cv2.imread`` returns under ``IMREAD_UNCHANGED``,
channels in RGB order (OpenCV's ``grfmt_png.cpp`` on libpng): grey without
alpha as [H, W]; grey with alpha, RGB with ``tRNS`` and a palette with
``tRNS`` as 4 channels; RGB and a palette without ``tRNS`` as 3; 16-bit
samples as uint16 (``utils/imread.py`` derives ``IMREAD_COLOR`` from it,
as libpng's transforms do).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3|4] -> PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("encode_png takes a uint8 [H, W, 3] or [H, W, 4] array")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)      # filter byte 0 + the row
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h rows of a filter byte and ``stride`` bytes -> uint8 [h, stride]."""
    out = np.empty((h, stride), np.uint8)
    if h and stride and native.image_codecs().dg_png_unfilter(
            np.ascontiguousarray(raw).ctypes.data, h, stride, bpp, out.ctypes.data):
        raise ValueError("unknown PNG filter type")
    return out


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> integer samples [h, w, channels] (big-endian, MSB
    first below 8 bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w * channels]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, channels)


def _parse(data: bytes):
    """(header, palette, tRNS, samples [H, W, C] at the file's depth, eXIf)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off, header, plte, trns, exif, idat = 8, None, None, None, None, []
    while off + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        off += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"eXIf":
            exif = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace > 1 or not w or not h:
        raise ValueError(f"a PNG header out of the specification (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError("a palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    bpp = max(1, depth * channels // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * depth * channels + 7) // 8
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError("PNG data is shorter than its image")
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
        pos += n
    return header, plte, trns, out, exif


def imread_png(data: bytes) -> tuple[np.ndarray, bytes | None]:
    """PNG bytes -> (``cv2.imread(..., IMREAD_UNCHANGED)``'s array in RGB(A)
    order, the eXIf chunk or None)."""
    (w, h, depth, ctype, *_), plte, trns, s, exif = _parse(data)
    top = np.uint16(65535) if depth == 16 else np.uint8(255)
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:len(plte), :3] = plte
        pal[:, 3] = 255
        if trns:
            pal[:min(len(trns), 256), 3] = np.frombuffer(trns[:256], np.uint8)
        img = pal[s[..., 0]]
        if not trns:
            img = img[..., :3]
    elif ctype == 0:
        img = s[..., 0]                     # below 8 bits: libpng's expand_gray_1_2_4_to_8
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    elif ctype == 2 and trns and len(trns) >= 6:
        key = np.array(struct.unpack(">3H", trns[:6]), np.uint32)
        alpha = np.where((s.astype(np.uint32) == key).all(-1), 0, top).astype(s.dtype)
        img = np.dstack([s, alpha])
    elif ctype == 4:
        img = s[..., [0, 0, 0, 1]]
    else:
        img = s
    return np.ascontiguousarray(img), exif


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``cv2.imread(..., IMREAD_UNCHANGED)``'s array in RGB(A) order."""
    return imread_png(data)[0]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())
