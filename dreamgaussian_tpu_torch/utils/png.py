"""Small PNG writer and reader on ``zlib`` (no cv2, no PIL).

Covers what the mesh textures and the input images need: 8-bit RGB or
RGBA written; 8-bit grey, grey with alpha, RGB or RGBA read,
non-interlaced. The writer emits filter type 0 (None) on every row; the
reader undoes all five filter types (None, Sub, Up, Average, Paeth), so
files of other encoders at those formats read back too.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


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


def _unfilter_row(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct one row (uint8 [W*bpp]) from its filtered bytes."""
    if kind == 0:
        return cur
    if kind == 2:
        return cur + prev                           # uint8 wraps mod 256
    if kind == 1:
        # recon[x] = filt[x] + recon[x - bpp]: a running sum per channel.
        return np.cumsum(cur.reshape(-1, bpp).astype(np.uint64), axis=0) \
            .astype(np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    out = bytearray(cur.tobytes())
    up = prev.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit grey, grey+alpha, RGB or RGBA, non-interlaced) ->
    uint8 [H, W, 1|2|3|4]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    header = None
    idat = []
    while off < len(data):
        length, tag = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        off += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): 8-bit grey/RGB(A) non-interlaced only")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data has the wrong length")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())
