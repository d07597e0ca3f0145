"""BMP reader of the port's own (numpy, no cv2, no PIL), as OpenCV's
``grfmt_bmp.cpp`` reads a file, channels in RGB order.

Headers: OS/2 (12 bytes) and Windows (40 bytes and longer: V3, V4, V5).
Pixels: 1-, 4- and 8-bit palettes, ``BI_RLE4``, ``BI_RLE8``, 16-bit (5-5-5,
or 5-6-5 by ``BI_BITFIELDS``), 24-bit, 32-bit; bottom-up and top-down.
OpenCV's rules, copied:

- a palette whose entries are all grey reads as [H, W] under
  ``IMREAD_UNCHANGED``, any other as 3 channels; every OS/2 file reads as
  [H, W] under ``IMREAD_UNCHANGED``, its colours turned grey by OpenCV's
  fixed-point BT.601 weights (``(b*1868 + g*9617 + r*4899 + 8192) >> 14``);
- 32-bit ``BI_BITFIELDS`` (the V4/V5 files with an alpha mask) reads as 4
  channels, the bytes taken as B, G, R, A whatever the masks say; 32-bit
  ``BI_RGB`` as 3, its fourth byte dropped;
- 16-bit samples are widened by a shift (``t << 3 & 0xf8``), not scaled;
- a run-length file's skipped pixels (end of line, delta, end of bitmap)
  take palette entry 0.
"""

from __future__ import annotations

import struct

import numpy as np

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _rle(data: bytes, off: int, w: int, h: int, bpp: int) -> np.ndarray:
    """Palette indices [h, w] (file row order) of a BI_RLE8/BI_RLE4 stream;
    skipped pixels index 0."""
    out = np.zeros(h * w, np.uint8)
    pos, x, y, n = off, 0, 0, len(data)
    while y < h and pos + 2 <= n:
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:                                   # a run of one (or two alternating) colours
            if x + count > w:
                break
            vals = [code] if bpp == 8 else [code >> 4, code & 15]
            out[y * w + x:y * w + x + count] = np.resize(np.array(vals, np.uint8), count)
            x += count
        elif code > 2:                              # absolute: ``code`` literal pixels
            if x + code > w:
                break
            size = (code + 1) & ~1 if bpp == 8 else (((code + 1) >> 1) + 1) & ~1
            lit = np.frombuffer(data, np.uint8, min(size, n - pos), pos)
            if bpp == 4:
                lit = np.stack([lit >> 4, lit & 15], -1).reshape(-1)
            out[y * w + x:y * w + x + code] = lit[:code]
            x += code
            pos += size
        elif code == 0:                             # end of line
            y, x = y + 1, 0
        elif code == 1:                             # end of bitmap
            break
        else:                                       # delta: right, then down
            if pos + 2 > n:
                break
            y, x = divmod(y * w + x + data[pos] + data[pos + 1] * w, w)
            pos += 2
    return out.reshape(h, w)


def decode_bmp(data: bytes, flags: int = -1) -> np.ndarray:
    """BMP bytes -> ``cv2.imread``'s array (``flags`` -1 or 1), RGB order."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError("not a BMP file")
    offset, size = struct.unpack_from("<II", data, 10)
    if size >= 36:
        w, h, planes_bpp, comp = struct.unpack_from("<iiIi", data, 18)
        bpp = planes_bpp >> 16
        clrused = struct.unpack_from("<i", data, 46)[0]
        pal_off, entry = 14 + size, 4
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
            or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
            or (bpp == 4 and comp == _RLE4) or (bpp == 8 and comp == _RLE8))
    elif size == 12:
        w, h, planes_bpp = struct.unpack_from("<HHI", data, 18)
        bpp, comp, clrused, pal_off, entry = planes_bpp >> 16, _RGB, 0, 26, 3
        ok = w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)
    else:
        raise ValueError(f"a BMP header of {size} bytes")
    if not ok:
        raise ValueError(f"a {bpp}-bit BMP with compression {comp} is not read by cv2")
    palette = np.zeros((256, 3), np.uint8)          # B, G, R
    channels = 3 if size >= 36 else 1
    if bpp <= 8:
        n = (clrused or 1 << bpp) if size >= 36 else 1 << bpp
        if not 0 <= n <= 256:
            raise ValueError("a BMP palette of more than 256 entries")
        raw = np.frombuffer(data, np.uint8, n * entry, pal_off).reshape(n, entry)
        palette[:n] = raw[:, :3]
        used = palette[:1 << bpp]
        if size >= 36 and not ((used[:, 0] != used[:, 1]) | (used[:, 1] != used[:, 2])).any():
            channels = 1
    elif bpp == 16:
        if comp == _BITFIELDS:
            masks = struct.unpack_from("<3I", data, 14 + size)   # red, green, blue
            if masks == (0xF800, 0x7E0, 0x1F):
                bpp = 16
            elif masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            else:
                raise ValueError(f"16-bit BMP masks {masks} are not read by cv2")
        else:
            bpp = 15
    elif bpp == 32 and comp == _BITFIELDS:
        channels = 4
    height = abs(h)
    if comp in (_RLE8, _RLE4):
        img = palette[_rle(data, offset, w, height, bpp)]
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        rows = np.frombuffer(data, np.uint8, pitch * height, offset).reshape(height, pitch)
        if bpp <= 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(height, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)).sum(-1, dtype=np.uint8)
            img = palette[idx]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                img = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
            else:
                img = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
            img = img.astype(np.uint8)
        else:
            img = rows[:, :w * (bpp // 8)].reshape(height, w, bpp // 8)
            img = img[..., :4 if channels == 4 else 3]
    if h > 0:
        img = img[::-1]
    if flags == 1 or channels == 3:
        img = img[..., :3]
    elif channels == 1:
        b, g, r = (img[..., k].astype(np.int32) for k in range(3))
        img = ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return np.ascontiguousarray(img)
