"""Sun raster reader of the port's own (no cv2), on the host.

``decode_sunras(data, flags)`` returns what OpenCV 5.0's
``SunRasterDecoder`` gives ``cv2.imread``, channels in RGB order:

- the 32-byte big-endian header: width and height above 0, a depth of 1,
  8, 24 or 32, the types ``RT_OLD`` (0) and ``RT_STANDARD`` (1), and either
  no colormap or an ``RMT_EQUAL_RGB`` one of at most 3 x 2^depth bytes for
  a depth of 8 or less (its red, green and blue thirds, entries past it
  black). cv2 refuses the rest: ``RT_BYTE_ENCODED`` (2) and
  ``RT_FORMAT_RGB`` (3) files among them, since its header check compares
  the type with the decoder's matrix type, not the file's;
- rows padded to 16 bits; 1-bit pixels most significant bit first;
  24-bit pixels stored blue, green, red; 32-bit pixels a pad byte then
  blue, green, red;
- ``IMREAD_UNCHANGED``: 3 channels for 24 and 32 bits and for a colormap
  whose entries are not all grey, else 1 channel: a grey colormap's
  entries through OpenCV's fixed-point grey (equal to them), and, where
  there is no colormap, zeros (cv2 fills its grey table only from a
  colormap); ``IMREAD_COLOR``: 3 channels, the colormap or, without one,
  the grey ramp (0 and 255 for 1 bit).

Where cv2 returns None (a header it refuses, a colormap or pixel rows that
end short) ``decode_sunras`` raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from .hdr import check_size

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1
SIGNATURE = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD = 0, 1
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def _grey(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u: 14-bit fixed-point weights."""
    v = bgr.astype(np.int64)
    return ((v[..., 0] * 1868 + v[..., 1] * 9617 + v[..., 2] * 4899 + 8192) >> 14).astype(np.uint8)


def decode_sunras(data: bytes, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """Sun raster bytes -> ``cv2.imread``'s array, RGB order."""
    if len(data) < 32 or not data.startswith(SIGNATURE):
        raise ValueError("a Sun raster header that ends short")
    w, h, depth, _, kind, maptype, maplength = struct.unpack_from(">7i", data, 4)
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (w > 0 and h > 0 and depth in (1, 8, 24, 32) and kind in (RT_OLD, RT_STANDARD)
            and ((maptype == RMT_NONE and maplength == 0)
                 or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size and depth <= 8))):
        raise ValueError(f"a Sun raster cv2 refuses (depth {depth}, type {kind}, colormap "
                         f"type {maptype} of {maplength} bytes)")
    check_size(h, w, "Sun raster")
    # The palette as OpenCV keeps it: 256 BGR entries, zero past the map.
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        cmap = np.frombuffer(data, np.uint8, count=maplength, offset=32) \
            if len(data) >= 32 + maplength else None
        if cmap is None:
            raise ValueError("a Sun raster colormap that ends short")
        n = maplength // 3
        palette[:n] = np.stack([cmap[2 * n:3 * n], cmap[n:2 * n], cmap[:n]], -1)
        colour = bool((palette[:1 << depth] != palette[:1 << depth, :1]).any())
    else:
        colour = depth > 8
        if depth <= 8:
            ramp = np.arange(1 << depth) * 255 // ((1 << depth) - 1)
            palette[:1 << depth] = ramp[:, None].astype(np.uint8)
    pitch = ((w * depth + 7) // 8 + 1) & -2
    at = 32 + maplength
    if len(data) - at < h * pitch:
        raise ValueError("Sun raster rows that end short")
    rows = np.frombuffer(data, np.uint8, count=h * pitch, offset=at).reshape(h, pitch)
    three = colour or flags == IMREAD_COLOR
    if depth == 24:
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    if depth == 32:
        return np.ascontiguousarray(rows[:, :4 * w].reshape(h, w, 4)[..., :0:-1])
    idx = np.unpackbits(rows, axis=1)[:, :w] if depth == 1 else rows[:, :w]
    if three:
        return np.ascontiguousarray(palette[idx][..., ::-1])
    grey = _grey(palette) if maptype == RMT_EQUAL_RGB else np.zeros(256, np.uint8)
    return grey[idx]
