"""Radiance HDR reader of the port's own (no cv2), on the host.

``decode_hdr(data, flags)`` returns what ``cv2.imread`` (OpenCV 5.0's
``HdrDecoder`` over its ``rgbe.cpp``) returns, channels in RGB order:

- the header as ``RGBE_ReadHeader`` reads it without its info block: lines
  of at most 127 bytes (``fgets`` into 128), skipped up to the first empty
  one; a ``FORMAT=32-bit_rle_rgbe`` line among them is required (cv2 reads
  no other format, ``32-bit_rle_xyze`` included); then the resolution line,
  of which ``sscanf("-Y %d +X %d")`` takes only the top-down, left-to-right
  orientation (cv2 refuses ``+Y``, ``-X`` and column-major files);
- the pixels in ``csrc/image_codecs.cpp`` ``dg_hdr_decode``: new-style RLE
  scanlines, flat RGBE pixels for widths outside 8..32767 or from the
  first scanline that does not start with 2, 2; each pixel's mantissas
  times ``ldexp(1, e - 136)``, an exponent of 0 giving 0;
- ``IMREAD_UNCHANGED``: float32 [H, W, 3]; ``IMREAD_COLOR``: uint8 [H, W, 3]
  by OpenCV's ``convertTo`` with a scale of 255 (float32 product rounded
  half to even and saturated; a product beyond the int32 range gives 0,
  as its ``cvRound`` does).

Where cv2 returns None (no ``FORMAT`` line, another orientation, a size of
0, data that ends short, a scanline of another width, a run that overruns
its channel) ``decode_hdr`` raises ValueError.
"""

from __future__ import annotations

import re

import numpy as np

from .. import native

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1
SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SPACE = rb"[ \t\n\v\f\r]*"
_INT = _SPACE + rb"([+-]?\d+)"
_RESOLUTION = re.compile(b"-Y" + _INT + _SPACE + b"\\+X" + _INT)


def _lines(data: bytes):
    """``fgets(buf, 128, fp)`` over ``data``: (line, offset after it)."""
    pos = 0
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(data)) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def _c_int(text: bytes) -> int:
    """``%d``'s value: glibc's ``strtol`` clamped to a long, stored to an int."""
    v = max(-(1 << 63), min(int(text), (1 << 63) - 1))
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def float_to_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's float32 -> uint8 conversion: ``cvRound`` (half to even; 0
    outside the int32 range and for NaN), saturated to 0..255."""
    ok = (img >= np.float32(-2.0 ** 31)) & (img < np.float32(2.0 ** 31))
    return np.where(ok, np.clip(np.rint(np.where(ok, img, 0)), 0, 255), 0).astype(np.uint8)


def check_size(h: int, w: int, fmt: str) -> None:
    """OpenCV's limits on a decoded size (``validateInputImageSize``)."""
    if h <= 0 or w <= 0 or h > 1 << 20 or w > 1 << 20 or h * w > 1 << 30:
        raise ValueError(f"a {fmt} of {h} x {w} pixels")


def header(data: bytes) -> tuple[int, int, int]:
    """(height, width, offset of the pixels) as ``RGBE_ReadHeader`` reads
    them; ValueError where it fails or the size is not positive."""
    lines = _lines(data)
    has_format = False
    for line, end in lines:
        if line[:1] == b"\n":
            break
        has_format |= line.split(b"\0")[0] == _FORMAT
    else:
        raise ValueError("a Radiance HDR header without its empty line")
    if not has_format:
        raise ValueError("a Radiance HDR header without FORMAT=32-bit_rle_rgbe")
    line, end = next(lines, (None, 0))
    match = None if line is None else _RESOLUTION.match(line.split(b"\0")[0])
    if match is None:
        raise ValueError("a Radiance HDR resolution other than -Y <height> +X <width>")
    h, w = _c_int(match.group(1)), _c_int(match.group(2))
    check_size(h, w, "Radiance HDR")
    return h, w, end


def decode_hdr(data: bytes, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """Radiance HDR bytes -> ``cv2.imread``'s array, RGB order."""
    h, w, at = header(data)
    raw = np.frombuffer(data, np.uint8, offset=at)
    rgb = np.empty((h, w, 3), np.float32)
    code = native.image_codecs().dg_hdr_decode(raw.ctypes.data, len(raw), w, h, rgb.ctypes.data)
    if code:
        raise ValueError({1: "Radiance HDR pixels that end short",
                          2: "a Radiance HDR scanline of another width",
                          3: "Radiance HDR run-length data that overruns its scanline"}[code])
    if flags == IMREAD_COLOR:
        with np.errstate(over="ignore"):
            return float_to_u8(rgb * np.float32(255))
    return rgb
