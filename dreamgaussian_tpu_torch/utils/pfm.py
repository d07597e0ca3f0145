"""PFM (Portable Float Map) reader of the port's own (no cv2), on the host.

``decode_pfm(data, flags, imread)`` returns what OpenCV 5.0's
``PFMDecoder`` gives ``cv2.imdecode`` (with ``imread``, ``cv2.imread``),
channels in RGB order:

- the header: ``PF`` (3 channels) or ``Pf`` (1), a line feed, then the
  width, the height and the scale, each read up to the next whitespace byte
  (at most 2048 bytes) by ``atoi`` and ``atof``, so that one separator is
  taken and a second gives an empty number;
- the scale's sign is the byte order (negative little-endian, otherwise
  big-endian), and rows are stored bottom-up;
- the samples times ``1 / |scale|`` (OpenCV's ``convertTo``: a copy where
  that factor is 1 within DBL_EPSILON, else a float32 product plus 0, so a
  negative zero becomes 0); a scale of 0 or NaN gives None;
- ``IMREAD_UNCHANGED``: float32 [H, W, 3] or [H, W]; ``IMREAD_COLOR``: the
  same samples converted to uint8 without scaling (rounded half to even,
  saturated); a one-channel file stays one channel there, which
  ``cv2.imdecode`` returns as [H, W] uint8 and ``cv2.imread`` refuses
  (None), its check that the decoder filled the 3-channel matrix failing.

Where cv2 returns None or raises (a width or height that is not positive,
data that ends short) ``decode_pfm`` raises ValueError.
"""

from __future__ import annotations

import re

import numpy as np

from .hdr import check_size, float_to_u8

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1
_WHITESPACE = b" \t\n\v\f\r"
_INT = re.compile(rb"[ \t\n\v\f\r]*([+-]?\d+)")
_FLOAT = re.compile(rb"[ \t\n\v\f\r]*([+-]?(?:inf(?:inity)?|nan(?:\([0-9a-z_]*\))?|"
                    rb"0x(?:[0-9a-f]+\.?[0-9a-f]*|\.[0-9a-f]+)(?:p[+-]?\d+)?|"
                    rb"(?:\d+\.?\d*|\.\d+)(?:e[+-]?\d+)?))", re.IGNORECASE)


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """``read_number``'s bytes: up to the next whitespace byte (taken) or
    2048 bytes, the string ending at a NUL; ValueError at the data's end."""
    out = bytearray()
    for k in range(2048):
        if pos >= len(data):
            raise ValueError("a PFM header that ends short")
        c = data[pos]
        pos += 1
        if c in _WHITESPACE:
            break
        out.append(c)
    return bytes(out).split(b"\0")[0], pos


def _atoi(text: bytes) -> int:
    m = _INT.match(text)
    if m is None:
        return 0
    v = max(-(1 << 63), min(int(m.group(1)), (1 << 63) - 1))
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _atof(text: bytes) -> float:
    m = _FLOAT.match(text)
    if m is None:
        return 0.0
    s = m.group(1).decode().lower()
    sign = -1.0 if s.startswith("-") else 1.0
    s = s.lstrip("+-")
    if s.startswith("nan"):
        return float("nan")
    if s.startswith("inf"):
        return sign * float("inf")
    if s.startswith("0x"):
        body = s[2:]
        if "p" not in body:
            body += "p0"
        if body.startswith("."):
            body = "0" + body
        return sign * float.fromhex(body)
    return sign * float(s)


def decode_pfm(data: bytes, flags: int = IMREAD_UNCHANGED, imread: bool = False) -> np.ndarray:
    """PFM bytes -> ``cv2.imdecode``'s array (``imread``: ``cv2.imread``'s), RGB order."""
    if len(data) < 3 or data[:1] != b"P" or data[1:2] not in (b"f", b"F"):
        raise ValueError("not a PFM file")
    channels = 3 if data[1:2] == b"F" else 1
    if data[2:3] != b"\n":
        raise ValueError("a PFM header whose type is not followed by a line feed")
    pos = 3
    text, pos = _token(data, pos)
    w = _atoi(text)
    text, pos = _token(data, pos)
    h = _atoi(text)
    text, pos = _token(data, pos)
    scale = _atof(text)
    check_size(h, w, "PFM")
    if flags == IMREAD_COLOR and channels == 1 and imread:
        raise ValueError("cv2.imread returns None for a one-channel PFM under IMREAD_COLOR")
    row = w * channels * 4
    if len(data) - pos < h * row:
        raise ValueError("PFM samples that end short")
    order = ">" if scale >= 0 else "<"        # NaN compares false: little-endian
    img = np.frombuffer(data, order + "f4", count=h * w * channels, offset=pos)
    img = img.reshape(h, w, channels)[::-1].astype(np.float32)
    if not abs(scale) > 0:
        raise ValueError(f"a PFM scale of {scale}")
    alpha = 1.0 / abs(scale)
    if abs(alpha - 1) >= np.finfo(np.float64).eps:
        with np.errstate(over="ignore", under="ignore"):
            img = img * np.float32(alpha) + np.float32(0)
    if channels == 1:
        img = img[..., 0]
    return float_to_u8(img) if flags == IMREAD_COLOR else np.ascontiguousarray(img)
