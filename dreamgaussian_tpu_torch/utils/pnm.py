"""PNM and PAM reader of the port's own (numpy, no cv2, no PIL), as
OpenCV's ``grfmt_pxm.cpp`` (P1-P6) and ``grfmt_pam.cpp`` (P7) read a file.

OpenCV's rules, copied (arrays returned with OpenCV's channel order
reversed, as every reader of the port returns RGB where cv2 returns BGR):

- P1-P6: ``maxval`` above 255 gives uint16 samples, taken as stored;
  ASCII samples of 8 bits are scaled by ``v * 255 // maxval`` (and clamped
  to ``maxval`` first), binary ones are not; bitmaps (P1, P4) read 1 as 0
  and 0 as 255; RGB (P3, P6) is turned into BGR;
- P7 (PAM): the channels as stored, ``DEPTH`` of them (OpenCV takes them
  as B, G, R, A), ``maxval`` above 255 giving uint16; under
  ``IMREAD_COLOR`` a 3-channel file is copied as stored, and a 2- or
  4-channel one raises NotImplementedError: OpenCV converts only the first
  ``ceil(WIDTH / DEPTH)`` pixels of each row and leaves the rest of its
  output unwritten;
- ``IMREAD_COLOR``: grey repeated, 16-bit samples shifted right by 8.
"""

from __future__ import annotations

import re

import numpy as np

_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n?)*(\d+)")


def _number(data: bytes, pos: int) -> tuple[int, int]:
    """The decimal number after whitespace and comments at ``pos``; the
    position after its one terminating character."""
    m = _TOKEN.match(data, pos)
    if not m:
        raise ValueError("a PNM header without its numbers")
    return int(m.group(1)), m.end() + 1


def _color(img: np.ndarray, flags: int) -> np.ndarray:
    """OpenCV's array (B, G, R order) -> the port's, under ``flags``."""
    if flags == 1:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return np.ascontiguousarray(img)


def _pam(data: bytes, flags: int) -> np.ndarray:
    fields, pos = {}, 3
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError("a PAM header without ENDHDR")
        line = data[pos:end].strip()
        pos = end + 1
        if line == b"ENDHDR":
            break
        if line and not line.startswith(b"#"):
            key, _, value = line.partition(b" ")
            fields.setdefault(key.decode("ascii", "replace"), value.strip().decode("ascii", "replace"))
    try:
        w, h, c, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError("a PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL") from None
    if maxval == 1 or not (0 < maxval <= 65535) or w <= 0 or h <= 0 or c <= 0:
        raise NotImplementedError(f"a PAM file with maxval {maxval} and depth {c}")
    dtype = ">u2" if maxval > 255 else np.uint8
    img = np.frombuffer(data, dtype, w * h * c, pos).reshape(h, w, c).astype(
        np.uint16 if maxval > 255 else np.uint8)
    if c == 1:
        return _color(img[..., 0], flags)
    if flags == 1 and c != 3:
        # OpenCV's conversion steps through the row by DEPTH samples per
        # pixel but stops after WIDTH samples: the rest of the row is left
        # as the allocator gave it.
        raise NotImplementedError(f"a {c}-channel PAM file under IMREAD_COLOR, which cv2 "
                                  f"fills only in part")
    return _color(img, flags)


def decode_pnm(data: bytes, flags: int = -1) -> np.ndarray:
    """P1-P7 bytes -> ``cv2.imread``'s array (``flags`` -1 or 1), RGB order."""
    if len(data) < 3 or data[:1] != b"P" or data[1:2] not in b"1234567":
        raise ValueError("not a PNM file")
    kind = data[1] - ord("0")
    if kind == 7:
        return _pam(data, flags)
    w, pos = _number(data, 2)
    h, pos = _number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _number(data, pos)
    if not (0 < maxval <= 65535) or w <= 0 or h <= 0:
        raise ValueError("a PNM header out of range")
    c = 3 if kind in (3, 6) else 1
    if kind in (1, 4):
        if kind == 1:
            vals = np.array([int(t) != 0 for t in re.findall(rb"[01]", data[pos:])[:w * h]],
                            np.uint8)
        else:
            pitch = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
            vals = np.unpackbits(rows, axis=1)[:, :w]
        img = np.where(vals.reshape(h, w) != 0, 0, 255).astype(np.uint8)
        return _color(img, flags)
    deep = maxval > 255
    if kind in (2, 3):
        nums = np.array(re.findall(rb"\d+", data[pos - 1:])[:w * h * c], np.int64)
        nums = np.minimum(nums, maxval)
        img = nums.astype(np.uint16) if deep else (nums * 255 // maxval).astype(np.uint8)
    else:
        img = np.frombuffer(data, ">u2" if deep else np.uint8, w * h * c, pos).astype(
            np.uint16 if deep else np.uint8)
    img = img.reshape(h, w, c)
    return _color(img[..., ::-1] if c == 3 else img[..., 0], flags)
