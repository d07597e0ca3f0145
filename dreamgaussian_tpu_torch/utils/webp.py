"""WebP reader of the port's own (no cv2, no PIL), on the host.

Python reads the RIFF container (``VP8 ``, ``VP8L``, ``VP8X`` with
``ALPH``, ``ANIM``/``ANMF`` and ``EXIF``); ``csrc/image_codecs.cpp`` (built
by ``native.py``) decodes the bitstreams: VP8L (lossless) in full, VP8
(lossy) key frames with libwebp's fancy chroma upsampling and fixed-point
YUV->RGB, and the ALPH plane's filters. The result equals what
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives (cv2 decodes through
libwebp's ``WebPDecodeBGR(A)``), channels in RGB order, bit for bit:

- 4 channels when the file declares alpha (VP8X's alpha flag, or the VP8L
  header's alpha bit for a lossless image), else 3;
- an animated file gives its first frame on a transparent black canvas, as
  libwebp's animation decoder composes it.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02


def _chunks(data: bytes, off: int, end: int):
    """(fourcc, payload) of each RIFF chunk in data[off:end]."""
    while off + 8 <= end:
        tag = data[off:off + 4]
        size = struct.unpack_from("<I", data, off + 4)[0]
        if off + 8 + size > end:
            raise ValueError("a WebP chunk runs past the end of the file")
        yield tag, data[off + 8:off + 8 + size]
        off += 8 + size + (size & 1)


def _vp8l_info(payload: bytes) -> tuple[int, int, bool]:
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError("a VP8L chunk without its signature")
    bits = struct.unpack_from("<I", payload, 1)[0]
    if bits >> 29:
        raise ValueError("a VP8L stream of an unknown version")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def _vp8_info(payload: bytes) -> tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a VP8 chunk without a key frame")
    return (struct.unpack_from("<H", payload, 6)[0] & 0x3FFF,
            struct.unpack_from("<H", payload, 8)[0] & 0x3FFF)


def _lossless(stream: bytes, w: int, h: int) -> np.ndarray:
    """A VP8L image stream -> uint32 ARGB [h, w]."""
    buf = np.frombuffer(stream, np.uint8)
    argb = np.empty((h, w), np.uint32)
    if native.image_codecs().dg_webp_vp8l(buf.ctypes.data, len(buf), w, h, argb.ctypes.data):
        raise ValueError("a malformed VP8L stream")
    return argb


def _alpha(alph: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk -> uint8 [h, w] (libwebp's alpha_dec.c)."""
    if not alph:
        raise ValueError("an empty ALPH chunk")
    method, filt = alph[0] & 3, (alph[0] >> 2) & 3
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("an ALPH chunk shorter than its plane")
        plane = np.frombuffer(alph, np.uint8, w * h, 1).reshape(h, w).copy()
    elif method == 1:
        plane = ((_lossless(alph[1:], w, h) >> 8) & 0xFF).astype(np.uint8)
    else:
        raise ValueError(f"an ALPH chunk of unknown compression {method}")
    if filt:
        native.image_codecs().dg_webp_alpha_unfilter(plane.ctypes.data, w, h, filt)
    return plane


def _frame(image: tuple[bytes, bytes], alph: bytes | None, w: int, h: int,
           channels: int) -> np.ndarray:
    """One bitstream (``(fourcc, payload)``) of w x h -> uint8 [h, w, channels]."""
    tag, payload = image
    if tag == b"VP8L":
        if _vp8l_info(payload)[:2] != (w, h):
            raise ValueError("a VP8L stream whose size differs from its canvas")
        argb = _lossless(payload[5:], w, h)
        shifts = (16, 8, 0, 24)[:channels]
        return np.stack([((argb >> s) & 0xFF).astype(np.uint8) for s in shifts], axis=-1)
    out = np.full((h, w, channels), 255, np.uint8)
    buf = np.frombuffer(payload, np.uint8)
    ret = native.image_codecs().dg_webp_vp8(buf.ctypes.data, len(buf), w, h, out.ctypes.data,
                                            channels)
    if ret:
        raise ValueError(f"a malformed VP8 frame (code {ret})")
    if channels == 4 and alph is not None:
        out[..., 3] = _alpha(alph, w, h)
    return out


def decode_webp(data: bytes) -> tuple[np.ndarray, bytes | None]:
    """WebP bytes -> (uint8 [H, W, 3|4] RGB(A), the EXIF chunk or None)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("a WebP file without chunks")
    tag, payload = chunks[0]
    if tag == b"VP8 ":
        w, h = _vp8_info(payload)
        return _frame(chunks[0], None, w, h, 3), None
    if tag == b"VP8L":
        w, h, alpha = _vp8l_info(payload)
        return _frame(chunks[0], None, w, h, 4 if alpha else 3), None
    if tag != b"VP8X" or len(payload) < 10:
        raise ValueError(f"a WebP file that starts with a {tag!r} chunk")
    flags = payload[0]
    cw = int.from_bytes(payload[4:7], "little") + 1
    ch = int.from_bytes(payload[7:10], "little") + 1
    exif = next((p for t, p in chunks if t == b"EXIF"), None)
    if flags & _ANIMATION_FLAG:
        frame = next((p for t, p in chunks if t == b"ANMF"), None)
        if frame is None or len(frame) < 16:
            raise ValueError("an animated WebP without a frame")
        fx, fy = 2 * int.from_bytes(frame[0:3], "little"), 2 * int.from_bytes(frame[3:6], "little")
        fw, fh = int.from_bytes(frame[6:9], "little") + 1, int.from_bytes(frame[9:12], "little") + 1
        if fx + fw > cw or fy + fh > ch:
            raise ValueError("an animation frame outside its canvas")
        sub = list(_chunks(frame, 16, len(frame)))
        image = next(((t, p) for t, p in sub if t in (b"VP8 ", b"VP8L")), None)
        if image is None:
            raise ValueError("an animation frame without a bitstream")
        alph = next((p for t, p in sub if t == b"ALPH"), None)
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[fy:fy + fh, fx:fx + fw] = _frame(image, alph, fw, fh, 4)
        return (canvas if flags & _ALPHA_FLAG else np.ascontiguousarray(canvas[..., :3])), exif
    image = next(((t, p) for t, p in chunks if t in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise ValueError("a WebP file without a bitstream")
    alpha = bool(flags & _ALPHA_FLAG)
    alph = None
    if image[0] == b"VP8L":
        alpha = _vp8l_info(image[1])[2]
    else:
        alph = next((p for t, p in chunks if t == b"ALPH"), None)
        alpha = alpha or alph is not None
    return _frame(image, alph, cw, ch, 4 if alpha else 3), exif
