"""Animated GIF89a writer and reader (numpy and the standard library only).

The port's counterpart of ``imageio.mimwrite(path, frames,
duration=1000 / fps, loop=0)``: every frame gets a 256-colour palette of its
own (a local colour table), the frame delay is written in centiseconds
(``int(1000 / fps / 10)``, as Pillow writes imageio's duration), and the
NETSCAPE2.0 block loops the animation forever. A frame with at most 256
colours keeps them exactly; one with more is reduced by median cut: the
colour box with the widest channel range is split at the pixel-weighted
median of that channel until there are 256 boxes, and each box's pixels
take its pixel-weighted mean colour.

Pixels are LZW-coded as giflib codes them (8-bit roots, codes of 9 to 12
bits, a clear code when the table is full); the dictionary walk is a
Python loop, the bit packing numpy. Both readers share one block walker
and one LZW decoder (``csrc/image_codecs.cpp``): ``read_gif`` decodes what
``write_gif`` writes (and other GIFs whose frames fill the screen): it
returns the frames as RGB and the delay. ``imread_gif`` is ``cv2.imread``
of any GIF: its first frame, by OpenCV's rules.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from .. import native

_MIN_CODE = 8
_CLEAR, _EOI = 1 << _MIN_CODE, (1 << _MIN_CODE) + 1
_MAX_CODE = 4095


def _split(box: np.ndarray, colors: np.ndarray, counts: np.ndarray):
    """Split a box of colour indices at the weighted median of its widest channel."""
    ch = int(np.argmax(colors[box].max(0) - colors[box].min(0)))
    order = box[np.argsort(colors[box, ch], kind="stable")]
    cum = np.cumsum(counts[order])
    cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0) + 1, 1, len(order) - 1))
    return order[:cut], order[cut:]


def quantize(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 [H, W, 3] -> (palette uint8 [<=256, 3], indices uint8 [H, W]);
    ``palette[indices]`` is the frame as the GIF holds it."""
    flat = np.ascontiguousarray(frame, np.uint8).reshape(-1, 3).astype(np.int64)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
    if len(uniq) <= 256:
        return colors.astype(np.uint8), inverse.reshape(frame.shape[:2]).astype(np.uint8)
    def span(box):
        return int((colors[box].max(0) - colors[box].min(0)).max())

    boxes = [np.arange(len(uniq))]
    spans = [span(boxes[0])]
    while len(boxes) < 256:       # more than 256 colours: no box is left of span 0
        i = int(np.argmax(spans))
        spans.pop(i)
        for half in _split(boxes.pop(i), colors, counts):
            boxes.append(half)
            spans.append(span(half))
    label = np.zeros(len(uniq), np.int64)
    palette = np.zeros((len(boxes), 3), np.uint8)
    for j, box in enumerate(boxes):
        label[box] = j
        w = counts[box].astype(np.float64)
        palette[j] = np.rint((colors[box] * w[:, None]).sum(0) / w.sum())
    return palette, label[inverse].reshape(frame.shape[:2]).astype(np.uint8)


def _lzw_codes(pixels: bytes) -> tuple[list, list]:
    """giflib's LZW: (codes, their bit widths)."""
    codes, widths = [_CLEAR], [_MIN_CODE + 1]
    width, nxt, table = _MIN_CODE + 1, _EOI + 1, {}
    w = pixels[0]
    for k in pixels[1:]:
        key = (w << 8) | k
        c = table.get(key)
        if c is not None:
            w = c
            continue
        codes.append(w)
        widths.append(width)
        if nxt >= (1 << width):
            width += 1
        if nxt >= _MAX_CODE:
            codes.append(_CLEAR)
            widths.append(width)
            width, nxt, table = _MIN_CODE + 1, _EOI + 1, {}
        else:
            table[key] = nxt
            nxt += 1
        w = k
    codes.append(w)
    widths.append(width)
    if nxt >= (1 << width):
        width += 1
    codes.append(_EOI)
    widths.append(width)
    return codes, widths


def _pack_bits(codes: list, widths: list) -> bytes:
    """Codes packed least significant bit first."""
    c = np.asarray(codes, np.int64)[:, None]
    bits = (c >> np.arange(12)) & 1
    keep = np.arange(12)[None, :] < np.asarray(widths)[:, None]
    return np.packbits(bits[keep].astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out + b"\x00")


def encode_gif(frames, fps: float = 15) -> bytes:
    """uint8 [H, W, 3] frames of one size -> an endlessly looping GIF89a."""
    frames = [np.asarray(f) for f in frames]
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) or f.dtype != np.uint8 for f in frames):
        raise ValueError("encode_gif takes uint8 [H, W, 3] frames of one size")
    delay = int(1000.0 / fps / 10)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0x70, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for f in frames:
        palette, idx = quantize(f)
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + table.tobytes()
        out += bytes([_MIN_CODE]) + _sub_blocks(_pack_bits(*_lzw_codes(idx.tobytes())))
    return bytes(out + b"\x3b")


def write_gif(path: str, frames, fps: float = 15) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_gif(frames, fps))


def _table(data: bytes, pos: int, packed: int) -> tuple[np.ndarray, int]:
    """The colour table that ``packed`` announces at ``pos``, padded to 256
    entries, and the position after it."""
    n = 2 << (packed & 7)
    table = np.zeros((256, 3), np.uint8)
    table[:n] = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
    return table, pos + 3 * n


def _sub_block_data(data: bytes, pos: int) -> tuple[bytes, int]:
    """The joined sub-blocks at ``pos`` and the position after their terminator."""
    parts = []
    while pos < len(data) and data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def _indices(codes: bytes, min_code: int, w: int, h: int, interlaced: bool):
    """An image's LZW codes -> (colour indices uint8 [h, w], how many were
    decoded before the codes ended); the rows of an interlaced image are put
    back in order."""
    idx = np.zeros(w * h, np.uint8)
    buf = np.frombuffer(codes, np.uint8)
    done = np.zeros(1, np.int64)
    if native.image_codecs().dg_gif_lzw(buf.ctypes.data, len(buf), min_code, idx.ctypes.data,
                                        idx.size, done.ctypes.data):
        raise ValueError("malformed GIF LZW codes")
    idx = idx.reshape(h, w)
    if interlaced:                                          # rows in four passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    return idx, int(done[0])


def _walk(data: bytes):
    """The logical screen of a GIF, ``(width, height, global table or None,
    background index, blocks)``; ``blocks`` yields ``("gce", packed, delay,
    transparent index)`` for each graphic control extension and ``("image",
    left, top, width, height, colour table or None, decode)`` for each image,
    up to the trailer, where ``decode()`` gives ``_indices`` of its codes."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    w, h, packed, bg = struct.unpack_from("<HHBB", data, 6)
    table, pos = _table(data, 13, packed) if packed & 0x80 else (None, 13)

    def blocks():
        pos_ = pos
        while pos_ < len(data) and data[pos_] != 0x3B:
            kind = data[pos_]
            if kind == 0x21:                                # extension
                if data[pos_ + 1] == 0xF9 and pos_ + 7 <= len(data):
                    yield ("gce", data[pos_ + 3], struct.unpack_from("<H", data, pos_ + 4)[0],
                           data[pos_ + 6])
                _, pos_ = _sub_block_data(data, pos_ + 2)
            elif kind == 0x2C:                              # image
                left, top, fw, fh, ipacked = struct.unpack_from("<HHHHB", data, pos_ + 1)
                local, pos_ = (_table(data, pos_ + 10, ipacked) if ipacked & 0x80
                               else (table, pos_ + 10))
                min_code = data[pos_]
                codes, pos_ = _sub_block_data(data, pos_ + 1)
                yield ("image", left, top, fw, fh, local,
                       functools.partial(_indices, codes, min_code, fw, fh, ipacked & 0x40))
            else:
                raise ValueError(f"an unknown GIF block 0x{kind:02x}")

    return w, h, table, bg, blocks()


def decode_gif(data: bytes) -> tuple[np.ndarray, int]:
    """GIF bytes -> (uint8 [frames, H, W, 3], the first frame's delay in
    centiseconds). Every frame must be a full-size image."""
    w, h, _, _, blocks = _walk(data)
    frames, delay = [], None
    for block in blocks:
        if block[0] == "gce":
            delay = block[2] if delay is None else delay
            continue
        _, left, top, fw, fh, table, decode = block
        if (left, top, fw, fh) != (0, 0, w, h):
            raise ValueError("read_gif reads full-size frames only")
        if table is None:
            raise ValueError("a GIF frame without a colour table")
        idx, done = decode()
        if done != w * h:
            raise ValueError("GIF frame data is short")
        frames.append(table[idx])
    return np.stack(frames), (delay or 0)


def read_gif(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as fh:
        return decode_gif(fh.read())


def imread_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF as ``cv2.imread(..., IMREAD_UNCHANGED)``
    returns it (OpenCV's own ``grfmt_gif.cpp``), channels in RGB order: 4
    channels when any graphic control extension of the file sets a
    transparent index, else 3; the canvas starts as the global table's
    background colour (black without a global table) with alpha 0, and the
    frame's pixels, but for its transparent index, are laid on it with alpha
    255."""
    w, h, table, bg, blocks = _walk(data)
    canvas = np.zeros((h, w, 4), np.uint8)
    if table is not None:
        if bg >= 2 << (data[10] & 7):
            raise ValueError("a GIF background index outside its global colour table")
        canvas[..., :3] = table[bg]
    any_transparent, transparent, first = False, None, None
    for block in blocks:
        if block[0] == "gce":
            _, flags, _, index = block
            any_transparent |= bool(flags & 1)
            if first is None:
                transparent = index if flags & 1 else None
            continue
        if first is not None:
            continue
        _, left, top, fw, fh, local, decode = block
        if not (fw > 0 and fh > 0 and left + fw <= w and top + fh <= h):
            raise ValueError("a GIF frame outside its canvas")
        idx, _ = decode()
        local = np.zeros((256, 3), np.uint8) if local is None else local
        region = canvas[top:top + fh, left:left + fw]
        keep = idx != transparent if transparent is not None else np.ones_like(idx, bool)
        region[keep, :3] = local[idx[keep]]
        region[keep, 3] = 255
        first = True
    if first is None:
        raise ValueError("a GIF without an image")
    return np.ascontiguousarray(canvas if any_transparent else canvas[..., :3])
