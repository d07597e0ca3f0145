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
Python loop, the bit packing numpy. ``read_gif`` decodes what
``write_gif`` writes (and other single-image-per-frame GIFs without
interlacing): it returns the frames as RGB and the delay.
"""

from __future__ import annotations

import struct

import numpy as np

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


def _lzw_decode(data: bytes, min_code: int, n: int) -> np.ndarray:
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    buf = data + b"\x00\x00\x00"
    pos, end = 0, len(data) * 8
    out = bytearray()
    table: list = []
    width, prev = min_code + 1, None
    while pos + width <= end:
        code = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 3], "little") >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev = min_code + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) == (1 << width) and width < 12:
            width += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def decode_gif(data: bytes) -> tuple[np.ndarray, int]:
    """GIF bytes -> (uint8 [frames, H, W, 3], the first frame's delay in
    centiseconds). Every frame must be a full-size, non-interlaced image."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_table = None
    if packed & 0x80:
        size = 3 << ((packed & 7) + 1)
        global_table = np.frombuffer(data[pos:pos + size], np.uint8).reshape(-1, 3)
        pos += size
    frames, delay = [], None
    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            break
        if tag == 0x21:                               # an extension: skip its blocks
            if data[pos + 1] == 0xF9 and delay is None:
                delay = struct.unpack("<H", data[pos + 4:pos + 6])[0]
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if tag != 0x2C:
            raise ValueError(f"unexpected GIF block 0x{tag:02x}")
        x, y, fw, fh, fpacked = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        pos += 10
        if (x, y, fw, fh) != (0, 0, w, h) or fpacked & 0x40:
            raise ValueError("read_gif reads full-size, non-interlaced frames only")
        table = global_table
        if fpacked & 0x80:
            size = 3 << ((fpacked & 7) + 1)
            table = np.frombuffer(data[pos:pos + size], np.uint8).reshape(-1, 3)
            pos += size
        min_code = data[pos]
        pos += 1
        blocks = bytearray()
        while data[pos]:
            blocks += data[pos + 1:pos + 1 + data[pos]]
            pos += data[pos] + 1
        pos += 1
        idx = _lzw_decode(bytes(blocks), min_code, w * h)
        if idx.size != w * h:
            raise ValueError("GIF frame data is short")
        frames.append(table[idx].reshape(h, w, 3))
    return np.stack(frames), (delay or 0)


def read_gif(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as fh:
        return decode_gif(fh.read())
