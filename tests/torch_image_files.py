"""Writers of image files for the port's reader tests and fixtures
(``scripts/port_make_image_fixtures.py``): GIF, BMP, PNM/PAM and PNG written
here from their specifications with numpy, so that every variant the
readers take (palettes, bit depths, run-length coding, interlacing,
transparency, 16-bit samples) can be made on purpose; WebP through Pillow
(libwebp), with a hand-made ``ALPH`` chunk for each alpha filter; EXIF
orientation added to a JPEG, PNG or WebP file; JPEG 2000 through Pillow and
through the OpenJPEG library Pillow bundles, called with ``ctypes`` for the
coding options Pillow does not pass on. No cv2 here."""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import tempfile
import zlib

import numpy as np


def photo(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """uint8 [h, w, channels] with detail at every scale: waves, edges, noise;
    a fourth channel is a soft disc with a transparent surround."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / (3.0 + c) + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    img[(xx // 7 + yy // 5) % 3 == 0] = (250, 20, 90)
    img = np.clip(img + rng.normal(0, 15, (h, w, 3)), 0, 255)
    if channels == 4:
        r = np.hypot((yy - h / 2) / max(h, 1), (xx - w / 2) / max(w, 1))
        img = np.dstack([img, np.clip((0.45 - r) * 900, 0, 255)])
    return img.astype(np.uint8)


# ------------------------------------------------------------------ GIF

def _lzw(idx: np.ndarray, m: int) -> bytes:
    """GIF LZW of palette indices with ``m``-bit roots; a clear code when the
    table nears 4096 entries."""
    clear, eoi = 1 << m, (1 << m) + 1
    out, acc, nb, width = bytearray(), 0, 0, m + 1

    def emit(code):
        nonlocal acc, nb
        acc |= code << nb
        nb += width
        while nb >= 8:
            out.append(acc & 255)
            acc >>= 8
            nb -= 8

    table = {(i,): i for i in range(clear)}
    nxt = eoi + 1
    emit(clear)
    cur: tuple = ()
    for c in idx.tolist():
        ext = cur + (c,)
        if ext in table:
            cur = ext
            continue
        emit(table[cur])
        table[ext] = nxt
        nxt += 1
        if nxt - 1 >= (1 << width) and width < 12:
            width += 1
        if nxt >= 4094:
            emit(clear)
            table, nxt, width = {(i,): i for i in range(clear)}, eoi + 1, m + 1
        cur = (c,)
    if cur:
        emit(table[cur])
    emit(eoi)
    if nb:
        out.append(acc & 255)
    return bytes(out)


def _gif_table(pal: np.ndarray) -> tuple[bytes, int]:
    n = 2
    while n < len(pal):
        n *= 2
    full = np.zeros((n, 3), np.uint8)
    full[:len(pal)] = pal
    return full.tobytes(), n.bit_length() - 2


def gif(w: int, h: int, frames: list, palette=None, bg: int = 0) -> bytes:
    """A GIF89a; each frame a dict: ``idx`` [fh, fw], optional ``left``,
    ``top``, ``palette`` (local table), ``transparent`` index, ``dispose``,
    ``interlace``; a graphic control extension precedes a frame that sets a
    transparent index or a disposal, and every frame of an animation."""
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, bg, 0))
    if palette is not None:
        table, size = _gif_table(palette)
        out[10] = 0x80 | (7 << 4) | size
        out += table
    for f in frames:
        idx = np.asarray(f["idx"])
        fh, fw = idx.shape
        if f.get("transparent") is not None or f.get("dispose") or len(frames) > 1:
            packed = (f.get("dispose", 0) << 2) | (f.get("transparent") is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 10, f.get("transparent") or 0) + b"\0"
        packed, local = 0, b""
        pal = f.get("palette")
        if pal is not None:
            local, size = _gif_table(pal)
            packed = 0x80 | size
        rows = idx
        if f.get("interlace"):
            packed |= 0x40
            rows = idx[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                       np.arange(2, fh, 4), np.arange(1, fh, 2)])]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), fw, fh, packed)
        out += local
        colors = len(pal) if pal is not None else len(palette)
        m = max(2, (colors - 1).bit_length())
        codes = _lzw(rows.reshape(-1).astype(np.int64), m)
        out += bytes([m]) + b"".join(bytes([len(codes[i:i + 255])]) + codes[i:i + 255]
                                     for i in range(0, len(codes), 255)) + b"\0"
    return bytes(out + b"\x3b")


# ------------------------------------------------------------------ BMP

def _rle_rows(idx: np.ndarray, bpp: int, eol_early: bool) -> bytes:
    """BI_RLE8/BI_RLE4 codes: runs of repeated pixels and absolute stretches,
    an end of line per row (after dropping a row's trailing index-0 pixels
    when ``eol_early``), an end of bitmap."""
    out = bytearray()
    for row in idx:
        row = list(row)
        if eol_early:
            while row and row[-1] == 0:
                row.pop()
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 3:
                run = max(1, min(run, len(row) - x))
                out += bytes([run, row[x] if bpp == 8 else row[x] << 4 | row[x]])
                x += run
                continue
            lit = 3
            while x + lit < len(row) and lit < 255 and not (
                    x + lit + 2 < len(row) and row[x + lit] == row[x + lit + 1] == row[x + lit + 2]):
                lit += 1
            vals = row[x:x + lit]
            if bpp == 8:
                body = bytes(vals) + (b"\0" if lit & 1 else b"")
            else:
                nib = vals + [0] * (lit & 1)
                body = bytes(nib[i] << 4 | nib[i + 1] for i in range(0, len(nib), 2))
                body += b"\0" * (len(body) & 1)
            out += bytes([0, lit]) + body
            x += lit
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp(img: np.ndarray, bpp: int, palette=None, header: int = 40, top_down: bool = False,
        compression: int = 0, masks=None, eol_early: bool = False) -> bytes:
    """A BMP of ``img`` (palette indices [h, w] when ``bpp`` <= 8, else RGB
    or RGBA uint8, or uint16 words for 16-bit); ``palette`` RGB [n, 3];
    ``header`` 12 (OS/2), 40, 108 (V4) or 124 (V5); ``masks`` (R, G, B, A)
    written for BI_BITFIELDS (after a 40-byte header, inside a V4/V5 one)."""
    h, w = img.shape[:2]
    pal = b""
    if bpp <= 8:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        pal = (p.tobytes() if header == 12
               else np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1).tobytes())
    rows = img[::-1] if not top_down else img
    if compression in (1, 2):
        pixels = _rle_rows(rows, bpp, eol_early)
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & ~3
        if bpp <= 8:
            bits = ((rows[..., None] >> np.arange(bpp - 1, -1, -1)) & 1).astype(np.uint8)
            packed = np.packbits(bits.reshape(h, -1), axis=1)
        elif bpp == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows[..., [2, 1, 0, 3][:rows.shape[-1]]].reshape(h, -1)
            if bpp == 32 and rows.shape[-1] == 3:
                packed = np.dstack([rows[..., ::-1], np.full((h, w), 0x55, np.uint8)]).reshape(h, -1)
        buf = np.zeros((h, pitch), np.uint8)
        buf[:, :packed.shape[1]] = packed
        pixels = buf.tobytes()
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, compression,
                           len(pixels), 2835, 2835, len(palette) if palette is not None else 0, 0)
        if header > 40:
            m = masks or (0, 0, 0, 0)
            info += struct.pack("<4I", *m) + b"BGRs" + b"\0" * (header - 56 - 4)
        elif compression == 3:
            extra = struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra
            + pal + pixels)


# ------------------------------------------------------------------ PNM

def pnm(img: np.ndarray, kind: int, maxval: int = 255, comment: bool = False) -> bytes:
    """P1-P6 of ``img`` ([h, w] or [h, w, 3] samples at ``maxval``; P1/P4 take
    0/1 with 1 black)."""
    h, w = img.shape[:2]
    head = f"P{kind}\n" + ("# made by the tests\n" if comment else "") + f"{w} {h}\n"
    if kind not in (1, 4):
        head += f"{maxval}\n"
    if kind == 1:
        body = "\n".join(" ".join(str(int(v)) for v in row) for row in img).encode() + b"\n"
    elif kind in (2, 3):
        body = "\n".join(" ".join(str(int(v)) for v in row.reshape(-1)) for row in img).encode() + b"\n"
    elif kind == 4:
        body = np.packbits(img.astype(np.uint8), axis=1).tobytes()
    else:
        body = img.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head.encode() + body


def pam(img: np.ndarray, tupltype: str, maxval: int = 255) -> bytes:
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {c}\nMAXVAL {maxval}\nTUPLTYPE {tupltype}\n"
            "ENDHDR\n")
    return head.encode() + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ------------------------------------------------------------------ PNG

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def png(samples: np.ndarray, depth: int, ctype: int, palette=None, trns: bytes | None = None,
        interlace: bool = False, exif: bytes | None = None, seed: int = 0) -> bytes:
    """A PNG of integer ``samples`` [h, w, c] at ``depth`` bits, colour type
    ``ctype``; each row gets a filter type drawn from ``seed``."""
    h, w, c = samples.shape
    rng = np.random.default_rng(seed)
    raw = bytearray()
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        bpp = max(1, depth * c // 8)
        prev = None
        for row in sub:
            if depth == 16:
                line = row.astype(">u2").tobytes()
            elif depth == 8:
                line = row.astype(np.uint8).tobytes()
            else:
                bits = ((row.reshape(-1)[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
                line = np.packbits(bits.reshape(-1)).tobytes()
            cur = np.frombuffer(line, np.uint8).astype(np.int64)
            up = np.zeros_like(cur) if prev is None else prev
            a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:len(cur)]
            cc = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])[:len(cur)]
            p = a + up - cc
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - cc)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, cc))
            kind = int(rng.integers(0, 5))
            filt = (cur - [0 * cur, a, up, (a + up) >> 1, paeth][kind]) & 255
            raw += bytes([kind]) + filt.astype(np.uint8).tobytes()
            prev = cur
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                                 int(interlace)))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    if exif is not None:
        out += _png_chunk(b"eXIf", exif)
    return out + _png_chunk(b"IDAT", zlib.compress(bytes(raw))) + _png_chunk(b"IEND", b"")


# ------------------------------------------------------------------ EXIF, WebP

def exif_orientation(value: int) -> bytes:
    """A little-endian TIFF block with one IFD entry: Orientation = value."""
    return b"II*\0" + struct.pack("<IH", 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, value, 0) \
        + struct.pack("<I", 0)


def webp(img: np.ndarray, **kw) -> bytes:
    """Pillow's WebP of RGB or RGBA uint8 ``img``."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _riff(chunks: list) -> bytes:
    body = b"WEBP" + b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                              for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes) -> list:
    out, off = [], 12
    while off + 8 <= len(data):
        tag, size = data[off:off + 4], struct.unpack_from("<I", data, off + 4)[0]
        out.append((tag, data[off + 8:off + 8 + size]))
        off += 8 + size + (size & 1)
    return out


def filter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """An alpha plane filtered as libwebp's encoder does (1 horizontal, 2
    vertical, 3 gradient); the decoder's inverse is in filters.c."""
    a = a.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    for y in range(h):
        for x in range(w):
            if y == 0:
                pred[y, x] = a[y, x - 1] if x else 0
            elif method == 1:
                pred[y, x] = a[y, x - 1] if x else a[y - 1, 0]
            elif method == 2:
                pred[y, x] = a[y - 1, x]
            else:
                pred[y, x] = (np.clip(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1], 0, 255)
                              if x else a[y - 1, 0])
    return ((a - pred) & 255).astype(np.uint8)


def webp_with_alph(img: np.ndarray, method: int, compressed: bool, quality: int = 80,
                   exif: bytes | None = None) -> bytes:
    """A lossy WebP of RGBA ``img`` whose ALPH chunk is made here: the plane
    filtered by ``method`` (0-3), stored raw or as a VP8L stream (Pillow's
    lossless coding of the filtered plane in the green channel)."""
    h, w = img.shape[:2]
    plane = filter_alpha(img[..., 3], method) if method else img[..., 3].astype(np.uint8)
    if compressed:
        stream = webp_chunks(webp(np.repeat(plane[..., None], 3, -1), lossless=True, exact=True))
        vp8l = next(p for t, p in stream if t == b"VP8L")
        payload = bytes([1 | method << 2]) + vp8l[5:]
    else:
        payload = bytes([method << 2]) + plane.tobytes()
    vp8 = next(p for t, p in webp_chunks(webp(np.ascontiguousarray(img[..., :3]), quality=quality))
               if t == b"VP8 ")
    flags = 0x10 | (0x08 if exif else 0)
    head = bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    chunks = [(b"VP8X", head), (b"ALPH", payload), (b"VP8 ", vp8)]
    return _riff(chunks + ([(b"EXIF", exif)] if exif else []))


def webp_with_exif(data: bytes, exif: bytes) -> bytes:
    """A single-image WebP wrapped in VP8X with an EXIF chunk."""
    chunks = webp_chunks(data)
    if chunks[0][0] == b"VP8X":
        head = bytes([chunks[0][1][0] | 0x08]) + chunks[0][1][1:]
        return _riff([(b"VP8X", head)] + chunks[1:] + [(b"EXIF", exif)])
    tag, payload = chunks[0]
    if tag == b"VP8L":
        bits = struct.unpack_from("<I", payload, 1)[0]
        w, h, alpha = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1
    else:
        w, h = (struct.unpack_from("<H", payload, 6)[0] & 0x3FFF,
                struct.unpack_from("<H", payload, 8)[0] & 0x3FFF)
        alpha = 0
    head = bytes([0x08 | (0x10 if alpha else 0), 0, 0, 0]) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")
    return _riff([(b"VP8X", head), (tag, payload), (b"EXIF", exif)])


def jpeg_with_exif(data: bytes, exif: bytes) -> bytes:
    """A JPEG with an APP1 Exif segment after its SOI."""
    seg = b"Exif\0\0" + exif
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


# ------------------------------------------------------------------ VP8 header rewrite

def _vp8_table(name: str) -> list:
    """A table of the port's VP8 decoder, read from its source (the
    specification's probabilities, which the rewrite below must replay)."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "dreamgaussian_tpu_torch" / "csrc"
           / "image_codecs.cpp").read_text()
    body = re.search(rf"{name}\[[^\]]*\] = \{{(.*?)\}};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


class _BoolDecoder:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8 | data[1]) if len(data) > 1 else 0
        self.range, self.count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            self.range -= split
            self.value -= split << 8
            out = 1
        else:
            self.range, out = split, 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return out


class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def vp8_rewrite(data: bytes, simple: int | None = None, level: int | None = None,
                sharpness: int | None = None, partitions: int | None = None) -> bytes:
    """A lossy single-image WebP with its loop-filter type, level and
    sharpness and its number of token partitions (1, 2, 4 or 8) replaced:
    every symbol is decoded and coded again with the probabilities it was
    coded with, the tokens of macroblock row y into partition
    ``y % partitions``. libwebp's encoder through Pillow offers neither the
    simple filter nor several partitions."""
    chunks = webp_chunks(data)
    vp8 = next(p for t, p in chunks if t == b"VP8 ")
    tag = vp8[0] | vp8[1] << 8 | vp8[2] << 16
    size = tag >> 5
    w = struct.unpack_from("<H", vp8, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", vp8, 8)[0] & 0x3FFF
    dec, enc = _BoolDecoder(vp8[10:10 + size]), _BoolEncoder()

    def bit(prob, value=None, d=None, e=None):
        v = (d or dec).bit(prob)
        (e or enc).put(v if value is None else value, prob)
        return v

    def lit(n, value=None):
        v = 0
        for k in range(n - 1, -1, -1):
            v = v << 1 | bit(128, None if value is None else (value >> k) & 1)
        return v

    def signed(n):
        if lit(1):
            lit(n)
            lit(1)

    lit(2)                                          # colour space, clamping
    seg_p, update_map = [255, 255, 255], 0
    if lit(1):
        update_map = lit(1)
        if lit(1):
            lit(1)
            for n in [7] * 4 + [6] * 4:
                signed(n)
        if update_map:
            seg_p = [lit(8) if lit(1) else 255 for _ in range(3)]
    lit(1, simple)
    lit(6, level)
    lit(3, sharpness)
    if lit(1) and lit(1):
        for _ in range(8):
            signed(6)
    old_parts = 1 << lit(2, None if partitions is None else partitions.bit_length() - 1)
    if old_parts != 1:
        raise ValueError("vp8_rewrite reads files of one token partition")
    parts = partitions or 1
    lit(7)
    for _ in range(5):
        signed(4)
    lit(1)
    proba = [lit(8) if bit(u) else p0 for u, p0 in zip(_vp8_table("kCoeffsUpdateProba"),
                                                        _vp8_table("kCoeffsProba0"))]
    skip_p = lit(8) if lit(1) else None
    bmodes = _vp8_table("kBModesProba")
    tree = [0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9]
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    tok_dec = _BoolDecoder(vp8[10 + size:])
    tok_enc = [_BoolEncoder() for _ in range(parts)]

    def coeffs(e, t, ctx, n):                       # libwebp's GetCoeffs, replayed
        def pr(band, c):
            at = ((t * 8 + band) * 3 + c) * 11
            return proba[at:at + 11]

        def tb(prob):
            return bit(prob, d=tok_dec, e=e)

        p = pr(_BANDS[n], ctx)
        while n < 16:
            if not tb(p[0]):
                return n
            while not tb(p[1]):
                n += 1
                p = pr(_BANDS[n], 0)
                if n == 16:
                    return 16
            if not tb(p[2]):
                p = pr(_BANDS[n + 1], 1)
            else:
                if not tb(p[3]):
                    if tb(p[4]):
                        tb(p[5])
                elif not tb(p[6]):
                    if not tb(p[7]):
                        tb(159)
                    else:
                        tb(165)
                        tb(145)
                else:
                    b1 = tb(p[8])
                    for c in _CATS[2 * b1 + tb(p[9 + b1])]:
                        tb(c)
                p = pr(_BANDS[n + 1], 2)
            tb(128)
            n += 1
        return 16

    top = [0] * (4 * mb_w)
    nz_y, nz_u, nz_v, nz_dc = [0] * (4 * mb_w), [0] * (2 * mb_w), [0] * (2 * mb_w), [0] * mb_w
    for my in range(mb_h):
        left = [0] * 4
        l_y, l_u, l_v, l_dc = [0] * 4, [0] * 2, [0] * 2, 0
        e = tok_enc[my % parts]
        for mx in range(mb_w):
            if update_map:
                bit(seg_p[1]) if not bit(seg_p[0]) else bit(seg_p[2])
            skip = bit(skip_p) if skip_p is not None else 0
            i16 = bit(145)
            if i16:
                ymode = (1 if bit(128) else 3) if bit(156) else (2 if bit(163) else 0)
                top[4 * mx:4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                for y in range(4):
                    mode = left[y]
                    for x in range(4):
                        prob = bmodes[(top[4 * mx + x] * 10 + mode) * 9:][:9]
                        i = tree[bit(prob[0])]
                        while i > 0:
                            i = tree[2 * i + bit(prob[i])]
                        mode = top[4 * mx + x] = -i
                    left[y] = mode
            if bit(142) and bit(114):
                bit(183)
            if skip:
                nz_y[4 * mx:4 * mx + 4], l_y = [0] * 4, [0] * 4
                nz_u[2 * mx:2 * mx + 2], nz_v[2 * mx:2 * mx + 2], l_u, l_v = [0] * 2, [0] * 2, [0] * 2, [0] * 2
                if i16:
                    nz_dc[mx] = l_dc = 0
                continue
            first, kind = 0, 3
            if i16:
                nz_dc[mx] = l_dc = int(coeffs(e, 1, nz_dc[mx] + l_dc, 0) > 0)
                first, kind = 1, 0
            for y in range(4):
                lv = l_y[y]
                for x in range(4):
                    lv = nz_y[4 * mx + x] = int(coeffs(e, kind, lv + nz_y[4 * mx + x], first) > first)
                l_y[y] = lv
            for tops, lefts in ((nz_u, l_u), (nz_v, l_v)):
                for y in range(2):
                    lv = lefts[y]
                    for x in range(2):
                        lv = tops[2 * mx + x] = int(coeffs(e, 2, lv + tops[2 * mx + x], 0) > 0)
                    lefts[y] = lv
    first = enc.flush()
    streams = [t.flush() for t in tok_enc]
    sizes = b"".join(len(s_).to_bytes(3, "little") for s_ in streams[:-1])
    tag = (tag & 0x1F) | len(first) << 5
    new = (bytes([tag & 255, tag >> 8 & 255, tag >> 16]) + vp8[3:10] + first + sizes
           + b"".join(streams))
    return _riff([(t, new if t == b"VP8 " else p) for t, p in chunks])


# ------------------------------------------------------------------ TIFF

def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (as libtiff's encoder writes it): MSB-first codes from 9 to
    12 bits, the width raised one code early, a clear code first and when
    the table fills, an end-of-information code last."""
    out, acc, nb = bytearray(), 0, 0
    width = 9

    def emit(code):
        nonlocal acc, nb
        acc = (acc << width) | code
        nb += width
        while nb >= 8:
            nb -= 8
            out.append((acc >> nb) & 255)

    def reset():
        return {bytes([i]): i for i in range(256)}, 258

    emit(256)
    table, free = reset()
    cur = b""
    for byte in data:
        ext = cur + bytes([byte])
        if ext in table:
            cur = ext
            continue
        emit(table[cur])
        table[ext] = free
        free += 1
        if free == 4094:
            emit(256)
            table, free = reset()
            width = 9
        elif free > (1 << width) - 1:
            width += 1
        cur = bytes([byte])
    if cur:
        emit(table[cur])
        free += 1
        if free == 4094:
            emit(256)
            width = 9
        elif free > (1 << width) - 1:
            width += 1
    emit(257)
    if nb:
        out.append((acc << (8 - nb)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits (Apple's run-length code): literal runs and repeats of at
    most 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_bits(samples: np.ndarray, bps: int) -> bytes:
    """Rows of ``bps``-bit samples (< 8) packed MSB first, each row padded
    to a byte."""
    rows = samples.reshape(samples.shape[0], -1).astype(np.uint8)
    per = 8 // bps
    pad = -rows.shape[1] % per
    rows = np.pad(rows, ((0, 0), (0, pad))).reshape(rows.shape[0], -1, per)
    shifts = (8 - bps * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(rows << shifts, axis=2).astype(np.uint8).tobytes()


def _predict(raw: np.ndarray, predictor: int, spp: int) -> bytes:
    """Predictor 2 (horizontal differences of samples, per row) or 3 (the
    floating-point predictor: each row's bytes split into planes, most
    significant first, then differenced) of ``raw`` [rows, width, spp]."""
    if predictor == 2:
        uint = raw.dtype.newbyteorder("=").str.replace("i", "u").replace("f", "u")
        ints = raw.view(raw.dtype.str[0] + uint[1:]).astype(uint)
        d = ints.copy()
        d[:, 1:] = ints[:, 1:] - ints[:, :-1]
        return d.astype(raw.dtype.str[0] + uint[1:]).tobytes()
    rows, width = raw.shape[:2]
    size = raw.dtype.itemsize
    be = raw.astype(raw.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, width * spp, size)
    planes = be.transpose(0, 2, 1).reshape(rows, -1)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return d.tobytes()


TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
              10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}


def _ifd(entries: dict, e: str, big: bool, base: int) -> tuple[bytes, bytes]:
    """An IFD whose out-of-line values follow it; ``base`` is its offset.
    Returns (directory with a zero next-IFD link, values)."""
    count_fmt, off_fmt, inline = ("Q", "Q", 8) if big else ("I", "I", 4)
    head = struct.pack(e + ("Q" if big else "H"), len(entries))
    dir_size = len(head) + len(entries) * (20 if big else 12) + (8 if big else 4)
    body, extra = bytearray(head), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        if typ in (2, 7) and isinstance(values, (bytes, str)):
            blob = values if isinstance(values, bytes) else values.encode() + b"\0"
            count = len(blob)
        else:
            values = np.atleast_1d(np.asarray(values))
            fmt = TIFF_TYPES[typ]
            count = len(values) // len(fmt)
            blob = values.astype(e + fmt[0]).tobytes()
        body += struct.pack(e + "HH" + count_fmt, tag, typ, count)
        if len(blob) <= inline:
            body += blob.ljust(inline, b"\0")
        else:
            at = base + dir_size + len(extra)
            body += struct.pack(e + off_fmt, at)
            extra += blob + b"\0" * (len(blob) & 1)
    body += b"\0" * (8 if big else 4)
    return bytes(body), bytes(extra)


def tiff(samples, bps: int, photometric: int, *, sample_format: int = 1, compression: int = 1,
         predictor: int = 1, rows_per_strip: int | None = None, tile: tuple | None = None,
         planar: int = 1, big_endian: bool = False, bigtiff: bool = False, extra_samples=None,
         colormap=None, tags: dict | None = None, fill_order: int = 1, chunks=None,
         pages: list | None = None, gap: int = 0) -> bytes:
    """A TIFF written from the TIFF 6.0 specification (and the BigTIFF
    extension): ``samples`` [H, W, S] (S samples per pixel of ``bps`` bits)
    in strips of ``rows_per_strip`` rows or in ``tile`` = (height, width)
    tiles (edge tiles padded), planar configuration 1 or 2, either byte
    order, compression 1 (none), 5 (LZW), 8 or 32946 (Deflate) or 32773
    (PackBits) with ``predictor`` 1, 2 or 3 (10-, 12- and 14-bit samples
    packed most significant bit first, with the Predictor tag only), a
    colormap, and any further ``tags`` {tag: (type, values)}. ``chunks`` gives the strips or tiles
    already coded (JPEG, CCITT, YCbCr blocks) in place of ``samples``'
    coding; ``pages`` appends further IFDs, each a dict of keyword
    arguments for another call; ``gap`` puts that many bytes before each
    chunk (odd offsets)."""
    e = ">" if big_endian else "<"
    big = bigtiff
    head = (b"MM" if big_endian else b"II") + (struct.pack(e + "HHHQ", 43, 8, 0, 16) if big
                                               else struct.pack(e + "HI", 42, 8))
    out = bytearray(head)
    ifd_links = []
    for page in [dict(samples=samples, bps=bps, photometric=photometric,
                      sample_format=sample_format, compression=compression, predictor=predictor,
                      rows_per_strip=rows_per_strip, tile=tile, planar=planar,
                      extra_samples=extra_samples, colormap=colormap, tags=tags,
                      fill_order=fill_order, chunks=chunks)] + list(pages or []):
        out, link = _tiff_page(out, e, big, gap, **page)
        ifd_links.append(link)
    # Link each IFD from the header or the IFD before it.
    link_at = 8 if big else 4
    for ifd_at, next_at in ifd_links:
        struct.pack_into(e + ("Q" if big else "I"), out, link_at, ifd_at)
        link_at = next_at
    return bytes(out)


def _tiff_page(out: bytearray, e: str, big: bool, gap: int, samples, bps, photometric,
               sample_format=1, compression=1, predictor=1, rows_per_strip=None, tile=None,
               planar=1, extra_samples=None, colormap=None, tags=None, fill_order=1,
               chunks=None):
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if chunks is None:
        dtype = {8: "u1", 16: "u2", 32: "u4", 64: "u8"}.get(bps, "u1")
        if sample_format == 2:
            dtype = dtype.replace("u", "i")
        elif sample_format == 3 and bps not in (10, 12, 14):
            dtype = {16: "f2", 32: "f4", 64: "f8"}[bps]
        arr = (samples.astype(np.int64) if bps in (10, 12, 14) else
               samples.astype(e + dtype) if bps >= 8 else samples.astype(np.uint8))
        th, tw = tile if tile else (rows_per_strip or h, w)
        planes = [arr] if planar == 1 else [arr[..., s:s + 1] for s in range(spp)]
        chunks = []
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw if tile else w):
                    part = plane[y:y + th, x:x + tw]
                    if tile:
                        part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1]),
                                             (0, 0)))
                    if bps in (10, 12, 14):
                        raw = pack_samples(part.reshape(part.shape[0], -1), bps)
                    elif predictor > 1:
                        raw = _predict(part, predictor, part.shape[2])
                    elif bps < 8:
                        raw = _pack_bits(part, bps)
                    else:
                        raw = part.tobytes()
                    raw = {1: lambda r: r, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress,
                           32773: packbits}[compression](raw)
                    if fill_order == 2:         # the coded bytes' bits reversed
                        raw = bytes(_REVERSED[np.frombuffer(raw, np.uint8)])
                    chunks.append(raw)
    offsets, counts = [], []
    for c in chunks:
        out += b"\0" * gap
        offsets.append(len(out))
        counts.append(len(c))
        out += c
    out += b"\0" * (len(out) & 1)
    long_type = 16 if big else 4
    entries = {256: (4, w), 257: (4, h), 258: (3, [bps] * spp), 259: (3, compression),
               262: (3, photometric), 277: (3, spp), 284: (3, planar)}
    if tile:
        entries.update({322: (4, tile[1]), 323: (4, tile[0]), 324: (long_type, offsets),
                        325: (long_type, counts)})
    else:
        entries.update({273: (long_type, offsets), 278: (4, rows_per_strip or h),
                        279: (long_type, counts)})
    if predictor > 1:
        entries[317] = (3, predictor)
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if extra_samples is not None:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, np.asarray(colormap, np.int64).T.reshape(-1))
    if fill_order != 1:
        entries[266] = (3, fill_order)
    entries.update(tags or {})
    at = len(out)
    body, extra = _ifd(entries, e, big, at)
    out += body + extra
    next_at = at + len(body) - (8 if big else 4)
    return out, (at, next_at)


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def ycbcr_chunks(ycc: np.ndarray, hs: int, vs: int, rows: int, compress=lambda b: b) -> list:
    """Strips of ``rows`` rows of uint8 [H, W, 3] Y, Cb, Cr in TIFF's
    subsampled blocks: hs x vs luma samples then the block's Cb and Cr (the
    chroma of its top-left pixel), blocks padded at the edges."""
    h, w = ycc.shape[:2]
    out = []
    for y0 in range(0, h, rows):
        part = ycc[y0:y0 + rows]
        ph = -(-part.shape[0] // vs) * vs
        pw = -(-w // hs) * hs
        part = np.pad(part, ((0, ph - part.shape[0]), (0, pw - w), (0, 0)), mode="edge")
        bh, bw = ph // vs, pw // hs
        luma = part[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, -1)
        chroma = part[::vs, ::hs, 1:]
        out.append(compress(np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()))
    return out


def _jpeg_segments(data: bytes) -> list:
    """A JPEG's marker segments up to its first SOS: (marker, bytes)."""
    out, at = [], 2
    while data[at + 1] != 0xDA:
        length = struct.unpack_from(">H", data, at + 2)[0]
        out.append((data[at + 1], data[at:at + 2 + length]))
        at += 2 + length
    return out + [(0xDA, data[at:])]


def jpeg_tiff_chunks(img: np.ndarray, rows: int | None = None, tile: tuple | None = None,
                     **kw) -> tuple[list, bytes]:
    """JPEG-in-TIFF (compression 7) strips of ``rows`` rows or ``tile``
    tiles (padded to full size) of uint8 ``img``, each coded by Pillow's
    libjpeg with ``kw`` (quality, subsampling, keep_rgb) and stripped to an
    abbreviated stream; returns (chunks, JPEGTables): SOI, the shared DQT
    and DHT segments, EOI."""
    from PIL import Image

    h, w = img.shape[:2]
    th, tw = tile if tile else (rows or h, w)
    chunks, tables = [], None
    for y in range(0, h, th):
        for x in range(0, w, tw):
            part = img[y:y + th, x:x + tw]
            if tile:
                part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1]))
                              + ((0, 0),) * (img.ndim - 2), mode="edge")
            buf = io.BytesIO()
            Image.fromarray(part).save(buf, "JPEG", **kw)
            segs = _jpeg_segments(buf.getvalue())
            shared = b"".join(s for m, s in segs if m in (0xDB, 0xC4))
            tables = tables or b"\xff\xd8" + shared + b"\xff\xd9"
            chunks.append(b"\xff\xd8" + b"".join(s for m, s in segs if m not in (0xDB, 0xC4)
                                                 and not 0xE0 <= m <= 0xEF))
    return chunks, tables


def sgilog_row(codes: np.ndarray, nbytes: int, runs: bool = True) -> bytes:
    """One row of SGILog's run-length code (libtiff's tif_luv.c): the
    ``nbytes`` byte planes of ``codes``, most significant first, each as
    runs (128 + n - 2 then the byte, for 2 to 129 repeats) where ``runs``
    and a byte repeats at least 3 times, else literals of at most 127."""
    out = bytearray()
    codes = np.asarray(codes, np.uint64)
    for k in range(nbytes - 1, -1, -1):
        plane = ((codes >> np.uint64(8 * k)) & np.uint64(255)).astype(np.uint8).tobytes()
        i, lit = 0, bytearray()
        while i <= len(plane):
            j = i
            while runs and j < len(plane) and plane[j] == plane[i] and j - i < 129:
                j += 1
            if i == len(plane) or (runs and j - i >= 3):
                for at in range(0, len(lit), 127):
                    out += bytes([len(lit[at:at + 127])]) + lit[at:at + 127]
                lit = bytearray()
                if i == len(plane):
                    break
                out += bytes([128 + j - i - 2, plane[i]])
                i = j
            else:
                lit.append(plane[i])
                i += 1
    return bytes(out)


def logluv24(codes: np.ndarray) -> bytes:
    """Rows of LogLuv24 codes (10-bit log luminance, 14-bit uv index): 3
    bytes each, most significant first (libtiff's LogLuvDecode24)."""
    c = np.asarray(codes, np.uint32)
    return np.stack([c >> 16, c >> 8, c], -1).astype(np.uint8).tobytes()


def sgilog_tiff(codes: np.ndarray, photometric: int = 32844, compression: int = 34676,
                bps: int = 16, sample_format: int = 2, runs: bool = True, **kw) -> bytes:
    """A LogL (photometric 32844: int16 [H, W] codes) or LogLuv (32845:
    uint32 LogLuv32 codes, or LogLuv24 codes with compression 34677) TIFF
    in SGILog's own coding, in strips of ``rows_per_strip`` rows or
    ``tile`` tiles (padded with code 0), with the BitsPerSample and
    SampleFormat that libtiff writes for 16-bit signed data (cv2's choice);
    ``kw`` goes to ``tiff``."""
    codes = np.asarray(codes)
    h, w = codes.shape
    tile = kw.get("tile")
    th, tw = tile if tile else (kw.get("rows_per_strip") or h, w)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            part = codes[y:y + th, x:x + tw]
            if tile:
                part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1])))
            if compression == 34677:
                chunks.append(logluv24(part))
            else:
                nbytes = 2 if photometric == 32844 else 4
                mask = (1 << (8 * nbytes)) - 1
                chunks.append(b"".join(sgilog_row(r.astype(np.int64) & mask, nbytes, runs)
                                       for r in part))
    spp = 1 if photometric == 32844 else 3
    return tiff(np.zeros((h, w, spp), np.uint8), bps, photometric, compression=compression,
                sample_format=sample_format, chunks=kw.pop("chunks", chunks), **kw)


def thunder_row(row: np.ndarray) -> bytes:
    """One row of 4-bit samples in ThunderScan's codes (tif_thunder.c):
    runs of the last pixel, three 2-bit or two 3-bit deltas (with their
    skip codes where a pair or a single pixel is left), or raw pixels."""
    out, last, i, n = bytearray(), 0, 0, len(row)
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    row = [int(v) for v in row]
    while i < n:
        j = i
        while j < n and row[j] == last and j - i < 63:
            j += 1
        if j - i >= 2:
            out.append(j - i)
            i = j
            continue
        d = [row[k] - (row[k - 1] if k > i else last) for k in range(i, min(i + 3, n))]
        if len(d) == 3 and all(v in two for v in d):
            out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
            last, i = row[i + 2], i + 3
        elif len(d) >= 2 and all(v in two for v in d[:2]):
            out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | 2)
            last, i = row[i + 1], i + 2
        elif len(d) >= 2 and all(v in three for v in d[:2]):
            out.append(0x80 | three[d[0]] << 3 | three[d[1]])
            last, i = row[i + 1], i + 2
        elif d[0] in three and d[0] != 0:
            out.append(0x80 | three[d[0]] << 3 | 4)
            last, i = row[i], i + 1
        else:
            out.append(0xC0 | row[i])
            last, i = row[i], i + 1
    return bytes(out)


def next_row(row: np.ndarray, kind: str = "runs") -> bytes:
    """One row of 2-bit samples in NeXT's 2-bit coding (tif_next.c): the
    whole row literal (0x00), a literal span (0x40, offset, count; the rest
    white), or runs of <colour:2><count:6>."""
    packed = bytes(np.packbits(((np.asarray(row)[:, None] >> [1, 0]) & 1).astype(np.uint8)))
    if kind == "literal":
        return b"\x00" + packed
    if kind == "span":
        return b"\x40" + struct.pack(">HH", 0, len(packed)) + packed
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 63:
            j += 1
        out.append(int(row[i]) << 6 | (j - i))
        i = j
    return bytes(out)


def sunras(w: int, h: int, depth: int, kind: int, rows: np.ndarray, cmap: bytes = b"") -> bytes:
    """A Sun raster: the 32-byte big-endian header, the colormap (red,
    green and blue thirds), ``rows`` [h, bytes] each padded to 16 bits."""
    pad = np.pad(rows, ((0, 0), (0, rows.shape[1] & 1))).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(pad), kind, 1 if cmap else 0,
                       len(cmap)) + cmap + pad


def sunras_rle(data: bytes) -> bytes:
    """RT_BYTE_ENCODED's coding of ``data``: 0x80, count - 1, value for a run
    of 3 or more (or of any 0x80 bytes), 0x80 0x00 for a single 0x80."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3 or data[i] == 0x80:
            out += b"\x80\x00" if j - i == 1 else bytes([0x80, j - i - 1, data[i]])
            i = j
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def pack_samples(samples: np.ndarray, bps: int) -> bytes:
    """Rows of ``bps``-bit samples ([rows, n]) most significant bit first,
    each row padded to a byte (TIFF's packing of 10-, 12- and 14-bit data)."""
    rows = np.asarray(samples, np.uint32).reshape(np.shape(samples)[0], -1)
    bits = ((rows[..., None] >> np.arange(bps - 1, -1, -1, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(rows.shape[0], -1), axis=1).tobytes()


# ------------------------------------------------------------------ JPEG 2000

def jp2_pillow(img: np.ndarray, **kw) -> bytes:
    """A JP2 file (or with ``no_jp2=True`` a raw codestream) written by
    Pillow's OpenJPEG encoder; ``img`` uint8 L/RGB/RGBA (LA with
    ``mode="LA"``) or uint16 I;16."""
    from PIL import Image

    mode = kw.pop("mode", None)
    pil = Image.fromarray(img)
    if mode is not None:
        pil = pil.convert(mode)
    buf = io.BytesIO()
    pil.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def jp2_boxes(data: bytes) -> list:
    """The top-level (or a super box's) boxes as (type, payload) pairs."""
    out, pos = [], 0
    while pos < len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        length = length or len(data) - pos
        out.append((kind, data[pos + 8:pos + length]))
        pos += length
    return out


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def jp2_rebuild(data: bytes, header=None, codestream: bytes | None = None) -> bytes:
    """A JP2 file with its jp2h sub-boxes passed through ``header(list) ->
    list`` and its codestream replaced."""
    out = b""
    for kind, payload in jp2_boxes(data):
        if kind == b"jp2h" and header is not None:
            payload = b"".join(jp2_box(k, p) for k, p in header(jp2_boxes(payload)))
        if kind == b"jp2c" and codestream is not None:
            payload = codestream
        out += jp2_box(kind, payload)
    return out


def jp2_codestream(data: bytes) -> bytes:
    return dict(jp2_boxes(data))[b"jp2c"]


def jp2_colr(enumcs: int | None = None, icc: bytes | None = None) -> bytes:
    if icc is not None:
        return b"\x02\0\0" + icc
    return b"\x01\0\0" + struct.pack(">I", enumcs)


def jp2_cdef(entries) -> bytes:
    return struct.pack(">H", len(entries)) + b"".join(struct.pack(">HHH", *e) for e in entries)


def jp2_pclr(entries: np.ndarray, depths) -> bytes:
    """A palette box: entries [NE, NPC], each column of its bit depth."""
    out = struct.pack(">HB", *entries.shape) + bytes(d - 1 for d in depths)
    for row in entries:
        out += b"".join(int(v).to_bytes((d + 7) // 8, "big") for v, d in zip(row, depths))
    return out


def jp2_cmap(entries) -> bytes:
    return b"".join(struct.pack(">HBB", *e) for e in entries)


def jp2_header_with(colr: bytes | None = None, drop=(), extra=()):
    """A ``header`` for jp2_rebuild: colr replaced, boxes dropped, added."""
    def edit(sub):
        out = [(k, colr if k == b"colr" and colr is not None else p) for k, p in sub
               if k not in drop]
        return out + list(extra)
    return edit


def j2k_parse(cs: bytes) -> tuple[list, list]:
    """A codestream -> (main header segments [(marker, payload)], tile-parts
    [(Isot, TPsot, TNsot, header segments, data)]); SOC, SIZ first, EOC
    last."""
    pos, main = 2, []
    while True:
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == 0xFF90:
            break
        length = struct.unpack_from(">H", cs, pos + 2)[0]
        main.append((m, cs[pos + 4:pos + 2 + length]))
        pos += 2 + length
    parts = []
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", cs, pos + 4)
        end = pos + psot if psot else len(cs) - 2
        at, segs = pos + 12, []
        while struct.unpack_from(">H", cs, at)[0] != 0xFF93:
            m, length = struct.unpack_from(">HH", cs, at)
            segs.append((m, cs[at + 4:at + 2 + length]))
            at += 2 + length
        parts.append((isot, tpsot, tnsot, segs, cs[at + 2:end]))
        pos = end
    return main, parts


def j2k_build(main: list, parts: list) -> bytes:
    out = b"\xff\x4f"
    for m, p in main:
        out += struct.pack(">HH", m, len(p) + 2) + p
    for isot, tpsot, tnsot, segs, data in parts:
        head = b"".join(struct.pack(">HH", m, len(p) + 2) + p for m, p in segs)
        psot = 12 + len(head) + 2 + len(data)
        sot = struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tpsot, tnsot)
        out += sot + head + b"\xff\x93" + data
    return out + b"\xff\xd9"


def j2k_set_precision(cs: bytes, precs) -> bytes:
    """SIZ's component precisions set (None keeps one); the coded data is
    unchanged, so the DC shift, clamp and (9/7) step sizes follow."""
    cs = bytearray(cs)
    for i, p in enumerate(precs):
        if p is not None:
            cs[42 + 3 * i] = (cs[42 + 3 * i] & 0x80) | (p - 1)
    return bytes(cs)


def j2k_set_rsiz(cs: bytes, value: int) -> bytes:
    """SIZ's capabilities field (Rsiz) set: bit 15 claims Part 2
    extensions, bit 14 HTJ2K."""
    return cs[:6] + struct.pack(">H", value) + cs[8:]


def j2k_set_cod(cs: bytes, at: int, value: int) -> bytes:
    """One byte of the main header's COD payload replaced (0 Scod, 1
    progression, 4 MCT, 8 code-block style, ...)."""
    main, parts = j2k_parse(cs)
    main = [(m, p[:at] + bytes([value]) + p[at + 1:] if m == 0xFF52 else p) for m, p in main]
    return j2k_build(main, parts)


def _plt_lengths(segs: list) -> list:
    out, v = [], 0
    for m, p in segs:
        if m != 0xFF58:
            continue
        for b in p[1:]:
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                out.append(v)
                v = 0
    return out


def j2k_split_tile_parts(cs: bytes, tlm: bool = False) -> bytes:
    """Every tile's packets over two tile-parts, split at the middle packet
    (the codestream needs PLT markers: Pillow's ``plt=True``); PLT dropped;
    with ``tlm``, a TLM marker in the main header giving every tile-part's
    length."""
    main, parts = j2k_parse(cs)
    out = []
    for isot, _, _, segs, data in parts:
        lengths = _plt_lengths(segs)
        cut = sum(lengths[:len(lengths) // 2])
        rest = [(m, p) for m, p in segs if m != 0xFF58]
        out += [(isot, 0, 2, rest, data[:cut]), (isot, 1, 2, [], data[cut:])]
    if tlm:
        body = j2k_build([], out)[2:-2]
        lens, pos = [], 0
        while pos < len(body):
            psot = struct.unpack_from(">I", body, pos + 6)[0]
            lens.append((struct.unpack_from(">H", body, pos + 4)[0], psot))
            pos += psot
        tlm = bytes([0, 0x60]) + b"".join(struct.pack(">HI", t, n) for t, n in lens)
        main = main + [(0xFF55, tlm)]
    return j2k_build(main, out)


def j2k_per_component_markers(cs: bytes, where: str = "main") -> bytes:
    """COC and QCC markers for every component that repeat COD's and QCD's
    values (the decode is the same), in the main header or in each tile's
    first tile-part header (there with a tile COD and QCD too)."""
    main, parts = j2k_parse(cs)
    cod = next(p for m, p in main if m == 0xFF52)
    qcd = next(p for m, p in main if m == 0xFF5C)
    ncomp = struct.unpack_from(">H", dict(main)[0xFF51], 34)[0]
    extra = []
    for c in range(ncomp):
        extra += [(0xFF53, bytes([c, cod[0] & 1]) + cod[5:]), (0xFF5D, bytes([c]) + qcd)]
    if where == "main":
        return j2k_build(main + extra, parts)
    parts = [(i, tp, tn, ([(0xFF52, cod), (0xFF5C, qcd)] + extra if tp == 0 else []) + segs, d)
             for i, tp, tn, segs, d in parts]
    return j2k_build(main, parts)


def j2k_with_sop(cs: bytes) -> bytes:
    """An SOP marker segment before every packet, numbered from 0 in each
    tile, and COD's SOP flag set (the codestream needs PLT markers: Pillow's
    ``plt=True``); PLT dropped."""
    main, parts = j2k_parse(cs)
    main = [(m, bytes([p[0] | 2]) + p[1:] if m == 0xFF52 else p) for m, p in main]
    out, count = [], {}
    for isot, tpsot, tnsot, segs, data in parts:
        body, at = b"", 0
        for n in _plt_lengths(segs):
            k = count.get(isot, 0)
            count[isot] = k + 1
            body += struct.pack(">HHH", 0xFF91, 4, k % 65536) + data[at:at + n]
            at += n
        out.append((isot, tpsot, tnsot, [(m, p) for m, p in segs if m != 0xFF58], body + data[at:]))
    return j2k_build(main, out)


def j2k_poc_in_tiles(cs: bytes) -> bytes:
    """The main header's POC marker moved into every tile's first tile-part
    header (the same progression, read from the tile)."""
    main, parts = j2k_parse(cs)
    poc = [(m, p) for m, p in main if m == 0xFF5F]
    main = [(m, p) for m, p in main if m != 0xFF5F]
    parts = [(i, tp, tn, (poc if tp == 0 else []) + segs, d) for i, tp, tn, segs, d in parts]
    return j2k_build(main, parts)


# ------------------------------------------------------------------ OpenJPEG through ctypes
#
# OpenJPEG 2.5's public structures, from its ``openjpeg.h`` (no header is
# needed: ctypes lays them out as the C compiler does). The layout is held
# by the tests: the library's own defaults land on the fields named here,
# and every field set below comes back in the markers it writes.

_U32, _I32 = ctypes.c_uint32, ctypes.c_int
_PROG_ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


class OpjPoc(ctypes.Structure):
    _fields_ = ([(n, _U32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1",
                                     "layno0", "precno0", "precno1")]
                + [("prg1", _I32), ("prg", _I32), ("progorder", ctypes.c_char * 5),
                   ("tile", _U32)]
                + [(n, _U32) for n in ("tx0", "tx1", "ty0", "ty1", "layS", "resS", "compS",
                                       "prcS", "layE", "resE", "compE", "prcE", "txS", "txE",
                                       "tyS", "tyE", "dx", "dy", "lay_t", "res_t", "comp_t",
                                       "prc_t", "tx0_t", "ty0_t")])


class OpjCParameters(ctypes.Structure):
    """opj_cparameters_t (with the JPWL fields, present whether or not the
    library was built with JPWL)."""
    _fields_ = ([(n, _I32) for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
                                     "cp_disto_alloc", "cp_fixed_alloc", "cp_fixed_quality")]
                + [("cp_matrice", ctypes.POINTER(_I32)), ("cp_comment", ctypes.c_char_p),
                   ("csty", _I32), ("prog_order", _I32), ("POC", OpjPoc * 32),
                   ("numpocs", _U32), ("tcp_numlayers", _I32),
                   ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100)]
                + [(n, _I32) for n in ("numresolution", "cblockw_init", "cblockh_init", "mode",
                                       "irreversible", "roi_compno", "roi_shift", "res_spec")]
                + [("prcw_init", _I32 * 33), ("prch_init", _I32 * 33),
                   ("infile", ctypes.c_char * 4096), ("outfile", ctypes.c_char * 4096),
                   ("index_on", _I32), ("index", ctypes.c_char * 4096)]
                + [(n, _I32) for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx",
                                       "subsampling_dy", "decod_format", "cod_format",
                                       "jpwl_epc_on", "jpwl_hprot_MH")]
                + [(n, _I32 * 16) for n in ("jpwl_hprot_TPH_tileno", "jpwl_hprot_TPH",
                                            "jpwl_pprot_tileno", "jpwl_pprot_packno",
                                            "jpwl_pprot")]
                + [(n, _I32) for n in ("jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range",
                                       "jpwl_sens_MH")]
                + [("jpwl_sens_TPH_tileno", _I32 * 16), ("jpwl_sens_TPH", _I32 * 16),
                   ("cp_cinema", _I32), ("max_comp_size", _I32), ("cp_rsiz", _I32),
                   ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
                   ("tcp_mct", ctypes.c_char), ("jpip_on", _I32), ("mct_data", ctypes.c_void_p),
                   ("max_cs_size", _I32), ("rsiz", ctypes.c_uint16)])


class OpjComponentParameters(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class OpjImageComponent(ctypes.Structure):
    _fields_ = ([(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                     "resno_decoded", "factor")]
                + [("data", ctypes.POINTER(_I32)), ("alpha", ctypes.c_uint16)])


class OpjImage(ctypes.Structure):
    _fields_ = ([(n, _U32) for n in ("x0", "y0", "x1", "y1", "numcomps")]
                + [("color_space", _I32), ("comps", ctypes.POINTER(OpjImageComponent)),
                   ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", _U32)])


_OPENJPEG = []


def openjpeg() -> ctypes.CDLL:
    """The ``libopenjp2`` that Pillow bundles (``pillow.libs/``), its
    encoder's functions declared."""
    if not _OPENJPEG:
        import PIL

        found = sorted(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                              "libopenjp2-*.so*")))
        if not found:
            raise FileNotFoundError("no libopenjp2 beside Pillow")
        lib = ctypes.CDLL(found[0])
        p, img = ctypes.POINTER(OpjCParameters), ctypes.POINTER(OpjImage)
        vp = ctypes.c_void_p
        for name, res, args in (
                ("opj_set_default_encoder_parameters", None, [p]),
                ("opj_set_MCT", _I32, [p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_int32), _U32]),
                ("opj_image_create", img, [_U32, ctypes.POINTER(OpjComponentParameters), _I32]),
                ("opj_image_destroy", None, [img]),
                ("opj_create_compress", vp, [_I32]),
                ("opj_setup_encoder", _I32, [vp, p, img]),
                ("opj_stream_create_default_file_stream", vp, [ctypes.c_char_p, _I32]),
                ("opj_start_compress", _I32, [vp, img, vp]),
                ("opj_encode", _I32, [vp, vp]),
                ("opj_end_compress", _I32, [vp, vp]),
                ("opj_stream_destroy", None, [vp]),
                ("opj_destroy_codec", None, [vp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _OPENJPEG.append(lib)
    return _OPENJPEG[0]


def openjpeg_defaults() -> OpjCParameters:
    params = OpjCParameters()
    openjpeg().opj_set_default_encoder_parameters(ctypes.byref(params))
    return params


def jp2_openjpeg(img: np.ndarray, *, csty: int = 0, mode: int = 0, roi=None,
                 irreversible: bool = False, mct: int | None = None, rates=(0,), tile=None,
                 resolutions: int = 6, cblk=(64, 64), order: str = "LRCP", jp2: bool = True,
                 tile_parts: str | None = None, matrix=None) -> bytes:
    """A JP2 file (a raw codestream with ``jp2=False``) written by
    OpenJPEG's own encoder, as ``opj_compress`` sets it up: ``img`` uint8
    or uint16 [h, w] or [h, w, C] (the last of 2 or 4 channels is alpha);
    ``csty`` the COD's Scod bits (2 SOP, 4 EPH), ``mode`` the code-block
    style (1 BYPASS, 2 RESET, 4 RESTART, 8 CAUSAL, 16 ERTERM, 32 SEGMARK:
    ``-M``), ``roi`` (component, shift) an RGN marker, ``rates`` the
    layers' compression ratios (0 lossless), ``tile`` (w, h), ``mct`` the
    RCT/ICT flag (default on for three or more channels), ``tile_parts``
    "R", "L" or "C" a tile-part at each new resolution, layer or component
    of the progression (``-TP``), ``matrix`` a Part 2 custom MCT (C x C)
    through ``opj_set_MCT``."""
    lib = openjpeg()
    params = openjpeg_defaults()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, n = img.shape
    prec = 8 if img.dtype == np.uint8 else 16
    comps = (OpjComponentParameters * n)(
        *[OpjComponentParameters(1, 1, w, h, 0, 0, prec, prec, 0) for _ in range(n)])
    image = lib.opj_image_create(n, comps, 1 if n >= 3 else 2)      # sRGB or grey
    image.contents.x1, image.contents.y1 = w, h
    for c in range(n):
        comp = image.contents.comps[c]
        plane = np.ascontiguousarray(img[..., c], np.int32)
        ctypes.memmove(comp.data, plane.ctypes.data, plane.nbytes)
        comp.alpha = int(n in (2, 4) and c == n - 1)
    params.csty, params.mode, params.irreversible = csty, mode, int(irreversible)
    if roi is not None:
        params.roi_compno, params.roi_shift = roi
    params.tcp_numlayers, params.cp_disto_alloc = len(rates), 1
    for i, r in enumerate(rates):
        params.tcp_rates[i] = r
    params.tcp_mct = bytes([int(n >= 3) if mct is None else mct])
    if tile is not None:
        params.tile_size_on, params.cp_tdx, params.cp_tdy = 1, tile[0], tile[1]
    params.numresolution = resolutions
    params.cblockw_init, params.cblockh_init = cblk
    params.prog_order = _PROG_ORDERS[order]
    if tile_parts is not None:
        params.tp_on, params.tp_flag = b"\1", tile_parts.encode()
    if matrix is not None:
        m = np.ascontiguousarray(matrix, np.float32)
        dc = (ctypes.c_int32 * n)()
        lib.opj_set_MCT(ctypes.byref(params), m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        dc, n)
    codec = lib.opj_create_compress(2 if jp2 else 0)                 # OPJ_CODEC_JP2 / J2K
    try:
        if not lib.opj_setup_encoder(codec, ctypes.byref(params), image):
            raise ValueError("OpenJPEG refused the encoder parameters")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out")
            stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
            ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
            if not ok:
                raise ValueError("OpenJPEG failed to encode")
            with open(path, "rb") as fh:
                return fh.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


def j2k_rgn(cs: bytes, comp: int, shift: int, where: str = "main") -> bytes:
    """A maxshift RGN marker (ROI) for ``comp`` set in the main header or in
    every tile's first tile-part header; RGN markers already there go. The
    coded data is kept: the decoder's bit-planes start ``shift`` higher and
    the magnitudes come back down (OpenJPEG's encoder writes the marker and
    codes the data as it would without it)."""
    main, parts = j2k_parse(cs)
    ncomp = struct.unpack_from(">H", dict(main)[0xFF51], 34)[0]
    rgn = (0xFF5E, (bytes([comp]) if ncomp <= 256 else struct.pack(">H", comp))
           + bytes([0, shift]))
    main = [(m, p) for m, p in main if m != 0xFF5E]
    parts = [(i, tp, tn, [(m, p) for m, p in segs if m != 0xFF5E], d)
             for i, tp, tn, segs, d in parts]
    if where == "main":
        return j2k_build(main + [rgn], parts)
    return j2k_build(main, [(i, tp, tn, ([rgn] if tp == 0 else []) + segs, d)
                            for i, tp, tn, segs, d in parts])


def j2k_packets(data: bytes) -> list:
    """A tile-part's packets of an SOP+EPH codestream as (SOP, header,
    body):
    each starts at its SOP marker, its header runs through its EPH marker
    (neither marker can stand inside coded data)."""
    starts = []
    at = data.find(b"\xff\x91")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\xff\x91", at + 2)
    if not starts or starts[0] != 0:
        raise ValueError("the tile-part does not start with an SOP marker")
    out = []
    for s, e in zip(starts, starts[1:] + [len(data)]):
        eph = data.index(b"\xff\x92", s + 6) + 2
        out.append((data[s:s + 6], data[s + 6:eph], data[eph:e]))
    return out


def j2k_packed_headers(cs: bytes, where: str = "ppt", eph: bool = True, sop: bool = True,
                       chunk: int = 65532, order=None, tnsot: int | None = None,
                       ppm_order=None) -> bytes:
    """An SOP+EPH codestream (``jp2_openjpeg(csty=6)``) with its packet
    headers moved out of the packets: into PPT markers in the header of the
    tile-part they came from (``where="ppt"``), or into PPM markers in the
    main header with an Nppm field for each tile-part (``"ppm"``).
    ``eph``: the packed headers keep their EPH markers (else both the
    markers and COD's EPH flag go); ``sop``: the bodies keep their SOP
    markers (likewise). ``chunk``: the most header bytes a marker carries
    (a smaller one spreads the headers, and an Nppm's bytes, over several
    markers). ``order``: a function of the tile-parts [(Isot, TPsot, TNsot,
    segments, data)] that returns them in the order the codestream is to
    hold them (the packed headers follow that order, as Part 1 lays PPM's
    out: tile-part by tile-part as they come); ``tnsot``: every tile-part's
    TNsot set to it (0: the number of tile-parts is not known);
    ``ppm_order``: a function of the tile-parts' (Isot, TPsot, headers) in
    codestream order that returns them in the order PPM is to hold them
    (OpenJPEG reads them in its decode order)."""
    main, parts = j2k_parse(cs)
    if order is not None:
        parts = list(order(parts))
    if tnsot is not None:
        parts = [(i, tp, tnsot, segs, data) for i, tp, _, segs, data in parts]
    cod = next(p for m, p in main if m == 0xFF52)
    if cod[0] & 6 != 6:
        raise ValueError("the codestream lacks SOP and EPH markers")
    scod = cod[0] & ~((0 if eph else 4) | (0 if sop else 2))
    main = [(m, bytes([scod]) + p[1:] if m == 0xFF52 else p) for m, p in main]
    out, ppm, zppt = [], [], {}
    for isot, tpsot, tnsot, segs, data in parts:
        heads, bodies = b"", b""
        for sop_marker, head, body in j2k_packets(data):
            heads += head if eph else head[:-2]
            bodies += (sop_marker if sop else b"") + body
        if where == "ppm":
            ppm.append((isot, tpsot, heads))
            out.append((isot, tpsot, tnsot, segs, bodies))
            continue
        markers = []
        for at in range(0, len(heads), chunk):
            z = zppt.get(isot, 0)
            zppt[isot] = z + 1
            markers.append((0xFF61, bytes([z]) + heads[at:at + chunk]))
        out.append((isot, tpsot, tnsot, segs + markers, bodies))
    if where == "ppm":
        markers, cur = [], b""
        for _, _, heads in (ppm if ppm_order is None else ppm_order(ppm)):
            if chunk - len(cur) < 4:
                markers.append(cur)
                cur = b""
            cur += struct.pack(">I", len(heads))
            rest = heads
            while rest:
                room = chunk - len(cur)
                if room == 0:
                    markers.append(cur)
                    cur, room = b"", chunk
                cur, rest = cur + rest[:room], rest[room:]
        markers.append(cur)
        main = main + [(0xFF60, bytes([z]) + m) for z, m in enumerate(markers)]
    return j2k_build(main, out)
