"""JPEG 2000 (JP2 files and raw J2K codestreams) read as ``cv2.imread`` reads
them (OpenCV 5.0 over OpenJPEG 2.5), with no cv2 or OpenJPEG.

The codestream's tiers, dequantization, inverse DWT, MCT and DC shift are
``csrc/jpeg2000.cpp``; this module reads the JP2 boxes, applies the palette
(``pclr``/``cmap``) and channel definitions (``cdef``) as OpenJPEG applies
them, and then cv2's own rules (``grfmt_jpeg2000_openjpeg.cpp``):

- the output depth follows the codestream's largest component precision:
  8 bits gives uint8, 9 to 16 give uint16 unshifted, more gives no image
  under ``IMREAD_UNCHANGED``; ``IMREAD_COLOR`` gives uint8 shifted right by
  the precision less 8; below 8 bits, signed components, an image origin
  other than 0 or subsampled components give no image;
- the channel count under ``IMREAD_UNCHANGED`` is the codestream's
  component count (1, 3 or 4; 2 gives no image), before a palette expands
  it; ``IMREAD_COLOR`` gives 3;
- by colour space: sRGB (also an unknown, unspecified or ICC space, and a
  raw codestream) copies 1, 3 or 4 components, takes the first three under
  ``IMREAD_COLOR`` (a single component gives no image there) and turns three
  or more into one by cv2's BGR2GRAY; greyscale repeats the first
  component; sYCC goes through cv2's integer YUV2BGR; CMYK and e-sYCC give
  no image;
- samples are cast to the output type, not saturated.

The codestream is read in all of Part 1 as OpenJPEG 2.5 decodes it: SOP
and EPH markers, the six code-block styles (bypass, reset, termination on
each pass, vertically causal contexts, predictable termination,
segmentation symbols), ROI by maxshift (RGN) and packed packet headers
(PPM, PPT). Where cv2 returns None the port raises ValueError naming
JPEG 2000; what the port does not decode, HTJ2K (Part 15) and Part 2,
raises NotImplementedError naming it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import native

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1

_SRGB, _GRAY, _SYCC = "sRGB", "greyscale", "sYCC"
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 12: "CMYK", 24: "e-sYCC"}


def _boxes(data: bytes, pos: int, end: int) -> list[tuple[bytes, bytes]]:
    """The boxes of ``data[pos:end]`` as (type, payload). As OpenJPEG reads
    them, the codestream box (``jp2c``) runs to the end whatever its length
    says, and nothing is read after it; any other box must fit."""
    out = []
    while pos < end:
        if pos + 8 > end:
            raise ValueError("a JP2 box header runs past its container")
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError("a JP2 box header runs past its container")
            length, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        if kind == b"jp2c":
            out.append((kind, data[pos + head:end]))
            break
        if length == 0:
            raise ValueError(f"JP2 box {kind!r} of undefined length")
        if length < head or pos + length > end:
            raise ValueError(f"JP2 box {kind!r} of length {length} does not fit")
        out.append((kind, data[pos + head:pos + length]))
        pos += length
    return out


class _Jp2:
    """The boxes of a JP2 file that the decode reads."""

    def __init__(self, data: bytes):
        boxes = _boxes(data, 0, len(data))
        if len(boxes) < 2 or boxes[0] != (b"jP  ", b"\r\n\x87\n") or boxes[1][0] != b"ftyp":
            raise ValueError("a JP2 file starts with its signature and ftyp boxes")
        self.codestream = self.enumcs = None
        self.pclr = self.cmap = self.cdef = None
        header = False
        for kind, payload in boxes[2:]:
            if kind == b"jp2h":
                header = True
                self._header(payload)
            elif kind == b"jp2c":
                if not header:
                    raise ValueError("the JP2 codestream box comes before the header box")
                self.codestream = payload
                break
        if not header:
            raise ValueError("no JP2 header box")
        if self.codestream is None:
            raise ValueError("no JP2 codestream box")

    def _header(self, payload: bytes) -> None:
        sub = _boxes(payload, 0, len(payload))
        if not sub or sub[0][0] != b"ihdr":
            raise ValueError("the JP2 header box does not start with ihdr")
        if len(sub[0][1]) != 14:
            raise ValueError("a JP2 ihdr box is not 14 bytes long")
        self.size = struct.unpack_from(">II", sub[0][1])        # height, width
        colr = False
        for kind, body in sub[1:]:
            if kind == b"colr" and not colr:        # later ones are ignored
                colr = True
                if len(body) < 3:
                    raise ValueError("a JP2 colr box is too short")
                if body[0] == 1:
                    if len(body) < 7:
                        raise ValueError("a JP2 colr box is too short")
                    self.enumcs = struct.unpack_from(">I", body, 3)[0]
            elif kind == b"pclr":
                if self.pclr is not None:
                    raise ValueError("two JP2 pclr boxes")
                self.pclr = _palette(body)
            elif kind == b"cmap":
                if self.pclr is None:
                    raise ValueError("a JP2 cmap box before its pclr box")
                if self.cmap is not None:
                    raise ValueError("two JP2 cmap boxes")
                n = self.pclr.shape[1]
                if len(body) < 4 * n:
                    raise ValueError("a JP2 cmap box is too short")
                self.cmap = [struct.unpack_from(">HBB", body, 4 * i) for i in range(n)]
            elif kind == b"cdef":
                if self.cdef is not None:
                    raise ValueError("two JP2 cdef boxes")
                if len(body) < 2:
                    raise ValueError("a JP2 cdef box is too short")
                n = struct.unpack_from(">H", body)[0]
                if n == 0 or len(body) < 2 + 6 * n:
                    raise ValueError("a JP2 cdef box is too short")
                self.cdef = [list(struct.unpack_from(">HHH", body, 2 + 6 * i)) for i in range(n)]


def _palette(body: bytes) -> np.ndarray:
    """A pclr box -> its entries [NE, NPC] as int64."""
    if len(body) < 3:
        raise ValueError("a JP2 pclr box is too short")
    ne, npc = struct.unpack_from(">HB", body)
    if ne == 0 or ne > 1024 or npc == 0:
        raise ValueError(f"a JP2 palette of {ne} entries and {npc} columns")
    if len(body) < 3 + npc:
        raise ValueError("a JP2 pclr box is too short")
    depths = [(b & 0x7F) + 1 for b in body[3:3 + npc]]
    if any(d > 38 for d in depths):
        raise ValueError("a JP2 palette column deeper than 38 bits")
    widths = [(d + 7) // 8 for d in depths]
    if len(body) < 3 + npc + ne * sum(widths):
        raise ValueError("a JP2 pclr box is too short")
    out = np.empty((ne, npc), np.int64)
    at = 3 + npc
    for e in range(ne):
        for c, w in enumerate(widths):
            out[e, c] = int.from_bytes(body[at:at + w], "big")
            at += w
    return out


def _call(fn, *args):
    msg = ctypes.create_string_buffer(256)
    rc = fn(*args, msg, len(msg))
    if rc == 2:
        raise NotImplementedError(f"JPEG 2000 {msg.value.decode()} is not read by the port")
    if rc:
        raise ValueError(msg.value.decode())


def _codestream_info(cs: np.ndarray) -> tuple[int, int, list[tuple[int, int, int, int]]]:
    info = np.zeros(5 + 4 * 16384, np.int32)
    _call(native.jpeg2000().dg_j2k_info, cs.ctypes.data, cs.size, info.ctypes.data, info.size)
    n, w, h, x0, y0 = (int(v) for v in info[:5])
    if x0 or y0:
        raise ValueError(f"image origin ({x0}, {y0}): cv2 reads none but 0")
    comps = [tuple(int(v) for v in info[5 + 4 * c:9 + 4 * c]) for c in range(n)]
    return w, h, comps


def _apply_palette(planes: list[np.ndarray], jp2: _Jp2) -> list[np.ndarray]:
    """OpenJPEG's opj_jp2_check_color and opj_jp2_apply_pclr."""
    pal, cmap = jp2.pclr, jp2.cmap
    n = pal.shape[1]
    used = [False] * n
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(planes):
            raise ValueError(f"JP2 cmap names component {cmp} of {len(planes)}")
        if mtyp not in (0, 1) or pcol >= n or (mtyp == 1 and used[pcol]) \
                or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            raise ValueError(f"JP2 cmap entry {i} ({cmp}, {mtyp}, {pcol}) is not one OpenJPEG maps")
        used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(n)):
        raise ValueError("a JP2 palette column has no mapping")
    if len(planes) == 1 and not all(used):
        cmap = [(c, 1, i) for i, (c, _, _) in enumerate(cmap)]
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        src = planes[cmp]
        out.append(src.copy() if mtyp == 0 else pal[np.clip(src, 0, len(pal) - 1), pcol])
    return out


def _check_cdef(cdef: list, channels: int) -> None:
    """OpenJPEG's opj_jp2_check_color for a cdef box."""
    for cn, _, asoc in cdef:
        if cn >= channels or (asoc not in (0, 65535) and asoc - 1 >= channels):
            raise ValueError("a JP2 cdef entry names a channel that does not exist")
    if any(c not in {cn for cn, _, _ in cdef} for c in range(channels)):
        raise ValueError("the JP2 cdef box does not define every channel")


def _apply_cdef(planes: list[np.ndarray], cdef: list) -> list[np.ndarray]:
    """OpenJPEG's opj_jp2_apply_cdef: colour channels move to their
    association (cv2 reads no alpha flag: it checks them before this)."""
    planes = list(planes)
    info = [list(e) for e in cdef]
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= len(planes) or asoc in (0, 65535) or asoc - 1 >= len(planes):
            continue
        acn = asoc - 1
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for later in info[i + 1:]:
                if later[0] == cn:
                    later[0] = acn
                elif later[0] == acn:
                    later[0] = cn
    return planes


def _bgr2gray(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv2.cvtColor BGR2GRAY on integers (15-bit fixed point)."""
    r, g, b = (p.astype(np.int64) for p in (r, g, b))
    return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15


def _yuv2rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, depth: int) -> list[np.ndarray]:
    """cv2.cvtColor YUV2BGR on integers (14-bit fixed point), RGB order."""
    half, top = 1 << (depth - 1), (1 << depth) - 1
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    u, v = u - half, v - half
    d = lambda x: (x + (1 << 13)) >> 14  # noqa: E731
    return [np.clip(y + d(v * 18678), 0, top), np.clip(y + d(v * -9519 + u * -6472), 0, top),
            np.clip(y + d(u * 33292), 0, top)]


def decode_jpeg2000(data: bytes, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """JP2 or J2K bytes -> ``cv2.imdecode(data, flags)``'s array in RGB(A)
    order (flags -1 or 1). ValueError where cv2 returns None."""
    jp2 = _Jp2(data) if data.startswith(JP2_SIGNATURE) else None
    cs = np.frombuffer(jp2.codestream if jp2 else data, np.uint8)
    w, h, comps = _codestream_info(cs)
    if jp2 is not None and jp2.size != (h, w):
        raise ValueError(f"the JP2 ihdr box says {jp2.size[1]}x{jp2.size[0]}, the codestream "
                         f"{w}x{h}")
    space = _SRGB if jp2 is None else _ENUMCS.get(jp2.enumcs, _SRGB)
    # cv2's header: 1 to 4 components, unsigned, 8 bits at least.
    if not 1 <= len(comps) <= 4:
        raise ValueError(f"{len(comps)} components: cv2 reads 1 to 4")
    if any(c[1] for c in comps):
        raise ValueError("signed components: cv2 reads none")
    prec = max(c[0] for c in comps)
    if prec < 8:
        raise ValueError(f"{prec}-bit components: cv2 reads 8 bits and more")
    if any((dx, dy) != (1, 1) for _, _, dx, dy in comps):
        raise ValueError("subsampled components: cv2 reads none")
    if flags == IMREAD_UNCHANGED:
        if prec > 16:
            raise ValueError(f"{prec}-bit components: cv2 reads at most 16 under IMREAD_UNCHANGED")
        channels, depth = len(comps), 8 if prec == 8 else 16
    else:
        channels, depth = 3, 8
    if channels == 2:
        raise ValueError("two channels: cv2 returns none")
    if space not in (_SRGB, _GRAY, _SYCC):
        raise ValueError(f"{space} colour space: cv2 converts none")
    if jp2 is not None and jp2.pclr is not None and jp2.cmap is None:
        jp2.pclr = None                     # Part 1, I.5.3.4: both or neither
    if jp2 is not None and jp2.cdef is not None:
        _check_cdef(jp2.cdef, jp2.pclr.shape[1] if jp2.pclr is not None else len(comps))
    out = np.zeros((len(comps), h, w), np.int32)
    _call(native.jpeg2000().dg_j2k_decode, cs.ctypes.data, cs.size, out.ctypes.data)
    planes = list(out)
    if jp2 is not None and jp2.pclr is not None:
        planes = _apply_palette(planes, jp2)
    if jp2 is not None and jp2.cdef is not None:
        planes = _apply_cdef(planes, jp2.cdef)
    shift = prec - depth if prec > depth else 0
    mask = (1 << depth) - 1
    planes = [(p >> shift) & mask for p in planes]      # cv2's cast, not saturated
    n = len(planes)
    if space == _GRAY:
        if channels == 4:
            raise ValueError("a greyscale image to four channels: cv2 returns none")
        img = planes[:1] * channels
    elif space == _SYCC:
        if channels == 1:
            img = planes[:1]
        elif channels == 3 and n >= 3:
            img = _yuv2rgb(planes[0], planes[1], planes[2], depth)
        else:
            raise ValueError(f"sYCC from {n} components to {channels} channels: cv2 returns none")
    elif channels == 1:
        img = planes[:1] if n <= 2 else [_bgr2gray(*planes[:3]) & mask]
    elif channels == 3 and n >= 3:
        img = planes[:3]
    elif channels == 4 and n >= 4:
        img = planes[:4]
    else:
        raise ValueError(f"sRGB from {n} components to {channels} channels: cv2 returns none")
    dtype = np.uint8 if depth == 8 else np.uint16
    if channels == 1:
        return img[0].astype(dtype)
    return np.ascontiguousarray(np.stack(img, -1).astype(dtype))
