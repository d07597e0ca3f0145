"""JPEG decoder of the port's own (no cv2, no PIL), on the host.

Python reads the markers (SOI, APPn and COM skipped, DQT, DHT, SOF, SOS,
DRI, EOI) and hands each scan's entropy-coded bytes to
``csrc/image_tools.cpp`` (built by ``native.py``), which does the Huffman
decoding (sequential and progressive scans, restart intervals) and, once
every scan is read, libjpeg-turbo's interblock smoothing of progressive
coefficients left unrefined, dequantisation, libjpeg's integer IDCT, its
"fancy" chroma upsampling and its fixed-point colour conversion. Each of
those steps is integer arithmetic, so the result equals what
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` (libjpeg-turbo) gives, channels
in RGB order, bit for bit.

A file cut off or damaged is read as cv2.imread reads it: where a scan's
data runs out, the MCU under way finishes on zero bits and later ones are
left as they are (flat grey in a sequential file) until a restart marker;
a cut inside a marker segment reads on through the FF D9 pairs
libjpeg-turbo's source manager hands out past the end, then ends the file;
a file that ends before its first scan is refused with ValueError, as cv2
returns None. (cv2.imdecode's memory source does not pad a cut file so,
and its decode of one differs.)

A JPEG-compressed TIFF's strips and tiles come here too
(``utils/tiff.py`` splices its JPEGTables in front and names the colour
conversion). Covered: SOF0, SOF1 and SOF2 with 8-bit samples; 1, 3 or 4 components
(YCbCr or RGB by the JFIF/Adobe markers and the component ids as libjpeg
decides; CMYK and YCCK by Adobe's APP14 marker, turned into RGB as cv2
turns them into BGR); any integral sampling factors; restart intervals;
sizes that are not multiples of the MCU. The EXIF orientation is ignored,
as ``IMREAD_UNCHANGED`` ignores it. Refused with NotImplementedError:
arithmetic coding (SOF9-SOF15), lossless (SOF3), hierarchical (SOF5-SOF7)
and 12-bit samples.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import native

_TABLE_BYTES = 16 + 256     # one Huffman table for the native side: counts, symbols
_MAX_PIXELS = 1 << 30       # cv2.imread's CV_IO_MAX_IMAGE_PIXELS
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])   # zigzag -> natural
_REFUSED = {0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
            0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical JPEG (SOF7)",
            **{m: f"arithmetic-coded JPEG (SOF{m - 0xC0})"
               for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)}}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _pointers(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*[_ptr(a) for a in arrays])


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None           # latched at the component's first scan, as libjpeg does


def _color_transform(comps, jfif: bool, adobe: int | None) -> int:
    """The native side's conversion: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4
    YCCK (jdapimin.c default_decompress_parms)."""
    n = len(comps)
    if n == 1:
        return 0
    if n == 3:
        if jfif:
            return 1
        if adobe is not None:
            return 2 if adobe == 0 else 1
        ids = tuple(c.cid for c in comps)
        return 2 if ids == (82, 71, 66) else 1        # 'R', 'G', 'B'
    if n == 4:
        return 3 if adobe is None or adobe == 0 else 4
    raise NotImplementedError(f"a JPEG with {n} components (1, 3 or 4 are read)")


_SAVED = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]     # natural positions of zigzag 0..9


def _smoothing(comps, frame, coef_bits, prev_bits, scans, last_good):
    """jdcoefct.c smoothing_ok: the native side's smoothing parameters, or
    None where libjpeg-turbo does not smooth (a sequential file, a table
    missing or with a zero among the ten quantisers, a component with no
    DC yet, or every one of coefficients 1..9 fully known). ``last_good``:
    the iMCU row after which the rows take the scan before's bits."""
    if not frame[2] or any(c.quant is None or not c.quant[_SAVED].all() for c in comps):
        return None
    if (coef_bits[:, 0] < 0).any() or not coef_bits[:, 1:10].any():
        return None
    total_rows = -(-frame[0] // (8 * frame[4]))
    prev = prev_bits[:, :10] if scans > 1 else np.full_like(prev_bits[:, :10], -1)
    return np.concatenate([[last_good, total_rows],
                           np.concatenate([coef_bits[:, :10], prev], 1).ravel()]).astype(np.int32)


def decode_jpeg(data: bytes, transform: int | None = None) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (one component) or [H, W, 3] RGB.
    ``transform`` overrides the colour conversion the markers name (1
    YCbCr to RGB, 2 the components as stored), as libtiff sets libjpeg's
    colour spaces for a JPEG-compressed TIFF."""
    buf = np.frombuffer(data, np.uint8)
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise ValueError("not a JPEG file (no SOI marker)")
    # Where markers start: 0xFF followed by neither a stuffed 0x00, a fill
    # 0xFF nor RSTn. A scan's entropy-coded bytes end at the first one.
    nxt = buf[1:]
    markers = np.flatnonzero((buf[:-1] == 0xFF) & (nxt != 0x00) & (nxt != 0xFF)
                             & ((nxt < 0xD0) | (nxt > 0xD7)))
    lib = native.image_tools()
    quant: dict[int, np.ndarray] = {}
    dc_tables: dict[int, bytes] = {}
    ac_tables: dict[int, bytes] = {}
    comps: list[_Component] = []
    coefs: list[np.ndarray] = []
    frame = None                   # (height, width, progressive, max_h, max_v, mcus_x, mcus_y)
    jfif, adobe, restart = False, None, 0
    coef_bits = prev_bits = None   # jdphuff.c's coef_bits [components, 64], and before the scan
    scans, last_good = 0, -1       # last_good: jdcoefct.c's last_good_iMCU_row
    pos = 2
    while True:
        while pos < len(buf) and buf[pos] != 0xFF:     # garbage before a marker: skipped
            pos += 1
        while pos < len(buf) and buf[pos] == 0xFF:
            pos += 1
        if pos >= len(buf):
            break                                       # no EOI: the end of the file ends it
        code = int(buf[pos])
        pos += 1
        if code == 0xD9:                                # EOI
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:        # RSTn or TEM outside a scan
            continue
        cut = pos + 2 > len(buf) or pos + struct.unpack_from(">H", data, pos)[0] > len(buf)
        if cut:
            # The file ends inside this segment. libjpeg's source manager hands out
            # FF D9 pairs past the end (cv2.imread's and libtiff's alike), so the
            # segment is read on through them, and then the file has ended.
            data += b"\xff\xd9" * 32769
            buf = np.frombuffer(data, np.uint8)
        length = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += length
        if code == 0xE0 and seg[:5] == b"JFIF\0" and len(seg) >= 14:
            jfif = True
        elif code == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif code == 0xDB:                              # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[_ZIGZAG] = vals
                quant[tq] = table
                i += 1 + n
        elif code == 0xC4:                              # DHT, with jdmarker.c get_dht's checks
            i = 0
            while len(seg) - i > 16:
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                if n > 256 or n > len(seg) - i - 17 or seg[i] & 0xEC:
                    raise ValueError("a malformed JPEG Huffman table")
                table = counts + seg[i + 17:i + 17 + n]
                (ac_tables if tc else dc_tables)[th] = table.ljust(_TABLE_BYTES, b"\0")
                i += 17 + n
            if i != len(seg):
                raise ValueError("a malformed JPEG Huffman table")
        elif code == 0xDD:                              # DRI
            restart = struct.unpack(">H", seg[:2])[0]
        elif code in (0xC0, 0xC1, 0xC2):                # SOF0, SOF1, SOF2
            if frame is not None:
                raise ValueError("a JPEG with two frame headers")
            precision, height, width, n = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG samples (8-bit ones are read)")
            if height == 0:
                raise NotImplementedError("a JPEG whose height is given by a DNL marker")
            if width * height > _MAX_PIXELS:
                raise ValueError(f"a {width}x{height} JPEG is over cv2's limit of "
                                 f"{_MAX_PIXELS} pixels")
            comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                                seg[8 + 3 * k]) for k in range(n)]
            if width == 0 or any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
                raise ValueError("a JPEG frame header with a zero width or bad sampling factors")
            max_h = max(c.h for c in comps)
            max_v = max(c.v for c in comps)
            mcus_x, mcus_y = -(-width // (8 * max_h)), -(-height // (8 * max_v))
            for c in comps:
                c.bw = -(-width * c.h // (8 * max_h))      # blocks that hold samples
                c.bh = -(-height * c.v // (8 * max_v))
                c.stride = mcus_x * c.h                    # blocks an interleaved MCU row covers
                coefs.append(np.zeros((mcus_y * c.v, c.stride, 64), np.int16))
            frame = (height, width, code == 0xC2, max_h, max_v, mcus_x, mcus_y)
            coef_bits = np.full((n, 64), -1, np.int32)
            prev_bits = np.zeros((n, 64), np.int32)
        elif code in _REFUSED:
            raise NotImplementedError(f"{_REFUSED[code]} is not read")
        elif code == 0xDA:                              # SOS
            if frame is None:
                raise ValueError("a JPEG scan before its frame header")
            ns = seg[0]
            by_id = {c.cid: k for k, c in enumerate(comps)}
            if any(seg[1 + 2 * k] not in by_id for k in range(ns)):
                raise ValueError("a JPEG scan names a component its frame lacks")
            members = [by_id[seg[1 + 2 * k]] for k in range(ns)]
            tables = [seg[2 + 2 * k] for k in range(ns)]
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = a >> 4, a & 15
            if not 1 <= ns <= 4 or (frame[2] and (              # jdphuff.c's checks
                    (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
                    or (ah and al != ah - 1) or al > 13)):
                raise ValueError("a JPEG scan header out of range")
            after = np.searchsorted(markers, pos)
            end = int(markers[after]) if after < len(markers) else len(buf)
            if cut:             # the scan's data is the padding up to its first 0xFF
                end = pos + int(buf[pos] != 0xFF)
            for k in members:
                c = comps[k]
                if c.quant is None and c.tq in quant:
                    c.quant = quant[c.tq].copy()
            _, _, progressive, _, _, mcus_x, mcus_y = frame
            scans += 1
            if progressive:     # start_pass_phuff_decoder: the whole band counts as read
                for k in members:
                    band = slice(min(ss, 1), max(se, 9) + 1)
                    prev_bits[k, band] = coef_bits[k, band] if scans > 1 else 0
                    coef_bits[k, ss:se + 1] = al
            if ns == 1:         # one block per MCU over the component's own blocks
                c = comps[members[0]]
                desc = [1, 1, c.stride, 0]
                grid = (c.bw, c.bh)
            else:
                desc = [x for k in members for x in (comps[k].h, comps[k].v, comps[k].stride, 0)]
                grid = (mcus_x, mcus_y)
            empty = b"\0" * _TABLE_BYTES
            dc = np.frombuffer(b"".join(dc_tables.get(t >> 4, empty) for t in tables), np.uint8)
            ac = np.frombuffer(b"".join(ac_tables.get(t & 15, empty) for t in tables), np.uint8)
            scan = np.ascontiguousarray(buf[pos:end])
            desc = np.array(desc, np.int32)     # every array named: alive through the call
            decoded = np.zeros(1, np.int64)
            ret = lib.dg_jpeg_scan(
                _ptr(scan), len(scan), ns, _pointers([coefs[k] for k in members]), _ptr(desc),
                _ptr(dc), _ptr(ac), grid[0], grid[1], ss, se, ah, al, int(progressive), restart,
                _ptr(decoded))
            if ret != 0:
                raise ValueError("a JPEG scan refers to a missing or malformed Huffman table")
            # The iMCU row of the last MCU begun with data left: the smoothing
            # takes the scan before's coefficient bits for the rows after it.
            last_good = int(decoded[0]) // grid[0] // (comps[members[0]].v if ns == 1 else 1)
            pos = end
        if cut:
            break
    if frame is None:
        raise ValueError("a JPEG without a frame header")
    if scans == 0:
        raise ValueError("a JPEG that ends before its first scan")   # cv2: no image
    height, width, _, max_h, max_v, _, _ = frame
    if transform is None or len(comps) != 3:
        transform = _color_transform(comps, jfif, adobe)
    desc = np.array([x for c in comps for x in (c.h, c.v, c.stride, c.bw, c.bh,
                                                int(c.quant is not None))], np.int32)
    q = np.stack([c.quant if c.quant is not None else np.zeros(64, np.uint16) for c in comps])
    smooth = _smoothing(comps, frame, coef_bits, prev_bits, scans, last_good)
    out = np.empty((height, width) if transform == 0 else (height, width, 3), np.uint8)
    if lib.dg_jpeg_finish(len(comps), _pointers(coefs), _ptr(desc), _ptr(q), width, height,
                          max_h, max_v, transform, None if smooth is None else _ptr(smooth),
                          _ptr(out)) != 0:
        raise NotImplementedError("a JPEG whose sampling factors are not integral ratios")
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read())
