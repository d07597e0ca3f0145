"""JPEG decoder of the port's own (no cv2, no PIL), on the host.

Python reads the markers (SOI, APPn and COM skipped, DQT, DHT, DAC, SOF,
SOS, DRI, EOI) and hands each scan's entropy-coded bytes to
``csrc/image_tools.cpp`` (built by ``native.py``), which does the entropy
decoding and, once every scan is read, libjpeg-turbo's interblock
smoothing of progressive coefficients left unrefined, dequantisation,
libjpeg's integer IDCT, its "fancy" chroma upsampling and its fixed-point
colour conversion. Each of those steps is integer arithmetic, so the
result equals what ``cv2.imread(path, flags)`` (libjpeg-turbo 3.1) gives,
channels in RGB order, bit for bit.

The processes cv2 reads are read: baseline and extended sequential (SOF0,
SOF1) and progressive (SOF2) with Huffman coding; the same with arithmetic
coding (SOF9, SOF10: libjpeg-turbo's QM decoder, the DAC segment's
conditioning with its defaults L = 0, U = 1, Kx = 5, the statistics
restarted at each restart marker, zeros read on past a marker, nothing
decoded in an interval after a bad arithmetic code); and lossless (SOF3:
Huffman-coded differences of categories 0 to 16, the seven predictors, the
point transform, 2- to 8-bit samples, straight to samples with chroma
replicated). Lossy files have 8-bit samples; 1, 3 or 4 components (YCbCr
or RGB by the JFIF/Adobe markers and the component ids as libjpeg decides,
where a lossless file without those markers is RGB; CMYK and YCCK by
Adobe's APP14 marker, turned into RGB as cv2 turns them into BGR); any
integral sampling factors; restart intervals; sizes that are not
multiples of the MCU. The EXIF orientation is ignored, as
``IMREAD_UNCHANGED`` ignores it.

Where cv2 returns None, ``decode_jpeg`` raises ValueError naming the
cause: hierarchical processes (SOF5-SOF7, SOF13-SOF15), lossless
arithmetic coding (SOF11), the reserved SOF8 and other markers libjpeg
does not know, lossy samples of other than 8 bits and lossless ones of
more than 8, scan headers out of range for their process (a lossless
scan's predictor outside 1-7, Se or Ah not 0, Al not below the precision;
a lossless restart interval that is not whole MCU rows), 2 or more than 4
components, a lossless file that would need a colour conversion
(libjpeg-turbo converts none in lossless mode: YCbCr or YCCK, and grey
under ``IMREAD_COLOR``), fractional sampling ratios.

A file cut off or damaged is read as cv2.imread reads it: where a
Huffman scan's data runs out, the MCU under way finishes on zero bits and
later ones are left as they are (flat grey in a sequential file; zero
differences from the first-row predictor in a lossless one) until a
restart marker, and an arithmetic-coded scan reads on zeros; a cut inside
a marker segment reads on through the FF D9 pairs libjpeg-turbo's source
manager hands out past the end, then ends the file; a file that ends
before its first scan is refused with ValueError, as cv2 returns None.
(cv2.imdecode's memory source does not pad a cut file so, and its decode
of one differs.)

A JPEG-compressed TIFF's strips and tiles come here too
(``utils/tiff.py`` splices its JPEGTables in front and names the colour
conversion). ``read_coefficients`` gives a DCT-based file's quantised
coefficients, as libjpeg's ``jpeg_read_coefficients`` does.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import native

IMREAD_UNCHANGED, IMREAD_COLOR = -1, 1
_TABLE_BYTES = 16 + 256     # one Huffman table for the native side: counts, symbols
_MAX_PIXELS = 1 << 30       # cv2.imread's CV_IO_MAX_IMAGE_PIXELS
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])   # zigzag -> natural
# The frame headers libjpeg-turbo reads: (progressive, arithmetic, lossless).
_PROCESSES = {0xC0: (False, False, False), 0xC1: (False, False, False),
              0xC2: (True, False, False), 0xC3: (False, False, True),
              0xC9: (False, True, False), 0xCA: (True, True, False)}
# The ones it refuses (jdmarker.c JERR_SOF_UNSUPPORTED): cv2 returns None.
_UNSUPPORTED = {0xC5: "hierarchical sequential (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
                0xC7: "hierarchical lossless (SOF7)", 0xC8: "reserved SOF8 (JPG)",
                0xCB: "arithmetic-coded lossless (SOF11)",
                0xCD: "hierarchical arithmetic-coded sequential (SOF13)",
                0xCE: "hierarchical arithmetic-coded progressive (SOF14)",
                0xCF: "hierarchical arithmetic-coded lossless (SOF15)"}
# Markers read_markers skips or reads; any other is fatal (JERR_UNKNOWN_MARKER).
_KNOWN = {0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE, *_PROCESSES, *range(0xE0, 0xF0)}
# T.81 Annex K's tables (K.3-K.6), which libjpeg-turbo's sequential Huffman
# decoder (jdhuff.c jinit_huff_decoder, not the progressive or lossless
# ones) puts in place of a DC or AC table 0 or 1 that no DHT defined, as
# Motion-JPEG frames omit them: (class, number) -> 16 counts, the symbols.
_STD_TABLES = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], "000102030405060708090a0b"),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], "000102030405060708090a0b"),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a1617"
             "18191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a"
             "737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7"
             "b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
             "fa"),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
             "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
             "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
             "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
             "f9fa"),
}

_STD = {k: (bytes(bits) + bytes.fromhex(vals)).ljust(_TABLE_BYTES, b"\0")
        for k, (bits, vals) in _STD_TABLES.items()}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _pointers(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*[_ptr(a) for a in arrays])


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None           # latched at the component's first scan, as libjpeg does


class _Frame:
    """What the frame header says and the arrays its scans fill: int16
    coefficients [rows, stride, 64] per component, or for a lossless file
    uint8 samples [height, width]."""

    def __init__(self, code: int, seg: bytes):
        self.progressive, self.arith, self.lossless = _PROCESSES[code]
        precision, self.height, self.width, n = struct.unpack(">BHHB", seg[:6])
        self.precision = precision
        if self.lossless and not 2 <= precision <= 8:
            raise ValueError(f"a lossless JPEG of {precision}-bit samples: cv2 reads 2 to 8 "
                             f"bits (libjpeg-turbo's 8-bit interface)")
        if not self.lossless and precision != 8:
            raise ValueError(f"a JPEG of {precision}-bit samples: cv2 reads 8-bit ones "
                             f"(libjpeg-turbo's 8-bit interface)")
        if self.height == 0 or self.width == 0 or n == 0:
            raise ValueError("an empty JPEG frame (a zero size, a height left to a DNL "
                             "marker, or no components)")
        if self.width * self.height > _MAX_PIXELS:
            raise ValueError(f"a {self.width}x{self.height} JPEG is over cv2's limit of "
                             f"{_MAX_PIXELS} pixels")
        if len(seg) != 6 + 3 * n:
            raise ValueError("a JPEG frame header of the wrong length")
        self.comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                                 seg[8 + 3 * k]) for k in range(n)]
        if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in self.comps):
            raise ValueError("a JPEG frame header with bad sampling factors")
        self.max_h = max(c.h for c in self.comps)
        self.max_v = max(c.v for c in self.comps)
        unit = 1 if self.lossless else 8                   # a block: 8x8 samples, or one
        self.mcus_x = -(-self.width // (unit * self.max_h))
        self.mcus_y = -(-self.height // (unit * self.max_v))
        self.arrays = []
        for c in self.comps:
            c.bw = -(-self.width * c.h // (unit * self.max_h))    # blocks that hold samples
            c.bh = -(-self.height * c.v // (unit * self.max_v))
            c.stride = self.mcus_x * c.h                 # blocks an interleaved MCU row covers
            if self.lossless:
                self.arrays.append(np.zeros((c.bh, c.bw), np.uint8))
            else:
                self.arrays.append(np.zeros((self.mcus_y * c.v, c.stride, 64), np.int16))
        self.coef_bits = np.full((n, 64), -1, np.int32)   # jdphuff.c's coef_bits
        self.prev_bits = np.zeros((n, 64), np.int32)      # and before the scan
        self.scans, self.last_good = 0, -1                # last_good_iMCU_row
        self.multi_scan = False                           # has_multiple_scans
        self.scanned: set[int] = set()                    # components some scan held


def _color_transform(comps, jfif: bool, adobe: int | None, lossless: bool) -> int:
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
        if ids == (82, 71, 66):                   # 'R', 'G', 'B'
            return 2
        return 2 if lossless else 1               # RGB or YCbCr assumed without markers
    if n == 4:
        return 3 if adobe is None or adobe == 0 else 4
    raise ValueError(f"a JPEG of {n} components: libjpeg-turbo converts no colour space "
                     f"of theirs to the BGR cv2 asks for")


_SAVED = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]     # natural positions of zigzag 0..9


def _smoothing(frame: _Frame):
    """jdcoefct.c smoothing_ok: the native side's smoothing parameters, or
    None where libjpeg-turbo does not smooth (a sequential file, a table
    missing or with a zero among the ten quantisers, a component with no
    DC yet, or every one of coefficients 1..9 fully known). The iMCU rows
    after ``last_good`` take the scan before's bits."""
    comps, coef_bits = frame.comps, frame.coef_bits
    if not frame.progressive or any(c.quant is None or not c.quant[_SAVED].all()
                                    for c in comps):
        return None
    if (coef_bits[:, 0] < 0).any() or not coef_bits[:, 1:10].any():
        return None
    total_rows = -(-frame.height // (8 * frame.max_v))
    prev = frame.prev_bits[:, :10] if frame.scans > 1 else np.full_like(
        frame.prev_bits[:, :10], -1)
    return np.concatenate([[frame.last_good, total_rows],
                           np.concatenate([coef_bits[:, :10], prev], 1).ravel()]).astype(np.int32)


class _Tables:
    """The tables and settings the markers define, as libjpeg keeps them."""

    def __init__(self):
        self.quant: dict[int, np.ndarray] = {}
        self.dc: dict[int, bytes] = {}
        self.ac: dict[int, bytes] = {}
        # DAC conditioning per table, the defaults get_soi sets: L, U, Kx.
        self.cond = np.concatenate([np.zeros(16), np.ones(16), np.full(16, 5)]).astype(np.uint8)
        self.restart = 0
        self.jfif, self.adobe = False, None

    def dqt(self, seg: bytes) -> None:
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 15
            n = 128 if pq else 64
            if tq >= 4 or i + 1 + n > len(seg):
                raise ValueError(f"a JPEG quantisation table numbered {tq} or cut short by "
                                 f"its segment")
            table = np.zeros(64, np.uint16)
            table[_ZIGZAG] = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
            self.quant[tq] = table
            i += 1 + n

    def dht(self, seg: bytes) -> None:
        """jdmarker.c get_dht, with its checks."""
        i = 0
        while len(seg) - i > 16:
            tc, th = seg[i] >> 4, seg[i] & 15
            counts = seg[i + 1:i + 17]
            n = sum(counts)
            if n > 256 or n > len(seg) - i - 17 or seg[i] & 0xEC:
                raise ValueError("a malformed JPEG Huffman table")
            table = counts + seg[i + 17:i + 17 + n]
            (self.ac if tc else self.dc)[th] = table.ljust(_TABLE_BYTES, b"\0")
            i += 17 + n
        if i != len(seg):
            raise ValueError("a malformed JPEG Huffman table")

    def dac(self, seg: bytes) -> None:
        """jdmarker.c get_dac: (Tc << 4 | Tb, value) pairs."""
        if len(seg) % 2:
            raise ValueError("a JPEG DAC segment of odd length")
        for index, val in zip(seg[::2], seg[1::2]):
            if index >= 32:
                raise ValueError(f"a JPEG DAC segment for table index {index}")
            if index >= 16:
                self.cond[32 + index - 16] = val          # Kx of an AC table
            else:
                if val & 15 > val >> 4:
                    raise ValueError(f"a JPEG DAC segment with L > U ({val:#x})")
                self.cond[index], self.cond[16 + index] = val & 15, val >> 4


def _scan(lib, frame: _Frame, t: _Tables, seg: bytes, scan: np.ndarray) -> int:
    """One scan: its header checked as libjpeg-turbo checks it, its bytes
    (the rest of the file) decoded into the frame's arrays; returns the
    bytes it read before the marker it stopped at."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise ValueError("a JPEG scan header out of range")
    comps = frame.comps
    members = []
    for i in range(ns):
        # jdmarker.c get_sos: the first of the frame's first four components
        # with the id whose slot in the scan's list is still empty, which
        # takes the scan's components in frame order, each once.
        k = next((k for k in range(i, min(len(comps), 4)) if comps[k].cid == seg[1 + 2 * i]),
                 None)
        if k is None:
            raise ValueError(f"a JPEG scan names component {seg[1 + 2 * i]}, which its frame "
                             f"lacks or the scan names out of the frame's order")
        members.append(k)
    tables = [seg[2 + 2 * k] for k in range(ns)]
    if ns > 1 and sum(comps[k].h * comps[k].v for k in members) > 10:
        raise ValueError("a JPEG scan of more than 10 blocks an MCU (jdinput.c "
                         "D_MAX_BLOCKS_IN_MCU)")
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.progressive and ((se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
                              or (ah and al != ah - 1) or al > 13):
        process = "arithmetic-coded progressive" if frame.arith else "progressive"
        raise ValueError(f"a {process} JPEG scan header out of range: Ss {ss}, Se {se}, Ah "
                         f"{ah}, Al {al} (jdphuff.c, jdarith.c)")
    if frame.lossless and not (1 <= ss <= 7 and se == 0 and ah == 0
                               and al < frame.precision):
        raise ValueError(f"a lossless JPEG scan header out of range: predictor {ss}, Se "
                         f"{se}, Ah {ah}, point transform {al} (jdlossls.c)")
    if frame.scans == 0:
        frame.multi_scan = frame.progressive or ns < len(comps)
    frame.scans += 1
    frame.scanned.update(members)
    if frame.lossless:
        return _lossless_scan(lib, frame, t, members, tables, ss, al, scan)
    for k in members:           # jdinput.c latch_quant_tables
        c = comps[k]
        if c.quant is None:
            if c.tq not in t.quant:
                raise ValueError(f"a JPEG scan of a component whose quantisation table "
                                 f"{c.tq} is not defined")
            c.quant = t.quant[c.tq].copy()
    if frame.progressive:       # start_pass: the whole band counts as read
        for k in members:
            band = slice(min(ss, 1), max(se, 9) + 1)
            frame.prev_bits[k, band] = frame.coef_bits[k, band] if frame.scans > 1 else 0
            frame.coef_bits[k, ss:se + 1] = al
    if ns == 1:                 # one block per MCU over the component's own blocks
        c = comps[members[0]]
        desc = [1, 1, c.stride, 0]
        grid = (c.bw, c.bh)
    else:
        desc = [x for k in members for x in (comps[k].h, comps[k].v, comps[k].stride, 0)]
        grid = (frame.mcus_x, frame.mcus_y)
    desc = np.array(desc, np.int32)         # every array named: alive through the call
    arrays = _pointers([frame.arrays[k] for k in members])
    args = (int(frame.progressive), t.restart)
    out = np.zeros(2, np.int64)             # the last MCU begun with data left, bytes read
    if frame.arith:
        codes = np.array([x for b in tables for x in (b >> 4, b & 15)], np.int32)
        lib.dg_jpeg_arith_scan(_ptr(scan), len(scan), ns, arrays, _ptr(desc), _ptr(codes),
                               _ptr(t.cond), grid[0], grid[1], ss, se, ah, al, *args,
                               _ptr(out[1:]))
        out[0] = grid[0] * grid[1] - 1      # no out-of-data flag: every MCU counts as read
    else:
        std = {} if frame.progressive else _STD
        empty = b"\0" * _TABLE_BYTES
        dc = np.frombuffer(b"".join(t.dc.get(b >> 4, std.get((0, b >> 4), empty))
                                    for b in tables), np.uint8)
        ac = np.frombuffer(b"".join(t.ac.get(b & 15, std.get((1, b & 15), empty))
                                    for b in tables), np.uint8)
        if lib.dg_jpeg_scan(_ptr(scan), len(scan), ns, arrays, _ptr(desc), _ptr(dc), _ptr(ac),
                            grid[0], grid[1], ss, se, ah, al, *args, _ptr(out)):
            raise ValueError("a JPEG scan refers to a missing or malformed Huffman table")
    # The iMCU row of the last MCU begun with data left: the smoothing takes
    # the scan before's coefficient bits for the rows after it.
    frame.last_good = int(out[0]) // grid[0] // (comps[members[0]].v if ns == 1 else 1)
    return int(out[1])


def _lossless_scan(lib, frame: _Frame, t: _Tables, members, tables, psv: int, pt: int,
                   scan: np.ndarray) -> int:
    comps = frame.comps
    if len(members) == 1:
        c = comps[members[0]]
        grid = (c.bw, c.bh)                 # one sample per MCU
    else:
        grid = (frame.mcus_x, frame.mcus_y)
    if t.restart % grid[0]:
        raise ValueError(f"a lossless JPEG's restart interval {t.restart} is not a whole "
                         f"number of its MCU rows of {grid[0]} (jddiffct.c)")
    desc = np.array([x for k in members for x in (comps[k].h, comps[k].v, comps[k].bw,
                                                    comps[k].bh)], np.int32)
    empty = b"\0" * _TABLE_BYTES
    dc = np.frombuffer(b"".join(t.dc.get(b >> 4, empty) for b in tables), np.uint8)
    imcu_rows = -(-frame.height // frame.max_v)
    stop = np.zeros(1, np.int64)
    if lib.dg_jpeg_lossless_scan(_ptr(scan), len(scan), len(members),
                                 _pointers([frame.arrays[k] for k in members]), _ptr(desc),
                                 _ptr(dc), grid[0], grid[1], imcu_rows, psv, pt,
                                 frame.precision, t.restart, _ptr(stop)):
        raise ValueError("a lossless JPEG scan refers to a missing or malformed Huffman table")
    return int(stop[0])


def _read(data: bytes) -> tuple[_Frame, _Tables]:
    """Every marker and scan of a JPEG, as libjpeg-turbo reads them."""
    buf = np.frombuffer(data, np.uint8)
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise ValueError("not a JPEG file (no SOI marker)")
    lib = native.image_tools()
    t = _Tables()
    frame = None
    pos = 2
    while True:
        code = 0                                        # jdmarker.c next_marker: garbage,
        while code == 0:                                # fill bytes and FF 00 skipped
            while pos < len(buf) and buf[pos] != 0xFF:
                pos += 1
            while pos < len(buf) and buf[pos] == 0xFF:
                pos += 1
            if pos >= len(buf):
                break
            code = int(buf[pos])
            pos += 1
        if code == 0:
            break                                       # no EOI: the end of the file ends it
        if code == 0xD9:                                # EOI
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:        # RSTn or TEM outside a scan
            continue
        if code in _UNSUPPORTED:
            raise ValueError(f"a {_UNSUPPORTED[code]} JPEG: libjpeg-turbo does not read the "
                             f"process, and cv2 returns None")
        if code not in _KNOWN:
            raise ValueError(f"a JPEG with the marker 0x{code:02X}, which libjpeg-turbo does "
                             f"not know (SOI twice, DHP, EXP, JPGn or RESn)")
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
            t.jfif = True
        elif code == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            t.adobe = seg[11]
        elif code == 0xDB:
            t.dqt(seg)
        elif code == 0xC4:
            t.dht(seg)
        elif code == 0xCC:
            t.dac(seg)
        elif code == 0xDD:                              # DRI
            if len(seg) != 2:
                raise ValueError("a JPEG DRI segment of the wrong length")
            t.restart = struct.unpack(">H", seg)[0]
        elif code in _PROCESSES:
            if frame is not None:
                raise ValueError("a JPEG with two frame headers")
            frame = _Frame(code, seg)
        elif code == 0xDA:                              # SOS
            if frame is None:
                raise ValueError("a JPEG scan before its frame header")
            pos += _scan(lib, frame, t, seg, buf[pos:])
            if not frame.multi_scan:
                # One scan holds the image: cv2 has it once the scan is read,
                # whatever follows (libjpeg reads on only to find EOI).
                break
        if cut:
            break
    if frame is None:
        raise ValueError("a JPEG without a frame header")
    if frame.scans == 0:
        raise ValueError("a JPEG that ends before its first scan")   # cv2: no image
    return frame, t


def decode_jpeg(data: bytes, transform: int | None = None,
                flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (one component) or [H, W, 3] RGB, as
    ``cv2.imread`` under ``flags`` decodes them before its own conversions
    (which only a lossless file's colour conversion depends on).
    ``transform`` overrides the colour conversion the markers name (1
    YCbCr to RGB, 2 the components as stored), as libtiff sets libjpeg's
    colour spaces for a JPEG-compressed TIFF."""
    frame, t = _read(data)
    comps = frame.comps
    if transform is None or len(comps) != 3:
        transform = _color_transform(comps, t.jfif, t.adobe, frame.lossless)
    shape = (frame.height, frame.width) if transform == 0 else (frame.height, frame.width, 3)
    out = np.empty(shape, np.uint8)
    if frame.lossless:
        if transform in (1, 4) or (transform == 0 and flags == IMREAD_COLOR):
            space = {0: "grey", 1: "YCbCr", 4: "YCCK"}[transform]
            raise ValueError(f"a lossless JPEG in {space}, which cv2 asks libjpeg-turbo to "
                             f"give as {'CMYK' if transform == 4 else 'BGR'}: it converts "
                             f"no colour space in lossless mode")
        if len(frame.scanned) < len(comps):
            raise ValueError("a lossless JPEG that ends before a scan of each of its "
                             "components (cv2 returns None)")
        desc = np.array([x for c in comps for x in (c.h, c.v)], np.int32)
        if native.image_tools().dg_jpeg_lossless_finish(
                len(comps), _pointers(frame.arrays), _ptr(desc), frame.width, frame.height,
                frame.max_h, frame.max_v, transform, _ptr(out)):
            raise ValueError("a JPEG whose sampling factors are not integral ratios")
        return out
    desc = np.array([x for c in comps for x in (c.h, c.v, c.stride, c.bw, c.bh,
                                                int(c.quant is not None))], np.int32)
    q = np.stack([c.quant if c.quant is not None else np.zeros(64, np.uint16) for c in comps])
    smooth = _smoothing(frame)
    if native.image_tools().dg_jpeg_finish(
            len(comps), _pointers(frame.arrays), _ptr(desc), _ptr(q), frame.width,
            frame.height, frame.max_h, frame.max_v, transform,
            None if smooth is None else _ptr(smooth), _ptr(out)) != 0:
        raise ValueError("a JPEG whose sampling factors are not integral ratios")
    return out


def read_coefficients(data: bytes) -> dict:
    """A DCT-based JPEG's quantised coefficients, as libjpeg's
    ``jpeg_read_coefficients`` gives them: ``size`` (height, width),
    ``components`` [(id, h, v, quant table number)], ``quant`` {number:
    table in natural order}, and ``coefficients``, per component int16
    [rows, blocks across, 64] in natural order (padded to whole MCUs)."""
    frame, t = _read(data)
    if frame.lossless:
        raise ValueError("a lossless JPEG has no DCT coefficients")
    return {"size": (frame.height, frame.width),
            "components": [(c.cid, c.h, c.v, c.tq) for c in frame.comps],
            "quant": dict(t.quant), "coefficients": frame.arrays}
