"""Writes the fixtures of the port's arithmetic-coded and lossless JPEG
decoding into ``tests/fixtures/port_jpeg_variants/``, with cv2's decodes
beside them.

    python scripts/port_make_jpeg_variant_fixtures.py [--out tests/fixtures/port_jpeg_variants]

cv2 writes neither process, so the files come from this script's own
encoders, and cv2 (OpenCV 5.0 with libjpeg-turbo 3.1, which reads both)
judges every one of them:

- ``lossless``: a lossless (SOF3) Huffman encoder of 2- to 16-bit samples:
  any of the seven predictors, a point transform, restart intervals,
  interleaved or one scan per component, sampling factors, one table
  optimised for the image's difference categories (0 to 16) as libjpeg's
  ``jpeg_gen_optimal_table`` builds it;
- ``ArithEncoder`` and ``arith_scan``: the QM coder of T.81 Annex D as
  libjpeg-turbo's ``jcarith.c`` runs it, for sequential (SOF9) and
  progressive (SOF10) scans (DC first and refine, AC first and refine),
  with the conditioning of a DAC segment and restart markers;
- ``transcode``: the quantised coefficients of a Huffman JPEG (read by the
  port's own ``utils/jpeg.py`` ``read_coefficients``) written again with
  arithmetic coding, sequential or in a progressive scan script, so that
  the new file decodes to the old one's pixels (checked here against cv2).

Writes, beside each file, ``.npy`` of ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)`` in RGB order for the small ones, and
``decodes.json``: shape and SHA-256 of cv2.imread's decode of every file
under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR`` (key ``color``), null for
None. ``photo_512_arith.jpg`` is ``tests/fixtures/port_jpeg/photo_512.jpg``
transcoded to progressive arithmetic coding (the same pixels);
``photo_1024x768_arith.jpg`` is that folder's 1024x768 photo as sequential
arithmetic coding, and ``photo_256_lossless.jpg`` a 256x256 RGB lossless
photo, both for the card's decode timings.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "fixtures", "port_jpeg_variants")
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "port_jpeg")

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS | Switch_MPS << 7), and
# entry 113, the fixed estimate of probability 0.5 libjpeg adds for sign and
# refinement bits.
QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
      (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
      (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
      (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
      (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
      (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
      (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
      (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
      (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
      (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
      (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
      (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
      (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
      (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
      (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
      (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
      (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
      (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
      (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
      (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
      (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
      (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
      (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
      (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
      (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
      (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
      (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
      (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
      (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
QE_TABLE = [(qe, nm, nl | sw << 7) for qe, nl, nm, sw in QE]
FIXED = 113


# ------------------------------------------------------------------ segments

def segment(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") + payload


def jfif() -> bytes:
    return segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))


def sof(code: int, precision: int, h: int, w: int, comps) -> bytes:
    """comps: (id, h, v, quant table) per component."""
    return segment(code, bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                   + bytes([len(comps)]) + b"".join(bytes([i, hs << 4 | vs, tq])
                                                    for i, hs, vs, tq in comps))


def sos(comps, ss: int, se: int, ah: int, al: int) -> bytes:
    """comps: (id, DC table, AC table) per scan component."""
    return segment(0xDA, bytes([len(comps)]) + b"".join(bytes([i, td << 4 | ta])
                                                        for i, td, ta in comps)
                   + bytes([ss, se, ah << 4 | al]))


def dqt(tables: dict) -> bytes:
    """tables: number -> 64 values in natural order (8-bit)."""
    return segment(0xDB, b"".join(bytes([t]) + bytes(int(q[z]) for z in ZIGZAG)
                                  for t, q in tables.items()))


def dht(tc: int, th: int, bits, vals) -> bytes:
    return segment(0xC4, bytes([tc << 4 | th]) + bytes(bits) + bytes(vals))


def dri(n: int) -> bytes:
    return segment(0xDD, n.to_bytes(2, "big"))


def dac(conditions) -> bytes:
    """conditions: (class 0 DC / 1 AC, table, value): (U << 4 | L) or Kx."""
    return segment(0xCC, b"".join(bytes([tc << 4 | tb, v]) for tc, tb, v in conditions))


def markers_of(data: bytes, code: int) -> list[int]:
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == code]


# ------------------------------------------------------------------ Huffman

class BitWriter:
    """Huffman-coded bits, most significant first, 0xFF stuffed with 0x00,
    the last byte of a segment padded with ones."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = self.acc << length | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = self.acc >> self.n & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def optimal_table(freq) -> tuple[list, list]:
    """libjpeg's jpeg_gen_optimal_table: (16 counts, symbols) of a Huffman
    table for symbol frequencies ``freq`` (up to 256 symbols), no code
    longer than 16 bits and none all ones."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [s for size in range(1, 33) for s in range(256) if codesize[s] == size]
    return bits[1:17], vals


def huffman_codes(bits, vals) -> dict:
    """symbol -> (code, length) of a table's canonical codes."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


# ------------------------------------------------------------------ lossless

def _category(d: int) -> int:
    return 16 if d == 32768 else abs(int(d)).bit_length()


def _differences(x, psv: int, pt: int, precision: int, first_rows):
    """A component's difference rows (mod 2^16, in -32767..32768) from its
    samples as libjpeg-turbo's jdlossls.c predicts them: rows in
    ``first_rows`` by the first-row predictor, the others by ``psv`` with
    the sample above as the first column's."""
    x = x.astype(np.int64) >> pt
    d = np.zeros_like(x)
    for r in range(x.shape[0]):
        cur = x[r]
        ra = np.concatenate([[0], cur[:-1]])
        if r in first_rows:
            pred = ra.copy()
            pred[0] = 1 << (precision - pt - 1)
        else:
            rb = x[r - 1]
            rc = np.concatenate([[0], rb[:-1]])
            pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
            pred[0] = rb[0]
        d[r] = (cur - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def lossless(planes, comps, size, *, psv: int = 1, pt: int = 0, precision: int = 8,
             restart_rows: int = 0, interleave: bool = True, head: bytes = b"",
             frame_code: int = 0xC3) -> bytes:
    """A lossless JPEG of ``size`` (height, width): ``planes`` each
    component's samples at its own resolution (ceil(H v / max_v) rows,
    ceil(W h / max_h) columns), ``comps`` (id, h, v) per component; one
    interleaved scan or one scan per component; a restart every
    ``restart_rows`` MCU rows (0: none); ``head``: segments after SOI."""
    height, width = size
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    out = bytearray(b"\xff\xd8" + head)
    out += sof(frame_code, precision, height, width, [(i, hs, vs, 0) for i, hs, vs in comps])
    for members in [list(range(len(comps)))] if interleave else [[k] for k in range(len(comps))]:
        if len(members) > 1:
            mcus_x, mcus_y = -(-width // max_h), -(-height // max_v)
            geom = [comps[k][1:] for k in members]
        else:
            mcus_y, mcus_x = planes[members[0]].shape
            geom = [(1, 1)]
        # The undifferencers restart at the scan's start and at each restart
        # marker, which libjpeg-turbo reads before an MCU row; they act on the
        # first row of the iMCU row being decoded then (jddiffct.c).
        imcu = 1 if len(members) > 1 else comps[members[0]][2]
        resets = {0} | {r // imcu for r in range(mcus_y)
                        if restart_rows and r and r % restart_rows == 0}
        diffs = []
        for k in members:
            v = comps[k][2]
            first = {r for r in range(planes[k].shape[0]) if r % v == 0 and r // v in resets}
            diffs.append(_differences(planes[k], psv, pt, precision, first))
        freq = [0] * 17
        for d in diffs:
            cats = np.where(d == 32768, 16, np.ceil(np.log2(np.abs(d) + 1)).astype(np.int64))
            freq = [f + int((cats == c).sum()) for c, f in enumerate(freq)]
        freq[0] += 1                      # the padding samples' zero differences
        bits, vals = optimal_table(freq)
        codes = huffman_codes(bits, vals)
        w = BitWriter()
        for my in range(mcus_y):
            if restart_rows and my and my % restart_rows == 0:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            for mx in range(mcus_x):
                for (hs, vs), d in zip(geom, diffs):
                    for by in range(vs):
                        for bx in range(hs):
                            y, x = my * vs + by, mx * hs + bx
                            v = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0
                            c = _category(v)
                            w.put(*codes[c])
                            if 0 < c < 16:
                                w.put(v if v > 0 else v - 1, c)
        w.flush()
        out += dht(0, 0, bits, vals)
        if restart_rows:
            out += dri(restart_rows * mcus_x)
        out += sos([(comps[k][0], 0, 0) for k in members], psv, 0, 0, pt)
        out += w.out
    return bytes(out + b"\xff\xd9")


# ------------------------------------------------------------------ arithmetic

class ArithEncoder:
    """The QM coder as jcarith.c runs it: ``encode(stats, index, bit)``
    codes one binary decision with the statistics bin ``stats[index]``
    (state index | MPS << 7); ``finish`` flushes the interval (Annex D.1.8,
    final zero bytes left out) and returns the coded bytes."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _zeros(self) -> None:
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:                        # a carry over every stacked 0xFF byte
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, stats, i: int, val: int) -> None:
        sv = stats[i]
        qe, nm, nl = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:                     # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:                            # renormalise, a byte out every 8 shifts
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _magnitude(enc: ArithEncoder, stats, st: int, v: int, x1: int, ac: bool) -> int:
    """Figures F.8 and F.9: the magnitude category of ``v`` - 1 (``v`` > 0)
    from bin ``st`` (an AC coefficient takes a second decision there before
    its X1 bin ``x1``), then the bits below its top one. Returns m, the
    category's top bit (0 for ``v`` = 1), for the DC conditioning."""
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if not ac:
            st = x1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        elif v2:
            enc.encode(stats, st, 1)
            m <<= 1
            st = x1
            v2 >>= 1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(stats, st, 0)
    top = m
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1
    return top


class ArithScan:
    """One scan's arithmetic coding as jcarith.c's encode_mcu routines do
    it: DC statistics per DC table (64 bins) with the L and U of its
    conditioning, AC statistics per AC table (256 bins) with its Kx, a
    fixed bin of probability 0.5; both reset with the coder at every
    restart interval."""

    def __init__(self, dc_tables, ac_tables, cond_dc, cond_ac):
        self.dc_tables, self.ac_tables = dc_tables, ac_tables     # per scan component
        self.cond_dc, self.cond_ac = cond_dc, cond_ac             # table -> (L, U) / Kx
        self.reset()

    def reset(self):
        self.enc = ArithEncoder()
        self.dc = {t: bytearray(64) for t in self.dc_tables}
        self.ac = {t: bytearray(256) for t in self.ac_tables}
        self.fixed = bytearray([FIXED])
        self.last_dc = [0] * len(self.dc_tables)
        self.context = [0] * len(self.dc_tables)

    def dc_diff(self, ci: int, v: int) -> None:
        """Figure F.4 with the conditioning of F.1.4.4.1.2."""
        tbl = self.dc_tables[ci]
        stats, enc = self.dc[tbl], self.enc
        st = self.context[ci]
        if v == 0:
            enc.encode(stats, st, 0)
            self.context[ci] = 0
            return
        enc.encode(stats, st, 1)
        if v > 0:
            enc.encode(stats, st + 1, 0)
            st += 2
            self.context[ci] = 4
        else:
            v = -v
            enc.encode(stats, st + 1, 1)
            st += 3
            self.context[ci] = 8
        m = _magnitude(enc, stats, st, v, 20, False)
        lo, hi = self.cond_dc.get(tbl, (0, 1))
        if m < (1 << lo) >> 1:
            self.context[ci] = 0
        elif m > (1 << hi) >> 1:
            self.context[ci] += 8

    def ac_band(self, ci: int, coefs, ss: int, se: int) -> None:
        """Figure F.5 over positions ss..se (zigzag) of ``coefs`` (already
        shifted by the point transform, rounded towards 0)."""
        tbl = self.ac_tables[ci]
        stats, enc = self.ac[tbl], self.enc
        kx = self.cond_ac.get(tbl, 5)
        ke = se
        while ke >= ss and coefs[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)               # not the end of the block
            while coefs[k] == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            enc.encode(stats, st + 1, 1)
            v = coefs[k]
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            _magnitude(enc, stats, st + 2, abs(v), 189 if k <= kx else 217, True)
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)     # end of block

    def ac_refine(self, ci: int, coefs, ss: int, se: int, ah: int, al: int) -> None:
        """Figure G.10 (jcarith.c encode_mcu_AC_refine) on the block's
        coefficients ``coefs`` (zigzag, unshifted)."""
        stats, enc = self.ac[self.ac_tables[ci]], self.enc
        mag = [abs(int(c)) for c in coefs]
        ke = se
        while ke > 0 and mag[ke] >> al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and mag[kex] >> ah == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:                         # nonzero before: its next bit
                        enc.encode(stats, st + 2, v & 1)
                    else:                              # newly nonzero
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0, 1 if coefs[k] < 0 else 0)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)


def arith_scan(coefs, comps, members, grid, ss, se, ah, al, progressive, restart,
               tables, cond_dc, cond_ac) -> bytes:
    """One scan's entropy-coded bytes (with its RSTn markers): ``coefs``
    per frame component int [rows, stride, 64] (natural order), ``comps``
    (h, v) per frame component, ``members`` the scan's components, ``grid``
    its MCUs across and down (a one-component scan: the component's blocks),
    ``tables`` (DC table, AC table) per member."""
    scan = ArithScan([t[0] for t in tables], [t[1] for t in tables], cond_dc, cond_ac)
    out = bytearray()
    zz = np.array(ZIGZAG)
    mcus_x, mcus_y = grid
    n = 0
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if restart and n and n % restart == 0:
                out += scan.enc.finish()
                out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                scan.reset()
            n += 1
            for ci, k in enumerate(members):
                h, v = (1, 1) if len(members) == 1 else comps[k]
                for by in range(v):
                    for bx in range(h):
                        blk = coefs[k][my * v + by, mx * h + bx]
                        z = [int(x) for x in blk[zz]]
                        if not progressive:
                            scan.dc_diff(ci, z[0] - scan.last_dc[ci])
                            scan.last_dc[ci] = z[0]
                            scan.ac_band(ci, z, 1, 63)
                        elif ss == 0 and ah == 0:
                            dc = z[0] >> al
                            scan.dc_diff(ci, dc - scan.last_dc[ci])
                            scan.last_dc[ci] = dc
                        elif ss == 0:
                            scan.enc.encode(scan.fixed, 0, (z[0] >> al) & 1)
                        elif ah == 0:
                            shifted = [(abs(x) >> al) * (1 if x >= 0 else -1) for x in z]
                            scan.ac_band(ci, shifted, ss, se)
                        else:
                            scan.ac_refine(ci, z, ss, se, ah, al)
    out += scan.enc.finish()
    return bytes(out)


# Progressive scan scripts: (components, Ss, Se, Ah, Al), as libjpeg's
# jpeg_simple_progression writes them for YCbCr and for one component.
SCRIPT_COLOUR = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0)]
SCRIPT_GREY = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
               ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def transcode(data: bytes, *, progressive: bool = False, script=None, restart: int = 0,
              conditions=(), head: bytes | None = None, ids=None) -> bytes:
    """A Huffman JPEG's coefficients written again with arithmetic coding:
    SOF9 (one interleaved scan) or SOF10 in ``script`` (default: libjpeg's
    simple progression), a restart every ``restart`` MCUs, a DAC segment of
    ``conditions`` (class, table, value), the chroma components on DC and
    AC table 1. ``head``: the segments after SOI (default JFIF)."""
    sys.path.insert(0, ROOT)
    from dreamgaussian_tpu_torch.utils.jpeg import read_coefficients

    info = read_coefficients(data)
    height, width = info["size"]
    comps = info["components"]
    coefs = info["coefficients"]
    if ids is not None:
        comps = [(i, *c[1:]) for i, c in zip(ids, comps)]
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcus = (-(-width // (8 * max_h)), -(-height // (8 * max_v)))
    cond_dc = {tb: (v & 15, v >> 4) for tc, tb, v in conditions if tc == 0}
    cond_ac = {tb: v for tc, tb, v in conditions if tc == 1}
    out = bytearray(b"\xff\xd8" + (jfif() if head is None else head))
    out += dqt({t: q for t, q in info["quant"].items()})
    out += sof(0xCA if progressive else 0xC9, 8, height, width, comps)
    if conditions:
        out += dac(conditions)
    if restart:
        out += dri(restart)
    if not progressive:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    elif script is None:
        script = SCRIPT_COLOUR if len(comps) == 3 else SCRIPT_GREY
    for members, ss, se, ah, al in script:
        tables = [(min(k, 1), min(k, 1)) for k in members]
        if len(members) == 1:
            c = comps[members[0]]
            grid = (-(-width * c[1] // (8 * max_h)), -(-height * c[2] // (8 * max_v)))
        else:
            grid = mcus
        out += sos([(comps[k][0], *tb) for k, tb in zip(members, tables)], ss, se, ah, al)
        out += arith_scan(coefs, [c[1:3] for c in comps], list(members), grid, ss, se, ah, al,
                          progressive, restart, tables, cond_dc, cond_ac)
    return bytes(out + b"\xff\xd9")


# ------------------------------------------------------------------ the files

SMALL = (29, 37)            # height, width: no multiple of any MCU


def _sof_rewritten(data: bytes, code: int, precision: int | None = None) -> bytes:
    """``data`` with its frame header's marker (and precision) changed."""
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] in
             (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    out[i + 1] = code
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def lossless_files(photo) -> dict:
    rgb = photo(*SMALL, seed=11).astype(np.int64)
    grey = rgb[..., 1]
    planes = [rgb[..., k] for k in range(3)]
    ids = [(1, 1, 1), (2, 1, 1), (3, 1, 1)]
    rgb_ids = [(82, 1, 1), (71, 1, 1), (66, 1, 1)]
    f = {f"ll_grey_psv{p}": lossless([grey], [(1, 1, 1)], SMALL, psv=p) for p in range(1, 8)}
    f.update({f"ll_grey_pt{pt}": lossless([grey], [(1, 1, 1)], SMALL, psv=4, pt=pt)
              for pt in (1, 2, 3)})
    f["ll_grey_restart"] = lossless([grey], [(1, 1, 1)], SMALL, psv=5, restart_rows=3)
    f["ll_grey_6bit"] = lossless([grey >> 2], [(1, 1, 1)], SMALL, psv=6, precision=6)
    f["ll_grey_2bit"] = lossless([grey >> 6], [(1, 1, 1)], SMALL, psv=1, precision=2)
    f["ll_rgb_ids123"] = lossless(planes, ids, SMALL, psv=4)
    f["ll_rgb_idsRGB"] = lossless(planes, rgb_ids, SMALL, psv=7)
    f["ll_rgb_adobe0"] = lossless(planes, ids, SMALL, psv=2, head=adobe(0))
    f["ll_rgb_restart"] = lossless(planes, ids, SMALL, psv=6, restart_rows=2)
    f["ll_rgb_scans_restart"] = lossless(planes, rgb_ids, SMALL, psv=3, restart_rows=4,
                                         interleave=False)
    # Subsampled: green full size, red and blue at half width (and height).
    sub = [rgb[..., 1], rgb[::2, ::2, 0], rgb[:, ::2, 2]]
    f["ll_rgb_subsampled"] = lossless(sub, [(71, 2, 2), (82, 1, 1), (66, 1, 2)], SMALL, psv=7,
                                      restart_rows=3)
    cmyk = [rgb[..., 0], rgb[..., 1], rgb[..., 2], 255 - grey]
    f["ll_cmyk"] = lossless(cmyk, [(k + 1, 1, 1) for k in range(4)], SMALL, psv=1)
    # cv2's None: YCbCr by JFIF or Adobe 1, YCCK, 12 and 16 bits, two
    # components, a restart interval of part of an MCU row, a baseline
    # scan header under SOF3, and lossless arithmetic coding (SOF11).
    f["ll_rgb_jfif"] = lossless(planes, ids, SMALL, psv=1, head=jfif())
    f["ll_rgb_adobe1"] = lossless(planes, rgb_ids, SMALL, psv=1, head=adobe(1))
    f["ll_ycck"] = lossless(cmyk, [(k + 1, 1, 1) for k in range(4)], SMALL, head=adobe(2))
    f["ll_grey_12bit"] = lossless([grey << 4], [(1, 1, 1)], SMALL, precision=12)
    f["ll_grey_16bit"] = lossless([grey << 8], [(1, 1, 1)], SMALL, precision=16)
    f["ll_two_components"] = lossless(planes[:2], ids[:2], SMALL)
    bad = bytearray(lossless([grey], [(1, 1, 1)], SMALL, restart_rows=2))
    at = markers_of(bytes(bad), 0xDD)[0]
    bad[at + 4:at + 6] = (SMALL[1] + 5).to_bytes(2, "big")
    f["ll_grey_partial_restart"] = bytes(bad)
    f["ll_sof11"] = lossless([grey], [(1, 1, 1)], SMALL, frame_code=0xCB)
    # Cut off: in the middle of an RGB file, inside a restart interval
    # (whose rest decodes as zero differences), and a grey one early.
    whole = f["ll_rgb_ids123"]
    f["ll_cut_rgb_50"] = whole[:len(whole) // 2]
    rst = markers_of(f["ll_rgb_restart"], 0xD3)[0]
    f["ll_cut_rgb_restart"] = f["ll_rgb_restart"][:rst - 20]
    f["ll_cut_grey_20"] = f["ll_grey_psv1"][:len(f["ll_grey_psv1"]) // 5]
    return f


def arith_files(photo, cv2) -> dict:
    rgb = photo(*SMALL, seed=12)
    bgr = np.ascontiguousarray(rgb[..., ::-1])

    def huffman(img, *flags):
        ok, enc = cv2.imencode(".jpg", img, list(flags))
        assert ok
        return enc.tobytes()

    SF = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    base = huffman(bgr, cv2.IMWRITE_JPEG_QUALITY, 90)                  # 4:2:0
    b444 = huffman(bgr, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    b422 = huffman(bgr, SF, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    grey = huffman(rgb[..., 1].copy(), cv2.IMWRITE_JPEG_QUALITY, 80)
    dac_seq = [(0, 0, 0x52), (0, 1, 0x31), (1, 0, 2), (1, 1, 40)]
    dac_prog = [(0, 0, 0xF0), (0, 1, 0x00), (1, 0, 63), (1, 1, 1)]
    f = {
        "ar_seq_420": transcode(base),
        "ar_seq_444": transcode(b444),
        "ar_seq_422": transcode(b422),
        "ar_seq_grey": transcode(grey),
        "ar_seq_restart": transcode(base, restart=2),
        "ar_seq_dac": transcode(base, conditions=dac_seq),
        "ar_seq_rgb_ids": transcode(b444, head=adobe(0), ids=(82, 71, 66)),
        "ar_prog_420": transcode(base, progressive=True),
        "ar_prog_444": transcode(b444, progressive=True),
        "ar_prog_grey": transcode(grey, progressive=True),
        "ar_prog_restart_dac": transcode(base, progressive=True, restart=3,
                                         conditions=dac_prog),
    }
    prog = f["ar_prog_420"]
    # Unrefined: the first four scans and EOI (libjpeg-turbo's interblock
    # smoothing of the coefficients left unrefined).
    f["ar_prog_unrefined"] = prog[:markers_of(prog, 0xDA)[4]] + b"\xff\xd9"
    for name in ("ar_seq_420", "ar_prog_420"):
        data = f[name]
        for p in (40, 80):
            f[f"ar_cut_{name[3:]}_{p}"] = data[:len(data) * p // 100]
    scan = markers_of(prog, 0xDA)[5]
    f["ar_cut_prog_420_scan6"] = prog[:(scan + markers_of(prog, 0xDA)[6]) // 2]
    rs = f["ar_seq_restart"]
    rst = markers_of(rs, 0xD1)[0]
    f["ar_cut_seq_restart"] = rs[:rst - 3]
    # A Huffman file's frame header marked arithmetic-coded: its data read by
    # the QM decoder (bad arithmetic codes, cv2 decodes what it can), and a
    # baseline scan header under SOF10 (None).
    f["ar_rewritten_sof9"] = _sof_rewritten(base, 0xC9)
    progressive = huffman(bgr, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    f["ar_rewritten_sof10"] = _sof_rewritten(progressive, 0xCA)
    f["ar_rewritten_prog_sof9"] = _sof_rewritten(progressive, 0xC9)
    f["ar_rewritten_base_sof10"] = _sof_rewritten(base, 0xCA)
    # cv2's None: hierarchical and reserved processes, 12-bit samples, a DAC
    # with L > U.
    for code in (0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF):
        f[f"sof{code - 0xC0}"] = _sof_rewritten(base, code)
    f["sof1_12bit"] = _sof_rewritten(base, 0xC1, 12)
    f["ar_dac_l_over_u"] = transcode(base, conditions=[(0, 0, 0x13)])
    return f


def photo_files(photo, cv2) -> dict:
    f = {}
    with open(os.path.join(JPEG_FIXTURES, "photo_512.jpg"), "rb") as fh:
        f["photo_512_arith"] = transcode(fh.read(), progressive=True)
    with open(os.path.join(JPEG_FIXTURES, "photo_1024x768.jpg"), "rb") as fh:
        f["photo_1024x768_arith"] = transcode(fh.read())
    big = photo(256, 256, seed=13).astype(np.int64)
    f["photo_256_lossless"] = lossless([big[..., k] for k in range(3)],
                                       [(82, 1, 1), (71, 1, 1), (66, 1, 1)], (256, 256), psv=7)
    # load_rgba's and Mesh.load's inputs: the photo test_torch_process.py
    # mattes with U2Net, a disc GrabCut mattes, a texture.
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_image_cases import scene

    small = photo(150, 110, seed=7)
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(small[..., ::-1]))
    f["photo_110x150_arith"] = transcode(enc.tobytes(), progressive=True, restart=5)
    f["photo_110x150_lossless"] = lossless([small[..., k].astype(np.int64) for k in range(3)],
                                           [(1, 1, 1), (2, 1, 1), (3, 1, 1)], (150, 110), psv=1)
    disc = scene("disc", 96, 128, 5)
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(disc[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    f["disc_arith"] = transcode(enc.tobytes())
    f["disc_lossless"] = lossless([disc[..., k].astype(np.int64) for k in range(3)],
                                  [(82, 1, 1), (71, 1, 1), (66, 1, 1)], (96, 128), psv=4)
    tex = photo(48, 64, seed=14)
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(tex[..., ::-1]))
    f["texture_arith"] = transcode(enc.tobytes(), progressive=True)
    return f


def cv2_digest(img) -> dict | None:
    if img is None:
        return None
    rgb = np.ascontiguousarray(img if img.ndim == 2 else img[..., ::-1])
    return {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main(argv=None) -> None:
    import cv2     # the reference; the port itself never imports it

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from port_make_jpeg_fixtures import photo

    os.makedirs(args.out, exist_ok=True)
    for name in os.listdir(args.out):
        os.remove(os.path.join(args.out, name))
    files = {**lossless_files(photo), **arith_files(photo, cv2), **photo_files(photo, cv2)}
    # The transcodes hold the Huffman files' coefficients: the same pixels.
    for name, source in (("photo_512_arith", "photo_512"),
                         ("photo_1024x768_arith", "photo_1024x768")):
        want = cv2.imread(os.path.join(JPEG_FIXTURES, source + ".jpg"), cv2.IMREAD_UNCHANGED)
        got = cv2.imdecode(np.frombuffer(files[name], np.uint8), cv2.IMREAD_UNCHANGED)
        if got is None or not np.array_equal(got, want):
            raise RuntimeError(f"{name} does not decode to {source}.jpg's pixels under cv2")
    digests = {}
    for name, data in files.items():
        path = os.path.join(args.out, name + ".jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        dec = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        digests[name + ".jpg"] = {**(cv2_digest(dec) or {"shape": None, "sha256": None}),
                                  "color": cv2_digest(cv2.imread(path, cv2.IMREAD_COLOR))}
        if dec is not None and dec.shape[0] * dec.shape[1] <= SMALL[0] * SMALL[1]:
            np.save(os.path.join(args.out, name + ".npy"),
                    np.ascontiguousarray(dec if dec.ndim == 2 else dec[..., ::-1]))
    with open(os.path.join(args.out, "decodes.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    none = sorted(k for k, v in digests.items() if v["sha256"] is None)
    print(f"[fixtures] {len(digests)} JPEGs ({len(none)} None under cv2: {', '.join(none)}), "
          f"{total} bytes in {args.out}")


if __name__ == "__main__":
    main()
