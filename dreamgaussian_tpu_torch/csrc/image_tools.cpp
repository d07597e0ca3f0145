// Host-side image tools of the port: the JPEG decoder's pixel work and
// GrabCut's min-cut. Built and loaded by dreamgaussian_tpu_torch/native.py,
// exposed through a plain C ABI for ctypes.
//
// JPEG (utils/jpeg.py parses the markers and calls these):
//  - dg_jpeg_scan: Huffman decoding of one scan into the coefficient
//    arrays, sequential or progressive (DC/AC first and refinement passes,
//    EOB runs), with restart markers;
//  - dg_jpeg_arith_scan: the same for an arithmetic-coded scan (SOF9,
//    SOF10), libjpeg-turbo's QM decoder (jdarith.c) with the DAC
//    conditioning;
//  - dg_jpeg_lossless_scan and dg_jpeg_lossless_finish: a lossless (SOF3)
//    scan's Huffman-coded differences, predictors and point transform
//    straight to samples (libjpeg-turbo 3's jdlhuff.c, jddiffct.c,
//    jdlossls.c), then replicated chroma and the colour conversion;
//  - dg_jpeg_finish: libjpeg-turbo's interblock smoothing of unrefined
//    progressive coefficients (jdcoefct.c), dequantisation, libjpeg's
//    integer "islow" IDCT (jidctint.c, in the lanes of its x86 SIMD
//    version), libjpeg's "fancy" triangular chroma upsampling
//    (jdsample.c: h2v1, h1v2, h2v2; plain replication for other factors and
//    for components two samples wide or less), the fixed-point YCbCr->RGB
//    tables (jdcolor.c), YCCK->CMYK, and OpenCV's CMYK->BGR
//    (icvCvt_CMYK2BGR_8u_C4C3R). Every step is integer arithmetic, so the
//    result equals cv2.imread's (libjpeg-turbo) bit for bit.
// GrabCut (preprocess/grabcut.py):
//  - dg_maxflow: the Boykov-Kolmogorov max-flow of OpenCV's GCGraph
//    (modules/imgproc/src/gcgraph.hpp), on the edges in the order given.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <climits>
#include <vector>
#include <algorithm>

namespace {

// Zigzag position -> natural position, with libjpeg's 16 extra entries so
// that corrupt run lengths land on coefficient 63 instead of outside.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A Huffman table as jdhuff.c derives it: maxcode and value offset per
// code length (canonical codes).
struct Huff {
  bool present = false;
  int maxcode[18];
  int valoffset[17];
  uint8_t vals[256];
};

// table: 16 code counts then up to 256 symbols; all counts 0 = absent. A
// DC table's symbols (difference sizes) are at most `dc_max`, as jdhuff.c
// checks: 15 in a DCT-based scan, 16 in a lossless one; -1 for AC.
bool make_huff(const uint8_t* table, int dc_max, Huff* h) {
  int total = 0;
  for (int l = 0; l < 16; l++) total += table[l];
  if (total == 0) return true;
  if (total > 256) return false;
  std::memcpy(h->vals, table + 16, total);
  for (int i = 0; dc_max >= 0 && i < total; i++)
    if (h->vals[i] > dc_max) return false;
  int code = 0, p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = table[l - 1];
    if (n) {
      h->valoffset[l] = p - code;
      code += n;
      p += n;
      h->maxcode[l] = code - 1;
      if (code >= (1 << l)) return false;  // an all-ones code, as jdhuff.c refuses
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = INT_MAX;
  h->present = true;
  return true;
}

// A scan's entropy-coded bytes: the rest of the file from the scan's
// start, which the decoder reads up to the first marker it meets; the
// restart markers in them as jdmarker.c reads them. `p` ends where the
// scan stopped reading: Python reads the markers on from there.
struct Source {
  const uint8_t* p;
  const uint8_t* end;
  bool at_marker = false;   // p is on the 0xFF before an unread marker's code

  Source(const uint8_t* data, int64_t len) : p(data), end(data + len) {}
  // The unread marker's code; the end of the file stands for EOI, as
  // libjpeg's source manager inserts one there.
  int marker() const { return p + 1 < end ? p[1] : 0xD9; }
  // jdmarker.c next_marker: skip to the next marker, over stuffed 0xFF 0x00.
  void next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) p++;
      const uint8_t* q = p;
      while (q < end && *q == 0xFF) q++;
      if (q < end && *q == 0x00) {
        p = q + 1;
        continue;
      }
      p = q > p ? q - 1 : p;
      at_marker = true;
      return;
    }
  }
  // jdmarker.c read_restart_marker: read RSTn (`desired` = n),
  // resynchronising as jpeg_resync_to_restart does when another marker
  // stands there.
  void read_restart(int desired) {
    if (!at_marker) next_marker();
    for (;;) {
      int m = marker();
      if (m < 0xC0) {                         // not a valid marker: skipped, scan on
        p += 2;
        at_marker = false;
        next_marker();
        continue;
      }
      if (m < 0xD0 || m > 0xD7) break;        // not an RSTn: left unread, an empty interval
      int ahead = (m - 0xD0 - desired) & 7;
      if (ahead == 1 || ahead == 2) break;    // one of the next two RSTn: left unread
      p += 2;                                 // read it: the one expected, or one too far off
      at_marker = false;
      if (ahead < 6) break;
      next_marker();                          // one of the two before: scan on
    }
  }
};

// Huffman-coded bits, most significant first: 0xFF 0x00 is a data 0xFF,
// 0xFF fill bytes are skipped, and at a marker (or the end) zeros follow,
// as libjpeg inserts them. A read that takes more bits than the data held
// sets `insufficient`, as jdhuff.c's jpeg_fill_bit_buffer does when it
// pads with zeros; the block under way finishes on those zeros and the
// scan decoders skip every later MCU while the flag is set.
struct Bits : Source {
  uint64_t acc = 0;
  int n = 0;                // bits in acc
  int real = 0;             // of them, the leading ones read from the data
  bool insufficient = false;

  using Source::Source;
  void fill() {
    while (n <= 56) {
      int c = 0;
      if (!at_marker && p < end) {
        c = *p++;
        if (c == 0xFF) {
          while (p < end && *p == 0xFF) p++;
          if (p < end && *p == 0x00) {
            p++;
          } else {
            at_marker = true;
            p--;             // back onto the 0xFF before the marker's code
            c = 0;
          }
        }
        if (!at_marker) real += 8;
      }
      acc |= uint64_t(c) << (56 - n);
      n += 8;
    }
  }
  int get(int k) {          // k in 0..16
    if (k == 0) return 0;
    if (n < k) fill();
    if (k > real) insufficient = true;
    real = std::max(real - k, 0);
    int v = int(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huff& h) {
    int code = bit();
    int l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bit();
      if (++l > 16) return 0;     // corrupt: libjpeg warns and decodes 0
    }
    return h.vals[(h.valoffset[l] + code) & 0xFF];
  }
  // jdhuff.c/jdphuff.c process_restart: drop the bits left in the interval
  // and read RSTn; the out-of-data flag is cleared only when no marker is
  // left unread.
  void restart(int desired) {
    acc = 0;
    n = 0;
    real = 0;
    read_restart(desired);
    if (!at_marker) insufficient = false;
  }
};

// ---- Arithmetic decoding (jdarith.c) ----------------------------------------

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate of
// probability 0.5 for sign and refinement bits.
#define QE(i, qe, lps, mps, sw) ((int32_t(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAritab[114] = {
    QE(0, 0x5a1d, 1, 1, 1),      QE(1, 0x2586, 14, 2, 0),     QE(2, 0x1114, 16, 3, 0),
    QE(3, 0x080b, 18, 4, 0),     QE(4, 0x03d8, 20, 5, 0),     QE(5, 0x01da, 23, 6, 0),
    QE(6, 0x00e5, 25, 7, 0),     QE(7, 0x006f, 28, 8, 0),     QE(8, 0x0036, 30, 9, 0),
    QE(9, 0x001a, 33, 10, 0),    QE(10, 0x000d, 35, 11, 0),   QE(11, 0x0006, 9, 12, 0),
    QE(12, 0x0003, 10, 13, 0),   QE(13, 0x0001, 12, 13, 0),   QE(14, 0x5a7f, 15, 15, 1),
    QE(15, 0x3f25, 36, 16, 0),   QE(16, 0x2cf2, 38, 17, 0),   QE(17, 0x207c, 39, 18, 0),
    QE(18, 0x17b9, 40, 19, 0),   QE(19, 0x1182, 42, 20, 0),   QE(20, 0x0cef, 43, 21, 0),
    QE(21, 0x09a1, 45, 22, 0),   QE(22, 0x072f, 46, 23, 0),   QE(23, 0x055c, 48, 24, 0),
    QE(24, 0x0406, 49, 25, 0),   QE(25, 0x0303, 51, 26, 0),   QE(26, 0x0240, 52, 27, 0),
    QE(27, 0x01b1, 54, 28, 0),   QE(28, 0x0144, 56, 29, 0),   QE(29, 0x00f5, 57, 30, 0),
    QE(30, 0x00b7, 59, 31, 0),   QE(31, 0x008a, 60, 32, 0),   QE(32, 0x0068, 62, 33, 0),
    QE(33, 0x004e, 63, 34, 0),   QE(34, 0x003b, 32, 35, 0),   QE(35, 0x002c, 33, 9, 0),
    QE(36, 0x5ae1, 37, 37, 1),   QE(37, 0x484c, 64, 38, 0),   QE(38, 0x3a0d, 65, 39, 0),
    QE(39, 0x2ef1, 67, 40, 0),   QE(40, 0x261f, 68, 41, 0),   QE(41, 0x1f33, 69, 42, 0),
    QE(42, 0x19a8, 70, 43, 0),   QE(43, 0x1518, 72, 44, 0),   QE(44, 0x1177, 73, 45, 0),
    QE(45, 0x0e74, 74, 46, 0),   QE(46, 0x0bfb, 75, 47, 0),   QE(47, 0x09f8, 77, 48, 0),
    QE(48, 0x0861, 78, 49, 0),   QE(49, 0x0706, 79, 50, 0),   QE(50, 0x05cd, 48, 51, 0),
    QE(51, 0x04de, 50, 52, 0),   QE(52, 0x040f, 50, 53, 0),   QE(53, 0x0363, 51, 54, 0),
    QE(54, 0x02d4, 52, 55, 0),   QE(55, 0x025c, 53, 56, 0),   QE(56, 0x01f8, 54, 57, 0),
    QE(57, 0x01a4, 55, 58, 0),   QE(58, 0x0160, 56, 59, 0),   QE(59, 0x0125, 57, 60, 0),
    QE(60, 0x00f6, 58, 61, 0),   QE(61, 0x00cb, 59, 62, 0),   QE(62, 0x00ab, 61, 63, 0),
    QE(63, 0x008f, 61, 32, 0),   QE(64, 0x5b12, 65, 65, 1),   QE(65, 0x4d04, 80, 66, 0),
    QE(66, 0x412c, 81, 67, 0),   QE(67, 0x37d8, 82, 68, 0),   QE(68, 0x2fe8, 83, 69, 0),
    QE(69, 0x293c, 84, 70, 0),   QE(70, 0x2379, 86, 71, 0),   QE(71, 0x1edf, 87, 72, 0),
    QE(72, 0x1aa9, 87, 73, 0),   QE(73, 0x174e, 72, 74, 0),   QE(74, 0x1424, 72, 75, 0),
    QE(75, 0x119c, 74, 76, 0),   QE(76, 0x0f6b, 74, 77, 0),   QE(77, 0x0d51, 75, 78, 0),
    QE(78, 0x0bb6, 77, 79, 0),   QE(79, 0x0a40, 77, 48, 0),   QE(80, 0x5832, 80, 81, 1),
    QE(81, 0x4d1c, 88, 82, 0),   QE(82, 0x438e, 89, 83, 0),   QE(83, 0x3bdd, 90, 84, 0),
    QE(84, 0x34ee, 91, 85, 0),   QE(85, 0x2eae, 92, 86, 0),   QE(86, 0x299a, 93, 87, 0),
    QE(87, 0x2516, 86, 71, 0),   QE(88, 0x5570, 88, 89, 1),   QE(89, 0x4ca9, 95, 90, 0),
    QE(90, 0x44d9, 96, 91, 0),   QE(91, 0x3e22, 97, 92, 0),   QE(92, 0x3824, 99, 93, 0),
    QE(93, 0x32b4, 99, 94, 0),   QE(94, 0x2e17, 93, 86, 0),   QE(95, 0x56a8, 95, 96, 1),
    QE(96, 0x4f46, 101, 97, 0),  QE(97, 0x47e5, 102, 98, 0),  QE(98, 0x41cf, 103, 99, 0),
    QE(99, 0x3c3d, 104, 100, 0), QE(100, 0x375e, 99, 93, 0),  QE(101, 0x5231, 105, 102, 0),
    QE(102, 0x4c0f, 106, 103, 0), QE(103, 0x4639, 107, 104, 0), QE(104, 0x415e, 103, 99, 0),
    QE(105, 0x5627, 105, 106, 1), QE(106, 0x50e7, 108, 107, 0), QE(107, 0x4b85, 109, 103, 0),
    QE(108, 0x5597, 110, 109, 0), QE(109, 0x504f, 111, 107, 0), QE(110, 0x5a10, 110, 111, 1),
    QE(111, 0x5522, 112, 109, 0), QE(112, 0x59eb, 112, 111, 1), QE(113, 0x5a1d, 113, 113, 0)};
#undef QE

// The QM decoder of jdarith.c: C holds the code register and the input
// bits with a floating cut-point (ct), A the interval. At a marker (or the
// end of the bytes) zeros are read on, as libjpeg supplies them; ct == -1
// is the state after "bad arithmetic code", where the scan decodes nothing
// more until a restart re-initialises it.
struct Arith : Source {
  int64_t c = 0, a = 0;
  int ct = -16;             // -16: the two initial bytes still to read

  using Source::Source;
  int byte() {
    if (at_marker) return 0;
    if (p >= end) {
      at_marker = true;
      return 0;
    }
    int v = *p++;
    if (v != 0xFF) return v;
    while (p < end && *p == 0xFF) p++;
    if (p < end && *p == 0x00) {
      p++;
      return 0xFF;
    }
    at_marker = true;
    p--;                     // back onto the 0xFF before the marker's code
    return 0;
  }
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  // arith_decode: one binary decision with the statistics bin *st (state
  // index | MPS << 7), updated.
  int decode(uint8_t* st) {
    while (a < 0x8000) {                       // renormalisation and input (D.2.6)
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;          // the two initial bytes read
        }
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    uint8_t nl = qe & 0xFF;
    qe >>= 8;
    uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {                           // the less probable interval
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// One scan's statistics: DC per table (64 bins, with L and U), AC per table
// (256 bins, with Kx), the fixed bin; the DC predictions and contexts per
// scan component.
struct ArithScan {
  Arith ar;
  uint8_t dc_stats[16][64];
  uint8_t ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int ss, se, ah, al;
  const uint8_t* cond;      // L[16], U[16], K[16]
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};

  ArithScan(const uint8_t* data, int64_t len, int ss_, int se_, int ah_, int al_,
            const uint8_t* cond_)
      : ar(data, len), ss(ss_), se(se_), ah(ah_), al(al_), cond(cond_) {}

  // Figures F.21-F.24: a nonzero value's sign was read; its magnitude
  // category from bin st (then x1 on), then its bits. Returns the value's
  // magnitude less one and sets *m to the category's top bit; -1 after a
  // magnitude overflow (ct = -1).
  int magnitude(uint8_t* st, uint8_t* x1, bool ac, int* m_out) {
    int m = ar.decode(st);
    if (m) {
      if (ac) {
        if (ar.decode(st)) {
          m <<= 1;
          st = x1;
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) return -1;
            st += 1;
          }
        }
      } else {
        st = x1;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return -1;
          st += 1;
        }
      }
    }
    *m_out = m;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    return v;
  }

  // Figure F.19 with the conditioning of F.1.4.4.1.2: the DC difference
  // into last_dc[ci]. False after a magnitude overflow.
  bool dc(int ci, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (ar.decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m;
    int v = magnitude(st, dc_stats[tbl] + 20, false, &m);
    if (v < 0) {
      ar.ct = -1;
      return false;
    }
    if (m < int((1L << cond[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > int((1L << cond[16 + tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
    return true;
  }

  // Figure F.20 over zigzag positions k0..kend into blk (shifted by
  // shift). False after a spectral or magnitude overflow (ct = -1).
  bool ac(int tbl, int k0, int kend, int shift, int16_t* blk) {
    uint8_t* stats = ac_stats[tbl];
    for (int k = k0; k <= kend; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;                // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > kend) {
          ar.ct = -1;
          return false;
        }
      }
      int sign = ar.decode(&fixed_bin);
      int m;
      int v = magnitude(st + 2, stats + (k <= cond[32 + tbl] ? 189 : 217), true, &m);
      if (v < 0) {
        ar.ct = -1;
        return false;
      }
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << shift);
    }
    return true;
  }

  // jdarith.c decode_mcu_AC_refine for one block.
  void ac_refine(int tbl, int16_t* blk) {
    uint8_t* stats = ac_stats[tbl];
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;     // end of block
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c) {                              // nonzero before: its next bit
          if (ar.decode(st + 2)) *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
          break;
        }
        if (ar.decode(st + 1)) {               // newly nonzero
          *c = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return;
        }
      }
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Scan {
  int ss, se, ah, al;
  int eobrun = 0;
};

// jdhuff.c decode_mcu for one block of a sequential scan.
void block_sequential(Bits& br, const Huff& dc, const Huff& ac, int* last_dc, int16_t* blk) {
  int s = br.decode(dc);
  int diff = s ? extend(br.get(s), s) : 0;
  *last_dc = int(unsigned(*last_dc) + unsigned(diff));
  blk[0] = int16_t(*last_dc);
  for (int k = 1; k < 64; k++) {
    int rs = br.decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(extend(br.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// jdphuff.c decode_mcu_DC_first / _DC_refine for one block.
void block_dc_first(Bits& br, const Huff& dc, int* last_dc, int al, int16_t* blk) {
  int s = br.decode(dc);
  int diff = s ? extend(br.get(s), s) : 0;
  *last_dc = int(unsigned(*last_dc) + unsigned(diff));
  blk[0] = int16_t(unsigned(*last_dc) << al);
}

void block_dc_refine(Bits& br, int al, int16_t* blk) {
  if (br.bit()) blk[0] = int16_t(blk[0] | (1 << al));
}

// jdphuff.c decode_mcu_AC_first for one block.
void block_ac_first(Bits& br, const Huff& ac, Scan& sc, int16_t* blk) {
  if (sc.eobrun > 0) {
    sc.eobrun--;
    return;
  }
  for (int k = sc.ss; k <= sc.se; k++) {
    int rs = br.decode(ac);
    int r = rs >> 4;
    int s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(unsigned(extend(br.get(s), s)) << sc.al);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        sc.eobrun--;
        break;
      }
    }
  }
}

// jdphuff.c decode_mcu_AC_refine for one block.
void block_ac_refine(Bits& br, const Huff& ac, Scan& sc, int16_t* blk) {
  const int p1 = 1 << sc.al;
  const int m1 = -1 * (1 << sc.al);
  int k = sc.ss;
  auto correct = [&](int16_t* c) {
    if (br.bit() && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
  };
  if (sc.eobrun == 0) {
    for (; k <= sc.se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = br.bit() ? p1 : m1;     // a newly nonzero coefficient is +-1 << al
      } else if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        break;                      // the rest of the block is the EOB run's
      }
      // Advance over nonzero coefficients (appending their correction bits)
      // and r zero ones.
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          correct(c);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = int16_t(s);
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; k++) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0) correct(c);
    }
    sc.eobrun--;
  }
}

// ---- IDCT (libjpeg-turbo's jsimd_idct_islow) -------------------------------
//
// jidctint.c's integer "islow" IDCT in the arithmetic of libjpeg-turbo's
// x86 SIMD version (jidctint-sse2.asm / -avx2.asm), which cv2's decoder
// runs: dequantisation and the sums in0 +- in4, in7 + in3 and in5 + in1 in
// 16-bit lanes that wrap, products and the rest in 32-bit lanes, each pass's
// output saturated to 16 bits and the samples to 8, and the first pass
// skipped for the whole block (the DC shifted in 16 bits) when rows 1..7
// hold no coefficient. On the coefficients of valid data none of that
// wraps or saturates, and the result is jidctint.c's; it differs on the
// blocks a corrupt or cut-off file decodes to, and cv2's is this one.

const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int16_t wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int32_t add32(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {   // pmaddwd
  return add32(int32_t(a) * ca, int32_t(b) * cb);
}
inline int16_t sat16(int32_t x) { return int16_t(std::min(std::max(x, -32768), 32767)); }

// One pass over 8 values (in(0..7), int16), out(i, 32-bit sum) before descaling.
template <typename In, typename Out>
inline void idct_1d(const In& in, Out out) {
  int16_t z2 = in(2), z3 = in(6);
  int32_t tmp3 = madd(z2, FIX_0_541196100 + FIX_0_765366865, z3, FIX_0_541196100);
  int32_t tmp2 = madd(z2, FIX_0_541196100, z3, FIX_0_541196100 - FIX_1_847759065);
  int32_t tmp0 = int32_t(uint32_t(int32_t(wrap16(in(0) + in(4)))) << CONST_BITS);
  int32_t tmp1 = int32_t(uint32_t(int32_t(wrap16(in(0) - in(4)))) << CONST_BITS);
  int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  int16_t i7 = in(7), i5 = in(5), i3 = in(3), i1 = in(1);
  int16_t s3 = wrap16(i7 + i3), s4 = wrap16(i5 + i1);
  int32_t z3o = madd(s3, FIX_1_175875602 - FIX_1_961570560, s4, FIX_1_175875602);
  int32_t z4o = madd(s3, FIX_1_175875602, s4, FIX_1_175875602 - FIX_0_390180644);
  int32_t o0 = add32(madd(i7, FIX_0_298631336 - FIX_0_899976223, i1, -FIX_0_899976223), z3o);
  int32_t o3 = add32(madd(i7, -FIX_0_899976223, i1, FIX_1_501321110 - FIX_0_899976223), z4o);
  int32_t o1 = add32(madd(i5, FIX_2_053119869 - FIX_2_562915447, i3, -FIX_2_562915447), z4o);
  int32_t o2 = add32(madd(i5, -FIX_2_562915447, i3, FIX_3_072711026 - FIX_2_562915447), z3o);
  out(0, add32(tmp10, o3));
  out(7, sub32(tmp10, o3));
  out(1, add32(tmp11, o2));
  out(6, sub32(tmp11, o2));
  out(2, add32(tmp12, o1));
  out(5, sub32(tmp12, o1));
  out(3, add32(tmp13, o0));
  out(4, sub32(tmp13, o0));
}

inline int16_t descale16(int32_t x, int n) { return sat16(add32(x, 1 << (n - 1)) >> n); }

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];
  bool ac = false;
  for (int i = 8; i < 64; i++) ac = ac || coef[i] != 0;
  if (!ac) {                          // pass 1 of a block with row 0 alone
    for (int c = 0; c < 8; c++) {
      int16_t dc = wrap16(int32_t(uint32_t(int32_t(wrap16(coef[c] * q[c]))) << PASS1_BITS));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {     // pass 1: columns
      auto in = [&](int r) { return wrap16(coef[r * 8 + c] * q[r * 8 + c]); };
      idct_1d(in, [&](int r, int32_t v) { ws[r * 8 + c] = descale16(v, CONST_BITS - PASS1_BITS); });
    }
  }
  for (int r = 0; r < 8; r++) {       // pass 2: rows
    const int16_t* w = ws + r * 8;
    auto in = [&](int c) { return w[c]; };
    uint8_t* o = out + size_t(r) * stride;
    idct_1d(in, [&](int c, int32_t v) {
      int x = descale16(v, CONST_BITS + PASS1_BITS + 3);
      o[c] = uint8_t(std::min(std::max(x, -128), 127) + 128);
    });
  }
}

// ---- Interblock smoothing (jdcoefct.c decompress_smooth_data) ---------------

// libjpeg-turbo's estimate of one coefficient from the DC neighbourhood:
// num scaled by the coefficient's quantiser, rounded to nearest, and kept
// below the precision still unknown (al bits) when al > 0.
inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
  return int16_t(num >= 0 ? pred : -pred);
}

// One component's blocks with the unrefined low coefficients estimated,
// as libjpeg-turbo >= 2.1 does for a progressive file. bits[0..9]: the
// latched coef_bits of the rows read in full; prev[0..9]: those of the
// scan before, used for iMCU rows past last_good. A coefficient is
// estimated when it is still zero and its bits are not 0; with no AC bits
// known at all (change_dc) the 5x5 DC neighbourhood also replaces the DC
// and estimates four more coefficients.
void smooth_component(const int16_t* coefs, int stride, int bw, int bh, int v,
                      int total_rows, int last_good, const int32_t* bits_good,
                      const int32_t* bits_prev, const uint16_t* q, int16_t* out) {
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2],
                Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  const int last_row = total_rows - 1;
  for (int r = 0; r * v < bh; r++) {
    const int32_t* bits = r > last_good ? bits_prev : bits_good;
    bool change_dc = true;
    for (int i = 1; i < 10; i++) change_dc = change_dc && bits[i] == -1;
    int block_rows = v;
    if (r == last_row) {
      block_rows = bh % v;
      if (block_rows == 0) block_rows = v;
    }
    // (libjpeg-turbo counts the image's block rows with this iMCU row's
    // count, which differs on a short last row.)
    int image_rows = block_rows * total_rows;
    for (int br = 0; br < block_rows; br++) {
      int by = r * v + br, ib = r * block_rows + br;
      auto row = [&](int y) { return coefs + int64_t(y) * stride * 64; };
      const int16_t* cur = row(by);
      const int16_t* prv = ib > 0 ? row(by - 1) : cur;
      const int16_t* pp = ib > 1 ? row(by - 2) : prv;
      const int16_t* nxt = ib < image_rows - 1 ? row(by + 1) : cur;
      const int16_t* nn = ib < image_rows - 2 ? row(by + 2) : nxt;
      const int16_t* rows[5] = {pp, prv, cur, nxt, nn};
      int D[5][5];                 // DC01..DC25, row by row
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) D[i][j] = rows[i][0];
      const int last_col = bw - 1;
      for (int bx = 0; bx < bw; bx++) {
        if (bx == 0 && bx < last_col)
          for (int i = 0; i < 5; i++) D[i][3] = D[i][4] = rows[i][64];
        if (bx + 1 < last_col)
          for (int i = 0; i < 5; i++) D[i][4] = rows[i][(bx + 2) * 64];
        int16_t* w = out + (int64_t(by) * stride + bx) * 64;
        std::memcpy(w, cur + int64_t(bx) * 64, 64 * sizeof(int16_t));
        const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3], DC05 = D[0][4],
                  DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3], DC10 = D[1][4],
                  DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4],
                  DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
                  DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3], DC25 = D[4][4];
        int al;
        if ((al = bits[1]) != 0 && w[1] == 0)
          w[1] = smooth_pred(Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, al);
        if ((al = bits[2]) != 0 && w[8] == 0)
          w[8] = smooth_pred(Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
               13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, al);
        if ((al = bits[3]) != 0 && w[16] == 0)
          w[16] = smooth_pred(Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20, al);
        if ((al = bits[4]) != 0 && w[9] == 0)
          w[9] = smooth_pred(Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
               10 * DC07 - 10 * DC09)), Q11, al);
        if ((al = bits[5]) != 0 && w[2] == 0)
          w[2] = smooth_pred(Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
               2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02, al);
        if (change_dc) {
          if ((al = bits[6]) != 0 && w[3] == 0)
            w[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
          if ((al = bits[7]) != 0 && w[10] == 0)
            w[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
          if ((al = bits[8]) != 0 && w[17] == 0)
            w[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
          if ((al = bits[9]) != 0 && w[24] == 0)
            w[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
          w[0] = smooth_pred(Q00 * (
              -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
              42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
              8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
              6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), Q00, 0);
        }
        for (int i = 0; i < 5; i++)        // slide the window one column right
          for (int j = 0; j < 4; j++) D[i][j] = D[i][j + 1];
      }
    }
  }
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One component's samples [dh, dw] upsampled by (hx, vx) to [oh, ow]
// (oh <= dh * vx, ow <= dw * hx), as jdsample.c does it with fancy
// upsampling on (off: plain replication, as libjpeg-turbo upsamples a
// lossless file); rows and columns past the component's edge repeat its
// last one, as jdmainct.c's context rows do.
void upsample(const uint8_t* in, int dw, int dh, int hx, int vx, uint8_t* out, int ow, int oh,
              bool fancy) {
  auto at = [&](int y, int x) {
    y = std::min(std::max(y, 0), dh - 1);
    x = std::min(std::max(x, 0), dw - 1);
    return int(in[size_t(y) * dw + x]);
  };
  const bool h2 = fancy && hx == 2 && vx == 1 && dw > 2;
  const bool v2 = fancy && hx == 1 && vx == 2;
  const bool hv2 = fancy && hx == 2 && vx == 2 && dw > 2;
  for (int y = 0; y < oh; y++) {
    uint8_t* o = out + size_t(y) * ow;
    if (h2) {                          // h2v1_fancy_upsample
      for (int x = 0; x < ow; x++) {
        int i = x >> 1, near = at(y, i) * 3;
        o[x] = uint8_t((x & 1) ? (near + at(y, i + 1) + 2) >> 2 : (near + at(y, i - 1) + 1) >> 2);
      }
    } else if (v2) {                   // h1v2_fancy_upsample
      int i = y >> 1;
      int other = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < ow; x++) o[x] = uint8_t((at(i, x) * 3 + at(other, x) + bias) >> 2);
    } else if (hv2) {                  // h2v2_fancy_upsample
      int i = y >> 1, other = (y & 1) ? i + 1 : i - 1;
      auto colsum = [&](int x) { return at(i, x) * 3 + at(other, x); };
      for (int x = 0; x < ow; x++) {
        int j = x >> 1, here = colsum(j) * 3;
        o[x] = uint8_t((x & 1) ? (here + colsum(j + 1) + 7) >> 4 : (here + colsum(j - 1) + 8) >> 4);
      }
    } else {                           // fullsize, h2v1/h2v2 plain, int_upsample
      for (int x = 0; x < ow; x++) o[x] = uint8_t(at(y / vx, x / hx));
    }
  }
}

// ---- Max-flow (OpenCV's GCGraph) -------------------------------------------

struct Vtx {
  Vtx* next;
  int parent;
  int first;
  int ts;
  int dist;
  double weight;
  uint8_t t;
};

struct Edge {
  int dst;
  int next;
  double weight;
};

// Every component's full-size plane into out [n, 1 or 3]. transform: 0
// grey, 1 YCbCr->RGB, 2 RGB as stored, 3 CMYK, 4 YCCK (both then OpenCV's
// CMYK->BGR, written as RGB).
void convert(const std::vector<std::vector<uint8_t>>& planes, size_t n, int transform,
             uint8_t* out) {
  if (transform == 0) {
    std::memcpy(out, planes[0].data(), n);
    return;
  }
  // jdcolor.c build_ycc_rgb_table
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
  auto fix = [](double x) { return int64_t(x * (1L << 16) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  for (size_t i = 0; i < n; i++) {
    int a = planes[0][i], b = planes[1][i], c = planes[2][i];
    int r = a, g = b, bl = c;                          // RGB and CMYK as stored
    if (transform == 1 || transform == 4) {            // ycc_rgb_convert
      r = a + cr_r[c];
      g = a + int((cb_g[b] + cr_g[c]) >> SCALEBITS);
      bl = a + cb_b[b];
      if (transform == 4) {                            // ycck_cmyk_convert
        r = 255 - r;
        g = 255 - g;
        bl = 255 - bl;
      }
      r = clamp255(r);
      g = clamp255(g);
      bl = clamp255(bl);
    }
    if (transform >= 3) {                              // icvCvt_CMYK2BGR_8u_C4C3R
      int k = planes[3][i];
      r = k - ((255 - r) * k >> 8);
      g = k - ((255 - g) * k >> 8);
      bl = k - ((255 - bl) * k >> 8);
    }
    out[i * 3] = uint8_t(r);
    out[i * 3 + 1] = uint8_t(g);
    out[i * 3 + 2] = uint8_t(bl);
  }
}

}  // namespace

extern "C" {

// Decode one scan. data/len: its entropy-coded bytes up to the next marker
// other than RSTn. Per scan component c: coefs[c] its int16 [rows, stride,
// 64] array, desc[c*4 ..] = (h, v, stride, unused): blocks per MCU across
// and down (1, 1 in a scan of one component) and the array's row width in
// blocks; dc/ac[c*272 ..] its tables (16 counts, 256 symbols; all counts 0
// where the scan needs none). mcus_x, mcus_y: the scan's MCU grid. Writes
// to out[0] the last MCU begun with data left (jdcoefct.c's
// last_good_iMCU_row is its iMCU row) and to out[1] the bytes the scan
// read before the marker it stopped at.
// Returns 0, or 1 for a table the scan needs that is missing or malformed.
int dg_jpeg_scan(const uint8_t* data, int64_t len, int ncomp, int16_t** coefs,
                 const int32_t* desc, const uint8_t* dc, const uint8_t* ac, int mcus_x,
                 int mcus_y, int ss, int se, int ah, int al, int progressive,
                 int restart_interval, int64_t* out) {
  std::vector<Huff> dct(ncomp), act(ncomp);
  for (int c = 0; c < ncomp; c++) {
    if (!make_huff(dc + c * 272, 15, &dct[c]) || !make_huff(ac + c * 272, -1, &act[c]))
      return 1;
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !progressive || ss > 0;
    if ((need_dc && !dct[c].present) || (need_ac && !act[c].present)) return 1;
  }
  Bits br(data, len);
  Scan sc{ss, se, ah, al};
  std::vector<int> last_dc(ncomp, 0);
  int64_t n_mcus = int64_t(mcus_x) * mcus_y;
  int next_rst = 0;
  out[0] = -1;
  for (int64_t m = 0; m < n_mcus; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      br.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      std::fill(last_dc.begin(), last_dc.end(), 0);
      sc.eobrun = 0;
    }
    if (br.insufficient) continue;      // out of data: the MCU is left as it is
    out[0] = m;
    int mx = int(m % mcus_x), my = int(m / mcus_x);
    for (int c = 0; c < ncomp; c++) {
      int h = desc[c * 4], v = desc[c * 4 + 1], stride = desc[c * 4 + 2];
      for (int by = 0; by < v; by++) {
        for (int bx = 0; bx < h; bx++) {
          int16_t* blk = coefs[c] + (int64_t(my * v + by) * stride + (mx * h + bx)) * 64;
          if (!progressive) {
            block_sequential(br, dct[c], act[c], &last_dc[c], blk);
          } else if (ss == 0) {
            if (ah == 0) block_dc_first(br, dct[c], &last_dc[c], al, blk);
            else block_dc_refine(br, al, blk);
          } else if (ah == 0) {
            block_ac_first(br, act[c], sc, blk);
          } else {
            block_ac_refine(br, act[c], sc, blk);
          }
        }
      }
    }
  }
  out[1] = br.p - data;
  return 0;
}

// Decode one arithmetic-coded scan (jdarith.c), into the same coefficient
// arrays as dg_jpeg_scan and with the same data, coefs, desc and MCU grid.
// tables[c*2 ..] = the scan component's DC and AC table numbers (0..15);
// cond: the DAC conditioning, L[16], U[16] then Kx[16]. The statistics and
// the coder restart at every restart marker; after a bad arithmetic code
// the rest of the interval decodes nothing. Writes to *stop the bytes read.
int dg_jpeg_arith_scan(const uint8_t* data, int64_t len, int ncomp, int16_t** coefs,
                       const int32_t* desc, const int32_t* tables, const uint8_t* cond,
                       int mcus_x, int mcus_y, int ss, int se, int ah, int al, int progressive,
                       int restart_interval, int64_t* stop) {
  ArithScan sc(data, len, ss, se, ah, al, cond);
  auto reset_stats = [&]() {
    for (int c = 0; c < ncomp; c++) {
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(sc.dc_stats[tables[c * 2]], 0, 64);
        sc.last_dc[c] = 0;
        sc.dc_context[c] = 0;
      }
      if (!progressive || ss) std::memset(sc.ac_stats[tables[c * 2 + 1]], 0, 256);
    }
  };
  reset_stats();
  int64_t n_mcus = int64_t(mcus_x) * mcus_y;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcus; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      sc.ar.read_restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      reset_stats();
      sc.ar.reset();
    }
    if (sc.ar.ct == -1) continue;             // after a bad code: nothing decoded
    int mx = int(m % mcus_x), my = int(m / mcus_x);
    for (int c = 0; c < ncomp && sc.ar.ct != -1; c++) {
      int h = desc[c * 4], v = desc[c * 4 + 1], stride = desc[c * 4 + 2];
      for (int by = 0; by < v && sc.ar.ct != -1; by++) {
        for (int bx = 0; bx < h && sc.ar.ct != -1; bx++) {
          int16_t* blk = coefs[c] + (int64_t(my * v + by) * stride + (mx * h + bx)) * 64;
          if (!progressive) {                  // decode_mcu
            if (!sc.dc(c, tables[c * 2])) break;
            blk[0] = int16_t(sc.last_dc[c]);
            sc.ac(tables[c * 2 + 1], 1, 63, 0, blk);
          } else if (ss == 0 && ah == 0) {     // decode_mcu_DC_first
            if (!sc.dc(c, tables[c * 2])) break;
            blk[0] = int16_t(unsigned(sc.last_dc[c]) << al);
          } else if (ss == 0) {                // decode_mcu_DC_refine
            if (sc.ar.decode(&sc.fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
          } else if (ah == 0) {                // decode_mcu_AC_first
            sc.ac(tables[c * 2 + 1], ss, se, al, blk);
          } else {                             // decode_mcu_AC_refine
            sc.ac_refine(tables[c * 2 + 1], blk);
          }
        }
      }
    }
  }
  *stop = sc.ar.p - data;
  return 0;
}

// Decode one lossless scan (libjpeg-turbo 3's jdlhuff.c, jddiffct.c and
// jdlossls.c) into 8-bit sample planes. Per scan component c: planes[c]
// its uint8 [height, width] plane, desc[c*4 ..] = (h, v, width, height) in
// samples, dc[c*272 ..] its Huffman table (difference categories 0..16).
// mcus_x, mcus_y: the scan's MCU grid (one sample per MCU in a scan of one
// component); imcu_rows: the frame's iMCU rows. psv: the predictor (1..7),
// pt: the point transform, precision: the sample precision. Writes to
// *stop the bytes read. Returns 0, or 1 for a missing or malformed table.
int dg_jpeg_lossless_scan(const uint8_t* data, int64_t len, int ncomp, uint8_t** planes,
                          const int32_t* desc, const uint8_t* dc, int mcus_x, int mcus_y,
                          int imcu_rows, int psv, int pt, int precision,
                          int restart_interval, int64_t* stop) {
  std::vector<Huff> tbl(ncomp);
  for (int c = 0; c < ncomp; c++)
    if (!make_huff(dc + c * 272, 16, &tbl[c]) || !tbl[c].present) return 1;
  const bool interleaved = ncomp > 1;
  // Per component: the rows of differences one iMCU row holds, and its
  // undifferenced rows (the last of them the next row's Rb and Rc).
  std::vector<int> hs(ncomp), vs(ncomp), width(ncomp), height(ncomp), cols(ncomp);
  std::vector<std::vector<int32_t>> diff(ncomp), undiff(ncomp);
  std::vector<bool> first_row(ncomp, true);       // the undifferencer each starts with
  for (int c = 0; c < ncomp; c++) {
    hs[c] = interleaved ? desc[c * 4] : 1;
    vs[c] = desc[c * 4 + 1];
    width[c] = desc[c * 4 + 2];
    height[c] = desc[c * 4 + 3];
    cols[c] = mcus_x * hs[c];
    diff[c].assign(size_t(vs[c]) * cols[c], 0);
    undiff[c].assign(size_t(vs[c]) * width[c], 0);
  }
  Bits br(data, len);
  const int restart_rows = restart_interval / mcus_x;
  int rows_to_go = restart_rows, next_rst = 0, mcu_row = 0;
  const int initial = 1 << (precision - pt - 1);
  for (int imcu = 0; imcu < imcu_rows && mcu_row < mcus_y; imcu++) {
    const bool last = imcu == imcu_rows - 1;
    // The MCU rows of this iMCU row: one interleaved, else the component's v
    // (what is left of its rows in the last).
    int last_rows = height[0] % vs[0] ? height[0] % vs[0] : vs[0];
    int n_mcu_rows = interleaved ? 1 : (last ? last_rows : vs[0]);
    for (int yoff = 0; yoff < n_mcu_rows; yoff++, mcu_row++) {
      if (restart_interval && rows_to_go == 0) {  // jddiffct.c process_restart
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        std::fill(first_row.begin(), first_row.end(), true);
        rows_to_go = restart_rows;
      }
      if (br.insufficient) {                      // out of data: zero differences,
        for (int c = 0; c < ncomp; c++) {         // the undifferencers restarted
          int r0 = interleaved ? 0 : yoff, nr = interleaved ? vs[c] : 1;
          std::fill(diff[c].begin() + size_t(r0) * cols[c],
                    diff[c].begin() + size_t(r0 + nr) * cols[c], 0);
        }
        std::fill(first_row.begin(), first_row.end(), true);
      } else {
        for (int mx = 0; mx < mcus_x; mx++) {
          for (int c = 0; c < ncomp; c++) {
            for (int by = 0; by < (interleaved ? vs[c] : 1); by++) {
              int32_t* row = diff[c].data() + size_t(interleaved ? by : yoff) * cols[c];
              for (int bx = 0; bx < hs[c]; bx++) {
                int s = br.decode(tbl[c]);
                if (s == 16) {
                  s = 32768;
                } else if (s) {
                  s = extend(br.get(s), s);
                }
                row[mx * hs[c] + bx] = s;
              }
            }
          }
        }
      }
      if (restart_interval) rows_to_go--;
    }
    // Undifference and scale the iMCU row's rows (jdlossls.c).
    for (int c = 0; c < ncomp; c++) {
      int v = vs[c];
      int n_rows = last ? (height[c] % v ? height[c] % v : v) : v;
      for (int row = 0; row < n_rows; row++) {
        const int32_t* d = diff[c].data() + size_t(row) * cols[c];
        const int32_t* prev = undiff[c].data() + size_t(row ? row - 1 : v - 1) * width[c];
        int32_t* u = undiff[c].data() + size_t(row) * width[c];
        int w = width[c];
        if (first_row[c]) {                       // jpeg_undifference_first_row
          int ra = (d[0] + initial) & 0xFFFF;
          u[0] = ra;
          for (int x = 1; x < w; x++) u[x] = ra = (d[x] + ra) & 0xFFFF;
          first_row[c] = false;
        } else {
          // Rb and Rc are read before each sample is written: with v = 1
          // the row above is this row's own storage.
          int rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
          u[0] = ra;
          for (int x = 1; x < w; x++) {
            rc = rb;
            rb = prev[x];
            int64_t pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = int64_t(ra) + rb - rc; break;
              case 5: pred = ra + ((int64_t(rb) - rc) >> 1); break;
              case 6: pred = rb + ((int64_t(ra) - rc) >> 1); break;
              default: pred = (int64_t(ra) + rb) >> 1; break;
            }
            u[x] = ra = int((d[x] + pred) & 0xFFFF);
          }
        }
        uint8_t* out = planes[c] + size_t(imcu * v + row) * width[c];
        for (int x = 0; x < w; x++) out[x] = uint8_t(unsigned(u[x]) << pt);
      }
    }
  }
  *stop = br.p - data;
  return 0;
}

// A lossless image's full-size pixels into out [height, width, 1 or 3]:
// per component c its plane (planes[c], desc[c*2 ..] = its h and v),
// upsampled by replication as libjpeg-turbo does without DCT scaling, and
// converted as dg_jpeg_finish converts (transform 0, 2 or 3).
int dg_jpeg_lossless_finish(int ncomp, uint8_t** planes, const int32_t* desc, int width,
                            int height, int max_h, int max_v, int transform, uint8_t* out) {
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int c = 0; c < ncomp; c++) {
    int h = desc[c * 2], v = desc[c * 2 + 1];
    if (max_h % h || max_v % v) return 1;             // fractional sampling
    int dw = int((int64_t(width) * h + max_h - 1) / max_h);
    int dh = int((int64_t(height) * v + max_v - 1) / max_v);
    full[c].resize(size_t(width) * height);
    upsample(planes[c], dw, dh, max_h / h, max_v / v, full[c].data(), width, height, false);
  }
  convert(full, size_t(width) * height, transform, out);
  return 0;
}

// Dequantise, inverse-transform, upsample and convert every component into
// out [height, width, 1 or 3]. Per component c: coefs[c] int16 [rows,
// stride, 64], desc[c*6 ..] = (h, v, stride, width_in_blocks,
// height_in_blocks, has_table), q[c*64 ..] its quantisation table in
// natural order. transform: 0 grey, 1 YCbCr->RGB, 2 RGB as stored,
// 3 CMYK, 4 YCCK (both then OpenCV's CMYK->BGR, written as RGB).
// smooth: null, or a progressive file's interblock smoothing:
// (last_good_row, total_imcu_rows), then per component its ten latched
// coef_bits and the ten of the scan before (smooth_component).
int dg_jpeg_finish(int ncomp, int16_t** coefs, const int32_t* desc, const uint16_t* q,
                   int width, int height, int max_h, int max_v, int transform,
                   const int32_t* smooth, uint8_t* out) {
  std::vector<std::vector<uint8_t>> planes(ncomp);
  for (int c = 0; c < ncomp; c++) {
    const int32_t* d = desc + c * 6;
    int h = d[0], v = d[1], stride = d[2], bw = d[3], bh = d[4];
    if (max_h % h || max_v % v) return 1;             // fractional sampling
    int dw = int((int64_t(width) * h + max_h - 1) / max_h);
    int dh = int((int64_t(height) * v + max_v - 1) / max_v);
    int16_t qt[64];
    for (int i = 0; i < 64; i++) qt[i] = d[5] ? int16_t(q[c * 64 + i]) : 0;
    const int16_t* src = coefs[c];
    std::vector<int16_t> smoothed;
    if (smooth) {
      smoothed.resize(size_t(bh) * stride * 64);
      const int32_t* bits = smooth + 2 + c * 20;
      smooth_component(coefs[c], stride, bw, bh, v, smooth[1], smooth[0], bits, bits + 10,
                       q + c * 64, smoothed.data());
      src = smoothed.data();
    }
    std::vector<uint8_t> samples(size_t(bw) * 8 * bh * 8);
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++)
        idct_islow(src + (int64_t(by) * stride + bx) * 64, qt,
                   samples.data() + size_t(by) * 8 * bw * 8 + bx * 8, bw * 8);
    std::vector<uint8_t> crop(size_t(dw) * dh);
    for (int y = 0; y < dh; y++)
      std::memcpy(crop.data() + size_t(y) * dw, samples.data() + size_t(y) * bw * 8, dw);
    planes[c].resize(size_t(width) * height);
    upsample(crop.data(), dw, dh, max_h / h, max_v / v, planes[c].data(), width, height, true);
  }
  convert(planes, size_t(width) * height, transform, out);
  return 0;
}

// Max-flow/min-cut of a graph with terminal weights, as OpenCV's GCGraph
// computes it (Boykov-Kolmogorov search trees; edges added in the order
// given, each with its capacity and its reverse capacity). source_w[i] and
// sink_w[i] are vertex i's capacities from the source and to the sink.
// Writes in_source[i] = 1 for the vertices GCGraph places in the source
// segment (tree 0, which includes the vertices no tree reached) and the
// flow's value to *flow. Returns 0, 1 for a bad edge, 2 for a path of no
// positive capacity (OpenCV's assertion).
int dg_maxflow(int n_vtx, int64_t n_edges, const int32_t* src, const int32_t* dst,
               const double* cap, const double* rev_cap, const double* source_w,
               const double* sink_w, uint8_t* in_source, double* flow_out) {
  std::vector<Vtx> vtcs(n_vtx);
  std::vector<Edge> edges(2 + 2 * size_t(n_edges));
  double flow = 0;
  for (int i = 0; i < n_vtx; i++) {
    Vtx& v = vtcs[i];
    std::memset(&v, 0, sizeof(Vtx));
    double s = source_w[i], t = sink_w[i];
    flow += (s < t) ? s : t;
    v.weight = s - t;
  }
  for (int64_t e = 0; e < n_edges; e++) {
    int i = src[e], j = dst[e];
    if (i < 0 || j < 0 || i >= n_vtx || j >= n_vtx || i == j) return 1;
    int k = int(2 + 2 * e);
    edges[k] = {j, vtcs[i].first, cap[e]};
    vtcs[i].first = k;
    edges[k + 1] = {i, vtcs[j].first, rev_cap[e]};
    vtcs[j].first = k + 1;
  }

  const int TERMINAL = -1, ORPHAN = -2;
  Vtx stub, *nil = &stub, *first = nil, *last = nil;
  std::memset(&stub, 0, sizeof(Vtx));
  int curr_ts = 0;
  stub.next = nil;
  Vtx* V = vtcs.data();
  Edge* E = edges.data();
  std::vector<Vtx*> orphans;

  for (int i = 0; i < n_vtx; i++) {
    Vtx* v = V + i;
    v->ts = 0;
    if (v->weight != 0) {
      last = last->next = v;
      v->dist = 1;
      v->parent = TERMINAL;
      v->t = v->weight < 0;
    } else {
      v->parent = 0;
    }
  }
  first = first->next;
  last->next = nil;
  nil->next = 0;

  for (;;) {
    Vtx *v, *u;
    int e0 = -1, ei = 0, ej = 0;
    double min_weight, weight;
    uint8_t vt;

    // grow the source and sink trees, find an edge joining them
    while (first != nil) {
      v = first;
      if (v->parent) {
        vt = v->t;
        for (ei = v->first; ei != 0; ei = E[ei].next) {
          if (E[ei ^ vt].weight == 0) continue;
          u = V + E[ei].dst;
          if (!u->parent) {
            u->t = vt;
            u->parent = ei ^ 1;
            u->ts = v->ts;
            u->dist = v->dist + 1;
            if (!u->next) {
              u->next = nil;
              last = last->next = u;
            }
            continue;
          }
          if (u->t != vt) {
            e0 = ei ^ vt;
            break;
          }
          if (u->dist > v->dist + 1 && u->ts <= v->ts) {
            u->parent = ei ^ 1;
            u->ts = v->ts;
            u->dist = v->dist + 1;
          }
        }
        if (e0 > 0) break;
      }
      first = first->next;
      v->next = 0;
    }
    if (e0 <= 0) break;

    // the bottleneck of the path
    min_weight = E[e0].weight;
    if (!(min_weight > 0)) return 2;
    for (int k = 1; k >= 0; k--) {
      for (v = V + E[e0 ^ k].dst;; v = V + E[ei].dst) {
        if ((ei = v->parent) < 0) break;
        weight = E[ei ^ k].weight;
        min_weight = std::min(min_weight, weight);
        if (!(min_weight > 0)) return 2;
      }
      weight = std::fabs(v->weight);
      min_weight = std::min(min_weight, weight);
      if (!(min_weight > 0)) return 2;
    }

    // push it, collecting the orphans
    E[e0].weight -= min_weight;
    E[e0 ^ 1].weight += min_weight;
    flow += min_weight;
    for (int k = 1; k >= 0; k--) {
      for (v = V + E[e0 ^ k].dst;; v = V + E[ei].dst) {
        if ((ei = v->parent) < 0) break;
        E[ei ^ (k ^ 1)].weight += min_weight;
        if ((E[ei ^ k].weight -= min_weight) == 0) {
          orphans.push_back(v);
          v->parent = ORPHAN;
        }
      }
      v->weight = v->weight + min_weight * (1 - k * 2);
      if (v->weight == 0) {
        orphans.push_back(v);
        v->parent = ORPHAN;
      }
    }

    // adopt the orphans
    curr_ts++;
    while (!orphans.empty()) {
      Vtx* v2 = orphans.back();
      orphans.pop_back();
      int d, min_dist = INT_MAX;
      e0 = 0;
      vt = v2->t;
      for (ei = v2->first; ei != 0; ei = E[ei].next) {
        if (E[ei ^ (vt ^ 1)].weight == 0) continue;
        u = V + E[ei].dst;
        if (u->t != vt || u->parent == 0) continue;
        for (d = 0;;) {               // the distance to the tree's root
          if (u->ts == curr_ts) {
            d += u->dist;
            break;
          }
          ej = u->parent;
          d++;
          if (ej < 0) {
            if (ej == ORPHAN) {
              d = INT_MAX - 1;
            } else {
              u->ts = curr_ts;
              u->dist = 1;
            }
            break;
          }
          u = V + E[ej].dst;
        }
        if (++d < INT_MAX) {
          if (d < min_dist) {
            min_dist = d;
            e0 = ei;
          }
          for (u = V + E[ei].dst; u->ts != curr_ts; u = V + E[u->parent].dst) {
            u->ts = curr_ts;
            u->dist = --d;
          }
        }
      }
      if ((v2->parent = e0) > 0) {
        v2->ts = curr_ts;
        v2->dist = min_dist;
        continue;
      }
      v2->ts = 0;                     // no parent: free it
      for (ei = v2->first; ei != 0; ei = E[ei].next) {
        u = V + E[ei].dst;
        ej = u->parent;
        if (u->t != vt || !ej) continue;
        if (E[ei ^ (vt ^ 1)].weight && !u->next) {
          u->next = nil;
          last = last->next = u;
        }
        if (ej > 0 && V + E[ej].dst == v2) {
          orphans.push_back(u);
          u->parent = ORPHAN;
        }
      }
    }
  }
  for (int i = 0; i < n_vtx; i++) in_source[i] = vtcs[i].t == 0;
  *flow_out = flow;
  return 0;
}

}  // extern "C"
