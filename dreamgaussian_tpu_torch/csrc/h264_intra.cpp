// H.264 intra encoder (ITU-T H.264 / ISO/IEC 14496-10), the port's own:
// Constrained Baseline (profile_idc 66, constraint_set0/1 flags) with CAVLC.
//
// Every picture is one IDR slice of Intra 16x16 and I_PCM macroblocks:
//   - luma predicted 16x16 (vertical, horizontal, DC or plane, chosen by
//     SATD), chroma 8x8 (DC, horizontal, vertical or plane, by SATD over
//     Cb and Cr);
//   - the 4x4 integer transform, the luma DC's 4x4 Hadamard and the chroma
//     DC's 2x2, quantised at a fixed QP with mb_qp_delta 0;
//   - CAVLC for every block (coeff_token by nC, levels with their suffix
//     length escalation, total_zeros, run_before);
//   - a macroblock whose levels leave the range Baseline's level_prefix
//     (at most 15) can code, or whose bits come to at least those of its
//     samples, goes out as I_PCM, which keeps it under the 128 + RawMbBits
//     = 3200 bits of Annex A;
//   - the deblocking filter is off (disable_deblocking_filter_idc 1), so the
//     reconstruction made here by clause 8's decoding process is what a
//     decoder outputs, sample for sample.
//
// Two entry points:
//   dg_h264_headers -> the SPS and the PPS NAL units;
//   dg_h264_encode  -> each frame's IDR slice NAL unit, the reconstructed
//                      planes and the count of I_PCM macroblocks; frames
//                      are independent and spread over up to eight threads.
// NAL units carry their header byte and emulation prevention bytes, with
// no start code. Each returns 0, or 1 with a message.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Fail {
    std::string msg;
};

// ------------------------------------------------------------ bit writer

struct Bits {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nacc = 0;
    int64_t nbits = 0;

    void put(uint32_t v, int n) {  // the n low bits of v, first bit first
        nbits += n;
        while (n > 0) {
            int take = std::min(n, 24);
            acc = (acc << take) | ((v >> (n - take)) & ((1u << take) - 1));
            nacc += take;
            n -= take;
            while (nacc >= 8) {
                buf.push_back(uint8_t(acc >> (nacc - 8)));
                nacc -= 8;
            }
            acc &= (uint64_t(1) << nacc) - 1;
        }
    }
    void ue(uint32_t v) {  // ue(v): Exp-Golomb
        uint64_t x = uint64_t(v) + 1;
        int len = 0;
        while ((x >> len) > 1) ++len;
        put(0, len);
        put(uint32_t(x), len + 1);
    }
    void se(int v) { ue(v > 0 ? uint32_t(2 * v - 1) : uint32_t(-2 * v)); }
    void align_zero() {
        if (nacc) put(0, 8 - nacc);
    }
    void trailing() {  // rbsp_trailing_bits
        put(1, 1);
        align_zero();
    }
    void append(const Bits& o) {
        for (uint8_t b : o.buf) put(b, 8);
        if (o.nacc) put(uint32_t(o.acc), o.nacc);
    }
};

// NAL unit: header byte, then the RBSP with an emulation prevention byte
// after every two zero bytes that a byte of at most 3 follows (an RBSP ends
// in its stop bit, so never in a zero byte).
std::vector<uint8_t> nal_unit(int ref_idc, int type, const Bits& rbsp) {
    std::vector<uint8_t> out;
    out.reserve(rbsp.buf.size() + rbsp.buf.size() / 64 + 2);
    out.push_back(uint8_t((ref_idc << 5) | type));
    int zeros = 0;
    for (uint8_t b : rbsp.buf) {
        if (zeros >= 2 && b <= 3) {
            out.push_back(3);
            zeros = 0;
        }
        out.push_back(b);
        zeros = b == 0 ? zeros + 1 : 0;
    }
    return out;
}

// ------------------------------------------------------------ CAVLC tables
// Table 9-5: coeff_token (length, code) by [TotalCoeff * 4 + TrailingOnes],
// for 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8 and 8 <= nC.

const uint8_t kTokenLen[4][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8,
     13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15,
     14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6,
     11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13,
     12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4,
     7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8,
     10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6},
};
const uint8_t kTokenCode[4][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4,
     11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8,
     15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8,
     15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12,
     11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10,
     9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2},
    {3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
     40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
     60, 61, 62, 63},
};
// coeff_token for the chroma DC of 4:2:0 (nC = -1), TotalCoeff 0..4.
const uint8_t kChromaDcTokenLen[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0,
                                       6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kChromaDcTokenCode[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0,
                                        3, 3, 2, 5, 2, 3, 2, 0};

// Tables 9-7 and 9-8: total_zeros of 4x4 blocks by [TotalCoeff - 1][total_zeros].
const uint8_t kZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3},
    {3, 3, 1, 2},
    {2, 2, 1},
    {1, 1},
};
const uint8_t kZerosCode[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1},
    {0, 1, 1, 1},
    {0, 1, 1},
    {0, 1},
};
// Table 9-9 (a): total_zeros of the 4:2:0 chroma DC by [TotalCoeff - 1][total_zeros].
const uint8_t kChromaDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t kChromaDcZerosCode[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};

// Table 9-10: run_before by [min(zerosLeft, 7) - 1][run_before].
const uint8_t kRunLen[7][15] = {
    {1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3},
    {2, 3, 3, 3, 3, 3, 3}, {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
const uint8_t kRunCode[7][15] = {
    {1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0},
    {3, 0, 1, 3, 2, 5, 4}, {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

// Zig-zag scan of a 4x4 block: scan index -> raster index (row * 4 + column).
const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// luma4x4BlkIdx -> (x, y) of the 4x4 block inside its macroblock, in blocks.
const int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

// normAdjust4x4 (8.5.9) and the matching forward multipliers, by
// [QP % 6][class]: class 0 at (even, even), 1 at (odd, odd), 2 elsewhere.
const int kNormAdjust[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                               {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
const int kQuantMul[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
                             {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};
// Table 8-15: QPc by qPI for qPI >= 30.
const int kChromaQp[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                           36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

inline int pos_class(int raster) {
    int x = raster & 3, y = raster >> 2;
    if (!(x & 1) && !(y & 1)) return 0;
    return (x & 1) && (y & 1) ? 1 : 2;
}
inline int clip1(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int chroma_qp(int qp) { return qp < 30 ? qp : kChromaQp[qp - 30]; }

// ------------------------------------------------------------ transforms

// Forward core transform of a 4x4 residual (raster), W = Cf X Cf^T.
void forward4x4(const int* x, int* w) {
    int t[16];
    for (int i = 0; i < 4; ++i) {  // rows
        const int* r = x + 4 * i;
        int s03 = r[0] + r[3], d03 = r[0] - r[3], s12 = r[1] + r[2], d12 = r[1] - r[2];
        t[4 * i + 0] = s03 + s12;
        t[4 * i + 1] = 2 * d03 + d12;
        t[4 * i + 2] = s03 - s12;
        t[4 * i + 3] = d03 - 2 * d12;
    }
    for (int j = 0; j < 4; ++j) {  // columns
        int s03 = t[j] + t[12 + j], d03 = t[j] - t[12 + j];
        int s12 = t[4 + j] + t[8 + j], d12 = t[4 + j] - t[8 + j];
        w[j] = s03 + s12;
        w[4 + j] = 2 * d03 + d12;
        w[8 + j] = s03 - s12;
        w[12 + j] = d03 - 2 * d12;
    }
}

// 8.5.12.2: the inverse transform of scaled coefficients d, rows first,
// to the residual r = (h + 32) >> 6.
void inverse4x4(const int* d, int* r) {
    int f[16];
    for (int i = 0; i < 4; ++i) {
        const int* di = d + 4 * i;
        int e0 = di[0] + di[2], e1 = di[0] - di[2];
        int e2 = (di[1] >> 1) - di[3], e3 = di[1] + (di[3] >> 1);
        f[4 * i + 0] = e0 + e3;
        f[4 * i + 1] = e1 + e2;
        f[4 * i + 2] = e1 - e2;
        f[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {
        int g0 = f[j] + f[8 + j], g1 = f[j] - f[8 + j];
        int g2 = (f[4 + j] >> 1) - f[12 + j], g3 = f[4 + j] + (f[12 + j] >> 1);
        r[j] = (g0 + g3 + 32) >> 6;
        r[4 + j] = (g1 + g2 + 32) >> 6;
        r[8 + j] = (g1 - g2 + 32) >> 6;
        r[12 + j] = (g0 - g3 + 32) >> 6;
    }
}

// 4x4 Hadamard (raster in and out), the luma DC transform of both directions.
void hadamard4x4(const int* x, int* y) {
    int t[16];
    for (int i = 0; i < 4; ++i) {
        const int* r = x + 4 * i;
        int s01 = r[0] + r[1], d01 = r[0] - r[1], s23 = r[2] + r[3], d23 = r[2] - r[3];
        t[4 * i + 0] = s01 + s23;
        t[4 * i + 1] = s01 - s23;
        t[4 * i + 2] = d01 - d23;
        t[4 * i + 3] = d01 + d23;
    }
    for (int j = 0; j < 4; ++j) {
        int s01 = t[j] + t[4 + j], d01 = t[j] - t[4 + j];
        int s23 = t[8 + j] + t[12 + j], d23 = t[8 + j] - t[12 + j];
        y[j] = s01 + s23;
        y[4 + j] = s01 - s23;
        y[8 + j] = d01 - d23;
        y[12 + j] = d01 + d23;
    }
}

// Sum of absolute Hadamard-transformed differences of one 4x4 block.
int satd4x4(const uint8_t* src, int stride, const uint8_t* pred, int pstride) {
    int d[16], h[16];
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) d[4 * y + x] = int(src[y * stride + x]) - pred[y * pstride + x];
    hadamard4x4(d, h);
    int s = 0;
    for (int k = 0; k < 16; ++k) s += std::abs(h[k]);
    return s;
}

// Forward quantisation of one coefficient (rounding offset of intra, 1/3).
inline int quant(int w, int mul, int qbits) {
    int64_t a = int64_t(std::abs(w)) * mul + ((int64_t(1) << qbits) / 3);
    int l = int(a >> qbits);
    return w < 0 ? -l : l;
}

// ------------------------------------------------------------ CAVLC

// residual_block_cavlc of coef[0..n) (scan order) under nC (-1: chroma DC);
// returns false where a level needs a level_prefix above 15.
bool cavlc_block(Bits& b, const int* coef, int n, int nC, int& total) {
    int level[16], run[16];
    int tc = 0, last = -1;
    for (int k = n - 1; k >= 0; --k)
        if (coef[k]) {
            if (last < 0) last = k;
            level[tc++] = coef[k];  // highest frequency first
        }
    total = tc;
    int t1 = 0;
    while (t1 < tc && t1 < 3 && std::abs(level[t1]) == 1) ++t1;
    if (nC == -1) {
        b.put(kChromaDcTokenCode[tc * 4 + t1], kChromaDcTokenLen[tc * 4 + t1]);
    } else {
        int t = nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3;
        b.put(kTokenCode[t][tc * 4 + t1], kTokenLen[t][tc * 4 + t1]);
    }
    if (tc == 0) return true;
    for (int i = 0; i < t1; ++i) b.put(level[i] < 0 ? 1 : 0, 1);
    int sl = tc > 10 && t1 < 3 ? 1 : 0;
    for (int i = t1; i < tc; ++i) {
        int lv = level[i];
        int code = lv > 0 ? 2 * lv - 2 : -2 * lv - 1;
        if (i == t1 && t1 < 3) code -= 2;
        int prefix, suffix = 0, slen = 0;
        if (sl == 0 && code < 14) {
            prefix = code;
        } else if (sl == 0 && code < 30) {
            prefix = 14, suffix = code - 14, slen = 4;
        } else if (sl == 0) {
            prefix = 15, suffix = code - 30, slen = 12;
        } else if (code < (15 << sl)) {
            prefix = code >> sl, suffix = code & ((1 << sl) - 1), slen = sl;
        } else {
            prefix = 15, suffix = code - (15 << sl), slen = 12;
        }
        if (prefix == 15 && suffix >= 4096) return false;  // level_prefix 16+: not Baseline
        b.put(1, prefix + 1);
        if (slen) b.put(uint32_t(suffix), slen);
        if (sl == 0) sl = 1;
        if (std::abs(lv) > (3 << (sl - 1)) && sl < 6) ++sl;
    }
    // Runs: zeros before each coefficient, highest frequency first.
    int pos = last, zeros_total = last + 1 - tc;
    for (int i = 0; i < tc; ++i) {
        int k = pos - 1, r = 0;
        while (k >= 0 && coef[k] == 0) --k, ++r;
        run[i] = r;
        pos = k;
    }
    if (tc < n) {
        if (nC == -1)
            b.put(kChromaDcZerosCode[tc - 1][zeros_total], kChromaDcZerosLen[tc - 1][zeros_total]);
        else
            b.put(kZerosCode[tc - 1][zeros_total], kZerosLen[tc - 1][zeros_total]);
    }
    int left = zeros_total;
    for (int i = 0; i < tc - 1 && left > 0; ++i) {
        int t = std::min(left, 7) - 1;
        b.put(kRunCode[t][run[i]], kRunLen[t][run[i]]);
        left -= run[i];
    }
    return true;
}

// ------------------------------------------------------------ one picture

struct Picture {
    int w, h, mbw, mbh, qp;
    const uint8_t* src[3];
    uint8_t* rec[3];
    // TotalCoeff of every 4x4 block, per plane, in blocks of the picture
    // (luma w/4 x h/4; chroma w/8 x h/8), as nC's neighbours read them.
    std::vector<uint8_t> nz[3];

    int nz_stride(int p) const { return p ? w / 8 : w / 4; }

    // nC of the 4x4 block (bx, by) of plane p (9.2.1): the mean of the
    // left and upper neighbours' counts, where they lie in the picture.
    int nc(int p, int bx, int by) const {
        const std::vector<uint8_t>& z = nz[p];
        int s = nz_stride(p);
        bool a = bx > 0, b = by > 0;
        if (a && b) return (z[by * s + bx - 1] + z[(by - 1) * s + bx] + 1) >> 1;
        if (a) return z[by * s + bx - 1];
        if (b) return z[(by - 1) * s + bx];
        return 0;
    }
};

// The neighbours of an n x n block at (x0, y0) of a plane: the row above,
// the column to the left and the corner, from the reconstruction (zeros
// where the picture has none).
struct Edges {
    uint8_t top[16] = {}, left[16] = {};
    int corner = 0;
    bool has_top, has_left;
    Edges(const uint8_t* rec, int stride, int x0, int y0, int n) {
        has_top = y0 > 0, has_left = x0 > 0;
        if (has_top) std::memcpy(top, rec + (y0 - 1) * stride + x0, n);
        if (has_left)
            for (int k = 0; k < n; ++k) left[k] = rec[(y0 + k) * stride + x0 - 1];
        if (has_top && has_left) corner = rec[(y0 - 1) * stride + x0 - 1];
    }
};

// Intra 16x16 prediction (8.3.3) of mode 0 V, 1 H, 2 DC, 3 plane.
void predict16(int mode, const Edges& e, uint8_t* p) {
    const uint8_t *top = e.top, *left = e.left;
    if (mode == 0) {
        for (int y = 0; y < 16; ++y) std::memcpy(p + 16 * y, top, 16);
    } else if (mode == 1) {
        for (int y = 0; y < 16; ++y) std::memset(p + 16 * y, left[y], 16);
    } else if (mode == 2) {
        int s = 0, v = 128;
        for (int k = 0; k < 16; ++k) s += top[k] + left[k];
        if (e.has_top && e.has_left) v = (s + 16) >> 5;
        else if (e.has_top || e.has_left) v = (s + 8) >> 4;
        std::memset(p, v, 256);
    } else {
        int hh = 0, vv = 0;
        for (int k = 0; k < 8; ++k) {
            hh += (k + 1) * (top[8 + k] - (k == 7 ? e.corner : top[6 - k]));
            vv += (k + 1) * (left[8 + k] - (k == 7 ? e.corner : left[6 - k]));
        }
        int a = 16 * (left[15] + top[15]);
        int b = (5 * hh + 32) >> 6, c = (5 * vv + 32) >> 6;
        for (int y = 0; y < 16; ++y)
            for (int x = 0; x < 16; ++x)
                p[16 * y + x] = uint8_t(clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5));
    }
}

// Intra chroma prediction (8.3.4) of one 8x8 plane, mode 0 DC, 1 H, 2 V, 3 plane.
void predict_chroma(int mode, const Edges& e, uint8_t* p) {
    const uint8_t *top = e.top, *left = e.left;
    const bool has_top = e.has_top, has_left = e.has_left;
    if (mode == 0) {
        for (int by = 0; by < 2; ++by)
            for (int bx = 0; bx < 2; ++bx) {
                int st = 0, sl = 0, v = 128;
                for (int k = 0; k < 4; ++k) st += top[4 * bx + k], sl += left[4 * by + k];
                if (bx == by) {  // upper left and lower right: both sides
                    if (has_top && has_left) v = (st + sl + 4) >> 3;
                    else if (has_left) v = (sl + 2) >> 2;
                    else if (has_top) v = (st + 2) >> 2;
                } else if (bx == 1) {  // upper right: the row above first
                    if (has_top) v = (st + 2) >> 2;
                    else if (has_left) v = (sl + 2) >> 2;
                } else {  // lower left: the left column first
                    if (has_left) v = (sl + 2) >> 2;
                    else if (has_top) v = (st + 2) >> 2;
                }
                for (int y = 0; y < 4; ++y) std::memset(p + 8 * (4 * by + y) + 4 * bx, v, 4);
            }
    } else if (mode == 1) {
        for (int y = 0; y < 8; ++y) std::memset(p + 8 * y, left[y], 8);
    } else if (mode == 2) {
        for (int y = 0; y < 8; ++y) std::memcpy(p + 8 * y, top, 8);
    } else {
        int hh = 0, vv = 0;
        for (int k = 0; k < 4; ++k) {
            hh += (k + 1) * (top[4 + k] - (k == 3 ? e.corner : top[2 - k]));
            vv += (k + 1) * (left[4 + k] - (k == 3 ? e.corner : left[2 - k]));
        }
        int a = 16 * (left[7] + top[7]);
        int b = (34 * hh + 32) >> 6, c = (34 * vv + 32) >> 6;
        for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x)
                p[8 * y + x] = uint8_t(clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5));
    }
}

// Levels and reconstruction of the luma of one Intra 16x16 macroblock.
struct Luma {
    int mode;
    int dc[16];       // Intra16x16DCLevel, scan order
    int ac[16][15];   // Intra16x16ACLevel per luma4x4BlkIdx, scan order
    int cbp;          // 0 or 15
    uint8_t rec[256];
};

// Levels and reconstruction of both chroma planes of one macroblock.
struct Chroma {
    int mode;
    int dc[2][4];
    int ac[2][4][15];
    int cbp;  // 0, 1 (DC only) or 2
    uint8_t rec[2][64];
};

// The transform of a 4x4 block's residual, src minus pred.
void transform_residual(const uint8_t* src, int st, const uint8_t* pred, int pst, int* w) {
    int r[16];
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) r[4 * y + x] = int(src[y * st + x]) - pred[y * pst + x];
    forward4x4(r, w);
}

// The 15 AC levels of a block's coefficients w (raster), in scan order;
// returns whether any is nonzero.
bool quant_ac(const int* w, int q6, int qbits, int* lv) {
    bool any = false;
    for (int k = 1; k < 16; ++k) {
        lv[k - 1] = quant(w[kZigzag[k]], kQuantMul[q6][pos_class(kZigzag[k])], qbits);
        any |= lv[k - 1] != 0;
    }
    return any;
}

// 8.5.12: the block of AC levels lv (scan order) scaled, with the scaled DC
// dc, transformed back and added to pred, into out (stride pst as pred).
void reconstruct(const int* lv, int dc, int q6, int qd, const uint8_t* pred, int pst,
                 uint8_t* out) {
    int d[16], r[16];
    d[0] = dc;
    for (int k = 1; k < 16; ++k) {
        int ras = kZigzag[k], ls = 16 * kNormAdjust[q6][pos_class(ras)];
        d[ras] = qd >= 4 ? lv[k - 1] * ls * (1 << (qd - 4))
                         : (lv[k - 1] * ls + (1 << (3 - qd))) >> (4 - qd);
    }
    inverse4x4(d, r);
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
            out[y * pst + x] = uint8_t(clip1(pred[y * pst + x] + r[4 * y + x]));
}

void code_luma(const Picture& pic, int mbx, int mby, Luma& out) {
    const int st = pic.w;
    const uint8_t* src = pic.src[0] + (16 * mby) * st + 16 * mbx;
    Edges e(pic.rec[0], st, 16 * mbx, 16 * mby, 16);
    uint8_t pred[256], best_pred[256];
    int best = -1, best_cost = 0;
    for (int mode = 0; mode < 4; ++mode) {
        if ((mode == 0 && !e.has_top) || (mode == 1 && !e.has_left) ||
            (mode == 3 && !(e.has_top && e.has_left)))
            continue;
        predict16(mode, e, pred);
        int cost = 0;
        for (int b = 0; b < 16; ++b) cost += satd4x4(src + 4 * (b >> 2) * st + 4 * (b & 3), st,
                                                      pred + 4 * (b >> 2) * 16 + 4 * (b & 3), 16);
        if (best < 0 || cost < best_cost) {
            best = mode, best_cost = cost;
            std::memcpy(best_pred, pred, 256);
        }
    }
    out.mode = best;
    const int q6 = pic.qp % 6, qd = pic.qp / 6, qbits = 15 + qd;
    int dcs[16], hd[16], dcq[16];  // raster over the 4x4 blocks
    bool any_ac = false;
    for (int blk = 0; blk < 16; ++blk) {
        int at = 4 * kBlkY[blk] * 16 + 4 * kBlkX[blk], w[16];
        transform_residual(src + 4 * kBlkY[blk] * st + 4 * kBlkX[blk], st, best_pred + at, 16, w);
        dcs[4 * kBlkY[blk] + kBlkX[blk]] = w[0];
        any_ac |= quant_ac(w, q6, qbits, out.ac[blk]);
    }
    hadamard4x4(dcs, hd);
    for (int k = 0; k < 16; ++k) dcq[k] = quant(hd[k] / 2, kQuantMul[q6][0], qbits + 1);
    for (int k = 0; k < 16; ++k) out.dc[k] = dcq[kZigzag[k]];
    out.cbp = any_ac ? 15 : 0;

    // Decoding (8.5.10, 8.5.12): the DC, then each block.
    int f[16];
    hadamard4x4(dcq, f);
    const int ls0 = 16 * kNormAdjust[q6][0];
    for (int blk = 0; blk < 16; ++blk) {
        int k = 4 * kBlkY[blk] + kBlkX[blk], at = 4 * kBlkY[blk] * 16 + 4 * kBlkX[blk];
        int dc = qd >= 6 ? f[k] * ls0 * (1 << (qd - 6))
                         : (f[k] * ls0 + (1 << (5 - qd))) >> (6 - qd);
        reconstruct(out.ac[blk], dc, q6, qd, best_pred + at, 16, out.rec + at);
    }
}

void code_chroma(const Picture& pic, int mbx, int mby, Chroma& out) {
    const int st = pic.w / 2;
    const uint8_t* src[2] = {pic.src[1] + 8 * mby * st + 8 * mbx,
                             pic.src[2] + 8 * mby * st + 8 * mbx};
    Edges e[2] = {Edges(pic.rec[1], st, 8 * mbx, 8 * mby, 8),
                  Edges(pic.rec[2], st, 8 * mbx, 8 * mby, 8)};
    uint8_t pred[2][64], best_pred[2][64];
    int best = -1, best_cost = 0;
    for (int mode = 0; mode < 4; ++mode) {
        if ((mode == 1 && !e[0].has_left) || (mode == 2 && !e[0].has_top) ||
            (mode == 3 && !(e[0].has_top && e[0].has_left)))
            continue;
        int cost = 0;
        for (int c = 0; c < 2; ++c) {
            predict_chroma(mode, e[c], pred[c]);
            for (int b = 0; b < 4; ++b)
                cost += satd4x4(src[c] + 4 * (b >> 1) * st + 4 * (b & 1), st,
                                pred[c] + 4 * (b >> 1) * 8 + 4 * (b & 1), 8);
        }
        if (best < 0 || cost < best_cost) {
            best = mode, best_cost = cost;
            std::memcpy(best_pred, pred, sizeof(pred));
        }
    }
    out.mode = best;
    const int qpc = chroma_qp(pic.qp), q6 = qpc % 6, qd = qpc / 6, qbits = 15 + qd;
    bool any_dc = false, any_ac = false;
    for (int c = 0; c < 2; ++c) {
        int d[4], w[16];
        for (int blk = 0; blk < 4; ++blk) {
            int at = 4 * (blk >> 1) * 8 + 4 * (blk & 1);
            transform_residual(src[c] + 4 * (blk >> 1) * st + 4 * (blk & 1), st, best_pred[c] + at,
                               8, w);
            d[blk] = w[0];
            any_ac |= quant_ac(w, q6, qbits, out.ac[c][blk]);
        }
        int hd[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3],
                     d[0] + d[1] - d[2] - d[3], d[0] - d[1] - d[2] + d[3]};
        for (int k = 0; k < 4; ++k) {
            out.dc[c][k] = quant(hd[k], kQuantMul[q6][0], qbits + 1);
            any_dc |= out.dc[c][k] != 0;
        }
    }
    out.cbp = any_ac ? 2 : any_dc ? 1 : 0;
    if (out.cbp < 2)
        for (int c = 0; c < 2; ++c)
            for (int blk = 0; blk < 4; ++blk) std::fill(out.ac[c][blk], out.ac[c][blk] + 15, 0);

    // Decoding (8.5.11, 8.5.12).
    const int ls0 = 16 * kNormAdjust[q6][0];
    for (int c = 0; c < 2; ++c) {
        const int* q = out.dc[c];
        int f[4] = {q[0] + q[1] + q[2] + q[3], q[0] - q[1] + q[2] - q[3],
                    q[0] + q[1] - q[2] - q[3], q[0] - q[1] - q[2] + q[3]};
        for (int blk = 0; blk < 4; ++blk) {
            int at = 4 * (blk >> 1) * 8 + 4 * (blk & 1);
            reconstruct(out.ac[c][blk], (f[blk] * ls0 * (1 << qd)) >> 5, q6, qd, best_pred[c] + at,
                        8, out.rec[c] + at);
        }
    }
}

// macroblock_layer() of an Intra 16x16 macroblock into b, its counts into
// the picture's nC maps; false where a level cannot be coded.
bool write_i16(Picture& pic, int mbx, int mby, const Luma& l, const Chroma& c, Bits& b) {
    b.ue(uint32_t(1 + l.mode + 4 * c.cbp + (l.cbp ? 12 : 0)));  // mb_type
    b.ue(uint32_t(c.mode));                                     // intra_chroma_pred_mode
    b.se(0);                                                    // mb_qp_delta
    int total;
    const int bx0 = 4 * mbx, by0 = 4 * mby, ls = pic.nz_stride(0);
    if (!cavlc_block(b, l.dc, 16, pic.nc(0, bx0, by0), total)) return false;
    for (int blk = 0; blk < 16; ++blk) {
        int bx = bx0 + kBlkX[blk], by = by0 + kBlkY[blk];
        total = 0;
        if (l.cbp && !cavlc_block(b, l.ac[blk], 15, pic.nc(0, bx, by), total)) return false;
        pic.nz[0][by * ls + bx] = uint8_t(total);
    }
    if (c.cbp)
        for (int p = 0; p < 2; ++p)
            if (!cavlc_block(b, c.dc[p], 4, -1, total)) return false;
    const int cs = pic.nz_stride(1);
    for (int p = 0; p < 2; ++p)
        for (int blk = 0; blk < 4; ++blk) {
            int bx = 2 * mbx + (blk & 1), by = 2 * mby + (blk >> 1);
            total = 0;
            if (c.cbp == 2 && !cavlc_block(b, c.ac[p][blk], 15, pic.nc(1 + p, bx, by), total))
                return false;
            pic.nz[1 + p][by * cs + bx] = uint8_t(total);
        }
    return true;
}

// I_PCM: mb_type 25, alignment, then the samples as they are; every block
// counts 16 coefficients for its neighbours' nC.
void write_pcm(Picture& pic, int mbx, int mby, Bits& b) {
    b.ue(25);
    b.align_zero();
    const int st = pic.w, cst = pic.w / 2;
    for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) {
            uint8_t v = pic.src[0][(16 * mby + y) * st + 16 * mbx + x];
            b.put(v, 8);
            pic.rec[0][(16 * mby + y) * st + 16 * mbx + x] = v;
        }
    for (int p = 1; p < 3; ++p)
        for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x) {
                uint8_t v = pic.src[p][(8 * mby + y) * cst + 8 * mbx + x];
                b.put(v, 8);
                pic.rec[p][(8 * mby + y) * cst + 8 * mbx + x] = v;
            }
    for (int k = 0; k < 16; ++k)
        pic.nz[0][(4 * mby + k / 4) * pic.nz_stride(0) + 4 * mbx + k % 4] = 16;
    for (int p = 1; p < 3; ++p)
        for (int k = 0; k < 4; ++k)
            pic.nz[p][(2 * mby + k / 2) * pic.nz_stride(1) + 2 * mbx + k % 2] = 16;
}

// One picture as an IDR slice NAL unit; returns the count of I_PCM macroblocks.
int encode_picture(Picture& pic, int idr_pic_id, std::vector<uint8_t>& nal) {
    for (int p = 0; p < 3; ++p)
        pic.nz[p].assign(size_t(pic.nz_stride(p)) * (p ? pic.h / 8 : pic.h / 4), 0);
    Bits b;
    b.ue(0);            // first_mb_in_slice
    b.ue(7);            // slice_type: I, as every slice of the picture
    b.ue(0);            // pic_parameter_set_id
    b.put(0, 4);        // frame_num (log2_max_frame_num 4)
    b.ue(uint32_t(idr_pic_id));
    b.put(0, 1);        // no_output_of_prior_pics_flag
    b.put(0, 1);        // long_term_reference_flag
    b.se(0);            // slice_qp_delta (the PPS carries the QP)
    b.ue(1);            // disable_deblocking_filter_idc
    const int pcm_bits_floor = 9 + 8 * 384;  // ue(25) and the samples, before alignment
    int pcm = 0;
    Luma l;
    Chroma c;
    for (int mby = 0; mby < pic.mbh; ++mby)
        for (int mbx = 0; mbx < pic.mbw; ++mbx) {
            code_luma(pic, mbx, mby, l);
            code_chroma(pic, mbx, mby, c);
            Bits mb;
            if (write_i16(pic, mbx, mby, l, c, mb) && mb.nbits < pcm_bits_floor) {
                b.append(mb);
                const int st = pic.w, cst = pic.w / 2;
                for (int y = 0; y < 16; ++y)
                    std::memcpy(pic.rec[0] + (16 * mby + y) * st + 16 * mbx, l.rec + 16 * y, 16);
                for (int p = 0; p < 2; ++p)
                    for (int y = 0; y < 8; ++y)
                        std::memcpy(pic.rec[1 + p] + (8 * mby + y) * cst + 8 * mbx,
                                    c.rec[p] + 8 * y, 8);
            } else {
                write_pcm(pic, mbx, mby, b);
                ++pcm;
            }
        }
    b.trailing();
    nal = nal_unit(3, 5, b);
    return pcm;
}

// Runs fn(first, end) over [0, n) in contiguous shares, on up to eight
// threads.
template <typename Fn>
void parallel_for(int n, Fn fn) {
    int threads = int(std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()), 8u));
    threads = std::min(threads, n);
    if (threads <= 1) {
        if (n > 0) fn(0, n);
        return;
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
        pool.emplace_back(
            [&, t] { fn(int(int64_t(n) * t / threads), int(int64_t(n) * (t + 1) / threads)); });
    for (auto& th : pool) th.join();
}

void check_size(int w, int h, int qp) {
    if (w <= 0 || h <= 0 || w % 16 || h % 16)
        throw Fail{"width and height must be positive multiples of 16, got " +
                   std::to_string(w) + "x" + std::to_string(h)};
    if (qp < 0 || qp > 51) throw Fail{"QP must lie in [0, 51], got " + std::to_string(qp)};
}

int report(const Fail& f, char* msg, int32_t cap) {
    if (msg && cap > 0) {
        std::strncpy(msg, f.msg.c_str(), size_t(cap) - 1);
        msg[cap - 1] = 0;
    }
    return 1;
}

}  // namespace

extern "C" {

// The SPS (seq_parameter_set_id 0) and the PPS (0) of a stream of width x
// height pictures at level_idc and qp, one after the other in out;
// lens[0], lens[1] their sizes.
int dg_h264_headers(int32_t width, int32_t height, int32_t level_idc, int32_t qp, uint8_t* out,
                    int32_t cap, int32_t* lens, char* msg, int32_t msg_cap) {
    try {
        check_size(width, height, qp);
        Bits sps;
        sps.put(66, 8);      // profile_idc: Baseline
        sps.put(0xC0, 8);    // constraint_set0 and set1 (Constrained Baseline), reserved 0
        sps.put(uint32_t(level_idc), 8);
        sps.ue(0);           // seq_parameter_set_id
        sps.ue(0);           // log2_max_frame_num_minus4
        sps.ue(2);           // pic_order_cnt_type: output order is decoding order
        sps.ue(1);           // max_num_ref_frames
        sps.put(0, 1);       // gaps_in_frame_num_value_allowed_flag
        sps.ue(uint32_t(width / 16 - 1));
        sps.ue(uint32_t(height / 16 - 1));
        sps.put(1, 1);       // frame_mbs_only_flag
        sps.put(1, 1);       // direct_8x8_inference_flag
        sps.put(0, 1);       // frame_cropping_flag
        sps.put(0, 1);       // vui_parameters_present_flag
        sps.trailing();
        Bits pps;
        pps.ue(0);           // pic_parameter_set_id
        pps.ue(0);           // seq_parameter_set_id
        pps.put(0, 1);       // entropy_coding_mode_flag: CAVLC
        pps.put(0, 1);       // bottom_field_pic_order_in_frame_present_flag
        pps.ue(0);           // num_slice_groups_minus1
        pps.ue(0);           // num_ref_idx_l0_default_active_minus1
        pps.ue(0);           // num_ref_idx_l1_default_active_minus1
        pps.put(0, 1);       // weighted_pred_flag
        pps.put(0, 2);       // weighted_bipred_idc
        pps.se(qp - 26);     // pic_init_qp_minus26
        pps.se(0);           // pic_init_qs_minus26
        pps.se(0);           // chroma_qp_index_offset
        pps.put(1, 1);       // deblocking_filter_control_present_flag
        pps.put(0, 1);       // constrained_intra_pred_flag
        pps.put(0, 1);       // redundant_pic_cnt_present_flag
        pps.trailing();
        std::vector<uint8_t> a = nal_unit(3, 7, sps), b = nal_unit(3, 8, pps);
        if (int64_t(a.size() + b.size()) > cap) throw Fail{"header buffer too small"};
        std::memcpy(out, a.data(), a.size());
        std::memcpy(out + a.size(), b.data(), b.size());
        lens[0] = int32_t(a.size());
        lens[1] = int32_t(b.size());
        return 0;
    } catch (const Fail& f) {
        return report(f, msg, msg_cap);
    }
}

// frames pictures of yuv420p planes (y [frames][height][width], u and v
// [frames][height/2][width/2]) at qp: each frame's IDR slice NAL unit
// (idr_pic_id alternating 0, 1) one after the other in out, its size in
// sizes[f], its count of I_PCM macroblocks in pcm[f], and the
// reconstruction in ry, ru, rv (the layout of y, u, v).
int dg_h264_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t width,
                   int32_t height, int32_t frames, int32_t qp, uint8_t* ry, uint8_t* ru,
                   uint8_t* rv, uint8_t* out, int64_t cap, int64_t* sizes, int32_t* pcm,
                   char* msg, int32_t msg_cap) {
    try {
        check_size(width, height, qp);
        const int64_t ly = int64_t(width) * height, lc = ly / 4;
        std::vector<std::vector<uint8_t>> nals(size_t(std::max(frames, 0)));
        parallel_for(frames, [&](int first, int end) {
            for (int f = first; f < end; ++f) {
                Picture pic;
                pic.w = width, pic.h = height, pic.qp = qp;
                pic.mbw = width / 16, pic.mbh = height / 16;
                pic.src[0] = y + f * ly, pic.src[1] = u + f * lc, pic.src[2] = v + f * lc;
                pic.rec[0] = ry + f * ly, pic.rec[1] = ru + f * lc, pic.rec[2] = rv + f * lc;
                pcm[f] = encode_picture(pic, f & 1, nals[size_t(f)]);
            }
        });
        int64_t at = 0;
        for (int f = 0; f < frames; ++f) {
            const std::vector<uint8_t>& n = nals[size_t(f)];
            if (at + int64_t(n.size()) > cap) throw Fail{"output buffer too small"};
            std::memcpy(out + at, n.data(), n.size());
            sizes[f] = int64_t(n.size());
            at += int64_t(n.size());
        }
        return 0;
    } catch (const Fail& f) {
        return report(f, msg, msg_cap);
    }
}

}  // extern "C"
