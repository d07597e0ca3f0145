// Shared by the tile compositor's kernels (composite_fwd.cu, composite_bwd.cu):
// the pixel a thread owns, the staging of a chunk of a tile's list, and the
// exponent of a (gaussian, pixel) pair.
//
// A tile is split into quadrants of 16x16 pixels, one block each (4 blocks
// for tile 32, 1 for tile 16), so that a small frame still fills the card's
// 132 SMs. Every block of a tile walks the same depth-ordered list.
//
// COMPOSITE_SIFT=0 builds the kernels without the sift (see may_reach): a
// warp then walks every gaussian of a chunk. The sift may only drop
// gaussians that contribute nowhere in the warp's pixels, so both builds
// must give the same bits; the card's tests hold them to that.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef COMPOSITE_SIFT
#define COMPOSITE_SIFT 1
#endif

namespace composite {

constexpr int kQuad = 16;        // edge of the pixel square one block owns
constexpr int kMaxChunk = 128;   // most gaussians a staged chunk holds
constexpr int kRealRows = 10;    // feature rows that carry data (of 16)
constexpr int kOutCh = 8;
constexpr float kTermEps = 1e-4f;
constexpr float kLogAlphaSkip = -5.541263545158426f;  // log(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr unsigned kFullMask = 0xffffffffu;

// One chunk as it is copied: thread g owns column g of every row, so it can
// read what it copied after waiting on its own copies, with no barrier.
struct RawChunk {
  float row[kRealRows][kMaxChunk];
};

// One chunk as it is walked: coefficients relative to the tile's centre,
// packed so that a gaussian costs a few 16-byte broadcast reads.
struct StagedChunk {
  float4 a[kMaxChunk];   // q0, qx, qy, log_opacity
  float4 b[kMaxChunk];   // conic a, b, c, unused
  float4 c[kMaxChunk];   // r, g, b, depth
  float2 m[kMaxChunk];   // mean - tile centre
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Thread `threadIdx.x` (< chunk) starts the copy of its column of the chunk
// whose first slot is `first_col`.
__device__ __forceinline__ void start_copy(RawChunk& raw, const float* __restrict__ feat,
                                            int64_t k_total, int64_t first_col) {
  const float* src = feat + first_col + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRealRows; ++r) cp_async4(&raw.row[r][threadIdx.x], src + r * k_total);
  cp_async_commit();
}

// Thread `threadIdx.x` (< chunk) turns its copied column into the staged
// form. The products are not contracted into multiply-adds: the skip tests
// of a pair must decide as the plain version's do, bit for bit.
__device__ __forceinline__ void derive_chunk(StagedChunk& st, const RawChunk& raw, float cx,
                                             float cy) {
  const int g = threadIdx.x;
  const float mx = __fsub_rn(raw.row[0][g], cx);
  const float my = __fsub_rn(raw.row[1][g], cy);
  const float ca = raw.row[2][g], cb = raw.row[3][g], cc = raw.row[4][g];
  const float lop = raw.row[5][g];
  const float qx = __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
  const float qy = __fadd_rn(__fmul_rn(cc, my), __fmul_rn(cb, mx));
  const float q0 = __fadd_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(mx, qx), __fmul_rn(my, qy))), lop);
  st.a[g] = make_float4(q0, qx, qy, lop);
  st.b[g] = make_float4(ca, cb, cc, 0.0f);
  st.c[g] = make_float4(raw.row[6][g], raw.row[7][g], raw.row[8][g], raw.row[9][g]);
  st.m[g] = make_float2(mx, my);
}

// The loader threads' part of one loop iteration: make chunk `k` (of the
// tile's list starting at chunk `cs`) ready in st[k & 1], and start the copy
// of chunk `k_next` (none if negative). Chunk `k`'s own copy was started an
// iteration earlier (the first one before the loop), so it lands while the
// chunk before it is walked.
__device__ __forceinline__ void stage_chunk(StagedChunk* st, RawChunk* raw,
                                            const float* __restrict__ feat, int64_t k_total,
                                            int cs, int k, int k_next, int chunk, float cx,
                                            float cy) {
  const int b = k & 1;
  cp_async_wait_all();
  if (k_next >= 0) start_copy(raw[b ^ 1], feat, k_total, (int64_t)(cs + k_next) * chunk);
  derive_chunk(st[b], raw[b], cx, cy);
}

// The pixel of lane `lane` of warp `warp`, `i`-th of the thread's `ppt`
// pixels, inside the block's 16x16 quadrant: a warp owns a compact patch 8
// pixels wide, so that its lanes skip and stop together.
__device__ __forceinline__ void quadrant_pixel(int warp, int lane, int i, int ppt, int& lx,
                                               int& ly) {
  lx = (warp & 1) * 8 + (lane & 7);
  ly = (warp >> 1) * 4 * ppt + i * 4 + (lane >> 3);
}

// Per-pixel constants of the exponent.
struct PixelTerms {
  float x, y, hxx, nxy, hyy;   // x, y, -0.5 x^2, -(x y), -0.5 y^2
  __device__ __forceinline__ void set(float px, float py) {
    x = px;
    y = py;
    hxx = __fmul_rn(__fmul_rn(-0.5f, px), px);
    nxy = -__fmul_rn(px, py);
    hyy = __fmul_rn(__fmul_rn(-0.5f, py), py);
  }
};

// powero = power + log(opacity), in the plain version's association and
// without contraction, so that both skip tests fall as they do there.
__device__ __forceinline__ float powero_of(const float4& a, const float4& b,
                                           const PixelTerms& p) {
  const float t0 = __fadd_rn(a.x, __fmul_rn(a.y, p.x));
  const float t1 = __fadd_rn(__fmul_rn(a.z, p.y), __fmul_rn(b.x, p.hxx));
  const float t2 = __fadd_rn(__fmul_rn(b.y, p.nxy), __fmul_rn(b.z, p.hyy));
  return __fadd_rn(__fadd_rn(t0, t1), t2);
}

__device__ __forceinline__ bool pair_skipped(float powero, float log_op) {
  return powero > log_op || powero < kLogAlphaSkip;
}

// The box of pixel centres a warp owns, in tile-centre-relative coordinates.
struct PixelBox {
  float x0, x1, y0, y1;
  // From each lane's own pixels' extremes, over the warp.
  __device__ __forceinline__ void set(float lo_x, float hi_x, float lo_y, float hi_y) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo_x = fminf(lo_x, __shfl_xor_sync(kFullMask, lo_x, off));
      hi_x = fmaxf(hi_x, __shfl_xor_sync(kFullMask, hi_x, off));
      lo_y = fminf(lo_y, __shfl_xor_sync(kFullMask, lo_y, off));
      hi_y = fmaxf(hi_y, __shfl_xor_sync(kFullMask, hi_y, off));
    }
    x0 = lo_x, x1 = hi_x, y0 = lo_y, y1 = hi_y;
  }
};

// Can staged gaussian g pass both skip tests at some pixel of the box?
// Never false for a gaussian that can. One thread answers for one gaussian,
// so a warp sifts 32 gaussians for the price of one pair. A pair passes only
// if log(1/255) <= powero <= log_opacity, where powero = log_opacity - q / 2
// with q the conic's quadratic form in the pixel's offset from the mean. So
// an opacity below 1/255 never passes, and otherwise a positive semidefinite
// conic passes only where q <= 2 (log_opacity - log(1/255)): the least q over
// the box (0 if the mean lies in it, else the least over its four edges)
// decides. The margin covers the rounding of the per-pixel exponent, whose
// terms are as large as the conic times the squared distances in the tile.
// Other conics are never sifted out.
__device__ __forceinline__ bool may_reach(const StagedChunk& st, int g, const PixelBox& box) {
  const float4 a = st.a[g], b = st.b[g];
  const float2 m = st.m[g];
  const float ca = b.x, cb = b.y, cc = b.z, log_op = a.w;
  if (log_op < kLogAlphaSkip) return false;
  if (!(ca > 0.0f && cc > 0.0f && ca * cc - cb * cb >= 0.0f)) return true;
  const float lx = box.x0 - m.x, hx = box.x1 - m.x;
  const float ly = box.y0 - m.y, hy = box.y1 - m.y;
  if (lx <= 0.0f && hx >= 0.0f && ly <= 0.0f && hy >= 0.0f) return true;
  const float ry = -cb / cc, rx = -cb / ca;
  auto edge_x = [&](float ex) {
    const float dy = fminf(fmaxf(ry * ex, ly), hy);
    return (ca * ex + 2.0f * cb * dy) * ex + cc * dy * dy;
  };
  auto edge_y = [&](float ey) {
    const float dx = fminf(fmaxf(rx * ey, lx), hx);
    return (cc * ey + 2.0f * cb * dx) * ey + ca * dx * dx;
  };
  const float q_min = fminf(fminf(edge_x(lx), edge_x(hx)), fminf(edge_y(ly), edge_y(hy)));
  const float far_x = fabsf(m.x) + kQuad, far_y = fabsf(m.y) + kQuad;
  const float margin = 1e-3f + 2e-5f * (ca * far_x * far_x + cc * far_y * far_y +
                                        2.0f * fabsf(cb) * far_x * far_y);
  return q_min <= 2.0f * (log_op - kLogAlphaSkip) + margin;
}

}  // namespace composite
