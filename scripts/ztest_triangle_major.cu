// The triangle-major design of K3 (the per-tile triangle z-test), kept as
// the alternative that scripts/port_ztest_variants.py times against the
// shipped kernel (dreamgaussian_tpu_torch/csrc/ztest.cu). Not part of the
// port. Built like the shipped kernel, for sm_90a without fused
// multiply-add.
//
// One block of 128 threads per 16x16 quadrant of a tile; thread g owns slot
// g of every chunk of the tile's list. For its triangle it runs the shipped
// kernel's exact per-edge test against each 8x4 patch of the quadrant, and
// for each patch that passes it evaluates the patch's 32 pixel centres one
// after another, folding each covering pixel into a per-pixel 64-bit key in
// shared memory with atomicMin. The key orders the contract exactly: high
// 32 bits z (its bits mapped so that they order as unsigned, -0 taken as
// +0), then the chunk's place in the list ascending (8 bits), then the id
// descending (24 bits: 2^24 - id). Lists longer than 255 chunks run in
// passes; between passes every pixel's key gets chunk place 0, so that it
// keeps its precedence over the later chunks at equal z. No barrier per
// chunk. Unlike the shipped kernel it does not carry the NaN rule (a
// covering triangle with a NaN z voids the pixel's chunk).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQuad = 16;
constexpr int kMaxChunk = 128;
constexpr int kChunksPerPass = 255;
constexpr float kBig = 3.4e38f;
constexpr unsigned long long kNoKey = ~0ull;

struct PatchBox {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ bool edge_may_pass(float A, float B, float xa, float ya,
                                              const PatchBox& box, bool pos) {
  const float py = ((A >= 0.0f) == pos) ? box.y1 : box.y0;
  const float px = ((B >= 0.0f) == pos) ? box.x0 : box.x1;
  const float p1 = A * (py - ya);
  const float p2 = B * (px - xa);
  return pos ? p1 >= p2 : p1 <= p2;
}

__device__ __forceinline__ unsigned ordered_bits(float z) {
  const unsigned u = __float_as_uint(z == 0.0f ? 0.0f : z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
ztest_tri_major_kernel(const float* __restrict__ feat, int64_t k_total,
                       const int* __restrict__ chunk_starts, const int* __restrict__ n_chunks,
                       int* __restrict__ out_id, float* __restrict__ out_z, int grid_x,
                       int chunk) {
  __shared__ unsigned long long s_key[kQuad * kQuad];

  constexpr int tile = Q == 4 ? 2 * kQuad : kQuad;
  const int t = blockIdx.x / Q;
  const int q = blockIdx.x % Q;
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const int qx = tx * tile + (q & 1) * kQuad, qy = ty * tile + (q >> 1) * kQuad;

  for (int p = threadIdx.x; p < kQuad * kQuad; p += kThreads) s_key[p] = kNoKey;
  __syncthreads();

  for (int pass = 0; pass < nc; pass += kChunksPerPass) {
    const int end = min(nc, pass + kChunksPerPass);
    for (int k = pass; k < end && threadIdx.x < chunk; ++k) {
      const int64_t col = (int64_t)(cs + k) * chunk + threadIdx.x;
      const float x0 = feat[0 * k_total + col], y0 = feat[1 * k_total + col];
      const float x1 = feat[2 * k_total + col], y1 = feat[3 * k_total + col];
      const float x2 = feat[4 * k_total + col], y2 = feat[5 * k_total + col];
      const float id = feat[9 * k_total + col];
      const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
      if (!(id > 0.0f) || area == 0.0f) continue;
      const float a0 = x2 - x1, b0 = y2 - y1, a1 = x0 - x2, b1 = y0 - y2;
      const float a2 = x1 - x0, b2 = y1 - y0;
      const float z0 = feat[6 * k_total + col], z1 = feat[7 * k_total + col];
      const float z2 = feat[8 * k_total + col];
      const float inv = 1.0f / area;
      const bool pos = area > 0.0f;
      const unsigned long long low =
          ((unsigned long long)(k - pass + 1) << 24) | (unsigned)(16777216.0f - id);
      for (int patch = 0; patch < 8; ++patch) {
        const int lx0 = (patch & 1) * 8, ly0 = (patch >> 1) * 4;
        PatchBox box;
        box.x0 = (float)(qx + lx0);
        box.x1 = box.x0 + 7.0f;
        box.y0 = (float)(qy + ly0);
        box.y1 = box.y0 + 3.0f;
        if (!(edge_may_pass(a0, b0, x1, y1, box, pos) && edge_may_pass(a1, b1, x2, y2, box, pos) &&
              edge_may_pass(a2, b2, x0, y0, box, pos)))
          continue;
        for (int i = 0; i < 32; ++i) {
          const int lx = lx0 + (i & 7), ly = ly0 + (i >> 3);
          const float px = (float)(qx + lx), py = (float)(qy + ly);
          const float e0 = a0 * (py - y1) - b0 * (px - x1);
          const float e1 = a1 * (py - y2) - b1 * (px - x2);
          const float e2 = a2 * (py - y0) - b2 * (px - x0);
          const bool inside = pos ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                                  : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
          if (!inside) continue;
          const float z = (e0 * inv) * z0 + (e1 * inv) * z1 + (e2 * inv) * z2;
          if (!(z < kBig)) continue;
          atomicMin(&s_key[ly * kQuad + lx], ((unsigned long long)ordered_bits(z) << 32) | low);
        }
      }
    }
    __syncthreads();
    // Earlier passes' winners keep precedence at equal z: chunk place 0.
    for (int p = threadIdx.x; p < kQuad * kQuad; p += kThreads)
      if (s_key[p] != kNoKey) s_key[p] &= ~(0xffull << 24);
    __syncthreads();
  }

  for (int p = threadIdx.x; p < kQuad * kQuad; p += kThreads) {
    const unsigned long long key = s_key[p];
    const int lx = (q & 1) * kQuad + (p % kQuad), ly = (q >> 1) * kQuad + p / kQuad;
    const int64_t o = (int64_t)t * tile * tile + ly * tile + lx;
    const bool hit = key != kNoKey;
    out_id[o] = hit ? 16777216 - (int)(key & 0xffffffu) : 0;
    out_z[o] = hit ? from_ordered((unsigned)(key >> 32)) : 0.0f;
  }
}

}  // namespace

extern "C" int ztest_tri_major(const float* feat, long long k_total, const int* chunk_starts,
                               const int* n_chunks, int* out_id, float* out_z, int num_tiles,
                               int grid_x, int chunk, int tile, void* stream,
                               int* blocks_launched) {
  if (chunk <= 0 || chunk > kMaxChunk || num_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (tile == kQuad) {
    grid = dim3((unsigned)num_tiles);
    ztest_tri_major_kernel<1><<<grid, kThreads, 0, s>>>(feat, k_total, chunk_starts, n_chunks,
                                                         out_id, out_z, grid_x, chunk);
  } else if (tile == 2 * kQuad) {
    grid = dim3((unsigned)num_tiles * 4u);
    ztest_tri_major_kernel<4><<<grid, kThreads, 0, s>>>(feat, k_total, chunk_starts, n_chunks,
                                                         out_id, out_z, grid_x, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *blocks_launched = (int)grid.x;
  return (int)err;
}
