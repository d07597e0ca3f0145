// K3: per-tile triangle z-test (nearest covering triangle per pixel), sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/mesh_raster_pallas.py, _ztest_kernel
// (called through ztest). Plain version: ztest_ref in
// dreamgaussian_tpu_torch/ops/mesh_raster_cuda.py, which also documents the
// feature rows and the tie rules.
//
// What bounds it on the H100: every (pixel, triangle) pair of a tile's list
// costs three edge functions (15 f32 operations) and the inside test on the
// CUDA cores, against 40 bytes of features per triangle that the tile's
// 1024 pixels share, so it is bound by f32 operations, not by bytes.
//
// Design: one block of 256 threads per screen tile, each thread owning
// PPT = tile*tile/256 pixels (4 at tile 32, 1 at tile 16). The block walks
// its tile's list chunk by chunk. Per chunk, the first `chunk` threads read
// one triangle's 10 feature rows each (coalesced: K is the minor dimension)
// and stage the vertices, the edge differences, the area and its inverse in
// shared memory; then every thread walks the chunk for its own pixels and
// keeps the chunk's winner in registers. A per-pixel minimum needs no
// reduction across threads. Padding slots (id 0) and zero-area triangles
// are skipped by the whole block at once. The arithmetic is written in the
// plain version's order and the file is built without fused multiply-add,
// so each operation rounds as the plain version's does.
//
// Ties: a pixel centre on an edge is inside (edge function >= 0 after the
// winding's sign). Within a chunk equal z goes to the larger id; across
// chunks only a strictly smaller z replaces the winner.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr float kBig = 3.4e38f;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
ztest_kernel(const float* __restrict__ feat, int64_t k_total,
             const int* __restrict__ chunk_starts,
             const int* __restrict__ n_chunks, int* __restrict__ out_id,
             float* __restrict__ out_z, int grid_x, int chunk, int tile) {
  __shared__ float s_x0[kMaxChunk], s_y0[kMaxChunk], s_x1[kMaxChunk];
  __shared__ float s_y1[kMaxChunk], s_x2[kMaxChunk], s_y2[kMaxChunk];
  __shared__ float s_a0[kMaxChunk], s_b0[kMaxChunk], s_a1[kMaxChunk];
  __shared__ float s_b1[kMaxChunk], s_a2[kMaxChunk], s_b2[kMaxChunk];
  __shared__ float s_z0[kMaxChunk], s_z1[kMaxChunk], s_z2[kMaxChunk];
  __shared__ float s_area[kMaxChunk], s_inv[kMaxChunk], s_id[kMaxChunk];

  const int t = blockIdx.x;
  const int pix = tile * tile;
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;

  float px[PPT], py[PPT], zbest[PPT], idbest[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = (float)(tx * tile + p % tile);
    py[i] = (float)(ty * tile + p / tile);
    zbest[i] = kBig;
    idbest[i] = 0.0f;
  }

  for (int k = 0; k < nc; ++k) {
    __syncthreads();  // the previous chunk is walked before it is overwritten
    if (threadIdx.x < chunk) {
      const int64_t col = (int64_t)(cs + k) * chunk + threadIdx.x;
      const float x0 = feat[0 * k_total + col], y0 = feat[1 * k_total + col];
      const float x1 = feat[2 * k_total + col], y1 = feat[3 * k_total + col];
      const float x2 = feat[4 * k_total + col], y2 = feat[5 * k_total + col];
      const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
      s_x0[threadIdx.x] = x0; s_y0[threadIdx.x] = y0;
      s_x1[threadIdx.x] = x1; s_y1[threadIdx.x] = y1;
      s_x2[threadIdx.x] = x2; s_y2[threadIdx.x] = y2;
      s_a0[threadIdx.x] = x2 - x1; s_b0[threadIdx.x] = y2 - y1;
      s_a1[threadIdx.x] = x0 - x2; s_b1[threadIdx.x] = y0 - y2;
      s_a2[threadIdx.x] = x1 - x0; s_b2[threadIdx.x] = y1 - y0;
      s_z0[threadIdx.x] = feat[6 * k_total + col];
      s_z1[threadIdx.x] = feat[7 * k_total + col];
      s_z2[threadIdx.x] = feat[8 * k_total + col];
      s_area[threadIdx.x] = area;
      s_inv[threadIdx.x] = 1.0f / (area != 0.0f ? area : 1.0f);
      s_id[threadIdx.x] = feat[9 * k_total + col];
    }
    __syncthreads();

    float zc[PPT], idc[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      zc[i] = kBig;
      idc[i] = 0.0f;
    }
    for (int g = 0; g < chunk; ++g) {
      const float id = s_id[g], area = s_area[g];
      if (!(id > 0.0f) || area == 0.0f) continue;  // the same for every thread
      const float x0 = s_x0[g], y0 = s_y0[g], x1 = s_x1[g], y1 = s_y1[g];
      const float x2 = s_x2[g], y2 = s_y2[g];
      const float a0 = s_a0[g], b0 = s_b0[g], a1 = s_a1[g], b1 = s_b1[g];
      const float a2 = s_a2[g], b2 = s_b2[g], inv = s_inv[g];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float e0 = a0 * (py[i] - y1) - b0 * (px[i] - x1);
        const float e1 = a1 * (py[i] - y2) - b1 * (px[i] - x2);
        const float e2 = a2 * (py[i] - y0) - b2 * (px[i] - x0);
        const float inside = area > 0.0f ? fminf(fminf(e0, e1), e2)
                                         : -fmaxf(fmaxf(e0, e1), e2);
        if (!(inside >= 0.0f)) continue;
        const float w0 = e0 * inv, w1 = e1 * inv, w2 = e2 * inv;
        const float z = w0 * s_z0[g] + w1 * s_z1[g] + w2 * s_z2[g];
        if (z < zc[i] || (z == zc[i] && id > idc[i])) {
          zc[i] = z;
          idc[i] = id;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (idc[i] > 0.0f && zc[i] < zbest[i]) {
        zbest[i] = zc[i];
        idbest[i] = idc[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int64_t o = (int64_t)t * pix + threadIdx.x + i * kThreads;
    out_id[o] = (int)idbest[i];
    out_z[o] = idbest[i] > 0.0f ? zbest[i] : 0.0f;
  }
}

}  // namespace

extern "C" int ztest(const float* feat, long long k_total,
                     const int* chunk_starts, const int* n_chunks, int* out_id,
                     float* out_z, int num_tiles, int grid_x, int chunk,
                     int tile, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 16) {
    ztest_kernel<1><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out_id, out_z, grid_x, chunk, tile);
  } else if (tile == 32) {
    ztest_kernel<4><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out_id, out_z, grid_x, chunk, tile);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
