// K1: tile-compositing forward for 3D Gaussian splatting, sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/rasterize_pallas.py, _fwd_kernel (called
// through composite_forward). Plain version: composite_forward_ref in
// dreamgaussian_tpu_torch/ops/rasterize_cuda.py, which also documents the
// row and channel layouts.
//
// What bounds it on the H100: per (gaussian, pixel) pair it does about 20
// f32 operations and one expf on the CUDA cores, against 40 bytes of
// features per gaussian that a whole tile shares. The work is the sum over
// pixels of the pairs walked before the pixel stops, so it is bound by
// operations (f32, no tensor cores), and by how many pixels of a tile are
// still walking: a tile finishes when its slowest pixel does.
//
// Design: one block of 256 threads per screen tile, each thread owning
// PPT = tile*tile/256 pixels (4 at tile 32, 1 at tile 16). The block walks
// its tile's depth-ordered list chunk by chunk. Per chunk, the first
// `chunk` threads read one gaussian's 10 feature rows each (coalesced:
// K is the minor dimension) and stage its tile-centre-relative quadratic
// coefficients in shared memory; then every thread walks the chunk in
// order for its pixels, keeping T, rgb, depth and the last contributor's
// position in registers, exactly as the CUDA reference's per-pixel loop.
// The block leaves as soon as every pixel has stopped
// (__syncthreads_count). Outputs are written channel-planar, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr float kTermEps = 1e-4f;
constexpr float kLogAlphaSkip = -5.541263545158426f;  // log(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr int kOutCh = 8;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ feat, int64_t k_total,
                     const int* __restrict__ chunk_starts,
                     const int* __restrict__ n_chunks,
                     float* __restrict__ out, int grid_x, int chunk, int tile) {
  __shared__ float s_q0[kMaxChunk], s_qx[kMaxChunk], s_qy[kMaxChunk];
  __shared__ float s_ca[kMaxChunk], s_cb[kMaxChunk], s_cc[kMaxChunk];
  __shared__ float s_lop[kMaxChunk];
  __shared__ float s_col[4][kMaxChunk];

  const int t = blockIdx.x;
  const int pix = tile * tile;
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const float half = (tile - 1) * 0.5f;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float cx = (float)(tx * tile) + half;
  const float cy = (float)(ty * tile) + half;

  float x[PPT], y[PPT], T[PPT], acc[PPT][4], last[PPT];
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    x[i] = (float)(p % tile) - half;
    y[i] = (float)(p / tile) - half;
    T[i] = 1.0f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    last[i] = 0.0f;
    done[i] = false;
  }

  for (int k = 0; k < nc; ++k) {
    bool all_done = true;
#pragma unroll
    for (int i = 0; i < PPT; ++i) all_done = all_done && done[i];
    // Also the barrier before the staging buffers are overwritten.
    if (__syncthreads_count(!all_done) == 0) break;

    if (threadIdx.x < chunk) {
      const int64_t col = (int64_t)(cs + k) * chunk + threadIdx.x;
      const float mx = feat[0 * k_total + col] - cx;
      const float my = feat[1 * k_total + col] - cy;
      const float ca = feat[2 * k_total + col];
      const float cb = feat[3 * k_total + col];
      const float cc = feat[4 * k_total + col];
      const float lop = feat[5 * k_total + col];
      const float qx = ca * mx + cb * my;
      const float qy = cc * my + cb * mx;
      s_q0[threadIdx.x] = -0.5f * (mx * qx + my * qy) + lop;
      s_qx[threadIdx.x] = qx;
      s_qy[threadIdx.x] = qy;
      s_ca[threadIdx.x] = ca;
      s_cb[threadIdx.x] = cb;
      s_cc[threadIdx.x] = cc;
      s_lop[threadIdx.x] = lop;
#pragma unroll
      for (int c = 0; c < 4; ++c) s_col[c][threadIdx.x] = feat[(6 + c) * k_total + col];
    }
    __syncthreads();

    for (int g = 0; g < chunk; ++g) {
      const float q0 = s_q0[g], qx = s_qx[g], qy = s_qy[g];
      const float ca = s_ca[g], cb = s_cb[g], cc = s_cc[g], lop = s_lop[g];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (done[i]) continue;
        const float xi = x[i], yi = y[i];
        const float powero = (q0 + qx * xi) + (qy * yi + ca * (-0.5f * xi * xi)) +
                             (cb * (-(xi * yi)) + cc * (-0.5f * yi * yi));
        if (powero > lop || powero < kLogAlphaSkip) continue;
        const float alpha = fminf(expf(powero), kAlphaMax);
        const float test = T[i] * (1.0f - alpha);
        if (test < kTermEps) {
          done[i] = true;
          continue;
        }
        const float w = alpha * T[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += s_col[c][g] * w;
        T[i] = test;
        last[i] = (float)(k * chunk + g + 1);
      }
    }
  }

  float* o = out + (int64_t)t * kOutCh * pix;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    o[0 * pix + p] = acc[i][0];
    o[1 * pix + p] = acc[i][1];
    o[2 * pix + p] = acc[i][2];
    o[3 * pix + p] = acc[i][3];
    o[4 * pix + p] = T[i];
    o[5 * pix + p] = last[i];
    o[6 * pix + p] = 0.0f;
    o[7 * pix + p] = 0.0f;
  }
}

}  // namespace

extern "C" int composite_fwd(const float* feat, long long k_total,
                             const int* chunk_starts, const int* n_chunks,
                             float* out, int num_tiles, int grid_x, int chunk,
                             int tile, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 16) {
    composite_fwd_kernel<1><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out, grid_x, chunk, tile);
  } else if (tile == 32) {
    composite_fwd_kernel<4><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out, grid_x, chunk, tile);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
