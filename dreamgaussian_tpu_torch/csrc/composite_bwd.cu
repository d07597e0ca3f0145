// K2: tile-compositing backward for 3D Gaussian splatting, sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/rasterize_pallas.py, _bwd_kernel (called
// through composite_backward). Plain version: composite_backward_ref in
// dreamgaussian_tpu_torch/ops/rasterize_cuda.py.
//
// What bounds it on the H100: per contributing (gaussian, pixel) pair about
// 40 f32 operations, a division and an expf on the CUDA cores, then a sum
// of 10 gradient terms over the tile's pixels for every gaussian. It is
// bound by operations and by that per-gaussian reduction across the block,
// not by memory: a tile reads and writes 40 bytes per live duplicate.
//
// Design: one block of 256 threads per tile, each thread owning PPT pixels
// (4 at tile 32, 1 at tile 16). Each thread walks its pixels back to front
// from its own n_contrib, rebuilding T from T_final by dividing by
// (1 - alpha) step by step and keeping the suffix sum of the accumulated
// colour in registers (the CUDA reference's scheme). For each gaussian of a
// chunk the 10 per-pixel terms are summed over the warp with shuffles
// (skipped when no lane of the warp has a contributing pair), each warp's
// partial goes to shared memory, and after the chunk the first `chunk`
// threads add the 8 partials in warp order, chain them to mean, conic and
// log-opacity, and store the duplicate's 10 gradient rows. A duplicate
// slot belongs to exactly one tile, so no atomics are needed and the
// result is deterministic. The kernel writes nothing else: chunks at or
// past the tile's largest n_contrib, rows 10-15 and slots outside every
// tile's range keep the zeros the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr float kLogAlphaSkip = -5.541263545158426f;  // log(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr int kOutCh = 8;
constexpr int kTerms = 10;  // s0..s5 (quadratic monomials), d rgb, d depth

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ feat, int64_t k_total,
                     const int* __restrict__ chunk_starts,
                     const int* __restrict__ n_chunks,
                     const float* __restrict__ fwd,
                     const float* __restrict__ gout,
                     float* __restrict__ dfeat, int grid_x, int chunk,
                     int tile) {
  __shared__ float s_mx[kMaxChunk], s_my[kMaxChunk], s_qx[kMaxChunk];
  __shared__ float s_qy[kMaxChunk], s_q0[kMaxChunk], s_lop[kMaxChunk];
  __shared__ float s_ca[kMaxChunk], s_cb[kMaxChunk], s_cc[kMaxChunk];
  __shared__ float s_col[4][kMaxChunk];
  __shared__ float s_part[kWarps][kTerms][kMaxChunk];
  __shared__ int s_max_nc;

  const int t = blockIdx.x;
  const int pix = tile * tile;
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const float half = (tile - 1) * 0.5f;
  const int ty = t / grid_x;
  const int tx = t - ty * grid_x;
  const float cx = (float)(tx * tile) + half;
  const float cy = (float)(ty * tile) + half;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* f_t = fwd + (int64_t)t * kOutCh * pix;
  const float* g_t = gout + (int64_t)t * kOutCh * pix;
  float x[PPT], y[PPT], T[PPT], S[PPT], kt[PPT], gd[PPT][4];
  int ncon[PPT];
  int my_max = 0;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    x[i] = (float)(p % tile) - half;
    y[i] = (float)(p / tile) - half;
    T[i] = f_t[4 * pix + p];
    ncon[i] = (int)f_t[5 * pix + p];
    S[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) gd[i][c] = g_t[c * pix + p];
    kt[i] = g_t[4 * pix + p] * T[i];
    my_max = max(my_max, ncon[i]);
  }
  if (threadIdx.x == 0) s_max_nc = 0;
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_max = max(my_max, __shfl_xor_sync(0xffffffffu, my_max, off));
  if (lane == 0) atomicMax(&s_max_nc, my_max);
  __syncthreads();
  const int max_nc = s_max_nc;

  // Chunks at or past max_nc are dead: no pixel reaches them.
  const int k_live = min(nc, (max_nc + chunk - 1) / chunk);
  for (int k = k_live - 1; k >= 0; --k) {
    const int64_t base = (int64_t)(cs + k) * chunk;
    __syncthreads();  // the previous chunk's epilogue is done with smem
    if (threadIdx.x < chunk) {
      const int64_t col = base + threadIdx.x;
      const float mx = feat[0 * k_total + col] - cx;
      const float my = feat[1 * k_total + col] - cy;
      const float ca = feat[2 * k_total + col];
      const float cb = feat[3 * k_total + col];
      const float cc = feat[4 * k_total + col];
      const float lop = feat[5 * k_total + col];
      const float qx = ca * mx + cb * my;
      const float qy = cc * my + cb * mx;
      s_mx[threadIdx.x] = mx;
      s_my[threadIdx.x] = my;
      s_qx[threadIdx.x] = qx;
      s_qy[threadIdx.x] = qy;
      s_q0[threadIdx.x] = -0.5f * (mx * qx + my * qy) + lop;
      s_lop[threadIdx.x] = lop;
      s_ca[threadIdx.x] = ca;
      s_cb[threadIdx.x] = cb;
      s_cc[threadIdx.x] = cc;
#pragma unroll
      for (int c = 0; c < 4; ++c) s_col[c][threadIdx.x] = feat[(6 + c) * k_total + col];
    }
    __syncthreads();

    for (int g = chunk - 1; g >= 0; --g) {
      const int gpos = k * chunk + g;  // 0-based position in the tile's list
      const float q0 = s_q0[g], qx = s_qx[g], qy = s_qy[g], lop = s_lop[g];
      const float ca = s_ca[g], cb = s_cb[g], cc = s_cc[g];
      const float cr = s_col[0][g], cgr = s_col[1][g], cbl = s_col[2][g], cd = s_col[3][g];
      float v[kTerms];
#pragma unroll
      for (int r = 0; r < kTerms; ++r) v[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (gpos >= ncon[i]) continue;
        const float xi = x[i], yi = y[i];
        const float powero = (q0 + qx * xi) + (qy * yi + ca * (-0.5f * xi * xi)) +
                             (cb * (-(xi * yi)) + cc * (-0.5f * yi * yi));
        if (powero > lop || powero < kLogAlphaSkip) continue;
        const float alpha_raw = expf(powero);
        const float alpha = fminf(alpha_raw, kAlphaMax);
        const float one_m = 1.0f - alpha;
        const float t_g = T[i] / one_m;  // T before this gaussian
        const float w = alpha * t_g;
        const float e = ((cr * gd[i][0] + cgr * gd[i][1]) + cbl * gd[i][2]) + cd * gd[i][3];
        const float d_alpha = e * t_g - (S[i] + kt[i]) / one_m;
        S[i] += w * e;
        T[i] = t_g;
        const float dpo = alpha_raw * d_alpha;  // the 0.99 clamp is straight-through
        v[0] += dpo;
        v[1] += dpo * xi;
        v[2] += dpo * yi;
        v[3] += dpo * (xi * xi);
        v[4] += dpo * (xi * yi);
        v[5] += dpo * (yi * yi);
        v[6] += w * gd[i][0];
        v[7] += w * gd[i][1];
        v[8] += w * gd[i][2];
        v[9] += w * gd[i][3];
        any = true;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < kTerms; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kTerms; ++r) s_part[warp][r][g] = v[r];
      }
    }
    __syncthreads();

    if (threadIdx.x < chunk) {
      const int g = threadIdx.x;
      float s[kTerms];
#pragma unroll
      for (int r = 0; r < kTerms; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[w][r][g];
        s[r] = acc;
      }
      const float mx = s_mx[g], my = s_my[g], qx = s_qx[g], qy = s_qy[g];
      const float ca = s_ca[g], cb = s_cb[g], cc = s_cc[g];
      const int64_t col = base + g;
      dfeat[0 * k_total + col] = -qx * s[0] + ca * s[1] + cb * s[2];
      dfeat[1 * k_total + col] = -qy * s[0] + cb * s[1] + cc * s[2];
      dfeat[2 * k_total + col] = -0.5f * mx * mx * s[0] + mx * s[1] - 0.5f * s[3];
      dfeat[3 * k_total + col] = -mx * my * s[0] + my * s[1] + mx * s[2] - s[4];
      dfeat[4 * k_total + col] = -0.5f * my * my * s[0] + my * s[2] - 0.5f * s[5];
      dfeat[5 * k_total + col] = s[0];
#pragma unroll
      for (int c = 0; c < 4; ++c) dfeat[(6 + c) * k_total + col] = s[6 + c];
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const float* feat, long long k_total,
                             const int* chunk_starts, const int* n_chunks,
                             const float* fwd, const float* gout, float* dfeat,
                             int num_tiles, int grid_x, int chunk, int tile,
                             void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 16) {
    composite_bwd_kernel<1><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, grid_x, chunk, tile);
  } else if (tile == 32) {
    composite_bwd_kernel<4><<<num_tiles, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, grid_x, chunk, tile);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
