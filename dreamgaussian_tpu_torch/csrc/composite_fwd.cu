// K1: tile-compositing forward for 3D Gaussian splatting, sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/rasterize_pallas.py, _fwd_kernel (called
// through composite_forward). Plain version: composite_forward_ref in
// dreamgaussian_tpu_torch/ops/rasterize_cuda.py, which also documents the
// row and channel layouts.
//
// What bounds it on the H100: per (gaussian, pixel) pair about 20 f32
// operations and one expf on the CUDA cores, against 40 bytes of features
// per gaussian that a whole tile shares. So it is bound by operations (f32,
// no tensor cores), and in practice by three things that keep the cores
// idle: too few blocks for 132 SMs when the frame is small, pixels that
// have stopped but wait for the slowest pixel of their group, and the
// chain of dependent operations a single pixel's walk is.
//
// Design:
// - One block of 256 threads per 16x16 quadrant of a tile, one pixel per
//   thread: tile 32 launches four blocks per tile (64 / 256 / 1024 blocks
//   at 128^2 / 256^2 / 512^2), tile 16 one. The quadrants need nothing
//   from each other, so they are plain blocks, and each leaves as soon as
//   its own 256 pixels have stopped.
// - A warp owns a compact 8x4 patch of pixels, so its lanes skip and stop
//   together; a warp whose lanes have all stopped skips the walk and only
//   meets the others at the chunk's barrier.
// - The next chunk's 10 feature rows are copied with cp.async (each of the
//   first `chunk` threads copies its own column, so it needs no barrier to
//   read it back) while the current chunk is walked. One barrier per chunk:
//   the staged coefficients are double-buffered, and the barrier also
//   counts the pixels still walking.
// - A warp sifts a chunk 32 gaussians at a time, one per lane, for those
//   that can reach its patch at all (the least of the conic's quadratic
//   form over the patch's box against the 1/255 threshold, with a margin
//   for rounding), and walks only those. Small gaussians touch few patches
//   of a tile, and padding slots are sifted out for nothing.
// - A gaussian's staged coefficients are three float4 broadcast reads.
//   Four gaussians are taken together: their exponents, skip tests and
//   exponentials are independent work that the scheduler overlaps, and the
//   order-dependent part that follows has no branch, so the chain through
//   T costs a multiply, a compare and a select per gaussian. A batch none
//   of whose gaussians reaches a live pixel of the warp ends at the vote.
// - The exponent and the stop test are computed without multiply-add
//   contraction (the skip and stop decisions then fall as in the plain
//   version); the colour accumulation contracts.

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int kThreads = 256;
constexpr int kBatch = 4;   // gaussians whose exponents are evaluated together

// Q: blocks (quadrants) per tile; the tile's edge is 16 for Q = 1, 32 for 4.
template <int Q>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ feat, int64_t k_total,
                     const int* __restrict__ chunk_starts,
                     const int* __restrict__ n_chunks,
                     float* __restrict__ out, int grid_x, int tile_offset,
                     int chunk) {
  __shared__ StagedChunk s_st[2];
  __shared__ RawChunk s_raw[2];

  constexpr int tile = Q == 4 ? 2 * kQuad : kQuad;
  constexpr int pix = tile * tile;
  const int t = blockIdx.x / Q;
  const int q = blockIdx.x % Q;
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const float half = (tile - 1) * 0.5f;
  // The tile's place in the whole frame: a rank of a tile-sharded render
  // composites the slab of tiles that starts at tile_offset.
  const int ty = (t + tile_offset) / grid_x;
  const int tx = t + tile_offset - ty * grid_x;
  const float cx = (float)(tx * tile) + half;
  const float cy = (float)(ty * tile) + half;

  const int lane = threadIdx.x & 31;
  int lx, ly;
  quadrant_pixel(threadIdx.x >> 5, lane, 0, 1, lx, ly);
  const int px = (q & 1) * kQuad + lx;
  const int py = (q >> 1) * kQuad + ly;
  PixelTerms pt;
  pt.set((float)px - half, (float)py - half);

  PixelBox box;
  box.set(pt.x, pt.x, pt.y, pt.y);

  float T = 1.0f, acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f, last = 0.0f;
  bool done = false;        // this pixel has stopped
  bool warp_done = false;   // all of the warp's pixels have

  const bool loader = threadIdx.x < chunk;
  if (loader && nc > 0) start_copy(s_raw[0], feat, k_total, (int64_t)cs * chunk);
  for (int k = 0; k < nc; ++k) {
    if (loader)
      stage_chunk(s_st, s_raw, feat, k_total, cs, k, k + 1 < nc ? k + 1 : -1, chunk, cx, cy);
    // The chunk's one barrier: st[k & 1] is ready, and nobody still reads
    // the buffer that the next iteration overwrites. It also counts the
    // pixels still walking.
    if (__syncthreads_count(!done) == 0) break;
    if (warp_done) continue;
    const StagedChunk& st = s_st[k & 1];
    // Thirty-two gaussians at a time: each lane sifts one, then the warp
    // walks the ones that can reach its pixels, in order, in batches.
    for (int base = 0; base < chunk && !warp_done; base += 32) {
#if COMPOSITE_SIFT
      const int mine = min(base + lane, kMaxChunk - 1);
      unsigned todo = __ballot_sync(kFullMask, base + lane < chunk && may_reach(st, mine, box));
#else
      unsigned todo = __ballot_sync(kFullMask, base + lane < chunk);
#endif
      while (todo != 0) {
        // What does not depend on the pixel's running T, for the whole
        // batch: independent work that hides the latency of the exponentials.
        int g[kBatch];
        float po[kBatch];
        bool ok[kBatch];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool valid = todo != 0;
          g[j] = valid ? base + __ffs(todo) - 1 : base;
          todo &= todo - 1;
          const float4 a = st.a[g[j]];
          po[j] = powero_of(a, st.b[g[j]], pt);
          ok[j] = valid && !pair_skipped(po[j], a.w);
          any = any || ok[j];
        }
        if (!__any_sync(kFullMask, any && !done)) continue;
        float alpha[kBatch], one_m[kBatch];
        float4 col[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          alpha[j] = fminf(expf(po[j]), kAlphaMax);
          one_m[j] = __fsub_rn(1.0f, alpha[j]);
          col[j] = st.c[g[j]];
        }
        // The order-dependent part, without branches: per gaussian the
        // chain through T is one multiply, one compare and one select.
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float test = __fmul_rn(T, one_m[j]);
          const bool live = ok[j] && !done;
          const bool adds = live && !(test < kTermEps);
          done = done || (live && test < kTermEps);
          const float w = adds ? alpha[j] * T : 0.0f;
          acc0 += col[j].x * w;
          acc1 += col[j].y * w;
          acc2 += col[j].z * w;
          acc3 += col[j].w * w;
          T = adds ? test : T;
          last = adds ? (float)(k * chunk + g[j] + 1) : last;
        }
        if (__all_sync(kFullMask, done)) {
          warp_done = true;
          break;
        }
      }
    }
  }
  // No copy may still be in flight into this block's shared memory when
  // the block leaves.
  if (loader) cp_async_wait_all();

  float* o = out + (int64_t)t * kOutCh * pix + py * tile + px;
  o[0 * pix] = acc0;
  o[1 * pix] = acc1;
  o[2 * pix] = acc2;
  o[3 * pix] = acc3;
  o[4 * pix] = T;
  o[5 * pix] = last;
  o[6 * pix] = 0.0f;
  o[7 * pix] = 0.0f;
}

}  // namespace

// Returns the CUDA error of the launch (0: launched) and, where it
// launched, the grid it gave the launch in *blocks_launched.
extern "C" int composite_fwd(const float* feat, long long k_total,
                             const int* chunk_starts, const int* n_chunks,
                             float* out, int num_tiles, int grid_x, int tile_offset,
                             int chunk, int tile, void* stream, int* blocks_launched) {
  if (chunk <= 0 || chunk > kMaxChunk || num_tiles <= 0 || tile_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (tile == kQuad) {
    grid = dim3((unsigned)num_tiles);
    composite_fwd_kernel<1><<<grid, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out, grid_x, tile_offset, chunk);
  } else if (tile == 2 * kQuad) {
    grid = dim3((unsigned)num_tiles * 4u);
    composite_fwd_kernel<4><<<grid, kThreads, 0, s>>>(
        feat, k_total, chunk_starts, n_chunks, out, grid_x, tile_offset, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *blocks_launched = (int)grid.x;
  return (int)err;
}
