// K2: tile-compositing backward for 3D Gaussian splatting, sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/rasterize_pallas.py, _bwd_kernel (called
// through composite_backward). Plain version: composite_backward_ref in
// dreamgaussian_tpu_torch/ops/rasterize_cuda.py.
//
// What bounds it on the H100: per contributing (gaussian, pixel) pair about
// 40 f32 operations, a reciprocal and an expf on the CUDA cores, then a sum
// of 10 gradient terms over the tile's 1,024 pixels for every gaussian. It
// is bound by operations, not by memory (a tile reads and writes 40 bytes
// per live duplicate). In practice two things set its time. On a large
// frame, the reduction: summed term by term with shuffles it costs more
// scheduler slots than the arithmetic, on the one shuffle pipe an SM has. On a
// small frame, the chain of dependent operations of the slowest warp of
// the longest tile, chunk after chunk.
//
// Design:
// - One block per 16x16 quadrant of a tile. Tile 32 launches a thread block
//   cluster of four blocks per tile (64 / 256 / 1024 blocks at 128^2 /
//   256^2 / 512^2), tile 16 one block and no cluster. Every quadrant walks
//   the tile's list back to front from the tile's last live chunk; a
//   quadrant whose own pixels end earlier sits the chunk out.
// - A block has 256 threads with one pixel each while the launch's blocks
//   fit on the card at once (the most warps for a small frame), and 128
//   threads with two pixels each beyond that: a thread then adds its two
//   pixels' terms in registers, which halves the reduction's cost per
//   pixel, and four of the smaller blocks fit on an SM.
// - A warp owns a compact 8-wide patch of pixels and walks a chunk from
//   its own last contributor down, so a warp whose pixels all ended
//   earlier skips the chunk. It first sifts the chunk 32 gaussians at a
//   time, one per lane, for those that can reach its patch at all (see
//   may_reach), and walks and reduces only those: small gaussians touch few
//   patches of a tile.
// - Each thread rebuilds T from T_final with a reciprocal of (1 - alpha)
//   per step and keeps the suffix sum of the accumulated colour in
//   registers (the CUDA reference's scheme). The reciprocal is refined by
//   a Newton step (rcp_refined): T goes through up to about 2,000 of them
//   on a long list, and d_alpha's two terms cancel (by a factor of about
//   200 under a mask loss), so the drift of the bare one-ulp approximation
//   showed in the log-opacity row against float64
//   (scripts/port_k2_hold_sweep.py). A batch's exponentials and
//   reciprocals, which do not depend on T, are formed together before the
//   order-dependent part, which has no branch. That gives a warp
//   independent work where a small frame leaves it alone on its scheduler.
// - The six moments of d_powero are taken about the gaussian's own centre,
//   not the tile's, so the mean and conic gradients follow from them
//   without the cancellation of large terms: the kernel's own rounding
//   error stays well inside the tolerance it is held to.
// - The reduction takes three gaussians at a time: their 30 per-lane terms
//   are summed over the warp by recursive halving (each step a lane keeps
//   half of its values and sends the other half: 31 shuffles for 30 sums
//   where term-by-term butterflies cost 150), skipped when no lane of the
//   warp has a contributing pair in the batch. Lane L ends with sum L and
//   stores it to the warp's partials in shared memory.
// - Per chunk: the block adds its warps' partials in warp order; after a
//   cluster barrier each block of the cluster takes a quarter of the
//   chunk's gaussians, adds the four quadrants' sums in quadrant order
//   through distributed shared memory, chains them to mean, conic and
//   log-opacity, and stores the duplicate's 10 gradient rows. Every slot
//   is written by one thread and every sum has a fixed order: no atomics,
//   equal bits on every run. The sums are double-buffered, so one cluster
//   barrier per chunk is enough.
// - The next chunk's rows are copied with cp.async while the current chunk
//   is walked, as in K1.
// - The kernel writes nothing else: chunks at or past the tile's largest
//   n_contrib, rows 10-15 and slots outside every tile's range keep the
//   zeros the wrapper allocates.

#include <cooperative_groups.h>

#include "composite_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace composite;

constexpr int kTerms = 10;   // six moments of d_powero, d rgb, d depth
constexpr int kBatch = 3;    // gaussians per warp reduction: 30 of 32 lanes
// Blocks of 256 threads that an SM holds at once (their registers decide
// it): a launch with more blocks than the card holds runs in waves.
constexpr int kBlocksPerSm = 2;

template <int WARPS>
struct Smem {
  StagedChunk st[2];
  RawChunk raw[2];
  float part[WARPS][kTerms * kMaxChunk];   // [warp][gaussian * 10 + term]
  float sum[2][kTerms * kMaxChunk];        // the block's sums, by chunk parity
  unsigned walked[WARPS][kMaxChunk / 32];  // bit g: the warp walked gaussian g of the chunk
  int max_nc;                              // largest n_contrib of the quadrant
};

// 1 / x: the one-ulp approximation (one special-function operation) and one
// Newton step, two fused multiply-adds, which bring it to rounding of the
// correctly rounded result without __frcp_rn's slow path (x = 1 - alpha lies
// in [0.01, 1]).
__device__ __forceinline__ float rcp_refined(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// Sum v[i] over the warp's lanes for all 32 i at once: lane L returns the
// sum of v[L]. Each step halves the values a lane holds.
template <int N>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool hi = (lane & (N / 2)) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = hi ? v[i + N / 2] : v[i];
    const float send = hi ? v[i] : v[i + N / 2];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, N / 2);
  }
}

__device__ __forceinline__ float warp_sums(float (&v)[32], int lane) {
  halve<32>(v, lane);
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  return v[0];
}

// Q: blocks (quadrants) per tile, a cluster when 4; the tile's edge is 16
// for Q = 1, 32 for Q = 4. PPT: pixels per thread, 1 or 2; a block has
// 256 / PPT threads.
template <int Q, int PPT>
__global__ void __launch_bounds__(kQuad * kQuad / PPT, PPT == 1 ? 2 : 4)
composite_bwd_kernel(const float* __restrict__ feat, int64_t k_total,
                     const int* __restrict__ chunk_starts,
                     const int* __restrict__ n_chunks,
                     const float* __restrict__ fwd,
                     const float* __restrict__ gout,
                     float* __restrict__ dfeat, int grid_x, int tile_offset,
                     int chunk) {
  constexpr int kPpt = PPT;
  constexpr int kThreads = kQuad * kQuad / PPT;
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads >= kMaxChunk, "a thread per staged gaussian");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<kWarps>& s = *reinterpret_cast<Smem<kWarps>*>(smem_bytes);
  cg::cluster_group cluster = cg::this_cluster();
  // Every thread of the tile's blocks: a cluster barrier, or the block's.
  auto sync_tile = [&]() {
    if constexpr (Q > 1) cluster.sync(); else __syncthreads();
  };

  constexpr int tile = Q == 4 ? 2 * kQuad : kQuad;
  constexpr int pix = tile * tile;
  const int t = blockIdx.x / Q;
  const int q = blockIdx.x % Q;   // the block's rank in its cluster
  const int cs = chunk_starts[t];
  const int nc = n_chunks[t];
  const float half = (tile - 1) * 0.5f;
  // The tile's place in the whole frame (see K1); chunk_starts, n_chunks and
  // the forward's tiles are the local slab's.
  const int ty = (t + tile_offset) / grid_x;
  const int tx = t + tile_offset - ty * grid_x;
  const float cx = (float)(tx * tile) + half;
  const float cy = (float)(ty * tile) + half;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* f_t = fwd + (int64_t)t * kOutCh * pix;
  const float* g_t = gout + (int64_t)t * kOutCh * pix;
  PixelTerms pt[kPpt];
  float T[kPpt], S[kPpt], kt[kPpt], gd[kPpt][4];
  int ncon[kPpt];
  int wmax = 0;
#pragma unroll
  for (int i = 0; i < kPpt; ++i) {
    int lx, ly;
    quadrant_pixel(warp, lane, i, kPpt, lx, ly);
    const int px = (q & 1) * kQuad + lx;
    const int py = (q >> 1) * kQuad + ly;
    const int p = py * tile + px;
    pt[i].set((float)px - half, (float)py - half);
    T[i] = f_t[4 * pix + p];
    ncon[i] = (int)f_t[5 * pix + p];
    S[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) gd[i][c] = g_t[c * pix + p];
    kt[i] = g_t[4 * pix + p] * T[i];
    wmax = max(wmax, ncon[i]);
  }
  PixelBox box;
  box.set(pt[0].x, pt[kPpt - 1].x, pt[0].y, pt[kPpt - 1].y);
  if (threadIdx.x == 0) s.max_nc = 0;
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = max(wmax, __shfl_xor_sync(kFullMask, wmax, off));
  if (lane == 0) atomicMax(&s.max_nc, wmax);
  sync_tile();

  // Live chunks of each quadrant (chunks at or past its largest n_contrib
  // are dead: no pixel reaches them) and of the tile.
  int k_live[Q];
  int my_live = 0, k_top = 0;
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    int m;
    if constexpr (Q > 1) m = *cluster.map_shared_rank(&s.max_nc, r); else m = s.max_nc;
    k_live[r] = min(nc, (m + chunk - 1) / chunk);
    k_top = max(k_top, k_live[r]);
    if (r == q) my_live = k_live[r];
  }

  const bool loader = threadIdx.x < chunk;
  // Lane L of a warp ends a batch's reduction with term L % 10 of the
  // batch's gaussian L / 10.
  const int red_j = lane / kTerms;
  const int red_r = lane - red_j * kTerms;
  // Gaussians of a chunk whose rows one block of the tile writes.
  const int per = (chunk + Q - 1) / Q;

  if (loader && k_top > 0)
    start_copy(s.raw[(k_top - 1) & 1], feat, k_total, (int64_t)(cs + k_top - 1) * chunk);
  for (int k = k_top - 1; k >= 0; --k) {
    const int b = k & 1;
    if (loader) stage_chunk(s.st, s.raw, feat, k_total, cs, k, k - 1, chunk, cx, cy);
    __syncthreads();   // st[b] is ready
    const StagedChunk& st = s.st[b];

    if (k < my_live) {
      // Gaussians of this chunk below the warp's last contributor.
      const int n_walk = max(0, min(chunk, wmax - k * chunk));
      if (lane < kMaxChunk / 32) s.walked[warp][lane] = 0;
      __syncwarp();
      // Thirty-two gaussians at a time, from the back: each lane sifts one,
      // then the warp walks the ones that can reach its pixels, back to
      // front, three to a reduction.
      for (int base = (n_walk - 1) & ~31; base >= 0; base -= 32) {
#if COMPOSITE_SIFT
        const int mine = min(base + lane, kMaxChunk - 1);
        unsigned todo = __ballot_sync(kFullMask, base + lane < n_walk && may_reach(st, mine, box));
#else
        unsigned todo = __ballot_sync(kFullMask, base + lane < n_walk);
#endif
        if (lane == 0) s.walked[warp][base >> 5] = todo;
        while (todo != 0) {
          // What does not depend on the pixels' running T and S, for the
          // whole batch: independent work that hides the latency of the
          // exponentials and reciprocals.
          int g[kBatch];
          float po[kBatch][kPpt];
          bool ok[kBatch][kPpt];
          bool any = false;
          int red_g = -1;   // the gaussian whose sum this lane ends with
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const bool valid = todo != 0;
            const int bit = valid ? 31 - __clz(todo) : 0;
            todo &= ~(valid ? 1u << bit : 0u);
            g[j] = base + bit;
            if (valid && red_j == j) red_g = g[j];
            const int gpos = k * chunk + g[j];   // 0-based position in the tile's list
            const float4 fa = st.a[g[j]], fb = st.b[g[j]];
#pragma unroll
            for (int i = 0; i < kPpt; ++i) {
              po[j][i] = powero_of(fa, fb, pt[i]);
              ok[j][i] = valid && gpos < ncon[i] && !pair_skipped(po[j][i], fa.w);
              any = any || ok[j][i];
            }
          }
          if (!__any_sync(kFullMask, any)) {
            if (red_g >= 0) s.part[warp][red_g * kTerms + red_r] = 0.0f;
            continue;
          }
          // A pair that does not contribute gets alpha 0 and reciprocal 1:
          // the order-dependent part below then needs no branch and leaves
          // that pixel's T and S as they are.
          float alpha_raw[kBatch][kPpt], alpha[kBatch][kPpt], rinv[kBatch][kPpt];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
#pragma unroll
            for (int i = 0; i < kPpt; ++i) {
              const float raw = expf(po[j][i]);
              alpha_raw[j][i] = ok[j][i] ? raw : 0.0f;
              alpha[j][i] = fminf(alpha_raw[j][i], kAlphaMax);
              rinv[j][i] = ok[j][i] ? rcp_refined(1.0f - alpha[j][i]) : 1.0f;
            }
          }
          // The order-dependent part, back to front. The six moments of
          // d_powero are taken about the gaussian's own centre, so that
          // mean and conic gradients follow from them without cancellation.
          float v[32];
          v[30] = v[31] = 0.0f;
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const float4 fc = st.c[g[j]];
            const float2 fm = st.m[g[j]];
            float* vj = &v[j * kTerms];
#pragma unroll
            for (int i = 0; i < kPpt; ++i) {
              const float t_g = T[i] * rinv[j][i];   // T before this gaussian
              const float w = alpha[j][i] * t_g;
              const float e = ((fc.x * gd[i][0] + fc.y * gd[i][1]) + fc.z * gd[i][2]) + fc.w * gd[i][3];
              const float d_alpha = e * t_g - (S[i] + kt[i]) * rinv[j][i];
              S[i] += w * e;
              T[i] = t_g;
              const float dpo = alpha_raw[j][i] * d_alpha;   // the 0.99 clamp is straight-through
              const float dx = pt[i].x - fm.x, dy = pt[i].y - fm.y;
              const float dpx = dpo * dx, dpy = dpo * dy;
              const float term[kTerms] = {dpo, dpx, dpy, dpx * dx, dpx * dy, dpy * dy,
                                          w * gd[i][0], w * gd[i][1], w * gd[i][2], w * gd[i][3]};
#pragma unroll
              for (int r = 0; r < kTerms; ++r) vj[r] = i == 0 ? term[r] : vj[r] + term[r];
            }
          }
          const float mine_sum = warp_sums(v, lane);
          if (red_g >= 0) s.part[warp][red_g * kTerms + red_r] = mine_sum;
        }
      }
    }
    __syncthreads();   // the warps' partials are complete

    if (k < my_live) {
      for (int f = threadIdx.x; f < chunk * kTerms; f += kThreads) {
        const int g = f / kTerms;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if ((s.walked[w][g >> 5] >> (g & 31)) & 1u) acc += s.part[w][f];
        s.sum[b][f] = acc;
      }
    }
    sync_tile();   // every quadrant's sums of this chunk are complete

    // This block's quarter of the chunk: one (gradient row, gaussian) item
    // per thread and round, rows outermost so that a warp writes 32
    // neighbouring slots of one row.
    const float* src[Q];
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      if constexpr (Q > 1) src[r] = cluster.map_shared_rank(&s.sum[b][0], r); else src[r] = &s.sum[b][0];
    }
    // Term `term` of gaussian g summed over the quadrants, in quadrant order.
    auto tile_sum = [&](int g, int term) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < Q; ++r)
        if (k < k_live[r]) acc += src[r][g * kTerms + term];   // else it sat the chunk out
      return acc;
    };
    for (int item = threadIdx.x; item < per * kTerms; item += kThreads) {
      const int row = item / per;
      const int g = q * per + item - row * per;
      if (g >= chunk) continue;
      // Terms 0..5 are the sums of d_powero times 1, dx, dy, dx^2, dx dy,
      // dy^2 with (dx, dy) the pixel's offset from the gaussian's centre.
      float grad;
      if (row < 2) {
        const float4 fb = st.b[g];   // conic a, b, c
        const float sx = tile_sum(g, 1), sy = tile_sum(g, 2);
        grad = row == 0 ? fb.x * sx + fb.y * sy : fb.y * sx + fb.z * sy;
      } else if (row < 5) {
        grad = (row == 3 ? -1.0f : -0.5f) * tile_sum(g, row + 1);
      } else {
        grad = tile_sum(g, row == 5 ? 0 : row);
      }
      dfeat[row * k_total + (int64_t)(cs + k) * chunk + g] = grad;
    }
  }
  if (loader) cp_async_wait_all();
  // A block of a cluster must not leave while another may still read its
  // shared memory.
  sync_tile();
}

template <int Q, int PPT>
cudaError_t launch(const float* feat, int64_t k_total, const int* chunk_starts,
                   const int* n_chunks, const float* fwd, const float* gout, float* dfeat,
                   int num_tiles, int grid_x, int tile_offset, int chunk, cudaStream_t stream,
                   int* blocks_launched) {
  constexpr int threads = kQuad * kQuad / PPT;
  using Shared = Smem<threads / 32>;
  auto kernel = composite_bwd_kernel<Q, PPT>;
  // More than 48 KB of shared memory has to be asked for, on the device the
  // launch goes to.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Shared));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)num_tiles * Q);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = sizeof(Shared);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, feat, k_total, chunk_starts, n_chunks, fwd, gout,
                           dfeat, grid_x, tile_offset, chunk);
  if (err == cudaSuccess) *blocks_launched = (int)cfg.gridDim.x;
  return err;
}

// One pixel per thread gives a small frame the most warps. Once the blocks
// outnumber what the card holds at once, two pixels per thread do better:
// the reduction then costs half as much per pixel, and the smaller blocks
// fit four to an SM. On the trainer's cloud one pixel is 13 to 19% faster at
// 64 and 256 blocks, two pixels 8% faster at 1,024 (one process, H100).
template <int Q>
cudaError_t launch_tiles(const float* feat, int64_t k_total, const int* chunk_starts,
                         const int* n_chunks, const float* fwd, const float* gout,
                         float* dfeat, int num_tiles, int grid_x, int tile_offset, int chunk,
                         cudaStream_t stream, int* blocks_launched) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return (long long)num_tiles * Q > (long long)kBlocksPerSm * sms
             ? launch<Q, 2>(feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, num_tiles,
                            grid_x, tile_offset, chunk, stream, blocks_launched)
             : launch<Q, 1>(feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, num_tiles,
                            grid_x, tile_offset, chunk, stream, blocks_launched);
}

}  // namespace

// Returns the CUDA error of the launch (0: launched) and, where it
// launched, the grid it gave the launch in *blocks_launched.
extern "C" int composite_bwd(const float* feat, long long k_total,
                             const int* chunk_starts, const int* n_chunks,
                             const float* fwd, const float* gout, float* dfeat,
                             int num_tiles, int grid_x, int tile_offset, int chunk, int tile,
                             void* stream, int* blocks_launched) {
  if (chunk <= 0 || chunk > kMaxChunk || num_tiles <= 0 || tile_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tile == kQuad) {
    err = launch_tiles<1>(feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, num_tiles,
                          grid_x, tile_offset, chunk, s, blocks_launched);
  } else if (tile == 2 * kQuad) {
    err = launch_tiles<4>(feat, k_total, chunk_starts, n_chunks, fwd, gout, dfeat, num_tiles,
                          grid_x, tile_offset, chunk, s, blocks_launched);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  // Reading the last error also clears it: a refused launch must not show
  // up again at the caller's next CUDA call.
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
