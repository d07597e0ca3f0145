// K3: per-tile triangle z-test (nearest covering triangle per pixel), sm_90a.
//
// Replaces: dreamgaussian_tpu/ops/mesh_raster_pallas.py, _ztest_kernel
// (called through ztest). Plain version: ztest_ref in
// dreamgaussian_tpu_torch/ops/mesh_raster_cuda.py, which also documents the
// feature rows and the tie rules.
//
// What bounds it on the H100: by count, the bytes. A tile's list is 40
// bytes per triangle slot, and after decimation the triangles are a few
// pixels wide, so a pixel centre lies in the bounding box of well under 1%
// of the (pixel, triangle) pairs of its tile's list (bake view 9 of the
// smoke run's export: 584,916 of 118,355,968). Evaluating every pair, as a
// plain walk does, spends 200 times the operations that coverage needs. In
// practice the time goes to the pairs that a warp still walks and to the
// latency of each one's chain of shared-memory reads and comparisons.
//
// Design:
// - Work items are runs of a tile's list for one 16x16 quadrant of the
//   tile: four quadrants per 32x32 tile (one per 16x16 tile), each list cut
//   into up to kMaxSegments runs of at least kSegmentChunks chunks, so that
//   a long list is walked by several blocks at once (the longest list of a
//   bake view has 12 to 27 chunks, the mean about 4).
// - Persistent blocks of 256 threads, six per SM, one pixel of the
//   quadrant per thread; a warp owns a compact 8x4 patch of it. A block
//   reads the lists of its next 256 slots at once into a table in shared
//   memory and walks the runs that the table holds, chunk after chunk.
// - The first `chunk` threads load one slot's 10 feature rows each into
//   registers, the next chunk's while the current one is walked (across
//   runs too), then stage the vertices, the edge differences, z, 1/area,
//   the id and the area in shared memory (double-buffered: one barrier per
//   chunk).
// - A quadrant cut into several runs keeps each run's winners in `part` and
//   counts its runs done; the block that counts the last run folds the
//   runs' winners in list order and writes the quadrant.
// - The sift: a warp takes the chunk 32 slots at a time, one per lane; each
//   lane decides whether its triangle can cover any pixel of the warp's
//   patch (may_cover), the warp votes, and walks only the triangles that
//   pass, every lane testing its own pixel. Padding slots and zero-area
//   triangles fall out in the same vote.
// - The sift is exact for the rounded arithmetic, with no margin. An edge
//   function is computed as fl(fl(A*fl(py-ya)) - fl(B*fl(px-xa))) with A, B
//   the rounded edge differences; its sign is that of
//   fl(A*fl(py-ya)) - fl(B*fl(px-xa)), and each of those two products is a
//   monotone function of py alone or of px alone, since rounding is
//   monotone. So over the patch's box of pixel centres (a product of a
//   range of columns and a range of rows) the best the edge can do is
//   reached at one corner, chosen by the signs of A and B, and the test
//   there decides exactly whether some pixel of the patch passes that edge.
//   A triangle is walked if each of its three edges passes somewhere in the
//   patch; it may then still miss every pixel, but it is never dropped
//   where the plain version finds it covering. (A test on the triangle's
//   bounding box would not do: a sliver's rounded edge functions can all be
//   >= 0 at pixel centres far outside its box.)
// - The arithmetic is written in the plain version's order and the file is
//   built without fused multiply-add, so each operation rounds as the plain
//   version's does and the ids and z are the plain version's bits.
//
// ZTEST_SIFT=0 builds the kernel without the sift (every valid slot of a
// chunk is walked); both builds must give the same bits, and the card's
// tests hold them to that.
// PERF.md records the designs timed against this one, among them the
// triangle-major walk of scripts/ztest_triangle_major.cu.
//
// Ties, as in the plain version: a pixel centre on an edge is inside.
// Within a chunk equal z goes to the larger id, and a pixel takes nothing
// from a chunk where a covering triangle gives it a NaN z (the chunk's
// minimum is then NaN); across chunks only a strictly smaller z replaces
// the winner.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#ifndef ZTEST_SIFT
#define ZTEST_SIFT 1
#endif

namespace {

constexpr int kThreads = 256;       // one per pixel of a 16x16 quadrant
constexpr int kMaxSegments = 8;     // runs a quadrant's list is cut into at most
constexpr int kSegmentChunks = 2;   // chunks a run has at least
constexpr int kBlocksPerSm = 6;     // what 40 registers a thread let an SM hold
constexpr int kQuad = 16;        // edge of the pixel square one block owns
constexpr int kMaxChunk = 128;
constexpr int kRealRows = 10;
constexpr float kBig = 3.4e38f;
constexpr unsigned kFullMask = 0xffffffffu;

// One chunk as it is walked: thread g staged slot g.
struct StagedChunk {
  float4 v01[kMaxChunk];   // x0, y0, x1, y1
  float4 v2e0[kMaxChunk];  // x2, y2, A0 = x2 - x1, B0 = y2 - y1
  float4 e12[kMaxChunk];   // A1 = x0 - x2, B1 = y0 - y2, A2 = x1 - x0, B2 = y1 - y0
  float4 zi[kMaxChunk];    // z0, z1, z2, 1 / area
  float2 ida[kMaxChunk];   // id, area
};

// The box of pixel centres a warp owns, in absolute pixel coordinates.
struct PatchBox {
  float x0, x1, y0, y1;
};

// Does some pixel centre of the box pass this edge's half of the inside
// test (e >= 0 for a positive area, e <= 0 for a negative one), with
// e = A * (py - ya) - B * (px - xa) rounded as the walk rounds it? Exact:
// both products are monotone in one coordinate each (see the note above).
__device__ __forceinline__ bool edge_may_pass(float A, float B, float xa, float ya,
                                              const PatchBox& box, bool pos) {
  const float py = ((A >= 0.0f) == pos) ? box.y1 : box.y0;
  const float px = ((B >= 0.0f) == pos) ? box.x0 : box.x1;
  const float p1 = A * (py - ya);
  const float p2 = B * (px - xa);
  return pos ? p1 >= p2 : p1 <= p2;
}

__device__ __forceinline__ bool may_cover(const StagedChunk& st, int g, const PatchBox& box) {
  const float2 ida = st.ida[g];
  if (!(ida.x > 0.0f) || ida.y == 0.0f) return false;
#if ZTEST_SIFT
  const float4 v01 = st.v01[g], v2e0 = st.v2e0[g], e12 = st.e12[g];
  const bool pos = ida.y > 0.0f;
  return edge_may_pass(v2e0.z, v2e0.w, v01.z, v01.w, box, pos) &&
         edge_may_pass(e12.x, e12.y, v2e0.x, v2e0.y, box, pos) &&
         edge_may_pass(e12.z, e12.w, v01.x, v01.y, box, pos);
#else
  return true;
#endif
}

// One slot's feature rows, as loaded.
struct Slot {
  float f[kRealRows];
};

__device__ __forceinline__ void load_slot(Slot& s, const float* __restrict__ feat,
                                          int64_t k_total, int64_t col) {
#pragma unroll
  for (int r = 0; r < kRealRows; ++r) s.f[r] = __ldg(feat + r * k_total + col);
}

// In the plain version's operation order (the file has no contraction).
__device__ __forceinline__ void stage_slot(StagedChunk& st, int g, const Slot& s) {
  const float x0 = s.f[0], y0 = s.f[1], x1 = s.f[2], y1 = s.f[3], x2 = s.f[4], y2 = s.f[5];
  const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
  st.v01[g] = make_float4(x0, y0, x1, y1);
  st.v2e0[g] = make_float4(x2, y2, x2 - x1, y2 - y1);
  st.e12[g] = make_float4(x0 - x2, y0 - y2, x1 - x0, y1 - y0);
  st.zi[g] = make_float4(s.f[6], s.f[7], s.f[8], 1.0f / (area != 0.0f ? area : 1.0f));
  st.ida[g] = make_float2(s.f[9], area);
}

// The blocks' work: quadrant-segments. Quadrant qd (tile t = qd / Q, its
// quadrant qd % Q) of a tile with nc chunks is cut, in list order, into runs
// of per = max(kSegmentChunks, ceil(nc / kMaxSegments)) chunks: ceil(nc /
// per) segments (one, with no chunk, for an empty list). Slot s of the
// T * Q * kMaxSegments slots is segment s / (T * Q) of quadrant s % (T * Q);
// slots past a quadrant's segment count are empty.
struct Segment {
  int qd, seg, k0, k1;
};

__device__ __forceinline__ int chunks_per_segment(int nc) {
  return max(kSegmentChunks, (nc + kMaxSegments - 1) / kMaxSegments);
}

__device__ __forceinline__ int segments_of(int nc) {
  return nc == 0 ? 1 : (nc + chunks_per_segment(nc) - 1) / chunks_per_segment(nc);
}

// The first entry after i of the block's table (of n) that has a chunk; n
// if none.
__device__ __forceinline__ int next_with_chunks(const Segment* work, int i, int n) {
  for (++i; i < n && work[i].k0 == work[i].k1; ++i) {
  }
  return i;
}

// Persistent blocks: block b takes slots b, b + G, b + 2G, ... (G blocks),
// 256 at a time: each thread reads the list of one slot into a table in
// shared memory, then the block walks the table's segments one chunk after
// another, so that the next chunk's slots are always being loaded while
// the current one is walked, across segments too. A quadrant with one
// segment writes its pixels' winners. A quadrant with more writes each
// segment's winners to `part` and counts the segment in `done`; the block
// that counts the last one folds the segments' winners of each pixel in
// list order, where only a strictly smaller z replaces the winner (as
// across chunks), and writes them.
template <int Q>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ztest_kernel(const float* __restrict__ feat, int64_t k_total,
             const int* __restrict__ chunk_starts, const int* __restrict__ n_chunks,
             int* __restrict__ out_id, float* __restrict__ out_z, float2* __restrict__ part,
             int* __restrict__ done, int num_tiles, int grid_x, int chunk) {
  __shared__ StagedChunk s_st[2];
  __shared__ Segment s_work[kThreads];
  __shared__ int s_cs[kThreads], s_nseg[kThreads];
  __shared__ int s_count[kThreads / 32], s_n, s_last;

  constexpr int tile = Q == 4 ? 2 * kQuad : kQuad;
  const int quads = num_tiles * Q;
  const int64_t slots = (int64_t)quads * kMaxSegments;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool loader = threadIdx.x < chunk;
  int buf = 0;
  Slot next;

  for (int64_t first = blockIdx.x; first < slots; first += (int64_t)gridDim.x * kThreads) {
    // The table: the segments among the next 256 slots, in slot order.
    {
      const int64_t slot = first + (int64_t)threadIdx.x * gridDim.x;
      Segment w = {0, 0, 0, 0};
      int cs = 0, nseg = 0;
      bool live = false;
      if (slot < slots) {
        const int qd = (int)(slot % quads), seg = (int)(slot / quads);
        const int nc = n_chunks[qd / Q];
        nseg = segments_of(nc);
        live = seg < nseg;
        if (live) {
          const int k0 = min(nc, seg * chunks_per_segment(nc));
          w = {qd, seg, k0, min(nc, k0 + chunks_per_segment(nc))};
          cs = chunk_starts[qd / Q];
        }
      }
      const unsigned below = __ballot_sync(kFullMask, live) & ((1u << lane) - 1u);
      if (lane == 31) s_count[warp] = __popc(below) + live;
      __syncthreads();
      int rank = __popc(below);
      for (int v = 0; v < warp; ++v) rank += s_count[v];
      if (live) {
        s_work[rank] = w;
        s_cs[rank] = cs;
        s_nseg[rank] = nseg;
      }
      if (threadIdx.x == 0) {
        int n = 0;
        for (int v = 0; v < kThreads / 32; ++v) n += s_count[v];
        s_n = n;
      }
    }
    __syncthreads();
    const int n = s_n;

    if (loader) {
      const int j = next_with_chunks(s_work, -1, n);
      if (j < n)
        load_slot(next, feat, k_total, (int64_t)(s_cs[j] + s_work[j].k0) * chunk + threadIdx.x);
    }
    for (int i = 0; i < n; ++i) {
      const Segment w = s_work[i];
      const int t = w.qd / Q, q = w.qd % Q;
      const int ty = t / grid_x;
      const int tx = t - ty * grid_x;
      // The warp's 8x4 patch inside the quadrant, and this lane's pixel in it.
      const int lx0 = (q & 1) * kQuad + (warp & 1) * 8;
      const int ly0 = (q >> 1) * kQuad + (warp >> 1) * 4;
      const int lx = lx0 + (lane & 7), ly = ly0 + (lane >> 3);
      const float px = (float)(tx * tile + lx), py = (float)(ty * tile + ly);
      PatchBox box;
      box.x0 = (float)(tx * tile + lx0);
      box.x1 = box.x0 + 7.0f;
      box.y0 = (float)(ty * tile + ly0);
      box.y1 = box.y0 + 3.0f;

      float zbest = kBig, idbest = 0.0f;
      for (int k = w.k0; k < w.k1; ++k) {
        StagedChunk& st = s_st[buf];
        buf ^= 1;
        if (loader) {
          stage_slot(st, threadIdx.x, next);
          // The next chunk of the table: this segment's, or the first of
          // the next segment that has one.
          if (k + 1 < w.k1) {
            load_slot(next, feat, k_total, (int64_t)(s_cs[i] + k + 1) * chunk + threadIdx.x);
          } else {
            const int j = next_with_chunks(s_work, i, n);
            if (j < n)
              load_slot(next, feat, k_total, (int64_t)(s_cs[j] + s_work[j].k0) * chunk + threadIdx.x);
          }
        }
        // The chunk's one barrier: st is staged, and the buffer the next
        // chunk stages was last read a chunk earlier.
        __syncthreads();

        float zc = kBig, idc = 0.0f;
        bool nan_z = false;
        for (int base = 0; base < chunk; base += 32) {
          const int mine = base + lane;
          unsigned todo = __ballot_sync(kFullMask, mine < chunk && may_cover(st, mine, box));
          while (todo != 0) {
            const int g = base + __ffs(todo) - 1;
            todo &= todo - 1;
            const float4 v01 = st.v01[g], v2e0 = st.v2e0[g], e12 = st.e12[g];
            const float2 ida = st.ida[g];
            const float e0 = v2e0.z * (py - v01.w) - v2e0.w * (px - v01.z);
            const float e1 = e12.x * (py - v2e0.y) - e12.y * (px - v2e0.x);
            const float e2 = e12.z * (py - v01.y) - e12.w * (px - v01.x);
            const bool inside = ida.y > 0.0f ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                                             : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
            if (!inside) continue;
            const float4 zi = st.zi[g];
            const float z = (e0 * zi.w) * zi.x + (e1 * zi.w) * zi.y + (e2 * zi.w) * zi.z;
            nan_z = nan_z || z != z;
            if (z < zc || (z == zc && ida.x > idc)) {
              zc = z;
              idc = ida.x;
            }
          }
        }
        if (!nan_z && idc > 0.0f && zc < zbest) {
          zbest = zc;
          idbest = idc;
        }
      }

      const int64_t o = (int64_t)t * tile * tile + ly * tile + lx;
      const int nseg = s_nseg[i];
      if (nseg == 1) {
        out_id[o] = (int)idbest;
        out_z[o] = idbest > 0.0f ? zbest : 0.0f;
        continue;
      }
      float2* seg_part = part + (int64_t)w.qd * kMaxSegments * kThreads;
      seg_part[w.seg * kThreads + threadIdx.x] = make_float2(zbest, idbest);
      __threadfence();   // the winners are visible before the count
      __syncthreads();
      if (threadIdx.x == 0) s_last = atomicAdd(&done[w.qd], 1) == nseg - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        float zb = kBig, ib = 0.0f;
        for (int r = 0; r < nseg; ++r) {
          const float2 v = __ldcg(&seg_part[r * kThreads + threadIdx.x]);
          if (v.y > 0.0f && v.x < zb) {
            zb = v.x;
            ib = v.y;
          }
        }
        out_id[o] = (int)ib;
        out_z[o] = ib > 0.0f ? zb : 0.0f;
      }
    }
    // The table is read to its end before the next 256 slots overwrite it.
    __syncthreads();
  }
}

template <int Q>
cudaError_t launch(const float* feat, int64_t k_total, const int* chunk_starts,
                   const int* n_chunks, int* out_id, float* out_z, float2* part, int* done,
                   int num_tiles, int grid_x, int chunk, cudaStream_t stream,
                   int* blocks_launched) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)num_tiles * Q * kMaxSegments;
  if (slots > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  const int blocks = (int)std::min<long long>(slots, (long long)sms * kBlocksPerSm);
  ztest_kernel<Q><<<blocks, kThreads, 0, stream>>>(feat, k_total, chunk_starts, n_chunks, out_id,
                                                   out_z, part, done, num_tiles, grid_x, chunk);
  err = cudaGetLastError();
  if (err == cudaSuccess) *blocks_launched = blocks;
  return err;
}

}  // namespace

// Returns the CUDA error of the launch (0: launched) and, where it
// launched, the grid it gave the launch in *blocks_launched. `part` holds
// num_tiles * (tile / 16)^2 * ztest_max_segments() * 256 float2 and needs
// no set value; `done` holds num_tiles * (tile / 16)^2 ints, all 0.
extern "C" int ztest(const float* feat, long long k_total, const int* chunk_starts,
                     const int* n_chunks, int* out_id, float* out_z, void* part, int* done,
                     int num_tiles, int grid_x, int chunk, int tile, void* stream,
                     int* blocks_launched) {
  if (chunk <= 0 || chunk > kMaxChunk || num_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  if (tile == kQuad)
    return (int)launch<1>(feat, k_total, chunk_starts, n_chunks, out_id, out_z, p, done,
                          num_tiles, grid_x, chunk, s, blocks_launched);
  if (tile == 2 * kQuad)
    return (int)launch<4>(feat, k_total, chunk_starts, n_chunks, out_id, out_z, p, done,
                          num_tiles, grid_x, chunk, s, blocks_launched);
  return (int)cudaErrorInvalidValue;
}

// Segments a quadrant's list is cut into at most: the size of `part`.
extern "C" int ztest_max_segments() { return kMaxSegments; }
