// The transe backward (kernel K3 of the port), by hand for Hopper.
//
// K3 replaces rspmm_gather1 in mode none as rspmm_bwd_pallas's transe branch
// calls it (ultra_torchdrug_tpu/ops/rspmm_pallas.py:2807-2834: dx over the
// reverse layout with gather1, dr over the relation layout with gather2),
// the backward of out[v] = sum of w[eid_e] * (rel[r] + x[s]):
//
//     dx[s, :] = sum over e = (s -> v, r) of  g[v, :] * w[eid_e]
//     dr[r, :] = sum over e with type r   of  g[v_e, :] * w[eid_e]
//
// It reads neither x nor rel: it is a weighted SpMM twice, dx = A^T g and
// dr = T g with T[r, v] the summed weights of the type-r edges into v.
// Shapes: g, dx [V, F]; dr [R, F]; w [E] in original edge order; fp32 in
// and out. Rows of dx and dr without edges come back 0.
//
// What bounds it on an H100: the compulsory traffic is one read of g and the
// edges and one write of dx and dr; at the classic NBFNet training shape
// (V = 14,541, E = 496,188, R = 474, F = 64 x 32 = 2,048) that is about
// 250 MB, 0.075 ms at 3.35 TB/s, against 3.0 GFLOP, 0.045 ms at 67 TFLOP/s:
// bytes-bound. Each half gathers one g row per edge, E * F * 4 = 4.1 GB, so
// what a design can reach is set by where those gathers are served (the
// 50 MB L2 or the 3.35 TB/s memory) and by how many are in flight.
//
// The first design ran the forward's row loop: one CTA per source row
// and 256-thread feature tile, every edge loading col, then eid, then w[eid]
// before its gather, and relation chunks of up to 256 edges in original
// order, whose g rows lay anywhere in g. It took 1.51 ms against 1.17 ms for
// two torch.sparse.mm calls, and 25.5 ms on bench.py's heavy-tailed KG,
// where one source row of 10^5 edges walks serially (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
//
// What this design does about it (the layouts are data/graph.py's Csr
// fields src_seg_* / src_long_* and tile_*):
//  * metadata staged: a CTA first loads its segment's or chunk's (row,
//    w[eid]) pairs into shared memory with one coalesced pass, so the
//    gathers wait on no global metadata load; the edge loop issues
//    kInFlight independent 16-byte row gathers per thread before it
//    accumulates them, in edge order;
//  * feature tiles of kThreads threads (16 bytes each), one CTA per
//    (segment or chunk, tile), the grid tile-major: a tile's pass over the
//    rows touches V * kThreads * 16 bytes of g, which the L2 holds;
//  * dx pass, hub-aware: a source row of at most 256 edges is one segment,
//    written straight to its dx row (rows without edges write 0); a longer
//    row is cut into 256-edge segments whose partial rows a second kernel
//    sums in segment order;
//  * dr pass, local in the destination: chunks of at most 256 edges of one
//    relation whose destinations fall in one tile of 2,048 rows, sorted by
//    destination and launched tile-major, so the chunks that run at once
//    gather from one 16 MB tile of g; each chunk writes one partial row,
//    and relation_sums (rspmm_rows.cuh) adds each relation's partials in
//    tile order.
// Deterministic: no atomics, every sum in a fixed order, so two calls give
// bitwise-equal dx and dr. One call makes up to four launches: the dx
// segments, the long rows' sums, the dr chunks, the relation sums (a half
// whose output pointer is null is skipped).
//
// Measured on NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 1.01 ms at the
// training shape (dx 0.54, dr 0.48) against 1.17 ms for torch.sparse.mm
// (dx 0.64, dr 0.53), and 0.78 ms on bench.py's KG, as the library. Each
// half gathers at about 8 TB/s, from the L2; 128- and 256-thread tiles took
// 1.03 and 1.21 ms. ptxas keeps about 3 of the kInFlight gathers in flight
// per thread; a double-buffered loop that kept 8 (checked in its SASS) was
// no faster, so the L2, not the latency, bounds the gathers here.

#include "rspmm_rows.cuh"

namespace {

using rspmm::aligned16;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::long_row_sums;
using rspmm::relation_sums;
using rspmm::store_lanes;

// threads per feature tile: 64 (1 KB of a row at 16 bytes a thread) timed
// fastest against 128 and 256 on the H100 (PERF.md)
constexpr int kThreads = 64;
constexpr int kStage = 256;   // edges staged at a time (the layouts' length)
constexpr int kInFlight = 8;  // independent row gathers per thread

// acc += g[rows[k], lanes] * w[k] for k in [0, len), in order
template <int W>
__device__ __forceinline__ void gather_staged(float (&acc)[W],
                                              const float* __restrict__ g,
                                              int64_t width, const int* rows,
                                              const float* w, int len) {
  int k = 0;
  for (; k + kInFlight <= len; k += kInFlight) {
    Lanes<W> v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      v[u] = load_lanes<W>(g + rows[k + u] * width);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const float wu = w[k + u];
#pragma unroll
      for (int l = 0; l < W; ++l) acc[l] += v[u].v[l] * wu;
    }
  }
  for (; k < len; ++k) {
    const Lanes<W> v = load_lanes<W>(g + rows[k] * width);
    const float wk = w[k];
#pragma unroll
    for (int l = 0; l < W; ++l) acc[l] += v.v[l] * wk;
  }
}

// out row of item c = sum over e in [ptr[c], ptr[c+1]) of
//                     g[row[e], :] * w[eid[e]]
// written to out[dest[c]] when dest[c] >= 0, else to partial[~dest[c]];
// each thread owns W lanes, n is the row width in groups of W lanes
template <int W>
__global__ void __launch_bounds__(kThreads)
staged_sums(const int* __restrict__ ptr, const int* __restrict__ dest,
            const int* __restrict__ row, const int* __restrict__ eid,
            const float* __restrict__ weight, const float* __restrict__ g,
            float* __restrict__ out, float* __restrict__ partial, int n) {
  __shared__ int s_row[kStage];
  __shared__ float s_w[kStage];
  const int c = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(ptr + c);
  const int end = __ldg(ptr + c + 1);
  float acc[W] = {};
  for (int base = begin; base < end; base += kStage) {
    const int len = min(kStage, end - base);
    if (base != begin) __syncthreads();  // the last stage has been read
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_row[i] = __ldg(row + base + i);
      s_w[i] = __ldg(weight + __ldg(eid + base + i));
    }
    __syncthreads();
    if (j < n) gather_staged<W>(acc, g + lane, width, s_row, s_w, len);
  }
  if (j >= n) return;
  const int d = __ldg(dest + c);
  float* o = d >= 0 ? out + static_cast<int64_t>(d) * width
                    : partial + static_cast<int64_t>(~d) * width;
  store_lanes<W>(o + lane, acc);
}

// threads per CTA and feature tiles for a row of n groups of lanes
void tiles_of(int n, int* threads, int* tiles) {
  *threads = n >= kThreads ? kThreads : ((n + 31) / 32) * 32;
  *tiles = (n + *threads - 1) / *threads;
}

// staged_sums over num_items items (16-byte lanes when vec)
void launch_staged(bool vec, const int* ptr, const int* dest, const int* row,
                   const int* eid, const float* weight, const float* g,
                   float* out, float* partial, int num_items,
                   int num_features, cudaStream_t stream) {
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  tiles_of(n, &threads, &tiles);
  const dim3 grid(num_items, tiles);
  if (vec) {
    staged_sums<4><<<grid, threads, 0, stream>>>(ptr, dest, row, eid, weight,
                                                 g, out, partial, n);
  } else {
    staged_sums<1><<<grid, threads, 0, stream>>>(ptr, dest, row, eid, weight,
                                                 g, out, partial, n);
  }
}

}  // namespace

// K3. The dx pass reads the source-sorted edges (seg_dst = Csr.src_dst,
// seg_eid = src_eid) cut at seg_ptr, with seg_out, long_rows and long_ptr
// (Csr.src_seg_* and src_long_*); dx_partial holds one row of F floats per
// segment of a long row (long_ptr[num_long_rows] rows). The dr pass reads
// the (destination tile, relation) chunks (Csr.tile_*); dr_partial holds one
// row per chunk. dx == nullptr skips the dx pass, dr == nullptr the dr pass.
// Returns the first nonzero cudaGetLastError() code after a launch (0 on
// success).
extern "C" int rspmm_transe_bwd(
    const int* seg_ptr, const int* seg_out, const int* seg_dst,
    const int* seg_eid, const int* long_rows, const int* long_ptr,
    const int* chunk_ptr, const int* chunk_slot, const int* chunk_dst,
    const int* chunk_eid, const int* rel_ptr, const float* weight,
    const float* g, float* dx, float* dr, float* dx_partial,
    float* dr_partial, int num_segments, int num_long_rows, int num_chunks,
    int num_relations, int num_features, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec =
      num_features % 4 == 0 && aligned16(g) &&
      (dx == nullptr || (aligned16(dx) && aligned16(dx_partial))) &&
      (dr == nullptr || (aligned16(dr) && aligned16(dr_partial)));
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  tiles_of(n, &threads, &tiles);
  if (dx != nullptr && num_segments > 0) {
    launch_staged(vec, seg_ptr, seg_out, seg_dst, seg_eid, weight, g, dx,
                  dx_partial, num_segments, num_features, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (num_long_rows > 0) {
      const dim3 grid(num_long_rows, tiles);
      if (vec) {
        long_row_sums<float4><<<grid, threads, 0, s>>>(
            long_rows, long_ptr, reinterpret_cast<const float4*>(dx_partial),
            reinterpret_cast<float4*>(dx), n);
      } else {
        long_row_sums<float><<<grid, threads, 0, s>>>(long_rows, long_ptr,
                                                      dx_partial, dx, n);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (dr != nullptr && num_relations > 0) {
    if (num_chunks > 0) {
      launch_staged(vec, chunk_ptr, chunk_slot, chunk_dst, chunk_eid, weight,
                    g, dr_partial, nullptr, num_chunks, num_features, s);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(num_relations, tiles);
    if (vec) {
      relation_sums<float4><<<grid, threads, 0, s>>>(
          rel_ptr, reinterpret_cast<const float4*>(dr_partial),
          reinterpret_cast<float4*>(dr), n);
    } else {
      relation_sums<float><<<grid, threads, 0, s>>>(rel_ptr, dr_partial, dr,
                                                    n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
