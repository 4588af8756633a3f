// Relational SpMM backward, sum aggregation (kernels K2 and K2h of the
// port; K3, the transe backward, has its own passes in
// rspmm_transe_bwd.cu).
//
// K2 replaces the TPU kernel ultra_torchdrug_tpu/ops/rspmm_pallas.py::
// rspmm_bwd_fused in mode mul (reached through rspmm_bwd_pallas), the
// backward of out[v] = sum over e = (s -> v, r) of w[eid_e] * rel[r] * x[s]:
//
//     dx[s, :] = sum over e = (s -> v, r) of  w[eid_e] * rel[r, :] * g[v, :]
//     dr[r, :] = sum over e with type r   of  w[eid_e] * x[s_e, :] * g[v_e, :]
//
// K2h is the same function with compute_dtype=bfloat16 (rspmm_bwd_fused
// with bf16 operands, :2117-2153): x, g and rel arrive as bf16, the products
// are taken in fp32 from the widened values with g * w formed first, and dx
// and dr are fp32. It runs K2's two passes with bf16 row loads (8 lanes per
// 16-byte load), which halves the gathered bytes.
//
// Shapes: x, g, dx [V, F]; rel, dr [R, F]; w [E] in original edge order;
// fp32 in and out (K2h: bf16 x, g and rel). Rows of dx and dr without edges
// come back 0.
//
// What bounds them on an H100: the compulsory traffic is one read of the
// dense inputs (x, g, rel) and the edge arrays and one write of dx and dr;
// the work is 6 flops per edge and feature; K2h reads half the operand
// bytes, so half the gather traffic. At the ULTRA training shape (V =
// 14,541, E = 496,188, R = 474, F = 64 queries x 64 = 4096) K2 moves about
// 738 MB, 0.220 ms at 3.35 TB/s, against 12.2 GFLOP, 0.182 ms at 67 TFLOP/s
// fp32: bytes-bound at about 0.22 ms. A design gathers a g row per edge for
// dx and an x and a g row per edge for dr (3 * E * F * 4 bytes, about 24 GB
// at that shape, with the rel rows of dx 32 GB), so where those gathers are
// served (the 50 MB L2 or the memory) sets what it reaches.
//
// K2's first design (PRs 2-9, still K2h's) ran the forward's row loop over
// the source rows (one CTA per row and 256-thread feature tile, a rel and a
// g row gathered per edge) and relation chunks of up to 256 edges in
// original order, whose x and g rows lay anywhere, in 256-thread tiles whose
// two 59.6 MB passes the L2 cannot hold together. It took 6.29 ms at the
// training shape (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What K2's design does about it (rspmm_staged.cuh; the layouts
// data/graph.py's Csr.src_seg_* / src_long_* and tile_*):
//  * dx pass: K1's staged row kernel with g in place of x over the source
//    rows' 256-edge segments (long rows through partial rows summed in
//    segment order), the rel slice in shared memory, so each edge gathers
//    one g row;
//  * dr pass: (destination tile, relation) chunks of at most 256 edges,
//    one warp each, a partial row per chunk in relation-major slots, then
//    relation_sums (rspmm_rows.cuh) adds each relation's partials in slot
//    order; each edge gathers an x and a g row of one narrow slice;
//  * both passes read each edge's weight from a copy gathered once per call
//    in their own order, and run slice-major in narrow slices, so the
//    gathered slices of g (and x) in flight stay in the L2.
// Deterministic: every sum is one warp's in a fixed order, then partials in
// a fixed order; no float atomics, so two calls give bitwise-equal dx and
// dr. One call makes up to six launches: the weights of each pass, the dx
// segments, the long rows' sums, the dr chunks, the relation sums (a half
// whose output pointer is null is skipped). One fused pass, in which a
// source row's x stays in registers and each g gather feeds both dx and
// dr, needs a reduction of dr across CTAs in a fixed order; it is not
// built.
//
// K2h keeps the first design, whose two kernels follow; its redesign onto
// this one is later work.

#include "rspmm_staged.cuh"

namespace {

using rspmm::accumulate;
using rspmm::bf16;
using rspmm::kMaxThreads;
using rspmm::kMulRel;
using rspmm::kMulScaled;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::relation_sums;
using rspmm::store_lanes;

// partial[c, :] = sum over e in [chunk_ptr[c], chunk_ptr[c+1]) of
//                 w[eid[e]] * x[src[e], :] * g[dst[e], :]   (kMulRel)
//                 x[src[e], :] * (g[dst[e], :] * w[eid[e]])  (kMulScaled)
// each thread owning W lanes; n is the row width in groups of W lanes
template <int MODE, typename In, int W>
__global__ void __launch_bounds__(kMaxThreads)
chunk_partials(const int* __restrict__ chunk_ptr, const int* __restrict__ src,
               const int* __restrict__ dst, const int* __restrict__ eid,
               const float* __restrict__ weight, const In* __restrict__ x,
               const In* __restrict__ g, float* __restrict__ partial, int n) {
  const int c = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(chunk_ptr + c);
  const int end = __ldg(chunk_ptr + c + 1);
  float acc[W] = {};
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t d = __ldg(dst + e);
    const float w = __ldg(weight + __ldg(eid + e));
    const Lanes<W> gv = load_lanes<W>(g + d * width + lane);
    const int64_t s = __ldg(src + e);
    accumulate<MODE, In, W>(acc, load_lanes<W>(x + s * width + lane), gv, w);
  }
  store_lanes<W>(partial + static_cast<int64_t>(c) * width + lane, acc);
}

// the dr pass: chunk partials (16-byte operand loads when vec), then the
// per-relation sums of the fp32 partial rows (float4 when vec)
template <int MODE, typename In>
int launch_dr(bool vec, const int* chunk_ptr, const int* rel_chunk_ptr,
              const int* rel_src, const int* rel_dst, const int* rel_eid,
              const float* weight, const In* x, const In* g, float* dr,
              float* partial, int num_relations, int num_chunks,
              int num_features, cudaStream_t stream) {
  constexpr int kVec = rspmm::vec_lanes<In>();
  int threads, tiles;
  if (num_chunks > 0) {
    const int n = vec ? num_features / kVec : num_features;
    rspmm::feature_tiles(n, &threads, &tiles);
    const dim3 grid(num_chunks, tiles);
    if (vec) {
      chunk_partials<MODE, In, kVec><<<grid, threads, 0, stream>>>(
          chunk_ptr, rel_src, rel_dst, rel_eid, weight, x, g, partial, n);
    } else {
      chunk_partials<MODE, In, 1><<<grid, threads, 0, stream>>>(
          chunk_ptr, rel_src, rel_dst, rel_eid, weight, x, g, partial, n);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = vec ? num_features / 4 : num_features;
  rspmm::feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_relations, tiles);
  if (vec) {
    relation_sums<float4><<<grid, threads, 0, stream>>>(
        rel_chunk_ptr, reinterpret_cast<const float4*>(partial),
        reinterpret_cast<float4*>(dr), n);
  } else {
    relation_sums<float><<<grid, threads, 0, stream>>>(rel_chunk_ptr, partial,
                                                       dr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. The dx pass reads the source rows' segments (seg_ptr, seg_out,
// long_rows, long_ptr = Csr.src_seg_*, src_long_*) over the source-sorted
// edges (seg_dst, seg_etype, seg_eid = Csr.src_dst, src_etype, src_eid);
// dx_partial holds long_ptr[num_long_rows] rows of F floats. The dr pass
// reads the (destination tile, relation) chunks (chunk_ptr, chunk_slot,
// chunk_src, chunk_dst, chunk_eid, rel_ptr = Csr.tile_*); dr_partial holds
// one row of F floats per chunk. w_scratch holds 2 * num_edges floats.
// dx == nullptr skips the dx pass, dr == nullptr the dr pass. Returns the
// first nonzero cudaGetLastError() code after a launch (0 on success).
extern "C" int rspmm_bwd(
    const int* seg_ptr, const int* seg_out, const int* seg_dst,
    const int* seg_etype, const int* seg_eid, const int* long_rows,
    const int* long_ptr, const int* chunk_ptr, const int* chunk_slot,
    const int* chunk_src, const int* chunk_dst, const int* chunk_eid,
    const int* rel_ptr, const float* weight, const float* rel,
    const float* x, const float* g, float* dx, float* dr, float* w_scratch,
    float* dx_partial, float* dr_partial, int num_rows, int num_segments,
    int num_long_rows, int num_chunks, int num_relations, int num_edges,
    int num_features, void* stream) {
  using rspmm::aligned16;
  namespace staged = rspmm::staged;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec =
      num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
      aligned16(g) &&
      (dx == nullptr ||
       (aligned16(dx) && (dx_partial == nullptr || aligned16(dx_partial)))) &&
      (dr == nullptr || (aligned16(dr) && aligned16(dr_partial)));
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && num_segments > 0) {
    err = staged::launch_gather_weights(seg_eid, weight, w_scratch,
                                        num_edges, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const staged::Rows a{seg_ptr,    seg_out,      seg_dst,   seg_etype,
                         w_scratch,  rel,          g,         dx,
                         dx_partial, num_segments, num_edges, num_relations,
                         num_features};
    const staged::Plan p = staged::rows_plan<kMulRel>(
        vec, num_relations, num_features, num_rows, num_segments);
    err = staged::launch_rows<kMulRel>(vec, p, a, long_rows, long_ptr,
                                       num_long_rows, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dr != nullptr && num_relations > 0) {
    float* w_tile = w_scratch + num_edges;
    err = staged::launch_gather_weights(chunk_eid, weight, w_tile, num_edges,
                                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const staged::Chunks a{chunk_ptr, chunk_slot, chunk_src,  chunk_dst,
                           w_tile,    x,          g,          dr_partial,
                           num_chunks, num_edges, num_features};
    const staged::Plan p = staged::chunks_plan(
        vec, num_features, int64_t{2} * num_rows, num_chunks);
    err = staged::launch_chunks(vec, p, a, rel_ptr, num_relations, dr, s);
  }
  return static_cast<int>(err);
}

// How K2 lays out its passes at this shape (rspmm_staged.cuh's plans),
// written to out[0..9]: the dx pass's features a slice, 1 when its rel
// slice sits in shared memory, its bytes, slices, CTAs a slice; then the
// dr pass's five, as rspmm_k1_plan's.
extern "C" int rspmm_k2_plan(int vec, int num_relations, int num_features,
                             int num_rows, int num_segments, int num_chunks,
                             int* out) {
  namespace staged = rspmm::staged;
  const staged::Plan plans[2] = {
      staged::rows_plan<kMulRel>(vec != 0, num_relations, num_features,
                                 num_rows, num_segments),
      staged::chunks_plan(vec != 0, num_features, int64_t{2} * num_rows,
                          num_chunks)};
  for (int i = 0; i < 2; ++i) {
    out[5 * i] = plans[i].slice;
    out[5 * i + 1] = plans[i].shared_rel ? 1 : 0;
    out[5 * i + 2] = static_cast<int>(plans[i].smem);
    out[5 * i + 3] = plans[i].slices;
    out[5 * i + 4] = plans[i].ctas_per_slice;
  }
  return static_cast<int>(cudaGetLastError());
}

// K2h: K2 (mul_rel) with bf16 rel, x and g, fp32 weight, dx, dr and partial:
//     dx[s, :] = sum over e = (s -> v, r) of  rel[r, :] * (g[v, :] * w[eid_e])
//     dr[r, :] = sum over e with type r   of  x[s_e, :] * (g[v_e, :] * w[eid_e])
// the products in fp32 from the widened bf16 values, g * w formed first, as
// rspmm_pallas.py's bf16 backward does (:659-666, :798-805). The first
// design's two passes: the source-sorted CSR (src_rowptr / src_dst /
// src_etype / src_eid) drives the dx pass, the relation-sorted edges
// (rel_src / rel_dst / rel_eid) cut at chunk_ptr, with rel_chunk_ptr giving
// each relation's chunks, the dr pass; partial holds num_chunks rows of F
// floats. Two calls agree bitwise. Null outputs and return as for
// rspmm_bwd.
extern "C" int rspmm_bwd_k2h(
    const int* src_rowptr, const int* src_dst, const int* src_etype,
    const int* src_eid, const int* chunk_ptr, const int* rel_chunk_ptr,
    const int* rel_src, const int* rel_dst, const int* rel_eid,
    const float* weight, const bf16* rel, const bf16* x, const bf16* g,
    float* dx, float* dr, float* partial, int num_rows, int num_relations,
    int num_chunks, int num_features, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = num_features % rspmm::vec_lanes<bf16>() == 0 &&
                   aligned16(rel) && aligned16(x) && aligned16(g) &&
                   (dx == nullptr || aligned16(dx)) &&
                   (dr == nullptr || (aligned16(dr) && aligned16(partial)));
  if (dx != nullptr && num_rows > 0) {
    rspmm::launch_row_gather<kMulScaled, bf16>(
        vec, src_rowptr, src_dst, src_etype, src_eid, weight, rel, g, dx,
        num_rows, num_features, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dr != nullptr && num_relations > 0) {
    return launch_dr<kMulScaled, bf16>(vec, chunk_ptr, rel_chunk_ptr, rel_src,
                                       rel_dst, rel_eid, weight, x, g, dr,
                                       partial, num_relations, num_chunks,
                                       num_features, s);
  }
  return static_cast<int>(cudaGetLastError());
}
