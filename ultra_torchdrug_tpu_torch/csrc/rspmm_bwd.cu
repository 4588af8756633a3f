// Relational SpMM backward, sum aggregation (kernels K2, K2h and K3 of the
// port).
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
// K3 replaces rspmm_gather1 in mode none as rspmm_bwd_pallas's transe branch
// calls it (rspmm_pallas.py:2807-2834: dx over the reverse layout with
// gather1, dr over the relation layout with gather2), the backward of
// out[v] = sum of w[eid_e] * (rel[r] + x[s]):
//
//     dx[s, :] = sum over e = (s -> v, r) of  g[v, :] * w[eid_e]
//     dr[r, :] = sum over e with type r   of  g[v_e, :] * w[eid_e]
//
// K3 reads neither x nor rel: it is a weighted SpMM twice, dx = A^T g and
// dr = T g with T[r, v] the summed weights of the type-r edges into v.
//
// Shapes: x, g, dx [V, F]; rel, dr [R, F]; w [E] in original edge order;
// fp32 in and out (K2h: bf16 x, g and rel). Rows of dx and dr without edges
// come back 0.
//
// What bounds them on an H100: the compulsory traffic is one read of the
// dense inputs (K2: x, g, rel; K3: g) and the edge arrays and one write of
// dx and dr; the work is 6 (K2, K2h) or 3 (K3) flops per edge and feature;
// K2h reads half the operand bytes, so half the gather traffic. At the
// ULTRA training shape (V = 14,541, E = 496,188, R = 474, F = 64 queries x
// 64 = 4096) K2 moves about 738 MB, 0.220 ms at 3.35 TB/s, against
// 12.2 GFLOP, 0.182 ms at 67 TFLOP/s fp32: bytes-bound at about 0.22 ms. At
// the classic NBFNet training shape (F = 64 x 32 = 2048) K3 moves about
// 250 MB (0.075 ms) against 3.0 GFLOP (0.045 ms): bytes-bound. This design
// gathers one g row per edge for dx and one x and one g row (K3: one g row)
// per edge for dr (3 or 2 * E * F * 4 bytes, about 24 GB for K2 and 8 GB for
// K3 at those shapes, mostly missing the 50 MB L2), so the gathers are its
// real limit.
//
// What the design does about it, and what keeps it deterministic (two calls
// on the same inputs give bitwise-equal dx and dr; no float atomics):
//  * dx pass: the forward's row gather (rspmm_rows.cuh) over the
//    source-sorted CSR, one CTA per source row and feature tile, the sum in
//    registers, each row written once (K3: message kNone, g[v] alone);
//  * dr pass, a segmented reduction in two kernels: the relation-sorted
//    edges are cut into chunks of at most 256 edges that never cross a
//    relation; one CTA per (chunk, feature tile) sums its chunk into a row of
//    a scratch buffer the caller allocates, then one CTA per (relation,
//    feature tile) sums that relation's chunk rows in chunk order.
// One call makes up to three device launches: dx pass, chunk partials,
// relation sums (a half whose output pointer is null is skipped).
// One fused pass, in which a source row's x stays in registers and each g
// gather feeds both dx and dr, is the later redesign.

#include "rspmm_rows.cuh"

namespace {

using rspmm::accumulate;
using rspmm::bf16;
using rspmm::kAddRel;
using rspmm::kMaxThreads;
using rspmm::kMulRel;
using rspmm::kMulScaled;
using rspmm::kNone;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::relation_sums;
using rspmm::store_lanes;

// partial[c, :] = sum over e in [chunk_ptr[c], chunk_ptr[c+1]) of
//                 w[eid[e]] * x[src[e], :] * g[dst[e], :]   (kMulRel)
//                 x[src[e], :] * (g[dst[e], :] * w[eid[e]])  (kMulScaled)
//                 g[dst[e], :] * w[eid[e]]                  (kNone)
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
    if constexpr (MODE == kNone) {
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] += gv.v[k] * w;
    } else {
      const int64_t s = __ldg(src + e);
      accumulate<MODE, In, W>(acc, load_lanes<W>(x + s * width + lane), gv,
                              w);
    }
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

// mode: 0 = mul_rel (K2), 1 = add_rel (K3; rel and x are not read and may
// be null). The source-sorted CSR (src_rowptr / src_dst / src_etype /
// src_eid) drives the dx pass; the relation-sorted edges (rel_src / rel_dst
// / rel_eid) cut at chunk_ptr, with rel_chunk_ptr giving each relation's
// chunks, drive the dr pass. partial holds num_chunks rows of F floats.
// dx == nullptr skips the dx pass, dr == nullptr the dr pass. Returns the
// first nonzero cudaGetLastError() code after a launch (0 on success); an
// unknown mode returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_bwd(
    int mode, const int* src_rowptr, const int* src_dst, const int* src_etype,
    const int* src_eid, const int* chunk_ptr, const int* rel_chunk_ptr,
    const int* rel_src, const int* rel_dst, const int* rel_eid,
    const float* weight, const float* rel, const float* x, const float* g,
    float* dx, float* dr, float* partial, int num_rows, int num_relations,
    int num_chunks, int num_features, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kMulRel && mode != kAddRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(g) && (dx == nullptr || aligned16(dx)) &&
                   (dr == nullptr || (aligned16(dr) && aligned16(partial)));
  if (dx != nullptr && num_rows > 0) {
    if (mode == kMulRel) {
      rspmm::launch_row_gather<kMulRel, float>(
          vec, src_rowptr, src_dst, src_etype, src_eid, weight, rel, g, dx,
          num_rows, num_features, s);
    } else {
      rspmm::launch_row_gather<kNone, float>(
          vec, src_rowptr, src_dst, src_etype, src_eid, weight, nullptr, g,
          dx, num_rows, num_features, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dr != nullptr && num_relations > 0) {
    return mode == kMulRel
               ? launch_dr<kMulRel, float>(vec, chunk_ptr, rel_chunk_ptr,
                                           rel_src, rel_dst, rel_eid, weight,
                                           x, g, dr, partial, num_relations,
                                           num_chunks, num_features, s)
               : launch_dr<kNone, float>(vec, chunk_ptr, rel_chunk_ptr,
                                         rel_src, rel_dst, rel_eid, weight,
                                         nullptr, g, dr, partial,
                                         num_relations, num_chunks,
                                         num_features, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2h: K2 (mul_rel) with bf16 rel, x and g, fp32 weight, dx, dr and partial:
//     dx[s, :] = sum over e = (s -> v, r) of  rel[r, :] * (g[v, :] * w[eid_e])
//     dr[r, :] = sum over e with type r   of  x[s_e, :] * (g[v_e, :] * w[eid_e])
// the products in fp32 from the widened bf16 values, g * w formed first, as
// rspmm_pallas.py's bf16 backward does (:659-666, :798-805); the same two
// passes and layouts as K2, so two calls agree bitwise. Arguments, null
// outputs and return as for rspmm_bwd.
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
