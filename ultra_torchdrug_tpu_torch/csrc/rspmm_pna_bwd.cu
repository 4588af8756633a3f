// Gated and factored rspmm backward for the aggregations beyond the sum:
// kernels K6b and K7b (the fused PNA pairs) and K5 (the single extremum).
//
// Replaces the TPU kernel ultra_torchdrug_tpu/ops/rspmm_pallas.py::
// rspmm_bwd_minmax_blk in kind argext_pair (K6b, reached through
// rspmm_bwd_pallas_maxmin, the backward of K6), kind moments (K7b, reached
// through rspmm_bwd_pallas_addsq, the backward of K7) and kind argext (K5b),
// and rspmm_bwd_minmax (K5), the same single-extremum function on the
// per-edge layouts; rspmm_bwd_pallas_minmax picks one of those two by the
// TPU layout, which the card has no use for, so kind argext here serves
// both ids. Each edge e = (s -> v, r) with weight w = w[eid_e] gets a
// coefficient c per lane,
//
//   argext_pair:  m = (rel[r] * x[s]) * w   (or (rel[r] + x[s]) * w, add_rel)
//                 c = [m == mx[v]] * g_mx[v] * w + [m == mn[v]] * g_mn[v] * w
//   argext:       m as above,  c = [m == out[v]] * g[v] * w
//   moments:      m = rel[r] * x[s]
//                 c = g_s[v] * w + (2 m) * (g_sq[v] * w)
//
// and the gradients are
//
//     dx[s, :] = sum over e = (s -> v, r) of  rel[r, :] * c   (c for add_rel)
//     dr[r, :] = sum over e with type r   of  x[s, :] * c     (c for add_rel)
//
// The argext kinds recompute the forward's message (K6's, K4's) in the
// same order and gate on bitwise equality, so every edge whose message ties
// with the extremum gets the full gradient (the convention of the TPU
// kernels, which the JAX package documents at ops/rspmm.py:195-198). Edges
// of weight 0 get c = 0. The saved extremum is the forward's output after
// the empty-row masking; a row without edges has no edge to gate.
//
// Shapes: x, the planes (g_mx, mx, g_mn, mn; g, out; or g_s, g_sq), dx
// [V, F]; rel, dr [R, F]; w [E] in original edge order; fp32 in and out.
// Rows of dx and dr without edges come back 0.
//
// What bounds it on an H100: the compulsory traffic is one read of x, the
// planes, rel and the edge arrays and one write of dx and dr; the least work
// is 10 (argext_pair), 8 (argext) or 8 (moments, with w factored out: c =
// w * (g_s + m * (2 g_sq)), 2 g_sq formed once per node) flops per edge and
// feature. At the classic NBFNet training shape (V = 14,541, E = 496,188,
// R = 474, F = 64 queries x 32 = 2048) argext_pair moves about 730 MB,
// 0.22 ms at 3.35 TB/s, against 10.2 GFLOP (0.152 ms at 67 TFLOP/s fp32);
// argext and moments move about 492 MB (0.147 ms) against 8.1 GFLOP
// (0.121 ms): all are bytes-bound. This design gathers the planes and rel
// once per edge for dx and x and the planes once per edge for dr (9, 6 or 5
// row gathers per edge, 37, 24 or 20 GB at that shape), so the gathers are
// its real limit.
//
// What the design does about it, and what keeps it deterministic (two calls
// on the same inputs give bitwise-equal dx and dr; no float atomics), the
// two passes of K2 (rspmm_bwd.cu):
//  * dx pass over the source-sorted CSR: one CTA per source row and feature
//    tile keeps x[s] in registers, loops over the row's out-edges gathering
//    rel and the planes at the destination, and writes dx[s] once;
//  * dr pass over the relation-sorted chunks of at most 256 edges: one CTA
//    per (chunk, feature tile) keeps its relation's row in registers and
//    writes one partial row; then K2's per-relation sums run in chunk order.
// One call makes up to three device launches (a half whose output pointer is
// null is skipped).

#include <type_traits>

#include "rspmm_rows.cuh"

namespace {

using rspmm::kAddRel;
using rspmm::kMaxThreads;
using rspmm::kMulRel;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::message;
using rspmm::relation_sums;
using rspmm::store_lanes;

constexpr int kArgextPair = 0;  // K6b: planes g_mx, mx, g_mn, mn
constexpr int kMoments = 1;     // K7b: planes g_s, g_sq
constexpr int kArgext = 2;      // K5: planes g, out

// the planes of one destination row, W lanes each
template <int KIND, int W>
struct Planes {
  Lanes<W> p0, p1, p2, p3;

  __device__ __forceinline__ Planes(const float* q0, const float* q1,
                                    const float* q2, const float* q3,
                                    int64_t off) {
    p0 = load_lanes<W>(q0 + off);
    p1 = load_lanes<W>(q1 + off);
    if constexpr (KIND == kArgextPair) {
      p2 = load_lanes<W>(q2 + off);
      p3 = load_lanes<W>(q3 + off);
    }
  }
};

// the coefficient c of one edge in lane k (see the header comment)
template <int KIND, int MODE, int W>
__device__ __forceinline__ float coefficient(float r, float xv, float w,
                                             const Planes<KIND, W>& q, int k) {
  if constexpr (KIND == kArgextPair) {
    const float m = message<MODE>(r, xv) * w;  // K6's message, bit for bit
    const float c_mx = m == q.p1.v[k] ? q.p0.v[k] * w : 0.f;
    const float c_mn = m == q.p3.v[k] ? q.p2.v[k] * w : 0.f;
    return c_mx + c_mn;
  } else if constexpr (KIND == kArgext) {
    const float m = message<MODE>(r, xv) * w;  // K4's message, bit for bit
    return m == q.p1.v[k] ? q.p0.v[k] * w : 0.f;
  } else {
    const float m = r * xv;
    return q.p0.v[k] * w + (2.f * m) * (q.p1.v[k] * w);
  }
}

// dx[s] = sum over the out-edges of s of rel[r] * c (c for add_rel)
template <int KIND, int MODE, int W>
__global__ void __launch_bounds__(kMaxThreads)
dx_rows(const int* __restrict__ src_rowptr, const int* __restrict__ src_dst,
        const int* __restrict__ src_etype, const int* __restrict__ src_eid,
        const float* __restrict__ weight, const float* __restrict__ rel,
        const float* __restrict__ x, const float* __restrict__ q0,
        const float* __restrict__ q1, const float* __restrict__ q2,
        const float* __restrict__ q3, float* __restrict__ dx, int n) {
  const int s = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(src_rowptr + s);
  const int end = __ldg(src_rowptr + s + 1);
  const Lanes<W> xv = load_lanes<W>(x + s * width + lane);
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
#pragma unroll 2
  for (int e = begin; e < end; ++e) {
    const int64_t d = __ldg(src_dst + e);
    const int64_t r = __ldg(src_etype + e);
    const float w = __ldg(weight + __ldg(src_eid + e));
    const Lanes<W> rv = load_lanes<W>(rel + r * width + lane);
    const Planes<KIND, W> q(q0, q1, q2, q3, d * width + lane);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float c = coefficient<KIND, MODE, W>(rv.v[k], xv.v[k], w, q, k);
      acc[k] += MODE == kMulRel ? rv.v[k] * c : c;
    }
  }
  store_lanes<W>(dx + s * width + lane, acc);
}

// partial[c] = sum over the edges of chunk c (one relation) of x[s] * c
// (c for add_rel)
template <int KIND, int MODE, int W>
__global__ void __launch_bounds__(kMaxThreads)
dr_chunks(const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_rel,
          const int* __restrict__ rel_src, const int* __restrict__ rel_dst,
          const int* __restrict__ rel_eid, const float* __restrict__ weight,
          const float* __restrict__ rel, const float* __restrict__ x,
          const float* __restrict__ q0, const float* __restrict__ q1,
          const float* __restrict__ q2, const float* __restrict__ q3,
          float* __restrict__ partial, int n) {
  const int chunk = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(chunk_ptr + chunk);
  const int end = __ldg(chunk_ptr + chunk + 1);
  const int64_t r = __ldg(chunk_rel + chunk);
  const Lanes<W> rv = load_lanes<W>(rel + r * width + lane);
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
#pragma unroll 2
  for (int e = begin; e < end; ++e) {
    const int64_t s = __ldg(rel_src + e);
    const int64_t d = __ldg(rel_dst + e);
    const float w = __ldg(weight + __ldg(rel_eid + e));
    const Lanes<W> xv = load_lanes<W>(x + s * width + lane);
    const Planes<KIND, W> q(q0, q1, q2, q3, d * width + lane);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float c = coefficient<KIND, MODE, W>(rv.v[k], xv.v[k], w, q, k);
      acc[k] += MODE == kMulRel ? xv.v[k] * c : c;
    }
  }
  store_lanes<W>(partial + chunk * width + lane, acc);
}

struct Args {
  const int *src_rowptr, *src_dst, *src_etype, *src_eid;
  const int *chunk_ptr, *chunk_rel, *rel_chunk_ptr, *rel_src, *rel_dst,
      *rel_eid;
  const float *weight, *rel, *x, *q0, *q1, *q2, *q3;
  float *dx, *dr, *partial;
  int num_rows, num_relations, num_chunks, num_features;
};

template <int KIND, int MODE, int W>
int launch(const Args& a, cudaStream_t stream) {
  const int n = a.num_features / W;
  int threads, tiles;
  rspmm::feature_tiles(n, &threads, &tiles);
  if (a.dx != nullptr && a.num_rows > 0) {
    dx_rows<KIND, MODE, W><<<dim3(a.num_rows, tiles), threads, 0, stream>>>(
        a.src_rowptr, a.src_dst, a.src_etype, a.src_eid, a.weight, a.rel, a.x,
        a.q0, a.q1, a.q2, a.q3, a.dx, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.dr == nullptr || a.num_relations <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (a.num_chunks > 0) {
    dr_chunks<KIND, MODE, W><<<dim3(a.num_chunks, tiles), threads, 0,
                               stream>>>(
        a.chunk_ptr, a.chunk_rel, a.rel_src, a.rel_dst, a.rel_eid, a.weight,
        a.rel, a.x, a.q0, a.q1, a.q2, a.q3, a.partial, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using T = typename std::conditional<W == 4, float4, float>::type;
  relation_sums<T><<<dim3(a.num_relations, tiles), threads, 0, stream>>>(
      a.rel_chunk_ptr, reinterpret_cast<const T*>(a.partial),
      reinterpret_cast<T*>(a.dr), n);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int MODE>
int launch_width(bool vec, const Args& a, cudaStream_t stream) {
  return vec ? launch<KIND, MODE, 4>(a, stream)
             : launch<KIND, MODE, 1>(a, stream);
}

}  // namespace

// kind: 0 = argext_pair (K6b; planes q0..q3 = g_mx, mx, g_mn, mn), 1 =
// moments (K7b; q0, q1 = g_s, g_sq; q2, q3 unused), 2 = argext (K5; q0, q1
// = g, out; q2, q3 unused). mode: 0 = mul_rel, 1 = add_rel (all kinds but
// K7b). The source-sorted CSR drives the dx pass; the relation-sorted edges
// cut at chunk_ptr (chunk_rel: each chunk's relation; rel_chunk_ptr: each
// relation's chunks) drive the dr pass, whose partial holds num_chunks rows
// of F floats. dx == nullptr skips the dx pass, dr == nullptr the dr pass.
// Returns the first nonzero cudaGetLastError() code after a launch (0 on
// success); an unknown kind or mode, or K7b with add_rel, returns
// cudaErrorInvalidValue without launching.
extern "C" int rspmm_pna_bwd(
    int kind, int mode, const int* src_rowptr, const int* src_dst,
    const int* src_etype, const int* src_eid, const int* chunk_ptr,
    const int* chunk_rel, const int* rel_chunk_ptr, const int* rel_src,
    const int* rel_dst, const int* rel_eid, const float* weight,
    const float* rel, const float* x, const float* q0, const float* q1,
    const float* q2, const float* q3, float* dx, float* dr, float* partial,
    int num_rows, int num_relations, int num_chunks, int num_features,
    void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool both_modes = mode == kMulRel || mode == kAddRel;
  const bool known = (kind == kMoments && mode == kMulRel) ||
                     ((kind == kArgextPair || kind == kArgext) && both_modes);
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{src_rowptr, src_dst,   src_etype, src_eid,  chunk_ptr,
               chunk_rel,  rel_chunk_ptr, rel_src, rel_dst, rel_eid,
               weight,     rel,       x,         q0,       q1,
               q2,         q3,        dx,        dr,       partial,
               num_rows,   num_relations, num_chunks, num_features};
  const bool vec =
      num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
      aligned16(q0) && aligned16(q1) &&
      (kind != kArgextPair || (aligned16(q2) && aligned16(q3))) &&
      (dx == nullptr || aligned16(dx)) &&
      (dr == nullptr || (aligned16(dr) && aligned16(partial)));
  const bool mul = mode == kMulRel;
  if (kind == kMoments) return launch_width<kMoments, kMulRel>(vec, a, s);
  if (kind == kArgext) {
    return mul ? launch_width<kArgext, kMulRel>(vec, a, s)
               : launch_width<kArgext, kAddRel>(vec, a, s);
  }
  return mul ? launch_width<kArgextPair, kMulRel>(vec, a, s)
             : launch_width<kArgextPair, kAddRel>(vec, a, s);
}
