// Row-gather aggregations beyond the sum, forward: the fused PNA pairs
// (kernels K6 and K7 of the port) and the single extremum (kernel K4).
//
// K6 replaces the TPU kernel ultra_torchdrug_tpu/ops/rspmm_pallas.py::
// rspmm_gather_maxmin (reached through rspmm_fwd_pallas_maxmin): both
// extrema of one row's messages from one pass,
//
//     m_e       = (rel[r, :] * x[s, :]) * w[eid_e]      (mul_rel, distmult)
//               = (rel[r, :] + x[s, :]) * w[eid_e]      (add_rel, transe)
//     mx[v, :]  = max over edges e = (s -> v, r) of m_e
//     mn[v, :]  = min over the same edges;  rows without edges write 0.
//
// K4 replaces rspmm_gather1 with agg max / min (reached through
// rspmm_fwd_pallas, which masks the empty rows' +-_BIG sentinel to 0): one
// of the two extrema alone, out[v, :] = max (or min) of the same m_e, rows
// without edges 0.
//
// The message is computed in exactly that order, as its own expression: the
// backward (K6b / K5, rspmm_pna_bwd.cu) recomputes it and gates the gradient
// on bitwise equality with the saved extremum. Edges of weight 0 are not
// skipped: a masked edge sends the message 0, which takes part in the max
// and the min, as in the TPU kernels (their valid flag marks padding only)
// and in the JAX package's segment_max formulation.
//
// K7 replaces rspmm_gather_addsq (reached through rspmm_fwd_pallas_addsq),
// distmult only: the first and second moments of the same messages,
//
//     m = rel[r, :] * x[s, :],  s[v, :] += m * w,  sq[v, :] += m * (m * w).
//
// Shapes: x [V, F], rel [R, F], w [E] in original edge order, outputs
// [V, F]; fp32 in and out; a destination-sorted CSR (rowptr / src / etype /
// eid, int32), the same one K1 reads.
//
// What bounds it on an H100: the compulsory traffic is one read of x, rel
// and the edge arrays and one write of the outputs; the work is 3 (K4),
// 4 (K6) or 5 (K7) flops per edge and feature. At the classic NBFNet eval
// shape (V = 14,541, E = 496,188, R = 474, F = 16 queries x 32 = 512) that
// is about 98 MB for the pairs and 68 MB for K4, 0.029 / 0.020 ms at
// 3.35 TB/s, against 0.8-1.3 GFLOP, under 0.02 ms at 67 TFLOP/s fp32:
// bytes-bound. Like K1, this design gathers one x row per edge (E * F * 4
// bytes, about 1 GB at that shape), so those gathers are its real limit.
//
// What the design does about it: K1's structure (rspmm_rows.cuh), one CTA
// per destination row and feature tile, threads across features with
// float4 accesses where aligned, with one register accumulator per lane and
// output (two for the pairs): each x row gathered feeds every output, each
// output row is written once, no atomics, and the result does not depend on
// launch order.

#include <math_constants.h>

#include "rspmm_rows.cuh"

namespace {

using rspmm::kAddRel;
using rspmm::kMaxThreads;
using rspmm::kMulRel;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::message;
using rspmm::store_lanes;

constexpr int kMaxMin = 0;  // K6
constexpr int kAddSq = 1;   // K7
constexpr int kMax = 2;     // K4, max
constexpr int kMin = 3;     // K4, min

// one CTA per (row v, feature tile); each thread owns W consecutive lanes;
// n is the row width in groups of W lanes; out1 is written by the pairs
// (K6, K7) only
template <int KIND, int MODE, int W>
__global__ void __launch_bounds__(kMaxThreads)
row_stats(const int* __restrict__ rowptr, const int* __restrict__ col,
          const int* __restrict__ etype, const int* __restrict__ eid,
          const float* __restrict__ weight, const float* __restrict__ rel,
          const float* __restrict__ x, float* __restrict__ out0,
          float* __restrict__ out1, int n) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  constexpr bool kPair = KIND == kMaxMin || KIND == kAddSq;
  float a[W], b[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    a[k] = KIND == kMaxMin || KIND == kMax ? -CUDART_INF_F
           : KIND == kMin                  ? CUDART_INF_F
                                           : 0.f;
    b[k] = KIND == kMaxMin ? CUDART_INF_F : 0.f;
  }
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t c = __ldg(col + e);
    const int64_t r = __ldg(etype + e);
    const float w = __ldg(weight + __ldg(eid + e));
    const Lanes<W> rv = load_lanes<W>(rel + r * width + lane);
    const Lanes<W> xv = load_lanes<W>(x + c * width + lane);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (KIND == kMaxMin) {
        const float m = message<MODE>(rv.v[k], xv.v[k]) * w;
        a[k] = fmaxf(a[k], m);
        b[k] = fminf(b[k], m);
      } else if constexpr (KIND == kAddSq) {
        const float m = rv.v[k] * xv.v[k];
        const float mw = m * w;
        a[k] += mw;
        b[k] += m * mw;
      } else {
        const float m = message<MODE>(rv.v[k], xv.v[k]) * w;
        a[k] = KIND == kMax ? fmaxf(a[k], m) : fminf(a[k], m);
      }
    }
  }
  if (KIND != kAddSq && begin == end) {
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] = b[k] = 0.f;
  }
  const int64_t off = static_cast<int64_t>(v) * width + lane;
  store_lanes<W>(out0 + off, a);
  if constexpr (kPair) store_lanes<W>(out1 + off, b);
}

template <int KIND, int MODE>
void launch(bool vec, const int* rowptr, const int* src, const int* etype,
            const int* eid, const float* weight, const float* rel,
            const float* x, float* out0, float* out1, int num_rows,
            int num_features, cudaStream_t stream) {
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  rspmm::feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_rows, tiles);
  if (vec) {
    row_stats<KIND, MODE, 4><<<grid, threads, 0, stream>>>(
        rowptr, src, etype, eid, weight, rel, x, out0, out1, n);
  } else {
    row_stats<KIND, MODE, 1><<<grid, threads, 0, stream>>>(
        rowptr, src, etype, eid, weight, rel, x, out0, out1, n);
  }
}

template <int KIND>
void launch_mode(bool mul, bool vec, const int* rowptr, const int* src,
                 const int* etype, const int* eid, const float* weight,
                 const float* rel, const float* x, float* out0, float* out1,
                 int num_rows, int num_features, cudaStream_t stream) {
  if (mul) {
    launch<KIND, kMulRel>(vec, rowptr, src, etype, eid, weight, rel, x, out0,
                          out1, num_rows, num_features, stream);
  } else {
    launch<KIND, kAddRel>(vec, rowptr, src, etype, eid, weight, rel, x, out0,
                          out1, num_rows, num_features, stream);
  }
}

}  // namespace

// kind: 0 = max/min pair (K6; out0 = max, out1 = min), 1 = moments (K7;
// out0 = sum, out1 = sum of squares), 2 = max (K4; out0), 3 = min (K4;
// out0; out1 is not written by kinds 2 and 3 and may be null). mode: 0 =
// mul_rel, 1 = add_rel (all kinds but K7). Returns the cudaGetLastError()
// code after the launch (0 on success); an unknown kind or mode, or K7 with
// add_rel, returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_pna_fwd(int kind, int mode, const int* rowptr,
                             const int* src, const int* etype, const int* eid,
                             const float* weight, const float* rel,
                             const float* x, float* out0, float* out1,
                             int num_rows, int num_features, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool both_modes = mode == kMulRel || mode == kAddRel;
  const bool known = (kind == kAddSq && mode == kMulRel) ||
                     ((kind == kMaxMin || kind == kMax || kind == kMin) &&
                      both_modes);
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows > 0 && num_features > 0) {
    const bool vec = num_features % 4 == 0 && aligned16(rel) &&
                     aligned16(x) && aligned16(out0) && aligned16(out1);
    const bool mul = mode == kMulRel;
    if (kind == kAddSq) {
      launch<kAddSq, kMulRel>(vec, rowptr, src, etype, eid, weight, rel, x,
                              out0, out1, num_rows, num_features, s);
    } else if (kind == kMaxMin) {
      launch_mode<kMaxMin>(mul, vec, rowptr, src, etype, eid, weight, rel, x,
                           out0, out1, num_rows, num_features, s);
    } else if (kind == kMax) {
      launch_mode<kMax>(mul, vec, rowptr, src, etype, eid, weight, rel, x,
                        out0, out1, num_rows, num_features, s);
    } else {
      launch_mode<kMin>(mul, vec, rowptr, src, etype, eid, weight, rel, x,
                        out0, out1, num_rows, num_features, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
