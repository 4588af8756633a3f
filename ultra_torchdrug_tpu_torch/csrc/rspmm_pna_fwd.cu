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
// [V, F]; fp32 in and out; a destination-sorted CSR (src / etype / eid,
// int32) and its destination rows' segments, the same ones K1 reads.
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
// K4, K6 and K7 run K1's staged, hub-aware design (rspmm_staged.cuh's
// blocks, the layouts data/graph.py's Csr.seg_* / long_*), seg_stats, one
// kernel with the kind as a template argument:
//  * over the destination rows' 256-edge segments, slice-major in 64-feature
//    slices (32 on the scalar path), one 16-thread stream a segment in
//    staged_rows' software pipeline (the next edges' metadata and the next
//    segment loaded while an iteration's gathers are in flight);
//  * the rel slice in shared memory (121 KB at R = 474), so each edge
//    gathers one x slice row; above the budget (R > 906) rel rows are
//    gathered, a choice by shape;
//  * each edge's weight gathered once a call in the segments' order
//    (gather_weights);
//  * register accumulators a lane: K4 one (the max or the min, from -inf or
//    +inf), K6 two (the max and the min), K7 two (the sum and the sum of
//    squares, in the order written above); a segment without edges (a row
//    without edges) writes 0 to each of the kind's planes;
//  * a row of more than 256 edges is cut into segments whose partial rows
//    go to one partial plane for each output, combined in segment order by
//    a second kernel: long_row_extrema for K4 (one plane) and K6 (the max of
//    the maxima, the min of the minima), rspmm_rows.cuh's long_row_sums
//    once a plane for K7;
//  * CTAs of 1,024 threads with 8 edges' x slices in flight a stream for
//    K4 and K6, of 512 threads with 16 in flight for K7 (seg_threads: K6
//    spills 18-128 bytes at 1,024 and still beat 512 by 1-2 % on the card,
//    K4, 4-16 bytes spilled, by 28 %; K7, 32-128 bytes spilled at 1,024,
//    ran 12 % faster at 512, PERF.md).
// Max and min are exact, so K4's and K6's results equal the plain
// version's but for the sign of a zero where a weight-0 edge's -0 meets a
// +0 (fmaxf may return either): the backward's gate m == out[v] treats both
// alike. K7's sums add a segment's edges in edge order, then a long row's
// segments in segment order. One call makes up to four launches: the
// weights, the segments, the long rows' combine (K7 one a plane).

#include <math_constants.h>

#include "rspmm_staged.cuh"

namespace {

using rspmm::kAddRel;
using rspmm::kMaxThreads;
using rspmm::kMulRel;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::message;
using rspmm::store_lanes;
namespace staged = rspmm::staged;

constexpr int kMaxMin = 0;  // K6
constexpr int kAddSq = 1;   // K7
constexpr int kMax = 2;     // K4, max
constexpr int kMin = 3;     // K4, min

// the planes a kind writes: K4 one, K6 and K7 two
__host__ __device__ constexpr int kind_planes(int kind) {
  return kind == kMax || kind == kMin ? 1 : 2;
}

// threads a CTA of seg_stats, by kind: 1,024 (64 registers each, 8 edges'
// x slices in flight a stream) for K4 and K6, 512 (128 registers, 16 in
// flight) for K7, each the faster on the card (PERF.md: K4 at 512 took
// 28 % longer, K6 1-2 %; K7 at 1,024 took 12 % longer)
__host__ __device__ constexpr int seg_threads(int kind) {
  return kind == kAddSq ? 512 : 1024;
}

// edges in flight a stream: kRowInFlight rows a thread at 1,024 threads (64
// registers each), twice as many at 512, over the rows an edge gathers (x,
// and rel where it is not staged)
__host__ __device__ constexpr int seg_edges_in_flight(int kind,
                                                      bool shared_rel) {
  return staged::kRowInFlight * 1024 / seg_threads(kind) /
         (shared_rel ? 1 : 2);
}

// one edge's messages into the kind's accumulators, lane by lane. An
// extremum's message is formed exactly as the backward's gates recompute
// it bit for bit (K6b, K5: message<MODE>(r, x) * w); K7's sums as
// s += m * w, sq += m * (m * w), m = r * x
template <int KIND, int MODE, int W>
__device__ __forceinline__ void stats_edge(float (&a)[W], float (&b)[W],
                                           const Lanes<W>& r,
                                           const Lanes<W>& xv, float w) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if constexpr (KIND == kAddSq) {
      const float m = r.v[k] * xv.v[k];
      const float mw = m * w;
      a[k] += mw;
      b[k] += m * mw;
    } else {
      const float m = message<MODE>(r.v[k], xv.v[k]) * w;
      a[k] = KIND == kMin ? fminf(a[k], m) : fmaxf(a[k], m);
      if constexpr (KIND == kMaxMin) b[k] = fminf(b[k], m);
    }
  }
}

struct SegStats {
  const int* seg_ptr;  // [S + 1] the destination rows' segments
  const int* seg_out;  // [S] row (>= 0) or ~partial slot
  const int* col;      // [E] each edge's source, destination order
  const int* etype;    // [E]
  const float* w;      // [E] each edge's weight, destination order
  const float* rel;    // [R, F]
  const float* x;      // [V_in, F]
  float* out0;         // [V, F] K4's extremum, K6's max, K7's sum
  float* out1;         // [V, F] K6's min, K7's sum of squares (K4: none)
  float* partial0;     // [P, F] the long rows' partial rows of out0
  float* partial1;     // [P, F] and of out1
  int num_segments;
  int num_edges;
  int num_relations;
  int num_features;
};

// out0[row of segment i, slice] (and out1 where the kind has two planes) =
// the kind's statistics of the segment's messages (a partial row's for a
// long row's segment), 0 for a segment without edges: staged_rows'
// pipeline (one stream of G threads a segment, the next iteration's edge
// metadata and the next segment loaded while an iteration's gathers are in
// flight) with the kind's accumulators.
template <int KIND, int MODE, int W, int G, bool kSharedRel>
__global__ void __launch_bounds__(seg_threads(KIND), 1)
    seg_stats(SegStats a) {
  constexpr int kThreads = seg_threads(KIND);
  constexpr int S = W * G;
  constexpr int kIn = seg_edges_in_flight(KIND, kSharedRel);
  static_assert(kIn <= G, "a stream's lanes hold an iteration's edges");
  extern __shared__ float4 smem[];
  float* s_rel = reinterpret_cast<float*>(smem);
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int t = lane % G;  // this thread's place in its stream
  const int F = a.num_features;
  const int64_t F64 = F;
  const int f0 = blockIdx.y * S;  // the slice's first feature
  const int f = f0 + t * W;       // this thread's first feature
  const bool on = f < F;          // F % W == 0 on the vector path
  if constexpr (kSharedRel) {
    staged::stage_rel<W, G, kThreads>(s_rel, a.rel, a.num_relations, F, f0);
  }
  if (threadIdx.x == 0) {
    staged::claim_items(a.seg_ptr, a.num_segments, a.num_edges, s_range);
    s_next = s_range[0] + kThreads / G;
  }
  __syncthreads();
  const int last = s_range[1];
  int item = min(s_range[0] + static_cast<int>(threadIdx.x) / G, last);
  int pos = 0, end = 0;
  if (item < last) {
    pos = __ldg(a.seg_ptr + item);
    end = __ldg(a.seg_ptr + item + 1);
  }
  bool empty = pos == end;  // the item has no edge (a row without edges)
  int next = staged::draw_item<G>(&s_next, true, lane, last);
  int next_begin = 0, next_end = 0;
  if (next < last) {
    next_begin = __ldg(a.seg_ptr + next);
    next_end = __ldg(a.seg_ptr + next + 1);
  }
  // lane t < kIn of the stream holds edge pos + t
  int m_col = 0, m_type = 0;
  float m_w = 0.f;
  if (t < kIn && pos + t < end) {
    m_col = __ldg(a.col + pos + t);
    m_type = __ldg(a.etype + pos + t);
    m_w = __ldg(a.w + pos + t);
  }
  // the accumulators: acc0 holds K4's extremum, K6's max or K7's sum, acc1
  // K6's min or K7's sum of squares; a max starts at -inf, a min at +inf, a
  // sum at 0
  const float start0 = KIND == kMin ? CUDART_INF_F
                       : KIND == kAddSq ? 0.f : -CUDART_INF_F;
  const float start1 = KIND == kMaxMin ? CUDART_INF_F : 0.f;
  float acc0[W], acc1[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc0[k] = start0;
    acc1[k] = start1;
  }
  while (__any_sync(0xffffffffu, item < last)) {
    const int n = item < last ? min(kIn, end - pos) : 0;
    Lanes<W> xv[kIn];
    Lanes<W> rv[kSharedRel ? 1 : kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int c = __shfl_sync(0xffffffffu, m_col, u, G);
      if constexpr (kSharedRel) {
        if (on && u < n) xv[u] = load_lanes<W>(a.x + c * F64 + f);
      } else {
        const int r = __shfl_sync(0xffffffffu, m_type, u, G);
        if (on && u < n) {
          xv[u] = load_lanes<W>(a.x + c * F64 + f);
          rv[u] = load_lanes<W>(a.rel + r * F64 + f);
        }
      }
    }
    // where this stream goes next: on in its item, or to the next item,
    // whose successor is drawn and whose edge range is loaded now
    const bool done = item < last && pos + kIn >= end;
    int new_item = item, new_pos = pos + kIn, new_end = end;
    bool new_empty = empty;
    if (done) {
      new_item = next;
      new_pos = next_begin;
      new_end = next_end;
      new_empty = next_begin == next_end;
    }
    const int drawn = staged::draw_item<G>(&s_next, done && next < last,
                                           lane, last);
    if (done) {
      next = drawn;
      if (next < last) {
        next_begin = __ldg(a.seg_ptr + next);
        next_end = __ldg(a.seg_ptr + next + 1);
      }
    }
    int c_col = 0, c_type = 0;
    float c_w = 0.f;
    if (new_item < last && t < kIn && new_pos + t < new_end) {
      c_col = __ldg(a.col + new_pos + t);
      c_type = __ldg(a.etype + new_pos + t);
      c_w = __ldg(a.w + new_pos + t);
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const float we = __shfl_sync(0xffffffffu, m_w, u, G);
      if constexpr (kSharedRel) {
        // the type is passed on here, not kept in a register
        const int r = __shfl_sync(0xffffffffu, m_type, u, G);
        if (on && u < n) {
          stats_edge<KIND, MODE, W>(
              acc0, acc1, staged::load_shared<W>(s_rel + r * S + (f - f0)),
              xv[u], we);
        }
      } else if (on && u < n) {
        stats_edge<KIND, MODE, W>(acc0, acc1, rv[u], xv[u], we);
      }
    }
    if (done) {
      if (on) {
        if constexpr (KIND != kAddSq) {  // a sum of no edges is 0 already
          if (empty) {
#pragma unroll
            for (int k = 0; k < W; ++k) acc0[k] = acc1[k] = 0.f;
          }
        }
        const int d = __ldg(a.seg_out + item);
        const int64_t off = (d >= 0 ? d : ~d) * F64 + f;
        store_lanes<W>((d >= 0 ? a.out0 : a.partial0) + off, acc0);
        if constexpr (kind_planes(KIND) == 2) {
          store_lanes<W>((d >= 0 ? a.out1 : a.partial1) + off, acc1);
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        acc0[k] = start0;
        acc1[k] = start1;
      }
    }
    item = new_item;
    pos = new_pos;
    end = new_end;
    empty = new_empty;
    m_col = c_col;
    m_type = c_type;
    m_w = c_w;
  }
}

__device__ __forceinline__ void max_to(float& a, float v) { a = fmaxf(a, v); }
__device__ __forceinline__ void min_to(float& a, float v) { a = fminf(a, v); }
__device__ __forceinline__ void max_to(float4& a, float4 v) {
  a = make_float4(fmaxf(a.x, v.x), fmaxf(a.y, v.y), fmaxf(a.z, v.z),
                  fmaxf(a.w, v.w));
}
__device__ __forceinline__ void min_to(float4& a, float4 v) {
  a = make_float4(fminf(a.x, v.x), fminf(a.y, v.y), fminf(a.z, v.z),
                  fminf(a.w, v.w));
}

// the second kernel of K6 (kMaxMin) and K4 (kMax, kMin), beside
// long_row_sums (rspmm_rows.cuh), for the rows cut into several segments
// (each has two or more partial rows), in segment order: K6 out0[rows[l],
// :] = the max over p in [ptr[l], ptr[l+1]) of p0[p, :] and out1[rows[l],
// :] the min of p1[p, :]; K4 out0[rows[l], :] = the max (or the min) of
// p0[p, :] alone
template <typename T, int KIND>
__global__ void __launch_bounds__(kMaxThreads)
long_row_extrema(const int* __restrict__ rows, const int* __restrict__ ptr,
                 const T* __restrict__ p0, const T* __restrict__ p1,
                 T* __restrict__ out0, T* __restrict__ out1, int n) {
  const int l = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int begin = __ldg(ptr + l);
  const int end = __ldg(ptr + l + 1);
  T a = rspmm::ld(p0 + static_cast<int64_t>(begin) * n + j);
  T b{};
  if constexpr (KIND == kMaxMin) {
    b = rspmm::ld(p1 + static_cast<int64_t>(begin) * n + j);
  }
#pragma unroll 8
  for (int p = begin + 1; p < end; ++p) {
    if constexpr (KIND == kMin) {
      min_to(a, rspmm::ld(p0 + static_cast<int64_t>(p) * n + j));
    } else {
      max_to(a, rspmm::ld(p0 + static_cast<int64_t>(p) * n + j));
    }
    if constexpr (KIND == kMaxMin) {
      min_to(b, rspmm::ld(p1 + static_cast<int64_t>(p) * n + j));
    }
  }
  const int64_t o = static_cast<int64_t>(__ldg(rows + l)) * n + j;
  out0[o] = a;
  if constexpr (KIND == kMaxMin) out1[o] = b;
}

// the long rows' partial rows combined into their rows: long_row_extrema
// for K4 and K6, long_row_sums once a plane for K7
template <int KIND>
cudaError_t launch_long_rows(bool vec, const int* long_rows,
                             const int* long_ptr, int num_long_rows,
                             const SegStats& a, cudaStream_t stream) {
  if (num_long_rows <= 0) return cudaGetLastError();
  if constexpr (KIND == kAddSq) {
    const cudaError_t err = staged::launch_long_row_sums(
        vec, long_rows, long_ptr, num_long_rows, a.partial0, a.out0,
        a.num_features, stream);
    if (err != cudaSuccess) return err;
    return staged::launch_long_row_sums(vec, long_rows, long_ptr,
                                        num_long_rows, a.partial1, a.out1,
                                        a.num_features, stream);
  } else {
    const int n = vec ? a.num_features / 4 : a.num_features;
    const int threads = n >= 64 ? 64 : ((n + 31) / 32) * 32;
    const dim3 grid(num_long_rows, (n + threads - 1) / threads);
    if (vec) {
      long_row_extrema<float4, KIND><<<grid, threads, 0, stream>>>(
          long_rows, long_ptr, reinterpret_cast<const float4*>(a.partial0),
          reinterpret_cast<const float4*>(a.partial1),
          reinterpret_cast<float4*>(a.out0), reinterpret_cast<float4*>(a.out1),
          n);
    } else {
      long_row_extrema<float, KIND><<<grid, threads, 0, stream>>>(
          long_rows, long_ptr, a.partial0, a.partial1, a.out0, a.out1, n);
    }
    return cudaGetLastError();
  }
}

template <int KIND, int MODE, int W, int G, bool kSharedRel>
int seg_resident(size_t smem) {
  static staged::Occupancy occupancy;
  return occupancy.resident(seg_stats<KIND, MODE, W, G, kSharedRel>, smem,
                            seg_threads(KIND));
}

// seg_stats' plan: 64-feature slices (32 on the scalar path), rel in shared
// memory where it fits; the CTAs in flight gather x's slices
template <int KIND, int MODE>
staged::Plan seg_plan(bool vec, int num_relations, int num_features,
                      int num_x_rows, int num_segments) {
  staged::Plan p;
  p.slice = vec ? staged::kSlice : staged::kScalarSlice;
  p.slices = (num_features + p.slice - 1) / p.slice;
  const size_t rel_bytes = size_t{4} * p.slice * num_relations;
  p.shared_rel = rel_bytes <= size_t{staged::kRelSmemBytes};
  p.smem = p.shared_rel ? rel_bytes : 0;
  constexpr int G4 = staged::kSlice / 4;
  int resident;
  if (vec) {
    resident = p.shared_rel ? seg_resident<KIND, MODE, 4, G4, true>(p.smem)
                            : seg_resident<KIND, MODE, 4, G4, false>(0);
  } else {
    resident = p.shared_rel ? seg_resident<KIND, MODE, 1, 32, true>(p.smem)
                            : seg_resident<KIND, MODE, 1, 32, false>(0);
  }
  staged::plan_ctas(&p, resident, num_x_rows, num_segments,
                    seg_threads(KIND) / 32);
  return p;
}

// the weights, seg_stats over a's segments, then the long rows' combine
template <int KIND, int MODE>
cudaError_t launch_seg(bool vec, const SegStats& a, const int* eid,
                       const float* weight, float* w_scratch,
                       const int* long_rows, const int* long_ptr,
                       int num_long_rows, int num_x_rows,
                       cudaStream_t stream) {
  cudaError_t err = staged::launch_gather_weights(eid, weight, w_scratch,
                                                  a.num_edges, stream);
  if (err != cudaSuccess) return err;
  const staged::Plan p = seg_plan<KIND, MODE>(
      vec, a.num_relations, a.num_features, num_x_rows, a.num_segments);
  const dim3 grid(p.ctas_per_slice, p.slices);
  constexpr int G4 = staged::kSlice / 4;
  constexpr int kThreads = seg_threads(KIND);
  if (vec && p.shared_rel) {
    seg_stats<KIND, MODE, 4, G4, true><<<grid, kThreads, p.smem, stream>>>(a);
  } else if (vec) {
    seg_stats<KIND, MODE, 4, G4, false><<<grid, kThreads, 0, stream>>>(a);
  } else if (p.shared_rel) {
    seg_stats<KIND, MODE, 1, 32, true><<<grid, kThreads, p.smem, stream>>>(a);
  } else {
    seg_stats<KIND, MODE, 1, 32, false><<<grid, kThreads, 0, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_long_rows<KIND>(vec, long_rows, long_ptr, num_long_rows, a,
                                stream);
}

// K4 and K6 take both modes, K7 mul_rel only
bool known(int kind, int mode) {
  const bool both_modes = mode == kMulRel || mode == kAddRel;
  return (kind == kAddSq && mode == kMulRel) ||
         ((kind == kMaxMin || kind == kMax || kind == kMin) && both_modes);
}

// a known kind's launches in mode
template <int KIND>
cudaError_t launch_kind(int mode, bool vec, const SegStats& a, const int* eid,
                        const float* weight, float* w_scratch,
                        const int* long_rows, const int* long_ptr,
                        int num_long_rows, int num_x_rows,
                        cudaStream_t stream) {
  if constexpr (KIND != kAddSq) {
    if (mode == kAddRel) {
      return launch_seg<KIND, kAddRel>(vec, a, eid, weight, w_scratch,
                                       long_rows, long_ptr, num_long_rows,
                                       num_x_rows, stream);
    }
  }
  return launch_seg<KIND, kMulRel>(vec, a, eid, weight, w_scratch, long_rows,
                                   long_ptr, num_long_rows, num_x_rows,
                                   stream);
}

// a known kind's plan in mode
template <int KIND>
staged::Plan plan_kind(int mode, bool vec, int num_relations,
                       int num_features, int num_x_rows, int num_segments) {
  if constexpr (KIND != kAddSq) {
    if (mode == kAddRel) {
      return seg_plan<KIND, kAddRel>(vec, num_relations, num_features,
                                     num_x_rows, num_segments);
    }
  }
  return seg_plan<KIND, kMulRel>(vec, num_relations, num_features,
                                 num_x_rows, num_segments);
}

}  // namespace

// K4, K6 and K7 on K1's layouts in rspmm_fwd_k1's order: the destination
// rows' segments (seg_ptr, seg_out, long_rows, long_ptr = Csr.seg_*,
// long_*) over the destination-sorted edges (src, etype, eid). kind: 0 =
// the max/min pair (K6; out0 = max, out1 = min), 1 = the moments (K7,
// mul_rel only; out0 = sum, out1 = sum of squares), 2 = max (K4; out0), 3 =
// min (K4; out0); mode: 0 = mul_rel, 1 = add_rel. w_scratch holds
// num_edges floats; partial0 and (but for K4) partial1 each
// long_ptr[num_long_rows] rows of F floats (null without long rows); K4
// reads neither out1 nor partial1, which may be null. Returns the first
// nonzero cudaGetLastError() code after a launch (0 on success); another
// kind or mode, or K7 with add_rel, returns cudaErrorInvalidValue without
// launching.
extern "C" int rspmm_pna_fwd_seg(
    int kind, int mode, const int* seg_ptr, const int* seg_out,
    const int* long_rows, const int* long_ptr, const int* src,
    const int* etype, const int* eid, const float* weight, const float* rel,
    const float* x, float* out0, float* out1, float* w_scratch,
    float* partial0, float* partial1, int num_segments, int num_long_rows,
    int num_edges, int num_relations, int num_x_rows, int num_features,
    void* stream) {
  using rspmm::aligned16;
  if (!known(kind, mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments <= 0 || num_features <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a null pointer counts as aligned: K4 has no out1, a graph without long
  // rows no partial rows
  const bool vec = num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(out0) && aligned16(out1) &&
                   aligned16(partial0) && aligned16(partial1);
  const SegStats a{seg_ptr,   seg_out,      src,       etype,
                   w_scratch, rel,          x,         out0,
                   out1,      partial0,     partial1,  num_segments,
                   num_edges, num_relations, num_features};
  cudaError_t err;
  switch (kind) {
    case kMaxMin:
      err = launch_kind<kMaxMin>(mode, vec, a, eid, weight, w_scratch,
                                 long_rows, long_ptr, num_long_rows,
                                 num_x_rows, s);
      break;
    case kAddSq:
      err = launch_kind<kAddSq>(mode, vec, a, eid, weight, w_scratch,
                                long_rows, long_ptr, num_long_rows,
                                num_x_rows, s);
      break;
    case kMax:
      err = launch_kind<kMax>(mode, vec, a, eid, weight, w_scratch, long_rows,
                              long_ptr, num_long_rows, num_x_rows, s);
      break;
    default:
      err = launch_kind<kMin>(mode, vec, a, eid, weight, w_scratch, long_rows,
                              long_ptr, num_long_rows, num_x_rows, s);
  }
  return static_cast<int>(err);
}

// How K4, K6 or K7 (kind and mode as rspmm_pna_fwd_seg's) lays out a call
// of this shape, written to out[0..4] as rspmm_k1_plan's: features a slice,
// 1 when the rel slice sits in shared memory, its bytes, the slices, the
// CTAs a slice; vec: 1 for the float4 path (F % 4 == 0, operands aligned).
extern "C" int rspmm_pna_fwd_plan(int kind, int mode, int vec,
                                  int num_relations, int num_features,
                                  int num_x_rows, int num_segments,
                                  int* out) {
  if (!known(kind, mode)) return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec != 0;
  staged::Plan p;
  switch (kind) {
    case kMaxMin:
      p = plan_kind<kMaxMin>(mode, v, num_relations, num_features,
                             num_x_rows, num_segments);
      break;
    case kAddSq:
      p = plan_kind<kAddSq>(mode, v, num_relations, num_features, num_x_rows,
                            num_segments);
      break;
    case kMax:
      p = plan_kind<kMax>(mode, v, num_relations, num_features, num_x_rows,
                          num_segments);
      break;
    default:
      p = plan_kind<kMin>(mode, v, num_relations, num_features, num_x_rows,
                          num_segments);
  }
  out[0] = p.slice;
  out[1] = p.shared_rel ? 1 : 0;
  out[2] = static_cast<int>(p.smem);
  out[3] = p.slices;
  out[4] = p.ctas_per_slice;
  return static_cast<int>(cudaGetLastError());
}
