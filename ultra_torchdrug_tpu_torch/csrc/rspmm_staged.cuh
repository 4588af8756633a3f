// Hub-aware, slice-major row sums of K1 and K1h (rspmm_fwd.cu) and K2 and
// K2h (rspmm_bwd.cu), by hand for Hopper; their blocks also serve K6
// (rspmm_pna_fwd.cu), K6b, K7b and K5 (rspmm_pna_bwd.cu) and K8f and K8b
// (rspmm_rotate.cu).
//
//   staged_rows:    out[row of item i, slice] = sum over the item's edges e
//                   of w_e * msg(rel[etype_e, slice], x[col_e, slice])
//                   (K1 over the destination rows' segments, K2's dx pass
//                   over the source rows' segments with g in place of x);
//   staged_chunks:  partial[slot_c, slice] = sum over chunk c's edges e of
//                   w_e * x[src_e, slice] * g[dst_e, slice]
//                   (K2's dr pass over the (destination tile, relation)
//                   chunks; relation_sums in rspmm_rows.cuh adds each
//                   relation's partial rows in slot order);
//   gather_weights: w_e = weight[eid_e] in the order of a layout, once per
//                   call, so that no slice gathers a weight through eid.
//
// The layouts are data/graph.py's Csr fields: an item is a segment of at most
// 256 edges of one row (seg_* / src_seg_*; a longer row is cut into several,
// whose partial rows long_row_sums in rspmm_rows.cuh adds in segment order)
// or a chunk of at most 256 edges of one relation in one destination tile
// (tile_*).
//
// The design:
//  * feature slices: a CTA owns one slice of kSlice = 64 features (picked
//    by timing 32, 64 and 128 on the card: PERF.md) and a
//    contiguous share of the items, cut by edge count so that hub segments
//    spread evenly. The grid is slice-major (blockIdx.y the slice), so the
//    CTAs that run together gather from a few slices of the gathered
//    tables, V * kSlice * 4 bytes each (3.7 MB at V = 14,541 and 64
//    features), which the 50 MB L2 holds; ctas_per_slice keeps about
//    kL2Bytes of slices in flight;
//  * staged_rows: one edge stream a segment. A stream of G threads (W
//    lanes each, one 16-byte load) sums its segment's edges in edge order,
//    kIn gathers in flight a thread, in a software pipeline: while an
//    iteration's gathers are in flight, the next iteration's edge metadata
//    (row, type, weight; one coalesced load each by kIn lanes, passed on by
//    shuffles) and at a segment's start the next segment and its edge range
//    are loaded. (Run with the chunks as items, this pipeline took 1.93 ms
//    for the dr pass at the ULTRA training shape against staged_chunks'
//    1.85, and 1.90 against 1.39 on bench.py's KG: PERF.md);
//  * staged_chunks: one warp a chunk (see there);
//  * the rel slice in shared memory: each CTA of K1 and K2's dx pass first
//    copies rel[:, slice] (R * kSlice * 4 bytes, 121 KB at R = 474) into
//    shared memory, and each edge then gathers only its x (or g) row. Where
//    that exceeds kRelSmemBytes, the kernel gathers rel rows instead (the
//    same kernel, a choice by shape, kSharedRel = false);
//  * streams (warps) take segments (chunks) from the CTA's share through a
//    shared counter (an integer atomic): each sum is one stream's or one
//    warp's in a fixed order, whichever takes it, so two calls give
//    bitwise-equal outputs. No float atomics.
//
// Operands: the kernels, plans and launchers take the operand type In,
// fp32 (K1, K2) or bf16 (K1h and K2h: rel, x and g bf16, weights, sums and
// outputs fp32). A bf16 slice holds kBf16RowsSlice (staged_rows) or
// kBf16ChunksSlice (staged_chunks) features of 8 lanes a thread (one
// 16-byte load); the rel slice is staged in the operand type (121 KB at
// R = 474 for 128 bf16 features). Gathered bf16 lanes stay packed until
// they are used. K2h's products are taken in fp32 from the widened values;
// K1h's messages in bf16 arithmetic on the lanes as they lie, rounded once
// to bf16 before the fp32 weight multiplies them (accumulate_packed).

#pragma once

#include <algorithm>
#include <type_traits>

#include "rspmm_rows.cuh"

namespace rspmm {
namespace staged {
// internal linkage: each library that includes this header keeps its own
// kernels and launch state (a shared-memory attribute set on one library's
// kernel does not reach another's)
namespace {

// features of a slice on the vector path (16 threads of 4 floats); the
// scalar path (F % 4 != 0) takes 32 one-float lanes
constexpr int kSlice = 64;
constexpr int kScalarSlice = 32;
// features of a bf16 slice on the vector path (8 lanes a thread), picked by
// timing in turns on the card (PERF.md): staged_rows 128 (256-byte rows, as
// an fp32 slice; 64, with the rel slice widened to fp32, was 19 % slower),
// staged_chunks 64 (four edge streams a warp; 128 was 10 % slower, 32
// 52 %)
constexpr int kBf16RowsSlice = 128;
constexpr int kBf16ChunksSlice = 64;
// one CTA of 1,024 threads an SM (64 registers each), whose rel slice may
// take all of the SM's shared memory (121 KB at R = 474)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// gathers in flight a thread: kRowInFlight edges a round, half as many
// where each edge gathers two rows
constexpr int kRowInFlight = 8;
// the rel slice's budget: the shared memory of one SM, less the CTA's
// static shared memory
constexpr int kRelSmemBytes = 227 * 1024 - 512;
// the gathered slices that the CTAs in flight may touch together
constexpr int64_t kL2Bytes = 24ll << 20;

// features a slice of staged_rows and of staged_chunks on the vector path
// for operands of type In
template <typename In>
constexpr int rows_slice() {
  return std::is_same_v<In, float> ? kSlice : kBf16RowsSlice;
}
template <typename In>
constexpr int chunks_slice() {
  return std::is_same_v<In, float> ? kSlice : kBf16ChunksSlice;
}


// w_out[e] = weight[eid[e]]
__global__ void gather_weights(const int* __restrict__ eid,
                               const float* __restrict__ weight,
                               float* __restrict__ w_out, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) w_out[e] = __ldg(weight + __ldg(eid + e));
}

inline cudaError_t launch_gather_weights(const int* eid, const float* weight,
                                         float* w_out, int n,
                                         cudaStream_t stream) {
  if (n > 0) {
    gather_weights<<<(n + 255) / 256, 256, 0, stream>>>(eid, weight, w_out,
                                                        n);
  }
  return cudaGetLastError();
}

// the first i in [0, n) with a[i] >= v, else n
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// This CTA's items: those whose first edge falls in its share
// [c * E / k, (c + 1) * E / k) of the edges (the last CTA also takes the
// items that start at E, rows without edges at the end), as range[0..1].
__device__ __forceinline__ void claim_items(const int* ptr, int num_items,
                                            int num_edges, int* range) {
  const int c = blockIdx.x, k = gridDim.x;
  range[0] = lower_bound(ptr, num_items,
                         static_cast<int>(int64_t{c} * num_edges / k));
  range[1] = c + 1 == k
                 ? num_items
                 : lower_bound(ptr, num_items,
                               static_cast<int>(int64_t{c + 1} * num_edges / k));
}

template <int W>
__device__ __forceinline__ Lanes<W> load_shared(const float* p) {
  Lanes<W> out;
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out.v[0] = t.x;
    out.v[1] = t.y;
    out.v[2] = t.z;
    out.v[3] = t.w;
  } else {
    out.v[0] = *p;
  }
  return out;
}

// W bf16 lanes of a staged rel slice, widened to fp32 (W = 8: one 16-byte
// load)
template <int W>
__device__ __forceinline__ Lanes<W> load_shared(const bf16* p) {
  if constexpr (W == 8) {
    return widen_lanes(*reinterpret_cast<const uint4*>(p));
  } else {
    Lanes<W> out;
    out.v[0] = __bfloat162float(*p);
    return out;
  }
}

// the 16 bytes (W = 8) or the element (W = 1) of bf16 lanes, as they lie
template <int W>
using RawLanes = std::conditional_t<W == 8, uint4, unsigned short>;

// W lanes of a gathered row as they arrive: fp32 lanes, or bf16 lanes
// packed as they lie, widened where they are used (widen), so that a
// thread's gathers in flight take 4 registers an edge either way (widened
// at the load, K2h's passes spilled 160-536 bytes: PERF.md)
template <typename In, int W>
using Gathered =
    std::conditional_t<std::is_same_v<In, float>, Lanes<W>, RawLanes<W>>;

template <int W, typename In>
__device__ __forceinline__ Gathered<In, W> gather(const In* p) {
  if constexpr (std::is_same_v<In, float>) {
    return load_lanes<W>(p);
  } else {
    return __ldg(reinterpret_cast<const RawLanes<W>*>(p));
  }
}

template <int W>
__device__ __forceinline__ const Lanes<W>& widen(const Lanes<W>& v) {
  return v;
}
__device__ __forceinline__ Lanes<8> widen(uint4 t) { return widen_lanes(t); }
__device__ __forceinline__ Lanes<1> widen(unsigned short b) {
  Lanes<1> out;
  out.v[0] = __uint_as_float(static_cast<uint32_t>(b) << 16);
  return out;
}

// K1h's message of W bf16 lanes as they lie: rel * x (kMulRel) or rel + x
// (kAddRel) in bf16 arithmetic, two lanes an instruction, rounded once to
// bf16 as the TPU kernel's bf16 product is (rspmm_pallas.py:365, :497),
// then widened and weighted into the fp32 sums, acc += m * w. The fp32
// product of two bf16 values is exact and their fp32 sum rounds to bf16 as
// the exact sum does (24 >= 2 * 8 + 2 bits), so the plain version's
// rounding of the fp32 result gives the same bits at every magnitude above
// fp32's subnormals (below 2^-126 the fp32 result may round first). With
// the lanes widened first and the fp32 result rounded, K1h took 1.12 ms
// against 0.86 at F = 4,096 on an NVIDIA H100 (PERF.md).
template <int MODE, int W>
__device__ __forceinline__ void accumulate_packed(float (&acc)[W],
                                                  RawLanes<W> r,
                                                  RawLanes<W> x, float w) {
  static_assert(MODE == kMulRel || MODE == kAddRel, "K1h's modes");
  if constexpr (W == 8) {
    const uint32_t rp[4] = {r.x, r.y, r.z, r.w};
    const uint32_t xp[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&rp[k]);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&xp[k]);
      __nv_bfloat162 m;
      if constexpr (MODE == kMulRel) {
        m = __hmul2(a, b);
      } else {
        m = __hadd2(a, b);
      }
      const uint32_t p = *reinterpret_cast<const uint32_t*>(&m);
      // little-endian: lane 2k in the low half
      acc[2 * k] += __uint_as_float(p << 16) * w;
      acc[2 * k + 1] += __uint_as_float(p & 0xffff0000u) * w;
    }
  } else {
    const bf16 a = __ushort_as_bfloat16(r), b = __ushort_as_bfloat16(x);
    bf16 m;
    if constexpr (MODE == kMulRel) {
      m = __hmul(a, b);
    } else {
      m = __hadd(a, b);
    }
    acc[0] += __bfloat162float(m) * w;
  }
}

// s_rel[r * W * G + c] = rel[r, f0 + c] for the W * G features of the slice
// at f0 (those below F), every relation, by the CTA's THREADS threads:
// kRowInFlight loads in flight a thread, so that the slice (121 KB at
// R = 474) arrives in about one memory latency, not one per row a thread
template <int W, int G, int THREADS>
__device__ __forceinline__ void stage_rel(float* s_rel, const float* rel,
                                          int num_relations, int F, int f0) {
  constexpr int S = W * G;
  const int64_t F64 = F;
  const int n = num_relations * G;
  for (int i0 = threadIdx.x; i0 < n; i0 += kRowInFlight * THREADS) {
    Lanes<W> v[kRowInFlight];
#pragma unroll
    for (int u = 0; u < kRowInFlight; ++u) {
      const int i = i0 + u * THREADS, c = (i % G) * W;
      if (i < n && f0 + c < F) {
        v[u] = load_lanes<W>(rel + (i / G) * F64 + f0 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowInFlight; ++u) {
      const int i = i0 + u * THREADS, c = (i % G) * W;
      if (i < n && f0 + c < F) store_lanes<W>(s_rel + (i / G) * S + c, v[u].v);
    }
  }
}

template <typename In>
struct Rows {
  const int* seg_ptr;  // [S + 1] the items' edge ranges
  const int* seg_out;  // [S] row (>= 0) or ~partial slot
  const int* col;      // [E] the gathered row of each edge
  const int* etype;    // [E]
  const float* w;      // [E] each edge's weight, in this order
  const In* rel;       // [R, F]
  const In* x;         // [V_in, F] (K2's dx pass: g)
  float* out;          // [V, F]
  float* partial;      // [P, F] the long rows' partial rows
  int num_segments;
  int num_edges;
  int num_relations;
  int num_features;
};

// The next item of a stream, drawn by its first lane and passed to the
// others (every lane of the warp takes part; `draw` selects the streams
// that need one). Returns `last` past the end.
template <int G>
__device__ __forceinline__ int draw_item(int* next, bool draw, int lane,
                                         int last) {
  int item = last;
  if (draw && lane % G == 0) item = min(atomicAdd(next, 1), last);
  return __shfl_sync(0xffffffffu, item, lane - lane % G);
}

// MODE kMulRel or kAddRel (K1, K2; K1h with In = bf16), kMulScaled (K2h);
// W lanes a thread, G threads a stream, each stream one item at a time,
// kIn edges an iteration
template <int MODE, int W, int G, bool kSharedRel, typename In>
__global__ void __launch_bounds__(kThreads, 1) staged_rows(Rows<In> a) {
  constexpr int S = W * G;
  // the gathered-rel branch loads two rows an edge
  constexpr int kIn = kSharedRel ? kRowInFlight : kRowInFlight / 2;
  // K1h's messages in bf16 arithmetic on the lanes as they lie
  constexpr bool kPacked = std::is_same_v<In, bf16> && MODE != kMulScaled;
  static_assert(kIn <= G, "a stream's lanes hold an iteration's edges");
  extern __shared__ float4 smem[];
  In* s_rel = reinterpret_cast<In*>(smem);
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int t = lane % G;  // this thread's place in its stream
  const int F = a.num_features;
  const int64_t F64 = F;
  const int f0 = blockIdx.y * S;  // the slice's first feature
  const int f = f0 + t * W;       // this thread's first feature
  const bool on = f < F;          // F % W == 0 on the vector path
  if constexpr (kSharedRel && std::is_same_v<In, bf16>) {
    // bf16 rows staged as they lie, 16 bytes a load: stage_rel's loop
    using Raw = RawLanes<W>;
    const int n = a.num_relations * G;
    for (int i0 = threadIdx.x; i0 < n; i0 += kRowInFlight * kThreads) {
      Raw v[kRowInFlight];
#pragma unroll
      for (int u = 0; u < kRowInFlight; ++u) {
        const int i = i0 + u * kThreads, c = (i % G) * W;
        if (i < n && f0 + c < F) {
          v[u] = __ldg(reinterpret_cast<const Raw*>(a.rel + (i / G) * F64 +
                                                    f0 + c));
        }
      }
#pragma unroll
      for (int u = 0; u < kRowInFlight; ++u) {
        const int i = i0 + u * kThreads, c = (i % G) * W;
        if (i < n && f0 + c < F) {
          *reinterpret_cast<Raw*>(s_rel + (i / G) * S + c) = v[u];
        }
      }
    }
  } else if constexpr (kSharedRel) {
    // kRowInFlight loads in flight a thread: the slice (121 KB at R = 474)
    // arrives in about one memory latency, not one per row a thread (the
    // loop of stage_rel, kept in place so that K1's and K2's compiled code
    // stays as it was)
    const int n = a.num_relations * G;
    for (int i0 = threadIdx.x; i0 < n; i0 += kRowInFlight * kThreads) {
      Lanes<W> v[kRowInFlight];
#pragma unroll
      for (int u = 0; u < kRowInFlight; ++u) {
        const int i = i0 + u * kThreads, c = (i % G) * W;
        if (i < n && f0 + c < F) {
          v[u] = load_lanes<W>(a.rel + (i / G) * F64 + f0 + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowInFlight; ++u) {
        const int i = i0 + u * kThreads, c = (i % G) * W;
        if (i < n && f0 + c < F) store_lanes<W>(s_rel + (i / G) * S + c, v[u].v);
      }
    }
  }
  if (threadIdx.x == 0) {
    claim_items(a.seg_ptr, a.num_segments, a.num_edges, s_range);
    s_next = s_range[0] + kThreads / G;
  }
  __syncthreads();
  const int last = s_range[1];
  // a software pipeline per stream: while an iteration's kIn gathers are
  // in flight, the next iteration's edge metadata (and, at the start of an
  // item, the item after it and its edge range) are loaded
  int item = min(s_range[0] + static_cast<int>(threadIdx.x) / G, last);
  int pos = 0, end = 0;
  if (item < last) {
    pos = __ldg(a.seg_ptr + item);
    end = __ldg(a.seg_ptr + item + 1);
  }
  int next = draw_item<G>(&s_next, true, lane, last);
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
  float acc[W] = {};
  while (__any_sync(0xffffffffu, item < last)) {
    const int n = item < last ? min(kIn, end - pos) : 0;
    Gathered<In, W> xv[kIn];
    Gathered<In, W> rv[kSharedRel ? 1 : kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int c = __shfl_sync(0xffffffffu, m_col, u, G);
      if constexpr (kSharedRel) {
        if (on && u < n) xv[u] = gather<W>(a.x + c * F64 + f);
      } else {
        const int r = __shfl_sync(0xffffffffu, m_type, u, G);
        if (on && u < n) {
          xv[u] = gather<W>(a.x + c * F64 + f);
          rv[u] = gather<W>(a.rel + r * F64 + f);
        }
      }
    }
    // where this stream goes next: on in its item, or to the next item,
    // whose successor is drawn and whose edge range is loaded now
    const bool done = item < last && pos + kIn >= end;
    int new_item = item, new_pos = pos + kIn, new_end = end;
    if (done) {
      new_item = next;
      new_pos = next_begin;
      new_end = next_end;
    }
    const int drawn = draw_item<G>(&s_next, done && next < last, lane, last);
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
          if constexpr (kPacked) {
            accumulate_packed<MODE, W>(
                acc,
                *reinterpret_cast<const RawLanes<W>*>(s_rel + r * S + (f - f0)),
                xv[u], we);
          } else {
            accumulate<MODE, W>(
                acc, load_shared<W>(s_rel + r * S + (f - f0)), widen(xv[u]),
                we);
          }
        }
      } else if (on && u < n) {
        if constexpr (kPacked) {
          accumulate_packed<MODE, W>(acc, rv[u], xv[u], we);
        } else {
          accumulate<MODE, W>(acc, widen(rv[u]), widen(xv[u]), we);
        }
      }
    }
    if (done) {
      if (on) {
        const int d = __ldg(a.seg_out + item);
        float* o = d >= 0 ? a.out + d * F64 : a.partial + int64_t{~d} * F64;
        store_lanes<W>(o + f, acc);
      }
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = 0.f;
    }
    item = new_item;
    pos = new_pos;
    end = new_end;
    m_col = c_col;
    m_type = c_type;
    m_w = c_w;
  }
}

// K2's dr pass: partial[slot_c, slice] = sum over chunk c's edges e of
// w_e * x[src_e, slice] * g[dst_e, slice]. One warp a chunk: its 32 / G
// streams take every (32 / G)-th edge of a batch of 32, whose metadata the
// warp loads with one coalesced load each, and the streams' sums are
// combined by a fixed butterfly. A chunk's destinations are sorted and lie
// in one tile, so the streams' g gathers fall on neighbouring rows, often
// the same one (a destination hub), which one warp's loads share. bf16
// operands (K2h) take the bf16 backward's order, x * (g * w).
template <typename In>
struct Chunks {
  const int* chunk_ptr;   // [C + 1] the chunks' edge ranges (tile-major)
  const int* chunk_slot;  // [C] each chunk's partial row
  const int* src;         // [E] in tile order
  const int* dst;         // [E]
  const float* w;         // [E] each edge's weight, in tile order
  const In* x;            // [V, F]
  const In* g;            // [V, F]
  float* partial;         // [C, F]
  int num_chunks;
  int num_edges;
  int num_features;
};

template <int W, int G, typename In>
__global__ void __launch_bounds__(kThreads, 1)
staged_chunks(Chunks<In> a) {
  constexpr int kStreams = 32 / G;
  constexpr int kIn = kRowInFlight / 2;  // two gathers an edge
  constexpr int kMode = std::is_same_v<In, float> ? kMulRel : kMulScaled;
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int stream = lane / G;
  const int F = a.num_features;
  const int64_t F64 = F;
  const int f = blockIdx.y * (W * G) + (lane % G) * W;
  const bool on = f < F;
  if (threadIdx.x == 0) {
    claim_items(a.chunk_ptr, a.num_chunks, a.num_edges, s_range);
    s_next = s_range[0] + kWarps;
  }
  __syncthreads();
  const int last = s_range[1];
  int item = s_range[0] + static_cast<int>(threadIdx.x >> 5);
  while (item < last) {
    const int begin = __ldg(a.chunk_ptr + item);
    const int end = __ldg(a.chunk_ptr + item + 1);
    float acc[W] = {};
    for (int base = begin; base < end; base += 32) {
      const int n = min(32, end - base);
      int m_src = 0, m_dst = 0;
      float m_w = 0.f;
      if (lane < n) {
        m_src = __ldg(a.src + base + lane);
        m_dst = __ldg(a.dst + base + lane);
        m_w = __ldg(a.w + base + lane);
      }
#pragma unroll
      for (int u0 = 0; u0 < G; u0 += kIn) {
        if (u0 * kStreams >= n) break;
        Gathered<In, W> xv[kIn];
        Gathered<In, W> gv[kIn];
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const int s = __shfl_sync(0xffffffffu, m_src, i);
          const int d = __shfl_sync(0xffffffffu, m_dst, i);
          if (on && i < n) {
            xv[u] = gather<W>(a.x + s * F64 + f);
            gv[u] = gather<W>(a.g + d * F64 + f);
          }
        }
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const float we = __shfl_sync(0xffffffffu, m_w, i);
          if (on && i < n) {
            accumulate<kMode, W>(acc, widen(xv[u]), widen(gv[u]), we);
          }
        }
      }
    }
    // the streams' sums, combined over the lanes G, 2G, ... apart: the same
    // sum in every lane, in a fixed order
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
    if (on && stream == 0) {
      store_lanes<W>(a.partial + __ldg(a.chunk_slot + item) * F64 + f, acc);
    }
    int next = 0;
    if (lane == 0) next = atomicAdd(&s_next, 1);
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

// How a pass is laid out: features a slice, whether the rel slice sits in
// shared memory (its bytes), the slices, and the CTAs of each slice.
struct Plan {
  int slice;
  bool shared_rel;
  size_t smem;
  int slices;
  int ctas_per_slice;
};

// CTAs of one kernel that fit on the card at once. The SM count, the
// occupancy and the raised shared-memory limit are kept per device (a
// cudaFuncSetAttribute acts on the current device only) and asked once per
// kernel, device and shared-memory size; a device numbered kMaxDevices or
// more is asked on every call.
constexpr int kMaxDevices = 64;

struct Occupancy {
  struct Device {
    int sms = 0;
    size_t smem = ~size_t{0};
    int blocks = 0;
    bool raised = false;  // the limit above 48 KB of dynamic shared memory
  };
  Device devices[kMaxDevices];

  template <typename Kernel>
  int resident(Kernel kernel, size_t bytes, int threads = kThreads) {
    int dev = 0;
    cudaGetDevice(&dev);
    Device unkept;
    Device& d = dev >= 0 && dev < kMaxDevices ? devices[dev] : unkept;
    if (d.sms == 0) {
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (bytes > 48 * 1024 && !d.raised) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kRelSmemBytes);
      d.raised = true;
    }
    if (bytes != d.smem) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.blocks, kernel,
                                                    threads, bytes);
      d.smem = bytes;
    }
    return d.sms * std::max(d.blocks, 1);
  }
};

template <int MODE, int W, int G, bool kSharedRel, typename In>
int rows_resident(size_t smem) {
  static Occupancy occupancy;
  return occupancy.resident(staged_rows<MODE, W, G, kSharedRel, In>, smem);
}

template <int W, int G, typename In>
int chunks_resident() {
  static Occupancy occupancy;
  return occupancy.resident(staged_chunks<W, G, In>, 0);
}

// p.ctas_per_slice for a pass whose items gather from gathered_rows rows of
// elem_bytes an element: enough for every CTA that fits on the card
// (resident) to run while the slices in flight gather at most kL2Bytes,
// rounded up to whole waves of CTAs, and no more than one a `warps` items
// (the warps of a CTA)
inline void plan_ctas(Plan* p, int resident, int64_t gathered_rows,
                      int num_items, int warps = kWarps, int elem_bytes = 4) {
  const int64_t slice_bytes =
      std::max<int64_t>(1, gathered_rows * p->slice * elem_bytes);
  const int64_t in_flight = std::max<int64_t>(1, kL2Bytes / slice_bytes);
  int64_t k = (resident + in_flight - 1) / in_flight;
  const int64_t waves = (k * p->slices + resident - 1) / resident;
  k = std::max<int64_t>(k, waves * resident / p->slices);
  k = std::min<int64_t>(k, num_items / warps);
  p->ctas_per_slice = static_cast<int>(std::max<int64_t>(1, k));
}

// The plan of staged_rows over num_items items (K1's or the dx pass's
// segments) that gather from gathered_rows rows, with rel rows of
// num_relations in shared memory where they fit
template <int MODE, typename In>
Plan rows_plan(bool vec, int num_relations, int num_features,
               int64_t gathered_rows, int num_items) {
  constexpr int W = vec_lanes<In>(), G = rows_slice<In>() / W;
  Plan p;
  p.slice = vec ? rows_slice<In>() : kScalarSlice;
  p.slices = (num_features + p.slice - 1) / p.slice;
  const size_t rel_bytes = sizeof(In) * size_t{1} * p.slice * num_relations;
  p.shared_rel = rel_bytes <= size_t{kRelSmemBytes};
  p.smem = p.shared_rel ? rel_bytes : 0;
  int resident;
  if (vec) {
    resident = p.shared_rel ? rows_resident<MODE, W, G, true, In>(p.smem)
                            : rows_resident<MODE, W, G, false, In>(0);
  } else {
    resident = p.shared_rel ? rows_resident<MODE, 1, 32, true, In>(p.smem)
                            : rows_resident<MODE, 1, 32, false, In>(0);
  }
  plan_ctas(&p, resident, gathered_rows, num_items, kWarps, sizeof(In));
  return p;
}

// The plan of staged_chunks over num_chunks chunks (x's and g's rows,
// gathered_rows together)
template <typename In>
Plan chunks_plan(bool vec, int num_features, int64_t gathered_rows,
                 int num_chunks) {
  constexpr int W = vec_lanes<In>(), G = chunks_slice<In>() / W;
  Plan p;
  p.slice = vec ? chunks_slice<In>() : kScalarSlice;
  p.slices = (num_features + p.slice - 1) / p.slice;
  p.shared_rel = false;
  p.smem = 0;
  plan_ctas(&p, vec ? chunks_resident<W, G, In>() : chunks_resident<1, 32, In>(),
            gathered_rows, num_chunks, kWarps, sizeof(In));
  return p;
}

// long_row_sums: out[long_rows[l]] = the sum of the row's partial rows in
// segment order, for the num_long_rows rows cut into several segments
inline cudaError_t launch_long_row_sums(bool vec, const int* long_rows,
                                        const int* long_ptr,
                                        int num_long_rows,
                                        const float* partial, float* out,
                                        int num_features,
                                        cudaStream_t stream) {
  if (num_long_rows > 0) {
    const int n = vec ? num_features / 4 : num_features;
    const int threads = n >= 64 ? 64 : ((n + 31) / 32) * 32;
    const dim3 grid(num_long_rows, (n + threads - 1) / threads);
    if (vec) {
      long_row_sums<float4><<<grid, threads, 0, stream>>>(
          long_rows, long_ptr, reinterpret_cast<const float4*>(partial),
          reinterpret_cast<float4*>(out), n);
    } else {
      long_row_sums<float><<<grid, threads, 0, stream>>>(
          long_rows, long_ptr, partial, out, n);
    }
  }
  return cudaGetLastError();
}

// relation_sums: dr[r] = the sum of relation r's partial rows in slot
// order, for every relation
inline cudaError_t launch_relation_sums(bool vec, const int* rel_ptr,
                                        int num_relations,
                                        const float* partial, float* dr,
                                        int num_features,
                                        cudaStream_t stream) {
  if (num_relations > 0) {
    const int n = vec ? num_features / 4 : num_features;
    int threads, tiles;
    feature_tiles(n, &threads, &tiles);
    const dim3 grid(num_relations, tiles);
    if (vec) {
      relation_sums<float4><<<grid, threads, 0, stream>>>(
          rel_ptr, reinterpret_cast<const float4*>(partial),
          reinterpret_cast<float4*>(dr), n);
    } else {
      relation_sums<float><<<grid, threads, 0, stream>>>(rel_ptr, partial,
                                                         dr, n);
    }
  }
  return cudaGetLastError();
}

// staged_rows over a's items by plan p, then long_row_sums over the long
// rows
template <int MODE, typename In>
cudaError_t launch_rows(bool vec, const Plan& p, const Rows<In>& a,
                        const int* long_rows, const int* long_ptr,
                        int num_long_rows, cudaStream_t stream) {
  constexpr int W = vec_lanes<In>(), G = rows_slice<In>() / W;
  if (a.num_features <= 0) return cudaGetLastError();
  if (a.num_segments > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    if (vec && p.shared_rel) {
      staged_rows<MODE, W, G, true, In><<<grid, kThreads, p.smem, stream>>>(a);
    } else if (vec) {
      staged_rows<MODE, W, G, false, In><<<grid, kThreads, 0, stream>>>(a);
    } else if (p.shared_rel) {
      staged_rows<MODE, 1, 32, true, In><<<grid, kThreads, p.smem, stream>>>(
          a);
    } else {
      staged_rows<MODE, 1, 32, false, In><<<grid, kThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_long_row_sums(vec, long_rows, long_ptr, num_long_rows,
                              a.partial, a.out, a.num_features, stream);
}

// staged_chunks over a's chunks by plan p, then relation_sums of each
// relation's partial rows in slot order into dr [R, F]
template <typename In>
cudaError_t launch_chunks(bool vec, const Plan& p, const Chunks<In>& a,
                          const int* rel_ptr, int num_relations, float* dr,
                          cudaStream_t stream) {
  constexpr int W = vec_lanes<In>(), G = chunks_slice<In>() / W;
  if (a.num_features <= 0) return cudaGetLastError();
  if (a.num_chunks > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    if (vec) {
      staged_chunks<W, G, In><<<grid, kThreads, 0, stream>>>(a);
    } else {
      staged_chunks<1, 32, In><<<grid, kThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_relation_sums(vec, rel_ptr, num_relations, a.partial, dr,
                              a.num_features, stream);
}

}  // namespace
}  // namespace staged
}  // namespace rspmm
