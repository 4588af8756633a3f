// Relational SpMM with RotatE messages, sum aggregation: kernels K8f (the
// forward) and K8b (its backward) of the port.
//
// Rows are fp32 [N, F] with F = B * D: B blocks of D features, each block
// holding the real parts in [:D/2] and the imaginary parts in [D/2:] (the
// RotatE convention of ultra_torchdrug_tpu/ops/rspmm.py:64-73). With the
// complex product a (x) b = (ar*br - ai*bi, ar*bi + ai*br) and
// conj(a) (x) b = (ar*br + ai*bi, ar*bi - ai*br), lane by lane:
//
// K8f replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1 in mode
// rot_rel (reached through rspmm_rotate_fwd_pallas):
//
//     out[v, :] = sum over e = (s -> v, r) of  (rel[r] (x) x[s]) * w[eid_e]
//
// K8b replaces rspmm_bwd_fused in mode rotate (through rspmm_rotate_bwd_pallas):
//
//     dx[s, :] = sum over e = (s -> v, r) of  (conj(rel[r]) (x) g[v]) * w[eid_e]
//     dr[r, :] = sum over e with type r   of  (conj(x[s_e]) (x) g[v_e]) * w[eid_e]
//
// Shapes: x, g, dx, out [V, F]; rel, dr [R, F]; w [E] in original edge order.
// Rows without edges come back 0.
//
// What bounds them on an H100: the compulsory traffic is one read of the
// dense inputs and the edges and one write of each output; the work is 5
// flops per edge and feature for K8f (the complex product, 3 per real lane,
// the weight and the sum) and 10 for K8b. At classic NBFNet's shapes on the
// FB15k-237-sized graph (V = 14,541, E = 496,188, R = 474, D = 32) K8f moves
// about 68.5 MB at F = 512 (0.0204 ms at 3.35 TB/s, against 1.27 GFLOP,
// 0.019 ms at 67 TFLOP/s fp32: bytes-bound) and 250 MB at F = 2048 (0.0746 ms
// against 0.0758 ms: just flop-bound); K8b at F = 2048 moves 373 MB
// (0.111 ms) against 10.2 GFLOP (0.152 ms): flop-bound. A design gathers a
// row per edge of g (dx pass; rel too where it is not staged) and of x and
// g (dr pass), so, as for K1 and K2, where those gathers are served (the
// 50 MB L2 or the memory) is its real limit.
//
// Lanes: a thread owns W complex positions (b, k), k < D/2, and reads their
// real parts at b*D + k and their imaginary parts at b*D + D/2 + k, and
// writes both. The TPU kernel relays the rows out into planar re/im halves
// first (_planarize, rspmm_pallas.py:2627); the card indexes the halves in
// place. Four positions a thread (two float4 loads a row) when D/2 % 4 == 0
// and every row pointer is 16-byte aligned, else one.
//
// K8f's first design ran one CTA per destination row and feature tile, each
// edge loading its etype, col and w[eid] and gathering a rel and an x row:
// 1.30 ms at F = 2048 (NVIDIA H100 80GB HBM3, 700 W; PERF.md), a hub row
// walked by one CTA. K8f and K8b's dx pass are one kernel, rotate_seg_rows,
// whose template argument kConj picks rel (x) x or conj(rel) (x) g:
//  * K8f: over K1's destination rows' 256-edge segments (Csr.seg_ptr,
//    seg_out, long_rows, long_ptr over src, etype and eid), each edge
//    gathering x's slice, the rel slice in shared memory, long rows
//    through partial rows that long_row_sums adds in segment order, the
//    weights gathered once a call; rows without edges write 0;
//  * K8b's dx pass: the same over the source rows' segments, gathering g.
//
// K8b runs K2's staged design (rspmm_staged.cuh; the layouts data/graph.py's
// Csr.src_seg_* / src_long_* and tile_*) with a complex body, slice-major in
// slices of kPositions = 32 complex positions (64 floats, K2's slice width):
// slice i holds positions [32 i, 32 i + 32), whose real parts and
// imaginary parts lie in separate runs of a row (at D = 32 a slice is two
// whole blocks, at D = 128 half of one block's real and half of its
// imaginary parts). One column map, position_offset, serves the rel
// staging, the gathers and the stores.
//  * dx pass: the source rows' 256-edge segments (long rows through partial
//    rows that long_row_sums adds in segment order), one stream of G
//    threads a segment (8 on the vector path, 32 on the scalar one) in
//    staged_rows' software pipeline, the rel slice in shared memory (real
//    parts, then imaginary parts, 64 floats a relation: 121 KB at R = 474;
//    rel rows gathered above R = 906), so each edge gathers only g's slice;
//    no x is read;
//  * dr pass: the (destination tile, relation) chunks, one warp a chunk
//    (its 32 / G streams take every (32 / G)-th edge, their sums combined by
//    a fixed butterfly), each edge gathering x's and g's slices, the
//    chunk's sorted destinations shared by the warp's loads; partial rows
//    in relation-major slots, added by relation_sums in slot order;
//  * both passes read each edge's weight from a copy gathered once per
//    call in their order (gather_weights);
//  * the dx pass runs 512-thread CTAs of up to 128 registers a thread, so
//    that eight edges' g lanes (64 floats) are in flight a stream without
//    spills (at 1,024 threads, four edges', it spilled), the dr pass
//    1,024-thread CTAs, two edges' x and g lanes in flight.
// Deterministic: every sum is one stream's or one warp's in a fixed order,
// then partials in a fixed order; no float atomics, so two calls give
// bitwise-equal dx and dr (and K8f's out). One K8b call makes up to six
// launches: the weights of each pass, the dx segments, the long rows' sums,
// the dr chunks, the relation sums (a half whose output pointer is null is
// skipped); one K8f call three: the weights, the segments, the long rows'
// sums.

#include "rspmm_staged.cuh"

namespace {

using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::store_lanes;
namespace staged = rspmm::staged;
using staged::kRowInFlight;

// ---------------------------------------------------------------------------
// complex lanes
// ---------------------------------------------------------------------------

// (re, im) += (a (x) b) * w, or (conj(a) (x) b) * w with CONJ: the message
// first, then the weight, as the TPU kernel and the plain version form it
template <bool CONJ, int W>
__device__ __forceinline__ void cplx_accumulate(float (&re)[W],
                                                float (&im)[W],
                                                const Lanes<W>& ar,
                                                const Lanes<W>& ai,
                                                const Lanes<W>& br,
                                                const Lanes<W>& bi, float w) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (CONJ) {
      re[i] += (ar.v[i] * br.v[i] + ai.v[i] * bi.v[i]) * w;
      im[i] += (ar.v[i] * bi.v[i] - br.v[i] * ai.v[i]) * w;
    } else {
      re[i] += (ar.v[i] * br.v[i] - ai.v[i] * bi.v[i]) * w;
      im[i] += (ar.v[i] * bi.v[i] + br.v[i] * ai.v[i]) * w;
    }
  }
}

// ---------------------------------------------------------------------------
// K8f and K8b
// ---------------------------------------------------------------------------

// complex positions a slice (64 floats, staged::kSlice), W a thread in a
// stream of G threads: W = 4, G = 8 on the vector path, W = 1, G = 32 on
// the scalar one
constexpr int kPositions = staged::kSlice / 2;
// threads a CTA of K8f and the dx pass (rotate_seg_rows: 512, of up to 128
// registers, so that eight edges' gathered lanes are in flight a thread
// without spills) and of the dr pass (rotate_chunks), timed on the card
// (PERF.md)
constexpr int kRowsThreads = 512;
constexpr int kChunksThreads = 1024;

// 16-byte loads in flight a thread in a CTA of `threads` threads:
// kRowInFlight at 1,024 threads (64 registers each), twice as many at 512
__host__ __device__ constexpr int loads_in_flight(int threads) {
  return kRowInFlight * 1024 / threads;
}

// the offset of complex position p's real part in a row of blocks of
// 2 * half features (its imaginary part lies half further)
__device__ __forceinline__ int64_t position_offset(int p, int half) {
  return static_cast<int64_t>(p / half) * (2 * half) + p % half;
}

// s_rel[r * 2 * kPositions + c] = rel[r, real part of position p0 + c] and
// s_rel[r * 2 * kPositions + kPositions + c] = its imaginary part, for the
// slice's positions below F / 2, every relation, by the CTA's THREADS
// threads: in groups of W positions, kRowInFlight loads in flight a thread
template <int W, int G, int THREADS>
__device__ __forceinline__ void stage_rel(float* s_rel, const float* rel,
                                          int num_relations, int F, int half,
                                          int p0) {
  const int64_t F64 = F;
  const int n = num_relations * 2 * G;
  for (int i0 = threadIdx.x; i0 < n; i0 += kRowInFlight * THREADS) {
    Lanes<W> v[kRowInFlight];
#pragma unroll
    for (int u = 0; u < kRowInFlight; ++u) {
      const int i = i0 + u * THREADS, j = i % (2 * G);
      const int p = p0 + (j % G) * W;
      if (i < n && 2 * p < F) {
        v[u] = load_lanes<W>(rel + (i / (2 * G)) * F64 +
                             position_offset(p, half) + (j / G) * half);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowInFlight; ++u) {
      const int i = i0 + u * THREADS, j = i % (2 * G);
      if (i < n && 2 * (p0 + (j % G) * W) < F) {
        store_lanes<W>(s_rel + (i / (2 * G)) * (2 * kPositions) +
                           (j / G) * kPositions + (j % G) * W,
                       v[u].v);
      }
    }
  }
}

struct RotateRows {
  const int* seg_ptr;  // [S + 1] the rows' segments
  const int* seg_out;  // [S] row (>= 0) or ~partial slot
  const int* col;      // [E] the gathered row of each edge, in row order
  const int* etype;    // [E]
  const float* w;      // [E] each edge's weight, in row order
  const float* rel;    // [R, F]
  const float* x;      // [V_in, F] (K8b's dx pass: g)
  float* out;          // [V, F] (K8f's out, K8b's dx)
  float* partial;      // [P, F] the long rows' partial rows
  int num_segments;
  int num_edges;
  int num_relations;
  int num_features;
  int half;            // D / 2
};

// K8f: out[v, slice] = sum over the in-edges of v of (rel[r] (x) x[s]) * w
// over the destination rows' segments; K8b's dx pass (kConj):
// dx[s, slice] = sum over the out-edges of s of (conj(rel[r]) (x) g[v]) * w
// over the source rows' segments. staged_rows' pipeline (one stream of G
// threads a segment, the next iteration's edge metadata and the next
// segment loaded while an iteration's gathers are in flight)
template <int W, int G, bool kSharedRel, bool kConj>
__global__ void __launch_bounds__(kRowsThreads, 1)
rotate_seg_rows(RotateRows a) {
  static_assert(W * G == kPositions, "a stream covers a slice");
  // an edge gathers x's (g's) real and imaginary lanes (and rel's, unstaged)
  constexpr int kIn = loads_in_flight(kRowsThreads) / (kSharedRel ? 2 : 4);
  static_assert(kIn <= G, "a stream's lanes hold an iteration's edges");
  extern __shared__ float4 smem[];
  float* s_rel = reinterpret_cast<float*>(smem);
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int t = lane % G;  // this thread's place in its stream
  const int F = a.num_features;
  const int64_t F64 = F;
  const int p0 = blockIdx.y * kPositions;  // the slice's first position
  const bool on = 2 * (p0 + t * W) < F;   // (F / 2) % W == 0 on the vector path
  const int64_t re = on ? position_offset(p0 + t * W, a.half) : 0;
  const int64_t im = re + a.half;
  if constexpr (kSharedRel) {
    stage_rel<W, G, kRowsThreads>(s_rel, a.rel, a.num_relations, F, a.half,
                                  p0);
  }
  if (threadIdx.x == 0) {
    staged::claim_items(a.seg_ptr, a.num_segments, a.num_edges, s_range);
    s_next = s_range[0] + kRowsThreads / G;
  }
  __syncthreads();
  const int last = s_range[1];
  int item = min(s_range[0] + static_cast<int>(threadIdx.x) / G, last);
  int pos = 0, end = 0;
  if (item < last) {
    pos = __ldg(a.seg_ptr + item);
    end = __ldg(a.seg_ptr + item + 1);
  }
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
  float acc_re[W] = {};
  float acc_im[W] = {};
  while (__any_sync(0xffffffffu, item < last)) {
    const int n = item < last ? min(kIn, end - pos) : 0;
    Lanes<W> gr[kIn], gi[kIn];
    Lanes<W> rr[kSharedRel ? 1 : kIn], ri[kSharedRel ? 1 : kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int c = __shfl_sync(0xffffffffu, m_col, u, G);
      if constexpr (!kSharedRel) {
        const int r = __shfl_sync(0xffffffffu, m_type, u, G);
        if (on && u < n) {
          rr[u] = load_lanes<W>(a.rel + r * F64 + re);
          ri[u] = load_lanes<W>(a.rel + r * F64 + im);
        }
      }
      if (on && u < n) {
        gr[u] = load_lanes<W>(a.x + c * F64 + re);
        gi[u] = load_lanes<W>(a.x + c * F64 + im);
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
          const float* sr = s_rel + r * (2 * kPositions) + t * W;
          cplx_accumulate<kConj, W>(acc_re, acc_im,
                                    staged::load_shared<W>(sr),
                                    staged::load_shared<W>(sr + kPositions),
                                    gr[u], gi[u], we);
        }
      } else if (on && u < n) {
        cplx_accumulate<kConj, W>(acc_re, acc_im, rr[u], ri[u], gr[u], gi[u],
                                  we);
      }
    }
    if (done) {
      if (on) {
        const int d = __ldg(a.seg_out + item);
        float* o = d >= 0 ? a.out + d * F64 : a.partial + int64_t{~d} * F64;
        store_lanes<W>(o + re, acc_re);
        store_lanes<W>(o + im, acc_im);
      }
#pragma unroll
      for (int k = 0; k < W; ++k) acc_re[k] = acc_im[k] = 0.f;
    }
    item = new_item;
    pos = new_pos;
    end = new_end;
    m_col = c_col;
    m_type = c_type;
    m_w = c_w;
  }
}

struct RotateChunks {
  const int* chunk_ptr;   // [C + 1] the chunks' edge ranges (tile-major)
  const int* chunk_slot;  // [C] each chunk's partial row
  const int* src;         // [E] in tile order
  const int* dst;         // [E]
  const float* w;         // [E] each edge's weight, in tile order
  const float* x;         // [V, F]
  const float* g;         // [V, F]
  float* partial;         // [C, F]
  int num_chunks;
  int num_edges;
  int num_features;
  int half;               // D / 2
};

// partial[slot_c, slice] = sum over chunk c's edges of
// (conj(x[s]) (x) g[v]) * w: staged_chunks' warp a chunk (its 32 / G
// streams take every (32 / G)-th edge of a batch of 32, whose metadata the
// warp loads with one coalesced load each; the streams' sums combined by a
// fixed butterfly). The chunk's relation is not needed.
template <int W, int G>
__global__ void __launch_bounds__(kChunksThreads, 1)
rotate_chunks(RotateChunks a) {
  static_assert(W * G == kPositions, "a stream covers a slice");
  constexpr int kStreams = 32 / G;
  // an edge gathers x's and g's real and imaginary lanes
  constexpr int kIn = loads_in_flight(kChunksThreads) / 4;
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int stream = lane / G;
  const int F = a.num_features;
  const int64_t F64 = F;
  const int p = blockIdx.y * kPositions + (lane % G) * W;
  const bool on = 2 * p < F;
  const int64_t re = on ? position_offset(p, a.half) : 0;
  const int64_t im = re + a.half;
  if (threadIdx.x == 0) {
    staged::claim_items(a.chunk_ptr, a.num_chunks, a.num_edges, s_range);
    s_next = s_range[0] + kChunksThreads / 32;
  }
  __syncthreads();
  const int last = s_range[1];
  int item = s_range[0] + static_cast<int>(threadIdx.x >> 5);
  while (item < last) {
    const int begin = __ldg(a.chunk_ptr + item);
    const int end = __ldg(a.chunk_ptr + item + 1);
    float acc_re[W] = {};
    float acc_im[W] = {};
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
        Lanes<W> xr[kIn], xi[kIn], gr[kIn], gi[kIn];
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const int s = __shfl_sync(0xffffffffu, m_src, i);
          const int d = __shfl_sync(0xffffffffu, m_dst, i);
          if (on && i < n) {
            xr[u] = load_lanes<W>(a.x + s * F64 + re);
            xi[u] = load_lanes<W>(a.x + s * F64 + im);
            gr[u] = load_lanes<W>(a.g + d * F64 + re);
            gi[u] = load_lanes<W>(a.g + d * F64 + im);
          }
        }
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const float we = __shfl_sync(0xffffffffu, m_w, i);
          if (on && i < n) {
            cplx_accumulate<true, W>(acc_re, acc_im, xr[u], xi[u], gr[u],
                                     gi[u], we);
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
        acc_re[k] += __shfl_xor_sync(0xffffffffu, acc_re[k], off);
        acc_im[k] += __shfl_xor_sync(0xffffffffu, acc_im[k], off);
      }
    }
    if (on && stream == 0) {
      float* o = a.partial + __ldg(a.chunk_slot + item) * F64;
      store_lanes<W>(o + re, acc_re);
      store_lanes<W>(o + im, acc_im);
    }
    int next = 0;
    if (lane == 0) next = atomicAdd(&s_next, 1);
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

template <int W, int G, bool kSharedRel, bool kConj>
int rows_resident(size_t smem) {
  static staged::Occupancy occupancy;
  return occupancy.resident(rotate_seg_rows<W, G, kSharedRel, kConj>, smem,
                            kRowsThreads);
}

template <int W, int G>
int chunks_resident() {
  static staged::Occupancy occupancy;
  return occupancy.resident(rotate_chunks<W, G>, 0, kChunksThreads);
}

// the slices of a row of F features: kPositions complex positions each
staged::Plan slices(int num_features) {
  staged::Plan p;
  p.slice = 2 * kPositions;
  p.slices = (num_features / 2 + kPositions - 1) / kPositions;
  p.shared_rel = false;
  p.smem = 0;
  return p;
}

// the plan of rotate_seg_rows (K8f, or K8b's dx pass with kConj): rel in
// shared memory where it fits; the CTAs in flight gather the slices of
// gathered_rows rows (K8f's x, the dx pass's g)
template <bool kConj>
staged::Plan seg_plan(bool vec, int num_relations, int num_features,
                      int gathered_rows, int num_segments) {
  staged::Plan p = slices(num_features);
  const size_t rel_bytes = size_t{4} * p.slice * num_relations;
  p.shared_rel = rel_bytes <= size_t{staged::kRelSmemBytes};
  p.smem = p.shared_rel ? rel_bytes : 0;
  int resident;
  if (vec) {
    resident = p.shared_rel ? rows_resident<4, 8, true, kConj>(p.smem)
                            : rows_resident<4, 8, false, kConj>(0);
  } else {
    resident = p.shared_rel ? rows_resident<1, 32, true, kConj>(p.smem)
                            : rows_resident<1, 32, false, kConj>(0);
  }
  staged::plan_ctas(&p, resident, gathered_rows, num_segments,
                    kRowsThreads / 32);
  return p;
}

// the dr pass's plan: the CTAs in flight gather x's and g's slices
staged::Plan dr_plan(bool vec, int num_features, int num_rows,
                     int num_chunks) {
  staged::Plan p = slices(num_features);
  staged::plan_ctas(&p, vec ? chunks_resident<4, 8>() : chunks_resident<1, 32>(),
                    int64_t{2} * num_rows, num_chunks, kChunksThreads / 32);
  return p;
}

// rotate_seg_rows over a's segments by plan p, then long_row_sums over
// the long rows
template <bool kConj>
cudaError_t launch_seg_rows(bool vec, const staged::Plan& p,
                            const RotateRows& a, const int* long_rows,
                            const int* long_ptr, int num_long_rows,
                            cudaStream_t stream) {
  if (a.num_segments > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    if (vec && p.shared_rel) {
      rotate_seg_rows<4, 8, true, kConj>
          <<<grid, kRowsThreads, p.smem, stream>>>(a);
    } else if (vec) {
      rotate_seg_rows<4, 8, false, kConj>
          <<<grid, kRowsThreads, 0, stream>>>(a);
    } else if (p.shared_rel) {
      rotate_seg_rows<1, 32, true, kConj>
          <<<grid, kRowsThreads, p.smem, stream>>>(a);
    } else {
      rotate_seg_rows<1, 32, false, kConj>
          <<<grid, kRowsThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the partial rows are plain rows: summed 4 floats a thread where aligned
  return staged::launch_long_row_sums(vec, long_rows, long_ptr, num_long_rows,
                                      a.partial, a.out, a.num_features,
                                      stream);
}

cudaError_t launch_dr(bool vec, const staged::Plan& p, const RotateChunks& a,
                      const int* rel_ptr, int num_relations, float* dr,
                      cudaStream_t stream) {
  if (a.num_chunks > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    if (vec) {
      rotate_chunks<4, 8><<<grid, kChunksThreads, 0, stream>>>(a);
    } else {
      rotate_chunks<1, 32><<<grid, kChunksThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return staged::launch_relation_sums(vec, rel_ptr, num_relations, a.partial,
                                      dr, a.num_features, stream);
}

bool valid_dim(int num_features, int dim) {
  return dim > 0 && dim % 2 == 0 && num_features % dim == 0;
}

}  // namespace

// K8f, on K1's layouts and in rspmm_fwd_k1's argument order, with dim
// before the stream: the destination rows' segments (seg_ptr, seg_out,
// long_rows, long_ptr = Csr.seg_*, long_*) over the destination-sorted
// edges (src, etype, eid). w_scratch holds num_edges floats, partial
// long_ptr[num_long_rows] rows of F floats. dim is D, the width of one
// block (even, dividing num_features). Returns the first nonzero
// cudaGetLastError() code after a launch (0 on success); an invalid dim
// returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_rotate_fwd(const int* seg_ptr, const int* seg_out,
                                const int* long_rows, const int* long_ptr,
                                const int* src, const int* etype,
                                const int* eid, const float* weight,
                                const float* rel, const float* x, float* out,
                                float* w_scratch, float* partial,
                                int num_segments, int num_long_rows,
                                int num_edges, int num_relations,
                                int num_x_rows, int num_features, int dim,
                                void* stream) {
  using rspmm::aligned16;
  if (!valid_dim(num_features, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments <= 0 || num_features <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      staged::launch_gather_weights(eid, weight, w_scratch, num_edges, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (dim / 2) % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(out) && (partial == nullptr || aligned16(partial));
  const RotateRows a{seg_ptr,   seg_out,      src,       etype,
                     w_scratch, rel,          x,         out,
                     partial,   num_segments, num_edges, num_relations,
                     num_features, dim / 2};
  const staged::Plan p = seg_plan<false>(vec, num_relations, num_features,
                                         num_x_rows, num_segments);
  err = launch_seg_rows<false>(vec, p, a, long_rows, long_ptr, num_long_rows,
                               s);
  return static_cast<int>(err);
}

// How K8f lays out a call of this shape, written to out[0..4] as
// rspmm_k1_plan's: floats a slice (kPositions complex positions), 1 when
// the rel slice sits in shared memory, its bytes, the slices, the CTAs a
// slice; vec: 1 for the float4 path (D/2 % 4 == 0, operands aligned).
extern "C" int rspmm_rotate_fwd_plan(int vec, int num_relations,
                                     int num_features, int num_x_rows,
                                     int num_segments, int* out) {
  const staged::Plan p = seg_plan<false>(vec != 0, num_relations,
                                         num_features, num_x_rows,
                                         num_segments);
  out[0] = p.slice;
  out[1] = p.shared_rel ? 1 : 0;
  out[2] = static_cast<int>(p.smem);
  out[3] = p.slices;
  out[4] = p.ctas_per_slice;
  return static_cast<int>(cudaGetLastError());
}

// K8b, on K2's layouts and in rspmm_bwd's argument order, with dim last.
// The dx pass reads the source rows' segments (seg_ptr, seg_out, long_rows,
// long_ptr = Csr.src_seg_*, src_long_*) over the source-sorted edges
// (seg_dst, seg_etype, seg_eid = Csr.src_dst, src_etype, src_eid);
// dx_partial holds long_ptr[num_long_rows] rows of F floats. The dr pass
// reads the (destination tile, relation) chunks (chunk_ptr, chunk_slot,
// chunk_src, chunk_dst, chunk_eid, rel_ptr = Csr.tile_*); dr_partial holds
// one row of F floats per chunk. w_scratch holds 2 * num_edges floats.
// dx == nullptr skips the dx pass, dr == nullptr the dr pass. Returns the
// first nonzero cudaGetLastError() code after a launch (0 on success); an
// invalid dim returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_rotate_bwd(
    const int* seg_ptr, const int* seg_out, const int* seg_dst,
    const int* seg_etype, const int* seg_eid, const int* long_rows,
    const int* long_ptr, const int* chunk_ptr, const int* chunk_slot,
    const int* chunk_src, const int* chunk_dst, const int* chunk_eid,
    const int* rel_ptr, const float* weight, const float* rel,
    const float* x, const float* g, float* dx, float* dr, float* w_scratch,
    float* dx_partial, float* dr_partial, int num_rows, int num_segments,
    int num_long_rows, int num_chunks, int num_relations, int num_edges,
    int num_features, int dim, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_dim(num_features, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec =
      (dim / 2) % 4 == 0 && aligned16(rel) && aligned16(x) && aligned16(g) &&
      (dx == nullptr ||
       (aligned16(dx) && (dx_partial == nullptr || aligned16(dx_partial)))) &&
      (dr == nullptr || (aligned16(dr) && aligned16(dr_partial)));
  const int half = dim / 2;
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && num_segments > 0) {
    err = staged::launch_gather_weights(seg_eid, weight, w_scratch,
                                        num_edges, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const RotateRows a{seg_ptr,   seg_out,      seg_dst,      seg_etype,
                       w_scratch, rel,          g,            dx,
                       dx_partial, num_segments, num_edges,   num_relations,
                       num_features, half};
    const staged::Plan p =
        seg_plan<true>(vec, num_relations, num_features, num_rows,
                       num_segments);
    err = launch_seg_rows<true>(vec, p, a, long_rows, long_ptr, num_long_rows,
                                s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dr != nullptr && num_relations > 0) {
    float* w_tile = w_scratch + num_edges;
    err = staged::launch_gather_weights(chunk_eid, weight, w_tile, num_edges,
                                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const RotateChunks a{chunk_ptr, chunk_slot, chunk_src,  chunk_dst,
                         w_tile,    x,          g,          dr_partial,
                         num_chunks, num_edges, num_features, half};
    const staged::Plan p = dr_plan(vec, num_features, num_rows, num_chunks);
    err = launch_dr(vec, p, a, rel_ptr, num_relations, dr, s);
  }
  return static_cast<int>(err);
}

// How K8b lays out its passes at this shape, written to out[0..9] as
// rspmm_k2_plan's: the dx pass's floats a slice (kPositions complex
// positions), 1 when its rel slice sits in shared memory, its bytes,
// slices, CTAs a slice; then the dr pass's five.
extern "C" int rspmm_rotate_plan(int vec, int num_relations, int num_features,
                                 int num_rows, int num_segments,
                                 int num_chunks, int* out) {
  const staged::Plan plans[2] = {
      seg_plan<true>(vec != 0, num_relations, num_features, num_rows,
                     num_segments),
      dr_plan(vec != 0, num_features, num_rows, num_chunks)};
  for (int i = 0; i < 2; ++i) {
    out[5 * i] = plans[i].slice;
    out[5 * i + 1] = plans[i].shared_rel ? 1 : 0;
    out[5 * i + 2] = static_cast<int>(plans[i].smem);
    out[5 * i + 3] = plans[i].slices;
    out[5 * i + 4] = plans[i].ctas_per_slice;
  }
  return static_cast<int>(cudaGetLastError());
}
