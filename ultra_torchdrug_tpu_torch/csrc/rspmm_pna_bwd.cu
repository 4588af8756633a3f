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
// (0.121 ms): all are bytes-bound. A design gathers rows per edge: the
// planes at the destination for dx, x and the planes for dr (one gathered
// row of every edge is 4.06 GB at that shape), so where those gathers are
// served (the 50 MB L2 or the memory) and how many it makes set its time.
//
// K6b, K7b and K5 run K2's staged design (rspmm_staged.cuh, the layouts
// data/graph.py's Csr.src_seg_* / src_long_* and tile_*), the same two
// passes with their own planes and per-edge body (a kind):
//  * dx pass over the source rows' 256-edge segments (long rows through
//    partial rows that long_row_sums adds in segment order), slice-major in
//    64-feature slices, one 16-thread stream a segment, the rel slice in
//    shared memory (121 KB at R = 474; rel rows gathered above R = 906). A
//    segment has one source row, so its x slice sits in registers and each
//    edge gathers only its destination's plane slices (K5: g and out, as
//    K7b's g_s and g_sq, with K6b's gate on one extremum);
//  * dr pass over the (destination tile, relation) chunks, one warp a
//    chunk, the chunk's rel slice in registers; each edge gathers x[s] and
//    the planes at its destination, which are sorted, so one warp's loads
//    share rows; partial rows go to their slots, which relation_sums adds in
//    slot order;
//  * both passes read each edge's weight from a copy gathered once per call
//    in their order (gather_weights);
//  * the dx pass runs 512-thread CTAs of 128 registers a thread, so that
//    four edges' planes (16 floats each for K6b) are in flight a stream
//    without spills, the dr pass 1,024-thread CTAs (at 1,024 threads the
//    dx pass spilled and took 3.06 ms against 2.54 at the classic NBFNet
//    training shape on an NVIDIA H100, PERF.md §6). K5, with K7b's two
//    planes, takes the same split.
//    Loading K6b's extrema first and g_mx or g_mn only where a gate passes
//    (89 % of those loads skip on the uniform training KG) was timed and
//    dropped: its dependent second round of loads cost more than the bytes
//    it saved, but on the uniform KG's dr pass.
// Deterministic: every sum is one stream's or one warp's in a fixed order,
// then partials in a fixed order; no float atomics, so two calls give
// bitwise-equal dx and dr. One call makes up to six launches: the weights
// of each pass, the dx segments, the long rows' sums, the dr chunks, the
// relation sums (a half whose output pointer is null is skipped).

#include "rspmm_staged.cuh"

namespace {

using rspmm::kAddRel;
using rspmm::kMulRel;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::message;
using rspmm::store_lanes;
namespace staged = rspmm::staged;

// the kinds of rspmm_pna_bwd
constexpr int kArgextPair = 0;  // K6b: planes g_mx, mx, g_mn, mn
constexpr int kMoments = 1;     // K7b: planes g_s, g_sq
constexpr int kArgext = 2;      // K5: planes g, out

// ---------------------------------------------------------------------------
// K6b, K7b and K5
// ---------------------------------------------------------------------------

// threads a CTA of the dx pass (pna_rows: 512, of 128 registers, so that
// four K6b edges' planes are in flight a thread without spills) and of the
// dr pass (pna_chunks), timed on the card (PERF.md)
constexpr int kRowsThreads = 512;
constexpr int kChunksThreads = 1024;

// the largest power of two that is at most n (n >= 1)
__host__ __device__ constexpr int pow2_floor(int n) {
  return n >= 2 ? 2 * pow2_floor(n / 2) : 1;
}

// the plane rows an edge holds: K6b four, K7b and K5 two
template <int KIND>
__host__ __device__ constexpr int num_planes() {
  return KIND == kArgextPair ? 4 : 2;
}

// edges in flight a stream in a CTA of `threads` threads: kRowInFlight
// rows a thread at 1,024 threads (64 registers each), twice as many at 512,
// over the rows an edge holds, its planes and `extra` (a rel row, or x)
template <int KIND>
__host__ __device__ constexpr int edges_in_flight(int threads, int extra) {
  return pow2_floor(staged::kRowInFlight * 1024 / threads /
                    (num_planes<KIND>() + extra));
}

// an edge's plane slices at its destination: K6b p0..p3 = g_mx, mx, g_mn,
// mn; K7b p0, p1 = g_s, g_sq; K5 p0, p1 = g, out
template <int W>
struct Planes {
  Lanes<W> p0, p1, p2, p3;
};

// an edge's plane slices (q: the planes, off: the destination row's
// offset plus the thread's first feature)
template <int KIND, int W>
__device__ __forceinline__ void load_planes(Planes<W>& q,
                                            const float* const* planes,
                                            int64_t off) {
  q.p0 = load_lanes<W>(planes[0] + off);
  q.p1 = load_lanes<W>(planes[1] + off);
  if constexpr (KIND == kArgextPair) {
    q.p2 = load_lanes<W>(planes[2] + off);
    q.p3 = load_lanes<W>(planes[3] + off);
  }
}

// acc += rel * c (the dx pass, DX) or x * c (the dr pass), or c for
// add_rel, lane by lane, with c as the header says; K6b's and K5's gates
// recompute K6's and K4's message bit for bit
template <int KIND, int MODE, bool DX, int W>
__device__ __forceinline__ void accumulate_edge(float (&acc)[W],
                                                const Lanes<W>& r,
                                                const Lanes<W>& xv, float w,
                                                const Planes<W>& q) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float c;
    if constexpr (KIND == kArgextPair) {
      const float m = message<MODE>(r.v[k], xv.v[k]) * w;
      const float c_mx = m == q.p1.v[k] ? q.p0.v[k] * w : 0.f;
      const float c_mn = m == q.p3.v[k] ? q.p2.v[k] * w : 0.f;
      c = c_mx + c_mn;
    } else if constexpr (KIND == kArgext) {
      const float m = message<MODE>(r.v[k], xv.v[k]) * w;
      c = m == q.p1.v[k] ? q.p0.v[k] * w : 0.f;
    } else {
      const float m = r.v[k] * xv.v[k];
      c = q.p0.v[k] * w + (2.f * m) * (q.p1.v[k] * w);
    }
    if constexpr (MODE == kAddRel) {
      acc[k] += c;
    } else {
      acc[k] += (DX ? r.v[k] : xv.v[k]) * c;
    }
  }
}

struct PnaRows {
  const int* seg_ptr;    // [S + 1] the source rows' segments
  const int* seg_out;    // [S] row (>= 0) or ~partial slot
  const int* long_rows;  // [L] the rows cut into several segments
  const int* long_ptr;   // [L + 1] their partial slots
  const int* dst;        // [E] each edge's destination, source order
  const int* etype;      // [E]
  const float* w;        // [E] each edge's weight, source order
  const float* rel;      // [R, F]
  const float* x;        // [V, F]
  const float* planes[4];
  float* out;            // dx [V, F]
  float* partial;        // [P, F] the long rows' partial rows
  int num_segments;
  int num_long_rows;
  int num_edges;
  int num_relations;
  int num_features;
};

// the source row of segment i: seg_out[i], or for a segment of a long row
// the row whose partial slots hold ~seg_out[i]
__device__ __forceinline__ int segment_row(const PnaRows& a, int i) {
  const int d = __ldg(a.seg_out + i);
  if (d >= 0) return d;
  return __ldg(a.long_rows + staged::lower_bound(a.long_ptr + 1,
                                                 a.num_long_rows, ~d + 1));
}

// dx[s, slice] = sum over the out-edges of s of rel[r, slice] * c (c for
// add_rel), over the source rows' segments: staged_rows' pipeline (one
// stream of G threads a segment, the next iteration's edge metadata and the
// next segment loaded while an iteration's gathers are in flight), with the
// segment's x slice in registers, loaded for the next segment with its
// metadata
template <int KIND, int MODE, int W, int G, bool kSharedRel>
__global__ void __launch_bounds__(kRowsThreads, 1) pna_rows(PnaRows a) {
  constexpr int S = W * G;
  constexpr int kIn =
      edges_in_flight<KIND>(kRowsThreads, kSharedRel ? 0 : 1);
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
    staged::stage_rel<W, G, kRowsThreads>(s_rel, a.rel, a.num_relations, F,
                                          f0);
  }
  if (threadIdx.x == 0) {
    staged::claim_items(a.seg_ptr, a.num_segments, a.num_edges, s_range);
    s_next = s_range[0] + kRowsThreads / G;
  }
  __syncthreads();
  const int last = s_range[1];
  int item = min(s_range[0] + static_cast<int>(threadIdx.x) / G, last);
  int pos = 0, end = 0;
  Lanes<W> xs = {};
  if (item < last) {
    pos = __ldg(a.seg_ptr + item);
    end = __ldg(a.seg_ptr + item + 1);
    if (on) xs = load_lanes<W>(a.x + segment_row(a, item) * F64 + f);
  }
  int next = staged::draw_item<G>(&s_next, true, lane, last);
  int next_begin = 0, next_end = 0, next_row = 0;
  if (next < last) {
    next_begin = __ldg(a.seg_ptr + next);
    next_end = __ldg(a.seg_ptr + next + 1);
    next_row = segment_row(a, next);
  }
  // lane t < kIn of the stream holds edge pos + t
  int m_col = 0, m_type = 0;
  float m_w = 0.f;
  if (t < kIn && pos + t < end) {
    m_col = __ldg(a.dst + pos + t);
    m_type = __ldg(a.etype + pos + t);
    m_w = __ldg(a.w + pos + t);
  }
  float acc[W] = {};
  while (__any_sync(0xffffffffu, item < last)) {
    const int n = item < last ? min(kIn, end - pos) : 0;
    Planes<W> q[kIn];
    Lanes<W> rv[kSharedRel ? 1 : kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int d = __shfl_sync(0xffffffffu, m_col, u, G);
      if constexpr (!kSharedRel) {
        const int r = __shfl_sync(0xffffffffu, m_type, u, G);
        if (on && u < n) rv[u] = load_lanes<W>(a.rel + r * F64 + f);
      }
      if (on && u < n) load_planes<KIND, W>(q[u], a.planes, d * F64 + f);
    }
    // where this stream goes next: on in its item, or to the next item,
    // whose successor is drawn and whose edge range and row are loaded now,
    // and the new item's x slice
    const bool done = item < last && pos + kIn >= end;
    int new_item = item, new_pos = pos + kIn, new_end = end;
    Lanes<W> x_new = {};
    if (done) {
      new_item = next;
      new_pos = next_begin;
      new_end = next_end;
      if (on && next < last) x_new = load_lanes<W>(a.x + next_row * F64 + f);
    }
    const int drawn = staged::draw_item<G>(&s_next, done && next < last,
                                           lane, last);
    if (done) {
      next = drawn;
      if (next < last) {
        next_begin = __ldg(a.seg_ptr + next);
        next_end = __ldg(a.seg_ptr + next + 1);
        next_row = segment_row(a, next);
      }
    }
    int c_col = 0, c_type = 0;
    float c_w = 0.f;
    if (new_item < last && t < kIn && new_pos + t < new_end) {
      c_col = __ldg(a.dst + new_pos + t);
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
          accumulate_edge<KIND, MODE, true, W>(
              acc, staged::load_shared<W>(s_rel + r * S + (f - f0)), xs, we,
              q[u]);
        }
      } else if (on && u < n) {
        accumulate_edge<KIND, MODE, true, W>(acc, rv[u], xs, we, q[u]);
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
      xs = x_new;
    }
    item = new_item;
    pos = new_pos;
    end = new_end;
    m_col = c_col;
    m_type = c_type;
    m_w = c_w;
  }
}

struct PnaChunks {
  const int* chunk_ptr;   // [C + 1] the chunks' edge ranges (tile-major)
  const int* chunk_slot;  // [C] each chunk's partial row
  const int* chunk_rel;   // [C] each chunk's relation
  const int* src;         // [E] in tile order
  const int* dst;         // [E]
  const float* w;         // [E] each edge's weight, in tile order
  const float* rel;       // [R, F]
  const float* x;         // [V, F]
  const float* planes[4];
  float* partial;         // [C, F]
  int num_chunks;
  int num_edges;
  int num_features;
};

// partial[slot_c, slice] = sum over chunk c's edges of x[s, slice] * c (c
// for add_rel): staged_chunks' warp a chunk (its 32 / G streams take every
// (32 / G)-th edge of a batch of 32, whose metadata the warp loads with one
// coalesced load each; the streams' sums combined by a fixed butterfly),
// with the chunk's rel slice in registers
template <int KIND, int MODE, int W, int G>
__global__ void __launch_bounds__(kChunksThreads, 1)
pna_chunks(PnaChunks a) {
  constexpr int kStreams = 32 / G;
  constexpr int kIn = edges_in_flight<KIND>(kChunksThreads, 1);  // and x
  __shared__ int s_range[2];
  __shared__ int s_next;
  const int lane = threadIdx.x & 31;
  const int stream = lane / G;
  const int F = a.num_features;
  const int64_t F64 = F;
  const int f = blockIdx.y * (W * G) + (lane % G) * W;
  const bool on = f < F;
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
    const int64_t r = __ldg(a.chunk_rel + item);
    Lanes<W> rv = {};
    if (on) rv = load_lanes<W>(a.rel + r * F64 + f);
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
        Lanes<W> xv[kIn];
        Planes<W> q[kIn];
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const int s = __shfl_sync(0xffffffffu, m_src, i);
          const int d = __shfl_sync(0xffffffffu, m_dst, i);
          if (on && i < n) {
            xv[u] = load_lanes<W>(a.x + s * F64 + f);
            load_planes<KIND, W>(q[u], a.planes, d * F64 + f);
          }
        }
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int i = (u0 + u) * kStreams + stream;
          const float we = __shfl_sync(0xffffffffu, m_w, i);
          if (on && i < n) {
            accumulate_edge<KIND, MODE, false, W>(acc, rv, xv[u], we, q[u]);
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

template <int KIND, int MODE, int W, int G, bool kSharedRel>
int rows_resident(size_t smem) {
  static staged::Occupancy occupancy;
  return occupancy.resident(pna_rows<KIND, MODE, W, G, kSharedRel>, smem,
                            kRowsThreads);
}

template <int KIND, int MODE, int W, int G>
int chunks_resident() {
  static staged::Occupancy occupancy;
  return occupancy.resident(pna_chunks<KIND, MODE, W, G>, 0,
                            kChunksThreads);
}

// the dx pass's plan: rel in shared memory where it fits; the CTAs in
// flight gather the planes' slices
template <int KIND, int MODE>
staged::Plan dx_plan(bool vec, int num_relations, int num_features,
                     int num_rows, int num_segments) {
  staged::Plan p;
  p.slice = vec ? staged::kSlice : staged::kScalarSlice;
  p.slices = (num_features + p.slice - 1) / p.slice;
  const size_t rel_bytes = size_t{4} * p.slice * num_relations;
  p.shared_rel = rel_bytes <= size_t{staged::kRelSmemBytes};
  p.smem = p.shared_rel ? rel_bytes : 0;
  constexpr int G4 = staged::kSlice / 4;
  int resident;
  if (vec) {
    resident = p.shared_rel ? rows_resident<KIND, MODE, 4, G4, true>(p.smem)
                            : rows_resident<KIND, MODE, 4, G4, false>(0);
  } else {
    resident = p.shared_rel ? rows_resident<KIND, MODE, 1, 32, true>(p.smem)
                            : rows_resident<KIND, MODE, 1, 32, false>(0);
  }
  staged::plan_ctas(&p, resident, int64_t{num_planes<KIND>()} * num_rows,
                    num_segments, kRowsThreads / 32);
  return p;
}

// the dr pass's plan: the CTAs in flight gather x's and the planes' slices
template <int KIND, int MODE>
staged::Plan dr_plan(bool vec, int num_features, int num_rows,
                     int num_chunks) {
  staged::Plan p;
  p.slice = vec ? staged::kSlice : staged::kScalarSlice;
  p.slices = (num_features + p.slice - 1) / p.slice;
  p.shared_rel = false;
  p.smem = 0;
  const int resident = vec
      ? chunks_resident<KIND, MODE, 4, staged::kSlice / 4>()
      : chunks_resident<KIND, MODE, 1, 32>();
  staged::plan_ctas(&p, resident,
                    int64_t{num_planes<KIND>() + 1} * num_rows, num_chunks,
                    kChunksThreads / 32);
  return p;
}

template <int KIND, int MODE>
cudaError_t launch_dx(bool vec, const staged::Plan& p, const PnaRows& a,
                      cudaStream_t stream) {
  if (a.num_segments > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    constexpr int G4 = staged::kSlice / 4;
    if (vec && p.shared_rel) {
      pna_rows<KIND, MODE, 4, G4, true>
          <<<grid, kRowsThreads, p.smem, stream>>>(a);
    } else if (vec) {
      pna_rows<KIND, MODE, 4, G4, false>
          <<<grid, kRowsThreads, 0, stream>>>(a);
    } else if (p.shared_rel) {
      pna_rows<KIND, MODE, 1, 32, true>
          <<<grid, kRowsThreads, p.smem, stream>>>(a);
    } else {
      pna_rows<KIND, MODE, 1, 32, false>
          <<<grid, kRowsThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return staged::launch_long_row_sums(vec, a.long_rows, a.long_ptr,
                                      a.num_long_rows, a.partial, a.out,
                                      a.num_features, stream);
}

template <int KIND, int MODE>
cudaError_t launch_dr(bool vec, const staged::Plan& p, const PnaChunks& a,
                      const int* rel_ptr, int num_relations, float* dr,
                      cudaStream_t stream) {
  if (a.num_chunks > 0) {
    const dim3 grid(p.ctas_per_slice, p.slices);
    if (vec) {
      pna_chunks<KIND, MODE, 4, staged::kSlice / 4>
          <<<grid, kChunksThreads, 0, stream>>>(a);
    } else {
      pna_chunks<KIND, MODE, 1, 32><<<grid, kChunksThreads, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return staged::launch_relation_sums(vec, rel_ptr, num_relations, a.partial,
                                      dr, a.num_features, stream);
}

struct PnaArgs {
  const int *seg_ptr, *seg_out, *seg_dst, *seg_etype, *seg_eid, *long_rows,
      *long_ptr;
  const int *chunk_ptr, *chunk_slot, *chunk_rel, *chunk_src, *chunk_dst,
      *chunk_eid, *rel_ptr;
  const float *weight, *rel, *x, *q0, *q1, *q2, *q3;
  float *dx, *dr, *w_scratch, *dx_partial, *dr_partial;
  int num_rows, num_segments, num_long_rows, num_chunks, num_relations,
      num_edges, num_features;
};

template <int KIND, int MODE>
cudaError_t launch_pna(bool vec, const PnaArgs& a, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (a.dx != nullptr && a.num_segments > 0) {
    err = staged::launch_gather_weights(a.seg_eid, a.weight, a.w_scratch,
                                        a.num_edges, s);
    if (err != cudaSuccess) return err;
    const PnaRows rows{a.seg_ptr,       a.seg_out,    a.long_rows,
                       a.long_ptr,      a.seg_dst,    a.seg_etype,
                       a.w_scratch,     a.rel,        a.x,
                       {a.q0, a.q1, a.q2, a.q3},      a.dx,
                       a.dx_partial,    a.num_segments, a.num_long_rows,
                       a.num_edges,     a.num_relations, a.num_features};
    const staged::Plan p = dx_plan<KIND, MODE>(
        vec, a.num_relations, a.num_features, a.num_rows, a.num_segments);
    err = launch_dx<KIND, MODE>(vec, p, rows, s);
    if (err != cudaSuccess) return err;
  }
  if (a.dr != nullptr && a.num_relations > 0) {
    float* w_tile = a.w_scratch + a.num_edges;
    err = staged::launch_gather_weights(a.chunk_eid, a.weight, w_tile,
                                        a.num_edges, s);
    if (err != cudaSuccess) return err;
    const PnaChunks chunks{a.chunk_ptr, a.chunk_slot, a.chunk_rel,
                           a.chunk_src, a.chunk_dst,  w_tile,
                           a.rel,       a.x,          {a.q0, a.q1, a.q2, a.q3},
                           a.dr_partial, a.num_chunks, a.num_edges,
                           a.num_features};
    const staged::Plan p =
        dr_plan<KIND, MODE>(vec, a.num_features, a.num_rows, a.num_chunks);
    err = launch_dr<KIND, MODE>(vec, p, chunks, a.rel_ptr, a.num_relations,
                                a.dr, s);
  }
  return err;
}

bool known(int kind, int mode) {
  return (kind == kMoments && mode == kMulRel) ||
         ((kind == kArgextPair || kind == kArgext) &&
          (mode == kMulRel || mode == kAddRel));
}

}  // namespace

// K6b, K7b and K5. kind: 0 = argext_pair (K6b; planes q0..q3 = g_mx, mx,
// g_mn, mn), 1 = moments (K7b; q0, q1 = g_s, g_sq; q2, q3 unused), 2 =
// argext (K5; q0, q1 = g, out, the saved max or min; q2, q3 unused). mode:
// 0 = mul_rel, 1 = add_rel (K6b and K5). The dx pass reads the source rows'
// segments (seg_ptr, seg_out, long_rows, long_ptr = Csr.src_seg_*,
// src_long_*) over the source-sorted edges (seg_dst, seg_etype, seg_eid =
// Csr.src_dst, src_etype, src_eid); dx_partial holds
// long_ptr[num_long_rows] rows of F floats. The dr pass reads the
// (destination tile, relation) chunks (chunk_ptr, chunk_slot, chunk_rel,
// chunk_src, chunk_dst, chunk_eid, rel_ptr = Csr.tile_*); dr_partial holds
// one row of F floats per chunk. w_scratch holds 2 * num_edges floats.
// dx == nullptr skips the dx pass, dr == nullptr the dr pass. Returns the
// first nonzero cudaGetLastError() code after a launch (0 on success); an
// unknown kind or mode, or K7b with add_rel, returns cudaErrorInvalidValue
// without launching.
extern "C" int rspmm_pna_bwd(
    int kind, int mode, const int* seg_ptr, const int* seg_out,
    const int* seg_dst, const int* seg_etype, const int* seg_eid,
    const int* long_rows, const int* long_ptr, const int* chunk_ptr,
    const int* chunk_slot, const int* chunk_rel, const int* chunk_src,
    const int* chunk_dst, const int* chunk_eid, const int* rel_ptr,
    const float* weight, const float* rel, const float* x, const float* q0,
    const float* q1, const float* q2, const float* q3, float* dx, float* dr,
    float* w_scratch, float* dx_partial, float* dr_partial, int num_rows,
    int num_segments, int num_long_rows, int num_chunks, int num_relations,
    int num_edges, int num_features, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known(kind, mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const PnaArgs a{seg_ptr,      seg_out,      seg_dst,      seg_etype,
                  seg_eid,      long_rows,    long_ptr,     chunk_ptr,
                  chunk_slot,   chunk_rel,    chunk_src,    chunk_dst,
                  chunk_eid,    rel_ptr,      weight,       rel,
                  x,            q0,           q1,           q2,
                  q3,           dx,           dr,           w_scratch,
                  dx_partial,   dr_partial,   num_rows,     num_segments,
                  num_long_rows, num_chunks,  num_relations, num_edges,
                  num_features};
  const bool vec =
      num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
      aligned16(q0) && aligned16(q1) &&
      (kind != kArgextPair || (aligned16(q2) && aligned16(q3))) &&
      (dx == nullptr ||
       (aligned16(dx) && (dx_partial == nullptr || aligned16(dx_partial)))) &&
      (dr == nullptr || (aligned16(dr) && aligned16(dr_partial)));
  cudaError_t err;
  if (kind == kMoments) {
    err = launch_pna<kMoments, kMulRel>(vec, a, s);
  } else if (kind == kArgext) {
    err = mode == kMulRel ? launch_pna<kArgext, kMulRel>(vec, a, s)
                          : launch_pna<kArgext, kAddRel>(vec, a, s);
  } else if (mode == kMulRel) {
    err = launch_pna<kArgextPair, kMulRel>(vec, a, s);
  } else {
    err = launch_pna<kArgextPair, kAddRel>(vec, a, s);
  }
  return static_cast<int>(err);
}

// How K6b (kind 0), K7b (kind 1) or K5 (kind 2) lays out its passes at
// this shape, written to out[0..9] as rspmm_k2_plan's: the dx pass's
// features a slice, 1 when its rel slice sits in shared memory, its bytes,
// slices, CTAs a slice; then the dr pass's five.
extern "C" int rspmm_pna_plan(int kind, int mode, int vec, int num_relations,
                              int num_features, int num_rows,
                              int num_segments, int num_chunks, int* out) {
  if (!known(kind, mode)) return static_cast<int>(cudaErrorInvalidValue);
  staged::Plan plans[2];
  const bool v = vec != 0;
  if (kind == kMoments) {
    plans[0] = dx_plan<kMoments, kMulRel>(v, num_relations, num_features,
                                          num_rows, num_segments);
    plans[1] = dr_plan<kMoments, kMulRel>(v, num_features, num_rows,
                                          num_chunks);
  } else if (kind == kArgext && mode == kMulRel) {
    plans[0] = dx_plan<kArgext, kMulRel>(v, num_relations, num_features,
                                         num_rows, num_segments);
    plans[1] = dr_plan<kArgext, kMulRel>(v, num_features, num_rows,
                                         num_chunks);
  } else if (kind == kArgext) {
    plans[0] = dx_plan<kArgext, kAddRel>(v, num_relations, num_features,
                                         num_rows, num_segments);
    plans[1] = dr_plan<kArgext, kAddRel>(v, num_features, num_rows,
                                         num_chunks);
  } else if (mode == kMulRel) {
    plans[0] = dx_plan<kArgextPair, kMulRel>(v, num_relations, num_features,
                                             num_rows, num_segments);
    plans[1] = dr_plan<kArgextPair, kMulRel>(v, num_features, num_rows,
                                             num_chunks);
  } else {
    plans[0] = dx_plan<kArgextPair, kAddRel>(v, num_relations, num_features,
                                             num_rows, num_segments);
    plans[1] = dr_plan<kArgextPair, kAddRel>(v, num_features, num_rows,
                                             num_chunks);
  }
  for (int i = 0; i < 2; ++i) {
    out[5 * i] = plans[i].slice;
    out[5 * i + 1] = plans[i].shared_rel ? 1 : 0;
    out[5 * i + 2] = static_cast<int>(plans[i].smem);
    out[5 * i + 3] = plans[i].slices;
    out[5 * i + 4] = plans[i].ctas_per_slice;
  }
  return static_cast<int>(cudaGetLastError());
}
