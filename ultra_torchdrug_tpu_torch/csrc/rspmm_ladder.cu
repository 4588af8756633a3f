// A strip-down ladder of K1 (rspmm_fwd.cu): variants of the relational
// SpMM forward row kernel, each without one per-edge ingredient or with one
// changed, timed side by side to read off what each ingredient costs. It is
// the card's counterpart of the TPU probes P1 and P2:
//
//   script/diagnostics/kernel_floor.py::run_variant (pallas_call :350,
//     bodies make_kernel :36) on a synthetic hub workload, and
//   script/diagnostics/blocked_ladder.py::main (pallas_call :333, :370) on
//     bench.py's heavy-tailed KG.
//
// ultra_torchdrug_tpu_torch/diagnostics/{kernel_floor,blocked_ladder}.py run
// it; nothing on the model's path calls it. Every variant computes a defined
// function (out [V, F] fp32 over K1's destination-sorted CSR, x [V_in, F],
// rel [R, F], w [E] in original edge order), held against its plain version
// in ops/rspmm_ladder_cuda.py:
//
//   id variant   TPU origin                     out[v] =
//    0 full      v0_current, b0_full            sum w[eid]·rel[r]⊙x[s]  (K1's
//                                               row_gather itself)
//    1 noweight  v2_noscalar                    sum rel[r]⊙x[s]  (no eid, w)
//    2 norel     b4_norel                       sum w·x[s]  (K1's row_gather
//                                               with K3's kNone message)
//    3 statrow   b2_statrow                     sum w·rel[r]⊙x[0]
//    4 floor     v4_pure_fma, b5_floor          sum w·x[0]
//    5 multiacc  v3_multiacc4, b6_nosum         full, 4 accumulator sets
//    6 packed    v6_packed, v8_direct_packed    full from (src << shift |
//                                               etype) and w in CSR order
//    7 direct    v7_direct                      full by one float atomicAdd
//                                               per edge and feature
//    8 drrmw     v5_drrmw                       full, and dr[r] += w·rel⊙x
//                                               by atomics into [R, F]
//    9 nowrite   b1_noflush, b7_nochain         full, stored only if `write`
//   10 split     the TPU's edge-chunked grid    full from row segments of at
//                                               most 256 edges, summed in
//                                               order by a second pass
//   11 ftile     b10a/b10b_fsplit               full with 64-thread feature
//                                               tiles (4x the CTAs per row)
//
// statrow and floor still load each edge's source and mask it with a
// runtime 0 (`gather_mask`), as the TPU's packed word still carried it: they
// remove the random gather, not the metadata load. nowrite's store is behind
// the runtime flag `write` or a sum of the lanes equal to `never` (NaN from
// the wrapper), so the compiler has to keep every load and product.
//
// TPU ingredients with no counterpart here, and so no variant: the flush
// branch of the telescoping row sum (v1_nobranch; K1 keeps each row's sum in
// registers and has no flush), the VMEM stream-buffer slot (b3_statbuf), the
// per-slice VMEM marks of b10a, and the hot-source VMEM residency of P2's
// layout (hot_rows=1024), which the card's 50 MB L2 gives without a layout:
// statrow measures what gathers from anywhere but row 0 cost.
//
// What bounds them on an H100: as K1, the compulsory bytes (x, rel, edges,
// out) over 3.35 TB/s against 3 fp32 operations per edge and feature over
// 67 TFLOP/s; the design reads one x row per edge. The variants change the
// per-edge work, not that bound: their times against K1's bound say which
// ingredient holds the row loop back. direct and drrmw are the only float
// atomics in the port and exist to measure them.

#include "rspmm_rows.cuh"

namespace {

using namespace rspmm;

// variant ids, in the order of ops/rspmm_ladder_cuda.py::VARIANTS
constexpr int kFull = 0;
constexpr int kNoWeight = 1;
constexpr int kNoRel = 2;
constexpr int kStatRow = 3;
constexpr int kFloor = 4;
constexpr int kMultiAcc = 5;
constexpr int kPacked = 6;
constexpr int kDirect = 7;
constexpr int kDrRmw = 8;
constexpr int kNoWrite = 9;
constexpr int kSplit = 10;
constexpr int kFtile = 11;

constexpr int kSets = 4;          // multiacc's accumulator sets
constexpr int kFtileThreads = 64;  // ftile's CTA width
constexpr int kDirectEdges = 8;    // direct's edges per CTA

// The per-edge loads of all variants, as the metadata of one edge.
struct Edge {
  int64_t src;
  int64_t etype;
  float w;
};

template <int VARIANT>
__device__ __forceinline__ Edge load_edge(int e, const int* col,
                                          const int* etype, const int* eid,
                                          const float* weight, int gather_mask,
                                          int shift) {
  Edge m{0, 0, 1.f};
  if constexpr (VARIANT == kPacked) {
    const int word = __ldg(col + e);
    m.src = word >> shift;
    m.etype = word & ((1 << shift) - 1);
    m.w = __ldg(weight + e);  // w already in CSR order: no eid hop
    return m;
  }
  m.src = __ldg(col + e);
  if constexpr (VARIANT == kStatRow || VARIANT == kFloor) {
    m.src &= gather_mask;
  }
  if constexpr (VARIANT != kFloor) m.etype = __ldg(etype + e);
  if constexpr (VARIANT != kNoWeight) m.w = __ldg(weight + __ldg(eid + e));
  return m;
}

// acc += one edge's term, lane by lane
template <int VARIANT, int W>
__device__ __forceinline__ void add_edge(float (&acc)[W], const Edge& m,
                                         const float* rel, const float* x,
                                         float* dr, int64_t width,
                                         int64_t lane) {
  const Lanes<W> xv = load_lanes<W>(x + m.src * width + lane);
  if constexpr (VARIANT == kFloor) {
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] += xv.v[k] * m.w;
    return;
  }
  const Lanes<W> rv = load_lanes<W>(rel + m.etype * width + lane);
  if constexpr (VARIANT == kNoWeight) {
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] += rv.v[k] * xv.v[k];
  } else if constexpr (VARIANT == kDrRmw) {
    float* d = dr + m.etype * width + lane;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float t = message<kMulRel>(rv.v[k], xv.v[k]) * m.w;
      acc[k] += t;
      atomicAdd(d + k, t);
    }
  } else {
    accumulate<kMulRel, float, W>(acc, rv, xv, m.w);
  }
}

// One CTA per output row and feature tile, as K1's row_gather, for the
// variants that change its row loop: noweight, statrow, floor, multiacc,
// packed, drrmw, nowrite.
template <int VARIANT, int W>
__global__ void __launch_bounds__(kMaxThreads)
ladder_row(const int* __restrict__ rowptr, const int* __restrict__ col,
           const int* __restrict__ etype, const int* __restrict__ eid,
           const float* __restrict__ weight, const float* __restrict__ rel,
           const float* __restrict__ x, float* __restrict__ out,
           float* __restrict__ dr, int n, int gather_mask, int shift,
           int write, float never) {
  constexpr int kAcc = VARIANT == kMultiAcc ? kSets : 1;
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  float acc[kAcc][W] = {};
  if constexpr (kAcc == 1) {
#pragma unroll 4
    for (int e = begin; e < end; ++e) {
      add_edge<VARIANT, W>(acc[0], load_edge<VARIANT>(e, col, etype, eid,
                                                      weight, gather_mask,
                                                      shift),
                           rel, x, dr, width, lane);
    }
  } else {
    // edge e + s goes to set s: kAcc independent sums in flight
    int e = begin;
    for (; e + kAcc <= end; e += kAcc) {
#pragma unroll
      for (int s = 0; s < kAcc; ++s) {
        add_edge<VARIANT, W>(acc[s], load_edge<VARIANT>(e + s, col, etype,
                                                        eid, weight,
                                                        gather_mask, shift),
                             rel, x, dr, width, lane);
      }
    }
    for (; e < end; ++e) {
      add_edge<VARIANT, W>(acc[0], load_edge<VARIANT>(e, col, etype, eid,
                                                      weight, gather_mask,
                                                      shift),
                           rel, x, dr, width, lane);
    }
  }
  float total[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    total[k] = acc[0][k];
#pragma unroll
    for (int s = 1; s < kAcc; ++s) total[k] += acc[s][k];
  }
  if constexpr (VARIANT == kNoWrite) {
    float lanes = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) lanes += total[k];
    if (!write && !(lanes == never)) return;
  }
  store_lanes<W>(out + static_cast<int64_t>(v) * width + lane, total);
}

// direct: kDirectEdges consecutive edges of the destination-sorted order per
// CTA and feature tile; every edge adds its term into out[dst[e]] with one
// atomicAdd per feature (out zeroed by the caller). No row loop, no sum in
// registers; the order of the additions changes from run to run.
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
edge_scatter(const int* __restrict__ dst, const int* __restrict__ col,
             const int* __restrict__ etype, const int* __restrict__ eid,
             const float* __restrict__ weight, const float* __restrict__ rel,
             const float* __restrict__ x, float* __restrict__ out, int n,
             int num_edges) {
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int first = blockIdx.x * kDirectEdges;
  const int last = min(first + kDirectEdges, num_edges);
  for (int e = first; e < last; ++e) {
    const Edge m = load_edge<kFull>(e, col, etype, eid, weight, -1, 0);
    const Lanes<W> xv = load_lanes<W>(x + m.src * width + lane);
    const Lanes<W> rv = load_lanes<W>(rel + m.etype * width + lane);
    float* o = out + static_cast<int64_t>(__ldg(dst + e)) * width + lane;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      atomicAdd(o + k, message<kMulRel>(rv.v[k], xv.v[k]) * m.w);
    }
  }
}

template <int VARIANT>
void launch_ladder_row(bool vec, const int* rowptr, const int* col,
                       const int* etype, const int* eid, const float* weight,
                       const float* rel, const float* x, float* out, float* dr,
                       int num_rows, int num_features, int gather_mask,
                       int shift, int write, float never,
                       cudaStream_t stream) {
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_rows, tiles);
  if (vec) {
    ladder_row<VARIANT, 4><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, dr, n, gather_mask,
        shift, write, never);
  } else {
    ladder_row<VARIANT, 1><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, dr, n, gather_mask,
        shift, write, never);
  }
}

// K1's row_gather (MODE kMulRel: full, split's first pass, ftile; kNone:
// norel) with CTAs of `width` threads at most
template <int MODE>
void launch_rows(bool vec, int width, const int* rowptr, const int* col,
                 const int* etype, const int* eid, const float* weight,
                 const float* rel, const float* x, float* out, int num_rows,
                 int num_features, cudaStream_t stream) {
  const int n = vec ? num_features / 4 : num_features;
  const int threads = n >= width ? width : ((n + 31) / 32) * 32;
  const dim3 grid(num_rows, (n + threads - 1) / threads);
  if (vec) {
    row_gather<MODE, float, 4><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, n);
  } else {
    row_gather<MODE, float, 1><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, n);
  }
}

void launch_direct(bool vec, const int* dst, const int* col, const int* etype,
                   const int* eid, const float* weight, const float* rel,
                   const float* x, float* out, int num_features,
                   int num_edges, cudaStream_t stream) {
  if (num_edges == 0) return;
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  feature_tiles(n, &threads, &tiles);
  const dim3 grid((num_edges + kDirectEdges - 1) / kDirectEdges, tiles);
  if (vec) {
    edge_scatter<4><<<grid, threads, 0, stream>>>(
        dst, col, etype, eid, weight, rel, x, out, n, num_edges);
  } else {
    edge_scatter<1><<<grid, threads, 0, stream>>>(
        dst, col, etype, eid, weight, rel, x, out, n, num_edges);
  }
}

// split: row_gather over the segments (seg_ptr is a CSR over segments of the
// same edge arrays) into partial [S, F], then each row's segments summed in
// order (relation_sums over row_seg_ptr; rows without a segment write 0)
int launch_split(bool vec, const int* seg_ptr, const int* row_seg_ptr,
                 const int* col, const int* etype, const int* eid,
                 const float* weight, const float* rel, const float* x,
                 float* partial, float* out, int num_rows, int num_segments,
                 int num_features, cudaStream_t stream) {
  if (num_segments > 0) {
    launch_rows<kMulRel>(vec, kMaxThreads, seg_ptr, col, etype, eid, weight,
                         rel, x, partial, num_segments, num_features, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_rows, tiles);
  if (vec) {
    relation_sums<float4><<<grid, threads, 0, stream>>>(
        row_seg_ptr, reinterpret_cast<const float4*>(partial),
        reinterpret_cast<float4*>(out), n);
  } else {
    relation_sums<float><<<grid, threads, 0, stream>>>(row_seg_ptr, partial,
                                                       out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One variant of the ladder (ids above). rowptr / col / etype / eid / weight
// are K1's CSR and weights; packed: col holds (src << shift | etype) and
// weight the weights in CSR order. scratch is drrmw's dr [R, F] (zeroed by
// the caller) or split's partial [num_segments, F]; dst (direct) is each
// CSR edge's row; seg_ptr / row_seg_ptr / num_segments are split's segments.
// out is zeroed by the caller for direct. Pointers a variant does not read
// may be null. Returns the first nonzero cudaGetLastError() code after a
// launch (0 on success); an unknown variant returns cudaErrorInvalidValue
// without launching.
extern "C" int rspmm_ladder(int variant, const int* rowptr, const int* col,
                            const int* etype, const int* eid,
                            const float* weight, const float* rel,
                            const float* x, float* out, float* scratch,
                            const int* dst, const int* seg_ptr,
                            const int* row_seg_ptr, int num_rows,
                            int num_features, int num_edges, int num_segments,
                            int shift, int write, float never, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant < kFull || variant > kFtile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0 || num_features == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(out) && (scratch == nullptr || aligned16(scratch));
  switch (variant) {
    case kFull:
      launch_rows<kMulRel>(vec, kMaxThreads, rowptr, col, etype, eid, weight,
                           rel, x, out, num_rows, num_features, s);
      break;
    case kNoRel:
      launch_rows<kNone>(vec, kMaxThreads, rowptr, col, etype, eid, weight,
                         rel, x, out, num_rows, num_features, s);
      break;
    case kFtile:
      launch_rows<kMulRel>(vec, kFtileThreads, rowptr, col, etype, eid,
                           weight, rel, x, out, num_rows, num_features, s);
      break;
    case kDirect:
      launch_direct(vec, dst, col, etype, eid, weight, rel, x, out,
                    num_features, num_edges, s);
      break;
    case kSplit:
      return launch_split(vec, seg_ptr, row_seg_ptr, col, etype, eid, weight,
                          rel, x, scratch, out, num_rows, num_segments,
                          num_features, s);
#define LADDER_ROW(ID, MASK)                                                 \
  case ID:                                                                   \
    launch_ladder_row<ID>(vec, rowptr, col, etype, eid, weight, rel, x, out, \
                          scratch, num_rows, num_features, MASK, shift,      \
                          write, never, s);                                  \
    break;
      LADDER_ROW(kNoWeight, -1)
      LADDER_ROW(kStatRow, 0)
      LADDER_ROW(kFloor, 0)
      LADDER_ROW(kMultiAcc, -1)
      LADDER_ROW(kPacked, -1)
      LADDER_ROW(kDrRmw, -1)
      LADDER_ROW(kNoWrite, -1)
#undef LADDER_ROW
  }
  return static_cast<int>(cudaGetLastError());
}
