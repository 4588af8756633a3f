// Relational SpMM forward, sum aggregation (kernels K1 and K1h of the port).
//
// Replaces the TPU kernel ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1
// in modes mul_rel / add_rel with agg add (reached through rspmm_fwd_pallas):
//
//     out[v, :] = sum over edges e = (s -> v, r) of  w[eid_e] * (rel[r, :] * x[s, :])   (mul_rel)
//                                                or  w[eid_e] * (rel[r, :] + x[s, :])   (add_rel)
//
// over a destination-sorted CSR (rowptr / src / etype / eid, all int32).
// Shapes: x [V_in, F], rel [R, F], w [E], out [V, F]. K1 takes fp32 operands;
// K1h is the same function with compute_dtype=bfloat16 (rspmm_gather1 with
// bf16 operands, :1689-1724): rel and x arrive as bf16, each message is
// rounded to bf16 before the fp32 weight multiplies it, and the sum and the
// output stay fp32 (rspmm_rows.cuh says how the rounding matches).
//
// What bounds them on an H100: the compulsory traffic is one read of x, rel
// and the edge arrays and one write of out; the work is 3 flops per edge and
// feature, so the function is memory-bound (about 12 flops per byte at the
// ULTRA entity-graph shape, below the card's 20 flops per byte fp32 balance
// point: 67 TFLOP/s over 3.35 TB/s). A row gather reads one x row per edge
// (E * F * 4 bytes for K1, 8.1 GB at the training shape, many times the x
// table), so what a design reaches is set by where those gathers are
// served (the 50 MB L2 or the memory) and by which other bytes ride along.
//
// K1's first design ran one CTA per destination row and 256-thread
// feature tile, every edge loading col, eid, w[eid] and etype and then
// gathering an x row and a rel row. It took 2.05 ms at the training shape
// (16.3 GB of gathers at about 7.9 TB/s, from the L2), and 39.7 ms on
// bench.py's heavy-tailed KG, where one row of 107,150 edges walks serially
// on one CTA (NVIDIA H100 80GB HBM3, 700 W; PERF.md). K1h ran the same
// design with bf16 operands until it moved onto K1's.
//
// What K1's design does about it (rspmm_staged.cuh, the layouts
// data/graph.py's Csr.seg_* / long_*):
//  * hub-aware: a row of at most 256 edges is one segment, written straight
//    to its output row (rows without edges write 0); a longer row is cut
//    into 256-edge segments whose partial rows a second kernel sums in
//    segment order;
//  * the rel slice in shared memory: each CTA stages rel[:, slice] once, so
//    an edge gathers only its x row, half the gathered bytes (above the
//    shared-memory budget, large R, rel rows are gathered instead);
//  * metadata ahead of the gathers: each edge's weight is gathered through
//    eid once per call (gather_weights), and a 16-thread stream loads its
//    next 8 edges' (src, etype, w) with one coalesced load each while its
//    current gathers are in flight;
//  * narrow feature slices launched slice-major, so that the x slices
//    gathered by the CTAs in flight stay in the L2.
// Deterministic: each segment's sum is one warp's in a fixed order, the
// long rows' partials are added in segment order, no atomics on floats.
// One call makes up to three launches: the weights, the segments, the long
// rows' sums.
//
// K1h runs K1's passes with bf16 operands (rspmm_staged.cuh's In = bf16,
// as K2h's dx pass): 128-feature slices of 8 lanes a thread, the rel slice
// staged in bf16 (121 KB at R = 474; rel rows gathered above R = 906),
// gathers kept packed until used, and each message formed in bf16
// arithmetic (rounded once to bf16) before the fp32 weight multiplies it
// (rspmm_staged.cuh::accumulate_packed).

#include "rspmm_staged.cuh"

namespace {

// staged_rows over the destination rows' segments with operands of type In
// (K1: fp32, K1h: bf16), then long_row_sums; the arguments and the return
// as rspmm_fwd_k1's
template <typename In>
int run_k1(const int* seg_ptr, const int* seg_out, const int* long_rows,
           const int* long_ptr, const int* src, const int* etype,
           const int* eid, const float* weight, const In* rel, const In* x,
           float* out, float* w_scratch, float* partial, int num_segments,
           int num_long_rows, int num_edges, int num_relations,
           int num_x_rows, int num_features, int mode, cudaStream_t s) {
  using namespace rspmm;
  if (mode != kMulRel && mode != kAddRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments <= 0 || num_features <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err =
      staged::launch_gather_weights(eid, weight, w_scratch, num_edges, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const staged::Rows<In> a{seg_ptr,      seg_out,   src,
                           etype,        w_scratch, rel,
                           x,            out,       partial,
                           num_segments, num_edges, num_relations,
                           num_features};
  const bool vec = num_features % vec_lanes<In>() == 0 && aligned16(rel) &&
                   aligned16(x) && aligned16(out) &&
                   (partial == nullptr || aligned16(partial));
  if (mode == kMulRel) {
    const staged::Plan p = staged::rows_plan<kMulRel, In>(
        vec, num_relations, num_features, num_x_rows, num_segments);
    err = staged::launch_rows<kMulRel, In>(vec, p, a, long_rows, long_ptr,
                                           num_long_rows, s);
  } else {
    const staged::Plan p = staged::rows_plan<kAddRel, In>(
        vec, num_relations, num_features, num_x_rows, num_segments);
    err = staged::launch_rows<kAddRel, In>(vec, p, a, long_rows, long_ptr,
                                           num_long_rows, s);
  }
  return static_cast<int>(err);
}

// the plan of K1 (In = float) or K1h (bf16) at this shape, written to
// out[0..4] as rspmm_k1_plan says
template <typename In>
int write_plan(int vec, int num_relations, int num_features, int num_x_rows,
               int num_segments, int mode, int* out) {
  using namespace rspmm;
  const staged::Plan p =
      mode == kMulRel
          ? staged::rows_plan<kMulRel, In>(vec != 0, num_relations,
                                           num_features, num_x_rows,
                                           num_segments)
          : staged::rows_plan<kAddRel, In>(vec != 0, num_relations,
                                           num_features, num_x_rows,
                                           num_segments);
  out[0] = p.slice;
  out[1] = p.shared_rel ? 1 : 0;
  out[2] = static_cast<int>(p.smem);
  out[3] = p.slices;
  out[4] = p.ctas_per_slice;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, fp32 operands. mode: 0 = mul_rel (distmult), 1 = add_rel (transe).
// The destination rows' segments (Csr.seg_ptr, seg_out, long_rows,
// long_ptr) over the destination-sorted edges (src, etype, eid).
// w_scratch holds num_edges floats, partial long_ptr[num_long_rows] rows of
// F floats. Returns the first nonzero cudaGetLastError() code after a
// launch (0 on success); an unknown mode returns cudaErrorInvalidValue
// without launching.
extern "C" int rspmm_fwd_k1(const int* seg_ptr, const int* seg_out,
                            const int* long_rows, const int* long_ptr,
                            const int* src, const int* etype, const int* eid,
                            const float* weight, const float* rel,
                            const float* x, float* out, float* w_scratch,
                            float* partial, int num_segments,
                            int num_long_rows, int num_edges,
                            int num_relations, int num_x_rows,
                            int num_features, int mode, void* stream) {
  return run_k1<float>(seg_ptr, seg_out, long_rows, long_ptr, src, etype,
                       eid, weight, rel, x, out, w_scratch, partial,
                       num_segments, num_long_rows, num_edges, num_relations,
                       num_x_rows, num_features, mode,
                       static_cast<cudaStream_t>(stream));
}

// K1h: K1 with bf16 rel and x (fp32 weight, partial rows and out), in
// rspmm_fwd_k1's argument order, layouts and return.
extern "C" int rspmm_fwd_k1h(const int* seg_ptr, const int* seg_out,
                             const int* long_rows, const int* long_ptr,
                             const int* src, const int* etype,
                             const int* eid, const float* weight,
                             const __nv_bfloat16* rel,
                             const __nv_bfloat16* x, float* out,
                             float* w_scratch, float* partial,
                             int num_segments, int num_long_rows,
                             int num_edges, int num_relations,
                             int num_x_rows, int num_features, int mode,
                             void* stream) {
  return run_k1<rspmm::bf16>(seg_ptr, seg_out, long_rows, long_ptr, src,
                             etype, eid, weight, rel, x, out, w_scratch,
                             partial, num_segments, num_long_rows, num_edges,
                             num_relations, num_x_rows, num_features, mode,
                             static_cast<cudaStream_t>(stream));
}

// How K1 lays out a call of this shape (the plan of rspmm_staged.cuh),
// written to out[0..4]: features a slice, 1 when the rel slice sits in
// shared memory (0: rel rows gathered), its bytes, the slices, the CTAs a
// slice. vec: 1 for the 16-byte path (F % 4 == 0 and aligned operands).
extern "C" int rspmm_k1_plan(int vec, int num_relations, int num_features,
                             int num_x_rows, int num_segments, int mode,
                             int* out) {
  return write_plan<float>(vec, num_relations, num_features, num_x_rows,
                           num_segments, mode, out);
}

// K1h's plan, as rspmm_k1_plan's; vec: 1 for the 16-byte path (F % 8 == 0
// and aligned operands).
extern "C" int rspmm_k1h_plan(int vec, int num_relations, int num_features,
                              int num_x_rows, int num_segments, int mode,
                              int* out) {
  return write_plan<rspmm::bf16>(vec, num_relations, num_features,
                                 num_x_rows, num_segments, mode, out);
}
