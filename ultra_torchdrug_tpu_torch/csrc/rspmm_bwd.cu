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
// and dr are fp32. It runs K2's two passes (below) with bf16 operands, 8
// lanes a 16-byte load, which halves the gathered bytes.
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
// K2's first design (K2h's too) ran the forward's row loop over
// the source rows (one CTA per row and 256-thread feature tile, a rel and a
// g row gathered per edge) and relation chunks of up to 256 edges in
// original order, whose x and g rows lay anywhere, in 256-thread tiles whose
// two 59.6 MB passes the L2 cannot hold together. It took 6.29 ms at the
// training shape, K2h 3.03 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
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
// built. K2h's passes are the same kernels with bf16 operands
// (rspmm_staged.cuh: slices of kBf16RowsSlice and kBf16ChunksSlice
// features, the rel slice staged in bf16, the gathered lanes packed until
// used), each product rel * (g * w) or x * (g * w) in fp32.

#include "rspmm_staged.cuh"

namespace {

namespace staged = rspmm::staged;

// K2's passes (MODE kMulRel, fp32 operands) or K2h's (kMulScaled, bf16), in
// rspmm_bwd's argument order
template <int MODE, typename In>
int run_passes(const int* seg_ptr, const int* seg_out, const int* seg_dst,
               const int* seg_etype, const int* seg_eid, const int* long_rows,
               const int* long_ptr, const int* chunk_ptr,
               const int* chunk_slot, const int* chunk_src,
               const int* chunk_dst, const int* chunk_eid, const int* rel_ptr,
               const float* weight, const In* rel, const In* x, const In* g,
               float* dx, float* dr, float* w_scratch, float* dx_partial,
               float* dr_partial, int num_rows, int num_segments,
               int num_long_rows, int num_chunks, int num_relations,
               int num_edges, int num_features, cudaStream_t s) {
  using rspmm::aligned16;
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec =
      num_features % rspmm::vec_lanes<In>() == 0 && aligned16(rel) &&
      aligned16(x) && aligned16(g) &&
      (dx == nullptr ||
       (aligned16(dx) && (dx_partial == nullptr || aligned16(dx_partial)))) &&
      (dr == nullptr || (aligned16(dr) && aligned16(dr_partial)));
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && num_segments > 0) {
    err = staged::launch_gather_weights(seg_eid, weight, w_scratch,
                                        num_edges, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const staged::Rows<In> a{seg_ptr,    seg_out,      seg_dst,   seg_etype,
                             w_scratch,  rel,          g,         dx,
                             dx_partial, num_segments, num_edges, num_relations,
                             num_features};
    const staged::Plan p = staged::rows_plan<MODE, In>(
        vec, num_relations, num_features, num_rows, num_segments);
    err = staged::launch_rows<MODE, In>(vec, p, a, long_rows, long_ptr,
                                        num_long_rows, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dr != nullptr && num_relations > 0) {
    float* w_tile = w_scratch + num_edges;
    err = staged::launch_gather_weights(chunk_eid, weight, w_tile, num_edges,
                                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const staged::Chunks<In> a{chunk_ptr,  chunk_slot, chunk_src,  chunk_dst,
                               w_tile,     x,          g,          dr_partial,
                               num_chunks, num_edges,  num_features};
    const staged::Plan p = staged::chunks_plan<In>(
        vec, num_features, int64_t{2} * num_rows, num_chunks);
    err = staged::launch_chunks<In>(vec, p, a, rel_ptr, num_relations, dr, s);
  }
  return static_cast<int>(err);
}

// How K2 (or K2h) lays out its passes at this shape, written to out[0..9]:
// the dx pass's features a slice, 1 when its rel slice sits in shared
// memory, its bytes, slices, CTAs a slice; then the dr pass's five.
template <int MODE, typename In>
int write_plans(int vec, int num_relations, int num_features, int num_rows,
                int num_segments, int num_chunks, int* out) {
  const staged::Plan plans[2] = {
      staged::rows_plan<MODE, In>(vec != 0, num_relations, num_features,
                                  num_rows, num_segments),
      staged::chunks_plan<In>(vec != 0, num_features, int64_t{2} * num_rows,
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
  return run_passes<rspmm::kMulRel, float>(
      seg_ptr, seg_out, seg_dst, seg_etype, seg_eid, long_rows, long_ptr,
      chunk_ptr, chunk_slot, chunk_src, chunk_dst, chunk_eid, rel_ptr,
      weight, rel, x, g, dx, dr, w_scratch, dx_partial, dr_partial, num_rows,
      num_segments, num_long_rows, num_chunks, num_relations, num_edges,
      num_features, static_cast<cudaStream_t>(stream));
}

// How K2 lays out its passes at this shape (rspmm_staged.cuh's plans),
// written to out[0..9]: the dx pass's features a slice, 1 when its rel
// slice sits in shared memory, its bytes, slices, CTAs a slice; then the
// dr pass's five, as rspmm_k1_plan's.
extern "C" int rspmm_k2_plan(int vec, int num_relations, int num_features,
                             int num_rows, int num_segments, int num_chunks,
                             int* out) {
  return write_plans<rspmm::kMulRel, float>(vec, num_relations, num_features,
                                            num_rows, num_segments,
                                            num_chunks, out);
}

// K2h: K2 (mul_rel) with bf16 rel, x and g, fp32 weight, dx, dr and partial
// rows:
//     dx[s, :] = sum over e = (s -> v, r) of  rel[r, :] * (g[v, :] * w[eid_e])
//     dr[r, :] = sum over e with type r   of  x[s_e, :] * (g[v_e, :] * w[eid_e])
// the products in fp32 from the widened bf16 values, g * w formed first, as
// rspmm_pallas.py's bf16 backward does (:659-666, :798-805). K2's layouts,
// scratch, arguments, null outputs and return; the 16-byte path needs
// F % 8 == 0.
extern "C" int rspmm_bwd_k2h(
    const int* seg_ptr, const int* seg_out, const int* seg_dst,
    const int* seg_etype, const int* seg_eid, const int* long_rows,
    const int* long_ptr, const int* chunk_ptr, const int* chunk_slot,
    const int* chunk_src, const int* chunk_dst, const int* chunk_eid,
    const int* rel_ptr, const float* weight, const rspmm::bf16* rel,
    const rspmm::bf16* x, const rspmm::bf16* g, float* dx, float* dr,
    float* w_scratch, float* dx_partial, float* dr_partial, int num_rows,
    int num_segments, int num_long_rows, int num_chunks, int num_relations,
    int num_edges, int num_features, void* stream) {
  return run_passes<rspmm::kMulScaled, rspmm::bf16>(
      seg_ptr, seg_out, seg_dst, seg_etype, seg_eid, long_rows, long_ptr,
      chunk_ptr, chunk_slot, chunk_src, chunk_dst, chunk_eid, rel_ptr,
      weight, rel, x, g, dx, dr, w_scratch, dx_partial, dr_partial, num_rows,
      num_segments, num_long_rows, num_chunks, num_relations, num_edges,
      num_features, static_cast<cudaStream_t>(stream));
}

// How K2h lays out its passes at this shape, as rspmm_k2_plan; vec: 1 for
// the 16-byte path (F % 8 == 0 and aligned operands).
extern "C" int rspmm_k2h_plan(int vec, int num_relations, int num_features,
                              int num_rows, int num_segments, int num_chunks,
                              int* out) {
  return write_plans<rspmm::kMulScaled, rspmm::bf16>(
      vec, num_relations, num_features, num_rows, num_segments, num_chunks,
      out);
}
