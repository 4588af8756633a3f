// Relational SpMM forward, sum aggregation (kernel K1 of the port).
//
// Replaces the TPU kernel ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1
// in modes mul_rel / add_rel with agg add (reached through rspmm_fwd_pallas):
//
//     out[v, :] = sum over edges e = (s -> v, r) of  w[eid_e] * (rel[r, :] * x[s, :])   (mul_rel)
//                                                or  w[eid_e] * (rel[r, :] + x[s, :])   (add_rel)
//
// over a destination-sorted CSR (rowptr / src / etype / eid, all int32).
// Shapes: x [V_in, F], rel [R, F], w [E], out [V, F], fp32 in and fp32 out.
//
// What bounds it on an H100: the compulsory traffic is one read of x, rel and
// the edge arrays and one write of out; the work is 3 flops per edge and
// feature, so the function is memory-bound (about 12 flops per byte at the
// ULTRA entity-graph shape, below the card's 20 flops per byte fp32 balance
// point: 67 TFLOP/s over 3.35 TB/s). This design reads one x row per edge
// (E * F * 4 bytes, many times the x table), so its real limit is the gather
// traffic that misses L2, not the compulsory bytes.
//
// What the design does about it: one CTA per destination row and feature
// tile, the sum in registers, each row written once (rspmm_rows.cuh says
// how). Keeping x rows in shared memory or ordering rows for L2 reuse is the
// later redesign.

#include "rspmm_rows.cuh"

// mode: 0 = mul_rel (distmult), 1 = add_rel (transe). Returns the
// cudaGetLastError() code after the launch (0 on success); an unknown mode
// returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_fwd_k1(const int* rowptr, const int* src, const int* etype,
                            const int* eid, const float* weight,
                            const float* rel, const float* x, float* out,
                            int num_rows, int num_features, int mode,
                            void* stream) {
  using namespace rspmm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kMulRel && mode != kAddRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows > 0 && num_features > 0) {
    const bool vec = num_features % 4 == 0 && aligned16(rel) &&
                     aligned16(x) && aligned16(out);
    if (mode == kMulRel) {
      launch_row_gather<kMulRel>(vec, rowptr, src, etype, eid, weight, rel, x,
                                 out, num_rows, num_features, s);
    } else {
      launch_row_gather<kAddRel>(vec, rowptr, src, etype, eid, weight, rel, x,
                                 out, num_rows, num_features, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
