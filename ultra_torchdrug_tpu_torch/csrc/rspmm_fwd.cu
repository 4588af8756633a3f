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
// point: 67 TFLOP/s over 3.35 TB/s). This design reads one x row per edge
// (E * F * 4 bytes for K1, E * F * 2 for K1h, many times the x table), so
// its real limit is the gather traffic that misses L2, not the compulsory
// bytes; K1h halves that traffic.
//
// What the design does about it: one CTA per destination row and feature
// tile, the sum in registers, each row written once (rspmm_rows.cuh says
// how); K1h reads 8 bf16 lanes per 16-byte load and widens them in
// registers. Keeping x rows in shared memory or ordering rows for L2 reuse
// is the later redesign. The TPU kernel pads bf16 rows to multiples of 1024
// features for its (16, 128) memory tiling; that has no numeric effect and
// is not copied.

#include "rspmm_rows.cuh"

namespace {

template <typename In>
int launch_fwd(const int* rowptr, const int* src, const int* etype,
               const int* eid, const float* weight, const In* rel,
               const In* x, float* out, int num_rows, int num_features,
               int mode, cudaStream_t stream) {
  using namespace rspmm;
  if (mode != kMulRel && mode != kAddRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows > 0 && num_features > 0) {
    const bool vec = num_features % vec_lanes<In>() == 0 && aligned16(rel) &&
                     aligned16(x) && aligned16(out);
    if (mode == kMulRel) {
      launch_row_gather<kMulRel, In>(vec, rowptr, src, etype, eid, weight,
                                     rel, x, out, num_rows, num_features,
                                     stream);
    } else {
      launch_row_gather<kAddRel, In>(vec, rowptr, src, etype, eid, weight,
                                     rel, x, out, num_rows, num_features,
                                     stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, fp32 operands. mode: 0 = mul_rel (distmult), 1 = add_rel (transe).
// Returns the cudaGetLastError() code after the launch (0 on success); an
// unknown mode returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_fwd_k1(const int* rowptr, const int* src, const int* etype,
                            const int* eid, const float* weight,
                            const float* rel, const float* x, float* out,
                            int num_rows, int num_features, int mode,
                            void* stream) {
  return launch_fwd<float>(rowptr, src, etype, eid, weight, rel, x, out,
                           num_rows, num_features, mode,
                           static_cast<cudaStream_t>(stream));
}

// K1h, bf16 rel and x, fp32 weight and out; modes and return as for K1.
extern "C" int rspmm_fwd_k1h(const int* rowptr, const int* src,
                             const int* etype, const int* eid,
                             const float* weight, const __nv_bfloat16* rel,
                             const __nv_bfloat16* x, float* out, int num_rows,
                             int num_features, int mode, void* stream) {
  return launch_fwd<__nv_bfloat16>(rowptr, src, etype, eid, weight, rel, x,
                                   out, num_rows, num_features, mode,
                                   static_cast<cudaStream_t>(stream));
}
