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
// What the design does about it:
//  * one CTA per destination row (and per feature tile when F / 4 > 256);
//    threads run across the feature dimension, so every row gather is one
//    coalesced 16-byte-per-thread load (float4 when F % 4 == 0 and the
//    pointers are 16-byte aligned, a scalar path otherwise);
//  * the sum lives in registers and each output row is written exactly once:
//    no atomics, no memset (rows without edges write 0), deterministic;
//  * the edge metadata of a row (src, etype, w[eid]) is the same for every
//    thread, so it is read once per warp as a broadcast load;
//  * the edge loop is unrolled by 4, so four independent row gathers are in
//    flight per thread instead of one dependent load at a time.
// Keeping x rows in shared memory or ordering rows for L2 reuse is the later
// redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMulRel = 0;
constexpr int kAddRel = 1;
constexpr int kMaxThreads = 256;

template <int MODE>
__device__ __forceinline__ float message(float r, float xv) {
  return MODE == kMulRel ? r * xv : r + xv;
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
rspmm_fwd_vec4(const int* __restrict__ rowptr, const int* __restrict__ src,
               const int* __restrict__ etype, const int* __restrict__ eid,
               const float* __restrict__ weight,
               const float4* __restrict__ rel, const float4* __restrict__ x,
               float4* __restrict__ out, int nvec) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= nvec) return;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t s = __ldg(src + e);
    const int64_t r = __ldg(etype + e);
    const float w = __ldg(weight + __ldg(eid + e));
    const float4 xv = __ldg(x + s * nvec + j);
    const float4 rv = __ldg(rel + r * nvec + j);
    acc.x += message<MODE>(rv.x, xv.x) * w;
    acc.y += message<MODE>(rv.y, xv.y) * w;
    acc.z += message<MODE>(rv.z, xv.z) * w;
    acc.w += message<MODE>(rv.w, xv.w) * w;
  }
  out[static_cast<int64_t>(v) * nvec + j] = acc;
}

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
rspmm_fwd_scalar(const int* __restrict__ rowptr, const int* __restrict__ src,
                 const int* __restrict__ etype, const int* __restrict__ eid,
                 const float* __restrict__ weight,
                 const float* __restrict__ rel, const float* __restrict__ x,
                 float* __restrict__ out, int nfeat) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= nfeat) return;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  float acc = 0.f;
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t s = __ldg(src + e);
    const int64_t r = __ldg(etype + e);
    const float w = __ldg(weight + __ldg(eid + e));
    acc += message<MODE>(__ldg(rel + r * nfeat + j), __ldg(x + s * nfeat + j)) * w;
  }
  out[static_cast<int64_t>(v) * nfeat + j] = acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int MODE>
void launch(const int* rowptr, const int* src, const int* etype, const int* eid,
            const float* weight, const float* rel, const float* x, float* out,
            int num_rows, int num_features, cudaStream_t stream) {
  const bool vec = num_features % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(out);
  const int n = vec ? num_features / 4 : num_features;
  const int threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  const dim3 grid(num_rows, (n + threads - 1) / threads);
  if (vec) {
    rspmm_fwd_vec4<MODE><<<grid, threads, 0, stream>>>(
        rowptr, src, etype, eid, weight, reinterpret_cast<const float4*>(rel),
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n);
  } else {
    rspmm_fwd_scalar<MODE><<<grid, threads, 0, stream>>>(
        rowptr, src, etype, eid, weight, rel, x, out, n);
  }
}

}  // namespace

// mode: 0 = mul_rel (distmult), 1 = add_rel (transe). Returns the
// cudaGetLastError() code after the launch (0 on success); an unknown mode
// returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_fwd_k1(const int* rowptr, const int* src, const int* etype,
                            const int* eid, const float* weight,
                            const float* rel, const float* x, float* out,
                            int num_rows, int num_features, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_rows > 0 && num_features > 0) {
    if (mode == kMulRel) {
      launch<kMulRel>(rowptr, src, etype, eid, weight, rel, x, out, num_rows,
                      num_features, s);
    } else if (mode == kAddRel) {
      launch<kAddRel>(rowptr, src, etype, eid, weight, rel, x, out, num_rows,
                      num_features, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
