// Row-gather device code shared by the rspmm kernels (row_gather serves
// the K1 ladder in rspmm_ladder.cu, fp32 operands; the Lanes helpers,
// message, accumulate, relation_sums and long_row_sums also serve K1, K1h,
// K2 and K2h in rspmm_staged.cuh, K3 in rspmm_transe_bwd.cu, K4, K6/K7 and
// K5, K6b/K7b in rspmm_pna_*.cu and K8f/K8b in rspmm_rotate.cu):
//
//     out[v, :] = sum over e in [rowptr[v], rowptr[v+1]) of
//                 w[eid[e]] * msg(rel[etype[e], :], x[col[e], :])
//
// with msg = rel * x (kMulRel), rel + x (kAddRel), x alone (kNone, the
// transe backward's message: neither rel nor etype is read), or
// rel * (x * w) with the weight applied to x first (kMulScaled, the bf16
// backward's order: rspmm_pallas.py forms gw = g * w, then rel * gw),
// over a CSR (int32 rowptr / col / etype / eid) and operand rows of width F.
//
// Operands are fp32 or bf16 (__nv_bfloat16, the compute_dtype=bfloat16 mode
// of K1h and K2h, whose staged kernels gather them: rspmm_staged.cuh); every
// sum is kept in fp32 and every output is fp32.
//
// row_gather: one CTA per output row and per feature tile of up to 256
// threads; threads run across the feature dimension, W lanes each, so every
// row gather is one coalesced load of 16 bytes a thread (W = 4, a float4)
// when F % W == 0 and every row pointer is 16-byte aligned, else a scalar
// path (W = 1). The sum lives in registers and each output row is written
// exactly once: no atomics, no memset (rows without edges write 0), and the
// edge order within a row fixes the result bitwise. The edge metadata of a
// row is the same for every thread, so it is read once per warp as a
// broadcast load; the edge loop is unrolled by 4 so that four independent
// row gathers are in flight per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace rspmm {

constexpr int kMulRel = 0;
constexpr int kAddRel = 1;
constexpr int kNone = 2;      // the row alone (the transe backward's message)
constexpr int kMulScaled = 3;  // rel * (x * w), unrounded (K2h's passes)
constexpr int kMaxThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 ld(const float4* p) { return __ldg(p); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// the message of one lane from fp32 values
template <int MODE>
__device__ __forceinline__ float message(float r, float xv) {
  if constexpr (MODE == kMulRel) {
    return r * xv;
  } else if constexpr (MODE == kAddRel) {
    return r + xv;
  } else {
    return xv;
  }
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// dr[r, :] = sum over c in [rel_chunk_ptr[r], rel_chunk_ptr[r+1]) of
//            partial[c, :], in chunk order (the second kernel of the
//            backward kernels' segmented dr reduction)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
relation_sums(const int* __restrict__ rel_chunk_ptr,
              const T* __restrict__ partial, T* __restrict__ dr, int n) {
  const int r = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int begin = __ldg(rel_chunk_ptr + r);
  const int end = __ldg(rel_chunk_ptr + r + 1);
  T acc = zero<T>();
  for (int c = begin; c < end; ++c) {
    add_to(acc, ld(partial + static_cast<int64_t>(c) * n + j));
  }
  dr[static_cast<int64_t>(r) * n + j] = acc;
}

// out[rows[l], :] = sum over p in [ptr[l], ptr[l+1]) of partial[p, :], in
// order: the second kernel of the hub-aware row passes (K1 and K2 in
// rspmm_staged.cuh, K3's dx pass), which sums the partial rows of each row
// cut into several segments. A hub row of 10^5 edges has 400 and more
// partial rows, so the loop is unrolled for its loads to overlap.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
long_row_sums(const int* __restrict__ rows, const int* __restrict__ ptr,
              const T* __restrict__ partial, T* __restrict__ out, int n) {
  const int l = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int begin = __ldg(ptr + l);
  const int end = __ldg(ptr + l + 1);
  T acc = zero<T>();
#pragma unroll 8
  for (int p = begin; p < end; ++p) {
    add_to(acc, ld(partial + static_cast<int64_t>(p) * n + j));
  }
  out[static_cast<int64_t>(__ldg(rows + l)) * n + j] = acc;
}

// W consecutive lanes of a row, as fp32 values in registers. fp32 rows: W = 4
// is one 16-byte float4 access (the pointer 16-byte aligned), W = 1 one
// float. bf16 rows (widen_lanes, rspmm_staged.cuh's widen): W = 8 is one
// 16-byte uint4 access, W = 1 one element; a bf16 value is the upper half
// of the fp32 value it widens to.
template <int W>
struct Lanes {
  float v[W];
};

template <int W>
__device__ __forceinline__ Lanes<W> load_lanes(const float* p) {
  Lanes<W> out;
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = t.x;
    out.v[1] = t.y;
    out.v[2] = t.z;
    out.v[3] = t.w;
  } else {
    static_assert(W == 1, "fp32 rows load 4 lanes or 1");
    out.v[0] = __ldg(p);
  }
  return out;
}

// eight bf16 lanes packed in 16 bytes, widened to fp32
__device__ __forceinline__ Lanes<8> widen_lanes(uint4 t) {
  Lanes<8> out;
  const uint32_t pairs[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // little-endian: lane 2k in the low half
    out.v[2 * k] = __uint_as_float(pairs[k] << 16);
    out.v[2 * k + 1] = __uint_as_float(pairs[k] & 0xffff0000u);
  }
  return out;
}

template <int W>
__device__ __forceinline__ void store_lanes(float* p, const float (&a)[W]) {
  if constexpr (W == 8) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(a[0], a[1], a[2], a[3]);
    q[1] = make_float4(a[4], a[5], a[6], a[7]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

// acc += msg(a, b) * w lane by lane (kMulScaled: acc += a * (b * w))
template <int MODE, int W>
__device__ __forceinline__ void accumulate(float (&acc)[W], const Lanes<W>& a,
                                           const Lanes<W>& b, float w) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if constexpr (MODE == kMulScaled) {
      acc[k] += a.v[k] * (b.v[k] * w);
    } else {
      acc[k] += message<MODE>(a.v[k], b.v[k]) * w;
    }
  }
}

// In is float (the ladder's operands); each thread owns W lanes; n is the
// row width in groups of W lanes
template <int MODE, typename In, int W>
__global__ void __launch_bounds__(kMaxThreads)
row_gather(const int* __restrict__ rowptr, const int* __restrict__ col,
           const int* __restrict__ etype, const int* __restrict__ eid,
           const float* __restrict__ weight, const In* __restrict__ rel,
           const In* __restrict__ x, float* __restrict__ out, int n) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t width = static_cast<int64_t>(n) * W;
  const int64_t lane = static_cast<int64_t>(j) * W;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  float acc[W] = {};
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t c = __ldg(col + e);
    const float w = __ldg(weight + __ldg(eid + e));
    const Lanes<W> xv = load_lanes<W>(x + c * width + lane);
    if constexpr (MODE == kNone) {
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] += xv.v[k] * w;
    } else {
      const int64_t r = __ldg(etype + e);
      accumulate<MODE, W>(acc, load_lanes<W>(rel + r * width + lane), xv, w);
    }
  }
  store_lanes<W>(out + static_cast<int64_t>(v) * width + lane, acc);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// lanes per thread on the vector path: 16 bytes of operand
template <typename In>
constexpr int vec_lanes() {
  return 16 / static_cast<int>(sizeof(In));
}

// threads per CTA and feature tiles for a row of n elements
inline void feature_tiles(int n, int* threads, int* tiles) {
  *threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  *tiles = (n + *threads - 1) / *threads;
}

}  // namespace rspmm
