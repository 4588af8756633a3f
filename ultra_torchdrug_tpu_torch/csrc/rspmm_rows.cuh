// Row-gather device code shared by the rspmm kernels (K1 and K1h in
// rspmm_fwd.cu, the dx passes of K2, K2h and K3 in rspmm_bwd.cu; the Lanes
// helpers and relation_sums also serve K4, K6/K7 and K5, K6b/K7b in
// rspmm_pna_*.cu and K8f/K8b in rspmm_rotate.cu):
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
// of K1h and K2h); they are widened to fp32 in registers, every sum is kept
// in fp32 and every output is fp32. With bf16 operands the forward messages
// (kMulRel, kAddRel) are rounded to bf16 before the weight multiplies them,
// as the TPU kernel's bf16 product is (rspmm_pallas.py:365, :497): the
// fp32 product of two bf16 values is exact, and their fp32 sum rounds to
// bf16 as the exact sum does (24 >= 2 * 8 + 2 bits), so one rounding of the
// fp32 result to bf16 gives the bf16 operation's bits.
//
// One CTA per output row and per feature tile of up to 256 threads; threads
// run across the feature dimension, W lanes each, so every row gather is one
// coalesced load of 16 bytes a thread (fp32: W = 4, a float4; bf16: W = 8,
// a uint4 of four bf16 pairs) when F % W == 0 and every row pointer is
// 16-byte aligned, else a scalar path (W = 1). The sum lives in registers
// and each output row is written exactly once: no atomics, no memset (rows
// without edges write 0), and the edge order within a row fixes the result
// bitwise. The edge metadata of a row is the same for every thread, so it
// is read once per warp as a broadcast load; the edge loop is unrolled by 4
// so that four independent row gathers are in flight per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rspmm {

constexpr int kMulRel = 0;
constexpr int kAddRel = 1;
constexpr int kNone = 2;      // the row alone (K3's dx and dr passes)
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

// the message of one lane from fp32 values; In = bf16 rounds the forward
// messages to bf16 (the operands are bf16 values widened to fp32)
template <int MODE, typename In = float>
__device__ __forceinline__ float message(float r, float xv) {
  float m;
  if constexpr (MODE == kMulRel) {
    m = r * xv;
  } else if constexpr (MODE == kAddRel) {
    m = r + xv;
  } else {
    return xv;
  }
  if constexpr (std::is_same_v<In, bf16>) {
    return __bfloat162float(__float2bfloat16_rn(m));
  }
  return m;
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

// W consecutive lanes of a row, as fp32 values in registers. fp32 rows: W = 4
// is one 16-byte float4 access (the pointer 16-byte aligned), W = 1 one
// float. bf16 rows: W = 8 is one 16-byte uint4 access, W = 1 one element;
// a bf16 value is the upper half of the fp32 value it widens to.
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

template <int W>
__device__ __forceinline__ Lanes<W> load_lanes(const bf16* p) {
  Lanes<W> out;
  if constexpr (W == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t pairs[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // little-endian: lane 2k in the low half
      out.v[2 * k] = __uint_as_float(pairs[k] << 16);
      out.v[2 * k + 1] = __uint_as_float(pairs[k] & 0xffff0000u);
    }
  } else {
    static_assert(W == 1, "bf16 rows load 8 lanes or 1");
    const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
    out.v[0] = __uint_as_float(static_cast<uint32_t>(b) << 16);
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
template <int MODE, typename In, int W>
__device__ __forceinline__ void accumulate(float (&acc)[W], const Lanes<W>& a,
                                           const Lanes<W>& b, float w) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if constexpr (MODE == kMulScaled) {
      acc[k] += a.v[k] * (b.v[k] * w);
    } else {
      acc[k] += message<MODE, In>(a.v[k], b.v[k]) * w;
    }
  }
}

// In is float or bf16; each thread owns W lanes; n is the row width in
// groups of W lanes
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
      accumulate<MODE, In, W>(acc, load_lanes<W>(rel + r * width + lane), xv,
                              w);
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

// launch row_gather over num_rows rows; vec selects the 16-byte path (the
// caller checks F % vec_lanes<In>() == 0 and the alignment of every row
// pointer)
template <int MODE, typename In>
void launch_row_gather(bool vec, const int* rowptr, const int* col,
                       const int* etype, const int* eid, const float* weight,
                       const In* rel, const In* x, float* out, int num_rows,
                       int num_features, cudaStream_t stream) {
  constexpr int kVec = vec_lanes<In>();
  const int n = vec ? num_features / kVec : num_features;
  int threads, tiles;
  feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_rows, tiles);
  if (vec) {
    row_gather<MODE, In, kVec><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, n);
  } else {
    row_gather<MODE, In, 1><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, n);
  }
}

}  // namespace rspmm
