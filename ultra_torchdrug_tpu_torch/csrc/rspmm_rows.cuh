// Row-gather device code shared by the rspmm kernels (K1 in rspmm_fwd.cu,
// the dx passes of K2 and K3 in rspmm_bwd.cu; the Lanes helpers and
// relation_sums also serve K4, K6/K7 and K5, K6b/K7b in rspmm_pna_*.cu):
//
//     out[v, :] = sum over e in [rowptr[v], rowptr[v+1]) of
//                 w[eid[e]] * msg(rel[etype[e], :], x[col[e], :])
//
// with msg = rel * x (kMulRel), rel + x (kAddRel) or x alone (kNone, the
// transe backward's message: neither rel nor etype is read).
//
// over a CSR (int32 rowptr / col / etype / eid), fp32 rows of width F.
//
// One CTA per output row and per feature tile of up to 256 threads; threads
// run across the feature dimension, so every row gather is one coalesced
// load of 16 bytes a thread (float4 when F % 4 == 0 and every row pointer is
// 16-byte aligned, else a scalar path). The sum lives in registers and each
// output row is written exactly once: no atomics, no memset (rows without
// edges write 0), and the edge order within a row fixes the result bitwise.
// The edge metadata of a row is the same for every thread, so it is read
// once per warp as a broadcast load; the edge loop is unrolled by 4 so that
// four independent row gathers are in flight per thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rspmm {

constexpr int kMulRel = 0;
constexpr int kAddRel = 1;
constexpr int kNone = 2;  // the row alone (K3's dx and dr passes)
constexpr int kMaxThreads = 256;

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

// acc += msg(a, b) * w, lane by lane
template <int MODE>
__device__ __forceinline__ void accumulate(float& acc, float a, float b,
                                           float w) {
  acc += message<MODE>(a, b) * w;
}
template <int MODE>
__device__ __forceinline__ void accumulate(float4& acc, float4 a, float4 b,
                                           float w) {
  acc.x += message<MODE>(a.x, b.x) * w;
  acc.y += message<MODE>(a.y, b.y) * w;
  acc.z += message<MODE>(a.z, b.z) * w;
  acc.w += message<MODE>(a.w, b.w) * w;
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// T is float or float4; n is the row width in T elements
template <int MODE, typename T>
__global__ void __launch_bounds__(kMaxThreads)
row_gather(const int* __restrict__ rowptr, const int* __restrict__ col,
           const int* __restrict__ etype, const int* __restrict__ eid,
           const float* __restrict__ weight, const T* __restrict__ rel,
           const T* __restrict__ x, T* __restrict__ out, int n) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  T acc = zero<T>();
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const int64_t c = __ldg(col + e);
    const float w = __ldg(weight + __ldg(eid + e));
    if constexpr (MODE == kNone) {
      accumulate<MODE>(acc, zero<T>(), ld(x + c * n + j), w);
    } else {
      const int64_t r = __ldg(etype + e);
      accumulate<MODE>(acc, ld(rel + r * n + j), ld(x + c * n + j), w);
    }
  }
  out[static_cast<int64_t>(v) * n + j] = acc;
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

// W consecutive fp32 lanes of a row (W = 4: one 16-byte float4 access, the
// pointer 16-byte aligned; W = 1: one float), for kernels whose per-lane
// arithmetic is written once for both widths
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
    out.v[0] = __ldg(p);
  }
  return out;
}

template <int W>
__device__ __forceinline__ void store_lanes(float* p, const float (&a)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// threads per CTA and feature tiles for a row of n elements
inline void feature_tiles(int n, int* threads, int* tiles) {
  *threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  *tiles = (n + *threads - 1) / *threads;
}

// launch row_gather over num_rows rows; vec selects the float4 path (the
// caller checks F % 4 == 0 and the alignment of every row pointer)
template <int MODE>
void launch_row_gather(bool vec, const int* rowptr, const int* col,
                       const int* etype, const int* eid, const float* weight,
                       const float* rel, const float* x, float* out,
                       int num_rows, int num_features, cudaStream_t stream) {
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_rows, tiles);
  if (vec) {
    row_gather<MODE, float4><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, reinterpret_cast<const float4*>(rel),
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n);
  } else {
    row_gather<MODE, float><<<grid, threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, n);
  }
}

}  // namespace rspmm
