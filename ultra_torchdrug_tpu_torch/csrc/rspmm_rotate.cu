// Relational SpMM with RotatE messages, sum aggregation: kernels K8f (the
// forward) and K8b (its backward) of the port.
//
// Rows are fp32 [N, F] with F = B * D: B blocks of D features, each block
// holding the real parts in [:D/2] and the imaginary parts in [D/2:] (the
// RotatE convention of ultra_torchdrug_tpu/ops/rspmm.py:64-73). With the
// complex product a (x) b = (ar*br - ai*bi, ar*bi + ai*br) and
// conj(a) (x) b = (ar*br + ai*bi, ar*bi - ai*br), lane by lane:
//
// K8f replaces ultra_torchdrug_tpu/ops/rspmm_pallas.py::rspmm_gather1 in mode
// rot_rel (reached through rspmm_rotate_fwd_pallas):
//
//     out[v, :] = sum over e = (s -> v, r) of  (rel[r] (x) x[s]) * w[eid_e]
//
// K8b replaces rspmm_bwd_fused in mode rotate (through rspmm_rotate_bwd_pallas):
//
//     dx[s, :] = sum over e = (s -> v, r) of  (conj(rel[r]) (x) g[v]) * w[eid_e]
//     dr[r, :] = sum over e with type r   of  (conj(x[s_e]) (x) g[v_e]) * w[eid_e]
//
// Shapes: x, g, dx, out [V, F]; rel, dr [R, F]; w [E] in original edge order.
// Rows without edges come back 0.
//
// What bounds them on an H100: the compulsory traffic is one read of the
// dense inputs and the edges and one write of each output; the work is 5
// flops per edge and feature for K8f (the complex product, 3 per real lane,
// the weight and the sum) and 10 for K8b. At classic NBFNet's shapes on the
// FB15k-237-sized graph (V = 14,541, E = 496,188, R = 474, D = 32) K8f moves
// about 68.5 MB at F = 512 (0.0204 ms at 3.35 TB/s, against 1.27 GFLOP,
// 0.019 ms at 67 TFLOP/s fp32: bytes-bound) and 250 MB at F = 2048 (0.0746 ms
// against 0.0758 ms: just flop-bound); K8b at F = 2048 moves 373 MB
// (0.111 ms) against 10.2 GFLOP (0.152 ms): flop-bound. This design gathers
// one x and one rel row per edge (K8f), and g and rel (dx pass) and x and g
// (dr pass) per edge for K8b, so, as for K1 and K2, the gathers that miss the
// 50 MB L2 are its real limit.
//
// What the design does about it: K1's row kernel and K2's two deterministic
// passes (rspmm_rows.cuh, rspmm_bwd.cu), with one change: a thread owns a
// complex lane (b, k), k < D/2, reads its real part at b*D + k and its
// imaginary part at b*D + D/2 + k and writes both. The TPU kernel relays the
// rows out into planar re/im halves first (_planarize, rspmm_pallas.py:2627);
// the card indexes the halves in place. Four lanes a thread (float4 loads)
// when D/2 % 4 == 0 and every row pointer is 16-byte aligned, else one.
//  * K8f and K8b's dx pass: one CTA per output row and feature tile over a
//    CSR (destination-sorted for K8f, source-sorted for dx), the sums in
//    registers, each row written once; no atomics.
//  * K8b's dr pass: the relation-sorted edges cut into chunks of at most 256
//    edges that never cross a relation, one CTA per (chunk, feature tile)
//    summing its chunk into a scratch row, then relation_sums adding each
//    relation's chunk rows in chunk order. No float atomics: two calls give
//    bitwise-equal dx and dr.
// One K8b call makes up to three device launches (a half whose output pointer
// is null is skipped).

#include "rspmm_rows.cuh"

namespace {

using rspmm::kMaxThreads;
using rspmm::Lanes;
using rspmm::load_lanes;
using rspmm::store_lanes;

// The offset of lane j's real parts in a row: lanes run over the B blocks
// and, within a block, over its D/2 complex positions, W at a time
template <int W>
__device__ __forceinline__ int64_t real_offset(int j, int dim) {
  const int per_block = dim / (2 * W);
  return static_cast<int64_t>(j / per_block) * dim +
         static_cast<int64_t>(j % per_block) * W;
}

// (re, im) += (a (x) b) * w, or (conj(a) (x) b) * w with CONJ: the message
// first, then the weight, as the TPU kernel and the plain version form it
template <bool CONJ, int W>
__device__ __forceinline__ void cplx_accumulate(float (&re)[W],
                                                float (&im)[W],
                                                const Lanes<W>& ar,
                                                const Lanes<W>& ai,
                                                const Lanes<W>& br,
                                                const Lanes<W>& bi, float w) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (CONJ) {
      re[i] += (ar.v[i] * br.v[i] + ai.v[i] * bi.v[i]) * w;
      im[i] += (ar.v[i] * bi.v[i] - br.v[i] * ai.v[i]) * w;
    } else {
      re[i] += (ar.v[i] * br.v[i] - ai.v[i] * bi.v[i]) * w;
      im[i] += (ar.v[i] * bi.v[i] + br.v[i] * ai.v[i]) * w;
    }
  }
}

// out[v] = sum over e in [rowptr[v], rowptr[v+1]) of
//          (rel[etype[e]] (x) x[col[e]]) * w[eid[e]]  (conj(rel) with CONJ)
template <bool CONJ, int W>
__global__ void __launch_bounds__(kMaxThreads)
rotate_rows(const int* __restrict__ rowptr, const int* __restrict__ col,
            const int* __restrict__ etype, const int* __restrict__ eid,
            const float* __restrict__ weight, const float* __restrict__ rel,
            const float* __restrict__ x, float* __restrict__ out,
            int num_features, int dim, int lanes) {
  const int v = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  const int64_t re = real_offset<W>(j, dim);
  const int64_t im = re + dim / 2;
  const int begin = __ldg(rowptr + v);
  const int end = __ldg(rowptr + v + 1);
  float acc_re[W] = {};
  float acc_im[W] = {};
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const float* r =
        rel + static_cast<int64_t>(__ldg(etype + e)) * num_features;
    const float* s = x + static_cast<int64_t>(__ldg(col + e)) * num_features;
    const float w = __ldg(weight + __ldg(eid + e));
    cplx_accumulate<CONJ, W>(acc_re, acc_im, load_lanes<W>(r + re),
                             load_lanes<W>(r + im), load_lanes<W>(s + re),
                             load_lanes<W>(s + im), w);
  }
  float* o = out + static_cast<int64_t>(v) * num_features;
  store_lanes<W>(o + re, acc_re);
  store_lanes<W>(o + im, acc_im);
}

// partial[c] = sum over e in [chunk_ptr[c], chunk_ptr[c+1]) of
//              (conj(x[src[e]]) (x) g[dst[e]]) * w[eid[e]]
template <int W>
__global__ void __launch_bounds__(kMaxThreads)
rotate_chunk_partials(const int* __restrict__ chunk_ptr,
                      const int* __restrict__ src, const int* __restrict__ dst,
                      const int* __restrict__ eid,
                      const float* __restrict__ weight,
                      const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ partial, int num_features, int dim,
                      int lanes) {
  const int c = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  const int64_t re = real_offset<W>(j, dim);
  const int64_t im = re + dim / 2;
  const int begin = __ldg(chunk_ptr + c);
  const int end = __ldg(chunk_ptr + c + 1);
  float acc_re[W] = {};
  float acc_im[W] = {};
#pragma unroll 4
  for (int e = begin; e < end; ++e) {
    const float* s = x + static_cast<int64_t>(__ldg(src + e)) * num_features;
    const float* d = g + static_cast<int64_t>(__ldg(dst + e)) * num_features;
    const float w = __ldg(weight + __ldg(eid + e));
    cplx_accumulate<true, W>(acc_re, acc_im, load_lanes<W>(s + re),
                             load_lanes<W>(s + im), load_lanes<W>(d + re),
                             load_lanes<W>(d + im), w);
  }
  float* o = partial + static_cast<int64_t>(c) * num_features;
  store_lanes<W>(o + re, acc_re);
  store_lanes<W>(o + im, acc_im);
}

// the complex lanes of a row and their CTA tiling
struct Tiling {
  int lanes, threads, tiles;
};

Tiling tiling(int num_features, int width) {
  Tiling t;
  t.lanes = num_features / (2 * width);
  rspmm::feature_tiles(t.lanes, &t.threads, &t.tiles);
  return t;
}

template <bool CONJ>
int launch_rows(bool vec, const int* rowptr, const int* col, const int* etype,
                const int* eid, const float* weight, const float* rel,
                const float* x, float* out, int num_rows, int num_features,
                int dim, cudaStream_t stream) {
  const Tiling t = tiling(num_features, vec ? 4 : 1);
  const dim3 grid(num_rows, t.tiles);
  if (vec) {
    rotate_rows<CONJ, 4><<<grid, t.threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, num_features, dim,
        t.lanes);
  } else {
    rotate_rows<CONJ, 1><<<grid, t.threads, 0, stream>>>(
        rowptr, col, etype, eid, weight, rel, x, out, num_features, dim,
        t.lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_dr(bool vec, const int* chunk_ptr, const int* rel_chunk_ptr,
              const int* rel_src, const int* rel_dst, const int* rel_eid,
              const float* weight, const float* x, const float* g, float* dr,
              float* partial, int num_relations, int num_chunks,
              int num_features, int dim, cudaStream_t stream) {
  if (num_chunks > 0) {
    const Tiling t = tiling(num_features, vec ? 4 : 1);
    const dim3 grid(num_chunks, t.tiles);
    if (vec) {
      rotate_chunk_partials<4><<<grid, t.threads, 0, stream>>>(
          chunk_ptr, rel_src, rel_dst, rel_eid, weight, x, g, partial,
          num_features, dim, t.lanes);
    } else {
      rotate_chunk_partials<1><<<grid, t.threads, 0, stream>>>(
          chunk_ptr, rel_src, rel_dst, rel_eid, weight, x, g, partial,
          num_features, dim, t.lanes);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the chunk rows are plain rows: summed 4 floats a thread where aligned
  const int n = vec ? num_features / 4 : num_features;
  int threads, tiles;
  rspmm::feature_tiles(n, &threads, &tiles);
  const dim3 grid(num_relations, tiles);
  if (vec) {
    rspmm::relation_sums<float4><<<grid, threads, 0, stream>>>(
        rel_chunk_ptr, reinterpret_cast<const float4*>(partial),
        reinterpret_cast<float4*>(dr), n);
  } else {
    rspmm::relation_sums<float><<<grid, threads, 0, stream>>>(
        rel_chunk_ptr, partial, dr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid_dim(int num_features, int dim) {
  return dim > 0 && dim % 2 == 0 && num_features % dim == 0;
}

}  // namespace

// K8f. dim is D, the width of one block (even, dividing num_features).
// Returns the cudaGetLastError() code after the launch (0 on success); an
// invalid dim returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_rotate_fwd(const int* rowptr, const int* src,
                                const int* etype, const int* eid,
                                const float* weight, const float* rel,
                                const float* x, float* out, int num_rows,
                                int num_features, int dim, void* stream) {
  using rspmm::aligned16;
  if (!valid_dim(num_features, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows <= 0 || num_features <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = (dim / 2) % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(out);
  return launch_rows<false>(vec, rowptr, src, etype, eid, weight, rel, x, out,
                            num_rows, num_features, dim,
                            static_cast<cudaStream_t>(stream));
}

// K8b. The source-sorted CSR (src_rowptr / src_dst / src_etype / src_eid)
// drives the dx pass; the relation-sorted edges (rel_src / rel_dst / rel_eid)
// cut at chunk_ptr, with rel_chunk_ptr giving each relation's chunks, drive
// the dr pass. partial holds num_chunks rows of F floats. dx == nullptr skips
// the dx pass, dr == nullptr the dr pass. Returns the first nonzero
// cudaGetLastError() code after a launch (0 on success); an invalid dim
// returns cudaErrorInvalidValue without launching.
extern "C" int rspmm_rotate_bwd(
    const int* src_rowptr, const int* src_dst, const int* src_etype,
    const int* src_eid, const int* chunk_ptr, const int* rel_chunk_ptr,
    const int* rel_src, const int* rel_dst, const int* rel_eid,
    const float* weight, const float* rel, const float* x, const float* g,
    float* dx, float* dr, float* partial, int num_rows, int num_relations,
    int num_chunks, int num_features, int dim, void* stream) {
  using rspmm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_dim(num_features, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_features <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (dim / 2) % 4 == 0 && aligned16(rel) && aligned16(x) &&
                   aligned16(g) && (dx == nullptr || aligned16(dx)) &&
                   (dr == nullptr || (aligned16(dr) && aligned16(partial)));
  if (dx != nullptr && num_rows > 0) {
    const int err = launch_rows<true>(vec, src_rowptr, src_dst, src_etype,
                                      src_eid, weight, rel, g, dx, num_rows,
                                      num_features, dim, s);
    if (err != 0) return err;
  }
  if (dr != nullptr && num_relations > 0) {
    return launch_dr(vec, chunk_ptr, rel_chunk_ptr, rel_src, rel_dst, rel_eid,
                     weight, x, g, dr, partial, num_relations, num_chunks,
                     num_features, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
