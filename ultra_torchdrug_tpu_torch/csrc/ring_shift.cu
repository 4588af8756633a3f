// The ring shift (kernel K9 of the port): every shard's block moves one shard
// to the right, so that afterwards shard s holds what shard s - 1 held.
//
// Replaces the TPU kernel ultra_torchdrug_tpu/parallel/rdma.py::_rotate_leaf
// (body _rotate_kernel, reached through rdma_rotate): after a barrier with
// both neighbours, one HBM -> HBM remote copy of the shard's whole block into
// the right neighbour's output buffer, the same function as
// jax.lax.ppermute(perm=[(i, (i + 1) % n)]), for any dtype and shape.
//
// Here the kernel takes n source block pointers and n destination block
// pointers, each block `block_bytes` long, and copies source block s to
// destination block (s + 1) mod n. It is written for per-shard buffers, not
// as a roll of one tensor: with peer access the same pointers may lie on n
// cards. In this port every shard lives on one device (parallel/mesh.py), so
// all pointers do too, and the copy is device-local. Sources and destinations
// never alias: the wrapper allocates the output.
//
// What bounds it on an H100: a pure copy reads and writes every byte once,
// 2 * n * block_bytes over 3.35 TB/s (at the ULTRA entity ring, n = 4 and
// v_block = 3,636 rows: 0.036 ms for F = 1024 fp32 features, 0.142 ms for
// F = 4096). There is no arithmetic.
//
// What the design does about it: a 2-D grid, y over the shards and x grid-
// strided over 16-byte units of the block, so that each thread moves 16 bytes
// per load and neighbouring threads touch neighbouring addresses; the bytes of
// a block that do not fill a last 16-byte unit are copied one per thread. A
// block whose source or destination is not 16-byte aligned (ragged block
// sizes of blocks after the first) is copied a byte per thread, still
// coalesced. The TPU kernel's barrier and semaphores have no counterpart: the
// copy is ordered on the caller's stream. Overlapping the copy with the ring
// step's aggregation (a copy engine or a second stream) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;

// dst[s] is the block that receives src[s]
struct BlockPtrs {
  const unsigned char* src[kMaxShards];
  unsigned char* dst[kMaxShards];
};

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

__global__ void __launch_bounds__(kThreads)
    ring_shift_kernel(BlockPtrs p, long long block_bytes) {
  const unsigned char* src = p.src[blockIdx.y];
  unsigned char* dst = p.dst[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (aligned16(src, dst)) {
    const long long units = block_bytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (; i < units; i += stride) {
      d4[i] = s4[i];
    }
    // the byte tail after the last whole unit
    const long long tail = block_bytes & 15;
    if (blockIdx.x == 0 && threadIdx.x < tail) {
      const long long b = (units << 4) + threadIdx.x;
      dst[b] = src[b];
    }
  } else {
    for (; i < block_bytes; i += stride) {
      dst[i] = src[i];
    }
  }
}

}  // namespace

// K9: src and dst are host arrays of n device pointers to blocks of
// block_bytes bytes each; source block s is copied to destination block
// (s + 1) mod n on `stream`. Returns the cudaGetLastError code of the launch
// (0 on success); n outside [1, 64] or a negative size is cudaErrorInvalidValue.
extern "C" int ring_shift_k9(const void* const* src, void* const* dst, int n,
                             long long block_bytes, void* stream) {
  if (n < 1 || n > kMaxShards || block_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (block_bytes == 0) {
    return static_cast<int>(cudaSuccess);
  }
  BlockPtrs p;
  bool vec = true;
  for (int s = 0; s < n; ++s) {
    p.src[s] = static_cast<const unsigned char*>(src[s]);
    p.dst[s] = static_cast<unsigned char*>(dst[(s + 1) % n]);
    vec = vec && ((reinterpret_cast<uintptr_t>(p.src[s]) |
                   reinterpret_cast<uintptr_t>(p.dst[s])) & 15) == 0;
  }
  int device = 0;
  int sms = 132;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // 16 CTAs of 256 threads per SM over all shards: every SM full, each
  // thread looping over several units of a large block
  const long long work = vec ? (block_bytes + 15) / 16 : block_bytes;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = sms * 16 / n > 0 ? sms * 16 / n : 1;
  if (blocks > cap) {
    blocks = cap;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  ring_shift_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, block_bytes);
  return static_cast<int>(cudaGetLastError());
}
