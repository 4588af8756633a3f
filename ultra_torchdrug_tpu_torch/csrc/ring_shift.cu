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
// as a roll of one tensor. The sources lie on the launching card; the
// destinations may lie on other cards (parallel/mesh.py places each edge
// shard on a card of its own), which the launching card stores to through
// peer access (ring_shift_enable_peer, once a pair of cards, never on the
// launch path): each card pushes its shards' blocks to their right
// neighbours, as the TPU kernel pushes a shard's block into its right
// neighbour's buffer. Where every shard lives on one card, one launch over
// all n pairs is a device-local copy. Sources and destinations never
// alias: the wrapper allocates the output.
//
// What bounds it on an H100: a pure copy reads and writes every byte once,
// 2 * n * block_bytes over 3.35 TB/s (at the ULTRA entity ring, n = 4 and
// v_block = 3,636 rows: 0.036 ms for F = 1024 fp32 features, 0.142 ms for
// F = 4096). There is no arithmetic.
//
// The first design was a grid-strided loop of one 16-byte load and
// store per thread over a grid capped at 16 CTAs per SM, and it asked the
// runtime for the device and its SM count on every launch: 0.0444 and
// 0.1671 ms against torch.cat's 0.0429 and 0.1624 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md). A persistent bulk copy (TMA: one CTA per SM streaming
// its share through four 32 KB shared-memory stages, one thread issuing
// every copy) was tried and took 0.0470 and 0.1830 ms on the same card, and
// several 16-byte units per thread, with or without streaming hints, were
// no faster than one. This design is the plainest copy:
//  * one 16-byte unit per thread and no loop, over a grid (units / 256
//    CTAs, n shards) that covers every block at once, so the card's block
//    scheduler keeps every SM full to the end and no thread walks a second
//    unit behind a partial wave;
//  * the bytes of a block after its last whole unit (its tail) are copied
//    one per thread by the first CTA of the block's row;
//  * blocks whose source or destination is not 16-byte aligned (ragged
//    block sizes after the first) are copied a byte per thread, coalesced;
//  * no runtime query on the launch path: the grid follows from the size.
// It takes 0.0429 and 0.1602 ms against torch.cat's 0.0433 and 0.1645 in
// the same run (83 and 89 % of the bound), and 0.0434 ms a call at the
// host's pace, where the first design took 0.053-0.085 ms (the same card;
// the wrapper's host side was cut with it).
// Between cards the stores cross NVLink: a block over 450 GB/s each way
// (0.0331 ms for F = 1024, 0.1324 ms for F = 4096 at v_block = 3,636 fp32
// rows), with every card pushing one block on its own link at once.
// The TPU kernel's barrier and semaphores have no counterpart: the copy is
// ordered on the launching card's stream, and the wrapper orders that
// stream against the receiving cards' streams with events.

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

// grid (units / kThreads, n): thread i of row s copies unit i of block s
__global__ void __launch_bounds__(kThreads)
    ring_shift_units(BlockPtrs p, long long block_bytes) {
  const unsigned char* src = p.src[blockIdx.y];
  unsigned char* dst = p.dst[blockIdx.y];
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long units = block_bytes >> 4;
  if (i < units) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  // the tail after the last whole unit
  if (blockIdx.x == 0 && threadIdx.x < (block_bytes & 15)) {
    const long long b = (units << 4) + threadIdx.x;
    dst[b] = src[b];
  }
}

// grid (bytes / kThreads, n): thread i of row s copies byte i of block s
__global__ void __launch_bounds__(kThreads)
    ring_shift_bytes(BlockPtrs p, long long block_bytes) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < block_bytes) p.dst[blockIdx.y][i] = p.src[blockIdx.y][i];
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
  bool aligned = true;
  for (int s = 0; s < n; ++s) {
    p.src[s] = static_cast<const unsigned char*>(src[s]);
    p.dst[s] = static_cast<unsigned char*>(dst[(s + 1) % n]);
    aligned = aligned && ((reinterpret_cast<uintptr_t>(p.src[s]) |
                           reinterpret_cast<uintptr_t>(p.dst[s])) & 15) == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long work = aligned ? block_bytes >> 4 : block_bytes;
  const long long ctas = work > 0 ? (work + kThreads - 1) / kThreads : 1;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(n));
  if (aligned) {
    ring_shift_units<<<grid, kThreads, 0, s>>>(p, block_bytes);
  } else {
    ring_shift_bytes<<<grid, kThreads, 0, s>>>(p, block_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// Let the current device's kernels access `peer`'s memory (K9's stores to
// a neighbour card). Returns 0 on success or when access was enabled
// before, else the CUDA error code.
extern "C" int ring_shift_enable_peer(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();  // clear the runtime's last error
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(err);
}
