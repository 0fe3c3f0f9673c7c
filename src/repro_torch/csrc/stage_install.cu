// The continuous-batching install's cache copy, for Hopper (sm_90a), CUDA C++:
// a device-predicated row copy.
//
//   recalkv_stage_install  copies row q of every stage-cache leaf into row
//                          slot of the matching serving-cache leaf, where
//                          slot and q are read from device memory; a slot
//                          outside [0, n_rows) copies nothing
//
// It is glue, not a TPU kernel: the JAX package's counterpart is an XLA
// scatter with mode="drop" (src/repro/models/transformer.py::swap_cache_slot,
// called by src/repro/serving/engine.py::Engine._stage_install), which no
// pallas_call implements.  The window iteration calls it on every iteration
// of a continuous engine on the ring, inside the captured CUDA graph, so the
// install decision (a FIFO head of the staging queue and a free slot, both
// found on the device) never comes back to the host.
//
// What bounds it on an H100: an installing call moves one slot row of the
// whole cache, read once and written once.  At qwen3-4b with max_len 4,096
// and bf16 latents at r = 256 (G = 2) a row is 36 layers x (2 x 4 MB + 32 KB
// of positions) = 303 MB: 606 MB of traffic, 0.18 ms at 3.35 TB/s.  A
// branchless torch.where over the row reads two rows and writes one (0.27 ms)
// on every iteration whether or not anything installs; the idle call is what
// matters, since most iterations install nothing.
//
// Design: one launch over a device table of (dst, src, row bytes) per leaf,
// built once by the owner of the two caches, which holds it as long as they
// and any graph captured over them live (kernels/stage_install.py's
// InstallTable; the cache pointers never move).  Every block
// reads slot and q first and returns at once when nothing installs, so an
// idle iteration costs one launch of a grid that exits.  An installing call
// walks the leaves in order; within a leaf the blocks stride over 16-byte
// vectors, four loads in flight per thread before their stores.  A leaf
// whose pointers or row bytes are not 16-byte aligned is copied byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
stage_install_kernel(const long long* __restrict__ table, int n_leaves,
                     const long long* __restrict__ slot_p, const long long* __restrict__ q_p,
                     int n_rows, int n_src_rows) {
  const long long slot = *slot_p;
  const long long q = *q_p;
  if (slot < 0 || slot >= n_rows || q < 0 || q >= n_src_rows) return;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (int leaf = 0; leaf < n_leaves; ++leaf) {
    char* dst = reinterpret_cast<char*>(table[3 * leaf]);
    const char* src = reinterpret_cast<const char*>(table[3 * leaf + 1]);
    const long long bytes = table[3 * leaf + 2];
    dst += slot * bytes;
    src += q * bytes;
    const bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                       static_cast<uintptr_t>(bytes)) & 15) == 0;
    if (vec) {
      const long long n = bytes / 16;
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      for (long long i = tid; i < n; i += stride * UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = i + u * stride;
          if (j < n) v[u] = __ldg(s + j);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = i + u * stride;
          if (j < n) d[j] = v[u];
        }
      }
    } else {
      for (long long i = tid; i < bytes; i += stride) dst[i] = src[i];
    }
  }
}

}  // namespace

extern "C" {

// table: (n_leaves, 3) int64 on the device of ``stream``: destination base,
// source base, bytes of one row; every destination leaf has n_rows rows and
// every source leaf n_src_rows.  slot, q: one int64 each, on the device.
// grid: blocks of 256 threads.  Returns a cudaError_t (0 = success).
int recalkv_stage_install(const long long* table, int n_leaves, const long long* slot,
                          const long long* q, int n_rows, int n_src_rows, int grid,
                          void* stream) {
  if (table == nullptr || slot == nullptr || q == nullptr || n_leaves < 1 || n_rows < 1 ||
      n_src_rows < 1 || grid < 1 || grid > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  stage_install_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_leaves, slot, q, n_rows, n_src_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
