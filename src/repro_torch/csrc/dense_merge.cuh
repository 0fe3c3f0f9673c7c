// The log-sum-exp merge of split-K partials, shared by the dense cache's
// decode (dense_decode.cu) and verify (dense_verify.cu) kernels: each main
// grid leaves, per (b, h) and chunk k, R rows of (acc_k, m_k, l_k), and this
// kernel writes out = sum_k acc_k w_k / max(sum_k l_k w_k, 1e-30), w_k =
// e^{m_k - M} over the chunks that saw a live column (a chunk with m_k =
// NEG_INF wrote no acc: its values are loaded but weigh nothing); a row no
// chunk saw is exact 0, and a row one chunk saw at weight 1 (m_k = M) keeps
// that chunk's acc / l bits.
//
// A thread per output element; it issues its first MERGE_KB chunks' acc
// loads before the block's (n_chunks, R) maxima and sums arrive in shared
// memory, so one latency covers them all.  Launched as a programmatic
// dependent of the main grid, so its launch overlaps the main grid's tail;
// griddepcontrol.wait holds it until the main grid's writes are visible.
// Grid (ceil(R * dh / MERGE_THREADS), Hkv, B), dynamic shared memory
// n_chunks * R * 8 bytes.  With m_out / l_out it also writes each row's
// merged softmax state (M, L): o = acc / L at running max M, the state a
// caller merging partial softmaxes across devices needs (M = NEG_INF and
// L = 0 for a row no chunk saw).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dense {

constexpr float NEG_INF = -1e30f;
constexpr int MERGE_THREADS = 128, MERGE_KB = 32;

struct Partials {
  const float* acc;   // (B, Hkv, n_chunks, R, dh)
  const float* m;     // (B, Hkv, n_chunks, R)
  const float* l;     // (B, Hkv, n_chunks, R)
  void* out;          // (B, Hkv, R, dh), bf16 or f32
  int B, Hkv, R, n_chunks;
  float* m_out = nullptr;   // (B, Hkv, R) merged max, or null
  float* l_out = nullptr;   // (B, Hkv, R) merged sum at that max, or null
};

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) merge(Partials a, int dh) {
  extern __shared__ float ml[];
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the main grid's partials
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int R = a.R, n = a.n_chunks;
  const size_t base = (size_t(b) * a.Hkv + h) * n;
  const int e = blockIdx.x * MERGE_THREADS + tid;
  const bool mine = e < R * dh;
  const size_t stride = size_t(R) * dh;
  const float* pa = a.acc + base * stride + e;
  float acc[MERGE_KB];
#pragma unroll
  for (int u = 0; u < MERGE_KB; ++u) acc[u] = mine && u < n ? pa[u * stride] : 0.f;
  float* m = ml;            // (n, R)
  float* l = ml + n * R;    // (n, R)
  for (int i = tid; i < n * R; i += MERGE_THREADS) {
    m[i] = a.m[base * R + i];
    l[i] = a.l[base * R + i];
  }
  __syncthreads();
  if (!mine) return;
  const int j = e / dh;
  float M = NEG_INF;
  for (int k = 0; k < n; ++k) M = fmaxf(M, m[k * R + j]);
  float L = 0.f, O = 0.f;
  for (int k0 = 0; k0 < n; k0 += MERGE_KB) {
    if (k0 > 0) {
#pragma unroll
      for (int u = 0; u < MERGE_KB; ++u) acc[u] = k0 + u < n ? pa[(k0 + u) * stride] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < MERGE_KB; ++u) {
      const int k = k0 + u;
      const float mk = k < n ? m[k * R + j] : NEG_INF;
      if (mk > NEG_INF * 0.5f) {
        const float w = mk == M ? 1.f : __expf(mk - M);
        L += l[k * R + j] * w;
        O += acc[u] * w;
      }
    }
  }
  store_out(static_cast<T*>(a.out) + (size_t(b) * a.Hkv + h) * stride + e,
            O / fmaxf(L, 1e-30f));
  if (a.m_out != nullptr && e % dh == 0) {
    const size_t row = (size_t(b) * a.Hkv + h) * R + j;
    a.m_out[row] = M;
    a.l_out[row] = L;
  }
}

// Launch the merge on ``stream`` as a programmatic dependent of the grid
// launched just before it there (the merge is set up while that grid runs
// and waits for it in griddepcontrol.wait).  While the stream is being
// captured into a CUDA graph it is launched as a plain dependent (the wait
// is then a no-op), so the capture does not hinge on the toolkit's support
// for programmatic edges in graphs.
template <typename T>
cudaError_t launch_merge(const Partials& p, int dh, cudaStream_t stream) {
  const size_t smem = size_t(p.n_chunks) * p.R * 8;
  cudaError_t err = cudaFuncSetAttribute(merge<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.R * dh + MERGE_THREADS - 1) / MERGE_THREADS, p.Hkv, p.B);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(stream, &capturing);
  if (err != cudaSuccess) return err;
  cfg.attrs = attr;
  cfg.numAttrs = capturing == cudaStreamCaptureStatusNone ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, merge<T>, p, dh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dense
