// Causal / sliding-window flash-attention prefill for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::
// flash_prefill_attention (Pallas).  q (B,T,H,dh), k (B,T,Hkv,dh),
// v (B,T,Hv,dv) -> out (B,T,H,dv), with query head h reading kv head
// h / (H/Hkv) and value group h / (H/Hv) (kv-major head order).  On the
// ReCalKV prefill path the values are the latent groups: Hv = G and
// dv = r_v, which differ from Hkv and dh.
//
// What bounds it on an H100: at B=8, T=2048, H=32, dh=128, dv=256 the
// causal work is ~0.4 TFLOP (0.42 ms on bf16 tensor cores) against
// ~0.45 GB of traffic (0.14 ms), so it is bound by operations.  This
// first version multiplies on CUDA cores (register-tiled from shared
// memory): it takes about 18 ms at that shape on an H100 80GB HBM3 at
// 700 W, some 44x the bound (chip_smoke.py measures it; PERF.md keeps the
// current time); wgmma with TMA-fed tiles is the next step.
//
// Design: grid (query tiles, H, B), 64 x 64 tiles, 256 threads; a
// thread holds 4 query rows x (4 score / dv/16 output) columns in
// registers, and the 16 threads of a row reduce its softmax state with
// warp shuffles.  Key tiles above the diagonal or wholly outside the
// window are skipped; keys at or beyond T are masked (NEG_INF = -1e30,
// never -inf), as in the TPU kernel.  bf16 or f32 inputs, f32
// accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride in elements: one extra 4-byte word keeps the 16 rows a
// thread group reads at one column in distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int padded() { return D + int(4 / sizeof(T)); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, T, H, Hkv, Hv, window;  // window <= 0: none
  int causal;
  float scale;
};

template <typename T, int DH, int DV>
size_t smem_bytes() {
  return (size_t(BQ) * padded<T, DH>() + size_t(BK) * padded<T, DH>() + size_t(BK) * DV) *
             sizeof(T) +
         size_t(BQ) * (BK + 1) * sizeof(float);
}

template <typename T, int DH, int DV>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(Args a) {
  constexpr int QS = padded<T, DH>();
  constexpr int PS = BK + 1;
  constexpr int NO = DV / 16;   // output columns per thread
  static_assert(DV % 16 == 0, "dv must be a multiple of 16");

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int T_ = a.T, H = a.H;
  const int hk = h / (H / a.Hkv), hv = h / (H / a.Hv);
  const int q_start = qt * BQ;

  extern __shared__ unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);       // BQ * QS
  T* k_s = q_s + BQ * QS;                         // BK * QS
  T* v_s = k_s + BK * QS;                         // BK * DV
  float* p_s = reinterpret_cast<float*>(v_s + BK * DV);  // BQ * PS

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, t = q_start + r;
    q_s[r * QS + d] = t < T_ ? q[((size_t(b) * T_ + t) * H + h) * DH + d] : from_f<T>(0.f);
  }

  float o[4][NO], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[i][j] = 0.f;
  }

  const int n_k = (T_ + BK - 1) / BK;
  const int kt_hi = a.causal ? min(n_k - 1, (q_start + BQ - 1) / BK) : n_k - 1;
  for (int kt = 0; kt <= kt_hi; ++kt) {
    const int k_start = kt * BK;
    if (a.window > 0 && !(k_start + BK - 1 > q_start - a.window)) continue;
    __syncthreads();  // previous tile's readers are done with k_s / v_s / p_s
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH, t = k_start + r;
      k_s[r * QS + d] = t < T_ ? k[((size_t(b) * T_ + t) * a.Hkv + hk) * DH + d] : from_f<T>(0.f);
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int r = e / DV, c = e - r * DV, t = k_start + r;
      v_s[e] = t < T_ ? v[((size_t(b) * T_ + t) * a.Hv + hv) * DV + c] : from_f<T>(0.f);
    }
    __syncthreads();

    // -- scores: rows ty + 16i, columns tx + 16j --------------------------
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f(q_s[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(k_s[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // -- mask + online softmax (16 lanes per row) --------------------------
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_start + tx + 16 * j;
        bool ok = kp < T_;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window > 0) ok = ok && kp > qp - a.window;
        sc[i][j] = ok ? sc[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = __expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr[i] + ps;
      m[i] = m_new;
    }
    __syncthreads();

    // -- o = o * corr + P @ V ------------------------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NO; ++j) o[i][j] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j) vv[j] = to_f(v_s[kk * DV + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NO; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty + 16 * i;
    if (qp >= T_) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      out[((size_t(b) * T_ + qp) * H + h) * DV + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

template <typename T, int DH, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, DH, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  flash_prefill_kernel<T, DH, DV><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// (128, 256): qwen3-4b's dh with r_v = 256 latent values (the main path);
// (64, 64): the small shape the GPU tests use.
template <typename T>
cudaError_t dispatch(int dh, int dv, const Args& a, cudaStream_t st) {
  if (dh == 64 && dv == 64) return launch<T, 64, 64>(a, st);
  if (dh == 128 && dv == 256) return launch<T, 128, 256>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// 1 when (dh, dv) has a compiled instantiation, else 0.
int recalkv_flash_prefill_supports(int dh, int dv) {
  return (dh == 64 && dv == 64) || (dh == 128 && dv == 256);
}

// Returns a cudaError_t (0 = success).  Tensors contiguous; ``is_bf16``
// selects bf16 (1) or f32 (0) for q, k, v and out; ``window`` <= 0 means
// no sliding window.
int recalkv_flash_prefill(int is_bf16, int dh, int dv, const void* q, const void* k,
                          const void* v, void* out, int B, int T, int H, int Hkv, int Hv,
                          int causal, int window, float scale, void* stream) {
  Args a{q, k, v, out, B, T, H, Hkv, Hv, window, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(dh, dv, a, st)
                                  : dispatch<float>(dh, dv, a, st));
}

}  // extern "C"
