// ReCalKV latent-ring flash decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/latent_decode.py::
// latent_decode_attention (Pallas).  It computes, for every (batch b,
// latent group g) and the Hg = s * qpk query heads of that group:
//
//   K_i[t]  = RoPE_t( RMSNorm_(1+k_norm)( zk[b,t,g,:] @ R_k[g][:, i*dh:(i+1)*dh] ) )
//   score   = scale * q[b,g,h,:] . K_{h / qpk}[t] + bias[b,t]
//   out     = softmax_t(score) @ zv[b,:,g,:]            (values stay latent)
//
// over the ring columns t < S plus, optionally, one self column (the
// current token's latents, scored at bias 0 and rotated by its own
// cos/sin): the deferred-write token enters the softmax without the
// ring copy the JAX wrapper's _extend_ring makes for every layer call.
//
// What bounds it on an H100: at the main-path shape (B=8, S=4096, G=2,
// r=256, s=4, dh=128) a call must read ~84 MB (zk, zv and the f32 cos/sin
// tables) — 25 us at 3.35 TB/s — and do ~17 GFLOP of key reconstruction,
// 17 us on bf16 tensor cores.  This first version does the reconstruction
// on CUDA cores from shared memory and is bound by that arithmetic: it
// takes about 1.4 ms at that shape on an H100 80GB HBM3 at 700 W, some 55x
// the bound (chip_smoke.py measures it; PERF.md keeps the current time);
// moving the (32 x r) @ (r x dh) product onto wgmma is the next step.
//
// Design against the card's limits:
//  * The TPU grid walks S in order on one core; a (B, G) grid would be 16
//    blocks for 132 SMs.  Here S (+ the self column) is split into chunks:
//    grid (n_chunks, G, B), sized by the wrapper to ~8 blocks per SM so
//    that a ring filled only in part still spreads its live tiles over
//    the card.  Each block runs the online softmax over its chunk and
//    writes the raw (acc, m, l) state; a second small kernel merges the
//    chunks with the log-sum-exp algebra (a chunk whose tiles were all
//    masked has l = 0 and adds exactly 0).
//  * One group's R_k (r x s*dh) in bf16 is 256 KB, above the 227 KB a
//    block may use.  It is streamed per head slot in (32 x dh) slices, and
//    each slot's keys are normalised and rotated in registers: a warp owns
//    whole key rows, so the per-head RMSNorm and the half-split RoPE need
//    only warp shuffles.
//  * Keys are never written to device memory.
//
// Contracts kept from the TPU kernel: masked logits use NEG_INF = -1e30
// (never -inf); a tile whose bias is all masked is skipped (no loads, no
// arithmetic); a fully masked row finishes as exact 0 (the l floor 1e-30).
// Inputs are bf16 or f32; accumulation is f32 in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SB = 32;        // key tile (tokens); one token per lane
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RC = 32;        // rank rows of R_k staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const void* q;        // (B, G, Hg, dh)
  const void* zk;       // (B, S, G, rk)
  const void* zv;       // (B, S, G, rv)
  const void* r_k;      // (G, rk, s*dh)
  const float* cos;     // (B, S, dh/2)
  const float* sin;     // (B, S, dh/2)
  const float* bias;    // (B, S)
  const float* k_norm;  // (dh,) or null
  const void* zk_self;  // (B, G, rk) or null
  const void* zv_self;  // (B, G, rv) or null
  const float* cos_self;  // (B, dh/2) or null
  const float* sin_self;  // (B, dh/2) or null
  float* part_acc;      // (B, G, n_chunks, Hg, rv)
  float* part_m;        // (B, G, n_chunks, Hg)
  float* part_l;        // (B, G, n_chunks, Hg)
  void* out;            // (B, G, Hg, rv)
  int B, S, G, Hg, rk, rv, s, n_chunks, chunk_len;
  float scale, eps;
};

template <int DH>
__host__ __device__ constexpr int k_stride() { return DH + 1; }

template <typename T, int DH>
size_t smem_bytes(int Hg, int rk, int rv) {
  size_t floats = size_t(Hg) * DH + size_t(Hg) * rv + 3 * Hg + size_t(Hg) * SB + SB +
                  2 * SB * (DH / 2) + SB * k_stride<DH>() + RC * DH;
  return floats * sizeof(float) + size_t(SB) * (rk + rv) * sizeof(T);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
latent_decode_partial(Args a) {
  constexpr int HALF = DH / 2;
  constexpr int KS = k_stride<DH>();
  constexpr int NJ = DH / 32;        // key columns per lane
  constexpr int NI = SB / WARPS;     // key rows per warp
  static_assert(DH % 64 == 0, "dh must be a multiple of 64");

  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hg = a.Hg, rk = a.rk, rv = a.rv, s = a.s, G = a.G, S = a.S;
  const int qpk = Hg / s;
  const bool has_self = a.zk_self != nullptr;
  const int S_ext = S + (has_self ? 1 : 0);
  const int t0 = chunk * a.chunk_len;
  const int t1 = min(S_ext, t0 + a.chunk_len);

  extern __shared__ float smem[];
  float* q_s = smem;                      // Hg * DH
  float* acc_s = q_s + Hg * DH;           // Hg * rv
  float* m_s = acc_s + Hg * rv;           // Hg
  float* l_s = m_s + Hg;                  // Hg
  float* corr_s = l_s + Hg;               // Hg
  float* p_s = corr_s + Hg;               // Hg * SB
  float* bias_s = p_s + Hg * SB;          // SB
  float* cos_s = bias_s + SB;             // SB * HALF
  float* sin_s = cos_s + SB * HALF;       // SB * HALF
  float* k_s = sin_s + SB * HALF;         // SB * KS
  float* r_s = k_s + SB * KS;             // RC * DH
  T* zk_s = reinterpret_cast<T*>(r_s + RC * DH);  // SB * rk
  T* zv_s = zk_s + SB * rk;                       // SB * rv

  const T* q = static_cast<const T*>(a.q);
  const T* zk = static_cast<const T*>(a.zk);
  const T* zv = static_cast<const T*>(a.zv);
  const T* rkp = static_cast<const T*>(a.r_k);
  const T* zk_self = static_cast<const T*>(a.zk_self);
  const T* zv_self = static_cast<const T*>(a.zv_self);

  for (int e = tid; e < Hg * DH; e += THREADS)
    q_s[e] = to_f(q[(size_t(b) * G + g) * Hg * DH + e]);
  for (int e = tid; e < Hg * rv; e += THREADS) acc_s[e] = 0.f;
  for (int e = tid; e < Hg; e += THREADS) { m_s[e] = NEG_INF; l_s[e] = 0.f; }

  for (int tt = t0; tt < t1; tt += SB) {
    // -- bias first: a fully masked tile costs no further loads ----------
    int valid = 0;
    if (tid < SB) {
      const int t = tt + tid;
      float bv = NEG_INF;
      if (t < t1) bv = (t < S) ? a.bias[size_t(b) * S + t] : 0.f;  // self: 0
      bias_s[tid] = bv;
      valid = bv > NEG_INF * 0.5f;
    }
    if (!__syncthreads_or(valid)) continue;

    // -- latent, value and rotation tiles ---------------------------------
    for (int e = tid; e < SB * rk; e += THREADS) {
      const int i = e / rk, r = e - i * rk, t = tt + i;
      T v = from_f<T>(0.f);
      if (t < t1 && t < S) v = zk[((size_t(b) * S + t) * G + g) * rk + r];
      else if (t < t1) v = zk_self[(size_t(b) * G + g) * rk + r];
      zk_s[e] = v;
    }
    for (int e = tid; e < SB * rv; e += THREADS) {
      const int i = e / rv, c = e - i * rv, t = tt + i;
      T v = from_f<T>(0.f);
      if (t < t1 && t < S) v = zv[((size_t(b) * S + t) * G + g) * rv + c];
      else if (t < t1) v = zv_self[(size_t(b) * G + g) * rv + c];
      zv_s[e] = v;
    }
    for (int e = tid; e < SB * HALF; e += THREADS) {
      const int i = e / HALF, d = e - i * HALF, t = tt + i;
      float c = 0.f, sn = 0.f;
      if (t < t1 && t < S) {
        c = a.cos[(size_t(b) * S + t) * HALF + d];
        sn = a.sin[(size_t(b) * S + t) * HALF + d];
      } else if (t < t1) {
        c = a.cos_self[size_t(b) * HALF + d];
        sn = a.sin_self[size_t(b) * HALF + d];
      }
      cos_s[e] = c;
      sin_s[e] = sn;
    }
    __syncthreads();

    for (int i = 0; i < s; ++i) {
      // -- reconstruct this head slot's keys: (SB x rk) @ (rk x DH) -------
      // warp w owns key rows w + WARPS*ii; lane owns columns lane + 32*jj.
      float kacc[NI][NJ];
#pragma unroll
      for (int ii = 0; ii < NI; ++ii)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) kacc[ii][jj] = 0.f;
      for (int r0 = 0; r0 < rk; r0 += RC) {
        const int rn = min(RC, rk - r0);
        for (int e = tid; e < rn * DH; e += THREADS) {
          const int rr = e / DH, d = e - rr * DH;
          r_s[e] = to_f(rkp[(size_t(g) * rk + r0 + rr) * (size_t(s) * DH) + i * DH + d]);
        }
        __syncthreads();
        for (int rr = 0; rr < rn; ++rr) {
          float zr[NI], rc[NJ];
#pragma unroll
          for (int ii = 0; ii < NI; ++ii) zr[ii] = to_f(zk_s[(warp + WARPS * ii) * rk + r0 + rr]);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) rc[jj] = r_s[rr * DH + lane + 32 * jj];
#pragma unroll
          for (int ii = 0; ii < NI; ++ii)
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) kacc[ii][jj] = fmaf(zr[ii], rc[jj], kacc[ii][jj]);
        }
        __syncthreads();
      }
      // -- per-head RMSNorm and half-split RoPE, in registers ------------
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) {
        const int row = warp + WARPS * ii;
        if (a.k_norm != nullptr) {
          float ss = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) ss += kacc[ii][jj] * kacc[ii][jj];
          const float inv = rsqrtf(warp_sum(ss) / DH + a.eps);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            kacc[ii][jj] *= inv * (1.f + a.k_norm[lane + 32 * jj]);
        }
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          const float c = cos_s[row * HALF + lane + 32 * jj];
          const float sn = sin_s[row * HALF + lane + 32 * jj];
          const float x1 = kacc[ii][jj], x2 = kacc[ii][jj + NJ / 2];
          kacc[ii][jj] = x1 * c - x2 * sn;
          kacc[ii][jj + NJ / 2] = x2 * c + x1 * sn;
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) k_s[row * KS + lane + 32 * jj] = kacc[ii][jj];
      }
      __syncthreads();
      // -- scores of the qpk heads that read this slot --------------------
      for (int e = tid; e < qpk * SB; e += THREADS) {
        const int h = i * qpk + e / SB, t = e % SB;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot = fmaf(q_s[h * DH + d], k_s[t * KS + d], dot);
        p_s[h * SB + t] = dot * a.scale + bias_s[t];
      }
      __syncthreads();
    }

    // -- online softmax: one warp per head row, one lane per token --------
    for (int h = warp; h < Hg; h += WARPS) {
      const float sc = p_s[h * SB + lane];
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float p = __expf(sc - m_new);
      const float psum = warp_sum(p);
      p_s[h * SB + lane] = p;
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[h] = corr;
        l_s[h] = l_s[h] * corr + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // -- acc = acc * corr + P @ zv (value latents) ------------------------
    for (int e = tid; e < Hg * rv; e += THREADS) {
      const int h = e / rv, c = e - h * rv;
      float acc = acc_s[e] * corr_s[h];
#pragma unroll 8
      for (int t = 0; t < SB; ++t) acc = fmaf(p_s[h * SB + t], to_f(zv_s[t * rv + c]), acc);
      acc_s[e] = acc;
    }
  }
  __syncthreads();
  const size_t base = (size_t(b) * G + g) * a.n_chunks + chunk;
  for (int e = tid; e < Hg * rv; e += THREADS) a.part_acc[base * Hg * rv + e] = acc_s[e];
  for (int e = tid; e < Hg; e += THREADS) {
    a.part_m[base * Hg + e] = m_s[e];
    a.part_l[base * Hg + e] = l_s[e];
  }
}

// Log-sum-exp merge of the chunk partials: out = sum_k acc_k e^{m_k - M} /
// max(sum_k l_k e^{m_k - M}, 1e-30).  A fully masked row (every chunk
// skipped: acc = 0, l = 0) finishes as exact 0.
// Grid (ceil(Hg * rv / THREADS), G, B): one output element per thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
latent_decode_merge(Args a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int Hg = a.Hg, rv = a.rv, n = a.n_chunks;
  const size_t base = (size_t(b) * a.G + g) * n;
  T* out = static_cast<T*>(a.out);
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e < Hg * rv) {
    const int h = e / rv;
    float M = NEG_INF;
    for (int k = 0; k < n; ++k) M = fmaxf(M, a.part_m[(base + k) * Hg + h]);
    float L = 0.f, O = 0.f;
    for (int k = 0; k < n; ++k) {
      const float w = __expf(a.part_m[(base + k) * Hg + h] - M);
      L += a.part_l[(base + k) * Hg + h] * w;
      O += a.part_acc[(base + k) * Hg * rv + e] * w;
    }
    out[((size_t(b) * a.G + g) * Hg) * rv + e] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(a.Hg, a.rk, a.rv);
  cudaError_t err = cudaFuncSetAttribute(latent_decode_partial<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  latent_decode_partial<T, DH><<<dim3(a.n_chunks, a.G, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (a.Hg * a.rv + THREADS - 1) / THREADS;
  latent_decode_merge<T><<<dim3(merge_blocks, a.G, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the partial kernel needs (bytes), for the wrapper's check.
long long recalkv_latent_decode_smem(int is_bf16, int dh, int Hg, int rk, int rv) {
  if (dh == 64) return is_bf16 ? smem_bytes<__nv_bfloat16, 64>(Hg, rk, rv)
                               : smem_bytes<float, 64>(Hg, rk, rv);
  if (dh == 128) return is_bf16 ? smem_bytes<__nv_bfloat16, 128>(Hg, rk, rv)
                                : smem_bytes<float, 128>(Hg, rk, rv);
  return -1;
}

// Returns a cudaError_t (0 = success).  All tensors contiguous, on the
// device of ``stream``; ``is_bf16`` selects bf16 (1) or f32 (0) for q,
// zk, zv, r_k, the self latents and out.  Null zk_self means no self
// column; null k_norm means no key norm.
int recalkv_latent_decode(int is_bf16, int dh,
                          const void* q, const void* zk, const void* zv, const void* r_k,
                          const float* cos, const float* sin, const float* bias,
                          const float* k_norm, const void* zk_self, const void* zv_self,
                          const float* cos_self, const float* sin_self,
                          float* part_acc, float* part_m, float* part_l, void* out,
                          int B, int S, int G, int Hg, int rk, int rv, int s,
                          int n_chunks, int chunk_len, float scale, float eps,
                          void* stream) {
  Args a{q, zk, zv, r_k, cos, sin, bias, k_norm, zk_self, zv_self, cos_self, sin_self,
         part_acc, part_m, part_l, out, B, S, G, Hg, rk, rv, s, n_chunks, chunk_len,
         scale, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return is_bf16 ? launch<__nv_bfloat16, 64>(a, st) : launch<float, 64>(a, st);
  if (dh == 128) return is_bf16 ? launch<__nv_bfloat16, 128>(a, st) : launch<float, 128>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
