// ReCalKV latent-ring flash decode for Hopper (sm_90a), CUDA C++: four
// kernels from one template.
//
//   K1 recalkv_latent_decode           replaces src/repro/kernels/
//                                      latent_decode.py::latent_decode_attention
//   K3 recalkv_latent_decode_quant     latent_decode_q.py::latent_decode_attention_quant
//   K5 recalkv_latent_decode_mq        latent_decode.py::latent_decode_attention_mq
//   K6 recalkv_latent_decode_mq_quant  latent_decode_q.py::latent_decode_attention_mq_quant
//
// For every (batch b, latent group g) and the R = nq * Hg query rows of
// that group (nq queries, Hg = s * qpk heads each, rows ordered (query,
// head); nq = 1 for K1/K3, spec_depth + 1 for K5/K6):
//
//   K_i[t]  = RoPE_t( RMSNorm_(1+k_norm)( zk[b,t,g,:] @ R_k[g][:, i*dh:(i+1)*dh] ) )
//   score   = scale * q[b,g,row,:] . K_{head(row) / qpk}[t] + bias[b,query(row),t]
//   out     = softmax_t(score) @ zv[b,:,g,:]            (values stay latent)
//
// over the ring columns t < S plus n_self self columns: the deferred-write
// tokens' latents, rotated by their own cos/sin, passed as operands so
// the ring is never copied (the JAX wrappers append them to a copy of the
// ring).  K1/K3 score their one self column at bias 0; K5/K6 read the
// self columns' bias from the last n_self columns of their (B, nq, S +
// n_self) bias.  K3/K6 read an int8 ring: int8 latents with one float32
// scale per (token, group).  The tile loader stages the raw int8 latents
// and their scales in shared memory; the key scale multiplies each
// reconstructed key row once (k = s * (q @ R_k), before k-norm) and the
// value scale multiplies the softmax weight of its column, so the
// dequantized values are never materialised.
//
// What bounds it on an H100: at the main-path shape (B=8, S=4096, G=2,
// r=256, s=4, dh=128) a K1 call must read ~84 MB (zk, zv and the f32
// cos/sin tables) — 25 us at 3.35 TB/s — and do ~17 GFLOP of key
// reconstruction, 17 us on bf16 tensor cores.  The int8 ring reads
// r_k + r_v + 8 = 520 bytes per token and group instead of 1,024; the
// verify kernels add (nq - 1) * Hg rows of scoring per rebuilt key tile.
// This version does the reconstruction on CUDA cores from shared memory
// and is bound by that arithmetic (K1 takes ~1.4 ms at that shape on an
// H100 80GB HBM3 at 700 W; chip_smoke.py measures all four and PERF.md
// keeps the times); moving the (32 x r) @ (r x dh) product onto wgmma is
// the next step.
//
// Design against the card's limits:
//  * The TPU grid walks S in order on one core; a (B, G) grid would be 16
//    blocks for 132 SMs.  Here S (+ the self columns) is split into
//    chunks: grid (n_chunks, G, B), sized by the wrapper to ~8 blocks per
//    SM so that a ring filled only in part still spreads its live tiles
//    over the card.  Each block runs the online softmax over its chunk
//    and writes the raw (acc, m, l) state; a second small kernel merges
//    the chunks with the log-sum-exp algebra (a chunk whose tiles were all
//    masked has l = 0 and adds exactly 0).
//  * One group's R_k (r x s*dh) in bf16 is 256 KB, above the 227 KB a
//    block may use.  It is streamed per head slot in (32 x dh) slices, and
//    each slot's keys are normalised and rotated in registers: a warp owns
//    whole key rows, so the per-head RMSNorm and the half-split RoPE need
//    only warp shuffles.
//  * Keys are rebuilt once per tile and scored by all nq queries (the
//    verify kernels' reason to exist; K1 is not launched nq times).
//  * Shared memory grows with the row count (q, acc and the tile's scores
//    are R rows).  At Hg = 16, dh = 128, r_k = r_v = 256 the tile needs
//    ~189 KB with nq = 4 and bf16 latents, ~221 KB with f32 and ~173 KB
//    with int8: spec_depth = 3 fits every type.  nq = 5 needs ~248 KB with
//    f32 latents, over the 227 KB limit, and the wrapper raises on any
//    shape over the limit (as for K1) instead of splitting rows across
//    blocks, which would rebuild every key tile once per split.  Holding
//    acc in registers would lift the limit; that is later work.
//  * Keys are never written to device memory.
//
// Contracts kept from the TPU kernels: masked logits use NEG_INF = -1e30
// (never -inf); a tile whose bias is masked for every query is skipped
// (no loads, no arithmetic); a row whose columns are all masked finishes
// as exact 0 (a row masked across a whole processed tile leaves its
// softmax state untouched, and the merge floors l at 1e-30).  Inputs are
// bf16 or f32 (latents also int8); accumulation is f32 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SB = 32;        // key tile (tokens); one token per lane
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RC = 32;        // rank rows of R_k staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return static_cast<int8_t>(x);
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
  const void* q;              // (B, G, R, dh), R = nq * Hg, rows (query, head)
  const void* zk;             // (B, S, G, rk)   T, or int8
  const void* zv;             // (B, S, G, rv)
  const float* zk_scale;      // (B, S, G) int8 ring only, else null
  const float* zv_scale;      // (B, S, G)
  const void* r_k;            // (G, rk, s*dh)
  const float* cos;           // (B, S, dh/2)
  const float* sin;           // (B, S, dh/2)
  const float* bias;          // (B, nq, bias_cols)
  const float* k_norm;        // (dh,) or null
  const void* zk_self;        // (B, n_self, G, rk) or null
  const void* zv_self;        // (B, n_self, G, rv)
  const float* zk_self_scale; // (B, n_self, G) int8 ring only
  const float* zv_self_scale; // (B, n_self, G)
  const float* cos_self;      // (B, n_self, dh/2)
  const float* sin_self;      // (B, n_self, dh/2)
  float* part_acc;            // (B, G, n_chunks, R, rv)
  float* part_m;              // (B, G, n_chunks, R)
  float* part_l;              // (B, G, n_chunks, R)
  void* out;                  // (B, G, R, rv)
  int B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols, n_chunks, chunk_len;
  float scale, eps;
};

template <int DH>
__host__ __device__ constexpr int k_stride() { return DH + 1; }

template <typename L, int DH>
size_t smem_bytes(int R, int nq, int rk, int rv) {
  size_t floats = size_t(R) * DH + size_t(R) * rv + 3 * R + size_t(R) * SB +
                  size_t(nq) * SB + 2 * SB * (DH / 2) + SB * k_stride<DH>() + RC * DH +
                  2 * SB;
  return floats * sizeof(float) + size_t(SB) * (rk + rv) * sizeof(L);
}

// T: type of q, r_k and out (bf16 or f32); L: latent storage (T, or
// int8_t with per-(token, group) float scales).
template <typename T, typename L, int DH>
__global__ void __launch_bounds__(THREADS)
latent_decode_partial(Args a) {
  constexpr int HALF = DH / 2;
  constexpr int KS = k_stride<DH>();
  constexpr int NJ = DH / 32;        // key columns per lane
  constexpr int NI = SB / WARPS;     // key rows per warp
  constexpr bool QUANT = sizeof(L) == 1;
  static_assert(DH % 64 == 0, "dh must be a multiple of 64");

  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hg = a.Hg, rk = a.rk, rv = a.rv, s = a.s, G = a.G, S = a.S;
  const int nq = a.nq, n_self = a.n_self, R = nq * Hg;
  const int qpk = Hg / s;
  const int S_ext = S + n_self;
  const int t0 = chunk * a.chunk_len;
  const int t1 = min(S_ext, t0 + a.chunk_len);

  extern __shared__ float smem[];
  float* q_s = smem;                      // R * DH
  float* acc_s = q_s + R * DH;            // R * rv
  float* m_s = acc_s + R * rv;            // R
  float* l_s = m_s + R;                   // R
  float* corr_s = l_s + R;                // R
  float* p_s = corr_s + R;                // R * SB
  float* bias_s = p_s + R * SB;           // nq * SB
  float* cos_s = bias_s + nq * SB;        // SB * HALF
  float* sin_s = cos_s + SB * HALF;       // SB * HALF
  float* k_s = sin_s + SB * HALF;         // SB * KS
  float* r_s = k_s + SB * KS;             // RC * DH
  float* ksc_s = r_s + RC * DH;           // SB key scales (int8 ring)
  float* vsc_s = ksc_s + SB;              // SB value scales
  L* zk_s = reinterpret_cast<L*>(vsc_s + SB);  // SB * rk
  L* zv_s = zk_s + SB * rk;                    // SB * rv

  const T* q = static_cast<const T*>(a.q);
  const L* zk = static_cast<const L*>(a.zk);
  const L* zv = static_cast<const L*>(a.zv);
  const T* rkp = static_cast<const T*>(a.r_k);
  const L* zk_self = static_cast<const L*>(a.zk_self);
  const L* zv_self = static_cast<const L*>(a.zv_self);

  for (int e = tid; e < R * DH; e += THREADS)
    q_s[e] = to_f(q[(size_t(b) * G + g) * R * DH + e]);
  for (int e = tid; e < R * rv; e += THREADS) acc_s[e] = 0.f;
  for (int e = tid; e < R; e += THREADS) { m_s[e] = NEG_INF; l_s[e] = 0.f; }

  for (int tt = t0; tt < t1; tt += SB) {
    // -- bias first: a tile masked for every query costs no further loads
    int valid = 0;
    if (tid < SB) {
      const int t = tt + tid;
      for (int j = 0; j < nq; ++j) {
        float bv = NEG_INF;
        if (t < t1)
          bv = (t < S || a.bias_cols > S)
                   ? a.bias[(size_t(b) * nq + j) * a.bias_cols + t]
                   : 0.f;                                  // K1/K3 self column
        bias_s[j * SB + tid] = bv;
        valid |= bv > NEG_INF * 0.5f;
      }
    }
    if (!__syncthreads_or(valid)) continue;

    // -- latent, scale and rotation tiles -------------------------------
    for (int e = tid; e < SB * rk; e += THREADS) {
      const int i = e / rk, r = e - i * rk, t = tt + i;
      L v = from_f<L>(0.f);
      if (t < t1 && t < S) v = zk[((size_t(b) * S + t) * G + g) * rk + r];
      else if (t < t1) v = zk_self[((size_t(b) * n_self + (t - S)) * G + g) * rk + r];
      zk_s[e] = v;
    }
    for (int e = tid; e < SB * rv; e += THREADS) {
      const int i = e / rv, c = e - i * rv, t = tt + i;
      L v = from_f<L>(0.f);
      if (t < t1 && t < S) v = zv[((size_t(b) * S + t) * G + g) * rv + c];
      else if (t < t1) v = zv_self[((size_t(b) * n_self + (t - S)) * G + g) * rv + c];
      zv_s[e] = v;
    }
    if (QUANT && tid < SB) {
      const int t = tt + tid;
      float ks = 0.f, vs = 0.f;
      if (t < t1 && t < S) {
        ks = a.zk_scale[(size_t(b) * S + t) * G + g];
        vs = a.zv_scale[(size_t(b) * S + t) * G + g];
      } else if (t < t1) {
        ks = a.zk_self_scale[(size_t(b) * n_self + (t - S)) * G + g];
        vs = a.zv_self_scale[(size_t(b) * n_self + (t - S)) * G + g];
      }
      ksc_s[tid] = ks;
      vsc_s[tid] = vs;
    }
    for (int e = tid; e < SB * HALF; e += THREADS) {
      const int i = e / HALF, d = e - i * HALF, t = tt + i;
      float c = 0.f, sn = 0.f;
      if (t < t1 && t < S) {
        c = a.cos[(size_t(b) * S + t) * HALF + d];
        sn = a.sin[(size_t(b) * S + t) * HALF + d];
      } else if (t < t1) {
        c = a.cos_self[(size_t(b) * n_self + (t - S)) * HALF + d];
        sn = a.sin_self[(size_t(b) * n_self + (t - S)) * HALF + d];
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
      // -- dequantize, per-head RMSNorm and half-split RoPE, in registers -
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) {
        const int row = warp + WARPS * ii;
        if (QUANT) {
          const float ks = ksc_s[row];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) kacc[ii][jj] *= ks;
        }
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
      // -- scores of every query's qpk heads that read this slot -----------
      for (int e = tid; e < nq * qpk * SB; e += THREADS) {
        const int j = e / (qpk * SB), rem = e - j * qpk * SB;
        const int h = j * Hg + i * qpk + rem / SB, t = rem % SB;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot = fmaf(q_s[h * DH + d], k_s[t * KS + d], dot);
        p_s[h * SB + t] = dot * a.scale + bias_s[j * SB + t];
      }
      __syncthreads();
    }

    // -- online softmax: one warp per row, one lane per token -------------
    for (int h = warp; h < R; h += WARPS) {
      const float sc = p_s[h * SB + lane];
      const float m_tile = warp_max(sc);
      if (m_tile <= NEG_INF * 0.5f) {
        // this row sees no column of the tile (another query does): its
        // state stays as it is, so a row masked everywhere ends as 0
        p_s[h * SB + lane] = 0.f;
        if (lane == 0) corr_s[h] = 1.f;
        continue;
      }
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, m_tile);
      const float p = __expf(sc - m_new);
      const float psum = warp_sum(p);
      p_s[h * SB + lane] = QUANT ? p * vsc_s[lane] : p;   // value scale folded in
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[h] = corr;
        l_s[h] = l_s[h] * corr + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // -- acc = acc * corr + P @ zv (value latents) ------------------------
    for (int e = tid; e < R * rv; e += THREADS) {
      const int h = e / rv, c = e - h * rv;
      float acc = acc_s[e] * corr_s[h];
#pragma unroll 8
      for (int t = 0; t < SB; ++t) acc = fmaf(p_s[h * SB + t], to_f(zv_s[t * rv + c]), acc);
      acc_s[e] = acc;
    }
  }
  __syncthreads();
  const size_t base = (size_t(b) * G + g) * a.n_chunks + chunk;
  for (int e = tid; e < R * rv; e += THREADS) a.part_acc[base * R * rv + e] = acc_s[e];
  for (int e = tid; e < R; e += THREADS) {
    a.part_m[base * R + e] = m_s[e];
    a.part_l[base * R + e] = l_s[e];
  }
}

// Log-sum-exp merge of the chunk partials: out = sum_k acc_k e^{m_k - M} /
// max(sum_k l_k e^{m_k - M}, 1e-30).  A fully masked row (no chunk saw a
// column: acc = 0, l = 0) finishes as exact 0.
// Grid (ceil(R * rv / THREADS), G, B): one output element per thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
latent_decode_merge(Args a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = a.nq * a.Hg, rv = a.rv, n = a.n_chunks;
  const size_t base = (size_t(b) * a.G + g) * n;
  T* out = static_cast<T*>(a.out);
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e < R * rv) {
    const int h = e / rv;
    float M = NEG_INF;
    for (int k = 0; k < n; ++k) M = fmaxf(M, a.part_m[(base + k) * R + h]);
    float L = 0.f, O = 0.f;
    for (int k = 0; k < n; ++k) {
      const float w = __expf(a.part_m[(base + k) * R + h] - M);
      L += a.part_l[(base + k) * R + h] * w;
      O += a.part_acc[(base + k) * R * rv + e] * w;
    }
    out[((size_t(b) * a.G + g) * R) * rv + e] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename L, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<L, DH>(a.nq * a.Hg, a.nq, a.rk, a.rv);
  cudaError_t err = cudaFuncSetAttribute(latent_decode_partial<T, L, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  latent_decode_partial<T, L, DH><<<dim3(a.n_chunks, a.G, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (a.nq * a.Hg * a.rv + THREADS - 1) / THREADS;
  latent_decode_merge<T><<<dim3(merge_blocks, a.G, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// Dispatch on (T, L, dh).  ``quant`` selects int8 latents.
int dispatch(int is_bf16, int dh, bool quant, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dh == 64) {
    if (is_bf16) err = quant ? launch<__nv_bfloat16, int8_t, 64>(a, st)
                             : launch<__nv_bfloat16, __nv_bfloat16, 64>(a, st);
    else err = quant ? launch<float, int8_t, 64>(a, st) : launch<float, float, 64>(a, st);
  } else if (dh == 128) {
    if (is_bf16) err = quant ? launch<__nv_bfloat16, int8_t, 128>(a, st)
                             : launch<__nv_bfloat16, __nv_bfloat16, 128>(a, st);
    else err = quant ? launch<float, int8_t, 128>(a, st) : launch<float, float, 128>(a, st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Shared memory the partial kernel needs (bytes), for the wrapper's check;
// -1 for an unsupported dh.
long long recalkv_latent_decode_smem(int is_bf16, int is_int8, int dh, int rows, int nq,
                                     int rk, int rv) {
  if (dh != 64 && dh != 128) return -1;
  const size_t f = dh == 64 ? smem_bytes<float, 64>(rows, nq, rk, rv)
                            : smem_bytes<float, 128>(rows, nq, rk, rv);
  const size_t lat_f32 = size_t(SB) * (rk + rv) * sizeof(float);
  const size_t lat = size_t(SB) * (rk + rv) * (is_int8 ? 1 : is_bf16 ? 2 : 4);
  return static_cast<long long>(f - lat_f32 + lat);
}

// The four entry points share one argument list and return a cudaError_t
// (0 = success).  All tensors contiguous, on the device of ``stream``;
// ``is_bf16`` selects bf16 (1) or f32 (0) for q, r_k, out and (float
// rings) the latents.  Null self latents mean no self column; null k_norm
// means no key norm.  Each entry point checks that the operands match its
// kernel: scales present only for the int8 kernels, one query for K1/K3.
#define RECALKV_ENTRY(NAME, QUANT, MULTI)                                                \
  int NAME(int is_bf16, int dh, const void* q, const void* zk, const void* zv,          \
           const float* zk_scale, const float* zv_scale, const void* r_k,               \
           const float* cos, const float* sin, const float* bias, const float* k_norm,  \
           const void* zk_self, const void* zv_self, const float* zk_self_scale,        \
           const float* zv_self_scale, const float* cos_self, const float* sin_self,    \
           float* part_acc, float* part_m, float* part_l, void* out, int B, int S,      \
           int G, int Hg, int rk, int rv, int s, int nq, int n_self, int bias_cols,     \
           int n_chunks, int chunk_len, float scale, float eps, void* stream) {         \
    if ((zk_scale != nullptr) != (QUANT) || (!(MULTI) && nq != 1) ||                   \
        ((QUANT) && zk_self != nullptr && zk_self_scale == nullptr))                    \
      return static_cast<int>(cudaErrorInvalidValue);                                   \
    Args a{q, zk, zv, zk_scale, zv_scale, r_k, cos, sin, bias, k_norm,                  \
           zk_self, zv_self, zk_self_scale, zv_self_scale, cos_self, sin_self,          \
           part_acc, part_m, part_l, out, B, S, G, Hg, rk, rv, s, nq, n_self,           \
           bias_cols, n_chunks, chunk_len, scale, eps};                                 \
    return dispatch(is_bf16, dh, QUANT, a, static_cast<cudaStream_t>(stream));          \
  }

RECALKV_ENTRY(recalkv_latent_decode, false, false)           // K1
RECALKV_ENTRY(recalkv_latent_decode_quant, true, false)      // K3
RECALKV_ENTRY(recalkv_latent_decode_mq, false, true)         // K5
RECALKV_ENTRY(recalkv_latent_decode_mq_quant, true, true)    // K6

#undef RECALKV_ENTRY

}  // extern "C"
