// Causal / sliding-window flash-attention prefill for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::
// flash_prefill_attention (Pallas).  q (B,T,H,dh), k (B,T,Hkv,dh),
// v (B,T,Hv,dv) -> out (B,T,H,dv), with query head h reading kv head
// h / (H/Hkv) and value group h / (H/Hv) (kv-major head order).  On the
// ReCalKV prefill path the values are the latent groups: Hv = G and
// dv = r_v, which differ from Hkv and dh.  Served widths: dh 64, 80, 128
// or 256 and any dv that is a multiple of 8 from 8 to 1,024 (every r_v the
// JAX package makes for qwen3-4b, minicpm-2b, gemma3-12b, h2o-danube-1.8b
// and qwen3-moe-235b-a22b, and the dense cache's dv = dh).
//
// What bounds it on an H100: at B=8, T=2048, H=32, dh=128, dv=256 the
// causal work is ~0.41 TFLOP (0.42 ms on bf16 tensor cores) against
// ~0.45 GB of traffic (0.14 ms), so it is bound by operations.
//
// Two bodies (chip_smoke.py measures both; PERF.md keeps the times):
//  * bf16 (the serving path): flash_prefill_tc, on wgmma.  A block takes
//    BQ = 128 query rows of one head as two warpgroups of 64 rows.  Per
//    64-key tile a warpgroup starts S = Q K^T as wgmma.m64n64k16 from
//    shared memory (Q and K K-major) and O += P V as wgmma.m64n{DV}k16
//    with P in registers as the A operand and V MN-major from shared
//    memory (wgmma.cuh).  S, P and O (64 x dv f32 per warpgroup: 128
//    registers a thread at dv = 256) never leave registers; the S
//    accumulator's layout is P's A-fragment layout, so P is packed in
//    place.  Against the mma.sync shape (FlashAttention-2), where each
//    warp re-reads every K and V tile through ldmatrix, a warpgroup reads
//    each tile once per 64 rows.
//  * Pipeline: Q, K and V arrive by 16-byte cp.async, in the 128-byte
//    swizzle wgmma reads, into a three-stage K/V ring (a thread copies the
//    same cells of every tile, so its addresses advance by adds).  At dh
//    256 and a 256-column value slice three V stages overrun shared memory
//    (Q 64 KB + 3 x 32 KB of K + 3 x 32 KB of V), so V keeps two stages and
//    loads one tile ahead instead of two (K stays two ahead); there S =
//    Q K^T is 16 wgmma k-steps over four 64-column swizzle blocks.  In tile
//    i a warpgroup starts S of tile i + 1 and then P V of tile i, runs the
//    softmax of tile i + 1 on the CUDA cores while P V is on the tensor
//    cores, and rescales O once P V is done; one block barrier per tile
//    publishes the next tile's copies and frees the oldest stage.  The
//    exponent base moves only when a score exceeds it by more than 8 (log2
//    units, P <= 2^8), so O is rescaled rarely.  O leaves through shared
//    memory in 16-byte row chunks.  The grid puts the query-tile index
//    slowest and reversed, so the longest causal rows launch first.
//    Masks are applied in registers only on tiles that need them (the
//    diagonal, the T tail, the window edge); tiles above the diagonal or
//    wholly outside the window are never loaded.
//  * dh 80 (h2o-danube-1.8b): Q and K rows are stored at 128 columns, two
//    64-column swizzle blocks, and S = Q K^T takes 5 k-steps, the fifth on
//    columns 64-79 of the second block; the 48 columns past dh are neither
//    loaded nor read.  Shared memory is dh 128's; the k-steps are 5 of 8.
//  * Value widths.  The P V product is wgmma.m64n{DV}k16 with V read
//    MN-major in 64-column swizzle blocks, and O already costs 128
//    registers a thread at 256 columns, so a block computes one slice of
//    DV = 64, 128 or 256 value columns (the narrowest that holds dv):
//    V's 16-byte chunks past dv are zero-filled as they land (their P V
//    columns are exact zeros) and O's are not stored.  Past 256 the head's
//    dv splits into ceil(dv / 256) slices along grid x, each recomputing
//    S = Q K^T, a fifth of a 256-column slice's products at dh = 128 (P V
//    is two products, hi and lo): dv = 512 does ~11% more products than
//    one 512-column pass would.  The main width (128, 256) is one full
//    slice, its arithmetic unchanged.
//  * Precision: P enters P V as two bf16 A operands on the same V, hi =
//    bf16(P) and lo = bf16(P - hi) (~2^-17 relative per weight).  One bf16
//    P (2^-9) is large against the output on rows that have averaged few
//    keys: it missed chip_smoke.py's per-element bf16 limit by 2.9x at its
//    shape on an H100, on early causal rows.  tests/test_torch_tc_rounding.py
//    emulates both roundings.
//  * f32 (the CPU/GPU parity instantiation): flash_prefill_kernel, the
//    first version, on CUDA cores (register-tiled from shared memory, 64 x
//    64 tiles, 256 threads; a thread holds 4 query rows x (4 score / DV/16
//    output) columns and 16 threads of a row reduce its softmax state with
//    warp shuffles), over the same value slices as the bf16 body (along
//    grid y).  Tensor cores in TF32 or bf16 cannot meet the f32 parity
//    limit of 1e-4.
//
// Both mask keys at or beyond T (NEG_INF = -1e30, never -inf), as the TPU
// kernel does.  In the bf16 body a row that sees no key of a tile keeps
// its softmax state, so a row masked everywhere would finish as exact 0.
// f32 accumulation throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_helpers.cuh"
#include "wgmma.cuh"

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
  int dv;                        // value columns (a multiple of 8)
  int n_sl;                      // value-column slices of a head: ceil(dv / DV)
};

template <typename T, int DH, int DV>
size_t smem_bytes() {
  return (size_t(BQ) * padded<T, DH>() + size_t(BK) * padded<T, DH>() + size_t(BK) * DV) *
             sizeof(T) +
         size_t(BQ) * (BK + 1) * sizeof(float);
}

// DV is the block's value-column slice: slice blockIdx.y % n_sl covers
// columns [c0, c0 + DV) of dv; columns past dv are zero-filled and not
// stored.
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(Args a) {
  constexpr int QS = padded<T, DH>();
  constexpr int PS = BK + 1;
  constexpr int NO = DV / 16;   // output columns per thread
  static_assert(DV % 16 == 0, "dv must be a multiple of 16");

  const int qt = blockIdx.x, h = blockIdx.y / a.n_sl, b = blockIdx.z;
  const int c0 = (blockIdx.y - h * a.n_sl) * DV, dv = a.dv;
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
      v_s[e] = t < T_ && c0 + c < dv ? v[((size_t(b) * T_ + t) * a.Hv + hv) * dv + c0 + c]
                                     : from_f<T>(0.f);
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
      if (c0 + tx + 16 * j < dv)
        out[((size_t(b) * T_ + qp) * H + h) * dv + c0 + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

// ---- bf16 body: wgmma (see the header) --------------------------------------

namespace tcp {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128, BK = 64, THREADS = 256;   // 2 warpgroups of 64 query rows
constexpr int NSK = 3;                             // K stages in the ring
constexpr size_t SMEM_LIMIT = 232448;              // bytes of shared memory a block may use

// Columns of a Q / K row in shared memory: dh rounded up to whole 64-column
// swizzle blocks (dh 80: 128, of which the k-steps read the first 80).
template <int DH>
__host__ __device__ constexpr int dh_stored() { return (DH + 63) / 64 * 64; }

// Q, NSK K stages and nsv V stages; + 1 KB to align
template <int DH, int DV>
__host__ __device__ constexpr size_t ring_smem(int nsv) {
  return (size_t(BQ) * dh_stored<DH>() + NSK * size_t(BK) * dh_stored<DH>() +
          nsv * size_t(BK) * DV) * sizeof(bf16) +
         1024;
}
// V stages: three, or two where three overrun shared memory (dh 256 at a
// 256-column slice: Q 64 KB, three K stages 96 KB, two V stages 64 KB)
template <int DH, int DV>
__host__ __device__ constexpr int v_stages() {
  return ring_smem<DH, DV>(3) <= SMEM_LIMIT ? 3 : 2;
}
template <int DH, int DV>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_smem<DH, DV>(v_stages<DH, DV>());
}

// DV is the block's value-column slice (64, 128 or 256): slice
// blockIdx.x % n_sl covers columns [c0, c0 + DV) of dv; V's columns past
// dv are zero-filled as they land and O's are not stored.
template <int DH, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_tc(Args a) {
  constexpr int SN = BK / 8;   // score 8-column tiles of a warp (16 rows x 64 keys)
  constexpr int ON = DV / 8;   // output 8-column tiles of a warp (16 rows x DV)
  constexpr int DHS = dh_stored<DH>();      // stored Q / K row
  constexpr int QC = DHS / 8, VC = DV / 8;  // 16-byte chunks per stored row
  constexpr int QL = DH / 8;                // of them holding dh columns
  constexpr uint32_t Q_BYTES = BQ * DHS * 2, K_BYTES = BK * DHS * 2, V_BYTES = BK * DV * 2;
  constexpr int NSV = v_stages<DH, DV>();   // V stages: V of tile i + NSV - 1 loads in tile i
  static_assert(DH % 16 == 0 && (DV == 64 || DV == 128 || DV == 256),
                "whole k-steps of dh; value slices of 64, 128 or 256 columns");
  static_assert(smem_bytes<DH, DV>() <= SMEM_LIMIT, "the ring fits in shared memory");

  const int h = blockIdx.x / a.n_sl, b = blockIdx.y;
  const int c0 = (blockIdx.x - h * a.n_sl) * DV;   // the slice's first value column
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest causal rows first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2;                    // warpgroup: query rows 64 wgi..
  const int g4 = lane >> 2, t4 = lane & 3;
  const int T_ = a.T, H = a.H;
  const int hk = h / (H / a.Hkv), hv = h / (H / a.Hv);
  const int q_start = qt * BQ;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                   // Q_BYTES, swizzled
  unsigned char* k_s = q_s + Q_BYTES;          // NSK stages of K_BYTES
  unsigned char* v_s = k_s + NSK * K_BYTES;    // NSV stages of V_BYTES
  const uint32_t q_a = tc::smem_u32(q_s), k_a = tc::smem_u32(k_s), v_a = tc::smem_u32(v_s);

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  // key tiles this query tile needs: none above the diagonal, none wholly
  // below the window of its first row
  const int n_k = (T_ + BK - 1) / BK;
  const int kt_hi = a.causal ? min(n_k - 1, (q_start + BQ - 1) / BK) : n_k - 1;
  int kt_lo = 0;
  if (a.window > 0 && q_start - a.window + 1 > 0) kt_lo = (q_start - a.window + 1) / BK;
  const int n_tiles = kt_hi - kt_lo + 1;

  // -- async loads into the swizzled tiles: rows past T are zero-filled -------
  for (int e = tid; e < BQ * QL; e += THREADS) {
    const int r = e / QL, c = e - r * QL, t = q_start + r;
    const bool ok = t < T_;
    tc::cp_async16(q_s + wg::sw128(BQ, r, c),
                   q + ((size_t(b) * T_ + (ok ? t : 0)) * H + h) * DH + c * 8, ok);
  }
  // A thread copies the same (row, 16-byte chunk) cells of every K and V
  // tile: rows r0 + j * (THREADS / chunks per row), one chunk column, whose
  // swizzled offsets differ by whole row steps (a multiple of 8 rows).
  // Chunks past dh (dh 80: chunks 10-15 of the 128-column row) are never
  // loaded, as no k-step reads them.
  static_assert(THREADS % QC == 0 && THREADS % VC == 0 && (THREADS / QC) % 8 == 0 &&
                (THREADS / VC) % 8 == 0, "the copy pattern needs 8-row steps");
  constexpr int KR = THREADS / QC, VR = THREADS / VC;   // row steps
  const int kr0 = tid / QC, vr0 = tid / VC;
  const uint32_t k_off = wg::sw128(BK, kr0, tid % QC), v_off = wg::sw128(BK, vr0, tid % VC);
  const bool k_live = tid % QC < QL;
  const bf16* k_src = k + (size_t(b) * T_ * a.Hkv + hk) * DH + (k_live ? tid % QC : 0) * 8;
  const size_t k_rs = size_t(a.Hkv) * DH;   // token stride
  // a thread whose value chunk lies past dv zero-fills it in every tile
  const int vc = c0 + (tid % VC) * 8;
  const int v_T = vc < a.dv ? T_ : 0;       // rows of the chunk to load
  const bf16* v_src = v + (vc < a.dv ? (size_t(b) * T_ * a.Hv + hv) * a.dv + vc : 0);
  const size_t v_rs = size_t(a.Hv) * a.dv;
  auto load_k = [&](int i) {   // K of tile kt_lo + i into stage i % NSK
    const int k_start = (kt_lo + i) * BK, st = i % NSK;
    if (!k_live) return;
#pragma unroll
    for (int j = 0; j < BK / KR; ++j) {
      const int t = k_start + kr0 + j * KR;
      tc::cp_async16(k_s + st * K_BYTES + k_off + j * KR * 128, k_src + (t < T_ ? t : 0) * k_rs,
                     t < T_);
    }
  };
  auto load_v = [&](int i) {   // V of tile kt_lo + i into stage i % NSV
    const int k_start = (kt_lo + i) * BK, st = i % NSV;
#pragma unroll
    for (int j = 0; j < BK / VR; ++j) {
      const int t = k_start + vr0 + j * VR;
      tc::cp_async16(v_s + st * V_BYTES + v_off + j * VR * 128,
                     v_src + (t < v_T ? t : 0) * v_rs, t < v_T);
    }
  };
  // K runs two tiles ahead of P V, V NSV - 1 tiles: with two V stages, V
  // of tile i + 1 loads at the top of tile i, once every warp is done with
  // P V of tile i - 1
  load_k(0);
  load_v(0);
  tc::cp_async_commit();
  if (n_tiles > 1) {
    load_k(1);
    if (NSV == 3) load_v(1);
  }
  tc::cp_async_commit();

  float o[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units
  const int row0 = q_start + warp * 16 + g4;          // rows of c0/c1; +8 for c2/c3

  // S = Q K^T of tile i: 64 x 64 per warpgroup, 16 x 64 per warp (started,
  // not waited for)
  auto start_s = [&](float (&x)[SN][4], int i) {
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t qd = q_a + (kk >> 2) * (BQ * 128) + wgi * (64 * 128) + (kk & 3) * 32;
      const uint32_t kd = k_a + (i % NSK) * K_BYTES + (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      wg::wgmma_ss_n64(x, wg::desc_sw128(qd, 16, 1024), wg::desc_sw128(kd, 16, 1024), 1);
    }
    wg::commit();
  };
  // Mask (edge tiles only) and online softmax of tile i's scores, in log2
  // units: x becomes P = 2^(S - m) (f32), l and m advance, corr is the
  // factor that O (still in the old m's units) must take.
  auto softmax = [&](float (&x)[SN][4], int i) {
    const int k_start = (kt_lo + i) * BK;
    const bool edge = k_start + BK > T_ || (a.causal && k_start + BK - 1 > q_start) ||
                      (a.window > 0 && k_start <= q_start + BQ - 1 - a.window);
    float mx[2] = {NEG_INF, NEG_INF};   // over raw scores (sl2 > 0)
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (edge) {
          const int kp = k_start + j * 8 + 2 * t4 + (c & 1);
          const int qp = row0 + (c >> 1) * 8;
          bool ok = kp < T_;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window > 0) ok = ok && kp > qp - a.window;
          if (!ok) x[j][c] = NEG_INF;
        }
        mx[c >> 1] = fmaxf(mx[c >> 1], x[j][c]);
      }
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // m is the exponent base, not the running max: it moves only when a
      // score exceeds it by more than 8 (P <= 2^8), so O is rescaled rarely.
      // Liveness is read on the raw scores: a row that has seen no key yet
      // keeps m = NEG_INF and its (empty) state.
      const float raw = tc::quad_max(mx[r]);
      const float m_tile = raw * sl2;
      const float m_new = raw > NEG_INF * 0.5f && m_tile > m[r] + 8.f ? m_tile : m[r];
      live[r] = m_new > NEG_INF * 0.5f;
      corr[r] = live[r] && m_new != m[r] ? tc::fast_exp2(m[r] - m_new) : 1.f;
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = live[r] ? tc::fast_exp2(fmaf(x[j][c], sl2, -m[r])) : 0.f;
        x[j][c] = p;
        ps[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + tc::quad_sum(ps[r]);
  };
  uint32_t ph[BK / 16][4], pl[BK / 16][4];   // P of the tile in P V, bf16 hi / lo
  // P (f32, in x) as bf16 A fragments: hi = bf16(P), lo = bf16(P - hi)
  auto pack = [&](const float (&x)[SN][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float p0 = x[2 * kk + (f >> 1)][2 * (f & 1)];
        const float p1 = x[2 * kk + (f >> 1)][2 * (f & 1) + 1];
        ph[kk][f] = tc::pack_bf16(p0, p1);
        pl[kk][f] = tc::pack_bf16(p0 - __uint_as_float(ph[kk][f] << 16),
                                  p1 - __uint_as_float(ph[kk][f] & 0xffff0000u));
      }
  };

  // prologue: tile 0's scores and P
  float sc[SN][4];
  tc::cp_async_wait<1>();   // Q and tile 0 have landed
  wg::fence_proxy_async();
  __syncthreads();
  start_s(sc, 0);
  wg::wait_all();
  softmax(sc, 0);
  pack(sc);

  // Tile i: S of tile i + 1 starts before P V of tile i, so the softmax of
  // tile i + 1 runs on the CUDA cores while P V of tile i is on the tensor
  // cores; O takes tile i + 1's correction once P V of tile i is done.
  for (int i = 0; i < n_tiles; ++i) {
    tc::cp_async_wait<0>();   // K of tile i + 1 and V of tile i have landed
    wg::fence_proxy_async();
    __syncthreads();          // ... for every thread; K stage (i + 2) % NSK and V
                              // stage (i + NSV - 1) % NSV are free
    if (i + 2 < n_tiles) load_k(i + 2);
    if (i + NSV - 1 < n_tiles) load_v(i + NSV - 1);
    tc::cp_async_commit();
    start_s(sc, i + 1);       // past the last tile: a stale stage, never read
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd =
          wg::desc_sw128(v_a + (i % NSV) * V_BYTES + kk * (16 * 128), BK * 128, 1024);
      if constexpr (DV == 256) {
        wg::wgmma_rs_n256_tb(o, ph[kk], vd);
        wg::wgmma_rs_n256_tb(o, pl[kk], vd);
      } else if constexpr (DV == 128) {
        wg::wgmma_rs_n128_tb(o, ph[kk], vd);
        wg::wgmma_rs_n128_tb(o, pl[kk], vd);
      } else {
        wg::wgmma_rs_n64_tb(o, ph[kk], vd);
        wg::wgmma_rs_n64_tb(o, pl[kk], vd);
      }
    }
    wg::commit();
    wg::wait_group<1>();      // S of tile i + 1 is done
    if (i + 1 < n_tiles) softmax(sc, i + 1);
    wg::wait_all();           // P V of tile i is done
    if (i + 1 < n_tiles) {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < ON; ++j) {
          o[j][0] *= corr[0];
          o[j][1] *= corr[0];
          o[j][2] *= corr[1];
          o[j][3] *= corr[1];
        }
      }
      pack(sc);
    }
  }

  // O / l to bf16 through shared memory (the K/V ring is free), then out in
  // 16-byte row chunks of the slice's live columns
  constexpr int OS = DV * 2 + 16;   // staged row stride (bytes): rows 16 B apart in banks
  static_assert(size_t(BQ) * OS <= NSK * size_t(K_BYTES) + NSV * size_t(V_BYTES),
                "O fits the ring");
  __syncthreads();
  unsigned char* o_s = k_s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(o_s + (warp * 16 + g4 + 8 * r) * OS);
#pragma unroll
    for (int j = 0; j < ON; ++j)
      orow[j * 4 + t4] = tc::pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(a.out);
  for (int e = tid; e < BQ * VC; e += THREADS) {
    const int r = e / VC, c = e - r * VC, qp = q_start + r;
    if (qp < T_ && c0 + c * 8 < a.dv)
      *reinterpret_cast<uint4*>(out + ((size_t(b) * T_ + qp) * H + h) * a.dv + c0 + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * OS + c * 16);
  }
}

template <int DH, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_tc<DH, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.H * a.n_sl, a.B, (a.T + BQ - 1) / BQ);
  flash_prefill_tc<DH, DV><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tcp

// ---- f32 body launch -----------------------------------------------------

template <int DH, int DV>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<float, DH, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<float, DH, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + BQ - 1) / BQ, a.H * a.n_sl, a.B);
  flash_prefill_kernel<float, DH, DV><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Served widths: dh 64, 80, 128 or 256, and any dv that is a multiple of 8 from 8
// to 1,024 (r_v up to s * dh at group_size 8 and keep_ratio 1; the dense
// cache's dv = dh).  A block computes one value-column slice of DV = 64,
// 128 or 256 columns, the narrowest that holds dv, and past 256 the head's
// dv splits into ceil(dv / 256) slices along grid x (y for f32), each of
// which recomputes the scores.  qwen3-4b's main width (128, 256) is one
// full slice.  bf16 runs the tensor-core body, f32 the CUDA-core one.
template <int DH>
cudaError_t dispatch_dh(int is_bf16, Args a, cudaStream_t st) {
  const int w = a.dv <= 64 ? 64 : a.dv <= 128 ? 128 : 256;
  a.n_sl = (a.dv + w - 1) / w;
  if (w == 64) return is_bf16 ? tcp::launch<DH, 64>(a, st) : launch_f32<DH, 64>(a, st);
  if (w == 128) return is_bf16 ? tcp::launch<DH, 128>(a, st) : launch_f32<DH, 128>(a, st);
  return is_bf16 ? tcp::launch<DH, 256>(a, st) : launch_f32<DH, 256>(a, st);
}

bool supports(int dh, int dv) {
  return (dh == 64 || dh == 80 || dh == 128 || dh == 256) && dv >= 8 && dv <= 1024 &&
         dv % 8 == 0;
}

cudaError_t dispatch(int is_bf16, int dh, const Args& a, cudaStream_t st) {
  if (!supports(dh, a.dv)) return cudaErrorInvalidValue;
  if (dh == 64) return dispatch_dh<64>(is_bf16, a, st);
  if (dh == 80) return dispatch_dh<80>(is_bf16, a, st);
  return dh == 128 ? dispatch_dh<128>(is_bf16, a, st) : dispatch_dh<256>(is_bf16, a, st);
}

}  // namespace

extern "C" {

// 1 when (dh, dv) is a served width (see dispatch), else 0.
int recalkv_flash_prefill_supports(int dh, int dv) { return supports(dh, dv) ? 1 : 0; }

// Returns a cudaError_t (0 = success).  Tensors contiguous; ``is_bf16``
// selects bf16 (1) or f32 (0) for q, k, v and out; ``window`` <= 0 means
// no sliding window.
int recalkv_flash_prefill(int is_bf16, int dh, int dv, const void* q, const void* k,
                          const void* v, void* out, int B, int T, int H, int Hkv, int Hv,
                          int causal, int window, float scale, void* stream) {
  Args a{q, k, v, out, B, T, H, Hkv, Hv, window, causal, scale, dv, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(is_bf16, dh, a, st));
}

}  // extern "C"
