// K4, bf16: ReCalKV latent flash decode over the paged pool on tensor
// cores, for Hopper (sm_90a), CUDA C++.
//
// Replaces src/repro/kernels/latent_decode.py::latent_decode_attention_paged
// (Pallas) for bf16 operands; float32 operands go to the parity
// instantiation recalkv_latent_decode_paged of latent_decode.cu, which runs
// K1's tiles in K1's order.  For batch row b, latent group g, the Hg = s *
// qpk query rows of the group and the ring columns t < S = n_sp *
// page_size (pool row ptab[b, t / page_size] * page_size + t % page_size),
// plus one self column at bias 0:
//
//   K_i[t] = RoPE_t( RMSNorm_(1+k_norm)( zk[t] @ R_k[g][:, i*dh:(i+1)*dh] ) )
//   out    = softmax_t(scale * q[row] . K_{row / qpk}[t] + bias[b, t]) @ zv[t]
//
// What bounds it on an H100: at chip_smoke.py's shape (B=8, G=2, 1,415
// mapped 16-token pages, r=256, s=4, dh=128) the call must read ~59 MB
// (bytes bound ~18 us) and do ~12 GFLOP of key reconstruction (~12 us on
// bf16 tensor cores).  The earlier version rebuilt keys with scalar FMAs
// and re-read all of R_k (256 KB) from L2 for every 64 columns.
//
// Design:
//  * A block takes CH = 256 ring columns (four 64-column tiles) of one
//    (b, g): grid (ceil((S + 1) / CH), G, B), 256 threads, one block per
//    SM (~223 KB of shared memory).  Each R_k slice is read once per 256
//    columns: R_k streams through a two-stage cp.async ring in stages of
//    RC = 128 rank rows x dh of one head slot, bf16 as stored.
//  * The chunk's bias comes first: a 64-column tile whose bias is masked
//    everywhere (unmapped slot pages, null page 0, the ring's empty tail)
//    is never loaded or multiplied, and a chunk with no live tile writes
//    only m = NEG_INF, l = 0.  Live columns resolve their pool row through
//    the page table; masked columns of a live tile, and pages outside the
//    pool, are zero-filled instead of loaded.  The chunk's zk rows (256 x
//    r bf16) are loaded once by 16-byte cp.async; zv later reuses their
//    space.
//  * Key rebuild: warp w owns the 16-column m-tiles w and w + 8 and all dh
//    columns, as mma.sync.m16n8k16 products (A = zk rows by ldmatrix, B =
//    the R_k stage by transposed ldmatrix, f32 accumulators in registers).
//    Since a thread's fragments hold columns d and d + dh/2 of the same
//    key row, the per-head RMSNorm needs only a quad reduction and the
//    half-split RoPE no shuffle.
//  * Scoring: the rotated keys are the A fragments of one more product
//    against the slot's qpk query rows (B = Q^T, n = 8), so keys never
//    leave registers.  Scores (+ bias) go to shared memory.
//  * Softmax over the chunk's 256 columns in one pass (every score of the
//    chunk is in shared memory), P written in place of its scores; then
//    acc (16 x r_v) = P @ zv on tensor cores, r_v split across the 8
//    warps, skipping dead tiles.  A second small kernel merges the chunks
//    by log-sum-exp, skipping chunks that saw nothing.
//  * Precision: the keys (for scoring) and P (for P zv) enter their
//    products as bf16 hi + lo pairs (tc::split_bf16), two mma.sync on the
//    same B fragments, so both carry ~2^-17 relative error.  One bf16
//    rounding of each (2^-9) reaches 1.25x chip_smoke.py's bf16 limit on a
//    ragged ring of its widths in the CPU emulation (python
//    tests/test_torch_tc_rounding.py --ring); the two extra products add
//    ~6% to the key rebuild's tensor-core work.
//
// Contracts: masked logits are NEG_INF = -1e30; fully masked tiles are
// skipped before any load; a row masked everywhere finishes as exact 0
// (its chunks have l = 0 and the merge floors l at 1e-30); keys are never
// written to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int CH = 256;          // ring columns of a block
constexpr int TILE = 64;         // skip granularity
constexpr int NT = CH / TILE;    // tiles of a block
constexpr int THREADS = 256, WARPS = 8;
constexpr int RC = 128;          // rank rows of R_k per pipeline stage
constexpr int ROWS = 16;         // query rows of a group (Hg <= 16)
constexpr int SCS = CH + 4;      // score row stride (floats): P rows 16 B apart in banks
static_assert(CH == THREADS, "one column per thread for the bias pass");
static_assert(CH == 32 * WARPS, "warp w owns m-tiles w and w + WARPS");

struct Args {
  const bf16* q;            // (B, G, Hg, dh)
  const bf16* zk;           // (n_pages, page_size, G, rk)
  const bf16* zv;           // (n_pages, page_size, G, rv)
  const bf16* r_k;          // (G, rk, s*dh)
  const float* cos;         // (B, S, dh/2)
  const float* sin;         // (B, S, dh/2)
  const float* bias;        // (B, S)
  const float* k_norm;      // (dh,) or null
  const bf16* zk_self;      // (B, G, rk) or null
  const bf16* zv_self;      // (B, G, rv)
  const float* cos_self;    // (B, dh/2)
  const float* sin_self;    // (B, dh/2)
  const int* ptab;          // (B, S / page_size)
  float* part_acc;          // (B, G, n_chunks, Hg, rv)
  float* part_m;            // (B, G, n_chunks, Hg)
  float* part_l;            // (B, G, n_chunks, Hg)
  bf16* out;                // (B, G, Hg, rv)
  int B, S, G, Hg, rk, rv, s, n_self, n_chunks, page_size, n_pages;
  float scale, eps;
};

__host__ __device__ constexpr int z_stride(int rk, int rv) { return (rk > rv ? rk : rv) + 8; }

template <int DH>
__host__ __device__ constexpr size_t smem_bytes(int rk, int rv) {
  return size_t(CH) * z_stride(rk, rv) * 2      // zk, then zv, rows
         + 2 * size_t(RC) * (DH + 8) * 2        // R_k ring
         + size_t(ROWS) * SCS * 4               // scores, then P hi and lo (bf16) in place
         + size_t(ROWS) * (DH + 8) * 2          // q rows
         + DH * 4 + CH * 4 + CH * 4 + 16;       // 1 + k_norm, bias, rows, tile flags
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
paged_decode_tc(Args a) {
  constexpr int HALF = DH / 2;
  constexpr int RS = DH + 8;   // R_k / q row stride (bf16)
  constexpr int NN = DH / 8;   // key n-tiles of a warp's m-tile
  static_assert(DH % 64 == 0, "dh must be a multiple of 64");

  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int S = a.S, G = a.G, Hg = a.Hg, rk = a.rk, rv = a.rv, s = a.s;
  const int qpk = Hg / s;
  const int S_ext = S + a.n_self;
  const int t0 = chunk * CH;
  const int ZS = z_stride(rk, rv);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* z_s = reinterpret_cast<bf16*>(smem_raw);            // CH x ZS
  bf16* r_s = z_s + CH * ZS;                                 // 2 x RC x RS
  float* sc_s = reinterpret_cast<float*>(r_s + 2 * RC * RS); // ROWS x SCS
  bf16* q_s = reinterpret_cast<bf16*>(sc_s + ROWS * SCS);    // ROWS x RS
  float* kn_s = reinterpret_cast<float*>(q_s + ROWS * RS);   // DH
  float* bias_s = kn_s + DH;                                 // CH
  int* row_s = reinterpret_cast<int*>(bias_s + CH);          // CH
  int* live_s = row_s + CH;                                  // NT

  // -- bias first: which tiles of the chunk are live, and their pool rows --
  if (tid < NT) live_s[tid] = 0;
  __syncthreads();
  {
    const int t = t0 + tid;
    float bv = NEG_INF;
    int row = -1;   // -1: zero-filled; -2: the self column
    if (t < S) {
      bv = a.bias[size_t(b) * S + t];
      if (bv > NEG_INF * 0.5f) {
        const int n_sp = S / a.page_size;
        const int page = a.ptab[b * n_sp + t / a.page_size];
        if (page >= 0 && page < a.n_pages) row = page * a.page_size + t % a.page_size;
      }
    } else if (t < S_ext) {
      bv = 0.f;
      row = -2;
    }
    bias_s[tid] = bv;
    row_s[tid] = row;
    if (bv > NEG_INF * 0.5f) live_s[tid / TILE] = 1;
  }
  __syncthreads();
  const size_t base = (size_t(b) * G + g) * a.n_chunks + chunk;
  if (!(live_s[0] | live_s[1] | live_s[2] | live_s[3])) {
    if (tid < Hg) {
      a.part_m[base * Hg + tid] = NEG_INF;
      a.part_l[base * Hg + tid] = 0.f;
    }
    return;
  }

  // -- async loads: q rows, zk rows of live tiles, the first R_k stages ----
  for (int e = tid; e < ROWS * (DH / 8); e += THREADS) {
    const int r = e / (DH / 8), c = e - r * (DH / 8);
    const bool ok = r < Hg;
    tc::cp_async16(q_s + r * RS + c * 8,
                   a.q + ((size_t(b) * G + g) * Hg + (ok ? r : 0)) * DH + c * 8, ok);
  }
  const bool has_norm = a.k_norm != nullptr;
  if (tid < DH) kn_s[tid] = has_norm ? 1.f + a.k_norm[tid] : 1.f;
  auto load_latents = [&](const bf16* pool, const bf16* self, int r) {
    const int nc = r / 8;
    for (int e = tid; e < CH * nc; e += THREADS) {
      const int i = e / nc, c = e - i * nc;
      if (!live_s[i / TILE]) continue;
      const int row = row_s[i];
      const bf16* src = row >= 0    ? pool + (size_t(row) * G + g) * r + c * 8
                        : row == -2 ? self + (size_t(b) * G + g) * r + c * 8
                                    : pool;
      tc::cp_async16(z_s + i * ZS + c * 8, src, row != -1);
    }
  };
  load_latents(a.zk, a.zk_self, rk);
  tc::cp_async_commit();

  const int nkc = (rk + RC - 1) / RC;   // R_k stages per head slot
  const int n_st = s * nkc;
  const bf16* rkg = a.r_k + size_t(g) * rk * s * DH;
  auto load_r = [&](int st) {
    const int i = st / nkc, r0 = (st % nkc) * RC, rn = min(RC, rk - r0);
    bf16* dst = r_s + (st & 1) * RC * RS;
    for (int e = tid; e < rn * (DH / 8); e += THREADS) {
      const int rr = e / (DH / 8), c = e - rr * (DH / 8);
      tc::cp_async16(dst + rr * RS + c * 8, rkg + size_t(r0 + rr) * s * DH + i * DH + c * 8,
                     true);
    }
  };
  load_r(0);
  tc::cp_async_commit();
  if (n_st > 1) load_r(1);
  tc::cp_async_commit();

  // -- key rebuild, k-norm, RoPE and scores, one head slot at a time -------
  const bool live0 = live_s[warp / 4] != 0;         // m-tile warp
  const bool live1 = live_s[(warp + WARPS) / 4] != 0;  // m-tile warp + 8
  float acc[2][NN][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][j][c] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    tc::cp_async_wait<1>();
    __syncthreads();
    const int slot = st / nkc, kc = st % nkc;
    const int r0 = kc * RC, rn = min(RC, rk - r0);
    const bf16* rs = r_s + (st & 1) * RC * RS;
    if (live0 || live1) {
      const bf16* za = z_s + (warp * 16 + (lane & 15)) * ZS + r0 + (lane >> 4) * 8;
      const bf16* zb = za + WARPS * 16 * ZS;
      for (int ks = 0; ks < rn / 16; ++ks) {
        uint32_t fa[4], fb[4];
        if (live0) tc::ldsm_x4(fa, za + ks * 16);
        if (live1) tc::ldsm_x4(fb, zb + ks * 16);
        const bf16* rrow = rs + (ks * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t rb[4];
          tc::ldsm_x4_t(rb, rrow + np * 16);
          if (live0) {
            tc::mma16816(acc[0][2 * np], fa, rb[0], rb[1]);
            tc::mma16816(acc[0][2 * np + 1], fa, rb[2], rb[3]);
          }
          if (live1) {
            tc::mma16816(acc[1][2 * np], fb, rb[0], rb[1]);
            tc::mma16816(acc[1][2 * np + 1], fb, rb[2], rb[3]);
          }
        }
      }
    }
    if (kc == nkc - 1) {
      // B fragments of Q^T for this slot: column n = g4 is query row
      // slot * qpk + g4 (rows past qpk are computed and dropped)
      const int qrow = min(slot * qpk + g4, ROWS - 1);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!(u == 0 ? live0 : live1)) continue;
        float(&k)[NN][4] = acc[u];
        const int mt = warp + WARPS * u;
        if (has_norm) {
          float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
          for (int j = 0; j < NN; ++j) {
            ss0 += k[j][0] * k[j][0] + k[j][1] * k[j][1];
            ss1 += k[j][2] * k[j][2] + k[j][3] * k[j][3];
          }
          const float i0 = rsqrtf(tc::quad_sum(ss0) / DH + a.eps);
          const float i1 = rsqrtf(tc::quad_sum(ss1) / DH + a.eps);
#pragma unroll
          for (int j = 0; j < NN; ++j) {
            const float w0 = kn_s[j * 8 + 2 * t4], w1 = kn_s[j * 8 + 2 * t4 + 1];
            k[j][0] *= i0 * w0;
            k[j][1] *= i0 * w1;
            k[j][2] *= i1 * w0;
            k[j][3] *= i1 * w1;
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + mt * 16 + g4 + 8 * hr;
          const float* cp = nullptr;
          const float* sp = nullptr;
          if (t < S) {
            cp = a.cos + (size_t(b) * S + t) * HALF;
            sp = a.sin + (size_t(b) * S + t) * HALF;
          } else if (t < S_ext) {
            cp = a.cos_self + (size_t(b) * a.n_self + (t - S)) * HALF;
            sp = a.sin_self + (size_t(b) * a.n_self + (t - S)) * HALF;
          }
#pragma unroll
          for (int j = 0; j < NN / 2; ++j) {
            float2 c = make_float2(1.f, 1.f), sn = make_float2(0.f, 0.f);
            if (cp != nullptr) {
              c = *reinterpret_cast<const float2*>(cp + j * 8 + 2 * t4);
              sn = *reinterpret_cast<const float2*>(sp + j * 8 + 2 * t4);
            }
            const float x1a = k[j][2 * hr], x2a = k[j + NN / 2][2 * hr];
            const float x1b = k[j][2 * hr + 1], x2b = k[j + NN / 2][2 * hr + 1];
            k[j][2 * hr] = x1a * c.x - x2a * sn.x;
            k[j + NN / 2][2 * hr] = x2a * c.x + x1a * sn.x;
            k[j][2 * hr + 1] = x1b * c.y - x2b * sn.y;
            k[j + NN / 2][2 * hr + 1] = x2b * c.y + x1b * sn.y;
          }
        }
        // scores^T (16 columns x 8 query rows) = (K_hi + K_lo) @ Q^T
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* qr = q_s + qrow * RS + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
            tc::split_bf16(k[2 * kk + (f >> 1)][2 * (f & 1)], k[2 * kk + (f >> 1)][2 * (f & 1) + 1],
                           fh[f], fl[f]);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
          tc::mma16816(sacc, fh, b0, b1);
          tc::mma16816(sacc, fl, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * t4 + (e & 1);
          const int col = mt * 16 + g4 + 8 * (e >> 1);
          if (j < qpk) sc_s[(slot * qpk + j) * SCS + col] = sacc[e] * a.scale + bias_s[col];
        }
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) k[j][c] = 0.f;
      }
    }
    __syncthreads();   // every warp is done with this R_k stage
    if (st + 2 < n_st) load_r(st + 2);
    tc::cp_async_commit();
  }

  // -- zv rows into the keys' space, while the softmax runs -----------------
  load_latents(a.zv, a.zv_self, rv);
  tc::cp_async_commit();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int h = warp + WARPS * u;
    float x[CH / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < CH / 32; ++k) {
      const int col = lane + 32 * k;
      x[k] = (h < Hg && live_s[col / TILE]) ? sc_s[h * SCS + col] : NEG_INF;
      mx = fmaxf(mx, x[k]);
    }
    mx = warp_max(mx);
    const bool alive = mx > NEG_INF * 0.5f;
    __syncwarp();   // every lane has read its scores before P overwrites the row
    bf16* prow = reinterpret_cast<bf16*>(sc_s + h * SCS);   // P_hi [0, CH), P_lo [CH, 2 CH)
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < CH / 32; ++k) {
      const float p = alive ? __expf(x[k] - mx) : 0.f;
      const bf16 hi = __float2bfloat16(p);
      prow[lane + 32 * k] = hi;
      prow[CH + lane + 32 * k] = __float2bfloat16(p - __bfloat162float(hi));
      lsum += p;
    }
    lsum = warp_sum(lsum);
    if (lane == 0 && h < Hg) {
      a.part_m[base * Hg + h] = alive ? mx : NEG_INF;
      a.part_l[base * Hg + h] = lsum;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // -- acc (16 x rv) = P @ zv; warp w takes value n-tiles w, w+8, w+16, w+24
  const int nv = rv / 8;
  float o[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[u][c] = 0.f;
  const bf16* p_s = reinterpret_cast<const bf16*>(sc_s);
  constexpr int PS = SCS * 2;   // P row stride in bf16 elements
  for (int kt = 0; kt < NT; ++kt) {
    if (!live_s[kt]) continue;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const int k0 = kt * TILE + kk * 16;
      uint32_t ph[4], pl[4];
      const bf16* prow = p_s + (lane & 15) * PS + k0 + (lane >> 4) * 8;
      tc::ldsm_x4(ph, prow);
      tc::ldsm_x4(pl, prow + CH);
      const bf16* vrow = z_s + (k0 + (lane & 15)) * ZS;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = warp + WARPS * u;
        if (n < nv) {
          uint32_t b0, b1;
          tc::ldsm_x2_t(b0, b1, vrow + n * 8);
          tc::mma16816(o[u], ph, b0, b1);
          tc::mma16816(o[u], pl, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = warp + WARPS * u;
    if (n >= nv) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int h = g4 + 8 * hr;
      if (h < Hg)
        *reinterpret_cast<float2*>(a.part_acc + (base * Hg + h) * rv + n * 8 + 2 * t4) =
            make_float2(o[u][2 * hr], o[u][2 * hr + 1]);
    }
  }
}

// Log-sum-exp merge of the chunk partials: out = sum_k acc_k e^{m_k - M} /
// max(sum_k l_k e^{m_k - M}, 1e-30) over the chunks that saw a column (a
// chunk with m_k = NEG_INF wrote no acc).  A row no chunk saw finishes as
// exact 0.  Grid (ceil(Hg * rv / THREADS), G, B).
__global__ void __launch_bounds__(THREADS)
paged_decode_merge(Args a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = a.Hg, rv = a.rv, n = a.n_chunks;
  const size_t base = (size_t(b) * a.G + g) * n;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= R * rv) return;
  const int h = e / rv;
  float M = NEG_INF;
  for (int k = 0; k < n; ++k) M = fmaxf(M, a.part_m[(base + k) * R + h]);
  float L = 0.f, O = 0.f;
  for (int k = 0; k < n; ++k) {
    const float mk = a.part_m[(base + k) * R + h];
    if (mk <= NEG_INF * 0.5f) continue;
    const float w = __expf(mk - M);
    L += a.part_l[(base + k) * R + h] * w;
    O += a.part_acc[(base + k) * R * rv + e] * w;
  }
  a.out[((size_t(b) * a.G + g) * R) * rv + e] = __float2bfloat16(O / fmaxf(L, 1e-30f));
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(a.rk, a.rv);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_tc<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_decode_tc<DH><<<dim3(a.n_chunks, a.G, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (a.Hg * a.rv + THREADS - 1) / THREADS;
  paged_decode_merge<<<dim3(merge_blocks, a.G, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ring columns per block, so the wrapper can size the partial buffers.
int recalkv_paged_tc_chunk() { return CH; }

// Shared memory one block needs (bytes), -1 for an unsupported dh.
long long recalkv_paged_tc_smem(int dh, int rk, int rv) {
  if (dh == 64) return static_cast<long long>(smem_bytes<64>(rk, rv));
  if (dh == 128) return static_cast<long long>(smem_bytes<128>(rk, rv));
  return -1;
}

// K4 in bf16.  Returns a cudaError_t (0 = success).  All tensors
// contiguous, on the device of ``stream``; null self latents mean no self
// column, null k_norm no key norm.  The wrapper checks the shapes: Hg <=
// 16 rows with qpk = Hg / s <= 8, r_k a multiple of 16, r_v of 8, both at
// most 256, and n_chunks = ceil((S + n_self) / recalkv_paged_tc_chunk()).
int recalkv_latent_decode_paged_tc(int dh, const void* q, const void* zk, const void* zv,
                                   const void* r_k, const float* cos, const float* sin,
                                   const float* bias, const float* k_norm,
                                   const void* zk_self, const void* zv_self,
                                   const float* cos_self, const float* sin_self,
                                   const int* ptab, float* part_acc, float* part_m,
                                   float* part_l, void* out, int B, int S, int G, int Hg,
                                   int rk, int rv, int s, int n_chunks, int page_size,
                                   int n_pages, float scale, float eps, void* stream) {
  const int n_self = zk_self != nullptr ? 1 : 0;
  if (Hg < 1 || Hg > ROWS || s < 1 || Hg % s != 0 || Hg / s > 8 || rk % 16 != 0 ||
      rk < 16 || rk > 256 || rv % 8 != 0 || rv < 8 || rv > 256 || page_size < 1 ||
      S % page_size != 0 || n_pages < 1 || n_chunks != (S + n_self + CH - 1) / CH)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(zk),
         static_cast<const bf16*>(zv), static_cast<const bf16*>(r_k), cos, sin, bias,
         k_norm, static_cast<const bf16*>(zk_self), static_cast<const bf16*>(zv_self),
         cos_self, sin_self, ptab, part_acc, part_m, part_l, static_cast<bf16*>(out),
         B, S, G, Hg, rk, rv, s, n_self, n_chunks, page_size, n_pages, scale, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return static_cast<int>(launch<64>(a, st));
  if (dh == 128) return static_cast<int>(launch<128>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
