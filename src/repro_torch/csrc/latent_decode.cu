// ReCalKV latent-ring flash decode for Hopper (sm_90a), CUDA C++: six
// float32 kernels from one template, on CUDA cores.
//
//   K1 recalkv_latent_decode           replaces src/repro/kernels/
//                                      latent_decode.py::latent_decode_attention
//   K3 recalkv_latent_decode_quant     latent_decode_q.py::latent_decode_attention_quant
//   K5 recalkv_latent_decode_mq        latent_decode.py::latent_decode_attention_mq
//   K6 recalkv_latent_decode_mq_quant  latent_decode_q.py::latent_decode_attention_mq_quant
//   K4 recalkv_latent_decode_paged     latent_decode.py::latent_decode_attention_paged
//   K7 recalkv_latent_decode_mq_paged  latent_decode.py::latent_decode_attention_mq_paged
//
// Which body serves which (kernel, dtype): all six run here in float32
// only, as the parity instantiations the 1e-4 checks use (every entry
// point refuses bf16 q); in bf16 all six run the tensor-core body of
// latent_decode_tc.cu.
//
// For every (batch b, latent group g) and the R = nq * Hg query rows of
// that group (nq queries, Hg = s * qpk heads each, rows ordered (query,
// head); nq = 1 for K1/K3, spec_depth + 1 for K5/K6; a block takes the
// rows of qpb queries and sps head slots, see the plan below):
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
// K4/K7 read a page-major pool instead of a slot-major ring: latents
// (n_pages, page_size, G, r) and a (B, n_sp) int32 page table ``ptab``.
// Ring column t < S = n_sp * page_size of batch row b lives in pool row
// ptab[b, t / page_size] * page_size + t % page_size; the bias and the
// rotation tables stay slot-major (B, S, ...), as the JAX wrappers build
// them from the table-gathered positions.  The lookup is per row, because
// a 32-column tile spans several pages when page_size < 32, and a tile
// whose columns all sit on unmapped slot pages (the null page 0, pos = -1,
// bias masked) is skipped before anything is loaded, as in the ring
// kernels.  With the same chunking, K4 runs K1's tiles in K1's order on
// the same values, so its output is K1's on the gathered ring, bit for bit.
//
// What bounds it on an H100: at the main-path shape (B=8, S=4096, G=2,
// r=256, s=4, dh=128) a K1 call must read ~84 MB (zk, zv and the f32
// cos/sin tables) — 25 us at 3.35 TB/s — and do ~17 GFLOP of key
// reconstruction, 17 us on bf16 tensor cores.  The int8 ring reads
// r_k + r_v + 8 = 520 bytes per token and group instead of 1,024; the
// verify kernels add (nq - 1) * Hg rows of scoring per rebuilt key tile;
// the paged kernels read the mapped pages and the page table instead of
// the ring, the same bytes for a full table.
// This version does the reconstruction on CUDA cores from shared memory
// and is bound by that arithmetic (K1 took ~1.4 ms at that shape on an
// H100 80GB HBM3 at 700 W; chip_smoke.py measures the kernels and PERF.md
// keeps the times); latent_decode_tc.cu moves the (columns x r) @ (r x dh)
// product onto mma.sync tensor cores.
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
//  * One group's R_k (r x s*dh) is 512 KB in f32 (256 KB in bf16), above
//    the 227 KB a block may use.  It is streamed per head slot in (32 x dh) slices, and
//    each slot's keys are normalised and rotated in registers: a warp owns
//    whole key rows, so the per-head RMSNorm and the half-split RoPE need
//    only warp shuffles.
//  * Keys are rebuilt once per tile and scored by all nq queries (the
//    verify kernels' reason to exist; K1 is not launched nq times).
//  * Shared memory grows with the block's row count (q, acc and the
//    tile's scores) and with the column tile times the rank (the staged
//    latents).  At Hg = 16, dh = 128, r_k = r_v = 256 one block of all
//    rows and a 32-column tile needs ~221 KB with nq = 4 and f32 latents;
//    at group_size 8 (Hg = 32) and r = 1,024 the f32 latents of a
//    32-column tile alone take 256 KB.  So each (kernel, shape) takes a
//    plan — column tile SB in {32, 16, 8}, head slots per block sps
//    (dividing s), queries per block qpb (dividing nq) — the first that
//    fits, in the order: all rows (narrowing SB first), then fewer head
//    slots per block, then fewer queries per block.  The extra blocks
//    run along grid z.  A head-slot split costs only latent reloads (each
//    slot's keys are rebuilt once either way); a query split rebuilds
//    every key tile once per query block.  Every rank up to s * dh at
//    dh 128, group_size <= 8, Hg <= 32 and nq <= 8 fits, and gemma3-12b's
//    dh 256 at r = 512 on 16-column tiles; dh 80 (h2o-danube-1.8b) and
//    qwen3-moe-235b-a22b's 64 query rows a group take the same planner (the wrapper,
//    kernels/latent_decode.py, picks the plan; these are the parity
//    instantiations, and bf16 serves from latent_decode_tc.cu).  A shape
//    the main path had before keeps SB = 32 and one block of all rows,
//    so its arithmetic, and K4 == K1 bit for bit, are unchanged.
//  * Keys are never written to device memory.
//
// Contracts kept from the TPU kernels: masked logits use NEG_INF = -1e30
// (never -inf); a tile whose bias is masked for every query is skipped
// (no loads, no arithmetic); a row whose columns are all masked finishes
// as exact 0 (a row masked across a whole processed tile leaves its
// softmax state untouched, and the merge floors l at 1e-30).  Inputs are
// f32 (latents also int8); accumulation is f32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 8 warps; key tile SB in {32, 16, 8} tokens,
                              // one token per lane (lanes past SB idle)
constexpr int WARPS = THREADS / 32;
constexpr int RC = 32;        // rank rows of R_k staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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
  const float* q;             // (B, G, R, dh), R = nq * Hg, rows (query, head)
  const void* zk;             // (B, S, G, rk)   f32, or int8
  const void* zv;             // (B, S, G, rv)
  const float* zk_scale;      // (B, S, G) int8 ring only, else null
  const float* zv_scale;      // (B, S, G)
  const float* r_k;           // (G, rk, s*dh)
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
  float* out;                 // (B, G, R, rv)
  int B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols, n_chunks, chunk_len;
  const int* ptab;            // (B, S / page_size) page table, or null (ring)
  int page_size, n_pages;     // pool latents (n_pages, page_size, G, r)
  float scale, eps;
  int sps, qpb;               // head slots and queries per block (the plan)
  float* m_out;               // (B, G, R) merged softmax max, or null
  float* l_out;               // (B, G, R) merged softmax sum, or null
};

// Row blocks per (b, g): head-slot blocks times query blocks.
__host__ __device__ __forceinline__ int row_blocks(const Args& a) {
  return (a.s / a.sps) * (a.nq / a.qpb);
}

// Latent row of ring column t < S of batch row b: the slot-major ring
// row, or the pool row through the page table.  A page index outside the
// pool reads nothing (-1), so a bad table cannot fault the card.
__device__ __forceinline__ int latent_row(const Args& a, int b, int t) {
  if (a.ptab == nullptr) return b * a.S + t;
  const int n_sp = a.S / a.page_size;
  const int page = a.ptab[b * n_sp + t / a.page_size];
  if (page < 0 || page >= a.n_pages) return -1;
  return page * a.page_size + t % a.page_size;
}

template <int DH>
__host__ __device__ constexpr int k_stride() { return DH + 1; }

// R: the block's rows (qpb * sps * qpk); nq: its queries (qpb).
template <typename L, int DH, int SB>
size_t smem_bytes(int R, int nq, int rk, int rv) {
  size_t floats = size_t(R) * DH + size_t(R) * rv + 3 * R + size_t(R) * SB +
                  size_t(nq) * SB + 2 * SB * (DH / 2) + SB * k_stride<DH>() + RC * DH +
                  2 * SB + SB;  // + the tile's latent rows (int)
  return floats * sizeof(float) + size_t(SB) * (rk + rv) * sizeof(L);
}

// L: latent storage (float, or int8_t with per-(token, group) float
// scales); q, r_k and out are float.  Grid (n_chunks, G, B * row_blocks):
// block z covers batch row z / row_blocks and, of that row's (query,
// head) rows, queries j0 .. j0 + qpb - 1 and head slots i0 .. i0 + sps - 1.
template <typename L, int DH, int SB>
__global__ void __launch_bounds__(THREADS)
latent_decode_partial(Args a) {
  constexpr int HALF = DH / 2;
  constexpr int KS = k_stride<DH>();
  // A lane owns columns lane + 32 jj of each half of dh (jj < NH), so that
  // column d and its RoPE partner d + dh/2 sit in one lane; at dh 80 (half
  // 40) lanes 8-31 own one column of each half, lanes 0-7 two.
  constexpr int NH = (HALF + 31) / 32;   // key columns of each half per lane, at most
  constexpr int NJ = 2 * NH;             // key columns per lane, at most
  constexpr int NI = SB / WARPS;         // key rows per warp
  constexpr bool QUANT = sizeof(L) == 1;
  static_assert(DH % 16 == 0, "dh must be a multiple of 16");
  static_assert(SB % WARPS == 0 && SB <= 32, "SB: 8, 16 or 32 tokens");

  const int chunk = blockIdx.x, g = blockIdx.y;
  const int n_rb = row_blocks(a), slot_blocks = a.s / a.sps;
  const int b = blockIdx.z / n_rb, rb = blockIdx.z % n_rb;
  const int i0 = (rb % slot_blocks) * a.sps, j0 = (rb / slot_blocks) * a.qpb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // column jj of the lane, and whether it exists (always where 32 | dh/2)
  auto kcol = [&](int jj) { return (jj < NH ? 0 : HALF) + lane + 32 * (jj % NH); };
  auto kown = [&](int jj) { return HALF % 32 == 0 || lane + 32 * (jj % NH) < HALF; };
  const int Hg = a.Hg, rk = a.rk, rv = a.rv, s = a.s, G = a.G, S = a.S;
  const int sps = a.sps, nq = a.qpb, n_self = a.n_self;
  const int qpk = Hg / s;
  const int R = nq * sps * qpk, R_all = a.nq * Hg;
  // block row hl = (query jl, slot il, head hh) -> the group's row
  auto grow = [&](int hl) {
    const int hh = hl % qpk, il = (hl / qpk) % sps, jl = hl / (qpk * sps);
    return (j0 + jl) * Hg + (i0 + il) * qpk + hh;
  };
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
  int* row_s = reinterpret_cast<int*>(vsc_s + SB);  // SB latent rows (-1: none)
  L* zk_s = reinterpret_cast<L*>(row_s + SB);  // SB * rk
  L* zv_s = zk_s + SB * rk;                    // SB * rv

  const float* q = a.q;
  const L* zk = static_cast<const L*>(a.zk);
  const L* zv = static_cast<const L*>(a.zv);
  const float* rkp = a.r_k;
  const L* zk_self = static_cast<const L*>(a.zk_self);
  const L* zv_self = static_cast<const L*>(a.zv_self);

  for (int e = tid; e < R * DH; e += THREADS) {
    const int hl = e / DH;
    q_s[e] = to_f(q[((size_t(b) * G + g) * R_all + grow(hl)) * DH + e - hl * DH]);
  }
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
                   ? a.bias[(size_t(b) * a.nq + j0 + j) * a.bias_cols + t]
                   : 0.f;                                  // K1/K3 self column
        bias_s[j * SB + tid] = bv;
        valid |= bv > NEG_INF * 0.5f;
      }
    }
    if (!__syncthreads_or(valid)) continue;

    // -- latent rows of the tile's ring columns (ring or page table) -----
    if (tid < SB) {
      const int t = tt + tid;
      row_s[tid] = (t < t1 && t < S) ? latent_row(a, b, t) : -1;
    }
    __syncthreads();

    // -- latent, scale and rotation tiles -------------------------------
    for (int e = tid; e < SB * rk; e += THREADS) {
      const int i = e / rk, r = e - i * rk, t = tt + i;
      const int row = row_s[i];
      L v = L(0);
      if (row >= 0) v = zk[(size_t(row) * G + g) * rk + r];
      else if (t < t1 && t >= S)
        v = zk_self[((size_t(b) * n_self + (t - S)) * G + g) * rk + r];
      zk_s[e] = v;
    }
    for (int e = tid; e < SB * rv; e += THREADS) {
      const int i = e / rv, c = e - i * rv, t = tt + i;
      const int row = row_s[i];
      L v = L(0);
      if (row >= 0) v = zv[(size_t(row) * G + g) * rv + c];
      else if (t < t1 && t >= S)
        v = zv_self[((size_t(b) * n_self + (t - S)) * G + g) * rv + c];
      zv_s[e] = v;
    }
    if (QUANT && tid < SB) {
      const int t = tt + tid;
      const int row = row_s[tid];
      float ks = 0.f, vs = 0.f;
      if (row >= 0) {
        ks = a.zk_scale[size_t(row) * G + g];
        vs = a.zv_scale[size_t(row) * G + g];
      } else if (t < t1 && t >= S) {
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

    for (int il = 0; il < sps; ++il) {
      const int i = i0 + il;
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
          for (int jj = 0; jj < NJ; ++jj) rc[jj] = kown(jj) ? r_s[rr * DH + kcol(jj)] : 0.f;
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
            if (kown(jj)) kacc[ii][jj] *= inv * (1.f + a.k_norm[kcol(jj)]);
        }
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) {
          if (!kown(jj)) continue;
          const float c = cos_s[row * HALF + kcol(jj)];
          const float sn = sin_s[row * HALF + kcol(jj)];
          const float x1 = kacc[ii][jj], x2 = kacc[ii][jj + NH];
          kacc[ii][jj] = x1 * c - x2 * sn;
          kacc[ii][jj + NH] = x2 * c + x1 * sn;
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (kown(jj)) k_s[row * KS + kcol(jj)] = kacc[ii][jj];
      }
      __syncthreads();
      // -- scores of every query's qpk heads that read this slot -----------
      for (int e = tid; e < nq * qpk * SB; e += THREADS) {
        const int j = e / (qpk * SB), rem = e - j * qpk * SB;
        const int h = (j * sps + il) * qpk + rem / SB, t = rem % SB;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot = fmaf(q_s[h * DH + d], k_s[t * KS + d], dot);
        p_s[h * SB + t] = dot * a.scale + bias_s[j * SB + t];
      }
      __syncthreads();
    }

    // -- online softmax: one warp per row, one lane per token -------------
    for (int h = warp; h < R; h += WARPS) {
      const bool on = lane < SB;
      const float sc = on ? p_s[h * SB + lane] : NEG_INF;
      const float m_tile = warp_max(sc);
      if (m_tile <= NEG_INF * 0.5f) {
        // this row sees no column of the tile (another query does): its
        // state stays as it is, so a row masked everywhere ends as 0
        if (on) p_s[h * SB + lane] = 0.f;
        if (lane == 0) corr_s[h] = 1.f;
        continue;
      }
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, m_tile);
      const float p = on ? __expf(sc - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (on) p_s[h * SB + lane] = QUANT ? p * vsc_s[lane] : p;   // value scale folded in
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
  for (int e = tid; e < R * rv; e += THREADS) {
    const int hl = e / rv;
    a.part_acc[(base * R_all + grow(hl)) * rv + e - hl * rv] = acc_s[e];
  }
  for (int e = tid; e < R; e += THREADS) {
    a.part_m[base * R_all + grow(e)] = m_s[e];
    a.part_l[base * R_all + grow(e)] = l_s[e];
  }
}

// Log-sum-exp merge of the chunk partials: out = sum_k acc_k e^{m_k - M} /
// max(sum_k l_k e^{m_k - M}, 1e-30).  A fully masked row (no chunk saw a
// column: acc = 0, l = 0) finishes as exact 0.  With m_out / l_out each
// row's merged (M, L) is written too (NEG_INF and 0 for a row no chunk
// saw).
// Grid (ceil(R * rv / THREADS), G, B): one output element per thread.
__global__ void __launch_bounds__(THREADS)
latent_decode_merge(Args a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = a.nq * a.Hg, rv = a.rv, n = a.n_chunks;
  const size_t base = (size_t(b) * a.G + g) * n;
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
    a.out[((size_t(b) * a.G + g) * R) * rv + e] = O / fmaxf(L, 1e-30f);
    if (a.m_out != nullptr && e % rv == 0) {
      a.m_out[(size_t(b) * a.G + g) * R + h] = M;
      a.l_out[(size_t(b) * a.G + g) * R + h] = L;
    }
  }
}

template <typename L, int DH, int SB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rows = a.qpb * a.sps * (a.Hg / a.s);
  const size_t smem = smem_bytes<L, DH, SB>(rows, a.qpb, a.rk, a.rv);
  cudaError_t err = cudaFuncSetAttribute(latent_decode_partial<L, DH, SB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  latent_decode_partial<L, DH, SB>
      <<<dim3(a.n_chunks, a.G, a.B * row_blocks(a)), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (a.nq * a.Hg * a.rv + THREADS - 1) / THREADS;
  latent_decode_merge<<<dim3(merge_blocks, a.G, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, int SB>
cudaError_t launch_sb(bool quant, const Args& a, cudaStream_t st) {
  return quant ? launch<int8_t, DH, SB>(a, st) : launch<float, DH, SB>(a, st);
}

template <int DH>
cudaError_t launch_dh(int sb, bool quant, const Args& a, cudaStream_t st) {
  if (sb == 32) return launch_sb<DH, 32>(quant, a, st);
  if (sb == 16) return launch_sb<DH, 16>(quant, a, st);
  if (sb == 8) return launch_sb<DH, 8>(quant, a, st);
  return cudaErrorInvalidValue;
}

// Dispatch on (dh, SB, L); ``quant`` selects int8 latents.
int dispatch(int dh, int sb, bool quant, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dh == 64) err = launch_dh<64>(sb, quant, a, st);
  else if (dh == 80) err = launch_dh<80>(sb, quant, a, st);
  else if (dh == 128) err = launch_dh<128>(sb, quant, a, st);
  else if (dh == 256) err = launch_dh<256>(sb, quant, a, st);
  return static_cast<int>(err);
}

template <int DH, int SB>
long long smem_sb(int is_int8, int rows, int nq, int rk, int rv) {
  return static_cast<long long>(is_int8 ? smem_bytes<int8_t, DH, SB>(rows, nq, rk, rv)
                                        : smem_bytes<float, DH, SB>(rows, nq, rk, rv));
}

template <int DH>
long long smem_dh(int is_int8, int rows, int nq, int rk, int rv, int sb) {
  if (sb == 32) return smem_sb<DH, 32>(is_int8, rows, nq, rk, rv);
  if (sb == 16) return smem_sb<DH, 16>(is_int8, rows, nq, rk, rv);
  if (sb == 8) return smem_sb<DH, 8>(is_int8, rows, nq, rk, rv);
  return -1;
}

}  // namespace

extern "C" {

// Shared memory a block of the partial kernel needs (bytes) with ``rows``
// query rows of ``nq`` queries and an ``sb``-column tile, for the
// wrapper's plan; -1 for an unsupported dh or sb.
long long recalkv_latent_decode_smem(int is_int8, int dh, int rows, int nq, int rk, int rv,
                                     int sb) {
  if (dh == 64) return smem_dh<64>(is_int8, rows, nq, rk, rv, sb);
  if (dh == 80) return smem_dh<80>(is_int8, rows, nq, rk, rv, sb);
  if (dh == 128) return smem_dh<128>(is_int8, rows, nq, rk, rv, sb);
  if (dh == 256) return smem_dh<256>(is_int8, rows, nq, rk, rv, sb);
  return -1;
}

// The six entry points take the argument list of latent_decode_tc.cu's
// six plus the plan (sb, sps, qpb: column tile, head slots per block,
// queries per block) and return a cudaError_t (0 = success).  All tensors contiguous, on
// the device of ``stream``; q, r_k, out and (float rings) the latents f32:
// ``is_bf16`` must be 0.  Null self latents mean no self column; null
// k_norm means no key norm.  Each entry point checks that the operands
// match its kernel: scales present only for the int8 kernels, one query
// for K1/K3/K4, a page table (with page_size dividing S and a pool of
// n_pages pages) present only for the paged kernels K4/K7.
#define RECALKV_ENTRY(NAME, QUANT, MULTI, PAGED)                                         \
  int NAME(int is_bf16, int dh, const void* q, const void* zk, const void* zv,          \
           const float* zk_scale, const float* zv_scale, const void* r_k,               \
           const float* cos, const float* sin, const float* bias, const float* k_norm,  \
           const void* zk_self, const void* zv_self, const float* zk_self_scale,        \
           const float* zv_self_scale, const float* cos_self, const float* sin_self,    \
           float* part_acc, float* part_m, float* part_l, void* out, float* m_out,      \
           float* l_out, int B, int S, int G, int Hg, int rk, int rv, int s, int nq,    \
           int n_self, int bias_cols, int n_chunks, int chunk_len, const int* ptab,     \
           int page_size, int n_pages, float scale, float eps, void* stream, int sb,    \
           int sps, int qpb) {                                                          \
    if ((zk_scale != nullptr) != (QUANT) || (!(MULTI) && nq != 1) || is_bf16 != 0 ||   \
        (m_out == nullptr) != (l_out == nullptr) ||                                     \
        ((QUANT) && zk_self != nullptr && zk_self_scale == nullptr) ||                  \
        (ptab != nullptr) != (PAGED) ||                                                 \
        ((PAGED) && (page_size < 1 || S % page_size != 0 || n_pages < 1)) ||            \
        s < 1 || Hg % s != 0 || sps < 1 || s % sps != 0 || qpb < 1 || nq % qpb != 0 ||  \
        sb < 1 || chunk_len % sb != 0)                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                                   \
    Args a{static_cast<const float*>(q), zk, zv, zk_scale, zv_scale,                    \
           static_cast<const float*>(r_k), cos, sin, bias, k_norm, zk_self, zv_self,     \
           zk_self_scale, zv_self_scale, cos_self, sin_self, part_acc, part_m, part_l,   \
           static_cast<float*>(out), B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols,      \
           n_chunks, chunk_len, ptab, page_size, n_pages, scale, eps, sps, qpb, m_out,   \
           l_out};                                                                      \
    return dispatch(dh, sb, QUANT, a, static_cast<cudaStream_t>(stream));               \
  }

RECALKV_ENTRY(recalkv_latent_decode, false, false, false)          // K1
RECALKV_ENTRY(recalkv_latent_decode_quant, true, false, false)     // K3
RECALKV_ENTRY(recalkv_latent_decode_mq, false, true, false)        // K5
RECALKV_ENTRY(recalkv_latent_decode_mq_quant, true, true, false)   // K6
RECALKV_ENTRY(recalkv_latent_decode_paged, false, false, true)     // K4
RECALKV_ENTRY(recalkv_latent_decode_mq_paged, false, true, true)   // K7

#undef RECALKV_ENTRY

}  // extern "C"
