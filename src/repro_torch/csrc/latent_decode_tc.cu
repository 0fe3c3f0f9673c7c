// K1 and K3-K7 in bf16: ReCalKV latent flash decode on tensor cores, for
// Hopper (sm_90a), CUDA C++.  One templated body, six entry points:
//
//   K1 recalkv_latent_decode_tc           replaces src/repro/kernels/latent_decode.py::
//                                         latent_decode_attention (the ring, bf16 latents)
//   K3 recalkv_latent_decode_quant_tc     latent_decode_q.py::latent_decode_attention_quant
//                                         (the int8 ring, one query)
//   K4 recalkv_latent_decode_paged_tc     latent_decode.py::latent_decode_attention_paged
//                                         (a page-major pool through a page table)
//   K5 recalkv_latent_decode_mq_tc        latent_decode.py::latent_decode_attention_mq
//                                         (the ring, nq verify queries)
//   K6 recalkv_latent_decode_mq_quant_tc  latent_decode_q.py::latent_decode_attention_mq_quant
//                                         (the int8 ring, nq verify queries)
//   K7 recalkv_latent_decode_mq_paged_tc  latent_decode.py::latent_decode_attention_mq_paged
//                                         (the pool, nq verify queries)
//
// Float32 operands of all six go to the CUDA-core template of
// latent_decode.cu (the parity instantiations the 1e-4 checks use).  For
// batch row b, latent group g, the R = nq * Hg query rows of the group
// (ordered (query j, head h), Hg = s * qpk) and the ring columns t < S plus
// n_self self columns:
//
//   K_i[t] = RoPE_t( RMSNorm_(1+k_norm)( ks[t] * zk[t] @ R_k[g][:, i*dh:(i+1)*dh] ) )
//   out    = softmax_t(scale * q[j, h] . K_{h / qpk}[t] + bias[b, j, t]) @ (vs[t] * zv[t])
//
// ks = vs = 1 for bf16 latents; int8 latents carry one f32 scale each per
// (token, group).  Ring column t of row b is latent row b * S + t (K1, K3,
// K5, K6) or ptab[b, t / page_size] * page_size + t % page_size (K4, K7).
// K1 / K3 / K4 score one self column at bias 0; K5 / K6 / K7 read their nq
// self columns' bias from the last n_self columns of their (B, nq, S +
// n_self) bias.  The self tokens' latents, scales and rotation tables are
// operands.
//
// What bounds it on an H100: at chip_smoke.py's K1 shape (B=8, a full
// 4096-token ring, G=2, r=256, s=4, dh=128) a call reads ~84 MB (bytes
// bound ~25 us) and does ~17 GFLOP of key reconstruction (~17 us on bf16
// tensor cores); the int8 ring reads 520 instead of 1,024 latent bytes per
// token and group, and the verify bodies score nq * Hg rows per rebuilt
// key.  The CUDA-core template rebuilt keys with scalar FMAs and re-read
// all of R_k (256 KB) from L2 for every 32 columns.
//
// Design:
//  * A block takes CH ring columns of one (b, g): 256 (four 64-column
//    tiles) with one query set, 128 with up to four (K5, K6, K7, see
//    below); 256 threads, one block per SM.  Grid (G * B, ceil((S +
//    n_self) / CH), query blocks x head-slot blocks), chunk-major, so the
//    chunks that hold only self columns launch last and fill the tail of
//    the last wave.  Each R_k slice is read once per CH columns: R_k streams
//    through a two-stage cp.async ring in stages of rc = 128 rank rows x dh
//    of one head slot, bf16 as stored.  r_k that is a multiple of 8 but not
//    of 16 is padded to 16 with zero latents and zero R_k rows, which add
//    exact zeros to the products.
//  * Ranks past 256 (recalkv ratios above 0.5, Fisher-allocated layers,
//    group_size 8 at s * dh = 1,024) would overflow shared memory at these
//    widths, so plan_dh narrows the chunk to 128 columns, then the stage to
//    64 rows, then the chunk to 64 columns (with a 128-row stage, then a
//    64-row one): at dh = 128 every rank up to s * dh = 1,024 (group_size
//    8) fits every body (~212 KB one-query, ~204 KB multi-query at r =
//    1,024).  The 64-column plan is taken only where no wider one fits, so
//    every width a wider plan serves keeps its bits.
//  * 64 columns are 4 key m-tiles for 8 warps.  Two warps share an m-tile
//    (KS = 2), each rebuilding the keys of one quarter of each half of dh,
//    columns d and d + dh/2 in the same warp, so RoPE still needs no
//    shuffle; the per-head RMSNorm adds the two warps' sums of squares
//    through shared memory, and the first warp adds the second's partial
//    scores to its own before the bias.  Two block barriers per head slot
//    are the cost.  Streaming zk through the rank dimension instead would
//    keep a warp per m-tile but re-read the chunk's latents from shared
//    memory once per head slot and R_k stage pair, and would need a third
//    pipeline; the split keeps the loads and stages of the wider plans.
//    The chunk partials grow as the chunk narrows: (B, G, n_chunks, R,
//    r_v) f32, ~270 MB for K5 at B = 8, S = 4,096, R = 128, r_v = 1,024.
//  * The chunk's bias comes first: a 64-column tile whose bias is masked
//    for every query (the ring's empty tail, unmapped slot pages, the null
//    page 0) is never loaded or multiplied, and a chunk with no live tile
//    writes only m = NEG_INF, l = 0.  Live columns resolve their latent
//    row through the row map; masked columns of a live tile, and pages
//    outside the pool, are zero-filled instead of loaded.  bf16 latent rows
//    (CH x r) arrive by 16-byte cp.async; int8 rows are read 8 values at a
//    time and stored as bf16 (exact: |x| <= 127), so both feed the same
//    ldmatrix paths.  zv later reuses the space of zk.
//  * Key rebuild: warp w owns the 16-column m-tiles w (and w + 8 at CH =
//    256) and all dh columns (half of them at CH = 64, above), as
//    mma.sync.m16n8k16 products (A = latent rows by ldmatrix, B = the R_k
//    stage by transposed ldmatrix, f32 accumulators in registers).  The key
//    scale multiplies each rebuilt row before k-norm.  Since a thread's
//    fragments hold columns d and d + dh/2 of the same key row, the
//    per-head RMSNorm needs only a quad reduction and the half-split RoPE
//    no shuffle.
//  * Scoring: the rotated keys are the A fragments of one more product
//    against the slot's nq * qpk query rows (B = Q^T, n = 8; n = 16 as two
//    n8 tiles for the verify bodies), so keys never leave registers.
//    Scores (+ each query's bias) go to shared memory.
//  * Softmax over the chunk in one pass (every score of the chunk is in
//    shared memory), P (times the value scale) written in place of its
//    scores; then acc (R x r_v) = P @ zv on tensor cores, r_v split across
//    the 8 warps in passes of 32 n8 tiles (two passes past r_v = 256), R
//    in m16 tiles, skipping dead tiles.  bf16 zv rows arrive by cp.async
//    while the softmax runs.  A second small kernel merges the chunks by
//    log-sum-exp, skipping chunks that saw nothing.
//  * Precision: the keys (for scoring) and P (for P zv) enter their
//    products as bf16 hi + lo pairs (tc::split_bf16), two mma.sync on the
//    same B fragments, so both carry ~2^-17 relative error.  One bf16
//    rounding of each (2^-9) misses chip_smoke.py's bf16 limit on a ragged
//    ring of its widths in the CPU emulation (python
//    tests/test_torch_tc_rounding.py --ring).
//  * The verify bodies' shared memory.  Their 64 score rows (nq = 4 x Hg
//    = 16) at CH = 256 would take 66,560 B of scores and 17,408 B of q
//    rows, ~290 KB in all with K4's 135 KB of latent rows and 70 KB R_k
//    ring, over the 227 KB a block may use.  They run CH = 128 instead
//    (~193 KB): the R_k ring keeps its two stages (a one-stage ring would
//    stall every stage on its load), scores stay f32 for the one-pass
//    softmax, and the cost is R_k read from L2 once per 128 columns
//    instead of 256.  A verify window of more than 4 query sets (spec_depth
//    >= 4) adds query blocks along grid z, each of qg = min(4, 16 /
//    q_per_kv) sets: each re-reads the chunk's latents and R_k, and the
//    merge sees every row as before.
//  * More than 16 query rows per group (Hg > 16: group_size 8 puts s = 8
//    kv heads and 32 query heads in one group).  A block holds at most 16
//    score rows (64 for the verify bodies), so grid z also splits the s
//    head slots into blocks of sps, the largest divisor of s with qg * sps
//    * q_per_kv <= ROWS; a block rebuilds keys and streams R_k for its own
//    slots only, re-reading the chunk's latents, and the merge sees every
//    row.  At Hg <= 16 one block takes every slot and the launch is the
//    unsplit one.
//  * K3 is K1's instantiation with int8 latents: the 256-column chunk
//    (230,416 B of shared memory at dh = 128, r = 256) with the rows
//    converted as K6's are and the key / value scales applied as above.
//    K5 is K6's with bf16 latents (loaded as K1's are).
//  * dh 256 (gemma3-12b: s = 4 kv heads of 256, r = 512 at recalkv_ratio
//    0.5) takes the 64-column plan only.  A warp's rebuilt keys are 16 rows
//    x dh f32 at KS = 1, 128 registers for one m-tile at dh 256 (as two
//    m-tiles are at dh 128 on the 256-column plan, which sits at 255 with
//    its stage depth known at compile time); two warps per m-tile halve
//    that to the 64 the 128-column plan holds at dh 128.  Shared memory
//    takes rc 128 for one query set (~217 KB at r = 512) and rc 64 for the
//    verify bodies (~188 KB).  The cost is R_k read from L2 once per 64
//    columns and chunk partials for 64 chunks of a 4,096-column ring.
//  * dh 80 (h2o-danube-1.8b: s = 4 kv heads of 80, r = 160 at recalkv_ratio
//    0.5) is 5 k16 steps and 10 n8 tiles: a warp at KS = 1 holds n-tiles j
//    and j + 5, columns d and d + 40, so RoPE still needs no shuffle, and
//    its 176-byte R_k / q rows keep ldmatrix free of bank conflicts.  Its
//    10 n-tiles do not split into the quarters two warps share at KS = 2, so
//    it has no 64-column plan; the 128-column plan takes R_k stages down to
//    32 rows instead, and every rank up to s * dh = 640 at group_size 8
//    fits.
//  * q_per_kv 16 (qwen3-moe-235b-a22b: 64 q heads over 4 kv heads).  The
//    verify bodies already score 16 rows a slot as two n8 tiles; a one-query
//    call past 8 rows a slot runs the multi-query instantiation of its row
//    map and latent type at nq = 1 (entry below), whose 64 score rows hold
//    all four slots of the group: one read of the chunk's latents, R_k read
//    once per 128 columns.
//  * K1 and K4, and K5 and K7, are the same instantiation but for the row
//    map, with the same block plan and chunks in the same order: K4 (K7) on
//    a pool equals K1 (K5) on the table-gathered ring bit for bit (masked
//    columns are zero-filled in both, and their P is exactly 0).
//
// Contracts: masked logits are NEG_INF = -1e30; tiles masked for every
// query are skipped before any load; a row masked everywhere finishes as
// exact 0 (its chunks have l = 0 and the merge floors l at 1e-30); keys
// are never written to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;         // skip granularity
constexpr int THREADS = 256, WARPS = 8;
constexpr size_t SMEM_LIMIT = 232448;   // bytes of shared memory a Hopper block may use

// Tile shape of a body: CH ring columns of one query set (K1, K3, K4) or of up
// to four (K5, K6, K7) per block.
template <int CH_, bool MQ>
struct Shape {
  static constexpr int CH = CH_;                  // ring columns of a block
  static constexpr int NQ = MQ ? 4 : 1;           // query sets of a block, at most
  static constexpr int ROWS = 16 * NQ;            // score rows of a block, at most
  static constexpr int NB = MQ ? 2 : 1;           // n8 tiles of a slot's query rows
  static constexpr int NT = CH / TILE;            // skip tiles of a block
  static constexpr int MT = CH / 16;              // key m-tiles of a block
  static constexpr int KS = MT < WARPS ? WARPS / MT : 1;   // warps per key m-tile
  static constexpr int MTW = KS == 1 ? MT / WARPS : 1;     // key m-tiles of a warp
  static constexpr int SCS = CH + 4;              // score row stride (floats): P rows 16 B apart in banks
  static_assert(CH <= THREADS, "one column per thread for the bias pass");
  static_assert(KS == 1 ? MT % WARPS == 0 : KS == 2 && MT * KS == WARPS,
                "whole m-tiles per warp, or two warps per m-tile");
};

struct Args {
  const bf16* q;               // (B, G, R, dh), R = nq * Hg, rows (query, head)
  const void* zk;              // ring (B, S, G, rk) or pool (n_pages, page_size, G, rk)
  const void* zv;              // likewise, rv; bf16, or int8
  const float* zk_scale;       // int8: (B, S, G), else null
  const float* zv_scale;       // int8: (B, S, G)
  const bf16* r_k;             // (G, rk, s*dh)
  const float* cos;            // (B, S, dh/2)
  const float* sin;            // (B, S, dh/2)
  const float* bias;           // (B, nq, bias_cols)
  const float* k_norm;         // (dh,) or null
  const void* zk_self;         // (B, n_self, G, rk) or null
  const void* zv_self;         // (B, n_self, G, rv)
  const float* zk_self_scale;  // int8: (B, n_self, G)
  const float* zv_self_scale;  // int8: (B, n_self, G)
  const float* cos_self;       // (B, n_self, dh/2)
  const float* sin_self;       // (B, n_self, dh/2)
  const int* ptab;             // K4: (B, S / page_size), else null
  float* part_acc;             // (B, G, n_chunks, R, rv)
  float* part_m;               // (B, G, n_chunks, R)
  float* part_l;               // (B, G, n_chunks, R)
  bf16* out;                   // (B, G, R, rv)
  int B, S, G, Hg, rk, rv, s, nq, n_self, bias_cols, n_chunks, page_size, n_pages;
  float scale, eps;
  int qg;                      // query sets of a block
  int sps;                     // head slots of a block, a divisor of s
  int nsb;                     // head-slot blocks: s / sps (grid z covers nq and s)
  int hb;                      // query rows of a query set in a block: sps * qpk
  int rc;                      // rank rows of R_k per pipeline stage
  float* m_out;                // (B, G, R) merged softmax max, or null
  float* l_out;                // (B, G, R) merged softmax sum, or null
};

// r_k is padded to a multiple of 16 (zero latents, zero R_k rows) for the
// k16 products; r_v needs only whole n8 tiles.
__host__ __device__ constexpr int rk_pad(int rk) { return (rk + 15) & ~15; }
__host__ __device__ constexpr int z_stride(int rk, int rv) {
  return (rk_pad(rk) > rv ? rk_pad(rk) : rv) + 8;
}

template <int DH, int CH, bool QUANT, bool MQ>
__host__ __device__ constexpr size_t smem_bytes(int rk, int rv, int rc) {
  using L = Shape<CH, MQ>;
  return size_t(CH) * z_stride(rk, rv) * 2               // zk, then zv, rows (bf16)
         + 2 * size_t(rc) * (DH + 8) * 2                 // R_k ring
         + size_t(L::ROWS) * L::SCS * 4                  // scores, then P hi and lo (bf16) in place
         + size_t(L::ROWS) * (DH + 8) * 2                // q rows
         + DH * 4 + L::NQ * CH * 4 + CH * 4              // 1 + k_norm, bias, latent rows
         + (QUANT ? 2 * CH * 4 : 0) + 16                 // key and value scales, tile flags
         + (L::KS == 2 ? 2 * CH * 4 : 0);                // k-norm partial sums of the two warps
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

// The two int8 values in bits 0-15 of w as a packed bf16 pair (exact).
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  return tc::pack_bf16(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                       static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)));
}

template <int DH, int CH, bool PAGED, bool QUANT, bool MQ>
__global__ void __launch_bounds__(THREADS, 1)
latent_decode_tc(Args a) {
  using L = Shape<CH, MQ>;
  constexpr int NT = L::NT, ROWS = L::ROWS, SCS = L::SCS, MTW = L::MTW,
                NB = L::NB, MR = ROWS / 16, KS = L::KS;
  constexpr int HALF = DH / 2;
  constexpr int RS = DH + 8;   // R_k / q row stride (bf16)
  constexpr int NN = DH / 8;   // key n-tiles of an m-tile
  constexpr int NW = NN / KS;  // key n-tiles of a warp's m-tile
  constexpr int QW = NW / 2;   // of them in each half of dh
  static_assert(DH % 16 == 0 && NW % 2 == 0 && (KS == 1 || DH % 64 == 0),
                "whole k16 steps of dh; two warps per m-tile split each half of dh evenly");

  const int chunk = blockIdx.y, g = blockIdx.x % a.G, b = blockIdx.x / a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  // KS = 2 (64-column chunks): warps w and w + 4 share m-tile w, warp w + 4
  // * hf taking quarter hf of each half of dh, so that columns d and d +
  // dh/2 stay in one warp.  n-tile jl of a warp is key n-tile jmap(jl).
  const int hf = KS == 1 ? 0 : warp / L::MT;
  const int mw = KS == 1 ? warp : warp % L::MT;   // the warp's first m-tile
  auto jmap = [&](int jl) { return (jl / QW) * (NN / 2) + hf * QW + jl % QW; };
  const int S = a.S, G = a.G, Hg = a.Hg, rk = a.rk, rv = a.rv, s = a.s;
  const int zq = MQ ? blockIdx.z / a.nsb : 0;         // grid z: (query block, slot block)
  const int j0 = MQ ? zq * a.qg : 0;                  // the block's first query set
  const int nq = MQ ? min(a.qg, a.nq - j0) : 1;       // and its query sets
  const int qpk = Hg / s;
  const int sb = blockIdx.z - zq * a.nsb;             // slot block: head slots sb * sps..
  const int Hb = a.hb;                                // heads of a query set in the block
  const int R = nq * Hb;                              // score rows of the block
  const int RT = a.nq * Hg;                           // rows of the call
  const int row0 = j0 * Hg + sb * Hb;                 // the call's row of block row 0
  // block row h = (query j, head i of the block) -> call row - row0 (h
  // itself when the block holds every head slot)
  auto grow = [&](int h) { return MQ && Hb != Hg ? (h / Hb) * Hg + h % Hb : h; };
  const int S_ext = S + a.n_self;
  const int t0 = chunk * CH;
  const int ZS = z_stride(rk, rv);
  // the 256-column plan always stages 128 rows and r_v <= 256: both known
  // at compile time there keep K1 / K4 <128> within 255 registers
  const int rc = CH == 256 ? 128 : a.rc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* z_s = reinterpret_cast<bf16*>(smem_raw);             // CH x ZS
  bf16* r_s = z_s + CH * ZS;                                  // 2 x rc x RS
  float* sc_s = reinterpret_cast<float*>(r_s + 2 * rc * RS);  // ROWS x SCS
  bf16* q_s = reinterpret_cast<bf16*>(sc_s + ROWS * SCS);     // ROWS x RS
  float* kn_s = reinterpret_cast<float*>(q_s + ROWS * RS);    // DH
  float* bias_s = kn_s + DH;                                  // NQ x CH
  int* row_s = reinterpret_cast<int*>(bias_s + L::NQ * CH);   // CH
  float* ksc_s = reinterpret_cast<float*>(row_s + CH);        // CH key scales (int8)
  float* vsc_s = ksc_s + (QUANT ? CH : 0);                    // CH value scales (int8)
  int* live_s = reinterpret_cast<int*>(vsc_s + (QUANT ? CH : 0));  // NT (16 B)
  float* red_s = reinterpret_cast<float*>(live_s + 4);       // KS = 2: 2 x CH

  // -- bias first: which tiles of the chunk are live, and their latent rows
  if (tid < NT) live_s[tid] = 0;
  __syncthreads();
  if (tid < CH) {
    const int t = t0 + tid;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < L::NQ; ++j) {
      float bv = NEG_INF;
      if (j < nq) {
        if (t < S || (t < S_ext && a.bias_cols > S))
          bv = a.bias[(size_t(b) * a.nq + j0 + j) * a.bias_cols + t];
        else if (t < S_ext)
          bv = 0.f;   // K1 / K3 / K4's self column
      }
      bias_s[j * CH + tid] = bv;
      seen |= bv > NEG_INF * 0.5f;
    }
    int row = -1;   // -1: zero-filled; -2: a self column
    if (seen) {
      if (t >= S) {
        row = -2;
      } else if (PAGED) {
        const int n_sp = S / a.page_size;
        const int page = a.ptab[b * n_sp + t / a.page_size];
        if (page >= 0 && page < a.n_pages) row = page * a.page_size + t % a.page_size;
      } else {
        row = b * S + t;
      }
    }
    if constexpr (QUANT) {
      float ks = 0.f, vs = 0.f;
      if (row >= 0) {
        ks = a.zk_scale[size_t(row) * G + g];
        vs = a.zv_scale[size_t(row) * G + g];
      } else if (row == -2) {
        const size_t e = (size_t(b) * a.n_self + (t - S)) * G + g;
        ks = a.zk_self_scale[e];
        vs = a.zv_self_scale[e];
      }
      ksc_s[tid] = ks;
      vsc_s[tid] = vs;
    }
    row_s[tid] = row;
    if (seen) live_s[tid / TILE] = 1;
  }
  __syncthreads();
  // partial-state row of block row 0 (+ grow(h) for block row h)
  const size_t base = ((size_t(b) * G + g) * a.n_chunks + chunk) * RT + row0;
  bool chunk_live = false;
#pragma unroll
  for (int i = 0; i < NT; ++i) chunk_live |= live_s[i] != 0;
  if (!chunk_live) {
    if (tid < R) {
      a.part_m[base + grow(tid)] = NEG_INF;
      a.part_l[base + grow(tid)] = 0.f;
    }
    return;
  }

  // -- loads: q rows, latent rows of live tiles, the first R_k stages ------
  for (int e = tid; e < ROWS * (DH / 8); e += THREADS) {
    const int r = e / (DH / 8), c = e - r * (DH / 8);
    const bool ok = r < R;
    tc::cp_async16(q_s + r * RS + c * 8,
                   a.q + ((size_t(b) * G + g) * RT + row0 + grow(ok ? r : 0)) * DH + c * 8, ok);
  }
  const bool has_norm = a.k_norm != nullptr;
  if (tid < DH) kn_s[tid] = has_norm ? 1.f + a.k_norm[tid] : 1.f;
  // bf16 latents: 16-byte cp.async, zero-filled where masked and in the
  // padding columns [r, rp)
  auto load_bf16 = [&](const void* ring, const void* self, int r, int rp) {
    const bf16* pool = static_cast<const bf16*>(ring);
    const bf16* selfp = static_cast<const bf16*>(self);
    const int nc = rp / 8, nr = r / 8;
    for (int e = tid; e < CH * nc; e += THREADS) {
      const int i = e / nc, c = e - i * nc;
      if (!live_s[i / TILE]) continue;
      const int row = row_s[i];
      const bool ok = row != -1 && c < nr;
      const bf16* src =
          !ok         ? pool
          : row >= 0  ? pool + (size_t(row) * G + g) * r + c * 8
                      : selfp + ((size_t(b) * a.n_self + (t0 + i - S)) * G + g) * r + c * 8;
      tc::cp_async16(z_s + i * ZS + c * 8, src, ok);
    }
  };
  // int8 latents: 8 values through registers, stored as bf16 (exact).
  // cp.async cannot convert, so the loads are plain: each thread issues U
  // = 8 of them before it stores any (U * THREADS * 8 = 16 KB in flight
  // per block).  A load-then-store loop took K3 0.21-0.30 ms at
  // chip_smoke.py's shape on an H100, U = 8 0.19 ms; U = 16 was no faster
  // for K3 and ~13% slower for K6.
  auto load_i8 = [&](const void* ring, const void* self, int r, int rp) {
    constexpr int U = 8;
    const int8_t* pool = static_cast<const int8_t*>(ring);
    const int8_t* selfp = static_cast<const int8_t*>(self);
    const int nc = rp / 8, nr = r / 8, n = CH * nc;
    for (int e0 = tid; e0 < n; e0 += U * THREADS) {
      uint2 raw[U];
      int dst[U];   // the bf16 row chunk in z_s, or -1 (past the end, a dead tile)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS, i = e / nc, c = e - i * nc;
        raw[u] = make_uint2(0u, 0u);
        dst[u] = -1;
        if (e < n && live_s[i / TILE]) {
          dst[u] = i * ZS + c * 8;
          const int row = row_s[i];
          if (c < nr && row >= 0)
            raw[u] = __ldg(reinterpret_cast<const uint2*>(pool + (size_t(row) * G + g) * r +
                                                          c * 8));
          else if (c < nr && row == -2)
            raw[u] = __ldg(reinterpret_cast<const uint2*>(
                selfp + ((size_t(b) * a.n_self + (t0 + i - S)) * G + g) * r + c * 8));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (dst[u] >= 0)
          *reinterpret_cast<uint4*>(z_s + dst[u]) =
              make_uint4(i8x2_bf16(raw[u].x), i8x2_bf16(raw[u].x >> 16), i8x2_bf16(raw[u].y),
                         i8x2_bf16(raw[u].y >> 16));
    }
  };
  const int rkp = rk_pad(rk);
  if constexpr (!QUANT) load_bf16(a.zk, a.zk_self, rk, rkp);
  tc::cp_async_commit();

  const int nkc = (rk + rc - 1) / rc;   // R_k stages per head slot
  const int n_st = a.sps * nkc;         // the block's slots only
  const bf16* rkg = a.r_k + size_t(g) * rk * s * DH + sb * a.sps * DH;
  auto load_r = [&](int st) {   // rows past r_k (to the next 16) zero-filled
    const int i = st / nkc, r0 = (st % nkc) * rc, rn = min(rc, rk - r0);
    bf16* dst = r_s + (st & 1) * rc * RS;
    for (int e = tid; e < rk_pad(rn) * (DH / 8); e += THREADS) {
      const int rr = e / (DH / 8), c = e - rr * (DH / 8);
      const bool ok = rr < rn;
      tc::cp_async16(dst + rr * RS + c * 8,
                     rkg + (ok ? size_t(r0 + rr) * s * DH + i * DH + c * 8 : 0), ok);
    }
  };
  load_r(0);
  tc::cp_async_commit();
  if (n_st > 1) load_r(1);
  tc::cp_async_commit();
  if constexpr (QUANT) load_i8(a.zk, a.zk_self, rk, rkp);   // while the R_k stages fly

  // -- key rebuild, key scale, k-norm, RoPE and scores, one head slot at a time
  bool live[MTW];
  bool warp_live = false;
#pragma unroll
  for (int u = 0; u < MTW; ++u) {
    live[u] = live_s[(mw + WARPS * u) * 16 / TILE] != 0;
    warp_live |= live[u];
  }
  float acc[MTW][NW][4];
#pragma unroll
  for (int u = 0; u < MTW; ++u)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][j][c] = 0.f;
  const int nqk = nq * qpk;   // query rows that read one head slot

  for (int st = 0; st < n_st; ++st) {
    tc::cp_async_wait<1>();
    __syncthreads();
    const int slot = st / nkc, kc = st % nkc;   // slot of the block
    const int r0 = kc * rc, rn = min(rc, rk - r0);
    const bf16* rs = r_s + (st & 1) * rc * RS;
    if (warp_live) {
      const bf16* za = z_s + (mw * 16 + (lane & 15)) * ZS + r0 + (lane >> 4) * 8;
      for (int ks = 0; ks < rk_pad(rn) / 16; ++ks) {
        uint32_t fa[MTW][4];
#pragma unroll
        for (int u = 0; u < MTW; ++u)
          if (live[u]) tc::ldsm_x4(fa[u], za + u * WARPS * 16 * ZS + ks * 16);
        const bf16* rrow = rs + (ks * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NW / 2; ++np) {
          uint32_t rb[4];
          tc::ldsm_x4_t(rb, rrow + jmap(2 * np) * 8);
#pragma unroll
          for (int u = 0; u < MTW; ++u) {
            if (live[u]) {
              tc::mma16816(acc[u][2 * np], fa[u], rb[0], rb[1]);
              tc::mma16816(acc[u][2 * np + 1], fa[u], rb[2], rb[3]);
            }
          }
        }
      }
    }
    if (kc == nkc - 1) {
      // B fragments of Q^T for this slot: column n = nb * 8 + g4 = j * qpk
      // + i of n8 tile nb is block row (j, slot * qpk + i); columns past
      // nq * qpk read any row and are dropped
      int qrow[NB];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = nb * 8 + g4;
        const int j = MQ ? n / qpk : 0;
        qrow[nb] = n < nqk ? j * Hb + slot * qpk + (n - j * qpk) : min(slot * qpk + n, ROWS - 1);
      }
#pragma unroll
      for (int u = 0; u < MTW; ++u) {
        if (!live[u]) continue;   // KS = 2: one tile, live in every warp
        float(&k)[NW][4] = acc[u];
        const int mt = mw + WARPS * u;
        if constexpr (QUANT) {
          const float s0 = ksc_s[mt * 16 + g4], s1 = ksc_s[mt * 16 + g4 + 8];
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            k[j][0] *= s0;
            k[j][1] *= s0;
            k[j][2] *= s1;
            k[j][3] *= s1;
          }
        }
        if (has_norm) {
          float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            ss0 += k[j][0] * k[j][0] + k[j][1] * k[j][1];
            ss1 += k[j][2] * k[j][2] + k[j][3] * k[j][3];
          }
          ss0 = tc::quad_sum(ss0);
          ss1 = tc::quad_sum(ss1);
          if constexpr (KS == 2) {   // the two warps' halves of each row's sum
            if (t4 == 0) {
              red_s[hf * CH + mt * 16 + g4] = ss0;
              red_s[hf * CH + mt * 16 + g4 + 8] = ss1;
            }
            __syncthreads();
            ss0 = red_s[mt * 16 + g4] + red_s[CH + mt * 16 + g4];
            ss1 = red_s[mt * 16 + g4 + 8] + red_s[CH + mt * 16 + g4 + 8];
          }
          const float i0 = rsqrtf(ss0 / DH + a.eps);
          const float i1 = rsqrtf(ss1 / DH + a.eps);
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            const float w0 = kn_s[jmap(j) * 8 + 2 * t4], w1 = kn_s[jmap(j) * 8 + 2 * t4 + 1];
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
          for (int j = 0; j < QW; ++j) {
            float2 c = make_float2(1.f, 1.f), sn = make_float2(0.f, 0.f);
            if (cp != nullptr) {
              c = *reinterpret_cast<const float2*>(cp + jmap(j) * 8 + 2 * t4);
              sn = *reinterpret_cast<const float2*>(sp + jmap(j) * 8 + 2 * t4);
            }
            const float x1a = k[j][2 * hr], x2a = k[j + QW][2 * hr];
            const float x1b = k[j][2 * hr + 1], x2b = k[j + QW][2 * hr + 1];
            k[j][2 * hr] = x1a * c.x - x2a * sn.x;
            k[j + QW][2 * hr] = x2a * c.x + x1a * sn.x;
            k[j][2 * hr + 1] = x1b * c.y - x2b * sn.y;
            k[j + QW][2 * hr + 1] = x2b * c.y + x1b * sn.y;
          }
        }
        // scores^T (16 columns x 8 or 16 query rows) = (K_hi + K_lo) @ Q^T
        // over the warp's columns of dh
        float sacc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NW / 2; ++kk) {
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
            tc::split_bf16(k[2 * kk + (f >> 1)][2 * (f & 1)], k[2 * kk + (f >> 1)][2 * (f & 1) + 1],
                           fh[f], fl[f]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const bf16* qr = q_s + qrow[nb] * RS + 2 * t4 + jmap(2 * kk) * 8;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qr);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qr + 8);
            tc::mma16816(sacc[nb], fh, b0, b1);
            tc::mma16816(sacc[nb], fl, b0, b1);
          }
        }
        // KS = 2: warp hf = 1 leaves its partial scores in place, and warp
        // hf = 0 adds its own to them
        if constexpr (KS == 2) {
          if (hf == 1) {
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = nb * 8 + 2 * t4 + (e & 1);
                const int col = mt * 16 + g4 + 8 * (e >> 1);
                if (n < nqk) {
                  const int j = MQ ? n / qpk : 0;
                  sc_s[(j * Hb + slot * qpk + (n - j * qpk)) * SCS + col] = sacc[nb][e];
                }
              }
          }
          __syncthreads();
        }
        if (hf == 0) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = nb * 8 + 2 * t4 + (e & 1);
              const int col = mt * 16 + g4 + 8 * (e >> 1);
              if (n < nqk) {
                const int j = MQ ? n / qpk : 0;
                float* dst = sc_s + (j * Hb + slot * qpk + (n - j * qpk)) * SCS + col;
                const float x = KS == 2 ? sacc[nb][e] + *dst : sacc[nb][e];
                *dst = x * a.scale + bias_s[j * CH + col];
              }
            }
        }
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) k[j][c] = 0.f;
      }
    }
    __syncthreads();   // every warp is done with this R_k stage
    if (st + 2 < n_st) load_r(st + 2);
    tc::cp_async_commit();
  }

  // -- zv rows into the keys' space (bf16: while the softmax runs) ---------
  if constexpr (QUANT) load_i8(a.zv, a.zv_self, rv, rv);
  else load_bf16(a.zv, a.zv_self, rv, rv);
  tc::cp_async_commit();
#pragma unroll
  for (int u = 0; u < ROWS / WARPS; ++u) {
    const int h = warp + WARPS * u;
    float x[CH / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < CH / 32; ++k) {
      const int col = lane + 32 * k;
      x[k] = (h < R && live_s[col / TILE]) ? sc_s[h * SCS + col] : NEG_INF;
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
      const float pv = QUANT ? p * vsc_s[lane + 32 * k] : p;   // value scale folded in
      const bf16 hi = __float2bfloat16(pv);
      prow[lane + 32 * k] = hi;
      prow[CH + lane + 32 * k] = __float2bfloat16(pv - __bfloat162float(hi));
      lsum += p;
    }
    lsum = warp_sum(lsum);
    if (lane == 0 && h < R) {
      a.part_m[base + grow(h)] = alive ? mx : NEG_INF;
      a.part_l[base + grow(h)] = lsum;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // -- acc (R x rv) = P @ zv, in passes of 32 value n-tiles: warp w takes
  // n-tiles w, w+8, w+16, w+24 of each pass
  const int nv = rv / 8;
  const bf16* p_s = reinterpret_cast<const bf16*>(sc_s);
  constexpr int PS = SCS * 2;   // P row stride in bf16 elements
  for (int v0 = 0; v0 < (CH == 256 ? 1 : nv); v0 += 4 * WARPS) {
    float o[MR][4][4];
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mi][u][c] = 0.f;
    for (int kt = 0; kt < NT; ++kt) {
      if (!live_s[kt]) continue;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        const int k0 = kt * TILE + kk * 16;
        uint32_t ph[MR][4], pl[MR][4];
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          const bf16* prow = p_s + (mi * 16 + (lane & 15)) * PS + k0 + (lane >> 4) * 8;
          tc::ldsm_x4(ph[mi], prow);
          tc::ldsm_x4(pl[mi], prow + CH);
        }
        const bf16* vrow = z_s + (k0 + (lane & 15)) * ZS;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = v0 + warp + WARPS * u;
          if (n < nv) {
            uint32_t b0, b1;
            tc::ldsm_x2_t(b0, b1, vrow + n * 8);
#pragma unroll
            for (int mi = 0; mi < MR; ++mi) {
              tc::mma16816(o[mi][u], ph[mi], b0, b1);
              tc::mma16816(o[mi][u], pl[mi], b0, b1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = v0 + warp + WARPS * u;
        if (n >= nv) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int h = mi * 16 + g4 + 8 * hr;
          if (h < R)
            *reinterpret_cast<float2*>(a.part_acc + (base + grow(h)) * rv + n * 8 +
                                       2 * t4) =
                make_float2(o[mi][u][2 * hr], o[mi][u][2 * hr + 1]);
        }
      }
  }
}

// Log-sum-exp merge of the chunk partials: out = sum_k acc_k e^{m_k - M} /
// max(sum_k l_k e^{m_k - M}, 1e-30) over the chunks that saw a column (a
// chunk with m_k = NEG_INF wrote no acc).  A row no chunk saw finishes as
// exact 0.  With m_out / l_out each row's merged (M, Lsum) is written too:
// o = acc / Lsum at running max M, the state a cross-device merge of
// partial softmaxes needs (NEG_INF and 0 for a row no chunk saw).
// Grid (ceil(R * rv / THREADS), G, B).
__global__ void __launch_bounds__(THREADS)
latent_decode_tc_merge(Args a) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = a.nq * a.Hg, rv = a.rv, n = a.n_chunks;
  const size_t base = (size_t(b) * a.G + g) * n;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= R * rv) return;
  const int h = e / rv;
  float M = NEG_INF;
  for (int k = 0; k < n; ++k) M = fmaxf(M, a.part_m[(base + k) * R + h]);
  float Lsum = 0.f, O = 0.f;
  for (int k = 0; k < n; ++k) {
    const float mk = a.part_m[(base + k) * R + h];
    if (mk <= NEG_INF * 0.5f) continue;
    const float w = __expf(mk - M);
    Lsum += a.part_l[(base + k) * R + h] * w;
    O += a.part_acc[(base + k) * R * rv + e] * w;
  }
  a.out[((size_t(b) * a.G + g) * R) * rv + e] = __float2bfloat16(O / fmaxf(Lsum, 1e-30f));
  if (a.m_out != nullptr && e % rv == 0) {
    a.m_out[(size_t(b) * a.G + g) * R + h] = M;
    a.l_out[(size_t(b) * a.G + g) * R + h] = Lsum;
  }
}

// A body's block plan: the widest chunk (CH), then the deepest R_k stage
// (rc rank rows), whose block fits in shared memory; ch = 0 if none does.
// K1 / K3 / K4 take (256, 128) up to r = 256 (the kernel relies on r_v <=
// 256 there), K5 / K6 / K7 (128, 128); larger ranks narrow the chunk, then
// the stage, down to 64 columns (at dh = 128 the one-query bodies fit r up
// to ~1,450, the multi-query ones ~1,250).
struct Plan {
  int ch, rc;
};
template <int DH, bool QUANT, bool MQ>
Plan plan_dh(int rk, int rv) {
  if constexpr (DH < 256) {   // dh 256: 64-column chunks only (see the header)
    if constexpr (!MQ) {
      if (rv <= 256 && smem_bytes<DH, 256, QUANT, MQ>(rk, rv, 128) <= SMEM_LIMIT)
        return {256, 128};
    }
    // dh 80 has no 64-column plan (its 10 n8 tiles do not split into two
    // warps' quarters), so its 128-column chunk also takes 32-row stages
    for (int rc = 128; rc >= (DH % 64 ? 32 : 64); rc /= 2)
      if (smem_bytes<DH, 128, QUANT, MQ>(rk, rv, rc) <= SMEM_LIMIT) return {128, rc};
  }
  if constexpr (DH % 64 == 0) {
    for (int rc = 128; rc >= 64; rc /= 2)
      if (smem_bytes<DH, 64, QUANT, MQ>(rk, rv, rc) <= SMEM_LIMIT) return {64, rc};
  }
  return {0, 0};
}
template <bool QUANT, bool MQ>
Plan plan(int dh, int rk, int rv) {
  return dh == 64    ? plan_dh<64, QUANT, MQ>(rk, rv)
         : dh == 80  ? plan_dh<80, QUANT, MQ>(rk, rv)
         : dh == 128 ? plan_dh<128, QUANT, MQ>(rk, rv)
         : dh == 256 ? plan_dh<256, QUANT, MQ>(rk, rv)
                     : Plan{0, 0};
}

// Query sets and head slots per block: all of a slot's query rows (qg *
// qpk) must fit the NB n8 tiles of the scoring product, and the block's
// rows (qg * sps * qpk) its ROWS (16, or 64 for the multi-query body).
// sps is the largest divisor of s that fits, so every block has as many
// rows.  Grid z covers the nq query sets in blocks of qg times the s head
// slots in blocks of sps; at Hg <= 16 a block takes every slot (nsb = 1).
template <bool MQ>
void split_rows(Args& a) {
  const int qpk = a.Hg / a.s;
  a.qg = MQ ? (16 / qpk < 4 ? 16 / qpk : 4) : 1;
  const int fit = Shape<128, MQ>::ROWS / (a.qg * qpk);
  a.sps = a.s;
  while (a.sps > fit || a.s % a.sps != 0) --a.sps;
  a.nsb = a.s / a.sps;
  a.hb = a.sps * qpk;
}

template <int DH, int CH, bool PAGED, bool QUANT, bool MQ>
cudaError_t launch_ch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH, CH, QUANT, MQ>(a.rk, a.rv, a.rc);
  cudaError_t err = cudaFuncSetAttribute(latent_decode_tc<DH, CH, PAGED, QUANT, MQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qg = (a.nq + a.qg - 1) / a.qg;
  latent_decode_tc<DH, CH, PAGED, QUANT, MQ>
      <<<dim3(a.G * a.B, a.n_chunks, n_qg * a.nsb), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (a.nq * a.Hg * a.rv + THREADS - 1) / THREADS;
  latent_decode_tc_merge<<<dim3(merge_blocks, a.G, a.B), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, bool PAGED, bool QUANT, bool MQ>
cudaError_t launch(Args a, cudaStream_t stream) {
  const Plan p = plan<QUANT, MQ>(DH, a.rk, a.rv);
  a.rc = p.rc;
  split_rows<MQ>(a);
  if constexpr (DH == 256) {
    return launch_ch<DH, 64, PAGED, QUANT, MQ>(a, stream);
  } else {
    if constexpr (!MQ) {
      if (p.ch == 256) return launch_ch<DH, 256, PAGED, QUANT, MQ>(a, stream);
    }
    if constexpr (DH % 64 == 0) {
      if (p.ch == 64) return launch_ch<DH, 64, PAGED, QUANT, MQ>(a, stream);
    }
    return launch_ch<DH, 128, PAGED, QUANT, MQ>(a, stream);
  }
}

// The shape limits of a body (the wrapper raises on the same ones first).
template <bool QUANT, bool MQ>
bool shapes_ok(Args a, int dh) {
  if (a.Hg < 1 || a.s < 1 || a.Hg % a.s != 0 || a.nq < 1) return false;
  const int qpk = a.Hg / a.s;
  if (MQ ? qpk > 16 : (a.nq != 1 || qpk > 8)) return false;
  split_rows<MQ>(a);
  const int ch = plan<QUANT, MQ>(dh, a.rk, a.rv).ch;
  return ch > 0 && (a.nq + a.qg - 1) / a.qg * a.nsb <= 65535 &&
         a.rk % 8 == 0 && a.rk >= 8 && a.rv % 8 == 0 && a.rv >= 8 && a.B >= 1 &&
         a.G >= 1 && a.S >= 0 && a.n_self >= 0 &&
         (a.bias_cols == a.S + a.n_self || (a.nq == 1 && a.bias_cols == a.S)) &&
         a.n_chunks == (a.S + a.n_self + ch - 1) / ch && a.n_chunks >= 1;
}

// One entry point's checks and launch.  A one-query call with more than 8
// query rows per head slot (q_per_kv 16: qwen3-moe-235b-a22b's 64 q heads
// over 4 kv heads) runs the multi-query instantiation of its row map and
// latent type at nq = 1: its scoring product takes a slot's 16 rows as two
// n8 tiles and its block up to 64 score rows, so all four head slots of a
// group share one block and one read of the chunk's latents.
template <bool PAGED, bool QUANT, bool MQ>
int entry(Args a, int dh, int chunk_len, cudaStream_t st) {
  if constexpr (!MQ) {
    if (a.s >= 1 && a.Hg % a.s == 0 && a.Hg / a.s > 8)
      return a.nq == 1 ? entry<PAGED, QUANT, true>(a, dh, chunk_len, st)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_len != plan<QUANT, MQ>(dh, a.rk, a.rv).ch || !shapes_ok<QUANT, MQ>(a, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return static_cast<int>(launch<64, PAGED, QUANT, MQ>(a, st));
  if (dh == 80) return static_cast<int>(launch<80, PAGED, QUANT, MQ>(a, st));
  if (dh == 128) return static_cast<int>(launch<128, PAGED, QUANT, MQ>(a, st));
  if (dh == 256) return static_cast<int>(launch<256, PAGED, QUANT, MQ>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Ring columns per block of the one-query (mq = 0) or the multi-query
// body at these widths, from the block plan; 0 if no block fits.  A
// one-query call past q_per_kv 8 runs the multi-query body (see entry):
// ask with mq = 1 for it.
int recalkv_tc_chunk(int mq, int quant, int dh, int rk, int rv) {
  if (mq) return quant ? plan<true, true>(dh, rk, rv).ch : plan<false, true>(dh, rk, rv).ch;
  return quant ? plan<true, false>(dh, rk, rv).ch : plan<false, false>(dh, rk, rv).ch;
}

// The six entry points take the argument list of latent_decode.cu's six
// and return a cudaError_t (0 = success).  All tensors contiguous, on the
// device of ``stream``; q, r_k and out bf16 (is_bf16 = 1); latents bf16
// (K1, K4, K5, K7) or int8 (K3, K6).  Null self latents mean no self
// column, null k_norm no key norm.  Each checks that the operands match
// its body: a page table (with page_size dividing S and a pool of n_pages
// pages) only for K4 / K7, scales only for K3 / K6, one query for K1 / K3
// / K4; and the shape limits of shapes_ok (dh 64, 80, 128 or 256; any Hg,
// q_per_kv <= 16, K1 / K3 / K4 past 8 on the multi-query body, K5 / K6 /
// K7 with any nq; r_k and r_v multiples of 8 whose block fits, every rank
// up to s * dh at group_size <= 8;
// chunk_len = recalkv_tc_chunk and n_chunks = ceil((S + n_self) /
// chunk_len)).  m_out / l_out (B, G, nq * Hg) f32, both or neither, take
// the rows' merged softmax state; null leaves the launch as it was.
#define RECALKV_TC_ENTRY(NAME, PAGED, QUANT, MQ)                                         \
  int NAME(int is_bf16, int dh, const void* q, const void* zk, const void* zv,           \
           const float* zk_scale, const float* zv_scale, const void* r_k,                \
           const float* cos, const float* sin, const float* bias, const float* k_norm,   \
           const void* zk_self, const void* zv_self, const float* zk_self_scale,         \
           const float* zv_self_scale, const float* cos_self, const float* sin_self,     \
           float* part_acc, float* part_m, float* part_l, void* out, float* m_out,       \
           float* l_out, int B, int S, int G, int Hg, int rk, int rv, int s, int nq,     \
           int n_self, int bias_cols, int n_chunks, int chunk_len, const int* ptab,      \
           int page_size, int n_pages, float scale, float eps, void* stream) {           \
    Args a{static_cast<const bf16*>(q), zk, zv, zk_scale, zv_scale,                       \
           static_cast<const bf16*>(r_k), cos, sin, bias, k_norm, zk_self, zv_self,       \
           zk_self_scale, zv_self_scale, cos_self, sin_self, ptab, part_acc, part_m,      \
           part_l, static_cast<bf16*>(out), B, S, G, Hg, rk, rv, s, nq, n_self,           \
           bias_cols, n_chunks, page_size, n_pages, scale, eps, 1, 1, 1, 1, 0, m_out, l_out}; \
    if (is_bf16 != 1 || (ptab != nullptr) != (PAGED) || (zk_scale != nullptr) != (QUANT) || \
        (m_out == nullptr) != (l_out == nullptr) ||                                       \
        ((QUANT) && zk_self != nullptr && zk_self_scale == nullptr) ||                    \
        ((PAGED) && (page_size < 1 || S % page_size != 0 || n_pages < 1)))                \
      return static_cast<int>(cudaErrorInvalidValue);                                     \
    return entry<PAGED, QUANT, MQ>(a, dh, chunk_len, static_cast<cudaStream_t>(stream));  \
  }

RECALKV_TC_ENTRY(recalkv_latent_decode_tc, false, false, false)            // K1
RECALKV_TC_ENTRY(recalkv_latent_decode_quant_tc, false, true, false)       // K3
RECALKV_TC_ENTRY(recalkv_latent_decode_paged_tc, true, false, false)       // K4
RECALKV_TC_ENTRY(recalkv_latent_decode_mq_tc, false, false, true)          // K5
RECALKV_TC_ENTRY(recalkv_latent_decode_mq_quant_tc, false, true, true)     // K6
RECALKV_TC_ENTRY(recalkv_latent_decode_mq_paged_tc, true, false, true)     // K7

#undef RECALKV_TC_ENTRY

}  // extern "C"
