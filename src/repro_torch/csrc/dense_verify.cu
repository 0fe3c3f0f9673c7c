// The dense cores of K5 and K7 in bf16 and f32: multi-query (speculative
// verify) flash attention over the dense KV cache (keys stored after RoPE),
// for Hopper (sm_90a), CUDA C++.  One templated body, two entry points:
//
//   recalkv_dense_decode_mq        the ring: replaces the Pallas K5
//                                  (src/repro/kernels/latent_decode.py::
//                                  latent_decode_attention_mq) as the JAX
//                                  package's dense ring core (src/repro/
//                                  kernels/ops.py::_dense_ring_core_mq)
//                                  calls it, at an identity R_k
//   recalkv_dense_decode_mq_paged  the pool: replaces the Pallas K7
//                                  (latent_decode.py::
//                                  latent_decode_attention_mq_paged) as
//                                  ops.py::_dense_paged_core_mq calls it
//
// For batch row b, kv head h and its M = nq * qpk query rows r = (j, i),
// ordered (query, head) as ops.group_queries_mq lays them out, over the S
// ring columns and then the nq self columns:
//
//   out[b, h, r] = softmax_t(scale * q[b, h, r] . K[t, h] + bias[b, j, t]) @ V[t, h]
//
// Ring column t of row b is K / V row b * S + t (the ring) or ptab[b, t /
// page_size] * page_size + t % page_size (the pool); self column S + j' is
// k_self / v_self[b, j', h], already rotated.  The bias has a row per query
// (causality over the self columns, the feed mask and the window are in
// it).  No R_k, no rotation tables, no k-norm: the JAX cores pass an
// identity R_k and identity tables to K5 / K7 because their keys are stored
// after RoPE, and this body does not compute what those would add.
//
// What bounds it on an H100: at chip_smoke.py's shape (qwen3-4b's heads: B =
// 8, S = 4,096 + nq = 4 self columns, Hkv = 8, qpk = 4, dh = 128, bf16) a
// call reads 134 MB of K and V (0.040 ms at 3.35 TB/s) and does 2.15 GFLOP
// of scores and P V for 16 query rows a kv head: 4x dense decode's work,
// ~32 us on CUDA cores at their 67 TFLOP/s f32 peak (0.8x the bytes bound)
// and ~3x the bytes bound at qpk 8, nq 8 (64 rows).  So the rows go to the
// tensor cores.  K5 / K7's latent body at the identity R_k rebuilt every
// key (bf16 hi + lo mma.sync), streamed R_k, read ring-sized rotation
// tables that four fills a layer wrote, and ran one 255-register block
// per SM with too few bytes in flight for a streaming shape.
//
// Design:
//  * Split-K over the ring plus the self columns: grid (n_chunks * n_mt,
//    Hkv, B).  A block takes chunk_len columns (a multiple of 32, at most
//    512) of one (b, h) and 16 of its query rows: the rows pad to one m16
//    tile of mma.sync.m16n8k16 (16 rows at the main shape fill it
//    exactly); more rows take n_mt = ceil(rows / 16) blocks on the same
//    columns, adjacent in the grid so the later reads hit L2, so any nq is
//    served (nq 16 at qpk 4: 64 rows, 4 blocks).  A block keeps only the
//    bias rows of its own queries (at most 15 / qpk + 2).  A second
//    kernel (dense_merge.cuh, the decode kernel's) merges the chunk
//    partials by log-sum-exp, launched as a programmatic dependent.
//  * The chunk's bias rows and row map come first, into shared memory.  A
//    32-column tile is skipped before any load when every one of the
//    block's queries has it masked (the ring's empty tail, unmapped slot
//    pages, the null page 0, a window's past, unfed or later candidates);
//    masked columns of a live tile are zero-filled, never loaded, and score
//    exactly NEG_INF for the rows that do not see them.
//  * Four warps, each on its own: warp w takes live tiles w, w + 4, ... and
//    streams their K and V (32 rows x dh, 16-byte cp.async, swizzled so
//    ldmatrix reads are free of bank conflicts) through its own three-
//    stage ring: two tiles (16 KB in bf16 at dh 128) in flight per warp,
//    ~128 KB per SM at two blocks per SM (~106 KB of shared memory each at
//    nq 4), and no block barrier between the prologue and the epilogue.
//    Each warp keeps an online softmax over its tiles: q's A fragments (32
//    registers at dh 128) and its 16 x dh f32 accumulator (64) stay in
//    registers; S = q K^T is 32 mma.sync a tile, P V 64 (P as a bf16 hi +
//    lo pair: one bf16 rounding of P fails chip_smoke's limit, and hi + lo
//    carries P to ~2^-17).  The four warps' (m, l, acc) merge in a fixed
//    order through shared memory at the end.
//  * dh 256 (gemma3-12b): a warp's accumulator is 16 x 256 f32, 128
//    registers, so bf16 q leaves the registers for shared memory (8 KB,
//    swizzled) and each k-step reads its A fragments by ldmatrix, in the
//    order the register path multiplies them.  The four three-stage bf16
//    rings take 192 KB: one block an SM.  The f32 body's would take 256
//    KB, so two of its warps stream (two stages each) and two idle.
//  * dh 80 (h2o-danube-1.8b) is 5 k-steps of q K^T: pairs by ldmatrix.x4
//    as at the other widths, the fifth by ldmatrix.x2; its rows of 10
//    (bf16) or 20 (f32) pieces swizzle the first 8 pieces as the others do
//    and the rest among themselves (swz).  q_per_kv 16 (qwen3-moe-235b-a22b)
//    makes a block's 16 rows one query's heads; nq 4 is 64 rows, 4 blocks.
//  * bf16 x bf16 products are exact in f32, so q . K has no rounding point
//    beyond its inputs; P's split is the body's only one
//    (tests/test_torch_tc_rounding.py emulates it).  The f32 instantiation
//    is the parity one: the same plan, tiles, fragments and order, with
//    the two products on CUDA cores (each lane computes the accumulator
//    elements its mma fragment would hold; P is gathered from the quad by
//    shuffles), two stages a warp and one block per SM.
//  * The ring and the pool are one instantiation but for the row map, with
//    the same chunks, tiles and order: the pool equals the ring on the
//    table-gathered view bit for bit, in both types.
//
// Measured on an H100 (chip_smoke.py, PERF.md §6): about twice the bytes
// bound at the main shape, under half SDPA's time.  In bring-up variants
// the loads alone streamed near the card's rate; what the design leaves
// exposed is a block's fixed cost (the bias / row-map prologue, the warps'
// merge, the chunk merge) and each warp's serial path from a tile's
// arrival to its next loads, with 8 warps an SM.  Other warp counts,
// stages and chunk sizes, the self tile folded into the last chunk, a
// batched prologue and a merge by the last block of each head were each
// no faster.
//
// Contracts: masked logits are NEG_INF = -1e30; a row whose only live column
// is one self column returns that self value exactly (P = 1 there: hi 1, lo
// 0; exactly 0 elsewhere; every merge weighs it by 1); a row masked
// everywhere returns exact 0; launches go on the caller's stream, allocate
// nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_merge.cuh"
#include "tc_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dense::NEG_INF;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int TC = 32;        // columns of a tile: the skip unit and a warp's step
constexpr int MT = 16;        // query rows of a block: one m16 tile
constexpr int CH_MAX = 512;   // columns of a block, at most
constexpr int NT_MAX = CH_MAX / TC;
constexpr int SELF0 = -2;     // row map: -1 zero fill, SELF0 - j self column j

struct Args {
  const void* q;        // (B, Hkv, M, dh), M = nq * qpk rows ordered (query, head)
  const void* k;        // ring (B, S, Hkv, dh) or pool (n_pages, page_size, Hkv, dh)
  const void* v;        // likewise
  const float* bias;    // (B, nq, S + nq)
  const void* k_self;   // (B, nq, Hkv, dh)
  const void* v_self;   // (B, nq, Hkv, dh)
  const int* ptab;      // the pool: (B, S / page_size), else null
  float* part_acc;      // (B, Hkv, n_chunks, M, dh)
  float* part_m;        // (B, Hkv, n_chunks, M)
  float* part_l;        // (B, Hkv, n_chunks, M)
  int B, S, Hkv, nq, qpk, n_chunks, chunk_len, page_size, n_pages;
  float scale;
};

template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }

// Warps that stream tiles: all four, but two in the f32 body at dh 256,
// whose four two-stage rings of 32 KB tiles would take 256 KB (the other
// two warps idle and join the merge with nothing seen).
template <typename T, int DH>
__host__ __device__ constexpr int streams() { return sizeof(T) == 4 && DH == 256 ? 2 : WARPS; }

// bf16 q in shared memory, read by ldmatrix in each k-step, instead of its
// A fragments in registers: at dh 256 those would be 64 registers beside
// the 128 of the 16 x 256 f32 accumulator.
template <typename T, int DH>
__host__ __device__ constexpr bool q_shared() { return sizeof(T) == 2 && DH == 256; }

template <typename T, int DH>
__host__ __device__ constexpr size_t ring_bytes() {
  return size_t(streams<T, DH>()) * stages<T>() * TC * DH * sizeof(T);
}

// Queries a block's MT rows can touch: rows r0 .. r0 + MT - 1 of (query,
// head) order span at most (MT - 1) / qpk + 2 queries.
__host__ __device__ constexpr int block_queries(int nq, int qpk) {
  return (MT - 1) / qpk + 2 < nq ? (MT - 1) / qpk + 2 : nq;
}

template <typename T, int DH>
size_t smem_bytes(int nq, int qpk, int chunk_len) {
  return ring_bytes<T, DH>()                                 // the warps' cp.async rings, then the merge
         + (q_shared<T, DH>() ? size_t(MT) * DH * sizeof(T) : 0)   // q (bf16, dh 256)
         + size_t(block_queries(nq, qpk)) * chunk_len * 4    // the block's bias rows
         + size_t(chunk_len) * 4                             // row map
         + (2 * NT_MAX + 1) * 4;                             // tile flags, live tiles and their count
}

// Element offset of 16-byte piece ``piece`` of tile row ``r``: the pieces of
// a row are XOR-swizzled by r % 8, so the 8 rows of an ldmatrix matrix (or
// 8 lanes reading one piece of 8 rows) fall in 8 different bank groups.  At
// dh 80 a row has 8 + REM pieces (REM 2 in bf16, 4 in f32): the last REM
// swizzle among themselves by r / 4, which with the 160-byte row stride
// also spreads 8 rows over the 8 bank groups.
template <typename T, int DH>
__device__ __forceinline__ int swz(int r, int piece) {
  constexpr int PE = 16 / int(sizeof(T)), PIECES = DH / PE, REM = PIECES % 8;
  const int sw = REM == 0 || piece < PIECES - REM ? piece ^ (r & 7)
                                                  : piece ^ ((r >> 2) & (REM - 1));
  return r * DH + sw * PE;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <typename T, int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
dense_verify(Args a) {
  constexpr int STAGES = stages<T>();
  constexpr int PE = 16 / int(sizeof(T));     // elements of a 16-byte piece
  constexpr int PIECES = DH / PE;             // pieces of a row
  constexpr int TILE = TC * DH;               // elements of a tile
  constexpr int KS = DH / 16, ND = DH / 8;    // k-steps of q K^T, n-tiles of P V
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NSW = streams<T, DH>();       // warps that stream tiles
  constexpr bool QSM = q_shared<T, DH>();
  static_assert(PIECES >= 8 && (PIECES % 8 == 0 || PIECES % 8 == 2 || PIECES % 8 == 4),
                "the swizzle permutes 8 pieces a row, and 2 or 4 past them");
  static_assert(ring_bytes<T, DH>() >= size_t(WARPS) * MT * (DH + 2) * 4,
                "the merge reuses the rings");

  extern __shared__ __align__(16) unsigned char smem[];
  const int cl = a.chunk_len, nq = a.nq, qpk = a.qpk;
  const int M = nq * qpk, n_mt = (M + MT - 1) / MT;
  const int c = blockIdx.x / n_mt, r0 = (blockIdx.x % n_mt) * MT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = a.S, S_ext = S + nq, c0 = c * cl;
  const int nt = (min(cl, S_ext - c0) + TC - 1) / TC;
  const int rows = min(MT, M - r0);
  const int j_lo = r0 / qpk, j_hi = (r0 + rows - 1) / qpk;   // the block's queries
  const size_t prow = ((size_t(b) * a.Hkv + h) * a.n_chunks + c) * M + r0;

  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + ring_bytes<T, DH>());   // QSM: (MT, DH), swizzled
  float* bias_s = reinterpret_cast<float*>(q_s + (QSM ? MT * DH : 0));   // (j_hi - j_lo + 1, cl)
  int* src = reinterpret_cast<int*>(bias_s + size_t(block_queries(nq, qpk)) * cl);   // (cl)
  int* tiles = src + cl;                                                 // (NT_MAX)
  int* flags = tiles + NT_MAX;                                           // (NT_MAX)
  int* n_live_s = flags + NT_MAX;

  const T* qb = static_cast<const T*>(a.q) + (size_t(b) * a.Hkv + h) * M * DH;
  if constexpr (QSM) {   // the block's MT q rows (zero past M), published by the barrier below
    for (int p = tid; p < MT * PIECES; p += THREADS) {
      const int r = p / PIECES, piece = p % PIECES;
      *reinterpret_cast<uint4*>(q_s + swz<T, DH>(r, piece)) =
          r0 + r < M ? *reinterpret_cast<const uint4*>(qb + size_t(r0 + r) * DH + piece * PE)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the chunk's bias rows of the block's queries and its row map; columns
  // past S_ext are masked.  A column a lane, a tile a warp pass, so a
  // ballot flags the tiles some query of the block sees.
  for (int i = tid; i < nt * TC; i += THREADS) {
    const int col = c0 + i;
    bool live = false;
    for (int j = j_lo; j <= j_hi; ++j) {
      const float bv = col < S_ext ? a.bias[(size_t(b) * nq + j) * S_ext + col] : NEG_INF;
      bias_s[(j - j_lo) * cl + i] = bv;
      live |= bv > NEG_INF * 0.5f;
    }
    int row = -1;
    if (live) {
      if (col >= S) {
        row = SELF0 - (col - S);
      } else if constexpr (PAGED) {
        const int page = a.ptab[size_t(b) * (S / a.page_size) + col / a.page_size];
        if (page >= 0 && page < a.n_pages) row = page * a.page_size + col % a.page_size;
      } else {
        row = b * S + col;
      }
    }
    src[i] = row;
    const bool any = __any_sync(0xffffffffu, live);
    if (lane == 0) flags[i / TC] = any;
  }
  __syncthreads();
  if (tid == 0) {   // the live tiles, warp w's at w, w + WARPS, ...
    int n = 0;
    for (int i = 0; i < nt; ++i)
      if (flags[i]) tiles[n++] = i;
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;
  if (n_live == 0) {
    if (tid < rows) {
      a.part_m[prow + tid] = NEG_INF;
      a.part_l[prow + tid] = 0.f;
    }
    return;
  }

  // this warp's stream: K of its first tile, V of it, K of its second, ...
  const int n_mine = warp < NSW && warp < n_live ? (n_live - warp + NSW - 1) / NSW : 0;
  const int total = 2 * n_mine;
  T* my_ring = ring + size_t(warp < NSW ? warp : 0) * STAGES * TILE;
  auto issue = [&](int idx) {
    const int tile = tiles[warp + NSW * (idx >> 1)];
    const bool is_v = idx & 1;
    const T* base = static_cast<const T*>(is_v ? a.v : a.k);
    const T* self = static_cast<const T*>(is_v ? a.v_self : a.k_self);
    T* dst = my_ring + (idx % STAGES) * TILE;
    auto piece_copy = [&](int p) {
      const int r = p / PIECES, piece = p % PIECES;
      const int row = src[tile * TC + r];
      const T* s = row >= 0 ? base + (size_t(row) * a.Hkv + h) * DH
                   : row == -1 ? base
                               : self + ((size_t(b) * nq + (SELF0 - row)) * a.Hkv + h) * DH;
      tc::cp_async16(dst + swz<T, DH>(r, piece), s + piece * PE, row != -1);
    };
    if constexpr (DH == 256) {   // 32 / 64 copies a lane: addresses four at a time
#pragma unroll 4
      for (int p = lane; p < TC * PIECES; p += 32) piece_copy(p);
    } else {
#pragma unroll
      for (int p = lane; p < TC * PIECES; p += 32) piece_copy(p);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    tc::cp_async_commit();
  }

  // rows g and g + 8 of the block's m16 tile: their queries (-1: padding)
  const int rg = r0 + g, rg8 = rg + 8;
  const int bias_g = rg < M ? (rg / qpk - j_lo) * cl : -1;     // offsets of the rows' bias
  const int bias_g8 = rg8 < M ? (rg8 / qpk - j_lo) * cl : -1;
  uint32_t qa[BF16 && !QSM ? KS : 1][4];   // q's A fragments (bf16, in registers)
  if constexpr (BF16 && !QSM) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int col = 16 * ks + 2 * t4;
      auto ld = [&](int row, int cc) {
        return row < M ? *reinterpret_cast<const uint32_t*>(qb + size_t(row) * DH + cc) : 0u;
      };
      qa[ks][0] = ld(rg, col);
      qa[ks][1] = ld(rg8, col);
      qa[ks][2] = ld(rg, col + 8);
      qa[ks][3] = ld(rg8, col + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int tile = tiles[warp + NSW * i];
    tc::cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (2 * i + STAGES - 1 < total) issue(2 * i + STAGES - 1);
    tc::cp_async_commit();

    // S = q K^T: element e of n-tile n is row g (e < 2) or g + 8, column
    // 8n + 2 t4 + (e & 1) of the tile
    const T* kt = my_ring + ((2 * i) % STAGES) * TILE;
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (QSM) {   // the same products in the same order, q by ldmatrix
#pragma unroll
      for (int k2 = 0; k2 < KS / 2; ++k2) {
        uint32_t q0[4], q1[4];   // A fragments of k-steps 2 k2 and 2 k2 + 1
        tc::ldsm_x4(q0, q_s + swz<T, DH>(lane & 15, 4 * k2 + (lane >> 4)));
        tc::ldsm_x4(q1, q_s + swz<T, DH>(lane & 15, 4 * k2 + 2 + (lane >> 4)));
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t r[4];
          tc::ldsm_x4(r, kt + swz<T, DH>(8 * n + (lane & 7), 4 * k2 + (lane >> 3)));
          tc::mma16816(s[n], q0, r[0], r[1]);
          tc::mma16816(s[n], q1, r[2], r[3]);
        }
      }
    } else if constexpr (BF16) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int k2 = 0; k2 < KS / 2; ++k2) {
          uint32_t r[4];
          tc::ldsm_x4(r, kt + swz<T, DH>(8 * n + (lane & 7), 4 * k2 + (lane >> 3)));
          tc::mma16816(s[n], qa[2 * k2], r[0], r[1]);
          tc::mma16816(s[n], qa[2 * k2 + 1], r[2], r[3]);
        }
        if constexpr (KS % 2 == 1) {   // dh 80: the fifth k-step, pieces 8 and 9
          uint32_t r0, r1;
          tc::ldsm_x2(r0, r1, kt + swz<T, DH>(8 * n + (lane & 7), 2 * (KS - 1) + ((lane >> 3) & 1)));
          tc::mma16816(s[n], qa[KS - 1], r0, r1);
        }
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(qb);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int pc = 0; pc < PIECES; ++pc) {
        const float4 qg = rg < M ? reinterpret_cast<const float4*>(qf + size_t(rg) * DH)[pc] : zero;
        const float4 qg8 =
            rg8 < M ? reinterpret_cast<const float4*>(qf + size_t(rg8) * DH)[pc] : zero;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(kt) + swz<T, DH>(8 * n + 2 * t4 + e, pc));
            s[n][e] = dot4(qg, kv, s[n][e]);
            s[n][2 + e] = dot4(qg8, kv, s[n][2 + e]);
          }
      }
    }

    // scale, bias, mask; the online softmax of rows g and g + 8
    const int tb = tile * TC + 2 * t4;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? bias_g : bias_g8;
        const float bv = row >= 0 ? bias_s[row + tb + 8 * n + (e & 1)] : NEG_INF;
        s[n][e] = bv > NEG_INF * 0.5f ? s[n][e] * a.scale + bv : NEG_INF;
      }
    float mx0 = fmaxf(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])),
                      fmaxf(fmaxf(s[2][0], s[2][1]), fmaxf(s[3][0], s[3][1])));
    float mx1 = fmaxf(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])),
                      fmaxf(fmaxf(s[2][2], s[2][3]), fmaxf(s[3][2], s[3][3])));
    mx0 = fmaxf(m0, tc::quad_max(mx0));
    mx1 = fmaxf(m1, tc::quad_max(mx1));
    const float f0 = m0 == mx0 ? 1.f : __expf(m0 - mx0);
    const float f1 = m1 == mx1 ? 1.f : __expf(m1 - mx1);
    m0 = mx0, m1 = mx1;
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // row, column parity: short chains
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = e < 2 ? m0 : m1;
        const float p = s[n][e] <= NEG_INF * 0.5f ? 0.f
                        : s[n][e] == mm           ? 1.f
                                                  : __expf(s[n][e] - mm);
        s[n][e] = p;
        ls[e >> 1][e & 1] += p;
      }
    l0 = l0 * f0 + (ls[0][0] + ls[0][1]);
    l1 = l1 * f1 + (ls[1][0] + ls[1][1]);
    if (__any_sync(0xffffffffu, f0 != 1.f || f1 != 1.f)) {   // a row's maximum moved
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= f0, o[n][1] *= f0;
        o[n][2] *= f1, o[n][3] *= f1;
      }
    }

    tc::cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (2 * i + STAGES < total) issue(2 * i + STAGES);
    tc::cp_async_commit();

    // O += P V
    const T* vt = my_ring + ((2 * i + 1) % STAGES) * TILE;
    if constexpr (BF16) {
      uint32_t ph[2][4], pl[2][4];   // P's A fragments: k-step kk is n-tiles 2kk, 2kk + 1
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        tc::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
        tc::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
        tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t r[4];
          tc::ldsm_x4_t(r, vt + swz<T, DH>(16 * kk + (lane & 15), 2 * n2 + (lane >> 4)));
          tc::mma16816(o[2 * n2], ph[kk], r[0], r[1]);
          tc::mma16816(o[2 * n2], pl[kk], r[0], r[1]);
          tc::mma16816(o[2 * n2 + 1], ph[kk], r[2], r[3]);
          tc::mma16816(o[2 * n2 + 1], pl[kk], r[2], r[3]);
        }
    } else {
      const float* vf = reinterpret_cast<const float*>(vt);
      // column cc of the tile: P of rows g and g + 8 gathered from the quad
      // that holds it, times V's row cc
      auto pv_column = [&](int cc, const float (&sn)[4]) {
        const int from = (lane & ~3) | ((cc & 7) >> 1);
        const float pg = __shfl_sync(0xffffffffu, sn[cc & 1], from);
        const float pg8 = __shfl_sync(0xffffffffu, sn[2 + (cc & 1)], from);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(
              vf + swz<T, DH>(cc, 2 * n + (t4 >> 1)) + 2 * (t4 & 1));
          o[n][0] = fmaf(pg, vv.x, o[n][0]);
          o[n][1] = fmaf(pg, vv.y, o[n][1]);
          o[n][2] = fmaf(pg8, vv.x, o[n][2]);
          o[n][3] = fmaf(pg8, vv.y, o[n][3]);
        }
      };
      if constexpr (DH == 256) {
        // the accumulator holds 128 registers: one score n-tile (8
        // columns) at a time, the n-tile picked by selects, not unrolled
#pragma unroll 1
        for (int n8 = 0; n8 < 4; ++n8) {
          float sn[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sn[e] = n8 == 0 ? s[0][e] : n8 == 1 ? s[1][e] : n8 == 2 ? s[2][e] : s[3][e];
#pragma unroll
          for (int c = 0; c < 8; ++c) pv_column(8 * n8 + c, sn);
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) pv_column(cc, s[cc / 8]);
      }
    }
  }
  tc::cp_async_wait<0>();
  l0 = tc::quad_sum(l0);
  l1 = tc::quad_sum(l1);

  // merge the warps in order: (WARPS, MT, DH) accumulators, then m and l
  __syncthreads();   // every warp is done with its ring
  float* so = reinterpret_cast<float*>(smem);
  float* sm = so + WARPS * MT * DH;
  float* sl = sm + WARPS * MT;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(so + (warp * MT + g) * DH + d) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(so + (warp * MT + g + 8) * DH + d) =
        make_float2(o[n][2], o[n][3]);
  }
  if (t4 == 0) {
    sm[warp * MT + g] = m0, sm[warp * MT + g + 8] = m1;
    sl[warp * MT + g] = l0, sl[warp * MT + g + 8] = l1;
  }
  __syncthreads();
  for (int i = tid; i < rows * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm[w * MT + r]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = sm[w * MT + r];
      if (mw > NEG_INF * 0.5f)
        acc += so[(w * MT + r) * DH + d] * (mw == mx ? 1.f : __expf(mw - mx));
    }
    a.part_acc[prow * DH + i] = acc;
  }
  if (tid < rows) {
    float mx = NEG_INF, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm[w * MT + tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = sm[w * MT + tid];
      if (mw > NEG_INF * 0.5f) sum += sl[w * MT + tid] * (mw == mx ? 1.f : __expf(mw - mx));
    }
    a.part_m[prow + tid] = mx;
    a.part_l[prow + tid] = sum;
  }
}

template <typename T, int DH, bool PAGED>
cudaError_t launch(const Args& a, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(a.nq, a.qpk, a.chunk_len);
  cudaError_t err = cudaFuncSetAttribute(dense_verify<T, DH, PAGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int M = a.nq * a.qpk, n_mt = (M + MT - 1) / MT;
  dense_verify<T, DH, PAGED>
      <<<dim3(a.n_chunks * n_mt, a.Hkv, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dense::Partials p{a.part_acc, a.part_m, a.part_l, out, a.B, a.Hkv, M, a.n_chunks};
  return dense::launch_merge<T>(p, DH, stream);
}

template <typename T, bool PAGED>
cudaError_t launch_dh(const Args& a, int dh, void* out, cudaStream_t stream) {
  if (dh == 64) return launch<T, 64, PAGED>(a, out, stream);
  if (dh == 80) return launch<T, 80, PAGED>(a, out, stream);
  return dh == 128 ? launch<T, 128, PAGED>(a, out, stream) : launch<T, 256, PAGED>(a, out, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) a block of the bf16 (is_bf16 = 1) or f32 body takes
// at this dh, nq, qpk and chunk length: the wrapper's chunk plan keeps the
// bf16 body at two blocks per SM up to 5 queries a block (q_per_kv >= 4).
int recalkv_dense_decode_mq_smem(int is_bf16, int dh, int nq, int qpk, int chunk_len) {
  if (dh == 64)
    return static_cast<int>(is_bf16 ? smem_bytes<bf16, 64>(nq, qpk, chunk_len)
                                    : smem_bytes<float, 64>(nq, qpk, chunk_len));
  if (dh == 80)
    return static_cast<int>(is_bf16 ? smem_bytes<bf16, 80>(nq, qpk, chunk_len)
                                    : smem_bytes<float, 80>(nq, qpk, chunk_len));
  if (dh == 128)
    return static_cast<int>(is_bf16 ? smem_bytes<bf16, 128>(nq, qpk, chunk_len)
                                    : smem_bytes<float, 128>(nq, qpk, chunk_len));
  return static_cast<int>(is_bf16 ? smem_bytes<bf16, 256>(nq, qpk, chunk_len)
                                  : smem_bytes<float, 256>(nq, qpk, chunk_len));
}

// Both entry points take this argument list and return a cudaError_t (0 =
// success).  All tensors contiguous and 16-byte aligned, on the device of
// ``stream``; q, k, v, the self entries and out bf16 (is_bf16 = 1) or f32
// (0); bias f32.  Limits: dh 64, 80, 128 or 256, nq >= 1, 1 <= qpk <= 16,
// chunk_len a multiple of 32 up to 512 and n_chunks = ceil((S + nq) /
// chunk_len); ring and pool row indices below 2^31; the pool takes a page
// table (B, S / page_size) int32 with page_size dividing S, the ring none.
#define RECALKV_DENSE_MQ_ENTRY(NAME, PAGED)                                                \
  int NAME(int is_bf16, int dh, const void* q, const void* k, const void* v,               \
           const float* bias, const void* k_self, const void* v_self, const int* ptab,     \
           float* part_acc, float* part_m, float* part_l, void* out, int B, int S,         \
           int Hkv, int nq, int qpk, int n_chunks, int chunk_len, int page_size,           \
           int n_pages, float scale, void* stream) {                                       \
    Args a{q, k, v, bias, k_self, v_self, ptab, part_acc, part_m, part_l, B, S, Hkv, nq,   \
           qpk, n_chunks, chunk_len, page_size, n_pages, scale};                           \
    const long long rows = (PAGED) ? (long long)n_pages * page_size : (long long)B * S;   \
    if ((is_bf16 != 0 && is_bf16 != 1) ||                                                 \
        (dh != 64 && dh != 80 && dh != 128 && dh != 256) || nq < 1 ||                      \
        (long long)nq * qpk > (1 << 20) || (long long)S + nq >= (1LL << 31) ||             \
        qpk < 1 || qpk > 16 || B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || S < 0 ||    \
        k_self == nullptr || v_self == nullptr || chunk_len < TC || chunk_len > CH_MAX ||  \
        chunk_len % TC != 0 || n_chunks != (S + nq + chunk_len - 1) / chunk_len ||         \
        rows >= (1LL << 31) || (ptab != nullptr) != (PAGED) ||                             \
        ((PAGED) && (page_size < 1 || S % page_size != 0 || n_pages < 1)) ||               \
        recalkv_dense_decode_mq_smem(is_bf16, dh, nq, qpk, chunk_len) > 232448)            \
      return static_cast<int>(cudaErrorInvalidValue);                                      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                   \
    return static_cast<int>(is_bf16 ? launch_dh<bf16, PAGED>(a, dh, out, st)               \
                                    : launch_dh<float, PAGED>(a, dh, out, st));            \
  }

RECALKV_DENSE_MQ_ENTRY(recalkv_dense_decode_mq, false)         // K5's dense core
RECALKV_DENSE_MQ_ENTRY(recalkv_dense_decode_mq_paged, true)    // K7's dense core

#undef RECALKV_DENSE_MQ_ENTRY

}  // extern "C"
