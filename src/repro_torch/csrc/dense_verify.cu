// The dense cores of K5 and K7 (verify) and, at 8-16 query rows a kv head,
// of K1 and K4 (decode), in bf16 and f32: flash attention of several query
// rows over the dense KV cache (keys stored after RoPE) on Hopper (sm_90a)
// tensor cores, CUDA C++.  Two bodies, six entry points:
//
//   recalkv_dense_decode_mq        verify over the ring: replaces the Pallas
//                                  K5 (src/repro/kernels/latent_decode.py::
//                                  latent_decode_attention_mq) as the JAX
//                                  package's dense ring core (src/repro/
//                                  kernels/ops.py::_dense_ring_core_mq)
//                                  calls it, at an identity R_k
//   recalkv_dense_decode_mq_paged  verify over the pool: replaces the Pallas
//                                  K7 (latent_decode.py::
//                                  latent_decode_attention_mq_paged) as
//                                  ops.py::_dense_paged_core_mq calls it
//   recalkv_dense_decode_tc        decode over the ring at up to 16 query
//                                  rows (the wrapper sends 8-16 here; 1-7
//                                  run dense_decode.cu): K1 (latent_decode.py
//                                  ::latent_decode_attention) as ops.py::
//                                  _dense_ring_core calls it
//   recalkv_dense_decode_tc_paged  the same over the pool: K4 (latent_decode
//                                  .py::latent_decode_attention_paged) as
//                                  ops.py::_dense_paged_core calls it
//
// Verify: for batch row b, kv head h and its M = nq * qpk query rows r =
// (j, i), ordered (query, head) as ops.group_queries_mq lays them out, over
// the S ring columns and then the nq self columns:
//
//   out[b, h, r] = softmax_t(scale * q[b, h, r] . K[t, h] + bias[b, j, t]) @ V[t, h]
//
// Decode: M = qpk rows (nq = 1) under one bias row (B, S) over the ring,
// and an optional self column at bias 0.  Ring column t of row b is K / V
// row b * S + t (the ring) or ptab[b, t / page_size] * page_size + t %
// page_size (the pool); self column S + j' is k_self / v_self[b, j', h],
// already rotated.  The verify bias has a row per query (causality over
// the self columns, the feed mask and the window are in it).  No R_k, no
// rotation tables, no k-norm: the JAX cores pass an identity R_k and
// identity tables because their keys are stored after RoPE, and this body
// does not compute what those would add.
//
// What bounds it on an H100: the bytes of K and V.  At chip_smoke.py's
// shapes a call reads 134 MB (qwen3-4b's heads: B = 8, S = 4,096, Hkv = 8,
// dh = 128, bf16; 0.040 ms at 3.35 TB/s) or 67 MB (qwen3-moe's Hkv = 4).
// The operations grow with the rows: at 64 rows a kv head (qwen3-4b nq 16)
// q . K and P . V with P as hi + lo are ~13 GFLOP, ~0.02 ms on mma.sync;
// on CUDA cores at 16 rows (qwen3-moe's decode) the products alone took
// 4x the bytes bound.  So every row goes to the tensor cores, and every
// K / V tile is read from device memory once per block of up to 64 rows.
//
// Design:
//  * Split-K over the ring plus the self columns: grid (n_chunks * n_blk,
//    Hkv, B), a chunk's row blocks adjacent.  A block takes chunk_len
//    columns (a multiple of 32, at most 1024) of one (b, h) and its query
//    rows: up to 16 rows in one m16 tile
//    of mma.sync.m16n8k16 (the one-tile body), 17 or more in row groups of
//    64 (the row-group body; ceil(rows / 64) blocks on the same columns:
//    256 rows read the ring four times, not 16).  A block keeps only the
//    bias rows of its own queries (at most (rows - 1) / qpk + 2).  A
//    second kernel (dense_merge.cuh, shared with dense_decode.cu) merges
//    the chunk partials by log-sum-exp, launched as a programmatic
//    dependent.
//  * The chunk's bias rows and row map come first, into shared memory.  A
//    32-column tile is skipped before any load when every one of the
//    block's rows has it masked (the ring's empty tail, unmapped slot
//    pages, the null page 0, a window's past, unfed or later candidates);
//    masked columns of a live tile are zero-filled, never loaded, and score
//    exactly NEG_INF for the rows that do not see them.
//  * One-tile body (<= 16 rows: the verify at nq * q_per_kv <= 16,
//    and the decode at 8-16 rows): four warps share the block's shared
//    memory but each streams its own tiles: warp w takes live tiles w, w +
//    4, ... and loads their K and V (32 rows x dh, 16-byte cp.async,
//    swizzled so ldmatrix reads are free of bank conflicts) into its
//    three-stage part of the ring: two tiles (16 KB in bf16 at dh 128) in
//    flight per warp, ~128 KB per SM at two blocks per SM, and no block
//    barrier between the prologue and the epilogue.  Each warp keeps an
//    online softmax over its tiles: q's A fragments (32 registers at dh
//    128) and its 16 x dh f32 accumulator (64) stay in registers; S = q K^T
//    is 32 mma.sync a tile, P V 64 (P as a bf16 hi + lo pair: one bf16
//    rounding of P fails chip_smoke's limit, and hi + lo carries P to
//    ~2^-17).  The four warps' (m, l, acc) merge in a fixed order through
//    shared memory at the end.
//  * Row-group body (17+ rows, bf16): one warpgroup on wgmma, warp w the
//    rows 16 w .. 16 w + 15 of a 64-row group (the wgmma accumulator's
//    rows), q and a ring of K / V tiles in shared memory in wgmma.cuh's
//    128-byte swizzle; all 128 threads fill the ring, so each K / V tile
//    is read from device memory once per group.  S = q K^T is 8 (dh 128)
//    m64n32k16 products from shared memory, P V two k-steps of
//    m64n{dh}k16 with P's hi and lo from registers and V from the ring.
//    S of tile i + 1 starts before P V of tile i, so the softmax of tile
//    i + 1 runs on the CUDA cores while P V of tile i runs on the tensor
//    cores (K2's order), and O takes tile i + 1's factor once P V of tile
//    i is done.  A four-stage ring (three at dh 256: q takes 32 KB there),
//    one block barrier a tile.  Each row's softmax runs over every live
//    tile of the chunk in order, so no warp merge: each warp writes its
//    rows' partials.  The f32 parity instantiation runs the same groups,
//    tiles and order on CUDA cores in the mma fragments' layout (at dh 256
//    in two passes, each over half of dh in P V, the same scores and P).
//  * dh 256 (gemma3-12b) in the one-tile body: a warp's accumulator is 16
//    x 256 f32, 128 registers, so bf16 q leaves the registers for shared
//    memory (8 KB, swizzled) and each k-step reads its A fragments by ldmatrix,
//    in the order the register path multiplies them.  The one-tile body's
//    four three-stage bf16 rings take 192 KB: one block an SM.  Its f32
//    body's would take 256 KB, so two of its warps stream (two stages each)
//    and two idle.
//  * dh 80 (h2o-danube-1.8b) is 5 k-steps of q K^T: in the one-tile body
//    pairs by ldmatrix.x4 as at the other widths, the fifth by
//    ldmatrix.x2, its rows of 10 (bf16) or 20 (f32) pieces swizzling the
//    first 8 pieces as the others do and the rest among themselves (swz);
//    in the row groups the fifth k-step opens a second 128-byte block, and
//    P V is m64n80k16.
//  * bf16 x bf16 products are exact in f32, so q . K has no rounding point
//    beyond its inputs; P's split is the bodies' only one
//    (tests/test_torch_tc_rounding.py emulates both).  The f32
//    instantiations are the parity ones: the same plans, tiles, fragments
//    and order, with the two products on CUDA cores (each lane computes
//    the accumulator elements its mma fragment would hold; P is gathered
//    from the quad by shuffles), two stages and one block per SM.
//  * The chunk plan (kernels/dense_decode.py::verify_plan) picks the chunk
//    length with the fewest waves times a block's steps, a wave being the
//    blocks the card holds (recalkv_dense_decode_mq_blocks_per_sm, from
//    registers and shared memory), up to 1024 columns; the bias rows reach
//    shared memory by 4-byte cp.async, all in flight at once.
//  * The ring and the pool are one instantiation but for the row map, with
//    the same chunks, tiles and order: the pool equals the ring on the
//    table-gathered view bit for bit, in both types.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md §6): the
// one-tile body about twice the bytes bound, under half SDPA's time at 16
// verify rows (0.083 ms) and 2.2x the bound, 1.2x SDPA, for the 16-row
// decode (0.044 ms, a quarter of the CUDA-core body it replaced); the row
// groups 3.5x the bound at 64 rows (0.144 ms, 0.78x SDPA; half the time
// of four 16-row blocks).  What the design leaves exposed is the stream,
// not the products: with the per-tile compute taken out
// (benchmarks_torch/dense_verify_probe.py) a 64-row group still takes two
// thirds of its time, in a block's prologue and first loads, one barrier
// a tile with two tiles in flight at two blocks an SM, and the chunk
// merge's partials.  An mma.sync row group ran no faster than the wgmma
// one; the kv head fastest in the grid changed nothing; other warp counts,
// stages and chunk sizes of the one-tile body, the self tile folded into
// the last chunk, and a merge by the last block of each head were each
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
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dense::NEG_INF;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int TC = 32;          // columns of a tile: the skip unit and a warp's step
constexpr int MT = 16;          // query rows of a warp's tile: one m16 tile
constexpr int RG = WARPS * MT;  // query rows of a row-group block
constexpr int CH_MAX = 1024;    // columns of a block, at most
constexpr int NT_MAX = CH_MAX / TC;
constexpr int SELF0 = -2;       // row map: -1 zero fill, SELF0 - j self column j

struct Args {
  const void* q;        // (B, Hkv, M, dh), M = nq * qpk rows ordered (query, head)
  const void* k;        // ring (B, S, Hkv, dh) or pool (n_pages, page_size, Hkv, dh)
  const void* v;        // likewise
  const float* bias;    // verify (B, nq, S + nq); decode (B, S)
  const void* k_self;   // (B, n_self, Hkv, dh), or null (decode without a self column)
  const void* v_self;   // likewise
  const int* ptab;      // the pool: (B, S / page_size), else null
  float* part_acc;      // (B, Hkv, n_chunks, M, dh)
  float* part_m;        // (B, Hkv, n_chunks, M)
  float* part_l;        // (B, Hkv, n_chunks, M)
  int B, S, Hkv, nq, qpk, n_self, n_chunks, chunk_len, page_size, n_pages;
  int one_bias;         // decode: one bias row (B, S) for every row, self columns at 0
  float scale;
};

// Query rows of a block: one m16 tile up to 16 rows, else a row group.
__host__ __device__ constexpr int block_rows(int M) { return M <= MT ? MT : RG; }

// Stages of the one-tile body's per-warp rings and of the row-group ring.
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }
template <typename T, int DH>
__host__ __device__ constexpr int group_stages() { return sizeof(T) == 4 ? 2 : DH <= 128 ? 4 : 3; }

// The bf16 row-group body's 128-byte-swizzled tiles (wgmma.cuh's layout):
// a K or V tile is ceil(dh / 64) blocks of 32 rows x 128 B, q ceil(dh / 64)
// blocks of 64 rows x 128 B (dh 80: the second block half used).
__host__ __device__ constexpr int dh_blocks(int dh) { return (dh + 63) / 64; }
__host__ __device__ constexpr int wg_tile_bytes(int dh) { return dh_blocks(dh) * TC * 128; }
__host__ __device__ constexpr int wg_q_bytes(int dh) { return dh_blocks(dh) * RG * 128; }

// Warps of the one-tile body that stream tiles: all four, but two in the
// f32 body at dh 256, whose four two-stage rings of 32 KB tiles would take
// 256 KB (the other two warps idle and join the merge with nothing seen).
template <typename T, int DH>
__host__ __device__ constexpr int streams() { return sizeof(T) == 4 && DH == 256 ? 2 : WARPS; }

// bf16 q in shared memory, read by ldmatrix in each k-step, instead of its
// A fragments in registers: at dh 256 those would be 64 registers beside
// the 128 of the 16 x 256 f32 accumulator.
template <typename T, int DH>
__host__ __device__ constexpr bool q_shared() { return sizeof(T) == 2 && DH == 256; }

template <typename T, int DH, bool GROUP>
__host__ __device__ constexpr size_t ring_bytes() {
  return !GROUP         ? size_t(streams<T, DH>()) * stages<T>() * TC * DH * sizeof(T)
         : sizeof(T) == 2 ? size_t(group_stages<T, DH>()) * 2 * wg_tile_bytes(DH)
                          : size_t(group_stages<T, DH>()) * 2 * TC * DH * sizeof(T);
}

// Queries a block's rows can touch: rows r0 .. r0 + R - 1 of (query, head)
// order span at most (R - 1) / qpk + 2 queries.
__host__ __device__ constexpr int block_queries(int nq, int qpk, int R) {
  return (R - 1) / qpk + 2 < nq ? (R - 1) / qpk + 2 : nq;
}

template <typename T, int DH, bool GROUP>
size_t smem_bytes(int nq, int qpk, int chunk_len) {
  constexpr int R = GROUP ? RG : MT;
  constexpr bool WG = GROUP && sizeof(T) == 2;   // the wgmma row groups: q swizzled, 1 KB aligned
  return (WG ? 1024 + wg_q_bytes(DH) : q_shared<T, DH>() ? size_t(R) * DH * sizeof(T) : 0)
         + ring_bytes<T, DH, GROUP>()                        // the cp.async ring(s), then the merge
         + size_t(block_queries(nq, qpk, R)) * chunk_len * 4 // the block's bias rows
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

// 4 bytes global -> shared; ``full`` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// The chunk's bias rows of queries j_lo .. j_hi (the decode: its one row)
// by asynchronous copies, all in flight at once, then per column the
// masks past the ring (past S + n_self: NEG_INF; the decode's self
// column: 0) and the row map, and the list of tiles some row of the block
// sees.  A column a lane, a tile a warp pass, so a ballot flags a tile.
// Returns the live tiles' count (the same in every thread).
template <bool PAGED>
__device__ int chunk_prologue(const Args& a, int b, int c0, int nt, int j_lo, int j_hi,
                              float* bias_s, int* src, int* tiles, int* flags, int* n_live_s) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int cl = a.chunk_len, S = a.S, S_ext = S + a.n_self, ncols = nt * TC;
  const int nb = a.one_bias ? 1 : j_hi - j_lo + 1;
  for (int e = tid; e < nb * ncols; e += THREADS) {
    const int jr = e / ncols, i = e - jr * ncols, col = c0 + i;
    const bool ok = col < (a.one_bias ? S : S_ext);
    const size_t row = a.one_bias ? size_t(b) * S : (size_t(b) * a.nq + j_lo + jr) * S_ext;
    cp_async4(bias_s + jr * cl + i, a.bias + row + (ok ? col : 0), ok);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < ncols; i += THREADS) {
    const int col = c0 + i;
    bool live = false;
    for (int jr = 0; jr < nb; ++jr) {
      float bv = bias_s[jr * cl + i];
      if (col >= S && (col >= S_ext || a.one_bias)) {
        bv = col < S_ext ? 0.f : NEG_INF;
        bias_s[jr * cl + i] = bv;
      }
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
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nt; ++i)
      if (flags[i]) tiles[n++] = i;
    *n_live_s = n;
  }
  __syncthreads();
  return *n_live_s;
}

// The (b, h) row of K / V (base) or of a self column (self) that row-map
// entry ``row`` names (-1: base itself, never read).
template <typename T, int DH>
__device__ __forceinline__ const T* row_src(const Args& a, const T* base, const T* self, int row,
                                            int b, int h) {
  return row >= 0 ? base + (size_t(row) * a.Hkv + h) * DH
         : row == -1 ? base
                     : self + ((size_t(b) * a.n_self + (SELF0 - row)) * a.Hkv + h) * DH;
}

// 16-byte piece p of a tile (row p / PIECES) of K or V, or of a self
// column, into its swizzled place at dst; zero-filled for row -1.
template <typename T, int DH>
__device__ __forceinline__ void copy_piece(const Args& a, T* dst, const T* base, const T* self,
                                           const int* src_tile, int b, int h, int p) {
  constexpr int PE = 16 / int(sizeof(T)), PIECES = DH / PE;
  const int r = p / PIECES, piece = p % PIECES;
  const int row = src_tile[r];
  tc::cp_async16(dst + swz<T, DH>(r, piece), row_src<T, DH>(a, base, self, row, b, h) + piece * PE,
                 row != -1);
}

// q's A fragments of rows rg and rg8 (zero past M), for the bf16 register path.
template <int KS>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[KS][4], const bf16* qb, int rg,
                                             int rg8, int M, int t4, int dh) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = 16 * ks + 2 * t4;
    auto ld = [&](int row, int cc) {
      return row < M ? *reinterpret_cast<const uint32_t*>(qb + size_t(row) * dh + cc) : 0u;
    };
    qa[ks][0] = ld(rg, col);
    qa[ks][1] = ld(rg8, col);
    qa[ks][2] = ld(rg, col + 8);
    qa[ks][3] = ld(rg8, col + 8);
  }
}

// S = q K^T of one warp's m16 tile on the K tile kt: element e of n-tile n
// is row g (e < 2) or g + 8, column 8n + 2 t4 + (e & 1) of the tile.  q
// comes from the A fragments qa (bf16, registers), from the swizzled rows
// q_s (bf16, dh 256) or from device memory (f32: rows rg, rg8 of qb).
template <typename T, int DH, int QA>
__device__ __forceinline__ void tile_scores(float (&s)[4][4], const T* kt,
                                            uint32_t (&qa)[QA][4], const T* q_s,
                                            const T* qb, int rg, int rg8, int M, int lane) {
  constexpr bool BF16 = sizeof(T) == 2, QSM = q_shared<T, DH>();
  constexpr int KS = DH / 16, PIECES = DH * int(sizeof(T)) / 16;
  const int t4 = lane & 3;
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
}

// Scale, bias and mask the scores of columns tb .. tb + 31 of the bias rows
// at offsets bias_g / bias_g8 (-1: padding rows), then the online softmax
// of rows g and g + 8: P in s, (m, l) updated, and the factors f0, f1 that
// the accumulator takes (``rescale``).  Returns whether a row's maximum
// moved in the warp.
__device__ __forceinline__ bool softmax_step(float (&s)[4][4], const float* bias_s, int bias_g,
                                             int bias_g8, int tb, float scale, float& m0,
                                             float& m1, float& l0, float& l1, float& f0,
                                             float& f1) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? bias_g : bias_g8;
      const float bv = row >= 0 ? bias_s[row + tb + 8 * n + (e & 1)] : NEG_INF;
      s[n][e] = bv > NEG_INF * 0.5f ? s[n][e] * scale + bv : NEG_INF;
    }
  float mx0 = fmaxf(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])),
                    fmaxf(fmaxf(s[2][0], s[2][1]), fmaxf(s[3][0], s[3][1])));
  float mx1 = fmaxf(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])),
                    fmaxf(fmaxf(s[2][2], s[2][3]), fmaxf(s[3][2], s[3][3])));
  mx0 = fmaxf(m0, tc::quad_max(mx0));
  mx1 = fmaxf(m1, tc::quad_max(mx1));
  f0 = m0 == mx0 ? 1.f : __expf(m0 - mx0);
  f1 = m1 == mx1 ? 1.f : __expf(m1 - mx1);
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
  return __any_sync(0xffffffffu, f0 != 1.f || f1 != 1.f);
}

template <int ND>
__device__ __forceinline__ void rescale(float (&o)[ND][4], float f0, float f1) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= f0, o[n][1] *= f0;
    o[n][2] *= f1, o[n][3] *= f1;
  }
}

// P (in s, as softmax_step leaves it) as bf16 A fragments of P V: hi =
// bf16(P), lo = bf16(P - hi); k-step kk is n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void split_p(const float (&s)[4][4], uint32_t (&ph)[2][4],
                                        uint32_t (&pl)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    tc::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
    tc::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
    tc::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
    tc::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
  }
}

// O[:, 8 n0 .. 8 (n0 + NO)) += P V on CUDA cores (f32): column cc of the
// tile is P of rows g and g + 8, gathered from the quad that holds it,
// times V's row cc; o holds n-tiles n0 .. n0 + NO - 1.
template <int DH, int NO>
__device__ __forceinline__ void pv_f32(float (&o)[NO][4], float (&s)[4][4],
                                       const float* vf, int lane, int n0) {
  const int t4 = lane & 3;
  auto pv_column = [&](int cc, const float (&sn)[4]) {
    const int from = (lane & ~3) | ((cc & 7) >> 1);
    const float pg = __shfl_sync(0xffffffffu, sn[cc & 1], from);
    const float pg8 = __shfl_sync(0xffffffffu, sn[2 + (cc & 1)], from);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float2 vv = *reinterpret_cast<const float2*>(
          vf + swz<float, DH>(cc, 2 * (n0 + n) + (t4 >> 1)) + 2 * (t4 & 1));
      o[n][0] = fmaf(pg, vv.x, o[n][0]);
      o[n][1] = fmaf(pg, vv.y, o[n][1]);
      o[n][2] = fmaf(pg8, vv.x, o[n][2]);
      o[n][3] = fmaf(pg8, vv.y, o[n][3]);
    }
  };
  if constexpr (NO >= 32) {
    // the accumulator holds 128 registers: one score n-tile (8 columns)
    // at a time, the n-tile picked by selects, not unrolled
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

// O += P V of one warp's m16 tile on the V tile vt (P in s, as softmax_step
// leaves it).
template <typename T, int DH>
__device__ __forceinline__ void tile_pv(float (&o)[DH / 8][4], float (&s)[4][4],
                                        const T* vt, int lane) {
  constexpr int ND = DH / 8;
  const int t4 = lane & 3;
  if constexpr (sizeof(T) == 2) {
    uint32_t ph[2][4], pl[2][4];   // P's A fragments
    split_p(s, ph, pl);
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
    pv_f32<DH, ND>(o, s, reinterpret_cast<const float*>(vt), lane, 0);
  }
}

// The block's R q rows from r0 (zero past M) into swizzled shared memory,
// published by the prologue's barriers (bf16, dh 256).
template <typename T, int DH>
__device__ __forceinline__ void q_to_shared(T* q_s, const T* qb, int r0, int R, int M) {
  constexpr int PE = 16 / int(sizeof(T)), PIECES = DH / PE;
  for (int p = threadIdx.x; p < R * PIECES; p += THREADS) {
    const int r = p / PIECES, piece = p % PIECES;
    *reinterpret_cast<uint4*>(q_s + swz<T, DH>(r, piece)) =
        r0 + r < M ? *reinterpret_cast<const uint4*>(qb + size_t(r0 + r) * DH + piece * PE)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The one-tile body: up to 16 rows a block, each warp its own tiles.
template <typename T, int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
dense_verify(Args a) {
  constexpr int STAGES = stages<T>();
  constexpr int PIECES = DH * int(sizeof(T)) / 16;   // 16-byte pieces of a row
  constexpr int TILE = TC * DH;                      // elements of a tile
  constexpr int KS = DH / 16, ND = DH / 8;           // k-steps of q K^T, n-tiles of P V
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NSW = streams<T, DH>();              // warps that stream tiles
  constexpr bool QSM = q_shared<T, DH>();
  static_assert(PIECES >= 8 && (PIECES % 8 == 0 || PIECES % 8 == 2 || PIECES % 8 == 4),
                "the swizzle permutes 8 pieces a row, and 2 or 4 past them");
  static_assert(ring_bytes<T, DH, false>() >= size_t(WARPS) * MT * (DH + 2) * 4,
                "the merge reuses the rings");

  extern __shared__ __align__(16) unsigned char smem[];
  const int cl = a.chunk_len, nq = a.nq, qpk = a.qpk;
  const int M = nq * qpk, n_mt = (M + MT - 1) / MT;
  const int c = blockIdx.x / n_mt, r0 = (blockIdx.x % n_mt) * MT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = c * cl;
  const int nt = (min(cl, a.S + a.n_self - c0) + TC - 1) / TC;
  const int rows = min(MT, M - r0);
  const int j_lo = r0 / qpk, j_hi = (r0 + rows - 1) / qpk;   // the block's queries
  const size_t prow = ((size_t(b) * a.Hkv + h) * a.n_chunks + c) * M + r0;

  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + ring_bytes<T, DH, false>());   // QSM: (MT, DH), swizzled
  float* bias_s = reinterpret_cast<float*>(q_s + (QSM ? MT * DH : 0));   // (j_hi - j_lo + 1, cl)
  int* src = reinterpret_cast<int*>(bias_s + size_t(block_queries(nq, qpk, MT)) * cl);   // (cl)
  int* tiles = src + cl;                                                 // (NT_MAX)
  int* flags = tiles + NT_MAX;                                           // (NT_MAX)
  int* n_live_s = flags + NT_MAX;

  const T* qb = static_cast<const T*>(a.q) + (size_t(b) * a.Hkv + h) * M * DH;
  if constexpr (QSM) q_to_shared<T, DH>(q_s, qb, r0, MT, M);
  const int n_live = chunk_prologue<PAGED>(a, b, c0, nt, j_lo, j_hi, bias_s, src, tiles, flags,
                                           n_live_s);
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
    if constexpr (DH == 256) {   // 32 / 64 copies a lane: addresses four at a time
#pragma unroll 4
      for (int p = lane; p < TC * PIECES; p += 32)
        copy_piece<T, DH>(a, dst, base, self, src + tile * TC, b, h, p);
    } else {
#pragma unroll
      for (int p = lane; p < TC * PIECES; p += 32)
        copy_piece<T, DH>(a, dst, base, self, src + tile * TC, b, h, p);
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
  if constexpr (BF16 && !QSM)
    load_q_frags<KS>(qa, reinterpret_cast<const bf16*>(qb), rg, rg8, M, t4, DH);

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
    float s[4][4];
    tile_scores<T, DH>(s, my_ring + ((2 * i) % STAGES) * TILE, qa, q_s, qb, rg, rg8, M, lane);
    float f0, f1;
    if (softmax_step(s, bias_s, bias_g, bias_g8, tile * TC + 2 * t4, a.scale, m0, m1, l0, l1, f0,
                     f1))
      rescale<ND>(o, f0, f1);
    tc::cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (2 * i + STAGES < total) issue(2 * i + STAGES);
    tc::cp_async_commit();
    tile_pv<T, DH>(o, s, my_ring + ((2 * i + 1) % STAGES) * TILE, lane);
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

// The row-group body's f32 parity instantiation: up to 64 rows a block,
// warp w the m16 tile of rows 16 w .. 16 w + 15, every live tile loaded
// once into one ring for all four, the products on CUDA cores in the mma
// fragments' layout (the bf16 body, dense_verify_wg, runs them on wgmma).
// At dh 256 the 16 x 256 accumulator and the f32 products overflow the
// registers, so the block streams the chunk twice, each pass the same
// scores and P, each half of dh in P V.
template <int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
dense_verify_group(Args a) {
  using T = float;
  constexpr int ST = group_stages<T, DH>();
  constexpr int PIECES = DH / 4;
  constexpr int TILE = TC * DH;
  constexpr int HALVES = DH == 256 ? 2 : 1, NO = DH / 8 / HALVES;

  extern __shared__ __align__(16) unsigned char smem[];
  const int cl = a.chunk_len, nq = a.nq, qpk = a.qpk;
  const int M = nq * qpk, n_g = (M + RG - 1) / RG;
  const int c = blockIdx.x / n_g, r0 = (blockIdx.x % n_g) * RG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = c * cl;
  const int nt = (min(cl, a.S + a.n_self - c0) + TC - 1) / TC;
  const int rows = min(RG, M - r0);
  const int j_lo = r0 / qpk, j_hi = (r0 + rows - 1) / qpk;
  const size_t prow = ((size_t(b) * a.Hkv + h) * a.n_chunks + c) * M;   // row 0's partials

  T* ring = reinterpret_cast<T*>(smem);                                  // (ST, K / V, TILE)
  float* bias_s = reinterpret_cast<float*>(smem + ring_bytes<T, DH, true>());
  int* src = reinterpret_cast<int*>(bias_s + size_t(block_queries(nq, qpk, RG)) * cl);
  int* tiles = src + cl;
  int* flags = tiles + NT_MAX;
  int* n_live_s = flags + NT_MAX;

  const T* qb = static_cast<const T*>(a.q) + (size_t(b) * a.Hkv + h) * M * DH;
  const int n_live = chunk_prologue<PAGED>(a, b, c0, nt, j_lo, j_hi, bias_s, src, tiles, flags,
                                           n_live_s);
  if (n_live == 0) {
    for (int r = tid; r < rows; r += THREADS) {
      a.part_m[prow + r0 + r] = NEG_INF;
      a.part_l[prow + r0 + r] = 0.f;
    }
    return;
  }

  // stage i % ST: live tile i's K, then its V, copied by all the block's threads
  auto issue = [&](int i) {
    const int* st = src + tiles[i] * TC;
    T* dst = ring + size_t(i % ST) * 2 * TILE;
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* ks = static_cast<const T*>(a.k_self);
    const T* vs = static_cast<const T*>(a.v_self);
#pragma unroll 1
    for (int p = tid; p < TC * PIECES; p += THREADS) {
      copy_piece<T, DH>(a, dst, k, ks, st, b, h, p);
      copy_piece<T, DH>(a, dst + TILE, v, vs, st, b, h, p);
    }
  };

  const int wr0 = r0 + MT * warp;   // this warp's first row; past M it only loads
  const bool act = wr0 < M;
  const int rg = wr0 + g, rg8 = rg + 8;
  const int bias_g = rg < M ? (rg / qpk - j_lo) * cl : -1;
  const int bias_g8 = rg8 < M ? (rg8 / qpk - j_lo) * cl : -1;
  uint32_t qa[1][4];   // unused: q comes from device memory

#pragma unroll 1
  for (int half = 0; half < HALVES; ++half) {
    if (half > 0) __syncthreads();   // every warp is done with the ring
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < n_live) issue(s);
      tc::cp_async_commit();
    }
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    for (int i = 0; i < n_live; ++i) {
      tc::cp_async_wait<ST - 2>();
      __syncthreads();   // tile i landed for all; every warp is done with tile i - 1
      if (i + ST - 1 < n_live) issue(i + ST - 1);
      tc::cp_async_commit();
      if (!act) continue;
      const T* kt = ring + size_t(i % ST) * 2 * TILE;
      float s[4][4];
      tile_scores<T, DH>(s, kt, qa, nullptr, qb, rg, rg8, M, lane);
      float f0, f1;
      if (softmax_step(s, bias_s, bias_g, bias_g8, tiles[i] * TC + 2 * t4, a.scale, m0, m1, l0,
                       l1, f0, f1))
        rescale<NO>(o, f0, f1);
      pv_f32<DH, NO>(o, s, kt + TILE, lane, half * NO);
    }
    tc::cp_async_wait<0>();
    if (!act) continue;
    l0 = tc::quad_sum(l0);
    l1 = tc::quad_sum(l1);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * (half * NO + n) + 2 * t4;
      if (rg < M)
        *reinterpret_cast<float2*>(a.part_acc + (prow + rg) * DH + d) =
            make_float2(o[n][0], o[n][1]);
      if (rg8 < M)
        *reinterpret_cast<float2*>(a.part_acc + (prow + rg8) * DH + d) =
            make_float2(o[n][2], o[n][3]);
    }
    if (t4 == 0 && half == HALVES - 1) {
      if (rg < M) a.part_m[prow + rg] = m0, a.part_l[prow + rg] = l0;
      if (rg8 < M) a.part_m[prow + rg8] = m1, a.part_l[prow + rg8] = l1;
    }
  }
}

// The bf16 row-group body on wgmma: one warpgroup, warp w the rows 16 w ..
// 16 w + 15 of the group (the wgmma accumulator's rows), q and a ring of
// K / V tiles in shared memory in the 128-byte swizzle.  S of tile i + 1
// (m64n32k16, both operands from shared memory) starts before P V of tile
// i (m64n{dh}k16, P's hi and lo from registers, V from the ring), so the
// softmax of tile i + 1 runs on the CUDA cores while P V of tile i runs
// on the tensor cores (K2's order); O takes tile i + 1's factor once P V
// of tile i is done.
template <int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS, DH <= 128 ? 2 : 1)
dense_verify_wg(Args a) {
  constexpr int ST = group_stages<bf16, DH>();
  constexpr int KB = wg_tile_bytes(DH), QB = wg_q_bytes(DH);
  constexpr int CH = DH / 8;               // 16-byte chunks of a row
  constexpr int KS = DH / 16, ND = DH / 8;
  static_assert(ST >= 3, "a stage each for P V of tile i, S of tile i + 1 and the loads");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                   // QB, swizzled
  unsigned char* ring = q_s + QB;              // ST stages of a K tile, then a V tile
  float* bias_s = reinterpret_cast<float*>(ring + ST * 2 * KB);
  const int cl = a.chunk_len, nq = a.nq, qpk = a.qpk;
  int* src = reinterpret_cast<int*>(bias_s + size_t(block_queries(nq, qpk, RG)) * cl);
  int* tiles = src + cl;
  int* flags = tiles + NT_MAX;
  int* n_live_s = flags + NT_MAX;
  const uint32_t q_a = tc::smem_u32(q_s), ring_a = tc::smem_u32(ring);

  const int M = nq * qpk, n_g = (M + RG - 1) / RG;
  const int c = blockIdx.x / n_g, r0 = (blockIdx.x % n_g) * RG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = c * cl;
  const int nt = (min(cl, a.S + a.n_self - c0) + TC - 1) / TC;
  const int rows = min(RG, M - r0);
  const int j_lo = r0 / qpk, j_hi = (r0 + rows - 1) / qpk;
  const size_t prow = ((size_t(b) * a.Hkv + h) * a.n_chunks + c) * M;

  const int n_live = chunk_prologue<PAGED>(a, b, c0, nt, j_lo, j_hi, bias_s, src, tiles, flags,
                                           n_live_s);
  if (n_live == 0) {
    for (int r = tid; r < rows; r += THREADS) {
      a.part_m[prow + r0 + r] = NEG_INF;
      a.part_l[prow + r0 + r] = 0.f;
    }
    return;
  }

  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t(b) * a.Hkv + h) * M * DH;
  auto load_q = [&]() {   // the group's 64 q rows, zero past M
    for (int e = tid; e < RG * CH; e += THREADS) {
      const int r = e / CH, ch = e % CH;
      const bool ok = r0 + r < M;
      tc::cp_async16(q_s + wg::sw128(RG, r, ch), qb + size_t(ok ? r0 + r : 0) * DH + ch * 8, ok);
    }
  };
  auto issue = [&](int i) {   // live tile i's K and V into stage i % ST
    const int* st = src + tiles[i] * TC;
    unsigned char* kd = ring + (i % ST) * 2 * KB;
    const bf16* k = static_cast<const bf16*>(a.k);
    const bf16* v = static_cast<const bf16*>(a.v);
    const bf16* ks = static_cast<const bf16*>(a.k_self);
    const bf16* vs = static_cast<const bf16*>(a.v_self);
#pragma unroll 4
    for (int e = tid; e < TC * CH; e += THREADS) {
      const int r = e / CH, ch = e % CH, row = st[r];
      const uint32_t off = wg::sw128(TC, r, ch);
      tc::cp_async16(kd + off, row_src<bf16, DH>(a, k, ks, row, b, h) + ch * 8, row != -1);
      tc::cp_async16(kd + KB + off, row_src<bf16, DH>(a, v, vs, row, b, h) + ch * 8, row != -1);
    }
  };
  load_q();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_live) issue(s);
    tc::cp_async_commit();
  }

  const int rg = r0 + MT * warp + g, rg8 = rg + 8;
  const int bias_g = rg < M ? (rg / qpk - j_lo) * cl : -1;
  const int bias_g8 = rg8 < M ? (rg8 / qpk - j_lo) * cl : -1;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, f0, f1;
  float sc[4][4];
  uint32_t ph[2][4], pl[2][4];

  auto start_s = [&](int i) {   // S = q K^T of live tile i, started, not waited for
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t qd = q_a + (ks >> 2) * (RG * 128) + (ks & 3) * 32;
      const uint32_t kd = ring_a + (i % ST) * 2 * KB + (ks >> 2) * (TC * 128) + (ks & 3) * 32;
      wg::wgmma_ss_n32(sc, wg::desc_sw128(qd, 16, 1024), wg::desc_sw128(kd, 16, 1024), 1);
    }
    wg::commit();
  };
  auto softmax = [&](int i) {
    return softmax_step(sc, bias_s, bias_g, bias_g8, tiles[i] * TC + 2 * t4, a.scale, m0, m1,
                        l0, l1, f0, f1);
  };

  tc::cp_async_wait<ST - 2>();   // q and tile 0 have landed
  wg::fence_proxy_async();
  __syncthreads();
  start_s(0);
  wg::wait_all();
  softmax(0);                    // O is 0: its factor is moot
  split_p(sc, ph, pl);
  for (int i = 0; i < n_live; ++i) {
    tc::cp_async_wait<ST - 3>();   // tile i + 1 has landed
    wg::fence_proxy_async();
    __syncthreads();               // ... for all; every warp is done with stage (i - 1) % ST
    if (i + ST - 1 < n_live) issue(i + ST - 1);
    tc::cp_async_commit();
    const bool next = i + 1 < n_live;
    if (next) start_s(i + 1);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t vd =
          wg::desc_sw128(ring_a + (i % ST) * 2 * KB + KB + kk * (16 * 128), TC * 128, 1024);
      if constexpr (DH == 256) {
        wg::wgmma_rs_n256_tb(o, ph[kk], vd);
        wg::wgmma_rs_n256_tb(o, pl[kk], vd);
      } else if constexpr (DH == 128) {
        wg::wgmma_rs_n128_tb(o, ph[kk], vd);
        wg::wgmma_rs_n128_tb(o, pl[kk], vd);
      } else if constexpr (DH == 80) {
        wg::wgmma_rs_n80_tb(o, ph[kk], vd);
        wg::wgmma_rs_n80_tb(o, pl[kk], vd);
      } else {
        wg::wgmma_rs_n64_tb(o, ph[kk], vd);
        wg::wgmma_rs_n64_tb(o, pl[kk], vd);
      }
    }
    wg::commit();
    bool moved = false;
    if (next) {
      wg::wait_group<1>();         // S of tile i + 1 is done
      moved = softmax(i + 1);
    }
    wg::wait_all();                // P V of tile i is done
    if (next) {
      if (moved) rescale<ND>(o, f0, f1);
      split_p(sc, ph, pl);
    }
  }
  l0 = tc::quad_sum(l0);
  l1 = tc::quad_sum(l1);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t4;
    if (rg < M)
      *reinterpret_cast<float2*>(a.part_acc + (prow + rg) * DH + d) = make_float2(o[n][0], o[n][1]);
    if (rg8 < M)
      *reinterpret_cast<float2*>(a.part_acc + (prow + rg8) * DH + d) = make_float2(o[n][2], o[n][3]);
  }
  if (t4 == 0) {
    if (rg < M) a.part_m[prow + rg] = m0, a.part_l[prow + rg] = l0;
    if (rg8 < M) a.part_m[prow + rg8] = m1, a.part_l[prow + rg8] = l1;
  }
}

template <typename T, int DH, bool PAGED>
cudaError_t launch(const Args& a, void* out, cudaStream_t stream) {
  const int M = a.nq * a.qpk;
  const bool group = M > MT;
  const size_t smem = group ? smem_bytes<T, DH, true>(a.nq, a.qpk, a.chunk_len)
                            : smem_bytes<T, DH, false>(a.nq, a.qpk, a.chunk_len);
  void (*kernel)(Args) = dense_verify<T, DH, PAGED>;
  if (group) {
    if constexpr (sizeof(T) == 2) kernel = dense_verify_wg<DH, PAGED>;
    else kernel = dense_verify_group<DH, PAGED>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_blk = (M + block_rows(M) - 1) / block_rows(M);
  kernel<<<dim3(a.n_chunks * n_blk, a.Hkv, a.B), THREADS, smem, stream>>>(a);
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

template <typename T>
size_t smem_of(int dh, int nq, int qpk, int chunk_len) {
  const bool group = nq * qpk > MT;
  if (dh == 64)
    return group ? smem_bytes<T, 64, true>(nq, qpk, chunk_len) : smem_bytes<T, 64, false>(nq, qpk, chunk_len);
  if (dh == 80)
    return group ? smem_bytes<T, 80, true>(nq, qpk, chunk_len) : smem_bytes<T, 80, false>(nq, qpk, chunk_len);
  if (dh == 128)
    return group ? smem_bytes<T, 128, true>(nq, qpk, chunk_len) : smem_bytes<T, 128, false>(nq, qpk, chunk_len);
  return group ? smem_bytes<T, 256, true>(nq, qpk, chunk_len) : smem_bytes<T, 256, false>(nq, qpk, chunk_len);
}

}  // namespace

extern "C" {

// Shared memory (bytes) a block of the bf16 (is_bf16 = 1) or f32 body takes
// at this dh, nq, qpk and chunk length (the decode: nq 1): the wrapper's
// chunk plan narrows the chunk until it fits.
int recalkv_dense_decode_mq_smem(int is_bf16, int dh, int nq, int qpk, int chunk_len) {
  return static_cast<int>(is_bf16 ? smem_of<bf16>(dh, nq, qpk, chunk_len)
                                  : smem_of<float>(dh, nq, qpk, chunk_len));
}

// Blocks of the ring's bf16 (is_bf16 = 1) or f32 body that one SM holds at
// this dh, nq, qpk and chunk length (registers and shared memory), or a
// negative cudaError_t: the wrapper's chunk plan counts the waves from it
// (the pool takes the ring's plan, so the two sum in the same order).
int recalkv_dense_decode_mq_blocks_per_sm(int is_bf16, int dh, int nq, int qpk,
                                          int chunk_len) {
  const int smem = recalkv_dense_decode_mq_smem(is_bf16, dh, nq, qpk, chunk_len);
  const bool group = nq * qpk > MT;
  void (*kernel)(Args) = nullptr;
#define RECALKV_PICK(D)                                                                   \
  if (dh == D)                                                                            \
    kernel = is_bf16 ? (group ? dense_verify_wg<D, false> : dense_verify<bf16, D, false>)  \
                     : (group ? dense_verify_group<D, false> : dense_verify<float, D, false>);
  RECALKV_PICK(64)
  RECALKV_PICK(80)
  RECALKV_PICK(128)
  RECALKV_PICK(256)
#undef RECALKV_PICK
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                                              smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The verify entry points take this argument list and return a cudaError_t
// (0 = success).  All tensors contiguous and 16-byte aligned, on the device
// of ``stream``; q, k, v, the self entries and out bf16 (is_bf16 = 1) or f32
// (0); bias f32.  Limits: dh 64, 80, 128 or 256, nq >= 1, 1 <= qpk <= 16,
// chunk_len a multiple of 32 up to 1024 and n_chunks = ceil((S + nq) /
// chunk_len); ring and pool row indices below 2^31; the pool takes a page
// table (B, S / page_size) int32 with page_size dividing S, the ring none.
#define RECALKV_DENSE_MQ_ENTRY(NAME, PAGED)                                                \
  int NAME(int is_bf16, int dh, const void* q, const void* k, const void* v,               \
           const float* bias, const void* k_self, const void* v_self, const int* ptab,     \
           float* part_acc, float* part_m, float* part_l, void* out, int B, int S,         \
           int Hkv, int nq, int qpk, int n_chunks, int chunk_len, int page_size,           \
           int n_pages, float scale, void* stream) {                                       \
    Args a{q, k, v, bias, k_self, v_self, ptab, part_acc, part_m, part_l, B, S, Hkv, nq,   \
           qpk, nq, n_chunks, chunk_len, page_size, n_pages, 0, scale};                    \
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

// The decode entry points take dense_decode.cu's argument list: q (B, Hkv,
// qpk, dh), bias (B, S), optional k_self / v_self (B, Hkv, dh) (null: no
// self column).  Limits as the verify's, with 1 <= qpk <= 16, n_chunks =
// ceil((S + n_self) / chunk_len) and S + n_self >= 1.
#define RECALKV_DENSE_TC_ENTRY(NAME, PAGED)                                                \
  int NAME(int is_bf16, int dh, const void* q, const void* k, const void* v,               \
           const float* bias, const void* k_self, const void* v_self, const int* ptab,     \
           float* part_acc, float* part_m, float* part_l, void* out, int B, int S,         \
           int Hkv, int qpk, int n_chunks, int chunk_len, int page_size, int n_pages,      \
           float scale, void* stream) {                                                    \
    const int n_self = k_self != nullptr ? 1 : 0;                                          \
    Args a{q, k, v, bias, k_self, v_self, ptab, part_acc, part_m, part_l, B, S, Hkv, 1,    \
           qpk, n_self, n_chunks, chunk_len, page_size, n_pages, 1, scale};                \
    const long long rows = (PAGED) ? (long long)n_pages * page_size : (long long)B * S;   \
    if ((is_bf16 != 0 && is_bf16 != 1) ||                                                 \
        (dh != 64 && dh != 80 && dh != 128 && dh != 256) || qpk < 1 || qpk > 16 ||         \
        B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || S < 0 || S + n_self < 1 ||          \
        (long long)S + 1 >= (1LL << 31) || (k_self == nullptr) != (v_self == nullptr) ||   \
        chunk_len < TC || chunk_len > CH_MAX || chunk_len % TC != 0 ||                     \
        n_chunks != (S + n_self + chunk_len - 1) / chunk_len || rows >= (1LL << 31) ||     \
        (ptab != nullptr) != (PAGED) ||                                                    \
        ((PAGED) && (page_size < 1 || S % page_size != 0 || n_pages < 1)) ||               \
        recalkv_dense_decode_mq_smem(is_bf16, dh, 1, qpk, chunk_len) > 232448)             \
      return static_cast<int>(cudaErrorInvalidValue);                                      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                   \
    return static_cast<int>(is_bf16 ? launch_dh<bf16, PAGED>(a, dh, out, st)               \
                                    : launch_dh<float, PAGED>(a, dh, out, st));            \
  }

RECALKV_DENSE_TC_ENTRY(recalkv_dense_decode_tc, false)         // K1's dense core, 8-16 rows
RECALKV_DENSE_TC_ENTRY(recalkv_dense_decode_tc_paged, true)    // K4's dense core, 8-16 rows

#undef RECALKV_DENSE_TC_ENTRY

}  // extern "C"
