// The dense cores of K1 and K4 at 1-7 query rows a kv head, in bf16 and
// f32: flash decode over the dense KV cache (keys stored after RoPE), for
// Hopper (sm_90a), CUDA C++ (8-16 rows run dense_verify.cu's m16 tensor-core
// body through its decode entry points; this body still takes 8, to be
// timed against it).  One templated body, two entry
// points:
//
//   recalkv_dense_decode        the ring: replaces the Pallas K1
//                               (src/repro/kernels/latent_decode.py::
//                               latent_decode_attention) as the JAX package's
//                               dense ring core (src/repro/kernels/ops.py::
//                               _dense_ring_core) calls it, at an identity R_k
//   recalkv_dense_decode_paged  the pool: replaces the Pallas K4
//                               (latent_decode.py::latent_decode_attention_paged)
//                               as ops.py::_dense_paged_core calls it
//
// For batch row b, kv head h and its qpk query rows j (q grouped kv-major, as
// K1's are), over the ring columns t < S and one self column at bias 0:
//
//   out[b, h, j] = softmax_t(scale * q[b, h, j] . K[t, h] + bias[b, t]) @ V[t, h]
//
// Ring column t of row b is K / V row b * S + t (the ring) or ptab[b, t /
// page_size] * page_size + t % page_size (the pool); the self column is the
// k_self / v_self entry of (b, h), already rotated.  No R_k, no rotation, no
// k-norm: the JAX cores pass an identity R_k and identity tables to K1 / K4
// because their keys are stored after RoPE, and this body does not compute
// what those would add.
//
// What bounds it on an H100: at chip_smoke.py's shape (qwen3-4b's heads: B =
// 8, S = 4,096 + 1 self column, Hkv = 8, qpk = 4, dh = 128, bf16) a call
// reads 134 MB of K and V (0.040 ms at 3.35 TB/s) and does 0.54 GFLOP of
// scores and P V (~8 us even on CUDA cores at their f32 peak): a pure
// streaming problem.  K1 / K4's latent body, at the identity R_k, spent
// ~8.6 GFLOP on an identity key rebuild (bf16 hi + lo mma.sync), streamed
// R_k through a two-stage ring, read ring-sized rotation tables, filled 4 of
// 16 rows of each m16 tile and ran one 200 KB block per SM, with too few
// bytes in flight for a streaming shape.  The products grow with the rows
// while the bytes do not: at 16 rows a kv head (qwen3-moe's heads, 67 MB)
// they are 1.1 GFLOP, ~0.016 ms at the CUDA cores' f32 peak beside a
// 0.020 ms bytes bound, and the lane-group sums take 128 KB of shared
// memory, so past 7 rows the tensor cores take them (dense_verify.cu).
//
// Design:
//  * Split-K over the ring ("flash-decoding"): grid (n_chunks, Hkv, B), a
//    block takes chunk_len ring columns (a multiple of 32, at most 512) of
//    one (b, h) with all of its query rows; 256 threads at <= 85 registers
//    (qpk <= 4) and ~40 KB of shared memory in bf16 at dh 128 (256
//    columns), so 3 blocks share an SM.  The wrapper sizes the chunks for
//    about 8 blocks per SM.  The block's per-tile work is its critical path
//    (it waits for tile i before it asks for tile i + 3), so 256 threads
//    and a third block per SM each cut the time by ~10-25% where deeper
//    cp.async rings or 128 threads did not.  A second small kernel
//    (dense_merge.cuh, shared with the verify kernel) merges the chunk
//    partials by log-sum-exp, as latent_decode_tc_merge does, with each
//    thread's loads of every chunk in flight together.
//  * The chunk's bias and row map come first, into shared memory.  A 32-
//    column tile whose bias is masked everywhere (the ring's empty tail,
//    unmapped slot pages, the null page 0, a window's past) is never loaded;
//    masked columns of a live tile are zero-filled, never loaded, and score
//    NEG_INF; a chunk with no live tile writes only m = NEG_INF, l = 0.
//  * The live tiles stream through a four-stage cp.async ring of 32 rows x dh,
//    16-byte loads, K tiles first, then V tiles: three tiles (24 KB in bf16)
//    in flight per block, ~72 KB per SM.  The V tiles' loads start while
//    the last K tiles are scored and the softmax runs.
//  * CUDA cores, f32 accumulators, for both types: bf16 values widen to f32
//    exactly, so the bf16 body has no rounding point beyond its inputs and
//    its output.  Scores: a lane group of dh / 8 lanes holds the (padded to
//    1 / 2 / 4 / 8) query rows' 8 dh values each in registers and takes 2
//    (dh 128) or 1 (dh 64) columns of each tile; its partial dot products are
//    summed over the lane group by a reduce-scatter (each shuffle level
//    halves the values a lane keeps), so a lane ends with whole scores
//    instead of shuffling each one through every level.  At dh 256 the
//    lane group is a whole warp and takes 4 columns of each tile, and the
//    ring holds 64 KB in bf16.  The chunk's scores
//    (+ bias) sit in shared memory; one pass takes each row's maximum and
//    writes P = exp(s - m) in f32 in their place.  P V: lane group g adds
//    the columns it owns, 8 dh values per lane and every row, into
//    registers; the lane groups are summed in a fixed order through shared
//    memory.
//  * dh 80 (h2o-danube-1.8b): 10 lanes of 8 values; the lane group takes
//    16 lanes (two columns a tile, as at dh 128), the last 6 holding zeros,
//    so the reduce-scatter keeps its power-of-two levels.
//  * At most 8 rows.  16 rows (qwen3-moe-235b-a22b's q_per_kv) held 128
//    registers of q a lane here, one block an SM and 128 KB of lane-group
//    sums: 8.9x the bytes bound, slower than the identity route it had
//    replaced.  Those rows fill one m16 tile of dense_verify.cu's body,
//    which now serves 8-16 rows.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md §6): 1.5x
// the bytes bound at 4 rows (0.060 ms, 1.06x SDPA); at 8 rows this body
// took 0.127 ms where dense_verify.cu's tensor-core body took 0.067, so
// the wrapper runs 8 rows there.
//  * The ring and the pool are one instantiation but for the row map, with
//    the same chunks, tiles and order: the pool equals the ring on the
//    table-gathered view bit for bit.
//
// Contracts: masked logits are NEG_INF = -1e30; a row whose only live column
// is the self column returns the self value exactly (P = 1 there, exactly 0
// elsewhere, and the merge weighs it by 1); a row masked everywhere returns
// exact 0; launches go on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_merge.cuh"
#include "tc_helpers.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dense::NEG_INF;
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int TC = 32;           // ring columns of a tile: the skip and pipeline unit
constexpr int STAGES = 4;        // tiles in the cp.async ring
constexpr int CH_MAX = 512;      // ring columns of a block, at most
constexpr int EL = 8;            // dh values of a lane
constexpr long long SELF = -2;   // row map entry of the self column (-1: zero-fill)

// Lanes of a lane group: dh / 8 rounded up to a power of two (dh 80: 16
// lanes, of which the first 10 hold values and the rest hold zeros).
__host__ __device__ constexpr int lane_group(int dh) {
  return dh / EL <= 8 ? 8 : dh / EL <= 16 ? 16 : 32;
}

struct Args {
  const void* q;        // (B, Hkv, qpk, dh)
  const void* k;        // ring (B, S, Hkv, dh) or pool (n_pages, page_size, Hkv, dh)
  const void* v;        // likewise
  const float* bias;    // (B, S)
  const void* k_self;   // (B, Hkv, dh) or null
  const void* v_self;   // (B, Hkv, dh) or null
  const int* ptab;      // the pool: (B, S / page_size), else null
  float* part_acc;      // (B, Hkv, n_chunks, qpk, dh)
  float* part_m;        // (B, Hkv, n_chunks, qpk)
  float* part_l;        // (B, Hkv, n_chunks, qpk)
  void* out;            // (B, Hkv, qpk, dh), q's type
  int B, S, Hkv, qpk, n_self, n_chunks, chunk_len, page_size, n_pages;
  float scale;
};

// 8 consecutive values as f32 (bf16 widens exactly).
__device__ __forceinline__ void load8(const bf16* p, float (&x)[EL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[EL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
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

// Sums the N values of v over the LG lanes of an aligned lane group.  Each
// shuffle level with values left to split halves them: the lane whose level
// bit is set keeps the upper half, its partner the lower, and each adds the
// other's copy.  Past that (N < LG) the single value is summed by butterfly,
// so LG / N lanes hold it.  The lane then holds the sums of values base(lane)
// .. base(lane) + max(N / LG, 1) - 1 in v[0..].
template <int N, int LG>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  int n = N;
#pragma unroll
  for (int off = LG / 2; off >= 1; off /= 2) {
    if (n > 1) {
      const bool up = lane & off;
      const int half = n / 2;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
}

// The first value index a lane holds after reduce_scatter<N, LG>, and
// whether it is the one lane of its copies that writes them.
template <int N, int LG>
__device__ __forceinline__ int scatter_base(int lane, bool& writer) {
  int n = N, base = 0;
  writer = true;
#pragma unroll
  for (int off = LG / 2; off >= 1; off /= 2) {
    if (n > 1) {
      n /= 2;
      if (lane & off) base += n;
    } else if (lane & off) {
      writer = false;
    }
  }
  return base;
}

template <typename T, int DH, int NQ>
__host__ __device__ constexpr size_t stage_bytes() {
  constexpr size_t ring = size_t(STAGES) * TC * DH * sizeof(T);
  constexpr size_t red = size_t(THREADS / lane_group(DH)) * NQ * DH * 4;   // P V lane-group sums
  return ring > red ? ring : red;
}

template <typename T, int DH, int NQ>
__host__ __device__ constexpr size_t smem_bytes(int chunk_len) {
  return stage_bytes<T, DH, NQ>()           // cp.async ring, then the lane-group sums
         + size_t(chunk_len) * 8            // row map (element offsets)
         + size_t(chunk_len) * NQ * 4       // scores, then P
         + size_t(chunk_len) * 4            // bias
         + 2 * WARPS * NQ * 4 + 2 * NQ * 4  // softmax partials, row m and l
         + (2 * CH_MAX / TC + 1) * 4;       // tile flags, live tiles and their count
}

// Blocks an SM the register budget is sized for: 3 (<= 85 registers) up to
// 4 query rows, 2 up to 8; at dh 256 (a lane group of 32: 4 columns a tile)
// one fewer.
__host__ __device__ constexpr int min_blocks(int dh, int nq) {
  return (nq <= 4 ? 3 : 2) - (dh == 256 ? 1 : 0);
}

template <typename T, int DH, int NQ, bool PAGED>
__global__ void __launch_bounds__(THREADS, min_blocks(DH, NQ))
dense_decode(Args a) {
  constexpr int LG = lane_group(DH);       // lanes of a lane group (32, 16 or 8)
  constexpr int ACT = DH / EL;             // of them holding dh values (LG, or 10 at dh 80)
  constexpr int NLG = THREADS / LG;        // lane groups of a block (8, 16 or 32)
  constexpr int CPG = TC / NLG;            // columns of a tile per lane group (4, 2 or 1)
  constexpr int NV = CPG * NQ;             // partial scores of a lane per tile
  constexpr int KEEP = NV >= LG ? NV / LG : 1;
  constexpr int PIECES = DH * int(sizeof(T)) / 16;   // 16-byte pieces of a row
  constexpr int PE = 16 / int(sizeof(T));            // elements of a piece
  static_assert(LG <= 32 && 32 % LG == 0 && TC % NLG == 0, "lane groups tile warps and tiles");
  static_assert(TC == 32 && THREADS % TC == 0, "a warp's ballot flags one tile");

  extern __shared__ __align__(16) unsigned char smem[];
  const int cl = a.chunk_len;
  T* ring = reinterpret_cast<T*>(smem);
  long long* src = reinterpret_cast<long long*>(smem + stage_bytes<T, DH, NQ>());
  float* sc = reinterpret_cast<float*>(src + cl);
  float* bias_s = sc + size_t(cl) * NQ;
  float* red_m = bias_s + cl;
  float* red_l = red_m + WARPS * NQ;
  float* row_m = red_l + WARPS * NQ;
  float* row_l = row_m + NQ;
  int* tiles = reinterpret_cast<int*>(row_l + NQ);
  int* flags = tiles + CH_MAX / TC;
  int* n_live_s = flags + CH_MAX / TC;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = tid / LG, e = tid % LG;
  const bool act = ACT == LG || e < ACT;   // the lane holds dh values
  const int S = a.S, S_ext = S + a.n_self;
  const int c0 = c * cl;
  const int nt = (min(cl, S_ext - c0) + TC - 1) / TC;
  const size_t prow = (size_t(b) * a.Hkv + h) * a.n_chunks + c;

  // the chunk's bias and row map; columns past S_ext are masked.  Warp w
  // takes tiles w, w + WARPS, ...: a column a lane, so a ballot flags live
  // tiles.
  for (int i = tid; i < nt * TC; i += THREADS) {
    const int t = c0 + i;
    float bv = NEG_INF;
    long long off = -1;
    if (t < S) {
      bv = a.bias[size_t(b) * S + t];
      if (bv > NEG_INF * 0.5f) {
        long long row = -1;
        if constexpr (PAGED) {
          const int page = a.ptab[size_t(b) * (S / a.page_size) + t / a.page_size];
          if (page >= 0 && page < a.n_pages)
            row = static_cast<long long>(page) * a.page_size + t % a.page_size;
        } else {
          row = static_cast<long long>(b) * S + t;
        }
        if (row >= 0) off = (row * a.Hkv + h) * DH;
      }
    } else if (t < S_ext) {
      bv = 0.f;
      off = SELF;
    }
    bias_s[i] = bv;
    src[i] = off;
    const bool live = __any_sync(0xffffffffu, bv > NEG_INF * 0.5f);
    if (lane == 0) flags[i / TC] = live;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nt; ++i)
      if (flags[i]) tiles[n++] = i;
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;
  if (n_live == 0) {
    if (tid < a.qpk) {
      a.part_m[prow * a.qpk + tid] = NEG_INF;
      a.part_l[prow * a.qpk + tid] = 0.f;
    }
    return;
  }

  // load idx of the stream: the K tiles of the live list, then their V tiles
  const size_t self_off = (size_t(b) * a.Hkv + h) * DH;
  auto issue = [&](int idx) {
    const bool is_v = idx >= n_live;
    const int tile = tiles[is_v ? idx - n_live : idx];
    const T* base = static_cast<const T*>(is_v ? a.v : a.k);
    const T* self = static_cast<const T*>(is_v ? a.v_self : a.k_self);
    T* dst = ring + size_t(idx % STAGES) * TC * DH;
#pragma unroll
    for (int p = tid; p < TC * PIECES; p += THREADS) {
      const int r = p / PIECES, piece = p % PIECES;
      const long long off = src[tile * TC + r];
      const T* s = off >= 0 ? base + off : off == SELF ? self + self_off : base;
      tc::cp_async16(dst + r * DH + piece * PE, s + piece * PE, off != -1);
    }
  };
  const int total = 2 * n_live;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    tc::cp_async_commit();
  }

  bool writer;
  const int base = scatter_base<NV, LG>(lane, writer);
  {
    // scores: the padded query rows' dh values of this lane, in registers
    float qr[NQ][EL];
    const T* q = static_cast<const T*>(a.q) + (size_t(b) * a.Hkv + h) * a.qpk * DH + e * EL;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j < a.qpk && act) {
        load8(q + j * DH, qr[j]);
      } else {
#pragma unroll
        for (int x = 0; x < EL; ++x) qr[j][x] = 0.f;
      }
    }
    for (int i = 0; i < n_live; ++i) {
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (i + STAGES - 1 < total) issue(i + STAGES - 1);
      tc::cp_async_commit();
      const T* kt = ring + size_t(i % STAGES) * TC * DH;
      float v[NV];
#pragma unroll
      for (int u = 0; u < CPG; ++u) {
        float kv[EL] = {};
        if (act) load8(kt + (lg + NLG * u) * DH + e * EL, kv);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          float s = 0.f;
#pragma unroll
          for (int x = 0; x < EL; ++x) s = fmaf(qr[j][x], kv[x], s);
          v[u * NQ + j] = s;
        }
      }
      reduce_scatter<NV, LG>(v, lane);
      if (writer) {
        const int tb = tiles[i] * TC;
#pragma unroll
        for (int k = 0; k < KEEP; ++k) {
          const int idx = base + k, col = lg + NLG * (idx / NQ), j = idx % NQ;
          sc[(i * TC + col) * NQ + j] = v[k] * a.scale + bias_s[tb + col];
        }
      }
    }
  }
  __syncthreads();

  // softmax over the chunk's live columns: row maxima, then P in place
  const int n_sc = n_live * TC;
  float m[NQ], l[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) m[j] = NEG_INF, l[j] = 0.f;
  for (int i = tid; i < n_sc; i += THREADS)
#pragma unroll
    for (int j = 0; j < NQ; ++j) m[j] = fmaxf(m[j], sc[i * NQ + j]);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    m[j] = warp_max(m[j]);
    if (lane == 0) red_m[warp * NQ + j] = m[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    m[j] = red_m[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m[j] = fmaxf(m[j], red_m[w * NQ + j]);
  }
  for (int i = tid; i < n_sc; i += THREADS)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float s = sc[i * NQ + j];
      const float p = s == m[j] ? 1.f : __expf(s - m[j]);
      sc[i * NQ + j] = p;
      l[j] += p;
    }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    l[j] = warp_sum(l[j]);
    if (lane == 0) red_l[warp * NQ + j] = l[j];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float s = red_l[j];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red_l[w * NQ + j];
      row_m[j] = m[j];
      row_l[j] = s;
    }
  }

  // P V: lane group lg adds its columns of each V tile, 8 dh values a lane
  float o[NQ][EL];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int x = 0; x < EL; ++x) o[j][x] = 0.f;
  for (int i = n_live; i < total; ++i) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);
    tc::cp_async_commit();
    const T* vt = ring + size_t(i % STAGES) * TC * DH;
    const float* pk = sc + size_t(i - n_live) * TC * NQ;
#pragma unroll
    for (int u = 0; u < CPG; ++u) {
      const int col = lg + NLG * u;
      float vv[EL] = {}, p[NQ];
      if (act) load8(vt + col * DH + e * EL, vv);
#pragma unroll
      for (int j = 0; j < NQ; ++j) p[j] = pk[col * NQ + j];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int x = 0; x < EL; ++x) o[j][x] = fmaf(p[j], vv[x], o[j][x]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // (NLG, NQ, DH): the ring is spent
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (!act) break;
    float4* d = reinterpret_cast<float4*>(red + (lg * NQ + j) * DH + e * EL);
    d[0] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
    d[1] = make_float4(o[j][4], o[j][5], o[j][6], o[j][7]);
  }
  __syncthreads();
  for (int i = tid; i < a.qpk * DH; i += THREADS) {
    const int j = i / DH, d = i % DH;
    float s = red[j * DH + d];
    for (int g = 1; g < NLG; ++g) s += red[(g * NQ + j) * DH + d];
    a.part_acc[prow * a.qpk * DH + i] = s;
  }
  if (tid < a.qpk) {
    a.part_m[prow * a.qpk + tid] = row_m[tid];
    a.part_l[prow * a.qpk + tid] = row_l[tid];
  }
}

template <typename T, int DH, int NQ, bool PAGED>
cudaError_t launch_nq(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH, NQ>(a.chunk_len);
  cudaError_t err = cudaFuncSetAttribute(dense_decode<T, DH, NQ, PAGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dense_decode<T, DH, NQ, PAGED>
      <<<dim3(a.n_chunks, a.Hkv, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dense::Partials p{a.part_acc, a.part_m, a.part_l, a.out, a.B, a.Hkv, a.qpk, a.n_chunks};
  return dense::launch_merge<T>(p, DH, stream);
}

// The query rows pad to 1, 2, 4 or 8 (padded rows are zero and not written).
template <typename T, int DH, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.qpk == 1) return launch_nq<T, DH, 1, PAGED>(a, stream);
  if (a.qpk == 2) return launch_nq<T, DH, 2, PAGED>(a, stream);
  if (a.qpk <= 4) return launch_nq<T, DH, 4, PAGED>(a, stream);
  return launch_nq<T, DH, 8, PAGED>(a, stream);
}

template <typename T, bool PAGED>
cudaError_t launch_dh(const Args& a, int dh, cudaStream_t stream) {
  if (dh == 64) return launch<T, 64, PAGED>(a, stream);
  if (dh == 80) return launch<T, 80, PAGED>(a, stream);
  return dh == 128 ? launch<T, 128, PAGED>(a, stream) : launch<T, 256, PAGED>(a, stream);
}

}  // namespace

extern "C" {

// Both entry points take this argument list and return a cudaError_t (0 =
// success).  All tensors contiguous and 16-byte aligned, on the device of
// ``stream``; q, k, v, the self entries and out bf16 (is_bf16 = 1) or f32
// (0); bias f32.  Null k_self / v_self mean no self column.  Limits: dh 64,
// 80, 128 or 256, 1 <= qpk <= 8, chunk_len a multiple of 32 up to 512 and n_chunks =
// ceil((S + n_self) / chunk_len) >= 1; the pool takes a page table (B, S /
// page_size) int32 with page_size dividing S, the ring none.
#define RECALKV_DENSE_ENTRY(NAME, PAGED)                                                 \
  int NAME(int is_bf16, int dh, const void* q, const void* k, const void* v,             \
           const float* bias, const void* k_self, const void* v_self, const int* ptab,   \
           float* part_acc, float* part_m, float* part_l, void* out, int B, int S,       \
           int Hkv, int qpk, int n_chunks, int chunk_len, int page_size, int n_pages,    \
           float scale, void* stream) {                                                  \
    const int n_self = k_self != nullptr ? 1 : 0;                                        \
    Args a{q, k, v, bias, k_self, v_self, ptab, part_acc, part_m, part_l, out, B, S,     \
           Hkv, qpk, n_self, n_chunks, chunk_len, page_size, n_pages, scale};             \
    if ((is_bf16 != 0 && is_bf16 != 1) ||                                               \
        (dh != 64 && dh != 80 && dh != 128 && dh != 256) || qpk < 1 ||                   \
        qpk > 8 || B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || S < 0 ||               \
        (k_self == nullptr) != (v_self == nullptr) || chunk_len < TC ||                  \
        chunk_len > CH_MAX || chunk_len % TC != 0 || n_chunks < 1 ||                     \
        n_chunks != (S + n_self + chunk_len - 1) / chunk_len ||                          \
        (ptab != nullptr) != (PAGED) ||                                                  \
        ((PAGED) && (page_size < 1 || S % page_size != 0 || n_pages < 1)))              \
      return static_cast<int>(cudaErrorInvalidValue);                                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                 \
    return static_cast<int>(is_bf16 ? launch_dh<bf16, PAGED>(a, dh, st)                  \
                                     : launch_dh<float, PAGED>(a, dh, st));              \
  }

RECALKV_DENSE_ENTRY(recalkv_dense_decode, false)         // K1's dense core
RECALKV_DENSE_ENTRY(recalkv_dense_decode_paged, true)    // K4's dense core

#undef RECALKV_DENSE_ENTRY

}  // extern "C"
