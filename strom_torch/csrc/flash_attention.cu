// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels in
// f32 FMAs (CUDA cores), at every head width.
//
// Replaces the three Pallas TPU kernels of strom/ops/flash_attention.py:
//   fa_fwd_kernel      <- _fa_kernel          (launched by _flash_fwd)
//   fa_bwd_dkv_kernel  <- _fa_bwd_dkv_kernel  (launched by _flash_bwd)
//   fa_bwd_dq_kernel   <- _fa_bwd_dq_kernel   (launched by _flash_bwd)
// They serve float32 inputs at every head width, and bfloat16 inputs at
// heads wider than 256; bf16 heads up to 256 take the tensor-core kernels
// of flash_attention_sm90.cu.
//
// What bounds them on an H100: at the main path's shape (S = 2048,
// Dh = 128) attention does ~Dh/2 = 64 multiply-adds per byte of q/k/v it
// reads once, far above the card's ~295 operations per byte, so all three
// are bound by arithmetic, not by device memory. f32 has no dense
// tensor-core path that keeps f32's precision, so these kernels do that
// arithmetic with f32 FMAs (67 TFLOP/s at most), fed from shared memory.
// A warp's float4 read (LDS.128) hands 512 bytes to its threads, and
// shared memory serves 128 bytes a clock against 128 FMAs, so the size of
// a thread's register tile sets the ceiling: 4 x 8 needs 1.5 bytes a FMA
// (at most 0.67 of the FMA peak), 8 x 8 1.0.
//
// Common to all three (256 threads, one CTA of 8 warps an SM):
//   - operands sit in shared memory as rows of f32, unpadded, with each
//     16-byte chunk of row r XOR-swizzled by r & 7 (swz), so a quarter-
//     warp's float4 reads hit distinct banks; every product reads them as
//     float4 into register micro-tiles (mm_nt, mm_nn);
//   - f32 tiles land by cp.async (16 bytes a thread, zero-filled past S)
//     in a two-stage ring, so tile j + 1 loads while tile j is computed;
//     bf16 (heads above 256) is converted to f32 as it is staged;
//   - the grid is one dimension, ordered by causal work, longest first;
//   - the causal skip is a loop bound (kv tiles up to the diagonal), and
//     only the tiles the diagonal crosses are masked elementwise;
//   - GQA: q head h reads kv head h / (H / KV); no repeated k/v in memory;
//   - any S: tiles are staged with a row bound (rows past S read as 0), the
//     tile the end of S crosses masks its kv columns >= S (the forward:
//     NEG_BIG before the row max; the backward: P = 0), and no row >= S is
//     stored.
// The forward (one CTA per 128-row q tile and DC-column chunk of the head):
//   - Q is staged once; 64-row K and V tiles run through the ring; shared
//     memory holds Q, two K and two V stages and the 128 x 64 P tile
//     (FwdTiles: 229,888 bytes at DC 128);
//   - S = Q K^T is a 4 x 8 block a thread (rows tr + 32 i, columns
//     tc + 8 j: a row's eight threads are neighbouring lanes, so the online
//     softmax's row max and sum take three shuffles); P goes to shared
//     memory rounded to T with each row's rescale factor beside it, and
//     P V adds to an 8 x 8 block (8 x 4 at DC 64) of the 128 x DC
//     accumulator a thread;
//   - a head wider than DC runs as a thread-block cluster of one CTA per
//     DC-column chunk (Dh <= 1024: 8 CTAs, the portable cluster size). Each
//     CTA computes the partial scores Q_c K_c^T of its own chunk and writes
//     them into the K stage it has just read. After a cluster barrier the
//     CTA of rank r sums, in rank order, the partials of the q rows it owns
//     (rank row * C / 128) through distributed shared memory and runs their
//     online softmax; after a second barrier every CTA copies the other
//     CTAs' rows of P, and their factors, into its own P tile, and adds
//     P V_c to its own output chunk. So the scores of a (q tile, kv tile)
//     pair are computed once across the head, and each CTA reads
//     2 (C - 1) / C of a score tile from the others (48 KB at C = 4, where
//     reading every partial whole took 128 KB and was slower).
//     Above 8 chunks a cluster of 8 CTAs owns 8 output chunks, CTA r
//     summing the partials of chunks r, r + 8, ... (Q and K restaged chunk
//     by chunk, no ring), so the scores are computed once per 8 output
//     chunks.
// The backward pair:
//   - the two groups of 128 threads split each 64 x 64 score tile's
//     products: group 0 computes S = Q K^T (dK/dV: S^T) and group 1
//     dP = dO V^T (dP^T), a 4 x 8 block a thread; both write them to
//     shared memory, where all 256 threads form P and dS (so no group waits
//     out the other's exponentials); then dK/dV's group 0 adds P^T dO to dV
//     and group 1 dS^T Q to dK (8 x 8 a thread at DC 128), and dQ's groups
//     each add dS K to half of dq's columns (4 x 8). The budgets (DqTiles,
//     DkvTiles: 229 and 230 KB at DC 128) allow one CTA an SM;
//   - the ring holds kv tiles in dQ, q/dO tiles with their lse and delta
//     rows in dK/dV;
//   - a head wider than DC (the Pallas kernels tile (1, 1, blk, Dh) with no
//     bound on Dh; here shared memory and registers run out at Dh 256) is
//     cut into DC-column chunks: the score tiles S = sum_c Q_c K_c^T and
//     dP = sum_c dO_c V_c^T are accumulated chunk by chunk, and each CTA
//     owns ONE chunk of the output (dq, or dk and dv), so any width runs
//     with the registers and shared memory of one chunk. The price: every
//     chunk's CTA recomputes the full-width scores (2x the score products
//     at Dh 256), and stages each chunk and waits for it;
//   - dK/dV: one CTA per (batch, kv head, kv tile, chunk) loops over every
//     group head and every q tile itself, so the sum the TPU grid carried
//     across sequential grid steps stays inside the CTA: no atomics, no
//     second pass.
// bf16 inputs are computed in f32; P (before P.V and dV) and dS (before dK
// and dQ) are rounded to bf16 where the JAX package rounds them
// (strom/ops/flash_attention.py:79, :185, :194, :230), and the outputs once
// at the end.
// Tensors keep the model's layout: q, o, dO, dq are [B, S, H, Dh]; k, v, dk,
// dv are [B, S, KV, Dh]; lse is [B, H, S] f32 out of the forward, lse and
// delta [B, H, SL] f32 into the backward (SL = S rounded up to 64; the
// wrapper pads). Dh is 64 or a multiple of 128: the wrapper zero-pads any
// other head. The kernels read their inputs in 16-byte chunks: the wrapper
// hands them 16-byte-aligned tensors.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;       // rows of a staged tile
constexpr float NEG_BIG = -0.7f * 3.402823466e38f;  // as the Pallas kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: where the JAX package casts P or dS to the
// input dtype before a product
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// ------------------------------------------------------ shared building blocks
// Every operand is staged in shared memory as f32 rows, swizzled (swz),
// and read as float4 into register micro-tiles.

constexpr int BT = 256;             // threads of a CTA
constexpr int GT = BT / 2;          // threads of one backward group
constexpr size_t SMEM_MAX = 232448; // dynamic shared memory one CTA may use

// Offset of float 4 f of row r in a tile of rows W floats wide: chunk f
// (4 floats) of row r sits at chunk f ^ (r & 7). Eight rows at one chunk,
// or eight consecutive chunks of one row, land in eight distinct groups of
// four banks, so a quarter-warp's float4 reads never conflict, with no
// padding.
template <int W>
__device__ __forceinline__ int swz(int r, int f) {
  static_assert(W % 32 == 0, "a swizzled row holds at least 8 chunks");
  return r * W + ((f ^ (r & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage a TILE x DC tile (row r at src + r * row_stride) swizzled into
// shared memory; rows from `rows` on (past S) are zeros. f32 goes through
// cp.async, 16 bytes a thread and nothing in registers: it lands by the
// next cp_async_wait. bf16 is read, converted and stored by the threads.
template <int DC>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long row_stride, int rows) {
  constexpr int NC = DC / 4;
  for (int e = threadIdx.x; e < TILE * NC; e += BT) {
    const int r = e / NC, f = e % NC;
    const bool in = r < rows;
    cp_async16(dst + swz<DC>(r, f), src + (in ? r * row_stride + 4 * f : 0), in ? 16 : 0);
  }
}
template <int DC>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* __restrict__ src,
                                      long row_stride, int rows) {
  constexpr int NC = DC / 4;
  for (int e = threadIdx.x; e < TILE * NC; e += BT) {
    const int r = e / NC, f = e % NC;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const __nv_bfloat162* p =
          reinterpret_cast<const __nv_bfloat162*>(src + r * row_stride + 4 * f);
      const float2 lo = __bfloat1622float2(p[0]), hi = __bfloat1622float2(p[1]);
      x = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst + swz<DC>(r, f)) = x;
  }
}

// One q tile's lse and delta (TILE values each from offset `base` of the
// [B, H, SL] rows) into dst[0, TILE) and dst[TILE, 2 TILE) by cp.async;
// zeros from row `rows` on (past S).
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ lse,
                                           const float* __restrict__ delta, long base,
                                           int rows) {
  constexpr int NC = TILE / 4;
  if (threadIdx.x < 2 * NC) {
    const int which = threadIdx.x / NC, r0 = 4 * (threadIdx.x % NC);
    const int n = min(max(rows - r0, 0), 4);
    cp_async16(dst + which * TILE + r0, (which ? delta : lse) + base + (n ? r0 : 0), 4 * n);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __float2bfloat16(x[e]);
}

// acc[i][j] += sum_d A[ra + RA i][d] * B[rb + RB j][d] over the W columns of
// two swizzled tiles (S = Q K^T, dP = dO V^T, or their transposes): per
// four d, MR + NR float4 reads feed 4 MR NR FMAs. RA and RB are multiples
// of 8, so a thread's A rows share one swizzle key and its B rows another.
template <int MR, int NR, int W, int RA, int RB>
__device__ __forceinline__ void mm_nt(float (&acc)[MR][NR], const float* A, int ra,
                                      const float* B, int rb) {
  static_assert(RA % 8 == 0 && RB % 8 == 0, "a thread's rows share a swizzle key");
  const float* a0 = A + ra * W;
  const float* b0 = B + rb * W;
  const int ka = ra & 7, kb = rb & 7;
#pragma unroll 1
  for (int u = 0; u < W; u += 32) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float4 a[MR], b[NR];
#pragma unroll
      for (int i = 0; i < MR; ++i) a[i] = ld4(a0 + RA * i * W + u + ((v ^ ka) << 2));
#pragma unroll
      for (int j = 0; j < NR; ++j) b[j] = ld4(b0 + RB * j * W + u + ((v ^ kb) << 2));
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
}

// acc[i][4 g + e] += sum_k A[ra + RA i][k] * B[k][4 (cb + CS g) + e] over the
// KD columns of swizzled score tile A and the first KD rows of swizzled
// tile B (rows WB floats wide): dQ += dS K, dV += P^T dO, dK += dS^T Q. Per
// four k, MR + 4 NG float4 reads feed 16 MR NG FMAs.
template <int MR, int NG, int KD, int WB, int RA, int CS>
__device__ __forceinline__ void mm_nn(float (&acc)[MR][4 * NG], const float* A, int ra,
                                      const float* B, int cb) {
  static_assert(RA % 8 == 0 && CS % 8 == 0, "a thread's rows share a swizzle key");
  const float* a0 = A + ra * KD;
  const int ka = ra & 7;
#pragma unroll 1
  for (int u = 0; u < KD; u += 32) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float4 a[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) a[i] = ld4(a0 + RA * i * KD + u + ((v ^ ka) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * v + e;  // row u + kk of B, whose swizzle key is kk & 7
        const float* brow = B + (u + kk) * WB + ((cb ^ (kk & 7)) << 2);
        float4 b[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) b[g] = ld4(brow + 4 * CS * g);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float x = at(a[i], e);
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[i][4 * g + 0] = fmaf(x, b[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(x, b[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(x, b[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(x, b[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
}

// The elementwise step of both backward kernels, over one TILE x TILE
// score tile split across all BT threads (a quarter-warp reads 8 chunks
// of one row): X holds S scale - lse, D holds dP - delta. Each element
// gives P = exp(X) (0 where masked(row, col)) and dS = P D scale, both
// rounded to T; dS goes to DSout and P to Pout unless Pout is null (dQ
// needs no P). Outputs may overwrite X or D: each thread reads its
// elements before it writes them.
template <typename T, typename Masked>
__device__ __forceinline__ void ew_scores(const float* X, const float* D, float* DSout,
                                          float* Pout, float scale, Masked masked) {
  constexpr int NC = TILE / 4;  // chunks a row
#pragma unroll
  for (int i = 0; i < TILE * NC / BT; ++i) {
    const int e = threadIdx.x + BT * i, r = e / NC, f = e % NC;
    const int pos = swz<TILE>(r, f);
    const float4 x = ld4(X + pos), d = ld4(D + pos);
    float p[4], ds[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      p[m] = masked(r, 4 * f + m) ? 0.f : expf(at(x, m));
      ds[m] = round_t<T>(p[m] * at(d, m) * scale);
      p[m] = round_t<T>(p[m]);
    }
    if (Pout) store4(Pout + pos, p);
    store4(DSout + pos, ds);
  }
}

// ---------------------------------------------------------------- forward
constexpr int QT = 2 * TILE;    // q rows of a forward CTA
constexpr int MAX_CLUSTER = 8;  // CTAs of a portable thread-block cluster

// Shared memory of the forward: Q (QT rows), two stages of K and of V, the
// QT x TILE P tile, and one float a q row (P's rescale factor, then the
// softmax denominator).
template <int DC> struct FwdTiles {
  static constexpr int QCH = QT * DC;   // floats of the staged Q
  static constexpr int CH = TILE * DC;  // floats of one staged K or V tile
  static constexpr int PT = QT * TILE;  // floats of the score tile
  static constexpr size_t bytes = (QCH + 4 * CH + PT + QT) * sizeof(float);
  static_assert(bytes <= SMEM_MAX, "the forward's tiles exceed a CTA's shared memory");
  // a cluster (heads wider than DC) exchanges partial scores in a K stage
  static constexpr bool exchange = CH >= PT;
};

__device__ __forceinline__ float max8(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float sum8(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the thread-block cluster's barrier, in halves: arrive (release this
// thread's shared-memory writes and reads) and wait (acquire the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Float 4 f (of 8) of thread t's 32 partial scores in the exchange tile:
// each thread's scores are contiguous, their chunks swizzled by t & 7 so
// a quarter-warp's float4 accesses hit distinct banks.
__device__ __forceinline__ int xpos(int t, int f) { return t * 32 + ((f ^ (t & 7)) << 2); }

// One CTA per (q tile of QT rows, batch, q head, DC-column chunk of the
// head), the longest causal rows first; the nch chunks of a q tile form a
// cluster of C = min(nch, 8) CTAs (ncl clusters where nch > 8). Per 64-row
// kv tile j: S = Q K_j^T (4 x 8 a thread; a cluster sums its CTAs' partial
// scores), the online softmax on S, P rounded to T into shared memory,
// then acc = alpha acc + P V_j (8 x 4 NG a thread). CL: the CTAs form
// clusters (nch > 1); without, every row is the CTA's own.
template <typename T, int DC, bool CL>
__global__ void __launch_bounds__(BT, 1)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
              int S, int H, int KV, int DHP, int causal, float scale) {
  using L = FwdTiles<DC>;
  static_assert(!CL || L::exchange, "a cluster exchanges scores in a K stage");
  constexpr int CH = L::CH, NG = DC / 64;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::QCH;    // two stages
  float* Vs = Ks + 2 * CH;    // two stages
  float* Ps = Vs + 2 * CH;    // P: [q row][kv row], rows of TILE swizzled
  float* Rs = Ps + L::PT;     // a float a q row

  const int nch = DHP / DC;
  const int C = CL ? min(nch, MAX_CLUSTER) : 1, ncl = (nch + C - 1) / C;
  const int nq = (S + QT - 1) / QT, nkv = (S + TILE - 1) / TILE;
  const int r = (int)blockIdx.x % C;              // rank in the cluster
  const int cl = (int)blockIdx.x / C;
  const int per = (int)gridDim.x / C / nq;        // clusters a q tile
  const int qi = nq - 1 - cl / per;               // longest causal rows first
  const int rem = cl % per;
  const int h = rem / ncl % H, b = rem / (ncl * H);
  const int kc = rem % ncl, c = kc * C + r;      // this CTA's output chunk
  const bool own = c < nch;                       // false only past 8 chunks
  const int nsc = (nch - r + C - 1) / C;          // score chunks r, r + C, ...
  const bool ring = ncl == 1;  // one score chunk a CTA: Q staged once, K/V in the ring
  const int kvh = h / (H / KV);
  const int t = threadIdx.x;
  const int tr = t / 8, tc = t % 8;     // scores: q rows tr + 32 i, kv columns tc + 8 j
  const int ar = t / 16, ac = t % 16;   // acc: q rows ar + 16 i, column chunks ac + 16 g
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const int q0 = qi * QT, qrows = S - q0;
  const T* qb = q + ((long)b * S + q0) * qrow + (long)h * DHP;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DHP;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DHP + (long)min(c, nch - 1) * DC;
  const int nk = causal ? min(2 * qi + 2, nkv) : nkv;

  auto stage_q = [&](int cc) {  // Q's chunk cc, in two 64-row halves
    stage<DC>(Qs, qb + cc * DC, qrow, qrows);
    stage<DC>(Qs + CH, qb + (qrows > TILE ? TILE * qrow : 0) + cc * DC, qrow, qrows - TILE);
  };
  // K_j's chunk cc into K stage `slot`, V_j's chunk c into V stage `slot`
  auto stage_k = [&](int kj, int slot, int cc) {
    stage<DC>(Ks + slot * CH, kb + (long)kj * TILE * kvrow + cc * DC, kvrow, S - kj * TILE);
  };
  auto stage_v = [&](int kj, int slot) {
    if (own) stage<DC>(Vs + slot * CH, vb + (long)kj * TILE * kvrow, kvrow, S - kj * TILE);
  };
  if (ring) {
    stage_q(r);
    stage_k(0, 0, r);
    stage_v(0, 0);
    cp_async_commit();
    if (nk > 1) {
      stage_k(1, 1, r);
      stage_v(1, 1);
    }
    cp_async_commit();
  }

  namespace cg = cooperative_groups;
  // rows of P (with Ps) and their factors in Rs that other CTAs own, copied
  // from them: row `row` is owned by the CTA of rank row * C / QT
  auto gather_rows = [&](float* P, float* R) {
    if (P) {
      for (int e = t; e < QT * TILE / 4; e += BT) {
        const int rk = e / (TILE / 4) * C / QT;
        if (rk != r)
          *reinterpret_cast<float4*>(P + 4 * e) =
              ld4(cg::this_cluster().map_shared_rank(P, rk) + 4 * e);
      }
    }
    if (t < QT && t * C / QT != r) R[t] = *cg::this_cluster().map_shared_rank(R + t, t * C / QT);
  };

  float m[4], l[4], acc[8][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;

  for (int kj = 0; kj < nk; ++kj) {
    const int slot = ring ? kj & 1 : 0;
    // a cluster's exchange tile: the K stage the ring has just read, or the
    // one never staged; at one offset in every CTA (`ring` is the cluster's)
    float* X = Ks + (ring ? slot : 1) * CH;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    if (ring) {
      cp_async_wait<1>();  // tile kj is in; tile kj + 1 may be in flight
      __syncthreads();
      mm_nt<4, 8, DC, 32, 8>(s, Qs, tr, Ks + slot * CH, tc);
    } else {
      for (int u = 0; u < nsc; ++u) {
        __syncthreads();  // the previous chunk (or tile) is read
        stage_q(r + C * u);
        stage_k(kj, 0, r + C * u);
        if (u == 0) stage_v(kj, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        mm_nt<4, 8, DC, 32, 8>(s, Qs, tr, Ks, tc);
      }
    }

    if (CL) {  // this CTA's partial scores into its exchange tile
      if (ring) __syncthreads();  // every thread has read K_j
#pragma unroll
      for (int f = 0; f < 8; ++f)
        *reinterpret_cast<float4*>(X + xpos(t, f)) =
            make_float4(s[f / 2][4 * (f % 2)], s[f / 2][4 * (f % 2) + 1],
                        s[f / 2][4 * (f % 2) + 2], s[f / 2][4 * (f % 2) + 3]);
      cluster_arrive();
      cluster_wait();  // every CTA's partial is written
    }

    // the online softmax over this tile's columns, each row by the CTA that
    // owns it (in a cluster: the sum of the partials, in rank order); P
    // rounded to T and the row's rescale factor into shared memory
    const bool diag = causal && (kj + 1) * TILE - 1 > q0;  // a column may pass a row
    const bool edge = (kj + 1) * TILE > S;                 // kv columns past S
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 32 * i;
      const bool mine = !CL || row * C / QT == r;
      if (CL && !__any_sync(0xffffffffu, mine)) continue;  // no row of this warp's
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = CL ? 0.f : s[i][j];
      if (CL && mine) {
        for (int rk = 0; rk < C; ++rk) {
          const float* Xr = rk == r ? X : cg::this_cluster().map_shared_rank(X, rk);
          const float4 lo = ld4(Xr + xpos(t, 2 * i)), hi = ld4(Xr + xpos(t, 2 * i + 1));
          x[0] += lo.x;
          x[1] += lo.y;
          x[2] += lo.z;
          x[3] += lo.w;
          x[4] += hi.x;
          x[5] += hi.y;
          x[6] += hi.z;
          x[7] += hi.w;
        }
      }
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kj * TILE + tc + 8 * j;
        x[j] *= scale;
        if ((diag && col > q0 + row) || (edge && col >= S)) x[j] = NEG_BIG;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], max8(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
      if (mine) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = expf(x[j] - m_new);
          const int col = tc + 8 * j;
          Ps[swz<TILE>(row, col >> 2) + (col & 3)] = round_t<T>(p);
          rs += p;
        }
      }
      rs = sum8(rs);
      if (mine) {
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
        if (tc == 0) Rs[row] = alpha;
      }
    }
    if (CL) {  // the other CTAs' P rows and factors into this CTA's
      cluster_arrive();
      cluster_wait();  // every slice is written, every partial read
      gather_rows(Ps, Rs);
      cluster_arrive();  // this thread's reads are done (waited below)
    }
    __syncthreads();

    if (own) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float alpha = Rs[ar + 16 * i];
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= alpha;
      }
      mm_nn<8, NG, TILE, DC, 16, 16>(acc, Ps, ar, Vs + slot * CH, ac);
    }
    __syncthreads();  // P, Rs and stage `slot` are read
    if (CL) cluster_wait();  // and this CTA's P rows by the cluster
    if (ring) {
      if (kj + 2 < nk) {
        stage_k(kj + 2, slot, r);
        stage_v(kj + 2, slot);
      }
      cp_async_commit();
    }
  }

  // each row's denominator into Rs, and its lse, by the CTA that owns it
  // (of the first cluster)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + 32 * i;
    if (tc == 0 && (!CL || row * C / QT == r)) {
      const float denom = fmaxf(l[i], 1e-30f);
      Rs[row] = denom;
      if (kc == 0 && row < qrows) lse[((long)b * H + h) * S + q0 + row] = m[i] + logf(denom);
    }
  }
  if (CL) {
    cluster_arrive();
    cluster_wait();
    gather_rows(nullptr, Rs);
    cluster_arrive();
  }
  __syncthreads();
  if (own) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ar + 16 * i;
      if (row >= qrows) continue;
      const float denom = Rs[row];
      T* orow = o + ((long)b * S + q0 + row) * qrow + (long)h * DHP + (long)c * DC;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float y[4] = {acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                            acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom};
        store4(orow + 4 * (ac + 16 * g), y);
      }
    }
  }
  if (CL) cluster_wait();  // no CTA leaves while its rows are read
}

// Shared memory of the dQ kernel: Q, dO, two stages of K and of V, and
// two score tiles (S scale - lse, then dS; dP - delta).
template <int DC> struct DqTiles {
  static constexpr int CH = TILE * DC;  // floats of one staged tile
  static constexpr size_t bytes = (6 * CH + 2 * TILE * TILE) * sizeof(float);
  static_assert(bytes <= SMEM_MAX, "dQ's tiles exceed a CTA's shared memory");
};

// Shared memory of the dK/dV kernel: K, V, two stages of Q and of dO, P^T,
// dS^T, and two stages of one q tile's lse and delta.
template <int DC> struct DkvTiles {
  static constexpr int CH = TILE * DC;
  static constexpr size_t bytes = (6 * CH + 2 * TILE * TILE + 4 * TILE) * sizeof(float);
  static_assert(bytes <= SMEM_MAX, "dK/dV's tiles exceed a CTA's shared memory");
};

// ------------------------------------------------------------- backward dQ
// One CTA per (batch, q head, 64-row q tile, DC-column chunk of dq), the
// longest causal rows first across the whole grid. Per kv tile j: group 0
// S = Q K_j^T, group 1 dP = dO V_j^T; all threads turn them into
// dS = P (dP - delta) scale; then each group adds dS K_j to its half of
// dq's columns (4 x 4 NG a thread). With one chunk (Dh <= 128) Q and dO are staged once and K_j,
// V_j run through a two-stage cp.async ring: tile j + 1 loads while tile j
// is computed. A wider head restages Q, dO, K and V chunk by chunk.
template <typename T, int DC>
__global__ void __launch_bounds__(BT, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int S, int SL, int H, int KV, int DHP,
                 int causal, float scale) {
  constexpr int CH = DqTiles<DC>::CH, NG = DC / 64;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + CH;      // dO
  float* Ks = Gs + CH;      // two stages
  float* Vs = Ks + 2 * CH;  // two stages
  float* Ds = Vs + 2 * CH;       // S scale - lse, then dS: [q row][kv row]
  float* Es = Ds + TILE * TILE;  // dP - delta

  const int nch = DHP / DC;
  const int nq = (S + TILE - 1) / TILE;
  const int per = (int)gridDim.x / nq;           // CTAs per q tile
  const int qi = nq - 1 - (int)blockIdx.x / per;  // longest causal rows first
  const int rem = (int)blockIdx.x % per;
  const int c = rem % nch, h = rem / nch % H, b = rem / (nch * H);
  const int kvh = h / (H / KV);
  const int grp = threadIdx.x / GT, lt = threadIdx.x % GT;
  const int tr = lt / 8, tc = lt % 8;  // q rows tr + 16 i, kv columns tc + 8 j
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const long qoff = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DHP;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DHP;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DHP;
  const long rowbase = ((long)b * H + h) * SL + (long)qi * TILE;
  const int qrows = S - qi * TILE;
  const int nk = causal ? qi + 1 : nq;
  const int cb = grp * 8 * NG + tc;  // dq column chunks cb + 8 g

  float lse_r[4], dlt_r[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    lse_r[i] = r < qrows ? lse[rowbase + r] : 0.f;
    dlt_r[i] = r < qrows ? delta[rowbase + r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }

  // K_j and V_j, chunk cc, into stage `slot`
  auto stage_kv = [&](int kj, int slot, int cc) {
    const long off = (long)kj * TILE * kvrow + (long)cc * DC;
    stage<DC>(Ks + slot * CH, kb + off, kvrow, S - kj * TILE);
    stage<DC>(Vs + slot * CH, vb + off, kvrow, S - kj * TILE);
  };
  if (nch == 1) {
    stage<DC>(Qs, q + qoff, qrow, qrows);
    stage<DC>(Gs, dout + qoff, qrow, qrows);
    stage_kv(0, 0, 0);
    cp_async_commit();
    if (nk > 1) stage_kv(1, 1, 0);
    cp_async_commit();
  }

  for (int kj = 0; kj < nk; ++kj) {
    const int slot = nch == 1 ? kj & 1 : 0;
    const float* Kt = Ks + slot * CH;
    const float* Vt = Vs + slot * CH;
    float sc[4][8];  // group 0: S, group 1: dP
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    // chunks in an order that ends at c, so Kt holds K_c for dS K_c
    for (int t = 1; t <= nch; ++t) {
      if (nch > 1) {
        const int cc = (c + t) % nch;
        __syncthreads();  // the previous chunk is read
        stage<DC>(Qs, q + qoff + cc * DC, qrow, qrows);
        stage<DC>(Gs, dout + qoff + cc * DC, qrow, qrows);
        stage_kv(kj, 0, cc);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();  // tile kj is in; tile kj + 1 may be in flight
      }
      __syncthreads();
      mm_nt<4, 8, DC, 16, 8>(sc, grp ? Gs : Qs, tr, grp ? Vt : Kt, tc);
    }

    // group 0 S scale - lse into Ds, group 1 dP - delta into Es; then all
    // 256 threads turn them into dS (ew_scores)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tr + 16 * i, col = tc + 8 * j;
        const int pos = swz<TILE>(r, col >> 2) + (col & 3);
        if (grp == 0) Ds[pos] = sc[i][j] * scale - lse_r[i];
        else Es[pos] = sc[i][j] - dlt_r[i];
      }
    __syncthreads();
    ew_scores<T>(Ds, Es, Ds, nullptr, scale, [&](int r, int col) {  // P = 0 where masked
      return (causal && kj == qi && col > r) || kj * TILE + col >= S;
    });
    __syncthreads();
    mm_nn<4, NG, TILE, DC, 16, 8>(acc, Ds, tr, Kt, cb);
    if (nch == 1) {
      __syncthreads();  // stage `slot` and Ds are read
      if (kj + 2 < nk) stage_kv(kj + 2, slot, 0);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= qrows) continue;
    T* row = dq + qoff + (long)r * qrow + (long)c * DC;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float x[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]};
      store4(row + 4 * (cb + 8 * g), x);
    }
  }
}

// ---------------------------------------------------------- backward dK/dV
// One CTA per (batch, kv head, 64-row kv tile, DC-column chunk), the tiles
// with the most causal q tiles first across the whole grid. It loops over
// every (group head, q tile) step itself, so dK and dV sum inside the CTA:
// no atomics, no second pass. Per step: group 0 S^T = K Q^T, group 1
// dP^T = V dO^T; all threads turn them into P^T (Pt) and dS^T (St); then
// group 0 adds P^T dO to dV and group 1 dS^T Q to dK (8 x 4 NG a
// thread). With one chunk K and V are staged once and Q, dO, lse and
// delta run through a two-stage cp.async ring; a wider head restages
// everything chunk by chunk.
template <typename T, int DC>
__global__ void __launch_bounds__(BT, 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int S, int SL, int H,
                  int KV, int DHP, int causal, float scale) {
  constexpr int CH = DkvTiles<DC>::CH, NG = DC / 64;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + CH;
  float* Qs = Vs + CH;            // two stages
  float* Gs = Qs + 2 * CH;        // dO, two stages
  float* Pt = Gs + 2 * CH;        // S^T scale - lse, then P^T: [kv row][q row]
  float* St = Pt + TILE * TILE;   // dP^T - delta, then dS^T
  float* Rs = St + TILE * TILE;   // two stages of lse and delta rows

  const int nch = DHP / DC;
  const int nq = (S + TILE - 1) / TILE;
  const int per = (int)gridDim.x / nq;      // CTAs per kv tile
  const int kj = (int)blockIdx.x / per;     // small kj has the most causal q tiles
  const int rem = (int)blockIdx.x % per;
  const int c = rem % nch, kvh = rem / nch % KV, b = rem / (nch * KV);
  const int G = H / KV;
  const int grp = threadIdx.x / GT, lt = threadIdx.x % GT;
  const int tr = lt / 8, tc = lt % 8;    // scores: kv rows tr + 16 i, q columns tc + 8 j
  const int ar = lt / 16, ac = lt % 16;  // dV, dK: kv rows ar + 8 i, column chunks ac + 16 g
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const long kvoff = ((long)b * S + (long)kj * TILE) * kvrow + (long)kvh * DHP;
  const int krows = S - kj * TILE;
  const int q0 = causal ? kj : 0, nqt = nq - q0;
  const int n = G * nqt;  // steps: (group head, q tile)

  float acc[8][4 * NG];  // group 0: dV, group 1: dK
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;

  // step s's Q and dO (chunk cc), lse and delta, into stage `slot`
  auto stage_q = [&](int s, int slot, int cc) {
    const int h = kvh * G + s / nqt, qi = q0 + s % nqt;
    const long off = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DHP + (long)cc * DC;
    stage<DC>(Qs + slot * CH, q + off, qrow, S - qi * TILE);
    stage<DC>(Gs + slot * CH, dout + off, qrow, S - qi * TILE);
    stage_rows(Rs + slot * 2 * TILE, lse, delta, ((long)b * H + h) * SL + (long)qi * TILE,
               S - qi * TILE);
  };
  if (nch == 1) {  // K and V stay put for the whole CTA: staged once
    stage<DC>(Ks, k + kvoff, kvrow, krows);
    stage<DC>(Vs, v + kvoff, kvrow, krows);
    stage_q(0, 0, 0);
    cp_async_commit();
    if (n > 1) stage_q(1, 1, 0);
    cp_async_commit();
  }

  for (int s = 0; s < n; ++s) {
    const int qi = q0 + s % nqt;
    const int slot = nch == 1 ? s & 1 : 0;
    const float* Qt = Qs + slot * CH;
    const float* Gt = Gs + slot * CH;
    const float* lse_s = Rs + slot * 2 * TILE;
    const float* dlt_s = lse_s + TILE;
    float sc[4][8];  // group 0: S^T; group 1: dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    // chunks in an order that ends at c, so Qt and Gt hold Q_c and dO_c
    for (int t = 1; t <= nch; ++t) {
      if (nch > 1) {
        const int cc = (c + t) % nch;
        __syncthreads();  // the previous chunk is read
        stage<DC>(Ks, k + kvoff + cc * DC, kvrow, krows);
        stage<DC>(Vs, v + kvoff + cc * DC, kvrow, krows);
        stage_q(s, 0, cc);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();  // step s is in; step s + 1 may be in flight
      }
      __syncthreads();
      mm_nt<4, 8, DC, 16, 8>(sc, grp ? Vs : Ks, tr, grp ? Gt : Qt, tc);
    }

    // group 0 S^T scale - lse into Pt, group 1 dP^T - delta into St; then
    // all 256 threads turn them into P^T and dS^T (ew_scores)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kr = tr + 16 * i, r = tc + 8 * j;
        const int pos = swz<TILE>(kr, r >> 2) + (r & 3);
        if (grp == 0) Pt[pos] = sc[i][j] * scale - lse_s[r];
        else St[pos] = sc[i][j] - dlt_s[r];
      }
    __syncthreads();
    ew_scores<T>(Pt, St, St, Pt, scale, [&](int kr, int r) {  // P = 0 where masked
      return (causal && qi == kj && r < kr) || qi * TILE + r >= S;
    });
    __syncthreads();
    mm_nn<8, NG, TILE, DC, 8, 16>(acc, grp ? St : Pt, ar, grp ? Qt : Gt, ac);
    if (nch == 1) {
      __syncthreads();  // stage `slot`, Pt and St are read
      if (s + 2 < n) stage_q(s + 2, slot, 0);
      cp_async_commit();
    }
  }

  T* out = grp ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ar + 8 * i;
    if (r >= krows) continue;
    T* row = out + kvoff + (long)r * kvrow + (long)c * DC;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float x[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]};
      store4(row + 4 * (ac + 16 * g), x);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The forward's grid: nch CTAs a (q tile, batch, head), in clusters of
// min(nch, MAX_CLUSTER) (no cluster for one chunk).
template <typename T, int DC, bool CL>
cudaError_t launch_fwd_grid(const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int S, int H, int KV, int DHP,
                            int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdTiles<DC>::bytes;
  cudaError_t e = allow_smem(fa_fwd_kernel<T, DC, CL>, smem);
  if (e != cudaSuccess) return e;
  const int nch = DHP / DC, C = CL ? (nch < MAX_CLUSTER ? nch : MAX_CLUSTER) : 1;
  const int ncl = (nch + C - 1) / C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((S + QT - 1) / QT) * B * H * ncl * C);
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = CL ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, fa_fwd_kernel<T, DC, CL>, (const T*)q, (const T*)k,
                         (const T*)v, (T*)o, lse, S, H, KV, DHP, causal, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One chunk (f32 at Dh 64 or 128) runs without a cluster; a wider head (f32
// above 128, bf16 above 256) with one.
template <typename T, int DC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KV, int DHP,
                       int causal, float scale, cudaStream_t stream) {
  if constexpr (DC == 128) {
    if (DHP > DC)
      return launch_fwd_grid<T, DC, true>(q, k, v, o, lse, B, S, H, KV, DHP, causal,
                                          scale, stream);
  }
  if constexpr (std::is_same<T, float>::value)
    return launch_fwd_grid<T, DC, false>(q, k, v, o, lse, B, S, H, KV, DHP, causal,
                                         scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int DC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int SL, int H, int KV, int DHP,
                      int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = DqTiles<DC>::bytes;
  cudaError_t e = allow_smem(fa_bwd_dq_kernel<T, DC>, smem);
  if (e != cudaSuccess) return e;
  const int nq = (S + TILE - 1) / TILE;
  fa_bwd_dq_kernel<T, DC><<<nq * (DHP / DC) * H * B, BT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, SL, H, KV, DHP, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int SL, int H, int KV,
                       int DHP, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = DkvTiles<DC>::bytes;
  cudaError_t e = allow_smem(fa_bwd_dkv_kernel<T, DC>, smem);
  if (e != cudaSuccess) return e;
  const int nq = (S + TILE - 1) / TILE;
  fa_bwd_dkv_kernel<T, DC><<<nq * (DHP / DC) * KV * B, BT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, SL, H, KV, DHP, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16; dh: the
// padded head width: 64 or a multiple of 128 for float32, a multiple of 128
// above 128 for bfloat16; SL: the row length of lse and delta in the
// backward, a multiple of 64 and >= S. Returns the cudaError_t of the
// launch (0 = launched), or -1 for a dtype / head width these kernels are
// not built for.
#define STROM_DISPATCH(CALL)                                            \
  if (dtype == 0 && dh == 64) return (int)CALL(float, 64);              \
  if (dh <= 0 || dh % 128) return -1;                                   \
  if (dtype == 0) return (int)CALL(float, 128);                         \
  if (dtype == 1 && dh > 128) return (int)CALL(__nv_bfloat16, 128);

extern "C" {

int strom_fa_fwd(int dtype, int dh, const void* q, const void* k, const void* v,
                 void* o, float* lse, int B, int S, int H, int KV, int causal,
                 float scale, void* stream) {
#define CALL(T, DC) launch_fwd<T, DC>(q, k, v, o, lse, B, S, H, KV, dh, causal, \
                                      scale, (cudaStream_t)stream)
  STROM_DISPATCH(CALL)
  return -1;
#undef CALL
}

int strom_fa_bwd_dq(int dtype, int dh, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dq, int B, int S, int SL, int H,
                    int KV, int causal, float scale, void* stream) {
#define CALL(T, DC) launch_dq<T, DC>(q, k, v, dout, lse, delta, dq, B, S, SL, H, \
                                     KV, dh, causal, scale, (cudaStream_t)stream)
  STROM_DISPATCH(CALL)
  return -1;
#undef CALL
}

int strom_fa_bwd_dkv(int dtype, int dh, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int B, int S,
                     int SL, int H, int KV, int causal, float scale, void* stream) {
#define CALL(T, DC) launch_dkv<T, DC>(q, k, v, dout, lse, delta, dk, dv, B, S, SL, \
                                      H, KV, dh, causal, scale, (cudaStream_t)stream)
  STROM_DISPATCH(CALL)
  return -1;
#undef CALL
}

const char* strom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
