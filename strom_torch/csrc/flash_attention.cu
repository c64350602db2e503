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
// arithmetic with f32 FMAs (67 TFLOP/s at most), fed from shared memory,
// which serves one 128-byte wavefront a clock against four warp-FMAs.
//
// The forward (scalar loads):
//   - one CTA of 256 threads per 64-row tile and DC-column chunk of the
//     head (DC = 64 or 128); q/k/v chunks are staged in dynamic shared
//     memory as f32 (rows padded to DC+1 floats, so a half-warp reading 16
//     different rows at one column hits 16 banks);
//   - each thread owns a 4x4 block of every 64x64 score tile and a 4 x DC/16
//     block of the 64 x DC accumulator, kept in registers, with rows
//     ty + 16*i and columns tx + 16*j (ty, tx = thread / 16, thread % 16);
//     row reductions of the online softmax are 16-lane shuffles.
// The backward pair (register micro-tiles, vector reads, async staging):
//   - 256 threads as two groups of 128. On each 64 x 64 score tile group 0
//     computes S = Q K^T (dK/dV: S^T) and group 1 dP = dO V^T (dP^T), a
//     4 x 8 block a thread; both write them to shared memory, where all
//     256 threads form P and dS (so no group waits out the other's
//     exponentials); then dK/dV's group 0 adds P^T dO to dV and group 1
//     dS^T Q to dK
//     (8 x 8 a thread at DC 128), and dQ's groups each add dS K to half of
//     dq's columns (4 x 8). The per-thread reads are float4 (LDS.128): 12
//     feed 128 FMAs in the score phase, 16 feed 256 in dK/dV's, against
//     8 scalar reads per 16 FMAs in the forward's layout;
//   - operands sit in shared memory as rows of f32, unpadded, with each
//     16-byte chunk of row r XOR-swizzled by r & 7 (swz), so a quarter-
//     warp's float4 reads hit distinct banks; the budgets (DqTiles,
//     DkvTiles: 229 and 230 KB at DC 128) allow one CTA of 8 warps per SM;
//   - f32 tiles land by cp.async (16 bytes a thread, zero-filled past S)
//     in a two-stage ring: kv tiles in dQ, q/dO tiles with their lse and
//     delta rows in dK/dV, so step j + 1 loads while step j is computed;
//     bf16 (heads above 256) is converted to f32 as it is staged;
//   - the grid is one dimension, ordered by causal work, longest first.
// Common to all three:
//   - a head wider than DC (the Pallas kernels tile (1, 1, blk, Dh) with no
//     bound on Dh; here shared memory and registers run out at Dh 256) is
//     cut into DC-column chunks: the score tile S = sum_c Q_c K_c^T (and
//     dP = sum_c dO_c V_c^T) is accumulated chunk by chunk, and each CTA
//     owns ONE chunk of the output (o, dq, or dk and dv), so any width runs
//     with the registers and shared memory of one chunk. The price: every
//     chunk's CTA recomputes the full-width scores (2x the score products
//     at Dh 256), and the backward stages each chunk and waits for it.
//     With one chunk the operands that stay put across the loop are
//     staged once;
//   - the causal skip is a loop bound (kv tiles up to the diagonal), and
//     only the diagonal tile is masked elementwise;
//   - GQA: q head h reads kv head h / (H / KV); no repeated k/v in memory;
//   - dK/dV: one CTA per (batch, kv head, kv tile, chunk) loops over every
//     group head and every q tile itself, so the sum the TPU grid carried
//     across sequential grid steps stays inside the CTA: no atomics, no
//     second pass;
//   - any S: tiles are staged with a row bound (rows past S read as 0), the
//     tile the end of S crosses masks its kv columns >= S (the forward:
//     NEG_BIG before the row max; the backward: P = 0), and no row >= S is
//     stored.
// bf16 inputs are computed in f32; P (before P.V and dV) and dS (before dK
// and dQ) are rounded to bf16 where the JAX package rounds them
// (strom/ops/flash_attention.py:79, :185, :194, :230), and the outputs once
// at the end.
// Tensors keep the model's layout: q, o, dO, dq are [B, S, H, Dh]; k, v, dk,
// dv are [B, S, KV, Dh]; lse is [B, H, S] f32 out of the forward, lse and
// delta [B, H, SL] f32 into the backward (SL = S rounded up to 64; the
// wrapper pads). Dh is 64 or a multiple of 128: the wrapper zero-pads any
// other head. The backward reads its inputs in 16-byte chunks: the wrapper
// hands it 16-byte-aligned tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;       // q rows and kv rows per tile
constexpr int NT = 256;        // threads per CTA (16 x 16)
constexpr int SLD = TILE + 1;  // padded row length of a 64x64 score tile
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

// Stage a TILE x DC chunk (row r at src + r * row_stride) into shared
// memory as f32 with row length DC + 1; rows from `rows` on (past S) are
// zeros.
template <typename T, int DC>
__device__ __forceinline__ void load_chunk(float* dst, const T* __restrict__ src,
                                           long row_stride, int rows) {
  constexpr int LD = DC + 1;
  for (int e = threadIdx.x; e < TILE * DC; e += NT) {
    const int r = e / DC, d = e % DC;
    dst[r * LD + d] = r < rows ? to_f(src[(long)r * row_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// acc[i][j] += sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over one staged
// chunk (a 4x4 block of a 64x64 tile).
template <int DC>
__device__ __forceinline__ void chunk_dot(float (&acc)[4][4], const float* A,
                                          const float* Bm) {
  constexpr int LD = DC + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------- forward
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
              int S, int H, int KV, int DHP, int causal, float scale) {
  constexpr int LD = DC + 1;
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;  // TILE x SLD

  const int nch = DHP / DC;
  const int nq = (S + TILE - 1) / TILE;
  const int c = blockIdx.x % nch;                 // this CTA's output chunk
  const int qi = nq - 1 - (int)blockIdx.x / nch;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const T* qb = q + ((long)b * S + (long)qi * TILE) * qrow + (long)h * DHP;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DHP;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DHP + (long)c * DC;
  const int qrows = S - qi * TILE;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = causal ? qi + 1 : nq;
  for (int kj = 0; kj < nk; ++kj) {
    const T* kt = kb + (long)kj * TILE * kvrow;
    const int krows = S - kj * TILE;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int cc = 0; cc < nch; ++cc) {
      __syncthreads();  // the previous chunk (or tile's P.V) is read
      if (nch > 1 || kj == 0) load_chunk<T, DC>(Qs, qb + cc * DC, qrow, qrows);
      load_chunk<T, DC>(Ks, kt + cc * DC, kvrow, krows);
      // V_c is read only after the softmax's barrier
      if (cc == 0) load_chunk<T, DC>(Vs, vb + (long)kj * TILE * kvrow, kvrow, krows);
      __syncthreads();
      chunk_dot<DC>(s, Qs, Ks);
    }

    const bool diag = causal && kj == qi;
    const bool edge = (kj + 1) * TILE > S;  // kv columns past S
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if ((diag && tx + 16 * j > ty + 16 * i) || (edge && kj * TILE + tx + 16 * j >= S))
          x = NEG_BIG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * SLD + tx + 16 * j] = round_t<T>(p);
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int cp = 0; cp < TILE; ++cp) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * SLD + cp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[cp * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = qi * TILE + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)b * S + r) * qrow + (long)h * DHP + (long)c * DC;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
    if (c == 0 && tx == 0) lse[((long)b * H + h) * S + r] = m[i] + logf(denom);
  }
}

// --------------------------------------------------------------- backward
// The backward kernels run 256 threads as two groups of 128 (warps 0-3 and
// 4-7). In the score phase of a 64 x 64 tile group 0 computes S = Q K^T
// (or S^T) and group 1 dP = dO V^T (or dP^T), each thread a 4 x 8 block;
// both write them to shared memory, where all 256 threads form P and dS
// (ew_scores); in the accumulation phase each group owns its own outputs. Every operand is staged in shared
// memory as f32 rows, swizzled (swz), and read as float4.

constexpr int BT = 256;             // threads of a backward CTA
constexpr int GT = BT / 2;          // threads of one group
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

template <int DC> constexpr size_t fwd_smem() {
  return (3 * TILE * (DC + 1) + TILE * SLD) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KV, int DHP,
                       int causal, float scale, cudaStream_t stream) {
  cudaError_t e = allow_smem(fa_fwd_kernel<T, DC>, fwd_smem<DC>());
  if (e != cudaSuccess) return e;
  const int nq = (S + TILE - 1) / TILE;
  fa_fwd_kernel<T, DC><<<dim3(nq * (DHP / DC), H, B), NT, fwd_smem<DC>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, H, KV, DHP, causal,
      scale);
  return cudaGetLastError();
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
