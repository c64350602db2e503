// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels in
// scalar f32 FMAs, at every head width.
//
// Replaces the three Pallas TPU kernels of strom/ops/flash_attention.py:
//   fa_fwd_kernel      <- _fa_kernel          (launched by _flash_fwd)
//   fa_bwd_dkv_kernel  <- _fa_bwd_dkv_kernel  (launched by _flash_bwd)
//   fa_bwd_dq_kernel   <- _fa_bwd_dq_kernel   (launched by _flash_bwd)
// They serve float32 inputs at every head width, and bfloat16 inputs at
// heads wider than 128; bf16 heads up to 128 take the tensor-core kernels
// of flash_attention_sm90.cu.
//
// What bounds them on an H100: at the main path's shape (S = 2048,
// Dh = 128) attention does ~Dh/2 = 64 multiply-adds per byte of q/k/v it
// reads once, far above the card's ~295 operations per byte, so all three
// are bound by arithmetic, not by device memory. f32 has no dense
// tensor-core path that keeps f32's precision, so these kernels do that
// arithmetic with scalar f32 FMAs; their design keeps the FMA units fed
// from shared memory instead of device memory:
//   - one CTA of 256 threads per 64-row tile and DC-column chunk of the
//     head (DC = 64 or 128); q/k/v/dO chunks are staged in dynamic shared
//     memory as f32 (rows padded to DC+1 floats, so a half-warp reading 16
//     different rows at one column hits 16 banks);
//   - each thread owns a 4x4 block of every 64x64 score tile and a 4 x DC/16
//     block of every 64 x DC accumulator, kept in registers, with rows
//     ty + 16*i and columns tx + 16*j (ty, tx = thread / 16, thread % 16);
//     row reductions of the online softmax are 16-lane shuffles;
//   - a head wider than DC (the Pallas kernels tile (1, 1, blk, Dh) with no
//     bound on Dh; here 227 KB of shared memory and 255 registers a thread
//     run out at Dh 256) is cut into DC-column chunks: the score tile
//     S = sum_c Q_c K_c^T (and dP = sum_c dO_c V_c^T) is accumulated chunk by
//     chunk, and each CTA owns ONE chunk of the output (o, dq, or dk and dv;
//     grid x = row tiles x chunks), so any width runs with the registers and
//     shared memory of one chunk. The price: every chunk's CTA recomputes
//     the full-width scores (2x the score products at Dh 256). With one
//     chunk the operands that stay put across the loop are staged once;
//   - the causal skip is a loop bound (kv tiles up to the diagonal), and
//     only the diagonal tile is masked elementwise;
//   - GQA: q head h reads kv head h / (H / KV); no repeated k/v in memory;
//   - dK/dV: one CTA per (batch, kv head, kv tile, chunk) loops over every
//     group head and every q tile itself, so the sum the TPU grid carried
//     across sequential grid steps stays inside the CTA: no atomics, no
//     second pass.
//   - any S: tiles are staged with a row bound (rows past S read as 0), the
//     tile the end of S crosses masks its kv columns >= S (the forward:
//     NEG_BIG before the row max; the backward: P = 0), and no row >= S is
//     stored.
// bf16 inputs are read as bf16 and computed in f32; P (before P.V and dV)
// and dS (before dK and dQ) are rounded to bf16 where the JAX package
// rounds them (strom/ops/flash_attention.py:79, :185, :194, :230), and the
// outputs once at the end.
// Tensors keep the model's layout: q, o, dO, dq are [B, S, H, Dh]; k, v, dk,
// dv are [B, S, KV, Dh]; lse is [B, H, S] f32 out of the forward, lse and
// delta [B, H, SL] f32 into the backward (SL = S rounded up to 64; the
// wrapper pads). Dh is 64 or a multiple of 128: the wrapper zero-pads any
// other head.

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

// ------------------------------------------------------------- backward dQ
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int S, int SL, int H, int KV, int DHP,
                 int causal, float scale) {
  constexpr int LD = DC + 1;
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO chunk
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ds = Vs + TILE * LD;  // dS tile, TILE x SLD

  const int nch = DHP / DC;
  const int nq = (S + TILE - 1) / TILE;
  const int c = blockIdx.x % nch;
  const int qi = nq - 1 - (int)blockIdx.x / nch;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const long qoff = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DHP;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DHP;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DHP;
  const long rowbase = ((long)b * H + h) * SL + (long)qi * TILE;
  const int qrows = S - qi * TILE;

  float lse_r[4], dlt_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[rowbase + ty + 16 * i];
    dlt_r[i] = delta[rowbase + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = causal ? qi + 1 : nq;
  for (int kj = 0; kj < nk; ++kj) {
    const long koff = (long)kj * TILE * kvrow;
    const int krows = S - kj * TILE;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    // chunks in an order that ends at c, so Ks holds K_c for dS.K_c
    for (int t = 1; t <= nch; ++t) {
      const int cc = (c + t) % nch;
      __syncthreads();
      if (nch > 1 || kj == 0) {
        load_chunk<T, DC>(Qs, q + qoff + cc * DC, qrow, qrows);
        load_chunk<T, DC>(Gs, dout + qoff + cc * DC, qrow, qrows);
      }
      load_chunk<T, DC>(Ks, kb + koff + cc * DC, kvrow, krows);
      load_chunk<T, DC>(Vs, vb + koff + cc * DC, kvrow, krows);
      __syncthreads();
      chunk_dot<DC>(s, Qs, Ks);
      chunk_dot<DC>(dp, Gs, Vs);
    }

    const bool diag = causal && kj == qi;
    const bool edge = (kj + 1) * TILE > S;  // kv columns past S
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] * scale - lse_r[i]);
        if ((diag && tx + 16 * j > ty + 16 * i) || (edge && kj * TILE + tx + 16 * j >= S))
          p = 0.f;
        Ds[(ty + 16 * i) * SLD + tx + 16 * j] =
            round_t<T>(p * (dp[i][j] - dlt_r[i]) * scale);
      }
    __syncthreads();

#pragma unroll 4
    for (int cp = 0; cp < TILE; ++cp) {
      float ds[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ds[(ty + 16 * i) * SLD + cp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[cp * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qi * TILE + ty + 16 * i >= S) continue;
    T* row = dq + qoff + (long)(ty + 16 * i) * qrow + (long)c * DC;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------- backward dK/dV
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int S, int SL, int H,
                  int KV, int DHP, int causal, float scale) {
  constexpr int LD = DC + 1;
  constexpr int NJ = DC / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + TILE * LD;   // dO chunk
  float* Pt = Gs + TILE * LD;   // P transposed: [kv row][q row], TILE x SLD
  float* St = Pt + TILE * SLD;  // dS transposed, TILE x SLD
  float* lse_s = St + TILE * SLD;
  float* dlt_s = lse_s + TILE;

  const int nch = DHP / DC;
  const int nq = (S + TILE - 1) / TILE;
  const int c = blockIdx.x % nch;
  const int kj = (int)blockIdx.x / nch;  // small kj has the most causal q tiles
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DHP, kvrow = (long)KV * DHP;
  const long kvoff = ((long)b * S + (long)kj * TILE) * kvrow + (long)kvh * DHP;
  const int krows = S - kj * TILE;

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  if (nch == 1) {  // K and V stay put for the whole CTA: staged once
    load_chunk<T, DC>(Ks, k + kvoff, kvrow, krows);
    load_chunk<T, DC>(Vs, v + kvoff, kvrow, krows);
  }
  const int q0 = causal ? kj : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qi = q0; qi < nq; ++qi) {
      const long qoff = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DHP;
      const long rowbase = ((long)b * H + h) * SL + (long)qi * TILE;
      const int qrows = S - qi * TILE;
      // rows: kv rows ty + 16*i; columns: q rows tx + 16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      // chunks in an order that ends at c, so Qs/Gs hold Q_c and dO_c
      for (int t = 1; t <= nch; ++t) {
        const int cc = (c + t) % nch;
        __syncthreads();
        if (nch > 1) {
          load_chunk<T, DC>(Ks, k + kvoff + cc * DC, kvrow, krows);
          load_chunk<T, DC>(Vs, v + kvoff + cc * DC, kvrow, krows);
        }
        load_chunk<T, DC>(Qs, q + qoff + cc * DC, qrow, qrows);
        load_chunk<T, DC>(Gs, dout + qoff + cc * DC, qrow, qrows);
        if (t == 1 && threadIdx.x < TILE) {
          lse_s[threadIdx.x] = lse[rowbase + threadIdx.x];
          dlt_s[threadIdx.x] = delta[rowbase + threadIdx.x];
        }
        __syncthreads();
#pragma unroll 2
        for (int d = 0; d < DC; ++d) {
          float kk[4], vv[4], a[4], gg[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kk[i] = Ks[(ty + 16 * i) * LD + d];
            vv[i] = Vs[(ty + 16 * i) * LD + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j] = Qs[(tx + 16 * j) * LD + d];
            gg[j] = Gs[(tx + 16 * j) * LD + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(kk[i], a[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
            }
        }
      }

      const bool diag = causal && qi == kj;
      const bool edge = (qi + 1) * TILE > S;  // q rows past S
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          float p = expf(s[i][j] * scale - lse_s[r]);
          if ((diag && r < ty + 16 * i) || (edge && qi * TILE + r >= S)) p = 0.f;
          Pt[(ty + 16 * i) * SLD + r] = round_t<T>(p);
          St[(ty + 16 * i) * SLD + r] = round_t<T>(p * (dp[i][j] - dlt_s[r]) * scale);
        }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < TILE; ++r) {
        float p[4], ds[4], gg[NJ], a[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Pt[(ty + 16 * i) * SLD + r];
          ds[i] = St[(ty + 16 * i) * SLD + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gg[j] = Gs[r * LD + tx + 16 * j];
          a[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dva[i][j] = fmaf(p[i], gg[j], dva[i][j]);
            dka[i][j] = fmaf(ds[i], a[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kj * TILE + ty + 16 * i >= S) continue;
    const long off = kvoff + (long)(ty + 16 * i) * kvrow + (long)c * DC;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

template <int DC> constexpr size_t fwd_smem() {
  return (3 * TILE * (DC + 1) + TILE * SLD) * sizeof(float);
}
template <int DC> constexpr size_t dq_smem() {
  return (4 * TILE * (DC + 1) + TILE * SLD) * sizeof(float);
}
template <int DC> constexpr size_t dkv_smem() {
  return (4 * TILE * (DC + 1) + 2 * TILE * SLD + 2 * TILE) * sizeof(float);
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
  cudaError_t e = allow_smem(fa_bwd_dq_kernel<T, DC>, dq_smem<DC>());
  if (e != cudaSuccess) return e;
  const int nq = (S + TILE - 1) / TILE;
  fa_bwd_dq_kernel<T, DC><<<dim3(nq * (DHP / DC), H, B), NT, dq_smem<DC>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, SL, H, KV, DHP, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int SL, int H, int KV,
                       int DHP, int causal, float scale, cudaStream_t stream) {
  cudaError_t e = allow_smem(fa_bwd_dkv_kernel<T, DC>, dkv_smem<DC>());
  if (e != cudaSuccess) return e;
  const int nq = (S + TILE - 1) / TILE;
  fa_bwd_dkv_kernel<T, DC><<<dim3(nq * (DHP / DC), KV, B), NT, dkv_smem<DC>(),
                             stream>>>(
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
