// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels in
// scalar f32 FMAs.
//
// Replaces the three Pallas TPU kernels of strom/ops/flash_attention.py:
//   fa_fwd_kernel      <- _fa_kernel          (launched by _flash_fwd)
//   fa_bwd_dkv_kernel  <- _fa_bwd_dkv_kernel  (launched by _flash_bwd)
//   fa_bwd_dq_kernel   <- _fa_bwd_dq_kernel   (launched by _flash_bwd)
// All three serve float32 inputs only; bf16 inputs take the tensor-core
// kernels of flash_attention_sm90.cu.
//
// What bounds them on an H100: at the main path's shape (S = 2048,
// Dh = 128) attention does ~Dh/2 = 64 multiply-adds per byte of q/k/v it
// reads once, far above the card's ~295 operations per byte, so all three
// are bound by arithmetic, not by device memory. f32 has no dense
// tensor-core path that keeps f32's precision, so these kernels do that
// arithmetic with scalar f32 FMAs; their design keeps the FMA units fed
// from shared memory instead of device memory:
//   - one CTA of 256 threads per 64-row tile; q/k/v/dO tiles are staged in
//     dynamic shared memory as f32 (rows padded to Dh+1 floats, so a
//     half-warp reading 16 different rows at one column hits 16 banks);
//   - each thread owns a 4x4 block of every 64x64 score tile and a 4 x Dh/16
//     block of every 64 x Dh accumulator, kept in registers, with rows
//     ty + 16*i and columns tx + 16*j (ty, tx = thread / 16, thread % 16);
//     row reductions of the online softmax are 16-lane shuffles;
//   - the causal skip is a loop bound (kv tiles up to the diagonal), and
//     only the diagonal tile is masked elementwise;
//   - GQA: q head h reads kv head h / (H / KV); no repeated k/v in memory;
//   - dK/dV: one CTA per (batch, kv head, kv tile) loops over every group
//     head and every q tile itself, so the sum the TPU grid carried across
//     sequential grid steps stays inside the CTA: no atomics, no second pass.
//   - any S: tiles are staged with a row bound (rows past S read as 0), the
//     tile the end of S crosses masks its kv columns >= S (the forward:
//     NEG_BIG before the row max; the backward: P = 0), and no row >= S is
//     stored.
// Tensors keep the model's layout: q, o, dO, dq are [B, S, H, Dh]; k, v, dk,
// dv are [B, S, KV, Dh]; lse is [B, H, S] f32 out of the forward, lse and
// delta [B, H, SL] f32 into the backward (SL = S rounded up to 64; the
// wrapper pads). Dh is 64 or 128: the wrapper zero-pads a narrower head.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;     // q rows and kv rows per tile
constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int SLD = TILE + 1;  // padded row length of a 64x64 score tile
constexpr float NEG_BIG = -0.7f * 3.402823466e38f;  // as the Pallas kernel

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Stage a TILE x DH tile (row r at src + r * row_stride) into shared memory
// as f32 with row length DH + 1; rows from `rows` on (past S) are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long row_stride, int rows) {
  constexpr int LD = DH + 1;
  for (int e = threadIdx.x; e < TILE * DH; e += NT) {
    const int r = e / DH, d = e % DH;
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

// ---------------------------------------------------------------- forward
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
              int S, int H, int KV, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;  // TILE x SLD

  const int nq = (S + TILE - 1) / TILE;
  const int qi = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DH, kvrow = (long)KV * DH;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DH;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DH;

  load_tile<T, DH>(Qs, q + ((long)b * S + (long)qi * TILE) * qrow + (long)h * DH, qrow,
                   S - qi * TILE);

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
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile<T, DH>(Ks, kb + (long)kj * TILE * kvrow, kvrow, S - kj * TILE);
    load_tile<T, DH>(Vs, vb + (long)kj * TILE * kvrow, kvrow, S - kj * TILE);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
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
        Ps[(ty + 16 * i) * SLD + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
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
    T* orow = o + ((long)b * S + r) * qrow + (long)h * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
    if (tx == 0) lse[((long)b * H + h) * S + r] = m[i] + logf(denom);
  }
}

// ------------------------------------------------------------- backward dQ
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int S, int SL, int H, int KV, int causal,
                 float scale) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO tile
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ds = Vs + TILE * LD;  // dS tile, TILE x SLD

  const int nq = (S + TILE - 1) / TILE;
  const int qi = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DH, kvrow = (long)KV * DH;
  const long qoff = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DH;
  const T* kb = k + (long)b * S * kvrow + (long)kvh * DH;
  const T* vb = v + (long)b * S * kvrow + (long)kvh * DH;
  const long rowbase = ((long)b * H + h) * SL + (long)qi * TILE;

  load_tile<T, DH>(Qs, q + qoff, qrow, S - qi * TILE);
  load_tile<T, DH>(Gs, dout + qoff, qrow, S - qi * TILE);
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
    __syncthreads();
    load_tile<T, DH>(Ks, kb + (long)kj * TILE * kvrow, kvrow, S - kj * TILE);
    load_tile<T, DH>(Vs, vb + (long)kj * TILE * kvrow, kvrow, S - kj * TILE);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float a[4], g[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        g[i] = Gs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * LD + d];
        w[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
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
        Ds[(ty + 16 * i) * SLD + tx + 16 * j] = p * (dp[i][j] - dlt_r[i]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float ds[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ds[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qi * TILE + ty + 16 * i >= S) continue;
    T* row = dq + qoff + (long)(ty + 16 * i) * qrow;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------- backward dK/dV
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv,
                  int S, int SL, int H, int KV, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + TILE * LD;   // dO tile
  float* Pt = Gs + TILE * LD;   // P transposed: [kv row][q row], TILE x SLD
  float* St = Pt + TILE * SLD;  // dS transposed, TILE x SLD
  float* lse_s = St + TILE * SLD;
  float* dlt_s = lse_s + TILE;

  const int nq = (S + TILE - 1) / TILE;
  const int kj = blockIdx.x;  // small kj has the most causal q tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long qrow = (long)H * DH, kvrow = (long)KV * DH;
  const long kvoff = ((long)b * S + (long)kj * TILE) * kvrow + (long)kvh * DH;

  load_tile<T, DH>(Ks, k + kvoff, kvrow, S - kj * TILE);
  load_tile<T, DH>(Vs, v + kvoff, kvrow, S - kj * TILE);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int q0 = causal ? kj : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qi = q0; qi < nq; ++qi) {
      const long qoff = ((long)b * S + (long)qi * TILE) * qrow + (long)h * DH;
      const long rowbase = ((long)b * H + h) * SL + (long)qi * TILE;
      __syncthreads();
      load_tile<T, DH>(Qs, q + qoff, qrow, S - qi * TILE);
      load_tile<T, DH>(Gs, dout + qoff, qrow, S - qi * TILE);
      if (threadIdx.x < TILE) {
        lse_s[threadIdx.x] = lse[rowbase + threadIdx.x];
        dlt_s[threadIdx.x] = delta[rowbase + threadIdx.x];
      }
      __syncthreads();

      // rows: kv rows c = ty + 16*i; columns: q rows r = tx + 16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; ++d) {
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

      const bool diag = causal && qi == kj;
      const bool edge = (qi + 1) * TILE > S;  // q rows past S
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          float p = expf(s[i][j] * scale - lse_s[r]);
          if ((diag && r < ty + 16 * i) || (edge && qi * TILE + r >= S)) p = 0.f;
          Pt[(ty + 16 * i) * SLD + r] = p;
          St[(ty + 16 * i) * SLD + r] = p * (dp[i][j] - dlt_s[r]) * scale;
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
    const long off = kvoff + (long)(ty + 16 * i) * kvrow;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

template <int DH> constexpr size_t fwd_smem() {
  return (3 * TILE * (DH + 1) + TILE * SLD) * sizeof(float);
}
template <int DH> constexpr size_t dq_smem() {
  return (4 * TILE * (DH + 1) + TILE * SLD) * sizeof(float);
}
template <int DH> constexpr size_t dkv_smem() {
  return (4 * TILE * (DH + 1) + 2 * TILE * SLD + 2 * TILE) * sizeof(float);
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KV, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  fa_fwd_kernel<T, DH><<<dim3((S + TILE - 1) / TILE, H, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, H, KV, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int SL, int H, int KV, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  fa_bwd_dq_kernel<T, DH><<<dim3((S + TILE - 1) / TILE, H, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, SL, H, KV, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int SL, int H, int KV,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkv_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  fa_bwd_dkv_kernel<T, DH><<<dim3((S + TILE - 1) / TILE, KV, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, SL, H, KV, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32 (the only one built);
// dh: 64 or 128; SL: the row length of lse and delta in the backward, a
// multiple of 64 and >= S. Returns the cudaError_t of the launch (0 =
// launched), or -1 for a type / head width this library was not built for.
#define STROM_DISPATCH_F32(CALL)                                      \
  if (dtype == 0 && dh == 64) return (int)CALL(float, 64);            \
  if (dtype == 0 && dh == 128) return (int)CALL(float, 128);

extern "C" {

int strom_fa_fwd(int dtype, int dh, const void* q, const void* k, const void* v,
                 void* o, float* lse, int B, int S, int H, int KV, int causal,
                 float scale, void* stream) {
#define CALL(T, D) launch_fwd<T, D>(q, k, v, o, lse, B, S, H, KV, causal, scale, \
                                    (cudaStream_t)stream)
  STROM_DISPATCH_F32(CALL)
  return -1;
#undef CALL
}

int strom_fa_bwd_dq(int dtype, int dh, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dq, int B, int S, int SL, int H,
                    int KV, int causal, float scale, void* stream) {
#define CALL(T, D) launch_dq<T, D>(q, k, v, dout, lse, delta, dq, B, S, SL, H, KV, \
                                   causal, scale, (cudaStream_t)stream)
  STROM_DISPATCH_F32(CALL)
  return -1;
#undef CALL
}

int strom_fa_bwd_dkv(int dtype, int dh, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int B, int S,
                     int SL, int H, int KV, int causal, float scale, void* stream) {
#define CALL(T, D) launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, B, S, SL, \
                                    H, KV, causal, scale, (cudaStream_t)stream)
  STROM_DISPATCH_F32(CALL)
  return -1;
#undef CALL
}

const char* strom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
