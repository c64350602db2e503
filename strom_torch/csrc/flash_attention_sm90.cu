// Flash attention for Hopper (sm_90a) in bf16 on the tensor cores: the
// forward, the dK/dV backward and the dQ backward.
//
// Replaces, for bf16 inputs, the three Pallas TPU kernels of
// strom/ops/flash_attention.py:
//   fa_fwd_wgmma_kernel      <- _fa_kernel          :42  (launched by _flash_fwd)
//   fa_bwd_dkv_wgmma_kernel  <- _fa_bwd_dkv_kernel  :158 (launched by _flash_bwd)
//   fa_bwd_dq_wgmma_kernel   <- _fa_bwd_dq_kernel   :204 (launched by _flash_bwd)
// f32 inputs and bf16 heads above 256 take the scalar kernels of
// flash_attention.cu; the wrapper's route (kernel_route in
// strom_torch/ops/flash_attention.py) picks the library per kernel.
//
// What bounds them on an H100: attention at the main path's shape does
// ~Dh/2 = 64 multiply-adds per byte of q/k/v it reads once, far above the
// card's ~295 operations per byte, so all three kernels are bound by the
// bf16 tensor-core rate (989 TFLOP/s): at B 2, S 2048, H 32, Dh 128, causal,
// 0.07 ms for the forward (4*Dh flops per (q, kv) pair), 0.14 ms for dK/dV
// (8*Dh) and 0.10 ms for dQ (6*Dh). The design puts every product on the
// tensor cores and keeps them fed (FlashAttention-3's shape):
//   - warpgroups 0 and 1 consume (wgmma). In dQ and dK/dV up to DH 128,
//     one thread of a third warpgroup produces (TMA; 384 threads); in dQ
//     setmaxnreg moves registers from it (24) to the consumers (240), and
//     the producer returns, so the two roles never reconverge. The forward
//     at every width, and dK/dV and dQ at DH 256, have no producer group
//     (256 threads):
//     thread 0 issues each load while a tile's first wgmma runs, once the
//     stage it fills is free, and then the warp reconverges (__syncwarp)
//     before its next .aligned instruction. On an H100 (700 W) at B 2,
//     S 2048, H 32, KV 8, DH 128, a producer-free forward ran 4 % faster
//     than one with a producer, a producer-free dK/dV 15 % slower: thread 0
//     waits for the stage the slower warpgroup still holds, so the two
//     warpgroups run in lockstep;
//   - TMA loads each tile into 128-byte-swizzled shared memory, signalled on
//     an mbarrier; a ring of full/empty barriers (2 stages forward, 3 dK/dV
//     and dQ, 2 dK/dV at DH 256; dQ at DH 256: 3 one-tile slots, two for K
//     and one for V) lets the next tiles land while the current one is
//     multiplied;
//   - products are wgmma m64nNk16, bf16 x bf16 -> f32 in registers. Operands
//     read straight from the swizzled tiles are K-major (Q.K^T, K.Q^T, V.dO^T,
//     dO.V^T) or MN-major (the "transpose B" flag: V in P.V, dO in P^T.dO, Q
//     in dS^T.Q, K in dS.K). The bf16 A operand of P.V, P^T.dO, dS^T.Q and
//     dS.K is the f32 accumulator fragment rounded in registers: wgmma's A
//     register layout is its accumulator's, so P, dS and dS^T are never
//     written as bf16 tiles;
//   - the online softmax works on the accumulator fragment: a thread holds
//     two rows (lane/4 and lane/4 + 8 of its warp's 16), so row max and row
//     sum are two xor-shuffles among the 4 lanes of a row; exp2f with
//     scale*log2(e) folded into one multiply;
//   - rounding matches the JAX package: P to bf16 before P.V (:79) and before
//     dV (:185), dS to bf16 before dK (:194) and before dQ (:230), once, in
//     to_a_frag; lse, delta and every sum are f32;
//   - the causal skip is a loop bound; only the tiles the diagonal crosses
//     are masked.
//
// dQ (fa_bwd_dq_wgmma_kernel) has the forward's shape: one CTA per 128-row
// q tile whose two warpgroups own 64 rows each, Q and dO resident, K and V
// streamed. Its kv tiles are 64 rows, not the forward's 128, so that each
// warpgroup's S and dP accumulators are m64n64 (32 f32 registers each)
// beside dQ's 64 x Dh (Dh/2 registers); S = Q.K^T and dP = dO.V^T go out in
// one commit group. The diagonal of a 128-row q tile crosses two 64-row kv
// tiles (2qi and 2qi + 1), so both are masked elementwise; for warpgroup 0
// the second is wholly masked (P = 0) but still takes part in the
// warpgroup's wgmmas and in the ring's barriers. Each CTA owns its dQ rows:
// no atomics, no second pass, a deterministic result. dQ takes DH 64, 128
// and 256.
//
// At DH 256 (heads of 129-256, zero-padded) the forward streams 64-row kv
// tiles as dQ does, with dQ's masking of the two diagonal tiles: Q (64 KB)
// and two stages of K and V (128 KB) fit a block. P.V is one chain of
// m64n256k16, N 256 spanning V's four 64-column boxes. dK/dV keeps its
// design with a 2-stage ring and one P^T buffer. A consumer then holds a
// 128-register accumulator (O, dV or dK) beside a 32-register S or P tile
// and its 16-register bf16 fragment; both kernels spilled at the 168
// registers a 384-thread block gets, setmaxnreg notwithstanding. So at DH
// 256 dK/dV drops its producer warpgroup, as the forward does at every
// width (256 threads, up to 255 registers; ptxas gives the forward 199 and
// dK/dV 211, no spill). dQ at DH 256 keeps its shape with no producer
// either: Q and dO (128 KB) leave room for three 32 KB one-tile slots, not
// three 64 KB K+V stages (231,488 bytes in all; the sum is under
// DqLayout). Its consumer holds dQ's m64n256 accumulator (128 f32), S and
// dP (32 + 32) and dS's bf16 fragments (16): 208 before addresses, kept
// under 255 by writing dS over S, so dP dies before the four packs (ptxas
// gives it 218, no spill). dS.K is one m64n256k16 chain over K's four
// boxes, as P.V is in the forward.
//
// Where the trouble was, and what the code does about it:
//   - TMA descriptors: cuTensorMapEncodeTiled is reached through
//     cudaGetDriverEntryPoint(ByVersion) (no -lcuda). q/o/dO are seen as 3-D
//     [B][S][H*Dh] and k/v as [B][S][KV*Dh], so rows past S within one batch
//     are out of bounds and read as zeros. A 128-byte swizzle allows 128
//     bytes of inner box, so a Dh-128 tile is two 64-column boxes, each its
//     own [rows][64] region. Each map is a __grid_constant__ parameter.
//   - matching descriptors (sw128_desc): K-major operands have SBO = 1024
//     bytes (8 rows of 128 bytes); a k16 step inside a box advances the
//     start address by 32 bytes. MN-major operands have SBO = 1024 bytes
//     (8 k-rows) and LBO = the byte distance between two 64-column boxes; a
//     k16 step advances 16 rows (2048 bytes). Every tile base is 1024-byte
//     aligned, so the swizzle phase is that of the TMA write.
//   - accumulator layout (m64nN f32): register i of thread (warp w, lane l)
//     holds row 16w + l/4 + 8*((i/2)%2), column 8*(i/4) + 2*(l%4) + i%2.
//   - any S (the reference takes any S that its block divides, 63 or 96 or
//     192): the last q tile and the last kv tile may be cut by S. TMA
//     zero-fills every row past S. The tile the end of S crosses masks its
//     columns >= S (the forward: -inf before the row max; dK/dV and dQ:
//     P = 0, so dS = 0 too), and no row >= S is stored. lse and delta come
//     from the wrapper with rows of SL floats, SL = S rounded up to 64 (a
//     copy only where S % 64 != 0): the bulk copies need 16-byte-aligned
//     sources and must not read past the arrays. dQ also gives its rows
//     past S lse = +inf and delta = 0, so their P and dS are 0, not inf or
//     NaN.
//   - wgmma is asynchronous: after each wait the accumulators pass through
//     an empty asm (fence_regs), so no read of them moves above the wait.
//   - spills: one warpgroup holding dK, dV (128 f32 at Dh 128), S^T and dP^T
//     spilled under ptxas even with setmaxnreg 240, and its wgmmas were
//     serialised. dK/dV therefore splits the four products of a
//     tile between the two consumer warpgroups, one accumulator each, and
//     passes P^T between them in f32 through shared memory; no kernel here
//     spills (ptxas -v is printed by chip_smoke.py's build phase).
//   - load balance: the forward and dQ schedule the longest causal q tiles
//     first; the dK/dV grid starts at kv tile 0, which has the most causal
//     q tiles.
//   - a lost barrier: every mbarrier wait traps after 2^22 polls, so a fault
//     shows as a launch error instead of a hung card.
//
// Layouts are those of flash_attention.cu: q, o, dO, dq [B, S, H, Dh]; k, v,
// dk, dv [B, S, KV, Dh]; lse [B, H, S] f32 out of the forward, lse and delta
// [B, H, SL] f32 into the backward. Dh is 64, 128 or 256 for all three:
// the wrapper zero-pads a narrower head (exact: zero columns add nothing to
// Q.K^T and give zero output and gradient columns, which it slices off).

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Warpgroups 0 and 1 consume: they arrive on an "empty" barrier. dQ and
// dK/dV up to DH 128 add warpgroup 2, one thread of which loads; in the
// forward, and in dK/dV and dQ at DH 256, thread 0 loads (ptxas gives a 384-thread
// block 168 registers a thread, too few for DH 256's accumulators; a
// 256-thread block up to 255).
constexpr int CONSUMERS = 256;
constexpr int WITH_PRODUCER = 384;
template <int DH>
__host__ __device__ constexpr bool dkv_producer() { return DH <= 128; }
constexpr uint32_t ROW_BYTES = 128;  // one swizzled box row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. Every wait here is
// for work of the same CTA (microseconds); a wait that spins 2^22 times (some
// seconds) is a lost barrier, and traps (a launch error) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (c0 innermost) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of an operand that TMA wrote with a 128-byte swizzle.
// lbo, sbo in bytes; layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sw128_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t box_bytes) {
  return sw128_desc(addr, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragment of 16 columns (k16 step kk) as wgmma's A operand.
template <int N>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Column of accumulator register i within its tile (see the note above).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- wgmma
// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (the accumulator
// fragment layout, packed to bf16x2), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A from registers (the accumulator
// fragment layout, packed to bf16x2), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256]; A from registers (the accumulator
// fragment layout, packed to bf16x2), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- forward
// One CTA per (128-row q tile, q head, batch); warpgroup w owns q rows
// 64w..64w+63 of the tile. kv tiles of BK rows go through a 2-stage ring:
// 128 rows up to DH 128; 64 at DH 256, where Q (64 KB) and two stages of
// 128-row K and V tiles (256 KB) would not fit a block's 227 KB, and where
// each warpgroup's O (64 x 256 f32, 128 registers a thread) leaves room for
// an m64n64 S tile (32) beside it, not an m64n128 one.
template <int DH>
struct FwdLayout {
  static constexpr int NBOX = DH / 64;
  static constexpr int BK = DH > 128 ? 64 : 128;       // kv tile rows
  static constexpr uint32_t Q_BOX = 128 * ROW_BYTES;   // 128 rows x 64 columns
  static constexpr uint32_t KV_BOX = BK * ROW_BYTES;
  static constexpr uint32_t KV_TILE = NBOX * KV_BOX;   // one K or one V tile
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = NBOX * Q_BOX;
  static constexpr uint32_t V_OFF = K_OFF + 2 * KV_TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * KV_TILE;
  static constexpr uint32_t BYTES = BAR_OFF + 64 + 1024;  // + barriers, alignment
};

template <int DH>
__global__ void __launch_bounds__(CONSUMERS, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
                    int KV, int causal, float scale) {
  using L = FwdLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;  // + 8 * stage

  const int nq = (S + 127) / 128;
  const int qi = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * 128;
  // causal: kv tiles up to the diagonal, which crosses tile qi (BK 128) or
  // tiles 2qi and 2qi + 1 (BK 64)
  const int nk = (S + L::BK - 1) / L::BK;
  const int nkv = causal ? min((q0 + 128) / L::BK, nk) : nk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads, each by one thread: Q, and kv tile j into stage j & 1 once
  // the tile before in that stage is consumed
  auto load_q = [&]() {
    mbar_expect_tx(bar_q, L::NBOX * L::Q_BOX);
    for (int c = 0; c < L::NBOX; ++c)
      tma_load_3d(sQ + c * L::Q_BOX, &tm_q, bar_q, h * DH + 64 * c, q0, b);
  };
  auto load_kv = [&](int j) {
    const int s = j & 1;
    mbar_wait(bar_empty + 8 * s, ((j >> 1) & 1) ^ 1);
    mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_TILE);
    for (int c = 0; c < L::NBOX; ++c) {
      tma_load_3d(sK + s * L::KV_TILE + c * L::KV_BOX, &tm_k, bar_full + 8 * s,
                  kvh * DH + 64 * c, j * L::BK, b);
      tma_load_3d(sV + s * L::KV_TILE + c * L::KV_BOX, &tm_v, bar_full + 8 * s,
                  kvh * DH + 64 * c, j * L::BK, b);
    }
  };

  // consumers: S = Q.K^T, online softmax, O += P.V; thread 0 also loads
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    load_q();
    for (int j = 0; j < min(2, nkv); ++j) load_kv(j);
  }
  __syncwarp();  // warp 0 converged before its next .aligned wgmma
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows row0, row0 + 8
  const float c = scale * LOG2E;
  float acc[DH / 2];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < nkv; ++j) {
    const int s = j & 1;
    mbar_wait(bar_full + 8 * s, (j >> 1) & 1);
    const uint32_t tK = sK + s * L::KV_TILE, tV = sV + s * L::KV_TILE;

    float sc[L::BK / 2];  // S tile: 64 q rows x BK kv columns
    zero(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, kmajor(sQ + (kk / 4) * L::Q_BOX + wg * 64 * ROW_BYTES + (kk % 4) * 32),
               kmajor(tK + (kk / 4) * L::KV_BOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    // while S runs, tile j + 1 goes where tile j - 1 was
    if (threadIdx.x == 0 && j >= 1 && j + 1 < nkv) load_kv(j + 1);
    __syncwarp();
    wgmma_wait0();
    fence_regs(sc);

    // causal: only the tiles the diagonal crosses have kv > q (for
    // warpgroup 0 the second of two is wholly masked, P = 0); otherwise
    // only the last tile can hold kv rows past S
    const bool masked = causal ? (j + 1) * L::BK > q0 : (j + 1) * L::BK > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < L::BK / 2; ++i) {
      const int hf = (i / 2) % 2;
      float x = sc[i] * c;
      if (masked) {
        const int col = j * L::BK + frag_col(i, lane);
        if (causal ? col > row0 + 8 * hf : col >= S) x = -INFINITY;
      }
      sc[i] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
    float alpha[2], mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = quad_max(mx[hf]);
      mu[hf] = mn == -INFINITY ? 0.f : mn;  // a row masked so far stays all-zero
      alpha[hf] = exp2f(m[hf] - mu[hf]);
      m[hf] = mn;
    }
#pragma unroll
    for (int i = 0; i < L::BK / 2; ++i) {
      const int hf = (i / 2) % 2;
      const float p = exp2f(sc[i] - mu[hf]);
      sc[i] = p;
      rs[hf] += p;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];  // per-thread part
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += bf16(P).V: m64nDHk16, DH 256 being wgmma's widest N; V is the
    // MN-major B operand across NBOX 64-column boxes KV_BOX apart
    uint32_t pa[L::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk) to_a_frag(pa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk)
      wgmma_rs(acc, pa[kk], mnmajor(tV + kk * 16 * ROW_BYTES, L::KV_BOX));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    const float denom = fmaxf(quad_sum(l[hf]), 1e-30f);
    if (row < S) {
      __nv_bfloat16* orow = o + ((long)b * S + row) * H * DH + (long)h * DH;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + jj * 8 + (lane % 4) * 2) =
            pack_bf16(acc[4 * jj + 2 * hf] / denom, acc[4 * jj + 2 * hf + 1] / denom);
      if (lane % 4 == 0) lse[((long)b * H + h) * S + row] = m[hf] * LN2 + logf(denom);
    }
  }
}

// ------------------------------------------------------- backward dK/dV
// Warpgroup 0's P^T = exp(S^T*scale - lse), into sc and the hand-over
// buffer. MASKED: P^T = 0 above the diagonal (causal) and in q columns >= S;
// instantiated with MASKED false for every other tile, which then carries
// no mask arithmetic at all.
template <bool MASKED>
__device__ __forceinline__ void dkv_p(float (&sc)[32], float* pbuf, const float* lse_s,
                                      float c, int lane, int q0, int kv_row, int causal,
                                      int S) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = frag_col(i, lane);
    float p = exp2f(sc[i] * c - lse_s[col] * LOG2E);
    if (MASKED && ((causal && q0 + col < kv_row + 8 * ((i / 2) % 2)) || q0 + col >= S))
      p = 0.f;
    sc[i] = p;
    pbuf[i * 128] = p;
  }
}

// One CTA per (64-row kv tile, kv head, batch). K and V stay resident; the
// CTA loops over the G group heads and the causal q tiles (64 rows), whose
// Q, dO, lse and delta go through a STAGES-stage TMA ring. The sum the TPU grid
// carried stays in the CTA's registers: no atomics, no second pass.
// The two consumer warpgroups split the four products of a tile two and two,
// so each holds one 64 x Dh accumulator:
//   warpgroup 0: S^T = K.Q^T, P^T = exp(S^T*scale - lse), dV += bf16(P^T).dO
//   warpgroup 1: dP^T = V.dO^T, dS^T = P^T o (dP^T - delta)*scale,
//                dK += bf16(dS^T).Q
// P^T passes from 0 to 1 in f32 through shared memory, in the accumulator's
// fragment order (thread t of one warpgroup writes what thread t of the other
// reads), in PBUFS buffers behind their own full/empty mbarriers.
// Up to DH 128: 3 stages, 2 P buffers. At DH 256 a stage is 65 KB, so the
// ring has 2 stages and P^T one buffer (216 KB in all; two buffers would
// make 232,576 bytes, 128 over a block's limit), and the block has no
// producer warpgroup (thread 0 loads), as the forward has none.

template <int DH>
struct DkvLayout {
  static constexpr int NBOX = DH / 64;
  static constexpr int STAGES = DH > 128 ? 2 : 3;
  static constexpr int PBUFS = DH > 128 ? 1 : 2;
  static constexpr uint32_t BOX = 64 * ROW_BYTES;  // 64 rows x 64 columns
  static constexpr uint32_t TILE = NBOX * BOX;     // one K, V, Q or dO tile
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = TILE;
  static constexpr uint32_t ST_OFF = 2 * TILE;
  // a stage: Q tile, dO tile, 64 lse, 64 delta; 1024-byte aligned
  static constexpr uint32_t LSE_OFF = 2 * TILE, DLT_OFF = LSE_OFF + 256;
  static constexpr uint32_t STAGE = 2 * TILE + 1024;
  static constexpr uint32_t P_OFF = ST_OFF + STAGES * STAGE;  // PBUFS x [32][128] f32
  static constexpr uint32_t P_BUF = 32 * 128 * 4;
  static constexpr uint32_t BAR_OFF = P_OFF + PBUFS * P_BUF;
  static constexpr uint32_t BYTES = BAR_OFF + 128 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(dkv_producer<DH>() ? WITH_PRODUCER : CONSUMERS, 1)
fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int S, int SL, int H, int KV, int causal, float scale) {
  using L = DkvLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF, sSt = base + L::ST_OFF;
  // barriers, 8 bytes each: kv, full[STAGES], empty[STAGES], p_full[PBUFS],
  // p_empty[PBUFS]
  const uint32_t bar_kv = base + L::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * L::STAGES;
  const uint32_t bar_pfull = bar_empty + 8 * L::STAGES, bar_pempty = bar_pfull + 8 * L::PBUFS;

  const int kj = blockIdx.x;  // small kj has the most causal q tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int nq = (S + 63) / 64;
  const int i0 = causal ? kj : 0;  // first q tile that sees this kv tile
  const int nqt = nq - i0;
  const int ntiles = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < L::PBUFS; ++s) {
      mbar_init(bar_pfull + 8 * s, 128);
      mbar_init(bar_pempty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads, each by one thread: K and V, and the Q, dO, lse and delta of
  // tile t into stage t % STAGES once the tile before in that stage is
  // consumed
  auto load_kv = [&]() {
    mbar_expect_tx(bar_kv, 2 * L::TILE);
    for (int c = 0; c < L::NBOX; ++c) {
      tma_load_3d(sK + c * L::BOX, &tm_k, bar_kv, kvh * DH + 64 * c, kj * 64, b);
      tma_load_3d(sV + c * L::BOX, &tm_v, bar_kv, kvh * DH + 64 * c, kj * 64, b);
    }
  };
  auto load_stage = [&](int t) {
    const int s = t % L::STAGES;
    const int h = kvh * G + t / nqt, qi = i0 + t % nqt;
    const uint32_t st = sSt + s * L::STAGE, full = bar_full + 8 * s;
    const long row = ((long)b * H + h) * SL + (long)qi * 64;
    mbar_wait(bar_empty + 8 * s, ((t / L::STAGES) & 1) ^ 1);
    mbar_expect_tx(full, 2 * L::TILE + 512);
    for (int c = 0; c < L::NBOX; ++c) {
      tma_load_3d(st + c * L::BOX, &tm_q, full, h * DH + 64 * c, qi * 64, b);
      tma_load_3d(st + L::TILE + c * L::BOX, &tm_do, full, h * DH + 64 * c, qi * 64, b);
    }
    bulk_load(st + L::LSE_OFF, lse + row, 256, full);
    bulk_load(st + L::DLT_OFF, delta + row, 256, full);
  };

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  if (dkv_producer<DH>() && wg == 2) {
    // ---------------- producer: one thread issues every load
    if (threadIdx.x == 256) {
      load_kv();
      for (int t = 0; t < ntiles; ++t) load_stage(t);
    }
    return;
  }

  // ---------------- consumers
  if constexpr (!dkv_producer<DH>()) {
    if (threadIdx.x == 0) {
      load_kv();
      for (int t = 0; t < min(L::STAGES, ntiles); ++t) load_stage(t);
    }
    __syncwarp();  // warp 0 converged before its next .aligned wgmma
  }
  const int kv_row = kj * 64 + warp * 16 + lane / 4;  // rows kv_row, kv_row + 8
  const float c = scale * LOG2E;
  float acc[DH / 2];  // warpgroup 0: dV; warpgroup 1: dK
  zero(acc);
  mbar_wait(bar_kv, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::STAGES, pb = t % L::PBUFS;  // ring stage, P buffer
    const uint32_t pphase = (t / L::PBUFS) & 1;
    const int qi = i0 + t % nqt;
    const uint32_t tQ = sSt + s * L::STAGE, tG = tQ + L::TILE;
    const float* lse_s = reinterpret_cast<const float*>(gbase + L::ST_OFF + s * L::STAGE +
                                                        L::LSE_OFF);
    const float* dlt_s = lse_s + 64;
    float* pbuf = reinterpret_cast<float*>(gbase + L::P_OFF + pb * L::P_BUF) + tid;
    mbar_wait(bar_full + 8 * s, (t / L::STAGES) & 1);

    float sc[32];  // S^T or dP^T: 64 kv rows x 64 q columns
    zero(sc);
    const uint32_t a = wg == 0 ? sK : sV, bt = wg == 0 ? tQ : tG;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, kmajor(a + (kk / 4) * L::BOX + (kk % 4) * 32),
               kmajor(bt + (kk / 4) * L::BOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    // no producer: while S^T runs, tile t + STAGES - 1 goes where tile t - 1 was
    if constexpr (!dkv_producer<DH>()) {
      if (threadIdx.x == 0 && t >= 1 && t + L::STAGES - 1 < ntiles) load_stage(t + L::STAGES - 1);
      __syncwarp();
    }
    wgmma_wait0();
    fence_regs(sc);

    if (wg == 0) {
      // P^T = exp(S^T*scale - lse), zero above the diagonal and in the q
      // columns past S; hand it over
      mbar_wait(bar_pempty + 8 * pb, pphase ^ 1);
      if ((causal && qi == kj) || (qi + 1) * 64 > S)
        dkv_p<true>(sc, pbuf, lse_s, c, lane, qi * 64, kv_row, causal, S);
      else
        dkv_p<false>(sc, pbuf, lse_s, c, lane, qi * 64, kv_row, causal, S);
      mbar_arrive(bar_pfull + 8 * pb);
    } else {
      // dS^T = P^T o (dP^T - delta) * scale
      mbar_wait(bar_pfull + 8 * pb, pphase);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = pbuf[i * 128] * (sc[i] - dlt_s[frag_col(i, lane)]) * scale;
      mbar_arrive(bar_pempty + 8 * pb);
    }

    // dV += bf16(P^T).dO, or dK += bf16(dS^T).Q
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a_frag(fa[kk], sc, kk);
    const uint32_t bm = wg == 0 ? tG : tQ;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, fa[kk], mnmajor(bm + kk * 16 * ROW_BYTES, L::BOX));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (kv_row + 8 * hf >= S) continue;
    const long off = ((long)b * S + kv_row + 8 * hf) * KV * DH + (long)kvh * DH;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<uint32_t*>(out + off + jj * 8 + (lane % 4) * 2) =
          pack_bf16(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
  }
}

// ----------------------------------------------------------- backward dQ
// One CTA per (128-row q tile, q head, batch), longest causal rows first;
// warpgroup w owns q rows 64w..64w+63 of the tile. Q, dO, lse and delta of
// the tile stay resident; K and V tiles of 64 kv rows stream in by TMA. Per
// kv tile, each consumer warpgroup computes
//   S = Q.K^T and dP = dO.V^T (one commit group),
//   P = exp(S*scale - lse), dS = P o (dP - delta)*scale, rounded to bf16,
//   dQ += bf16(dS).K
// with its 64 x Dh f32 dQ in registers.
// Up to DH 128 a producer warpgroup streams K and V together through a
// DQ_STAGES-stage ring (384 threads). At DH 256 one K+V stage is 64 KB and
// Q with dO take 128 KB, so three stages would make 320 KB. There the ring
// holds DQ_STAGES slots of 32 KB, one tile each: K_j in slot j & 1
// (double-buffered: K_j serves both S and dS.K, so it lives the whole tile)
// and V_j in slot 2, released as soon as dP is done. Thread 0 issues every
// load (256 threads, as the forward): K_{j+1} while S_j runs, V_{j+1} while
// dS_j.K_j runs, so V lands a product ahead and K a tile ahead. Bytes at
// DH 256: Q 65,536 + dO 65,536 + 3 x 32,768 + lse and delta 1,024 +
// 7 barriers (64) + 1,024 alignment = 231,488 of a block's 232,448.
constexpr int DQ_STAGES = 3;  // ring stages (up to DH 128), or slots (DH 256)
template <int DH>
__host__ __device__ constexpr bool dq_producer() { return DH <= 128; }

template <int DH>
struct DqLayout {
  static constexpr int NBOX = DH / 64;
  static constexpr uint32_t Q_BOX = 128 * ROW_BYTES;   // 128 rows x 64 columns
  static constexpr uint32_t KV_BOX = 64 * ROW_BYTES;   // 64 rows x 64 columns
  static constexpr uint32_t KV_TILE = NBOX * KV_BOX;   // one K or one V tile
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t G_OFF = NBOX * Q_BOX;      // dO
  static constexpr uint32_t RING_OFF = 2 * NBOX * Q_BOX;
  // a stage: K tile, then V tile; a slot (DH 256): one tile
  static constexpr uint32_t STAGE = dq_producer<DH>() ? 2 * KV_TILE : KV_TILE;
  static constexpr uint32_t LSE_OFF = RING_OFF + DQ_STAGES * STAGE;  // 128 f32
  static constexpr uint32_t DLT_OFF = LSE_OFF + 512;                 // 128 f32
  static constexpr uint32_t BAR_OFF = DLT_OFF + 512;
  static constexpr uint32_t BYTES = BAR_OFF + 64 + 1024;  // + barriers, alignment
  static_assert(BYTES <= 232448, "dQ's layout exceeds a block's shared memory");
};

template <int DH>
__global__ void __launch_bounds__(dq_producer<DH>() ? WITH_PRODUCER : CONSUMERS, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int SL, int H, int KV,
                       int causal, float scale) {
  using L = DqLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t sQ = base + L::Q_OFF, sG = base + L::G_OFF, sRing = base + L::RING_OFF;
  // barriers, 8 bytes each: q, full[DQ_STAGES], empty[DQ_STAGES] (one pair
  // per stage, or per slot)
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * DQ_STAGES;

  const int nq = (S + 127) / 128;
  const int qi = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * 128;
  const int rows = min(128, S - q0);     // rows of this tile below S
  const int lrows = min(128, SL - q0);  // lse/delta values loaded: 64 or 128
  // causal: kv tiles up to the diagonal, which crosses tiles 2qi and 2qi + 1
  const int nk = (S + 63) / 64;
  const int nkv = causal ? min(2 * qi + 2, nk) : nk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads, each by one thread: Q, dO, lse and delta; at DH 256 K_j into
  // slot j & 1 and V_j into slot 2, each once the tile before in its slot
  // is consumed
  auto load_q = [&]() {
    const long row = ((long)b * H + h) * SL + q0;
    mbar_expect_tx(bar_q, 2 * L::NBOX * L::Q_BOX + 8 * lrows);
    for (int c = 0; c < L::NBOX; ++c) {
      tma_load_3d(sQ + c * L::Q_BOX, &tm_q, bar_q, h * DH + 64 * c, q0, b);
      tma_load_3d(sG + c * L::Q_BOX, &tm_do, bar_q, h * DH + 64 * c, q0, b);
    }
    bulk_load(base + L::LSE_OFF, lse + row, 4 * lrows, bar_q);
    bulk_load(base + L::DLT_OFF, delta + row, 4 * lrows, bar_q);
  };
  auto load_slot = [&](int s, uint32_t phase, const CUtensorMap* map, int j) {
    const uint32_t full = bar_full + 8 * s;
    mbar_wait(bar_empty + 8 * s, phase ^ 1);
    mbar_expect_tx(full, L::KV_TILE);
    for (int c = 0; c < L::NBOX; ++c)
      tma_load_3d(sRing + s * L::STAGE + c * L::KV_BOX, map, full, kvh * DH + 64 * c,
                  j * 64, b);
  };
  auto load_k = [&](int j) { load_slot(j & 1, (j >> 1) & 1, &tm_k, j); };
  auto load_v = [&](int j) { load_slot(2, j & 1, &tm_v, j); };

  const int wg = threadIdx.x / 128;
  if constexpr (dq_producer<DH>()) {
    if (wg == 2) {
      // ---------------- producer: one thread issues every load
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
      if (threadIdx.x == 256) {
        load_q();
        for (int j = 0; j < nkv; ++j) {
          const int s = j % DQ_STAGES;
          const uint32_t st = sRing + s * L::STAGE, full = bar_full + 8 * s;
          mbar_wait(bar_empty + 8 * s, ((j / DQ_STAGES) & 1) ^ 1);
          mbar_expect_tx(full, L::STAGE);
          for (int c = 0; c < L::NBOX; ++c) {
            tma_load_3d(st + c * L::KV_BOX, &tm_k, full, kvh * DH + 64 * c, j * 64, b);
            tma_load_3d(st + L::KV_TILE + c * L::KV_BOX, &tm_v, full, kvh * DH + 64 * c,
                        j * 64, b);
          }
        }
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  } else {
    if (threadIdx.x == 0) {
      load_q();
      load_k(0);
      load_v(0);
      if (nkv > 1) load_k(1);
    }
    __syncwarp();  // warp 0 converged before its next .aligned wgmma
  }

  // ---------------- consumers
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r = wg * 64 + warp * 16 + lane / 4;  // rows r, r + 8 of the tile
  const float c = scale * LOG2E;
  float acc[DH / 2];  // dQ: 64 q rows x Dh
  zero(acc);

  mbar_wait(bar_q, 0);
  const float* lse_s = reinterpret_cast<const float*>(gbase + L::LSE_OFF);
  const float* dlt_s = reinterpret_cast<const float*>(gbase + L::DLT_OFF);
  // a row past S (zeros from TMA, no lse or delta loaded) gets P = 0, dS = 0;
  // lim: the last kv column each of the thread's two rows sees (the
  // diagonal, causal, and the end of S), so a masked tile tests one bound
  float lse2[2], dlt[2];
  int lim[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool in = r + 8 * hf < rows;
    lse2[hf] = in ? lse_s[r + 8 * hf] * LOG2E : INFINITY;
    dlt[hf] = in ? dlt_s[r + 8 * hf] : 0.f;
    lim[hf] = causal ? min(q0 + r + 8 * hf, S - 1) : S - 1;
  }

  for (int j = 0; j < nkv; ++j) {
    // K_j's stage (K and V together) or slot, and the phase of its barriers
    const int ks = dq_producer<DH>() ? j % DQ_STAGES : j & 1;
    const uint32_t phase = dq_producer<DH>() ? (j / DQ_STAGES) & 1 : (j >> 1) & 1;
    const uint32_t tK = sRing + ks * L::STAGE;
    const uint32_t tV = dq_producer<DH>() ? tK + L::KV_TILE : sRing + 2 * L::STAGE;
    mbar_wait(bar_full + 8 * ks, phase);

    float sc[32], dp[32];  // S and dP: 64 q rows x 64 kv columns
    zero(sc);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, kmajor(sQ + (kk / 4) * L::Q_BOX + wg * 64 * ROW_BYTES + (kk % 4) * 32),
               kmajor(tK + (kk / 4) * L::KV_BOX + (kk % 4) * 32), kk > 0);
    if constexpr (!dq_producer<DH>()) {
      // while S runs, K_{j+1} goes where K_{j-1} was; then V_j must be in.
      // Without the fence after the wait ptxas puts its own in the
      // divergent load path and serialises every wgmma (C7520; 30 % slower
      // on an H100 at Gemma-2-9B's shape)
      if (threadIdx.x == 0 && j >= 1 && j + 1 < nkv) load_k(j + 1);
      __syncwarp();
      mbar_wait(bar_full + 8 * 2, j & 1);
      wgmma_fence();
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dp, kmajor(sG + (kk / 4) * L::Q_BOX + wg * 64 * ROW_BYTES + (kk % 4) * 32),
               kmajor(tV + (kk / 4) * L::KV_BOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    if constexpr (!dq_producer<DH>()) mbar_arrive(bar_empty + 8 * 2);  // V_j is done

    // P = exp(S*scale - lse), zero above the diagonal and in the kv
    // columns past S; dS = P o (dP - delta)*scale, in place of S
    const bool masked = (causal && j >= 2 * qi) || (j + 1) * 64 > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i / 2) % 2;
      float p = exp2f(sc[i] * c - lse2[hf]);
      if (masked && j * 64 + frag_col(i, lane) > lim[hf]) p = 0.f;
      sc[i] = p * (dp[i] - dlt[hf]) * scale;
    }

    // dQ += bf16(dS).K: m64nDHk16, K the MN-major B operand across NBOX
    // 64-column boxes KV_BOX apart
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a_frag(fa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, fa[kk], mnmajor(tK + kk * 16 * ROW_BYTES, L::KV_BOX));
    wgmma_commit();
    if constexpr (!dq_producer<DH>()) {
      // while dS.K runs, V_{j+1} goes where V_j was
      if (threadIdx.x == 0 && j + 1 < nkv) load_v(j + 1);
      __syncwarp();
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * ks);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r + 8 * hf;
    if (row < S) {
      __nv_bfloat16* drow = dq + ((long)b * S + row) * H * DH + (long)h * DH;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj)
        *reinterpret_cast<uint32_t*>(drow + jj * 8 + (lane % 4) * 2) =
            pack_bf16(acc[4 * jj + 2 * hf], acc[4 * jj + 2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// head width with no layout here: the forward, dK/dV and dQ take 64, 128
// and 256 (the wrapper pads a head to one of these, and sends every other
// width to flash_attention.cu)
constexpr int ERR_UNSUPPORTED = -1;
constexpr int ERR_NO_ENCODER = -2;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = -3;   // the driver refused a tensor map

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 [B][S][width] tensor as a 3-D tensor map, boxes of 64 columns
// (128 bytes, 128-byte swizzle) x box_rows rows x 1 batch. Rows past S are
// out of bounds and read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int width, int box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)S * width * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int S, int H, int KV, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc;
  constexpr int BK = FwdLayout<DH>::BK;
  if ((rc = make_map(&mq, q, B, S, H * DH, 128)) || (rc = make_map(&mk, k, B, S, KV * DH, BK)) ||
      (rc = make_map(&mv, v, B, S, KV * DH, BK)))
    return rc;
  const int smem = FwdLayout<DH>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_wgmma_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fa_fwd_wgmma_kernel<DH><<<dim3((S + 127) / 128, H, B), CONSUMERS, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, int S, int SL,
               int H, int KV, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int rc;
  if ((rc = make_map(&mq, q, B, S, H * DH, 64)) || (rc = make_map(&mg, dout, B, S, H * DH, 64)) ||
      (rc = make_map(&mk, k, B, S, KV * DH, 64)) || (rc = make_map(&mv, v, B, S, KV * DH, 64)))
    return rc;
  const int smem = DkvLayout<DH>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkv_wgmma_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkv_wgmma_kernel<DH><<<dim3((S + 63) / 64, KV, B),
                                dkv_producer<DH>() ? WITH_PRODUCER : CONSUMERS, smem, stream>>>(
      mq, mk, mv, mg, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, SL, H, KV,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S, int SL, int H,
              int KV, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int rc;
  if ((rc = make_map(&mq, q, B, S, H * DH, 128)) ||
      (rc = make_map(&mg, dout, B, S, H * DH, 128)) ||
      (rc = make_map(&mk, k, B, S, KV * DH, 64)) || (rc = make_map(&mv, v, B, S, KV * DH, 64)))
    return rc;
  const int smem = DqLayout<DH>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq_wgmma_kernel<DH><<<dim3((S + 127) / 128, H, B),
                               dq_producer<DH>() ? WITH_PRODUCER : CONSUMERS, smem, stream>>>(
      mq, mk, mv, mg, lse, delta, (__nv_bfloat16*)dq, S, SL, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes; bf16 tensors only, dh 64, 128 or 256 for
// every kernel; SL, the row length of lse and delta in the backward, a
// multiple of 64 and >= S.
// Returns 0 when the kernel was launched, a cudaError_t, or a negative ERR_
// code.
extern "C" {

int strom_fa_fwd_sm90(int dh, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int H, int KV, int causal, float scale,
                      void* stream) {
  if (dh == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, S, H, KV, causal, scale, (cudaStream_t)stream);
  if (dh == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, S, H, KV, causal, scale, (cudaStream_t)stream);
  if (dh == 256)
    return launch_fwd<256>(q, k, v, o, lse, B, S, H, KV, causal, scale, (cudaStream_t)stream);
  return ERR_UNSUPPORTED;
}

int strom_fa_bwd_dkv_sm90(int dh, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta, void* dk,
                          void* dv, int B, int S, int SL, int H, int KV, int causal,
                          float scale, void* stream) {
  if (dh == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, SL, H, KV, causal, scale,
                          (cudaStream_t)stream);
  if (dh == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, SL, H, KV, causal,
                           scale, (cudaStream_t)stream);
  if (dh == 256)
    return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, B, S, SL, H, KV, causal,
                           scale, (cudaStream_t)stream);
  return ERR_UNSUPPORTED;
}

int strom_fa_bwd_dq_sm90(int dh, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         int B, int S, int SL, int H, int KV, int causal, float scale,
                         void* stream) {
  if (dh == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, SL, H, KV, causal, scale,
                         (cudaStream_t)stream);
  if (dh == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, SL, H, KV, causal, scale,
                          (cudaStream_t)stream);
  if (dh == 256)
    return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, S, SL, H, KV, causal, scale,
                          (cudaStream_t)stream);
  return ERR_UNSUPPORTED;
}

}  // extern "C"
