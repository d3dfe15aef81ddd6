// Fourier attention's matmul chain on Hopper (sm_90a), on the tensor cores
// (wgmma): the body that fourier_chain.cu (float32 A, B, C),
// fourier_chain_bf16.cu (bf16 A, B, C) and fourier_chain_mixed.cu (one float32
// operand beside two bf16 ones) instantiate.
//
// Replaces: ops/pallas/fourier.py of the JAX package, _tiled_abc ->
//   _matmul_chain_kernel, for every mix of operand types its forward and the
//   three sweeps of _fourier_bwd give it.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m cast_C(A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// in float32, the score tile complete over d before cast_C, without storing
// the R x M score matrix.  cast_C is _matmul_chain_kernel's s.astype(c.dtype):
// the identity for a float32 C, round to nearest-even bf16 for a bf16 C (not
// truncation: that would be another result).  The caller scales the result.
//
// Operands on the tensor cores.  A bf16 operand is one bf16 part.  A float32
// value x is cut into three bf16 parts whose sum is x exactly (hi: x with its
// low 16 bits cleared; mid: the same of x - hi; lo: what is left, at most 8
// significant bits), so a float32 operand is never rounded.  A product runs
// the part products i j with i + j < 3: one pass for two bf16 operands, three
// for one float32 operand, six for two (down to about 2^-22 of the largest);
// each part product is exact in float32 and they are summed in float32.  With
// a float32 C the float32 score tile is split in the same way, in registers.
//
// The tensor cores drop the low bits of their float32 sums (they do not round
// to nearest), which adds up over long sums.  Where kFresh is set the second
// product is summed into fresh fragments for each step of TM middle rows and
// added into the running float32 sum with ordinary adds; otherwise the
// tensor cores keep one sum over all of M.
//
// What the design does:
//  * layout_kernel, a prologue of the same call, reads B and C where they lie
//    (unpadded rows of d and d_out columns) and writes their parts into a
//    workspace, each step's tile whole: B per 8 columns, C transposed per 8
//    rows, zero past M, d and d_out, K-major core matrices of 8 rows x 16
//    bytes without swizzle; with a tail, everything of a step together;
//  * grid (ceil(R / 128), BH) of two warpgroups, 64 output rows each, one CTA
//    per SM; a thread loads its A fragments once (a float32 A split into its
//    parts) and keeps them in registers;
//  * each step of TM middle rows: thread 0 copies the step's part tiles with
//    cp.async.bulk into a ring of stages, counted in bytes on a `full`
//    mbarrier; s = A_r B_m^T is wgmma.m64n(TM)k16 with A from registers and B
//    from shared memory; the float32 score tile becomes, in registers, the A
//    fragments of cast_C(s) C_m (the accumulator layout of two neighbouring
//    8-column tiles is the A-fragment layout of one 16-column tile), a
//    wgmma.m64n(W)k16 with C from shared memory.  Each warpgroup waits only
//    for its stage's bytes and releases the stage on an `empty` mbarrier;
//    thread 0 refills the stage of the step before the current one, so one
//    warpgroup may run a step ahead of the other;
//  * the running sums stay in registers, or, where they would spill, in
//    shared memory, one slot per thread;
//  * the tail (kTailMax > 0, the float32 chain): where the wider of d and
//    d_out is 16 T + U with T >= 1 and 1 <= U <= kTailMax, the tiles are
//    W = 16 T wide and the U columns past them are summed in float32 on the
//    CUDA cores instead of padding the tiles to 16 (T + 1).  The prologue
//    writes B's and C's tail columns as float32 after the step's part tiles,
//    and lays each step's tiles and tails out together, so that one bulk
//    copy fills a stage (two more small copies a stage, the tails apart,
//    cost more than the 16 columns saved: 2.14 against 2.04 ms at (8, 8192,
//    97), and 1.74 ms as one copy).  A thread loads its rows' tail of A
//    once.  Each step it sums a[r, tail] b[m, tail] for its score elements
//    while the tensor cores run the first product and adds them to the score
//    tile (kept apart from the accumulator, which only wgmma writes), so the
//    score is complete over d before it is split; while the tensor cores run
//    the second product it sums s[r, m] c[m, tail] for its rows from the
//    unsplit float32 score.  After the last step the four lanes that share a
//    row add their sums by shuffles in a fixed order (no atomics: bit-equal
//    run to run).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chain {

constexpr int kThreads = 256;   // two warpgroups of 64 output rows
constexpr int kTR = 128;        // output rows per CTA
constexpr int kSmem = 232448;   // shared memory one CTA may use
// values a thread may hold across a step before its running sums go to shared
// memory (the float32 chain holds 236 in 239 registers at W = 112 without a
// tail, 212 in 237 at W = 96 with a tail of one column, the dQ sweep 244 in
// 232)
constexpr int kRegisters = 248;

// parts of an operand stored as X: three for float32, one for bf16 (uint16_t)
template <typename X>
constexpr int kParts = sizeof(X) == 4 ? 3 : 1;

// U: the tail, columns past the tiles summed in float32 (0: none)
template <int T, int TM, int NA, int NB, int NC, bool kFresh, int U = 0>
struct Tile {
  static constexpr int W = 16 * T;              // padded d and d_out, or their whole blocks
  static constexpr int NS = NC == 3 ? 3 : 1;    // parts of the score tile
  static constexpr int kTile = TM * W;          // bf16 elements of one part tile
  static constexpr int kStage = (NB + NC) * kTile;
  static constexpr int kTail = TM * U;          // float32 tail values of B, and of C, a step
  static constexpr int kStageBytes = kStage * 2 + 2 * kTail * 4;
  // A's parts, the score tile and its parts, the running sums and the fresh
  // ones, A's tail and the tail's sums
  static constexpr int kHeld =
      NA * T * 4 + TM / 2 + NS * TM / 4 + (kFresh ? W : W / 2) + 4 * U;
  static constexpr bool kSumsInRegisters = kHeld <= kRegisters;
  static_assert(kFresh || kSumsInRegisters, "a tensor-core sum stays in registers");
  static constexpr int kSumBytes = kSumsInRegisters ? 0 : kTR * W * 4;
  static constexpr int kFit = (kSmem - 1024 - kSumBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two stages of shared memory");
  static constexpr int bytes = kStages * kStageBytes + kSumBytes;
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits for the phase of `parity` to complete; traps (and the launch fails)
// rather than hang if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 26)) __trap();
  }
}
// bytes (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_registers(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The descriptor of a K-major bf16 operand in shared memory without swizzle:
// core matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo`
// bytes apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x N, float32) = d + a b, or a b where `accumulate` is 0; the layouts
// of d and a in a warp are those of mma.m16n8k16 (warp w of the warpgroup
// holds rows 16 w .. 16 w + 15)
template <int N>
__device__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int accumulate);

// d (64 x 16, float32, 8 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 16, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32, float32, 16 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 32, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 48, float32, 24 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 48, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32, 32 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 64, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 80, float32, 40 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 80, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 96, float32, 48 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 96, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 112, float32, 56 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 112, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[56], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32, 64 a thread) = or += a (64 x 16, bf16, registers) *
// b (16 x 128, bf16, shared memory, descriptor)
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// a stored value as float32: bf16 is held as its 16 bits (uint16_t)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// x = part[0] + part[1] + part[2] exactly, each part a bf16 value held in a
// float32 (its low 16 bits zero): hi keeps x's top 8 significand bits, mid
// the next 8 of the rest, lo the remaining ones (at most 8).  Below 2^-110
// lo may hold bits under bf16's least subnormal, 2^-133, which `pack` drops.
// A bf16 x is its own hi; mid and lo are zero.
__device__ __forceinline__ void split3(float x, float (&part)[3]) {
  part[0] = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r = x - part[0];
  part[1] = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  part[2] = r - part[1];
}

// the 2 U float32 values at p (8 U-byte aligned) in one shared-memory load
template <int U>
__device__ __forceinline__ void load_pairs(const float* p, float (&v)[2 * U]) {
  static_assert(U == 1 || U == 2, "tails of one or two columns");
  if constexpr (U == 1) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
}

// the bf16 values held by two float32 as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// two float32 rounded to nearest-even bf16 as a pair, the first in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The parts of B and C in the layouts the chain copies whole: B's tile of a
// step as [W / 8][TM][8] (per 8 columns), C's transposed as [TM / 8][W][8]
// (per 8 rows, every column); zero past M, d and d_out.  Without a tail, part
// q of every step lies together, [q][bh][Mt / TM][tile], C's parts after B's.
// With a tail of U columns, everything of a step lies together, so that one
// bulk copy carries it: [bh][Mt / TM][B's parts, C's parts, B's tail, C's
// tail], each tail the float32 values of columns W .. W + U - 1 as [TM][U].
// blockIdx.y: 0 for B, 1 for C; blockIdx.z: bh.  A thread lays out 8 values
// of every part, or the tail of one row.
template <int TM, typename TB, typename TC, int U = 0>
__global__ void layout_kernel(const TB* __restrict__ b, const TC* __restrict__ c,
                              uint16_t* __restrict__ parts, int M, int Mt, int d, int d_out,
                              int W) {
  constexpr int NB = kParts<TB>, NC = kParts<TC>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int tiles = Mt * (W / 8);
  if (i >= tiles + (U > 0 ? Mt : 0)) return;
  const int bh = blockIdx.z, tile = TM * W;
  const size_t part = (size_t)gridDim.z * Mt * W;
  // where part q's tile of step k starts
  const size_t step = (size_t)(NB + NC) * tile + 4 * TM * U;
  auto tile_at = [&](int k, int q) -> size_t {
    if constexpr (U > 0) return ((size_t)bh * (Mt / TM) + k) * step + (size_t)q * tile;
    else return q * part + ((size_t)bh * Mt + (size_t)k * TM) * W;
  };
  if constexpr (U > 0) {
    if (i >= tiles) {
      const int m = i - tiles, y = blockIdx.y;
      float* tail = reinterpret_cast<float*>(parts + tile_at(m / TM, NB + NC)) +
                    (y * TM + m % TM) * U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int col = W + u;
        float x = 0.f;
        if (m < M && y == 0 && col < d) x = to_float(b[((size_t)bh * M + m) * d + col]);
        if (m < M && y == 1 && col < d_out) x = to_float(c[((size_t)bh * M + m) * d_out + col]);
        tail[u] = x;
      }
      return;
    }
  }
  float x[8];
  size_t at;   // part 0's element, part q's lies q parts further
  int n, q0;   // parts of this operand, and the first one's index
  if (blockIdx.y == 0) {
    const int m = i % Mt, s = i / Mt;
    const TB* row = b + ((size_t)bh * M + m) * d;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = (m < M && 8 * s + u < d) ? to_float(row[8 * s + u]) : 0.f;
    at = tile_at(m / TM, 0) + ((size_t)s * TM + m % TM) * 8;
    n = NB;
    q0 = 0;
  } else {
    const int j = i % W, g = i / W;
    const TC* col = c + (size_t)bh * M * d_out + j;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = (8 * g + u < M && j < d_out) ? to_float(col[(size_t)(8 * g + u) * d_out]) : 0.f;
    at = tile_at(8 * g / TM, 0) + ((size_t)(g % (TM / 8)) * W + j) * 8;
    n = NC;
    q0 = NB;
  }
  const size_t apart = tile_at(0, 1) - tile_at(0, 0);   // from one part to the next
  uint32_t p[3][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float lo[3], hi[3];
    split3(x[2 * u], lo);
    split3(x[2 * u + 1], hi);
#pragma unroll
    for (int q = 0; q < 3; ++q) p[q][u] = pack(lo[q], hi[q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (q < n)
      *reinterpret_cast<uint4*>(parts + at + (q0 + q) * apart) =
          make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
}

// acc (+)= cast_C(s) C_m for one step: sp holds the NS parts of the score
// tile as A fragments, Ct the NC part tiles of C_m^T; `fresh` starts acc anew;
// `during` runs on the CUDA cores while the tensor cores work
template <int W, int TM, int NS, int NC, typename F>
__device__ __forceinline__ void second_product(float (&acc)[W / 2],
                                               const uint32_t (&sp)[NS][TM / 16][4],
                                               const uint16_t* Ct, int tile, bool fresh,
                                               F&& during) {
  fence_registers(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < TM / 16; ++ks)
#pragma unroll
    for (int pc = 0; pc < NC; ++pc) {
      const uint64_t desc = smem_desc(Ct + pc * tile + ks * 2 * W * 8, W * 16, 128);
#pragma unroll
      for (int ps = 0; ps + pc < 3 && ps < NS; ++ps)
        wgmma<W>(acc, sp[ps][ks], desc, !fresh || ks + pc + ps > 0);
    }
  wgmma_commit();
  during();
  wgmma_wait();
  fence_registers(acc);
}

// a: (BH, R, d) of TA (float32, or bf16 as uint16_t); bp, cp: part 0 of B
// and of C^T (see layout_kernel), part q starts q * part elements later; with
// a tail, bp is the workspace, each step's parts and tails together
template <int T, int TM, typename TA, int NB, int NC, bool kFresh, int U = 0>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const TA* __restrict__ a, const uint16_t* __restrict__ bp,
             const uint16_t* __restrict__ cp, float* __restrict__ out, int R, int M, int Mt,
             int d, int d_out, size_t part) {
  constexpr int NA = kParts<TA>;
  using K = Tile<T, TM, NA, NB, NC, kFresh, U>;
  constexpr int W = K::W, NS = K::NS, S = K::kStages;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  // S stages of NB + NC part tiles and the tails of B and C
  auto stage = [&](int k) {
    return reinterpret_cast<uint16_t*>(smem_bytes + (k % S) * K::kStageBytes);
  };
  float* Os = reinterpret_cast<float*>(smem_bytes + S * K::kStageBytes);  // sums without registers

  const int bh = blockIdx.y, r0 = blockIdx.x * kTR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint16_t* bb = bp + (size_t)bh * Mt * W;
  const uint16_t* cb = cp + (size_t)bh * Mt * W;

  // a stage: each part tile of B as [W / 8][TM][8], of C^T as [TM / 8][W][8],
  // both whole in the workspace, then the step's tails of B and C as [TM][U];
  // thread 0 copies them, `full` counts the bytes
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int steps = Mt / TM;
  auto produce = [&](int k) {
    uint64_t* bar = &full[k % S];
    uint16_t* dst = stage(k);
    mbar_expect_tx(bar, K::kStageBytes);
    if constexpr (U > 0) {   // the whole step in one copy
      bulk_copy(dst, bp + ((size_t)bh * steps + k) * (K::kStageBytes / 2), K::kStageBytes,
                bar);
      return;
    }
#pragma unroll
    for (int q = 0; q < NB; ++q)
      bulk_copy(dst + q * K::kTile, bb + q * part + (size_t)k * K::kTile, K::kTile * 2, bar);
#pragma unroll
    for (int q = 0; q < NC; ++q)
      bulk_copy(dst + (NB + q) * K::kTile, cb + q * part + (size_t)k * K::kTile,
                K::kTile * 2, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);   // one arrival from each warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < S && k < steps; ++k) produce(k);

  // this thread's A fragments, a float32 A split into its three parts
  const int row0 = r0 + 16 * warp + g;
  uint32_t af[NA][T][4];
#pragma unroll
  for (int kk = 0; kk < T; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e % 2), col = 16 * kk + 2 * t + 8 * (e / 2);
      const TA* ar = a + ((size_t)bh * R + r) * d;
      float x0[3], x1[3];
      split3(r < R && col < d ? to_float(ar[col]) : 0.f, x0);
      split3(r < R && col + 1 < d ? to_float(ar[col + 1]) : 0.f, x1);
#pragma unroll
      for (int q = 0; q < NA; ++q) af[q][kk][e] = pack(x0[q], x1[q]);
    }
  // the tail of A on this thread's rows row0 and row0 + 8, and the sums of
  // s[r, m] c[m, tail] on them
  float at[2][U > 0 ? U : 1], ot[2][U > 0 ? U : 1];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = row0 + 8 * h, col = W + u;
      at[h][u] = r < R && col < d ? to_float(a[((size_t)bh * R + r) * d + col]) : 0.f;
      ot[h][u] = 0.f;
    }

  // fragment element 4 j + e: row g + 8 (e / 2), column 8 j + 2 t + e % 2
  float s[TM / 2], oc[kFresh ? W / 2 : 1], o[K::kSumsInRegisters ? W / 2 : 1];
#pragma unroll
  for (int i = 0; i < TM / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    if constexpr (K::kSumsInRegisters) o[i] = 0.f;
    else Os[i * kThreads + tid] = 0.f;
  }

  for (int k = 0; k < steps; ++k) {
    mbar_wait(&full[k % S], (k / S) & 1);
    const uint16_t* Bt = stage(k);
    const uint16_t* Ct = Bt + NB * K::kTile;
    const float* Bx = reinterpret_cast<const float*>(Bt + K::kStage);   // [TM][U]
    const float* Cx = Bx + K::kTail;

    // s = A_r B_m^T: 64 rows x TM a warpgroup, complete over d and the parts.
    // With one three-part operand (three passes) the part products run from
    // the smallest terms to the largest (lo, mid, hi), so that the small ones
    // sum while the accumulator is small: the score tile then lands nearer
    // the plain version's float32 sum and rounds to bf16 as it does more
    // often.  Six passes run in the order of d, which was faster for the
    // float32 chain.
    fence_registers(s);
    wgmma_fence();
    constexpr bool kSmallFirst = NA * NB == 3;
    int started = 0;
#pragma unroll
    for (int pass = 0; pass < (kSmallFirst ? 3 : 1); ++pass)
#pragma unroll
      for (int kk = 0; kk < T; ++kk)
#pragma unroll
        for (int pb = 0; pb < NB; ++pb) {
          const uint64_t desc = smem_desc(Bt + pb * K::kTile + kk * 2 * TM * 8, TM * 16, 128);
#pragma unroll
          for (int pa = 0; pa < NA; ++pa)
            if (kSmallFirst ? pa + pb == 2 - pass : pa + pb < 3) {
              wgmma<TM>(s, af[pa][kk], desc, started);
              started = 1;
            }
        }
    wgmma_commit();
    // the tail's terms of the score on the CUDA cores, while the tensor cores
    // run the first product; kept apart from s, which only wgmma writes
    float st[U > 0 ? TM / 2 : 1];
    if constexpr (U > 0) {
#pragma unroll
      for (int j = 0; j < TM / 8; ++j) {
        float bt[2 * U];
        load_pairs<U>(Bx + (8 * j + 2 * t) * U, bt);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, x = e % 2;
          float v = at[h][0] * bt[x * U];
#pragma unroll
          for (int u = 1; u < U; ++u) v = fmaf(at[h][u], bt[x * U + u], v);
          st[4 * j + e] = v;
        }
      }
    }
    wgmma_wait();
    fence_registers(s);
    // the score tile complete over d: the tiles' sum, then the tail's terms
    if constexpr (U > 0) {
#pragma unroll
      for (int i = 0; i < TM / 2; ++i) st[i] = s[i] + st[i];
    }
    auto score = [&](int i) -> float {
      if constexpr (U > 0) return st[i];
      else return s[i];
    };
    // the tail of the output, s[r, m] c[m, tail] summed on the CUDA cores
    // while the tensor cores run the second product
    auto tail_sums = [&] {
      if constexpr (U > 0) {
#pragma unroll
        for (int j = 0; j < TM / 8; ++j) {
          float ct[2 * U];
          load_pairs<U>(Cx + (8 * j + 2 * t) * U, ct);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < U; ++u)
              ot[e / 2][u] = fmaf(st[4 * j + e], ct[(e % 2) * U + u], ot[e / 2][u]);
        }
      }
    };

    // cast_C(s) as the A fragments of the second product: the accumulator
    // layout of two neighbouring 8-column score tiles is the A-fragment
    // layout of one 16-column tile
    uint32_t sp[NS][TM / 16][4];
#pragma unroll
    for (int ks = 0; ks < TM / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * ks + e / 2, x = 2 * (e % 2);
        if constexpr (NS == 1) {
          sp[0][ks][e] = pack_rn(s[4 * j + x], s[4 * j + x + 1]);
        } else {
          float lo[3], hi[3];
          split3(score(4 * j + x), lo);
          split3(score(4 * j + x + 1), hi);
#pragma unroll
          for (int q = 0; q < 3; ++q) sp[q][ks][e] = pack(lo[q], hi[q]);
        }
      }
    if constexpr (kFresh) second_product<W, TM, NS, NC>(oc, sp, Ct, K::kTile, true, tail_sums);
    else second_product<W, TM, NS, NC>(o, sp, Ct, K::kTile, false, tail_sums);

    // this warpgroup is done with the stage; thread 0 refills the stage of
    // the step before, which both warpgroups have left by now, so that one
    // warpgroup may run a step ahead of the other
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + warp / 4) : "memory");
    if (tid % 128 == 0) mbar_arrive(&empty[k % S]);
    if (tid == 0 && k >= 1 && k - 1 + S < steps) {
      mbar_wait(&empty[(k - 1) % S], ((k - 1) / S) & 1);
      produce(k - 1 + S);
    }
    if constexpr (kFresh) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        if constexpr (K::kSumsInRegisters) o[i] += oc[i];
        else Os[i * kThreads + tid] += oc[i];
      }
    }
  }

  float* ob = out + (size_t)bh * R * d_out;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const int j = i / 4, e = i % 4;
    const int r = row0 + 8 * (e / 2), col = 8 * j + 2 * t + e % 2;
    if (r >= R || col >= d_out) continue;
    if constexpr (K::kSumsInRegisters) ob[(size_t)r * d_out + col] = o[i];
    else ob[(size_t)r * d_out + col] = Os[i * kThreads + tid];
  }
  // the tail's sums over the four lanes of a row, in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = ot[h][u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int r = row0 + 8 * h, col = W + u;
      if (t == 0 && r < R && col < d_out) ob[(size_t)r * d_out + col] = v;
    }
}

template <int T, int TM, typename TA, int NB, int NC, bool kFresh, int U>
int launch(const TA* a, const uint16_t* parts, float* out, int BH, int R, int M, int Mt,
           int d, int d_out, cudaStream_t stream) {
  using K = Tile<T, TM, kParts<TA>, NB, NC, kFresh, U>;
  auto kernel = chain_kernel<T, TM, TA, NB, NC, kFresh, U>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::bytes);
  if (err != cudaSuccess) return (int)err;
  const size_t part = (size_t)BH * Mt * K::W;
  const dim3 grid((R + kTR - 1) / kTR, BH);
  kernel<<<grid, kThreads, K::bytes, stream>>>(a, parts, parts + NB * part, out, R, M, Mt, d,
                                               d_out, part);
  return (int)cudaGetLastError();
}

// The layout prologue, then the chain kernel, with a tail of U columns past
// the tiles of W = 16 T columns.
template <int U, int TM, typename TA, typename TB, typename TC, bool kFresh>
int run_tiles(const void* a, const void* b, const void* c, float* out, uint16_t* p, int BH,
              int R, int M, int Mt, int d, int d_out, int T, cudaStream_t s) {
  const int W = 16 * T, threads = Mt * (W / 8) + (U > 0 ? Mt : 0);
  layout_kernel<TM, TB, TC, U><<<dim3((threads + 255) / 256, 2, BH), 256, 0, s>>>(
      (const TB*)b, (const TC*)c, p, M, Mt, d, d_out, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int NB = kParts<TB>, NC = kParts<TC>;
  const TA* pa = (const TA*)a;
  switch (T) {
#define GT_CHAIN_CASE(T) \
  case T: return launch<T, TM, TA, NB, NC, kFresh, U>(pa, p, out, BH, R, M, Mt, d, d_out, s);
    GT_CHAIN_CASE(1) GT_CHAIN_CASE(2) GT_CHAIN_CASE(3) GT_CHAIN_CASE(4)
    GT_CHAIN_CASE(5) GT_CHAIN_CASE(6) GT_CHAIN_CASE(7)
#undef GT_CHAIN_CASE
    case 8:   // 128 columns leave no tail
      if constexpr (U == 0) return launch<8, TM, TA, NB, NC, kFresh, 0>(pa, p, out, BH, R, M,
                                                                        Mt, d, d_out, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// run_tiles with the tail U, the one instantiated tail of at most kTail that
// equals `tail`
template <int kTail, int TM, typename TA, typename TB, typename TC, bool kFresh>
int run_tail(int tail, const void* a, const void* b, const void* c, float* out, uint16_t* p,
             int BH, int R, int M, int Mt, int d, int d_out, int T, cudaStream_t s) {
  if constexpr (kTail > 0)
    if (tail != kTail)
      return run_tail<kTail - 1, TM, TA, TB, TC, kFresh>(tail, a, b, c, out, p, BH, R, M, Mt,
                                                          d, d_out, T, s);
  return run_tiles<kTail, TM, TA, TB, TC, kFresh>(a, b, c, out, p, BH, R, M, Mt, d, d_out, T,
                                                  s);
}

// One call of the chain: the layout prologue, then the chain kernel.
// a: (BH, R, d) of TA, b: (BH, M, d) of TB, c: (BH, M, d_out) of TC, out:
// (BH, R, d_out) float32, all contiguous; float for float32, uint16_t for
// bf16; d, d_out <= 128.  The tiles are W = 16 ceil(D / 16) wide, D the
// wider of d and d_out, or, where D >= 16 and 1 <= D mod 16 <= kTailMax,
// W = D - U with a tail of U = D mod 16 columns.  parts: bf16 scratch of
// (NB + NC) BH Mt W elements and 4 BH Mt U more (the tails, float32), NB and
// NC the parts of B and C (3 for float32, 1 for bf16), Mt = TM ceil(M / TM).
// Returns the CUDA error code of the launches (0 on success).
template <int TM, typename TA, typename TB, typename TC, bool kFresh, int kTailMax = 0>
int run(const void* a, const void* b, const void* c, float* out, void* parts, int BH, int R,
        int M, int d, int d_out, cudaStream_t s) {
  if (BH < 1 || BH > 65535 || R < 1 || M < 1 || M > (1 << 24) || d < 1 || d_out < 1 ||
      d > 128 || d_out > 128)
    return (int)cudaErrorInvalidValue;
  const int D = d > d_out ? d : d_out;
  const int U = D >= 16 && D % 16 <= kTailMax ? D % 16 : 0;
  const int T = (D - U + 15) / 16;
  const int Mt = (M + TM - 1) / TM * TM;
  return run_tail<kTailMax, TM, TA, TB, TC, kFresh>(U, a, b, c, out, (uint16_t*)parts, BH, R,
                                                    M, Mt, d, d_out, T, s);
}

}  // namespace chain
