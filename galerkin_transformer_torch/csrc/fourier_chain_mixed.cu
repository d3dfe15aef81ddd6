// Fourier attention's matmul chain on Hopper (sm_90a) with one float32 operand
// beside two bf16 ones, on the tensor cores (wgmma): the three sweeps of the
// bf16 backward, fourier_chain.cuh with the operand types of each sweep.
//
// Replaces: ops/pallas/fourier.py of the JAX package, _fourier_bwd with bf16
//   q, k, v and the gradient cast to float32: three sweeps of _tiled_abc ->
//   _matmul_chain_kernel whose operands (A, B, C) have the types
//     dQ: (float32 g, bf16 v, bf16 k)    dK: (bf16 v, float32 g, bf16 q)
//     dV: (bf16 k, bf16 q, float32 g).
//   That kernel casts the score tile to C's type: rounded to nearest-even
//   bf16 in the first two sweeps, left in float32 in the third.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m cast_C(A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// in float32, without storing the R x M score matrix.
//
// The float32 operand is NOT rounded to bf16 (that would be another result):
// it is three bf16 parts whose sum is exact, so the product with a bf16
// operand is three passes (dQ: A's parts, split once in registers; dK: three
// B part tiles a stage), run from the smallest part products to the
// largest.  dQ and dK round the score tile to nearest-even bf16.  In dV the
// float32 score tile is split in registers too and the second product is
// six passes with C's three parts.  Every sweep sums its second product into
// fresh fragments per step, as the float32 chain does (the tensor cores
// truncate their float32 sums).
//
// What bounds it: operations on the tensor cores.  2 BH R M (d + d_out)
// flops as the all-bf16 kernel, as (3 + 1), (3 + 1) and (1 + 6) bf16 passes
// for dQ, dK and dV, on O((R + M) d) bytes.
//
// A call is two device kernels: the layout prologue (which splits a float32 B
// or C) and the chain, both reading the operands where they lie.  Steps of
// 64 middle rows (128 would leave dK one stage of shared memory).
//
// Measured on an H100 SXM (700 W) by chip_smoke.py --against, the three
// sweeps at (8, 2048, 97): the mma.sync kernel this replaces (a split kernel,
// padded copies, 8 warps of 16 rows, A's parts re-read from shared memory
// each step) 0.44 ms (dQ 0.121, dK 0.144, dV 0.178); this design 0.226 ms
// (0.062, 0.068, 0.089), its errors against the plain version below that
// kernel's on most input draws; with one long tensor-core sum in dQ and dK
// and the part products in the order of d 0.219 ms, but dQ's error above
// that kernel's on most draws; with 32-row steps 0.275 ms; with step k+1's
// first product issued before waiting on step k's second 0.289 ms.
#include "fourier_chain.cuh"

namespace {
constexpr int kTM = 64;   // middle rows per step
}  // namespace

// a: (BH, R, d), b: (BH, M, d), c: (BH, M, d_out), contiguous; operand number
// `f32_operand` (0: a, 1: b, 2: c) is float32, the other two bf16; d, d_out
// <= 128.  parts: bf16 scratch of 4 BH Mt W elements, Mt = 64 ceil(M / 64),
// W = 16 ceil(max(d, d_out) / 16).  out: (BH, R, d_out) contiguous float32.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int fourier_chain_mixed_launch(const void* a, const void* b, const void* c,
                                          float* out, void* parts, int BH, int R, int M,
                                          int d, int d_out, int f32_operand, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f32_operand) {
    case 0:   // dQ
      return chain::run<kTM, float, uint16_t, uint16_t, true>(a, b, c, out, parts, BH, R, M,
                                                               d, d_out, s);
    case 1:   // dK
      return chain::run<kTM, uint16_t, float, uint16_t, true>(a, b, c, out, parts, BH, R, M,
                                                               d, d_out, s);
    case 2:   // dV
      return chain::run<kTM, uint16_t, uint16_t, float, true>(a, b, c, out, parts, BH, R, M,
                                                               d, d_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
