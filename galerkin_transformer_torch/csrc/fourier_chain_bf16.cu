// Fourier attention's matmul chain on Hopper (sm_90a), bf16 on the tensor
// cores (wgmma): fourier_chain.cuh with bf16 A, B and C.
//
// Replaces: ops/pallas/fourier.py of the JAX package,
//   _tiled_abc -> _matmul_chain_kernel with bf16 A, B, C (the bf16 encoder
//   dtype): the score tile is a float32 sum of bf16 products, is rounded to
//   nearest-even bf16 (s.astype(c.dtype)), and feeds a second bf16 product
//   with a float32 sum.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m bf16(A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// in float32, without storing the R x M score matrix.  The caller scales the
// result (1 / (sqrt(d) n) for fourier attention) and rounds it to bf16.
//
// What bounds it: operations on the tensor cores, one bf16 pass.
// 2 BH R M (d + d_out) flops on O((R + M) d) bytes: at (BH, R = M, d) =
// (8, 8192, 97) 208 GFLOP on 25 MB, 0.21 ms at 989 TFLOP/s.
//
// A call is two device kernels: the layout prologue reads b and c where they
// lie (unpadded bf16 rows) and the chain reads a where it lies.  Steps of 128
// middle rows: a B and a C tile a stage (56 KB at W = 112), a ring of 4 (3 at
// W = 128).  The tensor cores keep one sum of the second product over all of
// M, as the mma.sync kernel this replaces did: at (8, 8192, 97) it is as far
// from the plain version as that kernel (1.776e-4 of max|ref|; fresh
// fragments per step 1.77e-4, and 7 % slower).
//
// Measured on an H100 SXM (700 W) by chip_smoke.py --against, (8, 8192, 97)
// and (8, 2048, 97): the mma.sync kernel this replaces (8 warps of 16 rows,
// cp.async under a CTA barrier each step) 0.99 and 0.094 ms; this design with
// steps of 32 rows and fresh fragments 0.73 and 0.061 ms, 64 rows 0.48 and
// 0.046 ms, 64 rows and one long sum 0.45 and 0.044 ms, 128 rows 0.38 and
// 0.041 ms; step k+1's first product issued before waiting on step k's
// second (two sets of score fragments) 0.56 and 0.050 ms at 64 rows, 0.44
// and 0.043 ms at 128.
#include "fourier_chain.cuh"

namespace {
constexpr int kTM = 128;            // middle rows per step
constexpr bool kFreshSums = false;  // one tensor-core sum over M
}  // namespace

// a: (BH, R, d), b: (BH, M, d), c: (BH, M, d_out), contiguous bf16; out:
// (BH, R, d_out) contiguous float32; d, d_out <= 128.  parts: bf16 scratch of
// 2 BH Mt W elements, Mt = 128 ceil(M / 128), W = 16 ceil(max(d, d_out) / 16).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int fourier_chain_bf16_launch(const void* a, const void* b, const void* c,
                                         float* out, void* parts, int BH, int R, int M, int d,
                                         int d_out, void* stream) {
  return chain::run<kTM, uint16_t, uint16_t, uint16_t, kFreshSums>(
      a, b, c, out, parts, BH, R, M, d, d_out, (cudaStream_t)stream);
}
