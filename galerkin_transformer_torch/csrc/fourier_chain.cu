// Fourier attention's matmul chain on Hopper (sm_90a), float32, on the
// tensor cores (wgmma): fourier_chain.cuh with float32 A, B and C.
//
// Replaces: ops/pallas/fourier.py of the JAX package,
//   _tiled_abc -> _matmul_chain_kernel (the forward of fourier_attention_tiled),
//   and the three sweeps of _fourier_bwd, which run the same kernel.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m (A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// i.e. (A B^T) C in float32, the score tile complete over d and kept in
// float32, without storing the R x M score matrix.  The caller scales the
// result (1 / (sqrt(d) n) for fourier attention).
//
// Float32, not TF32: every operand and the score tile in three bf16 parts
// whose sum is exact, six part products per product (fourier_chain.cuh).  The
// second product is summed into fresh fragments for each step of 32 middle
// rows (one long tensor-core sum instead was 7.1e-5 of max|ref| from float64
// at (8, 8192, 97), against 1.8e-6).
//
// What bounds it: operations on the tensor cores.  2 BH R M (d + d_out)
// flops, six bf16 passes each; at the ex1 serving shape (BH = 8, R = M = 8192,
// d = d_out = 97) 208 GFLOP, 1250 GFLOP as bf16 passes: 1.26 ms at 989
// TFLOP/s (the CUDA cores' float32 bound is 3.11 ms at 67 TFLOP/s).
//
// Steps of 32 middle rows: six part tiles a stage (43 KB at W = 112), a ring
// of 4 stages (3 at W = 128, where the running sums live in shared memory).
// Measured on an H100 SXM (700 W) by chip_smoke.py --against, (8, 8192, 97)
// and the three backward sweeps at (8, 2048, 97): the CUDA-core kernel this
// replaces 6.65 and 1.46 ms; the same arithmetic with mma.sync (8 warps of
// 16 rows, A, B and C staged as parts) 3.69 and 0.79 ms; with wgmma and
// cp.async under a CTA barrier each step (the two warpgroups in lockstep)
// 3.09 and 0.67 ms with the sums in shared memory, 2.70 and 0.60 ms in
// registers; this design 2.02 and 0.46 ms (5 stages: 2.17 and 0.47 ms).
#include "fourier_chain.cuh"

namespace {
constexpr int kTM = 32;   // middle rows per step
}  // namespace

// a: (BH, R, d), b: (BH, M, d), c: (BH, M, d_out), out: (BH, R, d_out), all
// contiguous float32; d, d_out <= 128.  parts: bf16 scratch of 6 BH Mt W
// elements, Mt = 32 ceil(M / 32), W = 16 ceil(max(d, d_out) / 16).  Returns
// the CUDA error code of the launches (0 on success).
extern "C" int fourier_chain_launch(const float* a, const float* b, const float* c,
                                    float* out, void* parts, int BH, int R, int M, int d,
                                    int d_out, void* stream) {
  return chain::run<kTM, float, float, float, true>(a, b, c, out, parts, BH, R, M, d, d_out,
                                                    (cudaStream_t)stream);
}
