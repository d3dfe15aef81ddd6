// Fourier attention's matmul chain on Hopper (sm_90a), float32.
//
// Replaces: ops/pallas/fourier.py of the JAX package,
//   _tiled_abc -> _matmul_chain_kernel (the forward of fourier_attention_tiled).
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m (A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// i.e. (A B^T) C without storing the R x M score matrix.  The caller scales
// the result (1 / (sqrt(d) n) for fourier attention).
//
// What bounds it: operations.  It does 2 * BH * R * M * (d + d_out) flops on
// O((R + M) * d) bytes; at the ex1 serving shape (BH = 8, R = M = 8192,
// d = d_out = 97) that is 208 GFLOP per call.  Float32 is kept at full
// precision (the TPU kernel pins Precision.HIGHEST), so the work runs on
// CUDA-core FMAs, not TF32 tensor cores.
//
// What the design does about it:
//  * grid (ceil(R / 128), BH): each CTA keeps its 128 x d_out output tile as
//    float32 accumulators in registers (16 x 16 threads, each 8 rows x TPT
//    interleaved columns, d padded to 16 * TPT with zeros);
//  * its 128 rows of A stay in shared memory for the whole sweep;
//  * a loop over the middle dimension in steps of 32 rows takes the place of
//    the TPU's sequential third grid axis; each step forms the 128 x 32
//    score tile s = A_r B_m^T in float32 (8 x 2 per thread), writes it to
//    shared memory, then accumulates s C_m.  B_m is read only by the first
//    product and C_m only by the second, so cp.async refills each one while
//    the other product runs: the loads' latency is hidden with a single
//    buffer of each, and two CTAs still fit on an SM.  Rows past M are
//    zeros (the ragged edge is masked here, no padded copy is made);
//  * A, B and the score tile are kept k-major (transposed) in shared memory,
//    so a thread reads its 8 rows as two 16-byte loads and its 2 score
//    columns as one 8-byte load: about one shared-memory wavefront per 4
//    FMAs, so the FMA pipes and not shared memory set the pace.
// Earlier versions measured on the card: 4 x 2 / 4 x 7 register tiles with
// scalar loads ran at 31 % of the bound (shared-memory bound); 8 x 2 / 8 x 7
// tiles staged by plain loads at 43 % (each step's load latency exposed);
// double-buffered B and C at 38 % (one CTA per SM at 153 registers).
// Shared memory is ~103 KB at d = 97: two CTAs per SM.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 128;       // output rows per CTA: 16 groups of 8
constexpr int kTM = 32;        // middle rows per step
constexpr int kLA = kTR + 4;   // row stride of the k-major A and score tiles
constexpr int kLB = kTM + 2;   // row stride of the k-major B tile

template <int TPT>
constexpr size_t smem_floats() {
  return (size_t)(16 * TPT) * kLA + (size_t)(16 * TPT) * kLB +
         (size_t)kTM * (16 * TPT) + (size_t)kTM * kLA;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts copying rows m0 .. m0 + 31 of a row-major (M, w) matrix into shared
// memory, element (m, j) to dst[m * row_stride + j * col_stride]; rows past
// M are written as zeros.  One warp per row, lanes along the row.
__device__ __forceinline__ void stage_rows(float* dst, int row_stride,
                                           int col_stride, const float* src,
                                           int m0, int M, int w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < kTM / kWarps; ++q) {
    const int m = warp + kWarps * q;
    float* row = dst + m * row_stride;
    if (m0 + m < M) {
      const float* from = src + (size_t)(m0 + m) * w;
      for (int j = lane; j < w; j += 32) cp_async4(row + j * col_stride, from + j);
    } else {
      for (int j = lane; j < w; j += 32) row[j * col_stride] = 0.f;
    }
  }
  cp_async_commit();
}

template <int TPT>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ out, int R,
             int M, int d, int d_out) {
  constexpr int DP = 16 * TPT;
  extern __shared__ __align__(16) float smem[];
  float* At = smem;            // DP x kLA:  At[k][r] = A[r0 + r][k]
  float* Bt = At + DP * kLA;   // DP x kLB:  Bt[k][m] = B[m0 + m][k]
  float* Cs = Bt + DP * kLB;   // kTM x DP:  Cs[m][j] = C[m0 + m][j]
  float* St = Cs + kTM * DP;   // kTM x kLA: St[m][r] = s[r][m]

  const int bh = blockIdx.y, r0 = blockIdx.x * kTR;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ab = a + (size_t)bh * R * d;
  const float* bb = b + (size_t)bh * M * d;
  const float* cb = c + (size_t)bh * M * d_out;

  stage_rows(Bt, 1, kLB, bb, 0, M, d);
  // rows of A past R are zeros; columns past d are never read
  for (int i = tid; i < kTR * d; i += kThreads) {
    const int r = i / d, k = i % d;
    At[k * kLA + r] = (r0 + r < R) ? ab[(size_t)r0 * d + i] : 0.f;
  }
  // columns of C past d_out feed accumulators that are never stored; zero
  // them once so they hold no stale values
  for (int i = tid; i < kTM * (DP - d_out); i += kThreads) {
    const int m = i / (DP - d_out), j = d_out + i % (DP - d_out);
    Cs[m * DP + j] = 0.f;
  }

  float acc[8][TPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TPT; ++j) acc[i][j] = 0.f;

  // B is read only by the first product of a step and C only by the second,
  // so each is refilled while the other product runs.
  for (int m0 = 0; m0 < M; m0 += kTM) {
    cp_async_wait_all();  // B_m has landed
    __syncthreads();      // ... for every thread; the last step is done with Cs
    stage_rows(Cs, DP, 1, cb, m0, M, d_out);

    // s = A_r B_m^T: rows 8 ty .. 8 ty + 7, columns 2 tx, 2 tx + 1
    float s[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(At + k * kLA + 8 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(At + k * kLA + 8 * ty + 4);
      const float2 bv = *reinterpret_cast<const float2*>(Bt + k * kLB + 2 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][0] = fmaf(av[i], bv.x, s[i][0]);
        s[i][1] = fmaf(av[i], bv.y, s[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* dst = St + (2 * tx + j) * kLA + 8 * ty;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    cp_async_wait_all();  // C_m has landed
    __syncthreads();      // ... for every thread, with the score tile; Bt is free
    if (m0 + kTM < M) stage_rows(Bt, 1, kLB, bb, m0 + kTM, M, d);

    // acc += s C_m: rows 8 ty .. 8 ty + 7, columns tx + 16 j
#pragma unroll 2
    for (int m = 0; m < kTM; ++m) {
      const float4 s0 = *reinterpret_cast<const float4*>(St + m * kLA + 8 * ty);
      const float4 s1 = *reinterpret_cast<const float4*>(St + m * kLA + 8 * ty + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float cv[TPT];
#pragma unroll
      for (int j = 0; j < TPT; ++j) cv[j] = Cs[m * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TPT; ++j) acc[i][j] = fmaf(sv[i], cv[j], acc[i][j]);
    }
  }

  float* ob = out + (size_t)bh * R * d_out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * ty + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int col = tx + 16 * j;
      if (col < d_out) ob[(size_t)r * d_out + col] = acc[i][j];
    }
  }
}

template <int TPT>
int launch(const float* a, const float* b, const float* c, float* out, int BH,
           int R, int M, int d, int d_out, cudaStream_t stream) {
  const int bytes = (int)(smem_floats<TPT>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<TPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTR - 1) / kTR, BH);
  chain_kernel<TPT><<<grid, kThreads, bytes, stream>>>(a, b, c, out, R, M, d, d_out);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (BH, R, d), b: (BH, M, d), c: (BH, M, d_out), out: (BH, R, d_out), all
// contiguous float32; d, d_out <= 128.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fourier_chain_launch(const float* a, const float* b,
                                    const float* c, float* out, int BH, int R,
                                    int M, int d, int d_out, void* stream) {
  if (BH < 1 || BH > 65535 || R < 1 || M < 1 || d < 1 || d_out < 1 ||
      d > 128 || d_out > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int w = d > d_out ? d : d_out;
  switch ((w + 15) / 16) {
    case 1: return launch<1>(a, b, c, out, BH, R, M, d, d_out, s);
    case 2: return launch<2>(a, b, c, out, BH, R, M, d, d_out, s);
    case 3: return launch<3>(a, b, c, out, BH, R, M, d, d_out, s);
    case 4: return launch<4>(a, b, c, out, BH, R, M, d, d_out, s);
    case 5: return launch<5>(a, b, c, out, BH, R, M, d, d_out, s);
    case 6: return launch<6>(a, b, c, out, BH, R, M, d, d_out, s);
    case 7: return launch<7>(a, b, c, out, BH, R, M, d, d_out, s);
    case 8: return launch<8>(a, b, c, out, BH, R, M, d, d_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
