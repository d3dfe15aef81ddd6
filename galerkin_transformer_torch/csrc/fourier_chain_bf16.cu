// Fourier attention's matmul chain on Hopper (sm_90a), bf16 on the tensor cores.
//
// Replaces: ops/pallas/fourier.py of the JAX package,
//   _tiled_abc -> _matmul_chain_kernel with bf16 A, B, C (the bf16 encoder
//   dtype): the score tile is a float32 sum of bf16 products, is rounded to
//   bf16, and feeds a second bf16 product with a float32 sum.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m bf16(A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// in float32, without storing the R x M score matrix.  The caller scales the
// result (1 / (sqrt(d) n) for fourier attention) and rounds it to bf16.
//
// What bounds it: operations.  2 * BH * R * M * (d + d_out) flops on
// O((R + M) * d) bytes: at (BH, R = M, d) = (8, 8192, 97) that is 208 GFLOP
// on 25 MB.
//
// The caller hands over A, B and C padded with zero columns to one width
// W = 16 * T (the mma depth and tile width), so every row starts on a
// 16-byte boundary and the pad needs no masking here.
//
// What the design does about it:
//  * grid (ceil(R / 128), BH), 8 warps, each warp owns 16 rows of the output
//    tile: its A fragments (16 x W) stay in registers for the whole sweep and
//    its 16 x W output stays in float32 accumulators;
//  * a loop over the middle dimension in steps of 64 rows takes the place of
//    the TPU's sequential grid axis.  cp.async (16 bytes a thread) copies the
//    next B and C tiles into the other of two shared-memory stages while the
//    warps work on the current ones; rows past M are written as zeros;
//  * per step a warp forms its 16 x 64 score tile with mma.sync.m16n8k16
//    (B fragments by ldmatrix from the row-major B tile), complete over d
//    before it is rounded, so the result does not depend on the tiling of
//    the middle dimension; the float32 accumulator fragments, rounded to
//    bf16 and packed in pairs, ARE the A fragments of the second product (no
//    trip through shared memory); C fragments come by ldmatrix.trans from
//    the row-major C tile;
//  * the row stride of the tiles is W + 8 bf16 = 16 * (2 T + 1) bytes: the
//    8 rows of one ldmatrix fall into 8 different 16-byte bank groups.
// Shared memory at W = 128: 34 KB (A) + 2 * 2 * 17 KB (B, C) = 102 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTR = 128;       // output rows per CTA: 16 per warp
constexpr int kTM = 64;        // middle rows per step

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8 x 8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Starts copying `rows` rows of a row-major (N, W) matrix, from row n0 on,
// into a tile of row stride LD; rows past N are written as zeros.
template <int W, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int n0, int N,
                                           int rows) {
  constexpr int kPerRow = W / 8;   // 16-byte pieces in a row
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = 8 * (i % kPerRow);
    if (n0 + r < N)
      cp_async16(dst + r * LD + c, src + (size_t)(n0 + r) * W + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             const bf16* __restrict__ c, float* __restrict__ out, int R, int M,
             int d_out) {
  constexpr int W = 16 * T;   // padded d and d_out
  constexpr int LD = W + 8;   // row stride of the tiles
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* As = reinterpret_cast<bf16*>(smem_bytes);  // kTR x LD
  bf16* Bs = As + kTR * LD;                        // 2 stages of kTM x LD
  bf16* Cs = Bs + 2 * kTM * LD;                    // 2 stages of kTM x LD

  const int bh = blockIdx.y, r0 = blockIdx.x * kTR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* ab = a + (size_t)bh * R * W;
  const bf16* bb = b + (size_t)bh * M * W;
  const bf16* cb = c + (size_t)bh * M * W;

  stage_rows<W, LD>(As, ab, r0, R, kTR);
  stage_rows<W, LD>(Bs, bb, 0, M, kTM);
  stage_rows<W, LD>(Cs, cb, 0, M, kTM);
  cp_async_commit();

  // ldmatrix row addresses of this lane inside a 16 x 16 tile:
  // row-major operand (A, and B as the column-major operand of A B^T):
  //   tiles (rows 0.., cols 0..), (8, 0), (0, 8), (8, 8) for A;
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  //   tiles (0, 0), (0, 8), (8, 0), (8, 8) for B: two 8-row groups of B, each
  //   with its two halves of the depth;
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);
  //   C, read transposed: tiles (0, 0), (8, 0), (0, 8), (8, 8).
  const int c_row = (lane % 8) + 8 * ((lane / 8) % 2), c_col = 8 * (lane / 16);

  float o[2 * T][4];
#pragma unroll
  for (int j = 0; j < 2 * T; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t afrag[T][4];
#pragma unroll
  for (int kk = 0; kk < T; ++kk)
    ldmatrix_x4(afrag[kk], As + (16 * warp + a_row) * LD + 16 * kk + a_col);

  int stage = 0;
  for (int m0 = 0; m0 < M; m0 += kTM, stage ^= 1) {
    // this step's tiles have landed and every warp is done with the last step
    cp_async_wait_all();
    __syncthreads();
    if (m0 + kTM < M) {
      stage_rows<W, LD>(Bs + (stage ^ 1) * kTM * LD, bb, m0 + kTM, M, kTM);
      stage_rows<W, LD>(Cs + (stage ^ 1) * kTM * LD, cb, m0 + kTM, M, kTM);
      cp_async_commit();
    }
    const bf16* Bt = Bs + stage * kTM * LD;
    const bf16* Ct = Cs + stage * kTM * LD;

    // s = A_r B_m^T: 16 rows x 64 columns, complete over d
    float s[kTM / 8][4];
#pragma unroll
    for (int j = 0; j < kTM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kTM / 16; ++jp) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, Bt + (16 * jp + b_row) * LD + 16 * kk + b_col);
        mma_bf16(s[2 * jp], afrag[kk], bfrag[0], bfrag[1]);
        mma_bf16(s[2 * jp + 1], afrag[kk], bfrag[2], bfrag[3]);
      }
    }

    // out += bf16(s) C_m: the accumulator layout of two neighbouring 16 x 8
    // score tiles is the A-fragment layout of one 16 x 16 tile
#pragma unroll
    for (int ks = 0; ks < kTM / 16; ++ks) {
      uint32_t pfrag[4];
      pfrag[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pfrag[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pfrag[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pfrag[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < T; ++np) {
        uint32_t cfrag[4];
        ldmatrix_x4_trans(cfrag, Ct + (16 * ks + c_row) * LD + 16 * np + c_col);
        mma_bf16(o[2 * np], pfrag, cfrag[0], cfrag[1]);
        mma_bf16(o[2 * np + 1], pfrag, cfrag[2], cfrag[3]);
      }
    }
  }

  // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
  // column 2 * (lane % 4) + e % 2
  float* ob = out + (size_t)bh * R * d_out;
#pragma unroll
  for (int j = 0; j < 2 * T; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 16 * warp + lane / 4 + 8 * (e / 2);
      const int col = 8 * j + 2 * (lane % 4) + e % 2;
      if (r < R && col < d_out) ob[(size_t)r * d_out + col] = o[j][e];
    }
}

template <int T>
int launch(const bf16* a, const bf16* b, const bf16* c, float* out, int BH, int R,
           int M, int d_out, cudaStream_t stream) {
  constexpr int LD = 16 * T + 8;
  const int bytes = (kTR + 4 * kTM) * LD * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTR - 1) / kTR, BH);
  chain_kernel<T><<<grid, kThreads, bytes, stream>>>(a, b, c, out, R, M, d_out);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (BH, R, W), b: (BH, M, W), c: (BH, M, W), contiguous bf16, zero in the
// columns past d (a, b) and past d_out (c), W a multiple of 16 up to 128;
// out: (BH, R, d_out) contiguous float32, d_out <= W.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int fourier_chain_bf16_launch(const void* a, const void* b, const void* c,
                                         float* out, int BH, int R, int M, int W,
                                         int d_out, void* stream) {
  if (BH < 1 || BH > 65535 || R < 1 || M < 1 || W < 16 || W > 128 || W % 16 != 0 ||
      d_out < 1 || d_out > W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *pa = (const bf16*)a, *pb = (const bf16*)b, *pc = (const bf16*)c;
  switch (W / 16) {
    case 1: return launch<1>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 2: return launch<2>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 3: return launch<3>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 4: return launch<4>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 5: return launch<5>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 6: return launch<6>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 7: return launch<7>(pa, pb, pc, out, BH, R, M, d_out, s);
    case 8: return launch<8>(pa, pb, pc, out, BH, R, M, d_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
