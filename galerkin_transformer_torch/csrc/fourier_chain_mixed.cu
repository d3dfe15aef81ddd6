// Fourier attention's matmul chain on Hopper (sm_90a) with one float32 operand:
// the three sweeps of the bf16 backward.
//
// Replaces: ops/pallas/fourier.py of the JAX package, _fourier_bwd with bf16
//   q, k, v and the gradient cast to float32: three sweeps of _tiled_abc ->
//   _matmul_chain_kernel whose operands (A, B, C) have the types
//     dQ: (float32 g, bf16 v, bf16 k)    dK: (bf16 v, float32 g, bf16 q)
//     dV: (bf16 k, bf16 q, float32 g).
//   That kernel casts the score tile to C's type: rounded to bf16 in the
//   first two sweeps, left in float32 in the third.
//
// Computes, for every bh,
//   out[bh, r, :] = sum_m cast_C(A[bh, r, :] . B[bh, m, :]) * C[bh, m, :]
// in float32, without storing the R x M score matrix.
//
// The float32 operand is NOT rounded to bf16 (that would be another result).
// A first kernel splits it into three bf16 parts, hi + mid + lo, whose sum is
// the float32 value exactly (3 x 8 significand bits), padded with zero columns
// to the tile width.  A product with a bf16 operand is then three tensor-core
// products whose terms are exact in float32, summed in float32: the float32
// product up to the order of summation.  In the third sweep both the float32
// score tile (split in registers) and C have three parts; the six part
// products down to 2^-24 of the largest are kept (hi hi, hi mid, mid hi,
// hi lo, mid mid, lo hi), so that product is float32 to about three units in
// its last place.
//
// What bounds it: operations, on the tensor cores.  2 BH R M (d + d_out)
// flops as the all-bf16 kernel, times 2 (sweeps 1, 2: the first product three
// times) or 3.5 (sweep 3: the second product six times), on O((R + M) d)
// bytes.
//
// The design is that of fourier_chain_bf16.cu: grid (ceil(R / 128), BH), 8
// warps of 16 output rows each, a loop over the middle dimension in steps of
// 64 rows with cp.async double buffering, mma.sync.m16n8k16, the score tile
// complete over d before it is cast, its accumulator fragments reused as the
// A fragments of the second product.  Every operand arrives as bf16 rows of
// one width W = 16 T (the bf16 operands padded by the caller, the float32 one
// by the split kernel).  With a split A its three tiles stay in shared memory
// and are read by ldmatrix each step (registers hold A only when it has one
// part).  Shared memory at W = 128: 174 KB, one CTA per SM.
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

// x = hi + mid + lo exactly: each part takes the next 8 significand bits
__device__ __forceinline__ void split3(float x, float (&part)[3]) {
  part[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r1 = x - part[0];
  part[1] = __bfloat162float(__float2bfloat16_rn(r1));
  part[2] = __bfloat162float(__float2bfloat16_rn(r1 - part[1]));
}

// parts[i][row][c] for i < 3: the three bf16 parts of x[row][c], zero for
// d <= c < W.  x: (rows, d) float32; parts: (3, rows, W) bf16.
__global__ void split_kernel(const float* __restrict__ x, bf16* __restrict__ parts,
                             size_t rows, int d, int W) {
  const size_t total = rows * (size_t)W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t r = i / W;
  const int c = (int)(i % W);
  float part[3];
  split3(c < d ? x[r * d + c] : 0.f, part);
#pragma unroll
  for (int q = 0; q < 3; ++q) parts[q * total + i] = __float2bfloat16_rn(part[q]);
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

// NA, NB, NC: the number of bf16 parts of A, B and C (3 for the float32
// operand, 1 for the others); part i of an operand starts i * <x>_part
// elements after part 0.
template <int T, int NA, int NB, int NC>
__global__ void __launch_bounds__(kThreads, 1)
chain_mixed_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   const bf16* __restrict__ c, float* __restrict__ out, int R, int M,
                   int d_out, size_t a_part, size_t b_part, size_t c_part) {
  constexpr int W = 16 * T;   // padded d and d_out
  constexpr int LD = W + 8;   // row stride of the tiles
  constexpr int kTile = kTM * LD;
  constexpr int kStage = (NB + NC) * kTile;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* As = reinterpret_cast<bf16*>(smem_bytes);  // NA tiles of kTR x LD
  bf16* St = As + NA * kTR * LD;                   // 2 stages of NB B tiles, NC C tiles

  const int bh = blockIdx.y, r0 = blockIdx.x * kTR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* ab = a + (size_t)bh * R * W;
  const bf16* bb = b + (size_t)bh * M * W;
  const bf16* cb = c + (size_t)bh * M * W;

  auto stage_bc = [&](bf16* dst, int m0) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      stage_rows<W, LD>(dst + i * kTile, bb + i * b_part, m0, M, kTM);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      stage_rows<W, LD>(dst + (NB + i) * kTile, cb + i * c_part, m0, M, kTM);
  };

#pragma unroll
  for (int i = 0; i < NA; ++i)
    stage_rows<W, LD>(As + i * kTR * LD, ab + i * a_part, r0, R, kTR);
  stage_bc(St, 0);
  cp_async_commit();

  // ldmatrix row addresses of this lane inside a 16 x 16 tile (as in
  // fourier_chain_bf16.cu): A row-major; B as the column-major operand of
  // A B^T; C read transposed
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);
  const int c_row = (lane % 8) + 8 * ((lane / 8) % 2), c_col = 8 * (lane / 16);

  float o[2 * T][4];
#pragma unroll
  for (int j = 0; j < 2 * T; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  const bf16* Aw = As + (16 * warp + a_row) * LD + a_col;   // this lane's A rows
  uint32_t afrag[NA == 1 ? T : 1][4];
  if constexpr (NA == 1) {
#pragma unroll
    for (int kk = 0; kk < T; ++kk) ldmatrix_x4(afrag[kk], Aw + 16 * kk);
  }

  int stage = 0;
  for (int m0 = 0; m0 < M; m0 += kTM, stage ^= 1) {
    // this step's tiles have landed and every warp is done with the last step
    cp_async_wait_all();
    __syncthreads();
    if (m0 + kTM < M) {
      stage_bc(St + (stage ^ 1) * kStage, m0 + kTM);
      cp_async_commit();
    }
    const bf16* Bt = St + stage * kStage;
    const bf16* Ct = Bt + NB * kTile;

    // s = A_r B_m^T: 16 rows x 64 columns, complete over d and over the parts
    float s[kTM / 8][4];
#pragma unroll
    for (int j = 0; j < kTM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T; ++kk) {
#pragma unroll
      for (int pa = 0; pa < NA; ++pa) {
        uint32_t av[4];
        if constexpr (NA == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) av[e] = afrag[kk][e];
        } else {
          ldmatrix_x4(av, Aw + pa * kTR * LD + 16 * kk);
        }
#pragma unroll
        for (int pb = 0; pb < NB; ++pb) {
#pragma unroll
          for (int jp = 0; jp < kTM / 16; ++jp) {
            uint32_t bfrag[4];
            ldmatrix_x4(bfrag, Bt + pb * kTile + (16 * jp + b_row) * LD + 16 * kk + b_col);
            mma_bf16(s[2 * jp], av, bfrag[0], bfrag[1]);
            mma_bf16(s[2 * jp + 1], av, bfrag[2], bfrag[3]);
          }
        }
      }
    }

    // out += cast_C(s) C_m: the accumulator layout of two neighbouring 16 x 8
    // score tiles is the A-fragment layout of one 16 x 16 tile
#pragma unroll
    for (int ks = 0; ks < kTM / 16; ++ks) {
      if constexpr (NC == 1) {
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
      } else {
        // the float32 score tile in three bf16 parts
        uint32_t pfrag[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * ks + e / 2, x = 2 * (e % 2);
          float lo[3], hi[3];
          split3(s[j][x], lo);
          split3(s[j][x + 1], hi);
#pragma unroll
          for (int q = 0; q < 3; ++q) pfrag[q][e] = pack_bf16(lo[q], hi[q]);
        }
#pragma unroll
        for (int np = 0; np < T; ++np) {
#pragma unroll
          for (int pc = 0; pc < 3; ++pc) {
            uint32_t cfrag[4];
            ldmatrix_x4_trans(cfrag,
                              Ct + pc * kTile + (16 * ks + c_row) * LD + 16 * np + c_col);
#pragma unroll
            for (int ps = 0; ps + pc < 3; ++ps) {
              mma_bf16(o[2 * np], pfrag[ps], cfrag[0], cfrag[1]);
              mma_bf16(o[2 * np + 1], pfrag[ps], cfrag[2], cfrag[3]);
            }
          }
        }
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

template <int T, int NA, int NB, int NC>
int launch(const bf16* a, const bf16* b, const bf16* c, float* out, int BH, int R,
           int M, int d_out, size_t a_part, size_t b_part, size_t c_part,
           cudaStream_t stream) {
  constexpr int LD = 16 * T + 8;
  const int bytes = (NA * kTR + 2 * (NB + NC) * kTM) * LD * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      chain_mixed_kernel<T, NA, NB, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTR - 1) / kTR, BH);
  chain_mixed_kernel<T, NA, NB, NC><<<grid, kThreads, bytes, stream>>>(
      a, b, c, out, R, M, d_out, a_part, b_part, c_part);
  return (int)cudaGetLastError();
}

template <int T>
int launch_for(int f32_operand, const bf16* a, const bf16* b, const bf16* c, float* out,
               int BH, int R, int M, int d_out, size_t part, cudaStream_t stream) {
  switch (f32_operand) {
    case 0: return launch<T, 3, 1, 1>(a, b, c, out, BH, R, M, d_out, part, 0, 0, stream);
    case 1: return launch<T, 1, 3, 1>(a, b, c, out, BH, R, M, d_out, 0, part, 0, stream);
    case 2: return launch<T, 1, 1, 3>(a, b, c, out, BH, R, M, d_out, 0, 0, part, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: (BH, R, .), b: (BH, M, .), c: (BH, M, .), contiguous.  Operand number
// `f32_operand` (0: a, 1: b, 2: c) is float32 with rows of d (a, b) or d_out
// (c) columns, unpadded; the other two are bf16 with rows of W columns, zero
// past d (a, b) and past d_out (c).  W is a multiple of 16 up to 128, d and
// d_out <= W.  parts: bf16 scratch for the float32 operand's three parts,
// (3, BH, rows, W).  out: (BH, R, d_out) contiguous float32.  Returns the CUDA
// error code of the launches (0 on success).
extern "C" int fourier_chain_mixed_launch(const void* a, const void* b, const void* c,
                                          float* out, void* parts, int BH, int R, int M,
                                          int d, int W, int d_out, int f32_operand,
                                          void* stream) {
  if (BH < 1 || BH > 65535 || R < 1 || M < 1 || W < 16 || W > 128 || W % 16 != 0 ||
      d < 1 || d > W || d_out < 1 || d_out > W || f32_operand < 0 || f32_operand > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* src = f32_operand == 0 ? a : f32_operand == 1 ? b : c;
  const size_t rows = (size_t)BH * (f32_operand == 0 ? R : M);
  const size_t part = rows * W;
  split_kernel<<<(unsigned)((part + 255) / 256), 256, 0, s>>>(
      (const float*)src, (bf16*)parts, rows, f32_operand == 2 ? d_out : d, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16* p = (const bf16*)parts;
  const bf16* pa = f32_operand == 0 ? p : (const bf16*)a;
  const bf16* pb = f32_operand == 1 ? p : (const bf16*)b;
  const bf16* pc = f32_operand == 2 ? p : (const bf16*)c;
  switch (W / 16) {
#define GT_MIXED_CASE(T) \
  case T: return launch_for<T>(f32_operand, pa, pb, pc, out, BH, R, M, d_out, part, s);
    GT_MIXED_CASE(1) GT_MIXED_CASE(2) GT_MIXED_CASE(3) GT_MIXED_CASE(4)
    GT_MIXED_CASE(5) GT_MIXED_CASE(6) GT_MIXED_CASE(7) GT_MIXED_CASE(8)
#undef GT_MIXED_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
