// Galerkin attention scores on Hopper (sm_90a), bf16 inputs on the tensor cores.
//
// Replaces: ops/pallas/galerkin.py of the JAX package,
//   galerkin_scores_pallas -> _scores_kernel with bf16 K, V and pos (the bf16
//   encoder dtype): LayerNorm statistics and affine in float32, the result
//   rounded to bf16, one bf16 matrix-unit pass with a float32 sum.
//
// Computes, for every (batch, head) pair bh,
//   S[bh] = [pos, bf16(LN_K(K[bh]))]^T [pos, bf16(LN_V(V[bh]))]   (d_eff x d_eff)
// unscaled, in float32.  K, V (B*H, n, d_k) and pos (B, n, p) are bf16; the
// LN scale and bias (H, d_k) are float32, as the model keeps its parameters.
//
// What bounds it: bytes.  It reads K and V once (2 * BH * n * d_k bf16) and
// does 2 * BH * n * d_eff^2 flops on the tensor cores; at d_eff = 97 that is
// 94 flops a byte, a third of what the card needs before the tensor cores
// are the limit.  The LayerNorm stage (float32, CUDA cores, warp shuffles)
// is what costs instructions, as in the float32 kernel.
//
// What the design does about it:
//  * grid (BH, splits), as in galerkin_scores.cu: each CTA owns a contiguous
//    range of sequence rows, walks it in chunks of 32 rows that cp.async
//    copies (16 bytes a thread) one chunk ahead, and writes one float32
//    partial; a second kernel sums the partials in split order, so the
//    result is the same from run to run;
//  * each warp normalizes 4 rows of K and 4 of V at once (interleaved
//    reductions), rounds to bf16 and writes them row-major into shared
//    memory with pos in front; rows past n and columns from d_eff up to the
//    next multiple of 16 (the mma depth and tile width) are zeros;
//  * the product contracts over the rows of the chunk, so both operands are
//    read transposed: ldmatrix.trans turns the row-major [row][column] tiles
//    into the A (K'^T, 16 x 16) and B (V', 16 x 8) fragments of
//    mma.sync.m16n8k16 with float32 accumulators.  The d_eff x d_eff output
//    is cut into 16 x 16 blocks dealt to the 8 warps in order, so a warp's
//    blocks share their A fragment where they share a block row.  The row
//    stride of the tiles is 16 * (2 DT + 1) bytes: the 8 rows of one
//    ldmatrix fall into 8 different 16-byte bank groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerChunk = 32;  // sequence rows staged per step: 2 mma depths
constexpr int kMaxDk = 128;        // d_k held in registers by one warp
constexpr int kLnBatch = kRowsPerChunk / kWarps;  // rows a warp normalizes at once

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

// Four 8 x 8 bf16 tiles, each read transposed; lane l gives the address of
// row l % 8 of tile l / 8.
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

// Starts the copy of rows [c0, c0 + 32) ∩ [c0, row_end) of K, V and pos into
// one stage buffer: K rows at [0, 32 dk), V rows at [32 dk, 64 dk), pos rows
// after them.  With d_k a multiple of 8 and 16-byte aligned bases the K and V
// rows go through cp.async and land while the CTA computes the previous
// chunk; otherwise, and for pos, plain loads.
__device__ __forceinline__ void prefetch(bf16* stage, const bf16* kb, const bf16* vb,
                                         const bf16* pb, int c0, int row_end, int dk,
                                         int p) {
  const int rows = min(kRowsPerChunk, row_end - c0);
  const bf16* ks = kb + (size_t)c0 * dk;
  const bf16* vs = vb + (size_t)c0 * dk;
  if ((dk % 8) == 0 && (reinterpret_cast<size_t>(ks) % 16) == 0 &&
      (reinterpret_cast<size_t>(vs) % 16) == 0) {
    for (int i = 8 * threadIdx.x; i < rows * dk; i += 8 * kThreads) {
      cp_async16(stage + i, ks + i);
      cp_async16(stage + kRowsPerChunk * dk + i, vs + i);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dk; i += kThreads) {
      stage[i] = ks[i];
      stage[kRowsPerChunk * dk + i] = vs[i];
    }
  }
  bf16* ps = stage + 2 * kRowsPerChunk * dk;
  for (int i = threadIdx.x; i < rows * p; i += kThreads) ps[i] = pb[(size_t)c0 * p + i];
  cp_async_commit();
}

// One warp normalizes kBatch rows at once.  Row u is x[u] (d_k bf16 in shared
// memory), written to dst[u] (dp bf16) as
// [pos_row (p), bf16(LN(x) * scale + bias) (d_k), zeros]; a row past the end
// of the sequence is written as zeros.  Statistics, the affine and their
// order of operations are those of the plain version (no fused multiply-add),
// so the value that is rounded to bf16 is the same float32.
template <int kBatch>
__device__ __forceinline__ void ln_rows(const bf16* const (&x)[kBatch], const float* scale,
                                        const float* bias,
                                        const bf16* const (&pos_row)[kBatch],
                                        bf16* const (&dst)[kBatch],
                                        const bool (&valid)[kBatch], int dk, int p,
                                        int dp, float eps, int lane) {
  constexpr int kPer = kMaxDk / 32;
  float xv[kBatch][kPer], mean[kBatch], q[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    mean[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      xv[u][t] = (valid[u] && c < dk) ? __bfloat162float(x[u][c]) : 0.f;
      mean[u] += xv[u][t];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kBatch; ++u) mean[u] += __shfl_xor_sync(0xffffffffu, mean[u], o);
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    mean[u] /= dk;
    q[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const float dev = (lane + 32 * t < dk) ? xv[u][t] - mean[u] : 0.f;
      q[u] += dev * dev;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kBatch; ++u) q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const float rstd = rsqrtf(q[u] / dk + eps);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c < dk) {
        const float y = __fadd_rn(
            __fmul_rn(__fmul_rn(xv[u][t] - mean[u], rstd), scale[c]), bias[c]);
        dst[u][p + c] = __float2bfloat16_rn(valid[u] ? y : 0.f);
      }
    }
    for (int c = lane; c < p; c += 32)
      dst[u][c] = valid[u] ? pos_row[u][c] : __float2bfloat16_rn(0.f);
    for (int c = p + dk + lane; c < dp; c += 32) dst[u][c] = __float2bfloat16_rn(0.f);
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
scores_partial_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ pos, const float* __restrict__ scale_k,
                      const float* __restrict__ bias_k, const float* __restrict__ scale_v,
                      const float* __restrict__ bias_v, float* __restrict__ partial,
                      int H, int n, int dk, int p, int rows_per_split, float eps) {
  constexpr int DP = 16 * DT;                   // d_eff padded to the mma tile
  constexpr int LD = DP + 8;                    // row stride of the bf16 tiles
  constexpr int NB = (DT * DT + kWarps - 1) / kWarps;  // 16 x 16 blocks per warp
  __shared__ __align__(16) bf16 ks[kRowsPerChunk][LD];
  __shared__ __align__(16) bf16 vs[kRowsPerChunk][LD];
  __shared__ float affine[4][kMaxDk];  // scale_k, bias_k, scale_v, bias_v
  extern __shared__ __align__(16) unsigned char raw_bytes[];  // 2 stages of raw rows
  bf16* raw = reinterpret_cast<bf16*>(raw_bytes);
  // each stage starts on a 16-byte boundary
  const int stage_elems = (kRowsPerChunk * (2 * dk + p) + 7) / 8 * 8;

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + (size_t)bh * n * dk;
  const bf16* vb = v + (size_t)bh * n * dk;
  const bf16* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;

  for (int c = threadIdx.x; c < dk; c += kThreads) {
    affine[0][c] = scale_k[h * dk + c];
    affine[1][c] = bias_k[h * dk + c];
    affine[2][c] = scale_v[h * dk + c];
    affine[3][c] = bias_v[h * dk + c];
  }

  // block q = warp * NB + t of the DT x DT grid of 16 x 16 output blocks;
  // acc[t][j] is its 16 x 8 half j
  float acc[NB][2][4];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // ldmatrix row addresses of this lane inside a 16 x 16 tile at (r0, c0):
  // A = K'^T: tiles (rows r0.., cols c0..), (r0, c0 + 8), (r0 + 8, c0), (r0 + 8, c0 + 8)
  const int a_row = (lane % 8) + 8 * (lane / 16), a_col = 8 * ((lane / 8) % 2);
  // B = V':   tiles (r0, c0), (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8)
  const int b_row = (lane % 8) + 8 * ((lane / 8) % 2), b_col = 8 * (lane / 16);

  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);
  if (row0 < row_end) prefetch(raw, kb, vb, pb, row0, row_end, dk, p);
  int stage = 0;
  for (int c0 = row0; c0 < row_end; c0 += kRowsPerChunk, stage ^= 1) {
    // this chunk's copies have landed and every thread is done with the
    // previous chunk (its ks/vs and its stage buffer)
    cp_async_wait_all();
    __syncthreads();
    if (c0 + kRowsPerChunk < row_end)
      prefetch(raw + (stage ^ 1) * stage_elems, kb, vb, pb, c0 + kRowsPerChunk, row_end,
               dk, p);
    const bf16* cur = raw + stage * stage_elems;
    // each warp normalizes 8 of the chunk's 64 rows: 4 of K, then 4 of V
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* x[kLnBatch];
      const bf16* pos_row[kLnBatch];
      bf16* dst[kLnBatch];
      bool valid[kLnBatch];
#pragma unroll
      for (int u = 0; u < kLnBatch; ++u) {
        const int r = warp + kWarps * u;
        x[u] = cur + (half * kRowsPerChunk + r) * dk;
        pos_row[u] = cur + 2 * kRowsPerChunk * dk + r * p;
        dst[u] = half ? vs[r] : ks[r];
        valid[u] = c0 + r < row_end;
      }
      ln_rows<kLnBatch>(x, affine[2 * half], affine[2 * half + 1], pos_row, dst, valid,
                        dk, p, DP, eps, lane);
    }
    __syncthreads();
#pragma unroll
    for (int r0 = 0; r0 < kRowsPerChunk; r0 += 16) {
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      int a_block = -1;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int q = warp * NB + t;
        if (q < DT * DT) {
          const int mi = q / DT, nj = q % DT;
          if (mi != a_block) {
            ldmatrix_x4_trans(a, &ks[r0 + a_row][16 * mi + a_col]);
            a_block = mi;
          }
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, &vs[r0 + b_row][16 * nj + b_col]);
          mma_bf16(acc[t][0], a, bfrag[0], bfrag[1]);
          mma_bf16(acc[t][1], a, bfrag[2], bfrag[3]);
        }
      }
    }
  }

  // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
  // column 2 * (lane % 4) + e % 2
  float* out = partial + ((size_t)split * BH + bh) * de * de;
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int q = warp * NB + t;
    if (q < DT * DT) {
      const int mi = q / DT, nj = q % DT;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 16 * mi + lane / 4 + 8 * (e / 2);
          const int cj = 16 * nj + 8 * j + 2 * (lane % 4) + e % 2;
          if (ri < de && cj < de) out[ri * de + cj] = acc[t][j][e];
        }
    }
  }
}

// out[i] = sum over splits of partial[split][i], in split order.
__global__ void scores_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int splits, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += partial[(size_t)t * total + i];
  out[i] = s;
}

}  // namespace

// k, v: (B*H, n, dk) contiguous bf16; pos: (B, n, p) bf16 or null with p = 0;
// scale/bias: (H, dk) float32; partial: (splits, B*H, de, de) float32 scratch;
// out: (B*H, de, de) float32.  de = dk + p <= 128, dk <= 128.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int galerkin_scores_bf16_launch(const void* k, const void* v, const void* pos,
                                           const float* scale_k, const float* bias_k,
                                           const float* scale_v, const float* bias_v,
                                           float* partial, float* out, int B, int H,
                                           int n, int dk, int p, int rows_per_split,
                                           int splits, float eps, void* stream) {
  const int de = dk + p;
  if (dk < 1 || dk > kMaxDk || de > 128 || n < 1 || splits < 1 ||
      rows_per_split % kRowsPerChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B * H, splits);
  const int stage_elems = (kRowsPerChunk * (2 * dk + p) + 7) / 8 * 8;
  const int raw_bytes = 2 * stage_elems * (int)sizeof(bf16);
#define GT_SCORES_CASE(T)                                                        \
  case T:                                                                        \
    err = cudaFuncSetAttribute(scores_partial_kernel<T>,                          \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                               raw_bytes);                                        \
    if (err != cudaSuccess) return (int)err;                                     \
    scores_partial_kernel<T><<<grid, kThreads, raw_bytes, s>>>(                  \
        (const bf16*)k, (const bf16*)v, (const bf16*)pos, scale_k, bias_k,       \
        scale_v, bias_v, partial, H, n, dk, p, rows_per_split, eps);             \
    break;
  cudaError_t err;
  switch ((de + 15) / 16) {
    GT_SCORES_CASE(1) GT_SCORES_CASE(2) GT_SCORES_CASE(3) GT_SCORES_CASE(4)
    GT_SCORES_CASE(5) GT_SCORES_CASE(6) GT_SCORES_CASE(7) GT_SCORES_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GT_SCORES_CASE
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * H * de * de;
  scores_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, out, splits, total);
  return (int)cudaGetLastError();
}
