// Galerkin attention scores on Hopper (sm_90a), float32.
//
// Replaces: ops/pallas/galerkin.py of the JAX package,
//   galerkin_scores_pallas -> _scores_kernel.
//
// Computes, for every (batch, head) pair bh,
//   S[bh] = [pos, LN_K(K[bh])]^T [pos, LN_V(V[bh])]      (d_eff x d_eff, unscaled)
// where LN is a per-row LayerNorm over d_k with per-head affine (statistics
// in float32) and pos (B, n, p) is shared by the heads of a batch.
//
// What bounds it: it reads K and V once (2 * BH * n * d_k floats) and does
// 2 * BH * n * d_eff^2 flops on CUDA cores (float32 is pinned to full
// precision, as the TPU kernel pins Precision.HIGHEST).  At d_eff = 97 both
// limits are near each other.  The TPU kernel walks the sequence in order
// into one resident block per bh; with only B*H = 8 such blocks at the ex1
// serving shape that would leave most of the 132 SMs idle.
//
// What the design does about it:
//  * grid (BH, splits): each CTA owns a contiguous range of sequence rows,
//    so the card is filled whatever B*H is;
//  * a CTA walks its rows in chunks of 32: cp.async copies the next chunk
//    of raw K, V and pos rows into shared memory while the CTA works on the
//    current one; then each warp normalizes 4 rows of K and 4 of V with
//    their mean and variance reductions (warp shuffles) interleaved, applies
//    the affine, puts pos in front, and writes zeros for rows past n and
//    columns past d_eff (the ragged last chunk is masked here, no padded
//    copy).  Measured on the card: loading rows straight into registers
//    left HBM latency exposed, and one row at a time per warp left the
//    shuffle latency exposed; each cost more than the product itself;
//  * the d_eff x d_eff partial stays in registers (16 x 16 threads, each a
//    TPT x TPT interleaved tile, d_eff padded to 16 * TPT) and is written
//    once per CTA to a scratch of shape (splits, BH, d_eff, d_eff);
//  * a second kernel sums the splits in a fixed order: the result is the
//    same from run to run (no float atomics).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 8 warps; also a 16 x 16 grid of tiles
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerChunk = 32;  // sequence rows staged per step
constexpr int kMaxDk = 128;        // d_k held in registers by one warp
constexpr int kLnBatch = kRowsPerChunk / kWarps;  // rows a warp normalizes at once

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts the copy of rows [c0, c0 + 32) ∩ [c0, row_end) of K, V and pos into
// one stage buffer: K rows at [0, 32 dk), V rows at [32 dk, 64 dk), pos rows
// after them.  The copies run while the CTA computes the previous chunk.
__device__ __forceinline__ void prefetch(float* stage, const float* kb,
                                         const float* vb, const float* pb,
                                         int c0, int row_end, int dk, int p) {
  const int rows = min(kRowsPerChunk, row_end - c0);
  const float* ks = kb + (size_t)c0 * dk;
  const float* vs = vb + (size_t)c0 * dk;
  if ((dk % 4) == 0 && (reinterpret_cast<size_t>(ks) % 16) == 0 &&
      (reinterpret_cast<size_t>(vs) % 16) == 0) {
    for (int i = 4 * threadIdx.x; i < rows * dk; i += 4 * kThreads) {
      cp_async16(stage + i, ks + i);
      cp_async16(stage + kRowsPerChunk * dk + i, vs + i);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dk; i += kThreads) {
      cp_async4(stage + i, ks + i);
      cp_async4(stage + kRowsPerChunk * dk + i, vs + i);
    }
  }
  float* ps = stage + 2 * kRowsPerChunk * dk;
  for (int i = threadIdx.x; i < rows * p; i += kThreads)
    cp_async4(ps + i, pb + (size_t)c0 * p + i);
  cp_async_commit();
}

// One warp normalizes kBatch rows at once (their reductions interleave, so
// the shuffle latency of one row hides behind the others).  Row u of the
// batch is x[u] (d_k floats in shared memory), written to dst[u] (dp floats)
// as [pos_row (p), LN(x) * scale + bias (d_k), zeros]; an invalid row (past
// the end of the sequence) is written as zeros.
template <int kBatch>
__device__ __forceinline__ void ln_rows(const float* const (&x)[kBatch],
                                        const float* scale, const float* bias,
                                        const float* const (&pos_row)[kBatch],
                                        float* const (&dst)[kBatch],
                                        const bool (&valid)[kBatch], int dk,
                                        int p, int dp, float eps, int lane) {
  constexpr int kPer = kMaxDk / 32;
  float xv[kBatch][kPer], mean[kBatch], q[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    mean[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      xv[u][t] = (valid[u] && c < dk) ? x[u][c] : 0.f;
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
      if (c < dk)
        dst[u][p + c] = valid[u] ? (xv[u][t] - mean[u]) * rstd * scale[c] + bias[c] : 0.f;
    }
    for (int c = lane; c < p; c += 32) dst[u][c] = valid[u] ? pos_row[u][c] : 0.f;
    for (int c = p + dk + lane; c < dp; c += 32) dst[u][c] = 0.f;
  }
}

template <int TPT>
__global__ void __launch_bounds__(kThreads, 2)
scores_partial_kernel(const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ pos,
                      const float* __restrict__ scale_k, const float* __restrict__ bias_k,
                      const float* __restrict__ scale_v, const float* __restrict__ bias_v,
                      float* __restrict__ partial, int H, int n, int dk, int p,
                      int rows_per_split, float eps) {
  constexpr int DP = 16 * TPT;
  __shared__ float ks[kRowsPerChunk][DP];
  __shared__ float vs[kRowsPerChunk][DP];
  __shared__ float affine[4][kMaxDk];  // scale_k, bias_k, scale_v, bias_v
  extern __shared__ __align__(16) float raw[];  // 2 stages of raw K, V, pos rows
  const int stage_floats = kRowsPerChunk * (2 * dk + p);

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * n * dk;
  const float* vb = v + (size_t)bh * n * dk;
  const float* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;

  for (int c = threadIdx.x; c < dk; c += kThreads) {
    affine[0][c] = scale_k[h * dk + c];
    affine[1][c] = bias_k[h * dk + c];
    affine[2][c] = scale_v[h * dk + c];
    affine[3][c] = bias_v[h * dk + c];
  }

  float acc[TPT][TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < TPT; ++j) acc[i][j] = 0.f;

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
      prefetch(raw + (stage ^ 1) * stage_floats, kb, vb, pb, c0 + kRowsPerChunk,
               row_end, dk, p);
    const float* cur = raw + stage * stage_floats;
    // each warp normalizes 8 of the chunk's 64 rows: 4 of K, then 4 of V
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* x[kLnBatch];
      const float* pos_row[kLnBatch];
      float* dst[kLnBatch];
      bool valid[kLnBatch];
#pragma unroll
      for (int u = 0; u < kLnBatch; ++u) {
        const int r = warp + kWarps * u;
        x[u] = cur + (half * kRowsPerChunk + r) * dk;
        pos_row[u] = cur + 2 * kRowsPerChunk * dk + r * p;
        dst[u] = half ? vs[r] : ks[r];
        valid[u] = c0 + r < row_end;
      }
      ln_rows<kLnBatch>(x, affine[2 * half], affine[2 * half + 1], pos_row, dst,
                        valid, dk, p, DP, eps, lane);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRowsPerChunk; ++r) {
      float a[TPT], c[TPT];
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        a[i] = ks[r][ty + 16 * i];
        c[i] = vs[r][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < TPT; ++i)
#pragma unroll
        for (int j = 0; j < TPT; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }

  float* out = partial + ((size_t)split * BH + bh) * de * de;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int cj = tx + 16 * j;
      if (ri < de && cj < de) out[ri * de + cj] = acc[i][j];
    }
  }
}

// out[i] = sum over splits of partial[split][i], in split order.
__global__ void scores_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int splits,
                                     int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += partial[(size_t)t * total + i];
  out[i] = s;
}

}  // namespace

// k, v: (B*H, n, dk) contiguous; pos: (B, n, p) or null with p = 0;
// scale/bias: (H, dk); partial: (splits, B*H, de, de) scratch;
// out: (B*H, de, de).  de = dk + p <= 128, dk <= 128.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int galerkin_scores_launch(const float* k, const float* v,
                                      const float* pos, const float* scale_k,
                                      const float* bias_k, const float* scale_v,
                                      const float* bias_v, float* partial,
                                      float* out, int B, int H, int n, int dk,
                                      int p, int rows_per_split, int splits,
                                      float eps, void* stream) {
  const int de = dk + p;
  if (dk < 1 || dk > kMaxDk || de > 128 || n < 1 || splits < 1 ||
      rows_per_split % kRowsPerChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B * H, splits);
  const int raw_bytes = 2 * kRowsPerChunk * (2 * dk + p) * (int)sizeof(float);
#define GT_SCORES_CASE(T)                                                    \
  case T:                                                                    \
    err = cudaFuncSetAttribute(scores_partial_kernel<T>,                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               raw_bytes);                                    \
    if (err != cudaSuccess) return (int)err;                                 \
    scores_partial_kernel<T><<<grid, kThreads, raw_bytes, s>>>(              \
        k, v, pos, scale_k, bias_k, scale_v, bias_v, partial, H, n, dk, p,   \
        rows_per_split, eps);                                                \
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
