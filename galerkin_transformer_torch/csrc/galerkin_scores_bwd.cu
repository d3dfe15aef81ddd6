// Backward of the Galerkin attention scores on Hopper (sm_90a), float32.
//
// Replaces: ops/pallas/galerkin.py of the JAX package, _scores_bwd with
//   _ln_bwd (the custom VJP of galerkin_scores_fused, plain XLA there).
//
// The forward (csrc/galerkin_scores.cu) is S = K'^T V' per bh, with
// K' = [pos, LN_K(K)] and V' = [pos, LN_V(V)] (n x d_eff).  Given dS
// (d_eff x d_eff per bh), this computes for every sequence row r
//   dV'_r = K'_r dS,   dK'_r = V'_r dS^T
// and from them
//   dk_r  = rstd (gy - mean(gy) - xhat mean(gy xhat)),  gy = dK'_r[p:] scale_k
//   (dv_r the same with V), the LayerNorm's own input gradient;
//   dscale_k = sum over batch and rows of dK'[p:] xhat, dbias_k = sum dK'[p:]
//   (and for V), one row of d_k per head;
//   dpos_r = dK'_r[:p] + dV'_r[:p], summed over the heads of a batch.
// Nothing but the raw K, V, pos and LN parameters is saved by the forward:
// LN is recomputed here.
//
// What bounds it: operations.  The two row-by-matrix products are
// 4 * BH * n * d_eff^2 flops in float32 on CUDA cores (the TPU pins
// Precision.HIGHEST; TF32 would change the numerics), against ~4 BH n d_k
// floats moved (read k, v; write dk, dv).  At (B, H, n, d_k, p) =
// (8, 1, 8192, 96, 1) that is 2.5 GFLOP (37 us at 67 TFLOP/s) against
// 101 MB (30 us at 3.35 TB/s).
//
// What the design does about it (simple first):
//  * grid (BH, splits): each CTA owns a contiguous range of rows, walked in
//    chunks of 32, so the card is filled whatever B*H is (the TPU walks the
//    sequence in order per bh);
//  * dS is loaded once per CTA into shared memory, padded with zeros to
//    16 * TPT and stored with an odd row stride, so that reading a row of
//    dS and reading a column of it (for dS^T) are both free of bank
//    conflicts;
//  * per chunk: (A) each warp normalizes 4 rows of K and 4 of V with their
//    reductions interleaved and keeps xhat and rstd in registers; the
//    concatenated rows K', V' go to shared memory;  (B) every thread forms
//    2 rows x TPT columns of dV' and of dK' over the d_eff inner dimension,
//    and writes them back over K', V';  (C) the warps of (A) run the
//    LayerNorm backward for the same rows from their registers, write dk
//    and dv, and add the affine gradients to per-lane sums;
//  * the affine gradients leave each CTA as one partial (warps summed in
//    order), and a second kernel sums the partials over batch and splits in
//    a fixed order; dpos goes out per head and is summed over heads in a
//    fixed order too.  No float atomics: the result is the same from run
//    to run.
// Measured on an H100 SXM (700 W) at the shape above: 0.227 ms, 5.6x the
// bound and 2x two cuBLAS products on precomputed K', V'.  The product loop
// issues 18 shared loads per 28 FMAs, and keeping xhat in registers across
// it spills 72-160 bytes: those are what to cut first.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                    // 8 warps; a 16 x 16 grid in (B)
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                        // sequence rows per chunk
constexpr int kMaxDk = 128;
constexpr int kPer = kMaxDk / 32;                // columns per lane in (A), (C)
constexpr int kRowsPerWarp = kRows / kWarps;     // 4 rows of K and 4 of V

// Sums each of the kN values across the warp; the shuffles of the kN sums
// interleave, so one sum's latency hides behind the others.
template <int kN>
__device__ __forceinline__ void warp_sum(float (&x)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
}

template <int TPT>
__global__ void __launch_bounds__(kThreads, 2)
scores_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ pos,
                  const float* __restrict__ scale_k, const float* __restrict__ bias_k,
                  const float* __restrict__ scale_v, const float* __restrict__ bias_v,
                  const float* __restrict__ ds, float* __restrict__ dk_out,
                  float* __restrict__ dv_out, float* __restrict__ dpos_h,
                  float* __restrict__ partial, int H, int n, int dk, int p,
                  int rows_per_split, float eps) {
  constexpr int DP = 16 * TPT;  // d_eff padded
  constexpr int LD = DP + 1;    // odd row stride
  extern __shared__ float smem[];
  float* dS = smem;             // DP x LD, zeros past d_eff
  float* tk = dS + DP * LD;     // kRows x LD: K' rows, then dK'
  float* tv = tk + kRows * LD;  // kRows x LD: V' rows, then dV'
  float* red = tv + kRows * LD; // kWarps x 4 x dk: per-warp affine sums
  __shared__ float affine[4][kMaxDk];  // scale_k, bias_k, scale_v, bias_v

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const float* kb = k + (size_t)bh * n * dk;
  const float* vb = v + (size_t)bh * n * dk;
  const float* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;

  for (int c = tid; c < dk; c += kThreads) {
    affine[0][c] = scale_k[h * dk + c];
    affine[1][c] = bias_k[h * dk + c];
    affine[2][c] = scale_v[h * dk + c];
    affine[3][c] = bias_v[h * dk + c];
  }
  const float* dsb = ds + (size_t)bh * de * de;
  for (int i = tid; i < DP * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dS[r * LD + c] = (r < de && c < de) ? dsb[r * de + c] : 0.f;
  }

  float acc[4][kPer];  // dscale_k, dbias_k, dscale_v, dbias_v at lane + 32 t
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[q][t] = 0.f;

  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);
  for (int c0 = row0; c0 < row_end; c0 += kRows) {
    // (A) LayerNorm of rows warp + 8 u of K and of V (u < 4), kept as xhat
    float xk[kRowsPerWarp][kPer], xv[kRowsPerWarp][kPer];
    float sk[kRowsPerWarp], sv[kRowsPerWarp];
    bool valid[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int row = c0 + warp + kWarps * u;
      valid[u] = row < row_end;
      sk[u] = sv[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        const bool in = valid[u] && c < dk;
        xk[u][t] = in ? kb[(size_t)row * dk + c] : 0.f;
        xv[u][t] = in ? vb[(size_t)row * dk + c] : 0.f;
        sk[u] += xk[u][t];
        sv[u] += xv[u][t];
      }
    }
    warp_sum(sk);
    warp_sum(sv);
    float qk[kRowsPerWarp], qv[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const float mk = sk[u] / dk, mv = sv[u] / dk;
      qk[u] = qv[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const bool in = lane + 32 * t < dk;
        xk[u][t] = in ? xk[u][t] - mk : 0.f;
        xv[u][t] = in ? xv[u][t] - mv : 0.f;
        qk[u] += xk[u][t] * xk[u][t];
        qv[u] += xv[u][t] * xv[u][t];
      }
    }
    warp_sum(qk);
    warp_sum(qv);
    float rk[kRowsPerWarp], rv[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      rk[u] = rsqrtf(qk[u] / dk + eps);
      rv[u] = rsqrtf(qv[u] / dk + eps);
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        xk[u][t] *= rk[u];
        xv[u][t] *= rv[u];
      }
    }
    __syncthreads();  // every thread is done with the last chunk's tiles
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = warp + kWarps * u, row = c0 + r;
      float* krow = tk + r * LD;
      float* vrow = tv + r * LD;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) {
          krow[p + c] = valid[u] ? xk[u][t] * affine[0][c] + affine[1][c] : 0.f;
          vrow[p + c] = valid[u] ? xv[u][t] * affine[2][c] + affine[3][c] : 0.f;
        }
      }
      for (int c = lane; c < p; c += 32)
        krow[c] = vrow[c] = valid[u] ? pb[(size_t)row * p + c] : 0.f;
    }
    __syncthreads();

    // (B) dV' = K' dS and dK' = V' dS^T for rows ty, ty + 16 and columns
    // tx + 16 j; d_eff is the inner dimension
    float gk[2][TPT], gv[2][TPT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < TPT; ++j) gk[i][j] = gv[i][j] = 0.f;
    const float* k0 = tk + ty * LD;
    const float* k1 = tk + (ty + 16) * LD;
    const float* v0 = tv + ty * LD;
    const float* v1 = tv + (ty + 16) * LD;
#pragma unroll 2
    for (int kk = 0; kk < de; ++kk) {
      const float a0 = k0[kk], a1 = k1[kk], b0 = v0[kk], b1 = v1[kk];
#pragma unroll
      for (int j = 0; j < TPT; ++j) {
        const int c = tx + 16 * j;
        const float s = dS[kk * LD + c];   // dS[kk][c]
        const float st = dS[c * LD + kk];  // dS^T[kk][c]
        gv[0][j] = fmaf(a0, s, gv[0][j]);
        gv[1][j] = fmaf(a1, s, gv[1][j]);
        gk[0][j] = fmaf(b0, st, gk[0][j]);
        gk[1][j] = fmaf(b1, st, gk[1][j]);
      }
    }
    __syncthreads();  // every thread is done reading K', V'
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int c = tx + 16 * j;
      tk[ty * LD + c] = gk[0][j];
      tk[(ty + 16) * LD + c] = gk[1][j];
      tv[ty * LD + c] = gv[0][j];
      tv[(ty + 16) * LD + c] = gv[1][j];
    }
    __syncthreads();

    // (C) LayerNorm backward of (A)'s rows, from its registers
    float gyk[kRowsPerWarp][kPer], gyv[kRowsPerWarp][kPer];
    float mk[kRowsPerWarp], mv[kRowsPerWarp], mxk[kRowsPerWarp], mxv[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = warp + kWarps * u;
      mk[u] = mv[u] = mxk[u] = mxv[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        const bool in = valid[u] && c < dk;
        const float g_k = in ? tk[r * LD + p + c] : 0.f;
        const float g_v = in ? tv[r * LD + p + c] : 0.f;
        if (in) {
          acc[0][t] = fmaf(g_k, xk[u][t], acc[0][t]);
          acc[1][t] += g_k;
          acc[2][t] = fmaf(g_v, xv[u][t], acc[2][t]);
          acc[3][t] += g_v;
        }
        gyk[u][t] = in ? g_k * affine[0][c] : 0.f;
        gyv[u][t] = in ? g_v * affine[2][c] : 0.f;
        mk[u] += gyk[u][t];
        mv[u] += gyv[u][t];
        mxk[u] += gyk[u][t] * xk[u][t];
        mxv[u] += gyv[u][t] * xv[u][t];
      }
    }
    warp_sum(mk);
    warp_sum(mv);
    warp_sum(mxk);
    warp_sum(mxv);
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      if (!valid[u]) continue;
      const int r = warp + kWarps * u, row = c0 + r;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) {
          dk_out[((size_t)bh * n + row) * dk + c] =
              rk[u] * (gyk[u][t] - mk[u] / dk - xk[u][t] * (mxk[u] / dk));
          dv_out[((size_t)bh * n + row) * dk + c] =
              rv[u] * (gyv[u][t] - mv[u] / dk - xv[u][t] * (mxv[u] / dk));
        }
      }
      if (dpos_h != nullptr)
        for (int c = lane; c < p; c += 32)
          dpos_h[((size_t)bh * n + row) * p + c] = tk[r * LD + c] + tv[r * LD + c];
    }
  }

  // this CTA's affine gradients: the warps' sums added in warp order
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      if (c < dk) red[(warp * 4 + q) * dk + c] = acc[q][t];
    }
  __syncthreads();
  float* out = partial + ((size_t)split * BH + bh) * 4 * dk;
  for (int i = tid; i < 4 * dk; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 4 * dk + i];
    out[i] = s;
  }
}

// dparams[q][h][c] = sum over b, then split, of partial[split][b H + h][q][c]
// (q: dscale_k, dbias_k, dscale_v, dbias_v), in that fixed order.
__global__ void params_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dparams, int B, int H,
                                     int dk, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * H * dk) return;
  const int q = i / (H * dk), h = (i / dk) % H, c = i % dk;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int sp = 0; sp < splits; ++sp)
      s += partial[((size_t)sp * B * H + b * H + h) * 4 * dk + q * dk + c];
  dparams[i] = s;
}

// dpos[b][r][c] = sum over heads h, in order, of dpos_h[b H + h][r][c].
__global__ void dpos_reduce_kernel(const float* __restrict__ dpos_h,
                                   float* __restrict__ dpos, int B, int H,
                                   int n, int p) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)n * p;
  if (i >= (size_t)B * per_b) return;
  const size_t b = i / per_b, rest = i % per_b;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += dpos_h[(b * H + h) * per_b + rest];
  dpos[i] = s;
}

template <int TPT>
int launch(const float* k, const float* v, const float* pos, const float* scale_k,
           const float* bias_k, const float* scale_v, const float* bias_v,
           const float* ds, float* dk_out, float* dv_out, float* dpos_h,
           float* partial, int B, int H, int n, int dk, int p,
           int rows_per_split, int splits, float eps, cudaStream_t stream) {
  constexpr int LD = 16 * TPT + 1;
  const int bytes =
      (int)(((size_t)16 * TPT * LD + 2 * kRows * LD + kWarps * 4 * dk) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      scores_bwd_kernel<TPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, splits);
  scores_bwd_kernel<TPT><<<grid, kThreads, bytes, stream>>>(
      k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, dk_out, dv_out, dpos_h,
      partial, H, n, dk, p, rows_per_split, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// k, v: (B*H, n, dk) contiguous; pos: (B, n, p) or null with p = 0;
// scale/bias: (H, dk); ds: (B*H, de, de) with de = dk + p <= 128, dk <= 128.
// Outputs: dk_out, dv_out (B*H, n, dk); dparams (4, H, dk) = dscale_k,
// dbias_k, dscale_v, dbias_v; dpos (B, n, p), written only when dpos is not
// null, through the scratch dpos_h (B*H, n, p).  partial: (splits, B*H, 4,
// dk) scratch.  Returns the CUDA error code of the launches (0 on success).
extern "C" int galerkin_scores_bwd_launch(
    const float* k, const float* v, const float* pos, const float* scale_k,
    const float* bias_k, const float* scale_v, const float* bias_v,
    const float* ds, float* dk_out, float* dv_out, float* dpos_h, float* dpos,
    float* partial, float* dparams, int B, int H, int n, int dk, int p,
    int rows_per_split, int splits, float eps, void* stream) {
  const int de = dk + p;
  if (dk < 1 || dk > kMaxDk || de > 128 || n < 1 || B < 1 || H < 1 ||
      splits < 1 || rows_per_split % kRows != 0 || (p > 0) != (pos != nullptr) ||
      (dpos != nullptr && (p == 0 || dpos_h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* scratch = dpos != nullptr ? dpos_h : nullptr;
  int err;
  switch ((de + 15) / 16) {
#define GT_BWD_CASE(T)                                                         \
  case T:                                                                      \
    err = launch<T>(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, dk_out,   \
                    dv_out, scratch, partial, B, H, n, dk, p, rows_per_split,  \
                    splits, eps, s);                                           \
    break;
    GT_BWD_CASE(1) GT_BWD_CASE(2) GT_BWD_CASE(3) GT_BWD_CASE(4)
    GT_BWD_CASE(5) GT_BWD_CASE(6) GT_BWD_CASE(7) GT_BWD_CASE(8)
#undef GT_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int total = 4 * H * dk;
  params_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, dparams, B, H,
                                                           dk, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dpos != nullptr) {
    const size_t m = (size_t)B * n * p;
    dpos_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, dpos, B,
                                                                   H, n, p);
    e = cudaGetLastError();
  }
  return (int)e;
}
