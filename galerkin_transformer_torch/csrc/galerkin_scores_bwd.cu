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
// 101 MB (30 us at 3.35 TB/s).  At the ex2 training shape (4, 4, 1849, 32,
// 2) it is 15 MB and 0.14 GFLOP: a few microseconds of either, so there
// the latency of one pass over a few chunks per CTA sets the time.
//
// What the design does about it:
//  * grid (BH, splits): each CTA owns a contiguous range of rows, walked in
//    chunks of 64; the wrapper sizes `splits` so that the CTAs fit on the
//    card at once (galerkin_scores_bwd_ctas_per_sm);
//  * dS is loaded once per CTA into shared memory, zero-padded to d_eff
//    rounded up to a multiple of 8 (DP), row stride DP + 4;
//  * cp.async copies bring the next chunk's raw K, V and pos rows into a
//    second stage buffer while the CTA works on the current chunk
//    (one buffer, and no overlap, only where two do not fit: DP = 128 with
//    d_k above ~88);
//  * per chunk: (A) each warp normalizes 8 rows of K and 8 of V (4 and 4,
//    twice, at d_k <= 32 and d_k > 96) with their reductions interleaved,
//    writes K' and V' to shared memory and each row's mean and rstd beside
//    them; nothing of it stays in registers;  (B) warps 0-3 form dV' = K' dS and warps 4-7 form
//    dK' = V' dS^T, each thread a 4-row x DP/8-column tile of one product,
//    reading K', V' and (for dK') dS as float4 along the inner dimension:
//    per 4 steps of it, 4 + DP/8 float4 loads (dK') or 4 float4 and DP/2
//    scalar loads (dV') for 2 DP FMAs; the results overwrite K', V';  (C)
//    the warps of (A) rebuild xhat from the raw rows still in the stage
//    buffer and the saved mean and rstd, run the LayerNorm backward, write
//    dk and dv, and add the affine gradients to per-lane sums (4 x d_k/32
//    registers, the only state kept across chunks);
//  * the LN stages are templated on d_k/32 rounded up (1..4) and the
//    product on DP/8 (1..16), so no register holds padding;
//  * the affine gradients leave each CTA as one partial (warps summed in
//    order); the last CTA of each bh to finish (a ticket taken with an
//    integer atomic after a fence) sums that bh's partials over the splits,
//    and the last of those sums them over the batch, each sum in a fixed
//    order, and resets the tickets: a call is one launch and the result is
//    the same from run to run (no float atomics).  dpos goes out per head
//    and a second kernel sums it over heads in a fixed order, only when it
//    is asked for.
// Shared memory per CTA: 201,600 bytes at (d_k, p) = (96, 1), one CTA per
// SM; 64,896 bytes at (32, 2), two CTAs per SM (registers capped at 128).
// Its time against two cuBLAS products: `chip_smoke.py`; against the
// two-launch kernel it replaces: `chip_smoke.py --against` (PERF.md, row 1b).
// At the ex1 width the product and the two LN stages take about half the
// time each; the LN stages run at one CTA (8 warps) per SM there, so their
// latency is not hidden: that is what to cut next.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // sequence rows per chunk
constexpr int kGroup = kThreads / 2;       // threads per product in (B)
constexpr int kTileRows = 4;               // rows of a thread's tile in (B)
constexpr int kRowGroups = kRows / kTileRows;       // 16
constexpr int kColGroups = kGroup / kRowGroups;     // 8: columns c = cg + 8 j
// rows of each matrix a warp normalizes at once, their reductions interleaved
// (8 where the registers allow it: one pass over the chunk's 64 rows; at
// d_k <= 32 the kernel is held to 128 registers, and 8 rows spill there)
__host__ __device__ constexpr int ln_batch(int C) { return C == 2 || C == 3 ? 8 : 4; }
constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;

static_assert(kColGroups == 8, "DP is a multiple of 8: one column group per 8 columns");

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
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sums each of the kN values across the warp; the shuffles of the kN sums
// interleave, so one sum's latency hides behind the others.
template <int kN>
__device__ __forceinline__ void warp_sum(float (&x)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
}

// The sum of src[j * stride] over j < terms, in order, with 16 loads in
// flight before any is added (the partials were written by other CTAs: read
// through L2).
__device__ __forceinline__ float ordered_sum(const float* src, size_t stride, int terms) {
  constexpr int kInFlight = 16;
  float s = 0.f;
  for (int j0 = 0; j0 < terms; j0 += kInFlight) {
    float x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      x[u] = j0 + u < terms ? __ldcg(src + (size_t)(j0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (j0 + u < terms) s += x[u];
  }
  return s;
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Floats of the dynamic shared memory: dS (DP x LD), the K' and V' tiles
// (kRows x LD each), the row statistics (4 x kRows), the LN parameters
// (4 x dk), then nbuf stage buffers of raw K, V and pos rows.
__host__ __device__ constexpr int stage_floats(int dk, int p) {
  return 2 * kRows * dk + kRows * p;
}
__host__ __device__ constexpr int smem_floats(int dp, int dk, int p, int nbuf) {
  return dp * (dp + 4) + 2 * kRows * (dp + 4) + 4 * kRows + 4 * dk +
         nbuf * stage_floats(dk, p);
}

// Starts the copy of rows [c0, min(c0 + kRows, row_end)) of K, V and pos
// into a stage buffer: K rows at [0, kRows dk), V rows after them, then pos.
// K and V go 16 bytes per copy where their rows allow it; pos (a few floats
// per row) 4 bytes per copy.
__device__ __forceinline__ void prefetch(float* stage, const float* kb, const float* vb,
                                         const float* pb, int c0, int row_end, int dk,
                                         int p) {
  const int rows = min(kRows, row_end - c0);
  const float* ks = kb + (size_t)c0 * dk;
  const float* vs = vb + (size_t)c0 * dk;
  if (dk % 4 == 0 && reinterpret_cast<size_t>(ks) % 16 == 0 &&
      reinterpret_cast<size_t>(vs) % 16 == 0) {
    for (int i = 4 * threadIdx.x; i < rows * dk; i += 4 * kThreads) {
      cp_async16(stage + i, ks + i);
      cp_async16(stage + kRows * dk + i, vs + i);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dk; i += kThreads) {
      cp_async4(stage + i, ks + i);
      cp_async4(stage + kRows * dk + i, vs + i);
    }
  }
  float* ps = stage + 2 * kRows * dk;
  for (int i = threadIdx.x; i < rows * p; i += kThreads)
    cp_async4(ps + i, pb + (size_t)c0 * p + i);
  cp_async_commit();
}

// (A): rows warp + kWarps (kB j + u) of K and of V (kB = ln_batch(C)),
// normalized from the
// stage buffer into the tiles as [pos, LN(x) scale + bias, zeros to DP];
// rows past row_end are written as zeros.  stats holds mean_k, rstd_k,
// mean_v, rstd_v of every row (kRows each).
template <int C>
__device__ __forceinline__ void ln_forward(const float* stage, const float* affine,
                                           float* tk, float* tv, float* stats, int c0,
                                           int row_end, int dk, int p, int dp, int ld,
                                           float eps, int warp, int lane) {
  const float* src[2] = {stage, stage + kRows * dk};
  float* dst[2] = {tk, tv};
  const float* ps = stage + 2 * kRows * dk;
  constexpr int kB = ln_batch(C), kPasses = kRows / (kWarps * kB);
  const float inv_dk = 1.f / dk;
#pragma unroll 1
  for (int j = 0; j < kPasses; ++j) {
    float x[2][kB][C], s[2 * kB], q[2 * kB];
    int r[kB];
    bool valid[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      r[u] = warp + kWarps * (kB * j + u);
      valid[u] = c0 + r[u] < row_end;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        s[m * kB + u] = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = lane + 32 * t;
          x[m][u][t] = (valid[u] && c < dk) ? src[m][r[u] * dk + c] : 0.f;
          s[m * kB + u] += x[m][u][t];
        }
      }
    }
    warp_sum(s);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const float mean = s[m * kB + u] * inv_dk;
        s[m * kB + u] = mean;
        q[m * kB + u] = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          x[m][u][t] = lane + 32 * t < dk ? x[m][u][t] - mean : 0.f;
          q[m * kB + u] += x[m][u][t] * x[m][u][t];
        }
      }
    warp_sum(q);
    // every load before the first store: the stores go to shared memory too,
    // so the compiler cannot move a load above one, and each row would wait
    // for the stores of the last
    float scale[2][C], bias[2][C], pv[kB];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int c = min(lane + 32 * t, dk - 1);
        scale[m][t] = affine[2 * m * dk + c];
        bias[m][t] = affine[(2 * m + 1) * dk + c];
      }
#pragma unroll
    for (int u = 0; u < kB; ++u) pv[u] = valid[u] && lane < p ? ps[r[u] * p + lane] : 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const float rstd = rsqrtf(q[m * kB + u] * inv_dk + eps);
        float* row = dst[m] + r[u] * ld;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = lane + 32 * t;
          if (c < dk)
            row[p + c] = valid[u] ? x[m][u][t] * rstd * scale[m][t] + bias[m][t] : 0.f;
        }
        if (lane < p) row[lane] = pv[u];
        for (int c = lane + 32; c < p; c += 32) row[c] = valid[u] ? ps[r[u] * p + c] : 0.f;
        for (int c = p + dk + lane; c < dp; c += 32) row[c] = 0.f;
        if (lane == 0) {
          stats[2 * m * kRows + r[u]] = s[m * kB + u];
          stats[(2 * m + 1) * kRows + r[u]] = rstd;
        }
      }
  }
}

// (B): threads [0, kGroup) form dV' = K' dS, threads [kGroup, 2 kGroup)
// dK' = V' dS^T, each the rows rg + 16 i (i < 4) and columns cg + 8 j
// (j < T8) of its product, the inner dimension in steps of 4 (float4).  The
// sums run over the inner dimension in order.  dV' then overwrites V' and
// dK' overwrites K'.
template <int T8>
__device__ __forceinline__ void products(const float* dS, float* tk, float* tv, int tid) {
  constexpr int DP = 8 * T8, LD = DP + 4;
  const int group = tid / kGroup, t = tid % kGroup;
  const int cg = t % kColGroups, rg = t / kColGroups;
  const float* a = (group == 0 ? tk : tv) + rg * LD;
  float acc[kTileRows][T8];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < T8; ++j) acc[i][j] = 0.f;
  if (group == 0) {   // dV'[r][c] = sum_kk K'[r][kk] dS[kk][c]
#pragma unroll 1
    for (int kk = 0; kk < DP; kk += 4) {
      float4 x[kTileRows];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        x[i] = *reinterpret_cast<const float4*>(a + i * kRowGroups * LD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* srow = dS + (kk + u) * LD + cg;
#pragma unroll
        for (int j = 0; j < T8; ++j) {
          const float s = srow[kColGroups * j];
#pragma unroll
          for (int i = 0; i < kTileRows; ++i) acc[i][j] = fmaf(lane4(x[i], u), s, acc[i][j]);
        }
      }
    }
  } else {            // dK'[r][c] = sum_kk V'[r][kk] dS[c][kk]
#pragma unroll 1
    for (int kk = 0; kk < DP; kk += 4) {
      float4 x[kTileRows];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        x[i] = *reinterpret_cast<const float4*>(a + i * kRowGroups * LD + kk);
#pragma unroll
      for (int j = 0; j < T8; ++j) {
        const float4 s =
            *reinterpret_cast<const float4*>(dS + (cg + kColGroups * j) * LD + kk);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          acc[i][j] = fmaf(x[i].x, s.x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, s.y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, s.z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, s.w, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done reading K', V'
  float* out = (group == 0 ? tv : tk) + rg * LD + cg;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < T8; ++j) out[i * kRowGroups * LD + kColGroups * j] = acc[i][j];
}

// (C): the LayerNorm backward of (A)'s rows.  xhat is rebuilt from the raw
// row in the stage buffer and the row's mean and rstd, exactly as (A) formed
// it; g = dK'[p:] (tk) or dV'[p:] (tv).  acc[2m], acc[2m+1] (m = 0 for K,
// 1 for V) gather the affine gradients at columns lane + 32 t.
template <int C>
__device__ __forceinline__ void ln_backward(const float* stage, const float* affine,
                                            const float* tk, const float* tv,
                                            const float* stats, float* dk_out,
                                            float* dv_out, float* dpos_h,
                                            float (&acc)[4][C], size_t row_base, int c0,
                                            int row_end, int dk, int p, int ld, int warp,
                                            int lane) {
  const float* src[2] = {stage, stage + kRows * dk};
  const float* grad[2] = {tk, tv};
  float* out[2] = {dk_out, dv_out};
  constexpr int kB = ln_batch(C), kPasses = kRows / (kWarps * kB);
  const float inv_dk = 1.f / dk;
#pragma unroll 1
  for (int j = 0; j < kPasses; ++j) {
    float xh[2][kB][C], gy[2][kB][C], rstd[2][kB];
    float sums[4 * kB];  // sum gy (K, V), then sum gy xhat (K, V)
    int r[kB];
    bool valid[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      r[u] = warp + kWarps * (kB * j + u);
      valid[u] = c0 + r[u] < row_end;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float mean = stats[2 * m * kRows + r[u]];
        rstd[m][u] = stats[(2 * m + 1) * kRows + r[u]];
        float sg = 0.f, sgx = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = lane + 32 * t;
          const bool in = valid[u] && c < dk;
          const float xhat = in ? (src[m][r[u] * dk + c] - mean) * rstd[m][u] : 0.f;
          const float g = in ? grad[m][r[u] * ld + p + c] : 0.f;
          if (in) {
            acc[2 * m][t] = fmaf(g, xhat, acc[2 * m][t]);
            acc[2 * m + 1][t] += g;
          }
          xh[m][u][t] = xhat;
          gy[m][u][t] = in ? g * affine[2 * m * dk + c] : 0.f;
          sg += gy[m][u][t];
          sgx += gy[m][u][t] * xhat;
        }
        sums[m * kB + u] = sg;
        sums[(2 + m) * kB + u] = sgx;
      }
    }
    warp_sum(sums);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!valid[u]) continue;
      const size_t row = row_base + c0 + r[u];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float mg = sums[m * kB + u] * inv_dk;
        const float mgx = sums[(2 + m) * kB + u] * inv_dk;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = lane + 32 * t;
          if (c < dk)
            out[m][row * dk + c] = rstd[m][u] * (gy[m][u][t] - mg - xh[m][u][t] * mgx);
        }
      }
      if (dpos_h != nullptr)
        for (int c = lane; c < p; c += 32)
          dpos_h[row * p + c] = tk[r[u] * ld + c] + tv[r[u] * ld + c];
    }
  }
}

// Two CTAs per SM (registers capped at 128) where that cap holds without
// spills, as -Xptxas -v shows it: d_k <= 32 and 24 < d_eff <= 64 (the ex2
// width).  Elsewhere one, with up to 255 registers.
__host__ __device__ constexpr int min_ctas(int C, int T8) {
  return C == 1 && T8 >= 4 && T8 <= 8 ? 2 : 1;
}

template <int C, int T8>
__global__ void __launch_bounds__(kThreads, min_ctas(C, T8))
scores_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ pos,
                  const float* __restrict__ scale_k, const float* __restrict__ bias_k,
                  const float* __restrict__ scale_v, const float* __restrict__ bias_v,
                  const float* __restrict__ ds, float* __restrict__ dk_out,
                  float* __restrict__ dv_out, float* __restrict__ dpos_h,
                  float* __restrict__ partial, float* __restrict__ dparams,
                  int* __restrict__ tickets, int B, int H, int n, int dk, int p,
                  int rows_per_split, int nbuf, float eps) {
  constexpr int DP = 8 * T8, LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* dS = smem;                    // DP x LD, zeros past d_eff
  float* tk = dS + DP * LD;            // kRows x LD: K', then dK'
  float* tv = tk + kRows * LD;         // kRows x LD: V', then dV'
  float* stats = tv + kRows * LD;      // 4 x kRows: mean_k, rstd_k, mean_v, rstd_v
  float* affine = stats + 4 * kRows;   // 4 x dk: scale_k, bias_k, scale_v, bias_v
  float* stage0 = affine + 4 * dk;     // nbuf x stage_floats(dk, p)
  const int stage_size = stage_floats(dk, p);
  __shared__ bool last;

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* kb = k + (size_t)bh * n * dk;
  const float* vb = v + (size_t)bh * n * dk;
  const float* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;
  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);
  const int chunks = (row_end - row0 + kRows - 1) / kRows;

  prefetch(stage0, kb, vb, pb, row0, row_end, dk, p);
  for (int c = tid; c < dk; c += kThreads) {
    affine[c] = scale_k[h * dk + c];
    affine[dk + c] = bias_k[h * dk + c];
    affine[2 * dk + c] = scale_v[h * dk + c];
    affine[3 * dk + c] = bias_v[h * dk + c];
  }
  const float* dsb = ds + (size_t)bh * de * de;
  for (int i0 = tid; i0 < DP * DP; i0 += 8 * kThreads) {   // 8 loads in flight
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads, r = i / DP, c = i % DP;
      x[u] = (i < DP * DP && r < de && c < de) ? dsb[r * de + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads;
      if (i < DP * DP) dS[(i / DP) * LD + i % DP] = x[u];
    }
  }

  float acc[4][C];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < C; ++t) acc[q][t] = 0.f;

  for (int i = 0; i < chunks; ++i) {
    const int c0 = row0 + i * kRows;
    const int s = nbuf == 2 ? i & 1 : 0;   // this chunk's stage buffer
    const float* stage = stage0 + s * stage_size;
    cp_async_wait_all();
    __syncthreads();  // chunk i has landed; every thread is done with chunk i - 1
    if (nbuf == 2 && i + 1 < chunks)
      prefetch(stage0 + (s ^ 1) * stage_size, kb, vb, pb, c0 + kRows, row_end, dk, p);
    ln_forward<C>(stage, affine, tk, tv, stats, c0, row_end, dk, p, DP, LD, eps, warp, lane);
    __syncthreads();
    products<T8>(dS, tk, tv, tid);
    __syncthreads();
    ln_backward<C>(stage, affine, tk, tv, stats, dk_out, dv_out, dpos_h, acc,
                   (size_t)bh * n, c0, row_end, dk, p, LD, warp, lane);
    if (nbuf == 1 && i + 1 < chunks) {
      __syncthreads();  // every thread is done with the only stage buffer
      prefetch(stage0, kb, vb, pb, c0 + kRows, row_end, dk, p);
    }
  }

  // this CTA's affine gradients: the warps' sums added in warp order
  __syncthreads();
  float* red = tk;  // kWarps x 4 x dk, over the tiles
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < C; ++t) {
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

  // the last CTA of this bh sums its splits into split 0's slot, and the last
  // of those sums the batch: dparams[q][h][c] = sum over b of (sum over split
  // of partial[split][b H + h][q][c]), each sum in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* own = partial + (size_t)bh * 4 * dk;
  for (int i = tid; i < 4 * dk; i += kThreads)
    own[i] = ordered_sum(own + i, (size_t)BH * 4 * dk, gridDim.y);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tickets[bh] = 0;  // ready for the next launch on this stream
    last = atomicAdd(tickets + BH, 1) == BH - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < 4 * H * dk; i += kThreads) {
    const int q = i / (H * dk), hh = (i / dk) % H, c = i % dk;
    dparams[i] = ordered_sum(partial + ((size_t)hh * 4 + q) * dk + c, (size_t)H * 4 * dk, B);
  }
  if (tid == 0) tickets[BH] = 0;
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

struct Args {
  const float *k, *v, *pos, *scale_k, *bias_k, *scale_v, *bias_v, *ds;
  float *dk_out, *dv_out, *dpos_h, *partial, *dparams;
  int* tickets;
  int B, H, n, dk, p, rows_per_split, splits;
  float eps;
  cudaStream_t stream;
};

// Lets the instantiation take the card's largest dynamic shared memory per
// CTA (the opt-in limit less its static shared memory), once per device;
// returns that size in *max_bytes.
template <int C, int T8>
int allow_smem(int* max_bytes) {
  static int allowed[kMaxDevices];
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, scores_bwd_kernel<C, T8>);
    const int bytes = optin - (int)attr.sharedSizeBytes;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scores_bwd_kernel<C, T8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  *max_bytes = allowed[dev];
  return 0;
}

// The stage buffers that fit in a CTA's shared memory (2, else 1) and the
// bytes that takes.
int plan_smem(int dp, int dk, int p, int max_bytes, int* nbuf, int* bytes) {
  for (*nbuf = 2; *nbuf >= 1; --*nbuf) {
    *bytes = (int)sizeof(float) * smem_floats(dp, dk, p, *nbuf);
    if (*bytes <= max_bytes) return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the instantiation (ctas == nullptr) or reports how many of its
// CTAs fit on one SM at this (d_k, p) (*ctas).
template <int C, int T8>
int run(const Args& a, int* ctas) {
  int max_bytes, nbuf, bytes;
  int err = allow_smem<C, T8>(&max_bytes);
  if (err == 0) err = plan_smem(8 * T8, a.dk, a.p, max_bytes, &nbuf, &bytes);
  if (err != 0) return err;
  if (ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, scores_bwd_kernel<C, T8>, kThreads, bytes);
  const dim3 grid(a.B * a.H, a.splits);
  scores_bwd_kernel<C, T8><<<grid, kThreads, bytes, a.stream>>>(
      a.k, a.v, a.pos, a.scale_k, a.bias_k, a.scale_v, a.bias_v, a.ds, a.dk_out,
      a.dv_out, a.dpos_h, a.partial, a.dparams, a.tickets, a.B, a.H, a.n, a.dk, a.p,
      a.rows_per_split, nbuf, a.eps);
  return (int)cudaGetLastError();
}

// The instantiation for d_eff padded to 8 t8 and d_k/32 rounded up to C;
// the pairs that no (d_k, p) reaches are not built.
template <int C>
int by_width(int t8, const Args& a, int* ctas) {
  switch (t8) {
#define GT_BWD_CASE(T)                                       \
  case T:                                                    \
    if constexpr (8 * T > 32 * (C - 1)) return run<C, T>(a, ctas); \
    break;
    GT_BWD_CASE(1) GT_BWD_CASE(2) GT_BWD_CASE(3) GT_BWD_CASE(4)
    GT_BWD_CASE(5) GT_BWD_CASE(6) GT_BWD_CASE(7) GT_BWD_CASE(8)
    GT_BWD_CASE(9) GT_BWD_CASE(10) GT_BWD_CASE(11) GT_BWD_CASE(12)
    GT_BWD_CASE(13) GT_BWD_CASE(14) GT_BWD_CASE(15) GT_BWD_CASE(16)
#undef GT_BWD_CASE
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Args& a, int* ctas) {
  const int de = a.dk + a.p;
  if (a.dk < 1 || a.dk > kMaxD || a.p < 0 || de > kMaxD) return (int)cudaErrorInvalidValue;
  const int t8 = (de + 7) / 8;
  switch ((a.dk + 31) / 32) {
    case 1: return by_width<1>(t8, a, ctas);
    case 2: return by_width<2>(t8, a, ctas);
    case 3: return by_width<3>(t8, a, ctas);
    case 4: return by_width<4>(t8, a, ctas);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// How many CTAs of the kernel for (dk, p) fit on one SM of the current
// device (*ctas); the wrapper sizes its grid from it.  Returns a CUDA error
// code (0 on success).
extern "C" int galerkin_scores_bwd_ctas_per_sm(int dk, int p, int* ctas) {
  Args a{};
  a.dk = dk;
  a.p = p;
  return ctas == nullptr ? (int)cudaErrorInvalidValue : dispatch(a, ctas);
}

// k, v: (B*H, n, dk) contiguous; pos: (B, n, p) or null with p = 0;
// scale/bias: (H, dk); ds: (B*H, de, de) with de = dk + p <= 128, dk <= 128.
// Outputs: dk_out, dv_out (B*H, n, dk); dparams (4, H, dk) = dscale_k,
// dbias_k, dscale_v, dbias_v; dpos (B, n, p), written only when dpos is not
// null, through the scratch dpos_h (B*H, n, p).  partial: (splits, B*H, 4,
// dk) scratch.  tickets: B*H + 1 ints, 0 before the launch and 0 again after
// it (the last CTAs reset them); launches that share them must be ordered on
// one stream.  rows_per_split: a multiple of 64.  Returns the CUDA error code of
// the launches (0 on success): one launch, two with dpos.
extern "C" int galerkin_scores_bwd_launch(
    const float* k, const float* v, const float* pos, const float* scale_k,
    const float* bias_k, const float* scale_v, const float* bias_v,
    const float* ds, float* dk_out, float* dv_out, float* dpos_h, float* dpos,
    float* partial, float* dparams, int* tickets, int B, int H, int n, int dk, int p,
    int rows_per_split, int splits, float eps, void* stream) {
  if (n < 1 || B < 1 || H < 1 || splits < 1 || rows_per_split % kRows != 0 ||
      (size_t)(splits - 1) * rows_per_split >= (size_t)n || tickets == nullptr ||
      (p > 0) != (pos != nullptr) || (dpos != nullptr && (p == 0 || dpos_h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* scratch = dpos != nullptr ? dpos_h : nullptr;
  const Args a{k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, dk_out, dv_out,
               scratch, partial, dparams, tickets, B, H, n, dk, p, rows_per_split,
               splits, eps, s};
  int err = dispatch(a, nullptr);
  if (err != 0 || dpos == nullptr) return err;
  const size_t m = (size_t)B * n * p;
  dpos_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, dpos, B, H, n, p);
  return (int)cudaGetLastError();
}
