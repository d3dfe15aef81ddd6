// Backward of the Galerkin attention scores on Hopper (sm_90a), bf16 K, V, pos.
//
// Replaces: ops/pallas/galerkin.py of the JAX package, _scores_bwd with
//   _ln_bwd (the custom VJP of galerkin_scores_fused, plain XLA there) for the
//   bf16 encoder dtype: dS is cast to bf16, the products K' dS and V' dS^T are
//   float32 sums rounded to bf16, the LN-parameter gradients and dpos come out
//   in bf16.
//
// The forward (csrc/galerkin_scores_bf16.cu) is S = K'^T V' per bh with
// K' = [pos, bf16(LN_K(K))], V' = [pos, bf16(LN_V(V))] (n x d_eff, bf16).
// Given dS (d_eff x d_eff float32 per bh) this computes for every row r
//   dV'_r = bf16(K'_r bf16(dS)),   dK'_r = bf16(V'_r bf16(dS)^T)
// on the tensor cores (float32 sums of bf16 products), and from them, in
// float32,
//   dk_r = rstd (gy - mean(gy) - xhat mean(gy xhat)),  gy = dK'_r[p:] scale_k
//   (dv_r the same with V), written as bf16 (one rounding of the float32
//   value; K and V are bf16, so their gradients are);
//   dscale_k = sum over batch and rows of dK'[p:] xhat, dbias_k = sum dK'[p:]
//   (and for V): float32 sums, rounded once to bf16, handed back as float32
//   (the parameters are float32);
//   dpos_r = bf16(dK'_r[:p] + dV'_r[:p]) per head, summed over the heads of a
//   batch in float32 and rounded once to bf16.
// Where it rounds: the LN output (as the forward kernel does, same order of
// float32 operations), dS, dK', dV', the per-head pos sum, and the outputs.
// All other LayerNorm arithmetic (statistics, xhat, the LN backward) stays in
// float32 registers; JAX on a CPU rounds after each of those elementwise
// operations too, which a compiler is free not to do inside a fusion.  The
// plain version in ops/cuda/galerkin.py states exactly these roundings.
//
// What bounds it: bytes.  It reads K, V and writes dk, dv (4 BH n d_k bf16)
// and does 4 BH n d_eff^2 flops on the tensor cores: at d_eff = 97 about
// 47 flops a byte, far below what the card needs before the tensor cores are
// the limit.  What costs time is the LayerNorm arithmetic on CUDA cores.
//
// What the design does about it (simple first, after galerkin_scores_bwd.cu):
//  * grid (BH, splits): each CTA owns a contiguous range of rows, walked in
//    chunks of 32;
//  * dS is loaded once per CTA, rounded to bf16, into a row-major shared tile
//    padded with zeros to 16 * DT columns; the same tile serves both products:
//    read with ldmatrix.trans it is the B operand of K' dS, read with plain
//    ldmatrix it is the B operand of V' dS^T;
//  * per chunk: (A) each warp normalizes 4 rows of K and 4 of V, keeps xhat
//    and rstd in float32 registers and writes the bf16 rows K', V' row-major
//    to shared memory (zero columns up to 16 * DT);  (B) warp w forms with
//    mma.sync.m16n8k16 one 16-row block (w / 2 % 2) of one product (w % 2)
//    for one half of the column blocks (w / 4), and writes it rounded to bf16
//    over V' (dV') or K' (dK') after a barrier;  (C) the warps of (A) run the
//    LayerNorm backward for their rows from registers, write dk and dv, and
//    add the affine gradients to per-lane float32 sums;
//  * the affine gradients leave each CTA as one partial (warps summed in
//    order); a second kernel sums the partials over batch and splits in a
//    fixed order and rounds; dpos goes out per head and is summed over heads
//    in a fixed order.  No float atomics: the result is the same run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                        // sequence rows per chunk
constexpr int kMaxDk = 128;
constexpr int kPer = kMaxDk / 32;                // columns per lane in (A), (C)
constexpr int kRowsPerWarp = kRows / kWarps;     // 4 rows of K and 4 of V

template <int kN>
__device__ __forceinline__ void warp_sum(float (&x)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
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

template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
scores_bwd_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ pos,
                       const float* __restrict__ scale_k, const float* __restrict__ bias_k,
                       const float* __restrict__ scale_v, const float* __restrict__ bias_v,
                       const float* __restrict__ ds, bf16* __restrict__ dk_out,
                       bf16* __restrict__ dv_out, float* __restrict__ dpos_h,
                       float* __restrict__ partial, int H, int n, int dk, int p,
                       int rows_per_split, float eps) {
  constexpr int DP = 16 * DT;          // d_eff padded to the mma tile
  constexpr int LD = DP + 8;           // row stride of the bf16 tiles
  constexpr int NH = (DT + 1) / 2;     // 16-column blocks per warp in (B)
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* dS = reinterpret_cast<bf16*>(smem_bytes);  // DP x LD, zeros past d_eff
  bf16* tk = dS + DP * LD;                         // kRows x LD: K' rows, then dK'
  bf16* tv = tk + kRows * LD;                      // kRows x LD: V' rows, then dV'
  float* red = reinterpret_cast<float*>(tv + kRows * LD);  // kWarps x 4 x dk
  __shared__ float affine[4][kMaxDk];  // scale_k, bias_k, scale_v, bias_v

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* kb = k + (size_t)bh * n * dk;
  const bf16* vb = v + (size_t)bh * n * dk;
  const bf16* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int c = tid; c < dk; c += kThreads) {
    affine[0][c] = scale_k[h * dk + c];
    affine[1][c] = bias_k[h * dk + c];
    affine[2][c] = scale_v[h * dk + c];
    affine[3][c] = bias_v[h * dk + c];
  }
  const float* dsb = ds + (size_t)bh * de * de;
  for (int i = tid; i < DP * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dS[r * LD + c] = __float2bfloat16_rn((r < de && c < de) ? dsb[r * de + c] : 0.f);
  }

  // (B)'s share of this warp: product `which` (0: dV' = K' dS, 1: dK' = V' dS^T),
  // rows 16 rb .., column blocks half * NH .. of the DT blocks
  const int which = warp % 2, rb = (warp / 2) % 2, half = warp / 4;
  // ldmatrix row addresses of this lane inside a 16 x 16 tile:
  // A (row-major rows of K' or V'): tiles (0, 0), (8, 0), (0, 8), (8, 8)
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  // dS as B[k][n] = dS[k][n], read transposed: tiles (0, 0), (8, 0), (0, 8), (8, 8)
  const int t_row = (lane % 8) + 8 * ((lane / 8) % 2), t_col = 8 * (lane / 16);
  // dS as B[k][n] = dS[n][k]: tiles (0, 0), (0, 8), (8, 0), (8, 8)
  const int n_row = (lane % 8) + 8 * (lane / 16), n_col = 8 * ((lane / 8) % 2);

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
        xk[u][t] = in ? __bfloat162float(kb[(size_t)row * dk + c]) : 0.f;
        xv[u][t] = in ? __bfloat162float(vb[(size_t)row * dk + c]) : 0.f;
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
        xk[u][t] = __fmul_rn(xk[u][t], rk[u]);
        xv[u][t] = __fmul_rn(xv[u][t], rv[u]);
      }
    }
    __syncthreads();  // every thread is done with the last chunk's tiles
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = warp + kWarps * u, row = c0 + r;
      bf16* krow = tk + r * LD;
      bf16* vrow = tv + r * LD;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) {
          // the forward kernel's order of float32 operations: no fused multiply-add
          const float yk = __fadd_rn(__fmul_rn(xk[u][t], affine[0][c]), affine[1][c]);
          const float yv = __fadd_rn(__fmul_rn(xv[u][t], affine[2][c]), affine[3][c]);
          krow[p + c] = __float2bfloat16_rn(valid[u] ? yk : 0.f);
          vrow[p + c] = __float2bfloat16_rn(valid[u] ? yv : 0.f);
        }
      }
      for (int c = lane; c < p; c += 32)
        krow[c] = vrow[c] = valid[u] ? pb[(size_t)row * p + c] : zero;
      for (int c = de + lane; c < DP; c += 32) krow[c] = vrow[c] = zero;
    }
    __syncthreads();

    // (B) this warp's 16 rows x (up to NH 16-column blocks) of one product,
    // d_eff (padded) the inner dimension
    float g[NH][2][4];
#pragma unroll
    for (int t = 0; t < NH; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[t][j][e] = 0.f;
    const bf16* src = which == 0 ? tk : tv;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, src + (16 * rb + a_row) * LD + 16 * kk + a_col);
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        const int nj = half * NH + t;
        if (nj < DT) {
          uint32_t bfrag[4];
          if (which == 0)
            ldmatrix_x4_trans(bfrag, dS + (16 * kk + t_row) * LD + 16 * nj + t_col);
          else
            ldmatrix_x4(bfrag, dS + (16 * nj + n_row) * LD + 16 * kk + n_col);
          mma_bf16(g[t][0], a, bfrag[0], bfrag[1]);
          mma_bf16(g[t][1], a, bfrag[2], bfrag[3]);
        }
      }
    }
    __syncthreads();  // every warp is done reading K', V'
    // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
    // column 2 * (lane % 4) + e % 2; dV' goes over V', dK' over K'
    bf16* dst = which == 0 ? tv : tk;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      const int nj = half * NH + t;
      if (nj < DT) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * nj + 8 * j + 2 * (lane % 4);
          const int r = 16 * rb + lane / 4;
          *reinterpret_cast<uint32_t*>(dst + r * LD + col) =
              pack_bf16(g[t][j][0], g[t][j][1]);
          *reinterpret_cast<uint32_t*>(dst + (r + 8) * LD + col) =
              pack_bf16(g[t][j][2], g[t][j][3]);
        }
      }
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
        const float g_k = in ? __bfloat162float(tk[r * LD + p + c]) : 0.f;
        const float g_v = in ? __bfloat162float(tv[r * LD + p + c]) : 0.f;
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
          dk_out[((size_t)bh * n + row) * dk + c] = __float2bfloat16_rn(
              rk[u] * (gyk[u][t] - mk[u] / dk - xk[u][t] * (mxk[u] / dk)));
          dv_out[((size_t)bh * n + row) * dk + c] = __float2bfloat16_rn(
              rv[u] * (gyv[u][t] - mv[u] / dk - xv[u][t] * (mxv[u] / dk)));
        }
      }
      if (dpos_h != nullptr)
        for (int c = lane; c < p; c += 32)
          dpos_h[((size_t)bh * n + row) * p + c] = __bfloat162float(
              __float2bfloat16_rn(__bfloat162float(tk[r * LD + c]) +
                                  __bfloat162float(tv[r * LD + c])));
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

// dparams[q][h][c] = bf16(sum over b, then split, of partial[split][b H + h][q][c])
// (q: dscale_k, dbias_k, dscale_v, dbias_v), in that fixed order, as float32.
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
  dparams[i] = __bfloat162float(__float2bfloat16_rn(s));
}

// dpos[b][r][c] = bf16(sum over heads h, in order, of dpos_h[b H + h][r][c]).
__global__ void dpos_reduce_kernel(const float* __restrict__ dpos_h,
                                   bf16* __restrict__ dpos, int B, int H, int n, int p) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)n * p;
  if (i >= (size_t)B * per_b) return;
  const size_t b = i / per_b, rest = i % per_b;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += dpos_h[(b * H + h) * per_b + rest];
  dpos[i] = __float2bfloat16_rn(s);
}

template <int DT>
int launch(const bf16* k, const bf16* v, const bf16* pos, const float* scale_k,
           const float* bias_k, const float* scale_v, const float* bias_v,
           const float* ds, bf16* dk_out, bf16* dv_out, float* dpos_h, float* partial,
           int B, int H, int n, int dk, int p, int rows_per_split, int splits,
           float eps, cudaStream_t stream) {
  constexpr int LD = 16 * DT + 8;
  const int bytes = (int)((size_t)(16 * DT + 2 * kRows) * LD * sizeof(bf16) +
                          (size_t)kWarps * 4 * dk * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      scores_bwd_bf16_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, splits);
  scores_bwd_bf16_kernel<DT><<<grid, kThreads, bytes, stream>>>(
      k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, dk_out, dv_out, dpos_h, partial,
      H, n, dk, p, rows_per_split, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// k, v: (B*H, n, dk) contiguous bf16; pos: (B, n, p) bf16 or null with p = 0;
// scale/bias: (H, dk) float32; ds: (B*H, de, de) float32 with de = dk + p <= 128,
// dk <= 128.  Outputs: dk_out, dv_out (B*H, n, dk) bf16; dparams (4, H, dk)
// float32 holding bf16-rounded dscale_k, dbias_k, dscale_v, dbias_v; dpos
// (B, n, p) bf16, written only when dpos is not null, through the float32
// scratch dpos_h (B*H, n, p).  partial: (splits, B*H, 4, dk) float32 scratch.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int galerkin_scores_bwd_bf16_launch(
    const void* k, const void* v, const void* pos, const float* scale_k,
    const float* bias_k, const float* scale_v, const float* bias_v, const float* ds,
    void* dk_out, void* dv_out, float* dpos_h, void* dpos, float* partial,
    float* dparams, int B, int H, int n, int dk, int p, int rows_per_split, int splits,
    float eps, void* stream) {
  const int de = dk + p;
  if (dk < 1 || dk > kMaxDk || de > 128 || n < 1 || B < 1 || H < 1 || splits < 1 ||
      rows_per_split % kRows != 0 || (p > 0) != (pos != nullptr) ||
      (dpos != nullptr && (p == 0 || dpos_h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* scratch = dpos != nullptr ? dpos_h : nullptr;
  int err;
  switch ((de + 15) / 16) {
#define GT_BWD_CASE(T)                                                              \
  case T:                                                                           \
    err = launch<T>((const bf16*)k, (const bf16*)v, (const bf16*)pos, scale_k,      \
                    bias_k, scale_v, bias_v, ds, (bf16*)dk_out, (bf16*)dv_out,      \
                    scratch, partial, B, H, n, dk, p, rows_per_split, splits, eps, s); \
    break;
    GT_BWD_CASE(1) GT_BWD_CASE(2) GT_BWD_CASE(3) GT_BWD_CASE(4)
    GT_BWD_CASE(5) GT_BWD_CASE(6) GT_BWD_CASE(7) GT_BWD_CASE(8)
#undef GT_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int total = 4 * H * dk;
  params_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, dparams, B, H, dk,
                                                           splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dpos != nullptr) {
    const size_t m = (size_t)B * n * p;
    dpos_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, (bf16*)dpos,
                                                                   B, H, n, p);
    e = cudaGetLastError();
  }
  return (int)e;
}
