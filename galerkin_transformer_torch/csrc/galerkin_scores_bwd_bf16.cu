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
// float32; JAX on a CPU rounds after each of those elementwise operations
// too, which a compiler is free not to do inside a fusion.  The plain version
// in ops/cuda/galerkin.py states exactly these roundings.
//
// What bounds it: bytes.  It reads K, V and writes dk, dv (4 BH n d_k bf16)
// and does 4 BH n d_eff^2 flops on the tensor cores: at d_eff = 97 about
// 47 flops a byte, far below what the card needs before the tensor cores are
// the limit.  What costs time is the LayerNorm arithmetic on CUDA cores and
// its latency.
//
// What the design does about it (after galerkin_scores_bwd.cu):
//  * grid (BH, splits): each CTA owns a contiguous range of rows, walked in
//    chunks of 64; the wrapper sizes `splits` so that the CTAs fit on the
//    card at once (galerkin_scores_bwd_bf16_ctas_per_sm);
//  * dS is loaded once per CTA, rounded to bf16, into a row-major shared tile
//    padded with zeros to 16 * DT columns; the same tile serves both products:
//    read with ldmatrix.trans it is the B operand of K' dS, read with plain
//    ldmatrix it is the B operand of V' dS^T;
//  * cp.async copies (16 bytes where aligned) bring the next chunk's raw K, V
//    and pos rows into a second stage buffer while the CTA works on the
//    current chunk;
//  * warp w = 2 rb + which owns rows 16 rb .. 16 rb + 15 of the chunk for one
//    product (which 0: dV' = K' dS, 1: dK' = V' dS^T), so the work is even
//    and a warp mostly waits on itself:
//    (A) it normalizes its 16 rows of K (which 0) or V (which 1) from the
//        stage buffer into its rows of the bf16 tile, and writes each row's
//        float32 mean and rstd beside them; nothing of it stays in registers;
//    (B) it forms its 16-row block of the product with mma.sync.m16n8k16 over
//        every column block (above 4 blocks in two halves, the first held as
//        packed bf16 while the second is summed) and writes it, rounded to
//        bf16, over the rows it read (no other warp reads them);
//    (C) after a barrier of the two warps of its row block it runs the
//        LayerNorm backward of the other matrix for the same 16 rows: xhat is
//        rebuilt from the raw rows still in the stage buffer and the other
//        warp's mean and rstd, bit-equal to (A)'s; it writes dk or dv and adds
//        the affine gradients to per-lane float32 sums (the only state kept
//        across chunks).
//    One CTA barrier per chunk (the stage buffers), one pair barrier, and
//    warp barriers;
//  * eight lanes share a row in (A) and (C), four rows to a warp instruction
//    (the whole warp at 32 < d_k <= 64): a row's reductions take three
//    shuffle levels, not five, and its divisions are shared; the lanes'
//    columns are strided so that (A)'s sums keep the forward kernel's order;
//  * the LN stages are templated on d_k/32 rounded up (1..4) and the product
//    on DT = d_eff/16 rounded up (1..8), so no register holds padding;
//  * the affine gradients leave each CTA as one partial (warps summed in
//    order); the last CTA of each bh to finish (a ticket taken with an
//    integer atomic after a fence) sums that bh's partials over the splits
//    in order, the last of those sums them over the batch in order and
//    rounds once to bf16, and each resets its ticket: a call is one launch
//    and the result is the same from run to run (no float atomics).  dpos
//    goes out per head and a second kernel sums it over heads in a fixed
//    order, only when it is asked for.
// Shared memory per CTA: 109,568 bytes at (d_k, p) = (96, 1), 38,144 bytes at
// (32, 2); registers capped at 128 (two CTAs per SM) for d_eff <= 112.
// Its time against two bf16 cuBLAS products: `chip_smoke.py`; against the
// kernel of another checkout: `chip_smoke.py --against` (PERF.md, row 3c).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                        // sequence rows per chunk
constexpr int kBlockRows = 16;                   // rows of one warp: an mma tile
constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;
// Lanes that share one row in the LN stages: L = 8 (4 rows to a warp
// instruction), lane j holding columns j + 8 k + 32 t (k < 4, t < C); 32 at
// 32 < d_k <= 64, where 8 spill under the 128-register cap.  Its sums are
// formed in the order of the forward kernel, whose lane m holds columns
// m + 32 t: per forward lane in t order, then that kernel's xor levels 16 ..
// L within the lane (lane_tree), then levels L / 2 .. 1 across the L lanes:
// the same additions in the same order, so the statistics agree bit for bit
// (above d_k = 32, as far as both kernels compile `q += d * d` alike).
__host__ __device__ constexpr int ln_lanes(int C) { return C == 2 ? 32 : 8; }
// row instructions a warp runs at once in the LN stages, their reductions
// interleaved: as many as the 128-register cap holds without spilling
__host__ __device__ constexpr int ln_batch(int C) { return C == 1 ? 2 : C == 2 ? 4 : 1; }
// Two CTAs per SM (registers capped at 128), but at DT = 8 (d_eff > 112),
// where the shared memory of d_k near 128 leaves room for one CTA anyway.
__host__ __device__ constexpr int min_ctas(int DT) { return DT == 8 ? 1 : 2; }

static_assert(kWarps * kBlockRows == 2 * kRows, "two products x four row blocks");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the 64 threads of row block rb (warps 2 rb and 2 rb + 1); barrier 0 is
// __syncthreads'
__device__ __forceinline__ void pair_barrier(int rb) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rb) : "memory");
}

// Sums each of the kN values across the L lanes of its row (xor levels
// L / 2 .. 1, as the forward kernel's last levels); the shuffles of the kN
// sums interleave, so one sum's latency hides behind the others.
template <int L, int kN>
__device__ __forceinline__ void row_sum(float (&x)[kN]) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
}

// a[k]: the partial sum of the forward kernel's lane j + (32 / R) k (R = 1:
// the lane itself).  Returns what that kernel's lane j holds after its xor
// levels 16 .. 32 / R: the same additions in the same order, none fused.
template <int R>
__device__ __forceinline__ float lane_tree(const float (&a)[R]) {
  float v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = a[k];
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2) {
    float w[R];
#pragma unroll
    for (int k = 0; k < R; ++k) w[k] = __fadd_rn(v[k], v[k ^ h]);
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = w[k];
  }
  return v[0];
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

// bf16 elements of one stage buffer: K rows at [0, kRows dk), V rows after
// them, then pos rows; rounded up so that the next buffer starts on 16 bytes.
__host__ __device__ constexpr int stage_elems(int dk, int p) {
  return (2 * kRows * dk + kRows * p + 7) / 8 * 8;
}
// Bytes of the dynamic shared memory: dS (DP x LD bf16), the two row tiles
// (kRows x LD bf16 each), two stage buffers, the row statistics (4 x kRows
// float32) and the LN parameters (4 x dk float32).
__host__ __device__ constexpr int smem_bytes(int dt, int dk, int p) {
  return 2 * (16 * dt * (16 * dt + 8) + 2 * kRows * (16 * dt + 8) + 2 * stage_elems(dk, p)) +
         4 * (4 * kRows + 4 * dk);
}

// Starts the copy of `count` bf16 from global src to shared dst (16-byte
// aligned): 16 bytes per cp.async where src is 16-byte aligned, 4 where it is
// 4-byte aligned; what is left over (a tail, or a run at an odd address) by
// plain loads and stores.
__device__ __forceinline__ void copy_run(bf16* dst, const bf16* src, int count) {
  const size_t a = reinterpret_cast<size_t>(src);
  int done = 0;
  if (a % 16 == 0) {
    done = count / 8 * 8;
    for (int i = 8 * threadIdx.x; i < done; i += 8 * kThreads) cp_async16(dst + i, src + i);
  } else if (a % 4 == 0) {
    done = count / 2 * 2;
    for (int i = 2 * threadIdx.x; i < done; i += 2 * kThreads) cp_async4(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// Starts the copy of rows [c0, min(c0 + kRows, row_end)) of K, V and pos into
// a stage buffer; each is one contiguous run.
__device__ __forceinline__ void prefetch(bf16* stage, const bf16* kb, const bf16* vb,
                                         const bf16* pb, int c0, int row_end, int dk,
                                         int p) {
  const int rows = min(kRows, row_end - c0);
  copy_run(stage, kb + (size_t)c0 * dk, rows * dk);
  copy_run(stage + kRows * dk, vb + (size_t)c0 * dk, rows * dk);
  if (p > 0) copy_run(stage + 2 * kRows * dk, pb + (size_t)c0 * p, rows * p);
  cp_async_commit();
}

// (A): rows r0 .. r0 + 15 of one matrix (src: its raw rows in the stage
// buffer, ps: the pos rows), normalized into the tile as [pos, bf16(LN(x)
// scale + bias), zeros to dp], in the forward kernel's order of float32
// operations (no fused multiply-add, the same sums in the same order); rows
// past row_end are written as zeros.  Each row's mean and rstd go to
// mean_out[r], rstd_out[r].  Lane j + L g takes row g of each instruction's
// 32 / L rows and its columns j + L k + 32 t.
template <int C>
__device__ __forceinline__ void ln_forward(const bf16* src, const bf16* ps, const float* scale,
                                           const float* bias, bf16* tile, float* mean_out,
                                           float* rstd_out, int r0, int c0, int row_end,
                                           int dk, int p, int dp, int ld, float eps,
                                           int lane) {
  constexpr int L = ln_lanes(C), R = 32 / L, kB = ln_batch(C), kRowsPerPass = kB * R;
  const int j = lane % L, g = lane / L;
  const bf16 zero = __float2bfloat16_rn(0.f);
  float sc[R][C], bi[R][C];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int c = min(j + L * k + 32 * t, dk - 1);
      sc[k][t] = scale[c];
      bi[k][t] = bias[c];
    }
#pragma unroll 1
  for (int pass = 0; pass < kBlockRows / kRowsPerPass; ++pass) {
    float x[kB][R][C], s[kB], q[kB];
    bool valid[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int r = r0 + (kB * pass + u) * R + g;
      valid[u] = c0 + r < row_end;
      float a[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a[k] = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = j + L * k + 32 * t;
          x[u][k][t] = (valid[u] && c < dk) ? __bfloat162float(src[r * dk + c]) : 0.f;
          a[k] += x[u][k][t];
        }
      }
      s[u] = lane_tree(a);
    }
    row_sum<L>(s);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      s[u] = s[u] / dk;   // the mean
      float a[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a[k] = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          x[u][k][t] = j + L * k + 32 * t < dk ? x[u][k][t] - s[u] : 0.f;
          a[k] += x[u][k][t] * x[u][k][t];
        }
      }
      q[u] = lane_tree(a);
    }
    row_sum<L>(q);
    // every load before the first store: the stores go to shared memory too,
    // so the compiler cannot move a load above one
    bf16 pv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u)
      pv[u] = valid[u] && j < p ? ps[(r0 + (kB * pass + u) * R + g) * p + j] : zero;
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int r = r0 + (kB * pass + u) * R + g;
      const float rstd = rsqrtf(q[u] / dk + eps);
      bf16* row = tile + r * ld;
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = j + L * k + 32 * t;
          if (c < dk) {
            const float y =
                __fadd_rn(__fmul_rn(__fmul_rn(x[u][k][t], rstd), sc[k][t]), bi[k][t]);
            row[p + c] = __float2bfloat16_rn(valid[u] ? y : 0.f);
          }
        }
      if (j < p) row[j] = pv[u];
      for (int c = j + L; c < p; c += L) row[c] = valid[u] ? ps[r * p + c] : zero;
      for (int c = p + dk + j; c < dp; c += L) row[c] = zero;
      if (j == 0) {
        mean_out[r] = s[u];
        rstd_out[r] = rstd;
      }
    }
  }
}

// Column blocks n0 .. n0 + N - 1 of this warp's 16 rows (tile, row-major,
// d_eff padded to 16 DT the inner dimension) times dS (kWhich 0: dS, read
// transposed; 1: dS^T), float32 sums over the inner dimension in order.
template <int DT, int kWhich, int N0, int N>
__device__ __forceinline__ void product_blocks(const bf16* dS, const bf16* tile, int lane,
                                               float (&g)[N][2][4]) {
  constexpr int LD = 16 * DT + 8;
  // ldmatrix row addresses of this lane inside a 16 x 16 tile:
  // A (row-major rows of K' or V') and dS as B[k][n] = dS[k][n], read
  // transposed: tiles (0, 0), (8, 0), (0, 8), (8, 8)
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  // dS as B[k][n] = dS[n][k]: tiles (0, 0), (0, 8), (8, 0), (8, 8)
  const int n_row = (lane % 8) + 8 * (lane / 16), n_col = 8 * ((lane / 8) % 2);
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[t][j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, tile + a_row * LD + 16 * kk + a_col);
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int nj = N0 + t;
      uint32_t b[4];
      if (kWhich == 0)
        ldmatrix_x4_trans(b, dS + (16 * kk + a_row) * LD + 16 * nj + a_col);
      else
        ldmatrix_x4(b, dS + (16 * nj + n_row) * LD + 16 * kk + n_col);
      mma_bf16(g[t][0], a, b[0], b[1]);
      mma_bf16(g[t][1], a, b[2], b[3]);
    }
  }
}

// (B): this warp's 16 rows times dS (kWhich 0) or dS^T (1) over every
// 16-column block, written rounded to bf16 over the same rows.  Above 4
// blocks the columns go in two halves, the first held as packed bf16 pairs
// while the second is summed (the same roundings, half the accumulators).
template <int DT, int kWhich>
__device__ __forceinline__ void product(const bf16* dS, bf16* tile, int lane) {
  constexpr int LD = 16 * DT + 8;
  constexpr int N1 = DT > 4 ? (DT + 1) / 2 : DT, N2 = DT - N1;
  // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
  // column 2 * (lane % 4) + e % 2
  const int r = lane / 4;
  uint32_t lo[N1][2], hi[N1][2];   // rows r and r + 8 of the first N1 blocks
  {
    float g[N1][2][4];
    product_blocks<DT, kWhich, 0, N1>(dS, tile, lane, g);
#pragma unroll
    for (int t = 0; t < N1; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        lo[t][j] = pack_bf16(g[t][j][0], g[t][j][1]);
        hi[t][j] = pack_bf16(g[t][j][2], g[t][j][3]);
      }
  }
  float g[N2 > 0 ? N2 : 1][2][4];
  if constexpr (N2 > 0) product_blocks<DT, kWhich, N1, N2>(dS, tile, lane, g);
  __syncwarp();  // every lane is done reading the rows
#pragma unroll
  for (int t = 0; t < N1; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * t + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(tile + r * LD + col) = lo[t][j];
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * LD + col) = hi[t][j];
    }
#pragma unroll
  for (int t = 0; t < N2; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * (N1 + t) + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(tile + r * LD + col) = pack_bf16(g[t][j][0], g[t][j][1]);
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * LD + col) =
          pack_bf16(g[t][j][2], g[t][j][3]);
    }
}

// (C): the LayerNorm backward of rows r0 .. r0 + 15 of one matrix: src its
// raw rows in the stage buffer, mean_in and rstd_in its row statistics from
// (A) (xhat rebuilt exactly as (A) formed it), tile the gradient of its
// LN output (dK' or dV', bf16, pos columns first).  acc[0], acc[1] gather
// dscale, dbias at this lane's columns, as in (A).
template <int C>
__device__ __forceinline__ void ln_backward(const bf16* src, const bf16* tile,
                                            const float* mean_in, const float* rstd_in,
                                            const float* scale, bf16* out,
                                            float (&acc)[2][32 / ln_lanes(C)][C],
                                            size_t row_base, int r0, int c0, int row_end,
                                            int dk, int p, int ld, int lane) {
  constexpr int L = ln_lanes(C), R = 32 / L, kB = ln_batch(C), kRowsPerPass = kB * R;
  const int j = lane % L, g = lane / L;
  float sc[R][C];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int t = 0; t < C; ++t) sc[k][t] = scale[min(j + L * k + 32 * t, dk - 1)];
#pragma unroll 1
  for (int pass = 0; pass < kBlockRows / kRowsPerPass; ++pass) {
    float xh[kB][R][C], gy[kB][R][C], rstd[kB];
    float sums[2 * kB];  // sum gy, then sum gy xhat
    bool valid[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int r = r0 + (kB * pass + u) * R + g;
      valid[u] = c0 + r < row_end;
      const float mean = mean_in[r];
      rstd[u] = rstd_in[r];
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = j + L * k + 32 * t;
          const bool in = valid[u] && c < dk;
          const float xhat =
              in ? __fmul_rn(__bfloat162float(src[r * dk + c]) - mean, rstd[u]) : 0.f;
          const float gr = in ? __bfloat162float(tile[r * ld + p + c]) : 0.f;
          if (in) {
            acc[0][k][t] = fmaf(gr, xhat, acc[0][k][t]);
            acc[1][k][t] += gr;
          }
          xh[u][k][t] = xhat;
          gy[u][k][t] = in ? gr * sc[k][t] : 0.f;
          sg += gy[u][k][t];
          sgx += gy[u][k][t] * xhat;
        }
      sums[u] = sg;
      sums[kB + u] = sgx;
    }
    row_sum<L>(sums);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!valid[u]) continue;
      const size_t row = row_base + c0 + r0 + (kB * pass + u) * R + g;
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = j + L * k + 32 * t;
          if (c < dk)
            out[row * dk + c] = __float2bfloat16_rn(
                rstd[u] * (gy[u][k][t] - sums[u] / dk -
                           xh[u][k][t] * (sums[kB + u] / dk)));
        }
    }
  }
}

template <int C, int DT>
__global__ void __launch_bounds__(kThreads, min_ctas(DT))
scores_bwd_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ pos,
                       const float* __restrict__ scale_k, const float* __restrict__ bias_k,
                       const float* __restrict__ scale_v, const float* __restrict__ bias_v,
                       const float* __restrict__ ds, bf16* __restrict__ dk_out,
                       bf16* __restrict__ dv_out, float* __restrict__ dpos_h,
                       float* __restrict__ partial, float* __restrict__ dparams,
                       int* __restrict__ tickets, int B, int H, int n, int dk, int p,
                       int rows_per_split, float eps) {
  constexpr int DP = 16 * DT;          // d_eff padded to the mma tile
  constexpr int LD = DP + 8;           // row stride of the bf16 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dS = reinterpret_cast<bf16*>(smem);   // DP x LD, zeros past d_eff
  bf16* tiles = dS + DP * LD;                 // 2 x kRows x LD: K' then dV', V' then dK'
  bf16* stage0 = tiles + 2 * kRows * LD;      // 2 x stage_elems(dk, p)
  const int stage_size = stage_elems(dk, p);
  float* stats = reinterpret_cast<float*>(stage0 + 2 * stage_size);  // mean, rstd of K, V
  float* affine = stats + 4 * kRows;          // scale_k, bias_k, scale_v, bias_v
  __shared__ bool last;

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this warp's product and rows; (A) normalizes matrix `which` (0: K, 1: V)
  // into its tile, (C) back-propagates through the other one's LayerNorm
  const int which = warp % 2, rb = warp / 2, r0 = kBlockRows * rb;
  const int other = 1 - which;
  const bf16* kb = k + (size_t)bh * n * dk;
  const bf16* vb = v + (size_t)bh * n * dk;
  const bf16* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;
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
#pragma unroll 4
  for (int r = warp; r < DP; r += kWarps)
#pragma unroll
    for (int c = lane; c < DP; c += 32)
      dS[r * LD + c] = __float2bfloat16_rn(r < de && c < de ? dsb[r * de + c] : 0.f);

  bf16* own = tiles + which * kRows * LD;   // (A) writes it, (B) reads and overwrites it
  // dscale, dbias of matrix `other` at this lane's columns in the LN stages
  constexpr int L = ln_lanes(C), R = 32 / L;
  float acc[2][R][C];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int t = 0; t < C; ++t) acc[q][m][t] = 0.f;

  for (int i = 0; i < chunks; ++i) {
    const int c0 = row0 + i * kRows;
    const bf16* stage = stage0 + (i & 1) * stage_size;
    cp_async_wait_all();
    __syncthreads();  // chunk i has landed; every thread is done with chunk i - 1
    if (i + 1 < chunks)
      prefetch(stage0 + ((i + 1) & 1) * stage_size, kb, vb, pb, c0 + kRows, row_end, dk, p);
    ln_forward<C>(stage + which * kRows * dk, stage + 2 * kRows * dk,
                  affine + 2 * which * dk, affine + (2 * which + 1) * dk, own,
                  stats + 2 * which * kRows, stats + (2 * which + 1) * kRows, r0, c0,
                  row_end, dk, p, DP, LD, eps, lane);
    __syncwarp();
    if (which == 0)
      product<DT, 0>(dS, own + r0 * LD, lane);
    else
      product<DT, 1>(dS, own + r0 * LD, lane);
    pair_barrier(rb);  // both products of these rows are written, and both statistics
    ln_backward<C>(stage + other * kRows * dk, own, stats + 2 * other * kRows,
                   stats + (2 * other + 1) * kRows, affine + 2 * other * dk,
                   other == 0 ? dk_out : dv_out, acc, (size_t)bh * n, r0, c0, row_end, dk,
                   p, LD, lane);
    if (dpos_h != nullptr && which == 0) {
      const bf16* t1 = tiles + kRows * LD;
      for (int r = r0; r < r0 + kBlockRows && c0 + r < row_end; ++r)
        for (int c = lane; c < p; c += 32)
          dpos_h[((size_t)bh * n + c0 + r) * p + c] = __bfloat162float(__float2bfloat16_rn(
              __bfloat162float(own[r * LD + c]) + __bfloat162float(t1[r * LD + c])));
    }
  }

  // this CTA's affine gradients: the lanes of a warp that hold one column
  // added (xor levels L .. 16), then the four warps of each matrix in order
#pragma unroll
  for (int o = L; o < 32; o *= 2)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int t = 0; t < C; ++t)
          acc[q][m][t] += __shfl_xor_sync(0xffffffffu, acc[q][m][t], o);
  __syncthreads();
  float* red = reinterpret_cast<float*>(tiles);  // kWarps x 2 x dk, over the tiles
  if (lane < L)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = lane + L * m + 32 * t;
          if (c < dk) red[(warp * 2 + q) * dk + c] = acc[q][m][t];
        }
  __syncthreads();
  float* out = partial + ((size_t)split * BH + bh) * 4 * dk;
  for (int i = tid; i < 4 * dk; i += kThreads) {
    // q = i / dk: dscale_k, dbias_k (the warps with which 1), dscale_v, dbias_v
    const int q = i / dk, c = i % dk, w0 = q < 2 ? 1 : 0;
    float s = 0.f;
    for (int w = w0; w < kWarps; w += 2) s += red[(w * 2 + q % 2) * dk + c];
    out[i] = s;
  }

  // the last CTA of this bh sums its splits into split 0's slot, and the last
  // of those sums the batch: dparams[q][h][c] = bf16(sum over b of (sum over
  // split of partial[split][b H + h][q][c])), each sum in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* own_partial = partial + (size_t)bh * 4 * dk;
  for (int i = tid; i < 4 * dk; i += kThreads)
    own_partial[i] = ordered_sum(own_partial + i, (size_t)BH * 4 * dk, gridDim.y);
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
    dparams[i] = __bfloat162float(__float2bfloat16_rn(
        ordered_sum(partial + ((size_t)hh * 4 + q) * dk + c, (size_t)H * 4 * dk, B)));
  }
  if (tid == 0) tickets[BH] = 0;
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

struct Args {
  const bf16 *k, *v, *pos;
  const float *scale_k, *bias_k, *scale_v, *bias_v, *ds;
  bf16 *dk_out, *dv_out;
  float *dpos_h, *partial, *dparams;
  int* tickets;
  int B, H, n, dk, p, rows_per_split, splits;
  float eps;
  cudaStream_t stream;
};

// Lets the instantiation take the dynamic shared memory that (d_k, p) needs,
// once per device and size: the largest it has been asked for so far.
template <int C, int DT>
int allow_smem(int bytes) {
  static int allowed[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] < bytes) {
    err = cudaFuncSetAttribute(scores_bwd_bf16_kernel<C, DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  return 0;
}

// Launches the instantiation (ctas == nullptr) or reports how many of its
// CTAs fit on one SM at this (d_k, p) (*ctas).
template <int C, int DT>
int run(const Args& a, int* ctas) {
  const int bytes = smem_bytes(DT, a.dk, a.p);
  int err = allow_smem<C, DT>(bytes);
  if (err != 0) return err;
  if (ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, scores_bwd_bf16_kernel<C, DT>, kThreads, bytes);
  const dim3 grid(a.B * a.H, a.splits);
  scores_bwd_bf16_kernel<C, DT><<<grid, kThreads, bytes, a.stream>>>(
      a.k, a.v, a.pos, a.scale_k, a.bias_k, a.scale_v, a.bias_v, a.ds, a.dk_out, a.dv_out,
      a.dpos_h, a.partial, a.dparams, a.tickets, a.B, a.H, a.n, a.dk, a.p,
      a.rows_per_split, a.eps);
  return (int)cudaGetLastError();
}

// The instantiation for d_eff padded to 16 dt and d_k/32 rounded up to C;
// the pairs that no (d_k, p) reaches are not built.
template <int C>
int by_width(int dt, const Args& a, int* ctas) {
  switch (dt) {
#define GT_BWD_CASE(T)                                              \
  case T:                                                           \
    if constexpr (16 * T > 32 * (C - 1)) return run<C, T>(a, ctas); \
    break;
    GT_BWD_CASE(1) GT_BWD_CASE(2) GT_BWD_CASE(3) GT_BWD_CASE(4)
    GT_BWD_CASE(5) GT_BWD_CASE(6) GT_BWD_CASE(7) GT_BWD_CASE(8)
#undef GT_BWD_CASE
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Args& a, int* ctas) {
  const int de = a.dk + a.p;
  if (a.dk < 1 || a.dk > kMaxD || a.p < 0 || de > kMaxD) return (int)cudaErrorInvalidValue;
  const int dt = (de + 15) / 16;
  switch ((a.dk + 31) / 32) {
    case 1: return by_width<1>(dt, a, ctas);
    case 2: return by_width<2>(dt, a, ctas);
    case 3: return by_width<3>(dt, a, ctas);
    case 4: return by_width<4>(dt, a, ctas);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// How many CTAs of the kernel for (dk, p) fit on one SM of the current
// device (*ctas); the wrapper sizes its grid from it.  Returns a CUDA error
// code (0 on success).
extern "C" int galerkin_scores_bwd_bf16_ctas_per_sm(int dk, int p, int* ctas) {
  Args a{};
  a.dk = dk;
  a.p = p;
  return ctas == nullptr ? (int)cudaErrorInvalidValue : dispatch(a, ctas);
}

// k, v: (B*H, n, dk) contiguous bf16; pos: (B, n, p) bf16 or null with p = 0;
// scale/bias: (H, dk) float32; ds: (B*H, de, de) float32 with de = dk + p <= 128,
// dk <= 128.  Outputs: dk_out, dv_out (B*H, n, dk) bf16; dparams (4, H, dk)
// float32 holding bf16-rounded dscale_k, dbias_k, dscale_v, dbias_v; dpos
// (B, n, p) bf16, written only when dpos is not null, through the float32
// scratch dpos_h (B*H, n, p).  partial: (splits, B*H, 4, dk) float32 scratch.
// tickets: B*H + 1 ints, 0 before the launch and 0 again after it (the last
// CTAs reset them); launches that share them must be ordered on one stream.
// rows_per_split: a multiple of 64.  Returns the CUDA error code of the
// launches (0 on success): one launch, two with dpos.
extern "C" int galerkin_scores_bwd_bf16_launch(
    const void* k, const void* v, const void* pos, const float* scale_k,
    const float* bias_k, const float* scale_v, const float* bias_v, const float* ds,
    void* dk_out, void* dv_out, float* dpos_h, void* dpos, float* partial,
    float* dparams, int* tickets, int B, int H, int n, int dk, int p, int rows_per_split,
    int splits, float eps, void* stream) {
  if (n < 1 || B < 1 || H < 1 || splits < 1 || rows_per_split % kRows != 0 ||
      (size_t)(splits - 1) * rows_per_split >= (size_t)n || tickets == nullptr ||
      (p > 0) != (pos != nullptr) || (dpos != nullptr && (p == 0 || dpos_h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* scratch = dpos != nullptr ? dpos_h : nullptr;
  const Args a{(const bf16*)k, (const bf16*)v, (const bf16*)pos, scale_k, bias_k, scale_v,
               bias_v, ds, (bf16*)dk_out, (bf16*)dv_out, scratch, partial, dparams,
               tickets, B, H, n, dk, p, rows_per_split, splits, eps, s};
  int err = dispatch(a, nullptr);
  if (err != 0 || dpos == nullptr) return err;
  const size_t m = (size_t)B * n * p;
  dpos_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, (bf16*)dpos, B,
                                                                 H, n, p);
  return (int)cudaGetLastError();
}
