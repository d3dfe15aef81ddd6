// Galerkin attention scores on Hopper (sm_90a), bf16 inputs on the tensor cores.
//
// Replaces: ops/pallas/galerkin.py:46 of the JAX package, _scores_kernel
//   (launched by galerkin_scores_pallas, l.94) with bf16 K, V and pos (the
//   bf16 encoder dtype): LayerNorm statistics and affine in float32, the
//   result rounded to bf16, one bf16 matrix-unit pass with a float32 sum.
//
// Computes, for every (batch, head) pair bh,
//   S[bh] = [pos, bf16(LN_K(K[bh]))]^T [pos, bf16(LN_V(V[bh]))]   (d_eff x d_eff)
// unscaled, in float32.  K, V (B*H, n, d_k) and pos (B, n, p) are bf16; the
// LN scale and bias (H, d_k) are float32, as the model keeps its parameters.
// The bf16 LN output is the value galerkin_scores_bwd_bf16.cu recomputes:
// the same float32 sums in the same order, no fused multiply-add in the
// affine.
//
// What bounds it: bytes.  It reads K and V once (2 BH n d_k bf16) and does
// 2 BH n d_eff^2 flops on the tensor cores: about 97 flops a byte at
// d_eff = 97 and 18 at the ex2 width (d_k 32, p 2), far below the ~295 the
// card needs before the tensor cores are the limit.  At the ex2 serving shape
// (B, H, n, d_k, p) = (4, 4, 5041, 32, 2) it reads 10.3 MB of K and V in
// about 0.020 ms on an H100 SXM at 700 W, 0.5 TB/s, 15 % of the card's
// 3.35 TB/s (PERF.md row 3a).  What takes the time is the LayerNorm stage on
// the CUDA cores, which is bound by its instructions (most of a chunk's
// cycles), then the launch and the first copy, then the sum over the splits.
//
// What the design does about it:
//  * one launch, grid (BH, splits) from the occupancy query
//    (galerkin_scores_bf16_ctas_per_sm): each CTA owns a contiguous range of
//    rows, walked in chunks of 64, and writes a float32 partial of S through
//    shared memory as 16-byte stores.  The wrapper sizes a grid of more than
//    one split to fit on the card at once, and such a grid is launched
//    cooperatively (a grid that does not fit fails to launch): the CTAs of a
//    bh meet at a barrier on two counters per bh and each then sums its own
//    slice of S over the splits, so the sum is spread over the whole card.
//    Each element is summed in split order, so a call is bit-equal from run
//    to run; the last CTA to leave resets the counters for the next launch
//    (a CUDA graph of the launch replays bit-equal: tests/test_torch_cuda.py).
//    A grid of one split writes S directly;
//  * a ring of two stage buffers: cp.async copies (16 bytes where the source
//    is 16-byte aligned, 4 where a run of pos is only 4-byte aligned) bring
//    the next chunk's raw K, V and pos rows while the CTA works on this one
//    (three stages fit at two CTAs per SM and were no faster);
//  * warp w normalizes 16 rows of K (w < 4) or of V into a row-major bf16
//    tile as [pos, bf16(LN(x) scale + bias)]: eight lanes to a row, four rows
//    to a warp instruction, templated on d_k/32 rounded up (1..4) and on
//    whether d_k is a multiple of 32, so no register holds padding and no
//    column is predicated; a row's reductions take three shuffle levels; the
//    columns from d_eff to 16 DT are zeroed once per CTA;
//  * the product contracts over the 64 rows of the chunk, so both operands
//    are read transposed: ldmatrix.trans turns the tiles into the A (K'^T)
//    and B (V') fragments of mma.sync.m16n8k16 with float32 accumulators.
//    The DT x DT output blocks of 16 x 16 are dealt to the 8 warps in order,
//    so a warp's blocks share their A fragment where they share a block row.
//    The row stride of the tiles is 16 (2 DT + 1) bytes: the 8 rows of one
//    ldmatrix fall into 8 different 16-byte bank groups.
//    Two CTA barriers a chunk: after its copies land, and after LN.
// Shared memory per CTA (smem_bytes): 81,664 bytes at (d_k, p) = (96, 1), two
// 24,704-byte stages, two 15,360-byte tiles and the LN parameters, so two
// CTAs fit on an SM (three stages, 106,368 bytes, would fit too); 31,744
// bytes at (32, 2).  Registers: at most 128 (two CTAs per SM) up to d_k = 96
// and d_eff = 112, and 0 bytes of spill in every instantiation (`nvcc -Xptxas
// -v`, printed by `chip_smoke.py`); one CTA per SM above.  Its times: PERF.md
// row 3a (`chip_smoke.py`; against another checkout's kernel `chip_smoke.py
// --against ROOT --kernel galerkin_scores_bf16`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;        // sequence rows per chunk: 4 mma depths
constexpr int kBlockRows = 16;   // rows of K or V one warp normalizes per chunk
constexpr int kStages = 2;       // stage buffers in the cp.async ring
constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;
constexpr int kCounters = 2;     // per bh: arrivals, then departures
// Lanes that share one row in the LN stage: kLanes = 8 (4 rows to a warp
// instruction), lane j holding columns j + 8 k + 32 t (k < 4, t < C).  The
// sums are formed in the order of a warp per row whose lane m holds columns
// m + 32 t: per such lane in t order, then its xor levels 16 and 8 within
// the lane (lane_tree), then levels 4 .. 1 across the 8 lanes: the same
// additions in the same order as this kernel's earlier warp-per-row form and
// as galerkin_scores_bwd_bf16.cu, so the statistics agree bit for bit.
constexpr int kLanes = 8;
// Row instructions a warp runs at once in the LN stage, their reductions
// interleaved: two at d_k <= 32 and d_eff <= 80, where the LN parameters of a
// lane's columns are held in registers too; one where the accumulators of the
// product leave no room under the 128-register cap.
__host__ __device__ constexpr bool ln_narrow(int C, int DT) { return C == 1 && DT <= 5; }
__host__ __device__ constexpr int ln_batch(int C, int DT) { return ln_narrow(C, DT) ? 2 : 1; }
// Two CTAs per SM (registers capped at 128), but one above d_k = 96 (C = 4)
// or d_eff = 112 (DT = 8), where the accumulators and the LN registers do not
// fit in 128 and the shared memory of d_k near 128 leaves room for one CTA
// anyway.
__host__ __device__ constexpr int min_ctas(int C, int DT) { return C == 4 || DT == 8 ? 1 : 2; }

static_assert(kWarps * kBlockRows == 2 * kRows, "four warps for K's rows, four for V's");
static_assert(kStages >= 2, "a ring of at least two stages");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// The counters that order the CTAs of one bh (CUTLASS's split-K barrier):
// thread 0 adds with release semantics after a CTA barrier, so the CTA's
// earlier writes are visible to whoever acquires the count; it reads with
// acquire semantics before a CTA barrier, so the CTA's later reads see what
// the other CTAs wrote.
__device__ __forceinline__ void add_release(int* counter, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(counter), "r"(v) : "memory");
}
__device__ __forceinline__ int add_acq_rel(int* counter, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(counter), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ int load_acquire(const int* counter) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums each of the kN values across the L lanes of its row (xor levels
// L / 2 .. 1); the shuffles of the kN sums interleave, so one sum's latency
// hides behind the others.
template <int L, int kN>
__device__ __forceinline__ void row_sum(float (&x)[kN]) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
}

// a[k]: the partial sum of the warp-per-row lane j + (32 / R) k (R = 1: the
// lane itself).  Returns what that lane holds after its xor levels
// 16 .. 32 / R: the same additions in the same order, none fused.
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

// dst[i] = the sum over j < terms of src[i + j stride], in order of j, for i
// in [e0, e1): this thread's elements two at a time, with up to 16 terms of
// each in flight before any is added (the partials were written by other
// CTAs: read through L2).
__device__ __forceinline__ void ordered_sums(float* dst, const float* src, size_t stride,
                                             int terms, int e0, int e1) {
  constexpr int kE = 2, kT = 16;
  for (int i0 = e0 + threadIdx.x; i0 < e1; i0 += kE * kThreads) {
    float s[kE] = {};
    for (int j0 = 0; j0 < terms; j0 += kT) {
      float x[kE][kT];
#pragma unroll
      for (int e = 0; e < kE; ++e)
#pragma unroll
        for (int u = 0; u < kT; ++u)
          x[e][u] = i0 + e * kThreads < e1 && j0 + u < terms
                        ? __ldcg(src + i0 + e * kThreads + (size_t)(j0 + u) * stride)
                        : 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e)
#pragma unroll
        for (int u = 0; u < kT; ++u)
          if (j0 + u < terms) s[e] += x[e][u];
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (i0 + e * kThreads < e1) dst[i0 + e * kThreads] = s[e];
  }
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

// bf16 elements of one stage buffer: K rows at [0, kRows dk), V rows after
// them, then pos rows; rounded up so that the next buffer starts on 16 bytes.
__host__ __device__ constexpr int stage_elems(int dk, int p) {
  return (2 * kRows * dk + kRows * p + 7) / 8 * 8;
}
// float32 of one partial of S (de x de), rounded up so that each partial
// starts on 16 bytes
__host__ __device__ constexpr int partial_stride(int de) { return (de * de + 3) / 4 * 4; }
// Bytes of the dynamic shared memory: the K' and V' tiles (kRows x LD bf16
// each), kStages stage buffers and the LN parameters (4 x dk float32); at
// the end the CTA's partial lies over them.
__host__ __device__ constexpr int smem_bytes(int dt, int dk, int p) {
  return max(2 * (2 * kRows * (16 * dt + 8) + kStages * stage_elems(dk, p)) + 4 * 4 * dk,
             4 * partial_stride(dk + p));
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
// a stage buffer; each is one contiguous run.  The caller commits the group.
__device__ __forceinline__ void prefetch(bf16* stage, const bf16* kb, const bf16* vb,
                                         const bf16* pb, int c0, int row_end, int dk,
                                         int p) {
  const int rows = min(kRows, row_end - c0);
  copy_run(stage, kb + (size_t)c0 * dk, rows * dk);
  copy_run(stage + kRows * dk, vb + (size_t)c0 * dk, rows * dk);
  if (p > 0) copy_run(stage + 2 * kRows * dk, pb + (size_t)c0 * p, rows * p);
}

// Rows r0 .. r0 + 15 of one matrix (src: its raw rows in the stage buffer,
// ps: the pos rows), normalized into the tile as [pos, bf16(LN(x) scale +
// bias)] (the columns after them hold zeros from the start): statistics and
// affine in float32, the affine without fused multiply-add, as the plain
// version computes them; rows past row_end are written as zeros (their
// statistics come from whatever the stage buffer holds, and are not used).
// Lane j + L g takes row g of each instruction's 32 / L rows and its columns
// j + L k + 32 t; kFull: d_k = 32 C, so every one of them is a column.
template <int C, int kB, bool kFull>
__device__ __forceinline__ void ln_rows(const bf16* src, const bf16* ps, const float* scale,
                                        const float* bias, bf16* tile, int r0, int c0,
                                        int row_end, int dk, int p, int ld, float eps,
                                        int lane) {
  constexpr int L = kLanes, R = 32 / L, kRowsPerPass = kB * R;
  const int j = lane % L, g = lane / L;
  const bf16 zero = __float2bfloat16_rn(0.f);
  // the LN parameters of this lane's columns: held in registers where the
  // LN stage is narrow, read from shared memory where they are used
  // otherwise (the registers there are the product's)
  constexpr bool kHeld = kB == 2;
  float sc[R], bi[R];
  if constexpr (kHeld) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = min(j + L * k, dk - 1);
      sc[k] = scale[c];
      bi[k] = bias[c];
    }
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
          x[u][k][t] = kFull || c < dk ? __bfloat162float(src[r * dk + c]) : 0.f;
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
          x[u][k][t] = kFull || j + L * k + 32 * t < dk ? x[u][k][t] - s[u] : 0.f;
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
          if (kFull || c < dk) {
            const float y =
                kHeld ? __fadd_rn(__fmul_rn(__fmul_rn(x[u][k][t], rstd), sc[k]), bi[k])
                      : __fadd_rn(__fmul_rn(__fmul_rn(x[u][k][t], rstd), scale[c]), bias[c]);
            row[p + c] = __float2bfloat16_rn(valid[u] ? y : 0.f);
          }
        }
      if (j < p) row[j] = pv[u];
      for (int c = j + L; c < p; c += L) row[c] = valid[u] ? ps[r * p + c] : zero;
    }
  }
}

template <int C, int DT, bool kFull>
__global__ void __launch_bounds__(kThreads, min_ctas(C, DT))
scores_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ pos, const float* __restrict__ scale_k,
                   const float* __restrict__ bias_k, const float* __restrict__ scale_v,
                   const float* __restrict__ bias_v, float* __restrict__ partial,
                   float* __restrict__ out, int* __restrict__ tickets, int H, int n, int dk,
                   int p, int rows_per_split, float eps) {
  constexpr int DP = 16 * DT;                           // d_eff padded to the mma tile
  constexpr int LD = DP + 8;                            // row stride of the bf16 tiles
  constexpr int NB = (DT * DT + kWarps - 1) / kWarps;   // 16 x 16 output blocks per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);   // K' then V', kRows x LD each
  bf16* stage0 = tiles + 2 * kRows * LD;         // kStages x stage_elems(dk, p)
  const int stage_size = stage_elems(dk, p);
  float* affine = reinterpret_cast<float*>(stage0 + kStages * stage_size);

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the LN stage: warp w normalizes rows 16 (w % 4) .. + 15 of K (w < 4) or V
  const int which = warp / (kWarps / 2), r0 = kBlockRows * (warp % (kWarps / 2));
  const bf16* kb = k + (size_t)bh * n * dk;
  const bf16* vb = v + (size_t)bh * n * dk;
  const bf16* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;
  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);
  const int chunks = (row_end - row0 + kRows - 1) / kRows;

  // chunks 0 .. kStages - 2 in flight, one commit group each (empty past the
  // last chunk, so that every iteration below waits on the same count)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      prefetch(stage0 + s * stage_size, kb, vb, pb, row0 + s * kRows, row_end, dk, p);
    cp_async_commit();
  }
  // the tiles' columns from d_eff on are zeros for every chunk
  for (int i = tid; i < 2 * kRows * (DP - de); i += kThreads)
    tiles[i / (DP - de) * LD + de + i % (DP - de)] = __float2bfloat16_rn(0.f);
  for (int c = tid; c < dk; c += kThreads) {
    affine[c] = scale_k[h * dk + c];
    affine[dk + c] = bias_k[h * dk + c];
    affine[2 * dk + c] = scale_v[h * dk + c];
    affine[3 * dk + c] = bias_v[h * dk + c];
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

  // ldmatrix row addresses of this lane inside a 16 x 16 tile at (r, c):
  // A = K'^T: tiles (r, c), (r, c + 8), (r + 8, c), (r + 8, c + 8)
  const int a_row = (lane % 8) + 8 * (lane / 16), a_col = 8 * ((lane / 8) % 2);
  // B = V':   tiles (r, c), (r + 8, c), (r, c + 8), (r + 8, c + 8)
  const int b_row = (lane % 8) + 8 * ((lane / 8) % 2), b_col = 8 * (lane / 16);
  const bf16* ks = tiles;
  const bf16* vs = tiles + kRows * LD;

  for (int i = 0; i < chunks; ++i) {
    const int c0 = row0 + i * kRows;
    cp_async_wait<kStages - 2>();
    // chunk i has landed; every thread is done with chunk i - 1: its product
    // (the tiles) and its LN (the stage buffer that chunk i + kStages - 1 takes)
    __syncthreads();
    if (i + kStages - 1 < chunks)
      prefetch(stage0 + (i + kStages - 1) % kStages * stage_size, kb, vb, pb,
               c0 + (kStages - 1) * kRows, row_end, dk, p);
    cp_async_commit();
    const bf16* stage = stage0 + i % kStages * stage_size;
    ln_rows<C, ln_batch(C, DT), kFull>(
        stage + which * kRows * dk, stage + 2 * kRows * dk, affine + 2 * which * dk,
        affine + (2 * which + 1) * dk, tiles + which * kRows * LD, r0, c0, row_end, dk, p, LD,
        eps, lane);
    __syncthreads();
    // one 16-row depth of the chunk: A from K' rows r .. r + 15 (transposed),
    // B from V' rows r .. r + 15
    auto product_step = [&](int r) {
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      int a_block = -1;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int q = warp * NB + t;
        if (q < DT * DT) {
          const int mi = q / DT, nj = q % DT;
          if (mi != a_block) {
            ldmatrix_x4_trans(a, ks + (r + a_row) * LD + 16 * mi + a_col);
            a_block = mi;
          }
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, vs + (r + b_row) * LD + 16 * nj + b_col);
          mma_bf16(acc[t][0], a, bfrag[0], bfrag[1]);
          mma_bf16(acc[t][1], a, bfrag[2], bfrag[3]);
        }
      }
    };
    if constexpr (DT == 7) {   // 56 accumulators: one depth at a time, or it spills
#pragma unroll 1
      for (int r = 0; r < kRows; r += 16) product_step(r);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; r += 16) product_step(r);
    }
  }

  // The CTA's partial goes to global memory through shared memory (to S
  // itself when it is the only CTA of its bh).  With more than one split
  // every CTA of the grid is on the card at once (a cooperative launch), so
  // the CTAs of a bh meet at a barrier and CTA `split` then sums elements
  // [e0, e1) of S over the splits, in split order.
  const int splits = gridDim.y;
  const int count = de * de, stride = partial_stride(de);
  const size_t dd = (size_t)count;
  __syncthreads();   // every warp is done with the tiles
  float* red = reinterpret_cast<float*>(smem);
  // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
  // column 2 * (lane % 4) + e % 2
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
          if (ri < de && cj < de) red[ri * de + cj] = acc[t][j][e];
        }
    }
  }
  __syncthreads();
  if (splits == 1) {
    for (int i = tid; i < count; i += kThreads) out[bh * dd + i] = red[i];
    return;
  }
  float4* part = reinterpret_cast<float4*>(partial + ((size_t)split * BH + bh) * stride);
  for (int i = tid; i < stride / 4; i += kThreads) part[i] = reinterpret_cast<const float4*>(red)[i];
  int* counter = tickets + kCounters * bh;
  __syncthreads();   // every partial of this CTA is written
  if (tid == 0) {
    add_release(counter, 1);
    while (load_acquire(counter) < splits) __nanosleep(32);
  }
  __syncthreads();   // every CTA of this bh has written its partial
  ordered_sums(out + bh * dd, partial + (size_t)bh * stride, (size_t)BH * stride, splits,
               count * split / splits, count * (split + 1) / splits);
  __syncthreads();   // this CTA is done reading the partials
  // the last CTA to leave resets both counters for the next launch
  if (tid == 0 && add_acq_rel(counter + 1, 1) == splits - 1) counter[0] = counter[1] = 0;
}

struct Args {
  const bf16 *k, *v, *pos;
  const float *scale_k, *bias_k, *scale_v, *bias_v;
  float *partial, *out;
  int* tickets;
  int B, H, n, dk, p, rows_per_split, splits;
  float eps;
  cudaStream_t stream;
};

// Lets the instantiation take the dynamic shared memory that (d_k, p) needs,
// once per device and size: the largest it has been asked for so far, with
// the most of each SM's memory given to shared memory, as the occupancy
// query assumes (a cooperative launch is sized by it).
template <int C, int DT, bool kFull>
int allow_smem(int dev, int bytes) {
  static int allowed[kMaxDevices];
  if (allowed[dev] < bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        scores_bf16_kernel<C, DT, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scores_bf16_kernel<C, DT, kFull>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  return 0;
}

// How many CTAs of the instantiation fit on one SM at `bytes` of shared
// memory (*ctas), asked once per device and size.
template <int C, int DT, bool kFull>
int ctas_per_sm(int dev, int bytes, int* ctas) {
  static int asked_bytes[kMaxDevices], fit[kMaxDevices];
  if (asked_bytes[dev] != bytes) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit[dev], scores_bf16_kernel<C, DT, kFull>, kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    asked_bytes[dev] = bytes;
  }
  *ctas = fit[dev];
  return 0;
}

// Launches the instantiation (ctas == nullptr) or reports how many of its
// CTAs fit on one SM at this (d_k, p) (*ctas).  A grid of more than one
// split is launched cooperatively, so the CTAs of a bh may wait for each
// other; one that does not fit on the card at once fails to launch.
template <int C, int DT, bool kFull>
int run(const Args& a, int* ctas) {
  const int bytes = smem_bytes(DT, a.dk, a.p);
  int dev, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int rc = allow_smem<C, DT, kFull>(dev, bytes);
  if (rc == 0) rc = ctas_per_sm<C, DT, kFull>(dev, bytes, &per_sm);
  if (rc != 0) return rc;
  if (ctas != nullptr) {
    *ctas = per_sm;
    return 0;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.B * a.H, a.splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = a.stream;
  cudaLaunchAttribute cooperative;
  cooperative.id = cudaLaunchAttributeCooperative;
  cooperative.val.cooperative = 1;
  config.attrs = &cooperative;
  config.numAttrs = a.splits > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&config, scores_bf16_kernel<C, DT, kFull>, a.k, a.v, a.pos,
                                 a.scale_k, a.bias_k, a.scale_v, a.bias_v, a.partial, a.out,
                                 a.tickets, a.H, a.n, a.dk, a.p, a.rows_per_split, a.eps);
}

// The instantiation for d_eff padded to 16 dt and d_k/32 rounded up to C,
// kFull where d_k = 32 C; the ones that no (d_k, p) reaches are not built.
template <int C>
int by_width(int dt, const Args& a, int* ctas) {
  switch (dt) {
#define GT_SCORES_CASE(T)                                                           \
  case T:                                                                           \
    if constexpr (16 * T >= 32 * C)                                                 \
      if (a.dk == 32 * C) return run<C, T, true>(a, ctas);                          \
    if constexpr (16 * T > 32 * (C - 1)) return run<C, T, false>(a, ctas);          \
    break;
    GT_SCORES_CASE(1) GT_SCORES_CASE(2) GT_SCORES_CASE(3) GT_SCORES_CASE(4)
    GT_SCORES_CASE(5) GT_SCORES_CASE(6) GT_SCORES_CASE(7) GT_SCORES_CASE(8)
#undef GT_SCORES_CASE
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
extern "C" int galerkin_scores_bf16_ctas_per_sm(int dk, int p, int* ctas) {
  Args a{};
  a.dk = dk;
  a.p = p;
  return ctas == nullptr ? (int)cudaErrorInvalidValue : dispatch(a, ctas);
}

// k, v: (B*H, n, dk) contiguous bf16; pos: (B, n, p) bf16 or null with p = 0;
// scale/bias: (H, dk) float32; partial: (splits, B*H, (de de + 3) / 4 * 4)
// float32 scratch;
// out: (B*H, de, de) float32.  de = dk + p <= 128, dk <= 128.  tickets: 2 B*H
// ints, 0 before the launch and 0 again after it (the last CTAs reset them);
// launches that share them must be ordered on one stream.  rows_per_split: a
// multiple of 64, with (splits - 1) * rows_per_split < n <= splits *
// rows_per_split; with splits > 1 the B*H*splits CTAs must fit on the card at
// once (galerkin_scores_bf16_ctas_per_sm per SM), or the launch fails.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int galerkin_scores_bf16_launch(const void* k, const void* v, const void* pos,
                                           const float* scale_k, const float* bias_k,
                                           const float* scale_v, const float* bias_v,
                                           float* partial, float* out, int* tickets, int B,
                                           int H, int n, int dk, int p, int rows_per_split,
                                           int splits, float eps, void* stream) {
  if (n < 1 || B < 1 || H < 1 || splits < 1 || rows_per_split < kRows ||
      rows_per_split % kRows != 0 || (size_t)(splits - 1) * rows_per_split >= (size_t)n ||
      (size_t)splits * rows_per_split < (size_t)n || tickets == nullptr ||
      (p > 0) != (pos != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const bf16*)k, (const bf16*)v, (const bf16*)pos, scale_k, bias_k, scale_v,
               bias_v, partial, out, tickets, B, H, n, dk, p, rows_per_split, splits, eps,
               (cudaStream_t)stream};
  return dispatch(a, nullptr);
}
