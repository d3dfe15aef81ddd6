// Galerkin attention scores on Hopper (sm_90a), float32, on the tensor cores.
//
// Replaces: ops/pallas/galerkin.py:46 of the JAX package, _scores_kernel
//   (launched by galerkin_scores_pallas, l.94, through pallas_call, l.124)
//   with float32 K, V and pos: LayerNorm statistics and affine in float32,
//   the product pinned to full float32 precision (Precision.HIGHEST, l.78-82).
//
// Computes, for every (batch, head) pair bh,
//   S[bh] = [pos, LN_K(K[bh])]^T [pos, LN_V(V[bh])]      (d_eff x d_eff, unscaled)
// in float32.  K, V (B*H, n, d_k) and pos (B, n, p) are float32, pos shared
// by the heads of a batch; the LN scale and bias are (H, d_k) float32.
//
// What bounds it: at the ex1 shape (B, H, n, d_k, p) = (8, 1, 8192, 96, 1) it
// reads 50.6 MB (0.0151 ms at 3.35 TB/s) and does 2 BH n d_eff^2 = 1.23
// GFLOP: 0.0184 ms on the CUDA cores at 67 TFLOP/s (more, padded to the
// tile), 0.0075 ms as six bf16 passes on the tensor cores.  So the product
// goes to the tensor cores at float32 accuracy: each float32 LN output x is
// cut into three bf16 parts whose sum is x exactly (split3, as
// csrc/fourier_chain.cuh cuts its operands), and a product is the six part
// products i + j <= 2, smallest first (the dropped terms are below 2^-24 of
// the largest).  The tensor cores truncate long float32 sums, so each 64-row
// chunk is summed into fresh fragments that are then added to float32
// running sums on the CUDA cores.  At the ex2 shape (4, 4, 5041, 32, 2) it
// reads 20.6 MB and does 0.19 GFLOP: bytes.  On an H100 SXM (PERF.md row 1)
// mma.sync runs about one m16n8k16 each 8 cycles on an SM sub-partition, so
// at ex1 the product of a chunk takes about as long as its copies, and LN
// about as long again.
//
// What the design does about it:
//  * one launch, grid (BH, splits) from the occupancy query
//    (galerkin_scores_ctas_per_sm): each CTA owns a contiguous range of rows,
//    walked in chunks of 64.  The wrapper sizes a grid of more than one split
//    to fit on the card at once, and such a grid is launched cooperatively
//    (a grid that does not fit fails to launch): the CTAs of a bh meet at a
//    barrier on two counters per bh and each then sums its own slice of S
//    over the splits, in split order, so a call is bit-equal from run to run;
//    the last CTA to leave resets the counters for the next launch (a CUDA
//    graph of the launch replays bit-equal).  A grid of one split writes S
//    directly;
//  * a ring of two stage buffers: cp.async copies (16 bytes where the source
//    is 16-byte aligned, 4 where a run, such as pos at odd b, is not) bring
//    raw K, V and pos rows; a buffer takes the chunk after next as soon as LN
//    has read it, so two chunks are in flight during each product.  The
//    ragged last chunk is masked in the LN stage, no padded copy;
//  * warp w normalizes 16 rows of K (w < 4) or of V: eight lanes to a row,
//    four rows to a warp instruction and up to four of its instructions at
//    once (ln_batch), each lane two adjacent columns at a time (a float2
//    where d_k = 32 C, the two rows of a half-warp on other banks),
//    templated on d_k/32 rounded up (C) and on whether d_k = 32 C, so no
//    register holds padding; a row's reductions take three shuffle levels and
//    are the additions of a warp per row in the same order (mean, then the
//    two-pass variance, then rsqrtf of it over d_k plus eps);
//  * the three parts of each LN output go to three bf16 tiles per operand as
//    pairs.  With pos of at most two columns and d_k <= 96 (kPosOut: ex1 and
//    ex2) the tiles hold the d_k LN columns alone, and the rows and columns
//    of S that pos gives are float32 sums of pos times the LN outputs, formed
//    by the LN lanes in registers: the single pos column of ex1 would
//    otherwise take a seventh m16 row and a thirteenth n8 column of tiles
//    (98 tiles for 72).  Else the tiles hold [LN(x) (d_k), pos (p)].  The
//    rows and columns are put back in S's order [pos, LN(x)] when S is
//    written;
//  * the product contracts over the chunk's rows, so both operands are read
//    transposed by ldmatrix.trans into mma.sync.m16n8k16 fragments.  The
//    warps share the m16 x n8 output tiles as a 2 x 4 grid (9 tiles a warp
//    at d_k = 96, one at 32), or as 8 column strips for the widest tiles,
//    with loops that are the same in every warp and branch-free (a per-tile
//    condition put each tile in its own block and ran its six dependent mma
//    one after another: 0.127 ms at ex1 on an H100 SXM).  Tile rows are
//    16 (2 DT + 1) bytes apart (the 8 rows of one ldmatrix in 8 bank
//    groups); at DT = 8 the 16-byte units of row r are permuted by r % 8
//    instead (no padding: d_k = 128 then fits two stages and the six tiles
//    in 227 KB).
//    Two CTA barriers a chunk: after its copies land, and after LN.
// Shared memory per CTA (smem_bytes): 180,224 bytes at (d_k, p) = (96, 1),
// one CTA per SM; 65,024 at (32, 2), two.  Registers and spills per
// instantiation: `nvcc -Xptxas -v`, printed by chip_smoke.py.  Its times:
// PERF.md row 1 (chip_smoke.py; against another checkout's kernel
// `chip_smoke.py --against ROOT --kernel galerkin_scores`).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;        // sequence rows per chunk: 4 mma depths
constexpr int kBlockRows = 16;   // rows of K or V one warp normalizes per chunk
constexpr int kStages = 2;       // stage buffers in the cp.async ring
constexpr int kParts = 3;        // bf16 parts of a float32 value
constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;
constexpr int kCounters = 2;     // per bh: arrivals, then departures
constexpr int kLanes = 8;        // lanes of one LN row
// pos widths whose rows and columns of S the LN stage sums in float32 where
// d_k <= 96 (the product on the tensor cores then covers the d_k x d_k block
// alone); wider pos, or wider d_k, goes through the tiles with LN(x)
constexpr int kMaxPosOut = 2;
// work bits of a launch: the wrapper runs both; chip_smoke.py times each
// stage alone by leaving the other out (the result is then not S)
constexpr int kWorkLn = 1, kWorkProduct = 2;

static_assert(kWarps * kBlockRows == 2 * kRows, "four warps for K's rows, four for V's");

// The widest tiles (d > 96 columns, DT >= 7), whose product's registers
// leave no room for the LN parameters in registers or for four LN rows at once.
__host__ __device__ constexpr bool held(int DT) { return DT < 7; }
// Row instructions a warp normalizes at once, their reductions interleaved:
// all four of its rows of a chunk, or two (the widest tiles, and d_k <= 32
// with two CTAs per SM and d > 48).
__host__ __device__ constexpr int ln_batch(int C, int DT) {
  return !held(DT) || (C == 1 && DT == 4) ? 2 : 4;
}

// One CTA per SM above d_k = 32 or 64 tile columns, where the stage buffers
// and the six tiles leave no room for two (registers uncapped up to 255).
__host__ __device__ constexpr int min_ctas(int C, int DT) { return C == 1 && DT <= 4 ? 2 : 1; }

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
// waits until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// x = part[0] + part[1] + part[2] exactly, each part a bf16 value held in a
// float32 (its low 16 bits zero): csrc/fourier_chain.cuh's split3.
__device__ __forceinline__ void split3(float x, float (&part)[kParts]) {
  part[0] = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r = x - part[0];
  part[1] = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  part[2] = r - part[1];
}
// the bf16 values held by two float32 as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint16_t top16(float x) {
  return static_cast<uint16_t>(__float_as_uint(x) >> 16);
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

// 8 x 8 bf16 tiles, each read transposed; lane l gives the address of row
// l % 8 of tile l / 8 (x2: lanes 0 .. 15)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const uint16_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row stride of the bf16 part tiles (their d_k or d_eff columns padded to
// 16 DT): 8 columns of padding, or none at DT = 8, where the units are
// permuted.
__host__ __device__ constexpr int tile_ld(int DT) { return DT == 8 ? 128 : 16 * DT + 8; }
// Offset of element (r, c) in a part tile; c and c + 1 (c even) lie side by
// side, and so do the 8 columns of a 16-byte unit (c a multiple of 8).
template <int DT>
__device__ __forceinline__ int tile_at(int r, int c) {
  if constexpr (DT == 8)
    return r * 128 + (c ^ ((r & 7) << 3));
  else
    return r * tile_ld(DT) + c;
}
// float32 of one stage buffer: K rows at [0, kRows dk), V rows after them,
// then pos rows; rounded up so that the next buffer starts on 16 bytes
__host__ __device__ constexpr int stage_floats(int dk, int p) {
  return (2 * kRows * dk + kRows * p + 3) / 4 * 4;
}
// float32 of one partial of S (de x de), rounded up so that each partial
// starts on 16 bytes
__host__ __device__ constexpr int partial_stride(int de) { return (de * de + 3) / 4 * 4; }
// Bytes of the dynamic shared memory: the six part tiles (kRows x tile_ld
// bf16 each), kStages stage buffers and the LN parameters (4 x dk float32);
// at the end the CTA's partial and the warps' pos sums lie over them.
__host__ __device__ constexpr int smem_bytes(int dt, int dk, int p) {
  return max(2 * 2 * kParts * kRows * tile_ld(dt) + 4 * (kStages * stage_floats(dk, p) + 4 * dk),
             4 * (partial_stride(dk + p) + kWarps * kMaxPosOut * (dk + kMaxPosOut)));
}

// Starts the copy of `count` float32 from global src to shared dst (16-byte
// aligned): 16 bytes per cp.async where src is 16-byte aligned, 4 otherwise.
__device__ __forceinline__ void copy_run(float* dst, const float* src, int count) {
  int done = 0;
  if (reinterpret_cast<size_t>(src) % 16 == 0) {
    done = count / 4 * 4;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads) cp_async16(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) cp_async4(dst + i, src + i);
}

// Starts the copy of rows [c0, min(c0 + kRows, row_end)) of K, V and pos into
// a stage buffer; each is one contiguous run.  The caller commits the group.
__device__ __forceinline__ void prefetch(float* stage, const float* kb, const float* vb,
                                         const float* pb, int c0, int row_end, int dk, int p) {
  const int rows = min(kRows, row_end - c0);
  copy_run(stage, kb + (size_t)c0 * dk, rows * dk);
  copy_run(stage + kRows * dk, vb + (size_t)c0 * dk, rows * dk);
  if (p > 0) copy_run(stage + 2 * kRows * dk, pb + (size_t)c0 * p, rows * p);
}

// Rows r0 .. r0 + 15 of one matrix (src: its raw rows in the stage buffer,
// ps: the pos rows), normalized and cut into the three part tiles as
// [LN(x) scale + bias, pos] (kPosOut: without pos; the columns after them
// hold zeros from the start); rows past row_end are written as zeros (their
// statistics come from whatever the stage buffer holds, and are not used).
// kPosOut: pacc[a] += pos[a] LN(x) for this lane's columns and a < p, in
// float32, and pp[a][b] += pos[a] pos[b] in lanes 0, 8, 16, 24.
// Lane j + 8 g takes row g of each instruction's 4 rows and its columns
// 2 j + e + 16 k + 32 t (e, k < 2, t < C): as in a warp per row whose lane
// m = c % 32 holds columns m + 32 t, the sums are formed per such lane in t
// order, then its xor level 16 (k) within the lane, levels 8 .. 2 across the
// 8 lanes (j) and level 1 (e) within the lane.  Where d_k = 32 C (kFull) the
// odd rows of an instruction take their two 16-column halves in the other
// order (the same additions: level 16 pairs them), so a half-warp's float2
// loads fall on 32 banks; every column is then a column of the row.
// The affine: this lane's scale and bias in registers (sc, bi), or read
// from shared memory (scale, bias) where registers are short (!held(DT)).
template <int C, int DT, bool kFull, bool kPosOut, int kLnBatch = ln_batch(C, DT)>
__device__ __forceinline__ void ln_rows(const float* src, const float* ps,
                                        const float (&sc)[2][2][C], const float (&bi)[2][2][C],
                                        const float* scale, const float* bias, uint16_t* tile,
                                        float (&pacc)[kMaxPosOut][2][2][C],
                                        float (&pp)[kMaxPosOut][kMaxPosOut], int r0, int c0,
                                        int row_end, int dk, int p, float eps, int lane) {
  constexpr int R = 32 / kLanes;               // rows of one warp instruction
  static_assert(kBlockRows % (kLnBatch * R) == 0, "whole LN passes");
  constexpr int kPartSize = kRows * tile_ld(DT);
  const int j = lane % kLanes, g = lane / kLanes;
  const int flip = kFull ? (g & 1) : 0;
#pragma unroll 1
  for (int pass = 0; pass < kBlockRows / (kLnBatch * R); ++pass) {
    float x[kLnBatch][2][2][C], s[kLnBatch][2], q[kLnBatch][2];
    bool valid[kLnBatch];
#pragma unroll
    for (int u = 0; u < kLnBatch; ++u) {
      const int r = r0 + (kLnBatch * pass + u) * R + g;
      valid[u] = c0 + r < row_end;
      const float* row = src + r * dk;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = 2 * j + 16 * (k ^ flip) + 32 * t;
          if constexpr (kFull) {
            const float2 v = *reinterpret_cast<const float2*>(row + c);
            x[u][k][0][t] = v.x;
            x[u][k][1][t] = v.y;
          } else {
            x[u][k][0][t] = c < dk ? row[c] : 0.f;
            x[u][k][1][t] = c + 1 < dk ? row[c + 1] : 0.f;
          }
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          a[k] = 0.f;
#pragma unroll
          for (int t = 0; t < C; ++t) a[k] += x[u][k][e][t];
        }
        s[u][e] = __fadd_rn(a[0], a[1]);
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kLnBatch; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[u][e] += __shfl_xor_sync(0xffffffffu, s[u][e], o);
#pragma unroll
    for (int u = 0; u < kLnBatch; ++u) {
      const float mean = __fadd_rn(s[u][0], s[u][1]) / dk;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          a[k] = 0.f;
#pragma unroll
          for (int t = 0; t < C; ++t) {
            const int c = 2 * j + e + 16 * (k ^ flip) + 32 * t;
            const float dev = kFull || c < dk ? x[u][k][e][t] - mean : 0.f;
            x[u][k][e][t] = dev;
            a[k] += dev * dev;
          }
        }
        q[u][e] = __fadd_rn(a[0], a[1]);
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kLnBatch; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) q[u][e] += __shfl_xor_sync(0xffffffffu, q[u][e], o);
    // every load before the first store: the stores go to shared memory too,
    // so the compiler cannot move a load above one.  pv: the row's pos
    // (kPosOut: columns 0 .. p - 1, else column j), 0 past row_end
    float pv[kLnBatch][kMaxPosOut];
#pragma unroll
    for (int u = 0; u < kLnBatch; ++u) {
      const float* prow = ps + (r0 + (kLnBatch * pass + u) * R + g) * p;
#pragma unroll
      for (int a = 0; a < kMaxPosOut; ++a) {
        const int c = kPosOut ? a : j;
        pv[u][a] = valid[u] && c < p && (kPosOut || a == 0) ? prow[c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kLnBatch; ++u) {
      const int r = r0 + (kLnBatch * pass + u) * R + g;
      const float rstd = rsqrtf(__fadd_rn(q[u][0], q[u][1]) / dk + eps);
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = 2 * j + 16 * (k ^ flip) + 32 * t;
          if (kFull || c < dk) {
            float y[2][kParts];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float scl = held(DT) ? sc[k][e][t] : scale[min(c + e, dk - 1)];
              const float bia = held(DT) ? bi[k][e][t] : bias[min(c + e, dk - 1)];
              const float ln = valid[u] ? x[u][k][e][t] * rstd * scl + bia : 0.f;
              if constexpr (kPosOut) {
#pragma unroll
                for (int a = 0; a < kMaxPosOut; ++a)
                  pacc[a][k][e][t] = fmaf(pv[u][a], ln, pacc[a][k][e][t]);
              }
              split3(ln, y[e]);
            }
            const int at = tile_at<DT>(r, c);
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
              if (kFull || c + 1 < dk)
                *reinterpret_cast<uint32_t*>(tile + part * kPartSize + at) =
                    pack(y[0][part], y[1][part]);
              else   // d_k odd: column d_k is pos's, or zero
                tile[part * kPartSize + at] = top16(y[0][part]);
            }
          }
        }
      if constexpr (kPosOut) {
        if (j == 0)
#pragma unroll
          for (int a = 0; a < kMaxPosOut; ++a)
#pragma unroll
            for (int b2 = 0; b2 < kMaxPosOut; ++b2) pp[a][b2] = fmaf(pv[u][a], pv[u][b2], pp[a][b2]);
      } else {
        for (int c = j; c < p; c += kLanes) {
          float y[kParts];
          split3(c == j ? pv[u][0] : (valid[u] ? ps[r * p + c] : 0.f), y);
          const int at = tile_at<DT>(r, dk + c);
#pragma unroll
          for (int part = 0; part < kParts; ++part) tile[part * kPartSize + at] = top16(y[part]);
        }
      }
    }
  }
}

template <int C, int DT, bool kFull, bool kPosOut>
__global__ void __launch_bounds__(kThreads, min_ctas(C, DT))
scores_kernel(const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ pos, const float* __restrict__ scale_k,
              const float* __restrict__ bias_k, const float* __restrict__ scale_v,
              const float* __restrict__ bias_v, float* __restrict__ partial,
              float* __restrict__ out, int* __restrict__ tickets, int H, int n, int dk, int p,
              int rows_per_split, float eps, int work) {
  constexpr int DP = 16 * DT;                 // the tiles' columns, padded to m16
  constexpr int kPartSize = kRows * tile_ld(DT);
  constexpr int MT = DT, NT = 2 * DT;         // m16 and n8 tiles of the tiles' product
  // warp w owns the RM x RN output tiles from (wm RM, wn RN) of a WM x WN
  // grid of warps, moved back to end at the last tile where MT or NT is
  // short: 2 x 4 (9 tiles a warp at d_k = 96, 1 at 32), or 1 x 8 (column
  // strips, fewer B fragments held) for the widest tiles
  constexpr int WM = held(DT) ? 2 : 1, WN = kWarps / WM;
  constexpr int RM = (MT + WM - 1) / WM, RN = (NT + WN - 1) / WN;
  extern __shared__ __align__(16) unsigned char smem[];
  // K' parts 0, 1, 2, then V' parts 0, 1, 2
  uint16_t* tiles = reinterpret_cast<uint16_t*>(smem);
  float* stage0 = reinterpret_cast<float*>(tiles + 2 * kParts * kPartSize);
  const int stage_size = stage_floats(dk, p);
  float* affine = stage0 + kStages * stage_size;

  const int bh = blockIdx.x, split = blockIdx.y, BH = gridDim.x;
  const int h = bh % H, b = bh / H;
  const int de = dk + p;
  const int dt = kPosOut ? dk : de;           // columns of the tiles that hold data
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the LN stage: warp w normalizes rows 16 (w % 4) .. + 15 of K (w < 4) or V
  const int which = warp / (kWarps / 2), r0 = kBlockRows * (warp % (kWarps / 2));
  const float* kb = k + (size_t)bh * n * dk;
  const float* vb = v + (size_t)bh * n * dk;
  const float* pb = p > 0 ? pos + (size_t)b * n * p : nullptr;
  const int row0 = split * rows_per_split;
  const int row_end = min(n, row0 + rows_per_split);
  const int chunks = (row_end - row0 + kRows - 1) / kRows;

  // chunks 0 .. kStages - 1 in flight, one commit group each (empty past the
  // last chunk, so that every iteration below waits on the same count)
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < chunks)
      prefetch(stage0 + s * stage_size, kb, vb, pb, row0 + s * kRows, row_end, dk, p);
    cp_async_commit();
  }
  // the tiles' columns from dt on are zeros for every chunk
  for (int row = tid; row < 2 * kParts * kRows; row += kThreads)
    for (int c = dt; c < DP; ++c) tiles[row / kRows * kPartSize + tile_at<DT>(row % kRows, c)] = 0;
  for (int c = tid; c < dk; c += kThreads) {
    affine[c] = scale_k[h * dk + c];
    affine[dk + c] = bias_k[h * dk + c];
    affine[2 * dk + c] = scale_v[h * dk + c];
    affine[3 * dk + c] = bias_v[h * dk + c];
  }
  __syncthreads();
  const float* scale = affine + 2 * which * dk;
  const float* bias = scale + dk;
  // the LN parameters of this lane's columns (ln_rows' order; 0 past d_k),
  // where they are held in registers
  float sc[2][2][C], bi[2][2][C];
  if constexpr (held(DT)) {
    const int j = lane % kLanes, flip = kFull ? (lane / kLanes) & 1 : 0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const int c = 2 * j + e + 16 * (kk ^ flip) + 32 * t;
          sc[kk][e][t] = c < dk ? scale[c] : 0.f;
          bi[kk][e][t] = c < dk ? bias[c] : 0.f;
        }
  }
  // kPosOut: this lane's float32 sums of pos[a] LN(x) and pos[a] pos[b]
  float pacc[kMaxPosOut][2][2][C], pp[kMaxPosOut][kMaxPosOut];
#pragma unroll
  for (int a = 0; a < kMaxPosOut; ++a) {
#pragma unroll
    for (int b2 = 0; b2 < kMaxPosOut; ++b2) pp[a][b2] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int t = 0; t < C; ++t) pacc[a][kk][e][t] = 0.f;
  }

  // sum[i][j]: the running float32 sum of the warp's output tile
  // (m0 + i, n0 + j); tiles past the data are summed (zeros) and not written,
  // so the loops are the same in every warp and branch-free
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = min(wm * RM, MT - RM), n0 = min(wn * RN, NT - RN);
  float sum[RM][RN][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < RN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][jj][e] = 0.f;

  // ldmatrix row addresses of this lane inside a tile at (r, c):
  // A = K'^T: 8 x 8 tiles (r, c), (r, c + 8), (r + 8, c), (r + 8, c + 8)
  const int a_row = (lane % 8) + 8 * (lane / 16), a_col = 8 * ((lane / 8) % 2);
  // B = V':   8 x 8 tiles (r, c), (r + 8, c)
  const int b_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const uint16_t* ks = tiles;
  const uint16_t* vs = tiles + kParts * kPartSize;

  for (int i = 0; i < chunks; ++i) {
    const int c0 = row0 + i * kRows;
    cp_async_wait<kStages - 1>();
    // chunk i has landed; every thread is done with the product of chunk
    // i - 1 (the tiles)
    __syncthreads();
    float* stage = stage0 + i % kStages * stage_size;
    if (work & kWorkLn)
      ln_rows<C, DT, kFull, kPosOut>(stage + which * kRows * dk, stage + 2 * kRows * dk, sc,
                                     bi, scale, bias, tiles + which * kParts * kPartSize, pacc,
                                     pp, r0, c0, row_end, dk, p, eps, lane);
    __syncthreads();
    // every thread is done with chunk i's stage buffer: chunk i + kStages
    // takes it while the CTA runs this chunk's product and the next LN
    if (i + kStages < chunks)
      prefetch(stage, kb, vb, pb, c0 + kStages * kRows, row_end, dk, p);
    cp_async_commit();
    if (!(work & kWorkProduct)) continue;
    // the chunk's sums start anew: the tensor cores truncate long sums
    float fresh[RM][RN][4];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[ii][jj][e] = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; r += 16) {
      uint32_t bf[RN][kParts][2];
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
#pragma unroll
        for (int part = 0; part < kParts; ++part)
          ldmatrix_x2_trans(bf[jj][part],
                            vs + part * kPartSize + tile_at<DT>(r + b_row, 8 * (n0 + jj)));
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) {
        uint32_t a[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part)
          ldmatrix_x4_trans(a[part],
                            ks + part * kPartSize + tile_at<DT>(r + a_row, 16 * (m0 + ii) + a_col));
        // the part products i + j <= 2, smallest first
#pragma unroll
        for (int jj = 0; jj < RN; ++jj) {
          mma_bf16(fresh[ii][jj], a[2], bf[jj][0]);
          mma_bf16(fresh[ii][jj], a[1], bf[jj][1]);
          mma_bf16(fresh[ii][jj], a[0], bf[jj][2]);
          mma_bf16(fresh[ii][jj], a[1], bf[jj][0]);
          mma_bf16(fresh[ii][jj], a[0], bf[jj][1]);
          mma_bf16(fresh[ii][jj], a[0], bf[jj][0]);
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[ii][jj][e] += fresh[ii][jj][e];
  }

  // The CTA's partial goes to global memory through shared memory (to S
  // itself when it is the only CTA of its bh), its rows and columns put back
  // in S's order [pos, LN(x)].  With more than one split every CTA of the
  // grid is on the card at once (a cooperative launch), so the CTAs of a bh
  // meet at a barrier and CTA `split` then sums elements [e0, e1) of S over
  // the splits, in split order.
  const int splits = gridDim.y;
  const int count = de * de, stride = partial_stride(de);
  const size_t dd = (size_t)count;
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the tiles and the stage buffers
  float* red = reinterpret_cast<float*>(smem);
  auto s_index = [&](int i) { return i < dk ? i + p : i - dk; };
  // accumulator element e of a 16 x 8 tile: row lane / 4 + 8 * (e / 2),
  // column 2 * (lane % 4) + e % 2
#pragma unroll
  for (int ii = 0; ii < RM; ++ii)
#pragma unroll
    for (int jj = 0; jj < RN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = 16 * (m0 + ii) + lane / 4 + 8 * (e / 2);
        const int cj = 8 * (n0 + jj) + 2 * (lane % 4) + e % 2;
        if (m0 + ii >= wm * RM && n0 + jj >= wn * RN && ri < dt && cj < dt)
          red[s_index(ri) * de + s_index(cj)] = sum[ii][jj][e];
      }
  if constexpr (kPosOut) {
    // the pos rows and columns: each warp's sums over its lanes' rows (xor
    // levels 8 and 16), then over the four warps of K or of V in order
    float* pos_part = red + stride;           // [warp][a][column]
    float* pp_part = pos_part + kWarps * kMaxPosOut * dk;   // [K warp][a][b]
    const int flip = kFull ? (lane / kLanes) & 1 : 0;
#pragma unroll
    for (int a = 0; a < kMaxPosOut; ++a) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int t = 0; t < C; ++t) {
            // slot kk of a lane holds the 16 columns kk ^ flip: the sums
            // over rows pair the lanes' slots of one column
            float x = flip ? pacc[a][kk ^ 1][e][t] : pacc[a][kk][e][t];
            x += __shfl_xor_sync(0xffffffffu, x, 8);
            x += __shfl_xor_sync(0xffffffffu, x, 16);
            const int c = 2 * (lane % kLanes) + e + 16 * kk + 32 * t;
            if (lane < kLanes && a < p && c < dk) pos_part[(warp * kMaxPosOut + a) * dk + c] = x;
          }
#pragma unroll
      for (int b2 = 0; b2 < kMaxPosOut; ++b2) {
        float x = pp[a][b2];
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (lane == 0 && which == 0) pp_part[(warp * kMaxPosOut + a) * kMaxPosOut + b2] = x;
      }
    }
    __syncthreads();
    // S[p + c][a] from K' (warps 0 .. 3), S[a][p + c] from V' (warps 4 .. 7)
    for (int i = tid; i < 2 * p * dk; i += kThreads) {
      const int side = i / (p * dk), a = i / dk % p, c = i % dk;
      float x = 0.f;
      for (int w = 0; w < kWarps / 2; ++w)
        x += pos_part[((side * kWarps / 2 + w) * kMaxPosOut + a) * dk + c];
      red[side == 0 ? (p + c) * de + a : a * de + p + c] = x;
    }
    if (tid < p * p) {
      float x = 0.f;
      for (int w = 0; w < kWarps / 2; ++w)
        x += pp_part[(w * kMaxPosOut + tid / p) * kMaxPosOut + tid % p];
      red[tid / p * de + tid % p] = x;
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
  const float *k, *v, *pos;
  const float *scale_k, *bias_k, *scale_v, *bias_v;
  float *partial, *out;
  int* tickets;
  int B, H, n, dk, p, rows_per_split, splits;
  float eps;
  int work;
  cudaStream_t stream;
};

// Lets the instantiation take the dynamic shared memory that (d_k, p) needs,
// once per device and size: the largest it has been asked for so far, with
// the most of each SM's memory given to shared memory, as the occupancy
// query assumes (a cooperative launch is sized by it).
template <int C, int DT, bool kFull, bool kPosOut>
int allow_smem(int dev, int bytes) {
  static int allowed[kMaxDevices];
  if (allowed[dev] < bytes) {
    cudaError_t err = cudaFuncSetAttribute(scores_kernel<C, DT, kFull, kPosOut>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scores_kernel<C, DT, kFull, kPosOut>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  return 0;
}

// How many CTAs of the instantiation fit on one SM at `bytes` of shared
// memory (*ctas), asked once per device and size.
template <int C, int DT, bool kFull, bool kPosOut>
int ctas_per_sm(int dev, int bytes, int* ctas) {
  static int asked_bytes[kMaxDevices], fit[kMaxDevices];
  if (asked_bytes[dev] != bytes) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit[dev], scores_kernel<C, DT, kFull, kPosOut>, kThreads, bytes);
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
template <int C, int DT, bool kFull, bool kPosOut>
int run(const Args& a, int* ctas) {
  const int bytes = smem_bytes(DT, a.dk, a.p);
  int dev, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int rc = allow_smem<C, DT, kFull, kPosOut>(dev, bytes);
  if (rc == 0) rc = ctas_per_sm<C, DT, kFull, kPosOut>(dev, bytes, &per_sm);
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
  return (int)cudaLaunchKernelEx(&config, scores_kernel<C, DT, kFull, kPosOut>, a.k, a.v,
                                 a.pos, a.scale_k, a.bias_k, a.scale_v, a.bias_v, a.partial,
                                 a.out, a.tickets, a.H, a.n, a.dk, a.p, a.rows_per_split, a.eps,
                                 a.work);
}

// The instantiation for tiles of 16 dt columns and d_k/32 rounded up to C,
// kFull where d_k = 32 C, kPosOut where p <= kMaxPosOut (the tiles then hold
// d_k columns, else d_k + p); the ones that no (d_k, p) reaches are not
// built.
template <int C, bool kPosOut>
int by_width(int dt, const Args& a, int* ctas) {
  switch (dt) {
#define GT_SCORES_CASE(T)                                                           \
  case T:                                                                           \
    if constexpr (!kPosOut || (T <= 2 * C && held(T))) {                            \
      if constexpr (16 * T >= 32 * C)                                               \
        if (a.dk == 32 * C) return run<C, T, true, kPosOut>(a, ctas);               \
      if constexpr (16 * T > 32 * (C - 1)) return run<C, T, false, kPosOut>(a, ctas);  \
    }                                                                               \
    break;
    GT_SCORES_CASE(1) GT_SCORES_CASE(2) GT_SCORES_CASE(3) GT_SCORES_CASE(4)
    GT_SCORES_CASE(5) GT_SCORES_CASE(6) GT_SCORES_CASE(7) GT_SCORES_CASE(8)
#undef GT_SCORES_CASE
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kPosOut>
int by_dk(int dt, const Args& a, int* ctas) {
  switch ((a.dk + 31) / 32) {
    case 1: return by_width<1, kPosOut>(dt, a, ctas);
    case 2: return by_width<2, kPosOut>(dt, a, ctas);
    case 3: return by_width<3, kPosOut>(dt, a, ctas);
    case 4: return by_width<4, kPosOut>(dt, a, ctas);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int* ctas) {
  const int de = a.dk + a.p;
  if (a.dk < 1 || a.dk > kMaxD || a.p < 0 || de > kMaxD) return (int)cudaErrorInvalidValue;
  if (a.p <= kMaxPosOut && held((a.dk + 15) / 16)) return by_dk<true>((a.dk + 15) / 16, a, ctas);
  return by_dk<false>((de + 15) / 16, a, ctas);
}

}  // namespace

// How many CTAs of the kernel for (dk, p) fit on one SM of the current
// device (*ctas); the wrapper sizes its grid from it.  Returns a CUDA error
// code (0 on success).
extern "C" int galerkin_scores_ctas_per_sm(int dk, int p, int* ctas) {
  Args a{};
  a.dk = dk;
  a.p = p;
  return ctas == nullptr ? (int)cudaErrorInvalidValue : dispatch(a, ctas);
}

// k, v: (B*H, n, dk) contiguous float32; pos: (B, n, p) float32 or null with
// p = 0; scale/bias: (H, dk) float32; partial: (splits, B*H, (de de + 3) / 4
// * 4) float32 scratch; out: (B*H, de, de) float32.  de = dk + p <= 128,
// dk <= 128.  tickets: 2 B*H ints, 0 before the launch and 0 again after it
// (the last CTAs reset them); launches that share them must be ordered on
// one stream.  rows_per_split: a multiple of 64, with (splits - 1) *
// rows_per_split < n <= splits * rows_per_split; with splits > 1 the
// B*H*splits CTAs must fit on the card at once (galerkin_scores_ctas_per_sm
// per SM), or the launch fails.  work: 3 (LN and the product); 1 or 2 leave
// one stage out, for timing only.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int galerkin_scores_launch(const float* k, const float* v, const float* pos,
                                      const float* scale_k, const float* bias_k,
                                      const float* scale_v, const float* bias_v,
                                      float* partial, float* out, int* tickets, int B, int H,
                                      int n, int dk, int p, int rows_per_split, int splits,
                                      float eps, int work, void* stream) {
  if (n < 1 || B < 1 || H < 1 || splits < 1 || rows_per_split < kRows ||
      rows_per_split % kRows != 0 || (size_t)(splits - 1) * rows_per_split >= (size_t)n ||
      (size_t)splits * rows_per_split < (size_t)n || tickets == nullptr ||
      (p > 0) != (pos != nullptr) || work < 0 || work > (kWorkLn | kWorkProduct))
    return (int)cudaErrorInvalidValue;
  const Args a{k, v, pos, scale_k, bias_k, scale_v, bias_v, partial, out, tickets, B, H, n,
               dk, p, rows_per_split, splits, eps, work, (cudaStream_t)stream};
  return dispatch(a, nullptr);
}
