// Layout-parametric GEMM for Hopper (sm_90a) on bf16 operands: the same two
// functions as gemm.cu, for A and B in bfloat16.
//
// Replaces the bf16 case of the TPU kernels `gemm_pallas` (`_gemm_kernel`)
// and `gemm_panel_pallas` (`_panel_kernel`) of src/repro/kernels/gemm.py,
// which take any operand dtype and accumulate in float32.
//
// What it computes (A and B bf16; the sum in float32):
//   layout_gemm_bf16_kernel:        C = A @ B (+ acc): acc (bf16 or float32)
//                                   added in float32 after the product, C
//                                   (bf16 or float32) rounded once to nearest
//   layout_gemm_panel_bf16_kernel:  panel[j-block jb] += A @ B, in place, the
//                                   panel (bf16 or float32) read, added to in
//                                   float32 and rounded once to its dtype
// Operand orientations are gemm.cu's (the C/A/B "majors" of the paper's
// Fig. 3): A is logical (i, k), buffer (M, K) or, when A_T, (K, M); B is
// logical (k, j), buffer (K, N) or, when B_T, (N, K); C is (M, ldc) or, when
// transposed, (N.., ldc) with i contiguous.  No operand is transposed by a
// pass of its own.
//
// Arithmetic: one `wgmma.mma_async m64n128k16 .f32.bf16.bf16` product per
// 16-deep k step, both operands read from shared memory.  A product of two
// bf16 values is exact in float32; the tensor cores add into their float32
// accumulator with truncation, so the products of each FOLD k-tiles (512
// deep) go into a partial sum that starts from zero and the partial is
// added to the running sum with a round-to-nearest `fadd` (Ootomo and
// Yokota, 2022).  Measured on an H100 (kernels/gemm_ab.py --bf16), the
// whole sum in the accumulator errs 10-18x as much as a float32 product at
// K = 4096-16384, past the port's bound of 10x; partials of 8 k-tiles err
// no more than it does.  Within a partial the products of one k-tile run
// while the next is awaited (wgmma.wait_group 1).  The reference's order,
// product first and acc after, is kept; the output is rounded once.  Every
// store path and schedule below computes the same sums in the same order,
// so their outputs are bitwise equal.
//
// Bound: 2*M*N*K operations at 989 TFLOP/s (bf16, H100 SXM) against 2 bytes
// an element of A and B and the output's and acc's own widths at 3.35 TB/s:
// operations bound at the case study's EXTRALARGE (0.0149 ms against
// 0.0070-0.0164 ms of bytes).  What holds the kernel above it, measured on
// an H100 (kernels/gemm_ab.py --bf16, builds with parts cut out): the
// k-tile loads pace the main loop (0.024-0.040 ms at EXTRALARGE, growing
// with the TMA boxes a k-tile takes: 2 with both operands K-major, 4 with
// both MN-major), and an epilogue that stores from the accumulators adds
// 0.018-0.029 ms on top, since no product runs while it stores.  Hence the
// store through shared memory below, which the next tile's products
// overlap.  B shared by a 2-block cluster (TMA multicast, half the L2 reads
// of B) measured slower in every majors and is not built.
//
// Design:
//   * Operands: bf16 `wgmma` reads A and B from shared memory in either
//     major order (its transpose bits), so both land straight from device
//     memory in the 128-byte-swizzled layout of a TMA box and no pass
//     touches them.  A k-tile is 64 deep, one 128-byte row of bf16.  A
//     K-major tile (A not A_T, B_T) is one box of 64 k x R rows, row r at
//     r * 128 bytes, 16-byte chunk c at c ^ r % 8: descriptors of SBO 1 KB
//     (8 rows), the k16 step kk 32 kk bytes into the row.  An MN-major tile
//     (A_T, B not B_T) is R / 64 boxes of 64 k rows x 64 MN values, 8 KB
//     apart: descriptors of SBO 1 KB (8 k rows), LBO 8 KB (the next 64
//     MN values), the k16 step kk 2 KB (16 k rows) into the box, and the
//     transpose bit set.  (The attention kernels read V this way.)
//   * Block: 384 threads.  Warpgroup 0 loads k-tiles; warpgroups 1 and 2
//     multiply, each 64 rows of a 128 x 128 output tile.  A consumer holds
//     64 accumulators and 64 partial sums; `setmaxnreg` moves registers
//     from the loaders (64 a thread) to the consumers (216), within the
//     168 x 384 registers the block launched with (setmaxnreg takes no
//     more: a consumer's increase past them waits forever).
//   * Loads: a ring of k-tiles (32 KB each), an mbarrier pair per stage
//     (full: landed; empty: read by the products of all consumer warps that
//     read it).  Two loaders, one template each; the caller chooses.  TMA
//     (one thread, 2-D tensor maps passed as __grid_constant__, boxes past
//     the edges zero-filled by the hardware; a box wholly past the edge is
//     not loaded, since it feeds only output rows or columns that are never
//     stored) when A's and B's bases are 16-byte aligned and their row
//     strides multiples of 8 elements.  Else (an odd K or N, a view's offset
//     base) the 128 loader threads copy the tile element by element with
//     plain loads into the same swizzled layout, zeros past the edges, and
//     make their stores visible to the tensor cores before they arrive.
//   * Schedule: persistent, one block per SM, 128 x 128 tiles taken in a
//     fixed stride by block, rasterised in groups of 8 tile rows for L2
//     reuse; the loader runs ahead into the next tile while the consumers
//     finish the last one (the TMA loader's one thread works out a tile's
//     origin once, not once a k-tile: its work between two loads paces
//     them).  At EXTRALARGE (2048 x 2560) that is 16 x 20 = 320 tiles on
//     132 SMs.  Each output element is summed by one thread in one fixed k
//     order, so two launches on the same inputs are bitwise equal.
//   * Store, two paths; the caller chooses (kernels/gemm.py:store_path_bf16).
//     TMA, behind the TMA loader, when C's (and acc's) base is 16-byte
//     aligned and the tensor maps' strides are multiples of 16 bytes.  Each
//     consumer warpgroup writes its 64 x 128 sums into a staging buffer of
//     shared memory in the output's own major order, as 128-byte-swizzled
//     boxes (bf16 by `stmatrix`, `.trans` for a j-major C; float32 by
//     8-byte stores placed so that no two lanes of a half warp share a
//     bank, or 4-byte ones for a j-major C), so that the global write runs
//     along the output's contiguous axis in whole lines.  One thread issues
//     the boxes' TMA stores (3-D maps whose third axis is the panel's
//     j-block, so a tile past N is clipped at its own block and the block
//     index can come from the device), and the warpgroup goes on to the
//     next tile's products at once.  It waits for the stores to have read
//     the buffer only after its next tile's first k-tile is issued; then
//     that thread brings the new tile's acc, or the panel's block, into the
//     buffer by a TMA load, which lands while the tile's products run (no
//     handshake with the loader warpgroup), and the epilogue adds it from
//     shared memory.  acc may be the output itself: each tile is read
//     before it is written, by one block.  Direct (any shape and
//     alignment, and every shape behind the plain loads, which pace the
//     kernel with their copies: there the TMA store gained nothing,
//     measured on an H100, and lost 11% on a float32 panel): from the
//     accumulators, a fragment's two adjacent values in one 4-byte (bf16)
//     or 8-byte (float32) store where C is i-major and the address allows
//     it, acc read from device memory.
//   * Shared memory, one block an SM (227 KB): the TMA store takes 5 ring
//     stages (160 KB) and 64 KB of staging (each warpgroup's 64 x 128 in
//     float32, the widest output or acc) plus 1 KB of alignment and
//     barriers; the direct store 6 stages (192 KB) and no staging.
//
// The panel kernel takes the block index jb either by value or through a
// pointer to one int32 on the device (no host sync); jb is clamped to
// [0, nb) like the reference's dynamic_slice.  Blocks of the panel outside
// jb are never touched.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                // output tile rows: two warpgroups of 64
constexpr int BN = 128;                // output tile columns: wgmma n128
constexpr int BK = 64;                 // k-tile depth: one 128-byte row of bf16
constexpr int BOX = 64;                // bf16 values of a 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int FOLD = 8;                // k-tiles a partial sums before its rounded add (0: none)
constexpr int PRODUCERS = 128;         // warpgroup 0 loads
constexpr int LOADER_REGS = 64;        // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 216;
constexpr int CONSUMERS = 256;         // warpgroups 1 and 2
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int ACC = BN / 2;            // accumulators a consumer thread holds
constexpr int WG_ROWS = 64;            // output rows of a consumer warpgroup
constexpr int GROUP_M = 8;             // tile rows per raster group
constexpr int TILE_A = BM * BK * 2;    // bytes of a k-tile of A
constexpr int TILE_B = BN * BK * 2;
constexpr int STAGE = TILE_A + TILE_B;
constexpr int BOX_BYTES = BOX * BK * 2;  // an MN-major box: 64 k rows x 64 values
constexpr int WG_STAGING = WG_ROWS * BN * 4;  // a warpgroup's tile in float32
constexpr int STAGING = 2 * WG_STAGING;
static_assert(PRODUCERS * LOADER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * 168,
              "setmaxnreg moves registers within the block's own (168 a thread at launch)");
static_assert(BK * 2 == ROW_BYTES, "a k-tile row is one 128-byte swizzle span");
static_assert(STAGE % 1024 == 0 && TILE_A % 1024 == 0, "every tile starts on 1 KB");

enum Loader : int { PLAIN = 0, TMA = 1 };
enum Store : int { DIRECT = 0, TMA_STORE = 1 };

template <int STORE>
__host__ __device__ constexpr int stages() {
  return STORE == TMA_STORE ? 5 : 6;
}

// barriers: full and empty a stage, and acc landed in a warpgroup's
// staging buffer
template <int STORE>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<STORE>() * STAGE + (STORE == TMA_STORE ? STAGING : 0) +
         (2 * stages<STORE>() + 2) * 8;
}
static_assert(smem_bytes<TMA_STORE>() <= 227 * 1024 && smem_bytes<DIRECT>() <= 227 * 1024,
              "one block per SM");

struct Maps {
  CUtensorMap a;
  CUtensorMap b;
  CUtensorMap c;    // the output (TMA store)
  CUtensorMap acc;  // acc (TMA store with acc; the panel uses c)
};

struct Params {
  const uint16_t* a;
  const uint16_t* b;
  const void* acc;  // null: no sum (the panel kernel adds the panel itself)
  void* c;
  int M, N, K, lda, ldb, ldc;
  int c_trans, tiles_m, tiles_n;
  int acc_bf16, out_bf16;  // dtypes of acc and of the output (the panel: both)
  int nb;
  const int* jb_dev;
  int jb_host;
};

__device__ __forceinline__ void tma_load(unsigned char* dst, const CUtensorMap* map, int c0,
                                         int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle mode.
__device__ __forceinline__ uint64_t desc(const unsigned char* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (uint64_t{1} << 62);
}

// k16 step kk of an operand tile whose first row (K-major) or first box
// (MN-major) is at `tile`.
template <bool MN>
__device__ __forceinline__ uint64_t desc_step(const unsigned char* tile, int kk) {
  return MN ? desc(tile + kk * 16 * ROW_BYTES, BOX_BYTES, 8 * ROW_BYTES)
            : desc(tile + kk * 32, 16, 8 * ROW_BYTES);
}

#define BF_F8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define BF_F32(d, i) BF_F8(d, i), BF_F8(d, i + 8), BF_F8(d, i + 16), BF_F8(d, i + 24)

// d (64 x 128) = A B (+ d unless scale_d is 0) over one k16 step, both from
// shared memory; TA / TB: A / B MN-major (wgmma's transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : BF_F32(d, 0), BF_F32(d, 32)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef BF_F8
#undef BF_F32

// Copies one k-tile of an operand (logical (x, k), x its R-long tile axis;
// the buffer contiguous along k when KC) into the layout TMA's boxes give
// it, element by element with plain loads, zeros past the edges (x >=
// extent, k >= K).  Thread t takes elements t, t + PRODUCERS, ... in buffer
// order, so a warp reads 32 consecutive elements of a row.
template <bool KC, int R>
__device__ __forceinline__ void plain_tile(unsigned char* dst, const uint16_t* base, int ld,
                                           int x0, int extent, int k0, int K, int t) {
#pragma unroll 4
  for (int e = t; e < R * BK; e += PRODUCERS) {
    const int x = KC ? e / BK : e % R, k = KC ? e % BK : e / R;
    const int gx = x0 + x, gk = k0 + k;
    uint16_t v = 0;
    if (gx < extent && gk < K) v = base[KC ? (long long)gx * ld + gk : (long long)gk * ld + gx];
    const int off = KC ? x * ROW_BYTES + ((((k >> 3) ^ x) & 7) << 4) + (k & 7) * 2
                       : (x / BOX) * BOX_BYTES + k * ROW_BYTES +
                             (((((x % BOX) >> 3) ^ k) & 7) << 4) + (x & 7) * 2;
    *reinterpret_cast<uint16_t*>(dst + off) = v;
  }
}

__device__ __forceinline__ float load_f32(const void* base, long long off, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off])
              : static_cast<const float*>(base)[off];
}

// The panel's block index, clamped to [0, nb) (0 for the GEMM).
template <bool PANEL>
__device__ __forceinline__ int block_index(const Params& p) {
  if (!PANEL) return 0;
  const int jb = p.jb_dev != nullptr ? *p.jb_dev : p.jb_host;
  return jb < 0 ? 0 : (jb >= p.nb ? p.nb - 1 : jb);
}

// Stores one output tile straight from the accumulators: C = A@B (+ acc),
// the reference's order (dot, then add), rounded once to the output's
// dtype; the panel form adds the panel's own block.  wgmma's fragment:
// d[4c + 2h + e] is row 16wq + lane/4 + 8h, column 8c + 2(lane%4) + e of the
// warpgroup's 64 x 128 product.  acc may be the output itself (each element
// is read and written by one thread); a chunk of it is loaded before any of
// it is stored, so the loads are in flight together.  Where C is i-major,
// a fragment's two adjacent values go out in one store if its address is
// aligned to both.
template <bool PANEL>
__device__ __forceinline__ void epilogue_direct(const float (&d)[ACC], const Params& p, int i0,
                                                int j0, int ct) {
  const int wg = ct >> 7, wq = (ct >> 5) & 3, lane = ct & 31;
  const long long col0 = (long long)block_index<PANEL>(p) * p.N;
  const void* acc = PANEL ? p.c : p.acc;
  const bool acc_bf16 = PANEL ? p.out_bf16 : p.acc_bf16;
  const int gi0 = i0 + wg * 64 + wq * 16 + (lane >> 2);
  const int gj0 = j0 + 2 * (lane & 3);
  constexpr int CHUNK = 16;  // accumulators per batch of loads
#pragma unroll
  for (int r0 = 0; r0 < ACC; r0 += CHUNK) {
    long long off[CHUNK];
    float v[CHUNK];
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int r = r0 + q;
      const int gi = gi0 + 8 * ((r >> 1) & 1), gj = gj0 + 8 * (r >> 2) + (r & 1);
      off[q] = gi < p.M && gj < p.N ? (p.c_trans ? (col0 + gj) * p.ldc + gi
                                                 : (long long)gi * p.ldc + col0 + gj)
                                    : -1;
      v[q] = d[r];
    }
    if (acc != nullptr) {
#pragma unroll
      for (int q = 0; q < CHUNK; ++q)
        if (off[q] >= 0) v[q] = __fadd_rn(v[q], load_f32(acc, off[q], acc_bf16));
    }
#pragma unroll
    for (int q = 0; q < CHUNK; q += 2) {  // q, q + 1: columns gj, gj + 1 of one row
      const bool pair = off[q] >= 0 && off[q + 1] == off[q] + 1;
      if (p.out_bf16) {
        __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c);
        if (pair && (reinterpret_cast<uintptr_t>(c + off[q]) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(c + off[q]) = __floats2bfloat162_rn(v[q], v[q + 1]);
        } else {
          if (off[q] >= 0) c[off[q]] = __float2bfloat16_rn(v[q]);
          if (off[q + 1] >= 0) c[off[q + 1]] = __float2bfloat16_rn(v[q + 1]);
        }
      } else {
        float* c = static_cast<float*>(p.c);
        if (pair && (reinterpret_cast<uintptr_t>(c + off[q]) & 7) == 0) {
          *reinterpret_cast<float2*>(c + off[q]) = make_float2(v[q], v[q + 1]);
        } else {
          if (off[q] >= 0) c[off[q]] = v[q];
          if (off[q + 1] >= 0) c[off[q + 1]] = v[q + 1];
        }
      }
    }
  }
}

// --- the TMA store's staging buffer -------------------------------------
// A warpgroup's 64 x 128 tile (rows i, columns j of its part of the output)
// in the output's major order, as the boxes of its tensor map land:
//   i-major, E-byte values, V = 128 / E a box row: 128 / V boxes of 64 rows
//     x 128 bytes, 8 KB apart; (i, j) in box j / V, row i;
//   j-major: 64 / V boxes of 128 j rows x 128 bytes, 16 KB apart; (i, j) in
//     box i / V, row j;
// 16-byte chunk x of row r at (x ^ r % 8) * 16 (the 128-byte swizzle).

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(128) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of the 8 x 8 bf16 matrix row that lane supplies to
// stmatrix/ldmatrix .x4 number x4 (fragment columns 16 x4 ... 16 x4 + 15):
// matrix m = lane / 8 holds d[8 x4 + 2m], d[8 x4 + 2m + 1], i.e. column
// group c = 2 x4 + m / 2, row half h = m % 2.
__device__ __forceinline__ int bf16_row_offset(bool c_trans, int x4, int wq, int lane) {
  const int m = lane >> 3, rho = lane & 7, c = 2 * x4 + (m >> 1), h = m & 1;
  if (!c_trans) {  // row i = 16 wq + 8 h + rho, columns 8c..8c+7: box c / 8, chunk c % 8
    const int i = 16 * wq + 8 * h + rho;
    return (c >> 3) * 8192 + i * ROW_BYTES + (((c & 7) ^ rho) << 4);
  }
  // transposed: row j = 8c + rho holds i = 16 wq + 8 h .. + 7, chunk 2 wq + h
  return (8 * c + rho) * ROW_BYTES + (((2 * wq + h) ^ rho) << 4);
}

// Byte offset of float32 value (i, j) of the tile.
__device__ __forceinline__ int f32_offset(bool c_trans, int i, int j) {
  if (!c_trans)
    return (j >> 5) * 8192 + i * ROW_BYTES + (((((j & 31) >> 2) ^ i) & 7) << 4) + (j & 3) * 4;
  return (i >> 5) * 16384 + j * ROW_BYTES + (((((i & 31) >> 2) ^ j) & 7) << 4) + (i & 3) * 4;
}

// d += the acc tile in the staging buffer (bf16 or float32), each sum
// rounded to nearest.  An i-major float32 tile is read in pairs: lanes of
// odd rows take column group c ^ 2 where the others take c, so that no two
// lanes of a half warp share a bank.
__device__ __forceinline__ void add_staged(float (&d)[ACC], const unsigned char* stg, bool bf16,
                                           bool c_trans, int wq, int lane) {
  if (bf16) {
#pragma unroll
    for (int x4 = 0; x4 < 8; ++x4) {
      uint32_t r[4];
      const uint32_t addr = smem_u32(stg + bf16_row_offset(c_trans, x4, wq, lane));
      if (c_trans)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(addr)
                     : "memory");
      else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(addr)
                     : "memory");
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r[m]);
        d[8 * x4 + 2 * m] = __fadd_rn(d[8 * x4 + 2 * m], __low2float(v));
        d[8 * x4 + 2 * m + 1] = __fadd_rn(d[8 * x4 + 2 * m + 1], __high2float(v));
      }
    }
    return;
  }
  const int row = lane >> 2, col = 2 * (lane & 3);
  if (c_trans) {
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int i = 16 * wq + row + 8 * ((r >> 1) & 1), j = 8 * (r >> 2) + col + (r & 1);
      d[r] = __fadd_rn(d[r], *reinterpret_cast<const float*>(stg + f32_offset(true, i, j)));
    }
    return;
  }
  const bool odd = row & 1;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c & 2) continue;  // c and c ^ 2 together
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * wq + 8 * h + row;
      const int c1 = odd ? c ^ 2 : c, c2 = c1 ^ 2;
      const float2 x = *reinterpret_cast<const float2*>(stg + f32_offset(false, i, 8 * c1 + col));
      const float2 y = *reinterpret_cast<const float2*>(stg + f32_offset(false, i, 8 * c2 + col));
      const float2 at_c = odd ? y : x, at_c2 = odd ? x : y;
      const int r = 4 * c + 2 * h, r2 = 4 * (c ^ 2) + 2 * h;
      d[r] = __fadd_rn(d[r], at_c.x);
      d[r + 1] = __fadd_rn(d[r + 1], at_c.y);
      d[r2] = __fadd_rn(d[r2], at_c2.x);
      d[r2 + 1] = __fadd_rn(d[r2 + 1], at_c2.y);
    }
  }
}

// Writes the warpgroup's sums into the staging buffer, rounded once to the
// output's dtype (bf16 by stmatrix; float32 as add_staged reads it).
__device__ __forceinline__ void stage_out(const float (&d)[ACC], unsigned char* stg, bool bf16,
                                          bool c_trans, int wq, int lane) {
  if (bf16) {
#pragma unroll
    for (int x4 = 0; x4 < 8; ++x4) {
      const uint32_t addr = smem_u32(stg + bf16_row_offset(c_trans, x4, wq, lane));
      const uint32_t r0 = pack_bf16(d[8 * x4], d[8 * x4 + 1]);
      const uint32_t r1 = pack_bf16(d[8 * x4 + 2], d[8 * x4 + 3]);
      const uint32_t r2 = pack_bf16(d[8 * x4 + 4], d[8 * x4 + 5]);
      const uint32_t r3 = pack_bf16(d[8 * x4 + 6], d[8 * x4 + 7]);
      if (c_trans)
        asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
                     ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                     : "memory");
      else
        asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                     ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                     : "memory");
    }
    return;
  }
  const int row = lane >> 2, col = 2 * (lane & 3);
  if (c_trans) {
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int i = 16 * wq + row + 8 * ((r >> 1) & 1), j = 8 * (r >> 2) + col + (r & 1);
      *reinterpret_cast<float*>(stg + f32_offset(true, i, j)) = d[r];
    }
    return;
  }
  const bool odd = row & 1;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c & 2) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * wq + 8 * h + row;
      const int r = 4 * c + 2 * h, r2 = 4 * (c ^ 2) + 2 * h;
      const float2 at_c = make_float2(d[r], d[r + 1]), at_c2 = make_float2(d[r2], d[r2 + 1]);
      const int c1 = odd ? c ^ 2 : c, c2 = c1 ^ 2;
      *reinterpret_cast<float2*>(stg + f32_offset(false, i, 8 * c1 + col)) = odd ? at_c2 : at_c;
      *reinterpret_cast<float2*>(stg + f32_offset(false, i, 8 * c2 + col)) = odd ? at_c : at_c2;
    }
  }
}

// The boxes of warpgroup wg's part of tile (i0, j0) that hold output, for
// the map of an output or acc of E-byte values: calls fn(offset in the
// staging buffer, c0, c1, c2) for each (the map's coordinates: (j, jb, i) i-major, (i, j,
// jb) j-major) and returns their bytes.
template <typename Fn>
__device__ __forceinline__ int staged_boxes(const Params& p, bool bf16, int i0, int j0, int wg,
                                            int jb, Fn fn) {
  const int v = bf16 ? 64 : 32, r0 = i0 + WG_ROWS * wg;
  int bytes = 0;
  if (!p.c_trans) {
    if (r0 >= p.M) return 0;
    for (int b = 0; b < BN / v; ++b)
      if (j0 + b * v < p.N) fn(b * 8192, j0 + b * v, jb, r0), bytes += 8192;
  } else {
    for (int b = 0; b < WG_ROWS / v; ++b)
      if (r0 + b * v < p.M) fn(b * 16384, r0 + b * v, j0, jb), bytes += 16384;
  }
  return bytes;
}

// Sums, rounds and stores one tile through the staging buffer (see the note
// at the head): acc (or the panel's block) awaited and added, the sums
// staged, and the boxes stored by the warpgroup's first thread, which keeps
// `pending` while its stores may still read the buffer.
template <bool PANEL>
__device__ __forceinline__ void epilogue_tma(float (&d)[ACC], const Params& p, const Maps& maps,
                                             unsigned char* stg, uint64_t* acc_full, int i0,
                                             int j0, int n, int ct, bool& pending) {
  const int wg = ct >> 7, wq = (ct >> 5) & 3, lane = ct & 31;
  const bool c_trans = p.c_trans;
  if (PANEL || p.acc != nullptr) {
    mbar_wait(acc_full, n & 1);
    add_staged(d, stg, PANEL ? p.out_bf16 : p.acc_bf16, c_trans, wq, lane);
  }
  wg_sync(wg);  // acc read by all, and the last tile's stores done reading
  stage_out(d, stg, p.out_bf16, c_trans, wq, lane);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA store
  wg_sync(wg);
  if ((ct & 127) == 0) {
    const int jb = block_index<PANEL>(p);
    const int bytes = staged_boxes(p, p.out_bf16, i0, j0, wg, jb, [&](int off, int c0, int c1,
                                                                       int c2) {
      tma_store_3d(&maps.c, stg + off, c0, c1, c2);
    });
    if (bytes > 0) {
      bulk_commit();
      pending = true;
    }
  }
}

template <bool A_T, bool B_T, int LOADER, bool PANEL, int STORE>
__device__ __forceinline__ void gemm_body(const Maps& maps, const Params& p) {
  constexpr int S = stages<STORE>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* staging = ring + S * STAGE;  // the TMA store's; 1 KB aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + (STORE == TMA_STORE ? STAGING : 0));
  uint64_t* empty = full + S;        // k-tile read by the products of all consumer warps
  uint64_t* acc_full = empty + S;    // acc landed in a warpgroup's staging buffer
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], LOADER == TMA ? 1 : PRODUCERS);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int w = 0; w < 2; ++w) mbar_init(&acc_full[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = (p.K + BK - 1) / BK;
  const int tiles = p.tiles_m * p.tiles_n;
  const bool has_acc = PANEL || p.acc != nullptr;

  if (tid < PRODUCERS) {  // the loader warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LOADER_REGS));
    // k-tile (i0, j0, k0) into ring slot q % S
    auto load = [&](int q, int i0, int j0, int k0) {
      unsigned char* sa = ring + (q % S) * STAGE;
      unsigned char* sb = sa + TILE_A;
      uint64_t* bar = &full[q % S];
      mbar_wait(&empty[q % S], ((q / S) & 1) ^ 1);  // the first round passes at once
      if (LOADER == TMA) {
        // a box wholly past the edge is skipped: it would only feed rows
        // (A) or columns (B) of the product that are not stored
        const int boxes_a = A_T ? (min(p.M - i0, BM) + BOX - 1) / BOX : 0;
        const int boxes_b = B_T ? 0 : (min(p.N - j0, BN) + BOX - 1) / BOX;
        mbar_expect_tx(bar, (A_T ? boxes_a * BOX_BYTES : TILE_A) +
                                (B_T ? TILE_B : boxes_b * BOX_BYTES));
        if (A_T)
          for (int h = 0; h < boxes_a; ++h) tma_load(sa + h * BOX_BYTES, &maps.a, i0 + h * BOX, k0, bar);
        else
          tma_load(sa, &maps.a, k0, i0, bar);
        if (B_T)
          tma_load(sb, &maps.b, k0, j0, bar);
        else
          for (int h = 0; h < boxes_b; ++h) tma_load(sb + h * BOX_BYTES, &maps.b, j0 + h * BOX, k0, bar);
      } else {
        plain_tile<!A_T, BM>(sa, p.a, p.lda, i0, p.M, k0, p.K, tid);
        plain_tile<B_T, BN>(sb, p.b, p.ldb, j0, p.N, k0, p.K, tid);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
        mbar_arrive(bar);
      }
    };
    if (LOADER == TMA) {
      // one thread; a tile's origin once, not once a k-tile (the thread's
      // work between two loads is what paces them)
      if (tid == 0) {
        int q = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          int i0, j0;
          tile_origin<BM, BN, GROUP_M>(t, p.tiles_m, p.tiles_n, i0, j0);
          for (int kt = 0; kt < k_tiles; ++kt, ++q) load(q, i0, j0, kt * BK);
        }
      }
    } else {
      // all 128 threads; only q lives from one k-tile to the next, so that
      // the element copies keep their registers
      const int my_tiles =
          tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
      const int total = my_tiles * k_tiles;  // this block's k-tiles, all its tiles in a row
      for (int q = 0; q < total; ++q) {
        int i0, j0;
        tile_origin<BM, BN, GROUP_M>(blockIdx.x + (q / k_tiles) * gridDim.x, p.tiles_m,
                                     p.tiles_n, i0, j0);
        load(q, i0, j0, (q % k_tiles) * BK);
      }
    }
    return;
  }

  // the two consumer warpgroups: products and epilogue
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ct = tid - PRODUCERS;
  const int wg = ct >> 7;
  const bool leader = (ct & 127) == 0;
  unsigned char* stg = staging + wg * WG_STAGING;
  // this warpgroup's 64 rows of A: 64 rows of a K-major tile, or box wg of
  // an MN-major one
  const int a_off = A_T ? wg * BOX_BYTES : wg * 64 * ROW_BYTES;
  // the products of k-tile kt run while the consumer waits for k-tile kt + 1
  // (wgmma.wait_group 1); a stage is handed back once its products are done
  auto release = [&](int stage) {
    __syncwarp();
    if ((ct & 31) == 0) mbar_arrive(&empty[stage]);
  };
  bool pending = false;  // the leader's stores of the last tile may still read stg
  // once the last tile's stores have read the buffer, the leader fills it
  // with this tile's acc (or panel block), which lands while the products
  // run
  auto refill_staging = [&](int i0, int j0) {
    if (leader) {
      if (pending) bulk_wait_read<0>();
      pending = false;
      if (has_acc) {
        const CUtensorMap* map = PANEL ? &maps.c : &maps.acc;
        const bool bf16 = PANEL ? p.out_bf16 : p.acc_bf16;
        const int jb = block_index<PANEL>(p);
        mbar_expect_tx(&acc_full[wg], staged_boxes(p, bf16, i0, j0, wg, jb,
                                                   [](int, int, int, int) {}));
        staged_boxes(p, bf16, i0, j0, wg, jb, [&](int off, int c0, int c1, int c2) {
          tma_load_3d(stg + off, map, c0, c1, c2, &acc_full[wg]);
        });
      }
    }
  };
  float d[ACC], part[FOLD > 0 ? ACC : 1];
  int q = 0, n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    int i0, j0;
    tile_origin<BM, BN, GROUP_M>(t, p.tiles_m, p.tiles_n, i0, j0);
#pragma unroll
    for (int r = 0; r < ACC; ++r) d[r] = 0.0f;
    int held = -1;  // the stage that products still in flight read
    for (int kt = 0; kt < k_tiles; ++kt, ++q) {
      const unsigned char* sa = ring + (q % S) * STAGE;
      const unsigned char* sb = sa + TILE_A;
      const int first = FOLD > 0 ? kt % FOLD == 0 : kt == 0;  // the sum starts from zero
      mbar_wait(&full[q % S], (q / S) & 1);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (FOLD > 0)
          wgmma_bf16<A_T ? 1 : 0, B_T ? 0 : 1>(part, desc_step<A_T>(sa + a_off, kk),
                                               desc_step<!B_T>(sb, kk), kk > 0 || !first);
        else
          wgmma_bf16<A_T ? 1 : 0, B_T ? 0 : 1>(d, desc_step<A_T>(sa + a_off, kk),
                                               desc_step<!B_T>(sb, kk), kk > 0 || !first);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (STORE == TMA_STORE && kt == 0) refill_staging(i0, j0);
      wgmma_wait<1>();
      if (held >= 0) release(held);
      held = q % S;
      if constexpr (FOLD > 0) {
        if ((kt + 1) % FOLD == 0 || kt + 1 == k_tiles) {
          wgmma_wait<0>();
          fence_acc(part);
          release(held);
          held = -1;
#pragma unroll
          for (int r = 0; r < ACC; ++r) d[r] = __fadd_rn(d[r], part[r]);
        }
      }
    }
    wgmma_wait<0>();
    if (held >= 0) release(held);
    fence_acc(d);
    if constexpr (STORE == TMA_STORE) {  // behind the TMA loader: K > 0
      epilogue_tma<PANEL>(d, p, maps, stg, &acc_full[wg], i0, j0, n, ct, pending);
    } else {
      epilogue_direct<PANEL>(d, p, i0, j0, ct);
    }
  }
  if (STORE == TMA_STORE && leader && pending) bulk_wait<0>();  // before the buffer goes
}

template <bool A_T, bool B_T, int LOADER, int STORE>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, false, STORE>(maps, p);
}

template <bool A_T, bool B_T, int LOADER, int STORE>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_panel_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, true, STORE>(maps, p);
}

template <bool A_T, bool B_T, int LOADER, bool PANEL, int STORE>
cudaError_t launch(const Maps& maps, const Params& p, int grid, cudaStream_t stream) {
  auto kernel = PANEL ? layout_gemm_panel_bf16_kernel<A_T, B_T, LOADER, STORE>
                      : layout_gemm_bf16_kernel<A_T, B_T, LOADER, STORE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<STORE>());
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, smem_bytes<STORE>(), stream>>>(maps, p);
  return cudaGetLastError();
}

template <bool PANEL>
cudaError_t dispatch(int a_trans, int b_trans, int loader, int store, const Maps& maps,
                     const Params& p, int grid, cudaStream_t s) {
#define GB_CASE(AT, BT)                                                        \
  if (loader == PLAIN) return launch<AT, BT, PLAIN, PANEL, DIRECT>(maps, p, grid, s); \
  return store == TMA_STORE ? launch<AT, BT, TMA, PANEL, TMA_STORE>(maps, p, grid, s) \
                            : launch<AT, BT, TMA, PANEL, DIRECT>(maps, p, grid, s);
  switch ((a_trans ? 2 : 0) | (b_trans ? 1 : 0)) {
    case 0: GB_CASE(false, false)
    case 1: GB_CASE(false, true)
    case 2: GB_CASE(true, false)
    default: GB_CASE(true, true)
  }
#undef GB_CASE
}

// A 2-D map of bf16 rows: `inner` values a row, `rows` rows `ld` values
// apart from `base`, boxes of 64 x box_rows, 128-byte swizzled; past the
// buffer's rows and row ends TMA writes zeros.
bool encode(CUtensorMap* map, const uint16_t* base, long long inner, long long rows, long long ld,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(2 * ld)};
  const cuuint32_t box[2] = {BOX, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<uint16_t*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of one operand: its buffer is (extent, K) when KC (K-major: boxes
// of 64 k x R rows), else (K, extent) (MN-major: boxes of 64 values x 64 k
// rows, R / 64 of them a k-tile).
bool encode_operand(CUtensorMap* map, const uint16_t* base, bool kc, int extent, int K, int ld,
                    int R) {
  return kc ? encode(map, base, K, extent, ld, R) : encode(map, base, extent, K, ld, BK);
}

// The 3-D map of an output-shaped buffer (C, acc or the panel) of bf16 or
// float32 values, nb j-blocks of N: i-major (j, jb, i), boxes of 128 bytes
// of j x 1 x 64 rows; j-major (i, j, jb), boxes of 128 bytes of i x 128 j
// rows x 1; 128-byte swizzled, as the staging buffer holds them.  A box
// past the block's edges is clipped (stores) or zero-filled (loads).
bool encode_out(CUtensorMap* map, const void* base, bool bf16, bool c_trans, int M, int N,
                int nb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = bf16 ? 2 : 4, v = 128 / e;
  const cuuint64_t m = static_cast<cuuint64_t>(M), n = static_cast<cuuint64_t>(N);
  const cuuint64_t i_dims[3] = {n, static_cast<cuuint64_t>(nb), m};
  const cuuint64_t i_strides[2] = {n * e, nb * n * e};
  const cuuint32_t i_box[3] = {static_cast<cuuint32_t>(v), 1, WG_ROWS};
  const cuuint64_t j_dims[3] = {m, n, static_cast<cuuint64_t>(nb)};
  const cuuint64_t j_strides[2] = {m * e, n * m * e};
  const cuuint32_t j_box[3] = {static_cast<cuuint32_t>(v), BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(base), c_trans ? j_dims : i_dims, c_trans ? j_strides : i_strides,
            c_trans ? j_box : i_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether an output-shaped buffer meets a TMA map's rules: a 16-byte
// aligned base, and strides (a row, a j-block) of multiples of 16 bytes.
bool out_legal(const void* base, bool bf16, bool c_trans, int M, int N) {
  const long long e = bf16 ? 2 : 4;
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (c_trans ? M : N) * e % 16 == 0;
}

template <bool PANEL>
int run(Params p, int a_trans, int b_trans, int loader, int store, void* stream) {
  p.lda = a_trans ? p.M : p.K;
  p.ldb = b_trans ? p.K : p.N;
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles_n = (p.N + BN - 1) / BN;
  Maps maps = {};
  if (loader == TMA) {
    // the caller's choice must meet TMA's rules: 16-byte aligned bases and
    // row strides
    const bool legal = p.K > 0 && reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.b) % 16 == 0 && p.lda % 8 == 0 &&
                       p.ldb % 8 == 0;
    if (!legal) return static_cast<int>(cudaErrorInvalidValue);
    if (!encode_operand(&maps.a, p.a, !a_trans, p.M, p.K, p.lda, BM) ||
        !encode_operand(&maps.b, p.b, b_trans != 0, p.N, p.K, p.ldb, BN))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (loader != PLAIN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (store == TMA_STORE) {
    // the caller's choice must meet the output's (and acc's) maps' rules,
    // behind the TMA loader
    const bool legal =
        loader == TMA && out_legal(p.c, p.out_bf16, p.c_trans, p.M, p.N) &&
        (p.acc == nullptr || out_legal(p.acc, p.acc_bf16, p.c_trans, p.M, p.N));
    if (!legal || !encode_out(&maps.c, p.c, p.out_bf16, p.c_trans, p.M, p.N, p.nb) ||
        (p.acc != nullptr && !encode_out(&maps.acc, p.acc, p.acc_bf16, p.c_trans, p.M, p.N, 1)))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (store != DIRECT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = p.tiles_m * p.tiles_n;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  return static_cast<int>(dispatch<PANEL>(a_trans, b_trans, loader, store, maps, p, grid,
                                          static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// C = A @ B (+ acc) for bf16 A and B.  acc may be null; acc_bf16 and
// out_bf16 give acc's and C's dtypes (1 bfloat16, 0 float32).  loader: 1
// loads through TMA (the caller has checked alignment), 0 through plain
// loads (any alignment and shape).  store: 1 stores through shared memory
// and TMA (with loader 1 only; the caller has checked C's and acc's maps),
// 0 directly.  Returns
// the cudaError_t of the launch.
int layout_gemm_bf16(const void* a, const void* b, const void* acc, void* c, int M, int N, int K,
                     int a_trans, int b_trans, int c_trans, int acc_bf16, int out_bf16,
                     int loader, int store, void* stream) {
  Params p = {};
  p.a = static_cast<const uint16_t*>(a), p.b = static_cast<const uint16_t*>(b);
  p.acc = acc, p.c = c;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = c_trans ? M : N;
  p.acc_bf16 = acc_bf16, p.out_bf16 = out_bf16;
  p.nb = 1;
  return run<false>(p, a_trans, b_trans, loader, store, stream);
}

// panel[j-block jb] += A @ B in place for bf16 A and B; the panel is
// bfloat16 (panel_bf16 = 1) or float32 and holds nb j-blocks of width N; ldp
// is its row length (nb*N, or M when C is j-major).  jb_dev, when not null,
// points to the block index on the device and jb_host is ignored.  loader
// and store as for layout_gemm_bf16.
int layout_gemm_panel_bf16(const void* a, const void* b, void* panel, int M, int N, int K,
                           int a_trans, int b_trans, int c_trans, int ldp, int nb,
                           const int* jb_dev, int jb_host, int panel_bf16, int loader, int store,
                           void* stream) {
  Params p = {};
  p.a = static_cast<const uint16_t*>(a), p.b = static_cast<const uint16_t*>(b);
  p.acc = nullptr, p.c = panel;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = ldp;
  p.acc_bf16 = panel_bf16, p.out_bf16 = panel_bf16;
  p.nb = nb, p.jb_dev = jb_dev, p.jb_host = jb_host;
  return run<true>(p, a_trans, b_trans, loader, store, stream);
}

// Dynamic shared memory of one block of either kernel on a store path, in
// bytes.
int layout_gemm_bf16_smem_bytes(int store) {
  return store == TMA_STORE ? smem_bytes<TMA_STORE>() : smem_bytes<DIRECT>();
}

const char* layout_gemm_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
