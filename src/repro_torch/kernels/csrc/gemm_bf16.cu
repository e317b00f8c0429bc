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
// product first and acc after, is kept; the output is rounded once.
//
// Bound: 2*M*N*K operations at 989 TFLOP/s (bf16, H100 SXM) against 2 bytes
// an element of A and B and the output's and acc's own widths at 3.35 TB/s:
// operations bound at the case study's EXTRALARGE (0.0149 ms against
// 0.0070-0.0164 ms of bytes).
//
// Design: what gemm.cu built for split TF32, without the split.
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
//     from the loaders (56 a thread) to the consumers (224).
//   * Loads: a 6-stage ring of k-tiles (32 KB each), an mbarrier pair per
//     stage (full: landed; empty: read by the products of all 8 consumer
//     warps).  Two loaders, one template each; the caller chooses.  TMA (one
//     thread, 2-D tensor maps passed as __grid_constant__, boxes past the
//     edges zero-filled by the hardware; an MN-major box wholly past the
//     edge is not loaded, since it feeds only output rows or columns that
//     are never stored) when A's and B's bases are 16-byte aligned and
//     their row strides multiples of 8 elements.  Else (an odd K or N, a
//     view's offset base) the 128 loader threads copy the tile element by
//     element with plain loads into the same swizzled layout, zeros past
//     the edges, and make their stores visible to the tensor cores before
//     they arrive.  Strided TMA by residue class, as gemm.cu has, would
//     need 8 classes for 2-byte elements, and is not built.
//   * Schedule: persistent, one block per SM (194 KB of shared memory),
//     128 x 128 tiles taken in a fixed stride by block, rasterised in
//     groups of 8 tile rows for L2 reuse; the loader runs ahead into the
//     next tile while the consumers store the last one.  At EXTRALARGE
//     (2048 x 2560) that is 16 x 20 = 320 tiles on 132 SMs.  Each output
//     element is summed by one thread in one fixed k order, so two launches
//     on the same inputs are bitwise equal.
//   * Epilogue: straight from the accumulators, in the fragment order of
//     gemm.cu's; acc (or the panel block) read and added in float32, the
//     sum rounded once to the output's dtype.
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
constexpr int STAGES = 6;              // k-tiles in flight
constexpr int FOLD = 8;                // k-tiles a partial sums before its rounded add (0: none)
constexpr int PRODUCERS = 128;         // warpgroup 0 loads
constexpr int LOADER_REGS = 56;        // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 224;
constexpr int CONSUMERS = 256;         // warpgroups 1 and 2
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int ACC = BN / 2;            // accumulators a consumer thread holds
constexpr int GROUP_M = 8;             // tile rows per raster group
constexpr int TILE_A = BM * BK * 2;    // bytes of a k-tile of A
constexpr int TILE_B = BN * BK * 2;
constexpr int STAGE = TILE_A + TILE_B;
constexpr int BOX_BYTES = BOX * BK * 2;  // an MN-major box: 64 k rows x 64 values
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + 2 * STAGES * 8;
static_assert(PRODUCERS * LOADER_REGS + CONSUMERS * CONSUMER_REGS <= 65536,
              "setmaxnreg moves registers within the SM's 64K");
static_assert(BK * 2 == ROW_BYTES, "a k-tile row is one 128-byte swizzle span");
static_assert(STAGE % 1024 == 0 && TILE_A % 1024 == 0, "every tile starts on 1 KB");
static_assert(SMEM_BYTES <= 227 * 1024, "one block per SM");

enum Loader : int { PLAIN = 0, TMA = 1 };

struct Maps {
  CUtensorMap a;
  CUtensorMap b;
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

// Stores one output tile straight from the accumulators: C = A@B (+ acc),
// the reference's order (dot, then add), rounded once to the output's
// dtype; the panel form adds the panel's own block.  wgmma's fragment:
// d[4c + 2h + e] is row 16wq + lane/4 + 8h, column 8c + 2(lane%4) + e of the
// warpgroup's 64 x 128 product.  acc may be the output itself (each element
// is read and written by one thread); a chunk of it is loaded before any of
// it is stored, so the loads are in flight together.
template <bool PANEL>
__device__ __forceinline__ void epilogue(const float (&d)[ACC], const Params& p, int i0, int j0,
                                         int ct) {
  const int wg = ct >> 7, wq = (ct >> 5) & 3, lane = ct & 31;
  long long col0 = 0;
  if (PANEL) {
    int jb = p.jb_dev != nullptr ? *p.jb_dev : p.jb_host;
    jb = jb < 0 ? 0 : (jb >= p.nb ? p.nb - 1 : jb);
    col0 = (long long)jb * p.N;
  }
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
    if (p.out_bf16) {
      __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c);
#pragma unroll
      for (int q = 0; q < CHUNK; ++q)
        if (off[q] >= 0) c[off[q]] = __float2bfloat16_rn(v[q]);
    } else {
      float* c = static_cast<float*>(p.c);
#pragma unroll
      for (int q = 0; q < CHUNK; ++q)
        if (off[q] >= 0) c[off[q]] = v[q];
    }
  }
}

template <bool A_T, bool B_T, int LOADER, bool PANEL>
__device__ __forceinline__ void gemm_body(const Maps& maps, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);  // k-tile landed
  uint64_t* empty = full + STAGES;  // k-tile read by the products of all consumer warps
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADER == TMA ? 1 : PRODUCERS);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = (p.K + BK - 1) / BK;
  const int tiles = p.tiles_m * p.tiles_n;
  const int my_tiles =
      tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * k_tiles;  // this block's k-tiles, all its output tiles in a row

  if (tid < PRODUCERS) {  // the loader warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LOADER_REGS));
    if (LOADER == TMA && tid != 0) return;
    for (int q = 0; q < total; ++q) {
      int i0, j0;
      tile_origin<BM, BN, GROUP_M>(blockIdx.x + (q / k_tiles) * gridDim.x, p.tiles_m,
                                     p.tiles_n, i0, j0);
      const int k0 = (q % k_tiles) * BK;
      unsigned char* sa = ring + (q % STAGES) * STAGE;
      unsigned char* sb = sa + TILE_A;
      uint64_t* bar = &full[q % STAGES];
      mbar_wait(&empty[q % STAGES], ((q / STAGES) & 1) ^ 1);  // the first round passes at once
      if (LOADER == TMA) {
        // an MN-major box wholly past the edge is skipped: it would only
        // feed rows (A) or columns (B) of the product that are not stored
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
    }
    return;
  }

  // the two consumer warpgroups: products and epilogue
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ct = tid - PRODUCERS;
  const int wg = ct >> 7;
  // this warpgroup's 64 rows of A: 64 rows of a K-major tile, or box wg of
  // an MN-major one
  const int a_off = A_T ? wg * BOX_BYTES : wg * 64 * ROW_BYTES;
  // the products of k-tile kt run while the consumer waits for k-tile kt + 1
  // (wgmma.wait_group 1); a stage is handed back once its products are done
  auto release = [&](int stage) {
    __syncwarp();
    if ((ct & 31) == 0) mbar_arrive(&empty[stage]);
  };
  float d[ACC], part[FOLD > 0 ? ACC : 1];
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int i0, j0;
    tile_origin<BM, BN, GROUP_M>(t, p.tiles_m, p.tiles_n, i0, j0);
#pragma unroll
    for (int r = 0; r < ACC; ++r) d[r] = 0.0f;
    int held = -1;  // the stage that products still in flight read
    for (int kt = 0; kt < k_tiles; ++kt, ++q) {
      const unsigned char* sa = ring + (q % STAGES) * STAGE;
      const unsigned char* sb = sa + TILE_A;
      const int first = FOLD > 0 ? kt % FOLD == 0 : kt == 0;  // the sum starts from zero
      mbar_wait(&full[q % STAGES], (q / STAGES) & 1);
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
      wgmma_wait<1>();
      if (held >= 0) release(held);
      held = q % STAGES;
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
    epilogue<PANEL>(d, p, i0, j0, ct);
  }
}

template <bool A_T, bool B_T, int LOADER>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, false>(maps, p);
}

template <bool A_T, bool B_T, int LOADER>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_panel_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, true>(maps, p);
}

template <bool A_T, bool B_T, int LOADER, bool PANEL>
cudaError_t launch(const Maps& maps, const Params& p, int grid, cudaStream_t stream) {
  auto kernel = PANEL ? layout_gemm_panel_bf16_kernel<A_T, B_T, LOADER>
                      : layout_gemm_bf16_kernel<A_T, B_T, LOADER>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(maps, p);
  return cudaGetLastError();
}

template <bool PANEL>
cudaError_t dispatch(int a_trans, int b_trans, int loader, const Maps& maps, const Params& p,
                     int grid, cudaStream_t s) {
#define GB_CASE(AT, BT)                                                             \
  return loader == TMA ? launch<AT, BT, TMA, PANEL>(maps, p, grid, s)              \
                       : launch<AT, BT, PLAIN, PANEL>(maps, p, grid, s);
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

template <bool PANEL>
int run(Params p, int a_trans, int b_trans, int loader, void* stream) {
  p.lda = a_trans ? p.M : p.K;
  p.ldb = b_trans ? p.K : p.N;
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles_n = (p.N + BN - 1) / BN;
  const int tiles = p.tiles_m * p.tiles_n;
  const int grid = tiles < sm_count() ? tiles : sm_count();
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
  return static_cast<int>(
      dispatch<PANEL>(a_trans, b_trans, loader, maps, p, grid, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// C = A @ B (+ acc) for bf16 A and B.  acc may be null; acc_bf16 and
// out_bf16 give acc's and C's dtypes (1 bfloat16, 0 float32).  loader: 1
// loads through TMA (the caller has checked alignment), 0 through plain
// loads (any alignment and shape).  Returns the cudaError_t of the launch.
int layout_gemm_bf16(const void* a, const void* b, const void* acc, void* c, int M, int N, int K,
                     int a_trans, int b_trans, int c_trans, int acc_bf16, int out_bf16,
                     int loader, void* stream) {
  Params p = {};
  p.a = static_cast<const uint16_t*>(a), p.b = static_cast<const uint16_t*>(b);
  p.acc = acc, p.c = c;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = c_trans ? M : N;
  p.acc_bf16 = acc_bf16, p.out_bf16 = out_bf16;
  return run<false>(p, a_trans, b_trans, loader, stream);
}

// panel[j-block jb] += A @ B in place for bf16 A and B; the panel is
// bfloat16 (panel_bf16 = 1) or float32 and holds nb j-blocks of width N; ldp
// is its row length (nb*N, or M when C is j-major).  jb_dev, when not null,
// points to the block index on the device and jb_host is ignored.
int layout_gemm_panel_bf16(const void* a, const void* b, void* panel, int M, int N, int K,
                           int a_trans, int b_trans, int c_trans, int ldp, int nb,
                           const int* jb_dev, int jb_host, int panel_bf16, int loader,
                           void* stream) {
  Params p = {};
  p.a = static_cast<const uint16_t*>(a), p.b = static_cast<const uint16_t*>(b);
  p.acc = nullptr, p.c = panel;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = ldp;
  p.acc_bf16 = panel_bf16, p.out_bf16 = panel_bf16;
  p.nb = nb, p.jb_dev = jb_dev, p.jb_host = jb_host;
  return run<true>(p, a_trans, b_trans, loader, stream);
}

// Dynamic shared memory of one block of either kernel, in bytes.
int layout_gemm_bf16_smem_bytes() { return SMEM_BYTES; }

const char* layout_gemm_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
