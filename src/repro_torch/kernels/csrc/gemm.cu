// Layout-parametric GEMM for Hopper (sm_90a) on the tensor cores: the per-rank
// multiply of the distributed GEMM case study and the rotating-panel step of
// its SUMMA ring.
//
// Replaces the TPU kernels `gemm_pallas` (`_gemm_kernel`) and
// `gemm_panel_pallas` (`_panel_kernel`) of src/repro/kernels/gemm.py.
//
// What it computes (float32 in and out):
//   layout_gemm_kernel:        C = A @ B (+ acc), the sum added after the product
//   layout_gemm_panel_kernel:  panel[j-block jb] += A @ B, in place
// Each operand has its own physical orientation (the C/A/B "majors" of the
// paper's Fig. 3): A is logical (i, k), buffer (M, K) or, when A_T, (K, M);
// B is logical (k, j), buffer (K, N) or, when B_T, (N, K); C is logical
// (i, j), buffer (M, ldc) or, when C is transposed, (N.., ldc) with i
// contiguous.  No operand is transposed by a pass of its own.
//
// Arithmetic: split TF32 on the tensor cores.  Every element x of A and B is
// split as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
// `cvt.rna.tf32.f32` (x - hi is exact), and A @ B is taken as
// A_lo B_hi + A_hi B_lo + A_hi B_hi: three `wgmma.mma_async m64n160k8
// .f32.tf32.tf32` per 8-deep k step, the two small terms first, all three
// into one tensor-core accumulator (a second one for the small terms would
// cost 80 more registers a thread, past the 224 a consumer has, and buy
// nothing: they are added in float32 either way).  A_lo B_lo (2^-22
// relative) is dropped.  The tensor cores add into their float32
// accumulator with truncation, whose bias grows with the number of adds
// (summed over the whole K = 1408 of EXTRALARGE, the error against a
// float64 product is several times the plain version's and fails the
// kernel check), so the products of every 2 k-tiles (64 deep) go into a
// partial sum that starts from zero, and the partial is added to the
// running sum with a round-to-nearest `fadd` (the scheme of Ootomo and
// Yokota, 2022).  The result keeps float32-class accuracy (the
// kernel-vs-plain check is rtol 1e-4, atol 1e-3; one TF32 product alone
// misses it at K ~ 1400).  `chip_smoke.py` measures both errors.
//
// Bound: 2*M*N*K operations three times over at 495 TFLOP/s (TF32, H100 SXM)
// against ~4*(MK + KN + MN) bytes at 3.35 TB/s: operations bound at the
// case study's shapes, 2.5x below the float32 CUDA-core bound.
//
// Design.  Shared memory is what the design economises: `wgmma` reads B
// from it, and B alone, read by both consumer warpgroups, costs 64 bytes a
// cycle of the SM's 128 at the tensor cores' rate.
//   * B: `wgmma` reads 32-bit operands only K-major from shared memory
//     (there is no transpose flag for tf32), so raw float32 k-tiles land in
//     a staging ring and a split pass writes B's hi and lo K-major, in the
//     canonical no-swizzle layout (8-row x 16-byte core matrices, LBO 128 B
//     along k, SBO 1 KB along rows); an MN-major B tile is transposed there.
//     Thread-to-element maps keep the staging reads and the split writes
//     free of bank conflicts.
//   * A: from registers.  Each consumer thread loads its wgmma fragments of
//     A straight from the raw k-tile and splits them itself.  A contiguous
//     along k is stored by TMA with its 128-byte swizzle, so those loads hit
//     32 banks; A contiguous along i, and A in the row-class layout, are
//     read with up to 4-way conflicts, still less traffic than a split
//     buffer would take.
//   * Block: 384 threads.  Warpgroup 0 loads k-tiles and splits B;
//     warpgroups 1 and 2 multiply, each 64 rows of a 128 x 160 output tile,
//     k-tiles 32 deep, so the split of k-tile t+1 runs on other warps while
//     the products of k-tile t are in flight.  A consumer thread holds 80
//     accumulators, 80 partial sums and 32 registers of A, more than the 168
//     registers 384 threads get, so `setmaxnreg` moves registers from the
//     loaders (56 a thread) to the consumers (224).
//   * Loads: a 3-stage ring of raw k-tiles, two loading while one is split.
//     Three loaders fill it, one template each; the caller chooses.  TMA
//     (one thread, 2-D tensor maps passed as __grid_constant__, boxes past
//     the edges zero-filled by the hardware) when A's and B's base
//     addresses are 16-byte aligned and their row strides multiples of 16
//     bytes.  Else, the ragged SUMMA's case, a TMA map's stride rule fails,
//     but every 4th row of a buffer is 16 * ld bytes on: the strided TMA
//     loads each operand as 4 maps, one per residue class of rows mod 4,
//     each based at the aligned address at or below its first row, so all
//     rows of a class start the same `shift` floats (0-3) into their 16
//     bytes.  Its boxes land in the row-class layout (slot(), async_tile):
//     rows 4 floats longer than the tile's, the readers skipping the shift.
//     Below 4 rows in a dimension a class is empty, and `cp.async` from the
//     128 loader threads fills the same layout with 16-byte copies.  A
//     stage is reloaded once the loaders have split its B and the consumers
//     have read its A.  (On an H100 a round of tiles took 2.5x as long
//     through cp.async as through TMA, its copies all of the difference.)
//   * Split buffers: 2, handed between the warpgroups on mbarriers (full:
//     written by the 128 loaders; empty: read by the products of both
//     consumer warpgroups).  No barrier spans all 384 threads after setup.
//   * Schedule: persistent, one block per SM (203 KB of shared memory), tiles
//     taken in a fixed stride by block, rasterised in groups of 8 tile rows
//     for L2 reuse; the loaders run ahead into the next tile while the
//     consumers store the last one.  At EXTRALARGE (2048 x 2560) the 128 x
//     160 tile gives 16 x 16 = 256 tiles on 132 SMs: two rounds with 8 SMs
//     idle in the second, against 320 tiles of 128 x 128 (three rounds, 2.4
//     of work).  The ragged SUMMA's 2049 x 2561 makes 17 x 17 = 289 tiles,
//     the last row and column one element wide: three rounds, 2.2 of
//     work.  Each output element is summed by one thread in one fixed k
//     order, so two launches on the same inputs are bitwise equal.
//   * Epilogue: straight from the accumulators; a warp's stores cover whole
//     32-byte sectors in either C orientation.  acc is read and added after
//     the product; the panel writes only the columns of jb.
//
// The panel kernel takes the block index jb either by value or through a
// pointer to one int32 on the device (read by every block, so a ring step
// needs no host sync); jb is clamped to [0, nb) like the reference's
// dynamic_slice.  Blocks of the panel outside jb are never touched.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                // output tile rows (i): two warpgroups of 64
constexpr int BN = 160;                // output tile columns (j): wgmma n160
constexpr int BK = 32;                 // k-tile depth (four k8 steps)
constexpr int STAGES = 3;              // raw k-tiles in flight
constexpr int SPLITS = 2;              // hi/lo split buffers
constexpr int PRODUCERS = 128;         // warpgroup 0 loads
constexpr int LOADER_REGS = 56;        // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 224;
constexpr int CONSUMERS = 256;         // warpgroups 1 and 2
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int ACC = BN / 2;            // accumulators a consumer thread holds
constexpr int ADD_EVERY = 2;           // k-tiles summed on the tensor cores per float32 add
constexpr int GROUP_M = 8;             // tile rows per raster group
constexpr int PAD = 4;                 // floats a row-class row holds past its tile: its shift
constexpr int RAW_A = BM * (BK + PAD); // floats of A's region of a raw stage (any loader)
constexpr int RAW_B = BN * (BK + PAD);
constexpr int RAW_STAGE = (RAW_A + RAW_B + 255) / 256 * 256;  // 1 KB multiples
constexpr int B_SPLIT = BN * BK;       // floats of one split part of B
constexpr int SPLIT_BUF = 2 * B_SPLIT; // B hi, B lo
constexpr int SMEM_BYTES = 4 * (STAGES * RAW_STAGE + SPLITS * SPLIT_BUF) + 16 * (STAGES + SPLITS);
static_assert(PRODUCERS * LOADER_REGS + CONSUMERS * CONSUMER_REGS <= 65536,
              "setmaxnreg moves registers within the SM's 64K");
static_assert(BK == 32, "a raw A row is one 128-byte swizzle span; the split's map takes 8 kg");
static_assert((RAW_STAGE * 4) % 1024 == 0 && (RAW_A * 4) % 128 == 0,
              "TMA boxes 128-byte aligned, the swizzled A box 1024-byte aligned");
static_assert(BK * (BM + PAD) <= RAW_A && BK * (BN + PAD) <= RAW_B,
              "a tile of k runs fits its region");
static_assert(SMEM_BYTES <= 227 * 1024, "one block per SM");

enum Loader : int { ASYNC = 0, TMA = 1, STRIDED = 2 };

// The operands' tensor maps: TMA uses a[0] and b[0], STRIDED all four.
struct Maps {
  CUtensorMap a[4];
  CUtensorMap b[4];
};

struct Params {
  const float* a;
  const float* b;
  const float* acc;  // null: no sum (the panel kernel adds the panel itself)
  float* c;
  int M, N, K, lda, ldb, ldc;
  int c_trans, tiles_m, tiles_n;
  int nb;
  const int* jb_dev;
  int jb_host;
};

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 16-byte asynchronous copy of src_bytes (0 to 16) from src, the rest of
// the 16 written as zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);  // exact difference: hi is within a factor 2 of x
}

// Descriptor of a K-major operand in the no-swizzle canonical layout:
// core matrices of 8 rows x 16 bytes, 128 B apart along k (LBO), BK / 4 *
// 128 B apart along rows (SBO: a row group holds BK / 4 core matrices).
__device__ __forceinline__ uint64_t desc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{128 >> 4} << 16) |
         (uint64_t{BK / 4 * 128 >> 4} << 32);
}

// One m64n160k8 TF32 product on the tensor cores, d = A B + (scale_d ? d : 0):
// A (64 x 8) from registers, this thread's four TF32 elements of it in
// wgmma's fragment order; B (160 x 8) K-major in shared memory, read
// through its descriptor.
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Where element (x, k) of a raw A k-tile that is contiguous along k sits:
// rows of BK = 32 floats (128 B) with their 16-byte chunks permuted by the
// TMA's 128-byte swizzle (chunk c of row x at chunk c ^ x % 8), so that the
// fragment loads below hit 32 different banks.
__device__ __forceinline__ int swizzled(int x, int k) {
  return x * BK + ((((k >> 2) ^ x) & 7) << 2) + (k & 3);
}

// The row-class layout of a raw k-tile, filled by the strided TMA and by
// cp.async.  An operand is logical (x, k), x its R-long tile axis; a run
// is what lies contiguous in its buffer: row x (k = 0..BK-1) when KC, the
// buffer contiguous along k, else row k (x = 0..R-1), NR runs of W floats
// a tile.  Run r lands in shared row slot(r) = (r % 4) * NR/4 + r / 4 (the
// runs of one residue class together, as one strided TMA box writes them),
// W + PAD floats long, starting `shift` floats in: the aligned 16 bytes at
// or below the run's start are copied whole.  shift is the run's start's
// float index mod 4, (the buffer's base + its row in the buffer * ld) mod
// 4, since a tile starts at a multiple of 4 floats along the run; as every
// tile starts at a multiple of 4 runs too, it is the same for every run of
// a class, and class_shifts() packs the four, two bits each.
__device__ __forceinline__ unsigned class_shifts(const float* base, int ld) {
  const unsigned off = static_cast<unsigned>(reinterpret_cast<uintptr_t>(base) >> 2);
  unsigned packed = 0;
#pragma unroll
  for (unsigned c = 0; c < 4; ++c) packed |= ((off + c * static_cast<unsigned>(ld)) & 3u) << (2 * c);
  return packed;
}

__device__ __forceinline__ int shift_of(unsigned shifts, int run) {
  return static_cast<int>((shifts >> (2 * (run & 3))) & 3u);
}

template <int NR>
__device__ __forceinline__ int slot(int r) {
  return (r & 3) * (NR / 4) + (r >> 2);
}

// Loads one raw k-tile into the row-class layout with 16-byte cp.async
// copies, past the edges (x >= extent, k >= K) zero-filled: thread t copies
// chunks t, t + PRODUCERS, ... of the tile's runs in order, so a warp reads
// consecutive chunks of a run.  A chunk's bytes before the run's start
// belong to the same aligned 16 bytes as its first float and are never
// read back.
template <bool KC, int R>
__device__ __forceinline__ void async_tile(float* raw, const float* base, int ld, int x0,
                                           int extent, int k0, int K, int t) {
  constexpr int RUNS = KC ? R : BK;
  constexpr int W = KC ? BK : R;
  constexpr int CHUNKS = W / 4 + 1;  // a shifted run spans one chunk more
  const unsigned shifts = class_shifts(base, ld);
  const float* dummy = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(base) & ~uintptr_t{15});
  const int first = KC ? k0 : x0;         // the tile's first float along the run
  const int left = (KC ? K : extent) - first;  // floats of the run from there on
#pragma unroll 1  // unrolled, it spills under the loaders' 56 registers
  for (int c = t; c < RUNS * CHUNKS; c += PRODUCERS) {
    const int run = c / CHUNKS, ch = c % CHUNKS;
    const int row = (KC ? x0 : k0) + run;  // the run's row in the buffer
    const int j = 4 * ch - shift_of(shifts, run);  // tile float that starts the chunk
    if (j >= W) continue;  // an unshifted run needs one chunk less
    const int valid = row < (KC ? extent : K) ? left - j : 0;
    const int bytes = valid <= 0 ? 0 : (valid >= 4 ? 16 : 4 * valid);
    cp_async16(raw + slot<RUNS>(run) * (W + PAD) + 4 * ch,
               bytes ? base + (long long)row * ld + first + j : dummy, bytes);
  }
}

// Floats m..m+3 of the 8 in lo, hi.
__device__ __forceinline__ float4 shifted(const float4& lo, const float4& hi, int m) {
  return make_float4(m == 0 ? lo.x : m == 1 ? lo.y : m == 2 ? lo.z : lo.w,
                     m == 0 ? lo.y : m == 1 ? lo.z : m == 2 ? lo.w : hi.x,
                     m == 0 ? lo.z : m == 1 ? lo.w : m == 2 ? hi.x : hi.y,
                     m == 0 ? lo.w : m == 1 ? hi.x : m == 2 ? hi.y : hi.z);
}

// Splits one raw k-tile of an operand (TMA's layout when SIMPLE, else the
// row-class layout, its classes' shifts packed in `shifts`) into hi and
// lo, written K-major in the canonical layout: float4
// group (r, kg) holds row r, k 4kg..4kg+3, at float4 index (r/8)*8*KG +
// kg*8 + r%8 (KG = BK/4).  A float4 access is served in phases of 8
// threads: KC reads one float4 of each of 8 rows, kg rotated so that the 8
// reads hit 8 bank groups, and the 8 writes fill one core matrix; MN reads
// 32 consecutive x of one k row per warp.
template <bool KC, int R, bool SIMPLE>
__device__ __forceinline__ void split_tile(const float* raw, float* hi, float* lo, int t,
                                           unsigned shifts) {
  constexpr int KG = BK / 4;
  constexpr int GROUPS = R * KG;
  constexpr int PITCH = (KC ? BK : R) + (SIMPLE ? 0 : PAD);
  // MN: k row 4kg + i is run i * KG + kg of the class layout, shift i's
  int mn_at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mn_at[i] = SIMPLE ? i * R : i * KG * PITCH + shift_of(shifts, i);
  const float4* raw4 = reinterpret_cast<const float4*>(raw);
  float4* hi4 = reinterpret_cast<float4*>(hi);
  float4* lo4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int g0 = 0; g0 < GROUPS; g0 += PRODUCERS) {
    const int g = g0 + t;
    if (GROUPS % PRODUCERS != 0 && g >= GROUPS) break;
    int r, kg;
    float4 x;
    if (KC) {
      const int p = g & 7;
      r = (g / (8 * KG)) * 8 + p;
      if (SIMPLE) {  // rows of 8 float4s: rotate by row
        kg = (p + (g >> 3)) & (KG - 1);
        x = raw4[r * KG + kg];
      } else {  // rows of 9 float4s in 4 classes: rotate by class
        kg = ((g >> 3) + 2 * (p & 3)) & (KG - 1);
        const float4* run = raw4 + slot<R>(r) * (PITCH / 4) + kg;
        x = shifted(run[0], run[1], shift_of(shifts, r));
      }
    } else {
      kg = g / R;
      r = g % R;
      const float* col = raw + kg * (SIMPLE ? 4 * R : PITCH) + r;
      x = make_float4(col[mn_at[0]], col[mn_at[1]], col[mn_at[2]], col[mn_at[3]]);
    }
    float4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    const int o = (r >> 3) * KG * 8 + kg * 8 + (r & 7);
    hi4[o] = h;
    lo4[o] = l;
  }
}

// Stores one output tile straight from the accumulators: C = A@B (+ acc),
// the reference's order (dot, then add); the panel form adds the panel's
// own block.  wgmma's fragment: d[4c + 2h + e] is row 16wq + lane/4 + 8h,
// column 8c + 2(lane%4) + e of the warpgroup's 64 x 160 product, so a
// warp's store covers whole 32-byte sectors in either C orientation.  acc
// may be the output itself (each element is read and written by one
// thread); a chunk of it is loaded before any of it is stored, so the loads
// are in flight together.
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
  const float* acc = PANEL ? p.c : p.acc;
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
        if (off[q] >= 0) v[q] = __fadd_rn(v[q], acc[off[q]]);
    }
#pragma unroll
    for (int q = 0; q < CHUNK; ++q)
      if (off[q] >= 0) p.c[off[q]] = v[q];
  }
}

// Floats one strided TMA box of an operand lands: one residue class of
// runs, NR/4 runs of W + PAD floats; class c's box lands c boxes in.
template <bool KC, int R>
constexpr int CLASS_FLOATS = KC ? R / 4 * (BK + PAD) : BK / 4 * (R + PAD);

template <bool A_T, bool B_T, int LOADER, bool PANEL>
__device__ __forceinline__ void gemm_body(const Maps& maps, const Params& p) {
  constexpr bool SIMPLE = LOADER == TMA;  // TMA's layout, else the row-class layout
  extern __shared__ __align__(1024) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  float* splits = raw + STAGES * RAW_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(splits + SPLITS * SPLIT_BUF);  // raw k-tile landed
  uint64_t* sfull = full + STAGES;    // split buffer written
  uint64_t* sempty = sfull + SPLITS;  // split buffer read by both warpgroups' products
  uint64_t* rempty = sempty + SPLITS;  // raw k-tile's A read by the consumers
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADER == ASYNC ? PRODUCERS : 1);
      mbar_init(&rempty[s], CONSUMERS / 32);
    }
    for (int b = 0; b < SPLITS; ++b) {
      mbar_init(&sfull[b], PRODUCERS);
      mbar_init(&sempty[b], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = (p.K + BK - 1) / BK;
  const int tiles = p.tiles_m * p.tiles_n;
  const int my_tiles =
      tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * k_tiles;  // this block's k-tiles, all its output tiles in a row

  if (tid < PRODUCERS) {  // the loader warpgroup: loads k-tiles and splits them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LOADER_REGS));
    const unsigned b_shifts = class_shifts(p.b, p.ldb);
    // loads k-tile q of the sequence into raw stage q % STAGES
    auto load = [&](int q) {
      int i0, j0;
      tile_origin<BM, BN, GROUP_M>(blockIdx.x + (q / k_tiles) * gridDim.x, p.tiles_m,
                                     p.tiles_n, i0, j0);
      const int k0 = (q % k_tiles) * BK;
      float* ra = raw + (q % STAGES) * RAW_STAGE;
      float* rb = ra + RAW_A;
      uint64_t* bar = &full[q % STAGES];
      // the consumers read A from the stage; the first round passes at once
      if (LOADER == ASYNC || tid == 0) mbar_wait(&rempty[q % STAGES], ((q / STAGES) & 1) ^ 1);
      if (LOADER == TMA) {
        if (tid == 0) {
          mbar_expect_tx(bar, (BM + BN) * BK * 4);
          tma_load(ra, &maps.a[0], A_T ? i0 : k0, A_T ? k0 : i0, bar);
          tma_load(rb, &maps.b[0], B_T ? k0 : j0, B_T ? j0 : k0, bar);
        }
      } else if (LOADER == STRIDED) {  // a box per residue class of runs
        if (tid == 0) {
          constexpr int CA = CLASS_FLOATS<!A_T, BM>, CB = CLASS_FLOATS<B_T, BN>;
          mbar_expect_tx(bar, 4 * 4 * (CA + CB));
          for (int c = 0; c < 4; ++c) {
            tma_load(ra + c * CA, &maps.a[c], A_T ? i0 : k0, A_T ? k0 / 4 : i0 / 4, bar);
            tma_load(rb + c * CB, &maps.b[c], B_T ? k0 : j0, B_T ? j0 / 4 : k0 / 4, bar);
          }
        }
      } else {
        async_tile<!A_T, BM>(ra, p.a, p.lda, i0, p.M, k0, p.K, tid);
        async_tile<B_T, BN>(rb, p.b, p.ldb, j0, p.N, k0, p.K, tid);
        cp_async_arrive(bar);
      }
    };
    for (int q = 0; q < STAGES - 1 && q < total; ++q) load(q);
    for (int q = 0; q < total; ++q) {
      // stage (q + STAGES - 1) % STAGES last held k-tile q-1, split before
      // the barrier below
      if (q + STAGES - 1 < total) load(q + STAGES - 1);
      const float* ra = raw + (q % STAGES) * RAW_STAGE;
      float* sb = splits + (q % SPLITS) * SPLIT_BUF;  // B hi, B lo
      mbar_wait(&full[q % STAGES], (q / STAGES) & 1);
      mbar_wait(&sempty[q % SPLITS], ((q / SPLITS) & 1) ^ 1);  // the first round passes at once
      split_tile<B_T, BN, SIMPLE>(ra + RAW_A, sb, sb + B_SPLIT, tid, b_shifts);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // splits visible to wgmma
      mbar_arrive(&sfull[q % SPLITS]);
      asm volatile("bar.sync 2, %0;" ::"n"(PRODUCERS) : "memory");  // raw stage q read by all
    }
    if (LOADER == ASYNC) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // the two consumer warpgroups: products and epilogue
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ct = tid - PRODUCERS;
  const int wg = ct >> 7;
  float d[ACC], part[ACC];
  const unsigned a_shifts = class_shifts(p.a, p.lda);
  const int lane = ct & 31;
  const int row = wg * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  // the row-class layout: A contiguous along k, where this thread's two rows
  // of A start; A contiguous along i, where its k rows 4m + lane % 4 start
  // (run (lane % 4) * BK/4 + m), less 4m rows.  Both hold in every tile.
  const int a_row[2] = {slot<BM>(row) * (BK + PAD) + shift_of(a_shifts, row),
                        slot<BM>(row + 8) * (BK + PAD) + shift_of(a_shifts, row + 8)};
  const int a_col = (lane & 3) * (BK / 4) * (BM + PAD) + shift_of(a_shifts, lane & 3) + row;
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int i0, j0;
    tile_origin<BM, BN, GROUP_M>(t, p.tiles_m, p.tiles_n, i0, j0);
#pragma unroll
    for (int r = 0; r < ACC; ++r) d[r] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt, ++q) {
      const float* sb = splits + (q % SPLITS) * SPLIT_BUF;
      const bool chain = kt % ADD_EVERY != 0;  // else the partial sums start from zero
      // wgmma's A fragment: a[e] is row 16wq + lane/4 + 8(e%2), column
      // lane%4 + 4(e/2) of the warpgroup's 64 x 8 slice; loaded from the raw
      // k-tile and split here
      uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
      const float* ra = raw + (q % STAGES) * RAW_STAGE;
      mbar_wait(&full[q % STAGES], (q / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = row + 8 * (e & 1), k = kk * 8 + (lane & 3) + 4 * (e >> 1);
          int at;  // where (x, k) lies in the raw k-tile
          if (SIMPLE)
            at = A_T ? k * BM + x : swizzled(x, k);
          else if (A_T)  // k >> 2 == 2kk + e/2
            at = a_col + (2 * kk + (e >> 1)) * (BM + PAD) + 8 * (e & 1);
          else
            at = a_row[e & 1] + k;
          float hi, lo;
          split(ra[at], hi, lo);
          a_hi[kk][e] = __float_as_uint(hi);
          a_lo[kk][e] = __float_as_uint(lo);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&rempty[q % STAGES]);
      mbar_wait(&sfull[q % SPLITS], (q / SPLITS) & 1);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const float* b_hi = sb + kk * 64;  // two core matrices a k8 step
        const float* b_lo = b_hi + B_SPLIT;
        wgmma_tf32(part, a_lo[kk], desc(b_hi), chain || kk > 0);
        wgmma_tf32(part, a_hi[kk], desc(b_lo), 1);
        wgmma_tf32(part, a_hi[kk], desc(b_hi), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait_all();
      fence_acc(part);
      if ((ct & 31) == 0) mbar_arrive(&sempty[q % SPLITS]);
      if ((kt + 1) % ADD_EVERY == 0 || kt + 1 == k_tiles) {
#pragma unroll
        for (int r = 0; r < ACC; ++r) d[r] = __fadd_rn(d[r], part[r]);
      }
    }
    epilogue<PANEL>(d, p, i0, j0, ct);
  }
}

template <bool A_T, bool B_T, int LOADER>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, false>(maps, p);
}

template <bool A_T, bool B_T, int LOADER>
__global__ void __launch_bounds__(THREADS, 1)
layout_gemm_panel_kernel(const __grid_constant__ Maps maps, const Params p) {
  gemm_body<A_T, B_T, LOADER, true>(maps, p);
}

template <bool A_T, bool B_T, int LOADER, bool PANEL>
cudaError_t launch(const Maps& maps, const Params& p, int grid, cudaStream_t stream) {
  auto kernel =
      PANEL ? layout_gemm_panel_kernel<A_T, B_T, LOADER> : layout_gemm_kernel<A_T, B_T, LOADER>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(maps, p);
  return cudaGetLastError();
}

template <bool A_T, bool B_T, bool PANEL>
cudaError_t dispatch_loader(int loader, const Maps& maps, const Params& p, int grid,
                            cudaStream_t s) {
  switch (loader) {
    case TMA: return launch<A_T, B_T, TMA, PANEL>(maps, p, grid, s);
    case STRIDED: return launch<A_T, B_T, STRIDED, PANEL>(maps, p, grid, s);
    default: return launch<A_T, B_T, ASYNC, PANEL>(maps, p, grid, s);
  }
}

template <bool PANEL>
cudaError_t dispatch(int a_trans, int b_trans, int loader, const Maps& maps, const Params& p,
                     int grid, cudaStream_t s) {
  switch ((a_trans ? 2 : 0) | (b_trans ? 1 : 0)) {
    case 0: return dispatch_loader<false, false, PANEL>(loader, maps, p, grid, s);
    case 1: return dispatch_loader<false, true, PANEL>(loader, maps, p, grid, s);
    case 2: return dispatch_loader<true, false, PANEL>(loader, maps, p, grid, s);
    default: return dispatch_loader<true, true, PANEL>(loader, maps, p, grid, s);
  }
}

// A 2-D map of float32 rows: `inner` floats a row, `rows` rows `stride`
// bytes apart from `base`, boxes of box_inner x box_rows.
bool encode(CUtensorMap* map, const float* base, long long inner, long long rows,
            long long stride, int box_inner, int box_rows, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one operand: its buffer is (extent, K) when KC, else (K,
// extent), rows ld floats apart; R is the tile's extent.  TMA: one map,
// boxes BK x R (KC) or R x BK.  STRIDED: a map per residue class c of
// runs, rows c, c + 4, ... (16 * ld bytes apart), based at the aligned
// address at or below row c's start, each row shift floats longer at its
// front; boxes BK + PAD x R/4 (KC) or R + PAD x BK/4, which land in the
// row-class layout.  Past the buffer's rows and row ends TMA writes zeros.
bool encode_operand(CUtensorMap* maps, int loader, const float* base, bool kc, int extent, int K,
                    int ld, int R, bool swizzle) {
  const long long inner = kc ? K : extent, rows = kc ? extent : K;
  if (loader == TMA)
    return encode(&maps[0], base, inner, rows, 4LL * ld, kc ? BK : R, kc ? R : BK, swizzle);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  for (int c = 0; c < 4; ++c) {
    const uintptr_t start = addr + 4ull * c * ld;  // row c
    const int shift = static_cast<int>((start >> 2) & 3);
    if (!encode(&maps[c], reinterpret_cast<const float*>(start - 4 * shift), inner + shift,
                (rows - c + 3) / 4, 16LL * ld, kc ? BK + PAD : R + PAD, kc ? R / 4 : BK / 4,
                false))
      return false;
  }
  return true;
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
  if (loader == TMA || loader == STRIDED) {
    // the caller's choice must meet TMA's rules: TMA, 16-byte aligned bases
    // and row strides; STRIDED, every residue class of runs nonempty
    const bool legal =
        loader == TMA ? p.K > 0 && reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(p.b) % 16 == 0 && p.lda % 4 == 0 &&
                            p.ldb % 4 == 0
                      : p.M >= 4 && p.N >= 4 && p.K >= 4 &&
                            reinterpret_cast<uintptr_t>(p.a) % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(p.b) % 4 == 0;
    if (!legal) return static_cast<int>(cudaErrorInvalidValue);
    if (!encode_operand(maps.a, loader, p.a, !a_trans, p.M, p.K, p.lda, BM, !a_trans) ||
        !encode_operand(maps.b, loader, p.b, b_trans != 0, p.N, p.K, p.ldb, BN, false))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      dispatch<PANEL>(a_trans, b_trans, loader, maps, p, grid, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// C = A @ B (+ acc).  acc may be null.  loader: 1 loads through TMA (the
// caller has checked alignment), 2 through strided TMA (any alignment, M,
// N, K >= 4), 0 through cp.async.  Returns the cudaError_t of the launch.
int layout_gemm_f32(const float* a, const float* b, const float* acc, float* c, int M, int N,
                    int K, int a_trans, int b_trans, int c_trans, int loader, void* stream) {
  Params p = {};
  p.a = a, p.b = b, p.acc = acc, p.c = c;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = c_trans ? M : N;
  return run<false>(p, a_trans, b_trans, loader, stream);
}

// panel[j-block jb] += A @ B in place.  The panel holds nb j-blocks of width N;
// ldp is its row length (nb*N, or M when C is j-major).  jb_dev, when not
// null, points to the block index on the device and jb_host is ignored.
int layout_gemm_panel_f32(const float* a, const float* b, float* panel, int M, int N, int K,
                          int a_trans, int b_trans, int c_trans, int ldp, int nb,
                          const int* jb_dev, int jb_host, int loader, void* stream) {
  Params p = {};
  p.a = a, p.b = b, p.acc = nullptr, p.c = panel;
  p.M = M, p.N = N, p.K = K;
  p.c_trans = c_trans;
  p.ldc = ldp;
  p.nb = nb, p.jb_dev = jb_dev, p.jb_host = jb_host;
  return run<true>(p, a_trans, b_trans, loader, stream);
}

// Dynamic shared memory of one block of either kernel, in bytes.
int layout_gemm_smem_bytes() { return SMEM_BYTES; }

const char* layout_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
