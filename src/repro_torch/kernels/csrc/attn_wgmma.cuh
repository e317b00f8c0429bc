// Tensor-core machinery shared by the bf16 attention kernels
// (flash_attention.cu, flash_decode.cu): K/V tiles brought in by TMA from
// (B, G, S, D) operands, their 128-byte-swizzled shared-memory layout, the
// wgmma descriptors that read it, and the two bf16 products with float32
// accumulators, S = Q K^T and O += P V.
//
// Layout.  A tile of R rows x D bf16 (q rows, or KT keys) is stored as
// ceil(D/64) "boxes", each R rows x 128 bytes (64 values), box b holding
// columns 64b..64b+63, with TMA's 128-byte swizzle: the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8).  Every box starts on 1 KB.  A head dim
// that 64 does not divide (96, 112) leaves the last box part empty: TMA fills
// the columns past D with zeros, and Q K^T reads none of them (it runs
// D/16 k16 steps); P V over a V head dim of 112 runs N = 128 over the
// zero columns 112-127 and drops them.  The products read
// it through wgmma descriptors in the same swizzle mode:
//   * K-major (Q as A, K as B of Q K^T; the contraction runs along D, which
//     is contiguous): 8-row groups 1 KB apart (SBO); the k16 step kk starts
//     kk % 4 * 32 bytes into box kk / 4 (the hardware applies the swizzle
//     to the address, so an offset inside the 128-byte row is legal);
//   * MN-major (V as B of P V; the contraction runs along the keys, and D,
//     the N dimension, is contiguous: wgmma's transpose bit for 16-bit
//     types): 8-key groups 1 KB apart (SBO), 64-column blocks of D one box
//     apart (LBO); the k16 step kk starts 16 keys = 2 KB into each box.
// So V needs no transposed copy and K no second layout.
//
// Fragments (PTX ISA, wgmma .m64nNk16): thread `lane` of warp wq of a
// warpgroup holds accumulator d[4c + 2h + e] = row 16 wq + lane / 4 + 8 h,
// column 8 c + 2 (lane % 4) + e; the A fragment of k16 step kk from
// registers is four bf16 pairs, a[j] = rows 16 wq + lane / 4 + 8 (j % 2),
// columns 16 kk + 8 (j / 2) + 2 (lane % 4) + {0, 1}.  So the scores of key
// columns 16kk..16kk+15 that a thread holds, d[8kk..8kk+7], are exactly its
// A fragment of step kk for P V, pair j from d[8kk + 2j], d[8kk + 2j + 1],
// and the softmax never leaves registers.
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace attn_tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;         // keys per tile
constexpr int BOX = 64;        // bf16 values in one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float NEG_INF = -1e30f;  // the reference's finite mask value

// Boxes of a D-column tile, and the bytes of an R-row tile in the boxed
// layout (whole boxes: a TMA load writes every column of its box).
__host__ __device__ constexpr int boxes(int D) { return (D + BOX - 1) / BOX; }
__host__ __device__ constexpr int tile_bytes(int rows, int D) {
  return rows * boxes(D) * ROW_BYTES;
}

// A (B, G, S, D) bf16 operand as a TMA map: dimension 0 is D, the other
// three are the sequence, group and batch axes ordered by stride (TMA
// reads any order; sorting keeps every stride at least the one inside
// it); `at` says which map dimension holds each.  Boxes are 64 values x
// `rows` sequence positions; positions past the operand's end, and
// columns past D, read as zeros.
struct KvMap {
  CUtensorMap map;
  int at_seq, at_group, at_batch;
};

struct KvMaps {
  KvMap k, v;
};

// Encodes `m` for base (B, G, S, D) with element strides sb, sg, ss (the
// head dim contiguous).  Returns false if cuTensorMapEncodeTiled refuses it.
inline bool encode_kv(KvMap* m, const void* base, int B, int G, int S, int D, long long sb,
                      long long sg, long long ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // (size, byte stride, which axis) of the three outer axes, by stride;
  // an axis of size 1 is never stepped, so its stride is free
  long long axis[3][3] = {{S, 2 * ss, 0}, {G, 2 * sg, 1}, {B, 2 * sb, 2}};
  for (auto& a : axis)
    if (a[0] == 1) a[1] = 16;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (axis[j][1] < axis[i][1])
        for (int f = 0; f < 3; ++f) {
          const long long t = axis[i][f];
          axis[i][f] = axis[j][f];
          axis[j][f] = t;
        }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {BOX, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int* at[3] = {&m->at_seq, &m->at_group, &m->at_batch};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(axis[i][0]);
    strides[i] = static_cast<cuuint64_t>(axis[i][1]);
    *at[axis[i][2]] = i + 1;
    if (axis[i][2] == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
  }
  return fn(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Loads the rows x D tile starting at sequence position `pos` of (batch,
// group) into `dst` (1 KB aligned, the boxed layout), completing on `bar`,
// which expects tile_bytes(rows, D).
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const KvMap& m, int pos, int group,
                                          int batch, int rows, uint64_t* bar) {
  const int c1 = m.at_seq == 1 ? pos : m.at_group == 1 ? group : batch;
  const int c2 = m.at_seq == 2 ? pos : m.at_group == 2 ? group : batch;
  const int c3 = m.at_seq == 3 ? pos : m.at_group == 3 ? group : batch;
#pragma unroll
  for (int b = 0; b < boxes(D); ++b)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst + b * rows * ROW_BYTES)),
        "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(b * BOX), "r"(c1), "r"(c2), "r"(c3),
        "r"(smem_u32(bar))
        : "memory");
}

// Byte offset of 16-byte chunk `c` (columns 8c..8c+7) of row r in a tile of
// `rows` rows.
__device__ __forceinline__ int chunk_at(int r, int c, int rows) {
  return (c / 8) * rows * ROW_BYTES + r * ROW_BYTES + (((c % 8) ^ (r % 8)) << 4);
}

// Stores `rows` rows of D values of q (row i at src + i * stride, i <
// valid; zeros past it) into the boxed layout of a tile of `tile_rows` rows
// (dst: the tile's row 0, or a row that is a multiple of 8), with `threads`
// threads numbered t; the caller then makes the writes visible to the
// tensor cores (fence_async).
template <int D>
__device__ __forceinline__ void store_rows(unsigned char* dst, int tile_rows, const bf16* src,
                                           long long stride, int rows, int valid, int t,
                                           int threads) {
  for (int i = t; i < rows * (D / 8); i += threads) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + chunk_at(r, c, tile_rows)) = x;
  }
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint64_t desc(const unsigned char* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (uint64_t{1} << 62);  // 128-byte swizzle
}

// K-major operand (Q or K) of `rows` rows: k16 step kk.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int kk) {
  return desc(tile + (kk / 4) * rows * ROW_BYTES + (kk % 4) * 32, 16, 8 * ROW_BYTES);
}

// MN-major V tile of KT keys: k16 step kk (keys 16kk..16kk+15).
__device__ __forceinline__ uint64_t desc_v(const unsigned char* tile, int kk) {
  return desc(tile + kk * 16 * ROW_BYTES, KT * ROW_BYTES, 8 * ROW_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define ATTN_F8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ATTN_F32(d) ATTN_F8(d, 0), ATTN_F8(d, 8), ATTN_F8(d, 16), ATTN_F8(d, 24)
#define ATTN_F64(d) ATTN_F32(d), ATTN_F8(d, 32), ATTN_F8(d, 40), ATTN_F8(d, 48), ATTN_F8(d, 56)

// d (64 x 64) = Q K^T over one k16 step (+ d unless scale_d is 0): both
// operands K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ATTN_F32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x D) += P V over one k16 step (d = P V when scale_d is 0): P from
// registers (this thread's A fragment), V MN-major in shared memory.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ATTN_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ATTN_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef ATTN_F8
#undef ATTN_F32
#undef ATTN_F64

// Two values as a bf16 pair (the lower column in the low half), each
// rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// Reductions over the 4 lanes that share a row of a fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A small cache of encoded maps, keyed by everything that goes into one, so
// that repeated calls on the same buffers (a forward's layers, the serving
// engine's cache) encode once.  Host-side; calls come from one thread.
struct MapKey {
  const void* base;
  long long B, G, S, D, sb, sg, ss, rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && B == o.B && G == o.G && S == o.S && D == o.D && sb == o.sb &&
           sg == o.sg && ss == o.ss && rows == o.rows;
  }
};

// Lookups that found their map, and maps encoded, since the library loaded.
struct MapCacheStats {
  long long hits = 0, misses = 0;
};

inline MapCacheStats& map_cache_stats() {
  static MapCacheStats stats;
  return stats;
}

inline bool cached_kv(KvMap* out, const void* base, int B, int G, int S, int D, long long sb,
                      long long sg, long long ss, int rows) {
  constexpr int N = 16;
  static MapKey keys[N];
  static KvMap maps[N];
  static int used = 0, next = 0;
  const MapKey key{base, B, G, S, D, sb, sg, ss, rows};
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      ++map_cache_stats().hits;
      return true;
    }
  ++map_cache_stats().misses;
  if (!encode_kv(out, base, B, G, S, D, sb, sg, ss, rows)) return false;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % N;
  used = used < N ? used + 1 : N;
  return true;
}

}  // namespace attn_tc
