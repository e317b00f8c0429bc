// Tile machinery shared by the attention kernels (flash_attention.cu,
// flash_decode.cu): float32 shared-memory tiles, the score tile Q K^T and
// the product P V, all on the CUDA cores in float32 (FFMA), because the
// reference kernels do all their arithmetic in float32.
//
// One block has 256 threads in a 16 x 16 grid: ty = tid / 16 owns TR
// consecutive query rows (ty*TR .. ty*TR+TR-1) of a BR = 16*TR row tile,
// tx = tid % 16 owns keys tx, tx+16, tx+32, tx+48 of a 64-key tile and the
// DPT = D/16 head-dim columns col(e) = (e/4)*64 + tx*4 + e%4 of the output
// (D a multiple of 64: a head dim that is not, 112, runs on a V tile and
// an output padded to the next multiple of 64 with zero columns).  The same thread
// therefore holds a row's scores, its softmax state and its output columns,
// so rescaling the output never leaves registers; a row's reductions are
// shuffles among the 16 lanes that share ty (one half of a warp).
//
// Shared tiles are row-major float32 with a row pitch of D+4 (or keys+4)
// floats: 16-byte aligned rows, and the 16 rows that the 16 tx threads read
// at one column fall into distinct 4-bank groups, so the float4 reads of
// the score loop are free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int THREADS = 256;
constexpr int KT = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;  // the reference's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the reference's `.astype(cache dtype)`).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Copies `rows` rows of D elements (row r at src + r*stride, r < valid;
// zeros past it) into a float32 tile of W >= D columns (columns D..W-1
// zero) with pitch W+4, times `mul`.  16-byte global loads; the caller
// guarantees 16-byte alignment of every row.
template <typename T, int D, int W = D>
__device__ __forceinline__ void load_tile(float* tile, const T* src, long long stride, int rows,
                                          int valid, float mul, int tid) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CHUNKS = W / PER;      // loads per row
  static_assert(D % PER == 0 && W % PER == 0 && W >= D, "whole 16-byte loads");
  for (int c = tid; c < rows * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, d = (c % CHUNKS) * PER;
    float v[PER];
    if (r < valid && (W == D || d < D)) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + d);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = to_f32(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = 0.f;
    }
    float* dst = tile + r * (W + 4) + d;
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// s[i][j] = sum_d Q[ty*TR+i][d] * K[j*16+tx][d] over a KT-key tile.
template <int D, int TR>
__device__ __forceinline__ void score_tile(float (&s)[TR][4], const float* Qs, const float* Ks,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 q[TR], k[4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      q[i] = *reinterpret_cast<const float4*>(Qs + (ty * TR + i) * (D + 4) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = *reinterpret_cast<const float4*>(Ks + (j * 16 + tx) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
      }
  }
}

// The head-dim column of a thread's e-th output value: float4 runs of 4,
// neighbouring tx on neighbouring runs (conflict-free float4 reads of V).
__device__ __forceinline__ int out_col(int e, int tx) { return (e / 4) * 64 + tx * 4 + e % 4; }

// o[i][e] += sum_c P[ty*TR+i][c] * V[c][out_col(e)] over `keys` (a multiple
// of 4) keys; P has row pitch `ppitch`, V pitch D+4.
template <int D, int TR>
__device__ __forceinline__ void pv_tile(float (&o)[TR][D / 16], const float* Ps, int ppitch,
                                        const float* Vs, int keys, int ty, int tx) {
  constexpr int DPT = D / 16;
#pragma unroll 2
  for (int c = 0; c < keys; c += 4) {
    float4 p[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty * TR + i) * ppitch + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float v[DPT];
#pragma unroll
      for (int e = 0; e < DPT; e += 4) {
        const float4 t = *reinterpret_cast<const float4*>(Vs + (c + cc) * (D + 4) + out_col(e, tx));
        v[e] = t.x, v[e + 1] = t.y, v[e + 2] = t.z, v[e + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int e = 0; e < DPT; ++e) o[i][e] = fmaf(pc, v[e], o[i][e]);
      }
    }
  }
}

// Reductions over the 16 lanes that share ty.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace attn
