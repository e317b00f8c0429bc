// Split-KV flash decoding for Hopper (sm_90a): attention of a few new
// queries per slot over the serving engine's KV cache, for both the
// whole-prompt prefill chunk and every decode step.
//
// Replaces the TPU kernel `flash_decode_pallas` (`_decode_kernel` and its
// log-sum-exp combine epilogue) of src/repro/kernels/flash_decode.py.
//
// What it computes, as the reference does.  The rep = Hq / G query heads of
// a KV group are stacked into rep*S rows (row r is head r / S, query r % S).
// The cache is cut into KV blocks of bk keys; for block j and each row:
// scores s = (scale * q) . k in float32, masked to -1e30 where
// k_pos >= min(cache_len[b], T) or k_pos > q_positions[b, r % S]; the
// block's own max m_j; p = exp(s - m_j); l_j = sum p in float32; and
// o_j = round(p) @ v with p rounded to the cache type first and float32
// accumulation.  The rounding is relative to each block's own max, so the
// block split is part of the function and bk is an argument.  The blocks
// then combine as m = max m_j, w_j = exp(m_j - m),
// o = sum w_j o_j / sum w_j l_j, with l == 0 -> 1.
//
// Bound: a decode step reads the whole valid cache for a few rows, so it is
// bound by the bytes of K and V (3.35 TB/s on an H100 SXM); the prefill
// chunk (rep*S = 6144 rows per group) is bound by float32 operations like
// the forward's flash attention.  The design covers both with one body:
//   * a block owns a tile of BR = 16*TR rows of one (batch, KV group) and a
//     contiguous range of KV blocks (a split); splits spread a decode step's
//     few rows over the card, while the prefill chunk's many row tiles fill
//     it with one split;
//   * within a split the combine runs online, block after block: the block's
//     scores are kept in shared memory (BR x bk float32), its max is taken
//     over all of them before any exp, and each rounded p is scaled by
//     w_j = exp(m_j - m_run) after rounding, so each block still rounds
//     relative to its own max;
//   * a second small kernel merges the splits' (o, m, l) partials;
//   * KV blocks, and 64-key tiles inside one, that lie wholly past every
//     row's last visible key (cache length, or chunk causality) are skipped:
//     they contribute exactly 0 after the combine.  A row with no visible
//     key at all (an idle slot) counts as seeing up to T - 1, so its tile
//     walks every block and it gets the reference's mean of v; the keys of
//     the last block past T count in l as the reference's padding does; a
//     tile of such rows only (an idle slot's) skips K and Q K^T, since
//     every score is masked, and pays for p @ v alone;
//   * warps whose rows all lie past rep*S skip the arithmetic (a decode
//     step's 3 rows occupy 2 of 8 warps of a 16-row tile).
// Shared memory at TR = 4, D = 128, bk = 512: 195 KB, set with
// cudaFuncSetAttribute.  Tensor cores, asynchronous copies and reading the
// cache once per group for all splits are later work.

#include <algorithm>

#include "attn_tiles.cuh"

namespace {

using namespace attn;

__host__ __device__ constexpr int score_pitch(int bk) { return (bk + KT - 1) / KT * KT + 4; }

template <int D, int TR>
constexpr long long smem_bytes(int bk) {
  return 4LL * (16 * TR * (D + 4) + KT * (D + 4) + 16 * TR * score_pitch(bk));
}

template <typename T, int D, int TR>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ cache_len, const int* __restrict__ q_pos,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int G, int S, int RS, int T_len, int bk, int nb,
                    int per, long long skb, long long skg, long long sks, long long svb,
                    long long svg, long long svs, float scale) {
  constexpr int BR = 16 * TR, DPT = D / 16;
  extern __shared__ float4 smem4[];
  const int sp = score_pitch(bk);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BR * (D + 4);
  float* Ss = KVs + KT * (D + 4);
  __shared__ int s_limit, s_seen;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = blockIdx.x * BR, bg = blockIdx.y, b = bg / G, g = bg % G;
  const int split = blockIdx.z, splits = gridDim.z;
  const T* kp = kc + b * skb + g * skg;
  const T* vp = vc + b * svb + g * svg;
  // whole warps past the last row skip the arithmetic (warp-uniform)
  const bool busy = r0 + (ty & ~1) * TR < RS;

  // keys at or past `limit` are masked for every row of the tile; a row
  // with no visible key at all sees every key (its scores are all -1e30 and
  // p = exp(0) = 1: the reference's mean of v over the padded cache)
  const int valid = min(cache_len[b], T_len);
  if (tid == 0) s_limit = 0, s_seen = 0;
  load_tile<T, D>(Qs, q + ((long long)bg * RS + r0) * D, D, BR, RS - r0, scale, tid);
  __syncthreads();
  if (tid < BR && r0 + tid < RS) {
    const int seen = q_pos ? min(valid, q_pos[b * S + (r0 + tid) % S] + 1) : valid;
    atomicMax(&s_limit, seen > 0 ? seen : T_len);
    if (seen > 0) s_seen = 1;
  }
  int pos[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = min(r0 + ty * TR + i, RS - 1);
    pos[i] = q_pos ? q_pos[b * S + r % S] : T_len;
  }
  __syncthreads();
  const int limit = s_limit;
  // a tile whose rows see no key at all (an idle slot) needs no scores:
  // every one is masked, so neither K nor Q K^T is touched (block-uniform)
  const bool blind = s_seen == 0;

  float o[TR][DPT], m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF, l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[i][e] = 0.f;
  }

  const int j_end = min(nb, (split + 1) * per);
  for (int j = split * per; j < j_end && j * bk < limit; ++j) {
    const int kb0 = j * bk, kb_end = min(kb0 + bk, T_len);
    const int ntiles = (min(kb_end, limit) - kb0 + KT - 1) / KT;
    // keys of the block past its scored tiles (past T: the reference's
    // padding) are masked for every row; each adds exp(-1e30 - m_j) to l_j,
    // which is 1 for a row with no visible key in the block and 0 otherwise
    const float unscored = static_cast<float>(bk - ntiles * KT);

    // scores of the whole block into shared memory, and each row's max
    float mx[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) mx[i] = NEG_INF;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = kb0 + t * KT;
      __syncthreads();  // the previous readers of KVs and of the scores are done
      if (!blind) {
        load_tile<T, D>(KVs, kp + k0 * sks, sks, KT, kb_end - k0, 1.f, tid);
        __syncthreads();
      }
      float s[TR][4];
      if (busy && !blind) {
        score_tile<D, TR>(s, Qs, KVs, ty, tx);
      } else {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + c * 16 + tx;
          if (kpos >= kb_end || kpos >= valid || kpos > pos[i]) s[i][c] = NEG_INF;
          mx[i] = fmaxf(mx[i], s[i][c]);
          Ss[(ty * TR + i) * sp + t * KT + c * 16 + tx] = s[i][c];
        }
    }

    // p = exp(s - m_j), rounded to the cache type, then scaled by the
    // block's weight in the running combine (each thread its own entries)
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float m_j = half_warp_max(mx[i]);
      const float m_new = fmaxf(m[i], m_j);
      const float w_old = expf(m[i] - m_new), w_j = expf(m_j - m_new);
      float sum = 0.f;
      for (int t = 0; t < ntiles; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* e = Ss + (ty * TR + i) * sp + t * KT + c * 16 + tx;
          const float p = expf(*e - m_j);
          sum += p;
          *e = round_to<T>(p) * w_j;
        }
      l[i] = l[i] * w_old + w_j * (half_warp_sum(sum) + unscored * expf(NEG_INF - m_j));
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[i][e] *= w_old;
    }

    for (int t = 0; t < ntiles; ++t) {
      const int k0 = kb0 + t * KT;
      __syncthreads();  // scores written, previous readers of KVs done
      load_tile<T, D>(KVs, vp + k0 * svs, svs, KT, kb_end - k0, 1.f, tid);
      __syncthreads();
      if (busy) pv_tile<D, TR>(o, Ss + t * KT, sp, KVs, KT, ty, tx);
    }
  }

  // this split's unnormalized partial state
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + ty * TR + i;
    if (r >= RS) continue;
    const long long row = ((long long)bg * splits + split) * RS + r;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o_part[row * D + out_col(e, tx)] = o[i][e];
    if (tx == 0) {
      m_part[row] = m[i];
      l_part[row] = l[i];
    }
  }
}

// out (B*G, RS, D) in T = the log-sum-exp merge of the splits' partials.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ o_part,
                                            const float* __restrict__ m_part,
                                            const float* __restrict__ l_part, T* __restrict__ out,
                                            long long n, int RS, int D, int splits) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long bgr = idx / D;
    const int d = idx % D;
    const long long bg = bgr / RS, r = bgr % RS;
    float mx = NEG_INF;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[(bg * splits + s) * RS + r]);
    float lt = 0.f, ot = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long row = (bg * splits + s) * RS + r;
      const float w = expf(m_part[row] - mx);
      lt += w * l_part[row];
      ot += w * o_part[row * D + d];
    }
    out[idx] = from_f32<T>(ot / (lt == 0.f ? 1.f : lt));
  }
}

template <typename T, int D, int TR>
int launch(const void* q, const void* kc, const void* vc, const int* cache_len, const int* q_pos,
           float* o_part, float* m_part, float* l_part, void* out, int B, int G, int S, int RS,
           int T_len, int bk, int splits, int per, const long long* st, float scale,
           cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, D, TR>;
  const long long smem = smem_bytes<D, TR>(bk);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (T_len + bk - 1) / bk;
  dim3 grid((RS + 16 * TR - 1) / (16 * TR), B * G, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), cache_len,
      q_pos, o_part, m_part, l_part, G, S, RS, T_len, bk, nb, per, st[0], st[1], st[2], st[3],
      st[4], st[5], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)B * G * RS * D;
  const int blocks = static_cast<int>(std::min((n + 255) / 256, 65535LL));
  flash_decode_combine_kernel<T><<<blocks, 256, 0, stream>>>(o_part, m_part, l_part,
                                                             static_cast<T*>(out), n, RS, D,
                                                             splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tr(int tr, const void* q, const void* kc, const void* vc, const int* cache_len,
              const int* q_pos, float* o_part, float* m_part, float* l_part, void* out, int B,
              int G, int S, int RS, int T_len, int bk, int splits, int per, const long long* st,
              float scale, cudaStream_t stream) {
  if (tr == 4)
    return launch<T, D, 4>(q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B, G, S, RS,
                           T_len, bk, splits, per, st, scale, stream);
  if (tr == 1)
    return launch<T, D, 1>(q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B, G, S, RS,
                           T_len, bk, splits, per, st, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory the decode kernel needs at row-tile factor tr (1 or 4).
long long flash_decode_smem_bytes(int D, int tr, int bk) {
  if (D == 128) return tr == 4 ? smem_bytes<128, 4>(bk) : smem_bytes<128, 1>(bk);
  return tr == 4 ? smem_bytes<64, 4>(bk) : smem_bytes<64, 1>(bk);
}

// out (B, Hq, S, D) contiguous = split-KV decode attention of q (B, Hq, S, D)
// contiguous over the caches (B, G, T, D) (strides st = k's batch/group/seq,
// v's batch/group/seq, in elements; head dim contiguous, rows 16-byte
// aligned).  cache_len (B,) int32; q_pos (B, S) int32 or null.  Partials
// o_part (B*G, splits, Hq/G*S, D), m_part and l_part (B*G, splits, Hq/G*S)
// float32 scratch; split s covers KV blocks [s*per, (s+1)*per).  dtype 0 =
// float32, 1 = bfloat16; D = 64 or 128; tr = 1 or 4.  Returns a cudaError_t.
int flash_decode_fwd(const void* q, const void* kc, const void* vc, const int* cache_len,
                     const int* q_pos, float* o_part, float* m_part, float* l_part, void* out,
                     int dtype, int B, int Hq, int G, int S, int T_len, int D, int bk, int splits,
                     int per, int tr, const long long* strides, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int RS = Hq / G * S;
  if (dtype == 0 && D == 128)
    return launch_tr<float, 128>(tr, q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B,
                                 G, S, RS, T_len, bk, splits, per, strides, scale, s);
  if (dtype == 0 && D == 64)
    return launch_tr<float, 64>(tr, q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B,
                                G, S, RS, T_len, bk, splits, per, strides, scale, s);
  if (dtype == 1 && D == 128)
    return launch_tr<__nv_bfloat16, 128>(tr, q, kc, vc, cache_len, q_pos, o_part, m_part, l_part,
                                         out, B, G, S, RS, T_len, bk, splits, per, strides, scale,
                                         s);
  if (dtype == 1 && D == 64)
    return launch_tr<__nv_bfloat16, 64>(tr, q, kc, vc, cache_len, q_pos, o_part, m_part, l_part,
                                        out, B, G, S, RS, T_len, bk, splits, per, strides, scale,
                                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
