// Split-KV flash decoding for Hopper (sm_90a): attention of a few new
// queries per slot over the serving engine's KV cache, for both the
// whole-prompt prefill chunk and every decode step.
//
// Replaces the TPU kernel `flash_decode_pallas` (`_decode_kernel` and its
// log-sum-exp combine epilogue) of src/repro/kernels/flash_decode.py.
// q and K have a head dim D, v and the output one of their own, Dv.
//
// What it computes, as the reference does.  The rep = Hq / G query heads of
// a KV group are stacked into rep*S rows (row r is head r / S, query r % S).
// The cache is cut into KV blocks of bk keys; for block j and each row:
// scores s = scale * (q . k) in float32, masked to -1e30 where
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
// chunk (rep*S = 6144 rows per group) is bound by operations.  One design
// covers both:
//   * a block owns a tile of 16 * TR rows of one (batch, KV group) (TR = 1
//     for a decode step's few rows, 4 for a chunk's many) and a contiguous
//     range of KV blocks (a split); splits spread a decode step's few rows
//     over the card (one 512-key block each at the path's shapes), while
//     the prefill chunk's many row tiles fill it with one split;
//   * within a split the combine runs online, block after block; the
//     splits' (o, m, l) partials are merged in a fixed split order (bf16:
//     by the last block of the row tile to finish; float32: by a second
//     small kernel);
//   * KV blocks, and 64-key tiles inside one, that lie wholly past every
//     row's last visible key (cache length, or chunk causality) are skipped:
//     they contribute exactly 0 after the combine.  A row with no visible
//     key at all (an idle slot) counts as seeing up to T - 1, so its tile
//     walks every block and it gets the reference's mean of v; the keys of
//     the last block past T count in l as the reference's padding does (and
//     only there: keys of a tile past its block's end are neither summed nor
//     multiplied); a tile of such rows only (an idle slot's) skips K and
//     Q K^T, since every score is masked, and pays for p @ v alone.
//
// bf16 caches (the model's type; flash_decode_kernel_wgmma).  Both products
// on the tensor cores, each exactly the reference's function:
//   * s = q . k is a bf16 product with a float32 accumulator (wgmma
//     m64n64k16, q from shared memory, stored once), the scale applied to
//     the float32 scores after it (the reference scales q first: float32
//     rounding apart).  wgmma's 64 rows read the block's 16 * TR rows of Q
//     and, at TR = 1, 48 more from whatever shared memory follows: those
//     product rows are never used;
//   * o_j = round(p) @ v is a bf16 product too, since the reference rounds
//     p to the cache type first: one piece (wgmma m64nDk16, P from
//     registers), summed over the block's tiles in the tensor cores'
//     float32 accumulator and merged into the running output with
//     o = o * w_old + w_j * o_j.  p = exp(s - m_j) is `__expf` (the SFU's
//     ex2 after a multiply by log2 e, within a few float32 ulp of exp
//     before the rounding to bf16).
//   * The block-own-max rule needs every score of a block before any exp:
//     the scores stay in shared memory, each thread's own fragment in a
//     thread-private slot (16 * TR x bk float32, conflict-free float2s);
//     the second pass reads them back, exps, rounds and packs P's A
//     fragment in registers.  Scores are masked only on a tile that reaches
//     past the keys every row of the block sees, or past the block.
//   * Copies: a producer warp brings 64-key tiles of K and then V by TMA
//     (4-D maps over the (B, G, T, D) caches, a layer slice of a stacked
//     cache included; the maps are encoded once per buffer and cached) into
//     a ring of 4 stages, 128-byte swizzled, each guarded by an mbarrier;
//     the consumer warpgroup releases a stage as soon as its product is
//     done, so the V tiles of a block stream in while its scores are taken.
//     A decode step (TR = 1, 101 KB of shared memory a block) runs two
//     blocks an SM, all its blocks at once; its 512-key split is 16 tiles.
//     wgmma over mma.sync: the step's 3 rows waste 61 of wgmma's 64 rows,
//     but the tensor cores idle in a byte-bound step either way, and the
//     chunk, bound by operations, needs wgmma's rate; one body serves both.
//   * Splits: with one split (a prefill chunk) a block writes its rows'
//     output itself; else each writes its partials and the last block of
//     its row tile to finish (an arrival count per row tile, left at zero
//     for the next launch) merges all splits' partials in split order, so
//     there is no second launch.  An idle slot with one split gives every
//     row of its group the same mean of v: the group's first row tile
//     computes it and writes every row; the other row tiles exit at once.
// Shared memory at TR = 4, D = 128, bk = 512: 209 KB; at TR = 1, 101 KB.
//
// float32 caches (flash_decode_kernel; no model path decodes in float32 on
// the card): the body of the first port, unchanged, on the CUDA cores in
// FFMA with synchronous float32 shared-memory tiles (attn_tiles.cuh): q
// scaled first, each rounded p scaled by w_j = exp(m_j - m_run) and summed
// into the output per tile.  Shared memory at TR = 4, D = 128, bk = 512:
// 195 KB.
//
// Head dims (D, Dv) = (64, 64), (112, 112), (128, 128) and (96, 64).  112
// (zamba2-7b's shared attention block, MHA:
// one row per (slot, group) in a step) is 64 + 48: K and V tiles take two
// boxes, TMA zero-filling columns 112-127 (the maps' inner extent is 112);
// Q K^T runs 7 k16 steps, P V wgmma m64n128k16 over V's zero columns (16 of
// 128 of its products wasted), and only 112 columns are stored or merged.
// The float32 body pads V's tile and its output columns to 128 the same way.
// (96, 64) is MLA's pair (q/k of d_nope + d_rope, v of d_v), as the forward
// kernel takes it: q and K tiles take two boxes (TMA zero-filling K's
// columns 96-127, q's never read), Q K^T runs D / 16 = 6 k16 steps; V tiles,
// P V (N = 64), the partials, the merge and the output are Dv wide.  A ring
// stage holds the larger of a K and a V tile, each load expects its own
// tile's bytes, and K's and V's TMA maps are cached apart (the key holds
// the buffer and its head dim).  The float32 body's K/V tile is as wide as
// the wider of K's row and V's padded row.
//
// No atomics on data (only on the arrival counts), one thread per output
// sum in a fixed order, and a fixed split order in the merge: two launches
// are bitwise equal.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "attn_tiles.cuh"
#include "attn_wgmma.cuh"

namespace {

// -------------------------------------------------------------- float32 body

namespace simt {

using namespace attn;

__host__ __device__ constexpr int score_pitch(int bk) { return (bk + KT - 1) / KT * KT + 4; }

// V's tile and the output are padded to a multiple of 64 columns (the
// thread-to-column map of attn_tiles.cuh); the padding is zero and never
// stored.
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + 63) / 64 * 64;
}

// Floats a row of the K or V tile takes: K's D, or V's padded Dv.
template <int D, int DV>
__host__ __device__ constexpr int kv_cols() {
  return D > padded<DV>() ? D : padded<DV>();
}

template <int D, int DV, int TR>
constexpr long long smem_bytes(int bk) {
  // Q, the K or V tile (V's padded), the scores
  return 4LL * (16 * TR * (D + 4) + KT * (kv_cols<D, DV>() + 4) + 16 * TR * score_pitch(bk));
}

template <typename T, int D, int DV, int TR>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ cache_len, const int* __restrict__ q_pos,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int G, int S, int RS, int T_len, int bk, int nb,
                    int per, long long skb, long long skg, long long sks, long long svb,
                    long long svg, long long svs, float scale) {
  constexpr int BR = 16 * TR, DP = padded<DV>(), DPT = DP / 16;
  extern __shared__ float4 smem4[];
  const int sp = score_pitch(bk);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BR * (D + 4);
  float* Ss = KVs + KT * (kv_cols<D, DV>() + 4);
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
      load_tile<T, DV, DP>(KVs, vp + k0 * svs, svs, KT, kb_end - k0, 1.f, tid);
      __syncthreads();
      if (busy) pv_tile<DP, TR>(o, Ss + t * KT, sp, KVs, KT, ty, tx);
    }
  }

  // this split's unnormalized partial state
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + ty * TR + i;
    if (r >= RS) continue;
    const long long row = ((long long)bg * splits + split) * RS + r;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      if (DP == DV || out_col(e, tx) < DV) o_part[row * DV + out_col(e, tx)] = o[i][e];
    if (tx == 0) {
      m_part[row] = m[i];
      l_part[row] = l[i];
    }
  }
}

// out (B*G, RS, Dv) in T = the log-sum-exp merge of the splits' partials,
// each row Dv wide.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ o_part,
                                            const float* __restrict__ m_part,
                                            const float* __restrict__ l_part, T* __restrict__ out,
                                            long long n, int RS, int Dv, int splits) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long bgr = idx / Dv;
    const int d = idx % Dv;
    const long long bg = bgr / RS, r = bgr % RS;
    float mx = NEG_INF;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[(bg * splits + s) * RS + r]);
    float lt = 0.f, ot = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long row = (bg * splits + s) * RS + r;
      const float w = expf(m_part[row] - mx);
      lt += w * l_part[row];
      ot += w * o_part[row * Dv + d];
    }
    out[idx] = from_f32<T>(ot / (lt == 0.f ? 1.f : lt));
  }
}


}  // namespace simt

// ---------------------------------------------------------------- bf16 body

namespace tc {

using namespace attn_tc;

constexpr int STAGES = 4;               // K or V tiles in flight
constexpr int CONSUMERS = 128;          // one warpgroup: wgmma's 64 rows
constexpr int THREADS = CONSUMERS + 32; // and a producer warp behind it

__host__ __device__ constexpr int tiles_of(int bk) { return (bk + KT - 1) / KT; }

// Floats of a block's scores: 16 * TR rows x its tiles' keys.
template <int TR>
__host__ __device__ constexpr long long score_floats(int bk) {
  return 16LL * TR * tiles_of(bk) * KT;
}

// Bytes of a ring stage: a K tile or a V tile, whichever is larger.
template <int D, int DV>
__host__ __device__ constexpr int stage_bytes() {
  return tile_bytes(KT, D) > tile_bytes(KT, DV) ? tile_bytes(KT, D) : tile_bytes(KT, DV);
}

template <int D, int DV, int TR>
constexpr long long smem_bytes(int bk) {
  // alignment slack, Q, the ring, the scores, 2 barriers a stage, 3 flags
  return 1024 + tile_bytes(16 * TR, D) + STAGES * stage_bytes<D, DV>() +
         4 * score_floats<TR>(bk) + 2 * STAGES * 8 + 16;
}

template <int D, int DV, int TR>
__global__ void __launch_bounds__(THREADS, TR == 1 ? 2 : 1)
flash_decode_kernel_wgmma(const __grid_constant__ KvMaps maps, const bf16* __restrict__ q,
                          const int* __restrict__ cache_len, const int* __restrict__ q_pos,
                          float* __restrict__ o_part, float* __restrict__ m_part,
                          float* __restrict__ l_part, bf16* __restrict__ out, int* arrivals,
                          int G, int S, int RS, int T_len, int bk, int nb, int per, float scale) {
  constexpr int ROWS = 16 * TR;  // query rows of a block
  constexpr int KEEP = 32 * TR;  // threads that hold them (warps 0..TR-1)
  constexpr int NV = boxes(DV) * BOX;  // P V's N: Dv, or 128 for 112 (zero columns dropped)
  constexpr int ACC = NV / 2;
  constexpr int TILE = stage_bytes<D, DV>();  // a ring stage
  constexpr int TILE_K = tile_bytes(KT, D), TILE_V = tile_bytes(KT, DV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* Qs = smem;
  // Q holds the block's rows only: wgmma reads 64, and the product's rows
  // past ROWS (read from whatever follows) are never used
  unsigned char* ring = Qs + tile_bytes(ROWS, D);
  // the block's scores: a thread's 16 pairs of tile t at (16t + i2) * KEEP + its index
  float2* Ss = reinterpret_cast<float2*>(ring + STAGES * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(Ss + score_floats<TR>(bk) / 2);
  uint64_t* empty = full + STAGES;
  int* flags = reinterpret_cast<int*>(empty + STAGES);  // limit, seen, common, last

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS, bg = blockIdx.y, b = bg / G, g = bg % G;
  const int split = blockIdx.z, splits = gridDim.z;
  const int valid = min(cache_len[b], T_len);
  // an idle slot (no cached key) gives every row of the group the same
  // mean of v: with one split, the first row tile computes it for all
  if (valid == 0 && splits == 1 && blockIdx.x > 0) return;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    flags[0] = 0, flags[1] = 0, flags[2] = INT_MAX;
  }
  // keys at or past `limit` are masked for every row of the tile; a row
  // with no visible key at all sees every key (its scores are all -1e30 and
  // p = exp(0) = 1: the reference's mean of v over the padded cache)
  const bool counts = tid < ROWS && r0 + tid < RS;
  const int seen = !counts ? 0 : q_pos ? min(valid, q_pos[b * S + (r0 + tid) % S] + 1) : valid;
  if (tid < CONSUMERS)
    store_rows<D>(Qs, ROWS, q + ((long long)bg * RS + r0) * D, D, ROWS, min(ROWS, RS - r0), tid,
                  CONSUMERS);
  fence_async();
  __syncthreads();
  if (counts) {
    atomicMax(&flags[0], seen > 0 ? seen : T_len);
    atomicMin(&flags[2], seen);
    if (seen > 0) flags[1] = 1;
  }
  __syncthreads();
  const int limit = flags[0];
  const int common = flags[2];  // keys below it are visible to every row
  // a tile whose rows see no key at all (an idle slot) needs no scores:
  // every one is masked, so neither K nor Q K^T is touched (block-uniform)
  const bool blind = flags[1] == 0;
  const int j_end = min(nb, (split + 1) * per);

  if (tid >= CONSUMERS) {  // the producer: K tiles, then V tiles, of each block
    if (tid == CONSUMERS) {
      int n = 0;
      // the next stage of the ring, once its last tile has been read
      auto next = [&](int bytes) {
        const int s = n % STAGES;
        mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], bytes);
        ++n;
        return s;
      };
      for (int j = split * per; j < j_end && j * bk < limit; ++j) {
        const int kb0 = j * bk;
        const int nt = (min(min(kb0 + bk, T_len), limit) - kb0 + KT - 1) / KT;
        if (!blind)
          for (int t = 0; t < nt; ++t) {
            const int s = next(TILE_K);
            load_tile<D>(ring + s * TILE, maps.k, kb0 + t * KT, g, b, KT, &full[s]);
          }
        for (int t = 0; t < nt; ++t) {
          const int s = next(TILE_V);
          load_tile<DV>(ring + s * TILE, maps.v, kb0 + t * KT, g, b, KT, &full[s]);
        }
      }
    }
    return;
  }

  const int wq = tid >> 5, lane = tid & 31, quad = lane & 3;
  const bool keeps = wq < TR && r0 + 16 * wq < RS;  // the warp has rows (warp-uniform)
  const int row0 = r0 + 16 * wq + (lane >> 2);      // and row0 + 8
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = min(row0 + 8 * hh, RS - 1);
    pos[hh] = q_pos ? q_pos[b * S + r % S] : T_len;
  }

  float o[ACC], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ACC; ++i) o[i] = 0.f;

  int n = 0;  // position in the ring's sequence of tiles
  for (int j = split * per; j < j_end && j * bk < limit; ++j) {
    const int kb0 = j * bk, kb_end = min(kb0 + bk, T_len);
    const int nt = (min(kb_end, limit) - kb0 + KT - 1) / KT;
    // keys of the block past its scored tiles (past T: the reference's
    // padding) are masked for every row; each adds exp(-1e30 - m_j) to l_j,
    // which is 1 for a row with no visible key in the block and 0 otherwise
    const float unscored = static_cast<float>(bk - min(nt * KT, kb_end - kb0));

    // pass 1: the block's scores into shared memory, and each row's max;
    // pair i2 of a tile's fragment is row row0 + 8 (i2 % 2), keys
    // 8 (i2 / 2) + 2 quad + {0, 1}
    float mx[2] = {NEG_INF, NEG_INF};
    if (!blind) {
      for (int t = 0; t < nt; ++t, ++n) {
        const int s = n % STAGES;
        float sc[32];
        mbar_wait(&full[s], (n / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_qk(sc, desc_k(Qs, ROWS, kk), desc_k(ring + s * TILE, KT, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (keeps) {
          const int kt0 = kb0 + t * KT;
          // only a tile that reaches past the keys every row sees, or past
          // the block, has masked scores (block-uniform)
          const bool edge = kt0 + KT > min(common, kb_end);
#pragma unroll
          for (int i2 = 0; i2 < 16; ++i2) {
            const int hh = i2 & 1, key = kt0 + 8 * (i2 >> 1) + 2 * quad;
            float2 x = make_float2(__fmul_rn(sc[2 * i2], scale), __fmul_rn(sc[2 * i2 + 1], scale));
            if (edge) {
              if (key >= kb_end || key >= valid || key > pos[hh]) x.x = NEG_INF;
              if (key + 1 >= kb_end || key + 1 >= valid || key + 1 > pos[hh]) x.y = NEG_INF;
            }
            mx[hh] = fmaxf(mx[hh], fmaxf(x.x, x.y));
            Ss[(16 * t + i2) * KEEP + tid] = x;
          }
        }
      }
    }
    float m_j[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m_j[hh] = quad_max(mx[hh]);

    // pass 2: p = exp(s - m_j) rounded to bf16 (the keys of the block only),
    // o_j = round(p) @ v over the block's tiles
    float oj[ACC];
    for (int t = 0; t < nt; ++t, ++n) {
      const int s = n % STAGES;
      uint32_t pa[4][4];
      const int kt0 = kb0 + t * KT;
      const bool inside = kt0 + KT <= kb_end;  // every key of the tile is the block's
      if (keeps && blind && inside) {  // every score masked: p = exp(0) = 1
#pragma unroll
        for (int i2 = 0; i2 < 16; ++i2) pa[i2 >> 2][i2 & 3] = 0x3F803F80u;  // bf16 1, 1
        sum[0] = __fadd_rn(sum[0], 16.f);
        sum[1] = __fadd_rn(sum[1], 16.f);
      } else if (keeps) {
        float part[2][4];
#pragma unroll
        for (int i2 = 0; i2 < 16; ++i2) {
          const int hh = i2 & 1, key = kt0 + 8 * (i2 >> 1) + 2 * quad;
          const float2 x = blind ? make_float2(NEG_INF, NEG_INF) : Ss[(16 * t + i2) * KEEP + tid];
          float p0 = __expf(__fsub_rn(x.x, m_j[hh])), p1 = __expf(__fsub_rn(x.y, m_j[hh]));
          if (!inside) {
            if (key >= kb_end) p0 = 0.f;
            if (key + 1 >= kb_end) p1 = 0.f;
          }
          const float pp = __fadd_rn(p0, p1);
          part[hh][i2 >> 2] = (i2 & 2) ? __fadd_rn(part[hh][i2 >> 2], pp) : pp;
          pa[i2 >> 2][i2 & 3] = pack_bf16(p0, p1);  // step i2 / 4, pair i2 % 4
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          sum[hh] = __fadd_rn(sum[hh], __fadd_rn(__fadd_rn(part[hh][0], part[hh][1]),
                                                 __fadd_rn(part[hh][2], part[hh][3])));
      } else {
#pragma unroll
        for (int i2 = 0; i2 < 16; ++i2) pa[i2 >> 2][i2 & 3] = 0u;
      }
      mbar_wait(&full[s], (n / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<NV>(oj, pa[kk], desc_v(ring + s * TILE, kk), t > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oj);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the block into the running combine
    float w_old[2], w_j[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lj = __fadd_rn(quad_sum(sum[hh]),
                                 __fmul_rn(unscored, expf(__fsub_rn(NEG_INF, m_j[hh]))));
      const float m_new = fmaxf(m[hh], m_j[hh]);
      w_old[hh] = expf(__fsub_rn(m[hh], m_new));
      w_j[hh] = expf(__fsub_rn(m_j[hh], m_new));
      l[hh] = fmaf(l[hh], w_old[hh], __fmul_rn(w_j[hh], lj));
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int hh = (i >> 1) & 1;
      o[i] = fmaf(o[i], w_old[hh], __fmul_rn(w_j[hh], oj[i]));
    }
  }

  if (splits == 1 && valid == 0) {  // row 0's output, written to every row of the group
    bf16* row = reinterpret_cast<bf16*>(Ss);  // the scores are no longer read
    if (tid < 4) {
      const float li = l[0] == 0.f ? 1.f : l[0];
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<uint32_t*>(row + 8 * c + 2 * quad) =
            pack_bf16(__fdiv_rn(o[4 * c], li), __fdiv_rn(o[4 * c + 1], li));
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(out + (long long)bg * RS * DV);
    for (long long i = tid; i < (long long)RS * (DV / 8); i += CONSUMERS)
      dst[i] = src[i % (DV / 8)];
    return;
  }
  if (splits == 1) {  // the whole cache in one split: the output itself
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      if (!keeps || r >= RS) continue;
      const float li = l[hh] == 0.f ? 1.f : l[hh];
      bf16* dst = out + ((long long)bg * RS + r) * DV + 2 * quad;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) =
            pack_bf16(__fdiv_rn(o[4 * c + 2 * hh], li), __fdiv_rn(o[4 * c + 2 * hh + 1], li));
    }
    return;
  }
  // this split's unnormalized partial state
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (!keeps || r >= RS) continue;
    const long long row = ((long long)bg * splits + split) * RS + r;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      *reinterpret_cast<float2*>(o_part + row * DV + 8 * c + 2 * quad) =
          make_float2(o[4 * c + 2 * hh], o[4 * c + 2 * hh + 1]);
    if (quad == 0) m_part[row] = m[hh], l_part[row] = l[hh];
  }

  // the combine, folded: the last block of this row tile to finish merges
  // every split's partials in split order (the order, and so the bits, do
  // not depend on which block is last) and clears its arrival count for the
  // next launch.  The barrier makes the block's partials visible to thread
  // 0, whose fence then publishes them before its arrival; the last block's
  // thread 0 fences again before the block reads the others' partials.
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  int* count = arrivals + (long long)bg * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(count, 1) == splits - 1;
    if (last) __threadfence();
    flags[3] = last;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  if (!flags[3]) return;
  // warp wq merges rows r0 + wq, r0 + wq + 4, ...; lane its vectors
  // lane, lane + 32, ... of VW columns each; every split's loads in flight
  // at once, 8 splits at a time
  constexpr int VW = DV % 128 == 0 ? 4 : 2;          // floats a vector holds
  constexpr int NVEC = DV / VW, VPL = (NVEC + 31) / 32;  // vectors a row has, a lane takes
  using Vec = typename std::conditional<VW == 4, float4, float2>::type;
  for (int r = r0 + wq; r < min(r0 + ROWS, RS); r += CONSUMERS / 32) {
    const long long first = (long long)bg * splits * RS + r;  // split 0's row
    float mx = NEG_INF;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float ms[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ms[i] = __ldcg(m_part + first + min(s0 + i, splits - 1) * RS);
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, ms[i]);  // a repeated last split changes nothing
    }
    float lt = 0.f, ot[VPL][VW];
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int c = 0; c < VW; ++c) ot[v][c] = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float ms[8], ls[8];
      Vec os[8][VPL];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = first + min(s0 + i, splits - 1) * RS;
        ms[i] = __ldcg(m_part + row), ls[i] = __ldcg(l_part + row);
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          os[i][v] = lane + 32 * v < NVEC
              ? __ldcg(reinterpret_cast<const Vec*>(o_part + row * DV) + lane + 32 * v)
              : Vec{};
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (s0 + i >= splits) break;
        const float w = expf(__fsub_rn(ms[i], mx));
        lt = fmaf(w, ls[i], lt);
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const float* o_i = reinterpret_cast<const float*>(&os[i][v]);
#pragma unroll
          for (int c = 0; c < VW; ++c) ot[v][c] = fmaf(w, o_i[c], ot[v][c]);
        }
      }
    }
    const float li = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (lane + 32 * v >= NVEC) continue;
      bf16* dst = out + ((long long)bg * RS + r) * DV + (lane + 32 * v) * VW;
#pragma unroll
      for (int c = 0; c < VW; c += 2)
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16(__fdiv_rn(ot[v][c], li), __fdiv_rn(ot[v][c + 1], li));
    }
  }
  if (tid == 0) *count = 0;
}

}  // namespace tc

template <int D, int DV, int TR>
int launch_simt(const void* q, const void* kc, const void* vc, const int* cache_len,
                const int* q_pos, float* o_part, float* m_part, float* l_part, void* out, int B,
                int G, int S, int RS, int T_len, int bk, int splits, int per, const long long* st,
                float scale, cudaStream_t stream) {
  auto kernel = simt::flash_decode_kernel<float, D, DV, TR>;
  const long long smem = simt::smem_bytes<D, DV, TR>(bk);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (T_len + bk - 1) / bk;
  dim3 grid((RS + 16 * TR - 1) / (16 * TR), B * G, splits);
  kernel<<<grid, attn::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc), static_cast<const float*>(vc),
      cache_len, q_pos, o_part, m_part, l_part, G, S, RS, T_len, bk, nb, per, st[0], st[1], st[2],
      st[3], st[4], st[5], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)B * G * RS * DV;
  const int blocks = static_cast<int>(std::min((n + 255) / 256, 65535LL));
  simt::flash_decode_combine_kernel<float><<<blocks, 256, 0, stream>>>(
      o_part, m_part, l_part, static_cast<float*>(out), n, RS, DV, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV, int TR>
int launch_tc(const void* q, const void* kc, const void* vc, const int* cache_len,
              const int* q_pos, float* o_part, float* m_part, float* l_part, void* out, int B,
              int G, int S, int RS, int T_len, int bk, int splits, int per, const long long* st,
              float scale, cudaStream_t stream, int* arrivals) {
  using namespace tc;
  KvMaps maps;
  if (!cached_kv(&maps.k, kc, B, G, T_len, D, st[0], st[1], st[2], KT) ||
      !cached_kv(&maps.v, vc, B, G, T_len, DV, st[3], st[4], st[5], KT))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_decode_kernel_wgmma<D, DV, TR>;
  const long long smem = smem_bytes<D, DV, TR>(bk);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (T_len + bk - 1) / bk;
  dim3 grid((RS + 16 * TR - 1) / (16 * TR), B * G, splits);
  kernel<<<grid, THREADS, smem, stream>>>(maps, static_cast<const bf16*>(q), cache_len, q_pos,
                                          o_part, m_part, l_part, static_cast<bf16*>(out),
                                          arrivals, G, S, RS, T_len, bk, nb, per, scale);
  return static_cast<int>(cudaGetLastError());  // the kernel merges the splits itself
}

template <int D, int DV, int TR>
int launch(int dtype, const void* q, const void* kc, const void* vc, const int* cache_len,
           const int* q_pos, float* o_part, float* m_part, float* l_part, void* out, int B, int G,
           int S, int RS, int T_len, int bk, int splits, int per, const long long* st,
           float scale, cudaStream_t stream, int* arrivals) {
  if (dtype == 0)
    return launch_simt<D, DV, TR>(q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B, G, S,
                              RS, T_len, bk, splits, per, st, scale, stream);
  return launch_tc<D, DV, TR>(q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B, G, S, RS,
                          T_len, bk, splits, per, st, scale, stream, arrivals);
}

// Shared memory of one block of the decode kernel: the larger of its two
// bodies' needs.
template <int D, int DV, int TR>
long long smem_of(int bk) {
  return std::max(simt::smem_bytes<D, DV, TR>(bk), tc::smem_bytes<D, DV, TR>(bk));
}

}  // namespace

extern "C" {

// Shared memory of one block of the decode kernel at head dims (D, Dv)
// ((64, 64), (112, 112), (128, 128) or (96, 64)), row-tile factor tr (1 or 4)
// and KV block bk: the larger of its two bodies' needs, so that one plan
// serves both types; -1 for a pair or tr the kernel has no instance of.
long long flash_decode_smem_bytes(int D, int tr, int bk, int Dv) {
  if (tr != 1 && tr != 4) return -1;
#define FD_SMEM(DD, DDV) \
  if (D == DD && Dv == DDV) return tr == 4 ? smem_of<DD, DDV, 4>(bk) : smem_of<DD, DDV, 1>(bk);
  FD_SMEM(64, 64)
  FD_SMEM(112, 112)
  FD_SMEM(128, 128)
  FD_SMEM(96, 64)
#undef FD_SMEM
  return -1;
}

// Lookups of the bf16 body's cache of TMA maps (16 maps, keyed by buffer
// and shape) since the library loaded: stats[0] found, stats[1] encoded.
void flash_decode_map_cache_stats(long long* stats) {
  stats[0] = attn_tc::map_cache_stats().hits;
  stats[1] = attn_tc::map_cache_stats().misses;
}

// out (B, Hq, S, Dv) contiguous = split-KV decode attention of q (B, Hq, S, D)
// contiguous over the caches k (B, G, T, D) and v (B, G, T, Dv) (strides st =
// k's batch/group/seq, v's batch/group/seq, in elements; head dim
// contiguous, rows 16-byte aligned).  cache_len (B,) int32; q_pos (B, S)
// int32 or null.  Partials o_part (B*G, splits, Hq/G*S, Dv), m_part and
// l_part (B*G, splits, Hq/G*S) float32 scratch; split s covers KV blocks
// [s*per, (s+1)*per).  dtype 0 = float32, 1 = bfloat16; (D, Dv) = (64, 64),
// (112, 112), (128, 128) or (96, 64); tr = 1 or 4.  arrivals: B*G*ceil(Hq/G*S
// / (16 tr)) int32 zeros on the device, which bfloat16 launches use to find
// the last block of each row tile (and leave zero); a launch must not
// overlap another that uses the same ones.  Returns a cudaError_t.
int flash_decode_fwd(const void* q, const void* kc, const void* vc, const int* cache_len,
                     const int* q_pos, float* o_part, float* m_part, float* l_part, void* out,
                     int dtype, int B, int Hq, int G, int S, int T_len, int D, int Dv, int bk,
                     int splits, int per, int tr, const long long* strides, float scale,
                     void* stream, int* arrivals) {
  auto s = static_cast<cudaStream_t>(stream);
  const int RS = Hq / G * S;
  auto run = [&](auto launch_fn) {
    return launch_fn(dtype, q, kc, vc, cache_len, q_pos, o_part, m_part, l_part, out, B, G, S, RS,
                     T_len, bk, splits, per, strides, scale, s, arrivals);
  };
  if ((dtype != 0 && dtype != 1) || (tr != 1 && tr != 4))
    return static_cast<int>(cudaErrorInvalidValue);
#define FD_LAUNCH(DD, DDV)                                                  \
  if (D == DD && Dv == DDV)                                                 \
    return tr == 4 ? run(launch<DD, DDV, 4>) : run(launch<DD, DDV, 1>);
  FD_LAUNCH(128, 128)
  FD_LAUNCH(112, 112)
  FD_LAUNCH(64, 64)
  FD_LAUNCH(96, 64)
#undef FD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
