// Blockwise (flash) attention for Hopper (sm_90a): the full-sequence
// attention of the dense LM forward, and one step of the sequence-parallel
// attention ring.
//
// Replaces the TPU kernels `flash_attention_pallas` (`_flash_kernel` with
// has_carry=False, emit_state=False) and `flash_attention_carry_pallas`
// (has_carry=True, emit_state=True) of src/repro/kernels/flash_attention.py.
//
// What it computes, as the reference does: scores q . k scaled by `scale`,
// exp, the running (acc, m, l) online-softmax state and p @ v, all in
// float32; the causal mask is q_pos >= k_pos with q and k both starting at
// 0 (top-left aligned); keys at or past Skv are masked; masked scores are
// the finite -1e30, not -inf; a row whose l is 0 is divided by 1; the
// output is acc / l, an IEEE division as the reference's, in q's type.
// GQA: query head h reads KV head h / (Hq / G) in place, with no repeat.
// v has a head dim of its own, Dv, and the output is (B, Hq, Sq, Dv), as
// the reference's: instances (D, Dv) = (64, 64), (128, 128) and, for MLA's
// forward (q/k of d_nope + d_rope = 96, v of d_v = 64), (96, 64), and for
// zamba2-7b's shared attention block (112, 112).
//
// Two bodies, one per input type.
//
// bf16 (the model's type; flash_attention_kernel_wgmma).  Bound: at the
// forward's shape (Sq = Skv = 4096, D = 128, causal) the work is
// 2 * Sq * Skv * D products per head, against ~4 * S * D * 2 bytes, so the
// kernel is bound by operations, those of the tensor cores:
//   * S = q k^T is one bf16 product with a float32 accumulator (wgmma
//     m64n64k16, Q and K from shared memory): every product of two bf16
//     values is exact in float32, so it is the reference's float32 score
//     up to the order of the sum.  The scale multiplies the float32 scores
//     after the product, where the reference scales q before it: the two
//     differ by float32 rounding.  p = exp(s - m) is `__expf` (the SFU's
//     ex2 after a multiply by log2 e, within a few float32 ulp of exp at
//     these arguments); alpha = exp(m_old - m_new) is `expf`.
//   * p @ v: p is float32 and only v is bf16, so p goes in as two bf16
//     pieces (PIECES), hi = bf16(p) and lo = bf16(p - hi) (p - hi is
//     exact), both products into one float32 accumulator (wgmma m64n128k16,
//     P from registers as the A operand, V from shared memory in its stored
//     MN-major layout): hi + lo keeps 16 of p's 24 bits, within 2^-16 of p,
//     and the error against float64 stays within 10x the plain version's
//     (chip_smoke.py measures it; one bf16 rounding of p alone is far over,
//     tests/test_torch_attention_split.py).  The tensor cores add into
//     their accumulator with truncation, so each 64-key tile's p @ v starts
//     from zero and is added to the running output with one rounded fma
//     (o = o * alpha + pv).
//   * Tiles: a block owns 128 query rows of one head, two consumer
//     warpgroups of 64; key tiles are 64 keys.  One thread of a third
//     warpgroup (the producer; setmaxnreg gives it 40 registers and the
//     consumers 232) brings K and V tiles by TMA (4-D maps over the strided
//     (B, G, S, D) operands, boxes past Skv zero-filled) into a ring of 4
//     stages of 128-byte-swizzled tiles, each half guarded by an mbarrier;
//     a stage is refilled once both consumer warpgroups have read it.  Q is
//     stored once by the consumers.
//   * Pipeline: a consumer warpgroup starts tile t-1's P V and tile t's
//     Q K^T together, then adds the P V into the output (while Q K^T runs)
//     and takes tile t's softmax on the accumulator registers: scale, mask
//     (only on a tile that reaches past Skv, valid_len or its first row's
//     diagonal), max and sum as trees over the fragment and its quad of
//     lanes, exp, and the split of p into the A fragments of the next P V.
//     The two warpgroups take turns at starting them (named barriers), so one's
//     softmax runs while the other's products do.  Per tile the operations
//     and their order are those of a tile at a time.
//   * Causal: each warpgroup stops at its own diagonal (a 64-row tile
//     never computes a key tile that starts past its last row, the
//     reference's `diag_ok`), and the grid puts the longest query tiles
//     first, so the last wave is short tiles.
//
// The (96, 64) instance.  96 is not a multiple of the 64-column box: q and
// K tiles take two boxes, the second half empty (TMA zero-fills K's columns
// 96-127, q's are never written), and Q K^T runs D / 16 = 6 k16 steps, so
// no empty column costs tensor work; P V, the output accumulators, the V
// stage of the ring and the epilogue are sized by Dv (one box, N = 64).
// Its work at MLA's shape is 4/7 in Q K^T, so it is bound by operations
// like the others.  Its carry form (MLA under the sequence-parallel
// recipes) keeps the state acc (B, Hq, Sq, 64) at the state's own width:
// the P V accumulators are 64 columns, one box, so HAS_CARRY reads and
// EMIT_STATE writes exactly Dv columns a row (stride Dv), whatever the 128
// columns of q/K's tiles; nothing past a row's 64 columns is touched.
//
// The (112, 112) instance (zamba2-7b's shared attention block).  112 =
// 64 + 48: q, K and V tiles take two boxes each, TMA zero-filling columns
// 112-127 of K and V (the maps' inner extent is 112); Q K^T runs 7 k16
// steps, so no empty column costs it; P V runs wgmma m64n128k16 over V's
// zero columns (16 of 128 of its products wasted) and the epilogue stores
// 112 columns.  Shared memory, registers and the pipeline are the
// (128, 128) instance's.  The float32 body pads V's tile and the output
// to 128 columns the same way.  The carry form at (112, 112) keeps the
// state acc (B, Hq, Sq, 112) in device memory while a thread's P V
// accumulators span 128 columns: HAS_CARRY loads columns 112-127 as zero
// (only columns below Dv are read) and EMIT_STATE stores only the first
// Dv / 8 column pairs of a row, so the padding never reaches the next
// row's state; the state update of a padding column is 0 * alpha + 0.
//
// float32 (flash_attention_kernel; no model path runs attention in float32
// on the card): the body of the first port on the CUDA cores in FFMA
// (attn_tiles.cuh): q is scaled by `scale` in float32 first; a block owns
// 64 query rows and walks 64-key tiles loaded synchronously into float32
// shared-memory tiles (K of D columns, V of Dv); each of 256 threads
// computes a 4x4 score micro-tile and a 4 x Dv/16 slice of the output.
// Bound: float32 operations (67 TFLOP/s on an H100 SXM).
//
// The carry form (`flash_attention_carry_pallas`, one step of the
// sequence-parallel ring) is the same body with two template flags, as the
// reference's `_flash_kernel` has them: HAS_CARRY starts each row from the
// (acc, m, l) float32 state in device memory instead of (0, -1e30, 0), and
// EMIT_STATE writes that state back, unnormalized and in place (the
// reference's input_output_aliases), instead of the output.  Positions are
// global: q_off + row and k_off + key; keys at global positions >= valid_len
// are masked too; a tile is skipped when k_off + k0 >= q_off + q0 + 64 for
// the 64 rows starting at q0 (the reference's `diag_ok`).  Everything
// between the load and the store is the single-shot op sequence, so carry
// steps chained over KV chunks that start on 64-key tile boundaries (the
// key tile of both bodies; the ring's chunks start at multiples of 1024),
// normalized as the ring's epilogue does (acc / l, l == 0 -> 1), reproduce
// the single-shot kernel bitwise.  The state update is written with
// explicit fmaf, __fmul_rn and __fsub_rn and the normalization with
// __fdiv_rn, so no instance of the template can contract it otherwise.
// Each output is summed by one thread in a fixed order, so two launches are
// bitwise equal.

#include <climits>

#include "attn_tiles.cuh"
#include "attn_wgmma.cuh"

namespace {

// --------------------------------------------------------------- float32 body

namespace simt {

using namespace attn;

constexpr int TR = 4;
constexpr int BR = 16 * TR;  // query rows per block

// V's tile and the output are padded to a multiple of 64 columns (the
// thread-to-column map of attn_tiles.cuh); the padding is zero and never
// stored.
template <int DV>
__host__ __device__ constexpr int padded() {
  return (DV + 63) / 64 * 64;
}

template <int D, int DV>
constexpr int smem_bytes() {
  return 4 * (BR * (D + 4) + KT * (D + 4) + KT * (padded<DV>() + 4) + BR * (KT + 4));  // Q, K, V, P
}

// Operand strides in elements: q's, k's and v's batch/head/sequence strides.
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T, int D, int DV, bool HAS_CARRY, bool EMIT_STATE>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, float* acc_st, float* m_st, float* l_st, int Hq,
                       int group, int Sq, int Skv, Strides st, float scale, bool causal,
                       int q_off, int k_off, int valid_len) {
  constexpr int DVP = padded<DV>(), DPT = DVP / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BR * (D + 4);
  float* Vs = Ks + KT * (D + 4);
  float* Ps = Vs + KT * (DVP + 4);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, g = h / group;
  // causal: tiles that start past the block's last row are all masked
  // (the reference's diag_ok: k_off + k0 < q_off + q0 + BR)
  const int kend = causal ? min(Skv, q_off + q0 + BR - k_off) : Skv;
  if (EMIT_STATE && kend <= 0) return;  // the state passes through unchanged
  const T* kp = k + b * st.kb + g * st.kh;
  const T* vp = v + b * st.vb + g * st.vh;

  load_tile<T, D>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BR, Sq - q0, scale, tid);

  float o[TR][DPT], m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty * TR + i;
    if (HAS_CARRY && r < Sq) {  // padded rows keep the (0, -1e30, 0) identity
      const long long row = (long long)bh * Sq + r;
      m[i] = m_st[row], l[i] = l_st[row];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int col = out_col(e, tx);
        o[i][e] = DVP == DV || col < DV ? acc_st[row * DV + col] : 0.f;
      }
    } else {
      m[i] = NEG_INF, l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[i][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kp + k0 * st.ks, st.ks, KT, Skv - k0, 1.f, tid);
    load_tile<T, DV, DVP>(Vs, vp + k0 * st.vs, st.vs, KT, Skv - k0, 1.f, tid);
    __syncthreads();

    float s[TR][4];
    score_tile<D, TR>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q_off + q0 + ty * TR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kloc = k0 + j * 16 + tx, kpos = k_off + kloc;
        if (kloc >= Skv || kpos >= valid_len || (causal && qpos < kpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(ty * TR + i) * (KT + 4) + j * 16 + tx] = s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = fmaf(l[i], alpha, half_warp_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[i][e] *= alpha;
    }
    __syncthreads();
    pv_tile<DVP, TR>(o, Ps, KT + 4, Vs, KT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty * TR + i;
    if (r >= Sq) continue;
    const long long row = (long long)bh * Sq + r;
    if (EMIT_STATE) {
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        if (DVP == DV || out_col(e, tx) < DV) acc_st[row * DV + out_col(e, tx)] = o[i][e];
      if (tx == 0) m_st[row] = m[i], l_st[row] = l[i];
    } else {
      const float li = l[i] == 0.f ? 1.f : l[i];  // guard fully masked rows
      T* dst = out + row * DV;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        if (DVP == DV || out_col(e, tx) < DV) dst[out_col(e, tx)] = from_f32<T>(__fdiv_rn(o[i][e], li));
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------- bf16 body

namespace tc {

using namespace attn_tc;

constexpr int WG_ROWS = 64;              // query rows of a consumer warpgroup
constexpr int ROWS = 2 * WG_ROWS;        // query rows of a block
constexpr int STAGES = 4;                // K/V tiles in flight
constexpr int THREADS = 384;             // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PIECES = 2;                // bf16 pieces of p in P @ V
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "setmaxnreg within 64K");

template <int D, int DV>
constexpr int smem_bytes() {
  // alignment slack, Q, the ring of K and V tiles, 3 barriers a stage
  return 1024 + tile_bytes(ROWS, D) + STAGES * (tile_bytes(KT, D) + tile_bytes(KT, DV)) +
         STAGES * 3 * 8;
}

template <int D, int DV, bool HAS_CARRY, bool EMIT_STATE>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ KvMaps maps, const bf16* __restrict__ q,
                             long long qb, long long qh, long long qs, bf16* __restrict__ out,
                             float* acc_st, float* m_st, float* l_st, int Hq, int group, int Sq,
                             int Skv, float scale, bool causal, int q_off, int k_off,
                             int valid_len) {
  constexpr int NV = boxes(DV) * BOX;  // P V's N: DV, or 128 for 112 (zero columns dropped)
  constexpr int ACC = NV / 2;  // output accumulators a thread holds
  constexpr int TILE_K = tile_bytes(KT, D), TILE_V = tile_bytes(KT, DV);
  constexpr int STAGE = TILE_K + TILE_V;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + tile_bytes(ROWS, D);  // stage s: K, then V
  uint64_t* full_k = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, g = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // the longest tiles first
  // causal: key tiles that start past the block's last row are all masked
  // (the reference's diag_ok: k_off + k0 < q_off + q0 + rows)
  const int kend = causal ? min(Skv, q_off + q0 + ROWS - k_off) : Skv;
  if (EMIT_STATE && kend <= 0) return;  // the state passes through unchanged
  const int ntiles = kend > 0 ? (kend + KT - 1) / KT : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full_k[s], TILE_K);
        load_tile<D>(ring + s * STAGE, maps.k, t * KT, g, b, KT, &full_k[s]);
        mbar_expect_tx(&full_v[s], TILE_V);
        load_tile<DV>(ring + s * STAGE + TILE_K, maps.v, t * KT, g, b, KT, &full_v[s]);
      }
    }
    return;
  }

  // the two consumer warpgroups, 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ct = tid - 128, w = ct >> 7, wt = ct & 127;
  const int lane = ct & 31, quad = lane & 3;
  const int row0 = q0 + w * WG_ROWS + ((ct >> 5) & 3) * 16 + (lane >> 2);  // and row0 + 8
  store_rows<D>(Qs + w * WG_ROWS * ROW_BYTES, ROWS, q + b * qb + h * qh + (q0 + w * WG_ROWS) * qs,
                qs, WG_ROWS, Sq - q0 - w * WG_ROWS, wt, 128);
  fence_async();
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");

  float o[ACC], m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (HAS_CARRY && r < Sq) {  // padded rows keep the (0, -1e30, 0) identity
      const long long row = (long long)bh * Sq + r;
      m[hh] = m_st[row], l[hh] = l_st[row];
#pragma unroll
      for (int c = 0; c < ACC / 4; ++c) {
        const float2 x = 8 * c < DV
            ? *reinterpret_cast<const float2*>(acc_st + row * DV + 8 * c + 2 * quad)
            : make_float2(0.f, 0.f);
        o[4 * c + 2 * hh] = x.x, o[4 * c + 2 * hh + 1] = x.y;
      }
    } else {
      m[hh] = NEG_INF, l[hh] = 0.f;
#pragma unroll
      for (int c = 0; c < ACC / 4; ++c) o[4 * c + 2 * hh] = o[4 * c + 2 * hh + 1] = 0.f;
    }
  }

  // this warpgroup's own diagonal: it computes tiles 0..nt_w-1 and only
  // releases the rest
  const int kend_w = causal ? min(Skv, q_off + q0 + (w + 1) * WG_ROWS - k_off) : Skv;
  const int nt_w = kend_w > 0 ? min(ntiles, (kend_w + KT - 1) / KT) : 0;
  const unsigned char* Qw = Qs + w * WG_ROWS * ROW_BYTES;
  float sc[32], pv[ACC], alpha[2];
  uint32_t pa[PIECES][4][4];

  auto release = [&](int t) {  // tile t's stage is read (or was never needed)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % STAGES]);
  };
  auto start_qk = [&](int t) {
    const unsigned char* Ks = ring + (t % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(sc, desc_k(Qw, ROWS, kk), desc_k(Ks, KT, kk), kk > 0);
    wgmma_commit();
  };
  auto start_pv = [&](int t) {
    const unsigned char* Vs = ring + (t % STAGES) * STAGE + TILE_K;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pc = PIECES - 1; pc >= 0; --pc)  // the small pieces first
        wgmma_pv<NV>(pv, pa[pc][kk], desc_v(Vs, kk), kk > 0 || pc < PIECES - 1);
    wgmma_commit();
  };
  auto add_pv = [&]() {  // o = o * alpha + P V, once P V has landed
    fence_regs(pv);
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) fence_regs(pa[pc]);
#pragma unroll
    for (int i = 0; i < ACC; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  };
  // tile t's scores in sc: scale, mask, online softmax, and p's pieces into pa
  auto softmax = [&](int t) {
    fence_regs(sc);
    // sc[4c + 2hh + e] is row row0 + 8hh, key k0 + 8c + 2quad + e.  Only a
    // tile that reaches past Skv, past valid_len or, causal, past this
    // warpgroup's first row has masked scores (warp-uniform).
    const int k0 = t * KT;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = __fmul_rn(sc[i], scale);
    if (k0 + KT > Skv || k_off + k0 + KT > valid_len ||
        (causal && k_off + k0 + KT - 1 > q_off + q0 + w * WG_ROWS)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kloc = k0 + 8 * (i / 4) + 2 * quad + i % 2, kpos = k_off + kloc;
        const int qpos = q_off + row0 + 8 * ((i / 2) % 2);
        if (kloc >= Skv || kpos >= valid_len || (causal && qpos < kpos)) sc[i] = NEG_INF;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // the row's 16 values: sc[4c + 2hh + e]; max and sum as trees
      float mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx[j] = fmaxf(fmaxf(sc[8 * j + 2 * hh], sc[8 * j + 2 * hh + 1]),
                      fmaxf(sc[8 * j + 4 + 2 * hh], sc[8 * j + 5 + 2 * hh]));
      const float m_new = fmaxf(m[hh], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
      float part[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* x = sc + 8 * j + 2 * hh;
        x[0] = __expf(__fsub_rn(x[0], m_new));
        x[1] = __expf(__fsub_rn(x[1], m_new));
        x[4] = __expf(__fsub_rn(x[4], m_new));
        x[5] = __expf(__fsub_rn(x[5], m_new));
        part[j] = __fadd_rn(__fadd_rn(x[0], x[1]), __fadd_rn(x[4], x[5]));
      }
      const float sum = __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
      alpha[hh] = expf(__fsub_rn(m[hh], m_new));
      l[hh] = fmaf(l[hh], alpha[hh], quad_sum(sum));
      m[hh] = m_new;
    }
    // p in PIECES bf16 pieces, each the A fragment of P @ V: step kk, pair
    // j = sc[8kk + 2j], sc[8kk + 2j + 1]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x0 = sc[8 * kk + 2 * j], x1 = sc[8 * kk + 2 * j + 1];
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          const uint32_t p = pack_bf16(x0, x1);
          pa[pc][kk][j] = p;
          x0 = __fsub_rn(x0, bf16_lo(p));  // exact: the rest below this piece
          x1 = __fsub_rn(x1, bf16_hi(p));
        }
      }
  };

  // Section t starts P V of tile t-1 and Q K^T of tile t together; the two
  // warpgroups take turns at their sections (named barriers 3 and 4,
  // warpgroup 0 first), so that one's softmax runs while the other's
  // products do.  Between its sections a warpgroup adds tile t-1's P V into
  // the output and takes tile t's softmax: the same operations in the same
  // order as one tile at a time.  Both take ntiles + 1 turns.
  auto turn = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(3 + w) : "memory"); };
  auto pass_turn = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(4 - w) : "memory"); };
  if (w == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");
  int t = 0;
  if (nt_w > 0) {
    mbar_wait(&full_k[0], 0);
    turn();
    wgmma_fence();
    start_qk(0);
    pass_turn();
    wgmma_wait_all();
    softmax(0);
    for (t = 1; t < nt_w; ++t) {
      mbar_wait(&full_v[(t - 1) % STAGES], ((t - 1) / STAGES) & 1);
      mbar_wait(&full_k[t % STAGES], (t / STAGES) & 1);
      turn();
      wgmma_fence();
      start_pv(t - 1);
      start_qk(t);
      pass_turn();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // P V landed
      add_pv();
      release(t - 1);
      wgmma_wait_all();
      softmax(t);
    }
    mbar_wait(&full_v[(t - 1) % STAGES], ((t - 1) / STAGES) & 1);
    turn();
    wgmma_fence();
    start_pv(t - 1);
    pass_turn();
    wgmma_wait_all();
    add_pv();
    release(t - 1);
    ++t;
  }
  for (; t <= ntiles; ++t) {  // nothing left to compute: keep the turns, release the rest
    turn();
    pass_turn();
    if (t >= 1) release(t - 1);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= Sq) continue;
    const long long row = (long long)bh * Sq + r;
    if (EMIT_STATE) {
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<float2*>(acc_st + row * DV + 8 * c + 2 * quad) =
            make_float2(o[4 * c + 2 * hh], o[4 * c + 2 * hh + 1]);
      if (quad == 0) m_st[row] = m[hh], l_st[row] = l[hh];
    } else {
      const float li = l[hh] == 0.f ? 1.f : l[hh];  // guard fully masked rows
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + row * DV + 8 * c + 2 * quad) =
            pack_bf16(__fdiv_rn(o[4 * c + 2 * hh], li), __fdiv_rn(o[4 * c + 2 * hh + 1], li));
    }
  }
}

}  // namespace tc


template <typename T, int D, int DV, bool CARRY>
int launch(const void* q, const void* k, const void* v, void* out, float* acc, float* m, float* l,
           int B, int Hq, int G, int Sq, int Skv, const long long* st, float scale, int causal,
           int q_off, int k_off, int valid_len, cudaStream_t stream) {
  using namespace simt;
  auto kernel = flash_attention_kernel<T, D, DV, CARRY, CARRY>;
  constexpr int smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  dim3 grid((Sq + BR - 1) / BR, B * Hq);
  kernel<<<grid, attn::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), acc, m, l, Hq, Hq / G, Sq, Skv, strides, scale, causal != 0, q_off,
      k_off, valid_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV, bool CARRY>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* acc, float* m,
              float* l, int B, int Hq, int G, int Sq, int Skv, const long long* st, float scale,
              int causal, int q_off, int k_off, int valid_len, cudaStream_t stream) {
  using namespace tc;
  KvMaps maps;
  if (!cached_kv(&maps.k, k, B, G, Skv, D, st[3], st[4], st[5], KT) ||
      !cached_kv(&maps.v, v, B, G, Skv, DV, st[6], st[7], st[8], KT))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel_wgmma<D, DV, CARRY, CARRY>;
  constexpr int smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * Hq, (Sq + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(maps, static_cast<const bf16*>(q), st[0], st[1], st[2],
                                          static_cast<bf16*>(out), acc, m, l, Hq, Hq / G, Sq, Skv,
                                          scale, causal != 0, q_off, k_off, valid_len);
  return static_cast<int>(cudaGetLastError());
}

// The (D, Dv) instances, each in both forms: (64, 64), (128, 128), (112,
// 112) (zamba2's shared attention) and (96, 64) (MLA).
template <bool CARRY>
int dispatch(const void* q, const void* k, const void* v, void* out, float* acc, float* m,
             float* l, int dtype, int B, int Hq, int G, int Sq, int Skv, int D, int Dv,
             const long long* st, float scale, int causal, int q_off, int k_off, int valid_len,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DD, DDV)                                                                    \
  if (D == DD && Dv == DDV)                                                                   \
    return dtype == 0 ? launch<float, DD, DDV, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq,  \
                                                      Skv, st, scale, causal, q_off, k_off,   \
                                                      valid_len, s)                           \
                      : launch_tc<DD, DDV, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq, Skv, \
                                                  st, scale, causal, q_off, k_off, valid_len, \
                                                  s);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  FA_LAUNCH(128, 128)
  FA_LAUNCH(64, 64)
  FA_LAUNCH(112, 112)
  FA_LAUNCH(96, 64)
#undef FA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (B, Hq, Sq, Dv) contiguous = attention of q (B, Hq, Sq, D) over k
// (B, G, Skv, D) and v (B, G, Skv, Dv), each given by its batch/head/sequence
// strides in elements (st = q's 3, k's 3, v's 3; head dim contiguous, rows
// 16-byte aligned).  dtype 0 = float32, 1 = bfloat16; (D, Dv) = (64, 64),
// (128, 128), (96, 64) or (112, 112).  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                        int Hq, int G, int Sq, int Skv, int D, int Dv, const long long* strides,
                        float scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, out, nullptr, nullptr, nullptr, dtype, B, Hq, G, Sq, Skv, D, Dv,
                         strides, scale, causal, 0, 0, INT_MAX, stream);
}

// One ring step: the state acc (B, Hq, Sq, Dv), m and l (B, Hq, Sq),
// float32 contiguous, is updated in place by the attention of q (global
// rows q_off + i) over k, v (global keys k_off + j; keys at or past
// valid_len masked).  Operands and (D, Dv) as for flash_attention_fwd.
// Returns a cudaError_t.
int flash_attention_carry_fwd(const void* q, const void* k, const void* v, float* acc, float* m,
                              float* l, int dtype, int B, int Hq, int G, int Sq, int Skv, int D,
                              int Dv, const long long* strides, float scale, int causal,
                              int q_off, int k_off, int valid_len, void* stream) {
  return dispatch<true>(q, k, v, nullptr, acc, m, l, dtype, B, Hq, G, Sq, Skv, D, Dv, strides,
                        scale, causal, q_off, k_off, valid_len, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
