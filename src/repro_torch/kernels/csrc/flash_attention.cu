// Blockwise (flash) attention for Hopper (sm_90a): the full-sequence
// attention of the dense LM forward, and one step of the sequence-parallel
// attention ring.
//
// Replaces the TPU kernels `flash_attention_pallas` (`_flash_kernel` with
// has_carry=False, emit_state=False) and `flash_attention_carry_pallas`
// (has_carry=True, emit_state=True) of src/repro/kernels/flash_attention.py.
//
// What it computes, as the reference does: q is scaled by `scale` in
// float32; scores, exp, the running (acc, m, l) online-softmax state and
// p @ v are all float32, whatever the input type; the causal mask is
// q_pos >= k_pos with q and k both starting at 0 (top-left aligned); keys at
// or past Skv are masked; masked scores are the finite -1e30, not -inf; a
// row whose l is 0 is divided by 1; the output is acc / l, an IEEE
// division as the reference's, in q's type.  GQA: query
// head h reads KV head h / (Hq / G) in place, with no repeat.
//
// Bound: at the forward's shape (Sq = Skv = 4096, D = 128) the work is
// 4*Sq*Skv*D/2 float32 operations per head against ~4*S*D*2 bytes, so the
// kernel is bound by float32 operations (67 TFLOP/s on the CUDA cores of an
// H100 SXM), not by memory, and tensor cores would change the reference's
// float32 arithmetic.  The design keeps the FMA units fed from registers:
// a block owns 64 query rows of one head and walks the KV sequence in
// 64-key tiles (the TPU's sequential KV grid axis becomes this loop, since
// Hopper's blocks run in parallel); each of 256 threads computes a 4x4
// score micro-tile (64 FMAs per eight 16-byte shared loads) and a 4 x D/16
// slice of the output, so its rows' softmax state and output stay in its
// registers (attn_tiles.cuh).  Tiles wholly above the diagonal
// are never visited (the reference's `diag_ok`).  Shared memory holds Q, K,
// V and P tiles in float32, 119 KB at D = 128, set with
// cudaFuncSetAttribute above the 48 KB default.  wgmma and asynchronous
// copies are later work.  A ring step of 4 ranks over the same 4096 tokens
// (1024 query rows against a 1024-key block) is bound by operations too:
// 1.3e10 float32 operations against 36 MB of q, k, v and the state.
//
// The carry form (`flash_attention_carry_pallas`, one step of the
// sequence-parallel ring) is the same body with two template flags, as the
// reference's `_flash_kernel` has them: HAS_CARRY starts each row from the
// (acc, m, l) float32 state in device memory instead of (0, -1e30, 0), and
// EMIT_STATE writes that state back, unnormalized and in place (the
// reference's input_output_aliases), instead of the output.  Positions are
// global: q_off + row and k_off + key; keys at global positions >= valid_len
// are masked too; a tile is skipped when k_off + k0 >= q_off + q0 + BR (the
// reference's `diag_ok`).  Everything between the load and the store is the
// single-shot op sequence, so carry steps chained over KV chunks that start
// on 64-key tile boundaries, normalized as the ring's epilogue does
// (acc / l, l == 0 -> 1), reproduce the single-shot kernel bitwise.  The
// state update is written with explicit fmaf and the normalization with
// __fdiv_rn, so no instance of the template can contract it otherwise.

#include <climits>

#include "attn_tiles.cuh"

namespace {

using namespace attn;

constexpr int TR = 4;
constexpr int BR = 16 * TR;  // query rows per block

template <int D>
constexpr int smem_bytes() {
  return 4 * (3 * BR * (D + 4) + BR * (KT + 4));  // Q, K, V tiles + P tile
}

// Operand strides in elements: q's, k's and v's batch/head/sequence strides.
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T, int D, bool HAS_CARRY, bool EMIT_STATE>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, float* acc_st, float* m_st, float* l_st, int Hq,
                       int group, int Sq, int Skv, Strides st, float scale, bool causal,
                       int q_off, int k_off, int valid_len) {
  constexpr int DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BR * (D + 4);
  float* Vs = Ks + KT * (D + 4);
  float* Ps = Vs + KT * (D + 4);

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
      for (int e = 0; e < DPT; ++e) o[i][e] = acc_st[row * D + out_col(e, tx)];
    } else {
      m[i] = NEG_INF, l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) o[i][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kp + k0 * st.ks, st.ks, KT, Skv - k0, 1.f, tid);
    load_tile<T, D>(Vs, vp + k0 * st.vs, st.vs, KT, Skv - k0, 1.f, tid);
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
    pv_tile<D, TR>(o, Ps, KT + 4, Vs, KT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty * TR + i;
    if (r >= Sq) continue;
    const long long row = (long long)bh * Sq + r;
    if (EMIT_STATE) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc_st[row * D + out_col(e, tx)] = o[i][e];
      if (tx == 0) m_st[row] = m[i], l_st[row] = l[i];
    } else {
      const float li = l[i] == 0.f ? 1.f : l[i];  // guard fully masked rows
      T* dst = out + row * D;
#pragma unroll
      for (int e = 0; e < DPT; ++e) dst[out_col(e, tx)] = from_f32<T>(__fdiv_rn(o[i][e], li));
    }
  }
}

template <typename T, int D, bool CARRY>
int launch(const void* q, const void* k, const void* v, void* out, float* acc, float* m, float* l,
           int B, int Hq, int G, int Sq, int Skv, const long long* st, float scale, int causal,
           int q_off, int k_off, int valid_len, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, CARRY, CARRY>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides strides{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  dim3 grid((Sq + BR - 1) / BR, B * Hq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), acc, m, l, Hq, Hq / G, Sq, Skv, strides, scale, causal != 0, q_off,
      k_off, valid_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool CARRY>
int dispatch(const void* q, const void* k, const void* v, void* out, float* acc, float* m,
             float* l, int dtype, int B, int Hq, int G, int Sq, int Skv, int D,
             const long long* st, float scale, int causal, int q_off, int k_off, int valid_len,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch<float, 128, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq, Skv, st, scale,
                                     causal, q_off, k_off, valid_len, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq, Skv, st, scale,
                                    causal, q_off, k_off, valid_len, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq, Skv, st,
                                             scale, causal, q_off, k_off, valid_len, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, CARRY>(q, k, v, out, acc, m, l, B, Hq, G, Sq, Skv, st,
                                            scale, causal, q_off, k_off, valid_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (B, Hq, Sq, D) contiguous = attention of q (B, Hq, Sq, D) over k, v
// (B, G, Skv, D), each given by its batch/head/sequence strides in elements
// (st = q's 3, k's 3, v's 3; head dim contiguous, rows 16-byte aligned).
// dtype 0 = float32, 1 = bfloat16; D = 64 or 128.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                        int Hq, int G, int Sq, int Skv, int D, const long long* strides,
                        float scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, out, nullptr, nullptr, nullptr, dtype, B, Hq, G, Sq, Skv, D,
                         strides, scale, causal, 0, 0, INT_MAX, stream);
}

// One ring step: the state acc (B, Hq, Sq, D), m and l (B, Hq, Sq), float32
// contiguous, is updated in place by the attention of q (global rows
// q_off + i) over k, v (global keys k_off + j; keys at or past valid_len
// masked).  Operands as for flash_attention_fwd.  Returns a cudaError_t.
int flash_attention_carry_fwd(const void* q, const void* k, const void* v, float* acc, float* m,
                              float* l, int dtype, int B, int Hq, int G, int Sq, int Skv, int D,
                              const long long* strides, float scale, int causal, int q_off,
                              int k_off, int valid_len, void* stream) {
  return dispatch<true>(q, k, v, nullptr, acc, m, l, dtype, B, Hq, G, Sq, Skv, D, strides, scale,
                        causal, q_off, k_off, valid_len, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
