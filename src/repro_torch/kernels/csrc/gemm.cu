// Layout-parametric tiled GEMM for Hopper (sm_90a): the per-rank multiply of
// the distributed GEMM case study and the rotating-panel step of its SUMMA
// ring.
//
// Replaces the TPU kernels `gemm_pallas` (`_gemm_kernel`) and
// `gemm_panel_pallas` (`_panel_kernel`) of src/repro/kernels/gemm.py.
//
// What it computes (float32 throughout, FFMA, no TF32):
//   layout_gemm_kernel:        C = A @ B (+ acc)
//   layout_gemm_panel_kernel:  panel[j-block jb] += A @ B, in place
// Each operand has its own physical orientation (the C/A/B "majors" of the
// paper's Fig. 3): A is logical (i, k) and its buffer is (M, K) or, when
// A_T, (K, M); B is logical (k, j), buffer (K, N) or, when B_T, (N, K); C is
// logical (i, j), buffer (M, ldc) or, when C_T, (N.., ldc) with i
// contiguous.  A transposed operand is read straight from its buffer order
// into a logical-order shared-memory tile — no pre-transpose pass, the
// counterpart of the Pallas BlockSpec index maps.
//
// Bound: at the case study's shapes (M, N, K ~ 1.4k-2.5k and up) the work is
// 2*M*N*K float32 operations against ~4*(MK + KN + MN) bytes, so the
// kernel is bound by float32 operations (67 TFLOP/s on the CUDA cores of an
// H100 SXM), not by memory.  The tiling keeps the FMA units fed from
// registers: 128x128 output tiles, BK = 8, 256 threads each holding an 8x8
// micro-tile (two 4x4 quadrants 64 apart, so its shared-memory reads are
// 16-byte loads without bank conflicts), 16 FMAs per 16-byte shared load.
// Shared memory is double-buffered: the next K-slice is loaded from device
// memory into registers while the current one is multiplied, then stored to
// the other buffer, one barrier per slice.  Edge tiles are bounds-checked
// (zero-filled loads, guarded stores), so any M, N, K works.  wgmma, TMA and
// a deeper asynchronous pipeline are later work.
//
// The panel kernel takes the block index jb either by value or through a
// pointer to one int32 on the device (read by every block, so a ring step
// needs no host sync); jb is clamped to [0, nb) like the reference's
// dynamic_slice.  Blocks of the panel outside jb are never touched.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int LOADS = (BM * BK) / THREADS;      // 4 elements of A and of B per thread and slice
constexpr int PAD = 4;  // keeps float4 alignment, spreads the transposing stores over banks
static_assert(BM == BN, "one slice loader serves both operands' 128-long tile axis");

// Moves one operand's K-slices from device memory through registers into
// shared memory.  The operand is logical (x, k) with x the tile's 128-long
// axis (i of A, j of B).  KC: its buffer is contiguous along k (A when not
// transposed, B when transposed), element (x, k) at base[x*K + k], and a warp
// reads rows of 8 consecutive k; otherwise element (x, k) at base[k*ld + x]
// and a warp reads 128 consecutive x of one k row.  Addresses and the x
// bounds are computed once; each slice only advances the pointer.
template <bool KC>
struct SliceLoader {
  const float* p;  // this thread's slot-0 element of the current slice
  long long slot;  // offset between the thread's LOADS elements
  long long next;  // offset from one slice to the next
  int x, kk;       // tile coordinates of slot 0
  unsigned x_ok;   // bit s: slot s lies inside the matrix along x

  __device__ __forceinline__ SliceLoader(const float* base, int x0, int extent, int K, int tid) {
    constexpr int XSTEP = THREADS / BK;  // KC: rows per slot
    constexpr int KSTEP = THREADS / BM;  // !KC: k rows per slot
    x = KC ? tid / BK : tid % BM;
    kk = KC ? tid % BK : tid / BM;
    const long long ld = KC ? K : extent;
    p = KC ? base + (long long)(x0 + x) * K + kk : base + kk * ld + x0 + x;
    slot = KC ? XSTEP * ld : KSTEP * ld;
    next = KC ? BK : BK * ld;
    x_ok = 0;
#pragma unroll
    for (int s = 0; s < LOADS; ++s)
      x_ok |= (unsigned)(x0 + x + (KC ? s * XSTEP : 0) < extent) << s;
  }

  __device__ __forceinline__ int slot_x(int s) const { return KC ? x + s * (THREADS / BK) : x; }
  __device__ __forceinline__ int slot_k(int s) const { return KC ? kk : kk + s * (THREADS / BM); }

  __device__ __forceinline__ void load(int k0, int K, float (&r)[LOADS]) {
#pragma unroll
    for (int s = 0; s < LOADS; ++s)
      r[s] = ((x_ok >> s) & 1u) && k0 + slot_k(s) < K ? p[s * slot] : 0.0f;
    p += next;
  }

  __device__ __forceinline__ void store(float (*S)[BM + PAD], const float (&r)[LOADS]) const {
#pragma unroll
    for (int s = 0; s < LOADS; ++s) S[slot_k(s)][slot_x(s)] = r[s];
  }
};

template <bool A_T, bool B_T, bool C_T, bool HAS_ACC>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          const float* acc, float* c,
                                          int M, int N, int K, int ldc, long long col0) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // thread -> micro-tile: keep the output's contiguous axis across
  // neighbouring threads so the stores coalesce in either C orientation
  const int rt = C_T ? tx : ty;
  const int ct = C_T ? ty : tx;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;

  float sum[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) sum[m][n] = 0.0f;

  SliceLoader<!A_T> la(a, i0, M, K, tid);
  SliceLoader<B_T> lb(b, j0, N, K, tid);
  float ra[LOADS], rb[LOADS];
  la.load(0, K, ra);
  lb.load(0, K, rb);
  la.store(As[0], ra);
  lb.store(Bs[0], rb);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {  // the next slice's device loads are in flight during the FMAs
      la.load(k0 + BK, K, ra);
      lb.load(k0 + BK, K, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][rt * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][rt * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][ct * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][ct * 4 + BN / 2]);
      const float af[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bf[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) sum[m][n] = __fmaf_rn(af[m], bf[n], sum[m][n]);
    }
    // the other buffer was last read before the previous barrier
    if (more) {
      la.store(As[buf ^ 1], ra);
      lb.store(Bs[buf ^ 1], rb);
    }
    __syncthreads();
    buf ^= 1;
  }

  // epilogue: C = A@B (+ acc), the same order as the reference (dot, then add)
#pragma unroll
  for (int n = 0; n < TN; ++n) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + rt * 4 + (m / 4) * (BM / 2) + m % 4;
      const int j = j0 + ct * 4 + (n / 4) * (BN / 2) + n % 4;
      if (i < M && j < N) {
        const long long off = C_T ? (col0 + j) * ldc + i : (long long)i * ldc + col0 + j;
        float v = sum[m][n];
        if (HAS_ACC) v = __fadd_rn(v, acc[off]);
        c[off] = v;
      }
    }
  }
}

template <bool A_T, bool B_T, bool C_T, bool HAS_ACC>
__global__ void __launch_bounds__(THREADS, 2)  // <= 128 registers: two blocks per SM
layout_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ acc, float* __restrict__ c,
                   int M, int N, int K, int ldc) {
  gemm_tile<A_T, B_T, C_T, HAS_ACC>(a, b, acc, c, M, N, K, ldc, 0);
}

template <bool A_T, bool B_T, bool C_T>
__global__ void __launch_bounds__(THREADS, 2)  // <= 128 registers: two blocks per SM
layout_gemm_panel_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         float* panel, int M, int N, int K, int ldp, int nb,
                         const int* jb_dev, int jb_host) {
  int jb = jb_dev != nullptr ? *jb_dev : jb_host;
  jb = jb < 0 ? 0 : (jb >= nb ? nb - 1 : jb);
  // the panel is both the accumulator and the output: each element is read
  // and then written by the same thread
  gemm_tile<A_T, B_T, C_T, true>(a, b, panel, panel, M, N, K, ldp, (long long)jb * N);
}

template <bool A_T, bool B_T, bool C_T>
void launch_gemm(dim3 grid, cudaStream_t stream, const float* a, const float* b,
                 const float* acc, float* c, int M, int N, int K, int ldc) {
  if (acc != nullptr)
    layout_gemm_kernel<A_T, B_T, C_T, true><<<grid, THREADS, 0, stream>>>(a, b, acc, c, M, N, K, ldc);
  else
    layout_gemm_kernel<A_T, B_T, C_T, false><<<grid, THREADS, 0, stream>>>(a, b, acc, c, M, N, K, ldc);
}

template <bool A_T, bool B_T, bool C_T>
void launch_panel(dim3 grid, cudaStream_t stream, const float* a, const float* b,
                  float* panel, int M, int N, int K, int ldp, int nb, const int* jb_dev,
                  int jb_host) {
  layout_gemm_panel_kernel<A_T, B_T, C_T><<<grid, THREADS, 0, stream>>>(
      a, b, panel, M, N, K, ldp, nb, jb_dev, jb_host);
}

dim3 grid_for(int M, int N) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

}  // namespace

#define LAYOUT_GEMM_DISPATCH(FN, CODE, ...)              \
  switch (CODE) {                                        \
    case 0: FN<false, false, false>(__VA_ARGS__); break; \
    case 1: FN<false, false, true>(__VA_ARGS__); break;  \
    case 2: FN<false, true, false>(__VA_ARGS__); break;  \
    case 3: FN<false, true, true>(__VA_ARGS__); break;   \
    case 4: FN<true, false, false>(__VA_ARGS__); break;  \
    case 5: FN<true, false, true>(__VA_ARGS__); break;   \
    case 6: FN<true, true, false>(__VA_ARGS__); break;   \
    default: FN<true, true, true>(__VA_ARGS__); break;   \
  }

extern "C" {

// C = A @ B (+ acc).  acc may be null.  Returns the cudaError_t of the launch.
int layout_gemm_f32(const float* a, const float* b, const float* acc, float* c, int M, int N,
                    int K, int a_trans, int b_trans, int c_trans, void* stream) {
  const int code = (a_trans ? 4 : 0) | (b_trans ? 2 : 0) | (c_trans ? 1 : 0);
  const int ldc = c_trans ? M : N;
  LAYOUT_GEMM_DISPATCH(launch_gemm, code, grid_for(M, N), static_cast<cudaStream_t>(stream), a,
                       b, acc, c, M, N, K, ldc);
  return static_cast<int>(cudaGetLastError());
}

// panel[j-block jb] += A @ B in place.  The panel holds nb j-blocks of width N;
// ldp is its row length (nb*N, or M when C is j-major).  jb_dev, when not
// null, points to the block index on the device and jb_host is ignored.
int layout_gemm_panel_f32(const float* a, const float* b, float* panel, int M, int N, int K,
                          int a_trans, int b_trans, int c_trans, int ldp, int nb,
                          const int* jb_dev, int jb_host, void* stream) {
  const int code = (a_trans ? 4 : 0) | (b_trans ? 2 : 0) | (c_trans ? 1 : 0);
  LAYOUT_GEMM_DISPATCH(launch_panel, code, grid_for(M, N), static_cast<cudaStream_t>(stream), a,
                       b, panel, M, N, K, ldp, nb, jb_dev, jb_host);
  return static_cast<int>(cudaGetLastError());
}

const char* layout_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
