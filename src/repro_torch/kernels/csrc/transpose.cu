// Batched tiled transpose for Hopper (sm_90a): (B, M, N) -> (B, N, M).
//
// Replaces the TPU kernel `transpose_tiled_pallas` (`_transpose_kernel`) of
// src/repro/kernels/relayout.py, the hand-tiled form of the relayout that a
// layout-agnostic transfer performs when its two endpoint layouts differ by
// a permutation of the last two axes.
//
// What it computes: y[b, n, m] = x[b, m, n], bit for bit.  It only moves
// data, so it dispatches on the element size (1, 2, 4 or 8 bytes) and
// never looks at the values: every dtype of that size goes through the same
// instance, and the output equals the input's bits.
//
// Bound: bytes.  Each element is read once and written once, 2 * B*M*N *
// size bytes over 3.35 TB/s (an H100 SXM); at 2048 x 2048 float32 that is
// 33.5 MB, 0.010 ms.  The design makes both sides of the copy coalesced: a
// block of 32 x 8 threads reads a 32 x 32 tile along rows of x (neighbouring
// threads on neighbouring elements), stages it in shared memory, and writes
// it along rows of y, reading the tile down a column; a row pitch of 33
// elements puts the 32 elements of a column in distinct banks (4-byte
// types).  Edge tiles are masked, so any M and N work; the TPU tile
// (256 x 256 by default) and its divisibility rule are the wrapper's.
// Batches beyond the grid's 65535 z-blocks loop inside the block.  Wider
// per-thread accesses for the 1- and 2-byte types and TMA tiles are later
// work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // thread rows; each covers TILE / ROWS rows of the tile

template <typename E>
__global__ void __launch_bounds__(TILE * ROWS)
transpose_kernel(const E* __restrict__ x, E* __restrict__ y, long long batch, int M, int N) {
  __shared__ E tile[TILE][TILE + 1];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long plane = (long long)M * N;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const E* xb = x + b * plane;
    E* yb = y + b * plane;
#pragma unroll
    for (int r = ty; r < TILE; r += ROWS) {
      const int m = m0 + r, n = n0 + tx;
      if (m < M && n < N) tile[r][tx] = xb[(long long)m * N + n];
    }
    __syncthreads();
#pragma unroll
    for (int r = ty; r < TILE; r += ROWS) {
      const int n = n0 + r, m = m0 + tx;
      if (n < N && m < M) yb[(long long)n * M + m] = tile[tx][r];
    }
    __syncthreads();  // the tile is free for the next batch
  }
}

template <typename E>
int launch(const void* x, void* y, long long batch, int M, int N, cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE,
                  static_cast<unsigned>(batch < 65535 ? batch : 65535));
  transpose_kernel<E><<<grid, dim3(TILE, ROWS), 0, stream>>>(static_cast<const E*>(x),
                                                            static_cast<E*>(y), batch, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (batch, N, M) = the transpose of x (batch, M, N), both contiguous, with
// elements of elem_size bytes (1, 2, 4 or 8).  Returns a cudaError_t.
int transpose_fwd(const void* x, void* y, int elem_size, long long batch, int M, int N,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M > 65535 * TILE) return static_cast<int>(cudaErrorInvalidValue);
  switch (elem_size) {
    case 1: return launch<uint8_t>(x, y, batch, M, N, s);
    case 2: return launch<uint16_t>(x, y, batch, M, N, s);
    case 4: return launch<uint32_t>(x, y, batch, M, N, s);
    case 8: return launch<uint64_t>(x, y, batch, M, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
