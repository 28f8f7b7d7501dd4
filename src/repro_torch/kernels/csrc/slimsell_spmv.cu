// SlimSell semiring SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/slimsell_spmv.py:_spmv_kernel
// (wrapper slimsell_spmv_pallas) in its implicit-edge-value mode.
//
// y[v] = add over the slots of v's chunk row of edge(x[col]), for the
// tiles of the row's chunk that the SlimWork mask keeps.
//
// What bounds it: bytes. Each slot costs a 4-byte cols read and a 4-byte
// gather of x[col] for one add, far below the float32 rate of an H100 SXM
// (67 TFLOP/s, NVIDIA data sheet); the least time is (the cols of each
// chunk up to its length cl + x + y) over its 3.35 TB/s of HBM bandwidth
// (the same sheet). The gathers are irregular, so the x reads are served
// at sector (32-byte) granularity from L2 rather than at full HBM rate.
//
// Design. The Pallas kernel walks tiles in a sequential grid and carries a
// chunk's partial sum in its output block across grid steps. Blocks on the
// GPU run in no order, so here one thread block owns one chunk and loops
// over the chunk's contiguous tiles tile_ptr[c]:tile_ptr[c+1] (SlimChunk
// accumulation in registers, no atomics, deterministic order). Warp r of
// the block owns chunk row r: its lanes read consecutive column slots, so
// each cols row is one coalesced 512-byte read, and a shuffle reduction
// folds the 32 lanes at the end. A tile whose mask bit is 0 is skipped
// before any of its cols are loaded (SlimWork); a chunk with no kept tile
// writes the semiring zero. The slots of a chunk past its length cl[c] are
// padding, so the block stops there: the last tile is read only up to cl,
// and a tile wholly past it is not read. Each vertex owns exactly one
// chunk row, so the result is written straight to y[row_vertex] (no
// chunk-row epilogue).
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles.
#include "semiring.cuh"

namespace {

template <int SR>
__global__ void spmv_kernel(const int* __restrict__ cols,
                            const int* __restrict__ tile_ptr,
                            const int* __restrict__ row_vertex,
                            const int* __restrict__ cl,
                            const bool* __restrict__ tile_mask,
                            const typename Semiring<SR>::T* __restrict__ x,
                            typename Semiring<SR>::T* __restrict__ y,
                            int C, int L) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const int chunk = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T acc = S::zero();
  const int t_begin = tile_ptr[chunk];
  const int t_end = tile_ptr[chunk + 1];
  const int len = cl[chunk];
  for (int t = t_begin; t < t_end; ++t) {
    const int lim = min(L, len - (t - t_begin) * L);  // slots before cl
    if (lim <= 0) break;  // this tile and the rest are padding
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    const int* row = cols + (static_cast<size_t>(t) * C + r) * L;
#pragma unroll 4
    for (int l = lane; l < lim; l += 32) {
      const int c = __ldg(row + l);
      if (c >= 0) acc = S::add(acc, S::edge(__ldg(x + c)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = S::add(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) {
    const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
    if (v >= 0) y[v] = acc;
  }
}

struct Launch {
  const int* cols;
  const int* tile_ptr;
  const int* row_vertex;
  const int* cl;
  const bool* tile_mask;
  const void* x;
  void* y;
  int n_chunks, C, L;
  cudaStream_t stream;

  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    spmv_kernel<SR><<<n_chunks, 32 * C, 0, stream>>>(
        cols, tile_ptr, row_vertex, cl, tile_mask, static_cast<const T*>(x),
        static_cast<T*>(y), C, L);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `cl` holds each chunk's length: no slot at or past it may hold
// an edge. Needs 1 <= C <= 32. Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int slimsell_spmv(int sr_code, const void* cols,
                             const void* tile_ptr, const void* row_vertex,
                             const void* cl, const void* tile_mask,
                             const void* x, void* y,
                             int n_chunks, int C, int L, void* stream) {
  if (C < 1 || C > 32 || L < 1 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  Launch launch{static_cast<const int*>(cols),
                static_cast<const int*>(tile_ptr),
                static_cast<const int*>(row_vertex),
                static_cast<const int*>(cl),
                static_cast<const bool*>(tile_mask), x, y, n_chunks, C, L,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, launch));
}

extern "C" const char* slimsell_spmv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
