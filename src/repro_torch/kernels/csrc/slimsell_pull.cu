// SlimSell bottom-up (pull) semiring sweep for Hopper (sm_90a): the pull
// iterations of direction-optimizing BFS.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_pull.py:_pull_kernel
// (wrapper slimsell_pull_pallas).
//
// For each vertex v with nf[v] set: y[v] is the reduction over L of
// edge(x[col]) for the FIRST kept tile of v's chunk, in tile order, whose
// reduction is not the semiring zero; y[v] is zero when nf[v] is false or
// no kept tile hits. This is the Pallas kernel's per-row early exit stated
// exactly: a row is pending while nf is set and its value is still zero,
// and only a pending row takes add(zero, red) = red.
//
// What bounds it: bytes. A slot costs a 4-byte cols read and a 4-byte
// gather of x[col] for one add. The least time is (the cols a pending row
// reads through its first hit tile, capped at the chunk length cl, + x +
// nf + y) over an H100 SXM's 3.35 TB/s of HBM (NVIDIA data sheet); the
// early exit makes those bytes depend on the data, so the bound is worked
// out from the hits of each run.
//
// Design. As in the push SpMV, one thread block owns one chunk and walks
// its contiguous tiles tile_ptr[c]:tile_ptr[c+1] up to cl[c] (the Pallas
// kernel's sequential grid and first-visit init become a loop inside the
// block), skips a tile whose SlimWork mask bit is 0 before loading it, and
// writes y[row_vertex] directly. Warp r owns chunk row r and reads nf once:
// a row that is not pending writes zero. For each kept tile a pending
// warp's lanes reduce the row's slots and a shuffle reduction gives the
// tile's value at once (once per tile, not once at the end as in push);
// the first value that is not zero is the row's, and the warp reads no
// more of the chunk. The whole block stops at the first tile where no
// warp is pending (__syncthreads_or), so a chunk whose rows have all hit
// loads none of its remaining tiles. Every thread takes the same branches
// up to that barrier: the tile bounds and the mask bit are the block's.
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles; the early exit
// shortens that tail only where every row of a long chunk hits early.
#include "semiring.cuh"

namespace {

template <int SR>
__global__ void pull_kernel(const int* __restrict__ cols,
                            const int* __restrict__ tile_ptr,
                            const int* __restrict__ row_vertex,
                            const int* __restrict__ cl,
                            const bool* __restrict__ tile_mask,
                            const bool* __restrict__ nf,
                            const typename Semiring<SR>::T* __restrict__ x,
                            typename Semiring<SR>::T* __restrict__ y,
                            int C, int L) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const int chunk = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
  bool pending = v >= 0 && nf[v];  // the same for all lanes of the warp
  T val = S::zero();
  const int t_begin = tile_ptr[chunk];
  const int t_end = tile_ptr[chunk + 1];
  const int len = cl[chunk];
  for (int t = t_begin; t < t_end; ++t) {
    const int lim = min(L, len - (t - t_begin) * L);  // slots before cl
    if (lim <= 0) break;  // this tile and the rest are padding
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    if (!__syncthreads_or(pending)) break;  // every row of the chunk is done
    if (!pending) continue;
    const int* row = cols + (static_cast<size_t>(t) * C + r) * L;
    T red = S::zero();
#pragma unroll 4
    for (int l = lane; l < lim; l += 32) {
      const int c = __ldg(row + l);
      if (c >= 0) red = S::add(red, S::edge(__ldg(x + c)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      red = S::add(red, __shfl_xor_sync(0xffffffffu, red, off));
    if (red != S::zero()) {  // the first hit: the row takes add(zero, red)
      val = red;
      pending = false;
    }
  }
  if (lane == 0 && v >= 0) y[v] = val;
}

struct Launch {
  const int* cols;
  const int* tile_ptr;
  const int* row_vertex;
  const int* cl;
  const bool* tile_mask;
  const bool* nf;
  const void* x;
  void* y;
  int n_chunks, C, L;
  cudaStream_t stream;

  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    pull_kernel<SR><<<n_chunks, 32 * C, 0, stream>>>(
        cols, tile_ptr, row_vertex, cl, tile_mask, nf,
        static_cast<const T*>(x), static_cast<T*>(y), C, L);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept); `nf` is bool[n] in vertex space. `cl` holds each chunk's
// length: no slot at or past it may hold an edge. Needs 1 <= C <= 32.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int slimsell_pull(int sr_code, const void* cols,
                             const void* tile_ptr, const void* row_vertex,
                             const void* cl, const void* tile_mask,
                             const void* nf, const void* x, void* y,
                             int n_chunks, int C, int L, void* stream) {
  if (C < 1 || C > 32 || L < 1 || n_chunks < 0 || nf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  Launch launch{static_cast<const int*>(cols),
                static_cast<const int*>(tile_ptr),
                static_cast<const int*>(row_vertex),
                static_cast<const int*>(cl),
                static_cast<const bool*>(tile_mask),
                static_cast<const bool*>(nf), x, y, n_chunks, C, L,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, launch));
}

extern "C" const char* slimsell_pull_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
