// SlimSell-B packed-bit SpMV for Hopper (sm_90a): the single-source sweep
// of the bit-packed boolean BFS.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_packed.py:
// _spmv_packed_kernel (wrapper slimsell_spmv_packed_pallas).
//
// y bit v = OR over the slots of v's chunk row of bit (col & 31) of
// x[col >> 5], for the tiles of the row's chunk that the SlimWork mask
// keeps. x and y are packed bitmaps of ceil(n/32) words (32-bit patterns
// in int32 storage, read here as unsigned).
//
// What bounds it: bytes. Each slot costs a 4-byte cols read and the gather
// of one 4-byte word, for a shift and an OR; the least time is (the cols of
// each chunk up to its length cl + the layout indices + x + y) over an H100
// SXM's 3.35 TB/s of HBM bandwidth (NVIDIA data sheet). The frontier is
// 32x smaller than the lane SpMV's (131 KB at n = 2^20), so its gathers
// hit L2; the cols stream is the whole cost.
//
// Design. The TPU kernel walks tiles in a sequential grid, ORs 0/1 hits
// into a chunk-row output block, and its wrapper scatters the hits to
// vertex space and packs them again. Here one thread block owns one chunk
// and loops over its contiguous tiles tile_ptr[c]:tile_ptr[c+1], as the
// lane SpMV does: warp r owns chunk row r, its lanes read consecutive
// column slots (one coalesced 512-byte cols row per tile) and OR the
// gathered words shifted down to the slot's bit. A tile whose mask bit is
// 0 is skipped before its cols are loaded (SlimWork), and the block stops
// at the chunk's length cl[c] (the slots past it are padding). At the end
// __any_sync folds the warp into the row's hit, and lane 0 sets bit
// (v & 31) of y[v >> 5] with atomicOr, v = row_vertex: OR commutes, so the
// result does not depend on the order of the blocks, and the wrapper hands
// in y zeroed. Only real vertices set bits, so the tail bits of the last
// word stay zero. No shared memory and no barrier: the warps of a block
// are independent.
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles.
#include <cuda_runtime.h>

namespace {

__global__ void spmv_packed_kernel(const int* __restrict__ cols,
                                   const int* __restrict__ tile_ptr,
                                   const int* __restrict__ row_vertex,
                                   const int* __restrict__ cl,
                                   const bool* __restrict__ tile_mask,
                                   const unsigned* __restrict__ x,
                                   unsigned* __restrict__ y, int C, int L) {
  const int chunk = blockIdx.x;
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned hit = 0u;  // bit 0 of the OR of the gathered words, shifted
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
      if (c >= 0) hit |= __ldg(x + (c >> 5)) >> (c & 31);
    }
  }
  // every lane votes before lane 0 writes
  if (__any_sync(0xffffffffu, hit & 1u) && lane == 0) {
    const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
    if (v >= 0) atomicOr(y + (v >> 5), 1u << (v & 31));
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `cl` holds each chunk's length: no slot at or past it may hold
// an edge. `y` must hold ceil(n/32) zeroed words. Needs 1 <= C <= 32.
// Returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.
extern "C" int slimsell_spmv_packed(const void* cols, const void* tile_ptr,
                                    const void* row_vertex, const void* cl,
                                    const void* tile_mask, const void* x,
                                    void* y, int n_chunks, int C, int L,
                                    void* stream) {
  if (C < 1 || C > 32 || L < 1 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  spmv_packed_kernel<<<n_chunks, 32 * C, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const int*>(tile_ptr),
      static_cast<const int*>(row_vertex), static_cast<const int*>(cl),
      static_cast<const bool*>(tile_mask), static_cast<const unsigned*>(x),
      static_cast<unsigned*>(y), C, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slimsell_spmv_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
