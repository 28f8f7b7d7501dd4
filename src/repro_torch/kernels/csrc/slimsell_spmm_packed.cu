// SlimSell-B packed-plane SpMM for Hopper (sm_90a): the sweep of the
// bit-packed multi-source BFS, 32 roots per word.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_packed.py:
// _spmm_packed_kernel (wrapper slimsell_spmm_packed_pallas).
//
// Y[v, w] = OR over the slots of v's chunk row of X[col, w], for the tiles
// of the row's chunk that the SlimWork mask keeps and the Wb = ceil(B/32)
// word planes w. X and Y are row-major [n, Wb] (32-bit patterns in int32
// storage, read here as unsigned). The implicit edge value is the all-ones
// word, whose AND is a no-op, so nothing is multiplied in.
//
// What bounds it: bytes. Each slot costs a 4-byte cols read and a gather of
// 4 * Wb bytes of X (8 bytes at B = 64), for Wb ORs; the least time is (the
// cols of each chunk up to its length cl + the layout indices + X + Y) over
// an H100 SXM's 3.35 TB/s of HBM bandwidth (NVIDIA data sheet). At B = 64
// and n = 2^20, X is 8 MB and stays in the 50 MB L2, where the lane SpMM's
// float X of 256 MB did not, and a slot gathers 8 bytes instead of 256.
//
// Design. The lane SpMM gives each thread one (row, batch column); at
// Wb = 2 words a warp over the word axis would leave 30 of its 32 lanes
// idle. So here, as in the packed SpMV, one thread block owns one chunk
// and loops over its contiguous tiles tile_ptr[c]:tile_ptr[c+1], warp r
// owns chunk row r, and the lanes spread over the row's L slots (one
// coalesced cols row per tile). Each lane ORs the gathered words of its
// slots into WORDS registers, and __reduce_or_sync folds the warp once
// per word at the end; lane j writes word j of Y[row_vertex]. A batch wider
// than WORDS words takes further blocks along grid y. A tile whose mask
// bit is 0 is skipped before its cols are loaded (SlimWork), and the block
// stops at the chunk's length cl[c]. Each vertex owns exactly one chunk
// row, so every row of Y is written once (zero when no kept tile hits):
// no chunk-row epilogue, no atomics, no shared memory, no barrier. Words
// are ORs of X words, so X's zero tail bits stay zero in Y.
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles.
#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 4;  // word planes one block covers (128 roots)

__global__ void spmm_packed_kernel(const int* __restrict__ cols,
                                   const int* __restrict__ tile_ptr,
                                   const int* __restrict__ row_vertex,
                                   const int* __restrict__ cl,
                                   const bool* __restrict__ tile_mask,
                                   const unsigned* __restrict__ X,
                                   unsigned* __restrict__ Y, int C, int L,
                                   int Wb) {
  const int chunk = blockIdx.x;
  const int w0 = blockIdx.y * WORDS;
  const int nw = min(WORDS, Wb - w0);
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned acc[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS; ++j) acc[j] = 0u;
  const int t_begin = tile_ptr[chunk];
  const int t_end = tile_ptr[chunk + 1];
  const int len = cl[chunk];
  for (int t = t_begin; t < t_end; ++t) {
    const int lim = min(L, len - (t - t_begin) * L);  // slots before cl
    if (lim <= 0) break;  // this tile and the rest are padding
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    const int* row = cols + (static_cast<size_t>(t) * C + r) * L;
#pragma unroll 2
    for (int l = lane; l < lim; l += 32) {
      const int c = __ldg(row + l);
      if (c >= 0) {
        const unsigned* xr = X + static_cast<size_t>(c) * Wb + w0;
#pragma unroll
        for (int j = 0; j < WORDS; ++j)
          if (j < nw) acc[j] |= __ldg(xr + j);
      }
    }
  }
  const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    const unsigned word = __reduce_or_sync(0xffffffffu, acc[j]);  // all lanes
    if (lane == j && j < nw && v >= 0)
      Y[static_cast<size_t>(v) * Wb + w0 + j] = word;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `cl` holds each chunk's length: no slot at or past it may hold
// an edge. X and Y are [n, Wb] words with Wb >= 1, and every vertex must
// own exactly one chunk row (each row of Y is written once). Needs
// 1 <= C <= 32. Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.
extern "C" int slimsell_spmm_packed(const void* cols, const void* tile_ptr,
                                    const void* row_vertex, const void* cl,
                                    const void* tile_mask, const void* X,
                                    void* Y, int n_chunks, int C, int L,
                                    int Wb, void* stream) {
  if (C < 1 || C > 32 || L < 1 || Wb < 1 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(n_chunks, (Wb + WORDS - 1) / WORDS);
  spmm_packed_kernel<<<grid, 32 * C, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const int*>(tile_ptr),
      static_cast<const int*>(row_vertex), static_cast<const int*>(cl),
      static_cast<const bool*>(tile_mask), static_cast<const unsigned*>(X),
      static_cast<unsigned*>(Y), C, L, Wb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slimsell_spmm_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
