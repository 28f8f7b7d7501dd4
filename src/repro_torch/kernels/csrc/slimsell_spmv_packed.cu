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
// stay in L1 and L2, where the lane SpMV's come from a 4 MB x at L2's
// sector rate; the cols stream is the larger cost.
//
// Design: the SpMV's (csrc/slimsell_spmv.cu), over the SpMV's own work
// list (kernels/ops.py, spmv_work, kept on the layout) and with its row
// walk (row_walk.cuh): each item is one piece of a chunk (at most 1024
// slots a row), a row gets 1 to 32 lanes by its width class and a warp
// takes 32 / LANES rows of a class, so short rows share a warp and no
// block holds a whole chunk. A lane takes 8 slots a step (two 16-byte
// loads of cols), gathers the 8 words x[col >> 5] and ORs each shifted
// down to its slot's bit; the LANES lanes of a row OR their bits by
// shuffles. No fold and no scratch: OR is commutative and idempotent, so
// every piece whose row hits sets bit (v & 31) of y[v >> 5] with atomicOr,
// v = row_vertex, into the y the wrapper hands in zeroed, in any block
// order, the same bits every call. Only real vertices set bits, so the
// tail bits of the last word stay zero. SlimWork: a tile whose mask bit is
// 0 is skipped before its cols are loaded; only slots below cl are read.
#include "row_walk.cuh"

namespace {

using row_walk::Classes;
using row_walk::kFull;
using row_walk::kGroup;
using row_walk::kWarps;

// Rows of one width class: LANES lanes a row, 32 / LANES rows a warp.
template <bool VEC, int LANES>
__device__ __forceinline__ void sweep_rows(
    const int* __restrict__ cols, const int4* __restrict__ items, int n_items,
    int warp, const int* __restrict__ row_vertex,
    const bool* __restrict__ tile_mask, const unsigned* __restrict__ x,
    unsigned* __restrict__ y, int C, int L) {
  const row_walk::Row row = row_walk::row_of<LANES>(items, n_items, warp, C);
  unsigned hit = 0u;  // bit 0: the OR of the row's gathered bits
  int v = -1;
  if (row.live) {
    v = row_vertex[static_cast<size_t>(row.it.x) * C + row.r];
    row_walk::walk_row<VEC, LANES>(
        cols, tile_mask, row, C, L,
        [&](const int (&c)[kGroup], size_t, bool) {
          unsigned got[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            got[j] = c[j] >= 0 ? __ldg(x + (c[j] >> 5)) >> (c[j] & 31) : 0u;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) hit |= got[j];
        });
  }
  // the LANES lanes of a row, ORed
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    hit |= __shfl_xor_sync(kFull, hit, off);
  if (row.live && row.lg == 0 && v >= 0 && (hit & 1u))
    atomicOr(y + (v >> 5), 1u << (v & 31));
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    spmv_packed_kernel(const int* __restrict__ cols,
                       const int4* __restrict__ items,
                       const int* __restrict__ row_vertex,
                       const bool* __restrict__ tile_mask,
                       const unsigned* __restrict__ x,
                       unsigned* __restrict__ y, int C, int L, Classes cls) {
  row_walk::for_warp(cls, items, [&](auto lanes, const int4* it, int n,
                                     int w) {
    sweep_rows<VEC, decltype(lanes)::value>(cols, it, n, w, row_vertex,
                                            tile_mask, x, y, C, L);
  });
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `items` int32 [n_items, 4] lists (chunk, first tile, slots of
// its rows below the chunk's length cl, partial slot or -1, unused here)
// for every piece of every chunk, sorted by width class; `class_items` is
// a HOST array of the items of each of the 6 classes (lanes a row 1, 2,
// ..., 32). `y` must hold ceil(n/32) zeroed words. Needs 1 <= C <= 32.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int slimsell_spmv_packed(const void* cols, const void* row_vertex,
                                    const void* tile_mask, const void* items,
                                    const void* class_items, const void* x,
                                    void* y, int C, int L, void* stream) {
  Classes cls;
  if (C < 1 || C > 32 || L < 1 ||
      !row_walk::make_classes(static_cast<const int*>(class_items), C, cls))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cls.warp0[row_walk::kClasses] == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(cols);
  const auto* it = static_cast<const int4*>(items);
  const auto* rv = static_cast<const int*>(row_vertex);
  const auto* m = static_cast<const bool*>(tile_mask);
  const auto* xw = static_cast<const unsigned*>(x);
  auto* yw = static_cast<unsigned*>(y);
  if (L % 4 == 0 && row_walk::aligned16(cols))
    spmv_packed_kernel<true><<<row_walk::blocks(cls), 32 * kWarps, 0, s>>>(
        c, it, rv, m, xw, yw, C, L, cls);
  else
    spmv_packed_kernel<false><<<row_walk::blocks(cls), 32 * kWarps, 0, s>>>(
        c, it, rv, m, xw, yw, C, L, cls);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slimsell_spmv_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
