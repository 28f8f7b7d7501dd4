// The row walk of the sweeps that take the SpMV's work list (kernels/ops.py,
// spmv_work): the implicit and stored-weight SpMV (slimsell_spmv.cu), the
// single-source pull (slimsell_pull.cu), the packed SpMV
// (slimsell_spmv_packed.cu) and the packed SpMM (slimsell_spmm_packed.cu).
// The batched pull (slimsell_pull_mm.cu) takes the same list but walks it
// its own way, lanes over batch columns.
//
// An item of the list is one piece of a chunk: (chunk, first tile, slots of
// its rows below the chunk's length cl, partial slot or -1). Each row of an
// item gets LANES = 1, 2, 4, ..., 32 lanes, the least power of two whose 8
// slots a lane cover the item's row length (at most 32; the item's width
// class); the wrapper sorts the items by class and hands in the count of
// each. A warp takes 32 / LANES consecutive rows of one class, across chunk
// boundaries (row i of a class is chunk row i % C of its item i / C), so C
// need not divide 32; a block is kWarps independent warps. A lane takes 8
// consecutive slots of its row a step (two 16-byte loads of cols when L is
// a multiple of 4 and cols is aligned, VEC), so it has eight independent
// gathers in flight; cols are read once, with the streaming hint (__ldcs),
// leaving the L1 cache to the gathers. A tile whose SlimWork mask bit is 0
// is skipped before any of its cols are loaded, and only slots below cl are
// read: the last group of a row takes scalar loads of the slots below it.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace row_walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClasses = 6;  // lanes a row: 1, 2, 4, 8, 16, 32
constexpr int kGroup = 8;    // slots a lane takes a step: 32 bytes of cols
constexpr int kWarps = 8;    // independent warps a block

// where each width class starts in the item list and in the grid's warps
struct Classes {
  int item0[kClasses + 1];
  int warp0[kClasses + 1];
};

// Host: `cls` from the HOST array `class_items` (the items of each class).
// False when a count is negative or the rows (items x C, and so the warps)
// would not fit the int the kernels count them in.
inline bool make_classes(const int* class_items, int C, Classes& cls) {
  if (class_items == nullptr) return false;
  long long item = 0, warp = 0;
  for (int k = 0; k < kClasses; ++k) {
    if (class_items[k] < 0) return false;
    cls.item0[k] = static_cast<int>(item);
    cls.warp0[k] = static_cast<int>(warp);
    const int rows_a_warp = 32 >> k;
    warp += (static_cast<long long>(class_items[k]) * C + rows_a_warp - 1) /
            rows_a_warp;
    item += class_items[k];
  }
  if (item * C > 0x7fffffffLL) return false;
  cls.item0[kClasses] = static_cast<int>(item);
  cls.warp0[kClasses] = static_cast<int>(warp);
  return true;
}

// Host: the blocks of kWarps warps that cover every class.
inline unsigned blocks(const Classes& cls) {
  return static_cast<unsigned>((cls.warp0[kClasses] + kWarps - 1) / kWarps);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// LANES as a type, for the kernels' generic lambdas
template <int N> struct Lanes {
  static constexpr int value = N;
};

// The calling warp's width class: calls f(lanes, items, n_items, warp) with
// lanes a Lanes<LANES>, the class's items and the warp's rank within the
// class. The whole warp returns past the last class.
template <typename F>
__device__ __forceinline__ void for_warp(const Classes& cls,
                                         const int4* __restrict__ items,
                                         F&& f) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= cls.warp0[kClasses]) return;  // the whole warp
  // the class: warp0[k] <= warp < warp0[k + 1] (no indexing of cls by a
  // runtime value, which would copy it to local memory)
  int k = 0, item0 = 0, item1 = cls.item0[1], warp0 = 0;
#pragma unroll
  for (int j = 1; j < kClasses; ++j)
    if (warp >= cls.warp0[j]) {
      k = j;
      item0 = cls.item0[j];
      item1 = cls.item0[j + 1];
      warp0 = cls.warp0[j];
    }
  const int4* it = items + item0;
  const int n = item1 - item0;
  const int w = warp - warp0;
  switch (k) {
    case 0: f(Lanes<1>{}, it, n, w); break;
    case 1: f(Lanes<2>{}, it, n, w); break;
    case 2: f(Lanes<4>{}, it, n, w); break;
    case 3: f(Lanes<8>{}, it, n, w); break;
    case 4: f(Lanes<16>{}, it, n, w); break;
    case 5: f(Lanes<32>{}, it, n, w); break;
  }
}

// The lane's row of the list: `lg` its rank among the row's LANES lanes,
// `live` whether the row exists, and, when it does, its item `it` and
// chunk row `r`.
struct Row {
  int lg;
  bool live;
  int4 it;
  int r;
};

template <int LANES>
__device__ __forceinline__ Row row_of(const int4* __restrict__ items,
                                      int n_items, int warp, int C) {
  constexpr int R = 32 / LANES;
  const int lane = threadIdx.x & 31;
  Row row{lane % LANES, false, make_int4(0, 0, 0, -1), 0};
  const int i = warp * R + lane / LANES;  // the row within the class
  row.live = i < n_items * C;
  if (row.live) {
    row.it = items[i / C];  // (chunk, first tile, slots, slot)
    row.r = i % C;
  }
  return row;
}

// The cols of slots s .. s + kGroup - 1 of the tile row that starts at
// cols + at, -1 at and past `lim`. True when they came in two 16-byte
// loads (VEC and the group whole).
template <bool VEC>
__device__ __forceinline__ bool load_group(const int* __restrict__ cols,
                                           size_t at, int s, int lim,
                                           int c[kGroup]) {
  const bool whole = VEC && s + kGroup <= lim;
  if (whole) {
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const int4 v4 = __ldcs(reinterpret_cast<const int4*>(cols + at + s) + q);
      c[4 * q] = v4.x;
      c[4 * q + 1] = v4.y;
      c[4 * q + 2] = v4.z;
      c[4 * q + 3] = v4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      c[j] = s + j < lim ? __ldcs(cols + at + s + j) : -1;
  }
  return whole;
}

// A live row's walk over its item's kept tiles, one tile at a time: for
// each group of kGroup slots the lane takes, op(c, at + s, whole) with the
// group's cols c (-1 past cl), the offset of its first slot in the layout
// and whether it came whole.
template <bool VEC, int LANES, typename Op>
__device__ __forceinline__ void walk_row(const int* __restrict__ cols,
                                         const bool* __restrict__ tile_mask,
                                         const Row& row, int C, int L,
                                         Op&& op) {
  int t = row.it.y;
  for (int done = 0; done < row.it.z; done += L, ++t) {
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    const int lim = min(L, row.it.z - done);              // slots before cl
    const size_t at = (static_cast<size_t>(t) * C + row.r) * L;
    for (int s = kGroup * row.lg; s < lim; s += kGroup * LANES) {
      int c[kGroup];
      const bool whole = load_group<VEC>(cols, at, s, lim, c);
      op(c, at + s, whole);
    }
  }
}

}  // namespace row_walk
