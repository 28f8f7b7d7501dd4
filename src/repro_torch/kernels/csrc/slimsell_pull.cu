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
// Design: the SpMV's (csrc/slimsell_spmv.cu), over the SpMV's own work
// list (kernels/ops.py, spmv_work, kept on the layout), with an exit per
// tile.
// - SlimChunk pieces. Each item of the list is one piece of a chunk (at
//   most 1024 slots a row). A row of an item gets the lanes of its width
//   class, and a warp takes 32 / LANES rows of a class (row_walk.cuh), so
//   short rows share a warp and no block holds a whole chunk. A row that
//   is not pending (nf[row_vertex] false, or row_vertex -1) reads no cols
//   and writes the semiring zero. Warps are independent: no shared memory,
//   no block barrier.
// - The exit is per tile. A tile of L slots takes LT lanes, the least
//   power of two whose 8 slots a lane cover L, at most the row's LANES; a
//   step of the row takes its next LANES / LT tiles side by side (the two
//   halves of a 32-lane row at L = 128, a lane a tile at L = 1). Each
//   tile's LT lanes reduce its slots in a fixed shuffle tree; the first
//   tile of the step, in tile order, whose value is not the semiring zero
//   is the row's hit (a ballot over the tiles' first lanes), and the row
//   reads no more cols. No two tiles' values are ever added. The warp walks
//   the steps of its rows in step and leaves when none is pending
//   (__any_sync).
// - The first hit across pieces. A piece does not know of an earlier
//   piece's hit, so each piece writes its own first hit (zero if none): a
//   chunk of one piece writes y[row_vertex] itself, the pieces of a split
//   chunk write a scratch [slots, C], and a second launch in the same entry
//   takes, for each row, the FIRST piece in piece order whose value is not
//   zero. That is not the semiring add: under real and sel-max, an add or
//   max of two pieces' hits is a value the plain version never gives. A
//   later piece still reads its tiles after an earlier piece hit: that is
//   the price of running pieces side by side (PERF.md §6 counts those
//   slots).
// - SlimWork: a tile whose mask bit is 0 is skipped before it is loaded
//   (it gives zero, as a tile that does not hit). Only slots below cl are
//   read, cols with the streaming hint; a padding slot (cols -1) below it
//   contributes the semiring zero.
#include "row_walk.cuh"
#include "semiring.cuh"

namespace {

using row_walk::Classes;
using row_walk::kFull;
using row_walk::kGroup;
using row_walk::kWarps;

// Rows of one width class: LANES lanes a row, LT lanes a tile.
template <int SR, bool VEC, int LANES>
__device__ __forceinline__ void pull_rows(
    const int* __restrict__ cols, const int4* __restrict__ items,
    int n_items, int warp, const int* __restrict__ row_vertex,
    const bool* __restrict__ tile_mask, const bool* __restrict__ nf,
    const typename Semiring<SR>::T* __restrict__ x,
    typename Semiring<SR>::T* __restrict__ y,
    typename Semiring<SR>::T* __restrict__ partial, int C, int L, int LT) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const row_walk::Row row = row_walk::row_of<LANES>(items, n_items, warp, C);
  const int lane = threadIdx.x & 31;
  const int base = lane - row.lg;      // the row's first lane
  const int tiles = LANES / LT;        // tiles a step
  const int sub = row.lg / LT;         // this lane's tile of the step
  const int q = row.lg % LT;           // its rank among the tile's lanes
  int v = -1;
  if (row.live) v = row_vertex[static_cast<size_t>(row.it.x) * C + row.r];
  bool pending = v >= 0 && nf[v];  // the same for all lanes of the row
  T val = S::zero();
  for (int done = sub * L, t = row.it.y + sub;
       __any_sync(kFull, pending && done - sub * L < row.it.z);
       done += tiles * L, t += tiles) {
    const bool busy = pending && done < row.it.z &&
                      (tile_mask == nullptr || tile_mask[t]);
    const int lim = busy ? min(L, row.it.z - done) : 0;  // slots before cl
    const size_t at = (static_cast<size_t>(t) * C + row.r) * L;
    T red = S::zero();
    for (int s = kGroup * q; s < lim; s += kGroup * LT) {
      int c[kGroup];
      row_walk::load_group<VEC>(cols, at, s, lim, c);
      T got[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        got[j] = c[j] >= 0 ? S::edge(__ldg(x + c[j])) : S::zero();
#pragma unroll
      for (int j = 0; j < kGroup; ++j) red = S::add(red, got[j]);
    }
    // each tile's value: its LT lanes' sums in a fixed tree
    for (int off = LT / 2; off > 0; off >>= 1)
      red = S::add(red, __shfl_xor_sync(kFull, red, off));
    // the row's first tile of the step that hit: the lowest of its tiles'
    // first lanes whose value is not zero
    unsigned hits = __ballot_sync(kFull, q == 0 && red != S::zero()) >> base;
    if constexpr (LANES < 32) hits &= (1u << LANES) - 1u;
    const T first = __shfl_sync(kFull, red, hits ? base + __ffs(hits) - 1 : lane);
    if (pending && hits) {  // the first hit: the row takes add(zero, red)
      val = first;
      pending = false;
    }
  }
  if (!row.live || row.lg != 0) return;
  if (row.it.w >= 0)
    partial[static_cast<size_t>(row.it.w) * C + row.r] = val;
  else if (v >= 0)
    y[v] = val;
}

template <int SR, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    pull_kernel(const int* __restrict__ cols, const int4* __restrict__ items,
                const int* __restrict__ row_vertex,
                const bool* __restrict__ tile_mask,
                const bool* __restrict__ nf,
                const typename Semiring<SR>::T* __restrict__ x,
                typename Semiring<SR>::T* __restrict__ y,
                typename Semiring<SR>::T* __restrict__ partial, int C, int L,
                int tile_lanes, Classes cls) {
  row_walk::for_warp(cls, items, [&](auto lanes, const int4* it, int n,
                                     int w) {
    constexpr int LANES = decltype(lanes)::value;
    pull_rows<SR, VEC, LANES>(cols, it, n, w, row_vertex, tile_mask, nf, x,
                              y, partial, C, L, min(tile_lanes, LANES));
  });
}

// One thread per (split chunk, row): the value of the first of the
// chunk's pieces, in piece order, that is not the semiring zero (zero if
// none). `folds` holds (chunk, first partial slot, number of slots,
// unused).
template <int SR>
__global__ void fold_kernel(const int4* __restrict__ folds, int total,
                            const int* __restrict__ row_vertex,
                            const typename Semiring<SR>::T* __restrict__ partial,
                            typename Semiring<SR>::T* __restrict__ y, int C) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int4 f = folds[i / C];
  const int r = i % C;
  const int v = row_vertex[static_cast<size_t>(f.x) * C + r];
  if (v < 0) return;
  const T* p = partial + static_cast<size_t>(f.y) * C + r;
  T hit = S::zero();
  for (int k = 0; k < f.z; ++k) {
    const T got = p[static_cast<size_t>(k) * C];
    if (got != S::zero()) {
      hit = got;
      break;
    }
  }
  y[v] = hit;
}

struct Launch {
  const int* cols;
  const int4* items;
  Classes cls;
  const int4* folds;
  int n_folds;
  const int* row_vertex;
  const bool* tile_mask;
  const bool* nf;
  const void* x;
  void* y;
  void* partial;
  int C, L;
  cudaStream_t stream;

  // the sweep, then the fold of the split chunks
  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    if (cls.warp0[row_walk::kClasses] > 0) {
      // lanes a tile: the least power of two whose 8 slots a lane cover L
      int tile_lanes = 1;
      while (tile_lanes < 32 && kGroup * tile_lanes < L) tile_lanes *= 2;
      const unsigned blocks = row_walk::blocks(cls);
      const auto* xt = static_cast<const T*>(x);
      auto* yt = static_cast<T*>(y);
      auto* pt = static_cast<T*>(partial);
      if (L % 4 == 0 && row_walk::aligned16(cols))
        pull_kernel<SR, true><<<blocks, 32 * kWarps, 0, stream>>>(
            cols, items, row_vertex, tile_mask, nf, xt, yt, pt, C, L,
            tile_lanes, cls);
      else
        pull_kernel<SR, false><<<blocks, 32 * kWarps, 0, stream>>>(
            cols, items, row_vertex, tile_mask, nf, xt, yt, pt, C, L,
            tile_lanes, cls);
    }
    if (n_folds > 0) {
      const int total = n_folds * C;
      const int threads = 256;
      fold_kernel<SR><<<(total + threads - 1) / threads, threads, 0, stream>>>(
          folds, total, row_vertex, static_cast<const T*>(partial),
          static_cast<T*>(y), C);
    }
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept); `nf` is bool[n] in vertex space. `items` int32 [n_items, 4]
// lists (chunk, first tile, slots of its rows below the chunk's length cl,
// partial slot or -1) for every piece of every chunk, sorted by width
// class; `class_items` is a HOST array of the items of each of the 6
// classes (lanes a row 1, 2, ..., 32); `folds` int32 [n_folds, 4] lists
// (chunk, first slot, number of slots, 0) for each chunk split into
// several pieces, whose slots are consecutive in piece order; `partial` is
// scratch of [slots, C] elements of x's type (null when n_folds is 0).
// Needs 1 <= C <= 32. Returns cudaGetLastError() after its launches: 0
// when they were accepted.
extern "C" int slimsell_pull(int sr_code, const void* cols,
                             const void* row_vertex, const void* tile_mask,
                             const void* nf, const void* items,
                             const void* class_items, const void* folds,
                             int n_folds, void* partial, const void* x,
                             void* y, int C, int L, void* stream) {
  Classes cls;
  // the kernels count rows (items x C) and fold rows in int
  if (C < 1 || C > 32 || L < 1 || n_folds < 0 || nf == nullptr ||
      !row_walk::make_classes(static_cast<const int*>(class_items), C, cls) ||
      static_cast<long long>(n_folds) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch launch{static_cast<const int*>(cols),
                      static_cast<const int4*>(items), cls,
                      static_cast<const int4*>(folds), n_folds,
                      static_cast<const int*>(row_vertex),
                      static_cast<const bool*>(tile_mask),
                      static_cast<const bool*>(nf), x, y, partial, C, L,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, launch));
}

extern "C" const char* slimsell_pull_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
