// SlimSell semiring SpMV for Hopper (sm_90a), in two modes.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_spmv.py:_spmv_kernel
// (wrapper slimsell_spmv_pallas):
// - implicit edge value (entry slimsell_spmv, BFS): y[v] = add over the
//   slots of v's chunk row of edge(x[col]);
// - stored weights (entry slimsell_spmv_wts, SSSP; the Pallas kernel with
//   weighted=True, _weighted_contrib): y[v] = min over the slots of
//   (wts[slot] + x[col]), min-plus over SlimSell-W;
// both over the tiles of the row's chunk that the SlimWork mask keeps.
//
// What bounds it: bytes. Each slot costs a 4-byte cols read (and a 4-byte
// wts read in the stored mode) and a 4-byte gather of x[col] for one or two
// float operations, far below the float32 rate of an H100 SXM (67 TFLOP/s,
// NVIDIA data sheet); the least time is (the cols, and wts, of each chunk
// up to its length cl + x + y) over its 3.35 TB/s of HBM bandwidth (the
// same sheet). The gathers are irregular, so the x reads are served at
// sector (32-byte) granularity from L2 rather than at full HBM rate: at
// scale 20 the 32 M gathers move about 1 GB of L2 sectors, and they hold
// most of the sweep (PERF.md §6).
//
// Design. The Pallas kernel walks tiles in a sequential grid and carries a
// chunk's partial sum in its output block across grid steps. Blocks on the
// GPU run in no order; here the work is a list built once per layout by
// the wrapper (kernels/ops.py, spmv_work), and each warp takes rows of it.
// - SlimChunk balance. Each chunk's tiles below cl are cut into pieces of
//   at most P tiles (P = 1024 // L: 1024 slots a row); an item of the list
//   is one piece (chunk, first tile, slots of its rows, partial slot). The
//   first chunks of a sigma-sorted power-law graph, hundreds of tiles long,
//   spread over many warps. A chunk of one piece writes y[row_vertex]
//   itself; the pieces of a split chunk write their rows to a scratch
//   [slots, C], and a second launch folds them in piece order and writes
//   y. No atomics, a fixed order: the result is the same bits on every
//   call.
// - No idle lanes on short rows. A lane takes 8 consecutive slots a step
//   (two 16-byte loads of cols, and of wts in lockstep, when L is a
//   multiple of 4 and the arrays are aligned), so it has eight independent
//   x gathers in flight. A row of an item gets LANES = 1, 2, 4, ..., 32
//   lanes, the least power of two whose 8 * LANES slots cover the item's
//   row length (at most 32); a warp takes 32 / LANES consecutive rows of
//   the items of one width class (the wrapper sorts the items by class),
//   across chunk boundaries, so C need not divide 32. The LANES lanes of a
//   row fold their sums by shuffles in a fixed tree.
// - A smaller floor. The old design started a 32 * C-thread block for
//   every chunk, a warp a row, most of whose warps made a few index loads
//   and one write; here a block is 8 independent warps, and a warp covers
//   up to 32 short rows (four chunks of 8 at LANES = 1): at scale 20 about
//   138 k warps where there were 1.05 M.
// - cols and wts are read once, so they are loaded with the streaming
//   hint (__ldcs) and leave the L1 cache to the x gathers, which hit it on
//   the graph's hubs.
// - SlimWork: a tile whose mask bit is 0 is skipped before any of its cols
//   or wts are loaded; an item with no kept tile gives the semiring zero,
//   written to its rows (y is not cleared beforehand). Only slots below cl
//   are read: the last group of a row takes scalar loads of the slots
//   below cl. A slot below cl may still be padding (cols -1): it
//   contributes the semiring zero, and its weight is not read (a group
//   with a pad loads the weights of its edges one by one). A padding row
//   (row_vertex -1) writes nothing.
#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClasses = 6;  // lanes a row: 1, 2, 4, 8, 16, 32
constexpr int kGroup = 8;    // slots a lane takes a step: 32 bytes of cols
constexpr int kWarps = 8;    // independent warps a block

// where each width class starts in the item list and in the grid's warps
struct Classes {
  int item0[kClasses + 1];
  int warp0[kClasses + 1];
};

struct Args {
  const int* cols;
  const float* wts;
  const int4* items;
  const int* class_items;  // host array: items of each class
  const int4* folds;
  int n_folds;
  const int* row_vertex;
  const bool* tile_mask;
  const void* x;
  void* y;
  void* partial;
  int C, L;
  cudaStream_t stream;
};

// the contribution of a slot whose column is c (>= 0) and weight w
template <int SR, bool WTS>
__device__ __forceinline__ typename Semiring<SR>::T contribution(
    const typename Semiring<SR>::T* __restrict__ x, int c, float w) {
  using S = Semiring<SR>;
  (void)w;
  if constexpr (WTS)
    return S::mul(w, __ldg(x + c));
  else
    return S::edge(__ldg(x + c));
}

// Rows of one width class: LANES lanes a row, 32 / LANES rows a warp.
// `warp` is the warp's rank within the class, `items` the class's items.
template <int SR, bool WTS, bool VEC, int LANES>
__device__ __forceinline__ void sweep_rows(
    const int* __restrict__ cols, const float* __restrict__ wts,
    const int4* __restrict__ items, int n_items, int warp,
    const int* __restrict__ row_vertex, const bool* __restrict__ tile_mask,
    const typename Semiring<SR>::T* __restrict__ x,
    typename Semiring<SR>::T* __restrict__ y,
    typename Semiring<SR>::T* __restrict__ partial, int C, int L) {
  using S = Semiring<SR>;
  using T = typename S::T;
  constexpr int R = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int lg = lane % LANES;
  const int i = warp * R + lane / LANES;  // the row within the class
  const bool live = i < n_items * C;
  T acc = S::zero();
  int r = 0, slot = -1, v = -1;
  if (live) {
    const int4 it = items[i / C];  // (chunk, first tile, slots, slot)
    r = i % C;
    slot = it.w;
    if (slot < 0) v = row_vertex[static_cast<size_t>(it.x) * C + r];
    int t = it.y;
    for (int done = 0; done < it.z; done += L, ++t) {
      if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
      const int lim = min(L, it.z - done);                  // slots before cl
      const size_t row = (static_cast<size_t>(t) * C + r) * L;
      for (int s = kGroup * lg; s < lim; s += kGroup * LANES) {
        int c[kGroup];
        float w[kGroup] = {};
        const bool whole = VEC && s + kGroup <= lim;
        if (whole) {
#pragma unroll
          for (int q = 0; q < kGroup / 4; ++q) {
            const int4 v4 =
                __ldcs(reinterpret_cast<const int4*>(cols + row + s) + q);
            c[4 * q] = v4.x;
            c[4 * q + 1] = v4.y;
            c[4 * q + 2] = v4.z;
            c[4 * q + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            c[j] = s + j < lim ? __ldcs(cols + row + s + j) : -1;
        }
        if constexpr (WTS) {
          int all = 0;  // sign bit set if any slot of the group is padding
#pragma unroll
          for (int j = 0; j < kGroup; ++j) all |= c[j];
          if (whole && all >= 0) {
#pragma unroll
            for (int q = 0; q < kGroup / 4; ++q) {
              const float4 v4 =
                  __ldcs(reinterpret_cast<const float4*>(wts + row + s) + q);
              w[4 * q] = v4.x;
              w[4 * q + 1] = v4.y;
              w[4 * q + 2] = v4.z;
              w[4 * q + 3] = v4.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              w[j] = c[j] >= 0 ? __ldcs(wts + row + s + j) : 0.0f;
          }
        }
        T got[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          got[j] = c[j] >= 0 ? contribution<SR, WTS>(x, c[j], w[j]) : S::zero();
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc = S::add(acc, got[j]);
      }
    }
  }
  // the LANES sums of a row, folded in a fixed tree
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc = S::add(acc, __shfl_xor_sync(kFull, acc, off));
  if (!live || lg != 0) return;
  if (slot >= 0)
    partial[static_cast<size_t>(slot) * C + r] = acc;
  else if (v >= 0)
    y[v] = acc;
}

template <int SR, bool WTS, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    spmv_kernel(const int* __restrict__ cols, const float* __restrict__ wts,
                const int4* __restrict__ items,
                const int* __restrict__ row_vertex,
                const bool* __restrict__ tile_mask,
                const typename Semiring<SR>::T* __restrict__ x,
                typename Semiring<SR>::T* __restrict__ y,
                typename Semiring<SR>::T* __restrict__ partial, int C, int L,
                Classes cls) {
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
#define SPMV_CLASS(K)                                                     \
  case K:                                                                 \
    sweep_rows<SR, WTS, VEC, 1 << K>(cols, wts, it, n, w, row_vertex,     \
                                     tile_mask, x, y, partial, C, L);     \
    break;
  switch (k) {
    SPMV_CLASS(0)
    SPMV_CLASS(1)
    SPMV_CLASS(2)
    SPMV_CLASS(3)
    SPMV_CLASS(4)
    SPMV_CLASS(5)
  }
#undef SPMV_CLASS
}

// One thread per (split chunk, row): the partial rows of the chunk's
// pieces, added in piece order. `folds` holds (chunk, first partial slot,
// number of slots, unused).
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
  T acc = p[0];
  for (int k = 1; k < f.z; ++k) acc = S::add(acc, p[static_cast<size_t>(k) * C]);
  y[v] = acc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the sweep, then the fold of the split chunks
template <int SR, bool WTS>
cudaError_t launch(const Args& a) {
  using T = typename Semiring<SR>::T;
  Classes cls;
  long long item = 0, warp = 0;
  for (int k = 0; k < kClasses; ++k) {
    cls.item0[k] = static_cast<int>(item);
    cls.warp0[k] = static_cast<int>(warp);
    const int rows_a_warp = 32 >> k;
    warp += (static_cast<long long>(a.class_items[k]) * a.C + rows_a_warp - 1) /
            rows_a_warp;
    item += a.class_items[k];
  }
  cls.item0[kClasses] = static_cast<int>(item);
  cls.warp0[kClasses] = static_cast<int>(warp);
  if (warp > 0) {
    const unsigned blocks = static_cast<unsigned>((warp + kWarps - 1) / kWarps);
    const bool vec = a.L % 4 == 0 && aligned16(a.cols) &&
                     (!WTS || aligned16(a.wts));
    const auto* x = static_cast<const T*>(a.x);
    auto* y = static_cast<T*>(a.y);
    auto* partial = static_cast<T*>(a.partial);
    if (vec)
      spmv_kernel<SR, WTS, true><<<blocks, 32 * kWarps, 0, a.stream>>>(
          a.cols, a.wts, a.items, a.row_vertex, a.tile_mask, x, y, partial,
          a.C, a.L, cls);
    else
      spmv_kernel<SR, WTS, false><<<blocks, 32 * kWarps, 0, a.stream>>>(
          a.cols, a.wts, a.items, a.row_vertex, a.tile_mask, x, y, partial,
          a.C, a.L, cls);
  }
  if (a.n_folds > 0) {
    const int total = a.n_folds * a.C;
    const int threads = 256;
    fold_kernel<SR><<<(total + threads - 1) / threads, threads, 0, a.stream>>>(
        a.folds, total, a.row_vertex, static_cast<const T*>(a.partial),
        static_cast<T*>(a.y), a.C);
  }
  return cudaGetLastError();
}

struct Implicit {
  const Args& a;
  template <int SR> void operator()() const { launch<SR, false>(a); }
};

// Refused before any launch, by both entries alike. The kernels count rows
// (items x C, and so warps) and fold rows in int.
bool bad_args(const int* class_items, int n_folds, int C, int L) {
  if (class_items == nullptr || C < 1 || C > 32 || L < 1 || n_folds < 0)
    return true;
  long long items = 0;
  for (int k = 0; k < kClasses; ++k) {
    if (class_items[k] < 0) return true;
    items += class_items[k];
  }
  return items * C > 0x7fffffffLL ||
         static_cast<long long>(n_folds) * C > 0x7fffffffLL;
}

}  // namespace

// Plain C entry points, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `items` int32 [n_items, 4] lists (chunk, first tile, slots of
// its rows below the chunk's length cl, partial slot or -1) for every piece
// of every chunk, sorted by width class; `class_items` is a HOST array of
// the items of each of the 6 classes (lanes a row 1, 2, ..., 32); `folds`
// int32 [n_folds, 4] lists (chunk, first slot, number of slots, 0) for each
// chunk split into several pieces, whose slots are consecutive in piece
// order; `partial` is scratch of [slots, C] elements of x's type (null
// when n_folds is 0). Needs 1 <= C <= 32. Each returns cudaGetLastError()
// after its launches: 0 when they were accepted.
extern "C" int slimsell_spmv(int sr_code, const void* cols,
                             const void* row_vertex, const void* tile_mask,
                             const void* items, const void* class_items,
                             const void* folds, int n_folds, void* partial,
                             const void* x, void* y, int C, int L,
                             void* stream) {
  if (bad_args(static_cast<const int*>(class_items), n_folds, C, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(cols), nullptr,
               static_cast<const int4*>(items),
               static_cast<const int*>(class_items),
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(row_vertex),
               static_cast<const bool*>(tile_mask), x, y, partial, C, L,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, Implicit{a}));
}

// The stored-weight (min-plus) sweep: `wts` is float32, laid out as `cols`;
// x and y are float32.
extern "C" int slimsell_spmv_wts(const void* cols, const void* wts,
                                 const void* row_vertex, const void* tile_mask,
                                 const void* items, const void* class_items,
                                 const void* folds, int n_folds, void* partial,
                                 const void* x, void* y, int C, int L,
                                 void* stream) {
  if (bad_args(static_cast<const int*>(class_items), n_folds, C, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(cols), static_cast<const float*>(wts),
               static_cast<const int4*>(items),
               static_cast<const int*>(class_items),
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(row_vertex),
               static_cast<const bool*>(tile_mask), x, y, partial, C, L,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<MINPLUS, true>(a));
}

extern "C" const char* slimsell_spmv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
