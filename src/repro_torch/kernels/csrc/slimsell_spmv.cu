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
// The walk of a row of the list (the width classes, rows a warp, the
// 8-slot groups, the SlimWork skip and the scalar tail below cl) is
// row_walk.cuh's, shared with the single-source pull (slimsell_pull.cu)
// and the packed sweeps (slimsell_spmv_packed.cu, slimsell_spmm_packed.cu).
#include "row_walk.cuh"
#include "semiring.cuh"

namespace {

using row_walk::Classes;
using row_walk::kFull;
using row_walk::kGroup;
using row_walk::kWarps;

struct Args {
  const int* cols;
  const float* wts;
  const int4* items;
  Classes cls;
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
  const row_walk::Row row = row_walk::row_of<LANES>(items, n_items, warp, C);
  T acc = S::zero();
  int v = -1;
  if (row.live) {
    if (row.it.w < 0) v = row_vertex[static_cast<size_t>(row.it.x) * C + row.r];
    row_walk::walk_row<VEC, LANES>(
        cols, tile_mask, row, C, L,
        [&](const int (&c)[kGroup], size_t at, bool whole) {
          float w[kGroup] = {};
          if constexpr (WTS) {
            int all = 0;  // sign bit set if any slot of the group is padding
#pragma unroll
            for (int j = 0; j < kGroup; ++j) all |= c[j];
            if (whole && all >= 0) {
#pragma unroll
              for (int q = 0; q < kGroup / 4; ++q) {
                const float4 v4 =
                    __ldcs(reinterpret_cast<const float4*>(wts + at) + q);
                w[4 * q] = v4.x;
                w[4 * q + 1] = v4.y;
                w[4 * q + 2] = v4.z;
                w[4 * q + 3] = v4.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < kGroup; ++j)
                w[j] = c[j] >= 0 ? __ldcs(wts + at + j) : 0.0f;
            }
          }
          T got[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            got[j] = c[j] >= 0 ? contribution<SR, WTS>(x, c[j], w[j])
                               : S::zero();
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc = S::add(acc, got[j]);
        });
  }
  // the LANES sums of a row, folded in a fixed tree
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc = S::add(acc, __shfl_xor_sync(kFull, acc, off));
  if (!row.live || row.lg != 0) return;
  if (row.it.w >= 0)
    partial[static_cast<size_t>(row.it.w) * C + row.r] = acc;
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
  row_walk::for_warp(cls, items, [&](auto lanes, const int4* it, int n,
                                     int w) {
    sweep_rows<SR, WTS, VEC, decltype(lanes)::value>(
        cols, wts, it, n, w, row_vertex, tile_mask, x, y, partial, C, L);
  });
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

// the sweep, then the fold of the split chunks
template <int SR, bool WTS>
cudaError_t launch(const Args& a) {
  using T = typename Semiring<SR>::T;
  if (a.cls.warp0[row_walk::kClasses] > 0) {
    const unsigned blocks = row_walk::blocks(a.cls);
    const bool vec = a.L % 4 == 0 && row_walk::aligned16(a.cols) &&
                     (!WTS || row_walk::aligned16(a.wts));
    const auto* x = static_cast<const T*>(a.x);
    auto* y = static_cast<T*>(a.y);
    auto* partial = static_cast<T*>(a.partial);
    if (vec)
      spmv_kernel<SR, WTS, true><<<blocks, 32 * kWarps, 0, a.stream>>>(
          a.cols, a.wts, a.items, a.row_vertex, a.tile_mask, x, y, partial,
          a.C, a.L, a.cls);
    else
      spmv_kernel<SR, WTS, false><<<blocks, 32 * kWarps, 0, a.stream>>>(
          a.cols, a.wts, a.items, a.row_vertex, a.tile_mask, x, y, partial,
          a.C, a.L, a.cls);
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

// Refused before any launch, by both entries alike; fills the classes. The
// kernels count rows (items x C, and so warps) and fold rows in int.
bool bad_args(const int* class_items, int n_folds, int C, int L,
              Classes& cls) {
  if (C < 1 || C > 32 || L < 1 || n_folds < 0 ||
      !row_walk::make_classes(class_items, C, cls))
    return true;
  return static_cast<long long>(n_folds) * C > 0x7fffffffLL;
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
  Classes cls;
  if (bad_args(static_cast<const int*>(class_items), n_folds, C, L, cls))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(cols), nullptr,
               static_cast<const int4*>(items), cls,
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
  Classes cls;
  if (bad_args(static_cast<const int*>(class_items), n_folds, C, L, cls))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(cols), static_cast<const float*>(wts),
               static_cast<const int4*>(items), cls,
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(row_vertex),
               static_cast<const bool*>(tile_mask), x, y, partial, C, L,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<MINPLUS, true>(a));
}

extern "C" const char* slimsell_spmv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
