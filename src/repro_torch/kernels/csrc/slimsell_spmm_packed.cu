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
// and n = 2^20, X is 8 MB and stays in the 50 MB L2, so the sweep is the
// SpMV's (csrc/slimsell_spmv.cu) with an 8-byte gather in place of a
// 4-byte one: the x gathers at L2's sector rate hold most of its time.
//
// Design: the SpMV's, over the SpMV's own work list (kernels/ops.py,
// spmv_work), so no second list is built for a layout.
// - SlimChunk balance. Each item of the list is one piece of a chunk (at
//   most 1024 slots a row): (chunk, first tile, slots of its rows below cl,
//   partial slot). A chunk of one piece writes Y[row_vertex] itself; the
//   pieces of a split chunk write their rows to a scratch [slots, C, Wb],
//   and a second launch ORs them in piece order and writes Y. No atomics.
// - No idle lanes on short rows. A row gets LANES = 1, 2, 4, ..., 32 lanes
//   by its length (the item's width class; the wrapper sorts the items by
//   class), a warp takes 32 / LANES consecutive rows of a class across
//   chunk boundaries, so C need not divide 32. A lane takes 8 consecutive
//   slots a step (two 16-byte loads of cols when L is a multiple of 4 and
//   cols is aligned) and gathers WORDS words of X for each: one 8-byte
//   uint2 at Wb = 2, one 16-byte uint4 at Wb a multiple of 4, when X is
//   aligned; words past Wb are not read. The LANES lanes of a row OR their
//   words by shuffles. A batch wider than 4 words takes further blocks
//   along grid y.
// - cols are read once, with the streaming hint (__ldcs), leaving the L1
//   cache to the X gathers.
// - SlimWork: a tile whose mask bit is 0 is skipped before any of its cols
//   are loaded; an item with no kept tile writes zero words. Only slots
//   below cl are read; a padding slot (cols -1) below it adds nothing.
//   Every vertex owns exactly one chunk row, so Y (not cleared beforehand)
//   is written once a row and word, zero included; a padding row
//   (row_vertex -1) writes nothing. Words are ORs of X words, so X's zero
//   tail bits stay zero in Y.
// The walk of a row of the list (the width classes, rows a warp, the
// 8-slot groups, the SlimWork skip and the scalar tail below cl) is
// row_walk.cuh's, shared with the SpMV (slimsell_spmv.cu), the
// single-source pull (slimsell_pull.cu) and the packed SpMV
// (slimsell_spmv_packed.cu).
#include "row_walk.cuh"

namespace {

using row_walk::Classes;
using row_walk::kFull;
using row_walk::kGroup;
using row_walk::kWarps;
constexpr int kMaxWords = 4; // word planes one block covers (128 roots)

// words w0 .. w0 + nw - 1 of one X row, ORed into acc; WORDS is the most a
// block covers, VW the words of one vector load (VW divides nw)
template <int WORDS, int VW>
__device__ __forceinline__ void or_words(const unsigned* __restrict__ xr,
                                         int nw, unsigned acc[WORDS]) {
  if constexpr (VW == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr));
    acc[0] |= q.x;
    acc[1] |= q.y;
    acc[2] |= q.z;
    acc[3] |= q.w;
  } else if constexpr (VW == 2) {
#pragma unroll
    for (int j = 0; j < WORDS; j += 2)
      if (j < nw) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(xr + j));
        acc[j] |= q.x;
        acc[j + 1] |= q.y;
      }
  } else {
#pragma unroll
    for (int j = 0; j < WORDS; ++j)
      if (j < nw) acc[j] |= __ldg(xr + j);
  }
}

// Rows of one width class: LANES lanes a row, 32 / LANES rows a warp.
// `warp` is the warp's rank within the class, `items` the class's items.
template <int WORDS, int VW, bool CVEC, int LANES>
__device__ __forceinline__ void sweep_rows(
    const int* __restrict__ cols, const int4* __restrict__ items,
    int n_items, int warp, const int* __restrict__ row_vertex,
    const bool* __restrict__ tile_mask, const unsigned* __restrict__ X,
    unsigned* __restrict__ Y, unsigned* __restrict__ partial, int C, int L,
    int Wb) {
  const row_walk::Row row = row_walk::row_of<LANES>(items, n_items, warp, C);
  const int w0 = blockIdx.y * kMaxWords;
  const int nw = min(WORDS, Wb - w0);
  unsigned acc[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS; ++j) acc[j] = 0u;
  int v = -1;
  if (row.live) {
    if (row.it.w < 0) v = row_vertex[static_cast<size_t>(row.it.x) * C + row.r];
    row_walk::walk_row<CVEC, LANES>(
        cols, tile_mask, row, C, L, [&](const int (&c)[kGroup], size_t, bool) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (c[j] >= 0)
              or_words<WORDS, VW>(X + static_cast<size_t>(c[j]) * Wb + w0, nw,
                                  acc);
        });
  }
  // the LANES lanes of a row, ORed
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < WORDS; ++j)
      acc[j] |= __shfl_xor_sync(kFull, acc[j], off);
  if (!row.live || row.lg != 0) return;
  unsigned* out = nullptr;
  if (row.it.w >= 0)
    out = partial + (static_cast<size_t>(row.it.w) * C + row.r) * Wb + w0;
  else if (v >= 0)
    out = Y + static_cast<size_t>(v) * Wb + w0;
  if (out == nullptr) return;
#pragma unroll
  for (int j = 0; j < WORDS; ++j)
    if (j < nw) out[j] = acc[j];
}

template <int WORDS, int VW, bool CVEC>
__global__ void __launch_bounds__(32 * kWarps)
    spmm_packed_kernel(const int* __restrict__ cols,
                       const int4* __restrict__ items,
                       const int* __restrict__ row_vertex,
                       const bool* __restrict__ tile_mask,
                       const unsigned* __restrict__ X,
                       unsigned* __restrict__ Y,
                       unsigned* __restrict__ partial, int C, int L, int Wb,
                       Classes cls) {
  row_walk::for_warp(cls, items, [&](auto lanes, const int4* it, int n,
                                     int w) {
    sweep_rows<WORDS, VW, CVEC, decltype(lanes)::value>(
        cols, it, n, w, row_vertex, tile_mask, X, Y, partial, C, L, Wb);
  });
}

// One thread per (split chunk, row, word): the partial rows of the chunk's
// pieces, ORed in piece order. `folds` holds (chunk, first partial slot,
// number of slots, unused).
__global__ void fold_kernel(const int4* __restrict__ folds, long long total,
                            const int* __restrict__ row_vertex,
                            const unsigned* __restrict__ partial,
                            unsigned* __restrict__ Y, int C, int Wb) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long per = static_cast<long long>(C) * Wb;
  const int4 f = folds[i / per];
  const int r = static_cast<int>(i % per / Wb);
  const int w = static_cast<int>(i % Wb);
  const int v = row_vertex[static_cast<size_t>(f.x) * C + r];
  if (v < 0) return;
  const unsigned* p = partial + (static_cast<size_t>(f.y) * C + r) * Wb + w;
  unsigned acc = p[0];
  for (int k = 1; k < f.z; ++k) acc |= p[static_cast<size_t>(k) * per];
  Y[static_cast<size_t>(v) * Wb + w] = acc;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Args {
  const int* cols;
  const int4* items;
  const int* row_vertex;
  const bool* tile_mask;
  const unsigned* X;
  unsigned* Y;
  unsigned* partial;
  int C, L, Wb;
  Classes cls;
  unsigned blocks;
  cudaStream_t stream;
};

template <int WORDS, int VW, bool CVEC>
void launch_sweep(const Args& a) {
  const dim3 grid(a.blocks, (a.Wb + kMaxWords - 1) / kMaxWords);
  spmm_packed_kernel<WORDS, VW, CVEC><<<grid, 32 * kWarps, 0, a.stream>>>(
      a.cols, a.items, a.row_vertex, a.tile_mask, a.X, a.Y, a.partial, a.C,
      a.L, a.Wb, a.cls);
}

// the words a block covers and the width of one gather: WORDS = Wb up to
// 2, else 4; one vector load when X is aligned to it and Wb a multiple
template <bool CVEC>
void launch_words(const Args& a) {
  if (a.Wb == 1)
    launch_sweep<1, 1, CVEC>(a);
  else if (a.Wb == 2 && aligned(a.X, 8))
    launch_sweep<2, 2, CVEC>(a);
  else if (a.Wb == 2)
    launch_sweep<2, 1, CVEC>(a);
  else if (a.Wb % 4 == 0 && aligned(a.X, 16))
    launch_sweep<4, 4, CVEC>(a);
  else if (a.Wb % 2 == 0 && aligned(a.X, 8))
    launch_sweep<4, 2, CVEC>(a);
  else
    launch_sweep<4, 1, CVEC>(a);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `items` int32 [n_items, 4] lists (chunk, first tile, slots of
// its rows below the chunk's length cl, partial slot or -1) for every piece
// of every chunk, sorted by width class; `class_items` is a HOST array of
// the items of each of the 6 classes (lanes a row 1, 2, ..., 32); `folds`
// int32 [n_folds, 4] lists (chunk, first slot, number of slots, 0) for each
// chunk split into several pieces, whose slots are consecutive in piece
// order; `partial` is scratch of [slots, C, Wb] words (null when n_folds
// is 0). X and Y are [n, Wb] words with Wb >= 1, and every vertex must own
// exactly one chunk row (each row of Y is written once). Needs
// 1 <= C <= 32. Returns cudaGetLastError() after its launches: 0 when
// they were accepted.
extern "C" int slimsell_spmm_packed(const void* cols, const void* row_vertex,
                                    const void* tile_mask, const void* items,
                                    const void* class_items, const void* folds,
                                    int n_folds, void* partial, const void* X,
                                    void* Y, int C, int L, int Wb,
                                    void* stream) {
  Args a{static_cast<const int*>(cols), static_cast<const int4*>(items),
         static_cast<const int*>(row_vertex),
         static_cast<const bool*>(tile_mask), static_cast<const unsigned*>(X),
         static_cast<unsigned*>(Y), static_cast<unsigned*>(partial), C, L, Wb,
         {}, 0u, static_cast<cudaStream_t>(stream)};
  // the kernels count rows (items x C, and so warps) in int
  if (C < 1 || C > 32 || L < 1 || Wb < 1 || n_folds < 0 ||
      !row_walk::make_classes(static_cast<const int*>(class_items), C, a.cls))
    return static_cast<int>(cudaErrorInvalidValue);
  a.blocks = row_walk::blocks(a.cls);
  if (a.blocks > 0) {
    if (L % 4 == 0 && row_walk::aligned16(cols))
      launch_words<true>(a);
    else
      launch_words<false>(a);
  }
  if (n_folds > 0) {
    const long long total = static_cast<long long>(n_folds) * C * Wb;
    const int threads = 256;
    fold_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                  threads, 0, a.stream>>>(
        static_cast<const int4*>(folds), total, a.row_vertex, a.partial, a.Y,
        C, Wb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slimsell_spmm_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
