// SlimSell batched bottom-up (pull) semiring sweep for Hopper (sm_90a): the
// matrix-RHS pull of batched multi-source BFS.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_pull.py:_pull_mm_kernel
// (wrapper slimsell_pull_mm_pallas).
//
// For each (v, b) with nf[v, b] set: Y[v, b] is the reduction over L of
// edge(X[col, b]) for the FIRST kept tile of v's chunk, in tile order,
// whose reduction is not the semiring zero; Y[v, b] is zero when nf[v, b]
// is false or no kept tile hits. X, Y and nf are row-major [n, B].
//
// What bounds it: bytes. A slot costs one cols read shared by the row's
// batch columns and a gather of X[col, b] for each pending column. The
// least time is (the cols each row reads through the last first hit of its
// pending columns, capped at the chunk length cl, + X + nf + Y) over an
// H100 SXM's 3.35 TB/s of HBM (NVIDIA data sheet); like the hits, it
// depends on the data and is worked out from each run's.
//
// Design.
// - SlimChunk pieces. The work list is the SpMV's (kernels/ops.py,
//   spmv_work, kept on the layout): each chunk's tiles below cl cut into
//   pieces of at most 1024 // L tiles, (chunk, first tile, slots of its
//   rows below cl, partial slot). The list's width-class order puts pieces
//   of like length side by side; the pull ignores the classes. Pieces of
//   1024 slots a row, not the SpMM's 256: at the pull states of a BFS the
//   long chunks hit early, and longer pieces mean fewer warps and fewer
//   slots read past a hit (PERF.md §6).
// - The first hit across pieces. A piece writes, for each (row, column),
//   its own first hit: the reduction of its first kept tile, in tile
//   order, that is not the semiring zero, or zero if none. A chunk of one
//   piece writes Y[row_vertex] itself; the pieces of a split chunk write
//   their rows to a scratch [slots, C, B], and a second launch takes, for
//   each (v, b), the FIRST piece in piece order whose value is not zero.
//   That is not the semiring add: under real and sel-max, an add or max of
//   two pieces' hits is a value the plain version never gives. The later
//   pieces of a chunk do not know of an earlier piece's hit, so they read
//   their tiles all the same: that is the price of running pieces side by
//   side (PERF.md §6 counts those slots).
// - Lanes over the batch columns, as in the push SpMM
//   (csrc/slimsell_spmm.cu): with a column tile Bt of 16, 32, 64 or 128,
//   each lane holds 4 adjacent columns (one 16-byte float4 or int4 gather
//   of X[col, b0:b0+4]) and a group of Bt/4 lanes covers the tile. Each
//   group takes a row of the list of its own, so a warp takes G = 128/Bt
//   consecutive rows (2 at B = 64, 8 at B <= 16), across piece
//   boundaries: a short piece's life is a chain of dependent loads (its
//   item, row_vertex, nf) and fewer warps mean fewer such chains. A group
//   reads Bt/4 cols of its row in one coalesced load and hands them out
//   with width-Bt/4 shuffles, slot by slot in order; no shared memory, no
//   block barrier, no reduction across lanes. The warp walks the tiles of
//   its rows in step (the rows of one piece share their tiles; across
//   pieces the loop runs to the longest, a group past its row loading no
//   cols). Each lane keeps its columns' pending flags in a register and
//   gathers nothing once none of them is pending; at the end of a tile a
//   lane takes the tile's reduction as the first hit of each column still
//   pending whose reduction is not zero, and the warp leaves as soon as
//   __any_sync over all its flags is false. A row with no pending column
//   reads no cols and writes zeros. B that is not a multiple of 4, or an
//   operand not aligned, takes scalar loads a lane instead. Wider batches
//   take further blocks along grid y. A block is 8 independent warps, six
//   blocks an SM.
// - SlimWork: a tile whose mask bit is 0 is skipped before its cols are
//   read. Only slots below cl are read; a padding slot (cols -1) below it
//   contributes the semiring zero, and a batch of 32 slots that holds only
//   padding is skipped. cols are read once, with the streaming hint.
#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using V = float4; };
template <> struct Vec4<int> { using V = int4; };

// columns b..b+3 of one row; the scalar path reads only those below B
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int b, int B,
                                      T v[4]) {
  if constexpr (VEC) {
    const auto q = __ldg(reinterpret_cast<const typename Vec4<T>::V*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = b + j < B ? __ldg(p + j) : T(0);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ p, int b, int B,
                                       const T v[4]) {
  if constexpr (VEC) {
    using V = typename Vec4<T>::V;
    *reinterpret_cast<V*>(p) = V{v[0], v[1], v[2], v[3]};
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b + j < B) p[j] = v[j];
  }
}

constexpr int kWarps = 8;  // independent warps a block
// Six blocks an SM hold a thread to 40 registers (48 warps an SM) without
// a spill; on the card that beat 8 blocks (32 registers: more warps, but
// one gather in flight a lane) and 4 (fewer warps), PERF.md §6.
constexpr int kMinBlocks = 6;

// `items` holds (chunk, first tile, slots of its rows, partial slot or -1)
// for each piece; the group of a warp takes row i % C of item i / C, for
// the i of its rank in the grid.
template <int SR, int BT, bool VEC>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    pull_mm_kernel(const int* __restrict__ cols,
                   const int4* __restrict__ items, int n_rows,
                   const int* __restrict__ row_vertex,
                   const bool* __restrict__ tile_mask,
                   const bool* __restrict__ nf,
                   const typename Semiring<SR>::T* __restrict__ X,
                   typename Semiring<SR>::T* __restrict__ Y,
                   typename Semiring<SR>::T* __restrict__ partial, int C,
                   int L, int B) {
  using S = Semiring<SR>;
  using T = typename S::T;
  constexpr int LG = BT / 4;      // lanes of a group: the columns of a row
  constexpr int G = 32 / LG;      // groups, rows a warp
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp * G >= n_rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int q = lane % LG;
  const int i = warp * G + lane / LG;  // the group's row of the list
  int4 it = make_int4(0, 0, 0, -1);
  int r = 0, v = -1;
  if (i < n_rows) {
    it = items[i / C];  // (chunk, first tile, slots, slot)
    r = i % C;
    v = row_vertex[static_cast<size_t>(it.x) * C + r];
  }
  const int b = blockIdx.y * BT + q * 4;
  const bool live = b < B;
  unsigned pend = 0u;  // bit j set: column b + j is pending
  if (live && v >= 0) {
    const bool* p = nf + static_cast<size_t>(v) * B + b;
    if constexpr (VEC) {
      const uchar4 u = *reinterpret_cast<const uchar4*>(p);
      pend = (u.x ? 1u : 0u) | (u.y ? 2u : 0u) | (u.z ? 4u : 0u) |
             (u.w ? 8u : 0u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (b + j < B && p[j]) pend |= 1u << j;
    }
  }
  T val[4] = {S::zero(), S::zero(), S::zero(), S::zero()};
  // the tiles of the rows, in step: a group past its row's slots loads none
  for (int done = 0, t = it.y;
       __any_sync(kFull, pend != 0u && done < it.z); done += L, ++t) {
    // this group's row: still pending, a tile left, the tile kept
    const unsigned own = __ballot_sync(kFull, pend != 0u) >> (lane - q);
    const bool busy = (LG == 32 ? own : own & ((1u << LG) - 1u)) != 0u &&
                      done < it.z && (tile_mask == nullptr || tile_mask[t]);
    const int lim = busy ? min(L, it.z - done) : 0;  // slots before cl
    const int warp_lim = __reduce_max_sync(kFull, lim);
    const size_t row = (static_cast<size_t>(t) * C + r) * L;
    T red[4] = {S::zero(), S::zero(), S::zero(), S::zero()};
    for (int base = 0; base < warp_lim; base += LG) {
      const int s = base + q;
      const int c = s < lim ? __ldcs(cols + row + s) : -1;
      if (__ballot_sync(kFull, c >= 0) == 0) continue;  // padding only
#pragma unroll
      for (int k = 0; k < LG; ++k) {
        const int cs = __shfl_sync(kFull, c, k, LG);  // slot base + k
        if (cs < 0 || pend == 0u) continue;
        T xs[4];
        load4<T, VEC>(X + static_cast<size_t>(cs) * B + b, b, B, xs);
#pragma unroll
        for (int j = 0; j < 4; ++j) red[j] = S::add(red[j], S::edge(xs[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((pend >> j & 1u) && red[j] != S::zero()) {  // first hit of (v, b)
        val[j] = red[j];
        pend &= ~(1u << j);
      }
  }
  if (!live || v < 0) return;
  T* out = it.w < 0 ? Y + static_cast<size_t>(v) * B + b
                    : partial + (static_cast<size_t>(it.w) * C + r) * B + b;
  store4<T, VEC>(out, b, B, val);
}

// One thread per (split chunk, row, column): the value of the first of the
// chunk's pieces, in piece order, that is not the semiring zero (zero if
// none). `folds` holds (chunk, first partial slot, number of slots, unused).
template <int SR>
__global__ void fold_kernel(
    const int4* __restrict__ folds, long long total,
    const int* __restrict__ row_vertex,
    const typename Semiring<SR>::T* __restrict__ partial,
    typename Semiring<SR>::T* __restrict__ Y, int C, int B) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long per = static_cast<long long>(C) * B;
  const int4 f = folds[i / per];
  const int r = static_cast<int>(i % per / B);
  const int b = static_cast<int>(i % B);
  const int v = row_vertex[static_cast<size_t>(f.x) * C + r];
  if (v < 0) return;
  const T* p = partial + (static_cast<size_t>(f.y) * C + r) * B + b;
  T hit = S::zero();
  for (int k = 0; k < f.z; ++k) {
    const T got = p[static_cast<size_t>(k) * per];
    if (got != S::zero()) {
      hit = got;
      break;
    }
  }
  Y[static_cast<size_t>(v) * B + b] = hit;
}

struct Args {
  const int* cols;
  const int4* items;
  int n_rows;
  const int4* folds;
  int n_folds;
  const int* row_vertex;
  const bool* tile_mask;
  const bool* nf;
  const void* X;
  void* Y;
  void* partial;
  int C, L, B;
  cudaStream_t stream;
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int SR, int BT, bool VEC>
void launch_sweep(const Args& a) {
  using T = typename Semiring<SR>::T;
  const int warps = (a.n_rows + 128 / BT - 1) / (128 / BT);  // G rows each
  const dim3 grid((warps + kWarps - 1) / kWarps, (a.B + BT - 1) / BT);
  pull_mm_kernel<SR, BT, VEC><<<grid, 32 * kWarps, 0, a.stream>>>(
      a.cols, a.items, a.n_rows, a.row_vertex, a.tile_mask, a.nf,
      static_cast<const T*>(a.X), static_cast<T*>(a.Y),
      static_cast<T*>(a.partial), a.C, a.L, a.B);
}

template <int SR, bool VEC>
void launch_width(const Args& a) {
  if (a.B <= 16) launch_sweep<SR, 16, VEC>(a);
  else if (a.B <= 32) launch_sweep<SR, 32, VEC>(a);
  else if (a.B <= 64) launch_sweep<SR, 64, VEC>(a);
  else launch_sweep<SR, 128, VEC>(a);
}

// the sweep, then the fold of the split chunks
struct Launch {
  const Args& a;
  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    const bool vec = a.B % 4 == 0 && aligned(a.X, 16) && aligned(a.Y, 16) &&
                     aligned(a.partial, 16) && aligned(a.nf, 4);
    if (a.n_rows > 0) {
      if (vec) launch_width<SR, true>(a);
      else launch_width<SR, false>(a);
    }
    if (a.n_folds > 0) {
      const long long total = static_cast<long long>(a.n_folds) * a.C * a.B;
      const int threads = 256;
      fold_kernel<SR><<<static_cast<unsigned>((total + threads - 1) / threads),
                        threads, 0, a.stream>>>(
          a.folds, total, a.row_vertex, static_cast<const T*>(a.partial),
          static_cast<T*>(a.Y), a.C, a.B);
    }
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept); `nf` is bool[n, B] in vertex space. `items` int32
// [n_items, 4] lists (chunk, first tile, slots of its rows below the
// chunk's length cl, partial slot or -1) for every piece of every chunk
// (the SpMV's list; any order); `folds` int32 [n_folds, 4] lists (chunk,
// first slot, number of slots, 0) for each chunk split into several
// pieces, whose slots are consecutive in piece order; `partial` is scratch
// of [slots, C, B] elements of X's type (null when n_folds is 0). Needs
// 1 <= C <= 32. Returns cudaGetLastError() after its launches: 0 when they
// were accepted.
extern "C" int slimsell_pull_mm(int sr_code, const void* cols,
                                const void* row_vertex, const void* tile_mask,
                                const void* nf, const void* items,
                                int n_items, const void* folds, int n_folds,
                                void* partial, const void* X, void* Y, int C,
                                int L, int B, void* stream) {
  // the kernel counts rows (items x C) in int
  if (C < 1 || C > 32 || L < 1 || B < 1 || n_items < 0 || n_folds < 0 ||
      nf == nullptr || static_cast<long long>(n_items) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(cols),
               static_cast<const int4*>(items), n_items * C,
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(row_vertex),
               static_cast<const bool*>(tile_mask),
               static_cast<const bool*>(nf), X, Y, partial, C, L, B,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, Launch{a}));
}

extern "C" const char* slimsell_pull_mm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
