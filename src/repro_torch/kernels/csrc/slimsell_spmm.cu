// SlimSell semiring SpMM for Hopper (sm_90a), in three modes: the
// matrix-RHS sweep of batched multi-source BFS, of batched SSSP, and GCN's
// neighbourhood aggregation.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_spmm.py:_spmm_kernel
// (wrapper slimsell_spmm_pallas):
// - implicit edge value (entry slimsell_spmm, BFS): Y[v, b] = add over the
//   slots of v's chunk row of edge(X[col, b]);
// - stored weights (entry slimsell_spmm_wts, multi-source SSSP; the Pallas
//   kernel with wts=, stored=True): Y[v, b] = min over the slots of
//   (wts[slot] + X[col, b]), min-plus over SlimSell-W, the same weight for
//   every column b;
// - GCN weight (entry slimsell_spmm_gcn, the GCN aggregation; the Pallas
//   kernel with weighted=True): Y[v, b] = sum over the slots of
//   rsqrt(max(deg[v], 1)) * rsqrt(max(deg[col], 1)) * X[col, b], real
//   semiring, float32, the weight derived from the degree vector and never
//   stored (SlimSell-W);
// each over the tiles of the row's chunk that the SlimWork mask keeps. X
// and Y are row-major [n, B].
//
// What bounds it: bytes. Each slot costs one cols read (and one wts read in
// the stored mode, one column-factor gather in the GCN mode) shared by all
// B columns plus a B-wide gather of X[col, :], and one to three operations
// per column; the least time is (the cols, and wts, of each chunk up to its
// length cl + deg + X + Y) over an H100 SXM's 3.35 TB/s of HBM bandwidth
// (NVIDIA data sheet). The X rows are gathered irregularly, 4*B bytes each.
//
// Design.
// - SlimChunk balance. The wrapper cuts each chunk's tiles below cl into
//   pieces of at most P tiles (kernels/ops.py: P = 256 // L, so a row's
//   walk in one piece is at most 256 slots) and passes the list of pieces
//   (chunk, first tile, end tile, partial slot). One block takes one piece
//   and one column tile, so the first chunks of a sigma-sorted power-law
//   graph, hundreds of tiles long, spread over many blocks. A chunk of one
//   piece writes Y[row_vertex] itself; the pieces of a split chunk write
//   their partial rows to a scratch [slots, C, B], and a second launch
//   folds them in piece order and writes Y. No atomics, a fixed order:
//   the result is the same bits on every call.
// - A warp per chunk row. With a column tile Bt of 16, 32, 64 or 128, each
//   lane holds 4 adjacent columns (one 16-byte float4 or int4 gather of
//   X[col, b0:b0+4]), a group of Bt/4 lanes covers the tile, and the warp's
//   G = 128/Bt groups walk G slots at once: no lane idles at B = 16. The
//   warp reads 32 cols of its row (and 32 weights, or the 32 column
//   factors) in one coalesced load and hands them to the groups with
//   __shfl_sync: no shared memory, no block barrier. Each group adds its
//   slots in order; the G group sums fold by shuffles in a fixed tree. B
//   that is not a multiple of 4, or an operand not 16-byte aligned, takes
//   4 scalar loads a lane instead. Wider batches take further blocks
//   along grid y.
// - GCN column factors once a call. A small kernel writes dinv[v] =
//   1/sqrt(max(deg[v], 1)) (IEEE root and division, no fast math; the
//   clamp keeps isolated vertices finite) into an [n] scratch; the sweep
//   gathers dinv[col] (4 MB at scale 20, L2-resident) and a slot adds
//   (dinv[row] * dinv[col]) * X[col, b], the reference's order.
// - SlimWork: a tile whose mask bit is 0 is skipped before its cols are
//   read; a piece with no kept tile gives the semiring zero. Only slots
//   below cl are read. A slot below cl may still be padding (cols -1): it
//   contributes the semiring zero whatever its weight, and its weight is
//   not read. A batch of 32 slots that holds only padding is skipped.
#include <cstdint>

#include "semiring.cuh"

namespace {

// what a slot's contribution multiplies X[col, b] by
enum Mode { IMPLICIT = 0, STORED = 1, GCN = 2 };

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

// `aux` is the stored weights [T, C, L] (STORED), the column factors
// dinv [n] (GCN), or null (IMPLICIT). `pieces` holds (chunk, first tile,
// end tile, partial slot or -1) for each block along grid x.
// The launch bounds (two 1024-thread blocks an SM) hold a thread to 32
// registers, so 64 warps share an SM, each with one gather in flight at a
// time: on the card more warps hide the gathers' latency better than more
// gathers a warp (the first version kept 8 in flight at 64-72 registers,
// 32 warps an SM; PERF.md §6 gives both times), and 4 or 8 in flight at
// 32 registers spill.
template <int SR, int MODE, int BT, bool VEC>
__global__ void __launch_bounds__(1024, 2)
    spmm_kernel(const int* __restrict__ cols, const float* __restrict__ aux,
                const int4* __restrict__ pieces,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ row_vertex,
                const int* __restrict__ cl, const bool* __restrict__ tile_mask,
                const typename Semiring<SR>::T* __restrict__ X,
                typename Semiring<SR>::T* __restrict__ Y,
                typename Semiring<SR>::T* __restrict__ partial, int C, int L,
                int B) {
  using S = Semiring<SR>;
  using T = typename S::T;
  constexpr int LG = BT / 4;      // lanes of one slot group
  constexpr int G = 32 / LG;      // slot groups: slots a warp takes a step
  constexpr int STEPS = 32 / G;   // steps over the 32 slots of one load
  const int4 pc = pieces[blockIdx.x];
  const int chunk = pc.x;
  const int r = threadIdx.y;
  const int lane = threadIdx.x;
  const int g = lane / LG;
  const int b = blockIdx.y * BT + (lane % LG) * 4;
  const bool live = b < B;
  const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
  // a padding row (v < 0) holds only padding slots and writes nothing
  float w_row = 1.0f;
  if constexpr (MODE == GCN) w_row = __ldg(aux + max(v, 0));
  T acc[4] = {S::zero(), S::zero(), S::zero(), S::zero()};
  const int t_first = tile_ptr[chunk];
  const int len = cl[chunk];
  for (int t = pc.y; t < pc.z; ++t) {
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    const int lim = min(L, len - (t - t_first) * L);      // slots before cl
    const size_t row = (static_cast<size_t>(t) * C + r) * L;
    for (int base = 0; base < lim; base += 32) {
      const int s = base + lane;
      const int c = s < lim ? __ldg(cols + row + s) : -1;
      if (__ballot_sync(kFull, c >= 0) == 0) continue;  // padding only
      float w = 0.0f;
      if constexpr (MODE == STORED) w = c >= 0 ? __ldg(aux + row + s) : 0.0f;
      if constexpr (MODE == GCN) w = c >= 0 ? w_row * __ldg(aux + c) : 0.0f;
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        // group g takes slots g, g + G, ... of these 32, in order
        const int cs = __shfl_sync(kFull, c, k * G + g);
        float ws = 0.0f;
        if constexpr (MODE != IMPLICIT) ws = __shfl_sync(kFull, w, k * G + g);
        if (cs < 0 || !live) continue;
        T xs[4];
        load4<T, VEC>(X + static_cast<size_t>(cs) * B + b, b, B, xs);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == STORED)
            acc[j] = S::add(acc[j], S::mul(ws, xs[j]));
          else if constexpr (MODE == GCN)
            acc[j] = S::add(acc[j], ws * xs[j]);
          else
            acc[j] = S::add(acc[j], S::edge(xs[j]));
        }
      }
    }
  }
  // the G group sums, folded into group 0 in a fixed tree
#pragma unroll
  for (int off = 16; off >= LG; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = S::add(acc[j], __shfl_down_sync(kFull, acc[j], off));
  if (lane >= LG || !live || v < 0) return;
  T* out = pc.w < 0 ? Y + static_cast<size_t>(v) * B + b
                    : partial + (static_cast<size_t>(pc.w) * C + r) * B + b;
  store4<T, VEC>(out, b, B, acc);
}

// One thread per (split chunk, row, column): the partial rows of the
// chunk's pieces, added in piece order. `folds` holds (chunk, first
// partial slot, number of slots, unused).
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
  T acc = p[0];
  for (int k = 1; k < f.z; ++k)
    acc = S::add(acc, p[static_cast<size_t>(k) * per]);
  Y[static_cast<size_t>(v) * B + b] = acc;
}

// 1 / sqrt(max(deg[v], 1)): the clamp keeps isolated vertices finite
__global__ void inv_sqrt_deg_kernel(const float* __restrict__ deg,
                                    float* __restrict__ dinv, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dinv[i] = 1.0f / sqrtf(fmaxf(deg[i], 1.0f));
}

struct Args {
  const int* cols;
  const float* aux;
  const int4* pieces;
  int n_pieces;
  const int4* folds;
  int n_folds;
  const int* tile_ptr;
  const int* row_vertex;
  const int* cl;
  const bool* tile_mask;
  const void* X;
  void* Y;
  void* partial;
  int C, L, B;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int SR, int MODE, int BT, bool VEC>
void launch_sweep(const Args& a) {
  using T = typename Semiring<SR>::T;
  const dim3 grid(a.n_pieces, (a.B + BT - 1) / BT);
  const dim3 block(32, a.C);
  spmm_kernel<SR, MODE, BT, VEC><<<grid, block, 0, a.stream>>>(
      a.cols, a.aux, a.pieces, a.tile_ptr, a.row_vertex, a.cl, a.tile_mask,
      static_cast<const T*>(a.X), static_cast<T*>(a.Y),
      static_cast<T*>(a.partial), a.C, a.L, a.B);
}

template <int SR, int MODE, bool VEC>
void launch_width(const Args& a) {
  if (a.B <= 16) launch_sweep<SR, MODE, 16, VEC>(a);
  else if (a.B <= 32) launch_sweep<SR, MODE, 32, VEC>(a);
  else if (a.B <= 64) launch_sweep<SR, MODE, 64, VEC>(a);
  else launch_sweep<SR, MODE, 128, VEC>(a);
}

// the sweep, then the fold of the split chunks
template <int SR, int MODE>
cudaError_t launch(const Args& a) {
  using T = typename Semiring<SR>::T;
  const bool vec = a.B % 4 == 0 && aligned16(a.X) && aligned16(a.Y) &&
                   aligned16(a.partial);
  if (vec) launch_width<SR, MODE, true>(a);
  else launch_width<SR, MODE, false>(a);
  if (a.n_folds > 0) {
    const long long total = static_cast<long long>(a.n_folds) * a.C * a.B;
    const int threads = 256;
    fold_kernel<SR><<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, a.stream>>>(
        a.folds, total, a.row_vertex, static_cast<const T*>(a.partial),
        static_cast<T*>(a.Y), a.C, a.B);
  }
  return cudaGetLastError();
}

struct Implicit {
  const Args& a;
  template <int SR> void operator()() const { launch<SR, IMPLICIT>(a); }
};

bool bad_shape(int n_pieces, int n_folds, int C, int L, int B) {
  return C < 1 || C > 32 || L < 1 || B < 1 || n_pieces < 0 || n_folds < 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `cl` holds each chunk's length: no slot at or past it may hold
// an edge. `pieces` int32 [n_pieces, 4] lists (chunk, first tile, end tile,
// partial slot or -1) and covers every chunk; `folds` int32 [n_folds, 4]
// lists (chunk, first slot, number of slots, 0) for each chunk split into
// several pieces, whose slots are consecutive in piece order; `partial` is
// scratch of [slots, C, B] elements of X's type (null when n_folds is 0).
// C is at most 32. Each returns cudaGetLastError() after its launches: 0
// when they were accepted.
extern "C" int slimsell_spmm(int sr_code, const void* cols,
                             const void* tile_ptr, const void* row_vertex,
                             const void* cl, const void* tile_mask,
                             const void* pieces, int n_pieces,
                             const void* folds, int n_folds, void* partial,
                             const void* X, void* Y, int C, int L, int B,
                             void* stream) {
  if (bad_shape(n_pieces, n_folds, C, L, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces == 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const int*>(cols), nullptr,
               static_cast<const int4*>(pieces), n_pieces,
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(tile_ptr),
               static_cast<const int*>(row_vertex),
               static_cast<const int*>(cl), static_cast<const bool*>(tile_mask),
               X, Y, partial, C, L, B, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, Implicit{a}));
}

// The stored-weight (min-plus) sweep: `wts` is float32, laid out as `cols`;
// X and Y are float32.
extern "C" int slimsell_spmm_wts(const void* cols, const void* wts,
                                 const void* tile_ptr, const void* row_vertex,
                                 const void* cl, const void* tile_mask,
                                 const void* pieces, int n_pieces,
                                 const void* folds, int n_folds, void* partial,
                                 const void* X, void* Y, int C, int L, int B,
                                 void* stream) {
  if (bad_shape(n_pieces, n_folds, C, L, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces == 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const int*>(cols), static_cast<const float*>(wts),
               static_cast<const int4*>(pieces), n_pieces,
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(tile_ptr),
               static_cast<const int*>(row_vertex),
               static_cast<const int*>(cl), static_cast<const bool*>(tile_mask),
               X, Y, partial, C, L, B, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<MINPLUS, STORED>(a));
}

// The GCN aggregation: `deg` is float32 [n], the degree of each vertex;
// `dinv` is float32 scratch [n] for the column factors; X and Y are
// float32, the real semiring.
extern "C" int slimsell_spmm_gcn(const void* cols, const void* deg,
                                 void* dinv, int n, const void* tile_ptr,
                                 const void* row_vertex, const void* cl,
                                 const void* tile_mask, const void* pieces,
                                 int n_pieces, const void* folds, int n_folds,
                                 void* partial, const void* X, void* Y, int C,
                                 int L, int B, void* stream) {
  if (bad_shape(n_pieces, n_folds, C, L, B) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pieces == 0) return static_cast<int>(cudaSuccess);
  auto* s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    inv_sqrt_deg_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(deg), static_cast<float*>(dinv), n);
  const Args a{static_cast<const int*>(cols), static_cast<const float*>(dinv),
               static_cast<const int4*>(pieces), n_pieces,
               static_cast<const int4*>(folds), n_folds,
               static_cast<const int*>(tile_ptr),
               static_cast<const int*>(row_vertex),
               static_cast<const int*>(cl), static_cast<const bool*>(tile_mask),
               X, Y, partial, C, L, B, s};
  return static_cast<int>(launch<REAL, GCN>(a));
}

extern "C" const char* slimsell_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
