// SlimSell semiring SpMM for Hopper (sm_90a), in two modes: the
// matrix-RHS sweep of batched multi-source BFS and of batched SSSP.
//
// Replaces the TPU kernel src/repro/kernels/slimsell_spmm.py:_spmm_kernel
// (wrapper slimsell_spmm_pallas):
// - implicit edge value (entry slimsell_spmm, BFS): Y[v, b] = add over the
//   slots of v's chunk row of edge(X[col, b]);
// - stored weights (entry slimsell_spmm_wts, multi-source SSSP; the Pallas
//   kernel with wts=, stored=True): Y[v, b] = min over the slots of
//   (wts[slot] + X[col, b]), min-plus over SlimSell-W, the same weight for
//   every column b;
// both over the tiles of the row's chunk that the SlimWork mask keeps. X
// and Y are row-major [n, B].
//
// What bounds it: bytes. Each slot costs one cols read (and one wts read in
// the stored mode) shared by all B columns plus a B-wide gather of
// X[col, :], and one or two operations per column; the least time is (the
// cols, and wts, of each chunk up to its length cl + X + Y) over an H100
// SXM's 3.35 TB/s of HBM bandwidth (NVIDIA data sheet). The X rows are
// gathered irregularly, 4*B bytes each.
//
// Design. One thread block owns one chunk and loops over the chunk's
// contiguous tiles tile_ptr[c]:tile_ptr[c+1]: the SlimChunk accumulation
// stays in registers, with no atomics and a fixed order. Thread (b, r)
// owns chunk row r and batch column b, so a warp covers 32 neighbouring
// columns of one row and each gathered X[col, b0:b0+32] is one coalesced
// 128-byte read. The block stages each kept tile's cols (C*L ints), and in
// the stored mode its weights beside them (C*L floats, read once and
// shared by all B columns), in shared memory, and every thread of a row
// reads the same slot (a broadcast). A tile whose mask bit is 0 is skipped
// before its cols or weights are loaded (SlimWork); a chunk with no kept
// tile writes the semiring zero. The slots of a chunk past its length
// cl[c] are padding: the block stages and walks only the slots before it,
// and reads no tile wholly past it. A slot below cl may still be padding
// (cols -1, weight 0): the pad test comes before the weight is read, so
// such a slot contributes +inf whatever its weight. Batches wider than one
// lane tile take further blocks along grid y, so any B is taken (the
// Pallas wrapper narrows its lane tile to gcd(B, 128) instead). Each
// vertex owns exactly one chunk row, so results go straight to
// Y[row_vertex, b] (no chunk-row epilogue).
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles.
#include "semiring.cuh"

namespace {

template <int SR, bool WTS>
__global__ void spmm_kernel(const int* __restrict__ cols,
                            const float* __restrict__ wts,
                            const int* __restrict__ tile_ptr,
                            const int* __restrict__ row_vertex,
                            const int* __restrict__ cl,
                            const bool* __restrict__ tile_mask,
                            const typename Semiring<SR>::T* __restrict__ X,
                            typename Semiring<SR>::T* __restrict__ Y,
                            int C, int L, int B) {
  using S = Semiring<SR>;
  using T = typename S::T;
  // one tile: C * L column ids, then (stored mode) its C * L weights
  extern __shared__ int s_cols[];
  float* s_w = WTS ? reinterpret_cast<float*>(s_cols + C * L) : nullptr;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  const int r = threadIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  T acc = S::zero();
  const int t_begin = tile_ptr[chunk];
  const int t_end = tile_ptr[chunk + 1];
  const int len = cl[chunk];
  for (int t = t_begin; t < t_end; ++t) {
    // lim and the mask bit are the same for the whole block, so every
    // thread takes the same branches and the barriers below stay uniform
    const int lim = min(L, len - (t - t_begin) * L);  // slots before cl
    if (lim <= 0) break;  // this tile and the rest are padding
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    __syncthreads();  // the previous tile's reads are done
    const size_t tile = static_cast<size_t>(t) * C * L;
    for (int i = tid; i < C * lim; i += n_threads) {
      const int rr = i / lim;
      const int o = rr * L + (i - rr * lim);
      s_cols[o] = __ldg(cols + tile + o);
      if constexpr (WTS) s_w[o] = __ldg(wts + tile + o);
    }
    __syncthreads();
    if (b < B) {
      const int* row = s_cols + r * L;
#pragma unroll 8
      for (int l = 0; l < lim; ++l) {
        const int c = row[l];
        if (c >= 0) {
          const T xv = __ldg(X + static_cast<size_t>(c) * B + b);
          if constexpr (WTS)
            acc = S::add(acc, S::mul(s_w[r * L + l], xv));
          else
            acc = S::add(acc, S::edge(xv));
        }
      }
    }
  }
  if (b < B) {
    const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
    if (v >= 0) Y[static_cast<size_t>(v) * B + b] = acc;
  }
}

struct Launch {
  const int* cols;
  const int* tile_ptr;
  const int* row_vertex;
  const int* cl;
  const bool* tile_mask;
  const void* X;
  void* Y;
  int n_chunks, C, L, B, lanes;
  cudaStream_t stream;

  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    const dim3 grid(n_chunks, (B + lanes - 1) / lanes);
    const dim3 block(lanes, C);
    const size_t smem = static_cast<size_t>(C) * L * sizeof(int);
    spmm_kernel<SR, false><<<grid, block, smem, stream>>>(
        cols, nullptr, tile_ptr, row_vertex, cl, tile_mask,
        static_cast<const T*>(X), static_cast<T*>(Y), C, L, B);
  }
};

bool bad_shape(int n_chunks, int C, int L, int B, int lanes, int tiles) {
  return C < 1 || L < 1 || B < 1 || n_chunks < 0 || lanes < 32 ||
         lanes % 32 != 0 || lanes * C > 1024 ||
         static_cast<size_t>(tiles) * C * L * 4 > 48 * 1024;
}

}  // namespace

// Plain C entry points, loaded with ctypes. `tile_mask` may be null (every
// tile kept). `cl` holds each chunk's length: no slot at or past it may hold
// an edge. `lanes` is the batch-column tile of one block: a multiple of
// 32 with lanes * C <= 1024. The staged tile (C * L ints, and as many
// floats in the stored mode) must fit the default 48 KB of shared memory.
// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.
extern "C" int slimsell_spmm(int sr_code, const void* cols,
                             const void* tile_ptr, const void* row_vertex,
                             const void* cl, const void* tile_mask,
                             const void* X, void* Y,
                             int n_chunks, int C, int L, int B, int lanes,
                             void* stream) {
  if (bad_shape(n_chunks, C, L, B, lanes, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  Launch launch{static_cast<const int*>(cols),
                static_cast<const int*>(tile_ptr),
                static_cast<const int*>(row_vertex),
                static_cast<const int*>(cl),
                static_cast<const bool*>(tile_mask), X, Y, n_chunks, C, L, B,
                lanes, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, launch));
}

// The stored-weight (min-plus) sweep: `wts` is float32, laid out as `cols`;
// X and Y are float32.
extern "C" int slimsell_spmm_wts(const void* cols, const void* wts,
                                 const void* tile_ptr, const void* row_vertex,
                                 const void* cl, const void* tile_mask,
                                 const void* X, void* Y,
                                 int n_chunks, int C, int L, int B, int lanes,
                                 void* stream) {
  if (bad_shape(n_chunks, C, L, B, lanes, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(n_chunks, (B + lanes - 1) / lanes);
  const dim3 block(lanes, C);
  const size_t smem = 2 * static_cast<size_t>(C) * L * sizeof(int);
  spmm_kernel<MINPLUS, true><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(wts),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(row_vertex),
      static_cast<const int*>(cl), static_cast<const bool*>(tile_mask),
      static_cast<const float*>(X), static_cast<float*>(Y), C, L, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slimsell_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
