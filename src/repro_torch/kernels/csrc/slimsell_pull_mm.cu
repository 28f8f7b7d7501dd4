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
// What bounds it: bytes. A slot costs one cols read shared by the block's
// batch columns and a gather of X[col, b] for each pending column. The
// least time is (the cols each row reads through the last first hit of its
// pending columns, capped at the chunk length cl, + X + nf + Y) over an
// H100 SXM's 3.35 TB/s of HBM (NVIDIA data sheet); like the hits, it
// depends on the data and is worked out from each run's.
//
// Design. As in the push SpMM, one thread block owns one chunk (and one
// tile of `lanes` batch columns along grid y) and walks the chunk's
// contiguous tiles tile_ptr[c]:tile_ptr[c+1] up to cl[c]; thread (b, r)
// owns chunk row r and batch column b, so a warp's gathers of
// X[col, b0:b0+32] are one 128-byte read; each kept tile's cols are staged
// in shared memory once and read as a broadcast. Thread (b, r) reads
// nf[v, b] once and keeps its own pending flag: it adds nothing once its
// (v, b) has hit or was never pending. The block skips a tile, the load of
// its cols included, as soon as no thread of it is pending
// (__syncthreads_or, which is also the barrier that protects the staged
// tile), and a tile whose SlimWork mask bit is 0 before any load.
// Known limit: one block per chunk is unbalanced on sigma-sorted power-law
// graphs, whose first chunks hold hundreds of tiles; a block stops early
// only when all of its rows and columns have hit.
#include "semiring.cuh"

namespace {

template <int SR>
__global__ void pull_mm_kernel(const int* __restrict__ cols,
                               const int* __restrict__ tile_ptr,
                               const int* __restrict__ row_vertex,
                               const int* __restrict__ cl,
                               const bool* __restrict__ tile_mask,
                               const bool* __restrict__ nf,
                               const typename Semiring<SR>::T* __restrict__ X,
                               typename Semiring<SR>::T* __restrict__ Y,
                               int C, int L, int B) {
  using S = Semiring<SR>;
  using T = typename S::T;
  extern __shared__ int s_cols[];  // one tile: C * L column ids
  const int chunk = blockIdx.x;
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  const int r = threadIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int v = row_vertex[static_cast<size_t>(chunk) * C + r];
  bool pending = b < B && v >= 0 && nf[static_cast<size_t>(v) * B + b];
  T val = S::zero();
  const int t_begin = tile_ptr[chunk];
  const int t_end = tile_ptr[chunk + 1];
  const int len = cl[chunk];
  for (int t = t_begin; t < t_end; ++t) {
    // lim and the mask bit are the same for the whole block, so every
    // thread takes the same branches and the barriers below stay uniform
    const int lim = min(L, len - (t - t_begin) * L);  // slots before cl
    if (lim <= 0) break;  // this tile and the rest are padding
    if (tile_mask != nullptr && !tile_mask[t]) continue;  // SlimWork skip
    // no thread pending: the rest of the chunk is not needed. The barrier
    // also ends the previous tile's reads of s_cols.
    if (!__syncthreads_or(pending)) break;
    const int* tile = cols + static_cast<size_t>(t) * C * L;
    for (int i = tid; i < C * lim; i += n_threads) {
      const int rr = i / lim;
      const int o = rr * L + (i - rr * lim);
      s_cols[o] = __ldg(tile + o);
    }
    __syncthreads();
    if (pending) {
      const int* row = s_cols + r * L;
      T red = S::zero();
#pragma unroll 8
      for (int l = 0; l < lim; ++l) {
        const int c = row[l];
        if (c >= 0)
          red = S::add(red, S::edge(__ldg(X + static_cast<size_t>(c) * B + b)));
      }
      if (red != S::zero()) {  // the first hit: (v, b) takes add(zero, red)
        val = red;
        pending = false;
      }
    }
  }
  if (b < B && v >= 0) Y[static_cast<size_t>(v) * B + b] = val;
}

struct Launch {
  const int* cols;
  const int* tile_ptr;
  const int* row_vertex;
  const int* cl;
  const bool* tile_mask;
  const bool* nf;
  const void* X;
  void* Y;
  int n_chunks, C, L, B, lanes;
  cudaStream_t stream;

  template <int SR> void operator()() const {
    using T = typename Semiring<SR>::T;
    const dim3 grid(n_chunks, (B + lanes - 1) / lanes);
    const dim3 block(lanes, C);
    const size_t smem = static_cast<size_t>(C) * L * sizeof(int);
    pull_mm_kernel<SR><<<grid, block, smem, stream>>>(
        cols, tile_ptr, row_vertex, cl, tile_mask, nf,
        static_cast<const T*>(X), static_cast<T*>(Y), C, L, B);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. `tile_mask` may be null (every
// tile kept); `nf` is bool[n, B] in vertex space. `cl` holds each chunk's
// length: no slot at or past it may hold an edge. `lanes` is the
// batch-column tile of one block: a multiple of 32 with lanes * C <= 1024.
// The tile (C * L ints) must fit the default 48 KB of shared memory.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int slimsell_pull_mm(int sr_code, const void* cols,
                                const void* tile_ptr, const void* row_vertex,
                                const void* cl, const void* tile_mask,
                                const void* nf, const void* X, void* Y,
                                int n_chunks, int C, int L, int B, int lanes,
                                void* stream) {
  if (C < 1 || L < 1 || B < 1 || n_chunks < 0 || lanes < 32 ||
      lanes % 32 != 0 || lanes * C > 1024 || nf == nullptr ||
      static_cast<size_t>(C) * L * sizeof(int) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaSuccess);
  Launch launch{static_cast<const int*>(cols),
                static_cast<const int*>(tile_ptr),
                static_cast<const int*>(row_vertex),
                static_cast<const int*>(cl),
                static_cast<const bool*>(tile_mask),
                static_cast<const bool*>(nf), X, Y, n_chunks, C, L, B, lanes,
                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_semiring(sr_code, launch));
}

extern "C" const char* slimsell_pull_mm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
