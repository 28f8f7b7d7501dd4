// The semiring table of the CUDA kernels (semiring.cuh), evaluated on the
// card: the analysis layer's behavioural check that the table the kernels
// compile agrees with the port's PyTorch table (repro_torch/core/
// semiring.py), value for value (repro_torch/analysis/laws.py,
// cross_check_kernel_tables). Not a sweep: it reads no layout.
//
// semiring_probe(code, xs, n, zero, edge, add, mul, stream) takes n <= 32
// values of the semiring's type T (float, or int for boolean) and writes,
// in one block of n * n threads:
//   zero[0]         Semiring<code>::zero()
//   add[i * n + j]  Semiring<code>::add(xs[i], xs[j])
//   edge[i]         Semiring<code>::edge(xs[i])       (implicit semirings)
//   mul[i * n + j]  Semiring<code>::mul(xs[i], xs[j]) (minplus: w + x)
// An unknown code, one with no struct in the table (4, boolean_packed,
// whose sweeps have kernels of their own) or n outside [1, 32] returns
// cudaErrorInvalidValue without a launch.
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

template <int SR>
__global__ void probe_kernel(const void* xs, int n, void* zero, void* edge,
                             void* add, void* mul) {
  using S = Semiring<SR>;
  using T = typename S::T;
  const T* x = static_cast<const T*>(xs);
  const int t = threadIdx.x;
  if (t >= n * n) return;
  const int i = t / n, j = t % n;
  static_cast<T*>(add)[t] = S::add(x[i], x[j]);
  if (t == 0) static_cast<T*>(zero)[0] = S::zero();
  if constexpr (SR == MINPLUS) {
    static_cast<T*>(mul)[t] = S::mul(x[i], x[j]);
  } else {
    if (j == 0) static_cast<T*>(edge)[i] = S::edge(x[i]);
  }
}

template <int SR>
void launch(const void* xs, int n, void* zero, void* edge, void* add,
            void* mul, cudaStream_t stream) {
  probe_kernel<SR><<<1, n * n, 0, stream>>>(xs, n, zero, edge, add, mul);
}

}  // namespace

extern "C" int semiring_probe(int code, const void* xs, int n, void* zero,
                              void* edge, void* add, void* mul,
                              void* stream) {
  if (n < 1 || n > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
    case TROPICAL: launch<TROPICAL>(xs, n, zero, edge, add, mul, s); break;
    case REAL: launch<REAL>(xs, n, zero, edge, add, mul, s); break;
    case BOOLEAN: launch<BOOLEAN>(xs, n, zero, edge, add, mul, s); break;
    case SELMAX: launch<SELMAX>(xs, n, zero, edge, add, mul, s); break;
    case MINPLUS: launch<MINPLUS>(xs, n, zero, edge, add, mul, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* semiring_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
