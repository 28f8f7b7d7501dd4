// The four BFS semirings as compile-time policies for the SlimSell kernels.
// The integer codes match `Semiring.code` in repro_torch/core/semiring.py:
//   0 tropical (min, x+1, zero +inf)   float
//   1 real     (sum, x,   zero 0)      float
//   2 boolean  (max, x,   zero 0)      int32
//   3 selmax   (max, x,   zero 0)      float
//   5 minplus  (min, w+x, zero +inf)   float, stored weights only
// (code 4, boolean_packed, has no case here: the packed sweeps have
// kernels of their own, slimsell_spmv_packed.cu and slimsell_spmm_packed.cu)
// minplus multiplies the gathered value by a stored slot weight (`mul`),
// never by the implicit edge value, so `dispatch_semiring` (the implicit
// sweeps' switch) has no case for it.
// `edge` is mul(implicit edge value 1, x): the value is worked out here and
// never loaded (SlimSell stores no `val`). A padding slot (col < 0) is
// skipped, which is the same as contributing `zero`.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

enum SemiringCode { TROPICAL = 0, REAL = 1, BOOLEAN = 2, SELMAX = 3, MINPLUS = 5 };

template <int SR> struct Semiring;

template <> struct Semiring<TROPICAL> {
  using T = float;
  __device__ static T zero() { return CUDART_INF_F; }
  __device__ static T edge(T x) { return x + 1.0f; }
  __device__ static T add(T a, T b) { return fminf(a, b); }
};

template <> struct Semiring<REAL> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T edge(T x) { return x; }
  __device__ static T add(T a, T b) { return a + b; }
};

template <> struct Semiring<BOOLEAN> {
  using T = int;
  __device__ static T zero() { return 0; }
  __device__ static T edge(T x) { return x; }
  __device__ static T add(T a, T b) { return max(a, b); }
};

template <> struct Semiring<SELMAX> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T edge(T x) { return x; }
  __device__ static T add(T a, T b) { return fmaxf(a, b); }
};

// A float add and a min: no product, so no FMA can form, and the min is
// order-free; the result is bit-equal to the plain version's.
template <> struct Semiring<MINPLUS> {
  using T = float;
  __device__ static T zero() { return CUDART_INF_F; }
  __device__ static T mul(T w, T x) { return w + x; }
  __device__ static T add(T a, T b) { return fminf(a, b); }
};

// Calls f.template operator()<SR>() for a runtime semiring code; returns
// cudaErrorInvalidValue for an unknown code.
template <typename F> cudaError_t dispatch_semiring(int code, F f) {
  switch (code) {
    case TROPICAL: f.template operator()<TROPICAL>(); break;
    case REAL: f.template operator()<REAL>(); break;
    case BOOLEAN: f.template operator()<BOOLEAN>(); break;
    case SELMAX: f.template operator()<SELMAX>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
