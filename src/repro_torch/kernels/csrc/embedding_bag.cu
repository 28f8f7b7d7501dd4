// Embedding bag for Hopper (sm_90a): DLRM's sparse lookup.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py:_bag_kernel
// (wrapper embedding_bag_pallas): out[b, :] = sum over the slots k of bag b
// whose id is not a pad (-1) of table[bags[b, k], :]; under mean, divided by
// max(count, 1), the count of ids that are not pads.
//
// What bounds it: bytes. A bag reads K ids and up to K table rows of 4*d
// bytes each and writes one row, with one add per element read, far below
// an H100 SXM's float32 rate (67 TFLOP/s, NVIDIA data sheet); the least
// time is (the ids + the rows the ids name + out) over its 3.35 TB/s of HBM
// bandwidth (the same sheet). The rows lie at random in tables far larger
// than L2, so each row read is a cold 4*d-byte read from HBM.
//
// Design. The Pallas kernel walks bags in a sequential grid and pulls each
// slot's row slice from HBM into VMEM with one DMA, start and wait. Here
// one warp owns one (bag, 128-float slice of d): each lane holds 4 floats
// of the slice, so a row slice is one coalesced 512-byte read (as one
// float4 a lane where d % 4 == 0 and the pointers are 16-byte aligned,
// else as 4 scalars a lane 32 floats apart, the path a d of 16 or 130
// takes). The warp loops over the K slots in order and adds in registers,
// acc += row, the order of the plain version, so the two agree bit for bit.
// A pad adds nothing and is not counted; the lanes past d in the last slice
// read nothing. Row offsets are 64-bit (idx * d), so a table past 2^31
// elements is read right. An id at or past V is outside the contract: the
// kernel never reads it and makes its bag NaN, as the plain version (and
// jnp.take in the JAX package's oracle) does. Bags are read through two
// element strides, so a strided [B, K] view (one field of DLRM's
// [B, 26, K] ids) needs no copy. Not done here (a later step): a warp over
// several bags for small d, all tables in one launch, row prefetch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 128;          // floats of d one warp owns
constexpr int kWarpsPerBlock = 8;

template <bool VEC>
__global__ void bag_kernel(const float* __restrict__ table,
                           const int* __restrict__ bags,
                           long long stride_b, long long stride_k,
                           float* __restrict__ out, long long n_warps,
                           int slices, int K, int d, long long V, bool mean) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const long long b = w / slices;
  const int base = static_cast<int>(w % slices) * kSlice;
  const int* bag = bags + b * stride_b;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cnt = 0;
  bool outside = false;
  for (int k = 0; k < K; ++k) {
    const int idx = __ldg(bag + k * stride_k);
    if (idx < 0) continue;  // a pad
    ++cnt;
    if (idx >= V) {  // outside the table: never read
      outside = true;
      continue;
    }
    const float* row = table + static_cast<long long>(idx) * d + base;
    if constexpr (VEC) {
      const int c = lane * 4;
      if (base + c < d) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
        acc[0] += v.x;
        acc[1] += v.y;
        acc[2] += v.z;
        acc[3] += v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (base + c < d) acc[j] += __ldg(row + c);
      }
    }
  }
  const float div = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (outside) acc[j] = __int_as_float(0x7fc00000);  // quiet NaN
    else if (mean) acc[j] = acc[j] / div;
  }
  float* o = out + b * d + base;
  if constexpr (VEC) {
    const int c = lane * 4;
    if (base + c < d)
      *reinterpret_cast<float4*>(o + c) = make_float4(acc[0], acc[1], acc[2],
                                                      acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (base + c < d) o[c] = acc[j];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. table float32 [V, d] row-major
// and contiguous; bags int32 [B, K] at element strides (stride_b,
// stride_k); out float32 [B, d] contiguous. mode_mean 0 sums, 1 takes the
// mean. Any B >= 0, K >= 0, d >= 1. Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int embedding_bag(const void* table, const void* bags,
                             long long stride_b, long long stride_k,
                             void* out, int B, int K, int d, long long V,
                             int mode_mean, void* stream) {
  if (B < 0 || K < 0 || d < 1 || V < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int slices = (d + kSlice - 1) / kSlice;
  const long long n_warps = static_cast<long long>(B) * slices;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* g = static_cast<const int*>(bags);
  auto* o = static_cast<float*>(out);
  if (vec)
    bag_kernel<true><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                       s>>>(t, g, stride_b, stride_k, o, n_warps, slices, K,
                            d, V, mode_mean != 0);
  else
    bag_kernel<false><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                        s>>>(t, g, stride_b, stride_k, o, n_warps, slices, K,
                             d, V, mode_mean != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
