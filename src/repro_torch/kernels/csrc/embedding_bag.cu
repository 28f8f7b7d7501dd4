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
// time is (the ids + each distinct row the ids name, once + out) over its
// 3.35 TB/s of HBM bandwidth (the same sheet). In a table far larger than
// L2 each row read is a cold 4*d-byte read from HBM; a small table's rows
// are read from HBM once and then hit L2.
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
// jnp.take in the JAX package's oracle) does. Bags are read through
// element strides, so a strided [B, K] view (one field of DLRM's
// [B, 26, K] ids) needs no copy.
//
// One kernel takes all T tables of a DLRM forward in one launch: the T
// table pointers and row counts passed by value in the launch's parameters
// (read through the constant cache, no device array to keep), the
// [B, T, K] ids through three element strides (DLRM's batch["sparse"]
// read in place) and an output with strides for B and T (for example the
// [B, 1 + T, d] tensor the interaction stacks). The grid is (bags / 8,
// table, slice): a warp owns one (bag, table, slice) with no index
// division, and blocks go out table by table, so a small table's rows stay
// in L2 while its bags are summed. One table is the case T = 1. Not done
// here (a later step): a warp over several bags for small d, row prefetch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlice = 128;          // floats of d one warp owns
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTables = 128;   // tables of one launch (2 KB of parameters)

// One warp's (bag, slice): the sum (or mean) of the rows the bag's K ids
// name in `table` [V, d], columns base..base+127, into o[base..].
template <bool VEC>
__device__ __forceinline__ void bag_slice(const float* __restrict__ table,
                                          long long V,
                                          const int* __restrict__ bag,
                                          long long stride_k, int K, int d,
                                          int base, bool mean,
                                          float* __restrict__ o) {
  const int lane = threadIdx.x & 31;
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
  o += base;
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

// The launch's tables: at most kMaxTables pointers and row counts.
struct Tables {
  const float* ptr[kMaxTables];
  long long rows[kMaxTables];
};

template <bool VEC>
__global__ void bag_kernel(const __grid_constant__ Tables tables,
                           const int* __restrict__ bags, long long stride_b,
                           long long stride_t, long long stride_k,
                           float* __restrict__ out, long long out_b,
                           long long out_t, int B, int K, int d, bool mean) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int t = blockIdx.y;
  bag_slice<VEC>(tables.ptr[t], tables.rows[t],
                 bags + b * stride_b + t * stride_t, stride_k, K, d,
                 blockIdx.z * kSlice, mean, out + b * out_b + t * out_t);
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tables` is a host array of T
// pointers to float32 [V_t, d] row-major contiguous tables on the device,
// `rows` a host array of the V_t; 1 <= T <= kMaxTables. bags int32
// [B, T, K] at element strides (stride_b, stride_t, stride_k); out float32
// with out[b, t, :] at b * out_b + t * out_t, contiguous along d. mode_mean
// 0 sums, 1 takes the mean. Any B, K >= 0, d >= 1. Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
extern "C" int embedding_bag_grouped(const void* const* tables,
                                     const long long* rows, int T,
                                     const void* bags, long long stride_b,
                                     long long stride_t, long long stride_k,
                                     void* out, long long out_b,
                                     long long out_t, int B, int K, int d,
                                     int mode_mean, void* stream) {
  const int slices = d < 1 ? 0 : (d + kSlice - 1) / kSlice;
  if (B < 0 || T < 1 || T > kMaxTables || K < 0 || d < 1 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Tables tabs;
  bool vec = d % 4 == 0 && out_b % 4 == 0 && out_t % 4 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int t = 0; t < T; ++t) {
    if (rows[t] < 0) return static_cast<int>(cudaErrorInvalidValue);
    tabs.ptr[t] = static_cast<const float*>(tables[t]);
    tabs.rows[t] = rows[t];
    vec = vec && reinterpret_cast<uintptr_t>(tables[t]) % 16 == 0;
  }
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock, T, slices);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int*>(bags);
  auto* o = static_cast<float*>(out);
  if (vec)
    bag_kernel<true><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        tabs, g, stride_b, stride_t, stride_k, o, out_b, out_t, B, K, d,
        mode_mean != 0);
  else
    bag_kernel<false><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        tabs, g, stride_b, stride_t, stride_k, o, out_b, out_t, B, K, d,
        mode_mean != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
