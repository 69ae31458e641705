// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/cuda/_build.py): raw device pointers, int shapes, the device index
// and the caller's stream. It launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace sde {

// dtype codes shared with the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// ---- tensor-core and async-copy building blocks (sm_90a) ---------------

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A (16x16, row-major) * B (16x8, column-major), bf16 in, fp32 sums.
// Not volatile: it only reads and writes registers, so the compiler may
// schedule it around the fragment loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: with lanes 0-15 pointing at
// rows 0..15 of a row-major (m, k) block at columns k0..k0+7 and lanes
// 16-31 at the same rows, columns k0+8..k0+15, r is the A fragment
// (a0..a3) of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: with lanes 0-15 pointing at rows k = 0..15 of a
// row-major (k, n) block at columns n0..n0+7 and lanes 16-31 at the same
// rows, columns n0+8..n0+15, r[0], r[1] are the B fragment (b0, b1) of
// mma.m16n8k16 for columns n0.., r[2], r[3] for n0+8...
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from device memory to shared memory without passing through
// registers; with `valid` false the 16 bytes are zero-filled and nothing
// is read (src must still be a device address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until all but the newest N cp.async groups this thread committed
// have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace sde
