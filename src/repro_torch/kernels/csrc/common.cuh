// Helpers shared by the port's CUDA kernels. Every csrc/<name>.cu is its
// own shared library with a plain C interface and includes this header
// once, so the extern "C" error string below is defined once per library.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// Reductions over aligned groups of 16 lanes (lanes 0-15 and 16-31 apart).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// One 16-byte load of Vec<T>::n elements, widened to f32. p must be
// 16-byte aligned (the wrappers check bases and strides).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) out[i] = to_f32(e[i]);
}

// Call f.operator()<T, D>() for the instantiated head widths; false when D
// is not one of them.
template <typename T, typename F>
bool dispatch_d(int D, const F& f) {
  switch (D) {
    case 16: f.template operator()<T, 16>(); return true;
    case 32: f.template operator()<T, 32>(); return true;
    case 64: f.template operator()<T, 64>(); return true;
    case 128: f.template operator()<T, 128>(); return true;
    default: return false;
  }
}

// dtype: 0 = float32, 1 = bfloat16.
template <typename F>
bool dispatch_dtype_d(int dtype, int D, const F& f) {
  if (dtype == 0) return dispatch_d<float>(D, f);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, f);
  return false;
}

// Call f.operator()<T, G, D>() for the instantiated (G, D).
template <typename T, typename F>
bool dispatch_gd(int G, int D, const F& f) {
#define REPRO_D(GG)                                              \
  switch (D) {                                                   \
    case 16: f.template operator()<T, GG, 16>(); return true;    \
    case 32: f.template operator()<T, GG, 32>(); return true;    \
    case 64: f.template operator()<T, GG, 64>(); return true;    \
    case 128: f.template operator()<T, GG, 128>(); return true;  \
    default: return false;                                       \
  }
  switch (G) {
    case 1: REPRO_D(1)
    case 2: REPRO_D(2)
    case 3: REPRO_D(3)
    case 4: REPRO_D(4)
    case 6: REPRO_D(6)
    case 8: REPRO_D(8)
    default: return false;
  }
#undef REPRO_D
}

template <typename F>
bool dispatch_dtype_gd(int dtype, int G, int D, const F& f) {
  if (dtype == 0) return dispatch_gd<float>(G, D, f);
  if (dtype == 1) return dispatch_gd<__nv_bfloat16>(G, D, f);
  return false;
}

// Allow `kernel` the dynamic shared memory it launches with (above 48 KB
// a kernel must opt in). Idempotent, so a race between first callers is
// harmless.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Resident blocks per SM, registers per thread and shared bytes (static +
// dynamic) of `kernel` launched with `threads` threads on this device.
template <typename K>
cudaError_t occupancy(K* kernel, int threads, size_t dyn_smem, int* blocks,
                      int* regs, int* smem) {
  cudaError_t err = allow_smem(kernel, dyn_smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + dyn_smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                       dyn_smem);
}

// D**-0.5 rounded once to f32, as the JAX kernels' Python-float scale.
inline float inv_sqrt(int D) { return (float)(1.0 / sqrt((double)D)); }

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
