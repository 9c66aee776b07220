// Helpers shared by the port's CUDA kernels (sm_90a, nvcc, no fast-math).
//
// Exactness rules every kernel follows:
//   * the absmax barrier rounds half to even (rintf) and divides with
//     __fdiv_rn, so its int8 values and scales are bitwise the plain
//     PyTorch version's;
//   * float steps that the plain version runs as separate ops (scale
//     products, the bias add) use __fmul_rn / __fadd_rn so nvcc cannot
//     contract them into an FMA;
//   * every reduction runs in a fixed order (per-thread sequential, then
//     an xor-shuffle tree, then warps in index order), so a result is a
//     function of its own inputs only.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Absmax barrier scale: max(amax, 1e-5) / 127.
__device__ __forceinline__ float barrier_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-5f), 127.0f);
}

// clip(round_half_even(x / scale), -127, 127) as int8.
__device__ __forceinline__ int8_t barrier_quantize(float x, float scale) {
  float q = rintf(__fdiv_rn(x, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}
