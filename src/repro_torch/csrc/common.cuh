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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// signed byte k of w as a float, exactly: 2^23 + (b + 128) − (2^23 + 128)
__device__ __forceinline__ float byte_to_float(unsigned w, int k) {
  const unsigned x = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 + k);
  return __fsub_rn(__uint_as_float(x), 8388736.0f);
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

// Fixed-order reductions over a CTA of kWarps warps (thread sequential →
// warp tree → warps 0..kWarps−1); ``red`` holds kWarps entries. All
// threads get the result.
template <int kWarps>
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

template <int kWarps>
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = __fadd_rn(r, red[w]);
  return r;
}

template <int kWarps>
__device__ int block_max_int(int v, int* red) {
  v = warp_max_int(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < kWarps; ++w) r = max(r, red[w]);
  return r;
}

// Four packed LOP nibbles (sgn << 3 | LO, dims 0..3 from the low nibble
// up) → their pot values as four int8: ±2^LO, 0 for LO 7. Three byte
// permutes and no table: |pot| from the bytes of 2^LO, −|pot| from their
// negations, the sign bit of each nibble picking between the two.
__device__ __forceinline__ int pot4(unsigned h) {
  const unsigned sel = h & 0x7777u;
  const unsigned pos = __byte_perm(0x08040201u, 0x00402010u, sel);   // 1 .. 64, 0
  const unsigned neg = __byte_perm(0xF8FCFEFFu, 0x00C0E0F0u, sel);   // −1 .. −64, 0
  return static_cast<int>(__byte_perm(pos, neg, 0x3210u | ((h >> 1) & 0x4444u)));
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to the card's maximum and
// prefer the largest shared-memory carveout, once per kernel and device
// (`done` holds kMaxDevices flags), so no launch after the first pays for
// it.
template <class K>
cudaError_t prepare(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}
