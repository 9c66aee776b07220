// Chunked-prefill int8 attention for Hopper (sm_90a).
//
// Replaces the Pallas body src/repro/kernels/prefill_attention.py:
// _fused_prefill_kernel (fused_prefill_attention).
//
// What it computes, per (batch·kv-head) lane and query row r = g·chunk + t
// at global position qpos = q_off + t: causal (optionally windowed) int8
// attention over the capacity-padded cache [0, kv_len), logits scaled as
// ((s·k_scale)·q_scale)·softmax_scale, an online softmax in f32 whose fold
// zeroes fully-masked positions (p = 0) and whose flush divides only where
// ℓ > 0 (an empty lane emits exact zero).
//
// What bounds it: the f32 P·V, 2·d operations per visible (row, key)
// pair; the int8 K/V of a lane is read once per 16-row slab.
//
// Design: the shared tile core of int8_flash.cuh (int8 tensor-core
// logits, key tiles split over 4 warps by absolute index and merged in
// warp order, register-tiled f32 P·V, cp.async double buffering). Grid
// (lane, 16-row slab): a 128-row chunk of 32 lanes is 256 CTAs of 4
// warps, two per SM. Slabs launch last-first, so under causal masking the
// slabs that see the most keys start first and the short ones fill the
// tail. A row's bits depend on the row alone, so chunked prefill is
// bitwise whole-prompt prefill on the card (see the core's header).
#include "int8_flash.cuh"

namespace {

using int8_flash::kRows;
constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32, 2)
prefill_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
               const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const int* __restrict__ kv_len, float* __restrict__ out,
               int R, int M, int d, int hkv, int chunk, int q_off, int causal,
               int window, float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * R;
  const size_t k_row0 = static_cast<size_t>(bh) * M;
  int8_flash::Slab a;
  a.q = qi + q_row0 * d;
  a.qs = qsc + q_row0;
  a.k = kc + k_row0 * d;
  a.v = vc + k_row0 * d;
  a.ks = ksc + k_row0;
  a.vs = vsc + k_row0;
  a.out = out + q_row0 * d;
  a.n_rows = R;
  a.M = M;
  a.d = d;
  a.r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  a.q_off = q_off;
  a.chunk = chunk;
  a.kv_len = kv_len[bh / hkv];
  a.causal = causal;
  a.window = window;
  a.softmax_scale = softmax_scale;
  int8_flash::fold_slab<kWarps, /*kKScaleFirst=*/true>(a, smem);
}

}  // namespace

extern "C" {

int repro_prefill_max_d() { return int8_flash::kMaxD; }

int repro_prefill_warps() { return kWarps; }

int repro_prefill_rows() { return kRows; }

size_t repro_prefill_smem_bytes(int d) { return int8_flash::smem_bytes(kWarps, d); }

// qi int8 [BH, R, d]; qsc f32 [BH, R]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; kv_len int32 [B]; out f32 [BH, R, d]. d % 4 == 0, d ≤ 128.
int repro_prefill_attention(const void* qi, const void* qsc, const void* k,
                            const void* v, const void* ks, const void* vs,
                            const void* kv_len, void* out, int BH, int R,
                            int M, int d, int hkv, int chunk, int q_off,
                            int causal, int window, float softmax_scale,
                            void* stream) {
  const size_t smem = int8_flash::smem_bytes(kWarps, d);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (R + kRows - 1) / kRows);
  prefill_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(kv_len), static_cast<float*>(out), R, M, d, hkv,
      chunk, q_off, causal, window, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
