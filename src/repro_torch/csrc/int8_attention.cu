// Standalone int8 attention kernels for Hopper (sm_90a): single-head
// flash prefill and single-kv-head block-sparse decode, the two entries of
// src/repro/kernels/int8_attention.py.
//
// ---- flash prefill ----
// Replaces the Pallas kernel int8_flash_prefill (_flash_prefill_kernel).
//
// What it computes, for one head of s tokens: row r attends to keys
// k ≤ r (causal), r − k < window as well (sliding window), or every key
// (non-causal), with logits ((dot·q_scale)·k_scale)·softmax_scale and an
// online softmax in f32: m' = max(m, max s), α = exp(m − m'), p = exp(s −
// m') with p = 0 where s ≤ −1e30/2, ℓ = ℓα + Σp, acc = acc·α + p·(v·v_scale);
// the flush is acc / ℓ. A fold never sees p = 1 over a tile the row
// cannot see (the TPU kernel's fold, wiped later by α = 0): a masked
// logit gives p = 0, so such a tile is a no-op, and every row has ℓ > 0.
//
// What bounds it: at s = 1536 the s²/2·2d f32 operations of P·V (the
// int8 QKᵀ runs on the tensor cores; the int8 Q/K/V bytes are small).
// Design: the shared tile core of int8_flash.cuh — the chunked-prefill
// kernel's fold with one lane, qpos = r and kv_len = M = s. One head
// gives only s/16 CTAs (96 at s = 1536, for 132 SMs), one per SM, so a
// CTA runs 8 warps (137 KB of shared memory at d 100): two warps per
// scheduler instead of one, and the longest warp folds 6 of the last
// slab's 48 key tiles instead of 12. Slabs launch last-first, the longest
// first.
//
// ---- block-sparse decode ----
// Replaces the Pallas kernel sparse_decode_attention
// (_sparse_decode_kernel).
//
// What it computes, per lane (one query-head group over one kv head):
// the caller's block_idx blocks are walked in the given order; a block
// with gate 0 is skipped; inside a block, tokens outside [start, end) get
// the logit −1e30; the online softmax is the prefill one with the TPU
// kernel's arithmetic (no p = 0 guard), and the flush divides only where
// ℓ > 0, so a lane whose gates are all 0 emits exact zero. Lanes are the
// batch axis a vmap over (batch, kv-head, group) gives the TPU kernel;
// ``share`` consecutive lanes read the same cache lane, as the vmap
// broadcasts one kv head's cache over its query heads. A block index is
// clamped into the cache, as the reference's gather does.
//
// What bounds it: bytes — the selected blocks of int8 K/V and their f32
// scales (≈ 2·d + 8 bytes a token). Design: one CTA (128 threads) per
// lane; a block's K/V words are copied into shared memory, a thread per
// token forms the logit with __dp4a, a thread per output dim the value
// sum; every reduction has a fixed order.
#include "int8_flash.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash prefill
// ---------------------------------------------------------------------------

constexpr int kFlashWarps = 8;

__global__ void __launch_bounds__(kFlashWarps * 32, 1)
flash_prefill_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ qsc,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     float* __restrict__ out, int s, int d, int causal,
                     int window, float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_flash::Slab a;
  a.q = q;
  a.qs = qsc;
  a.k = k;
  a.v = v;
  a.ks = ksc;
  a.vs = vsc;
  a.out = out;
  a.n_rows = s;
  a.M = s;
  a.d = d;
  a.r0 = (gridDim.x - 1 - blockIdx.x) * int8_flash::kRows;
  a.q_off = 0;
  a.chunk = s;
  a.kv_len = s;
  a.causal = causal;
  a.window = window;
  a.softmax_scale = softmax_scale;
  int8_flash::fold_slab<kFlashWarps, /*kKScaleFirst=*/false>(a, smem);
}

// ---------------------------------------------------------------------------
// block-sparse decode
// ---------------------------------------------------------------------------

constexpr int kSdThreads = 128;
constexpr int kSdWarps = kSdThreads / 32;

// Shared layout: k tile int [block·dw] | v tile int [block·dw] | qw int
// [G·dw] | ks, vs, p f32 [block] | acc f32 [G·d] | m, l f32 [G] | red
// [kSdWarps]
__host__ __device__ inline size_t sparse_smem_bytes(int G, int d, int block) {
  const int dw = d / 4;
  return sizeof(int) * (2 * static_cast<size_t>(block) * dw + G * dw)
       + sizeof(float) * (3 * block + G * d + 2 * G + kSdWarps);
}

__global__ void __launch_bounds__(kSdThreads)
sparse_decode_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
                     const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     const int* __restrict__ block_idx,
                     const int* __restrict__ gate_tokens, float* __restrict__ out,
                     int G, int M, int d, int nb, int share, int block,
                     float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = d / 4;
  int* k_s = reinterpret_cast<int*>(smem);
  int* v_w = k_s + block * dw;
  const int8_t* v_s = reinterpret_cast<const int8_t*>(v_w);
  int* qw = v_w + block * dw;
  float* ks_s = reinterpret_cast<float*>(qw + G * dw);
  float* vs_s = ks_s + block;
  float* p_s = vs_s + block;
  float* acc = p_s + block;
  float* m_s = acc + G * d;
  float* l_s = m_s + G;
  float* red = l_s + G;

  const int ln = blockIdx.x, tid = threadIdx.x;
  const size_t cache_tok = static_cast<size_t>(ln / share) * M;
  const int* idx = block_idx + static_cast<size_t>(ln) * nb;
  const int* gt = gate_tokens + static_cast<size_t>(ln) * 3 * nb;
  const int8_t* q_lane = qi + static_cast<size_t>(ln) * G * d;
  const int n_blocks = M / block;

  for (int i = tid; i < G * dw; i += kSdThreads)
    qw[i] = reinterpret_cast<const int*>(q_lane)[i];
  for (int i = tid; i < G * d; i += kSdThreads) acc[i] = 0.0f;
  for (int i = tid; i < G; i += kSdThreads) { m_s[i] = REPRO_NEG_INF; l_s[i] = 0.0f; }
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    if (gt[j] <= 0) continue;                        // CTA-uniform
    const int t0 = min(max(idx[j], 0), n_blocks - 1) * block;
    const int end = gt[nb + j], start = gt[2 * nb + j];
    const int* k_src = reinterpret_cast<const int*>(kc + (cache_tok + t0) * d);
    const int* v_src = reinterpret_cast<const int*>(vc + (cache_tok + t0) * d);
    for (int i = tid; i < block * dw; i += kSdThreads) {
      k_s[i] = k_src[i];
      v_w[i] = v_src[i];
    }
    for (int t = tid; t < block; t += kSdThreads) {
      ks_s[t] = ksc[cache_tok + t0 + t];
      vs_s[t] = vsc[cache_tok + t0 + t];
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const float qs = qsc[static_cast<size_t>(ln) * G + g];
      const int* qg = qw + g * dw;
      float lmax = REPRO_NEG_INF;
      for (int t = tid; t < block; t += kSdThreads) {
        int dot = 0;
        for (int w = 0; w < dw; ++w) dot = __dp4a(qg[w], k_s[t * dw + w], dot);
        float sv = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), qs), ks_s[t]),
                             softmax_scale);
        if (t < start || t >= end) sv = REPRO_NEG_INF;
        p_s[t] = sv;
        lmax = fmaxf(lmax, sv);
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, block_max<kSdWarps>(lmax, red));
      const float alpha = expf(m_prev - m_new);
      float lsum = 0.0f;
      for (int t = tid; t < block; t += kSdThreads) {
        const float p = expf(p_s[t] - m_new);
        p_s[t] = p;
        lsum = __fadd_rn(lsum, p);
      }
      const float psum = block_sum<kSdWarps>(lsum, red);   // ends in __syncthreads
      for (int dd = tid; dd < d; dd += kSdThreads) {
        float part = 0.0f;
        for (int t = 0; t < block; ++t)
          part = fmaf(p_s[t], __fmul_rn(static_cast<float>(v_s[t * d + dd]), vs_s[t]), part);
        acc[g * d + dd] = __fadd_rn(__fmul_rn(acc[g * d + dd], alpha), part);
      }
      __syncthreads();
      if (tid == 0) {
        l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), psum);
        m_s[g] = m_new;
      }
      __syncthreads();
    }
  }

  float* o = out + static_cast<size_t>(ln) * G * d;
  for (int i = tid; i < G * d; i += kSdThreads) {
    const float l = l_s[i / d];
    o[i] = __fdiv_rn(acc[i], l > 0.0f ? l : 1.0f);
  }
}

}  // namespace

extern "C" {

int repro_flash_prefill_max_d() { return int8_flash::kMaxD; }

int repro_flash_prefill_warps() { return kFlashWarps; }

int repro_flash_prefill_rows() { return int8_flash::kRows; }

size_t repro_flash_prefill_smem_bytes(int d) {
  return int8_flash::smem_bytes(kFlashWarps, d);
}

// One head. q/k/v int8 [s, d]; q/k/v scales f32 [s]; out f32 [s, d].
// d % 4 == 0, d ≤ 128, s ≥ 1.
int repro_flash_prefill(const void* q, const void* k, const void* v,
                        const void* qs, const void* ks, const void* vs,
                        void* out, int s, int d, int causal, int window,
                        float softmax_scale, void* stream) {
  const size_t smem = int8_flash::smem_bytes(kFlashWarps, d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (s + int8_flash::kRows - 1) / int8_flash::kRows;
  flash_prefill_kernel<<<grid, kFlashWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<float*>(out), s, d, causal, window, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

size_t repro_sparse_decode_smem_bytes(int G, int d, int block) {
  return sparse_smem_bytes(G, d, block);
}

// q int8 [L, G, d]; qsc f32 [L, G]; k/v int8 [C, M, d]; k/v scales f32
// [C, M] with C = L / share; block_idx int32 [L, nb]; gate_tokens int32
// [L, 3·nb]; out f32 [L, G, d]. d % 4 == 0, M % block == 0, L ≥ 1.
int repro_sparse_decode(const void* q, const void* qs, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* block_idx, const void* gate_tokens,
                        void* out, int L, int G, int M, int d, int nb,
                        int share, int block, float softmax_scale,
                        void* stream) {
  const size_t smem = sparse_smem_bytes(G, d, block);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_decode_kernel<<<L, kSdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(block_idx), static_cast<const int*>(gate_tokens),
      static_cast<float*>(out), G, M, d, nb, share, block, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
