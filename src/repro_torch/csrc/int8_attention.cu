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
// m'), ℓ = ℓα + Σp, acc = acc·α + p·(v·v_scale); the flush is acc / ℓ.
// A row folds only the 128-token tiles from the one holding its first
// visible key to the one holding its last, so its running max is finite
// after the first fold and a masked logit (−1e30) gives p = 0 exactly:
// the TPU kernel's fold of p = 1 over a tile the row cannot see at all
// (wiped later by α = 0) never arises, and every row has ℓ > 0.
//
// What bounds it: at s = 1536 the 2·s²/2·d int8 operations of QKᵀ and
// as many f32 operations of P·V (operations; the int8 Q/K/V bytes are
// small). Design: as the chunked-prefill kernel: a CTA owns 16 query
// rows, streams 128-token K/V tiles into shared memory, and each of its
// four warps folds four rows; within a row lane l owns tokens l + 32i for
// the logits (__dp4a, head_dim a multiple of 4 up to 128) and dims
// l + 32j of the output. One head gives s/16 CTAs (96 at s = 1536), fewer
// than the card's 132 SMs.
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
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash prefill
// ---------------------------------------------------------------------------

constexpr int kTile = 128;                 // tokens per K/V tile
constexpr int kPfWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kPfWarps * kRowsPerWarp;   // query rows per CTA
constexpr int kMaxD = 128;
constexpr int kMaxW = kMaxD / 4;
constexpr int kKStride = kMaxW + 1;        // odd word stride: no bank conflicts

__device__ __forceinline__ int first_key(int r, int causal, int window) {
  return (causal && window) ? max(0, r - window + 1) : 0;
}

__device__ __forceinline__ int key_end(int r, int s, int causal) {
  return causal ? r + 1 : s;
}

__global__ void __launch_bounds__(kPfWarps * 32)
flash_prefill_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ qsc,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     float* __restrict__ out, int s, int d, int causal,
                     int window, float softmax_scale) {
  __shared__ int q_s[kRows][kMaxW];
  __shared__ int k_s[kTile][kKStride];
  __shared__ __align__(16) int8_t v_s[kTile][kMaxD];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ float p_s[kPfWarps][kTile];

  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dw = d >> 2;
  const int r_last = min(r0 + kRows, s) - 1;

  for (int i = tid; i < kRows * kMaxW; i += blockDim.x) {
    const int r = i / kMaxW, w = i % kMaxW;
    q_s[r][w] = (r0 + r < s && w < dw)
        ? reinterpret_cast<const int*>(q + static_cast<size_t>(r0 + r) * d)[w] : 0;
  }
  // tiles any row of the CTA can see
  const int jt_lo = first_key(r0, causal, window) / kTile;
  const int jt_hi = (key_end(r_last, s, causal) + kTile - 1) / kTile;

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = REPRO_NEG_INF;
    l_r[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int jt = jt_lo; jt < jt_hi; ++jt) {
    const int t0 = jt * kTile;
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < kTile * dw; i += blockDim.x) {
      const int t = i / dw, w = i % dw;
      int kv = 0, vv = 0;
      if (t0 + t < s) {
        const size_t base = static_cast<size_t>(t0 + t) * d;
        kv = reinterpret_cast<const int*>(k + base)[w];
        vv = reinterpret_cast<const int*>(v + base)[w];
      }
      k_s[t][w] = kv;
      reinterpret_cast<int*>(v_s[t])[w] = vv;
    }
    for (int t = tid; t < kTile; t += blockDim.x) {
      const bool in = t0 + t < s;
      ks_s[t] = in ? ksc[t0 + t] : 0.0f;
      vs_s[t] = in ? vsc[t0 + t] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int rl = warp * kRowsPerWarp + ri;
      const int r = r0 + rl;
      const int lo = first_key(r, causal, window), hi = key_end(r, s, causal);
      if (r >= s || t0 >= hi || t0 + kTile <= lo) continue;   // warp-uniform
      const float qs = qsc[r];
      float sv[4];
      float bmax = REPRO_NEG_INF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = lane + 32 * i;
        int dot = 0;
        for (int w = 0; w < dw; ++w) dot = __dp4a(q_s[rl][w], k_s[t][w], dot);
        const float x = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), qs), ks_s[t]),
                                  softmax_scale);
        const int kpos = t0 + t;
        sv[i] = (kpos >= lo && kpos < hi) ? x : REPRO_NEG_INF;
        bmax = fmaxf(bmax, sv[i]);
      }
      bmax = warp_max(bmax);
      const float m_new = fmaxf(m_r[ri], bmax);
      const float alpha = expf(m_r[ri] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sv[i] - m_new);
        p_s[warp][lane + 32 * i] = p;
        psum = __fadd_rn(psum, p);
      }
      psum = warp_sum(psum);
      l_r[ri] = __fadd_rn(__fmul_rn(l_r[ri], alpha), psum);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dd = lane + 32 * j;
        if (dd < d) {
          float part = 0.0f;
          for (int t = 0; t < kTile; ++t)
            part = fmaf(p_s[warp][t], __fmul_rn(static_cast<float>(v_s[t][dd]), vs_s[t]), part);
          acc[ri][j] = __fadd_rn(__fmul_rn(acc[ri][j], alpha), part);
        }
      }
      m_r[ri] = m_new;
      __syncwarp();
    }
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int r = r0 + warp * kRowsPerWarp + ri;
    if (r >= s) continue;
    float* dst = out + static_cast<size_t>(r) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = lane + 32 * j;
      if (dd < d) dst[dd] = __fdiv_rn(acc[ri][j], l_r[ri]);
    }
  }
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

int repro_flash_prefill_max_d() { return kMaxD; }

// One head. q/k/v int8 [s, d]; q/k/v scales f32 [s]; out f32 [s, d].
// d % 4 == 0, d ≤ 128, s ≥ 1.
int repro_flash_prefill(const void* q, const void* k, const void* v,
                        const void* qs, const void* ks, const void* vs,
                        void* out, int s, int d, int causal, int window,
                        float softmax_scale, void* stream) {
  const int grid = (s + kRows - 1) / kRows;
  flash_prefill_kernel<<<grid, kPfWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
