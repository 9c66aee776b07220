// Decode attention for Hopper (sm_90a): the LOP-sparse mode and the dense
// mode of src/repro/kernels/decode_attention.py:fused_decode_attention.
//
// ---- LOP mode ----
// Replaces the Pallas body _fused_lop_kernel (LOP mode, pos_offset 0,
// per-query-head selection, no returned stats).
//
// What it computes, per (batch·kv-head) lane, in three phases:
//   screen  every LOP block's score = max over its valid tokens of the
//           integer dot pot(q)·pot(k), with pot(k) decoded from the packed
//           (sgn‖LO) nibbles; invalid tokens are INT32_MIN and a block
//           with no valid token scores −inf;
//   select  the comparison-free bucketized rank of
//           src/repro/core/lop.py:comparison_free_rank, bit for bit:
//           span = max(smax − smin, 1e-9), bucket = trunc(((s − smin) /
//           span)·64) in IEEE steps, non-finite → −1, cut = highest bucket
//           whose ≥-count reaches K, ranks in index order above the cut
//           then at it, rank ≥ K → unselected;
//   exact   candidates folded in rank order (row = c / K): int8 logits
//           over the block, scaled ((s·q_scale)·k_scale)·softmax_scale,
//           the live interval [start, end) of the block, and an online
//           softmax without a p = 0 guard; the flush divides where ℓ > 0,
//           so a lane with new_len == 0 emits exact zero.
//
// What bounds it: bytes — the feature cache (M·d/2 per lane) plus K
// selected blocks of int8 K/V, against a handful of integer ops per byte.
// Design: one CTA (128 threads) per lane, B·Hkv CTAs. The screen gives a
// thread one token of the block at a time; the select runs on one thread
// per query row over a few dozen blocks in shared memory; the exact phase
// stages only the selected K/V blocks in shared memory, a thread per token
// for the logits and per output dim for the value sum. All reductions
// have a fixed order, so the output is a function of the lane alone.
//
// ---- dense mode ----
// Replaces the Pallas body _fused_dense_kernel (use_lop=False, pos_offset
// 0, no returned stats): exact attention streamed over every K/V block.
// Per lane, blocks run in index order; a block with no valid token
// (t ≥ new_len, or before new_len − window when window is set) is skipped
// whole. Otherwise its logits ((dot·q_scale)·k_scale)·softmax_scale, with
// invalid tokens at −1e30, fold into the online softmax: m_new = max(m,
// max s), α = exp(m − m_new), ℓ = ℓα + Σp, acc = acc·α + Σ p·(v·v_scale).
// The flush divides where ℓ > 0, so new_len == 0 emits exact zero.
//
// What bounds it: bytes — every valid block of int8 K and V plus their
// f32 scales (≈ 2·d + 8 bytes a token), against 2·d int8 ops and 2·d f32
// ops a token. Design: one CTA (128 threads) per lane; a block's K/V words
// are copied contiguously into shared memory, a thread per token forms
// the logit with __dp4a, a thread per output dim forms the value sum. The
// reductions have a fixed order and no CTA reads another lane, so a
// lane's output is bitwise the same whatever the other lanes hold — the
// recovery retry, which runs one lane alone, depends on that.
#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 64;

// One row of comparison_free_rank over nb block scores (single thread).
__device__ void rank_row(const float* s, int* rank, int nb, int k) {
  float smin = CUDART_INF_F, smax = -CUDART_INF_F;
  for (int j = 0; j < nb; ++j) {
    if (isfinite(s[j])) { smin = fminf(smin, s[j]); smax = fmaxf(smax, s[j]); }
  }
  const float span = fmaxf(__fsub_rn(smax, smin), 1e-9f);
  int hist[kBuckets];
  for (int b = 0; b < kBuckets; ++b) hist[b] = 0;
  for (int j = 0; j < nb; ++j) {
    int b = -1;
    if (isfinite(s[j])) {
      const float ratio = __fmul_rn(__fdiv_rn(__fsub_rn(s[j], smin), span),
                                    static_cast<float>(kBuckets));
      b = min(max(static_cast<int>(ratio), 0), kBuckets - 1);
      hist[b] += 1;
    }
    rank[j] = b;                         // bucket, for now
  }
  int cut = 0, ge = 0;
  for (int b = kBuckets - 1; b >= 0; --b) {
    ge += hist[b];
    if (ge >= k) { cut = b; break; }
  }
  int n_above = 0;
  for (int j = 0; j < nb; ++j) n_above += rank[j] > cut;
  int seen_above = 0, seen_cut = 0;
  const int big = nb + k + 1;
  for (int j = 0; j < nb; ++j) {
    const int b = rank[j];
    int r = big;
    if (b > cut) r = seen_above++;
    else if (b == cut) r = n_above + seen_cut++;
    rank[j] = r < k ? r : big;
  }
}

// Shared layout (dynamic): blk f32 [G·nb] | rank int [G·nb] | cand int
// [G·K] | qpot int [G·d] | qw int [G·dw] | k tile int [block·kstr] | v tile
// int8 [block·dpad] | ks, vs, p f32 [block] | acc f32 [G·d] | m, l f32 [G]
// | red [kWarps]
__host__ __device__ inline size_t smem_bytes(int G, int nb, int d, int block,
                                             int k_keep) {
  const int dw = d / 4, kstr = dw | 1, dpad = (d + 3) & ~3;
  return sizeof(float) * (2 * static_cast<size_t>(G) * nb + G * k_keep
                          + G * d + G * dw + block * kstr)
       + static_cast<size_t>(block) * dpad
       + sizeof(float) * (3 * block + G * d + 2 * G + kWarps);
}

__global__ void __launch_bounds__(kThreads)
lop_decode_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
                  const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                  const float* __restrict__ ksc, const float* __restrict__ vsc,
                  const uint8_t* __restrict__ feat,
                  const int* __restrict__ new_len, float* __restrict__ out,
                  int G, int M, int d, int hkv, int block, int k_keep,
                  int window, float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = M / block;
  const int dw = d / 4, kstr = dw | 1, dpad = (d + 3) & ~3, dh = d / 2;
  float* blk = reinterpret_cast<float*>(smem);
  int* rank = reinterpret_cast<int*>(blk + G * nb);
  int* cand = rank + G * nb;
  int* qpot = cand + G * k_keep;
  int* qw = qpot + G * d;
  int* k_s = qw + G * dw;
  int8_t* v_s = reinterpret_cast<int8_t*>(k_s + block * kstr);
  float* ks_s = reinterpret_cast<float*>(v_s + block * dpad);
  float* vs_s = ks_s + block;
  float* p_s = vs_s + block;
  float* acc = p_s + block;
  float* m_s = acc + G * d;
  float* l_s = m_s + G;
  float* red = l_s + G;
  int* red_i = reinterpret_cast<int*>(red);

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int nl = new_len[bh / hkv];
  const size_t lane_tok = static_cast<size_t>(bh) * M;
  const int8_t* q_lane = qi + static_cast<size_t>(bh) * G * d;

  for (int i = tid; i < G * d; i += kThreads) {
    const int qv = q_lane[i];
    const int mag = qv == 0 ? 0 : (1 << (31 - __clz(abs(qv))));
    qpot[i] = qv < 0 ? -mag : mag;
    acc[i] = 0.0f;
  }
  for (int i = tid; i < G * dw; i += kThreads)
    qw[i] = reinterpret_cast<const int*>(q_lane)[i];
  for (int i = tid; i < G; i += kThreads) { m_s[i] = REPRO_NEG_INF; l_s[i] = 0.0f; }
  for (int i = tid; i < G * k_keep; i += kThreads) cand[i] = -1;
  __syncthreads();

  // ---- screen: per-block max of the surrogate scores ----
  for (int jb = 0; jb < nb; ++jb) {
    const int lo = max(jb * block, window ? nl - window : 0);
    const int hi = min((jb + 1) * block, nl);
    for (int g = 0; g < G; ++g) {
      const int* qp = qpot + g * d;
      int best = INT_MIN;
      for (int t = tid; t < block; t += kThreads) {
        const int tpos = jb * block + t;
        if (tpos >= lo && tpos < hi) {
          const uint8_t* f = feat + (lane_tok + tpos) * dh;
          int sc = 0;
          for (int e = 0; e < dh; ++e) {
            const int byte = f[e];
            sc += qp[2 * e] * nib_pot(byte & 0xF) + qp[2 * e + 1] * nib_pot(byte >> 4);
          }
          best = max(best, sc);
        }
      }
      best = block_max_int<kWarps>(best, red_i);
      if (tid == 0)
        blk[g * nb + jb] = lo < hi ? static_cast<float>(best) : -CUDART_INF_F;
    }
  }
  __syncthreads();

  // ---- select: comparison-free ranks, then candidates in rank order ----
  for (int g = tid; g < G; g += kThreads) {
    rank_row(blk + g * nb, rank + g * nb, nb, k_keep);
    for (int j = 0; j < nb; ++j) {
      const int r = rank[g * nb + j];
      if (r < k_keep) cand[g * k_keep + r] = j;
    }
  }
  __syncthreads();

  // ---- exact: fold the selected blocks in rank order ----
  for (int c = 0; c < G * k_keep; ++c) {
    const int idx = cand[c];
    if (idx < 0) continue;                       // block-uniform
    const int g = c / k_keep;
    const int t0 = idx * block;
    for (int i = tid; i < block * dw; i += kThreads) {
      const int t = i / dw, w = i % dw;
      const size_t base = (lane_tok + t0 + t) * d;
      k_s[t * kstr + w] = reinterpret_cast<const int*>(kc + base)[w];
      reinterpret_cast<int*>(v_s + t * dpad)[w] = reinterpret_cast<const int*>(vc + base)[w];
    }
    for (int t = tid; t < block; t += kThreads) {
      ks_s[t] = ksc[lane_tok + t0 + t];
      vs_s[t] = vsc[lane_tok + t0 + t];
    }
    __syncthreads();
    const float qs = qsc[static_cast<size_t>(bh) * G + g];
    const int end = min(max(nl - t0, 0), block);
    const int tstart = window ? min(max(nl - window - t0, 0), block) : 0;
    float lmax = REPRO_NEG_INF;
    for (int t = tid; t < block; t += kThreads) {
      int dot = 0;
      for (int w = 0; w < dw; ++w) dot = __dp4a(qw[g * dw + w], k_s[t * kstr + w], dot);
      float s = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), qs), ks_s[t]),
                          softmax_scale);
      if (t < tstart || t >= end) s = REPRO_NEG_INF;
      p_s[t] = s;
      lmax = fmaxf(lmax, s);
    }
    const float m_prev = m_s[g];
    const float m_new = fmaxf(m_prev, block_max<kWarps>(lmax, red));
    const float alpha = expf(m_prev - m_new);
    float lsum = 0.0f;
    for (int t = tid; t < block; t += kThreads) {
      const float p = expf(p_s[t] - m_new);
      p_s[t] = p;
      lsum = __fadd_rn(lsum, p);
    }
    const float psum = block_sum<kWarps>(lsum, red);     // ends in __syncthreads
    for (int dd = tid; dd < d; dd += kThreads) {
      float part = 0.0f;
      for (int t = 0; t < block; ++t)
        part = fmaf(p_s[t], __fmul_rn(static_cast<float>(v_s[t * dpad + dd]), vs_s[t]), part);
      acc[g * d + dd] = __fadd_rn(__fmul_rn(acc[g * d + dd], alpha), part);
    }
    __syncthreads();
    if (tid == 0) {
      l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), psum);
      m_s[g] = m_new;
    }
    __syncthreads();
  }

  // ---- flush ----
  float* o = out + static_cast<size_t>(bh) * G * d;
  for (int i = tid; i < G * d; i += kThreads) {
    const float l = l_s[i / d];
    o[i] = __fdiv_rn(acc[i], l > 0.0f ? l : 1.0f);
  }
}

// Shared layout (dynamic): k tile int [block·dw] | v tile int8 [block·dw·4]
// | qw int [G·dw] | ks, vs, p f32 [block] | acc f32 [G·d] | m, l f32 [G]
// | red [kWarps]
__host__ __device__ inline size_t dense_smem_bytes(int G, int d, int block) {
  const int dw = d / 4;
  return sizeof(int) * (2 * static_cast<size_t>(block) * dw + G * dw)
       + sizeof(float) * (3 * block + G * d + 2 * G + kWarps);
}

__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const int8_t* __restrict__ qi,
                    const float* __restrict__ qsc,
                    const int8_t* __restrict__ kc,
                    const int8_t* __restrict__ vc,
                    const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ new_len, float* __restrict__ out,
                    int G, int M, int d, int hkv, int block, int window,
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

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int nl = min(max(new_len[bh / hkv], 0), M);
  const int lo_tok = window ? max(nl - window, 0) : 0;
  const size_t lane_tok = static_cast<size_t>(bh) * M;
  const int8_t* q_lane = qi + static_cast<size_t>(bh) * G * d;

  for (int i = tid; i < G * dw; i += kThreads)
    qw[i] = reinterpret_cast<const int*>(q_lane)[i];
  for (int i = tid; i < G * d; i += kThreads) acc[i] = 0.0f;
  for (int i = tid; i < G; i += kThreads) { m_s[i] = REPRO_NEG_INF; l_s[i] = 0.0f; }
  __syncthreads();

  // blocks holding at least one valid token: [jb_lo, jb_hi); the rest are
  // the reference's skipped tiles
  const int jb_lo = lo_tok / block;
  const int jb_hi = (nl + block - 1) / block;
  for (int jb = jb_lo; jb < jb_hi; ++jb) {
    const int t0 = jb * block;
    const int* k_src = reinterpret_cast<const int*>(kc + (lane_tok + t0) * d);
    const int* v_src = reinterpret_cast<const int*>(vc + (lane_tok + t0) * d);
    for (int i = tid; i < block * dw; i += kThreads) {
      k_s[i] = k_src[i];
      v_w[i] = v_src[i];
    }
    for (int t = tid; t < block; t += kThreads) {
      ks_s[t] = ksc[lane_tok + t0 + t];
      vs_s[t] = vsc[lane_tok + t0 + t];
    }
    __syncthreads();
    const int tstart = max(lo_tok - t0, 0);       // live tokens [tstart, end)
    const int end = min(nl - t0, block);
    for (int g = 0; g < G; ++g) {
      const float qs = qsc[static_cast<size_t>(bh) * G + g];
      const int* qg = qw + g * dw;
      float lmax = REPRO_NEG_INF;
      for (int t = tid; t < block; t += kThreads) {
        int dot = 0;
        for (int w = 0; w < dw; ++w) dot = __dp4a(qg[w], k_s[t * dw + w], dot);
        float s = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), qs), ks_s[t]),
                            softmax_scale);
        if (t < tstart || t >= end) s = REPRO_NEG_INF;
        p_s[t] = s;
        lmax = fmaxf(lmax, s);
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, block_max<kWarps>(lmax, red));
      const float alpha = expf(m_prev - m_new);
      float lsum = 0.0f;
      for (int t = tid; t < block; t += kThreads) {
        const float p = expf(p_s[t] - m_new);
        p_s[t] = p;
        lsum = __fadd_rn(lsum, p);
      }
      const float psum = block_sum<kWarps>(lsum, red);   // ends in __syncthreads
      for (int dd = tid; dd < d; dd += kThreads) {
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

  float* o = out + static_cast<size_t>(bh) * G * d;
  for (int i = tid; i < G * d; i += kThreads) {
    const float l = l_s[i / d];
    o[i] = __fdiv_rn(acc[i], l > 0.0f ? l : 1.0f);
  }
}

}  // namespace

extern "C" {

size_t repro_decode_smem_bytes(int G, int nb, int d, int block, int k_keep) {
  return smem_bytes(G, nb, d, block, k_keep);
}

// qi int8 [BH, G, d]; qsc f32 [BH, G]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; feat uint8 [BH, M, d/2]; new_len int32 [B]; out f32
// [BH, G, d]. d % 4 == 0, M % block == 0.
int repro_lop_decode_attention(const void* qi, const void* qsc, const void* k,
                               const void* v, const void* ks, const void* vs,
                               const void* feat, const void* new_len,
                               void* out, int BH, int G, int M, int d, int hkv,
                               int block, int k_keep, int window,
                               float softmax_scale, void* stream) {
  const size_t smem = smem_bytes(G, M / block, d, block, k_keep);
  cudaError_t err = cudaFuncSetAttribute(
      lop_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lop_decode_kernel<<<BH, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(feat), static_cast<const int*>(new_len),
      static_cast<float*>(out), G, M, d, hkv, block, k_keep, window,
      softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

size_t repro_dense_decode_smem_bytes(int G, int d, int block) {
  return dense_smem_bytes(G, d, block);
}

// qi int8 [BH, G, d]; qsc f32 [BH, G]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; new_len int32 [B]; out f32 [BH, G, d]. d % 4 == 0,
// M % block == 0.
int repro_dense_decode_attention(const void* qi, const void* qsc,
                                 const void* k, const void* v, const void* ks,
                                 const void* vs, const void* new_len,
                                 void* out, int BH, int G, int M, int d,
                                 int hkv, int block, int window,
                                 float softmax_scale, void* stream) {
  const size_t smem = dense_smem_bytes(G, d, block);
  cudaError_t err = cudaFuncSetAttribute(
      dense_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_decode_kernel<<<BH, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(new_len), static_cast<float*>(out), G, M, d,
      hkv, block, window, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
