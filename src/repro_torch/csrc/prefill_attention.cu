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
// What bounds it: at a 128-row chunk over a ~1.7k-token cache the int8
// K/V bytes of each lane (read once per CTA of 16 rows) against
// 2·R·M·d integer and float operations; at these sizes it is bound by
// latency and instruction throughput rather than at either roofline. Design: grid (lane, 16-row
// slab). The CTA streams 128-token K/V tiles into shared memory and each
// of its four warps folds four query rows; within a row, lane l owns
// tokens l + 32i for the logits (__dp4a over d padded to a multiple of 4;
// head_dim 100 needs no power of two) and dims l + 32i of the output.
//
// Chunk invariance: a row folds exactly the tiles [0, ceil(min(kv_len,
// qpos + 1) / 128)) — a function of the row alone — in order, and every
// reduction inside a tile has a fixed order. Which rows share the CTA,
// the chunk width and q_off therefore cannot change a row's bits, so
// chunked prefill is bitwise whole-prompt prefill on the card. (Tiles the
// row cannot see would be bitwise no-ops anyway: max(m, −∞) = m, ℓ += 0.)
#include "common.cuh"

namespace {

constexpr int kTile = 128;                 // tokens per K/V tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per CTA
constexpr int kMaxD = 128;
constexpr int kMaxW = kMaxD / 4;           // int32 words per row
constexpr int kKStride = kMaxW + 1;        // odd word stride: no bank conflicts

__global__ void __launch_bounds__(kWarps * 32)
prefill_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
               const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const int* __restrict__ kv_len, float* __restrict__ out,
               int R, int M, int d, int hkv, int chunk, int q_off, int causal,
               int window, float softmax_scale) {
  __shared__ int q_s[kRows][kMaxW];
  __shared__ int k_s[kTile][kKStride];
  __shared__ __align__(16) int8_t v_s[kTile][kMaxD];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ float p_s[kWarps][kTile];
  __shared__ int lim_s[kRows];

  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dw = d >> 2;
  const int kvl = kv_len[bh / hkv];
  const size_t lane_off = static_cast<size_t>(bh) * M;

  for (int i = tid; i < kRows * kMaxW; i += blockDim.x) {
    const int r = i / kMaxW, w = i % kMaxW;
    int v = 0;
    if (r0 + r < R && w < dw)
      v = reinterpret_cast<const int*>(qi + (static_cast<size_t>(bh) * R + r0 + r) * d)[w];
    q_s[r][w] = v;
  }
  if (tid < kRows) {
    const int r = r0 + tid;
    int lim = 0;
    if (r < R) {
      const int qpos = q_off + r % chunk;
      lim = causal ? min(kvl, qpos + 1) : kvl;
      lim = max(0, min(lim, M));
    }
    lim_s[tid] = lim;
  }
  __syncthreads();
  int cta_lim = 0;
  for (int i = 0; i < kRows; ++i) cta_lim = max(cta_lim, lim_s[i]);
  const int n_tiles = (cta_lim + kTile - 1) / kTile;

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = REPRO_NEG_INF;
    l_r[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int t0 = jt * kTile;
    for (int i = tid; i < kTile * dw; i += blockDim.x) {
      const int t = i / dw, w = i % dw;
      int kv = 0, vv = 0;
      if (t0 + t < M) {
        const size_t base = (lane_off + t0 + t) * d;
        kv = reinterpret_cast<const int*>(kc + base)[w];
        vv = reinterpret_cast<const int*>(vc + base)[w];
      }
      k_s[t][w] = kv;
      reinterpret_cast<int*>(v_s[t])[w] = vv;
    }
    for (int t = tid; t < kTile; t += blockDim.x) {
      const bool in = t0 + t < M;
      ks_s[t] = in ? ksc[lane_off + t0 + t] : 0.0f;
      vs_s[t] = in ? vsc[lane_off + t0 + t] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int rl = warp * kRowsPerWarp + ri;
      const int r = r0 + rl;
      if (r >= R || t0 >= lim_s[rl]) continue;          // warp-uniform
      const int qpos = q_off + r % chunk;
      const float qs = qsc[static_cast<size_t>(bh) * R + r];
      float s[4];
      float bmax = REPRO_NEG_INF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = lane + 32 * i;
        int dot = 0;
        for (int w = 0; w < dw; ++w) dot = __dp4a(q_s[rl][w], k_s[t][w], dot);
        float sv = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), ks_s[t]), qs),
                             softmax_scale);
        const int kpos = t0 + t;
        bool ok = kpos < kvl && kpos < M;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window) ok = ok && (qpos - kpos) < window;
        }
        s[i] = ok ? sv : REPRO_NEG_INF;
        bmax = fmaxf(bmax, s[i]);
      }
      bmax = warp_max(bmax);
      const float m_new = fmaxf(m_r[ri], bmax);
      const float alpha = expf(m_r[ri] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(s[i] - m_new);
        if (s[i] <= REPRO_NEG_INF / 2) p = 0.0f;       // fully-masked guard
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
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int r = r0 + warp * kRowsPerWarp + ri;
    if (r >= R) continue;
    const float l = l_r[ri] > 0.0f ? l_r[ri] : 1.0f;
    float* dst = out + (static_cast<size_t>(bh) * R + r) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = lane + 32 * j;
      if (dd < d) dst[dd] = __fdiv_rn(acc[ri][j], l);
    }
  }
}

}  // namespace

extern "C" {

int repro_prefill_max_d() { return kMaxD; }

// qi int8 [BH, R, d]; qsc f32 [BH, R]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; kv_len int32 [B]; out f32 [BH, R, d]. d % 4 == 0, d ≤ 128.
int repro_prefill_attention(const void* qi, const void* qsc, const void* k,
                            const void* v, const void* ks, const void* vs,
                            const void* kv_len, void* out, int BH, int R,
                            int M, int d, int hkv, int chunk, int q_off,
                            int causal, int window, float softmax_scale,
                            void* stream) {
  dim3 grid(BH, (R + kRows - 1) / kRows);
  prefill_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(kv_len), static_cast<float*>(out), R, M, d, hkv,
      chunk, q_off, causal, window, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
