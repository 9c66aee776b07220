// The split-lane decode core shared by the port's three decode-attention
// kernels (decode_attention.cu: #4 LOP, folding a lane's K selected blocks
// in rank order; #5 dense, folding every live block in index order;
// int8_attention.cu: #9 block-sparse decode, folding a caller-given list
// of blocks in list order). It folds a list of one lane's K/V blocks, each
// with its live interval [tstart, end), into per-query-row online-softmax
// state and merges the lane's CTAs into the output row.
//
// What it computes, for query row g of a lane over one block at t0:
//   s_t = ((dot(q_g, k_t)·q_scale_g)·k_scale_t)·softmax_scale (the int32
//   dot exact, each product one __fmul_rn), −1e30 outside [tstart, end);
//   then an online softmax over 32-token chunks: m' = max(m, max s),
//   α = exp(m − m'), p = exp(s − m') on live tokens (0 elsewhere),
//   ℓ = ℓα + Σp, acc = acc·α + Σ_t fmaf(p_t·vs_t, v_t). The flush divides
//   (IEEE) only where ℓ > 0, so a lane with no live token emits exact zero.
//   #9 folds with kMasked, the TPU sparse decode kernel's arithmetic: p =
//   exp(s − m') for every token of a folded block, masked ones too (1
//   while m is still −1e30, 0 once a live token has set it), so a lane
//   whose folded blocks hold no live token emits the mean of their V.
//
// What bounds it on the H100: bytes, then latency. Per live token it reads
// 2·d + 8 bytes of int8 K/V and f32 scales against 2·d int8 and 2·d f32
// operations; a B = 4 step of bitnet-3b (32 lanes a sequence, d 100, M
// 1664, new_len [1600, 0, 700, 1200]) is ~23 MB, ~7 µs at 3.35 TB/s. One
// CTA a lane would leave 128 CTAs of 4 warps on 132 SMs, each streaming
// its lane's blocks one after another. At this size a call is also a
// chain of fixed latencies — the launch, the first copies, the cluster
// barriers — so the design keeps every CTA of a step resident at once.
//
// Design:
//  * Split lanes, flash-decoding style. A lane's nb = M / block blocks are
//    cut into shares of share_of(nb) = ⌈nb / 8⌉ consecutive blocks, one CTA
//    each: split_of(nb) CTAs a lane, one thread-block cluster (≤ 8, the
//    portable size), grid (split, lanes). Each CTA folds its share and the
//    cluster merges the partial states through distributed shared memory
//    in the fixed order of the CTA rank: m* = max m_c, ℓ = Σ ℓ_c·e^{m_c −
//    m*}, acc = Σ acc_c·e^{m_c − m*}, each CTA flushing a slice of the
//    lane's G·d outputs. No atomics, no scratch buffer, one launch.
//  * The split is a function of the lane's shape alone (nb = M / block),
//    never of the number of lanes, any lane's new_len or an occupancy
//    query. A lane's bits are then the same whatever the other lanes hold
//    (the recovery retry runs one lane with the others at new_len 0) and
//    whatever the batch (the scheduler and lockstep decode one request at
//    different B). A block outside a CTA's live range is not folded, and
//    an empty partial (m = −1e30, ℓ = 0, acc = 0) merges as a no-op, so a
//    lane with new_len 0 still emits exact zero.
//  * A two-stage cp.async ring of 16-byte copies, whose steps are half
//    blocks: a block's K rows + k scales, then its V rows + v scales.
//    While one half is computed on, the next is in flight; a stage stays
//    at block·d + 4·block bytes (13 KB at d 100). #4/#5 take the ring's
//    depth as the tile sweep's knob (kMaxStages: 2, 3 or 4 stages, the
//    counterpart of the TPU kernel's n_slots): only how far ahead the
//    copies run changes, never the order of a fold, so every depth gives
//    the same bits.
//  * One query row (G = 1, block ≤ 128: bitnet-3b's shape) keeps each
//    warp's online-softmax state and each token's logit in registers
//    (Warp<true>; thread t forms token t's logit and folds it), so a CTA
//    needs only the ring, q and (LOP) the screen's few hundred bytes:
//    27 KB, eight CTAs an SM under __launch_bounds__(128, 8), and the
//    7 × 128 CTAs of a B = 4 step fit the card's 139 resident clusters.
//    Other shapes keep the state in shared memory (Warp<false>), which
//    at this shape holds only 84 (LOP) or 101 (dense) clusters of 7, so
//    a B = 4 step's last lanes would wait for a second wave
//    (scripts/decode_ablation.py, "state in smem").
//  * Logits with __dp4a, a thread a (row, token), over K rows at d bytes
//    (an odd number of words at d 100: 4-byte loads free of bank
//    conflicts).
//  * P·V splits the tokens over the warps: warp w takes the 32-token
//    chunks ≡ w (mod 4) of each block into its own (m, ℓ, acc) and lane l
//    the output words l and l + 32 (dims 4l .. 4l + 3), dequantizing with
//    a byte permute (byte_to_float), in a loop with no branch (tokens that
//    are not live weigh 0), so the loads and shuffles of later tokens
//    issue ahead. The warps merge in order 0..3 into the CTA's partial,
//    then the cluster merges the CTAs.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace int8_decode {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;            // the ring's default depth
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;          // the portable cluster size

// A lane's blocks are cut into shares of share_of(nb) blocks, one CTA each.
__host__ __device__ inline int share_of(int nb) {
  return (nb + kMaxSplit - 1) / kMaxSplit;
}
__host__ __device__ inline int split_of(int nb) {
  const int s = share_of(nb);
  return (nb + s - 1) / s;
}

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// One query row and a block no longer than the CTA (G == 1, block ≤
// kThreads): thread t then both forms token t's logit and folds it, so a
// warp's online-softmax state and the logits stay in registers (Warp<true>).
__host__ __device__ inline bool one_row(int G, int block) {
  return G == 1 && block <= kThreads;
}

// Shared memory (dynamic), byte offsets: the ring (after the last fold:
// the CTA's partial m, ℓ f32 [G] and acc f32 [G][d]) | q int8 [G][d] |
// the logits s f32 [G][block] | per warp m, ℓ f32 [kWarps][G] and acc f32
// [kWarps][G][d] (for one_row: over the ring, written after the last fold
// from the registers) | LOP only: pot(q) int8 [G][d], block scores f32
// [G][nb], ranks int [G][nb], candidates int [G·K], this CTA's candidates
// int [G·K] and their count, per-warp screen maxima int [share][kWarps][G].
struct Layout {
  int stage, q, s, wm, wl, wacc, cm, cl, cacc;
  int qpot, blk, rank, cand, mine, wbest, total;
};

__host__ __device__ inline Layout layout(int G, int nb, int d, int block,
                                         int k_keep, bool lop,
                                         int stages = kStages) {
  Layout L;
  const int f_part = lop ? up16(block * d / 2) : 0;
  L.stage = max(up16(block * d) + up16(4 * block), f_part);
  int o = 0;
  auto take = [&o](int bytes) {
    const int at = o;
    o += up16(bytes);
    return at;
  };
  // written after the last fold, so over the ring
  L.cm = take(4 * G);
  L.cl = take(4 * G);
  L.cacc = take(4 * G * d);
  const bool one = one_row(G, block);
  if (one) {
    L.s = o;
    L.wm = take(4 * kWarps * G);
    L.wl = take(4 * kWarps * G);
    L.wacc = take(4 * kWarps * G * d);
  }
  o = max(o, stages * L.stage);
  L.q = take(G * d);
  if (!one) {
    L.s = take(4 * G * block);
    L.wm = take(4 * kWarps * G);
    L.wl = take(4 * kWarps * G);
    L.wacc = take(4 * kWarps * G * d);
  }
  L.qpot = lop ? take(G * d) : o;
  L.blk = lop ? take(4 * G * nb) : o;
  L.rank = lop ? take(4 * G * nb) : o;
  L.cand = lop ? take(4 * G * k_keep) : o;
  L.mine = lop ? take(4 * (G * k_keep + 1)) : o;
  L.wbest = lop ? take(4 * share_of(nb) * kWarps * G) : o;
  L.total = o;
  return L;
}

// One lane's operands, already offset to the lane, and its live tokens
// [lo, hi) in cache rows (row t sits at global position pos_offset + t:
// live where that is < new_len, ≥ new_len − window when window is set,
// and t < M).
struct Lane {
  const int8_t* q;      // [G, d]
  const float* qs;      // [G]
  const int8_t* k;      // [M, d]
  const int8_t* v;      // [M, d]
  const float* ks;      // [M]
  const float* vs;      // [M]
  float* out;           // [G, d]
  float* m_out;         // [G] merged running max, or nullptr
  float* l_out;         // [G] merged ℓ, or nullptr
  int G, M, d, block, lo, hi;
  float softmax_scale;
};

// Lane `lane`'s q, q scales and out, cache lane `cache_lane`'s K/V and
// their scales; no live tokens yet.
__device__ inline Lane lane_at(const int8_t* qi, const float* qsc,
                               const int8_t* kc, const int8_t* vc,
                               const float* ksc, const float* vsc, float* out,
                               int lane, int cache_lane, int G, int M, int d,
                               int block, float softmax_scale) {
  const size_t tok = static_cast<size_t>(cache_lane) * M;
  Lane ln;
  ln.q = qi + static_cast<size_t>(lane) * G * d;
  ln.qs = qsc + static_cast<size_t>(lane) * G;
  ln.k = kc + tok * d;
  ln.v = vc + tok * d;
  ln.ks = ksc + tok;
  ln.vs = vsc + tok;
  ln.out = out + static_cast<size_t>(lane) * G * d;
  ln.m_out = ln.l_out = nullptr;
  ln.G = G;
  ln.M = M;
  ln.d = d;
  ln.block = block;
  ln.lo = ln.hi = 0;
  ln.softmax_scale = softmax_scale;
  return ln;
}

// The lane of #4/#5: lane = cache lane = blockIdx.y, live tokens from its
// sequence's global new_len, the window and the global position of row 0
// (pos_offset: a cache shard of the sequence-parallel path); the (m, ℓ)
// stats go to m_out / l_out [lanes, G] where given.
__device__ inline Lane make_lane(const int8_t* qi, const float* qsc,
                                 const int8_t* kc, const int8_t* vc,
                                 const float* ksc, const float* vsc,
                                 const int* new_len, float* out, float* m_out,
                                 float* l_out, int G, int M, int d, int hkv,
                                 int block, int window, int pos_offset,
                                 float softmax_scale) {
  const int bh = blockIdx.y;
  const int nl = new_len[bh / hkv] - pos_offset;    // in cache rows
  Lane ln = lane_at(qi, qsc, kc, vc, ksc, vsc, out, bh, bh, G, M, d, block,
                    softmax_scale);
  ln.lo = window ? max(nl - window, 0) : 0;
  ln.hi = min(max(nl, 0), M);
  if (m_out != nullptr) {
    ln.m_out = m_out + static_cast<size_t>(bh) * G;
    ln.l_out = l_out + static_cast<size_t>(bh) * G;
  }
  return ln;
}

// Live blocks of the lane: [jb_lo, jb_hi) (empty where lo ≥ hi).
__device__ __forceinline__ void live_blocks(const Lane& ln, int* jb_lo, int* jb_hi) {
  if (ln.lo >= ln.hi) {
    *jb_lo = *jb_hi = 0;
    return;
  }
  *jb_lo = ln.lo / ln.block;
  *jb_hi = (ln.hi + ln.block - 1) / ln.block;
}

// Live tokens [tstart, end) of block j, relative to its first token.
__device__ __forceinline__ void interval(const Lane& ln, int j, int* tstart, int* end) {
  const int t0 = j * ln.block;
  *tstart = min(max(ln.lo - t0, 0), ln.block);
  *end = min(max(ln.hi - t0, 0), ln.block);
}

// ---- a caller-given block list (#9) ----
// Entry i of a lane's list of nb names block clamp(idx_i, 0, M/block − 1)
// with live tokens [start_i, end_i) and is skipped where gate_i ≤ 0
// (gate_tokens = [gate ‖ end ‖ start]); CTA r of the lane's split_of(nb)
// folds entries [r·share_of(nb), (r + 1)·share_of(nb)) in order (its lane
// from lane_at, the interval from the list). A CTA's gathered entries sit
// after the layout's bytes: their count, then (block, tstart, end) each.
__host__ __device__ inline int list_bytes(int nb) {
  return up16(4 * (1 + 3 * share_of(nb)));
}

// Warp 1 gathers the gated entries among [i0, i1) of a lane's list (idx,
// gt already offset to the lane) into `list`, in order, clamping block
// and interval; the caller syncs before reading it. (Warp 1, so that at
// G = 1 its loads overlap begin()'s load of q, which warp 0 issues.)
__device__ inline void gather_list(const int* idx, const int* gt, int nb,
                                   int i0, int i1, int block, int n_blocks,
                                   int* list) {
  if ((threadIdx.x >> 5) != 1) return;
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = i0; base < i1; base += 32) {
    const int i = base + lane;
    const bool on = i < i1 && gt[i] > 0;
    const unsigned ball = __ballot_sync(0xffffffffu, on);
    if (on) {
      int* e = list + 1 + 3 * (n + __popc(ball & ((1u << lane) - 1u)));
      e[0] = min(max(idx[i], 0), n_blocks - 1);
      e[1] = min(max(gt[2 * nb + i], 0), block);
      e[2] = min(max(gt[nb + i], 0), block);
    }
    n += __popc(ball);
  }
  if (lane == 0) list[0] = n;
}

// A warp's online-softmax state: for one_row in registers (s: this
// thread's token's logit; m, ℓ the same in every lane; a: the lane's output
// words), else in shared memory (L.s, L.wm, L.wl, L.wacc).
template <bool kOne> struct Warp;
template <> struct Warp<true> { float s, m, l, a[2][4]; };
template <> struct Warp<false> {};

// Load q, reset every warp's state. Ends in __syncthreads.
template <bool kOne>
__device__ void begin(const Lane& ln, unsigned char* smem, const Layout& L,
                      Warp<kOne>& st) {
  const int G = ln.G, d = ln.d;
  int* q_w = reinterpret_cast<int*>(smem + L.q);
  for (int i = threadIdx.x; i < G * d / 4; i += kThreads)
    q_w[i] = reinterpret_cast<const int*>(ln.q)[i];
  if constexpr (kOne) {
    st.s = st.m = REPRO_NEG_INF;
    st.l = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.a[h][e] = 0.0f;
  } else {
    float* wm = reinterpret_cast<float*>(smem + L.wm);
    float* wl = reinterpret_cast<float*>(smem + L.wl);
    float* wacc = reinterpret_cast<float*>(smem + L.wacc);
    for (int i = threadIdx.x; i < kWarps * G; i += kThreads) {
      wm[i] = REPRO_NEG_INF;
      wl[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < kWarps * G * d; i += kThreads) wacc[i] = 0.0f;
  }
  __syncthreads();
}

// Start the copy of half `part` (0: K rows + k scales, 1: V rows + v
// scales) of block j into a stage, 16 bytes a copy.
__device__ __forceinline__ void issue_half(const Lane& ln, unsigned char* stage,
                                           int j, int part) {
  const int d = ln.d, block = ln.block, t0 = j * block;
  const int8_t* src = (part ? ln.v : ln.k) + static_cast<size_t>(t0) * d;
  for (int i = threadIdx.x; i < block * d / 16; i += kThreads)
    cp_async16(stage + 16 * i, src + 16 * i, 16);
  const int rows = up16(block * d);
  const float* sc = (part ? ln.vs : ln.ks) + t0;
  for (int i = threadIdx.x; i < block / 4; i += kThreads)
    cp_async16(stage + rows + 16 * i, sc + 4 * i, 16);
}

// The ring: items 0 .. n−1 through S stages. issue(i, stage) starts item
// i's copies; setup() runs once the first copies are in flight (so its own
// global loads overlap them); consume(i, stage) runs on item i with every
// thread of the CTA, between two __syncthreads.
template <int S = kStages, class Issue, class Setup, class Consume>
__device__ __forceinline__ void ring(unsigned char* stages, int stage_bytes,
                                     int n, Issue issue, Setup setup,
                                     Consume consume) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) issue(s, stages + s * stage_bytes);
    cp_async_commit();
  }
  setup();
  for (int i = 0; i < n; ++i) {
    const int nx = i + S - 1;
    if (nx < n) issue(nx, stages + (nx % S) * stage_bytes);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    consume(i, stages + (i % S) * stage_bytes);
    __syncthreads();
  }
}

// ((dot(q row, K row t)·q_scale)·k_scale_t)·softmax_scale of one token;
// `stage` holds the block's K half.
__device__ __forceinline__ float logit(const Lane& ln, const unsigned char* smem,
                                       const Layout& L, const unsigned char* stage,
                                       int g, int t) {
  const int d = ln.d;
  const int* qr = reinterpret_cast<const int*>(smem + L.q + g * d);
  const int* kr = reinterpret_cast<const int*>(stage + t * d);
  const float* ks = reinterpret_cast<const float*>(stage + up16(ln.block * d));
  int dot = 0;
#pragma unroll 4
  for (int w = 0; w < d / 4; ++w) dot = __dp4a(qr[w], kr[w], dot);
  return __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), ln.qs[g]), ks[t]),
                   ln.softmax_scale);
}

// Logits of rows [g0, g1) over the block whose K half sits in `stage`,
// −1e30 outside [tstart, end): into s[g][t], or (one_row) into the
// register of the thread that folds token t.
template <bool kOne>
__device__ void logits(const Lane& ln, unsigned char* smem, const Layout& L,
                       const unsigned char* stage, int g0, int g1, int tstart,
                       int end, Warp<kOne>& st) {
  const int block = ln.block;
  if constexpr (kOne) {
    const int t = threadIdx.x;
    if (t < block)
      st.s = t >= tstart && t < end ? logit(ln, smem, L, stage, 0, t)
                                    : REPRO_NEG_INF;
  } else {
    float* s_buf = reinterpret_cast<float*>(smem + L.s);
    for (int i = threadIdx.x; i < (g1 - g0) * block; i += kThreads) {
      const int g = g0 + i / block, t = i % block;
      s_buf[g * block + t] = t >= tstart && t < end
                                 ? logit(ln, smem, L, stage, g, t)
                                 : REPRO_NEG_INF;
    }
  }
}

// a[h][e] += Σ_j pw_j · v[j][word lane + 32h][e] over a chunk's n tokens
// (rows at dw words; pw_j lives in lane j and is 0 where token j is not
// live), in increasing j. No branch in the loop, so the loads and
// shuffles of later tokens issue ahead; lanes past the row's words read
// its last word and their sums are never stored.
template <int kH>
__device__ __forceinline__ void value_sum(float (&a)[2][4], const unsigned* rows,
                                          int dw, int n, float pw, int lane) {
  int wo[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) wo[h] = min(lane + 32 * h, dw - 1);
  auto step = [&](int j) {
    const float wj = __shfl_sync(0xffffffffu, pw, j);
    const unsigned* row = rows + j * dw;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const unsigned v4 = row[wo[h]];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[h][e] = fmaf(wj, byte_to_float(v4, e), a[h][e]);
    }
  };
  if (n == 32) {
#pragma unroll 8
    for (int j = 0; j < 32; ++j) step(j);
  } else {
#pragma unroll 4
    for (int j = 0; j < n; ++j) step(j);
  }
}

// One 32-token chunk (c0 .. c0 + n − 1, tokens [lo, hi) live) into a
// warp's (m, ℓ, a); s is this lane's token's logit (−1e30 where not live).
// kMasked: every token of the chunk weighs p = exp(s − m'), as the TPU's
// sparse decode kernel takes it — 0 once a live token has set m, but 1
// while m is still −1e30 (wiped by α = 0 when a live token comes); else
// only live tokens weigh (p = 0 elsewhere).
template <bool kMasked>
__device__ __forceinline__ void fold_chunk(float s, const unsigned* v_w,
                                           const float* vs, int dw, int c0,
                                           int n, int lo, int hi, float& m,
                                           float& l, float (&a)[2][4]) {
  const int lane = threadIdx.x & 31, t = c0 + lane;
  const bool live = kMasked ? lane < n : t >= lo && t < hi;
  // the xor trees give every lane the same m, ℓ
  const float m_new = fmaxf(m, warp_max(live ? s : REPRO_NEG_INF));
  const float alpha = expf(m - m_new);
  const float p = live ? expf(s - m_new) : 0.0f;
  const float psum = warp_sum(p);
  const float pw = live ? __fmul_rn(p, vs[t]) : 0.0f;
  l = __fadd_rn(__fmul_rn(l, alpha), psum);
  m = m_new;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[h][e] = __fmul_rn(a[h][e], alpha);
  const unsigned* rows = v_w + c0 * dw;
  if (dw > 32) value_sum<2>(a, rows, dw, n, pw, lane);
  else value_sum<1>(a, rows, dw, n, pw, lane);
}

// Fold rows [g0, g1) of the block whose V half sits in `stage` into the
// warps' states: warp w takes the 32-token chunks ≡ w (mod kWarps) that
// hold live tokens (kMasked: every chunk of the block).
template <bool kMasked, bool kOne>
__device__ void fold_values(const Lane& ln, unsigned char* smem, const Layout& L,
                            const unsigned char* stage, int g0, int g1,
                            int tstart, int end, Warp<kOne>& st) {
  const int d = ln.d, dw = d / 4, block = ln.block, G = ln.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* v_w = reinterpret_cast<const unsigned*>(stage);
  const float* vs = reinterpret_cast<const float*>(stage + up16(block * d));
  for (int g = g0; g < g1; ++g) {
    for (int c0 = 32 * warp; c0 < block; c0 += 32 * kWarps) {
      const int lo = max(tstart, c0), hi = min(min(end, c0 + 32), block);
      if (!kMasked && lo >= hi) continue;            // warp-uniform
      const int n = min(32, block - c0);
      if constexpr (kOne) {
        fold_chunk<kMasked>(st.s, v_w, vs, dw, c0, n, lo, hi, st.m, st.l, st.a);
      } else {
        float* wm = reinterpret_cast<float*>(smem + L.wm) + warp * G + g;
        float* wl = reinterpret_cast<float*>(smem + L.wl) + warp * G + g;
        float* acc = reinterpret_cast<float*>(smem + L.wacc) + (warp * G + g) * d;
        const float* s_buf = reinterpret_cast<const float*>(smem + L.s);
        const int t = c0 + lane;
        float m = *wm, l = *wl, a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = lane + 32 * h;
#pragma unroll
          for (int e = 0; e < 4; ++e) a[h][e] = w < dw ? acc[4 * w + e] : 0.0f;
        }
        fold_chunk<kMasked>(t < block ? s_buf[g * block + t] : REPRO_NEG_INF,
                            v_w, vs, dw, c0, n, lo, hi, m, l, a);
        __syncwarp();
        *wm = m;
        *wl = l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = lane + 32 * h;
          if (w < dw) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * w + e] = a[h][e];
          }
        }
      }
    }
  }
}

// Fold one block, live tokens [tstart, end), for rows [g0, g1) as two
// ring items (K half, V half).
template <bool kMasked, bool kOne>
__device__ __forceinline__ void fold_part(const Lane& ln, unsigned char* smem,
                                          const Layout& L,
                                          const unsigned char* stage, int part,
                                          int tstart, int end, int g0, int g1,
                                          Warp<kOne>& st) {
  if (part == 0) logits(ln, smem, L, stage, g0, g1, tstart, end, st);
  else fold_values<kMasked>(ln, smem, L, stage, g0, g1, tstart, end, st);
}

// The same for block j of a lane whose live tokens are [lo, hi) (#4, #5).
template <bool kOne>
__device__ __forceinline__ void fold_half(const Lane& ln, unsigned char* smem,
                                          const Layout& L,
                                          const unsigned char* stage, int part,
                                          int j, int g0, int g1, Warp<kOne>& st) {
  int tstart, end;
  interval(ln, j, &tstart, &end);
  fold_part<false>(ln, smem, L, stage, part, tstart, end, g0, g1, st);
}

// Merge the warps' states in order 0..kWarps−1 into the CTA's partial,
// then the cluster's partials in rank order, and write the lane's output
// (each CTA a slice of its G·d values) and, where the lane asks for them,
// each row's merged (m, ℓ) in natural-log units (the thread that writes
// the row's first value; an empty row gives m = −1e30, ℓ = 0, out = 0).
// Every thread of every CTA of the cluster calls it.
template <bool kOne>
__device__ void finish(const Lane& ln, unsigned char* smem, const Layout& L,
                       const Warp<kOne>& st) {
  const int G = ln.G, d = ln.d;
  float* wm = reinterpret_cast<float*>(smem + L.wm);
  float* wl = reinterpret_cast<float*>(smem + L.wl);
  float* wacc = reinterpret_cast<float*>(smem + L.wacc);
  float* cm = reinterpret_cast<float*>(smem + L.cm);
  float* cl = reinterpret_cast<float*>(smem + L.cl);
  float* cacc = reinterpret_cast<float*>(smem + L.cacc);
  __syncthreads();                          // the ring is idle from here
  if constexpr (kOne) {                     // registers → shared memory
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      wm[warp] = st.m;
      wl[warp] = st.l;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = lane + 32 * h;
      if (w < d / 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[warp * d + 4 * w + e] = st.a[h][e];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * d; i += kThreads) {
    const int g = i / d, dd = i - g * d;
    float m = wm[g];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wm[w * G + g]);
    float acc = 0.0f, l = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * G + g] - m);
      acc = __fadd_rn(acc, __fmul_rn(wacc[(w * G + g) * d + dd], f));
      l = __fadd_rn(l, __fmul_rn(wl[w * G + g], f));
    }
    cacc[i] = acc;
    if (dd == 0) {
      cm[g] = m;
      cl[g] = l;
    }
  }
  const int split = gridDim.x, rank = blockIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();            // every partial is in place
  else __syncthreads();
  const int n = G * d, i0 = rank * n / split, i1 = (rank + 1) * n / split;
  for (int i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const int g = i / d;
    // every peer's (m, ℓ, acc) first, unrolled so the remote loads overlap
    float pm[kMaxSplit], pl[kMaxSplit], pa[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (c < split) {
        pm[c] = *cluster.map_shared_rank(cm + g, c);
        pl[c] = *cluster.map_shared_rank(cl + g, c);
        pa[c] = *cluster.map_shared_rank(cacc + i, c);
      }
    }
    float m = pm[0];
#pragma unroll
    for (int c = 1; c < kMaxSplit; ++c)
      if (c < split) m = fmaxf(m, pm[c]);
    float acc = 0.0f, l = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (c < split) {
        const float f = expf(pm[c] - m);
        acc = __fadd_rn(acc, __fmul_rn(pa[c], f));
        l = __fadd_rn(l, __fmul_rn(pl[c], f));
      }
    }
    ln.out[i] = __fdiv_rn(acc, l > 0.0f ? l : 1.0f);
    if (ln.m_out != nullptr && i == g * d) {
      ln.m_out[g] = m;
      ln.l_out[g] = l;
    }
  }
  if (split > 1) cluster.sync();            // no CTA leaves while read
}

// The launch of a kernel on grid (split, lanes), one cluster of `split`
// CTAs a lane: `cfg` points at `attr`, so the two travel together.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

inline void configure(Config* c, int split, int lanes, int smem,
                      cudaStream_t stream) {
  c->cfg = {};
  c->cfg.gridDim = dim3(split, lanes);
  c->cfg.blockDim = dim3(kThreads);
  c->cfg.dynamicSmemBytes = smem;
  c->cfg.stream = stream;
  c->attr[0].id = cudaLaunchAttributeClusterDimension;
  c->attr[0].val.clusterDim.x = split;
  c->attr[0].val.clusterDim.y = 1;
  c->attr[0].val.clusterDim.z = 1;
  c->cfg.attrs = c->attr;
  c->cfg.numAttrs = 1;
}

template <class K, class... Args>
cudaError_t launch(K kernel, bool* done, int split, int lanes, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = prepare(kernel, done);
  if (err != cudaSuccess) return err;
  Config c;
  configure(&c, split, lanes, smem, stream);
  err = cudaLaunchKernelEx(&c.cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the card holds of `kernel` at that launch: resident clusters and
// CTAs an SM (reported only; the split never depends on it).
template <class K>
cudaError_t occupancy(K kernel, bool* done, int split, int smem, int* clusters,
                      int* ctas_per_sm) {
  cudaError_t err = prepare(kernel, done);
  if (err != cudaSuccess) return err;
  Config c;
  configure(&c, split, 1, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &c.cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                       kThreads, smem);
}

}  // namespace int8_decode
