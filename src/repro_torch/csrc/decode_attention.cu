// Decode attention for Hopper (sm_90a): the LOP-sparse mode and the dense
// mode of src/repro/kernels/decode_attention.py:fused_decode_attention, on
// the split-lane decode core int8_decode.cuh.
//
// ---- #4, LOP mode (lop_decode_kernel) ----
// Replaces the Pallas body _fused_lop_kernel (LOP mode, pos_offset 0,
// per-query-head selection, no returned stats). Per (batch·kv-head) lane:
//   screen  every LOP block's score = max over its live tokens of the
//           integer dot pot(q)·pot(k), pot(k) decoded from the packed
//           (sgn‖LO) nibbles; a block with no live token scores −inf;
//   select  rank_row, one warp a query row: the comparison-free bucketized
//           rank of src/repro/core/lop.py:comparison_free_rank, bit for bit:
//           span = max(smax − smin, 1e-9), bucket = trunc(((s − smin) /
//           span)·64) in IEEE steps, non-finite → −1, cut = highest bucket
//           whose ≥-count reaches K, ranks in index order above the cut
//           then at it, rank ≥ K → unselected;
//   exact   the K candidates of each query row folded on the core, each
//           over its block's live interval.
// What bounds it: bytes — the packed features of the live tokens (d/2
// a token, up to 80 KB a lane at new_len 1600) plus K blocks of int8 K/V
// and scales (53 KB), ~3 µs for a B = 4 step at 3.35 TB/s — and, at that
// size, the chain of latencies each lane walks: the screen's copies, the
// cluster-wide gather of its block scores, the candidates' copies, the
// merge. Design: the lane's split_of(nb) CTAs (one cluster) each screen their
// share of blocks, staged whole with 16-byte cp.async through the core's
// ring; a thread a token decodes four nibbles at a time into int8 pot
// values (three byte permutes: |pot| from a table of 2^LO, −|pot| from a
// second, the sign picks) and takes the exact dot with __dp4a (|Σ| ≤
// d·128·64); the block score is a fixed-order integer max over the warps.
// The cluster gathers the lane's block scores through distributed shared
// memory, and every CTA runs rank_row on the same scores, so every CTA
// holds the same candidates; CTA r folds candidates c ≡ r (mod split) in
// increasing c (row g = c / K, rank order within the row), and the core
// merges the CTAs in rank order.
//
// ---- #5, dense mode (dense_decode_kernel) ----
// Replaces the Pallas body _fused_dense_kernel (use_lop=False, pos_offset
// 0, no returned stats): exact attention over every live block. Block j
// holds live tokens where j·block ≤ t < (j + 1)·block, t < new_len and,
// with a window, t ≥ new_len − window; a block with none is skipped whole,
// as the reference's tiles are. What bounds it: bytes — every live token's
// int8 K and V plus their f32 scales (2·d + 8 bytes a token, ~23 MB and
// ~7 µs for a B = 4 step at new_len [1600, 0, 700, 1200]). One CTA a lane
// would put 4 warps on an SM and leave the short lanes' SMs idle while
// the 1600-token lanes stream 13 blocks each.
// Design: CTA r of a lane folds the live blocks of its share [r·share,
// (r + 1)·share) in index order, all G query rows of a block from one copy
// of its K/V, and the core merges the CTAs in rank order.
//
// Why the split never depends on the batch or on new_len: the split count
// and shares come from nb = M / block alone, so a lane's output is bitwise
// the same whatever the other lanes hold and at any B — the recovery retry
// (one lane alone, the others at new_len 0) and the scheduler-vs-lockstep
// equality rest on that.
#include "int8_decode.cuh"

#include <climits>
#include <math_constants.h>

namespace {

using namespace int8_decode;

constexpr int kBuckets = 64;

// One row of comparison_free_rank over nb block scores, on one warp (every
// lane calls it; `rank` doubles as the buckets' scratch). The same ranks as
// the serial definition: span = max(smax − smin, 1e-9), bucket b_j =
// trunc(((s_j − smin) / span)·64) clamped to [0, 63] (non-finite → −1),
// cut = the highest bucket whose count of buckets ≥ it reaches K (0 if
// none does), ranks in index order above the cut, then at it, rank ≥ K →
// unselected. min, max and integer counts are exact in any order, and the
// index-order ranks come from ballots over 32-block chunks in order.
__device__ void rank_row(const float* s, int* rank, int nb, int k) {
  const int lane = threadIdx.x & 31;
  float smin = CUDART_INF_F, smax = -CUDART_INF_F;
  for (int j = lane; j < nb; j += 32) {
    if (isfinite(s[j])) { smin = fminf(smin, s[j]); smax = fmaxf(smax, s[j]); }
  }
  smin = warp_min(smin);
  smax = warp_max(smax);
  const float span = fmaxf(__fsub_rn(smax, smin), 1e-9f);
  int hist_lo = 0, hist_hi = 0;           // buckets lane and lane + 32
  for (int j = lane; j < nb; j += 32) {
    int b = -1;
    if (isfinite(s[j])) {
      const float ratio = __fmul_rn(__fdiv_rn(__fsub_rn(s[j], smin), span),
                                    static_cast<float>(kBuckets));
      b = min(max(static_cast<int>(ratio), 0), kBuckets - 1);
    }
    rank[j] = b;
  }
  __syncwarp();
  for (int j = 0; j < nb; ++j) {
    const int b = rank[j];
    hist_lo += b == lane;
    hist_hi += b == lane + 32;
  }
  // ge(b) = #buckets ≥ b: suffix sums over lanes, the high half first
  int ge_hi = hist_hi, ge_lo = hist_lo;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up_hi = __shfl_down_sync(0xffffffffu, ge_hi, o);
    const int up_lo = __shfl_down_sync(0xffffffffu, ge_lo, o);
    if (lane + o < 32) { ge_hi += up_hi; ge_lo += up_lo; }
  }
  ge_lo += __shfl_sync(0xffffffffu, ge_hi, 0);
  int cut = 0;
  if (ge_lo >= k) cut = lane;
  if (ge_hi >= k) cut = lane + 32;
  cut = warp_max_int(cut);
  int n_above = 0;
  for (int j = lane; j < nb; j += 32) n_above += rank[j] > cut;
  n_above = warp_sum_int(n_above);
  const int big = nb + k + 1;
  const unsigned below = (1u << lane) - 1u;
  int seen_above = 0, seen_cut = 0;
  for (int base = 0; base < nb; base += 32) {
    const int j = base + lane;
    const int b = j < nb ? rank[j] : -1;
    const unsigned above = __ballot_sync(0xffffffffu, b > cut);
    const unsigned at = __ballot_sync(0xffffffffu, b == cut);
    int r = big;
    if (b > cut) r = seen_above + __popc(above & below);
    else if (b == cut) r = n_above + seen_cut + __popc(at & below);
    __syncwarp();
    if (j < nb) rank[j] = r < k ? r : big;
    seen_above += __popc(above);
    seen_cut += __popc(at);
  }
  __syncwarp();
}

// Screen one staged feature block (item i of this CTA, block j): each
// warp's max of the live tokens' scores, per row, into wbest.
__device__ void screen_block(const Lane& ln, unsigned char* smem,
                             const Layout& L, const unsigned char* stage,
                             int i, int j) {
  const int G = ln.G, d = ln.d, hw = d / 4, block = ln.block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* qpot = reinterpret_cast<const int*>(smem + L.qpot);
  int* wbest = reinterpret_cast<int*>(smem + L.wbest) + i * kWarps * G;
  int tstart, end;
  interval(ln, j, &tstart, &end);
  for (int g = 0; g < G; ++g) {
    const int* qp = qpot + g * hw;
    int best = INT_MIN;
    for (int t = threadIdx.x; t < block; t += kThreads) {
      if (t >= tstart && t < end) {
        const unsigned short* f =
            reinterpret_cast<const unsigned short*>(stage + t * (d / 2));
        int sc = 0;
#pragma unroll 4
        for (int h = 0; h < hw; ++h) sc = __dp4a(qp[h], pot4(f[h]), sc);
        best = max(best, sc);
      }
    }
    best = warp_max_int(best);
    if (lane == 0) wbest[warp * G + g] = best;
  }
}

// kOne: one_row(G, block), the warps' state in registers and eight CTAs
// an SM.
template <bool kOne>
__global__ void __launch_bounds__(kThreads, kOne ? 8 : 1)
lop_decode_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
                  const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                  const float* __restrict__ ksc, const float* __restrict__ vsc,
                  const uint8_t* __restrict__ feat,
                  const int* __restrict__ new_len, float* __restrict__ out,
                  int G, int M, int d, int hkv, int block, int k_keep,
                  int window, float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = M / block, share = share_of(nb);
  const int split = gridDim.x, rank = blockIdx.x;
  const Layout L = layout(G, nb, d, block, k_keep, true);
  const Lane ln = make_lane(qi, qsc, kc, vc, ksc, vsc, new_len, out, G, M, d,
                            hkv, block, window, softmax_scale);
  float* blk = reinterpret_cast<float*>(smem + L.blk);
  int* rnk = reinterpret_cast<int*>(smem + L.rank);
  int* cand = reinterpret_cast<int*>(smem + L.cand);
  int* mine = reinterpret_cast<int*>(smem + L.mine);
  const int* wbest = reinterpret_cast<const int*>(smem + L.wbest);
  Warp<kOne> st;

  // ---- screen this CTA's share of blocks [j0, j1); live ones [a0, a1) ----
  int jb_lo, jb_hi;
  live_blocks(ln, &jb_lo, &jb_hi);
  const int j0 = rank * share, j1 = min(j0 + share, nb);
  const int a0 = max(j0, jb_lo), a1 = min(j1, jb_hi);
  const uint8_t* f_lane = feat + static_cast<size_t>(blockIdx.y) * M * (d / 2);
  const int f_bytes = block * d / 2;
  ring(smem, L.stage, max(a1 - a0, 0),
       [&](int i, unsigned char* stage) {
         const uint8_t* src = f_lane + static_cast<size_t>(a0 + i) * f_bytes;
         for (int c = threadIdx.x; c < f_bytes / 16; c += kThreads)
           cp_async16(stage + 16 * c, src + 16 * c, 16);
       },
       [&] {
         int8_t* qpot = reinterpret_cast<int8_t*>(smem + L.qpot);
         for (int i = threadIdx.x; i < G * d; i += kThreads) {
           const int qv = ln.q[i];
           const int mag = qv == 0 ? 0 : (1 << (31 - __clz(abs(qv))));
           qpot[i] = static_cast<int8_t>(qv < 0 ? -mag : mag);
         }
         begin(ln, smem, L, st);
       },
       [&](int i, unsigned char* stage) { screen_block(ln, smem, L, stage, i, a0 + i); });
  const int n_own = j1 - j0;
  for (int i = threadIdx.x; i < G * n_own; i += kThreads) {
    const int g = i / n_own, j = j0 + i % n_own;
    float sc = -CUDART_INF_F;
    if (j >= a0 && j < a1) {
      int b = INT_MIN;
      for (int w = 0; w < kWarps; ++w) b = max(b, wbest[((j - a0) * kWarps + w) * G + g]);
      sc = static_cast<float>(b);
    }
    blk[g * nb + j] = sc;
  }

  // ---- gather the lane's block scores, select on every CTA ----
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
    for (int i = threadIdx.x; i < G * nb; i += kThreads) {
      const int owner = (i % nb) / share;
      if (owner != rank) blk[i] = *cluster.map_shared_rank(blk + i, owner);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x >> 5; g < G; g += kWarps) {      // a warp a row
    for (int r = threadIdx.x & 31; r < k_keep; r += 32) cand[g * k_keep + r] = -1;
    rank_row(blk + g * nb, rnk + g * nb, nb, k_keep);
    for (int j = threadIdx.x & 31; j < nb; j += 32) {
      const int r = rnk[g * nb + j];
      if (r < k_keep) cand[g * k_keep + r] = j;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = rank; c < G * k_keep; c += split)
      if (cand[c] >= 0) mine[n++] = c;
    mine[G * k_keep] = n;
  }
  __syncthreads();

  // ---- exact: this CTA's candidates, K half then V half each ----
  ring(smem, L.stage, 2 * mine[G * k_keep],
       [&](int i, unsigned char* stage) {
         issue_half(ln, stage, cand[mine[i >> 1]], i & 1);
       },
       [] {},
       [&](int i, unsigned char* stage) {
         const int c = mine[i >> 1], g = c / k_keep;
         fold_half(ln, smem, L, stage, i & 1, cand[c], g, g + 1, st);
       });
  finish(ln, smem, L, st);
}

template <bool kOne>
__global__ void __launch_bounds__(kThreads, kOne ? 8 : 1)
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
  const int nb = M / block, share = share_of(nb), rank = blockIdx.x;
  const Layout L = layout(G, nb, d, block, 0, false);
  const Lane ln = make_lane(qi, qsc, kc, vc, ksc, vsc, new_len, out, G, M, d,
                            hkv, block, window, softmax_scale);
  int jb_lo, jb_hi;
  live_blocks(ln, &jb_lo, &jb_hi);
  const int a0 = max(rank * share, jb_lo);
  const int a1 = min(min(rank * share + share, nb), jb_hi);
  Warp<kOne> st;
  ring(smem, L.stage, 2 * max(a1 - a0, 0),
       [&](int i, unsigned char* stage) {
         issue_half(ln, stage, a0 + (i >> 1), i & 1);
       },
       [&] { begin(ln, smem, L, st); },
       [&](int i, unsigned char* stage) {
         fold_half(ln, smem, L, stage, i & 1, a0 + (i >> 1), 0, G, st);
       });
  finish(ln, smem, L, st);
}

// [kOne]: cudaFuncSetAttribute done, per device
bool lop_ready[2][kMaxDevices];
bool dense_ready[2][kMaxDevices];

using LopKernel = decltype(lop_decode_kernel<false>);
using DenseKernel = decltype(dense_decode_kernel<false>);
LopKernel* const lop_kernels[2] = {&lop_decode_kernel<false>,
                                   &lop_decode_kernel<true>};
DenseKernel* const dense_kernels[2] = {&dense_decode_kernel<false>,
                                       &dense_decode_kernel<true>};

}  // namespace

extern "C" {

// The launch plan of one call: {CTAs a lane (the cluster size, split),
// blocks a CTA (share), warps a CTA, dynamic shared-memory bytes}. A
// function of the lane's shape alone.
int repro_decode_plan(int G, int nb, int d, int block, int k_keep, int lop,
                      void* info) {
  int* o = static_cast<int*>(info);
  o[0] = split_of(nb);
  o[1] = share_of(nb);
  o[2] = kWarps;
  o[3] = layout(G, nb, d, block, k_keep, lop != 0).total;
  return 0;
}

// What the card holds of that plan's kernel: {resident clusters, CTAs an
// SM}. Reported only: the plan never depends on it.
int repro_decode_occupancy(int G, int nb, int d, int block, int k_keep,
                           int lop, void* info) {
  int* o = static_cast<int*>(info);
  const int one = one_row(G, block);
  const int smem = layout(G, nb, d, block, k_keep, lop != 0).total;
  return static_cast<int>(
      lop ? occupancy(lop_kernels[one], lop_ready[one], split_of(nb), smem, &o[0], &o[1])
          : occupancy(dense_kernels[one], dense_ready[one], split_of(nb), smem, &o[0],
                      &o[1]));
}

// qi int8 [BH, G, d]; qsc f32 [BH, G]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; feat uint8 [BH, M, d/2]; new_len int32 [B]; out f32
// [BH, G, d]. d % 4 == 0, d ≤ 256, block % 8 == 0, M % block == 0, every
// pointer 16-byte aligned.
int repro_lop_decode_attention(const void* qi, const void* qsc, const void* k,
                               const void* v, const void* ks, const void* vs,
                               const void* feat, const void* new_len,
                               void* out, int BH, int G, int M, int d, int hkv,
                               int block, int k_keep, int window,
                               float softmax_scale, void* stream) {
  const int nb = M / block, one = one_row(G, block);
  const int smem = layout(G, nb, d, block, k_keep, true).total;
  return static_cast<int>(launch(
      lop_kernels[one], lop_ready[one], split_of(nb), BH, smem,
      static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(qi),
      static_cast<const float*>(qsc), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(feat),
      static_cast<const int*>(new_len), static_cast<float*>(out), G, M, d,
      hkv, block, k_keep, window, softmax_scale));
}

// qi int8 [BH, G, d]; qsc f32 [BH, G]; k/v int8 [BH, M, d]; k/v scales
// f32 [BH, M]; new_len int32 [B]; out f32 [BH, G, d]. d % 4 == 0,
// d ≤ 256, block % 8 == 0, M % block == 0, every pointer 16-byte aligned.
int repro_dense_decode_attention(const void* qi, const void* qsc,
                                 const void* k, const void* v, const void* ks,
                                 const void* vs, const void* new_len,
                                 void* out, int BH, int G, int M, int d,
                                 int hkv, int block, int window,
                                 float softmax_scale, void* stream) {
  const int nb = M / block, one = one_row(G, block);
  const int smem = layout(G, nb, d, block, 0, false).total;
  return static_cast<int>(launch(
      dense_kernels[one], dense_ready[one], split_of(nb), BH, smem,
      static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(qi),
      static_cast<const float*>(qsc), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(new_len),
      static_cast<float*>(out), G, M, d, hkv, block, window, softmax_scale));
}

}  // extern "C"
