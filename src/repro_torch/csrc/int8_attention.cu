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
// the caller's block_idx blocks in the given order; a block with gate 0
// is skipped; inside a block, tokens outside [start, end) get the logit
// −1e30; the online softmax is the TPU kernel's (no p = 0 guard: a masked
// token weighs exp(−1e30 − m'), which is 1 while no live token has been
// seen), and the flush divides only where ℓ > 0. So a lane with live
// tokens attends to them alone, a lane whose gated blocks hold no live
// token emits the mean of their dequantized V, and a lane whose gates are
// all 0 emits exact zero. Lanes are the batch axis a vmap over (batch,
// kv-head, group) gives the TPU kernel; `q_per_cache` consecutive lanes
// read the same cache lane, as the vmap broadcasts one kv head's cache
// over its query heads. A block index is clamped into the cache, as the
// reference's gather does.
//
// What bounds it: bytes — the gated blocks of int8 K/V and their f32
// scales (2·d + 8 bytes a token; 128 lanes × 2 blocks of 128 at d 100 are
// ~5 MB, 1.5 µs at 3.35 TB/s) — and at that size the chain of latencies
// a lane walks: its list, its blocks' copies, the fold, the merge.
// Design: the split-lane decode core (int8_decode.cuh) with a list as the
// block source. A lane's nb entries are cut by position into shares of
// share_of(nb), one CTA each, split_of(nb) CTAs a lane in one cluster (2
// at K = 2: one block a CTA, 256 CTAs for 128 lanes, all resident at
// once). Warp 1 gathers the CTA's gated entries with a ballot while warp
// 0 loads q; the core's two-stage cp.async ring streams each block's K
// half and V half; the fold weighs masked tokens as above (the core's
// kMasked); the cluster merges the CTAs' partial states in rank order
// through distributed shared memory (m* = max m_c, weights e^{m_c − m*},
// which keeps the TPU kernel's mean-of-V case across CTAs). The split
// depends on nb alone, so a lane's output is bitwise the same whatever
// the other lanes hold.
#include "int8_decode.cuh"
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

// kOne: one_row(G, block), the warps' state in registers and eight CTAs
// an SM.
template <bool kOne>
__global__ void __launch_bounds__(int8_decode::kThreads, kOne ? 8 : 1)
sparse_decode_kernel(const int8_t* __restrict__ qi, const float* __restrict__ qsc,
                     const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     const int* __restrict__ block_idx,
                     const int* __restrict__ gate_tokens, float* __restrict__ out,
                     int G, int M, int d, int nb, int q_per_cache, int block,
                     float softmax_scale) {
  using namespace int8_decode;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, nb, d, block, 0, false);
  const int lane = blockIdx.y, per = share_of(nb);
  const Lane ln = lane_at(qi, qsc, kc, vc, ksc, vsc, out, lane,
                          lane / q_per_cache, G, M, d, block, softmax_scale);
  int* list = reinterpret_cast<int*>(smem + L.total);
  const int i0 = blockIdx.x * per;
  gather_list(block_idx + static_cast<size_t>(lane) * nb,
              gate_tokens + static_cast<size_t>(lane) * 3 * nb, nb, i0,
              min(i0 + per, nb), block, M / block, list);
  Warp<kOne> st;
  begin(ln, smem, L, st);                   // its __syncthreads shows the list
  ring(smem, L.stage, 2 * list[0],
       [&](int i, unsigned char* stage) {
         issue_half(ln, stage, list[1 + 3 * (i >> 1)], i & 1);
       },
       [] {},
       [&](int i, unsigned char* stage) {
         const int* e = list + 1 + 3 * (i >> 1);
         fold_part<true>(ln, smem, L, stage, i & 1, e[1], e[2], 0, G, st);
       });
  finish(ln, smem, L, st);
}

// [kOne]: cudaFuncSetAttribute done, per device
bool sparse_ready[2][kMaxDevices];

using SparseKernel = decltype(sparse_decode_kernel<false>);
SparseKernel* const sparse_kernels[2] = {&sparse_decode_kernel<false>,
                                         &sparse_decode_kernel<true>};

int sparse_smem(int G, int nb, int d, int block) {
  return int8_decode::layout(G, nb, d, block, 0, false).total
       + int8_decode::list_bytes(nb);
}

// CTAs a lane: the core's split of the list, one CTA for an empty list.
int sparse_split(int nb) { return nb > 0 ? int8_decode::split_of(nb) : 1; }

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

// The launch plan of one call: {CTAs a lane (the cluster size, split),
// list entries a CTA (share), warps a CTA, dynamic shared-memory bytes}.
// A function of the lane's shape alone.
int repro_sparse_decode_plan(int G, int nb, int d, int block, void* info) {
  int* o = static_cast<int*>(info);
  o[0] = sparse_split(nb);
  o[1] = int8_decode::share_of(nb);
  o[2] = int8_decode::kWarps;
  o[3] = sparse_smem(G, nb, d, block);
  return 0;
}

// What the card holds of that plan's kernel: {resident clusters, CTAs an
// SM}. Reported only: the plan never depends on it.
int repro_sparse_decode_occupancy(int G, int nb, int d, int block, void* info) {
  int* o = static_cast<int*>(info);
  const int one = int8_decode::one_row(G, block);
  return static_cast<int>(int8_decode::occupancy(
      sparse_kernels[one], sparse_ready[one], sparse_split(nb),
      sparse_smem(G, nb, d, block), &o[0], &o[1]));
}

// q int8 [L, G, d]; qsc f32 [L, G]; k/v int8 [C, M, d]; k/v scales f32
// [C, M] with C = L / q_per_cache; block_idx int32 [L, nb]; gate_tokens
// int32 [L, 3·nb]; out f32 [L, G, d]. d % 4 == 0, d ≤ 256, block % 8 ==
// 0, M % block == 0, L ≥ 1, the caches and their scales 16-byte aligned.
int repro_sparse_decode(const void* q, const void* qs, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* block_idx, const void* gate_tokens,
                        void* out, int L, int G, int M, int d, int nb,
                        int q_per_cache, int block, float softmax_scale,
                        void* stream) {
  const int one = int8_decode::one_row(G, block);
  return static_cast<int>(int8_decode::launch(
      sparse_kernels[one], sparse_ready[one], sparse_split(nb), L,
      sparse_smem(G, nb, d, block), static_cast<cudaStream_t>(stream),
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(block_idx), static_cast<const int*>(gate_tokens),
      static_cast<float*>(out), G, M, d, nb, q_per_cache, block,
      softmax_scale));
}

}  // extern "C"
