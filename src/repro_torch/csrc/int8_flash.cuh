// The tile core shared by the port's two int8 flash-prefill kernels
// (prefill_attention.cu: chunked prefill over the cache; int8_attention.cu:
// one head of causal / sliding-window / non-causal attention). Each .cu
// keeps only its row geometry, its extern "C" entry and its launch.
//
// What it computes, for query row r of a lane (global position qpos =
// q_off + r % chunk), over keys [lo, hi) with
//   hi = min(kv_len, qpos + 1, M) when causal, else min(kv_len, M);
//   lo = max(0, qpos − window + 1) when causal and window > 0, else 0:
// logits from the exact int32 dot, scaled ((dot·k_scale)·q_scale)·scale
// (kKScaleFirst) or ((dot·q_scale)·k_scale)·scale, masked to −1e30 outside
// [lo, hi); an online softmax in f32 — m' = max(m, max s), α = exp(m − m'),
// p = exp(s − m') with p = 0 where s ≤ −1e30/2, ℓ = ℓα + Σp, acc = acc·α +
// Σ_t fmaf(p_t, v_t·vs_t) with the dequantized v·vs one __fmul_rn; the
// flush divides (IEEE) only where ℓ > 0, so a row with no key emits zero.
//
// What bounds it: the f32 P·V (2·d operations per visible (row, key) pair
// at 67 TFLOP/s); the int8 QKᵀ on the tensor cores is ~1/30 of that, and
// the int8 K/V bytes are read once per 16-row slab.
//
// Design (one CTA = kWarps warps on one 16-row slab; #3 runs 4 warps a
// CTA, #8 8, see each .cu):
//  * Logits on int8 tensor cores: mma.sync m16n8k32 s8·s8→s32. A warp holds
//    the slab's Q as the A fragment (head_dim zero-padded to a multiple of
//    32 in shared memory: exact for an integer dot) and reads K in its
//    natural [token][d] layout with ldmatrix as the "col" B operand. K rows
//    sit at an odd number of 16-byte units (112 B at d 100, 144 B at d 128)
//    so ldmatrix is free of bank conflicts; bytes past d may hold anything,
//    since Q is zero there.
//  * Key tiles of kTile = 32 tokens are split over the warps by ABSOLUTE
//    tile index: warp w folds the tiles j ≡ w (mod kWarps) of the slab's
//    range, in increasing j, into its own (m, ℓ, acc). At the end the CTA
//    merges the partials in the fixed order w = 0..kWarps−1 (m = max m_w,
//    ℓ = Σ ℓ_w·exp(m_w − m), acc likewise) and flushes once.
//  * P·V stays f32 FMA, register-tiled: P goes from the MMA accumulator
//    layout to a per-warp buffer [token][row]; lane l owns dims 4l..4l+3 of
//    all 16 rows and, per token, loads its four int8 values once, forms
//    v·vs once each and issues 64 independent fmaf (64 chains, each over t
//    in increasing order).
//  * Each warp streams its own tiles (K rows with 4-byte cp.async into the
//    padded layout, V as one contiguous run with 16-byte cp.async where the
//    lane's base is 16-byte aligned, else 4-byte; the scales 4-byte) into a
//    two-stage ring; tokens past M are zero-filled.
// Shared memory: 32-token tiles keep a warp's two stages + P buffer at
// 17 KB (d 100) to 21 KB (d 128), so a CTA of 4 warps takes 69–85 KB
// (dynamic, above the 48 KB default) and two fit on an SM beside the
// registers (~200 a thread); 64-token tiles would double that and leave
// one CTA (4 warps) per SM.
//
// Row independence: a row's partial in warp w is the fold of the tiles
// j ≡ w (mod kWarps) that hold its visible keys. A tile outside the row's
// range is a bitwise no-op on it (every logit −1e30: m' = max(m, −1e30) =
// m, α = 1, p = 0, ℓ += +0, acc·1 + (+0)), also before its first visible
// tile (the state stays (−1e30, 0, 0)). So which rows share the CTA, the
// chunk width and q_off cannot change a row's bits: chunked prefill is
// bitwise whole-prompt prefill.
#pragma once

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace int8_flash {

constexpr int kRows = 16;               // query rows per CTA: one m16 MMA tile
constexpr int kTile = 32;               // tokens per key tile
constexpr int kStages = 2;              // cp.async ring depth per warp
constexpr int kMaxD = 128;
constexpr int kQStride = 144;           // Q row bytes: 128 + 16, an odd count of 16-byte units
constexpr int kPStride = 20;            // floats per token in the P buffer (conflict-free stores)

// K row bytes: d rounded up to an odd number of 16-byte units.
__host__ __device__ inline int k_stride(int d) { return 16 * (((d + 15) / 16) | 1); }
// + 32: ldmatrix reads up to a multiple of 32 bytes of the last row.
__host__ __device__ inline int k_tile_bytes(int d) { return kTile * k_stride(d) + 32; }
// + 128: lanes past d/4 words read (and discard) up to word 31 of the last row.
__host__ __device__ inline int v_tile_bytes(int d) { return kTile * d + 128; }
__host__ __device__ inline int stage_bytes(int d) {
  return k_tile_bytes(d) + v_tile_bytes(d) + 2 * kTile * 4;
}
// a warp's ring, its P buffer [kTile][kPStride] and α [kRows]
__host__ __device__ inline int warp_bytes(int d) {
  return kStages * stage_bytes(d) + kTile * kPStride * 4 + kRows * 4;
}
// Q [kRows][kQStride] | q scale, lo, hi [kRows] | m, ℓ [warps][kRows]
__host__ __device__ constexpr int cta_bytes(int warps) {
  return kRows * kQStride + 3 * kRows * 4 + 2 * warps * kRows * 4;
}

__host__ __device__ inline size_t smem_bytes(int warps, int d) {
  return cta_bytes(warps) + static_cast<size_t>(warps) * warp_bytes(d);
}

// One lane's operands, already offset to the lane.
struct Slab {
  const int8_t* q;        // [n_rows, d]
  const float* qs;        // [n_rows]
  const int8_t* k;        // [M, d]
  const int8_t* v;        // [M, d]
  const float* ks;        // [M]
  const float* vs;        // [M]
  float* out;             // [n_rows, d]
  int n_rows, M, d;
  int r0;                 // the CTA's first row
  int q_off, chunk;       // row r sits at qpos = q_off + r % chunk
  int kv_len;             // keys [0, kv_len) exist
  int causal, window;
  float softmax_scale;
};

namespace detail {

// Start the copy of tile j (tokens t0 .. t0 + kTile) into one stage.
__device__ __forceinline__ void load_tile(const Slab& a, unsigned char* stage,
                                          int j, int lane) {
  const int d = a.d, dw = d >> 2, kst = k_stride(d);
  const int t0 = j * kTile;
  const int n_in = min(kTile, a.M - t0);            // ≥ 1: tiles start below M
  unsigned char* k_dst = stage;
  unsigned char* v_dst = stage + k_tile_bytes(d);
  float* ks_dst = reinterpret_cast<float*>(v_dst + v_tile_bytes(d));
  float* vs_dst = ks_dst + kTile;
  if (lane < dw) {
    for (int t = 0; t < kTile; ++t) {
      const bool in = t < n_in;
      cp_async4(k_dst + t * kst + 4 * lane,
                a.k + static_cast<size_t>(t0 + (in ? t : 0)) * d + 4 * lane, in);
    }
  }
  const int8_t* v_src = a.v + static_cast<size_t>(t0) * d;
  const int v_bytes = n_in * d;
  if ((reinterpret_cast<uintptr_t>(v_src) & 15) == 0) {
    for (int c = 16 * lane; c < kTile * d; c += 16 * 32) {
      const int n = max(0, min(16, v_bytes - c));
      cp_async16(v_dst + c, v_src + (n ? c : 0), n);
    }
  } else {
    for (int c = 4 * lane; c < kTile * d; c += 4 * 32) {
      const bool in = c < v_bytes;
      cp_async4(v_dst + c, v_src + (in ? c : 0), in);
    }
  }
  const bool in = lane < n_in;                      // kTile == 32: a token per lane
  const size_t tk = t0 + (in ? lane : 0);
  cp_async4(ks_dst + lane, a.ks + tk, in);
  cp_async4(vs_dst + lane, a.vs + tk, in);
}

}  // namespace detail

// Fold the CTA's 16-row slab and write its rows of ``out``. Every thread
// of the kWarps·32-thread CTA calls it; ``smem`` holds
// smem_bytes(kWarps, d).
template <int kWarps, bool kKScaleFirst>
__device__ __forceinline__ void fold_slab(const Slab& a, unsigned char* smem) {
  using namespace detail;
  constexpr int kThreads = kWarps * 32;
  constexpr int kCtaBytes = cta_bytes(kWarps);
  static_assert(kTile == 32 && kStages == 2 && kRows == 16, "fragment layout");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;          // MMA row group, thread in group
  const int d = a.d, dw = d >> 2, ksteps = (d + 31) >> 5, kst = k_stride(d);

  int8_t* q_s = reinterpret_cast<int8_t*>(smem);
  float* qs_s = reinterpret_cast<float*>(smem + kRows * kQStride);
  int* lo_s = reinterpret_cast<int*>(qs_s + kRows);
  int* hi_s = lo_s + kRows;
  float* m_all = reinterpret_cast<float*>(hi_s + kRows);   // [kWarps][kRows]
  float* l_all = m_all + kWarps * kRows;
  unsigned char* ring = smem + kCtaBytes + warp * warp_bytes(d);
  float* p_w = reinterpret_cast<float*>(ring + kStages * stage_bytes(d));
  float* alpha_w = p_w + kTile * kPStride;

  // Q rows, zero past d and past the last row; each row's scale and keys
  for (int i = tid; i < kRows * (kQStride / 4); i += kThreads) {
    const int r = i / (kQStride / 4), w = i % (kQStride / 4);
    int val = 0;
    if (a.r0 + r < a.n_rows && w < dw)
      val = reinterpret_cast<const int*>(a.q + static_cast<size_t>(a.r0 + r) * d)[w];
    reinterpret_cast<int*>(q_s)[i] = val;
  }
  if (tid < kRows) {
    const int r = a.r0 + tid;
    int lo = 0, hi = 0;
    float qs = 0.0f;
    if (r < a.n_rows) {
      const int qpos = a.q_off + r % a.chunk;
      hi = a.causal ? min(a.kv_len, qpos + 1) : a.kv_len;
      hi = max(0, min(hi, a.M));
      lo = (a.causal && a.window) ? max(0, qpos - a.window + 1) : 0;
      qs = a.qs[r];
    }
    lo_s[tid] = lo;
    hi_s[tid] = hi;
    qs_s[tid] = qs;
  }
  __syncthreads();

  // the slab's tiles (the union of its rows' ranges); this warp's share
  int lo_min = INT_MAX, hi_max = 0;
  for (int i = 0; i < kRows; ++i) {
    if (lo_s[i] < hi_s[i]) {
      lo_min = min(lo_min, lo_s[i]);
      hi_max = max(hi_max, hi_s[i]);
    }
  }
  const int jt_lo = hi_max > 0 ? lo_min / kTile : 0;
  const int jt_hi = (hi_max + kTile - 1) / kTile;
  const int j0 = jt_lo + ((warp - jt_lo % kWarps) + kWarps) % kWarps;
  const int n_mine = j0 < jt_hi ? (jt_hi - 1 - j0) / kWarps + 1 : 0;

  const float qs0 = qs_s[g], qs1 = qs_s[g + 8];
  const int lo0 = lo_s[g], hi0 = hi_s[g], lo1 = lo_s[g + 8], hi1 = hi_s[g + 8];
  const float sm = a.softmax_scale;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_mine) load_tile(a, ring + st * stage_bytes(d), j0 + st * kWarps, lane);
    cp_async_commit();
  }

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    unsigned char* stage = ring + (i & 1) * stage_bytes(d);
    const int8_t* k_t = reinterpret_cast<const int8_t*>(stage);
    const unsigned* v_t = reinterpret_cast<const unsigned*>(stage + k_tile_bytes(d));
    const float* ks_t = reinterpret_cast<const float*>(stage + k_tile_bytes(d) + v_tile_bytes(d));
    const float* vs_t = ks_t + kTile;
    const int t0 = (j0 + i * kWarps) * kTile;

    // ---- S = Q·Kᵀ on the tensor cores: 16 rows × 32 keys, exact int32 ----
    int cs[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[nt][e] = 0;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 32; ++kk) {
      if (kk < ksteps) {                             // warp-uniform
        unsigned qa[4];
        ldmatrix_x4(qa, q_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kQStride
                            + kk * 32 + 16 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int mi = lane >> 3;                  // matrix: n-tile 2np + mi/2, k half mi&1
          unsigned b[4];
          ldmatrix_x4(b, k_t + (16 * np + 8 * (mi >> 1) + (lane & 7)) * kst
                             + kk * 32 + 16 * (mi & 1));
          mma_s8(cs[2 * np], qa, b[0], b[1]);
          mma_s8(cs[2 * np + 1], qa, b[2], b[3]);
        }
      }
    }

    // ---- scale, mask, fold the max; element e of n-tile nt is row
    //      g + 8·(e >> 1), key nt·8 + 2·tq + (e & 1) ----
    float s[4][4];
    float mx0 = REPRO_NEG_INF, mx1 = REPRO_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tq + (e & 1);
        const int kpos = t0 + col;
        const bool up = e >> 1;
        const float qsr = up ? qs1 : qs0;
        const float dot = static_cast<float>(cs[nt][e]);
        const float x = kKScaleFirst
            ? __fmul_rn(__fmul_rn(__fmul_rn(dot, ks_t[col]), qsr), sm)
            : __fmul_rn(__fmul_rn(__fmul_rn(dot, qsr), ks_t[col]), sm);
        const bool ok = up ? (kpos >= lo1 && kpos < hi1) : (kpos >= lo0 && kpos < hi0);
        s[nt][e] = ok ? x : REPRO_NEG_INF;
        if (up) mx1 = fmaxf(mx1, s[nt][e]);
        else mx0 = fmaxf(mx0, s[nt][e]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool up = e >> 1;
        float p = expf(s[nt][e] - (up ? mn1 : mn0));
        if (s[nt][e] <= REPRO_NEG_INF / 2) p = 0.0f;   // fully-masked guard
        p_w[(nt * 8 + 2 * tq + (e & 1)) * kPStride + g + 8 * up] = p;
        if (up) ps1 = __fadd_rn(ps1, p);
        else ps0 = __fadd_rn(ps0, p);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ps0 = __fadd_rn(ps0, __shfl_xor_sync(0xffffffffu, ps0, o));
      ps1 = __fadd_rn(ps1, __shfl_xor_sync(0xffffffffu, ps1, o));
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ps0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ps1);
    m0 = mn0;
    m1 = mn1;
    if (tq == 0) {
      alpha_w[g] = al0;
      alpha_w[g + 8] = al1;
    }
    __syncwarp();

    // ---- P·V: lane owns dims 4·lane .. 4·lane + 3 of all 16 rows ----
    float part[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.0f;
#pragma unroll 2
    for (int t = 0; t < kTile; ++t) {
      const unsigned w = v_t[t * dw + lane];
      const float vsc = vs_t[t];
      float vd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) vd[c] = __fmul_rn(byte_to_float(w, c), vsc);
      const float4* pr = reinterpret_cast<const float4*>(p_w + t * kPStride);
#pragma unroll
      for (int q4 = 0; q4 < kRows / 4; ++q4) {
        const float4 p4 = pr[q4];
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[4 * q4 + rr][c] = fmaf(pv[rr], vd[c], part[4 * q4 + rr][c]);
      }
    }
    const float4* al4 = reinterpret_cast<const float4*>(alpha_w);
#pragma unroll
    for (int q4 = 0; q4 < kRows / 4; ++q4) {
      const float4 a4 = al4[q4];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[4 * q4 + rr][c] = __fadd_rn(__fmul_rn(acc[4 * q4 + rr][c], av[rr]),
                                          part[4 * q4 + rr][c]);
    }
    __syncwarp();                                    // stage and P buffer free
    if (i + kStages < n_mine)
      load_tile(a, stage, j0 + (i + kStages) * kWarps, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // ---- merge the warps' partials in warp order, then flush ----
  float* acc_w = reinterpret_cast<float*>(ring);     // [kRows][d] over the ring
  if (4 * lane < d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float4*>(acc_w + r * d + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (tq == 0) {
    m_all[warp * kRows + g] = m0;
    m_all[warp * kRows + g + 8] = m1;
    l_all[warp * kRows + g] = l0;
    l_all[warp * kRows + g + 8] = l1;
  }
  __syncthreads();
  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int r = a.r0 + rr;
    if (r >= a.n_rows) continue;                     // warp-uniform
    float m = m_all[rr];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, m_all[w * kRows + rr]);
    float ew[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ew[w] = expf(m_all[w * kRows + rr] - m);
    float l = __fmul_rn(l_all[rr], ew[0]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l = __fadd_rn(l, __fmul_rn(l_all[w * kRows + rr], ew[w]));
    const float den = l > 0.0f ? l : 1.0f;
    float* dst = a.out + static_cast<size_t>(r) * d;
    for (int dd = lane; dd < d; dd += 32) {
      const float* src = reinterpret_cast<const float*>(smem + kCtaBytes) + rr * d + dd;
      float x = __fmul_rn(src[0], ew[0]);
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        x = __fadd_rn(x, __fmul_rn(src[w * (warp_bytes(d) / 4)], ew[w]));
      dst[dd] = __fdiv_rn(x, den);
    }
  }
}

}  // namespace int8_flash
