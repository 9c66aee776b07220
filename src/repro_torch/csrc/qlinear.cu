// Fused TINT projection and FFN gate/up stage for Hopper (sm_90a).
//
// Replaces the Pallas bodies src/repro/kernels/qlinear.py:_qlinear_kernel
// (fused_qlinear) and, in two launches, :_ffn_kernel (fused_ffn).
//
// What it computes, per output row r and column n:
//   xq, xs = absmax_barrier(x[r, :])                 (bitwise the plain version)
//   acc    = Σ_k xq[k] · w[k, n]                      (int32, w ∈ {−1, 0, 1})
//   y      = ((float(acc) · xs) · γ[n]) + bias[n], then the activation.
// The FFN's first launch runs the gated form: one CTA column reads the
// gate column j and the up column f + j of the same packed stream and
// writes h = act(g) · u as f32 into device memory; the second launch is
// this projection kernel again on h with the down weights, so the hidden
// barrier is the same exact absmax function the TPU kernel ran in VMEM.
//
// What bounds it: at decode (m = B ≤ 8) the packed 2-bit weight stream,
// k/4 · n bytes read once (bytes-bound, 3.35 TB/s); the activations are
// small and come from L2. Design: a CTA owns BM rows × 32 columns. Its
// eight warps first barrier-quantize the CTA's rows into shared memory
// (each CTA recomputes the absmax of its own rows; exact, so every CTA
// gets the same int8 rows), then split the k-reduction eight ways: lane
// = column, one packed byte = four consecutive k-rows of that column,
// unpacked through a 256-entry table to a char4 and fed to __dp4a
// against four consecutive int8 activations. The eight integer partial
// sums add exactly in shared memory. Simple and right first: no TMA, no
// wgmma, no pipelining yet.
#include "common.cuh"

namespace {

constexpr int kCols = 32;              // output columns per CTA (lane = column)
constexpr int kSplit = 8;              // warps splitting the k-reduction
constexpr int kThreads = 32 * kSplit;  // 256

__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) return y / (1.0f + expf(-y));                      // silu
  if (act == 2) {                                                  // tanh gelu
    const float c = 0.7978845608028654f;
    float inner = c * (y + 0.044715f * (y * y * y));
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  return y;
}

// Shared layout: [lut 256 int][xs BM float][partial kSplit*BM*kCols*(1|2) int][xq BM*kstride int8]
template <int BM, bool GATED>
__global__ void __launch_bounds__(kThreads)
qlinear_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ gamma, const float* __restrict__ bias,
               float* __restrict__ out, int m, int k, int n_out, int n_packed,
               int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lut = reinterpret_cast<int*>(smem);
  float* xs = reinterpret_cast<float*>(lut + 256);
  constexpr int kAcc = GATED ? 2 : 1;
  int* partial = reinterpret_cast<int*>(xs + BM);
  int8_t* xq = reinterpret_cast<int8_t*>(partial + kSplit * BM * kCols * kAcc);
  const int kstride = (k + 15) & ~15;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n = blockIdx.x * kCols + lane;

  // code table: byte → four int8 ternary values packed as a char4
  for (int b = tid; b < 256; b += kThreads) lut[b] = ternary_code_word(b);

  // ---- absmax barrier: warp w quantizes rows w, w + 8, ... of the tile ----
  for (int r = warp; r < BM; r += kSplit) {
    const int row = m0 + r;
    int8_t* dst = xq + r * kstride;
    if (row >= m) {
      for (int i = lane; i < kstride; i += 32) dst[i] = 0;
      if (lane == 0) xs[r] = 0.0f;
      continue;
    }
    const float* src = x + static_cast<size_t>(row) * k;
    float amax = 0.0f;
    for (int i = lane; i < k; i += 32) amax = fmaxf(amax, fabsf(src[i]));
    amax = warp_max(amax);
    const float scale = barrier_scale(amax);
    for (int i = lane; i < k; i += 32) dst[i] = barrier_quantize(src[i], scale);
    for (int i = k + lane; i < kstride; i += 32) dst[i] = 0;
    if (lane == 0) xs[r] = scale;
  }
  __syncthreads();

  // ---- integer GEMM: warp = k-slice, lane = column ----
  const int kp = k >> 2;                       // packed rows
  const int per = (kp + kSplit - 1) / kSplit;
  const int i0 = warp * per, i1 = min(kp, i0 + per);
  int acc[BM], acc_u[GATED ? BM : 1];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0;
#pragma unroll
  for (int r = 0; r < (GATED ? BM : 1); ++r) acc_u[r] = 0;
  if (n < n_out) {
    const uint8_t* wcol = packed + n;
    const uint8_t* ucol = packed + (GATED ? n_out : 0) + n;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const int wv = lut[wcol[static_cast<size_t>(i) * n_packed]];
      int uv = 0;
      if constexpr (GATED) uv = lut[ucol[static_cast<size_t>(i) * n_packed]];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int xv = *reinterpret_cast<const int*>(xq + r * kstride + 4 * i);
        acc[r] = __dp4a(xv, wv, acc[r]);
        if constexpr (GATED) acc_u[r] = __dp4a(xv, uv, acc_u[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    partial[(warp * BM + r) * kCols + lane] = acc[r];
    if constexpr (GATED) partial[((kSplit + warp) * BM + r) * kCols + lane] = acc_u[r];
  }
  __syncthreads();

  // ---- epilogue: exact integer sum of the k-slices, then dequant ----
  for (int o = tid; o < BM * kCols; o += kThreads) {
    const int r = o / kCols, c = o % kCols;
    const int row = m0 + r, col = blockIdx.x * kCols + c;
    if (row >= m || col >= n_out) continue;
    int a = 0, au = 0;
    for (int w = 0; w < kSplit; ++w) {
      a += partial[(w * BM + r) * kCols + c];
      if constexpr (GATED) au += partial[((kSplit + w) * BM + r) * kCols + c];
    }
    float y = __fmul_rn(__fmul_rn(static_cast<float>(a), xs[r]), gamma[col]);
    if constexpr (GATED) {
      const float u = __fmul_rn(__fmul_rn(static_cast<float>(au), xs[r]),
                                gamma[n_out + col]);
      y = __fmul_rn(act_fn(y, act), u);
    } else {
      if (bias != nullptr) y = __fadd_rn(y, bias[col]);
      y = act_fn(y, act);
    }
    out[static_cast<size_t>(row) * n_out + col] = y;
  }
}

template <int BM, bool GATED>
size_t smem_bytes(int k) {
  const int kstride = (k + 15) & ~15;
  return 256 * sizeof(int) + BM * sizeof(float)
       + kSplit * BM * kCols * (GATED ? 2 : 1) * sizeof(int)
       + static_cast<size_t>(BM) * kstride;
}

template <int BM, bool GATED>
int launch(const float* x, const uint8_t* packed, const float* gamma,
           const float* bias, float* out, int m, int k, int n_out,
           int n_packed, int act, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM, GATED>(k);
  cudaError_t err = cudaFuncSetAttribute(
      qlinear_kernel<BM, GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_out + kCols - 1) / kCols, (m + BM - 1) / BM);
  qlinear_kernel<BM, GATED><<<grid, kThreads, smem, stream>>>(
      x, packed, gamma, bias, out, m, k, n_out, n_packed, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest k whose barriered tile fits the 227 KB of shared memory.
int repro_qlinear_max_k() {
  return static_cast<int>((232448 - smem_bytes<16, true>(0)) / 16) & ~15;
}

// y = act(((xq·W)·xs)·γ + bias). x f32 [m, k]; packed uint8 [k/4, n];
// gamma f32 [n]; bias f32 [n] or null; out f32 [m, n].
int repro_qlinear(const void* x, const void* packed, const void* gamma,
                  const void* bias, void* out, int m, int k, int n, int act,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 8)
    return launch<8, false>(static_cast<const float*>(x),
                            static_cast<const uint8_t*>(packed),
                            static_cast<const float*>(gamma),
                            static_cast<const float*>(bias),
                            static_cast<float*>(out), m, k, n, n, act, s);
  return launch<16, false>(static_cast<const float*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<const float*>(gamma),
                           static_cast<const float*>(bias),
                           static_cast<float*>(out), m, k, n, n, act, s);
}

// h = act(g)·u with g, u the dequantized gate (columns [0, f)) and up
// (columns [f, 2f)) projections of one packed stream. x f32 [m, k];
// packed uint8 [k/4, 2f]; gamma f32 [2f]; h f32 [m, f].
int repro_ffn_gate_up(const void* x, const void* packed, const void* gamma,
                      void* h, int m, int k, int f, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 8)
    return launch<8, true>(static_cast<const float*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<const float*>(gamma), nullptr,
                           static_cast<float*>(h), m, k, f, 2 * f, act, s);
  return launch<16, true>(static_cast<const float*>(x),
                          static_cast<const uint8_t*>(packed),
                          static_cast<const float*>(gamma), nullptr,
                          static_cast<float*>(h), m, k, f, 2 * f, act, s);
}

}  // extern "C"
