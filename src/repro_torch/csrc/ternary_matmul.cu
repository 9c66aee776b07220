// TINT GEMM for Hopper (sm_90a): int8 activations × packed 2-bit ternary
// weights → the raw int32 accumulator (no barrier, no dequantization).
//
// Replaces the Pallas kernel src/repro/kernels/ternary_matmul.py:
// ternary_matmul (_ternary_matmul_kernel).
//
// What it computes: out[r, n] = Σ_k x[r, k] · w[k, n] with w ∈ {−1, 0, +1}
// decoded from the packed codes (code j of byte [i, n] is k-row 4i + j;
// 1 → +1, 2 → −1, 0 and 3 → 0). Integer sums are exact in any order, so
// the result is bitwise the plain version's. k may be any multiple of 4:
// the TPU kernel needs a multiple of its 512-deep k block, which
// bitnet-3b's k = 3200 and 8640 are not.
//
// What bounds it: at decode (m ≤ 8) the packed weight stream, k/4 · n
// bytes read once (bytes-bound at 3.35 TB/s); at a 128-row chunk the
// 2·m·k·n int8 operations. Design: a CTA owns BM rows × 128 columns. The
// rows are staged whole in shared memory as int8 words; eight warps split
// the packed rows (the k-reduction) eight ways, and a lane owns four
// adjacent columns, so one 32-bit load brings four columns × four k-rows.
// A 256-entry table in shared memory turns each code byte into a char4 of
// ternary values, which __dp4a multiplies into the four activations of
// each row. The warps' partial sums meet through shared-memory integer
// atomics (exact, so the order does not matter). Simple and right first:
// no TMA, no wgmma, no pipelining.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;                 // 32 lanes × 4 columns

// Shared layout: table int [256] | sums int [BM·kCols] | x words int [BM·k/4]
template <int BM>
size_t smem_bytes(int k) {
  return sizeof(int) * (256 + static_cast<size_t>(BM) * kCols)
       + static_cast<size_t>(BM) * k;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
ternary_matmul_kernel(const int8_t* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      int* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lut = reinterpret_cast<int*>(smem);
  int* sums = lut + 256;
  int* xw = sums + BM * kCols;
  const int kw = k >> 2;                   // packed rows = x words per row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * kCols + 4 * lane;

  for (int b = tid; b < 256; b += kThreads) lut[b] = ternary_code_word(b);
  for (int i = tid; i < BM * kCols; i += kThreads) sums[i] = 0;
  for (int i = tid; i < BM * kw; i += kThreads) {
    const int r = i / kw, w = i - r * kw;
    xw[i] = m0 + r < m
        ? reinterpret_cast<const int*>(x + static_cast<size_t>(m0 + r) * k)[w]
        : 0;
  }
  __syncthreads();

  const int per = (kw + kWarps - 1) / kWarps;
  const int i0 = warp * per, i1 = min(kw, i0 + per);
  int acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;
  }
  if (c0 < n) {
    const bool word_load = (n & 3) == 0;   // then c0 + 3 < n as well
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const uint8_t* src = packed + static_cast<size_t>(i) * n + c0;
      unsigned word = 0;
      if (word_load) {
        word = *reinterpret_cast<const unsigned*>(src);
      } else {
        for (int j = 0; j < 4 && c0 + j < n; ++j)
          word |= static_cast<unsigned>(src[j]) << (8 * j);
      }
      const int w0 = lut[word & 0xff], w1 = lut[(word >> 8) & 0xff];
      const int w2 = lut[(word >> 16) & 0xff], w3 = lut[word >> 24];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int xv = xw[r * kw + i];
        acc[r][0] = __dp4a(xv, w0, acc[r][0]);
        acc[r][1] = __dp4a(xv, w1, acc[r][1]);
        acc[r][2] = __dp4a(xv, w2, acc[r][2]);
        acc[r][3] = __dp4a(xv, w3, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(&sums[r * kCols + 4 * lane + j], acc[r][j]);
  }
  __syncthreads();

  for (int o = tid; o < BM * kCols; o += kThreads) {
    const int r = o / kCols, col = blockIdx.x * kCols + o % kCols;
    if (m0 + r < m && col < n) out[static_cast<size_t>(m0 + r) * n + col] = sums[o];
  }
}

template <int BM>
int launch(const int8_t* x, const uint8_t* packed, int* out, int m, int k,
           int n, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(k);
  cudaError_t err = cudaFuncSetAttribute(
      ternary_matmul_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + kCols - 1) / kCols, (m + BM - 1) / BM);
  ternary_matmul_kernel<BM><<<grid, kThreads, smem, stream>>>(x, packed, out,
                                                               m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest k (a multiple of 4) whose staged rows fit 227 KB of shared memory.
int repro_ternary_matmul_max_k() {
  return static_cast<int>((232448 - smem_bytes<16>(0)) / 16) & ~3;
}

// out = x · W. x int8 [m, k]; packed uint8 [k/4, n]; out int32 [m, n].
// k % 4 == 0, m ≥ 1, n ≥ 1.
int repro_ternary_matmul(const void* x, const void* packed, void* out, int m,
                         int k, int n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto pp = static_cast<const uint8_t*>(packed);
  auto op = static_cast<int*>(out);
  if (m <= 4) return launch<4>(xp, pp, op, m, k, n, s);
  if (m <= 8) return launch<8>(xp, pp, op, m, k, n, s);
  return launch<16>(xp, pp, op, m, k, n, s);
}

}  // extern "C"
