// LOP screen for Hopper (sm_90a): surrogate scores from the packed 4-bit
// feature cache.
//
// Replaces the Pallas kernel src/repro/kernels/lop_scores.py:
// lop_scores_kernel (_lop_scores_kernel).
//
// What it computes, per lane l, query row g and cached token t:
//   out[l, g, t] = Σ_e q_pot[l, g, e] · pot(nibble e of feat[l, t])
// in int32, exactly (so bitwise the plain version). Byte b of a token's
// feature row holds element 2b in its low nibble and 2b + 1 in its high
// nibble; a nibble (sgn << 3) | LO decodes to 0 for LO 7, else ±2^LO.
// The caller has already pot-rounded q. Lanes are the batch axis a vmap
// over (batch, kv-head) gives the TPU kernel: one launch screens them all.
//
// What bounds it: bytes — the packed features, m · d/2 per lane, read
// once, against d int8 operations per byte. Design: grid (128-token
// tiles, lanes). The CTA expands its tile's nibbles into pot int8 words
// in shared memory: one 2-byte load holds four nibbles, i.e. one __dp4a
// word, through a 256-entry byte → two-pot table. Only 2-byte alignment
// of a row is assumed — at head_dim 100 a row is 50 bytes. Then a thread
// per token takes d/4 __dp4a per query row against the pot(q) words (odd
// word stride, so the tile reads are free of bank conflicts).
#include "common.cuh"

namespace {

constexpr int kTok = 128;                  // tokens per CTA = threads
constexpr int kG = 8;                      // query rows per register pass

// Shared layout: table int [256] | pot(q) words int [g·d/4] | pot(k) words
// int [kTok·(d/4 | 1)]
__host__ __device__ inline size_t smem_bytes(int g, int d) {
  const int dw = d / 4;
  return sizeof(int) * (256 + static_cast<size_t>(g) * dw + kTok * (dw | 1));
}

__global__ void __launch_bounds__(kTok)
lop_scores_kernel(const int8_t* __restrict__ q_pot,
                  const uint8_t* __restrict__ feat, int* __restrict__ out,
                  int g, int m, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = d >> 2, kstr = dw | 1;
  int* lut = reinterpret_cast<int*>(smem);
  int* qw = lut + 256;
  int* kp = qw + g * dw;
  const int lane = blockIdx.y, t0 = blockIdx.x * kTok, tid = threadIdx.x;
  const int n_tok = min(kTok, m - t0);

  for (int b = tid; b < 256; b += kTok)
    lut[b] = (nib_pot(b & 15) & 0xff) | ((nib_pot(b >> 4) & 0xff) << 8);
  const int* q_src = reinterpret_cast<const int*>(q_pot + static_cast<size_t>(lane) * g * d);
  for (int i = tid; i < g * dw; i += kTok) qw[i] = q_src[i];
  __syncthreads();

  // a token's row is d/2 bytes = dw half-words; the tile is contiguous
  const unsigned short* f_src = reinterpret_cast<const unsigned short*>(
      feat + (static_cast<size_t>(lane) * m + t0) * (d >> 1));
  for (int i = tid; i < n_tok * dw; i += kTok) {
    const int t = i / dw, w = i - t * dw;
    const unsigned h = f_src[i];
    kp[t * kstr + w] = static_cast<int>(static_cast<unsigned>(lut[h & 0xff])
                                        | (static_cast<unsigned>(lut[h >> 8]) << 16));
  }
  __syncthreads();

  if (tid >= n_tok) return;
  const int* kr = kp + tid * kstr;
  int* o = out + static_cast<size_t>(lane) * g * m + t0 + tid;
  for (int g0 = 0; g0 < g; g0 += kG) {
    int acc[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) acc[j] = 0;
    for (int w = 0; w < dw; ++w) {
      const int kv = kr[w];
#pragma unroll
      for (int j = 0; j < kG; ++j)
        if (g0 + j < g) acc[j] = __dp4a(qw[(g0 + j) * dw + w], kv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kG; ++j)
      if (g0 + j < g) o[static_cast<size_t>(g0 + j) * m] = acc[j];
  }
}

}  // namespace

extern "C" {

size_t repro_lop_scores_smem_bytes(int g, int d) { return smem_bytes(g, d); }

// q_pot int8 [L, g, d] (pot-rounded); feat uint8 [L, m, d/2]; out int32
// [L, g, m]. d % 4 == 0; L, g, m ≥ 1.
int repro_lop_scores(const void* q_pot, const void* feat, void* out, int L,
                     int g, int m, int d, void* stream) {
  const size_t smem = smem_bytes(g, d);
  cudaError_t err = cudaFuncSetAttribute(
      lop_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + kTok - 1) / kTok, L);
  lop_scores_kernel<<<grid, kTok, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_pot), static_cast<const uint8_t*>(feat),
      static_cast<int*>(out), g, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
