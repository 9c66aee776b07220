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
// once, and the int32 scores written once (128 lanes × 1664 tokens at d
// 100: 10.6 MB in, 0.85 MB out, 3.4 µs at 3.35 TB/s), against d int8
// operations a feature byte.
//
// Design: grid (128-token tiles, lanes), a thread a token, one wave at
// that shape (1664 CTAs of 4 warps and ~6.5 KB of shared memory; the card
// holds 16 an SM), so every tile's copy is in flight at once and the
// tiles that landed first are decoded while the rest still stream. A
// tile's feature bytes are contiguous (a row is d/2 bytes, 50 at d 100,
// so a tile starts 16-byte aligned only where the lane's and the tile's
// offsets allow): its 16-byte-aligned body comes in by 16-byte cp.async,
// its unaligned head and tail (< 16 bytes each) by 2-byte loads, all into
// a buffer laid out as the global bytes are. Each thread then decodes its
// token's row four nibbles at a time with pot4 (three byte permutes, no
// table, no division) into a __dp4a word and takes the exact dot against
// the pot(q) words (in shared memory, read by every thread at the same
// address: a broadcast), for up to 8 query rows at a time with their sums
// in registers (rows in passes of 8, 4, 2, 1, each of a fixed width, so
// no guarded accumulator), and writes each row's scores coalesced.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTok = 128;                  // tokens per CTA = threads

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// Shared layout (dynamic): pot(q) words int [g·d/4] | the tile's bytes as
// they lie in memory from the 16-byte boundary at or below its start.
__host__ __device__ inline int smem_bytes(int g, int d) {
  return up16(g * d) + up16(kTok * d / 2) + 16;
}

// kR query rows' scores of one token: its packed row `f` (dw half-words)
// against the pot(q) words `qw` (rows at dw words), into o[r·m].
template <int kR>
__device__ __forceinline__ void score_rows(const int* qw,
                                           const unsigned short* f, int dw,
                                           int* o, int m) {
  int acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0;
#pragma unroll 5
  for (int w = 0; w < dw; ++w) {
    const int k4 = pot4(f[w]);
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = __dp4a(qw[r * dw + w], k4, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) o[static_cast<size_t>(r) * m] = acc[r];
}

__global__ void __launch_bounds__(kTok)
lop_scores_kernel(const int8_t* __restrict__ q_pot,
                  const uint8_t* __restrict__ feat, int* __restrict__ out,
                  int g, int m, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = d >> 2, rb = d >> 1;       // pot words, bytes a token
  const int lane = blockIdx.y, t0 = blockIdx.x * kTok, tid = threadIdx.x;
  const int n_tok = min(kTok, m - t0);
  int* qw = reinterpret_cast<int*>(smem);
  unsigned char* tile = smem + up16(g * d);

  // the tile's bytes [b0, b1): body [a0, a1) 16-byte aligned, head [b0,
  // a0) and tail [a1, b1) 2-byte aligned; byte x lands at tile[x − base]
  const uint8_t* b0 = feat + (static_cast<size_t>(lane) * m + t0) * rb;
  const uint8_t* b1 = b0 + n_tok * rb;
  const uintptr_t u0 = reinterpret_cast<uintptr_t>(b0);
  const uintptr_t u1 = reinterpret_cast<uintptr_t>(b1);
  const uintptr_t base = u0 & ~uintptr_t{15};
  const uintptr_t up = (u0 + 15) & ~uintptr_t{15}, down = u1 & ~uintptr_t{15};
  const uintptr_t a0 = up < u1 ? up : u1;
  const uintptr_t a1 = down > a0 ? down : a0;
  const int n_body = static_cast<int>((a1 - a0) >> 4);
  const unsigned char* body = reinterpret_cast<const unsigned char*>(a0);
  unsigned char* body_s = tile + (a0 - base);
  for (int i = tid; i < n_body; i += kTok)
    cp_async16(body_s + 16 * i, body + 16 * i, 16);
  cp_async_commit();
  const int n_head = static_cast<int>((a0 - u0) >> 1);
  const int n_tail = static_cast<int>((u1 - a1) >> 1);
  if (tid < n_head + n_tail) {
    const uintptr_t x = tid < n_head ? u0 + 2 * tid : a1 + 2 * (tid - n_head);
    *reinterpret_cast<unsigned short*>(tile + (x - base)) =
        *reinterpret_cast<const unsigned short*>(x);
  }
  const int* q_src = reinterpret_cast<const int*>(
      q_pot + static_cast<size_t>(lane) * g * d);
  for (int i = tid; i < g * dw; i += kTok) qw[i] = q_src[i];
  cp_async_wait<0>();
  __syncthreads();

  if (tid >= n_tok) return;
  const unsigned short* f = reinterpret_cast<const unsigned short*>(
      tile + (u0 - base) + tid * rb);
  int* o = out + static_cast<size_t>(lane) * g * m + t0 + tid;
  int r = 0;
  for (; r + 8 <= g; r += 8)
    score_rows<8>(qw + r * dw, f, dw, o + static_cast<size_t>(r) * m, m);
  if (g - r >= 4) {
    score_rows<4>(qw + r * dw, f, dw, o + static_cast<size_t>(r) * m, m);
    r += 4;
  }
  if (g - r >= 2) {
    score_rows<2>(qw + r * dw, f, dw, o + static_cast<size_t>(r) * m, m);
    r += 2;
  }
  if (g - r >= 1)
    score_rows<1>(qw + r * dw, f, dw, o + static_cast<size_t>(r) * m, m);
}

bool ready[kMaxDevices];                   // cudaFuncSetAttribute done

}  // namespace

extern "C" {

// The launch plan of one call: {tokens a CTA (the grid has ⌈m / that⌉
// CTAs a lane), warps a CTA, dynamic shared-memory bytes}.
int repro_lop_scores_plan(int g, int d, void* info) {
  int* o = static_cast<int*>(info);
  o[0] = kTok;
  o[1] = kTok / 32;
  o[2] = smem_bytes(g, d);
  return 0;
}

// q_pot int8 [L, g, d] (pot-rounded); feat uint8 [L, m, d/2]; out int32
// [L, g, m]; each 4-byte aligned. d % 4 == 0; L ≤ 65535; L, g, m ≥ 1.
int repro_lop_scores(const void* q_pot, const void* feat, void* out, int L,
                     int g, int m, int d, void* stream) {
  cudaError_t err = prepare(lop_scores_kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + kTok - 1) / kTok, L);
  lop_scores_kernel<<<grid, kTok, smem_bytes(g, d),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_pot), static_cast<const uint8_t*>(feat),
      static_cast<int*>(out), g, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
