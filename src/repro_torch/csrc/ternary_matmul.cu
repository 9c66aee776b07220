// TINT GEMM for Hopper (sm_90a): int8 activations × packed 2-bit ternary
// weights → the raw int32 accumulator (no barrier, no dequantization), on
// the ternary tile core (ternary_tile.cuh: int8 mma.sync fed by codes
// decoded in registers, k streamed through a cp.async ring).
//
// Replaces the Pallas kernel src/repro/kernels/ternary_matmul.py:
// ternary_matmul (_ternary_matmul_kernel).
//
// What it computes: out[r, c] = Σ_k x[r, k] · w[k, c] with w ∈ {−1, 0, +1}
// decoded from the packed codes. Integer sums are exact in any order, so
// the result is bitwise the plain version's. k may be any multiple of 4,
// with no cap: the TPU kernel needs a multiple of its 512-deep k block,
// which bitnet-3b's k = 3200 and 8640 are not.
//
// What bounds it, and the design's answer:
//  * decode (m ≤ 16): the packed weight stream, k/4 · n bytes read once
//    (bytes-bound at 3.35 TB/s: 2.3 µs for bitnet-3b's QKV). A CTA is one
//    m16 row tile × 128 columns, four warps of 32 columns, with a ring of
//    4 stages (16 KB of packed rows in flight a CTA, up to 4 CTAs an SM).
//  * chunk (m > 16): the 2·m·k·n int8 operations (operations-bound at a
//    128-row chunk of QKV, gate‖up and down). A CTA is 128 rows × 128
//    columns, four warps of 128 × 32: a decoded packed byte feeds eight
//    m16 MMAs, so the decode costs 1/8 of a register operation per MMA.
//  * Both: where the tiles alone leave SMs idle (25 column tiles for a
//    3200-wide output), each tile's k is split over a cluster of up to 8
//    CTAs that sum their partial tiles through distributed shared memory
//    (the core's plan and run_tile, shared with qlinear.cu): no atomics,
//    no zeroed output, and exact integer sums, so the same bits every run.
//    The epilogue stores the sums as they are.
#include "ternary_tile.cuh"

namespace {

using ternary_tile::Launch;
using ternary_tile::StreamedA;

using DecodeTile = ternary_tile::Tile<16, 128, 1, 4, 4>;
using ChunkTile = ternary_tile::Tile<128, 128, 1, 4, 4>;

// The epilogue: the exact sums, stored as int32 into out [m, n].
struct StoreInt {
  static constexpr bool kPaired = false;
  int* out;
  int m0, n0, n;

  __device__ __forceinline__ bool valid(int c) const { return n0 + c < n; }
  __device__ __forceinline__ void store(int r, int c, int4 v, int4) const {
    int* o = out + static_cast<size_t>(m0 + r) * n + n0 + c;
    if (n % 4 == 0) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      const int vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && n0 + c + e < n; ++e) o[e] = vs[e];
    }
  }
};

// Output tile blockIdx.x (the m tiles of a column tile next to each other,
// so its packed rows are read from memory once).
template <class T>
__device__ __forceinline__ void ternary_matmul_body(const int8_t* x,
                                                    const uint8_t* packed,
                                                    int* out, int m, int k,
                                                    int n) {
  const int tiles_m = (m + T::BM - 1) / T::BM;
  const int m0 = static_cast<int>(blockIdx.x % tiles_m) * T::BM;
  const int n0 = static_cast<int>(blockIdx.x / tiles_m) * T::BN;
  const StreamedA a{x, m, k, m0,
                    k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  ternary_tile::run_tile<T>(a, ternary_tile::packed_columns<T>(packed, k / 4, n, n0),
                            k, min(T::BM, m - m0), StoreInt{out, m0, n0, n});
}

__global__ void __launch_bounds__(DecodeTile::kThreads)
ternary_matmul_decode_kernel(const int8_t* __restrict__ x,
                             const uint8_t* __restrict__ packed,
                             int* __restrict__ out, int m, int k, int n) {
  ternary_matmul_body<DecodeTile>(x, packed, out, m, k, n);
}

__global__ void __launch_bounds__(ChunkTile::kThreads)
ternary_matmul_chunk_kernel(const int8_t* __restrict__ x,
                            const uint8_t* __restrict__ packed,
                            int* __restrict__ out, int m, int k, int n) {
  ternary_matmul_body<ChunkTile>(x, packed, out, m, k, n);
}

using Kernel = void (*)(const int8_t*, const uint8_t*, int*, int, int, int);

template <class T>
cudaError_t plan(Kernel kernel, int m, int k, int n, Launch* l) {
  const long long tiles = static_cast<long long>((m + T::BM - 1) / T::BM)
                          * ((n + T::BN - 1) / T::BN);
  return ternary_tile::plan<T>(kernel, tiles, k, l);
}

// The kernel for m rows and its launch.
cudaError_t plan(int m, int k, int n, Kernel* kernel, Launch* l) {
  if (m <= DecodeTile::BM) {
    *kernel = ternary_matmul_decode_kernel;
    return plan<DecodeTile>(*kernel, m, k, n, l);
  }
  *kernel = ternary_matmul_chunk_kernel;
  return plan<ChunkTile>(*kernel, m, k, n, l);
}

}  // namespace

extern "C" {

// The launch for x [m, k] × packed [k/4, n]: info ← {CTAs, warps per CTA,
// dynamic shared-memory bytes, output tiles, CTAs a tile's k is split over}.
int repro_ternary_matmul_shape(int m, int k, int n, void* info) {
  Kernel kernel;
  Launch l;
  const cudaError_t err = plan(m, k, n, &kernel, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  ternary_tile::launch_info(l, static_cast<int*>(info));
  return 0;
}

// out = x · W. x int8 [m, k] and packed uint8 [k/4, n], both 4-byte
// aligned; out int32 [m, n]. k % 4 == 0, m ≥ 1, n ≥ 1.
int repro_ternary_matmul(const void* x, const void* packed, void* out, int m,
                         int k, int n, void* stream) {
  Kernel kernel;
  Launch l;
  cudaError_t err = plan(m, k, n, &kernel, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ternary_tile::launch(kernel, l, static_cast<cudaStream_t>(stream),
                             static_cast<const int8_t*>(x),
                             static_cast<const uint8_t*>(packed),
                             static_cast<int*>(out), m, k, n);
  return static_cast<int>(err);
}

}  // extern "C"
