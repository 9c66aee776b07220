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
//    CTAs, the largest cluster for which every tile's cluster is resident
//    at once (one wave: no SM waits on a second). The cluster's CTAs stage
//    their partial tiles in shared memory and each sums a share of the
//    tile over the cluster through distributed shared memory: no atomics,
//    no zeroed output, and exact integer sums, so the same bits every run.
#include <cooperative_groups.h>

#include "ternary_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using ternary_tile::PackedB;
using ternary_tile::StreamedA;

using DecodeTile = ternary_tile::Tile<16, 128, 1, 4, 4>;
using ChunkTile = ternary_tile::Tile<128, 128, 1, 4, 4>;

constexpr int kMaxSplit = 8;               // the portable cluster size

__host__ __device__ inline int k_steps(int k) {
  return (k + ternary_tile::kBK - 1) / ternary_tile::kBK;
}

// CTA (tile u, rank r of the S in its cluster) folds k-stages
// [r·steps/S, (r+1)·steps/S) of output tile u (the m tiles of a column tile
// next to each other, so its packed rows are read from memory once). With
// S > 1 the cluster's CTAs stage their partial tiles in shared memory, and
// each sums its share of the tile's rows over the S staged tiles (its own,
// then the others' through distributed shared memory; integer sums, so the
// order cannot change a bit) and stores it: no atomics, no zeroing.
template <class T>
__device__ __forceinline__ void ternary_matmul_body(const int8_t* x,
                                                    const uint8_t* packed,
                                                    int* out, int m, int k,
                                                    int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_m = (m + T::BM - 1) / T::BM;
  const int m0 = static_cast<int>(blockIdx.x % tiles_m) * T::BM;
  const int n0 = static_cast<int>(blockIdx.x / tiles_m) * T::BN;
  const int split = gridDim.y, rank = blockIdx.y, steps = k_steps(k);
  const int t0 = rank * steps / split, t1 = (rank + 1) * steps / split;
  const PackedB b{packed, k / 4, n, ternary_tile::packed_mode(packed, n)};
  const StreamedA a{x, m, k, m0,
                    k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  ternary_tile::mainloop<T>(acc, smem, b, n0, t0, t1, a);
  const int* tile = ternary_tile::stage_acc<T>(acc, smem);

  // rows × 4-column groups of the tile that lie inside out, this CTA's share
  constexpr int kGroups = T::BN / 4;
  const int valid = min(T::BM, m - m0) * kGroups;
  const int g0 = rank * valid / split, g1 = (rank + 1) * valid / split;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();           // every partial tile is staged
  for (int i = g0 + threadIdx.x; i < g1; i += T::kThreads) {
    const int r = i / kGroups, c = 4 * (i % kGroups);
    if (n0 + c >= n) continue;
    const int4* src = reinterpret_cast<const int4*>(tile + r * T::kOutStride + c);
    int4 v = *src;
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {  // unrolled: the remote loads overlap
      if (q < split) {
        const int4 u = *cluster.map_shared_rank(src, (rank + q) % split);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    int* o = out + static_cast<size_t>(m0 + r) * n + n0 + c;
    if (n % 4 == 0) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      const int vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && n0 + c + e < n; ++e) o[e] = vs[e];
    }
  }
  if (split > 1) cluster.sync();           // no CTA leaves while read
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

struct Launch {
  Kernel kernel;
  int tiles, split, threads, smem;
};

// How many clusters of s CTAs of ``kernel`` the card holds at once, for
// s = 1 .. kMaxSplit, asked once per device (the shared-memory limit is
// raised on the way).
cudaError_t resident_clusters(Kernel kernel, int threads, int smem,
                              const int** clusters) {
  static int known[64][2][kMaxSplit + 1];  // [device][decode, chunk][s]
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int* fit = known[dev][kernel == ternary_matmul_decode_kernel ? 0 : 1];
  if (fit[0] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    for (int s = 1; s <= kMaxSplit; ++s) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, s);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute cluster[1];
      cluster[0].id = cudaLaunchAttributeClusterDimension;
      cluster[0].val.clusterDim.x = 1;
      cluster[0].val.clusterDim.y = s;
      cluster[0].val.clusterDim.z = 1;
      cfg.attrs = cluster;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&fit[s], kernel, &cfg);
      if (err != cudaSuccess) return err;
    }
    fit[0] = 1;
  }
  *clusters = fit;
  return cudaSuccess;
}

// Each tile's k is split over the largest cluster (up to 8 CTAs) for which
// every tile's cluster is resident at once: one wave, no SM waiting on a
// second; one CTA a tile where the tiles alone fill the card.
template <class T>
cudaError_t plan(Kernel kernel, int m, int k, int n, Launch* l) {
  const int* fit = nullptr;
  const cudaError_t err = resident_clusters(kernel, T::kThreads, T::kSmemBytes, &fit);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((m + T::BM - 1) / T::BM)
                          * ((n + T::BN - 1) / T::BN);
  int split = 1;
  for (int s = min(kMaxSplit, k_steps(k)); s > 1; --s) {
    if (tiles <= fit[s]) {
      split = s;
      break;
    }
  }
  l->kernel = kernel;
  l->tiles = static_cast<int>(tiles);
  l->split = split;
  l->threads = T::kThreads;
  l->smem = T::kSmemBytes;
  return cudaSuccess;
}

cudaError_t plan(int m, int k, int n, Launch* l) {
  return m <= DecodeTile::BM
      ? plan<DecodeTile>(ternary_matmul_decode_kernel, m, k, n, l)
      : plan<ChunkTile>(ternary_matmul_chunk_kernel, m, k, n, l);
}

}  // namespace

extern "C" {

// The launch for x [m, k] × packed [k/4, n]: info ← {CTAs, warps per CTA,
// dynamic shared-memory bytes, output tiles, CTAs a tile's k is split over}.
int repro_ternary_matmul_shape(int m, int k, int n, void* info) {
  Launch l;
  const cudaError_t err = plan(m, k, n, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(info);
  o[0] = l.tiles * l.split;
  o[1] = l.threads / 32;
  o[2] = l.smem;
  o[3] = l.tiles;
  o[4] = l.split;
  return 0;
}

// out = x · W. x int8 [m, k] and packed uint8 [k/4, n], both 4-byte
// aligned; out int32 [m, n]. k % 4 == 0, m ≥ 1, n ≥ 1.
int repro_ternary_matmul(const void* x, const void* packed, void* out, int m,
                         int k, int n, void* stream) {
  Launch l;
  cudaError_t err = plan(m, k, n, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.tiles, l.split);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = l.split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, l.kernel, static_cast<const int8_t*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<int*>(out), m, k, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
