// The ternary tile core: int8 rows × packed 2-bit ternary weights → exact
// int32 on the int8 tensor cores, reduced over a cluster and handed to an
// epilogue. The TINT GEMM (ternary_matmul.cu, #7: int32 out), the TINT
// projection and the whole FFN (qlinear.cu, #1 and #2: dequantize, bias,
// activation, gate‖up pairing) all run on it.
//
// What it computes: acc[r, c] = Σ_k a[r, k] · w[k, c] with w ∈ {−1, 0, +1}
// decoded from the packed codes (code j of byte [i, c] is k-row 4i + j;
// 1 → +1, 2 → −1, 0 and 3 → 0). int32 accumulation of int8 × ternary is
// exact (|sum| ≤ 127·k), so any order of the sum, split-k included, is
// bitwise the plain version.
//
// Design:
//  * mma.sync m16n8k32 s8·s8→s32. In its B fragment each 32-bit register
//    holds the four consecutive k-rows 4·(lane%4) .. +3 (and +16) of one
//    column lane/4: exactly one packed byte. So B never exists as int8 in
//    memory: a lane reads packed bytes from shared memory and decodes each
//    into a char4 in registers (decode4: two nibble spreads and one prmt
//    lookup per byte, no table in memory).
//  * Column permutation: a lane reads the NT adjacent packed bytes of one
//    packed row at columns NT·(lane/4) .. +NT−1 of its warp's WN = 8·NT
//    columns (NT/4 32-bit shared loads), and byte j feeds the j-th n8 MMA
//    tile. So logical tile j, column q is physical column NT·q + j, and in
//    the accumulator a lane ends up holding the 2·NT consecutive physical
//    columns 2·NT·(lane%4) .. of rows lane/4 and lane/4 + 8 (acc_at),
//    which stage_acc writes as 16-byte words.
//  * A (int8 rows) and B (packed rows) are both streamed in stages of
//    kBK = 128 k (32 packed rows) through a ring of kStages cp.async
//    stages (16-byte copies where a row's bytes allow, else 4-byte, else
//    bytes for a packed row whose width is no multiple of 4), zero-filled
//    past k, past m and past n, so any k that is a multiple of 4 runs,
//    with no cap. A kernel that starts from f32 rows (#1, #2) has them
//    absmax-quantized first by a barrier pass of its own into int8 rows
//    of k rounded up to 16, so its A always takes the 16-byte copies.
//  * B's columns come in two halves of BN/2 (PackedB): adjacent for a
//    projection, or the FFN's 64 gate columns from n0 beside the 64 up
//    columns from f + n0 of the same packed gate‖up stream, so one CTA
//    holds both operands of act(g)·u.
//  * Shared layouts free of bank conflicts: a packed stage row takes BN +
//    32 bytes, so the four rows a warp reads at once land 8 banks apart
//    (NT = 4: one word a lane, 8 words a row); an A row takes kBK + 16
//    bytes (9 units of 16 bytes, odd, so ldmatrix's eight rows hit eight
//    different bank groups).
//  * stage_acc writes the accumulators to the CTA's BM × BN int32 tile in
//    shared memory (over the ring), so an epilogue reads whole rows with
//    neighbouring threads on neighbouring columns.
//  * Where the tiles alone leave SMs idle, a tile's k is split over a
//    cluster of up to kMaxSplit CTAs, the largest cluster for which every
//    tile's cluster is resident at once (plan: one wave, no SM waits on a
//    second). run_tile then sums the cluster's staged partial tiles
//    through distributed shared memory, each CTA a share of the rows,
//    with exact integer sums (no atomics, no zeroed output, the same bits
//    every call), and hands each 4-column group to the kernel's epilogue.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace ternary_tile {

namespace cg = cooperative_groups;

constexpr int kBK = 128;                  // k per stage
constexpr int kBKp = kBK / 4;             // packed rows per stage
constexpr int kAStride = kBK + 16;        // streamed A row bytes
constexpr unsigned kCodeTable = 0x00FF0100u;   // byte c: code c → 0, +1, −1, 0
constexpr int kMaxSplit = 8;              // the portable cluster size

__host__ __device__ inline int k_steps(int k) { return (k + kBK - 1) / kBK; }

// CTA tile BM × BN of WarpsM × WarpsN warps, each owning a WM × WN warp
// tile; a ring of Stages k-stages. After the mainloop the ring holds the
// staged BM × BN int32 tile.
template <int BM_, int BN_, int WarpsM, int WarpsN, int Stages>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kWarpsN = WarpsN, kStages = Stages;
  static constexpr int kWarps = WarpsM * WarpsN, kThreads = 32 * kWarps;
  static constexpr int WM = BM / WarpsM, WN = BN / WarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;   // m16 and n8 MMA tiles a warp
  static constexpr int kBStride = BN + 32;
  static constexpr int kBBytes = kBKp * kBStride;
  static constexpr int kStageBytes = kBBytes + BM * kAStride;
  static constexpr int kOutStride = BN + 4;          // int32 columns of a staged row
  static constexpr int kSmemBytes =
      kStages * kStageBytes > BM * kOutStride * 4 ? kStages * kStageBytes
                                                  : BM * kOutStride * 4;
  static_assert(WM % 16 == 0 && NT % 4 == 0, "warp tile");
  static_assert(BN % 64 == 0 && Stages >= 3, "ring");
};

// Four packed bytes → four char4 B registers; r[i] holds the four k-rows of
// byte i in order.
__device__ __forceinline__ void decode4(unsigned w, unsigned* r) {
  unsigned e = __byte_perm(w, 0u, 0x4240);          // bytes 0, 2 in the 16-bit halves
  unsigned o = __byte_perm(w, 0u, 0x4341);          // bytes 1, 3
  // each half: codes at bits 0, 2, 4, 6 → nibbles 0, 1, 2, 3 (prmt selectors)
  e = (e | (e << 4)) & 0x0F0F0F0Fu;
  e = (e | (e << 2)) & 0x33333333u;
  o = (o | (o << 4)) & 0x0F0F0F0Fu;
  o = (o | (o << 2)) & 0x33333333u;
  r[0] = __byte_perm(kCodeTable, 0u, e);
  r[1] = __byte_perm(kCodeTable, 0u, o);
  r[2] = __byte_perm(kCodeTable, 0u, e >> 16);
  r[3] = __byte_perm(kCodeTable, 0u, o >> 16);
}

// NT packed bytes at p (4-byte aligned) → NT B registers.
template <int NT>
__device__ __forceinline__ void load_b(const unsigned char* p, unsigned (&b)[NT]) {
#pragma unroll
  for (int q = 0; q < NT / 4; ++q)
    decode4(reinterpret_cast<const unsigned*>(p)[q], b + 4 * q);
}

// One k32 step of a warp: acc[MT][NT] += A · B. a: the warp's first row at
// this step's k offset (row stride a_stride, 16-byte aligned rows); b: the
// step's first packed row at the warp's first column (row stride b_stride).
template <int MT, int NT>
__device__ __forceinline__ void mma_k32(int (&acc)[MT][NT][4], const int8_t* a,
                                        int a_stride, const unsigned char* b,
                                        int b_stride, int lane) {
  const unsigned char* bl = b + (lane & 3) * b_stride + NT * (lane >> 2);
  unsigned b0[NT], b1[NT];
  load_b<NT>(bl, b0);
  load_b<NT>(bl + 4 * b_stride, b1);
  const int8_t* al = a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * a_stride
                     + 16 * (lane >> 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    unsigned af[4];
    ldmatrix_x4(af, al + 16 * mt * a_stride);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_s8(acc[mt][j], af, b0[j], b1[j]);
  }
}

// The lane's value at column 2·NT·(lane%4) + c of row 16·mt + 8·h + lane/4
// of its warp tile (c < 2·NT; compile-time c keeps acc in registers).
template <int MT, int NT>
__device__ __forceinline__ int acc_at(const int (&acc)[MT][NT][4], int mt,
                                      int h, int c) {
  return c < NT ? acc[mt][c][2 * h] : acc[mt][c - NT][2 * h + 1];
}

// The packed weights [kp, stride] as one CTA stages them: tile column c <
// BN/2 is packed column c0 + c and tile column BN/2 + c is c1 + c, each
// zero from e0 (resp. e1) on. A projection's halves are adjacent (c1 = c0
// + BN/2, e0 = e1 = n); the FFN's gate‖up tile pairs gate column c0 + c
// with up column c1 + c = f + c0 + c (e0 = f, e1 = 2f). mode: how rows may
// be copied, 16 (every column bound and the base 16-byte aligned), 4
// (4-byte aligned) or 1 (bytes).
struct PackedB {
  const uint8_t* packed;
  int kp, stride, mode;
  int c0, c1, e0, e1;
};

// The copy mode of packed weights at p whose column bounds are all
// multiples of w.
__host__ __device__ inline int packed_mode(const void* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (w % 16 == 0 && a % 16 == 0) return 16;
  return (w % 4 == 0 && a % 4 == 0) ? 4 : 1;
}

// Columns [n0, n0 + BN) of packed [kp, n].
template <class T>
__device__ __forceinline__ PackedB packed_columns(const uint8_t* packed, int kp,
                                                  int n, int n0) {
  return PackedB{packed, kp, n, packed_mode(packed, n), n0, n0 + T::BN / 2, n, n};
}

// The source of tile column col (a copy never straddles the halves) in
// packed row r, and whether it lies inside the weights.
template <class T>
__device__ __forceinline__ const uint8_t* b_src(const PackedB& b, int r, int col,
                                                bool& in) {
  const bool hi = col >= T::BN / 2;
  const int g = (hi ? b.c1 - T::BN / 2 : b.c0) + col;
  in = r < b.kp && g < (hi ? b.e1 : b.e0);
  return b.packed + (in ? static_cast<size_t>(r) * b.stride + g : 0);
}

// Start the copy of packed rows [kBKp·t, +kBKp) of the CTA's BN columns
// into a stage; zeros past kp and past each half's bound.
template <class T>
__device__ __forceinline__ void load_b_stage(unsigned char* dst, const PackedB& b,
                                             int t) {
  const int r0 = kBKp * t;
  bool in;
  if (b.mode == 16) {
    constexpr int kPerRow = T::BN / 16;
    for (int c = threadIdx.x; c < kBKp * kPerRow; c += T::kThreads) {
      const int r = c / kPerRow, col = 16 * (c % kPerRow);
      const uint8_t* src = b_src<T>(b, r0 + r, col, in);
      cp_async16(dst + r * T::kBStride + col, src, in ? 16 : 0);
    }
  } else if (b.mode == 4) {
    constexpr int kPerRow = T::BN / 4;
    for (int c = threadIdx.x; c < kBKp * kPerRow; c += T::kThreads) {
      const int r = c / kPerRow, col = 4 * (c % kPerRow);
      const uint8_t* src = b_src<T>(b, r0 + r, col, in);
      cp_async4(dst + r * T::kBStride + col, src, in);
    }
  } else {
    for (int c = threadIdx.x; c < kBKp * T::BN; c += T::kThreads) {
      const int r = c / T::BN, col = c % T::BN;
      const uint8_t* src = b_src<T>(b, r0 + r, col, in);
      dst[r * T::kBStride + col] = in ? *src : 0;
    }
  }
}

// A streamed from int8 rows x [m, k] (4-byte aligned rows) through the ring.
// vec16: k % 16 == 0 and x 16-byte aligned (always so for a barrier pass's
// rows), so whole 16-byte units are copied.
struct StreamedA {
  const int8_t* x;
  int m, k, m0;
  bool vec16;
  static constexpr int stride = kAStride;

  // Start the copy of rows [m0, m0 + BM) × k [kBK·t, +kBK); zeros past m, k.
  template <class T>
  __device__ __forceinline__ void load(int8_t* dst, int t) const {
    const int c0 = kBK * t;
    if (vec16) {
      for (int c = threadIdx.x; c < T::BM * (kBK / 16); c += T::kThreads) {
        const int r = c / (kBK / 16), col = 16 * (c % (kBK / 16));
        const bool in = m0 + r < m && c0 + col < k;
        cp_async16(dst + r * stride + col,
                   x + (in ? static_cast<size_t>(m0 + r) * k + c0 + col : 0),
                   in ? 16 : 0);
      }
    } else {
      for (int c = threadIdx.x; c < T::BM * (kBK / 4); c += T::kThreads) {
        const int r = c / (kBK / 4), col = 4 * (c % (kBK / 4));
        const bool in = m0 + r < m && c0 + col < k;
        cp_async4(dst + r * stride + col,
                  x + (in ? static_cast<size_t>(m0 + r) * k + c0 + col : 0), in);
      }
    }
  }
  __device__ __forceinline__ const int8_t* rows(const int8_t* slot, int) const {
    return slot;
  }
};

// Fold k-stages [t0, t1) of the CTA's BM × BN tile into each warp's acc.
// ``a`` is the A policy: a.load<T>(slot, t) starts stage t's copy into the
// slot's A part, a.rows(slot, t) → stage t's first row, a.stride its row
// stride. Every thread of the CTA calls it; smem holds T::kSmemBytes.
template <class T, class A>
__device__ __forceinline__ void mainloop(int (&acc)[T::MT][T::NT][4],
                                         unsigned char* smem, const PackedB& b,
                                         int t0, int t1, const A& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  auto a_part = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + s * T::kStageBytes + T::kBBytes);
  };
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (t0 + s < t1) {
      load_b_stage<T>(smem + s * T::kStageBytes, b, t0 + s);
      a.template load<T>(a_part(s), t0 + s);
    }
    cp_async_commit();
  }
  int slot = 0, next = T::kStages - 1;     // slots of stage t and of t + kStages − 1
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();                        // stage t landed; slot `next` is free
    if (t + T::kStages - 1 < t1) {
      load_b_stage<T>(smem + next * T::kStageBytes, b, t + T::kStages - 1);
      a.template load<T>(a_part(next), t + T::kStages - 1);
    }
    cp_async_commit();
    const unsigned char* bs = smem + slot * T::kStageBytes + T::WN * wn;
    const int8_t* as = a.rows(a_part(slot), t) + T::WM * wm * a.stride;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      mma_k32<T::MT, T::NT>(acc, as + 32 * ks, a.stride,
                            bs + 8 * ks * T::kBStride, T::kBStride, lane);
    slot = slot + 1 == T::kStages ? 0 : slot + 1;
    next = next + 1 == T::kStages ? 0 : next + 1;
  }
  cp_async_wait<0>();
}

// Write the warps' accumulators into the CTA's BM × BN int32 tile in
// shared memory (row stride T::kOutStride, over the ring), undoing the
// column permutation; → the tile, complete when this returns. Every thread
// of the CTA calls it after the mainloop.
template <class T>
__device__ __forceinline__ const int* stage_acc(const int (&acc)[T::MT][T::NT][4],
                                                unsigned char* smem) {
  int* tile = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = T::WM * (warp / T::kWarpsN) + (lane >> 2);
  const int col0 = T::WN * (warp % T::kWarpsN) + 2 * T::NT * (lane & 3);
  __syncthreads();                          // every warp is done with the ring
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int4* o = reinterpret_cast<int4*>(tile + (row0 + 16 * mt + 8 * h) * T::kOutStride
                                        + col0);
#pragma unroll
      for (int c = 0; c < 2 * T::NT; c += 4)
        o[c / 4] = make_int4(acc_at(acc, mt, h, c), acc_at(acc, mt, h, c + 1),
                             acc_at(acc, mt, h, c + 2), acc_at(acc, mt, h, c + 3));
    }
  }
  __syncthreads();
  return tile;
}


// Σ over the cluster's `split` staged tiles of the 4 int32 at p (this
// CTA's own tile, then the others' through distributed shared memory; the
// loads are unrolled so they overlap, and integer sums cannot depend on
// their order).
__device__ __forceinline__ int4 cluster_sum4(cg::cluster_group& cluster,
                                             const int* p, int split, int rank) {
  const int4* src = reinterpret_cast<const int4*>(p);
  int4 v = *src;
#pragma unroll
  for (int q = 1; q < kMaxSplit; ++q) {
    if (q < split) {
      const int4 u = *cluster.map_shared_rank(src, (rank + q) % split);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
  }
  return v;
}

// One output tile on the core. The grid is tiles × split: blockIdx.y is
// the CTA's rank among the `split` CTAs (one cluster) that share the
// tile's k, and rank r folds k-stages [r·steps/S, (r+1)·steps/S). After
// the mainloop each CTA sums a share of the tile's `rows` valid rows over
// the cluster and hands every 4-column group to the epilogue:
//   Epi::kPaired        the tile is a gate‖up pair: groups cover columns
//                       [0, BN/2) and each comes with the group BN/2 on;
//   epi.valid(c)        whether tile column c (a multiple of 4) is stored;
//   epi.store(r, c, v, u)  the exact sums of tile row r, columns c .. c+3
//                       (u: columns BN/2 + c .., where kPaired).
// Every thread of the CTA calls it; the dynamic smem holds T::kSmemBytes.
template <class T, class A, class Epi>
__device__ __forceinline__ void run_tile(const A& a, const PackedB& b, int k,
                                         int rows, const Epi& epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = gridDim.y, rank = blockIdx.y, steps = k_steps(k);
  const int t0 = rank * steps / split, t1 = (rank + 1) * steps / split;
  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  mainloop<T>(acc, smem, b, t0, t1, a);
  const int* tile = stage_acc<T>(acc, smem);

  constexpr int kGroups = (Epi::kPaired ? T::BN / 2 : T::BN) / 4;
  const int valid = rows * kGroups;
  const int g0 = rank * valid / split, g1 = (rank + 1) * valid / split;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();           // every partial tile is staged
  for (int i = g0 + threadIdx.x; i < g1; i += T::kThreads) {
    const int r = i / kGroups, c = 4 * (i % kGroups);
    if (!epi.valid(c)) continue;
    const int* p = tile + r * T::kOutStride + c;
    const int4 v = cluster_sum4(cluster, p, split, rank);
    int4 u = v;
    if constexpr (Epi::kPaired) u = cluster_sum4(cluster, p + T::BN / 2, split, rank);
    epi.store(r, c, v, u);
  }
  if (split > 1) cluster.sync();           // no CTA leaves while read
}

// One launch of a run_tile kernel: grid tiles × split, split CTAs a
// cluster.
struct Launch {
  int tiles, split, threads, smem;
};

// How many clusters of s CTAs of ``kernel`` the card holds at once, for
// s = 1 .. kMaxSplit, asked once per kernel and device (the kernel's
// shared-memory limit is raised on the way).
template <class K>
cudaError_t resident_clusters(K kernel, int threads, int smem, const int** clusters) {
  struct Known {
    const void* kernel;
    int dev;
    int fit[kMaxSplit + 1];
  };
  static Known known[64];
  static int n_known = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_known; ++i) {
    if (known[i].kernel == key && known[i].dev == dev) {
      *clusters = known[i].fit;
      return cudaSuccess;
    }
  }
  if (n_known == 64) return cudaErrorInvalidDevice;
  Known& kn = known[n_known];
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
    err = cudaOccupancyMaxActiveClusters(&kn.fit[s], kernel, &cfg);
    if (err != cudaSuccess) return err;
  }
  kn.kernel = key;
  kn.dev = dev;
  *clusters = kn.fit;
  ++n_known;
  return cudaSuccess;
}

// Each of the `tiles` output tiles takes its k (k_steps(k) stages) on
// the largest cluster (up to kMaxSplit CTAs) for which every tile's
// cluster is resident at once: one wave, no SM waiting on a second; one
// CTA a tile where the tiles alone fill the card.
template <class T, class K>
cudaError_t plan(K kernel, long long tiles, int k, Launch* l) {
  const int* fit = nullptr;
  const cudaError_t err = resident_clusters(kernel, T::kThreads, T::kSmemBytes, &fit);
  if (err != cudaSuccess) return err;
  int split = 1;
  for (int s = min(kMaxSplit, k_steps(k)); s > 1; --s) {
    if (tiles <= fit[s]) {
      split = s;
      break;
    }
  }
  l->tiles = static_cast<int>(tiles);
  l->split = split;
  l->threads = T::kThreads;
  l->smem = T::kSmemBytes;
  return cudaSuccess;
}

// Launch ``kernel`` as planned, on ``stream``.
template <class K, class... Args>
cudaError_t launch(K kernel, const Launch& l, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.tiles, l.split);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = l.split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Info for a planned launch: {CTAs, warps per CTA, dynamic shared-memory
// bytes, output tiles, CTAs a tile's k is split over}.
inline void launch_info(const Launch& l, int* o) {
  o[0] = l.tiles * l.split;
  o[1] = l.threads / 32;
  o[2] = l.smem;
  o[3] = l.tiles;
  o[4] = l.split;
}

}  // namespace ternary_tile
