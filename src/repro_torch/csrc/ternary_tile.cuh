// The ternary tile core: int8 rows × packed 2-bit ternary weights → exact
// int32 on the int8 tensor cores. ternary_matmul.cu (#7) runs on it; the
// TINT projection and the FFN (qlinear.cu) are to follow.
//
// What it computes: acc[r, c] += Σ_k a[r, k] · w[k, c] over the k-stages
// it is given, with w ∈ {−1, 0, +1} decoded from the packed codes (code j
// of byte [i, c] is k-row 4i + j; 1 → +1, 2 → −1, 0 and 3 → 0). int32
// accumulation of int8 × ternary is exact (|sum| ≤ 127·k), so any order of
// the sum, split-k included, is bitwise the plain version.
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
//  * k is streamed in stages of kBK = 128 (32 packed rows) through a ring
//    of kStages cp.async stages (16-byte copies where a row's bytes allow,
//    else 4-byte, else bytes for a packed row whose width is no multiple
//    of 4), zero-filled past k, past m and past n, so any k that is a
//    multiple of 4 runs, with no cap.
//  * Shared layouts free of bank conflicts: a packed stage row takes BN +
//    32 bytes, so the four rows a warp reads at once land 8 banks apart
//    (NT = 4: one word a lane, 8 words a row); an A row takes kBK + 16
//    bytes (9 units of 16 bytes, odd, so ldmatrix's eight rows hit eight
//    different bank groups).
//  * stage_acc writes the accumulators to the CTA's BM × BN int32 tile in
//    shared memory (over the ring), so an epilogue reads whole rows with
//    neighbouring threads on neighbouring columns.
//  * The A side is a policy (StreamedA below, or rows a prologue already
//    wrote to shared memory): the mainloop only asks it to start a stage's
//    copy and for the stage's rows and stride, so a kernel that quantizes
//    its rows in-kernel (#1, #2) keeps them resident and streams only the
//    packed weights (Tile<..., false> leaves A out of the ring).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace ternary_tile {

constexpr int kBK = 128;                  // k per stage
constexpr int kBKp = kBK / 4;             // packed rows per stage
constexpr int kAStride = kBK + 16;        // streamed A row bytes
constexpr unsigned kCodeTable = 0x00FF0100u;   // byte c: code c → 0, +1, −1, 0

// CTA tile BM × BN of WarpsM × WarpsN warps, each owning a WM × WN warp
// tile; a ring of Stages k-stages; StreamA: whether A goes through the ring
// too. After the mainloop the ring holds the staged BM × BN int32 tile.
template <int BM_, int BN_, int WarpsM, int WarpsN, int Stages,
          bool StreamA = true>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kWarpsN = WarpsN, kStages = Stages;
  static constexpr int kWarps = WarpsM * WarpsN, kThreads = 32 * kWarps;
  static constexpr int WM = BM / WarpsM, WN = BN / WarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;   // m16 and n8 MMA tiles a warp
  static constexpr int kBStride = BN + 32;
  static constexpr int kBBytes = kBKp * kBStride;
  static constexpr int kStageBytes = kBBytes + (StreamA ? BM * kAStride : 0);
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

// The packed weights [kp, n] and how their rows may be copied: mode 16
// (n and the base 16-byte aligned), 4 (4-byte aligned) or 1 (bytes).
struct PackedB {
  const uint8_t* packed;
  int kp, n, mode;
};

__host__ __device__ inline int packed_mode(const void* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n % 16 == 0 && a % 16 == 0) return 16;
  return (n % 4 == 0 && a % 4 == 0) ? 4 : 1;
}

// Start the copy of packed rows [kBKp·t, +kBKp) × columns [n0, n0 + BN)
// into a stage; zeros past kp and n.
template <class T>
__device__ __forceinline__ void load_b_stage(unsigned char* dst, const PackedB& b,
                                             int t, int n0) {
  const int r0 = kBKp * t;
  if (b.mode == 16) {
    constexpr int kPerRow = T::BN / 16;
    for (int c = threadIdx.x; c < kBKp * kPerRow; c += T::kThreads) {
      const int r = c / kPerRow, col = 16 * (c % kPerRow);
      const bool in = r0 + r < b.kp && n0 + col < b.n;
      cp_async16(dst + r * T::kBStride + col,
                 b.packed + (in ? static_cast<size_t>(r0 + r) * b.n + n0 + col : 0),
                 in ? 16 : 0);
    }
  } else if (b.mode == 4) {
    constexpr int kPerRow = T::BN / 4;
    for (int c = threadIdx.x; c < kBKp * kPerRow; c += T::kThreads) {
      const int r = c / kPerRow, col = 4 * (c % kPerRow);
      const bool in = r0 + r < b.kp && n0 + col < b.n;
      cp_async4(dst + r * T::kBStride + col,
                b.packed + (in ? static_cast<size_t>(r0 + r) * b.n + n0 + col : 0),
                in);
    }
  } else {
    for (int c = threadIdx.x; c < kBKp * T::BN; c += T::kThreads) {
      const int r = c / T::BN, col = c % T::BN;
      const bool in = r0 + r < b.kp && n0 + col < b.n;
      dst[r * T::kBStride + col] =
          in ? b.packed[static_cast<size_t>(r0 + r) * b.n + n0 + col] : 0;
    }
  }
}

// A streamed from int8 rows x [m, k] (4-byte aligned rows) through the ring.
struct StreamedA {
  const int8_t* x;
  int m, k, m0;
  bool vec16;               // k % 16 == 0 and x 16-byte aligned
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

// Fold k-stages [t0, t1) of the CTA's BM × BN tile (columns from n0) into
// each warp's acc. ``a`` is the A policy: a.load<T>(slot, t) starts stage
// t's copy into the slot's A part (a no-op where A is resident),
// a.rows(slot, t) → stage t's first row, a.stride its row stride. Every
// thread of the CTA calls it; smem holds T::kSmemBytes.
template <class T, class A>
__device__ __forceinline__ void mainloop(int (&acc)[T::MT][T::NT][4],
                                         unsigned char* smem, const PackedB& b,
                                         int n0, int t0, int t1, const A& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  auto a_part = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + s * T::kStageBytes + T::kBBytes);
  };
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (t0 + s < t1) {
      load_b_stage<T>(smem + s * T::kStageBytes, b, t0 + s, n0);
      a.template load<T>(a_part(s), t0 + s);
    }
    cp_async_commit();
  }
  int slot = 0, next = T::kStages - 1;     // slots of stage t and of t + kStages − 1
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();                        // stage t landed; slot `next` is free
    if (t + T::kStages - 1 < t1) {
      load_b_stage<T>(smem + next * T::kStageBytes, b, t + T::kStages - 1, n0);
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

}  // namespace ternary_tile
