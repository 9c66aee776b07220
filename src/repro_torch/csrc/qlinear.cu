// Fused TINT projection and whole FFN for Hopper (sm_90a), on the ternary
// tile core (ternary_tile.cuh: int8 mma.sync fed by packed codes decoded
// in registers, k streamed through a cp.async ring, split-k over a
// cluster with exact distributed-shared-memory sums).
//
// Replaces the Pallas bodies src/repro/kernels/qlinear.py:_qlinear_kernel
// (fused_qlinear) and :_ffn_kernel (fused_ffn).
//
// What it computes, per output row r and column n:
//   xq, xs = absmax_barrier(x[r, :])                 (bitwise the plain version)
//   acc    = Σ_k xq[k] · w[k, n]                      (int32, w ∈ {−1, 0, 1})
//   y      = ((float(acc) · xs) · γ[n]) + bias[n], then the activation.
// The FFN runs act(g)·u with g, u the gate and up projections of one
// packed gate‖up stream (or act(x·W) ungated) into an f32 hidden row h,
// then the same barrier on h and the projection by the down weights, so
// the hidden barrier is the same exact absmax function the TPU kernel
// ran in VMEM.
//
// Both take the TPU kernels' leading expert axis: x [E, C, k] against
// expert stacks packed [E, k/4, n] with γ [E, n] (bias [E, n]), expert e's
// rows against expert e's weights, all E in the same launches. E = 1 is
// the plain projection.
//
// Launches, all issued by one C entry: #1 barrier → GEMM; #2 barrier(x)
// → gate‖up GEMM → barrier(h) → down GEMM.
//  * The barrier pass (barrier_kernel, a CTA a row) reads the f32 row
//    twice (absmax, then quantize) and writes int8 rows of k rounded up to
//    16, zero-filled, plus the row's scale, into scratch the wrapper
//    allocates. So any k runs (the TPU's bkq k-tiled barrier, bitwise the
//    single pass because the max is exact), and each row is quantized
//    once for all its column tiles.
//  * The GEMM is #7's (decode tile 16 × 128 for m ≤ 16, chunk tile
//    128 × 128 above; split-k over a cluster where the tiles alone leave
//    SMs idle; the tile sweep may name the tile and the split, which
//    changes no bit) with an epilogue on each CTA's share of the summed tile:
//    dequant · γ (+ bias)(+ act) for a projection; for gate‖up a CTA's
//    128 columns are 64 gate columns from n0 and the matching 64 up
//    columns from f + n0 (warps 0–1 gate, 2–3 up), which meet in the
//    epilogue as h = act(g)·u, 64 columns of h a CTA.
//  * The expert is a grid coordinate: blockIdx.x = e · (tiles of one
//    expert) + tile, and each CTA offsets its rows, packed weights, γ
//    (bias) and output by e, so no tile straddles two experts; the tile
//    (decode 16 rows for C ≤ 16, chunk 128 above) follows the rows of ONE
//    expert, and the launch plan counts the tiles of all E when it picks
//    the split-k. The barrier pass runs over the E·C rows as they are.
//    An all-zero row (an empty capacity slot of a MoE dispatch) gets the
//    clamped scale EPS/127 and q = 0, so its outputs are exact zeros.
//
// What bounds it: at decode (m ≤ 16) the packed 2-bit weight stream,
// k/4 · n bytes read once (bytes-bound, 3.35 TB/s); at a 128-row chunk
// the 2·m·k·n int8 operations.
#include "ternary_tile.cuh"

namespace {

using ternary_tile::Launch;
using ternary_tile::PackedB;
using ternary_tile::StreamedA;

using DecodeTile = ternary_tile::Tile<16, 128, 1, 4, 4>;
using ChunkTile = ternary_tile::Tile<128, 128, 1, 4, 4>;

constexpr int kBarrierWarps = 8;

__host__ __device__ inline int pad16(int k) { return (k + 15) & ~15; }

__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) return y / (1.0f + expf(-y));                      // silu
  if (act == 2) {                                                  // tanh gelu
    const float c = 0.7978845608028654f;
    float inner = c * (y + 0.044715f * (y * y * y));
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  if (act == 3) {                                                  // squared relu
    const float r = fmaxf(y, 0.0f);
    return __fmul_rn(r, r);
  }
  return y;
}

__device__ __forceinline__ unsigned quantize4(float4 v, float scale) {
  return static_cast<uint8_t>(barrier_quantize(v.x, scale))
         | static_cast<unsigned>(static_cast<uint8_t>(barrier_quantize(v.y, scale))) << 8
         | static_cast<unsigned>(static_cast<uint8_t>(barrier_quantize(v.z, scale))) << 16
         | static_cast<unsigned>(static_cast<uint8_t>(barrier_quantize(v.w, scale))) << 24;
}

// Row blockIdx.x of x f32 [m, k] (k % 4 == 0) → xq int8 [m, k16] (zeros
// past k) and xs f32 [m].
__global__ void __launch_bounds__(32 * kBarrierWarps)
barrier_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
               float* __restrict__ xs, int k, int k16) {
  __shared__ float red[kBarrierWarps];
  const size_t row = blockIdx.x;
  const float* src = x + row * k;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  auto load4 = [&](int i) {
    return vec ? src4[i] : make_float4(src[4 * i], src[4 * i + 1],
                                       src[4 * i + 2], src[4 * i + 3]);
  };
  float amax = 0.0f;
  for (int i = threadIdx.x; i < k / 4; i += blockDim.x) {
    const float4 v = load4(i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  const float scale = barrier_scale(block_max<kBarrierWarps>(amax, red));
  unsigned* dst = reinterpret_cast<unsigned*>(xq + row * k16);
  for (int i = threadIdx.x; i < k16 / 4; i += blockDim.x)
    dst[i] = 4 * i < k ? quantize4(load4(i), scale) : 0u;
  if (threadIdx.x == 0) xs[row] = scale;
}

// y = act(((acc · xs[row]) · γ[col]) + bias[col]) into out [m, n].
struct Dequant {
  static constexpr bool kPaired = false;
  float* out;
  const float* xs;
  const float* gamma;
  const float* bias;
  int m0, n0, n, act;

  __device__ __forceinline__ bool valid(int c) const { return n0 + c < n; }
  __device__ __forceinline__ void store(int r, int c, int4 v, int4) const {
    const int row = m0 + r, col = n0 + c;
    const float s = xs[row];
    const int a[4] = {v.x, v.y, v.z, v.w};
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e >= n) break;
      y[e] = __fmul_rn(__fmul_rn(static_cast<float>(a[e]), s), gamma[col + e]);
      if (bias != nullptr) y[e] = __fadd_rn(y[e], bias[col + e]);
      y[e] = act_fn(y[e], act);
    }
    float* o = out + static_cast<size_t>(row) * n + col;
    if (n % 4 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      for (int e = 0; e < 4 && col + e < n; ++e) o[e] = y[e];
    }
  }
};

// h = act(g)·u with g (tile columns [0, 64)) and u (the up columns 64 on)
// dequantized by their own γ, into h [m, f].
struct GateUp {
  static constexpr bool kPaired = true;
  float* h;
  const float* xs;
  const float* gamma;
  int m0, n0, f, act;

  __device__ __forceinline__ bool valid(int c) const { return n0 + c < f; }
  __device__ __forceinline__ void store(int r, int c, int4 v, int4 u) const {
    const int row = m0 + r, col = n0 + c;
    const float s = xs[row];
    const int g[4] = {v.x, v.y, v.z, v.w}, up[4] = {u.x, u.y, u.z, u.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // f % 4 == 0: the group is whole
      const float gv = __fmul_rn(__fmul_rn(static_cast<float>(g[e]), s),
                                 gamma[col + e]);
      const float uv = __fmul_rn(__fmul_rn(static_cast<float>(up[e]), s),
                                 gamma[f + col + e]);
      y[e] = __fmul_rn(act_fn(gv, act), uv);
    }
    *reinterpret_cast<float4*>(h + static_cast<size_t>(row) * f + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
};

// The CTA's expert, and its tile among that expert's tiles of BM rows ×
// `cols` output columns over m rows and n_out columns: blockIdx.x =
// e · tiles_m · tiles_n + j · tiles_m + (m0 / BM).
struct ExpertTile {
  size_t e;
  int m0, j;
};

template <class T>
__device__ __forceinline__ ExpertTile expert_tile(int m, int n_out, int cols) {
  const int tiles_m = (m + T::BM - 1) / T::BM;
  const int per = tiles_m * ((n_out + cols - 1) / cols);
  const int t = static_cast<int>(blockIdx.x % per);
  return {blockIdx.x / per, (t % tiles_m) * T::BM, t / tiles_m};
}

// Projection of expert e: xq [E, m, k16] × packed [E, k/4, n] → Dequant
// into out [E, m, n] (γ, bias [E, n]).
template <class T>
__device__ __forceinline__ void project_body(const int8_t* xq, const float* xs,
                                             const uint8_t* packed,
                                             const float* gamma,
                                             const float* bias, float* out,
                                             int m, int k, int n, int act) {
  const ExpertTile t = expert_tile<T>(m, n, T::BN);
  const int k16 = pad16(k), n0 = t.j * T::BN;
  const size_t rows = t.e * m;
  ternary_tile::run_tile<T>(
      StreamedA{xq + rows * k16, m, k16, t.m0, true},
      ternary_tile::packed_columns<T>(packed + t.e * (k / 4) * n, k / 4, n, n0),
      k16, min(T::BM, m - t.m0),
      Dequant{out + rows * n, xs + rows, gamma + t.e * n,
              bias == nullptr ? nullptr : bias + t.e * n, t.m0, n0, n, act});
}

// Gate‖up of expert e: xq [E, m, k16] × packed [E, k/4, 2f] → GateUp into
// h [E, m, f] (γ [E, 2f]), 64 columns of h a tile.
template <class T>
__device__ __forceinline__ void gate_up_body(const int8_t* xq, const float* xs,
                                             const uint8_t* packed,
                                             const float* gamma, float* h,
                                             int m, int k, int f, int act) {
  constexpr int kHalf = T::BN / 2;
  const ExpertTile t = expert_tile<T>(m, f, kHalf);
  const int k16 = pad16(k), n0 = t.j * kHalf;
  const size_t rows = t.e * m;
  const uint8_t* pe = packed + t.e * (k / 4) * (2 * f);
  const PackedB b{pe, k / 4, 2 * f, ternary_tile::packed_mode(pe, f),
                  n0, f + n0, f, 2 * f};
  ternary_tile::run_tile<T>(StreamedA{xq + rows * k16, m, k16, t.m0, true}, b,
                            k16, min(T::BM, m - t.m0),
                            GateUp{h + rows * f, xs + rows,
                                   gamma + t.e * (2 * f), t.m0, n0, f, act});
}

__global__ void __launch_bounds__(DecodeTile::kThreads)
qlinear_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ gamma,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int m, int k, int n, int act) {
  project_body<DecodeTile>(xq, xs, packed, gamma, bias, out, m, k, n, act);
}

__global__ void __launch_bounds__(ChunkTile::kThreads)
qlinear_chunk_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ gamma,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int m, int k, int n, int act) {
  project_body<ChunkTile>(xq, xs, packed, gamma, bias, out, m, k, n, act);
}

__global__ void __launch_bounds__(DecodeTile::kThreads)
gate_up_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ gamma, float* __restrict__ h,
                      int m, int k, int f, int act) {
  gate_up_body<DecodeTile>(xq, xs, packed, gamma, h, m, k, f, act);
}

__global__ void __launch_bounds__(ChunkTile::kThreads)
gate_up_chunk_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ gamma, float* __restrict__ h,
                     int m, int k, int f, int act) {
  gate_up_body<ChunkTile>(xq, xs, packed, gamma, h, m, k, f, act);
}

using ProjectKernel = void (*)(const int8_t*, const float*, const uint8_t*,
                               const float*, const float*, float*, int, int,
                               int, int);
using GateUpKernel = void (*)(const int8_t*, const float*, const uint8_t*,
                              const float*, float*, int, int, int, int);

// The launch of the GEMM over `experts` × m rows and n_out output columns
// (64 a tile for gate‖up, whose n_out is f), and its kernel. split: the
// CTAs a tile's k is split over (0 = the planner's choice).
template <class T, class K>
cudaError_t plan_tiles(K kernel, int experts, int m, int k, int n_out,
                       bool paired, int split, Launch* l) {
  const int cols = paired ? T::BN / 2 : T::BN;
  const long long tiles = static_cast<long long>(experts)
                          * ((m + T::BM - 1) / T::BM)
                          * ((n_out + cols - 1) / cols);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return ternary_tile::plan<T>(kernel, tiles, pad16(k), split, l);
}

// Whether m rows take the decode tile: by m (tile 0), or the tile of
// `tile` rows (16 or 128) that a caller names.
cudaError_t decode_tile(int m, int tile, bool* decode) {
  if (tile != 0 && tile != DecodeTile::BM && tile != ChunkTile::BM)
    return cudaErrorInvalidValue;
  *decode = tile ? tile == DecodeTile::BM : m <= DecodeTile::BM;
  return cudaSuccess;
}

cudaError_t plan_project(int experts, int m, int k, int n, int split, int tile,
                         ProjectKernel* kernel, Launch* l) {
  bool decode;
  const cudaError_t err = decode_tile(m, tile, &decode);
  if (err != cudaSuccess) return err;
  if (decode) {
    *kernel = qlinear_decode_kernel;
    return plan_tiles<DecodeTile>(*kernel, experts, m, k, n, false, split, l);
  }
  *kernel = qlinear_chunk_kernel;
  return plan_tiles<ChunkTile>(*kernel, experts, m, k, n, false, split, l);
}

cudaError_t plan_gate_up(int experts, int m, int k, int f, int split, int tile,
                         GateUpKernel* kernel, Launch* l) {
  bool decode;
  const cudaError_t err = decode_tile(m, tile, &decode);
  if (err != cudaSuccess) return err;
  if (decode) {
    *kernel = gate_up_decode_kernel;
    return plan_tiles<DecodeTile>(*kernel, experts, m, k, f, true, split, l);
  }
  *kernel = gate_up_chunk_kernel;
  return plan_tiles<ChunkTile>(*kernel, experts, m, k, f, true, split, l);
}

cudaError_t barrier(const float* x, int8_t* xq, float* xs, int rows, int k,
                    cudaStream_t s) {
  barrier_kernel<<<rows, 32 * kBarrierWarps, 0, s>>>(x, xq, xs, k, pad16(k));
  return cudaGetLastError();
}

cudaError_t project(const int8_t* xq, const float* xs, const uint8_t* packed,
                    const float* gamma, const float* bias, float* out,
                    int experts, int m, int k, int n, int act, int split,
                    int tile, cudaStream_t s) {
  ProjectKernel kernel;
  Launch l;
  const cudaError_t err = plan_project(experts, m, k, n, split, tile, &kernel, &l);
  if (err != cudaSuccess) return err;
  return ternary_tile::launch(kernel, l, s, xq, xs, packed, gamma, bias, out,
                              m, k, n, act);
}

}  // namespace

extern "C" {

// The GEMM launch of a projection x [E, m, k] × packed [E, k/4, n] (gated =
// 0) or of the gate‖up stage of an FFN of hidden width n (gated = 1), at
// the tile sweep's split and tile (0, 0: the planner's): info ← {CTAs,
// warps per CTA, dynamic shared-memory bytes, output tiles, CTAs a tile's
// k is split over, rows a tile}.
int repro_qlinear_shape(int experts, int m, int k, int n, int gated, int split,
                        int tile, void* info) {
  Launch l;
  cudaError_t err;
  if (gated) {
    GateUpKernel kernel;
    err = plan_gate_up(experts, m, k, n, split, tile, &kernel, &l);
  } else {
    ProjectKernel kernel;
    err = plan_project(experts, m, k, n, split, tile, &kernel, &l);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  ternary_tile::launch_info(l, static_cast<int*>(info));
  return 0;
}

// y = act(((xq·W)·xs)·γ + bias), expert by expert. x f32 [E, m, k]; packed
// uint8 [E, k/4, n]; gamma f32 [E, n]; bias f32 [E, n] or null; out f32
// [E, m, n]; scratch: xq int8 [E·m, k rounded up to 16] and xs f32 [E·m],
// 16-byte aligned. k % 4 == 0, E ≥ 1, m ≥ 1, n ≥ 1. split (1..8) and tile
// (16, 128) name the GEMM's cluster and row tile, 0 the planner's choice:
// the same bits at every setting.
int repro_qlinear(const void* x, const void* packed, const void* gamma,
                  const void* bias, void* out, void* xq, void* xs, int experts,
                  int m, int k, int n, int act, int split, int tile,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(xq);
  auto qs = static_cast<float*>(xs);
  cudaError_t err = barrier(static_cast<const float*>(x), q, qs, experts * m,
                            k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = project(q, qs, static_cast<const uint8_t*>(packed),
                static_cast<const float*>(gamma),
                static_cast<const float*>(bias), static_cast<float*>(out),
                experts, m, k, n, act, split, tile, s);
  return static_cast<int>(err);
}

// The whole FFN, expert by expert. x f32 [E, m, k]; gu_packed uint8 [E,
// k/4, 2f] (gate ‖ up; [E, k/4, f] ungated) with gu_scale f32 [E, 2f] (or
// [E, f]); down_packed uint8 [E, f/4, d_out] with down_scale f32 [E,
// d_out]; out f32 [E, m, d_out]; scratch, 16-byte aligned: xq int8 [E·m,
// k16], xs f32 [E·m], h f32 [E·m, f], hq int8 [E·m, f16], hs f32 [E·m]
// (k16, f16: rounded up to 16). k % 4 == f % 4 == 0, E ≥ 1, m ≥ 1,
// d_out ≥ 1. split_gu / split_down name the two GEMMs' clusters and tile
// their row tile (0: the planner's choice; the same bits at any setting).
int repro_ffn(const void* x, const void* gu_packed, const void* gu_scale,
              const void* down_packed, const void* down_scale, void* out,
              void* xq, void* xs, void* h, void* hq, void* hs, int experts,
              int m, int k, int f, int d_out, int gated, int act, int split_gu,
              int split_down, int tile, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(xq);
  auto qs = static_cast<float*>(xs);
  auto hf = static_cast<float*>(h);
  auto hq8 = static_cast<int8_t*>(hq);
  auto hsc = static_cast<float*>(hs);
  auto gu = static_cast<const uint8_t*>(gu_packed);
  auto gus = static_cast<const float*>(gu_scale);
  const int rows = experts * m;
  cudaError_t err = barrier(static_cast<const float*>(x), q, qs, rows, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gated) {
    GateUpKernel kernel;
    Launch l;
    err = plan_gate_up(experts, m, k, f, split_gu, tile, &kernel, &l);
    if (err == cudaSuccess)
      err = ternary_tile::launch(kernel, l, s, static_cast<const int8_t*>(q),
                                 static_cast<const float*>(qs), gu, gus, hf, m,
                                 k, f, act);
  } else {
    err = project(q, qs, gu, gus, nullptr, hf, experts, m, k, f, act, split_gu,
                  tile, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = barrier(hf, hq8, hsc, rows, f, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = project(hq8, hsc, static_cast<const uint8_t*>(down_packed),
                static_cast<const float*>(down_scale), nullptr,
                static_cast<float*>(out), experts, m, f, d_out, 0, split_down,
                tile, s);
  return static_cast<int>(err);
}

}  // extern "C"
