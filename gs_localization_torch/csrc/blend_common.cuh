// Device helpers shared by the tile-blend kernels: the stream blend
// (stream_blend.cu, K1/K2) and the pregathered blend (pallas_blend.cu,
// K3/K4). K1/K2 walk a tile's pairs in chunks staged in shared memory as 12
// rows of `chunk` floats: x y a b c opa valid pad r g b depth
// (blend_chunk_fwd / blend_chunk_bwd). K3/K4 walk pair-major pieces of at
// most kSub lanes, copied asynchronously (blend_piece_fwd /
// blend_piece_bwd, below); K1/K2 are to move onto those and the chunk walks
// to go.
//
// Contract (shared with the plain PyTorch versions in raster/stream_blend.py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = x - px (integer pixel px)
//   gated out when power > 0, opa exp(power) < 1/255, valid <= 0.5 or the
//   lane is past the tile's count; alpha = min(0.99, opa exp(power));
//   la = log(1 - alpha); a pair is applied while the INCLUSIVE log T >=
//   log(1e-4); w = alpha * T_before. A tile stops after the first chunk at
//   whose end every pixel has log T < log(1e-4); k_stop counts the chunks
//   it visited.
//
// The gate arithmetic uses explicitly rounded intrinsics (no FMA
// contraction) in the same order as the plain PyTorch version, so the
// 1/255 threshold test sees the same float on both sides. Build WITHOUT
// --use_fast_math: the gates are threshold tests.

#pragma once

#include <cuda_runtime.h>

namespace gsl {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kRows = 12;             // staged rows
constexpr int kGrad = 10;             // gradient rows: 0-5 geometry, 6-9 r g b depth
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLogTEps = -9.210340371976182f;   // log(1e-4)

// Shared memory bytes of the forward and backward kernels at a chunk.
inline size_t fwd_smem(int chunk) { return sizeof(float) * kRows * (size_t)chunk; }
inline size_t bwd_smem(int chunk) {
  return sizeof(float) * (kRows + kWarps * kGrad) * (size_t)chunk;
}

struct Gate {
  float dx, dy, expp, araw;
  bool in;
};

// Same operation order as stream_blend._chunk_alpha.
__device__ __forceinline__ Gate gate_of(const float* stage, int chunk, int j,
                                        float px, float py) {
  const float x = stage[0 * chunk + j];
  const float y = stage[1 * chunk + j];
  const float a = stage[2 * chunk + j];
  const float b = stage[3 * chunk + j];
  const float c = stage[4 * chunk + j];
  const float opa = stage[5 * chunk + j];
  const float vld = stage[6 * chunk + j];
  Gate g;
  g.dx = __fsub_rn(x, px);
  g.dy = __fsub_rn(y, py);
  const float qa = __fmul_rn(__fmul_rn(a, g.dx), g.dx);
  const float qc = __fmul_rn(__fmul_rn(c, g.dy), g.dy);
  const float qb = __fmul_rn(__fmul_rn(b, g.dx), g.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  g.expp = expf(fminf(power, 0.0f));
  g.araw = __fmul_rn(opa, g.expp);
  g.in = (power <= 0.0f) && (g.araw >= kAlphaMin) && (vld > 0.5f);
  return g;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pixel coordinates of this thread's pixel in tile t.
__device__ __forceinline__ void pixel_of(int t, int grid_x, float* px, float* py) {
  const int i = threadIdx.x;
  *px = (float)((t % grid_x) * kTile + i % kTile);
  *py = (float)((t / grid_x) * kTile + i / kTile);
}

// Forward walk of one staged chunk, front to back, for this thread's pixel.
__device__ __forceinline__ void blend_chunk_fwd(const float* stage, int chunk,
                                                int lanes, float px, float py,
                                                float& log_full, float& log_app,
                                                float acc[4]) {
  for (int j = 0; j < lanes; ++j) {
    const Gate g = gate_of(stage, chunk, j, px, py);
    if (!g.in) continue;           // alpha = 0: la = 0, w = 0
    const float alpha = fminf(kAlphaMax, g.araw);
    const float la = logf(1.0f - alpha);
    const float clog = log_full + la;
    if (clog >= kLogTEps) {
      const float w = alpha * expf(log_full);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] += w * stage[(8 + ch) * chunk + j];
      log_app += la;
    }
    log_full = clog;
  }
}

// Reverse walk of one staged chunk for this thread's pixel: the analytic
// adjoint of blend_chunk_fwd. Each pair's 10 gradient values are summed
// over the warp with shuffles into part[warp][q][j]; warps in which no
// pixel passes a pair's gate write zeros without reducing. `log_after` is
// the inclusive log T after the chunk's last pair and `suffix` the sum over
// later pairs of wbar * w; both are carried to the previous chunk.
__device__ __forceinline__ void blend_chunk_bwd(const float* stage, float* part,
                                                int chunk, int lanes, float px,
                                                float py, const float gc[4],
                                                float gl, float& log_after,
                                                float& suffix) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = lanes - 1; j >= 0; --j) {
    const Gate g = gate_of(stage, chunk, j, px, py);
    float v[kGrad];
#pragma unroll
    for (int q = 0; q < kGrad; ++q) v[q] = 0.0f;
    if (g.in) {
      const float a = stage[2 * chunk + j];
      const float b = stage[3 * chunk + j];
      const float c = stage[4 * chunk + j];
      const float alpha = fminf(kAlphaMax, g.araw);
      const float la = logf(1.0f - alpha);
      const float log_before = log_after - la;
      const bool applied = log_after >= kLogTEps;
      const float t_prev = expf(log_before);
      const float w = applied ? alpha * t_prev : 0.0f;
      float wbar = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) wbar += gc[ch] * stage[(8 + ch) * chunk + j];
      const float labar = suffix + (applied ? gl : 0.0f);
      const float abar = (applied ? wbar * t_prev : 0.0f) - labar / (1.0f - alpha);
      const bool unclamped = g.araw < kAlphaMax;
      const float dpow = unclamped ? abar * g.araw : 0.0f;
      const float dopa = unclamped ? abar * g.expp : 0.0f;
      v[0] = dpow * -(a * g.dx + b * g.dy);
      v[1] = dpow * -(c * g.dy + b * g.dx);
      v[2] = dpow * (-0.5f * g.dx * g.dx);
      v[3] = dpow * (-g.dx * g.dy);
      v[4] = dpow * (-0.5f * g.dy * g.dy);
      v[5] = dopa;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) v[6 + ch] = gc[ch] * w;
      suffix += wbar * w;
      log_after = log_before;
    }
    float* pj = part + (size_t)warp * kGrad * chunk + j;
    if (__any_sync(0xffffffffu, g.in)) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) {
        const float s = warp_sum(v[q]);
        if (lane == 0) pj[q * chunk] = s;
      }
    } else if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) pj[q * chunk] = 0.0f;
    }
  }
}

// Fixed-order sum of the per-warp partials of gradient row q, lane j:
// deterministic, no atomics.
__device__ __forceinline__ float sum_partials(const float* part, int chunk,
                                              int q, int j) {
  float s = 0.0f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) s += part[((size_t)wp * kGrad + q) * chunk + j];
  return s;
}

// ---------------------------------------------------------------------------
// Piece walks: pair-major staging in sub-chunks ("pieces"), used by K3/K4.
//
// A piece is at most kSub lanes of one contract chunk, staged pair-major:
// pair j's 12 values at stage[j * kPairStride], padded to 16 floats, so a
// warp reads a pair with three broadcast float4 loads (x y a b | c opa valid
// pad | r g b depth) instead of one scalar load per value. kStages buffers:
// the next piece in walk order is copied (cp.async) while the current one
// is walked. The order of pairs and every value a threshold reads (the
// gate, log T and its subtraction) are computed as in blend_chunk_fwd /
// blend_chunk_bwd. Where no threshold reads the value -- the transmittance
// T = exp(log T) that weights an applied pair (log T >= log(1e-4) there, so
// the argument lies in [-9.22, 0]) and the backward's division by
// 1 - alpha >= 0.01 -- the walks use the hardware approximations __expf
// and __fdividef (a few ulp), which take a fraction of the instructions of
// the accurate expf and IEEE division.
// ---------------------------------------------------------------------------

constexpr int kSub = 64;           // lanes per staged piece
constexpr int kPairStride = 16;    // floats per staged pair
constexpr int kStages = 2;         // staging buffers
constexpr int kStageFloats = kSub * kPairStride;
// Occupancy target of K3/K4 (__launch_bounds__ minimum CTAs per SM):
// registers, not shared memory, bound their CTAs per SM. Tighter register
// caps (6 CTAs per SM) measured slower on the H100.
constexpr int kPieceMinBlocks = 4;

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lanes [start, start + n) of one piece of a walk over [0, end): piece p is
// sub-piece i = p % nsub of contract chunk k = p / nsub.
struct Piece {
  int start, n;
};
__device__ __forceinline__ Piece piece_of(int p, int chunk, int sw, int nsub,
                                          int end) {
  const int k = p / nsub;
  const int i = p - k * nsub;
  Piece q;
  q.start = k * chunk + i * sw;
  q.n = min(min(sw, chunk - i * sw), end - q.start);
  return q;
}
// Pieces that cover [0, end).
__device__ __forceinline__ int pieces_of(int end, int chunk, int sw, int nsub) {
  if (end <= 0) return 0;
  const int kl = (end - 1) / chunk;
  return kl * nsub + (end - kl * chunk + sw - 1) / sw;
}

// gate_of on a staged pair: the same operations in the same order.
__device__ __forceinline__ Gate gate_of_pair(const float4 g0, const float4 g1,
                                             float px, float py) {
  Gate g;
  g.dx = __fsub_rn(g0.x, px);
  g.dy = __fsub_rn(g0.y, py);
  const float qa = __fmul_rn(__fmul_rn(g0.z, g.dx), g.dx);
  const float qc = __fmul_rn(__fmul_rn(g1.x, g.dy), g.dy);
  const float qb = __fmul_rn(__fmul_rn(g0.w, g.dx), g.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  g.expp = expf(fminf(power, 0.0f));
  g.araw = __fmul_rn(g1.y, g.expp);
  g.in = (power <= 0.0f) && (g.araw >= kAlphaMin) && (g1.z > 0.5f);
  return g;
}

// Forward walk of one staged piece (blend_chunk_fwd's arithmetic).
__device__ __forceinline__ void blend_piece_fwd(const float* stage, int lanes,
                                                float px, float py,
                                                float& log_full, float& log_app,
                                                float acc[4]) {
  const float4* p = reinterpret_cast<const float4*>(stage);
  for (int j = 0; j < lanes; ++j) {
    const Gate g = gate_of_pair(p[4 * j], p[4 * j + 1], px, py);
    if (!g.in) continue;           // alpha = 0: la = 0, w = 0
    const float alpha = fminf(kAlphaMax, g.araw);
    const float la = logf(1.0f - alpha);
    const float clog = log_full + la;
    if (clog >= kLogTEps) {
      const float4 c = p[4 * j + 2];
      const float w = alpha * __expf(log_full);
      acc[0] += w * c.x;
      acc[1] += w * c.y;
      acc[2] += w * c.z;
      acc[3] += w * c.w;
      log_app += la;
    }
    log_full = clog;
  }
}

// Transposed (recursive-halving) sum of ten values over the warp. At each
// offset a lane keeps half of its values and sends the other half, so the
// ten sums take 5 + 3 + 2 + 1 + 1 = 12 shuffles, not ten 5-shuffle trees.
// Every lane returns one full sum; which one is reduce10_slot(lane).
static_assert(kGrad == 10, "reduce10 folds exactly ten gradient values");
__device__ __forceinline__ float reduce10(const float v[kGrad], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {     // offset 16: 10 -> 5
    const float keep = b16 ? v[i + 5] : v[i];
    const float send = b16 ? v[i] : v[i + 5];
    a[i] = keep + __shfl_xor_sync(kAll, send, 16);
  }
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {     // offset 8: 5 -> 3 (lanes with bit 3: 2)
    const float hi = i + 3 < 5 ? a[i + 3] : 0.0f;
    const float keep = b8 ? hi : a[i];
    const float send = b8 ? a[i] : hi;
    c[i] = keep + __shfl_xor_sync(kAll, send, 8);
  }
  float d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // offset 4: 3 -> 2
    const float hi = i + 2 < 3 ? c[i + 2] : 0.0f;
    const float keep = b4 ? hi : c[i];
    const float send = b4 ? c[i] : hi;
    d[i] = keep + __shfl_xor_sync(kAll, send, 4);
  }
  // offset 2: 2 -> 1; offset 1: the last pairwise sum
  float e = (b2 ? d[1] : d[0]) + __shfl_xor_sync(kAll, b2 ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(kAll, e, 1);
}

// The value index whose sum reduce10 leaves on this lane, or -1 where the
// lane holds padding or is the odd lane of a pair holding the same sum:
// exactly ten lanes get an index, each index once.
__device__ __forceinline__ int reduce10_slot(int lane) {
  const int b16 = (lane >> 4) & 1, b8 = (lane >> 3) & 1;
  const int o = ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  if ((lane & 1) || o >= (b8 ? 2 : 3)) return -1;
  return 5 * b16 + 3 * b8 + o;
}

// Reverse walk of one staged piece (blend_chunk_bwd's arithmetic). Each
// pair's 10 gradient values are folded over the warp by reduce10 into
// part[warp][j][q] (kSub x kGrad floats per warp); warps in which no pixel
// passes a pair's gate write zeros without reducing. `slot` is
// reduce10_slot(lane).
__device__ __forceinline__ void blend_piece_bwd(const float* stage, float* part,
                                                int lanes, float px, float py,
                                                const float gc[4], float gl,
                                                int slot, float& log_after,
                                                float& suffix) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* p = reinterpret_cast<const float4*>(stage);
  float* pw = part + (size_t)warp * kSub * kGrad;
  for (int j = lanes - 1; j >= 0; --j) {
    const float4 g0 = p[4 * j];
    const float4 g1 = p[4 * j + 1];
    const Gate g = gate_of_pair(g0, g1, px, py);
    float v[kGrad];
#pragma unroll
    for (int q = 0; q < kGrad; ++q) v[q] = 0.0f;
    if (g.in) {
      const float4 c = p[4 * j + 2];
      const float a = g0.z, b = g0.w, cc = g1.x;
      const float alpha = fminf(kAlphaMax, g.araw);
      const float la = logf(1.0f - alpha);
      const float log_before = log_after - la;
      const bool applied = log_after >= kLogTEps;
      const float t_prev = __expf(log_before);
      const float w = applied ? alpha * t_prev : 0.0f;
      float wbar = 0.0f;
      wbar += gc[0] * c.x;
      wbar += gc[1] * c.y;
      wbar += gc[2] * c.z;
      wbar += gc[3] * c.w;
      const float labar = suffix + (applied ? gl : 0.0f);
      const float abar = (applied ? wbar * t_prev : 0.0f)
                         - __fdividef(labar, 1.0f - alpha);
      const bool unclamped = g.araw < kAlphaMax;
      const float dpow = unclamped ? abar * g.araw : 0.0f;
      const float dopa = unclamped ? abar * g.expp : 0.0f;
      v[0] = dpow * -(a * g.dx + b * g.dy);
      v[1] = dpow * -(cc * g.dy + b * g.dx);
      v[2] = dpow * (-0.5f * g.dx * g.dx);
      v[3] = dpow * (-g.dx * g.dy);
      v[4] = dpow * (-0.5f * g.dy * g.dy);
      v[5] = dopa;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) v[6 + ch] = gc[ch] * w;
      suffix += wbar * w;
      log_after = log_before;
    }
    float s = 0.0f;
    if (__any_sync(0xffffffffu, g.in)) s = reduce10(v, lane);
    if (slot >= 0) pw[j * kGrad + slot] = s;
  }
}

// Fixed-order sum over the warps of piece lane j's gradient q (the layout of
// blend_piece_bwd): deterministic, no atomics.
__device__ __forceinline__ float sum_piece_partials(const float* part, int j,
                                                    int q) {
  float s = 0.0f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) s += part[((size_t)wp * kSub + j) * kGrad + q];
  return s;
}

// Host: CTAs per SM at kPix threads, registers per thread, shared memory per
// CTA (static + dyn_smem) and local (spill) bytes per thread of a kernel,
// into out[0..3]. Returns a cudaError_t.
template <typename Kernel>
inline int kernel_info(Kernel kernel, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  if (dyn_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn_smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPix, dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)(a.sharedSizeBytes + dyn_smem);
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// K1/K2's kernel_info (stream_blend.cu): which 0 = K1, 1 = K2.
int stream_kernel_info(int which, int chunk, int* out);

}  // namespace gsl
