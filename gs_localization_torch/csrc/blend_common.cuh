// Device helpers shared by the tile-blend kernels: the stream blend
// (stream_blend.cu, K1/K2) and the pregathered blend (pallas_blend.cu,
// K3/K4). Both walk a tile's pairs in chunks staged in shared memory as 12
// rows of `chunk` floats: x y a b c opa valid pad r g b depth.
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

}  // namespace gsl
