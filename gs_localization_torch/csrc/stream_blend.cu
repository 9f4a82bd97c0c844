// Stream blend forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gs_localization_tpu/raster/stream_blend.py:
//   K1  _fwd_kernel  (front-to-back alpha blend of each 16x16 tile over its
//                     chunk-aligned window of the transposed pair stream)
//   K2  _bwd_kernel  (reverse walk; per-pair gradients summed over the
//                     tile's 256 pixels, written at the pair's own position)
//
// Contract (shared with the plain PyTorch versions in stream_blend.py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = x - px (integer pixel px)
//   gated out when power > 0, opa exp(power) < 1/255, valid <= 0.5 or the
//   lane is past the tile's count; alpha = min(0.99, opa exp(power));
//   la = log(1 - alpha); a pair is applied while the INCLUSIVE log T >=
//   log(1e-4); w = alpha * T_before. A tile stops after the first chunk at
//   whose end every pixel has log T < log(1e-4); k_stop counts the chunks
//   it visited.
//
// What bounds it on the H100: the per-(pixel, pair) gate and blend math on
// the CUDA cores (fp32, transcendental exp/log), not memory: each walked
// chunk is 12 rows x chunk floats, read once per tile from HBM/L2 and then
// reused by all 256 pixels from shared memory. Design: one CTA of 256
// threads per tile, one thread per pixel; the block stages each chunk's 12
// rows in shared memory, every thread walks the chunk sequentially (no TPU
// triangular-matmul prefix), and the early exit is a block-wide vote at the
// end of each chunk. K2 reduces each pair's 10 gradient values over the
// tile's pixels with warp shuffles into per-warp partials in shared memory,
// then sums the 8 partials in a fixed order: deterministic, no atomics.
// Warps in which no pixel passes a pair's gate skip that pair's reduction.
//
// Ordering: CTAs run in any order. Each CTA writes only whole chunks inside
// its own aligned window (windows are disjoint because align == chunk), and
// the caller zero-fills dstream and masks positions >= kept_al, so nothing
// depends on the TPU's sequential grid order.
//
// The gate arithmetic uses explicitly rounded intrinsics (no FMA
// contraction) in the same order as the plain PyTorch version, so the
// 1/255 threshold test sees the same float on both sides. Build WITHOUT
// --use_fast_math: the gates are threshold tests.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kRows = 12;             // staged rows: x y a b c opa valid pad r g b depth
constexpr int kGrad = 10;             // gradient rows 0-5 and 8-11
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLogTEps = -9.210340371976182f;   // log(1e-4)

struct Window {
  int start;
  int count;
  int n_chunks;
};

// Clamp so a corrupt bin table can never index out of bounds (as the TPU
// kernel's DMA clamp).
__device__ __forceinline__ Window tile_window(const int* tstart,
                                              const int* wcount, int t,
                                              int mrpad, int chunk) {
  Window w;
  w.start = min(max(tstart[t], 0), mrpad - chunk);
  w.count = min(max(wcount[t], 0), mrpad - chunk - w.start);
  w.n_chunks = (w.count + chunk - 1) / chunk;
  return w;
}

__device__ __forceinline__ void stage_chunk(float* stage,
                                            const float* __restrict__ stream,
                                            int mrpad, int base, int chunk) {
  for (int idx = threadIdx.x; idx < kRows * chunk; idx += kPix) {
    const int r = idx / chunk;
    const int j = idx - r * chunk;
    stage[idx] = stream[(size_t)r * mrpad + base + j];
  }
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

__global__ void __launch_bounds__(kPix)
stream_fwd_kernel(const int* __restrict__ tstart, const int* __restrict__ wcount,
                  const float* __restrict__ stream, int mrpad, int grid_x,
                  int chunk, float* __restrict__ accum,
                  float* __restrict__ logt, float* __restrict__ resid) {
  extern __shared__ float stage[];   // kRows * chunk
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const float px = (float)((t % grid_x) * kTile + i % kTile);
  const float py = (float)((t / grid_x) * kTile + i / kTile);
  const Window win = tile_window(tstart, wcount, t, mrpad, chunk);

  float log_full = 0.0f;   // every alpha: the saturation test and resid
  float log_app = 0.0f;    // applied alphas only: the output transmittance
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;
  while (k < win.n_chunks) {
    const int base = win.start + k * chunk;
    const int lanes = min(chunk, win.count - k * chunk);
    __syncthreads();                 // previous chunk fully consumed
    stage_chunk(stage, stream, mrpad, base, chunk);
    __syncthreads();
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
    ++k;
    if (!__syncthreads_or(log_full >= kLogTEps)) break;
  }
  const size_t tp = (size_t)t * kPix + i;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) accum[((size_t)t * 4 + ch) * kPix + i] = acc[ch];
  logt[tp] = log_app;
  resid[2 * tp + 0] = log_full;
  resid[2 * tp + 1] = (float)k;
}

__global__ void __launch_bounds__(kPix)
stream_bwd_kernel(const int* __restrict__ tstart, const int* __restrict__ wcount,
                  const float* __restrict__ stream, int mrpad, int grid_x,
                  int chunk, const float* __restrict__ gacc,
                  const float* __restrict__ glogt,
                  const float* __restrict__ resid,
                  float* __restrict__ dstream) {
  extern __shared__ float smem[];
  float* stage = smem;                        // kRows * chunk
  float* part = smem + kRows * chunk;         // kWarps * kGrad * chunk
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int warp = i >> 5;
  const int lane = i & 31;
  const float px = (float)((t % grid_x) * kTile + i % kTile);
  const float py = (float)((t / grid_x) * kTile + i / kTile);
  const Window win = tile_window(tstart, wcount, t, mrpad, chunk);
  const size_t tp = (size_t)t * kPix + i;
  const int k_stop = min(max((int)resid[2 * (size_t)t * kPix + 1], 0), win.n_chunks);

  float log_after = resid[2 * tp];            // inclusive log T after the pair
  float gc[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) gc[ch] = gacc[((size_t)t * 4 + ch) * kPix + i];
  const float gl = glogt[tp];
  float suffix = 0.0f;                        // sum over later pairs of wbar * w

  for (int k = k_stop - 1; k >= 0; --k) {
    const int base = win.start + k * chunk;
    const int lanes = min(chunk, win.count - k * chunk);
    __syncthreads();                          // stage and partials free
    stage_chunk(stage, stream, mrpad, base, chunk);
    __syncthreads();
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
    __syncthreads();
    // fixed-order sum of the per-warp partials: deterministic
    for (int j = i; j < lanes; j += kPix) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) s += part[((size_t)wp * kGrad + q) * chunk + j];
        const int row = q < 6 ? q : q + 2;
        dstream[(size_t)row * mrpad + base + j] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory bytes each kernel needs at a given chunk.
size_t gsl_stream_fwd_smem(int chunk) { return sizeof(float) * kRows * chunk; }
size_t gsl_stream_bwd_smem(int chunk) {
  return sizeof(float) * (kRows + kWarps * kGrad) * (size_t)chunk;
}

int gsl_stream_fwd(const int* tstart, const int* wcount, const float* stream,
                   int num_tiles, int mrpad, int grid_x, int chunk,
                   float* accum, float* logt, float* resid, void* cuda_stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = gsl_stream_fwd_smem(chunk);
  stream_fwd_kernel<<<num_tiles, kPix, smem, (cudaStream_t)cuda_stream>>>(
      tstart, wcount, stream, mrpad, grid_x, chunk, accum, logt, resid);
  return (int)cudaGetLastError();
}

int gsl_stream_bwd(const int* tstart, const int* wcount, const float* stream,
                   int num_tiles, int mrpad, int grid_x, int chunk,
                   const float* gacc, const float* glogt, const float* resid,
                   float* dstream, void* cuda_stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = gsl_stream_bwd_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      stream_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_bwd_kernel<<<num_tiles, kPix, smem, (cudaStream_t)cuda_stream>>>(
      tstart, wcount, stream, mrpad, grid_x, chunk, gacc, glogt, resid, dstream);
  return (int)cudaGetLastError();
}

const char* gsl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
