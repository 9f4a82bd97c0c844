// Pregathered blend forward (K3) and backward (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gs_localization_tpu/raster/pallas_blend.py:
//   K3  _fwd_kernel  (front-to-back alpha blend of each 16x16 tile over its
//                     own pregathered window: geom (8, cap) rows x y a b c
//                     opa valid pad and rgbd (4, cap) rows r g b depth)
//   K4  _bwd_kernel  (reverse walk from k_stop - 1 to 0 with log T rebuilt
//                     from the forward's residuals; per-pair gradients
//                     summed over the tile's 256 pixels, written into the
//                     tile's own (8, cap) and (4, cap) gradient blocks)
//
// The blend contract and the per-chunk walks are in blend_common.cuh,
// shared with the stream kernels (stream_blend.cu), so K3/K4 compute what
// K1/K2 compute on a window that was gathered per tile beforehand.
//
// What bounds it on the H100: the per-(pixel, pair) gate and blend math on
// the CUDA cores (fp32, exp/log), as for K1/K2. Each walked chunk (12 rows
// x chunk floats) is read once per tile from HBM into shared memory and
// reused by all 256 pixels. K4 also writes the whole (12, cap) gradient
// block of every tile, walked or not. Design: one CTA of 256 threads per
// tile, one thread per pixel; chunks staged in shared memory and walked
// sequentially by each thread; early exit by a block-wide vote
// (__syncthreads_or) at the end of each chunk, as the TPU kernel's
// while_loop tests max log T before each chunk. K4 first zero-fills its
// tile's gradient blocks, then writes every lane of each visited chunk:
// lanes >= count come out exactly 0, which matters because the caller's
// gather adjoint adds them into real Gaussians (masked lanes of the
// binning's id matrix hold real ids). Per-pair sums over the pixels use warp
// shuffles and a fixed-order sum of per-warp partials: deterministic, no
// atomics. Windows of different tiles are disjoint, so CTAs may run in any
// order.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gsl;

constexpr int kGeomRows = 8;
constexpr int kRgbdRows = 4;

// The tile's count clamped to [0, cap], as a corrupt table must never
// index past the window.
__device__ __forceinline__ int tile_count(const int* counts, int t, int cap) {
  return min(max(counts[t], 0), cap);
}

__device__ __forceinline__ void stage_chunk(float* stage,
                                            const float* __restrict__ geom,
                                            const float* __restrict__ rgbd,
                                            int t, int cap, int base,
                                            int chunk) {
  const float* g = geom + (size_t)t * kGeomRows * cap + base;
  const float* c = rgbd + (size_t)t * kRgbdRows * cap + base;
  for (int idx = threadIdx.x; idx < kRows * chunk; idx += kPix) {
    const int r = idx / chunk;
    const int j = idx - r * chunk;
    stage[idx] = r < kGeomRows ? g[(size_t)r * cap + j]
                               : c[(size_t)(r - kGeomRows) * cap + j];
  }
}

__global__ void __launch_bounds__(kPix)
pregathered_fwd_kernel(const int* __restrict__ counts,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, float* __restrict__ accum,
                       float* __restrict__ logt, float* __restrict__ resid) {
  extern __shared__ float stage[];   // kRows * chunk
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, &px, &py);
  const int count = tile_count(counts, t, cap);
  const int n_chunks = (count + chunk - 1) / chunk;

  float log_full = 0.0f;   // every alpha: the saturation test and resid
  float log_app = 0.0f;    // applied alphas only: the output transmittance
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;
  while (k < n_chunks) {
    const int base = k * chunk;
    const int lanes = min(chunk, count - base);
    __syncthreads();                 // previous chunk fully consumed
    stage_chunk(stage, geom, rgbd, t, cap, base, chunk);
    __syncthreads();
    blend_chunk_fwd(stage, chunk, lanes, px, py, log_full, log_app, acc);
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
pregathered_bwd_kernel(const int* __restrict__ counts,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, const float* __restrict__ gacc,
                       const float* __restrict__ glogt,
                       const float* __restrict__ resid,
                       float* __restrict__ dgeom, float* __restrict__ drgbd) {
  extern __shared__ float smem[];
  float* stage = smem;                        // kRows * chunk
  float* part = smem + kRows * chunk;         // kWarps * kGrad * chunk
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, &px, &py);
  const int count = tile_count(counts, t, cap);
  const int n_chunks = (count + chunk - 1) / chunk;
  const size_t tp = (size_t)t * kPix + i;
  const int k_stop = min(max((int)resid[2 * (size_t)t * kPix + 1], 0), n_chunks);

  float* dg = dgeom + (size_t)t * kGeomRows * cap;
  float* dc = drgbd + (size_t)t * kRgbdRows * cap;
  for (int idx = i; idx < kGeomRows * cap; idx += kPix) dg[idx] = 0.0f;
  for (int idx = i; idx < kRgbdRows * cap; idx += kPix) dc[idx] = 0.0f;

  float log_after = resid[2 * tp];            // inclusive log T after the pair
  float gc[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) gc[ch] = gacc[((size_t)t * 4 + ch) * kPix + i];
  const float gl = glogt[tp];
  float suffix = 0.0f;                        // sum over later pairs of wbar * w

  for (int k = k_stop - 1; k >= 0; --k) {
    const int base = k * chunk;
    const int lanes = min(chunk, count - base);
    __syncthreads();   // stage and partials free; the zero fill is ordered
                       // before the writes below
    stage_chunk(stage, geom, rgbd, t, cap, base, chunk);
    __syncthreads();
    blend_chunk_bwd(stage, part, chunk, lanes, px, py, gc, gl, log_after,
                    suffix);
    __syncthreads();
    for (int j = i; j < lanes; j += kPix) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) {
        const float s = sum_partials(part, chunk, q, j);
        if (q < 6) {
          dg[(size_t)q * cap + base + j] = s;
        } else {
          dc[(size_t)(q - 6) * cap + base + j] = s;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int gsl_pregathered_fwd(const int* counts, const float* geom, const float* rgbd,
                        int num_tiles, int cap, int grid_x, int chunk,
                        float* accum, float* logt, float* resid,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = fwd_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      pregathered_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pregathered_fwd_kernel<<<num_tiles, kPix, smem, (cudaStream_t)cuda_stream>>>(
      counts, geom, rgbd, cap, grid_x, chunk, accum, logt, resid);
  return (int)cudaGetLastError();
}

int gsl_pregathered_bwd(const int* counts, const float* geom, const float* rgbd,
                        int num_tiles, int cap, int grid_x, int chunk,
                        const float* gacc, const float* glogt,
                        const float* resid, float* dgeom, float* drgbd,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = bwd_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      pregathered_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pregathered_bwd_kernel<<<num_tiles, kPix, smem, (cudaStream_t)cuda_stream>>>(
      counts, geom, rgbd, cap, grid_x, chunk, gacc, glogt, resid, dgeom, drgbd);
  return (int)cudaGetLastError();
}

}  // extern "C"
