// Stream blend forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gs_localization_tpu/raster/stream_blend.py:
//   K1  _fwd_kernel  (front-to-back alpha blend of each 16x16 tile over its
//                     chunk-aligned window of the transposed pair stream)
//   K2  _bwd_kernel  (reverse walk; per-pair gradients summed over the
//                     tile's 256 pixels, written at the pair's own position)
//
// The blend contract and the per-chunk walks are in blend_common.cuh,
// shared with the pregathered kernels (pallas_blend.cu).
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
//
// Ordering: CTAs run in any order. Each CTA writes only whole chunks inside
// its own aligned window (windows are disjoint because align == chunk), and
// the caller zero-fills dstream and masks positions >= kept_al, so nothing
// depends on the TPU's sequential grid order.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gsl;

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

__global__ void __launch_bounds__(kPix)
stream_fwd_kernel(const int* __restrict__ tstart, const int* __restrict__ wcount,
                  const float* __restrict__ stream, int mrpad, int grid_x,
                  int chunk, float* __restrict__ accum,
                  float* __restrict__ logt, float* __restrict__ resid) {
  extern __shared__ float stage[];   // kRows * chunk
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, &px, &py);
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
  float px, py;
  pixel_of(t, grid_x, &px, &py);
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
    blend_chunk_bwd(stage, part, chunk, lanes, px, py, gc, gl, log_after,
                    suffix);
    __syncthreads();
    for (int j = i; j < lanes; j += kPix) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) {
        const int row = q < 6 ? q : q + 2;
        dstream[(size_t)row * mrpad + base + j] = sum_partials(part, chunk, q, j);
      }
    }
  }
}

}  // namespace

extern "C" {

int gsl_stream_fwd(const int* tstart, const int* wcount, const float* stream,
                   int num_tiles, int mrpad, int grid_x, int chunk,
                   float* accum, float* logt, float* resid, void* cuda_stream) {
  if (num_tiles == 0) return 0;
  stream_fwd_kernel<<<num_tiles, kPix, fwd_smem(chunk), (cudaStream_t)cuda_stream>>>(
      tstart, wcount, stream, mrpad, grid_x, chunk, accum, logt, resid);
  return (int)cudaGetLastError();
}

int gsl_stream_bwd(const int* tstart, const int* wcount, const float* stream,
                   int num_tiles, int mrpad, int grid_x, int chunk,
                   const float* gacc, const float* glogt, const float* resid,
                   float* dstream, void* cuda_stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = bwd_smem(chunk);
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
