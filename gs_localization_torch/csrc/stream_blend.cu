// Stream blend forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gs_localization_tpu/raster/stream_blend.py:
//   K1  _fwd_kernel (:85)   front-to-back alpha blend of each 16x16 tile over
//                           its chunk-aligned window [tstart, tstart +
//                           walk_count) of the transposed pair stream
//                           (16, mrpad); early exit once T < 1e-4 everywhere
//   K2  _bwd_kernel (:161)  reverse walk; per-pair gradients summed over the
//                           tile's 256 pixels, written at the pair's own
//                           stream position
//
// What bounds them on the H100: instruction issue, not memory. Each walked
// pair slot is read once per tile and reused by 256 pixels, and the
// per-(pixel, pair) gate and blend math (fp32, exp/log) is the least work,
// so the design spends as few issue slots as it can around that math.
//
// What the design does about it: K1/K2 run the pregathered kernels' bodies
// (blend_tile_fwd / blend_tile_bwd in blend_common.cuh; pallas_blend.cu
// gives each design point's reason). A stream window is 12 contiguous row
// runs of one array, so the pieces are copied from it as from a gathered
// window, only with the stream's row stride:
// - pair-major pieces of at most 64 lanes, double-buffered with cp.async
//   and read with three broadcast float4 loads per pair (not one scalar
//   shared-memory load per value); the block vote stays at the end of each
//   contract chunk, so k_stop and resid follow the contract;
// - K2 folds a pair's ten gradients with reduce10, 12 shuffles, not ten
//   5-shuffle trees;
// - K1 records each pixel's last applied lane and its log T at the start
//   of every chunk it walks (`chunk_logt`, one row of 256 floats per chunk
//   of the stream, (MR_AL + chunk) / chunk rows, indexed by the chunk's
//   position in the stream), and K2 walks only up to that lane, rebuilding
//   log T by subtraction within each chunk only, from K1's record at the
//   next chunk's start (or K1's log_t in the chunk of the last applied
//   pair; its running sum over later pairs in double), so K2 is the
//   adjoint of exactly the blend K1 computed, at the log T K1 computed at
//   every chunk's end, and skips the pairs walked
//   after saturation (a deliberate departure from the TPU kernel, which
//   rebuilds log T from log_full through every walked pair and compares it
//   with log(1e-4));
// - __expf / __fdividef only where no threshold reads the value;
// - static shared memory, K1 8 KB and K2 28 KB per CTA (not chunk-sized
//   partials), so registers set the CTAs per SM (__launch_bounds__
//   kPieceMinBlocks);
// - deepest tiles first: tile_order_kernel ranks the tiles by their clamped
//   walk counts just before K1, and K2 runs in K1's order; outputs stay
//   indexed by tile.
//
// Ordering: CTAs run in any order. K2 writes only its walked lanes, inside
// the tile's own aligned window (windows are disjoint because align ==
// chunk); the caller zero-fills dstream and masks positions >= kept_al, so
// nothing depends on the TPU's sequential grid order.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gsl;

struct Window {
  int start;
  int count;
};

// Clamp so a corrupt bin table can never index out of bounds (as the TPU
// kernel's DMA clamp).
__device__ __forceinline__ Window tile_window(const int* tstart,
                                              const int* wcount, int t,
                                              int mrpad, int chunk) {
  Window w;
  w.start = min(max(tstart[t], 0), mrpad - chunk);
  w.count = min(max(wcount[t], 0), mrpad - chunk - w.start);
  return w;
}

// A tile's clamped walk count: the key of its place in the tile order.
struct WalkCount {
  const int* tstart;
  const int* wcount;
  int mrpad, chunk;
  __device__ __forceinline__ int operator()(int t) const {
    return tile_window(tstart, wcount, t, mrpad, chunk).count;
  }
};

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
stream_fwd_kernel(const int* __restrict__ tstart, const int* __restrict__ wcount,
                  const int* __restrict__ order, int num_tiles,
                  const float* __restrict__ stream, int mrpad, int grid_x,
                  int chunk, float* __restrict__ accum,
                  float* __restrict__ logt, float* __restrict__ resid,
                  int* __restrict__ last, float* __restrict__ chunk_logt) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  const int t = tile_of(order, num_tiles);
  const Window w = tile_window(tstart, wcount, t, mrpad, chunk);
  const PairWindow win{stream + w.start,
                       stream + (size_t)kGeomRows * mrpad + w.start,
                       (size_t)mrpad};
  blend_tile_fwd(stage, win, w.count, chunk, t, 0, grid_x, accum, logt,
                 resid, last, chunk_logt + (size_t)(w.start / chunk) * kPix);
}

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
stream_bwd_kernel(const int* __restrict__ tstart, const int* __restrict__ wcount,
                  const int* __restrict__ order, int num_tiles,
                  const float* __restrict__ stream, int mrpad, int grid_x,
                  int chunk, const float* __restrict__ gacc,
                  const float* __restrict__ glogt,
                  const float* __restrict__ logt,
                  const int* __restrict__ last,
                  const float* __restrict__ chunk_logt,
                  float* __restrict__ dstream) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  __shared__ float part[kWarps * kSub * kGrad];
  const int t = tile_of(order, num_tiles);
  const Window w = tile_window(tstart, wcount, t, mrpad, chunk);
  const size_t rgbd = (size_t)kGeomRows * mrpad + w.start;
  blend_tile_bwd(stage, part,
                 PairWindow{stream + w.start, stream + rgbd, (size_t)mrpad},
                 GradWindow{dstream + w.start, dstream + rgbd, (size_t)mrpad},
                 w.count, chunk, t, 0, grid_x, gacc, glogt, logt, last,
                 chunk_logt + (size_t)(w.start / chunk) * kPix,
                 [](int) {});   // the caller's zeros cover what is not walked
}

}  // namespace

extern "C" {

// `order` (num_tiles ints) receives the tile order the kernel ran in,
// `last` (num_tiles x 256 ints) each pixel's last applied lane + 1 and
// `chunk_logt` (mrpad / chunk x 256 floats) each pixel's log T at the start
// of every chunk its tile walked, at the chunk's position in the stream
// (entries of chunks no tile walked are left as they were): all three are
// inputs of the backward.
int gsl_stream_fwd(const int* tstart, const int* wcount, int* order,
                   const float* stream, int num_tiles, int mrpad, int grid_x,
                   int chunk, float* accum, float* logt, float* resid,
                   int* last, float* chunk_logt, void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || mrpad < chunk) return (int)cudaErrorInvalidValue;
  const int err = launch_tile_order(WalkCount{tstart, wcount, mrpad, chunk},
                                    num_tiles, order,
                                    (cudaStream_t)cuda_stream);
  if (err != 0) return err;
  stream_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      tstart, wcount, order, num_tiles, stream, mrpad, grid_x, chunk, accum,
      logt, resid, last, chunk_logt);
  return (int)cudaGetLastError();
}

// `order`, `logt`, `last` and `chunk_logt` are the forward's.
int gsl_stream_bwd(const int* tstart, const int* wcount, const int* order,
                   const float* stream, int num_tiles, int mrpad, int grid_x,
                   int chunk, const float* gacc, const float* glogt,
                   const float* logt, const int* last,
                   const float* chunk_logt, float* dstream,
                   void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || mrpad < chunk) return (int)cudaErrorInvalidValue;
  stream_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      tstart, wcount, order, num_tiles, stream, mrpad, grid_x, chunk, gacc,
      glogt, logt, last, chunk_logt, dstream);
  return (int)cudaGetLastError();
}

// CTAs per SM, registers per thread, shared memory per CTA and local bytes
// per thread of K1 (which = 0) or K2 (1), into out[0..3].
int gsl_stream_info(int which, int* out) {
  if (which == 0) return kernel_info(stream_fwd_kernel, out);
  if (which == 1) return kernel_info(stream_bwd_kernel, out);
  return (int)cudaErrorInvalidValue;
}

const char* gsl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
