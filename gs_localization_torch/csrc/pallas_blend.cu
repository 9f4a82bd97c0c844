// Pregathered blend forward (K3) and backward (K4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gs_localization_tpu/raster/pallas_blend.py:
//   K3  _fwd_kernel (:82)  front-to-back alpha blend of each 16x16 tile over
//                          its own pregathered window: geom (8, cap) rows
//                          x y a b c opa valid pad and rgbd (4, cap) rows
//                          r g b depth
//   K4  _bwd_kernel (:145) reverse walk from k_stop - 1 to 0 with log T
//                          rebuilt from the forward's residuals; per-pair
//                          gradients summed over the tile's 256 pixels,
//                          written into the tile's own (8, cap) and (4, cap)
//                          gradient blocks
//
// The blend contract and the walks are in blend_common.cuh: K3/K4 run the
// same forward and backward bodies as the stream kernels (stream_blend.cu),
// on a window that was gathered per tile beforehand.
//
// What bounds them on the H100: instruction issue, not memory. Each walked
// pair slot is read once per tile and reused by 256 pixels, and the
// per-(pixel, pair) gate and blend math (fp32, exp/log) is the least work.
// The first design spent issue slots around that math: ten 5-shuffle sum
// trees per pair in K4 (50 shuffles, one warp instruction per clock per
// SM), 11 (K3) or 14 (K4) scalar shared-memory loads per pair, and the
// accurate expf and IEEE division where no threshold reads the value; its
// 94 KB of K4 partials per CTA held K4 to 2 CTAs per SM. What each design
// point does about it:
//
// - Pieces. A tile's pairs are staged in pieces of at most kSub = 64 lanes
//   of one contract chunk, so shared memory no longer scales with the chunk
//   (K3 8 KB, K4 28 KB per CTA, static) and registers set the CTAs per SM
//   (__launch_bounds__ kPieceMinBlocks: 4, 32 warps). The contract chunk
//   stays what it was: K3's block vote (__syncthreads_or of log T >= eps)
//   is taken at the end of each contract chunk, never of a piece, so
//   k_stop and resid are unchanged; K4 walks from the tile's last applied
//   lane down to 0, piece by piece, in the same pair order.
// - Pair-major staging. A staged pair is 16 floats (12 values, padded), so
//   the walks read it with three broadcast float4 loads instead of 11 (K3)
//   or 14 (K4) scalar loads.
// - Asynchronous double buffering. The next piece in walk order is copied
//   with cp.async while the current one is walked, transposed to pair-major
//   in the copy itself (stage_piece), so there is no landing buffer, no
//   transpose pass and no extra barrier (a TMA bulk copy moves rows
//   contiguously and would need both). On the H100 at the training and
//   bench windows, waiting for each copy at once measured no slower: a
//   piece's copy is a few percent of its walk, and the SM's other CTAs
//   cover it.
// - K4's per-pair fold. reduce10 sums a pair's ten gradient values over the
//   warp by recursive halving, 12 shuffles instead of 50, and each sum ends
//   on a known lane, which writes it to the warp's partials; the cross-warp
//   sum is a fixed-order loop over the 8 warps. Deterministic, no atomics.
//   Warps in which no pixel passes a pair's gate skip the fold.
// - Deepest tiles first. Block b takes tile order[b], order being the
//   tiles by count, descending, ties in tile order (a stable descending
//   argsort of the clamped counts, computed on the card by tile_order_kernel
//   launched just before K3/K4, so the wrapper adds no sort of its own), so
//   the deepest tiles start first and do not set the tail; K4 runs in K3's
//   order. Outputs stay
//   indexed by tile, so the result does not depend on the order.
// - Fast exp and division off the thresholds. The gate and log T stay
//   accurate (threshold tests read them); the weight exp(log T) of an
//   applied pair and K4's division by 1 - alpha use __expf / __fdividef
//   (blend_common.cuh says why that is safe).
// - K3 records each pixel's last applied lane (`last`) and its log T at
//   the start of every chunk it walks (`chunk_logt`, (T, cap / chunk, 256)
//   floats). K4 takes the gated pairs before `last` as the applied ones and
//   rebuilds their log T by subtraction within each chunk only, from K3's
//   record at the next chunk's start (or K3's log_t in the chunk of the last
//   applied pair): it is the adjoint of exactly the blend K3 computed, at
//   the log T K3 computed at every chunk's end (and it keeps each pixel's
//   running sum over later pairs in double, blend_piece_bwd says why), and
//   each warp stops its walk at its pixels' largest `last` (blend_piece_bwd
//   says how). This departs from the TPU kernel on purpose: that one
//   rebuilds log T from log_full through every walked pair and compares it
//   with log(1e-4), which after a long walk past saturation can disagree
//   with its own forward.
// - K4 writes each output element once: the sums of its walked lanes, and
//   zeros at or past the walked end (lanes past the count must be exactly
//   0, since the caller's gather adjoint adds them into real Gaussians) and
//   in the valid and pad rows.
//
// Tensor cores are not used: the per-pair sums over pixels need fp32 (TF32
// keeps about three digits, and the port keeps reduced-precision products
// out), and a lane holds one pixel's values for one pair, not an mma operand
// fragment. Windows of different tiles are disjoint, so CTAs may run in any
// order.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace gsl;

constexpr int kRgbdRows = 4;

// The tile's count clamped to [0, cap], as a corrupt table must never
// index past the window.
struct TileCount {
  const int* counts;
  int cap;
  __device__ __forceinline__ int operator()(int t) const {
    return min(max(counts[t], 0), cap);
  }
};

// Tile t's window: its own (8, cap) and (4, cap) blocks; its log T records
// are chunk_logt[(t * chunks + k) * kPix], chunks = cap / chunk.
__device__ __forceinline__ PairWindow tile_pairs(const float* geom,
                                                 const float* rgbd, int t,
                                                 int cap) {
  return {geom + (size_t)t * kGeomRows * cap,
          rgbd + (size_t)t * kRgbdRows * cap, (size_t)cap};
}

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
pregathered_fwd_kernel(const int* __restrict__ counts,
                       const int* __restrict__ order, int num_tiles,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, int tile0, float* __restrict__ accum,
                       float* __restrict__ logt, float* __restrict__ resid,
                       int* __restrict__ last,
                       float* __restrict__ chunk_logt) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  const int t = tile_of(order, num_tiles);
  const size_t chunks = (size_t)((cap + chunk - 1) / chunk);
  blend_tile_fwd(stage, tile_pairs(geom, rgbd, t, cap),
                 TileCount{counts, cap}(t), chunk, t, tile0, grid_x, accum,
                 logt, resid, last, chunk_logt + (size_t)t * chunks * kPix);
}

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
pregathered_bwd_kernel(const int* __restrict__ counts,
                       const int* __restrict__ order, int num_tiles,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, int tile0, const float* __restrict__ gacc,
                       const float* __restrict__ glogt,
                       const float* __restrict__ logt,
                       const int* __restrict__ last,
                       const float* __restrict__ chunk_logt,
                       float* __restrict__ dgeom, float* __restrict__ drgbd) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  __shared__ float part[kWarps * kSub * kGrad];
  const int t = tile_of(order, num_tiles);
  const int i = threadIdx.x;
  float* dg = dgeom + (size_t)t * kGeomRows * cap;
  float* dc = drgbd + (size_t)t * kRgbdRows * cap;
  // Zeros where no walked lane is: lanes >= end, and the valid and pad rows.
  auto fill = [=](int end) {
    for (int j = i; j < cap; j += kPix) {
      dg[6 * (size_t)cap + j] = 0.0f;
      dg[7 * (size_t)cap + j] = 0.0f;
    }
    for (int r = 0; r < kGrad; ++r) {
      float* row = r < 6 ? dg + (size_t)r * cap : dc + (size_t)(r - 6) * cap;
      for (int j = end + i; j < cap; j += kPix) row[j] = 0.0f;
    }
  };
  const size_t chunks = (size_t)((cap + chunk - 1) / chunk);
  blend_tile_bwd(stage, part, tile_pairs(geom, rgbd, t, cap),
                 GradWindow{dg, dc, (size_t)cap}, TileCount{counts, cap}(t),
                 chunk, t, tile0, grid_x, gacc, glogt, logt, last,
                 chunk_logt + (size_t)t * chunks * kPix, fill);
}

}  // namespace

extern "C" {

// `order` (num_tiles ints) receives the tile order the kernel ran in,
// `last` (num_tiles x 256 ints) each pixel's last applied lane + 1 and
// `chunk_logt` (num_tiles x cap / chunk x 256 floats) each pixel's log T at
// the start of every chunk it walked (entries of chunks it did not walk are
// left as they were): all three are inputs of the backward. Window t holds
// the pairs of image tile tile0 + t.
int gsl_pregathered_fwd(const int* counts, int* order, const float* geom,
                        const float* rgbd, int num_tiles, int cap, int grid_x,
                        int chunk, int tile0, float* accum, float* logt,
                        float* resid, int* last, float* chunk_logt,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || cap < chunk) return (int)cudaErrorInvalidValue;
  const int err = launch_tile_order(TileCount{counts, cap}, num_tiles, order,
                                    (cudaStream_t)cuda_stream);
  if (err != 0) return err;
  pregathered_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      counts, order, num_tiles, geom, rgbd, cap, grid_x, chunk, tile0, accum,
      logt, resid, last, chunk_logt);
  return (int)cudaGetLastError();
}

// `order`, `logt`, `last` and `chunk_logt` are the forward's.
int gsl_pregathered_bwd(const int* counts, const int* order,
                        const float* geom, const float* rgbd, int num_tiles,
                        int cap, int grid_x, int chunk, int tile0,
                        const float* gacc, const float* glogt,
                        const float* logt, const int* last,
                        const float* chunk_logt, float* dgeom, float* drgbd,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || cap < chunk) return (int)cudaErrorInvalidValue;
  pregathered_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      counts, order, num_tiles, geom, rgbd, cap, grid_x, chunk, tile0, gacc,
      glogt, logt, last, chunk_logt, dgeom, drgbd);
  return (int)cudaGetLastError();
}

// CTAs per SM, registers per thread, shared memory per CTA and local bytes
// per thread of K3 (which = 0) or K4 (1), into out[0..3].
int gsl_pregathered_info(int which, int* out) {
  if (which == 0) return kernel_info(pregathered_fwd_kernel, out);
  if (which == 1) return kernel_info(pregathered_bwd_kernel, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
