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
// The blend contract is in blend_common.cuh, shared with the stream kernels
// (stream_blend.cu), so K3/K4 compute what K1/K2 compute on a window that
// was gathered per tile beforehand.
//
// What bounds them on the H100: instruction issue, not memory. Each walked
// pair slot is read once per tile and reused by 256 pixels, and the
// per-(pixel, pair) gate and blend math (fp32, exp/log) is the least work.
// The first design spent issue slots around that math: ten 5-step warp_sum
// trees per pair in K4 (50 shuffles, one warp instruction per clock per
// SM), 11 (K3) or 14 (K4) scalar shared-memory loads per pair, and the
// accurate expf and IEEE division where no threshold reads the value; its
// 94 KB of K4 partials per CTA held K4 to 2 CTAs per SM. What each design
// point does about it:
//
// - Pieces. A tile's pairs are staged in pieces of at most kSub = 64 lanes
//   of one contract chunk, so shared memory no longer scales with the chunk
//   (K3 8 KB, K4 28 KB per CTA) and registers set the CTAs per SM
//   (__launch_bounds__ kPieceMinBlocks: 4, 32 warps). The contract chunk
//   stays what it was: K3's block vote (__syncthreads_or of log T >= eps)
//   is taken at the end of each contract chunk, never of a piece, so
//   k_stop and resid are unchanged; K4 walks [0, min(count, k_stop *
//   chunk)) from the last lane down, piece by piece, with the same pair
//   order and the same log T subtraction.
// - Pair-major staging. A staged pair is 16 floats (12 values, padded), so
//   the walks read it with three broadcast float4 loads instead of 11 (K3)
//   or 14 (K4) scalar loads.
// - Asynchronous double buffering. The next piece in walk order is copied
//   with cp.async while the current one is walked. Each thread copies 4-byte
//   elements, 8 pairs x 4 rows per warp: every 8 lanes read one 32-byte
//   sector of a row, and the transpose to pair-major happens in the copy
//   itself, so there is no landing buffer, no transpose pass and no extra
//   barrier (a TMA bulk copy moves rows contiguously and would need both).
//   K3 copies the first piece of the next chunk before the vote; when the
//   vote ends the walk, that copy is drained and dropped. On the H100 at
//   the training and bench windows, waiting for each copy at once measured
//   no slower: a piece's copy is a few percent of its walk, and the SM's
//   other CTAs cover it.
// - K4's per-pair fold. reduce10 sums a pair's ten gradient values over the
//   warp by recursive halving, 12 shuffles instead of 50, and each sum ends
//   on a known lane, which writes it to the warp's partials; the cross-warp
//   sum is a fixed-order loop over the 8 warps. Deterministic, no atomics.
//   Warps in which no pixel passes a pair's gate skip the fold.
// - Deepest tiles first. Block b takes tile order[b], order being the
//   tiles by count, descending, ties in tile order (a stable descending
//   argsort of the clamped counts, computed on the card by a helper kernel
//   launched just before K3/K4, so the wrapper adds no sort of its own), so
//   the deepest tiles start first and do not set the tail. Outputs stay
//   indexed by tile, so the result does not depend on the order.
// - Fast exp and division off the thresholds. The gate and log T stay
//   accurate (threshold tests read them); the weight exp(log T) of an
//   applied pair and K4's division by 1 - alpha use __expf / __fdividef
//   (blend_common.cuh says why that is safe).
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

constexpr int kGeomRows = 8;
constexpr int kRgbdRows = 4;

// The tile's count clamped to [0, cap], as a corrupt table must never
// index past the window.
__device__ __forceinline__ int tile_count(const int* counts, int t, int cap) {
  return min(max(counts[t], 0), cap);
}

constexpr int kOrderThreads = 256;   // 8 warps, one tile each

// order[rank(t)] = t, where rank(t) counts the tiles with a larger clamped
// count, and those with the same count and a smaller index: the stable
// descending argsort of the counts. One warp per tile, its lanes striding
// over the other tiles; integer sums only, so the order is the same on
// every run.
__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(const int* __restrict__ counts, int num_tiles, int cap,
                  int* __restrict__ order) {
  const int t = blockIdx.x * (kOrderThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;          // the whole warp: t is per warp
  const int c = tile_count(counts, t, cap);
  int rank = 0;
  for (int u = lane; u < num_tiles; u += 32) {
    const int cu = tile_count(counts, u, cap);
    rank += (cu > c) || (cu == c && u < t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
  if (lane == 0) order[rank] = t;
}

// Fills order (num_tiles ints) on the stream; returns a cudaError_t.
int launch_tile_order(const int* counts, int num_tiles, int cap, int* order,
                      cudaStream_t stream) {
  constexpr int kTilesPerBlock = kOrderThreads / 32;
  tile_order_kernel<<<(num_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                      kOrderThreads, 0, stream>>>(counts, num_tiles, cap,
                                                  order);
  return (int)cudaGetLastError();
}

// The tile this block walks: order[blockIdx.x], clamped.
__device__ __forceinline__ int tile_of(const int* order, int num_tiles) {
  return min(max(order[blockIdx.x], 0), num_tiles - 1);
}

// Copies lanes [q.start, q.start + q.n) of tile t's window into stage,
// pair-major, with cp.async; commits one group.
__device__ __forceinline__ void stage_piece(float* stage,
                                            const float* __restrict__ geom,
                                            const float* __restrict__ rgbd,
                                            int t, int cap, Piece q) {
  const float* g = geom + (size_t)t * kGeomRows * cap + q.start;
  const float* c = rgbd + (size_t)t * kRgbdRows * cap + q.start;
  const int units = 3 * ((q.n + 7) >> 3);   // 32 elements: 8 pairs x 4 rows
  for (int idx = threadIdx.x; idx < units * 32; idx += kPix) {
    const int u = idx >> 5;
    const int l = idx & 31;
    const int r = 4 * (u % 3) + (l >> 3);
    const int j = 8 * (u / 3) + (l & 7);
    if (j < q.n) {
      cp_async_f32(stage + j * kPairStride + r,
                   r < kGeomRows ? g + (size_t)r * cap + j
                                 : c + (size_t)(r - kGeomRows) * cap + j);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
pregathered_fwd_kernel(const int* __restrict__ counts,
                       const int* __restrict__ order, int num_tiles,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, float* __restrict__ accum,
                       float* __restrict__ logt, float* __restrict__ resid) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  const int t = tile_of(order, num_tiles);
  const int i = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, &px, &py);
  const int count = tile_count(counts, t, cap);
  const int sw = min(kSub, chunk);
  const int nsub = (chunk + sw - 1) / sw;
  const int n_pieces = pieces_of(count, chunk, sw, nsub);

  float log_full = 0.0f;   // every alpha: the saturation test and resid
  float log_app = 0.0f;    // applied alphas only: the output transmittance
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;               // contract chunks visited
  if (n_pieces > 0) {
    stage_piece(stage[0], geom, rgbd, t, cap, piece_of(0, chunk, sw, nsub, count));
  }
  for (int p = 0; p < n_pieces; ++p) {
    cp_async_wait_all();
    __syncthreads();       // piece p landed; buffer (p + 1) & 1 walked
    if (p + 1 < n_pieces) {
      stage_piece(stage[(p + 1) & 1], geom, rgbd, t, cap,
                  piece_of(p + 1, chunk, sw, nsub, count));
    }
    blend_piece_fwd(stage[p & 1], piece_of(p, chunk, sw, nsub, count).n, px,
                    py, log_full, log_app, acc);
    if ((p + 1) % nsub == 0 || p + 1 == n_pieces) {   // end of a contract chunk
      ++k;
      if (!__syncthreads_or(log_full >= kLogTEps)) break;
    }
  }
  cp_async_wait_all();     // the next chunk's first piece, after an early exit
  const size_t tp = (size_t)t * kPix + i;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) accum[((size_t)t * 4 + ch) * kPix + i] = acc[ch];
  logt[tp] = log_app;
  resid[2 * tp + 0] = log_full;
  resid[2 * tp + 1] = (float)k;
}

__global__ void __launch_bounds__(kPix, kPieceMinBlocks)
pregathered_bwd_kernel(const int* __restrict__ counts,
                       const int* __restrict__ order, int num_tiles,
                       const float* __restrict__ geom,
                       const float* __restrict__ rgbd, int cap, int grid_x,
                       int chunk, const float* __restrict__ gacc,
                       const float* __restrict__ glogt,
                       const float* __restrict__ resid,
                       float* __restrict__ dgeom, float* __restrict__ drgbd) {
  __shared__ __align__(16) float stage[kStages][kStageFloats];
  __shared__ float part[kWarps * kSub * kGrad];
  const int t = tile_of(order, num_tiles);
  const int i = threadIdx.x;
  float px, py;
  pixel_of(t, grid_x, &px, &py);
  const int count = tile_count(counts, t, cap);
  const int n_chunks = (count + chunk - 1) / chunk;
  const size_t tp = (size_t)t * kPix + i;
  const int k_stop = min(max((int)resid[2 * (size_t)t * kPix + 1], 0), n_chunks);
  const int end = min(count, k_stop * chunk);   // lanes the forward walked
  const int sw = min(kSub, chunk);
  const int nsub = (chunk + sw - 1) / sw;
  const int n_pieces = pieces_of(end, chunk, sw, nsub);
  if (n_pieces > 0) {
    stage_piece(stage[(n_pieces - 1) & 1], geom, rgbd, t, cap,
                piece_of(n_pieces - 1, chunk, sw, nsub, end));
  }

  // Zeros where no walked lane is: lanes >= end, and the valid and pad rows.
  float* dg = dgeom + (size_t)t * kGeomRows * cap;
  float* dc = drgbd + (size_t)t * kRgbdRows * cap;
  for (int j = i; j < cap; j += kPix) {
    dg[6 * (size_t)cap + j] = 0.0f;
    dg[7 * (size_t)cap + j] = 0.0f;
  }
  for (int r = 0; r < kGrad; ++r) {
    float* row = r < 6 ? dg + (size_t)r * cap : dc + (size_t)(r - 6) * cap;
    for (int j = end + i; j < cap; j += kPix) row[j] = 0.0f;
  }

  float log_after = resid[2 * tp];            // inclusive log T after the pair
  float gc[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) gc[ch] = gacc[((size_t)t * 4 + ch) * kPix + i];
  const float gl = glogt[tp];
  float suffix = 0.0f;                        // sum over later pairs of wbar * w
  const int slot = reduce10_slot(i & 31);

  for (int p = n_pieces - 1; p >= 0; --p) {
    const Piece q = piece_of(p, chunk, sw, nsub, end);
    cp_async_wait_all();
    __syncthreads();   // piece p landed; buffer (p - 1) & 1 and part free
    if (p > 0) {
      stage_piece(stage[(p - 1) & 1], geom, rgbd, t, cap,
                  piece_of(p - 1, chunk, sw, nsub, end));
    }
    blend_piece_bwd(stage[p & 1], part, q.n, px, py, gc, gl, slot, log_after,
                    suffix);
    __syncthreads();
    for (int idx = i; idx < kGrad * q.n; idx += kPix) {
      const int r = idx / q.n;
      const int j = idx - r * q.n;
      const float s = sum_piece_partials(part, j, r);
      if (r < 6) {
        dg[(size_t)r * cap + q.start + j] = s;
      } else {
        dc[(size_t)(r - 6) * cap + q.start + j] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

// `order` is scratch of num_tiles ints: it receives the tile order the
// kernel ran in.
int gsl_pregathered_fwd(const int* counts, int* order, const float* geom,
                        const float* rgbd, int num_tiles, int cap, int grid_x,
                        int chunk, float* accum, float* logt, float* resid,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || cap < chunk) return (int)cudaErrorInvalidValue;
  const int err = launch_tile_order(counts, num_tiles, cap, order,
                                    (cudaStream_t)cuda_stream);
  if (err != 0) return err;
  pregathered_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      counts, order, num_tiles, geom, rgbd, cap, grid_x, chunk, accum, logt,
      resid);
  return (int)cudaGetLastError();
}

int gsl_pregathered_bwd(const int* counts, int* order, const float* geom,
                        const float* rgbd, int num_tiles, int cap, int grid_x,
                        int chunk, const float* gacc, const float* glogt,
                        const float* resid, float* dgeom, float* drgbd,
                        void* cuda_stream) {
  if (num_tiles == 0) return 0;
  if (chunk < 1 || cap < chunk) return (int)cudaErrorInvalidValue;
  const int err = launch_tile_order(counts, num_tiles, cap, order,
                                    (cudaStream_t)cuda_stream);
  if (err != 0) return err;
  pregathered_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)cuda_stream>>>(
      counts, order, num_tiles, geom, rgbd, cap, grid_x, chunk, gacc, glogt,
      resid, dgeom, drgbd);
  return (int)cudaGetLastError();
}

// CTAs per SM, registers per thread, shared memory per CTA and local bytes
// per thread of K1-K4 (which = 0..3) at `chunk`, into out[0..3].
int gsl_kernel_info(int which, int chunk, int* out) {
  switch (which) {
    case 0:
    case 1:
      return stream_kernel_info(which, chunk, out);
    case 2:
      return kernel_info(pregathered_fwd_kernel, 0, out);
    case 3:
      return kernel_info(pregathered_bwd_kernel, 0, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
