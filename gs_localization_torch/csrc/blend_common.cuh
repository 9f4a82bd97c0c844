// Device code shared by the tile-blend kernels: the stream blend
// (stream_blend.cu, K1/K2) and the pregathered blend (pallas_blend.cu,
// K3/K4). Each 16x16 tile walks one window of pairs, 12 rows x y a b c opa
// valid pad r g b depth. The two layouts differ only in where that window
// lies: a chunk-aligned slice of the one transposed pair stream (K1/K2) or
// the tile's own gathered block (K3/K4). A PairWindow says where, and one
// forward body (blend_tile_fwd) and one backward body (blend_tile_bwd)
// serve both layouts.
//
// Contract (shared with the plain PyTorch versions in raster/stream_blend.py
// and raster/pallas_blend.py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = x - px (integer pixel px)
//   gated out when power > 0, opa exp(power) < 1/255, valid <= 0.5 or the
//   lane is past the tile's count; alpha = min(0.99, opa exp(power));
//   la = log(1 - alpha); a pair is applied while the INCLUSIVE log T >=
//   log(1e-4); w = alpha * T_before. A tile stops after the first contract
//   chunk at whose end every pixel has log T < log(1e-4); k_stop counts the
//   chunks it visited.
// The forward also records, per pixel, one past the lane of the last pair
// it applied (`last`) and its log T at the start of every chunk it walks
// (`chunk_logt`); the backward is the adjoint of exactly those pairs, and
// starts each chunk's reverse walk from the forward's own log T.
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
constexpr int kGeomRows = 8;          // x y a b c opa valid pad
constexpr int kGrad = 10;             // gradient rows: 0-5 geometry, 6-9 r g b depth
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLogTEps = -9.210340371976182f;   // log(1e-4)

struct Gate {
  float dx, dy, expp, araw;
  bool in;
};

// Pixel coordinates of this thread's pixel in tile t of the image (the
// callers pass tile0 + t: a launch may cover a run of tiles that starts at
// tile0).
__device__ __forceinline__ void pixel_of(int t, int grid_x, float* px, float* py) {
  const int i = threadIdx.x;
  *px = (float)((t % grid_x) * kTile + i % kTile);
  *py = (float)((t / grid_x) * kTile + i / kTile);
}

// ---------------------------------------------------------------------------
// Piece walks: pair-major staging in sub-chunks ("pieces").
//
// A piece is at most kSub lanes of one contract chunk, staged pair-major:
// pair j's 12 values at stage[j * kPairStride], padded to 16 floats, so a
// warp reads a pair with three broadcast float4 loads (x y a b | c opa valid
// pad | r g b depth). kStages buffers: the next piece in walk order is
// copied (cp.async) while the current one is walked. The order of pairs and
// every value a threshold reads (the gate, log T and its subtraction) are
// computed in the plain version's order. Where no threshold reads the value
// -- the transmittance T = exp(log T) that weights an applied pair (log T >=
// log(1e-4) there, so the argument lies in [-9.22, 0]) and the backward's
// division by 1 - alpha >= 0.01 -- the walks use the hardware
// approximations __expf and __fdividef (a few ulp), which take a fraction
// of the instructions of the accurate expf and IEEE division.
// ---------------------------------------------------------------------------

constexpr int kSub = 64;           // lanes per staged piece
constexpr int kPairStride = 16;    // floats per staged pair
constexpr int kStages = 2;         // staging buffers
constexpr int kStageFloats = kSub * kPairStride;
// Occupancy target of the blend kernels (__launch_bounds__ minimum CTAs per
// SM): registers, not shared memory, bound their CTAs per SM. Tighter
// register caps (6 CTAs per SM) measured slower on the H100.
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

// Where a tile's window lies: lane j of row r is geom[r * stride + j] for
// rows 0-7 (x y a b c opa valid pad) and rgbd[(r - 8) * stride + j] for rows
// 8-11 (r g b depth). GradWindow is the same for the backward's output
// (rows 0-5 and 8-11 written).
struct PairWindow {
  const float* geom;
  const float* rgbd;
  size_t stride;
};
struct GradWindow {
  float* geom;
  float* rgbd;
  size_t stride;
};

// Copies lanes [q.start, q.start + q.n) of a window into stage, pair-major,
// with cp.async; commits one group. Each warp copies 8 pairs x 4 rows: every
// 8 lanes read one 32-byte sector of a row, and the transpose to pair-major
// happens in the copy itself (no landing buffer, no transpose pass).
__device__ __forceinline__ void stage_piece(float* stage, PairWindow w,
                                            Piece q) {
  const float* g = w.geom + q.start;
  const float* c = w.rgbd + q.start;
  const int units = 3 * ((q.n + 7) >> 3);   // 32 elements: 8 pairs x 4 rows
  for (int idx = threadIdx.x; idx < units * 32; idx += kPix) {
    const int u = idx >> 5;
    const int l = idx & 31;
    const int r = 4 * (u % 3) + (l >> 3);
    const int j = 8 * (u / 3) + (l & 7);
    if (j < q.n) {
      cp_async_f32(stage + j * kPairStride + r,
                   r < kGeomRows ? g + (size_t)r * w.stride + j
                                 : c + (size_t)(r - kGeomRows) * w.stride + j);
    }
  }
  cp_async_commit();
}

// The gate of a staged pair, in the plain version's operation order
// (stream_blend._chunk_alpha).
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

// Forward walk of one staged piece (lanes [base, base + lanes) of the
// window), front to back, for this thread's pixel. `last` becomes one past
// the lane of the last pair applied so far.
__device__ __forceinline__ void blend_piece_fwd(const float* stage, int base,
                                                int lanes, float px, float py,
                                                float& log_full, float& log_app,
                                                int& last, float acc[4]) {
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
      last = base + j + 1;
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

// Reverse walk of one staged piece (lanes [base, base + lanes) of the
// window) for this thread's pixel: the analytic adjoint of blend_piece_fwd.
// Each pair's 10 gradient values are folded over the warp by reduce10 into
// part[warp][j][q] (kSub x kGrad floats per warp); warps in which no pixel
// applied a pair write zeros without reducing, and so do the lanes at or
// past `warp_last`, the largest `last` of the warp's pixels, without a
// gate. `slot` is reduce10_slot(lane).
//
// The pairs the forward applied are exactly the gated pairs of the lanes
// before `last` (blend_piece_fwd): log T only falls, so the forward applies
// a prefix of the gated pairs, and every other pair has zero gradient.
// `log_after`, the inclusive log T after the pair, is rebuilt by
// subtraction through the applied pairs only, from a value the forward
// computed bit for bit: at the end of each contract chunk blend_tile_bwd
// resets it (the forward's log T at the next chunk's start, or its log_t in
// the chunk of the last applied pair), so the subtractions never run past
// one chunk. `suffix` is the sum over later pairs of wbar * w, kept in
// double: it runs over every applied pair of the pixel (over a thousand at
// the training windows), where autograd's plain version sums it by chunks,
// and a float32 running sum lost digits against that (the float64
// yardstick of chip_smoke.py). Both carry to the previous piece. (The TPU
// kernel instead rebuilds log T from log_full through every pair the
// forward walked and compares it with log(1e-4), which after a long walk
// past saturation can drift from the forward's value.)
__device__ __forceinline__ void blend_piece_bwd(const float* stage, float* part,
                                                int base, int lanes, float px,
                                                float py, const float gc[4],
                                                float gl, int last,
                                                int warp_last, int slot,
                                                float& log_after,
                                                double& suffix) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* p = reinterpret_cast<const float4*>(stage);
  float* pw = part + (size_t)warp * kSub * kGrad;
  const int live = max(min(lanes, warp_last - base), 0);
  if (slot >= 0) {
    for (int j = live; j < lanes; ++j) pw[j * kGrad + slot] = 0.0f;
  }
  for (int j = live - 1; j >= 0; --j) {
    const float4 g0 = p[4 * j];
    const float4 g1 = p[4 * j + 1];
    const Gate g = gate_of_pair(g0, g1, px, py);
    const bool applied = g.in && base + j < last;
    float v[kGrad];
#pragma unroll
    for (int q = 0; q < kGrad; ++q) v[q] = 0.0f;
    if (applied) {
      const float4 c = p[4 * j + 2];
      const float a = g0.z, b = g0.w, cc = g1.x;
      const float alpha = fminf(kAlphaMax, g.araw);
      const float la = logf(1.0f - alpha);
      const float log_before = log_after - la;
      const float t_prev = __expf(log_before);
      const float w = alpha * t_prev;
      float wbar = 0.0f;
      wbar += gc[0] * c.x;
      wbar += gc[1] * c.y;
      wbar += gc[2] * c.z;
      wbar += gc[3] * c.w;
      const float abar =
          wbar * t_prev - __fdividef((float)(suffix + gl), 1.0f - alpha);
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
      suffix += (double)wbar * (double)w;
      log_after = log_before;
    }
    float s = 0.0f;
    if (__any_sync(0xffffffffu, applied)) s = reduce10(v, lane);
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

// ---------------------------------------------------------------------------
// The two bodies. Each is called by a CTA of kPix threads walking tile t,
// with `stage` kStages x kStageFloats floats of shared memory (16-byte
// aligned) and, for the backward, `part` kWarps x kSub x kGrad floats.
// ---------------------------------------------------------------------------

// Forward: lanes [0, count) of the window front to back, in pieces; the
// block vote (any pixel with log T >= eps) is taken at the end of each
// contract chunk, never of a piece. Writes tile t's accum (4, kPix), log_t
// (kPix) and resid (kPix, 2) = [log_full, k_stop], and for the backward
// `last` (kPix): one past the lane of each pixel's last applied pair, 0
// where it applied none, and `chunk_logt` (the tile's records: chunk k at
// chunk_logt[k * kPix]): each pixel's log T at the start of every chunk it
// walks. The pixels are those of image tile tile0 + t. The first piece of
// the next chunk is copied before the vote; when the vote ends the walk,
// that copy is drained and dropped.
__device__ __forceinline__ void blend_tile_fwd(float (*stage)[kStageFloats],
                                               PairWindow win, int count,
                                               int chunk, int t, int tile0,
                                               int grid_x,
                                               float* __restrict__ accum,
                                               float* __restrict__ logt,
                                               float* __restrict__ resid,
                                               int* __restrict__ last_out,
                                               float* __restrict__ chunk_logt) {
  const int i = threadIdx.x;
  float px, py;
  pixel_of(tile0 + t, grid_x, &px, &py);
  const int sw = min(kSub, chunk);
  const int nsub = (chunk + sw - 1) / sw;
  const int n_pieces = pieces_of(count, chunk, sw, nsub);

  float log_full = 0.0f;   // every alpha: the saturation test and resid
  float log_app = 0.0f;    // applied alphas only: the output transmittance
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int last = 0;            // one past the last applied lane
  int k = 0;               // contract chunks visited
  if (n_pieces > 0) stage_piece(stage[0], win, piece_of(0, chunk, sw, nsub, count));
  for (int p = 0; p < n_pieces; ++p) {
    cp_async_wait_all();
    __syncthreads();       // piece p landed; buffer (p + 1) & 1 walked
    if (p + 1 < n_pieces) {
      stage_piece(stage[(p + 1) & 1], win, piece_of(p + 1, chunk, sw, nsub, count));
    }
    const Piece q = piece_of(p, chunk, sw, nsub, count);
    if (p % nsub == 0) chunk_logt[(size_t)(p / nsub) * kPix + i] = log_full;
    blend_piece_fwd(stage[p & 1], q.start, q.n, px, py, log_full, log_app,
                    last, acc);
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
  last_out[tp] = last;
}

// Backward: lanes [0, end) from the last lane down, piece by piece, where
// end is the largest `last` of the tile's pixels (at most min(count, k_stop
// * chunk), the lanes the forward walked): no pixel applied a later pair,
// so every later lane's gradients are 0. Each chunk's reverse walk starts
// from the forward's own log T after the chunk's last applied pair: its
// record at the next chunk's start (`chunk_logt`, as blend_tile_fwd wrote
// it) where the pixel applied pairs past this chunk, else its log_t; log T
// is rebuilt from there through the chunk's applied pairs
// (blend_piece_bwd). Writes each walked lane's ten sums (rows 0-5 and 8-11
// of `out`) once; `fill(end)` runs after the first copy is issued, for a
// layout that must also write what no walked lane covers.
template <typename Fill>
__device__ __forceinline__ void blend_tile_bwd(float (*stage)[kStageFloats],
                                               float* part, PairWindow win,
                                               GradWindow out, int count,
                                               int chunk, int t, int tile0,
                                               int grid_x,
                                               const float* __restrict__ gacc,
                                               const float* __restrict__ glogt,
                                               const float* __restrict__ logt,
                                               const int* __restrict__ last_in,
                                               const float* __restrict__ chunk_logt,
                                               Fill fill) {
  const int i = threadIdx.x;
  float px, py;
  pixel_of(tile0 + t, grid_x, &px, &py);
  const size_t tp = (size_t)t * kPix + i;
  const int last = min(max(last_in[tp], 0), count);
  const int warp_last = __reduce_max_sync(0xffffffffu, last);
  if ((i & 31) == 0) part[i >> 5] = __int_as_float(warp_last);
  __syncthreads();
  int end = 0;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) end = max(end, __float_as_int(part[wp]));
  const int sw = min(kSub, chunk);
  const int nsub = (chunk + sw - 1) / sw;
  const int n_pieces = pieces_of(end, chunk, sw, nsub);
  if (n_pieces > 0) {
    stage_piece(stage[(n_pieces - 1) & 1], win,
                piece_of(n_pieces - 1, chunk, sw, nsub, end));
  }
  fill(end);

  float log_after = logt[tp];   // reset at the end of each chunk below
  float gc[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) gc[ch] = gacc[((size_t)t * 4 + ch) * kPix + i];
  const float gl = glogt[tp];
  double suffix = 0.0;          // sum over later pairs of wbar * w
  const int slot = reduce10_slot(i & 31);

  for (int p = n_pieces - 1; p >= 0; --p) {
    const Piece q = piece_of(p, chunk, sw, nsub, end);
    if (p == n_pieces - 1 || (p + 1) % nsub == 0) {   // the end of chunk k
      const int k = p / nsub;
      // the inclusive log T of the chunk's last applied pair, as the
      // forward computed it (either value where the chunk applied none)
      log_after = last > (k + 1) * chunk
                      ? chunk_logt[(size_t)(k + 1) * kPix + i]
                      : logt[tp];
    }
    cp_async_wait_all();
    __syncthreads();   // piece p landed; buffer (p - 1) & 1 and part free
    if (p > 0) {
      stage_piece(stage[(p - 1) & 1], win, piece_of(p - 1, chunk, sw, nsub, end));
    }
    blend_piece_bwd(stage[p & 1], part, q.start, q.n, px, py, gc, gl, last,
                    warp_last, slot, log_after, suffix);
    __syncthreads();
    for (int idx = i; idx < kGrad * q.n; idx += kPix) {
      const int r = idx / q.n;
      const int j = idx - r * q.n;
      const float s = sum_piece_partials(part, j, r);
      if (r < 6) {
        out.geom[(size_t)r * out.stride + q.start + j] = s;
      } else {
        out.rgbd[(size_t)(r - 6) * out.stride + q.start + j] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tile order: deepest tiles first, so they do not set the tail.
// ---------------------------------------------------------------------------

constexpr int kOrderThreads = 256;   // 8 warps, one tile each

// order[rank(t)] = t, where rank(t) counts the tiles whose walk count
// (count_of(u), clamped as the blend clamps it) is larger, and those with
// the same count and a smaller index: the stable descending argsort of the
// counts. One warp per tile, its lanes striding over the other tiles;
// integer sums only, so the order is the same on every run.
template <typename CountOf>
__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(CountOf count_of, int num_tiles, int* __restrict__ order) {
  const int t = blockIdx.x * (kOrderThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;          // the whole warp: t is per warp
  const int c = count_of(t);
  int rank = 0;
  for (int u = lane; u < num_tiles; u += 32) {
    const int cu = count_of(u);
    rank += (cu > c) || (cu == c && u < t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
  if (lane == 0) order[rank] = t;
}

// Fills order (num_tiles ints) on the stream; returns a cudaError_t.
template <typename CountOf>
int launch_tile_order(CountOf count_of, int num_tiles, int* order,
                      cudaStream_t stream) {
  constexpr int kTilesPerBlock = kOrderThreads / 32;
  tile_order_kernel<<<(num_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                      kOrderThreads, 0, stream>>>(count_of, num_tiles, order);
  return (int)cudaGetLastError();
}

// The tile this block walks: order[blockIdx.x], clamped.
__device__ __forceinline__ int tile_of(const int* order, int num_tiles) {
  return min(max(order[blockIdx.x], 0), num_tiles - 1);
}

// Host: CTAs per SM at kPix threads, registers per thread, static shared
// memory per CTA and local (spill) bytes per thread of a kernel, into
// out[0..3]. Returns a cudaError_t.
template <typename Kernel>
inline int kernel_info(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPix, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace gsl
