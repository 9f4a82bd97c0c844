// Pose mode's per-pair projection (P1) and its adjoint onto the camera (P2)
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel of gs_localization_tpu: the JAX package leaves
// this projection (raster/pose_mode.py, _project_core) to XLA's fusion. In
// PyTorch the same function is about 100 elementwise launches over every
// slot of the pair stream, each read and written whole, replayed by autograd
// in the backward, and every product with a pose scalar then needs its own
// full-length reduction to reach that scalar's gradient: about 300 launches
// and twice the stream's bytes an iteration. These two kernels do it in two
// launches over the live prefix (positions < kept_al, read on the device).
//
// P1 pose_project_fwd_kernel: one thread a stream position. A position below
//   kept_al reads its 14 param rows (xyz, cov3d, opacity, valid, rgb) and
//   writes the 16 blend-layout rows [px, py, a, b, c, opa, valid, 0, r, g,
//   b, vz, 0, 0, 0, 0]; a position at or past kept_al is one 64-byte zero
//   store and loads nothing (the plain version projects its zero params to
//   valid == 0; K1/K2 apply neither). Every operation is the plain version's
//   own, in its order, as a round-to-nearest intrinsic (__fmul_rn, ...),
//   which the compiler never fuses into an fma: the same float32 roundings
//   as PyTorch's op-by-op evaluation, so the gates (the 1e-6 depth guard,
//   the 1e-12 determinant guard, the near cull) decide as the plain version
//   does. No fast math: the gates are threshold tests.
// P2 pose_project_bwd_kernel + pose_project_sum_kernel: the hand-derived
//   adjoint of P1 (autograd's conventions: the clamp passes the gradient
//   only inside its limits, inclusive; a torch.where routes it to the branch
//   it took), from the stream cotangent's rows 0-4 and 11 (valid is a
//   comparison; opacity and rgb do not depend on the pose), recomputing each
//   live position's intermediates from its 9 geometry rows, onto the 24 pose
//   scalars: w2c rows 0-2 and full_proj rows 0, 1 and 3, each (x, y, z, 1)-
//   wise. Arithmetic is float32; the sums are float64.
//
// Reduction order (no float atomics: two calls give the same bits): the
// first pass runs a fixed grid (blocks = min(ceil(n / 256), 1024), set by
// the stream's length only); thread j of block b sums, in float64, the
// positions b * 256 + j + k * grid * 256 in increasing k; a warp folds its
// lanes by a shuffle butterfly, the block its 8 warps in order, into one
// float64 row of 24 per block. The second pass sums each column over the
// blocks, 256 threads in a strided order and then a shared-memory tree, and
// rounds once to float32.
//
// What bounds them on the H100: bytes. P1 reads 56 B and writes 64 B a live
// position and writes 64 B a dead one: at the mip360-localize stream
// (17,815,808 slots, about 7.9 M live) about 1.6 GB, 0.48 ms at 3.35 TB/s.
// P2 reads 9 param rows and 6 cotangent rows, 60 B a live position: about
// 0.47 GB, 0.14 ms; its ~200 float32 operations a position stay below the
// byte time. Loads and stores run along N (rows are (16, N) row-major),
// neighbouring threads on neighbouring columns, so every access coalesces.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;   // stream rows
constexpr int kGrad = 24;   // pose scalars: w2c rows 0-2, full_proj rows 0,1,3

// param rows (raster/pose_mode.py)
constexpr int kPOpa = 9, kPValid = 10, kPR = 11;
// the stream row of the depth; rows 0-4 (px, py, conic a, b, c) and it are
// the cotangent rows that carry a pose gradient
constexpr int kDepth = 11;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Cam {
  float W[3][4];   // w2c rows 0-2: R | t
  float F[3][4];   // full_proj rows 0, 1, 3
  float fx, fy, lim_x, lim_y;
};

// pose (24): w2c rows 0-2, full_proj rows 0, 1, 3; intr (4): fx, fy,
// tan_fovx, tan_fovy.
__device__ __forceinline__ Cam load_cam(const float* __restrict__ pose,
                                        const float* __restrict__ intr) {
  Cam c;
#pragma unroll
  for (int k = 0; k < 12; ++k) c.W[k / 4][k % 4] = __ldg(pose + k);
#pragma unroll
  for (int k = 0; k < 12; ++k) c.F[k / 4][k % 4] = __ldg(pose + 12 + k);
  c.fx = __ldg(intr);
  c.fy = __ldg(intr + 1);
  c.lim_x = mul(__ldg(intr + 2), 1.3f);   // 1.3 * camera.tan_fovx
  c.lim_y = mul(__ldg(intr + 3), 1.3f);
  return c;
}

// m . (x, y, z, 1) as ((m0 x + m1 y) + m2 z) + m3
__device__ __forceinline__ float affine(const float* m, const float* X) {
  return add(add(add(mul(m[0], X[0]), mul(m[1], X[1])), mul(m[2], X[2])),
             m[3]);
}

// _project_core's intermediates at one position.
struct Proj {
  float X[3];
  float vx, vy, vz, hx, hy, inv_w;
  float r[3][3];   // rows of R C
  float v00, v01, v02, v11, v12, v22;
  float zs, ux, uy, tx, ty, inv_z, inv_z2, j00, j02, j11, j12;
  float a, b, c, det, inv_det;
};

// p: x, y, z, c00, c01, c02, c11, c12, c22.
__device__ __forceinline__ void project(const Cam& cam, const float* p,
                                        Proj& q) {
  q.X[0] = p[0];
  q.X[1] = p[1];
  q.X[2] = p[2];
  q.vx = affine(cam.W[0], q.X);
  q.vy = affine(cam.W[1], q.X);
  q.vz = affine(cam.W[2], q.X);
  q.hx = affine(cam.F[0], q.X);
  q.hy = affine(cam.F[1], q.X);
  q.inv_w = dvd(1.0f, add(affine(cam.F[2], q.X), 1e-7f));
  const float c00 = p[3], c01 = p[4], c02 = p[5], c11 = p[6], c12 = p[7],
              c22 = p[8];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* R = cam.W[i];
    q.r[i][0] = add(add(mul(R[0], c00), mul(R[1], c01)), mul(R[2], c02));
    q.r[i][1] = add(add(mul(R[0], c01), mul(R[1], c11)), mul(R[2], c12));
    q.r[i][2] = add(add(mul(R[0], c02), mul(R[1], c12)), mul(R[2], c22));
  }
  auto dot = [&](int i, int j) {
    return add(add(mul(q.r[i][0], cam.W[j][0]), mul(q.r[i][1], cam.W[j][1])),
               mul(q.r[i][2], cam.W[j][2]));
  };
  q.v00 = dot(0, 0);
  q.v01 = dot(0, 1);
  q.v02 = dot(0, 2);
  q.v11 = dot(1, 1);
  q.v12 = dot(1, 2);
  q.v22 = dot(2, 2);
  q.zs = fabsf(q.vz) < 1e-6f ? 1e-6f : q.vz;
  q.ux = dvd(q.vx, q.zs);
  q.uy = dvd(q.vy, q.zs);
  q.tx = mul(clampf(q.ux, -cam.lim_x, cam.lim_x), q.zs);
  q.ty = mul(clampf(q.uy, -cam.lim_y, cam.lim_y), q.zs);
  q.inv_z = dvd(1.0f, q.zs);
  q.inv_z2 = mul(q.inv_z, q.inv_z);
  q.j00 = mul(cam.fx, q.inv_z);
  q.j02 = mul(mul(-cam.fx, q.tx), q.inv_z2);
  q.j11 = mul(cam.fy, q.inv_z);
  q.j12 = mul(mul(-cam.fy, q.ty), q.inv_z2);
  const float j00 = q.j00, j02 = q.j02, j11 = q.j11, j12 = q.j12;
  q.a = add(add(add(mul(mul(j00, j00), q.v00),
                    mul(mul(mul(2.0f, j00), j02), q.v02)),
                mul(mul(j02, j02), q.v22)),
            0.3f);
  q.b = add(add(add(mul(mul(j00, j11), q.v01), mul(mul(j00, j12), q.v02)),
                mul(mul(j02, j11), q.v12)),
            mul(mul(j02, j12), q.v22));
  q.c = add(add(add(mul(mul(j11, j11), q.v11),
                    mul(mul(mul(2.0f, j11), j12), q.v12)),
                mul(mul(j12, j12), q.v22)),
            0.3f);
  q.det = sub(mul(q.a, q.c), mul(q.b, q.b));
  q.inv_det = dvd(1.0f, fabsf(q.det) < 1e-12f ? 1.0f : q.det);
}

// The adjoint of project() from the cotangent g of (px, py, conic a, b, c,
// depth) onto the 24 pose scalars d.
__device__ __forceinline__ void adjoint(const Cam& cam, const Proj& q,
                                        const float* g, float sx, float sy,
                                        float* d) {
  // px = ((hx inv_w + 1) W - 1) / 2, inv_w = 1 / (hw + 1e-7)
  const float ghx = g[0] * sx * q.inv_w;
  const float ghy = g[1] * sy * q.inv_w;
  const float ginv_w = g[0] * sx * q.hx + g[1] * sy * q.hy;
  const float ghw = -ginv_w * q.inv_w * q.inv_w;
  // conic (c, -b, a) * inv_det; the determinant's guard routes nothing
  float ga = g[4] * q.inv_det, gb = -g[3] * q.inv_det, gc = g[2] * q.inv_det;
  if (!(fabsf(q.det) < 1e-12f)) {
    const float ginv_det = g[2] * q.c - g[3] * q.b + g[4] * q.a;
    const float gdet = -ginv_det * q.inv_det * q.inv_det;
    ga += gdet * q.c;
    gc += gdet * q.a;
    gb -= 2.0f * gdet * q.b;
  }
  // 2-D covariance J V J^T + 0.3 I
  const float j00 = q.j00, j02 = q.j02, j11 = q.j11, j12 = q.j12;
  const float gv00 = ga * j00 * j00;
  const float gv01 = gb * j00 * j11;
  const float gv02 = 2.0f * ga * j00 * j02 + gb * j00 * j12;
  const float gv11 = gc * j11 * j11;
  const float gv12 = gb * j02 * j11 + 2.0f * gc * j11 * j12;
  const float gv22 = ga * j02 * j02 + gb * j02 * j12 + gc * j12 * j12;
  const float gj00 = 2.0f * ga * (j00 * q.v00 + j02 * q.v02) +
                     gb * (j11 * q.v01 + j12 * q.v02);
  const float gj02 = 2.0f * ga * (j00 * q.v02 + j02 * q.v22) +
                     gb * (j11 * q.v12 + j12 * q.v22);
  const float gj11 = gb * (j00 * q.v01 + j02 * q.v12) +
                     2.0f * gc * (j11 * q.v11 + j12 * q.v12);
  const float gj12 = gb * (j00 * q.v02 + j02 * q.v22) +
                     2.0f * gc * (j11 * q.v12 + j12 * q.v22);
  // Jacobian: j00 = fx / z, j02 = -fx tx / z^2 (and y)
  const float ginv_z2 = -(gj02 * cam.fx * q.tx + gj12 * cam.fy * q.ty);
  const float ginv_z =
      gj00 * cam.fx + gj11 * cam.fy + 2.0f * ginv_z2 * q.inv_z;
  const float gtx = -gj02 * cam.fx * q.inv_z2;
  const float gty = -gj12 * cam.fy * q.inv_z2;
  // tx = clamp(vx / zs) zs
  const float cux = clampf(q.ux, -cam.lim_x, cam.lim_x);
  const float cuy = clampf(q.uy, -cam.lim_y, cam.lim_y);
  const float gux =
      (q.ux >= -cam.lim_x && q.ux <= cam.lim_x) ? gtx * q.zs : 0.0f;
  const float guy =
      (q.uy >= -cam.lim_y && q.uy <= cam.lim_y) ? gty * q.zs : 0.0f;
  const float gzs = -ginv_z * q.inv_z * q.inv_z + gtx * cux + gty * cuy -
                    (gux * q.ux + guy * q.uy) / q.zs;
  const float gv[3] = {gux / q.zs, guy / q.zs,
                       g[5] + (fabsf(q.vz) < 1e-6f ? 0.0f : gzs)};
  // w2c: v_i = W_i . (x, y, z, 1) and V = R C R^T through r_i = R_i C:
  // dV_ij / dR_k = [k == i] r_j + [k == j] r_i
  const float S[3][3] = {{2.0f * gv00, gv01, gv02},
                         {gv01, 2.0f * gv11, gv12},
                         {gv02, gv12, 2.0f * gv22}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d[4 * i + k] = gv[i] * q.X[k] + S[i][0] * q.r[0][k] +
                     S[i][1] * q.r[1][k] + S[i][2] * q.r[2][k];
    d[4 * i + 3] = gv[i];
  }
  const float gh[3] = {ghx, ghy, ghw};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d[12 + 4 * i + k] = gh[i] * q.X[k];
    d[12 + 4 * i + 3] = gh[i];
  }
}

__device__ __forceinline__ int live_length(const int* kept, int n) {
  return min(max(__ldg(kept), 0), n);
}

__global__ void __launch_bounds__(kThreads)
pose_project_fwd_kernel(const float* __restrict__ params,
                        const int* __restrict__ kept,
                        const float* __restrict__ pose,
                        const float* __restrict__ intr, int n, int width,
                        int height, float near_cull,
                        float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  float o[kRows] = {};
  if (i < live_length(kept, n)) {
    const Cam cam = load_cam(pose, intr);
    float p[9];
#pragma unroll
    for (int r = 0; r < 9; ++r) p[r] = __ldg(params + r * N + i);
    Proj q;
    project(cam, p, q);
    o[0] = mul(sub(mul(add(mul(q.hx, q.inv_w), 1.0f), (float)width), 1.0f),
               0.5f);
    o[1] = mul(sub(mul(add(mul(q.hy, q.inv_w), 1.0f), (float)height), 1.0f),
               0.5f);
    o[2] = mul(q.c, q.inv_det);
    o[3] = mul(-q.b, q.inv_det);
    o[4] = mul(q.a, q.inv_det);
    o[5] = __ldg(params + kPOpa * N + i);
    o[6] = (__ldg(params + kPValid * N + i) > 0.5f && q.vz > near_cull &&
            fabsf(q.det) > 1e-12f)
               ? 1.0f
               : 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) o[8 + r] = __ldg(params + (kPR + r) * N + i);
    o[kDepth] = q.vz;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * N + i] = o[r];
}

__global__ void __launch_bounds__(kThreads)
pose_project_bwd_kernel(const float* __restrict__ params,
                        const int* __restrict__ kept,
                        const float* __restrict__ pose,
                        const float* __restrict__ intr,
                        const float* __restrict__ dstream, int n, int width,
                        int height, double* __restrict__ partials) {
  const Cam cam = load_cam(pose, intr);
  const float sx = 0.5f * (float)width, sy = 0.5f * (float)height;
  const int live = live_length(kept, n);
  const size_t N = (size_t)n;
  double acc[kGrad] = {};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < live;
       i += gridDim.x * kThreads) {
    float p[9], g[6], d[kGrad];
#pragma unroll
    for (int r = 0; r < 9; ++r) p[r] = __ldg(params + r * N + i);
#pragma unroll
    for (int r = 0; r < 5; ++r) g[r] = __ldg(dstream + r * N + i);
    g[5] = __ldg(dstream + kDepth * N + i);
    Proj q;
    project(cam, p, q);
    adjoint(cam, q, g, sx, sy, d);
#pragma unroll
    for (int k = 0; k < kGrad; ++k) acc[k] += (double)d[k];
  }
  __shared__ double warp_sum[kWarps][kGrad];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kGrad; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sum[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kGrad) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w][threadIdx.x];
    partials[(size_t)blockIdx.x * kGrad + threadIdx.x] = s;
  }
}

// Block k sums column k of the (blocks, 24) partials.
__global__ void __launch_bounds__(kThreads)
pose_project_sum_kernel(const double* __restrict__ partials, int blocks,
                        float* __restrict__ grad) {
  __shared__ double s[kThreads];
  double v = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    v += partials[(size_t)b * kGrad + blockIdx.x];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) grad[blockIdx.x] = (float)s[0];
}

template <typename Kernel>
int info_of(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// params (16 x n floats, rows as StreamPairPack's) -> out (16 x n floats,
// blend-layout rows); kept is one int on the device, pose 24 and intr 4
// floats on the device.
int gsl_pose_project_fwd(const float* params, const int* kept,
                         const float* pose, const float* intr, int n,
                         int width, int height, float near_cull, float* out,
                         void* cuda_stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  pose_project_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)cuda_stream>>>(
      params, kept, pose, intr, n, width, height, near_cull, out);
  return (int)cudaGetLastError();
}

// dstream (16 x n floats) is the stream's cotangent; partials (blocks x 24
// doubles) is scratch; grad (24 floats) receives the pose gradient.
int gsl_pose_project_bwd(const float* params, const int* kept,
                         const float* pose, const float* intr,
                         const float* dstream, int n, int width, int height,
                         double* partials, int blocks, float* grad,
                         void* cuda_stream) {
  if (n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  pose_project_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      params, kept, pose, intr, dstream, n, width, height, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pose_project_sum_kernel<<<kGrad, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      partials, blocks, grad);
  return (int)cudaGetLastError();
}

// CTAs per SM at 256 threads, registers per thread, shared memory per CTA
// and local bytes per thread of P1 (which = 0) or P2's first pass (1).
int gsl_pose_project_info(int which, int* out) {
  if (which == 0) return info_of(pose_project_fwd_kernel, out);
  if (which == 1) return info_of(pose_project_bwd_kernel, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
