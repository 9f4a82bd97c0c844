// The pose refinement's per-iteration pose algebra for Hopper (sm_90a):
// the tangent's exponential applied to the pose (A1) and its adjoint (A2),
// the pose's camera vectors (V1) and their adjoint (V2), and the Adam step
// of the tangent and the exposure (S1).
//
// Replaces no Pallas kernel of gs_localization_tpu: the JAX package leaves
// this algebra to XLA, which fuses it into the iteration's program. In
// PyTorch an iteration of loc/refine.py::refine_pose carried the pose
// through about 370 operations on tensors of 1 to 24 floats (the forward,
// autograd's replay of it back to the tangent, two Adam updates, the
// retraction and a norm), each a launch, and core/se3.py::se3_exp built its
// bottom row by a copy from pageable memory, which waits for the stream,
// twice an iteration. Here the same algebra is six launches a pose-mode
// iteration and no wait:
//
// A1 se3_apply_fwd_kernel: core/se3.py::apply_delta, exp(tau) @ w2c for a
//   (6,) tangent [rho, theta] and a (4, 4) pose: Rodrigues' formula with
//   so3_exp's and so3_left_jacobian's small-angle test (|theta|^2 < 1e-10)
//   and Taylor constants; the bottom row of exp(tau) is written here.
// A2 se3_apply_bwd_kernel: its adjoint (core/se3.py::_apply_delta_adjoint
//   is the plain version): from the cotangent g of the product, tau's
//   gradient through both branches with autograd's conventions (the small
//   branch's constants carry no gradient through the angle) and w2c's,
//   exp(tau)^T g.
// V1 pose_vectors_fwd_kernel: raster/pose_mode.py::camera_vectors, the (24,)
//   pose [w2c rows 0-2, rows 0, 1 and 3 of projection @ w2c] and the (4,)
//   [fx, fy, tan_fovx, tan_fovy] that P1 takes, with the projection built
//   from the intrinsics by core/camera.py::projection_matrix's formula.
// V2 pose_vectors_bwd_kernel: its adjoint onto w2c (pose_mode.py::
//   _camera_vectors_adjoint): rows 0-2 of the cotangent directly, plus
//   projection^T applied to its three full_proj rows.
// S1 refine_adam_kernel: refine_pose's two Adam updates (the tangent's six
//   moments and the exposure's two, in place), the tangent's update, the
//   exposure's new value (in place) and the update's norm, which the loop
//   reads for its convergence test.
//
// Every operation is the plain version's own, in its order, as PyTorch
// evaluates it on the card, with round-to-nearest intrinsics (__fmul_rn,
// ...) that the compiler never contracts into an fma: a division by a
// Python number is a product by its float32 reciprocal, a Python number
// divided by a tensor the tensor's reciprocal times the number, and a
// product of small matrices a sum over k in order. No fast math: sinf,
// cosf and __fsqrt_rn are the accurate ones.
//
// What bounds them on the H100: launch latency. Each reads and writes at
// most a few hundred bytes and does a few hundred float operations, so one
// thread of one block does all of it; what the design saves is the ~60
// launches (and, for A1, the wait) that each replaces.

#include <cuda_runtime.h>

namespace {

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

// c = a @ b for row-major a (M x K) and b (K x N), each sum over k in order.
template <int M, int K, int N>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* c) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = mul(a[i * K], b[j]);
#pragma unroll
      for (int k = 1; k < K; ++k) s = add(s, mul(a[i * K + k], b[k * N + j]));
      c[i * N + j] = s;
    }
  }
}

// c = a^T @ b for row-major a (K x M) and b (K x N).
template <int K, int M, int N>
__device__ __forceinline__ void matmul_tn(const float* a, const float* b,
                                          float* c) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = mul(a[i], b[j]);
#pragma unroll
      for (int k = 1; k < K; ++k) s = add(s, mul(a[k * M + i], b[k * N + j]));
      c[i * N + j] = s;
    }
  }
}

// sum over the 9 entries of a * b, row-major, in order
__device__ __forceinline__ float dot9(const float* a, const float* b) {
  float s = mul(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) s = add(s, mul(a[k], b[k]));
  return s;
}

// core/se3.py's exponential at tau = [rho, theta] and the pieces its
// adjoint reads.
struct Exp {
  float W[9];    // skew(theta)
  float W2[9];   // W @ W
  float V[9];    // the left Jacobian: I + c W + c2 W2
  float E[16];   // exp(tau): [I + s W + c W2 | V rho], bottom row 0 0 0 1
  float a;       // the angle (1 on the small branch)
  float s, c, c2;  // sin a / a, (1 - cos a) / a^2, (a - sin a) / a^3
  bool small;
};

__device__ __forceinline__ void se3_exp(const float* tau, Exp& e) {
  const float x = tau[3], y = tau[4], z = tau[5];
  const float W[9] = {0.0f, -z, y, z, 0.0f, -x, -y, x, 0.0f};
#pragma unroll
  for (int k = 0; k < 9; ++k) e.W[k] = W[k];
  matmul<3, 3, 3>(e.W, e.W, e.W2);
  // _safe_angle: torch.sum(theta * theta) < _SMALL**2, as float32
  const float sq = add(add(mul(x, x), mul(y, y)), mul(z, z));
  e.small = sq < 1e-10f;
  e.a = __fsqrt_rn(e.small ? 1.0f : sq);
  if (e.small) {
    e.s = 1.0f;
    e.c = 0.5f;
    e.c2 = (float)(1.0 / 6.0);
  } else {
    const float sa = sinf(e.a), ca = cosf(e.a), a2 = mul(e.a, e.a);
    e.s = dvd(sa, e.a);
    e.c = dvd(sub(1.0f, ca), a2);
    e.c2 = dvd(sub(e.a, sa), mul(a2, e.a));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const int k = 3 * i + j;
      e.E[4 * i + j] = add(add(eye, mul(e.s, e.W[k])), mul(e.c, e.W2[k]));
      e.V[k] = add(add(eye, mul(e.c, e.W[k])), mul(e.c2, e.W2[k]));
    }
    e.E[4 * i + 3] = add(add(mul(e.V[3 * i], tau[0]),
                             mul(e.V[3 * i + 1], tau[1])),
                         mul(e.V[3 * i + 2], tau[2]));
  }
  e.E[12] = 0.0f;
  e.E[13] = 0.0f;
  e.E[14] = 0.0f;
  e.E[15] = 1.0f;
}

// A1: out = exp(tau) @ w2c.
__global__ void se3_apply_fwd_kernel(const float* __restrict__ tau,
                                     const float* __restrict__ w2c,
                                     float* __restrict__ out) {
  float t[6], w[16], o[16];
#pragma unroll
  for (int k = 0; k < 6; ++k) t[k] = tau[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = w2c[k];
  Exp e;
  se3_exp(t, e);
  matmul<4, 4, 4>(e.E, w, o);
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = o[k];
}

// A2: from g, the cotangent of exp(tau) @ w2c, the gradients of tau (6)
// and of w2c (4 x 4), as core/se3.py::_apply_delta_adjoint computes them.
__global__ void se3_apply_bwd_kernel(const float* __restrict__ tau,
                                     const float* __restrict__ w2c,
                                     const float* __restrict__ g,
                                     float* __restrict__ g_tau,
                                     float* __restrict__ g_w2c) {
  float t[6], w[16], gg[16];
#pragma unroll
  for (int k = 0; k < 6; ++k) t[k] = tau[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    w[k] = w2c[k];
    gg[k] = g[k];
  }
  Exp e;
  se3_exp(t, e);
  float gw[16];
  matmul_tn<4, 4, 4>(e.E, gg, gw);               // exp(tau)^T g
#pragma unroll
  for (int k = 0; k < 16; ++k) g_w2c[k] = gw[k];
  // gE = g @ w2c^T, rows 0-2: gR | gt
  float gR[9], gt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = mul(gg[4 * i], w[4 * j]);
#pragma unroll
      for (int k = 1; k < 4; ++k) s = add(s, mul(gg[4 * i + k], w[4 * j + k]));
      if (j < 3) gR[3 * i + j] = s; else gt[i] = s;
    }
  }
  // t = V rho: g_rho = V^T gt, gV = gt rho^T
  float g_rho[3], gV[9];
  matmul_tn<3, 3, 1>(e.V, gt, g_rho);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) gV[3 * i + j] = mul(gt[i], t[j]);
  }
  // the W2 = W @ W cotangent G2 = c gR + c2 gV; then
  // gW = (s gR + c gV) + G2 @ W^T + W^T @ G2
  float G2[9], gW[9], A[9], B[9], Wt[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Wt[3 * i + j] = e.W[3 * j + i];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    G2[k] = add(mul(e.c, gR[k]), mul(e.c2, gV[k]));
  matmul<3, 3, 3>(G2, Wt, A);
  matmul_tn<3, 3, 3>(e.W, G2, B);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    gW[k] = add(add(add(mul(e.s, gR[k]), mul(e.c, gV[k])), A[k]), B[k]);
  // skew's adjoint
  float g_th[3] = {sub(gW[7], gW[5]), sub(gW[2], gW[6]), sub(gW[3], gW[1])};
  if (!e.small) {
    // the angle's gradient through s, c (twice) and c2, then
    // d a / d theta = theta / a
    const float a = e.a, sa = sinf(a), ca = cosf(a), a2 = mul(a, a);
    const float a3 = mul(a2, a), omc = sub(1.0f, ca);
    const float ds = dvd(sub(mul(a, ca), sa), a2);
    const float dc = dvd(sub(mul(a, sa), mul(2.0f, omc)), a3);
    const float dc2 = dvd(sub(mul(omc, a), mul(3.0f, sub(a, sa))),
                          mul(a3, a));
    const float g_a = add(add(mul(dot9(gR, e.W), ds),
                              mul(add(dot9(gR, e.W2), dot9(gV, e.W)), dc)),
                          mul(dot9(gV, e.W2), dc2));
    const float r = dvd(g_a, a);
#pragma unroll
    for (int k = 0; k < 3; ++k) g_th[k] = add(g_th[k], mul(t[3 + k], r));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_tau[k] = g_rho[k];
    g_tau[3 + k] = g_th[k];
  }
}

// core/camera.py::projection_matrix as PyTorch evaluates it on the card, in
// float32 (Python numbers' own arithmetic in double).
__device__ __forceinline__ void projection(float fx, float fy, float cx,
                                           float cy, int width, int height,
                                           float znear, float zfar,
                                           float* P) {
  const float w = (float)width, h = (float)height;
  // ((2 cx - W) / W -/+ 1) W / 2
  const float ox = mul(sub(mul(cx, 2.0f), w), dvd(1.0f, w));
  const float oy = mul(sub(mul(cy, 2.0f), h), dvd(1.0f, h));
  // znear / fx: fx's reciprocal times znear
  const float nx = mul(dvd(1.0f, fx), znear), ny = mul(dvd(1.0f, fy), znear);
  const float left = mul(nx, mul(mul(sub(ox, 1.0f), w), 0.5f));
  const float right = mul(nx, mul(mul(add(ox, 1.0f), w), 0.5f));
  const float top = mul(ny, mul(mul(add(oy, 1.0f), h), 0.5f));
  const float bottom = mul(ny, mul(mul(sub(oy, 1.0f), h), 0.5f));
  const float near2 = (float)(2.0 * (double)znear);
  const double zn = znear, zf = zfar;
  const float rl = sub(right, left), tb = sub(top, bottom);
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = 0.0f;
  P[0] = mul(dvd(1.0f, rl), near2);
  P[2] = dvd(add(right, left), rl);
  P[5] = mul(dvd(1.0f, tb), near2);
  P[6] = dvd(add(top, bottom), tb);
  P[10] = (float)(zf / (zf - zn));
  P[11] = (float)(-(zf * zn) / (zf - zn));
  P[14] = 1.0f;
}

// V1: pose (24) = [w2c rows 0-2, (P @ w2c) rows 0, 1, 3]; intr (4) =
// [fx, fy, W / (2 fx), H / (2 fy)].
__global__ void pose_vectors_fwd_kernel(
    const float* __restrict__ w2c, const float* __restrict__ fx,
    const float* __restrict__ fy, const float* __restrict__ cx,
    const float* __restrict__ cy, int width, int height, float znear,
    float zfar, float* __restrict__ pose, float* __restrict__ intr) {
  float w[16], P[16], fp[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = w2c[k];
  const float fxv = *fx, fyv = *fy;
  projection(fxv, fyv, *cx, *cy, width, height, znear, zfar, P);
  matmul<4, 4, 4>(P, w, fp);
#pragma unroll
  for (int k = 0; k < 12; ++k) pose[k] = w[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) pose[12 + k] = fp[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) pose[20 + k] = fp[12 + k];
  intr[0] = fxv;
  intr[1] = fyv;
  intr[2] = mul(dvd(1.0f, mul(fxv, 2.0f)), (float)width);
  intr[3] = mul(dvd(1.0f, mul(fyv, 2.0f)), (float)height);
}

// V2: g_w2c (4 x 4) = [gpose rows 0-2; 0] + P^T @ [gpose 12-19; 0; gpose
// 20-23].
__global__ void pose_vectors_bwd_kernel(
    const float* __restrict__ fx, const float* __restrict__ fy,
    const float* __restrict__ cx, const float* __restrict__ cy, int width,
    int height, float znear, float zfar, const float* __restrict__ gpose,
    float* __restrict__ g_w2c) {
  float P[16], gfp[16], o[16];
  projection(*fx, *fy, *cx, *cy, width, height, znear, zfar, P);
#pragma unroll
  for (int k = 0; k < 8; ++k) gfp[k] = gpose[12 + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gfp[8 + k] = 0.0f;
    gfp[12 + k] = gpose[20 + k];
  }
  matmul_tn<4, 4, 4>(P, gfp, o);
#pragma unroll
  for (int k = 0; k < 16; ++k) g_w2c[k] = k < 12 ? add(o[k], gpose[k]) : o[k];
}

// S1: Adam (b1, b2, eps, lr; bc1 = 1 - b1^t, bc2 = 1 - b2^t and the
// weights 1 - b1, 1 - b2 as the host computes them) over the tangent's 6
// and the exposure's 2 gradients, moments in place; upd6 = the tangent's
// update, ab += the exposure's, norm = |upd6|.
__global__ void refine_adam_kernel(
    const float* __restrict__ g6, const float* __restrict__ g2,
    float* __restrict__ m6, float* __restrict__ v6, float* __restrict__ m2,
    float* __restrict__ v2, float* __restrict__ ab, float* __restrict__ upd6,
    float* __restrict__ norm, float b1, float omb1, float b2, float omb2,
    float eps, float lr, float bc1, float bc2) {
  const float rb1 = dvd(1.0f, bc1), rb2 = dvd(1.0f, bc2);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool pose = i < 6;
    float* m = pose ? m6 + i : m2 + (i - 6);
    float* v = pose ? v6 + i : v2 + (i - 6);
    const float g = pose ? g6[i] : g2[i - 6];
    const float mi = add(mul(*m, b1), mul(g, omb1));
    const float vi = add(mul(*v, b2), mul(mul(g, omb2), g));
    const float u = dvd(mul(mul(mi, rb1), -lr),
                        add(__fsqrt_rn(mul(vi, rb2)), eps));
    *m = mi;
    *v = vi;
    if (pose) {
      upd6[i] = u;
      sq = add(sq, mul(u, u));
    } else {
      ab[i - 6] = add(ab[i - 6], u);
    }
  }
  *norm = __fsqrt_rn(sq);
}

}  // namespace

extern "C" {

// tau 6 floats, w2c and out 16 floats (row-major), all on the device.
int gsl_se3_apply_fwd(const float* tau, const float* w2c, float* out,
                      void* cuda_stream) {
  se3_apply_fwd_kernel<<<1, 1, 0, (cudaStream_t)cuda_stream>>>(tau, w2c, out);
  return (int)cudaGetLastError();
}

// g (16 floats) is the cotangent of exp(tau) @ w2c; g_tau (6) and g_w2c
// (16) receive the gradients.
int gsl_se3_apply_bwd(const float* tau, const float* w2c, const float* g,
                      float* g_tau, float* g_w2c, void* cuda_stream) {
  se3_apply_bwd_kernel<<<1, 1, 0, (cudaStream_t)cuda_stream>>>(
      tau, w2c, g, g_tau, g_w2c);
  return (int)cudaGetLastError();
}

// w2c 16 floats; fx, fy, cx, cy one float each; pose 24 and intr 4 floats.
int gsl_pose_vectors_fwd(const float* w2c, const float* fx, const float* fy,
                         const float* cx, const float* cy, int width,
                         int height, float znear, float zfar, float* pose,
                         float* intr, void* cuda_stream) {
  if (width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  pose_vectors_fwd_kernel<<<1, 1, 0, (cudaStream_t)cuda_stream>>>(
      w2c, fx, fy, cx, cy, width, height, znear, zfar, pose, intr);
  return (int)cudaGetLastError();
}

// gpose 24 floats, the pose vector's cotangent; g_w2c 16 floats.
int gsl_pose_vectors_bwd(const float* fx, const float* fy, const float* cx,
                         const float* cy, int width, int height, float znear,
                         float zfar, const float* gpose, float* g_w2c,
                         void* cuda_stream) {
  if (width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  pose_vectors_bwd_kernel<<<1, 1, 0, (cudaStream_t)cuda_stream>>>(
      fx, fy, cx, cy, width, height, znear, zfar, gpose, g_w2c);
  return (int)cudaGetLastError();
}

// g6, m6, v6, upd6 6 floats; g2, m2, v2, ab 2 floats; norm one float.
int gsl_refine_adam(const float* g6, const float* g2, float* m6, float* v6,
                    float* m2, float* v2, float* ab, float* upd6, float* norm,
                    float b1, float omb1, float b2, float omb2, float eps,
                    float lr, float bc1, float bc2, void* cuda_stream) {
  refine_adam_kernel<<<1, 1, 0, (cudaStream_t)cuda_stream>>>(
      g6, g2, m6, v6, m2, v2, ab, upd6, norm, b1, omb1, b2, omb2, eps, lr,
      bc1, bc2);
  return (int)cudaGetLastError();
}

}  // extern "C"
