// The preprocess's arithmetic shared by its forward (preprocess_fwd.cu)
// and its backward (preprocess_bwd.cu): each step rounded once, as the
// torch path's separate elementwise kernels round it (__fadd_rn and its
// kin are never contracted into an FMA), the two matrix products in
// cuBLAS's order, torch's sums over a contiguous axis of 3 and of 4, and
// ops/sh.py's basis, and the covariances (tf.build_cov3d,
// tf.compute_cov2d) from them.  The backward recomputes with these the
// forward's values, so that it decides as the forward did where it
// decides again (the clamp of the view point, the two norms' maxima) and
// differentiates at the forward's own values.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 12;  // 16-byte words of a 16-coefficient row

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

// torch.maximum / torch.minimum / clamp: a NaN operand gives NaN
__device__ __forceinline__ float maxn(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minn(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clampn(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch's sums over a contiguous axis of 3 and of 4
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, c), b);
}
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return add(add(a, c), add(b, d));
}

// (p, 1) @ M[:, col]: the product chained as cuBLAS chains it, then the
// translation row added
__device__ __forceinline__ float affine(const float* m, int col, float x,
                                        float y, float z) {
  const float acc = fmaf(z, __ldg(m + 8 + col),
                         fmaf(y, __ldg(m + 4 + col), mul(x, __ldg(m + col))));
  return add(acc, __ldg(m + 12 + col));
}

// 16-byte words of coefficients a row of degree `deg` needs (C = 16)
__device__ __forceinline__ int words_needed(int deg) {
  const int n = deg < 0 ? 0 : (deg >= 3 ? 16 : (deg + 1) * (deg + 1));
  return (3 * n + 3) / 4;
}

// ops/sh.py:sh_basis at the unit direction (x, y, z)
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  const float c0 = 0.28209479177387814f, c1 = 0.4886025119029199f;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[0] = c0;
  b[1] = -c1 * y;
  b[2] = c1 * z;
  b[3] = -c1 * x;
  b[4] = 1.0925484305920792f * xy;
  b[5] = -1.0925484305920792f * yz;
  b[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  b[7] = -1.0925484305920792f * xz;
  b[8] = 0.5462742152960396f * (xx - yy);
  b[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  b[10] = 2.890611442640554f * xy * z;
  b[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  b[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  b[14] = 1.445305721320277f * z * (xx - yy);
  b[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
}

// tf.build_cov3d: M = R(q / max(|q|, eps)) diag(s), s = modifier *
// exp(log-scales), Sigma = M M^T (its six products)
struct Cov3d {
  float q[4];      // the raw quaternion (r, x, y, z)
  float qn;        // |q|, before the maximum with eps
  float R[3][3];   // the rotation of the unit quaternion
  float e[3];      // exp(log-scales)
  float s[3];      // modifier * e
  float M[3][3];   // R diag(s)
  float S[3][3];   // Sigma
};

__device__ __forceinline__ void build_cov3d(const float* rot,
                                            const float* log_scales,
                                            float modifier, Cov3d& o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = __ldg(rot + k);
  o.qn = root(sum4(mul(o.q[0], o.q[0]), mul(o.q[1], o.q[1]),
                   mul(o.q[2], o.q[2]), mul(o.q[3], o.q[3])));
  const float qm = maxn(o.qn, 1e-12f);
  const float r = dvd(o.q[0], qm), x = dvd(o.q[1], qm), y = dvd(o.q[2], qm),
              z = dvd(o.q[3], qm);
  float(&R)[3][3] = o.R;
  R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  R[0][1] = mul(2.0f, sub(mul(x, y), mul(r, z)));
  R[0][2] = mul(2.0f, add(mul(x, z), mul(r, y)));
  R[1][0] = mul(2.0f, add(mul(x, y), mul(r, z)));
  R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  R[1][2] = mul(2.0f, sub(mul(y, z), mul(r, x)));
  R[2][0] = mul(2.0f, sub(mul(x, z), mul(r, y)));
  R[2][1] = mul(2.0f, add(mul(y, z), mul(r, x)));
  R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.e[c] = expf(__ldg(log_scales + c));
    o.s[c] = mul(modifier, o.e[c]);
  }
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int c = 0; c < 3; ++c) o.M[rr][c] = mul(R[rr][c], o.s[c]);
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = u; v < 3; ++v) {
      o.S[u][v] = sum3(mul(o.M[u][0], o.M[v][0]), mul(o.M[u][1], o.M[v][1]),
                       mul(o.M[u][2], o.M[v][2]));
      o.S[v][u] = o.S[u][v];
    }
}

// tf.compute_cov2d at the view point (sx, sy, sz): s / sz clamped to
// +-lim, the EWA Jacobian's rows U0, U1 (Wp = viewmatrix[:3, :3].T),
// Sigma U0, Sigma U1 and the 2D covariance with its 0.3 low-pass
struct Cov2d {
  float ux, uy;        // sx / sz, sy / sz
  float cx, cy;        // ... clamped
  float tx, ty;        // ... times sz
  float inv_tz, inv_tz2;
  float U0[3], U1[3], SU0[3], SU1[3];
  float c0, c1, c2;    // cov_xx, cov_xy, cov_yy
};

__device__ __forceinline__ void compute_cov2d(const float* V, float sx,
                                              float sy, float sz,
                                              float focal_x, float focal_y,
                                              float limx, float limy,
                                              const float (&S)[3][3],
                                              Cov2d& o) {
  o.ux = dvd(sx, sz);
  o.uy = dvd(sy, sz);
  o.cx = minn(maxn(o.ux, -limx), limx);
  o.cy = minn(maxn(o.uy, -limy), limy);
  o.tx = mul(o.cx, sz);
  o.ty = mul(o.cy, sz);
  o.inv_tz = dvd(1.0f, sz);
  o.inv_tz2 = mul(o.inv_tz, o.inv_tz);
  const float J00 = mul(focal_x, o.inv_tz);
  const float J02 = mul(mul(-focal_x, o.tx), o.inv_tz2);
  const float J11 = mul(focal_y, o.inv_tz);
  const float J12 = mul(mul(-focal_y, o.ty), o.inv_tz2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.U0[c] = add(mul(J00, __ldg(V + 4 * c)), mul(J02, __ldg(V + 4 * c + 2)));
    o.U1[c] = add(mul(J11, __ldg(V + 4 * c + 1)),
                  mul(J12, __ldg(V + 4 * c + 2)));
  }
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    o.SU0[rr] = sum3(mul(S[rr][0], o.U0[0]), mul(S[rr][1], o.U0[1]),
                     mul(S[rr][2], o.U0[2]));
    o.SU1[rr] = sum3(mul(S[rr][0], o.U1[0]), mul(S[rr][1], o.U1[1]),
                     mul(S[rr][2], o.U1[2]));
  }
  o.c0 = add(sum3(mul(o.U0[0], o.SU0[0]), mul(o.U0[1], o.SU0[1]),
                  mul(o.U0[2], o.SU0[2])), 0.3f);
  o.c1 = sum3(mul(o.U0[0], o.SU1[0]), mul(o.U0[1], o.SU1[1]),
              mul(o.U0[2], o.SU1[2]));
  o.c2 = add(sum3(mul(o.U1[0], o.SU1[0]), mul(o.U1[1], o.SU1[1]),
                  mul(o.U1[2], o.SU1[2])), 0.3f);
}

}  // namespace
