// The backward of the training preprocess in one pass, for Hopper
// (sm_90a): the VJP of ops/preprocess.py:preprocess_torch (colours from
// SH) that ops/preprocess.py:PreprocessFunction runs on a card.
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// preprocess by autodiff.  It replaces autograd through the port's torch
// ops (ops/preprocess.py, ops/transforms.py, ops/sh.py): some sixty
// launches, each reading and writing (P,) to (P, 16, 3) intermediates
// that the forward kept for it.  Here one thread owns one row and keeps
// every intermediate in registers; nothing but the gradients goes to
// device memory.  Its plain twin, the same chain rule in torch ops, is
// ops/preprocess.py:preprocess_vjp_plain.
//
// Per row it reads the raw inputs (xyz, log-scales, quaternion, raw
// opacity, degree, alive flag), the saved radius and depth, and the
// incoming gradients of means2d, the conic, the opacity and the colour
// (each through its own row and column strides: autograd hands them as
// columns of the reduction's feature-major sums, which consecutive
// threads then read at consecutive addresses); a valid row also reads
// its saved conic and unclamped colour and the coefficients its degree
// keeps.  It
// writes the gradients of xyz, the log-scales, the quaternion, the raw
// opacity and the whole SH row (zeros past the row's degree and on rows
// that are not valid).  The screen offset's gradient is the incoming
// means2d gradient itself (ops/preprocess.py): no byte here.  Bound by
// those bytes: ~0.5 KB a row, ~1 flop a byte.
//
// The chain rule, row by row, as autograd runs it through the torch ops:
// means2d = ndc2pix(p_hom[:2] / (h3 + 1e-7)) into xyz through the
// projection (every row: culled rows keep p_w = 1); on valid rows the
// conic's inverse of the EWA covariance into the Jacobian, the clamped
// view point, R(q / |q|) and exp(log-scales) (the 0.3 low-pass a
// constant); the opacity's sigmoid; the degree-masked SH colour into
// its coefficients and, through the normalised view direction, into xyz.
// A tie of max / min gives each side half the gradient (jnp's rule,
// torch.maximum's).  Gradient arithmetic may contract and associate as
// it likes: it feeds no rounding to an integer.  No atomics but the
// counter's, so two launches give the same bits.
//
// The forward's discrete branches, each taken as the forward took it:
//   validity (radius > 0, the conic's and colour's `* validf`, the
//     opacity's `where(valid, ...)`, and det_inv's guard: a valid row has
//     det != 0) -- read from the saved radii; no determinant is formed
//     again: the conic's gradient is taken at the saved conic (dC = -K dK
//     K), since a covariance within rounding of singular could give a
//     determinant of 0 here and a finite one in the forward;
//   the near-plane cull and the alive mask (`where(live, ...)` of p_w
//     and of the view point) -- read from the saved depths and the mask;
//   the colour's clamp max(rgb, 0) -- read from the saved rgb's sign (a
//     recomputed colour near 0 could take the other branch);
//   the clamp of t / tz to +-1.3 tan_fov and the `eps` maxima of the
//     quaternion's and the view direction's norms -- recomputed with the
//     forward's arithmetic (preprocess_math.cuh: cuBLAS's FMA chain for
//     the view point, torch's sums of 3 and 4, each step rounded once),
//     tz taken from the saved depths.
//
// Layout: one thread a row, kBlock rows a block.  A 16-coefficient row
// on a 16-byte boundary moves in 16-byte words by its own thread (the
// words its degree keeps are read, all twelve are written); other rows
// a float at a time.  `visible` (a zeroed int32) gains the count of
// valid rows, one atomicAdd per block: the device counter
// "preprocess_bwd".

#include <cuda_runtime.h>

#include <cstdint>

#include "preprocess_math.cuh"

namespace {

constexpr int kBlock = 128;

struct Grad {  // an incoming gradient: null for zero, strides in floats
  const float* p;
  long long row, col;
  __device__ __forceinline__ float at(int i, int c) const {
    return p == nullptr ? 0.0f : p[i * row + c * col];
  }
};

struct Args {
  const float* xyz;        // (P, 3)
  const float* scales;     // (P, 3) log-scales
  const float* rotations;  // (P, 4) unnormalised quaternions (r, x, y, z)
  const float* opacities;  // (P,) raw
  const float* sh;         // (P, C, 3)
  const int* degrees;      // (P,)
  const bool* alive;       // (P,) or null
  const int* radii;        // (P,) saved: valid = radius > 0
  const float* depths;     // (P,) saved: view z
  const float* rgb;        // (P, 3) saved: the colour before its clamp
  const float* conic;      // (P, 3) saved: the inverse 2D covariance
  const float* viewmatrix;  // (4, 4) transposed world -> view
  const float* projmatrix;  // (4, 4) transposed full projection
  const float* campos;      // (3,)
  const float* tan_fovx;    // ()
  const float* tan_fovy;    // ()
  int p, coeffs, width, height;
  float scale_modifier;
  bool sh_words;  // sh and d_sh rows of 16 coefficients, 16-byte aligned
  Grad g_means2d, g_conic, g_opacity, g_color;
  float* d_xyz;      // (P, 3)
  float* d_scales;   // (P, 3)
  float* d_rot;      // (P, 4)
  float* d_opacity;  // (P,)
  float* d_sh;       // (P, C, 3)
  int* visible;      // ()
};

// the share of d max(a, b) that goes to a
__device__ __forceinline__ float tie(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// ops/sh.py:sh_basis_vjp: the direction's cotangent from the basis's
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* g, float* d) {
  const float c1 = 0.4886025119029199f;
  const float c20 = 1.0925484305920792f, c21 = -1.0925484305920792f,
              c22 = 0.31539156525252005f, c23 = -1.0925484305920792f,
              c24 = 0.5462742152960396f;
  const float c30 = -0.5900435899266435f, c31 = 2.890611442640554f,
              c32 = -0.4570457994644658f, c33 = 0.3731763325901154f,
              c34 = -0.4570457994644658f, c35 = 1.445305721320277f,
              c36 = -0.5900435899266435f;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  d[0] = -c1 * g[3] + c20 * y * g[4] - 2.0f * c22 * x * g[6] +
         c23 * z * g[7] + 2.0f * c24 * x * g[8] + 6.0f * c30 * xy * g[9] +
         c31 * yz * g[10] - 2.0f * c32 * xy * g[11] -
         6.0f * c33 * xz * g[12] + c34 * (4.0f * zz - 3.0f * xx - yy) * g[13] +
         2.0f * c35 * xz * g[14] + 3.0f * c36 * (xx - yy) * g[15];
  d[1] = -c1 * g[1] + c20 * x * g[4] + c21 * z * g[5] -
         2.0f * c22 * y * g[6] - 2.0f * c24 * y * g[8] +
         3.0f * c30 * (xx - yy) * g[9] + c31 * xz * g[10] +
         c32 * (4.0f * zz - xx - 3.0f * yy) * g[11] - 6.0f * c33 * yz * g[12] -
         2.0f * c34 * xy * g[13] - 2.0f * c35 * yz * g[14] -
         6.0f * c36 * xy * g[15];
  d[2] = c1 * g[2] + c21 * y * g[5] + 4.0f * c22 * z * g[6] +
         c23 * x * g[7] + c31 * xy * g[10] + 8.0f * c32 * yz * g[11] +
         c33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g[12] +
         8.0f * c34 * xz * g[13] + c35 * (xx - yy) * g[14];
}

// tf.normalize(v, eps)'s VJP: g / m - v (g . v) w / (m^2 n), with n = |v|
// (torch's sum of 3 or 4 for the branch), m = max(n, eps), w = tie(n, eps)
template <int N>
__device__ __forceinline__ void normalize_vjp(const float* v, const float* g,
                                              float n, float eps, float* d) {
  const float m = maxn(n, eps), w = tie(n, eps);
  float gv = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) gv += g[k] * v[k];
  const float s = w > 0.0f ? -gv * w / (m * m * n) : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = g[k] / m + s * v[k];
}

// the gradients of one valid row's conic, opacity and colour, into the
// quaternion, the log-scales, the raw opacity, xyz (dx, added) and the
// coefficients the degree keeps (dsh rows written by the caller from
// b and g_rgb)
__device__ __forceinline__ void valid_row(const Args& a, int i, float px,
                                          float py, float pz, float* dx,
                                          float* ds, float* dq, float& dop,
                                          float* b, float* g_rgb, int n) {
  const float* V = a.viewmatrix;
  const float tanx = __ldg(a.tan_fovx), tany = __ldg(a.tan_fovy);
  const float fx = mul(dvd(1.0f, mul(2.0f, tanx)),
                       static_cast<float>(a.width));
  const float fy = mul(dvd(1.0f, mul(2.0f, tany)),
                       static_cast<float>(a.height));
  const float limx = mul(1.3f, tanx), limy = mul(1.3f, tany);

  // the forward's values, with its arithmetic: M = R diag(s), Sigma, the
  // view point clamped to +-1.3 tan_fov (tz the saved depth), the EWA
  // Jacobian's rows U0, U1 and the 2D covariance
  Cov3d c3;
  build_cov3d(a.rotations + 4 * i, a.scales + 3 * i, a.scale_modifier, c3);
  const float(&R)[3][3] = c3.R;
  const float(&M)[3][3] = c3.M;
  const float(&S)[3][3] = c3.S;
  const float t0 = affine(V, 0, px, py, pz);
  const float t1 = affine(V, 1, px, py, pz);
  const float tz = __ldg(a.depths + i);
  Cov2d cv;
  compute_cov2d(V, t0, t1, tz, fx, fy, limx, limy, S, cv);
  const float wx = tie(cv.ux, -limx) * tie(limx, maxn(cv.ux, -limx));
  const float wy = tie(cv.uy, -limy) * tie(limy, maxn(cv.uy, -limy));
  const float cx = cv.cx, cy = cv.cy, tx = cv.tx, ty = cv.ty;
  const float inv_tz = cv.inv_tz, inv_tz2 = cv.inv_tz2;
  const float(&U0)[3] = cv.U0;
  const float(&U1)[3] = cv.U1;
  const float(&SU0)[3] = cv.SU0;
  const float(&SU1)[3] = cv.SU1;

  // the conic K = C^-1 of C = [[c0, c1], [c1, c2]]: dC = -K dK K, K the
  // forward's own conic
  const float g0 = a.g_conic.at(i, 0), g1 = a.g_conic.at(i, 1),
              g2 = a.g_conic.at(i, 2);
  const float k0 = __ldg(a.conic + 3 * i), k1 = __ldg(a.conic + 3 * i + 1),
              k2 = __ldg(a.conic + 3 * i + 2);
  const float dc0 = -(g0 * k0 * k0 + g1 * k0 * k1 + g2 * k1 * k1);
  const float dc1 = -(2.0f * g0 * k0 * k1 + g1 * (k0 * k2 + k1 * k1) +
                      2.0f * g2 * k1 * k2);
  const float dc2 = -(g0 * k1 * k1 + g1 * k1 * k2 + g2 * k2 * k2);

  // the covariance's quadratic forms into U0, U1 and Sigma
  float dSU0[3], dSU1[3], dU0[3], dU1[3];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    dSU0[u] = dc0 * U0[u];
    dSU1[u] = dc1 * U0[u] + dc2 * U1[u];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dU0[c] = dc0 * SU0[c] + dc1 * SU1[c] + S[c][0] * dSU0[0] +
             S[c][1] * dSU0[1] + S[c][2] * dSU0[2];
    dU1[c] = dc2 * SU1[c] + S[c][0] * dSU1[0] + S[c][1] * dSU1[1] +
             S[c][2] * dSU1[2];
  }
  // Sigma = M M^T: dM = (dSigma + dSigma^T) M
  float G[3][3];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = u; v < 3; ++v) {
      G[u][v] = dSU0[u] * U0[v] + dSU1[u] * U1[v] + dSU0[v] * U0[u] +
                dSU1[v] * U1[u];
      G[v][u] = G[u][v];
    }
  float dR[3][3], dsc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dM = G[u][0] * M[0][c] + G[u][1] * M[1][c] +
                       G[u][2] * M[2][c];
      dR[u][c] = dM * c3.s[c];
      dsc[c] += dM * R[u][c];
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) ds[c] = dsc[c] * a.scale_modifier * c3.e[c];

  // quat_to_rotmat at the unit quaternion (r, x, y, z), then normalize
  const float qm = maxn(c3.qn, 1e-12f);
  const float r = dvd(c3.q[0], qm), x = dvd(c3.q[1], qm),
              y = dvd(c3.q[2], qm), z = dvd(c3.q[3], qm);
  const float dqn[4] = {
      2.0f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] -
              y * dR[2][0] + x * dR[2][1]),
      2.0f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] -
              2.0f * x * dR[1][1] - r * dR[1][2] + z * dR[2][0] +
              r * dR[2][1] - 2.0f * x * dR[2][2]),
      2.0f * (-2.0f * y * dR[0][0] + x * dR[0][1] + r * dR[0][2] +
              x * dR[1][0] + z * dR[1][2] - r * dR[2][0] + z * dR[2][1] -
              2.0f * y * dR[2][2]),
      2.0f * (-2.0f * z * dR[0][0] - r * dR[0][1] + x * dR[0][2] +
              r * dR[1][0] - 2.0f * z * dR[1][1] + y * dR[1][2] +
              x * dR[2][0] + y * dR[2][1])};
  normalize_vjp<4>(c3.q, dqn, c3.qn, 1e-12f, dq);

  // the Jacobian, the clamp, the view point into xyz
  const float dJ00 = dU0[0] * __ldg(V) + dU0[1] * __ldg(V + 4) +
                     dU0[2] * __ldg(V + 8);
  const float dJ02 = dU0[0] * __ldg(V + 2) + dU0[1] * __ldg(V + 6) +
                     dU0[2] * __ldg(V + 10);
  const float dJ11 = dU1[0] * __ldg(V + 1) + dU1[1] * __ldg(V + 5) +
                     dU1[2] * __ldg(V + 9);
  const float dJ12 = dU1[0] * __ldg(V + 2) + dU1[1] * __ldg(V + 6) +
                     dU1[2] * __ldg(V + 10);
  const float dtx = -dJ02 * fx * inv_tz2, dty = -dJ12 * fy * inv_tz2;
  const float dinv = dJ00 * fx + dJ11 * fy -
                     2.0f * inv_tz * (dJ02 * fx * tx + dJ12 * fy * ty);
  const float dux = dtx * tz * wx, duy = dty * tz * wy;
  const float dt[3] = {dux / tz, duy / tz,
                       -dinv * inv_tz * inv_tz + dtx * cx + dty * cy -
                           (dux * t0 + duy * t1) / (tz * tz)};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dx[k] += dt[0] * __ldg(V + 4 * k) + dt[1] * __ldg(V + 4 * k + 1) +
             dt[2] * __ldg(V + 4 * k + 2);

  // sigmoid opacity: 1 / (1 + e), e = exp(-o)
  const float eo = expf(-__ldg(a.opacities + i));
  const float op = 1.0f / (1.0f + eo);
  dop = a.g_opacity.at(i, 0) * op * op * eo;

  // the colour: its clamp's branch from the saved rgb, the basis at the
  // normalised view direction
  const float v[3] = {sub(px, __ldg(a.campos)), sub(py, __ldg(a.campos + 1)),
                      sub(pz, __ldg(a.campos + 2))};
  const float vn = root(sum3(mul(v[0], v[0]), mul(v[1], v[1]),
                             mul(v[2], v[2])));
  const float vm = maxn(vn, 1e-12f);
  const float dir[3] = {dvd(v[0], vm), dvd(v[1], vm), dvd(v[2], vm)};
  sh_basis(dir[0], dir[1], dir[2], b);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    g_rgb[c] = a.g_color.at(i, c) * tie(__ldg(a.rgb + 3 * i + c), 0.0f);

  // dbasis_k = sum_c sh[k][c] g_rgb[c] over the kept coefficients
  float db[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) db[k] = 0.0f;
  if (a.sh_words) {
    const float4* row = reinterpret_cast<const float4*>(a.sh) +
                        static_cast<size_t>(i) * kRowWords;
    const int need = (3 * n + 3) / 4;
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) {
      if (w < need) {
        const float4 v4 = __ldg(row + w);
        const float f4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 4 * w + j;
          if (f / 3 < n) db[f / 3] += f4[j] * g_rgb[f % 3];
        }
      }
    }
  } else {
    const float* row = a.sh + static_cast<size_t>(i) * a.coeffs * 3;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n)
        db[k] = __ldg(row + 3 * k) * g_rgb[0] +
                __ldg(row + 3 * k + 1) * g_rgb[1] +
                __ldg(row + 3 * k + 2) * g_rgb[2];
  }
  float ddir[3], dv[3];
  sh_basis_vjp(dir[0], dir[1], dir[2], db, ddir);
  normalize_vjp<3>(v, ddir, vn, 1e-12f, dv);
#pragma unroll
  for (int k = 0; k < 3; ++k) dx[k] += dv[k];
}

__global__ void __launch_bounds__(kBlock)
    preprocess_bwd_kernel(const Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < a.p;
  bool valid = false;
  int n = 0;  // coefficients the row's degree keeps
  float b[16], g_rgb[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    const float px = __ldg(a.xyz + 3 * i), py = __ldg(a.xyz + 3 * i + 1),
                pz = __ldg(a.xyz + 3 * i + 2);
    const bool live = __ldg(a.depths + i) > 0.2f &&
                      (a.alive == nullptr || a.alive[i]);
    valid = __ldg(a.radii + i) > 0;

    // means2d = ((h * p_w + 1) * size - 1) / 2 for h = h0, h1
    const float* Pm = a.projmatrix;
    const float h0 = affine(Pm, 0, px, py, pz);
    const float h1 = affine(Pm, 1, px, py, pz);
    const float h3 = affine(Pm, 3, px, py, pz);
    const float pw = dvd(1.0f, live ? add(h3, 1e-7f) : 1.0f);
    const float dpx = a.g_means2d.at(i, 0) * 0.5f * a.width;
    const float dpy = a.g_means2d.at(i, 1) * 0.5f * a.height;
    const float dh0 = dpx * pw, dh1 = dpy * pw;
    const float dh3 = live ? -(dpx * h0 + dpy * h1) * pw * pw : 0.0f;
    float dx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dx[k] = dh0 * __ldg(Pm + 4 * k) + dh1 * __ldg(Pm + 4 * k + 1) +
              dh3 * __ldg(Pm + 4 * k + 3);

    float ds[3] = {0.0f, 0.0f, 0.0f}, dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dop = 0.0f;
    if (valid) {
      const int deg = __ldg(a.degrees + i);
      n = deg < 0 ? 0 : min(a.coeffs, deg >= 3 ? 16 : (deg + 1) * (deg + 1));
      valid_row(a, i, px, py, pz, dx, ds, dq, dop, b, g_rgb, n);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.d_xyz[3 * i + k] = dx[k];
      a.d_scales[3 * i + k] = ds[k];
    }
    reinterpret_cast<float4*>(a.d_rot)[i] =
        make_float4(dq[0], dq[1], dq[2], dq[3]);
    a.d_opacity[i] = dop;
  }

  const int block_valid = __syncthreads_count(valid);
  if (threadIdx.x == 0 && block_valid > 0)
    atomicAdd(a.visible, block_valid);
  if (!in) return;

  // the SH row: b_k g_rgb on the kept coefficients, zeros elsewhere
  if (a.sh_words) {
    float4* row = reinterpret_cast<float4*>(a.d_sh) +
                  static_cast<size_t>(i) * kRowWords;
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) {
      float f4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * w + j;
        f4[j] = f / 3 < n ? b[f / 3] * g_rgb[f % 3] : 0.0f;
      }
      row[w] = make_float4(f4[0], f4[1], f4[2], f4[3]);
    }
  } else {
    float* row = a.d_sh + static_cast<size_t>(i) * a.coeffs * 3;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < a.coeffs)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          row[3 * k + c] = k < n ? b[k] * g_rgb[c] : 0.0f;
  }
}

}  // namespace

extern "C" int preprocess_bwd_launch(
    const void* xyz, const void* scales, const void* rotations,
    const void* opacities, const void* sh, int coeffs, const void* degrees,
    const void* alive, const void* radii, const void* depths,
    const void* rgb, const void* conic, const void* viewmatrix, const void* projmatrix,
    const void* campos, const void* tan_fovx, const void* tan_fovy, int p,
    int width, int height, float scale_modifier, const void* g_means2d,
    long long gm_row, long long gm_col, const void* g_conic,
    long long gc_row, long long gc_col, const void* g_opacity,
    long long go_row, const void* g_color, long long gk_row,
    long long gk_col, void* d_xyz, void* d_scales, void* d_rot,
    void* d_opacity, void* d_sh, void* visible, void* stream) {
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.xyz = static_cast<const float*>(xyz);
  a.scales = static_cast<const float*>(scales);
  a.rotations = static_cast<const float*>(rotations);
  a.opacities = static_cast<const float*>(opacities);
  a.sh = static_cast<const float*>(sh);
  a.degrees = static_cast<const int*>(degrees);
  a.alive = static_cast<const bool*>(alive);
  a.radii = static_cast<const int*>(radii);
  a.depths = static_cast<const float*>(depths);
  a.rgb = static_cast<const float*>(rgb);
  a.conic = static_cast<const float*>(conic);
  a.viewmatrix = static_cast<const float*>(viewmatrix);
  a.projmatrix = static_cast<const float*>(projmatrix);
  a.campos = static_cast<const float*>(campos);
  a.tan_fovx = static_cast<const float*>(tan_fovx);
  a.tan_fovy = static_cast<const float*>(tan_fovy);
  a.p = p;
  a.coeffs = coeffs;
  a.width = width;
  a.height = height;
  a.scale_modifier = scale_modifier;
  a.sh_words = coeffs == 16 && reinterpret_cast<uintptr_t>(sh) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(d_sh) % 16 == 0;
  a.g_means2d = {static_cast<const float*>(g_means2d), gm_row, gm_col};
  a.g_conic = {static_cast<const float*>(g_conic), gc_row, gc_col};
  a.g_opacity = {static_cast<const float*>(g_opacity), go_row, 0};
  a.g_color = {static_cast<const float*>(g_color), gk_row, gk_col};
  a.d_xyz = static_cast<float*>(d_xyz);
  a.d_scales = static_cast<float*>(d_scales);
  a.d_rot = static_cast<float*>(d_rot);
  a.d_opacity = static_cast<float*>(d_opacity);
  a.d_sh = static_cast<float*>(d_sh);
  a.visible = static_cast<int*>(visible);
  const int blocks = (p + kBlock - 1) / kBlock;
  preprocess_bwd_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
