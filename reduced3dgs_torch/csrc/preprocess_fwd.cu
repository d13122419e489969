// The forward of ops/preprocess.py:preprocess in one pass, for Hopper
// (sm_90a): the preprocess of every render that asks for no gradient.
//
// Replaces no TPU kernel: the JAX package's preprocess is plain jnp, and
// the port's torch ops (ops/preprocess.py, ops/transforms.py, ops/sh.py)
// stay the differentiable path and the CPU's.  Those ops make some sixty
// launches, each reading and writing (P,) to (P, 16, 3) intermediates in
// device memory; here one thread owns one primitive and keeps every
// intermediate (the quaternion's rotation, the 3D and 2D covariances,
// the 16 SH basis values) in registers.  Per row it reads the parameters,
// the degree and the alive flag (49 B), and for the rows that survive the
// cull the (d + 1)^2 SH coefficients its degree keeps (at most 192 B); it
// writes the 64 B of PreprocessOut.  Bound by those bytes.
//
// Outputs, as the torch path gives them, for every row: means2d, depths,
// the conic, the activated opacity, the colour (the degree-masked SH
// colour + 0.5, clamped at 0, or color_precomp), the 3-sigma radius, the
// tight binning rect (rect_min / rect_max, computed for culled rows too)
// and tiles_touched; conic, opacity, colour and radius are zero where the
// row is not valid (culled by depth, the alive mask, det == 0 or an empty
// square rect).  `visible` (a zeroed int32) gains the count of valid rows,
// one atomicAdd per block.
//
// Arithmetic: the torch path's formulas in its order of operations, each
// step rounded once as its separate elementwise kernel rounds it
// (__fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn are never contracted
// into an FMA), so the values that feed a ceil or a truncation -- the
// radius and the tile rects -- round as the torch path's do.  The two
// matrix products are cuBLAS's order (k = 0, 1, 2 as a chain of FMAs from
// the first product, then the translation row added); a sum over a
// contiguous axis of 3 is torch's (x0 + x2) + x1, of 4 (x0 + x2) + (x1 +
// x3) (two threads of its reduction kernel, each with its strided share).  The SH colour may
// contract and sums in coefficient order: it feeds no rounding.
//
// The camera is read through device pointers (viewmatrix, projmatrix,
// campos, tan_fov*): a graph that builds its camera on the device replays
// with each new pose.  Only the image size and scale_modifier are fixed
// at launch.  No allocation, no host synchronisation: capturable.
//
// A 16-coefficient row (192 B, twelve 16-byte words) on a 16-byte
// boundary is read with 16-byte loads by its own thread, only the words
// its degree keeps; rows of other widths, or unaligned ones, a float at
// a time.  (A block-staged copy through shared memory, consecutive
// threads reading consecutive words, measured slower on an H100: 0.4177
// against 0.3570 ms at 2^22 rows of degree 3.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 16;
constexpr int kRowWords = 12;  // 16-byte words of a 16-coefficient row

struct Args {
  const float* xyz;        // (P, 3)
  const float* scales;     // (P, 3) log-scales
  const float* rotations;  // (P, 4) unnormalised quaternions (r, x, y, z)
  const float* opacities;  // (P,) raw
  const float* sh;         // (P, C, 3)
  const int* degrees;      // (P,)
  const bool* alive;       // (P,) or null
  const float* color_precomp;  // (P, 3) or null
  const float* viewmatrix;     // (4, 4) transposed world -> view
  const float* projmatrix;     // (4, 4) transposed full projection
  const float* campos;         // (3,)
  const float* tan_fovx;       // ()
  const float* tan_fovy;       // ()
  int p, coeffs, width, height;
  float scale_modifier;
  bool sh_words;  // rows of 16 coefficients on 16-byte boundaries
  float* means2d;  // (P, 2)
  float* depths;   // (P,)
  float* conic;    // (P, 3)
  float* opacity;  // (P,)
  float* color;    // (P, 3)
  int* radii;      // (P,)
  int* rect_min;   // (P, 2)
  int* rect_max;   // (P, 2)
  int* tiles;      // (P,)
  int* visible;    // ()
};

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

// ops/preprocess.py:_tile_index: clamp into [-1, grid + 1], truncate
// (a NaN converts to 0, as the torch path's cast does), clip to the grid
__device__ __forceinline__ int tile_index(float v, int grid) {
  const int t = static_cast<int>(clampn(v, -1.0f, grid + 1.0f));
  return min(max(t, 0), grid);
}

struct Rect {
  int x0, y0, x1, y1;
};

// ops/preprocess.py:get_rect: (x - r) / 16 and (x + r + 16 - 1) / 16
__device__ __forceinline__ Rect get_rect(float mx, float my, float rx,
                                         float ry, int gx, int gy) {
  const float inv = 1.0f / kTile;  // exact: the torch path's scalar divide
  Rect r;
  r.x0 = tile_index(mul(sub(mx, rx), inv), gx);
  r.y0 = tile_index(mul(sub(my, ry), inv), gy);
  r.x1 = tile_index(mul(sub(add(add(mx, rx), 16.0f), 1.0f), inv), gx);
  r.y1 = tile_index(mul(sub(add(add(my, ry), 16.0f), 1.0f), inv), gy);
  return r;
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

// colour += the coefficients of the row's 16-byte word w (floats 4w ..
// 4w + 3 of the row: coefficient f / 3, channel f % 3), those below n
// only; w is a constant once the caller's loop is unrolled
__device__ __forceinline__ void add_word(const float4 v, int w,
                                         const float* b, int n, float* col) {
  const float f4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = 4 * w + j;
    if (f / 3 < n) col[f % 3] = fmaf(b[f / 3], f4[j], col[f % 3]);
  }
}

__global__ void __launch_bounds__(kBlock)
    preprocess_fwd_kernel(const Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < a.p;
  const float* V = a.viewmatrix;
  const float* Pm = a.projmatrix;
  const int gx = (a.width + kTile - 1) / kTile;
  const int gy = (a.height + kTile - 1) / kTile;
  const float tanx = __ldg(a.tan_fovx), tany = __ldg(a.tan_fovy);
  // focal = width / (2 tan): the reciprocal, then the product
  const float focal_x = mul(dvd(1.0f, mul(2.0f, tanx)),
                            static_cast<float>(a.width));
  const float focal_y = mul(dvd(1.0f, mul(2.0f, tany)),
                            static_cast<float>(a.height));
  const float limx = mul(1.3f, tanx), limy = mul(1.3f, tany);

  bool valid = false;
  int deg = 0;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (in) {
    px = __ldg(a.xyz + 3 * i);
    py = __ldg(a.xyz + 3 * i + 1);
    pz = __ldg(a.xyz + 3 * i + 2);
    deg = __ldg(a.degrees + i);

    // frustum cull: view z > 0.2, and the alive mask
    const float t0 = affine(V, 0, px, py, pz);
    const float t1 = affine(V, 1, px, py, pz);
    const float depth = affine(V, 2, px, py, pz);
    const bool live =
        depth > 0.2f && (a.alive == nullptr || a.alive[i]);
    // culled rows take the substitute point (0, 0, 1)
    const float sx = live ? t0 : 0.0f, sy = live ? t1 : 0.0f;
    const float sz = live ? depth : 1.0f;

    // projection to pixels
    const float h0 = affine(Pm, 0, px, py, pz);
    const float h1 = affine(Pm, 1, px, py, pz);
    const float h3 = affine(Pm, 3, px, py, pz);
    const float pw = dvd(1.0f, live ? add(h3, 1e-7f) : 1.0f);
    const float mx = mul(sub(mul(add(mul(h0, pw), 1.0f),
                                 static_cast<float>(a.width)), 1.0f), 0.5f);
    const float my = mul(sub(mul(add(mul(h1, pw), 1.0f),
                                 static_cast<float>(a.height)), 1.0f), 0.5f);

    // build_cov3d: R(q / |q|) diag(s * modifier), the six products
    const float4 q4 = make_float4(__ldg(a.rotations + 4 * i),
                                  __ldg(a.rotations + 4 * i + 1),
                                  __ldg(a.rotations + 4 * i + 2),
                                  __ldg(a.rotations + 4 * i + 3));
    const float qn = maxn(root(sum4(mul(q4.x, q4.x), mul(q4.y, q4.y),
                                    mul(q4.z, q4.z), mul(q4.w, q4.w))),
                          1e-12f);
    const float r = dvd(q4.x, qn), x = dvd(q4.y, qn), y = dvd(q4.z, qn),
                z = dvd(q4.w, qn);
    float R[3][3];
    R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
    R[0][1] = mul(2.0f, sub(mul(x, y), mul(r, z)));
    R[0][2] = mul(2.0f, add(mul(x, z), mul(r, y)));
    R[1][0] = mul(2.0f, add(mul(x, y), mul(r, z)));
    R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
    R[1][2] = mul(2.0f, sub(mul(y, z), mul(r, x)));
    R[2][0] = mul(2.0f, sub(mul(x, z), mul(r, y)));
    R[2][1] = mul(2.0f, add(mul(y, z), mul(r, x)));
    R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
    float s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s[c] = mul(a.scale_modifier, expf(__ldg(a.scales + 3 * i + c)));
    float M[3][3];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int c = 0; c < 3; ++c) M[rr][c] = mul(R[rr][c], s[c]);
    float S[3][3];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = u; v < 3; ++v) {
        S[u][v] = sum3(mul(M[u][0], M[v][0]), mul(M[u][1], M[v][1]),
                       mul(M[u][2], M[v][2]));
        S[v][u] = S[u][v];
      }

    // compute_cov2d: the clamped view point, the EWA Jacobian, + 0.3
    const float tx = mul(minn(maxn(dvd(sx, sz), -limx), limx), sz);
    const float ty = mul(minn(maxn(dvd(sy, sz), -limy), limy), sz);
    const float inv_tz = dvd(1.0f, sz);
    const float inv_tz2 = mul(inv_tz, inv_tz);
    const float J00 = mul(focal_x, inv_tz);
    const float J02 = mul(mul(-focal_x, tx), inv_tz2);
    const float J11 = mul(focal_y, inv_tz);
    const float J12 = mul(mul(-focal_y, ty), inv_tz2);
    float U0[3], U1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // Wp = viewmatrix[:3, :3].T
      U0[c] = add(mul(J00, __ldg(V + 4 * c)), mul(J02, __ldg(V + 4 * c + 2)));
      U1[c] = add(mul(J11, __ldg(V + 4 * c + 1)),
                  mul(J12, __ldg(V + 4 * c + 2)));
    }
    float SU0[3], SU1[3];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
      SU0[rr] = sum3(mul(S[rr][0], U0[0]), mul(S[rr][1], U0[1]),
                     mul(S[rr][2], U0[2]));
      SU1[rr] = sum3(mul(S[rr][0], U1[0]), mul(S[rr][1], U1[1]),
                     mul(S[rr][2], U1[2]));
    }
    const float c0 = add(sum3(mul(U0[0], SU0[0]), mul(U0[1], SU0[1]),
                              mul(U0[2], SU0[2])), 0.3f);
    const float c1 = sum3(mul(U0[0], SU1[0]), mul(U0[1], SU1[1]),
                          mul(U0[2], SU1[2]));
    const float c2 = add(sum3(mul(U1[0], SU1[0]), mul(U1[1], SU1[1]),
                              mul(U1[2], SU1[2])), 0.3f);

    // the conic; det == 0 culled
    const float det = sub(mul(c0, c2), mul(c1, c1));
    const bool det_ok = det != 0.0f;
    const float det_inv = det_ok ? dvd(1.0f, det) : 0.0f;

    // 3 sigma of the larger eigenvalue
    const float mid = mul(0.5f, add(c0, c2));
    const float disc = root(maxn(sub(mul(mid, mid), det), 0.1f));
    float rad = ceilf(mul(3.0f, root(maxn(add(mid, disc), 0.0f))));
    rad = live && det_ok ? rad : 0.0f;

    // the square reference rect decides validity
    const Rect ref = get_rect(mx, my, rad, rad, gx, gy);
    valid = live && det_ok && (ref.x1 - ref.x0) * (ref.y1 - ref.y0) > 0;

    // sigmoid opacity; the tight binning rect (binning_extents)
    const float op =
        dvd(1.0f, add(expf(-__ldg(a.opacities + i)), 1.0f));
    const float r2 = clampn(
        mul(2.0f, logf(mul(300.0f, maxn(op, 1e-30f)))), 0.0f, 9.0f);
    const float ext_x = root(mul(r2, maxn(c0, 0.0f)));
    const float ext_y = root(mul(r2, maxn(c2, 0.0f)));
    const bool op_dead = mul(op, 300.0f) < 1.0f;
    const Rect bin = get_rect(mx, my, minn(ext_x, rad), minn(ext_y, rad),
                              gx, gy);
    const int tiles = valid && !op_dead
                          ? (bin.x1 - bin.x0) * (bin.y1 - bin.y0) : 0;

    const float vf = valid ? 1.0f : 0.0f;  // the torch path's `* validf`
    reinterpret_cast<float2*>(a.means2d)[i] = make_float2(mx, my);
    a.depths[i] = depth;
    a.conic[3 * i] = mul(mul(c2, det_inv), vf);
    a.conic[3 * i + 1] = mul(mul(-c1, det_inv), vf);
    a.conic[3 * i + 2] = mul(mul(c0, det_inv), vf);
    a.opacity[i] = valid ? op : 0.0f;
    a.radii[i] = valid ? static_cast<int>(rad) : 0;
    reinterpret_cast<int2*>(a.rect_min)[i] = make_int2(bin.x0, bin.y0);
    reinterpret_cast<int2*>(a.rect_max)[i] = make_int2(bin.x1, bin.y1);
    a.tiles[i] = tiles;
  }

  const int block_visible = __syncthreads_count(valid);
  if (threadIdx.x == 0 && block_visible > 0)
    atomicAdd(a.visible, block_visible);

  // colour: color_precomp, or the degree-masked SH colour; culled rows
  // read nothing and take 0
  if (!in) return;
  if (a.color_precomp != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.color[3 * i + c] = valid ? __ldg(a.color_precomp + 3 * i + c) : 0.0f;
    return;
  }
  const int n = deg < 0 ? 0 : min(a.coeffs, deg >= 3 ? 16
                                                       : (deg + 1) * (deg + 1));
  const int need = valid && a.sh_words ? words_needed(deg) : 0;
  float col[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const float dx = sub(px, __ldg(a.campos));
    const float dy = sub(py, __ldg(a.campos + 1));
    const float dz = sub(pz, __ldg(a.campos + 2));
    const float dn = maxn(root(sum3(mul(dx, dx), mul(dy, dy), mul(dz, dz))),
                          1e-12f);
    float b[16];
    sh_basis(dvd(dx, dn), dvd(dy, dn), dvd(dz, dn), b);
    if (a.sh_words) {
      const float4* row = reinterpret_cast<const float4*>(a.sh) +
                          static_cast<size_t>(i) * kRowWords;
#pragma unroll
      for (int w = 0; w < kRowWords; ++w)
        if (w < need) add_word(__ldg(row + w), w, b, n, col);
    } else {
      const float* row = a.sh + static_cast<size_t>(i) * a.coeffs * 3;
      for (int k = 0; k < n; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          col[c] = fmaf(b[k], __ldg(row + 3 * k + c), col[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = maxn(col[c] + 0.5f, 0.0f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) a.color[3 * i + c] = col[c];
}

}  // namespace

extern "C" int preprocess_fwd_launch(
    const void* xyz, const void* scales, const void* rotations,
    const void* opacities, const void* sh, int coeffs, const void* degrees,
    const void* alive, const void* color_precomp, const void* viewmatrix,
    const void* projmatrix, const void* campos, const void* tan_fovx,
    const void* tan_fovy, int p, int width, int height,
    float scale_modifier, void* means2d, void* depths, void* conic,
    void* opacity, void* color, void* radii, void* rect_min, void* rect_max,
    void* tiles, void* visible, void* stream) {
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.xyz = static_cast<const float*>(xyz);
  a.scales = static_cast<const float*>(scales);
  a.rotations = static_cast<const float*>(rotations);
  a.opacities = static_cast<const float*>(opacities);
  a.sh = static_cast<const float*>(sh);
  a.degrees = static_cast<const int*>(degrees);
  a.alive = static_cast<const bool*>(alive);
  a.color_precomp = static_cast<const float*>(color_precomp);
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
  a.sh_words = coeffs == 16 && reinterpret_cast<uintptr_t>(sh) % 16 == 0;
  a.means2d = static_cast<float*>(means2d);
  a.depths = static_cast<float*>(depths);
  a.conic = static_cast<float*>(conic);
  a.opacity = static_cast<float*>(opacity);
  a.color = static_cast<float*>(color);
  a.radii = static_cast<int*>(radii);
  a.rect_min = static_cast<int*>(rect_min);
  a.rect_max = static_cast<int*>(rect_max);
  a.tiles = static_cast<int*>(tiles);
  a.visible = static_cast<int*>(visible);
  const int blocks = (p + kBlock - 1) / kBlock;
  preprocess_fwd_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
