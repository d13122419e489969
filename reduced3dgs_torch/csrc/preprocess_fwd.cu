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

#include "preprocess_math.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 16;

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
    Cov3d c3;
    build_cov3d(a.rotations + 4 * i, a.scales + 3 * i, a.scale_modifier, c3);

    // compute_cov2d: the clamped view point, the EWA Jacobian, + 0.3
    Cov2d c2d;
    compute_cov2d(V, sx, sy, sz, focal_x, focal_y, limx, limy, c3.S, c2d);
    const float c0 = c2d.c0, c1 = c2d.c1, c2 = c2d.c2;

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
