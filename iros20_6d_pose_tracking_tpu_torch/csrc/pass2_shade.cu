// Rasterization pass 2 for Hopper, fused: each pixel's winner row gathered
// and shaded in one kernel, so the gathered rows never reach device memory.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_gather_kernel (launched by pallas_gather_rows) together with the
// shading that consumes its rows (iros20_6d_pose_tracking_tpu/render/
// rasterizer.py::shade_rows, depth_from_form=True). Plain PyTorch version:
// render/raster_kernels.py::pass2_shade_ref (zmin, coverage and hit from
// pass 1's 1/z, the winner clamp, gather_rows_ref and shade_rows, beside it).
//
// What it computes, per (view, pixel): from pass 1's iz, zmin = 1 / iz
// where iz > 1e-9 (else no surface), hit = zmin < far; for a hit pixel the
// winner's row of the attribute table (its id clamped to [0, F)): the 1/z
// form izpix, and the perspective-correct albedo (or, with UV forms, a
// bilinear wrapped texture fetch), normal and position forms, each
// (alpha px + beta py + gamma) / izpix; the normal and position rotated
// into the camera by the view's R and t, the light direction, n . l, and
// rgb = 255 clamp(albedo (ambient + diffuse max(n . l, 0)), 0, 1), depth =
// 1000 / izpix mm. A pixel without a hit gets rgb 0 and depth 0.
//
// Bits. Depth and hit follow shade_rows' op order with one rounding per op
// (__fmul_rn, __fadd_rn, __frcp_rn; torch's 1 / x is a correctly rounded
// reciprocal), so they are the plain version's bits on the card. RGB sums
// the rotation and the norms in this kernel's own order (torch's matmul and
// vector_norm keep theirs), a few float32 ulps apart.
//
// What bounds it on this card. Bytes: per pixel 8 read (iz, winner) and 16
// written (rgb, depth), plus the distinct attribute rows the hit pixels
// name, each once (the table stays in L2: 369 KB for the production mesh).
// About 150 flops per hit pixel, far below the bytes. The unfused pass 2 wrote and re-read 120-144 bytes of rows per
// pixel and ran about 50 elementwise launches over them.
//
// What the design does about it. One thread per (view, pixel), a flat grid
// over all views: a thread reads its two words, and only a hit pixel loads
// its winner's row (30 or 36 floats; rows are 8-byte aligned, so as float2
// loads through the read-only cache) and computes in registers. The
// lighting override is read on the device; R and t are read through their
// strides, so a view of the pose matrix needs no copy.

#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-9f;  // torch.clamp(min=1e-9) of the plain version
constexpr int kThreads = 256;

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// (alpha px + beta py + gamma) * inv_iz for column k of an attribute with c
// channels starting at `base`, rounded op by op as the plain version does.
__device__ __forceinline__ float attr_form(const float* row, int base, int c,
                                           int k, float px, float py,
                                           float inv_iz) {
  const float num = __fadd_rn(
      __fadd_rn(__fmul_rn(row[base + k], px), __fmul_rn(row[base + c + k], py)),
      row[base + 2 * c + k]);
  return __fmul_rn(num, inv_iz);
}

// raster_kernels._sample_texture at one (u, v): OBJ-convention UVs (origin
// bottom-left), wrap addressing, bilinear.
__device__ __forceinline__ void sample_texture(const float* __restrict__ tex,
                                               int th, int tw, float u,
                                               float v, float out[3]) {
  const float x = (u - floorf(u)) * static_cast<float>(tw - 1);
  const float y = (1.0f - (v - floorf(v))) * static_cast<float>(th - 1);
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(tw - 1));
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), static_cast<float>(th - 1));
  const float x1 = fminf(x0 + 1.0f, static_cast<float>(tw - 1));
  const float y1 = fminf(y0 + 1.0f, static_cast<float>(th - 1));
  const float fx = x - x0;
  const float fy = y - y0;
  const int i00 = (static_cast<int>(y0) * tw + static_cast<int>(x0)) * 3;
  const int i01 = (static_cast<int>(y0) * tw + static_cast<int>(x1)) * 3;
  const int i10 = (static_cast<int>(y1) * tw + static_cast<int>(x0)) * 3;
  const int i11 = (static_cast<int>(y1) * tw + static_cast<int>(x1)) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __ldg(&tex[i00 + k]) * (1.0f - fx) +
                      __ldg(&tex[i01 + k]) * fx;
    const float bot = __ldg(&tex[i10 + k]) * (1.0f - fx) +
                      __ldg(&tex[i11 + k]) * fx;
    out[k] = top * (1.0f - fy) + bot * fy;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) pass2_shade_kernel(
    const float* __restrict__ attr, const float* __restrict__ iz,
    const int* __restrict__ winner, const float* __restrict__ R, int r_sv,
    int r_si, int r_sj, const float* __restrict__ t, int t_sv, int t_si,
    const float* __restrict__ lighting, const float* __restrict__ texture,
    int th, int tw, float far, float* __restrict__ rgb,
    float* __restrict__ depth, int F, int H, int W, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long P = static_cast<long long>(H) * W;
  const long long view = i / P;
  const int p = static_cast<int>(i - view * P);

  // zmin = 1 / iz where iz > 1e-9 (clamp is then the identity), else inf.
  const float z = iz[i];
  const bool hit = z > kTiny && __frcp_rn(z) < far;
  if (!hit) {
    rgb[3 * i + 0] = 0.0f;
    rgb[3 * i + 1] = 0.0f;
    rgb[3 * i + 2] = 0.0f;
    depth[i] = 0.0f;
    return;
  }
  const int w = min(max(winner[i], 0), F - 1);
  float row[C];
  const float2* src = reinterpret_cast<const float2*>(
      attr + (view * F + w) * static_cast<long long>(C));
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {
    const float2 v = __ldg(&src[k]);
    row[2 * k] = v.x;
    row[2 * k + 1] = v.y;
  }
  const float px = static_cast<float>(p % W);
  const float py = static_cast<float>(p / W);

  const float izpix =
      __fadd_rn(__fadd_rn(__fmul_rn(row[0], px), __fmul_rn(row[1], py)),
                row[2]);
  const float inv_iz = __frcp_rn(clamp_min(izpix, kTiny));
  depth[i] = __fmul_rn(inv_iz, 1000.0f);

  float albedo[3];
  bool textured = false;
  if constexpr (C >= 36) {  // UV forms at columns 30-35
    if (texture != nullptr) {
      const float u = attr_form(row, 30, 2, 0, px, py, inv_iz);
      const float v = attr_form(row, 30, 2, 1, px, py, inv_iz);
      sample_texture(texture, th, tw, u, v, albedo);
      textured = true;
    }
  }
  if (!textured) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      albedo[k] = attr_form(row, 3, 3, k, px, py, inv_iz);
    }
  }
  float n_obj[3], p_obj[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n_obj[k] = attr_form(row, 12, 3, k, px, py, inv_iz);
    p_obj[k] = attr_form(row, 21, 3, k, px, py, inv_iz);
  }
  const float* Rv = R + view * r_sv;
  const float* tv = t + view * t_sv;
  float n_cam[3], p_cam[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* Ra = Rv + a * r_si;
    n_cam[a] = n_obj[0] * Ra[0] + n_obj[1] * Ra[r_sj] + n_obj[2] * Ra[2 * r_sj];
    p_cam[a] = p_obj[0] * Ra[0] + p_obj[1] * Ra[r_sj] +
               p_obj[2] * Ra[2 * r_sj] + tv[a * t_si];
  }
  float ambient = 0.65f, diffuse = 0.4f;  // raster_kernels.AMBIENT, DIFFUSE
  float light[3] = {0.0f, -0.1f, -0.9f};  // raster_kernels.LIGHT_CAM
  if (lighting != nullptr) {
    ambient = lighting[0];
    diffuse = lighting[1];
    light[0] = lighting[2];
    light[1] = lighting[3];
    light[2] = lighting[4];
  }
  const float n_len = clamp_min(
      sqrtf(n_cam[0] * n_cam[0] + n_cam[1] * n_cam[1] + n_cam[2] * n_cam[2]),
      kTiny);
  float l_vec[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) l_vec[a] = light[a] - p_cam[a];
  const float l_len = clamp_min(
      sqrtf(l_vec[0] * l_vec[0] + l_vec[1] * l_vec[1] + l_vec[2] * l_vec[2]),
      kTiny);
  float ndotl = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) ndotl += (n_cam[a] / n_len) * (l_vec[a] / l_len);
  ndotl = ndotl < 0.0f ? 0.0f : ndotl;
  const float lit = ambient + diffuse * ndotl;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rgb[3 * i + k] = clamp01(albedo[k] * lit) * 255.0f;
  }
}

}  // namespace

extern "C" {

// attr: (B, F, C) f32 with C = 30 or 36 (UV forms), 8-byte aligned; iz,
// winner: (B, H * W) f32 / i32 from pass 1; R: element (b, a, j) at R[b *
// r_sv + a * r_si + j * r_sj]; t: element (b, a) at t[b * t_sv + a * t_si];
// lighting: 5 f32 [ambient, diffuse, lx, ly, lz] or null for the defaults;
// texture: (th, tw, 3) f32 or null (sampled only when C = 36); rgb: (B, H *
// W, 3) and depth: (B, H * W) f32 outputs. All pointers live on the
// current CUDA device, which the caller sets; the kernel is queued on
// `stream` and nothing synchronises.
int pass2_shade(const void* attr, const void* iz, const void* winner,
                const void* R, const void* t, const void* lighting,
                const void* texture, void* rgb, void* depth, int B, int H,
                int W, int F, int C, int r_sv, int r_si, int r_sj, int t_sv,
                int t_si, int th, int tw, float far, void* stream) {
  const long long total = static_cast<long long>(B) * H * W;
  if (total == 0) return 0;
  if (F <= 0 || (C != 30 && C != 36)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = (total + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const float*>(attr), static_cast<const float*>(iz),
        static_cast<const int*>(winner), static_cast<const float*>(R), r_sv,
        r_si, r_sj, static_cast<const float*>(t), t_sv, t_si,
        static_cast<const float*>(lighting),
        static_cast<const float*>(texture), th, tw, far,
        static_cast<float*>(rgb), static_cast<float*>(depth), F, H, W, total);
  };
  if (C == 30) {
    launch(pass2_shade_kernel<30>);
  } else {
    launch(pass2_shade_kernel<36>);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
