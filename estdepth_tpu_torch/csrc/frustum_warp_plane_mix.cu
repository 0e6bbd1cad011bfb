// Plane-mix frustum warp (kernel 4 of the port), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp.py:frustum_warp_pallas
// (_frustum_impl: the lane-gather z-mix kernel _make_zmix_kernel, a
// transpose, then the two resample passes of _two_pass).
//
// Computes, per output voxel v = (b, d, i, j) with exact source coordinates
// x[b, v'], y[b, v'] (v' = (d*H + i)*W + j):
//   for each bilinear corner pixel c of (x, y) (stacked-sampler rules):
//     q     = zi[b, d, c]            the plane index of target plane d at c
//     z0    = clip(floor(q), 0, Z-2)
//     M(c)  = max(0, 1 - |q - z0|) * V[b, z0, c, :]
//           + max(0, 1 - |q - z0 - 1|) * V[b, z0+1, c, :]
//             and 0 where q leaves [-1e-3, Z-1+1e-3]
//   out = bilinear(M), and zero where (x, y) leaves the image.
// The two tests differ on purpose: the eps-padded window is on the plane
// index of each CORNER, the hard mask is on the exact (x, y) of the VOXEL.
// zi [B, D, H*W] is the per-(target plane, source pixel) index field the
// wrapper's caller computes in PyTorch (ops/warp_exact_z.zi_field), with
// its -2 sentinel behind the camera, which the window test rejects.
//
// The TPU version mixes z for every (plane, source pixel) into an
// intermediate in device memory, transposes it and resamples it in two
// passes at row crossings, because Mosaic gathers only along lanes. Here
// one thread per (voxel, 4 channels) mixes its four corners' taps in
// registers and blends them at the exact (x, y): no intermediate reaches
// device memory, and the result is the plain version's (ops/cuda/
// plane_mix.plane_mix_resample_plain) operation by operation: every add and
// multiply is rounded on its own (_rn intrinsics, no FMA contraction).
//
// Bound on the card: bytes. At the Joint window's shapes (V [3, 64, 64, 80,
// 32] f32) the kernel must read the 126 MB volume once and write as much,
// plus 3 x 15.7 MB of zi, x and y. Each voxel reads 8 float4 taps;
// neighbouring voxels share corners and planes, so the repeated reads are
// meant to hit L1/L2. Voxels whose (x, y) is out of range skip all gathers.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-3f;

__device__ __forceinline__ void corner(float q, int size, int& i0, int& i1,
                                       float& frac) {
  const float qc = fminf(fmaxf(q, 0.0f), static_cast<float>(size - 1));
  const float base = fminf(fmaxf(floorf(qc), 0.0f),
                           fmaxf(static_cast<float>(size - 2), 0.0f));
  i0 = static_cast<int>(base);
  i1 = min(i0 + 1, size - 1);
  frac = qc - base;
}

// a + t * (b - a), every operation rounded on its own.
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t),
                     lerp(a.w, b.w, t));
}

__device__ __forceinline__ float mix(float w0, float v0, float w1, float v1) {
  return __fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1));
}

// The z-mixed value of one corner pixel: two hat-weighted taps at the
// corner's own plane index, zero outside the eps-padded window.
__device__ __forceinline__ float4 z_mix(const float4* __restrict__ vol_b,
                                        const float* __restrict__ zi_map,
                                        int pix, int Z, long long hw,
                                        int C4) {
  const float q = __ldg(zi_map + pix);
  if (!(q >= -kEps && q <= static_cast<float>(Z - 1) + kEps)) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float z0 = fminf(fmaxf(floorf(q), 0.0f),
                         fmaxf(static_cast<float>(Z - 2), 0.0f));
  const float w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(q, z0))), 0.0f);
  const float w1 = fmaxf(
      __fsub_rn(1.0f, fabsf(__fsub_rn(q, __fadd_rn(z0, 1.0f)))), 0.0f);
  const long long z0i = static_cast<long long>(z0);
  const float4 v0 = __ldg(vol_b + (z0i * hw + pix) * C4);
  const float4 v1 = __ldg(vol_b + ((z0i + 1) * hw + pix) * C4);
  return make_float4(mix(w0, v0.x, w1, v1.x), mix(w0, v0.y, w1, v1.y),
                     mix(w0, v0.z, w1, v1.z), mix(w0, v0.w, w1, v1.w));
}

__global__ void frustum_warp_plane_mix_kernel(
    const float4* __restrict__ vol, const float* __restrict__ zi,
    const float* __restrict__ xs, const float* __restrict__ ys,
    float4* __restrict__ out, int Z, int H, int W, int C4, long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c4 = static_cast<int>(t % C4);
  const long long v = t / C4;  // voxel index over [B, D, H, W], D == Z
  const long long hw = static_cast<long long>(H) * W;
  const long long bd = v / hw;  // b * D + d
  const long long b = bd / Z;
  const float x = __ldg(xs + v);
  const float y = __ldg(ys + v);
  const bool valid = x >= 0.0f && x <= static_cast<float>(W - 1) &&
                     y >= 0.0f && y <= static_cast<float>(H - 1);
  if (!valid) {
    out[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  int x0, x1, y0, y1;
  float wx, wy;
  corner(x, W, x0, x1, wx);
  corner(y, H, y0, y1, wy);
  const float4* vol_b = vol + b * Z * hw * C4 + c4;
  const float* zi_map = zi + bd * hw;
  const float4 m00 = z_mix(vol_b, zi_map, y0 * W + x0, Z, hw, C4);
  const float4 m01 = z_mix(vol_b, zi_map, y0 * W + x1, Z, hw, C4);
  const float4 m10 = z_mix(vol_b, zi_map, y1 * W + x0, Z, hw, C4);
  const float4 m11 = z_mix(vol_b, zi_map, y1 * W + x1, Z, hw, C4);
  out[t] = lerp4(lerp4(m00, m01, wx), lerp4(m10, m11, wx), wy);
}

}  // namespace

// vol [B, D, H, W, C], zi [B, D, H*W], x/y [B, D*H*W], out like vol; all
// f32, contiguous, C % 4 == 0, D >= 2 (checked by the Python wrapper).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int frustum_warp_plane_mix_f32(const void* vol, const void* zi,
                                          const void* x, const void* y,
                                          void* out, int B, int D, int H,
                                          int W, int C, void* stream) {
  const int c4 = C / 4;
  const long long total = static_cast<long long>(B) * D * H * W * c4;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  frustum_warp_plane_mix_kernel<<<static_cast<unsigned int>(blocks), threads,
                                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vol), static_cast<const float*>(zi),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float4*>(out), D, H, W, c4, total);
  return static_cast<int>(cudaGetLastError());
}
