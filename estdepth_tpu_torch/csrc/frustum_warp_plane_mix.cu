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
// one thread per (voxel, 16-byte vector) mixes its four corners' taps in
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
//
// Two instances of one body: frustum_warp_plane_mix_f32 and
// frustum_warp_plane_mix_bf16. A thread owns one 16-byte vector of a voxel:
// 4 float32 or 8 bfloat16 channels (csrc/vec16.cuh), mixed and blended in
// float32 and, in bfloat16, rounded once, where the TPU kernels also round
// the z-mixed intermediate and the first resample pass to bf16. In
// bfloat16 the volume and the output halve (63 MB each at the Joint
// window's shapes) and the 47 MB of zi, x and y do not: about 52 us at
// 3.35 TB/s.

#include "vec16.cuh"

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

__device__ __forceinline__ float mix(float w0, float v0, float w1, float v1) {
  return __fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1));
}

// The z-mixed value of one corner pixel, one vector of channels: two
// hat-weighted taps at the corner's own plane index, zero outside the
// eps-padded window.
template <typename T>
__device__ __forceinline__ void z_mix(
    const typename vec16::Vec<T>::Raw* __restrict__ vol_b,
    const float* __restrict__ zi_map, int pix, int Z, long long hw, int CV,
    float (&m)[vec16::Vec<T>::kLanes]) {
  using V = vec16::Vec<T>;
  const float q = __ldg(zi_map + pix);
  if (!(q >= -kEps && q <= static_cast<float>(Z - 1) + kEps)) {
#pragma unroll
    for (int l = 0; l < V::kLanes; ++l) m[l] = 0.0f;
    return;
  }
  const float z0 = fminf(fmaxf(floorf(q), 0.0f),
                         fmaxf(static_cast<float>(Z - 2), 0.0f));
  const float w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(q, z0))), 0.0f);
  const float w1 = fmaxf(
      __fsub_rn(1.0f, fabsf(__fsub_rn(q, __fadd_rn(z0, 1.0f)))), 0.0f);
  const long long z0i = static_cast<long long>(z0);
  float v0[V::kLanes], v1[V::kLanes];
  V::unpack(__ldg(vol_b + (z0i * hw + pix) * CV), v0);
  V::unpack(__ldg(vol_b + ((z0i + 1) * hw + pix) * CV), v1);
#pragma unroll
  for (int l = 0; l < V::kLanes; ++l) m[l] = mix(w0, v0[l], w1, v1[l]);
}

template <typename T>
__global__ void frustum_warp_plane_mix_kernel(
    const typename vec16::Vec<T>::Raw* __restrict__ vol,
    const float* __restrict__ zi, const float* __restrict__ xs,
    const float* __restrict__ ys,
    typename vec16::Vec<T>::Raw* __restrict__ out, int Z, int H, int W,
    int CV, long long total) {
  using V = vec16::Vec<T>;
  constexpr int L = V::kLanes;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cv = static_cast<int>(t % CV);
  const long long v = t / CV;  // voxel index over [B, D, H, W], D == Z
  const long long hw = static_cast<long long>(H) * W;
  const long long bd = v / hw;  // b * D + d
  const long long b = bd / Z;
  const float x = __ldg(xs + v);
  const float y = __ldg(ys + v);
  const bool valid = x >= 0.0f && x <= static_cast<float>(W - 1) &&
                     y >= 0.0f && y <= static_cast<float>(H - 1);
  if (!valid) {
    out[t] = typename V::Raw{};
    return;
  }
  int x0, x1, y0, y1;
  float wx, wy;
  corner(x, W, x0, x1, wx);
  corner(y, H, y0, y1, wy);
  const typename V::Raw* vol_b = vol + b * Z * hw * CV + cv;
  const float* zi_map = zi + bd * hw;
  float m00[L], m01[L], m10[L], m11[L], o[L];
  z_mix<T>(vol_b, zi_map, y0 * W + x0, Z, hw, CV, m00);
  z_mix<T>(vol_b, zi_map, y0 * W + x1, Z, hw, CV, m01);
  z_mix<T>(vol_b, zi_map, y1 * W + x0, Z, hw, CV, m10);
  z_mix<T>(vol_b, zi_map, y1 * W + x1, Z, hw, CV, m11);
#pragma unroll
  for (int l = 0; l < L; ++l)
    o[l] = lerp(lerp(m00[l], m01[l], wx), lerp(m10[l], m11[l], wx), wy);
  out[t] = V::pack(o);
}

template <typename T>
int launch(const void* vol, const void* zi, const void* x, const void* y,
           void* out, int B, int D, int H, int W, int C, void* stream) {
  using Raw = typename vec16::Vec<T>::Raw;
  const int cv = C / vec16::Vec<T>::kLanes;
  const long long total = static_cast<long long>(B) * D * H * W * cv;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  frustum_warp_plane_mix_kernel<T>
      <<<static_cast<unsigned int>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Raw*>(vol), static_cast<const float*>(zi),
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<Raw*>(out), D, H, W, cv, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol [B, D, H, W, C], out like vol; zi [B, D, H*W] and x/y [B, D*H*W]
// float32; contiguous, C a multiple of 4 (float32) or 8 (bfloat16), D >= 2
// (checked by the Python wrapper). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int frustum_warp_plane_mix_f32(const void* vol, const void* zi,
                                          const void* x, const void* y,
                                          void* out, int B, int D, int H,
                                          int W, int C, void* stream) {
  return launch<float>(vol, zi, x, y, out, B, D, H, W, C, stream);
}

extern "C" int frustum_warp_plane_mix_bf16(const void* vol, const void* zi,
                                           const void* x, const void* y,
                                           void* out, int B, int D, int H,
                                           int W, int C, void* stream) {
  return launch<__nv_bfloat16>(vol, zi, x, y, out, B, D, H, W, C, stream);
}
