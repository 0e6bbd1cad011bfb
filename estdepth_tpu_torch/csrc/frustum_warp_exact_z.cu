// Exact-z frustum warp (kernel 2 of the ESTM step), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp_exact_z.py:
// frustum_warp_exact_z_pallas (_frustum_exact_z_impl: the K1' tap/slope
// kernels _tap_slope_kernel / _tap_slope_packed_kernel, then _two_pass on
// the [A | s] stack, then apply_exact_z_correction in XLA).
//
// Computes, per output voxel v = (b, d, i, j) with exact source coordinates
// x[b, v'], y[b, v'] and source depth z[b, v'] (v' = (d*H + i)*W + j):
//   zi*   = (z - depth_min) * inv_depth_interval
//   for each bilinear corner pixel c of (x, y) (stacked-sampler rules):
//     z0(c) = clip(floor(clip(zi[b, d, c], 0, Z-1)), 0, Z-2)
//     s(c)  = V[b, z0+1, c, :] - V[b, z0, c, :]
//     A(c)  = V[b, z0, c, :] - z0(c) * s(c)
//   out = bilinear(A) + clip(zi*, 0, Z-1) * bilinear(s)
// and zero where (x, y) leaves the image or zi* leaves [-1e-3, Z-1+1e-3].
// zi [B, D, H*W] is the per-(target plane, source pixel) index field the
// wrapper computes in PyTorch (ops/warp_exact_z.zi_field).
// inv_depth_interval is the f32 reciprocal 1 / depth_interval: PyTorch
// evaluates the plain version's division by a Python scalar on the card
// as this multiplication, and the voxel's z-window test must not flip
// between the two at a boundary.
//
// The TPU version writes A and s for every (plane, source pixel) to HBM
// (as bf16 pairs in its packed mode) and resamples them in two passes,
// because Mosaic can neither gather across lanes nor fuse the stages.
// Here one thread per (voxel, 16-byte vector) gathers its corners' taps
// directly: A and s never reach device memory, so there is nothing to pack,
// and the sample is taken at the exact (x, y).
//
// Bound on the card: bytes. At the flagship step (V [2, 64, 64, 80, 32]
// f32) the kernel must read the 84 MB volume once and write the 84 MB
// output, plus 7.9 MB of x/y/z and 2.6 MB of zi: ~178 MB, about 53 us at
// 3.35 TB/s. Each voxel reads 8 float4 taps (two planes at four corners);
// neighbouring voxels share corners and planes, so the repeated reads are
// meant to hit L1/L2 rather than device memory. Out-of-window voxels skip
// all gathers.
//
// Two instances of one body: frustum_warp_exact_z_f32 and
// frustum_warp_exact_z_bf16. A thread owns one 16-byte vector of a voxel:
// 4 float32 or 8 bfloat16 channels (csrc/vec16.cuh). A and s are float32
// in both, as the TPU function keeps them for a bf16 volume: A carries
// z0 * s at up to Z-1 times the volume's scale, which a bf16 A would
// amplify. A bfloat16 result is rounded once. In bfloat16 the volume and
// the output halve (42 MB each at the flagship step) and the 10.5 MB of
// x/y/z and zi do not: about 28 us at 3.35 TB/s.

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

// a + t * (b - a) with every operation rounded on its own: the explicit
// _rn intrinsics keep nvcc from contracting into an FMA, so the result is
// the plain PyTorch version's bit for bit.
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// Tap A and slope s of one corner pixel, one vector of channels: the
// corner's z-cell from its own plane index, clamped into range (never
// zeroed). No FMA contraction here either: A = v0 - z0 * s carries z0 * s
// at up to Z-1 times the volume's scale, and a contracted A moves the
// output by ~2e-5 of its scale.
template <typename T>
__device__ __forceinline__ void tap_slope(
    const typename vec16::Vec<T>::Raw* __restrict__ vol_b,
    const float* __restrict__ zi_map, int pix, int Z, long long hw, int CV,
    float (&a)[vec16::Vec<T>::kLanes], float (&s)[vec16::Vec<T>::kLanes]) {
  using V = vec16::Vec<T>;
  const float zq = __ldg(zi_map + pix);
  const float z0 =
      fminf(fmaxf(floorf(fminf(fmaxf(zq, 0.0f), static_cast<float>(Z - 1))),
                  0.0f),
            fmaxf(static_cast<float>(Z - 2), 0.0f));
  const long long z0i = static_cast<long long>(z0);
  float v0[V::kLanes], v1[V::kLanes];
  V::unpack(__ldg(vol_b + (z0i * hw + pix) * CV), v0);
  V::unpack(__ldg(vol_b + ((z0i + 1) * hw + pix) * CV), v1);
#pragma unroll
  for (int l = 0; l < V::kLanes; ++l) {
    s[l] = __fsub_rn(v1[l], v0[l]);
    a[l] = __fsub_rn(v0[l], __fmul_rn(z0, s[l]));
  }
}

template <typename T>
__global__ void frustum_warp_exact_z_kernel(
    const typename vec16::Vec<T>::Raw* __restrict__ vol,
    const float* __restrict__ zi, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ zs,
    typename vec16::Vec<T>::Raw* __restrict__ out, int Z, int H, int W,
    int CV, float depth_min, float inv_depth_interval, long long total) {
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
  const float zstar = (__ldg(zs + v) - depth_min) * inv_depth_interval;
  const bool valid = x >= 0.0f && x <= static_cast<float>(W - 1) &&
                     y >= 0.0f && y <= static_cast<float>(H - 1) &&
                     zstar >= -kEps &&
                     zstar <= static_cast<float>(Z - 1) + kEps;
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
  float a00[L], s00[L], a01[L], s01[L], a10[L], s10[L], a11[L], s11[L];
  tap_slope<T>(vol_b, zi_map, y0 * W + x0, Z, hw, CV, a00, s00);
  tap_slope<T>(vol_b, zi_map, y0 * W + x1, Z, hw, CV, a01, s01);
  tap_slope<T>(vol_b, zi_map, y1 * W + x0, Z, hw, CV, a10, s10);
  tap_slope<T>(vol_b, zi_map, y1 * W + x1, Z, hw, CV, a11, s11);
  const float zc = fminf(fmaxf(zstar, 0.0f), static_cast<float>(Z - 1));
  float o[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float at = lerp(lerp(a00[l], a01[l], wx), lerp(a10[l], a11[l], wx),
                          wy);
    const float st = lerp(lerp(s00[l], s01[l], wx), lerp(s10[l], s11[l], wx),
                          wy);
    o[l] = __fadd_rn(at, __fmul_rn(zc, st));
  }
  out[t] = V::pack(o);
}

template <typename T>
int launch(const void* vol, const void* zi, const void* x, const void* y,
           const void* z, void* out, int B, int D, int H, int W, int C,
           float depth_min, float inv_depth_interval, void* stream) {
  using Raw = typename vec16::Vec<T>::Raw;
  const int cv = C / vec16::Vec<T>::kLanes;
  const long long total = static_cast<long long>(B) * D * H * W * cv;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  frustum_warp_exact_z_kernel<T>
      <<<static_cast<unsigned int>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Raw*>(vol), static_cast<const float*>(zi),
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const float*>(z), static_cast<Raw*>(out), D, H, W, cv,
          depth_min, inv_depth_interval, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol [B, D, H, W, C], out like vol; zi [B, D, H*W] and x/y/z [B, D*H*W]
// float32; contiguous, C a multiple of 4 (float32) or 8 (bfloat16), D >= 2
// (checked by the Python wrapper). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int frustum_warp_exact_z_f32(const void* vol, const void* zi,
                                        const void* x, const void* y,
                                        const void* z, void* out, int B,
                                        int D, int H, int W, int C,
                                        float depth_min,
                                        float inv_depth_interval,
                                        void* stream) {
  return launch<float>(vol, zi, x, y, z, out, B, D, H, W, C, depth_min,
                       inv_depth_interval, stream);
}

extern "C" int frustum_warp_exact_z_bf16(const void* vol, const void* zi,
                                         const void* x, const void* y,
                                         const void* z, void* out, int B,
                                         int D, int H, int W, int C,
                                         float depth_min,
                                         float inv_depth_interval,
                                         void* stream) {
  return launch<__nv_bfloat16>(vol, zi, x, y, z, out, B, D, H, W, C,
                               depth_min, inv_depth_interval, stream);
}
