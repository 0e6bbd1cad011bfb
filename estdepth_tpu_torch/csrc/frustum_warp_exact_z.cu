// Exact-z frustum warp (kernel 2 of the ESTM step), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp_exact_z.py:
// frustum_warp_exact_z_pallas (_frustum_exact_z_impl: the K1' tap/slope
// kernels _tap_slope_kernel / _tap_slope_packed_kernel, then _two_pass on
// the [A | s] stack, then apply_exact_z_correction in XLA).
//
// Computes, per output voxel v = (b, d, i, j) with exact source coordinates
// x[b, v'], y[b, v'] and source depth z[b, v'] (v' = (d*H + i)*Wo + j; Wo
// the output's columns, W for the whole frustum, fewer for a width shard's
// own columns):
//   zi*   = (z - depth_min) * inv_depth_interval
//   for each bilinear corner pixel c of (x, y) (stacked-sampler rules):
//     z0(c) = clip(floor(clip(zi[b, d, c], 0, Z-1)), 0, Z-2)
//     s(c)  = V[b, z0+1, c, :] - V[b, z0, c, :]
//     A(c)  = V[b, z0, c, :] - z0(c) * s(c)
//   out = bilinear(A) + clip(zi*, 0, Z-1) * bilinear(s)
// and zero where (x, y) leaves the image or zi* leaves [-1e-3, Z-1+1e-3].
// The two windows differ on purpose: the z-window is tested on the voxel's
// zi*, and a corner's z-cell is clamped into range, never zeroed.
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
// Here A and s never reach device memory: the body (csrc/frustum_gather.cuh)
// gives each block of 16 x 8 voxels of one plane, a lane per voxel, and
// every vector of a voxel gathers its four corners' taps, derives their A
// and s and blends them at the exact (x, y). A = v0 - z0 * s carries
// z0 * s at up to Z-1 times the volume's scale, so A and s are float32 in
// both instances, as the TPU function keeps them for a bf16 volume, and no
// operation is contracted into an FMA (a contracted A moves the output by
// ~2e-5 of its scale).
//
// Bound on the card: bytes. At the flagship step (V [2, 64, 64, 80, 32]
// f32) the kernel must read the 84 MB volume once and write the 84 MB
// output, plus 7.9 MB of x/y/z and 2.6 MB of zi: ~178 MB, about 53 us at
// 3.35 TB/s. In bfloat16 the volume and the output halve (42 MB each) and
// the 10.5 MB of x/y/z and zi do not: ~94.4 MB, about 28 us. Out-of-window
// voxels read no taps.
//
// Two instances of one body: frustum_warp_exact_z_f32 and
// frustum_warp_exact_z_bf16 (csrc/vec16.cuh: a 16-byte vector holds 4
// float32 or 8 bfloat16 channels; a bfloat16 result is rounded once).

#include "frustum_gather.cuh"

namespace {

struct ExactZ {
  static constexpr int kValues = 2;  // A and s
  static constexpr bool kUsesZc = true;
  const float* zs;
  float depth_min, inv_depth_interval;

  // The voxel's z-window, and its clipped z index zc.
  __device__ __forceinline__ bool voxel(long long v, int Z, float& zc) const {
    const float zstar =
        __fmul_rn(__fsub_rn(__ldg(zs + v), depth_min), inv_depth_interval);
    zc = fminf(fmaxf(zstar, 0.0f), static_cast<float>(Z - 1));
    return zstar >= -frustum::kEps &&
           zstar <= static_cast<float>(Z - 1) + frustum::kEps;
  }

  // a corner's z-cell, clamped into range (never zeroed)
  __device__ __forceinline__ float z0(float q, int Z) const {
    return fminf(
        fmaxf(floorf(fminf(fmaxf(q, 0.0f), static_cast<float>(Z - 1))), 0.0f),
        fmaxf(static_cast<float>(Z - 2), 0.0f));
  }

  __device__ __forceinline__ bool loads(float) const { return true; }

  template <int L>
  __device__ __forceinline__ void values(const float (&v0)[L],
                                         const float (&v1)[L], float,
                                         float z0, float (&out)[2][L]) const {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out[1][l] = __fsub_rn(v1[l], v0[l]);
      out[0][l] = __fsub_rn(v0[l], __fmul_rn(z0, out[1][l]));
    }
  }

  // bilinear(A) + zc * bilinear(s)
  __device__ __forceinline__ float finish(const float (&t)[2],
                                          float zc) const {
    return __fadd_rn(t[0], __fmul_rn(zc, t[1]));
  }
};

template <typename T>
int launch(const void* vol, const void* zi, const void* x, const void* y,
           const void* z, void* out, int B, int D, int H, int W, int Wo,
           int C, float depth_min, float inv_depth_interval, void* stream) {
  const ExactZ op{static_cast<const float*>(z), depth_min,
                  inv_depth_interval};
  return frustum::launch<T>(vol, zi, x, y, out, B, D, H, W, Wo, C, op,
                            stream);
}

}  // namespace

// vol [B, D, H, W, C], zi [B, D, H*W], x/y/z [B, D, H, Wo] float32, out
// [B, D, H, Wo, C] of vol's type; contiguous, C a multiple of 4 (float32)
// or 8 (bfloat16), D >= 2 (checked by the Python wrapper). Launches on
// `stream` and returns the launch's CUDA error (cudaGetLastError()).
extern "C" int frustum_warp_exact_z_f32(const void* vol, const void* zi,
                                        const void* x, const void* y,
                                        const void* z, void* out, int B,
                                        int D, int H, int W, int Wo, int C,
                                        float depth_min,
                                        float inv_depth_interval,
                                        void* stream) {
  return launch<float>(vol, zi, x, y, z, out, B, D, H, W, Wo, C, depth_min,
                       inv_depth_interval, stream);
}

extern "C" int frustum_warp_exact_z_bf16(const void* vol, const void* zi,
                                         const void* x, const void* y,
                                         const void* z, void* out, int B,
                                         int D, int H, int W, int Wo, int C,
                                         float depth_min,
                                         float inv_depth_interval,
                                         void* stream) {
  return launch<__nv_bfloat16>(vol, zi, x, y, z, out, B, D, H, W, Wo, C,
                               depth_min, inv_depth_interval, stream);
}
