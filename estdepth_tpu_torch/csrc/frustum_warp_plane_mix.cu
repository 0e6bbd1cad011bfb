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
// index of each CORNER, the hard mask on the exact (x, y) of the VOXEL.
// zi [B, D, H*W] is the per-(target plane, source pixel) index field the
// wrapper's caller computes in PyTorch (ops/warp_exact_z.zi_field), with
// its -2 sentinel behind the camera, which the window test rejects.
//
// The TPU version mixes z for every (plane, source pixel) into an
// intermediate in device memory, transposes it and resamples it in two
// passes at row crossings, because Mosaic gathers only along lanes. Here
// no intermediate reaches device memory: the body (csrc/frustum_gather.cuh)
// gives each block of 16 x 8 voxels of one plane, a lane per voxel, and
// every vector of a voxel gathers and mixes its four corners' taps and
// blends them at the exact (x, y), the plain version's
// (ops/cuda/plane_mix.plane_mix_resample_plain) operations in its order,
// each rounded on its own (no FMA contraction).
//
// Bound on the card: bytes. At the Joint window's shapes (V [3, 64, 64,
// 80, 32] f32) the kernel must read the 125.8 MB volume once and write as
// much, plus 3 x 3.93 MB of zi, x and y: 263.5 MB, about 78.6 us at 3.35
// TB/s. In bfloat16 the volume and the output halve (62.9 MB each) and the
// 11.8 MB of zi, x and y do not: 137.6 MB, about 41.1 us. Corners outside
// the window and voxels outside the image read no taps.
//
// Two instances of one body: frustum_warp_plane_mix_f32 and
// frustum_warp_plane_mix_bf16 (csrc/vec16.cuh: mixed and blended in
// float32, a bfloat16 result rounded once, where the TPU kernels also round
// the z-mixed intermediate and the first resample pass to bf16).

#include "frustum_gather.cuh"

namespace {

struct PlaneMix {
  static constexpr int kValues = 1;  // M
  static constexpr bool kUsesZc = false;
  int Z;

  __device__ __forceinline__ bool voxel(long long, int, float&) const {
    return true;
  }

  __device__ __forceinline__ float z0(float q, int Z) const {
    return fminf(fmaxf(floorf(q), 0.0f),
                 fmaxf(static_cast<float>(Z - 2), 0.0f));
  }

  // the eps-padded window of a corner's plane index
  __device__ __forceinline__ bool loads(float q) const {
    return q >= -frustum::kEps &&
           q <= static_cast<float>(Z - 1) + frustum::kEps;
  }

  // two hat-weighted taps at the corner's own plane index, 0 outside
  template <int L>
  __device__ __forceinline__ void values(const float (&v0)[L],
                                         const float (&v1)[L], float q,
                                         float z0, float (&out)[1][L]) const {
    if (!loads(q)) {
#pragma unroll
      for (int l = 0; l < L; ++l) out[0][l] = 0.0f;
      return;
    }
    const float w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(q, z0))), 0.0f);
    const float w1 = fmaxf(
        __fsub_rn(1.0f, fabsf(__fsub_rn(q, __fadd_rn(z0, 1.0f)))), 0.0f);
#pragma unroll
    for (int l = 0; l < L; ++l)
      out[0][l] = __fadd_rn(__fmul_rn(w0, v0[l]), __fmul_rn(w1, v1[l]));
  }

  __device__ __forceinline__ float finish(const float (&t)[1], float) const {
    return t[0];
  }
};

template <typename T>
int launch(const void* vol, const void* zi, const void* x, const void* y,
           void* out, int B, int D, int H, int W, int C, void* stream) {
  return frustum::launch<T>(vol, zi, x, y, out, B, D, H, W, C, PlaneMix{D},
                            stream);
}

}  // namespace

// vol [B, D, H, W, C], out like vol; zi [B, D, H*W] and x/y [B, D*H*W]
// float32; contiguous, C a multiple of 4 (float32) or 8 (bfloat16), D >= 2
// (checked by the Python wrapper). Launches on `stream` and returns the
// launch's CUDA error (cudaGetLastError()).
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
