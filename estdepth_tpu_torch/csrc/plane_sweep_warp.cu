// Plane-sweep warp (kernel 1 of the ESTM step), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp.py:plane_sweep_warp_pallas
// (_psweep_impl -> _two_pass, kernels _make_pass1_kernel / _make_pass2_kernel).
//
// Computes: out[b, d, i, j, :] = bilinear(src[b], x[b, v], y[b, v]) with
// v = (d*H + i)*W + j, the stacked-sampler corner rules of
// ops/sampling.py (clip the coordinate to [0, size-1], the base index to
// [0, size-2], the fraction against the clipped coordinate) and a hard zero
// where the unclipped (x, y) leaves [0, W-1] x [0, H-1].
//
// The TPU kernel approximates this with a two-pass row-crossing resample
// because Mosaic cannot gather across a 128-lane vreg. Hopper gathers
// freely, so this kernel samples the four corners directly at the exact
// (x, y): the function the two-pass form approximates, identical in its
// arithmetic to the plain PyTorch version (ops/sampling.bilinear_sample).
//
// Bound on the card: bytes. At the flagship step (src [2, 64, 80, 32] f32,
// D = 64) it writes an 84 MB output and reads 2.6 MB of x/y and 1.3 MB of
// source, about 27 us at 3.35 TB/s; the arithmetic is ~10 flops per output
// value. The design keeps the traffic at that minimum: one thread per
// (voxel, 4 channels) so each thread stores one float4 and a warp stores
// 512 contiguous bytes; the four corner gathers are float4 loads from a
// 1.3 MB source that stays in L2; x/y are read once per thread (the eight
// threads of a voxel share the same cache line).

#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t),
                     lerp(a.w, b.w, t));
}

__global__ void plane_sweep_warp_kernel(const float4* __restrict__ src,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ ys,
                                        float4* __restrict__ out, int D,
                                        int H, int W, int C4,
                                        long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c4 = static_cast<int>(t % C4);
  const long long v = t / C4;  // voxel index over [B, D, H, W]
  const long long per_batch = static_cast<long long>(D) * H * W;
  const long long b = v / per_batch;
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
  const float4* base = src + b * H * W * C4 + c4;
  const float4 v00 = __ldg(base + (static_cast<long long>(y0) * W + x0) * C4);
  const float4 v01 = __ldg(base + (static_cast<long long>(y0) * W + x1) * C4);
  const float4 v10 = __ldg(base + (static_cast<long long>(y1) * W + x0) * C4);
  const float4 v11 = __ldg(base + (static_cast<long long>(y1) * W + x1) * C4);
  out[t] = lerp4(lerp4(v00, v01, wx), lerp4(v10, v11, wx), wy);
}

}  // namespace

// src [B, H, W, C], x/y [B, D*H*W], out [B, D, H, W, C]; all f32,
// contiguous, C % 4 == 0 (checked by the Python wrapper). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int plane_sweep_warp_f32(const void* src, const void* x,
                                    const void* y, void* out, int B, int D,
                                    int H, int W, int C, void* stream) {
  const int c4 = C / 4;
  const long long total = static_cast<long long>(B) * D * H * W * c4;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  plane_sweep_warp_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<float4*>(out), D, H, W, c4,
      total);
  return static_cast<int>(cudaGetLastError());
}
