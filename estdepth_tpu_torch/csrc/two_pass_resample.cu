// Fused two-pass resample (kernel 3 of the port), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp.py:_two_pass, the fused
// branch (ESTDEPTH_FUSED_WARP=1, kernel body _make_fused_pass_kernel).
//
// Computes, for output plane p reading source map m = p / planes_per_map:
//   pass 1  j[h, w, :]  = lerp(src[m, h, x0, :], src[m, h, x0 + 1, :], f)
//           (x0, f)     = corner(a[p, w] * h + b[p, w], W)   clamped, no mask
//   pass 2  out[p, i, w, :] = valid * lerp(j[y0, w, :], j[y0 + 1, w, :], f2)
//           (y0, f2)    = corner(y[p, i, w], H)
//           valid       = 0 <= y <= H-1 and 0 <= x <= W-1 at the exact (x, y)
// with lerp(g0, g1, f) = g0 * (1 - f) + g1 * f and the stacked-sampler
// corner rules (clip the coordinate to [0, size-1], the base index to
// [0, size-2], the fraction against the clipped coordinate). Column w of a
// target plane maps to a source line x = a*y + b; pass 1 resamples every
// source row along that line, pass 2 picks the row.
//
// The TPU kernel loops over channels and transposes [H, W] -> [W, H]
// between the passes because Mosaic gathers along lanes only. Here one
// thread block owns (plane, block of 8 or 4 channels): pass 1 writes the
// image j[H, W, cblk] into dynamic shared memory, a barrier, and pass 2
// gathers rows y0 and y0 + 1 from it. Nothing is transposed and the pass-1
// image never reaches device memory.
//
// Bound on the card: bytes. At the training window's plane sweep (6 maps
// of [64, 80, 32] f32, 64 planes each) it writes a 252 MB output and reads
// 16 MB of x/y, 0.25 MB of line coefficients and 3.9 MB of source: about
// 81 us at 3.35 TB/s; each output value costs ~8 flops. The design keeps
// the traffic at that minimum: the 64 planes of a map are neighbouring
// blocks and re-read the map from L2; a thread moves float4s, and with 8
// channels per block a pixel's loads and stores fill whole 32-byte sectors.
// j takes H*W*cblk*4 bytes (160 KB at 64x80x8), over the 48 KB default, so
// the entry raises the kernel's dynamic shared-memory limit first and
// returns the error if the card cannot give that much.
//
// Every multiply and add is rounded on its own (_rn intrinsics, no FMA
// contraction), so the result is the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void corner(float q, int size, int& i0,
                                       float& frac) {
  const float qc = fminf(fmaxf(q, 0.0f), static_cast<float>(size - 1));
  const float base = fminf(fmaxf(floorf(qc), 0.0f),
                           fmaxf(static_cast<float>(size - 2), 0.0f));
  i0 = static_cast<int>(base);
  frac = qc - base;
}

// g0 * (1 - f) + g1 * f, each operation rounded on its own
__device__ __forceinline__ float mix(float g0, float g1, float f) {
  return __fadd_rn(__fmul_rn(g0, __fsub_rn(1.0f, f)), __fmul_rn(g1, f));
}

__device__ __forceinline__ float4 mix4(float4 a, float4 b, float f) {
  return make_float4(mix(a.x, b.x, f), mix(a.y, b.y, f), mix(a.z, b.z, f),
                     mix(a.w, b.w, f));
}

// V4: float4s per pixel in one block (cblk / 4). Grid: (C / cblk) * P
// blocks, the channel block fastest.
template <int V4>
__global__ void __launch_bounds__(kThreads)
two_pass_resample_kernel(const float4* __restrict__ src,
                         const float* __restrict__ ab,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         float4* __restrict__ out, int H, int W, int C4,
                         int planes_per_map) {
  extern __shared__ float4 j[];  // [H, W, V4]
  const int blocks_per_plane = C4 / V4;
  const int p = blockIdx.x / blocks_per_plane;
  const int c0 = (blockIdx.x % blocks_per_plane) * V4;
  const int m = p / planes_per_map;
  const int items = H * W * V4;
  const float* a = ab + static_cast<long long>(p) * 2 * W;
  const float* b = a + W;
  const float4* map = src + static_cast<long long>(m) * H * W * C4 + c0;

  for (int t = threadIdx.x; t < items; t += kThreads) {
    const int v = t % V4;
    const int pix = t / V4;
    const int h = pix / W;
    const int w = pix - h * W;
    const float xq =
        __fadd_rn(__fmul_rn(__ldg(a + w), static_cast<float>(h)), __ldg(b + w));
    int x0;
    float f;
    corner(xq, W, x0, f);
    const float4* row = map + (static_cast<long long>(h) * W + x0) * C4 + v;
    j[t] = mix4(__ldg(row), __ldg(row + C4), f);
  }
  __syncthreads();

  const long long plane = static_cast<long long>(p) * H * W;
  for (int t = threadIdx.x; t < items; t += kThreads) {
    const int v = t % V4;
    const int pix = t / V4;
    const int w = pix % W;
    const float x = __ldg(xs + plane + pix);
    const float y = __ldg(ys + plane + pix);
    const bool valid = y >= 0.0f && y <= static_cast<float>(H - 1) &&
                       x >= 0.0f && x <= static_cast<float>(W - 1);
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (valid) {
      int y0;
      float f2;
      corner(y, H, y0, f2);
      const int at = (y0 * W + w) * V4 + v;
      r = mix4(j[at], j[at + W * V4], f2);
    }
    out[(plane + pix) * C4 + c0 + v] = r;
  }
}

template <int V4>
cudaError_t launch(const float4* src, const float* ab, const float* x,
                   const float* y, float4* out, int P, int H, int W, int C4,
                   int planes_per_map, size_t shared, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      two_pass_resample_kernel<V4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the return value
    return err;
  }
  two_pass_resample_kernel<V4>
      <<<static_cast<unsigned int>(P) * (C4 / V4), kThreads, shared, stream>>>(
          src, ab, x, y, out, H, W, C4, planes_per_map);
  return cudaGetLastError();
}

}  // namespace

// src [M, H, W, C], ab [P, 2, W], x/y [P, H*W], out [P, H, W, C]; all f32,
// contiguous, C % 4 == 0, H, W >= 2, P == M * planes_per_map (checked by
// the Python wrapper). Launches on `stream` and returns the CUDA error
// code, non-zero also when H*W*cblk floats exceed the shared memory a
// block may ask for.
extern "C" int two_pass_resample_f32(const void* src, const void* ab,
                                     const void* x, const void* y, void* out,
                                     int P, int H, int W, int C,
                                     int planes_per_map, void* stream) {
  if (P == 0) return 0;
  int device = 0, max_shared = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_shared, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c4 = C / 4;
  const size_t pixels = static_cast<size_t>(H) * W;
  const auto s = static_cast<const float4*>(src);
  const auto o = static_cast<float4*>(out);
  const auto fab = static_cast<const float*>(ab);
  const auto fx = static_cast<const float*>(x);
  const auto fy = static_cast<const float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  // 8 channels per block where they fit, else 4; if 4 do not fit either,
  // cudaFuncSetAttribute refuses and its error is returned
  if (c4 % 2 == 0 && pixels * 32 <= static_cast<size_t>(max_shared))
    err = launch<2>(s, fab, fx, fy, o, P, H, W, c4, planes_per_map,
                    pixels * 32, st);
  else
    err = launch<1>(s, fab, fx, fy, o, P, H, W, c4, planes_per_map,
                    pixels * 16, st);
  return static_cast<int>(err);
}
