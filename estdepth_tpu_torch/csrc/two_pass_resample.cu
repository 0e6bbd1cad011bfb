// Fused two-pass resample (kernel 3 of the port), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp.py:_two_pass, the fused
// branch (ESTDEPTH_FUSED_WARP=1, kernel body _make_fused_pass_kernel).
//
// Computes, for output plane p reading source map m = p / planes_per_map:
//   pass 1  j[h, w, :]  = mix(src[m, h, x0, :], src[m, h, x0 + 1, :], f)
//           (x0, f)     = corner(a[p, w] * h + b[p, w], W)   clamped, no mask
//   pass 2  out[p, i, w, :] = valid * mix(j[y0, w, :], j[y0 + 1, w, :], f2)
//           (y0, f2)    = corner(y[p, i, w], H)
//           valid       = 0 <= y <= H-1 and 0 <= x <= W-1 at the exact (x, y)
// with mix(g0, g1, f) = g0 * (1 - f) + g1 * f and the stacked-sampler
// corner rules (clip the coordinate to [0, size-1], the base index to
// [0, size-2], the fraction against the clipped coordinate). Column w of a
// target plane maps to a source line x = a*y + b; pass 1 resamples every
// source row along that line, pass 2 picks the row.
//
// The TPU kernel loops over channels and transposes [H, W] -> [W, H]
// between the passes because Mosaic gathers along lanes only. Hopper
// gathers freely, and pass 2 at (i, w) reads only column w of the pass-1
// image, at rows y0 and y0 + 1. So each output voxel is computed directly
// from four gathers of its source map, with no pass-1 image: for
// h = y0 and h = y0 + 1, (x0_h, f_h) = corner(a[p, w] * h + b[p, w], W)
// and j_h = mix(src[m, h, x0_h], src[m, h, x0_h + 1], f_h), then
// out = mix(j_y0, j_y0+1, f2). These are the operations pass 1 and pass 2
// do for that voxel, in the same order, each rounded on its own: the
// result is the two passes' bit for bit, and equals the plain PyTorch
// version (ops/cuda/two_pass.two_pass_resample_plain), which keeps the two
// passes. Rows pass 1 would resample and pass 2 never reads are skipped.
//
// Output window. The line coefficients and coordinates name the output
// grid: ab [P, 2, Wo] and x/y [P, H*Wo] are Wo columns, the source's own W
// or a width shard's window of them (parallel/spatial.py), whose
// coefficients are those of the columns' global indices. A voxel's column
// w = voxel % Wo indexes ab; its taps address the whole source map, whose
// rows stride by W. So a window is exactly those columns of the whole
// output, as kernel 1's.
//
// Bound on the card: bytes. At the training window's plane sweep (6 maps
// of [64, 80, 32] f32, 64 planes each) it writes a 252 MB output and reads
// 16 MB of x/y, 0.25 MB of line coefficients and 3.9 MB of source: about
// 81 us at 3.35 TB/s; each output value costs ~9 flops. The body is
// csrc/sweep_gather.cuh, as kernel 1's: a slab is one plane's H*W voxels,
// a voxel's Taps are its two rows' left corners with a fraction per row,
// and it needs no shared memory, no barrier and no limit on H and W
// (>= 2, checked by the wrapper).
//
// Two instances of one body: two_pass_resample_f32 and
// two_pass_resample_bf16 (a bfloat16 map and volume, float32 coefficients
// and coordinates; both passes in float32 and each value rounded once to
// bfloat16, csrc/vec16.cuh, where the TPU kernel also rounds its pass-1
// image). In bfloat16 the training window's sweep writes 126 MB: with the
// same 16 MB of x/y, about 43 us at 3.35 TB/s.

#include "sweep_gather.cuh"

namespace {

template <typename Index>
struct TwoPassTaps {
  const float* ab;  // [P, 2, Wo]: a then b of each plane's output columns
  int H, W, Wo, CV;  // the source grid H x W; Wo output columns

  __device__ __forceinline__ sweep::Taps<Index> operator()(
      int plane, long long voxel, float x, float y) const {
    sweep::Taps<Index> t;
    if (sweep::inside(x, y, H, W)) {
      const int w = static_cast<int>(static_cast<Index>(voxel) % Wo);
      const float* a = ab + static_cast<long long>(plane) * 2 * Wo + w;
      const float aw = __ldg(a), bw = __ldg(a + Wo);
      int y0, xu, xl;
      sweep::corner(y, H, y0, t.fy);
      sweep::corner(__fadd_rn(__fmul_rn(aw, static_cast<float>(y0)), bw), W,
                    xu, t.fu);
      sweep::corner(
          __fadd_rn(__fmul_rn(aw, static_cast<float>(y0 + 1)), bw), W, xl,
          t.fl);
      t.upper = (static_cast<Index>(y0) * W + xu) * CV;
      t.lower = (static_cast<Index>(y0 + 1) * W + xl) * CV;
    }
    return t;
  }
};

template <typename T, int CVT, typename Index>
__global__ void __launch_bounds__(sweep::kThreads)
two_pass_resample_kernel(const typename vec16::Vec<T>::Raw* __restrict__ src,
                         const float* __restrict__ ab,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         typename vec16::Vec<T>::Raw* __restrict__ out,
                         sweep::Shape s, int Wo) {
  const TwoPassTaps<Index> taps{ab, s.H, s.W, Wo, s.CV};
  sweep::gather_volume<T, true, CVT, Index>(src, xs, ys, out, s, taps);
}

template <typename T>
struct Launch {
  using Raw = typename vec16::Vec<T>::Raw;
  const Raw* src;
  const float *ab, *xs, *ys;
  Raw* out;
  sweep::Shape s;
  int Wo;
  unsigned blocks;
  cudaStream_t stream;

  template <int CVT, typename Index>
  void run() const {
    two_pass_resample_kernel<T, CVT, Index>
        <<<blocks, sweep::kThreads, 0, stream>>>(src, ab, xs, ys, out, s,
                                                 Wo);
  }
};

template <typename T>
int launch(const void* src, const void* ab, const void* x, const void* y,
           void* out, int P, int H, int W, int Wo, int C, int planes_per_map,
           void* stream) {
  using Raw = typename vec16::Vec<T>::Raw;
  const long long voxels = static_cast<long long>(H) * Wo;
  if (P == 0 || voxels == 0 || C == 0) return 0;
  sweep::Shape s;
  const unsigned blocks = sweep::plan(P, voxels, s);
  s.slabs_per_map = planes_per_map;
  s.H = H;
  s.W = W;
  s.CV = C / vec16::Vec<T>::kLanes;
  s.right = s.CV;
  const Launch<T> run{static_cast<const Raw*>(src),
                      static_cast<const float*>(ab),
                      static_cast<const float*>(x),
                      static_cast<const float*>(y), static_cast<Raw*>(out), s,
                      Wo, blocks, static_cast<cudaStream_t>(stream)};
  sweep::dispatch(s.CV, static_cast<long long>(H) * W * s.CV, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [M, H, W, C], ab [P, 2, Wo], x/y [P, H*Wo] float32, out
// [P, H, Wo, C] of src's type; contiguous, C a multiple of 4 (float32) or
// 8 (bfloat16), H, W >= 2, P == M * planes_per_map (checked by the Python
// wrapper). Launches on `stream` and returns cudaGetLastError().
extern "C" int two_pass_resample_f32(const void* src, const void* ab,
                                     const void* x, const void* y, void* out,
                                     int P, int H, int W, int Wo, int C,
                                     int planes_per_map, void* stream) {
  return launch<float>(src, ab, x, y, out, P, H, W, Wo, C, planes_per_map,
                       stream);
}

extern "C" int two_pass_resample_bf16(const void* src, const void* ab,
                                      const void* x, const void* y,
                                      void* out, int P, int H, int W, int Wo,
                                      int C, int planes_per_map,
                                      void* stream) {
  return launch<__nv_bfloat16>(src, ab, x, y, out, P, H, W, Wo, C,
                               planes_per_map, stream);
}
