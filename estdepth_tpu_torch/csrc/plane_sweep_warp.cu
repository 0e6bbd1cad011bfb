// Plane-sweep warp (kernel 1 of the port), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/plane_warp.py:plane_sweep_warp_pallas
// (_psweep_impl -> _two_pass, kernels _make_pass1_kernel / _make_pass2_kernel).
//
// Computes: out[b, d, i, j, :] = bilinear(src[b], x[b, v], y[b, v]) with
// v = (d*H + i)*Wo + j (Wo the output's columns: W for the whole sweep,
// fewer for a width shard's own columns), the stacked-sampler corner rules of
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
// Bound on the card: bytes. At the ESTM step (src [2, 64, 80, 32] f32,
// D = 64) it writes an 84 MB output and reads 2.6 MB of x/y and 1.3 MB of
// source, about 27 us at 3.35 TB/s; the arithmetic is ~10 flops per output
// value. The body is csrc/sweep_gather.cuh: a slab is one batch entry's
// D*H*W voxels, a voxel's Taps are its corners (y0, x0), (y0, x0 + 1),
// (y0 + 1, x0), (y0 + 1, x0 + 1) with one x fraction for both rows, and
// the blend is lerp(lerp(v00, v01, wx), lerp(v10, v11, wx), wy). The index
// math, the mask and the corner rules run once per voxel, not once per
// vector, and the volume is written with evict-first stores. A slab is
// the output's D*H*Wo voxels and its map the source's H*W pixels: the body
// finds a voxel's corners from its own (x, y) alone, so a window of Wo < W
// columns (parallel/spatial.py) writes exactly those columns of the whole
// sweep.
//
// Two instances of one body: plane_sweep_warp_f32 and plane_sweep_warp_bf16
// (a bfloat16 map and volume, float32 coordinates; the blend in float32,
// each value rounded once to bfloat16: csrc/vec16.cuh). In bfloat16 the
// volume's bytes halve and the coordinates' do not: at the ESTM step it
// writes 42 MB and reads the same 5.2 MB of x and y and 0.7 MB of source,
// about 14 us at 3.35 TB/s.

#include "sweep_gather.cuh"

namespace {

template <typename Index>
struct SweepTaps {
  int H, W, CV;
  Index down;  // vectors from a row to the next (0 when H == 1)

  __device__ __forceinline__ sweep::Taps<Index> operator()(
      int, long long, float x, float y) const {
    sweep::Taps<Index> t;
    if (sweep::inside(x, y, H, W)) {
      int x0, y0;
      sweep::corner(x, W, x0, t.fu);
      sweep::corner(y, H, y0, t.fy);
      t.upper = (static_cast<Index>(y0) * W + x0) * CV;
      t.lower = t.upper + down;
    }
    return t;
  }
};

template <typename T, int CVT, typename Index>
__global__ void __launch_bounds__(sweep::kThreads)
plane_sweep_warp_kernel(const typename vec16::Vec<T>::Raw* __restrict__ src,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        typename vec16::Vec<T>::Raw* __restrict__ out,
                        sweep::Shape s) {
  const SweepTaps<Index> taps{
      s.H, s.W, s.CV, s.H > 1 ? static_cast<Index>(s.W) * s.CV : Index{0}};
  sweep::gather_volume<T, false, CVT, Index>(src, xs, ys, out, s, taps);
}

template <typename T>
struct Launch {
  using Raw = typename vec16::Vec<T>::Raw;
  const Raw* src;
  const float *xs, *ys;
  Raw* out;
  sweep::Shape s;
  unsigned blocks;
  cudaStream_t stream;

  template <int CVT, typename Index>
  void run() const {
    plane_sweep_warp_kernel<T, CVT, Index>
        <<<blocks, sweep::kThreads, 0, stream>>>(src, xs, ys, out, s);
  }
};

template <typename T>
int launch(const void* src, const void* x, const void* y, void* out, int B,
           int D, int H, int W, int Wo, int C, void* stream) {
  using Raw = typename vec16::Vec<T>::Raw;
  const long long voxels = static_cast<long long>(D) * H * Wo;
  if (B == 0 || voxels == 0 || C == 0) return 0;
  sweep::Shape s;
  const unsigned blocks = sweep::plan(B, voxels, s);
  s.slabs_per_map = 1;
  s.H = H;
  s.W = W;
  s.CV = C / vec16::Vec<T>::kLanes;
  s.right = W > 1 ? s.CV : 0;  // x0 + 1 is clamped to W - 1
  const Launch<T> run{static_cast<const Raw*>(src),
                      static_cast<const float*>(x),
                      static_cast<const float*>(y), static_cast<Raw*>(out), s,
                      blocks, static_cast<cudaStream_t>(stream)};
  sweep::dispatch(s.CV, static_cast<long long>(H) * W * s.CV, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [B, H, W, C], x/y [B, D, H, Wo] float32, out [B, D, H, Wo, C] of
// src's type; contiguous, C a multiple of 4 (float32) or 8 (bfloat16),
// checked by the Python wrapper. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int plane_sweep_warp_f32(const void* src, const void* x,
                                    const void* y, void* out, int B, int D,
                                    int H, int W, int Wo, int C,
                                    void* stream) {
  return launch<float>(src, x, y, out, B, D, H, W, Wo, C, stream);
}

extern "C" int plane_sweep_warp_bf16(const void* src, const void* x,
                                     const void* y, void* out, int B, int D,
                                     int H, int W, int Wo, int C,
                                     void* stream) {
  return launch<__nv_bfloat16>(src, x, y, out, B, D, H, W, Wo, C, stream);
}
