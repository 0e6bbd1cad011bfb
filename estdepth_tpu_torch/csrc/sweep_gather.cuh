// Shared body of the port's two plane-sweep gathers, CUDA C++ for sm_90a:
// kernel 1 (csrc/plane_sweep_warp.cu) and kernel 3
// (csrc/two_pass_resample.cu).
//
// Both write a volume of slabs [S, N voxels, C] (kernel 1: one batch
// entry's D planes; kernel 3: one plane) from a source map [H, W, C] per
// slab or group of slabs (a slab's voxels need not lie on its map's grid:
// both write a window of a map's columns for a width shard), in float32
// or bfloat16 (the element type T, one body for both: csrc/vec16.cuh).
// Every output voxel is a blend of four corners of its map: a left and a
// right one on an upper row and on a lower row, a fraction along each row
// and one between the rows, or zero where its exact (x, y) leaves the
// image. The kernels differ only in how a voxel finds its corners (its
// Taps) and in the blend's formula.
//
// Both are bound by the bytes they store: the volume is C / 2 times larger
// than the x and y they read, and the source map stays in L2. The layout of
// the work keeps the instructions per stored byte low:
// - A block of kWarps warps owns kBlockVoxels consecutive voxels of one
//   slab. It finds its slab with one 32-bit division and its 64-bit base
//   offsets once; a lane's offsets from those bases are 32-bit wherever the
//   map holds fewer than 2^31 vectors (`Index`), else 64-bit.
// - A lane owns one voxel of each of its warp's kGroups groups of 32. It
//   loads x and y, tests validity, applies the corner rules and keeps the
//   voxel's Taps in registers: once per voxel, not once per vector.
// - The warp then writes a group's 32 * CV 16-byte vectors (CV = C / 4 in
//   float32, C / 8 in bfloat16; a template constant for CV = 1, 2, 4, 8,
//   16) in CV steps: in step i lane l writes vector f = 32 i + l, channel
//   block f % CV of voxel f / CV, whose Taps it takes from the voxel's owner
//   with __shfl_sync. Each step is one coalesced 512-byte store; kUnroll
//   steps keep 4 * kUnroll gathers of a lane in flight before their
//   stores. A bfloat16 vector is blended as 8 floats and rounded once.
// - Gathers are __ldg (the read-only path; the map is re-read from L1 and
//   L2 by neighbouring voxels and planes), stores __stcs (evict-first), so
//   the write-once volume does not push the map out of L2.
// Every add and multiply is rounded on its own (_rn intrinsics, no FMA
// contraction), so each kernel is its plain PyTorch version bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "vec16.cuh"

namespace sweep {

constexpr int kWarps = 4;   // warps per block
constexpr int kGroups = 2;  // groups of 32 voxels per warp
constexpr int kUnroll = 4;  // vectors per lane between loads and stores
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockVoxels = 32 * kGroups * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The stacked-sampler corner rule of ops/sampling.py: clip the coordinate
// to [0, size-1] and the base index to [0, size-2], the fraction against
// the clipped coordinate.
__device__ __forceinline__ void corner(float q, int size, int& i0,
                                       float& frac) {
  const float qc = fminf(fmaxf(q, 0.0f), static_cast<float>(size - 1));
  const float base = fminf(fmaxf(floorf(qc), 0.0f),
                           fmaxf(static_cast<float>(size - 2), 0.0f));
  i0 = static_cast<int>(base);
  frac = qc - base;
}

// The hard mask of both samplers, at the exact (unclipped) coordinate.
__device__ __forceinline__ bool inside(float x, float y, int H, int W) {
  return x >= 0.0f && x <= static_cast<float>(W - 1) && y >= 0.0f &&
         y <= static_cast<float>(H - 1);
}

// a + t * (b - a): ops/sampling.bilinear_sample's blend (kernel 1)
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// g0 * (1 - f) + g1 * f: two_pass_resample_plain's blend (kernel 3)
__device__ __forceinline__ float mix(float g0, float g1, float f) {
  return __fadd_rn(__fmul_rn(g0, __fsub_rn(1.0f, f)), __fmul_rn(g1, f));
}

template <bool kMix>
__device__ __forceinline__ float blend(float a, float b, float t) {
  if constexpr (kMix)
    return mix(a, b, t);
  else
    return lerp(a, b, t);
}

// A voxel's vector from its four corner vectors (upper left, upper right,
// lower left, lower right): each row blended at its fraction, then the
// two rows at fy, lane by lane in float32; a bfloat16 result rounded once.
template <typename T, bool kMix>
__device__ __forceinline__ typename vec16::Vec<T>::Raw blend_corners(
    const typename vec16::Vec<T>::Raw (&c)[4], float fu, float fl,
    float fy) {
  using V = vec16::Vec<T>;
  float v[4][V::kLanes], out[V::kLanes];
#pragma unroll
  for (int k = 0; k < 4; ++k) V::unpack(c[k], v[k]);
#pragma unroll
  for (int l = 0; l < V::kLanes; ++l)
    out[l] = blend<kMix>(blend<kMix>(v[0][l], v[1][l], fu),
                         blend<kMix>(v[2][l], v[3][l], fl), fy);
  return V::pack(out);
}

// One voxel's corners: vector offsets in its map of the left corner on the
// upper and on the lower row (upper < 0: the voxel is zero), the fraction
// along each row and the one between them.
template <typename Index>
struct Taps {
  Index upper = -1, lower = 0;
  float fu = 0.0f, fl = 0.0f, fy = 0.0f;
};

// Block-uniform sizes. A map serves `slabs_per_map` consecutive slabs.
struct Shape {
  long long voxels;  // per slab
  int blocks_per_slab, slabs_per_map, H, W;
  int CV;     // 16-byte vectors per voxel
  int right;  // vectors from a left corner to its right neighbour
};

// The body of both kernels over element type T (float or __nv_bfloat16).
// kTwoPass: a fraction per row and mix() (kernel 3); else one fraction
// along x for both rows and lerp() (kernel 1), so `fl` is not exchanged.
// CVT: the vectors per voxel, or 0 for any CV (read from `s`).
// make(slab, voxel in slab, x, y) -> Taps<Index>.
template <typename T, bool kTwoPass, int CVT, typename Index,
          class MakeTaps>
__device__ __forceinline__ void gather_volume(
    const typename vec16::Vec<T>::Raw* __restrict__ src,
    const float* __restrict__ xs, const float* __restrict__ ys,
    typename vec16::Vec<T>::Raw* __restrict__ out, const Shape& s,
    const MakeTaps& make) {
  using Raw = typename vec16::Vec<T>::Raw;
  const int CV = CVT > 0 ? CVT : s.CV;
  // whether a step of kUnroll can pass CV (known at compile time for CVT)
  constexpr bool kRagged = CVT == 0 || CVT % kUnroll != 0;
  const int slab = blockIdx.x / s.blocks_per_slab;
  const long long v0 =
      static_cast<long long>(blockIdx.x - slab * s.blocks_per_slab) *
      kBlockVoxels;
  const long long first = slab * s.voxels + v0;
  const Raw* map = src + static_cast<long long>(slab / s.slabs_per_map) *
                             s.H * s.W * CV;
  xs += first;
  ys += first;
  out += first * CV;
  const long long left = s.voxels - v0;  // voxels of the slab from v0 on
  const int lane = threadIdx.x & 31;
  const int warp_first = (threadIdx.x >> 5) * kGroups * 32;

  Taps<Index> own[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int v = warp_first + 32 * g + lane;
    if (v < left) own[g] = make(slab, v0 + v, __ldg(xs + v), __ldg(ys + v));
  }

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int v = warp_first + 32 * g;
    if (v >= left) break;  // the same for the whole warp
    const int stored = static_cast<int>(left - v < 32 ? left - v : 32) * CV;
    Raw* dst = out + static_cast<Index>(v) * CV;
#pragma unroll 1
    for (int i0 = 0; i0 < CV; i0 += kUnroll) {
      Raw c[kUnroll][4];
      float fu[kUnroll], fl[kUnroll], fy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kRagged && i0 + u >= CV) break;  // the same for the whole warp
        const int f = 32 * (i0 + u) + lane;
        const int owner = f / CV;
        const int cb = f - owner * CV;
        const Index upper = __shfl_sync(kFull, own[g].upper, owner);
        const Index lower = __shfl_sync(kFull, own[g].lower, owner);
        fu[u] = __shfl_sync(kFull, own[g].fu, owner);
        fl[u] = kTwoPass ? __shfl_sync(kFull, own[g].fl, owner) : fu[u];
        fy[u] = __shfl_sync(kFull, own[g].fy, owner);
        // a voxel outside blends four zero corners with zero fractions: 0
        const Raw zero{};
        c[u][0] = c[u][1] = c[u][2] = c[u][3] = zero;
        if (upper >= 0) {
          c[u][0] = __ldg(map + upper + cb);
          c[u][1] = __ldg(map + upper + cb + s.right);
          c[u][2] = __ldg(map + lower + cb);
          c[u][3] = __ldg(map + lower + cb + s.right);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kRagged && i0 + u >= CV) break;
        const int f = 32 * (i0 + u) + lane;
        if (f < stored)
          __stcs(dst + f,
                 blend_corners<T, kTwoPass>(c[u], fu[u], fl[u], fy[u]));
      }
    }
  }
}

// Calls launch.template run<CVT, Index>() with the instance for this CV:
// 32-bit offsets and a compile-time CV for CV = 1, 2, 4, 8, 16 (C = 4 to 64
// in float32, 8 to 128 in bfloat16) where a map holds fewer than 2^31
// vectors, else the generic instance (any CV, 64-bit offsets).
template <class Launch>
void dispatch(int CV, long long map_vectors, const Launch& launch) {
  if (map_vectors < INT_MAX) {
    switch (CV) {
      case 1: return launch.template run<1, int>();
      case 2: return launch.template run<2, int>();
      case 4: return launch.template run<4, int>();
      case 8: return launch.template run<8, int>();
      case 16: return launch.template run<16, int>();
      default: break;
    }
  }
  launch.template run<0, long long>();
}

// Fills in s.voxels and s.blocks_per_slab for `slabs` slabs of `voxels`
// each; returns the number of blocks.
inline unsigned plan(long long slabs, long long voxels, Shape& s) {
  s.voxels = voxels;
  s.blocks_per_slab =
      static_cast<int>((voxels + kBlockVoxels - 1) / kBlockVoxels);
  return static_cast<unsigned>(s.blocks_per_slab * slabs);
}

}  // namespace sweep
