// Shared body of the port's two frustum warps, CUDA C++ for sm_90a:
// kernel 2 (csrc/frustum_warp_exact_z.cu) and kernel 4
// (csrc/frustum_warp_plane_mix.cu).
//
// Both write a volume [B, D, H, W, C] whose voxel (b, d, i, j) is a
// bilinear blend of four corner pixels of the source (x0, y0), (x0 + 1, y0),
// (x0, y0 + 1), (x0 + 1, y0 + 1) of its exact source (x, y) (the stacked
// sampler's corner rules), zero where (x, y) leaves the image. Each corner c
// is a 2-tap gather along z at its own plane index q = zi[b, d, c]: the
// taps V[b, z0, c, :] and V[b, z0 + 1, c, :] with z0 a cell of q. The
// kernels differ only in what a corner's values are (kernel 2: A and s;
// kernel 4: the hat-mixed M, zero outside its window), in the blend's
// formula (kernel 2 adds zc * s~) and in a voxel's own validity (kernel 2:
// its z-window). An `Op` (each kernel's source) supplies those; this header
// is the rest.
//
// Both are bound by bytes (each kernel's source states its bound): the
// volume is read once and a volume as large written, beside float32
// coordinates. What held the one-thread-per-vector kernels they replace
// back was the work around the bytes: every thread redid its voxel's
// set-up (coordinates, mask, corner rules, four zi loads, four 64-bit
// divisions), which in bfloat16, with 8 channels a vector, cost twice as
// much per stored byte, and stored with the default policy.
//
// Layout of the work (the plane sweep's, csrc/sweep_gather.cuh, on 2-D
// tiles):
// - A block of kWarps warps owns a tile of kTileH x kTileW voxels of one
//   target plane (b, d): one 32-bit division finds the plane, whose 64-bit
//   bases are computed once; offsets from them are 32-bit wherever a batch
//   entry's volume holds fewer than 2^31 vectors (`Index`).
// - A lane owns one voxel (a warp: 32 / kTileW rows of kTileW). It loads x
//   and y (and kernel 2's z), tests the mask, applies the corner rules and
//   reads the four corners' q: once per voxel, not once per vector.
// - The warp then writes its 32 voxels' 32 * CV 16-byte vectors (CV = C / 4
//   in float32, C / 8 in bfloat16; a template constant for CV = 1, 2, 4, 8,
//   16) in CV steps: in step i lane l writes vector f = 32 i + l, channel
//   block f % CV of voxel f / CV, whose data it takes from the voxel's
//   owner with __shfl_sync. It reads the eight taps, derives each corner's
//   values and blends them in float32; a bfloat16 vector is rounded once.
//   Each row's vectors are contiguous, so the stores are coalesced, and
//   evict-first (__stcs): the write-once volume does not push the volume
//   that neighbouring planes re-read out of L2.
// - At most 64 registers a thread (__launch_bounds__(128, 8)): 32 warps per
//   SM to hide the gathers' latency.
// - The lane gathers its eight taps from the volume (__ldg); neighbouring
//   voxels share corners and planes, so most of the repeated reads hit L1
//   and L2. A field of each block's box of corner pixels in shared memory
//   (two device-memory taps per box pixel instead of eight gathers per
//   voxel, by cp.async; a TMA tile cannot make this copy, as each pixel
//   picks its own plane and Hopper has no gather mode) measured 11-30%
//   slower on an H100 (PERF.md): the field cut the blocks an SM holds, and
//   the copy and its wait were a phase the block could not overlap with its
//   own arithmetic, while these repeated gathers hit L1.
// Invalid voxels read no taps and store zeros. Every add and multiply is
// rounded on its own (_rn intrinsics, no FMA contraction), so each kernel
// is its plain PyTorch version bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "vec16.cuh"

namespace frustum {

constexpr int kWarps = 4;                   // warps per block
constexpr int kThreads = 32 * kWarps;       // one voxel per thread
constexpr int kMinBlocks = 8;               // 64 registers: 32 warps per SM
constexpr int kTileW = 16;                  // columns of a tile
constexpr int kWarpRows = 32 / kTileW;      // rows of a warp's voxels
constexpr int kTileH = kWarps * kWarpRows;  // rows of a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-3f;               // z-window epsilon

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

// The hard mask of the samplers, at the exact (unclipped) coordinate.
__device__ __forceinline__ bool inside(float x, float y, int H, int W) {
  return x >= 0.0f && x <= static_cast<float>(W - 1) && y >= 0.0f &&
         y <= static_cast<float>(H - 1);
}

// a + t * (b - a), every operation rounded on its own
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// Block-uniform sizes.
struct Shape {
  int Z, H, W;
  int CV;              // 16-byte vectors per voxel
  int tiles_x;         // tiles per row of a plane
  int tiles_per_slab;  // tiles per plane
  int right, down;     // 1 where a corner has a right / lower neighbour
};

// What the lanes storing a voxel's vectors need of it: the plane offset of
// its upper left corner (-1: the voxel is zero), its fractions, kernel 2's
// clipped z index and the four corners' plane indices q.
struct Voxel {
  int idx = -1;
  float wx = 0.0f, wy = 0.0f, zc = 0.0f;
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
};

// The body of both kernels over element type T (float or __nv_bfloat16).
// CVT: the vectors per voxel, or 0 for any CV (read from `s`).
template <typename T, class Op, int CVT, typename Index>
__device__ __forceinline__ void gather(
    const typename vec16::Vec<T>::Raw* __restrict__ vol,
    const float* __restrict__ zi, const float* __restrict__ xs,
    const float* __restrict__ ys, typename vec16::Vec<T>::Raw* __restrict__ out,
    const Shape& s, const Op& op) {
  using V = vec16::Vec<T>;
  using Raw = typename V::Raw;
  constexpr int L = V::kLanes;
  constexpr int K = Op::kValues;
  const int CV = CVT > 0 ? CVT : s.CV;
  const int Z = s.Z, W = s.W;
  const int slab = blockIdx.x / s.tiles_per_slab;  // b * D + d
  const int tile = blockIdx.x - slab * s.tiles_per_slab;
  const Index hw = static_cast<Index>(s.H) * W;
  const long long first = static_cast<long long>(slab) * s.H * W;
  const Raw* vol_b = vol + static_cast<long long>(slab / Z) * Z * s.H * W * CV;
  zi += first;
  out += first * CV;
  const int lane = threadIdx.x & 31;
  // the warp's voxels: kWarpRows rows of kTileW from (row0, col0)
  const int ty = tile / s.tiles_x;
  const int row0 = ty * kTileH + kWarpRows * (threadIdx.x >> 5);
  const int col0 = (tile - ty * s.tiles_x) * kTileW;
  // the plane pixel of the warp's voxel l, -1 outside the plane
  const auto pixel = [&](int l) {
    const int row = row0 + l / kTileW, col = col0 + l % kTileW;
    return row < s.H && col < W ? row * W + col : -1;
  };

  // the owner's pass: one voxel per lane
  Voxel own;
  bool valid = false;
  {
    const int pix = pixel(lane);
    if (pix >= 0) {
      const long long v = first + pix;
      const float x = __ldg(xs + v), y = __ldg(ys + v);
      valid = inside(x, y, s.H, W) && op.voxel(v, Z, own.zc);
      if (valid) {
        int x0, y0;
        corner(x, W, x0, own.wx);
        corner(y, s.H, y0, own.wy);
        own.idx = y0 * W + x0;
        own.q[0] = __ldg(zi + own.idx);
        own.q[1] = __ldg(zi + own.idx + s.right);
        own.q[2] = __ldg(zi + own.idx + s.down * W);
        own.q[3] = __ldg(zi + own.idx + s.down * W + s.right);
      }
    }
  }

  const int off[4] = {0, s.right, s.down * W, s.down * W + s.right};
  const Index plane = hw * CV;

  // the stores: the warp's 32 voxels
#pragma unroll 1
  for (int i = 0; i < CV; ++i) {
    const int f = 32 * i + lane;
    const int owner = f / CV;
    const int cb = f - owner * CV;
    const int idx = __shfl_sync(kFull, own.idx, owner);
    const float wx = __shfl_sync(kFull, own.wx, owner);
    const float wy = __shfl_sync(kFull, own.wy, owner);
    const float zc = Op::kUsesZc ? __shfl_sync(kFull, own.zc, owner) : 0.0f;
    float q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = __shfl_sync(kFull, own.q[c], owner);
    const int pix = pixel(owner);
    if (pix < 0) continue;  // no shuffle follows
    Raw* dst = out + static_cast<Index>(pix) * CV + cb;
    if (idx < 0) {
      __stcs(dst, Raw{});
      continue;
    }
    float val[4][K][L];
    Raw taps[4][2];
    float z0[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      z0[c] = op.z0(q[c], Z);
      taps[c][0] = taps[c][1] = Raw{};
      if (op.loads(q[c])) {
        const Raw* t =
            vol_b + (static_cast<Index>(z0[c]) * hw + idx + off[c]) * CV + cb;
        taps[c][0] = __ldg(t);
        taps[c][1] = __ldg(t + plane);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v0[L], v1[L];
      V::unpack(taps[c][0], v0);
      V::unpack(taps[c][1], v1);
      op.values(v0, v1, q[c], z0[c], val[c]);
    }
    float o[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float t[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        t[k] = lerp(lerp(val[0][k][l], val[1][k][l], wx),
                    lerp(val[2][k][l], val[3][k][l], wx), wy);
      o[l] = op.finish(t, zc);
    }
    __stcs(dst, V::pack(o));
  }
}

template <typename T, class Op, int CVT, typename Index>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
frustum_gather_kernel(const typename vec16::Vec<T>::Raw* __restrict__ vol,
                      const float* __restrict__ zi,
                      const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      typename vec16::Vec<T>::Raw* __restrict__ out, Shape s,
                      Op op) {
  gather<T, Op, CVT, Index>(vol, zi, xs, ys, out, s, op);
}

template <typename T, class Op>
struct Launch {
  using Raw = typename vec16::Vec<T>::Raw;
  const Raw* vol;
  const float *zi, *xs, *ys;
  Raw* out;
  Shape s;
  Op op;
  unsigned blocks;
  cudaStream_t stream;

  template <int CVT, typename Index>
  int run() const {
    frustum_gather_kernel<T, Op, CVT, Index><<<blocks, kThreads, 0, stream>>>(
        vol, zi, xs, ys, out, s, op);
    return static_cast<int>(cudaGetLastError());
  }
};

// Launches the kernel of `Op` over vol [B, D, H, W, C] (D == Z planes),
// zi [B, D, H*W] and x/y [B, D*H*W] into out [B, D, H, W, C] on `stream`;
// returns the CUDA error of the launch. 32-bit offsets and a compile-time
// CV for CV = 1, 2, 4, 8, 16 where a batch entry's volume holds fewer than
// 2^31 vectors, else the generic instance (any CV, 64-bit offsets).
template <typename T, class Op>
int launch(const void* vol, const void* zi, const void* x, const void* y,
           void* out, int B, int D, int H, int W, int C, const Op& op,
           void* stream) {
  using Raw = typename vec16::Vec<T>::Raw;
  if (B == 0 || D == 0 || H == 0 || W == 0 || C == 0) return 0;
  Shape s;
  s.Z = D;
  s.H = H;
  s.W = W;
  s.CV = C / vec16::Vec<T>::kLanes;
  s.tiles_x = (W + kTileW - 1) / kTileW;
  s.tiles_per_slab = s.tiles_x * ((H + kTileH - 1) / kTileH);
  s.right = W > 1;
  s.down = H > 1;
  const long long blocks = static_cast<long long>(B) * D * s.tiles_per_slab;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Launch<T, Op> l{static_cast<const Raw*>(vol),
                        static_cast<const float*>(zi),
                        static_cast<const float*>(x),
                        static_cast<const float*>(y),
                        static_cast<Raw*>(out),
                        s,
                        op,
                        static_cast<unsigned>(blocks),
                        static_cast<cudaStream_t>(stream)};
  if (static_cast<long long>(D) * H * W * s.CV < INT_MAX) {
    switch (s.CV) {
      case 1: return l.template run<1, int>();
      case 2: return l.template run<2, int>();
      case 4: return l.template run<4, int>();
      case 8: return l.template run<8, int>();
      case 16: return l.template run<16, int>();
      default: break;
    }
  }
  return l.template run<0, long long>();
}

}  // namespace frustum
