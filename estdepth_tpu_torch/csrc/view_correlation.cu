// Correlation of a swept source volume with the reference (TransMVSNet's
// cost volume), CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no TransMVSNet. It replaces
// the two ATen kernels that correlated each swept source view in
// models/transmvsnet.py, `(warped * ref).mean(-1)`: a broadcast product
// written as a second full-size volume, then a reduce over an innermost
// axis of only 8 to 32 channels that reads it back.
//
// Computes, for the reference view's features ref [B, H, W, C] and one
// swept source volume w [B, D, H, W, C] (channels-last, kernel 1's output):
//   out[b, d, i, j] = (sum over c of w[b, d, i, j, c] * ref[b, i, j, c]) * r
// with r = 1 / C in float32, as ATen's CUDA mean scales its sum. The sum
// is taken in a fixed order other than ATen's (below), each operation
// rounded on its own (_rn intrinsics, no FMA contraction), so the kernel
// is within a few rounding steps of the plain version: at every voxel
// |kernel - plain| <= 4 C 2^-23 mean_c |w_c ref_c| (held by the `cuda`
// tests at the DTU stages).
//
// Bound on the card: bytes. The volume and the reference are read once
// and the [B, D, H, W] correlation written once: 4 B H W (C + D C + D)
// bytes. At TransMVSNet's DTU stages (D = 48, 32, 8; 288x400x32,
// 576x800x16, 1152x1600x8) that is 0.745, 1.032 and 0.590 GB a source
// view, 0.222, 0.308 and 0.176 ms at 3.35 TB/s; half a flop a byte, far
// under the float32 rate. The design serves that bound:
// - A warp owns 32 consecutive pixels of one batch entry and a block of
//   kWarps warps walks kChunk planes of its kPixels pixels. The
//   reference's run is read once a block into registers, not once a
//   plane; the blocks of one pixel run are adjacent in the grid, so all
//   but the first read it from L2. Cutting D into chunks makes thousands
//   of short blocks at every stage, so no half-empty last wave of long
//   ones holds the card (TransMVSNet's stage 1 has 900 runs of 128
//   pixels, more than fit on the card at once).
// - A plane's tile of the volume is 32 * C consecutive floats a warp:
//   lane l loads 16-byte vectors l, 32 + l, ..., each warp load one
//   coalesced 512-byte run, with __ldcs (evict-first: every byte is read
//   once). The loads of kInFlight / (C / 4) planes, 8 vectors a lane, are
//   issued together before their sums.
// - Each lane multiplies its vector by the reference's and sums the four
//   products; the C / 4 lanes that hold one pixel's vectors sum theirs by
//   a butterfly of shuffles (every lane of the group gets the same sum).
//   Lane l then fetches pixel l's sum from its group with one shuffle a
//   round, so the warp stores its 32 outputs of a plane as one whole
//   128-byte line with __stcs (evict-first). No shared memory, no barrier.
// - Compile-time instances for C = 8, 16 and 32 (TransMVSNet's three
//   stages), and a generic one for any C % 4 == 0 up to kMaxChannels, in
//   which a lane sums its own pixel's vectors in order.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 512;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPixels = kThreads;  // pixels a block: 32 a warp
constexpr int kChunk = 8;          // planes a block
constexpr int kInFlight = 8;       // 16-byte loads a lane issues together
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  long long HW;  // pixels a plane
  int D;         // planes
  int CV;        // 16-byte vectors a pixel (C / 4)
  int tiles;     // runs of kPixels pixels a plane
  int chunks;    // runs of kChunk planes
  float r;       // 1 / C in float32
};

// ((x.x r.x + x.y r.y) + x.z r.z) + x.w r.w
__device__ __forceinline__ float dot(float4 x, float4 r) {
  float s = __fadd_rn(__fmul_rn(x.x, r.x), __fmul_rn(x.y, r.y));
  s = __fadd_rn(s, __fmul_rn(x.z, r.z));
  return __fadd_rn(s, __fmul_rn(x.w, r.w));
}

// The block's batch entry, the first pixel of the calling warp and the
// block's planes [d0, d1).
struct Place {
  int b, d0, d1;
  long long p0;

  __device__ Place(const Shape& s) {
    const int chunk = blockIdx.x % s.chunks;
    const int run = blockIdx.x / s.chunks;
    b = run / s.tiles;
    p0 = static_cast<long long>(run - b * s.tiles) * kPixels +
         (threadIdx.x / 32) * 32;
    d0 = chunk * kChunk;
    d1 = min(s.D, d0 + kChunk);
  }
};

// CV = C / 4, which divides 32: a round of 32 vectors holds 32 / CV whole
// pixels, and round k the warp's pixels k * 32 / CV onwards.
template <int CV>
__global__ void __launch_bounds__(kThreads)
view_correlation_kernel(const float4* __restrict__ ref,
                        const float4* __restrict__ warped,
                        float* __restrict__ out, const Shape s) {
  constexpr int kPlanes = kInFlight / CV > 0 ? kInFlight / CV : 1;
  constexpr int kGroup = 32 / CV;  // pixels a round
  const Place at(s);
  const long long left = s.HW - at.p0;
  if (left <= 0) return;  // the whole warp: p0 is the warp's
  const int vectors = static_cast<int>(left < 32 ? left : 32) * CV;
  const int lane = threadIdx.x % 32;

  float4 r[CV];
  const float4* rb = ref + (at.b * s.HW + at.p0) * CV;
#pragma unroll
  for (int k = 0; k < CV; ++k) {
    const int f = k * 32 + lane;
    r[k] = f < vectors ? __ldg(rb + f) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // pixel `lane` is in round lane / kGroup, summed by the lanes from
  // (lane % kGroup) * CV
  const int home = lane / kGroup;
  const int holder = (lane % kGroup) * CV;

  for (int d = at.d0; d < at.d1; d += kPlanes) {
    float4 x[kPlanes][CV];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const float4* wb =
          warped + ((at.b * static_cast<long long>(s.D) + d + p) * s.HW +
                    at.p0) * CV;
#pragma unroll
      for (int k = 0; k < CV; ++k) {
        const int f = k * 32 + lane;
        x[p][k] = d + p < at.d1 && f < vectors
                      ? __ldcs(wb + f)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      float mine = 0.f;
#pragma unroll
      for (int k = 0; k < CV; ++k) {
        float t = dot(x[p][k], r[k]);
#pragma unroll
        for (int m = 1; m < CV; m *= 2)
          t = __fadd_rn(t, __shfl_xor_sync(kFull, t, m));
        const float v = __shfl_sync(kFull, t, holder);
        if (k == home) mine = v;
      }
      if (d + p < at.d1 && lane * CV < vectors)
        __stcs(out + (at.b * static_cast<long long>(s.D) + d + p) * s.HW +
                   at.p0 + lane,
               __fmul_rn(mine, s.r));
    }
  }
}

// Any C % 4 == 0: lane l sums the vectors of the warp's pixel l in order.
__global__ void __launch_bounds__(kThreads)
view_correlation_generic(const float4* __restrict__ ref,
                         const float4* __restrict__ warped,
                         float* __restrict__ out, const Shape s) {
  const Place at(s);
  const long long pixel = at.p0 + threadIdx.x % 32;
  if (pixel >= s.HW) return;
  const float4* rb = ref + (at.b * s.HW + pixel) * s.CV;
  for (int d = at.d0; d < at.d1; ++d) {
    const long long voxel =
        (at.b * static_cast<long long>(s.D) + d) * s.HW + pixel;
    const float4* wb = warped + voxel * s.CV;
    float t = 0.f;
    for (int k = 0; k < s.CV; ++k)
      t = __fadd_rn(t, dot(__ldg(wb + k), __ldg(rb + k)));
    __stcs(out + voxel, __fmul_rn(t, s.r));
  }
}

struct Launch {
  const float4* ref;
  const float4* warped;
  float* out;
  Shape s;
  unsigned blocks;
  cudaStream_t stream;

  template <int CV>
  void run() const {
    view_correlation_kernel<CV><<<blocks, kThreads, 0, stream>>>(
        ref, warped, out, s);
  }

  void run_generic() const {
    view_correlation_generic<<<blocks, kThreads, 0, stream>>>(ref, warped,
                                                              out, s);
  }
};

}  // namespace

// ref [B, H, W, C], warped [B, D, H, W, C], out [B, D, H, W]; float32,
// contiguous, C % 4 == 0 and C <= 512, checked by the Python wrapper.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int view_correlation_f32(const void* ref, const void* warped,
                                    void* out, int B, int D, int H, int W,
                                    int C, void* stream) {
  if (C % 4 || C > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || H == 0 || W == 0 || C == 0) return 0;
  Launch launch{static_cast<const float4*>(ref),
                static_cast<const float4*>(warped), static_cast<float*>(out),
                {}, 0, static_cast<cudaStream_t>(stream)};
  Shape& s = launch.s;
  s.HW = static_cast<long long>(H) * W;
  s.D = D;
  s.CV = C / 4;
  s.tiles = static_cast<int>((s.HW + kPixels - 1) / kPixels);
  s.chunks = (D + kChunk - 1) / kChunk;
  s.r = 1.0f / static_cast<float>(C);
  const long long blocks = static_cast<long long>(B) * s.tiles * s.chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  launch.blocks = static_cast<unsigned>(blocks);
  switch (s.CV) {
    case 2: launch.run<2>(); break;
    case 4: launch.run<4>(); break;
    case 8: launch.run<8>(); break;
    default: launch.run_generic(); break;
  }
  return static_cast<int>(cudaGetLastError());
}
