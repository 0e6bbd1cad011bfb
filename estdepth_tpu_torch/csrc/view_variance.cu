// Variance over the views (CasMVSNet's cost volume), CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no CasMVSNet. It replaces the
// chain of ATen elementwise and copy kernels that built each stage's
// variance (models/casmvsnet.py): a clone, a square, three passes a source
// view and the NDHWC-to-NCDHW copy, about 45 passes over the volume.
//
// Computes, for the reference view's features ref [B, H, W, C] and N = V - 1
// swept source volumes w_1 .. w_N [B, D, H, W, C] (channels-last, kernel 1's
// output):
//   t = ref + w_1 + ... + w_N          s = ref*ref + w_1*w_1 + ... + w_N*w_N
//   out[b, c, d, i, j] = s * r - (t * r) * (t * r),   r = 1 / V in float32
// added in that order, each operation rounded on its own (_rn intrinsics,
// no FMA contraction). That is ops/cuda/view_variance.view_variance_plain on
// the card bit for bit: ATen's CUDA division of a tensor by a Python number
// multiplies by the number's float32 reciprocal.
//
// Bound on the card: bytes. Each swept volume and the reference are read
// once and the NCDHW variance written once: 4 B H W C (1 + V D) bytes. At
// CasMVSNet's DTU stages (V = 5; D = 48, 32, 8; 288x400x32, 576x800x16,
// 1152x1600x8) that is 3.55, 4.75 and 2.42 GB, 1.06, 1.42 and 0.72 ms at
// 3.35 TB/s; about 3 flops a byte read, far under the float32 rate.
// The design serves that bound:
// - A block of kThreads threads owns a run of T consecutive pixels of one
//   batch entry and walks its D planes, so the reference's run is read once
//   per (h, w), not once per plane, and kept with its squares in registers.
// - A plane's tile of a volume is T * C consecutive floats (8 KB): thread k
//   loads 16-byte vectors k and k + kThreads, so each warp load is one
//   coalesced 512-byte run. The N sources' loads of a vector are issued
//   together, kBatch at a time, before their sums: 4 x 2 loads in flight
//   a thread. Loads are __ldcs (evict-first): every byte is read once.
// - A vector's running sums stay in registers; its 4 variances go to a
//   shared-memory tile [C][T + pad] (pad 32 / C for C = 8, 16, 32: the 32
//   lanes' stores of one channel fall in 32 banks), and the block then
//   stores each channel's run of T pixels of the plane as whole 128-byte
//   lines of the NCDHW output, one float a lane, with __stcs (evict-first).
//   Two tiles alternate between planes: one barrier a plane.
// - Compile-time instances for C = 8, 16 and 32 (CasMVSNet's three stages;
//   T = 256, 128, 64 pixels), and a generic one for any C % 4 == 0 up to
//   kMaxChannels.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSources = 16;   // source views (the wrapper refuses more)
constexpr int kMaxChannels = 512;
constexpr int kThreads = 256;
constexpr int kPerThread = 2;     // vectors a thread loads a volume and plane
constexpr int kTileVectors = kThreads * kPerThread;
constexpr int kBatch = 4;         // source loads issued before their sums
// a tile of C * T <= 4 * kTileVectors floats, and its pad of at most one
// float a channel (the generic instance's)
constexpr int kTileFloats = 4 * kTileVectors + kMaxChannels;

struct Sources {
  const float4* w[kMaxSources];
};

struct Shape {
  long long HW;  // pixels a plane
  int D, n;      // planes; source views
  int CV;        // 16-byte vectors a pixel (C / 4)
  int T;         // pixels a tile (the generic instance's)
  int tiles;     // tiles a plane
  float r;       // 1 / V in float32
};

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 square(float4 a) {
  return make_float4(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y),
                     __fmul_rn(a.z, a.z), __fmul_rn(a.w, a.w));
}

// s * r - (t * r) * (t * r), lane by lane
__device__ __forceinline__ float variance(float t, float s, float r) {
  const float m = __fmul_rn(t, r);
  return __fsub_rn(__fmul_rn(s, r), __fmul_rn(m, m));
}

// CVT: vectors a pixel, or 0 for any (read from `s`).
template <int CVT>
__global__ void __launch_bounds__(kThreads)
view_variance_kernel(const float4* __restrict__ ref, const Sources src,
                     float* __restrict__ out, const Shape s) {
  __shared__ float tile[2][kTileFloats];
  const int CV = CVT > 0 ? CVT : s.CV;
  const int C = 4 * CV;
  const int T = CVT > 0 ? kTileVectors / CVT : s.T;
  const int stride = T + (CVT > 0 && CVT <= 8 ? 8 / CVT : 1);
  const int b = blockIdx.x / s.tiles;
  const long long p0 =
      static_cast<long long>(blockIdx.x - b * s.tiles) * T;  // first pixel
  const int pixels = static_cast<int>(s.HW - p0 < T ? s.HW - p0 : T);
  const int vectors = pixels * CV;

  // this thread's vectors of the reference's run, and their squares
  float4 r[kPerThread] = {}, rr[kPerThread] = {};
  const float4* rb = ref + (b * s.HW + p0) * CV;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int f = u * kThreads + threadIdx.x;
    if (f < vectors) {
      r[u] = __ldcs(rb + f);
      rr[u] = square(r[u]);
    }
  }

  for (int d = 0; d < s.D; ++d) {
    const long long first = ((b * static_cast<long long>(s.D) + d) * s.HW +
                             p0) * CV;  // the tile's first vector
    float4 t[kPerThread], q[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      t[u] = r[u];
      q[u] = rr[u];
    }
    // unrolled whole, so that each source's pointer is read from the
    // kernel's parameters at a fixed offset (an index known only at run
    // time would copy the array to the stack)
#pragma unroll
    for (int i = 0; i < kMaxSources; i += kBatch) {
      if (i >= s.n) break;
      float4 x[kBatch][kPerThread] = {};
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (i + k >= s.n) break;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          const int f = u * kThreads + threadIdx.x;
          if (f < vectors) x[k][u] = __ldcs(src.w[i + k] + first + f);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (i + k >= s.n) break;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          t[u] = add(t[u], x[k][u]);
          q[u] = add(q[u], square(x[k][u]));
        }
      }
    }

    float* buf = tile[d & 1];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int f = u * kThreads + threadIdx.x;
      if (f < vectors) {
        const int pixel = f / CV;
        float* at = buf + 4 * (f - pixel * CV) * stride + pixel;
        at[0] = variance(t[u].x, q[u].x, s.r);
        at[stride] = variance(t[u].y, q[u].y, s.r);
        at[2 * stride] = variance(t[u].z, q[u].z, s.r);
        at[3 * stride] = variance(t[u].w, q[u].w, s.r);
      }
    }
    // the tile of plane d is whole; the one of plane d - 1, which the
    // next plane overwrites, has been stored by every thread
    __syncthreads();

    // out[b, c, d, p0 + j] for the tile's pixels j, one channel's run at
    // a time: 32 lanes store one 128-byte line
    float* ob = out + (b * static_cast<long long>(C) * s.D + d) * s.HW + p0;
    const long long channel = static_cast<long long>(s.D) * s.HW;
    for (int e = threadIdx.x; e < C * T; e += kThreads) {
      const int c = e / T;
      const int j = e - c * T;
      if (j < pixels) __stcs(ob + c * channel + j, buf[c * stride + j]);
    }
  }
}

struct Launch {
  const float4* ref;
  Sources src;
  float* out;
  Shape s;
  unsigned blocks;
  cudaStream_t stream;

  template <int CVT>
  void run() const {
    view_variance_kernel<CVT><<<blocks, kThreads, 0, stream>>>(ref, src,
                                                               out, s);
  }
};

}  // namespace

// ref [B, H, W, C], warped: n pointers to [B, D, H, W, C], out
// [B, C, D, H, W]; float32, contiguous, C % 4 == 0 and C <= 512,
// 1 <= n <= 16, checked by the Python wrapper. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int view_variance_f32(const void* ref, const void* const* warped,
                                 int n, void* out, int B, int D, int H,
                                 int W, int C, void* stream) {
  if (n < 1 || n > kMaxSources || C % 4 || C > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || H == 0 || W == 0 || C == 0) return 0;
  Launch launch{static_cast<const float4*>(ref), {}, static_cast<float*>(out),
                {}, 0, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < n; ++i)
    launch.src.w[i] = static_cast<const float4*>(warped[i]);
  Shape& s = launch.s;
  s.HW = static_cast<long long>(H) * W;
  s.D = D;
  s.n = n;
  s.CV = C / 4;
  s.T = kTileVectors / s.CV;
  s.tiles = static_cast<int>((s.HW + s.T - 1) / s.T);
  s.r = 1.0f / static_cast<float>(n + 1);
  launch.blocks = static_cast<unsigned>(B) * s.tiles;
  switch (s.CV) {
    case 2: launch.run<2>(); break;
    case 4: launch.run<4>(); break;
    case 8: launch.run<8>(); break;
    default: launch.run<0>(); break;
  }
  return static_cast<int>(cudaGetLastError());
}
