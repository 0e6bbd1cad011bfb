// GroupNorm followed by an activation (the EST GRU's gates and output),
// CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves its GroupNorms to XLA. It
// replaces ATen's CUDA group norm and the activation after it
// (models/est_transformer.py). ATen's statistics kernel launches one block
// per (sample, group): at the GRU's [1, 16, 64, 64, 80] volumes that is one
// block walking 5.24 M values while the other 131 SMs idle: about 4 ms a
// call on an H100, activation included.
//
// Computes, for x [N, C, *S] (contiguous, float32 or bfloat16) in G groups,
// weight and bias float32 [C]:
//   mean, var  over each (n, g): its C / G channels of S values, float32,
//              var the biased variance
//   y = (x - mean) * (rsqrt(var + eps) * weight[c]) + bias[c], in float32,
//       rounded to x's type
//   out = act(y), act one of none, sigmoid (1 / (1 + exp(-y))) and tanh,
//       computed in float32 on the rounded y and rounded once to x's type
// which is ops/cuda/group_norm_act.group_norm_act_plain up to the order of
// the sums (the activations are ATen's expressions).
//
// Bound on the card: bytes. x is read once and the output written once:
// 8 N C S bytes in float32, 84 MB at the GRU's gates ([1, 32, 64, 64, 80]),
// 25 us at 3.35 TB/s; a few operations a value, far under the float32
// rate. A reduction across blocks needs a second pass, so two launches on
// the caller's stream, each over the whole card:
// - Statistics. Block (k, r) reduces chunk k of row r = n G + g, a
//   contiguous run of (C / G) S values in NCDHW. The wrapper sizes the
//   chunks from the row length and the SM count (a few blocks an SM in
//   all). A thread loads kUnroll 16-byte vectors at a time (the warp's
//   loads coalesced 512-byte runs); a misaligned head and the tail of odd
//   lengths are loaded as scalars. Each batch's mean and sum of squared
//   deviations are taken in registers and merged into the thread's
//   (count, mean, M2) with Chan's formula; warps and then the block merge
//   in a fixed tree. One partial a block goes to a scratch buffer. Loads
//   use the default caching: 21-42 MB stays in the 50 MB L2 for pass 2.
// - Apply. Each block merges its row's partials in a fixed order (each
//   thread a strided set, then the same tree): results are the same on
//   every run, with no atomics. It then normalizes its chunk, rounds,
//   applies the activation and stores 16-byte vectors with __stcs
//   (evict-first). The blocks run in the reverse order of pass 1's, so
//   the first of them re-read what pass 1 read last, likeliest in L2.
// One launch with a grid-wide barrier would save the second launch's
// latency (a few us) but needs a co-resident grid; the two passes are
// plain launches that the stream orders.
// Compile-time instances for the three activations and both element types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // vectors a thread has in flight

enum Act { kNone = 0, kSigmoid = 1, kTanh = 2 };

struct Shape {
  long long L;      // values a row: (C / G) S
  long long S;      // values a channel
  long long chunk;  // values a block, a multiple of the vector's lanes
  int chunks;       // blocks a row
  int G;            // groups
  int Cg;           // channels a group
  float eps;
};

// count, mean and the sum of squared deviations of a set of values
struct Moments {
  float n, mean, m2;
};

// Chan et al.'s merge of two sets' moments
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float f = b.n / n;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// the moments of the first `count` of `v`
template <int K>
__device__ __forceinline__ Moments moments(const float (&v)[K], int count) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < count) sum += v[i];
  const float mean = sum / static_cast<float>(count);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float d = v[i] - mean;
    if (i < count) m2 += d * d;
  }
  return {static_cast<float>(count), mean, m2};
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int offset) {
  return {__shfl_down_sync(0xffffffffu, m.n, offset),
          __shfl_down_sync(0xffffffffu, m.mean, offset),
          __shfl_down_sync(0xffffffffu, m.m2, offset)};
}

// The block's moments, in thread 0: each warp's lanes in a fixed tree,
// then the warps' in the same tree. Called once a block.
__device__ Moments block_merge(Moments m) {
  __shared__ float part[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = merge(m, shfl_down(m, o));
  if (lane == 0) {
    part[0][warp] = m.n;
    part[1][warp] = m.mean;
    part[2][warp] = m.m2;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? Moments{part[0][lane], part[1][lane], part[2][lane]}
                      : Moments{0.f, 0.f, 0.f};
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) m = merge(m, shfl_down(m, o));
  }
  return m;
}

template <typename T>
__device__ __forceinline__ float load_scalar(const T* p);
template <>
__device__ __forceinline__ float load_scalar<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_scalar<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_scalar(T* p, float v);
template <>
__device__ __forceinline__ void store_scalar<float>(float* p, float v) {
  __stcs(p, v);
}
template <>
__device__ __forceinline__ void store_scalar<__nv_bfloat16>(__nv_bfloat16* p,
                                                            float v) {
  *p = __float2bfloat16_rn(v);
}

// v as x's type holds it (the rounding of the plain version's .to(dtype))
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if constexpr (ACT == kSigmoid)
    return 1.0f / (1.0f + expf(-y));
  else if constexpr (ACT == kTanh)
    return tanhf(y);
  else
    return y;
}

// A block's values of its row: [begin, end), split into a scalar head up
// to the first 16-byte boundary, whole vectors, and a scalar tail.
template <typename T>
struct Chunk {
  static constexpr int kLanes = vec16::Vec<T>::kLanes;
  long long begin;  // the first value's index in the row
  int head, vectors, tail;

  __device__ Chunk(const T* row, const Shape& s, int k) {
    begin = k * s.chunk;
    const long long end = begin + s.chunk < s.L ? begin + s.chunk : s.L;
    const long long len = end > begin ? end - begin : 0;
    const int mis = static_cast<int>(
        reinterpret_cast<unsigned long long>(row + begin) % 16 / sizeof(T));
    const long long h = mis ? kLanes - mis : 0;
    head = static_cast<int>(h < len ? h : len);
    vectors = static_cast<int>((len - head) / kLanes);
    tail = static_cast<int>(len - head - static_cast<long long>(vectors) *
                                             kLanes);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_stats_kernel(const T* __restrict__ x, float4* __restrict__ partials,
                        const Shape s) {
  using V = vec16::Vec<T>;
  constexpr int kLanes = V::kLanes;
  const T* row = x + blockIdx.y * s.L;
  const Chunk<T> c(row, s, blockIdx.x);
  const T* first = row + c.begin;
  const typename V::Raw* vecs =
      reinterpret_cast<const typename V::Raw*>(first + c.head);

  Moments m{0.f, 0.f, 0.f};
  if (static_cast<int>(threadIdx.x) < c.head)
    m = Moments{1.f, load_scalar(first + threadIdx.x), 0.f};
  if (static_cast<int>(threadIdx.x) < c.tail)
    m = merge(m, Moments{1.f,
                         load_scalar(first + c.head +
                                     static_cast<long long>(c.vectors) *
                                         kLanes + threadIdx.x),
                         0.f});
  for (int f0 = 0; f0 < c.vectors; f0 += kThreads * kUnroll) {
    typename V::Raw raw[kUnroll] = {};
    int n = 0;  // this thread's vectors of the batch: a prefix
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads + threadIdx.x;
      if (f < c.vectors) {
        raw[u] = __ldg(vecs + f);
        n = u + 1;
      }
    }
    if (n == 0) break;
    float v[kUnroll * kLanes];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float lanes[kLanes];
      V::unpack(raw[u], lanes);
#pragma unroll
      for (int i = 0; i < kLanes; ++i) v[u * kLanes + i] = lanes[i];
    }
    m = merge(m, moments(v, n * kLanes));
  }
  m = block_merge(m);
  if (threadIdx.x == 0)
    partials[blockIdx.y * s.chunks + blockIdx.x] =
        make_float4(m.n, m.mean, m.m2, 0.f);
}

// The affine map of the channel a value of the row lies in, followed
// along the row: `advance(i)` moves it to the channel of row value i (i
// never decreasing).
struct Channel {
  long long bound;  // the first row index past the channel
  int c;            // the channel's index in the group
  float scale, shift;
  const float* w;   // the group's weights and biases
  const float* b;
  long long S;
  float rstd;

  __device__ Channel(long long i, const float* w_, const float* b_,
                     long long S_, float rstd_)
      : w(w_), b(b_), S(S_), rstd(rstd_) {
    c = static_cast<int>(i / S);
    bound = (c + 1) * S;
    load();
  }

  __device__ __forceinline__ void load() {
    scale = rstd * __ldg(w + c);
    shift = __ldg(b + c);
  }

  __device__ __forceinline__ void advance(long long i) {
    if (i < bound) return;
    do {
      ++c;
      bound += S;
    } while (i >= bound);
    load();
  }
};

template <typename T, int ACT>
__device__ __forceinline__ float normalize(float v, float mean, float scale,
                                          float shift) {
  return activate<ACT>(round_to<T>(fmaf(v - mean, scale, shift)));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const T* __restrict__ x,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        const float4* __restrict__ partials,
                        T* __restrict__ out, const Shape s) {
  using V = vec16::Vec<T>;
  constexpr int kLanes = V::kLanes;
  __shared__ float stats[2];

  // the blocks in the reverse order of the statistics pass, so that the
  // first to run find the values that pass read last still in L2
  const int r = gridDim.y - 1 - blockIdx.y;
  const int k = gridDim.x - 1 - blockIdx.x;

  // the row's moments from its partials, the same in every block of it
  const float4* mine = partials + r * s.chunks;
  Moments m{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < s.chunks; i += kThreads) {
    const float4 p = mine[i];
    m = merge(m, Moments{p.x, p.y, p.z});
  }
  m = block_merge(m);
  if (threadIdx.x == 0) {
    stats[0] = m.mean;
    stats[1] = __frsqrt_rn(m.m2 / static_cast<float>(s.L) + s.eps);
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  const long long offset = r * s.L;
  const T* row = x + offset;
  T* orow = out + offset;
  const Chunk<T> c(row, s, k);
  const int g = r % s.G;
  const float* w = weight + g * s.Cg;
  const float* b = bias + g * s.Cg;
  const long long first = c.begin + c.head;  // the first vector's value

  // the scalar head and tail
  const int t = threadIdx.x;
  const long long tail = first + static_cast<long long>(c.vectors) * kLanes;
  auto scalar = [&](long long i) {
    const Channel ch(i, w, b, s.S, rstd);
    store_scalar(orow + i, normalize<T, ACT>(load_scalar(row + i), mean,
                                             ch.scale, ch.shift));
  };
  if (t < c.head) scalar(c.begin + t);
  if (t < c.tail) scalar(tail + t);
  if (t >= c.vectors) return;  // a thread past the vectors has none

  const typename V::Raw* vecs =
      reinterpret_cast<const typename V::Raw*>(row + first);
  typename V::Raw* ovecs = reinterpret_cast<typename V::Raw*>(orow + first);
  Channel ch(first + static_cast<long long>(t) * kLanes, w, b, s.S, rstd);
  for (int f0 = 0; f0 < c.vectors; f0 += kThreads * kUnroll) {
    typename V::Raw raw[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads + t;
      if (f < c.vectors) raw[u] = __ldg(vecs + f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads + t;
      if (f >= c.vectors) break;
      const long long i = first + static_cast<long long>(f) * kLanes;
      ch.advance(i);
      float lanes[kLanes];
      V::unpack(raw[u], lanes);
      Channel lane = ch;  // a vector may cross into the next channels
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        lane.advance(i + k);
        lanes[k] = normalize<T, ACT>(lanes[k], mean, lane.scale, lane.shift);
      }
      __stcs(ovecs + f, V::pack(lanes));
    }
  }
}

struct Launch {
  const void* x;
  const float* weight;
  const float* bias;
  void* out;
  float4* partials;
  Shape s;
  dim3 grid;
  cudaStream_t stream;

  template <typename T, int ACT>
  void run() const {
    const T* xt = static_cast<const T*>(x);
    group_norm_stats_kernel<T><<<grid, kThreads, 0, stream>>>(xt, partials,
                                                              s);
    group_norm_apply_kernel<T, ACT><<<grid, kThreads, 0, stream>>>(
        xt, weight, bias, partials, static_cast<T*>(out), s);
  }

  template <typename T>
  int dispatch(int act) const {
    switch (act) {
      case kNone: run<T, kNone>(); break;
      case kSigmoid: run<T, kSigmoid>(); break;
      case kTanh: run<T, kTanh>(); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* x, const void* weight, const void* bias, void* out,
           void* partials, int rows, int groups, int channels_per_group,
           long long S, long long chunk, int chunks, float eps, int act,
           void* stream) {
  const long long L = static_cast<long long>(channels_per_group) * S;
  // the passes split each row at x's 16-byte boundaries, which must be
  // out's too
  if ((static_cast<const char*>(x) - static_cast<const char*>(out)) % 16 ||
      act < kNone || act > kTanh || rows < 0 || rows > 65535 ||
      groups < 1 || channels_per_group < 1 || S < 0 || chunks < 1 ||
      chunk < 1 || chunk % vec16::Vec<T>::kLanes ||
      chunk * chunks < L || chunk > (1LL << 31) - kThreads * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || L == 0) return 0;
  const Launch l{x, static_cast<const float*>(weight),
                 static_cast<const float*>(bias), out,
                 static_cast<float4*>(partials),
                 Shape{L, S, chunk, chunks, groups, channels_per_group, eps},
                 dim3(static_cast<unsigned>(chunks),
                      static_cast<unsigned>(rows)),
                 static_cast<cudaStream_t>(stream)};
  return l.dispatch<T>(act);
}

}  // namespace

// x, out [N, C, *S] contiguous, N G rows of (C / G) S values; weight, bias
// float32 [C]; partials float32 [rows, chunks, 4] (scratch); chunk values a
// block (a multiple of the vector's lanes, chunk * chunks >= the row's
// length); act 0 none, 1 sigmoid, 2 tanh. Checked by the Python wrapper.
// Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int group_norm_act_f32(const void* x, const void* weight,
                                  const void* bias, void* out,
                                  void* partials, int rows, int groups,
                                  int channels_per_group, long long S,
                                  long long chunk, int chunks, float eps,
                                  int act, void* stream) {
  return launch<float>(x, weight, bias, out, partials, rows, groups,
                       channels_per_group, S, chunk, chunks, eps, act,
                       stream);
}

extern "C" int group_norm_act_bf16(const void* x, const void* weight,
                                   const void* bias, void* out,
                                   void* partials, int rows, int groups,
                                   int channels_per_group, long long S,
                                   long long chunk, int chunks, float eps,
                                   int act, void* stream) {
  return launch<__nv_bfloat16>(x, weight, bias, out, partials, rows, groups,
                               channels_per_group, S, chunk, chunks, eps, act,
                               stream);
}
