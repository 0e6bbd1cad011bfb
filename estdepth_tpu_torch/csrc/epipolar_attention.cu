// Per-voxel epipolar attention (kernel 5 of the port), CUDA C++ for sm_90a.
//
// Replaces: estdepth_tpu/ops/pallas/epipolar_attention.py:epipolar_attention
// (_kernel).
//
// Computes, per voxel p of batch entry b, over the N warped neighbours:
//   corr_n = sum_c tk[b, p, c] * wk[n, b, p, c]          C = 16 channels
//   l_n    = valid[n, b] ? corr_n : -1e9
//   a_n    = valid[n, b] ? exp(l_n - max_m l_m) / sum_m exp(l_m - max) : 0
//   out[b, p, :] = sum_n a_n * wv[n, b, p, :] / max(#valid neighbours, 1)
// A batch entry with no valid neighbour gives exactly 0: every logit is
// -1e9, every exponential 1, and every weight is masked to 0.
//
// The TPU version flattens (voxel, channel) into lanes and sums each
// voxel's channels with lane gathers, because a 16-wide minor axis wastes
// its vector unit. Here one thread owns one voxel: it keeps the voxel's 16
// key channels and its N <= 8 logits in registers, sums the channels in a
// fixed order, and writes the 16 output channels; the correlation, the
// softmax, the weighted sum and the division never leave the thread.
//
// The neighbours' keys and values are read IN PLACE from the volume the
// frustum warp wrote, [B, N, D, H, W, 2C] with K in channels [0, C) and V
// in [C, 2C): the kernel takes the neighbour stride, the batch stride and
// the voxel pitch in elements, so no contiguous copy of the 2N
// half-volumes is made.
//
// Bound on the card: bytes. tk, N keys and N values are read once and the
// output is written once: (2 + 2N) * B * D*H*W * 64 bytes, 168 MB at the
// Joint window's shapes (N = 3, 64 x 64 x 80 voxels). A thread's 64-byte
// rows are 16-byte loads whose sectors its neighbours in the warp do not
// share, so the loads rely on L1 to use both halves of each 32-byte sector.
//
// Two instances of one body: epipolar_attention_f32 and
// epipolar_attention_bf16. A bfloat16 row of 16 channels is two 16-byte
// vectors, unpacked to floats (csrc/vec16.cuh); the correlation, softmax,
// weighted sum and division are float32 in both, and a bfloat16 output is
// rounded once, as the TPU kernel's (bf16 in and out, f32 inside). In
// bfloat16 every row halves: 84 MB at the Joint window's shapes.

#include "vec16.cuh"

namespace {

constexpr int kMaxNeighbours = 8;
constexpr int kChannels = 16;
constexpr float kNegInf = -1e9f;

// One voxel's 16 channels as floats.
struct Row {
  float c[kChannels];
};

template <typename T>
__device__ __forceinline__ Row load_row(const T* __restrict__ p) {
  using V = vec16::Vec<T>;
  constexpr int kVectors = kChannels / V::kLanes;
  const typename V::Raw* pv = reinterpret_cast<const typename V::Raw*>(p);
  Row r;
#pragma unroll
  for (int i = 0; i < kVectors; ++i) {
    float f[V::kLanes];
    V::unpack(__ldg(pv + i), f);
#pragma unroll
    for (int l = 0; l < V::kLanes; ++l) r.c[i * V::kLanes + l] = f[l];
  }
  return r;
}

__device__ __forceinline__ float dot(const Row& a, const Row& b) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kChannels; ++i) s += a.c[i] * b.c[i];
  return s;
}

template <typename T>
__global__ void epipolar_attention_kernel(
    const T* __restrict__ tk, const T* __restrict__ wk,
    const T* __restrict__ wv, const int* __restrict__ valid,
    T* __restrict__ out, int N, int B, long long P, long long tk_batch,
    long long tk_pitch, long long w_neighbour, long long w_batch,
    long long w_pitch) {
  using V = vec16::Vec<T>;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * P) return;
  const int b = static_cast<int>(t / P);
  const long long p = t % P;
  const Row key = load_row(tk + b * tk_batch + p * tk_pitch);
  const long long w_off = b * w_batch + p * w_pitch;

  float logit[kMaxNeighbours];
  float top = kNegInf;
  int n_valid = 0;
#pragma unroll
  for (int n = 0; n < kMaxNeighbours; ++n) {
    if (n < N) {
      const bool v = __ldg(valid + n * B + b) != 0;
      float l = kNegInf;
      if (v) {
        l = dot(key, load_row(wk + n * w_neighbour + w_off));
        ++n_valid;
      }
      logit[n] = l;
      top = fmaxf(top, l);
    }
  }
  float denom = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxNeighbours; ++n) {
    if (n < N) {
      logit[n] = expf(logit[n] - top);
      denom += logit[n];
    }
  }
  Row acc;
#pragma unroll
  for (int i = 0; i < kChannels; ++i) acc.c[i] = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxNeighbours; ++n) {
    if (n < N && __ldg(valid + n * B + b) != 0) {
      const float a = logit[n] / denom;
      const Row val = load_row(wv + n * w_neighbour + w_off);
#pragma unroll
      for (int i = 0; i < kChannels; ++i) acc.c[i] += a * val.c[i];
    }
  }
  const float count = fmaxf(static_cast<float>(n_valid), 1.0f);
  typename V::Raw* o =
      reinterpret_cast<typename V::Raw*>(out + t * kChannels);
#pragma unroll
  for (int i = 0; i < kChannels / V::kLanes; ++i) {
    float f[V::kLanes];
#pragma unroll
    for (int l = 0; l < V::kLanes; ++l)
      f[l] = acc.c[i * V::kLanes + l] / count;
    o[i] = V::pack(f);
  }
}

template <typename T>
int launch(const void* tk, const void* wk, const void* wv, const void* valid,
           void* out, int N, int B, long long P, long long tk_batch,
           long long tk_pitch, long long w_neighbour, long long w_batch,
           long long w_pitch, void* stream) {
  const long long total = static_cast<long long>(B) * P;
  if (total == 0) return 0;
  if (N < 1 || N > kMaxNeighbours) return cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  epipolar_attention_kernel<T>
      <<<static_cast<unsigned int>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(tk), static_cast<const T*>(wk),
          static_cast<const T*>(wv), static_cast<const int*>(valid),
          static_cast<T*>(out), N, B, P, tk_batch, tk_pitch, w_neighbour,
          w_batch, w_pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tk: B batch entries of P voxels of 16 channels (float32, or bfloat16 in
// the _bf16 instance), entry b voxel p at tk + b * tk_batch + p * tk_pitch
// (elements). wk, wv: N neighbours of the same, neighbour n at
// + n * w_neighbour + b * w_batch + p * w_pitch. valid [N, B] int32. out
// [B, P, 16] contiguous, of tk's type. Every row is 16-byte aligned and
// 1 <= N <= 8 (checked by the Python wrapper). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int epipolar_attention_f32(
    const void* tk, const void* wk, const void* wv, const void* valid,
    void* out, int N, int B, long long P, long long tk_batch,
    long long tk_pitch, long long w_neighbour, long long w_batch,
    long long w_pitch, void* stream) {
  return launch<float>(tk, wk, wv, valid, out, N, B, P, tk_batch, tk_pitch,
                       w_neighbour, w_batch, w_pitch, stream);
}

extern "C" int epipolar_attention_bf16(
    const void* tk, const void* wk, const void* wv, const void* valid,
    void* out, int N, int B, long long P, long long tk_batch,
    long long tk_pitch, long long w_neighbour, long long w_batch,
    long long w_pitch, void* stream) {
  return launch<__nv_bfloat16>(tk, wk, wv, valid, out, N, B, P, tk_batch,
                               tk_pitch, w_neighbour, w_batch, w_pitch,
                               stream);
}
