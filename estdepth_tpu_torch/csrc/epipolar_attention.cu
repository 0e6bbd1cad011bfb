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
// the voxel pitch in floats, so no contiguous copy of the 2N half-volumes
// is made.
//
// Bound on the card: bytes. tk, N keys and N values are read once and the
// output is written once: (2 + 2N) * B * D*H*W * 64 bytes, 168 MB at the
// Joint window's shapes (N = 3, 64 x 64 x 80 voxels). A thread's 64-byte
// rows are 16-byte loads whose sectors its neighbours in the warp do not
// share, so the loads rely on L1 to use both halves of each 32-byte sector.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNeighbours = 8;
constexpr int kC4 = 4;  // 16 channels as 4 float4
constexpr float kNegInf = -1e9f;

struct Row {
  float4 q[kC4];
};

__device__ __forceinline__ Row load_row(const float* __restrict__ p) {
  Row r;
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kC4; ++i) r.q[i] = __ldg(p4 + i);
  return r;
}

__device__ __forceinline__ float dot(const Row& a, const Row& b) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kC4; ++i) {
    s += a.q[i].x * b.q[i].x;
    s += a.q[i].y * b.q[i].y;
    s += a.q[i].z * b.q[i].z;
    s += a.q[i].w * b.q[i].w;
  }
  return s;
}

__global__ void epipolar_attention_kernel(
    const float* __restrict__ tk, const float* __restrict__ wk,
    const float* __restrict__ wv, const int* __restrict__ valid,
    float* __restrict__ out, int N, int B, long long P, long long tk_batch,
    long long tk_pitch, long long w_neighbour, long long w_batch,
    long long w_pitch) {
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
  for (int i = 0; i < kC4; ++i) acc.q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int n = 0; n < kMaxNeighbours; ++n) {
    if (n < N && __ldg(valid + n * B + b) != 0) {
      const float a = logit[n] / denom;
      const Row val = load_row(wv + n * w_neighbour + w_off);
#pragma unroll
      for (int i = 0; i < kC4; ++i) {
        acc.q[i].x += a * val.q[i].x;
        acc.q[i].y += a * val.q[i].y;
        acc.q[i].z += a * val.q[i].z;
        acc.q[i].w += a * val.q[i].w;
      }
    }
  }
  const float count = fmaxf(static_cast<float>(n_valid), 1.0f);
  float4* o = reinterpret_cast<float4*>(out + t * (4 * kC4));
#pragma unroll
  for (int i = 0; i < kC4; ++i) {
    o[i] = make_float4(acc.q[i].x / count, acc.q[i].y / count,
                       acc.q[i].z / count, acc.q[i].w / count);
  }
}

}  // namespace

// tk: B batch entries of P voxels of 16 f32 channels, entry b voxel p at
// tk + b * tk_batch + p * tk_pitch (floats). wk, wv: N neighbours of the
// same, neighbour n at + n * w_neighbour + b * w_batch + p * w_pitch.
// valid [N, B] int32. out [B, P, 16] contiguous. Every row is 16-byte
// aligned and 1 <= N <= 8 (checked by the Python wrapper). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int epipolar_attention_f32(
    const void* tk, const void* wk, const void* wv, const void* valid,
    void* out, int N, int B, long long P, long long tk_batch,
    long long tk_pitch, long long w_neighbour, long long w_batch,
    long long w_pitch, void* stream) {
  const long long total = static_cast<long long>(B) * P;
  if (total == 0) return 0;
  if (N < 1 || N > kMaxNeighbours) return cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  epipolar_attention_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tk), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<const int*>(valid),
      static_cast<float*>(out), N, B, P, tk_batch, tk_pitch, w_neighbour,
      w_batch, w_pitch);
  return static_cast<int>(cudaGetLastError());
}
