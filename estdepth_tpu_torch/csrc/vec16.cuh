// The 16-byte vector every kernel of the port loads and stores, for its two
// element types, CUDA C++ for sm_90a.
//
// A kernel is written once over an element type T and instantiated for
// float (float32) and __nv_bfloat16 (bfloat16): 16 bytes hold 4 float32
// channels or 8 bfloat16 channels, so a voxel's C channels are C / 4 or
// C / 8 vectors (the wrappers check that C is a whole number of them). A
// kernel loads a vector as Raw (float4 or uint4), unpacks it into kLanes
// floats, computes in float32 with the same operations in the same order
// for both types, and packs its result: a float32 instance stores the
// floats as they are, a bfloat16 instance rounds each once to nearest even
// (__float2bfloat16_rn), as PyTorch's .to(torch.bfloat16) does. So an
// instance equals its plain version run in float32 and then cast once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vec16 {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kLanes = 4;
  using Raw = float4;

  __device__ __forceinline__ static void unpack(const float4& r,
                                                float (&f)[kLanes]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }

  __device__ __forceinline__ static float4 pack(const float (&f)[kLanes]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kLanes = 8;
  using Raw = uint4;  // lane 2i in the low half of word i, 2i + 1 high

  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&f)[kLanes]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }

  __device__ __forceinline__ static unsigned bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }

  __device__ __forceinline__ static uint4 pack(const float (&f)[kLanes]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

}  // namespace vec16
