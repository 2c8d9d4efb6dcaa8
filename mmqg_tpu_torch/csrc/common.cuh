// Shared device helpers for the hand-written Hopper kernels.
//
// Operand convention (the JAX package's dtype policy): matmul operands arrive
// in the compute type T (float or __nv_bfloat16); products and sums run in
// float32; recurrent state and softmax statistics stay float32.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmqg {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float32 value to the operand type T and back: what
// ``h.astype(dtype)`` does to a float32 activation before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A float32 value in the operand type T (bf16: round to nearest even, as
// round_to and ``x.to(torch.bfloat16)`` do).
template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions. ``red`` is a shared array of at least 32 floats.
// Every thread of the block must call them; all get the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : -INFINITY;
    w = warp_max(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();  // red may be reused right after
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : 0.0f;
    w = warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

}  // namespace mmqg
