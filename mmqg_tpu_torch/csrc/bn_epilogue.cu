// The eval batchnorm epilogue of R(2+1)D-18's inference trunk: one pass
// over a conv output that applies the batchnorm, the block's shortcut and
// the ReLU, and writes the next conv's input and/or the f32 stream.
//
// x is a contiguous channels-last conv output (n, C), C % 8 == 0, bf16 (the
// bf16 trunk) or f32 (the f32 trunk), read 8 channels a thread (one 16-byte
// load of bf16, two of f32). Per element, in registers:
//   y = f32(x) * a[c] + b[c]                 (eval batchnorm, folded)
//   y = y + r        r: an f32 shortcut, or f32(rc) * a2[c] + b2[c] (the
//                    downsampling shortcut's conv output, x's dtype, and
//                    its batchnorm)
//   y = relu(y)
// then, for bf16 x, bf16(y) (round to nearest even) to y16 and/or y to
// y32; for f32 x, y to y32 (the f32 trunk's next conv reads it as it is).
// Each step is rounded as PyTorch's eval chain on the card rounds it
// (``torch.addcmul(b, x, a)`` is one fma; the add; ``relu``'s clamp, NaN
// kept), so the result is that chain's bit for bit.
//
// A grid-stride loop over the (n * C / 8) vectors, at most 8 blocks of 256
// threads an SM; a thread's channel group advances by the grid's stride
// modulo C / 8, so no division runs in the loop. a, b, a2, b2 (C floats
// each) stay in L1.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmqg {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

enum Residual { kNone = 0, kF32 = 1, kConv = 2 };

struct Args {
  const void* x;         // (n, C) bf16 or f32
  const float4* a;       // (C) scale
  const float4* b;       // (C) shift
  const float4* r32;     // (n, C) f32 shortcut (kF32)
  const void* rc;        // (n, C) shortcut conv output, x's dtype (kConv)
  const float4* a2;      // (C) its batchnorm's scale (kConv)
  const float4* b2;      // (C) and shift
  uint4* y16;            // (n, C) bf16 out, or null
  float4* y32;           // (n, C) f32 out, or null
  long long vecs;        // n * C / 8
  int groups;            // C / 8
};

__device__ __forceinline__ void unpack8(uint4 v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// the i-th 8 floats of p
__device__ __forceinline__ void load8(const float4* p, long long i,
                                      float f[8]) {
  const float4 lo = __ldg(p + 2 * i), hi = __ldg(p + 2 * i + 1);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// the v-th 8 elements of a conv output, in f32
__device__ __forceinline__ void load_act(const __nv_bfloat16* p, long long v,
                                         float f[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p) + v), f);
}

__device__ __forceinline__ void load_act(const float* p, long long v,
                                         float f[8]) {
  load8(reinterpret_cast<const float4*>(p), v, f);
}

// x * a + b rounded once, as aten's CUDA addcmul computes b + x * a (its
// product and sum are contracted into one fma)
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fmaf_rn(x, a, b);
}

// aten's ReLU (a clamp at 0 that keeps NaN)
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

template <typename In, int RES, bool RELU, bool OUT16, bool OUT32>
__global__ void __launch_bounds__(kThreads) bn_epilogue_kernel(Args p) {
  const In* x = static_cast<const In*>(p.x);
  const In* rc = static_cast<const In*>(p.rc);
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  int g = (int)(v % p.groups);
  const int step = (int)(stride % p.groups);
  for (; v < p.vecs; v += stride) {
    float y[8], a[8], b[8];
    load_act(x, v, y);
    load8(p.a, g, a);
    load8(p.b, g, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = affine(y[i], a[i], b[i]);
    if (RES == kF32) {
      float r[8];
      load8(p.r32, v, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(y[i], r[i]);
    } else if (RES == kConv) {
      float r[8];
      load_act(rc, v, r);
      load8(p.a2, g, a);
      load8(p.b2, g, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(y[i], affine(r[i], a[i], b[i]));
    }
    if (RELU) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = relu(y[i]);
    }
    if (OUT16) p.y16[v] = pack8(y);
    if (OUT32) {
      p.y32[2 * v] = make_float4(y[0], y[1], y[2], y[3]);
      p.y32[2 * v + 1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    g += step;
    if (g >= p.groups) g -= p.groups;
  }
}

template <int RES, bool RELU>
void launch(const Args& p, bool f32, int grid, cudaStream_t s) {
  using Bf16 = __nv_bfloat16;
  if (f32)
    bn_epilogue_kernel<float, RES, RELU, false, true>
        <<<grid, kThreads, 0, s>>>(p);
  else if (p.y16 && p.y32)
    bn_epilogue_kernel<Bf16, RES, RELU, true, true>
        <<<grid, kThreads, 0, s>>>(p);
  else if (p.y16)
    bn_epilogue_kernel<Bf16, RES, RELU, true, false>
        <<<grid, kThreads, 0, s>>>(p);
  else
    bn_epilogue_kernel<Bf16, RES, RELU, false, true>
        <<<grid, kThreads, 0, s>>>(p);
}

template <int RES>
void launch(const Args& p, bool relu, bool f32, int grid, cudaStream_t s) {
  if (relu)
    launch<RES, true>(p, f32, grid, s);
  else
    launch<RES, false>(p, f32, grid, s);
}

}  // namespace
}  // namespace mmqg

// One epilogue over x (positions, C) on ``stream``, x bf16 or (``f32``)
// f32: residual 0 none, 1 the f32 ``res``, 2 the ``res`` of x's dtype
// through its own a2, b2; ``relu`` last; writes y16 (bf16, bf16 x only)
// and/or y32 (f32), whichever is not null. Every pointer 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int mmqg_bn_epilogue(const void* x, const void* a, const void* b,
                                const void* res, const void* a2,
                                const void* b2, void* y16, void* y32,
                                int positions, int C, int residual, int relu,
                                int f32, void* stream) {
  using namespace mmqg;
  if (positions < 1 || C < 8 || C % 8 || residual < kNone ||
      residual > kConv || (!y16 && !y32) || (f32 && (y16 || !y32)) ||
      (residual != kNone && !res) || (residual == kConv && (!a2 || !b2)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p;
  p.x = x;
  p.a = static_cast<const float4*>(a);
  p.b = static_cast<const float4*>(b);
  p.r32 = static_cast<const float4*>(res);
  p.rc = res;
  p.a2 = static_cast<const float4*>(a2);
  p.b2 = static_cast<const float4*>(b2);
  p.y16 = static_cast<uint4*>(y16);
  p.y32 = static_cast<float4*>(y32);
  p.groups = C / 8;
  p.vecs = (long long)positions * p.groups;
  const long long need = (p.vecs + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  const int grid = (int)(need < most ? need : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual == kNone)
    launch<kNone>(p, relu != 0, f32 != 0, grid, s);
  else if (residual == kF32)
    launch<kF32>(p, relu != 0, f32 != 0, grid, s);
  else
    launch<kConv>(p, relu != 0, f32 != 0, grid, s);
  return static_cast<int>(cudaGetLastError());
}
