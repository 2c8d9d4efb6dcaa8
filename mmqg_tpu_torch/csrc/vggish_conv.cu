// VGGish conv2..conv6: a 3x3 SAME, stride-1 conv over NHWC activations with
// HWIO weights, bias and ReLU fused, and an optional 2x2 max pool fused into
// the epilogue. Three kernels:
//
// vggish_conv_tc_kernel (K3, bf16). Replaces: mmqg_tpu/ops/vggish_pallas.py::
// vggish_features_pallas (its ``_kernel_a``, :137, and ``_kernel_b``, :150).
// bf16 operands, f32 sums; the epilogue is relu(acc + b) in f32, rounded to
// bf16, then pooled -- the Pallas arithmetic of ``_conv3x3_relu`` and
// ``_pool2`` (the bias is added to the f32 sum before rounding, unlike
// layers.conv2d, which rounds first). Route: a tensor-core implicit GEMM on
// wgmma.m64n128k16 (bf16 -> f32) from 128-byte-swizzled shared-memory tiles
// that a 3-stage cp.async ring fills (tensor_core.cuh): M = output
// positions, N = Cout, K = 9 taps x Cin; a block of two warpgroups owns 128
// positions x 128 output channels and walks K 64 channels of one tap at a
// time (the design note is above the kernel). TMA loads and a
// warp-specialised producer are later work.
//
// vggish_conv_kernel<float> (K3, f32). SIMT, as first written: tensor cores
// have no f32 product (TF32 keeps 10 mantissa bits, outside the f32
// tolerance). A block owns a 4 x 8 tile of output positions of one example
// and 128 output channels and walks the input channels in chunks of 8,
// staging the 6 x 10 input patch (zero-filled at the image border) and the
// 9 x 8 x 128 weight slice in shared memory; each of the 256 threads holds
// one 2 x 2 window of positions for 4 channels, so the pool is a max over
// its own registers.
//
// vggish_conv_int8_kernel. Replaces: the int8 conv of mmqg_tpu/models/
// audio_encoder.py::embed_examples_int8 (an XLA conv there, int8 x int8 ->
// int32). The f32 kernel's design with int8 activations and weights and
// int32 sums (__dp4a); the epilogue is relu(float(acc) * (sx[n] * sw[c]) +
// b[c]) with three roundings, as JAX computes it (__fmul_rn/__fadd_rn: no
// FMA contraction), rounded to T, then pooled. sx is one scale per example,
// sw one per output channel. Weights arrive packed (3, 3, Cin/4, Cout)
// int32: each word holds four consecutive input channels of one output
// channel, the operand layout of __dp4a.
//
// Pooling comes after the rounding to T, as in JAX; rounding is monotone, so
// pooling first would give the same values.
//
// What bounds them on the H100: operations. conv2..conv6 are 0.793 G MAC per
// 96 x 64 example (1.88 TFLOP at the serving batch's 1184 examples) against
// ~0.3 GB of activations and weights: the bf16 bound is 1.9 ms at 989
// TFLOP/s, the int8 bound 0.95 ms at 1979 TOP/s, f32 28 ms at 67 TFLOP/s.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, conv2..conv6 at N=1184
// (chip_smoke.py): the first, SIMT bf16 kernel took 95.3-96.0 ms; this
// wgmma kernel takes 4.2 ms (~450 TFLOP/s, 2.2x its bound; cuDNN's bf16
// conv2..conv6 6.1 ms). An mma.sync version of the same tiling took 6.5
// ms; deeper rings that leave one block per SM were slower. The f32 SIMT
// kernel 95.4 ms, vggish_conv_int8 24.5 ms.
//
// The Pallas kernels kept a tile of examples' activations in VMEM through
// whole runs of the stack; Hopper's 227 KB of shared memory holds neither a
// layer's weights (up to 4.5 MiB in bf16) nor an example's activations at
// conv2 (96 KB in bf16), so each layer is one launch over all examples. The
// TPU's example tiling (8 examples, padded) was a VMEM artefact and is gone:
// any N >= 1 works, a ragged last tile is masked.
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace mmqg {
namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 4, kTileW = 8;  // output positions of a block
constexpr int kTileC = 128;            // output channels of a block
constexpr int kPatchH = kTileH + 2, kPatchW = kTileW + 2;
constexpr int kPatch = kPatchH * kPatchW;
constexpr int kChunkF = 8;  // input channels per stage, float path
constexpr int kWordsI = 8;  // input words (4 channels each) per stage, int8

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch/JAX casts
}

// Shared by both kernels: ``v[p][j]`` holds relu(...) of position p of the
// thread's 2 x 2 window (p = 2*dy + dx) and channel co0 + 4*cg + j, already
// rounded to T (held in f32). Stores the window, or its max when pooling.
template <typename T>
__device__ __forceinline__ void store_window(const float (&v)[4][4],
                                             T* __restrict__ y, int n, int H,
                                             int W, int Cout, int gy, int gx,
                                             int co, int pool) {
  if (pool) {
    const int Ho = H / 2, Wo = W / 2, oy = gy / 2, ox = gx / 2;
    if (oy >= Ho || ox >= Wo) return;
    T* out = y + (((size_t)n * Ho + oy) * Wo + ox) * Cout + co;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = from_f32<T>(
          fmaxf(fmaxf(v[0][j], v[1][j]), fmaxf(v[2][j], v[3][j])));
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int yy = gy + (p >> 1), xx = gx + (p & 1);
    if (yy >= H || xx >= W) continue;
    T* out = y + (((size_t)n * H + yy) * W + xx) * Cout + co;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = from_f32<T>(v[p][j]);
  }
}

// Block coordinates shared by both kernels.
struct Tile {
  int n, y0, x0, co0, cg, wy, wx;
  __device__ Tile(int tiles_x, int tiles_per_image) {
    n = blockIdx.x / tiles_per_image;
    const int t = blockIdx.x - n * tiles_per_image;
    y0 = (t / tiles_x) * kTileH;
    x0 = (t % tiles_x) * kTileW;
    co0 = blockIdx.y * kTileC;
    cg = threadIdx.x & 31;          // channel group: 4 channels
    const int wg = threadIdx.x >> 5;  // window: 2 rows x 4 columns of them
    wy = wg >> 2;
    wx = wg & 3;
  }
};

// x (N, H, W, Cin) T; w (3, 3, Cin, Cout) T; bias (Cout) f32;
// y (N, H', W', Cout) T with H' = H/2, W' = W/2 when pooling.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vggish_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y, int H,
                   int W, int Cin, int Cout, int tiles_x, int tiles_per_image,
                   int pool) {
  __shared__ float patch[kPatch * kChunkF];
  __shared__ __align__(16) float wsm[9 * kChunkF * kTileC];
  const Tile tl(tiles_x, tiles_per_image);
  const int tid = threadIdx.x;
  const T* xn = x + (size_t)tl.n * H * W * Cin;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += kChunkF) {
    for (int i = tid; i < kPatch * kChunkF; i += kThreads) {
      const int c = i % kChunkF, pos = i / kChunkF;
      const int gy = tl.y0 + pos / kPatchW - 1, gx = tl.x0 + pos % kPatchW - 1;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(xn[((size_t)gy * W + gx) * Cin + c0 + c]);
      patch[i] = v;
    }
    for (int i = tid; i < 9 * kChunkF * kTileC; i += kThreads) {
      const int co = i % kTileC, r = i / kTileC;  // r = tap * kChunkF + c
      const int c = r % kChunkF, tap = r / kChunkF;
      wsm[i] = to_f32(w[((size_t)tap * Cin + c0 + c) * Cout + tl.co0 + co]);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int c = 0; c < kChunkF; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(
            &wsm[(tap * kChunkF + c) * kTileC + tl.cg * 4]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int py = 2 * tl.wy + (p >> 1) + ky;
          const int px = 2 * tl.wx + (p & 1) + kx;
          const float a = patch[(py * kPatchW + px) * kChunkF + c];
          acc[p][0] = fmaf(a, wv.x, acc[p][0]);
          acc[p][1] = fmaf(a, wv.y, acc[p][1]);
          acc[p][2] = fmaf(a, wv.z, acc[p][2]);
          acc[p][3] = fmaf(a, wv.w, acc[p][3]);
        }
      }
    }
    __syncthreads();
  }

  const int co = tl.co0 + tl.cg * 4;
  float v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = bias[co + j];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      v[p][j] = round_to<T>(fmaxf(__fadd_rn(acc[p][j], b), 0.0f));
  }
  store_window<T>(v, y, tl.n, H, W, Cout, tl.y0 + 2 * tl.wy,
                  tl.x0 + 2 * tl.wx, co, pool);
}

// xq (N, H, W, Cin) int8; wq (3, 3, Cin/4, Cout) int32 (4 channels a word);
// sx (N) f32; sw (Cout) f32; bias (Cout) f32; y as vggish_conv_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vggish_conv_int8_kernel(const int8_t* __restrict__ xq,
                        const int* __restrict__ wq,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int H, int W, int Cin, int Cout, int tiles_x,
                        int tiles_per_image, int pool) {
  __shared__ int patch[kPatch * kWordsI];
  __shared__ __align__(16) int wsm[9 * kWordsI * kTileC];
  const Tile tl(tiles_x, tiles_per_image);
  const int tid = threadIdx.x;
  const int cw = Cin / 4;  // words per position
  const int* xn = reinterpret_cast<const int*>(xq + (size_t)tl.n * H * W * Cin);
  int acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0;

  for (int c0 = 0; c0 < cw; c0 += kWordsI) {
    for (int i = tid; i < kPatch * kWordsI; i += kThreads) {
      const int c = i % kWordsI, pos = i / kWordsI;
      const int gy = tl.y0 + pos / kPatchW - 1, gx = tl.x0 + pos % kPatchW - 1;
      int v = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xn[((size_t)gy * W + gx) * cw + c0 + c];
      patch[i] = v;
    }
    for (int i = tid; i < 9 * kWordsI * kTileC; i += kThreads) {
      const int co = i % kTileC, r = i / kTileC;  // r = tap * kWordsI + c
      const int c = r % kWordsI, tap = r / kWordsI;
      wsm[i] = wq[((size_t)tap * cw + c0 + c) * Cout + tl.co0 + co];
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int c = 0; c < kWordsI; ++c) {
        const int4 wv = *reinterpret_cast<const int4*>(
            &wsm[(tap * kWordsI + c) * kTileC + tl.cg * 4]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int py = 2 * tl.wy + (p >> 1) + ky;
          const int px = 2 * tl.wx + (p & 1) + kx;
          const int a = patch[(py * kPatchW + px) * kWordsI + c];
          acc[p][0] = __dp4a(a, wv.x, acc[p][0]);
          acc[p][1] = __dp4a(a, wv.y, acc[p][1]);
          acc[p][2] = __dp4a(a, wv.z, acc[p][2]);
          acc[p][3] = __dp4a(a, wv.w, acc[p][3]);
        }
      }
    }
    __syncthreads();
  }

  const int co = tl.co0 + tl.cg * 4;
  const float sxn = sx[tl.n];
  float v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float scale = __fmul_rn(sxn, sw[co + j]);
    const float b = bias[co + j];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float yv =
          __fadd_rn(__fmul_rn(__int2float_rn(acc[p][j]), scale), b);
      v[p][j] = round_to<T>(fmaxf(yv, 0.0f));
    }
  }
  store_window<T>(v, y, tl.n, H, W, Cout, tl.y0 + 2 * tl.wy,
                  tl.x0 + 2 * tl.wx, co, pool);
}

// ------------------------------------------------- K3 in bf16: tensor cores
//
// An implicit GEMM, C[m][co] = sum over k = (tap, c) of X(m, tap, c) .
// wk[co][k]: M = the N*H*W output positions, N = Cout, K = 9 taps x Cin.
// A block of two warpgroups owns 128 positions x 128 output channels; each
// warpgroup issues wgmma.m64n128k16 on its 64 rows, both operands read from
// shared memory, K-major with the 128-byte swizzle (tensor_core.cuh). A
// 3-stage ring holds K slices of 64 channels of one tap: the A slice is
// gathered from x by 16-byte cp.async copies, zero-filled where the tap
// falls off the image or the position is past M; the B slice is 128 rows of
// the weights packed K-major, wk (Cout, 3, 3, Cin). With ``pool`` the
// positions are taken window by window, m = 4 * pooled position +
// quadrant, so every 2x2 window lies in 4 consecutive rows of one warp's
// accumulators and the pool is a max across the 4 lanes that hold them; the
// pooled (or plain) rows are staged in shared memory and stored 16 bytes at
// a time, the output row of tile row r being m0 + r (m0 / 4 + r pooled).
constexpr int kConvBK = 64;                    // K slice: 64 channels, 1 tap
constexpr int kConvStages = 3;
constexpr int kConvTile = 128 * kConvBK;       // elements of an A or B slice
// the ring, and 1 KB to align it to the swizzle's 1024-byte groups
constexpr int kConvSmem = kConvStages * 2 * kConvTile * 2 + 1024;  // 97 KB
static_assert(kConvBK * 2 == tc::kSwzRowBytes, "a slice row is one swizzle row");

// (n, y, x) of GEMM row m.
__device__ __forceinline__ void position_of(int m, int H, int W, int pool,
                                            int& n, int& y, int& x) {
  if (pool) {
    const int Wo = W >> 1, HWo = (H >> 1) * Wo;
    const int p = m >> 2, q = m & 3;
    n = p / HWo;
    const int rem = p - n * HWo;
    y = 2 * (rem / Wo) + (q >> 1);
    x = 2 * (rem % Wo) + (q & 1);
  } else {
    n = m / (H * W);
    const int rem = m - n * H * W;
    y = rem / W;
    x = rem % W;
  }
}

// x (N, H, W, Cin) bf16; wk (Cout, 3, 3, Cin) bf16; bias (Cout) f32; y as
// vggish_conv_kernel. Cin % 64 == 0, Cout % 128 == 0. Dynamic shared
// memory: kConvSmem.
__global__ void __launch_bounds__(256)
vggish_conv_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wk,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int N, int H, int W,
                      int Cin, int Cout, int pool) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int M = N * H * W, K = 9 * Cin;
  // the Cout tiles of one M tile run back to back and share its A in L2
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int tid = threadIdx.x;
  // the thread's four A rows and B rows, tile rows r0 + 32 i, and its
  // 8-channel chunk kc of the slice: a warp writes 8 rows x 4 chunks, 4
  // chunks to each 16-byte bank group of the swizzled tile (no conflicts)
  const int r0 = (tid >> 6) * 8 + (tid & 7), kc = (tid >> 3) & 7;
  int ay[4], ax[4];
  bool aval[4];
  const bf16* abase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    int n, yy, xx;
    aval[i] = m < M;
    position_of(aval[i] ? m : 0, H, W, pool, n, yy, xx);
    ay[i] = yy;
    ax[i] = xx;
    abase[i] = x + (((size_t)n * H + yy) * W + xx) * Cin + kc * 8;
  }
  const bf16* bbase = wk + (size_t)(n0 + r0) * K + kc * 8;
  const int cpt = Cin / kConvBK;  // K slices per tap
  const int KT = 9 * cpt;
  auto load = [&](int kt, int stage) {
    bf16* As = smem + stage * 2 * kConvTile;
    bf16* Bs = As + kConvTile;
    const int tap = kt / cpt, c0 = (kt - tap * cpt) * kConvBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const int yy = ay[i] + dy, xx = ax[i] + dx;
      const bool ok = aval[i] && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* src =
          ok ? abase[i] + ((ptrdiff_t)dy * W + dx) * Cin + c0 : x;
      cp_async16(As + swz_off(r, kc), src, ok);
      cp_async16(Bs + swz_off(r, kc),
                 bbase + (size_t)32 * i * K + kt * kConvBK, true);
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  const int wg = tid >> 7;  // warpgroup: tile rows 64 wg ..
#pragma unroll
  for (int s = 0; s < kConvStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kConvStages - 2>();
    fence_proxy_async();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free
    const int nk = kt + kConvStages - 1;
    if (nk < KT) load(nk, nk % kConvStages);
    cp_async_commit();
    const bf16* As = smem + (kt % kConvStages) * 2 * kConvTile;
    const bf16* Bs = As + kConvTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kConvBK / 16; ++s)
      wgmma_m64n128k16(d, wgmma_desc(As + 64 * 64 * wg + 16 * s),
                       wgmma_desc(Bs + 16 * s));
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: relu(acc + b) in f32, rounded to bf16, pooled, staged
  constexpr int kLdO = 128 + 8;
  bf16* os = smem;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 64 * wg + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + 2 * q;
    const float b0 = bias[n0 + col], b1 = bias[n0 + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float v0 =
          round_to<bf16>(fmaxf(__fadd_rn(d[4 * nt + 2 * h], b0), 0.0f));
      float v1 =
          round_to<bf16>(fmaxf(__fadd_rn(d[4 * nt + 2 * h + 1], b1), 0.0f));
      if (pool) {  // rows 4j..4j+3 are lanes g ^ {0, 1, 2, 3}
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 8));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 8));
      }
      if (!pool || (g & 3) == 0)
        *reinterpret_cast<__nv_bfloat162*>(
            os + (pool ? row >> 2 : row) * kLdO + col) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  const int rows = pool ? 32 : 128;
  const int out0 = pool ? m0 / 4 : m0, out_rows = pool ? M / 4 : M;
  for (int i = tid; i < rows * 16; i += 256) {
    const int r = i / 16, cc = (i % 16) * 8;
    if (out0 + r < out_rows)
      *reinterpret_cast<uint4*>(y + (size_t)(out0 + r) * Cout + n0 + cc) =
          *reinterpret_cast<const uint4*>(os + r * kLdO + cc);
  }
}

// The launch both entry points share: shape checks (the kernels assume
// them), the grid, and the launch's own error.
bool bad_shape(int N, int H, int W, int Cin, int Cout, int pool, int chunk) {
  return N < 1 || H < 1 || W < 1 || Cin % chunk || Cout % kTileC ||
         (pool && (H % 2 || W % 2));
}

dim3 grid_for(int N, int H, int W, int Cout, int* tiles_x,
              int* tiles_per_image) {
  *tiles_x = (W + kTileW - 1) / kTileW;
  *tiles_per_image = *tiles_x * ((H + kTileH - 1) / kTileH);
  return dim3(N * *tiles_per_image, Cout / kTileC);
}

}  // namespace
}  // namespace mmqg

// x (N,H,W,Cin) in the compute type (bf16 when ``bf16`` is set, else f32);
// w packed K-major (Cout,3,3,Cin) in bf16, HWIO (3,3,Cin,Cout) in f32; bias
// (Cout) f32; y (N,H',W',Cout) in the compute type. Cin % 64 == 0 in bf16
// (Cin % 8 in f32), Cout % 128 == 0, H and W even when pooling. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mmqg_vggish_conv(const void* x, const void* w, const void* bias,
                                void* y, int N, int H, int W, int Cin,
                                int Cout, int pool, int bf16, void* stream) {
  using namespace mmqg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (bad_shape(N, H, W, Cin, Cout, pool, kConvBK))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        vggish_conv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kConvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long M = (long long)N * H * W;
    const dim3 grid(Cout / 128, (unsigned)((M + 127) / 128));
    vggish_conv_tc_kernel<<<grid, 256, kConvSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), N, H, W, Cin, Cout, pool);
    return static_cast<int>(cudaGetLastError());
  }
  if (bad_shape(N, H, W, Cin, Cout, pool, kChunkF))
    return static_cast<int>(cudaErrorInvalidValue);
  int tx, tpi;
  const dim3 grid = grid_for(N, H, W, Cout, &tx, &tpi);
  vggish_conv_kernel<float><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, Cin,
      Cout, tx, tpi, pool);
  return static_cast<int>(cudaGetLastError());
}

// xq (N,H,W,Cin) int8, wq (3,3,Cin/4,Cout) int32 (packed int8), sx (N),
// sw (Cout) and bias (Cout) f32; y (N,H',W',Cout) in the compute type.
// Cin % 32 == 0, Cout % 128 == 0, H and W even when pooling.
extern "C" int mmqg_vggish_conv_int8(const void* xq, const void* wq,
                                     const void* sx, const void* sw,
                                     const void* bias, void* y, int N, int H,
                                     int W, int Cin, int Cout, int pool,
                                     int bf16, void* stream) {
  using namespace mmqg;
  if (bad_shape(N, H, W, Cin, Cout, pool, 4 * kWordsI))
    return static_cast<int>(cudaErrorInvalidValue);
  int tx, tpi;
  const dim3 grid = grid_for(N, H, W, Cout, &tx, &tpi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const int* wp = static_cast<const int*>(wq);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* bp = static_cast<const float*>(bias);
  if (bf16)
    vggish_conv_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xp, wp, sxp, swp, bp, static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout,
        tx, tpi, pool);
  else
    vggish_conv_int8_kernel<float><<<grid, kThreads, 0, s>>>(
        xp, wp, sxp, swp, bp, static_cast<float*>(y), H, W, Cin, Cout, tx,
        tpi, pool);
  return static_cast<int>(cudaGetLastError());
}
