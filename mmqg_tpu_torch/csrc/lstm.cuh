// LSTM pieces shared by K1 (lstm_seq.cu) and K4 (lstm_train.cu): the input
// projection and gradient GEMMs, the grid barrier and residency check of
// the cooperative sweeps, the bf16 16-row mma.sync product, and the forward
// recurrence -- one persistent sweep that both kernels launch, templated on
// what it emits, with a per-step route for shapes whose blocks cannot all be
// resident.
//
// The forward of one layer (gate order i, f, g, o; operands rounded to the
// compute type Op, f32 products, sums, gates and state):
//  1. x.Wx + b for all B*T rows at once, before the recurrence: bf16 on
//     tc_gemm_kernel (mma.sync tensor cores, Wx read N-major through
//     ldmatrix.trans), f32 on gemm_kernel (SIMT, strided; TF32 stays off).
//  2. The recurrence. Block (j, r) owns hidden units [8j, 8j+8) of batch rows
//     [16r, 16r+16) and all four gate columns of them (32 columns), so the
//     cell update stays inside the block; at B=32, H=512 that is 64 x 2 =
//     128 blocks, one per SM.
//     - fwd_sweep_kernel, the persistent route: one cooperative launch for
//       all T steps (a batch larger than one grid of resident blocks holds
//       runs in row chunks, one launch each). The block keeps its 32
//       columns of Wh in shared memory throughout (transposed, so the
//       contraction is contiguous: 32 KB in bf16, 64 KB in f32) and its
//       cells' c in registers. Step t stages
//       the block's 16 rows of h_{t-1} in Op from L2 (__ldcg: other SMs
//       wrote them and L1 is not coherent; eight 16-byte reads in flight a
//       thread), forms the 16 x 32 x H product (bf16: mma.sync m16n8k16,
//       one n-tile a gate, the warps splitting the contraction; f32: SIMT
//       float4 FMAs), adds x.Wx + b (loaded a step ahead), runs the cell,
//       writes h_t in Op and meets the other blocks at grid_barrier.
//     - fwd_step_kernel, the per-step route (the first design): one launch
//       a step, the block's slice of Wh reloaded each launch and the
//       product an H-long SIMT FMA chain a thread, staged in slices of
//       512 so that any H fits (the sweep's blocks cannot all be resident
//       at H=2048, nor does its f32 Wh slice fit in shared memory there).
//     h ping-pongs between two Op buffers: hbuf[t % 2] holds h_{t-1} for
//     step t. Rounding h to Op once, when it is written, is the rounding the
//     product applies to every read of it.
// The wrapper picks the route by shape before launching (fwd_sweep_rows);
// a cooperative launch the device refuses returns its error, never falls
// back.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace mmqg {
namespace {

template <typename Op>
constexpr bool kIsBf16 = std::is_same<Op, __nv_bfloat16>::value;

constexpr int kThreads = 256;        // every LSTM kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 8;                // hidden units per block
constexpr int kG = 4 * kJ;           // gate columns per forward block
constexpr int kRows = 16;            // batch rows per sweep block
constexpr int kPartLd = kG + 8;      // partial-sum rows: the cell threads'
                                     // reads hit 32 different banks
constexpr int kTM = 64, kTN = 64, kTK = 16;  // SIMT GEMM tile
static_assert(kG == 32, "the f32 product gives a lane each gate column");

// C[M,N] = A.B (+ bias[N]), A(m,k) = A[m*sam + k*sak], B(k,n) = B[k*sbk +
// n*sbn]; operands rounded to Op, f32 products and sums, C row-major f32.
template <typename TA, typename TB, typename Op>
__global__ void __launch_bounds__(256)
gemm_kernel(const TA* __restrict__ A, int64_t sam, int64_t sak,
            const TB* __restrict__ B, int64_t sbk, int64_t sbn,
            const float* __restrict__ bias, float* __restrict__ C, int M,
            int N, int K) {
  __shared__ float As[kTK][kTM + 4];
  __shared__ float Bs[kTK][kTN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16x16 threads, 4x4 outputs each
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    // neighbouring threads take the unit-stride index of each operand
    for (int i = tid; i < kTM * kTK; i += 256) {
      const int r = sak == 1 ? i / kTK : i % kTM;
      const int kk = sak == 1 ? i % kTK : i / kTM;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K)
                      ? round_to<Op>(to_f32(A[gr * sam + gk * sak]))
                      : 0.0f;
    }
    for (int i = tid; i < kTK * kTN; i += 256) {
      const int c = sbn == 1 ? i % kTN : i / kTK;
      const int kk = sbn == 1 ? i / kTN : i % kTK;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N)
                      ? round_to<Op>(to_f32(B[gk * sbk + gc * sbn]))
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) C[(size_t)r * N + c] = acc[i][j] + (bias ? bias[c] : 0.0f);
    }
  }
}

// C[M,N] = A.B (+ bias[N]) in f32 on tensor cores: bf16 operands A(m,k) =
// A[m*lda + k] when A_KMAJOR else A[k*lda + m], B(k,n) = B[n*ldb + k] when
// B_KMAJOR else B[k*ldb + n]; C row-major. Ragged M, N and K are masked.
// Dynamic shared memory: tc::kSmemBytes.
template <bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(tc::kThreads)
tc_gemm_kernel(const __nv_bfloat16* __restrict__ A, int64_t lda,
               const __nv_bfloat16* __restrict__ B, int64_t ldb,
               const float* __restrict__ bias, float* __restrict__ C, int M,
               int N, int K) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int KT = (K + kBK - 1) / kBK;
  auto load = [&](int kt, int stage) {
    bf16* As = smem + stage * kStageElems;
    load_tile<A_KMAJOR>(As, A, lda, M, K, m0, kt * kBK);
    load_tile<B_KMAJOR>(As + kTileElems, B, ldb, N, K, n0, kt * kBK);
  };
  Acc acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free
    const int nk = kt + kStages - 1;
    if (nk < KT) load(nk, nk % kStages);
    cp_async_commit();
    const bf16* As = smem + (kt % kStages) * kStageElems;
    mma_slice<A_KMAJOR, B_KMAJOR>(As, As + kTileElems, acc);
  }
  cp_async_wait<0>();
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int wm = m0 + warp_row0(), wn = n0 + warp_col0();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + mt * 16 + g + 8 * (i >> 1);
        const int col = wn + nt * 8 + 2 * q + (i & 1);
        if (row < M && col < N)
          C[(size_t)row * N + col] =
              acc.v[mt][nt][i] + (bias ? bias[col] : 0.0f);
      }
}

template <typename TA, typename TB, typename Op>
cudaError_t gemm(const void* A, int64_t sam, int64_t sak, const void* B,
                 int64_t sbk, int64_t sbn, const float* bias, float* C, int M,
                 int N, int K, cudaStream_t stream) {
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  gemm_kernel<TA, TB, Op><<<grid, 256, 0, stream>>>(
      static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(B), sbk,
      sbn, bias, C, M, N, K);
  return cudaGetLastError();
}

template <bool A_KMAJOR, bool B_KMAJOR>
cudaError_t tc_gemm(const void* A, int64_t lda, const void* B, int64_t ldb,
                    const float* bias, float* C, int M, int N, int K,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel<A_KMAJOR, B_KMAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + tc::kBN - 1) / tc::kBN, (M + tc::kBM - 1) / tc::kBM);
  tc_gemm_kernel<A_KMAJOR, B_KMAJOR>
      <<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(
          static_cast<const __nv_bfloat16*>(A), lda,
          static_cast<const __nv_bfloat16*>(B), ldb, bias, C, M, N, K);
  return cudaGetLastError();
}

// The input projection x.Wx + b: x (M, In) and wx (In, N) in Op, bias (N)
// and xproj (M, N) f32.
template <typename Op>
cudaError_t input_proj(const void* x, const void* wx, const float* bias,
                       float* xproj, int M, int N, int In,
                       cudaStream_t stream) {
  if constexpr (kIsBf16<Op>)
    return tc_gemm<true, false>(x, In, wx, N, bias, xproj, M, N, In, stream);
  else
    return gemm<Op, Op, Op>(x, In, 1, wx, N, 1, bias, xproj, M, N, In,
                            stream);
}

// Every block of the grid waits here until all ``gridDim`` blocks have
// arrived for the ``target / blocks``-th time (``count`` starts at 0 and
// only grows). The writes before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// How many blocks of ``kernel`` (kThreads threads, ``smem`` bytes of
// dynamic shared memory) can be resident at once on the current device --
// the most a cooperative launch may have; a negative cudaError_t on
// failure.
template <typename Kernel>
int resident_blocks(Kernel* kernel, size_t smem) {
  int dev, optin, sms, per_sm;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > (size_t)optin) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// Warp w's share of P = A . B^T for A (16 x K) and B (8*NT x K), both bf16
// row-major in shared memory with row stride ``ld``: mma.sync m16n8k16 over
// the k-steps w, w + 8, ... of K (a multiple of 16), written to
// part[(w * 16 + r) * pld + n]. The caller sums the kWarps partial tiles.
template <int NT>
__device__ __forceinline__ void mma_rows16(const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int ld,
                                           int K, float* part, int pld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  auto ld32 = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  float d[NT][4] = {};
  for (int k0 = warp * 16; k0 < K; k0 += kWarps * 16) {
    const __nv_bfloat16* a = A + g * ld + k0 + 2 * q;  // rows g, g + 8
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * ld), ld32(a + 8),
                            ld32(a + 8 * ld + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* b = B + (nt * 8 + g) * ld + k0 + 2 * q;
      tc::mma_bf16(d[nt], af, ld32(b), ld32(b + 8));
    }
  }
  float* pw = part + warp * kRows * pld;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(pw + g * pld + nt * 8 + 2 * q) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * pld + nt * 8 + 2 * q) =
        make_float2(d[nt][2], d[nt][3]);
  }
}

// ------------------------------------------------------------ the forward

// One layer's forward: its operands, its state buffers and what it emits.
// ``Emit`` is called once per (row, unit, step) with the post-activation
// gates, h_t and c_t, and writes what the kernel returns.
template <typename Op, typename Emit>
struct Fwd {
  const float* xproj;  // (B, T, 4H): x.Wx + b
  const Op* wh;        // (H, 4H)
  Op* hbuf;            // (2, B, H): h_{t-1} of step t in hbuf[t % 2]
  float* c;            // (B, H): c0 on entry; the per-step route's c
  unsigned* sync;      // the sweep's grid-barrier counter
  Emit emit;
  int B, T, H;
  int row0;            // the sweep's first batch row (a launch's chunk)
};

template <typename Op, typename Emit>
__device__ __forceinline__ void load_xproj(const Fwd<Op, Emit>& p, int b,
                                           int j, int t, float (&xp)[4]) {
  const float* x = p.xproj + ((size_t)b * p.T + t) * 4 * p.H + j;
#pragma unroll
  for (int k = 0; k < 4; ++k) xp[k] = x[k * p.H];
}

// The cell of row b, unit j at step t: pre-activations x.Wx + b (``xp``)
// plus the Wh product (``hw``), from c_{t-1}. Writes h_t in Op for step
// t + 1, emits, and returns c_t.
template <typename Op, typename Emit>
__device__ __forceinline__ float cell_fwd(const Fwd<Op, Emit>& p, int b,
                                          int j, int t, const float (&xp)[4],
                                          const float (&hw)[4],
                                          float c_prev) {
  const float a[4] = {sigmoid_f32(xp[0] + hw[0]), sigmoid_f32(xp[1] + hw[1]),
                      tanhf(xp[2] + hw[2]), sigmoid_f32(xp[3] + hw[3])};
  const float c = a[1] * c_prev + a[0] * a[2];
  const float h = a[3] * tanhf(c);
  p.hbuf[((size_t)((t + 1) % 2) * p.B + b) * p.H + j] = from_f32<Op>(h);
  p.emit(b, j, t, p.T, p.H, a, h, c);
  return c;
}

// The contraction length of the sweep's product (H padded to the mma's 16)
// and the row stride of its shared tiles (16 bytes more, so the fragment
// and float4 loads of 8 or 32 lanes hit different banks).
__host__ __device__ constexpr int fwd_k(int H) { return (H + 15) / 16 * 16; }
template <typename Op>
__host__ __device__ constexpr int fwd_ld(int H) {
  return fwd_k(H) + 16 / static_cast<int>(sizeof(Op));
}
template <typename Op>
size_t fwd_sweep_smem(int H) {
  return sizeof(Op) * (size_t)(kG + kRows) * fwd_ld<Op>(H);
}

// part[w][r][n] = warp w's share of sum_k hs[r][k] . ws[n][k]. f32: lane n
// (a gate column), the 4-wide k-chunks w, w + 8, ... for all 16 rows.
__device__ __forceinline__ void hw_product(const float* hs, const float* ws,
                                           int ld, int K, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wrow = ws + lane * ld;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int k = warp * 4; k < K; k += kWarps * 4) {
    const float4 w = *reinterpret_cast<const float4*>(wrow + k);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 h = *reinterpret_cast<const float4*>(hs + r * ld + k);
      acc[r] = fmaf(h.x, w.x, acc[r]);
      acc[r] = fmaf(h.y, w.y, acc[r]);
      acc[r] = fmaf(h.z, w.z, acc[r]);
      acc[r] = fmaf(h.w, w.w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    part[(warp * kRows + r) * kPartLd + lane] = acc[r];
}

// bf16: mma.sync, one n-tile a gate
__device__ __forceinline__ void hw_product(const __nv_bfloat16* hs,
                                           const __nv_bfloat16* ws, int ld,
                                           int K, float* part) {
  mma_rows16<kG / 8>(hs, ws, ld, K, part, kPartLd);
}

// The persistent route: every step of the layer in one cooperative launch,
// grid (H / 8, row blocks), rows from p.row0 on. Dynamic shared memory (Op): ws, the block's
// 32 columns of Wh transposed (ws[n][k] = Wh[k, (n / 8) * H + 8j + n % 8]),
// and hs, its 16 rows of h_{t-1}, both fwd_ld(H) a row with zeros past H.
// ``p.sync`` is zeroed before the launch.
//
// One barrier a step is enough: step t reads hbuf[t % 2] before its block
// arrives at barrier t and writes only hbuf[(t + 1) % 2], so once every
// block has passed barrier t, nobody reads hbuf[t % 2] again until step t +
// 2 has written it anew (after barrier t + 1).
template <typename Op, typename Emit>
__global__ void __launch_bounds__(kThreads)
fwd_sweep_kernel(Fwd<Op, Emit> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float part[kWarps * kRows * kPartLd];
  const int H = p.H, K = fwd_k(H), ld = fwd_ld<Op>(H);
  Op* ws = reinterpret_cast<Op*>(smem_raw);
  Op* hs = ws + kG * ld;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ, b0 = p.row0 + blockIdx.y * kRows;
  for (int i = tid; i < kG * ld; i += kThreads) {  // neighbours: one k row
    const int k = i / kG, n = i % kG;
    ws[n * ld + k] = k < H ? p.wh[(size_t)k * 4 * H + (n / kJ) * H + j0 +
                                  n % kJ]
                           : from_f32<Op>(0.0f);
  }
  for (int i = tid; i < kRows * (ld - H); i += kThreads)  // the k padding
    hs[i / (ld - H) * ld + H + i % (ld - H)] = from_f32<Op>(0.0f);

  // the cell thread (r, jj) of the block, if it has a row
  const int r = tid / kJ, jj = tid % kJ, b = b0 + r, j = j0 + jj;
  const bool cell = tid < kRows * kJ && b < p.B;
  float c = cell ? p.c[(size_t)b * H + j] : 0.0f;
  float xp[4];
  if (cell) load_xproj(p, b, j, 0, xp);
  constexpr int kVec = 16 / sizeof(Op);  // Op values per 16-byte read
  constexpr int kBatch = 8;              // 16-byte L2 reads in flight
  const int row_vecs = H / kVec, n_vec = kRows * row_vecs;
  const unsigned blocks = gridDim.x * gridDim.y;
  for (int t = 0; t < p.T; ++t) {
    const Op* src = p.hbuf + (size_t)(t % 2) * p.B * H;
    for (int i0 = tid; i0 < n_vec; i0 += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads, rr = i / row_vecs;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n_vec && b0 + rr < p.B)
          v[u] = __ldcg(reinterpret_cast<const uint4*>(
              src + (size_t)(b0 + rr) * H + i % row_vecs * kVec));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_vec)
          *reinterpret_cast<uint4*>(hs + i / row_vecs * ld +
                                    i % row_vecs * kVec) = v[u];
      }
    }
    __syncthreads();
    hw_product(hs, ws, ld, K, part);
    __syncthreads();
    if (cell) {
      float hw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          s += part[(w * kRows + r) * kPartLd + k * kJ + jj];
        hw[k] = s;
      }
      c = cell_fwd(p, b, j, t, xp, hw, c);
      if (t + 1 < p.T) load_xproj(p, b, j, t + 1, xp);  // over the barrier
    }
    if (t + 1 < p.T) grid_barrier(p.sync, blocks * (unsigned)(t + 1));
  }
}

// The per-step route, launch t: the same blocks and cell, the block's slice
// of Wh reloaded and the product a SIMT FMA chain. The contraction is
// staged in slices of at most kStepK (f32 in dynamic shared memory: hs, 16
// rows of the slice, and ws, the slice x 32 columns, fwd_step_smem bytes),
// so any H fits; the chain runs k = 0 .. H-1 in order whatever the slices.
constexpr int kStepK = 512;
__host__ __device__ constexpr int fwd_step_k(int H) {
  return H < kStepK ? H : kStepK;
}
inline size_t fwd_step_smem(int H) {
  return sizeof(float) * (size_t)(kRows + kG) * fwd_step_k(H);
}

template <typename Op, typename Emit>
__global__ void __launch_bounds__(kThreads)
fwd_step_kernel(Fwd<Op, Emit> p, int t) {
  extern __shared__ float smem[];
  const int H = p.H, KS = fwd_step_k(H);
  float* hs = smem;
  float* ws = smem + kRows * KS;
  __shared__ float gs[kRows][kG];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ, b0 = blockIdx.y * kRows;
  const Op* h_prev = p.hbuf + (size_t)(t % 2) * p.B * H;
  const int col = tid % kG;  // gate column within the block
  const int rg = tid / kG;   // rows rg and rg + kRows/2
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k0 = 0; k0 < H; k0 += KS) {
    const int kc = min(KS, H - k0);
    for (int i = tid; i < kRows * kc; i += kThreads) {
      const int r = i / kc, k = i % kc, b = b0 + r;
      hs[r * KS + k] =
          b < p.B ? to_f32(h_prev[(size_t)b * H + k0 + k]) : 0.0f;
    }
    for (int i = tid; i < kc * kG; i += kThreads) {
      const int k = i / kG, c = i % kG;
      ws[i] = to_f32(
          p.wh[(size_t)(k0 + k) * 4 * H + (c / kJ) * H + j0 + c % kJ]);
    }
    __syncthreads();
    const float* h0p = hs + rg * KS;
    const float* h1p = hs + (rg + kRows / 2) * KS;
    for (int k = 0; k < kc; ++k) {
      const float w = ws[k * kG + col];
      acc0 = fmaf(h0p[k], w, acc0);
      acc1 = fmaf(h1p[k], w, acc1);
    }
    __syncthreads();  // the next slice overwrites hs and ws
  }
  gs[rg][col] = acc0;
  gs[rg + kRows / 2][col] = acc1;
  __syncthreads();
  const int r = tid / kJ, jj = tid % kJ, b = b0 + r, j = j0 + jj;
  if (tid < kRows * kJ && b < p.B) {
    float xp[4], hw[4];
    load_xproj(p, b, j, t, xp);
#pragma unroll
    for (int k = 0; k < 4; ++k) hw[k] = gs[r][k * kJ + jj];
    float* cs = p.c + (size_t)b * H + j;
    *cs = cell_fwd(p, b, j, t, xp, hw, *cs);
  }
}

// How many 16-row blocks of the batch one cooperative launch of the sweep
// can hold at (B, H) on the current device, at most all of them; 0 when not
// one row of blocks can be resident (the per-step route); a negative
// cudaError_t on failure.
template <typename Op, typename Emit>
int fwd_sweep_rows(int B, int H) {
  if (B < 1 || H < 8 || H % 8) return 0;
  const int n = resident_blocks(fwd_sweep_kernel<Op, Emit>,
                                fwd_sweep_smem<Op>(H));
  return n < 0 ? n : min(n / (H / kJ), (B + kRows - 1) / kRows);
}

// One layer's forward: x.Wx + b into p.xproj, then the recurrence: by the
// sweep when ``rows`` > 0, one cooperative launch for each ``rows`` 16-row
// blocks of the batch, else one launch a step. x (B,T,In) and wx (In,4H)
// in Op, bias (4H) f32. Returns the cudaError_t of the launches.
template <typename Op, typename Emit>
int lstm_forward(const void* x, const void* wx, const void* bias,
                 Fwd<Op, Emit> p, int In, int rows, cudaStream_t stream) {
  cudaError_t err = input_proj<Op>(x, wx, static_cast<const float*>(bias),
                                   const_cast<float*>(p.xproj), p.B * p.T,
                                   4 * p.H, In, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (p.B + kRows - 1) / kRows;
  const dim3 grid(p.H / kJ, row_blocks);
  if (rows > 0) {
    const size_t smem = fwd_sweep_smem<Op>(p.H);
    err = cudaFuncSetAttribute(fwd_sweep_kernel<Op, Emit>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    void* args[] = {&p};  // read at each launch
    for (int r = 0; r < row_blocks && err == cudaSuccess; r += rows) {
      p.row0 = r * kRows;
      err = cudaMemsetAsync(p.sync, 0, sizeof(unsigned), stream);
      if (err == cudaSuccess)
        err = cudaLaunchCooperativeKernel(
            reinterpret_cast<const void*>(fwd_sweep_kernel<Op, Emit>),
            dim3(p.H / kJ, min(rows, row_blocks - r)), dim3(kThreads), args,
            smem, stream);
    }
    if (err != cudaSuccess)
      cudaGetLastError();  // reported here; the next launch must not see it
    return static_cast<int>(err);
  }
  const size_t smem = fwd_step_smem(p.H);
  err = cudaFuncSetAttribute(fwd_step_kernel<Op, Emit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t = 0; t < p.T; ++t) {
    fwd_step_kernel<Op, Emit><<<grid, kThreads, smem, stream>>>(p, t);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg
