// Trainable LSTM layer: forward emitting the BPTT residuals, and the
// reverse-time backward with its weight-gradient products (K4).
//
// Replaces: mmqg_tpu/ops/lstm_train_pallas.py::lstm_layer_train -- its
// ``_fwd_kernel`` (launched by ``_forward``) and ``_bwd_kernel`` (launched by
// ``_bwd_rule``). Semantics are ``layers.lstm_scan`` for one layer: no mask,
// no latch; gate order i, f, g, o. Rounding follows the Pallas kernel: every
// product takes its operands (x, h, da, Wx, Wh) rounded to the compute type
// Op (bf16 or f32) and sums in f32; gates, state and gradients stay f32.
//
// Layouts (row r = b*T + t throughout): x (B,T,In) Op; out/cseq (B,T,H) f32;
// gates (B,T,4H) f32 post-activation; da (B,T,4H) f32.
//
// What bounds it on the H100: the two recurrences. Forward step t needs all
// of h_{t-1} and backward step t needs all of da_{t+1}, so each direction is
// a chain of T dependent (B,H)x(H,4H) products -- 67 MFLOP each at B=32,
// H=512, far too little to fill 132 SMs -- and every step costs about one
// launch plus one pass over Wh from L2 (2 MiB in bf16, resident in the 50 MB
// L2). The TPU kernels kept Wx, Wh and the weight-gradient sums in VMEM over
// a sequential grid; here blocks run in no order, one SM cannot hold Wh, and
// nothing carries over between blocks. So everything without a recurrence
// leaves the time loop:
//  1. gemm_kernel, a tiled SIMT GEMM with strides (so transposes need no
//     copy) and operands rounded to Op on load, computes the input
//     projection x.Wx + b (forward) and, after the backward sweep,
//     dx = DA.Wx^T, dWx = X^T.DA and dWh = H_prev^T.DA over all B*T rows at
//     once (11-19 GFLOP each at the text encoder's shapes). The Pallas kernel
//     summed dWx/dWh step by step in VMEM; one GEMM over T is the same sum.
//  2. fwd_step_kernel, one launch per step (K1's design, lstm_seq.cu): block
//     (j, r) owns hidden units [j*8, j*8+8) of 16 batch rows and all four
//     gate columns of them, so the cell update stays in the block. The input
//     projection is written into ``gates`` and overwritten in place by the
//     post-activation gates, so no separate projection buffer is needed.
//  3. bwd_step_kernel, T + 1 launches in reverse time: launch t first forms
//     dh_t = da_{t+1}.Wh^T for its 8 units (a warp per unit, lanes split the
//     4H contraction, da_{t+1} of its 8 rows staged in shared memory), then
//     the elementwise cell backward for those units, writing da_t and the
//     carried dc in place. The last launch (t = -1) only forms dh0.
//  4. colsum_kernel: db = the column sums of DA (f32, deterministic).
// The sequences are laid out (B, T, ...) rather than the Pallas kernel's
// (T, B, ...): the public outputs are (B, T, H), so nothing is transposed.
// A simple design that is right first: wgmma products, TMA and a persistent
// sweep that keeps Wh on chip are later work.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, B=32 bf16, one 283-step
// text layer: forward 6.5 ms (20 us a step), backward 11.6 ms, of which the
// 284 step launches take ~7.6 ms (27 us a step) and the three weight and
// input-gradient GEMMs the rest.
#include <cstdint>

#include "common.cuh"

namespace mmqg {
namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16;   // GEMM tile
constexpr int kJ = 8;                         // hidden units per step block
constexpr int kG = 4 * kJ;                    // gate columns per fwd block
constexpr int kFB = 16;                       // batch rows per fwd block
constexpr int kFThreads = kG * (kFB / 2);     // 256: two rows per thread
constexpr int kBB = 8;                        // batch rows per bwd block
constexpr int kBThreads = 32 * kJ;            // 256: a warp per hidden unit

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

// Forward step t. ``gates`` holds x.Wx + b on entry and the post-activation
// gates on exit. Dynamic shared memory: hs (kFB x H) and ws (H x kG), f32.
template <typename Op>
__global__ void __launch_bounds__(kFThreads)
fwd_step_kernel(float* __restrict__ gates, const Op* __restrict__ wh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ out, float* __restrict__ cseq,
                float* __restrict__ hT, float* __restrict__ cT, int B, int T,
                int H, int t) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* ws = smem + kFB * H;
  __shared__ float gs[kFB][kG];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ;
  const int b0 = blockIdx.y * kFB;
  const int H4 = 4 * H;

  for (int i = tid; i < kFB * H; i += kFThreads) {
    const int b = b0 + i / H, k = i % H;
    float h = 0.0f;
    if (b < B) h = t == 0 ? h0[(size_t)b * H + k]
                          : out[((size_t)b * T + t - 1) * H + k];
    hs[i] = round_to<Op>(h);
  }
  for (int i = tid; i < H * kG; i += kFThreads) {
    const int k = i / kG, col = i % kG;
    ws[i] = to_f32(wh[(size_t)k * H4 + (col / kJ) * H + j0 + col % kJ]);
  }
  __syncthreads();

  const int col = tid % kG;  // gate column within the block
  const int rg = tid / kG;   // rows rg and rg + kFB/2
  const float* h0p = hs + rg * H;
  const float* h1p = hs + (rg + kFB / 2) * H;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float w = ws[k * kG + col];
    acc0 = fmaf(h0p[k], w, acc0);
    acc1 = fmaf(h1p[k], w, acc1);
  }
  const int gcol = (col / kJ) * H + j0 + col % kJ;
  {
    const int b = b0 + rg;
    gs[rg][col] = b < B ? gates[((size_t)b * T + t) * H4 + gcol] + acc0 : 0.0f;
    const int b1 = b + kFB / 2;
    gs[rg + kFB / 2][col] =
        b1 < B ? gates[((size_t)b1 * T + t) * H4 + gcol] + acc1 : 0.0f;
  }
  __syncthreads();  // every pre-activation is read before any is overwritten

  if (tid < kFB * kJ) {
    const int r = tid / kJ, jj = tid % kJ;
    const int b = b0 + r;
    if (b < B) {
      const int j = j0 + jj;
      const float ig = sigmoid_f32(gs[r][jj]);
      const float fg = sigmoid_f32(gs[r][kJ + jj]);
      const float gg = tanhf(gs[r][2 * kJ + jj]);
      const float og = sigmoid_f32(gs[r][3 * kJ + jj]);
      const size_t row = (size_t)b * T + t;
      const float c_prev = t == 0 ? c0[(size_t)b * H + j]
                                  : cseq[(row - 1) * H + j];
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      float* g = gates + row * H4 + j;
      g[0] = ig;
      g[H] = fg;
      g[2 * H] = gg;
      g[3 * H] = og;
      out[row * H + j] = h_new;
      cseq[row * H + j] = c_new;
      if (t == T - 1) {
        hT[(size_t)b * H + j] = h_new;
        cT[(size_t)b * H + j] = c_new;
      }
    }
  }
}

// Backward launch t (T-1 down to -1). dh_t = da_{t+1}.Wh^T (dhT at t = T-1),
// then the cell backward of step t: da_t into ``da``, dc carried in place.
// At t = -1 only dh0 = da_0.Wh^T is formed. Dynamic shared memory: the
// operand-rounded da_{t+1} rows of the block, kBB x 4H f32.
template <typename Op>
__global__ void __launch_bounds__(kBThreads)
bwd_step_kernel(float* __restrict__ da, const Op* __restrict__ wh,
                const float* __restrict__ dhT, const float* __restrict__ dout,
                const float* __restrict__ dcseq,
                const float* __restrict__ gates,
                const float* __restrict__ cseq, const float* __restrict__ c0,
                float* __restrict__ dc, float* __restrict__ dh0, int B, int T,
                int H, int t) {
  extern __shared__ float das[];
  __shared__ float dh_s[kBB][kJ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJ;
  const int b0 = blockIdx.y * kBB;
  const int H4 = 4 * H;

  if (t < T - 1) {
    for (int i = tid; i < kBB * H4; i += kBThreads) {
      const int b = b0 + i / H4;
      das[i] = b < B ? round_to<Op>(da[((size_t)b * T + t + 1) * H4 + i % H4])
                     : 0.0f;
    }
    __syncthreads();
    const Op* wrow = wh + (size_t)(j0 + warp) * H4;  // Wh[j, :], one warp
    float acc[kBB];
#pragma unroll
    for (int r = 0; r < kBB; ++r) acc[r] = 0.0f;
    for (int g = lane; g < H4; g += 32) {
      const float w = to_f32(wrow[g]);
#pragma unroll
      for (int r = 0; r < kBB; ++r) acc[r] = fmaf(das[r * H4 + g], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kBB; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) dh_s[r][warp] = s;
    }
  } else if (tid < kBB * kJ) {
    const int r = tid / kJ, jj = tid % kJ, b = b0 + r;
    dh_s[r][jj] = b < B ? dhT[(size_t)b * H + j0 + jj] : 0.0f;
  }
  __syncthreads();
  if (tid >= kBB * kJ) return;
  const int r = tid / kJ, jj = tid % kJ, b = b0 + r;
  if (b >= B) return;
  const int j = j0 + jj;
  const size_t s = (size_t)b * H + j;
  if (t < 0) {
    dh0[s] = dh_s[r][jj];
    return;
  }
  const size_t row = (size_t)b * T + t;
  const float* g = gates + row * H4 + j;
  const float ig = g[0], fg = g[H], gg = g[2 * H], og = g[3 * H];
  const float c_t = cseq[row * H + j];
  const float c_prev = t == 0 ? c0[s] : cseq[(row - 1) * H + j];
  const float tanh_c = tanhf(c_t);
  const float dh = dout[row * H + j] + dh_s[r][jj];
  const float dcv = dc[s] + dcseq[row * H + j] + dh * og * (1.0f - tanh_c * tanh_c);
  float* d = da + row * H4 + j;
  d[0] = dcv * gg * ig * (1.0f - ig);
  d[H] = dcv * c_prev * fg * (1.0f - fg);
  d[2 * H] = dcv * ig * (1.0f - gg * gg);
  d[3 * H] = dh * tanh_c * og * (1.0f - og);
  dc[s] = dcv * fg;
}

// out[n] = sum over m of A[m, n]: 32 columns x 8 row groups a block.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ A, float* __restrict__ out, int M,
              int N) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < N)
    for (int m = rg; m < M; m += 8) s += A[(size_t)m * N + c];
  part[rg][lane] = s;
  __syncthreads();
  if (rg == 0 && c < N) {
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += part[k][lane];
    out[c] = total;
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

template <typename Op>
int forward(const void* x, const void* wx, const void* wh, const void* bias,
            const void* h0, const void* c0, void* out, void* cseq,
            void* gates, void* hT, void* cT, int B, int T, int In, int H,
            cudaStream_t stream) {
  const int M = B * T, H4 = 4 * H;
  float* g = static_cast<float*>(gates);
  cudaError_t err = gemm<Op, Op, Op>(x, In, 1, wx, H4, 1,
                                     static_cast<const float*>(bias), g, M,
                                     H4, In, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (size_t)(kFB * H + H * kG);
  err = cudaFuncSetAttribute(fwd_step_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / kJ, (B + kFB - 1) / kFB);
  for (int t = 0; t < T; ++t) {
    fwd_step_kernel<Op><<<grid, kFThreads, smem, stream>>>(
        g, static_cast<const Op*>(wh), static_cast<const float*>(h0),
        static_cast<const float*>(c0), static_cast<float*>(out),
        static_cast<float*>(cseq), static_cast<float*>(hT),
        static_cast<float*>(cT), B, T, H, t);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int backward(const void* x, const void* hprev, const void* c0,
             const void* cseq, const void* gates, const void* wx,
             const void* wh, const void* dout, const void* dcseq,
             const void* dhT, void* da, void* dc, void* dx, void* dwx,
             void* dwh, void* db, void* dh0, int B, int T, int In, int H,
             cudaStream_t stream) {
  const int M = B * T, H4 = 4 * H;
  float* dap = static_cast<float*>(da);
  const size_t smem = sizeof(float) * (size_t)kBB * H4;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_step_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / kJ, (B + kBB - 1) / kBB);
  for (int t = T - 1; t >= -1; --t) {
    bwd_step_kernel<Op><<<grid, kBThreads, smem, stream>>>(
        dap, static_cast<const Op*>(wh), static_cast<const float*>(dhT),
        static_cast<const float*>(dout), static_cast<const float*>(dcseq),
        static_cast<const float*>(gates), static_cast<const float*>(cseq),
        static_cast<const float*>(c0), static_cast<float*>(dc),
        static_cast<float*>(dh0), B, T, H, t);
    if (t == T - 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  // dx = DA . Wx^T: (M, 4H) x (4H, In), Wx read transposed in place
  err = gemm<float, Op, Op>(dap, H4, 1, wx, 1, H4, nullptr,
                            static_cast<float*>(dx), M, In, H4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWx = X^T . DA: (In, M) x (M, 4H)
  err = gemm<Op, float, Op>(x, 1, In, dap, H4, 1, nullptr,
                            static_cast<float*>(dwx), In, H4, M, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWh = H_prev^T . DA: (H, M) x (M, 4H)
  err = gemm<float, float, Op>(hprev, 1, H, dap, H4, 1, nullptr,
                               static_cast<float*>(dwh), H, H4, M, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<(H4 + 31) / 32, 256, 0, stream>>>(
      dap, static_cast<float*>(db), M, H4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg

// Forward. x (B,T,In), wx (In,4H), wh (H,4H) in the compute type (bf16 when
// ``bf16`` is set, else f32); bias (4H), h0/c0 (B,H) f32. Writes out and
// cseq (B,T,H), gates (B,T,4H) post-activation, hT/cT (B,H), all f32.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mmqg_lstm_train_fwd(const void* x, const void* wx,
                                   const void* wh, const void* bias,
                                   const void* h0, const void* c0, void* out,
                                   void* cseq, void* gates, void* hT, void* cT,
                                   int B, int T, int In, int H, int bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::forward<__nv_bfloat16>(x, wx, wh, bias, h0, c0, out, cseq,
                                        gates, hT, cT, B, T, In, H, s);
  return mmqg::forward<float>(x, wx, wh, bias, h0, c0, out, cseq, gates, hT,
                              cT, B, T, In, H, s);
}

// Backward. x, wx, wh as in the forward (compute type); hprev (B,T,H) f32 is
// h_{t-1} per row (h0 at t = 0); c0, cseq, gates from the forward; the
// cotangents dout, dcseq (B,T,H), dhT (B,H) f32. Scratch da (B,T,4H) f32;
// dc (B,H) f32 holds dcT on entry and dc0 on exit. Writes dx (B,T,In),
// dwx (In,4H), dwh (H,4H), db (4H), dh0 (B,H), all f32.
extern "C" int mmqg_lstm_train_bwd(
    const void* x, const void* hprev, const void* c0, const void* cseq,
    const void* gates, const void* wx, const void* wh, const void* dout,
    const void* dcseq, const void* dhT, void* da, void* dc, void* dx,
    void* dwx, void* dwh, void* db, void* dh0, int B, int T, int In, int H,
    int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::backward<__nv_bfloat16>(x, hprev, c0, cseq, gates, wx, wh,
                                         dout, dcseq, dhT, da, dc, dx, dwx,
                                         dwh, db, dh0, B, T, In, H, s);
  return mmqg::backward<float>(x, hprev, c0, cseq, gates, wx, wh, dout, dcseq,
                               dhT, da, dc, dx, dwx, dwh, db, dh0, B, T, In,
                               H, s);
}
