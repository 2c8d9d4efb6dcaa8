// LSTM layer over a whole sequence, forward only (the serving encoders).
//
// Replaces: mmqg_tpu/ops/lstm_pallas.py::lstm_layer_pallas (its ``_kernel``).
// Per step: gates = x_t.Wx + h.Wh + b; i, f, o = sigmoid, g = tanh;
// c = f*c + i*g; h = o*tanh(c). Output h_t is zeroed for t >= length and
// (h, c) at length-1 is latched into separate outputs. Operands are in the
// compute type Op (bf16 or f32); products, sums, gates and state are f32.
//
// What bounds it on the H100: the recurrence. Step t needs all of h_{t-1},
// so the T steps are a chain of dependent (B,H)x(H,4H) products: at B=32,
// H=512 each is 67 MFLOP and reads Wh (2 MiB in bf16) -- far too little work
// to fill 132 SMs, so every step costs about one launch plus one pass over Wh
// from L2 (50 MB: Wh stays resident there across the T steps). The TPU kernel
// kept Wx and Wh in VMEM over a sequential time grid; Hopper blocks run in no
// order and one SM's 227 KB of shared memory cannot hold Wh (2 MiB).
//
// Design (simple and right first):
//  1. input_proj_kernel: x.Wx + b for all B*T rows at once, a tiled SIMT GEMM
//     (no recurrence, so it leaves the time loop; 11-19 GFLOP per layer at
//     the text encoder's shapes).
//  2. lstm_step_kernel, one launch per step: block (j, r) owns hidden units
//     [j*J, (j+1)*J) for batch rows [r*BB, (r+1)*BB) and computes all four
//     gate columns of those units from h_{t-1}.Wh, so the cell update stays
//     inside the block. h ping-pongs between two buffers; c is updated in
//     place (only its owning thread reads it).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: 7.2 ms per 283-step text
// layer at B=32 bf16, 22.8 us a step -- several launches' worth, as each
// step block also reloads its 64 KB slice of Wh and runs a 512-long serial
// FMA chain. A persistent kernel with a grid barrier, or a cluster holding
// Wh in distributed shared memory, would remove the per-step launches.
#include <cstdint>

#include "common.cuh"

namespace mmqg {
namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16;  // input-projection tile
constexpr int kJ = 8;                        // hidden units per step block
constexpr int kG = 4 * kJ;                   // gate columns per step block
constexpr int kBB = 16;                      // batch rows per step block
constexpr int kStepThreads = kG * (kBB / 2); // 256: two rows per thread

// C[M,N] = A[M,K] . B[K,N] + bias[N]; A and B in Op, C and bias in f32.
template <typename Op>
__global__ void __launch_bounds__(256)
input_proj_kernel(const Op* __restrict__ A, const Op* __restrict__ B,
                  const float* __restrict__ bias, float* __restrict__ C,
                  int M, int N, int K) {
  __shared__ float As[kTK][kTM + 4];
  __shared__ float Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16x16 threads, 4x4 outputs each
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = tid; i < kTM * kTK; i += 256) {
      const int r = i / kTK, kk = i % kTK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(A[(size_t)gr * K + gk]) : 0.0f;
    }
    for (int i = tid; i < kTK * kTN; i += 256) {
      const int kk = i / kTN, c = i % kTN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? to_f32(B[(size_t)gk * N + gc]) : 0.0f;
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
      if (c < N) C[(size_t)r * N + c] = acc[i][j] + bias[c];
    }
  }
}

// One time step t. Dynamic shared memory: hs (kBB x H) and ws (H x kG), f32.
template <typename Op>
__global__ void __launch_bounds__(kStepThreads)
lstm_step_kernel(const float* __restrict__ xproj,  // (B, T, 4H)
                 const Op* __restrict__ wh,         // (H, 4H)
                 const float* __restrict__ h_prev, // (B, H)
                 float* __restrict__ h_next,       // (B, H)
                 float* __restrict__ c,            // (B, H), in place
                 const int* __restrict__ lengths,  // (B,)
                 float* __restrict__ out,          // (B, T, H)
                 float* __restrict__ h_last,       // (B, H)
                 float* __restrict__ c_last,       // (B, H)
                 int B, int T, int H, int t) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* ws = smem + kBB * H;
  __shared__ float gs[kBB][kG];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ;
  const int b0 = blockIdx.y * kBB;
  const int H4 = 4 * H;

  for (int i = tid; i < kBB * H; i += kStepThreads) {
    const int b = b0 + i / H;
    hs[i] = b < B ? round_to<Op>(h_prev[(size_t)b * H + i % H]) : 0.0f;
  }
  for (int i = tid; i < H * kG; i += kStepThreads) {
    const int k = i / kG, col = i % kG;
    ws[i] = to_f32(wh[(size_t)k * H4 + (col / kJ) * H + j0 + col % kJ]);
  }
  __syncthreads();

  const int col = tid % kG;  // gate column within the block
  const int rg = tid / kG;   // rows rg and rg + kBB/2
  const float* h0p = hs + rg * H;
  const float* h1p = hs + (rg + kBB / 2) * H;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float w = ws[k * kG + col];
    acc0 = fmaf(h0p[k], w, acc0);
    acc1 = fmaf(h1p[k], w, acc1);
  }
  const int gcol = (col / kJ) * H + j0 + col % kJ;
  {
    const int b = b0 + rg;
    gs[rg][col] = b < B ? xproj[((size_t)b * T + t) * H4 + gcol] + acc0 : 0.0f;
    const int b1 = b + kBB / 2;
    gs[rg + kBB / 2][col] =
        b1 < B ? xproj[((size_t)b1 * T + t) * H4 + gcol] + acc1 : 0.0f;
  }
  __syncthreads();

  if (tid < kBB * kJ) {
    const int r = tid / kJ, jj = tid % kJ;
    const int b = b0 + r;
    if (b < B) {
      const float ig = sigmoid_f32(gs[r][jj]);
      const float fg = sigmoid_f32(gs[r][kJ + jj]);
      const float gg = tanhf(gs[r][2 * kJ + jj]);
      const float og = sigmoid_f32(gs[r][3 * kJ + jj]);
      const size_t s = (size_t)b * H + j0 + jj;
      const float c_new = fg * c[s] + ig * gg;
      const float h_new = og * tanhf(c_new);
      c[s] = c_new;
      h_next[s] = h_new;
      const int len = lengths[b];
      out[((size_t)b * T + t) * H + j0 + jj] =
          t < len ? h_new : 0.0f;
      if (t == len - 1) {
        h_last[s] = h_new;
        c_last[s] = c_new;
      }
    }
  }
}

template <typename Op>
int run(const void* x, const void* wx, const void* wh, const void* bias,
        const void* lengths, void* xproj, void* hbuf, void* c, void* out,
        void* h_last, void* c_last, int B, int T, int In, int H,
        cudaStream_t stream) {
  const int M = B * T, N = 4 * H;
  dim3 pgrid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  input_proj_kernel<Op><<<pgrid, 256, 0, stream>>>(
      static_cast<const Op*>(x), static_cast<const Op*>(wx),
      static_cast<const float*>(bias), static_cast<float*>(xproj), M, N, In);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * (size_t)(kBB * H + H * kG);
  err = cudaFuncSetAttribute(lstm_step_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 sgrid(H / kJ, (B + kBB - 1) / kBB);
  float* h = static_cast<float*>(hbuf);
  for (int t = 0; t < T; ++t) {
    float* h_prev = h + (size_t)(t % 2) * B * H;
    float* h_next = h + (size_t)((t + 1) % 2) * B * H;
    lstm_step_kernel<Op><<<sgrid, kStepThreads, smem, stream>>>(
        static_cast<const float*>(xproj), static_cast<const Op*>(wh), h_prev,
        h_next, static_cast<float*>(c), static_cast<const int*>(lengths),
        static_cast<float*>(out), static_cast<float*>(h_last),
        static_cast<float*>(c_last), B, T, H, t);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg

// x (B,T,In) and wx (In,4H), wh (H,4H) in the compute type (bf16 when
// ``bf16`` is set, else f32); bias (4H) f32; lengths (B) int32.
// Scratch: xproj (B,T,4H) f32, hbuf (2,B,H) f32 with hbuf[0] = h0.
// c (B,H) f32 holds c0 on entry. h_last/c_last (B,H) hold h0/c0 on entry.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mmqg_lstm_seq(const void* x, const void* wx, const void* wh,
                             const void* bias, const void* lengths,
                             void* xproj, void* hbuf, void* c, void* out,
                             void* h_last, void* c_last, int B, int T, int In,
                             int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::run<__nv_bfloat16>(x, wx, wh, bias, lengths, xproj, hbuf, c,
                                    out, h_last, c_last, B, T, In, H, s);
  return mmqg::run<float>(x, wx, wh, bias, lengths, xproj, hbuf, c, out,
                          h_last, c_last, B, T, In, H, s);
}
