// Trainable LSTM layer: forward emitting the BPTT residuals, and the
// reverse-time backward with its weight-gradient products (K4).
//
// Replaces: mmqg_tpu/ops/lstm_train_pallas.py::lstm_layer_train -- its
// ``_fwd_kernel`` (launched by ``_forward``, :147) and ``_bwd_kernel``
// (launched by ``_bwd_rule``, :209). Semantics are ``layers.lstm_scan`` for
// one layer: no mask, no latch; gate order i, f, g, o. Rounding follows the
// Pallas kernel: every product takes its operands (x, h, da, Wx, Wh) rounded
// to the compute type Op (bf16 or f32) and sums in f32; gates, state and
// gradients stay f32.
//
// Layouts (row r = b*T + t throughout): x (B,T,In) Op; out/cseq (B,T,H) f32;
// gates (B,T,4H) f32 post-activation; da (B,T,4H) f32.
//
// What bounds it on the H100: the two recurrences. Forward step t needs all
// of h_{t-1} and backward step t needs all of da_{t+1}, so each direction is
// a chain of T dependent (B,H)x(H,4H) products -- 67 MFLOP each at B=32,
// H=512, far too little to fill 132 SMs. The TPU kernels kept Wx, Wh and
// the weight-gradient sums in VMEM over a sequential grid; here blocks run
// in no order and nothing carries over between launches, so everything
// without a recurrence leaves the time loop:
//  1. The products over all B*T rows at once: the forward's input
//     projection x.Wx + b, and the backward's dx = DA.Wx^T, dWx = X^T.DA and
//     dWh = H_prev^T.DA (11-19 GFLOP each at the text encoder's shapes; the
//     Pallas kernel summed dWx/dWh step by step in VMEM, one GEMM over T is
//     the same sum). In f32 they run gemm_kernel, a tiled SIMT GEMM with
//     strides (transposes need no copy) and operands rounded to Op on load.
//     The backward's three in bf16 run tc_gemm_kernel: mma.sync.m16n8k16
//     tensor-core tiles fed by a 4-stage cp.async ring (tensor_core.cuh),
//     with X and H_prev read M-major through ldmatrix.trans. Their operands
//     are the bf16 values the SIMT GEMM would round to (da_op, the sweep's
//     bf16 copy of da), so only the summation order differs.
//  2. fwd_step_kernel, one launch per step (K1's design, lstm_seq.cu): block
//     (j, r) owns hidden units [j*8, j*8+8) of 16 batch rows and all four
//     gate columns of them, so the cell update stays in the block. The input
//     projection is written into ``gates`` and overwritten in place by the
//     post-activation gates, so no separate projection buffer is needed.
//  3. The backward sweep, one persistent cooperative launch
//     (bwd_sweep_kernel): block (j, r) owns hidden units [j*8, j*8+8) of 16
//     batch rows for all T + 1 steps, keeps Wh[j*8 : j*8+8, :] in shared
//     memory throughout and the carried dc in registers. Step t stages the
//     block's rows of da_{t+1} (rounded to Op) from L2, forms dh_t = da_{t+1}
//     . Wh^T for its 8 units (a warp per unit, lanes split the 4H
//     contraction), runs the elementwise cell backward, writes da_t (f32, and
//     in bf16 its rounded copy da_op) and meets the other blocks at a grid
//     barrier (a counter in device memory; the cooperative launch guarantees
//     co-residency or fails). At B=32, H=512 that is 64 x 2 = 128 blocks
//     with 96 KB (bf16) or 192 KB (f32) of shared memory each, one per SM.
//     Shapes whose blocks cannot all be resident (e.g. H=2048) keep the
//     per-step route, bwd_step_kernel, T + 1 launches of the same step; the
//     wrapper picks the route by shape before launching
//     (mmqg_lstm_train_bwd_persistent).
//  4. colsum_kernel: db = the column sums of DA (f32, deterministic).
// The sequences are laid out (B, T, ...) rather than the Pallas kernel's
// (T, B, ...): the public outputs are (B, T, H), so nothing is transposed.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, B=32 bf16, one 283-step
// text layer (chip_smoke.py): forward 6.5 ms (20 us a step); backward 11.6
// ms with one launch a step and SIMT GEMMs (the first design), 2.1-2.2 ms
// with the persistent sweep (6-7 us a step: the grid barrier and the 64 KB
// L2 read of da_{t+1} per block) and tensor-core GEMMs; f32 6.2-6.3 ms.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace mmqg {
namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16;   // GEMM tile
constexpr int kJ = 8;                         // hidden units per step block
constexpr int kG = 4 * kJ;                    // gate columns per fwd block
constexpr int kFB = 16;                       // batch rows per fwd block
constexpr int kFThreads = kG * (kFB / 2);     // 256: two rows per thread
constexpr int kBB = 8;                        // batch rows per bwd block
constexpr int kPR = 16;                       // batch rows per sweep block
constexpr int kPad = 8;  // sweep: row padding (16 bytes in bf16), so the
                         // mma fragment loads hit 32 different banks
constexpr int kBThreads = 32 * kJ;            // 256: a warp per hidden unit

template <typename Op>
constexpr bool kIsBf16 = std::is_same<Op, __nv_bfloat16>::value;

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

// What the cell backward of step t reads for row b, unit j, besides dh.
struct CellIn {
  float ig, fg, gg, og, c_t, c_prev, dout, dcseq;
};

__device__ __forceinline__ CellIn cell_in(
    int b, int j, int t, int T, int H, const float* __restrict__ gates,
    const float* __restrict__ cseq, const float* __restrict__ c0,
    const float* __restrict__ dout, const float* __restrict__ dcseq) {
  const size_t row = (size_t)b * T + t;
  const float* g = gates + row * 4 * H + j;
  return {g[0], g[H], g[2 * H], g[3 * H], cseq[row * H + j],
          t == 0 ? c0[(size_t)b * H + j] : cseq[(row - 1) * H + j],
          dout[row * H + j], dcseq[row * H + j]};
}

// The cell backward of step t for row b, unit j: da_t (f32, and rounded to
// Op in ``da_op`` when Op is bf16) from dh_t = ``dh_rec`` + dout and the
// carried ``dc``; returns the dc carried to step t - 1.
template <typename Op>
__device__ __forceinline__ float cell_bwd(const CellIn& in, float dh_rec,
                                          float dc, int b, int j, int t,
                                          int T, int H, float* __restrict__ da,
                                          Op* __restrict__ da_op) {
  const float tanh_c = tanhf(in.c_t);
  const float dh = in.dout + dh_rec;
  const float dcv =
      dc + in.dcseq + dh * in.og * (1.0f - tanh_c * tanh_c);
  const float d[4] = {dcv * in.gg * in.ig * (1.0f - in.ig),
                      dcv * in.c_prev * in.fg * (1.0f - in.fg),
                      dcv * in.ig * (1.0f - in.gg * in.gg),
                      dh * tanh_c * in.og * (1.0f - in.og)};
  const size_t at = ((size_t)b * T + t) * 4 * H + j;
#pragma unroll
  for (int k = 0; k < 4; ++k) da[at + k * H] = d[k];
  if constexpr (kIsBf16<Op>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) da_op[at + k * H] = __float2bfloat16(d[k]);
  }
  return dcv * in.fg;
}

// Backward launch t (T-1 down to -1) of the per-step route. dh_t =
// da_{t+1}.Wh^T (dhT at t = T-1), then the cell backward of step t: da_t
// into ``da`` (and ``da_op``), dc carried in place. At t = -1 only dh0 =
// da_0.Wh^T is formed. Dynamic shared memory: the operand-rounded da_{t+1}
// rows of the block, kBB x 4H f32.
template <typename Op>
__global__ void __launch_bounds__(kBThreads)
bwd_step_kernel(float* __restrict__ da, Op* __restrict__ da_op,
                const Op* __restrict__ wh, const float* __restrict__ dhT,
                const float* __restrict__ dout,
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
  const CellIn in = cell_in(b, j, t, T, H, gates, cseq, c0, dout, dcseq);
  dc[s] = cell_bwd<Op>(in, dh_s[r][jj], dc[s], b, j, t, T, H, da, da_op);
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// dh_s[r][u] = sum over g of das[r][g] . ws[u][g] for the block's kPR rows
// and kJ units (row stride ``ld``). f32: a warp per unit, lanes split the
// 4H contraction. bf16: mma.sync m16n8k16 tiles (16 rows x 8 units x 16
// of the contraction), warps taking every 8th k-slice, then a sum over the
// 8 warps' partial tiles.
__device__ __forceinline__ void dh_product(const float* das, const float* ws,
                                           int ld, int H4,
                                           float (&dh_s)[kPR][kJ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wrow = ws + warp * ld;  // unit j0 + warp
  float acc[kPR];
#pragma unroll
  for (int q = 0; q < kPR; ++q) acc[q] = 0.0f;
  for (int g = 2 * lane; g < H4; g += 64) {
    const float2 w2 = load2(wrow + g);
#pragma unroll
    for (int q = 0; q < kPR; ++q) {
      const float2 d2 = load2(das + q * ld + g);
      acc[q] = fmaf(d2.x, w2.x, acc[q]);
      acc[q] = fmaf(d2.y, w2.y, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPR; ++q) {
    const float s = warp_sum(acc[q]);
    if (lane == 0) dh_s[q][warp] = s;
  }
}

__device__ __forceinline__ void dh_product(const __nv_bfloat16* das,
                                           const __nv_bfloat16* ws, int ld,
                                           int H4, float (&dh_s)[kPR][kJ]) {
  __shared__ float part[kBThreads / 32][kPR][kJ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  auto ld32 = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = warp * 16; k0 < H4; k0 += kBThreads / 2) {
    const __nv_bfloat16* a = das + g * ld + k0 + 2 * q;  // rows g, g + 8
    const __nv_bfloat16* w = ws + g * ld + k0 + 2 * q;   // unit g
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * ld), ld32(a + 8),
                            ld32(a + 8 * ld + 8)};
    tc::mma_bf16(d, af, ld32(w), ld32(w + 8));
  }
  part[warp][g][2 * q] = d[0];
  part[warp][g][2 * q + 1] = d[1];
  part[warp][g + 8][2 * q] = d[2];
  part[warp][g + 8][2 * q + 1] = d[3];
  __syncthreads();
  if (threadIdx.x < kPR * kJ) {
    const int r = threadIdx.x / kJ, u = threadIdx.x % kJ;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kBThreads / 32; ++w) s += part[w][r][u];
    dh_s[r][u] = s;
  }
}

// The whole backward sweep in one cooperative launch: block (j, r) owns
// hidden units [j*8, j*8+8) of batch rows [r*16, r*16+16) for steps T-1
// down to -1, as bwd_step_kernel does for one step, with a grid barrier
// between steps. Dynamic shared memory (Op): Wh[j*8 : j*8+8, :] (8 x 4H),
// loaded once, and the block's rows of da_{t+1} (16 x 4H), restaged each
// step from ``da_op`` (bf16) or ``da`` (f32) through L2 (__ldcg: other
// blocks wrote them). ``sync`` is a zeroed counter. dc holds dcT on entry
// and dc0 on exit.
template <typename Op>
__global__ void __launch_bounds__(kBThreads)
bwd_sweep_kernel(float* __restrict__ da, Op* __restrict__ da_op,
                 const Op* __restrict__ wh, const float* __restrict__ dhT,
                 const float* __restrict__ dout,
                 const float* __restrict__ dcseq,
                 const float* __restrict__ gates,
                 const float* __restrict__ cseq, const float* __restrict__ c0,
                 float* __restrict__ dc, float* __restrict__ dh0,
                 unsigned* __restrict__ sync, int B, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dh_s[kPR][kJ];
  const int H4 = 4 * H, ld = H4 + kPad;
  Op* ws = reinterpret_cast<Op*>(smem_raw);
  Op* das = ws + kJ * ld;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ, b0 = blockIdx.y * kPR;
  const unsigned blocks = gridDim.x * gridDim.y;
  for (int i = tid; i < kJ * H4; i += kBThreads)
    ws[i / H4 * ld + i % H4] = wh[(size_t)(j0 + i / H4) * H4 + i % H4];

  // the cell thread (r, jj) of the block, if it has a row
  const int r = tid / kJ, jj = tid % kJ, b = b0 + r, j = j0 + jj;
  const bool cell = tid < kPR * kJ && b < B;
  float dcv = cell ? dc[(size_t)b * H + j] : 0.0f;
  const Op* src;
  if constexpr (kIsBf16<Op>) src = da_op;
  else src = da;
  constexpr int kVec = 16 / sizeof(Op);  // Op values per 16-byte copy
  constexpr int kBatch = 32 / sizeof(Op);  // 16-byte L2 reads in flight

  const int n_vec = kPR * H4 / kVec;
  for (int t = T - 1; t >= -1; --t) {
    CellIn in;  // issued first: the loads overlap the staging below
    if (cell && t >= 0)
      in = cell_in(b, j, t, T, H, gates, cseq, c0, dout, dcseq);
    if (t < T - 1) {
      // kBatch independent 16-byte L2 reads in flight per thread
      for (int i0 = tid; i0 < n_vec; i0 += kBThreads * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kBThreads;
          const int rr = i * kVec / H4, col = i * kVec % H4;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (i < n_vec && b0 + rr < B)
            v[u] = __ldcg(reinterpret_cast<const uint4*>(
                src + ((size_t)(b0 + rr) * T + t + 1) * H4 + col));
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kBThreads;
          if (i < n_vec)
            *reinterpret_cast<uint4*>(das + i * kVec / H4 * ld +
                                      i * kVec % H4) = v[u];
        }
      }
      __syncthreads();
      dh_product(das, ws, ld, H4, dh_s);
    } else if (tid < kPR * kJ) {
      dh_s[r][jj] = b < B ? dhT[(size_t)b * H + j] : 0.0f;
    }
    __syncthreads();
    if (t < 0) break;
    if (cell)
      dcv = cell_bwd<Op>(in, dh_s[r][jj], dcv, b, j, t, T, H, da, da_op);
    grid_barrier(sync, blocks * (unsigned)(T - t));
  }
  if (cell) {
    dh0[(size_t)b * H + j] = dh_s[r][jj];
    dc[(size_t)b * H + j] = dcv;
  }
}

// C[M,N] = A.B in f32 on tensor cores: bf16 operands A(m,k) =
// A[m*lda + k] when A_KMAJOR else A[k*lda + m], B(k,n) = B[n*ldb + k] when
// B_KMAJOR else B[k*ldb + n]; C row-major. Ragged M, N and K are masked.
// Dynamic shared memory: tc::kSmemBytes.
template <bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(tc::kThreads)
tc_gemm_kernel(const __nv_bfloat16* __restrict__ A, int64_t lda,
               const __nv_bfloat16* __restrict__ B, int64_t ldb,
               float* __restrict__ C, int M, int N, int K) {
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
        if (row < M && col < N) C[(size_t)row * N + col] = acc.v[mt][nt][i];
      }
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

template <bool A_KMAJOR, bool B_KMAJOR>
cudaError_t tc_gemm(const void* A, int64_t lda, const void* B, int64_t ldb,
                    float* C, int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel<A_KMAJOR, B_KMAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + tc::kBN - 1) / tc::kBN, (M + tc::kBM - 1) / tc::kBM);
  tc_gemm_kernel<A_KMAJOR, B_KMAJOR>
      <<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(
          static_cast<const __nv_bfloat16*>(A), lda,
          static_cast<const __nv_bfloat16*>(B), ldb, C, M, N, K);
  return cudaGetLastError();
}

template <typename Op>
size_t sweep_smem(int H) {
  return sizeof(Op) * (size_t)(kJ + kPR) * (4 * H + kPad);
}

// 1 if every block of bwd_sweep_kernel<Op> at (B, H) can be resident at
// once on the current device (the cooperative launch's condition), else 0;
// a negative cudaError_t on failure.
template <typename Op>
int sweep_fits(int B, int H) {
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = sweep_smem<Op>(H);
  if (smem + sizeof(float) * kPR * kJ > (size_t)optin) return 0;
  err = cudaFuncSetAttribute(bwd_sweep_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bwd_sweep_kernel<Op>, kBThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long blocks = (long long)(H / kJ) * ((B + kPR - 1) / kPR);
  return blocks <= (long long)per_sm * sms ? 1 : 0;
}

template <typename Op>
int backward(const void* x, const void* hprev, const void* c0,
             const void* cseq, const void* gates, const void* wx,
             const void* wh, const void* dout, const void* dcseq,
             const void* dhT, void* da, void* da_op, void* dc, void* sync,
             void* dx, void* dwx, void* dwh, void* db, void* dh0, int B,
             int T, int In, int H, int persistent, cudaStream_t stream) {
  const int M = B * T, H4 = 4 * H;
  float* dap = static_cast<float*>(da);
  Op* daop = static_cast<Op*>(da_op);
  const Op* whp = static_cast<const Op*>(wh);
  const float* dhTp = static_cast<const float*>(dhT);
  const float* doutp = static_cast<const float*>(dout);
  const float* dcseqp = static_cast<const float*>(dcseq);
  const float* gatesp = static_cast<const float*>(gates);
  const float* cseqp = static_cast<const float*>(cseq);
  const float* c0p = static_cast<const float*>(c0);
  float* dcp = static_cast<float*>(dc);
  float* dh0p = static_cast<float*>(dh0);
  cudaError_t err;
  if (persistent) {
    unsigned* syncp = static_cast<unsigned*>(sync);
    const size_t smem = sweep_smem<Op>(H);
    err = cudaFuncSetAttribute(bwd_sweep_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaMemsetAsync(syncp, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&dap,    &daop,  &whp, &dhTp,  &doutp, &dcseqp,
                    &gatesp, &cseqp, &c0p, &dcp,   &dh0p,  &syncp,
                    &B,      &T,     &H};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bwd_sweep_kernel<Op>),
        dim3(H / kJ, (B + kPR - 1) / kPR), dim3(kBThreads), args, smem,
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const size_t smem = sizeof(float) * (size_t)kBB * H4;
    err = cudaFuncSetAttribute(bwd_step_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(H / kJ, (B + kBB - 1) / kBB);
    for (int t = T - 1; t >= -1; --t) {
      bwd_step_kernel<Op><<<grid, kBThreads, smem, stream>>>(
          dap, daop, whp, dhTp, doutp, dcseqp, gatesp, cseqp, c0p, dcp, dh0p,
          B, T, H, t);
      if (t == T - 1) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  if constexpr (kIsBf16<Op>) {
    // tensor cores on the bf16 copy of DA
    // dx = DA . Wx^T: (M, 4H) x (4H, In), Wx (In, 4H) is K-major
    err = tc_gemm<true, true>(daop, H4, wx, H4, static_cast<float*>(dx), M,
                              In, H4, stream);
    // dWx = X^T . DA: (In, M) x (M, 4H), X (M, In) is M-major
    if (err == cudaSuccess)
      err = tc_gemm<false, false>(x, In, daop, H4, static_cast<float*>(dwx),
                                  In, H4, M, stream);
    // dWh = H_prev^T . DA: (H, M) x (M, 4H)
    if (err == cudaSuccess)
      err = tc_gemm<false, false>(hprev, H, daop, H4,
                                  static_cast<float*>(dwh), H, H4, M, stream);
  } else {
    err = gemm<float, Op, Op>(dap, H4, 1, wx, 1, H4, nullptr,
                              static_cast<float*>(dx), M, In, H4, stream);
    if (err == cudaSuccess)
      err = gemm<Op, float, Op>(x, 1, In, dap, H4, 1, nullptr,
                                static_cast<float*>(dwx), In, H4, M, stream);
    if (err == cudaSuccess)
      err = gemm<Op, float, Op>(hprev, 1, H, dap, H4, 1, nullptr,
                                static_cast<float*>(dwh), H, H4, M, stream);
  }
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

// 1 when the backward's persistent sweep can run at (B, H) in the compute
// type on the current device (every block resident at once), 0 when the
// per-step route must; a negative cudaError_t on failure.
extern "C" int mmqg_lstm_train_bwd_persistent(int B, int H, int bf16) {
  if (B < 1 || H < 8 || H % 8) return 0;
  return bf16 ? mmqg::sweep_fits<__nv_bfloat16>(B, H)
              : mmqg::sweep_fits<float>(B, H);
}

// Backward. x, wx, wh as in the forward (compute type); hprev (B,T,H) is
// h_{t-1} per row (h0 at t = 0) in the compute type; c0, cseq, gates from
// the forward; the cotangents dout, dcseq (B,T,H), dhT (B,H) f32. Scratch:
// da (B,T,4H) f32; da_op (B,T,4H) bf16 when ``bf16`` (unused in f32); sync,
// one unsigned int. dc (B,H) f32 holds dcT on entry and dc0 on exit. Writes
// dx (B,T,In), dwx (In,4H), dwh (H,4H), db (4H), dh0 (B,H), all f32.
// ``persistent`` picks the one-launch sweep (when
// mmqg_lstm_train_bwd_persistent said 1) over T + 1 step launches.
extern "C" int mmqg_lstm_train_bwd(
    const void* x, const void* hprev, const void* c0, const void* cseq,
    const void* gates, const void* wx, const void* wh, const void* dout,
    const void* dcseq, const void* dhT, void* da, void* da_op, void* dc,
    void* sync, void* dx, void* dwx, void* dwh, void* db, void* dh0, int B,
    int T, int In, int H, int bf16, int persistent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::backward<__nv_bfloat16>(
        x, hprev, c0, cseq, gates, wx, wh, dout, dcseq, dhT, da, da_op, dc,
        sync, dx, dwx, dwh, db, dh0, B, T, In, H, persistent, s);
  return mmqg::backward<float>(x, hprev, c0, cseq, gates, wx, wh, dout, dcseq,
                               dhT, da, da_op, dc, sync, dx, dwx, dwh, db,
                               dh0, B, T, In, H, persistent, s);
}
