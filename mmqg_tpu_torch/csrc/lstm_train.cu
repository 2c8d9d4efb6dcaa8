// K4: a trainable LSTM layer -- the forward emitting the BPTT residuals,
// and the reverse-time backward with its weight-gradient products.
//
// Replaces: mmqg_tpu/ops/lstm_train_pallas.py::lstm_layer_train -- its
// ``_fwd_kernel`` (launched by ``_forward``, :147) and ``_bwd_kernel``
// (launched by ``_bwd_rule``, :209). Semantics are ``layers.lstm_scan`` for
// one layer: no mask, no latch; gate order i, f, g, o. Rounding follows the
// Pallas kernel: every product takes its operands (x, h, da, Wx, Wh) rounded
// to the compute type Op (bf16 or f32) and sums in f32; gates, state and
// gradients stay f32. The TPU kernels kept Wx, Wh and the weight-gradient
// sums in VMEM over a sequential grid.
//
// Layouts (row r = b*T + t throughout): x (B,T,In) Op; out/cseq (B,T,H) f32;
// gates (B,T,4H) f32 post-activation; da (B,T,4H) f32.
//
// What bounds it on the H100: the two recurrences. Forward step t needs all
// of h_{t-1} and backward step t needs all of da_{t+1}, so each direction is
// a chain of T dependent (B,H)x(H,4H) products -- 67 MFLOP each at B=32,
// H=512, far too little to fill 132 SMs: a step costs its latency (a grid
// barrier, an L2 read of the operand every block needs), not its FLOPs.
// Everything without a recurrence leaves the time loop:
//  1. The forward: the shared LSTM forward of lstm.cuh (the same kernel as
//     K1's, emitting h, c and the post-activation gates): x.Wx + b on tensor
//     cores in bf16, written into ``gates`` and overwritten in place by the
//     post-activation gates (each cell thread reads exactly the four
//     pre-activations it overwrites), then one persistent cooperative sweep
//     for all T steps (row chunks, one launch each, for a batch larger than
//     one grid of resident blocks).
//  2. The backward sweep, one persistent cooperative launch
//     (bwd_sweep_kernel): block (j, r) owns hidden units [j*8, j*8+8) of 16
//     batch rows for all T + 1 steps, keeps Wh[j*8 : j*8+8, :] in shared
//     memory throughout and the carried dc in registers. Step t stages the
//     block's rows of da_{t+1} (rounded to Op) from L2, forms dh_t = da_{t+1}
//     . Wh^T for its 8 units (bf16: mma.sync, mma_rows16; f32: a warp per
//     unit, lanes split the 4H contraction), runs the elementwise cell
//     backward, writes da_t (f32, and in bf16 its rounded copy da_op) and
//     meets the other blocks at grid_barrier. At B=32, H=512 that is 64 x 2
//     = 128 blocks with 96 KB (bf16) or 192 KB (f32) of shared memory each,
//     one per SM. Shapes whose blocks cannot all be resident (e.g. H=2048)
//     keep the per-step route, bwd_step_kernel, T + 1 launches of the same
//     step; the wrapper picks the route by shape before launching
//     (mmqg_lstm_train_bwd_persistent).
//  3. The products over all B*T rows at once: dx = DA.Wx^T, dWx = X^T.DA and
//     dWh = H_prev^T.DA (11-19 GFLOP each at the text encoder's shapes; the
//     Pallas kernel summed dWx/dWh step by step in VMEM, one GEMM over T is
//     the same sum). bf16: tc_gemm_kernel (mma.sync tiles fed by a 4-stage
//     cp.async ring, X and H_prev read M-major through ldmatrix.trans) on
//     da_op, the bf16 values a SIMT GEMM would round da to, so only the
//     summation order differs. f32: gemm_kernel, a tiled SIMT GEMM with
//     strides (transposes need no copy).
//  4. colsum_kernel: db = the column sums of DA (f32, deterministic).
// The sequences are laid out (B, T, ...) rather than the Pallas kernel's
// (T, B, ...): the public outputs are (B, T, H), so nothing is transposed.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, B=32 bf16, one 283-step
// text layer (chip_smoke.py): the forward 1.29-1.31 ms by the sweep, 7.11-
// 7.20 ms by the per-step route (the first design), cuDNN's LSTM forward
// 5.6-9.7 ms in the same calls; the backward 2.12-2.14 ms (6-7 us a step:
// the grid barrier, 1.34 us alone, and the 64 KB L2 read of da_{t+1} per
// block), cuDNN's 8.0-11.5 ms.
#include "lstm.cuh"

namespace mmqg {
namespace {

constexpr int kBB = 8;   // batch rows per per-step backward block
constexpr int kStepG = 4096;  // per-step backward: da columns staged a pass
constexpr int kPad = 8;  // sweep: row padding (16 bytes in bf16), so the
                         // mma fragment loads hit 32 different banks

// What the forward emits: the h and c sequences, the post-activation gates
// (over x.Wx + b in ``gates``, the forward's xproj) and the final state.
struct TrainOut {
  float* out;    // (B, T, H)
  float* cseq;   // (B, T, H)
  float* gates;  // (B, T, 4H)
  float* hT;     // (B, H)
  float* cT;     // (B, H)
  __device__ void operator()(int b, int j, int t, int T, int H,
                             const float (&a)[4], float h, float c) const {
    const size_t row = (size_t)b * T + t;
    float* g = gates + row * 4 * H + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k * H] = a[k];
    out[row * H + j] = h;
    cseq[row * H + j] = c;
    if (t == T - 1) {
      hT[(size_t)b * H + j] = h;
      cT[(size_t)b * H + j] = c;
    }
  }
};

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
// rows of the block, kBB x min(4H, kStepG) f32, staged a column slice at a
// time so that any H fits; each lane's sum runs over its columns in order
// whatever the slices (kStepG is a multiple of 32).
inline size_t bwd_step_smem(int H) {
  return sizeof(float) * (size_t)kBB * (4 * H < kStepG ? 4 * H : kStepG);
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
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
  const int H4 = 4 * H, GS = min(H4, kStepG);

  if (t < T - 1) {
    const Op* wrow = wh + (size_t)(j0 + warp) * H4;  // Wh[j, :], one warp
    float acc[kBB];
#pragma unroll
    for (int r = 0; r < kBB; ++r) acc[r] = 0.0f;
    for (int g0 = 0; g0 < H4; g0 += GS) {
      const int gc = min(GS, H4 - g0);
      for (int i = tid; i < kBB * gc; i += kThreads) {
        const int r = i / gc, g = i % gc, b = b0 + r;
        das[r * GS + g] =
            b < B ? round_to<Op>(da[((size_t)b * T + t + 1) * H4 + g0 + g])
                  : 0.0f;
      }
      __syncthreads();
      for (int g = lane; g < gc; g += 32) {
        const float w = to_f32(wrow[g0 + g]);
#pragma unroll
        for (int r = 0; r < kBB; ++r)
          acc[r] = fmaf(das[r * GS + g], w, acc[r]);
      }
      __syncthreads();  // the next slice overwrites das
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// dh_s[r][u] = sum over g of das[r][g] . ws[u][g] for the block's kRows rows
// and kJ units (row stride ``ld``). f32: a warp per unit, lanes split the
// 4H contraction. bf16: mma_rows16 (warps taking every 8th k-slice), then a
// sum over the 8 warps' partial tiles.
__device__ __forceinline__ void dh_product(const float* das, const float* ws,
                                           int ld, int H4,
                                           float (&dh_s)[kRows][kJ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wrow = ws + warp * ld;  // unit j0 + warp
  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.0f;
  for (int g = 2 * lane; g < H4; g += 64) {
    const float2 w2 = load2(wrow + g);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float2 d2 = load2(das + q * ld + g);
      acc[q] = fmaf(d2.x, w2.x, acc[q]);
      acc[q] = fmaf(d2.y, w2.y, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float s = warp_sum(acc[q]);
    if (lane == 0) dh_s[q][warp] = s;
  }
}

__device__ __forceinline__ void dh_product(const __nv_bfloat16* das,
                                           const __nv_bfloat16* ws, int ld,
                                           int H4, float (&dh_s)[kRows][kJ]) {
  __shared__ __align__(16) float part[kWarps][kRows][kJ];
  mma_rows16<1>(das, ws, ld, H4, &part[0][0][0], kJ);
  __syncthreads();
  if (threadIdx.x < kRows * kJ) {
    const int r = threadIdx.x / kJ, u = threadIdx.x % kJ;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][r][u];
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
__global__ void __launch_bounds__(kThreads)
bwd_sweep_kernel(float* __restrict__ da, Op* __restrict__ da_op,
                 const Op* __restrict__ wh, const float* __restrict__ dhT,
                 const float* __restrict__ dout,
                 const float* __restrict__ dcseq,
                 const float* __restrict__ gates,
                 const float* __restrict__ cseq, const float* __restrict__ c0,
                 float* __restrict__ dc, float* __restrict__ dh0,
                 unsigned* __restrict__ sync, int B, int T, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dh_s[kRows][kJ];
  const int H4 = 4 * H, ld = H4 + kPad;
  Op* ws = reinterpret_cast<Op*>(smem_raw);
  Op* das = ws + kJ * ld;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kJ, b0 = blockIdx.y * kRows;
  const unsigned blocks = gridDim.x * gridDim.y;
  for (int i = tid; i < kJ * H4; i += kThreads)
    ws[i / H4 * ld + i % H4] = wh[(size_t)(j0 + i / H4) * H4 + i % H4];

  // the cell thread (r, jj) of the block, if it has a row
  const int r = tid / kJ, jj = tid % kJ, b = b0 + r, j = j0 + jj;
  const bool cell = tid < kRows * kJ && b < B;
  float dcv = cell ? dc[(size_t)b * H + j] : 0.0f;
  const Op* src;
  if constexpr (kIsBf16<Op>) src = da_op;
  else src = da;
  constexpr int kVec = 16 / sizeof(Op);  // Op values per 16-byte copy
  constexpr int kBatch = 32 / sizeof(Op);  // 16-byte L2 reads in flight

  const int n_vec = kRows * H4 / kVec;
  for (int t = T - 1; t >= -1; --t) {
    CellIn in;  // issued first: the loads overlap the staging below
    if (cell && t >= 0)
      in = cell_in(b, j, t, T, H, gates, cseq, c0, dout, dcseq);
    if (t < T - 1) {
      // kBatch independent 16-byte L2 reads in flight per thread
      for (int i0 = tid; i0 < n_vec; i0 += kThreads * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          const int rr = i * kVec / H4, col = i * kVec % H4;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (i < n_vec && b0 + rr < B)
            v[u] = __ldcg(reinterpret_cast<const uint4*>(
                src + ((size_t)(b0 + rr) * T + t + 1) * H4 + col));
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n_vec)
            *reinterpret_cast<uint4*>(das + i * kVec / H4 * ld +
                                      i * kVec % H4) = v[u];
        }
      }
      __syncthreads();
      dh_product(das, ws, ld, H4, dh_s);
    } else if (tid < kRows * kJ) {
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

template <typename Op>
int forward(const void* x, const void* wx, const void* wh, const void* bias,
            void* hbuf, void* out, void* cseq, void* gates, void* sync,
            void* hT, void* cT, int B, int T, int In, int H, int rows,
            cudaStream_t stream) {
  float* g = static_cast<float*>(gates);
  const Fwd<Op, TrainOut> p{
      g, static_cast<const Op*>(wh), static_cast<Op*>(hbuf),
      static_cast<float*>(cT), static_cast<unsigned*>(sync),
      {static_cast<float*>(out), static_cast<float*>(cseq), g,
       static_cast<float*>(hT), static_cast<float*>(cT)},
      B, T, H, 0};
  return lstm_forward(x, wx, bias, p, In, rows, stream);
}

template <typename Op>
size_t sweep_smem(int H) {
  return sizeof(Op) * (size_t)(kJ + kRows) * (4 * H + kPad);
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
        dim3(H / kJ, (B + kRows - 1) / kRows), dim3(kThreads), args, smem,
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const size_t smem = bwd_step_smem(H);
    err = cudaFuncSetAttribute(bwd_step_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(H / kJ, (B + kBB - 1) / kBB);
    for (int t = T - 1; t >= -1; --t) {
      bwd_step_kernel<Op><<<grid, kThreads, smem, stream>>>(
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
    err = tc_gemm<true, true>(daop, H4, wx, H4, nullptr,
                              static_cast<float*>(dx), M, In, H4, stream);
    // dWx = X^T . DA: (In, M) x (M, 4H), X (M, In) is M-major
    if (err == cudaSuccess)
      err = tc_gemm<false, false>(x, In, daop, H4, nullptr,
                                  static_cast<float*>(dwx), In, H4, M,
                                  stream);
    // dWh = H_prev^T . DA: (H, M) x (M, 4H)
    if (err == cudaSuccess)
      err = tc_gemm<false, false>(hprev, H, daop, H4, nullptr,
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
// ``bf16`` is set, else f32); bias (4H) f32. Scratch: hbuf (2,B,H) in the
// compute type with hbuf[0] = h0; sync, one unsigned int. cT (B,H) f32
// holds c0 on entry. Writes out and cseq (B,T,H), gates (B,T,4H)
// post-activation, hT/cT (B,H), all f32. ``rows`` > 0 runs the sweep, one
// cooperative launch for each ``rows`` 16-row blocks of the batch
// (mmqg_lstm_train_fwd_rows says how many fit); 0 runs T step launches.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mmqg_lstm_train_fwd(const void* x, const void* wx,
                                   const void* wh, const void* bias,
                                   void* hbuf, void* out, void* cseq,
                                   void* gates, void* sync, void* hT,
                                   void* cT, int B, int T, int In, int H,
                                   int bf16, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::forward<__nv_bfloat16>(x, wx, wh, bias, hbuf, out, cseq,
                                        gates, sync, hT, cT, B, T, In, H,
                                        rows, s);
  return mmqg::forward<float>(x, wx, wh, bias, hbuf, out, cseq, gates, sync,
                              hT, cT, B, T, In, H, rows, s);
}

// How many 16-row blocks of the batch one cooperative launch of the
// forward's sweep holds at (B, H) in the compute type on the current device
// (at most all of them); 0 when the per-step route must run; a negative
// cudaError_t on failure.
extern "C" int mmqg_lstm_train_fwd_rows(int B, int H, int bf16) {
  return bf16 ? mmqg::fwd_sweep_rows<__nv_bfloat16, mmqg::TrainOut>(B, H)
              : mmqg::fwd_sweep_rows<float, mmqg::TrainOut>(B, H);
}

// 1 when the backward's persistent sweep can run at (B, H) in the compute
// type on the current device (every block resident at once), 0 when the
// per-step route must; a negative cudaError_t on failure.
extern "C" int mmqg_lstm_train_bwd_persistent(int B, int H, int bf16) {
  if (B < 1 || H < 8 || H % 8) return 0;
  const int n = bf16 ? mmqg::resident_blocks(
                           mmqg::bwd_sweep_kernel<__nv_bfloat16>,
                           mmqg::sweep_smem<__nv_bfloat16>(H))
                     : mmqg::resident_blocks(mmqg::bwd_sweep_kernel<float>,
                                             mmqg::sweep_smem<float>(H));
  const long long blocks = (long long)(H / mmqg::kJ) *
                           ((B + mmqg::kRows - 1) / mmqg::kRows);
  return n < 0 ? n : blocks <= n ? 1 : 0;
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
