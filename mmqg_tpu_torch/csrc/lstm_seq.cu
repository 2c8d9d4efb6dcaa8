// K1: an LSTM layer over a whole sequence, forward only (the serving
// encoders).
//
// Replaces: mmqg_tpu/ops/lstm_pallas.py::lstm_layer_pallas (its ``_kernel``,
// with mask_output=True). Per step: gates = x_t.Wx + h.Wh + b; i, f, o =
// sigmoid, g = tanh; c = f*c + i*g; h = o*tanh(c). Output h_t is zeroed for
// t >= length and (h, c) at length-1 is latched into separate outputs.
// Operands are in the compute type Op (bf16 or f32); products, sums, gates
// and state are f32. The TPU kernel kept Wx and Wh in VMEM over a
// sequential time grid.
//
// What bounds it on the H100: the recurrence. Step t needs all of h_{t-1},
// so the T steps are a chain of dependent (B,H)x(H,4H) products: at B=32,
// H=512 each is 67 MFLOP, far too little to fill 132 SMs, so a step costs
// its latency -- a grid-wide wait, an L2 read of h, the cell -- and not its
// arithmetic (the bound, 0.03 ms a text layer, is the input projection's and
// the recurrence's FLOPs at the tensor-core peak).
//
// Design: the LSTM forward of lstm.cuh, the same kernel as K4's forward,
// emitting the masked outputs and the latched state: the input projection
// on tensor cores in bf16, then one persistent cooperative sweep for all T
// steps with the block's columns of Wh held in shared memory and a grid
// barrier a step (a batch larger than one grid of resident blocks runs in
// row chunks, one cooperative launch each).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, text layer 0,
// B=32, T=283, In=300, H=512, bf16): the sweep 1.29-1.30 ms, 4.0 us a step
// after the 0.148 ms input GEMM, of which 1.34 us is the grid barrier alone;
// the per-step route (the first design: a launch, a 64 KB reload of Wh and
// a 512-long SIMT FMA chain a step) 7.05-7.16 ms; cuDNN's packed LSTM
// forward 5.6-8.4 ms in the same calls. At B=128, two cooperative launches
// (96 + 32 rows) take 3.27 ms, the per-step route 17.3 ms. f32: 2.53-2.58
// ms (cuDNN 4.7-5.9 ms).
#include "lstm.cuh"

namespace mmqg {
namespace {

// What K1 emits: h_t zeroed from each row's length on, (h, c) latched at
// length - 1.
struct MaskedOut {
  float* out;          // (B, T, H)
  float* h_last;       // (B, H), h0 on entry
  float* c_last;       // (B, H), c0 on entry
  const int* lengths;  // (B,)
  __device__ void operator()(int b, int j, int t, int T, int H,
                             const float (&)[4], float h, float c) const {
    const int len = lengths[b];
    out[((size_t)b * T + t) * H + j] = t < len ? h : 0.0f;
    if (t == len - 1) {
      h_last[(size_t)b * H + j] = h;
      c_last[(size_t)b * H + j] = c;
    }
  }
};

template <typename Op>
int run(const void* x, const void* wx, const void* wh, const void* bias,
        const void* lengths, void* xproj, void* hbuf, void* c, void* sync,
        void* out, void* h_last, void* c_last, int B, int T, int In, int H,
        int rows, cudaStream_t stream) {
  const Fwd<Op, MaskedOut> p{
      static_cast<const float*>(xproj), static_cast<const Op*>(wh),
      static_cast<Op*>(hbuf), static_cast<float*>(c),
      static_cast<unsigned*>(sync),
      {static_cast<float*>(out), static_cast<float*>(h_last),
       static_cast<float*>(c_last), static_cast<const int*>(lengths)},
      B, T, H, 0};
  return lstm_forward(x, wx, bias, p, In, rows, stream);
}

}  // namespace
}  // namespace mmqg

// x (B,T,In) and wx (In,4H), wh (H,4H) in the compute type (bf16 when
// ``bf16`` is set, else f32); bias (4H) f32; lengths (B) int32. Scratch:
// xproj (B,T,4H) f32; hbuf (2,B,H) in the compute type with hbuf[0] = h0;
// sync, one unsigned int. c (B,H) f32 holds c0 on entry. h_last/c_last (B,H)
// hold h0/c0 on entry. ``rows`` > 0 runs the sweep, one cooperative launch
// for each ``rows`` 16-row blocks of the batch (mmqg_lstm_seq_rows says
// how many fit); 0 runs T step launches. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int mmqg_lstm_seq(const void* x, const void* wx, const void* wh,
                             const void* bias, const void* lengths,
                             void* xproj, void* hbuf, void* c, void* sync,
                             void* out, void* h_last, void* c_last, int B,
                             int T, int In, int H, int bf16, int rows,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::run<__nv_bfloat16>(x, wx, wh, bias, lengths, xproj, hbuf, c,
                                    sync, out, h_last, c_last, B, T, In, H,
                                    rows, s);
  return mmqg::run<float>(x, wx, wh, bias, lengths, xproj, hbuf, c, sync, out,
                          h_last, c_last, B, T, In, H, rows, s);
}

// How many 16-row blocks of the batch one cooperative launch of the sweep
// holds at (B, H) in the compute type on the current device (at most all
// of them); 0 when the per-step route must run; a negative cudaError_t on
// failure.
extern "C" int mmqg_lstm_seq_rows(int B, int H, int bf16) {
  return bf16 ? mmqg::fwd_sweep_rows<__nv_bfloat16, mmqg::MaskedOut>(B, H)
              : mmqg::fwd_sweep_rows<float, mmqg::MaskedOut>(B, H);
}
