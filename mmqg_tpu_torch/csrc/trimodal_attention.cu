// One decode step of tri-modal location attention.
//
// Replaces: mmqg_tpu/ops/attention_pallas.py::trimodal_attention_pallas (its
// ``_kernel``). For query q = [word_emb; h_top] (B, Dq):
//   scores = q.[W_text | W_video | W_audio] + b          (B, Lt + 2La)
//   alpha_m = softmax over the first len_m positions of segment m (f32;
//             masked positions get -1e30 and weight 0)
//   ctx_m  = sum_l alpha_m[l] * mem_m[l, :]              (f32)
// Returns the three contexts and the attention maps (B, Lt + 2La) laid out
// [text | video | audio]. Rounding follows the Pallas kernel: q, W and the
// memories are operands in the compute type T; alpha stays f32 inside the
// context sum (attention_pallas.py:59-61). The XLA reference casts alpha to
// bf16 there (attention.py:90-95); in f32 the two agree.
//
// What bounds it on the H100: bytes, in principle. At B=32 one step reads the
// memories (32 x 283 x 512 text + 32 x 101 x 640 av, 13.4 MB in bf16) and W
// (812 x 485, 0.8 MB) once at about 2 flops per byte: 4 us at 3.35 TB/s.
// This simple version is latency bound instead: 85 us at B=32 bf16 on an
// NVIDIA H100 80GB HBM3 at 700 W (96 blocks; each text block walks 283
// positions serially in its context loop). The TPU kernel padded L to lane
// multiples (384/128/128); here the true lengths are masked in the kernel
// and nothing is padded.
//
// Design: one block per (batch row, modality). The block keeps q and its
// segment's scores in shared memory. Scores: one warp per position, lanes
// stride over Dq on the pre-transposed weight (Lt + 2La, Dq), so each warp
// reads one contiguous row. Softmax: block reductions in f32. Context:
// threads stride over the hidden dimension, so each position's memory row is
// read coalesced; positions past the length have weight 0 and are skipped.
#include "common.cuh"

namespace mmqg {
namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // finite -inf stand-in, as the JAX ops

template <typename T>
__global__ void __launch_bounds__(kThreads)
trimodal_attention_kernel(const T* __restrict__ q,        // (B, Dq)
                          const T* __restrict__ w_t,      // (Lt+2La, Dq)
                          const float* __restrict__ bias, // (Lt+2La,)
                          const T* __restrict__ enc_text,  // (B, Lt, Ht)
                          const T* __restrict__ enc_video, // (B, La, Hv)
                          const T* __restrict__ enc_audio, // (B, La, Ha)
                          const int* __restrict__ text_len,
                          const int* __restrict__ video_len,
                          const int* __restrict__ audio_len,
                          float* __restrict__ ctx_t,   // (B, Ht)
                          float* __restrict__ ctx_a,   // (B, Ha)
                          float* __restrict__ ctx_v,   // (B, Hv)
                          float* __restrict__ maps,    // (B, Lt+2La)
                          int Dq, int Lt, int La, int Ht, int Hv, int Ha) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x, m = blockIdx.y;
  const int Lsum = Lt + 2 * La;
  int L, off, Hm, len;
  const T* mem;
  float* ctx;
  if (m == 0) {
    L = Lt; off = 0; Hm = Ht; len = text_len[b];
    mem = enc_text + (size_t)b * Lt * Ht; ctx = ctx_t + (size_t)b * Ht;
  } else if (m == 1) {
    L = La; off = Lt; Hm = Hv; len = video_len[b];
    mem = enc_video + (size_t)b * La * Hv; ctx = ctx_v + (size_t)b * Hv;
  } else {
    L = La; off = Lt + La; Hm = Ha; len = audio_len[b];
    mem = enc_audio + (size_t)b * La * Ha; ctx = ctx_a + (size_t)b * Ha;
  }
  float* qs = smem;          // Dq
  float* alpha = smem + Dq;  // L
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;

  for (int i = tid; i < Dq; i += kThreads) qs[i] = to_f32(q[(size_t)b * Dq + i]);
  __syncthreads();

  for (int l = warp; l < L; l += nwarps) {
    const T* wr = w_t + (size_t)(off + l) * Dq;
    float s = 0.0f;
    for (int d = lane; d < Dq; d += 32) s = fmaf(qs[d], to_f32(wr[d]), s);
    s = warp_sum(s);
    if (lane == 0) alpha[l] = l < len ? s + bias[off + l] : kNegInf;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int l = tid; l < L; l += kThreads) mx = fmaxf(mx, alpha[l]);
  mx = block_max(mx, red);
  float sum = 0.0f;
  for (int l = tid; l < L; l += kThreads) {
    const float e = l < len ? expf(alpha[l] - mx) : 0.0f;
    alpha[l] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its barriers also publish alpha[]
  for (int l = tid; l < L; l += kThreads) {
    const float a = alpha[l] / sum;
    alpha[l] = a;
    maps[(size_t)b * Lsum + off + l] = a;
  }
  __syncthreads();

  const int n = len < L ? len : L;
  for (int h = tid; h < Hm; h += kThreads) {
    float acc = 0.0f;
    for (int l = 0; l < n; ++l)
      acc = fmaf(alpha[l], to_f32(mem[(size_t)l * Hm + h]), acc);
    ctx[h] = acc;
  }
}

template <typename T>
int run(const void* q, const void* w_t, const void* bias, const void* et,
        const void* ev, const void* ea, const void* tl, const void* vl,
        const void* al, void* ctx_t, void* ctx_a, void* ctx_v, void* maps,
        int B, int Dq, int Lt, int La, int Ht, int Hv, int Ha,
        cudaStream_t stream) {
  const int Lmax = Lt > La ? Lt : La;
  const size_t smem = sizeof(float) * (size_t)(Dq + Lmax);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trimodal_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trimodal_attention_kernel<T><<<dim3(B, 3), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(w_t),
      static_cast<const float*>(bias), static_cast<const T*>(et),
      static_cast<const T*>(ev), static_cast<const T*>(ea),
      static_cast<const int*>(tl), static_cast<const int*>(vl),
      static_cast<const int*>(al), static_cast<float*>(ctx_t),
      static_cast<float*>(ctx_a), static_cast<float*>(ctx_v),
      static_cast<float*>(maps), Dq, Lt, La, Ht, Hv, Ha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg

// q (B,Dq), w_t (Lt+2La,Dq) and the memories in the compute type (bf16 when
// ``bf16`` is set, else f32); bias (Lt+2La) f32; lengths (B) int32 each.
// Outputs f32: ctx_t (B,Ht), ctx_a (B,Ha), ctx_v (B,Hv), maps (B,Lt+2La).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mmqg_trimodal_attention(
    const void* q, const void* w_t, const void* bias, const void* enc_text,
    const void* enc_video, const void* enc_audio, const void* text_len,
    const void* video_len, const void* audio_len, void* ctx_t, void* ctx_a,
    void* ctx_v, void* maps, int B, int Dq, int Lt, int La, int Ht, int Hv,
    int Ha, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::run<__nv_bfloat16>(q, w_t, bias, enc_text, enc_video,
                                    enc_audio, text_len, video_len, audio_len,
                                    ctx_t, ctx_a, ctx_v, maps, B, Dq, Lt, La,
                                    Ht, Hv, Ha, s);
  return mmqg::run<float>(q, w_t, bias, enc_text, enc_video, enc_audio,
                          text_len, video_len, audio_len, ctx_t, ctx_a, ctx_v,
                          maps, B, Dq, Lt, La, Ht, Hv, Ha, s);
}
