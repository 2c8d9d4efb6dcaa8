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
// What bounds it on the H100: bytes. At B=32 one step reads W (812 x 485,
// 0.8 MB in bf16) once and each memory row below its length once (up to
// 13.4 MB in bf16 at full lengths) at about 2 flops a byte: 2-4 us at 3.35
// TB/s. The kernel masks the true lengths and pads nothing (the TPU kernel
// padded L to lane multiples, 384/128/128).
//
// attn_tile_kernel. A block owns a tile of 16 batch rows x a chunk of 16
// positions of one segment x a slice of 128 memory columns, so at B=32 the
// flagship's shapes give 2 x 107 = 214 blocks (text 18 chunks x 4 slices,
// video 7 x 4, audio 7 x 1). It stages the tile's q and the chunk's 16 rows
// of W in shared memory with cp.async (W is read once a batch tile, not once
// a row), forms the 16 x 16 x Dq score product (bf16: mma.sync m16n8k16
// through lstm.cuh's mma_rows16, the warps splitting Dq; f32: SIMT, 32
// interleaved sums and a tree, since TF32 is outside the f32 tolerance), and
// keeps a flash-decoding partial per row: the chunk's max m, sum s of
// exp(score - m) and context sum_l exp(score_l - m) mem[l, :] over its
// columns, from 16-byte reads of the memory rows, all of a thread's issued
// before its sums. Chunks wholly past a row's length are not read; a chunk
// past every row's length does nothing but arrive. The last block to arrive
// for its (tile, segment, slice) -- a __threadfence and an atomic counter,
// which it resets for the next call -- merges, with 8 chunks' partials in
// flight a thread: M = max m_c, S = sum s_c exp(m_c - M), ctx = sum_c exp(m_c
// - M) ctx_c / S. Block (chunk c, slice c % nsl) writes chunk c's raw scores,
// and the merger of that slice turns them into the normalised maps, exp(score
// - M) / S below the length and 0 past it, so the slices' mergers share the
// maps. Device time at B=32 on an NVIDIA H100 80GB HBM3 at 700 W: 0.019 ms in
// bf16, 0.036 ms in f32 (torch.profiler; PERF.md has the rest).
//
// The first design, one SIMT block per (batch row, segment) walking the
// row's positions serially, was latency-bound at 0.079 ms of device time
// at B=32 bf16 on the same card; this tiling replaced it.
#include "lstm.cuh"

namespace mmqg {
namespace {

constexpr int kAC = 16;       // positions a chunk
constexpr int kASlice = 128;  // memory columns a block
constexpr int kAPld = 24;     // row stride of the warps' partial scores
constexpr int kAGroup = 8;    // memory columns a thread: 16 bytes of bf16
constexpr int kAFlight = 8;   // chunks a merging thread reads at once
static_assert(kAC * kAC == kThreads, "a thread per (row, position)");
static_assert(kAC * kAGroup == kASlice, "a thread per (row, 8 columns)");

// A block's chunk of work, fixed for the call. Segments s = 0, 1, 2 are
// text, video, audio; blocks of a tile are laid out segment by segment,
// chunk by chunk, slice by slice.
template <typename T>
struct AttnArgs {
  const T* q;          // (B, Dq)
  const T* w_t;        // (Lsum, Dq)
  const float* bias;   // (Lsum,)
  const T* mem[3];     // (B, L_s, H_s)
  const int* len[3];   // (B,)
  float* ctx[3];       // (B, H_s)
  float* maps;         // (B, Lsum): raw scores, then the normalised maps
  float* part_ms;      // (B, ncs, 2): each (chunk, slice)'s m and s
  float* part_ctx;     // per segment (B, nch_s, H_s) from ctx_off[s]
  unsigned* count;     // (tiles, 3, msl) arrivals, zero between calls
  int B, Dq, Kp, ld, Lsum, ncs, msl;  // Kp: Dq padded (bf16 16, f32 32)
  int L[3], H[3], off[3], nch[3], nsl[3], cs_off[3], blk_off[4];
  long long ctx_off[3];
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// over the 16 lanes of a half warp (one row of the block)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 memory values (16 bytes of bf16, 32 of f32) as uint4 words
template <typename T>
constexpr int kWords = kAGroup * (int)sizeof(T) / 16;

template <typename T>
__device__ __forceinline__ void unpack8(const uint4 (&u)[kWords<T>],
                                        float (&v)[kAGroup]) {
  const T* e = reinterpret_cast<const T*>(u);
#pragma unroll
  for (int i = 0; i < kAGroup; ++i) v[i] = to_f32(e[i]);
}

// Dynamic shared memory: the q tile and the W chunk, 2 x 16 x ld of T, and
// in bf16 the warps' partial scores; the merger reuses it for exp(m_c - M).
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_tile_kernel(AttnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sc[kRows][kAC + 1];  // exp(score - m) of the chunk
  __shared__ int lens[kRows];
  __shared__ int last;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ws = qs + kRows * a.ld;
  float* part = reinterpret_cast<float*>(ws + kRows * a.ld);  // bf16 only
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kRows;
  int s = 0;
  while (s < 2 && (int)blockIdx.x >= a.blk_off[s + 1]) ++s;
  const int i = blockIdx.x - a.blk_off[s];
  const int chunk = i / a.nsl[s], slice = i % a.nsl[s];
  const int L = a.L[s], Hm = a.H[s], off = a.off[s], l0 = chunk * kAC;
  if (tid < kRows) {
    const int n = b0 + tid < a.B ? a.len[s][b0 + tid] : 0;
    lens[tid] = n < 0 ? 0 : (n < L ? n : L);
  }
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) maxlen = max(maxlen, lens[r]);
  // (row, position) of the scores, (row, column group) of the contexts
  const int r = tid / kAC, l = tid % kAC, b = b0 + r;
  const int len = lens[r];
  const int h0 = slice * kASlice + l * kAGroup;
  const size_t ms_at = ((size_t)b * a.ncs + a.cs_off[s] + chunk * a.nsl[s] +
                        slice) * 2;
  float* pctx = a.part_ctx + a.ctx_off[s];

  if (l0 < maxlen) {
    // stage the tile's q rows and the chunk's W rows, zero past B, L and Dq
    constexpr bool kBf16 = kIsBf16<T>;
    constexpr int kE = 4;  // elements a copy: 8 bytes of bf16, 16 of f32
    const int copies = a.Kp / kE;  // a row's copies
    for (int j = tid; j < 2 * kRows * copies; j += kThreads) {
      const int which = j / (kRows * copies), rem = j % (kRows * copies);
      const int rr = rem / copies, k = (rem % copies) * kE;
      const T* src;
      bool ok;
      T* dst;
      if (which == 0) {
        ok = b0 + rr < a.B && k < a.Dq;
        src = a.q + (size_t)(b0 + rr) * a.Dq + k;
        dst = qs + rr * a.ld + k;
      } else {
        ok = l0 + rr < L && k < a.Dq;
        src = a.w_t + (size_t)(off + l0 + rr) * a.Dq + k;
        dst = ws + rr * a.ld + k;
      }
      if (kBf16)
        cp_async8(dst, ok ? src : a.q, ok);
      else
        tc::cp_async16(dst, ok ? src : a.q, ok);
    }
    tc::cp_async_commit();
    const float bias_l = l0 + l < L ? a.bias[off + l0 + l] : 0.0f;
    tc::cp_async_wait<0>();
    __syncthreads();

    float score;
    if constexpr (kBf16) {
      mma_rows16<kAC / 8>(qs, ws, a.ld, a.Kp, part, kAPld);
      __syncthreads();
      score = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) score += part[(w * kRows + r) * kAPld + l];
    } else {
      // a warp's order (lanes over k = j mod 32, then a tree over the
      // lanes) as 32 independent sums in registers
      const float* qr = reinterpret_cast<const float*>(qs) + r * a.ld;
      const float* wr = reinterpret_cast<const float*>(ws) + l * a.ld;
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
      for (int k0 = 0; k0 < a.Kp; k0 += 32) {
#pragma unroll
        for (int j = 0; j < 32; j += 4) {  // 16-byte shared loads
          const float4 x = *reinterpret_cast<const float4*>(qr + k0 + j);
          const float4 w = *reinterpret_cast<const float4*>(wr + k0 + j);
          acc[j] = fmaf(x.x, w.x, acc[j]);
          acc[j + 1] = fmaf(x.y, w.y, acc[j + 1]);
          acc[j + 2] = fmaf(x.z, w.z, acc[j + 2]);
          acc[j + 3] = fmaf(x.w, w.w, acc[j + 3]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < o; ++j) acc[j] += acc[j + o];
      }
      score = acc[0];
    }
    const bool valid = l0 + l < len;
    const float sv = valid ? score + bias_l : -INFINITY;
    // the raw score, for the merger of slice chunk % nsl to normalise
    if (valid && slice == chunk % a.nsl[s])
      a.maps[(size_t)b * a.Lsum + off + l0 + l] = sv;
    const float m = half_max(sv);
    const float p = valid ? expf(sv - m) : 0.0f;
    const float sum = half_sum(p);
    sc[r][l] = p;
    if (l == 0 && l0 < len) {
      a.part_ms[ms_at] = m;
      a.part_ms[ms_at + 1] = sum;
    }
    __syncthreads();

    // the chunk's context over the thread's 8 columns: every 16-byte read
    // of a group issued before its sums
    if (l0 < len && h0 < Hm) {
      const int n = min(kAC, len - l0);
      constexpr int kBatch = kBf16 ? kAC : kAC / 2;  // positions a group
      float acc[kAGroup] = {};
      const T* mp = a.mem[s] + ((size_t)b * L + l0) * Hm + h0;
#pragma unroll
      for (int j0 = 0; j0 < kAC; j0 += kBatch) {
        uint4 u[kBatch][kWords<T>];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
#pragma unroll
          for (int w = 0; w < kWords<T>; ++w)
            u[j][w] = j0 + j < n ? __ldg(reinterpret_cast<const uint4*>(
                                           mp + (size_t)(j0 + j) * Hm) + w)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j0 + j >= n) break;
          float v[kAGroup];
          unpack8<T>(u[j], v);
          const float pj = sc[r][j0 + j];
#pragma unroll
          for (int e = 0; e < kAGroup; ++e) acc[e] = fmaf(pj, v[e], acc[e]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(
          pctx + ((size_t)b * a.nch[s] + chunk) * Hm + h0);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }

  // arrive; the last block of the (tile, segment, slice) merges
  __threadfence();
  __syncthreads();
  unsigned* counter =
      a.count + ((size_t)blockIdx.y * 3 + s) * a.msl + slice;
  if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)(a.nch[s] - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  const int nch = a.nch[s], nc = (len + kAC - 1) / kAC;  // the row's chunks
  float* e = reinterpret_cast<float*>(smem_raw);          // [16][nch]
  const float* ms = a.part_ms + ((size_t)b * a.ncs + a.cs_off[s]) * 2;
  const int st = 2 * a.nsl[s];  // floats from one chunk's m to the next's
  float M = -INFINITY;
  for (int c = l; c < nc; c += kAC)
    M = fmaxf(M, __ldcg(ms + c * st + 2 * slice));
  M = half_max(M);
  float S = 0.0f;
  for (int c = l; c < nc; c += kAC) {
    const float ec = expf(__ldcg(ms + c * st + 2 * slice) - M);
    e[r * nch + c] = ec;
    S += __ldcg(ms + c * st + 2 * slice + 1) * ec;
  }
  S = half_sum(S);
  __syncthreads();  // e[] published
  if (b < a.B && nc > 0) {
    if (h0 < Hm) {  // the context: kAFlight chunks' partials read at once
      float acc[kAGroup] = {};
      const float* src = pctx + (size_t)b * nch * Hm + h0;
      for (int c0 = 0; c0 < nc; c0 += kAFlight) {
        float4 v[kAFlight][2];
#pragma unroll
        for (int j = 0; j < kAFlight; ++j) {
          const float4* p =
              reinterpret_cast<const float4*>(src + (size_t)(c0 + j) * Hm);
          const bool in = c0 + j < nc;
          v[j][0] = in ? __ldcg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
          v[j][1] = in ? __ldcg(p + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kAFlight; ++j) {
          if (c0 + j >= nc) break;
          const float ec = e[r * nch + c0 + j];
          const float x[kAGroup] = {v[j][0].x, v[j][0].y, v[j][0].z,
                                    v[j][0].w, v[j][1].x, v[j][1].y,
                                    v[j][1].z, v[j][1].w};
#pragma unroll
          for (int k = 0; k < kAGroup; ++k) acc[k] = fmaf(ec, x[k], acc[k]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(a.ctx[s] + (size_t)b * Hm + h0);
      dst[0] = make_float4(acc[0] / S, acc[1] / S, acc[2] / S, acc[3] / S);
      dst[1] = make_float4(acc[4] / S, acc[5] / S, acc[6] / S, acc[7] / S);
    }
    // the maps of chunks slice, slice + nsl, ... (their raw scores came
    // from this slice's blocks): exp(score - M) / S below the length, 0 past
    const int nsl = a.nsl[s];
    float* mrow = a.maps + (size_t)b * a.Lsum + off;
    for (int c0 = slice; c0 < nch; c0 += kAFlight * nsl) {
      float v[kAFlight];
#pragma unroll
      for (int j = 0; j < kAFlight; ++j) {
        const int p = (c0 + j * nsl) * kAC + l;
        v[j] = p < len ? __ldcg(mrow + p) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kAFlight; ++j) {
        const int p = (c0 + j * nsl) * kAC + l;
        if (p < L) mrow[p] = p < len ? expf(v[j] - M) / S : 0.0f;
      }
    }
  }
  if (tid == 0) *counter = 0;  // every block of it has arrived
}

// The kernel's geometry for the call, from the shapes: fills ``a``'s
// ints and returns the floats of part_ms and part_ctx and the counters
// (tiles x 3 x msl) it needs.
template <typename T>
void attn_geometry(AttnArgs<T>& a, int B, int Dq, int Lt, int La, int Ht,
                   int Hv, int Ha, long long* sizes) {
  a.B = B;
  a.Dq = Dq;
  // bf16: k16 steps, rows 16 bytes off a bank cycle; f32: 32 lanes' sums,
  // rows 16 bytes off a bank cycle, so the 8 lanes of a 16-byte shared load
  // phase hit 8 distinct bank quads
  a.Kp = kIsBf16<T> ? (Dq + 15) / 16 * 16 : (Dq + 31) / 32 * 32;
  a.ld = kIsBf16<T> ? a.Kp + 8 : a.Kp + 4;
  a.Lsum = Lt + 2 * La;
  const int Ls[3] = {Lt, La, La}, Hs[3] = {Ht, Hv, Ha};
  const int offs[3] = {0, Lt, Lt + La};
  int cs = 0, blk = 0, msl = 0;
  long long co = 0;
  a.blk_off[0] = 0;
  for (int s = 0; s < 3; ++s) {
    a.L[s] = Ls[s];
    a.H[s] = Hs[s];
    a.off[s] = offs[s];
    a.nch[s] = (Ls[s] + kAC - 1) / kAC;
    a.nsl[s] = (Hs[s] + kASlice - 1) / kASlice;
    a.cs_off[s] = cs;
    a.ctx_off[s] = co;
    cs += a.nch[s] * a.nsl[s];
    co += (long long)B * a.nch[s] * Hs[s];
    blk += a.nch[s] * a.nsl[s];
    a.blk_off[s + 1] = blk;
    msl = a.nsl[s] > msl ? a.nsl[s] : msl;
  }
  a.ncs = cs;
  a.msl = msl;
  sizes[0] = 2LL * B * cs;
  sizes[1] = co;
  sizes[2] = (long long)((B + kRows - 1) / kRows) * 3 * msl;
}

template <typename T>
int run_tiled(const void* q, const void* w_t, const void* bias,
              const void* et, const void* ev, const void* ea, const void* tl,
              const void* vl, const void* al, void* ctx_t, void* ctx_a,
              void* ctx_v, void* maps, void* part_ms, void* part_ctx,
              void* count, int B, int Dq, int Lt, int La, int Ht, int Hv,
              int Ha, cudaStream_t stream) {
  AttnArgs<T> a;
  long long sizes[3];
  attn_geometry(a, B, Dq, Lt, La, Ht, Hv, Ha, sizes);
  a.q = static_cast<const T*>(q);
  a.w_t = static_cast<const T*>(w_t);
  a.bias = static_cast<const float*>(bias);
  a.mem[0] = static_cast<const T*>(et);
  a.mem[1] = static_cast<const T*>(ev);
  a.mem[2] = static_cast<const T*>(ea);
  a.len[0] = static_cast<const int*>(tl);
  a.len[1] = static_cast<const int*>(vl);
  a.len[2] = static_cast<const int*>(al);
  a.ctx[0] = static_cast<float*>(ctx_t);
  a.ctx[1] = static_cast<float*>(ctx_v);
  a.ctx[2] = static_cast<float*>(ctx_a);
  a.maps = static_cast<float*>(maps);
  a.part_ms = static_cast<float*>(part_ms);
  a.part_ctx = static_cast<float*>(part_ctx);
  a.count = static_cast<unsigned*>(count);
  size_t smem = 2 * kRows * (size_t)a.ld * sizeof(T) +
                (kIsBf16<T> ? sizeof(float) * kWarps * kRows * kAPld : 0);
  const size_t merge = sizeof(float) * kRows * a.nch[0] > sizeof(float) * kRows * a.nch[1]
                           ? sizeof(float) * kRows * a.nch[0]
                           : sizeof(float) * kRows * a.nch[1];
  if (merge > smem) smem = merge;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.blk_off[3], (B + kRows - 1) / kRows);
  attn_tile_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg

// The kernel's scratch for these shapes: sizes[0] floats of part_ms,
// sizes[1] floats of part_ctx, sizes[2] unsigned counters (zeroed once by
// the caller; every launch leaves them zero).
extern "C" int mmqg_trimodal_attention_workspace(int B, int Dq, int Lt,
                                                 int La, int Ht, int Hv,
                                                 int Ha, void* sizes) {
  mmqg::AttnArgs<float> a;
  mmqg::attn_geometry(a, B, Dq, Lt, La, Ht, Hv, Ha,
                      static_cast<long long*>(sizes));
  return 0;
}

// q (B,Dq), w_t (Lt+2La,Dq) and the memories in the compute type (bf16 when
// ``bf16`` is set, else f32); bias (Lt+2La) f32; lengths (B) int32 each.
// Outputs f32: ctx_t (B,Ht), ctx_a (B,Ha), ctx_v (B,Hv), maps (B,Lt+2La);
// then the scratch of mmqg_trimodal_attention_workspace. Dq % 4 == 0 and
// H_s % 8 == 0 (the 8- and 16-byte copies). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int mmqg_trimodal_attention_tiled(
    const void* q, const void* w_t, const void* bias, const void* enc_text,
    const void* enc_video, const void* enc_audio, const void* text_len,
    const void* video_len, const void* audio_len, void* ctx_t, void* ctx_a,
    void* ctx_v, void* maps, void* part_ms, void* part_ctx, void* count,
    int B, int Dq, int Lt, int La, int Ht, int Hv, int Ha, int bf16,
    void* stream) {
  if (B < 1 || Dq < 4 || Dq % 4 || Ht % 8 || Hv % 8 || Ha % 8 || Lt < 1 ||
      La < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mmqg::run_tiled<__nv_bfloat16>(
        q, w_t, bias, enc_text, enc_video, enc_audio, text_len, video_len,
        audio_len, ctx_t, ctx_a, ctx_v, maps, part_ms, part_ctx, count, B, Dq,
        Lt, La, Ht, Hv, Ha, s);
  return mmqg::run_tiled<float>(q, w_t, bias, enc_text, enc_video, enc_audio,
                                text_len, video_len, audio_len, ctx_t, ctx_a,
                                ctx_v, maps, part_ms, part_ctx, count, B, Dq,
                                Lt, La, Ht, Hv, Ha, s);
}
