// Video Swin-B's shifted-window self-attention: every window and head of one
// block in one launch, with the relative-position bias, the shift's region
// mask and each clip's padded keys built inside the kernel.
//
// Replaces no TPU kernel: the JAX package has no Video Swin encoder, and
// the port serves torchvision's swin3d_b (models/video_swin.py). It takes
// the place of a chain of library calls: the bias gathered into a mask, the
// region mask added to it in the compute dtype, PyTorch's fused attention
// over every window, and a second masked pass over the windows that hold
// both live and padded tokens.
//
// qkv (windows, N, 3, heads, 32) is the qkv GEMM's output as it is; out
// (windows, N, heads * 32) holds head h at columns 32h..32h+31, as proj
// reads it. Window w = ((b * nt + it) * nh + ih) * nw + iw of clip b, and
// its tokens i, j < N = wt * wh * ww in (t, h, w) order:
//   s(i, j) = q_i . k_j / sqrt(32) + table[A(i) - A(j) + 1267, head]
//             + REGION (-100) where i and j lie in different regions of the
//               rolled volume (shifted blocks: only the last window along a
//               shifted axis holds two regions of it)
//   a key whose rolled temporal position (it * wt + lt + st) mod (nt * wt)
//   is at or past live[b] takes no weight (its exp is exactly 0)
//   out_i = sum_j softmax_j(s(i, j)) v_j
// with A(n) = (n / 49) * 169 + (n / 7 % 7) * 13 + n % 7: the flat (8, 7, 7)
// numbering of torchvision's relative_position_index()[:N, :N], whatever
// the window's true shape. A window with no live key (padding alone)
// writes zeros and returns: no live token reads it.
//
// What bounds it on the H100: the per-score work, then the bytes. At the
// serving cell's shapes (32 clips of 20-101 frames at 224 px) a trunk's 24
// calls hold ~65 G live scores: 8.5 ms of bf16 products at 989 TFLOP/s, up
// to 13 ms of q, k, v and out at 3.35 TB/s, and 16.7 ms of exponentials
// alone at the SMs' ~3.9 T/s of special functions, besides the bias load,
// the scaling, the running max and sum a score. So mma.sync (m16n8k16, f32
// sums) suffices, and the design keeps the per-score instructions few: the
// table's column sits in shared memory pre-scaled by log2(e), a score's
// bias is one shared load at (row base - key offset), scale and bias are
// one fma, exp2 is ex2.approx, and the region and padded-key masks are
// compiled only into the variant a window needs (a window-uniform branch).
//
// bf16 (window_flash_fwd_kernel<__nv_bfloat16>): a block of 5 warps per
// (window, head), 3 blocks an SM. K and V go to shared memory by 16-byte
// cp.async (64-byte rows, the 16-byte chunks XOR-swizzled by row so that
// ldmatrix reads 8 rows without bank conflicts; rows N..round16(N) zero),
// 51 KB; the table's column 10 KB. Each warp walks 16-query tiles (25 for
// N = 392: 5 a warp), its q fragments read from global straight into
// registers one tile ahead, over keys in blocks of 64 (8 n8 tiles) with an
// online softmax (FlashAttention-2: f32 running max and sum, exp2, the
// probabilities rounded to bf16 for P.V); a tail block of 16 keys finishes
// N = 392's 49 tiles.
//
// float32 (window_flash_fwd_kernel<float>): the same window set-up, masks
// and bias code, then a thread per query row with float32 FMA products
// (not TF32) and a per-key online softmax. It serves the f32 memory check
// and the tests; its speed does not matter.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace mmqg {
namespace {

using tc::bf16;

constexpr int kD = 32;            // head size
constexpr int kMaxN = 392;        // tokens of an (8, 7, 7) window
constexpr int kRows = 400;        // K and V rows in shared memory: 25 k16
constexpr int kTable = 2535;      // (15, 13, 13) relative positions
constexpr int kCentre = 7 * 169 + 6 * 13 + 6;
constexpr int kWarps = 5;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockTiles = 8;    // n8 key tiles a softmax block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kRegionL2 = -100.0f * kLog2e;

struct Args {
  const void* qkv;      // (windows, N, 3, heads, 32), T
  const float* table;   // (2535, heads)
  const int* live;      // (B,) live temporal tokens of each clip
  void* out;            // (windows, N, heads * 32), T
  int heads;
  int nt, nh, nw;       // windows along T, H, W
  int wt, wh, ww;       // the window
  int st, sh, sw;       // the shift
  int N;
  float scale_l2;       // 32^-0.5 * log2(e)
};

// Shared memory: the table's column, then per key its offset into it, its
// region and its penalty (0 or -inf), then K and V.
struct Smem {
  float tab[kTable + 1];
  int kofs[kRows];      // A(j) * 4: byte offset, subtracted from a row base
  int kreg[kRows];      // region id of key j
  float kpen[kRows];    // 0, or -inf for a padded key or j >= N
};

template <typename T>
constexpr int kv_bytes() {
  return 2 * kRows * kD * (int)sizeof(T);
}

template <typename T>
constexpr int smem_bytes() {
  return (int)sizeof(Smem) + kv_bytes<T>();
}

__device__ __forceinline__ int flat_a(int n) {
  return (n / 49) * 169 + (n / 7 % 7) * 13 + n % 7;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The window of this block and what it needs: its clip, whether any key
// is live, whether it holds two regions, and each token's region.
struct Window {
  int w, head, b, it, ih, iw;
  unsigned live_slices;  // bit lt: temporal slice lt of the window is live
  bool region;           // tokens of different regions meet here

  __device__ Window(const Args& p) {
    head = blockIdx.x % p.heads;
    w = blockIdx.x / p.heads;
    iw = w % p.nw;
    int r = w / p.nw;
    ih = r % p.nh;
    r /= p.nh;
    it = r % p.nt;
    b = r / p.nt;
    const int tp = p.nt * p.wt;
    const int live = __ldg(p.live + b);
    live_slices = 0;
    for (int lt = 0; lt < p.wt; ++lt)
      if ((it * p.wt + lt + p.st) % tp < live) live_slices |= 1u << lt;
    region = (p.st && it == p.nt - 1) || (p.sh && ih == p.nh - 1) ||
             (p.sw && iw == p.nw - 1);
  }

  // the region id of token n: along a shifted axis the last window holds
  // region 1 (its first w - s positions) and 2 (its last s), others 0
  __device__ __forceinline__ int region_of(const Args& p, int n) const {
    const int lw = n % p.ww, lh = n / p.ww % p.wh, lt = n / (p.ww * p.wh);
    const int rt = (p.st && it == p.nt - 1) ? 1 + (lt >= p.wt - p.st) : 0;
    const int rh = (p.sh && ih == p.nh - 1) ? 1 + (lh >= p.wh - p.sh) : 0;
    const int rw = (p.sw && iw == p.nw - 1) ? 1 + (lw >= p.ww - p.sw) : 0;
    return rt * 9 + rh * 3 + rw;
  }

  __device__ __forceinline__ bool key_live(const Args& p, int n) const {
    return n < p.N && ((live_slices >> (n / (p.ww * p.wh))) & 1u);
  }
};

// The table's column (times log2(e)) and the per-key arrays, all threads.
__device__ void fill_keys(const Args& p, const Window& win, Smem& s) {
  constexpr int kTabLoads = (kTable + kThreads - 1) / kThreads;
  float v[kTabLoads];  // all of a thread's loads in flight at once
#pragma unroll
  for (int k = 0; k < kTabLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < kTable ? __ldg(p.table + (size_t)i * p.heads + win.head)
                      : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kTabLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kTable) s.tab[i] = v[k] * kLog2e;
  }
  for (int j = threadIdx.x; j < kRows; j += kThreads) {
    const bool in = j < p.N;
    s.kofs[j] = in ? flat_a(j) * 4 : 0;
    s.kreg[j] = in ? win.region_of(p, j) : -1;
    s.kpen[j] = win.key_live(p, j) ? 0.0f : -INFINITY;
  }
}

template <typename T>
__device__ void write_zeros(const Args& p, const Window& win) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte store
  const int C = p.heads * kD;
  T* out = static_cast<T*>(p.out) + (size_t)win.w * p.N * C + win.head * kD;
  for (int c = threadIdx.x; c < p.N * (kD / kPer); c += kThreads) {
    const int r = c / (kD / kPer), k = c % (kD / kPer);
    *reinterpret_cast<uint4*>(out + (size_t)r * C + k * kPer) =
        make_uint4(0, 0, 0, 0);
  }
}

// ------------------------------------------------------------------ bf16

// the swizzled element offset of (row r, 8-column chunk c) of K or V
__device__ __forceinline__ int kv_off(int r, int c) {
  return r * kD + ((c ^ ((r >> 1) & 3)) << 3);
}

// A lane's ldmatrix offsets, which depend on the lane alone since tiles
// start at rows that are multiples of 8: K (an n8 tile's 8 rows, the 4
// chunks), V (a k16 chunk's 16 rows, chunks 0-1 and 2-3)
struct LaneOffsets {
  int k, v01, v23;
  __device__ LaneOffsets() {
    const int lane = threadIdx.x & 31;
    k = kv_off(lane & 7, lane >> 3);
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    v01 = kv_off(r, lane >> 4);
    v23 = kv_off(r, 2 + (lane >> 4));
  }
};

// one query row's view: its bias row (base of the table for row i) and its
// region id
struct QRow {
  const char* bias;
  int reg;
};

// this thread's q fragments of a 16-row tile (rows r0 + g, r0 + g + 8),
// zero past N: a[k16 step][reg]
__device__ __forceinline__ void load_q(const Args& p, const Window& win,
                                       int r0, uint32_t (&a)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const size_t stride = (size_t)3 * p.heads * kD / 2;  // in bf16 pairs
  const uint32_t* base = static_cast<const uint32_t*>(p.qkv) +
                         ((size_t)win.w * p.N * 3 * p.heads * kD +
                          win.head * kD) / 2;
  const int ra = r0 + g, rb = r0 + g + 8;
  const uint32_t* pa = base + (size_t)ra * stride;
  const uint32_t* pb = base + (size_t)rb * stride;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    a[k][0] = ra < p.N ? __ldg(pa + 8 * k + q) : 0u;
    a[k][1] = rb < p.N ? __ldg(pb + 8 * k + q) : 0u;
    a[k][2] = ra < p.N ? __ldg(pa + 8 * k + 4 + q) : 0u;
    a[k][3] = rb < p.N ? __ldg(pb + 8 * k + 4 + q) : 0u;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The running state of one thread's two query rows.
struct Flash {
  float o[4][4];  // O[row g or g + 8][dims 8t + 2q, + 1]
  float m[2], l[2];
};

// Scores of NT n8 key tiles from tile0 against a q tile, through the
// softmax into acc. GUARD: tiles at or past n8 are skipped (weight 0).
template <int NT, bool REGION, bool KEYMASK, bool GUARD>
__device__ __forceinline__ void key_block(
    const Args& p, const Smem& s, const bf16* Ks, const bf16* Vs,
    const uint32_t (&qa)[2][4], const QRow (&row)[2],
    const LaneOffsets& lo, int tile0, int n8, Flash& f) {
  const int q = threadIdx.x & 3;
  float sc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int tile = tile0 + t;
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.0f;
    if (GUARD && tile >= n8) continue;
    uint32_t kf[4];
    tc::ldmatrix_x4(kf, Ks + tile * 8 * kD + lo.k);
    tc::mma_bf16(sc[t], qa[0], kf[0], kf[1]);
    tc::mma_bf16(sc[t], qa[1], kf[2], kf[3]);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int tile = tile0 + t;
    if (GUARD && tile >= n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = -INFINITY;
      continue;
    }
    const int j = tile * 8 + 2 * q;
    const int2 ko = *reinterpret_cast<const int2*>(s.kofs + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = (e & 1) ? ko.y : ko.x;
      const float b = *reinterpret_cast<const float*>(row[e >> 1].bias - off);
      sc[t][e] = fmaf(sc[t][e], p.scale_l2, b);
    }
    if (REGION) {
      const int2 kr = *reinterpret_cast<const int2*>(s.kreg + j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (((e & 1) ? kr.y : kr.x) != row[e >> 1].reg) sc[t][e] += kRegionL2;
    }
    if (KEYMASK) {
      const float2 kp = *reinterpret_cast<const float2*>(s.kpen + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] += (e & 1) ? kp.y : kp.x;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
  }
  float use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(f.m[h], mx[h]);
    use[h] = mn == -INFINITY ? 0.0f : mn;   // every key so far masked
    const float alpha = ex2(f.m[h] - use[h]);
    f.m[h] = mn;
    f.l[h] *= alpha;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      f.o[t][2 * h] *= alpha;
      f.o[t][2 * h + 1] *= alpha;
    }
  }
  uint32_t pa[NT][2];  // bf16 pairs: [tile][row g, row g + 8]
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float e4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      e4[e] = ex2(sc[t][e] - use[e >> 1]);
      f.l[e >> 1] += e4[e];
    }
    pa[t][0] = pack_bf16(e4[0], e4[1]);
    pa[t][1] = pack_bf16(e4[2], e4[3]);
  }
#pragma unroll
  for (int u = 0; u < NT / 2; ++u) {
    if (GUARD && tile0 + 2 * u >= n8) break;
    const uint32_t a[4] = {pa[2 * u][0], pa[2 * u][1], pa[2 * u + 1][0],
                           pa[2 * u + 1][1]};
    const bf16* v = Vs + (tile0 + 2 * u) * 8 * kD;
#pragma unroll
    for (int t = 0; t < 4; t += 2) {
      uint32_t vf[4];
      tc::ldmatrix_x4_trans(vf, v + (t ? lo.v23 : lo.v01));
      tc::mma_bf16(f.o[t], a, vf[0], vf[1]);
      tc::mma_bf16(f.o[t + 1], a, vf[2], vf[3]);
    }
  }
}

template <bool REGION, bool KEYMASK>
__device__ void attend_bf16(const Args& p, const Window& win, const Smem& s,
                            const bf16* Ks, const bf16* Vs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (p.N + 15) / 16;
  const int n8 = (p.N + 7) / 8;
  const int full = n8 / kBlockTiles;
  const int C = p.heads * kD;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)win.w * p.N * C +
              win.head * kD;
  uint32_t qa[2][4], next[2][4];
  if (warp < tiles) load_q(p, win, warp * 16, next);
  for (int qt = warp; qt < tiles; qt += kWarps) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[k][e] = next[k][e];
    if (qt + kWarps < tiles) load_q(p, win, (qt + kWarps) * 16, next);
    QRow row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = min(qt * 16 + g + 8 * h, p.N - 1);
      row[h].bias = reinterpret_cast<const char*>(s.tab + flat_a(i) +
                                                  kCentre);
      row[h].reg = REGION ? win.region_of(p, i) : 0;
    }
    const LaneOffsets lo;
    Flash f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) f.o[t][e] = 0.0f;
    f.m[0] = f.m[1] = -INFINITY;
    f.l[0] = f.l[1] = 0.0f;
    for (int kb = 0; kb < full; ++kb)
      key_block<kBlockTiles, REGION, KEYMASK, false>(
          p, s, Ks, Vs, qa, row, lo, kb * kBlockTiles, n8, f);
    for (int t0 = full * kBlockTiles; t0 < n8; t0 += 2)
      key_block<2, REGION, KEYMASK, true>(p, s, Ks, Vs, qa, row, lo, t0, n8,
                                          f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = f.l[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / l;
      const int i = qt * 16 + g + 8 * h;
      if (i >= p.N) continue;
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(out + (size_t)i * C);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        o[t * 4 + q] = __floats2bfloat162_rn(f.o[t][2 * h] * inv,
                                             f.o[t][2 * h + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------- f32

__device__ void attend_f32(const Args& p, const Window& win, const Smem& s,
                           const float* Ks, const float* Vs) {
  const int C = p.heads * kD;
  const float* qkv = static_cast<const float*>(p.qkv);
  float* out = static_cast<float*>(p.out) + (size_t)win.w * p.N * C +
               win.head * kD;
  for (int i = threadIdx.x; i < p.N; i += kThreads) {
    const float4* qp = reinterpret_cast<const float4*>(
        qkv + ((size_t)win.w * p.N + i) * 3 * C + win.head * kD);
    float qv[kD], o[kD];
#pragma unroll
    for (int k = 0; k < kD / 4; ++k) {
      const float4 v = __ldg(qp + k);
      qv[4 * k] = v.x;
      qv[4 * k + 1] = v.y;
      qv[4 * k + 2] = v.z;
      qv[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] = 0.0f;
    const char* bias = reinterpret_cast<const char*>(s.tab + flat_a(i) +
                                                     kCentre);
    const int reg = win.region_of(p, i);
    float m = -INFINITY, l = 0.0f;
    for (int j = 0; j < p.N; ++j) {
      if (s.kpen[j] != 0.0f) continue;   // the same j for every thread
      const float4* kp = reinterpret_cast<const float4*>(Ks + j * kD);
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < kD / 4; ++k) {
        const float4 v = kp[k];
        dot = fmaf(qv[4 * k], v.x, dot);
        dot = fmaf(qv[4 * k + 1], v.y, dot);
        dot = fmaf(qv[4 * k + 2], v.z, dot);
        dot = fmaf(qv[4 * k + 3], v.w, dot);
      }
      float sc = fmaf(dot, p.scale_l2, *reinterpret_cast<const float*>(
                                           bias - s.kofs[j]));
      if (s.kreg[j] != reg) sc += kRegionL2;
      if (sc > m) {
        const float c = exp2f(m - sc);
        l *= c;
#pragma unroll
        for (int d = 0; d < kD; ++d) o[d] *= c;
        m = sc;
      }
      const float e = exp2f(sc - m);
      l += e;
      const float4* vp = reinterpret_cast<const float4*>(Vs + j * kD);
#pragma unroll
      for (int k = 0; k < kD / 4; ++k) {
        const float4 v = vp[k];
        o[4 * k] = fmaf(e, v.x, o[4 * k]);
        o[4 * k + 1] = fmaf(e, v.y, o[4 * k + 1]);
        o[4 * k + 2] = fmaf(e, v.z, o[4 * k + 2]);
        o[4 * k + 3] = fmaf(e, v.w, o[4 * k + 3]);
      }
    }
    const float inv = 1.0f / l;
    float4* op = reinterpret_cast<float4*>(out + (size_t)i * C);
#pragma unroll
    for (int k = 0; k < kD / 4; ++k)
      op[k] = make_float4(o[4 * k] * inv, o[4 * k + 1] * inv,
                          o[4 * k + 2] * inv, o[4 * k + 3] * inv);
  }
}

// ---------------------------------------------------------------- kernel

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    window_flash_fwd_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + sizeof(Smem));
  T* Vs = Ks + kRows * kD;
  const Window win(p);
  if (!win.live_slices) {
    write_zeros<T>(p, win);
    return;
  }
  // K and V of this head: 16-byte copies, zero rows from N to a multiple
  // of 16 (bf16: swizzled; f32: plain rows)
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kD / kPer;
  const int rows = std::is_same<T, float>::value ? p.N : (p.N + 15) & ~15;
  const T* qkv = static_cast<const T*>(p.qkv);
  const size_t row_stride = (size_t)3 * p.heads * kD;
  for (int c = threadIdx.x; c < 2 * rows * kChunks; c += kThreads) {
    const int which = c / (rows * kChunks), rem = c % (rows * kChunks);
    const int r = rem / kChunks, k = rem % kChunks;
    const bool valid = r < p.N;
    const T* src = qkv + ((size_t)win.w * p.N + (valid ? r : 0)) *
                             row_stride + (size_t)(1 + which) * p.heads * kD +
                   win.head * kD + k * kPer;
    T* base = which ? Vs : Ks;
    T* dst = std::is_same<T, float>::value ? base + r * kD + k * kPer
                                           : base + kv_off(r, k);
    tc::cp_async16(dst, src, valid);
  }
  tc::cp_async_commit();
  fill_keys(p, win, s);
  tc::cp_async_wait<0>();
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {
    attend_f32(p, win, s, Ks, Vs);
  } else {
    const bool keymask = win.live_slices != (1u << p.wt) - 1u || p.N % 8;
    if (win.region) {
      if (keymask)
        attend_bf16<true, true>(p, win, s, Ks, Vs);
      else
        attend_bf16<true, false>(p, win, s, Ks, Vs);
    } else {
      if (keymask)
        attend_bf16<false, true>(p, win, s, Ks, Vs);
      else
        attend_bf16<false, false>(p, win, s, Ks, Vs);
    }
  }
}

template <typename T>
int launch(const Args& p, int windows, cudaStream_t stream) {
  const int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      window_flash_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_flash_fwd_kernel<T>
      <<<windows * p.heads, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmqg

// Every window of one Swin block on ``stream``: qkv (windows, N, 3, heads,
// 32) bf16 or (``f32``) float32, contiguous, 16-byte aligned; table (2535,
// heads) float32; live (B,) int32 with B = windows / (nt * nh * nw); out
// (windows, N, heads * 32) of qkv's dtype. The window (wt, wh, ww) holds N
// <= 392 tokens, wt <= 8, wh and ww <= 7; the shift (st, sh, sw) is below
// it. Returns the cudaError_t of the launch.
extern "C" int mmqg_window_attention(const void* qkv, const void* table,
                                     const void* live, void* out,
                                     int windows, int heads, int nt, int nh,
                                     int nw, int wt, int wh, int ww, int st,
                                     int sh, int sw, int f32, void* stream) {
  using namespace mmqg;
  const long long N = (long long)wt * wh * ww;
  if (windows < 1 || heads < 1 || nt < 1 || nh < 1 || nw < 1 || wt < 1 ||
      wh < 1 || ww < 1 || wt > 8 || wh > 7 || ww > 7 || N > kMaxN ||
      st < 0 || sh < 0 || sw < 0 || st >= wt || sh >= wh || sw >= ww ||
      windows % (nt * nh * nw) || (long long)windows * heads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.qkv = qkv;
  p.table = static_cast<const float*>(table);
  p.live = static_cast<const int*>(live);
  p.out = out;
  p.heads = heads;
  p.nt = nt;
  p.nh = nh;
  p.nw = nw;
  p.wt = wt;
  p.wh = wh;
  p.ww = ww;
  p.st = st;
  p.sh = sh;
  p.sw = sw;
  p.N = (int)N;
  p.scale_l2 = kLog2e / sqrtf((float)kD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(p, windows, s) : launch<bf16>(p, windows, s);
}
