// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the K3
// implicit-GEMM conv (vggish_conv.cu) and K4's gradient GEMMs
// (lstm_train.cu). Two routes:
//
// mma.sync.m16n8k16 (bf16 x bf16 -> f32), fed by ldmatrix from a ring of
// kStages shared-memory stages that 16-byte cp.async copies fill
// (zero-fill through cp.async's src-size operand): K4's GEMMs (mma_slice,
// load_tile). A block of 256 threads owns a kBM x kBN = 128 x 128 output
// tile and walks K in steps of kBK = 32; its 8 warps are 2 (M) x 4 (N), each
// a 64 x 32 sub-tile of 4 x 4 m16n8 accumulators (64 f32 registers a
// thread). Operand tiles in shared memory, either way round, padded so that
// the 8 rows an ldmatrix reads fall in 8 different 16-byte bank groups:
//   K-major:  [kBM or kBN rows][kLdK = kBK + 8]  (row = m or n, k contiguous)
//   MN-major: [kBK rows][kLdMN = kBM + 8]        (row = k, m or n contiguous)
// A K-major operand is read with ldmatrix, an MN-major one with
// ldmatrix.trans, so neither needs a transposing copy.
//
// wgmma.mma_async (warpgroup products from shared-memory descriptors) on
// K-major tiles with the 128-byte swizzle: K3 (see the wgmma section).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmqg {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kLdK = kBK + 8;    // 40 elements: 80-byte rows
constexpr int kLdMN = kBM + 8;   // 136 elements: 272-byte rows
constexpr int kTileElems = kBM * kLdK;  // 5120 >= kBK * kLdMN = 4352
constexpr int kStageElems = 2 * kTileElems;  // A then B
constexpr int kSmemBytes = kStages * kStageElems * 2;  // 81920
static_assert(kBK * kLdMN <= kTileElems, "an MN-major tile fits a slot");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes 16 zero bytes (reads nothing) when
// ``valid`` is false. ``src`` must be a valid 16-byte-aligned address even
// then.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b for one m16n8k16 tile, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt][i] of the calling thread: row wm + 16 mt + g + 8 (i >> 1),
// column wn + 8 nt + 2 q + (i & 1), with g = lane / 4, q = lane % 4,
// wm = warp_row0() and wn = warp_col0().
struct Acc {
  float v[4][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[a][b][c] = 0.0f;
  }
};

__device__ __forceinline__ int warp_row0() { return (threadIdx.x >> 7) * 64; }
__device__ __forceinline__ int warp_col0() {
  return ((threadIdx.x >> 5) & 3) * 32;
}

// acc += A_tile . B_tile over one kBK slice held in shared memory.
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void mma_slice(const bf16* As, const bf16* Bs,
                                          Acc& acc) {
  const int lane = threadIdx.x & 31;
  const int wm = warp_row0(), wn = warp_col0();
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m0 = wm + mt * 16;
      if (A_KMAJOR) {  // As[m][k]: lanes 0-15 rows m0.., lanes 16-31 at k+8
        ldmatrix_x4(a[mt],
                    As + (m0 + (lane & 15)) * kLdK + ks + (lane >> 4) * 8);
      } else {  // As[k][m]: matrices (k0-7,m0-7) (k0-7,m8-15) (k8-15,m0-7) ..
        ldmatrix_x4_trans(a[mt], As + (ks + (lane & 7) + (lane >> 4) * 8) *
                                          kLdMN +
                                      m0 + ((lane >> 3) & 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n0 = wn + np * 16;
      uint32_t r[4];
      if (B_KMAJOR) {  // Bs[n][k]: matrices (n0-7,k0-7) (n0-7,k8-15) (n8-15,..)
        ldmatrix_x4(r, Bs + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdK + ks +
                           ((lane >> 3) & 1) * 8);
      } else {  // Bs[k][n]: matrices (k0-7,n0-7) (k8-15,n0-7) (k0-7,n8-15) ..
        ldmatrix_x4_trans(r, Bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      kLdMN +
                                  n0 + (lane >> 4) * 8);
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc.v[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Stage one operand tile (kBM or kBN rows of the operand's M or N, kBK of
// K) of a strided bf16 matrix into shared memory. The operand is X(r, k)
// for r < R, k < K: X[r * ld + k] when K_MAJOR, else X[k * ld + r]. Each of
// the 256 threads copies two 16-byte chunks; a chunk that lies wholly in
// range and is 16-byte aligned goes by cp.async, one wholly outside is
// zero-filled by cp.async, and a ragged or unaligned one (e.g. rows of 300
// bf16, 600 bytes) is copied element by element with zeros past the edge.
template <bool K_MAJOR>
__device__ __forceinline__ void load_tile(bf16* S, const bf16* X, int64_t ld,
                                          int R, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    int r, k, n_in;  // the chunk's first (r, k) and how many lie in range
    bf16* dst;
    const bf16* src;
    if (K_MAJOR) {
      r = r0 + (c >> 2);
      k = k0 + (c & 3) * 8;
      dst = S + (c >> 2) * kLdK + (c & 3) * 8;
      src = X + r * ld + k;
      n_in = r < R ? min(8, K - k) : 0;
    } else {
      k = k0 + (c >> 4);
      r = r0 + (c & 15) * 8;
      dst = S + (c >> 4) * kLdMN + (c & 15) * 8;
      src = X + k * ld + r;
      n_in = k < K ? min(8, R - r) : 0;
    }
    const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    if (n_in >= 8 && aligned) {
      cp_async16(dst, src, true);
    } else if (n_in <= 0) {
      cp_async16(dst, X, false);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = e < n_in ? src[e] : __float2bfloat16(0.0f);
    }
  }
}

// ------------------------------------------------------------------ wgmma
//
// Hopper's warpgroup product, both operands read from shared memory through
// descriptors, in the K-major layout with the 128-byte swizzle: a tile of R
// rows x 64 bf16 columns is R rows of 128 bytes, and within each 1024-byte
// group of 8 rows the 16-byte chunk j of row r sits at chunk j ^ (r % 8),
// so element (r, k) is at byte r * 128 + ((k / 8) ^ (r % 8)) * 16 +
// (k % 8) * 2 (swz_off). Tiles start on 1024-byte boundaries; SBO (the next
// 8 rows) is 1024 bytes, and a k16 step advances the start address by 32
// bytes (the hardware applies the XOR to the address bits).
constexpr int kSwzRowBytes = 128;

// element offset of row r, 8-column chunk j in a swizzled tile
__device__ __forceinline__ int swz_off(int r, int j) {
  return r * 64 + ((j ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);  // 128B swizzle
}

// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each writer fences before the barrier that hands the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 16) . B (16 x 128) over one k16 step, both K-major in shared
// memory. d[i] of thread t of the warpgroup: row 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace tc
}  // namespace mmqg
