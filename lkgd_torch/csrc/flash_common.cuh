// Pieces shared by the mma.sync kernels (the two microbenchmark kernels, flash_variant.cu and
// blocked_matmul.cu): mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix, cp.async and
// the padded shared tiles they work on; and the types every flash source shares (bf16,
// Strides, pack_bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lkgd {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;  // in elements; the D stride is 1
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global->shared copy; with ok == false nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A shared tile of rows of D padded to DP, each row padded by 8 more elements so that the
// fragment loads of a warp hit distinct banks.
template <int DP>
struct RegTile {
  static constexpr int LD = DP + 8;
};

// The A operand (16 rows x 16 of depth, chunk kc) of mma m16n8k16 for the 16 rows starting
// at `row` of a padded tile; g = lane / 4 and t4 = lane % 4 as in the accumulator layout.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* tile, int row, int kc,
                                            int g, int t4) {
  const bf16* p = tile + (row + g) * LD + kc * 16 + 2 * t4;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LD);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LD + 8);
}

// The A operand of a product over 16 tile columns (chunk kc) from score-shaped accumulators
// s[n][4] of 8-wide n-tiles: the accumulator of one product is the next one's A operand.
__device__ __forceinline__ void acc_to_a_frag(uint32_t (&a)[4], float (*s)[4], int kc) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// acc[n] += A (16 x 16, chunk kc of the tile's rows) . tile[16 kc .. 16 kc + 15][0 .. DP):
// B fragments of a row-major (rows, DP) tile whose rows are the product's depth, with
// ldmatrix.trans.
template <int DP>
__device__ __forceinline__ void mma_a_by_rows(float (&acc)[DP / 8][4], const uint32_t (&a)[4],
                                              const bf16* tile, int kc, int lane) {
  constexpr int LD = RegTile<DP>::LD;
  const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
  const bf16* row = tile + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
  for (int n = 0; n < DP / 8; n += 2) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, row + n * 8);
    mma_16816(acc[n], a, f[0], f[1]);
    mma_16816(acc[n + 1], a, f[2], f[3]);
  }
}

}  // namespace lkgd
