// Blocked matrix product for Hopper (sm_90a): out (M, N) = x (M, K) . w (K, N), bf16 in and
// out, fp32 accumulation, all row-major.
//
// Replaces the Pallas TPU kernel pallas_matmul of experiments/matmul_microbench.py: there a
// 1024-row block of x sits in VMEM beside all of w and one dot per grid step writes a
// (1024, N) block of the output. On this card w at N=320 is 200 KB of bf16 and at N=1280
// 800 KB, more than a block's shared memory beside any x tile, so N is tiled as well.
//
// What bounds it on the H100 at the UNet's narrow shapes, (258048, 320) x (320, 320|1280):
// bytes. At N=320 it reads 165 MB and writes 165 MB for 0.053 TFLOP (0.099 ms of memory
// time against 0.053 ms of tensor-core time); at N=1280 it writes 661 MB. The design
// therefore reads x once from device memory and keeps the re-reads in L2:
//   * one block per (128 x BN) output tile, BN = 128 when N is a multiple of 128, else 64;
//     the N tiles of one row block are neighbours in the grid, so the x rows they share
//     and all of w (at most 800 KB) are served by the 50 MB L2;
//   * K streams through shared memory in chunks of 64 with cp.async, two stages, into rows
//     padded by 8 elements (bank-conflict-free fragment loads);
//   * 8 warps, each owning 16 rows of the tile: mma.sync m16n8k16 with the fp32
//     accumulators in registers, x fragments by 32-bit shared loads, w fragments by
//     ldmatrix.trans (the helpers of flash_common.cuh);
//   * the bf16 tile is staged through the warp's own shared rows so that each lane stores
//     16 bytes to device memory.
// Ragged M, K and N are masked (rows and columns past the end load as zeros and are not
// stored); K and N must be multiples of 8 so that every 16-byte vector is whole.
// TMA loads and wgmma are later work.

#include "flash_common.cuh"

namespace {

using namespace lkgd;

constexpr int kBM = 128;   // output rows of a block
constexpr int kBKC = 64;   // depth of one streamed chunk
constexpr int kThreads = 256;

template <int BN>
struct MatmulSmem {
  static constexpr int LDA = kBKC + 8;
  static constexpr int LDW = RegTile<BN>::LD;
  static constexpr int a_elems = kBM * LDA;
  static constexpr int w_elems = kBKC * LDW;
  static constexpr size_t bytes = size_t(2) * (a_elems + w_elems) * sizeof(bf16);
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    blocked_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          bf16* __restrict__ out, int m, int k, int n, int n_tiles) {
  using L = MatmulSmem<BN>;
  constexpr int LDA = L::LDA, LDW = L::LDW;
  constexpr int NB = BN / 8;  // 8-wide accumulator tiles of a warp's 16 x BN output

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // stages 0, 1
  bf16* sW = sA + 2 * L::a_elems;            // stages 0, 1

  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  const int n_chunks = (k + kBKC - 1) / kBKC;

  auto load_stage = [&](int stage, int k0) {
    bf16* a = sA + stage * L::a_elems;
    for (int i = threadIdx.x; i < kBM * (kBKC / 8); i += kThreads) {
      const int r = i / (kBKC / 8), c = (i % (kBKC / 8)) * 8;
      const bool ok = m0 + r < m && k0 + c < k;
      const bf16* src = ok ? x + (long long)(m0 + r) * k + k0 + c : x;
      cp_async_16(a + r * LDA + c, src, ok);
    }
    bf16* b = sW + stage * L::w_elems;
    for (int i = threadIdx.x; i < kBKC * NB; i += kThreads) {
      const int r = i / NB, c = (i % NB) * 8;
      const bool ok = k0 + r < k && n0 + c < n;
      const bf16* src = ok ? w + (long long)(k0 + r) * n + n0 + c : w;
      cp_async_16(b + r * LDW + c, src, ok);
    }
  };

  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j & 1;
    if (j + 1 < n_chunks) {  // prefetch the next chunk into the other stage
      load_stage(st ^ 1, (j + 1) * kBKC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = sA + st * L::a_elems;
    const bf16* b = sW + st * L::w_elems;
#pragma unroll
    for (int kc = 0; kc < kBKC / 16; ++kc) {
      uint32_t af[4];
      load_a_frag<LDA>(af, a, wr, kc, g, t4);
      mma_a_by_rows<BN>(acc, af, b, kc, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // bf16 tile through the warp's own shared rows, then 16 bytes a lane to device memory
  bf16* stage = reinterpret_cast<bf16*>(smem) + warp * 16 * LDW;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + g * LDW + col) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDW + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NB; i += 32) {
    const int r = i / NB, c = (i % NB) * 8;
    const int row = m0 + wr + r, col = n0 + c;
    if (row < m && col < n)
      *reinterpret_cast<uint4*>(out + (long long)row * n + col) =
          *reinterpret_cast<const uint4*>(stage + r * LDW + c);
  }
}

template <int BN>
cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int m, int k, int n,
                   cudaStream_t stream) {
  auto kernel = blocked_matmul_kernel<BN>;
  const int bytes = int(MatmulSmem<BN>::bytes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + BN - 1) / BN;
  const long long blocks = (long long)((m + kBM - 1) / kBM) * n_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, bytes, stream>>>(x, w, out, m, k, n, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k), w (k, n), out (m, n): dense row-major bf16; k and n multiples of 8.
int lkgd_blocked_matmul(const void* x, const void* w, void* out, int m, int k, int n, int device,
                        void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || n % 8 != 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(n % 128 == 0 ? launch<128>(xp, wp, op, m, k, n, s)
                          : launch<64>(xp, wp, op, m, k, n, s));
}

}  // extern "C"
