// Blocked matrix product for Hopper (sm_90a): out (M, N) = x (M, K) . w (K, N), bf16 in and
// out, fp32 accumulation, all row-major.
//
// Replaces the Pallas TPU kernel pallas_matmul of experiments/matmul_microbench.py: there a
// 1024-row block of x sits in VMEM beside all of w and one dot per grid step writes a
// (1024, N) block of the output. On this card w at N=1280 is 800 KB of bf16, more than a
// block's shared memory, so N is tiled as well and w is streamed.
//
// What bounds it on the H100 at the UNet's narrow shapes, (258048, 320) x (320, 320|1280):
// bytes and operations both. At N=320 it reads 165 MB and writes 165 MB for 0.053 TFLOP
// (0.099 ms of memory time against 0.053 ms at the bf16 tensor rate); at N=1280 it writes
// 661 MB for 0.211 TFLOP (0.247 ms against 0.214 ms). So x must be read from device memory
// once, the output written once, and the products must run at the wgmma rate beside them:
//   * a persistent grid, one block an SM, each walking 128-row blocks of x and, inside
//     them, all 128-wide column tiles in turn;
//   * a block is three warpgroups. A producer warp keeps two rings in flight by TMA (rank-4
//     tensor maps over the dense views, 128-byte swizzle): its row block's x panels (128
//     rows x 64 of K, K-major) and w's chunks (64 rows of K x 128 columns as two 64-column
//     panels, read as they lie: the MN-major B operand, as V is in P.V). While K fits in the
//     x ring (K <= 384), the x panels of a row block are loaded once and stay for all its
//     column tiles: x is read from device memory once. A deeper K streams x again for each
//     tile (from L2: a row block's tiles run back to back on one block);
//   * w (at most 800 KB) stays in the 50 MB L2 and is read from there again for every row
//     block (1.65 GB at N=1280). Sharing each w chunk between a pair of blocks (a cluster of
//     two, TMA multicast) halves those reads and measured no faster at either shape: the L2
//     is not the limit, so each block loads its own;
//   * two consumer warpgroups, 64 rows each, run wgmma.mma_async m64n128k16 with both
//     operands in shared memory (128 columns: m64n64 with both operands in shared memory
//     asks 128 bytes a clock, all the SM has, and measured 1.4x slower); a ring slot is
//     released as soon as the products reading it are done, and the last column tile of a
//     row block releases its x panels one by one, so the next row block's panels load
//     under it. Both rings run across tile boundaries;
//   * the epilogue packs the accumulator to bf16, starts the next tile's first products,
//     and writes the tile through a swizzled shared stage with a TMA store (bulk group), so
//     the store overlaps the next tile (stores straight from the registers measured 1.5x
//     slower at N=1280). Rows past M and columns past N arrive as zeros from the hardware
//     and are not stored by it; K and N must be multiples of 8 (16-byte rows).

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using namespace lkgd;
using namespace lkgd::sm90;

constexpr int kBM = 128;         // output rows a tile: 64 a consumer warpgroup
constexpr int kBN = 128;         // output columns a tile
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kXSlots = 6;                          // x panels in shared memory
constexpr int kWSlots = 6;                          // w chunks in shared memory
constexpr int kXPanelBytes = kBM * kPanelRowBytes;  // 128 rows x 64 of K
constexpr int kWBytes = kPanelCols * kBN * 2;       // a chunk: 64 rows of K x 128 columns
constexpr int kWPanelBytes = kPanelCols * kPanelRowBytes;  // one 64-column half of it
constexpr int kOutBytes = kBM * kBN * 2;            // the bf16 tile staged for the TMA store
constexpr int kBarBytes = 8 * 2 * (kXSlots + kWSlots);  // a full/empty pair a slot
// 1024 bytes of slack: the tiles start at the next multiple of the swizzle atom
constexpr int kSmemBytes =
    kAtomBytes + kXSlots * kXPanelBytes + kWSlots * kWBytes + kOutBytes + kBarBytes;
constexpr int kHalves = kBN / kPanelCols;           // 64-column panels of a w chunk

struct MatmulArgs {
  int n_tiles;     // kBN-wide column tiles
  int row_blocks;  // kBM-row blocks
  int npx;         // 64-deep panels of K (the last one zero-padded)
  int resident;    // the x panels of a row block stay for all its column tiles
};

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    blocked_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_out, const MatmulArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sX = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sW = sX + kXSlots * kXPanelBytes;
  const uint32_t sOut = sW + kWSlots * kWBytes;
  const uint32_t x_full = sOut + kOutBytes, x_empty = x_full + 8 * kXSlots;
  const uint32_t w_full = x_empty + 8 * kXSlots, w_empty = w_full + 8 * kWSlots;

  // this block's tiles i = 0 .. count-1: row block blockIdx.x + (i / n_tiles) gridDim.x,
  // column tile i % n_tiles
  const int count = (a.row_blocks - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x) *
                    a.n_tiles;
  auto row_block = [&](int i) { return int(blockIdx.x) + (i / a.n_tiles) * int(gridDim.x); };
  // ring positions: x panel p of tile i (once per row block while resident), w chunk p
  auto x_event = [&](int i, int p) { return (a.resident ? i / a.n_tiles : i) * a.npx + p; };
  auto w_event = [&](int i, int p) { return i * a.npx + p; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXSlots; ++s) {
      mbar_init(x_full + 8 * s, 1);                 // the producer's arrive with the byte count
      mbar_init(x_empty + 8 * s, kConsumers / 32);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < kWSlots; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warpgroup
    reg_dealloc<40>();  // 2 x 128 x 232 + 128 x 40 registers: the SM's 64 K
    if (threadIdx.x == kConsumers) {
      // the order the consumers want: x panel p (when it is loaded) beside w chunk p
      for (int i = 0; i < count; ++i) {
        const int rb = row_block(i), t = i % a.n_tiles;
        const bool load_x = !a.resident || t == 0;
        for (int p = 0; p < a.npx; ++p) {
          if (load_x) {
            const int e = x_event(i, p), slot = e % kXSlots, use = e / kXSlots;
            if (use > 0) mbar_wait(x_empty + 8 * slot, (use - 1) & 1);
            mbar_arrive_expect_tx(x_full + 8 * slot, kXPanelBytes);
            tma_load_4d(sX + slot * kXPanelBytes, &map_x, x_full + 8 * slot, p * kPanelCols,
                        rb * kBM, 0, 0);
          }
          // w chunk p of column tile t: its two 64-column panels
          const int e = w_event(i, p), slot = e % kWSlots, use = e / kWSlots;
          if (use > 0) mbar_wait(w_empty + 8 * slot, (use - 1) & 1);
          const uint32_t bar = w_full + 8 * slot;
          mbar_arrive_expect_tx(bar, kWBytes);
          for (int h = 0; h < kHalves; ++h)
            tma_load_4d(sW + slot * kWBytes + h * kWPanelBytes, &map_w, bar,
                        t * kBN + h * kPanelCols, p * kPanelCols, 0, 0);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;  // issues this warpgroup's TMA stores
    const uint32_t stage = sOut + wg * 64 * kBN * 2;  // its 64 rows: two panels of 64 rows

    float acc[kBN / 2];
    uint32_t pk[kBN / 4];

    // acc (+)= x panel p . w chunk p of tile i: four 16-deep steps
    auto issue = [&](int i, int p) {
      const int xe = x_event(i, p), we = w_event(i, p);
      mbar_wait(x_full + 8 * (xe % kXSlots), (xe / kXSlots) & 1);
      mbar_wait(w_full + 8 * (we % kWSlots), (we / kWSlots) & 1);
      const uint64_t x_desc = smem_desc(
          sX + (xe % kXSlots) * kXPanelBytes + wg * 64 * kPanelRowBytes, 16, kAtomBytes);
      const uint64_t w_desc = smem_desc(sW + (we % kWSlots) * kWBytes, kWPanelBytes, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_mn(acc, desc_advance(x_desc, kk * 32),
                    desc_advance(w_desc, kk * 16 * kPanelRowBytes), (p | kk) != 0);
      wgmma_commit();
    };
    // chunk p of tile i is read no more by this warp: its w slot, and its x panel after the
    // row block's last column tile (or at once when x is streamed)
    auto done = [&](int i, int p) {
      if (lane != 0) return;
      mbar_arrive(w_empty + 8 * (w_event(i, p) % kWSlots));
      if (!a.resident || i % a.n_tiles == a.n_tiles - 1)
        mbar_arrive(x_empty + 8 * (x_event(i, p) % kXSlots));
    };
    // the packed tile -> the swizzled stage -> device memory by TMA; rows past M and columns
    // past N are not written
    auto store = [&](int i) {
      if (leader) bulk_wait_read<0>();  // the previous tile's stores have read the stage
      named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // row 16 warp + g + 8 r (g mod 8), columns 8 n + 2 t4: panel n / 8, 16-byte chunk
          // n % 8 of the 128-byte row, moved by the 128-byte swizzle to chunk (n % 8) ^ g
          const int row = warp * 16 + g + 8 * r;
          sts32(stage + (n / 8) * 64 * kPanelRowBytes + row * kPanelRowBytes +
                    (((n % 8) ^ g) * 16) + 4 * t4,
                pk[2 * n + r]);
        }
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      if (leader) {
        const int rb = row_block(i), t = i % a.n_tiles;
#pragma unroll
        for (int c = 0; c < kBN / kPanelCols; ++c)
          tma_store_4d(&map_out, stage + c * 64 * kPanelRowBytes, t * kBN + c * kPanelCols,
                       rb * kBM + wg * 64, 0, 0);
        bulk_commit();
      }
    };

    issue(0, 0);
    // One tile; `last` (a std::bool_constant) marks the block's last tile, which starts no
    // successor: no branch around the products on the tile's number.
    auto tile = [&](int i, auto last) {
      constexpr bool LAST = decltype(last)::value;
      for (int p = 1; p < a.npx; ++p) {
        issue(i, p);
        wgmma_wait<1>();
        done(i, p - 1);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      done(i, a.npx - 1);
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) pk[j] = pack_bf16(acc[2 * j], acc[2 * j + 1]);
      if (!LAST) issue(i + 1, 0);  // the next tile's first products run under this store
      store(i);
    };
    for (int i = 0; i + 1 < count; ++i) tile(i, std::false_type{});
    tile(count - 1, std::true_type{});
    if (leader) bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------- host side
MatmulArgs plan_args(int m, int k, int n) {
  MatmulArgs a;
  a.n_tiles = (n + kBN - 1) / kBN;
  a.row_blocks = (m + kBM - 1) / kBM;
  a.npx = (k + kPanelCols - 1) / kPanelCols;
  a.resident = a.npx <= kXSlots;
  return a;
}

// Blocks of the persistent grid: one a row block, at most one an SM.
int plan_blocks(const MatmulArgs& a, int sms) { return a.row_blocks < sms ? a.row_blocks : sms; }

// A rank-4 map over a dense row-major (rows, cols) bf16 matrix, boxes of 64 columns x
// `box_rows` rows.
cudaError_t dense_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const long long size = (long long)rows * cols;
  return make_map(map, base, Strides{size, cols, size}, 1, rows, 1, cols, box_rows);
}

cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int m, int k, int n, int sms,
                   cudaStream_t stream) {
  const MatmulArgs a = plan_args(m, k, n);
  CUtensorMap map_x, map_w, map_out;
  cudaError_t err = dense_map(&map_x, x, m, k, kBM);
  if (err == cudaSuccess) err = dense_map(&map_w, w, k, n, kPanelCols);
  if (err == cudaSuccess) err = dense_map(&map_out, out, m, n, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(blocked_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  blocked_matmul_kernel<<<plan_blocks(a, sms), kThreads, kSmemBytes, stream>>>(map_x, map_w,
                                                                              map_out, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling of an (m, k) x (k, n) product on a card of sm_count SMs, out[8]: tile rows, tile
// columns, x panel slots, w chunk slots, dynamic shared memory, blocks, the most tiles one
// block walks, and 1 when x stays resident across a row block's column tiles.
int lkgd_matmul_plan(int m, int k, int n, int sm_count, int* out) {
  if (m <= 0 || k <= 0 || n <= 0 || sm_count <= 0) return int(cudaErrorInvalidValue);
  const MatmulArgs a = plan_args(m, k, n);
  const int blocks = plan_blocks(a, sm_count);
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kXSlots;
  out[3] = kWSlots;
  out[4] = kSmemBytes;
  out[5] = blocks;
  out[6] = (a.row_blocks + blocks - 1) / blocks * a.n_tiles;
  out[7] = a.resident;
  return 0;
}

// x (m, k), w (k, n), out (m, n): dense row-major bf16; k and n multiples of 8.
int lkgd_blocked_matmul(const void* x, const void* w, void* out, int m, int k, int n, int device,
                        void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || n % 8 != 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  return int(launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                    static_cast<bf16*>(out), m, k, n, sms, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
