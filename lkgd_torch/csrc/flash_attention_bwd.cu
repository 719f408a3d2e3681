// Flash-attention backward for Hopper (sm_90a): bf16 operands, fp32 accumulation, every
// D % 8 == 0 up to 512 (the JAX kernels' `supports`).
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py that _flash_bwd_bhsd
// drives under the custom VJP _flash_core:
//   * flash_bwd_dq_kernel ports _flash_bwd_dq_kernel (kernel 9):
//       P = exp2(s * scale * log2e - lse),  dS = P o (dO V^T - delta),  dQ = scale * dS K;
//   * flash_bwd_dkv_kernel ports _flash_bwd_dkv_kernel (kernel 10):
//       dV = P^T dO,  dK = scale * dS^T Q.
// lse is the forward's log2-domain logsumexp (B*H, S_q), carrying the shift the forward used,
// and delta = rowsum(dO o O) (B*H, S_q), both fp32, computed in PyTorch as JAX does
// (flash_attention.py:528). P and dS are rounded to bf16 before their products, as the TPU
// kernels round them to the input dtype.
//
// What bounds it on the H100: tensor-core operations. Each kernel recomputes the scores: dq
// runs three S^2*D products (Q K^T, dO V^T, dS K), dk/dv four (K Q^T, V dO^T, then P^T dO
// into dV and dS^T Q into dK); the fine-tune's level-0 call (B*T=8, S=4096, 5 heads, D=64)
// is 0.60 TFLOP for the pair. One exp2 stands against 384 (dq) or 512 (dk/dv) tensor-core
// operations, so the products, not the exp2 unit, set the pace, and they must run at the
// wgmma rate. The design, the forward's (flash_attention_wgmma.cu) turned around:
//   * the TPU's two-kernel split, no atomics: dq is one block per (batch*head, 128 query
//     rows) looping over key tiles, dk/dv one block per (batch*head, 128 keys) looping over
//     query tiles. Each output is written once: the result is deterministic, as JAX's is;
//   * a block is three warpgroups. A producer warp loads the block's own tiles once (Q and
//     dO for dq, K and V for dk/dv) and keeps a ring of streamed tiles in flight by TMA
//     (K and V tiles for dq; Q and dO tiles for dk/dv), through rank-4 tensor maps over the
//     (B, S, H, D) views' strides (make_map, shared with the forward), in the 128-byte
//     swizzle that wgmma reads directly. For dk/dv the same warp copies the tile's 64 lse
//     and delta beside it (plain loads: a 1-D bulk copy needs 16-byte aligned rows, which a
//     ragged S_q does not give). Consumers wait on mbarriers; no block-wide barrier in the
//     loop; setmaxnreg moves registers from the producer to the consumers;
//   * two consumer warpgroups, 64 resident rows each. dk/dv: S^T = K Q^T and dP^T = V dO^T
//     with both operands in shared memory (K-major), so the accumulators are already keys x
//     queries; P^T and dS^T are formed in registers and re-packed to bf16 as the register A
//     operand of dV += P^T dO and dK += dS^T Q, with dO and Q read as transposed (MN-major)
//     B operands: the same swizzled Q and dO tiles serve both products, as the forward reads
//     its K tile K-major and its V tile MN-major. dq: S = Q K^T and dP = dO V^T from shared
//     memory, dS in registers, dQ += dS K with K as the MN-major B operand; lse and delta of
//     the thread's two rows stay in registers;
//   * in a warpgroup the exp2 and dS arithmetic of tile i+1 runs while tile i's
//     accumulating products are in flight, and the other warpgroup's products fill the
//     tensor cores meanwhile (at D=128 dk/dv's two D-wide accumulators leave no registers
//     for that: its products and its arithmetic take turns);
//   * tiles by D padded to 64 or 128 (BwdPlan): dq streams 128-key tiles at D <= 64 and
//     64-key tiles above; dk/dv streams 64-query tiles. Above D = 128 (the VAE mid block's
//     512) flash_bwd_wide_kernel below: 64 resident rows, the score work split between the
//     two consumer warpgroups;
//   * masks, not only zero fill: a zero key row would give p = exp2(0 - lse) != 0. Keys past
//     S_k get P = 0 in dq (the last tile is peeled, so the loop's body has no branch on the
//     tile's number); queries past S_q get lse = +inf in dk/dv, so P = exp2(s - inf) = 0 and
//     dS = 0 exactly; rows past the end and columns past D are not written. D < 64 arrives
//     zero-padded from the hardware.

#include <math.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using namespace lkgd;
using namespace lkgd::sm90;

constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kRows = 128;       // resident rows a block: 64 a consumer warpgroup

struct BwdArgs {
  const float* lse;    // (B*H, s_q) log2 domain
  const float* delta;  // (B*H, s_q)
  bf16* out0;          // dq, or dk
  bf16* out1;          // dv (dk/dv kernel)
  Strides os0, os1;
  int heads, s_q, s_k, d, n_tiles;  // n_tiles: blocks along the block's own rows per (b, h)
  int n_slices;      // blocks along the output's columns (the wide kernels; else 1)
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 * log2(e), as the forward that wrote lse used it
};

// Tiling by D padded to DP (64 or 128), for the dq (DKV=false) and dk/dv kernels.
template <int DP, bool DKV>
struct BwdPlan {
  static constexpr int NP = DP / kPanelCols;                // panels of a tile
  static constexpr int ST = (DKV || DP > 64) ? 64 : 128;    // rows of a streamed tile
  static constexpr int NS = (DKV && DP > 64) ? 4 : 6;       // ring slots
  static constexpr int res_bytes = kRows * DP * 2;          // one resident tile
  static constexpr int tile_bytes = ST * DP * 2;            // one streamed tile
  static constexpr int slot_bytes = (DKV ? 2 : 1) * tile_bytes;  // dk/dv: Q and dO tiles
  static constexpr int row_bytes = DKV ? NS * 2 * ST * 4 : 0;    // dk/dv: lse and delta
  static constexpr int bar_bytes = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the tiles start at the next multiple of the swizzle atom
  static constexpr int smem_bytes = kAtomBytes + 2 * res_bytes + NS * slot_bytes + row_bytes +
                                    bar_bytes;
};

// Store rows r0 + g and r0 + g + 8 of a warp's m64nDP accumulator times `mul` as bf16,
// columns < d and rows < s_total only.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int r0, int s_total,
                                           int d, const float (&acc)[DP / 2], float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s_total) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d)
        *reinterpret_cast<uint32_t*>(base + (long long)row * row_stride + col) =
            pack_bf16(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const BwdArgs a) {
  using P = BwdPlan<DP, false>;
  constexpr int BK = P::ST, NP = P::NP, NS = P::NS;
  constexpr int SR = BK / 2;  // score registers a thread (64 x BK over 128 threads)
  constexpr int QR = DP / 2;  // dq registers a thread

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sdO = sQ + P::res_bytes;
  const uint32_t ring = sdO + P::res_bytes;
  const uint32_t res_full = ring + NS * P::slot_bytes;
  const uint32_t full0 = res_full + 8, empty0 = full0 + 8 * NS;

  const int bh = blockIdx.x / a.n_tiles;
  const int q0 = (blockIdx.x % a.n_tiles) * kRows;
  const int b = bh / a.heads, h = bh % a.heads;
  const int n_tiles = (a.s_k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrive with the byte count
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warpgroup
    reg_dealloc<40>();  // 2 x 128 x 232 + 128 x 40 registers: the SM's 64 K
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(res_full, 2 * P::res_bytes);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(sQ + p * kRows * kPanelRowBytes, &map_q, res_full, p * kPanelCols, q0, h, b);
        tma_load_4d(sdO + p * kRows * kPanelRowBytes, &map_do, res_full, p * kPanelCols, q0, h, b);
      }
      // the ring's order is the order the consumers want tiles in: K0, V0, K1, V1, ...
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int slot = i % NS, use = i / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * slot, dst = ring + slot * P::slot_bytes;
        mbar_arrive_expect_tx(bar, P::tile_bytes);
        const CUtensorMap* map = (i & 1) ? &map_v : &map_k;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load_4d(dst + p * BK * kPanelRowBytes, map, bar, p * kPanelCols, (i >> 1) * BK, h, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_in_tile = wg * 64 + warp * 16 + g;  // this thread's rows: this and + 8

    // lse and delta of this thread's two rows; rows past S_q (never stored) get P = 0
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_in_tile + 8 * r;
      const bool ok = row < a.s_q;
      lse_r[r] = ok ? a.lse[(long long)bh * a.s_q + row] : INFINITY;
      delta_r[r] = ok ? a.delta[(long long)bh * a.s_q + row] : 0.f;
    }
    float s[SR], dp[SR], dq[QR];
    uint32_t pk[SR / 2];
#pragma unroll
    for (int i = 0; i < QR; ++i) dq[i] = 0.f;

    mbar_wait(res_full, 0);
    const uint64_t q_desc = smem_desc(sQ + wg * 64 * kPanelRowBytes, 16, kAtomBytes);
    const uint64_t do_desc = smem_desc(sdO + wg * 64 * kPanelRowBytes, 16, kAtomBytes);
    auto slot_addr = [&](int i) { return ring + (i % NS) * P::slot_bytes; };
    auto release = [&](int i) {  // ring tile i is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % NS));
    };

    // s = Q . K_j^T and dp = dO . V_j^T over the depth DP: four 16-deep steps a panel
    auto start_sdp = [&](int j) {
      mbar_wait(full0 + 8 * ((2 * j) % NS), ((2 * j) / NS) & 1);
      mbar_wait(full0 + 8 * ((2 * j + 1) % NS), ((2 * j + 1) / NS) & 1);
      const uint64_t k_desc = smem_desc(slot_addr(2 * j), 16, kAtomBytes);
      const uint64_t v_desc = smem_desc(slot_addr(2 * j + 1), 16, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, desc_advance(q_desc, p * kRows * kPanelRowBytes + kk * 32),
                   desc_advance(k_desc, p * BK * kPanelRowBytes + kk * 32), (p | kk) != 0);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(dp, desc_advance(do_desc, p * kRows * kPanelRowBytes + kk * 32),
                   desc_advance(v_desc, p * BK * kPanelRowBytes + kk * 32), (p | kk) != 0);
      wgmma_commit();
    };
    // dq += dS . K_j over the BK keys, 16 keys (two swizzle atoms of K rows) a step, K_j as
    // the transposed (MN-major) B operand
    auto start_dq = [&](int j) {
      const uint64_t k_desc = smem_desc(slot_addr(2 * j), BK * kPanelRowBytes, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs(dq, pk + 4 * kc, desc_advance(k_desc, kc * 16 * kPanelRowBytes));
      wgmma_commit();
    };

    start_sdp(0);
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    release(1);  // V0

    // One key tile; `last` (a std::bool_constant) marks the tile that may be ragged and has
    // no successor: the loop's body has no branch on the tile's number.
    auto tile = [&](int j, auto last) {
      constexpr bool LAST = decltype(last)::value;
      // 1. dS of tile j in place, exp2 domain, while dq += dS . K of tile j-1 runs
      const int k0 = j * BK;
      if (LAST && k0 + BK > a.s_k) {
#pragma unroll
        for (int i = 0; i < SR; ++i)
          if (k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k) s[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], a.scale_log2, -lse_r[r])) * (dp[i] - delta_r[r]);
      }
      // 2. the product of tile j-1 is done: its K tile and the packed dS are free again
      wgmma_wait<0>();
      reg_fence(dq);
      if (j > 0) release(2 * (j - 1));
#pragma unroll
      for (int i = 0; i < SR / 2; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      // 3. the next scores, then this tile's dS . K behind them
      if (!LAST) start_sdp(j + 1);
      start_dq(j);
      // 4. the next scores are done (dS . K may still run): their V tile is free
      if (!LAST) {
        wgmma_wait<1>();
        reg_fence(s);
        reg_fence(dp);
        release(2 * (j + 1) + 1);
      }
    };
    for (int j = 0; j + 1 < n_tiles; ++j) tile(j, std::false_type{});
    tile(n_tiles - 1, std::true_type{});
    wgmma_wait<0>();
    reg_fence(dq);

    store_rows<DP>(a.out0 + b * a.os0.b + h * a.os0.h, a.os0.s, q0 + row_in_tile, a.s_q, a.d, dq,
                   a.scale, t4);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const BwdArgs a) {
  using P = BwdPlan<DP, true>;
  constexpr int BQ = P::ST, NP = P::NP, NS = P::NS;
  constexpr int SR = BQ / 2;  // score registers a thread (64 keys x BQ queries over 128 threads)
  constexpr int KR = DP / 2;  // dk and dv registers a thread, each
  // registers for a tile in flight beside the two accumulators: at D=64 only
  constexpr bool OVERLAP = DP == 64;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sV = sK + P::res_bytes;
  const uint32_t ring = sV + P::res_bytes;  // slot: the Q tile, then the dO tile
  const uint32_t rows = ring + NS * P::slot_bytes;
  const uint32_t res_full = rows + P::row_bytes;
  const uint32_t full0 = res_full + 8, empty0 = full0 + 8 * NS;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (rows - raw));  // (NS, BQ)
  float* delta_s = lse_s + NS * BQ;                                   // (NS, BQ)

  const int bh = blockIdx.x / a.n_tiles;
  const int k0 = (blockIdx.x % a.n_tiles) * kRows;
  const int b = bh / a.heads, h = bh % a.heads;
  const int n_tiles = (a.s_q + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrive with the byte count
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x < kConsumers + 32) {  // its first warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(res_full, 2 * P::res_bytes);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sK + p * kRows * kPanelRowBytes, &map_k, res_full, p * kPanelCols, k0, h, b);
          tma_load_4d(sV + p * kRows * kPanelRowBytes, &map_v, res_full, p * kPanelCols, k0, h, b);
        }
      }
      const float* lse = a.lse + (long long)bh * a.s_q;
      const float* delta = a.delta + (long long)bh * a.s_q;
      for (int i = 0; i < n_tiles; ++i) {
        const int slot = i % NS, use = i / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        // the tile's lse and delta beside it; queries past S_q get lse = +inf: P = 0, dS = 0
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const int row = i * BQ + r;
          const bool ok = row < a.s_q;
          lse_s[slot * BQ + r] = ok ? lse[row] : INFINITY;
          delta_s[slot * BQ + r] = ok ? delta[row] : 0.f;
        }
        __threadfence_block();
        __syncwarp();  // the warp's stores before lane 0's arrive (release) on the full barrier
        if (lane == 0) {
          const uint32_t bar = full0 + 8 * slot, dst = ring + slot * P::slot_bytes;
          mbar_arrive_expect_tx(bar, P::slot_bytes);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            tma_load_4d(dst + p * BQ * kPanelRowBytes, &map_q, bar, p * kPanelCols, i * BQ, h, b);
            tma_load_4d(dst + P::tile_bytes + p * BQ * kPanelRowBytes, &map_do, bar,
                        p * kPanelCols, i * BQ, h, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_in_tile = wg * 64 + warp * 16 + g;  // this thread's keys: this and + 8

    float s[SR], dp[SR], dk[KR], dv[KR];
    uint32_t pp[SR / 2], pd[SR / 2];  // P^T and dS^T as bf16 A operands
#pragma unroll
    for (int i = 0; i < KR; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(res_full, 0);
    const uint64_t k_desc = smem_desc(sK + wg * 64 * kPanelRowBytes, 16, kAtomBytes);
    const uint64_t v_desc = smem_desc(sV + wg * 64 * kPanelRowBytes, 16, kAtomBytes);
    auto slot_addr = [&](int i) { return ring + (i % NS) * P::slot_bytes; };
    auto release = [&](int i) {  // ring slot of tile i is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % NS));
    };

    // s = K . Q_i^T and dp = V . dO_i^T (keys x queries) over the depth DP
    auto start_sdp = [&](int i) {
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      const uint64_t q_desc = smem_desc(slot_addr(i), 16, kAtomBytes);
      const uint64_t do_desc = smem_desc(slot_addr(i) + P::tile_bytes, 16, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, desc_advance(k_desc, p * kRows * kPanelRowBytes + kk * 32),
                   desc_advance(q_desc, p * BQ * kPanelRowBytes + kk * 32), (p | kk) != 0);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(dp, desc_advance(v_desc, p * kRows * kPanelRowBytes + kk * 32),
                   desc_advance(do_desc, p * BQ * kPanelRowBytes + kk * 32), (p | kk) != 0);
      wgmma_commit();
    };
    // dv += P^T . dO_i and dk += dS^T . Q_i over the BQ queries, 16 a step, dO_i and Q_i as
    // transposed (MN-major) B operands
    auto start_dkv = [&](int i) {
      const uint64_t q_mn = smem_desc(slot_addr(i), BQ * kPanelRowBytes, kAtomBytes);
      const uint64_t do_mn = smem_desc(slot_addr(i) + P::tile_bytes, BQ * kPanelRowBytes,
                                       kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dv, pp + 4 * kc, desc_advance(do_mn, kc * 16 * kPanelRowBytes));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dk, pd + 4 * kc, desc_advance(q_mn, kc * 16 * kPanelRowBytes));
      wgmma_commit();
    };
    // P^T and dS^T of tile i in place: element 4 n + e is query column 8 n + 2 t4 + (e & 1)
    auto probs = [&](int i) {
      const float* l = lse_s + (i % NS) * BQ + 2 * t4;
      const float* dl = delta_s + (i % NS) * BQ + 2 * t4;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 lv = *reinterpret_cast<const float2*>(l + 8 * n);
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * n + e], a.scale_log2, -((e & 1) ? lv.y : lv.x)));
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - ((e & 1) ? dv2.y : dv2.x));
        }
      }
    };

    if (OVERLAP) {
      start_sdp(0);
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
    }
    // One query tile; `last` marks the tile with no successor (no branch on the tile's
    // number around the products)
    auto tile = [&](int i, auto last) {
      constexpr bool LAST = decltype(last)::value;
      if (!OVERLAP) {
        start_sdp(i);
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
      }
      // 1. P^T and dS^T of tile i, while the products of tile i-1 run
      probs(i);
      // 2. the products of tile i-1 are done: its slot and the packed operands are free
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      if (i > 0) release(i - 1);
#pragma unroll
      for (int j = 0; j < SR / 2; ++j) {
        pp[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
        pd[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
      }
      // 3. the next scores, then this tile's two accumulating products behind them
      if (OVERLAP && !LAST) start_sdp(i + 1);
      start_dkv(i);
      if (OVERLAP && !LAST) {
        wgmma_wait<1>();
        reg_fence(s);
        reg_fence(dp);
      }
    };
    for (int i = 0; i + 1 < n_tiles; ++i) tile(i, std::false_type{});
    tile(n_tiles - 1, std::true_type{});
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);

    store_rows<DP>(a.out0 + b * a.os0.b + h * a.os0.h, a.os0.s, k0 + row_in_tile, a.s_k, a.d, dk,
                   a.scale, t4);
    store_rows<DP>(a.out1 + b * a.os1.b + h * a.os1.h, a.os1.s, k0 + row_in_tile, a.s_k, a.d, dv,
                   1.f, t4);
  }
}

// ---------------------------------------------------------------------- 128 < D <= 512
// flash_bwd_wide_kernel<DP, DKV> (DP 256 or 512: the VAE mid block's single 512-wide head,
// and any D % 8 == 0 up to 512), kernels 9 (DKV=false) and 10 in one template. At these widths
// a 64-row m64nD fp32 output is D/2 registers a thread: the two outputs of dk/dv cannot both
// live in one warpgroup, nor dq's 512 columns, and one 128-row resident bf16 tile is 128 KB at
// D = 512. So a block keeps 64 resident rows and gives its two consumer warpgroups two roles
// that share one score tile through shared memory, no product computed twice:
//   * dq: warpgroup 0 forms S = Q K^T and P, warpgroup 1 dP = dO V^T and, from P, dS; each
//     accumulates dQ += dS K over half of dQ's columns (D/2 each: 128 registers at D = 512);
//   * dk/dv: warpgroup 0 forms S^T = K Q^T and P^T and accumulates dV += P^T dO, warpgroup 1
//     forms dP^T = V dO^T and, from P^T, dS^T, and accumulates dK += dS^T Q; each keeps up to
//     256 output columns (128 registers), so at D = 512 the grid has two column slices and a
//     slice's block recomputes S^T and dP^T: 6 products where one block would do 4 (1.5x).
// P (then dS, in place) crosses in a 16 KB buffer laid out [register][thread]: both
// warpgroups hold a 64 x 64 tile in the same accumulator layout, so a thread reads what the
// same thread of the other warpgroup wrote, with no conflict. Two named barriers order it:
// the writer arrives (bar.arrive), the reader waits (bar.sync).
// Each warpgroup has its own producer warp, ring and barriers: its 64 rows of the score's A
// operand (Q or dO for dq, K or V for dk/dv; resident at D = 256, streamed beside B at 512:
// WidePlan::RES), then for each 64-row streamed tile the score operand's 128-column units (K
// or V; Q or dO) and the units of the accumulating product's B operand (K's columns for dq;
// dO's or Q's for dk/dv, read MN-major). A unit is 64 rows x 128 bf16 (two panels, 16 KB): K is
// loaded once for S and again for dQ (2.5 D key columns a tile where 2 D would do). Inside a
// warpgroup the score, the exchange and the accumulating product take turns: the other
// warpgroup fills the tensor cores meanwhile. Masks as above: keys past S_k get
// P = 0 (dq), queries past S_q lse = +inf and delta = 0 (dk/dv), nothing past D or past the
// rows is written; D not a multiple of 128 arrives zero-padded from the hardware.
constexpr int kWRows = 64;                           // resident rows a block
constexpr int kWUnitCols = 2 * kPanelCols;           // bf16 columns of a unit
constexpr int kWPanelBytes = 64 * kPanelRowBytes;    // a 64-row panel: 8 KB
constexpr int kWUnitBytes = 2 * kWPanelBytes;        // a unit: 16 KB
constexpr int kXBytes = 32 * 128 * 4;                // the exchange: 32 fp32 a thread
constexpr int kSmemLimit = 232448;                   // dynamic shared memory a block may use

template <int DP, bool DKV>
struct WidePlan {
  // the score's A operand resident where that leaves a ring of four units (D = 256); at
  // D = 512 it would leave two, and A streams with B through a ring of six: in turns on one
  // H100 (experiments/flash_bwd_ab.py, two builds of this constant) the pair at (8,4096,1,512)
  // took 3.05-3.07 ms streamed against 3.60-3.61 resident, at (8,4096,2,256) 2.21-2.33
  // streamed against 2.07 resident
  static constexpr bool RES = DP < 512;
  static constexpr int ND = DP / kWUnitCols;                        // depth units of a row
  static constexpr int N = DKV ? (DP < 256 ? DP : 256) : DP / 2;    // output columns a warpgroup
  static constexpr int NC = N / kWUnitCols;                         // its units a tile
  static constexpr int W = DKV ? N : 2 * N;                         // output columns a block
  static constexpr int res_bytes = RES ? ND * kWUnitBytes : 0;      // 64 resident rows
  // a warpgroup's ring: its half of what is left after 1024 bytes of alignment slack, the
  // exchange and 512 for barriers
  static constexpr int NS = ((kSmemLimit - kAtomBytes - kXBytes - 512) / 2 - res_bytes) /
                            kWUnitBytes;
  static constexpr int wg_bytes = res_bytes + NS * kWUnitBytes;
  static constexpr int bar_bytes = 2 * 8 * (1 + 2 * NS);  // a warpgroup: resident, full, empty
  static constexpr int smem_bytes = kAtomBytes + 2 * wg_bytes + kXBytes + bar_bytes;
};

template <int DP, bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const BwdArgs a) {
  using P = WidePlan<DP, DKV>;
  constexpr int ND = P::ND, NC = P::NC, NS = P::NS;
  constexpr bool RES = P::RES;
  constexpr int UA = RES ? 1 : 2;  // ring units a depth unit of the scores: (A,) B
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t xch = base + 2 * P::wg_bytes;
  const uint32_t bars = xch + kXBytes;
  float* xf = reinterpret_cast<float*>(smem_raw + (xch - raw));
  uint32_t* xu = reinterpret_cast<uint32_t*>(xf);

  const int slice = blockIdx.x % a.n_slices;  // column slices innermost: they share rows
  const int rest = blockIdx.x / a.n_slices;
  const int bh = rest / a.n_tiles;
  const int r0 = (rest % a.n_tiles) * kWRows;
  const int b = bh / a.heads, h = bh % a.heads;
  const int n_tiles = ((DKV ? a.s_q : a.s_k) + 63) / 64;  // streamed 64-row tiles

  // this warpgroup's (consumer or producer) role, pipeline and first output column
  const int w = threadIdx.x < kConsumers ? threadIdx.x / 128 : (threadIdx.x - kConsumers) / 32;
  const uint32_t region = base + (w & 1) * P::wg_bytes, ring = region + P::res_bytes;
  const uint32_t res_full = bars + (w & 1) * 8 * (1 + 2 * NS);
  const uint32_t full0 = res_full + 8, empty0 = full0 + 8 * NS;
  const int cc = slice * P::W + (DKV ? 0 : w * P::N);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * (1 + 2 * NS); ++i)
      // resident and full barriers: the producer's arrive with the byte count; empty: lane 0
      // of each of the warpgroup's four warps
      mbar_init(bars + 8 * i, (i % (1 + 2 * NS)) > NS ? 4 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warps 0 and 1
    reg_dealloc<24>();
    if (w < 2 && threadIdx.x % 32 == 0) {
      // dq: warpgroup 0 Q, K, K; 1 dO, V, K. dk/dv: 0 K, Q, dO; 1 V, dO, Q
      const CUtensorMap* ma = DKV ? (w ? &map_v : &map_k) : (w ? &map_do : &map_q);
      const CUtensorMap* mb = DKV ? (w ? &map_do : &map_q) : (w ? &map_v : &map_k);
      const CUtensorMap* mc = DKV ? (w ? &map_q : &map_do) : &map_k;
      if (RES) {
        mbar_arrive_expect_tx(res_full, P::res_bytes);
        for (int p = 0; p < 2 * ND; ++p)
          tma_load_4d(region + p * kWPanelBytes, ma, res_full, p * kPanelCols, r0, h, b);
      }
      int x = 0;
      auto unit = [&](const CUtensorMap* m, int col, int row) {
        const int slot = x % NS, use = x / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * slot, dst = ring + slot * kWUnitBytes;
        mbar_arrive_expect_tx(bar, kWUnitBytes);
        tma_load_4d(dst, m, bar, col, row, h, b);
        tma_load_4d(dst + kWPanelBytes, m, bar, col + kPanelCols, row, h, b);
        ++x;
      };
      for (int t = 0; t < n_tiles; ++t) {
        for (int p = 0; p < ND; ++p) {
          if (!RES) unit(ma, p * kWUnitCols, r0);
          unit(mb, p * kWUnitCols, t * 64);
        }
        for (int c = 0; c < NC; ++c) unit(mc, cc + c * kWUnitCols, t * 64);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, t4 = lane & 3;
    const int row_in_tile = ((threadIdx.x / 32) % 4) * 16 + (lane >> 2);  // and + 8

    float o[NC][64];  // output columns cc .. cc + N, a 128-column unit each
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[c][i] = 0.f;
    // dq: lse and delta of this thread's two rows; rows past S_q (never stored) get P = 0
    float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if (!DKV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + row_in_tile + 8 * r;
        const bool ok = row < a.s_q;
        lse_r[r] = ok ? a.lse[(long long)bh * a.s_q + row] : INFINITY;
        delta_r[r] = ok ? a.delta[(long long)bh * a.s_q + row] : 0.f;
      }
    }
    float s[32];
    uint32_t pk[16];
    auto wait = [&](int i) { mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1); };
    auto at = [&](int i) { return ring + (i % NS) * kWUnitBytes; };
    auto release = [&](int i) {  // ring unit i is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % NS));
    };
    if (RES) mbar_wait(res_full, 0);

    int x = 0;  // this tile's first ring unit
    for (int t = 0; t < n_tiles; ++t) {
      // dk/dv: lse (warpgroup 0) or delta (1) of this thread's query columns, loaded while
      // the scores run; queries past S_q: lse = +inf, delta = 0
      float col_v[16];
      if (DKV) {
        const float* src = (w ? a.delta : a.lse) + (long long)bh * a.s_q;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = t * 64 + 8 * n + 2 * t4 + e;
            col_v[2 * n + e] = col < a.s_q ? src[col] : (w ? 0.f : INFINITY);
          }
      }
      // 1. the scores over the depth, a commit group a unit, each unit released once its
      // group is done: S or dP (dq), S^T or dP^T (dk/dv), 64 x 64
      auto release_unit = [&](int p) {  // the ring units of depth unit p
#pragma unroll
        for (int u = 0; u < UA; ++u) release(x + UA * p + u);
      };
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < ND; ++p) {
#pragma unroll
        for (int u = 0; u < UA; ++u) wait(x + UA * p + u);
        const uint64_t a_desc =
            smem_desc(RES ? region + 2 * p * kWPanelBytes : at(x + UA * p), 16, kAtomBytes);
        const uint64_t b_desc = smem_desc(at(x + UA * p + UA - 1), 16, kAtomBytes);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s, desc_advance(a_desc, q * kWPanelBytes + kk * 32),
                     desc_advance(b_desc, q * kWPanelBytes + kk * 32), (p | q | kk) != 0);
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          release_unit(p - 1);
        }
      }
      wgmma_wait<0>();
      reg_fence(s);
      release_unit(ND - 1);
      x += UA * ND;

      // 2. P and dS through the exchange, then this warpgroup's A operand, packed to bf16
      if (!DKV) {
        if (w == 0) {
          const int k0 = t * 64;
          if (k0 + 64 > a.s_k) {  // keys past S_k: P = 0
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k) s[i] = -INFINITY;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i)
            xf[i * 128 + tid] = ex2(fmaf(s[i], a.scale_log2, -lse_r[(i >> 1) & 1]));
          named_barrier_arrive(1, kConsumers);
          named_barrier_sync(2, kConsumers);  // dS is there, packed
#pragma unroll
          for (int j = 0; j < 16; ++j) pk[j] = xu[j * 128 + tid];
        } else {
          named_barrier_sync(1, kConsumers);  // P is there
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = xf[i * 128 + tid] * (s[i] - delta_r[(i >> 1) & 1]);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            pk[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
            xu[j * 128 + tid] = pk[j];  // over this thread's own P, read above
          }
          named_barrier_arrive(2, kConsumers);
        }
      } else {
        if (w == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = ex2(fmaf(s[i], a.scale_log2, -col_v[2 * (i >> 2) + (i & 1)]));
          if (t > 0) named_barrier_sync(2, kConsumers);  // the last tile's P^T is read
#pragma unroll
          for (int i = 0; i < 32; ++i) xf[i * 128 + tid] = s[i];
          named_barrier_arrive(1, kConsumers);
        } else {
          named_barrier_sync(1, kConsumers);  // P^T is there
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = xf[i * 128 + tid] * (s[i] - col_v[2 * (i >> 2) + (i & 1)]);
          if (t + 1 < n_tiles) named_barrier_arrive(2, kConsumers);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) pk[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      }

      // 3. the accumulating product over the tile's 64 rows, 16 a step, B read MN-major
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wait(x + c);
        const uint64_t c_desc = smem_desc(at(x + c), kWPanelBytes, kAtomBytes);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_rs(o[c], pk + 4 * kc, desc_advance(c_desc, kc * 16 * kPanelRowBytes));
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(x + c - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) reg_fence(o[c]);
      release(x + NC - 1);
      x += NC;
    }

    // dq, or dv (warpgroup 0) and dk (1)
    bf16* out = DKV ? (w ? a.out0 : a.out1) : a.out0;
    const Strides& os = DKV && !w ? a.os1 : a.os0;
    const float mul = DKV && !w ? 1.f : a.scale;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cc + c * kWUnitCols;
      store_rows<kWUnitCols>(out + b * os.b + h * os.h + col, os.s, r0 + row_in_tile,
                             DKV ? a.s_k : a.s_q, a.d - col, o[c], mul, t4);
    }
  }
}

// ---------------------------------------------------------------------- host side
struct BwdViews {
  const void *q, *k, *v, *dout;
  Strides qs, ks, vs, dos;
  int batch;
};

template <int DP, bool DKV>
cudaError_t launch(const BwdViews& in, BwdArgs a, cudaStream_t stream) {
  constexpr bool WIDE = DP > 128;
  // the block's own rows are resident (kRows; kWRows wide), the other side's are streamed
  // (BwdPlan::ST; 64 wide)
  int rows, streamed, smem;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, BwdArgs);
  if constexpr (WIDE) {
    using P = WidePlan<DP, DKV>;
    rows = kWRows, streamed = 64, smem = P::smem_bytes;
    kernel = flash_bwd_wide_kernel<DP, DKV>;
    a.n_slices = (a.d + P::W - 1) / P::W;
  } else {
    using P = BwdPlan<DP, DKV>;
    rows = kRows, streamed = P::ST, smem = P::smem_bytes;
    kernel = DKV ? flash_bwd_dkv_kernel<DP> : flash_bwd_dq_kernel<DP>;
    a.n_slices = 1;
  }
  a.n_tiles = ((DKV ? a.s_k : a.s_q) + rows - 1) / rows;
  const int q_rows = DKV ? streamed : rows, k_rows = DKV ? rows : streamed;
  CUtensorMap map_q, map_do, map_k, map_v;
  cudaError_t err = make_map(&map_q, in.q, in.qs, in.batch, a.s_q, a.heads, a.d, q_rows);
  if (err == cudaSuccess)
    err = make_map(&map_do, in.dout, in.dos, in.batch, a.s_q, a.heads, a.d, q_rows);
  if (err == cudaSuccess)
    err = make_map(&map_k, in.k, in.ks, in.batch, a.s_k, a.heads, a.d, k_rows);
  if (err == cudaSuccess)
    err = make_map(&map_v, in.v, in.vs, in.batch, a.s_k, a.heads, a.d, k_rows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)in.batch * a.heads * a.n_tiles * a.n_slices;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(map_q, map_do, map_k, map_v, a);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch(const BwdViews& in, const BwdArgs& a, cudaStream_t s) {
  if (a.d <= 64) return launch<64, DKV>(in, a, s);
  if (a.d <= 128) return launch<128, DKV>(in, a, s);
  if (a.d <= 256) return launch<256, DKV>(in, a, s);
  return launch<512, DKV>(in, a, s);
}

}  // namespace

extern "C" {

// Rows a block of the dq (dkv=0) or dk/dv (dkv=1) kernel keeps resident: query rows for dq,
// keys for dk/dv; 64 in the wide kernels (D > 128).
int lkgd_flash_bwd_block_rows(int d, int dkv) {
  (void)dkv;
  return d <= 128 ? kRows : kWRows;
}

// Dynamic shared memory of the dq (dkv=0) or dk/dv (dkv=1) block for a head dim d.
int lkgd_flash_bwd_smem_bytes(int d, int dkv) {
  if (d <= 64) return dkv ? BwdPlan<64, true>::smem_bytes : BwdPlan<64, false>::smem_bytes;
  if (d <= 128) return dkv ? BwdPlan<128, true>::smem_bytes : BwdPlan<128, false>::smem_bytes;
  if (d <= 256) return dkv ? WidePlan<256, true>::smem_bytes : WidePlan<256, false>::smem_bytes;
  return dkv ? WidePlan<512, true>::smem_bytes : WidePlan<512, false>::smem_bytes;
}

// Column slices of the grid (the wide kernels' output columns a block: dk/dv above D = 256)
// and the ring's slots for a head dim d.
int lkgd_flash_bwd_slices(int d, int dkv) {
  if (d <= 128) return 1;
  const int w = d <= 256 ? (dkv ? WidePlan<256, true>::W : WidePlan<256, false>::W)
                         : (dkv ? WidePlan<512, true>::W : WidePlan<512, false>::W);
  return (d + w - 1) / w;
}

int lkgd_flash_bwd_stages(int d, int dkv) {
  if (d <= 64) return dkv ? BwdPlan<64, true>::NS : BwdPlan<64, false>::NS;
  if (d <= 128) return dkv ? BwdPlan<128, true>::NS : BwdPlan<128, false>::NS;
  if (d <= 256) return dkv ? WidePlan<256, true>::NS : WidePlan<256, false>::NS;
  return dkv ? WidePlan<512, true>::NS : WidePlan<512, false>::NS;
}

// q, k, v, dout, dq, dk, dv: (B, S, H, D) bf16, strides[21] = (b, s, h) element strides of
// q, k, v, dout, dq, dk, dv. lse, delta: (B*H, s_q) fp32. dkv=0 launches the dq kernel
// (writes dq), dkv=1 the dk/dv kernel (writes dk and dv). D must be a multiple of 8, <= 512;
// s_q and s_k at least 1.
int lkgd_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const long long* strides, int batch, int heads, int s_q, int s_k, int d,
                   float scale, float scale_log2, int dkv, int device, void* stream) {
  if (d <= 0 || d > 512 || d % 8 != 0 || s_q <= 0 || s_k <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  BwdViews in;
  in.q = q;
  in.k = k;
  in.v = v;
  in.dout = dout;
  Strides* views[4] = {&in.qs, &in.ks, &in.vs, &in.dos};
  for (int i = 0; i < 4; ++i) *views[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  in.batch = batch;
  BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  const int out0 = dkv ? 5 : 4;  // dk (then dv) or dq among the seven stride triples
  a.out0 = static_cast<bf16*>(dkv ? dk : dq);
  a.out1 = static_cast<bf16*>(dkv ? dv : nullptr);
  a.os0 = {strides[3 * out0], strides[3 * out0 + 1], strides[3 * out0 + 2]};
  a.os1 = {strides[18], strides[19], strides[20]};
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_tiles = a.n_slices = 0;  // set by the launch from its plan
  a.scale = scale;
  a.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dkv ? dispatch<true>(in, a, s) : dispatch<false>(in, a, s));
}

}  // extern "C"
