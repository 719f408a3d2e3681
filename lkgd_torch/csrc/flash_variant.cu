// Variants of the bound-softmax flash-attention forward for Hopper (sm_90a), for A/B
// measurements of the levers inside the kernel: bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel _variant_kernel (driven by run_variant) of
// experiments/flash_variant_microbench.py. Given q, k, v (B*H, S, D) and the per-row bound
// t (B*H, S_q) in the log2 domain, each variant computes
//     p = exp2(scale*log2e * q.k + t),  out = (p . v) / rowsum(p)
// with no running max, no fallback and no logsumexp output:
//   * base              the bound form's arithmetic with nothing around it: the production
//                       forward's loop (flash_attention_wgmma.cu) with t given;
//   * prescale          q arrives pre-multiplied by scale*log2e, the multiply is dropped;
//   * bf16exp           the scores are rounded to bf16 pairs and exponentiated two at a time
//                       with ex2.approx.ftz.bf16x2; the packed result is the P.V operand as
//                       it is, and the row sum is still taken in fp32. These exp2s run after
//                       the previous P.V is done, not beside it (see the loop);
//   * prescale_bf16exp  both;
//   * noexp             exp2 replaced by the identity: the floor of the tensor-core work and
//                       the bookkeeping (not a softmax; a measurement only).
// Query x key tiles are template parameters: 64x64, 128x64, 64x128 and 128x128 (the
// production forward's tiling at D=64).
//
// What bounds it on the H100: tensor-core operations, 4*S^2*D*B*H (3.04 TFLOP at (140, 9216,
// 64), 3.08 ms at the bf16 peak) against 33 MB of inputs, and the exp2 unit beside them (one
// exp2 for 256 tensor-core operations at D=64). The design is the production forward's,
// built from the same pieces (flash_wgmma.cuh), so that a lever measured here is a lever of
// the kernel that runs:
//   * one block per (batch*head, query tile). A producer warp keeps a ring of six K and V
//     tiles in flight by TMA (rank-4 tensor maps over the (B*H, S, D) views' strides, the
//     128-byte swizzle); rows past S and columns past D arrive as zeros;
//   * one consumer warpgroup per 64 query rows (one or two): Q.K^T as wgmma m64nBKk16 from
//     shared memory, P.V with P re-packed from the score accumulator as the register A
//     operand and V as the MN-major B operand; in a warpgroup the exp2 of tile j+1 runs while
//     P.V of tile j is in flight. With two warpgroups setmaxnreg moves registers from the
//     producer to them; one warpgroup has no partner to fill the tensor cores during its
//     exp2, which is what the 64-row tiles measure;
//   * t is read per row from its (B*H, S_q) input; keys past S_k are masked in the peeled
//     last tile (-inf before exp2, 0 in noexp).

#include <math.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using namespace lkgd;
using namespace lkgd::sm90;

constexpr int kPrescale = 1, kBf16Exp = 2, kNoExp = 4;  // bits of a mode

struct VariantArgs {
  bf16* o;
  long long ob, os;  // batch and row strides of the output in elements
  const float* t;    // (B*H, s_q)
  int s_q, s_k, d, n_q_tiles;
  float scale_log2;
};

// Tiling of a BQ x BK query x key tile at D <= 64 (one 64-column panel).
template <int BQ, int BK>
struct VariantPlan {
  static constexpr int NWG = BQ / 64;                   // consumer warpgroups
  static constexpr int threads = (NWG + 1) * 128;       // and the producer warpgroup
  static constexpr int NS = 6;                          // ring slots (K and V tiles)
  static constexpr int q_bytes = BQ * kPanelRowBytes;
  static constexpr int slot_bytes = BK * kPanelRowBytes;
  static constexpr int bar_bytes = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the tiles start at the next multiple of the swizzle atom
  static constexpr int smem_bytes = kAtomBytes + q_bytes + NS * slot_bytes + bar_bytes;
};

// exp2 of two packed bf16 values
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16x2_sum(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xffff0000u);
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(VariantPlan<BQ, BK>::threads, 1)
    flash_variant_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const VariantArgs a) {
  using P = VariantPlan<BQ, BK>;
  constexpr int NS = P::NS;
  constexpr int consumers = P::NWG * 128;
  constexpr int SR = BK / 2;  // score registers a thread (64 x BK over 128 threads)
  constexpr int OR = 32;      // output registers a thread (64 x 64)
  constexpr bool PRESCALE = (MODE & kPrescale) != 0;
  constexpr bool BF16EXP = (MODE & kBf16Exp) != 0;
  constexpr bool NOEXP = (MODE & kNoExp) != 0;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sKV = sQ + P::q_bytes;
  const uint32_t q_full = sKV + NS * P::slot_bytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * NS;

  const int bh = blockIdx.x / a.n_q_tiles;
  const int q0 = (blockIdx.x % a.n_q_tiles) * BQ;
  const int n_tiles = (a.s_k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's arrive with the byte count
      mbar_init(empty0 + 8 * s, consumers / 32);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    // ------------------------------------------------------------ producer warpgroup
    if constexpr (P::NWG == 2) reg_dealloc<40>();  // 2 x 128 x 232 + 128 x 40: the SM's 64 K
    if (threadIdx.x == consumers) {
      mbar_arrive_expect_tx(q_full, P::q_bytes);
      tma_load_4d(sQ, &map_q, q_full, 0, q0, 0, bh);
      // the ring's order is the order the consumers want tiles in: K0, then K(j+1) and
      // V(j) in turn (the hole at 2 n_tiles - 1, where K(n_tiles) would be, stays empty)
      for (int i = 0; i <= 2 * n_tiles; ++i) {
        const bool is_v = i > 0 && !(i & 1);
        const int tile = is_v ? i / 2 - 1 : (i + 1) / 2;
        if (tile >= n_tiles) continue;
        const int slot = i % NS, use = i / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * slot;
        mbar_arrive_expect_tx(bar, P::slot_bytes);
        tma_load_4d(sKV + slot * P::slot_bytes, is_v ? &map_v : &map_k, bar, 0, tile * BK, 0, bh);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    if constexpr (P::NWG == 2) reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_in_tile = wg * 64 + warp * 16 + g;  // this thread's rows: this and + 8

    float t_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_in_tile + 8 * r;
      t_r[r] = row < a.s_q ? a.t[(long long)bh * a.s_q + row] : 0.f;
    }
    float s[SR], o[OR], l_r[2] = {0.f, 0.f};
    uint32_t pk[SR / 2];
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] = 0.f;

    mbar_wait(q_full, 0);
    const uint64_t q_desc = smem_desc(sQ + wg * 64 * kPanelRowBytes, 16, kAtomBytes);

    auto k_index = [](int j) { return j == 0 ? 0 : 2 * j - 1; };  // ring index of K(j)
    auto v_index = [](int j) { return 2 * j + 2; };               // and of V(j)
    // s = Q . K_j^T over the 64 columns: four 16-deep steps
    auto start_qk = [&](int j) {
      const int i = k_index(j);
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      const uint64_t k_desc = smem_desc(sKV + (i % NS) * P::slot_bytes, 16, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_advance(q_desc, kk * 32), desc_advance(k_desc, kk * 32), kk != 0);
      wgmma_commit();
    };
    // o += P . V_j over the BK keys, 16 keys (two swizzle atoms of V rows) a step
    auto start_pv = [&](int j) {
      const int i = v_index(j);
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      const uint64_t v_desc =
          smem_desc(sKV + (i % NS) * P::slot_bytes, BK * kPanelRowBytes, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs(o, pk + 4 * kc, desc_advance(v_desc, kc * 16 * kPanelRowBytes));
      wgmma_commit();
    };
    auto release = [&](int i) {  // ring tile i is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % NS));
    };

    start_qk(0);
    wgmma_wait<0>();
    reg_fence(s);
    release(0);

    // One key tile; `last` (a std::bool_constant) marks the tile that may be ragged and has
    // no successor: the loop's body has no branch on the tile's number.
    auto tile = [&](int j, auto last) {
      constexpr bool LAST = decltype(last)::value;
      // 1. numerators of tile j, exp2 domain, while P.V of tile j-1 runs; element i of the
      // scores is row (i >> 1) & 1, key 8 (i >> 2) + 2 t4 + (i & 1) of the tile
      const int k0 = j * BK;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float x = PRESCALE ? s[i] + t_r[(i >> 1) & 1]
                                 : fmaf(s[i], a.scale_log2, t_r[(i >> 1) & 1]);
        const bool masked = LAST && k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k;
        s[i] = masked ? (NOEXP ? 0.f : -INFINITY) : x;
      }
      if constexpr (!BF16EXP) {
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          if (!NOEXP) s[i] = ex2(s[i]);
          l_r[(i >> 1) & 1] += s[i];  // this thread's part; the row's 4 threads sum at the end
        }
      }

      // 2. P.V of tile j-1 is done: its V tile, the packed P and o are free again. The
      // packed exponentials are taken here, straight into pk: taken in step 1 (kept in s,
      // in registers of their own, or with pk held live to here) they measured wrong at 128
      // query rows on the H100, 6% faster; the cause is not known
      wgmma_wait<0>();
      reg_fence(o);
      if (j > 0) release(v_index(j - 1));
#pragma unroll
      for (int i = 0; i < SR / 2; ++i) {
        if constexpr (BF16EXP) {
          pk[i] = ex2_bf16x2(pack_bf16(s[2 * i], s[2 * i + 1]));
          l_r[i & 1] += bf16x2_sum(pk[i]);  // pair i is row i & 1
        } else {
          pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        }
      }

      // 3. the next scores, then this tile's P.V behind them
      if (!LAST) start_qk(j + 1);
      start_pv(j);

      // 4. the next scores are done (P.V may still run): their K tile is free
      if (!LAST) {
        wgmma_wait<1>();
        reg_fence(s);
        release(k_index(j + 1));
      }
    };
    for (int j = 0; j + 1 < n_tiles; ++j) tile(j, std::false_type{});
    tile(n_tiles - 1, std::true_type{});
    wgmma_wait<0>();
    reg_fence(o);

    // out = O / l through the output strides
    bf16* ob = a.o + bh * a.ob;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + row_in_tile + 8 * r;
      if (row >= a.s_q) continue;
      const float inv = 1.f / l;
#pragma unroll
      for (int n = 0; n < OR / 4; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < a.d)
          *reinterpret_cast<uint32_t*>(ob + (long long)row * a.os + col) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------- host side
struct VariantViews {
  const void *q, *k, *v;
  long long qb, qs, kb, ks, vb, vs;  // batch and row strides in elements
};

// A rank-4 map over a (B*H, S, D) view with unit D stride: (D, S, 1, B*H) innermost first,
// boxes of 64 columns x `rows` rows.
cudaError_t view_map(CUtensorMap* map, const void* base, long long b_stride, long long s_stride,
                     int bh, int s, int d, int rows) {
  return make_map(map, base, Strides{b_stride, s_stride, b_stride}, bh, s, 1, d, rows);
}

template <int BQ, int BK, int MODE>
cudaError_t launch(const VariantViews& in, VariantArgs a, int bh, cudaStream_t stream) {
  using P = VariantPlan<BQ, BK>;
  a.n_q_tiles = (a.s_q + BQ - 1) / BQ;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = view_map(&map_q, in.q, in.qb, in.qs, bh, a.s_q, a.d, BQ);
  if (err == cudaSuccess) err = view_map(&map_k, in.k, in.kb, in.ks, bh, a.s_k, a.d, BK);
  if (err == cudaSuccess) err = view_map(&map_v, in.v, in.vb, in.vs, bh, a.s_k, a.d, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_variant_kernel<BQ, BK, MODE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * a.n_q_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), P::threads, P::smem_bytes, stream>>>(map_q, map_k, map_v, a);
  return cudaGetLastError();
}

template <int BQ, int BK>
cudaError_t dispatch_mode(const VariantViews& in, const VariantArgs& a, int bh, int mode,
                          cudaStream_t s) {
  switch (mode) {
    case 0: return launch<BQ, BK, 0>(in, a, bh, s);
    case kPrescale: return launch<BQ, BK, kPrescale>(in, a, bh, s);
    case kBf16Exp: return launch<BQ, BK, kBf16Exp>(in, a, bh, s);
    case kPrescale | kBf16Exp: return launch<BQ, BK, kPrescale | kBf16Exp>(in, a, bh, s);
    case kNoExp: return launch<BQ, BK, kNoExp>(in, a, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int BQ, int BK>
void plan_of(int bh, int s_q, int* out) {
  using P = VariantPlan<BQ, BK>;
  out[0] = P::NWG;
  out[1] = P::threads;
  out[2] = P::NS;
  out[3] = P::smem_bytes;
  out[4] = bh * ((s_q + BQ - 1) / BQ);
}

}  // namespace

extern "C" {

// The tiling of a (bq, bk) variant over bh x s_q query rows, out[5]: consumer warpgroups,
// threads, ring slots, dynamic shared memory, blocks. Returns non-zero for a tile that is
// not built.
int lkgd_flash_variant_plan(int bq, int bk, int bh, int s_q, int* out) {
  if (bh <= 0 || s_q <= 0) return int(cudaErrorInvalidValue);
  if (bq == 64 && bk == 64) return plan_of<64, 64>(bh, s_q, out), 0;
  if (bq == 128 && bk == 64) return plan_of<128, 64>(bh, s_q, out), 0;
  if (bq == 64 && bk == 128) return plan_of<64, 128>(bh, s_q, out), 0;
  if (bq == 128 && bk == 128) return plan_of<128, 128>(bh, s_q, out), 0;
  return int(cudaErrorInvalidValue);
}

// q, k, v, o: (B*H, S, D) bf16 with unit D stride; strides[8] = (batch, row) element strides
// of q, k, v, o. t: (B*H, s_q) fp32. mode: 0 base, 1 prescale, 2 bf16exp, 3 both, 4 noexp.
// (bq, bk): the query x key tile, one of 64x64, 128x64, 64x128, 128x128.
int lkgd_flash_variant(const void* q, const void* k, const void* v, void* o, const float* t,
                       const long long* strides, int bh, int s_q, int s_k, int d,
                       float scale_log2, int mode, int bq, int bk, int device, void* stream) {
  if (d <= 0 || d > kPanelCols || d % 8 != 0 || bh <= 0 || s_q <= 0 || s_k <= 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  VariantViews in;
  in.q = q;
  in.k = k;
  in.v = v;
  in.qb = strides[0], in.qs = strides[1], in.kb = strides[2], in.ks = strides[3];
  in.vb = strides[4], in.vs = strides[5];
  VariantArgs a;
  a.o = static_cast<bf16*>(o);
  a.ob = strides[6], a.os = strides[7];
  a.t = t;
  a.s_q = s_q, a.s_k = s_k, a.d = d, a.n_q_tiles = 0;  // n_q_tiles: set by the launch
  a.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq == 64 && bk == 64) return int(dispatch_mode<64, 64>(in, a, bh, mode, s));
  if (bq == 128 && bk == 64) return int(dispatch_mode<128, 64>(in, a, bh, mode, s));
  if (bq == 64 && bk == 128) return int(dispatch_mode<64, 128>(in, a, bh, mode, s));
  if (bq == 128 && bk == 128) return int(dispatch_mode<128, 128>(in, a, bh, mode, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
