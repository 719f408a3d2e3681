// Flash-attention forward for Hopper (sm_90a), inference and training: bf16 in and out,
// fp32 sums, and with LSE=true the log2-domain logsumexp of every row that the backward
// kernels (flash_attention_bwd.cu) recompute the probabilities from.
//
// Replaces the Pallas TPU forward kernels of lkgd_tpu/ops/flash_attention.py:
//   * BOUND=true, kernel 1: _flash_bound_kernel (driven by _flash_bhsd). Softmax with a
//     per-row upper bound t_i = -scale*log2e*|q_i|*max_j|k_j| added in the exp2 domain in
//     the place of a running max: no max, no rescale, no cross-lane reduction in the loop.
//     The kernel writes the smallest row sum of each query tile. |q_i| is summed here from
//     the Q tile in shared memory; max_j|k_j|^2 per (batch, head) comes from a small kernel
//     of its own below (key_sq_max_kernel: the TPU wrapper computes its whole bound outside
//     the Pallas kernel, in _bound_t). That kernel is bound by bytes: it reads k once.
//   * BOUND=false, kernel 2: _flash_kernel (driven by _flash_maxtrack_bhsd), the online-max
//     form. Launched after kernel 1 with that kernel's per-tile minimum row sums, a block
//     returns at once unless its tile's minimum is <= 2^-110 (the TPU wrapper's lax.cond,
//     decided per tile on the device with no host synchronisation); launched with no
//     minimums it is the max-tracking kernel outright (LKGD_FLASH_MAXTRACK=1).
//   * LSE=true, kernels 7 and 8: _flash_bound_lse_kernel (driven by _flash_fwd_lse_bhsd) and
//     _flash_fwd_lse_kernel (driven by _flash_fwd_lse_maxtrack_bhsd), the two forms above
//     that also write lse, (B*H, S_q) fp32: log2(l) - t with the bound t the kernel itself
//     used, or m + log2(l) with the running max. One fp32 store a row in the epilogue and
//     nothing in the loop; kernel 8 guards kernel 7 as kernel 2 guards kernel 1, and a
//     recomputed tile overwrites both the output and the lse.
//
// What bounds it on the H100: tensor-core operations (4*S^2*D per batch and head against
// 8*S*D bytes: 9216 operations a byte at S=9216), and at D=64 the special-function unit
// as well: one exp2 stands against 256 tensor-core operations, and at 16 exp2 a clock an
// SM the exp2 of a call take about as long as its products at the full tensor rate. So
// the products must run at the wgmma rate and the softmax must run beside them:
//   * one block per (batch*head, query tile) of three warpgroups. A producer warp keeps a
//     ring of K and V tiles in flight with TMA (one rank-4 tensor map over each (B, S, H, D)
//     view, read through its strides, no copy); rows past S and columns past D arrive as
//     zeros from the hardware, in the 128-byte swizzle that wgmma reads directly. Consumers
//     wait on mbarriers; there is no block-wide barrier in the loop;
//   * two consumer warpgroups run wgmma.mma_async m64nNk16: Q.K^T with both operands in
//     shared memory, P.V with P as the register A operand (the score accumulator re-packed
//     to bf16) and V as a transposed (MN-major) B operand. In a warpgroup the exp2 of tile
//     j+1 runs while P.V of tile j is in flight, and the other warpgroup's products fill
//     the tensor cores meanwhile. setmaxnreg moves registers from the producer to them;
//   * D <= 128 (the UNet's D=64): 128 query rows a block, 64 to a warpgroup, 128-key tiles,
//     a ring of 6 (D <= 64) or 4 tiles;
//   * D > 128 (the VAE's D=512): 64 query rows a block; the output accumulator stays in
//     registers, split by columns: each warpgroup holds 64 x D/2 fp32 of O (128 registers a
//     thread at D=512) and accumulates P.V for its half of D. Both warpgroups compute the
//     full 64 x 64 scores of a 64-key tile (half as many operations again, and nothing to
//     exchange or synchronise between them); the ring has two 64 KB slots;
//   * ragged S: zero rows from TMA, keys past the end masked to -inf in the last tile.

#include <math.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace lkgd {  // the fp32 form (flash_attention_f32.cu)
int flash_f32_block_rows(int d);
int flash_f32_smem_bytes(int d);
int flash_f32_stages(int d);
long long flash_f32_scratch_floats(int batch, int heads, int s_q, int s_k, int d);
cudaError_t flash_key_sq_max_f32(const float* k, const Strides& ks, int batch, int heads, int s_k,
                                 int d, float* out, cudaStream_t stream);
cudaError_t flash_forward_f32(const void* q, const void* k, const void* v, void* o,
                              const Strides* st, int batch, int heads, int s_q, int s_k, int d,
                              float scale_log2, float* scratch, int* recomputed, float* lse,
                              bool bound, cudaStream_t s);
}  // namespace lkgd

namespace {

using namespace lkgd;
using namespace lkgd::sm90;

constexpr float kGuard = 0x1p-110f;  // smallest row sum the bound kernel may leave
constexpr int kConsumers = 256;      // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;

struct FwdArgs {
  bf16* o;
  Strides os;
  int heads, s_q, s_k, d, n_q_tiles;
  float scale_log2;     // D^-0.5 * log2(e)
  const float* k_sq_max;  // (B*H) largest squared key norm (bound kernel)
  float* tile_min;      // (B*H, n_q_tiles): written by the bound kernel, read as the guard
  int* recomputed;      // count of tiles the guarded max-tracking launch recomputed
  float* lse;           // (B*H, s_q) log2-domain logsumexp of the scaled logits (LSE forms)
};

// Tiling by D padded to DP (a multiple of 64): see the note above.
template <int DP>
struct Plan {
  static constexpr bool SPLIT = DP > 128;            // warpgroups split O by columns
  static constexpr int BQ = SPLIT ? 64 : 128;        // query rows a block
  static constexpr int BK = SPLIT ? 64 : 128;        // keys a tile
  static constexpr int NP = DP / kPanelCols;         // panels of a tile
  static constexpr int NO = SPLIT ? DP / 2 : DP;     // output columns a warpgroup
  static constexpr int NS = DP == 64 ? 6 : (DP == 512 ? 2 : 4);  // ring slots (K and V tiles)
  static constexpr int q_bytes = BQ * DP * 2;
  static constexpr int slot_bytes = BK * DP * 2;
  static constexpr int bar_bytes = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the tiles start at the next multiple of the swizzle atom
  static constexpr int smem_bytes = kAtomBytes + q_bytes + NS * slot_bytes + bar_bytes;
};

template <int DP, bool BOUND, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const FwdArgs a) {
  using P = Plan<DP>;
  constexpr int BQ = P::BQ, BK = P::BK, NP = P::NP, NO = P::NO, NS = P::NS;
  constexpr int SR = BK / 2;  // score registers a thread (64 x BK over 128 threads)
  constexpr int OR = NO / 2;  // output registers a thread

  if (!BOUND && a.tile_min != nullptr) {
    // guarded fallback launch: NaN compares false and is recomputed too
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ unsigned char smem_raw[];
  __shared__ float warp_min[kConsumers / 32];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sKV = sQ + P::q_bytes;
  const uint32_t q_full = sKV + NS * P::slot_bytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * NS;

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * BQ;
  const int n_tiles = (a.s_k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's arrive with the byte count
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warpgroup
    reg_dealloc<40>();  // 2 x 128 x 232 + 128 x 40 registers: the SM's 64 K
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, P::q_bytes);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sQ + p * BQ * kPanelRowBytes, &map_q, q_full, p * kPanelCols, q0, h, b);
      // the ring's order is the order the consumers want tiles in: K0, then K(j+1) and
      // V(j) in turn (the hole at 2 n_tiles - 1, where K(n_tiles) would be, stays empty)
      for (int i = 0; i <= 2 * n_tiles; ++i) {
        const bool is_v = i > 0 && !(i & 1);
        const int tile = is_v ? i / 2 - 1 : (i + 1) / 2;
        if (tile >= n_tiles) continue;
        const int slot = i % NS, use = i / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * slot, dst = sKV + slot * P::slot_bytes;
        mbar_arrive_expect_tx(bar, P::slot_bytes);
        const CUtensorMap* map = is_v ? &map_v : &map_k;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load_4d(dst + p * BK * kPanelRowBytes, map, bar, p * kPanelCols, tile * BK, h, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wg_row0 = P::SPLIT ? 0 : wg * 64;  // this warpgroup's first row in the Q tile
    const int col0 = P::SPLIT ? wg * NO : 0;     // and its first output column
    const int row_in_tile = wg_row0 + warp * 16 + g;  // this thread's rows: this and + 8

    mbar_wait(q_full, 0);

    // the bound t of this thread's two rows: -|q_i| * max_j|k_j| * scale * log2e, with the
    // squares of the row summed in fp32 from the swizzled tile (the four threads of a row
    // take two 16-byte chunks of each panel row each; the swizzle only permutes chunks)
    float t_r[2] = {0.f, 0.f};
    if (BOUND) {
      const unsigned char* q_tile = smem_raw + (sQ - raw);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ss = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const unsigned char* row =
              q_tile + p * BQ * kPanelRowBytes + (row_in_tile + 8 * r) * kPanelRowBytes;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint4 chunk = *reinterpret_cast<const uint4*>(row + (t4 + 4 * c) * 16);
            const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&chunk);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(v2[e]);
              ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
            }
          }
        }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        t_r[r] = -(sqrtf(ss) * sqrtf(a.k_sq_max[bh])) * a.scale_log2;
      }
    }

    float s[SR], o[OR];
    uint32_t pk[SR / 2];
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] = 0.f;

    const uint64_t q_desc = smem_desc(sQ + wg_row0 * kPanelRowBytes, 16, kAtomBytes);

    // s = Q . K_j^T over the depth DP: four 16-deep steps a panel
    auto k_index = [](int j) { return j == 0 ? 0 : 2 * j - 1; };  // ring index of K(j)
    auto v_index = [](int j) { return 2 * j + 2; };               // and of V(j)
    auto start_qk = [&](int j) {
      const int i = k_index(j);
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      const uint64_t k_desc = smem_desc(sKV + (i % NS) * P::slot_bytes, 16, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, desc_advance(q_desc, p * BQ * kPanelRowBytes + kk * 32),
                   desc_advance(k_desc, p * BK * kPanelRowBytes + kk * 32), (p | kk) != 0);
      wgmma_commit();
    };
    // o += P . V_j over the BK keys, 16 keys (two swizzle atoms of V rows) a step
    auto start_pv = [&](int j) {
      const int i = v_index(j);
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      const uint64_t v_desc =
          smem_desc(sKV + (i % NS) * P::slot_bytes + (col0 / kPanelCols) * BK * kPanelRowBytes,
                    BK * kPanelRowBytes, kAtomBytes);
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
      // 1. softmax numerators of tile j in place, exp2 domain, while P.V of tile j-1 runs
      const int k0 = j * BK;
      if (LAST && k0 + BK > a.s_k) {
#pragma unroll
        for (int i = 0; i < SR; ++i)
          if (k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k) s[i] = -INFINITY;
      }
      float alpha[2] = {1.f, 1.f}, shift[2];
      if (BOUND) {
        shift[0] = t_r[0];
        shift[1] = t_r[1];
      } else {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < SR; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r] * a.scale_log2);
          const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
          alpha[r] = ex2(m_r[r] - m_use);
          m_r[r] = m_new;
          l_r[r] *= alpha[r];
          shift[r] = -m_use;
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        s[i] = ex2(fmaf(s[i], a.scale_log2, shift[(i >> 1) & 1]));
        l_r[(i >> 1) & 1] += s[i];  // this thread's part; the row's 4 threads sum at the end
      }

      // 2. P.V of tile j-1 is done: its V tile, the packed P and o are free again
      wgmma_wait<0>();
      reg_fence(o);
      if (j > 0) release(v_index(j - 1));
      if (!BOUND) {
#pragma unroll
        for (int i = 0; i < OR; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < SR / 2; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

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

    // out = O / l through the output strides; with LSE the row's logsumexp from one of its
    // four threads (where the warpgroups split O by columns both hold the same l: the
    // first one writes). An underflowed row of the bound form may leave -inf or NaN here:
    // its tile's minimum is 0 and the guarded launch overwrites the whole tile.
    bf16* ob = a.o + b * a.os.b + h * a.os.h;
    float mn = INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + row_in_tile + 8 * r;
      if (row >= a.s_q) continue;
      mn = (l > kGuard) ? fminf(mn, l) : 0.f;  // an underflowed or NaN row: 0
      if (LSE && t4 == 0 && (!P::SPLIT || wg == 0))
        a.lse[(long long)bh * a.s_q + row] = BOUND ? log2f(l) - t_r[r] : m_r[r] + log2f(l);
      const float inv = 1.f / l;
#pragma unroll
      for (int n = 0; n < NO / 8; ++n) {
        const int col = col0 + n * 8 + 2 * t4;
        if (col < a.d)
          *reinterpret_cast<uint32_t*>(ob + (long long)row * a.os.s + col) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
    if (BOUND) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      if (lane == 0) warp_min[threadIdx.x / 32] = mn;
      named_barrier_sync(1, kConsumers);
      if (threadIdx.x == 0) {
        float tile = warp_min[0];
#pragma unroll
        for (int w = 1; w < kConsumers / 32; ++w) tile = fminf(tile, warp_min[w]);
        a.tile_min[blockIdx.x] = tile;
      }
    }
  }
}

// max_j |k_j|^2 of every (batch, head) into `out` (B*H fp32, zeroed before): a thread
// a key row, 16-byte loads, fp32 sums; non-negative floats order as their bits, so the
// blocks of one (batch, head) meet in an integer atomicMax.
__global__ void __launch_bounds__(256)
    key_sq_max_kernel(const bf16* k, Strides ks, int heads, int s_k, int d, float* out) {
  const int bh = blockIdx.y, row = blockIdx.x * blockDim.x + threadIdx.x;
  float ss = 0.f;
  if (row < s_k) {
    const bf16* p = k + (bh / heads) * ks.b + (bh % heads) * ks.h + (long long)row * ks.s;
    for (int c = 0; c < d; c += 8) {
      const uint4 chunk = __ldg(reinterpret_cast<const uint4*>(p + c));
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&chunk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = fmaxf(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (threadIdx.x % 32 == 0) atomicMax(reinterpret_cast<int*>(out + bh), __float_as_int(ss));
}

// ---------------------------------------------------------------------- host side
struct Views {
  const void *q, *k, *v;
  Strides qs, ks, vs;
  int batch;
};

struct Maps {
  CUtensorMap q, k, v;
};

template <int DP, bool BOUND, bool LSE>
cudaError_t launch(const Maps& m, const FwdArgs& a, int batch, cudaStream_t stream) {
  using P = Plan<DP>;
  auto kernel = flash_fwd_wgmma_kernel<DP, BOUND, LSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch * a.heads * a.n_q_tiles;
  kernel<<<unsigned(blocks), kThreads, P::smem_bytes, stream>>>(m.q, m.k, m.v, a);
  return cudaGetLastError();
}

// max_j |k_j|^2 of every (batch, head) into `out`, zeroed here first
cudaError_t key_sq_max(const void* k, const Strides& ks, int batch, int heads, int s_k, int d,
                       float* out, cudaStream_t stream) {
  if (batch * heads > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * batch * heads, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_k + 255) / 256, batch * heads);
  key_sq_max_kernel<<<grid, 256, 0, stream>>>(static_cast<const bf16*>(k), ks, heads, s_k, d,
                                                out);
  return cudaGetLastError();
}

// A whole forward at a tile width DP: the bound form (the key norms, the bound kernel, then
// the max-tracking kernel as its guard over the bound kernel's tile minimums) or the
// max-tracking kernel alone. The two launches read the same tensor maps, encoded once.
template <int DP, bool LSE>
cudaError_t forward(const Views& in, FwdArgs a, float* scratch, bool bound, cudaStream_t s) {
  using P = Plan<DP>;
  a.n_q_tiles = (a.s_q + P::BQ - 1) / P::BQ;
  Maps m;
  cudaError_t err = make_map(&m.q, in.q, in.qs, in.batch, a.s_q, a.heads, a.d, P::BQ);
  if (err == cudaSuccess) err = make_map(&m.k, in.k, in.ks, in.batch, a.s_k, a.heads, a.d, P::BK);
  if (err == cudaSuccess) err = make_map(&m.v, in.v, in.vs, in.batch, a.s_k, a.heads, a.d, P::BK);
  if (err != cudaSuccess) return err;
  if (!bound) return launch<DP, false, LSE>(m, a, in.batch, s);
  a.k_sq_max = scratch;
  a.tile_min = scratch + in.batch * a.heads;
  err = key_sq_max(in.k, in.ks, in.batch, a.heads, a.s_k, a.d, scratch, s);
  if (err == cudaSuccess) err = launch<DP, true, LSE>(m, a, in.batch, s);
  if (err == cudaSuccess) err = launch<DP, false, LSE>(m, a, in.batch, s);
  return err;
}

// Static dispatch by D padded to a tile width the kernel is built for.
template <bool LSE>
cudaError_t dispatch(const Views& in, const FwdArgs& a, float* scratch, bool bound,
                     cudaStream_t s) {
  if (a.d <= 64) return forward<64, LSE>(in, a, scratch, bound, s);
  if (a.d <= 128) return forward<128, LSE>(in, a, scratch, bound, s);
  if (a.d <= 256) return forward<256, LSE>(in, a, scratch, bound, s);
  return forward<512, LSE>(in, a, scratch, bound, s);
}

}  // namespace

extern "C" {

// Query rows per block (the tile the per-tile guard covers) for a head dim d: one tiling
// for the inference forward (lse == 0) and the training forward (lse != 0).
int lkgd_flash_block_rows(int d, int lse) {
  (void)lse;
  return d <= 128 ? 128 : 64;
}

// Dynamic shared memory of the forward's block for a head dim d.
int lkgd_flash_smem_bytes(int d) {
  return d <= 64    ? Plan<64>::smem_bytes
         : d <= 128 ? Plan<128>::smem_bytes
         : d <= 256 ? Plan<256>::smem_bytes
                    : Plan<512>::smem_bytes;
}

// q, k, v, o: (B, S, H, D) bf16, or fp32 with fp32 != 0 (the fp32 form of
// flash_attention_f32.cu); `strides` packs their (b, s, h) element strides, twelve int64 in
// that order. lse: (B*H, s_q) fp32 written beside o (kernels 7 and 8), or null (kernels 1
// and 2), in either dtype. bound=1: the bound kernel
// after the key-norm kernel, then the max-tracking kernel as its guard, all on `stream` from
// this one call; scratch: B*H floats for the squared key norms, then B*H * (query tiles) for
// the bound kernel's smallest row sums. bound=0: the max-tracking kernel alone, no scratch.
// The fp32 form takes scratch with either: lkgd_flash_f32_scratch_floats floats.
int lkgd_flash_forward(const void* q, const void* k, const void* v, void* o,
                       const void* strides, int batch, int heads, int s_q, int s_k, int d,
                       float scale_log2, float* scratch, int* recomputed, float* lse, int bound,
                       int fp32, int device, void* stream) {
  if (d <= 0 || d > 512 || d % 8 != 0 || ((bound || fp32) && scratch == nullptr))
    return int(cudaErrorInvalidValue);
  // cudaSetDevice also makes the device's context current on this thread, which
  // cuTensorMapEncodeTiled needs: a thread whose first CUDA call this is (autograd's
  // backward thread, recomputing a checkpointed forward) has none yet
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{lkgd::word(strides, 3 * i), lkgd::word(strides, 3 * i + 1),
                    lkgd::word(strides, 3 * i + 2)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return int(lkgd::flash_forward_f32(q, k, v, o, st, batch, heads, s_q, s_k, d, scale_log2,
                                       scratch, recomputed, lse, bound != 0, s));
  const Views in{q, k, v, st[0], st[1], st[2], batch};
  FwdArgs a;
  a.o = static_cast<bf16*>(o);
  a.os = st[3];
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_q_tiles = 0;  // set by the forward from its plan
  a.scale_log2 = scale_log2;
  a.k_sq_max = nullptr;
  a.tile_min = nullptr;
  a.recomputed = recomputed;
  a.lse = lse;
  return int(lse != nullptr ? dispatch<true>(in, a, scratch, bound != 0, s)
                            : dispatch<false>(in, a, scratch, bound != 0, s));
}

// k: (B, S_k, H, D) bf16 (fp32 with fp32 != 0) with (b, s, h) element strides -> out (B*H)
// fp32: the largest squared key norm of each batch and head (the key-norm kernel alone).
int lkgd_flash_key_sq_max(const void* k, const long long* strides, int batch, int heads, int s_k,
                          int d, float* out, int fp32, int device, void* stream) {
  if (d <= 0 || d % 8 != 0) return int(cudaErrorInvalidValue);
  const cudaError_t err = lkgd::use_device(device);
  if (err != cudaSuccess) return int(err);
  const Strides ks{strides[0], strides[1], strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return int(lkgd::flash_key_sq_max_f32(static_cast<const float*>(k), ks, batch, heads, s_k, d,
                                          out, s));
  return int(key_sq_max(k, ks, batch, heads, s_k, d, out, s));
}

// Query rows a block, dynamic shared memory and ring slots of the fp32 form's block for a
// head dim d, and the floats of scratch its forward takes.
int lkgd_flash_f32_block_rows(int d) { return lkgd::flash_f32_block_rows(d); }

int lkgd_flash_f32_smem_bytes(int d) { return lkgd::flash_f32_smem_bytes(d); }

int lkgd_flash_f32_stages(int d) { return lkgd::flash_f32_stages(d); }

long long lkgd_flash_f32_scratch_floats(int batch, int heads, int s_q, int s_k, int d) {
  return lkgd::flash_f32_scratch_floats(batch, heads, s_q, s_k, d);
}

// The message of a launcher's non-zero return, for every source of the library.
const char* lkgd_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
