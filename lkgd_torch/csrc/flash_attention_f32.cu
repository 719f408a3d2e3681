// Flash-attention forward for Hopper at fp32: fp32 in and out, fp32-accurate products on the
// TF32 tensor cores, fp32 sums; the form the bf16 kernels of flash_attention_wgmma.cu take
// for float32 operands, inference and training alike. lkgd_flash_forward
// (flash_attention_wgmma.cu) launches it from the same one C call, by the operands' type.
//
// Replaces, for fp32 operands, the Pallas TPU forward kernels of
// lkgd_tpu/ops/flash_attention.py, whose bodies take fp32 operands with fp32 accumulation
// (the temporal VAE and CLIP-H built in fp32, as lkgd_tpu/cli/precompute_cache.py builds
// them, send their mid-block attention there):
//   * BOUND=true, kernel 1 (_flash_bound_kernel): exp2 of the logits shifted by the per-row
//     Cauchy-Schwarz bound t_i = -scale*log2e*|q_i|*max_j|k_j|, no running max; each block
//     writes its tile's smallest row sum;
//   * BOUND=false, kernel 2 (_flash_kernel): the online-max form, launched after kernel 1
//     as its guard (a block returns at once unless its tile's smallest row sum is <=
//     2^-110; NaN is recomputed too), or alone (LKGD_FLASH_MAXTRACK=1);
//   * key_sq_max_f32_kernel, kernel 1a at fp32: max_j|k_j|^2 of every (batch, head);
//   * with an lse to write (F32Args::lse), kernels 7 and 8 (_flash_bound_lse_kernel,
//     _flash_fwd_lse_kernel) at fp32: the same two forms that also write the log2-domain
//     logsumexp of every row, (B*H, S_q) fp32, with the contract of the bf16 LSE forms:
//     log2(l) - t with the bound t the kernel used (absolute, whatever t is), or m + log2(l)
//     with the running max; a recomputed tile overwrites both the output and the lse. The
//     JAX SVD fine-tune CLI builds its UNet in fp32, and its train step sends the spatial
//     attention of levels 0 and 1 (4096 and 1024 tokens) there; one fp32 store a row.
//
// Arithmetic, 3xTF32: every fp32 operand x is split into hi = x rounded to tf32
// (cvt.rna) and lo = x - hi (exact in fp32), and each product is lo.hi + hi.lo + hi.hi on
// wgmma.mma_async m64n64k8 .tf32 (lo.lo is below fp32's rounding). S = Q.K^T and O = P.V
// alike; P is split in registers after its exp2. The tensor core's accumulator truncates
// each sum (round toward zero), a bias that grows with the number of sums into one
// accumulator: summed over all of D and over every key, the kernel landed 2-4e-5 of max|ref|
// from the fp32 plain version at D=512 (on an H100), past the 2e-5 it is held to. So:
//   * S keeps hi.hi and the two small products (2^-11 as large) in two accumulators, added
//     in fp32 at the end: the large sums see a third of the additions;
//   * P.V of each 64-key tile goes to a fresh accumulator, then O = O * alpha + it with an
//     fp32 FMA (24 truncated sums a tile, not 3 S_k / 8);
//   * at D = 512 each warpgroup sums S over half of the depth (below).
// That holds it at 1-7e-6 of max|ref|. One TF32 product would put ~3e-3 there.
//
// What bounds it on the H100: tensor-core operations, three TF32 products of 4*S^2*D each
// per batch and head at 495 TFLOP/s (at D = 256 the two warpgroups both compute all of S:
// 1.5x that), and at D = 512 the L2: each (64-row query tile, 64-key tile) pair streams Q,
// K and V^T as hi and lo, 768 KB, ~5.6 TB/s from L2 at (14, 4096, 1, 512).
//
// The tf32 layout rule: wgmma takes 32-bit operands K-major only. Q (rows x D) and K (keys
// x D) are K-major for Q.K^T as they lie, but V (keys x D) is not for P.V, which needs V^T
// (D x keys). So a pre-pass kernel (tf32_split_kernel, replacing no TPU kernel: it exists
// for that rule) launched first from the same call writes six planes into the wrapper's
// scratch: Q, K (B*H, S, DP) and V^T (B*H, DP, S_k rounded up to 32) as hi and lo, zeros
// past D and past S_k, and |q_i|^2 summed in fp32 for the bound. It reads q, k, v once
// through their strides and writes 2x their bytes (~0.3 ms at (14, 4096, 1, 512)).
// V^T's keys are laid out [0, 2, 4, 6, 1, 3, 5, 7] in every group of 8: the accumulator of
// S gives a thread keys {2 t4, 2 t4 + 1} of each 8, and the A operand of a k8 step wants
// depths {t4, t4 + 4}; with the permuted V^T the same registers are P's A operand as they
// are (P.V sums over keys, so permuting its keys and V^T's alike changes nothing).
//
// The main kernel, flash_fwd_tf32_kernel<DP, BOUND>: one block per (batch*head, query tile)
// of three warpgroups, the bf16 forward's structure:
//   * a producer warp keeps a ring of "units" in flight with TMA: a unit is a 64-row x 32
//     fp32 box of a hi plane and the same box of its lo plane (8 KB each, 128-byte swizzle:
//     a 32-fp32 row is one swizzled 128-byte row); consumers wait on mbarriers and release
//     every unit (8 warp arrivals, a warpgroup releasing the other's units once they have
//     arrived), with no block-wide barrier in the loop;
//   * two consumer warpgroups, setmaxnreg moving registers to them (240 each). D <= 128
//     (the fp32 UNet's D=64): 128 query rows a block, 64 to a warpgroup, Q hi and lo
//     resident in shared memory, K and V^T units streamed; a 10-unit ring (6 at D=128).
//     D = 256: 64 rows, Q resident, both warpgroups compute all of S and each keeps half of
//     O's columns. D = 512 (the VAE's mid block): 64 rows, each warpgroup keeps half of O's
//     columns (128 registers); Q hi and lo (256 KB) do not fit beside a ring, so Q's units
//     stream with K's from L2, and each warpgroup sums S over half of the depth; the halves
//     meet through shared memory (64 KB: two tiles' worth, one named barrier a tile), which
//     also spares the 1.5x products of both computing all of S; a 10-unit ring;
//   * a key tile is 64 keys: S over the depth units (one wgmma group a unit, the next unit's
//     group issued before the last one's release), the softmax in registers, P split into
//     hi and lo, then P.V a 64-column set of O at a time (its two V^T units of 32 keys);
//   * rows past S_q and past S_k arrive as zeros from TMA; keys past S_k are masked to -inf.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using lkgd::Strides;
using namespace lkgd::sm90;

constexpr float kGuard = 0x1p-110f;  // smallest row sum the bound kernel may leave
constexpr int kConsumers = 256;      // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kBK = 64;              // keys a tile
constexpr int kSmemLimit = 232448;               // dynamic shared memory a block may use

// Tiling by D padded to DP (a multiple of 64): see the note above.
template <int DP>
struct Plan {
  static constexpr bool SPLIT = DP > 128;          // warpgroups split O by columns
  static constexpr bool Q_STREAM = DP > 256;       // Q's units stream; S's depth is split
  static constexpr int BQ = SPLIT ? 64 : 128;      // query rows a block
  static constexpr int ND = DP / kUnitCols;        // depth units of a row block
  static constexpr int NSD = Q_STREAM ? ND / 2 : ND;  // depth units a warpgroup sums S over
  static constexpr int NR = DP / 64;               // 64-column sets of O
  static constexpr int NOS = SPLIT ? NR / 2 : NR;  // sets of O a warpgroup keeps
  static constexpr int q_bytes = Q_STREAM ? 0 : (BQ / 64) * ND * kUnitBytes;
  // the halves of S the warpgroups exchange, two tiles' worth (64 x 64 fp32 each)
  static constexpr int x_bytes = Q_STREAM ? 4 * 64 * 64 * 4 : 0;
  // ring slots: what is left after Q, the exchange, 1024 bytes of alignment slack and 512
  // for barriers
  static constexpr int NS = (kSmemLimit - 1536 - q_bytes - x_bytes) / kUnitBytes;
  static constexpr int bar_bytes = 8 * (1 + 2 * NS);
  static constexpr int smem_bytes = kAtomBytes + q_bytes + x_bytes + NS * kUnitBytes + bar_bytes;
};

// The scratch the forward splits into (floats, each plane 16-byte aligned: DP % 64 == 0,
// s_kp % 32 == 0): Q hi, Q lo (B*H, s_q, DP); K hi, K lo (B*H, s_k, DP); V^T hi, V^T lo
// (B*H, DP, s_kp); |q_i|^2 (B*H, s_q); the squared key norms (B*H); the bound kernel's
// smallest row sums (B*H, query tiles).
struct Scratch {
  float *qh, *ql, *kh, *kl, *vh, *vl, *q_sq, *k_sq_max, *tile_min;
  long long floats;
};

inline int pad_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 512; }
inline int block_rows(int d) { return d <= 128 ? 128 : 64; }

Scratch scratch_layout(float* base, int bh, int s_q, int s_k, int d) {
  const long long dp = pad_d(d), s_kp = (s_k + 31) / 32 * 32;
  const long long qp = (long long)bh * s_q * dp, kp = (long long)bh * s_k * dp,
                  vp = bh * dp * s_kp;
  const int n_q_tiles = (s_q + block_rows(d) - 1) / block_rows(d);
  Scratch sc;
  sc.floats = 2 * (qp + kp + vp) + (long long)bh * s_q + bh + (long long)bh * n_q_tiles;
  if (base == nullptr) return sc;
  sc.qh = base;
  sc.ql = sc.qh + qp;
  sc.kh = sc.ql + qp;
  sc.kl = sc.kh + kp;
  sc.vh = sc.kl + kp;
  sc.vl = sc.vh + vp;
  sc.q_sq = sc.vl + vp;
  sc.k_sq_max = sc.q_sq + (long long)bh * s_q;
  sc.tile_min = sc.k_sq_max + bh;
  return sc;
}

struct SplitArgs {
  const float *q, *k, *v;
  Strides qs, ks, vs;
  int heads, s_q, s_k, d, s_kp;
};

// The pre-pass: rows r0..r0+31 of q and of k, and keys r0..r0+31 of v (transposed), of one
// (batch, head) into their hi and lo planes; |q_i|^2 of the q rows. A warp takes whole rows
// (16-byte loads and stores along them); v goes through shared memory 64 columns at a time.
template <int DP>
__global__ void __launch_bounds__(256) tf32_split_kernel(const SplitArgs a, const Scratch sc) {
  __shared__ float tile[32][65];
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int r0 = blockIdx.x * 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto split_rows = [&](const float* x, const Strides& st, int s, float* hi, float* lo,
                        float* sq) {
    const float* xb = x + b * st.b + h * st.h;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = r0 + warp * 4 + rr;
      if (row >= s) break;
      float ss = 0.f;
      const long long out = ((long long)bh * s + row) * DP;
#pragma unroll
      for (int c = lane * 4; c < DP; c += 128) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < a.d) v = __ldg(reinterpret_cast<const float4*>(xb + (long long)row * st.s + c));
        ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
        const float4 vh = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                                      tf32_round(v.w));
        *reinterpret_cast<float4*>(hi + out + c) = vh;
        *reinterpret_cast<float4*>(lo + out + c) =
            make_float4(v.x - vh.x, v.y - vh.y, v.z - vh.z, v.w - vh.w);
      }
      if (sq != nullptr) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (lane == 0) sq[(long long)bh * s + row] = ss;
      }
    }
  };
  if (r0 < a.s_q) split_rows(a.q, a.qs, a.s_q, sc.qh, sc.ql, sc.q_sq);
  if (r0 < a.s_k) split_rows(a.k, a.ks, a.s_k, sc.kh, sc.kl, nullptr);
  if (r0 >= a.s_k) return;

  // V^T: 64 columns of D x the 32 keys at a time, zeros past S_k and past D
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  for (int c0 = 0; c0 < DP; c0 += 64) {
    for (int e = threadIdx.x; e < 32 * 16; e += 256) {
      const int key = e / 16, col = c0 + (e % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + key < a.s_k && col < a.d)
        v = __ldg(reinterpret_cast<const float4*>(vb + (long long)(r0 + key) * a.vs.s + col));
      tile[key][col - c0] = v.x;
      tile[key][col - c0 + 1] = v.y;
      tile[key][col - c0 + 2] = v.z;
      tile[key][col - c0 + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = threadIdx.x + 256 * i, row = e / 32, p = e % 32;
      const float x = tile[tf32_perm(p)][row];
      const float hi = tf32_round(x);
      const long long out = ((long long)bh * DP + c0 + row) * a.s_kp + r0 + p;
      sc.vh[out] = hi;
      sc.vl[out] = x - hi;
    }
    __syncthreads();
  }
}

struct F32Args {
  float* o;
  Strides os;
  int heads, s_q, s_k, d, n_q_tiles;
  float scale_log2;        // D^-0.5 * log2(e)
  const float* q_sq;       // (B*H, s_q) |q_i|^2 (bound kernel)
  const float* k_sq_max;   // (B*H) largest squared key norm (bound kernel)
  float* tile_min;         // (B*H, n_q_tiles) smallest row sums: written by 1, read by 2
  int* recomputed;         // tiles the guarded max-tracking launch recomputed
  float* lse;              // (B*H, s_q) log2-domain logsumexp (kernels 7 and 8), or null
};

struct Maps {
  CUtensorMap qh, ql, kh, kl, vh, vl;
};

template <int DP, bool BOUND>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ Maps m, const F32Args a) {
  using P = Plan<DP>;
  constexpr int BQ = P::BQ, ND = P::ND, NSD = P::NSD, NOS = P::NOS, NS = P::NS;
  constexpr bool SPLIT = P::SPLIT, Q_STREAM = P::Q_STREAM;

  if (!BOUND && a.tile_min != nullptr) {
    // guarded fallback launch: NaN compares false and is recomputed too
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ unsigned char smem_raw[];
  __shared__ float warp_min[kConsumers / 32];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sX = sQ + P::q_bytes;
  const uint32_t sRing = sX + P::x_bytes;
  const uint32_t q_full = sRing + NS * kUnitBytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * NS;

  const int bh = blockIdx.x / a.n_q_tiles;
  const int q0 = (blockIdx.x % a.n_q_tiles) * BQ;
  const int n_tiles = (a.s_k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrive with the byte count
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warpgroup
    reg_dealloc<24>();  // 2 x 128 x 240 + 128 x 24 registers: the SM's 64 K
    if (threadIdx.x == kConsumers) {
      if (!Q_STREAM) {
        mbar_arrive_expect_tx(q_full, P::q_bytes);
        for (int rb = 0; rb < BQ / 64; ++rb)
          for (int p = 0; p < ND; ++p) {
            const uint32_t dst = sQ + (rb * ND + p) * kUnitBytes;
            tma_load_4d(dst, &m.qh, q_full, p * kUnitCols, q0 + 64 * rb, bh, 0);
            tma_load_4d(dst + kPlaneBytes, &m.ql, q_full, p * kUnitCols, q0 + 64 * rb, bh, 0);
          }
      }
      // the units in the order the consumers take them: for each key tile the depth units
      // of S (where Q streams, Q's and K's unit of warpgroup 0's depth, then warpgroup 1's),
      // then V^T's units, 32 keys by 64 columns of O, two a set of O (where the warpgroups
      // split O, the two warpgroups' units alternate)
      int u = 0;
      auto load = [&](const CUtensorMap* hi, const CUtensorMap* lo, int c0, int c1) {
        const int slot = u % NS, use = u / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * slot, dst = sRing + slot * kUnitBytes;
        mbar_arrive_expect_tx(bar, kUnitBytes);
        tma_load_4d(dst, hi, bar, c0, c1, bh, 0);
        tma_load_4d(dst + kPlaneBytes, lo, bar, c0, c1, bh, 0);
        ++u;
      };
      for (int j = 0; j < n_tiles; ++j) {
        for (int p = 0; p < NSD; ++p) {
          if (Q_STREAM) {
            for (int w = 0; w < 2; ++w) {
              const int col = (w * NSD + p) * kUnitCols;
              load(&m.qh, &m.ql, col, q0);
              load(&m.kh, &m.kl, col, j * kBK);
            }
          } else {
            load(&m.kh, &m.kl, p * kUnitCols, j * kBK);
          }
        }
        for (int n = 0; n < NOS; ++n)
          for (int c = 0; c < kBK / kUnitCols; ++c)
            for (int w = 0; w < (SPLIT ? 2 : 1); ++w)
              load(&m.vh, &m.vl, j * kBK + c * kUnitCols, 64 * (w * NOS + n));
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int rb = SPLIT ? 0 : wg;                    // this warpgroup's row block of Q
    const int row_in_tile = rb * 64 + warp * 16 + g;  // this thread's rows: this and + 8

    // the bound t of this thread's two rows, -|q_i| * max_j|k_j| * scale * log2e, from the
    // pre-pass's |q_i|^2 (summed in fp32)
    float t_r[2] = {0.f, 0.f};
    if (BOUND) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + row_in_tile + 8 * r;
        const float ss = row < a.s_q ? a.q_sq[(long long)bh * a.s_q + row] : 0.f;
        t_r[r] = -(sqrtf(ss) * sqrtf(a.k_sq_max[bh])) * a.scale_log2;
      }
    }

    float s[32], o[NOS][32];
    uint32_t ph[32], pl[32];  // P's A operand, hi and lo: k8 step n is ph[4 n .. 4 n + 3]
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int n = 0; n < NOS; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] = 0.f;

    if (!Q_STREAM) mbar_wait(q_full, 0);

    int u = 0;  // the next unit of the ring, in the producer's order
    auto wait_unit = [&](int x) { mbar_wait(full0 + 8 * (x % NS), (x / NS) & 1); };
    auto unit_at = [&](int x) { return sRing + (x % NS) * kUnitBytes; };
    auto release = [&](int x) {  // ring unit x is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (x % NS));
    };
    auto desc = [](uint32_t addr) { return smem_desc(addr, 16, kAtomBytes); };

    // S = Q . K_j^T over this warpgroup's depth units, one wgmma group a unit, a unit
    // released once the next unit's group is in flight and its own is done. The tensor
    // core's accumulator truncates each sum: hi.hi goes to `big`, lo.hi + hi.lo (2^-11 as
    // large) to `small`, so that the large sums see a third of the additions. Where Q
    // streams, each warpgroup sums half of the depth and the halves meet through shared
    // memory (one named barrier a tile; the exchange area alternates with the tile).
    auto scores = [&](int j) {
      float big[32], small[32];
      int prev = -1;
#pragma unroll
      for (int p = 0; p < NSD; ++p) {
        uint32_t qa = sQ + (rb * ND + p) * kUnitBytes, ka;
        int mine = u;
        if (Q_STREAM) {  // Q(w0), K(w0), Q(w1), K(w1)
          mine = u + 2 * wg;
          const int other = u + 2 - 2 * wg;
          wait_unit(other);
          wait_unit(other + 1);
          release(other);
          release(other + 1);
          wait_unit(mine);
          qa = unit_at(mine);
          ka = unit_at(mine + 1);
          u += 4;
        } else {
          u += 1;
        }
        wait_unit(Q_STREAM ? mine + 1 : mine);
        if (!Q_STREAM) ka = unit_at(mine);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = kk * 32;
          wgmma_tf32_ss(small, desc(qa + kPlaneBytes + off), desc(ka + off), (p | kk) != 0);
          wgmma_tf32_ss(small, desc(qa + off), desc(ka + kPlaneBytes + off), 1);
          wgmma_tf32_ss(big, desc(qa + off), desc(ka + off), (p | kk) != 0);
        }
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          release(prev);
          if (Q_STREAM) release(prev + 1);
        }
        prev = mine;
      }
      wgmma_wait<0>();
      reg_fence(big);
      reg_fence(small);
      release(prev);
      if (Q_STREAM) release(prev + 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = big[i] + small[i];
      if (Q_STREAM) {
        float* x = reinterpret_cast<float*>(smem_raw + (sX - raw)) + (j & 1) * 2 * 4096;
        const int t = threadIdx.x % 128;  // the same rows and keys in both warpgroups
#pragma unroll
        for (int i = 0; i < 32; ++i) x[wg * 4096 + i * 128 + t] = s[i];
        named_barrier_sync(2, kConsumers);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] += x[(1 - wg) * 4096 + i * 128 + t];
      }
    };

    // O += P . V_j a 64-column set at a time: the set's two V^T units (32 keys each) into a
    // fresh accumulator, then o = o * alpha + it in fp32 (an accumulator kept over every
    // key would see 3 S_k / 8 truncated additions). Where the warpgroups split O, each takes
    // one unit of every pair and releases the other's once it has arrived.
    auto values = [&]() {
#pragma unroll
      for (int n = 0; n < NOS; ++n) {
        float acc[32];
        int mine[2];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kBK / kUnitCols; ++c) {
          mine[c] = u;
          if (SPLIT) {
            mine[c] = u + wg;
            const int other = u + 1 - wg;
            wait_unit(other);
            release(other);
            u += 2;
          } else {
            u += 1;
          }
          wait_unit(mine[c]);
          const uint32_t va = unit_at(mine[c]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int step = 4 * c + kk;
            const uint32_t off = kk * 32;
            wgmma_tf32_rs(acc, pl + 4 * step, desc(va + off), (c | kk) != 0);
            wgmma_tf32_rs(acc, ph + 4 * step, desc(va + kPlaneBytes + off), 1);
            wgmma_tf32_rs(acc, ph + 4 * step, desc(va + off), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        release(mine[0]);
        release(mine[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[n][i] = BOUND ? o[n][i] + acc[i] : fmaf(o[n][i], alpha[(i >> 1) & 1], acc[i]);
      }
    };

    // One key tile; `last` (a std::bool_constant) marks the tile that may be ragged: the
    // loop's body has no branch on the tile's number.
    auto tile = [&](int j, auto last) {
      constexpr bool LAST = decltype(last)::value;
      scores(j);
      const int k0 = j * kBK;
      if (LAST && k0 + kBK > a.s_k) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k) s[i] = -INFINITY;
      }
      float shift[2];
      if (BOUND) {
        shift[0] = t_r[0];
        shift[1] = t_r[1];
      } else {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
      // the numerators in the exp2 domain, split into P's hi and lo A operands: the
      // accumulator's keys {2 t4, 2 t4 + 1} of group n go to depths {t4, t4 + 4} of step n
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2(fmaf(s[4 * n + e], a.scale_log2, shift[e >> 1]));
          l_r[e >> 1] += x;  // this thread's part; the row's 4 threads sum at the end
          const float hi = tf32_round(x);
          const int at = 4 * n + ((e & 1) << 1) + (e >> 1);  // e: 0 1 2 3 -> 0 2 1 3
          ph[at] = __float_as_uint(hi);
          pl[at] = __float_as_uint(x - hi);
        }
      values();
    };
    for (int j = 0; j + 1 < n_tiles; ++j) tile(j, std::false_type{});
    tile(n_tiles - 1, std::true_type{});

    // out = O / l through the output strides; with an lse the row's logsumexp from one of
    // its four threads (where the warpgroups split O by columns both hold the same l: the
    // first one writes). An underflowed row of the bound form may leave inf or NaN here: its
    // tile's minimum is 0 and the guarded launch overwrites the whole tile.
    float* ob = a.o + (bh / a.heads) * a.os.b + (bh % a.heads) * a.os.h;
    const int col0 = SPLIT ? wg * (DP / 2) : 0;
    float mn = INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + row_in_tile + 8 * r;
      if (row >= a.s_q) continue;
      mn = (l > kGuard) ? fminf(mn, l) : 0.f;  // an underflowed or NaN row: 0
      if (a.lse != nullptr && t4 == 0 && (!SPLIT || wg == 0))
        a.lse[(long long)bh * a.s_q + row] = BOUND ? log2f(l) - t_r[r] : m_r[r] + log2f(l);
      const float inv = 1.f / l;
#pragma unroll
      for (int n = 0; n < NOS; ++n)
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int col = col0 + 64 * n + 8 * c8 + 2 * t4;
          if (col < a.d)
            *reinterpret_cast<float2*>(ob + (long long)row * a.os.s + col) =
                make_float2(o[n][4 * c8 + 2 * r] * inv, o[n][4 * c8 + 2 * r + 1] * inv);
        }
    }
    if (BOUND) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      if (lane == 0) warp_min[threadIdx.x / 32] = mn;
      named_barrier_sync(1, kConsumers);
      if (threadIdx.x == 0) {
        float tile_mn = warp_min[0];
#pragma unroll
        for (int w = 1; w < kConsumers / 32; ++w) tile_mn = fminf(tile_mn, warp_min[w]);
        a.tile_min[blockIdx.x] = tile_mn;
      }
    }
  }
}

// max_j |k_j|^2 of every (batch, head) into `out` (B*H fp32, zeroed before): a thread a key
// row, 16-byte loads, fp32 sums; non-negative floats order as their bits, so the blocks of
// one (batch, head) meet in an integer atomicMax.
__global__ void __launch_bounds__(256)
    key_sq_max_f32_kernel(const float* k, Strides ks, int heads, int s_k, int d, float* out) {
  const int bh = blockIdx.y, row = blockIdx.x * blockDim.x + threadIdx.x;
  float ss = 0.f;
  if (row < s_k) {
    const float* p = k + (bh / heads) * ks.b + (bh % heads) * ks.h + (long long)row * ks.s;
    for (int c = 0; c < d; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + c));
      ss = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, ss))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = fmaxf(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (threadIdx.x % 32 == 0) atomicMax(reinterpret_cast<int*>(out + bh), __float_as_int(ss));
}

// max_j |k_j|^2 of every (batch, head) into `out`, zeroed here first
cudaError_t key_sq_max_f32(const float* k, const Strides& ks, int batch, int heads, int s_k, int d,
                           float* out, cudaStream_t stream) {
  if (batch * heads > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * batch * heads, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_k + 255) / 256, batch * heads);
  key_sq_max_f32_kernel<<<grid, 256, 0, stream>>>(k, ks, heads, s_k, d, out);
  return cudaGetLastError();
}

template <int DP, bool BOUND>
cudaError_t launch(const Maps& m, const F32Args& a, int batch, cudaStream_t stream) {
  using P = Plan<DP>;
  auto kernel = flash_fwd_tf32_kernel<DP, BOUND>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch * a.heads * a.n_q_tiles;
  kernel<<<unsigned(blocks), kThreads, P::smem_bytes, stream>>>(m, a);
  return cudaGetLastError();
}

// A whole forward at a tile width DP: the pre-pass, then the bound form (the key norms, the
// bound kernel, then the max-tracking kernel as its guard over the bound kernel's tile
// minimums) or the max-tracking kernel alone. The launches read the same tensor maps.
template <int DP>
cudaError_t forward(const SplitArgs& in, F32Args a, int batch, const Scratch& sc, bool bound,
                    cudaStream_t s) {
  const int bh = batch * a.heads;
  if (bh > 65535) return cudaErrorInvalidValue;
  const dim3 grid(((a.s_q > a.s_k ? a.s_q : a.s_k) + 31) / 32, bh);
  tf32_split_kernel<DP><<<grid, 256, 0, s>>>(in, sc);
  cudaError_t err = cudaGetLastError();
  Maps m;
  if (err == cudaSuccess) err = f32_plane_map(&m.qh, sc.qh, bh, a.s_q, DP);
  if (err == cudaSuccess) err = f32_plane_map(&m.ql, sc.ql, bh, a.s_q, DP);
  if (err == cudaSuccess) err = f32_plane_map(&m.kh, sc.kh, bh, a.s_k, DP);
  if (err == cudaSuccess) err = f32_plane_map(&m.kl, sc.kl, bh, a.s_k, DP);
  if (err == cudaSuccess) err = f32_plane_map(&m.vh, sc.vh, bh, DP, in.s_kp);
  if (err == cudaSuccess) err = f32_plane_map(&m.vl, sc.vl, bh, DP, in.s_kp);
  if (err != cudaSuccess) return err;
  if (!bound) return launch<DP, false>(m, a, batch, s);
  a.q_sq = sc.q_sq;
  a.k_sq_max = sc.k_sq_max;
  a.tile_min = sc.tile_min;
  err = key_sq_max_f32(in.k, in.ks, batch, a.heads, a.s_k, a.d, sc.k_sq_max, s);
  if (err == cudaSuccess) err = launch<DP, true>(m, a, batch, s);
  if (err == cudaSuccess) err = launch<DP, false>(m, a, batch, s);
  return err;
}

}  // namespace

namespace lkgd {

int flash_f32_block_rows(int d) { return block_rows(d); }

int flash_f32_smem_bytes(int d) {
  return d <= 64    ? Plan<64>::smem_bytes
         : d <= 128 ? Plan<128>::smem_bytes
         : d <= 256 ? Plan<256>::smem_bytes
                    : Plan<512>::smem_bytes;
}

int flash_f32_stages(int d) {
  return d <= 64 ? Plan<64>::NS : d <= 128 ? Plan<128>::NS : d <= 256 ? Plan<256>::NS : Plan<512>::NS;
}

long long flash_f32_scratch_floats(int batch, int heads, int s_q, int s_k, int d) {
  return scratch_layout(nullptr, batch * heads, s_q, s_k, d).floats;
}

cudaError_t flash_key_sq_max_f32(const float* k, const Strides& ks, int batch, int heads, int s_k,
                                 int d, float* out, cudaStream_t stream) {
  return key_sq_max_f32(k, ks, batch, heads, s_k, d, out, stream);
}

// The fp32 forward of lkgd_flash_forward: q, k, v, o (B, S, H, D) fp32 with (b, s, h)
// element strides st[0..3]; `scratch`: flash_f32_scratch_floats floats (the planes of the
// pre-pass, |q_i|^2, the squared key norms, the tile minimums). bound: the pre-pass, the
// key norms, kernel 1 and kernel 2 as its guard; else the pre-pass and kernel 2 alone.
// lse: (B*H, s_q) fp32 written beside o (kernels 7 and 8), or null.
cudaError_t flash_forward_f32(const void* q, const void* k, const void* v, void* o,
                              const Strides* st, int batch, int heads, int s_q, int s_k, int d,
                              float scale_log2, float* scratch, int* recomputed, float* lse,
                              bool bound, cudaStream_t s) {
  SplitArgs in;
  in.q = static_cast<const float*>(q);
  in.k = static_cast<const float*>(k);
  in.v = static_cast<const float*>(v);
  in.qs = st[0];
  in.ks = st[1];
  in.vs = st[2];
  in.heads = heads;
  in.s_q = s_q;
  in.s_k = s_k;
  in.d = d;
  in.s_kp = (s_k + 31) / 32 * 32;
  F32Args a;
  a.o = static_cast<float*>(o);
  a.os = st[3];
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_q_tiles = (s_q + block_rows(d) - 1) / block_rows(d);
  a.scale_log2 = scale_log2;
  a.q_sq = nullptr;
  a.k_sq_max = nullptr;
  a.tile_min = nullptr;
  a.recomputed = recomputed;
  a.lse = lse;
  const Scratch sc = scratch_layout(scratch, batch * heads, s_q, s_k, d);
  if (d <= 64) return forward<64>(in, a, batch, sc, bound, s);
  if (d <= 128) return forward<128>(in, a, batch, sc, bound, s);
  if (d <= 256) return forward<256>(in, a, batch, sc, bound, s);
  return forward<512>(in, a, batch, sc, bound, s);
}

}  // namespace lkgd
