// Flash-attention backward at fp32 (kernels 9 and 10 on fp32 operands): fp32 q, k, v, dO, lse
// and delta in, fp32 dq, dk, dv out, every product fp32-accurate. lkgd_flash_bwd_f32 launches
// it, one C call for dq, dk/dv or both; flash_attention_bwd.cu holds the bf16 forms.
//
// Replaces, for fp32 operands, the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py
// that _flash_bwd_bhsd drives under the custom VJP _flash_core, whose bodies take fp32
// operands with fp32 accumulation (the JAX SVD fine-tune CLI builds its UNet in fp32, and
// the spatial attention of levels 0 and 1 runs there at 4096 and 1024 tokens, D = 64):
//   * flash_bwd_dq_tf32_kernel ports _flash_bwd_dq_kernel (kernel 9):
//       P = exp2(s * scale * log2e - lse),  dS = P o (dO V^T - delta),  dQ = scale * dS K;
//   * flash_bwd_dkv_tf32_kernel ports _flash_bwd_dkv_kernel (kernel 10):
//       dV = P^T dO,  dK = scale * dS^T Q.
// lse is the forward's log2-domain logsumexp (B*H, S_q) and delta = rowsum(dO o O) (B*H,
// S_q), both fp32, computed in PyTorch as JAX does. These kernels take D <= 64 (the fp32 UNet's
// heads); 64 < D <= 512 runs flash_bwd_tf32_wide_kernel below, the same arithmetic in the
// bf16 wide kernel's design.
//
// Arithmetic, 3xTF32, as the fp32 forward (flash_attention_f32.cu): each fp32 operand x is
// split into hi = x rounded to tf32 (cvt.rna) and lo = x - hi, and each product is lo.hi +
// hi.lo + hi.hi on wgmma.mma_async m64n64k8 .tf32. P and dS (P^T and dS^T) are split in
// registers after they are formed. The tensor core's accumulator truncates each sum, so:
//   * S and dP (S^T and dP^T) keep hi.hi and the two small products in two accumulators
//     each, added in fp32 at the end;
//   * every streamed tile's contribution to dQ, dK and dV goes to a fresh accumulator (24
//     truncated sums), then to fp32 running sums with an FFMA: at 4096 rows a single
//     accumulator would see 3 * 4096 / 8 truncated sums.
// That holds the gradients at 1.3-2.4e-6 of max|ref| at unit norms (2e-5 on the guard
// input, norms x4), in tests/test_torch_flash_f32_train.py's emulation; one TF32 product
// would put 3e-3 to 4e-2 there.
//
// The tf32 layout rule: wgmma takes 32-bit operands K-major only. S = Q K^T, dP = dO V^T,
// S^T = K Q^T and dP^T = V dO^T have both operands K-major as the tensors lie, but dQ += dS K,
// dV += P^T dO and dK += dS^T Q want K^T, dO^T and Q^T as their B operands. So a pre-pass
// (bwd_split_kernel, replacing no TPU kernel: it exists for that rule), launched first from the
// same call, writes hi and lo planes into the wrapper's scratch at D padded to DP (64, 128,
// 256 or 512; a block of the pre-pass a 64-column block of D): Q, dO (B*H, S_q, DP), K, V
// (B*H, S_k, DP), and for dq K^T (B*H, DP, S_k rounded up to 32), for dk/dv Q^T and dO^T (B*H,
// DP, S_q rounded up), zeros past D and past S: 14 planes for the pair, each input read once
// more for its transpose. The transposed planes keep their sequence permuted [0, 2, 4, 6, 1,
// 3, 5, 7] in every 8 (tf32_perm), so that the S / dS (S^T, P^T / dS^T) accumulator registers
// are the A operand of the next product as they stand.
//
// The narrow kernels (D <= 64) have the structure of the bf16 backward (flash_attention_bwd.cu)
// at D <= 128, in units of the forward's ring (64 rows x 32 fp32 of a hi plane and of its lo
// plane, 16 KB):
//   * the TPU's two-kernel split, no atomics: each output written once, deterministic;
//   * three warpgroups. A producer warp loads the block's 128 resident rows once (Q and dO
//     hi and lo for dq, K and V for dk/dv: 128 KB) and keeps a 6-unit ring in flight by
//     TMA: for each 64-key tile K (2 units), V (2), K^T (2) for dq; for each 64-query tile Q,
//     dO, dO^T, Q^T (8 units) for dk/dv, whose producer warp also copies the tile's 64 lse
//     and delta into one of two slots (queries past S_q: lse = +inf, delta = 0). Consumers
//     release every unit (8 warp arrivals), with no block-wide barrier in the loop;
//   * two consumer warpgroups of 64 resident rows each, setmaxnreg moving registers to them
//     (240 each, 24 to the producer). A tile: S and dP (S^T and dP^T) as two wgmma groups,
//     the first group's units released as soon as it is done; P and dS in registers; then
//     the accumulating products, their B units released when done. The warpgroups overlap
//     each other's arithmetic; inside one the products and the arithmetic take turns.
// Register budget, a consumer thread (an m64n64 fp32 accumulator is 32): dq keeps its running
// dQ (32), the tile's four score accumulators (128), dS's A operands hi and lo (64) in their
// place and the fresh accumulator (32): ~160 at most. dk/dv keeps dK and dV (64), the four
// score accumulators (128), then P^T's A operands (64) beside dS^T in fp32 (32) and the fresh
// accumulator (32), dV's product before dK's: ~192 at most, under the 240.
//
// Masks: keys past S_k get P = 0 in dq (the last tile peeled: the loop's body has no branch
// on the tile's number); queries past S_q get lse = +inf and delta = 0 in dk/dv, so P = 0
// and dS = 0; rows past the end and columns past D are not written (zero planes past D).
//
// What bounds it on the H100: tensor-core operations, three TF32 products at 495 TFLOP/s of
// 3 S^2 D (dq) and 4 S^2 D (dk/dv) multiply-adds per batch and head: 2.733 + 3.644 ms at the
// fine-tune's level 0 (14, 4096, 5, 64), against 6.731 + 8.975 ms for the same products as
// fp32 FMAs at 67 TFLOP/s. Each (128-row block, 64-row tile) pair streams 96 KB (dq) or 128
// KB (dk/dv) of hi and lo from L2 for 9.4 or 12.6 MFLOP: ~100 operations a byte. The wide
// kernels' 64-row blocks stream twice that a flop (dq at D = 128: 192 KB for 9.4 MFLOP).

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using lkgd::Strides;
using namespace lkgd::sm90;

// ---------------------------------------------------------------- 3xTF32 wgmma kernels
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kRows = 128;       // resident rows a block: 64 a consumer warpgroup
constexpr int kTile = 64;        // rows of a streamed tile
constexpr int kDP = 64;          // D padded: the tf32 kernels take D <= 64
constexpr int kND = kDP / kUnitCols;  // depth units of a row block
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use
constexpr int kLseSlots = 2;          // dk/dv: the lse and delta of two query tiles

template <bool DKV>
struct TPlan {
  // two resident tensors (Q and dO, or K and V), 128 rows, hi and lo
  static constexpr int res_bytes = 2 * (kRows / 64) * kND * kUnitBytes;
  static constexpr int row_bytes = DKV ? kLseSlots * 2 * kTile * 4 : 0;
  // ring units: what is left after 1024 bytes of alignment slack and 512 for barriers
  static constexpr int NS = (kSmemLimit - 1536 - res_bytes - row_bytes) / kUnitBytes;
  static constexpr int bar_bytes = 8 * (1 + 2 * NS);
  static constexpr int smem_bytes = kAtomBytes + res_bytes + row_bytes + NS * kUnitBytes + bar_bytes;
};
// the dk/dv producer writes tile i's lse into slot i % 2 once it holds the slot of tile i's
// first unit, which a ring of fewer than 8 units frees only after tile i - 1 began: tile i - 2
// has been read by then
static_assert(TPlan<true>::NS < 8, "the lse slots assume less than a tile of units in the ring");

// D padded: 64, the narrow kernels' width, or the wide kernels' 128, 256 or 512
inline int pad_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 512; }

// The scratch of the pre-pass (floats; every plane 16-byte aligned: DP % 64 == 0 and s_qp,
// s_kp % 32 == 0).
struct TScratch {
  float *qh, *ql, *oh, *ol;          // (B*H, s_q, DP): Q, dO
  float *kh, *kl, *vh, *vl;          // (B*H, s_k, DP): K, V
  float *kth, *ktl;                  // (B*H, DP, s_kp): K^T, keys permuted (dq)
  float *qth, *qtl, *oth, *otl;      // (B*H, DP, s_qp): Q^T, dO^T, queries permuted (dk/dv)
  long long floats;
};

__host__ __device__ inline int round32(int s) { return (s + 31) / 32 * 32; }

TScratch tscratch(float* base, int bh, int s_q, int s_k, int dp) {
  const long long qp = (long long)bh * s_q * dp, kp = (long long)bh * s_k * dp,
                  ktp = (long long)bh * dp * round32(s_k), qtp = (long long)bh * dp * round32(s_q);
  TScratch sc;
  sc.floats = 4 * qp + 4 * kp + 2 * ktp + 4 * qtp;
  if (base == nullptr) return sc;
  float* x = base;
  for (float** plane : {&sc.qh, &sc.ql, &sc.oh, &sc.ol}) { *plane = x; x += qp; }
  for (float** plane : {&sc.kh, &sc.kl, &sc.vh, &sc.vl}) { *plane = x; x += kp; }
  for (float** plane : {&sc.kth, &sc.ktl}) { *plane = x; x += ktp; }
  for (float** plane : {&sc.qth, &sc.qtl, &sc.oth, &sc.otl}) { *plane = x; x += qtp; }
  return sc;
}

enum Which { kDq = 1, kDkv = 2 };

struct TSplitArgs {
  const float *q, *k, *v, *o;  // o: dO
  Strides qs, ks, vs, os;
  int heads, s_q, s_k, d, which;
};

// The pre-pass: rows r0..r0+31 x columns c0..c0+63 (blockIdx.z: DP / 64 column blocks) of
// q, dO, k and v of one (batch, head) into their hi and lo planes (16-byte loads and stores
// along the rows), and their transposes where the launched kernels want them (through shared
// memory, 64 columns of D x 32 rows, written 32 positions a warp).
__global__ void __launch_bounds__(256) bwd_split_kernel(const TSplitArgs a, const TScratch sc) {
  __shared__ float tile[32][64 + 1];
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int r0 = blockIdx.x * 32, c0 = blockIdx.z * 64;
  const int dp = gridDim.z * 64;

  auto rows = [&](const float* x, const Strides& st, int s, float* hi, float* lo) {
    const float* xb = x + b * st.b + h * st.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + 256 * i, row = r0 + e / 16, c = c0 + (e % 16) * 4;
      if (row >= s) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < a.d) v = __ldg(reinterpret_cast<const float4*>(xb + (long long)row * st.s + c));
      const float4 vh = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                                    tf32_round(v.w));
      const long long out = ((long long)bh * s + row) * dp + c;
      *reinterpret_cast<float4*>(hi + out) = vh;
      *reinterpret_cast<float4*>(lo + out) =
          make_float4(v.x - vh.x, v.y - vh.y, v.z - vh.z, v.w - vh.w);
    }
  };
  auto cols = [&](const float* x, const Strides& st, int s, float* hi, float* lo) {
    const float* xb = x + b * st.b + h * st.h;
    const int s_p = round32(s);
    __syncthreads();  // the last transpose's reads of the tile are done
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + 256 * i, row = e / 16, c = (e % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + row < s && c0 + c < a.d)
        v = __ldg(reinterpret_cast<const float4*>(xb + (long long)(r0 + row) * st.s + c0 + c));
      tile[row][c] = v.x;
      tile[row][c + 1] = v.y;
      tile[row][c + 2] = v.z;
      tile[row][c + 3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = threadIdx.x + 256 * i, col = e / 32, p = e % 32;
      const float val = tile[tf32_perm(p)][col];
      const float vh = tf32_round(val);
      const long long out = ((long long)bh * dp + c0 + col) * s_p + r0 + p;
      hi[out] = vh;
      lo[out] = val - vh;
    }
  };
  if (r0 < a.s_q) {
    rows(a.q, a.qs, a.s_q, sc.qh, sc.ql);
    rows(a.o, a.os, a.s_q, sc.oh, sc.ol);
  }
  if (r0 < a.s_k) {
    rows(a.k, a.ks, a.s_k, sc.kh, sc.kl);
    rows(a.v, a.vs, a.s_k, sc.vh, sc.vl);
  }
  if ((a.which & kDq) && r0 < a.s_k) cols(a.k, a.ks, a.s_k, sc.kth, sc.ktl);
  if ((a.which & kDkv) && r0 < a.s_q) {
    cols(a.q, a.qs, a.s_q, sc.qth, sc.qtl);
    cols(a.o, a.os, a.s_q, sc.oth, sc.otl);
  }
}

struct TArgs {
  const float* lse;    // (B*H, s_q) log2 domain
  const float* delta;  // (B*H, s_q)
  float *dq, *dk, *dv;
  Strides dqs, dks, dvs;
  int heads, s_q, s_k, d, n_tiles;  // n_tiles: blocks along the block's own rows per (b, h)
  int n_slices;      // blocks along the output's columns (the wide kernels; else 1)
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 * log2(e), as the forward that wrote lse used it
};

// the planes' tensor maps: the row planes, then the transposed ones (dq: t = K^T; dk/dv:
// t = dO^T, t2 = Q^T)
struct TMaps {
  CUtensorMap qh, ql, oh, ol, kh, kl, vh, vl, th, tl, t2h, t2l;
};

// Store rows r0 + g and r0 + g + 8 of a warp's m64n64 accumulator times `mul`, columns < d and
// rows < s_total only.
__device__ __forceinline__ void store_rows(float* base, long long row_stride, int r0, int s_total,
                                           int d, const float (&acc)[32], float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s_total) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < d)
        *reinterpret_cast<float2*>(base + (long long)row * row_stride + col) =
            make_float2(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// The accumulator's element 4 n + e (row half e >> 1, column 8 n + 2 t4 + (e & 1)) as the
// register A operand of k8 step n over a permuted plane: a[0] row g depth t4, a[1] row g + 8
// depth t4, a[2] row g depth t4 + 4, a[3] row g + 8 depth t4 + 4.
__device__ __forceinline__ int a_slot(int n, int e) { return 4 * n + ((e & 1) << 1) + (e >> 1); }

// x split into its A operands, hi and lo, at slot `at`
__device__ __forceinline__ void split_to(uint32_t* hi, uint32_t* lo, int at, float x) {
  const float h = tf32_round(x);
  hi[at] = __float_as_uint(h);
  lo[at] = __float_as_uint(x - h);
}

__device__ __forceinline__ uint64_t udesc(uint32_t addr) { return smem_desc(addr, 16, kAtomBytes); }

// big (+)= A_hi . B_hi and small (+)= A_lo . B_hi + A_hi . B_lo over one depth unit (four k8
// steps): A a resident unit, B a ring unit, both K-major; `first_big`, `first_small`: the
// first unit of each sum
__device__ __forceinline__ void unit_ss(float (&big)[32], float (&small)[32], uint32_t a, uint32_t b,
                                        bool first_big, bool first_small) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = kk * 32;
    wgmma_tf32_ss(small, udesc(a + kPlaneBytes + off), udesc(b + off),
                  (!first_small || kk != 0) ? 1 : 0);
    wgmma_tf32_ss(small, udesc(a + off), udesc(b + kPlaneBytes + off), 1);
    wgmma_tf32_ss(big, udesc(a + off), udesc(b + off), (!first_big || kk != 0) ? 1 : 0);
  }
}

// acc (+)= A . B over one unit of B (32 rows of the depth, four k8 steps): A the registers of
// steps 4 c .. 4 c + 3, hi and lo; B a ring unit of a transposed plane (K-major)
__device__ __forceinline__ void unit_rs(float (&acc)[32], const uint32_t* ah, const uint32_t* al,
                                        uint32_t b, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int step = 4 * c + kk;
    const uint32_t off = kk * 32;
    wgmma_tf32_rs(acc, al + 4 * step, udesc(b + off), (c | kk) != 0);
    wgmma_tf32_rs(acc, ah + 4 * step, udesc(b + kPlaneBytes + off), 1);
    wgmma_tf32_rs(acc, ah + 4 * step, udesc(b + off), 1);
  }
}

// The part of a consumer the two kernels share: its place, the ring's bookkeeping.
struct Consumer {
  uint32_t ring, full0, empty0;
  int wg, lane, g, t4, row_in_tile;
  template <int NS>
  __device__ __forceinline__ void wait(int x) const {
    mbar_wait(full0 + 8 * (x % NS), (x / NS) & 1);
  }
  template <int NS>
  __device__ __forceinline__ uint32_t at(int x) const { return ring + (x % NS) * kUnitBytes; }
  template <int NS>
  __device__ __forceinline__ void release(int x) const {  // ring unit x is read no more here
    if (lane == 0) mbar_arrive(empty0 + 8 * (x % NS));
  }
};

__device__ __forceinline__ Consumer consumer(uint32_t ring, uint32_t full0, uint32_t empty0) {
  Consumer c;
  c.ring = ring;
  c.full0 = full0;
  c.empty0 = empty0;
  c.wg = threadIdx.x / 128;
  c.lane = threadIdx.x % 32;
  c.g = c.lane >> 2;
  c.t4 = c.lane & 3;
  c.row_in_tile = c.wg * 64 + ((threadIdx.x / 32) % 4) * 16 + c.g;  // this row and + 8
  return c;
}

// The producer's load of ring unit x: a box of the hi plane and the same box of the lo plane
template <int NS>
__device__ __forceinline__ void load_unit(uint32_t ring, uint32_t full0, uint32_t empty0, int x,
                                          const CUtensorMap* hi, const CUtensorMap* lo, int c0,
                                          int c1, int bh, bool waited = false) {
  const int slot = x % NS, use = x / NS;
  if (use > 0 && !waited) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
  const uint32_t bar = full0 + 8 * slot, dst = ring + slot * kUnitBytes;
  mbar_arrive_expect_tx(bar, kUnitBytes);
  tma_load_4d(dst, hi, bar, c0, c1, bh, 0);
  tma_load_4d(dst + kPlaneBytes, lo, bar, c0, c1, bh, 0);
}

// the two resident tensors' hi and lo, 128 rows from r0, onto one barrier
__device__ __forceinline__ void load_resident(uint32_t s0, uint32_t s1, const CUtensorMap* h0,
                                              const CUtensorMap* l0, const CUtensorMap* h1,
                                              const CUtensorMap* l1, uint32_t bar, int r0,
                                              int bh) {
  mbar_arrive_expect_tx(bar, TPlan<false>::res_bytes);
#pragma unroll
  for (int rb = 0; rb < kRows / 64; ++rb)
#pragma unroll
    for (int p = 0; p < kND; ++p) {
      const uint32_t off = (rb * kND + p) * kUnitBytes;
      tma_load_4d(s0 + off, h0, bar, p * kUnitCols, r0 + 64 * rb, bh, 0);
      tma_load_4d(s0 + off + kPlaneBytes, l0, bar, p * kUnitCols, r0 + 64 * rb, bh, 0);
      tma_load_4d(s1 + off, h1, bar, p * kUnitCols, r0 + 64 * rb, bh, 0);
      tma_load_4d(s1 + off + kPlaneBytes, l1, bar, p * kUnitCols, r0 + 64 * rb, bh, 0);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ TMaps m, const TArgs a) {
  using P = TPlan<false>;
  constexpr int NS = P::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sO = sQ + P::res_bytes / 2;
  const uint32_t ring = sQ + P::res_bytes;
  const uint32_t res_full = ring + NS * kUnitBytes;
  const uint32_t full0 = res_full + 8, empty0 = full0 + 8 * NS;

  const int bh = blockIdx.x / a.n_tiles;
  const int q0 = (blockIdx.x % a.n_tiles) * kRows;
  const int n_tiles = (a.s_k + kTile - 1) / kTile;

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
    reg_dealloc<24>();  // 2 x 128 x 240 + 128 x 24 registers: the SM's 64 K
    if (threadIdx.x == kConsumers) {
      load_resident(sQ, sO, &m.qh, &m.ql, &m.oh, &m.ol, res_full, q0, bh);
      // the units in the order the consumers take them: K (S), V (dP), K^T (dS K)
      int x = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int p = 0; p < kND; ++p)
          load_unit<NS>(ring, full0, empty0, x++, &m.kh, &m.kl, p * kUnitCols, j * kTile, bh);
        for (int p = 0; p < kND; ++p)
          load_unit<NS>(ring, full0, empty0, x++, &m.vh, &m.vl, p * kUnitCols, j * kTile, bh);
        for (int c = 0; c < kTile / kUnitCols; ++c)
          load_unit<NS>(ring, full0, empty0, x++, &m.th, &m.tl, j * kTile + c * kUnitCols, 0, bh);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<240>();
    const Consumer cs = consumer(ring, full0, empty0);
    const int t4 = cs.t4;

    // lse and delta of this thread's two rows; rows past S_q (never stored) get P = 0
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cs.row_in_tile + 8 * r;
      const bool ok = row < a.s_q;
      lse_r[r] = ok ? a.lse[(long long)bh * a.s_q + row] : INFINITY;
      delta_r[r] = ok ? a.delta[(long long)bh * a.s_q + row] : 0.f;
    }
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    mbar_wait(res_full, 0);

    int u = 0;  // the tile's first ring unit, in the producer's order
    // One key tile; `last` (a std::bool_constant) marks the tile that may be ragged: the
    // loop's body has no branch on the tile's number.
    auto tile = [&](int j, auto last) {
      constexpr bool LAST = decltype(last)::value;
      const int uk = u, uv = u + kND, ut = u + 2 * kND;
      u += 2 * kND + kTile / kUnitCols;
      // 1. S = Q . K_j^T and dP = dO . V_j^T over the depth, two groups
      float sb[32], ss[32], pb[32], ps[32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kND; ++p) {
        cs.wait<NS>(uk + p);
        unit_ss(sb, ss, sQ + (cs.wg * kND + p) * kUnitBytes, cs.at<NS>(uk + p), p == 0, p == 0);
      }
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < kND; ++p) {
        cs.wait<NS>(uv + p);
        unit_ss(pb, ps, sO + (cs.wg * kND + p) * kUnitBytes, cs.at<NS>(uv + p), p == 0, p == 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < kND; ++p) cs.release<NS>(uk + p);
      wgmma_wait<0>();
      reg_fence(sb);
      reg_fence(ss);
      reg_fence(pb);
      reg_fence(ps);
#pragma unroll
      for (int p = 0; p < kND; ++p) cs.release<NS>(uv + p);
      // 2. dS in the exp2 domain, split into its A operands; keys past S_k: P = 0
      uint32_t ah[32], al[32];
      const int k0 = j * kTile;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e, r = e >> 1;
          float s = sb[i] + ss[i];
          if (LAST && k0 + 8 * n + 2 * t4 + (e & 1) >= a.s_k) s = -INFINITY;
          const float ds = ex2(fmaf(s, a.scale_log2, -lse_r[r])) * ((pb[i] + ps[i]) - delta_r[r]);
          split_to(ah, al, a_slot(n, e), ds);
        }
      // 3. this tile's dS . K_j into a fresh accumulator, then into dq in fp32
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) {
        cs.wait<NS>(ut + c);
        unit_rs(acc, ah, al, cs.at<NS>(ut + c), c);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) cs.release<NS>(ut + c);
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] += acc[i];
    };
    for (int j = 0; j + 1 < n_tiles; ++j) tile(j, std::false_type{});
    tile(n_tiles - 1, std::true_type{});

    const int b = bh / a.heads, h = bh % a.heads;
    store_rows(a.dq + b * a.dqs.b + h * a.dqs.h, a.dqs.s, q0 + cs.row_in_tile, a.s_q, a.d, dq,
               a.scale, t4);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ TMaps m, const TArgs a) {
  using P = TPlan<true>;
  constexpr int NS = P::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t sV = sK + P::res_bytes / 2;
  const uint32_t ring = sK + P::res_bytes;
  const uint32_t rows = ring + NS * kUnitBytes;
  const uint32_t res_full = rows + P::row_bytes;
  const uint32_t full0 = res_full + 8, empty0 = full0 + 8 * NS;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (rows - raw));  // (kLseSlots, kTile)
  float* delta_s = lse_s + kLseSlots * kTile;                         // (kLseSlots, kTile)

  const int bh = blockIdx.x / a.n_tiles;
  const int k0 = (blockIdx.x % a.n_tiles) * kRows;
  const int n_tiles = (a.s_q + kTile - 1) / kTile;
  constexpr int kUnitsPerTile = 2 * kND + 2 * (kTile / kUnitCols);

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
    reg_dealloc<24>();
    if (threadIdx.x < kConsumers + 32) {  // its first warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) load_resident(sK, sV, &m.kh, &m.kl, &m.vh, &m.vl, res_full, k0, bh);
      const float* lse = a.lse + (long long)bh * a.s_q;
      const float* delta = a.delta + (long long)bh * a.s_q;
      // the units in the order the consumers take them: Q (S^T), dO (dP^T), dO^T (P^T dO),
      // Q^T (dS^T Q)
      for (int i = 0; i < n_tiles; ++i) {
        const int x = i * kUnitsPerTile, slot = x % NS, use = x / NS;
        if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
        // the tile's lse and delta beside its first unit; queries past S_q: P = 0, dS = 0
        float* l = lse_s + (i % kLseSlots) * kTile;
        float* dl = delta_s + (i % kLseSlots) * kTile;
#pragma unroll
        for (int r = lane; r < kTile; r += 32) {
          const int row = i * kTile + r;
          const bool ok = row < a.s_q;
          l[r] = ok ? lse[row] : INFINITY;
          dl[r] = ok ? delta[row] : 0.f;
        }
        __threadfence_block();
        __syncwarp();  // the warp's stores before lane 0's arrive (release) on the full barrier
        if (lane == 0) {
          const int q0 = i * kTile;
          for (int p = 0; p < kND; ++p)
            load_unit<NS>(ring, full0, empty0, x + p, &m.qh, &m.ql, p * kUnitCols, q0, bh,
                          p == 0);
          for (int p = 0; p < kND; ++p)
            load_unit<NS>(ring, full0, empty0, x + kND + p, &m.oh, &m.ol, p * kUnitCols, q0, bh);
          for (int c = 0; c < kTile / kUnitCols; ++c)
            load_unit<NS>(ring, full0, empty0, x + 2 * kND + c, &m.th, &m.tl,
                          q0 + c * kUnitCols, 0, bh);
          for (int c = 0; c < kTile / kUnitCols; ++c)
            load_unit<NS>(ring, full0, empty0, x + 2 * kND + 2 + c, &m.t2h, &m.t2l,
                          q0 + c * kUnitCols, 0, bh);
        }
        __syncwarp();
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<240>();
    const Consumer cs = consumer(ring, full0, empty0);
    const int t4 = cs.t4;

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(res_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int uq = i * kUnitsPerTile, uo = uq + kND, uot = uq + 2 * kND, uqt = uot + 2;
      // 1. S^T = K . Q_i^T and dP^T = V . dO_i^T (keys x queries), two groups
      float sb[32], ss[32], pb[32], ps[32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kND; ++p) {
        cs.wait<NS>(uq + p);
        unit_ss(sb, ss, sK + (cs.wg * kND + p) * kUnitBytes, cs.at<NS>(uq + p), p == 0, p == 0);
      }
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < kND; ++p) {
        cs.wait<NS>(uo + p);
        unit_ss(pb, ps, sV + (cs.wg * kND + p) * kUnitBytes, cs.at<NS>(uo + p), p == 0, p == 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < kND; ++p) cs.release<NS>(uq + p);
      wgmma_wait<0>();
      reg_fence(sb);
      reg_fence(ss);
      reg_fence(pb);
      reg_fence(ps);
#pragma unroll
      for (int p = 0; p < kND; ++p) cs.release<NS>(uo + p);
      // 2. P^T split into its A operands, dS^T kept in fp32: element 4 n + e is query column
      // 8 n + 2 t4 + (e & 1)
      const float* l = lse_s + (i % kLseSlots) * kTile + 2 * t4;
      const float* dl = delta_s + (i % kLseSlots) * kTile + 2 * t4;
      uint32_t ah[32], al[32];
      float ds[32];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lv = *reinterpret_cast<const float2*>(l + 8 * n);
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * n + e;
          const float p = ex2(fmaf(sb[x] + ss[x], a.scale_log2, -((e & 1) ? lv.y : lv.x)));
          ds[x] = p * ((pb[x] + ps[x]) - ((e & 1) ? dv2.y : dv2.x));
          split_to(ah, al, a_slot(n, e), p);
        }
      }
      // 3. dV += P^T . dO_i, a fresh accumulator added in fp32
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) {
        cs.wait<NS>(uot + c);
        unit_rs(acc, ah, al, cs.at<NS>(uot + c), c);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) cs.release<NS>(uot + c);
#pragma unroll
      for (int x = 0; x < 32; ++x) dv[x] += acc[x];
      // 4. dK += dS^T . Q_i, the same way
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_to(ah, al, a_slot(n, e), ds[4 * n + e]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) {
        cs.wait<NS>(uqt + c);
        unit_rs(acc, ah, al, cs.at<NS>(uqt + c), c);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int c = 0; c < kTile / kUnitCols; ++c) cs.release<NS>(uqt + c);
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[x] += acc[x];
    }

    const int b = bh / a.heads, h = bh % a.heads;
    store_rows(a.dk + b * a.dks.b + h * a.dks.h, a.dks.s, k0 + cs.row_in_tile, a.s_k, a.d, dk,
               a.scale, t4);
    store_rows(a.dv + b * a.dvs.b + h * a.dvs.h, a.dvs.s, k0 + cs.row_in_tile, a.s_k, a.d, dv,
               1.f, t4);
  }
}

// ---------------------------------------------------------------- 64 < D <= 512
// flash_bwd_tf32_wide_kernel<DP, DKV> (DP 128, 256 or 512), kernels 9 (DKV=false) and 10 in
// one template: the bf16 wide kernel's design (flash_attention_bwd.cu) in the 3xTF32
// arithmetic above. 128 resident rows of two tensors' hi and lo are 256 KB at D = 128, and
// dk and dv beside four score accumulators are 256 registers a thread, so a block keeps 64
// resident rows and gives its two consumer warpgroups two roles that share one score tile:
//   * dq: warpgroup 0 forms S = Q K^T and P, warpgroup 1 dP = dO V^T and, from P, dS; each
//     accumulates dQ += dS K over its half of the block's columns;
//   * dk/dv: warpgroup 0 forms S^T = K Q^T and P^T and accumulates dV += P^T dO, warpgroup 1
//     forms dP^T = V dO^T and, from P^T, dS^T, and accumulates dK += dS^T Q.
// A warpgroup keeps at most 128 output columns (64 running registers beside the score's 64,
// the A operand's 64 and a fresh 32-register accumulator), so the grid slices the columns:
// dq keeps 256 a block (two slices at D = 512: 5 products where one block would do 3), dk/dv
// 128 (two slices at D = 256: 6 products for 4; four at D = 512: 10 for 4). P (then dS, in
// place) crosses in a 16 KB buffer laid out [register][thread], ordered by two named barriers
// (the writer's bar.arrive, the reader's bar.sync). Each warpgroup has its own producer warp,
// ring of 16 KB units (six) and barriers. The score's A operand (Q or dO; K or V) streams
// unit by unit beside the score's B units, as do the accumulating product's B units (the
// transposed planes K^T (dq), dO^T and Q^T (dk/dv), 64 columns of D x 32 rows each): A kept
// resident at D = 128 (64 KB of hi and lo a warpgroup) leaves a ring of two units, and on the
// card the deeper ring won although it reads A again for every tile (the pair at
// (8,4096,2,128) 6.03 against 7.66 ms, in turns on one H100: experiments/flash_bwd_ab.py on
// the two builds). The hi.hi
// accumulator of a score restarts every 4 depth units (128 of D) and is added in fp32: the
// truncated sums of one accumulator over all of D = 512 would land near the 1e-4 the
// gradients are held to (the fp32 forward measured 2-4e-5 of max|ref| with one accumulator at
// D = 512). Masks and zero fill as in the narrow kernels.
constexpr int kXBytes = 32 * 128 * 4;  // the exchange: 32 fp32 a thread of one warpgroup
constexpr int kGroup = 4;              // depth units a hi.hi accumulator sums

template <int DP, bool DKV>
struct WPlan {
  static constexpr int ND = DP / kUnitCols;  // depth units of a row
  static constexpr int N = DKV ? (DP < 128 ? DP : 128) : (DP / 2 < 128 ? DP / 2 : 128);
  static constexpr int NC = N / 64;          // 64-column sets a warpgroup keeps
  static constexpr int W = DKV ? N : 2 * N;  // output columns a block
  // a warpgroup's ring: its half of what is left after 1024 bytes of alignment slack, the
  // exchange and 512 for barriers
  static constexpr int NS = (kSmemLimit - kAtomBytes - kXBytes - 512) / 2 / kUnitBytes;
  static constexpr int wg_bytes = NS * kUnitBytes;
  static constexpr int bar_bytes = 2 * 8 * 2 * NS;  // a warpgroup: a full and an empty a unit
  static constexpr int smem_bytes = kAtomBytes + 2 * wg_bytes + kXBytes + bar_bytes;
};

template <int DP, bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tf32_wide_kernel(const __grid_constant__ TMaps m, const TArgs a) {
  using P = WPlan<DP, DKV>;
  constexpr int ND = P::ND, NC = P::NC, NS = P::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t xch = base + 2 * P::wg_bytes;
  const uint32_t bars = xch + kXBytes;
  float* xf = reinterpret_cast<float*>(smem_raw + (xch - raw));

  const int slice = blockIdx.x % a.n_slices;  // column slices innermost: they share rows
  const int rest = blockIdx.x / a.n_slices;
  const int bh = rest / a.n_tiles;
  const int r0 = (rest % a.n_tiles) * 64;
  const int n_tiles = ((DKV ? a.s_q : a.s_k) + kTile - 1) / kTile;

  // this warpgroup's (consumer or producer) role, pipeline and first output column
  const int w = threadIdx.x < kConsumers ? threadIdx.x / 128 : (threadIdx.x - kConsumers) / 32;
  const uint32_t ring = base + (w & 1) * P::wg_bytes;
  const uint32_t full0 = bars + (w & 1) * 8 * 2 * NS, empty0 = full0 + 8 * NS;
  const int cc = slice * P::W + (DKV ? 0 : w * P::N);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * 2 * NS; ++i)
      // full barriers: the producer's arrive with the byte count; empty: lane 0 of each of the
      // warpgroup's four warps
      mbar_init(bars + 8 * i, (i % (2 * NS)) >= NS ? 4 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer warps 0 and 1
    reg_dealloc<24>();
    if (w < 2 && threadIdx.x % 32 == 0) {
      // dq: warpgroup 0 Q, K, K^T; 1 dO, V, K^T. dk/dv: 0 K, Q, dO^T; 1 V, dO, Q^T
      const CUtensorMap *a_hi, *a_lo, *b_hi, *b_lo, *c_hi, *c_lo;
      if (DKV) {
        a_hi = w ? &m.vh : &m.kh;
        a_lo = w ? &m.vl : &m.kl;
        b_hi = w ? &m.oh : &m.qh;
        b_lo = w ? &m.ol : &m.ql;
        c_hi = w ? &m.t2h : &m.th;
        c_lo = w ? &m.t2l : &m.tl;
      } else {
        a_hi = w ? &m.oh : &m.qh;
        a_lo = w ? &m.ol : &m.ql;
        b_hi = w ? &m.vh : &m.kh;
        b_lo = w ? &m.vl : &m.kl;
        c_hi = &m.th;
        c_lo = &m.tl;
      }
      int x = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int p = 0; p < ND; ++p) {
          load_unit<NS>(ring, full0, empty0, x++, a_hi, a_lo, p * kUnitCols, r0, bh);
          load_unit<NS>(ring, full0, empty0, x++, b_hi, b_lo, p * kUnitCols, t * kTile, bh);
        }
        for (int c = 0; c < NC; ++c)
          for (int u = 0; u < kTile / kUnitCols; ++u)
            load_unit<NS>(ring, full0, empty0, x++, c_hi, c_lo, t * kTile + u * kUnitCols,
                          cc + 64 * c, bh);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer warpgroups
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, t4 = lane & 3;
    const int row_in_tile = ((threadIdx.x / 32) % 4) * 16 + (lane >> 2);  // and + 8

    float o[NC][32];  // output columns cc .. cc + N, 64 a set
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
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
    auto wait = [&](int i) { mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1); };
    auto at = [&](int i) { return ring + (i % NS) * kUnitBytes; };
    auto release = [&](int i) {  // ring unit i is read no more by this warp
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % NS));
    };

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
            const int col = t * kTile + 8 * n + 2 * t4 + e;
            col_v[2 * n + e] = col < a.s_q ? src[col] : (w ? 0.f : INFINITY);
          }
      }
      // 1. the scores over the depth: a commit group a depth unit (its A and B ring units),
      // released once its group is done; hi.hi restarts every kGroup units into an fp32 sum
      float sb[32], ss[32], fold[32];
      auto release_unit = [&](int p) {
        release(x + 2 * p);
        release(x + 2 * p + 1);
      };
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < ND; ++p) {
        wait(x + 2 * p);
        wait(x + 2 * p + 1);
        unit_ss(sb, ss, at(x + 2 * p), at(x + 2 * p + 1), p % kGroup == 0, p == 0);
        wgmma_commit();
        if (p % kGroup != 0) {
          wgmma_wait<1>();
          release_unit(p - 1);
        }
        if (p % kGroup == kGroup - 1 || p == ND - 1) {
          wgmma_wait<0>();
          reg_fence(sb);
          reg_fence(ss);
          release_unit(p);
          if (ND > kGroup) {
#pragma unroll
            for (int i = 0; i < 32; ++i) fold[i] = (p < kGroup ? 0.f : fold[i]) + sb[i];
            wgmma_fence();  // sb was read: the next group writes it
          }
        }
      }
      x += 2 * ND;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = (ND > kGroup ? fold[i] : sb[i]) + ss[i];

      // 2. P and dS through the exchange: S or dP (dq), S^T or dP^T (dk/dv) -> this
      // warpgroup's A operand
      if (!DKV) {
        if (w == 0) {
          const int k0 = t * kTile;
          if (k0 + kTile > a.s_k) {  // keys past S_k: P = 0
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (k0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= a.s_k) sc[i] = -INFINITY;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i)
            xf[i * 128 + tid] = ex2(fmaf(sc[i], a.scale_log2, -lse_r[(i >> 1) & 1]));
          named_barrier_arrive(1, kConsumers);
          named_barrier_sync(2, kConsumers);  // dS is there
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = xf[i * 128 + tid];
        } else {
          named_barrier_sync(1, kConsumers);  // P is there
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            sc[i] = xf[i * 128 + tid] * (sc[i] - delta_r[(i >> 1) & 1]);
            xf[i * 128 + tid] = sc[i];  // over this thread's own P
          }
          named_barrier_arrive(2, kConsumers);
        }
      } else {
        if (w == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = ex2(fmaf(sc[i], a.scale_log2, -col_v[2 * (i >> 2) + (i & 1)]));
          if (t > 0) named_barrier_sync(2, kConsumers);  // the last tile's P^T is read
#pragma unroll
          for (int i = 0; i < 32; ++i) xf[i * 128 + tid] = sc[i];
          named_barrier_arrive(1, kConsumers);
        } else {
          named_barrier_sync(1, kConsumers);  // P^T is there
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = xf[i * 128 + tid] * (sc[i] - col_v[2 * (i >> 2) + (i & 1)]);
          if (t + 1 < n_tiles) named_barrier_arrive(2, kConsumers);
        }
      }
      uint32_t ah[32], al[32];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_to(ah, al, a_slot(n, e), sc[4 * n + e]);

      // 3. the accumulating product, a 64-column set at a time over its two 32-row units of
      // the transposed plane, into a fresh accumulator, then into the fp32 sums
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float acc[32];
        wgmma_fence();
        wait(x);
        unit_rs(acc, ah, al, at(x), 0);
        wgmma_commit();
        wait(x + 1);
        unit_rs(acc, ah, al, at(x + 1), 1);
        wgmma_commit();
        wgmma_wait<1>();
        release(x);
        wgmma_wait<0>();
        reg_fence(acc);
        release(x + 1);
        x += 2;
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] += acc[i];
      }
    }

    // dq, or dv (warpgroup 0) and dk (1)
    const int b = bh / a.heads, h = bh % a.heads;
    float* out = DKV ? (w ? a.dk : a.dv) : a.dq;
    const Strides& os = DKV ? (w ? a.dks : a.dvs) : a.dqs;
    const float mul = DKV && !w ? 1.f : a.scale;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cc + 64 * c;
      store_rows(out + b * os.b + h * os.h + col, os.s, r0 + row_in_tile, DKV ? a.s_k : a.s_q,
                 a.d - col, o[c], mul, t4);
    }
  }
}

template <bool DKV>
cudaError_t launch_tf32(const TMaps& m, TArgs a, int batch, cudaStream_t stream) {
  using P = TPlan<DKV>;
  auto kernel = DKV ? flash_bwd_dkv_tf32_kernel : flash_bwd_dq_tf32_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes);
  if (err != cudaSuccess) return err;
  a.n_tiles = ((DKV ? a.s_k : a.s_q) + kRows - 1) / kRows;
  a.n_slices = 1;
  const long long blocks = (long long)batch * a.heads * a.n_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, P::smem_bytes, stream>>>(m, a);
  return cudaGetLastError();
}

template <int DP, bool DKV>
cudaError_t launch_wide(const TMaps& m, TArgs a, int batch, cudaStream_t stream) {
  using P = WPlan<DP, DKV>;
  auto kernel = flash_bwd_tf32_wide_kernel<DP, DKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem_bytes);
  if (err != cudaSuccess) return err;
  a.n_tiles = ((DKV ? a.s_k : a.s_q) + 63) / 64;
  a.n_slices = (a.d + P::W - 1) / P::W;
  const long long blocks = (long long)batch * a.heads * a.n_tiles * a.n_slices;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, P::smem_bytes, stream>>>(m, a);
  return cudaGetLastError();
}

// the kernel of D padded to dp
template <bool DKV>
cudaError_t launch_by_width(const TMaps& m, const TArgs& a, int batch, int dp, cudaStream_t s) {
  if (dp == 64) return launch_tf32<DKV>(m, a, batch, s);
  if (dp == 128) return launch_wide<128, DKV>(m, a, batch, s);
  if (dp == 256) return launch_wide<256, DKV>(m, a, batch, s);
  return launch_wide<512, DKV>(m, a, batch, s);
}

// The pre-pass, then dq and dk/dv as `which` says, reading the planes through tensor maps.
cudaError_t backward_tf32(const TSplitArgs& in, const TArgs& a, int batch, float* scratch,
                          cudaStream_t s) {
  const int bh = batch * a.heads, dp = pad_d(a.d);
  if (bh > 65535) return cudaErrorInvalidValue;  // the pre-pass's grid
  const TScratch sc = tscratch(scratch, bh, a.s_q, a.s_k, dp);
  const dim3 grid(((a.s_q > a.s_k ? a.s_q : a.s_k) + 31) / 32, bh, dp / 64);
  bwd_split_kernel<<<grid, 256, 0, s>>>(in, sc);
  cudaError_t err = cudaGetLastError();
  TMaps m;
  const struct {
    CUtensorMap* map;
    const float* plane;
    int rows;
  } planes[] = {{&m.qh, sc.qh, a.s_q}, {&m.ql, sc.ql, a.s_q}, {&m.oh, sc.oh, a.s_q},
                {&m.ol, sc.ol, a.s_q}, {&m.kh, sc.kh, a.s_k}, {&m.kl, sc.kl, a.s_k},
                {&m.vh, sc.vh, a.s_k}, {&m.vl, sc.vl, a.s_k}};
  for (const auto& p : planes)
    if (err == cudaSuccess) err = f32_plane_map(p.map, p.plane, bh, p.rows, dp);
  if (in.which & kDq) {
    if (err == cudaSuccess) err = f32_plane_map(&m.th, sc.kth, bh, dp, round32(a.s_k));
    if (err == cudaSuccess) err = f32_plane_map(&m.tl, sc.ktl, bh, dp, round32(a.s_k));
    if (err == cudaSuccess) err = launch_by_width<false>(m, a, batch, dp, s);
  }
  if (in.which & kDkv) {
    if (err == cudaSuccess) err = f32_plane_map(&m.th, sc.oth, bh, dp, round32(a.s_q));
    if (err == cudaSuccess) err = f32_plane_map(&m.tl, sc.otl, bh, dp, round32(a.s_q));
    if (err == cudaSuccess) err = f32_plane_map(&m.t2h, sc.qth, bh, dp, round32(a.s_q));
    if (err == cudaSuccess) err = f32_plane_map(&m.t2l, sc.qtl, bh, dp, round32(a.s_q));
    if (err == cudaSuccess) err = launch_by_width<true>(m, a, batch, dp, s);
  }
  return err;
}

// A kernel's block for a head dim d: dynamic shared memory, ring units, column slices.
struct BlockInfo {
  int smem_bytes, stages, width;  // width: output columns a block
};

template <int DP, bool DKV>
BlockInfo wide_info() {
  using P = WPlan<DP, DKV>;
  return {P::smem_bytes, P::NS, P::W};
}

BlockInfo block_info(int d, int dkv) {
  switch (pad_d(d)) {
    case 64:
      return dkv ? BlockInfo{TPlan<true>::smem_bytes, TPlan<true>::NS, kDP}
                 : BlockInfo{TPlan<false>::smem_bytes, TPlan<false>::NS, kDP};
    case 128:
      return dkv ? wide_info<128, true>() : wide_info<128, false>();
    case 256:
      return dkv ? wide_info<256, true>() : wide_info<256, false>();
    default:
      return dkv ? wide_info<512, true>() : wide_info<512, false>();
  }
}

}  // namespace

extern "C" {

// Rows a block of the fp32 backward keeps resident (query rows for dq, keys for dk/dv), its
// dynamic shared memory, its ring's units, the grid's column slices and the scratch floats
// of the pre-pass, for a head dim d: the narrow kernels at d <= 64, the wide ones above.
int lkgd_flash_bwd_f32_block_rows(int d) { return d <= kDP ? kRows : 64; }

int lkgd_flash_bwd_f32_smem_bytes(int d, int dkv) { return block_info(d, dkv).smem_bytes; }

int lkgd_flash_bwd_f32_stages(int d, int dkv) { return block_info(d, dkv).stages; }

int lkgd_flash_bwd_f32_slices(int d, int dkv) {
  const int w = block_info(d, dkv).width;
  return (d + w - 1) / w;
}

long long lkgd_flash_bwd_f32_scratch_floats(int batch, int heads, int s_q, int s_k, int d) {
  return tscratch(nullptr, batch * heads, s_q, s_k, pad_d(d)).floats;
}

// lkgd_flash_bwd's arguments (flash_attention_bwd.cu) for fp32 tensors: q, k, v, dout, dq,
// dk, dv (B, S, H, D) fp32 with strides[21] = the (b, s, h) element strides of the seven;
// lse, delta (B*H, s_q) fp32. which: 1 the dq kernel (writes dq), 2 the dk/dv kernel (dk and
// dv), 3 both from one pre-pass. scratch: lkgd_flash_bwd_f32_scratch_floats floats. D a
// multiple of 8, <= 512; s_q and s_k at least 1; every row 16-byte aligned.
int lkgd_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       const long long* strides, int batch, int heads, int s_q, int s_k, int d,
                       float scale, float scale_log2, int which, float* scratch, int device,
                       void* stream) {
  if (d <= 0 || d > 512 || d % 8 != 0 || s_q <= 0 || s_k <= 0 || which < 1 || which > 3 ||
      scratch == nullptr)
    return int(cudaErrorInvalidValue);
  // cudaSetDevice also makes the device's context current on this thread, which
  // cuTensorMapEncodeTiled needs (autograd's backward thread may have none yet)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  TSplitArgs in;
  in.q = static_cast<const float*>(q);
  in.k = static_cast<const float*>(k);
  in.v = static_cast<const float*>(v);
  in.o = static_cast<const float*>(dout);
  in.qs = st[0];
  in.ks = st[1];
  in.vs = st[2];
  in.os = st[3];
  in.heads = heads;
  in.s_q = s_q;
  in.s_k = s_k;
  in.d = d;
  in.which = which;
  TArgs a;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dqs = st[4];
  a.dks = st[5];
  a.dvs = st[6];
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_tiles = a.n_slices = 0;  // set by each launch
  a.scale = scale;
  a.scale_log2 = scale_log2;
  return int(backward_tf32(in, a, batch, scratch, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
