// Variants of the bound-softmax flash-attention forward for Hopper (sm_90a), for A/B
// measurements of the levers inside the kernel: bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel _variant_kernel (driven by run_variant) of
// experiments/flash_variant_microbench.py. Given q, k, v (B*H, S, D) and the per-row bound
// t (B*H, S_q) in the log2 domain, each variant computes
//     p = exp2(scale*log2e * q.k + t),  out = (p . v) / rowsum(p)
// with no running max, no fallback and no logsumexp output:
//   * base              the bound form's arithmetic with nothing around it, on mma.sync
//                       (the production forward, flash_attention_wgmma.cu, runs it on wgmma);
//   * prescale          q arrives pre-multiplied by scale*log2e, the multiply is dropped;
//   * bf16exp           the scores are rounded to bf16 pairs and exponentiated two at a time
//                       with ex2.approx.ftz.bf16x2; the packed result is the P.V operand as
//                       it is, and the row sum is still taken in fp32;
//   * prescale_bf16exp  both;
//   * noexp             exp2 replaced by the identity: the floor of the tensor-core work and
//                       the bookkeeping (not a softmax; a measurement only).
// Query x key tile shapes are template parameters: 64x64 (the backward kernels'),
// 128x64, 64x128 and 128x128.
//
// What bounds it on the H100: tensor-core FLOPs, 4*S^2*D*B*H (3.04 TFLOP at (140, 9216,
// 64), 3.08 ms at the bf16 peak) against 33 MB of inputs. As in the backward kernels, one
// block per (batch*head, query tile) loops over K/V tiles streamed with cp.async into two
// stages of padded shared rows; each warp owns 16 query rows end to end, and scores,
// probabilities and the output accumulator stay in registers in the mma.sync m16n8k16
// layout (the pieces of flash_common.cuh). A ragged S is masked in the kernel.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace lkgd;

constexpr int kDP = 64;  // head dims up to 64, zero-padded in shared memory
constexpr int kPrescale = 1, kBf16Exp = 2, kNoExp = 4;  // bits of a mode

struct VariantArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long qb, qs, kb, ks, vb, vs, ob, os;  // batch and row strides in elements
  const float* t;                            // (B*H, s_q)
  int s_q, s_k, d, n_q_tiles;
  float scale_log2;
};

// rows [row0, row0 + ROWS) of a strided (S, D) slice -> a (ROWS, LD) shared tile, async;
// rows past s_total and columns past d are zero.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* base, long long row_stride,
                                                int row0, int s_total, int d) {
  constexpr int VPR = kDP / 8;
  constexpr int LD = RegTile<kDP>::LD;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = row0 + r < s_total && c < d;
    const bf16* src = ok ? base + (long long)(row0 + r) * row_stride + c : base;
    cp_async_16(dst + r * LD + c, src, ok);
  }
}

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
__global__ void __launch_bounds__(BQ * 2) flash_variant_kernel(const VariantArgs a) {
  constexpr int LD = RegTile<kDP>::LD;
  constexpr int NT = BQ * 2;    // one warp per 16 query rows
  constexpr int KC = kDP / 16;  // 16-wide chunks of D (Q K^T depth)
  constexpr int NS = BK / 8;    // 8-wide score tiles of a warp's 16 x BK scores
  constexpr int ND = kDP / 8;   // 8-wide output tiles
  constexpr bool PRESCALE = (MODE & kPrescale) != 0;
  constexpr bool BF16EXP = (MODE & kBf16Exp) != 0;
  constexpr bool NOEXP = (MODE & kNoExp) != 0;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;      // stages 0, 1
  bf16* sV = sK + 2 * BK * LD;  // stages 0, 1

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const bf16* qb = a.q + bh * a.qb;
  const bf16* kb = a.k + bh * a.kb;
  const bf16* vb = a.v + bh * a.vb;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  const int n_tiles = (a.s_k + BK - 1) / BK;

  load_rows_async<BQ, NT>(sQ, qb, a.qs, q0, a.s_q, a.d);
  load_rows_async<BK, NT>(sK, kb, a.ks, 0, a.s_k, a.d);
  load_rows_async<BK, NT>(sV, vb, a.vs, 0, a.s_k, a.d);
  cp_async_commit();

  // this thread's rows: wr + g (r = 0) and wr + g + 8 (r = 1)
  float l_r[2] = {0.f, 0.f}, t_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row < a.s_q) t_r[r] = a.t[(long long)bh * a.s_q + row];
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[KC][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_rows_async<BK, NT>(sK + (st ^ 1) * BK * LD, kb, a.ks, (j + 1) * BK, a.s_k, a.d);
      load_rows_async<BK, NT>(sV + (st ^ 1) * BK * LD, vb, a.vs, (j + 1) * BK, a.s_k, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) load_a_frag<LD>(qf[kc], sQ, wr, kc, g, t4);
    }
    const bf16* K = sK + st * BK * LD;
    const bf16* V = sV + st * BK * LD;

    // scores: a warp's 16 rows x BK keys, fp32 in registers
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* kp = K + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        mma_16816(s[n], qf[kc], lds32(kp), lds32(kp + 8));
      }
    }

    // log2-domain logits plus the bound; element e of a tile is row g + 8*(e/2). Keys past
    // the end contribute nothing: exp2(-inf) = 0, and 0 where there is no exp2.
    const int k0 = j * BK;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (PRESCALE ? s[n][e] : s[n][e] * a.scale_log2) + t_r[e >> 1];
        s[n][e] = (k0 + n * 8 + 2 * t4 + (e & 1) < a.s_k) ? x : (NOEXP ? 0.f : -INFINITY);
      }

    if constexpr (BF16EXP) {
      // P.V operand chunks straight from the packed exponentials
      uint32_t p[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          p[n][r] = ex2_bf16x2(pack_bf16(s[n][2 * r], s[n][2 * r + 1]));
          l_r[r] += bf16x2_sum(p[n][r]);
        }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t pa[4] = {p[2 * kc][0], p[2 * kc][1], p[2 * kc + 1][0], p[2 * kc + 1][1]};
        mma_a_by_rows<kDP>(o, pa, V, kc, lane);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!NOEXP) s[n][e] = exp2f(s[n][e]);
          l_r[e >> 1] += s[n][e];  // this thread's part; the row's 4 threads sum at the end
        }
      // O += P V: the score accumulators of keys 16kc..16kc+15 are the A operand
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t pa[4];
        acc_to_a_frag(pa, s, kc);
        mma_a_by_rows<kDP>(o, pa, V, kc, lane);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // out = O / l through the output strides
  bf16* ob = a.o + bh * a.ob;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= a.s_q) continue;
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < a.d)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * a.os + col) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <int BQ, int BK, int MODE>
cudaError_t launch(VariantArgs a, int bh, cudaStream_t stream) {
  auto kernel = flash_variant_kernel<BQ, BK, MODE>;
  const int bytes = int((BQ + 4 * BK) * RegTile<kDP>::LD * sizeof(bf16));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  a.n_q_tiles = (a.s_q + BQ - 1) / BQ;
  const long long blocks = (long long)bh * a.n_q_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), BQ * 2, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int BQ, int BK>
cudaError_t dispatch_mode(const VariantArgs& a, int bh, int mode, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<BQ, BK, 0>(a, bh, s);
    case kPrescale: return launch<BQ, BK, kPrescale>(a, bh, s);
    case kBf16Exp: return launch<BQ, BK, kBf16Exp>(a, bh, s);
    case kPrescale | kBf16Exp: return launch<BQ, BK, kPrescale | kBf16Exp>(a, bh, s);
    case kNoExp: return launch<BQ, BK, kNoExp>(a, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B*H, S, D) bf16 with unit D stride; strides[8] = (batch, row) element strides
// of q, k, v, o. t: (B*H, s_q) fp32. mode: 0 base, 1 prescale, 2 bf16exp, 3 both, 4 noexp.
// (bq, bk): the query x key tile, one of 64x64, 128x64, 64x128, 128x128.
int lkgd_flash_variant(const void* q, const void* k, const void* v, void* o, const float* t,
                       const long long* strides, int bh, int s_q, int s_k, int d,
                       float scale_log2, int mode, int bq, int bk, int device, void* stream) {
  if (d <= 0 || d > kDP || d % 8 != 0 || bh <= 0 || s_q <= 0 || s_k <= 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  VariantArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.qb = strides[0], a.qs = strides[1], a.kb = strides[2], a.ks = strides[3];
  a.vb = strides[4], a.vs = strides[5], a.ob = strides[6], a.os = strides[7];
  a.t = t;
  a.s_q = s_q, a.s_k = s_k, a.d = d, a.n_q_tiles = 0;
  a.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq == 64 && bk == 64) return int(dispatch_mode<64, 64>(a, bh, mode, s));
  if (bq == 128 && bk == 64) return int(dispatch_mode<128, 64>(a, bh, mode, s));
  if (bq == 64 && bk == 128) return int(dispatch_mode<64, 128>(a, bh, mode, s));
  if (bq == 128 && bk == 128) return int(dispatch_mode<128, 128>(a, bh, mode, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
