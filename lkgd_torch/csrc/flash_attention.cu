// Flash-attention forward for Hopper (sm_90a): bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py:
//   * BOUND=true ports _flash_bound_kernel (driven by _flash_bhsd):
//     softmax with a precomputed per-row upper bound t_i = -scale*log2e*|q_i|*max_j|k_j|
//     subtracted in the exp2 domain instead of a running max. No max reduction and no
//     rescaling; the kernel writes the smallest row sum of each query tile.
//   * BOUND=false ports _flash_kernel (driven by
//     _flash_maxtrack_bhsd): the online-max form with per-tile exp2(m_prev - m_next)
//     rescaling. Launched after the bound kernel with that kernel's per-tile minimum row
//     sums, it returns at once for every tile whose minimum is > 2^-110 and recomputes
//     only the tiles whose bound was too loose (the TPU wrapper's lax.cond, decided on
//     the device per tile, with no host synchronisation). Launched with no minimums it is
//     the plain max-tracking kernel (LKGD_FLASH_MAXTRACK=1).
//   * LSE=true is the training forward (D <= 128): with BOUND=true it ports
//     _flash_bound_lse_kernel (driven by _flash_fwd_lse_bhsd), with BOUND=false
//     _flash_fwd_lse_kernel (driven by _flash_fwd_lse_maxtrack_bhsd). Each also writes the
//     log2-domain logsumexp of every row's scaled logits, (B*H, S_q) fp32, that the
//     backward kernels (flash_attention_bwd.cu) recompute the probabilities from. The
//     guard is the same as above: JAX's min(lse + t) > -110 is min log2(l) > -110. The
//     LSE write is one fp32 per row, nothing next to the S^2*D products.
//
// What bounds it on the H100: tensor-core FLOPs. One UNet level-0 call (S=9216, D=64,
// B*H=140) is 4*S^2*D*B*H = 3.05 TFLOP; its inputs are 24 MB. The design keeps the
// logits out of device memory and spends its time in bf16 tensor-core products:
//   * one CUDA block per (batch*head, query tile); the TPU's sequential k-grid dimension
//     becomes a loop over K/V tiles inside the block;
//   * each warp owns 16 query rows end to end (scores, softmax, P.V), so the only
//     block-wide barriers are around the shared K/V tile loads;
//   * D <= 128 (the UNet's D=64): flash_fwd_mma_kernel keeps the scores, probabilities
//     and output accumulator in registers in the FlashAttention-2 layout of mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate): the score accumulator of one product is the
//     A operand of the next, with no trip through shared memory; the next K/V tile loads
//     with cp.async while the current one computes;
//   * D > 128 (the VAE's D=512): flash_fwd_kernel uses nvcuda::wmma fragments and keeps
//     the score tile, probabilities and output accumulator in shared memory (a warp's
//     16x512 fp32 accumulator cannot live in registers);
//   * q, k, v and the output are read and written as (B, S, H, D) through their strides:
//     the inference forward takes the projections' views as they are, the training
//     forward the head-major copies of relayout_heads.cu (_split_heads/_merge_heads);
//   * a ragged S is handled in the kernel: rows and keys past the end load as zeros and
//     the keys are masked to -inf (the TPU's _mask_if_padded), D is zero-padded in shared
//     memory up to the tile width.
// TMA loads, wgmma and warp specialisation are later work.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

namespace {

using namespace lkgd;
using namespace nvcuda;

constexpr float kGuard = 0x1p-110f;  // smallest row sum the bound kernel may leave

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  Strides qs, ks, vs, os;
  int heads, s_q, s_k, d, n_q_tiles;
  float scale_log2;      // D^-0.5 * log2(e)
  const float* t;        // (B*H, s_q) minus the logit bound, log2 domain (bound kernel)
  float* tile_min;       // (B*H, n_q_tiles): written by the bound kernel, read as the guard
  int* recomputed;       // count of tiles the guarded max-tracking launch recomputed
  float* lse;            // (B*H, s_q) log2-domain logsumexp, or null (inference forward)
};

template <int DP, int NW, int BK>
struct Smem {
  static constexpr int BQ = 16 * NW;
  static constexpr size_t q = size_t(BQ) * DP * sizeof(bf16);
  static constexpr size_t kv = size_t(BK) * DP * sizeof(bf16);
  static constexpr size_t s = size_t(BQ) * BK * sizeof(float);
  static constexpr size_t p = size_t(BQ) * BK * sizeof(bf16);
  static constexpr size_t o = size_t(BQ) * DP * sizeof(float);
  static constexpr size_t total = q + 2 * kv + s + p + o;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Copy rows [row0, row0 + nrows) of a strided (S, D) slice into a (nrows, DP) shared tile
// with 16-byte loads; rows past s_total and columns past d are zero.
template <int DP, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long row_stride,
                                          int row0, int nrows, int s_total, int d) {
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < nrows * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s_total && c < d)
      val = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + c));
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

template <int DP, int NW, int BK, bool BOUND>
__global__ void __launch_bounds__(NW * 32) flash_fwd_kernel(const FlashArgs a) {
  using L = Smem<DP, NW, BK>;
  constexpr int BQ = L::BQ;
  constexpr int NT = NW * 32;
  constexpr int CPL = BK / 32;  // score columns per lane

  if (!BOUND && a.tile_min != nullptr) {
    // guarded fallback launch: NaN compares false and is recomputed too
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::q + L::kv);
  float* sS = reinterpret_cast<float*>(smem + L::q + 2 * L::kv);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::q + 2 * L::kv + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s + L::p);
  __shared__ float warp_min[NW];

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;                 // this warp's first row in the tile
  const int d_tiles = (a.d + 15) / 16;      // 16-wide column tiles that hold real D

  load_rows<DP, NT>(sQ, qb, a.qs.s, q0, BQ, a.s_q, a.d);
  for (int i = threadIdx.x; i < BQ * DP; i += NT) sO[i] = 0.f;

  // per-row softmax state; every lane of the warp holds the same values
  float m_row[16], l_row[16], t_row[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_row[r] = -INFINITY;
    l_row[r] = 0.f;
    t_row[r] = 0.f;
    if (BOUND && q0 + wr + r < a.s_q) t_row[r] = a.t[(long long)bh * a.s_q + q0 + wr + r];
  }

  for (int k0 = 0; k0 < a.s_k; k0 += BK) {
    __syncthreads();  // the previous K/V tile is no longer read
    load_rows<DP, NT>(sK, kb, a.ks.s, k0, BK, a.s_k, a.d);
    load_rows<DP, NT>(sV, vb, a.vs.s, k0, BK, a.s_k, a.d);
    __syncthreads();

    // scores S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d_tiles; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + wr * DP + kk * 16, DP);
        wmma::load_matrix_sync(fb, sK + nt * 16 * DP + kk * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + wr * BK + nt * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // probabilities P (bf16) and row sums, exp2 domain
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      float sv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = lane + 32 * c;
        sv[c] = (k0 + col < a.s_k) ? sS[row * BK + col] * a.scale_log2 : -INFINITY;
      }
      float shift, alpha = 1.f;
      if (BOUND) {
        shift = -t_row[r];
      } else {
        float mx = sv[0];
#pragma unroll
        for (int c = 1; c < CPL; ++c) mx = fmaxf(mx, sv[c]);
        const float m_new = fmaxf(m_row[r], warp_max(mx));
        alpha = exp2f(m_row[r] - m_new);
        m_row[r] = m_new;
        shift = m_new;
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float pv = exp2f(sv[c] - shift);
        sum += pv;
        sP[row * BK + lane + 32 * c] = __float2bfloat16(pv);
      }
      l_row[r] = alpha * l_row[r] + warp_sum(sum);
      if (!BOUND) {
        for (int c = lane; c < DP; c += 32) sO[row * DP + c] *= alpha;
      }
    }
    __syncwarp();

    // O += P V
    for (int dt = 0; dt < d_tiles; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + wr * DP + dt * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + wr * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, sV + kk * 16 * DP + dt * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + wr * DP + dt * 16, acc, DP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / l, written through the output strides with 16-byte stores
  bf16* ob = a.o + b * a.os.b + h * a.os.h;
  float mn = INFINITY;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + wr + r;
    if (qrow >= a.s_q) continue;
    mn = (l_row[r] > kGuard) ? fminf(mn, l_row[r]) : 0.f;  // an underflowed or NaN row: 0
    const float inv = 1.f / l_row[r];
    for (int c = lane * 8; c < a.d; c += 32 * 8) {
      const float* src = sO + (wr + r) * DP + c;
      uint4 packed;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p2[e] = __floats2bfloat162_rn(src[2 * e] * inv, src[2 * e + 1] * inv);
      *reinterpret_cast<uint4*>(ob + (long long)qrow * a.os.s + c) = packed;
    }
  }
  if (BOUND) {
    if (lane == 0) warp_min[warp] = mn;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tile = warp_min[0];
      for (int w = 1; w < NW; ++w) tile = fminf(tile, warp_min[w]);
      a.tile_min[blockIdx.x] = tile;
    }
  }
}

// ---------------------------------------------------------------- D <= 128: registers
template <int DP, bool BOUND, bool LSE>
__global__ void __launch_bounds__(128) flash_fwd_mma_kernel(const FlashArgs a) {
  constexpr int LD = RegTile<DP>::LD;
  constexpr int KC = DP / 16;        // 16-wide chunks of D (Q K^T depth)
  constexpr int NS = kTileRows / 8;  // 8-wide score tiles of a warp's 16 x 64 scores
  constexpr int ND = DP / 8;         // 8-wide output tiles of a warp's 16 x DP output

  if (!BOUND && a.tile_min != nullptr) {
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + RegTile<DP>::bytes);      // stages 0, 1
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * RegTile<DP>::bytes);  // stages 0, 1
  __shared__ float warp_min[4];

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int q0 = qt * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group and column pair
  const int wr = warp * 16;
  const int n_tiles = (a.s_k + kTileRows - 1) / kTileRows;

  load_tile_async<DP>(sQ, qb, a.qs.s, q0, a.s_q, a.d);
  load_tile_async<DP>(sK, kb, a.ks.s, 0, a.s_k, a.d);
  load_tile_async<DP>(sV, vb, a.vs.s, 0, a.s_k, a.d);
  cp_async_commit();

  // this thread's rows: wr + g (r = 0) and wr + g + 8 (r = 1)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, t_r[2] = {0.f, 0.f};
  if (BOUND) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      if (row < a.s_q) t_r[r] = a.t[(long long)bh * a.s_q + row];
    }
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[KC][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_tile_async<DP>(sK + (st ^ 1) * kTileRows * LD, kb, a.ks.s, (j + 1) * kTileRows,
                          a.s_k, a.d);
      load_tile_async<DP>(sV + (st ^ 1) * kTileRows * LD, vb, a.vs.s, (j + 1) * kTileRows,
                          a.s_k, a.d);
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
    const bf16* K = sK + st * kTileRows * LD;
    const bf16* V = sV + st * kTileRows * LD;

    // scores: a warp's 16 rows x 64 keys, fp32 in registers
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* k = K + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        mma_16816(s[n], qf[kc], lds32(k), lds32(k + 8));
      }
    }

    // softmax numerators in the exp2 domain; element e of a tile is row g + 8*(e/2)
    const int k0 = j * kTileRows;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = (k0 + n * 8 + 2 * t4 + (e & 1) < a.s_k) ? s[n][e] * a.scale_log2 : -INFINITY;
    float shift[2];
    if (BOUND) {
      shift[0] = -t_r[0];
      shift[1] = -t_r[1];
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        shift[r] = (m_new == -INFINITY) ? 0.f : m_new;
        const float alpha = exp2f(m_r[r] - shift[r]);
        m_r[r] = m_new;
        l_r[r] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - shift[e >> 1]);
        l_r[e >> 1] += s[n][e];  // this thread's part; the row's 4 threads sum at the end
      }

    // O += P V: the score accumulators of keys 16kc..16kc+15 are the A operand
#pragma unroll
    for (int kc = 0; kc < kTileRows / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a_frag(pa, s, kc);
      mma_a_by_rows<DP>(o, pa, V, kc, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // out = O / l through the output strides; with LSE, the log2-domain logsumexp of each
  // row's scaled logits: log2(l) - t (bound: t is minus the subtracted bound) or m + log2(l)
  bf16* ob = a.o + b * a.os.b + h * a.os.h;
  float mn = INFINITY;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= a.s_q) continue;
    mn = (l > kGuard) ? fminf(mn, l) : 0.f;
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < a.d)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * a.os.s + col) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (LSE && t4 == 0)
      a.lse[(long long)bh * a.s_q + row] = BOUND ? log2f(l) - t_r[r] : m_r[r] + log2f(l);
  }
  if (BOUND) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    if (lane == 0) warp_min[warp] = mn;
    __syncthreads();
    if (threadIdx.x == 0)
      a.tile_min[blockIdx.x] =
          fminf(fminf(warp_min[0], warp_min[1]), fminf(warp_min[2], warp_min[3]));
  }
}

template <int DP, bool BOUND, bool LSE>
cudaError_t launch_mma(const FlashArgs& a, long long blocks, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<DP, BOUND, LSE>;
  const int bytes = int(5 * RegTile<DP>::bytes);  // Q + two stages of (K, V)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(blocks), 128, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, int NW, int BK, bool BOUND>
cudaError_t launch(const FlashArgs& a, long long blocks, cudaStream_t stream) {
  using L = Smem<DP, NW, BK>;
  auto kernel = flash_fwd_kernel<DP, NW, BK, BOUND>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::total));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(blocks), NW * 32, L::total, stream>>>(a);
  return cudaGetLastError();
}

// Plan by D padded to DP: registers up to 128 (64 query rows a block; shared memory 45 KB
// at DP=64, 85 KB at 128), shared-memory accumulators above (140 KB at DP=256 with 64
// rows, 166 KB at 512 with 32 rows).
// With an lse output (the training forward) only D <= 128 is built.
template <bool BOUND>
cudaError_t dispatch(const FlashArgs& a, long long blocks, cudaStream_t s) {
  if (a.lse != nullptr) {
    if (a.d <= 64) return launch_mma<64, BOUND, true>(a, blocks, s);
    if (a.d <= 128) return launch_mma<128, BOUND, true>(a, blocks, s);
    return cudaErrorInvalidValue;
  }
  if (a.d <= 64) return launch_mma<64, BOUND, false>(a, blocks, s);
  if (a.d <= 128) return launch_mma<128, BOUND, false>(a, blocks, s);
  if (a.d <= 256) return launch<256, 4, 32, BOUND>(a, blocks, s);
  return launch<512, 2, 32, BOUND>(a, blocks, s);
}

}  // namespace

extern "C" {

// Query rows per block for a head dim d (the tile the per-tile guard covers).
int lkgd_flash_block_rows(int d) { return d <= 256 ? 64 : 32; }

// q, k, v, o: (B, S, H, D) bf16 with strides[12] = (b, s, h) element strides of q, k, v, o.
// bound=1: the bound kernel (t and tile_min required). bound=0: the max-tracking kernel,
// guarded by tile_min when it is not null. lse: null, or (B*H, s_q) fp32 for the training
// forward's log2-domain logsumexp (D <= 128 only).
int lkgd_flash_fwd(const void* q, const void* k, const void* v, void* o, const long long* strides,
                   int batch, int heads, int s_q, int s_k, int d, float scale_log2,
                   const float* t, float* tile_min, int* recomputed, float* lse, int bound,
                   int device, void* stream) {
  if (d <= 0 || d > 512 || d % 8 != 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  FlashArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  const int bq = lkgd_flash_block_rows(d);
  a.n_q_tiles = (s_q + bq - 1) / bq;
  a.scale_log2 = scale_log2;
  a.t = t;
  a.tile_min = tile_min;
  a.recomputed = recomputed;
  a.lse = lse;
  const long long blocks = (long long)batch * heads * a.n_q_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bound ? dispatch<true>(a, blocks, s) : dispatch<false>(a, blocks, s));
}

const char* lkgd_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
