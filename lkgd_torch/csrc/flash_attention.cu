// Flash-attention training forward for Hopper (sm_90a): bf16 in and out, fp32 accumulation,
// with the log2-domain logsumexp of every row that the backward kernels need.
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py that carry training:
//   * BOUND=true, kernel 7: _flash_bound_lse_kernel (driven by _flash_fwd_lse_bhsd):
//     softmax with a precomputed per-row upper bound t_i = -scale*log2e*|q_i|*max_j|k_j|
//     subtracted in the exp2 domain instead of a running max. No max reduction and no
//     rescaling; the kernel writes the smallest row sum of each query tile.
//   * BOUND=false, kernel 8: _flash_fwd_lse_kernel (driven by
//     _flash_fwd_lse_maxtrack_bhsd): the online-max form with per-tile exp2(m_prev - m_next)
//     rescaling. Launched after the bound kernel with that kernel's per-tile minimum row
//     sums, it returns at once for every tile whose minimum is > 2^-110 and recomputes
//     only the tiles whose bound was too loose (the TPU wrapper's lax.cond, decided on
//     the device per tile, with no host synchronisation; JAX's min(lse + t) > -110 is
//     min log2(l) > -110). Launched with no minimums it is the plain max-tracking kernel
//     (LKGD_FLASH_MAXTRACK=1).
//   Each writes the lse of every row's scaled logits, (B*H, S_q) fp32, that the backward
//   kernels (flash_attention_bwd.cu) recompute the probabilities from: one fp32 per row,
//   nothing next to the S^2*D products. D <= 128 only.
// The inference forwards without an lse (kernels 1 and 2) are in flash_attention_wgmma.cu,
// built on wgmma and TMA; the lse output is not built there yet, so the training forward
// runs this mma.sync kernel.
//
// What bounds it on the H100: tensor-core FLOPs. One fine-tune level-0 call (S=4096, D=64,
// B*H=40) is 4*S^2*D*B*H = 0.17 TFLOP; its inputs are 21 MB. The design keeps the
// logits out of device memory and spends its time in bf16 tensor-core products:
//   * one CUDA block per (batch*head, query tile of 64 rows); the TPU's sequential k-grid
//     dimension becomes a loop over 64-key K/V tiles inside the block;
//   * each warp owns 16 query rows end to end (scores, softmax, P.V), so the only
//     block-wide barriers are around the shared K/V tile loads;
//   * the scores, probabilities and output accumulator stay in registers in the
//     FlashAttention-2 layout of mma.sync m16n8k16 (bf16 in, fp32 accumulate): the score
//     accumulator of one product is the A operand of the next, with no trip through shared
//     memory; the next K/V tile loads with cp.async while the current one computes;
//   * q, k, v and the output are read and written as (B, S, H, D) through their strides
//     (the head-major copies of relayout_heads.cu, _split_heads/_merge_heads);
//   * a ragged S is handled in the kernel: rows and keys past the end load as zeros and
//     the keys are masked to -inf (the TPU's _mask_if_padded), D is zero-padded in shared
//     memory up to the tile width.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace lkgd;

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
  float* lse;            // (B*H, s_q) log2-domain logsumexp
};

template <int DP, bool BOUND>
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
    if (t4 == 0)
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

template <int DP, bool BOUND>
cudaError_t launch_mma(const FlashArgs& a, long long blocks, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<DP, BOUND>;
  const int bytes = int(5 * RegTile<DP>::bytes);  // Q + two stages of (K, V)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(blocks), 128, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Static dispatch by D padded to the tile width; D <= 128 only.
template <bool BOUND>
cudaError_t dispatch(const FlashArgs& a, long long blocks, cudaStream_t s) {
  if (a.d <= 64) return launch_mma<64, BOUND>(a, blocks, s);
  if (a.d <= 128) return launch_mma<128, BOUND>(a, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) bf16 with strides[12] = (b, s, h) element strides of q, k, v, o;
// lse: (B*H, s_q) fp32, the log2-domain logsumexp. bound=1: the bound kernel (t and
// tile_min required). bound=0: the max-tracking kernel, guarded by tile_min when it is
// not null. Query tiles are kTileRows rows (lkgd_flash_block_rows(d, 1)).
int lkgd_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int batch, int heads, int s_q, int s_k, int d,
                       float scale_log2, const float* t, float* tile_min, int* recomputed,
                       float* lse, int bound, int device, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || lse == nullptr) return int(cudaErrorInvalidValue);
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
  a.n_q_tiles = (s_q + kTileRows - 1) / kTileRows;
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
