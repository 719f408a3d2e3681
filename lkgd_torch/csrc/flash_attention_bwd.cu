// Flash-attention backward for Hopper (sm_90a): bf16 operands, fp32 accumulation, D <= 128.
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py that _flash_bwd_bhsd
// drives under the custom VJP _flash_core:
//   * flash_bwd_dq_kernel ports _flash_bwd_dq_kernel:
//       P = exp2(s * scale * log2e - lse),  dS = P o (dO V^T - delta),  dQ = scale * dS K;
//   * flash_bwd_dkv_kernel ports _flash_bwd_dkv_kernel:
//       dV = P^T dO,  dK = scale * dS^T Q.
// lse is the forward's log2-domain logsumexp (B*H, S_q) and delta = rowsum(dO o O) (B*H,
// S_q), both fp32, computed in PyTorch as JAX does (flash_attention.py:528).
//
// What bounds it on the H100: tensor-core FLOPs. Each kernel recomputes the scores: dq
// runs three S^2*D products (Q K^T, dO V^T, dS K), dk/dv four (K Q^T, V dO^T, then P^T dO
// into dV and dS^T Q into dK), 3.5x the forward's work in all; the UNet level-0 training
// call (B*T=8, S=4096, 5 heads, D=64) is 0.60 TFLOP for the pair. The design keeps every
// S x S intermediate out of device memory:
//   * as the TPU's two-kernel split, no atomics: dq is one block per (batch*head, 64-row
//     query tile) looping over key tiles; dk/dv one block per (batch*head, 64-key tile)
//     looping over query tiles. Each output is written once, so the result is
//     deterministic;
//   * each warp owns 16 rows (queries, or keys for dkv) end to end; the fp32 scores,
//     probabilities and dS live in registers in the mma.sync m16n8k16 accumulator layout,
//     and the accumulators of one product are packed to bf16 as the A operand of the next
//     (P and dS are rounded to bf16 before their products, as the TPU kernels round them
//     to the input dtype);
//   * the streamed tiles (K/V for dq; Q/dO with their lse and delta for dkv) are double
//     buffered with cp.async; the A operands of the block's own tiles are read from
//     shared memory each tile, which leaves the registers to the accumulators;
//   * q, k, v and dO are read, and dq, dk, dv written, as (B, S, H, D) through their
//     strides; the autograd Function hands in the head-major copies of
//     relayout_heads.cu, whose tiles are contiguous, and merges the gradients back;
//   * a ragged S is masked in the kernel: keys past S_k get P = 0 (the TPU's kv_valid
//     padding, _mask_if_padded) and query columns past S_q get P = 0, so padded rows
//     contribute nothing; rows past the end are not written.
// TMA, wgmma and a fused single-pass backward are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace lkgd;

struct FlashBwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (B*H, s_q) log2 domain
  const float* delta;  // (B*H, s_q)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int batch_heads, heads, s_q, s_k, d, n_q_tiles, n_k_tiles;
  float scale_log2;  // D^-0.5 * log2(e), as the forward that wrote lse used it
  float scale;       // D^-0.5
};

// Write a warp's 16 x DP fp32 accumulator (rows r0 + g, r0 + g + 8) times `mul` as bf16.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int r0, int s_total,
                                           int d, const float (&acc)[DP / 8][4], float mul,
                                           int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= s_total) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d)
        *reinterpret_cast<uint32_t*>(base + (long long)row * row_stride + col) =
            pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const FlashBwdArgs a) {
  constexpr int LD = RegTile<DP>::LD;
  constexpr int KC = DP / 16;        // 16-wide chunks of D
  constexpr int NS = kTileRows / 8;  // 8-wide key tiles of a warp's 16 x 64 scores
  constexpr int ND = DP / 8;         // 8-wide D tiles of a warp's 16 x DP dq
  constexpr int TILE = kTileRows * LD;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + TILE;      // dO
  bf16* sK = sQ + 2 * TILE;  // stages 0, 1
  bf16* sV = sQ + 4 * TILE;  // stages 0, 1

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int q0 = qt * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  const int n_tiles = a.n_k_tiles;

  load_tile_async<DP>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.s_q, a.d);
  load_tile_async<DP>(sO, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.s_q, a.d);
  load_tile_async<DP>(sK, kb, a.ks.s, 0, a.s_k, a.d);
  load_tile_async<DP>(sV, vb, a.vs.s, 0, a.s_k, a.d);
  cp_async_commit();

  // this thread's rows: wr + g (r = 0) and wr + g + 8 (r = 1)
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row < a.s_q) {
      lse_r[r] = a.lse[(long long)bh * a.s_q + row];
      delta_r[r] = a.delta[(long long)bh * a.s_q + row];
    }
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next K/V tile into the other stage
      load_tile_async<DP>(sK + (st ^ 1) * TILE, kb, a.ks.s, (j + 1) * kTileRows, a.s_k, a.d);
      load_tile_async<DP>(sV + (st ^ 1) * TILE, vb, a.vs.s, (j + 1) * kTileRows, a.s_k, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* K = sK + st * TILE;
    const bf16* V = sV + st * TILE;

    // S = Q K^T and dP = dO V^T: a warp's 16 rows x 64 keys each
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], da[4];
      load_a_frag<LD>(qa, sQ, wr, kc, g, t4);
      load_a_frag<LD>(da, sO, wr, kc, g, t4);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* k = K + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        const bf16* v = V + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        mma_16816(s[n], qa, lds32(k), lds32(k + 8));
        mma_16816(dp[n], da, lds32(v), lds32(v + 8));
      }
    }

    // P = exp2(s' - lse) (0 past S_k), dS = P (dP - delta); element e is row g + 8*(e/2)
    const int k0 = j * kTileRows;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + n * 8 + 2 * t4 + (e & 1) < a.s_k;
        const float p = valid ? exp2f(s[n][e] * a.scale_log2 - lse_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
      }

    // dQ += dS K: the dS accumulators of keys 16kc..16kc+15 are the A operand
#pragma unroll
    for (int kc = 0; kc < kTileRows / 16; ++kc) {
      uint32_t sa[4];
      acc_to_a_frag(sa, s, kc);
      mma_a_by_rows<DP>(dq, sa, K, kc, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  store_rows<DP>(a.dq + b * a.dqs.b + h * a.dqs.h, a.dqs.s, q0 + wr, a.s_q, a.d, dq, a.scale,
                 g, t4);
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(const FlashBwdArgs a) {
  constexpr int LD = RegTile<DP>::LD;
  constexpr int KC = DP / 16;
  constexpr int NS = kTileRows / 8;  // 8-wide query tiles of a warp's 16 keys x 64 queries
  constexpr int ND = DP / 8;
  constexpr int TILE = kTileRows * LD;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sK + 2 * TILE;  // stages 0, 1
  bf16* sO = sK + 4 * TILE;  // dO, stages 0, 1
  __shared__ float sL[2][kTileRows], sD[2][kTileRows];  // lse and delta of the query tile

  const int bh = blockIdx.x / a.n_k_tiles;
  const int kt = blockIdx.x % a.n_k_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* ob = a.dout + b * a.dos.b + h * a.dos.h;
  const float* lse = a.lse + (long long)bh * a.s_q;
  const float* delta = a.delta + (long long)bh * a.s_q;
  const int k0 = kt * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;  // this warp's first key in the tile
  const int n_tiles = a.n_q_tiles;

  load_tile_async<DP>(sK, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, k0, a.s_k, a.d);
  load_tile_async<DP>(sV, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, k0, a.s_k, a.d);
  load_tile_async<DP>(sQ, qb, a.qs.s, 0, a.s_q, a.d);
  load_tile_async<DP>(sO, ob, a.dos.s, 0, a.s_q, a.d);
  cp_async_commit();
  if (threadIdx.x < kTileRows) {
    const bool ok = threadIdx.x < a.s_q;
    sL[0][threadIdx.x] = ok ? lse[threadIdx.x] : 0.f;
    sD[0][threadIdx.x] = ok ? delta[threadIdx.x] : 0.f;
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) {  // prefetch the next query tile (Q, dO, lse, delta)
      const int next = (i + 1) * kTileRows;
      load_tile_async<DP>(sQ + (st ^ 1) * TILE, qb, a.qs.s, next, a.s_q, a.d);
      load_tile_async<DP>(sO + (st ^ 1) * TILE, ob, a.dos.s, next, a.s_q, a.d);
      cp_async_commit();
      if (threadIdx.x < kTileRows) {
        const bool ok = next + threadIdx.x < a.s_q;
        sL[st ^ 1][threadIdx.x] = ok ? lse[next + threadIdx.x] : 0.f;
        sD[st ^ 1][threadIdx.x] = ok ? delta[next + threadIdx.x] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Q = sQ + st * TILE;
    const bf16* O = sO + st * TILE;

    // S^T = K Q^T and dP^T = V dO^T: a warp's 16 keys x 64 queries each
    float p[NS][4], ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      load_a_frag<LD>(ka, sK, wr, kc, g, t4);
      load_a_frag<LD>(va, sV, wr, kc, g, t4);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* q = Q + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        const bf16* o = O + (n * 8 + g) * LD + kc * 16 + 2 * t4;
        mma_16816(p[n], ka, lds32(q), lds32(q + 8));
        mma_16816(ds[n], va, lds32(o), lds32(o + 8));
      }
    }

    // P^T = exp2(s' - lse) (0 past S_q), dS^T = P^T (dP^T - delta); element e of a tile is
    // query column n*8 + 2*t4 + (e & 1)
    const int q0 = i * kTileRows;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        const float pe = (q0 + c < a.s_q) ? exp2f(p[n][e] * a.scale_log2 - sL[st][c]) : 0.f;
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - sD[st][c]);
      }

    // dV += P^T dO and dK += dS^T Q: the accumulators of queries 16kc..16kc+15 are the A
    // operands
#pragma unroll
    for (int kc = 0; kc < kTileRows / 16; ++kc) {
      uint32_t pa[4], sa[4];
      acc_to_a_frag(pa, p, kc);
      acc_to_a_frag(sa, ds, kc);
      mma_a_by_rows<DP>(dv, pa, O, kc, lane);
      mma_a_by_rows<DP>(dk, sa, Q, kc, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  store_rows<DP>(a.dk + b * a.dks.b + h * a.dks.h, a.dks.s, k0 + wr, a.s_k, a.d, dk, a.scale,
                 g, t4);
  store_rows<DP>(a.dv + b * a.dvs.b + h * a.dvs.h, a.dvs.s, k0 + wr, a.s_k, a.d, dv, 1.f, g,
                 t4);
}

template <int DP>
cudaError_t launch_bwd(const FlashBwdArgs& a, bool dkv, cudaStream_t stream) {
  const int bytes = int(6 * RegTile<DP>::bytes);  // two resident tiles + two double-buffered
  auto kernel = dkv ? flash_bwd_dkv_kernel<DP> : flash_bwd_dq_kernel<DP>;
  const long long blocks = (long long)a.batch_heads * (dkv ? a.n_k_tiles : a.n_q_tiles);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(blocks), 128, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (B, S, H, D) bf16, strides[21] = (b, s, h) element strides of
// q, k, v, dout, dq, dk, dv. lse, delta: (B*H, s_q) fp32. dkv=0 launches the dq kernel
// (writes dq), dkv=1 the dk/dv kernel (writes dk and dv). D must be a multiple of 8, <= 128.
int lkgd_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const long long* strides, int batch, int heads, int s_q, int s_k, int d,
                   float scale, float scale_log2, int dkv, int device, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  FlashBwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  Strides* all[7] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 7; ++i) *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.batch_heads = batch * heads;
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_q_tiles = (s_q + kTileRows - 1) / kTileRows;
  a.n_k_tiles = (s_k + kTileRows - 1) / kTileRows;
  a.scale = scale;
  a.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(d <= 64 ? launch_bwd<64>(a, dkv != 0, s) : launch_bwd<128>(a, dkv != 0, s));
}

}  // extern "C"
