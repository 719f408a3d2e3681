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
//   * q, k, v and the output are read and written as (B, S, H, D) through their strides,
//     so the head split/merge copies of the TPU path (_split_heads/_merge_heads) vanish;
//   * a ragged S is handled in the kernel: rows and keys past the end load as zeros and
//     the keys are masked to -inf (the TPU's _mask_if_padded), D is zero-padded in shared
//     memory up to the tile width.
// TMA loads, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kGuard = 0x1p-110f;  // smallest row sum the bound kernel may leave

struct Strides {
  long long b, s, h;  // in elements; the D stride is 1
};

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
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global->shared copy; with ok == false nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int kRegRows = 64;  // query rows a block (4 warps x 16)
constexpr int kRegKeys = 64;  // keys a K/V tile

template <int DP>
struct RegSmem {
  static constexpr int LD = DP + 8;  // padded row: conflict-free fragment loads
  static constexpr size_t tile = size_t(kRegRows) * LD * sizeof(bf16);
  static constexpr size_t total = 5 * tile;  // Q + two stages of (K, V)
};

// rows [row0, row0 + 64) of a strided (S, D) slice -> a (64, LD) shared tile, async
template <int DP>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long row_stride, int row0, int s_total,
                                                int d) {
  constexpr int VPR = DP / 8;
  constexpr int LD = RegSmem<DP>::LD;
  for (int i = threadIdx.x; i < kRegRows * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = row0 + r < s_total && c < d;
    const bf16* src = ok ? base + (long long)(row0 + r) * row_stride + c : base;
    cp_async_16(dst + r * LD + c, src, ok);
  }
}

template <int DP, bool BOUND>
__global__ void __launch_bounds__(128) flash_fwd_mma_kernel(const FlashArgs a) {
  using L = RegSmem<DP>;
  constexpr int LD = L::LD;
  constexpr int KC = DP / 16;        // 16-wide chunks of D (Q K^T depth)
  constexpr int NS = kRegKeys / 8;   // 8-wide score tiles of a warp's 16 x 64 scores
  constexpr int ND = DP / 8;         // 8-wide output tiles of a warp's 16 x DP output

  if (!BOUND && a.tile_min != nullptr) {
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::tile);      // stages 0, 1
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * L::tile);  // stages 0, 1
  __shared__ float warp_min[4];

  const int bh = blockIdx.x / a.n_q_tiles;
  const int qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int q0 = qt * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group and column pair
  const int wr = warp * 16;
  const int n_tiles = (a.s_k + kRegKeys - 1) / kRegKeys;

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
      load_tile_async<DP>(sK + (st ^ 1) * kRegRows * LD, kb, a.ks.s, (j + 1) * kRegKeys,
                          a.s_k, a.d);
      load_tile_async<DP>(sV + (st ^ 1) * kRegRows * LD, vb, a.vs.s, (j + 1) * kRegKeys,
                          a.s_k, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* q = sQ + (wr + g) * LD + kc * 16 + 2 * t4;
        qf[kc][0] = lds32(q);
        qf[kc][1] = lds32(q + 8 * LD);
        qf[kc][2] = lds32(q + 8);
        qf[kc][3] = lds32(q + 8 * LD + 8);
      }
    }
    const bf16* K = sK + st * kRegRows * LD;
    const bf16* V = sV + st * kRegRows * LD;

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
    const int k0 = j * kRegKeys;
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
    for (int kc = 0; kc < kRegKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
      const bf16* vrow = V + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + n * 8);
        mma_16816(o[n], pa, vf[0], vf[1]);
        mma_16816(o[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // out = O / l through the output strides
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
  const int bytes = int(RegSmem<DP>::total);
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
template <bool BOUND>
cudaError_t dispatch(const FlashArgs& a, long long blocks, cudaStream_t s) {
  if (a.d <= 64) return launch_mma<64, BOUND>(a, blocks, s);
  if (a.d <= 128) return launch_mma<128, BOUND>(a, blocks, s);
  if (a.d <= 256) return launch<256, 4, 32, BOUND>(a, blocks, s);
  return launch<512, 2, 32, BOUND>(a, blocks, s);
}

}  // namespace

extern "C" {

// Query rows per block for a head dim d (the tile the per-tile guard covers).
int lkgd_flash_block_rows(int d) { return d <= 256 ? 64 : 32; }

// q, k, v, o: (B, S, H, D) bf16 with strides[12] = (b, s, h) element strides of q, k, v, o.
// bound=1: the bound kernel (t and tile_min required). bound=0: the max-tracking kernel,
// guarded by tile_min when it is not null.
int lkgd_flash_fwd(const void* q, const void* k, const void* v, void* o, const long long* strides,
                   int batch, int heads, int s_q, int s_k, int d, float scale_log2,
                   const float* t, float* tile_min, int* recomputed, int bound, int device,
                   void* stream) {
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
  const long long blocks = (long long)batch * heads * a.n_q_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bound ? dispatch<true>(a, blocks, s) : dispatch<false>(a, blocks, s));
}

const char* lkgd_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
