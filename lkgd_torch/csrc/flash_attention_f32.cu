// Flash-attention inference forward for Hopper at fp32: fp32 in and out, fp32 products and
// fp32 sums, the form the bf16 kernels of flash_attention_wgmma.cu take for float32
// operands. lkgd_flash_forward (flash_attention_wgmma.cu) launches it from the same one C
// call, by the operands' type.
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
//     2^-110), or alone (LKGD_FLASH_MAXTRACK=1);
//   * key_sq_max_f32_kernel, kernel 1a at fp32: max_j|k_j|^2 of every (batch, head).
//
// What bounds it on the H100: fp32 operations (4*S^2*D per batch and head at 67 TFLOP/s
// outside the tensor cores). No TF32: its 10-bit mantissa would put about 1e-3 between the
// kernel and the fp32 plain version. A plain SIMT design, not tuned:
//   * one block of 256 threads per (batch*head, 64-row query tile); the threads form a
//     16 x 16 grid, each owning 4 query rows, and 4 keys of a 64-key tile for the scores
//     (keys tx + 16 j: the K reads of a half-warp fall in 16 different banks) and 4 x
//     D/16 columns of the output (columns 64 m + 4 tx + c);
//   * Q stays in shared memory for the whole block (64 x D fp32, 132 KB at D=512). Per key
//     tile: S = Q K^T with K streamed through shared memory 32 columns of D at a time, the
//     softmax numerators in registers (a row's 64 scores sit in one half-warp: shuffles),
//     P stored transposed in shared memory, then O += P V with V streamed 64 columns at a
//     time. O stays in registers: 128 a thread at D=512;
//   * rows past S_q and columns past D load as zeros; keys past S_k are masked to -inf.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_wgmma.cuh"

namespace {

using lkgd::Strides;

constexpr float kGuard = 0x1p-110f;  // smallest row sum the bound kernel may leave
constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows a block
constexpr int kBK = 64;   // keys a tile
constexpr int kDK = 32;   // columns of D a K chunk
constexpr int kPad = 4;   // floats of padding a shared row (keeps float4 rows aligned)

struct F32Args {
  const float *q, *k, *v;
  float* o;
  Strides qs, ks, vs, os;
  int heads, s_q, s_k, d, n_q_tiles;
  float scale_log2;        // D^-0.5 * log2(e)
  const float* k_sq_max;   // (B*H) largest squared key norm (bound kernel)
  float* tile_min;         // (B*H, n_q_tiles) smallest row sums: written by 1, read by 2
  int* recomputed;         // tiles the guarded max-tracking launch recomputed
};

template <int DP>
struct F32Plan {
  static constexpr int q_stride = DP + kPad;   // floats a row of the resident Q tile
  static constexpr int k_stride = kDK + kPad;  // of a K chunk
  static constexpr int pv_stride = 64 + kPad;  // of P^T and of a V chunk
  static constexpr int smem_floats =
      kBQ * q_stride + kBK * k_stride + kBK * pv_stride + kBK * pv_stride;
  static constexpr int smem_bytes = smem_floats * 4;
};

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int DP, bool BOUND>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(const F32Args a) {
  using P = F32Plan<DP>;
  constexpr int NM = DP / 64;  // 64-column V chunks; each thread keeps 4 columns of each

  if (!BOUND && a.tile_min != nullptr) {
    // guarded fallback launch: NaN compares false and is recomputed too
    if (a.tile_min[blockIdx.x] > kGuard) return;
    if (threadIdx.x == 0) atomicAdd(a.recomputed, 1);
  }

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * P::q_stride;
  float* sP = sK + kBK * P::k_stride;  // P^T: [key][row]
  float* sV = sP + kBK * P::pv_stride;
  __shared__ float warp_min[kThreads / 32];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x / a.n_q_tiles, qt = blockIdx.x % a.n_q_tiles;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = qt * kBQ;
  const int d_chunks = (a.d + kDK - 1) / kDK;
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;

  // the Q tile, zeros past S_q and past D
  for (int f = tid; f < kBQ * DP / 4; f += kThreads) {
    const int row = f / (DP / 4), col = (f % (DP / 4)) * 4;
    const bool ok = q0 + row < a.s_q && col < a.d;
    store4(sQ + row * P::q_stride + col, load4(qb + (long long)(q0 + row) * a.qs.s + col, ok));
  }
  __syncthreads();

  // the bound t of this thread's rows from |q_i| summed in fp32 over the resident tile
  float t_r[4] = {0.f, 0.f, 0.f, 0.f};
  if (BOUND) {
    const float kn = sqrtf(a.k_sq_max[bh]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ss = 0.f;
      for (int c = tx; c < DP; c += 16) {
        const float x = sQ[(ty * 4 + i) * P::q_stride + c];
        ss = fmaf(x, x, ss);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      t_r[i] = -(sqrtf(ss) * kn) * a.scale_log2;
    }
  }

  float o[4][NM * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NM * 4; ++c) o[i][c] = 0.f;
  float m_r[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l_r[4] = {0.f, 0.f, 0.f, 0.f};

  const int n_tiles = (a.s_k + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    // 1. s = Q K_j^T, K through shared memory kDK columns at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int dc = 0; dc < d_chunks; ++dc) {
      const int d0 = dc * kDK;
      for (int f = tid; f < kBK * kDK / 4; f += kThreads) {
        const int row = f / (kDK / 4), col = (f % (kDK / 4)) * 4;
        const bool ok = k0 + row < a.s_k && d0 + col < a.d;
        store4(sK + row * P::k_stride + col,
               load4(kb + (long long)(k0 + row) * a.ks.s + d0 + col, ok));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDK; kk += 4) {
        float4 qa[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * P::q_stride + d0 + kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(sK + (tx + 16 * jj) * P::k_stride + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qa[i].x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qa[i].y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qa[i].z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qa[i].w, kv[jj].w, s[i][jj]);
          }
      }
      __syncthreads();
    }

    // 2. the softmax numerators, exp2 domain; keys past S_k give 0
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (k0 + tx + 16 * jj >= a.s_k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = -INFINITY;
      }
    float alpha[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float shift = t_r[i];
      if (!BOUND) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_r[i], mx * a.scale_log2);
        const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[i] = exp2f(m_r[i] - m_use);
        m_r[i] = m_new;
        l_r[i] *= alpha[i];
        shift = -m_use;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = exp2f(fmaf(s[i][jj], a.scale_log2, shift));
        l_r[i] += s[i][jj];  // this thread's part; the row's 16 threads sum at the end
      }
    }
    if (!BOUND) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NM * 4; ++c) o[i][c] *= alpha[i];
    }
    // P^T into shared memory: a float4 of this thread's four rows for each of its keys
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      store4(sP + (tx + 16 * jj) * P::pv_stride + ty * 4,
             make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]));

    // 3. o += P V_j, V through shared memory 64 columns at a time
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (m * 64 < a.d) {
        for (int f = tid; f < kBK * 16; f += kThreads) {
          const int row = f / 16, col = (f % 16) * 4;
          const bool ok = k0 + row < a.s_k && m * 64 + col < a.d;
          store4(sV + row * P::pv_stride + col,
                 load4(vb + (long long)(k0 + row) * a.vs.s + m * 64 + col, ok));
        }
      }
      __syncthreads();  // P^T (first chunk) and this V chunk are in
      if (m * 64 < a.d) {
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 p = *reinterpret_cast<const float4*>(sP + kk * P::pv_stride + ty * 4);
          const float4 x = *reinterpret_cast<const float4*>(sV + kk * P::pv_stride + tx * 4);
          const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][4 * m + 0] = fmaf(pr[i], x.x, o[i][4 * m + 0]);
            o[i][4 * m + 1] = fmaf(pr[i], x.y, o[i][4 * m + 1]);
            o[i][4 * m + 2] = fmaf(pr[i], x.z, o[i][4 * m + 2]);
            o[i][4 * m + 3] = fmaf(pr[i], x.w, o[i][4 * m + 3]);
          }
        }
      }
      __syncthreads();  // the V chunk (and, after the last, P^T) is read no more
    }
  }

  // out = O / l through the output strides. An underflowed row of the bound form may leave
  // inf or NaN here: its tile's minimum is 0 and the guarded launch overwrites the tile.
  float mn = INFINITY;
  float* ob = a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + ty * 4 + i;
    if (row >= a.s_q) continue;
    mn = (l > kGuard) ? fminf(mn, l) : 0.f;  // an underflowed or NaN row: 0
    const float inv = 1.f / l;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int col = m * 64 + tx * 4;
      if (col < a.d)
        store4(ob + (long long)row * a.os.s + col,
               make_float4(o[i][4 * m] * inv, o[i][4 * m + 1] * inv, o[i][4 * m + 2] * inv,
                           o[i][4 * m + 3] * inv));
    }
  }
  if (BOUND) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    if (tid % 32 == 0) warp_min[tid / 32] = mn;
    __syncthreads();
    if (tid == 0) {
      float tile = warp_min[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) tile = fminf(tile, warp_min[w]);
      a.tile_min[blockIdx.x] = tile;
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

template <int DP, bool BOUND>
cudaError_t launch(const F32Args& a, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<DP, BOUND>;
  constexpr int smem = F32Plan<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch * a.heads * a.n_q_tiles;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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

template <int DP>
cudaError_t forward(F32Args a, int batch, float* scratch, bool bound, cudaStream_t s) {
  if (!bound) return launch<DP, false>(a, batch, s);
  a.k_sq_max = scratch;
  a.tile_min = scratch + batch * a.heads;
  cudaError_t err = key_sq_max_f32(a.k, a.ks, batch, a.heads, a.s_k, a.d, scratch, s);
  if (err == cudaSuccess) err = launch<DP, true>(a, batch, s);
  if (err == cudaSuccess) err = launch<DP, false>(a, batch, s);
  return err;
}

}  // namespace

namespace lkgd {

int flash_f32_block_rows() { return kBQ; }

int flash_f32_smem_bytes(int d) {
  return d <= 64    ? F32Plan<64>::smem_bytes
         : d <= 128 ? F32Plan<128>::smem_bytes
         : d <= 256 ? F32Plan<256>::smem_bytes
                    : F32Plan<512>::smem_bytes;
}

cudaError_t flash_key_sq_max_f32(const float* k, const Strides& ks, int batch, int heads, int s_k,
                                 int d, float* out, cudaStream_t stream) {
  return key_sq_max_f32(k, ks, batch, heads, s_k, d, out, stream);
}

// The fp32 forward of lkgd_flash_forward: q, k, v, o (B, S, H, D) fp32 with (b, s, h)
// element strides st[0..3]; bound: the key norms, kernel 1 and kernel 2 as its guard over
// `scratch` (B*H squared key norms, then B*H * (64-row query tiles) smallest row sums);
// else kernel 2 alone.
cudaError_t flash_forward_f32(const void* q, const void* k, const void* v, void* o,
                              const Strides* st, int batch, int heads, int s_q, int s_k, int d,
                              float scale_log2, float* scratch, int* recomputed, bool bound,
                              cudaStream_t s) {
  F32Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.qs = st[0];
  a.ks = st[1];
  a.vs = st[2];
  a.os = st[3];
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_q_tiles = (s_q + kBQ - 1) / kBQ;
  a.scale_log2 = scale_log2;
  a.k_sq_max = nullptr;
  a.tile_min = nullptr;
  a.recomputed = recomputed;
  if (d <= 64) return forward<64>(a, batch, scratch, bound, s);
  if (d <= 128) return forward<128>(a, batch, scratch, bound, s);
  if (d <= 256) return forward<256>(a, batch, scratch, bound, s);
  return forward<512>(a, batch, scratch, bound, s);
}

}  // namespace lkgd
