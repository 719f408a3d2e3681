// GroupNorm statistics and fused normalise(+SiLU) for Hopper (sm_90a), over (N, M, C)
// activations in bf16 or fp32: N samples, M rows (pixels, or frames x pixels), C channels
// innermost (the channels-last layout of the port's convolutions).
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/group_norm.py (_pallas_group_norm):
//   * gn_stats_kernel ports _stats_kernel and _sums_to_affine: per-(sample, group)
//     statistics over the rows, folded on the device into the per-(sample, channel) affine
//     a = w * rsqrt(var + eps), b = bias - mean * a;
//   * gn_apply_kernel ports _apply_kernel: y = act(x * a + b) in fp32, stored in x.dtype.
// lkgd_group_norm makes one GroupNorm forward from one host call: a memset of the tickets,
// the statistics with their fold, and the normalise pass (three device operations).
//
// What bounds it on the H100: device-memory bytes, 2 reads and 1 write of x (at VAE decode
// full resolution, (14, 589824, 128) bf16, 6.3 GB per norm), at no more than a few FLOPs a
// byte. The statistics pass:
//   * keeps bytes in flight for 3.35 TB/s: every thread issues kUnroll independent 16-byte
//     loads (8 bf16 or 4 fp32 channels each, read-only path, no L1 allocation) before it
//     uses any; three blocks of 256 threads an SM hold 96 KB in flight there;
//   * does no division per row: each thread sums x - shift and (x - shift)^2, the shift
//     being the first row it reads, and turns the sums into (mean, M2) once at the end, so
//     fp32 inputs with |mean| >> std keep their precision (the reason the XLA fp32 form is
//     two-pass) and bf16 ones get at least the one-pass form's;
//   * tiles the channels in whole groups (a tile is a multiple of C / G and of the vector,
//     chosen by ops/group_norm.py chunk_plan: the widest that fits a block, whole rows of
//     the models' widths in bf16, read as one contiguous stream), so that a block's
//     partials are per group: the threads' per-channel (mean, M2) merge down the rows
//     (Chan et al., a fixed tree), then across the channels of each group, and the block
//     writes one (mean, M2) for each of its groups in its chunk of rows. A group wider than
//     256 vectors (2048 bf16 or 1024 fp32 channels) fits no tile and is refused; the
//     models' widths (C / G <= 40) have none;
//   * splits M into chunks across blocks (on the TPU one grid row walks all of M, which
//     would leave most of the 132 SMs idle at N = 1..28). The last block to finish for a
//     sample, found with an integer ticket after __threadfence(), folds that sample's
//     chunks in a fixed order, so the result does not depend on which block came last and
//     repeated calls give the same bits. M need not be a multiple of any chunk: the last
//     chunk is short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"  // lkgd::word

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // threads a block
constexpr int kUnroll = 8;         // 16-byte loads a thread has in flight
constexpr int kTileFloats = kThreads * 8;  // shared floats for a block's per-thread stats
constexpr int kApplyBlocks = 4224; // blocks of the normalise pass (32 for each of 132 SMs)

// 16 bytes of a stream read once: read-only path, no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void to_float(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void to_float(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[8]) {
  to_float(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  to_float(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&in)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

template <int VEC>
__device__ __forceinline__ void accumulate(const uint4& raw, const float (&shift)[VEC],
                                           float (&s1)[VEC], float (&s2)[VEC]) {
  float v[VEC];
  to_float(raw, v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float d = v[e] - shift[e];
    s1[e] += d;
    s2[e] = fmaf(d, d, s2[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits (fp32 addition commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float param(const void* p, int i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Scratch of one call, fp32 words: a, b (N, C), the chunks' group means and M2 (N, K, G),
// one ticket a sample (N, as unsigned); lkgd_group_norm carves it, the caller sizes it.
struct StatsArgs {
  const void* weight;  // (C) bf16 or fp32, as bias
  const void* bias;
  float* a;
  float* b;
  float* part_mean;
  float* part_m2;
  unsigned* tickets;
  int m, c, groups, tile, rows_per_chunk, n_chunks;
  int param_bf16;
  float eps;
};

// grid (C / tile, n_chunks, N).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3) gn_stats_kernel(const T* __restrict__ x,
                                                               const StatsArgs p) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float s_mean[kTileFloats];  // [row lane][channel of the tile]; the fold reuses
  __shared__ float s_m2[kTileFloats];    // them for its group means and inverse stds
  __shared__ float s_cnt[kThreads];
  __shared__ bool s_last;

  const int lanes_x = p.tile / VEC, lanes_y = kThreads / lanes_x;
  const int tid = threadIdx.x, tx = tid % lanes_x, ty = tid / lanes_x;
  const int n = blockIdx.z, chunk = blockIdx.y;
  const int r0 = chunk * p.rows_per_chunk, r1 = min(p.m, r0 + p.rows_per_chunk);
  const int first = r0 + ty;
  // rows this thread reads: first, first + lanes_y, ... below r1
  const int cnt = (ty < lanes_y && first < r1) ? (r1 - first + lanes_y - 1) / lanes_y : 0;

  float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) shift[e] = s1[e] = s2[e] = 0.f;
  if (cnt > 0) {
    const long long step = (long long)lanes_y * p.c;
    const T* px = x + ((long long)n * p.m + first) * p.c + blockIdx.x * p.tile + tx * VEC;
    to_float(ld_stream(px), shift);
    px += step;
    int left = cnt - 1;
    for (; left >= kUnroll; left -= kUnroll, px += kUnroll * step) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = ld_stream(px + u * step);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<VEC>(raw[u], shift, s1, s2);
    }
    for (; left > 0; --left, px += step) accumulate<VEC>(ld_stream(px), shift, s1, s2);
  }
  if (ty < lanes_y) {
    const float inv = cnt > 0 ? 1.f / float(cnt) : 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int i = ty * p.tile + tx * VEC + e;
      s_mean[i] = shift[e] + s1[e] * inv;
      s_m2[i] = fmaxf(s2[e] - s1[e] * s1[e] * inv, 0.f);
    }
    s_cnt[tid] = float(cnt);
  }
  __syncthreads();

  // merge down the row lanes, a fixed tree (Chan et al.): lane ty takes ty + s
  int span = 1;
  while (span < lanes_y) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < lanes_y) {
      const float na = s_cnt[tid], nb = s_cnt[tid + s * lanes_x];
      if (nb > 0.f) {
        const float nt = na + nb, wb = nb / nt;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = ty * p.tile + tx * VEC + e, j = i + s * p.tile;
          const float dlt = s_mean[j] - s_mean[i];
          s_mean[i] += dlt * wb;
          s_m2[i] += s_m2[j] + dlt * dlt * na * wb;
        }
        s_cnt[tid] = nt;
      }
    }
    __syncthreads();
  }

  // the channels of each group in this tile, all with the chunk's rows as count
  const int cg = p.c / p.groups, groups_here = p.tile / cg;
  if (tid < groups_here) {
    const float rows = float(r1 - r0);
    const float* mean_c = s_mean + tid * cg;
    const float* m2_c = s_m2 + tid * cg;
    float mean = 0.f, m2 = 0.f;
    for (int k = 0; k < cg; ++k) mean += mean_c[k];
    mean /= float(cg);
    for (int k = 0; k < cg; ++k) {
      const float d = mean_c[k] - mean;
      m2 += m2_c[k] + rows * d * d;
    }
    const long long o = ((long long)n * p.n_chunks + chunk) * p.groups + blockIdx.x * groups_here
                        + tid;
    p.part_mean[o] = mean;
    p.part_m2[o] = m2;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.tickets + n, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the sample's fold: one warp a group, its lanes over the chunks in a fixed order, the
  // weighted mean first and the M2 about it second (Chan's formula, two passes)
  const int warp = tid / 32, lane = tid % 32;
  const float total = float(p.m) * float(cg);
  const long long base = (long long)n * p.n_chunks * p.groups;
  for (int g = warp; g < p.groups; g += kThreads / 32) {
    float sum = 0.f;
    for (int k = lane; k < p.n_chunks; k += 32) {
      const float nk = float(min(p.rows_per_chunk, p.m - k * p.rows_per_chunk)) * float(cg);
      sum += nk * __ldcg(p.part_mean + base + (long long)k * p.groups + g);
    }
    const float mean = warp_sum(sum) / total;
    float m2 = 0.f;
    for (int k = lane; k < p.n_chunks; k += 32) {
      const float nk = float(min(p.rows_per_chunk, p.m - k * p.rows_per_chunk)) * float(cg);
      const long long o = base + (long long)k * p.groups + g;
      const float d = __ldcg(p.part_mean + o) - mean;
      m2 += __ldcg(p.part_m2 + o) + nk * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      s_mean[g] = mean;
      s_m2[g] = rsqrtf(m2 / total + p.eps);
    }
  }
  __syncthreads();
  const bool bf = p.param_bf16 != 0;
  for (int c = tid; c < p.c; c += kThreads) {
    const int g = c / cg;
    const float a = s_m2[g] * param(p.weight, c, bf);
    p.a[(long long)n * p.c + c] = a;
    p.b[(long long)n * p.c + c] = param(p.bias, c, bf) - s_mean[g] * a;
  }
}

// grid (blocks_x, N); a grid-stride loop over one sample's M*C elements.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, long long mc, int C) {
  constexpr int VEC = 16 / sizeof(T);
  const int n = blockIdx.y;
  const T* xn = x + (long long)n * mc;
  T* yn = y + (long long)n * mc;
  const float* an = a + (long long)n * C;
  const float* bn = b + (long long)n * C;
  const long long step = (long long)gridDim.x * blockDim.x * VEC;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC; i < mc; i += step) {
    const int c = int(i % C);
    float v[VEC];
    load_vec(xn + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float t = v[e] * __ldg(an + c + e) + __ldg(bn + c + e);
      if (SILU) t = t / (1.f + expf(-t));
      v[e] = t;
    }
    store_vec(yn + i, v);
  }
}

cudaError_t launch_apply(const void* x, void* y, const float* a, const float* b, int n,
                         long long mc, int c, bool silu, bool is_bf16, cudaStream_t s) {
  const long long vec = is_bf16 ? 8 : 4;
  const long long want = (mc + vec * kThreads - 1) / (vec * kThreads);
  const long long cap = (kApplyBlocks + n - 1) / n;
  const dim3 grid(unsigned(want < cap ? (want > 0 ? want : 1) : cap), n);
  if (is_bf16) {
    const bf16* xi = static_cast<const bf16*>(x);
    bf16* yo = static_cast<bf16*>(y);
    if (silu) gn_apply_kernel<bf16, true><<<grid, kThreads, 0, s>>>(xi, yo, a, b, mc, c);
    else gn_apply_kernel<bf16, false><<<grid, kThreads, 0, s>>>(xi, yo, a, b, mc, c);
  } else {
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    if (silu) gn_apply_kernel<float, true><<<grid, kThreads, 0, s>>>(xi, yo, a, b, mc, c);
    else gn_apply_kernel<float, false><<<grid, kThreads, 0, s>>>(xi, yo, a, b, mc, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One GroupNorm forward over x (N, M, C). `shape` packs eight int64: n, m, c, groups, tile,
// rows_per_chunk, n_chunks and flags (1: x is bf16, 2: weight and bias are bf16, 4: SiLU).
// scratch (fp32, 2*N*C + 2*N*n_chunks*groups + N words) receives a, b (N, C) first. With
// y null only the statistics run: a memset and one launch; else the normalise pass follows.
int lkgd_group_norm(const void* x, void* y, const void* weight, const void* bias, float* scratch,
                    const void* shape, float eps, int device, void* stream) {
  const long long n = lkgd::word(shape, 0), m = lkgd::word(shape, 1), c = lkgd::word(shape, 2),
                  groups = lkgd::word(shape, 3), tile = lkgd::word(shape, 4),
                  rows = lkgd::word(shape, 5), n_chunks = lkgd::word(shape, 6),
                  flags = lkgd::word(shape, 7);
  const bool is_bf16 = flags & 1;
  const long long vec = is_bf16 ? 8 : 4;
  if (n <= 0 || n > 65535 || m <= 0 || m > INT32_MAX || groups <= 0 || c % groups ||
      groups > kTileFloats || tile <= 0 || c % tile || tile % (c / groups) || tile % vec ||
      tile / vec > kThreads || rows <= 0 || n_chunks <= 0 || n_chunks > 65535 ||
      (n_chunks - 1) * rows >= m || n_chunks * rows < m)
    return int(cudaErrorInvalidValue);
  // cudaSetDevice also makes the device's context current on a thread whose first CUDA
  // call this is (autograd's backward thread, recomputing a checkpointed forward)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StatsArgs p;
  p.weight = weight;
  p.bias = bias;
  p.a = scratch;
  p.b = p.a + n * c;
  p.part_mean = p.b + n * c;
  p.part_m2 = p.part_mean + n * n_chunks * groups;
  p.tickets = reinterpret_cast<unsigned*>(p.part_m2 + n * n_chunks * groups);
  p.m = int(m);
  p.c = int(c);
  p.groups = int(groups);
  p.tile = int(tile);
  p.rows_per_chunk = int(rows);
  p.n_chunks = int(n_chunks);
  p.param_bf16 = (flags & 2) != 0;
  p.eps = eps;
  err = cudaMemsetAsync(p.tickets, 0, n * sizeof(unsigned), s);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(c / tile), unsigned(n_chunks), unsigned(n));
  if (is_bf16)
    gn_stats_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), p);
  else
    gn_stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), p);
  err = cudaGetLastError();
  if (err != cudaSuccess || y == nullptr) return int(err);
  return int(launch_apply(x, y, p.a, p.b, int(n), m * c, int(c), flags & 4, is_bf16, s));
}

// The normalise pass alone: y = act(x * a + b) with (N, C) fp32 a and b.
int lkgd_gn_apply(const void* x, void* y, const float* a, const float* b, int n, long long mc,
                  int c, int silu, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return int(launch_apply(x, y, a, b, n, mc, c, silu != 0, is_bf16 != 0,
                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
