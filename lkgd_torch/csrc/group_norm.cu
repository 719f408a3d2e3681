// GroupNorm(+SiLU) forward for Hopper (sm_90a), over (N, M, C) activations in bf16 or fp32:
// N samples, M rows (pixels, or frames x pixels), C channels innermost (the channels-last
// layout of the port's convolutions).
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/group_norm.py (_pallas_group_norm):
// _stats_kernel (per-(sample, channel) sums over the rows), _sums_to_affine (the fold into
// the per-(sample, channel) affine a = w * rsqrt(var + eps), b = bias - mean * a) and
// _apply_kernel (y = act(x * a + b) in fp32, stored in x.dtype). Two forms compute them,
// chosen by shape before any launch (ops/group_norm.py fused_plan):
//
//   * the one-pass form, gn_one_pass_kernel (lkgd_gn_one_pass), where a sample's groups
//     fit on chip. An item is one (sample, slab), a slab being the fewest whole groups
//     whose channels make rows of whole 32-byte sectors, so that no two clusters write one
//     sector (a sector two clusters write half each costs the memory a read-modify-write).
//     One thread-block cluster of K blocks
//     (a power of two up to 16, non-portable above 8) holds an item in shared memory, block
//     r rows [r * rows_per_block, ...), in whole TMA boxes of 64 rows. The clusters are
//     persistent: as many as the card holds at once, each walking items i, i + P, ...
//     Each block has two buffers: TMA loads the next item into one while the block
//     works on the other. A block's work on an item: one pass over its rows for sums of
//     x - shift and their squares (the shift is the group's first value in the block, so
//     fp32 inputs with |mean| >> std keep their precision), reduced over the lanes of a
//     warp by shuffles and over the warps in a fixed order into the block's (mean, M2) of
//     each group; a cluster barrier; a warp a group, a lane a block, every block's
//     (mean, M2) read through distributed shared memory and merged with Chan's formula
//     over a fixed tree of the ranks, so that all K blocks get the same bits; the affine
//     folded into registers; y written in place of x a 16-row box at a time, each box
//     stored by TMA as soon as its warp has written it. x is read once and y written once:
//     one device operation a forward, no scratch. With an `ab` pointer the first block of
//     each cluster also writes a and b (N, C), which the tests read;
//   * the two-pass form (lkgd_group_norm) for what does not fit (the level-0 temporal
//     resblocks, the VAE's full resolution, the CogVideoX decode): gn_stats_kernel with
//     the fold on the device, then gn_apply_kernel. Three device operations: a memset of
//     the tickets, the statistics, the normalise pass. lkgd_gn_apply is the normalise pass
//     alone, on a and b the caller gives.
//
// There is no fallback between them: a refused launch is an error.
//
// What bounds it on the H100: device-memory bytes at no more than ~10 FLOPs a byte. The
// one-pass form's bound is x read once and y written once (2 x 165 MB at the UNet's
// level-0 (28, 9216, 320) bf16: 0.0986 ms at 3.35 TB/s); the two-pass form reads x twice.
// In the one-pass form a block's work on an item runs between the transfers it overlaps
// (the next item's load, this item's stores), so its length counts: with SiLU the
// special-function unit (16 operations a clock an SM, two a value) bounds the normalise.
//
// gn_stats_kernel, the statistics pass of the two-pass form:
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
//
// gn_apply_kernel, the normalise pass of the two-pass form, walks the stats kernel's own
// grid (chunk_plan: whole-row tiles, rows down): each thread owns the same 16-byte column
// of channels on every row it visits, so a and b are loaded once into registers and the
// loop has no division or remainder; kUnroll loads are in flight before the first store.
//
// The SiLU (silu), in both types: __expf and a fast reciprocal, within a few fp32 ulps of
// t * sigmoid(t) for every t, so that a bf16 output is its correct rounding but where t *
// sigmoid(t) lies within those ulps of a rounding boundary (tests/test_torch_kernels_cuda.py
// holds both kernels to a bf16 ulp over t in [-20, 20]). Its two special-function operations
// (an SM issues 16 a clock) bound the one-pass form's normalise at bf16; the accurate expf
// and IEEE division made one pass slower than two at fp32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "flash_wgmma.cuh"  // lkgd::word

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // threads a block
constexpr int kUnroll = 8;         // 16-byte loads a thread has in flight
constexpr int kTileFloats = kThreads * 8;  // shared floats for a block's per-thread sums
constexpr int kMaxSlabGroups = 128;        // groups in one slab of the one-pass form
constexpr int kMaxCluster = 16;            // blocks a cluster (above 8: non-portable)
constexpr int kSmemMax = 232448;           // shared memory a block may have on the H100
constexpr int kFusedThreads = 512;  // threads a block of the one-pass form
// the one-pass form's shared memory beside the slab's rows, in bytes: the warps' and the
// block's sums and sums of squares of each channel, the block's (mean, M2) of each group
// for two items (read by the cluster's other blocks), the groups' shifts, merged means and
// inverse standard deviations, and an mbarrier for each of two buffers
constexpr int kFusedFixedFloats = 7 * kMaxSlabGroups;
inline long long fused_extra(long long slab_ch) {
  return (2 * (kFusedThreads / 32 + 1) * slab_ch + kFusedFixedFloats) * 4 + 16;
}
constexpr int kMaxDevices = 64;
constexpr int kBoxRows = 64;     // rows of a TMA box the one-pass form loads
constexpr int kStoreRows = 16;   // rows of a TMA box it stores: a warp's share at a time
constexpr int kMaxBoxDim = 256;  // elements of a TMA box along a dimension

// 16 bytes of a stream read once: read-only path, no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// One box of a rank-3 tensor map (C, M, N innermost first) -> shared memory, counted in
// bytes on `bar`; rows past M arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of shared memory -> a rank-3 tensor map; rows past M are not written. Completion
// is tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ uint4 to_raw(const float (&in)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
  return raw;
}

__device__ __forceinline__ uint4 to_raw(const float (&in)[4]) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                    __float_as_uint(in[3]));
}

// t * sigmoid(t) with __expf and a fast reciprocal (two special-function operations): q =
// sigmoid(-|t|) = e / (1 + e), e = exp(-|t|) in (0, 1], then t * q for t < 0 and t - t * q
// for t >= 0. Neither sign takes a difference of near values, so the result is within a
// few fp32 ulps of t * sigmoid(t) for every t (a form on 1 + tanh(t / 2) cancels for t < 0)
__device__ __forceinline__ float silu(float t) {
  const float e = __expf(-fabsf(t)), q = __fdividef(e, 1.f + e);
  return t >= 0.f ? fmaf(-t, q, t) : t * q;
}

// y = act(x * a + b) on one 16-byte vector, in fp32
template <typename T, bool SILU, int VEC>
__device__ __forceinline__ uint4 normalise(const uint4& raw, const float (&a)[VEC],
                                           const float (&b)[VEC]) {
  float v[VEC];
  to_float(raw, v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float t = fmaf(v[e], a[e], b[e]);
    v[e] = SILU ? silu(t) : t;
  }
  return to_raw(v);
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

__device__ __forceinline__ float param(const void* p, long long i, bool is_bf16) {
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

// grid (C / tile, n_chunks, N), the stats kernel's: thread (tx, ty) normalises channels
// [tile * blockIdx.x + VEC * tx, + VEC) of rows r0 + ty, r0 + ty + lanes_y, ... of its chunk.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads, 3)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, int m, int c, int tile, int rows_per_chunk) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes_x = tile / VEC, lanes_y = kThreads / lanes_x;
  const int tx = threadIdx.x % lanes_x, ty = threadIdx.x / lanes_x;
  const int n = blockIdx.z, chunk = blockIdx.y, r0 = chunk * rows_per_chunk + ty;
  const int r1 = min(m, (chunk + 1) * rows_per_chunk);
  if (ty >= lanes_y || r0 >= r1) return;
  const int col = blockIdx.x * tile + tx * VEC;
  float av[VEC], bv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    av[e] = __ldg(a + (long long)n * c + col + e);
    bv[e] = __ldg(b + (long long)n * c + col + e);
  }
  const long long step = (long long)lanes_y * c, first = ((long long)n * m + r0) * c + col;
  const T* px = x + first;
  T* py = y + first;
  int left = (r1 - r0 + lanes_y - 1) / lanes_y;
  for (; left >= kUnroll; left -= kUnroll, px += kUnroll * step, py += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = ld_stream(px + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<uint4*>(py + u * step) = normalise<T, SILU, VEC>(raw[u], av, bv);
  }
  for (; left > 0; --left, px += step, py += step)
    *reinterpret_cast<uint4*>(py) = normalise<T, SILU, VEC>(ld_stream(px), av, bv);
}

cudaError_t launch_apply(const void* x, void* y, const float* a, const float* b, int n, int m,
                         int c, int tile, int rows_per_chunk, int n_chunks, bool silu,
                         bool is_bf16, cudaStream_t s) {
  const dim3 grid(unsigned(c / tile), unsigned(n_chunks), unsigned(n));
  if (is_bf16) {
    const bf16* xi = static_cast<const bf16*>(x);
    bf16* yo = static_cast<bf16*>(y);
    if (silu)
      gn_apply_kernel<bf16, true><<<grid, kThreads, 0, s>>>(xi, yo, a, b, m, c, tile,
                                                            rows_per_chunk);
    else
      gn_apply_kernel<bf16, false><<<grid, kThreads, 0, s>>>(xi, yo, a, b, m, c, tile,
                                                             rows_per_chunk);
  } else {
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    if (silu)
      gn_apply_kernel<float, true><<<grid, kThreads, 0, s>>>(xi, yo, a, b, m, c, tile,
                                                             rows_per_chunk);
    else
      gn_apply_kernel<float, false><<<grid, kThreads, 0, s>>>(xi, yo, a, b, m, c, tile,
                                                              rows_per_chunk);
  }
  return cudaGetLastError();
}

// The block's statistics of each group of the slab about the group's shift: the threads'
// per-channel sums `s1`, `s2` (column tx = tid % lanes_x) summed over the lanes of a warp
// that share a column (shuffles at fixed offsets), the warps' per-channel sums into `red`
// (two planes of warps x slab_ch), then over the warps in order and over a group's channels
// in order; group g's (mean, M2) over the block's `rows` rows into mean[g], m2[g]. Ends
// with the block synchronised.
template <int VEC>
__device__ __forceinline__ void block_group_stats(float (&s1)[VEC], float (&s2)[VEC],
                                                  const float* shift, float* red, float* mean,
                                                  float* m2, int lanes_x, int slab_ch, int cgw,
                                                  int slab_groups, int rows) {
  constexpr int kWarps = kFusedThreads / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float t1 = s1[e], t2 = s2[e];
    for (int o = lanes_x; o < 32; o += lanes_x) {
      const float u1 = __shfl_down_sync(0xffffffffu, s1[e], o);
      const float u2 = __shfl_down_sync(0xffffffffu, s2[e], o);
      if (lane + o < 32) {
        t1 += u1;
        t2 += u2;
      }
    }
    s1[e] = t1;
    s2[e] = t2;
  }
  if (lane < lanes_x) {
    const int col = (tid % lanes_x) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[warp * slab_ch + col + e] = s1[e];
      red[(kWarps + warp) * slab_ch + col + e] = s2[e];
    }
  }
  __syncthreads();
  float* chan = red + 2 * kWarps * slab_ch;  // the block's per-channel totals, two planes
  for (int i = tid; i < 2 * slab_ch; i += kFusedThreads) {
    const int plane = i / slab_ch, c = i % slab_ch;
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[(plane * kWarps + w) * slab_ch + c];
    chan[i] = t;
  }
  __syncthreads();
  const int g = tid;
  if (g < slab_groups) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < cgw; ++k) {
      t1 += chan[g * cgw + k];
      t2 += chan[slab_ch + g * cgw + k];
    }
    const float n = float(rows) * float(cgw), d = t1 / n;
    mean[g] = shift[g] + d;
    m2[g] = fmaxf(t2 - t1 * d, 0.f);
  }
  __syncthreads();
}

struct FusedArgs {
  const void* weight;  // (C) bf16 or fp32, as bias
  const void* bias;
  float* ab;           // a then b, (N, C) each, or null
  int n, m, c, groups, slab_groups, rows_per_block, param_bf16;
  float eps;
};

// grid (cluster x P), clusters (cluster, 1, 1): P persistent clusters walk the N x C /
// slab channels items (sample, slab) in turn, cluster i taking items i, i + P, ...; its
// block of rank r holds rows [r * rows_per_block, (r + 1) * rows_per_block) of the item
// (the last short) in one of two buffers: TMA fills one with the next item while the block
// normalises the other in place and TMA stores it.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kFusedThreads, 1)
    gn_one_pass_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_y, const FusedArgs p) {
  using namespace lkgd::sm90;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), blocks = int(cluster.num_blocks());
  const int cgw = p.c / p.groups, slab_ch = p.slab_groups * cgw;
  const int slabs = p.groups / p.slab_groups, items = p.n * slabs;
  const int lanes_x = slab_ch / VEC, lanes_y = kFusedThreads / lanes_x;
  const int tid = threadIdx.x, tx = tid % lanes_x, ty = tid / lanes_x;
  const int r0 = rank * p.rows_per_block;
  const int rows = max(0, min(p.rows_per_block, p.m - r0));
  const int mine = ty < lanes_y ? rows : 0;  // rows below which this thread's lie
  const int buffer = p.rows_per_block * lanes_x;  // 16-byte vectors
  const uint32_t box_bytes = uint32_t(kBoxRows * slab_ch * sizeof(T));
  const int boxes = (rows + kBoxRows - 1) / kBoxRows;  // every block has a row
  uint4* data = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(data + 2 * buffer);
  // the block's (mean, M2) of each group, read by the cluster's other blocks: two sets, an
  // item's and the next one's, so that an item's are not written while a peer reads the
  // last item's
  float* part = red + 2 * (kFusedThreads / 32 + 1) * slab_ch;
  float* shift = part + 4 * kMaxSlabGroups;
  float* g_mean = shift + kMaxSlabGroups;
  float* g_rstd = g_mean + kMaxSlabGroups;
  const uint32_t full = smem_u32(g_rstd + kMaxSlabGroups);  // an mbarrier a buffer
  const int stride = gridDim.x / blocks;
  const float count = float(p.m) * float(cgw);

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0: an item's rows of the slab into a buffer, in boxes of kBoxRows rows
  auto load = [&](int item, int b) {
    const uint32_t bar = full + 8 * b, dst = smem_u32(data + b * buffer);
    mbar_arrive_expect_tx(bar, box_bytes * boxes);
    for (int j = 0; j < boxes; ++j)
      tma_load_3d(dst + j * box_bytes, &map_x, bar, (item % slabs) * slab_ch,
                  r0 + j * kBoxRows, item / slabs);
  };

  const int warp = tid / 32, lane = tid % 32;
  // the normalise pass's lanes: a warp takes whole boxes, lane (wr, wc) the same column of
  // rows wr, wr + wrows, ... of each
  const int wrows = 32 / lanes_x, wr = lane / lanes_x, wc = lane % lanes_x;
  int item = blockIdx.x / blocks;
  if (tid == 0 && item < items) load(item, 0);
  for (int k = 0; item < items; ++k, item += stride) {
    const int b = k & 1;
    uint4* cur = data + b * buffer;
    if (item + stride < items) {
      // the other buffer held the last item: every warp's stores of it have left it
      if (k > 0 && lane == 0) bulk_wait_read<0>();
      __syncthreads();
      if (tid == 0) load(item + stride, b ^ 1);
    }
    mbar_wait(full + 8 * b, (k >> 1) & 1);

    // the lane's weights and biases for the normalise pass, loaded now to land meanwhile
    const int col = (item % slabs) * slab_ch + wc * VEC;
    const bool bf = p.param_bf16 != 0;
    float wt[VEC], bs[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wt[e] = param(p.weight, col + e, bf);
      bs[e] = param(p.bias, col + e, bf);
    }

    // one pass over the block's rows: sums of x - shift and its square, the shift being
    // row 0's value in the group's first channel, so that fp32 inputs with |mean| >> std
    // keep their precision
    const T* first_row = reinterpret_cast<const T*>(cur);
    if (tid < p.slab_groups) shift[tid] = to_f(first_row[tid * cgw]);
    __syncthreads();
    float s1[VEC], s2[VEC], sh[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s1[e] = s2[e] = 0.f;
      sh[e] = shift[(tx * VEC + e) / cgw];
    }
#pragma unroll 4
    for (int r = ty; r < mine; r += lanes_y) {
      float v[VEC];
      to_float(cur[r * lanes_x + tx], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[e] - sh[e];
        s1[e] += d;
        s2[e] = fmaf(d, d, s2[e]);
      }
    }
    float* mine_mean = part + (k & 1) * 2 * kMaxSlabGroups;
    float* mine_m2 = mine_mean + kMaxSlabGroups;
    block_group_stats<VEC>(s1, s2, shift, red, mine_mean, mine_m2, lanes_x, slab_ch, cgw,
                           p.slab_groups, rows);
    cluster.sync();
    // a warp a group, a lane a block of the cluster: every block's (mean, M2), read from
    // its shared memory, merged with Chan's formula (the weighted mean first, the M2 about
    // it second) over a fixed tree of the ranks
    for (int g = warp; g < p.slab_groups; g += kFusedThreads / 32) {
      float nq = 0.f, mq = 0.f, m2q = 0.f;
      if (lane < blocks) {
        nq = float(min(p.rows_per_block, p.m - lane * p.rows_per_block)) * float(cgw);
        mq = cluster.map_shared_rank(mine_mean, lane)[g];
        m2q = cluster.map_shared_rank(mine_m2, lane)[g];
      }
      const float mean = warp_sum(nq * mq) / count, d = mq - mean;
      const float m2 = warp_sum(fmaf(nq * d, d, m2q));
      if (lane == 0) {
        g_mean[g] = mean;
        g_rstd[g] = rsqrtf(m2 / count + p.eps);
      }
    }
    __syncthreads();

    // the affine of the lane's channels, then y in place of x a box at a time, each box
    // stored by TMA as soon as its warp has written it
    float a[VEC], sft[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int g = (wc * VEC + e) / cgw;
      a[e] = g_rstd[g] * wt[e];
      sft[e] = bs[e] - g_mean[g] * a[e];
    }
    if (p.ab != nullptr && rank == 0 && warp == 0 && wr == 0) {
      float* pa = p.ab + (long long)(item / slabs) * p.c + col;
      float* pb = pa + (long long)p.n * p.c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        pa[e] = a[e];
        pb[e] = sft[e];
      }
    }
    for (int j = warp; j * kStoreRows < rows; j += kFusedThreads / 32) {
      const int in_box = min(kStoreRows, rows - j * kStoreRows);
      uint4* box = cur + j * kStoreRows * lanes_x;
      // four rows' loads in flight before their stores
      for (int r = wr; wr < wrows && r < in_box; r += 4 * wrows) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r + u * wrows < in_box) v[u] = box[(r + u * wrows) * lanes_x + wc];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r + u * wrows < in_box)
            box[(r + u * wrows) * lanes_x + wc] = normalise<T, SILU, VEC>(v[u], a, sft);
      }
      fence_proxy_async();  // the lanes' writes of y are visible to the TMA store
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&map_y, smem_u32(box), (item % slabs) * slab_ch, r0 + j * kStoreRows,
                     item / slabs);
        bulk_commit();
      }
    }
  }
  if (lane == 0) bulk_wait<0>();  // a warp's last stores are done before the memory goes
  // a peer may still read this block's statistics of its last item until every block of
  // the cluster has arrived here
  cluster.sync();
}

template <typename T, bool SILU>
void* one_pass_kernel() {
  return reinterpret_cast<void*>(gn_one_pass_kernel<T, SILU>);
}

void* pick_one_pass(bool is_bf16, bool silu) {
  if (is_bf16) return silu ? one_pass_kernel<bf16, true>() : one_pass_kernel<bf16, false>();
  return silu ? one_pass_kernel<float, true>() : one_pass_kernel<float, false>();
}

// Shared memory above 48 KB and clusters above 8 blocks are opt-in, a function and a
// device at a time: done once for each of the four kernels on each device.
cudaError_t prepare_one_pass(const void* kernel, int index, int device) {
  static bool ready[kMaxDevices][4] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device][index]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  ready[device][index] = err == cudaSuccess;
  return err;
}

// The one-pass form's launch from its packed plan (see lkgd_gn_one_pass): checks the plan,
// fills the configuration; `err` says whether the plan is one the kernel takes. The grid
// is set by `persistent`.
struct OnePass {
  FusedArgs p;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  void* kernel;
  int index, cluster, items;
  bool is_bf16;
  cudaError_t err;

  OnePass(const void* shape, float eps)
      : p(), cfg(), attr(), kernel(nullptr), index(0), cluster(0), items(0), is_bf16(false) {
    const long long n = lkgd::word(shape, 0), m = lkgd::word(shape, 1),
                    c = lkgd::word(shape, 2), groups = lkgd::word(shape, 3),
                    slab_groups = lkgd::word(shape, 4), k = lkgd::word(shape, 5),
                    rows = lkgd::word(shape, 6), flags = lkgd::word(shape, 7);
    const bool silu = flags & 4;
    is_bf16 = flags & 1;
    const long long vec = is_bf16 ? 8 : 4, size = is_bf16 ? 2 : 4;
    const long long cgw = groups > 0 ? c / groups : 0, slab_ch = slab_groups * cgw;
    err = cudaErrorInvalidValue;
    if (n <= 0 || n > 65535 || m <= 0 || m > INT32_MAX || c <= 0 || c > INT32_MAX ||
        groups <= 0 || c % groups || slab_groups <= 0 || slab_groups > kMaxSlabGroups ||
        groups % slab_groups || slab_ch % vec || k <= 0 ||
        slab_ch > kMaxBoxDim || slab_ch / vec > 32 || k > kMaxCluster || rows <= 0 ||
        rows % kBoxRows ||
        k * rows < m || (k - 1) * rows >= m ||
        2 * rows * slab_ch * size + fused_extra(slab_ch) > kSmemMax ||
        n * (groups / slab_groups) > INT32_MAX)
      return;
    p.n = int(n);
    p.m = int(m);
    p.c = int(c);
    p.groups = int(groups);
    p.slab_groups = int(slab_groups);
    p.rows_per_block = int(rows);
    p.param_bf16 = (flags & 2) != 0;
    p.eps = eps;
    index = int(is_bf16) * 2 + int(silu);
    kernel = pick_one_pass(is_bf16, silu);
    cluster = int(k);
    items = int(n * (groups / slab_groups));
    cfg.gridDim = dim3(unsigned(cluster), 1, 1);
    cfg.blockDim = dim3(kFusedThreads, 1, 1);
    cfg.dynamicSmemBytes = size_t(2 * rows * slab_ch * size + fused_extra(slab_ch));
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaSuccess;
  }

  // clusters the device holds at once (cudaOccupancyMaxActiveClusters), asked once for
  // each kernel, cluster, shared memory and device
  cudaError_t resident(int device, int* clusters) {
    struct Entry {
      int index, cluster, device;
      size_t smem;
      int clusters;
    };
    static std::mutex lock;
    static std::vector<Entry> seen;
    std::lock_guard<std::mutex> guard(lock);
    for (const Entry& e : seen)
      if (e.index == index && e.cluster == cluster && e.device == device &&
          e.smem == cfg.dynamicSmemBytes) {
        *clusters = e.clusters;
        return cudaSuccess;
      }
    cudaError_t e = prepare_one_pass(kernel, index, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    if (e == cudaSuccess) seen.push_back({index, cluster, device, cfg.dynamicSmemBytes, *clusters});
    return e;
  }

  // a rank-3 map (C, M, N innermost first) over x or y, boxes of a slab's channels x
  // `box_rows` rows, no swizzle: a box lands as rows of 16-byte vectors, one after the other
  cudaError_t map(CUtensorMap* out, const void* base, int box_rows) const {
    lkgd::sm90::EncodeTiled encode = lkgd::sm90::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t size = is_bf16 ? 2 : 4;
    const cuuint64_t dims[3] = {cuuint64_t(p.c), cuuint64_t(p.m), cuuint64_t(p.n)};
    const cuuint64_t strides[2] = {cuuint64_t(p.c) * size, cuuint64_t(p.m) * p.c * size};
    const cuuint32_t box[3] = {cuuint32_t(p.slab_groups * (p.c / p.groups)),
                               cuuint32_t(box_rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult res = encode(
        out, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
        const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
  }

  // one cluster an item up to as many as the device holds at once
  cudaError_t persistent(int device) {
    int clusters = 0;
    cudaError_t e = resident(device, &clusters);
    if (e != cudaSuccess) return e;
    if (clusters <= 0) return cudaErrorLaunchOutOfResources;
    cfg.gridDim = dim3(unsigned(cluster * (items < clusters ? items : clusters)), 1, 1);
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// One GroupNorm forward over x (N, M, C) in two passes. `shape` packs eight int64: n, m, c,
// groups, tile, rows_per_chunk, n_chunks and flags (1: x is bf16, 2: weight and bias are
// bf16, 4: SiLU). scratch (fp32, 2*N*C + 2*N*n_chunks*groups + N words) receives a, b
// (N, C) first. With y null only the statistics run: a memset and one launch; else the
// normalise pass follows on the same grid.
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
  return int(launch_apply(x, y, p.a, p.b, int(n), int(m), int(c), int(tile), int(rows),
                          int(n_chunks), flags & 4, is_bf16, s));
}

// The normalise pass alone: y = act(x * a + b) with (N, C) fp32 a and b. `shape` packs
// eight int64: n, m, c, tile, rows_per_chunk, n_chunks, flags (1: bf16, 4: SiLU), 0.
int lkgd_gn_apply(const void* x, void* y, const float* a, const float* b, const void* shape,
                  int device, void* stream) {
  const long long n = lkgd::word(shape, 0), m = lkgd::word(shape, 1), c = lkgd::word(shape, 2),
                  tile = lkgd::word(shape, 3), rows = lkgd::word(shape, 4),
                  n_chunks = lkgd::word(shape, 5), flags = lkgd::word(shape, 6);
  const long long vec = (flags & 1) ? 8 : 4;
  if (n <= 0 || n > 65535 || m <= 0 || m > INT32_MAX || tile <= 0 || c % tile ||
      tile % vec || tile / vec > kThreads || rows <= 0 || n_chunks <= 0 ||
      n_chunks > 65535 || (n_chunks - 1) * rows >= m || n_chunks * rows < m)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return int(launch_apply(x, y, a, b, int(n), int(m), int(c), int(tile), int(rows),
                          int(n_chunks), flags & 4, flags & 1, static_cast<cudaStream_t>(stream)));
}

// One GroupNorm forward over x (N, M, C) in one pass. `shape` packs eight int64: n, m, c,
// groups, slab_groups, cluster, rows_per_block and flags (as lkgd_group_norm's). ab, if not
// null, receives a then b, (N, C) fp32 each.
int lkgd_gn_one_pass(const void* x, void* y, const void* weight, const void* bias, float* ab,
                     const void* shape, float eps, int device, void* stream) {
  OnePass op(shape, eps);
  if (op.err != cudaSuccess) return int(op.err);
  // cudaSetDevice makes the device's context current for the tensor maps' encoding
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = op.persistent(device);
  CUtensorMap map_x, map_y;
  if (err == cudaSuccess) err = op.map(&map_x, x, kBoxRows);
  if (err == cudaSuccess) err = op.map(&map_y, y, kStoreRows);
  if (err != cudaSuccess) return int(err);
  op.p.weight = weight;
  op.p.bias = bias;
  op.p.ab = ab;
  op.cfg.stream = static_cast<cudaStream_t>(stream);
  void* args[] = {&map_x, &map_y, &op.p};
  return int(cudaLaunchKernelExC(&op.cfg, op.kernel, args));
}

}  // extern "C"
