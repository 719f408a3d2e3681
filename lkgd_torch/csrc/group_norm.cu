// GroupNorm statistics and fused normalise(+SiLU) for Hopper (sm_90a), over (N, M, C)
// activations in bf16 or fp32: N samples, M rows (pixels, or frames x pixels), C channels
// innermost (the channels-last layout of the port's convolutions).
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/group_norm.py (_pallas_group_norm):
//   * gn_stats_kernel ports _stats_kernel: per-(sample, channel) statistics over the rows;
//   * gn_apply_kernel ports _apply_kernel: y = act(x * a + b) in fp32, stored in x.dtype,
//     with a and b the per-(sample, channel) affine folded from the statistics.
//
// What bounds it on the H100: device-memory bytes, 2 reads and 1 write of x (at VAE decode
// full resolution, (14, 589824, 128) bf16, 6.3 GB per norm), at no more than a few FLOPs a
// byte. The design moves each byte once per pass at full width:
//   * 16-byte vector loads and stores along C (8 bf16 or 4 fp32 channels a thread);
//   * on the TPU one grid row walks all of M for a sample, which would leave most of the
//     132 SMs idle at N = 1..28, so the stats pass splits M into chunks across blocks.
//     Each block writes its chunk's (mean, M2) per channel to an fp32 scratch made by the
//     caller; a small deterministic fold in PyTorch merges chunks and the channels of a
//     group (Chan's formula), with no atomics;
//   * each thread keeps a running (count, mean, M2) with Welford updates and the block
//     merges them with Chan's formula, so fp32 inputs with |mean| >> std keep their
//     precision (the reason the XLA fp32 form is two-pass);
//   * M need not be a multiple of any chunk: the last chunk is short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // channels a stats block covers
constexpr int kThreads = 256;  // threads a block

__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 raw = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = raw.x;
  out[1] = raw.y;
  out[2] = raw.z;
  out[3] = raw.w;
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

// grid (ceil(C / kTile), n_chunks, N). Writes mean_out/m2_out[(n, chunk, c)].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                    float* __restrict__ m2_out, int M, int C, int rows_per_chunk, int n_chunks) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TX = kTile / VEC;     // threads across the channel tile
  constexpr int TY = kThreads / TX;   // threads down the rows
  __shared__ float s_cnt[TY][TX];
  __shared__ float s_mean[TY][kTile];
  __shared__ float s_m2[TY][kTile];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n = blockIdx.z, chunk = blockIdx.y;
  const int c0 = blockIdx.x * kTile + tx * VEC;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);

  float cnt = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
  if (c0 < C) {
    const T* base = x + (long long)n * M * C + c0;
    for (int r = r0 + ty; r < r1; r += TY) {
      float xv[VEC];
      load_vec(base + (long long)r * C, xv);
      cnt += 1.f;
      const float inv = 1.f / cnt;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float dlt = xv[v] - mean[v];
        mean[v] += dlt * inv;
        m2[v] += dlt * (xv[v] - mean[v]);
      }
    }
  }
  s_cnt[ty][tx] = cnt;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_mean[ty][tx * VEC + v] = mean[v];
    s_m2[ty][tx * VEC + v] = m2[v];
  }
  __syncthreads();

  // tree merge down the rows (Chan et al.)
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
      const float na = s_cnt[ty][tx], nb = s_cnt[ty + s][tx];
      if (nb > 0.f) {
        const float nt = na + nb, wb = nb / nt;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int c = tx * VEC + v;
          const float dlt = s_mean[ty + s][c] - s_mean[ty][c];
          s_mean[ty][c] += dlt * wb;
          s_m2[ty][c] += s_m2[ty + s][c] + dlt * dlt * na * wb;
        }
        s_cnt[ty][tx] = nt;
      }
    }
    __syncthreads();
  }
  if (ty == 0 && c0 < C) {
    const long long o = ((long long)n * n_chunks + chunk) * C + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mean_out[o + v] = s_mean[0][tx * VEC + v];
      m2_out[o + v] = s_m2[0][tx * VEC + v];
    }
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

}  // namespace

extern "C" {

int lkgd_gn_stats(const void* x, float* mean_out, float* m2_out, int n, int m, int c,
                  int rows_per_chunk, int n_chunks, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((c + kTile - 1) / kTile, n_chunks, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    gn_stats_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), mean_out, m2_out,
                                                     m, c, rows_per_chunk, n_chunks);
  else
    gn_stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), mean_out,
                                                      m2_out, m, c, rows_per_chunk, n_chunks);
  return int(cudaGetLastError());
}

int lkgd_gn_apply(const void* x, void* y, const float* a, const float* b, int n, long long mc,
                  int c, int silu, int is_bf16, int blocks_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(blocks_x, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  return int(cudaGetLastError());
}

}  // extern "C"
