// Flash-attention backward at fp32 (kernels 9 and 10 on fp32 operands): fp32 q, k, v, dO,
// lse and delta in, fp32 dq, dk, dv out, every product an fp32 FFMA on the CUDA cores.
// lkgd_flash_bwd_f32 launches it; flash_attention_bwd.cu holds the bf16 forms.
//
// Replaces, for fp32 operands, the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py
// that _flash_bwd_bhsd drives under the custom VJP _flash_core, whose bodies take fp32
// operands with fp32 accumulation (the JAX SVD fine-tune CLI builds its UNet in fp32, and
// the spatial attention of levels 0 and 1 runs there at 4096 and 1024 tokens):
//   * flash_bwd_dq_f32_kernel ports _flash_bwd_dq_kernel (kernel 9):
//       P = exp2(s * scale * log2e - lse),  dS = P o (dO V^T - delta),  dQ = scale * dS K;
//   * flash_bwd_dkv_f32_kernel ports _flash_bwd_dkv_kernel (kernel 10):
//       dV = P^T dO,  dK = scale * dS^T Q.
// lse is the forward's log2-domain logsumexp (B*H, S_q) and delta = rowsum(dO o O) (B*H,
// S_q), both fp32, computed in PyTorch as JAX does.
//
// Design: a plain tiled kernel, the TPU's split with no atomics (each output written once,
// deterministic, as JAX's is). A block of 256 threads (16 x 16) owns a 64-row tile: 64 query
// rows for dq, looping over 64-key tiles; 64 keys for dk/dv, looping over 64-query tiles.
// The tiles live in shared memory at a row pitch of DP + 1 floats (DP: D padded to 64 or
// 128 with zeros), so that a thread that walks the depth of its four rows and the 16
// threads that read one column of 16 rows both hit distinct banks. A thread owns rows
// {ty + 16 r} x columns {tx + 16 c} of every 64 x 64 score tile and of its output tile
// (4 x DP/16 accumulators a tile). Per streamed tile: S (or S^T) and dP (or dP^T) in one
// pass over the depth, P and dS in registers, then written to shared memory for the
// accumulating products, which read them as rows. Products are exact fp32 FMAs, so the
// result differs from an fp32 reference only by the order of its sums.
//
// Masks: keys past S_k get P = 0 in dq; queries past S_q get lse = +inf and delta = 0 in
// dk/dv, so P = exp2(s - inf) = 0 and dS = 0; rows past the end and columns past D are not
// written. What bounds it on the H100: the fp32 FMA rate (67 TFLOP/s) at best; a thread's
// 4 x 4 score tile reads 16 shared words for 32 FMAs, so shared-memory issue sets the pace.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_wgmma.cuh"

namespace {

using lkgd::Strides;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows of the resident tile and of a streamed tile
constexpr int kSP = kTile + 1; // pitch of the P and dS tiles

template <int DP>
struct F32BwdPlan {
  static constexpr int LD = DP + 1;      // pitch of a q, k, v or dO tile
  static constexpr int NC = DP / 16;     // output columns a thread owns
  // four (64, LD) tiles, then P and dS (dk/dv; dq: dS alone), then lse and delta
  static constexpr int dq_floats = 4 * kTile * LD + kTile * kSP + 2 * kTile;
  static constexpr int dkv_floats = 4 * kTile * LD + 2 * kTile * kSP + 2 * kTile;
};

struct F32BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *out0, *out1;  // dq, or dk and dv
  Strides qs, ks, vs, dos, os0, os1;
  int heads, s_q, s_k, d, n_tiles;
  float scale, scale_log2;
};

// rows r0.. r0 + 63 of one (batch, head) of x into a (64, LD) tile, zeros past `rows` and
// past d; 16-byte loads along the rows
template <int DP>
__device__ __forceinline__ void load_tile(float* tile, const float* x, const Strides& st, int b,
                                          int h, int r0, int rows, int d) {
  constexpr int LD = DP + 1, PER_ROW = DP / 4;
  const float* base = x + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < kTile * PER_ROW; e += kThreads) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && c < d)
      v = __ldg(reinterpret_cast<const float4*>(base + (long long)(r0 + r) * st.s + c));
    float* t = tile + r * LD + c;
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
}

// lse and delta of rows r0.. r0 + 63 (past s_q: +inf and 0, so that P and dS are 0)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const F32BwdArgs& a,
                                          int bh, int r0) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    const bool in = row < a.s_q;
    lse_s[threadIdx.x] = in ? a.lse[(long long)bh * a.s_q + row] : INFINITY;
    delta_s[threadIdx.x] = in ? a.delta[(long long)bh * a.s_q + row] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const F32BwdArgs a) {
  using P = F32BwdPlan<DP>;
  constexpr int LD = P::LD, NC = P::NC;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  float* sLse = sDS + kTile * kSP;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x / a.n_tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = (blockIdx.x % a.n_tiles) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<DP>(sQ, a.q, a.qs, b, h, q0, a.s_q, a.d);
  load_tile<DP>(sDO, a.dout, a.dos, b, h, q0, a.s_q, a.d);
  load_rows(sLse, sDelta, a, bh, q0);

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < a.s_k; k0 += kTile) {
    __syncthreads();  // the last tile's K and dS are read no more
    load_tile<DP>(sK, a.k, a.ks, b, h, k0, a.s_k, a.d);
    load_tile<DP>(sV, a.v, a.vs, b, h, k0, a.s_k, a.d);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int x = 0; x < DP; ++x) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = sQ[(ty + 16 * r) * LD + x];
        dov[r] = sDO[(ty + 16 * r) * LD + x];
        kv[r] = sK[(tx + 16 * r) * LD + x];
        vv[r] = sV[(tx + 16 * r) * LD + x];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float p = k0 + j < a.s_k ? exp2f(s[r][c] * a.scale_log2 - sLse[i]) : 0.f;
        sDS[i * kSP + j] = p * (dp[r][c] - sDelta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float ds[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = sDS[(ty + 16 * r) * kSP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ds[r], kv[c], acc[r][c]);
    }
  }

  float* ob = a.out0 + b * a.os0.b + h * a.os0.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.s_q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.d) ob[(long long)row * a.os0.s + col] = acc[r][c] * a.scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(const F32BwdArgs a) {
  using P = F32BwdPlan<DP>;
  constexpr int LD = P::LD, NC = P::NC;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;  // P^T: keys x queries
  float* sDS = sP + kTile * kSP;  // dS^T
  float* sLse = sDS + kTile * kSP;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x / a.n_tiles, b = bh / a.heads, h = bh % a.heads;
  const int k0 = (blockIdx.x % a.n_tiles) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<DP>(sK, a.k, a.ks, b, h, k0, a.s_k, a.d);
  load_tile<DP>(sV, a.v, a.vs, b, h, k0, a.s_k, a.d);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int q0 = 0; q0 < a.s_q; q0 += kTile) {
    __syncthreads();  // the last tile's Q, dO, P and dS are read no more
    load_tile<DP>(sQ, a.q, a.qs, b, h, q0, a.s_q, a.d);
    load_tile<DP>(sDO, a.dout, a.dos, b, h, q0, a.s_q, a.d);
    load_rows(sLse, sDelta, a, bh, q0);
    __syncthreads();
    // S^T and dP^T: keys {ty + 16 r} x queries {tx + 16 c}
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] = dpt[r][c] = 0.f;
#pragma unroll 4
    for (int x = 0; x < DP; ++x) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = sK[(ty + 16 * r) * LD + x];
        vv[r] = sV[(ty + 16 * r) * LD + x];
        qv[r] = sQ[(tx + 16 * r) * LD + x];
        dov[r] = sDO[(tx + 16 * r) * LD + x];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[r][c] = fmaf(kv[r], qv[c], st[r][c]);
          dpt[r][c] = fmaf(vv[r], dov[c], dpt[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const float p = exp2f(st[r][c] * a.scale_log2 - sLse[i]);
        sP[j * kSP + i] = p;
        sDS[j * kSP + i] = p * (dpt[r][c] - sDelta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float p[4], ds[4], dov[NC], qv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = sP[(ty + 16 * r) * kSP + i];
        ds[r] = sDS[(ty + 16 * r) * kSP + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = sDO[i * LD + tx + 16 * c];
        qv[c] = sQ[i * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] = fmaf(p[r], dov[c], dv[r][c]);
          dk[r][c] = fmaf(ds[r], qv[c], dk[r][c]);
        }
    }
  }

  float* kb = a.out0 + b * a.os0.b + h * a.os0.h;
  float* vb = a.out1 + b * a.os1.b + h * a.os1.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= a.s_k) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.d) {
        kb[(long long)row * a.os0.s + col] = dk[r][c] * a.scale;
        vb[(long long)row * a.os1.s + col] = dv[r][c];
      }
    }
  }
}

template <int DP, bool DKV>
cudaError_t launch(F32BwdArgs a, int batch, cudaStream_t stream) {
  using P = F32BwdPlan<DP>;
  auto kernel = DKV ? flash_bwd_dkv_f32_kernel<DP> : flash_bwd_dq_f32_kernel<DP>;
  const int smem = 4 * (DKV ? P::dkv_floats : P::dq_floats);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  a.n_tiles = ((DKV ? a.s_k : a.s_q) + kTile - 1) / kTile;
  const long long blocks = (long long)batch * a.heads * a.n_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows a block of the fp32 backward keeps resident (query rows for dq, keys for dk/dv) and
// its dynamic shared memory for a head dim d.
int lkgd_flash_bwd_f32_block_rows(int d) {
  (void)d;
  return kTile;
}

int lkgd_flash_bwd_f32_smem_bytes(int d, int dkv) {
  if (d <= 64) return 4 * (dkv ? F32BwdPlan<64>::dkv_floats : F32BwdPlan<64>::dq_floats);
  return 4 * (dkv ? F32BwdPlan<128>::dkv_floats : F32BwdPlan<128>::dq_floats);
}

// lkgd_flash_bwd's arguments (flash_attention_bwd.cu) for fp32 tensors: q, k, v, dout, dq,
// dk, dv (B, S, H, D) fp32 with strides[21] = the (b, s, h) element strides of the seven;
// lse, delta (B*H, s_q) fp32. dkv=0 launches the dq kernel, dkv=1 the dk/dv kernel. D a
// multiple of 8, <= 128; s_q and s_k at least 1; every row 16-byte aligned.
int lkgd_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       const long long* strides, int batch, int heads, int s_q, int s_k, int d,
                       float scale, float scale_log2, int dkv, int device, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || s_q <= 0 || s_k <= 0) return int(cudaErrorInvalidValue);
  const cudaError_t err = lkgd::use_device(device);
  if (err != cudaSuccess) return int(err);
  F32BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = delta;
  Strides* views[4] = {&a.qs, &a.ks, &a.vs, &a.dos};
  for (int i = 0; i < 4; ++i) *views[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int out0 = dkv ? 5 : 4;  // dk (then dv) or dq among the seven stride triples
  a.out0 = static_cast<float*>(dkv ? dk : dq);
  a.out1 = static_cast<float*>(dkv ? dv : nullptr);
  a.os0 = {strides[3 * out0], strides[3 * out0 + 1], strides[3 * out0 + 2]};
  a.os1 = {strides[18], strides[19], strides[20]};
  a.heads = heads;
  a.s_q = s_q;
  a.s_k = s_k;
  a.d = d;
  a.n_tiles = 0;  // set by the launch
  a.scale = scale;
  a.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dkv) return int(d <= 64 ? launch<64, true>(a, batch, s) : launch<128, true>(a, batch, s));
  return int(d <= 64 ? launch<64, false>(a, batch, s) : launch<128, false>(a, batch, s));
}

}  // extern "C"
