// Head split and merge copies for Hopper (sm_90a): (B, S, H, D) <-> (B, H, S, D), for any
// element type whose rows of D are a multiple of 16 bytes (bf16 on the training path).
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py that the flash
// wrapper _flash_attention_local runs around the custom VJP _flash_core:
//   * SPLIT=true ports _split_heads_kernel (via _split_heads): (B, S, H*D) projections ->
//     (B*H, S, D), each head's rows contiguous;
//   * SPLIT=false ports _merge_heads_kernel (via _merge_heads): (B*H, S, D) -> (B, S, H*D).
// Each is the other's VJP, as in JAX. The port's autograd Function of flash attention
// splits q, k, v (and dO in the backward) and merges out (and dq, dk, dv), so what it saves
// for the backward, and the tiles the backward kernels re-read once per key or query tile,
// are one contiguous (S, D) slab per (batch, head).
//
// What bounds it on the H100: device-memory bytes, one read and one write of the tensor
// and no arithmetic (UNet level 0 of the fine-tune, (8, 4096, 5, 64) bf16: 21 MB each
// way). The design moves each byte once at full width:
//   * one thread per 16-byte chunk (8 bf16): uint4 loads and stores;
//   * the output is dense and written in its own order, chunk i at byte 16 i, so a warp
//     stores 512 contiguous bytes; the input is read as whole rows of D (128 bytes at the
//     UNet's D = 64) through its (b, s, h) strides, so a projection's view is taken as it
//     is, with no copy first;
//   * index arithmetic in 32 bits (the wrapper keeps the chunk count below 2^31), byte
//     offsets in 64; a grid-stride loop over a grid of at most 4096 blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

// x: input base, read at b * sb + s * ss + h * sh + 16 c bytes. y: dense output of n
// 16-byte chunks, (B, H, S, D) when SPLIT, (B, S, H, D) otherwise; rowc chunks a row of D.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    relayout_heads_kernel(const char* __restrict__ x, uint4* __restrict__ y, long long sb,
                          long long ss, long long sh, unsigned s_len, unsigned h_len,
                          unsigned rowc, unsigned n) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const unsigned c = i % rowc;
    unsigned r = i / rowc, s, h;
    if (SPLIT) {
      s = r % s_len;
      r /= s_len;
      h = r % h_len;
    } else {
      h = r % h_len;
      r /= h_len;
      s = r % s_len;
    }
    const unsigned b = r / (SPLIT ? h_len : s_len);
    const char* src = x + b * sb + s * ss + h * sh + 16ll * c;
    y[i] = __ldg(reinterpret_cast<const uint4*>(src));
  }
}

}  // namespace

extern "C" {

// x: a (B, S, H, D) view with byte_strides[3] = its (b, s, h) strides in bytes and a unit
// D stride; y: a dense (B, H, S, D) output (split=1) or (B, S, H, D) output (split=0).
// row_chunks = D * element size / 16. Every address and stride is a multiple of 16 bytes.
int lkgd_relayout_heads(const void* x, void* y, const long long* byte_strides, int b, int s,
                        int h, int row_chunks, int split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const unsigned n = unsigned(b) * unsigned(s) * unsigned(h) * unsigned(row_chunks);
  if (n == 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* xi = static_cast<const char*>(x);
  uint4* yo = static_cast<uint4*>(y);
  if (split)
    relayout_heads_kernel<true><<<blocks, kThreads, 0, st>>>(
        xi, yo, byte_strides[0], byte_strides[1], byte_strides[2], s, h, row_chunks, n);
  else
    relayout_heads_kernel<false><<<blocks, kThreads, 0, st>>>(
        xi, yo, byte_strides[0], byte_strides[1], byte_strides[2], s, h, row_chunks, n);
  return int(cudaGetLastError());
}

}  // extern "C"
