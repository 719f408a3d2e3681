// Head split and merge copies for Hopper (sm_90a): (B, S, H, D) <-> (B, H, S, D), for any
// element type whose rows of D are a multiple of 16 bytes (bf16 on the training path), up
// to three tensors in one launch.
//
// Replaces the Pallas TPU kernels of lkgd_tpu/ops/flash_attention.py that the flash
// wrapper _flash_attention_local runs around the custom VJP _flash_core:
//   * SPLIT=true ports _split_heads_kernel (via _split_heads): (B, S, H*D) projections ->
//     (B*H, S, D), each head's rows contiguous;
//   * SPLIT=false ports _merge_heads_kernel (via _merge_heads): (B*H, S, D) -> (B, S, H*D).
// Each is the other's VJP, as in JAX. The port's autograd Function of flash attention
// splits q, k and v in one launch and merges out in the forward, splits dO and merges dq, dk
// and dv in one launch in the backward: what it saves for the backward, and the tiles the
// backward kernels re-read once per key or query tile, are one contiguous (S, D) slab per
// (batch, head). The tensors of a launch share B, H and D; their S may differ (S_q, S_k).
//
// What bounds it on the H100: device-memory bytes, one read and one write of every tensor
// and no arithmetic (UNet level 0 of the fine-tune, 3 x (8, 4096, 5, 64) bf16: 63 MB each
// way, more than the 50 MB L2). On the host, a call of a train step costs more to enqueue
// than the copy takes, so the three tensors go in one launch from one C call whose
// per-tensor arguments arrive packed in one buffer. The copy: one thread per 16-byte chunk
// (uint4 loads and stores, four chunks a thread loaded before any is stored), the output
// written in its own order so a warp stores 512 contiguous bytes, the input read as whole
// rows of D through its (b, s, h) strides, so a projection's view is taken as it is; the
// blocks of each tensor follow the last block of the one before, and a block finds its
// tensor from its index. 37 registers; 82% of the byte bound at 3 x (8, 4096, 5, 64) on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md). A TMA copy (a persistent grid of one-warp
// blocks, a ring of 8 KB boxes through a tensor map on each side) moved the same bytes 2-7%
// slower on that card, with six tensor maps to encode a call on the host: not kept.

#include "flash_wgmma.cuh"

namespace {

using namespace lkgd;

constexpr int kMaxParts = 3;

// One tensor of a launch: source base and its (b, s, h) strides in bytes, its length S and
// its output's first byte in y.
struct Part {
  const char* x;
  long long sb, ss, sh;
  long long y_off;
  int s_len;
};

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunksPerBlock = kThreads * kPerThread;

struct Group {
  Part p[kMaxParts];
  unsigned first_block[kMaxParts];  // a part's first block; ~0u past the last part
  unsigned chunks[kMaxParts];       // 16-byte chunks of a part
  unsigned heads, rowc;             // H, and the 16-byte chunks of a row of D
};

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    relayout_heads_kernel(const __grid_constant__ Group g, char* __restrict__ y) {
  const int t = (blockIdx.x >= g.first_block[1]) + (blockIdx.x >= g.first_block[2]);
  const Part& p = g.p[t];
  const unsigned n = g.chunks[t], s_len = unsigned(p.s_len);
  const unsigned first = (blockIdx.x - g.first_block[t]) * kChunksPerBlock + threadIdx.x;
  uint4 v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const unsigned i = first + u * kThreads;
    if (i >= n) break;
    const unsigned c = i % g.rowc;
    unsigned r = i / g.rowc, s, h;
    if (SPLIT) {  // output (B, H, S, D)
      s = r % s_len;
      r /= s_len;
      h = r % g.heads;
      r /= g.heads;
    } else {  // output (B, S, H, D)
      h = r % g.heads;
      r /= g.heads;
      s = r % s_len;
      r /= s_len;
    }
    v[u] = __ldg(reinterpret_cast<const uint4*>(p.x + r * p.sb + s * p.ss + h * p.sh + 16ll * c));
  }
  uint4* out = reinterpret_cast<uint4*>(y + p.y_off);
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const unsigned i = first + u * kThreads;
    if (i >= n) break;
    out[i] = v[u];
  }
}

}  // namespace

extern "C" {

// Up to three (B, S_i, H, D) views into one dense buffer y. `parts` packs n records of five
// int64: the view's address, its (b, s, h) strides in bytes (D's is 1 element) and S_i.
// Part i goes to byte sum_{j<i} B*S_j*H*row_bytes of y, laid out (B, H, S_i, D) when
// split=1 and (B, S_i, H, D) when split=0; row_bytes = D * element size. Every address,
// stride and row_bytes is a multiple of 16 bytes.
int lkgd_relayout_heads(int split, int n, const void* parts, void* y, int batch, int heads,
                        int row_bytes, int device, void* stream) {
  if (n < 1 || n > kMaxParts || row_bytes <= 0 || row_bytes % 16) return int(cudaErrorInvalidValue);
  const cudaError_t err = lkgd::use_device(device);
  if (err != cudaSuccess) return int(err);
  Group g;
  g.heads = unsigned(heads);
  g.rowc = unsigned(row_bytes / 16);
  unsigned blocks = 0;
  long long y_off = 0;
  for (int t = 0; t < kMaxParts; ++t) {
    const int r = t < n ? t : 0;  // a part past n repeats the first and owns no block
    Part& p = g.p[t];
    p.x = reinterpret_cast<const char*>(lkgd::word(parts, 5 * r));
    p.sb = lkgd::word(parts, 5 * r + 1);
    p.ss = lkgd::word(parts, 5 * r + 2);
    p.sh = lkgd::word(parts, 5 * r + 3);
    p.s_len = int(lkgd::word(parts, 5 * r + 4));
    p.y_off = y_off;
    g.chunks[t] = t < n ? unsigned(batch) * unsigned(p.s_len) * g.heads * g.rowc : 0;
    g.first_block[t] = t < n ? blocks : ~0u;
    blocks += (g.chunks[t] + kChunksPerBlock - 1) / kChunksPerBlock;
    y_off += 16ll * g.chunks[t];
  }
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* out = static_cast<char*>(y);
  if (split)
    relayout_heads_kernel<true><<<blocks, kThreads, 0, st>>>(g, out);
  else
    relayout_heads_kernel<false><<<blocks, kThreads, 0, st>>>(g, out);
  return int(cudaGetLastError());
}

}  // extern "C"
