"""Image resizes as two precomputed matrix products, ``out = M_h @ img @ M_w^T``.

* ``resize_with_antialiasing`` (counterpart of ``lkgd_tpu/ops/resize.py``): the reference's
  CLIP conditioning blurs with a gaussian (sigma from the downscale factor, reflect
  padding) and then resizes bicubically (a = -0.75, align_corners=True). Both are fixed
  linear operators for given sizes, composed on the host in float64 into one (out, in)
  matrix per axis.
* ``bicubic_resize``: torch's BICUBIC (a = -0.75, half-pixel centres, align_corners=False,
  no antialias), which Depth-Anything's DINOv2 position embeddings are resampled with
  (``jax.image.resize(..., "cubic")`` is the a = -0.5 kernel and does not match it).
* ``resize_bilinear``: ``jax.image.resize(..., method="bilinear")``, which the JAX
  package's knowledge encoder uses. It antialiases when it downsamples: the triangle
  kernel is widened by the downscale factor and the weights of each output are
  renormalised (``jax._src.image.scale.compute_weight_mat``), which ``F.interpolate``'s
  bilinear mode does not do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    if ksize % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """torch ``F.pad(mode="reflect")`` indexing (no edge repeat)."""
    idx = np.abs(idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return np.clip(idx, 0, n - 1)


def _blur_matrix(n: int, sigma: float, ksize: int) -> np.ndarray:
    kernel = _gaussian_kernel(ksize, sigma)
    m = np.zeros((n, n), dtype=np.float64)
    half = ksize // 2
    for j, w in enumerate(kernel):
        m[np.arange(n), _reflect_index(np.arange(n) + (j - half), n)] += w
    return m


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch bicubic convolution weights of the 4 taps around fractional position t."""

    def c1(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def c2(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return np.stack([c2(t + 1.0), c1(t), c1(1.0 - t), c2(2.0 - t)], axis=-1)


def _bicubic_matrix(out_n: int, in_n: int) -> np.ndarray:
    """align_corners=True bicubic interpolation matrix (out_n, in_n)."""
    if out_n == 1 or in_n == 1:
        x = np.zeros(out_n)
    else:
        x = np.arange(out_n, dtype=np.float64) * (in_n - 1) / (out_n - 1)
    x0 = np.floor(x).astype(np.int64)
    w = _cubic_weights(x - x0)
    m = np.zeros((out_n, in_n), dtype=np.float64)
    for k in range(4):
        m[np.arange(out_n), np.clip(x0 + k - 1, 0, in_n - 1)] += w[:, k]
    return m


@functools.lru_cache(maxsize=64)
def bicubic_matrix_half_pixel(out_n: int, in_n: int) -> np.ndarray:
    """Half-pixel (align_corners=False) bicubic matrix (out_n, in_n), fp32: torch
    ``F.interpolate(mode="bicubic", align_corners=False)``, a = -0.75, no antialias."""
    x = (np.arange(out_n, dtype=np.float64) + 0.5) * in_n / out_n - 0.5
    x0 = np.floor(x).astype(np.int64)
    w = _cubic_weights(x - x0)
    m = np.zeros((out_n, in_n), dtype=np.float64)
    for k in range(4):
        m[np.arange(out_n), np.clip(x0 + k - 1, 0, in_n - 1)] += w[:, k]
    return m.astype(np.float32)


def bicubic_resize(images: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) -> (..., size[0], size[1], C): torch's bicubic as two matrix
    products, fp32 inside, in images.dtype."""
    out_h, out_w = size
    in_h, in_w = images.shape[-3], images.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return images
    m_h, m_w = (torch.from_numpy(bicubic_matrix_half_pixel(o, i)).to(images.device)
                for o, i in ((out_h, in_h), (out_w, in_w)))
    x = torch.einsum("oh,...hwc->...owc", m_h, images.float())
    x = torch.einsum("ow,...hwc->...hoc", m_w, x)
    return x.to(images.dtype)


@functools.lru_cache(maxsize=32)
def resize_matrices(in_h: int, in_w: int, out_h: int, out_w: int):
    """Composed blur + bicubic matrices (out_h, in_h) and (out_w, in_w), fp32 numpy."""
    factors = (in_h / out_h, in_w / out_w)
    sigmas = (max((factors[0] - 1.0) / 2.0, 0.001), max((factors[1] - 1.0) / 2.0, 0.001))
    ks = [int(max(2.0 * 2 * s, 3)) for s in sigmas]
    ks = [k + 1 if k % 2 == 0 else k for k in ks]
    m_h = _bicubic_matrix(out_h, in_h) @ _blur_matrix(in_h, sigmas[0], ks[0])
    m_w = _bicubic_matrix(out_w, in_w) @ _blur_matrix(in_w, sigmas[1], ks[1])
    return m_h.astype(np.float32), m_w.astype(np.float32)


# The matrices reach a device once per size: a copy from the host waits for the device's
# queue to drain, which would stall the host once per call.
@functools.lru_cache(maxsize=32)
def _antialias_matrices_on(in_h: int, in_w: int, out_h: int, out_w: int,
                           device: torch.device):
    return tuple(torch.from_numpy(m).to(device)
                 for m in resize_matrices(in_h, in_w, out_h, out_w))


@functools.lru_cache(maxsize=32)
def _bilinear_matrix_on(in_n: int, out_n: int, device: torch.device,
                        dtype: torch.dtype, antialias: bool = True) -> torch.Tensor:
    return torch.from_numpy(bilinear_matrix(in_n, out_n, antialias)).to(device, dtype)


def resize_with_antialiasing(images: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) -> (..., size[0], size[1], C), fp32 inside, in images.dtype."""
    out_h, out_w = size
    in_h, in_w = images.shape[-3], images.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return images
    m_h, m_w = _antialias_matrices_on(in_h, in_w, out_h, out_w, images.device)
    x = torch.einsum("oh,...hwc->...owc", m_h, images.float())
    x = torch.einsum("ow,...hwc->...hoc", m_w, x)
    return x.to(images.dtype)


@functools.lru_cache(maxsize=32)
def bilinear_matrix(in_n: int, out_n: int, antialias: bool = True) -> np.ndarray:
    """(out_n, in_n) fp32 weights of JAX's bilinear resize along one axis: half-pixel
    centres, a triangle kernel of half-width max(in/out, 1) (1 without ``antialias``), each
    row renormalised to sum to one."""
    inv_scale = in_n / out_n
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_n, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_n - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_bilinear(images: torch.Tensor, size, antialias: bool = True) -> torch.Tensor:
    """(..., H, W, C) -> (..., size[0], size[1], C) as ``jax.image.resize(method=
    "bilinear", antialias=antialias)``, in images.dtype."""
    out_h, out_w = size
    in_h, in_w = images.shape[-3], images.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return images
    m_h, m_w = (_bilinear_matrix_on(i, o, images.device, images.dtype, antialias)
                for i, o in ((in_h, out_h), (in_w, out_w)))
    x = torch.einsum("oh,...hwc->...owc", m_h, images)
    return torch.einsum("ow,...hwc->...hoc", m_w, x)
