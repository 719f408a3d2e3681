"""Gaussian-random-field masks for mask-conditioned joint training: the port's own numpy
copy of ``lkgd_tpu/data/gaussian_masks.py`` (which the port does not import).

Power-law-spectrum gaussian fields thresholded into smooth random masks. Every function
draws from the ``np.random.Generator`` it is given, in the JAX package's order, so one seed
gives the same masks in both packages, bit for bit."""

from __future__ import annotations

from typing import Optional

import numpy as np


def gaussian_random_field(rng: np.random.Generator, alpha: float = 3.0, size: int = 128,
                          normalize: bool = True) -> np.ndarray:
    """(size, size) float64 field with amplitude spectrum |k|^(-alpha/2), zero mean and unit
    std when ``normalize``."""
    k = np.fft.fftshift(np.mgrid[:size, :size] - int((size + 1) / 2))
    amplitude = np.power(k[0] ** 2 + k[1] ** 2 + 1e-10, -alpha / 4.0)
    amplitude[0, 0] = 0
    noise = rng.normal(size=(size, size)) + 1j * rng.normal(size=(size, size))
    field = np.fft.ifft2(noise * amplitude).real
    if normalize:
        field = (field - field.mean()) / (field.std() + 1e-12)
    return field


def gaussian_rand_mask(rng: np.random.Generator, grid_size: int, noise_patch_size: int = 1,
                       thresh: Optional[float] = None) -> np.ndarray:
    """A field at alpha 4 thresholded at ``thresh`` (a standard normal draw when None),
    float32 in {0, 1}, each cell repeated ``noise_patch_size`` times along both axes."""
    field = gaussian_random_field(rng, alpha=4.0, size=grid_size)
    t = rng.normal() if thresh is None else thresh
    mask = (field > t).astype(np.float32)
    if noise_patch_size > 1:
        mask = np.repeat(np.repeat(mask, noise_patch_size, -1), noise_patch_size, -2)
    return mask


def _box_blur(x: np.ndarray, k: int) -> np.ndarray:
    """k x k mean with zero padding, clipped to [0, 1]."""
    pad = k // 2
    xp = np.pad(x, ((pad, pad), (pad, pad)), mode="constant")
    out = np.zeros_like(x)
    for i in range(k):
        for j in range(k):
            out += xp[i:i + x.shape[0], j:j + x.shape[1]]
    return np.clip(out / (k * k), 0, 1)


def _dilate(x: np.ndarray, k: int = 5) -> np.ndarray:
    """k x k maximum with zero padding."""
    pad = k // 2
    xp = np.pad(x, ((pad, pad), (pad, pad)), mode="constant")
    out = np.zeros_like(x)
    for i in range(k):
        for j in range(k):
            out = np.maximum(out, xp[i:i + x.shape[0], j:j + x.shape[1]])
    return out


def get_rand_masks(rng: np.random.Generator, batch_size: int, grid_size: int,
                   thresh: Optional[float] = None, noise_patch_size: int = 1,
                   smooth: bool = False) -> np.ndarray:
    """(B, grid, grid) float32 masks; ``smooth``: each blurred (3 x 3) and dilated (5 x 5),
    then inverted with probability 1/2."""
    masks = np.stack([gaussian_rand_mask(rng, grid_size, noise_patch_size, thresh)
                      for _ in range(batch_size)])
    if smooth:
        masks = np.stack([_dilate(_box_blur(m, 3)) for m in masks])
        flip = rng.random(batch_size) < 0.5
        masks = np.where(flip[:, None, None], masks, 1.0 - masks)
    return masks
