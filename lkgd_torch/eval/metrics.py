"""Quality metrics (counterpart of ``lkgd_tpu/eval/metrics.py``): PSNR and global-window
SSIM, the Frechet distance behind FID and FVD, CLIP features and the CLIP score, the LAION
aesthetic head, and the depth metrics with least-squares scale and shift alignment.

The Frechet distance takes features from any extractor: ``eval/fid_inception.py``
(InceptionV3, standard FID), ``eval/i3d.py`` (I3D, standard FVD) or CLIP-H
(``make_clip_feature_extractor``: the cheaper CLIP-FID and CLIP-FVD, always labelled so).
Tensor functions take and return torch tensors on any device; the Frechet fit runs on the
host in float64 (numpy and ``scipy.linalg.sqrtm``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from lkgd_torch.models.clip_vision import clip_normalize
from lkgd_torch.ops.resize import resize_with_antialiasing


# ------------------------------------------------------------------ pixel metrics
def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Global-window SSIM of each image, averaged ((B, H, W, C) in [0, 1])."""
    a, b = a.float(), b.float()
    axes = tuple(range(1, a.ndim))
    mu_a = a.mean(axes, keepdim=True)
    mu_b = b.mean(axes, keepdim=True)
    var_a = a.var(axes, unbiased=False, keepdim=True)
    var_b = b.var(axes, unbiased=False, keepdim=True)
    cov = ((a - mu_a) * (b - mu_b)).mean(axes, keepdim=True)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


# ------------------------------------------------------------------ Frechet distances
def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """The Frechet distance between gaussians fit to two feature sets (N, D), float64:
    |mu1 - mu2|^2 + tr(S1) + tr(S2) - 2 tr(sqrt(S1 S2)). A square root that is not finite
    is taken again with ``eps`` on the diagonals; its imaginary part is dropped."""
    import scipy.linalg

    feats_a, feats_b = np.asarray(feats_a), np.asarray(feats_b)
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(s1 @ s2)  # no ``disp``: SciPy 1.18 removes it
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fid_from_features(real, fake) -> float:
    return frechet_distance(_host(real), _host(fake))


def fvd_from_features(real_video_feats, fake_video_feats) -> float:
    """Frechet Video Distance over per-video features (N_videos, D)."""
    return frechet_distance(_host(real_video_feats), _host(fake_video_feats))


def make_clip_feature_extractor(clip_model: nn.Module):
    """Images (B, H, W, 3) in [0, 1] -> L2-normalised CLIP embeddings (B, D), for CLIP-FID,
    CLIP-FVD and the CLIP score: the antialiased resize to the model's image size, CLIP's
    normalisation, the projected embedding."""
    size = clip_model.config.image_size

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        x = resize_with_antialiasing(images.float(), (size, size))
        emb = clip_model(clip_normalize(x))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    return extract


# ------------------------------------------------------------------ CLIP score + aesthetics
def clip_score(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """100 * max(cos, 0), averaged (torchmetrics' CLIPScore convention)."""
    a = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1, keepdim=True)
    b = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True)
    return torch.mean(100.0 * torch.clamp((a * b).sum(-1), min=0.0))


class AestheticMLP(nn.Module):
    """The LAION aesthetic predictor head: an MLP on CLIP image embeddings, 768 -> 1024 ->
    128 -> 64 -> 16 -> 1 with ReLU between (its dropout is the identity at evaluation).
    ``layers.<i>`` are the JAX package's ``layers_<i>``."""

    sizes = (1024, 128, 64, 16, 1)

    def __init__(self, in_dim: int = 768):
        super().__init__()
        dims = (in_dim,) + self.sizes
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def init_params(self, generator: torch.Generator) -> None:
        """Weights normal with std fan_in^-1/2, biases zero, as the JAX ``init``."""
        with torch.no_grad():
            for layer in self.layers:
                layer.weight.normal_(0.0, layer.in_features ** -0.5, generator=generator)
                layer.bias.zero_()

    def forward(self, clip_embeds: torch.Tensor) -> torch.Tensor:
        x = clip_embeds
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x[..., 0]


# ------------------------------------------------------------------ depth metrics
def align_depth_least_square(pred: torch.Tensor, gt: torch.Tensor,
                             mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image scale and shift by least squares (the Marigold convention). Returns
    (aligned pred, scale (B,), shift (B,))."""
    p = pred.float().reshape(pred.shape[0], -1)
    g = gt.float().reshape(gt.shape[0], -1)
    m = torch.ones_like(p) if mask is None else mask.float().reshape(mask.shape[0], -1)
    n = m.sum(-1, keepdim=True)
    sp = (m * p).sum(-1, keepdim=True)
    sg = (m * g).sum(-1, keepdim=True)
    spp = (m * p * p).sum(-1, keepdim=True)
    spg = (m * p * g).sum(-1, keepdim=True)
    det = torch.clamp(n * spp - sp ** 2, min=1e-8)
    scale = (n * spg - sp * sg) / det
    shift = (sg * spp - sp * spg) / det
    return (scale * p + shift).reshape(pred.shape), scale[..., 0], shift[..., 0]


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  align: bool = True) -> dict:
    """abs-rel and the delta accuracies at 1.25, 1.25^2, 1.25^3, after alignment."""
    if align:
        pred, _, _ = align_depth_least_square(pred, gt, mask)
    pred = torch.clamp(pred.float(), min=1e-6)
    gt = torch.clamp(gt.float(), min=1e-6)
    m = torch.ones_like(gt) if mask is None else mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    out = {"abs_rel": (m * (pred - gt).abs() / gt).sum() / n}
    ratio = torch.maximum(pred / gt, gt / pred)
    for i, thr in enumerate((1.25, 1.25 ** 2, 1.25 ** 3), start=1):
        out[f"delta{i}"] = (m * (ratio < thr)).sum() / n
    return {k: float(v) for k, v in out.items()}
