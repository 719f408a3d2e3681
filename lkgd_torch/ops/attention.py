"""Attention dispatch over ``(B, S, H, D)`` tensors (port of ``lkgd_tpu/ops/attention.py``).

Long sequences (spatial attention at UNet levels 0-1, the VAE mid-block) go to the flash
kernels: no mask, S_q and S_k >= 1024, D % 8 == 0 and D <= 512 (attention.py:25-43 and
flash_attention.py:507-513). Everything else (CLIP's 257 tokens, deep UNet levels, tests
at small sizes) runs the plain matmul-softmax form of ``_xla_attention``. A flash call
that cannot run raises: nothing falls back behind the caller's back.

A flash call whose q, k or v requires a gradient (with grad mode on) goes through the
autograd Function of the training kernels (7-10); every other one keeps the inference
kernels (1/2). This mirrors JAX, whose primal is ``_flash_bhsd`` and whose VJP forward
rule alone runs the LSE forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from lkgd_torch.ops.flash_attention import flash_attention, flash_attention_differentiable

FLASH_MIN_SEQ = 1024


def use_flash(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> bool:
    d = q.shape[-1]
    return (mask is None and q.shape[1] >= FLASH_MIN_SEQ and k.shape[1] >= FLASH_MIN_SEQ
            and d % 8 == 0 and d <= 512)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_xla_attention``: fp32 logits and softmax, probabilities cast to q.dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over (B, S, H, D) tensors; returns (B, S_q, H, D)."""
    if use_flash(q, k, mask):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return flash_attention_differentiable(q, k, v)
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, mask)
