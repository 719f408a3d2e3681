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

from lkgd_torch.ops.flash_attention import (LOG2E, flash_attention,
                                           flash_attention_differentiable, flash_fwd_lse)

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


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, S, H, D) attention returning (out (B, S_q, H, D) in q.dtype, lse2 (B, S_q, H)
    fp32): ``lse2`` is the log2-domain logsumexp of the scaled logits, so that partial
    results over disjoint key blocks combine exactly as out = sum_i out_i 2^(lse_i - LSE),
    LSE = log2 sum_i 2^lse_i (``lkgd_tpu/ops/attention.py`` ``attention_with_lse``).

    Sequences of 1024 or more (``use_flash``): ``flash_fwd_lse``, whose kernel 7 subtracts
    its own key block's Cauchy-Schwarz bound ``t`` and writes ``log2(l) - t``, the absolute
    value whatever ``t`` is. Below: the plain formula, fp32 logits and sums."""
    if use_flash(q, k, None):
        out, lse = flash_fwd_lse(q, k, v)
        return out, lse.transpose(1, 2)
    scale = q.shape[-1] ** -0.5
    logits2 = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = logits2.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out, (m + torch.log2(l))[..., 0].transpose(1, 2)
