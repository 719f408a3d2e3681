"""Pieces the two feature networks share: BatchNorm at evaluation, the random weights of
runs without a checkpoint, and a strict load that leaves out the keys a feature network
never runs."""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class EvalBatchNorm(nn.Module):
    """BatchNorm with frozen statistics (eps 1e-3) over the channels of dim 1: the state
    of a torch BatchNorm (``weight``, ``bias``, ``running_mean``, ``running_var``) without
    its ``num_batches_tracked`` counter, which evaluation never reads."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


def init_synthetic(module: nn.Module, generator: torch.Generator, scale: float) -> None:
    """Convolutions normal x ``scale`` with zero biases, BatchNorm the identity, as the JAX
    package's ``init_synthetic`` (for tests and runs without weights)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                m.weight.normal_(0.0, scale, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, EvalBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def load_feature_state_dict(module: nn.Module, state_dict: Mapping, skip: str) -> None:
    """``module.load_state_dict(..., strict=True)`` of a published checkpoint (torch tensors
    or numpy arrays) without the keys matching ``skip``: heads that the feature map never
    runs and BatchNorm's ``num_batches_tracked``. Every other key must match by name and
    shape."""
    keep = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in state_dict.items() if not re.search(skip, k)}
    module.load_state_dict(keep, strict=True)
