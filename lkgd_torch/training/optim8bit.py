"""8-bit Adam moments (counterpart of ``lkgd_tpu/training/optim8bit.py``): the
bitsandbytes ``AdamW8bit`` memory lever of the reference's ``--use_8bit_adam``, in plain
PyTorch.

Both Adam moments are stored blockwise-quantised as int8 codes with one fp32 absmax scale a
block (~1.02 bytes a parameter a moment at ``block=256`` instead of 4). Each step
dequantises, applies the exact AdamW arithmetic in fp32 and requantises. The first moment
uses linear codes; the second, whose entries in one block span many orders of magnitude,
the quartic map ``v = absmax * (code / 127)^4`` (~8 orders covered), since linear codes
would round its small entries to 0 and blow ``m / (sqrt(v) + eps)`` up by ``1 / eps``.
Tensors smaller than ``min_8bit_size`` keep fp32 moments, as bitsandbytes does.

``scale_by_adam8bit`` quantises each tensor's moments on their own; the packed form holds
the moments of all large tensors in one flat buffer, each padded to a block boundary so no
block straddles two tensors: its values are bit-identical to the per-tensor form.
``AdamW8bit`` is the optimizer over a list of parameters (``adamw8bit``), with the
``state_dict`` / ``load_state_dict`` a checkpoint needs.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Union

import torch
import torch.nn.functional as F


class Quantized8(NamedTuple):
    """A tensor stored as int8 codes (its own shape) and fp32 per-block absmax scales."""

    codes: torch.Tensor
    scales: torch.Tensor


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    return F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


def quantize8(x: torch.Tensor, block: int = 256, power: int = 1) -> Quantized8:
    """Blockwise absmax int8 quantisation of a flat view of ``x``: codes =
    ``round(127 * (|x| / absmax)^(1 / power))`` with the sign of ``x``."""
    padded = _blocks(x.reshape(-1).float(), block)
    absmax = padded.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    frac = padded.abs() / scale[:, None]
    if power != 1:
        frac = frac ** (1.0 / power)
    codes = torch.clamp(torch.round(127.0 * frac), 0, 127) * torch.sign(padded)
    return Quantized8(codes.to(torch.int8).reshape(-1)[:x.numel()].reshape(x.shape), absmax)


def dequantize8(q: Quantized8, block: int = 256, power: int = 1) -> torch.Tensor:
    padded = _blocks(q.codes.reshape(-1).float(), block)
    frac = padded.abs() / 127.0
    if power != 1:
        frac = frac ** power
    out = torch.sign(padded) * frac * q.scales[:, None]
    return out.reshape(-1)[:q.codes.numel()].reshape(q.codes.shape)


Moment = Union[Quantized8, torch.Tensor]


@dataclasses.dataclass
class Adam8bitState:
    count: torch.Tensor  # int32, 0-d
    mu: List[Moment]
    nu: List[Moment]


@dataclasses.dataclass
class Adam8bitPackedState:
    count: torch.Tensor
    small_mu: List[torch.Tensor]  # fp32 moments of the small tensors, in order
    small_nu: List[torch.Tensor]
    packed_mu: Quantized8  # one flat (codes, scales) pair for all the large tensors
    packed_nu: Quantized8


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    c = count.float()
    return 1 - b1 ** c, 1 - b2 ** c


class ScaleByAdam8bit:
    """Adam scaling with int8 moments: ``init(params) -> state`` and ``update(grads, state)
    -> (updates, state)`` over lists of tensors, the updates ``m_hat / (sqrt(v_hat) +
    eps)``."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 block: int = 256, min_8bit_size: int = 4096):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.block, self.min_8bit_size = block, min_8bit_size

    def _small(self, x: torch.Tensor) -> bool:
        return x.numel() < self.min_8bit_size

    def init(self, params: Sequence[torch.Tensor]) -> Adam8bitState:
        def zeros(x, power):
            z = torch.zeros_like(x, dtype=torch.float32)
            return z if self._small(x) else quantize8(z, self.block, power)

        return Adam8bitState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                             [zeros(p, 1) for p in params], [zeros(p, 4) for p in params])

    def update(self, grads: Sequence[torch.Tensor], state: Adam8bitState):
        b1, b2, blk = self.b1, self.b2, self.block
        count = state.count + 1
        c1, c2 = _bias_corrections(count, b1, b2)
        updates, mus, nus = [], [], []
        for g, m, v in zip(grads, state.mu, state.nu):
            g = g.float()
            quantized = isinstance(m, Quantized8)
            m = b1 * (dequantize8(m, blk, 1) if quantized else m) + (1 - b1) * g
            v = b2 * (dequantize8(v, blk, 4) if quantized else v) + (1 - b2) * (g * g)
            updates.append((m / c1) / (torch.sqrt(v / c2) + self.eps))
            mus.append(quantize8(m, blk, 1) if quantized else m)
            nus.append(quantize8(v, blk, 4) if quantized else v)
        return updates, Adam8bitState(count, mus, nus)


class ScaleByAdam8bitPacked(ScaleByAdam8bit):
    """``ScaleByAdam8bit`` with the large tensors' moments in one flat buffer: one
    quantise / dequantise chain a moment instead of one a tensor, the same values."""

    def _partition(self, tensors: Sequence[torch.Tensor]):
        """(small indices, large indices, their offsets in the flat buffer, its length)."""
        small, large, offsets, off = [], [], [], 0
        for i, x in enumerate(tensors):
            if self._small(x):
                small.append(i)
            else:
                large.append(i)
                offsets.append(off)
                off += x.numel() + (-x.numel()) % self.block
        return small, large, offsets, off

    def _pack(self, tensors, large) -> torch.Tensor:
        parts = [F.pad(tensors[i].reshape(-1).float(), (0, (-tensors[i].numel()) % self.block))
                 for i in large]
        return torch.cat(parts) if parts else torch.zeros(0, device=tensors[0].device)

    def init(self, params: Sequence[torch.Tensor]) -> Adam8bitPackedState:
        small, _, _, total = self._partition(params)
        device = params[0].device
        zeros = torch.zeros(total, device=device)
        return Adam8bitPackedState(
            torch.zeros((), dtype=torch.int32, device=device),
            [torch.zeros_like(params[i], dtype=torch.float32) for i in small],
            [torch.zeros_like(params[i], dtype=torch.float32) for i in small],
            quantize8(zeros, self.block, 1), quantize8(zeros, self.block, 4))

    def update(self, grads: Sequence[torch.Tensor], state: Adam8bitPackedState):
        b1, b2, blk = self.b1, self.b2, self.block
        count = state.count + 1
        c1, c2 = _bias_corrections(count, b1, b2)
        small, large, offsets, _ = self._partition(grads)
        updates: List[torch.Tensor] = [None] * len(grads)
        g = self._pack(grads, large)
        m = b1 * dequantize8(state.packed_mu, blk, 1) + (1 - b1) * g
        v = b2 * dequantize8(state.packed_nu, blk, 4) + (1 - b2) * (g * g)
        flat = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        for i, off in zip(large, offsets):
            updates[i] = flat[off:off + grads[i].numel()].reshape(grads[i].shape)
        small_mu, small_nu = [], []
        for j, i in enumerate(small):
            gi = grads[i].float()
            sm = b1 * state.small_mu[j] + (1 - b1) * gi
            sv = b2 * state.small_nu[j] + (1 - b2) * (gi * gi)
            small_mu.append(sm)
            small_nu.append(sv)
            updates[i] = (sm / c1) / (torch.sqrt(sv / c2) + self.eps)
        return updates, Adam8bitPackedState(count, small_mu, small_nu, quantize8(m, blk, 1),
                                            quantize8(v, blk, 4))


def _plain(x):
    """A state as tuples, lists and tensors only (what ``torch.load(weights_only=True)``
    reads back)."""
    if isinstance(x, Quantized8):
        return ("q8", x.codes, x.scales)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def _typed(x):
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "q8":
        return Quantized8(x[1], x[2])
    if isinstance(x, list):
        return [_typed(v) for v in x]
    return x


class AdamW8bit:
    """AdamW with 8-bit moments over ``params``: ``p -= lr * (adam8bit(g) + wd * p)``, the
    chain ``scale_by_adam8bit``, ``add_decayed_weights``, ``scale_by_learning_rate`` of the
    JAX package. ``step()`` reads ``p.grad``; ``zero_grad`` as a torch optimizer's."""

    def __init__(self, params: Sequence[torch.nn.Parameter], learning_rate: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, block: int = 256, min_8bit_size: int = 4096,
                 packed: bool = False):
        self.params = list(params)
        self.lr, self.weight_decay = learning_rate, weight_decay
        cls = ScaleByAdam8bitPacked if packed else ScaleByAdam8bit
        self.scale = cls(b1, b2, eps, block, min_8bit_size)
        self.state = self.scale.init(self.params)

    @torch.no_grad()
    def step(self) -> None:
        updates, self.state = self.scale.update([p.grad for p in self.params], self.state)
        for p, u in zip(self.params, updates):
            p.add_((u + self.weight_decay * p.float()).to(p.dtype), alpha=-self.lr)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_dict(self) -> dict:
        return {f.name: _plain(getattr(self.state, f.name))
                for f in dataclasses.fields(self.state)}

    def load_state_dict(self, blob: dict) -> None:
        self.state = type(self.state)(**{k: _typed(v) for k, v in blob.items()})


def adamw8bit(params: Sequence[torch.nn.Parameter], learning_rate: float = 1e-4,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 1e-2, block: int = 256, min_8bit_size: int = 4096,
              packed: bool = False) -> AdamW8bit:
    """AdamW with 8-bit moment state; ``packed=True`` selects the flat-packed layout (the
    same arithmetic, bit for bit)."""
    return AdamW8bit(params, learning_rate, b1, b2, eps, weight_decay, block, min_8bit_size,
                     packed)


def opt_state_bytes(state) -> int:
    """Persistent optimizer-state bytes: every tensor of the state (an ``AdamW8bit``, its
    ``state`` or a torch optimizer's ``state_dict()``)."""
    if isinstance(state, AdamW8bit):
        state = state.state
    if dataclasses.is_dataclass(state):
        state = [getattr(state, f.name) for f in dataclasses.fields(state)]
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        return sum(opt_state_bytes(x) for x in state)
    return 0
