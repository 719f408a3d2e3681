"""The SVD training step: EDM video-diffusion fine-tuning (counterpart of
``lkgd_tpu/training/train_state.py``).

EDM sigma sampling, conditioning dropout, channel-concatenated conditioning, the UNet
forward, the EDM weighted MSE (``training/edm.py``) and a masked AdamW update with a
global-norm clip. Only the trainable parameters (a predicate on parameter names, e.g. LoRA
factors and the knowledge fusion) require grad and reach the optimizer: frozen ones get no
update and stay bit-identical, which is what optax's ``multi_transform`` with
``set_to_zero`` gives the JAX package. Parameters live in the module, so the state is the
module, the optimizer, the step and the EMA.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from lkgd_torch.parallel.sequence import all_gather, all_reduce, shard
from lkgd_torch.training import edm
from lkgd_torch.training.optim8bit import adamw8bit


_JOINT_BRANCH = re.compile(r"(^|\.)(attn1n|conv1n|scale1n|norm1n)(\.|$)")


def trainable_trans(name: str) -> bool:
    """LoRA factors and the joint branch: the trained set of ``--mode trans`` and of the
    SD-2D joint LoRA step. The JAX package selects ``"lora" in path or "joint" in path``;
    here the branch's parameters sit on the block under their own names (``attn1n``,
    ``conv1n``, ``scale1n``, ``norm1n``), with no ``joint`` scope."""
    return "lora_" in name or _JOINT_BRANCH.search(name) is not None


class MaskedAdamW:
    """AdamW after a global-norm clip, over the parameters ``trainable_predicate`` selects
    (all when it is None). ``init(module)`` binds it to a module's parameters; ``step()``
    clips, updates and clears the gradients.

    The clip is optax's ``clip_by_global_norm``: gradients scale by exactly
    ``max_norm / norm`` when ``norm >= max_norm`` (``clip_grad_norm_`` would divide by
    ``norm + 1e-6``), decided on the device with no host sync. torch's AdamW applies the
    decoupled weight decay ``p -= lr * wd * p`` and the bias-corrected Adam update as
    ``optax.adamw`` does. ``use_8bit``: the moments held in 8 bits
    (``training/optim8bit.py`` ``adamw8bit``; ``"packed"`` for its flat-packed form).

    Data parallelism (``group``, a process group: each rank's loss over its rows of the
    batch): the gradients are averaged over the group, in one fp32 all-reduce, before the
    clip. ZeRO (``training/trainer.py`` ``zero_shard_opt_state`` sets ``shards``): the inner
    optimizer holds this rank's block of each split parameter and its moments alone, steps
    it on the same block of the averaged gradient, and the blocks are all-gathered into the
    parameters after."""

    def __init__(self, learning_rate: float = 1e-4, weight_decay: float = 1e-2,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: float = 1.0,
                 trainable_predicate: Optional[Callable[[str], bool]] = None,
                 use_8bit: Union[bool, str] = False):
        self.hyper = dict(lr=learning_rate, weight_decay=weight_decay, betas=(b1, b2), eps=eps)
        self.max_grad_norm = max_grad_norm
        self.predicate = trainable_predicate or (lambda name: True)
        self.use_8bit = use_8bit
        self.params: Dict[str, nn.Parameter] = {}
        self.adamw = None
        self.group = None
        self.shards: Dict[str, Tuple[Optional[int], torch.Tensor]] = {}

    def init(self, module: nn.Module) -> None:
        """Mark the trainable parameters (and only those) as requiring grad."""
        self.params = {}
        for name, p in module.named_parameters():
            p.requires_grad_(self.predicate(name))
            if p.requires_grad:
                self.params[name] = p
        if not self.params:
            raise ValueError("MaskedAdamW: the predicate selects no parameter")
        self.adamw = self.inner(list(self.params.values()))

    def inner(self, params):
        """The AdamW (8-bit where asked) over ``params``."""
        if self.use_8bit:
            h = self.hyper
            return adamw8bit(params, h["lr"], *h["betas"], eps=h["eps"],
                             weight_decay=h["weight_decay"], packed=self.use_8bit == "packed")
        return torch.optim.AdamW(params, **self.hyper)

    @torch.no_grad()
    def clip_grads(self) -> torch.Tensor:
        """Scale the gradients to a global norm of at most ``max_grad_norm``; returns the
        norm before clipping."""
        grads = [p.grad for p in self.params.values()]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                     for g in grads]))
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                            self.max_grad_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        return norm

    @torch.no_grad()
    def average_grads(self) -> None:
        """The gradients averaged over ``group``: one fp32 all-reduce of all of them."""
        grads = [p.grad for p in self.params.values()]
        flat = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), self.group)
        flat /= dist.get_world_size(self.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def step(self) -> torch.Tensor:
        for p in self.params.values():
            if p.grad is None:  # an unused trainable: optax still decays it
                p.grad = torch.zeros_like(p)
        if self.group is not None:
            self.average_grads()
        norm = self.clip_grads()
        if not self.shards:
            self.adamw.step()
            self.adamw.zero_grad(set_to_none=True)
            return norm
        with torch.no_grad():
            for name, (dim, block) in self.shards.items():
                if dim is not None:  # this rank's block of the gradient
                    block.grad = shard(self.params[name].grad, dim, self.group).clone()
            self.adamw.step()
            self.adamw.zero_grad(set_to_none=True)
            for name, (dim, block) in self.shards.items():
                p = self.params[name]
                p.grad = None
                if dim is not None:
                    p.copy_(all_gather(block, dim, self.group))
        return norm

    def state_dict(self) -> dict:
        if self.shards:
            raise NotImplementedError("a ZeRO optimizer holds this rank's moments only: its "
                                      "state is not checkpointed")
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 1e-2,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   trainable_predicate: Optional[Callable[[str], bool]] = None,
                   use_8bit: Union[bool, str] = False) -> MaskedAdamW:
    """AdamW with a global-norm clip over the trainable parameters; ``use_8bit=True`` holds
    the moments in 8 bits (``training/optim8bit.py``), ``"packed"`` in its packed form."""
    return MaskedAdamW(learning_rate, weight_decay, b1, b2, eps, max_grad_norm,
                       trainable_predicate, use_8bit)


@dataclasses.dataclass
class TrainState:
    step: int
    unet: nn.Module
    optimizer: MaskedAdamW
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def trainables(self) -> Dict[str, nn.Parameter]:
        return self.optimizer.params


def init_train_state(unet: nn.Module, optimizer: MaskedAdamW, ema: bool = False) -> TrainState:
    optimizer.init(unet)
    ema_params = ({n: p.detach().clone() for n, p in optimizer.params.items()} if ema
                  else None)
    return TrainState(0, unet, optimizer, ema_params)


@dataclasses.dataclass(frozen=True)
class SVDTrainConfig:
    edm: edm.EDMConfig = edm.EDMConfig()
    conditioning_dropout_prob: Optional[float] = 0.1
    train_noise_aug: float = 0.02
    fps: int = 6
    motion_bucket_id: int = 127
    # joint two-stream batches, rows interleaved [x0, y0, x1, y1, ...]: one sigma drawn a
    # pair and repeated, so that coupled streams share their noise level
    tie_stream_pairs: bool = False


def svd_draws(config: SVDTrainConfig, shape, generator: Optional[torch.Generator], device,
              sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
              dropout_u: Optional[torch.Tensor] = None) -> tuple:
    """The step's random draws for latents of ``shape``, in ``svd_loss``'s order: sigmas
    (B,) (one a stream pair under ``tie_stream_pairs``), the noise, and the conditioning
    dropout's uniforms (B,) when the dropout is on (else None); given ones are kept. A
    data-parallel rank draws them at the whole batch's shape and keeps its rows."""
    bsz = shape[0]
    if sigmas is None and config.tie_stream_pairs:
        sigmas = edm.rand_cosine_interpolated((bsz // 2,), config.edm, generator=generator,
                                              device=device).repeat_interleave(2)
    elif sigmas is None:
        sigmas = edm.rand_cosine_interpolated((bsz,), config.edm, generator=generator,
                                              device=device)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if config.conditioning_dropout_prob and dropout_u is None:
        dropout_u = torch.rand((bsz,), generator=generator, device=device)
    return sigmas, noise, dropout_u


def svd_loss(unet: nn.Module, batch: dict, config: SVDTrainConfig,
             generator: Optional[torch.Generator] = None,
             sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             dropout_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The EDM loss of one batch.

    batch: ``latents`` (B, T, h, w, 4) scaled video latents, ``cond_latents`` (B, h, w, 4)
    first-frame latents, ``image_embeddings`` (B, 1, D), optional ``domain_features`` /
    ``flow_features`` (B, 1, K). ``sigmas`` (B,), ``noise`` (latents' shape, standard
    normal) and ``dropout_u`` (B,) uniform: given values in place of draws from
    ``generator`` (``sigmas`` per row also under ``tie_stream_pairs``)."""
    latents = batch["latents"].float()
    bsz, num_frames = latents.shape[:2]
    device = latents.device
    sigmas, noise, dropout_u = svd_draws(config, latents.shape, generator, device, sigmas,
                                         noise, dropout_u)
    noisy, inp = edm.precondition_inputs(latents, noise.float(), sigmas.float())
    timesteps = edm.timesteps_from_sigmas(sigmas.float())

    ehs, cond_latents = batch["image_embeddings"], batch["cond_latents"]
    p = config.conditioning_dropout_prob
    if p:  # conditioning dropout for classifier-free guidance
        ehs = torch.where((dropout_u < 2 * p)[:, None, None], torch.zeros_like(ehs), ehs)
        image_mask = 1.0 - ((dropout_u >= p) & (dropout_u < 3 * p)).to(cond_latents.dtype)
        cond_latents = cond_latents * image_mask[:, None, None, None]

    cond = cond_latents[:, None].expand(-1, num_frames, -1, -1, -1)
    model_in = torch.cat([inp.to(cond.dtype), cond], dim=-1)
    # filled on the device: a host tensor's copy would wait for the queued preprocessing
    added_time_ids = torch.stack([
        torch.full((bsz,), float(v), dtype=torch.float32, device=device)
        for v in (config.fps, config.motion_bucket_id, config.train_noise_aug)], dim=1)
    pred = unet(model_in, timesteps, ehs, added_time_ids,
                domain_features=batch.get("domain_features"),
                flow_features=batch.get("flow_features"))
    return edm.edm_loss(pred.float(), noisy, latents, sigmas.float())


def make_svd_train_step(config: SVDTrainConfig = SVDTrainConfig()):
    """``train_step(state, batch, generator=None, *, sigmas=None, noise=None,
    dropout_u=None) -> (state, loss)``: one optimizer step of ``state.unet`` by
    ``state.optimizer`` (the state is updated in place and returned, as the JAX step
    returns its new state); ``loss`` is a 0-d device tensor."""

    def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   **inject):
        loss = svd_loss(state.unet, batch, config, generator, **inject)
        loss.backward()
        state.optimizer.step()
        if state.ema_params is not None:
            with torch.no_grad():
                for name, p in state.trainables.items():
                    state.ema_params[name].mul_(0.9999).add_(p, alpha=0.0001)
        state.step += 1
        return state, loss.detach()

    return train_step
