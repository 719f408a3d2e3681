"""Pipeline parallelism (a GPipe schedule) over the mesh's ``stage`` axis (counterpart of
``lkgd_tpu/parallel/pp.py``).

Every rank of the ``stage`` group runs the same call with the same inputs. The L identical
blocks split into S consecutive groups of L/S, one a rank in the group's rank order; the
batch splits into M microbatches, which pass from stage s to stage s+1 by point-to-point
``send``/``recv`` (staged through the host under gloo, as ``sequence.py``'s collectives
are), each stage running its L/S blocks on one microbatch at a time. The last stage's
outputs, joined in microbatch order, reach every rank by a broadcast from it: what JAX's
``psum`` over ``stage`` of the last stage's buffer gives (``lkgd_tpu/parallel/pp.py:118-121``).

JAX runs one ``lax.scan`` of M + S - 1 ticks in which every stage computes, the ticks of
the pipeline's fill and drain (the "bubbles") on zero buffers whose results are discarded.
Here a stage computes only its M real microbatches, in order, and waits in ``recv``
meanwhile: the results are the same and the bubbles cost no compute. Inference only: the
sends carry no gradient.

``cogvideox_pp_blocks`` is the ``blocks_override`` of ``models/cogvideox.py``
``CogVideoXTransformer3D.forward``: the DiT's blocks as the pipeline. It drops the blocks
of the other stages from the transformer, so that a rank holds the weights of its L/S
blocks and the embeddings and heads (``tp.per_device_param_bytes``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from lkgd_torch.parallel.mesh import STAGE_AXIS, host_staged  # noqa: F401 (JAX's name here)


def stack_block_params(params: Dict[str, torch.Tensor], num_blocks: int,
                       prefix: str = "transformer_blocks.") -> Dict[str, torch.Tensor]:
    """JAX's ``stack_block_params`` on the port's names: the entries ``{prefix}{i}.{name}``
    (i < ``num_blocks``) of a state dict stacked into one tree ``{name: (L, ...)}``, the
    layout JAX's ``gpipe`` shards over ``stage``. ``gpipe`` takes such a tree as it takes a
    sequence of L blocks (``unstack_block_params``)."""
    blocks = [{k[len(f"{prefix}{i}."):]: v for k, v in params.items()
               if k.startswith(f"{prefix}{i}.")} for i in range(num_blocks)]
    if not all(b.keys() == blocks[0].keys() for b in blocks) or not blocks[0]:
        raise ValueError(f"the {num_blocks} blocks under {prefix!r} do not hold the same names")
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def unstack_block_params(stacked) -> List:
    """A tree of (L, ...) leaves -> the L trees of its slices along the leading axis."""
    leaves, spec = tree_flatten(stacked)
    return [tree_unflatten([x[i] for x in leaves], spec) for i in range(leaves[0].shape[0])]


def stage_blocks(num_layers: int, stages: int, stage: int) -> range:
    """The consecutive blocks of ``stage``: L/S of them; L must divide by S."""
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers do not split over {stages} stages")
    n = num_layers // stages
    return range(stage * n, (stage + 1) * n)


def _send(xs: Sequence[torch.Tensor], dst: int, group) -> None:
    for x in xs:
        dist.send((x.cpu() if host_staged(x, group) else x).contiguous(), dst, group=group)


def _recv(like: Sequence[torch.Tensor], src: int, group) -> List[torch.Tensor]:
    out = []
    for x in like:
        staged = host_staged(x, group)
        buf = torch.empty(x.shape, dtype=x.dtype, device="cpu" if staged else x.device)
        dist.recv(buf, src, group=group)
        out.append(buf.to(x.device))
    return out


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    staged = host_staged(x, group)
    buf = (x.cpu() if staged else x).contiguous()
    dist.broadcast(buf, src, group=group)
    return buf.to(x.device)


def gpipe(step_fn: Callable, blocks, state, consts, *, group, num_microbatches: int):
    """Run L blocks over the S ranks of ``group`` (the mesh's ``stage`` axis), GPipe-style.

    step_fn(block, state, consts) -> state: ONE block; the blocks are homogeneous and a
    state keeps its leaves' shapes and dtypes through each.
    blocks: a sequence of L per-block items (modules, parameter trees; a rank reads only
    its own L/S, so the others may be None), or a tree of (L, ...) leaves as JAX's
    ``stack_block_params`` makes it. L % S == 0.
    state: a tree of (B, ...) tensors carried through every block (B % M == 0); inputs a
    block reads per sample but does not transform (the adaLN time embedding) belong here as
    pass-through leaves, so that they microbatch with the rest. Every rank passes the same
    state; the first stage reads its values, the others only its shapes.
    consts: batch-independent inputs (the rotary tables), given to every block as they are.

    Returns the state after all L blocks on every rank, equal (up to the re-tiling of
    products over B/M rows) to the blocks run one after another on the whole batch; with
    one microbatch the same arithmetic on the same rows.
    """
    if isinstance(blocks, (dict, torch.Tensor)):
        blocks = unstack_block_params(blocks)
    stages, stage = dist.get_world_size(group), dist.get_rank(group)
    mine = stage_blocks(len(blocks), stages, stage)
    leaves, spec = tree_flatten(state)
    b, m_count = leaves[0].shape[0], num_microbatches
    if b % m_count:
        raise ValueError(f"batch {b} does not split into {m_count} microbatches")
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        raise NotImplementedError("pipeline parallelism is inference only: its sends carry "
                                  "no gradient")
    n = b // m_count
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < stages - 1 else None
    outs = []
    for m in range(m_count):
        rows = [x[m * n:(m + 1) * n] for x in leaves] if m_count > 1 else leaves
        if prev is not None:
            rows = _recv(rows, prev, group)
        st = tree_unflatten(rows, spec)
        for i in mine:
            st = step_fn(blocks[i], st, consts)
        ys = tree_flatten(st)[0]
        if nxt is not None:
            _send(ys, nxt, group)
        else:
            outs.append(ys)
    last = dist.get_global_rank(group, stages - 1)
    if nxt is None:
        full = [torch.cat(parts) for parts in zip(*outs)] if m_count > 1 else outs[0]
    else:
        full = [torch.empty_like(x) for x in leaves]
    return tree_unflatten([_broadcast(x, last, group) for x in full], spec)


class _ElsewhereBlock(nn.Module):
    """The place of a block that lives on another stage: it holds no weights and refuses a
    call."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"transformer block {self.index} lives on stage {self.stage}: call "
                           f"the transformer with the blocks_override of cogvideox_pp_blocks")


def cogvideox_pp_blocks(transformer: nn.Module, group, num_microbatches: int) -> Callable:
    """The ``blocks_override(hidden, encoder, emb, rope) -> (hidden, encoder)`` of
    ``CogVideoXTransformer3D.forward`` that runs its block stack as a GPipe pipeline over
    ``group`` (the embeddings and the output head stay whole on every rank). The blocks of
    the other stages are dropped from ``transformer`` here: this rank keeps its L/S."""
    stages, stage = dist.get_world_size(group), dist.get_rank(group)
    layers = transformer.transformer_blocks
    n = len(stage_blocks(len(layers), stages, stage))
    blocks = list(layers)
    for i in range(len(layers)):
        if i // n != stage:
            layers[i] = _ElsewhereBlock(i, i // n)
            blocks[i] = None

    def step(block, st, rope):
        hidden, encoder = block(st["hidden"], st["encoder"], st["temb"], rope)
        return {"hidden": hidden, "encoder": encoder, "temb": st["temb"]}

    def run(hidden, encoder, emb, rope):
        state = {"hidden": hidden, "encoder": encoder, "temb": emb}
        out = gpipe(step, blocks, state, rope, group=group, num_microbatches=num_microbatches)
        return out["hidden"], out["encoder"]

    return run
