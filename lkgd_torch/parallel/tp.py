"""Weight sharding over the mesh's ``model`` axis: tensor parallelism and FSDP
(counterpart of ``lkgd_tpu/parallel/tp.py``).

The JAX package builds a PartitionSpec tree, ``device_put``s the parameters once and lets
GSPMD insert the collectives. Here a spec is a dict ``{parameter name: dim or None}`` over a
module's ``named_parameters()`` (dim: the port's torch dim that is split, None:
replicated); ``shard_params`` keeps this rank's block of each split parameter (the block a
JAX device at the same ``model`` coordinate holds) and installs the collectives by hand:

* ``cogvideox_tp_specs`` / ``tensor_parallel`` (megatron-style, CogVideoX): ``to_q``,
  ``to_k``, ``to_v`` and ``ff.net.0.proj`` column-parallel (weights and biases split on
  their output dim, torch dim 0: a flax kernel's ``P(None, axis)``), so each rank runs H/P
  heads and 1/P of the hidden units; ``to_out.0`` and ``ff.net.2`` row-parallel (weights
  split on their input dim, torch dim 1: ``P(axis, None)``), each rank's partial product
  summed by one all-reduce over ``model`` (in fp32), the replicated bias added once after
  it. LoRA factors stay replicated, as in JAX; a column layer uses the columns of its B
  that belong to the rank, a row layer the rows of its A, so the one all-reduce carries the
  adapter's partial product too. Inference only.
* ``fsdp_specs`` / ``fully_shard`` (any module: CogVideoX, the SVD UNet, VAE, CLIP): each
  leaf of ``min_size`` elements or more split on its largest axis that divides by the axis
  size; forward pre-hooks on the module that owns it and on that module's parent (which may
  read a child's weight without calling it) all-gather it before use, whichever runs
  first, and the matching post-hook puts the shard back (the ZeRO-3 schedule GSPMD
  derives). The gathered weights are the same tensors, in their original memory format:
  the forward is bit-identical.

JAX decides on flax's layouts: a Dense kernel is (in, out), a convolution kernel
(*spatial, in, out), where torch holds (out, in) and (out, in, *spatial). ``fsdp_specs``
applies JAX's rule, "the largest axis, the first among equal sizes", to the flax shape and
maps the chosen axis back to the torch dim (``flax_dims``), so that square kernels split the
way JAX splits them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import lora_delta
from lkgd_torch.parallel.mesh import MODEL_AXIS
from lkgd_torch.parallel.sequence import all_gather, all_reduce

_COLUMN = ("to_q", "to_k", "to_v", "ff.net.0.proj")
_ROW = ("to_out.0", "ff.net.2")


def named_owners(module: nn.Module):
    """(owning module, its name, key, parameter) for each parameter, once, in the order of
    ``named_parameters()``."""
    seen = set()
    for prefix, sub in module.named_modules():
        for key, p in sub._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield sub, prefix, key, p


def _name(prefix: str, key: str) -> str:
    return f"{prefix}.{key}" if prefix else key


def flax_dims(owner: nn.Module, key: str, p: torch.Tensor) -> tuple:
    """For each axis of the parameter's flax layout, the torch dim that holds it: a Linear
    weight (out, in) is the kernel (in, out); a convolution's (out, in, *k) is (*k, in, out)
    (the temporal (3, 1, 1) convolutions' trailing 1 keeps the order of the other axes);
    every other leaf keeps its layout."""
    if key == "weight" and isinstance(owner, nn.Linear):
        return (1, 0)
    if key == "weight" and isinstance(owner, nn.modules.conv._ConvNd):
        return tuple(range(2, p.dim())) + (1, 0)
    return tuple(range(p.dim()))


def cogvideox_tp_specs(module: nn.Module) -> Dict[str, Optional[int]]:
    """The tensor-parallel placement of a CogVideoX transformer's parameters: column-parallel
    weights and biases on dim 0, row-parallel weights on dim 1, everything else (norms,
    embeddings, adaLN, the patch and output layers, the fusion, LoRA factors and the
    row-parallel biases) replicated."""
    specs = {}
    for owner, prefix, key, p in named_owners(module):
        dim = None
        if not key.startswith("lora_"):
            if prefix.endswith(_COLUMN) and (key == "bias" or p.dim() == 2 and p.shape[0] > 1):
                dim = 0
            elif prefix.endswith(_ROW) and key == "weight" and p.dim() == 2 and p.shape[1] > 1:
                dim = 1
        specs[_name(prefix, key)] = dim
    return specs


def fsdp_specs(module: nn.Module, min_size: int = 2 ** 16, *,
               axis_size: int) -> Dict[str, Optional[int]]:
    """Model-agnostic weight sharding: each leaf of ``min_size`` elements or more split on
    its largest axis (in flax's layout, the first among equal sizes) that divides by
    ``axis_size``; the others replicated. ``axis_size`` is required: without it every leaf
    would be replicated."""
    specs = {}
    for owner, prefix, key, p in named_owners(module):
        dim = None
        if p.numel() >= min_size:
            order = flax_dims(owner, key, p)
            for j in sorted(range(len(order)), key=lambda j: p.shape[order[j]], reverse=True):
                size = p.shape[order[j]]
                if size % axis_size == 0 and size >= axis_size:
                    dim = order[j]
                    break
        specs[_name(prefix, key)] = dim
    return specs


def _block(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, copied in ``x``'s memory format."""
    p, i = dist.get_world_size(pg), dist.get_rank(pg)
    n = x.shape[dim] // p
    return x.narrow(dim, i * n, n).clone()


def _memory_format(x: torch.Tensor):
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


def _refuse_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("tensor parallelism is inference only: its all-reduce "
                                  "carries no gradient")


def _column_forward(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel layer: this rank's output columns (its weight and bias blocks, the
    matching columns of each adapter's B)."""
    _refuse_grad(x)
    pg = layer.tp_group
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    y = F.linear(x, layer.weight.to(x.dtype), bias)
    for spec in getattr(layer, "adapters", ()):
        b = getattr(layer, f"lora_{spec.name}_B")
        y = y + lora_delta(x, getattr(layer, f"lora_{spec.name}_A"), _block(b, 1, pg), spec)
    return y


def _row_forward(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer on this rank's input columns: the partial product (and each
    adapter's, through the rank's rows of A) summed over the group, then the bias."""
    _refuse_grad(x)
    pg = layer.tp_group
    y = F.linear(x, layer.weight.to(x.dtype))
    for spec in getattr(layer, "adapters", ()):
        a = getattr(layer, f"lora_{spec.name}_A")
        y = y + lora_delta(x, _block(a, 0, pg), getattr(layer, f"lora_{spec.name}_B"), spec)
    y = all_reduce(y, pg)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


_PARALLEL_CLASSES = {}


def _make_parallel(layer: nn.Linear, forward, pg) -> None:
    """Give ``layer`` the tensor-parallel ``forward``: its class becomes a subclass of its
    own with that forward (no reference cycle, unlike a bound method stored on the
    instance), and ``tp_group`` its group."""
    key = (type(layer), forward)
    if key not in _PARALLEL_CLASSES:
        kind = "Column" if forward is _column_forward else "Row"
        _PARALLEL_CLASSES[key] = type(f"{kind}Parallel{type(layer).__name__}", (type(layer),),
                                      {"forward": forward})
    layer.__class__ = _PARALLEL_CLASSES[key]
    layer.tp_group = pg


def _gather_hook(pg, unit: nn.Module, args) -> None:
    """Forward pre-hook of an FSDP unit: the split parameters of the unit and of its direct
    children that no enclosing unit has gathered yet, all-gathered in their formats."""
    taken = []
    for owner in unit._fsdp_owners:
        for key, (dim, fmt) in owner._fsdp_dims.items():
            if key not in owner._fsdp_shards:
                owner._fsdp_shards[key] = shard = owner._parameters[key]
                owner._parameters[key] = all_gather(shard.detach(), dim, pg).contiguous(
                    memory_format=fmt)
                taken.append((owner, key))
    unit._fsdp_taken.append(taken)


def _release_hook(unit: nn.Module, args, output) -> None:
    """Forward post-hook: what the matching pre-hook gathered dropped, the shards put back."""
    for owner, key in unit._fsdp_taken.pop():
        owner._parameters[key] = owner._fsdp_shards.pop(key)


def shard_params(module: nn.Module, specs: Dict[str, Optional[int]], pg,
                 gather: bool = False) -> nn.Module:
    """Keep this rank's block of each parameter ``specs`` splits (in place: the same
    ``Parameter`` objects, their data replaced). ``gather=False``: tensor parallelism, each
    split Linear computing on its blocks (dim 0 column-parallel, dim 1 row-parallel, with the
    all-reduce over ``pg``). ``gather=True``: FSDP, the owning modules all-gathering their
    split parameters for the length of their forward. Returns ``module``."""
    size = dist.get_world_size(pg)
    parents = {prefix: (module.get_submodule(prefix.rpartition(".")[0]) if prefix else None)
               for prefix, _ in module.named_modules()}
    for owner, prefix, key, p in list(named_owners(module)):
        dim = specs.get(_name(prefix, key))
        if dim is None:
            continue
        if p.shape[dim] % size:
            raise ValueError(f"{_name(prefix, key)} {tuple(p.shape)}: dim {dim} does not "
                             f"divide by the model axis' {size} ranks")
        fmt = _memory_format(p.data)
        p.data = _block(p.data, dim, pg).contiguous(memory_format=fmt)
        if gather:
            if not hasattr(owner, "_fsdp_dims"):
                owner._fsdp_dims, owner._fsdp_shards = {}, {}
                # units: the owner, and its parent, which may read a child's weights
                # without calling it (an embedding table added to its output)
                for unit in filter(None, (owner, parents[prefix])):
                    if not hasattr(unit, "_fsdp_owners"):
                        unit._fsdp_owners, unit._fsdp_taken = [], []
                        unit.register_forward_pre_hook(functools.partial(_gather_hook, pg))
                        unit.register_forward_hook(_release_hook)
                    unit._fsdp_owners.append(owner)
            owner._fsdp_dims[key] = (dim, fmt)
        elif key == "weight":
            if not isinstance(owner, nn.Linear) or dim not in (0, 1):
                raise ValueError(f"tensor parallelism splits Linear weights only: "
                                 f"{_name(prefix, key)} on dim {dim}")
            _make_parallel(owner, _column_forward if dim == 0 else _row_forward, pg)
    return module


def tensor_parallel(transformer: nn.Module, pg) -> nn.Module:
    """A CogVideoX transformer made tensor-parallel over ``pg`` (``cogvideox_tp_specs``):
    each rank holds and runs H/P heads and 1/P of every feed-forward. The heads must divide
    by the group's size."""
    size = dist.get_world_size(pg)
    heads = transformer.config.num_attention_heads
    if heads % size:
        raise ValueError(f"tensor parallelism splits the {heads} heads over the {size} ranks "
                         f"of the {MODEL_AXIS!r} axis: {heads} does not divide by {size}")
    return shard_params(transformer, cogvideox_tp_specs(transformer), pg)


def fully_shard(module: nn.Module, pg, min_size: int = 2 ** 16) -> nn.Module:
    """``module``'s weights sharded over ``pg`` (``fsdp_specs``), gathered at use."""
    specs = fsdp_specs(module, min_size, axis_size=dist.get_world_size(pg))
    return shard_params(module, specs, pg, gather=True)


def per_device_param_bytes(module: nn.Module) -> int:
    """Bytes of the parameters this rank holds (its blocks of the split ones)."""
    return sum(p.numel() * p.element_size() for *_, p in named_owners(module))
