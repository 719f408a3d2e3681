"""The device mesh of ``lkgd_tpu/parallel/mesh.py`` ``make_mesh`` on ``torch.distributed``:
one process a rank, one process group a line of each mesh axis.

``--mesh data=2,context=2,model=2`` asks for 8 ranks (the product of the sizes must be the
world size), laid out row-major over the axes in the order given, as JAX reshapes its
device list (``np.asarray(devices).reshape(axes.values())``): rank ``r`` sits at the
coordinates ``np.unravel_index(r, sizes)``. Each axis has one group per line of ranks that
differ only in that axis; ``Mesh.groups[axis]`` is this rank's, handed to whatever splits
its work over that axis. Every rank creates every group in the same order
(``dist.new_group`` is collective). The axes:

* ``data``: CFG and batch rows (``sequence.cfg_parallel_split``, data-parallel training);
* ``context``: the DiT's video tokens (``sequence.py``), SVD's frames;
* ``model``: the weights (``tp.py``: tensor parallel or FSDP);
* ``stage``: the DiT's blocks, L/S consecutive ones a rank (``pp.py``, a GPipe pipeline
  through CogVideoX's ``blocks_override``).

A process that has no default group yet initialises one from the environment ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL with one card a rank
(``cuda:{LOCAL_RANK}``), gloo for ``--device cpu``. A process that already has one (the
tests, the smoke's pairs of processes on one card over gloo) keeps it. Under gloo a
collective carries a CUDA tensor through the host (``host_staged``).

``slice`` (the JAX mesh's multi-slice DCN axis) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from lkgd_torch.utils.device import require_device

DATA_AXIS, CONTEXT_AXIS, MODEL_AXIS, STAGE_AXIS = "data", "context", "model", "stage"
AXES = (DATA_AXIS, CONTEXT_AXIS, MODEL_AXIS, STAGE_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes' sizes in the order given and this rank's group along each."""

    axes: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]


def parse_mesh(spec: Union[str, Dict[str, int]]) -> Dict[str, int]:
    """``"data=2,context=2"`` (or a dict) -> ``{"data": 2, "context": 2}``, in order; an axis
    other than data, context, model and stage raises."""
    if isinstance(spec, str):
        try:
            axes = {k.strip(): int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
        except ValueError:
            raise ValueError(f"--mesh {spec!r}: expected axis=size[,axis=size]") from None
    else:
        axes = dict(spec)
    other = sorted(set(axes) - set(AXES))
    if other:
        raise ValueError(f"--mesh axes {other} are not ported to lkgd_torch: only "
                         f"{', '.join(map(repr, AXES))}")
    bad = [a for a, n in axes.items() if n < 1]
    if bad or not axes:
        raise ValueError(f"--mesh {spec!r}: every axis needs a size >= 1")
    return axes


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index becomes ``cuda:{LOCAL_RANK}``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def make_mesh(spec: Union[str, Dict[str, int]], device="cuda") -> Mesh:
    """The mesh of ``spec`` (``--mesh``) over the default group, made from the environment if
    the process has none (NCCL for a CUDA ``device``, gloo for the CPU). Raises unless the
    product of the axis sizes is the world size."""
    axes = parse_mesh(spec)
    device = require_device(rank_device(device))
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(axes.values())
    if n != world:
        shown = ",".join(f"{a}={s}" for a, s in axes.items())
        raise ValueError(f"--mesh {shown} needs {n} processes, the world has {world} (launch "
                         f"with torchrun --nproc-per-node {n})")
    sizes = tuple(axes.values())
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for d, axis in enumerate(axes):
        if axes[axis] == world:
            groups[axis] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, d, -1).reshape(-1, axes[axis])
        for line in lines:  # every rank makes every group, in the same order
            pg = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = pg
    return Mesh(axes, groups)


def host_staged(x: torch.Tensor, pg: Optional[dist.ProcessGroup] = None) -> bool:
    """Whether a collective of ``pg`` carries ``x`` through the host: gloo moves CPU tensors
    only (two ranks on one card run over gloo, since NCCL refuses a card twice)."""
    return x.is_cuda and dist.get_backend(pg) == "gloo"


@torch.no_grad()
def check_replicated(tensors, pg: Optional[dist.ProcessGroup] = None,
                     what: str = "weights") -> None:
    """Raise unless every rank of ``pg`` holds the same ``tensors`` (parameters, latents):
    each tensor's fp64 sum and sum of squares, all-reduced by MAX and MIN, must agree
    exactly."""
    sums = torch.stack([torch.stack((t.sum(dtype=torch.float64),
                                     t.float().square().sum(dtype=torch.float64)))
                        for t in tensors]).flatten()
    if host_staged(sums, pg):
        sums = sums.cpu()
    high, low = sums.clone(), sums.clone()
    dist.all_reduce(high, op=dist.ReduceOp.MAX, group=pg)
    dist.all_reduce(low, op=dist.ReduceOp.MIN, group=pg)
    if not torch.equal(high, low):
        bad = int((high != low).nonzero()[0, 0]) // 2
        raise RuntimeError(f"the ranks' {what} differ (tensor {bad} of {len(tensors)}): every "
                           f"rank must build them from the same --seed")
