"""The process group of sequence parallelism (the ``context`` axis of
``lkgd_tpu/parallel/mesh.py`` ``make_mesh``), on ``torch.distributed``.

The JAX package names devices on a ``jax.sharding.Mesh``; here each process is one rank and
the ``context`` axis is the default process group: ``--mesh context=N`` asks for N ranks,
and N must be the world size. A process that has no group yet initialises one from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``):
NCCL with one card a rank (``cuda:{LOCAL_RANK}``), gloo for ``--device cpu``. A process that
already has one (the tests, the smoke's pair of processes on one card over gloo) keeps it.

The ``model`` and ``data`` axes of the JAX mesh (weight sharding, CFG and data parallelism)
and ``--weight-sharding`` are refused here: they wait for ROADMAP.md Queue 1, item 12.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from lkgd_torch.utils.device import require_device

CONTEXT_AXIS = "context"
ITEM = ("weight sharding, pipeline and data parallelism wait for ROADMAP.md Queue 1, item 12 "
        "(tp.py, pp.py, ZeRO, the model and data axes)")


def parse_mesh(spec: Union[str, Dict[str, int]]) -> Dict[str, int]:
    """``"context=2"`` (or a dict) -> ``{"context": 2}``; any other axis raises."""
    if isinstance(spec, str):
        try:
            axes = {k.strip(): int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
        except ValueError:
            raise ValueError(f"--mesh {spec!r}: expected axis=size[,axis=size]") from None
    else:
        axes = dict(spec)
    other = sorted(set(axes) - {CONTEXT_AXIS})
    if other:
        raise ValueError(f"--mesh axes {other} are not ported to lkgd_torch: only "
                         f"{CONTEXT_AXIS!r} (sequence parallelism); {ITEM}")
    if axes.get(CONTEXT_AXIS, 0) < 1:
        raise ValueError(f"--mesh {spec!r}: the {CONTEXT_AXIS!r} axis needs a size >= 1")
    return axes


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index becomes ``cuda:{LOCAL_RANK}``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def make_mesh(spec: Union[str, Dict[str, int]], device="cuda") -> dist.ProcessGroup:
    """The ``context`` process group for ``spec`` (``--mesh``): the default group, made from
    the environment if the process has none (NCCL for a CUDA ``device``, gloo for the CPU).
    Raises unless its size is the world size."""
    axes = parse_mesh(spec)
    device = require_device(rank_device(device))
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world = dist.get_world_size()
    if axes[CONTEXT_AXIS] != world:
        raise ValueError(f"--mesh {CONTEXT_AXIS}={axes[CONTEXT_AXIS]} needs "
                         f"{axes[CONTEXT_AXIS]} processes, the world has {world} (launch "
                         f"with torchrun --nproc-per-node {axes[CONTEXT_AXIS]})")
    return dist.group.WORLD


def group(axis: str = CONTEXT_AXIS) -> dist.ProcessGroup:
    """The process group of mesh axis ``axis``: the default group, for ``context``."""
    if axis != CONTEXT_AXIS or not dist.is_initialized():
        raise RuntimeError(f"no process group for mesh axis {axis!r}: only {CONTEXT_AXIS!r}, "
                           f"after lkgd_torch.parallel.mesh.make_mesh (--mesh {axis}=N)")
    return dist.group.WORLD


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
