"""Sequence-parallel attention over a process group: Ulysses and ring (counterpart of
``lkgd_tpu/parallel/sequence.py``).

Each rank holds its shard of the token axis, (B, S/P, H, D), as JAX's ``shard_map`` bodies
see theirs; the collectives are ``torch.distributed``'s over the group (NCCL with one card a
rank, or gloo, through which a CUDA tensor travels via the host: ``mesh.host_staged``); the
all-to-all is pairwise sends and receives on both.

* ``ulysses_attention``: one all-to-all trades the sequence shard of q, k and v (stacked)
  for a head shard, each rank attends over the whole sequence with H/P heads
  (``dot_product_attention``: the flash forward, kernels 1/2, at 1024+ tokens), one
  all-to-all trades back. H must divide by P.
* ``ring_attention``: the K/V shards pass round the ring (rank i sends to i+1), each
  rank's queries meet every block through ``attention_with_lse`` (kernel 7 guarded by 8
  at 1024+ tokens), and the partial results merge exactly in fp32 in the log2 domain:
  ``num 2^(m - m_new) + o 2^(lse - m_new)``. The next block's transfer runs while the
  current one is attended. O(S/P) K/V memory a rank.

``joint_sp_attention`` is CogVideoX's form: a replicated text prefix [text | video shard].
Ulysses slices the text heads of its head shard and all-gathers the text output's heads;
ring meets the text K/V block first, then the P video blocks, with the text queries padded
to a multiple of P and each rank attending its slice of them, then all-gathered. All of it
is inference only: nothing here carries a gradient.

``cfg_parallel_split`` is the ``data`` axis of inference (xDiT's CFG parallelism): a rank's
contiguous block of the CFG-doubled batch rows. ``all_gather`` and ``all_reduce`` are the
collectives the other axes share (``tp.py``, the pipelines), staged through the host under
gloo like the rest.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from lkgd_torch.ops.attention import attention_with_lse, dot_product_attention
from lkgd_torch.parallel.mesh import host_staged


def _refuse_grad(*xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError("sequence-parallel attention is inference only: its "
                                  "collectives carry no gradient")


def _all_to_all(chunks: List[torch.Tensor], pg) -> List[torch.Tensor]:
    """Chunk j to rank j; returns the chunks each rank sent here, by rank (all of one shape).
    Pairwise sends and receives in one batch on every backend: NCCL groups them as its own
    all-to-all does, and the gloo of some torch builds has no all-to-all."""
    staged = host_staged(chunks[0], pg)
    send = [(c.cpu() if staged else c).contiguous() for c in chunks]
    recv = [torch.empty_like(c) for c in send]
    me = dist.get_rank(pg)
    recv[me].copy_(send[me])
    ops = []
    for j in range(len(send)):
        if j != me:
            peer = dist.get_global_rank(pg, j)
            ops += [dist.P2POp(dist.isend, send[j], peer, pg),
                    dist.P2POp(dist.irecv, recv[j], peer, pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(chunks[0].device) for r in recv] if staged else recv


def all_gather(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order, on every rank."""
    staged = host_staged(x, pg)
    xs = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, xs, group=pg)
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce(x: torch.Tensor, pg) -> torch.Tensor:
    """The sum of the ranks' ``x`` on every rank, added in fp32 (bf16 partial products of a
    row-parallel layer are rounded once, after the sum) and returned in ``x``'s dtype."""
    staged = host_staged(x, pg)
    xs = x.float()
    xs = xs.cpu() if staged else xs.clone() if xs.dtype == x.dtype else xs
    dist.all_reduce(xs, group=pg)
    return xs.to(x.device, x.dtype)


def shard(x: torch.Tensor, dim: int, pg, what: str = "rows") -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (the inverse of ``all_gather``);
    the size of ``dim`` must divide by the group's size."""
    p, i = dist.get_world_size(pg), dist.get_rank(pg)
    if x.shape[dim] % p:
        raise ValueError(f"the mesh splits the {x.shape[dim]} {what} over {p} ranks: "
                         f"{x.shape[dim]} does not divide by {p}")
    n = x.shape[dim] // p
    return x.narrow(dim, i * n, n)


def cfg_parallel_split(batch: torch.Tensor, pg) -> torch.Tensor:
    """This rank's block of the rows of ``batch``: the CFG halves are batch rows, so
    splitting them over the ``data`` axis is CFG parallelism."""
    return shard(batch, 0, pg, "batch rows")


class _Ring:
    """Passes tensors to the next rank of the group and takes the previous rank's, posted
    asynchronously (``start``) and awaited (``wait``)."""

    def __init__(self, pg):
        self.pg = pg
        p, i = dist.get_world_size(pg), dist.get_rank(pg)
        self.dst = dist.get_global_rank(pg, (i + 1) % p)
        self.src = dist.get_global_rank(pg, (i - 1) % p)
        self.pending = None

    def start(self, *xs: torch.Tensor) -> None:
        staged = host_staged(xs[0], self.pg)
        self.device = xs[0].device
        send = [(x.cpu() if staged else x).contiguous() for x in xs]
        recv = [torch.empty_like(x) for x in send]
        ops = [dist.P2POp(dist.isend, s, self.dst, self.pg) for s in send]
        ops += [dist.P2POp(dist.irecv, r, self.src, self.pg) for r in recv]
        self.pending = (dist.batch_isend_irecv(ops), send, recv, staged)

    def wait(self) -> tuple:
        reqs, _, recv, staged = self.pending
        for req in reqs:
            req.wait()
        self.pending = None
        return tuple(r.to(self.device) for r in recv) if staged else tuple(recv)


class _Merge:
    """The exact log2-domain merge of partial attention results over disjoint key blocks,
    in fp32: ``num`` (B, S, H, D), running max ``m`` and denominator ``den`` (B, S, H)."""

    def __init__(self, out: torch.Tensor, lse: torch.Tensor):
        self.num, self.m, self.den = out.float(), lse, torch.ones_like(lse)

    def add(self, out: torch.Tensor, lse: torch.Tensor) -> None:
        m_new = torch.maximum(self.m, lse)
        c_old, c_new = torch.exp2(self.m - m_new), torch.exp2(lse - m_new)
        self.num = self.num * c_old[..., None] + out.float() * c_new[..., None]
        self.den = self.den * c_old + c_new
        self.m = m_new

    def result(self, dtype: torch.dtype) -> torch.Tensor:
        return (self.num / self.den[..., None]).to(dtype)

    def lse(self) -> torch.Tensor:
        return self.m + torch.log2(self.den)


def merge_partials(parts: List[tuple]) -> tuple:
    """(out, lse (B, S, H)) of one set of queries against disjoint key blocks -> (out in
    fp32, lse) of the attention over all of them, by the ring's merge."""
    merge = _Merge(*parts[0])
    for out, lse in parts[1:]:
        merge.add(out, lse)
    return merge.result(torch.float32), merge.lse()


def _ring_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pg,
               merge: Optional[_Merge]) -> _Merge:
    """``q`` against the P K/V blocks of the ring, starting with this rank's: each block's
    (out, lse) merged into ``merge`` (a new one for the first block when None)."""
    p = dist.get_world_size(pg)
    ring = _Ring(pg)
    for step in range(p):
        if step < p - 1:
            ring.start(k, v)
        out, lse = attention_with_lse(q, k, v)
        if merge is None:
            merge = _Merge(out, lse)
        else:
            merge.add(out, lse)
        if step < p - 1:
            k, v = ring.wait()
    return merge


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pg) -> torch.Tensor:
    """(B, S/P, H, D) shards of a sequence -> this rank's (B, S/P, H, D) shard of the
    attention over the whole sequence. H must divide by the group's size."""
    _refuse_grad(q, k, v)
    p = dist.get_world_size(pg)
    _check_heads(q.shape[2], p)
    hp = q.shape[2] // p
    qkv = torch.stack((q, k, v))  # (3, B, S/P, H, D)
    q, k, v = torch.cat(_all_to_all(list(qkv.split(hp, dim=3)), pg), dim=2).unbind(0)
    out = dot_product_attention(q, k, v)  # (B, S, H/P, D)
    return torch.cat(_all_to_all(list(out.chunk(p, dim=1)), pg), dim=2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pg) -> torch.Tensor:
    """(B, S/P, H, D) shards of a sequence -> this rank's (B, S/P, H, D) shard of the
    attention over the whole sequence, the K/V shards passed round the ring."""
    _refuse_grad(q, k, v)
    return _ring_pass(q, k, v, pg, None).result(q.dtype)


def _check_heads(h: int, p: int) -> None:
    if h % p:
        raise ValueError(f"Ulysses sequence parallelism splits the {h} heads over the {p} "
                         f"ranks: {h} does not divide by {p}")


def _ulysses_joint(qt, kt, vt, qv, kv, vv, pg):
    p, i = dist.get_world_size(pg), dist.get_rank(pg)
    _check_heads(qt.shape[2], p)
    hp, st = qt.shape[2] // p, qt.shape[1]
    qkv = torch.stack((qv, kv, vv))  # (3, B, Sv/P, H, D)
    qv, kv, vv = torch.cat(_all_to_all(list(qkv.split(hp, dim=3)), pg), dim=2).unbind(0)
    heads = slice(i * hp, (i + 1) * hp)
    q = torch.cat([qt[:, :, heads], qv], dim=1)
    k = torch.cat([kt[:, :, heads], kv], dim=1)
    v = torch.cat([vt[:, :, heads], vv], dim=1)
    out = dot_product_attention(q, k, v)  # (B, St + Sv, H/P, D)
    ov = torch.cat(_all_to_all(list(out[:, st:].chunk(p, dim=1)), pg), dim=2)
    ot = all_gather(out[:, :st], 2, pg)  # the text rows' heads back together
    return ot, ov


def _ring_joint(qt, kt, vt, qv, kv, vv, pg):
    p, i = dist.get_world_size(pg), dist.get_rank(pg)
    st = qt.shape[1]
    n = -(-st // p)  # text queries a rank, the text padded up to a multiple of P
    qt = torch.nn.functional.pad(qt, (0, 0, 0, 0, 0, n * p - st))
    q = torch.cat([qt[:, i * n:(i + 1) * n], qv], dim=1)  # (B, St/P + Sv/P, H, D)
    merge = _Merge(*attention_with_lse(q, kt, vt))  # the replicated text block first
    out = _ring_pass(q, kv, vv, pg, merge).result(qv.dtype)
    ot = all_gather(out[:, :n], 1, pg)[:, :st]  # the pad rows dropped
    return ot, out[:, n:]


def joint_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, text_len: int,
                       mode: str, pg) -> torch.Tensor:
    """Sequence-parallel attention over a joint (B, St + Sv/P, H, D) stream: the text
    prefix of ``text_len`` tokens replicated on every rank, then this rank's shard of the
    video tokens. ``mode``: "ulysses" (needs H % P == 0) or "ring". Returns this rank's
    (B, St + Sv/P, H, D): the text rows whole, the video rows of its shard."""
    _refuse_grad(q, k, v)
    body = {"ulysses": _ulysses_joint, "ring": _ring_joint}[mode]
    t = slice(0, text_len)
    s = slice(text_len, None)
    ot, ov = body(q[:, t], k[:, t], v[:, t], q[:, s], k[:, s], v[:, s], pg)
    return torch.cat([ot, ov], dim=1)
