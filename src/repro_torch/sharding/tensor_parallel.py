"""Tensor parallelism on the mesh's ``model`` axis (``repro``'s TP rules,
computed).

``repro`` shards compute on ``model`` under ``jit`` by its activation
constraints; the port computes the same split on plain local tensors with
explicit collectives, Megatron-style: a column-parallel projection holds
this rank's output columns, a row-parallel one this rank's input rows, and
three autograd collectives over the ``model`` group join them:

* :func:`copy_in`: identity forward, all-reduce backward (before the
  column-parallel projections of a replicated input);
* :func:`reduce_out`: all-reduce forward, identity backward (after a
  row-parallel projection);
* :func:`gather`: all-gather forward; backward the slice of this rank
  (``grad="slice"``: the consumer is replicated) or the reduce-scatter
  of every rank's gradient (``grad="sum"``: each rank consumes a different
  part);
* :func:`reduce_stat`: all-reduce forward and backward (a statistic over
  every rank's share, such as the sum of squares of a norm over channels
  split by heads, that each rank's own compute then reads: the gradient of
  the total is the sum of the ranks' partial gradients).

They call ``dist.all_reduce`` / ``all_gather_into_tensor`` /
``reduce_scatter_tensor``, which ``roofline.CommRecorder`` records.  With
one rank on ``model`` (or no mesh) each is the identity and moves nothing.

Sequence parallelism (``cfg.seq_shard``, Megatron's): between blocks the
residual stream holds this rank's ``T / tp`` rows.  A block then enters
with :func:`seq_enter` and leaves with :func:`seq_exit`: a split module
all-gathers T (backward: reduce-scatter) in place of ``copy_in`` and
reduce-scatters T (backward: all-gather) in place of ``reduce_out``; a
module that computes whole on every rank (heads that do not split)
all-gathers T (backward: this rank's slice, every rank's gradient being
the same) and keeps its rows of the output (:func:`split`; backward:
all-gather).  Position-wise work on the local rows (norms, the replicated
block-sparse FFN) reads its replicated parameters through ``copy_in``, so
their gradient is summed over the ranks' rows.  Decode over a KV cache
split on time reduces with the plain :func:`all_reduce` (no autograd)
over the ranks that share the cache's KV heads: all of ``model``, or a
subgroup of it (:func:`tp_subgroup`).

The vocabulary is split too: :func:`vocab_embed` looks up this rank's rows
of the table and all-reduces; :func:`vocab_cross_entropy` takes the max and
the sum of exponentials over the split vocabulary by all-reduce and the
target's logit from the rank that holds it.  The kernels are
``torch.library`` operators with no DTensor strategy, which is why the
tensors here are plain.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .rules import _all_gather, _reduce_scatter


class TensorParallelError(ValueError):
    """A model or tensor that cannot be split over the ``model`` axis as
    asked."""


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the ``model`` axis: ``rank`` of ``size``, and
    the process group (``None`` at one rank)."""
    rank: int = 0
    size: int = 1
    group: Optional[object] = None

    @property
    def on(self) -> bool:
        return self.size > 1

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` split evenly over the ranks."""
        if n % self.size:
            raise TensorParallelError(
                f"{n} does not split over {self.size} model ranks")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step


NO_TP = TP()


def tp_group(mesh) -> TP:
    """``(rank, size, group)`` of this rank on ``mesh``'s ``model`` axis;
    one rank (:data:`NO_TP`) without a mesh, without a ``model`` axis or
    with one rank on it."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return NO_TP
    i = mesh.mesh_dim_names.index("model")
    size = mesh.size(i)
    if size == 1:
        return NO_TP
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return TP(coord[i], size, mesh.get_group(i))


def tp_subgroup(tp: TP, size: int, mesh=None) -> TP:
    """This rank's place among the ``size`` consecutive ranks of ``tp``
    that it shares something with (the ranks of one KV head, say): ranks
    ``[k·size, (k+1)·size)`` on ``model``.  ``tp`` itself at ``size ==
    tp.size`` and :data:`NO_TP` at 1.

    Making a process group is collective over the whole world, so every
    rank makes the group of every such block of every ``model`` row of
    ``mesh``, in the same order, and keeps its own; without ``mesh`` the
    ranks of ``tp`` must be the whole world.  Call it once, where every
    rank builds the same model.  Without a process group (a model split
    on meta tensors) the group is ``None``."""
    if size == tp.size:
        return tp
    if size == 1:
        return NO_TP
    if size < 1 or tp.size % size:
        raise TensorParallelError(
            f"groups of {size} do not split {tp.size} model ranks")
    if tp.group is None:
        return TP(tp.rank % size, size)
    if mesh is not None:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        i = mesh.mesh_dim_names.index("model")
        with unset_fake_temporarily():     # a model built on fake tensors
            rows = mesh.mesh.movedim(i, -1).reshape(-1, tp.size).tolist()
    else:
        rows = [dist.get_process_group_ranks(tp.group)]
        if len(rows[0]) != dist.get_world_size():
            raise TensorParallelError(
                "the model ranks are not the whole world: pass the mesh, "
                "so that every rank makes every subgroup")
    me, mine = dist.get_rank(), None
    for row in rows:
        for lo in range(0, tp.size, size):
            ranks = row[lo:lo + size]
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
    return TP(tp.rank % size, size, mine)


def local(full: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim`` (a view)."""
    lo, hi = tp.span(full.shape[dim])
    return full.narrow(dim, lo, hi - lo)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp, grad):
        ctx.dim, ctx.tp, ctx.grad = dim, tp, grad
        return _all_gather(x, dim, tp.size, tp.group)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.grad == "sum":
            out = _reduce_scatter(g, ctx.dim, tp.size, tp.group)
        else:
            out = local(g, ctx.dim, tp).contiguous()
        return out, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _reduce_scatter(x, dim, tp.size, tp.group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp.size, ctx.tp.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return local(x, dim, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp.size, ctx.tp.group), None, None


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _mean_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g, ctx.groups), None


def _mean_over(t: torch.Tensor, groups) -> torch.Tensor:
    n = 1
    for group, size in groups:
        t = _all_reduce(t, group)
        n *= size
    return t / n


def all_mean(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``groups`` (``(group, size)``
    pairs, e.g. the dp axes), forward and backward: a statistic of every
    rank's tokens (the MoE aux loss's) that each rank's loss holds alike.
    ``x`` itself without groups."""
    return _AllMean.apply(x, tuple(groups)) if groups else x


def copy_in(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Identity forward, all-reduce (sum over ``model``) backward."""
    return _CopyIn.apply(x, tp.group) if tp.on else x


def reduce_out(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """All-reduce (sum over ``model``) forward, identity backward."""
    return _ReduceOut.apply(x, tp.group) if tp.on else x


def reduce_stat(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """All-reduce (sum over ``model``) forward and backward: the total of
    each rank's partial statistic, read by rank-local compute, so each
    rank's gradient of the total is partial and the ranks' are summed."""
    return _ReduceStat.apply(x, tp.group) if tp.on else x


def gather(x: torch.Tensor, dim: int, tp: TP,
           grad: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` (rank order).  Backward:
    this rank's slice of the gradient (``"slice"``), or of its sum over the
    ranks (``"sum"``, a reduce-scatter)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', not {grad!r}")
    if not tp.on:
        return x
    return _Gather.apply(x, dim % x.ndim, tp, grad)


def reduce_scatter(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's slice along ``dim``;
    backward: the all-gather of the ranks' gradients."""
    return _ReduceScatter.apply(x, dim % x.ndim, tp) if tp.on else x


def split(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """This rank's slice of ``x`` (the same on every rank) along ``dim``;
    backward: the all-gather of the ranks' gradients."""
    return _Split.apply(x, dim % x.ndim, tp) if tp.on else x


def seq_enter(x: torch.Tensor, tp: TP, seq: TP) -> torch.Tensor:
    """A block's input: ``copy_in(x, tp)``, or under sequence parallelism
    (``seq`` on: ``x`` holds this rank's rows of T, dim 1) every rank's
    rows gathered, whose backward reduce-scatters the split module's
    partial gradients (``tp`` on) or keeps this rank's rows of the
    gradient a whole computation makes alike on every rank."""
    if not seq.on:
        return copy_in(x, tp)
    return gather(x, 1, seq, grad="sum" if tp.on else "slice")


def seq_exit(y: torch.Tensor, tp: TP, seq: TP) -> torch.Tensor:
    """A block's output: ``reduce_out(y, tp)``, or under sequence
    parallelism this rank's rows of T: the reduce-scatter of the split
    module's partial sums, or the slice of a whole one's output."""
    if not seq.on:
        return reduce_out(y, tp)
    return reduce_scatter(y, 1, seq) if tp.on else split(y, 1, seq)


@torch.no_grad()
def all_reduce(t: torch.Tensor, tp: TP, op: str = "sum") -> torch.Tensor:
    """The sum (``"sum"``) or max (``"max"``) of ``t`` over ``tp``'s
    ranks, as a new tensor (no autograd: decode over a cache split on
    time)."""
    if not tp.on:
        return t
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    return _all_reduce(t, tp.group, ops[op])


@torch.no_grad()
def gather_full(t: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The full tensor from each rank's slice along ``dim`` (no autograd)."""
    return _all_gather(t, dim, tp.size, tp.group) if tp.on else t


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                tp: TP, seq: bool = False) -> torch.Tensor:
    """Rows ``tokens`` of a table whose rows are split over ``model``
    (``table``: this rank's ``(vocab / tp, d)``): each rank looks up the
    tokens in its range, zeros the rest, and the ranks' rows are summed;
    with ``seq`` reduce-scattered along T (dim 1), so each rank keeps its
    rows of the sequence."""
    if not tp.on:
        return table[tokens]
    n = table.shape[0]
    lo = tp.rank * n
    idx = tokens.long() - lo
    mine = (idx >= 0) & (idx < n)
    rows = torch.where(mine[..., None], table[idx.clamp(0, n - 1)], 0.0)
    return reduce_scatter(rows, 1, tp) if seq else reduce_out(rows, tp)


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        mask: Optional[torch.Tensor], tp: TP
                        ) -> torch.Tensor:
    """``layers.cross_entropy`` over logits whose last axis is this rank's
    share of the vocabulary (rank order): mean token NLL in fp32, over
    ``mask``'s sum (at least 1) when it is given.  The same value on every
    rank; each rank's gradient is its own logits'."""
    logits = logits.float()
    n = logits.shape[-1]
    with torch.no_grad():
        m = logits.amax(dim=-1)
        if tp.on:
            m = _all_reduce(m, tp.group, dist.ReduceOp.MAX)
    sum_exp = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    idx = targets.long() - tp.rank * n
    mine = (idx >= 0) & (idx < n)
    picked = logits.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
    true_logit = reduce_out(torch.where(mine, picked, 0.0), tp)
    nll = torch.log(sum_exp) + m - true_logit
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1)
    return nll.mean()
