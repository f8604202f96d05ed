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
  part).

They call ``dist.all_reduce`` / ``all_gather_into_tensor`` /
``reduce_scatter_tensor``, which ``roofline.CommRecorder`` records.  With
one rank on ``model`` (or no mesh) each is the identity and moves nothing.

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


@torch.no_grad()
def gather_full(t: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The full tensor from each rank's slice along ``dim`` (no autograd)."""
    return _all_gather(t, dim, tp.size, tp.group) if tp.on else t


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                tp: TP) -> torch.Tensor:
    """Rows ``tokens`` of a table whose rows are split over ``model``
    (``table``: this rank's ``(vocab / tp, d)``): each rank looks up the
    tokens in its range, zeros the rest, and the ranks' rows are summed."""
    if not tp.on:
        return table[tokens]
    n = table.shape[0]
    lo = tp.rank * n
    idx = tokens.long() - lo
    mine = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)]
    return reduce_out(torch.where(mine[..., None], rows, 0.0), tp)


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
