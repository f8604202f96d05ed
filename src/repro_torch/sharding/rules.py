"""Logical sharding rules over a ``DeviceMesh`` (``repro.sharding.rules``).

The strategy is ``repro``'s:

* **TP** on ``model``: attention heads, FFN hidden, vocab, experts;
* **FSDP** on ``data``: the other dimension of every large matrix, so the
  parameters and optimizer state scale down with the number of ranks;
* **DP** on ``pod``: replication, gradients averaged across pods.

The rules read the port's state names (``layers.0.attn.wq.w``,
``params/embed.table``, ``opt/m/...``): the last component is the name and
the one before it the parent, as ``repro`` reads the keys of its pytree.
The port's per-layer tensors have no stacked layer axis, so each spec is
``repro``'s without the leading ``None`` of that axis.

A :class:`Sharding` is ``repro``'s ``NamedSharding``: the sanitized spec
and the DTensor placements it gives, with the collectives the trainer
needs (the local shard, the all-gathers that make the model's parameter,
which :mod:`.zero3` runs a unit at a time, the reduce-scatter of
gradients into the shard).  Within one tensor dim sharded over several
mesh axes the earlier mesh axis is the major one, as in DTensor.  A
collective of the sharded runtime moves at most :data:`BUCKET_BYTES`: a
larger tensor goes in slices along a dim it is not split on
(:func:`slices`).

The specs are the storage layout.  Where the model computes tensor
parallel (:mod:`.tensor_parallel`), a parameter the rules shard on
``model`` is held by the model as this rank's ``model`` slice
(``Sharding.local_dim``): it is gathered over the dp axes only, and its
gradient, already local, is reduced over the dp axes only.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.launch.mesh import current_mesh


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis name, or a tuple of
    them (``jax.sharding.PartitionSpec``, which also stores a one-axis
    tuple as the axis and an empty one as ``None``)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec

# parameter-name classes
_COL_PARALLEL = {"up", "gate", "wq", "wk", "wv", "wg", "wr", "in_x", "in_g",
                 "a_gate", "x_gate", "cm_k", "w_lora_a", "router"}
_ROW_PARALLEL = {"down", "wo", "out", "cm_v", "w_lora_b"}
_REPLICATED = {"scale", "b", "a_param", "mix", "cm_mix", "u", "conv",
               "w_bias"}

Shape = Tuple[int, ...]


def _shape(leaf) -> Shape:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_pspec(name: str, leaf, *, dp="data", tp: str = "model") -> P:
    """The spec of the tensor named ``name`` (``leaf``: it, or its
    shape)."""
    names = re.split(r"[./]", name)
    key = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    ndim = len(_shape(leaf))
    if key == "blocks":
        # Segment-kernel BSR blocks: the schedule indexes the full block
        # list, so they are replicated
        return P()
    if key == "table":                       # (vocab, d) embedding
        return P(tp, dp)
    if key in _REPLICATED:
        return P()
    if key == "w" and parent in _COL_PARALLEL:
        return _last2(ndim, dp, tp)
    if key == "w" and parent in _ROW_PARALLEL:
        return _last2(ndim, tp, dp)
    if key in ("gate", "up") and ndim >= 3:  # (E, d, ff) expert weights
        return _expert(ndim, tp, dp)
    if key == "down" and ndim >= 3:          # (E, ff, d)
        return _expert(ndim, tp, dp, swap=True)
    if ndim >= 2:
        return _last2(ndim, dp, tp)
    return P()


def _last2(ndim: int, a, b) -> P:
    """The last two dims as (a, b); leading dims unsharded."""
    return P(*([None] * (ndim - 2)), a, b)


def _expert(ndim: int, tp, dp, swap: bool = False) -> P:
    pad = [None] * (ndim - 3)
    return P(*pad, tp, None, dp) if swap else P(*pad, tp, dp, None)


def params_pspecs(params: Mapping[str, object], fsdp="data"
                  ) -> Dict[str, P]:
    """Specs of a state dict, FSDP on ``fsdp``: an axis name, or a tuple
    such as ``("data", "pod")`` for cross-pod ZeRO (state-dominated
    giants); :func:`sanitize_pspec` drops the axes a mesh lacks.  Within
    one tensor dim the shards follow DTensor's order (the earlier mesh
    axis is the major one), whatever the tuple's order: the per-rank bytes
    are the same."""
    return {k: param_pspec(k, v, dp=fsdp) for k, v in params.items()}


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch-sharding axes: ``("pod", "data")`` multi-pod, ``("data",)``."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_pspec(mesh, ndim: int) -> P:
    return P(dp_axes(mesh), *([None] * (ndim - 1)))


def batch_pspecs(mesh, batch: Mapping[str, object]) -> Dict[str, P]:
    return {k: batch_pspec(mesh, len(_shape(v))) for k, v in batch.items()}


def cache_pspec(mesh, leaf) -> P:
    """Decode-state spec of one entry of the port's flat cache: batch (axis
    1) on the dp axes, axis 2 on ``model`` where it divides.  The KV
    entries ``k``/``v`` and the rings ``k_local``/``v_local`` are
    (layers, B, T, n_kv, hd): the timeline shards over ``model``; an int8
    KV cache's (layers, B, T, n_kv) scales shard T too from T = 1024."""
    dp = dp_axes(mesh)
    shape = _shape(leaf)
    ndim = len(shape)
    n_model = _axis_sizes(mesh)["model"]
    if ndim >= 5:
        tp = "model" if shape[2] % n_model == 0 else None
        return P(None, dp, tp, *([None] * (ndim - 3)))
    if ndim == 4 and shape[2] >= 1024 and shape[2] % n_model == 0:
        return P(None, dp, "model", None)
    if ndim >= 2:
        return P(None, dp, *([None] * (ndim - 2)))
    return P()


def sanitize_pspec(mesh, spec: P, shape) -> P:
    """Drop each axis the mesh lacks or whose size does not divide the dim
    (the dim then falls back to replication over it)."""
    sizes = _axis_sizes(mesh)
    dims = _shape(shape)
    new = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(dims):
            new.append(None)
            continue
        keep, size = [], 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a in sizes and dims[i] % (size * sizes[a]) == 0:
                keep.append(a)
                size *= sizes[a]
        new.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*new)


#: the most bytes one all-gather fills or one reduce-scatter reads: a
#: larger tensor goes in slices (:func:`slices`), so that a collective's
#: send, receive and staging buffers stay small beside the tensors it
#: fills
BUCKET_BYTES = 256 << 20


def slices(shape, dim: int, itemsize: int):
    """A tensor of ``shape`` split for the collectives along ``dim``:
    ``[(j, start, length), ...]`` along its first dim ``j`` other than
    ``dim`` that has more than one index, each slice of at most
    :data:`BUCKET_BYTES` (or one index of ``j``); ``[None]``, the whole
    tensor, when it is at most that or no such ``j`` exists."""
    bound = BUCKET_BYTES
    size = math.prod(shape) * itemsize
    j = next((i for i, s in enumerate(shape) if i != dim and s > 1), None)
    if size <= bound or j is None:
        return [None]
    step = max(1, bound // (size // shape[j]))
    return [(j, a, min(step, shape[j] - a))
            for a in range(0, shape[j], step)]


def _placements(mesh: DeviceMesh, spec: P) -> Tuple[Placement, ...]:
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if e is not None
                and axis in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: ``spec`` and its DTensor
    ``placements`` (one a mesh dim); ``local_dim``: the dim along which
    the model's parameter is this rank's ``model`` slice (tensor
    parallel), else ``None`` (the model holds the full tensor)."""
    mesh: DeviceMesh
    spec: P
    placements: Tuple[Placement, ...]
    local_dim: Optional[int] = None

    def _sharded(self, model: bool = True):
        """``(mesh dim, tensor dim, size, this rank's coordinate)`` of each
        mesh dim of more than one rank that shards the tensor, in mesh
        order (the major one first); without the ``model`` axis unless
        ``model``."""
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        return [(i, pl.dim, self.mesh.size(i), coord[i])
                for i, pl in enumerate(self.placements)
                if isinstance(pl, Shard) and self.mesh.size(i) > 1
                and (model or self.mesh.mesh_dim_names[i] != "model")]

    def _narrow(self, t: torch.Tensor, model: bool) -> torch.Tensor:
        for _, d, n, c in self._sharded(model):
            step = t.shape[d] // n
            t = t.narrow(d, c * step, step)
        return t

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``: a view, and ``full`` itself when
        nothing is sharded."""
        return self._narrow(full, model=True)

    def master_of(self, param: torch.Tensor) -> torch.Tensor:
        """This rank's shard as a view of the model's parameter: of the
        full tensor, or of this rank's ``model`` slice (``local_dim``)."""
        return self._narrow(param, model=self.local_dim is None)

    def gather_full(self, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (all-gathers over every
        mesh dim that shards it, ``model`` included, minor first);
        ``shard`` itself when nothing is sharded."""
        t = shard
        for i, d, n, _ in reversed(self._sharded(True)):
            t = _all_gather(t, d, n, self.mesh.get_group(i))
        return t

    def gather_axes(self) -> list:
        """``(mesh dim, tensor dim, size, coordinate)`` of each all-gather
        that makes the model's parameter from this rank's shard, the major
        mesh dim first: over every mesh dim that shards it, or with
        ``local_dim`` over the dp axes only (the model holds this rank's
        ``model`` slice)."""
        return self._sharded(self.local_dim is None)

    def reduce_scatter(self, grad: torch.Tensor) -> torch.Tensor:
        """The mean over the dp axes of each rank's gradient of the model's
        parameter, in this rank's layout: reduce-scattered over a dp axis
        that shards the tensor, all-reduced over one that does not; a full
        gradient is sliced along a model axis (its ranks computed the same
        gradient), a ``local_dim`` one is already this rank's.  ``grad``
        itself at one rank.  A reduce-scatter of more than
        :data:`BUCKET_BYTES` goes in :func:`slices` (one collective each).

        The dp axes reduce minor first (``data`` before ``pod``): where
        several shard one dim, each reduce-scatter takes this rank's
        chunks of every major coordinate still to reduce, so no
        intermediate is larger than ``grad`` over the first axis's size."""
        dp = dp_axes(self.mesh)
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        t, n_dp = grad, 1
        for i in reversed(range(self.mesh.ndim)):
            pl, n = self.placements[i], self.mesh.size(i)
            if n == 1:
                continue
            # the major mesh axes that also shard this dim, still to come
            major = (math.prod(
                self.mesh.size(j) for j in range(i)
                if isinstance(self.placements[j], Shard)
                and self.placements[j].dim == pl.dim
                and (names[j] in dp or self.local_dim is None))
                if isinstance(pl, Shard) else 1)
            if names[i] not in dp:
                if isinstance(pl, Shard) and self.local_dim is None:
                    t = _chunk_within(t, pl.dim, n, major, coord[i])
                continue
            n_dp *= n
            group = self.mesh.get_group(i)
            if isinstance(pl, Shard):
                t = _sliced_reduce_scatter(t, pl.dim, n, major, group)
            else:                    # a copy: the caller's grad stays
                t = t.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(t, group=group)
        return t if n_dp == 1 else t / n_dp

    def reduce_scatters(self, shape, itemsize: int) -> int:
        """The reduce-scatters :meth:`reduce_scatter` makes for a gradient
        of ``shape`` and ``itemsize`` (at one rank, none)."""
        dp = dp_axes(self.mesh)
        shape, count = list(shape), 0
        for i in reversed(range(self.mesh.ndim)):
            pl, n = self.placements[i], self.mesh.size(i)
            if n == 1 or not isinstance(pl, Shard):
                continue
            if self.mesh.mesh_dim_names[i] in dp:
                count += len(slices(shape, pl.dim, itemsize))
                shape[pl.dim] //= n
            elif self.local_dim is None:
                shape[pl.dim] //= n
        return count

    def counts_in_norm(self) -> bool:
        """True on the one rank of each replica group whose copy a global
        norm counts: coordinate 0 along every mesh dim that replicates the
        tensor."""
        coord = self.mesh.get_coordinate()
        return all(c == 0 for c, pl in zip(coord, self.placements)
                   if not isinstance(pl, Shard))


def _all_gather(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, n: int,
                    group) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _chunk_within(t: torch.Tensor, dim: int, n: int, major: int,
                  c: int) -> torch.Tensor:
    """Chunk ``c`` of every one of ``major`` blocks of ``n`` chunks along
    ``dim`` (a view when ``major`` is 1)."""
    if major == 1:
        step = t.shape[dim] // n
        return t.narrow(dim, c * step, step)
    shape = tuple(t.shape)
    rest = shape[dim] // (major * n)
    return t.reshape(*shape[:dim], major, n, rest, *shape[dim + 1:]) \
        .select(dim + 1, c).reshape(*shape[:dim], major * rest,
                                    *shape[dim + 1:])


def _reduce_scatter_within(t: torch.Tensor, dim: int, n: int, major: int,
                           group) -> torch.Tensor:
    """Reduce-scatter over ``n`` ranks along ``dim``, which holds ``major``
    blocks (the coordinates of the major mesh axes still to reduce) of
    ``n`` chunks each: this rank keeps its chunk of every block."""
    if major == 1:
        return _reduce_scatter(t, dim, n, group)
    shape = tuple(t.shape)
    rest = shape[dim] // (major * n)
    src = t.reshape(*shape[:dim], major, n, rest, *shape[dim + 1:]) \
        .movedim(dim + 1, 0).contiguous()
    out = torch.empty(src.shape[1:], dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src.view(-1, *src.shape[2:]),
                               group=group)
    return out.reshape(*shape[:dim], major * rest, *shape[dim + 1:])


def _sliced_reduce_scatter(t: torch.Tensor, dim: int, n: int, major: int,
                           group) -> torch.Tensor:
    """:func:`_reduce_scatter_within` of each of ``t``'s :func:`slices`,
    written into one result."""
    parts = slices(t.shape, dim, t.element_size())
    if parts == [None]:
        return _reduce_scatter_within(t, dim, n, major, group)
    shape = list(t.shape)
    shape[dim] //= n
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for j, a, k in parts:
        out.narrow(j, a, k).copy_(_reduce_scatter_within(
            t.narrow(j, a, k), dim, n, major, group))
    return out


def make_shardings(mesh: DeviceMesh, pspecs: Mapping[str, P],
                   leaves: Optional[Mapping[str, object]] = None,
                   local_dims: Optional[Mapping[str, int]] = None
                   ) -> Dict[str, Sharding]:
    """A :class:`Sharding` a name; with ``leaves`` (tensors or full
    shapes) each spec is sanitized against its shape first.
    ``local_dims``: ``{name: dim}`` of the parameters the model holds as
    this rank's ``model`` slice along ``dim``; the spec must shard that
    dim on ``model`` (a ``ValueError`` otherwise)."""
    out = {}
    for k, spec in pspecs.items():
        if leaves is not None:
            spec = sanitize_pspec(mesh, spec, leaves[k])
        dim = (local_dims or {}).get(k)
        if dim is not None:
            e = spec[dim] if dim < len(spec) else None
            if "model" not in (e if isinstance(e, tuple) else (e,)):
                raise ValueError(
                    f"{k}: the model holds its model slice along dim {dim}, "
                    f"which the rules' spec {spec} does not shard on model")
        out[k] = Sharding(mesh, spec, _placements(mesh, spec), dim)
    return out


def constrain(x, mesh: DeviceMesh, spec: P):
    """A DTensor redistributed to ``spec``; a plain tensor as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, _placements(mesh, spec))
    return x


def constrain_like_params(grads: Mapping[str, torch.Tensor],
                          shardings: Mapping[str, Sharding]
                          ) -> Dict[str, torch.Tensor]:
    """Each rank's full gradients → their mean over the dp axes in the
    parameter layout (:meth:`Sharding.reduce_scatter`)."""
    return {k: shardings[k].reduce_scatter(g) for k, g in grads.items()}


def global_norm(grads: Mapping[str, torch.Tensor],
                shardings: Mapping[str, Sharding]) -> torch.Tensor:
    """The global L2 norm of sharded gradients, each element counted once:
    a replicated shard only on the rank that :meth:`Sharding.counts_in_norm`.
    """
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
          for k, g in grads.items() if shardings[k].counts_in_norm()]
    total = (torch.stack(sq).sum() if sq else
             torch.zeros((), device=next(iter(grads.values())).device))
    mesh = next(iter(shardings.values())).mesh
    for i in range(mesh.ndim):       # the sum over every rank of the mesh
        if mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return total.sqrt()


def act_constrain(x, kind: str):
    """Redistribute an activation DTensor inside :func:`mesh_context` (a
    plain tensor, or no mesh with a ``model`` axis: ``x`` as it is).

    kinds: ``hidden`` (B, T, D) batch-sharded; ``logits`` (B, T, V) batch
    and vocab (model); ``seq``, ``ffn``, ``heads``, ``scores_t`` and
    ``expert`` as in ``repro``."""
    m = current_mesh()
    if m is None or "model" not in m.mesh_dim_names \
            or not isinstance(x, DTensor):
        return x
    dp = dp_axes(m)
    if not dp:
        return x
    sizes = _axis_sizes(m)
    if x.shape[0] % math.prod(sizes[a] for a in dp) != 0:
        return x
    n = x.ndim

    def tp_ok(dim):
        return dim % sizes["model"] == 0

    if kind == "logits":
        spec = P(dp, *([None] * (n - 2)), "model")
    elif kind == "seq" and n >= 2 and tp_ok(x.shape[1]):
        spec = P(dp, "model", *([None] * (n - 2)))
    elif kind == "ffn" and tp_ok(x.shape[-1]):
        spec = P(dp, *([None] * (n - 2)), "model")
    elif kind == "heads" and n == 4 and tp_ok(x.shape[2]):
        spec = P(dp, None, "model", None)
    elif kind == "scores_t" and n == 4 and tp_ok(x.shape[-1]):
        spec = P(dp, None, None, "model")
    elif kind == "expert" and n == 4 and tp_ok(x.shape[1]):
        spec = P(dp, "model", None, None)
    elif kind == "expert" and n == 3 and tp_ok(x.shape[0]):
        spec = P("model", None, None)
    else:
        spec = P(dp, *([None] * (n - 1)))
    return constrain(x, m, spec)

