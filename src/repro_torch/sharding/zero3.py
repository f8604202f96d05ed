"""Per-unit gather and free of the FSDP shards (ZeRO-3) on a mesh.

``repro`` holds every parameter as its rule shard (``params_pspecs``) and
lets XLA gather each layer's weights where the layer scan uses them.  The
port does the same by hand.  Each parameter that the rules shard over an
axis the model does not compute on (a dp axis, or ``model`` for a tensor
the model holds whole) lives as this rank's shard, the *master*, which
AdamW updates in place; the model's ``nn.Parameter`` keeps its shape but
holds no storage between uses.  The model runs in *units*:

* each element of ``Transformer.layers`` and ``Transformer.enc``;
* ``"embed"``: the embedding, the head and the final norm (called twice in
  a forward pass: the lookup, then the norm and the head);
* ``"frontend"``.

Before a unit runs, its shards are all-gathered into its parameters' own
storage (minor mesh dim first; a mesh dim's parameters of one dtype in
flat buckets of at most :data:`~.rules.BUCKET_BYTES` gathered, a larger
parameter in :func:`~.rules.slices`, so one all-gather a mesh dim where
the unit is small), and after it runs the storage is freed.  In
the backward pass a hook on the unit's output gathers it again before its
backward (the saved weights come back in the same storage; under
``cfg.remat`` the recompute then finds them) after freeing the unit whose
backward ended; the last one is freed by :meth:`Zero3.after_backward`.
The embedding lookup's backward reads only the indices, so that call
gathers nothing in the backward.  Each parameter's gradient is reduced
into its shard (:meth:`Sharding.reduce_scatter`) as soon as autograd has
accumulated it, and handed to :attr:`Zero3.on_grad`; the full gradient is
dropped then.

At most one unit is gathered at a time.  A parameter that nothing shards
beyond what the model holds (a replicated norm scale, a ``model`` slice at
one dp rank) is its own master and is never freed.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

from . import rules
from .rules import Sharding, slices


def unit_of(name: str) -> str:
    """The unit of the parameter ``name``: ``layers.<i>``, ``enc.<i>``,
    ``frontend`` or ``embed`` (the embedding, head and final norm)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc"):
        return ".".join(parts[:2])
    if parts[0] == "frontend":
        return "frontend"
    return "embed"


def _alloc(p: torch.Tensor) -> None:
    st = p.untyped_storage()
    if st.nbytes() == 0:
        st.resize_(p.numel() * p.element_size())


def _free(p: torch.Tensor) -> None:
    p.untyped_storage().resize_(0)


def _all_gather_into(pieces: List[torch.Tensor], n: int, group,
                     outs: List[Callable[[], torch.Tensor]]) -> None:
    """Every rank's ``pieces`` (one dtype) in one all-gather of a flat
    buffer; rank *r*'s copy of piece *i* goes to index *r* along dim 0 of
    ``outs[i]()``, called only once the send buffer is gone (it may
    allocate a parameter's storage)."""
    flat = torch.cat([s.reshape(-1) for s in pieces])
    size = flat.numel()
    buf = torch.empty(n * size, dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(buf, flat, group=group)
    del flat
    buf = buf.view(n, size)
    off = 0
    for s, out in zip(pieces, outs):
        k = s.numel()
        out().copy_(buf[:, off:off + k].view(n, *s.shape))
        off += k


class Zero3:
    """The gather-and-free manager of ``model`` (a ``Transformer``) over
    ``shardings`` (each parameter's :class:`Sharding`; see the module
    docstring).  ``master``: the tensors AdamW updates, this rank's shard
    of every parameter (the parameter itself where nothing is to gather).
    """

    def __init__(self, model, shardings: Mapping[str, Sharding], fsdp):
        self.model, self.fsdp = model, fsdp
        self.shardings = dict(shardings)
        self.mesh = next(iter(self.shardings.values())).mesh
        self.params = dict(model.named_parameters())
        self.master: Dict[str, torch.Tensor] = {}
        #: name → the all-gathers that make it (major mesh dim first)
        self.axes: Dict[str, list] = {}
        for k, p in self.params.items():
            axes = self.shardings[k].gather_axes()
            if axes:
                self.axes[k] = axes
                self.master[k] = self.shardings[k].master_of(
                    p.detach()).clone(memory_format=torch.contiguous_format)
                _free(p)
            else:
                self.master[k] = p.detach()
        self.units: Dict[str, List[str]] = {}
        for k in self.params:
            names = self.units.setdefault(unit_of(k), [])
            if k in self.axes:
                names.append(k)
        self.live: set = set()
        self._name = {id(p): k for k, p in self.params.items()}
        #: ``on_grad(name, shard gradient)`` when set: each parameter's
        #: gradient, reduced into its shard, as autograd accumulates it
        self.on_grad: Optional[Callable[[str, torch.Tensor], None]] = None
        #: ``(unit, "forward" | "backward")`` of every gather, when a list
        self.log: Optional[list] = None
        # the hooks live on the parameters' C++ side, which the garbage
        # collector does not see: a hook that held this manager would keep
        # it, the model and every parameter alive for good
        ref = weakref.ref(self)

        def grad_ready(p):
            z = ref()
            if z is not None:
                z._grad_ready(p)
        for p in self.params.values():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(grad_ready)

    # --- gather and free ----------------------------------------------------

    def _plan(self, names: Iterable[str]) -> list:
        """The all-gathers that gather ``names``, in order: ``(mesh dim,
        [(name, tensor dim, slice), ...])``, minor mesh dim first, then
        dtype; each gathers at most :data:`~.rules.BUCKET_BYTES` where its
        pieces allow (``slice``: one of :func:`slices` of the tensor at
        that stage, or ``None`` for all of it)."""
        names = [k for k in names if k in self.axes]
        shape = {k: list(self.master[k].shape) for k in names}
        dims = {k: {i: d for i, d, *_ in self.axes[k]} for k in names}
        plan = []
        for i in reversed(range(self.mesh.ndim)):
            n = self.mesh.size(i)
            ks = [k for k in names if i in dims[k]]
            for dt in sorted({self.master[k].dtype for k in ks}, key=str):
                bucket, size = [], 0
                for k in ks:
                    if self.master[k].dtype != dt:
                        continue
                    d = dims[k][i]
                    full = list(shape[k])
                    full[d] *= n
                    for sl in slices(full, d, dt.itemsize):
                        b = math.prod(full) * dt.itemsize
                        if sl is not None:
                            b = b // full[sl[0]] * sl[2]
                        if bucket and size + b > rules.BUCKET_BYTES:
                            plan.append((i, bucket))
                            bucket, size = [], 0
                        bucket.append((k, d, sl))
                        size += b
                if bucket:
                    plan.append((i, bucket))
            for k in ks:
                shape[k][dims[k][i]] *= n
        return plan

    @torch.no_grad()
    def _gather_names(self, names: Iterable[str]) -> None:
        """All-gather ``names``' shards into their parameters by
        :meth:`_plan`; a tensor gathered over several mesh dims passes
        through a new tensor until its last (the major) one."""
        names = [k for k in names if k in self.axes]
        cur = {k: self.master[k] for k in names}
        last = {k: min(i for i, *_ in self.axes[k]) for k in names}
        done: Dict[str, torch.Tensor] = {}
        stage = None
        for i, bucket in self._plan(names):
            if i != stage:
                cur.update(done)
                done, stage = {}, i
            n = self.mesh.size(i)

            def target(k, d, sl, n=n, i=i):
                def get():
                    if k not in done:
                        if i == last[k]:
                            _alloc(self.params[k])
                            done[k] = self.params[k].data
                        else:
                            shape = list(cur[k].shape)
                            shape[d] *= n
                            done[k] = cur[k].new_empty(shape)
                    t = done[k] if sl is None else done[k].narrow(*sl)
                    return t.unflatten(d, (n, t.shape[d] // n)).movedim(d, 0)
                return get
            _all_gather_into(
                [cur[k] if sl is None else cur[k].narrow(*sl)
                 for k, _, sl in bucket], n, self.mesh.get_group(i),
                [target(k, d, sl) for k, d, sl in bucket])

    def gather(self, unit: str, phase: str = "forward") -> None:
        """Gather ``unit``'s parameters (nothing when it is gathered)."""
        if unit in self.live:
            return
        self.live.add(unit)
        if self.log is not None:
            self.log.append((unit, phase))
        self._gather_names(self.units.get(unit, ()))

    def free(self, unit: str) -> None:
        """Free ``unit``'s gathered storage."""
        for k in self.units.get(unit, ()):
            _free(self.params[k])
        self.live.discard(unit)

    def free_all(self) -> None:
        for unit in list(self.live):
            self.free(unit)

    def gather_counts(self, unit: str) -> int:
        """The all-gathers one gather of ``unit`` makes: one a (mesh dim,
        dtype) its parameters gather over where they fit in one bucket
        (:meth:`_plan`)."""
        return len(self._plan(self.units.get(unit, ())))

    def reduce_scatters(self) -> int:
        """The reduce-scatters one backward pass makes: each gradient's
        :meth:`Sharding.reduce_scatters`."""
        return sum(self.shardings[k].reduce_scatters(
            p.shape, p.element_size()) for k, p in self.params.items()
            if p.requires_grad)

    # --- running a unit -----------------------------------------------------

    def call(self, unit: str, fn: Callable, *args, backward: bool = True,
             **kw):
        """``fn(*args, **kw)`` with ``unit`` gathered, freed after it;
        when the call records gradients and ``backward``, a hook on its
        (first) output gathers the unit again before its backward."""
        self.gather(unit)
        try:
            out = fn(*args, **kw)
        finally:
            self.free(unit)
        x = out[0] if isinstance(out, tuple) else out
        if backward and isinstance(x, torch.Tensor) and x.requires_grad:
            x.register_hook(self._pre_backward(unit))
        return out

    def _pre_backward(self, unit: str):
        def hook(grad):
            # the units whose backward ended (every consumer of this
            # output has run its backward) go before this one comes in
            self.free_all()
            self.gather(unit, "backward")
        return hook

    def _grad_ready(self, p: torch.Tensor) -> None:
        if self.on_grad is None:
            return
        k = self._name[id(p)]
        g, p.grad = p.grad, None
        self.on_grad(k, self.shardings[k].reduce_scatter(g))

    def after_backward(self) -> None:
        """Free the last unit of a backward pass."""
        self.free_all()

    # --- whole-model access -------------------------------------------------

    @contextlib.contextmanager
    def materialize(self, names: Iterable[str]):
        """A context: ``names`` gathered (whatever their unit), their
        shards copied back from the parameters when it ends, then freed
        (``Transformer.init`` writes through it)."""
        names = [k for k in names if k in self.axes]
        self._gather_names(names)
        try:
            yield
            with torch.no_grad():
                for k in names:
                    self.master[k].copy_(self.shardings[k].master_of(
                        self.params[k].detach()))
        finally:
            for k in names:
                if unit_of(k) not in self.live:
                    _free(self.params[k])

    @torch.no_grad()
    def full(self, name: str) -> torch.Tensor:
        """The full tensor of ``name`` from every rank's shard (a
        collective over the mesh dims that shard it)."""
        return self.shardings[name].gather_full(self.master[name])

    @torch.no_grad()
    def load_(self, name: str, t: torch.Tensor) -> None:
        """Write ``t`` (the full tensor, or the model's ``model`` slice of
        a split parameter) into this rank's shard."""
        sh = self.shardings[name]
        shard = sh.master_of(t) if tuple(t.shape) == tuple(
            self.params[name].shape) else sh.shard(t)
        self.master[name].copy_(shard)

    def param_bytes(self) -> int:
        """The bytes of this rank's parameter storage: every master and
        every parameter's own storage (shared storage counted once)."""
        seen, total = set(), 0
        for t in [*self.master.values(), *self.params.values()]:
            st = t.untyped_storage()
            if st.data_ptr() in seen or st.nbytes() == 0:
                continue
            seen.add(st.data_ptr())
            total += st.nbytes()
        return total

    def unit_bytes(self, unit: str) -> int:
        """The gathered bytes of ``unit``'s sharded parameters."""
        return sum(self.params[k].numel() * self.params[k].element_size()
                   for k in self.units.get(unit, ()))

