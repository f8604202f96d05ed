"""Device meshes over ``torch.distributed`` (``repro.launch.mesh``).

A mesh is a ``DeviceMesh`` over the process group the caller initialized
(``torch.distributed.init_process_group``): one process a device, NCCL on
``"cuda"`` and gloo on ``"cpu"``.  :func:`mesh_context` sets the current
mesh, which :func:`repro_torch.sharding.act_constrain` reads; outside one
it does nothing, as ``repro``'s does outside ``jax.set_mesh``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_CURRENT: contextvars.ContextVar[Optional[DeviceMesh]] = \
    contextvars.ContextVar("repro_torch_mesh", default=None)


class MeshSizeError(ValueError):
    """The mesh asked for needs another number of processes than the
    process group has."""


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=, "
            "world_size=, rank=) first")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every process of
    the group (``device``: ``"cuda"`` for NCCL, ``"cpu"`` for gloo)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world = _world()
    if math.prod(shape) != world:
        raise MeshSizeError(f"a {shape} mesh needs {math.prod(shape)} "
                            f"processes; the group has {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost :func:`mesh_context`, else ``None``."""
    return _CURRENT.get()


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2,
                         device: str = "cuda") -> DeviceMesh:
    """``repro``'s production layout: 16 × 16 (``data``, ``model``), or
    ``n_pods`` × 16 × 16 (``pod``, ``data``, ``model``); raises
    :class:`MeshSizeError` unless the group has exactly that many
    processes."""
    shape = (n_pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(n_data: int = 4, n_model: int = 2,
                   device: str = "cuda") -> DeviceMesh:
    """A small (``data``, ``model``) mesh."""
    return make_mesh((n_data, n_model), ("data", "model"), device)
