"""Backend and device resolution for plan execution.

Two backends:

* ``"cuda"``      — the hand-written CUDA kernels for CUDA tensors (their
  plain torch versions for CPU tensors);
* ``"reference"`` — the dense torch oracles of :mod:`repro_torch.kernels.ref`,
  run only when asked for by name.

The default is ``"cuda"``; :func:`use_backend` scopes another one lexically.
Devices resolve in one place too: entry points run on the card unless the
caller passes ``device="cpu"``, and with no card they raise instead of
quietly running on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple, Union

import torch

BACKENDS: Tuple[str, ...] = ("cuda", "reference")

_default_backend: Optional[str] = None


def default_backend() -> str:
    """The backend used when none is passed explicitly."""
    return _default_backend if _default_backend is not None else "cuda"


def resolve_backend(name: Optional[str]) -> str:
    """Validate ``name`` (or resolve the default when ``None``)."""
    if name is None:
        return default_backend()
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; available: {BACKENDS}")
    return name


@contextlib.contextmanager
def use_backend(name: str) -> Iterator[str]:
    """Lexically scope the default backend (e.g. force ``reference`` in a
    parity check)."""
    global _default_backend
    name = resolve_backend(name)
    prev = _default_backend
    _default_backend = name
    try:
        yield name
    finally:
        _default_backend = prev


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card; raises ``RuntimeError`` when there is none,
    so a CPU run is always one the caller asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
