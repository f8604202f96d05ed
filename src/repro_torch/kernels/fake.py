"""What the kernels' custom operators share: telling fake tensors from
real ones, and the address a fake tensor would have on the card.

Each kernel entry is a ``torch.library`` operator in the ``repro_torch``
namespace, with three implementations:
the launch for CUDA tensors, the plain version for CPU tensors, and a fake
rule (``register_fake``) for fake and meta tensors, which have a device
but no memory.  The fake rule picks the launch's path from the shapes,
dtypes and strides alone, and returns exactly what the launch allocates on
that device: the outputs, then the launch's scratch (the split paths' fp32
partials, the backward passes' row statistics and partials, the copies it
makes of misaligned or strided operands).  The wrapper drops the scratch,
so it lives as long as it does in the launch, and a memory tracker (one
that sees operator outputs, as ``MemTracker`` does) counts it.
"""
from __future__ import annotations

from typing import List

import torch
from torch._subclasses.fake_tensor import is_fake

#: the card's streaming multiprocessors (H100 SXM), for the dispatch
#: functions when a fake tensor of a card that this process cannot query
#: is traced
SMS = 132


def is_abstract(t: torch.Tensor) -> bool:
    """True for a fake or meta tensor (no memory behind it)."""
    return t.is_meta or is_fake(t)


def addr(t: torch.Tensor) -> int:
    """``t.data_ptr()``; for a fake or meta tensor the address it would have
    if its storage began at an allocation: the caching allocator's blocks
    are aligned to at least 256 bytes (cudaMalloc's guarantee), so only the
    storage offset decides a 16-byte alignment test."""
    if is_abstract(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def sms(device: torch.device) -> int:
    """The SM count of ``device`` where this process can query it, else
    :data:`SMS` (a fake CUDA tensor traced on a machine without a card)."""
    if device.type == "cuda" and torch.cuda.is_available():
        from .flash_attention import _sms
        return _sms(device)
    return SMS


def aligned_like(t: torch.Tensor) -> torch.Tensor:
    """The fake counterpart of ``flash_attention._aligned``: ``t`` itself
    when it is contiguous with a 16-byte-aligned start, else a new
    contiguous tensor of its shape (the launch's copy)."""
    if t.is_contiguous() and addr(t) % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def copies(pairs) -> List[torch.Tensor]:
    """The tensors of ``(new, old)`` pairs that a launch allocated: those
    that are not the operand they were made from."""
    return [new for new, old in pairs if new is not old]
