"""Device intervals of a profiler trace: their union (busy time), and the
idle gaps between them (copied from ``chip_smoke.py``'s
``device_busy_us``)."""
from __future__ import annotations

from typing import Iterable, List, Tuple

Span = Tuple[float, float]


def merged(spans: Iterable[Span]) -> List[Span]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[Span] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def busy(spans: Iterable[Span]) -> float:
    """Length of the union of the intervals."""
    return sum(hi - lo for lo, hi in merged(spans))


def gaps(spans: Iterable[Span], start: float, end: float) -> List[Span]:
    """The idle stretches of ``[start, end]`` that no interval covers."""
    out, at = [], start
    for lo, hi in merged(spans):
        if lo > at:
            out.append((at, min(lo, end)))
        at = max(at, hi)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(lo, hi) for lo, hi in out if hi > lo]
