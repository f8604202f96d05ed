"""Mean wall time of one batched decode step (``Engine.step``, the span
``decode step``) over the window, leaving out the steps the profiler
slowed."""
from statistics import fmean


def read(run):
    steps = run.spans("decode step")
    return 1e3 * fmean(s.seconds for s in steps) if steps else None
