"""95th percentile of every gap between consecutive tokens of one request,
both stamped in the window before the profiler started; a step's
admissions stall every live request, and those stalls count."""
from perfbench.harness import percentile


def read(run):
    t0, t1 = run.window[0], run.untraced_end
    gaps = [y - x for _, times in run.rec.requests
            for x, y in zip(times, times[1:]) if x >= t0 and y <= t1]
    return 1e3 * percentile(gaps, 95) if gaps else None
