"""90th percentile, over every request sent in the window before the
profiler started, of the time from its sending to its first token (the
end of its admission); a request that never got one counts as infinite."""
from perfbench.harness import percentile


def read(run):
    t0, t1 = run.window[0], run.untraced_end
    waits = [times[0] - sent if times else float("inf")
             for sent, times in run.rec.requests if t0 <= sent < t1]
    return 1e3 * percentile(waits, 90) if waits else None
