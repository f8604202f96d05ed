"""Wall time of admission (``Engine.admit_pending``, the span ``admit``:
the bucketed prefill of every waiting request, each to its first token)
per request admitted, over the window, leaving out what the profiler
slowed."""


def read(run):
    spans = [s for s in run.spans("admit") if s.attrs["n"]]
    n = sum(s.attrs["n"] for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / n if n else None
