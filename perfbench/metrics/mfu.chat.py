"""The serving loop's useful FLOPs (prefill and decode tokens at their
actual context lengths, not the padded cache or chunk) over the wall time
of its admissions and decode steps and the card's bf16 peak, over the
window's spans that the profiler did not slow."""
from perfbench.counts.flops import forward_flops
from perfbench.counts.peaks import H100


def read(run):
    spans = run.spans("admit") + run.spans("decode step")
    if not spans:
        return None
    flops = sum(forward_flops(run.arch,
                              s.attrs.get("tokens", s.attrs["n"]),
                              s.attrs["ctx_sum"]) for s in spans)
    return 100.0 * flops / sum(s.seconds for s in spans) / H100["bf16_flops"]
