"""The training step's useful FLOPs (the frozen ``model_flops``: three
times the forward, the block-sparse FFN at its stored blocks, the causal
attention term) over its wall time and the card's bf16 peak, over the
window's steps that the profiler did not slow."""
from perfbench.counts.flops import train_step_flops
from perfbench.counts.peaks import H100


def read(run):
    steps = run.spans("train step")
    if not steps:
        return None
    flops = sum(train_step_flops(run.arch, s.attrs["batch"], s.attrs["seq"])
                for s in steps)
    return 100.0 * flops / sum(s.seconds for s in steps) / H100["bf16_flops"]
