"""The block-sparse FFN's SpMM against its roofline in the profiled steps:
the sum of each needed call's least time over the device time of the
kernels named in :data:`KERNELS`.

A training step needs, in each layer, one forward call and one
``transpose_lhs`` (dx) call of each projection over N = batch × seq
columns; the rematerialised forward is not needed work.  A call's least
time is ``max(ops / bf16 peak, bytes / HBM peak)`` from the frozen counts
(:mod:`perfbench.counts.spmm`): fp32 stored blocks, bf16 B and C."""
from perfbench.counts import spmm

KERNELS = ("segment_spmm",)


def read(run):
    steps = run.spans("train step", traced=True)
    device = run.kernel_seconds(KERNELS)
    if not steps or device is None:
        return None
    least = sum(spmm.ffn_least_seconds(run.arch, s.attrs["batch"]
                                       * s.attrs["seq"], dx=True)
                for s in steps)
    return 100.0 * least / device
