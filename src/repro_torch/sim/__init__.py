"""Cycle-approximate evaluation substrate for the paper's figures (a copy
of ``repro.sim``): the SegFold simulator, the baseline accelerators and
Table III's matrix suite, all host numpy."""
from .segfold_sim import SegFoldConfig, SimResult, simulate_segfold
from .baselines import (dataflow_estimates, flexagon_best, flexagon_gust,
                        flexagon_ip, flexagon_op, spada)
from . import matrices

ACCELERATORS = {
    "flexagon_ip": flexagon_ip,
    "flexagon_op": flexagon_op,
    "flexagon_gust": flexagon_gust,
    "spada": spada,
}

__all__ = [
    "SegFoldConfig", "SimResult", "simulate_segfold",
    "ACCELERATORS", "dataflow_estimates", "flexagon_best", "flexagon_gust",
    "flexagon_ip", "flexagon_op", "spada", "matrices",
]
