"""Roofline analysis of the port: FLOPs, bytes and collective bytes of a
traced step against the H100's rates (``repro.roofline``)."""
from .analysis import (H100_SXM, Chip, CommRecorder, CostCounter,
                       collective_bytes, live_pairs, model_flops,
                       roofline_terms)

__all__ = ["Chip", "CommRecorder", "CostCounter", "H100_SXM",
           "collective_bytes", "live_pairs", "model_flops", "roofline_terms"]
