"""Hand-written Hopper kernels of the port, each beside its plain torch
version, and the dense oracles (:mod:`repro_torch.kernels.ref`)."""
from . import ref
from .segment_spmm import segment_spmm, segment_spmm_plain

__all__ = ["ref", "segment_spmm", "segment_spmm_plain"]
