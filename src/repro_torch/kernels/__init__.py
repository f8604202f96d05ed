"""Hand-written Hopper kernels of the port, each beside its plain torch
version, the dense oracles (:mod:`repro_torch.kernels.ref`) and the public
wrappers around them (:mod:`repro_torch.kernels.ops`)."""
from . import ref
from .flash_attention import flash_attention, flash_attention_plain
from .moe_gemm import build_moe_chunks, moe_gemm, moe_gemm_plain
from .rg_lru import rg_lru, rg_lru_plain
from .segment_spgemm import segment_spgemm, segment_spgemm_plain
from .segment_spmm import segment_spmm, segment_spmm_plain
from . import ops  # noqa: E402  (ops imports the api, which imports kernels)

__all__ = ["build_moe_chunks", "flash_attention", "flash_attention_plain",
           "moe_gemm", "moe_gemm_plain", "ops", "ref", "rg_lru",
           "rg_lru_plain", "segment_spgemm", "segment_spgemm_plain",
           "segment_spmm", "segment_spmm_plain"]
