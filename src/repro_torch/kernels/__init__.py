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
from .ops import (SpgemmPlan, SpmmPlan, flash_mha, moe_apply,  # noqa: E402
                  plan_spgemm, plan_spmm, rg_lru_scan)

__all__ = ["SpgemmPlan", "SpmmPlan", "build_moe_chunks", "flash_attention",
           "flash_attention_plain", "flash_mha", "moe_apply", "moe_gemm",
           "moe_gemm_plain", "ops", "plan_spgemm", "plan_spmm", "ref",
           "rg_lru", "rg_lru_plain", "rg_lru_scan", "segment_spgemm",
           "segment_spgemm_plain", "segment_spmm", "segment_spmm_plain"]
