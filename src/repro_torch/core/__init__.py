"""Segment dataflow core of the port (host-side numpy, copies of
``repro.core``):

* formats:   :class:`CSR`, :class:`DCSR`, :class:`CSC`, :class:`BSR` and
             quantized block storage
* dataflow:  :func:`run_selecta`, :func:`segment_spgemm_elementwise`,
             static references in :mod:`repro_torch.core.dataflows`
* folding:   :func:`spatial_fold`, :func:`fold_segments`, :func:`balance_bins`
* schedules: :func:`build_spmm_schedule`, :func:`build_spgemm_schedule`,
             :func:`partition_lanes` (lane-parallel realization)
* policies:  :func:`register_policy`, :func:`get_policy`,
             :func:`available_policies` (the dataflow configuration space)
"""
from .folding import (balance_bins, fold_segments, round_robin_bins,
                      spatial_fold, temporal_fold_spills)
from .formats import (BSR, CSC, CSR, DCSR, QUANT_DTYPES, QUANT_MAX,
                      QUANT_MODES, ROWWISE_SUFFIX, QuantizedBlocks,
                      csr_from_coo, dequantize_blocks, quant_base_dtype,
                      quant_error_bound, quant_is_rowwise, quantize_blocks,
                      random_csr, spgemm_reference)
from .policies import (SchedulePolicy, available_policies, get_policy,
                       register_policy, unregister_policy)
from .schedule import (LaneLayout, SegmentFinalization, SpgemmSchedule,
                       SpmmSchedule, build_spgemm_schedule,
                       build_spmm_schedule, fetch_flags, finalize_schedule,
                       lane_select, lane_traffic_spgemm, lane_traffic_spmm,
                       partition_lanes, shard_schedule,
                       spgemm_schedule_traffic, spmm_schedule_traffic,
                       symbolic_spgemm)
from .segmentbc import VSpace, segment_spgemm_elementwise
from .selecta import SelectaState, run_selecta, selecta_stats

__all__ = [
    "BSR", "CSC", "CSR", "DCSR", "csr_from_coo", "random_csr",
    "spgemm_reference",
    "QUANT_DTYPES", "QUANT_MAX", "QUANT_MODES", "ROWWISE_SUFFIX",
    "QuantizedBlocks", "dequantize_blocks", "quant_base_dtype",
    "quant_error_bound", "quant_is_rowwise", "quantize_blocks",
    "SelectaState", "run_selecta", "selecta_stats",
    "VSpace", "segment_spgemm_elementwise",
    "balance_bins", "fold_segments", "round_robin_bins", "spatial_fold",
    "temporal_fold_spills",
    "SchedulePolicy", "available_policies", "get_policy", "register_policy",
    "unregister_policy",
    "LaneLayout", "SegmentFinalization", "SpgemmSchedule", "SpmmSchedule",
    "build_spgemm_schedule", "build_spmm_schedule", "fetch_flags",
    "finalize_schedule", "lane_select", "lane_traffic_spgemm",
    "lane_traffic_spmm", "partition_lanes", "shard_schedule",
    "spgemm_schedule_traffic", "spmm_schedule_traffic", "symbolic_spgemm",
]
