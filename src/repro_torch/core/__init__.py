"""Segment dataflow core of the port: the BSR container and quantized
block storage, the policy registry, folding, and the SpMM and SpGEMM
schedule builders (host-side numpy)."""
from .folding import balance_bins, fold_segments, round_robin_bins
from .formats import (BSR, QUANT_DTYPES, QUANT_MAX, QUANT_MODES,
                      ROWWISE_SUFFIX, QuantizedBlocks, dequantize_blocks,
                      quant_base_dtype, quant_error_bound, quant_is_rowwise,
                      quantize_blocks)
from .policies import (SchedulePolicy, available_policies, get_policy,
                       register_policy, unregister_policy)
from .schedule import (LaneLayout, SegmentFinalization, SpgemmSchedule,
                       SpmmSchedule, build_spgemm_schedule,
                       build_spmm_schedule, check_lane_accum, fetch_flags,
                       finalize_schedule, lane_select, lane_traffic_spgemm,
                       lane_traffic_spmm, partition_lanes, shard_schedule,
                       spgemm_schedule_traffic, symbolic_spgemm)

__all__ = [
    "BSR", "QUANT_DTYPES", "QUANT_MAX", "QUANT_MODES", "ROWWISE_SUFFIX",
    "QuantizedBlocks", "dequantize_blocks", "quant_base_dtype",
    "quant_error_bound", "quant_is_rowwise", "quantize_blocks",
    "balance_bins", "fold_segments", "round_robin_bins",
    "SchedulePolicy", "available_policies", "get_policy", "register_policy",
    "unregister_policy",
    "LaneLayout", "SegmentFinalization", "SpgemmSchedule", "SpmmSchedule",
    "build_spgemm_schedule", "build_spmm_schedule", "check_lane_accum",
    "fetch_flags", "finalize_schedule", "lane_select", "lane_traffic_spgemm",
    "lane_traffic_spmm", "partition_lanes", "shard_schedule",
    "spgemm_schedule_traffic", "symbolic_spgemm",
]
