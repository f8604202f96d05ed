"""Segment dataflow core of the port: the BSR container, the policy
registry, folding and the SpMM schedule builders (host-side numpy)."""
from .folding import balance_bins, fold_segments, round_robin_bins
from .formats import BSR
from .policies import (SchedulePolicy, available_policies, get_policy,
                       register_policy, unregister_policy)
from .schedule import (LaneLayout, SegmentFinalization, SpmmSchedule,
                       build_spmm_schedule, check_lane_accum, fetch_flags,
                       finalize_schedule, lane_select, lane_traffic_spmm,
                       partition_lanes, shard_schedule)

__all__ = [
    "BSR", "balance_bins", "fold_segments", "round_robin_bins",
    "SchedulePolicy", "available_policies", "get_policy", "register_policy",
    "unregister_policy",
    "LaneLayout", "SegmentFinalization", "SpmmSchedule",
    "build_spmm_schedule", "check_lane_accum", "fetch_flags",
    "finalize_schedule", "lane_select", "lane_traffic_spmm",
    "partition_lanes", "shard_schedule",
]
