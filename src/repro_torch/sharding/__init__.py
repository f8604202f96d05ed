"""Sharding rules of the port over ``torch.distributed`` meshes."""
from .rules import (P, PartitionSpec, Sharding, act_constrain, batch_pspec,
                    batch_pspecs, cache_pspec, constrain,
                    constrain_like_params, dp_axes, global_norm,
                    make_shardings, param_pspec, params_pspecs,
                    sanitize_pspec)

__all__ = ["P", "PartitionSpec", "Sharding", "act_constrain", "batch_pspec",
           "batch_pspecs", "cache_pspec", "constrain",
           "constrain_like_params", "dp_axes", "global_norm",
           "make_shardings", "param_pspec", "params_pspecs",
           "sanitize_pspec"]
