"""Frozen counts: FLOPs, SpMM work, device intervals, peaks."""
