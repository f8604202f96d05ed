"""Synthetic data of the port."""
from .pipeline import SyntheticDataset

__all__ = ["SyntheticDataset"]
