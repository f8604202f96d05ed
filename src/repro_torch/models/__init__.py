"""Models of the port: the dense decoder family with an optional
block-sparse Segment FFN."""
from .model import build_model
from .sparse_ffn import SparseLinear, SparseMLP
from .transformer import Transformer

__all__ = ["build_model", "SparseLinear", "SparseMLP", "Transformer"]
