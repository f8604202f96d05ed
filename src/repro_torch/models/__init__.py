"""Models of the port: the dense and hybrid (RG-LRU + local attention)
decoder families, with an optional block-sparse Segment FFN."""
from .model import build_model
from .recurrent import RGLRUBlock
from .sparse_ffn import SparseLinear, SparseMLP
from .transformer import Transformer

__all__ = ["build_model", "RGLRUBlock", "SparseLinear", "SparseMLP",
           "Transformer"]
