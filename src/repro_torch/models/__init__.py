"""Models of the port: every family of ``repro``'s registry (dense, hybrid,
ssm, moe, vlm, enc_dec), with an optional block-sparse Segment FFN."""
from .model import build_model
from .moe import MoE
from .recurrent import RGLRUBlock, RWKVBlock
from .sparse_ffn import SparseLinear, SparseMLP
from .transformer import Transformer

__all__ = ["build_model", "MoE", "RGLRUBlock", "RWKVBlock", "SparseLinear",
           "SparseMLP", "Transformer"]
