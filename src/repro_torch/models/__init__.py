"""Models of the port: every family of ``repro``'s registry (dense, hybrid,
ssm, moe, vlm, enc_dec), with an optional block-sparse Segment FFN."""
from .model import abstract_params, build_model, cache_specs, input_specs
from .moe import MoE
from .recurrent import RGLRUBlock, RWKVBlock
from .sparse_ffn import SparseLinear, SparseMLP
from .transformer import Transformer

__all__ = ["abstract_params", "build_model", "cache_specs", "input_specs",
           "MoE", "RGLRUBlock", "RWKVBlock", "SparseLinear",
           "SparseMLP", "Transformer"]
