"""Model and shape configuration dataclasses (a copy of
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | enc_dec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free families
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # hybrid: repeating layer pattern
    layer_pattern: Tuple[str, ...] = ()
    local_window: int = 2048
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub
    frontend: str = "none"
    n_frontend_tokens: int = 0
    # the paper's technique: block-sparse FFN weights
    ffn_block_sparse: bool = False
    ffn_block: int = 64
    ffn_density: float = 0.25
    # misc
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024
    seq_shard: bool = False
    kv_cache_dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (Megatron-style TP padding)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def layer_kind(self, i: int) -> str:
        """Block kind for layer i: attn | moe | rec | local | rwkv."""
        if self.family == "ssm":
            return "rwkv"
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        if self.n_experts:
            return "moe"
        return "attn"

    def param_count(self) -> int:
        """Approximate total parameters (as ``repro`` counts them: dense
        FFN weights, no biases or norms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        per_layer = 0
        n_layers = self.n_layers if not self.enc_layers else (
            self.enc_layers + self.dec_layers)
        for i in range(n_layers):
            kind = self.layer_kind(i)
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
                + (self.n_heads * hd) * d
            if kind == "moe":
                per_layer += attn + self.n_experts * 3 * d * ff + d * self.n_experts
            elif kind == "rec":
                per_layer += 4 * d * d + 3 * d * ff  # rglru block + mlp
            elif kind == "rwkv":
                per_layer += 5 * d * d + 2 * d * ff
            elif kind == "local":
                per_layer += attn + 3 * d * ff
            else:
                per_layer += attn + 3 * d * ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        return per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        total = self.param_count()
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_kind(i) == "moe")
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * ff
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int
    accum_steps: int = 1         # gradient-accumulation microbatches (train)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
