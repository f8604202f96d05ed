"""What the benchmark makes from ``--seed`` and hands to both sides: the
model's configuration as run, its weights, the block-sparse FFN's pattern,
and the tokens of the traffic.

Nothing here imports the program.  Weights are drawn on the device in a few
large calls: the leaves, in a fixed order, are slices of one long normal
vector cut into chunks of :data:`CHUNK` values, chunk ``c`` drawn by a
generator seeded from ``(seed, c)``.  So a leaf's initial value can be drawn
again later (:func:`initial_leaves`) without keeping a copy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: normal values a chunk (512 MiB of fp32)
CHUNK = 1 << 27

#: the published keys of a configuration file, by the field of the port's
#: ``ModelConfig`` they fill
HF_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv",
    "intermediate_size": "d_ff", "vocab_size": "vocab",
    "head_dim": "head_dim", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
    "num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
}


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes the benchmark itself needs of a configuration (the
    program's config object is built from the same file by the driver)."""
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    padded_vocab: int
    tie_embeddings: bool
    rope_theta: float
    norm_eps: float
    n_experts: int
    top_k: int
    capacity_factor: float
    ffn_block_sparse: bool
    ffn_block: int
    ffn_density: float


def model_fields(cfg: dict) -> dict:
    """The port's ``ModelConfig`` fields of a configuration file: its
    published keys mapped by :data:`HF_KEYS`, then its ``port`` group."""
    out = {field: cfg[key] for key, field in HF_KEYS.items() if key in cfg}
    out.update(cfg.get("port", {}))
    out.setdefault("name", cfg["name"])
    return out


def arch(cfg: dict) -> Arch:
    f = model_fields(cfg)
    d, h = f["d_model"], f["n_heads"]
    vocab = f["vocab"]
    return Arch(
        family=f["family"], n_layers=f["n_layers"], d_model=d, n_heads=h,
        n_kv=f["n_kv"], head_dim=f.get("head_dim") or d // h,
        d_ff=f["d_ff"], vocab=vocab, padded_vocab=(vocab + 255) // 256 * 256,
        tie_embeddings=f.get("tie_embeddings", True),
        rope_theta=f.get("rope_theta", 10000.0),
        norm_eps=f.get("norm_eps", 1e-6), n_experts=f.get("n_experts", 0),
        top_k=f.get("top_k", 0),
        capacity_factor=f.get("moe_capacity_factor", 1.25),
        ffn_block_sparse=f.get("ffn_block_sparse", False),
        ffn_block=f.get("ffn_block", 64),
        ffn_density=f.get("ffn_density", 0.25))


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's
    tags (any ``--seed`` up to and past 2**31 is fine)."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, *tags))


# ---------------------------------------------------------------------------
# the block-sparse FFN's pattern
# ---------------------------------------------------------------------------

FFN_PROJ = ("up", "gate", "down")


def ffn_shapes(a: Arch) -> Dict[str, Tuple[int, int]]:
    """(d_out, d_in) of each projection of the SwiGLU FFN."""
    return {"up": (a.d_ff, a.d_model), "gate": (a.d_ff, a.d_model),
            "down": (a.d_model, a.d_ff)}


def ffn_nnz(a: Arch, proj: str) -> int:
    """Stored blocks of a projection: the density's share of its grid,
    the same number on every seed."""
    m, k = ffn_shapes(a)[proj]
    cells = (m // a.ffn_block) * (k // a.ffn_block)
    return max(1, round(a.ffn_density * cells))


def ffn_patterns(a: Arch, seed: int, device) -> Dict[str, Tuple[torch.Tensor,
                                                              torch.Tensor]]:
    """``{proj: (brow, bcol)}`` int64 on ``device``, in row-major order: a
    random :func:`ffn_nnz` of the grid's cells, one pattern shared by every
    layer (as the port shares one)."""
    out = {}
    for proj in FFN_PROJ:
        m, k = ffn_shapes(a)[proj]
        gm, gk = m // a.ffn_block, k // a.ffn_block
        g = generator(device, seed, "pattern", proj)
        cells = torch.randperm(gm * gk, generator=g, device=device)
        cells = cells[:ffn_nnz(a, proj)].sort().values
        out[proj] = (cells // gk, cells % gk)
    return out


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    std: Optional[float]     # None: all ones (a norm's scale)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def leaves(a: Arch) -> List[Leaf]:
    """Every weight of the model by the port's parameter name, in draw
    order, with the port's init scales: N(0, 0.02²) tables, N(0, 1/fan_in)
    matrices, sparse blocks and experts, unit norm scales."""
    d, hd, v = a.d_model, a.head_dim, a.padded_vocab
    out = [Leaf("embed.table", (v, d), 0.02)]
    if not a.tie_embeddings:
        out.append(Leaf("lm_head.table", (v, d), 0.02))
    for i in range(a.n_layers):
        p = f"layers.{i}."
        out += [Leaf(p + "norm1.scale", (d,), None),
                Leaf(p + "attn.wq.w", (d, a.n_heads * hd), d ** -0.5),
                Leaf(p + "attn.wk.w", (d, a.n_kv * hd), d ** -0.5),
                Leaf(p + "attn.wv.w", (d, a.n_kv * hd), d ** -0.5),
                Leaf(p + "attn.wo.w", (a.n_heads * hd, d),
                     (a.n_heads * hd) ** -0.5),
                Leaf(p + "norm2.scale", (d,), None)]
        if a.family == "moe":
            e, f = a.n_experts, a.d_ff
            out += [Leaf(p + "moe.router.w", (d, e), d ** -0.5),
                    Leaf(p + "moe.gate", (e, d, f), d ** -0.5),
                    Leaf(p + "moe.up", (e, d, f), d ** -0.5),
                    Leaf(p + "moe.down", (e, f, d), f ** -0.5)]
        elif a.ffn_block_sparse:
            b = a.ffn_block
            for proj in FFN_PROJ:
                d_in = ffn_shapes(a)[proj][1]
                out.append(Leaf(p + f"mlp.{proj}.blocks",
                                (ffn_nnz(a, proj), b, b), d_in ** -0.5))
        else:
            out += [Leaf(p + "mlp.up.w", (d, a.d_ff), d ** -0.5),
                    Leaf(p + "mlp.gate.w", (d, a.d_ff), d ** -0.5),
                    Leaf(p + "mlp.down.w", (a.d_ff, d), a.d_ff ** -0.5)]
    out.append(Leaf("final_norm.scale", (d,), None))
    return out


def initial_leaves(a: Arch, seed: int, device,
                   names=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, fp32 initial value)`` of every leaf (or those in
    ``names``), in draw order; each chunk of the normal vector is drawn
    once, when the first leaf that needs it comes."""
    chunk, chunk_id = None, -1
    offset = 0
    for leaf in leaves(a):
        if leaf.std is None:
            if names is None or leaf.name in names:
                yield leaf.name, torch.ones(leaf.shape, device=device)
            continue
        lo, hi = offset, offset + leaf.numel
        offset = hi
        if names is not None and leaf.name not in names:
            continue
        parts = []
        pos = lo
        while pos < hi:
            c = pos // CHUNK
            if c != chunk_id:
                chunk = None     # free the old chunk before the next draw
                chunk = torch.randn(CHUNK, generator=generator(
                    device, seed, "weights", c), device=device)
                chunk_id = c
            end = min(hi, (c + 1) * CHUNK)
            parts.append(chunk[pos - c * CHUNK:end - c * CHUNK])
            pos = end
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        yield leaf.name, (flat * leaf.std).reshape(leaf.shape)


# ---------------------------------------------------------------------------
# lengths and tokens
# ---------------------------------------------------------------------------


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> List[int]:
    """``n`` lengths at the lognormal's quantiles ``(i + 0.5) / n``,
    clipped to ``[lo, hi]``: the same multiset on every seed (a seed only
    orders them)."""
    from statistics import NormalDist
    z = NormalDist()
    return [int(min(hi, max(lo, round(median * math.exp(
        sigma * z.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def stratified(values: List[int], block: int, seed: int,
               *tags) -> List[int]:
    """``values`` (one multiset, ascending) in an order drawn from the
    seed in which every run of ``block`` consecutive entries holds one
    value of each of ``block`` strata (the sorted values cut into
    ``block`` equal parts), in a seeded order: a window that takes a few
    blocks takes nearly the same work on every seed."""
    n = len(values)
    if n % block:
        raise ValueError(f"{n} values do not cut into strata of {block}")
    per = n // block
    picks = [permutation(per, seed, *tags, "stratum", s)
             for s in range(block)]
    out = []
    for b in range(per):
        order = permutation(block, seed, *tags, "block", b)
        out += [values[s * per + picks[s][b]] for s in order]
    return out


def permutation(n: int, seed: int, *tags) -> List[int]:
    """A permutation of ``range(n)`` from the seed, drawn on the host
    (small)."""
    g = torch.Generator().manual_seed(derive_seed(seed, *tags))
    return torch.randperm(n, generator=g).tolist()
