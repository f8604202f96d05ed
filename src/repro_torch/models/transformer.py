"""The transformer of every family in ``repro``'s registry (the port of
``repro.models.transformer``): one implementation, ten architectures.

Block kinds (``cfg.layer_kind``): ``attn`` (GQA attention + SwiGLU or the
block-sparse Segment FFN), ``local`` (attention within
``cfg.local_window`` over a ring KV cache), ``rec`` (an RG-LRU block,
:mod:`.recurrent`, with a dense SwiGLU), ``rwkv`` (RWKV-6 time mix and
channel mix; ``norm1``, ``norm2`` and ``rwkv`` only), ``moe`` (attention +
the per-row dispatched MoE of :mod:`.moe`, whose Switch aux loss the model
sums) and, for the encoder-decoder family, ``attn_bidir`` (bidirectional
encoder blocks) and ``cross`` (decoder blocks that add ``norm_x`` and
``xattn`` over the encoder's output).  The layers are one ``nn.ModuleList``
in ``repro``'s order (a layer pattern repeated, then its first ``n_layers
mod len(pattern)`` kinds) instead of scanned stacks; the encoder of
``enc_dec`` is a second list, ``enc``.  A ``frontend`` dense layer (the
stubbed patch / frame encoders) maps ``vis_embeds`` to a prefix of the
text (``vlm``) or ``enc_embeds`` to the encoder's input (``enc_dec``).
With ``ffn_block_sparse`` every sparse FFN uses one shared pruning
pattern (three plans, built once) and owns its block values, as in
``repro``.  Parameter names follow the JAX param dict (``embed.table``,
``layers.<i>.attn.wq.w``, ``layers.<i>.mlp.up.blocks``,
``layers.<i>.rwkv.mix``, ``layers.<i>.moe.gate``, ``enc.<i>.attn.wq.w``,
...), see :mod:`repro_torch.convert`.

The cache is a flat dict of tensors, the layer axis first and the slot
axis second: ``k``/``v`` ``(n_attn, B, max_len, n_kv, hd)`` over the
full-attention layers (``attn``, ``moe``, ``cross``; int8 with
``kv_cache_dtype="int8"``, beside ``(n_attn, B, max_len, n_kv)`` fp32
scales ``k_s``/``v_s``) and ``(n_local, B, min(max_len, local_window),
n_kv, hd)`` rings over the ``local`` layers, at ``k``/``v`` when no layer
has full attention and at ``k_local``/``v_local`` beside them, ``conv`` ``(n_rec, B, 3, D)`` and ``h`` ``(n_rec, B, D)``
fp32 over the RG-LRU layers, ``shift``/``cm_shift`` ``(n_rwkv, B, D)`` and
``S`` ``(n_rwkv, B, H, hd, hd)`` fp32 over the RWKV layers (``H / tp``
heads a rank on a split model).
:meth:`Transformer.decode_step` writes every entry in place.

Quantized serving: :meth:`Transformer.quantize` returns a model whose
sparse FFN blocks are int8/fp8 payloads with scales and which shares every
other tensor with the source.

Training: :meth:`Transformer.loss_fn` is ``repro``'s (a prefix of vision
positions trimmed off the logits, ``+ 0.01 · aux``).  With ``cfg.remat``
each block of a forward pass that records gradients is rematerialized
(``torch.utils.checkpoint``, as ``repro`` wraps its layer scan in
``jax.checkpoint``): only block inputs are kept, and the backward pass runs
each block's forward again.  The hybrid family trains too: its RG-LRU and
local-attention kernels record gradients through their autograd Functions,
whose backward passes are kernels of their own (``rg_lru_bwd``,
``flash_attention_bwd``).

Tensor parallelism: ``Transformer(cfg, mesh=)`` (or :meth:`Transformer.
shard_`) splits the attention heads, the dense SwiGLU's hidden units, the
RG-LRU channels, RWKV-6's heads (time mix) and hidden units (channel mix),
the MoE experts and the vocabulary over the mesh's ``model`` axis
(:mod:`repro_torch.sharding.tensor_parallel`); ``forward`` then returns
this rank's share of the vocabulary, ``loss_fn`` takes the vocab-parallel
cross entropy and ``decode_step`` gathers the whole vocabulary.  The MoE
router and the frontend still compute on full tensors on every rank
(:attr:`Transformer.tp_gathered`); the block-sparse
FFN is replicated, as in ``repro``.  The KV caches (full attention and
rings) split their time axis over the ranks that share their KV heads
(``repro``'s ``cache_pspec``, :attr:`Transformer.kv_tp`): all of
``model`` for an attention that runs whole on every rank, the ranks of one
KV head where there are fewer KV heads than ranks; each rank holds its
share of the positions (ring slots) and decode reduces the attention over
the group.  With ``cfg.seq_shard``
a forward without a cache splits the residual stream's T over ``model``
between blocks (:meth:`Transformer.seq_parallel`; Megatron's sequence
parallelism, ``repro``'s ``act_constrain(x, "seq")``).

Sharded parameters: :meth:`Transformer.zero3_` (called by the mesh
trainer and by ``build_model(mesh=)``) holds every parameter as this
rank's rule shard and gathers each unit's (a layer, the embedding with
the head and the final norm, the frontend) just before it runs
(:mod:`repro_torch.sharding.zero3`).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import BSR
from repro_torch.sharding.tensor_parallel import (NO_TP, TP,
                                                  TensorParallelError,
                                                  gather, local, split,
                                                  tp_group, tp_subgroup,
                                                  vocab_cross_entropy)

from . import layers
from .moe import MoE, moe_apply
from .recurrent import (RGLRUBlock, RWKVBlock, rwkv_block_state,
                        rwkv_channel_mix, rwkv_time_mix)
from .sparse_ffn import SparseLinear, SparseMLP

#: numpy seed of the shared FFN pattern when none is given
PATTERN_SEED = 17

FfnPatterns = Dict[str, Tuple[np.ndarray, np.ndarray]]

#: the cache entries of the recurrent kinds; the others belong to attention
STATE_KEYS = {"rec": ("conv", "h"), "rwkv": ("shift", "S", "cm_shift")}


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _shared_sparse_mlp(cfg: ModelConfig, patterns: Optional[FfnPatterns],
                       device) -> SparseMLP:
    """The shared plans: random from :data:`PATTERN_SEED`, or built over
    given ``{proj: (brow, bcol)}`` patterns."""
    if patterns is None:
        return SparseMLP.create(PATTERN_SEED, cfg.d_model, cfg.d_ff,
                                block=cfg.ffn_block, density=cfg.ffn_density,
                                device=device)
    b = cfg.ffn_block
    shapes = {"up": (cfg.d_ff, cfg.d_model), "gate": (cfg.d_ff, cfg.d_model),
              "down": (cfg.d_model, cfg.d_ff)}
    lin = {}
    for proj, shape in shapes.items():
        brow, bcol = (np.asarray(v, np.int32) for v in patterns[proj])
        w = BSR(shape, (b, b), brow, bcol,
                np.zeros((brow.size, b, b), np.float32))
        lin[proj] = SparseLinear.from_pattern(w, device=device)
    return SparseMLP(lin["up"], lin["gate"], lin["down"])


def _sharing_copy(mod: nn.Module, **children: nn.Module) -> nn.Module:
    """A new module object that shares every parameter, buffer and child of
    ``mod``, with ``children`` replaced (nothing is copied on the device)."""
    new = copy.copy(mod)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    new._modules = dict(mod._modules)
    for name, child in children.items():
        setattr(new, name, child)
    return new


#: a layer's names for its KV entries (``Attention`` reads these)
_KV_NAMES = ("k", "v", "k_s", "v_s")


def _cache_group(kind: str) -> str:
    """The cache entries a layer of ``kind`` owns: its own state's, the
    ring KV entries (``local``) or the full-length ones (every other
    attention kind)."""
    return kind if kind in STATE_KEYS or kind == "local" else "attn"


def _cache_keys(group: str, groups) -> Dict[str, str]:
    """A layer's names for its cache entries → the cache's keys.  The KV
    group of a model with one kind of attention layer is ``k``/``v``; a
    model with local layers beside full-attention ones keeps the full
    group there and puts the rings at ``k_local``/``v_local``."""
    if group in STATE_KEYS:
        return {k: k for k in STATE_KEYS[group]}
    suffix = "_local" if group == "local" and "attn" in groups else ""
    return {k: k + suffix for k in _KV_NAMES}


class Block(nn.Module):
    """Pre-norm attention + FFN block of kind ``attn``, ``local`` (within
    ``cfg.local_window``, over a ring KV cache), ``attn_bidir`` (no causal
    mask) or ``cross`` (then ``norm_x`` and ``xattn``: attention over the
    encoder output, or over the step's own tokens without a mask when no
    encoder output is given, as ``repro`` decodes)."""

    def __init__(self, cfg: ModelConfig, mlp: nn.Module, *, kind="attn",
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.window = cfg.local_window if kind == "local" else None
        self.causal = kind != "attn_bidir"
        self.norm1 = layers.RMSNorm(d, device=device)
        self.attn = layers.Attention(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                     qkv_bias=cfg.qkv_bias, device=device)
        if kind == "cross":
            self.norm_x = layers.RMSNorm(d, device=device)
            self.xattn = layers.Attention(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                          qkv_bias=cfg.qkv_bias,
                                          device=device)
        else:
            self.xattn = None
        self.norm2 = layers.RMSNorm(d, device=device)
        self.mlp = mlp

    def forward(self, x, *, positions, cache=None, cache_pos=0,
                enc_out=None, seq: TP = NO_TP, kv_shard: TP = NO_TP):
        """``seq``: ``x`` is this rank's rows of T (sequence parallelism);
        ``kv_shard``: the cache holds this rank's share of the timeline."""
        cfg = self.cfg
        x = x + self.attn(self.norm1(x, cfg.norm_eps, seq),
                          positions=positions, rope_theta=cfg.rope_theta,
                          cache=cache, cache_pos=cache_pos,
                          chunk=cfg.attn_chunk, window=self.window,
                          ring=self.window is not None, causal=self.causal,
                          seq=seq, kv_shard=kv_shard)
        if self.xattn is not None:
            x = x + self.xattn(self.norm_x(x, cfg.norm_eps, seq),
                               positions=positions, rope_theta=0.0,
                               causal=False, kv_ctx=enc_out,
                               chunk=cfg.attn_chunk, seq=seq)
        return x + self.mlp(self.norm2(x, cfg.norm_eps, seq), seq=seq), None


class MoEBlock(nn.Module):
    """Pre-norm causal attention + MoE FFN; returns the MoE's aux loss."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = layers.RMSNorm(d, device=device)
        self.attn = layers.Attention(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                     qkv_bias=cfg.qkv_bias, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.moe = MoE(d, cfg.d_ff, cfg.n_experts, device=device)

    def forward(self, x, *, positions, cache=None, cache_pos=0,
                enc_out=None, seq: TP = NO_TP, kv_shard: TP = NO_TP):
        cfg = self.cfg
        x = x + self.attn(self.norm1(x, cfg.norm_eps, seq),
                          positions=positions, rope_theta=cfg.rope_theta,
                          cache=cache, cache_pos=cache_pos,
                          chunk=cfg.attn_chunk, seq=seq, kv_shard=kv_shard)
        h, aux = moe_apply(self.moe, self.norm2(x, cfg.norm_eps, seq),
                           top_k=cfg.top_k,
                           capacity_factor=cfg.moe_capacity_factor, seq=seq)
        return x + h, aux


class RecBlock(nn.Module):
    """Pre-norm RG-LRU block + dense SwiGLU (``repro`` gives ``rec`` layers a
    dense FFN even when ``ffn_block_sparse`` is set)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = layers.RMSNorm(d, device=device)
        self.rec = RGLRUBlock(d, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.mlp = layers.SwiGLU(d, cfg.d_ff, device=device)

    def forward(self, x, *, positions=None, cache=None, cache_pos=0,
                enc_out=None, seq: TP = NO_TP):
        """``cache``: optional dict of ``conv`` (B, 3, D) and ``h`` (B, D),
        read as the state and overwritten in place with the new one."""
        cfg = self.cfg
        h, state = self.rec(self.norm1(x, cfg.norm_eps, seq), state=cache,
                            seq=seq)
        if cache is not None:
            for k in STATE_KEYS["rec"]:
                cache[k].copy_(state[k])
        x = x + h
        return x + self.mlp(self.norm2(x, cfg.norm_eps, seq), seq=seq), None


class RWKVLayer(nn.Module):
    """Pre-norm RWKV-6 time mix, then channel mix (no other FFN)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.n_heads = cfg.n_heads or 32
        self.norm1 = layers.RMSNorm(d, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.rwkv = RWKVBlock(d, self.n_heads, cfg.d_ff, device=device)

    def forward(self, x, *, positions=None, cache=None, cache_pos=0,
                enc_out=None, seq: TP = NO_TP):
        """``cache``: optional dict of ``shift``, ``S`` and ``cm_shift``,
        read as the state and overwritten in place with the new one.
        ``seq``: ``x`` is this rank's rows of T; the time and channel mix
        gather every row on entry and hand back this rank's."""
        cfg = self.cfg
        st = cache if cache is not None else rwkv_block_state(
            x.shape[0], cfg.d_model, self.n_heads, x.dtype, x.device,
            self.rwkv.tp)
        h, tm = rwkv_time_mix(self.rwkv, self.norm1(x, cfg.norm_eps, seq),
                              st, seq)
        x = x + h
        h, cm_shift = rwkv_channel_mix(
            self.rwkv, self.norm2(x, cfg.norm_eps, seq), st["cm_shift"], seq)
        if cache is not None:
            cache["shift"].copy_(tm["shift"])
            cache["S"].copy_(tm["S"])
            cache["cm_shift"].copy_(cm_shift)
        return x + h, None


class Transformer(nn.Module):
    """The model of ``cfg``.  Parameters are allocated (uninitialized) on
    ``device``; call :meth:`init` or load a state dict."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 ffn_patterns: Optional[FfnPatterns] = None, mesh=None):
        super().__init__()
        if cfg.family == "enc_dec":
            enc_kinds = ("attn_bidir",) * cfg.enc_layers
            kinds = ("cross",) * cfg.dec_layers
        else:
            enc_kinds = ()
            kinds = tuple(cfg.layer_kind(i) for i in range(cfg.n_layers))
        self.cfg = cfg
        self.layer_kinds = kinds
        d = cfg.d_model
        self.embed = layers.Embedding(cfg.padded_vocab, d, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers.Embedding(cfg.padded_vocab, d, device=device))
        self.frontend = (layers.Dense(d, d, device=device)
                         if cfg.frontend != "none" else None)
        proto = (_shared_sparse_mlp(cfg, ffn_patterns, device)
                 if cfg.ffn_block_sparse else None)

        def block(kind):
            if kind == "rec":
                return RecBlock(cfg, device=device)
            if kind == "rwkv":
                return RWKVLayer(cfg, device=device)
            if kind == "moe":
                return MoEBlock(cfg, device=device)
            mlp = (proto.like() if proto is not None else
                   layers.SwiGLU(d, cfg.d_ff, device=device))
            return Block(cfg, mlp, kind=kind, device=device)

        self.enc = (nn.ModuleList(block(k) for k in enc_kinds)
                    if enc_kinds else None)
        self.layers = nn.ModuleList(block(k) for k in kinds)
        self.final_norm = layers.RMSNorm(d, device=device)
        # each layer's index along the layer axis of its cache entries, and
        # the cache keys it reads them from
        groups = [_cache_group(k) for k in kinds]
        self._cache_groups = groups
        self._cache_index = [groups[:i].count(g) for i, g in enumerate(groups)]
        self._cache_keys = [_cache_keys(g, groups) for g in groups]
        #: (cache group, its length a rank) → split on time or not (the
        #: layout :meth:`init_cache` made it in)
        self._kv_split: Dict[Tuple[str, int], bool] = {}
        self.tp = NO_TP
        #: the ranks that hold the same KV heads, over which the KV
        #: caches split their time axis (:meth:`shard_`)
        self.kv_tp = NO_TP
        #: module name → why it computes on full tensors under TP
        self.tp_gathered: Dict[str, str] = {}
        #: the per-unit gather of the sharded parameters (:meth:`zero3_`)
        self.zero3 = None
        if mesh is not None:
            self.shard_(mesh)

    def shard_(self, mesh=None, *, tp: Optional[TP] = None) -> "Transformer":
        """Split compute over ``mesh``'s ``model`` axis (or ``tp``), in
        place: each attention, dense SwiGLU, RG-LRU block, RWKV-6 block
        (heads and hidden units), MoE expert stack (expert parallelism)
        and the embedding / head keep this rank's shards (their modules'
        ``tensor_parallel_``).  Built whole first:
        the full tensors are freed as the shards replace them.  One rank on
        ``model`` changes nothing.

        Computed on full tensors on every rank, and named in
        :attr:`tp_gathered`: the MoE router (its top-k reads every
        expert's logit), the frontend, and an attention, FFN, RWKV-6 block
        or MoE whose heads, width or experts do not split over the
        ranks.  The block-sparse FFN is replicated, as
        ``repro``'s rules replicate its blocks.

        The KV group (:attr:`kv_tp`) is made here, once, on every rank:
        all of ``model`` for an attention that runs whole on every rank,
        the ``rep / mine`` consecutive ranks whose query heads read one KV
        head where the KV heads are fewer than the ranks (a subgroup of
        ``model``; every rank makes every such group, in the same order),
        and no group where each rank owns its KV heads."""
        tp = tp_group(mesh) if tp is None else tp
        if self.tp.on:
            if (tp.rank, tp.size) != (self.tp.rank, self.tp.size):
                raise TensorParallelError(
                    f"the model is split over {self.tp.size} model ranks; "
                    f"build it again for {tp.size}")
            return self
        if not tp.on:
            return self
        if self.zero3 is not None:
            raise TensorParallelError("split the model before zero3_")
        gathered: Dict[str, str] = {}

        def split(name, mod):
            try:
                mod.tensor_parallel_(tp)
            except TensorParallelError as e:
                gathered[name] = str(e)

        split("embed", self.embed)
        if self.lm_head is not None:
            split("lm_head", self.lm_head)
        if self.frontend is not None:
            gathered["frontend"] = "the modality frontend is replicated"
        for prefix, blocks in (("enc", self.enc or ()),
                               ("layers", self.layers)):
            for i, blk in enumerate(blocks):
                name = f"{prefix}.{i}"
                for attr in ("attn", "xattn", "rec", "rwkv"):
                    mod = getattr(blk, attr, None)
                    if mod is not None:
                        split(f"{name}.{attr}", mod)
                if isinstance(getattr(blk, "mlp", None), layers.SwiGLU):
                    split(f"{name}.mlp", blk.mlp)
                if isinstance(blk, MoEBlock):
                    split(f"{name}.moe", blk.moe)
                    gathered[f"{name}.moe.router"] = \
                        "the MoE router (top-k reads every expert's logit)"
        self.tp, self.tp_gathered = tp, gathered
        self.kv_tp = tp_subgroup(tp, self._kv_group_size(tp), mesh)
        return self

    def _kv_group_size(self, tp: TP) -> int:
        """The number of ``model`` ranks that hold the same KV heads."""
        attn = self._attention()
        if attn is None:
            return 1
        if not attn.tp.on:
            return tp.size
        rep = self.cfg.n_heads // self.cfg.n_kv
        mine = self.cfg.n_heads // tp.size
        return rep // mine if rep > mine else 1

    def zero3_(self, mesh, fsdp="data"):
        """Hold every parameter as this rank's shard of ``params_pspecs``
        (FSDP on ``fsdp``) and gather each unit's just before it runs
        (:class:`~repro_torch.sharding.zero3.Zero3`, returned and kept at
        :attr:`zero3`); on an already split model (:meth:`shard_`).  Again
        with the same mesh and ``fsdp``: the same manager; with others a
        ``ValueError`` (build the model again)."""
        from repro_torch.sharding import (dp_axes, make_shardings,
                                          params_pspecs)
        from repro_torch.sharding.zero3 import Zero3
        z = self.zero3
        if z is not None:
            if z.mesh is not mesh or z.fsdp != fsdp:
                raise ValueError(
                    f"the parameters are sharded with fsdp={z.fsdp!r} on "
                    f"another mesh or axes; build the model again for "
                    f"fsdp={fsdp!r}")
            return z
        split = self.tp_local_params()
        full = self.full_shapes()
        shardings = make_shardings(mesh, params_pspecs(full, fsdp=fsdp),
                                   full, {k: dim for k, (dim, _)
                                          in split.items()})
        self.zero3 = Zero3(self, shardings, fsdp)
        dp = tuple((mesh.get_group(i), mesh.size(i))
                   for i, a in enumerate(mesh.mesh_dim_names)
                   if a in dp_axes(mesh) and mesh.size(i) > 1)
        for mod in self.modules():
            if isinstance(mod, MoE):
                mod.dp = dp
        return self.zero3

    def _call(self, unit: str, fn, *args, backward: bool = True, **kw):
        """``fn(*args, **kw)``, with ``unit``'s parameters gathered around
        it when they are sharded (:meth:`Zero3.call`)."""
        if self.zero3 is None:
            return fn(*args, **kw)
        return self.zero3.call(unit, fn, *args, backward=backward, **kw)

    def tp_local_params(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        """``{parameter name: (its dim local on model, its full shape)}``
        of each parameter that holds this rank's slice (none at one
        rank)."""
        out = {}
        for mname, mod in self.named_modules():
            if mod is self:
                continue
            for pname, spec in getattr(mod, "tp_local", {}).items():
                out[f"{mname}.{pname}"] = spec
        return out

    def full_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each parameter's full shape (a local slice's whole tensor)."""
        split = self.tp_local_params()
        return {k: split[k][1] if k in split else tuple(p.shape)
                for k, p in self.named_parameters()}

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; on a split model an entry of a
        local parameter may also be the full tensor (a single process's
        state dict), of which this rank's slice is loaded.  On a model
        with sharded parameters (:meth:`zero3_`) the entry of a sharded
        one is written into this rank's shard."""
        state_dict = dict(state_dict)
        sharded = []
        if self.zero3 is not None:
            sharded = [k for k in self.zero3.axes if k in state_dict]
            for k in sharded:
                self.zero3.load_(k, state_dict.pop(k))
        for k, (dim, shape) in self.tp_local_params().items():
            t = state_dict.get(k)
            if t is not None and tuple(t.shape) == shape:
                state_dict[k] = local(t, dim, self.tp)
        if not sharded:
            return super().load_state_dict(state_dict, strict=strict,
                                           assign=assign)
        res = super().load_state_dict(state_dict, strict=False,
                                      assign=assign)
        res.missing_keys[:] = [k for k in res.missing_keys
                               if k not in sharded]
        if strict and (res.missing_keys or res.unexpected_keys):
            raise RuntimeError(
                f"Error(s) in loading state_dict for {type(self).__name__}:"
                f" missing keys {res.missing_keys}, unexpected keys "
                f"{res.unexpected_keys}")
        return res

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Transformer":
        """Random weights from ``gen`` (a generator on the model's device):
        N(0, 0.02²) embeddings, N(0, 1/d_in) dense, sparse and expert
        weights, unit norm scales, the recurrent blocks' own draws."""
        z = self.zero3
        names = {id(p): k for k, p in self.named_parameters()}
        for mod in self.modules():
            if isinstance(mod, (layers.Dense, layers.RMSNorm,
                                layers.Embedding, SparseLinear, RGLRUBlock,
                                RWKVBlock, MoE)):
                if z is None:
                    mod.init_(gen)
                    continue
                # a sharded parameter is drawn whole, then its shard kept
                with z.materialize(names[id(p)] for p in mod.parameters()):
                    mod.init_(gen)
        return self

    def _blocks(self) -> List[nn.Module]:
        return list(self.enc or ()) + list(self.layers)

    @property
    def recurrent(self) -> bool:
        """True when some layer carries recurrent state (``rec``, ``rwkv``):
        padding would pollute it, so the engine prefills a token a call."""
        return bool({"rec", "rwkv"} & set(self.layer_kinds))

    @property
    def quantized(self) -> bool:
        """True when the sparse FFN blocks are int8/fp8 payloads."""
        return any(isinstance(getattr(blk, "mlp", None), SparseMLP)
                   and blk.mlp.up.quantized for blk in self._blocks())

    def quantize(self, mode: str = "int8") -> "Transformer":
        """A copy of this model for quantized serving (``repro``'s
        ``Transformer.quantize``): every sparse FFN's blocks become a
        ``mode`` payload (``"int8"``, ``"fp8"``, ``"int8.rowwise"`` or
        ``"fp8.rowwise"``) with fp32 scales, under quantized plans that
        share one cached schedule per projection.  Every other tensor (the
        recurrent and MoE blocks and the dense SwiGLUs included) is shared
        with this model, not copied."""
        if not self.cfg.ffn_block_sparse:
            raise ValueError(
                "Transformer.quantize requires a block-sparse FFN model "
                "(ModelConfig.ffn_block_sparse=True); dense SwiGLU weights "
                "have no Segment plan to quantize")
        if self.quantized:
            raise ValueError("the model is already quantized; quantize "
                             "from the fp32 model")

        def frozen(blocks):
            return nn.ModuleList(
                _sharing_copy(blk, mlp=blk.mlp.quantize(mode))
                if isinstance(getattr(blk, "mlp", None), SparseMLP) else blk
                for blk in blocks)

        children = {"layers": frozen(self.layers)}
        if self.enc is not None:
            children["enc"] = frozen(self.enc)
        return _sharing_copy(self, **children)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return (self.lm_head or self.embed).head(x)

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """:meth:`forward`'s logits over the whole vocabulary: on a split
        model each rank's share all-gathered (backward: this rank's
        slice); the logits themselves at one rank."""
        return gather(logits, -1, self.tp)

    def seq_parallel(self, t: int) -> TP:
        """The ``model`` axis whose ranks each hold ``t / tp`` rows of the
        residual stream in a forward of ``t`` positions without a cache:
        the model's, with ``cfg.seq_shard`` on a split model where tp
        divides ``t`` (``repro``'s ``act_constrain(x, "seq")``), else
        :data:`NO_TP`."""
        tp = self.tp
        return (tp if self.cfg.seq_shard and tp.on and t % tp.size == 0
                else NO_TP)

    def _run(self, blocks, x, positions, enc_out=None, prefix="layers",
             seq: TP = NO_TP):
        """The blocks over x (units ``<prefix>.<i>``; ``seq``: x is this
        rank's rows of T), rematerialized under ``cfg.remat`` when
        gradients are recorded.  Returns ``(x, summed aux loss)``."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), device=x.device)
        for i, blk in enumerate(blocks):
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x, a = self._call(f"{prefix}.{i}", checkpoint, blk, x,
                                  positions=positions, enc_out=enc_out,
                                  seq=seq, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._call(f"{prefix}.{i}", blk, x,
                                  positions=positions, enc_out=enc_out,
                                  seq=seq)
            if a is not None:
                aux = aux + a
        return x, aux

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's output (no final norm) over ``enc_embeds`` (B,
        T_enc, D) through the frontend: what the decoder's cross attention
        reads (``enc_dec`` only)."""
        e = self._call("frontend", self.frontend,
                       enc_embeds.to(act_dtype(self.cfg)))
        b, t, _ = e.shape
        positions = torch.arange(t, device=e.device).expand(b, t)
        seq = self.seq_parallel(t)
        x = self._run(self.enc, split(e, 1, seq), positions, prefix="enc",
                      seq=seq)[0]
        # every decoder block reads all of it (the backward: this rank's
        # rows of the gradient, the same on every rank)
        return gather(x, 1, seq)

    def forward(self, tokens: torch.Tensor,
                vis_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None, *,
                return_aux: bool = False):
        """tokens (B, T_text) → logits (B, T, padded_vocab), with
        ``return_aux`` ``(logits, aux)``: the summed MoE aux loss (fp32,
        0 without MoE layers).  ``vis_embeds`` (B, Nv, D): a prefix through
        the frontend (``vlm``; T = Nv + T_text, positions over the whole
        sequence); ``enc_embeds`` (B, T_enc, D): the encoder's input
        (``enc_dec``, required there).  On a split model the logits are
        this rank's share of the vocabulary (B, T, padded_vocab / tp), as
        ``repro``'s prefill output is sharded on ``model``
        (:meth:`full_logits` gathers them).  Under sequence parallelism
        (:meth:`seq_parallel`) the blocks run on this rank's rows of T and
        the head on all of them."""
        dt = act_dtype(self.cfg)
        t = tokens.shape[1] + (0 if vis_embeds is None else
                               vis_embeds.shape[1])
        seq = self.seq_parallel(t)
        # the lookup's backward reads only the indices: no gather for it
        if vis_embeds is None:
            x = self._call("embed", self.embed, tokens, seq,
                           backward=False).to(dt)
        else:
            x = self._call("embed", self.embed, tokens, backward=False).to(dt)
            x = split(torch.cat([self._call("frontend", self.frontend,
                                            vis_embeds.to(dt)), x], dim=1),
                      1, seq)
        enc_out = None
        if self.enc is not None:
            if enc_embeds is None:
                raise ValueError(f"{self.cfg.name}: the encoder-decoder "
                                 f"forward needs enc_embeds")
            enc_out = self.encode(enc_embeds)
        b = x.shape[0]
        positions = torch.arange(t, device=x.device).expand(b, t)
        x, aux = self._run(self.layers, x, positions, enc_out, seq=seq)
        logits = self._call("embed", self._head, x, seq)
        return (logits, aux) if return_aux else logits

    def _head(self, x: torch.Tensor, seq: TP = NO_TP) -> torch.Tensor:
        """The final norm and the head (``seq``: on this rank's rows of T,
        then the head on all of them)."""
        return (self.lm_head or self.embed).head(
            self.final_norm(x, self.cfg.norm_eps, seq), seq)

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """batch: dict(tokens (B, T), targets (B, T)[, vis_embeds,
        enc_embeds, mask (B, T)]).

        Returns ``(loss + 0.01·aux, {"loss", "aux"})`` as ``repro`` does;
        the logits of a vision prefix are trimmed off before the loss."""
        logits, aux = self(batch["tokens"], batch.get("vis_embeds"),
                           batch.get("enc_embeds"), return_aux=True)
        targets = batch["targets"]
        n_prefix = logits.shape[1] - targets.shape[1]
        if n_prefix > 0:
            logits = logits[:, n_prefix:]
        if self.tp.on:
            loss = vocab_cross_entropy(logits, targets, batch.get("mask"),
                                       self.tp)
        else:
            loss = layers.cross_entropy(logits, targets, batch.get("mask"))
        return loss + 0.01 * aux, {"loss": loss.detach(),
                                   "aux": aux.detach()}

    def _attention(self) -> Optional[layers.Attention]:
        return next((m for m in self.modules()
                     if isinstance(m, layers.Attention)), None)

    def kv_shard(self, group: str, max_len: int) -> TP:
        """The ranks over which :meth:`init_cache` splits the time axis of
        ``group``'s KV cache for ``max_len`` positions (``"attn"``: the
        full-attention cache of ``max_len``; ``"local"``: the rings of
        ``min(max_len, local_window)`` slots): the KV group
        (:attr:`kv_tp`) where the length divides over it, else
        :data:`NO_TP`, as ``repro``'s ``sanitize_pspec`` falls back to
        replication."""
        g = self.kv_tp
        if not g.on or group not in self._cache_groups:
            return NO_TP
        n = max_len if group == "attn" else min(max_len,
                                                self.cfg.local_window)
        return g if n % g.size == 0 else NO_TP

    def kv_split_on_time(self, max_len: int) -> bool:
        """True when :meth:`init_cache` splits a KV cache (full attention
        or rings) of ``max_len`` positions on time (:meth:`kv_shard`)."""
        return any(self.kv_shard(g, max_len).on for g in ("attn", "local"))

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zero cache for ``batch_size`` slots of ``max_len`` positions (the
        decoder's layers only).  Full-attention layers get ``max_len``
        positions, local layers a ring of ``min(max_len, local_window)``,
        as ``repro``'s per-layer caches do.  Raises ``ValueError`` for an
        int8 KV cache over local layers: the ring has no int8 mode
        (``repro``'s ring write drops the scales).

        On a split model each rank's cache holds the RG-LRU channels and
        the RWKV-6 heads (``S``) it runs, and the KV heads its query heads
        read (``Attention.kv_span``; all of them for an attention that
        runs whole on every rank).  Each KV cache splits its time axis
        over the ranks that hold the same KV heads (:attr:`kv_tp`) where
        its length divides over them (:meth:`kv_shard`), so a rank holds
        exactly the bytes of ``repro``'s ``cache_pspec`` share: rank r of
        a group of g holds positions ``[r·L, (r+1)·L)``, ``L = max_len /
        g``, of its KV heads (int8 scales with their values; ``repro``
        shards the scales only from 1024 positions, so below that a
        rank's scales are smaller than its), and ring slots ``[r·W/g,
        (r+1)·W/g)`` of a ring of W.  :meth:`decode_step` then reduces the
        attention over the group.  Elsewhere a cache stays whole, as
        ``repro``'s rule falls back to replication."""
        cfg = self.cfg
        dev, dt = self.device, act_dtype(cfg)
        attn = self._attention()
        n_kv = cfg.n_kv if attn is None else attn.n_kv
        groups = self._cache_groups
        cache = {}
        for group, t_len in (("attn", max_len),
                             ("local", min(max_len, cfg.local_window))):
            n = groups.count(group)
            if not n:
                continue
            split_t = self.kv_shard(group, max_len).on
            t_len //= self.kv_tp.size if split_t else 1
            if self._kv_split.get((group, t_len), split_t) != split_t:
                raise ValueError(
                    f"a {group} cache of {t_len} positions a rank was made "
                    f"{'whole' if split_t else 'split on time'} before; "
                    f"this one would be the other layout")
            self._kv_split[(group, t_len)] = split_t
            keys = _cache_keys(group, groups)
            shape = (n, batch_size, t_len, n_kv, cfg.hd)
            if cfg.kv_cache_dtype == "int8":
                if group == "local":
                    raise ValueError(
                        f"{cfg.name}: kv_cache_dtype='int8' is not supported "
                        f"with local attention layers (the ring KV cache has "
                        f"no int8 mode); use the {dt} cache")
                cache.update({
                    keys["k"]: torch.zeros(shape, dtype=torch.int8,
                                           device=dev),
                    keys["v"]: torch.zeros(shape, dtype=torch.int8,
                                           device=dev),
                    keys["k_s"]: torch.zeros(shape[:-1], device=dev),
                    keys["v_s"]: torch.zeros(shape[:-1], device=dev)})
            else:
                cache.update({keys["k"]: torch.zeros(shape, dtype=dt,
                                                     device=dev),
                              keys["v"]: torch.zeros(shape, dtype=dt,
                                                     device=dev)})
        d = cfg.d_model
        n_rec = groups.count("rec")
        if n_rec:
            d = next(m.a_param.shape[0] // m.tp.size for m in self.modules()
                     if isinstance(m, RGLRUBlock))
            cache.update(
                conv=torch.zeros((n_rec, batch_size, 3, d), dtype=dt,
                                 device=dev),
                h=torch.zeros((n_rec, batch_size, d), dtype=torch.float32,
                              device=dev))
        n_rwkv = groups.count("rwkv")
        if n_rwkv:
            rwkv = next(m for m in self.modules()
                        if isinstance(m, RWKVBlock))
            st = rwkv_block_state(n_rwkv * batch_size, cfg.d_model,
                                  cfg.n_heads or 32, dt, dev, rwkv.tp)
            cache.update({k: v.reshape(n_rwkv, batch_size, *v.shape[1:])
                          for k, v in st.items()})
        return cache

    def decode_step(self, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                    pos, enc_out: Optional[torch.Tensor] = None, *,
                    logit_idx: Optional[torch.Tensor] = None):
        """token: (B, T) int (T=1 decode, T>1 chunked prefill); pos: the
        absolute position of token[:, 0], a shared int or a per-row (B,)
        tensor.  ``enc_out``: the encoder's output for the cross blocks
        (:meth:`encode`; without it they attend over the step's own tokens,
        as ``repro``'s do).  ``logit_idx``: optional per-row (B,) index of
        each row's last valid token (logits are taken there, not at T-1).

        Writes the new keys and values (and the recurrent state) into
        ``cache`` in place and returns ``(logits (B, padded_vocab),
        cache)``: the whole vocabulary on a split model too (each rank's
        share all-gathered).  A cache split on time (:meth:`init_cache`)
        takes the new keys on the ranks that hold their positions (ring
        slots), and each attention over it reduces over the KV group."""
        shards = {}
        for group in ("attn", "local"):
            k = cache.get(_cache_keys(group, self._cache_groups)["k"])
            shards[group] = (self.kv_tp if k is not None and
                             self._kv_split.get((group, k.shape[2]))
                             else NO_TP)
        x = self._call("embed", self.embed, token,
                       backward=False).to(act_dtype(self.cfg))
        b, t, _ = x.shape
        steps = torch.arange(t, device=x.device)
        if isinstance(pos, int) or pos.ndim == 0:
            positions = (int(pos) + steps).expand(b, t)
        else:
            positions = pos.long()[:, None] + steps
        for j, (blk, keys, i) in enumerate(zip(self.layers, self._cache_keys,
                                               self._cache_index)):
            mine = {name: cache[key][i] for name, key in keys.items()
                    if key in cache}
            group = self._cache_groups[j]
            kw = {"kv_shard": shards[group]} if group in shards else {}
            x, _ = self._call(f"layers.{j}", blk, x, positions=positions,
                              cache=mine, cache_pos=pos, enc_out=enc_out,
                              **kw)
        logits = self._call("embed", self._decode_head, x, logit_idx)
        return self.full_logits(logits)[:, 0], cache

    def _decode_head(self, x: torch.Tensor,
                     logit_idx: Optional[torch.Tensor]) -> torch.Tensor:
        """The final norm, then the head at each row's output position."""
        x = self.final_norm(x, self.cfg.norm_eps)
        # gather each row's output position before the head, so the
        # (B, T, vocab) prefill logits never materialize
        b = x.shape[0]
        if logit_idx is None:
            x = x[:, -1:]
        else:
            idx = torch.as_tensor(logit_idx, device=x.device).long().expand(b)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        return self._logits(x)
