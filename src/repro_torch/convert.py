"""Carry state of the JAX package over to the port.

:func:`params_from_jax` takes the output of ``repro``'s ``Transformer.init``
or ``Transformer.quantize`` (layer-stacked leaves, converted to numpy by
the caller) and returns the port's state dict, so that both packages
compute the same function.  The port's modules carry ``repro``'s keys, so
each block's tree comes over leaf for leaf under its dotted path.  A tree
without a layer pattern stacks its blocks under ``layers``; one with a
pattern (hybrid, Maverick's ``("attn", "moe")``) under ``units/b{j}``
(stacked over the units) and ``tail/b{j}`` (one unit's first blocks),
which come over as ``layers.{u * len(pattern) + j}`` and then the tail's;
an encoder-decoder's ``enc`` and ``dec`` as ``enc.{i}`` and
``layers.{i}``.  ``frontend`` and ``lm_head`` come over as they are.  The
block-sparse FFN blocks are in the storage order of the JAX model's
shared patterns; the port's model must be built over the same patterns
(``build_model(cfg, ffn_patterns=...)``).  :func:`quantized_blocks_from_jax`
does the same for ``repro``'s quantized block storage.  The port never
reproduces JAX's random numbers.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import (QUANT_DTYPES, ROWWISE_SUFFIX,
                                      QuantizedBlocks, _check_quant_dtype,
                                      quant_base_dtype)
from repro_torch.models.transformer import FfnPatterns

_PROJS = ("up", "gate", "down")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(cfg: ModelConfig, params_np: Mapping,
                    ffn_patterns_np: Optional[FfnPatterns] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) → the port's ``state_dict``.

    ``ffn_patterns_np``: ``{"up"|"gate"|"down": (brow, bcol)}`` of the JAX
    model's shared FFN plans; required when ``cfg.ffn_block_sparse``, and
    checked against the block counts of the FFN leaves.  A quantized tree
    (``repro``'s ``Transformer.quantize``) has FFN projections
    ``{"blocks": payload, "scales": scales}`` stacked over layers; they
    come over bit for bit (:func:`quantized_blocks_from_jax`) as the port's
    ``blocks`` and ``scales`` buffers, in the mode the leaves carry: an
    int8 payload is ``"int8"``, any other 1-byte one (fp8, or its ``uint8``
    view) ``"fp8"``, and ``(layers, n, bm)`` scales are rowwise.
    """
    sd: Dict[str, torch.Tensor] = {
        "embed.table": _t(params_np["embed"]["table"]),
        "final_norm.scale": _t(params_np["final_norm"]["scale"]),
    }
    for name in ("lm_head", "frontend"):
        if name in params_np:
            _put(sd, name + ".", params_np[name], None)
    for pre, tree, idx in _layer_trees(cfg, params_np):
        block = {k: v for k, v in tree.items() if k != "mlp"}
        _put(sd, pre, block, idx)
        if "mlp" not in tree:                # moe and rwkv blocks
            continue
        for proj in _PROJS:
            leaves = tree["mlp"][proj]
            if "scales" not in leaves:
                _put(sd, pre + f"mlp.{proj}.", leaves, idx)
                continue
            q = quantized_blocks_from_jax(leaves["blocks"][idx],
                                          leaves["scales"][idx],
                                          _mode_of(leaves))
            sd[pre + f"mlp.{proj}.blocks"] = q.payload
            sd[pre + f"mlp.{proj}.scales"] = q.scales
        if cfg.ffn_block_sparse and "blocks" in tree["mlp"]["up"]:
            if ffn_patterns_np is None:
                raise ValueError("a block-sparse FFN needs ffn_patterns_np")
            for proj in _PROJS:
                n = np.asarray(ffn_patterns_np[proj][0]).size
                got = tree["mlp"][proj]["blocks"].shape[1]
                if got != n:
                    raise ValueError(f"mlp.{proj} has {got} blocks per "
                                     f"layer but its pattern has {n}")
    return sd


def _put(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping,
         idx: Optional[int]) -> None:
    """Every leaf of a nested dict under its dotted path (the port's module
    names are ``repro``'s keys), indexed at ``idx`` along a layer-stacked
    leaf's first axis."""
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            _put(sd, f"{prefix}{key}.", sub, idx)
        else:
            sd[prefix + key] = _t(sub if idx is None else sub[idx])


def _layer_trees(cfg: ModelConfig, params_np: Mapping):
    """``(state-name prefix, block tree, index along its stack axis)`` of
    each layer: the encoder's (``enc`` → ``enc.{i}``), then the decoder's
    or the model's in the port's layer order (``dec`` or ``layers``, or a
    layer pattern's ``units/b{j}`` over units then ``tail/b{j}`` →
    ``layers.{i}``)."""
    if cfg.family == "enc_dec":
        return ([(f"enc.{i}.", params_np["enc"], i)
                 for i in range(cfg.enc_layers)]
                + [(f"layers.{i}.", params_np["dec"], i)
                   for i in range(cfg.dec_layers)])
    if not cfg.layer_pattern:
        trees = [(params_np["layers"], i) for i in range(cfg.n_layers)]
    else:
        p = len(cfg.layer_pattern)
        n_units = cfg.n_layers // p
        trees = ([(params_np["units"][f"b{j}"], u)
                  for u in range(n_units) for j in range(p)]
                 + [(params_np["tail"][f"b{j}"], 0)
                    for j in range(cfg.n_layers - n_units * p)])
    return [(f"layers.{i}.", tree, idx) for i, (tree, idx) in
            enumerate(trees)]


def _mode_of(leaves: Mapping) -> str:
    """The quantization mode of one layer-stacked projection of a quantized
    ``repro`` tree."""
    base = "int8" if leaves["blocks"].dtype == np.int8 else "fp8"
    return base + (ROWWISE_SUFFIX if leaves["scales"].ndim == 3 else "")


def quantized_blocks_from_jax(payload, scales, mode: str) -> QuantizedBlocks:
    """``repro``'s ``QuantizedBlocks`` (its ``payload``, ``scales`` and
    ``dtype``, as numpy) → the port's, bit for bit.

    ``torch.from_numpy`` takes no ``ml_dtypes`` array, so an fp8 payload is
    passed as its ``uint8`` view (``payload.view(np.uint8)``); an int8
    payload as it is.  The scales are fp32, ``(nblocks,)`` or
    ``(nblocks, bm)``.
    """
    _check_quant_dtype(mode)
    payload = np.ascontiguousarray(payload)
    want = QUANT_DTYPES[quant_base_dtype(mode)]
    if payload.dtype.itemsize != 1:
        raise ValueError(f"a {mode} payload has 1-byte elements, got "
                         f"{payload.dtype}")
    t = torch.from_numpy(payload.view(np.uint8).copy()).view(want)
    return QuantizedBlocks(
        payload=t, scales=torch.from_numpy(np.array(scales, np.float32)),
        dtype=mode)
