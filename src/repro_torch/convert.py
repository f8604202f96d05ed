"""Carry weights of the JAX model over to the port.

:func:`params_from_jax` takes the output of ``repro``'s ``Transformer.init``
(layer-stacked leaves, converted to numpy by the caller) and returns the
port's state dict, so that both packages compute the same function.  The
block-sparse FFN blocks are in the storage order of the JAX model's shared
patterns; the port's model must be built over the same patterns
(``build_model(cfg, ffn_patterns=...)``).  The port never reproduces JAX's
random numbers.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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
    checked against the block counts of the FFN leaves.
    """
    sd: Dict[str, torch.Tensor] = {
        "embed.table": _t(params_np["embed"]["table"]),
        "final_norm.scale": _t(params_np["final_norm"]["scale"]),
    }
    if "lm_head" in params_np:
        sd["lm_head.table"] = _t(params_np["lm_head"]["table"])
    lp = params_np["layers"]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        sd[pre + "norm1.scale"] = _t(lp["norm1"]["scale"][i])
        sd[pre + "norm2.scale"] = _t(lp["norm2"]["scale"][i])
        for name in ("wq", "wk", "wv", "wo"):
            for leaf, arr in lp["attn"][name].items():
                sd[pre + f"attn.{name}.{leaf}"] = _t(arr[i])
        for proj in _PROJS:
            for leaf, arr in lp["mlp"][proj].items():
                sd[pre + f"mlp.{proj}.{leaf}"] = _t(arr[i])
    if cfg.ffn_block_sparse:
        if ffn_patterns_np is None:
            raise ValueError("a block-sparse FFN needs ffn_patterns_np")
        for proj in _PROJS:
            n = np.asarray(ffn_patterns_np[proj][0]).size
            got = lp["mlp"][proj]["blocks"].shape[1]
            if got != n:
                raise ValueError(f"mlp.{proj} has {got} blocks per layer but "
                                 f"its pattern has {n}")
    return sd
