"""Read the checkpoints that ``repro``'s trainer writes.

``repro`` saves ``(params, AdamWState(step, m, v))`` as ``arrays.npz`` keyed
``leaf_00000``, ``leaf_00001``, ... in the flatten order of
``jax.tree_util``, with a manifest of the leaf count, shapes and dtypes
(no paths).  That order is rebuilt here from the config alone: dict keys
sorted at every level (so ``tail`` before ``units`` in a model with a layer
pattern, ``enc`` before ``dec``), the layers stacked on axis 0 (a pattern's
``units/b{j}`` over the units, its ``tail/b{j}`` with an axis of one), and
the step between the parameters and ``m``.  Each leaf maps onto the port's
state names (``params/layers.3.mlp.up.blocks``, ``opt/m/...``,
``opt/step``) through ``convert.params_from_jax``.

A block-sparse FFN's blocks are in the storage order of the JAX model's
shared patterns, which the reader needs (``ffn_patterns_np``: ``{"up" |
"gate" | "down": (brow, bcol)}``); the port's model must be built over the
same patterns.  bf16 leaves, which ``repro`` writes as fp32, come back in
the dtype of the state they are restored into (:meth:`JaxCheckpoint.restore`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.backends import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import FfnPatterns, Transformer

from .checkpoint import CheckpointManager, place_state

Keys = Tuple[str, ...]


class Leaf(NamedTuple):
    """One leaf of ``repro``'s checkpointed state: its path as
    ``jax.tree_util.keystr`` prints it, its shape, and the port's state
    names it holds (one a layer of a stacked leaf, in stack order)."""
    path: str
    shape: Tuple[int, ...]
    names: Tuple[str, ...]


def _repro_key(cfg: ModelConfig, name: str) -> Tuple[Keys, Optional[int]]:
    """A port parameter name → ``(repro's dict keys, index on the stack
    axis or None)``: the inverse of ``convert._layer_trees``."""
    parts = name.split(".")
    if parts[0] not in ("layers", "enc"):
        return tuple(parts), None
    i, rest = int(parts[1]), tuple(parts[2:])
    if cfg.family == "enc_dec":
        return ("enc" if parts[0] == "enc" else "dec",) + rest, i
    if not cfg.layer_pattern:
        return ("layers",) + rest, i
    p = len(cfg.layer_pattern)
    n_units = cfg.n_layers // p
    if i < n_units * p:
        return ("units", f"b{i % p}") + rest, i // p
    return ("tail", f"b{i - n_units * p}") + rest, 0


def _param_leaves(cfg: ModelConfig, ffn_patterns: Optional[FfnPatterns]
                  ) -> List[Tuple[Keys, Tuple[int, ...], Tuple[str, ...]]]:
    """``(keys, shape, port names)`` of each parameter leaf, sorted as JAX
    flattens nested dicts (the shapes from the port's model on the meta
    device: nothing is allocated)."""
    model = Transformer(cfg, device=torch.device("meta"),
                        ffn_patterns=ffn_patterns)
    groups: Dict[Keys, list] = {}
    for name, p in model.named_parameters():
        keys, idx = _repro_key(cfg, name)
        groups.setdefault(keys, []).append((idx, name, tuple(p.shape)))
    out = []
    for keys in sorted(groups):
        members = sorted(groups[keys], key=lambda m: -1 if m[0] is None
                         else m[0])
        idx, _, shape = members[0]
        if idx is not None:
            shape = (len(members),) + shape
        out.append((keys, shape, tuple(m[1] for m in members)))
    return out


def _keystr(keys: Keys) -> str:
    return "".join(f"['{k}']" for k in keys)


def jax_state_layout(cfg: ModelConfig,
                     ffn_patterns: Optional[FfnPatterns] = None
                     ) -> List[Leaf]:
    """The leaves of ``repro``'s ``(params, AdamWState)`` in checkpoint
    order (``leaf_%05d`` is the index here)."""
    params = _param_leaves(cfg, ffn_patterns)
    out = [Leaf("[0]" + _keystr(k), s, tuple(f"params/{n}" for n in names))
           for k, s, names in params]
    out.append(Leaf("[1].step", (), ("opt/step",)))
    for moment in ("m", "v"):
        out += [Leaf(f"[1].{moment}" + _keystr(k), s,
                     tuple(f"opt/{moment}/{n}" for n in names))
                for k, s, names in params]
    return out


def _nest(leaves: List[Tuple[Keys, np.ndarray]]) -> Dict:
    tree: Dict = {}
    for keys, a in leaves:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return tree


def restore_jax_checkpoint(directory: str, step: int, cfg: ModelConfig,
                           ffn_patterns_np: Optional[FfnPatterns] = None,
                           device=None) -> Dict[str, torch.Tensor]:
    """``repro``'s checkpoint ``<directory>/step_<step>`` as the port
    trainer's state dict (``params/…``, ``opt/m/…``, ``opt/v/…`` in fp32,
    ``opt/step`` int32) on ``device`` (``None``: the card).  The leaf count
    and every shape are checked against the manifest and the arrays."""
    device = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    layout = _param_leaves(cfg, ffn_patterns_np)
    n = len(layout)
    if manifest["n_leaves"] != 3 * n + 1:
        raise ValueError(f"{path}: {manifest['n_leaves']} leaves, but "
                         f"{cfg.name}'s training state has {3 * n + 1}")
    want = [s for _, s, _ in layout] + [()] + [s for _, s, _ in layout] * 2
    trees = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i:05d}"] for i in range(3 * n + 1)]
    for i, (a, s, m) in enumerate(zip(arrays, want, manifest["shapes"])):
        if tuple(a.shape) != s or tuple(m) != s:
            raise ValueError(f"{path}: leaf_{i:05d} has shape "
                             f"{tuple(a.shape)} (manifest {tuple(m)}), "
                             f"expected {s}")
    for start in (0, n + 1, 2 * n + 1):
        trees.append(_nest([(k, arrays[start + j])
                            for j, (k, _, _) in enumerate(layout)]))
    sd: Dict[str, torch.Tensor] = {}
    for prefix, tree in zip(("params/", "opt/m/", "opt/v/"), trees):
        for k, t in params_from_jax(cfg, tree, ffn_patterns_np).items():
            sd[prefix + k] = t.to(device)
    sd["opt/step"] = torch.tensor(int(arrays[n]), dtype=torch.int32,
                                  device=device)
    return sd


class JaxCheckpoint:
    """A directory of ``repro``'s checkpoints, restored as
    :class:`CheckpointManager` restores the port's (same ``restore``
    signature, so ``runtime.elastic.restore_onto_mesh`` takes either)."""

    def __init__(self, directory: str, cfg: ModelConfig,
                 ffn_patterns_np: Optional[FfnPatterns] = None):
        self.directory = directory
        self.cfg = cfg
        self.ffn_patterns_np = ffn_patterns_np

    def all_steps(self) -> List[int]:
        return CheckpointManager.all_steps(self)

    def latest_step(self) -> Optional[int]:
        return CheckpointManager.latest_step(self)

    def restore(self, step: int, state_like: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping] = None
                ) -> Dict[str, torch.Tensor]:
        """The state of ``step`` with the keys of ``state_like``, cast to
        its dtypes and placed on its devices (with ``shardings``, DTensors
        over this rank's shards)."""
        sd = restore_jax_checkpoint(self.directory, step, self.cfg,
                                    self.ffn_patterns_np, device="cpu")
        missing = sorted(set(state_like) - set(sd))
        if missing:
            raise ValueError(f"{self.cfg.name}: the checkpoint has no "
                             f"{missing}")
        return place_state({k: sd[k] for k in state_like}, state_like,
                           shardings)
