"""The system under test, built from the benchmark's inputs: the port's
model at the configuration as run, its FFN pattern and weights drawn by
:mod:`perfbench.inputs` and copied in, and the kernels the configuration
names built first (into the port's own build directory in the checkout).

The benchmark takes from the program only its entry points
(``build_model``, ``Engine``, ``make_train_step``, ``AdamW``) and its
kernel names.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.inputs import Arch, ffn_patterns, initial_leaves, model_fields


class ProgramError(RuntimeError):
    """The program does not take the inputs as the benchmark states them."""


def build_kernels(config: dict, device: torch.device) -> None:
    """Builds (or finds built) the CUDA sources the configuration names,
    so that a first run builds these and no others."""
    sources = config.get("kernels", [])
    if device.type != "cuda" or not sources:
        return
    from repro_torch.kernels.build import BuildJob
    BuildJob([(s, s, False) for s in sources]).wait()


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**model_fields(config))


def build(config: dict, a: Arch, seed: int, device: torch.device):
    """The port's model with the seed's pattern and weights; returns
    ``(model, pattern)`` (``pattern`` None for a dense FFN)."""
    from repro_torch.models import build_model

    build_kernels(config, device)
    pattern = ffn_patterns(a, seed, device) if a.ffn_block_sparse else None
    host = (None if pattern is None else
            {p: (br.cpu().numpy(), bc.cpu().numpy())
             for p, (br, bc) in pattern.items()})
    model = build_model(model_config(config), device=device, ffn_patterns=host)
    if pattern is not None:
        mlp = model.layers[0].mlp
        for proj, (br, bc) in pattern.items():
            plan = getattr(mlp, proj).plan
            if not (torch.equal(plan.a_brow.cpu().long(), br.cpu())
                    and torch.equal(plan.a_bcol.cpu().long(), bc.cpu())):
                raise ProgramError(f"the {proj} plan stores its blocks in "
                                   f"another order than the pattern")
    load_weights(model, a, seed)
    return model, pattern


@torch.no_grad()
def load_weights(model, a: Arch, seed: int) -> None:
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())
    drawn = set()
    for name, value in initial_leaves(a, seed, model.device):
        p = params.get(name)
        if p is None or p.shape != value.shape:
            raise ProgramError(f"the model has no parameter {name} of shape "
                               f"{tuple(value.shape)}")
        p.copy_(value)
        drawn.add(name)
    if drawn != set(params):
        raise ProgramError(f"parameters the benchmark does not draw: "
                           f"{sorted(set(params) - drawn)}")
