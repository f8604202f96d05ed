"""Continuous-batching serving from the command line (the port).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --requests 8 --max-new 16            # reduced widths, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # published widths

Weights are random, from ``--seed``.  Runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.runtime import Engine, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list(REGISTRY))
    ap.add_argument("--full", action="store_true",
                    help="serve at the published widths (default: reduced)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--eos", type=int, default=None,
                    help="retire a request early when it emits this token")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    # the repo's own block-sparse FFN switch: the port's serving slice
    cfg = dataclasses.replace(cfg, ffn_block_sparse=True)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine = Engine(model, slots=args.slots, max_len=args.max_len,
                    device=model.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, rng.integers(4, 32),
                                        dtype=np.int32),
                    max_new_tokens=args.max_new, eos_token=args.eos)
            for _ in range(args.requests)]
    t0 = time.time()
    engine.generate(reqs)
    dt = time.time() - t0
    total = sum(r.out_tokens.size for r in reqs)
    print(f"{len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {engine.device} — step shapes: "
          f"{engine.compiled_shapes}")
    for i, r in enumerate(reqs[:4]):
        print(f"req{i}: prompt_len={len(r.prompt)} out={r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
