"""Continuous-batching serving on the PyTorch port (the counterpart of
``examples/serve_batched.py``, importing only ``repro_torch``):
mixed-length requests stream through per-slot prefill and batched
per-position decode — a finished request frees its slot immediately and the
next queued request takes it.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch granite-3-8b
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu \\
        --backend reference
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.runtime import Engine, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list(REGISTRY))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="cuda (the default) or reference (torch oracles)")
    args = ap.parse_args()

    cfg = reduced_config(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = Engine(model, slots=3, max_len=128, backend=args.backend,
                    device=args.device)
    rng = np.random.default_rng(1)
    # mixed lengths AND mixed budgets: the engine retires each request at
    # its own limit instead of decoding everyone to the group max
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(4, 24)),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(
                        min(4, args.max_new), args.max_new + 1)))
            for _ in range(args.requests)]
    t0 = time.time()
    engine.generate(reqs)
    dt = time.time() - t0
    tok = sum(r.out_tokens.size for r in reqs)
    print(f"{args.arch} (reduced) on {engine.device} ({engine.backend}): "
          f"{len(reqs)} requests, {tok} tokens, {dt:.2f}s → "
          f"{tok/dt:.1f} tok/s (host clock); step shapes "
          f"{engine.compiled_shapes}")
    for i, r in enumerate(reqs):
        print(f"  req{i}: prompt[{len(r.prompt)}] +{r.max_new_tokens} "
              f"→ {r.out_tokens.tolist()}")


if __name__ == "__main__":
    main()
