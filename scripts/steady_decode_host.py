#!/usr/bin/env python3
"""Host cost of the steady 4-slot granite-3-8b decode step, for comparing
two checkouts of the port on one card.

    python3 scripts/steady_decode_host.py [--src DIR] [--steps 32]

Builds the CUDA sources of ``--src`` (a checkout's ``src`` directory,
default this one's), then granite-3-8b at full width (40 layers, the
block-sparse FFN, random weights from seed 0), and runs ``chip_smoke.py``'s
steady decode (``Engine(slots=4, max_len=256)``, four equal requests, 32
timed steps with every slot live: 120 Segment SpMM launches a step, all
on the split path) and one decode step under ``torch.profiler`` (host
operations a step, device busy time), then the host time of one
``execute_plan`` of layer 0's up projection at the decode width (N = 4,
bf16 B: the split path), over 2000 calls.  Prints one JSON line:
``{"src", "ms_per_step", "host_ops", "device_busy_ms", "wall_ms",
"spmm_per_step", "spmm_call_us"}``.  To compare two trees, run them in
turns in one call (A, B, B, A): the host's noise is larger than the
difference.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("steady_decode_host: no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine, Request

    build.build_all()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              ffn_block_sparse=True, ffn_block=64,
                              ffn_density=0.25, dtype="bfloat16")
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    # warm-up (cuBLAS handles, the allocator), not counted
    Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16)).generate(
        [Request(prompt=rng.integers(0, cfg.vocab, 20), max_new_tokens=2)])
    ms, per_step = cs.steady_decode(model, rng, steps=args.steps)

    from torch.profiler import ProfilerActivity, profile
    engine = Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16))
    for _ in range(4):
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab, 32),
                              max_new_tokens=8))
    engine.admit_pending()
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sum(e.count for e in prof.key_averages())
    busy = cs.device_busy_us(prof) / 1e3

    from repro_torch.api import execute_plan
    plan = model.layers[0].mlp.up.plan
    b = torch.randn(4, cfg.d_model, device=dev).bfloat16().T
    with torch.inference_mode():
        for _ in range(50):
            execute_plan(plan, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            execute_plan(plan, b)
        call_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"src": args.src, "ms_per_step": ms, "host_ops": ops,
                      "device_busy_ms": busy, "wall_ms": wall,
                      "spmm_per_step": per_step[0],
                      "spmm_call_us": call_us}))


if __name__ == "__main__":
    main()
