#!/usr/bin/env python3
"""Time the RG-LRU kernel at RecurrentGemma-9B's width on one GPU, so that
two trees can be compared in one run on one card.

    python3 scripts/rg_lru_bench.py [--src DIR] [--label NAME]

Builds ``DIR/src/repro_torch/csrc/rg_lru.cu`` alone (``nvcc`` with the
tree's own flags, into the tree's git-ignored build directory) and times
``rg_lru`` at ``chip_smoke.py``'s [ops] cases (B x T x 4096: 4 x 2048 in
fp32 and bf16, 1 x 8192 fp32, a 4 x 1 decode step with h0) on every path
the tree's wrapper offers (a tree without ``paths_for`` has one kernel),
as device ms per call (``chip_smoke.py``'s CUDA-graph timer), each call
held against the tree's plain version with ``chip_smoke.py``'s tolerances
(1e-5 of the largest value in fp32, 1e-2 for a bf16 output; h_T 1e-5) and,
where a tree has both paths, ``"tile"`` against ``"simt"`` bit for bit.
Prints one ``[rg_lru-bench]`` line a case and path, then the card's name
and power limit. Run it once per tree in turns (A, B, B, A) to compare two
trees.
"""
import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import torch

D_MODEL = 4096                 # RecurrentGemma-9B
CASES = (("fp32 4x2048", 4, 2048, torch.float32),
         ("bf16 4x2048", 4, 2048, torch.bfloat16),
         ("prefill 1x8192", 1, 8192, torch.float32),
         ("decode 4x1", 4, 1, torch.float32))
ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the tree to time (holds src/repro_torch)")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rg_lru_bench: no CUDA device")
    root = Path(args.src).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(ROOT))      # chip_smoke's timer and tolerances
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    build = importlib.import_module("repro_torch.kernels.build")
    rl = importlib.import_module("repro_torch.kernels.rg_lru")
    lib = build.library_path("rg_lru.cu")
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(build.nvcc_command(build.CSRC_DIR / "rg_lru.cu", lib),
                       check=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    bad = 0
    for case, b, t, dt in CASES:
        x, ag, xg = (torch.randn(b, t, D_MODEL, generator=gen,
                                 device=dev).to(dt) for _ in range(3))
        a_param = torch.randn(D_MODEL, generator=gen, device=dev)
        h0 = (torch.randn(b, D_MODEL, generator=gen, device=dev) if t == 1
              else torch.zeros(b, D_MODEL, device=dev))
        po, ph = rl.rg_lru_plain(x, ag, xg, a_param, h0)
        paths = (rl.paths_for(D_MODEL, (dt,) * 3)
                 if hasattr(rl, "paths_for") else (None,))
        outs = {}
        for path in paths:
            kw = {} if path is None else {"path": path}

            def call(kw=kw):
                return rl.rg_lru(x, ag, xg, a_param, h0, ct=min(128, t), **kw)

            out, h_t = outs[path] = call()
            torch.cuda.synchronize()
            err, err_h = cs._rel(out, po)[0], cs._rel(h_t, ph)[0]
            ok = err <= (cs.KERNEL_RTOL if dt == torch.float32
                         else cs.BF16_RTOL) and err_h <= cs.KERNEL_RTOL
            bad += not ok
            print(f"[rg_lru-bench] {label} {case:<15} path={path} ms="
                  f"{cs.device_ms(call):.4f} rel_err out={err:.2e} h_T="
                  f"{err_h:.2e}{'' if ok else ' FAILED'}", flush=True)
        if len(outs) == 2:
            (o1, h1), (o2, h2) = outs.values()
            same = torch.equal(o1, o2) and torch.equal(h1, h2)
            bad += not same
            print(f"[rg_lru-bench] {label} {case:<15} tile vs simt bit for "
                  f"bit: {same}", flush=True)
        del x, ag, xg, po, outs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
