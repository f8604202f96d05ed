#!/usr/bin/env python
"""Sweep the PyTorch port's plan verifier over a corpus of planner-built
plans (the counterpart of ``scripts/verify_plans.py``, importing only
``repro_torch``).

Builds plans from the ``repro_torch.sim.matrices`` pattern generators (the
structural families the paper benchmarks run) across the planner knob grid
— lanes × unroll × quantize × prefetch × policy, SpMM and SpGEMM, plus the
degenerate shapes the verifier must tolerate (single-block schedules,
empty symbolic C patterns, unpadded ``n_lanes=1``) — and runs
``repro_torch.analysis.verify_plan`` on each.  Any finding is a bug in
either the planner or the verifier; the process exits 1.  The sweep then
autotunes every pattern under the ``"cuda"`` objective
(``repro_torch.tune.autotune_matmul``: the H100's fitted cost models),
pushes each winner through the same full-level verifier and the
shared-memory budget (``check_plan_vmem``, at the card's 232,448-byte
limit), and runs it once against the ``"reference"`` backend on
``--device`` with ``--backend``.

``--json OUT`` also writes a machine-readable findings artifact.
``--fast`` is shorthand for ``--level fast``.

Usage::

    PYTHONPATH=src python scripts/verify_plans_torch.py      # on the card
    PYTHONPATH=src python scripts/verify_plans_torch.py --device cpu \\
        --backend reference [--level fast|full] [--scale 256] [--seed 7] \\
        [--json OUT.json] [-q]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import api, tune
from repro_torch.analysis import check_plan_vmem, verify_plan
from repro_torch.core.formats import BSR
from repro_torch.sim import matrices

BLOCK = (32, 32)

#: (pattern-name, generator) — small dims keep the sweep host-cheap while
#: still exercising banded/power-law/mesh segment structure.
PATTERNS = (
    ("banded", matrices.banded),
    ("mesh2d", matrices.mesh2d),
    ("powerlaw", matrices.powerlaw),
    ("powernet", matrices.powernet),
    ("uniform", matrices.uniform),
    ("blockrand", matrices.blockrand),
)

SPMM_GRID = tuple(
    dict(n_lanes=l, unroll=u, quantize=q, prefetch=p)
    for l in (1, 2, 4) for u in (1, 2)
    for q in (None, "int8", "int8.rowwise")
    for p in (None, "cross_pass"))
SPGEMM_GRID = tuple(
    dict(n_lanes=l, unroll=u, prefetch=p)
    for l in (1, 2) for u in (1, 2) for p in (None, "cross_pass"))
#: the autotuned winners run once at this width against the reference
N_COLS = 256
RUN_RTOL = 1e-5


def _pattern_bsr(gen, rng, dim: int, density: float) -> BSR:
    dense = gen(rng, dim, dim, density).to_dense()
    return BSR.from_dense(dense, BLOCK)


def sweep(level: str, scale: int, seed: int, quiet: bool, device,
          backend, json_out=None) -> int:
    rng = np.random.default_rng(seed)
    records = []
    n_findings = 0
    n_autotuned = 0
    n_bad_runs = 0
    t0 = time.perf_counter()

    def plan(*args, **kw):
        return api.plan_matmul(*args, cache=False, device=device, **kw)

    def check(label: str, p) -> None:
        nonlocal n_findings
        res = verify_plan(p, level=level)
        rec = {"plan": label, "kind": p.kind, "ok": bool(res.ok),
               "checked": len(res.checked),
               "findings": [{"invariant": f.invariant,
                             "message": f.message,
                             "severity": getattr(f, "severity", "error")}
                            for f in res.findings]}
        records.append(rec)
        if not res.ok:
            n_findings += len(res.findings)
            print(f"FAIL {label}:")
            for f in res.findings:
                print(f"  {f}")
        elif not quiet:
            print(f"  ok {label} ({len(res.checked)} invariants)")

    for name, gen in PATTERNS:
        a = _pattern_bsr(gen, rng, scale, 0.05)
        if a.nblocks == 0:
            print(f"  skip {name}: pattern quantizes to zero blocks")
            continue
        for kw in SPMM_GRID:
            label = (f"spmm/{name} lanes={kw['n_lanes']} "
                     f"unroll={kw['unroll']} quant={kw['quantize']} "
                     f"pf={kw['prefetch']}")
            check(label, plan(a, policy="segment", fold_len=4,
                              with_grad=kw["quantize"] is None, **kw))
        b = _pattern_bsr(gen, rng, scale, 0.05)
        if b.nblocks:
            for kw in SPGEMM_GRID:
                label = (f"spgemm/{name} lanes={kw['n_lanes']} "
                         f"unroll={kw['unroll']} pf={kw['prefetch']}")
                check(label, plan(a, b, policy="segment", **kw))

    # random BSR patterns (denser than the structural families)
    for density in (0.25, 0.6):
        a = BSR.random(rng, (scale, scale), BLOCK, density)
        for kw in SPMM_GRID:
            label = (f"spmm/random{density} lanes={kw['n_lanes']} "
                     f"unroll={kw['unroll']} quant={kw['quantize']} "
                     f"pf={kw['prefetch']}")
            check(label, plan(a, policy="segment", **kw))

    # --- degenerate regression cases --------------------------------------
    single = BSR.random(rng, BLOCK, BLOCK, 1.0)
    check("degenerate/single-block", plan(single))
    check("degenerate/single-block-lanes", plan(single, n_lanes=4))
    a = BSR.random(rng, (scale, scale), BLOCK, 0.4)
    check("degenerate/one-lane", plan(a, n_lanes=1))
    gb = scale // BLOCK[0]
    a_lo = BSR(shape=(scale, scale), block_shape=BLOCK,
               brow=np.zeros(1, np.int64), bcol=np.zeros(1, np.int64),
               blocks=np.ones((1,) + BLOCK, np.float32))
    b_hi = BSR(shape=(scale, scale), block_shape=BLOCK,
               brow=np.full(1, gb - 1, np.int64),
               bcol=np.zeros(1, np.int64),
               blocks=np.ones((1,) + BLOCK, np.float32))
    check("degenerate/empty-C", plan(a_lo, b_hi))

    # --- autotuned winners -------------------------------------------------
    # every schedule the search can emit passes the full-level verifier and
    # the shared-memory budget, and runs as the reference computes
    for name, gen in PATTERNS:
        a = _pattern_bsr(gen, rng, scale, 0.05)
        if a.nblocks == 0:
            continue
        res = tune.autotune_matmul(a, n_cols_hint=N_COLS, objective="cuda",
                                   rhs_dtype="float32", cache=False)
        kw = res.plan_kwargs()
        p = plan(a, n_cols_hint=N_COLS, **kw)
        check_plan_vmem(p, bn=kw["bn_hint"], n_cols=N_COLS)
        label = (f"autotuned/{name} obj=cuda policy={kw['policy']} "
                 f"lanes={kw['n_lanes']} unroll={kw['unroll']} "
                 f"fold={kw['fold_len']} pipe={kw['pipeline']} "
                 f"bn={kw['bn_hint']} pf={kw['prefetch']}")
        check(label, p)
        x = torch.from_numpy(rng.standard_normal(
            (a.shape[1], N_COLS)).astype(np.float32)).to(p.lhs_blocks.device)
        got = p(x, backend=backend)
        want = p(x, backend="reference")
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= RUN_RTOL:
            n_bad_runs += 1
            print(f"FAIL {label}: {backend or api.default_backend()} vs "
                  f"reference {err:.3g} > {RUN_RTOL}")
        elif not quiet:
            print(f"  ran {label}: vs reference {err:.2e}")
        n_autotuned += 1

    dt = time.perf_counter() - t0
    failed = n_findings or n_bad_runs
    status = "FAIL" if failed else "OK"
    print(f"{status}: verified {len(records)} plans "
          f"({n_autotuned} autotuned winners, run on {device or 'cuda'}) at "
          f"level={level!r} in {dt:.1f}s (host clock), {n_findings} "
          f"finding(s), {n_bad_runs} wrong run(s)")
    if json_out:
        artifact = {
            "level": level, "scale": scale, "seed": seed,
            "elapsed_s": round(dt, 3),
            "summary": {"n_plans": len(records),
                        "n_autotuned": n_autotuned,
                        "n_findings": n_findings,
                        "n_bad_runs": n_bad_runs,
                        "ok": not failed},
            "plans": records,
        }
        with open(json_out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"wrote {json_out}")
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--level", choices=("fast", "full"), default="full")
    p.add_argument("--fast", action="store_true",
                   help="shorthand for --level fast (skips the full-level "
                        "traffic-agreement recomputation)")
    p.add_argument("--scale", type=int, default=256,
                   help="square matrix dimension for the pattern corpus")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--backend", default=None,
                   help="cuda (the default) or reference")
    p.add_argument("--json", metavar="OUT", default=None,
                   help="write a machine-readable findings artifact here")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print failures and the summary line")
    args = p.parse_args(argv)
    level = "fast" if args.fast else args.level
    return sweep(level, args.scale, args.seed, args.quiet,
                 api.resolve_device(args.device), args.backend,
                 json_out=args.json)


if __name__ == "__main__":
    sys.exit(main())
