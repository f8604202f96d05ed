"""The kernel analyzers' entry points: checked runs of the CUDA kernels.

The port's counterpart of ``repro.analysis.jaxpr_lint`` (same file name,
so a reader finds it).  ``repro`` traces its Pallas kernels to jaxprs and
proves them free of DMA and ring hazards over their whole grid.  The
port's kernels are CUDA, with no jaxpr to read, so the analyzers here run
them: :func:`analyze_callable` calls a function with the checked build of
the kernels (``kernels/build.py``'s ``checked_kernels``), decodes each
launch's event log (:mod:`.trace`) and applies every rule of
:data:`ANALYZER_RULES` (:mod:`.ranges`, :mod:`.races`, :mod:`.budget`) and
:data:`ORDER_RULES` (:mod:`.order`) to it.  Dynamic, like ``racecheck``:
clean over the launches run.  :func:`analyze_shipped_kernels` runs every
shipped path (the backward kernels through autograd) at the smallest
shapes that reach it, and
``python -m repro_torch.analysis.jaxpr_lint`` prints the rules and exits 1
on any finding (it needs the card).

:data:`RULES` keeps ``repro``'s syntactic catalog, each entry saying what
covers it here; :data:`LOG_RULES` are the port's own findings about the
log itself.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

RULES: Dict[str, str] = {
    "program-id-in-when":
        "no check: a Pallas interpret-mode hazard (both arms of a "
        "pl.when are evaluated); a CUDA branch runs one arm",
    "dma-start-without-wait":
        "covered by sem-balance: every fill of a ring slot is waited on "
        "by every reader before the CTA ends",
    "read-before-wait":
        "covered by ring-slot-war, per slot and per reader (repro's "
        "ref-base rule has the false negative the slot rule fixes)",
}

#: findings about the log: a full log, a path that logged no event of a
#: kind its kernel has
LOG_RULES: Dict[str, str] = {
    "log-overflow": "the device log filled up: events are missing, so the "
                    "launch is not checked",
    "log-coverage": "a checked path logged no event of a kind its kernels "
                    "have (or no launch at all)",
}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One hazard flagged in a kernel launch."""

    rule: str
    message: str
    kernel: str = "<kernel>"
    severity: str = "error"

    def __str__(self) -> str:
        return f"[{self.rule}] kernel {self.kernel!r}: {self.message}"


class CheckUnavailableError(RuntimeError):
    """The analyzers need a CUDA device: the checked kernels run on it."""


def check_launch(launch, vmem_limit: Optional[int] = None
                 ) -> List[LintFinding]:
    """Every rule over one decoded launch."""
    from .budget import DEFAULT_VMEM_LIMIT_BYTES, check_vmem_budget
    from .order import check_order
    from .races import (check_parallel_races, check_ring_war,
                        check_sem_balance, replay)
    from .ranges import check_ranges

    limit = DEFAULT_VMEM_LIMIT_BYTES if vmem_limit is None else vmem_limit
    findings: List[LintFinding] = []
    if launch.overflow:
        findings.append(LintFinding(
            rule="log-overflow",
            message=("the device log overflowed during this launch's call: "
                     "events are missing"),
            kernel=launch.name))
    hz = replay(launch)
    findings += check_ranges(launch)
    findings += check_parallel_races(launch)
    findings += check_ring_war(launch, hz)
    findings += check_sem_balance(launch, hz)
    findings += check_order(launch, hz)
    findings += check_vmem_budget(launch, limit)
    return findings


def run_checked(fn: Callable, *args, **kwargs):
    """``(fn's result, the decoded launches)`` of one call of ``fn`` with
    the checked kernels.  Raises :class:`CheckUnavailableError` without a
    CUDA device: nothing falls back to the CPU."""
    import torch

    from repro_torch.kernels import build

    from .trace import traces_from_run
    if not torch.cuda.is_available():
        raise CheckUnavailableError(
            "the kernel analyzers run the checked kernels on a CUDA device; "
            "none is available")
    with build.checked_kernels() as run:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
    return out, traces_from_run(run)


def analyze_callable(fn: Callable, *args, label: Optional[str] = None,
                     vmem_limit: Optional[int] = None,
                     **kwargs) -> List[LintFinding]:
    """Run ``fn(*args, **kwargs)`` with the checked kernels and return every
    finding over its launches (their kernel names prefixed with
    ``label``).  Raises :class:`CheckUnavailableError` without a CUDA
    device, and ``ValueError`` when ``fn`` launched no checked kernel
    (nothing was analyzed)."""
    label = label or getattr(fn, "__name__", str(fn))
    _, launches = run_checked(fn, *args, **kwargs)
    if not launches:
        raise ValueError(f"{label!r} launched no checked kernel: nothing to "
                         f"analyze")
    findings: List[LintFinding] = []
    for launch in launches:
        launch.name = f"{label}:{launch.name}"
        findings += check_launch(launch, vmem_limit)
    return findings


# ---------------------------------------------------------------------------
# the shipped paths
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PathReport:
    """One shipped path's checked run: its launches, findings, events by
    kind, and whether its output equals the release kernels' bit for
    bit."""

    label: str
    launches: list
    findings: List[LintFinding]
    events: Dict[str, int]
    equal: Optional[bool]
    max_diff: float


#: the event kinds every path's kernels log
_BASE_KINDS = ("begin", "operand", "gwrite")


def shipped_paths(device=None) -> List[Tuple[str, Callable, Tuple[str, ...]]]:
    """``(label, fn, event kinds)`` of every shipped path at the smallest
    shapes that reach it: the kinds its trace must hold besides
    :data:`_BASE_KINDS`.  ``fn()`` returns the path's output (with the
    backward kernels, the output and every gradient, flattened)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core.formats import BSR
    from repro_torch.kernels.segment_spmm import chunk_offsets, segment_spmm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.rg_lru import rg_lru
    from repro_torch.kernels.segment_spgemm import segment_spgemm

    dev = torch.device(device or "cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    ring = ("issue", "wait", "read", "release", "gread")
    # SpMM: 4 x 16 blocks of 64 at density 0.5 (runs of ~8 items, deeper
    # than every ring); the split path's chunks cut at 3 items so that runs
    # hand partials over through the counters
    a = BSR.random(np.random.default_rng(0), (256, 1024), (64, 64), 0.5)
    paths = []
    for q in (None, "int8", "fp8", "int8.rowwise", "fp8.rowwise"):
        plan = api.plan_matmul(a, 64, with_grad=True, quantize=q,
                               cache=False, device=dev)
        for trans in (False, True):
            sched = plan.grad_plan if trans else plan
            k = (256 if trans else 1024)
            for path, n, bdt in (("tc", 64, torch.bfloat16),
                                 ("split", 12, torch.bfloat16),
                                 ("simt", 40, torch.float32)):
                b = rand(k, n, dtype=bdt)
                chunks = sched.chunk_offsets
                if path == "split":
                    chunks = torch.as_tensor(chunk_offsets(
                        sched.run_offsets.cpu().numpy(), 3), device=dev)

                def call(sched=sched, b=b, path=path, trans=trans,
                         chunks=chunks, plan=plan):
                    return segment_spmm(
                        plan.lhs_blocks, sched.slot_idx, sched.m_idx,
                        sched.k_idx, sched.seg_start, sched.seg_write,
                        sched.accum_prev, sched.valid, b,
                        grid_m=sched.grid_m, n_lanes=sched.n_lanes,
                        transpose_lhs=trans, a_scales=plan.lhs_scales,
                        runs=sched.run_offsets, chunks=chunks, path=path)
                kinds = ring + (("counter",) if path == "split" else ())
                label = (f"spmm-{path}-{'dx' if trans else 'fwd'}-"
                         f"{q or 'fp32'}")
                paths.append((label, call, kinds))
    pf = api.plan_matmul(a, 64, prefetch="cross_pass", cache=False,
                         device=dev)
    xb = rand(1024, 64, dtype=torch.bfloat16)
    paths.append(("spmm-cross_pass", lambda: api.execute_plan(pf, xb),
                  ring))
    # SpGEMM: A 256 x 512 @ B 512 x 256 at 64 x 64 blocks (tc) and 32 x 32
    # (simt), each fp32 and quantized
    for bs, path in ((64, "tc"), (32, "simt")):
        ga = BSR.random(np.random.default_rng(1), (256, 512), (bs, bs), 0.5)
        gb = BSR.random(np.random.default_rng(2), (512, 256), (bs, bs), 0.5)
        for q in (None, "int8", "fp8", "int8.rowwise"):
            gp = api.plan_matmul(ga, gb, quantize=q, cache=False, device=dev)

            def gcall(gp=gp, path=path):
                return segment_spgemm(
                    gp.lhs_blocks, gp.rhs_blocks, gp.a_idx, gp.b_idx,
                    gp.c_idx, gp.seg_start, gp.seg_write, gp.accum_prev,
                    gp.valid, n_c_blocks=gp.n_out_blocks,
                    n_lanes=gp.n_lanes, a_scales=gp.lhs_scales,
                    b_scales=gp.rhs_scales, runs=gp.run_offsets,
                    work=(gp.tc_runs, gp.tc_steps), path=path)
            kinds = ring + (("counter",) if path == "tc" else ())
            paths.append((f"spgemm-{path}-{q or 'fp32'}", gcall, kinds))
    # attention: 2 (batch, head) rows of 256 queries over 256 keys, D 64;
    # windowed with 4 query heads a KV head (GQA stacked on the q axis)
    q1, k1, v1 = (rand(2, 256, 64) for _ in range(3))
    qg = rand(2, 4 * 64, 64)
    kg, vg = rand(2, 256, 64), rand(2, 256, 64)
    for path in ("splitkv", "tc", "simt"):
        # tc reads q, k and v through tensor maps only
        kinds = {"splitkv": ring + ("counter",),
                 "tc": ("issue", "wait", "read", "release", "box"),
                 "simt": ring}[path]
        qq = q1[:, :16] if path == "splitkv" else q1
        paths.append((f"attn-{path}-causal",
                       lambda qq=qq, path=path: flash_attention(
                           qq, k1, v1, causal=True, path=path), kinds))
        paths.append((f"attn-{path}-window-gqa",
                       lambda path=path: flash_attention(
                           qg if path != "splitkv" else qg[:, :64], kg, vg,
                           causal=True, window=96, q_period=64, bq=64,
                           path=path), kinds))
    # MoE: 4 experts, chunks of 128 rows (some dead), d 64 -> 128
    xs = rand(4 * 128, 64, dtype=torch.bfloat16)
    w = rand(4, 64, 128, dtype=torch.bfloat16)
    ce = torch.arange(4, dtype=torch.int32, device=dev)
    live = torch.tensor([128, 70, 0, 5], dtype=torch.int32, device=dev)
    paths.append(("moe-tc", lambda: moe_gemm(xs, w, ce, live_rows=live),
                  ring + ("box",)))
    paths.append(("moe-simt", lambda: moe_gemm(
        xs.float(), w.float(), ce, live_rows=live), ("gread",)))
    # RG-LRU: 2 rows of 256 steps over 64 channels (tile), 2 x 5 (simt)
    xt, ag, xg = (rand(2, 256, 64) for _ in range(3))
    ap, h0 = rand(64), rand(2, 64)
    paths.append(("rg_lru-tile", lambda: rg_lru(xt, ag, xg, ap, h0,
                                                path="tile")[0],
                  ring + ("box",)))
    paths.append(("rg_lru-simt", lambda: rg_lru(xt[:, :5], ag[:, :5],
                                                xg[:, :5], ap, h0,
                                                path="simt")[0], ("gread",)))

    # the backward kernels, through autograd (the forward writes its row
    # statistics, then the backward runs): each path returns the output
    # and every gradient, flattened
    def grads(fn, inputs, dy):
        def call():
            xs_ = [t.clone().requires_grad_() for t in inputs]
            out = fn(*xs_)
            out.backward(dy)
            return torch.cat([out.detach().reshape(-1)]
                             + [t.grad.reshape(-1) for t in xs_])
        return call

    for d, kw, tag in ((64, dict(window=96, q_period=64, bq=64), "tc"),
                       (40, {}, "simt")):
        qkv = [rand(2, 128, d) for _ in range(3)]
        paths.append((f"attn-grad-{tag}", grads(
            lambda q, k, v, kw=kw: flash_attention(q, k, v, causal=True,
                                                   **kw),
            qkv, rand(2, 128, d)),
            ("issue", "wait", "read", "release", "gread")
            + (("box",) if tag == "tc" else ())))
    for d, tag in ((64, "tile"), (30, "simt")):
        ins = [rand(2, 256, d) for _ in range(3)] + [rand(d), rand(2, d)]
        paths.append((f"rg_lru-grad-{tag}", grads(
            lambda x, a, g, p, h: rg_lru(x, a, g, p, h)[0], ins,
            rand(2, 256, d)),
            ("gread",) + (("issue", "wait", "read", "release", "box")
                          if tag == "tile" else ())))
    return paths


def analyze_paths(paths, vmem_limit: Optional[int] = None,
                  compare: bool = True,
                  verbose: bool = False) -> List[PathReport]:
    """Each path checked: its launches, every finding (a path with no
    launch, or with no event of a kind it lists, adds a ``log-coverage``
    finding) and, with ``compare``, its output against a release run on
    the same inputs."""
    import torch
    reports = []
    for label, fn, kinds in paths:
        want = fn() if compare else None
        got, launches = run_checked(fn)
        findings: List[LintFinding] = []
        events: Dict[str, int] = {}
        for launch in launches:
            launch.name = f"{label}:{launch.name}"
            findings += check_launch(launch, vmem_limit)
            for k, n in launch.kind_counts().items():
                events[k] = events.get(k, 0) + n
        missing = [k for k in _BASE_KINDS + tuple(kinds) if not events.get(k)]
        if not launches or missing:
            findings.append(LintFinding(
                rule="log-coverage",
                message=(f"{len(launches)} launch(es); no event of kind(s) "
                         f"{missing}"),
                kernel=label))
        equal, diff = None, 0.0
        if compare:
            equal = bool(torch.equal(got, want))
            diff = float((got.float() - want.float()).abs().max()) \
                if got.numel() else 0.0
        reports.append(PathReport(label, launches, findings, events, equal,
                                  diff))
        if verbose:
            state = f"{len(findings)} finding(s)" if findings else "clean"
            print(f"  {label}: {len(launches)} launch(es), events "
                  f"{dict(sorted(events.items()))}, {state}"
                  + ("" if equal is None else f", release equal {equal}"))
    return reports


def analyze_shipped_kernels(verbose: bool = False) -> List[LintFinding]:
    """Every finding over :func:`shipped_paths` (checked outputs that
    differ from the release kernels' are reported by
    :func:`analyze_paths`, not here)."""
    reports = analyze_paths(shipped_paths(), compare=False, verbose=verbose)
    return [f for r in reports for f in r.findings]


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    verbose = "-q" not in argv
    from .order import ORDER_RULES
    from .races import ANALYZER_RULES
    rules = {**ANALYZER_RULES, **ORDER_RULES, **LOG_RULES}
    print(f"analyzing the shipped CUDA kernels' checked build "
          f"({len(rules)} rules: {', '.join(sorted(rules))})")
    for name, text in sorted({**RULES, **rules}.items()):
        print(f"  {name}: {text}")
    findings = analyze_shipped_kernels(verbose=verbose)
    if findings:
        print(f"FAIL: {len(findings)} hazard(s)")
        for f in findings:
            print(f"  {f}")
        return 1
    print("OK: every shipped path analyzes clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
