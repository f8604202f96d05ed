"""The faulty toy kernels of ``csrc/check_toys.cu``, each caught by its rule.

The card's counterpart of the mutation battery of
``tests/test_kernel_analysis.py``: one toy kernel per rule of the
analyzers, and twins that must analyze clean.  :func:`run_toys` runs each
through :func:`.jaxpr_lint.run_checked` and holds the set of rules it
draws against the one it must draw (set equality, as ``repro``'s tests
assert), and the message against the words it must hold.  ``python -m
repro_torch.analysis.toys`` prints one JSON line per toy and exits 1 when
one is not caught as it must be (``chip_smoke.py``'s ``[check]`` runs it in
a child process, so that a toy that brought the CUDA context down could
not take the smoke with it).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

from .budget import DEFAULT_VMEM_LIMIT_BYTES

#: the vmem toy's dynamic shared memory: inside the card's limit, over the
#: lower limit the toy is also checked against
VMEM_TOY_BYTES = 200 * 1024
VMEM_LOW_LIMIT = 100 * 1024


def _toys():
    """``(name, call(lib, dev), rules it must draw, words its message
    holds, vmem limit)``."""
    import ctypes

    import torch

    def f32(n, dev):
        return torch.arange(n, dtype=torch.float32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream(dev):
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    # each call keeps its tensors alive until the launcher returns: the
    # log's operands are resolved against the live allocations then
    def race(lib, dev):
        x, o = f32(64, dev), f32(32, dev)
        return lib.check_toy_race(ptr(x), ptr(o), 32, stream(dev))

    def handoff(use):
        def call(lib, dev):
            x, w, o = f32(64, dev), f32(64, dev), f32(32, dev)
            ctr = torch.zeros(1, dtype=torch.int32, device=dev)
            return lib.check_toy_handoff(ptr(x), ptr(w), ptr(ctr), ptr(o), 32,
                                         use, stream(dev))
        return call

    def oob(lib, dev):
        x, o = f32(24, dev), f32(32, dev)
        return lib.check_toy_oob(ptr(x), ptr(o), stream(dev))

    def ring(read_next):
        def call(lib, dev):
            x, o = f32(16, dev), f32(16, dev)
            return lib.check_toy_ring(ptr(x), ptr(o), 2, read_next,
                                      stream(dev))
        return call

    def sem(lib, dev):
        x, o = f32(32, dev), f32(32, dev)
        return lib.check_toy_sem(ptr(x), ptr(o), 4, stream(dev))

    def vmem(lib, dev):
        x, o = f32(128, dev), f32(128, dev)
        return lib.check_toy_vmem(ptr(x), ptr(o), 128, VMEM_TOY_BYTES,
                                  stream(dev))

    return [
        ("race", race, {"parallel-race"}, ("written by CTAs",), None),
        ("handoff", handoff(1), set(), (), None),
        ("handoff-no-counter", handoff(0), {"parallel-race"},
         ("no counter hand-off",), None),
        ("oob", oob, {"index-range"}, ("[24, 32)", "24 elements"), None),
        ("ring-off-by-one", ring(1), {"ring-slot-war"}, ("in flight",), None),
        ("ring-correct", ring(0), set(), (), None),
        ("one-branch-wait", sem, {"sem-balance"}, ("never waited",), None),
        ("vmem-default-limit", vmem, set(), (), DEFAULT_VMEM_LIMIT_BYTES),
        ("vmem-hog", vmem, {"vmem-budget"}, ("exceeds",), VMEM_LOW_LIMIT),
    ]


def run_toys(names: Optional[List[str]] = None) -> List[Dict]:
    """Each toy's result: its rules, whether they are the ones it must
    draw and its message holds the words, and its event counts."""
    import torch

    from repro_torch.kernels import build

    from .jaxpr_lint import check_launch, run_checked

    dev = torch.device("cuda", 0)
    out = []
    for name, call, want, words, limit in _toys():
        if names and name not in names:
            continue

        def run():
            rc = call(build.load("check_toys.cu"), dev)
            if rc != 0:
                raise RuntimeError(f"toy {name}: launch failed ({rc})")

        _, launches = run_checked(run)
        findings = [f for launch in launches
                    for f in check_launch(launch, limit)]
        rules = {f.rule for f in findings}
        text = " ".join(f.message for f in findings)
        events: Dict[str, int] = {}
        for launch in launches:
            for k, n in launch.kind_counts().items():
                events[k] = events.get(k, 0) + n
        ok = (bool(launches) and rules == want
              and all(w in text for w in words))
        out.append({"toy": name, "ok": ok, "want": sorted(want),
                    "rules": sorted(rules), "launches": len(launches),
                    "events": events,
                    "messages": [str(f) for f in findings][:3]})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    results = run_toys(argv or None)
    for r in results:
        print(json.dumps(r))
    return 0 if results and all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
