"""Runs one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

It prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number that decides ``correct``
beside its limit (also the last lines of standard error).  It exits with
another code than 0, printing no result, when the card the cell asks for
is missing, when a file the cell names is missing, or when the JAX package
or JAX itself was loaded.

``--control 1`` (for the control's tests, never in a benchmark run) also
computes the numbers of the reference in float8 put in the program's place;
``--fault <name>`` breaks the timed path (``unchanged``, ``half_batch``,
``token``) to see ``correct`` come out false.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: every build and kernel cache of the program, at fixed paths inside the
#: checkout (the port's nvcc libraries live in ``src/repro_torch/_build``)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "cuda", "PYTORCH_KERNEL_CACHE_PATH": "kernels"}


def _paths() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    _paths()
    from perfbench.harness import forbidden_modules, run_cell

    options = {"control": bool(args.control), "fault": args.fault}
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, options=options)
    loaded = forbidden_modules()
    if loaded:
        print(f"[perfbench] the measured process loaded {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"[perfbench] compared {name} {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
