"""A checkout that a later change could make: the repository's
``BENCHMARK.json`` and ``perfbench/`` copied into a directory, with the
toy configurations, mixes, limits and metric of ``fixtures/`` added as new
files and new entries, nothing already there edited.

The toy cells' limits were set as the real cells' are, from CPU readings
of the toy sizes: above the program's largest over five seeds, below the
float8 control's smallest (``test_perfbench_faults.py``)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIXTURES = Path(__file__).resolve().parent / "fixtures"

#: the toy cells: (name, config, traffic, the real cell whose metrics it
#: reports)
CELLS = (("toy-bsr.train", "toy-bsr", "toy-train",
          "granite-3-8b-bsr.train-2x2048"),
         ("toy-bsr.chat", "toy-bsr", "toy-chat", "phi3.5-moe-8of32.chat-64"),
         ("toy-moe.chat", "toy-moe", "toy-chat", "phi3.5-moe-8of32.chat-64"))

TOY_METRIC = {"name": "steps_per_s.toy", "unit": "1/s", "better": "higher",
              "source": "host_clock", "layer": "toy",
              "moves": "setup_s"}


def make_tree(dest: Path) -> Path:
    """Builds the checkout under ``dest``; returns its root."""
    pb = dest / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "metrics", "limits"):
        for f in (FIXTURES / kind).iterdir():
            target = pb / kind / f.name
            if target.exists():
                raise FileExistsError(f"the fixture {f.name} would edit "
                                      f"{target}")
            shutil.copy(f, target)
    for name in ("toy-bsr", "toy-moe"):
        bench["configs"].append(
            {"name": name, "source": "perfbench/tests/fixtures",
             "file": f"perfbench/configs/{name}.json", "reduced": [],
             "why": "a CPU-sized stand-in"})
    for name, config, traffic, real in CELLS:
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU-sized stand-in"})
        for m in bench["end_to_end"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
        for m in bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    bench["per_layer"].append(dict(TOY_METRIC))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
