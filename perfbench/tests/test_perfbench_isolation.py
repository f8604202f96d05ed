"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""
import ast
import json
import subprocess
import sys

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def imported(path):
    """Top-level names of every module a file imports (absolute imports;
    a relative import stays inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "perfbench" / "reference").rglob("*.py")) + [
            ROOT / "perfbench" / "inputs.py"] + sorted(
            (ROOT / "perfbench" / "counts").rglob("*.py")):
        assert not imported(f) & (FORBIDDEN | PROGRAM | {"perfbench.program"}
                                  ), f
        assert "program" not in {n for n in imported(f)}, f


PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import perfbench.reference.model, perfbench.reference.train
import perfbench.reference.compare, perfbench.counts.flops
ref = sorted({{m.split(".")[0] for m in sys.modules}})
import perfbench.run, perfbench.harness, perfbench.program
from perfbench.harness import Cell
from pathlib import Path
for w in json.loads(Path({bench!r}).read_text())["workloads"]:
    Cell.load(Path({root!r}), w["name"]).driver()
from repro_torch.runtime import Engine, make_train_step
from repro_torch.models import build_model
run = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"reference": ref, "run": run}}))
"""


def test_a_process_that_runs_the_cells_loads_no_jax():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(seen["reference"]) & (FORBIDDEN | PROGRAM)
    assert not set(seen["run"]) & FORBIDDEN
    assert "repro_torch" in seen["run"] and "torch" in seen["run"]
