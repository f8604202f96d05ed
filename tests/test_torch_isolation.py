"""The port stands alone: it imports nothing of JAX or of ``repro``, and its
entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.models, "
            "repro_torch.runtime, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_refuse_to_run_on_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points use it")
    from repro_torch import api
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.formats import BSR
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine
    import numpy as np

    cfg = reduced_config(REGISTRY["granite-3-8b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(build_model(cfg, device="cpu"))
    a = BSR.random(np.random.default_rng(0), (64, 64), (32, 32), 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.plan_matmul(a, 4)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1"], env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode != 0 and "device='cpu'" in run.stderr


def test_engine_rejects_quantize():
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine
    model = build_model(reduced_config(REGISTRY["granite-3-8b"]), device="cpu")
    with pytest.raises(NotImplementedError, match="quantized serving"):
        Engine(model, quantize="int8", device="cpu")
