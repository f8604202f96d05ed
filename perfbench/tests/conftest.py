"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the root
of a checkout.  Tests marked ``card`` need a CUDA device and skip without
one (decided in the ``card`` fixture, never at import)."""
import hashlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the cell's own size on the "
        "chip); skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control at the cell's own size "
                    "runs on the chip")
    return torch.device("cuda", 0)


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    """The checkout a later change could make (:mod:`perfbench.tests.toy`),
    checked to leave every file of the benchmark as it was."""
    from perfbench.tests import toy
    before = digest(ROOT / "perfbench")
    root = toy.make_tree(tmp_path_factory.mktemp("checkout"))
    copied = digest(root / "perfbench")
    # every file of the benchmark is there as it was, the toys beside it
    for name, h in before.items():
        if not name.startswith("tests"):
            assert copied[name] == h, name
    assert digest(ROOT / "perfbench") == before
    return root
