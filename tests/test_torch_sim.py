"""The port's SegFold simulator, baselines and matrix suite against
``repro``'s, exactly (``dataclasses.asdict`` of every result equal): every
schedule mode and mapping, each mechanism ablation, each accelerator of
``ACCELERATORS`` and ``flexagon_best``, over every matrix of the scale-256
suite and the 512 x 512 banded case of ``tests/test_sim.py``; ``PAPER_HW``;
and ``examples/spgemm_suite_torch.py`` line for line against
``examples/spgemm_suite.py`` under one ``PYTHONHASHSEED``.

The suite seeds each matrix from ``hash((name, seed))``, which changes with
the hash seed, so both packages' suites are built in one process."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.segfold_paper import PAPER_HW as JAX_PAPER_HW  # noqa: E402
from repro.sim import ACCELERATORS as JAX_ACCELERATORS  # noqa: E402
from repro.sim import matrices as jmatrices  # noqa: E402
from repro.sim import segfold_sim as jsim  # noqa: E402
from repro.sim.baselines import flexagon_best as jflexagon_best  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.segfold_paper import PAPER_HW  # noqa: E402
from repro_torch.sim import ACCELERATORS, matrices  # noqa: E402
from repro_torch.sim import segfold_sim as sim  # noqa: E402
from repro_torch.sim.baselines import flexagon_best  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALE_CAP = 256

#: every schedule mode x mapping, then each mechanism switched off in turn
CONFIGS = [dict(schedule_mode=m, mapping=p)
           for m in ("selecta", "static_rr", "static_kmajor")
           for p in ("zero", "lut", "ideal")] + [
    {f: False} for f in ("dynamic_k", "spatial_folding",
                         "segmentbc_enabled", "vector_injection")]


@pytest.fixture(scope="module")
def suites():
    """Both packages' suites, built in this process (one hash seed), and
    the banded case of ``tests/test_sim.py``."""
    got = matrices.suite(scale_cap=SCALE_CAP)
    want = jmatrices.suite(scale_cap=SCALE_CAP)
    got["banded512"] = (matrices.banded(np.random.default_rng(0), 512, 512,
                                        0.02), None)
    want["banded512"] = (jmatrices.banded(np.random.default_rng(0), 512, 512,
                                          0.02), None)
    return got, want


def _asdict_equal(got, want, where):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys(), where
    for k in w:
        assert type(g[k]) is type(w[k]) and g[k] == w[k], (where, k, g[k],
                                                             w[k])


NAMES = [n for n, *_ in jmatrices._TABLE_III + jmatrices._ABLATION_EXTRA] + [
    "banded512"]


@pytest.mark.parametrize("name", NAMES)
def test_simulator_and_baselines_match_repro(suites, name):
    (a, spec), (ja, jspec) = suites[0][name], suites[1][name]
    assert (a.shape, a.nnz) == (ja.shape, ja.nnz)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))
    if spec is not None:
        gs, ws = dataclasses.asdict(spec), dataclasses.asdict(jspec)
        assert gs.pop("generator").__name__ == ws.pop("generator").__name__
        assert gs == ws
    b, jb = a.transpose(), ja.transpose()
    cache = 256 * 1024
    for kw in CONFIGS:
        got = sim.simulate_segfold(a, b, sim.SegFoldConfig(cache_bytes=cache,
                                                           **kw))
        want = jsim.simulate_segfold(
            ja, jb, jsim.SegFoldConfig(cache_bytes=cache, **kw))
        _asdict_equal(got, want, (name, kw))
        assert got.cycles_per_mac == want.cycles_per_mac
    cfg = sim.SegFoldConfig(cache_bytes=cache)
    jcfg = jsim.SegFoldConfig(cache_bytes=cache)
    assert list(ACCELERATORS) == list(JAX_ACCELERATORS)
    for acc, fn in ACCELERATORS.items():
        _asdict_equal(fn(a, b, cfg), JAX_ACCELERATORS[acc](ja, jb, jcfg),
                      (name, acc))
    got, want = flexagon_best(a, b, cfg), jflexagon_best(ja, jb, jcfg)
    _asdict_equal(got.pop("result"), want.pop("result"), (name, "best"))
    assert got == want


def test_estimate_n_tiles_and_wave_engine_match_repro(suites):
    a, ja = suites[0]["ca-GrQc"][0], suites[1]["ca-GrQc"][0]
    b, jb = a.transpose(), ja.transpose()
    for kw in (dict(), dict(pe_cols=4), dict(pe_cols=64)):
        assert sim.estimate_n_tiles(a, b, sim.SegFoldConfig(**kw)) == \
            jsim.estimate_n_tiles(ja, jb, jsim.SegFoldConfig(**kw))
    eng = sim._WaveEngine(b, sim.SegFoldConfig(), n_tiles=2)
    jeng = jsim._WaveEngine(jb, jsim.SegFoldConfig(), n_tiles=2)
    batch = [(0, int(k)) for k in a.row(0)[0]] + [(1, 3)]
    assert eng.wave(batch) == jeng.wave(batch)
    _asdict_equal(eng.finish(merge_pass=True), jeng.finish(merge_pass=True),
                  "engine")
    with pytest.raises(ValueError):
        sim.simulate_segfold(a, b, sim.SegFoldConfig(schedule_mode="rr"))


def test_paper_hw_matches_repro_and_stays_out_of_the_registry():
    assert dataclasses.asdict(PAPER_HW) == dataclasses.asdict(JAX_PAPER_HW)
    assert PAPER_HW.r_max == JAX_PAPER_HW.r_max == 16
    assert all(not isinstance(c, sim.SegFoldConfig)
               for c in REGISTRY.values())
    assert matrices.describe() == jmatrices.describe()


def _run(code, hash_seed):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED=str(hash_seed), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return run.stdout.splitlines()


@pytest.mark.parametrize("hash_seed", [0, 1])
def test_suite_example_prints_repro_lines(hash_seed):
    """The port's example against ``repro``'s, both at scale cap 256 under
    one hash seed: the same rows and geomeans, line for line.  Both
    examples fix their scale cap, so each one's suite is wrapped to take
    ours."""
    def run_example(package, example, check=""):
        return _run(
            f"import sys, runpy, {package}.sim.matrices as m\n"
            "suite = m.suite\n"
            f"m.suite = lambda scale_cap=None, **kw: suite({SCALE_CAP}, "
            "**kw)\n"
            f"runpy.run_path('examples/{example}', run_name='__main__')\n"
            + check, hash_seed)

    want = run_example("repro", "spgemm_suite.py")
    got = run_example(
        "repro_torch", "spgemm_suite_torch.py",
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes')]\n")
    assert len(want) == 17 and want[-1].startswith("geomean:")
    assert got == want
