"""Synthetic stand-ins for the paper's SuiteSparse evaluation matrices (a
copy of ``repro.sim.matrices``, same generators and same seeding).

The 15 Table-III matrices are replaced by pattern-matched synthetic
generators with the same aspect ratio, density and structural family
(banded/stencil, planar mesh, power-law graph, power network,
LP/combinatorial).  Dimensions are scaled down (default max dim ≈ 2048);
density and pattern statistics are preserved, which is what the dataflow
comparison is sensitive to.  Every substitution is recorded in
``describe()``.

Each matrix is seeded with ``abs(hash((name, seed)))``, which depends on
``PYTHONHASHSEED``: two processes agree only under one fixed hash seed,
exactly as ``repro``'s suite does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.formats import CSR, csr_from_coo


def banded(rng, m, n, density, spread=0.02) -> CSR:
    """Stencil/CFD-like: entries concentrated near the diagonal."""
    nnz = max(1, int(density * m * n))
    rows = rng.integers(0, m, size=nnz)
    # diagonal position + gaussian spread
    diag = rows * (n / m)
    cols = np.clip(np.round(diag + rng.normal(0, max(spread * n, 1.5), size=nnz)), 0, n - 1)
    return csr_from_coo((m, n), rows, cols.astype(np.int64),
                        rng.standard_normal(nnz).astype(np.float32))


def mesh2d(rng, m, n, density) -> CSR:
    """Planar-mesh graph (delaunay-like): ~constant degree, local links."""
    side = int(np.sqrt(m))
    deg = max(2, int(density * n))
    rows, cols = [], []
    for r in range(m):
        x, y = r % side, r // side
        for _ in range(deg):
            dx, dy = rng.integers(-2, 3), rng.integers(-2, 3)
            c = (x + dx) % side + ((y + dy) % side) * side
            if c < n:
                rows.append(r)
                cols.append(c)
    nnz = len(rows)
    return csr_from_coo((m, n), np.asarray(rows), np.asarray(cols),
                        rng.standard_normal(nnz).astype(np.float32))


def powerlaw(rng, m, n, density, alpha=1.8) -> CSR:
    """Scale-free graph (ca-GrQc-like): few very dense rows/cols."""
    target = max(1, int(density * m * n))
    pr = (np.arange(1, m + 1, dtype=np.float64)) ** (-alpha)
    pr /= pr.sum()
    pc = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    pc /= pc.sum()
    seen = set()
    rows, cols = [], []
    # top-up sampling: head pairs collide heavily under Zipf, so draw in
    # rounds until the target nnz is reached (bounded rounds)
    for _ in range(12):
        need = target - len(seen)
        if need <= 0:
            break
        rs = rng.choice(m, size=2 * need, p=pr)
        cs = rng.choice(n, size=2 * need, p=pc)
        for r, c in zip(rs, cs):
            key = int(r) * n + int(c)
            if key not in seen:
                seen.add(key)
                rows.append(int(r))
                cols.append(int(c))
                if len(seen) >= target:
                    break
    perm_r = rng.permutation(m)
    perm_c = rng.permutation(n)
    rows = perm_r[np.asarray(rows)]
    cols = perm_c[np.asarray(cols)]
    return csr_from_coo((m, n), rows, cols,
                        rng.standard_normal(rows.size).astype(np.float32))


def powernet(rng, m, n, density) -> CSR:
    """Power-network-like: banded backbone + a few hub rows."""
    base = banded(rng, m, n, density * 0.8, spread=0.01)
    hub_nnz = max(1, int(density * m * n * 0.2))
    hubs = rng.choice(m, size=max(1, m // 200), replace=False)
    rows = rng.choice(hubs, size=hub_nnz)
    cols = rng.integers(0, n, size=hub_nnz)
    all_rows = np.concatenate([np.repeat(np.arange(m), base.row_lengths()), rows])
    all_cols = np.concatenate([base.indices.astype(np.int64), cols])
    all_vals = np.concatenate([base.data, rng.standard_normal(hub_nnz).astype(np.float32)])
    return csr_from_coo((m, n), all_rows, all_cols, all_vals)


def uniform(rng, m, n, density) -> CSR:
    """LP / combinatorial-like: near-uniform random pattern."""
    nnz = max(1, int(density * m * n))
    flat = rng.choice(m * n, size=min(nnz, m * n), replace=False)
    return csr_from_coo((m, n), flat // n, flat % n,
                        rng.standard_normal(flat.size).astype(np.float32))


def blockrand(rng, m, n, density, blocks=16) -> CSR:
    """Combinatorial block structure (Franz-like): dense-ish random blocks."""
    bm, bn = max(1, m // blocks), max(1, n // blocks)
    n_active = max(1, int(density * blocks * blocks * 6))
    rows, cols = [], []
    for _ in range(n_active):
        br, bc = rng.integers(blocks), rng.integers(blocks)
        cnt = max(1, int(density * m * n / n_active))
        rows.append(br * bm + rng.integers(0, bm, size=cnt))
        cols.append(bc * bn + rng.integers(0, bn, size=cnt))
    rows = np.clip(np.concatenate(rows), 0, m - 1)
    cols = np.clip(np.concatenate(cols), 0, n - 1)
    return csr_from_coo((m, n), rows, cols,
                        rng.standard_normal(rows.size).astype(np.float32))


@dataclasses.dataclass
class MatrixSpec:
    name: str
    m: int
    n: int
    density: float
    family: str
    generator: Callable
    domain: str
    scale: float = 1.0   # linear scale-down vs the original SuiteSparse matrix


# Table III of the paper, with the original (M, N, density) recorded.
_TABLE_III = [
    ("fv1",          9604, 9064, 9.79e-4, "banded",   banded,   "2D/3D problem"),
    ("flowmeter0",   9669, 9669, 7.21e-4, "banded",   banded,   "Model reduction"),
    ("delaunay_n13", 8192, 8192, 7.32e-4, "mesh",     mesh2d,   "Undirected graph"),
    ("ca-GrQc",      5242, 5242, 1.05e-3, "powerlaw", powerlaw, "Undirected graph"),
    ("ca-CondMat",  23133, 23133, 3.49e-4, "powerlaw", powerlaw, "Undirected graph"),
    ("poisson3Da",  13514, 13514, 1.93e-3, "banded",   banded,   "CFD"),
    ("bcspwr06",     1454, 1454, 2.51e-3, "powernet", powernet, "Power network"),
    ("tols4000",     4000, 4000, 5.49e-4, "banded",   banded,   "CFD"),
    ("rdb5000",      5000, 5000, 1.18e-3, "banded",   banded,   "CFD"),
    ("gemat1",       4929, 10595, 8.92e-4, "powernet", powernet, "Power network"),
    ("lp_woodw",     1098, 8418, 4.06e-3, "uniform",  uniform,  "Linear programming"),
    ("pcb3000",      3960, 7732, 1.88e-3, "uniform",  uniform,  "Circuit simulation"),
    ("Franz6",       7576, 3016, 1.99e-3, "block",    blockrand, "Combinatorial"),
    ("Franz8",      16728, 7176, 8.36e-4, "block",    blockrand, "Combinatorial"),
    ("psse1",       14318, 11028, 3.63e-4, "powernet", powernet, "Power network"),
]

# additional matrices referenced by the ablation figures
_ABLATION_EXTRA = [
    ("olm5000", 5000, 5000, 7.9e-4, "banded", banded, "Model reduction"),
]

MAX_DIM = 2048   # scaled-down stand-in size cap (documented deviation)


def suite(scale_cap: int = MAX_DIM, seed: int = 7) -> Dict[str, Tuple[CSR, MatrixSpec]]:
    """Generate the 15-matrix benchmark suite (+ ablation extras).

    When a matrix is scaled below its original dimensions, the *density is
    scaled up* so the mean nonzeros-per-row (the quantity the dataflow
    comparison is sensitive to: B-row lengths, intersection sizes, merge
    widths) is preserved; total nnz then scales linearly with the dimension.
    The harness scales the on-chip cache by the same linear factor so the
    cache-to-working-set ratio matches the original experiment.
    """
    out = {}
    for name, m, n, density, family, gen, domain in _TABLE_III + _ABLATION_EXTRA:
        rng = np.random.default_rng(abs(hash((name, seed))) % (2 ** 31))
        s = min(1.0, scale_cap / max(m, n))
        ms, ns = max(128, int(m * s)), max(128, int(n * s))
        d_scaled = min(density * (n / ns), 0.5)  # preserve nnz-per-row
        mat = gen(rng, ms, ns, d_scaled)
        out[name] = (mat, MatrixSpec(name, ms, ns, d_scaled, family, gen, domain,
                                     scale=s))
    return out


def describe() -> str:
    lines = ["matrix,orig_M,orig_N,density,family,domain (synthetic stand-ins)"]
    for name, m, n, density, family, _, domain in _TABLE_III:
        lines.append(f"{name},{m},{n},{density:.2e},{family},{domain}")
    return "\n".join(lines)


def synthetic(rng, n: int, density: float) -> CSR:
    """Square uniform synthetic matrix (sensitivity studies, Figs. 12-14)."""
    return uniform(rng, n, n, density)
