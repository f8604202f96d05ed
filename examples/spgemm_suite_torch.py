"""Scientific-workload demo on the PyTorch port: the paper's matrix suite
through the port's SegFold simulator (the counterpart of
``examples/spgemm_suite.py``, importing only ``repro_torch``).

    PYTHONPATH=src PYTHONHASHSEED=0 python examples/spgemm_suite_torch.py

The suite seeds each matrix from ``hash((name, seed))``, so fix
``PYTHONHASHSEED`` to reproduce a run (and to compare it with
``repro``'s).  The numbers are simulated cycles of the paper's hardware
(``PAPER_HW``, cache scaled with the matrices), not times of any device.
"""
import numpy as np

from repro_torch.sim import matrices
from repro_torch.sim.baselines import flexagon_best, spada
from repro_torch.sim.segfold_sim import SegFoldConfig, simulate_segfold

rows = []
for name, (a, spec) in matrices.suite(scale_cap=1024).items():
    if name == "olm5000":
        continue
    b = a.transpose()
    cfg = SegFoldConfig(cache_bytes=max(int(1.5 * 2**20 * spec.scale), 65536))
    seg = simulate_segfold(a, b, cfg)
    sp = spada(a, b, cfg)
    fb = flexagon_best(a, b, cfg)
    rows.append((name, sp.cycles / seg.cycles, fb["cycles"] / seg.cycles,
                 fb["config"], seg.mean_occupancy))
    print(f"{name:14s} ({spec.family:9s}) vs_spada={rows[-1][1]:5.2f}x "
          f"vs_static={rows[-1][2]:5.2f}x [{fb['config']:4s}] "
          f"PE-occupancy={seg.mean_occupancy:.2f}")
g1 = np.exp(np.mean([np.log(r[1]) for r in rows]))
g2 = np.exp(np.mean([np.log(r[2]) for r in rows]))
print(f"\ngeomean: {g1:.2f}x vs Spada (paper 1.95x), "
      f"{g2:.2f}x vs best static (paper 5.3x)")
