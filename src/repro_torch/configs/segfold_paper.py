"""The paper's own hardware configuration (Table II) as a config object,
used by the simulator (a copy of ``repro.configs.segfold_paper``; not a
model, so not in ``REGISTRY``)."""
from repro_torch.sim.segfold_sim import SegFoldConfig

PAPER_HW = SegFoldConfig()           # 16×16 PEs, W=32, 4-wide multicast,
                                     # 1.5 MiB cache, HBM2 @ 256 B/cycle
