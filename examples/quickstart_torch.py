"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``, importing only ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --backend reference

1. element-granularity Segment dataflow (paper Alg. 1 + §III-B) on a small
   sparse product — the faithful reference;
2. the block-level Segment plan on the port's kernels (``--backend``; on
   the card the CUDA kernels by default), each policy's traffic, and the
   plan the tuner picks (``policy="auto"``);
3. cycle-approximate simulator: SegFold vs Spada-like vs best-static.
"""
import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.formats import BSR, CSC, random_csr
from repro_torch.core.segmentbc import segment_spgemm_elementwise
from repro_torch.core.selecta import run_selecta, selecta_stats
from repro_torch.sim import matrices
from repro_torch.sim.baselines import flexagon_best, spada
from repro_torch.sim.segfold_sim import SegFoldConfig, simulate_segfold

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
ap.add_argument("--backend", default=None,
                help="cuda (the default) or reference (torch oracles)")
args = ap.parse_args()
dev = api.resolve_device(args.device)
rng = np.random.default_rng(0)

# --- 1. the dataflow itself -------------------------------------------------
a = random_csr(rng, (96, 128), 0.08)
b = random_csr(rng, (128, 80), 0.08)
c, telemetry = segment_spgemm_elementwise(CSC.from_csr(a), b, mapping="lut")
assert np.allclose(c, a.to_dense() @ b.to_dense(), atol=1e-4)
stats = selecta_stats(run_selecta(CSC.from_csr(a)), r_max=16)
print(f"[1] Segment SpGEMM correct | SELECTA occupancy={stats['occupancy']:.2f} "
      f"k-sharing={stats['k_sharing']:.2f} "
      f"mean displacement={telemetry['mean_displacement']:.2f}")

# --- 2. plan -> execute -> compare policies, then let the tuner pick -------
A = BSR.random(rng, (512, 768), (64, 64), 0.25)
x = torch.from_numpy(rng.standard_normal((768, 256)).astype(np.float32)).to(
    dev)
plan = api.plan_matmul(A, x.shape, policy="segment", device=dev)
y = plan(x, backend=args.backend)
y_ref = plan(x, backend="reference")      # torch dense oracle, same plan
want = torch.from_numpy(A.to_dense()).to(dev) @ x
assert torch.allclose(y, want, atol=1e-3) and torch.allclose(y, y_ref,
                                                             atol=1e-3)
traffic = {p: api.plan_matmul(A, x.shape, policy=p, device=dev)
           .traffic["total"] for p in api.available_policies()}
auto = api.plan_matmul(A, x.shape, policy="auto", device=dev)
assert torch.allclose(auto(x, backend=args.backend), want, atol=1e-3)
t = plan.traffic
stats = api.plan_cache_stats()
print(f"[2] Segment-SpMM correct on {dev} "
      f"({args.backend or api.default_backend()}) | traffic "
      f"{t['total']/1e6:.1f} MB (B fetches: {t['b_fetches']}, C segments: "
      f"{t['c_segments']}) | "
      + " ".join(f"{p}={traffic[p]/1e6:.1f}MB" for p in traffic)
      + f" | policy='auto' -> {auto.policy}, lanes {auto.n_lanes}, unroll "
      f"{auto.unroll} (searched {stats['searched']})")

# --- 3. the accelerator simulator ------------------------------------------
m = matrices.banded(rng, 1024, 1024, 0.01)
mt = m.transpose()
cfg = SegFoldConfig(cache_bytes=300 * 1024)
seg = simulate_segfold(m, mt, cfg)
sp = spada(m, mt, cfg)
fb = flexagon_best(m, mt, cfg)
print(f"[3] simulator: SegFold {seg.cycles:.0f} cyc | "
      f"Spada {sp.cycles:.0f} ({sp.cycles/seg.cycles:.2f}x) | "
      f"best static [{fb['config']}] {fb['cycles']:.0f} "
      f"({fb['cycles']/seg.cycles:.2f}x)")
