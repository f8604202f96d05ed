#!/usr/bin/env python3
"""Where one [zero3] rank's allocator peak goes, on one card.

    python3 scripts/zero3_memory.py

Starts the four gloo ranks of ``chip_smoke.py``'s [zero3] phase on the
card (Phi-3.5-MoE at published widths, ``ZERO3_LAYERS`` layers, fp32, a
(2, 2) data x model mesh, ``expandable_segments``), builds the sharded
model one rank at a time, and runs the phase's two ``Trainer`` steps.
Rank 0 records the allocator's history over the steps
(``torch.cuda.memory``, Python stacks) and prints: the peak above the
bytes held before the steps (the masters and the moments), the blocks
live at that peak summed by the
first three frames of the port that allocated them (``?`` for the
autograd engine's own buffers, which have no Python frame), and the
allocations just before it.  Needs one card; prints nothing else.
"""
import collections
import datetime
import gc
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def _frames(e, n):
    fr = [f for f in e.get("frames", [])
          if "repro_torch" in f["filename"] or "chip_smoke" in f["filename"]]
    return " <- ".join(f"{os.path.basename(f['filename'])}:{f['line']} "
                       f"{f['name']}" for f in fr[:n]) or "?"


def report(snap, base):
    """Replay the history's allocations and frees; print the peak's live
    blocks by frame and the events just before it."""
    ev = snap["device_traces"][0]
    live, cur, peak, at_peak, peak_i = {}, 0, 0, {}, 0
    for i, e in enumerate(ev):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, at_peak, peak_i = cur, dict(live), i
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    print(f"held before the steps {base / 1e9:.3f} GB; peak {peak / 1e9:.3f}"
          f" GB above it ({(base + peak) / 1e9:.3f} GB) at event {peak_i} "
          f"of {len(ev)}; live at the peak by frame:")
    groups = collections.Counter()
    for e in at_peak.values():
        groups[_frames(e, 3)] += e["size"]
    for k, v in groups.most_common(12):
        print(f"  {v / 1e9:8.3f} GB  {k}")
    print("the allocations before the peak:")
    for e in ev[max(0, peak_i - 12):peak_i + 1]:
        if e["action"] == "alloc":
            print(f"  {e['size'] / 1e6:9.1f} MB  {_frames(e, 1)}")


def rank_main(rank, port):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    cfg = cs.zero3_config()
    mesh = make_mesh(cs.ZERO3_SIZES, ("data", "model"), device="cuda")
    for r in range(WORLD):              # one rank at a time, as [zero3]
        if r == rank:
            model = build_model(cfg, device=dev, mesh=mesh)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    trainer = cs._zero3_trainer(model, cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    if rank == 0:
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
    torch.cuda.reset_peak_memory_stats()
    trainer.run()
    torch.cuda.synchronize()
    if rank == 0:
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        print(f"allocator peak {torch.cuda.max_memory_allocated() / 1e9:.3f}"
              f" GB, reserved at most "
              f"{torch.cuda.max_memory_reserved() / 1e9:.3f} GB")
        report(snap, base)
    dist.barrier()
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        sys.exit("zero3_memory.py needs a CUDA card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               PYTHONHASHSEED="0")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD)]
    rc = 0
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=900)[0]
            if r == 0 or p.returncode:
                print(out, end="")
            rc = rc or p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sys.exit(rc)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
