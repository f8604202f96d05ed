#!/usr/bin/env python3
"""Where the tensor-core Segment SpGEMM kernel spends its time, by ablation.

    python3 scripts/spgemm_tc_ablation.py [variant,variant,...]

Builds copies of ``src/repro_torch/csrc/segment_spgemm_tc.cu`` with one
part of the consumer's work removed (``nowgmma``: the passes; ``nosplit``:
the bf16 split of both tiles; ``nostore``: the C stores; ``loadonly``: the
consumer releases each tile as it lands, so only the producer's loads and
the row ring remain; ``a+b`` removes both), one ``nvcc`` per variant, all
at once, into ``src/repro_torch/_build/ablation/``, and times each on
``chip_smoke.py``'s W_up @ W_down plans at granite-3-8b's FFN shapes in
fp32, int8 and int8.rowwise (CUDA-graph replays between CUDA events).  A
variant's results are wrong by design; ``base`` is the kernel as shipped
and is held against the plain version.  Needs one CUDA card and ``nvcc``.
"""
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = ("base", "nowgmma", "nosplit", "nostore", "nowgmma+nosplit",
            "loadonly")
# (variant, text of the shipped source, its replacement)
EDITS = {
    "nowgmma": [
        ("      wgmma_fence();\n#pragma unroll\n      for (int ps = 0; "
         "ps < Lay::kPasses; ++ps) {",
         "      for (int x = 0; x < 32; ++x) part[x] = 0.f;\n      if (0)\n"
         "      for (int ps = 0; ps < Lay::kPasses; ++ps) {"),
        ("      wgmma_commit();\n      wgmma_wait0();\n", "")],
    "nosplit": [
        ("      split_tile<PAY, false, Lay::kAParts>(gpipe + slot(sa_slot), "
         "nullptr,\n                                           gpipe, t);",
         ""),
        ("      split_tile<PAY, kRowwise, Lay::kBParts>(\n"
         "          gpipe + slot(sb_slot),\n"
         "          reinterpret_cast<const float*>(gpipe + slot(sb_slot) +\n"
         "                                         Lay::kRawBytes),\n"
         "          gpipe + Lay::kAParts * kTile, t);", "")],
    "nostore": [("    if (fl & kWrite) {", "    if (fl & kWrite && fl < 0) {")],
    "loadonly": [
        ("      pipe_sync(pipe);   // every warp is past the last item's "
         "wgmma\n",
         "      if (t == 0) {\n        mbar_arrive(empty(sa_slot));\n"
         "        mbar_arrive(empty(sb_slot));\n      }\n      continue;\n")],
}


def source(variant: str, text: str) -> str:
    for part in variant.split("+"):
        for old, new in EDITS.get(part, ()):
            if old not in text:
                raise RuntimeError(f"{part}: the kernel source has changed")
            text = text.replace(old, new)
    return text


def main():
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else VARIANTS
    if not torch.cuda.is_available():
        sys.exit("spgemm_tc_ablation: no CUDA device")
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core.formats import BSR
    from repro_torch.kernels import build
    sg = importlib.import_module("repro_torch.kernels.segment_spgemm")

    text = (build.CSRC_DIR / "segment_spgemm_tc.cu").read_text()
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(source(name, text))
        procs[name] = subprocess.Popen(
            build.nvcc_command(cu, out / f"{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-4000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    (a_shape, b_shape, policy) = cs.SPGEMM_CASES["spgemm_up_down"]
    a = BSR.random(np.random.default_rng(cs.SEED), a_shape, (64, 64), 0.25)
    b = BSR.random(np.random.default_rng(cs.SEED + 1), b_shape, (64, 64),
                   0.25)
    plans = {q: api.plan_matmul(a, b, policy=policy, quantize=q, device=dev)
             for q in (None, "int8", "int8.rowwise")}
    plain = {q: cs._spgemm_plain(p) for q, p in plans.items()}
    for name in names:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_spgemm_tc.argtypes = [p] * 8 + [i] * 4 + [p]
        for q, plan in plans.items():
            c = torch.empty((plan.n_out_blocks, 64, 64), device=dev)
            mode = sg.storage_mode(plan.lhs_blocks.dtype,
                                   plan.rhs_blocks.dtype,
                                   None if q is None else plan.lhs_scales.ndim,
                                   None if q is None else plan.rhs_scales.ndim)
            payload = 0 if q is None else 1

            def call():
                counter = torch.zeros(1, dtype=torch.int32, device=dev)
                rc = lib.segment_spgemm_tc(
                    plan.lhs_blocks.data_ptr(), plan.rhs_blocks.data_ptr(),
                    c.data_ptr(),
                    plan.lhs_scales.data_ptr() if q else None,
                    plan.rhs_scales.data_ptr() if q else None,
                    plan.tc_runs.data_ptr(), plan.tc_steps.data_ptr(),
                    counter.data_ptr(), plan.n_runs, payload, mode, 0,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = cs.device_ms(call, 4)
            err = cs._rel(c, plain[q])[0]
            if name == "base" and err > cs.KERNEL_RTOL:
                sys.exit(f"base {q}: {err:.3g} from the plain version")
            print(f"[ablation] {name:<16} {str(q):<13} {ms:.4f} ms  "
                  f"(vs plain {err:.2e})", flush=True)


if __name__ == "__main__":
    main()
