#!/usr/bin/env python3
"""Where the RG-LRU ``"tile"`` kernel spends its time, by ablation.

    python3 scripts/rg_lru_ablation.py [variant,variant,...]

Builds copies of ``src/repro_torch/csrc/rg_lru.cu`` with one part of the
work removed or one setting changed (``nogate``: the gate function, the
shared-memory reads and writes kept; ``nogatework``: all of the gate
warps' work, each stage released as it lands; ``noscan``: the scan's steps
and stores; ``nostore``: its stores only; ``loadonly`` removes the gate
warps' work and the scan, leaving the producer's loads and the mbarrier
handoffs; ``stplain``: plain output stores instead of streaming ones;
``promo256`` / ``promo0``: 256-byte L2 promotion of every TMA box row, or
none, in place of 256 bytes for rows under 128; ``stages4``: a 4-stage
input ring, so three fp32 blocks an SM; ``gates128``: four gate warps a
block instead of eight; ``a+b`` applies both), one ``nvcc`` per variant,
all at once, into ``src/repro_torch/_build/ablation/``, and times each on
the [ops] cases of ``chip_smoke.py`` (B x T x 4096: 4 x 2048 fp32 and
bf16, 1 x 8192 fp32) at both tile widths (Dt = 16 and 32 channels a
block), as device ms per call (CUDA-graph replays between CUDA events). A
variant that removes work is wrong by design; ``base`` (the kernel as
shipped) and the variants that change a setting are held against the
plain version.  Needs one CUDA card and ``nvcc``.
"""
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = ("base", "nogate", "noscan", "nostore", "loadonly", "stplain",
            "promo256", "promo0", "stages4", "gates128")
CASES = (("fp32 4x2048", 4, 2048, torch.float32),
         ("bf16 4x2048", 4, 2048, torch.bfloat16),
         ("fp32 1x8192", 1, 8192, torch.float32))
# (variant, text of the shipped source, its replacement: every occurrence)
EDITS = {
    "nogate": [("          gate(ncs[j], xv[k][j], av[k][j], gv[k][j], "
                "a[k][j], xb[k][j]);",
                "          a[k][j] = av[k][j] * ncs[j], xb[k][j] = xv[k][j] "
                "* gv[k][j];")],
    "nogatework": [("      for (int k = 0; k < kGroups; ++k)",
                    "      for (int k = 0; k < kGroups * 0; ++k)")],
    "noscan": [("    if (live) {\n      int s0 = 0;",
                "    if (lane < 0) {\n      int s0 = 0;")],
    "nostore": [("          store_stream(o + static_cast<long long>(i * L + "
                 "s0 + j) * D, h);", ""),
                ("        store_stream(o + static_cast<long long>(i * L + s0) "
                 "* D, h);", "")],
    "stplain": [("          store_stream(o + ", "          store_as(o + "),
                ("        store_stream(o + ", "        store_as(o + ")],
    "promo256": [("dt * sizeof(T) < 128 ?", "true ?")],
    "promo0": [("dt * sizeof(T) < 128 ?", "false ?")],
    "stages4": [("constexpr int kStages = 3; ",
                 "constexpr int kStages = 4; ")],
    "gates128": [("constexpr int kGateThreads = 256; ",
                  "constexpr int kGateThreads = 128; ")],
}
EDITS["loadonly"] = EDITS["nogatework"] + EDITS["noscan"]
# the variants that still compute the function, held against the plain
# version like the kernel as shipped
EXACT = ("base", "stplain", "promo256", "promo0", "stages4", "gates128")


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
        sys.exit("rg_lru_ablation: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build
    rl = importlib.import_module("repro_torch.kernels.rg_lru")

    text = (build.CSRC_DIR / "rg_lru.cu").read_text()
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out / f"rg_lru_{name}.cu"
        cu.write_text(source(name, text))
        procs[name] = subprocess.Popen(
            build.nvcc_command(cu, out / f"rg_lru_{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-4000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    d = 4096
    inputs = {}
    for case, b, t, dt in CASES:
        x, ag, xg = (torch.randn(b, t, d, generator=gen, device=dev).to(dt)
                     for _ in range(3))
        ap = torch.randn(d, generator=gen, device=dev)
        h0 = torch.zeros(b, d, device=dev)
        inputs[case] = (x, ag, xg, ap, h0, rl.rg_lru_plain(x, ag, xg, ap, h0))
    for name in names:
        lib = ctypes.CDLL(str(out / f"rg_lru_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru.argtypes = [p] * 7 + [i] * 3 + [ctypes.c_float] + \
            [i] * 5 + [p]
        for case, b, t, dt in CASES:
            x, ag, xg, ap, h0, (po, ph) = inputs[case]
            o, h = torch.empty_like(x), torch.empty(b, d, device=dev)
            code = rl._DTYPE_CODE[dt]
            for width in (16, 32):
                def call():
                    rc = lib.rg_lru(x.data_ptr(), ag.data_ptr(), xg.data_ptr(),
                                    ap.data_ptr(), h0.data_ptr(), o.data_ptr(),
                                    h.data_ptr(), b, t, d, 8.0, code, code,
                                    code, rl._PATH_CODE["tile"], width,
                                    torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")
                call()
                torch.cuda.synchronize()
                err = max(cs._rel(o, po)[0], cs._rel(h, ph)[0])
                tol = cs.KERNEL_RTOL if dt == torch.float32 else cs.BF16_RTOL
                if name in EXACT and err > tol:
                    sys.exit(f"{name} {case} Dt={width}: {err:.3g} from the "
                             f"plain version")
                print(f"[ablation] {name:<11} {case:<12} Dt={width}: "
                      f"{cs.device_ms(call):.4f} ms (vs plain {err:.2e})",
                      flush=True)


if __name__ == "__main__":
    main()
