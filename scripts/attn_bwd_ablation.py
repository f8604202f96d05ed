#!/usr/bin/env python3
"""Where the attention backward's tensor-core path spends its time, by
ablation.

    python3 scripts/attn_bwd_ablation.py [variant,variant,...]

Builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu`` with one
part of the ``tc`` path's work removed, one ``nvcc`` per variant, all at
once, into ``src/repro_torch/_build/ablation/``, and times each on the
hybrid's local block (1 x 4096 tokens, 16 query heads on one KV head, D =
256, window 2048; the stacked call ``flash_mha`` gives the kernel) in bf16
and fp32 (CUDA events around repeated calls).  Variants:

- ``base``: the kernels as shipped, held against the plain version.  For
  it the script also reads the SASS (``cuobjdump -sass``): the highest
  register each ``bwd_tc`` kernel names, beside what ``ptxas`` reports
  (registers a thread at launch, spill bytes), which says whether code
  after ``setmaxnreg.inc`` is allocated above the launch's registers.
- ``loadonly``: the consumers hand every slot and row record back as it
  lands: what is left is the producer's TMA loads, the ring's waits, the
  row sums, the split pre-pass (fp32) and the partials' sum.
- ``nolo``: P and dS enter dV, dK and dQ as one bf16 part, not hi + lo
  (bf16 calls; fp32 calls keep their three).
- ``nodq``: no dQ pass (the dK / dV pass and the row sums alone).
- ``nohold``: the column group's chunks are loaded again for the output
  products instead of staying in the ring.

A variant's results are wrong by design.  Each line gives the worst
relative error against the plain version and, for bf16, the largest
Frobenius error of dq, dk, dv beside that of the one-part-P control
(``flash_attention_bwd_plain(p_dtype=bf16)``) that chip_smoke.py holds the
kernels below.  Needs one CUDA card and ``nvcc``; prints the card's name
and power limit first.
"""
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = ("base", "loadonly", "nolo", "nodq", "nohold")
# the local block: (batch, T, heads, KV heads, D, window)
CASE = (1, 4096, 16, 1, 256, 2048)
# (variant, text of the shipped source, its replacement)
EDITS = {
    "loadonly": [
        ("    float xs[R / 2], ys[R / 2];\n",
         "    {\n"
         "      for (int u = 0; u < kLoads; ++u, ++n) {\n"
         "        mbar_wait(full(n % kSlots), (n / kSlots) & 1);\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(empty(n % kSlots));\n"
         "      }\n"
         "      if (KV) {\n"
         "        mbar_wait(ifull(it & 1), (it >> 1) & 1);\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(iempty(it & 1));\n"
         "      }\n"
         "      continue;\n"
         "    }\n"
         "    float xs[R / 2], ys[R / 2];\n")],
    "nolo": [("NP = PARTS == 1 ? 2 : 3;", "NP = PARTS == 1 ? 1 : 3;"),
             ("{PARTS, KVC::NP,", "{PARTS, PARTS == 1 ? 2 : KVC::NP,")],
    "nodq": [("  return launch_pass<DMAX, PARTS, false>(",
              "  if (n_split > 0) return 0;\n"
              "  return launch_pass<DMAX, PARTS, false>(")],
    "nohold": [("kHold = kSlots >= 4 * NCH;", "kHold = false;")],
}


def source(variant: str, text: str) -> str:
    for part in variant.split("+"):
        for old, new in EDITS.get(part, ()):
            if old not in text:
                raise RuntimeError(f"{part}: the kernel source has changed")
            text = text.replace(old, new)
    return text


def sass_registers(cuobjdump: Path, lib: Path, log: str) -> list:
    """Per ``bwd_tc`` kernel of a built library: (its template arguments,
    the highest register its SASS names, ptxas's lines for it)."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    ptxas = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("spill stores" in line or "registers" in line):
            ptxas.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    out = []
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split()[0]
        m = re.search(r"bwd_tcILi(\d+)ELi(\d+)ELb(\d)E", fn)
        if not m:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", chunk)]
        out.append((f"bwd_tc<{m.group(1)}, {m.group(2)}, "
                    f"{'KV' if m.group(3) == '1' else 'Q'}>",
                    max(regs, default=-1), "; ".join(ptxas.get(fn, []))))
    return out


def main():
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else VARIANTS
    if not torch.cuda.is_available():
        sys.exit("attn_bwd_ablation: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    text = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out / f"attn_bwd_{name}.cu"
        cu.write_text(source(name, text))
        procs[name] = subprocess.Popen(
            build.nvcc_command(cu, out / f"attn_bwd_{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-4000:]}")
        logs[name] = log
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    b, t, h, hkv, d, window = CASE
    calls = {}
    for dt in (torch.bfloat16, torch.float32):
        q = (torch.randn(b, t, h, d, generator=gen, device=dev) * 0.5).to(dt)
        k = (torch.randn(b, t, hkv, d, generator=gen, device=dev)
             * 0.5).to(dt)
        v = (torch.randn(b, t, hkv, d, generator=gen, device=dev)
             * 0.5).to(dt)
        qh, kh, vh, kw = ops.stack_heads(q, k, v)
        kw.update(causal=True, window=window)
        out_, stats = fa.flash_attention_plain(qh, kh, vh, out_dtype=dt,
                                               stats=True, **kw)
        dout = torch.randn(out_.shape, generator=gen, device=dev).to(dt)
        args = (qh, kh, vh, out_, dout, stats)
        want = fa.flash_attention_bwd_plain(*args, **kw)
        control = None
        if dt == torch.bfloat16:
            control = max(cs._fro(c, w) for c, w in zip(
                fa.flash_attention_bwd_plain(*args, p_dtype=dt, **kw), want))
        calls[dt] = (args, kw, want, control)
    if "base" in names:
        cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
        for fn, top, line in sass_registers(
                cuobjdump, out / "attn_bwd_base.so", logs["base"]):
            print(f"[sass] {fn:<20} highest register R{top}; ptxas: {line}")
    for name in names:
        lib = fa.bwd_argtypes(ctypes.CDLL(str(out / f"attn_bwd_{name}.so")))
        fa._bwd_lib = lambda lib=lib: lib
        for dt, (args, kw, want, control) in calls.items():
            def call():
                return fa.flash_attention_bwd(*args, path="tc", **kw)
            got = call()
            err = max(cs._rel(g, w)[0] for g, w in zip(got, want))
            fro = max(cs._fro(g, w) for g, w in zip(got, want))
            fro = "" if control is None else (
                f", Frobenius {fro:.2e} vs one-part control {control:.2e}")
            del got
            tol = cs.KERNEL_RTOL if dt == torch.float32 else cs.BF16_RTOL
            if name == "base" and err > tol:
                sys.exit(f"base {dt}: {err:.3g} from the plain version")
            ms = cs.event_ms(call, 5)
            print(f"[ablation] {name:<10} {str(dt)[6:]:<9} {ms:.4f} ms  "
                  f"(vs plain {err:.2e}{fro})", flush=True)


if __name__ == "__main__":
    main()
