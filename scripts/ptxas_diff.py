"""Hold the release build's kernels to another tree's: registers, shared
memory, stack and spills of every kernel, as ``nvcc -Xptxas -v`` reports
them.

    python3 scripts/ptxas_diff.py --base <dir of another checkout>

builds every source of ``kernels/build.py``'s ``SOURCES`` from both trees
with the release flags, all ``nvcc`` runs at once, and prints one line per
kernel whose numbers differ (the unnamed namespace's hash is stripped from
the names).  Exits 1 when any kernel differs or is missing from one side.
Needs ``nvcc`` (the card's machine).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

_ANON = re.compile(r"_GLOBAL__N__[0-9A-Za-z_]*?_(?=\d)")


def ptxas_numbers(log: str) -> dict:
    """``{kernel: "used ... | stack ..."}`` from ``-Xptxas -v`` output."""
    out, name, props = {}, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _ANON.sub("", m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props["fn"] = _ANON.sub("", m.group(1))
            continue
        if "stack frame" in line and props.get("fn"):
            props[props.pop("fn")] = line.strip()
            continue
        if "Used " in line and name:
            out[name] = line.split("Used ", 1)[1].strip()
            name = None
    return {k: f"{v} | {props.get(k, '')}" for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    base_csrc = Path(args.base) / "src" / "repro_torch" / "csrc"
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        # both trees' builds at once: the machine's cores take them
        mine_p = [(src, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-o", str(Path(d1) / (Path(src).stem + ".so")),
             str(build.CSRC_DIR / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for src in build.SOURCES]
        base_p = [(src, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(base_csrc),
             "-o", str(Path(d2) / (Path(src).stem + ".so")),
             str(base_csrc / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for src in build.SOURCES]
        mine = {s: p.communicate()[0] for s, p in mine_p}
        base = {s: p.communicate()[0] for s, p in base_p}
        failed = [s for s, p in mine_p + base_p if p.returncode != 0]
    if failed:
        print(f"[ptxas] build failed: {failed}")
        for s in failed:
            print(mine.get(s, "")[-2000:], base.get(s, "")[-2000:])
        return 1
    bad = 0
    for src in build.SOURCES:
        a, b = ptxas_numbers(mine[src]), ptxas_numbers(base[src])
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        print(f"[ptxas] {src}: {len(a)} kernels here, {len(b)} in base, "
              f"{len(diff)} differ")
        for k in diff:
            print(f"[ptxas]   {k[:90]}\n[ptxas]     here {a.get(k)}\n"
                  f"[ptxas]     base {b.get(k)}")
        bad += len(diff)
    print(f"[ptxas] {'identical' if not bad else f'{bad} kernel(s) differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
