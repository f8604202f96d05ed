"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` is compiled for Hopper (``sm_90a``) into its own
shared library with a plain C interface; the sources share the building
blocks of ``csrc/*.cuh``.  The libraries land in ``src/repro_torch/_build/``
(listed in ``.gitignore``) under a name that carries a digest of the
source, the headers and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  :func:`build_all` starts one
``nvcc`` per missing library, all at once, and waits for them.  Nothing is
compiled at import time: the first :func:`load` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("segment_spmm.cu", "segment_spmm_tc.cu", "segment_spgemm.cu",
           "segment_spgemm_tc.cu", "flash_attention.cu", "moe_gemm.cu",
           "rg_lru.cu", "flash_attention_bwd.cu", "rg_lru_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def nvcc_command(source, out) -> list:
    """The ``nvcc`` command that builds ``source`` (a path; a copy outside
    ``csrc/`` finds the headers there too) into the library ``out``."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
            str(source)]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all ``nvcc`` runs
    started together; returns ``{source: library path}``.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``<library>.log``.  Raises ``RuntimeError`` with the compiler's output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {s: library_path(s) for s in SOURCES}
    running = []
    for source, lib in libs.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            nvcc_command(CSRC_DIR / source, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failures = []
    for source, lib, tmp, proc in running:
        out, _ = proc.communicate()
        Path(str(lib) + ".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {source} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use)."""
    lib = _loaded.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
