"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` is compiled for Hopper (``sm_90a``) into its own
shared library with a plain C interface; the sources share the building
blocks of ``csrc/*.cuh``.  The libraries land in ``src/repro_torch/_build/``
(listed in ``.gitignore``) under a name that carries a digest of the
source, the headers and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  :func:`build_all` starts one
``nvcc`` per missing library, all at once, and waits for them
(:func:`start_build` returns without waiting).  Nothing is
compiled at import time: the first :func:`load` builds.

Each source also has a *checked* variant (``checked=True``): the same
code compiled with ``-DREPRO_CHECKED -lineinfo``, so that the events of
``csrc/check.cuh`` are logged on the card, and a library of faulty toy
kernels (``csrc/check_toys.cu``) besides.  Inside :func:`checked_kernels`
every :func:`load` returns the checked library, whose launchers record
each call's log (:class:`CheckedRun`) for ``repro_torch.analysis``; the
wrappers' calling code is the same in both variants.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("segment_spmm.cu", "segment_spmm_tc.cu", "segment_spgemm.cu",
           "segment_spgemm_tc.cu", "flash_attention.cu", "moe_gemm.cu",
           "rg_lru.cu", "flash_attention_bwd.cu", "rg_lru_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: what the checked variant adds to :data:`NVCC_FLAGS`
CHECKED_FLAGS = ("-DREPRO_CHECKED", "-lineinfo")
#: the sources whose kernels log events (every one), and the toys
CHECKED_SOURCES = SOURCES + ("check_toys.cu",)
#: records the shared device log holds (96 bytes each)
LOG_CAPACITY = 1 << 19

_loaded: Dict[tuple, ctypes.CDLL] = {}
_run: Optional["CheckedRun"] = None


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


def flags(checked: bool = False) -> tuple:
    """The ``nvcc`` flags of the release or the checked variant."""
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else ())


def library_path(source: str, checked: bool = False) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(
        src + " ".join(flags(checked)).encode()).hexdigest()[:12]
    tag = "-checked" if checked else ""
    return BUILD_DIR / f"{Path(source).stem}{tag}-{digest}.so"


def nvcc_command(source, out, checked: bool = False) -> list:
    """The ``nvcc`` command that builds ``source`` (a path; a copy outside
    ``csrc/`` finds the headers there too) into the library ``out``."""
    return [nvcc_path(), *flags(checked), "-I", str(CSRC_DIR), "-o",
            str(out), str(source)]


class BuildJob:
    """``nvcc`` runs started together (:func:`start_build`); :meth:`wait`
    collects them."""

    def __init__(self, jobs, nice: int = 0):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.libs = {key: library_path(s, c) for key, s, c in jobs}
        self.t0 = time.perf_counter()
        #: wall seconds from the start to each library's build ending
        self.seconds: Dict[str, float] = {}
        self._running = []
        for key, source, chk in jobs:
            lib = self.libs[key]
            if lib.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            # the compiler's output goes to the log as it comes, so the
            # runs can be polled without a pipe filling up
            log = open(str(lib) + ".log", "w")
            proc = subprocess.Popen(
                nvcc_command(CSRC_DIR / source, tmp, checked=chk),
                stdout=log, stderr=subprocess.STDOUT, text=True,
                preexec_fn=(lambda: os.nice(nice)) if nice else None)
            # a thread a run notes when it ends, waited on or not
            waiter = threading.Thread(target=self._note_end,
                                      args=(key, proc), daemon=True)
            waiter.start()
            self._running.append((key, lib, tmp, proc, log, waiter))
        self._started = len(self._running)

    def _note_end(self, key: str, proc) -> None:
        proc.wait()
        self.seconds[key] = time.perf_counter() - self.t0

    def running(self) -> int:
        """The runs not ended yet."""
        return self._started - len(self.seconds)

    def wait(self) -> Dict[str, Path]:
        """The libraries, once every run has ended.  Raises
        ``RuntimeError`` with the compiler's output when a build
        failed."""
        for job in self._running:
            job[5].join()
        failures = []
        for key, lib, tmp, proc, log, _ in self._running:
            log.close()
            if proc.returncode != 0:
                os.unlink(tmp)
                out = Path(str(lib) + ".log").read_text()
                failures.append(
                    f"nvcc failed on {key} ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
        self._running = []
        if failures:
            raise RuntimeError("\n".join(failures))
        return self.libs

    def stop(self) -> None:
        """Ends the runs still going; their libraries are not kept."""
        for key, lib, tmp, proc, log, waiter in self._running:
            if proc.poll() is None:
                proc.kill()
            waiter.join()
            log.close()
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._running = []


def start_build(release: bool = True, checked: bool = False,
                nice: int = 0) -> BuildJob:
    """Start one ``nvcc`` per missing library, all at once: the release
    libraries of :data:`SOURCES`, the checked ones of
    :data:`CHECKED_SOURCES`, or both; ``nice`` lowers their priority (a
    build that runs beside other work).  Keys: the source, and ``"<source>
    checked"`` for a checked library."""
    jobs = [(s, s, False) for s in SOURCES] if release else []
    if checked:
        jobs += [(f"{s} checked", s, True) for s in CHECKED_SOURCES]
    return BuildJob(jobs, nice)


def build_all(checked: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing, all ``nvcc`` runs
    started together (with ``checked``, the checked variants of
    :data:`CHECKED_SOURCES` as well, in the same batch); returns
    ``{source: library path}`` of the release libraries, and
    ``{"<source> checked": path}`` of the checked ones.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``<library>.log``.  Raises ``RuntimeError`` with the compiler's output
    when a build fails."""
    return start_build(checked=checked).wait()


def load(source: str, checked: Optional[bool] = None) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use).  ``checked``
    None takes the variant of the surrounding :func:`checked_kernels`
    (release outside it)."""
    if checked is None:
        checked = _run is not None
    if checked and source not in CHECKED_SOURCES:
        raise RuntimeError(f"{source} has no checked variant: its kernels "
                           f"log no events (CHECKED_SOURCES)")
    if checked and _run is None:
        raise RuntimeError(f"the checked {source} runs only inside "
                           f"checked_kernels()")
    key = (source, bool(checked))
    lib = _loaded.get(key)
    if lib is None:
        path = library_path(source, checked)
        if not path.exists():
            start_build(release=not checked, checked=checked).wait()
        lib = (_CheckedLibrary if checked else ctypes.CDLL)(str(path))
        if checked:
            lib._source = source
        _loaded[key] = lib
    if checked:
        _run.attach(lib)
    return lib


# ---------------------------------------------------------------------------
# the checked variant's runs
# ---------------------------------------------------------------------------


class CheckedCall:
    """What one call of a checked launcher left: its library and function,
    the launches it numbered (``(id, name)``), the log's records as bytes,
    whether the log overflowed, and the caching allocator's blocks as
    ``(address, requested bytes)`` right after the call (the operands'
    extents)."""

    def __init__(self, source, function, launches, records, overflow,
                 blocks, names):
        self.source = source
        self.function = function
        self.launches = launches
        self.records = records
        self.overflow = overflow
        self.blocks = blocks
        self.names = names


class CheckedRun:
    """The device log of one :func:`checked_kernels` block and the calls
    made in it.  Each launcher call is synchronised and its log read and
    emptied before the call returns, so the log holds one call at a
    time."""

    def __init__(self, capacity: int = LOG_CAPACITY):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("checked kernels need a CUDA device: the "
                               "analysis reads their logs from the card")
        self.capacity = capacity
        # header: next, overflow, capacity, pad; then the records
        self.log = torch.zeros(16 + 96 * capacity, dtype=torch.uint8,
                               device="cuda")
        self._reset_header()
        self.calls: List[CheckedCall] = []
        self._attached = set()
        self._next_launch = 0

    def _reset_header(self) -> None:
        import torch
        head = torch.tensor([0, 0, self.capacity, 0], dtype=torch.int32)
        self.log[:16].copy_(head.view(torch.uint8))

    def attach(self, lib) -> None:
        if id(lib) in self._attached:
            return
        fn = ctypes.CDLL.__getattr__(lib, "repro_check_set_log")
        fn.argtypes = [ctypes.c_void_p]
        rc = fn(self.log.data_ptr())
        if rc != 0:
            raise RuntimeError(f"repro_check_set_log failed ({rc}) in "
                               f"{lib._source}")
        self._attached.add(id(lib))
        lib._run = self

    def capture(self, lib, function: str) -> None:
        """Reads and empties the log after one launcher call."""
        import numpy as np
        import torch
        torch.cuda.synchronize()
        launches = lib.check_launches()
        if not launches:
            return
        self._next_launch += len(launches)
        head = self.log[:16].cpu().view(torch.int32).numpy()
        n = min(int(head[0]), self.capacity)
        records = self.log[16:16 + 96 * n].cpu().numpy().tobytes()
        blocks = []
        for seg in torch.cuda.memory_snapshot():
            for b in seg.get("blocks", ()):
                if b.get("state") == "active_allocated":
                    blocks.append((int(b["address"]),
                                   int(b.get("requested_size", b["size"]))))
        self.calls.append(CheckedCall(
            lib._source, function, launches, records, bool(head[1]),
            np.array(blocks, dtype=np.int64).reshape(-1, 2),
            lib.check_names()))
        self._reset_header()


class _LaunchRecord(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char * 56), ("id", ctypes.c_uint),
                ("pad", ctypes.c_uint)]


class _CheckedFunction:
    """A launcher of a checked library: the call, then its log read."""

    def __init__(self, lib, name, fn):
        self._lib, self._name, self._fn = lib, name, fn

    @property
    def argtypes(self):
        return self._fn.argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._fn.argtypes = value

    @property
    def restype(self):
        return self._fn.restype

    @restype.setter
    def restype(self, value):
        self._fn.restype = value

    def __call__(self, *args):
        run = self._lib._run
        if run is None or _run is not run:
            raise RuntimeError(f"checked {self._name} called outside "
                               f"checked_kernels()")
        self._lib.check_reset(run._next_launch)
        out = self._fn(*args)
        run.capture(self._lib, self._name)
        return out


class _CheckedLibrary(ctypes.CDLL):
    """A checked library: every exported function but the ``repro_check_*``
    ones is wrapped in a :class:`_CheckedFunction`."""

    _run = None
    _source = ""

    def __getattr__(self, name):
        if name.startswith("__") or name.startswith("_"):
            raise AttributeError(name)
        fn = ctypes.CDLL.__getattr__(self, name)
        if name.startswith("repro_check_"):
            return fn
        wrapped = _CheckedFunction(self, name, fn)
        setattr(self, name, wrapped)
        return wrapped

    def check_reset(self, base: int) -> None:
        fn = ctypes.CDLL.__getattr__(self, "repro_check_reset")
        fn.argtypes = [ctypes.c_uint]
        fn.restype = None
        fn(base)

    def check_launches(self) -> list:
        fn = ctypes.CDLL.__getattr__(self, "repro_check_launches")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        buf = (_LaunchRecord * 256)()
        n = fn(ctypes.addressof(buf), 256)
        if n > 256:
            raise RuntimeError(f"{self._source}: {n} launches in one call, "
                               f"the table holds 256")
        return [(int(buf[i].id), buf[i].name.decode()) for i in range(n)]

    def check_names(self) -> str:
        fn = ctypes.CDLL.__getattr__(self, "repro_check_names")
        fn.restype = ctypes.c_char_p
        return fn().decode()


@contextlib.contextmanager
def checked_kernels(capacity: int = LOG_CAPACITY) -> Iterator[CheckedRun]:
    """Inside this block every :func:`load` returns the checked library of
    its source, and each launcher call's log lands in the yielded
    :class:`CheckedRun`'s ``calls``.  Raises ``RuntimeError`` without a
    CUDA device (the logs live on the card)."""
    global _run
    if _run is not None:
        raise RuntimeError("checked_kernels() blocks do not nest")
    run = CheckedRun(capacity)
    _run = run
    try:
        yield run
    finally:
        _run = None
        for (source, chk), lib in _loaded.items():
            if chk and getattr(lib, "_run", None) is run:
                fn = ctypes.CDLL.__getattr__(lib, "repro_check_set_log")
                fn.argtypes = [ctypes.c_void_p]
                fn(None)
                lib._run = None
        run._attached.clear()
