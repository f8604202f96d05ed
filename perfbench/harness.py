"""The benchmark's machinery, driven by ``BENCHMARK.json``: a cell names a
configuration and a traffic mix, and everything else is found by name.

* ``perfbench/configs/<config>.json``: the configuration as run;
* ``perfbench/traffic/<traffic>.json``: the mix's parameters and the name
  of its driver, ``perfbench/drivers/<driver>.py`` (``run(ctx)``);
* ``perfbench/metrics/<metric>.py``: one reader a per-layer metric
  (``read(run)`` → a number or ``None``);
* ``perfbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``.

A driver sets up the program, calls :meth:`Context.open_window` right
before its first timed operation, runs the window, reads the peak memory
(:meth:`Context.read_peak`), frees the program and compares what the
window produced with the plain reference.  The harness turns what it
returns into the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from perfbench.counts import intervals
from perfbench.inputs import Arch, arch

#: top-level modules the measured process may not hold (the JAX package's
#: name among them), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the prefix of the benchmark's own spans in a profiler trace
SPAN_PREFIX = "pb:"


class BenchError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def load_module(path: Path, name: str):
    """The module of a file the benchmark finds by name (a driver, a
    metric reader), loaded once a process."""
    key = "perfbench_" + re.sub(r"\W", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """One ``workloads`` entry with what it names, read from its files."""
    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]

    @classmethod
    def load(cls, root: Path, name: str,
             bench_file: Optional[Path] = None) -> "Cell":
        bench = json.loads((bench_file or root / "BENCHMARK.json").read_text())
        work = next((w for w in bench["workloads"] if w["name"] == name), None)
        if work is None:
            raise BenchError(f"BENCHMARK.json has no workload {name!r}")
        entry = next((c for c in bench["configs"]
                      if c["name"] == work["config"]), None)
        if entry is None:
            raise BenchError(f"BENCHMARK.json has no config "
                             f"{work['config']!r}")
        pb = root / "perfbench"
        config = json.loads((root / entry["file"]).read_text())
        traffic = json.loads((pb / "traffic" / f"{work['traffic']}.json")
                             .read_text())
        limits = json.loads((pb / "limits" / f"{name}.json").read_text())
        return cls(root, bench, work, config, traffic, limits)

    @property
    def arch(self) -> Arch:
        return arch(self.config)

    def metrics(self, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those that list it, or list no cells and move (or are) an
        end-to-end metric it reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if self._mine(m, None)]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self._mine(m, names)]

    def _mine(self, metric: dict, e2e_names) -> bool:
        if "workloads" in metric:
            return self.workload["name"] in metric["workloads"]
        return e2e_names is None or metric["moves"] in e2e_names

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.root / "perfbench" / "drivers" / f"{name}.py",
                           "driver_" + name)

    def reader(self, metric: str) -> Callable:
        return load_module(self.root / "perfbench" / "metrics"
                           / f"{metric}.py", "metric_" + metric).read


class Span(NamedTuple):
    """One of the benchmark's host spans in the window: its name, its start
    and end on ``time.perf_counter``, what the driver noted of its work,
    and whether the profiler was on (its time then carries the profiler's
    cost, so host-clock readers leave it out)."""
    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any]
    traced: bool

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """The benchmark's spans (host clock) around calls into the program,
    and the requests it served.  While a trace runs a span is also a
    ``record_function`` range, so that the device's idle gaps can be named
    by what the host was doing."""

    def __init__(self):
        self.spans: List[Span] = []
        #: served requests: ``(submitted, [time of each token])``
        self.requests: List[tuple] = []
        self.tracing = False
        #: when the profiler started (``None``: it never did)
        self.traced_from: Optional[float] = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        traced = self.tracing
        ctx = (torch.profiler.record_function(SPAN_PREFIX + name)
               if traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield attrs
        self.spans.append(Span(name, t0, time.perf_counter(), attrs,
                               traced or self.tracing))


@dataclasses.dataclass
class DeviceTrace:
    """What a profiled slice of the window saw: its device kernels
    ``(name, start_s, end_s)``, the benchmark's spans on the same clock,
    and the slice's bounds."""
    kernels: List[tuple]
    spans: List[tuple]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return intervals.busy((lo, hi) for _, lo, hi in self.kernels)

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, lo, hi in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (hi - lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        for lo, hi in intervals.gaps(((a, b) for _, a, b in self.kernels),
                                     self.start, self.end):
            mid = (lo + hi) / 2
            inside = [s for s in self.spans if s[1] <= mid <= s[2]]
            label = (min(inside, key=lambda s: s[2] - s[1])[0] if inside
                     else "between spans")
            gaps.append([label, hi - lo])
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": gaps[:n]}


class Tracer:
    """``torch.profiler`` over a slice of the window (:meth:`start` and
    :meth:`stop` at step boundaries, each after a synchronise)."""

    def __init__(self, rec: Recorder, device: torch.device):
        self.rec, self.device = rec, device
        self.prof = None
        self.result: Optional[DeviceTrace] = None
        self._slice = None

    @property
    def idle(self) -> bool:
        """Not started yet (a run profiles one slice)."""
        return self.prof is None and self.result is None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.rec.traced_from = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rec.tracing = True
        self._slice = torch.profiler.record_function(SPAN_PREFIX + "slice")
        self._slice.__enter__()

    def stop(self):
        self._sync()
        self._slice.__exit__(None, None, None)
        self.rec.tracing = False
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        kernels, spans, bounds = [], [], None
        for e in self.prof.events():
            lo, hi = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                # a record_function range shows on the device too: no work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    kernels.append((e.name, lo, hi))
            elif e.name.startswith(SPAN_PREFIX):
                name = e.name[len(SPAN_PREFIX):]
                if name == "slice":
                    bounds = (lo, hi)
                else:
                    spans.append((name, lo, hi))
        if bounds is None:
            raise BenchError("the profiler recorded no slice span")
        kernels = [k for k in kernels if k[2] > bounds[0] and k[1] < bounds[1]]
        self.result = DeviceTrace(kernels, spans, *bounds)
        self.prof = None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end metrics by name, requests
    or steps attempted and failed, the numbers that decide ``correct``, the
    window's length (from :meth:`Context.open_window`) and, with
    ``control``, the control's numbers."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, float]
    window_s: float
    control: Optional[Dict[str, float]] = None


class Context:
    """What a driver is given.  ``options``: ``control`` (also compute the
    control's numbers) and ``fault`` (break the timed path, for tests)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_start: float, options: dict):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.arch = cell.arch
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.options = options
        self.t_start = t_start
        self.t_window: Optional[float] = None
        self.memory_peak = 0
        self.rec = Recorder()
        self.tracer = Tracer(self.rec, device) if trace else None

    def log(self, msg: str) -> None:
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """Marks the end of set-up (the spans of set-up are dropped);
        returns the window's start."""
        self.sync()
        self.rec.spans.clear()
        self.t_window = time.perf_counter()
        self.log(f"set-up {self.setup_s:.3f} s")
        return self.t_window

    def trace_start(self, t0: float) -> float:
        """When a traced run starts the profiler: at the traffic's
        ``trace_from`` share of the window.  It profiles to the window's
        end and is stopped after it, so that reading the trace falls
        outside the window."""
        return t0 + self.traffic["trace_from"] * self.seconds

    def read_peak(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell, the configuration's sizes,
    the benchmark's spans and served requests, and the profiled
    slice (``None`` without one)."""
    cell: Cell
    arch: Arch
    rec: Recorder
    trace: Optional[DeviceTrace]
    window: tuple

    def spans(self, name: str, traced: Optional[bool] = False) -> List[Span]:
        """The window's spans of that name (by default those the profiler
        did not slow; ``traced=True`` those it saw, ``None`` all)."""
        t0, t1 = self.window
        return [s for s in self.rec.spans if s.name == name
                and s.t0 >= t0 and s.t1 <= t1
                and (traced is None or s.traced == traced)]

    @property
    def untraced_end(self) -> float:
        """The end of the part of the window the profiler did not slow."""
        t = self.rec.traced_from
        return self.window[1] if t is None else min(t, self.window[1])

    def kernel_seconds(self, names) -> Optional[float]:
        """Device seconds of the profiled slice's kernels whose names hold
        one of ``names``; ``None`` without a trace or without such a
        kernel."""
        if self.trace is None:
            return None
        ks = [hi - lo for n, lo, hi in self.trace.kernels
              if any(k in n for k in names)]
        return sum(ks) if ks else None


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, interpolated between ranks as numpy's
    default does; an infinite value (a request that failed) lies above
    every other, and a percentile that reaches it is infinite."""
    if not values:
        raise BenchError("no samples for a percentile")
    v = sorted(values)
    rank = q / 100 * (len(v) - 1)
    lo, frac = int(rank), rank - int(rank)
    if frac == 0:
        return float(v[lo])
    if v[lo + 1] == float("inf"):
        return float("inf")
    return float(v[lo] + (v[lo + 1] - v[lo]) * frac)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device=None,
             bench_file: Optional[Path] = None, options=None) -> dict:
    """Runs one cell once; returns the result line's object (with the
    harness's own ``control`` key when the control was asked for)."""
    cell = Cell.load(root, workload, bench_file)
    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count()} available")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Context(cell, seed, seconds, trace, device, t_start, options or {})
    out: Outcome = cell.driver().run(ctx)
    if ctx.t_window is None:
        raise BenchError("the driver never opened its window")

    limits = cell.limits
    missing = set(limits) ^ set(out.compared)
    if missing:
        raise BenchError(f"compared numbers and limits differ: {missing}")
    correct = all(out.compared[k] <= limits[k] for k in limits)
    values = dict(out.metrics, setup_s=ctx.setup_s)
    metrics = {}
    if trace:
        run = Run(cell, ctx.arch, ctx.rec,
                  ctx.tracer.result if ctx.tracer else None,
                  (ctx.t_window, ctx.t_window + out.window_s))
        for m in cell.metrics("per_layer"):
            v = cell.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.metrics("end_to_end"):
            if m["name"] not in values:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(ctx.memory_peak)}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and ctx.tracer and ctx.tracer.result:
        tr = ctx.tracer.result
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    if out.control is not None:
        result["control"] = {k: {"value": v, "limit": limits[k]}
                             for k, v in out.control.items()}
    result["compared"] = {k: {"value": out.compared[k], "limit": limits[k]}
                          for k in limits}
    return result
