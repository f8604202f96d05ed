"""Async, atomic checkpoints in ``repro``'s layout (numpy-backed)::

    <dir>/step_<N>/
        manifest.json      # step, entry keys, shapes, dtypes
        arrays.npz         # one entry per state tensor
    <dir>/step_<N>.tmp/    # staging; atomically renamed on commit

Entries are keyed by the port's state names (``params/<name>``,
``opt/m/<name>``, ...), not by ``repro``'s pytree leaf order, so a JAX
checkpoint does not load here (ROADMAP).

* **atomic commit**: a checkpoint exists completely or not at all (the
  rename of the staging directory), so a crash mid-save never corrupts the
  restart state;
* **async**: the tensors are copied to host memory synchronously (the
  trainer updates them in place right after), then written on a
  background thread; a failed write raises at the next :meth:`wait`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Mapping[str, torch.Tensor], *,
             wait: bool = False) -> None:
        """Commit ``state`` as ``step_<step>``; the write runs in the
        background unless ``wait``."""
        host = {}
        for key, t in state.items():
            a = t.detach().to("cpu", copy=True)
            if a.dtype == torch.bfloat16:  # bf16 moments (state_dtype)
                a = a.float()              # npz-safe; restore casts back
            host[key] = a.numpy()
        self.wait()                        # one outstanding save at a time
        self._thread = threading.Thread(target=self._write_guarded,
                                        args=(step, host), daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def _write_guarded(self, step: int, host: Dict[str, np.ndarray]) -> None:
        try:
            self._write(step, host)
        except Exception as e:             # re-raised by wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "keys": list(host),
            "shapes": [list(a.shape) for a in host.values()],
            "dtypes": [str(a.dtype) for a in host.values()],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # atomic commit
        self._gc()

    def wait(self) -> None:
        """Join the outstanding write; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, state_like: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The tensors of ``step_<step>`` with the keys of ``state_like``,
        each cast to its dtype and placed on its device."""
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        out = {}
        with np.load(path) as z:
            missing = sorted(set(state_like) - set(z.files))
            if missing:
                raise ValueError(f"checkpoint step {step} lacks {missing}")
            for key, like in state_like.items():
                a = z[key]
                if tuple(a.shape) != tuple(like.shape):
                    raise ValueError(f"{key}: checkpoint shape {a.shape}, "
                                     f"expected {tuple(like.shape)}")
                out[key] = torch.from_numpy(a).to(device=like.device,
                                                  dtype=like.dtype)
        return out
