"""Async, atomic checkpoints in ``repro``'s layout (numpy-backed)::

    <dir>/step_<N>/
        manifest.json      # step, entry keys, shapes, dtypes
        arrays.npz         # one entry per state tensor
    <dir>/step_<N>.tmp/    # staging; atomically renamed on commit

Entries are keyed by the port's state names (``params/<name>``,
``opt/m/<name>``, ...), not by ``repro``'s pytree leaf order; a checkpoint
that ``repro`` wrote is read by :mod:`repro_torch.checkpoint.jax_format`.
Arrays are stored unsharded, so a checkpoint restores onto any mesh: a
sharded state (DTensor entries) is gathered before it is written, by rank
0 only, and ``restore(..., shardings=)`` gives each rank its shards.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor


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
        background unless ``wait``.  DTensor entries are gathered to full
        tensors first (a collective: every rank of their mesh calls
        ``save``); in a process group only rank 0 writes, and ``wait``
        returns on every rank after the commit."""
        grouped = dist.is_initialized() and dist.get_world_size() > 1
        writer = not grouped or dist.get_rank() == 0
        host = {}
        for key, t in state.items():
            if isinstance(t, DTensor):
                t = t.full_tensor()        # every rank takes part
            if not writer:                 # only the writer keeps a copy
                continue
            a = t.detach().to("cpu", copy=True)
            if a.dtype == torch.bfloat16:  # bf16 moments (state_dtype)
                a = a.float()              # npz-safe; restore casts back
            host[key] = a.numpy()
        if writer:
            self.wait()                    # one outstanding save at a time
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, host), daemon=True)
            self._thread.start()
        if wait:
            self.wait()
            if grouped:
                dist.barrier()

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

    def restore(self, step: int, state_like: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping] = None
                ) -> Dict[str, torch.Tensor]:
        """The tensors of ``step_<step>`` with the keys of ``state_like``,
        each cast to its dtype and placed on its device; with
        ``shardings`` (a ``repro_torch.sharding.Sharding`` a key, any
        mesh) each comes back as a DTensor over this rank's shard."""
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            missing = sorted(set(state_like) - set(z.files))
            if missing:
                raise ValueError(f"checkpoint step {step} lacks {missing}")
            # one array read at a time: each is placed (or sharded) and
            # dropped before the next
            return place_state(z, state_like, shardings)


def place_state(loaded: Mapping[str, np.ndarray],
                state_like: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping] = None
                ) -> Dict[str, torch.Tensor]:
    """Full arrays → tensors like ``state_like``'s (shape checked, dtype
    and device taken), or with ``shardings`` DTensors over this rank's
    shards."""
    out = {}
    for key, like in state_like.items():
        a = loaded[key]
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(a.shape)}, "
                             f"expected {tuple(like.shape)}")
        t = torch.as_tensor(a)
        if shardings is None:
            out[key] = t.to(device=like.device, dtype=like.dtype)
            continue
        sh = shardings[key]
        local = sh.shard(t).to(device=like.device, dtype=like.dtype,
                               memory_format=torch.contiguous_format)
        out[key] = DTensor.from_local(local, sh.mesh, sh.placements,
                                      run_check=False)
    return out
