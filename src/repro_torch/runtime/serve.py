"""Continuous-batching serving engine (the port of ``repro.runtime.serve``).

* **slots** — a fixed number of batch rows backed by one persistent KV
  cache allocated at construction.  A request occupies one slot from
  admission to retirement, and every slot tracks its own absolute
  position: the decode step gets a per-row ``(B,)`` position vector.
* **admission** — a free slot takes the next queued request, whose prompt
  is prefilled in length-bucketed chunks (the last chunk zero-padded to the
  smallest bucket, its first token sampled at the last *valid* position).
  The first chunk zeroes the slot's cache row.
* **retirement** — a request leaves its slot when it emits ``eos_token`` or
  reaches its own ``max_new_tokens``.

Free slots ride along in the batched decode with ``pos=0`` and a dummy
token; attention masking keeps them invisible.  PyTorch runs eagerly, so
:attr:`Engine.compiled_shapes` counts the distinct step shapes seen, the
analogue of ``repro``'s trace counters.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.api.backends import (resolve_backend, resolve_device,
                                      use_backend)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None    # retire early on this token (kept)
    out_tokens: Optional[np.ndarray] = None
    rid: int = -1                      # assigned by Engine.submit


@dataclasses.dataclass
class _Slot:
    """Host-side per-slot decode state."""
    request: Request
    pos: int                           # tokens in cache == next write index
    last_tok: int                      # token to feed at the next step
    out: List[int] = dataclasses.field(default_factory=list)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Engine:
    """Greedy continuous-batching generation over a fixed slot count.

    ``model`` is a :class:`~repro_torch.models.Transformer` whose
    parameters live on ``device`` (``None`` means the card; raises when
    there is none).  ``prefill_buckets`` are descending chunk sizes, each a
    multiple of the smallest.  ``backend`` scopes the SpMM backend of every
    model call.  Quantized serving is not ported yet.
    """

    def __init__(self, model, *, slots: int = 4, max_len: int = 512,
                 backend: Optional[str] = None,
                 prefill_buckets: Tuple[int, ...] = (64, 16),
                 quantize: Optional[str] = None, device=None):
        if quantize is not None:
            raise NotImplementedError(
                "Engine(quantize=...): quantized serving is not ported yet; "
                "see ROADMAP 'quantized serving'")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model parameters are on {model.device}, the "
                             f"engine runs on {self.device}")
        self.model = model
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.backend = resolve_backend(backend)

        buckets = tuple(sorted({int(c) for c in prefill_buckets}, reverse=True))
        if not buckets or buckets[-1] < 1:
            raise ValueError(f"bad prefill_buckets {prefill_buckets!r}")
        if any(c % buckets[-1] for c in buckets):
            raise ValueError(
                f"prefill_buckets {buckets} must all be multiples of the "
                f"smallest bucket (chunk starts must stay bucket-aligned)")
        self.prefill_buckets = buckets
        # rounded up so a final padded chunk never writes past the end
        self._cache_len = _round_up(self.max_len, buckets[-1])
        self.cache = model.init_cache(self.slots, self._cache_len)

        self._queue: Deque[Request] = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._next_rid = 0
        self.completed = 0
        self.decode_calls = 0
        self.prefill_calls = 0
        self._shapes: Dict[str, Set[tuple]] = {"decode": set(),
                                               "prefill": set()}

    # -- step functions --------------------------------------------------------

    @torch.inference_mode()
    def _decode(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """tok (S, 1), pos (S,) — one batched decode step at per-slot
        positions; returns the greedy next token (S,)."""
        self._shapes["decode"].add(tuple(tok.shape))
        self.decode_calls += 1
        with use_backend(self.backend):
            logits, _ = self.model.decode_step(self.cache, tok, pos)
        return logits.argmax(dim=-1)

    @torch.inference_mode()
    def _prefill(self, slot: int, tok: torch.Tensor, pos: int,
                 last_idx: int, fresh: bool) -> torch.Tensor:
        """Prefill one chunk of one slot through a view of the slot's cache
        row; ``fresh`` zeroes the row first (wipes the previous occupant)."""
        self._shapes["prefill"].add(tuple(tok.shape))
        self.prefill_calls += 1
        row = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        if fresh:
            for v in row.values():
                v.zero_()
        idx = torch.tensor([last_idx], device=self.device)
        with use_backend(self.backend):
            logits, _ = self.model.decode_step(row, tok, pos, logit_idx=idx)
        return logits.argmax(dim=-1)

    # -- request lifecycle -----------------------------------------------------

    def submit(self, request: Request) -> Request:
        """Validate and enqueue; ``ValueError`` if the request cannot fit."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{request.max_new_tokens}")
        total = prompt.size + request.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request needs {prompt.size} prompt + "
                f"{request.max_new_tokens} new = {total} positions but "
                f"max_len={self.max_len}")
        request.prompt = prompt
        request.rid = self._next_rid
        self._next_rid += 1
        self._queue.append(request)
        return request

    def _chunk_schedule(self, length: int) -> List[int]:
        """Bucket sizes covering ``length`` prompt tokens (the last chunk
        may be zero-padded; starts stay aligned to the smallest bucket)."""
        chunks, done = [], 0
        while done < length:
            rem = length - done
            c = next((c for c in self.prefill_buckets if c <= rem),
                     self.prefill_buckets[-1])
            chunks.append(c)
            done += c
        return chunks

    def _admit(self, s: int, req: Request) -> None:
        prompt = req.prompt
        length = int(prompt.shape[0])
        done = 0
        tok_dev = None
        for i, c in enumerate(self._chunk_schedule(length)):
            n = min(c, length - done)
            buf = np.zeros((1, c), np.int64)
            buf[0, :n] = prompt[done:done + n]
            tok_dev = self._prefill(s, torch.from_numpy(buf).to(self.device),
                                    done, n - 1, fresh=(i == 0))
            done += n
        tok = int(tok_dev[0])      # one host sync per admission
        slot = _Slot(request=req, pos=length, last_tok=tok, out=[tok])
        self._slots[s] = slot
        if self._finished(slot):
            self._retire(s)

    def _finished(self, slot: _Slot) -> bool:
        r = slot.request
        return (len(slot.out) >= r.max_new_tokens
                or (r.eos_token is not None and slot.out
                    and slot.out[-1] == r.eos_token))

    def _retire(self, s: int) -> None:
        slot = self._slots[s]
        slot.request.out_tokens = np.asarray(slot.out, np.int32)
        self._slots[s] = None
        self.completed += 1

    # -- the serving loop --------------------------------------------------------

    def admit_pending(self) -> int:
        """Prefill queued requests into free slots; returns slots filled."""
        filled = 0
        for s in range(self.slots):
            if self._slots[s] is None and self._queue:
                self._admit(s, self._queue.popleft())
                filled += 1
        return filled

    def step(self) -> int:
        """Admit into free slots, then run one batched decode step.
        Returns the number of live slots that advanced."""
        self.admit_pending()
        live = [s for s in range(self.slots) if self._slots[s] is not None]
        if not live:
            return 0
        tok = np.zeros((self.slots, 1), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        for s in live:
            tok[s, 0] = self._slots[s].last_tok
            pos[s] = self._slots[s].pos
        nxt = self._decode(torch.from_numpy(tok).to(self.device),
                           torch.from_numpy(pos).to(self.device)).cpu().numpy()
        for s in live:
            slot = self._slots[s]
            slot.pos += 1
            slot.last_tok = int(nxt[s])
            slot.out.append(slot.last_tok)
            if self._finished(slot):
                self._retire(s)
        return len(live)

    def run(self) -> None:
        """Drain the queue and all occupied slots."""
        while self._queue or any(s is not None for s in self._slots):
            self.step()

    def generate(self, requests: List[Request]) -> List[Request]:
        """Submit + drain; fills each request's ``out_tokens`` in place."""
        for r in requests:
            self.submit(r)
        self.run()
        return requests

    @property
    def compiled_shapes(self) -> Dict[str, int]:
        """Distinct step shapes seen per step kind — flat after warmup."""
        return {k: len(v) for k, v in self._shapes.items()}
