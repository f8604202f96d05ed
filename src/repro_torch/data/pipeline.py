"""Deterministic synthetic token data (a numpy copy of
``repro.data.pipeline``, same hash, so the batches are bit-equal).

Every token is a pure function of ``(seed, step, batch row, position)``
through a counter-based hash: the pipeline's state is the step counter, and
a restart replays the same batches.  The row sharding and the frontend
embeddings of ``repro``'s vision and audio families are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix-style counter hash, vectorized, uint64 → uint32."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 1234

    def __post_init__(self):
        if self.cfg.family in ("vlm", "enc_dec"):
            raise NotImplementedError(
                f"{self.cfg.family}: frontend embeddings are not ported")

    def _tokens(self, step: int, rows: np.ndarray, t: int) -> np.ndarray:
        pos = np.arange(t, dtype=np.uint64)[None, :]
        ctr = (np.uint64(self.seed) * np.uint64(1_000_003)
               + np.uint64(step) * np.uint64(1 << 40)
               + rows[:, None].astype(np.uint64) * np.uint64(1 << 20) + pos)
        return (_hash_u32(ctr) % np.uint32(self.cfg.vocab)).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The global batch for ``step``: int32 ``tokens`` and next-token
        ``targets``, both ``(global_batch, seq_len)``."""
        rows = np.arange(self.shape.global_batch, dtype=np.int64)
        toks = self._tokens(step, rows, self.shape.seq_len + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
