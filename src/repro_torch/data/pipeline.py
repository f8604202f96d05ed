"""Deterministic synthetic token data (a numpy copy of
``repro.data.pipeline``, same hash, so the batches are bit-equal).

Every token is a pure function of ``(seed, step, batch row, position)``
through a counter-based hash: the pipeline's state is the step counter, and
a restart replays the same batches.  The frontend embeddings of the vision
and encoder-decoder families (``vis_embeds``, ``enc_embeds``) are float
stand-ins hashed the same way.  ``batch(step, shard=rows)`` computes only
the given rows, each equal bit for bit to the same row of the full batch,
so any rank can compute its share of any step without coordination.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Union

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

    def _tokens(self, step: int, rows: np.ndarray, t: int) -> np.ndarray:
        pos = np.arange(t, dtype=np.uint64)[None, :]
        ctr = (np.uint64(self.seed) * np.uint64(1_000_003)
               + np.uint64(step) * np.uint64(1 << 40)
               + rows[:, None].astype(np.uint64) * np.uint64(1 << 20) + pos)
        return (_hash_u32(ctr) % np.uint32(self.cfg.vocab)).astype(np.int32)

    def batch(self, step: int, *,
              shard: Union[slice, Sequence[int], None] = None
              ) -> Dict[str, np.ndarray]:
        """The global batch for ``step``: int32 ``tokens`` and next-token
        ``targets``, both ``(global_batch, seq_len)`` (a ``vlm``'s text is
        ``n_frontend_tokens`` shorter, so that its image prefix and text
        fill ``seq_len``), and fp32 ``vis_embeds`` (``vlm``) or
        ``enc_embeds`` (``enc_dec``) of ``(global_batch,
        n_frontend_tokens, d_model)``.  ``shard`` (a slice or row indices,
        as ``repro``'s) selects rows of the global batch before they are
        hashed."""
        cfg = self.cfg
        rows = np.arange(self.shape.global_batch, dtype=np.int64)
        if shard is not None:
            rows = rows[shard]
        n_front = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        toks = self._tokens(step, rows, self.shape.seq_len - n_front + 1)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.family in ("vlm", "enc_dec"):
            key = "vis_embeds" if cfg.family == "vlm" else "enc_embeds"
            out[key] = self._embeds(step, rows, cfg.n_frontend_tokens)
        return out

    def _embeds(self, step: int, rows: np.ndarray, n: int) -> np.ndarray:
        """(rows, n, d_model) fp32 in [-0.1, 0.1), a pure function of
        (seed, step, row, position, channel)."""
        d = self.cfg.d_model
        ctr = ((np.uint64(self.seed) ^ np.uint64(0xE5))
               + np.uint64(step) * np.uint64(1 << 34)
               + (rows[:, None, None].astype(np.uint64) * np.uint64(n * d)
                  + np.arange(n, dtype=np.uint64)[None, :, None]
                  * np.uint64(d)
                  + np.arange(d, dtype=np.uint64)[None, None, :]))
        u = _hash_u32(ctr).astype(np.float32) / np.float32(2 ** 32)
        return ((u - 0.5) * 0.2).astype(np.float32)
