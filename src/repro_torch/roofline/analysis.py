"""Roofline terms of a traced step (the port of
``repro.roofline.analysis``), with the H100's datasheet rates.

    compute    = FLOPs      / (chips × peak FLOP/s)
    memory     = bytes      / (chips × HBM B/s)
    collective = coll bytes / (chips × NVLink B/s per direction)
    dcn        = DCN bytes  / (links × B/s per GPU across nodes)

``repro`` reads FLOPs and bytes from XLA's ``cost_analysis`` and
collective bytes from the compiled HLO text.  The port runs eagerly, so
:class:`CostCounter` sums them over the operators a step dispatches
(``torch.utils.flop_counter``'s formulas for the dense products, one
formula for each kernel operator of :mod:`repro_torch.kernels`; the bytes
of every operator's tensor inputs and outputs, which is what XLA's
unfused ``bytes accessed`` counts, and each kernel's own byte count), and
:class:`CommRecorder` records the c10d collectives the step calls, each
counted at its result's bytes as ``repro``'s parser counts result shapes.
Both are dispatch modes: they see fake tensors (the dry run) as they see
real ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's peak rates (the roofline's denominators)."""
    name: str
    peak_flops: float        # dense bf16 tensor-core FLOP/s
    hbm_bw: float            # device-memory bytes/s
    link_bw: float           # bytes/s each way to the other cards of a node
    dcn_bw: float            # bytes/s a card across nodes
    hbm_bytes: int           # device memory


#: NVIDIA H100 SXM 80GB, datasheet values at the 700 W limit: 989 TFLOP/s
#: dense bf16, 3.35 TB/s of HBM3, NVLink 4 at 900 GB/s a card (450 GB/s
#: each way), one 400 Gb/s NIC a card across nodes.  No machine with more
#: than one card has measured the two link rates.  ``hbm_bytes`` is what
#: ``torch.cuda.get_device_properties(0).total_memory`` reports on the card
#: (chip_smoke.py [dryrun]).
H100_SXM = Chip("NVIDIA H100 SXM 80GB", peak_flops=989e12, hbm_bw=3.35e12,
                link_bw=450e9, dcn_bw=50e9, hbm_bytes=85_017_493_504)

_TERMS = ("compute_s", "memory_s", "collective_s", "dcn_s")


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, *, dcn_bytes: float = 0.0, dcn_links: int = 1,
                   chip: Chip = H100_SXM) -> Dict[str, object]:
    """``repro``'s formula and keys: the four terms in seconds, the
    ``dominant`` one and ``bound_s``, its value.  ``flops``,
    ``bytes_accessed`` and ``coll_bytes`` are totals over the ``chips``."""
    terms = {"compute_s": flops / (chips * chip.peak_flops),
             "memory_s": bytes_accessed / (chips * chip.hbm_bw),
             "collective_s": coll_bytes / (chips * chip.link_bw),
             "dcn_s": dcn_bytes / (max(dcn_links, 1) * chip.dcn_bw)}
    dominant = max(_TERMS, key=lambda k: terms[k])
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms


def model_flops(cfg, shape, n_tokens: float = None) -> float:
    """``repro``'s analytic count: 2·N·tokens (dense) or 2·N_active·tokens
    (MoE), plus the attention term 4·tokens·ctx·(H·hd) per attention layer
    at half for causality, times 3 for a training step."""
    if n_tokens is None:
        n_tokens = shape.global_batch * (
            shape.seq_len if shape.kind in ("train", "prefill") else 1)
    n = cfg.active_param_count()
    flops = 2.0 * n * n_tokens
    if cfg.n_heads:
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_kind(i) in ("attn", "moe", "local", "cross"))
        ctx = shape.seq_len
        if cfg.layer_pattern and "local" in cfg.layer_pattern:
            ctx = min(ctx, cfg.local_window)
        flops += 0.5 * 4.0 * n_tokens * ctx * cfg.n_heads * cfg.hd * n_attn
    mult = 3.0 if shape.kind == "train" else 1.0
    return flops * mult


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

#: ``repro``'s opcode names, by the words of the c10d operator names
_OPCODES = (("reduce_scatter", "reduce-scatter"),
            ("allgather", "all-gather"), ("all_gather", "all-gather"),
            ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
            ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
            ("send", "collective-permute"), ("recv", "collective-permute"))
_COLLECTIVE_NS = ("c10d", "_c10d_functional")


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _opcode(func) -> str:
    name = func._overloadpacket.__name__
    return next((op for word, op in _OPCODES if word in name), name)


class CommRecorder(TorchDispatchMode):
    """Records each c10d collective dispatched inside it as ``(opcode,
    result bytes)`` in :attr:`records`: the output of a functional
    collective, the first argument of an in-place one (the tensors it
    writes: the gathered tensor, the scattered shard, the reduced
    tensors).  The sharded trainer's direct ``dist.all_gather_into_tensor``
    / ``reduce_scatter_tensor`` / ``all_reduce`` calls reach a dispatch
    mode as ``c10d._allgather_base_`` / ``_reduce_scatter_base_`` /
    ``allreduce_`` (``CommDebugMode`` counts them too, but not their
    bytes)."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NS and "wait" not in func.__name__:
            result = args[0] if func.namespace == "c10d" else out
            self.records.append((_opcode(func), _nbytes(result)))
        return out


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Total result bytes per collective opcode (``repro``'s names:
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) of :class:`CommRecorder` records."""
    out: Dict[str, int] = {}
    for opcode, nbytes in records:
        out[opcode] = out.get(opcode, 0) + nbytes
    return out


# ---------------------------------------------------------------------------
# FLOPs and bytes
# ---------------------------------------------------------------------------

def live_pairs(tq: int, tk: int, *, causal: bool, window, offset: int,
               kv_len: int, q_period) -> int:
    """Unmasked (query row, key) pairs of one (batch, head) row of a
    ``flash_attention`` call: keys below ``kv_len``, at or before the row's
    position (causal) and within ``window`` of it."""
    period = tq if q_period is None else q_period
    pos = offset + np.arange(tq, dtype=np.int64) % period
    hi = np.full(tq, kv_len - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, pos)
    lo = np.zeros(tq, dtype=np.int64)
    if window is not None:
        lo = np.maximum(lo, pos - window + 1)
    return int(np.clip(hi - lo + 1, 0, tk).sum())


def _spmm_cost(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
               seg_write, accum_prev, valid, b_dense, runs, chunks, grid_m,
               bn, transpose_lhs, out_dtype, path, *, out_val):
    """Every stored block once against B's columns (``2·bm·bk·N`` a
    block); bytes as ``chip_smoke.spmm_bounds`` counts them: the blocks
    (and scales), B and C, each once."""
    n_blocks, bm, bk = a_blocks.shape
    n = b_dense.shape[1]
    c = out_val[0]
    nbytes = _nbytes([a_blocks, a_scales, b_dense, c])
    return 2 * n_blocks * bm * bk * n, nbytes


def _attn_pairs(q, k, causal, window, offset, kv_len, q_period):
    bh, tq, _ = q.shape
    return bh * live_pairs(tq, k.shape[1], causal=causal, window=window,
                           offset=offset, kv_len=kv_len, q_period=q_period)


def _attn_cost(q, k, v, causal, window, offset, kv_len, bq, bkv, q_period,
               out_dtype, stats, path, *, out_val):
    """Q·Kᵀ and P·V on each live pair (4·D); q, k, v, out and the row
    statistics once."""
    pairs = _attn_pairs(q, k, causal, window, offset, kv_len, q_period)
    return (4 * q.shape[-1] * pairs,
            _nbytes([q, k, v, out_val[:2 if stats else 1]]))


def _attn_bwd_cost(q, k, v, out, dout, stats, causal, window, offset,
                   kv_len, bq, bkv, q_period, path, *, out_val):
    """S again, dP, dV, dK and dQ on each live pair (10·D); the operands
    and dq, dk, dv once."""
    pairs = _attn_pairs(q, k, causal, window, offset, kv_len, q_period)
    return (10 * q.shape[-1] * pairs,
            _nbytes([q, k, v, out, dout, stats, out_val[:3]]))


def _lru_cost(x, a_gate, x_gate, a_param, h0, c, path, *, out_val):
    """The recurrence's multiply-add (2 an element); the operands, out and
    h_T once."""
    return (2 * x.numel(),
            _nbytes([x, a_gate, x_gate, a_param, h0, out_val[:2]]))


def _lru_bwd_cost(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c, path,
                  *, out_val):
    """The reverse chain's and da's multiply-adds (4 an element); the
    operands and the five gradients once."""
    return (4 * x.numel(),
            _nbytes([x, a_gate, x_gate, a_param, h0, hs, dout, dh_t,
                     out_val[:5]]))


def kernel_costs() -> Dict[object, object]:
    """``{operator packet: cost(*args, out_val=) → (flops, bytes)}`` of the
    kernel operators of :mod:`repro_torch.kernels`."""
    import repro_torch.kernels  # noqa: F401  (registers the operators)
    ops = torch.ops.repro_torch
    return {ops.segment_spmm: _spmm_cost,
            ops.flash_attention: _attn_cost,
            ops.flash_attention_bwd: _attn_bwd_cost,
            ops.rg_lru: _lru_cost, ops.rg_lru_bwd: _lru_bwd_cost}


#: operators that move no bytes: allocation and metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "set_", "resize_"}


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of every operator dispatched inside it.

    ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention) and the kernel operators' own
    (:func:`kernel_costs`); other operators count none, as in MFU
    accounting.  ``bytes``: the bytes of each operator's tensor inputs and
    outputs, views and allocations excluded (no data moves), collectives
    excluded (:class:`CommRecorder` counts them), a kernel operator at its
    own count (its scratch outputs stay inside the kernel)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self._kernels = kernel_costs()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NS or func.namespace == "prim":
            return out
        packet = func._overloadpacket
        if packet in self._kernels:
            flops, nbytes = self._kernels[packet](*args, **kwargs,
                                                  out_val=out)
        else:
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            nbytes = (0 if func.is_view or packet.__name__ in _NO_BYTES
                      else _nbytes([args, kwargs, out]))
        self.flops += int(flops)
        self.bytes += int(nbytes)
        return out
