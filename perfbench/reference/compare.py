"""The numbers that decide ``correct``, each taken the same way for the
program and for the control.

Training: ``loss_gap`` (the worst step's gap of the loss, relative),
``grad_gap`` (the worst leaf's gap of the first gradient's norm) and
``change_gap`` (the worst leaf's gap of the norm of its change over the
steps).  A leaf's gap is ``|‖prog‖ − ‖ref‖|`` over the larger of the
reference's norm of that leaf and of the median leaf.  ``change_gap``
leaves out the leaves whose reference gradient is under a thousandth of
the median leaf's: those move by round-off alone.

Serving: a served token's gap is how far its logit lies below the
reference's best logit at its position (:func:`token_gaps`);
``logit_gap_mean`` is the mean gap over the served tokens compared and
``logit_gap_worst_request`` the largest of the requests' median gaps
(``perfbench/drivers/chat.py``).
"""
from __future__ import annotations

import statistics
from typing import Dict, Tuple

import torch

#: a leaf whose first gradient is under this share of the median leaf's
#: is left out of ``change_gap``
QUIET_LEAF = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names) -> Dict[str, float]:
    """Each named leaf's gap of norms, relative to the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def moving_leaves(ref: dict):
    """The leaves whose reference gradient is at least :data:`QUIET_LEAF`
    of the median leaf's."""
    g_med = statistics.median(ref["grad"].values())
    return [k for k, g in ref["grad"].items() if g >= QUIET_LEAF * g_med]


def train_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], str]:
    """The three numbers, and for the log the leaf behind each worst gap
    of norms and the count of quiet leaves left out."""
    n = len(ref["loss"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(prog["loss"][:n], ref["loss"]))
    moving = moving_leaves(ref)
    gaps = {"grad": leaf_gaps(prog["grad"], ref["grad"], ref["grad"]),
            "change": leaf_gaps(prog["change"], ref["change"], moving)}
    numbers = {"loss_gap": loss_gap,
               "grad_gap": max(gaps["grad"].values()),
               "change_gap": max(gaps["change"].values(), default=0.0)}
    worst = [f"{k} {max(d, key=d.get)} {max(d.values()):.3g}"
             for k, d in gaps.items() if d]
    note = "; ".join(worst) + (f"; {len(ref['grad']) - len(moving)} quiet "
                               f"leaves left out")
    return numbers, note


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits (n, V) of the reference, tokens (n,): how far each token's
    logit lies below the best one."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]


def gap_summary(gaps: torch.Tensor) -> str:
    """A line on the spread of served tokens' gaps (for the log)."""
    g = gaps.float().sort().values
    q = [float(g[min(len(g) - 1, int(f * len(g)))]) for f in (0.5, 0.9,
                                                              0.99)]
    return (f"n {len(g)} max {float(g[-1]):.4g} p99 {q[2]:.4g} p90 "
            f"{q[1]:.4g} p50 {q[0]:.4g} mean {float(g.mean()):.4g} "
            f"share>0 {float((g > 0).float().mean()):.4g}")
