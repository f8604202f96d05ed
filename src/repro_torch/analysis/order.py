"""Ordering across passes over the event trace of a launch.

The port's counterpart of ``repro.analysis.order``.  ``repro``'s kernels
may carry a ring's prefetch across a pass boundary (``prefetch=
"cross_pass"``); the port runs such plans drained, and its persistent
kernels mark where an agent starts a new unit of work with a ``pass``
event.  The rules replay each CTA's log with :func:`.races.replay`, each
agent in its own pass:

``cross-pass-war``
    A read of a slot whose latest fill, issued in another pass, the reader
    has not waited on (the same hazard within one pass is
    ``ring-slot-war``).
``sem-carryover``
    An issue into a slot while a fill from an earlier pass is still not
    waited on by every reader: the carried fill was not discharged where
    the next pass expected it.
``prefetch-raw``
    The wait that precedes a read is on the copy that filled that slot: a
    wait on an mbarrier other than the one the fill it is due completes on
    synchronises with the wrong copy.
``dma-priority``
    Kept in the catalog without a check: it orders a TPU core's DMA issue
    queue, and a Hopper SM's copy engines keep no such queue.

A drained ring satisfies the first two trivially.  Dynamic, like
``racecheck``: clean over the launches run.
"""
from __future__ import annotations

from typing import List, Optional

from .jaxpr_lint import LintFinding
from .races import Hazard, _findings, replay
from .trace import Launch

RULE_XWAR = "cross-pass-war"
RULE_CARRY = "sem-carryover"
RULE_PRAW = "prefetch-raw"
RULE_PRIO = "dma-priority"

#: the ordering rules and what each checks (or why it has no check)
ORDER_RULES = {
    RULE_XWAR: "a slot read while a fill from another pass is in flight",
    RULE_CARRY: "a fill issued while an earlier pass's fill of its slot "
                "is not waited on",
    RULE_PRAW: "a wait on an mbarrier other than the one its fill "
               "completes on",
    RULE_PRIO: "no check: TPU DMA issue priority, which a Hopper SM's "
               "copy engines do not have",
}


def check_cross_pass_war(launch: Launch,
                         hazards: Optional[List[Hazard]] = None
                         ) -> List[LintFinding]:
    return _findings(launch, replay(launch) if hazards is None else hazards,
                     (RULE_XWAR,))


def check_sem_carryover(launch: Launch,
                        hazards: Optional[List[Hazard]] = None
                        ) -> List[LintFinding]:
    return _findings(launch, replay(launch) if hazards is None else hazards,
                     (RULE_CARRY,))


def check_prefetch_raw(launch: Launch,
                       hazards: Optional[List[Hazard]] = None
                       ) -> List[LintFinding]:
    return _findings(launch, replay(launch) if hazards is None else hazards,
                     (RULE_PRAW,))


def check_dma_priority(launch: Launch) -> List[LintFinding]:
    """No check on the card (see :data:`ORDER_RULES`)."""
    return []


def check_order(launch: Launch,
                hazards: Optional[List[Hazard]] = None) -> List[LintFinding]:
    """The ordering rules over one launch."""
    hz = replay(launch) if hazards is None else hazards
    return (check_cross_pass_war(launch, hz) + check_sem_carryover(launch, hz)
            + check_prefetch_raw(launch, hz) + check_dma_priority(launch))
