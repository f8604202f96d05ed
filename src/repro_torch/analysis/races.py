"""Races, ring-slot WAR and ring balance over the event trace of a launch.

The port's counterpart of ``repro.analysis.races``: three rules over the
log-ordered trace of :mod:`.trace`.

``parallel-race``
    No two CTAs write overlapping global regions, and no CTA reads a region
    another CTA writes.  Two exceptions: regions that both CTAs accumulate
    atomically (``gatomic``), and the counter hand-off, where the CTA that
    saw a counter's last value reads partials whose writers logged their
    increment of that counter after writing them.  A counter's increments
    must see 0, 1, ... each once (so it was reset for this launch), and
    where the kernel says how many to expect, as many as it says.  The
    rule works over the stores that happened, so run-time assignment (a
    work-stealing counter) needs no plan.  ``repro``'s scratch-leak case is
    this rule's global-workspace case on the card: a CTA's shared memory
    does not outlive it.

``ring-slot-war``
    Each CTA's log replayed with, for each (ring, slot), its fills and how
    many of them each reader (an agent: the CTA, or a warpgroup) has waited
    on.  A fill is for every reader of its ring, or for the one its issue
    names (a ring whose consumers take turns).  A read of a slot whose latest fill the reader has not waited on is
    a finding, and so is an issue into a slot that some reader has read
    and not released since.  A wait on an mbarrier whose parity is not the
    phase of the fill it is due returns early, and is a finding too.  The
    waits of a cp.async group ring complete every fill whose group is
    older than the groups left pending.

``sem-balance``
    At the end of each CTA every fill has been waited on by every reader
    of its ring ("never waited" otherwise), and every wait found a fill to
    wait on ("no matching issue" otherwise).  Balance at a pass boundary
    is :mod:`.order`'s ``sem-carryover``.

Dynamic, like ``racecheck``: clean over the launches run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .jaxpr_lint import LintFinding
from .trace import KIND, KINDS, Launch, region_elements

RULE_RACE = "parallel-race"
RULE_RING = "ring-slot-war"
RULE_SEM = "sem-balance"

#: the dynamic analyzer's rules and what each checks; ``index-range``
#: lives in :mod:`.ranges`, ``vmem-budget`` in :mod:`.budget`
ANALYZER_RULES = {
    "index-range": "a global region or TMA box outside its operand's "
                   "extent, past an edge at a site not declared zero fill",
    RULE_RACE: "two CTAs write one region, or one reads what another "
               "writes, outside atomics and the counter hand-off",
    RULE_RING: "a ring slot read before its fill was waited on, or "
               "refilled while a reader still holds it",
    RULE_SEM: "a fill never waited on, or a wait with no fill, at the end "
              "of a CTA",
    "vmem-budget": "a launch's static + dynamic shared memory over the "
                   "limit",
}

_RING_KINDS = [KIND[k] for k in ("issue", "wait", "read", "release",
                                 "commit", "pass")]


# ---------------------------------------------------------------------------
# the ring replay (shared with order.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Fill:
    pass_: int          # the issuing agent's pass
    bar: int            # the mbarrier slot it completes on
    group: int          # its cp.async group (-1: an mbarrier ring)
    to: int = -1        # its one reader (-1: every reader of the ring)


@dataclasses.dataclass
class Hazard:
    rule: str
    key: tuple          # one finding per key
    message: str


def replay(launch: Launch) -> List[Hazard]:
    """Every ring hazard of ``launch``, from each CTA's log in order."""
    hazards: List[Hazard] = []
    for cta, recs in launch.by_cta().items():
        hazards.extend(_replay_cta(launch, cta,
                                   recs[np.isin(recs["kind"], _RING_KINDS)]))
    return hazards


def _replay_cta(launch: Launch, cta: int, recs) -> List[Hazard]:
    out: List[Hazard] = []
    fills: Dict[Tuple[int, int], List[Fill]] = {}
    waited: Dict[Tuple[int, int, int], int] = {}
    holding: Dict[Tuple[int, int, int], bool] = {}
    readers: Dict[int, Set[int]] = {}
    commits: Dict[int, int] = {}
    passes: Dict[int, int] = {}

    def name(r):
        return launch.ring_name(int(r))

    def group_ring(g):
        ring = launch.rings.get(g)
        return ring is not None and ring.kind == "cp.async group"

    def mine(q, rd):
        """Reader rd's queue of a slot: the fills it is to wait on, with
        their places among the slot's fills."""
        return [(i, f) for i, f in enumerate(q) if f.to in (-1, rd)]

    def open_fills(g, s, q):
        """The fills of a slot some reader of theirs has not waited on."""
        out = []
        for rd in readers.get(g) or {0}:
            for k, (i, f) in enumerate(mine(q, rd)):
                if waited.get((g, s, rd), 0) <= k:
                    out.append(f)
        return out

    for r in recs:
        kind = KINDS[int(r["kind"])]
        who = int(r["who"])
        site = launch.site(r)
        if kind == "pass":
            passes[who] = int(r["aux"])
            continue
        g, s = int(r["obj"]), int(r["slot"])
        if kind == "commit":
            commits[g] = commits.get(g, 0) + 1
            continue
        q = fills.setdefault((g, s), []) if s >= 0 else None
        if kind == "issue":
            for rd in sorted(readers.get(g, ())):
                if holding.get((g, s, rd)):
                    out.append(Hazard(
                        RULE_RING, (g, s, "refill"),
                        f"slot {s} of {name(g)} refilled at {site} in CTA "
                        f"{cta} while reader {rd} still holds it (read, "
                        f"not released)"))
            p = passes.get(who, 0)
            carried = [f for f in open_fills(g, s, q) if f.pass_ != p]
            if carried:
                out.append(Hazard(
                    "sem-carryover", (g, s),
                    f"slot {s} of {name(g)}: issue at {site} in CTA {cta} "
                    f"(pass {p}) while a fill from pass {carried[0].pass_} "
                    f"is still not waited on: balance does not hold at the "
                    f"pass boundary"))
            q.append(Fill(p, int(r["v"][0]),
                          commits.get(g, 0) if group_ring(g) else -1,
                          int(r["v"][1]) - 1))
        elif kind == "wait":
            if s < 0:                       # cp.async groups: pending = aux
                done = commits.get(g, 0) - int(r["aux"])
                readers.setdefault(g, set()).add(0)
                for (gg, ss), fq in fills.items():
                    if gg != g:
                        continue
                    n = sum(1 for f in fq if 0 <= f.group < done)
                    key = (g, ss, 0)
                    waited[key] = max(waited.get(key, 0), n)
                continue
            readers.setdefault(g, set()).add(who)
            key = (g, s, who)
            k = waited.get(key, 0)
            rq = mine(q, who)
            if k >= len(rq):
                out.append(Hazard(
                    RULE_SEM, (g, s, "nofill"),
                    f"slot {s} of {name(g)}: wait at {site} in CTA {cta} "
                    f"has no matching issue"))
                continue
            gk, f = rq[k]
            if f.bar != int(r["v"][0]):
                out.append(Hazard(
                    "prefetch-raw", (g, s),
                    f"slot {s} of {name(g)}: wait at {site} in CTA {cta} is "
                    f"on mbarrier {int(r['v'][0])} but the fill it is due "
                    f"completes on {f.bar}: the read does not wait on the "
                    f"copy that filled the slot"))
            # fill gk of the slot completes the mbarrier's phase gk
            parity = int(r["aux"])
            if parity >= 0 and parity != (gk & 1):
                out.append(Hazard(
                    RULE_RING, (g, s, "parity"),
                    f"slot {s} of {name(g)}: wait at {site} in CTA {cta} on "
                    f"parity {parity}, but its fill {gk} completes phase "
                    f"parity {gk & 1}: the wait returns before the copy "
                    f"lands"))
            waited[key] = k + 1
        elif kind == "read":
            readers.setdefault(g, set()).add(who)
            key = (g, s, who)
            k = waited.get(key, 0)
            if q and (q[-1].to not in (-1, who) or k < len(mine(q, who))):
                f = q[-1]
                p = passes.get(who, 0)
                if f.pass_ != p:
                    out.append(Hazard(
                        "cross-pass-war", (g, s),
                        f"slot {s} of {name(g)} read at {site} in CTA {cta} "
                        f"(pass {p}) while a fill issued in pass {f.pass_} "
                        f"is still in flight"))
                else:
                    out.append(Hazard(
                        RULE_RING, (g, s, "read"),
                        f"slot {s} of {name(g)} read at {site} in CTA {cta} "
                        f"by reader {who} while its fill is still in flight "
                        f"(issued {len(q)}, waited {k})"))
            holding[key] = True
        elif kind == "release":
            holding[(g, s, who)] = False
    for (g, s), q in fills.items():
        for rd in sorted(readers.get(g) or {0}):
            left = len(mine(q, rd)) - waited.get((g, s, rd), 0)
            if left > 0:
                out.append(Hazard(
                    RULE_SEM, (g, s, "left"),
                    f"slot {s} of {name(g)}: {left} fill(s) in CTA {cta} "
                    f"never waited on by reader {rd}"))
    return out


def _findings(launch: Launch, hazards: List[Hazard],
              rules) -> List[LintFinding]:
    seen = set()
    out = []
    for h in hazards:
        if h.rule not in rules or (h.rule, h.key) in seen:
            continue
        seen.add((h.rule, h.key))
        out.append(LintFinding(rule=h.rule, message=h.message,
                               kernel=launch.name))
    return out


def check_ring_war(launch: Launch,
                   hazards: Optional[List[Hazard]] = None
                   ) -> List[LintFinding]:
    """The ``ring-slot-war`` rule."""
    return _findings(launch, replay(launch) if hazards is None else hazards,
                     (RULE_RING,))


def check_sem_balance(launch: Launch,
                      hazards: Optional[List[Hazard]] = None
                      ) -> List[LintFinding]:
    """The ``sem-balance`` rule."""
    return _findings(launch, replay(launch) if hazards is None else hazards,
                     (RULE_SEM,))


# ---------------------------------------------------------------------------
# parallel-race
# ---------------------------------------------------------------------------


def _bytes_of(rec) -> np.ndarray:
    es = int(rec["esize"]) or 1
    el = region_elements(rec) * es
    return (el[:, None] + np.arange(es)[None, :]).reshape(-1)


def _counter_events(launch: Launch, by_cta) -> Tuple[list, dict]:
    """The hand-offs: ``{(op, index): [(cta, position in its log, value,
    expected), ...]}`` sorted by the value each increment saw (the
    counter's own order: the log's order between CTAs is another
    atomic's), and the findings of counters whose values are not 0, 1,
    ... each once, or fall short of what the kernel expects."""
    recs = launch.records
    ctr = recs[recs["kind"] == KIND["counter"]]
    pos = {}
    for cta, rs in by_cta.items():
        for i, seq in enumerate(rs["seq"]):
            pos[int(seq)] = (cta, i)
    counters: Dict[Tuple[int, int], list] = {}
    for r in ctr:
        cta, i = pos[int(r["seq"])]
        counters.setdefault((int(r["obj"]), int(r["a"])), []).append(
            (cta, i, int(r["b"]), int(r["aux"])))
    findings = []
    for (op, idx), evs in counters.items():
        evs.sort(key=lambda e: e[2])
        vals = [v for _, _, v, _ in evs]
        exp = max(e for _, _, _, e in evs)
        if vals != list(range(len(vals))):
            findings.append(
                f"counter {launch.operand_name(op)}[{idx}] saw values "
                f"{vals[:8]}, not 0, 1, ... each once: it was not reset "
                f"before this launch")
        elif exp and len(vals) != exp:
            findings.append(
                f"counter {launch.operand_name(op)}[{idx}] was incremented "
                f"{len(vals)} times where the kernel expects {exp}: no CTA "
                f"saw the last value")
    return counters, findings


def check_parallel_races(launch: Launch) -> List[LintFinding]:
    """The ``parallel-race`` rule over the regions the launch touched."""
    findings: List[LintFinding] = []
    by_cta = launch.by_cta()
    counters, bad = _counter_events(launch, by_cta)
    findings += [LintFinding(rule=RULE_RACE, message=m, kernel=launch.name)
                 for m in bad]
    touched: Dict[int, list] = {}      # op -> [(cta, position, rec, bytes)]
    for cta, rs in by_cta.items():
        for i, r in enumerate(rs):
            kind = KINDS[int(r["kind"])]
            if kind not in ("gread", "gwrite", "gatomic"):
                continue
            op = int(r["obj"])
            if launch.operands[op].role == "counter":
                continue
            touched.setdefault(op, []).append((cta, i, r, _bytes_of(r)))
    for op, accs in touched.items():
        size = max((int(b.max()) + 1 for *_, b in accs if b.size),
                   default=0)
        owner = np.full(size, -1, np.int64)      # the last plain writer
        at = np.full(size, -1, np.int64)         # its log position
        a_owner = np.full(size, -1, np.int64)    # an atomic writer
        a_multi = np.zeros(size, bool)           # atomics by several CTAs
        name = launch.operand_name(op)
        hit = None
        for cta, i, r, b in accs:
            kind = KINDS[int(r["kind"])]
            if kind == "gread" or hit is not None:
                continue
            o = owner[b]
            clash = (o >= 0) & (o != cta)
            if kind == "gwrite":
                clash |= (a_owner[b] >= 0) & ((a_owner[b] != cta)
                                              | a_multi[b])
                owner[b], at[b] = cta, i
            else:
                a = a_owner[b]
                a_multi[b] |= (a >= 0) & (a != cta)
                a_owner[b] = np.where(a >= 0, a, cta)
            if clash.any():
                j = int(np.nonzero(clash)[0][0])
                other = int(o[j]) if o[j] >= 0 and o[j] != cta \
                    else int(a_owner[b][j])
                hit = LintFinding(
                    rule=RULE_RACE,
                    message=(f"{name} byte {int(b[j])} is written by CTAs "
                             f"{other} and {cta} ({launch.site(r)})"),
                    kernel=launch.name)
        if hit is not None:
            findings.append(hit)
            continue
        for cta, i, r, b in accs:
            if KINDS[int(r["kind"])] != "gread" or not b.size:
                continue
            o, pos = owner[b], at[b]
            writers: Dict[int, int] = {}
            for w in np.unique(o[(o >= 0) & (o != cta)]):
                writers[int(w)] = int(pos[o == w].max())
            a = a_owner[b]
            for w in np.unique(a[(a >= 0) & ((a != cta) | a_multi[b])]):
                writers.setdefault(int(w), -1)
            late = [w for w, wpos in sorted(writers.items())
                    if not _handed_off(counters, w, wpos, cta, i)]
            if late:
                hit = LintFinding(
                    rule=RULE_RACE,
                    message=(f"{name} read by CTA {cta} at {launch.site(r)} "
                             f"overlaps what CTA {late[0]} writes, with no "
                             f"counter hand-off between them"),
                    kernel=launch.name)
                break
        if hit is not None:
            findings.append(hit)
    return findings


def _handed_off(counters, writer, wpos, reader, rpos) -> bool:
    """A counter the writer incremented after its write (``wpos``; -1 for
    an atomic write, which needs no order) and whose last value the reader
    saw before its read (``rpos``): the atomic orders every other
    increment before the one that saw the last value."""
    for (cop, idx), evs in counters.items():
        last = evs[-1]
        if last[0] != reader or last[1] > rpos:
            continue
        if any(c == writer and i > wpos for c, i, _, _ in evs):
            return True
    return False
