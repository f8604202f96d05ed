"""Index ranges over the event trace of a checked launch.

The port's counterpart of ``repro.analysis.ranges``: every global region a
launch read or wrote lies inside its operand's extent (from the operand's
base to the end of the caching allocator's block that holds it), and every
TMA box lies inside its tensor map's dims.  A box or a copy that crosses an
edge is legal on the card (TMA fills zeros past a map's edge, and
``cp.async`` with fewer source bytes fills the rest of its 16), so such an
access is a finding unless its site is declared as relying on zero fill.
The message names the bad range in the access's elements, half-open, as
``repro``'s toy test reads it (``[24, 32)`` of a 24-element operand).

Dynamic, like ``racecheck``: clean over the launches run.

Rule id: ``index-range``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .jaxpr_lint import LintFinding
from .trace import KIND, KINDS, TOP, ZERO_FILL, Launch, region_bytes

RULE = "index-range"


def check_ranges(launch: Launch) -> List[LintFinding]:
    """Every region and box of ``launch`` in bounds; one finding per
    (operand, kind, site) that is not."""
    findings: List[LintFinding] = []
    seen = set()
    recs = launch.records
    regions = recs[np.isin(recs["kind"], [KIND["gread"], KIND["gwrite"],
                                          KIND["gatomic"]])]
    for r in regions:
        op = launch.operands[int(r["obj"])]
        kind = KINDS[int(r["kind"])]
        key = (op.index, kind, int(r["site"]))
        if key in seen:
            continue
        lo, hi = region_bytes(r)
        if op.extent is TOP:
            seen.add(key)
            findings.append(LintFinding(
                rule=RULE,
                message=(f"{kind} on {op.name} at {launch.site(r)}: its "
                         f"base {op.address:#x} lies in no live allocation"),
                kernel=launch.name))
            continue
        if lo >= 0 and hi <= op.extent:
            continue
        if int(r["flags"]) & ZERO_FILL and kind == "gread":
            continue
        seen.add(key)
        es = int(r["esize"]) or 1
        findings.append(LintFinding(
            rule=RULE,
            message=(f"{kind} on {op.name} at {launch.site(r)}: elements "
                     f"[{lo // es}, {-(-hi // es)}) exceed its extent of "
                     f"{op.extent // es} elements"),
            kernel=launch.name))
    for r in recs[recs["kind"] == KIND["box"]]:
        if int(r["flags"]) & ZERO_FILL:
            continue
        op = launch.operand_name(int(r["obj"]))
        c, e, d = r["v"][0:3], r["v"][3:6], r["v"][6:9]
        for ax in range(3):
            lo, hi, dim = int(c[ax]), int(c[ax]) + int(e[ax]), int(d[ax])
            if 0 <= lo and hi <= dim:
                continue
            key = (op, "box", int(r["site"]), ax)
            if key in seen:
                continue
            seen.add(key)
            findings.append(LintFinding(
                rule=RULE,
                message=(f"TMA box on {op} at {launch.site(r)} dim {ax}: "
                         f"[{lo}, {hi}) crosses the map's edge {dim} at a "
                         f"site not declared to rely on zero fill"),
                kernel=launch.name))
    return findings
