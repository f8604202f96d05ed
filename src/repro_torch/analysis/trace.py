"""The event trace of one checked kernel launch, decoded from the card's log.

The port's counterpart of ``repro.analysis.accesses``.  ``repro`` derives
its access IR from a kernel's jaxpr by abstract interpretation over a
fixed grid of (point, program-order ``seq``); a warp-specialised Hopper
kernel does not fit that grid (its producer refills slot s for item
i + depth while a consumer is still at item i, so any fixed ``seq``
misorders the refill).  So the port's IR is *log-ordered per CTA*: the
checked build of the kernels (``csrc/check.cuh``) appends one record per
event to a device log, each record's place given by one atomic on the
log's write index, and every event is logged on the right side of the
barrier that orders it (a release before the arrive that publishes it, an
issue or a read after the wait that permits it).  A CTA's records in log
order therefore follow the happens-before order of its barriers, and the
rules of :mod:`.ranges`, :mod:`.races`, :mod:`.order` and :mod:`.budget`
are restated over that order.

What stays as in ``repro``: :data:`READ_KINDS` / :data:`WRITE_KINDS`, an
operand table (``RefInfo`` there, :class:`Operand` here, with a role of
``input``, ``output``, ``workspace`` or ``counter`` and an extent), and
:data:`TOP` for a value the trace does not know (an operand whose base
lies in no live allocation has extent ``TOP``).  What differs: the events
are those of one launch as run, not of every grid point as traced, so a
clean trace is *dynamic, like racecheck: clean over the launches run*;
``repro``'s "unprovable" findings have no counterpart.

Event kinds (``csrc/check.cuh``'s ``ck::Kind``): ring ``issue`` into a
slot (``repro``'s ``dma_dst`` / ``dma_start``), ring ``wait``, ``read``
of a slot's shared memory, ``release`` of a slot, ``commit`` of a
cp.async group, global ``gread`` / ``gwrite`` / ``gatomic`` of a strided
region, a TMA ``box`` read, ``counter`` increment with the value it saw,
``pass`` boundary, and the launch's resources (``begin``: grid, block,
dynamic and total shared memory).

:func:`trace_from_log` decodes one launcher call's log
(:class:`repro_torch.kernels.build.CheckedCall`) into :class:`Launch`
objects; :func:`records` builds the same arrays from Python, which is how
the CPU tests state a trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

TOP = None          #: a value the trace does not know

#: one record of the device log (``ck::Record``, 96 bytes)
RECORD_DTYPE = np.dtype([
    ("seq", "<u4"), ("launch", "<u4"), ("cta", "<u4"), ("site", "<u2"),
    ("kind", "u1"), ("flags", "u1"), ("obj", "<i2"), ("slot", "<i2"),
    ("who", "<i2"), ("esize", "<i2"), ("aux", "<i4"), ("pad", "<i4"),
    ("a", "<i8"), ("b", "<i8"), ("v", "<i4", (12,))])
assert RECORD_DTYPE.itemsize == 96

KINDS = {1: "begin", 2: "operand", 3: "ring", 4: "issue", 5: "wait",
         6: "read", 7: "release", 8: "commit", 9: "gread", 10: "gwrite",
         11: "gatomic", 12: "box", 13: "counter", 14: "pass"}
KIND = {name: k for k, name in KINDS.items()}
ROLES = ("input", "output", "workspace", "counter")
RING_KINDS = ("mbarrier", "cp.async group")
ZERO_FILL = 1       #: ``ck::kZeroFill``: the site relies on zero fill

READ_KINDS = ("gread", "box")
WRITE_KINDS = ("gwrite", "gatomic")


@dataclasses.dataclass(frozen=True)
class Operand:
    """One global operand of a launch: its name, role, base address,
    element bytes and extent in bytes from its base (``TOP``: its base
    lies in no live allocation)."""

    index: int
    name: str
    role: str
    address: int
    esize: int
    extent: Optional[int]


@dataclasses.dataclass(frozen=True)
class Ring:
    """A ring of shared-memory slots: its depth and kind (``mbarrier`` or
    ``cp.async group``)."""

    index: int
    name: str
    depth: int
    kind: str


@dataclasses.dataclass
class Launch:
    """The decoded trace of one kernel launch."""

    name: str
    launch_id: int
    grid: Tuple[int, int, int]
    block: int
    dynamic_smem: int
    static_smem: int
    operands: Dict[int, Operand]
    rings: Dict[int, Ring]
    #: the launch's records in log order
    records: np.ndarray
    overflow: bool = False
    source: str = ""

    def by_cta(self) -> Dict[int, np.ndarray]:
        """Each CTA's records, in log order."""
        out: Dict[int, np.ndarray] = {}
        if not self.records.size:
            return out
        order = np.argsort(self.records["cta"], kind="stable")
        recs = self.records[order]
        ctas, starts = np.unique(recs["cta"], return_index=True)
        bounds = list(starts[1:]) + [len(recs)]
        for c, s, e in zip(ctas, starts, bounds):
            out[int(c)] = recs[s:e]
        return out

    def kind_counts(self) -> Dict[str, int]:
        ks, n = np.unique(self.records["kind"], return_counts=True)
        return {KINDS.get(int(k), str(k)): int(c) for k, c in zip(ks, n)}

    def operand_name(self, op: int) -> str:
        o = self.operands.get(op)
        return o.name if o is not None else f"op{op}"

    def ring_name(self, r: int) -> str:
        g = self.rings.get(r)
        return g.name if g is not None else f"ring{r}"

    def site(self, rec) -> str:
        return f"{self.source or self.name}:{int(rec['site'])}"


def records(rows: Iterable[dict]) -> np.ndarray:
    """A record array from dicts of fields (``kind`` by name or number;
    ``seq`` defaults to the row's place, ``v`` to zeros)."""
    rows = list(rows)
    out = np.zeros(len(rows), dtype=RECORD_DTYPE)
    for i, row in enumerate(rows):
        row = dict(row)
        kind = row.pop("kind")
        out[i]["kind"] = KIND[kind] if isinstance(kind, str) else kind
        out[i]["seq"] = row.pop("seq", i + 1)
        v = row.pop("v", ())
        out[i]["v"][:len(v)] = v
        for k, val in row.items():
            out[i][k] = val
    return out


def parse_names(text: str) -> Tuple[Dict[int, str], Dict[int, str]]:
    """``CK_NAMES``' text (``op:<id>:<name> ring:<id>:<name>``) as
    ``(operand names, ring names)``."""
    ops: Dict[int, str] = {}
    rings: Dict[int, str] = {}
    for tok in text.split():
        kind, idx, name = tok.split(":", 2)
        (ops if kind == "op" else rings)[int(idx)] = name
    return ops, rings


def _extent(address: int, blocks: Optional[np.ndarray]) -> Optional[int]:
    if blocks is None or address == 0 or not len(blocks):
        return TOP
    starts, sizes = blocks[:, 0], blocks[:, 1]
    hit = np.nonzero((starts <= address) & (address < starts + sizes))[0]
    if not hit.size:
        return TOP
    i = int(hit[0])
    return int(starts[i] + sizes[i] - address)


def trace_from_log(buffer, launch_table: Sequence[Tuple[int, str]],
                   blocks: Optional[np.ndarray] = None, names: str = "",
                   overflow: bool = False,
                   source: str = "") -> List[Launch]:
    """Decode one launcher call's log.

    ``buffer`` is the log's records (bytes or a :data:`RECORD_DTYPE`
    array), ``launch_table`` the ``(id, name)`` of each launch the call
    numbered, ``blocks`` the caching allocator's live blocks as
    ``(address, bytes)`` rows (the operands' extents), ``names`` the
    library's ``CK_NAMES`` text.  Returns one :class:`Launch` per entry of
    the table, in its order, each flagged ``overflow`` when the log
    overflowed.  Raises ``ValueError`` on a record the decoder cannot
    place: a torn or unwritten record, an unknown kind, a launch the table
    lacks, or a ring event or region on an operand or ring the launch
    never declared (a TMA box carries its map's dims and needs no
    declaration: a kernel that reads an operand only through a tensor map
    has no pointer to declare).
    """
    recs = (np.frombuffer(buffer, dtype=RECORD_DTYPE)
            if isinstance(buffer, (bytes, bytearray, memoryview))
            else np.asarray(buffer, dtype=RECORD_DTYPE))
    torn = np.nonzero(recs["seq"] != np.arange(1, len(recs) + 1))[0]
    if torn.size:
        raise ValueError(f"log record {int(torn[0])} is torn or was never "
                         f"written (seq {int(recs['seq'][torn[0]])})")
    bad = ~np.isin(recs["kind"], list(KINDS))
    if bad.any():
        r = recs[np.nonzero(bad)[0][0]]
        raise ValueError(f"{source}:{int(r['site'])}: unknown event kind "
                         f"{int(r['kind'])}")
    ids = {int(i): n for i, n in launch_table}
    stray = ~np.isin(recs["launch"], list(ids))
    if stray.any():
        r = recs[np.nonzero(stray)[0][0]]
        raise ValueError(f"{source}:{int(r['site'])}: a record of launch "
                         f"{int(r['launch'])}, which the launch table "
                         f"({sorted(ids)}) lacks")
    op_names, ring_names = parse_names(names)
    out: List[Launch] = []
    for lid, lname in launch_table:
        mine = recs[recs["launch"] == lid]
        begin = mine[mine["kind"] == KIND["begin"]]
        if len(begin):
            b = begin[0]
            grid = tuple(int(x) for x in b["v"][:3])
            block, dyn, total = int(b["v"][3]), int(b["a"]), int(b["b"])
        else:
            grid, block, dyn, total = (0, 0, 0), 0, 0, 0
        operands: Dict[int, Operand] = {}
        for r in mine[mine["kind"] == KIND["operand"]]:
            op = int(r["obj"])
            operands[op] = Operand(
                op, op_names.get(op, f"op{op}"), ROLES[int(r["aux"])],
                int(r["a"]), int(r["esize"]), _extent(int(r["a"]), blocks))
        rings: Dict[int, Ring] = {}
        for r in mine[mine["kind"] == KIND["ring"]]:
            g = int(r["obj"])
            rings[g] = Ring(g, ring_names.get(g, f"ring{g}"), int(r["aux"]),
                            RING_KINDS[int(r["v"][0])])
        for kinds, table, what in (
                (("gread", "gwrite", "gatomic", "counter"), operands,
                 "operand"),
                (("issue", "wait", "read", "release", "commit"), rings,
                 "ring")):
            sel = mine[np.isin(mine["kind"], [KIND[k] for k in kinds])]
            unknown = ~np.isin(sel["obj"], list(table) or [-(1 << 15)])
            if unknown.any():
                r = sel[np.nonzero(unknown)[0][0]]
                raise ValueError(
                    f"{source}:{int(r['site'])}: {KINDS[int(r['kind'])]} on "
                    f"{what} {int(r['obj'])}, which launch {lname!r} never "
                    f"declared")
        out.append(Launch(
            name=lname, launch_id=lid, grid=grid, block=block,
            dynamic_smem=dyn, static_smem=total - dyn, operands=operands,
            rings=rings, records=mine, overflow=overflow, source=source))
    return out


def traces_from_run(run) -> List[Launch]:
    """Every launch of a :class:`repro_torch.kernels.build.CheckedRun`."""
    out: List[Launch] = []
    for call in run.calls:
        out.extend(trace_from_log(call.records, call.launches, call.blocks,
                                  call.names, call.overflow, call.source))
    return out


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------


def region_bytes(rec) -> Tuple[int, int]:
    """``[lo, hi)`` in bytes from the operand's base of a region record
    (``gread`` / ``gwrite`` / ``gatomic``): rows x cols elements, row r and
    column j at ``a + r * b + j * v[2]``."""
    es = int(rec["esize"]) or 1
    start, rs = int(rec["a"]), int(rec["b"])
    rows, cols, cs = int(rec["v"][0]), int(rec["v"][1]), int(rec["v"][2])
    if rows <= 0 or cols <= 0:
        return start * es, start * es
    ends = [start, start + (rows - 1) * rs, start + (cols - 1) * cs,
            start + (rows - 1) * rs + (cols - 1) * cs]
    return min(ends) * es, (max(ends) + 1) * es


def region_elements(rec) -> np.ndarray:
    """Every element offset (in the record's element size) a region
    record covers."""
    start, rs = int(rec["a"]), int(rec["b"])
    rows, cols, cs = int(rec["v"][0]), int(rec["v"][1]), int(rec["v"][2])
    if rows <= 0 or cols <= 0:
        return np.zeros(0, dtype=np.int64)
    r = np.arange(rows, dtype=np.int64)[:, None] * rs
    c = np.arange(cols, dtype=np.int64)[None, :] * cs
    return (start + r + c).reshape(-1)
