"""The port's kernel analyzers on the CPU: the rules over event traces.

The checked kernels run only on the card (``chip_smoke.py --only check``
and ``python -m repro_torch.analysis.jaxpr_lint`` there).  Here the rules
are held against ``repro``'s rule functions: each toy situation of
``tests/test_kernel_analysis.py`` is built by hand as ``repro``'s
``KernelIR`` (its tracer is not called), ``repro``'s ``check_ranges``,
``check_parallel_races``, ``check_ring_war``, ``check_sem_balance`` and
``check_order`` run on it, and the same IR is expanded into the port's
trace (grid points in row-major order, ``seq`` within a point, the
parallel axes' signature as the CTA), on which the port's rules must give
the same set of rule names.  The expansion, per access at every point its
guard admits: a ``dma_dst`` on a ring ref is an ``issue`` into its slot on
its semaphore slot, a ``dma_wait`` a ``wait`` (no parity), a read of a ring
ref a ``read`` and at once a ``release`` (a TPU core's reads finish in
program order), a ``dma_src`` or a read or write of an operand a global
region (a BlockSpec window at its block coordinates), and a VMEM scratch
ref a global workspace the CTAs share (the GPU counterpart of a core's
scratch surviving from one parallel iteration to the next).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import budget as jbudget
from repro.analysis.accesses import Access, Dim, KernelIR, RefInfo
from repro.analysis.jaxpr_lint import RULES as J_RULES
from repro.analysis.order import ORDER_RULES as J_ORDER
from repro.analysis.order import check_order as j_order
from repro.analysis.races import ANALYZER_RULES as J_ANALYZER
from repro.analysis.races import (check_parallel_races as j_races,
                                  check_ring_war as j_ring,
                                  check_sem_balance as j_sem)
from repro.analysis.ranges import check_ranges as j_ranges

from repro_torch.analysis import budget, jaxpr_lint, trace
from repro_torch.analysis.jaxpr_lint import (LOG_RULES, RULES,
                                             CheckUnavailableError,
                                             analyze_callable, check_launch)
from repro_torch.analysis.order import ORDER_RULES
from repro_torch.analysis.races import (ANALYZER_RULES, check_ring_war,
                                        check_sem_balance)
from repro_torch.analysis.trace import records, trace_from_log
from repro_torch.kernels import build

torch = pytest.importorskip("torch")

BASE = 1 << 20          # the synthetic traces' first operand address


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# repro's IR, by hand
# ---------------------------------------------------------------------------


def _ir(name, grid, parallel, refs, accesses, block_coords=None,
        block_bounds=None):
    g = int(np.prod(grid))
    coords = np.unravel_index(np.arange(g), grid)
    sem = tuple("parallel" if a in parallel else "arbitrary"
                for a in range(len(grid)))
    return KernelIR(name=name, grid=tuple(grid), semantics=sem,
                    parallel_axes=tuple(parallel),
                    coords=tuple(np.asarray(c, np.int64) for c in coords),
                    refs=refs, accesses=accesses,
                    block_coords=block_coords or {},
                    block_bounds=block_bounds or {}, scalars={})


def _acc(ref, kind, dims, extent, mask, seq, sem=None, sem_slot=None):
    return Access(ref=ref, kind=kind, dims=tuple(dims), extent=tuple(extent),
                  mask=np.asarray(mask, bool), certain=True, seq=seq,
                  sem=sem, sem_slot=sem_slot)


def _full(shape):
    return [Dim(0, n, True) for n in shape]


def _repro_rules(ir):
    return (_rules(j_ranges(ir)) | _rules(j_races(ir)) | _rules(j_ring(ir))
            | _rules(j_sem(ir)) | _rules(j_order(ir)))


# ---------------------------------------------------------------------------
# the expansion into the port's trace
# ---------------------------------------------------------------------------


def _at(v, p):
    return int(v[p]) if isinstance(v, np.ndarray) else int(v)


def expand(ir: KernelIR, smem: int = 0) -> trace.Launch:
    """The port's trace of ``ir`` (see the module docstring)."""
    rings = sorted({a.ref.name for a in ir.accesses if a.kind == "dma_dst"})
    ops = [r for r in ir.refs if r.name not in rings
           and r.memspace != "semaphore" and r.role != "prefetch"]
    op_id = {r.name: i for i, r in enumerate(ops)}
    ring_id = {n: i for i, n in enumerate(rings)}
    ring_ref = {r.name: r for r in ir.refs if r.name in rings}
    role = {"input": 0, "output": 1, "scratch": 2}
    rows, addr = [], BASE
    blocks = []
    for r in ops:
        rows.append(dict(kind="operand", obj=op_id[r.name],
                         aux=role[r.role], esize=4, a=addr))
        nbytes = 4 * int(np.prod(r.shape))
        blocks.append((addr, nbytes))
        addr += 1 << 16
    for n in rings:
        rows.append(dict(kind="ring", obj=ring_id[n],
                         aux=ring_ref[n].shape[0], v=[0]))
    if ir.parallel_axes:
        sig = np.zeros(ir.n_points, np.int64)
        for ax in ir.parallel_axes:
            sig = sig * ir.grid[ax] + ir.coords[ax]
    else:
        sig = np.zeros(ir.n_points, np.int64)
    events = []
    for p in range(ir.n_points):
        cta = int(sig[p])
        for a in sorted(ir.accesses, key=lambda a: a.seq):
            if not a.mask[p]:
                continue
            name = a.ref.name
            if name in ring_id:
                slot = _at(a.dims[0].start, p)
                g = ring_id[name]
                if a.kind == "dma_dst":
                    events.append(dict(kind="issue", obj=g, slot=slot,
                                       cta=cta,
                                       v=[_at(a.sem_slot, p)]))
                elif a.kind == "dma_wait":
                    events.append(dict(kind="wait", obj=g, slot=slot,
                                       cta=cta, aux=-1,
                                       v=[_at(a.sem_slot, p)]))
                elif a.kind == "read":
                    events.append(dict(kind="read", obj=g, slot=slot,
                                       cta=cta))
                    events.append(dict(kind="release", obj=g, slot=slot,
                                       cta=cta))
                continue
            if name not in op_id or a.kind == "dma_wait":
                continue
            ref = a.ref
            kind = "gread" if a.kind in ("read", "dma_src") else "gwrite"
            if name in ir.block_coords:
                bshape = ref.block_shape
                coords = [_at(c, p) for c in ir.block_coords[name]]
                start = 0
                stride = 1
                for d in reversed(range(len(ref.shape))):
                    start += coords[d] * bshape[d] * stride
                    stride *= ref.shape[d]
                cols = bshape[-1]
                nrows = int(np.prod(bshape[:-1])) if len(bshape) > 1 else 1
                rs = ref.shape[-1]
            else:
                dims = a.dims
                if all(d.full for d in dims):
                    start, nrows, cols, rs = 0, 1, int(np.prod(ref.shape)), 0
                else:
                    start = _at(dims[0].start, p) * int(
                        np.prod(ref.shape[1:]))
                    nrows, cols, rs = 1, int(dims[0].size) * int(
                        np.prod(ref.shape[1:])), 0
            events.append(dict(kind=kind, obj=op_id[name], cta=cta, esize=4,
                               a=start, b=rs, v=[nrows, cols, 1]))
    n_ctas = int(sig.max()) + 1
    begin = dict(kind="begin", v=[n_ctas, 1, 1, 128], a=smem, b=smem)
    recs = records([begin] + rows + events)
    names = " ".join([f"op:{i}:{n}" for n, i in op_id.items()]
                     + [f"ring:{i}:{n}" for n, i in ring_id.items()])
    return trace_from_log(recs.tobytes(), [(0, ir.name)],
                          np.array(blocks, np.int64), names)[0]


def _port_rules(launch, limit=None):
    return _rules(check_launch(launch, limit))


# ---------------------------------------------------------------------------
# the toys of tests/test_kernel_analysis.py
# ---------------------------------------------------------------------------


def _race_toy():
    grid = (2, 2)
    g = 4
    lane, step = np.unravel_index(np.arange(g), grid)
    x = RefInfo("input", 0, "in0", (32, 128), "float32", "blocked", (8, 128))
    o = RefInfo("output", 0, "out0", (32, 128), "float32", "blocked",
                (8, 128))
    acc = RefInfo("scratch", 0, "scratch0", (8, 128), "float32", "vmem")
    every = np.ones(g, bool)
    accs = [_acc(acc, "write", _full((8, 128)), (8, 128),
                 (lane == 0) & (step == 0), 0),
            _acc(acc, "read", _full((8, 128)), (8, 128), every, 1),
            _acc(x, "read", _full((8, 128)), (8, 128), every, 2),
            _acc(acc, "write", _full((8, 128)), (8, 128), every, 3),
            _acc(acc, "read", _full((8, 128)), (8, 128), every, 4),
            _acc(o, "write", _full((8, 128)), (8, 128), every, 5)]
    bc = (lane * 2 + step).astype(np.int64)
    return _ir("toy-race", grid, (0,), [x, o, acc], accs,
               {"in0": (bc, 0), "out0": (bc, 0)},
               {"in0": (4, 1), "out0": (4, 1)})


def _oob_toy():
    i = np.arange(4)
    x = RefInfo("input", 0, "in0", (24,), "float32", "any")
    o = RefInfo("output", 0, "out0", (32,), "float32", "blocked", (8,))
    accs = [_acc(x, "read", [Dim(i * 8, 8, False)], (24,), np.ones(4), 0),
            _acc(o, "write", _full((8,)), (8,), np.ones(4), 1)]
    return _ir("toy-oob", (4,), (), [x, o], accs, {"out0": (i,)},
               {"out0": (4,)})


def _ring_ir(n, depth, ahead, offset, guards=None, name="toy-ring"):
    """A depth-``depth`` DMA ring over ``n`` steps: step s issues the copy
    of step s + ``ahead`` (steps 0 .. ahead - 1 in a prologue at s = 0),
    waits on slot s % depth and reads slot (s + offset) % depth; ``guards``
    (issue, wait, read) masks drop events at some steps."""
    s = np.arange(n)
    hbm = RefInfo("input", 0, "hbm", (8 * n,), "float32", "any")
    o = RefInfo("output", 0, "out0", (8 * n,), "float32", "blocked", (8,))
    buf = RefInfo("scratch", 0, "buf", (depth, 8), "float32", "vmem")
    sem = RefInfo("scratch", 1, "sem", (depth,), "int32", "semaphore")
    g_issue, g_wait, g_read = guards or (np.ones(n, bool),) * 3
    accs, seq = [], 0

    def copy(step, mask):
        nonlocal seq
        slot = np.asarray(step % depth, np.int64)
        accs.append(_acc(hbm, "dma_src", [Dim(np.asarray(step * 8), 8,
                                              False)], (8 * n,), mask, seq))
        accs.append(_acc(buf, "dma_dst", [Dim(slot, 1, False),
                                          Dim(0, 8, True)], (depth, 8), mask,
                         seq + 1, sem=sem, sem_slot=slot))
        seq += 2

    for j in range(min(ahead, n)):
        copy(np.full(n, j), s == 0)
    copy(np.minimum(s + ahead, n - 1), (s + ahead < n) & g_issue)
    slot = (s % depth).astype(np.int64)
    accs.append(_acc(buf, "dma_wait", [Dim(slot, 1, False), Dim(0, 8, True)],
                     (depth, 8), g_wait, seq, sem=sem, sem_slot=slot))
    rd = ((s + offset) % depth).astype(np.int64)
    accs.append(_acc(buf, "read", [Dim(rd, 1, False), Dim(0, 8, True)],
                     (depth, 8), g_read, seq + 1))
    accs.append(_acc(o, "write", _full((8,)), (8,), np.ones(n), seq + 2))
    return _ir(name, (n,), (), [hbm, o, buf, sem], accs, {"out0": (s,)},
               {"out0": (n,)})


def _sem_toy():
    n = 4
    s = np.arange(n)
    hbm = RefInfo("input", 0, "hbm", (8 * n,), "float32", "any")
    o = RefInfo("output", 0, "out0", (8 * n,), "float32", "blocked", (8,))
    buf = RefInfo("scratch", 0, "buf", (1, 8), "float32", "vmem")
    sem = RefInfo("scratch", 1, "sem", (1,), "int32", "semaphore")
    every = np.ones(n, bool)
    accs = [_acc(hbm, "dma_src", [Dim(s * 8, 8, False)], (8 * n,), every, 0),
            _acc(buf, "dma_dst", [Dim(0, 1, False), Dim(0, 8, True)], (1, 8),
                 every, 1, sem=sem, sem_slot=0),
            _acc(buf, "dma_wait", [Dim(0, 1, False), Dim(0, 8, True)], (1, 8),
                 s % 2 == 0, 2, sem=sem, sem_slot=0),
            _acc(o, "write", _full((8,)), (8,), every, 3)]
    return _ir("toy-sem", (n,), (), [hbm, o, buf, sem], accs, {"out0": (s,)},
               {"out0": (n,)})


def _vmem_toy():
    x = RefInfo("input", 0, "in0", (8, 128), "float32", "blocked", (8, 128))
    o = RefInfo("output", 0, "out0", (8, 128), "float32", "blocked",
                (8, 128))
    big = RefInfo("scratch", 0, "scratch0", (2048, 4096), "float32", "vmem")
    accs = [_acc(x, "read", _full((8, 128)), (8, 128), [True], 0),
            _acc(o, "write", _full((8, 128)), (8, 128), [True], 1)]
    return _ir("toy-vmem", (1,), (), [x, o, big], accs,
               {"in0": (0, 0), "out0": (0, 0)},
               {"in0": (1, 1), "out0": (1, 1)})


TOYS = {
    "race": (_race_toy, {"parallel-race"}),
    "oob": (_oob_toy, {"index-range"}),
    "ring-off-by-one": (lambda: _ring_ir(2, 2, 1, 1), {"ring-slot-war"}),
    "ring-correct": (lambda: _ring_ir(2, 2, 1, 0), set()),
    "one-branch-wait": (_sem_toy, {"sem-balance"}),
}


@pytest.mark.parametrize("toy", sorted(TOYS))
def test_toy_rule_sets_match_repro(toy):
    make, want = TOYS[toy]
    ir = make()
    assert _repro_rules(ir) == want
    assert _port_rules(expand(ir)) == want


def test_oob_message_names_the_bad_range():
    found = check_launch(expand(_oob_toy()))
    assert [f.rule for f in found] == ["index-range"]
    assert "[24, 32)" in found[0].message, found[0].message
    assert "24 elements" in found[0].message


def test_sem_toy_message_says_never_waited():
    found = check_launch(expand(_sem_toy()))
    assert any("never waited" in f.message for f in found), found


def test_vmem_hog_budget_matches_repro_and_the_limit_clears_it():
    ir = _vmem_toy()
    need = jbudget.kernel_vmem_bytes(ir)["total"]
    launch = expand(ir, smem=need)
    assert budget.kernel_vmem_bytes(launch)["total"] == need
    for limit in (16 * 2 ** 20, 64 * 2 ** 20):
        assert (_rules(jbudget.check_vmem_budget(ir, limit))
                == _port_rules(launch, limit))
    assert _port_rules(launch, 16 * 2 ** 20) == {"vmem-budget"}
    assert _port_rules(launch, 64 * 2 ** 20) == set()


@settings(max_examples=50, deadline=None)
@given(n=st.integers(2, 6), depth=st.integers(1, 3), ahead=st.integers(0, 3),
       offset=st.integers(0, 2), data=st.data())
def test_random_rings_match_repro(n, depth, ahead, offset, data):
    guards = tuple(np.array(data.draw(st.lists(st.booleans(), min_size=n,
                                               max_size=n)))
                   for _ in range(3))
    ir = _ring_ir(n, depth, ahead, offset, guards, name="random-ring")
    want = _rules(j_ring(ir)) | _rules(j_sem(ir))
    launch = expand(ir)
    got = _rules(check_ring_war(launch)) | _rules(check_sem_balance(launch))
    assert got == want


def test_catalog_covers_every_repro_rule():
    port = {**RULES, **ANALYZER_RULES, **ORDER_RULES}
    names = (set(J_RULES) | set(J_ANALYZER) | set(J_ORDER)
             | {jbudget.RULE, budget.RULE})
    missing = names - set(port)
    assert not missing, missing
    assert all(port[n].strip() for n in names)
    assert set(LOG_RULES) == {"log-overflow", "log-coverage"}


# ---------------------------------------------------------------------------
# the card's patterns, as traces
# ---------------------------------------------------------------------------


def _launch(rows, ops=(("c", 1), ("work", 2), ("ctr", 3)), rings=(),
            ctas=2, blocks=None, overflow=False):
    head = [dict(kind="begin", v=[ctas, 1, 1, 128])]
    for i, (name, role) in enumerate(ops):
        head.append(dict(kind="operand", obj=i, aux=role, esize=4,
                         a=BASE + i * 4096))
    for i, (name, depth, kind) in enumerate(rings):
        head.append(dict(kind="ring", obj=i, aux=depth, v=[kind]))
    names = " ".join([f"op:{i}:{n}" for i, (n, _) in enumerate(ops)]
                     + [f"ring:{i}:{n}" for i, (n, _, _) in enumerate(rings)])
    if blocks is None:
        blocks = np.array([(BASE + i * 4096, 4096) for i in range(len(ops))])
    recs = records([dict(r, launch=7) for r in head + rows])
    return trace_from_log(recs.tobytes(), [(7, "k")], blocks, names,
                          overflow)[0]


def _w(cta, op, start, n, kind="gwrite"):
    return dict(kind=kind, cta=cta, obj=op, esize=4, a=start, v=[1, n, 1])


def test_counter_hand_off_is_accepted_and_its_absence_is_a_race():
    # CTA 0 and 1 write their partials, increment the run's counter; the
    # one that saw the last value (1) reads both
    ok = [_w(0, 1, 0, 16), _w(1, 1, 16, 16),
          dict(kind="counter", cta=0, obj=2, a=0, b=0, aux=2),
          dict(kind="counter", cta=1, obj=2, a=0, b=1, aux=2),
          _w(1, 1, 0, 32, "gread"), _w(1, 0, 0, 16)]
    assert _port_rules(_launch(ok)) == set()
    no_counter = [r for r in ok if r["kind"] != "counter"]
    assert _port_rules(_launch(no_counter)) == {"parallel-race"}
    # the reader saw the counter before its writer incremented it
    early = [ok[0], ok[1], dict(ok[3], b=0), dict(ok[2], b=1), ok[4], ok[5]]
    assert _port_rules(_launch(early)) == {"parallel-race"}
    # three CTAs whose logs land out of the counter's order: the one that
    # saw the last value (2) reads all the partials
    three = [_w(0, 1, 0, 8), _w(1, 1, 8, 8), _w(2, 1, 16, 8),
             dict(kind="counter", cta=0, obj=2, a=0, b=0, aux=3),
             dict(kind="counter", cta=1, obj=2, a=0, b=2, aux=3),
             dict(kind="counter", cta=2, obj=2, a=0, b=1, aux=3),
             _w(1, 1, 0, 24, "gread")]
    assert _port_rules(_launch(three, ctas=3)) == set()
    # a counter not reset before the launch
    stale = [ok[0], ok[1], dict(ok[2], b=3), dict(ok[3], b=4), ok[4], ok[5]]
    found = check_launch(_launch(stale))
    assert _rules(found) == {"parallel-race"}
    assert any("not reset" in f.message for f in found)


def test_disjoint_and_atomic_writes_are_no_race():
    assert _port_rules(_launch([_w(0, 0, 0, 8), _w(1, 0, 8, 8)])) == set()
    both = [_w(0, 0, 0, 8, "gatomic"), _w(1, 0, 4, 8, "gatomic")]
    assert _port_rules(_launch(both)) == set()
    mixed = [_w(0, 0, 0, 8, "gatomic"), _w(1, 0, 4, 8)]
    assert _port_rules(_launch(mixed)) == {"parallel-race"}
    strided = [dict(_w(0, 0, 0, 4), b=16, v=[4, 4, 1]),
               dict(_w(1, 0, 4, 4), b=16, v=[4, 4, 1])]
    assert _port_rules(_launch(strided)) == set()
    assert _port_rules(_launch([dict(strided[0]), dict(strided[1], a=3)])) \
        == {"parallel-race"}


def test_ranges_zero_fill_and_unknown_extent():
    past = dict(_w(0, 0, 1020, 8, "gread"))
    assert _port_rules(_launch([past])) == {"index-range"}
    assert _port_rules(_launch([dict(past, flags=trace.ZERO_FILL)])) == set()
    box = dict(kind="box", cta=0, obj=0, v=[0, 120, 0, 64, 16, 1, 64, 128, 1])
    found = check_launch(_launch([box]))
    assert _rules(found) == {"index-range"}
    assert "[120, 136)" in found[0].message
    assert _port_rules(_launch([dict(box, flags=trace.ZERO_FILL)])) == set()
    lost = _launch([_w(0, 0, 0, 4)], blocks=np.zeros((0, 2), np.int64))
    assert "no live allocation" in check_launch(lost)[0].message


def test_mbarrier_ring_readers_parity_and_refill():
    rings = (("tiles", 2, 0),)

    def ev(kind, slot, who=0, to=None, **kw):
        # v: the mbarrier slot, then 1 + an issue's one reader
        v = [kw.pop("bar", slot)] + ([] if to is None else [to + 1])
        return dict(kind=kind, cta=0, obj=0, slot=slot, who=who, v=v, **kw)

    good = [ev("issue", 0), ev("issue", 1)]
    for i in range(4):
        s, ph = i % 2, (i // 2) & 1
        for who in (1, 2):       # two consumer warpgroups
            good += [ev("wait", s, who, aux=ph), ev("read", s, who),
                     ev("release", s, who)]
        if i + 2 < 4:
            good.append(ev("issue", s))
    assert _port_rules(_launch(good, rings=rings, ctas=1)) == set()
    # warpgroup 2 still reads slot 0 when it is refilled
    late = [ev("issue", 0), ev("issue", 1),
            ev("wait", 0, 1, aux=0), ev("read", 0, 1), ev("release", 0, 1),
            ev("wait", 0, 2, aux=0), ev("read", 0, 2), ev("issue", 0),
            ev("release", 0, 2)]
    assert "ring-slot-war" in _port_rules(_launch(late, rings=rings, ctas=1))
    # two consumer warpgroups taking turns: fill i of the ring is for
    # warpgroup i % 2 + 1 alone, which alone waits on it and releases it
    turns = []
    for i in range(6):
        s, to = i % 2, i % 2 + 1
        turns += [ev("issue", s, to=to), ev("wait", s, to,
                                                   aux=(i // 2) & 1),
                  ev("read", s, to), ev("release", s, to)]
    assert _port_rules(_launch(turns, rings=rings, ctas=1)) == set()
    # warpgroup 1 reads slot 1, whose fill is warpgroup 2's
    stray = turns[:8] + [ev("read", 1, 1)]
    assert _port_rules(_launch(stray, rings=rings, ctas=1)) \
        == {"ring-slot-war"}
    # a wait on the wrong parity returns before the copy lands
    bad = [dict(r, aux=1) if r["kind"] == "wait" and r["slot"] == 0 else r
           for r in good]
    assert _port_rules(_launch(bad, rings=rings, ctas=1)) == {"ring-slot-war"}
    # a wait on another fill's mbarrier
    raw = [dict(r, v=[1]) if r["kind"] == "wait" and r["slot"] == 0 else r
           for r in good]
    assert _port_rules(_launch(raw, rings=rings, ctas=1)) == {"prefetch-raw"}
    # one reader never waits on the last fill
    short = good[:-3]
    assert _port_rules(_launch(short, rings=rings, ctas=1)) == {"sem-balance"}


def test_cp_async_group_ring():
    rings = (("a", 3, 1),)

    def ev(kind, slot=-1, **kw):
        return dict(kind=kind, cta=0, obj=0, slot=slot, v=[slot], **kw)

    rows = [ev("issue", 0), ev("commit"), ev("issue", 1), ev("commit")]
    for it in range(4):
        nxt = it + 2
        rows += [ev("wait", aux=1), ev("read", it % 3),
                 ev("release", it % 3)]
        if nxt < 4:
            rows.append(ev("issue", nxt % 3))
        rows.append(ev("commit"))    # empty groups keep the count uniform
    rows.append(ev("wait", aux=0))
    assert _port_rules(_launch(rows, rings=rings, ctas=1)) == set()
    # waiting with two groups pending reads item it before it lands
    early = [dict(r, aux=2) if r["kind"] == "wait" and r["aux"] == 1 else r
             for r in rows]
    assert "ring-slot-war" in _port_rules(_launch(early, rings=rings, ctas=1))


def test_cross_pass_and_carryover():
    rings = (("tiles", 1, 0),)

    def ev(kind, who=0, **kw):
        return dict(kind=kind, cta=0, obj=0, slot=0, who=who, v=[0], **kw)

    ok = [ev("issue"), ev("wait", 1, aux=0), ev("read", 1),
          ev("release", 1), dict(kind="pass", cta=0, who=0, aux=1),
          ev("issue"), dict(kind="pass", cta=0, who=1, aux=1),
          ev("wait", 1, aux=1), ev("read", 1), ev("release", 1)]
    assert _port_rules(_launch(ok, rings=rings, ctas=1)) == set()
    # the consumer, still in pass 0, reads the fill of pass 1 unwaited
    xwar = ok[:6] + [ev("read", 1)]
    assert "cross-pass-war" in _port_rules(_launch(xwar, rings=rings,
                                                   ctas=1))
    # pass 1's issue while pass 0's fill was never waited on
    carry = [ev("issue"), dict(kind="pass", cta=0, who=0, aux=1),
             ev("issue"), ev("wait", 1, aux=0), ev("wait", 1, aux=1)]
    assert _port_rules(_launch(carry, rings=rings, ctas=1)) \
        == {"sem-carryover"}


# ---------------------------------------------------------------------------
# the decoder, the build and the entry points
# ---------------------------------------------------------------------------


def test_trace_from_log_decodes_and_refuses():
    launch = _launch([_w(0, 0, 0, 4), _w(1, 0, 4, 4)])
    assert launch.grid == (2, 1, 1) and launch.block == 128
    assert launch.operands[0].extent == 4096
    assert launch.operands[2].role == "counter"
    assert launch.kind_counts()["gwrite"] == 2
    assert set(launch.by_cta()) == {0, 1}
    # a record of a launch the table lacks
    recs = records([dict(kind="begin", launch=3)])
    with pytest.raises(ValueError, match="launch table"):
        trace_from_log(recs.tobytes(), [(0, "k")])
    # an unknown kind, a torn record, an undeclared operand
    with pytest.raises(ValueError, match="unknown event kind"):
        trace_from_log(records([dict(kind=99)]).tobytes(), [(0, "k")])
    torn = records([dict(kind="begin"), dict(kind="begin")])
    torn["seq"][1] = 0
    with pytest.raises(ValueError, match="torn"):
        trace_from_log(torn.tobytes(), [(0, "k")])
    with pytest.raises(ValueError, match="never declared"):
        trace_from_log(records([dict(kind="gread", obj=5, site=42)])
                       .tobytes(), [(0, "k")], source="x.cu")
    # an overflowed log is a finding of its own
    full = _launch([_w(0, 0, 0, 4)], overflow=True)
    assert _port_rules(full) == {"log-overflow"}
    # the decoder reads what the card writes: 96-byte records
    assert trace.RECORD_DTYPE.itemsize == 96


def test_nvcc_checked_flags_and_paths(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    rel = build.nvcc_command("x.cu", "x.so")
    chk = build.nvcc_command("x.cu", "x.so", checked=True)
    assert "-DREPRO_CHECKED" in chk and "-lineinfo" in chk
    assert "-DREPRO_CHECKED" not in rel and "-lineinfo" not in rel
    assert [f for f in chk if f not in rel] == list(build.CHECKED_FLAGS)
    for src in build.CHECKED_SOURCES:
        a, b = build.library_path(src), build.library_path(src, checked=True)
        assert a != b and "-checked-" in b.name
    assert set(build.CHECKED_SOURCES) - {"check_toys.cu"} \
        <= set(build.SOURCES)


def test_analyzers_refuse_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(CheckUnavailableError):
        analyze_callable(lambda: None, label="nothing")
    with pytest.raises(RuntimeError, match="CUDA"):
        with build.checked_kernels():
            pass
    with pytest.raises(RuntimeError, match="checked_kernels"):
        build.load("segment_spmm.cu", checked=True)
    with pytest.raises(RuntimeError, match="no checked variant"):
        build.load("not_a_source.cu", checked=True)
    assert jaxpr_lint.main is not None
