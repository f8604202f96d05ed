"""The port's plan verifier against ``repro``'s: every mutation of
``tests/test_analysis.py``'s kill battery applied to leaf-equal plans of
both packages gives equal ``VerifyResult``s (invariant, message, lane,
item, stream, path); every catalog id is killed; clean plans verify clean
over the knob grid (policy x fold x lanes x unroll x the five storage
modes, SpMM with grad plans and SpGEMM); degenerate plans; the planner's
``verify=`` and its template cache; ``execute_plan(verify=)``;
``SegmentPlan.verify`` / ``.traffic`` / ``.lane_len``; the knobs that
still raise; and SpMM plans with 32x64, 64x32, 16x16 and 128x128 blocks
(verified clean in both packages, products within 1e-6 of ``repro``'s
reference backend)."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.analysis import INVARIANTS as JAX_INVARIANTS  # noqa: E402
from repro.analysis import verify_plan as jax_verify  # noqa: E402
from repro.api.plan import _AUX_FIELDS, _LEAF_FIELDS  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.analysis import (INVARIANTS,  # noqa: E402
                                  PlanVerificationError, verify_plan)
from repro_torch.api import executor, planner  # noqa: E402
from repro_torch.core.formats import BSR, QUANT_MODES, quantize_blocks  # noqa: E402

MODES = (None,) + QUANT_MODES


def _mat(seed=2, shape=(256, 256), block=(32, 32), density=0.5):
    a = BSR.random(np.random.default_rng(seed), shape, block, density)
    return a, JaxBSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _same_plan(got, want):
    for f in _AUX_FIELDS:
        if f not in ("fingerprint", "backend"):
            assert getattr(got, f) == getattr(want, f), f
    for f in _LEAF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if f == "grad_plan" and w is not None:
            _same_plan(g, w)
        elif w is not None:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f)


def _pair(b=None, jb=None, mat=None, **kw):
    """Leaf-equal plans of both packages for one pattern and knobs."""
    a, ja = mat or _mat()
    kw.setdefault("policy", "segment")
    kw.setdefault("cache", False)
    got = api.plan_matmul(a, b, device="cpu", **kw)
    want = japi.plan_matmul(ja, jb, **kw)
    _same_plan(got, want)
    return got, want


def _result(res):
    return (tuple(dataclasses.astuple(f) for f in res.findings), res.level,
            res.checked)


def _both(got, want, **kw):
    """The two verifiers' results (``level="full"``), asserted equal; the
    reported invariant ids."""
    r, jr = (verify_plan(got, level="full", **kw),
             jax_verify(want, level="full", **kw))
    assert _result(r) == _result(jr)
    return sorted({f.invariant for f in r.findings})


@pytest.fixture(scope="module")
def plans():
    got, want = _pair(n_lanes=2, unroll=2)
    assert got.has_pads and verify_plan(got, level="full").ok
    return got, want


def _mutated(plans, fn):
    """Apply one numpy mutation (``fn(leaves) -> replace kwargs``) to both
    plans: numpy arrays into ``repro``'s, torch tensors into the port's."""
    got, want = plans
    leaves = {f: _np(getattr(got, f)).copy() for f in _LEAF_FIELDS
              if f != "grad_plan" and getattr(got, f) is not None}
    kw = fn(leaves, got)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    return got.replace(**tkw), want.replace(**kw)


# ---------------------------------------------------------------------------
# the kill battery, one corruption per invariant (tests/test_analysis.py)
# ---------------------------------------------------------------------------


def _seg_structure(lv, p):
    m, v, ss = lv["m_idx"], lv["valid"], lv["seg_start"]
    i = next(i for i in range(1, p.n_items)
             if v[i] and v[i - 1] and m[i] != m[i - 1] and ss[i] == 1
             and i % p.lane_len != 0)
    ss[i] = 0
    return dict(seg_start=ss)


def _accum_prev(lv, p):
    v, ss, ap = lv["valid"], lv["seg_start"], lv["accum_prev"]
    heads = [i for i in range(p.n_items) if v[i] and ss[i] == 1
             and ap[i] == 0]
    ap[heads[0]] = 1
    return dict(accum_prev=ap)


def _pad_fetch(lv, p):
    f = lv["a_fetch"]
    f[np.nonzero(lv["valid"] == 0)[0][0]] = 1
    return dict(a_fetch=f)


def _lane_first(lv, p):
    f = lv["b_fetch"]
    f[0] = 0
    return dict(b_fetch=f)


def _fetch_on_change(lv, p):
    v, f = lv["valid"], lv["b_fetch"]
    i = next(i for i in range(p.n_items)
             if v[i] and f[i] == 0 and i % p.lane_len != 0)
    f[i] = 1
    return dict(b_fetch=f)


def _slot_advance(lv, p):
    s = lv["a_slot"]
    fi = np.nonzero(lv["a_fetch"] == 1)[0]
    i1, i2 = int(fi[1]), int(fi[2])
    assert s[i1] != s[i2]
    s[i1], s[i2] = s[i2], s[i1]
    return dict(a_slot=s)


def _ring_war(lv, p):
    f, s = lv["a_fetch"], lv["a_slot"]
    for j in np.nonzero(f == 1)[0]:
        j = int(j)
        if j % p.lane_len == 0:
            continue
        lane = j // p.lane_len
        live = s[lane * p.lane_len + max(j // p.unroll - 1, 0) * p.unroll]
        if s[j] != live:
            s[j] = live
            return dict(a_slot=s)
    raise AssertionError("no redirectable fetch in this schedule")


def _index_bounds(lv, p):
    slot = lv["slot_idx"]
    slot[0] = p.n_blocks + 7
    return dict(slot_idx=slot)


def _slot_out_of_ring(lv, p):
    s = lv["a_slot"]
    s[0] = 2 * p.unroll
    return dict(a_slot=s)


def _traffic(lv, p):
    return dict(traffic_items=tuple(
        (k, v + 1 if k == "a_fetches" else v) for k, v in p.traffic_items))


KILLS = {
    "shape": (lambda lv, p: dict(seg_write=lv["seg_write"][:-1]),
              ["shape-agreement"]),
    "lane_divisibility": (lambda lv, p: dict(n_lanes=3),
                          ["lane-divisibility"]),
    "lane_divisibility_unroll": (lambda lv, p: dict(unroll=p.lane_len * 2),
                                 ["lane-divisibility"]),
    "index_bounds": (_index_bounds, ["index-bounds"]),
    "slot_out_of_ring": (_slot_out_of_ring, None),
    "segment_structure": (_seg_structure, ["segment-structure"]),
    "accum_prev_order": (_accum_prev, ["accum-prev-order"]),
    "pads_fetch_nothing": (_pad_fetch, ["pads-fetch-nothing"]),
    "lane_first_fetch": (_lane_first, ["lane-first-fetch"]),
    "fetch_on_change": (_fetch_on_change, ["fetch-on-change"]),
    "slot_advance": (_slot_advance, ["slot-advance"]),
    "ring_war": (_ring_war, ["slot-advance"]),
    "traffic_agreement": (_traffic, ["traffic-agreement"]),
}


@pytest.mark.parametrize("kill", list(KILLS))
def test_kill_matches_repro(plans, kill):
    fn, want_ids = KILLS[kill]
    got, want = _mutated(plans, fn)
    ids = _both(got, want)
    if want_ids is None:
        assert "index-bounds" in ids
    else:
        assert ids == want_ids
    if kill == "ring_war":
        # judged alone, the liveness property is what breaks
        assert _both(got, want, invariants=("ring-war",)) == ["ring-war"]
    if kill == "traffic_agreement":
        # the fast level skips the model recomputation
        assert verify_plan(got, level="fast").ok


def test_kill_scale_agreement_matches_repro():
    a, ja = _mat()
    q, jq = _pair(mat=(a, ja), n_lanes=2, quantize="int8")
    assert _both(q.replace(lhs_scales=torch.ones(3)),
                 jq.replace(lhs_scales=jnp.ones((3,), jnp.float32))) == [
        "scale-agreement"]
    p, jp = _pair(mat=(a, ja), n_lanes=2)
    assert _both(p.replace(lhs_scales=torch.ones(p.n_blocks)),
                 jp.replace(lhs_scales=jnp.ones((p.n_blocks,), jnp.float32))
                 ) == ["scale-agreement"]
    # a payload of the wrong dtype, and an fp32 plan fed a payload
    fq, jfq = _pair(mat=(a, ja), n_lanes=2, quantize="fp8")
    i8 = quantize_blocks(a.blocks, "int8")
    assert _both(fq.replace(lhs_blocks=i8.payload),
                 jfq.replace(lhs_blocks=jnp.asarray(_np(i8.payload)))) == [
        "scale-agreement"]
    assert _both(p.replace(lhs_blocks=i8.payload),
                 jp.replace(lhs_blocks=jnp.asarray(_np(i8.payload)))) == [
        "scale-agreement"]


def test_every_invariant_is_killed():
    assert INVARIANTS == JAX_INVARIANTS
    killed = {i for _, ids in KILLS.values() for i in ids or ()} | {
        "index-bounds", "ring-war", "scale-agreement"}
    assert killed == set(INVARIANTS)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.int64])
def test_flag_dtypes_give_the_same_findings(plans, dtype):
    """Realized flags may be bool or uint8 where ``repro`` has int32: the
    verifier reads them alike."""
    got, want = _mutated(plans, _fetch_on_change)
    flags = ("valid", "seg_start", "seg_write", "accum_prev", "a_fetch",
             "b_fetch")
    cast = got.replace(**{f: getattr(got, f).to(dtype) for f in flags})
    assert _result(verify_plan(cast, level="full")) == _result(
        jax_verify(want, level="full"))
    clean = plans[0].replace(**{f: getattr(plans[0], f).to(dtype)
                                for f in flags})
    assert verify_plan(clean, level="full").ok


def test_grad_plan_findings_carry_path():
    got, want = _pair(n_lanes=2, with_grad=True)
    f = _np(got.grad_plan.a_fetch).copy()
    f[0] = 0
    bad = got.replace(grad_plan=got.grad_plan.replace(
        a_fetch=torch.from_numpy(f)))
    jbad = want.replace(grad_plan=want.grad_plan.replace(a_fetch=f))
    assert _both(bad, jbad) == ["lane-first-fetch"]
    assert all(x.path == "plan.grad_plan"
               for x in verify_plan(bad).findings)


def test_verify_rejects_bad_level_and_ids(plans):
    with pytest.raises(ValueError, match="level must be"):
        verify_plan(plans[0], level="paranoid")
    with pytest.raises(ValueError, match="unknown invariant"):
        verify_plan(plans[0], invariants=("no-such-check",))


# ---------------------------------------------------------------------------
# clean plans verify clean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,fold_len,n_lanes,unroll", list(
    itertools.product(("segment", "gustavson", "outer"), (None, 3), (1, 3),
                      (1, 2))))
def test_knob_grid_verifies_clean(policy, fold_len, n_lanes, unroll):
    a, _ = _mat(seed=4, shape=(192, 160), density=0.45)
    b, _ = _mat(seed=5, shape=(160, 128), density=0.45)
    for q in MODES:
        kw = dict(policy=policy, fold_len=fold_len, n_lanes=n_lanes,
                  unroll=unroll, quantize=q, cache=False, device="cpu")
        for plan in (api.plan_matmul(a, 64, with_grad=True, **kw),
                     api.plan_matmul(a, b, **kw)):
            res = verify_plan(plan, level="full")
            assert res.ok, (q, plan.kind, res.summary())
            assert set(res.checked) == set(INVARIANTS)


def test_templates_and_realized_plans_give_one_result():
    """The planner verifies the value-free template (numpy leaves); the
    realized plan (torch leaves) and ``repro``'s give the same result."""
    a, ja = _mat()
    for kw in (dict(n_lanes=2, unroll=2, with_grad=True),
               dict(n_lanes=3, quantize="int8.rowwise")):
        got, want = _pair(mat=(a, ja), cache=True, **kw)
        tpl = next(t for t in planner._CACHE.values()
                   if t.aux["fingerprint"] == got.fingerprint)
        host = tpl.host_plan()
        assert isinstance(host.seg_start, np.ndarray)
        assert host.traffic_items == ()
        assert _result(verify_plan(host, level="full")) == _result(
            verify_plan(got, level="full"))
        _both(got, want)


# ---------------------------------------------------------------------------
# degenerate plans
# ---------------------------------------------------------------------------


def test_degenerate_single_block():
    a, ja = _mat(seed=0, shape=(32, 32), density=1.0)
    for kw in (dict(), dict(n_lanes=4, unroll=1)):
        got, want = _pair(mat=(a, ja), **kw)
        assert _both(got, want) == []


def test_degenerate_one_lane_unpadded():
    got, want = _pair(n_lanes=1)
    assert not got.has_pads
    assert _both(got, want) == []


def test_degenerate_empty_symbolic_c():
    blk = (32, 32)
    a = BSR((128, 128), blk, np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.ones((1,) + blk, np.float32))
    b = BSR((128, 128), blk, np.full(1, 3, np.int32), np.zeros(1, np.int32),
            np.ones((1,) + blk, np.float32))
    got, want = _pair(b, JaxBSR(b.shape, b.block_shape, b.brow, b.bcol,
                                b.blocks),
                      mat=(a, JaxBSR(a.shape, a.block_shape, a.brow, a.bcol,
                                     a.blocks)))
    assert got.n_out_blocks == 0
    assert _both(got, want) == []
    out = api.execute_plan(got, backend="reference", verify="full")
    assert out.shape[0] == 0


# ---------------------------------------------------------------------------
# plan_matmul(verify=), execute_plan(verify=), the plan's methods
# ---------------------------------------------------------------------------


def test_plan_matmul_verifies_each_template_once(monkeypatch):
    calls = []
    real = planner.verify_plan

    def counting(plan, level="fast", **kw):
        calls.append(level)
        return real(plan, level=level, **kw)

    monkeypatch.setattr(planner, "verify_plan", counting)
    api.clear_plan_cache()
    a, _ = _mat(seed=9)
    for _ in range(3):
        api.plan_matmul(a, 32, verify=True, device="cpu")
    assert calls == ["fast"]
    # a "full" request upgrades the fast-verified template once
    api.plan_matmul(a, 32, verify="full", device="cpu")
    api.plan_matmul(a, 32, verify="full", device="cpu")
    api.plan_matmul(a, 32, verify="fast", device="cpu")
    api.plan_matmul(a, 32, verify=False, device="cpu")
    assert calls == ["fast", "full"]
    tpl = next(iter(planner._CACHE.values()))
    assert tpl.verified_level == "full"
    with pytest.raises(ValueError, match="verify must be"):
        api.plan_matmul(a, 32, verify="paranoid", device="cpu")
    api.clear_plan_cache()


def test_plan_matmul_checks_the_values_on_every_realize():
    a, _ = _mat(seed=10)
    q = quantize_blocks(a.blocks, "int8")
    bad = dataclasses.replace(q, scales=q.scales[:3])
    plan = api.plan_matmul(dataclasses.replace(a, blocks=q), 32,
                           quantize="int8", verify="full", device="cpu")
    assert plan.verify("full").ok
    with pytest.raises(PlanVerificationError, match="scale-agreement"):
        api.plan_matmul(dataclasses.replace(a, blocks=bad), 32,
                        quantize="int8", verify="full", device="cpu")
    # without verify= the same values pass the planner
    api.plan_matmul(dataclasses.replace(a, blocks=bad), 32, quantize="int8",
                    device="cpu")


@pytest.mark.parametrize("q", MODES)
def test_plan_matmul_takes_tensor_blocks(q):
    """A layer's weights re-plan from a tensor (on its own device, no host
    copy): the same template, the same leaves as from numpy blocks."""
    a, _ = _mat(seed=12)
    want = api.plan_matmul(a, 32, quantize=q, verify="full", device="cpu")
    got = api.plan_matmul(dataclasses.replace(
        a, blocks=torch.from_numpy(a.blocks)), 32, quantize=q,
        verify="full", device="cpu")
    assert got.fingerprint == want.fingerprint
    for f in ("lhs_blocks", "lhs_scales"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(_np(g), _np(w))


def test_plan_matmul_raises_on_a_corrupt_schedule(monkeypatch):
    """A template the verifier rejects (here: a schedule builder whose
    fetch flags are wrong) raises at plan time."""
    real = planner.fetch_flags

    def broken(stream, valid, n_lanes, depth=2):
        f, s = real(stream, valid, n_lanes, depth=depth)
        f = f.copy()
        f[0] = 0
        return f, s

    monkeypatch.setattr(planner, "fetch_flags", broken)
    a, _ = _mat(seed=11)
    with pytest.raises(PlanVerificationError, match="lane-first-fetch"):
        api.plan_matmul(a, 32, verify=True, cache=False, device="cpu")


def test_execute_plan_verifies_before_any_launch(plans, monkeypatch):
    got, _ = _mutated(plans, _fetch_on_change)

    def no_launch(*a, **k):
        raise AssertionError("a kernel ran on a plan that fails to verify")

    monkeypatch.setattr(executor, "segment_spmm", no_launch)
    x = torch.ones(got.grid[1] * got.block_shape[1], 8)
    with pytest.raises(PlanVerificationError, match="fetch-on-change"):
        api.execute_plan(got, x, verify=True)
    with pytest.raises(PlanVerificationError):
        api.execute_plan(got, x, verify="full")
    with pytest.raises(AssertionError, match="a kernel ran"):
        api.execute_plan(got, x)


def test_plan_methods_match_repro(plans):
    got, want = plans
    assert got.lane_len == want.lane_len == got.n_items // got.n_lanes
    assert got.traffic == want.traffic
    assert got.traffic["a_fetches"] == int(got.a_fetch.sum())
    assert _result(got.verify("full")) == _result(want.verify("full"))
    bad = got.replace(seg_write=got.seg_write[:-1])
    with pytest.raises(PlanVerificationError, match="shape-agreement"):
        bad.verify().raise_if_findings()
    b, jb = _mat(seed=3, shape=(256, 128))
    g, jg = _pair(b, jb, n_lanes=2)
    assert g.traffic == jg.traffic and g.lane_len == jg.lane_len


@pytest.mark.parametrize("kw,match", [
    (dict(policy="auto"), "tuner"), (dict(policy="auto", verify="full"),
                                     "tuner"),
    (dict(vmem_limit_bytes=1 << 20), "budget")])
def test_tuner_knobs_still_raise(kw, match):
    a, _ = _mat()
    with pytest.raises(NotImplementedError, match=match) as e:
        api.plan_matmul(a, 32, device="cpu", **kw)
    assert "ROADMAP §1.3" in str(e.value)


# ---------------------------------------------------------------------------
# block shapes no model uses: 32x64, 64x32, 16x16, 128x128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [(32, 64), (64, 32), (16, 16), (128, 128)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("q", [None, "int8"])
def test_other_block_shapes_verify_and_match_repro(block, q):
    a, ja = _mat(seed=6, shape=(4 * block[0], 3 * block[1]), block=block,
                 density=0.5)
    got, want = _pair(mat=(a, ja), n_lanes=2, with_grad=True, quantize=q)
    assert _both(got, want) == []
    x = np.random.default_rng(7).standard_normal(
        (a.shape[1], 24)).astype(np.float32)
    y = got(torch.from_numpy(x)).numpy()
    jy = np.asarray(want(jnp.asarray(x), backend="reference"))
    rel = np.abs(y - jy).max() / np.abs(jy).max()
    assert rel <= 1e-6, rel
    dy = np.random.default_rng(8).standard_normal(
        (a.shape[0], 24)).astype(np.float32)
    dx = api.execute_plan(got.grad_plan.replace(
        lhs_blocks=got.lhs_blocks, lhs_scales=got.lhs_scales),
        torch.from_numpy(dy)).numpy()
    jdx = np.asarray(japi.execute_plan(want.grad_plan.replace(
        lhs_blocks=want.lhs_blocks, lhs_scales=want.lhs_scales),
        jnp.asarray(dy), backend="reference"))
    assert np.abs(dx - jdx).max() / np.abs(jdx).max() <= 1e-6
