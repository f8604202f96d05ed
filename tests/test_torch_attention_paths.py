"""The attention wrapper's three CUDA paths, checked on the CPU: the
dispatch (``choose_path``, ``paths_for``, ``split_plan``), plain torch
emulations of the ``"splitkv"`` path's order of operations (a partial per
split, combined in split order) and of the ``"tc"`` path's arithmetic (the
exact bf16 split of Q, K, P and V, the passes with part indices ``i + j <=
2`` summed in fp32, P·V promoted per KV tile) against ``repro``'s kernel in
interpret mode on shared numpy inputs, and the calls the card took up in
this redesign (q, k and v of mixed dtypes; any number of (batch, head)
rows).

Tolerance: fp32 sums in other orders on both sides, 1e-5 of the largest
output (as ``chip_smoke.py`` holds the kernels); the tc emulation's worst
error is pinned below that.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention)

from repro_torch.kernels import ops  # noqa: E402

# the modules (the package exports their functions under the same names)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
split_bf16x3 = importlib.import_module(
    "repro_torch.kernels.segment_spmm").split_bf16x3

RTOL = 1e-5
MASKED, ABSENT = -1e30, -3e38     # the kernels' finite scores
F32, BF16 = torch.float32, torch.bfloat16


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(seed, bh, tq, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d)))


def _resolve(tq, tk, **kw):
    """flash_attention's keyword defaults, resolved as the wrapper does."""
    kw = dict(dict(causal=True, window=None, offset=None, kv_len=None,
                   bq=128, bkv=128, q_period=None), **kw)
    kw["bq"], kw["bkv"] = min(kw["bq"], tq), min(kw["bkv"], tk)
    if kw["offset"] is None:
        kw["offset"] = tk - (tq if kw["q_period"] is None else kw["q_period"])
    if kw["kv_len"] is None:
        kw["kv_len"] = tk
    return kw


def _scores(q, k, kw, d):
    """The kernels' per-element scores: ``(q·k) * scale`` where unmasked,
    -1e30 for a masked key of a live TPU tile, -3e38 outside every live
    TPU tile."""
    tq, tk = q.shape[1], k.shape[1]
    period = tq if kw["q_period"] is None else kw["q_period"]
    live, mask = fa._tile_masks(
        tq, tk, causal=kw["causal"], window=kw["window"],
        offset=kw["offset"], kv_len=kw["kv_len"], bq=kw["bq"],
        bkv=kw["bkv"], period=period, rows=torch.arange(tq), device="cpu")
    s = torch.einsum("bqd,bkd->bqk", q, k) * (1.0 / math.sqrt(d))
    return torch.where(live, torch.where(mask, s, MASKED), ABSENT)


def _repro(q, k, v, **kw):
    return np.asarray(jax_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _stacked(b, tq, tk, h, hkv, d):
    """(bh, stacked rows, padded keys) of flash_mha's call at these shapes."""
    q = torch.zeros(b, tq, h, d)
    k = torch.zeros(b, tk, hkv, d)
    qh, kh, _, _ = ops.stack_heads(q, k, k)
    return qh.shape[0], qh.shape[1], kh.shape[1]


MIXED = [(F32, F32, F32), (BF16, BF16, BF16), (F32, BF16, BF16),
         (BF16, F32, BF16)]


@pytest.mark.parametrize("dtypes", MIXED, ids=str)
@pytest.mark.parametrize("label,shape,want", [
    ("granite decode", (4, 1, 4096, 32, 8, 128), "splitkv"),
    ("granite decode, long", (4, 1, 32768, 32, 8, 128), "splitkv"),
    ("granite prefill", (1, 4096, 4096, 32, 8, 128), "tc"),
    ("recurrentgemma local", (1, 8192, 8192, 16, 1, 256), "tc"),
    ("D 256 decode", (1, 1, 8192, 16, 1, 256), "splitkv"),
    ("D 64 prefill", (2, 2048, 2048, 16, 16, 64), "tc"),
    ("D 40 prefill", (1, 4096, 4096, 32, 8, 40), "simt"),
    ("D 40 decode", (4, 1, 4096, 32, 8, 40), "splitkv"),
    ("granite chunk of 64 over 4096", (1, 64, 4096, 32, 8, 128), "splitkv"),
    ("granite prefill, T 256", (1, 256, 256, 32, 8, 128), "tc"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_choose_path_on_published_shapes(label, shape, want, dtypes):
    bh, tq, tk = _stacked(*shape)
    d = shape[-1]
    assert fa.choose_path(bh, tq, tk, d, *dtypes) == want
    assert want in fa.paths_for(bh, tq, tk, d, dtypes)


@pytest.mark.parametrize("args,want,picked", [
    ((1, 8, 8, 12), (), None),                   # D not a multiple of 8
    ((1, 8, 8, 264), (), None),                  # D above 256
    ((4, 8, 64, 64), ("tc", "simt"), "tc"),      # one split unit of keys
    ((4, 8, 65, 64), ("splitkv", "tc", "simt"), "splitkv"),
    ((4, 8, 200, 40), ("splitkv", "simt"), "splitkv"),   # D % 16 != 0
    ((4, 512, 200, 40), ("splitkv", "simt"), "simt"),    # rows > keys
    ((70000, 8, 128, 16), ("splitkv", "tc", "simt"), "tc"),  # bh > 65535
    ((200, 8, 128, 40), ("splitkv", "simt"), "simt"),    # fills the card
])
def test_paths_for_at_the_edges(args, want, picked):
    assert fa.paths_for(*args) == want
    assert fa.choose_path(*args) == picked


def test_paths_for_refuses_other_dtypes():
    assert fa.paths_for(4, 8, 128, 64, (torch.float16, F32, F32)) == ()
    assert fa.choose_path(4, 8, 128, 64, F32, F32, torch.float16) is None
    # the card's thresholds scale with its streaming multiprocessors
    assert fa.choose_path(64, 32, 4096, 128, sms=132) != fa.choose_path(
        64, 32, 4096, 128, sms=16) or fa.SPLITKV_MAX_BLOCKS_PER_SM * 16 > 64


@pytest.mark.parametrize("bh,tq,tk", [(32, 32, 4096), (32, 32, 512),
                                      (8, 16384, 4096), (4, 8, 65),
                                      (1, 1, 100000), (70000, 8, 128)])
def test_split_plan_covers_the_keys(bh, tq, tk):
    n, split_keys = fa.split_plan(bh, tq, tk)
    assert n >= 2 and split_keys % fa.SPLIT_UNIT == 0
    assert (n - 1) * split_keys < tk <= n * split_keys   # no empty split
    if n > 2:
        assert split_keys >= fa.SPLIT_MIN_KEYS - fa.SPLIT_UNIT


@pytest.mark.parametrize("path,d,ok", [("tc", 40, False), ("tc", 64, True),
                                       ("splitkv", 64, True),
                                       ("simt", 40, True), ("cuda", 64, False)])
def test_forced_path_is_checked_on_every_device(path, d, ok):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 2, 64, 128, d))
    if ok:
        got = fa.flash_attention(q, k, v, path=path)
        want = fa.flash_attention(q, k, v)
        assert torch.equal(got, want)
    else:
        with pytest.raises(ValueError, match="cannot take this call"):
            fa.flash_attention(q, k, v, path=path)


# ---------------------------------------------------------------------------
# "splitkv": a partial per split, combined in split order
# ---------------------------------------------------------------------------

def splitkv_emulation(q, k, v, split_keys, **kw):
    """The split path's arithmetic in plain torch: split s takes keys [s
    split_keys, (s + 1) split_keys) from m = -1e30, l = 0, acc = 0 (a split
    with no live key for a row leaves l = acc = 0; one whose live keys are
    all masked carries m = -1e30), then M = max m_s and out = sum acc_s
    e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30), in split order."""
    d = q.shape[2]
    s = _scores(q, k, kw, d)
    parts = []
    for lo in range(0, k.shape[1], split_keys):
        ss = s[:, :, lo:lo + split_keys]
        m = torch.clamp(ss.amax(dim=-1, keepdim=True), min=MASKED)
        p = torch.exp(ss - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.bmm(p, v[:, lo:lo + split_keys])))
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - big)
        den = den + l * w
        num = num + acc * w
    return num / torch.clamp(den, min=1e-30)


SPLIT_CASES = [
    dict(offset=-40, kv_len=200, bq=32, bkv=64),     # rows with no live key,
    #                          and live tiles holding only masked keys
    dict(offset=0, kv_len=0, bq=64, bkv=128),        # kv_len = 0
    dict(offset=10, kv_len=100, bq=16, bkv=32, q_period=32, window=20),
    dict(offset=5, kv_len=150, bq=8, bkv=16, q_period=16, causal=False),
    dict(bq=64, bkv=128),                            # splits end mid-tile
    dict(offset=100, kv_len=256, bq=16, bkv=128, q_period=16, window=48),
]


@pytest.mark.parametrize("split_keys", [64, 128, 192])
@pytest.mark.parametrize("kw", SPLIT_CASES, ids=str)
def test_splitkv_order_matches_repro_kernel(kw, split_keys):
    q, k, v = _inputs(3, 2, 64, 256, 32)
    want = _repro(q, k, v, **kw)
    got = splitkv_emulation(*(torch.from_numpy(a) for a in (q, k, v)),
                            split_keys, **_resolve(64, 256, **kw))
    assert _rel(got, want) <= RTOL


def test_splitkv_order_on_a_stacked_decode_call():
    """flash_mha's decode layout (rep 4 query heads of one row, padded to
    8 rows each: q_period 8) with split_plan's splits, as the card runs it."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 600, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 600, 2, 64)).astype(np.float32))
    qh, kh, vh, kw = ops.stack_heads(q, k, v)
    n, split_keys = fa.split_plan(qh.shape[0], qh.shape[1], kh.shape[1])
    assert n >= 2 and kh.shape[1] % split_keys   # the last split is short
    want = _repro(qh.numpy(), kh.numpy(), vh.numpy(), **kw)
    got = splitkv_emulation(qh, kh, vh, split_keys,
                            **_resolve(qh.shape[1], kh.shape[1], **kw))
    assert _rel(got, want) <= RTOL


# ---------------------------------------------------------------------------
# "tc": six bf16 passes per product, P·V promoted per KV tile
# ---------------------------------------------------------------------------

def test_tc_passes():
    """The pass lists; and a bf16 value is its own hi part, so an
    all-bf16 call needs one part per operand."""
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32)).bfloat16()
    h, m, l = split_bf16x3(b)
    assert torch.equal(h, b) and not m.float().any() and not l.float().any()
    assert fa.tc_passes(3, 3) == ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
                                  (0, 0))
    assert fa.tc_passes(1, 1) == ((0, 0),)
    assert fa.tc_passes(3, 1) == ((2, 0), (1, 0), (0, 0))
    assert fa.tc_passes(1, 3) == ((0, 2), (0, 1), (0, 0))


def _parts(x):
    """An operand's parts as the tc path multiplies them: three for fp32,
    the value itself for bf16 (each as fp32 holding bf16 values)."""
    if x.dtype == BF16:
        return [x.float()]
    return [t.float() for t in split_bf16x3(x)]


def tc_emulation(q, k, v, **kw):
    """The tc path's arithmetic in plain torch: S = sum over
    tc_passes(Q parts, K parts) of Q_i K_j^T (each product exact in fp32),
    scaled and masked; the online softmax over the kernel's KV tiles (64
    keys for D <= 128, 32 above); each tile's P split into three bf16
    parts and P V = sum over tc_passes(3, V parts) of P_i V_j in a fresh
    fp32 sum, added to the accumulator after its alpha rescale."""
    d = q.shape[2]
    qp, kp, vp = _parts(q), _parts(k), _parts(v)
    s = sum(torch.einsum("bqd,bkd->bqk", qp[i], kp[j])
            for i, j in fa.tc_passes(len(qp), len(kp)))
    s = torch.where(_scores(q.float(), k.float(), kw, d) <= MASKED,
                    _scores(q.float(), k.float(), kw, d),
                    s * (1.0 / math.sqrt(d)))
    bkv = 64 if d <= 128 else 32
    m = torch.full(s.shape[:2] + (1,), MASKED)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:2] + (d,))
    for lo in range(0, k.shape[1], bkv):
        st = s[:, :, lo:lo + bkv]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pp = _parts(p)
        fresh = sum(torch.bmm(pp[i], vp[j][:, lo:lo + bkv])
                    for i, j in fa.tc_passes(3, len(vp)))
        acc = acc * alpha + fresh
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


#: the worst error of the tc emulation against repro's kernel over the
#: cases below, pinned: 1.35e-6 found (D = 256, window 96), 2e-6 held
#: (the dropped terms are below 2**-24 of each product; the rest is fp32
#: summation order, as on the other paths)
TC_WORST = 2e-6


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kw", SPLIT_CASES[:4] + [
    dict(bq=64, bkv=128, window=96)], ids=str)
def test_tc_arithmetic_matches_repro_kernel(kw, d):
    q, k, v = _inputs(11, 2, 64, 256, d)
    want = _repro(q, k, v, **kw)
    got = tc_emulation(*(torch.from_numpy(a) for a in (q, k, v)),
                       **_resolve(64, 256, **kw))
    assert _rel(got, want) <= TC_WORST


@pytest.mark.parametrize("dtypes", MIXED[1:], ids=str)
def test_tc_arithmetic_on_bf16_operands(dtypes):
    """bf16 operands take one part (bf16 Q·Kᵀ one pass, P·bf16 V three):
    still fp32-exact products, so the same tolerance holds."""
    q, k, v = _inputs(12, 2, 64, 256, 64)
    tq, tk, tv = (torch.from_numpy(a).to(dt) for a, dt in zip((q, k, v),
                                                               dtypes))
    kw = dict(bq=32, bkv=64, offset=100, kv_len=230, window=120)
    want = _repro(*(t.float().numpy() for t in (tq, tk, tv)), **kw)
    got = tc_emulation(tq, tk, tv, **_resolve(64, 256, **kw))
    assert _rel(got, want) <= TC_WORST


# ---------------------------------------------------------------------------
# calls the card took up in this redesign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", MIXED[2:] + [(F32, F32, BF16),
                                                (BF16, BF16, F32)], ids=str)
def test_mixed_dtypes_match_repro(dtypes):
    """q, k and v each fp32 or bf16: repro casts each to fp32 in its
    kernel; the port's wrapper takes the same call (on the card each
    kernel converts on load) and returns q's dtype."""
    q, k, v = _inputs(13, 2, 64, 256, 32)
    jax_dt = {F32: jnp.float32, BF16: jnp.bfloat16}
    kw = dict(bq=32, bkv=64, q_period=32, offset=150, window=100)
    want = jax_flash_attention(
        *(jnp.asarray(a).astype(jax_dt[dt]) for a, dt in zip((q, k, v),
                                                             dtypes)),
        interpret=True, out_dtype=jnp.float32, **kw)
    got = fa.flash_attention(
        *(torch.from_numpy(a).to(dt) for a, dt in zip((q, k, v), dtypes)),
        out_dtype=F32, **kw)
    assert got.dtype == F32
    assert _rel(got, np.asarray(want)) <= RTOL
    out = fa.flash_attention(
        *(torch.from_numpy(a).to(dt) for a, dt in zip((q, k, v), dtypes)),
        **kw)
    assert out.dtype == dtypes[0]


def test_many_batch_heads_take_every_path():
    """More (batch, head) rows than a CUDA grid's y axis holds: every path
    takes the call (bh is folded into the grid's x axis), and the plain
    version matches repro's kernel on a slice of it."""
    bh = 70000
    assert fa.paths_for(bh, 8, 128, 16, (F32,) * 3) == ("splitkv", "tc",
                                                          "simt")
    q, k, v = _inputs(14, bh, 8, 128, 16)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             bq=8, bkv=64)
    assert got.shape == (bh, 8, 16)
    rows = slice(bh - 3, bh)
    want = _repro(q[rows], k[rows], v[rows], bq=8, bkv=64)
    assert _rel(got[rows], want) <= RTOL


def test_launch_counts_stay_at_zero_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(15, 2, 64, 128, 64))
    names = ["launches"] + [f"{p}_launches" for p in fa.PATHS]
    before = [getattr(fa.flash_attention, n) for n in names]
    for path in fa.paths_for(2, 64, 128, 64):
        fa.flash_attention(q, k, v, path=path)
    assert [getattr(fa.flash_attention, n) for n in names] == before
