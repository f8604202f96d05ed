"""The two backward kernels' CUDA paths, checked on the CPU: plain torch
emulations of their orders of operations, held against the plain versions
and against ``jax.grad`` of ``repro``'s jnp code, and their dispatch.

- The attention backward's ``"tc"`` path (``csrc/flash_attention_bwd.cu``):
  operands split into bf16 parts (three for fp32, one for an all-bf16
  call), S and dP as the sum of ``tc_passes`` products, P and dS from the
  forward's row statistics and split into their own bf16 parts (three in
  fp32 calls, hi + lo in bf16 ones), the KV-outer dK / dV pass over
  ``bwd_splits``' row ranges with a partial per range added in range
  order, and the Q-outer dQ pass that recomputes S and dP.
- The RG-LRU backward's ``"tile"`` path (``csrc/rg_lru_bwd.cu``): boxes of
  L steps x Dt channels walked last to first, zero past T and D (TMA's
  fill, with a = 1 and dout = 0 past T, so the chain passes through), h_{t-1}
  from the box one step earlier (h0 at t = 0), the chain carried from box
  to box, and ``da_param`` summed per gate thread over the walk, then per
  channel over the threads in order, then over the batch rows.

Tolerances: the attention emulation against ``flash_attention_bwd_plain``
and ``jax.grad`` (max deviation over the largest magnitude): the worst
found is pinned below, fp32 operands ~1e-6 (every part exact, the dropped
passes below 2**-24 of a product; fp32 sums in other orders), bf16
operands a few 1e-6 (P and dS as hi + lo: 2**-17 a term).  The RG-LRU emulation equals the plain version
bit for bit in dx, da_gate, dx_gate and dh0 under one gate function
(torch's CPU loops round ``exp`` otherwise in their scalar tail, so the
test substitutes a Python-float gate in both); ``da_param``, the same sum
in another order, within 1e-6; against ``jax.grad`` of ``rg_lru_ref``
1e-5 (``tests/test_torch_hybrid_train.py``'s ``BWD_RTOL``).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import softplus  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
rl = importlib.import_module("repro_torch.kernels.rg_lru")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
BWD_RTOL = 1e-5
MASKED = -1e30


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the attention backward: dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dtypes,want", [
    (256, (BF16,) * 4, dict(parts=1, p_parts=2, wgs=2, rows=64, groups=2)),
    (128, (BF16,) * 4, dict(parts=1, p_parts=2, wgs=2, rows=64, groups=1)),
    (64, (BF16,) * 4, dict(parts=1, p_parts=2, wgs=2, rows=64, groups=1)),
    (256, (F32,) * 4, dict(parts=3, p_parts=3, wgs=1, rows=32, groups=2)),
    (80, (F32,) * 4, dict(parts=3, p_parts=3, wgs=1, rows=32, groups=1)),
    (144, (BF16, BF16, BF16, F32),
     dict(parts=3, p_parts=3, wgs=1, rows=32, groups=2))], ids=str)
def test_bwd_tc_layout(d, dtypes, want):
    assert fa.bwd_tc_layout(d, dtypes) == want


def test_bwd_tc_layout_goes_to_the_kernel_whole():
    """The wrapper hands every value of the layout to the library (in
    ``_LAYOUT_KEYS`` order), which refuses one that is not its ``Cfg``'s,
    so the grid ``bwd_splits`` sizes is the grid the kernel runs."""
    for d in (64, 256):
        for dtypes in ((BF16,) * 4, (F32,) * 4):
            assert sorted(fa._LAYOUT_KEYS) == sorted(fa.bwd_tc_layout(
                d, dtypes))


@pytest.mark.parametrize("args,want", [
    ((1, 16 * 4096, 4096, 256, (BF16,) * 4), 5),
    ((1, 16 * 4096, 4096, 256, (F32,) * 4), 5),
    ((1, 4096, 4096, 128, (BF16,) * 4), 9),
    ((2, 200, 100, 64, (F32,) * 4), 7),
    ((1, 40, 4096, 64, (BF16,) * 4), 1),
    ((64, 4096, 4096, 256, (BF16,) * 4), 1)], ids=str)
def test_bwd_splits_fill_the_card(args, want):
    """Ranges enough for ``BWD_BLOCKS_PER_SM`` blocks an SM on 132 SMs,
    never more than the row tiles."""
    n = fa.bwd_splits(*args, sms=132)
    assert n == want
    bh, tq, tk, d, dtypes = args
    lay = fa.bwd_tc_layout(d, dtypes)
    assert 1 <= n <= -(-tq // lay["rows"])


@pytest.mark.parametrize("d,dtypes,want", [
    (256, (F32,) * 4, "tc"), (256, (BF16,) * 4, "tc"),
    (48, (BF16, F32, BF16, F32), "tc"), (40, (F32,) * 4, "simt"),
    (8, (BF16,) * 4, "simt"), (272, (F32,) * 4, None),
    (64, (F16,) * 4, None)], ids=str)
def test_choose_bwd_path(d, dtypes, want):
    assert fa.choose_bwd_path(d, dtypes) == want
    able = fa.bwd_paths_for(d, dtypes)
    assert able == (() if want is None else
                    ("tc", "simt") if want == "tc" else ("simt",))


# ---------------------------------------------------------------------------
# the attention backward: the tc path's order of operations
# ---------------------------------------------------------------------------

def _np_parts(x, n):
    """x (fp32 values) as n bf16 parts, each rounded from what the earlier
    ones leave (the kernel's split_pair; three parts are exact)."""
    out, rest = [], x.float()
    for _ in range(n):
        h = rest.bfloat16().float()
        out.append(h)
        rest = rest - h
    return out


def _op_parts(x, parts):
    """An operand as the tc kernels read it: itself (all-bf16 calls) or its
    three bf16 parts (a bf16 operand of a mixed call: itself and two zero
    parts)."""
    return [x.float()] if parts == 1 else _np_parts(x, 3)


def _passes(a, b):
    """sum over ``tc_passes`` of ``a[i] @ b[j]``, in pass order, fp32."""
    out = None
    for i, j in fa.tc_passes(len(a), len(b)):
        term = a[i] @ b[j]
        out = term if out is None else out + term
    return out


def tc_bwd_emulation(q, k, v, out, dout, stats, *, causal, window, offset,
                     kv_len, bq, bkv, q_period, n_split=None):
    """The tc backward's arithmetic in plain torch.  Per bh: the dK/dV
    pass walks the row tiles of ``rows`` rows in ``n_split`` ranges (a
    fresh fp32 partial per range, added in range order); for each key
    block of 64 keys and each live row tile: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
    over the passes, P = exp(scale s - m) / max(l, 1e-30) (the masked
    score -1e30 in a live TPU tile, 0 for a dead one), dS = scale P (dP -
    delta) on unmasked keys, then dV += Σ passes Pᵀ_i dO_j and dK += Σ
    passes dSᵀ_i Q_j with P and dS in ``p_parts`` parts.  The dQ pass walks
    the key tiles of each 64-row block and recomputes S and dP the same
    way, dQ += Σ passes dS_i K_j.  Returns fp32 (dq, dk, dv)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dtypes = (q.dtype, k.dtype, v.dtype, out.dtype)
    lay = fa.bwd_tc_layout(d, dtypes)
    parts, npp, rows, outer = (lay["parts"], lay["p_parts"], lay["rows"],
                               64)
    if n_split is None:
        n_split = fa.bwd_splits(bh, tq, tk, d, dtypes)
    scale = 1.0 / math.sqrt(d)
    period = tq if q_period is None else q_period
    live, mask = fa._tile_masks(tq, tk, causal=causal, window=window,
                                offset=offset, kv_len=kv_len, bq=bq, bkv=bkv,
                                period=period, rows=torch.arange(tq),
                                device="cpu")
    cls = torch.where(live & mask, 2, torch.where(live, 1, 0))
    qp, kp, vp, op = (_op_parts(x, parts) for x in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1)
    m, l = stats[..., 0], stats[..., 1]

    def p_ds(s, dp, c, mm, ll, dl):
        pe = torch.where(c > 0, torch.exp(torch.where(c == 2, s * scale,
                                                      MASKED) - mm)
                         / torch.clamp(ll, min=1e-30), 0.0)
        ds = torch.where(c == 2, pe * (dp - dl), 0.0) * scale
        return pe, ds

    dq = torch.zeros((bh, tq, d))
    dk = torch.zeros((bh, tk, d))
    dv = torch.zeros((bh, tk, d))
    n_in = -(-tq // rows)
    per = -(-n_in // n_split)
    for b in range(bh):
        part_k = [torch.zeros((tk, d)) for _ in range(n_split)]
        part_v = [torch.zeros((tk, d)) for _ in range(n_split)]
        for sp in range(n_split):
            for k0 in range(0, tk, outer):
                ks = slice(k0, min(k0 + outer, tk))
                for j in range(sp * per, min(n_in, (sp + 1) * per)):
                    rs = slice(j * rows, min(j * rows + rows, tq))
                    c = cls[rs, ks].T                     # keys x rows
                    if not bool((c > 0).any()):
                        continue                          # a dead tile
                    st = _passes([x[b, ks] for x in kp],
                                 [x[b, rs].T for x in qp])
                    dpt = _passes([x[b, ks] for x in vp],
                                  [x[b, rs].T for x in op])
                    pt, dst = p_ds(st, dpt, c, m[b, rs], l[b, rs],
                                   delta[b, rs])
                    part_v[sp][ks] += _passes(_np_parts(pt, npp),
                                              [x[b, rs] for x in op])
                    part_k[sp][ks] += _passes(_np_parts(dst, npp),
                                              [x[b, rs] for x in qp])
        for sp in range(n_split):                 # in range order
            dk[b] += part_k[sp]
            dv[b] += part_v[sp]
        for r0 in range(0, tq, outer):
            rs = slice(r0, min(r0 + outer, tq))
            for j in range(-(-tk // rows)):
                ks = slice(j * rows, min(j * rows + rows, tk))
                c = cls[rs, ks]
                if not bool((c > 0).any()):
                    continue
                s = _passes([x[b, rs] for x in qp], [x[b, ks].T for x in kp])
                dp = _passes([x[b, rs] for x in op], [x[b, ks].T for x in vp])
                _, ds = p_ds(s, dp, c, m[b, rs, None], l[b, rs, None],
                             delta[b, rs, None])
                dq[b, rs] += _passes(_np_parts(ds, npp),
                                     [x[b, ks] for x in kp])
    return dq, dk, dv


def _attn_call(seed, bh, tq, tk, d, dtypes, **kw):
    """A stacked call's operands, its forward output and row statistics
    (the plain forward), a random dout, and the resolved masks."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * 0.5).to(dt)
               for s, dt in zip(((bh, tq, d), (bh, tk, d), (bh, tk, d)),
                                dtypes))
    kw = dict(dict(causal=True, window=None, offset=tk - tq, kv_len=tk,
                   bq=min(128, tq), bkv=min(128, tk), q_period=None), **kw)
    out, stats = fa.flash_attention_plain(q, k, v, out_dtype=dtypes[3],
                                          stats=True, **kw)
    dout = torch.from_numpy(rng.standard_normal((bh, tq, d)).astype(
        np.float32)).to(dtypes[3])
    return (q, k, v, out, dout, stats), kw


#: (bh, tq, tk, d, masks): a window with ragged Tq and Tk (row tiles and
#: key blocks cut short), q_period groups sharing the keys, kv_len padding,
#: a D that is not a multiple of 64
ATTN_CASES = {
    "window": (2, 100, 100, 64, dict(window=40, bq=50, bkv=50)),
    "grouped": (1, 128, 70, 48, dict(window=24, offset=6, q_period=64,
                                     bq=32, bkv=70)),
    "kv_len": (1, 96, 80, 80, dict(kv_len=61, bq=32, bkv=40)),
    "wide": (1, 70, 70, 144, dict(window=30, bq=35, bkv=70)),
}
#: the worst deviation of the emulation from flash_attention_bwd_plain
#: over ATTN_CASES x splits, pinned: fp32 operands 1.19e-6 found (D = 144:
#: fp32 sums in other orders), 2e-6 held; bf16 operands (P and dS as hi +
#: lo) 3.89e-6 found, 1e-5 held
EMU_WORST = {F32: 2e-6, BF16: 1e-5}


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("dt", [F32, BF16], ids=str)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_tc_bwd_order_matches_plain(case, dt, n_split):
    bh, tq, tk, d, masks = ATTN_CASES[case]
    args, kw = _attn_call(5, bh, tq, tk, d, (dt,) * 4, **masks)
    # the plain version on the same values in fp32 (its outputs unrounded)
    want = fa.flash_attention_bwd_plain(*(a.float() for a in args), **kw)
    got = tc_bwd_emulation(*args, n_split=n_split, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) <= EMU_WORST[dt]


@pytest.mark.parametrize("dtypes", [(BF16, F32, BF16, F32),
                                    (F32, BF16, BF16, BF16),
                                    (BF16, BF16, BF16, F32)], ids=str)
def test_tc_bwd_order_on_mixed_dtypes(dtypes):
    """A mixed call takes three parts for every operand (a bf16 operand's
    mid and lo parts are zero): the fp32 bound holds."""
    args, kw = _attn_call(6, 2, 100, 100, 64, dtypes, window=40, bq=50,
                          bkv=50)
    want = fa.flash_attention_bwd_plain(*(a.float() for a in args), **kw)
    got = tc_bwd_emulation(*args, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) <= EMU_WORST[F32]


#: (B, T, H, Hkv, D, window) through flash_mha, GQA stacking and padding
MHA_CASES = {"gqa": (1, 48, 4, 1, 16, 16), "padded": (2, 40, 4, 2, 32, 12),
             "ragged": (1, 200, 2, 1, 32, 64)}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_tc_bwd_order_matches_jax_grad(case, monkeypatch):
    """``ops.flash_mha``'s gradients with the backward's plain version
    replaced by the tc emulation, against ``jax.grad`` of ``repro``'s
    ``chunked_attention(window=)`` (fp32)."""
    b, t, h, hkv, d, window = MHA_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)

    def loss(q, k, v):
        out = jax_layers.chunked_attention(q, k, v, causal=True,
                                           window=window, chunk=32)
        return jnp.sum(out * g)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    seen = []

    def emulated(*args, **kw):
        seen.append(1)
        return tuple(x.to(a.dtype) for x, a in
                     zip(tc_bwd_emulation(*args, **kw), args[:3]))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", emulated)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (ops.flash_mha(*ins, causal=True, window=window)
     * torch.from_numpy(g)).sum().backward()
    assert seen
    for a, w in zip(ins, want):
        assert _rel(a.grad, w) <= BWD_RTOL


# ---------------------------------------------------------------------------
# the RG-LRU backward: dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtypes,want", [
    ((1, 4096, 4096), (BF16,) * 3, "tile"),
    ((4, 2048, 4096), (F32,) * 3, "tile"),
    ((1, 128, 4096), (BF16,) * 3, "tile"),
    ((4, 100, 4096), (BF16,) * 3, "tile"),
    ((4, 1, 4096), (F32,) * 3, "tile"),
    ((2, 4096, 36), (F32, F32, F32), "tile"),
    ((2, 4096, 36), (BF16, F32, F32), "simt"),
    ((2, 4096, 40), (F16, BF16, F32), "tile"),
    ((2, 4096, 40), (torch.float64,) * 3, None)], ids=str)
def test_rg_lru_choose_bwd_path(shape, dtypes, want):
    """``"tile"`` at every T where TMA reads every operand's rows (D a
    multiple of 16 bytes in each dtype), else ``"simt"``: the first of the
    forward's ``paths_for``."""
    assert rl.choose_bwd_path(shape[2], dtypes) == want
    able = rl.paths_for(shape[2], dtypes)
    assert want == (able[0] if able else None)


def test_rg_lru_bwd_path_is_checked_on_every_device():
    x = torch.zeros((1, 8, 36), dtype=BF16)
    p, h = torch.zeros(36), torch.zeros((1, 36))
    with pytest.raises(ValueError, match="path='tile' cannot take"):
        rl.rg_lru_bwd(x, x, x, p, h, x.float(), x, h, path="tile")


def test_rg_lru_bwd_counts_stay_at_zero_on_cpu():
    x = torch.zeros((1, 8, 16))
    p, h = torch.zeros(16), torch.zeros((1, 16))
    before = (rl.rg_lru_bwd.launches, rl.rg_lru_bwd.tile_launches,
              rl.rg_lru_bwd.simt_launches)
    rl.rg_lru_bwd(x, x, x, p, h, x, x, h, path="tile")
    assert (rl.rg_lru_bwd.launches, rl.rg_lru_bwd.tile_launches,
            rl.rg_lru_bwd.simt_launches) == before


# ---------------------------------------------------------------------------
# the RG-LRU backward: the tile path's order of operations
# ---------------------------------------------------------------------------

def tile_bwd_emulation(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, dt,
                       c=8.0):
    """The ``"tile"`` backward in torch: each (B, T, D) operand in boxes of
    L = ``TILE_ELEMS // dt`` steps x ``dt`` channels (zero past T and D),
    h_{t-1} from the box one step earlier (zero before step 0, then h0);
    boxes walked last to first; per box the gates, a = 1 and dout = 0 past
    T, the chain over the box's steps from last to first (g = dout + G, G =
    a g, G carried from box to box, starting at dh_T), the elements'
    gradients; ``da_param`` summed per gate thread (elements 4 m .. 4 m +
    3 of every box) over the walk, per channel over the threads in order,
    over the rows in order.  Returns what ``rg_lru_bwd_plain`` returns."""
    b, t, d = x.shape
    steps = rl.TILE_ELEMS // dt
    n_t, n_d = -(-t // steps), -(-d // dt)
    tp, dp_ = n_t * steps, n_d * dt

    def boxes(v, shift=0):
        full = torch.zeros((b, tp, dp_), dtype=torch.float32)
        full[:, shift:t, :d] = v.float()[:, :t - shift]
        return full

    xs, ags, xgs, dos = (boxes(v) for v in (x, a_gate, x_gate, dout))
    hps = boxes(hs, 1)
    hps[:, 0, :d] = h0.float()
    ncs = torch.zeros(dp_)
    ncs[:d] = -c * softplus(a_param.float())
    outs = [torch.zeros((b, tp, dp_)) for _ in range(3)]
    dh0 = torch.zeros((b, dp_))
    part = torch.zeros((b, dp_))
    in_t = (torch.arange(tp) < t)[None, :, None]
    for ci in range(n_d):
        cols = slice(ci * dt, (ci + 1) * dt)
        carry = torch.zeros((b, dt))
        carry[:, : max(0, min(dt, d - ci * dt))] = dh_t.float()[:, ci * dt:
                                                                 (ci + 1) * dt]
        pacc = torch.zeros((b, rl.TILE_ELEMS // 4, 4))
        for ti in reversed(range(n_t)):
            rows = slice(ti * steps, (ti + 1) * steps)
            live = in_t[:, rows]
            sg, a, ig = rl.rg_lru_bwd_gates(ags[:, rows, cols],
                                            xgs[:, rows, cols], ncs[cols])
            a = torch.where(live, a, 1.0)
            dv = torch.where(live, dos[:, rows, cols], 0.0)
            g = torch.empty_like(a)
            for s in reversed(range(steps)):
                g[:, s] = dv[:, s] + carry
                carry = a[:, s] * g[:, s]
            dx, dxg, dag, das = rl.rg_lru_bwd_elems(
                g, xs[:, rows, cols], sg, a, ig, hps[:, rows, cols],
                ncs[cols])
            for o, v in zip(outs, (dx, dxg, dag)):
                o[:, rows, cols] = v
            chan = (torch.arange(ci * dt, (ci + 1) * dt) < d)[None, None]
            das = torch.where(live & chan, das, 0.0)
            pacc = pacc + das.reshape(b, -1, 4)     # element e = 4 m + j
        dh0[:, cols] = carry
        per = dt // 4
        for cl in range(dt):
            s = torch.zeros(b)
            for m in range(cl // 4, rl.TILE_ELEMS // 4, per):
                s = s + pacc[:, m, cl % 4]
            part[:, ci * dt + cl] = s
    da_param = torch.zeros(dp_)
    for r in range(b):
        da_param = da_param + part[r]
    da_param = -c * torch.sigmoid(a_param.float()) * da_param[:d]
    dx, dxg, dag = (o[:, :t, :d] for o in outs)
    return (dx.to(x.dtype), dag.to(a_gate.dtype), dxg.to(x_gate.dtype),
            da_param, dh0[:, :d])


def scalar_bwd_gates(a_gate, x_gate, neg_c_sp):
    """``rg_lru_bwd_gates`` one element at a time in Python floats, rounded
    to fp32: the same function of each element wherever it lies in a
    tensor (see ``tests/test_torch_rg_lru_paths.py::scalar_gates``)."""
    def sig(v):
        return 1.0 / (1.0 + math.exp(-v))

    shape = a_gate.shape
    ncs = neg_c_sp.expand(shape).reshape(-1).tolist()
    sgs, avs, igs = [], [], []
    for ag, xg, n in zip(a_gate.reshape(-1).tolist(),
                         x_gate.reshape(-1).tolist(), ncs):
        sg = float(np.float32(sig(ag)))
        sgs.append(sg)
        avs.append(math.exp(float(np.float32(n * sg))))
        igs.append(sig(xg))
    return tuple(torch.tensor(v, dtype=torch.float32).reshape(shape)
                 for v in (sgs, avs, igs))


def _lru_inputs(seed, b, t, d, dtypes=(F32, F32, F32)):
    rng = np.random.default_rng(seed)
    x, ag, xg = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(dt) for dt in dtypes)
    ap = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    hs, _ = rl.rg_lru_plain(x.float(), ag, xg, ap, h0)
    dout = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(dtypes[0])
    dh_t = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return x, ag, xg, ap, h0, hs, dout, dh_t


# (B, T, D, Dt): T not a multiple of L (64 at Dt 16, 32 at Dt 32), D not a
# multiple of Dt (D % 4 == 0: the forward's fp32 h rows are TMA's), B = 1,
# a single box, a box of one step
TILE_CASES = [(2, 100, 40, 16), (1, 70, 36, 32), (3, 64, 32, 16),
              (1, 33, 48, 32), (2, 5, 16, 16), (1, 129, 8, 16),
              (2, 32, 72, 32), (1, 1, 20, 16)]


@pytest.mark.parametrize("b,t,d,dt", TILE_CASES)
def test_tile_bwd_order_matches_plain_bit_for_bit(b, t, d, dt, monkeypatch):
    """Boxes, the zero fill and its pass-through steps, the reverse walk
    and the carry from box to box change nothing: with one gate function
    in both, dx, da_gate, dx_gate and dh0 agree bit for bit; da_param (the
    same terms summed per gate thread, channel and row) within 1e-6."""
    args = _lru_inputs(3, b, t, d)
    monkeypatch.setattr(rl, "rg_lru_bwd_gates", scalar_bwd_gates)
    got = tile_bwd_emulation(*args, dt)
    want = rl.rg_lru_bwd_plain(*args)
    for i in (0, 1, 2, 4):
        assert torch.equal(got[i], want[i])
    assert _rel(got[3], want[3]) <= 1e-6


@pytest.mark.parametrize("dtypes", [(BF16, BF16, BF16), (F16, F16, F16),
                                    (BF16, F32, F16)], ids=str)
def test_tile_bwd_order_on_16_bit_and_mixed_operands(dtypes, monkeypatch):
    args = _lru_inputs(4, 2, 70, 40, dtypes)
    monkeypatch.setattr(rl, "rg_lru_bwd_gates", scalar_bwd_gates)
    got = tile_bwd_emulation(*args, 16)
    want = rl.rg_lru_bwd_plain(*args)
    for i in (0, 1, 2, 4):
        assert got[i].dtype == want[i].dtype and torch.equal(got[i], want[i])
    assert _rel(got[3], want[3]) <= 1e-6


def _jax_grads(x, ag, xg, ap, h0, dout, dh_t):
    def loss(x, ag, xg, ap, h0):
        out, h_t = jref.rg_lru_ref(x, ag, xg, ap, h0)
        return jnp.sum(out * dout) + jnp.sum(h_t * dh_t)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v.numpy()) for v in (x, ag, xg, ap, h0)))


@pytest.mark.parametrize("b,t,d,dt", TILE_CASES[:4])
def test_tile_bwd_order_matches_jax_grad(b, t, d, dt):
    """The emulation (torch's own gates) against ``jax.grad`` of
    ``repro``'s ``lax.scan`` (``rg_lru_ref``): dx, da_gate, dx_gate,
    da_param and dh0."""
    x, ag, xg, ap, h0, hs, dout, dh_t = _lru_inputs(5, b, t, d)
    want = _jax_grads(x, ag, xg, ap, h0, dout.numpy(), dh_t.numpy())
    got = tile_bwd_emulation(x, ag, xg, ap, h0, hs, dout, dh_t, dt)
    for g, w in zip(got, want):
        assert _rel(g, w) <= BWD_RTOL
