"""The port's ``kernels.ops`` slice against ``repro`` on shared numpy
inputs: ``flash_mha``, the raw ``flash_attention``, ``rg_lru_scan``,
``build_moe_chunks``, ``moe_gemm`` and ``moe_apply`` (``repro``'s Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them; the
port's wrappers on CPU tensors, which run the kernels' plain versions), the
dense oracles, the named errors, the deprecation shims and the configs the
slice takes its widths from."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.core.formats import BSR as JaxBSR  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention)
from repro.kernels.moe_gemm import build_moe_chunks as jax_chunks  # noqa: E402
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm  # noqa: E402
from repro.kernels.rg_lru import rg_lru as jax_rg_lru  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.api.plan import SegmentPlan  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.core.formats import BSR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.moe_gemm import (build_moe_chunks,  # noqa: E402
                                          moe_gemm)
from repro_torch.kernels.rg_lru import rg_lru  # noqa: E402

# fp32 on both sides, summed in other orders: test_kernels.py's attention
# tolerance, and fp32 rounding for the recurrence and the grouped GEMM
ATTN_TOL = dict(rtol=1e-4, atol=2e-5)
RG_LRU_TOL = dict(rtol=0, atol=1e-5)
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 outputs of the same fp32 arithmetic on the same bf16 inputs: they
# agree but for an occasional flip of the last bf16 bit (2**-8 relative)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 64, 256, 4, 1, 64, True, None),
    (2, 128, 128, 4, 4, 64, True, 64),
    (2, 128, 128, 4, 2, 64, True, 64),      # GQA × window (q_period wrap)
    (1, 1, 96, 8, 2, 64, True, None),       # decode shape
    (2, 48, 48, 2, 2, 32, False, None),     # bidirectional, ragged sizes
    (1, 32, 512, 2, 2, 128, True, 128),     # long kv + window
    (2, 1, 200, 16, 4, 32, True, None),     # decode, rep 4, ragged Tk
]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _attn_inputs(seed, b, tq, tk, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32) * 0.5
    return q, k, v


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_mha_matches_repro(shape):
    b, tq, tk, h, hkv, d, causal, window = shape
    q, k, v = _attn_inputs(1, b, tq, tk, h, hkv, d)
    want = jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window, interpret=True)
    got = ops.flash_mha(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)
    oracle = ref.mha_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                         window=window)
    np.testing.assert_allclose(
        _np(oracle), _np(jref.mha_ref(q, k, v, causal=causal, window=window)),
        **ATTN_TOL)


@pytest.mark.parametrize("shape", [ATTN_SHAPES[3], ATTN_SHAPES[4],
                                   ATTN_SHAPES[5], ATTN_SHAPES[7]], ids=str)
def test_flash_mha_bf16_matches_repro(shape):
    """bf16 q/k/v give a bf16 output on both sides (q's dtype)."""
    b, tq, tk, h, hkv, d, causal, window = shape
    q, k, v = _attn_inputs(2, b, tq, tk, h, hkv, d)
    want = jops.flash_mha(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in (q, k, v)),
                          causal=causal, window=window, interpret=True)
    got = ops.flash_mha(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                        causal=causal, window=window)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("kw", [
    dict(q_period=32, bq=16, bkv=32),
    dict(offset=10, kv_len=100, bq=16, bkv=32, q_period=32, window=20),
    dict(offset=-40, kv_len=200, bq=32, bkv=64),        # rows with no key
    dict(offset=0, kv_len=0, bq=64, bkv=128),           # nothing live
    dict(offset=5, kv_len=150, bq=8, bkv=16, q_period=16, causal=False),
    dict(kv_len=96, bq=64, bkv=64, out_dtype="float32"),
], ids=str)
def test_raw_flash_attention_matches_repro(kw):
    """Explicit ``q_period``, ``offset`` and ``kv_len < Tk``, down to rows
    whose live tiles hold only masked keys (they take repro's answer, the
    mean of V over those keys) and a call with no live tile at all."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 32)).astype(np.float32)
    kw = dict(kw)
    causal = kw.pop("causal", True)
    out_dtype = kw.pop("out_dtype", None)
    if out_dtype is not None:      # bf16 inputs, fp32 output
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    else:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = jax_flash_attention(
        jq, jk, jv, causal=causal, interpret=True,
        out_dtype=None if out_dtype is None else jnp.float32, **kw)
    got = flash_attention(
        tq, tk, tv, causal=causal,
        out_dtype=None if out_dtype is None else torch.float32, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("kw", [
    dict(offset=192, kv_len=256, bq=64, bkv=128, q_period=None, window=None),
    dict(offset=10, kv_len=100, bq=16, bkv=32, q_period=32, window=20),
    dict(offset=-40, kv_len=200, bq=32, bkv=64, q_period=None, window=64),
], ids=str)
def test_flash_attention_plain_row_chunks_match_repro(kw):
    """The plain version in chunks of 5 query rows (a ragged last chunk),
    as at long Tq on the card, against repro's kernel on the same call."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 32)).astype(np.float32)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               interpret=True, **kw)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=True, out_dtype=torch.float32,
                                chunk=5 * 2 * 256, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("shapes,kw", [
    (((1, 48, 16), (1, 64, 16)), dict(bq=32)),            # Tq % bq
    (((1, 64, 16), (1, 96, 16)), dict(bkv=64)),            # Tk % bkv
    (((1, 64, 16), (1, 64, 16)), dict(bq=16, q_period=24)),  # period % bq
    (((1, 64, 16), (1, 64, 16)), dict(bq=16, q_period=48)),  # Tq % period
])
def test_flash_attention_value_errors_match_repro(shapes, kw):
    (qs, ks) = shapes
    rng = np.random.default_rng(4)
    q = rng.standard_normal(qs).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    with pytest.raises(ValueError) as jerr:
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(k), **kw)
    assert str(terr.value) == str(jerr.value)


def _lru_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    x, ag, xg = (rng.standard_normal((b, t, d)).astype(np.float32)
                 for _ in range(3))
    ap = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return x, ag, xg, ap, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,d,ct", [(2, 128, 64, 32), (1, 64, 128, 64),
                                      (3, 96, 32, 16)])
def test_rg_lru_scan_matches_repro(b, t, d, ct, with_h0):
    x, ag, xg, ap, h0 = _lru_inputs(5, b, t, d)
    h0 = h0 if with_h0 else None
    want, want_h = jops.rg_lru_scan(
        *map(jnp.asarray, (x, ag, xg, ap)),
        None if h0 is None else jnp.asarray(h0), ct=ct, interpret=True)
    got, got_h = ops.rg_lru_scan(
        *map(torch.from_numpy, (x, ag, xg, ap)),
        None if h0 is None else torch.from_numpy(h0), ct=ct)
    assert got.dtype == torch.float32 and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **RG_LRU_TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **RG_LRU_TOL)
    # the oracles agree too
    wo, wh = jref.rg_lru_ref(x, ag, xg, ap, h0)
    go, gh = ref.rg_lru_ref(*map(torch.from_numpy, (x, ag, xg, ap)),
                            None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(_np(go), _np(wo), **RG_LRU_TOL)
    np.testing.assert_allclose(_np(gh), _np(wh), **RG_LRU_TOL)


def test_rg_lru_scan_bf16_matches_repro():
    """bf16 x/gates: out in bf16 (x's dtype), h_T in fp32, on both sides."""
    x, ag, xg, ap, h0 = _lru_inputs(6, 2, 64, 32)
    want, want_h = jops.rg_lru_scan(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, ag, xg)),
        jnp.asarray(ap), jnp.asarray(h0), ct=16, interpret=True)
    got, got_h = ops.rg_lru_scan(
        *(torch.from_numpy(a).bfloat16() for a in (x, ag, xg)),
        torch.from_numpy(ap), torch.from_numpy(h0), ct=16)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **RG_LRU_TOL)


@pytest.mark.parametrize("t,ct", [(200, 128), (96, 64)])
def test_rg_lru_chunk_error_matches_repro(t, ct):
    x, ag, xg, ap, h0 = _lru_inputs(7, 1, t, 8)
    with pytest.raises(ValueError) as jerr:
        jax_rg_lru(*map(jnp.asarray, (x, ag, xg, ap, h0)), ct=ct,
                   interpret=True)
    with pytest.raises(ValueError) as terr:
        rg_lru(*map(torch.from_numpy, (x, ag, xg, ap, h0)), ct=ct)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        ops.rg_lru_scan(*map(torch.from_numpy, (x, ag, xg, ap)), ct=ct)


@pytest.mark.parametrize("t,n_exp,rows,cf", [(200, 4, 16, 0.5), (300, 8, 8, 1.25),
                                             (64, 3, 16, 8.0), (5, 16, 4, 1.0)])
def test_build_moe_chunks_matches_repro(t, n_exp, rows, cf):
    """Same order, slots, chunk experts, kept tokens and static sizes; with
    a small capacity the same tokens overflow (both sorts are stable)."""
    expert = np.random.default_rng(t).integers(0, n_exp, t).astype(np.int32)
    want = jax_chunks(jnp.asarray(expert), n_exp, rows, cf)
    got = build_moe_chunks(torch.from_numpy(expert), n_exp, rows, cf)
    names = ("order", "slot", "chunk_expert", "keep")
    for name, w, g in zip(names, want[:4], got[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[4:] == tuple(want[4:])
    assert got[2].dtype == torch.int32
    if cf < 1:
        assert not got[3].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks,rows,d_in,d_out,n_exp", [
    (8, 16, 32, 64, 4), (6, 32, 48, 192, 3), (4, 8, 20, 1024, 2)])
def test_moe_gemm_matches_repro(dtype, n_chunks, rows, d_in, d_out, n_exp):
    rng = np.random.default_rng(n_chunks * 7 + d_in)
    x = rng.standard_normal((n_chunks * rows, d_in)).astype(np.float32)
    w = (rng.standard_normal((n_exp, d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    ce = np.sort(rng.integers(0, n_exp, n_chunks)).astype(np.int32)
    if dtype == "bfloat16":
        jx, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
        tx, tw = (torch.from_numpy(a).bfloat16() for a in (x, w))
    else:
        jx, jw = jnp.asarray(x), jnp.asarray(w)
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = jax_moe_gemm(jx, jw, jnp.asarray(ce), chunk_rows=rows,
                        interpret=True)
    got = moe_gemm(tx, tw, torch.from_numpy(ce), chunk_rows=rows)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **GEMM_TOL)
    np.testing.assert_allclose(
        _np(ref.moe_gemm_ref(tx, tw, torch.from_numpy(ce), rows)),
        _np(jref.moe_gemm_ref(jx, jw, jnp.asarray(ce), rows)), **GEMM_TOL)
    got16 = moe_gemm(tx, tw, torch.from_numpy(ce), chunk_rows=rows,
                     out_dtype=torch.bfloat16)
    want16 = jax_moe_gemm(jx, jw, jnp.asarray(ce), chunk_rows=rows,
                          interpret=True, out_dtype=jnp.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got16), _np(want16), **BF16_TOL)


@pytest.mark.parametrize("x_rows,w_shape,n_chunks,kw", [
    (128, (2, 32, 768), 1, {}),                 # d_out % bn (768 vs 512)
    (100, (2, 32, 64), 1, {}),                  # rows != chunks * rows
    (128, (2, 16, 64), 1, {}),                  # d_in mismatch
    (64, (2, 32, 96), 2, dict(chunk_rows=32, bn=64)),
])
def test_moe_gemm_value_errors_match_repro(x_rows, w_shape, n_chunks, kw):
    x = np.zeros((x_rows, 32), np.float32)
    w = np.zeros(w_shape, np.float32)
    ce = np.zeros(n_chunks, np.int32)
    with pytest.raises(ValueError) as jerr:
        jax_moe_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ce),
                     interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        moe_gemm(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(ce), **kw)
    assert str(terr.value) == str(jerr.value)


def _live_counts(kind, n_chunks, rows, rng):
    return {"zero": np.zeros(n_chunks, np.int32),
            "full": np.full(n_chunks, rows, np.int32),
            "partial": rng.integers(1, rows, n_chunks).astype(np.int32),
            "mixed": rng.permutation(np.resize(
                [0, 1, rows // 2, rows - 1, rows], n_chunks)).astype(np.int32),
            }[kind]


@pytest.mark.parametrize("kind", ["zero", "partial", "full", "mixed"])
@pytest.mark.parametrize("rows", [16, 40])
def test_moe_gemm_live_rows_match_repro(rows, kind):
    """With the rows past each chunk's count zeroed, ``live_rows`` changes
    no result: against ``repro``'s interpret kernel on the same rows, and
    against the call without it; fp32 and bf16 out."""
    n_chunks, d_in, d_out, n_exp = 6, 24, 64, 3
    rng = np.random.default_rng(rows + len(kind))
    live = _live_counts(kind, n_chunks, rows, rng)
    x = rng.standard_normal((n_chunks, rows, d_in)).astype(np.float32)
    x[np.arange(rows)[None, :] >= live[:, None]] = 0.0
    x = x.reshape(n_chunks * rows, d_in)
    w = (rng.standard_normal((n_exp, d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    ce = np.sort(rng.integers(0, n_exp, n_chunks)).astype(np.int32)
    tx, tw, tce = map(torch.from_numpy, (x, w, ce))
    tlive = torch.from_numpy(live)
    want = {}
    for out_dtype, jdt, tol in ((torch.float32, jnp.float32, GEMM_TOL),
                                (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        want[out_dtype] = _np(jax_moe_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ce), chunk_rows=rows,
            interpret=True, out_dtype=jdt))
        got = moe_gemm(tx, tw, tce, chunk_rows=rows, out_dtype=out_dtype,
                       live_rows=tlive)
        assert got.dtype == out_dtype
        np.testing.assert_allclose(_np(got), want[out_dtype], **tol)
        np.testing.assert_array_equal(
            _np(got), _np(moe_gemm(tx, tw, tce, chunk_rows=rows,
                                   out_dtype=out_dtype)))
    # rows past the counts come out zero even where x is not zero there
    noisy = tx + torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)) * (tx == 0)
    got = moe_gemm(noisy, tw, tce, chunk_rows=rows, live_rows=tlive)
    dead = torch.arange(rows)[None, :] >= tlive[:, None]
    assert (got[dead.reshape(-1)] == 0).all()
    np.testing.assert_allclose(_np(got[~dead.reshape(-1)]),
                               want[torch.float32][~dead.reshape(-1).numpy()],
                               **GEMM_TOL)


@pytest.mark.parametrize("live,match", [
    (torch.zeros(3, dtype=torch.int32), "shape"),
    (torch.zeros(4, 1, dtype=torch.int32), "shape"),
    (torch.zeros(4, dtype=torch.int64), "int32"),
    (torch.zeros(4), "int32"),
    ([16, 16, 16, 16], "int32"),
    (torch.tensor([0, 3, -1, 16], dtype=torch.int32), r"\[0, chunk_rows"),
    (torch.tensor([0, 17, 2, 16], dtype=torch.int32), r"\[0, chunk_rows"),
])
def test_moe_gemm_live_rows_value_errors(live, match):
    x, w = torch.zeros(64, 8), torch.zeros(2, 8, 16)
    ce = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        moe_gemm(x, w, ce, chunk_rows=16, live_rows=live)


@pytest.mark.parametrize("top_k,cf,rows,drops", [
    (1, 8.0, 16, False), (1, 0.5, 16, True), (2, 0.6, 16, True),
    (2, 0.5, 40, True)])
def test_moe_apply_passes_kept_token_counts(monkeypatch, top_k, cf, rows,
                                            drops):
    """``moe_apply`` hands both GEMMs each chunk's count of kept tokens
    (the rows ``build_moe_chunks`` fills), the up GEMM's rows past them
    are zero, and the result is still ``repro``'s, dropped tokens
    included."""
    rng = np.random.default_rng(20 + top_k + rows)
    t, dm, dff, n_exp = 128, 32, 64, 4
    x = rng.standard_normal((t, dm)).astype(np.float32) * 0.3
    wu = rng.standard_normal((n_exp, dm, dff)).astype(np.float32) * 0.1
    wd = rng.standard_normal((n_exp, dff, dm)).astype(np.float32) * 0.1
    logits = rng.standard_normal((t, n_exp)).astype(np.float32)
    calls = []

    def spy(xs, w, ce, **kw):
        calls.append((xs, kw["live_rows"]))
        return moe_gemm(xs, w, ce, **kw)

    monkeypatch.setattr(ops, "moe_gemm", spy)
    got = ops.moe_apply(*map(torch.from_numpy, (x, wu, wd, logits)),
                        top_k=top_k, chunk_rows=rows, capacity_factor=cf)
    want = jops.moe_apply(*map(jnp.asarray, (x, wu, wd, logits)),
                          top_k=top_k, chunk_rows=rows, capacity_factor=cf,
                          interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    assert len(calls) == 2 * top_k
    idx = torch.topk(torch.from_numpy(logits), top_k)[1]
    dropped = False
    for j in range(top_k):
        _, slot, _, keep, n_chunks, cap = build_moe_chunks(
            idx[:, j], n_exp, rows, cf)
        filled = np.zeros(n_exp * cap + 1, bool)
        filled[slot.numpy()] = True
        want_live = filled[:-1].reshape(n_chunks, rows).sum(1)
        (buf, live_up), (_, live_down) = calls[2 * j], calls[2 * j + 1]
        assert live_up.dtype == torch.int32
        np.testing.assert_array_equal(live_up.numpy(), want_live)
        assert live_down is live_up
        dead = np.arange(rows)[None, :] >= want_live[:, None]
        assert (buf[torch.from_numpy(dead.reshape(-1))] == 0).all()
        dropped |= not bool(keep.all())
    assert dropped == drops


@pytest.mark.parametrize("top_k,cf,dtype", [
    (1, 8.0, "float32"), (2, 8.0, "float32"), (1, 0.5, "float32"),
    (2, 0.6, "float32"), (2, 8.0, "bfloat16")])
def test_moe_apply_matches_repro(top_k, cf, dtype):
    """Random logits (no ties, so both top-k orders agree); a capacity
    under 1 drops tokens, the same ones on both sides."""
    rng = np.random.default_rng(10 + top_k)
    t, dm, dff, n_exp = 128, 32, 64, 4
    x = rng.standard_normal((t, dm)).astype(np.float32) * 0.3
    wu = rng.standard_normal((n_exp, dm, dff)).astype(np.float32) * 0.1
    wd = rng.standard_normal((n_exp, dff, dm)).astype(np.float32) * 0.1
    logits = rng.standard_normal((t, n_exp)).astype(np.float32)
    if dtype == "bfloat16":
        jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wu, wd)]
        tin = [torch.from_numpy(a).bfloat16() for a in (x, wu, wd)]
        tol = BF16_TOL
    else:
        jin, tin, tol = [jnp.asarray(a) for a in (x, wu, wd)], \
            [torch.from_numpy(a) for a in (x, wu, wd)], MOE_TOL
    want = jops.moe_apply(*jin, jnp.asarray(logits), top_k=top_k,
                          chunk_rows=16, capacity_factor=cf, interpret=True)
    got = ops.moe_apply(*tin, torch.from_numpy(logits), top_k=top_k,
                        chunk_rows=16, capacity_factor=cf)
    assert got.dtype == torch.float32 and got.shape == (t, dm)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    if cf < 1:       # dropped tokens change their rows against no capacity
        full = ops.moe_apply(*tin, torch.from_numpy(logits), top_k=top_k,
                             chunk_rows=16, capacity_factor=8.0)
        assert not torch.allclose(got, full)


def test_moe_apply_takes_an_activation():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    wu = rng.standard_normal((2, 16, 32)).astype(np.float32) * 0.2
    wd = rng.standard_normal((2, 32, 16)).astype(np.float32) * 0.2
    logits = rng.standard_normal((32, 2)).astype(np.float32)
    want = jops.moe_apply(*map(jnp.asarray, (x, wu, wd, logits)),
                          chunk_rows=8, capacity_factor=4.0,
                          activation=jax.nn.gelu, interpret=True)
    got = ops.moe_apply(*map(torch.from_numpy, (x, wu, wd, logits)),
                        chunk_rows=8, capacity_factor=4.0,
                        activation=lambda h: torch.nn.functional.gelu(
                            h, approximate="tanh"))
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors every wrapper runs its plain version: no launch."""
    for kernel in (flash_attention, moe_gemm, rg_lru):
        kernel.launches = 0
    moe_gemm.tensor_core_launches = 0
    q, k, v = map(torch.from_numpy, _attn_inputs(13, 1, 16, 32, 4, 2, 16))
    ops.flash_mha(q, k, v)
    x, ag, xg, ap, _ = map(torch.from_numpy, _lru_inputs(13, 1, 16, 8))
    ops.rg_lru_scan(x, ag, xg, ap)
    xs = torch.randn(64, 8)
    ops.moe_apply(xs, torch.randn(2, 8, 16), torch.randn(2, 16, 8),
                  torch.randn(64, 2), top_k=2, chunk_rows=16)
    assert (flash_attention.launches, moe_gemm.launches, rg_lru.launches,
            moe_gemm.tensor_core_launches) == (0, 0, 0, 0)


def _leaves_equal(got, want):
    for f in dataclasses.fields(SegmentPlan):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), f.name
        else:
            assert g == w, f.name


def test_ops_shims_warn_and_equal_plan_matmul():
    rng = np.random.default_rng(14)
    a = BSR.random(rng, (128, 96), (32, 32), 0.4)
    b = BSR.random(rng, (96, 64), (32, 32), 0.4)
    with pytest.warns(DeprecationWarning, match="plan_spmm"):
        spmm = ops.plan_spmm(a, policy="gustavson", n_cols_hint=64,
                             fold_len=2, device="cpu")
    with pytest.warns(DeprecationWarning, match="plan_spgemm"):
        spgemm = ops.plan_spgemm(a, b, fold_len=2, device="cpu")
    _leaves_equal(spmm, api.plan_matmul(a, policy="gustavson",
                                        n_cols_hint=64, fold_len=2,
                                        device="cpu"))
    _leaves_equal(spgemm, api.plan_matmul(a, b, fold_len=2, device="cpu"))
    assert ops.SpmmPlan is SegmentPlan and ops.SpgemmPlan is SegmentPlan
    # and the plan runs as repro's shim's does
    x = rng.standard_normal((96, 64)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jplan = jops.plan_spmm(JaxBSR(a.shape, a.block_shape, a.brow, a.bcol,
                                      a.blocks), policy="gustavson",
                               n_cols_hint=64, fold_len=2)
    np.testing.assert_allclose(
        spmm(torch.from_numpy(x)).numpy(),
        np.asarray(jplan(jnp.asarray(x), backend="reference")), **MOE_TOL)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_configs_are_repro_copies(name):
    """The port's configs, the widths its smoke runs the ops at, are
    field for field ``repro``'s."""
    mine, theirs = REGISTRY[name], JAX_REGISTRY[name]
    assert dataclasses.asdict(mine) == {
        f.name: getattr(theirs, f.name)
        for f in dataclasses.fields(mine)}
