"""The RG-LRU wrapper's two CUDA paths, checked on the CPU: the dispatch
(``choose_path``, ``paths_for``, ``tile_channels``) on the [ops] cases, the
crossover sweep's shapes and TMA's alignment edges; a plain torch emulation
of the ``"tile"`` path's order of operations (zero-filled boxes of L steps
x Dt channels, the gates a tile at a time, then the walk over each tile's
steps in order, clipped at T and D) bit-equal to the plain version under
one gate function, and against ``repro``'s kernel in interpret mode on
shared numpy inputs; and the calls the card took up in this redesign (fp16
and mixed x/gate dtypes) through ``ops.rg_lru_scan`` against ``repro``'s
interpret kernel.

Tolerance: fp32 on both sides, ``repro``'s exp and sigmoid against torch's,
1e-5 absolute (``tests/test_torch_ops.py``'s ``RG_LRU_TOL``); outputs in
bf16 or fp16 within one rounding of the same fp32 value (``BF16_TOL``);
the emulation with torch's own gates against the plain version 1e-6 (an
fp32 ulp of a gate where torch's CPU loop tail rounds ``exp`` otherwise).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import softplus  # noqa: E402

# the module (the package exports its function under the same name)
rl = importlib.import_module("repro_torch.kernels.rg_lru")

RG_LRU_TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
D_MODEL = 4096          # RecurrentGemma-9B's width


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    x, ag, xg = (rng.standard_normal((b, t, d)).astype(np.float32)
                 for _ in range(3))
    ap = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return x, ag, xg, ap, h0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label,shape,dtype,want", [
    ("rg_lru fp32", (4, 2048, D_MODEL), F32, "tile"),
    ("rg_lru bf16", (4, 2048, D_MODEL), BF16, "tile"),
    ("rg_lru prefill 1x8192", (1, 8192, D_MODEL), F32, "tile"),
    ("rg_lru decode", (4, 1, D_MODEL), F32, "simt"),
    ("edge B=1 T=1", (1, 1, D_MODEL), F32, "simt"),
    ("edge T=37", (2, 37, D_MODEL), F32, "tile"),
    ("edge T=7", (2, 7, 40), BF16, "simt"),
    ("edge D=37", (2, 256, 37), F32, "simt"),
    ("edge fp16", (2, 256, D_MODEL), F16, "tile"),
])
def test_choose_path_on_the_smoke_cases(label, shape, dtype, want):
    assert rl.choose_path(*shape, dtype, dtype, dtype) == want


@pytest.mark.parametrize("b,t", [(4, 1), (4, 16), (4, 64), (4, 256),
                                 (4, 2048), (1, 8192)])
def test_choose_path_on_the_crossover_sweep(b, t):
    want = "tile" if t >= rl.TILE_MIN_T else "simt"
    assert rl.choose_path(b, t, D_MODEL) == want
    assert rl.paths_for(D_MODEL, (F32,) * 3) == ("tile", "simt")


@pytest.mark.parametrize("d,dtypes,tile", [
    (4096, (F32, F32, F32), True),
    (36, (F32, F32, F32), True),       # 144-byte rows
    (37, (F32, F32, F32), False),
    (34, (F32, F32, F32), False),
    (36, (BF16, BF16, BF16), False),   # 72-byte rows
    (40, (BF16, BF16, BF16), True),
    (40, (F16, F16, F16), True),
    (12, (F16, F16, F16), False),
    (36, (F32, BF16, F32), False),     # one operand's rows decide
    (36, (F32, F32, F16), False),
    (40, (BF16, F32, F16), True),
    (8, (F32, BF16, F16), True),
])
def test_paths_for_at_the_tma_edges(d, dtypes, tile):
    want = ("tile", "simt") if tile else ("simt",)
    assert rl.paths_for(d, dtypes) == want
    assert rl.choose_path(2, 512, d, *dtypes) == want[0]


@pytest.mark.parametrize("dtypes", [(torch.float64,) * 3,
                                    (F32, F32, torch.int8),
                                    (torch.float64, F32, F32)])
def test_paths_for_refuses_other_dtypes(dtypes):
    assert rl.paths_for(64, dtypes) == ()
    assert rl.choose_path(2, 512, 64, *dtypes) is None


@pytest.mark.parametrize("b,d,sms,want", [
    (4, D_MODEL, 132, 32), (1, D_MODEL, 132, 16), (2, D_MODEL, 132, 16),
    (3, D_MODEL, 132, 32), (1, D_MODEL, 64, 32), (64, 256, 132, 32),
    (1, 40, 132, 16)])
def test_tile_channels_fill_the_card(b, d, sms, want):
    dt = rl.tile_channels(b, d, sms)
    assert dt == want
    blocks = b * -(-d // dt)
    # 32 only with twice as many blocks as SMs; 16 is the narrowest box
    assert dt == 16 or blocks >= 2 * sms
    assert rl.TILE_ELEMS % dt == 0


@pytest.mark.parametrize("path,d,ok", [("tile", 36, True),
                                       ("tile", 37, False),
                                       ("simt", 37, True),
                                       ("wgmma", 36, False)])
def test_forced_path_is_checked_on_every_device(path, d, ok):
    args = [torch.from_numpy(a) for a in _inputs(1, 1, 8, d)]
    if ok:
        out, h_t = rl.rg_lru(*args, path=path)
        assert out.shape == (1, 8, d) and h_t.shape == (1, d)
    else:
        with pytest.raises(ValueError, match="cannot take this call"):
            rl.rg_lru(*args, path=path)


# ---------------------------------------------------------------------------
# the "tile" path's order of operations
# ---------------------------------------------------------------------------

def tile_emulation(x, a_gate, x_gate, a_param, h0, dt, c=8.0):
    """The ``"tile"`` kernel's order of operations in torch: each (B, T, D)
    operand read in boxes of L = ``TILE_ELEMS // dt`` steps x ``dt``
    channels, zero past T and D (TMA's fill), converted to fp32; the gates
    of a whole box at once (``-c * softplus`` of a channel past D is 0, as
    in the kernel); then the scan over the box's steps up to T, one step a
    time, ``h`` carried from box to box; the output box clipped at T and D
    (TMA's store) in x's dtype, h_T after step T - 1."""
    b, t, d = x.shape
    steps = rl.TILE_ELEMS // dt
    n_t, n_d = -(-t // steps), -(-d // dt)

    def boxes(v):
        full = torch.zeros((b, n_t * steps, n_d * dt), dtype=torch.float32)
        full[:, :t, :d] = v.float()
        return full

    xs, ags, xgs = boxes(x), boxes(a_gate), boxes(x_gate)
    ncs = torch.zeros(n_d * dt)
    ncs[:d] = -c * softplus(a_param.float())
    h0s = torch.zeros((b, n_d * dt))
    h0s[:, :d] = h0.float()
    out = torch.zeros((b, n_t * steps, n_d * dt), dtype=x.dtype)
    h_t = torch.zeros((b, n_d * dt))
    for ci in range(n_d):
        cols = slice(ci * dt, (ci + 1) * dt)
        h = h0s[:, cols]
        for ti in range(n_t):
            rows = slice(ti * steps, (ti + 1) * steps)
            a, xb = rl.rg_lru_gates(xs[:, rows, cols].contiguous(),
                                    ags[:, rows, cols].contiguous(),
                                    xgs[:, rows, cols].contiguous(),
                                    ncs[cols])
            for s in range(min(steps, t - ti * steps)):
                h = a[:, s] * h + xb[:, s]
                out[:, ti * steps + s, cols] = h
        h_t[:, cols] = h
    return out[:, :t, :d], h_t[:, :d]


def _repro(x, ag, xg, ap, h0, dtypes=(F32, F32, F32)):
    xs, ags, xgs = (jnp.asarray(v).astype(JAX_DTYPE[dt])
                    for v, dt in zip((x, ag, xg), dtypes))
    return jops.rg_lru_scan(xs, ags, xgs, jnp.asarray(ap),
                            None if h0 is None else jnp.asarray(h0),
                            ct=x.shape[1], interpret=True)


# (B, T, D, Dt): T not a multiple of L (64 at Dt 16, 32 at Dt 32), D not a
# multiple of Dt, B = 1, a single tile, a tile of one step
TILE_CASES = [(2, 100, 40, 16), (1, 70, 36, 32), (3, 64, 32, 16),
              (1, 33, 48, 32), (2, 5, 16, 16), (1, 129, 8, 16),
              (2, 32, 72, 32), (1, 1, 20, 16)]


def scalar_gates(x, a_gate, x_gate, neg_c_sp):
    """``rg_lru_gates`` one element at a time in Python floats, rounded to
    fp32.  torch's CPU loops evaluate ``exp`` in their scalar tail other
    than in their vector body, so there an element's gate can round by its
    place in the loop; this one is the same function of each element
    wherever it lies, which lets the tests hold the tile order bit for
    bit."""
    def sig(v):
        return 1.0 / (1.0 + math.exp(-v))

    shape = x.shape
    ncs = neg_c_sp.expand(shape).reshape(-1).tolist()
    a, xb = [], []
    for xs, ag, xg, n in zip(x.reshape(-1).tolist(),
                             a_gate.reshape(-1).tolist(),
                             x_gate.reshape(-1).tolist(), ncs):
        av = math.exp(n * sig(ag))
        a.append(av)
        xb.append(math.sqrt(max(1.0 - av * av, 1e-12)) * (sig(xg) * xs))
    return (torch.tensor(a, dtype=torch.float32).reshape(shape),
            torch.tensor(xb, dtype=torch.float32).reshape(shape))


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,t,d,dt", TILE_CASES)
def test_tile_order_matches_plain_bit_for_bit(b, t, d, dt, with_h0,
                                              monkeypatch):
    """The tiles (zero fill, boxes, clipping, h carried from box to box)
    change nothing: with one gate function in both, the emulation and the
    plain version agree bit for bit."""
    x, ag, xg, ap, h0 = _inputs(3, b, t, d)
    h0 = h0 if with_h0 else np.zeros((b, d), np.float32)
    args = [torch.from_numpy(a) for a in (x, ag, xg, ap, h0)]
    monkeypatch.setattr(rl, "rg_lru_gates", scalar_gates)
    got, got_h = tile_emulation(*args, dt)
    plain, plain_h = rl.rg_lru_plain(*args)
    assert torch.equal(got, plain) and torch.equal(got_h, plain_h)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,t,d,dt", TILE_CASES)
def test_tile_order_matches_repro_kernel(b, t, d, dt, with_h0):
    x, ag, xg, ap, h0 = _inputs(3, b, t, d)
    args = [torch.from_numpy(a) for a in
            (x, ag, xg, ap, h0 if with_h0 else np.zeros((b, d), np.float32))]
    got, got_h = tile_emulation(*args, dt)
    want, want_h = _repro(x, ag, xg, ap, h0 if with_h0 else None)
    np.testing.assert_allclose(_np(got), _np(want), **RG_LRU_TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **RG_LRU_TOL)
    # and the plain version, whose gates differ from a tile's only where
    # torch's loop tail rounds exp otherwise: an fp32 ulp, carried
    plain, plain_h = rl.rg_lru_plain(*args)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(got_h), _np(plain_h), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtypes", [(BF16, BF16, BF16), (F16, F16, F16),
                                    (BF16, F32, F16), (F32, BF16, F16),
                                    (F16, BF16, F32)], ids=str)
def test_tile_order_on_16_bit_and_mixed_operands(dtypes, monkeypatch):
    x, ag, xg, ap, h0 = _inputs(4, 2, 70, 40)
    args = [torch.from_numpy(v).to(dt) for v, dt in zip((x, ag, xg), dtypes)]
    args += [torch.from_numpy(ap), torch.from_numpy(h0)]
    monkeypatch.setattr(rl, "rg_lru_gates", scalar_gates)
    got, got_h = tile_emulation(*args, 16)
    plain, plain_h = rl.rg_lru_plain(*args)
    assert got.dtype == dtypes[0]
    assert torch.equal(got, plain) and torch.equal(got_h, plain_h)


# ---------------------------------------------------------------------------
# fp16 and mixed dtypes through the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtypes", [
    (F16, F16, F16), (BF16, F32, F16), (F32, BF16, F16), (F16, F32, BF16),
    (F32, F16, F16), (BF16, BF16, F32)], ids=str)
def test_mixed_dtypes_match_repro(dtypes, with_h0):
    x, ag, xg, ap, h0 = _inputs(8, 2, 64, 40)
    h0 = h0 if with_h0 else None
    want, want_h = _repro(x, ag, xg, ap, h0, dtypes)
    got, got_h = ops.rg_lru_scan(
        *(torch.from_numpy(v).to(dt) for v, dt in zip((x, ag, xg), dtypes)),
        torch.from_numpy(ap), None if h0 is None else torch.from_numpy(h0),
        ct=16)
    # out in x's dtype on both sides, h_T in fp32
    assert got.dtype == dtypes[0]
    assert jnp.dtype(want.dtype) == jnp.dtype(JAX_DTYPE[dtypes[0]])
    assert got_h.dtype == F32
    tol = RG_LRU_TOL if dtypes[0] == F32 else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **RG_LRU_TOL)


def test_launch_counts_stay_at_zero_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(9, 2, 96, 40)]
    names = ["launches"] + [f"{p}_launches" for p in rl.PATHS]
    before = [getattr(rl.rg_lru, n) for n in names]
    assert before == [0] * len(names)
    for path in rl.paths_for(40, (F32,) * 3):
        rl.rg_lru(*args, path=path)
    ops.rg_lru_scan(*args[:4], ct=32)
    assert [getattr(rl.rg_lru, n) for n in names] == before
