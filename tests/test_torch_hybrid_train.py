"""Training the port's hybrid family (RecurrentGemma: RG-LRU blocks and
local attention) against ``jax.grad`` of ``repro``'s, on the CPU.

The port's gradients come from the two backward passes it adds, each run
here as its plain version (CPU tensors): ``rg_lru_bwd_plain``, the
explicit reverse walk of the RG-LRU, and ``flash_attention_bwd_plain``,
the dense masked-softmax backward of the windowed attention, both reached
through the kernels' autograd Functions.  ``repro`` differentiates jnp
code: ``lax.scan`` (``ref.rg_lru_ref``, ``rglru_block_apply``) and
``chunked_attention``, on its ``"reference"`` backend for the models.
Inputs are made with numpy from fixed seeds and handed to both.

Tolerances (max deviation over the largest magnitude of ``repro``'s):
1e-5 for the two backward passes alone (fp32, the same operations in
another order); 1e-4 for the RG-LRU block and the reduced model's loss and
every gradient (fp32, longer sums in other orders); for the block in bf16,
3e-2 against repro's bf16 gradients and no further from its fp32 ones than
its own bf16 gradients plus 1e-2 (bf16-rounded products summed in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (FP32, RTOL, SPARSE, check_loss_and_grads,  # noqa: E402
                             np_tree, pair, rel)
from repro import api as japi  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data import SyntheticDataset as JaxDataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import recurrent as jax_recurrent  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_paths_for, bwd_splits, choose_bwd_path, flash_attention,
    flash_attention_bwd, flash_attention_plain)
from repro_torch.kernels.rg_lru import (rg_lru, rg_lru_bwd,  # noqa: E402
                                        rg_lru_bwd_plain, rg_lru_plain)
from repro_torch.models import RGLRUBlock  # noqa: E402
from repro_torch.optim import cosine_with_warmup  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

NAME = "recurrentgemma-9b"
# the backward passes alone: fp32, the same operations in another order
BWD_RTOL = 1e-5
# bf16 activations: one bf16 rounding (2**-8) of each product and sum
BF16_RTOL = 1e-2
# a bf16 weight gradient: a sum of bf16-rounded products in each package
# (see test_rglru_block_grads_match_jax)
BF16_GRAD_RTOL = 3e-2


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


# --------------------------------------------------------------------------
# the RG-LRU backward pass
# --------------------------------------------------------------------------

# (B, T, D, a_gate offset): -200 drives sigmoid(a_gate) to 0, so a_t rounds
# to 1 and max(1 - a², 1e-12) takes its clamped side
RG_LRU_CASES = {"basic": (2, 37, 8, 0.0), "clamp": (2, 19, 8, -200.0),
                "long": (1, 130, 16, 0.0)}


def _rg_lru_inputs(b, t, d, shift, seed=1):
    rng = np.random.default_rng(seed)
    x, ag, xg = (rng.standard_normal((b, t, d)).astype(np.float32)
                 for _ in range(3))
    ag[:, : t // 2] += shift
    a_param = rng.uniform(0.5, 2.0, d).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    dout = rng.standard_normal((b, t, d)).astype(np.float32)
    dh_t = rng.standard_normal((b, d)).astype(np.float32)
    return x, ag, xg, a_param, h0, dout, dh_t


def _jax_rg_lru_grads(x, ag, xg, a_param, h0, dout, dh_t):
    def loss(x, ag, xg, a_param, h0):
        out, h_t = jref.rg_lru_ref(x, ag, xg, a_param, h0)
        return jnp.sum(out * dout) + jnp.sum(h_t * dh_t)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, ag, xg, a_param, h0)))


@pytest.mark.parametrize("case", list(RG_LRU_CASES))
def test_rg_lru_bwd_plain_matches_jax_grad(case):
    """``rg_lru_bwd_plain`` on the forward's fp32 h against ``jax.grad`` of
    ``repro``'s ``rg_lru_ref``: with h0 and a dh_T, and (``clamp``) where
    a_t rounds to 1 and the derivative through the clamp is 0."""
    b, t, d, shift = RG_LRU_CASES[case]
    x, ag, xg, a_param, h0, dout, dh_t = _rg_lru_inputs(b, t, d, shift)
    want = _jax_rg_lru_grads(x, ag, xg, a_param, h0, dout, dh_t)
    tx, tag, txg, tap, th0 = (_t(v) for v in (x, ag, xg, a_param, h0))
    hs, _ = rg_lru_plain(tx, tag, txg, tap, th0)
    if case == "clamp":
        a = torch.exp(-8.0 * torch.nn.functional.softplus(tap)
                      * torch.sigmoid(tag))
        assert bool((a[:, : t // 2] == 1.0).all())
    got = rg_lru_bwd_plain(tx, tag, txg, tap, th0, hs, _t(dout), _t(dh_t))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel(g, w) <= BWD_RTOL


@pytest.mark.parametrize("case", list(RG_LRU_CASES))
def test_rg_lru_autograd_matches_jax_grad(case):
    """The same gradients through ``rg_lru``'s autograd Function (the
    forward run with x in fp32, its h kept for the backward); the forward's
    outputs equal those of a call without gradients, bit for bit."""
    b, t, d, shift = RG_LRU_CASES[case]
    x, ag, xg, a_param, h0, dout, dh_t = _rg_lru_inputs(b, t, d, shift)
    want = _jax_rg_lru_grads(x, ag, xg, a_param, h0, dout, dh_t)
    ins = [_t(v, grad=True) for v in (x, ag, xg, a_param, h0)]
    out, h_t = rg_lru(*ins, ct=t)
    with torch.no_grad():
        out0, h_t0 = rg_lru(*ins, ct=t)
    assert torch.equal(out, out0) and torch.equal(h_t, h_t0)
    before = rg_lru_bwd.launches
    ((out * _t(dout)).sum() + (h_t * _t(dh_t)).sum()).backward()
    assert rg_lru_bwd.launches == before      # CPU tensors: plain version
    for v, w in zip(ins, want):
        assert rel(v.grad, w) <= BWD_RTOL


def test_rg_lru_autograd_bf16_keeps_dtypes():
    """bf16 x and gates: out in bf16 (the rounded fp32 h), gradients in the
    inputs' dtypes, within a bf16 rounding of the fp32 gradients."""
    x, ag, xg, a_param, h0, dout, _ = _rg_lru_inputs(2, 24, 16, 0.0)
    ins = [_t(v, torch.bfloat16, grad=True) for v in (x, ag, xg)]
    ap = _t(a_param, grad=True)
    out, _ = ops.rg_lru_scan(*ins, ap, ct=24)
    assert out.dtype == torch.bfloat16
    (out.float() * _t(dout)).sum().backward()
    ref_ins = [_t(np.asarray(v.detach().float()), grad=True) for v in ins]
    ref_ap = _t(a_param, grad=True)
    rout, _ = ops.rg_lru_scan(*ref_ins, ref_ap, ct=24)
    (rout * _t(dout)).sum().backward()
    for v, r in zip(ins + [ap], ref_ins + [ref_ap]):
        assert v.grad.dtype == v.dtype
        assert rel(v.grad, r.grad.numpy()) <= BF16_RTOL


# --------------------------------------------------------------------------
# the windowed attention's backward pass, through flash_mha
# --------------------------------------------------------------------------

# (B, T, H, Hkv, D, window): T > window throughout; GQA stacking (H > Hkv);
# T = 40 pads the stacked q axis (bq_eff 64) and the keys (bkv_eff 128)
ATTN_CASES = {"gqa": (1, 48, 4, 1, 16, 16), "padded": (2, 40, 4, 2, 8, 12),
              "ragged": (1, 200, 2, 1, 32, 64)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_mha_grads_match_jax_chunked_attention(case):
    """dq, dk, dv of ``ops.flash_mha`` (``flash_attention``'s autograd
    Function, ``flash_attention_bwd_plain`` on the CPU) against
    ``jax.grad`` of ``repro``'s ``chunked_attention(window=)``; padded
    query rows and keys take no part."""
    b, t, h, hkv, d, window = ATTN_CASES[case]
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
    ins = [_t(a, grad=True) for a in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = ops.flash_mha(*ins, causal=True, window=window)
    (out * _t(g)).sum().backward()
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == before   # CPU: plain versions
    for a, w in zip(ins, want):
        assert rel(a.grad, w) <= BWD_RTOL


def test_flash_attention_bwd_gives_padding_zero_gradient():
    """A raw stacked call with padded query rows (``q_period`` groups of
    32 rows, 20 real) and padded keys (``kv_len``): the padded keys get
    exactly zero dk and dv, and rows whose output gradient is zero give
    exactly zero dq."""
    rng = np.random.default_rng(9)
    q = _t(rng.standard_normal((1, 64, 16)), grad=True)
    k = _t(rng.standard_normal((1, 128, 16)), grad=True)
    v = _t(rng.standard_normal((1, 128, 16)), grad=True)
    out = flash_attention(q, k, v, causal=True, window=8, offset=0,
                          kv_len=20, bq=32, bkv=128, q_period=32)
    mask = torch.zeros((1, 64, 1))
    mask[:, :20] = mask[:, 32:52] = 1.0
    (out * mask * _t(rng.standard_normal((1, 64, 16)))).sum().backward()
    assert not k.grad[:, 20:].any() and not v.grad[:, 20:].any()
    assert not q.grad[:, 20:32].any() and not q.grad[:, 52:].any()
    assert q.grad[:, :20].abs().max() > 0 and k.grad[:, :20].abs().max() > 0


@pytest.mark.parametrize("d,dtype,want", [
    (256, torch.bfloat16, ("tc", "simt")), (128, torch.bfloat16, ("tc", "simt")),
    (64, torch.bfloat16, ("tc", "simt")), (256, torch.float32, ("tc", "simt")),
    (40, torch.bfloat16, ("simt",)), (96, torch.bfloat16, ("tc", "simt")),
    (264, torch.bfloat16, ()), (36, torch.float32, ())])
def test_attention_bwd_dispatch(d, dtype, want):
    """``bwd_paths_for`` / ``choose_bwd_path``: ``"tc"`` for head dims that
    are multiples of 16 in fp32, bf16 or a mix (the forward's ``"tc"``
    set), ``"simt"`` for the other head dims the forward takes."""
    assert bwd_paths_for(d, (dtype,) * 4) == want
    assert choose_bwd_path(d, (dtype,) * 4) == (want[0] if want else None)
    if want:
        mixed = (torch.bfloat16,) * 3 + (torch.float32,)
        assert bwd_paths_for(d, mixed) == want


def test_attention_bwd_splits_fill_the_card():
    """The ``"tc"`` dK/dV pass cuts the stacked rows into ranges until its
    grid holds 4 blocks an SM (RecurrentGemma-9B's local block at 1 x 4096:
    64 blocks of 64 keys x 2 column groups, 5 ranges, in bf16 and fp32),
    never more ranges than row tiles."""
    bf, f32 = (torch.bfloat16,) * 4, (torch.float32,) * 4
    assert bwd_splits(1, 16 * 4096, 4096, 256, bf, 132) == 5
    assert bwd_splits(1, 16 * 4096, 4096, 256, f32, 132) == 5
    assert bwd_splits(1, 64, 4096, 256, bf, 132) == 1
    assert bwd_splits(64, 4096, 4096, 256, bf, 132) == 1


def test_flash_attention_bwd_path_is_checked_on_every_device():
    # D = 24: a multiple of 8 that is not one of 16, so "tc" cannot take it
    q = torch.zeros((1, 32, 24))
    out, stats = flash_attention_plain(q, q, q, causal=True, window=None,
                                       offset=0, kv_len=32, bq=32, bkv=32,
                                       q_period=None, out_dtype=q.dtype,
                                       stats=True)
    with pytest.raises(ValueError, match="path='tc' cannot take"):
        flash_attention_bwd(q, q, q, out, out, stats, causal=True,
                            window=None, offset=0, kv_len=32, bq=32, bkv=32,
                            q_period=None, path="tc")


# --------------------------------------------------------------------------
# the RG-LRU block, the model and the trainer
# --------------------------------------------------------------------------


def _block_grads_jax(jp, x, g, jdt):
    def loss(p, x):
        out, _ = jax_recurrent.rglru_block_apply(p, x.astype(jdt))
        return jnp.sum(out.astype(jnp.float32) * g)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return {k: v["w"] if isinstance(v, dict) else v for k, v in gp.items()}, gx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_grads_match_jax(dtype):
    """Every parameter's gradient and dx of ``RGLRUBlock`` against
    ``jax.grad`` of ``rglru_block_apply`` (fp32 parameters, x in
    ``dtype``).  fp32 within 1e-4.  In bf16 each package rounds every
    product of the backward pass to bf16 and a weight's gradient sums B · T
    = 58 of them (repro's own bf16 conv gradient is 1.5e-2 off its fp32
    one), so bf16 holds the port two ways: within ``BF16_GRAD_RTOL`` of
    repro's bf16 gradients, and as near repro's fp32 gradients as repro's
    own bf16 gradients are, within one bf16 rounding (``BF16_RTOL``)."""
    d, b, t = 32, 2, 29
    jp = jax_recurrent.rglru_block_init(jax.random.PRNGKey(3), d)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want_p, want_x = _block_grads_jax(jp, x, g, jdt)
    f32_p, f32_x = _block_grads_jax(jp, x, g, jnp.float32)

    blk = RGLRUBlock(d, device="cpu")
    blk.load_state_dict({
        "conv": _t(jp["conv"]), "a_param": _t(jp["a_param"]),
        **{f"{n}.w": _t(jp[n]["w"]) for n in
           ("in_x", "in_g", "a_gate", "x_gate", "out")}})
    tx = _t(x, grad=True)
    out, _ = blk(tx.to(tdt))
    (out.float() * _t(g)).sum().backward()
    got = {n.split(".")[0]: prm.grad for n, prm in blk.named_parameters()}
    got["x"], want_p["x"], f32_p["x"] = tx.grad, want_x, f32_x
    assert set(got) == set(want_p)
    for k, v in got.items():
        if dtype == "float32":
            assert rel(v, want_p[k]) <= RTOL, k
        else:
            assert rel(v, want_p[k]) <= BF16_GRAD_RTOL, k
            assert rel(v, f32_p[k]) <= rel(want_p[k], f32_p[k]) + BF16_RTOL, k


@pytest.mark.parametrize("ffn,remat", [("dense", False), ("dense", True),
                                       ("sparse", True)])
def test_hybrid_loss_and_every_gradient_match(ffn, remat):
    """``reduced_config(recurrentgemma-9b)`` (4 layers, window 32) on 2 x
    80 tokens, so the window is smaller than T: ``loss_fn`` and every
    parameter's gradient (RG-LRU blocks, local attention, the sparse FFN's
    blocks) against ``jax.grad`` of ``repro``'s, remat on and off."""
    p = pair(NAME, remat=remat, **(FP32 if ffn == "dense" else SPARSE))
    assert p.cfg.local_window < 80
    batch = JaxDataset(p.jcfg, JaxShapeConfig("tiny", "train", 80, 2),
                       seed=3).batch(0)
    check_loss_and_grads(p, batch)


def test_hybrid_forward_records_gradients_and_serves_without():
    """The forward runs under grad mode (its logits carry a graph) and in
    ``inference_mode`` with the same shape and values."""
    p = pair(NAME, **FP32)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits = p.model(tokens)
    assert logits.requires_grad
    with torch.inference_mode():
        served = p.model(tokens)
    assert served.shape == (1, 8, p.jcfg.padded_vocab)
    assert torch.equal(served, logits.detach())


def test_hybrid_trainer_tracks_repro_trainer():
    """3 steps of ``Trainer`` against ``repro.runtime.Trainer`` on the
    reduced hybrid with the block-sparse FFN (T = 40 over a window of 32):
    loss and pre-clip gradient norm of every step within 1e-4, the final
    weights within the bound of ``tests/test_torch_train.py`` (2 · Σ lr,
    99.9 % quantile 1e-6)."""
    tc = dict(steps=3, log_every=1, peak_lr=1e-3, warmup=2)
    shape = dict(name="tiny", kind="train", seq_len=40, global_batch=2)
    p = pair(NAME, **SPARSE)
    jtrainer = JaxTrainer(p.jmodel, p.jcfg, JaxShapeConfig(**shape),
                          JaxTrainerConfig(**tc))
    init = np_tree(jtrainer.state[0])
    with japi.use_backend("reference"):
        want = jtrainer.run()
    final = np_tree(jtrainer.state[0])
    trainer = Trainer(p.model, p.cfg, ShapeConfig(**shape),
                      TrainerConfig(**tc))
    p.model.load_state_dict(params_from_jax(p.cfg, init, p.patterns))
    got = trainer.run()
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=RTOL)
    lr = cosine_with_warmup(tc["peak_lr"], tc["warmup"], tc["steps"])
    atol = 2 * sum(lr(s) for s in range(1, tc["steps"] + 1))
    want_p = params_from_jax(p.cfg, final, p.patterns)
    for k, t in p.model.named_parameters():
        d = np.abs(t.detach().numpy() - want_p[k].numpy())
        assert d.max() <= atol, k
        assert np.quantile(d, 0.999) <= 1e-6, k


def test_train_cli_takes_the_hybrid():
    """``python -m repro_torch.launch.train --arch recurrentgemma-9b
    --reduced --device cpu`` trains (in process, 2 steps)."""
    import json
    import sys
    from unittest import mock

    from repro_torch.launch import train
    argv = ["train", "--arch", NAME, "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    with mock.patch.object(sys, "argv", argv), \
            mock.patch("builtins.print") as printed:
        train.main()
    lines = [c.args[0] for c in printed.call_args_list]
    assert lines[0].startswith("step      0  loss ")
    assert np.isfinite(json.loads(lines[-1])["final_loss"])

