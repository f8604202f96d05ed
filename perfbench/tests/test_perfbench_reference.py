"""The plain reference against itself at small sizes: each layer against a
slower, more literal form of the same equations."""
import dataclasses
import math

import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

TOY = inputs.Arch(
    family="dense", n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
    d_ff=512, vocab=300, padded_vocab=512, tie_embeddings=True,
    rope_theta=10000.0, norm_eps=1e-5, n_experts=0, top_k=0,
    capacity_factor=1.25, ffn_block_sparse=True, ffn_block=64,
    ffn_density=0.5)
MOE = dataclasses.replace(TOY, family="moe", n_experts=4, top_k=2,
                          d_ff=64, ffn_block_sparse=False,
                          tie_embeddings=False)


def weights(a, seed=7):
    return dict(inputs.initial_leaves(a, seed, "cpu"))


def test_leaves_are_drawn_the_same_again():
    a, b = weights(TOY, 3), weights(TOY, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = dict(inputs.initial_leaves(TOY, 3, "cpu",
                                   names={"layers.1.mlp.down.blocks"}))
    assert list(c) == ["layers.1.mlp.down.blocks"]
    assert torch.equal(c["layers.1.mlp.down.blocks"],
                       a["layers.1.mlp.down.blocks"])
    assert not torch.equal(weights(TOY, 4)["embed.table"], a["embed.table"])


def test_pattern_is_seeded_sorted_and_of_fixed_size():
    p = inputs.ffn_patterns(TOY, 11, "cpu")
    q = inputs.ffn_patterns(TOY, 11, "cpu")
    for proj, (br, bc) in p.items():
        assert torch.equal(br, q[proj][0]) and torch.equal(bc, q[proj][1])
        key = br * 1000 + bc
        assert torch.equal(key, key.sort().values)
        assert br.numel() == inputs.ffn_nnz(TOY, proj)
    large = 2 ** 31 + 5
    assert inputs.derive_seed(large, "x") != inputs.derive_seed(large + 1,
                                                                "x")


def test_dense_ffn_weight_places_each_block():
    p = inputs.ffn_patterns(TOY, 5, "cpu")
    w = weights(TOY)
    blocks = w["layers.0.mlp.up.blocks"]
    dense = ref.dense_ffn_weight(TOY, blocks, p, "up")
    want = torch.zeros(TOY.d_ff, TOY.d_model)
    for s, (r, c) in enumerate(zip(*p["up"])):
        want[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64] = blocks[s]
    assert torch.equal(dense, want)


def test_attention_against_a_loop_over_positions():
    torch.manual_seed(0)
    w = weights(TOY)
    x = torch.randn(2, 9, TOY.d_model)
    got = ref.attention(TOY, w, 0, x, "fp32")
    p = "layers.0.attn."
    hd = TOY.head_dim
    pos = torch.arange(9)
    q = ref.rotary((x @ w[p + "wq.w"]).view(2, 9, 4, hd), pos, 1e4)
    k = ref.rotary((x @ w[p + "wk.w"]).view(2, 9, 2, hd), pos, 1e4)
    v = (x @ w[p + "wv.w"]).view(2, 9, 2, hd)
    out = torch.zeros(2, 9, 4, hd)
    for t in range(9):
        for h in range(4):
            s = (k[:, :t + 1, h // 2] @ q[:, t, h, :, None])[..., 0] \
                / math.sqrt(hd)
            out[:, t, h] = (s.softmax(-1)[..., None]
                            * v[:, :t + 1, h // 2]).sum(1)
    want = out.reshape(2, 9, 4 * hd) @ w[p + "wo.w"]
    assert torch.allclose(got, want, atol=1e-5)


def test_rotary_keeps_norms_and_rotates_position_zero_not_at_all():
    x = torch.randn(1, 5, 2, 8)
    r = ref.rotary(x, torch.arange(5), 100.0)
    assert torch.allclose(r.norm(dim=-1), x.norm(dim=-1), atol=1e-5)
    assert torch.allclose(r[:, 0], x[:, 0])


def test_served_logits_are_the_forward_pass_at_each_position():
    w = weights(TOY)
    p = inputs.ffn_patterns(TOY, 5, "cpu")
    prompt = torch.randint(1, TOY.vocab, (20,))
    served = torch.randint(1, TOY.vocab, (6,))
    got = ref.served_logits(TOY, w, prompt, served, [16, 8], p)
    seq = torch.cat([prompt, served[:-1]])[None]
    h, _ = ref.hidden(TOY, w, seq, p)
    want = h[0, 19:] @ w["embed.table"].T
    assert got.shape == (6, TOY.padded_vocab)
    assert torch.allclose(got, want, atol=1e-5)


def test_moe_with_room_is_the_gated_mixture_of_its_top_k():
    w = weights(MOE)
    x = torch.randn(1, 12, MOE.d_model)
    got, aux = ref.moe(MOE, w, 0, x, [(0, 12, 10 ** 6)], "fp32")
    p = "layers.0.moe."
    logits = x @ w[p + "router.w"]
    want = torch.zeros_like(x)
    for t in range(12):
        v, i = logits[0, t].topk(2)
        g = v.softmax(-1)
        for j in range(2):
            e = int(i[j])
            h = F.silu(x[0, t] @ w[p + "gate"][e]) * (x[0, t] @ w[p + "up"][e])
            want[0, t] += g[j] * (h @ w[p + "down"][e])
    assert torch.allclose(got, want, atol=1e-5)
    assert float(aux) > 0


def test_moe_capacity_keeps_the_first_tokens_of_each_choice():
    w = weights(MOE)
    x = torch.randn(1, 16, MOE.d_model)
    # width 4 over 4 experts at 1.25: ceil(5 / 4) = 2 slots an expert and
    # choice; the tokens past them get nothing from that choice
    full, _ = ref.moe(MOE, w, 0, x, [(0, 16, 10 ** 6)], "fp32")
    tight, _ = ref.moe(MOE, w, 0, x, [(0, 16, 4)], "fp32")
    top = (x @ w["layers.0.moe.router.w"]).topk(2).indices[0]
    for t in range(16):
        kept = all(int((top[:t, j] == top[t, j]).sum()) < 2 for j in range(2))
        assert torch.allclose(tight[0, t], full[0, t], atol=1e-6) == kept
    # a segment is routed alone: two halves as two calls
    halves, _ = ref.moe(MOE, w, 0, x, [(0, 8, 4), (8, 8, 4)], "fp32")
    alone, _ = ref.moe(MOE, w, 0, x[:, 8:], [(0, 8, 4)], "fp32")
    assert torch.allclose(halves[:, 8:], alone, atol=1e-6)


def test_the_float8_control_rounds_every_product():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    low = ref.mm(a, b, "fp8")
    assert not torch.equal(low, a @ b)
    rel = float((low - a @ b).norm() / (a @ b).norm())
    assert 1e-3 < rel < 0.2


def test_adamw_step_by_hand():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([3.0, 4.0])}           # norm 5, clipped to 1
    m = {"w": torch.zeros(2)}
    v = {"w": torch.zeros(2)}
    hp = {"lr": 0.1, "b1": 0.9, "b2": 0.95, "eps": 0.0, "weight_decay": 0.5,
          "clip_norm": 1.0}
    ref_train.adamw_(p, g, m, v, 1, hp)
    gc = torch.tensor([0.6, 0.8])
    assert torch.allclose(m["w"], 0.1 * gc)
    # step 1: m̂ / sqrt(v̂) = sign(g); p -= lr (sign + wd p)
    want = torch.tensor([1.0, -2.0]) - 0.1 * (torch.tensor([1.0, 1.0])
                                              + 0.5 * torch.tensor([1.0,
                                                                    -2.0]))
    assert torch.allclose(p["w"], want, atol=1e-6)


def test_training_loss_falls_and_readings_are_per_leaf():
    p = inputs.ffn_patterns(TOY, 5, "cpu")
    tok = torch.randint(1, TOY.vocab, (2, 17))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    hp = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
          "weight_decay": 0.0, "clip_norm": 1.0}
    out = ref_train.run_steps(TOY, 7, [batch] * 3, p, hp, "cpu")
    assert out["loss"][2] < out["loss"][0]
    names = [leaf.name for leaf in inputs.leaves(TOY)]
    assert sorted(out["grad"]) == sorted(out["change"]) == sorted(names)
    assert all(v > 0 for v in out["change"].values())
