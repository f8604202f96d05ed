"""Training traffic: packed documents in fixed batches, driven through the
port's train step (``make_train_step``: loss, backward, AdamW in place).

Set-up builds the model, the optimizer and the step, and runs the
traffic's ``checked_steps`` first steps through the same call and feed as
the window; it reads what the comparison needs from the program's state:
each step's loss, each leaf's first gradient (from AdamW's first moment
after one step) and each leaf's change after the last checked step.  The
window then runs steps on fresh batches until its time is up and waits for
the last one (a span ``train step`` each).  After it the program is freed
and the plain reference trains from the same weights on the same batches.

The traffic file: ``batch``, ``seq``, the documents' count ``docs``,
``doc_median``, ``doc_sigma``, ``doc_min``, ``doc_max`` and ``separator``
token, the ``optimizer`` (``lr``, ``b1``, ``b2``, ``eps``,
``weight_decay``, ``clip_norm``), ``checked_steps`` and ``trace_from``.
"""
from __future__ import annotations

import bisect
import gc
import itertools
import time
from typing import Dict, List

import torch

from perfbench import inputs, program
from perfbench.harness import Context, Outcome
from perfbench.reference import compare
from perfbench.reference import train as ref_train


class Feed:
    """Batches from the seed: row ``r`` of step ``k`` is the stream's tokens
    ``[(k·B + r)(T+1), (k·B + r + 1)(T+1))``; the stream is documents of the
    mix's lengths (one multiset, in the seed's order, again and again),
    each ended by the separator, of random tokens."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        t = traffic
        self.b, self.t = t["batch"], t["seq"]
        self.vocab, self.sep, self.seed = vocab, t["separator"], seed
        self.device = device
        lengths = inputs.lognormal_lengths(
            t["docs"], t["doc_median"], t["doc_sigma"], t["doc_min"],
            t["doc_max"])
        order = inputs.permutation(len(lengths), seed, "docs")
        self.ends = list(itertools.accumulate(lengths[i] for i in order))

    def _separators(self, lo: int, hi: int) -> List[int]:
        """Stream positions in ``[lo, hi)`` that end a document."""
        total = self.ends[-1]
        out = []
        for cycle in range(lo // total, (hi - 1) // total + 1):
            base = cycle * total
            i = bisect.bisect_left(self.ends, lo - base + 1)
            while i < len(self.ends) and base + self.ends[i] - 1 < hi:
                out.append(base + self.ends[i] - 1)
                i += 1
        return out

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        n = self.t + 1
        g = inputs.generator(self.device, self.seed, "tokens", k)
        rows = torch.randint(1, self.vocab, (self.b, n), generator=g,
                             device=self.device)
        lo = k * self.b * n
        sep = [p - lo for p in self._separators(lo, lo + self.b * n)]
        if sep:
            rows.view(-1)[torch.tensor(sep, device=self.device)] = self.sep
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


class _NoUpdate:
    """The fault of a step that leaves its state unchanged."""

    def update(self, grads, state, params, grad_norm=None):
        return {"grad_norm": torch.zeros(()), "lr": 0.0}


def _plant(fault, model, step) -> None:
    """Breaks the timed path underneath (for the harness's tests)."""
    if fault == "unchanged":
        step.opt = _NoUpdate()
    elif fault == "half_batch":
        whole = model.loss_fn
        model.loss_fn = lambda b: whole(
            {k: v[: v.shape[0] // 2] for k, v in b.items()})
    elif fault is not None:
        raise ValueError(f"no fault {fault!r} in a training cell")


def run(ctx: Context) -> Outcome:
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime import make_train_step

    a, t, dev = ctx.arch, ctx.traffic, ctx.device
    hp = t["optimizer"]
    model, pattern = program.build(ctx.config, a, ctx.seed, dev)
    opt = AdamW(lr=constant(hp["lr"]), b1=hp["b1"], b2=hp["b2"],
                eps=hp["eps"], weight_decay=hp["weight_decay"],
                clip_norm=hp["clip_norm"])
    step = make_train_step(model, opt, 1)
    state = opt.init(step.master)
    _plant(ctx.options.get("fault"), model, step)
    feed = Feed(t, a.vocab, ctx.seed, dev)

    # the checked steps: set-up, through the window's own call and feed
    n_check = t["checked_steps"]
    losses, first = [], None
    for k in range(n_check):
        losses.append(float(step(state, feed.batch(k))["loss"]))
        if k == 0:
            first = ref_train.leaf_norms(state.m, 1.0 / (1 - hp["b1"]))
    change = ref_train.change_norms(a, ctx.seed,
                                    dict(model.named_parameters()))
    prog = {"loss": losses, "grad": first, "change": change}
    ctx.log(f"program losses {losses}")

    shape = {"batch": t["batch"], "seq": t["seq"]}
    t0 = ctx.open_window()
    deadline = t0 + ctx.seconds
    lo = ctx.trace_start(t0)
    tracer = ctx.tracer
    k, steps = n_check, 0
    while True:
        if tracer and tracer.idle and time.perf_counter() >= lo:
            tracer.start()
        with ctx.rec.span("train step", **shape):
            step(state, feed.batch(k))
            ctx.sync()
        k += 1
        steps += 1
        now = time.perf_counter()
        if now >= deadline:
            break
    window = now - t0
    if tracer and tracer.running:
        tracer.stop()
    ctx.read_peak()
    ctx.log(f"{steps} steps in {window:.3f} s")

    del model, step, state, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    batches = [feed.batch(k) for k in range(n_check)]
    ref = ref_train.run_steps(a, ctx.seed, batches, pattern, hp, dev,
                              log=ctx.log)
    compared, worst = compare.train_numbers(prog, ref)
    ctx.log(f"reference {time.perf_counter() - t_ref:.1f} s; worst: {worst}")
    control = None
    if ctx.options.get("control"):
        low = ref_train.run_steps(a, ctx.seed, batches, pattern, hp, dev,
                                  prec="fp8", log=ctx.log)
        control, _ = compare.train_numbers(low, ref)
    return Outcome(
        metrics={"train_tokens_per_s": steps * t["batch"] * t["seq"]
                 / window},
        attempted=steps, failed=0, compared=compared, window_s=window,
        control=control)
