"""Chat traffic: a closed loop of clients over the port's serving engine
(``Engine``: continuous batching, bucketed prefill, greedy decode).

Each client sends its next request as soon as its last one has finished,
with no think time.  Requests come from a pool whose prompt and output
lengths are one multiset on every seed (the lognormal's quantiles), in the
seed's order, with random prompt tokens; ``max_new_tokens`` is the drawn
output length and no request stops early.  Set-up fills every slot (the
first requests carry a share of their output length, so that they do not
all finish together) and runs ``warm_steps`` steps of the loop, which
warms every shape the window uses.

A step of the loop is :meth:`Engine.admit_pending` (the span ``admit``:
the prefill of every request that waits, each ending in its first token)
and then :meth:`Engine.step` (the span ``decode step``: one batched decode
of every slot).  Each token is stamped when the call that made it
returns.  After the window the requests sent in it that still wait are
admitted, so that each gets its first token; then every request whose
last token came in the window is run through the plain reference: each
served token's logit is compared with the reference's best at its
position.

The traffic file: ``clients``, ``slots``, ``max_len``,
``prefill_buckets``, the ``prompt`` and ``output`` lengths (``median``,
``sigma``, ``min``, ``max``), the ``pool`` size and its ``strata``,
``warm_steps``, ``trace_from`` and ``median_from`` (:func:`check`).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs, program
from perfbench.counts.flops import causal_ctx
from perfbench.harness import BenchError, Context, Outcome, percentile
from perfbench.reference import compare
from perfbench.reference import model as ref


def chunk_schedule(length: int, buckets) -> List[int]:
    """The engine's prefill chunks for a prompt: the largest bucket that
    fits what is left, the last one padded to the smallest bucket."""
    buckets = sorted(buckets, reverse=True)
    out, done = [], 0
    while done < length:
        c = next((c for c in buckets if c <= length - done), buckets[-1])
        out.append(c)
        done += c
    return out


@dataclasses.dataclass
class Tracked:
    client: int
    prompt: np.ndarray
    n_out: int
    submitted: float
    times: List[float] = dataclasses.field(default_factory=list)
    request: object = None


class Pool:
    """The seed's requests: lengths from the mix's quantiles, paired and
    ordered by the seed; the prompts' tokens drawn on the device at once."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        n = traffic["pool"]
        p, o = traffic["prompt"], traffic["output"]
        plen = inputs.lognormal_lengths(n, p["median"], p["sigma"], p["min"],
                                        p["max"])
        olen = inputs.lognormal_lengths(n, o["median"], o["sigma"], o["min"],
                                        o["max"])
        self.plen = inputs.stratified(plen, traffic["strata"], seed,
                                      "prompt")
        self.olen = inputs.stratified(olen, traffic["strata"], seed,
                                      "output")
        #: the mean output length (the same on every seed)
        self.mean_out = sum(olen) / n
        g = inputs.generator(device, seed, "prompts")
        self.flat = torch.randint(1, vocab, (sum(self.plen),), generator=g,
                                  device=device).cpu().numpy().astype(np.int32)
        self.offsets = np.concatenate([[0], np.cumsum(self.plen)])
        self.next = 0

    def take(self):
        i = self.next % len(self.plen)
        self.next += 1
        return (self.flat[self.offsets[i]:self.offsets[i + 1]],
                self.olen[i])


def _plant(fault: Optional[str], engine, vocab: int) -> None:
    """Breaks the timed path underneath (for the harness's tests):
    ``token`` alters every slot's token of every seventh decode step where
    it is made; ``token_slot`` alters every token that one slot decodes
    (the middle one: set-up gives its request half a mean answer, so it
    ends in the window on every seed); ``unchanged`` runs each decode step
    on a copy of the cache, so the step's keys and values are never
    kept."""
    if fault in ("token", "token_slot"):
        made = engine._decode
        calls = [0]
        slot = engine.slots // 2

        def altered(tok, pos):
            out = made(tok, pos)
            calls[0] += 1
            if fault == "token_slot":
                out = out.clone()
                out[slot] = (out[slot] + 1) % vocab
                return out
            return (out + 1) % vocab if calls[0] % 7 == 0 else out
        engine._decode = altered
    elif fault == "unchanged":
        model = engine.model
        whole = model.decode_step

        def forgetful(cache, token, pos, *args, **kw):
            if token.shape[1] == 1:          # a decode step, not a prefill
                cache = {k: v.clone() for k, v in cache.items()}
            return whole(cache, token, pos, *args, **kw)
        model.decode_step = forgetful
    elif fault is not None:
        raise ValueError(f"no fault {fault!r} in a serving cell")


def run(ctx: Context) -> Outcome:
    from repro_torch.runtime import Engine, Request

    a, t, dev, rec = ctx.arch, ctx.traffic, ctx.device, ctx.rec
    buckets = tuple(t["prefill_buckets"])
    model, pattern = program.build(ctx.config, a, ctx.seed, dev)
    engine = Engine(model, slots=t["slots"], max_len=t["max_len"],
                    prefill_buckets=buckets, device=dev)
    if tuple(engine.prefill_buckets) != tuple(sorted(buckets, reverse=True)):
        raise BenchError(f"the engine chunks by {engine.prefill_buckets}, "
                         f"not {buckets}")
    _plant(ctx.options.get("fault"), engine, a.vocab)
    pool = Pool(t, a.vocab, ctx.seed, dev)
    live: Dict[int, Tracked] = {}
    queued: List[Tracked] = []
    done: List[Tracked] = []
    state = {"open": True}        # clients send while the window is open

    def submit(client: int, now: float, n_out: Optional[int] = None):
        prompt, n = pool.take()
        tr = Tracked(client, prompt, n if n_out is None else n_out, now)
        tr.request = engine.submit(Request(prompt=prompt,
                                           max_new_tokens=tr.n_out))
        queued.append(tr)

    def finish(tr: Tracked, now: float):
        out = tr.request.out_tokens
        if out is None or len(out) != tr.n_out:
            raise BenchError(f"request {tr.request.rid} ended with "
                             f"{None if out is None else len(out)} tokens, "
                             f"not {tr.n_out}")
        done.append(tr)
        del live[tr.request.rid]
        if state["open"]:
            submit(tr.client, now)

    def admit() -> None:
        """Admits every waiting request; again while a request that ended
        at its first token has sent a successor."""
        while queued:
            admit_waiting()

    def admit_waiting() -> None:
        waiting = list(queued)
        queued.clear()
        plens = [len(tr.prompt) for tr in waiting]
        with rec.span("admit", n=len(waiting), tokens=sum(plens),
                      ctx_sum=sum(causal_ctx(0, p) for p in plens)):
            filled = engine.admit_pending()
        now = time.perf_counter()
        if filled != len(waiting):
            raise BenchError(f"{filled} of {len(waiting)} waiting requests "
                             f"were admitted")
        for tr in waiting:
            tr.times.append(now)
            live[tr.request.rid] = tr
            if tr.n_out == 1:
                finish(tr, now)

    def decode() -> None:
        # a token at position p attends to p + 1 keys
        fed = [len(tr.prompt) + len(tr.times) - 1 for tr in live.values()]
        with rec.span("decode step", n=len(fed),
                      ctx_sum=sum(p + 1 for p in fed)):
            advanced = engine.step()
        now = time.perf_counter()
        if advanced != len(fed):
            raise BenchError(f"the engine advanced {advanced} slots, "
                             f"{len(fed)} are live")
        for tr in list(live.values()):
            tr.times.append(now)
            if len(tr.times) == tr.n_out:
                finish(tr, now)

    # set-up: every slot filled by a request part-way through, client c's
    # with (c + 1) / clients of a mean answer left, so that the first
    # answers end evenly spread, the same on every seed
    for c in range(t["clients"]):
        submit(c, time.perf_counter(), n_out=max(
            2, round((c + 1) * pool.mean_out / t["clients"])))
    for _ in range(t["warm_steps"]):
        admit()
        decode()

    t0 = ctx.open_window()
    deadline = t0 + ctx.seconds
    lo = ctx.trace_start(t0)
    tracer = ctx.tracer
    while True:
        if tracer and tracer.idle and time.perf_counter() >= lo:
            tracer.start()
        admit()
        decode()
        now = time.perf_counter()
        if now >= deadline:
            break
    t1 = now
    state["open"] = False
    if tracer and tracer.running:
        tracer.stop()
    sent = [tr for tr in done + list(live.values()) + queued
            if t0 <= tr.submitted <= t1]
    if queued:                     # those sent in the window get their first
        admit()
    ctx.read_peak()

    everyone = done + list(live.values())
    stamps = [s for tr in everyone for s in tr.times if t0 <= s <= t1]
    gaps = [y - x for tr in everyone for x, y in zip(tr.times, tr.times[1:])
            if x >= t0 and y <= t1]
    ttft = [tr.times[0] - tr.submitted for tr in sent if tr.times]
    failed = len(sent) - len(ttft)
    ttft += [float("inf")] * failed
    window = t1 - t0
    finished = [tr for tr in done if t0 <= tr.times[-1] <= t1]
    ctx.log(f"{len(stamps)} tokens, {len(sent)} requests sent, "
            f"{len(finished)} finished in {window:.3f} s; inter-token p95 "
            f"{1e3 * percentile(gaps, 95):.1f} ms, first token p90 "
            f"{1e3 * percentile(ttft, 90):.1f} ms")
    rec.requests = [(tr.submitted, tr.times) for tr in everyone]

    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared, control = check(ctx, finished, pattern, buckets)
    return Outcome(
        metrics={"output_tokens_per_s": len(stamps) / window},
        attempted=len(sent), failed=failed, compared=compared,
        window_s=window,
        control=control)


def check(ctx: Context, finished: List[Tracked], pattern, buckets):
    """Every finished request through the reference: the gap by which each
    served token's logit lies below the reference's best at its position.
    ``logit_gap_mean`` is the mean over all served tokens; under the MoE's
    top-2 routing bf16 activations flip a near-tied choice now and then,
    and one flip moves that position's logits by O(1), so the widest gap
    (logged) swings with the count of flips while the mean is steady.
    ``logit_gap_worst_request`` is the largest of the median gaps of the
    requests that served the mix's ``median_from`` tokens or more (a
    shorter request's median swings with a near tie): a request whose
    tokens are wrong (one slot among many) moves the mean little and its
    median much.  With the control, the same of the token that the float8
    reference puts first."""
    if not finished:
        raise BenchError("no request finished in the window")
    ref.no_tf32()
    t0 = time.perf_counter()
    w = dict(inputs.initial_leaves(ctx.arch, ctx.seed, ctx.device))
    seen = {"program": [], "control": []}
    for tr in finished:
        prompt = torch.as_tensor(tr.prompt, device=ctx.device).long()
        toks = torch.as_tensor(tr.request.out_tokens,
                               device=ctx.device).long()
        chunks = chunk_schedule(len(tr.prompt), buckets)
        logits = ref.served_logits(ctx.arch, w, prompt, toks, chunks, pattern)
        seen["program"].append(compare.token_gaps(logits, toks))
        if ctx.options.get("control"):
            low = ref.served_logits(ctx.arch, w, prompt, toks, chunks,
                                    pattern, prec="fp8")
            seen["control"].append(compare.token_gaps(logits,
                                                      low.argmax(-1)))
    served = sum(tr.n_out for tr in finished)
    ctx.log(f"compared {served} served tokens of {len(finished)} requests "
            f"in {time.perf_counter() - t0:.1f} s")
    out, least = {}, ctx.traffic["median_from"]
    for who, gs in seen.items():
        if gs:
            g = torch.cat(gs)
            ctx.log(f"{who} gaps: {compare.gap_summary(g)}")
            out[who] = {"logit_gap_mean": float(g.float().mean()),
                        "logit_gap_worst_request": max(
                            (float(r.float().median()) for r in gs
                             if r.numel() >= least), default=0.0)}
    return out["program"], out.get("control")
