#!/usr/bin/env python3
"""Build and run the PyTorch port on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

1. Card: name and power limit, versions, and the ``nvcc`` build of every
   CUDA source of ``src/repro_torch/csrc`` (for ``sm_90a``).
2. Kernel vs plain version: the Segment SpMM kernel on the shapes the main
   paths give it (granite-3-8b's up/gate and down FFN patterns at N = 4,
   16, 64, B in bf16 and fp32; the training width N = 2048), plus a
   ``fold_len=8`` plan, an ``n_lanes=4, unroll=2`` plan and a pattern with
   empty block rows, and its ``transpose_lhs`` mode on the up and down grad
   plans (dx = Wᵀ @ dy at N = 4, 64, 2048), each held against the plain
   torch version on the same inputs.  Times are device times (CUDA-graph
   replays between CUDA events); the bound is the larger of the bytes over
   3.35 TB/s and the fp32 operations over 67 TFLOP/s (H100 SXM data
   sheet); ``library_ms`` times one ``torch.sparse_bsr_tensor @ B`` call
   (of W, or of Wᵀ built once), a yardstick the port never calls.  Then a
   sweep of small plans at the kernel's edges, in both modes (block sizes,
   folds, lanes, ragged N, layouts, output dtype, a mode that must raise).
3. Serve: granite-3-8b at full published width (all 40 layers, random
   weights from ``SEED``) with the block-sparse FFN, through ``Engine``:
   6 requests, 4 slots.  The kernel's launch count over that run must be
   3 projections × 40 layers × model calls.  One decode step's logits on
   the ``"cuda"`` backend are held against the ``"reference"`` backend,
   and one decode step is profiled (device busy share, top operations).
   Then 32 decode steps with all 4 slots live are timed one by one.
4. Train: the same model (40 layers, full width, remat on) on batches of
   8 × 256 tokens with fp32 AdamW.  One step's loss and gradients on the
   ``"cuda"`` backend are held against the ``"reference"`` backend, then
   ``Trainer.run`` takes ``TRAIN_STEPS`` steps (loss, grad norm, ms/step,
   tokens/s; the kernel's launch count must be 3 projections × 40 layers ×
   (2 forward with remat + 1 transposed) per step), and one step is
   profiled.

Prints a JSON line of kernel numbers and, last, ``{"ok": true, ...}``.
Exits non-zero without that line when there is no CUDA device, when the
package is not beside this script, or when any check fails.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # fp32 outside the tensor cores, same source
KERNEL_RTOL = 1e-5             # both sides accumulate fp32, in other orders
# bf16 activations round at 2**-8; a one-ulp flip after the sparse FFN
# (fp32 kernel vs fp32 dense matmul, other summation order) propagates
# through 40 layers, so the logits agree to bf16 noise, not to fp32
LOGIT_RTOL = 5e-2
# the train phase's cuda-vs-reference check: the same bf16 rounding noise,
# now through 40 layers forward and 40 back.  The loss is a mean over 2048
# tokens, which averages the noise; the gradients are compared by their
# norm-relative error ||cuda - ref|| / ||ref||, of the same order as the
# logits' max error; the global norm sums all of them.
LOSS_RTOL = 1e-3
GRAD_RTOL = 5e-2
GNORM_RTOL = 2e-2
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 8, 256       # launch/train.py's defaults


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def device_ms(fn, reps=20, replays=5):
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph
    and replayed between CUDA events, so the host's launch path (Python,
    ctypes) is not in the number."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")
    for src, lib in libs.items():
        log = Path(str(lib) + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [l.split("Used ")[1] for l in lines if "Used " in l]
        # "Function properties for <name>" precedes "<n> bytes stack
        # frame, <s> bytes spill stores, <l> bytes spill loads"
        name, spilling = "", []
        for l in lines:
            if "Function properties for" in l:
                name = l.split("for ")[-1].strip()
            elif "spill stores" in l:
                nums = [int(w) for w in l.replace(",", " ").split()
                        if w.isdigit()]
                if any(nums):
                    spilling.append(f"{name}: {l.strip()}")
        print(f"[build] {src} -> {lib.name}: {len(regs)} kernels, "
              f"registers {sorted({int(r.split(' ')[0]) for r in regs})}, "
              f"kernels with a stack frame or spills {len(spilling)}")
        for line in spilling:
            print(f"[build]   {line}")
        check(lib.exists(), f"{src} did not build")
    return smi


def _bsr_tensor(plan, transpose=False):
    """The library's BSR tensor of W (or of Wᵀ) from a forward plan."""
    gm, gk = plan.grid
    bm, bk = plan.block_shape
    rows, cols, vals = plan.a_brow.long(), plan.a_bcol.long(), plan.lhs_blocks
    shape = (gm * bm, gk * bk)
    if transpose:
        order = torch.argsort(cols * gm + rows)
        rows, cols = cols[order], rows[order]
        vals = vals[order].transpose(1, 2).contiguous()
        gm, shape = gk, shape[::-1]
    crow = torch.zeros(gm + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.bincount(rows, minlength=gm).cumsum(0)
    return torch.sparse_bsr_tensor(crow, cols, vals, size=shape)


def kernel_case(label, plan, b, transpose=False, library=None):
    """Kernel vs plain version on one forward plan and one B; with
    ``transpose`` the kernel runs the plan's grad plan in ``transpose_lhs``
    mode against the forward blocks (dx = Wᵀ @ B).  Returns a record."""
    from repro_torch.kernels.segment_spmm import (segment_spmm,
                                                  segment_spmm_plain)
    sched = plan.grad_plan if transpose else plan

    def kern():
        return segment_spmm(
            plan.lhs_blocks, sched.slot_idx, sched.m_idx, sched.k_idx,
            sched.seg_start, sched.seg_write, sched.accum_prev, sched.valid,
            b, grid_m=sched.grid_m, n_lanes=sched.n_lanes,
            unroll=sched.unroll, transpose_lhs=transpose,
            runs=sched.run_offsets)

    def plain():
        return segment_spmm_plain(plan.lhs_blocks, sched.slot_idx,
                                  sched.m_idx, sched.k_idx, sched.valid, b,
                                  grid_m=sched.grid_m,
                                  transpose_lhs=transpose)

    live = torch.repeat_interleave(sched.row_mask > 0, sched.block_shape[0])
    got, want = kern()[live], plain()[live]
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(rel_err <= KERNEL_RTOL, f"{label}: kernel vs plain {rel_err:.3g} "
                                  f"> {KERNEL_RTOL}")
    nb = plan.n_blocks
    bm, bk = plan.block_shape
    k, n = b.shape
    m = sched.grid_m * sched.block_shape[0]
    nbytes = nb * bm * bk * 4 + k * n * b.element_size() + m * n * 4
    ops = 2 * int(sched.valid.sum()) * bm * bk * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    # wide cases run for milliseconds: fewer captured calls suffice
    reps = 20 if n <= 64 else 4
    rec = dict(case=label, mode="transpose_lhs" if transpose else "forward",
               n=n, b_dtype=str(b.dtype).removeprefix("torch."),
               rel_err=rel_err, max_abs_err=abs_err,
               ms=device_ms(kern, reps), plain_ms=device_ms(plain, reps),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    # the library's BSR x dense product, timed on fp32 B; the lane count
    # changes only the schedule, so every case has the same library call
    a_bsr = library if library is not None else _bsr_tensor(plan, transpose)
    b32 = b.float()
    rec["library_ms"] = device_ms(lambda: a_bsr @ b32, reps)
    print(f"[kernel] {label:<28} n={n:<4} B={rec['b_dtype']:<8} "
          f"rel_err={rel_err:.2e} kernel_ms={rec['ms']:.4f} "
          f"plain_ms={rec['plain_ms']:.4f} bound_us={rec['bound_ms'] * 1e3:.2f}"
          f" ({rec['bound_by']}) library_ms={rec['library_ms']:.4f}")
    return rec


def phase_kernels(model, dev):
    from repro_torch import api
    from repro_torch.core.formats import BSR

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    mlp = model.layers[0].mlp
    plans = {p: getattr(mlp, p).plan.with_values(getattr(mlp, p).blocks.data)
             for p in ("up", "down")}
    recs = []
    for proj, plan in plans.items():
        k = plan.grid_k * plan.block_shape[1]
        lib = _bsr_tensor(plan)
        for n, dts in ((4, (torch.bfloat16, torch.float32)),
                       (16, (torch.bfloat16, torch.float32)),
                       (64, (torch.bfloat16, torch.float32)),
                       (2048, (torch.bfloat16,))):
            for dt in dts:
                x = torch.randn(n, k, generator=gen, device=dev).to(dt)
                # the main path's layouts: up/gate read x.T (a transposed
                # view), down reads h.T, which is contiguous
                b = x.T if proj == "up" else x.T.contiguous()
                recs.append(kernel_case(f"{proj}", plan, b, library=lib))
    for proj, plan in plans.items():
        m = plan.grid_m * plan.block_shape[0]
        lib = _bsr_tensor(plan, transpose=True)
        for n in (4, 64, 2048):
            # the backward pass hands dx's kernel dy as a bf16 transposed
            # view (the gradient of the layer's y.T)
            dy = torch.randn(n, m, generator=gen, device=dev).bfloat16()
            recs.append(kernel_case(f"{proj} dx (transpose_lhs)", plan, dy.T,
                                    transpose=True, library=lib))
    up = plans["up"]
    bm, bk = up.block_shape
    w = BSR((up.grid_m * bm, up.grid_k * bk), up.block_shape,
            up.a_brow.cpu().numpy(), up.a_bcol.cpu().numpy(),
            up.lhs_blocks.cpu().numpy())
    keep = w.brow % 7 != 3
    holes = BSR(w.shape, w.block_shape, w.brow[keep], w.bcol[keep],
                w.blocks[keep])
    extra = {"up fold_len=8": (w, dict(fold_len=8)),
             "up n_lanes=4 unroll=2": (w, dict(n_lanes=4, unroll=2)),
             "up empty block rows": (holes, {})}
    for label, (mat, kw) in extra.items():
        plan = api.plan_matmul(mat, 16, device=dev, **kw)
        x = torch.randn(16, mat.shape[1], generator=gen, device=dev)
        recs.append(kernel_case(label, plan, x.T.to(torch.bfloat16)))
    return recs


def phase_edges(dev):
    """Small plans at the edges of what the kernel takes: 32 and 64 blocks,
    folded, multi-lane, unrolled, static-order and holed schedules, N of 1,
    5 and 100 (ragged tiles), B as a bf16 transposed view or contiguous
    fp32; each through ``execute_plan`` against the plain version and the
    dense oracle, in the forward mode and in the ``transpose_lhs`` mode on
    the plan's grad plan.  Also the bf16-output folded reload, and the mode
    that must raise on the card."""
    from repro_torch import api
    from repro_torch.core.formats import BSR
    from repro_torch.kernels.segment_spmm import segment_spmm_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst, count = {False: 0.0, True: 0.0}, {False: 0, True: 0}
    for block in (32, 64):
        a = BSR.random(np.random.default_rng(block), (12 * block, 9 * block),
                       (block, block), 0.35)
        keep = a.brow % 3 != 1
        holes = BSR(a.shape, a.block_shape, a.brow[keep], a.bcol[keep],
                    a.blocks[keep])
        variants = [(a, {}), (a, {"fold_len": 2}),
                    (a, {"n_lanes": 4, "unroll": 2}),
                    (a, {"policy": "outer", "n_lanes": 2}), (holes, {})]
        for mat, kw in variants:
            for n in (1, 5, 100):
                fwd = api.plan_matmul(mat, n, device=dev, with_grad=True,
                                      **kw)
                for transpose in (False, True):
                    plan = (fwd.grad_plan.with_values(fwd.lhs_blocks)
                            if transpose else fwd)
                    k = mat.shape[0] if transpose else mat.shape[1]
                    for dt, transposed in ((torch.bfloat16, True),
                                           (torch.float32, False)):
                        x = torch.randn((n, k) if transposed else (k, n),
                                        generator=gen, device=dev).to(dt)
                        b = x.T if transposed else x
                        got = plan(b)
                        plain = segment_spmm_plain(
                            plan.lhs_blocks, plan.slot_idx, plan.m_idx,
                            plan.k_idx, plan.valid, b, grid_m=plan.grid_m,
                            transpose_lhs=transpose)
                        want = plan(b, backend="reference")
                        scale = float(want.abs().max())
                        err = max(float((got - plain).abs().max()),
                                  float((got - want).abs().max())) / scale
                        check(err <= KERNEL_RTOL,
                              f"edge block={block} {kw} n={n} {dt} "
                              f"transpose_lhs={transpose}: {err:.3g}")
                        worst[transpose] = max(worst[transpose], err)
                        count[transpose] += 1
        plan = api.plan_matmul(a, 16, fold_len=1, device=dev, with_grad=True)
        b = torch.randn(a.shape[1], 16, generator=gen, device=dev)
        got = plan(b, out_dtype=torch.bfloat16)
        want = plan(b, backend="reference")
        # each folded segment is stored and reloaded in bf16 (2**-8 each)
        err = float((got.float() - want).abs().max() / want.abs().max())
        check(got.dtype == torch.bfloat16 and err <= 1e-2,
              f"bf16 folded reload: {err:.3g}")
        try:
            api.plan_matmul(a, 4, device=dev, prefetch="cross_pass")(b)
        except NotImplementedError:
            pass
        else:
            raise RuntimeError("cross_pass ran on the card instead of raising")
    print(f"[edges] forward: {count[False]} plans x layouts, transpose_lhs "
          f"(grad plans): {count[True]}, all within {KERNEL_RTOL} of the "
          f"plain version and the oracle (worst {worst[False]:.2e} / "
          f"{worst[True]:.2e}); bf16 folded reload ok; cross_pass raises "
          f"NotImplementedError")


def device_busy_us(prof):
    """Time in which the card ran anything (kernels, copies): the union of
    the device-side intervals of the trace.  Summing ``key_averages()``
    instead counts each kernel twice, under the operator that launched it
    and as the kernel itself."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def profile_once(label, fn):
    """``fn()`` once under torch.profiler (after the caller warmed it up):
    device busy and idle share, the top device kernels and host
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy = device_busy_us(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, device idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in events)} ops")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[profile]   device {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5} "
              f"{e.key[:150]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms  "
              f"x{e.count:<5} {e.key[:150]}")


def phase_profile(model, engine, dev):
    """One batched decode step under torch.profiler: where its time goes."""
    tok = torch.randint(0, model.cfg.vocab, (engine.slots, 1), device=dev)
    pos = torch.tensor([30, 41, 52, 63], device=dev)[:engine.slots]
    cache = {k: v.clone() for k, v in engine.cache.items()}
    with torch.inference_mode():
        model.decode_step(cache, tok, pos)
        profile_once("decode step", lambda: model.decode_step(cache, tok, pos))


def steady_decode(model, rng, slots=4, steps=32):
    """Decode with every slot live: ``slots`` equal requests are admitted
    (prefill, not timed), then ``steps`` batched decode steps are timed
    one by one (each ends in the host's read of the next tokens)."""
    from repro_torch.runtime import Engine, Request

    engine = Engine(model, slots=slots, max_len=256, prefill_buckets=(64, 16))
    for _ in range(slots):
        engine.submit(Request(prompt=rng.integers(0, model.cfg.vocab, 32),
                              max_new_tokens=steps + 1))
    engine.admit_pending()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        live = engine.step()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(live == slots, f"steady decode: {live} of {slots} slots live")
    med = float(np.median(ms))
    print(f"[steady] {steps} decode steps, all {slots} slots live: median "
          f"{med:.2f} ms/step (min {min(ms):.2f}, max {max(ms):.2f}), "
          f"{slots * 1e3 / med:.1f} tok/s")


def phase_serve(model, dev):
    from repro_torch.api import use_backend
    from repro_torch.kernels.segment_spmm import segment_spmm
    from repro_torch.runtime import Engine, Request

    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    # warm-up on its own engine (cuBLAS handles, allocator), not counted
    Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16)).generate(
        [Request(prompt=rng.integers(0, cfg.vocab, 20), max_new_tokens=2)])

    reqs = [Request(prompt=rng.integers(0, cfg.vocab, int(rng.integers(5, 61))),
                    max_new_tokens=8) for _ in range(6)]
    engine = Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16))
    for r in reqs:
        engine.submit(r)
    t_prefill = t_decode = 0.0
    decode_tokens = 0
    torch.cuda.synchronize()
    segment_spmm.launches = 0
    while True:
        t0 = time.perf_counter()
        engine.admit_pending()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        live = engine.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not live:
            break
        t_prefill += t1 - t0
        t_decode += t2 - t1
        decode_tokens += live
    launches = segment_spmm.launches
    calls = engine.decode_calls + engine.prefill_calls
    for r in reqs:
        check(r.out_tokens is not None and r.out_tokens.size == 8,
              f"request {r.rid} got {r.out_tokens}")
    want = 3 * cfg.n_layers * calls
    check(launches == want, f"kernel launches {launches} != 3 x "
                            f"{cfg.n_layers} x {calls} model calls")
    prompt_tokens = sum(r.prompt.size for r in reqs)
    print(f"[serve] {len(reqs)} requests, {prompt_tokens} prompt tokens, "
          f"{decode_tokens} decoded; model calls {calls} "
          f"({engine.prefill_calls} prefill chunks, {engine.decode_calls} "
          f"decode steps); segment_spmm launches {launches} == 3 x "
          f"{cfg.n_layers} x {calls}; step shapes {engine.compiled_shapes}")
    print(f"[serve] this request mix: prefill {prompt_tokens / t_prefill:.1f}"
          f" tok/s ({t_prefill:.3f} s); decode {decode_tokens} tokens in "
          f"{engine.decode_calls} steps "
          f"({decode_tokens / engine.decode_calls:.2f} live slots per step, "
          f"ramp-down included), "
          f"{1e3 * t_decode / engine.decode_calls:.2f} ms/step, "
          f"{decode_tokens / t_decode:.1f} tok/s")

    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).to(dev)
    pos = torch.tensor([40, 51, 62, 73], device=dev)
    logits = {}
    with torch.inference_mode():
        for backend in ("cuda", "reference"):
            cache = {k: v.clone() for k, v in engine.cache.items()}
            with use_backend(backend):
                logits[backend], _ = model.decode_step(cache, tok, pos)
    got, want = logits["cuda"].float(), logits["reference"].float()
    check(got.shape == (4, cfg.padded_vocab), f"logits shape {got.shape}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[serve] decode logits cuda vs reference: rel_err {rel:.3e} "
          f"(tol {LOGIT_RTOL}), top-1 agreement {top1:.2f}")
    check(rel <= LOGIT_RTOL, f"logits rel err {rel} > {LOGIT_RTOL}")
    phase_profile(model, engine, dev)
    steady_decode(model, rng)
    return launches


def _grads_on(model, batch, backend):
    """Loss and gradients of one step on ``backend`` (gradients are taken
    off the parameters again, so two backends can be compared)."""
    from repro_torch.api import use_backend
    with use_backend(backend):     # the remat recompute runs in backward()
        loss, _ = model.loss_fn(batch)
        loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def phase_train(model, dev):
    """Train at full width: cuda-vs-reference gradients, ``Trainer.run``,
    one profiled step.  Returns the launch counts of the training run."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.segment_spmm import segment_spmm
    from repro_torch.runtime import Trainer, TrainerConfig, make_train_step

    cfg = model.cfg
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 1).batch(0).items()}
    per_step = 3 * cfg.n_layers * 3     # 2 forward (remat) + 1 dx each

    # (a) one step's loss and gradients, cuda vs reference, before the
    # optimizer state exists
    picked = [f"layers.{i}.mlp.{p}.blocks" for i in (0, cfg.n_layers - 1)
              for p in ("up", "gate", "down")] + ["layers.0.attn.wq.w"]
    seen = {}
    for backend in ("cuda", "reference"):
        segment_spmm.launches = segment_spmm.transposed_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _grads_on(model, batch, backend)
        ms = (time.perf_counter() - t0) * 1e3
        if backend == "cuda":
            check(segment_spmm.launches == per_step
                  and segment_spmm.transposed_launches == per_step // 3,
                  f"gradient step launches {segment_spmm.launches} "
                  f"({segment_spmm.transposed_launches} transposed) != "
                  f"{per_step} ({per_step // 3})")
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()])))
        check(np.isfinite(loss) and np.isfinite(norm),
              f"{backend}: loss {loss}, grad norm {norm}")
        seen[backend] = (loss, norm, {k: grads[k].clone() for k in picked})
        del grads
        print(f"[train] gradient step on {backend}: loss {loss:.5f}, grad "
              f"norm {norm:.5f}, {ms:.1f} ms")
    (l_cuda, n_cuda, g_cuda), (l_ref, n_ref, g_ref) = (seen["cuda"],
                                                       seen["reference"])
    errs = {k: float(torch.linalg.vector_norm(g_cuda[k] - g_ref[k])
                     / torch.linalg.vector_norm(g_ref[k])) for k in picked}
    loss_err = abs(l_cuda - l_ref) / abs(l_ref)
    norm_err = abs(n_cuda - n_ref) / n_ref
    print(f"[train] cuda vs reference: loss {loss_err:.3e} (tol "
          f"{LOSS_RTOL}), grad norm {norm_err:.3e} (tol {GNORM_RTOL}), "
          f"gradients (norm-relative, tol {GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(loss_err <= LOSS_RTOL, f"loss cuda vs reference {loss_err:.3g}")
    check(norm_err <= GNORM_RTOL, f"grad norm cuda vs reference "
                                  f"{norm_err:.3g}")
    for k, v in errs.items():
        check(v <= GRAD_RTOL, f"{k} gradient cuda vs reference {v:.3g}")
    del seen, g_cuda, g_ref

    # (b) the training run: no checkpoint directory (55 GB of state)
    tcfg = TrainerConfig(steps=TRAIN_STEPS, log_every=1, warmup=2)
    trainer = Trainer(model, cfg, shape, tcfg, seed=SEED)
    probe = {k: p.detach()[:2].clone() for k, p in trainer.params.items()
             if k in picked}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segment_spmm.launches = segment_spmm.transposed_launches = 0
    out = trainer.run()
    launches = segment_spmm.launches
    transposed = segment_spmm.transposed_launches
    peak = torch.cuda.max_memory_allocated()
    for h in out["history"]:
        print(f"[train] step {h['step']}: loss {h['loss']:.5f}, grad norm "
              f"{h['grad_norm']:.5f}, {h['ms']:.1f} ms/step, "
              f"{tokens * 1e3 / h['ms']:.0f} tokens/s")
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"step {h['step']}: non-finite loss or grad norm")
    check(len(out["history"]) == TRAIN_STEPS, "a step was not logged")
    moved = [k for k, v in probe.items()
             if not torch.equal(trainer.params[k].detach()[:2], v)]
    check(len(moved) == len(probe), f"parameters that did not move: "
                                    f"{sorted(set(probe) - set(moved))}")
    check(launches == per_step * TRAIN_STEPS
          and transposed == per_step // 3 * TRAIN_STEPS,
          f"training launches {launches} ({transposed} transposed) != "
          f"{per_step} x {TRAIN_STEPS} ({per_step // 3} x {TRAIN_STEPS})")
    steady = float(np.median([h["ms"] for h in out["history"][1:]]))
    print(f"[train] {cfg.name} full width, {cfg.n_layers} layers, remat "
          f"{cfg.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} "
          f"steps, median of steps 1..{TRAIN_STEPS - 1} {steady:.1f} ms/step "
          f"({tokens * 1e3 / steady:.0f} tokens/s); segment_spmm launches "
          f"{launches} == {per_step} x {TRAIN_STEPS} ({transposed} "
          f"transposed); peak {peak / 2**30:.2f} GiB")

    # (c) one more step under the profiler
    step_fn = make_train_step(model, trainer.opt, 1)
    nxt = {k: torch.from_numpy(v).to(dev)
           for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    profile_once("training step", lambda: step_fn(trainer.opt_state, nxt))
    return launches, transposed


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_card()

    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              ffn_block_sparse=True, ffn_block=64,
                              ffn_density=0.25, dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] {cfg.name} full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}); {n_params / 1e9:.3f} B fp32 params; built "
          f"and planned in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    recs = phase_kernels(model, dev)
    phase_edges(dev)
    launches = phase_serve(model, dev)
    print(f"[memory] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gc.collect()                     # the serving engines and their caches
    torch.cuda.empty_cache()
    train_launches, transposed = phase_train(model, dev)

    def entry(name, mode, path, n_launches, main_rec):
        mine = [r for r in recs if r["mode"] == mode]
        return {"name": name, "route": "cuda", "mode": mode, "path": path,
                "source": "src/repro_torch/csrc/segment_spmm.cu",
                "replaces": "src/repro/kernels/segment_spmm.py:335",
                "launches": n_launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"], "n": main_rec["n"]}

    # forward: up projection at decode width, bf16 x.T view (the serve
    # path); transpose_lhs: up's dx at the training width (the train path)
    fwd_rec = recs[0]
    t_rec = next(r for r in recs if r["mode"] == "transpose_lhs"
                 and r["case"].startswith("up") and r["n"] == 2048)
    print(smi)
    print(json.dumps({"kernels": [
        entry("segment_spmm", "forward", "serve", launches, fwd_rec),
        entry("segment_spmm.transpose_lhs", "transpose_lhs", "train",
              transposed, t_rec)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
