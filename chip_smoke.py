#!/usr/bin/env python3
"""Build and run the PyTorch port on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

1. Card: name and power limit, versions, and the ``nvcc`` build of every
   CUDA source of ``src/repro_torch/csrc`` (for ``sm_90a``), all at once.
2. SpGEMM (before the model exists, so its transients never meet the
   model's): ``plan_matmul(A, B)`` → ``plan()`` on granite-3-8b's FFN
   shapes (W_down @ W_up and W_up @ W_down, 64×64 blocks at 25 % density,
   from ``SEED``), in fp32 and, on W_up @ W_down, in the four quantized
   modes (int8/fp8, per block or rowwise); exactly one Segment SpGEMM
   launch per ``plan()``, all six on the tensor-core path (``"tc"``, by
   its own count).  Each result is held against the kernel's plain
   version and the ``"reference"`` backend (≤ 1e-5), and a quantized one
   against the fp32 result (int8 < 5e-2, fp8 < 1e-1).  Each case runs on
   every path that takes it (``"tc"`` and the CUDA-core ``"simt"``), each
   held against the plain version and timed beside that path's bound
   (bytes, or operations × bf16 passes at the tensor-core peak on
   ``"tc"`` and at the fp32 CUDA-core peak on ``"simt"``) and the bytes
   it moves into the SMs; the
   plain version's time and the library's dense fp32 product (cuBLAS,
   TF32 off) beside one ``torch.sparse.mm`` of CSR tensors (cuSPARSE).
   Then 99 small plans at the kernels' edges (5 schedules × 5 storage
   modes × 32 and 64 tiles, each on every path that takes it; the eight
   tile shapes of 32 and 64, non-square ones included, on ``"simt"``),
   bf16 output, an empty symbolic C (no launch), a one-item plan, and
   tiles of 16 and 128 that must raise.
3. Ops ([ops], before the model exists; its tensors are freed after it):
   ``repro_torch.kernels.ops``'s three entry points on their kernels at
   published widths, each call with its exact launch count (1 per
   ``flash_mha`` and ``rg_lru_scan``, 2 x top_k per ``moe_apply``):
   ``flash_mha`` (fp32, causal; granite's also in bf16 beside a bf16
   SDPA) at granite-3-8b's heads (prefill 1 x 4096 and decode 4 x 1 over
   4096 keys, each once more under ``set_sync_debug_mode("error")``) and
   RecurrentGemma-9B's local block (1 x 8192, 16 heads, one KV head, D =
   256, window 2048), each on the attention path named in
   ``OPS_ATTN_CASES`` by that path's own count (decode on ``splitkv``,
   prefill and the local block on ``tc``), and every path that can take
   the stacked call held against the plain version and timed; the
   [attn-crossover] sweep (every path at decode over 512 .. 32768 keys,
   a wider batch, a prefill chunk and prefill over T = 256 .. 8192) that
   sets ``choose_path``'s rule;
   ``rg_lru_scan`` at RecurrentGemma-9B's width (4 x 2048 x 4096 in fp32
   and bf16, one request's prefill 1 x 8192 x 4096, all three on the
   ``"tile"`` path, and a decode step with h0 on ``"simt"``, each by its
   path's own count; each case also on the other path, bit for bit equal;
   the bound the larger of bytes, fp32 operations and the SFU operations
   counted in the SASS), and the [rg_lru-crossover] sweep (both paths at T
   = 1 .. 2048, B = 4, and 1 x 8192) that sets ``TILE_MIN_T``;
   ``moe_apply`` at Llama-4
   Maverick's expert widths (128 experts, 5120 -> 8192, top-1, capacity
   1.25, bf16 x and weights) on 4096 and on 4 tokens: every launch on the
   grouped GEMM's tensor-core kernel (its own count), no host sync (one
   call under ``torch.cuda.set_sync_debug_mode("error")``), the whole
   call timed (CUDA events) and profiled once, and its up and down GEMMs
   timed with and without the live-row counts moe_apply passes, beside
   the live and the padded bound.  Each kernel is held
   against its plain version (≤ 1e-5) and each entry point against the
   port's oracle (``ref.mha_ref``, ``ref.rg_lru_ref``, a token-by-token
   MoE; ≤ 1e-5 in fp32, ≤ 1e-2 where a bf16 rounding lies between);
   device times, the plain version's time (CUDA events around host
   launches), the bound (operations at the peak of the operands' type:
   fp32 on the CUDA cores, the bf16 tensor-core peak for the MoE's bf16
   products) and a library yardstick (fp32 SDPA with ``enable_gqa``, a
   bf16 ``torch.bmm`` over the expert buffer; none for the RG-LRU).  Then
   an edge sweep (head dims, ragged shapes, masks, bf16 outputs, every
   attention edge on each path that takes it, q/k/v of mixed dtypes and
   70,000 (batch, head) rows, dropped tokens, strided operands, the
   grouped GEMM's tensor-core path at chunk, d_in and d_out edges with
   live-row counts and unsorted experts, the RG-LRU on both paths at T, D
   and dtype edges (fp16, mixed x/gate dtypes, D = 37, T = 37, B = T = 1),
   calls that must raise).
3b. Tune ([tune], before the model exists): the shared-memory closed
   forms of ``repro_torch.analysis.budget`` against every compiled
   launcher's own number (the sources' ``*_smem_bytes`` exports), exactly,
   over all 150 instantiations; a plan one byte under its need raising
   ``VmemBudgetError`` with no launch, and the same plan at the default
   limit running.  The cost model's calibration: every policy × fold of
   granite-3-8b's FFN patterns on each SpMM path (``TUNE_CASES``) and of
   the paper's suite (A @ Aᵀ) on both SpGEMM paths, CUDA-graph times,
   ``calibrate`` per path, its coefficients and residuals printed.  Then
   ``autotune_matmul(objective="cuda")`` on each case and suite matrix
   (host seconds), the winner against its plain version and the default
   plan's result (≤ 1e-5) and within ``TUNE_SLOWDOWN`` of the default's
   time; the tuned plans once through ``plan()`` (exact launches);
   ``SparseLinear.from_pattern(policy="auto")`` forward and backward vs
   the reference backend, its search counted once, then answered from
   the cache.
3c. Check ([check], before the model exists): the kernel analyzers
   (``repro_torch.analysis``: index-range, parallel-race, ring-slot-war,
   sem-balance, the order rules, vmem-budget) over the checked build of
   the kernels (``-DREPRO_CHECKED``, built beside the release libraries in
   step 1).  The faulty toys of ``csrc/check_toys.cu`` run in a child
   process, each caught by exactly its rule, the correct ring and the
   vmem toy at the default limit clean; then every shipped path at small
   shapes (SpMM split / simt / tc in both directions and five storage
   modes, a ``cross_pass`` plan, SpGEMM tc / simt, attention splitkv / tc
   / simt causal and windowed with GQA, the grouped GEMM on both kernels
   with live rows, the RG-LRU on both paths, and both backward kernels on
   both paths through autograd): no finding, every event kind its kernels
   log present, each output equal to the release kernels' bit for bit.
4. Kernel vs plain version: the Segment SpMM kernels on the shapes the
   main paths give them (granite-3-8b's up/gate and down FFN patterns at
   N = 4, 16, 64, B in bf16 and fp32; the training width N = 2048; a
   ragged N = ``RAGGED_N`` on the tensor-core path), plus a ``fold_len=8``
   plan, an ``n_lanes=4, unroll=2`` plan and a pattern with empty block
   rows, and the ``transpose_lhs`` mode on the up and down grad plans (dx
   = Wᵀ @ dy at N = 4, 64, ``RAGGED_N``, 2048), each on the path the
   wrapper picks (``choose_path``: the folded "split" kernel, the
   tensor-core "tc" kernel, or the one-block-per-run "simt" kernel for
   fp32 B), launched exactly once there, held against the plain torch
   version on the same inputs.  Times are device times (CUDA-graph
   replays between CUDA events); the bound is the larger of the bytes over
   3.35 TB/s and the operations over the peak of the path that ran: 67
   TFLOP/s fp32 on the CUDA cores, or three bf16 passes at 989 TFLOP/s on
   the tensor cores (H100 SXM data sheet); ``library_ms`` times one
   ``torch.sparse_bsr_tensor @ B`` call (of W, or of Wᵀ built once), a
   yardstick the port never calls.  A forward and a dx call on each new
   path run under ``torch.cuda.set_sync_debug_mode("error")``.
   [crossover]: both new paths on the same up, down and up-dx calls at
   N = 4, 16, 32, 64, ``RAGGED_N`` and 2048, which sets ``TC_MIN_N``.  Then a
   sweep of small plans at the kernels' edges, in both modes (block sizes,
   folds, lanes, ragged N, layouts, output dtype, each new path forced on
   every schedule with fp32 and bf16 output, the bf16 folded reload on
   every path, and ``prefetch="cross_pass"`` plans, forward and dx in
   fp32, int8 and fp8, equal to the drained plans bit for bit on every
   path).
5. Serve: granite-3-8b at full published width (all 40 layers, random
   weights from ``SEED``) with the block-sparse FFN, through ``Engine``:
   6 requests, 4 slots.  The kernel's launch count over that run must be
   3 projections × 40 layers × model calls.  One decode step's logits on
   the ``"cuda"`` backend are held against the ``"reference"`` backend,
   and one decode step is profiled (device busy share, top operations).
   Then 32 decode steps with all 4 slots live are timed one by one; every
   decode launch must take the split path.
6. Quantized kernel ([qkernel]): the Segment SpMM kernel's int8 / fp8
   payload modes (per-block and rowwise scales) on layer 0's up and down
   blocks as ``SparseLinear.quantize`` freezes them, forward at N = 4, 16,
   64, ``RAGGED_N`` and ``transpose_lhs`` at N = 4, 64 (on the path the
   wrapper picks, and on the up projection also on the other new path),
   each held against its plain
   version (≤ 1e-5), against the fp32 kernel on the dequantized blocks
   (≤ 1e-5) and against the fp32 kernel on the source blocks (int8 <
   5e-2, fp8 < 1e-1); device times, the bound of the path that ran (bytes
   of payload, scales, B and C; operations at the fp32 peak on the split
   path, as one or three bf16 passes on the tensor cores) and, as a
   yardstick, the library's fp32 BSR product of the dequantized blocks.
7. Quantized serving ([qserve]): ``Engine(model, quantize=mode)`` for int8
   and fp8 on the serve phase's 6 requests (every launch quantized, 120
   per decode step; decode logits ``"cuda"`` vs ``"reference"`` ≤ 5e-2;
   greedy drift against the fp32 engine's tokens within ``repro``'s
   bounds, int8 ≤ 0.25 and fp8 ≤ 0.5), a profiled decode step, 32 steady
   decode steps and peak memory; then an int8 engine over an int8 KV cache
   (prefill chunks of at most 8), its decode logits against the reference
   backend.  [qgrad]: one loss and backward pass through the int8 model on
   1 × 64 tokens, so dx runs the quantized ``transpose_lhs`` mode (loss and
   gradients against the reference backend).
8. Train: the same model (40 layers, full width, remat on) on batches of
   8 × 256 tokens with fp32 AdamW.  One step's loss and gradients on the
   ``"cuda"`` backend are held against the ``"reference"`` backend, then
   ``Trainer.run`` takes ``TRAIN_STEPS`` steps (loss, grad norm, ms/step,
   tokens/s; the kernel's launch count must be 3 projections × 40 layers ×
   (2 forward with remat + 1 transposed) per step, all on the tensor-core
   path), and one step is profiled.
9. Verify ([verify], after training, before granite is freed): every
   ``SparseLinear`` plan of the served and trained model (40 layers × 3
   projections, each with its grad plan, in fp32 and quantized to int8
   and fp8) planned again with ``verify="fast"``, then ``"full"``: every
   template verified once per level, zero findings, the count and the
   host seconds of each level (the planner pass, and ``verify_plan``'s
   calls timed within it) printed; the hybrid's 12 sparse FFNs the same way in [hybrid].
   Layer 0's up plan on the card verifies clean; with one ``a_fetch``
   item flipped ``verify_plan`` reports exactly ``fetch-on-change`` there
   and ``execute_plan(..., verify=True)`` raises with no launch. Then the
   paper's suite (``sim.matrices.suite(scale_cap=2048)``, blocked at
   64×64 by ``BSR.from_dense``): A @ Aᵀ as SpGEMM and A @ X (64 fp32
   columns) as SpMM, planned with ``verify="full"``, each once through
   ``plan()`` on the path ``choose_path`` picks (exact launch counts per
   path), held against ``spgemm_reference``, ``to_dense() @ X`` and the
   plain versions (≤ 1e-5); the C blocks and host planning seconds
   printed, and the largest case of each timed beside its bound.
10. Hybrid ([hybrid], after granite-3-8b, its engines and its optimizer
   state are freed): RecurrentGemma-9B at full published width (38
   layers: 26 RG-LRU blocks with a dense SwiGLU, 12 local-attention blocks,
   window 2048, with the block-sparse FFN; bf16 activations, random
   weights from ``SEED``).  ``Engine(slots=4, max_len=256)`` on the serve
   phase's request mix, prefilled one token at a time (``prefill_buckets
   == (1,)``): per model call exactly 26 ``rg_lru`` launches, all on
   ``simt``, 3 x 12 SpMM launches, all on the split path, and no
   ``flash_attention`` (the ring cache's attention is torch); a decode
   step's logits on ``"cuda"`` vs ``"reference"`` (≤ ``LOGIT_RTOL``), a
   profiled decode step, 32 steady 4-slot steps.  ``rg_lru`` at the
   model's (4, 1, 4096) and (1, 4096, 4096) bf16 calls on both paths and
   ``flash_attention`` at its local blocks' 1 x 4096 bf16 forward call
   on every path, against their plain versions and timed.  ``forward`` on
   1 x 4096 tokens (twice the window): exactly 26 ``rg_lru`` on ``tile``,
   12 ``flash_attention`` on ``tc``, 36 SpMM on the tensor cores; its time
   and peak memory.  Last, the logits of ``forward`` over 64 tokens
   against 64 ``decode_step`` calls over the same tokens (≤
   ``LOGIT_RTOL``): the forward kernels against the decode ones and the
   ring cache.
10b. Mixed ([mixed]): RecurrentGemma-9B's widths with full-attention
   layers beside its local ones (``layer_pattern=("attn", "local")``,
   ``MIXED_LAYERS`` layers): the two KV cache groups, ``forward`` over 1 x
   4096 tokens with each layer's ``flash_attention`` launches counted
   (one ``tc`` launch per local layer, none per full-attention layer),
   forward vs stepwise decode, the serve mix through ``Engine``.
11. Hybrid training ([hybrid_train], after [hybrid]'s model is freed): the
   two backward kernels against their plain versions on every path that
   takes each call, ``rg_lru_bwd`` at the model's (1, 4096, 4096) bf16
   call and at (4, 2048, 4096) fp32 (``tile``, the one training takes,
   and ``simt``; dx, da_gate, dx_gate and dh0 of the two bit for bit,
   da_param within 1e-6) and at a short ragged (4, 100, 4096) bf16 call,
   ``flash_attention_bwd`` at the local block's 1 x 4096 call in bf16 and
   fp32 on both of its paths (``tc``, the one training takes, and
   ``simt``; after the forward kernel's row statistics are held against
   the plain forward's) and at small ragged bf16 (both paths) and fp32 D =
   40 (``simt``) calls, each path's two calls bit for bit
   (``KERNEL_RTOL`` in fp32,
   ``BF16_RTOL`` across a bf16 rounding), each timed beside its bound, its
   plain version and (attention) an fp32 SDPA forward + backward (and a
   bf16 one for bf16 calls); then
   RecurrentGemma-9B at full width with its depth cut 38 -> 6 layers (two
   ``(rec, rec, local)`` units, the block-sparse FFN, remat) on 1 x 4096
   tokens: one step's loss and gradients on ``"cuda"`` vs ``"reference"``
   (the granite training gates) with exact launches per path (per step:
   8 ``rg_lru`` on tile, 4 ``rg_lru_bwd`` on tile, 4 ``flash_attention``
   on tc, 2 ``flash_attention_bwd`` on tc, 18 SpMM on the tensor cores, 6
   of them transposed), then 3 ``Trainer`` steps with the same counts,
   ms/step and peak memory, and one profiled step.
12. The last four families, each built at published width after the
   earlier models are freed (bf16 activations, fp32 parameters, random
   weights from ``SEED``), each holding a decode step's logits against the
   ``"reference"`` backend and ``forward`` against stepwise decode (≤
   ``LOGIT_RTOL``) and printing its times and peak memory.  [ssm]
   RWKV-6 1.6B, all 24 layers: the serve mix (one token a prefill call),
   32 steady steps, ``forward`` over 1 x ``SSM_FORWARD_T`` tokens (the wkv
   recurrence is a torch loop: no kernel launches).  [moe] Phi-3.5-MoE,
   depth cut to ``MOE_LAYERS``: the mix with prefill buckets (64, 16), so
   chunks pad and drop tokens (every call's kept-token count printed;
   decode steps drop none), 32 steady steps, ``forward`` + aux over 1 x
   ``MOE_FORWARD_T`` tokens; forward vs one decode_step over the same
   tokens (the same capacity) and, with the capacity factor at the expert
   count so nothing drops, vs 64 stepwise steps.  [vlm] InternVL2-2B, all
   24 layers, block-sparse FFN: ``forward`` over 256 vision + 1024 text
   positions (72 SpMM launches, all tc), the mix served text-only (72
   split launches a decode step) and by ``Engine(quantize="int8")`` (every
   launch quantized), the SpMM kernel vs plain at N = 4 and 1280.
   [encdec] Whisper-tiny, block-sparse FFN: ``forward`` over 1500 frames
   and 448 text tokens (24 launches: the encoder's 4 down projections on
   the split path, whose B rows of 1500 bf16 TMA cannot read, the other
   20 on tc), decode logits with the
   encoder's output, ``Engine`` raising ``NotImplementedError`` as
   ``repro``'s does, a training step's loss and gradients cuda vs
   reference, then 3 ``Trainer`` steps at 8 x 448 tokens (72 SpMM
   launches a step with remat, 24 transposed, all tc), the kernel vs
   plain at the encoder's 12000 training rows, forward and dx.
13. The sharded runtime ([dist]): one process in an NCCL group of
   world size 1 (``init_process_group`` on a free local port, destroyed at
   the end of the phase); granite-3-8b at full width with its depth cut 40
   -> ``DIST_LAYERS`` layers (sparse FFN, remat) on 8 x 256 tokens with
   accum 2.  ``Trainer(mesh=make_mesh((1, 1), ("data", "model")))`` against
   the plain ``Trainer`` from the same init for ``DIST_STEPS`` steps:
   losses within ``LOSS_RTOL``, the largest parameter difference printed,
   SpMM launches per path equal (all tc, a third transposed), ms/step and
   peak memory of both, every master shard the parameter itself.  The
   plain trainer's state after step 2 written in ``repro``'s checkpoint
   layout (``write_repro_checkpoint``: ``jax_state_layout``'s order,
   ``leaf_%05d``, the manifest) and restored onto the mesh through
   ``restore_onto_mesh(JaxCheckpoint(...))``: the sharded trainer's step 3
   loss against the uninterrupted run's within ``LOSS_RTOL``.
   ``make_compressed_dp_step`` (int8, topk) against plain steps on the
   compression's formula, ``pipeline_forward`` with one stage against the
   same two layers in sequence.  At world size 1 the trainer skips every
   collective (each mesh dim has one rank), so the NCCL calls the sharded
   runtime makes (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
   ``all_reduce``, ``DTensor.full_tensor``) are made directly on the
   trainer's tensors, bf16 and fp32, along a non-leading dim of a
   non-contiguous view: each result equals its input bit for bit.  Last,
   the SpMM kernel vs plain at the trainer's N = 1024, forward and dx.
13b. Tensor parallel ([tp], after [dist]): two processes of this script
   (``--phase tp``) on the one card, a gloo group (gloo stages CUDA tensors
   through the host; NCCL refuses two ranks on one device) and a (1, 2)
   ``(data, model)`` mesh.  RecurrentGemma-9B at published width cut to
   ``TP_LAYERS`` = 3 layers (one ``(rec, rec, local)`` unit, the
   block-sparse FFN, remat) on 1 x 4096 tokens: rank 0 first runs it at
   world size 1 (one gradient step, then ``TP_STEPS`` ``Trainer``
   steps), then both ranks run it split (``build_model(cfg, mesh=)``):
   the loss and gradient norm of every step (``LOSS_RTOL``,
   ``GNORM_RTOL``) and every parameter's gradient, its slices gathered
   (``GRAD_RTOL``, norm-relative), against world size 1; each rank's
   exact launches per path (``rg_lru`` and ``rg_lru_bwd`` on ``tile``
   over 2048 channels, ``flash_attention`` and its backward on ``tc``
   with 8 query heads on one KV head, the replicated sparse FFN's SpMM
   on the tensor cores) equal to world size 1's; each split parameter
   half of its full tensor; each kernel against its plain version on
   random inputs at the local shapes; peak memory per rank.  Step times
   are printed as information only.
13c. Expert parallelism and ZeRO-3 ([zero3], after [tp]): four processes
   of this script (``--phase zero3``, builds one rank at a time, each
   process's allocator on ``expandable_segments``) on a (2, 2)
   ``(data, model)`` gloo mesh.  Phi-3.5-MoE at published widths cut to
   ``ZERO3_LAYERS`` = 1 layer, fp32, remat, 2 x 1024 tokens (one row a
   dp rank): rank 0 first runs it at world size 1, then all four run it
   with the experts split over ``model`` and every parameter held as its
   rule shard, gathered a unit at a time: the loss and norm of
   ``ZERO3_STEPS`` ``Trainer`` steps and every gradient (reduced into its
   shard, then gathered full) against world size 1 under [tp]'s gates;
   each rank's experts (8 of 16) and only the routers whole; its
   parameter bytes between steps equal to the sum of its rule shards;
   its allocator peak, printed beside every unit held at once; its
   all-gathers and reduce-scatters in the steps equal to the units'
   count; no kernel launch in the step (einsum experts, chunked
   attention); ``flash_attention`` (``tc``) and its backward at a rank's
   heads (16 query heads on 4 KV heads, D = 128) against their plain
   versions.  Step times are information only.
13d. Sequence parallelism ([seq], after [zero3]): three processes of this
   script (``--phase seq``) on a (1, 3) ``(data, model)`` gloo mesh.
   Qwen1.5-4B at published widths cut to ``SEQ_LAYERS`` = 2 layers, the
   block-sparse FFN, fp32, remat: its 20 heads do not split over 3 ranks,
   so its attention runs whole on every rank.  Rank 0 first runs it at
   world size 1, then all three run it split: ``SEQ_STEPS`` ``Trainer``
   steps on 1 x ``SEQ_T`` = 1536 tokens with ``seq_shard`` (each block's
   input holds 512 rows a rank, checked by a hook) under [tp]'s gates
   and every gradient; a chunked prefill (``SEQ_CHUNKS``, the second
   across a shard edge) and ``SEQ_DECODE`` greedy steps over the KV cache
   split on time (256 of ``SEQ_MAX_LEN`` = 768 positions a rank, its
   bytes exactly a third of world size 1's): the same tokens on every
   rank, logits within ``LOGIT_RTOL``; each rank's exact ``segment_spmm``
   launches (all ``simt``: fp32 B) equal to world size 1's; the kernel
   against its plain version at a rank's 512 rows (forward and
   ``transpose_lhs``) and at the decode's 2 rows; peak memory per rank.
13e. Head-parallel RWKV-6 ([rwkv_tp], after [seq]): four processes of
   this script (``--phase rwkv_tp``) on a (1, 4) ``(data, model)`` gloo
   mesh.  RWKV-6 1.6B at published widths cut to ``RWKV_TP_LAYERS`` = 2
   layers, fp32: each rank runs 8 of the 32 heads of the time mix, 1792
   of the 7168 hidden units of the channel mix and its 8 heads of the
   wkv state.  Rank 0 first runs it at world size 1, then all four run
   it split: ``RWKV_TP_STEPS`` ``Trainer`` steps on 1 x ``RWKV_TP_T`` =
   256 tokens, loss, norm and every gradient (gathered) within the
   fp32 gate ``RWKV_TP_RTOL``; one ``seq_shard`` step (64 rows a rank
   at every block, checked by a hook) against world size 1's first; a
   64-token prefill and 16 greedy steps: the same tokens on every rank,
   logits within ``RWKV_TP_RTOL``; a rank's S bytes and its split
   projections' parameters exactly a quarter of world size 1's; no
   kernel launch (the wkv recurrence is a
   torch loop in both packages, so no kernel is held against a plain
   version here); times and peak memory per rank as information.
13f. The KV cache split over the ranks that share its KV heads
   ([kv_group], after [rwkv_tp]): four processes of this script
   (``--phase kv_group``) on a (1, 4) gloo mesh.  RecurrentGemma-9B at
   published widths cut to ``KV_GROUP_LAYERS`` = 3 layers (rec, rec,
   local), fp32: each rank runs 4 of the 16 query heads of the one KV
   head, which all four share, so the local layer's ring of 2048 slots
   splits 512 a rank, and 1024 of the 4096 RG-LRU channels.  Rank 0
   first decodes at world size 1, then all four split: a prefill of 2 x
   2048 tokens in two chunks, 24 greedy steps past the ring's end and
   two calls at per-row positions (one row across ranks 0 and 1); the
   same tokens on every rank, logits within ``LOGIT_RTOL``; a rank's
   ring bytes exactly a quarter of world size 1's; each rank's exact
   launches (``rg_lru`` ``tile`` a prefill chunk and layer, ``simt``
   a decode call and layer) equal to world size 1's; ``rg_lru`` against
   its plain version at a rank's 1024 channels; times and peak memory
   per rank as information.
   Before each phase that starts ranks ([tp], [zero3], [seq],
   [rwkv_tp], [kv_group]), the parent drops its plan cache and prints
   the card's free memory and what it still holds (``free_parent``).
14. The dry run ([dryrun], after [kv_group]): first the fake rules of
   ``moe_gemm`` and ``segment_spgemm`` against one real launch each on
   every path (the same outputs and scratch, shape and dtype, and the
   bytes the launch's results hold in the allocator).  Then
   ``repro_torch.launch.dryrun.run_cell`` traces ``DRYRUN_CELLS`` on fake
   CUDA tensors in a fake process group of 256 ranks (``pod_16x16``),
   the model split tensor parallel over the 16 ``model`` ranks, its
   parameters held as shards and gathered a unit at a time:
   granite-3-8b's train_4k and decode_32k and RecurrentGemma-9B's
   train_4k (the cell whose fake rules are the
   attention's and the RG-LRU's, forward and backward).  Each cell's
   per-rank bytes by MemTracker category, FLOPs, bytes, collective bytes
   by opcode, roofline terms, fit against the card's memory and
   ``useful_flops_ratio`` printed; each must complete with
   ``tensor_parallel`` true, granite's decode_32k must fit with its KV
   cache split on time over the two ranks of each KV head and a rank's
   KV bytes equal to ``repro``'s ``cache_pspec`` share in closed form,
   the training cells' ``useful_flops_ratio`` at least
   ``DRYRUN_USEFUL_MIN``, the parameters at least
   ``DRYRUN_PARAM_CUT`` times under the gathered layout's, and its
   ``Parameter`` and ``Optstate`` bytes equal to the closed form of the
   rules' shard sizes (each rank's masters are its rule shards, plus the
   one unit gathered at the peak, its split parameters at 1/16; the AdamW
   moments are its shards; each storage rounded to the allocator's 512
   bytes).  Qwen1.5-4B's decode_32k (its attention whole on every rank)
   must fit the card with its KV cache split on time, and
   ``EXPECTED_OVER_HBM`` must be empty.  Then the dry run's predictions
   against two steps that
   really run on the card (``DRYRUN_REAL``): [dist]'s granite-3-8b at 8
   layers (sparse FFN, 8 x 256 tokens, accum 2, one rank: SpMM on ``tc``)
   and [hybrid_train]'s RecurrentGemma-9B at 6 layers (1 x 4096 tokens:
   ``flash_attention``, ``rg_lru`` and both backward kernels).  The
   predicted peak must lie within ``DRYRUN_PEAK_RTOL`` of
   ``torch.cuda.max_memory_allocated()`` over the same step (after
   ``reset_peak_memory_stats()``, above what was allocated before the
   model), the trace's FLOPs must equal a ``CostCounter`` run over the real
   step exactly, and the measured step time must be at least the roofline
   bound (the ratio printed).

The script runs itself under ``PYTHONHASHSEED=0`` (it re-executes when
started under another), so the suite's matrices are the same in every run.
Prints a JSON line of kernel numbers and, last, ``{"ok": true, ...}``.
``--only kernel,edges`` (any of ``PHASES``) runs those phases alone, after
the build, and prints neither line; ``--only ops`` (or ``spgemm,ops``,
``hybrid``, ``hybrid_train``, or any of ``ssm,moe,vlm,encdec,dist,tp,
zero3,seq,dryrun,rwkv_tp,kv_group``) builds no 40-layer granite model.
Exits non-zero without that line when there is no CUDA device, when the
package is not beside this script, or when any check fails.
"""
import atexit
import contextlib
import dataclasses
import gc
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # fp32 outside the tensor cores, same source
# bf16 tensor-core peak, dense (same source): the bound of a product whose
# operands are both bf16, since bf16 x bf16 products are exact in fp32
BF16_FLOPS = 989e12
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
# int8 and fp8 tensor-core peaks (same data sheet): the bound of a kernel
# whose inputs are int8/fp8 payloads
QUANT_OPS = 1979e12
# SpGEMM on granite-3-8b's FFN projections (ffn_block=64, ffn_density=0.25):
# C = A @ B with A drawn from seed SEED and B from SEED + 1.  down_up has
# 4,096 long C segments, up_down 39,322 short ones; up_down plans with
# gustavson because the segment policy's run chaining is quadratic in the
# number of C blocks on the host.
SPGEMM_CASES = {
    "spgemm_down_up": ((4096, 12800), (12800, 4096), "segment"),
    "spgemm_up_down": ((12800, 4096), (4096, 12800), "gustavson"),
}
SPGEMM_QUANT_CASE = "spgemm_up_down"
# quantized SpGEMM vs the fp32 SpGEMM of the same operands, max error over
# the fp32 result's max magnitude: the gates of benchmarks/kernel_bench.py
QUANT_GATE = {"int8": 5e-2, "fp8": 1e-1}
# greedy-token drift of a quantized engine against the fp32 engine: the
# bounds of repro's tests/test_serving.py::test_quantized_greedy_drift_bounded
DRIFT_BOUND = {"int8": 0.25, "fp8": 0.5}
QSERVE_MODES = ("int8", "fp8")
QGRAD_SEQ = 64                        # [qgrad]: 1 x 64 tokens, so dx's N = 64
# [ops]: the kernels reached through repro_torch.kernels.ops, at the
# published widths of the configs that give each its shapes.  Attention
# cases: (config, batch, Tq, Tk, window: None or the config's local window)
# cases: (config, batch, Tq, Tk, window: None or the config's local window,
# the flash_attention path choose_path must give it)
OPS_ATTN_CASES = {
    "granite prefill": ("granite-3-8b", 1, 4096, 4096, None, "tc"),
    "granite decode": ("granite-3-8b", 4, 1, 4096, None, "splitkv"),
    "recurrentgemma local": ("recurrentgemma-9b", 1, 8192, 8192, "local",
                             "tc"),
}
# the cases also run with bf16 q, k and v (beside a bf16 SDPA), and the
# ones run once more under set_sync_debug_mode("error")
OPS_ATTN_BF16 = ("granite prefill", "granite decode")
OPS_ATTN_SYNC_FREE = ("granite prefill", "granite decode")
# [attn-crossover]: granite-3-8b's heads, fp32, every path that can take
# the call, causal: (label, batch, Tq, Tk): decode over 512 .. 32768 keys,
# a wider decode batch, a 64-token prefill chunk over a 4096-key context,
# and prefill over T = 256 .. 8192
ATTN_CROSSOVER = [("decode", 4, 1, n) for n in (512, 2048, 8192, 32768)] \
    + [("decode", 16, 1, 4096), ("chunk", 1, 64, 4096)] \
    + [("prefill", 1, n, n) for n in (256, 1024, 4096, 8192)]
OPS_MOE_TOKENS = (4096, 4)           # Llama-4 Maverick experts, top-1
# RG-LRU cases at RecurrentGemma-9B's d_model 4096: (batch, T, dtype, the
# rg_lru path choose_path must give it); the prefill of one request at the
# local-block case's length has the bytes of the 4 x 2048 case
OPS_RG_LRU_CASES = {
    "rg_lru fp32": (4, 2048, torch.float32, "tile"),
    "rg_lru bf16": (4, 2048, torch.bfloat16, "tile"),
    "rg_lru prefill 1x8192": (1, 8192, torch.float32, "tile"),
    "rg_lru decode": (4, 1, torch.float32, "simt"),
}
# [hybrid]: RecurrentGemma-9B at full width, served and scored.  The rg_lru
# calls its model makes (bf16 operands at D = 4096): a 4-slot decode step on
# "simt" and the 1 x HYBRID_FORWARD_T forward on "tile"; flash_attention at
# its local blocks' forward call; the forward over twice the window, so the
# window mask bites, and the forward-vs-stepwise cache check over
# HYBRID_CACHE_T tokens
HYBRID_FORWARD_T = 4096
HYBRID_CACHE_T = 64
HYBRID_RG_LRU_CASES = {
    "rg_lru decode": (4, 1, torch.bfloat16, "simt"),
    "rg_lru forward": (1, HYBRID_FORWARD_T, torch.bfloat16, "tile"),
}
# [rg_lru-crossover]: every rg_lru path at these (batch, T), fp32, D = 4096
RG_LRU_CROSSOVER = [(4, t) for t in (1, 16, 64, 256, 2048)] + [(1, 8192)]
# the SFU's rate (H100 SXM: 16 operations a clock an SM, 132 SMs, the
# 1.98 GHz boost clock of the fp32 peak above)
SFU_OPS = 132 * 16 * 1.98e9
# bf16 outputs against fp32 oracles: one bf16 rounding (2**-8 relative)
# of each output, or of the MoE's activation between its two GEMMs
BF16_RTOL = 1e-2
# a ragged N on the SpMM's tensor-core path (not a multiple of its
# 256-column tile, nor of 128)
RAGGED_N = 200
# the edge sweep's N for the new paths: ragged for the tensor-core
# kernel's 256- and 128-column tiles (one and two consumer warpgroups) and
# multiples of 8, so an N-contiguous bf16 B suits TMA
EDGE_N = 136
EDGE_N_NARROW = 40


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


# the checked build ([check]), started during [build]
CHECKED_BUILD = None


def phase_card(checked=False):
    """Card, versions, and the release build; with ``checked`` the checked
    build starts once the release build's runs hold at most half the
    cores, at a lower priority, and overlaps the phases before [check],
    which waits for it."""
    global CHECKED_BUILD
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
    job = build.start_build()
    if checked:
        # once the release build holds at most half the cores (its short
        # libraries done, ~35 s), the checked one takes the rest
        while job.running() > (os.cpu_count() or 8) // 2:
            time.sleep(0.2)
        CHECKED_BUILD = build.start_build(release=False, checked=True,
                                          nice=CHECKED_BUILD_NICE)
        atexit.register(CHECKED_BUILD.stop)   # a failed phase leaves none
    libs = job.wait()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s; per library "
          + " ".join(f"{Path(k).stem} {v:.0f}" for k, v in
                     sorted(job.seconds.items(), key=lambda kv: -kv[1])))
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


def _bsr_tensor(plan, transpose=False, values=None):
    """The library's BSR tensor of W (or of Wᵀ) from a forward plan, with
    the plan's blocks or the fp32 ``values`` given."""
    gm, gk = plan.grid
    bm, bk = plan.block_shape
    rows, cols = plan.a_brow.long(), plan.a_bcol.long()
    vals = plan.lhs_blocks if values is None else values
    shape = (gm * bm, gk * bk)
    if transpose:
        order = torch.argsort(cols * gm + rows)
        rows, cols = cols[order], rows[order]
        vals = vals[order].transpose(1, 2).contiguous()
        gm, shape = gk, shape[::-1]
    crow = torch.zeros(gm + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.bincount(rows, minlength=gm).cumsum(0)
    return torch.sparse_bsr_tensor(crow, cols, vals, size=shape)


def _path_counts():
    """The SpMM wrapper's counts: all launches, tensor-core, split."""
    from repro_torch.kernels.segment_spmm import segment_spmm
    return (segment_spmm.launches, segment_spmm.tensor_core_launches,
            segment_spmm.split_launches)


def _check_path(label, before, path, launches=1):
    """The calls since ``before`` (from :func:`_path_counts`) launched
    ``launches`` kernels, all on ``path``."""
    got = [a - b for a, b in zip(_path_counts(), before)]
    want = [launches, launches * (path == "tc"), launches * (path == "split")]
    check(got == want, f"{label}: launches (all, tensor-core, split) {got} "
                       f"!= {want} for path {path!r}")


def spmm_bounds(sched, plan, b, out_bytes=4, a_bytes=None, parts=3):
    """The least time (ms) one SpMM call could take, and what binds it,
    per path: every stored tile (``a_bytes``, default the plan's blocks),
    B and C moved once; 2 bm bk N operations per valid item, at the fp32
    CUDA-core peak (``"fp32"``) and, for the tensor-core path, ``parts``
    bf16 passes at the bf16 tensor-core peak (``"tc"``)."""
    bm, bk = plan.block_shape
    k, n = b.shape
    m = sched.grid_m * sched.block_shape[0]
    if a_bytes is None:
        a_bytes = plan.lhs_blocks.numel() * plan.lhs_blocks.element_size()
    nbytes = a_bytes + k * n * b.element_size() + m * n * out_bytes
    ops = 2 * int(sched.valid.sum()) * bm * bk * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {}
    for key, t_ops in (("fp32", ops / FP32_FLOPS),
                       ("tc", parts * ops / BF16_FLOPS)):
        out[key] = (max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_case(label, plan, b, transpose=False, library=None, path=None,
                tag="kernel"):
    """Kernel vs plain version on one forward plan and one B; with
    ``transpose`` the kernel runs the plan's grad plan in ``transpose_lhs``
    mode against the forward blocks (dx = Wᵀ @ B).  ``path`` forces one of
    the wrapper's paths (default: the one ``choose_path`` picks); the call
    must launch exactly once, on that path.  ``library`` is the library's
    BSR tensor to time beside it, or False for none.  Returns a record."""
    from repro_torch.kernels.segment_spmm import (choose_path, segment_spmm,
                                                  segment_spmm_plain)
    sched = plan.grad_plan if transpose else plan
    bm, bk = plan.block_shape
    k, n = b.shape
    picked = choose_path(n, b.dtype, bm, bk, b.stride(), b.data_ptr())
    path = path or picked

    def kern():
        return segment_spmm(
            plan.lhs_blocks, sched.slot_idx, sched.m_idx, sched.k_idx,
            sched.seg_start, sched.seg_write, sched.accum_prev, sched.valid,
            b, grid_m=sched.grid_m, n_lanes=sched.n_lanes,
            unroll=sched.unroll, transpose_lhs=transpose,
            runs=sched.run_offsets, chunks=sched.chunk_offsets, path=path)

    def plain():
        return segment_spmm_plain(plan.lhs_blocks, sched.slot_idx,
                                  sched.m_idx, sched.k_idx, sched.valid, b,
                                  grid_m=sched.grid_m,
                                  transpose_lhs=transpose)

    live = torch.repeat_interleave(sched.row_mask > 0, sched.block_shape[0])
    before = _path_counts()
    got = kern()
    _check_path(label, before, path)
    got, want = got[live], plain()[live]
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(rel_err <= KERNEL_RTOL, f"{label} ({path}): kernel vs plain "
                                  f"{rel_err:.3g} > {KERNEL_RTOL}")
    bounds = spmm_bounds(sched, plan, b)
    # wide cases run for milliseconds: fewer captured calls suffice
    reps = 20 if n <= 64 else 4
    rec = dict(case=label, mode="transpose_lhs" if transpose else "forward",
               path=path, picked=picked, n=n,
               b_dtype=str(b.dtype).removeprefix("torch."),
               rel_err=rel_err, max_abs_err=abs_err,
               ms=device_ms(kern, reps), plain_ms=device_ms(plain, reps),
               bound_ms=bounds["tc" if path == "tc" else "fp32"][0],
               bound_by=bounds["tc" if path == "tc" else "fp32"][1],
               fp32_bound_ms=bounds["fp32"][0], tc_bound_ms=bounds["tc"][0],
               library_ms=None)
    # the library's BSR x dense product, timed on fp32 B; the lane count
    # changes only the schedule, so every case has the same library call
    if library is not False:
        a_bsr = (library if library is not None
                 else _bsr_tensor(plan, transpose))
        b32 = b.float()
        rec["library_ms"] = device_ms(lambda: a_bsr @ b32, reps)
    lib = (f" library_ms={rec['library_ms']:.4f}"
           if rec["library_ms"] is not None else "")
    print(f"[{tag}] {label:<28} n={n:<4} B={rec['b_dtype']:<8} "
          f"path={path:<5} rel_err={rel_err:.2e} kernel_ms={rec['ms']:.4f} "
          f"plain_ms={rec['plain_ms']:.4f} bound_us={rec['bound_ms'] * 1e3:.2f}"
          f" ({rec['bound_by']}; fp32 {rec['fp32_bound_ms'] * 1e3:.2f}, "
          f"3xbf16 tc {rec['tc_bound_ms'] * 1e3:.2f}){lib}")
    return rec


def phase_kernels(model, dev):
    """The Segment SpMM kernel on layer 0's up and down plans at the main
    paths' widths and layouts, each on the path the wrapper picks, plus a
    ragged N of 200 on the tensor-core path (forward, both B layouts, and
    dx), three schedules of other shapes, and a forward and dx call under
    ``set_sync_debug_mode("error")``.  Returns the records and the plans."""
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
                       (RAGGED_N, (torch.bfloat16,)),
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
        for n in (4, 64, RAGGED_N, 2048):
            # the backward pass hands dx's kernel dy as a bf16 transposed
            # view (the gradient of the layer's y.T)
            dy = torch.randn(n, m, generator=gen, device=dev).bfloat16()
            recs.append(kernel_case(f"{proj} dx (transpose_lhs)", plan, dy.T,
                                    transpose=True, library=lib))
    ragged = [r for r in recs if r["n"] == RAGGED_N]
    check(all(r["path"] == "tc" for r in ragged),
          f"ragged N = {RAGGED_N} cases off the tensor-core path: "
          f"{[(r['case'], r['path']) for r in ragged]}")
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
    sync_free_calls(plans["up"], gen, dev)
    return recs, plans


def sync_free_calls(plan, gen, dev):
    """A forward and a dx call through the plan and its grad plan, at the
    decode width (split path) and the training width (tensor-core path),
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises."""
    k = plan.grid_k * plan.block_shape[1]
    m = plan.grid_m * plan.block_shape[0]
    grad = plan.grad_plan.with_values(plan.lhs_blocks)
    ins = {n: (torch.randn(n, k, generator=gen, device=dev).bfloat16(),
               torch.randn(n, m, generator=gen, device=dev).bfloat16())
           for n in (4, 2048)}
    torch.cuda.synchronize()
    before = _path_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [(plan(x.T), grad(dy.T)) for x, dy in ins.values()]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(_path_counts(), before)]
    check(got == [4, 2, 2], f"sync-free calls: launches (all, tensor-core, "
                            f"split) {got} != [4, 2, 2]")
    check(all(bool(torch.isfinite(t).all()) for pair in outs for t in pair),
          "sync-free calls: non-finite output")
    print("[kernel] forward and dx at N = 4 (split) and 2048 (tensor cores) "
          "under set_sync_debug_mode('error'): no host sync")


def phase_crossover(plans, dev):
    """Both new paths on the same calls (up and down forward, up dx; bf16
    B in the main path's layouts) at N = 4, 16, 32, 64, 2048 and a ragged
    ``RAGGED_N``, each held against the plain version: where the
    tensor-core path starts to win, which sets ``TC_MIN_N``.  Returns the
    records."""
    # the module (the package exports its function under the same name)
    spmm = importlib.import_module("repro_torch.kernels.segment_spmm")

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    recs = []
    for label, proj, transpose in (("up", "up", False),
                                   ("down", "down", False),
                                   ("up dx (transpose_lhs)", "up", True)):
        plan = plans[proj]
        k = (plan.grid_m * plan.block_shape[0] if transpose
             else plan.grid_k * plan.block_shape[1])
        for n in (4, 16, 32, 64, RAGGED_N, 2048):
            x = torch.randn(n, k, generator=gen, device=dev).bfloat16()
            b = x.T.contiguous() if proj == "down" and not transpose else x.T
            # an N-contiguous B needs N % 8 == 0 for TMA: N = 4 has no
            # tensor-core run in the down projection's layout
            able = spmm.paths_for(b.dtype, *plan.block_shape, b.stride(),
                                  b.data_ptr())
            pair = {p: kernel_case(label, plan, b, transpose=transpose,
                                   library=False, path=p, tag="crossover")
                    for p in ("split", "tc") if p in able}
            fast = min(pair, key=lambda p: pair[p]["ms"])
            print(f"[crossover] {label:<22} n={n:<4} "
                  + ", ".join(f"{p} {r['ms']:.4f} ms"
                              for p, r in pair.items())
                  + f": {fast} is faster; the wrapper picks "
                  f"{pair['split']['picked']} (TC_MIN_N = {spmm.TC_MIN_N})")
            recs.extend(pair.values())
    return recs


def qkernel_case(label, plan, src_blocks, b, transpose, library,
                 path=None):
    """One quantized kernel call against its plain version, against the
    fp32 kernel on the dequantized blocks and against the fp32 kernel on
    the source blocks ``src_blocks`` (the quantization gate); with
    ``transpose`` the plan's grad plan in the ``transpose_lhs`` mode.
    ``path`` forces one of the wrapper's paths (default: the one it
    picks), for the quantized call and the two fp32 calls alike.  Returns
    a record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (choose_path, segment_spmm,
                                                  segment_spmm_plain)
    sched = plan.grad_plan if transpose else plan
    bm, bk = plan.block_shape
    k, n = b.shape
    path = path or choose_path(n, b.dtype, bm, bk, b.stride(), b.data_ptr())
    args = (sched.slot_idx, sched.m_idx, sched.k_idx, sched.seg_start,
            sched.seg_write, sched.accum_prev, sched.valid, b)
    kw = dict(grid_m=sched.grid_m, n_lanes=sched.n_lanes,
              unroll=sched.unroll, transpose_lhs=transpose,
              runs=sched.run_offsets, chunks=sched.chunk_offsets, path=path)
    deq = ref.dequant_blocks_ref(plan.lhs_blocks, plan.lhs_scales)

    def kern():
        return segment_spmm(plan.lhs_blocks, *args, a_scales=plan.lhs_scales,
                            **kw)

    def plain():
        return segment_spmm_plain(plan.lhs_blocks, sched.slot_idx,
                                  sched.m_idx, sched.k_idx, sched.valid, b,
                                  grid_m=sched.grid_m, transpose_lhs=transpose,
                                  a_scales=plan.lhs_scales)

    live = torch.repeat_interleave(sched.row_mask > 0, sched.block_shape[0])
    before = _path_counts()
    got = kern()[live]
    rel_plain, abs_plain = _rel(got, plain()[live])
    rel_deq, _ = _rel(got, segment_spmm(deq, *args, **kw)[live])
    quant_err, _ = _rel(got, segment_spmm(src_blocks, *args, **kw)[live])
    torch.cuda.synchronize()
    _check_path(f"{label} quantized", before, path, launches=3)
    mode = plan.block_dtype
    gate = QUANT_GATE[mode.split(".")[0]]
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(rel_plain <= KERNEL_RTOL and rel_deq <= KERNEL_RTOL,
          f"{label} {mode} ({path}): vs plain {rel_plain:.3g}, vs the fp32 "
          f"kernel on the dequantized blocks {rel_deq:.3g} > {KERNEL_RTOL}")
    check(quant_err < gate, f"{label} {mode}: vs fp32 {quant_err:.3g} >= "
                            f"{gate}")
    # bound of the path that ran: payload, scales, B and C each moved once;
    # the operations at the fp32 CUDA-core peak (split path) or as bf16
    # passes at the bf16 tensor-core peak (one for a per-block payload,
    # three for a rowwise one); and, as a yardstick, at the payload type's
    # tensor-core peak
    nbytes = (plan.lhs_blocks.numel() * plan.lhs_blocks.element_size()
              + plan.lhs_scales.numel() * 4 + k * n * b.element_size()
              + sched.grid_m * sched.block_shape[0] * n * 4)
    ops = 2 * int(sched.valid.sum()) * bm * bk * n
    parts = 3 if plan.lhs_scales.ndim == 2 else 1
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = parts * ops / BF16_FLOPS if path == "tc" else ops / FP32_FLOPS
    reps = 20 if n <= 64 else 4
    b32 = b.float()
    rec = dict(case=label, mode="transpose_lhs" if transpose else "forward",
               quant=mode, path=path, n=n, rel_err=rel_plain,
               max_abs_err=abs_plain, rel_err_deq=rel_deq,
               quant_err=quant_err, ms=device_ms(kern, reps),
               plain_ms=device_ms(plain, reps),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes_ms=t_bytes * 1e3, fp32_ops_ms=ops / FP32_FLOPS * 1e3,
               tc_ops_ms=parts * ops / BF16_FLOPS * 1e3,
               quant_ops_ms=ops / QUANT_OPS * 1e3,
               library_ms=device_ms(lambda: library @ b32, reps))
    print(f"[qkernel] {label:<22} {mode:<12} n={n:<4} path={path:<5} rel_err "
          f"plain={rel_plain:.2e} deq={rel_deq:.2e} vs_fp32={quant_err:.2e} "
          f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
          f"bound_us={rec['bound_ms'] * 1e3:.2f} ({rec['bound_by']}; bytes "
          f"{rec['bytes_ms'] * 1e3:.2f}, fp32 ops "
          f"{rec['fp32_ops_ms'] * 1e3:.2f}, {parts} x bf16 tc ops "
          f"{rec['tc_ops_ms'] * 1e3:.2f}, payload-type tc ops "
          f"{rec['quant_ops_ms'] * 1e3:.2f}) library_ms="
          f"{rec['library_ms']:.4f} (fp32 BSR @ of the dequantized blocks)")
    return rec


def phase_qkernel(model, dev):
    """The quantized modes on layer 0's up and down projections, frozen by
    ``SparseLinear.quantize`` as the quantized model freezes them, each on
    the path the wrapper picks, and on the up projection also on the other
    new path (forward at N = 16 and ``RAGGED_N``, dx at N = 64: the split
    path where the wrapper picks the tensor cores, and the other way)."""
    from repro_torch.core.formats import QUANT_MODES
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    mlp = model.layers[0].mlp
    recs = []
    for mode in QUANT_MODES:
        for proj in ("up", "down"):
            layer = getattr(mlp, proj)
            plan = layer.quantize(mode).plan
            src = layer.blocks.detach()
            deq = ref.dequant_blocks_ref(plan.lhs_blocks, plan.lhs_scales)
            k = plan.grid_k * plan.block_shape[1]
            m = plan.grid_m * plan.block_shape[0]
            lib = _bsr_tensor(plan, values=deq)
            for n in (4, 16, 64, RAGGED_N):
                x = torch.randn(n, k, generator=gen, device=dev).bfloat16()
                # the serve path's layouts, as in phase_kernels
                b = x.T if proj == "up" else x.T.contiguous()
                recs.append(qkernel_case(proj, plan, src, b, False, lib))
                if proj == "up" and n in (16, RAGGED_N):
                    other = "split" if recs[-1]["path"] == "tc" else "tc"
                    recs.append(qkernel_case(proj, plan, src, b, False, lib,
                                             path=other))
            lib = _bsr_tensor(plan, transpose=True, values=deq)
            for n in (4, 64):
                dy = torch.randn(n, m, generator=gen, device=dev).bfloat16()
                recs.append(qkernel_case(f"{proj} dx (transpose_lhs)", plan,
                                         src, dy.T, True, lib))
                if proj == "up" and n == 64:
                    other = "split" if recs[-1]["path"] == "tc" else "tc"
                    recs.append(qkernel_case(f"{proj} dx (transpose_lhs)",
                                             plan, src, dy.T, True, lib,
                                             path=other))
            del plan, deq, lib
    paths = {(r["quant"], r["mode"], r["path"]) for r in recs}
    for mode in QUANT_MODES:
        for direction in ("forward", "transpose_lhs"):
            for path in ("split", "tc"):
                check((mode, direction, path) in paths,
                      f"[qkernel] {mode} {direction} never ran on {path}")
    return recs


def phase_edges(dev):
    """Small plans at the edges of what the kernels take: 32 and 64 blocks,
    folded, multi-lane, unrolled, static-order and holed schedules, N of 1,
    5 and 100 (ragged tiles), B as a bf16 transposed view or contiguous
    fp32; each through ``execute_plan`` (on the path the wrapper picks)
    against the plain version and the dense oracle, in the forward mode and
    in the ``transpose_lhs`` mode on the plan's grad plan.  Then, on 64
    blocks, every schedule through each new path (split and tensor cores)
    in both modes, with fp32 and bf16 output and B k-contiguous or
    N-contiguous, at two ragged N (``EDGE_N_NARROW`` and ``EDGE_N``: one
    and two consumer warpgroups on the tensor cores).  Also the
    bf16-output folded reload on each path, and ``prefetch="cross_pass"``
    plans (fp32, int8, fp8; forward and dx) against the drained plans, bit
    for bit, on each path.
    Returns the one-block-per-run ("simt") kernel's launches (the main
    paths do not run it)."""
    from repro_torch import api
    from repro_torch.core.formats import BSR
    from repro_torch.kernels.segment_spmm import (segment_spmm,
                                                  segment_spmm_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst, count = {False: 0.0, True: 0.0}, {False: 0, True: 0}
    simt_launches = 0
    on_path = {"tc": 0, "split": 0, "simt": 0}
    cross = []

    def held(label, got, plain, want, tol=KERNEL_RTOL):
        scale = float(want.float().abs().max())
        err = max(float((got.float() - plain.float()).abs().max()),
                  float((got.float() - want.float()).abs().max())) / scale
        check(err <= tol, f"edge {label}: {err:.3g} > {tol}")
        return err

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
            for n in (1, 5, 100, EDGE_N_NARROW, EDGE_N):
                fwd = api.plan_matmul(mat, n, device=dev, with_grad=True,
                                      **kw)
                for transpose in (False, True):
                    plan = (fwd.grad_plan.with_values(fwd.lhs_blocks)
                            if transpose else fwd)
                    k = mat.shape[0] if transpose else mat.shape[1]

                    def plain_of(b, plan=plan, transpose=transpose):
                        return segment_spmm_plain(
                            plan.lhs_blocks, plan.slot_idx, plan.m_idx,
                            plan.k_idx, plan.valid, b, grid_m=plan.grid_m,
                            transpose_lhs=transpose)

                    if n not in (EDGE_N_NARROW, EDGE_N):
                        # the path the wrapper picks
                        for dt, transposed in ((torch.bfloat16, True),
                                               (torch.float32, False)):
                            x = torch.randn((n, k) if transposed else (k, n),
                                            generator=gen, device=dev).to(dt)
                            b = x.T if transposed else x
                            before = _path_counts()
                            got = plan(b)
                            d = [u - v for u, v in zip(_path_counts(),
                                                       before)]
                            path = ("tc" if d[1] else "split" if d[2]
                                    else "simt")
                            on_path[path] += 1
                            err = held(f"block={block} {kw} n={n} {dt} "
                                       f"transpose_lhs={transpose} ({path})",
                                       got, plain_of(b),
                                       plan(b, backend="reference"))
                            worst[transpose] = max(worst[transpose], err)
                            count[transpose] += 1
                            simt_launches += path == "simt"
                        continue
                    if block != 64:
                        continue
                    # each new path, forced, on both B layouts and out dtypes
                    for layout in ("k", "n"):
                        x = torch.randn((n, k) if layout == "k" else (k, n),
                                        generator=gen,
                                        device=dev).bfloat16()
                        b = x.T if layout == "k" else x
                        want = plan(b, backend="reference")
                        plain = plain_of(b)
                        for path in ("split", "tc"):
                            for out in (torch.float32, torch.bfloat16):
                                before = _path_counts()
                                got = segment_spmm(
                                    plan.lhs_blocks, plan.slot_idx,
                                    plan.m_idx, plan.k_idx, plan.seg_start,
                                    plan.seg_write, plan.accum_prev,
                                    plan.valid, b, grid_m=plan.grid_m,
                                    n_lanes=plan.n_lanes, unroll=plan.unroll,
                                    transpose_lhs=transpose, out_dtype=out,
                                    runs=plan.run_offsets,
                                    chunks=plan.chunk_offsets, path=path)
                                _check_path(f"edge {kw} {path}", before, path)
                                live = torch.repeat_interleave(
                                    plan.row_mask > 0, block)
                                check(got.dtype == out, f"edge dtype {out}")
                                err = held(
                                    f"block=64 {kw} n={n} B {layout}-"
                                    f"contiguous {path} out={out} "
                                    f"transpose_lhs={transpose}",
                                    got[live], plain[live], want[live],
                                    KERNEL_RTOL if out == torch.float32
                                    else BF16_RTOL)
                                if out == torch.float32:
                                    worst[transpose] = max(worst[transpose],
                                                           err)
                                count[transpose] += 1
                                on_path[path] += 1
        # bf16 output, every item its own folded segment: on the simt and
        # tensor-core paths each segment is stored and reloaded in bf16
        # (2**-8 each), on the split path the run's sum is rounded once
        plan = api.plan_matmul(a, EDGE_N, fold_len=1, device=dev,
                               with_grad=True)
        for dt, path in ((torch.float32, "simt"), (torch.bfloat16, "split"),
                         (torch.bfloat16, "tc")):
            if block != 64 and path != "simt":
                continue
            x = torch.randn(EDGE_N, a.shape[1], generator=gen,
                            device=dev).to(dt)
            before = _path_counts()
            got = segment_spmm(
                plan.lhs_blocks, plan.slot_idx, plan.m_idx, plan.k_idx,
                plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid,
                x.T, grid_m=plan.grid_m, n_lanes=plan.n_lanes,
                unroll=plan.unroll, out_dtype=torch.bfloat16,
                runs=plan.run_offsets, chunks=plan.chunk_offsets, path=path)
            _check_path(f"bf16 folded reload {path}", before, path)
            if path == "simt":
                simt_launches += 1
            # rows no item visits are left unwritten by the kernels
            live = torch.repeat_interleave(plan.row_mask > 0, block)
            want = plan(x.T, backend="reference")[live]
            got = got[live]
            err = float((got.float() - want).abs().max() / want.abs().max())
            check(got.dtype == torch.bfloat16 and err <= BF16_RTOL,
                  f"bf16 folded reload ({path}): {err:.3g}")
        # prefetch="cross_pass" (a TPU DMA timing) runs the drained kernel:
        # forward and dx through the grad plan, fp32 and int8/fp8 payloads,
        # equal to the drained plan bit for bit, two launches each, on every
        # path: fp32 x (simt), bf16 x at N = 16 (split) and at EDGE_N
        # (tensor cores; 64 blocks only)
        cases = [(torch.float32, 16, "simt")]
        if block == 64:
            cases += [(torch.bfloat16, 16, "split"),
                      (torch.bfloat16, EDGE_N, "tc")]
        for dt, n, path in cases:
            xin = torch.randn(n, a.shape[1], generator=gen, device=dev).to(dt)
            ct = torch.randn(a.shape[0], n, generator=gen, device=dev).to(dt)
            for quant in (None, "int8", "fp8"):
                outs = []
                for pf in (None, "cross_pass"):
                    plan = api.plan_matmul(a, n, device=dev, with_grad=True,
                                           quantize=quant, prefetch=pf)
                    xx = xin.clone().requires_grad_(True)
                    before = _path_counts()
                    y = api.apply_plan(plan, xx.T, blocks=plan.lhs_blocks,
                                       scales=plan.lhs_scales)
                    y.backward(ct)
                    torch.cuda.synchronize()
                    _check_path(f"cross_pass {quant} prefetch={pf}", before,
                                path, launches=2)
                    if path == "simt":
                        simt_launches += 2
                    outs.append((y.detach(), xx.grad))
                check(all(torch.equal(g, w) for g, w in zip(*outs)),
                      f"block={block} {quant} ({path}): cross_pass differs "
                      f"from drained")
                cross.append(path)
    print(f"[edges] forward: {count[False]} plans x layouts x paths, "
          f"transpose_lhs (grad plans): {count[True]}, within {KERNEL_RTOL} "
          f"of the plain version and the oracle (bf16 out within "
          f"{BF16_RTOL}; worst fp32 {worst[False]:.2e} / {worst[True]:.2e}); "
          f"calls per path {on_path}; bf16 folded reload ok on every path; "
          f"{len(cross)} prefetch='cross_pass' plans (fp32, int8, fp8; "
          f"forward and dx; paths {sorted(set(cross))}) equal to the drained "
          f"plans bit for bit")
    return simt_launches


def _rel(got, want):
    """max |got - want| over max |want| (both as fp32), and the max
    absolute difference."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30), diff


def _fro(got, want):
    """||got - want|| over ||want|| (Frobenius, as fp32)."""
    w = want.float()
    return float(torch.linalg.vector_norm(got.float() - w)) / max(
        float(torch.linalg.vector_norm(w)), 1e-30)


def _dense_of(plan, side):
    """Dense fp32 (dequantized) operand of an spgemm plan, for the library
    yardstick."""
    from repro_torch.kernels import ref
    if side == "a":
        blocks, scales, rows, cols = (plan.lhs_blocks, plan.lhs_scales,
                                      plan.a_brow, plan.a_bcol)
        grid = plan.grid
    else:
        blocks, scales, rows, cols = (plan.rhs_blocks, plan.rhs_scales,
                                      plan.b_brow, plan.b_bcol)
        grid = plan.rhs_grid
    return ref.bsr_to_dense(ref.dequant_blocks_ref(blocks, scales), rows,
                            cols, *grid)


def _spgemm_counts():
    """The SpGEMM wrapper's counts: all, quantized, tensor-core, simt."""
    from repro_torch.kernels.segment_spgemm import segment_spgemm
    return (segment_spgemm.launches, segment_spgemm.quantized_launches,
            segment_spgemm.tc_launches, segment_spgemm.simt_launches)


def _zero_spgemm_counts():
    from repro_torch.kernels.segment_spgemm import segment_spgemm
    segment_spgemm.launches = segment_spgemm.quantized_launches = 0
    segment_spgemm.tc_launches = segment_spgemm.simt_launches = 0


def _spgemm_call(plan, path=None, out_dtype=torch.float32):
    """One ``segment_spgemm`` launch on the plan's leaves, on ``path``
    (default: the wrapper's choice)."""
    from repro_torch.kernels.segment_spgemm import segment_spgemm
    return segment_spgemm(
        plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx, plan.c_idx,
        plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid,
        n_c_blocks=plan.n_out_blocks, n_lanes=plan.n_lanes,
        unroll=plan.unroll, out_dtype=out_dtype, a_scales=plan.lhs_scales,
        b_scales=plan.rhs_scales, runs=plan.run_offsets,
        work=(plan.tc_runs, plan.tc_steps), path=path)


def _spgemm_plain(plan):
    from repro_torch.kernels.segment_spgemm import segment_spgemm_plain
    return segment_spgemm_plain(
        plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx,
        plan.c_idx, plan.valid, n_c_blocks=plan.n_out_blocks,
        a_scales=plan.lhs_scales, b_scales=plan.rhs_scales)


def _spgemm_passes(plan):
    """bf16 passes of the tensor-core path: six for fp32 tiles, one for a
    per-block-scaled payload, three for a rowwise one."""
    if not plan.quantized:
        return 6
    return 3 if plan.lhs_scales.ndim == 2 else 1


def spgemm_sm_bytes(plan, path):
    """Bytes one call of ``path`` moves from L2 into the SMs, counted from
    the plan's schedule: both tiles of each valid item and their rowwise
    scale rows, C blocks written at each seg_write and read at each
    accum_prev, and for ``"tc"`` the work table's rows."""
    tile_a = plan.lhs_blocks[0].numel() * plan.lhs_blocks.element_size()
    tile_b = plan.rhs_blocks[0].numel() * plan.rhs_blocks.element_size()
    rowwise = plan.quantized and plan.lhs_scales.ndim == 2
    bm, bk = plan.block_shape
    c_block = bm * plan.rhs_blocks.shape[2] * 4
    valid = int(plan.valid.sum())
    c = c_block * (int(plan.seg_write.sum()) + int(plan.accum_prev.sum()))
    table = (plan.tc_steps.numel() * 4 + plan.tc_runs.numel() * 4
             if path == "tc" else 0)
    return valid * (tile_a + tile_b + rowwise * 4 * (bm + bk)) + c + table


def spgemm_case(label, plan, out, fp32_out=None, library_ms=None):
    """One main-path SpGEMM output ``out`` (from ``plan()``) against the
    plain version and the ``"reference"`` backend, and (for a quantized
    plan) against the fp32 result; then every path that takes the call,
    each held against the plain version and timed beside its bound and the
    bytes it moves into the SMs; the plain version's and the library's
    dense product's times.  Returns a record."""
    sg = importlib.import_module("repro_torch.kernels.segment_spgemm")

    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    plain_out = _spgemm_plain(plan)
    rel_plain, abs_plain = _rel(out, plain_out)
    rel_ref, _ = _rel(out, plan(backend="reference"))
    check(rel_plain <= KERNEL_RTOL and rel_ref <= KERNEL_RTOL,
          f"{label}: kernel vs plain {rel_plain:.3g}, vs reference "
          f"{rel_ref:.3g} > {KERNEL_RTOL}")
    rec = dict(case=label, mode=plan.block_dtype, rel_err=rel_plain,
               max_abs_err=abs_plain, rel_err_ref=rel_ref,
               items=int(plan.valid.sum()), c_blocks=plan.n_out_blocks)
    if fp32_out is not None:
        gate = QUANT_GATE[plan.block_dtype.split(".")[0]]
        rec["quant_err"], _ = _rel(out, fp32_out)
        check(rec["quant_err"] < gate, f"{label}: vs fp32 "
                                       f"{rec['quant_err']:.3g} >= {gate}")
    # bound of each path: each stored tile (payload and scales) read once,
    # C written once; 2 * bm * bk * bn operations per valid triple, at the
    # fp32 CUDA-core peak on simt and as bf16 passes at the tensor-core
    # peak on tc
    bm, bk = plan.block_shape
    bn = plan.rhs_blocks.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (
        plan.lhs_blocks, plan.rhs_blocks, plan.lhs_scales, plan.rhs_scales)
        if t is not None) + out.numel() * out.element_size()
    ops = 2 * rec["items"] * bm * bk * bn
    t_bytes = nbytes / HBM_BYTES_PER_S
    peaks = {"tc": (BF16_FLOPS, _spgemm_passes(plan)), "simt": (FP32_FLOPS, 1)}
    mode = sg.storage_mode(plan.lhs_blocks.dtype, plan.rhs_blocks.dtype,
                           None if plan.lhs_scales is None
                           else plan.lhs_scales.ndim,
                           None if plan.rhs_scales is None
                           else plan.rhs_scales.ndim)
    by_path = {}
    for path in sg.paths_for(bm, bk, bn, mode, out.dtype):
        peak, passes = peaks[path]
        t_ops = ops * passes / peak
        got = _spgemm_call(plan, path)
        err, abs_err = _rel(got, plain_out)
        check(err <= KERNEL_RTOL, f"{label} on {path}: vs plain {err:.3g} > "
                                  f"{KERNEL_RTOL}")
        del got
        by_path[path] = dict(
            ms=device_ms(lambda: _spgemm_call(plan, path), 4),
            sm_bytes=spgemm_sm_bytes(plan, path), rel_err=err,
            max_abs_err=abs_err,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            passes=passes)
    main = by_path[sg.choose_path(bm, bk, bn, mode, out.dtype)]
    rec.update(path=sg.choose_path(bm, bk, bn, mode, out.dtype),
               ms=main["ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], sm_bytes=main["sm_bytes"],
               plain_ms=device_ms(lambda: _spgemm_plain(plan), 2),
               by_path=by_path)
    if library_ms is None:
        # the library's dense fp32 product of the (dequantized) operands
        a, b = _dense_of(plan, "a"), _dense_of(plan, "b")
        library_ms = device_ms(lambda: a @ b, 2)
        del a, b
    rec["library_ms"] = library_ms
    print(f"[spgemm] {label:<15} {plan.block_dtype:<12} items={rec['items']} "
          f"c_blocks={rec['c_blocks']} rel_err plain={rel_plain:.2e} "
          f"ref={rel_ref:.2e}"
          + (f" vs_fp32={rec['quant_err']:.2e}" if fp32_out is not None
             else "")
          + f" plain_ms={rec['plain_ms']:.4f} library_ms={library_ms:.4f} "
          f"(dense fp32 cuBLAS)")
    for path, r in by_path.items():
        print(f"[spgemm]   {path:<4} kernel_ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, "
              f"{r['passes']} pass{'es' if r['passes'] > 1 else ''}) "
              f"sm_bytes={r['sm_bytes'] / 1e9:.3f} GB")
    return rec


def cusparse_ms(plan):
    """One ``torch.sparse.mm`` of the two operands as CSR tensors on the
    card (cuSPARSE SpGEMM), timed between CUDA events, first call; or why
    it could not run."""
    a = _dense_of(plan, "a").to_sparse_csr()
    b = _dense_of(plan, "b").to_sparse_csr()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        c = torch.sparse.mm(a, b)
        end.record()
        end.synchronize()
    except (RuntimeError, torch.OutOfMemoryError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    nnz = c._nnz()
    del a, b, c
    return start.elapsed_time(end), f"nnz(C) {nnz}"


def phase_spgemm(dev):
    """SpGEMM through ``plan_matmul(A, B)`` → ``plan()`` at granite-3-8b's
    FFN shapes (both cases in fp32, the four quantized modes on up_down),
    each held against the plain version and the reference backend, then
    the edge sweep.  Returns the records, the main path's launch counts
    (all, quantized) and the edge sweep's launches on ``"simt"``."""
    from repro_torch import api
    from repro_torch.core.formats import BSR, QUANT_MODES

    runs = []
    for case, (a_shape, b_shape, policy) in SPGEMM_CASES.items():
        a = BSR.random(np.random.default_rng(SEED), a_shape, (64, 64), 0.25)
        b = BSR.random(np.random.default_rng(SEED + 1), b_shape, (64, 64),
                       0.25)
        modes = (None,) + (QUANT_MODES if case == SPGEMM_QUANT_CASE else ())
        for q in modes:
            t0 = time.perf_counter()
            plan = api.plan_matmul(a, b, policy=policy, quantize=q,
                                   device=dev)
            print(f"[spgemm] plan {case} {plan.block_dtype} ({policy}): "
                  f"{plan.n_items} items, {plan.n_out_blocks} C blocks, "
                  f"{plan.n_runs} owner runs, planned in "
                  f"{time.perf_counter() - t0:.1f} s")
            runs.append((case, plan))
        del a, b
    # the main path: every plan once through plan(), counts set just before
    torch.cuda.synchronize()
    _zero_spgemm_counts()
    outs = [plan() for _, plan in runs]
    torch.cuda.synchronize()
    launches, quantized, tc, simt = _spgemm_counts()
    n_quant = sum(plan.quantized for _, plan in runs)
    check(launches == len(runs) and quantized == n_quant
          and tc == len(runs) and simt == 0,
          f"spgemm main path: {launches} launches ({quantized} quantized, "
          f"{tc} tc, {simt} simt) != {len(runs)} ({n_quant}, all tc)")
    print(f"[spgemm] main path: {len(runs)} plan() calls, segment_spgemm "
          f"launches {launches} ({quantized} quantized), per path: tc {tc}, "
          f"simt {simt}")

    recs, fp32_out, library = [], {}, {}
    for (case, plan), out in zip(runs, outs):
        rec = spgemm_case(case, plan, out, fp32_out.get(case),
                          library.get(case))
        if not plan.quantized:
            fp32_out[case] = out
            library[case] = rec["library_ms"]
        recs.append(rec)
    for case, plan in runs:
        if not plan.quantized:
            ms, note = cusparse_ms(plan)
            print(f"[spgemm] {case}: torch.sparse.mm on CSR (cuSPARSE), one "
                  f"call: " + (f"{ms:.2f} ms, " if ms is not None else "")
                  + note)
    del runs, outs, fp32_out
    simt_launches = phase_spgemm_edges(dev)
    return recs, launches, quantized, simt_launches


def phase_spgemm_edges(dev):
    """Small SpGEMM plans at the kernels' edges: 32 and 64 tiles; segment,
    folded (``fold_len=2``), four-lane, gustavson with ``n_lanes=2,
    unroll=2`` and k-major outer plans; fp32 and every quantized mode; each
    through ``plan()`` (one launch, on the path ``choose_path`` gives it)
    and forced onto every other path that takes it, each held against the
    plain version and the oracle.  Also bf16 output with every item folded
    (each path), an empty symbolic C (no launch), a one-item plan, the
    eight tile shapes of 32 and 64 on the CUDA-core path, and tiles of 16
    and 128 that must raise on the card.  Returns the launches on
    ``"simt"``."""
    from repro_torch import api
    from repro_torch.core.formats import BSR, QUANT_MODES
    sg = importlib.import_module("repro_torch.kernels.segment_spgemm")

    simt = 0

    def run(plan, path=None, want_launches=1, out_dtype=torch.float32):
        nonlocal simt
        _zero_spgemm_counts()
        got = plan() if path is None else _spgemm_call(plan, path,
                                                       out_dtype=out_dtype)
        launches, quantized, tc, on_simt = _spgemm_counts()
        want = path or (plan.n_out_blocks and sg.choose_path(
            *plan.block_shape, plan.rhs_blocks.shape[2],
            sg.storage_mode(plan.lhs_blocks.dtype, plan.rhs_blocks.dtype,
                            None if plan.lhs_scales is None
                            else plan.lhs_scales.ndim,
                            None if plan.rhs_scales is None
                            else plan.rhs_scales.ndim),
            got.dtype))
        check([launches, quantized, tc, on_simt] == [
            want_launches, want_launches * plan.quantized,
            want_launches * (want == "tc"), want_launches * (want == "simt")],
              f"edge {plan.policy} {plan.block_dtype} {plan.block_shape} on "
              f"{want}: launches (all, quantized, tc, simt) "
              f"{[launches, quantized, tc, on_simt]}")
        simt += on_simt
        return got

    def paths(plan, out_dtype=torch.float32):
        return sg.paths_for(
            *plan.block_shape, plan.rhs_blocks.shape[2],
            sg.storage_mode(plan.lhs_blocks.dtype, plan.rhs_blocks.dtype,
                            None if plan.lhs_scales is None
                            else plan.lhs_scales.ndim,
                            None if plan.rhs_scales is None
                            else plan.rhs_scales.ndim), out_dtype)

    worst, count, on_path = 0.0, 0, {}
    variants = [{}, {"fold_len": 2}, {"n_lanes": 4},
                {"policy": "gustavson", "n_lanes": 2, "unroll": 2},
                {"policy": "outer", "n_lanes": 2}]
    for block in (32, 64):
        rng = np.random.default_rng(block)
        a = BSR.random(rng, (12 * block, 9 * block), (block, block), 0.35)
        b = BSR.random(rng, (9 * block, 10 * block), (block, block), 0.35)
        for kw in variants:
            for q in (None,) + QUANT_MODES:
                plan = api.plan_matmul(a, b, quantize=q, device=dev, **kw)
                plain = _spgemm_plain(plan)
                want = plan(backend="reference")
                for path in (None,) + paths(plan)[1:]:
                    got = run(plan, path)
                    err = max(_rel(got, plain)[0], _rel(got, want)[0])
                    label = path or paths(plan)[0]
                    check(err <= KERNEL_RTOL, f"spgemm edge block={block} "
                                              f"{kw} {q} on {label}: "
                                              f"{err:.3g}")
                    worst, count = max(worst, err), count + 1
                    on_path[label] = on_path.get(label, 0) + 1
        # bf16 output: every item its own folded segment, so each partial
        # sum is stored and reloaded in bf16 (2**-8 each time)
        plan = api.plan_matmul(a, b, fold_len=1, device=dev,
                               out_dtype=torch.bfloat16)
        want = plan(backend="reference", out_dtype=torch.float32)
        for path in (None,) + paths(plan, torch.bfloat16)[1:]:
            got = run(plan, path, out_dtype=torch.bfloat16)
            err = _rel(got, want)[0]
            check(got.dtype == torch.bfloat16 and err <= 1e-2,
                  f"spgemm bf16 folded reload on {path}: {err:.3g}")
        one = BSR((block, block), (block, block), np.zeros(1, np.int32),
                  np.zeros(1, np.int32), rng.standard_normal(
                      (1, block, block)).astype(np.float32))
        plan = api.plan_matmul(one, one, device=dev)
        check(plan.n_items == 1, "one-item plan")
        for path in (None,) + paths(plan)[1:]:
            err = _rel(run(plan, path), plan(backend="reference"))[0]
            check(err <= KERNEL_RTOL, f"spgemm one-item plan: {err:.3g}")
    ones = np.ones((2, 32, 32), np.float32)
    a = BSR((64, 64), (32, 32), np.array([0, 1], np.int32),
            np.array([0, 0], np.int32), ones)
    b = BSR((64, 64), (32, 32), np.array([1], np.int32),
            np.array([0], np.int32), ones[:1])
    for q in (None, "int8"):
        plan = api.plan_matmul(a, b, quantize=q, device=dev)
        got = run(plan, want_launches=0)
        check(tuple(got.shape) == (0, 32, 32), f"empty C: {got.shape}")
    # every tile shape of 32 and 64 on the CUDA-core path, in fp32 and in a
    # per-block and a rowwise mode
    shapes = 0
    for bm, bk, bn in itertools.product((32, 64), repeat=3):
        rng = np.random.default_rng(bm + 2 * bk + 3 * bn)
        a = BSR.random(rng, (4 * bm, 3 * bk), (bm, bk), 0.5)
        b = BSR.random(rng, (3 * bk, 4 * bn), (bk, bn), 0.5)
        for q in (None, "int8", "fp8.rowwise"):
            plan = api.plan_matmul(a, b, quantize=q, device=dev)
            got = run(plan, "simt" if bm == bk == bn == 64 else None)
            err = max(_rel(got, _spgemm_plain(plan))[0],
                      _rel(got, plan(backend="reference"))[0])
            check(err <= KERNEL_RTOL, f"spgemm tile ({bm}, {bk}, {bn}) {q} on "
                                      f"simt: {err:.3g}")
            worst, shapes = max(worst, err), shapes + 1
    raised = 0
    for bm, bk, bn in ((16, 16, 16), (128, 128, 128), (64, 128, 64),
                       (32, 16, 32)):
        a = BSR.random(np.random.default_rng(3), (2 * bm, 2 * bk), (bm, bk),
                       0.5)
        b = BSR.random(np.random.default_rng(4), (2 * bk, 2 * bn), (bk, bn),
                       0.5)
        try:
            api.plan_matmul(a, b, device=dev)()
        except NotImplementedError:
            raised += 1
        else:
            raise RuntimeError(f"a ({bm}, {bk}, {bn}) tile ran on the card")
    print(f"[spgemm-edges] {count} calls (5 schedules x 5 storage modes x 2 "
          f"tiles, each on every path that takes it: {on_path}) within "
          f"{KERNEL_RTOL} of the plain version and the oracle; {shapes} "
          f"calls over the 8 tile shapes of 32 and 64 (fp32, int8, "
          f"fp8.rowwise) on simt; worst {worst:.2e}; one launch each on its "
          f"path; bf16 folded reload and one-item plans ok on each path; "
          f"empty C: no launch; tiles of 16 and 128: {raised} raise "
          f"NotImplementedError")
    return simt


def event_ms(fn, n=3):
    """Time of one ``fn()`` between CUDA events around ``n`` host-launched
    calls, after one warm-up call: for the plain versions, which a CUDA
    graph cannot always capture (``moe_gemm_plain`` reads ``chunk_expert``
    on the host), so their number includes the host's launch path."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def scaled_device_ms(fn):
    """``device_ms`` with fewer captured calls for a long call: 20 under 1
    ms, 4 under 10 ms, else 1 (and 3 replays), so the phase stays short."""
    t = event_ms(fn, 1)
    if t < 1:
        return device_ms(fn, 20)
    if t < 10:
        return device_ms(fn, 4)
    return device_ms(fn, 1, replays=3)


def ops_call(kernel, want, fn, label):
    """The ops path: ``fn()`` (a call of an ``ops`` entry point) with
    ``kernel``'s launch count set to 0 just before and read just after; it
    must be ``want``.  Returns the result and the count."""
    torch.cuda.synchronize()
    kernel.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = kernel.launches
    check(got == want, f"[ops] {label}: {kernel.__name__} launched {got} "
                       f"times, expected {want}")
    return out, got


def _bound(nbytes, ops, peak=FP32_FLOPS):
    """The least time for ``nbytes`` moved once and ``ops`` operations at
    the peak rate of the operands' type, in ms, and which of the two binds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_call(want_path, fn, label, tag="[ops]"):
    """``fn()`` (one flash_attention or flash_mha call) with every
    flash_attention count set to 0 just before and read just after: one
    launch, on ``want_path``.  Returns the result."""
    from repro_torch.kernels.flash_attention import PATHS, flash_attention
    torch.cuda.synchronize()
    flash_attention.launches = 0
    for p in PATHS:
        setattr(flash_attention, f"{p}_launches", 0)
    out = fn()
    torch.cuda.synchronize()
    want = [1] + [int(p == want_path) for p in PATHS]
    got = [flash_attention.launches] + [
        getattr(flash_attention, f"{p}_launches") for p in PATHS]
    check(got == want, f"{tag} {label}: flash_attention launches (all, "
                       f"{', '.join(PATHS)}) {got}, expected {want}")
    return out


def attn_bound(path, nbytes, pairs, d, q_dtype, k_dtype, v_dtype):
    """The least time of one attention call on ``path``: the bytes moved
    once, and the 4 D operations of each live (query, key) pair at the
    peak of the path's arithmetic: fp32 on the CUDA cores (``simt``,
    ``splitkv``), or on ``tc`` as bf16 ``wgmma`` passes at 989 TFLOP/s
    (Q·Kᵀ's passes on half, P·V's on the other half)."""
    from repro_torch.kernels.flash_attention import tc_passes
    if path != "tc":
        return _bound(nbytes, 4 * d * pairs)
    parts = {torch.float32: 3, torch.bfloat16: 1}
    passes = (len(tc_passes(parts[q_dtype], parts[k_dtype]))
              + len(tc_passes(3, parts[v_dtype])))
    return _bound(nbytes, 2 * d * pairs * passes, BF16_FLOPS)


def ops_attention(label, cfg_name, b, tq, tk, window, want_path, dev, gen,
                  dtype=torch.float32, prefix="[ops]"):
    """One attention case through ``ops.flash_mha`` (q/k/v of ``dtype`` at
    the config's head layout, causal): one launch, on ``want_path`` (by
    that path's own count), and for the fp32 cases of
    ``OPS_ATTN_SYNC_FREE`` one more under ``set_sync_debug_mode("error")``;
    every path that can take the stacked call against the plain version
    (fp32 output) and timed (output in ``dtype``, as ``flash_mha`` runs
    it); the entry point against ``ref.mha_ref``; the bound of each path,
    the plain version's time and the library's SDPA in ``dtype``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     paths_for)
    cfg = get_config(cfg_name)
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.hd
    win = cfg.local_window if window == "local" else None
    q = (torch.randn(b, tq, h, d, generator=gen, device=dev) * 0.5).to(dtype)
    k = (torch.randn(b, tk, hkv, d, generator=gen, device=dev) * 0.5).to(dtype)
    v = (torch.randn(b, tk, hkv, d, generator=gen, device=dev) * 0.5).to(dtype)
    tag = f"{label} {str(dtype).replace('torch.', '')}"
    out = attn_call(want_path, lambda: ops.flash_mha(
        q, k, v, causal=True, window=win), tag, prefix)
    launches = 1
    if dtype == torch.float32 and label in OPS_ATTN_SYNC_FREE:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            attn_call(want_path, lambda: ops.flash_mha(
                q, k, v, causal=True, window=win), tag + " (sync-free)",
                prefix)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches += 1
    check(out.shape == q.shape and out.dtype == q.dtype
          and bool(torch.isfinite(out).all()), f"{prefix} {tag}: output")
    rel_ref, _ = _rel(out, ref.mha_ref(q, k, v, causal=True, window=win))
    ref_tol = KERNEL_RTOL if dtype == torch.float32 else BF16_RTOL
    check(rel_ref <= ref_tol, f"{prefix} {tag}: flash_mha vs mha_ref "
                              f"{rel_ref:.3g} > {ref_tol}")
    qh, kh, vh, kw = ops.stack_heads(q, k, v)

    def plain():
        return flash_attention_plain(qh, kh, vh, causal=True, window=win,
                                     out_dtype=torch.float32, **kw)

    want = plain()
    # live (query, key) pairs: query i sits at position tk - tq + i and sees
    # keys max(0, p - window + 1) .. p
    pos = torch.arange(tk - tq, tk, device=dev)
    lo = (pos - win + 1).clamp(min=0) if win is not None else 0
    pairs = int((pos + 1 - lo).sum()) * b * h
    by_path = {}
    for path in paths_for(*qh.shape[:2], kh.shape[1], d, (dtype,) * 3):
        def kern(path=path, out_dtype=None):
            return flash_attention(qh, kh, vh, causal=True, window=win,
                                   out_dtype=out_dtype, path=path, **kw)
        got = attn_call(path, lambda: kern(out_dtype=torch.float32),
                        f"{tag} on {path}", prefix)
        rel, diff = _rel(got, want)
        del got
        check(rel <= KERNEL_RTOL, f"{prefix} {tag} on {path}: kernel vs plain "
                                  f"{rel:.3g} > {KERNEL_RTOL}")
        bound_ms, bound_by = attn_bound(path, _nbytes(q, k, v, out), pairs, d,
                                        dtype, dtype, dtype)
        by_path[path] = dict(ms=scaled_device_ms(kern), rel_err=rel,
                             max_abs_err=diff, bound_ms=bound_ms,
                             bound_by=bound_by)
    del want
    # the library's fused attention on the same tensors, (B, H, T, D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qpos, kpos = pos[:, None], torch.arange(tk, device=dev)[None, :]
    mask = kpos <= qpos
    if win is not None:
        mask &= kpos > qpos - win
    kw_lib = (dict(is_causal=True) if win is None and tq == tk
              else dict(attn_mask=None if bool(mask.all()) else mask))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw_lib)

    mine = by_path[want_path]
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""),
               kernel="flash_attention", path=want_path, launches=launches,
               rel_err=mine["rel_err"], max_abs_err=mine["max_abs_err"],
               rel_err_ref=rel_ref, ms=mine["ms"],
               plain_ms=event_ms(plain, 1), bound_ms=mine["bound_ms"],
               bound_by=mine["bound_by"],
               library_ms=scaled_device_ms(library),
               library=f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                       f"scaled_dot_product_attention(enable_gqa=True)",
               by_path=by_path)
    times = ", ".join(f"{p} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                      f"{r['bound_by']}; err {r['rel_err']:.2e})"
                      for p, r in by_path.items())
    print(f"{prefix} {tag:<26} B={b} Tq={tq} Tk={tk} H={h} Hkv={hkv} D={d} "
          f"window={win}: path {want_path}, launches {launches}; {times}; "
          f"flash_mha vs mha_ref {rel_ref:.2e}; plain_ms="
          f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
          f"({rec['library']})")
    return rec


def attn_crossover(dev, gen):
    """[attn-crossover]: every path that can take the call, device times,
    on granite-3-8b's heads in fp32, at the shapes of ``ATTN_CROSSOVER``,
    beside what ``choose_path`` picks.  Sets ``choose_path``'s rule for
    ``"splitkv"`` (where it stops winning)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (choose_path,
                                                     flash_attention,
                                                     paths_for)
    cfg = get_config("granite-3-8b")
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.hd
    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worse = 0
    for kind, b, tq, tk in ATTN_CROSSOVER:
        q = torch.randn(b, tq, h, d, generator=gen, device=dev) * 0.5
        k = torch.randn(b, tk, hkv, d, generator=gen, device=dev) * 0.5
        v = torch.randn(b, tk, hkv, d, generator=gen, device=dev) * 0.5
        qh, kh, vh, kw = ops.stack_heads(q, k, v)
        shape = (*qh.shape[:2], kh.shape[1], d)
        picked = choose_path(*shape, sms=sms)
        ms = {}
        for path in paths_for(*shape):
            ms[path] = scaled_device_ms(lambda path=path: flash_attention(
                qh, kh, vh, causal=True, path=path, **kw))
        best = min(ms, key=ms.get)
        worse += ms[picked] > 1.03 * ms[best]
        print(f"[attn-crossover] {kind:<7} B={b:<2} Tq={tq:<5} Tk={tk:<5} (bh "
              f"{shape[0]}, stacked rows {shape[1]}): " + ", ".join(
                  f"{p} {t:.4f} ms" for p, t in ms.items())
              + f"; choose_path -> {picked}, fastest {best}")
        del q, k, v, qh, kh, vh
    print(f"[attn-crossover] {worse} cases where choose_path's pick is more "
          f"than 3 % slower than the fastest path; "
          f"{time.perf_counter() - t0:.1f} s")


def _moe_oracle(x, w_up, w_down, logits, top_k):
    """The MoE FFN token by token in fp32 (no capacity: the caller checks
    that no token was dropped), the activation cast to x's dtype between
    the two products as ``moe_apply`` does."""
    import torch.nn.functional as F
    vals, idx = torch.topk(logits, top_k)
    gates = torch.softmax(vals, dim=-1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        for e in idx[:, j].unique().tolist():
            rows = (idx[:, j] == e).nonzero().flatten()
            mid = F.silu(x[rows].float() @ w_up[e].float()).to(x.dtype)
            out[rows] += gates[rows, j, None] * (mid.float()
                                                 @ w_down[e].float())
    return out


def _moe_bounds(x_rows, live, experts, w):
    """(padded, live) bounds of one grouped GEMM, each (ms, by): the padded
    work reads every weight and row of the buffer; the live work reads the
    weights of the experts that hold a live row and the live rows only.
    Both write the whole output (fp32)."""
    n_exp, d_in, d_out = w.shape
    rows = x_rows.shape[0]
    live_rows = int(live.sum())
    live_exp = int(torch.unique(experts[live > 0]).numel())
    out_bytes = rows * d_out * 4
    padded = _bound(_nbytes(x_rows, w) + out_bytes, 2 * rows * d_in * d_out,
                    BF16_FLOPS)
    alive = _bound(live_exp * d_in * d_out * w.element_size()
                   + live_rows * d_in * x_rows.element_size() + out_bytes,
                   2 * live_rows * d_in * d_out, BF16_FLOPS)
    return padded, alive


def ops_moe(dev, gen):
    """``ops.moe_apply`` at Llama-4 Maverick's expert widths (bf16 x and
    weights, top-1, 128 experts, chunk_rows 128, capacity 1.25) for each
    token count of ``OPS_MOE_TOKENS``: 2 x top_k launches, all of them on
    the tensor-core kernel, with no host sync (one call under
    ``torch.cuda.set_sync_debug_mode("error")``); the result against a
    token-by-token oracle and the whole call's time; then the up and the
    down GEMM on moe_apply's own chunk buffers, with and without the
    per-chunk live-row counts moe_apply passes, each against its plain
    version, timed, beside the padded and the live bound and the library's
    batched bf16 product.  One call at each T is profiled (the device time
    of each operation of the call)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import (build_moe_chunks, moe_gemm,
                                              moe_gemm_plain)
    cfg = get_config("llama4-maverick-400b-a17b")
    n_exp, dm, dff, top_k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    cf, rows = cfg.moe_capacity_factor, 128
    bf16 = torch.bfloat16
    w_up = torch.randn(n_exp, dm, dff, generator=gen, device=dev,
                       dtype=bf16).mul_(dm ** -0.5)
    w_down = torch.randn(n_exp, dff, dm, generator=gen, device=dev,
                         dtype=bf16).mul_(dff ** -0.5)
    recs = []
    for t in OPS_MOE_TOKENS:
        label = f"maverick moe T={t}"
        x = torch.randn(t, dm, generator=gen, device=dev, dtype=bf16)
        logits = torch.randn(t, n_exp, generator=gen, device=dev)

        def call():
            return ops.moe_apply(x, w_up, w_down, logits, top_k=top_k,
                                 chunk_rows=rows, capacity_factor=cf)

        moe_gemm.tensor_core_launches = 0
        out, launches = ops_call(moe_gemm, 2 * top_k, call, label)
        check(moe_gemm.tensor_core_launches == launches,
              f"[ops] {label}: {moe_gemm.tensor_core_launches} of "
              f"{launches} launches on the tensor-core kernel")
        check(out.shape == x.shape and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"[ops] {label}: output")
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(torch.equal(again, out), f"[ops] {label}: a second call "
                                       f"differs")
        del again
        rel_ref, _ = _rel(out, _moe_oracle(x, w_up, w_down, logits, top_k))
        check(rel_ref <= BF16_RTOL, f"[ops] {label}: moe_apply vs oracle "
                                    f"{rel_ref:.3g} > {BF16_RTOL}")
        apply_ms = event_ms(call, 3)
        profile_once(f"moe_apply T={t}", call)
        del out
        # moe_apply's first chunk buffer and live-row counts, built as it
        # builds them
        idx = torch.topk(logits, top_k)[1][:, 0]
        order, slot, chunk_expert, keep, n_chunks, cap_rows = \
            build_moe_chunks(idx, n_exp, rows, cf)
        check(bool(keep.all()), f"[ops] {label}: tokens dropped")
        buf = torch.zeros((n_exp * cap_rows + 1, dm), dtype=bf16, device=dev)
        buf[slot] = x[order]
        buf = buf[:-1]
        counts = torch.bincount(idx, minlength=n_exp).clamp(max=cap_rows)
        live = (counts[:, None] - torch.arange(0, cap_rows, rows,
                                               device=dev)).clamp(
            0, rows).reshape(-1).int()
        mid = F.silu(moe_gemm(buf, w_up, chunk_expert, chunk_rows=rows,
                              live_rows=live)).to(bf16)
        gemm, bounds, bmm = {}, {}, {}
        for name, xs, w in (("up", buf, w_up), ("down", mid, w_down)):
            for lv in (live, None):
                def kern(xs=xs, w=w, lv=lv):
                    return moe_gemm(xs, w, chunk_expert, chunk_rows=rows,
                                    live_rows=lv)

                def plain(xs=xs, w=w, lv=lv):
                    return moe_gemm_plain(xs, w, chunk_expert,
                                          chunk_rows=rows, live_rows=lv)

                moe_gemm.launches = moe_gemm.tensor_core_launches = 0
                got = kern()
                torch.cuda.synchronize()
                check(moe_gemm.tensor_core_launches == 1,
                      f"[ops] {label} {name}: not on the tensor-core kernel")
                rel, err = _rel(got, plain())
                del got
                check(rel <= KERNEL_RTOL, f"[ops] {label}: {name} GEMM "
                      f"(live_rows={lv is not None}) vs plain {rel:.3g} > "
                      f"{KERNEL_RTOL}")
                gemm[name, lv is not None] = dict(
                    rel=rel, err=err, ms=scaled_device_ms(kern),
                    plain_ms=event_ms(plain, 1))
            bounds[name] = _moe_bounds(xs, live, chunk_expert, w)
            view = xs.view(n_exp, cap_rows, w.shape[1])
            bmm[name] = scaled_device_ms(lambda: torch.bmm(view, w))
        # the main path's call: the up GEMM with moe_apply's live rows
        up, (bound_ms, bound_by) = gemm["up", True], bounds["up"][1]
        rec = dict(case=label, kernel="moe_gemm", launches=launches,
                   rel_err=max(g["rel"] for g in gemm.values()),
                   max_abs_err=max(g["err"] for g in gemm.values()),
                   rel_err_ref=rel_ref, ms=up["ms"],
                   plain_ms=up["plain_ms"], bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=bmm["up"],
                   library="bf16 torch.bmm of the (E, cap_rows, d_in) buffer")
        print(f"[ops] {label:<21} {n_chunks} chunks x {rows} rows "
              f"({t * top_k} real, {int(live.sum())} live), d {dm} -> "
              f"{dff} -> {dm}: moe_apply {apply_ms:.4f} ms (CUDA events, "
              f"{launches} launches, all tensor-core, no host sync), vs "
              f"oracle {rel_ref:.2e}")
        for name in ("up", "down"):
            (pb, pby), (lb, lby) = bounds[name]
            for lv in (True, False):
                g = gemm[name, lv]
                print(f"[ops]   {name:<4} GEMM live_rows={'yes' if lv else 'no '}"
                      f": kernel_ms={g['ms']:.4f} plain_ms="
                      f"{g['plain_ms']:.4f} rel_err plain={g['rel']:.2e}")
            print(f"[ops]   {name:<4} GEMM bound_ms live={lb:.4f} ({lby}) "
                  f"padded={pb:.4f} ({pby}) library_ms={bmm[name]:.4f} "
                  f"(bf16 bmm)")
        recs.append(rec)
        del x, logits, buf, mid
    return recs


def lru_call(want_path, fn, label, tag="[ops]"):
    """``fn()`` (one rg_lru or rg_lru_scan call) with every rg_lru count set
    to 0 just before and read just after: one launch, on ``want_path``.
    Returns the result."""
    from repro_torch.kernels.rg_lru import PATHS, rg_lru
    torch.cuda.synchronize()
    rg_lru.launches = 0
    for p in PATHS:
        setattr(rg_lru, f"{p}_launches", 0)
    out = fn()
    torch.cuda.synchronize()
    want = [1] + [int(p == want_path) for p in PATHS]
    got = [rg_lru.launches] + [getattr(rg_lru, f"{p}_launches")
                               for p in PATHS]
    check(got == want, f"{tag} {label}: rg_lru launches (all, "
                       f"{', '.join(PATHS)}) {got}, expected {want}")
    return out


def rg_lru_sfu_per_element():
    """The SFU operations of one gate evaluation: the MUFU instructions of
    ``rg_lru_gate_probe``'s SASS (cuobjdump of the built library) up to its
    EXIT; the slow paths past it run only on special operands."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", "-fun", "rg_lru_gate_probe",
         str(build.library_path("rg_lru.cu"))], capture_output=True,
        text=True, check=True).stdout
    body = sass.split("EXIT")[0]
    n = body.count("MUFU")
    check(n > 0 and "rg_lru_gate_probe" in sass,
          f"no MUFU in rg_lru_gate_probe's SASS:\n{sass[:2000]}")
    return n


def rg_lru_bound(nbytes, elems, sfu_per_elem):
    """The least time of one RG-LRU call: the larger of the bytes moved
    once at 3.35 TB/s, ~20 fp32 operations an element at the fp32 peak and
    the SFU operations at the SFU's rate.  Returns (ms, by, the three terms
    in ms)."""
    terms = (nbytes / HBM_BYTES_PER_S * 1e3, 20 * elems / FP32_FLOPS * 1e3,
             sfu_per_elem * elems / SFU_OPS * 1e3)
    return (max(terms), "bytes" if terms[0] >= max(terms[1:])
            else "operations", terms)


def ops_rg_lru(dev, gen, cases=OPS_RG_LRU_CASES, tag="[ops]"):
    """``ops.rg_lru_scan`` at RecurrentGemma-9B's width (D = d_model) for
    each case of ``cases``: one launch each on the case's path
    (by that path's own count), the kernel against its plain version, the
    chosen path against the other one forced on the same inputs (bit for
    bit: both run one gate function and the same fused step), the entry
    point against ``ref.rg_lru_ref`` on the same values in fp32, each path's
    time and the bound (bytes, fp32 operations and SFU operations; no
    single library call computes it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rg_lru import (choose_path, paths_for, rg_lru,
                                            rg_lru_plain)
    d = get_config("recurrentgemma-9b").d_model
    sfu = rg_lru_sfu_per_element()
    print(f"{tag} rg_lru: {sfu} SFU operations an element "
          f"(rg_lru_gate_probe's SASS)")
    recs = []
    for label, (b, t, dt, want_path) in cases.items():
        x, a_gate, x_gate = (torch.randn(b, t, d, generator=gen,
                                         device=dev).to(dt) for _ in range(3))
        a_param = torch.randn(d, generator=gen, device=dev)
        h0 = torch.randn(b, d, generator=gen, device=dev) if t == 1 else None
        check(choose_path(b, t, d, dt, dt, dt) == want_path,
              f"{tag} {label}: choose_path gives "
              f"{choose_path(b, t, d, dt, dt, dt)}, expected {want_path}")
        out, h_t = lru_call(want_path, lambda: ops.rg_lru_scan(
            x, a_gate, x_gate, a_param, h0, ct=128), label, tag)
        check(out.dtype == dt and h_t.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"{tag} {label}: output")
        h0z = h0 if h0 is not None else torch.zeros(b, d, device=dev)

        def plain():
            return rg_lru_plain(x, a_gate, x_gate, a_param, h0z)

        po, ph = plain()
        wo, wh = ref.rg_lru_ref(x.float(), a_gate.float(), x_gate.float(),
                                a_param, h0)
        rel_ref = max(_rel(out, wo)[0], _rel(h_t, wh)[0])
        # a bf16 output rounds once (2**-8); h_T and fp32 outputs are fp32
        tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
        by_path, results = {}, {}
        for path in paths_for(d, (dt,) * 3):
            def kern(path=path):
                return rg_lru(x, a_gate, x_gate, a_param, h0z,
                              ct=min(128, t), path=path)

            ko, kh = results[path] = lru_call(path, kern, f"{label} on {path}",
                                              tag)
            rel_o, abs_o = _rel(ko, po)
            rel_h, abs_h = _rel(kh, ph)
            check(rel_o <= tol and rel_h <= KERNEL_RTOL,
                  f"{tag} {label} on {path}: kernel vs plain out {rel_o:.3g},"
                  f" h_T {rel_h:.3g}")
            by_path[path] = dict(ms=scaled_device_ms(kern),
                                 rel=max(rel_o, rel_h), err=max(abs_o, abs_h))
        (to, th), (so, sh) = results["tile"], results["simt"]
        check(torch.equal(to, so) and torch.equal(th, sh),
              f"{tag} {label}: tile and simt differ (out "
              f"{_rel(to, so)[1]:.3g}, h_T {_rel(th, sh)[1]:.3g})")
        check(rel_ref <= tol, f"{tag} {label}: rg_lru_scan vs rg_lru_ref "
                              f"{rel_ref:.3g}")
        bound_ms, bound_by, terms = rg_lru_bound(
            _nbytes(x, a_gate, x_gate, po, a_param, h0z, ph), x.numel(), sfu)
        main = by_path[want_path]
        rec = dict(case=label, kernel="rg_lru", path=want_path,
                   dtype=str(dt)[6:], launches=1, rel_err=main["rel"],
                   max_abs_err=max(r["err"] for r in by_path.values()),
                   rel_err_ref=rel_ref, ms=main["ms"],
                   plain_ms=event_ms(plain, 1), bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None,
                   library="no single call computes it", by_path=by_path)
        times = ", ".join(f"{p} {r['ms']:.4f} ms" for p, r in by_path.items())
        print(f"{tag} {label:<21} B={b} T={t} D={d} {str(dt)[6:]}: path "
              f"{want_path}, launches 1; {times}; tile == simt bit for bit; "
              f"rel_err plain={main['rel']:.2e} ref={rel_ref:.2e} plain_ms="
              f"{rec['plain_ms']:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
              f"bytes {terms[0]:.4f}, fp32 ops {terms[1]:.4f}, SFU "
              f"{terms[2]:.4f})")
        recs.append(rec)
        del x, a_gate, x_gate, out, po, results
    return recs


def rg_lru_crossover(dev, gen):
    """[rg_lru-crossover]: every rg_lru path forced at the (B, T) of
    ``RG_LRU_CROSSOVER`` (fp32, D = 4096, device times) beside what
    ``choose_path`` picks; sets ``TILE_MIN_T``."""
    from repro_torch.kernels.rg_lru import choose_path, paths_for, rg_lru
    d = 4096
    worse = 0
    for b, t in RG_LRU_CROSSOVER:
        x, a_gate, x_gate = (torch.randn(b, t, d, generator=gen, device=dev)
                             for _ in range(3))
        a_param = torch.randn(d, generator=gen, device=dev)
        h0 = torch.randn(b, d, generator=gen, device=dev)
        ms = {p: scaled_device_ms(lambda p=p: rg_lru(
            x, a_gate, x_gate, a_param, h0, ct=t, path=p))
            for p in paths_for(d)}
        picked, best = choose_path(b, t, d), min(ms, key=ms.get)
        worse += ms[picked] > 1.03 * ms[best]
        print(f"[rg_lru-crossover] B={b} T={t:<5} D={d}: " + ", ".join(
            f"{p} {v:.4f} ms" for p, v in ms.items())
            + f"; choose_path -> {picked}, fastest {best}")
        del x, a_gate, x_gate
    print(f"[rg_lru-crossover] {worse} cases where choose_path's pick is "
          f"more than 3 % slower than the fastest path")


def phase_ops(dev):
    """[ops]: ``repro_torch.kernels.ops``'s three entry points on their
    Hopper kernels at published widths (before the model exists; every
    tensor is freed on return), the attention crossover sweep, then the
    edge sweep.  Returns the records and the edge sweep's count of
    attention calls that ``choose_path`` sent to ``"simt"``."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    recs = [ops_attention(label, *case, dev, gen)
            for label, case in OPS_ATTN_CASES.items()]
    recs += [ops_attention(label, *OPS_ATTN_CASES[label], dev, gen,
                           dtype=torch.bfloat16) for label in OPS_ATTN_BF16]
    attn_crossover(dev, gen)
    recs += ops_rg_lru(dev, gen)
    rg_lru_crossover(dev, gen)
    recs += ops_moe(dev, gen)
    simt = phase_ops_edges(dev, gen)
    print(f"[ops] phase: {time.perf_counter() - t0:.1f} s")
    return recs, simt


def phase_ops_edges(dev, gen):
    """Small ``ops`` calls at the kernels' edges, each with its exact
    launch count and against its plain version (≤ 1e-5): attention at
    every head dim of the CPU tests and 40 and 256, ragged Tq/Tk,
    bidirectional, GQA x window, decode with rep 4, ``kv_len < Tk`` with
    an explicit offset and q_period (rows with no live key), bf16 outputs,
    strided and misaligned q; ``moe_gemm`` on both kernels (each call's
    tensor-core count checked): chunks of 16, 40, 128 and 200 rows (tiles
    that would straddle a chunk), d_in 72 / d_out 200 and d_out 136
    (ragged against the tiles), d_out not a multiple of the SIMT kernel's
    128-wide tile (but of bn), bf16 output, live-row counts of 0, partial,
    full and mixed (against the plain version with and without them),
    unsorted expert ids, a misaligned bf16 x (the SIMT kernel), transposed
    weights and int64 expert ids; ``moe_apply`` in fp32 and bf16 with
    top-2 and dropped tokens against the same call on the CPU; the RG-LRU
    with T not a
    multiple of its tiles, in bf16, fp16 and mixed dtypes, at D = 37 and
    B = T = 1, each on ``choose_path``'s path by its count and on every
    path that takes it, ``"tile"`` equal to ``"simt"`` bit for bit; and
    the calls that must raise on the card (D = 12, T % ct, d_out % bn,
    fp64 RG-LRU operands)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (PATHS, choose_path,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     paths_for)
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
    from repro_torch.kernels.rg_lru import PATHS as lru_paths
    from repro_torch.kernels.rg_lru import choose_path as lru_choose
    from repro_torch.kernels.rg_lru import paths_for as lru_paths_for
    from repro_torch.kernels.rg_lru import rg_lru, rg_lru_plain

    def rnd(*shape, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dt)

    worst, count = 0.0, 0

    def held(label, got, want, tol=KERNEL_RTOL):
        nonlocal worst, count
        err = _rel(got, want)[0]
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"[ops-edges] {label}: {err:.3g} > {tol}")
        if tol == KERNEL_RTOL:
            worst = max(worst, err)
        count += 1

    attn = [(2, 128, 128, 4, 2, 64, True, None),
            (1, 64, 256, 4, 1, 64, True, None),
            (2, 128, 128, 4, 4, 64, True, 64),
            (2, 128, 128, 4, 2, 64, True, 64),      # GQA x window
            (1, 1, 96, 8, 2, 64, True, None),       # decode
            (2, 48, 48, 2, 2, 32, False, None),     # bidirectional, ragged
            (1, 32, 512, 2, 2, 128, True, 128),     # long kv + window
            (2, 1, 200, 8, 2, 128, True, None),     # decode, rep 4, ragged Tk
            (1, 40, 200, 4, 2, 256, True, 64),      # D 256, ragged
            (1, 24, 72, 2, 1, 40, False, None),     # D 40
            (4, 512, 512, 8, 8, 40, True, None),    # D 40, fills the card
            (2, 320, 320, 4, 2, 80, True, 96)]      # D 80: tc, ragged chunk
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 132
    per_path = dict.fromkeys(PATHS, 0)
    picked = dict.fromkeys(PATHS, 0)

    def on_each_path(label, q, k, v, **kw):
        """The raw kernel on every path that takes the call, each with its
        one launch on that path, against the plain version (fp32 out)."""
        full = dict(dict(window=None, q_period=None, offset=None,
                         kv_len=None), **kw)
        bq = min(full.pop("bq", 128), q.shape[1])
        bkv = min(full.pop("bkv", 128), k.shape[1])
        full["offset"] = (k.shape[1] - (q.shape[1] if full["q_period"] is None
                                        else full["q_period"])) \
            if full["offset"] is None else full["offset"]
        full["kv_len"] = k.shape[1] if full["kv_len"] is None \
            else full["kv_len"]
        want = flash_attention_plain(q, k, v, causal=True, bq=bq, bkv=bkv,
                                     out_dtype=torch.float32, **full)
        able = paths_for(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                         (q.dtype, k.dtype, v.dtype))
        for path in able:
            got = attn_call(path, lambda: flash_attention(
                q, k, v, causal=True, out_dtype=torch.float32, path=path,
                **kw), f"{label} on {path}", tag="[ops-edges]")
            held(f"{label} on {path}", got, want)
            per_path[path] += 1
        return able

    for b, tq, tk, h, hkv, d, causal, win in attn:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = rnd(b, tq, h, d, dt=dt), rnd(b, tk, hkv, d, dt=dt), \
                rnd(b, tk, hkv, d, dt=dt)
            label = f"flash_mha {(b, tq, tk, h, hkv, d, causal, win)} {dt}"
            qh, kh, vh, kw = ops.stack_heads(q, k, v)
            path = choose_path(*qh.shape[:2], kh.shape[1], d, dt, dt, dt,
                               sms=sms)
            out = attn_call(path, lambda: ops.flash_mha(
                q, k, v, causal=causal, window=win), label,
                tag="[ops-edges]")
            picked[path] += 1
            check(out.dtype == dt, f"{label}: output dtype {out.dtype}")
            held(label + " vs mha_ref", out, ref.mha_ref(
                q, k, v, causal=causal, window=win),
                KERNEL_RTOL if dt == torch.float32 else BF16_RTOL)
            for p_ in paths_for(*qh.shape[:2], kh.shape[1], d, (dt,) * 3):
                got = attn_call(p_, lambda: flash_attention(
                    qh, kh, vh, causal=causal, window=win,
                    out_dtype=torch.float32, path=p_, **kw),
                    f"{label} on {p_}", tag="[ops-edges]")
                held(f"{label} on {p_} vs plain", got, flash_attention_plain(
                    qh, kh, vh, causal=causal, window=win,
                    out_dtype=torch.float32, **kw))
                per_path[p_] += 1
    q, k, v = rnd(2, 64, 64), rnd(2, 256, 64), rnd(2, 256, 64)
    for kw in (dict(offset=-40, kv_len=200, bq=32, bkv=64),
               dict(offset=10, kv_len=100, bq=16, bkv=32, q_period=32,
                    window=20),
               dict(offset=0, kv_len=0, bq=64, bkv=128),
               dict(offset=5, kv_len=150, bq=8, bkv=16, q_period=16)):
        on_each_path(f"flash_attention {kw}", q, k, v, **kw)
    # q, k and v of mixed dtypes (each converted on load, as repro casts
    # each to fp32), and more (batch, head) rows than a grid's y axis takes
    f32, bf = torch.float32, torch.bfloat16
    for dts in ((f32, bf, bf), (bf, f32, f32), (f32, f32, bf), (bf, bf, f32)):
        qm, km, vm = (rnd(2, 128, 64, dt=dt) if i == 0 else
                      rnd(2, 256, 64, dt=dt) for i, dt in enumerate(dts))
        on_each_path(f"flash_attention mixed {dts}", qm, km, vm, bq=64,
                     bkv=64, q_period=64)
    on_each_path("flash_attention bh=70000", rnd(70000, 8, 16),
                 rnd(70000, 128, 16), rnd(70000, 128, 16), bq=8, bkv=64)
    # a strided view and a contiguous one off the 16-byte grid: the wrapper
    # copies both, as the CPU takes any layout
    wide = rnd(2, 64, 66)
    for label, qs in (("strided q", wide[:, :, 1:65]),
                      ("misaligned q", rnd(2 * 64 * 64 + 1)[1:].view(
                          2, 64, 64))):
        on_each_path(f"flash_attention {label}", qs, k, v)
    if dev.type == "cuda":     # the plain version takes any head dim
        try:
            flash_attention(rnd(1, 8, 12), rnd(1, 8, 12), rnd(1, 8, 12))
        except NotImplementedError:
            pass
        else:
            raise RuntimeError("flash_attention ran D = 12 on the card")
    print(f"[ops-edges] attention: choose_path's picks {picked}; calls "
          f"forced on each path {per_path}")

    def moe_call(label, want_tc, fn, launches=1):
        """``fn()`` with moe_gemm's counts at 0: ``launches`` launches, of
        them ``want_tc`` on the tensor-core kernel."""
        moe_gemm.tensor_core_launches = 0
        got, _ = ops_call(moe_gemm, launches, fn, label)
        check(moe_gemm.tensor_core_launches == want_tc,
              f"[ops-edges] {label}: {moe_gemm.tensor_core_launches} "
              f"tensor-core launches, expected {want_tc}")
        return got

    def live_of(kind, nc, rows):
        return {"zero": torch.zeros(nc, dtype=torch.int32, device=dev),
                "full": torch.full((nc,), rows, dtype=torch.int32,
                                   device=dev),
                "partial": torch.randint(1, rows, (nc,), generator=gen,
                                         device=dev).int(),
                "mixed": torch.tensor([0, 1, rows // 2, rows - 1, rows] * nc,
                                      dtype=torch.int32, device=dev)[:nc],
                None: None}[kind]

    bf = torch.bfloat16
    tc_calls = 0
    # bf16 x and w take the tensor-core kernel: chunks of 40 and 200 rows
    # (tiles that would straddle a chunk), d_in 72 / d_out 200 (ragged
    # against the 64 x 128 tiles, % 8 == 0), bf16 out, live_rows of 0,
    # partial, full and mixed, unsorted expert ids; fp32 or mixed operands
    # and d % 8 != 0 the SIMT kernel
    for nc, rows, din, dout, n_exp, dt, odt, kind, srt in (
            (6, 128, 96, 192, 3, bf, torch.float32, None, True),
            (6, 128, 96, 192, 3, bf, bf, None, True),
            (5, 40, 72, 200, 3, bf, torch.float32, None, True),
            (3, 200, 520, 320, 2, bf, torch.float32, None, True),
            (3, 200, 520, 320, 2, bf, bf, "mixed", True),
            (5, 40, 72, 200, 3, bf, torch.float32, "zero", True),
            (5, 40, 72, 200, 3, bf, torch.float32, "partial", False),
            (6, 128, 96, 192, 3, bf, torch.float32, "full", False),
            (7, 200, 64, 136, 4, bf, torch.float32, "mixed", False),
            (8, 16, 32, 64, 4, bf, bf, "partial", False),
            (6, 128, 96, 192, 3, bf, torch.float32, "mixed", True),
            (5, 40, 36, 60, 2, torch.float32, torch.float32, None, True),
            (8, 16, 32, 64, 4, torch.float32, torch.float32, None, True),
            (3, 200, 520, 320, 2, torch.float32, torch.float32, None, True),
            (5, 40, 72, 200, 3, torch.float32, torch.float32, "mixed",
             False),
            (4, 64, 36, 60, 2, bf, torch.float32, "partial", True)):
        x, w = rnd(nc * rows, din, dt=dt), rnd(n_exp, din, dout, dt=dt)
        ce = torch.randint(0, n_exp, (nc,), generator=gen, device=dev)
        ce = (torch.sort(ce)[0] if srt else ce).int()
        live = live_of(kind, nc, rows)
        if live is not None:   # the rows past each count are zero
            dead = torch.arange(rows, device=dev)[None, :] >= live[:, None]
            x = x.masked_fill(dead.reshape(-1, 1), 0)
        tc = dt == bf and din % 8 == 0 and dout % 8 == 0
        tc_calls += tc
        label = (f"moe_gemm {(nc, rows, din, dout)} {dt} -> {odt} "
                 f"live_rows={kind} sorted={srt}")
        got = moe_call(label, int(tc), lambda: moe_gemm(
            x, w, ce, chunk_rows=rows, out_dtype=odt, live_rows=live))
        check(got.dtype == odt, f"{label}: dtype {got.dtype}")
        tol = KERNEL_RTOL if odt == torch.float32 else BF16_RTOL
        held(label, got, moe_gemm_plain(x, w, ce, chunk_rows=rows,
                                        live_rows=live), tol)
        if live is not None:   # live_rows changes no result here
            held(label + " vs no live_rows", got,
                 moe_gemm_plain(x, w, ce, chunk_rows=rows), tol)
    # a bf16 x off the 16-byte grid takes the SIMT kernel (TMA cannot)
    x, w = rnd(6 * 128 * 96 + 1, dt=bf)[1:].view(6 * 128, 96), \
        rnd(3, 96, 192, dt=bf)
    ce = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32, device=dev)
    label = "moe_gemm misaligned bf16 x"
    got = moe_call(label, 0, lambda: moe_gemm(x, w, ce, chunk_rows=128))
    held(label, got, moe_gemm_plain(x, w, ce, chunk_rows=128))
    # transposed expert weights and int64 expert ids: copied by the wrapper
    x, w_t = rnd(4 * 32, 48), rnd(3, 80, 48).transpose(1, 2)
    ce = torch.tensor([0, 2, 2, 1], device=dev)
    label = "moe_gemm transposed w, int64 ids"
    got = moe_call(label, 0, lambda: moe_gemm(x, w_t, ce, chunk_rows=32))
    held(label, got, moe_gemm_plain(x, w_t, ce, chunk_rows=32))
    logits = torch.randn(128, 4, generator=gen, device=dev)
    for dt in (torch.float32, bf):
        x, wu, wd = rnd(128, 32, dt=dt), rnd(4, 32, 64, dt=dt), \
            rnd(4, 64, 32, dt=dt)
        for top_k, cf in ((2, 8.0), (2, 0.5), (1, 0.5)):
            label = f"moe_apply {dt} top_k={top_k} capacity={cf}"
            tc = 2 * top_k if dt == bf else 0
            tc_calls += tc
            got = moe_call(label, tc, lambda: ops.moe_apply(
                x, wu, wd, logits, top_k=top_k, chunk_rows=16,
                capacity_factor=cf), 2 * top_k)
            held(label + " vs the CPU", got.cpu(), ops.moe_apply(
                x.cpu(), wu.cpu(), wd.cpu(), logits.cpu(), top_k=top_k,
                chunk_rows=16, capacity_factor=cf),
                KERNEL_RTOL if dt == torch.float32 else BF16_RTOL)
    try:
        moe_gemm(rnd(128, 32), rnd(2, 32, 768), torch.zeros(
            1, dtype=torch.int32, device=dev), chunk_rows=128)
    except ValueError:
        pass
    else:
        raise RuntimeError("moe_gemm took d_out=768 with bn=512 on the card")

    # the RG-LRU: each call on choose_path's path by that path's count, then
    # on every path that takes it, each against the plain version and the
    # two paths against each other bit for bit: T not a multiple of the
    # tile's steps, bf16, D = 37 (simt only: 148-byte rows), T = 37 at D =
    # 4096, fp16, mixed dtypes (bf16 x, fp32 a_gate, fp16 x_gate), B = 1
    # with T = 1, a D that is not a multiple of the tile's channels
    f16 = torch.float16
    lru_picked = dict.fromkeys(lru_paths, 0)
    for b, t, d, dts, ct in ((2, 37, 48, (f32,) * 3, 128),
                             (2, 7, 40, (bf,) * 3, 128),
                             (3, 96, 32, (f32,) * 3, 16),
                             (1, 40, 4096, (bf,) * 3, 8),
                             (2, 200, 37, (f32,) * 3, 8),
                             (2, 37, 4096, (f32,) * 3, 37),
                             (2, 300, 4096, (f16,) * 3, 100),
                             (2, 300, 4096, (bf, f32, f16), 100),
                             (1, 1, 4096, (f32,) * 3, 128),
                             (3, 129, 36, (f32,) * 3, 43)):
        x, ag, xg = (rnd(b, t, d, dt=dt) for dt in dts)
        ap, h0 = rnd(d), rnd(b, d)
        label = f"rg_lru_scan {(b, t, d)} {dts} ct={ct}"
        path = lru_choose(b, t, d, *dts)
        lru_picked[path] += 1
        out, h_t = lru_call(path, lambda: ops.rg_lru_scan(
            x, ag, xg, ap, h0, ct=ct), label, tag="[ops-edges]")
        check(out.dtype == dts[0], f"[ops-edges] {label}: out {out.dtype}")
        po, ph = rg_lru_plain(x, ag, xg, ap, h0)
        tol = KERNEL_RTOL if dts[0] == f32 else BF16_RTOL
        held(label + " h_T", h_t, ph)
        held(label + " out", out, po, tol)
        forced = {}
        for p_ in lru_paths_for(d, dts):
            forced[p_] = lru_call(p_, lambda: rg_lru(
                x, ag, xg, ap, h0, ct=ct, path=p_), f"{label} on {p_}",
                tag="[ops-edges]")
            held(f"{label} on {p_} h_T", forced[p_][1], ph)
            held(f"{label} on {p_} out", forced[p_][0], po, tol)
        if len(forced) == 2:
            (to, th), (so, sh) = forced["tile"], forced["simt"]
            check(torch.equal(to, so) and torch.equal(th, sh),
                  f"[ops-edges] {label}: tile and simt differ")
    try:
        ops.rg_lru_scan(rnd(1, 200, 8), rnd(1, 200, 8), rnd(1, 200, 8),
                        rnd(8), ct=128)
    except ValueError:
        pass
    else:
        raise RuntimeError("rg_lru took T=200 with ct=128 on the card")
    if dev.type == "cuda":     # the plain version takes fp64
        x64 = rnd(1, 8, 8).double()
        try:
            rg_lru(x64, x64, x64, rnd(8), rnd(1, 8))
        except NotImplementedError:
            pass
        else:
            raise RuntimeError("rg_lru took fp64 operands on the card")
    print(f"[ops-edges] rg_lru: choose_path's picks {lru_picked}, every call "
          f"also forced on each path that takes it, tile == simt bit for "
          f"bit")
    print(f"[ops-edges] {count} checks, each call with its exact launch "
          f"count ({tc_calls} moe_gemm launches on the tensor-core kernel, "
          f"the misaligned bf16 x on the SIMT one), fp32 results within "
          f"{KERNEL_RTOL} of the plain version or the oracle (worst "
          f"{worst:.2e}), bf16 and fp16 outputs within {BF16_RTOL}; D=12, "
          f"T % ct, d_out % bn and fp64 RG-LRU operands raise")
    return picked["simt"]


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
    spmm = [e for e in kernels if "segment_spmm" in e.key]
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, device idle share "
          f"{1 - busy / wall_us:.3f}, {sum(e.count for e in events)} ops; "
          f"Segment SpMM kernels {sum(dev_us(e) for e in spmm) / 1e3:.3f} ms "
          f"over {sum(e.count for e in spmm)} launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[profile]   device {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5} "
              f"{e.key[:150]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms  "
              f"x{e.count:<5} {e.key[:150]}")
    return 1 - busy / wall_us


def phase_profile(model, engine, dev, label="decode step"):
    """One batched decode step under torch.profiler: where its time goes.
    Returns the device idle share."""
    tok = torch.randint(0, model.cfg.vocab, (engine.slots, 1), device=dev)
    pos = torch.tensor([30, 41, 52, 63], device=dev)[:engine.slots]
    cache = {k: v.clone() for k, v in engine.cache.items()}
    with torch.inference_mode():
        model.decode_step(cache, tok, pos)
        return profile_once(label,
                            lambda: model.decode_step(cache, tok, pos))


def sparse_layers(model):
    """The layers whose FFN is block-sparse (each runs 3 SpMM launches a
    model call): all of granite's, the local ones of the hybrid, the
    encoder's and the decoder's of an encoder-decoder model."""
    from repro_torch.models import SparseMLP
    return sum(isinstance(getattr(blk, "mlp", None), SparseMLP)
               for blk in list(model.enc or ()) + list(model.layers))


def steady_decode(model, rng, slots=4, steps=32, tag="steady"):
    """Decode with every slot live: ``slots`` equal requests are admitted
    (prefill, not timed), then ``steps`` batched decode steps are timed
    one by one (each ends in the host's read of the next tokens).  Returns
    the median ms/step and the kernel launches (all, quantized) per step,
    which must be the same in every step."""
    from repro_torch.kernels.segment_spmm import segment_spmm
    from repro_torch.runtime import Engine, Request
    n_sparse = sparse_layers(model)

    engine = Engine(model, slots=slots, max_len=256, prefill_buckets=(64, 16))
    for _ in range(slots):
        engine.submit(Request(prompt=rng.integers(0, model.cfg.vocab, 32),
                              max_new_tokens=steps + 1))
    engine.admit_pending()
    ms = []
    segment_spmm.launches = segment_spmm.quantized_launches = 0
    segment_spmm.split_launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        live = engine.step()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(live == slots, f"steady decode: {live} of {slots} slots live")
    per_step = (segment_spmm.launches / steps,
                segment_spmm.quantized_launches / steps,
                segment_spmm.split_launches / steps)
    check(per_step[0] == 3 * n_sparse,
          f"{tag}: {per_step[0]} launches per decode step, expected 3 x "
          f"{n_sparse}")
    check(per_step[2] == per_step[0],
          f"{tag}: {per_step[2]} of {per_step[0]} launches per decode step "
          f"on the split path")
    med = float(np.median(ms))
    print(f"[{tag}] {steps} decode steps, all {slots} slots live: median "
          f"{med:.2f} ms/step (min {min(ms):.2f}, max {max(ms):.2f}), "
          f"{slots * 1e3 / med:.1f} tok/s; segment_spmm launches per step "
          f"{per_step[0]:.0f} ({per_step[1]:.0f} quantized, "
          f"{per_step[2]:.0f} on the split path)")
    return med, per_step


def serve_mix(engine, prompts, tag):
    """The smoke's request mix through ``engine``, prefill and decode timed
    apart; every request must get its 8 tokens and the kernel's launch
    count must be 3 projections × sparse-FFN layers × model calls.
    Returns the requests and the launch counts (all, quantized, split)."""
    from repro_torch.kernels.segment_spmm import segment_spmm
    from repro_torch.runtime import Request

    n_sparse = sparse_layers(engine.model)
    reqs = [Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
    for r in reqs:
        engine.submit(r)
    t_prefill = t_decode = 0.0
    decode_tokens = 0
    torch.cuda.synchronize()
    segment_spmm.launches = segment_spmm.quantized_launches = 0
    segment_spmm.split_launches = segment_spmm.tensor_core_launches = 0
    decode_launches = decode_split = 0
    while True:
        t0 = time.perf_counter()
        engine.admit_pending()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = (segment_spmm.launches, segment_spmm.split_launches)
        live = engine.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        decode_launches += segment_spmm.launches - counts[0]
        decode_split += segment_spmm.split_launches - counts[1]
        if not live:
            break
        t_prefill += t1 - t0
        t_decode += t2 - t1
        decode_tokens += live
    launches = segment_spmm.launches
    quantized = segment_spmm.quantized_launches
    split = segment_spmm.split_launches
    tc = segment_spmm.tensor_core_launches
    calls = engine.decode_calls + engine.prefill_calls
    for r in reqs:
        check(r.out_tokens is not None and r.out_tokens.size == 8,
              f"{tag}: request {r.rid} got {r.out_tokens}")
    want = 3 * n_sparse * calls
    check(launches == want, f"{tag}: kernel launches {launches} != 3 x "
                            f"{n_sparse} x {calls} model calls")
    check(decode_split == decode_launches == 3 * n_sparse
          * engine.decode_calls, f"{tag}: {decode_split} of "
                                 f"{decode_launches} decode launches on the "
                                 f"split path")
    prompt_tokens = sum(r.prompt.size for r in reqs)
    print(f"[{tag}] {len(reqs)} requests, {prompt_tokens} prompt tokens, "
          f"{decode_tokens} decoded; model calls {calls} "
          f"({engine.prefill_calls} prefill chunks, {engine.decode_calls} "
          f"decode steps); segment_spmm launches {launches} == 3 x "
          f"{n_sparse} x {calls} ({quantized} quantized; paths: "
          f"{split} split, all {decode_launches} of the decode steps among "
          f"them, {tc} tensor cores, {launches - split - tc} simt); step "
          f"shapes {engine.compiled_shapes}")
    print(f"[{tag}] this request mix: prefill "
          f"{prompt_tokens / t_prefill:.1f} tok/s ({t_prefill:.3f} s); "
          f"decode {decode_tokens} tokens in {engine.decode_calls} steps "
          f"({decode_tokens / engine.decode_calls:.2f} live slots per step, "
          f"ramp-down included), "
          f"{1e3 * t_decode / engine.decode_calls:.2f} ms/step, "
          f"{decode_tokens / t_decode:.1f} tok/s")
    return reqs, launches, quantized, split


def decode_logits_check(model, engine, dev, rng, tag):
    """One decode step from the engine's cache on the ``"cuda"`` and the
    ``"reference"`` backends: finite, of the right shape, within
    ``LOGIT_RTOL``."""
    from repro_torch.api import use_backend

    cfg = model.cfg
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).to(dev)
    pos = torch.tensor([40, 51, 62, 73], device=dev)
    logits = {}
    with torch.inference_mode():
        for backend in ("cuda", "reference"):
            cache = {k: v.clone() for k, v in engine.cache.items()}
            with use_backend(backend):
                logits[backend], _ = model.decode_step(cache, tok, pos)
    got, want = logits["cuda"].float(), logits["reference"].float()
    check(got.shape == (4, cfg.padded_vocab),
          f"{tag}: logits shape {got.shape}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite logits")
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[{tag}] decode logits cuda vs reference: rel_err {rel:.3e} "
          f"(tol {LOGIT_RTOL}), top-1 agreement {top1:.2f}")
    check(rel <= LOGIT_RTOL, f"{tag}: logits rel err {rel} > {LOGIT_RTOL}")


def phase_serve(model, dev):
    """The fp32 engine on the smoke's mix.  Returns the launch count, the
    prompts and their greedy tokens."""
    from repro_torch.runtime import Engine, Request

    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    # warm-up on its own engine (cuBLAS handles, allocator), not counted
    Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16)).generate(
        [Request(prompt=rng.integers(0, cfg.vocab, 20), max_new_tokens=2)])
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(5, 61)))
               for _ in range(6)]
    engine = Engine(model, slots=4, max_len=256, prefill_buckets=(64, 16))
    reqs, launches, _, split = serve_mix(engine, prompts, "serve")
    decode_logits_check(model, engine, dev, rng, "serve")
    phase_profile(model, engine, dev)
    steady_decode(model, rng)
    return launches, split, prompts, [r.out_tokens for r in reqs]


def phase_qserve(model, dev, prompts, fp32_tokens):
    """Quantized serving at full width: ``Engine(model, quantize=mode)``
    for int8 and fp8 on the serve phase's prompts, then an int8 engine over
    an int8 KV cache.  Returns the quantized launches of the three request
    mixes, those of them on the split path, and a summary per engine."""
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine

    rng = np.random.default_rng(SEED + 4)
    total, total_split, summary = 0, 0, {}
    for mode in QSERVE_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = Engine(model, quantize=mode, slots=4, max_len=256,
                        prefill_buckets=(64, 16))
        setup_s = time.perf_counter() - t0
        qmodel = engine.model
        tag = f"qserve {mode}"
        reqs, launches, quantized, split = serve_mix(engine, prompts, tag)
        check(quantized == launches, f"{tag}: {quantized} of {launches} "
                                     f"launches quantized")
        total += quantized
        total_split += split
        got = [r.out_tokens for r in reqs]
        n_tok = sum(t.size for t in fp32_tokens)
        drift = sum(int((a != b).sum()) for a, b in zip(got, fp32_tokens))
        print(f"[{tag}] quantized in {setup_s:.1f} s; greedy drift vs the "
              f"fp32 engine {drift}/{n_tok} = {drift / n_tok:.3f} (bound "
              f"{DRIFT_BOUND[mode]})")
        check(drift / n_tok <= DRIFT_BOUND[mode],
              f"{tag}: drift {drift}/{n_tok} > {DRIFT_BOUND[mode]}")
        decode_logits_check(qmodel, engine, dev, rng, tag)
        idle = phase_profile(qmodel, engine, dev, label=f"{tag} decode step")
        med, per_step = steady_decode(qmodel, rng, tag=f"{tag} steady")
        check(per_step[1] == per_step[0],
              f"{tag}: {per_step[1]} of {per_step[0]} launches per decode "
              f"step quantized")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{tag}] summary: steady {med:.2f} ms/step, device idle "
              f"share {idle:.3f}, {per_step[1]:.0f} quantized launches per "
              f"decode step, peak {peak:.2f} GiB")
        summary[mode] = dict(ms_per_step=med, idle=idle, peak_gib=peak,
                             per_step=per_step[1], drift=drift / n_tok)
        del engine, qmodel, reqs

    # int8 weights over an int8 KV cache: the same weights (and the same
    # seeded FFN patterns) in a model built with kv_cache_dtype="int8"
    model8 = build_model(
        dataclasses.replace(model.cfg, kv_cache_dtype="int8"), device=dev)
    model8.load_state_dict(model.state_dict())
    engine = Engine(model8, quantize="int8", slots=4, max_len=256,
                    prefill_buckets=(64, 16))
    tag = "qserve int8 + int8 KV"
    check(max(engine.prefill_buckets) <= 8,
          f"{tag}: prefill buckets {engine.prefill_buckets}")
    reqs, launches, quantized, split = serve_mix(engine, prompts, tag)
    check(quantized == launches, f"{tag}: {quantized} of {launches} "
                                 f"launches quantized")
    total += quantized
    total_split += split
    decode_logits_check(engine.model, engine, dev, rng, tag)
    del engine, model8, reqs
    return total, total_split, summary


def phase_qgrad(model, dev):
    """x-gradients through the int8 model: one loss and backward pass on
    1 x ``QGRAD_SEQ`` tokens, so each quantized layer's dx runs the
    ``transpose_lhs`` mode on its payload; loss and gradients against the
    reference backend.  Returns the transposed quantized launches."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.segment_spmm import segment_spmm

    qmodel = model.quantize("int8")
    cfg = qmodel.cfg
    shape = ShapeConfig("qgrad", "train", QGRAD_SEQ, 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 5).batch(0).items()}
    fwd = 3 * cfg.n_layers * (2 if cfg.remat else 1)
    picked = ["layers.0.attn.wq.w", f"layers.{cfg.n_layers - 1}.attn.wo.w",
              "layers.0.norm2.scale"]
    seen = {}
    for backend in ("cuda", "reference"):
        segment_spmm.launches = segment_spmm.transposed_launches = 0
        segment_spmm.quantized_launches = segment_spmm.split_launches = 0
        segment_spmm.tensor_core_launches = 0
        loss, grads = _grads_on(qmodel, batch, backend)
        if backend == "cuda":
            paths = (segment_spmm.tensor_core_launches,
                     segment_spmm.split_launches)
            launches = (segment_spmm.launches,
                        segment_spmm.transposed_launches,
                        segment_spmm.quantized_launches)
            want = (fwd + 3 * cfg.n_layers, 3 * cfg.n_layers,
                    fwd + 3 * cfg.n_layers)
            check(launches == want, f"qgrad launches (all, transposed, "
                                    f"quantized) {launches} != {want}")
        check(not any(".mlp." in k for k in grads),
              "a quantized payload got a gradient")
        seen[backend] = (loss, {k: grads[k].clone() for k in picked})
        del grads
    (l_cuda, g_cuda), (l_ref, g_ref) = seen["cuda"], seen["reference"]
    loss_err = abs(l_cuda - l_ref) / abs(l_ref)
    errs = {k: float(torch.linalg.vector_norm(g_cuda[k] - g_ref[k])
                     / torch.linalg.vector_norm(g_ref[k])) for k in picked}
    print(f"[qgrad] int8 model, 1 x {QGRAD_SEQ} tokens: loss {l_cuda:.5f} "
          f"(vs reference {loss_err:.3e}, tol {LOSS_RTOL}); segment_spmm "
          f"launches {launches[0]} ({launches[1]} transposed, {launches[2]} "
          f"quantized; {paths[0]} on the tensor cores, {paths[1]} on the "
          f"split path); gradients (norm-relative, tol {GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(loss_err <= LOSS_RTOL, f"qgrad loss cuda vs reference {loss_err}")
    for k, v in errs.items():
        check(v <= GRAD_RTOL, f"qgrad {k} gradient cuda vs reference {v:.3g}")
    del qmodel, seen
    return launches[1]


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
        segment_spmm.tensor_core_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _grads_on(model, batch, backend)
        ms = (time.perf_counter() - t0) * 1e3
        if backend == "cuda":
            check(segment_spmm.launches == per_step
                  and segment_spmm.transposed_launches == per_step // 3
                  and segment_spmm.tensor_core_launches == per_step,
                  f"gradient step launches {segment_spmm.launches} "
                  f"({segment_spmm.transposed_launches} transposed, "
                  f"{segment_spmm.tensor_core_launches} on the tensor "
                  f"cores) != {per_step} ({per_step // 3}, {per_step})")
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
    segment_spmm.tensor_core_launches = 0
    out = trainer.run()
    launches = segment_spmm.launches
    transposed = segment_spmm.transposed_launches
    tc = segment_spmm.tensor_core_launches
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
          and transposed == per_step // 3 * TRAIN_STEPS
          and tc == launches,
          f"training launches {launches} ({transposed} transposed, {tc} on "
          f"the tensor cores) != {per_step} x {TRAIN_STEPS} ({per_step // 3}"
          f" x {TRAIN_STEPS}, all)")
    steady = float(np.median([h["ms"] for h in out["history"][1:]]))
    print(f"[train] {cfg.name} full width, {cfg.n_layers} layers, remat "
          f"{cfg.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} "
          f"steps, median of steps 1..{TRAIN_STEPS - 1} {steady:.1f} ms/step "
          f"({tokens * 1e3 / steady:.0f} tokens/s); segment_spmm launches "
          f"{launches} == {per_step} x {TRAIN_STEPS} ({transposed} "
          f"transposed), all {tc} on the tensor cores; peak "
          f"{peak / 2**30:.2f} GiB")

    # (c) one more step under the profiler
    step_fn = make_train_step(model, trainer.opt, 1)
    nxt = {k: torch.from_numpy(v).to(dev)
           for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    profile_once("training step", lambda: step_fn(trainer.opt_state, nxt))
    return launches, transposed


def _zero_counts():
    """Every launch count of the hybrid's kernels (forward and backward) set
    to 0."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rg_lru import rg_lru, rg_lru_bwd
    from repro_torch.kernels.segment_spmm import segment_spmm
    torch.cuda.synchronize()
    for kernel, names in ((rg_lru, ("launches", "tile_launches",
                                    "simt_launches")),
                          (rg_lru_bwd, ("launches", "tile_launches",
                                        "simt_launches")),
                          (flash_attention, ("launches", "splitkv_launches",
                                             "tc_launches", "simt_launches")),
                          (flash_attention_bwd, ("launches", "tc_launches",
                                                 "simt_launches")),
                          (segment_spmm, ("launches", "split_launches",
                                          "tensor_core_launches",
                                          "quantized_launches",
                                          "transposed_launches"))):
        for n in names:
            setattr(kernel, n, 0)


def _counts():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rg_lru import rg_lru, rg_lru_bwd
    from repro_torch.kernels.segment_spmm import segment_spmm
    torch.cuda.synchronize()
    return dict(rg_lru=rg_lru.launches, rg_lru_tile=rg_lru.tile_launches,
                rg_lru_simt=rg_lru.simt_launches,
                rg_lru_bwd=rg_lru_bwd.launches,
                rg_lru_bwd_tile=rg_lru_bwd.tile_launches,
                rg_lru_bwd_simt=rg_lru_bwd.simt_launches,
                flash=flash_attention.launches,
                flash_tc=flash_attention.tc_launches,
                flash_bwd=flash_attention_bwd.launches,
                flash_bwd_tc=flash_attention_bwd.tc_launches,
                flash_bwd_simt=flash_attention_bwd.simt_launches,
                spmm=segment_spmm.launches,
                spmm_split=segment_spmm.split_launches,
                spmm_tc=segment_spmm.tensor_core_launches,
                spmm_t=segment_spmm.transposed_launches)


def phase_hybrid(dev, replan=False):
    """[hybrid]: RecurrentGemma-9B at full published width (38 layers: 26
    RG-LRU blocks with dense SwiGLU, 12 local-attention blocks with the
    block-sparse FFN; bf16 activations, random weights from ``SEED``).
    Serves the smoke's request mix (every RG-LRU launch on ``simt``, every
    SpMM launch on the split path, no flash_attention), holds a decode
    step's logits against the reference backend, profiles one, times 32
    steady 4-slot steps; holds rg_lru and flash_attention against their
    plain versions at the shapes the model gives them; runs ``forward`` on
    1 x ``HYBRID_FORWARD_T`` tokens (``tile``, ``tc``, tensor-core SpMM);
    checks forward against stepwise decode over ``HYBRID_CACHE_T`` tokens.
    Returns the launch counts and the kernel records."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              ffn_block_sparse=True, ffn_block=64,
                              ffn_density=0.25, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    kinds = model.layer_kinds
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    n_sparse = sparse_layers(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[hybrid] {cfg.name} full width: {cfg.n_layers} layers ({n_rec} "
          f"rec, {n_local} local, window {cfg.local_window}), d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads / {cfg.n_kv} "
          f"KV, head_dim {cfg.hd}, vocab {cfg.vocab}; {n_sparse} sparse "
          f"FFNs; {n_params / 1e9:.3f} B fp32 params; built and planned in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(n_sparse == n_local, f"[hybrid] {n_sparse} sparse FFNs")
    if replan:      # [verify]'s re-plan of the sparse FFNs' plans
        verify_replan(model, dev, "[verify hybrid]")

    # 1. serving: one token a prefill call (recurrent state), the ring cache
    s = serve_family(model, dev, "hybrid")
    check(s["buckets"] == (1,), f"[hybrid] prefill buckets {s['buckets']}")
    got, calls = s["counts"], s["calls"]
    check(got["rg_lru"] == got["rg_lru_simt"] == n_rec * calls
          and got["flash"] == 0
          and s["split"] == s["spmm"] == 3 * n_sparse * calls,
          f"[hybrid serve] launches {got}, expected rg_lru {n_rec} x {calls} "
          f"all on simt, segment_spmm 3 x {n_sparse} x {calls} all split, "
          f"no flash_attention")
    serve_lru = got["rg_lru"]
    print(f"[hybrid serve] rg_lru launches {serve_lru} == {n_rec} x {calls} "
          f"model calls, all on simt; flash_attention none (the ring cache's "
          f"attention is torch)")
    med, idle = s["steady_ms"], s["idle"]
    serve_peak = torch.cuda.max_memory_allocated() / 2**30

    # 2. the kernels against their plain versions at the model's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    recs = ops_rg_lru(dev, gen, HYBRID_RG_LRU_CASES, tag="[hybrid]")
    recs.append(ops_attention(
        "local forward", "recurrentgemma-9b", 1, HYBRID_FORWARD_T,
        HYBRID_FORWARD_T, "local", "tc", dev, gen, dtype=torch.bfloat16,
        prefix="[hybrid]"))

    # 3. forward over twice the window
    tokens = torch.randint(0, cfg.vocab, (1, HYBRID_FORWARD_T),
                           generator=gen, device=dev)
    fwd, fwd_ms, fwd_peak, _ = timed_forward(
        model, "hybrid", {"rg_lru": n_rec, "rg_lru_tile": n_rec,
                          "flash": n_local, "flash_tc": n_local,
                          "spmm": 3 * n_sparse, "spmm_tc": 3 * n_sparse},
        tokens)

    # 4. the caches: forward's last logits vs stepwise decode (simt, ring
    # attention)
    stepwise_check(model, tokens[:, :HYBRID_CACHE_T], "hybrid")
    print(f"[hybrid] summary: steady {med:.2f} ms/step, device idle share "
          f"{idle:.3f}, serving peak {serve_peak:.2f} GiB; forward "
          f"{fwd_ms:.2f} ms, peak {fwd_peak:.2f} GiB")
    return serve_lru, fwd, recs


# [hybrid_train]: RecurrentGemma-9B trained at full width with its depth
# cut 38 -> HYBRID_TRAIN_LAYERS (two (rec, rec, local) units): 38 layers of
# fp32 parameters, gradients and AdamW moments (~129 GB) do not fit one
# card, 6 (2.1 B parameters) take ~34 GB.  Batches of 1 x HYBRID_TRAIN_T
# tokens, twice the window, so the backward pass's window mask bites.
HYBRID_TRAIN_LAYERS = 6
HYBRID_TRAIN_T = 4096
HYBRID_TRAIN_STEPS = 3
# the backward kernels against their plain versions, D = d_model: the
# RG-LRU at the model's (1, 4096, 4096) bf16 call, a (4, 2048, 4096) fp32
# one and a short one whose T is not a multiple of a tile's 64 steps (both
# paths take every T), (batch, T, dtype); the attention at the local block's 1 x 4096
# call (16 heads on one KV head, D = 256, window 2048) in bf16, as the
# model runs it, and in fp32, and small ragged calls (padded stacked rows
# and keys), (batch, T, heads, KV heads, D, window, dtype): every case on
# every path that takes it (the fp32 D = 40 one only on simt)
HYBRID_BWD_RG_LRU_CASES = {
    "rg_lru bwd 1x4096 bf16": (1, HYBRID_TRAIN_T, torch.bfloat16),
    "rg_lru bwd 4x2048 fp32": (4, 2048, torch.float32),
    "rg_lru bwd 4x100 bf16": (4, 100, torch.bfloat16),
}
# a bf16 attention backward's error (Frobenius, against the plain version)
# is held below this share of a control's that takes P and dS as one bf16
# part (flash_attention_bwd_plain(p_dtype=bf16), the function of a bf16
# SDPA): BF16_RTOL alone would pass a kernel that drops their lo parts
ONE_PART_SHARE = 0.5
HYBRID_BWD_ATTN_CASES = {
    "local bwd 1x4096 bf16": (1, HYBRID_TRAIN_T, 16, 1, 256, 2048,
                              torch.bfloat16),
    "local bwd 1x4096 fp32": (1, HYBRID_TRAIN_T, 16, 1, 256, 2048,
                              torch.float32),
    "ragged bwd bf16": (2, 200, 4, 2, 64, 64, torch.bfloat16),
    "ragged bwd fp32": (2, 200, 4, 2, 40, 64, torch.float32),
}


def rg_lru_bwd_case(label, b, t, dt, dev, gen, sfu):
    """One ``rg_lru_bwd`` call at RecurrentGemma-9B's width on the forward's
    fp32 h (the forward run with x in fp32, as the autograd Function runs
    it), on every path that takes it: one launch by that path's own count,
    every output against ``rg_lru_bwd_plain`` (``KERNEL_RTOL`` for fp32
    outputs, ``BF16_RTOL`` for bf16 ones), ``tile`` against ``simt`` bit for
    bit (``da_param``, the same sum in another order, within 1e-6), each
    path's time, the plain version's, and the bound (bytes; the forward's
    SFU operations an element, which the backward recomputes).  The record
    is ``choose_bwd_path``'s path's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rg_lru import (choose_bwd_path, paths_for,
                                            rg_lru, rg_lru_bwd,
                                            rg_lru_bwd_plain)
    d = get_config("recurrentgemma-9b").d_model
    x, a_gate, x_gate = (torch.randn(b, t, d, generator=gen,
                                     device=dev).to(dt) for _ in range(3))
    a_param = torch.randn(d, generator=gen, device=dev)
    h0 = torch.randn(b, d, generator=gen, device=dev)
    with torch.no_grad():
        hs, _ = rg_lru(x.float(), a_gate, x_gate, a_param, h0, ct=t)
    dout = torch.randn(b, t, d, generator=gen, device=dev).to(dt)
    dh_t = torch.randn(b, d, generator=gen, device=dev)
    args = (x, a_gate, x_gate, a_param, h0, hs, dout, dh_t)
    want = rg_lru_bwd_plain(*args)
    names = ("dx", "da_gate", "dx_gate", "da_param", "dh0")
    by_path, outs = {}, {}
    for path in paths_for(d, (dt,) * 3):
        torch.cuda.synchronize()
        for n in ("launches", "tile_launches", "simt_launches"):
            setattr(rg_lru_bwd, n, 0)
        got = rg_lru_bwd(*args, path=path)
        torch.cuda.synchronize()
        counts = [getattr(rg_lru_bwd, n)
                  for n in ("launches", "tile_launches", "simt_launches")]
        check(counts == [1, int(path == "tile"), int(path == "simt")],
              f"[hybrid_train] {label} on {path}: rg_lru_bwd launches (all, "
              f"tile, simt) {counts}")
        errs = []
        for name, g, w in zip(names, got, want):
            rel, diff = _rel(g, w)
            tol = KERNEL_RTOL if g.dtype == torch.float32 else BF16_RTOL
            check(g.dtype == w.dtype and bool(torch.isfinite(g).all())
                  and rel <= tol, f"[hybrid_train] {label} on {path}: "
                                  f"{name} kernel vs plain {rel:.3g} > {tol}")
            errs.append((name, rel, diff))
        outs[path] = got
        by_path[path] = dict(errs=errs, ms=scaled_device_ms(
            lambda path=path: rg_lru_bwd(*args, path=path)))
    same = ""
    if "tile" in outs and "simt" in outs:
        for i, name in enumerate(names):
            if name == "da_param":
                rel, _ = _rel(outs["tile"][i], outs["simt"][i])
                check(rel <= 1e-6, f"[hybrid_train] {label}: da_param tile "
                                   f"vs simt {rel:.3g} > 1e-6")
                same += f"; da_param tile vs simt {rel:.2e}"
            else:
                check(torch.equal(outs["tile"][i], outs["simt"][i]),
                      f"[hybrid_train] {label}: {name} on tile differs "
                      f"from simt")
        same = "; dx, da_gate, dx_gate, dh0 tile == simt bit for bit" + same
    del outs
    main = choose_bwd_path(d, (dt,) * 3)
    plain_ms = event_ms(lambda: rg_lru_bwd_plain(*args), 1)
    bound_ms, bound_by, terms = rg_lru_bound(
        _nbytes(x, a_gate, x_gate, dout, hs, h0, dh_t, a_param, *want),
        x.numel(), sfu)
    times = "; ".join(f"{p} {r['ms']:.4f} ms (" + ", ".join(
        f"{n} {e:.2e}" for n, e, _ in r["errs"]) + " vs plain)"
        for p, r in by_path.items())
    print(f"[hybrid_train] {label:<22} B={b} T={t} D={d}: path {main}; "
          f"{times}{same}; plain_ms={plain_ms:.4f}, bound_ms={bound_ms:.4f} "
          f"({bound_by}; bytes {terms[0]:.4f}, fp32 ops {terms[1]:.4f}, SFU "
          f"{terms[2]:.4f}); no single library call")
    mine = by_path[main]
    return dict(case=label, kernel="rg_lru_bwd", path=main,
                dtype=str(dt)[6:], launches=1,
                rel_err=max(r for _, r, _ in mine["errs"]),
                max_abs_err=max(a for _, _, a in mine["errs"]),
                ms=mine["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                library="no single call computes it", by_path=by_path)


def attn_bwd_bound(path, nbytes, pairs, d, dt):
    """The least time of an attention backward call: the bytes moved once,
    and the function's five products (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO,
    dK = dSᵀ Q, dQ = dS K; 2 D operations a pair each) over the live
    (query, key) pairs at the peak of the path's arithmetic.  ``simt``: in
    fp32 on the CUDA cores.  ``tc``: as bf16 products at 989 TFLOP/s, at
    the precision the function needs there (:func:`attn_bwd_passes`): 16 D
    operations a pair for bf16 operands, 60 D for fp32.  What the kernel
    repeats (S and dP in each dK/dV column group and again in the dQ pass)
    is its overhead against this bound, not part of it."""
    if path != "tc":
        return _bound(nbytes, 10 * d * pairs)
    need, _ = attn_bwd_passes(d, dt)
    return _bound(nbytes, 2 * d * pairs * need, BF16_FLOPS)


def attn_bwd_passes(d, dt):
    """bf16 products a live pair, ``(the function's, the tc kernel's)``.
    The function's: S and dP take the split's passes of the operands (one
    for bf16, six for fp32: ``tc_passes``), dV, dK and dQ those of P's or
    dS's parts (two for bf16 calls, three for fp32) with the operand's.
    The kernel's (``bwd_tc_layout``): S and dP once in each dK/dV column
    group and once more in the dQ pass, which recomputes them."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    lay = fa.bwd_tc_layout(d, (dt,) * 4)
    n_s = len(fa.tc_passes(lay["parts"], lay["parts"]))
    n_o = len(fa.tc_passes(lay["p_parts"], lay["parts"]))
    return 2 * n_s + 3 * n_o, 2 * n_s * (lay["groups"] + 1) + 3 * n_o


def attn_bwd_case(label, b, t, h, hkv, d, window, dt, dev, gen):
    """One attention backward at the stacked shapes ``flash_mha`` gives the
    kernel (causal, ``window``): the forward kernel on the path
    ``choose_path`` picks, writing its row statistics (held against the
    plain forward's, ≤ ``KERNEL_RTOL``); ``flash_attention_bwd`` on every
    path that can take the call, one launch each by that path's own count,
    dq, dk, dv against ``flash_attention_bwd_plain`` (``KERNEL_RTOL`` in
    fp32, ``BF16_RTOL`` in bf16; in bf16 also below ``ONE_PART_SHARE`` of
    a one-part-P control's error) and a second call bit for bit, each path
    timed beside its bound; the plain version's time and, as yardsticks,
    one ``scaled_dot_product_attention`` forward and backward with a
    boolean window mask in fp32 (the same function: ``library_ms``) and,
    for bf16 calls, in bf16 (P in bf16: not the same function).  The
    record is ``choose_bwd_path``'s path's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = (torch.randn(b, t, h, d, generator=gen, device=dev) * 0.5).to(dt)
    k = (torch.randn(b, t, hkv, d, generator=gen, device=dev) * 0.5).to(dt)
    v = (torch.randn(b, t, hkv, d, generator=gen, device=dev) * 0.5).to(dt)
    qh, kh, vh, kw = ops.stack_heads(q, k, v)
    kw.update(causal=True, window=window)
    with torch.no_grad():
        out, stats = fa._forward(qh, kh, vh, kw, dt, None, stats=True)
        _, want_stats = fa.flash_attention_plain(
            qh, kh, vh, out_dtype=torch.float32, stats=True, **kw)
    rel_m, _ = _rel(stats[..., 0], want_stats[..., 0])
    rel_l, _ = _rel(stats[..., 1], want_stats[..., 1])
    check(rel_m <= KERNEL_RTOL and rel_l <= KERNEL_RTOL,
          f"[hybrid_train] {label}: forward row statistics vs plain m "
          f"{rel_m:.3g}, l {rel_l:.3g}")
    dout = (torch.randn(out.shape, generator=gen, device=dev)).to(dt)
    args = (qh, kh, vh, out, dout, stats)

    def plain():
        return fa.flash_attention_bwd_plain(*args, **kw)

    want = plain()
    tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
    control = None
    if dt == torch.bfloat16:
        control = [_fro(c, w) for c, w in zip(fa.flash_attention_bwd_plain(
            *args, p_dtype=torch.bfloat16, **kw), want)]
    # live (query, key) pairs: query i sees keys max(0, i - window + 1) .. i
    pos = torch.arange(t, device=dev)
    pairs = int((pos + 1 - (pos - window + 1).clamp(min=0)).sum()) * b * h
    dtypes = (dt,) * 4
    main = fa.choose_bwd_path(d, dtypes)
    by_path = {}
    for path in fa.bwd_paths_for(d, dtypes):
        torch.cuda.synchronize()
        for n in ("launches", "tc_launches", "simt_launches"):
            setattr(fa.flash_attention_bwd, n, 0)
        got = fa.flash_attention_bwd(*args, path=path, **kw)
        torch.cuda.synchronize()
        counts = [getattr(fa.flash_attention_bwd, n)
                  for n in ("launches", "tc_launches", "simt_launches")]
        check(counts == [1, int(path == "tc"), int(path == "simt")],
              f"[hybrid_train] {label} on {path}: flash_attention_bwd "
              f"launches (all, tc, simt) {counts}")
        again = fa.flash_attention_bwd(*args, path=path, **kw)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"[hybrid_train] {label} on {path}: two calls differ")
        del again
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            rel, diff = _rel(g, w)
            check(bool(torch.isfinite(g).all()) and rel <= tol,
                  f"[hybrid_train] {label} on {path}: {name} kernel vs "
                  f"plain {rel:.3g} > {tol}")
            errs.append((name, rel, diff))
        fro = [_fro(g, w) for g, w in zip(got, want)]
        if control is not None:
            check(all(f <= ONE_PART_SHARE * c for f, c in zip(fro, control)),
                  f"[hybrid_train] {label} on {path}: error (Frobenius) "
                  f"{fro} not below {ONE_PART_SHARE} of the one-part-P "
                  f"control's {control}")
        del got
        bound_ms, bound_by = attn_bwd_bound(
            path, _nbytes(qh, kh, vh, out, dout, stats, qh, kh, vh), pairs,
            d, dt)
        by_path[path] = dict(
            ms=scaled_device_ms(lambda path=path: fa.flash_attention_bwd(
                *args, path=path, **kw)),
            errs=errs, fro=fro, bound_ms=bound_ms, bound_by=bound_by)
    del want
    plain_ms = event_ms(plain, 1)
    # the library: fp32 SDPA forward + backward, boolean window mask
    qf, kf, vf = (x.float().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    go = torch.randn(qf.shape, generator=gen, device=dev)

    def library():
        o = F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qf, kf, vf), go)

    library_ms = event_ms(library, 3)
    del qf, kf, vf, go
    bf16_sdpa = ""
    if dt == torch.bfloat16:
        qb, kb, vb = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        gb = torch.randn(qb.shape, generator=gen, device=dev).to(dt)

        def library_bf16():
            o = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qb, kb, vb), gb)

        bf16_ms = event_ms(library_bf16, 3)
        bf16_sdpa = (f", bf16 SDPA forward + backward {bf16_ms:.4f} ms (P in "
                     f"bf16, not the same function)")
        del qb, kb, vb, gb
    need, run = attn_bwd_passes(d, dt)
    times = "; ".join(
        f"{p} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']}; "
        + ", ".join(f"{n} {e:.2e}" for n, e, _ in r["errs"]) + "; Frobenius "
        + ", ".join(f"{f:.2e}" for f in r["fro"]) + ")"
        for p, r in by_path.items())
    if control is not None:
        times += ("; one-part-P control (Frobenius, dq dk dv) "
                  + ", ".join(f"{c:.2e}" for c in control)
                  + f", every path within {ONE_PART_SHARE} of it")
    if "tc" in by_path:
        times += (f"; tc runs {2 * run} D operations a pair where the "
                  f"function needs {2 * need} D (its bound)")
    print(f"[hybrid_train] {label:<22} B={b} T={t} H={h} Hkv={hkv} D={d} "
          f"window={window}: forward row statistics vs plain m {rel_m:.2e} "
          f"l {rel_l:.2e}; backward path {main}, {pairs} live pairs; "
          f"{times}; two calls of each path bit for bit; plain_ms="
          f"{plain_ms:.4f}, library_ms={library_ms:.4f} (fp32 "
          f"scaled_dot_product_attention forward + backward, boolean window "
          f"mask){bf16_sdpa}")
    mine = by_path[main]
    return dict(case=label, kernel="flash_attention_bwd", path=main,
                dtype=str(dt)[6:], launches=1,
                rel_err=max(r for _, r, _ in mine["errs"]),
                max_abs_err=max(a for _, _, a in mine["errs"]),
                ms=mine["ms"], plain_ms=plain_ms, bound_ms=mine["bound_ms"],
                bound_by=mine["bound_by"], library_ms=library_ms,
                library="fp32 scaled_dot_product_attention forward + "
                        "backward, boolean window mask", by_path=by_path)


def phase_hybrid_train(dev):
    """[hybrid_train]: the two backward kernels against their plain
    versions (``HYBRID_BWD_*_CASES``), then RecurrentGemma-9B at full width
    with its depth cut to ``HYBRID_TRAIN_LAYERS`` (4 RG-LRU blocks with a
    dense SwiGLU, 2 local-attention blocks with the block-sparse FFN; bf16
    activations, fp32 parameters, remat) on 1 x ``HYBRID_TRAIN_T`` tokens:
    one step's loss and gradients on ``"cuda"`` vs ``"reference"``
    (``LOSS_RTOL``, ``GNORM_RTOL``, ``GRAD_RTOL``) with the exact launches
    of every kernel per path, then ``HYBRID_TRAIN_STEPS`` ``Trainer``
    steps (launches, ms/step, peak memory) and one profiled step.  Returns
    the Trainer run's launch counts and the kernel records."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.runtime import Trainer, TrainerConfig, make_train_step

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    sfu = rg_lru_sfu_per_element()
    recs = [rg_lru_bwd_case(label, *case, dev, gen, sfu)
            for label, case in HYBRID_BWD_RG_LRU_CASES.items()]
    recs += [attn_bwd_case(label, *case, dev, gen)
             for label, case in HYBRID_BWD_ATTN_CASES.items()]
    gc.collect()
    torch.cuda.empty_cache()

    model = build_family("recurrentgemma-9b", "hybrid_train", dev,
                         n_layers=HYBRID_TRAIN_LAYERS, ffn_block_sparse=True,
                         ffn_block=64, ffn_density=0.25)
    cfg = model.cfg
    kinds = model.layer_kinds
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    n_sparse = sparse_layers(model)
    check(cfg.remat and n_sparse == n_local and n_rec == 2 * n_local,
          f"[hybrid_train] layers {kinds}, {n_sparse} sparse FFNs, remat "
          f"{cfg.remat}")
    shape = ShapeConfig("hybrid-train", "train", HYBRID_TRAIN_T, 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 1).batch(0).items()}
    # a step with remat: each forward kernel twice (the forward, then the
    # backward pass's recompute), each backward kernel once; the SpMM's dx
    # on the transposed mode, every SpMM launch on the tensor cores
    per_step = dict(rg_lru=2 * n_rec, rg_lru_tile=2 * n_rec,
                    rg_lru_bwd=n_rec, rg_lru_bwd_tile=n_rec,
                    flash=2 * n_local,
                    flash_tc=2 * n_local, flash_bwd=n_local,
                    flash_bwd_tc=n_local,
                    spmm=3 * n_sparse * 3, spmm_tc=3 * n_sparse * 3,
                    spmm_t=3 * n_sparse)

    def check_counts(got, steps, what):
        bad = {k: (got[k], v * steps) for k, v in per_step.items()
               if got[k] != v * steps}
        check(not bad and got["rg_lru_simt"] == 0
              and got["rg_lru_bwd_simt"] == 0 and got["flash_bwd_simt"] == 0,
              f"[hybrid_train] {what}: launches (got, expected) {bad}; "
              f"{got}")

    # (a) one step's loss and gradients, cuda vs reference
    picked = ["layers.0.rec.a_param", "layers.0.rec.a_gate.w",
              "layers.0.rec.x_gate.w", "layers.0.rec.in_x.w",
              "layers.3.rec.conv", "layers.2.attn.wq.w", "layers.2.attn.wk.w",
              "layers.5.attn.wv.w", "layers.2.mlp.up.blocks",
              "layers.5.mlp.down.blocks", "layers.4.mlp.gate.w",
              "final_norm.scale"]
    seen = {}
    for backend in ("cuda", "reference"):
        _zero_counts()
        t1 = time.perf_counter()
        loss, grads = _grads_on(model, batch, backend)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got = _counts()
        if backend == "cuda":
            check_counts(got, 1, "gradient step")
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()])))
        check(np.isfinite(loss) and np.isfinite(norm),
              f"[hybrid_train] {backend}: loss {loss}, grad norm {norm}")
        seen[backend] = (loss, norm, {k: grads[k].clone() for k in picked})
        del grads
        print(f"[hybrid_train] gradient step on {backend}: loss {loss:.5f}, "
              f"grad norm {norm:.5f}, {ms:.1f} ms; launches "
              f"{ {k: v for k, v in got.items() if v} }")
    (l_cuda, n_cuda, g_cuda), (l_ref, n_ref, g_ref) = (seen["cuda"],
                                                       seen["reference"])
    errs = {k: float(torch.linalg.vector_norm(g_cuda[k] - g_ref[k])
                     / torch.linalg.vector_norm(g_ref[k])) for k in picked}
    loss_err = abs(l_cuda - l_ref) / abs(l_ref)
    norm_err = abs(n_cuda - n_ref) / n_ref
    print(f"[hybrid_train] cuda vs reference: loss {loss_err:.3e} (tol "
          f"{LOSS_RTOL}), grad norm {norm_err:.3e} (tol {GNORM_RTOL}), "
          f"gradients (norm-relative, tol {GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(loss_err <= LOSS_RTOL, f"[hybrid_train] loss err {loss_err:.3g}")
    check(norm_err <= GNORM_RTOL, f"[hybrid_train] grad norm err "
                                  f"{norm_err:.3g}")
    for k, v in errs.items():
        check(v <= GRAD_RTOL, f"[hybrid_train] {k} gradient err {v:.3g}")
    del seen, g_cuda, g_ref

    # (b) the Trainer: no checkpoint directory
    tcfg = TrainerConfig(steps=HYBRID_TRAIN_STEPS, log_every=1, warmup=1)
    trainer = Trainer(model, cfg, shape, tcfg, seed=SEED)
    probe = {k: p.detach().reshape(-1)[:64].clone()
             for k, p in trainer.params.items() if k in picked}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = trainer.run()
    got = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in out["history"]:
        print(f"[hybrid_train] step {h['step']}: loss {h['loss']:.5f}, grad "
              f"norm {h['grad_norm']:.5f}, {h['ms']:.1f} ms/step, "
              f"{HYBRID_TRAIN_T * 1e3 / h['ms']:.0f} tokens/s")
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"[hybrid_train] step {h['step']}: non-finite")
    check(len(out["history"]) == HYBRID_TRAIN_STEPS,
          "[hybrid_train] a step was not logged")
    moved = [k for k, v in probe.items()
             if not torch.equal(trainer.params[k].detach().reshape(-1)[:64],
                                v)]
    check(len(moved) == len(probe), f"[hybrid_train] parameters that did "
                                    f"not move: {sorted(set(probe) - set(moved))}")
    check_counts(got, HYBRID_TRAIN_STEPS, "Trainer run")
    steady = float(np.median([h["ms"] for h in out["history"][1:]]))
    # (c) one more step under the profiler: where a step's time goes
    step_fn = make_train_step(model, trainer.opt, 1)
    nxt = {k: torch.from_numpy(v).to(dev)
           for k, v in trainer.data.batch(HYBRID_TRAIN_STEPS).items()}
    idle = profile_once("hybrid training step",
                        lambda: step_fn(trainer.opt_state, nxt))
    print(f"[hybrid_train] launches per step, each exact: rg_lru forward "
          f"{per_step['rg_lru']} (all tile, remat), rg_lru_bwd "
          f"{per_step['rg_lru_bwd']} (all tile), flash_attention forward "
          f"{per_step['flash']} (all tc, remat), flash_attention_bwd "
          f"{per_step['flash_bwd']} (all tc), segment_spmm "
          f"{per_step['spmm']} (all "
          f"tc; {per_step['spmm_t']} transposed)")
    print(f"[hybrid_train] summary: {cfg.name} full width, "
          f"{cfg.n_layers} layers, batch 1 x {HYBRID_TRAIN_T}, remat: "
          f"median of steps 1..{HYBRID_TRAIN_STEPS - 1} {steady:.1f} ms/step "
          f"({HYBRID_TRAIN_T * 1e3 / steady:.0f} tokens/s), peak {peak:.2f} "
          f"GiB, device idle share {idle:.3f}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer
    free_model(model)
    return got, recs


# the last four families ([ssm], [moe], [vlm], [encdec]): each is built at
# published width after the earlier models are freed, and freed after
SSM_FORWARD_T = 2048           # [ssm]: forward over 1 x 2048 tokens
MOE_LAYERS = 2                 # [moe]: Phi-3.5-MoE's depth cut 32 -> 2
MOE_FORWARD_T = 4096           # [moe]: forward + aux over 1 x 4096 tokens
VLM_TEXT_T = 1024              # [vlm]: 256 vision + 1024 text positions
ENCDEC_TEXT_T = 448            # [encdec]: Whisper's text context
ENCDEC_TRAIN_BATCH = 8         # [encdec]: Trainer steps at 8 x 448 tokens
ENCDEC_TRAIN_STEPS = 3


def build_family(name, tag, dev, **knobs):
    """``name``'s config at published width (bf16 activations, fp32
    parameters, ``knobs`` on top), built on the card with random weights
    from ``SEED``; prints its shape, parameter count and memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(name), dtype="bfloat16", **knobs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = model.layer_kinds
    enc = len(model.enc) if model.enc is not None else 0
    print(f"[{tag}] {cfg.name} full width: {len(kinds)} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}"
          f"{f', encoder {enc} attn_bidir' if enc else ''}), d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads / "
          f"{cfg.n_kv} KV, vocab {cfg.vocab}; {sparse_layers(model)} sparse "
          f"FFNs; {n_params / 1e9:.3f} B fp32 params; built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model


def serve_family(model, dev, tag, steady=True,
                 around_mix=contextlib.nullcontext, **engine_kw):
    """The smoke's request mix through ``Engine(slots=4, max_len=256,
    **engine_kw)`` after a warm-up engine, every launch count set to 0 just
    before the mix and read just after it (the mix runs inside
    ``around_mix()``); a decode step's logits on ``"cuda"`` vs
    ``"reference"``, a profiled decode step and (``steady``) 32 steady
    4-slot steps.  Returns a dict of the counts, the model calls, the
    engine's buckets, the idle share and the steady ms/step."""
    from repro_torch.runtime import Engine, Request

    rng = np.random.default_rng(SEED)
    vocab = model.cfg.vocab
    Engine(model, slots=4, max_len=256, **engine_kw).generate(
        [Request(prompt=rng.integers(0, vocab, 4), max_new_tokens=2)])
    prompts = [rng.integers(0, vocab, int(rng.integers(5, 61)))
               for _ in range(6)]
    engine = Engine(model, slots=4, max_len=256, **engine_kw)
    with around_mix():
        _zero_counts()
        _, spmm, quantized, split = serve_mix(engine, prompts,
                                              f"{tag} serve")
    out = dict(counts=_counts(), spmm=spmm, quantized=quantized,
               split=split, buckets=engine.prefill_buckets,
               decode_calls=engine.decode_calls,
               calls=engine.decode_calls + engine.prefill_calls)
    decode_logits_check(engine.model, engine, dev, rng, f"{tag} serve")
    out["idle"] = phase_profile(engine.model, engine, dev,
                                label=f"{tag} decode step")
    del engine
    if steady:
        out["steady_ms"], _ = steady_decode(model, rng, tag=f"{tag} steady")
    return out


def stepwise_check(model, tokens, tag, enc_out=None, **forward_kw):
    """``forward``'s logits at the last of ``tokens`` (1, T) against T
    ``decode_step`` calls of one token from an empty cache (≤
    ``LOGIT_RTOL``)."""
    t = tokens.shape[1]
    with torch.inference_mode():
        want = model(tokens, **forward_kw)[0, -1].float()
        cache = model.init_cache(1, t)
        for i in range(t):
            step, _ = model.decode_step(cache, tokens[:, i:i + 1], i,
                                        enc_out)
    got = step[0].float()
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = int(got.argmax()) == int(want.argmax())
    print(f"[{tag} cache] forward vs {t} decode steps at the last position: "
          f"rel_err {rel:.3e} (tol {LOGIT_RTOL}), same top-1 {top1}")
    check(bool(torch.isfinite(got).all()), f"[{tag} cache] non-finite")
    check(rel <= LOGIT_RTOL, f"[{tag} cache] rel err {rel} > {LOGIT_RTOL}")


def timed_forward(model, tag, want, *args, **kw):
    """``model(*args, **kw)`` under inference mode with every count set to
    0 just before it: the counts (each must equal ``want``'s), the logits'
    shape and finiteness, then the time of a second call (CUDA events) and
    the peak memory.  Returns the counts, the ms, the peak GiB and the aux
    loss."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with torch.inference_mode():
        logits, aux = model(*args, return_aux=True, **kw)
        got = _counts()
        for k, v in want.items():
            check(got[k] == v, f"[{tag} forward] {k} launches {got[k]} != "
                               f"{v} ({got})")
        check(bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(aux)),
              f"[{tag} forward] non-finite logits or aux")
        shape = tuple(logits.shape)
        del logits
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model(*args, **kw)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag} forward] logits {shape}, aux {float(aux):.5f}; launches "
          f"{ {k: v for k, v in got.items() if v} }; "
          f"{ms:.2f} ms a forward (CUDA events, "
          f"{shape[0] * shape[1] * 1e3 / ms:.0f} tokens/s); peak "
          f"{peak:.2f} GiB")
    return got, ms, peak, float(aux)


def free_model(model):
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_ssm(dev):
    """[ssm]: RWKV-6 1.6B at full width, all 24 layers, bf16 activations.
    Serves the mix (one token a prefill call: the state has no mask lane),
    32 steady steps; forward over 1 x ``SSM_FORWARD_T`` tokens; forward vs
    stepwise decode.  The wkv recurrence is a torch loop (no kernel in
    either package): no launch of the port's kernels is expected."""
    model = build_family("rwkv6-1.6b", "ssm", dev)
    s = serve_family(model, dev, "ssm")
    check(s["buckets"] == (1,), f"[ssm] prefill buckets {s['buckets']}")
    check(s["counts"]["spmm"] == 0 and s["counts"]["rg_lru"] == 0
          and s["counts"]["flash"] == 0, f"[ssm serve] launches "
                                         f"{s['counts']}, expected none")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tokens = torch.randint(0, model.cfg.vocab, (1, SSM_FORWARD_T),
                           generator=gen, device=dev)
    _, ms, peak, _ = timed_forward(model, "ssm", {"spmm": 0}, tokens)
    stepwise_check(model, tokens[:, :HYBRID_CACHE_T], "ssm")
    print(f"[ssm] summary: steady {s['steady_ms']:.2f} ms/step, device "
          f"idle share {s['idle']:.3f}; forward {ms:.2f} ms, peak "
          f"{peak:.2f} GiB")
    free_model(model)


@contextlib.contextmanager
def kept_tokens(seen):
    """Within the block, ``repro_torch.models.moe.dispatch_batched``
    appends each dispatch's (B, T), capacity and kept count (a device
    tensor, read after the run) to ``seen``."""
    from repro_torch.models import moe as moe_mod
    inner = moe_mod.dispatch_batched

    def counting(x, expert, n_exp, cap):
        buf, slot, keep = inner(x, expert, n_exp, cap)
        seen.append((tuple(x.shape[:2]), cap, keep.sum()))
        return buf, slot, keep

    moe_mod.dispatch_batched = counting
    try:
        yield seen
    finally:
        moe_mod.dispatch_batched = inner


def summarize_kept(seen, per_call, tag):
    """Each model call's kept / routed tokens (``per_call`` dispatches a
    call: MoE layers x top_k), printed in call order."""
    calls = []
    for i in range(0, len(seen), per_call):
        group = seen[i:i + per_call]
        (b, t), cap = group[0][0], group[0][1]
        kept = sum(int(k) for _, _, k in group)
        calls.append((b, t, cap, kept, b * t * per_call))
    print(f"[{tag}] kept / routed token choices per model call (B x T, "
          f"cap): " + " ".join(f"{b}x{t}(cap {c}):{k}/{n}"
                               for b, t, c, k, n in calls))
    return calls


def phase_moe(dev):
    """[moe]: Phi-3.5-MoE at full width with its depth cut to
    ``MOE_LAYERS`` (16 experts, top-2, capacity 1.25).  Serves the mix with
    prefill buckets (64, 16), so chunks pad and drop tokens, and prints
    every model call's kept-token count; 32 steady steps; forward + aux
    over 1 x ``MOE_FORWARD_T`` tokens; forward vs one decode_step over the
    same 64 tokens (the same capacity), and, with the capacity factor set
    to the expert count so nothing drops, forward vs 64 stepwise decode
    steps."""
    model = build_family("phi3.5-moe-42b-a6.6b", "moe", dev,
                         n_layers=MOE_LAYERS)
    cfg = model.cfg
    per_call = cfg.n_layers * cfg.top_k
    seen = []
    s = serve_family(model, dev, "moe", steady=False,
                     around_mix=lambda: kept_tokens(seen))
    check(s["buckets"] == (64, 16), f"[moe] prefill buckets {s['buckets']}")
    check(s["counts"]["spmm"] == 0, f"[moe serve] launches {s['counts']}")
    calls = summarize_kept(seen, per_call, "moe serve")
    decode = [c for c in calls if c[1] == 1]
    check(len(calls) == s["calls"]
          and len(decode) == s["decode_calls"]
          and all(k == n for _, _, _, k, n in decode),
          "[moe serve] a decode step dropped a token, or calls miscounted")
    kept = sum(c[3] for c in calls)
    routed = sum(c[4] for c in calls)
    print(f"[moe serve] kept {kept} of {routed} routed token choices "
          f"({routed - kept} dropped, all in prefill chunks)")
    steady_ms, _ = steady_decode(model, np.random.default_rng(SEED + 7),
                                 tag="moe steady")

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab, (1, MOE_FORWARD_T), generator=gen,
                           device=dev)
    seen = []
    with kept_tokens(seen):
        _, ms, peak, aux = timed_forward(model, "moe", {"spmm": 0}, tokens)
    # the first call's dispatches (the second is the timed one)
    fwd = summarize_kept(seen[:per_call], per_call, "moe forward")
    print(f"[moe forward] aux {aux:.5f}; kept {fwd[0][3]} of {fwd[0][4]} "
          f"token choices at cap {fwd[0][2]}")

    prompt = tokens[:, :HYBRID_CACHE_T]
    with torch.inference_mode():
        want = model(prompt)[0, -1].float()
        cache = model.init_cache(1, HYBRID_CACHE_T)
        got, _ = model.decode_step(cache, prompt, 0)
    rel = float((got[0].float() - want).abs().max() / want.abs().max())
    print(f"[moe cache] forward vs one {HYBRID_CACHE_T}-token decode_step "
          f"(same capacity): rel_err {rel:.3e} (tol {LOGIT_RTOL})")
    check(rel <= LOGIT_RTOL, f"[moe cache] rel err {rel} > {LOGIT_RTOL}")
    roomy = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    for blk in model.layers:
        blk.cfg = roomy
    try:
        stepwise_check(model, prompt, "moe no-drop")
    finally:
        for blk in model.layers:
            blk.cfg = cfg
    print(f"[moe] summary: steady {steady_ms:.2f} ms/step, device idle "
          f"share {s['idle']:.3f}; forward {ms:.2f} ms, peak {peak:.2f} GiB")
    free_model(model)


def phase_vlm(dev):
    """[vlm]: InternVL2-2B at full width, all 24 layers, with the
    block-sparse FFN as granite is served (64 blocks, density 0.25).
    Forward over 256 vision + ``VLM_TEXT_T`` text positions (the SpMM on
    the tensor cores, 72 launches); the mix served text-only (72 split
    launches a decode step) and on ``Engine(quantize="int8")`` (every
    launch quantized); forward vs stepwise decode; SpMM kernel vs plain at
    the model's decode and forward shapes.  Returns the launch counts and
    the kernel records."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataset

    model = build_family("internvl2-2b", "vlm", dev, ffn_block_sparse=True,
                         ffn_block=64, ffn_density=0.25)
    cfg = model.cfg
    n_sparse = sparse_layers(model)
    s = serve_family(model, dev, "vlm")
    check(s["split"] == s["spmm"] - s["counts"]["spmm_tc"]
          and s["spmm"] == 3 * n_sparse * s["calls"],
          f"[vlm serve] launches {s['counts']}")
    q = serve_family(model, dev, "vlm int8", steady=False, quantize="int8")
    check(q["quantized"] == q["spmm"] == 3 * n_sparse * q["calls"],
          f"[vlm int8 serve] {q['quantized']} of {q['spmm']} launches "
          f"quantized, expected 3 x {n_sparse} x {q['calls']}")
    print(f"[vlm] serving launches: fp32 {s['spmm']} == 3 x {n_sparse} x "
          f"{s['calls']} ({s['split']} split, {s['counts']['spmm_tc']} tc); "
          f"int8 {q['quantized']} quantized == 3 x {n_sparse} x "
          f"{q['calls']} ({q['split']} split)")

    shape = ShapeConfig("vlm", "prefill", cfg.n_frontend_tokens + VLM_TEXT_T,
                        1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 1).batch(0).items()}
    fwd, ms, peak, _ = timed_forward(
        model, "vlm", {"spmm": 3 * n_sparse, "spmm_tc": 3 * n_sparse},
        batch["tokens"], vis_embeds=batch["vis_embeds"])
    stepwise_check(model, batch["tokens"][:, :HYBRID_CACHE_T], "vlm")

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    up = model.layers[0].mlp.up
    plan = up.plan.with_values(up.blocks.data)
    recs = []
    for n in (4, cfg.n_frontend_tokens + VLM_TEXT_T):
        x = torch.randn(n, cfg.d_model, generator=gen, device=dev).bfloat16()
        recs.append(kernel_case(f"vlm up N={n}", plan, x.T, tag="vlm"))
    print(f"[vlm] summary: steady {s['steady_ms']:.2f} ms/step, device idle "
          f"share {s['idle']:.3f}; forward {ms:.2f} ms, peak {peak:.2f} GiB")
    free_model(model)
    return s["split"], fwd["spmm_tc"], recs


def phase_encdec(dev):
    """[encdec]: Whisper-tiny at full width with the block-sparse FFN (64
    blocks, density 0.25).  Forward over 1500 frames and
    ``ENCDEC_TEXT_T`` text tokens (24 SpMM launches, 20 on tc and the
    encoder's 4 down projections on split); decode
    logits with the encoder's output on ``"cuda"`` vs ``"reference"``;
    forward vs stepwise decode; ``Engine`` raises as ``repro``'s does;
    ``ENCDEC_TRAIN_STEPS`` ``Trainer`` steps at ``ENCDEC_TRAIN_BATCH`` x
    ``ENCDEC_TEXT_T`` tokens (loss and gradients vs the reference backend
    first; SpMM launches per step counted exactly, remat included); SpMM
    kernel vs plain at the encoder's training shapes.  Returns the launch
    counts and the kernel records."""
    from repro_torch.api import use_backend
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.segment_spmm import segment_spmm
    from repro_torch.runtime import Engine, Trainer, TrainerConfig

    model = build_family("whisper-tiny", "encdec", dev, ffn_block_sparse=True,
                         ffn_block=64, ffn_density=0.25)
    cfg = model.cfg
    n_sparse = sparse_layers(model)
    try:
        Engine(model, slots=4, max_len=256)
    except NotImplementedError as e:
        print(f"[encdec] Engine raises NotImplementedError: {e}")
    else:
        check(False, "[encdec] Engine served an encoder-decoder model")

    shape = ShapeConfig("encdec", "prefill", ENCDEC_TEXT_T, 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 1).batch(0).items()}
    # the encoder's down projections read h.T with a row stride of 1500
    # elements (3000 bytes), which TMA cannot read: the split path
    n_enc = len(model.enc)
    fwd, ms, peak, _ = timed_forward(
        model, "encdec", {"spmm": 3 * n_sparse,
                          "spmm_tc": 3 * n_sparse - n_enc,
                          "spmm_split": n_enc},
        batch["tokens"], enc_embeds=batch["enc_embeds"])

    rng = np.random.default_rng(SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1))).to(dev)
    logits = {}
    with torch.inference_mode():
        for backend in ("cuda", "reference"):
            with use_backend(backend):
                enc = model.encode(batch["enc_embeds"])
                cache = model.init_cache(1, 64)
                model.decode_step(cache, batch["tokens"][:, :40], 0, enc)
                logits[backend], _ = model.decode_step(cache, tok, 40, enc)
    got, want = logits["cuda"].float(), logits["reference"].float()
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[encdec] decode logits (with the encoder's output) cuda vs "
          f"reference: rel_err {rel:.3e} (tol {LOGIT_RTOL})")
    check(bool(torch.isfinite(got).all()) and rel <= LOGIT_RTOL,
          f"[encdec] decode logits rel err {rel}")
    with torch.inference_mode():
        enc = model.encode(batch["enc_embeds"])
    stepwise_check(model, batch["tokens"][:, :HYBRID_CACHE_T], "encdec",
                   enc_out=enc, enc_embeds=batch["enc_embeds"])

    # training: one step's loss and gradients cuda vs reference, then the
    # Trainer (remat: 2 forward + 1 transposed launch per projection)
    tshape = ShapeConfig("encdec-train", "train", ENCDEC_TEXT_T,
                         ENCDEC_TRAIN_BATCH)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, tshape, seed=SEED + 1).batch(0).items()}
    per_step = 3 * n_sparse * (3 if cfg.remat else 2)
    picked = ["enc.0.mlp.up.blocks", f"layers.{cfg.dec_layers - 1}.mlp."
              "down.blocks", "layers.0.xattn.wq.w", "frontend.w"]
    seen = {}
    for backend in ("cuda", "reference"):
        _zero_counts()
        loss, grads = _grads_on(model, tbatch, backend)
        counts = (segment_spmm.launches, segment_spmm.transposed_launches,
                  segment_spmm.tensor_core_launches)
        if backend == "cuda":
            check(counts == (per_step, 3 * n_sparse, per_step),
                  f"[encdec train] gradient step launches (all, transposed,"
                  f" tc) {counts} != ({per_step}, {3 * n_sparse}, "
                  f"{per_step})")
        seen[backend] = (loss, {k: grads[k].clone() for k in picked})
        del grads
    errs = {k: float(torch.linalg.vector_norm(seen["cuda"][1][k]
                                              - seen["reference"][1][k])
                     / torch.linalg.vector_norm(seen["reference"][1][k]))
            for k in picked}
    loss_err = abs(seen["cuda"][0] - seen["reference"][0]) / abs(
        seen["reference"][0])
    print(f"[encdec train] cuda vs reference: loss {loss_err:.3e} (tol "
          f"{LOSS_RTOL}), gradients (norm-relative, tol {GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(loss_err <= LOSS_RTOL, f"[encdec train] loss err {loss_err}")
    for k, v in errs.items():
        check(v <= GRAD_RTOL, f"[encdec train] {k} gradient err {v}")
    del seen
    tcfg = TrainerConfig(steps=ENCDEC_TRAIN_STEPS, log_every=1, warmup=1)
    trainer = Trainer(model, cfg, tshape, tcfg, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = trainer.run()
    launches = segment_spmm.launches
    transposed = segment_spmm.transposed_launches
    tc = segment_spmm.tensor_core_launches
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = ENCDEC_TRAIN_BATCH * ENCDEC_TEXT_T
    for h in out["history"]:
        print(f"[encdec train] step {h['step']}: loss {h['loss']:.5f}, grad "
              f"norm {h['grad_norm']:.5f}, {h['ms']:.1f} ms/step, "
              f"{tokens * 1e3 / h['ms']:.0f} text tokens/s")
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"[encdec train] step {h['step']}: non-finite")
    check((launches, transposed, tc) == (
        per_step * ENCDEC_TRAIN_STEPS, 3 * n_sparse * ENCDEC_TRAIN_STEPS,
        per_step * ENCDEC_TRAIN_STEPS),
        f"[encdec train] launches (all, transposed, tc) {launches}, "
        f"{transposed}, {tc} != {per_step} x {ENCDEC_TRAIN_STEPS}, "
        f"{3 * n_sparse} x {ENCDEC_TRAIN_STEPS}, all")
    steady = float(np.median([h["ms"] for h in out["history"][1:]]))
    print(f"[encdec train] batch {ENCDEC_TRAIN_BATCH} x {ENCDEC_TEXT_T} "
          f"text tokens over {cfg.n_frontend_tokens} frames, remat "
          f"{cfg.remat}: median of steps 1..{ENCDEC_TRAIN_STEPS - 1} "
          f"{steady:.1f} ms/step; segment_spmm launches {launches} == "
          f"{per_step} x {ENCDEC_TRAIN_STEPS} ({transposed} transposed), all "
          f"{tc} on the tensor cores; peak {train_peak:.2f} GiB")

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    up = model.enc[0].mlp.up
    plan = up.plan.with_values(up.blocks.data)
    n = ENCDEC_TRAIN_BATCH * cfg.n_frontend_tokens
    x = torch.randn(n, cfg.d_model, generator=gen, device=dev).bfloat16()
    dy = torch.randn(n, cfg.d_ff, generator=gen, device=dev).bfloat16()
    recs = [kernel_case(f"encdec up N={n}", plan, x.T, tag="encdec"),
            kernel_case(f"encdec up dx N={n}", plan, dy.T, transpose=True,
                        tag="encdec")]
    print(f"[encdec] summary: forward {ms:.2f} ms, peak {peak:.2f} GiB; "
          f"training {steady:.1f} ms/step, peak {train_peak:.2f} GiB")
    del trainer
    free_model(model)
    return launches - transposed, transposed, recs


VERIFY_SCALE_CAP = 2048        # [verify]: the paper's suite at this cap
VERIFY_BLOCK = (64, 64)        # its matrices blocked for the kernels
VERIFY_N = 64                  # A @ X: X's fp32 columns, from SEED


def verify_replan(model, dev, tag):
    """Every ``SparseLinear`` of ``model`` planned again, as it was planned
    (with its grad plan) and quantized to each of ``QSERVE_MODES``, first
    with ``verify="fast"`` and then with ``verify="full"``: each template is
    verified once per level and a finding raises.  The planner's calls to
    ``verify_plan`` are counted and timed in the pass.  Returns the counts
    and host seconds."""
    import repro_torch.api.planner as planner
    from repro_torch import api
    from repro_torch.core.formats import BSR, quantize_blocks
    from repro_torch.models import SparseLinear

    layers = [m for m in model.modules() if isinstance(m, SparseLinear)]
    patterns = [(lin, BSR((lin.d_out, lin.d_in), lin.plan.block_shape,
                          lin.plan.a_brow.cpu().numpy(),
                          lin.plan.a_bcol.cpu().numpy(), None))
                for lin in layers]
    real = planner.verify_plan

    def replan(level, calls):
        """One planner pass, its ``verify_plan`` calls appended to
        ``calls``; the fingerprints it touched."""
        def counted(plan, **kw):
            t0 = time.perf_counter()
            res = real(plan, **kw)
            calls.append((plan, kw.get("level"), res,
                          time.perf_counter() - t0))
            return res

        fps = []
        planner.verify_plan = counted
        try:
            for lin, w in patterns:
                src = lin.plan
                for mode in (None,) + QSERVE_MODES:
                    blocks = lin.blocks.detach()
                    if mode is not None:
                        blocks = quantize_blocks(blocks, mode)
                    plan = api.plan_matmul(
                        dataclasses.replace(w, blocks=blocks),
                        policy=src.policy, with_grad=True, quantize=mode,
                        n_lanes=src.n_lanes, unroll=src.unroll,
                        pipeline=src.pipeline, bn_hint=src.bn_hint,
                        verify=level, device=dev)
                    fps.append(plan.fingerprint)
        finally:
            planner.verify_plan = real
        torch.cuda.synchronize()
        return fps

    out = dict(projections=len(layers))
    for level in ("fast", "full"):
        stats = api.plan_cache_stats()
        calls = []
        t0 = time.perf_counter()
        fps = replan(level, calls)
        secs = time.perf_counter() - t0
        after = api.plan_cache_stats()
        n_tpl = len(set(fps))
        bad = [r.summary() for _, _, r, _ in calls if not r.ok]
        check(not bad, f"{tag} findings: {bad[:2]}")
        check(len(calls) == n_tpl and all(lv == level
                                          for _, lv, _, _ in calls),
              f"{tag} {level}: {len(calls)} verify_plan calls for {n_tpl} "
              f"templates")
        verify_s = sum(c[3] for c in calls)
        items = sum(p.n_items + p.grad_plan.n_items for p, _, _, _ in calls)
        out[level] = dict(templates=n_tpl, verified=len(calls),
                          plan_s=secs, verify_s=verify_s,
                          ms_per_template=verify_s * 1e3 / n_tpl,
                          hits=after["hits"] - stats["hits"],
                          misses=after["misses"] - stats["misses"])
        print(f"{tag} verify={level!r}: {len(layers)} projections x (fp32 "
              f"+ {'/'.join(QSERVE_MODES)}) re-planned, {len(fps)} plans "
              f"over {n_tpl} distinct templates (patterns the layers "
              f"share; grad plans inside, {items} schedule items), "
              f"{len(calls)} verified now, cache hits {out[level]['hits']} "
              f"/ misses {out[level]['misses']}, 0 findings; planner pass "
              f"{secs:.3f} s host, verify_plan in it {verify_s:.3f} s host "
              f"({out[level]['ms_per_template']:.3f} ms a template)")
    return out


def verify_on_card(model, dev):
    """The verifier on a realized plan whose tensors live on the card:
    layer 0's up plan verifies clean; with one ``a_fetch`` item flipped,
    ``verify_plan`` reports exactly ``fetch-on-change`` there, and
    ``execute_plan(..., verify=True)`` raises before any launch."""
    from repro_torch.analysis import PlanVerificationError, verify_plan
    from repro_torch.api import execute_plan
    from repro_torch.kernels.segment_spmm import segment_spmm

    plan = model.layers[0].mlp.up.plan
    check(plan.a_fetch.is_cuda and plan.seg_start.is_cuda,
          "[verify card] the plan's tensors are not on the card")
    t0 = time.perf_counter()
    res = verify_plan(plan, level="full")
    clean_s = time.perf_counter() - t0
    check(res.ok, f"[verify card] {res.summary()}")
    valid = plan.valid.cpu().numpy()
    i = next(i for i in range(1, plan.n_items)
             if valid[i] and valid[i - 1] and i % plan.lane_len)
    a_fetch = plan.a_fetch.clone()
    a_fetch[i] = 1 - a_fetch[i]
    bad = plan.replace(a_fetch=a_fetch)
    got = [(f.invariant, f.item, f.stream, f.path)
           for f in verify_plan(bad, level="full").findings]
    check(got == [("fetch-on-change", i, "a", "plan")],
          f"[verify card] flipped a_fetch[{i}]: findings {got}")
    x = torch.randn(plan.grid[1] * plan.block_shape[1], 4, device=dev)
    torch.cuda.synchronize()
    before = segment_spmm.launches
    try:
        execute_plan(bad, x, verify=True)
        raised = False
    except PlanVerificationError as e:
        raised = [f.invariant for f in e.findings] == ["fetch-on-change"]
    torch.cuda.synchronize()
    check(raised and segment_spmm.launches == before,
          f"[verify card] execute_plan(verify=True) raised {raised}, "
          f"launches {segment_spmm.launches - before}")
    print(f"[verify card] layer 0 up plan on {plan.a_fetch.device}: "
          f"verify_plan(full) clean in {clean_s * 1e3:.2f} ms host; "
          f"a_fetch[{i}] flipped -> exactly [fetch-on-change] at item {i} "
          f"(stream a); execute_plan(verify=True) raised "
          f"PlanVerificationError, segment_spmm launches unchanged "
          f"({before})")


def verify_suite(dev):
    """The paper's suite (``sim.matrices.suite(scale_cap=VERIFY_SCALE_CAP)``)
    on the card: each matrix blocked at ``VERIFY_BLOCK`` by
    ``BSR.from_dense``, A @ Aᵀ planned as SpGEMM and A @ X as SpMM (X:
    ``VERIFY_N`` fp32 columns from ``SEED``), both with ``verify="full"``;
    every plan once through ``plan()`` with the counts set to 0 just
    before, each path's launches exact; SpGEMM blocks held against
    ``spgemm_reference`` and the plain version, SpMM against ``to_dense()
    @ X`` and the plain version (≤ ``KERNEL_RTOL``); the largest case of
    each timed.  Returns the launch counts and the records."""
    from repro_torch import api
    from repro_torch.core.formats import BSR, spgemm_reference
    from repro_torch.kernels.segment_spmm import (choose_path,
                                                  segment_spmm_plain)
    from repro_torch.sim import matrices

    sg = importlib.import_module("repro_torch.kernels.segment_spgemm")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    t0 = time.perf_counter()
    suite = matrices.suite(scale_cap=VERIFY_SCALE_CAP)
    print(f"[verify suite] {len(suite)} matrices at scale cap "
          f"{VERIFY_SCALE_CAP} built in {time.perf_counter() - t0:.2f} s "
          f"(hash((name, seed)) seeding: PYTHONHASHSEED="
          f"{os.environ.get('PYTHONHASHSEED', 'unset')})")
    runs = []
    for name, (a, _) in suite.items():
        dense = a.to_dense()
        am = BSR.from_dense(dense, VERIFY_BLOCK)
        bm_ = BSR.from_dense(np.ascontiguousarray(dense.T), VERIFY_BLOCK)
        t0 = time.perf_counter()
        g = api.plan_matmul(am, bm_, verify="full", device=dev)
        g_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = api.plan_matmul(am, VERIFY_N, verify="full", device=dev)
        p_s = time.perf_counter() - t0
        x = torch.randn(am.grid[1] * VERIFY_BLOCK[1], VERIFY_N,
                        generator=gen, device=dev)
        runs.append(dict(name=name, a=a, dense=dense, g=g, p=p, x=x,
                         g_s=g_s, p_s=p_s))
    fp32 = sg.storage_mode(torch.float32, torch.float32, None, None)
    g_path = sg.choose_path(*VERIFY_BLOCK, VERIFY_BLOCK[0], fp32,
                            torch.float32)
    x0 = runs[0]["x"]
    p_path = choose_path(VERIFY_N, x0.dtype, *VERIFY_BLOCK, x0.stride(),
                         x0.data_ptr())
    # the main path: every plan once, counts set just before, read after
    _zero_counts()
    _zero_spgemm_counts()
    for r in runs:
        r["c"], r["y"] = r["g"](), r["p"](r["x"])
    torch.cuda.synchronize()
    g_launches, g_quant, g_tc, g_simt = _spgemm_counts()
    p_got = list(_path_counts())
    n_g = sum(r["g"].n_out_blocks > 0 for r in runs)
    check(g_launches == n_g and g_quant == 0
          and (g_tc, g_simt) == ((n_g, 0) if g_path == "tc" else (0, n_g)),
          f"[verify suite] segment_spgemm launches {g_launches} (tc {g_tc},"
          f" simt {g_simt}) != {n_g} on {g_path}")
    n_p = len(runs)
    check(p_got == [n_p, n_p * (p_path == "tc"), n_p * (p_path == "split")],
          f"[verify suite] segment_spmm (all, tc, split) {p_got} != {n_p} "
          f"on {p_path}")
    worst = dict(g_ref=0.0, g_plain=0.0, p_ref=0.0, p_plain=0.0,
                 g_abs=0.0, p_abs=0.0)
    for r in runs:
        g, p, a = r["g"], r["p"], r["a"]
        m, k = a.shape
        # SpGEMM: the reference's C, blocked at the plan's symbolic pattern
        ref = spgemm_reference(a, a.transpose()).to_dense()
        gm, gn = g.grid[0], g.rhs_grid[1]
        pad = np.zeros((gm * VERIFY_BLOCK[0], gn * VERIFY_BLOCK[1]),
                       np.float32)
        pad[:m, :m] = ref
        tiles = pad.reshape(gm, VERIFY_BLOCK[0], gn, VERIFY_BLOCK[1])
        want = torch.from_numpy(np.ascontiguousarray(
            tiles[g.c_brow, :, g.c_bcol, :])).to(dev)
        g_ref, _ = _rel(r["c"], want)
        g_plain, g_abs = _rel(r["c"], _spgemm_plain(g))
        # SpMM: the dense product and the plain version
        y = r["y"][:m]
        p_ref, _ = _rel(y, torch.from_numpy(r["dense"]).to(dev)
                        @ r["x"][:k])
        plain = segment_spmm_plain(p.lhs_blocks, p.slot_idx, p.m_idx,
                                   p.k_idx, p.valid, r["x"],
                                   grid_m=p.grid_m)[:m]
        p_plain, p_abs = _rel(y, plain)
        check(max(g_ref, g_plain, p_ref, p_plain) <= KERNEL_RTOL
              and bool(torch.isfinite(r["c"]).all())
              and bool(torch.isfinite(y).all()),
              f"[verify suite] {r['name']}: SpGEMM vs reference {g_ref:.3g}"
              f", vs plain {g_plain:.3g}; SpMM vs dense {p_ref:.3g}, vs "
              f"plain {p_plain:.3g} > {KERNEL_RTOL}")
        for key, v in (("g_ref", g_ref), ("g_plain", g_plain),
                       ("p_ref", p_ref), ("p_plain", p_plain),
                       ("g_abs", g_abs), ("p_abs", p_abs)):
            worst[key] = max(worst[key], v)
        print(f"[verify suite] {r['name']:<13} {m}x{k} nnz {a.nnz}: "
              f"{g.n_blocks} blocks, SpGEMM {int(g.valid.sum())} items -> "
              f"{g.n_out_blocks} C blocks (planned {r['g_s']:.3f} s), SpMM "
              f"{int(p.valid.sum())} items (planned {r['p_s']:.3f} s); "
              f"rel_err SpGEMM ref {g_ref:.2e} plain {g_plain:.2e}, SpMM "
              f"dense {p_ref:.2e} plain {p_plain:.2e}")
    plan_s = sum(r["g_s"] + r["p_s"] for r in runs)
    print(f"[verify suite] {n_p} matrices: segment_spgemm launches "
          f"{g_launches} (all {g_path}), segment_spmm launches {p_got[0]} "
          f"(all {p_path}); C blocks {sum(r['g'].n_out_blocks for r in runs)}"
          f"; host planning {plan_s:.2f} s (verify='full' included); worst "
          f"rel_err SpGEMM ref {worst['g_ref']:.2e} plain "
          f"{worst['g_plain']:.2e}, SpMM dense {worst['p_ref']:.2e} plain "
          f"{worst['p_plain']:.2e}")
    # the largest case of each timed beside its plain version and bound
    big_g = max(runs, key=lambda r: int(r["g"].valid.sum()))
    g_rec = spgemm_case(f"suite {big_g['name']}", big_g["g"], big_g["c"])
    g_rec["max_abs_err"] = max(g_rec["max_abs_err"], worst["g_abs"])
    big_p = max(runs, key=lambda r: int(r["p"].valid.sum()))
    p_rec = kernel_case(f"suite {big_p['name']}", big_p["p"], big_p["x"],
                        tag="verify")
    p_rec["max_abs_err"] = max(p_rec["max_abs_err"], worst["p_abs"])
    return g_launches, p_got[0], g_rec, p_rec


def phase_verify(model, dev):
    """[verify]: the plan verifier on the served and trained granite-3-8b
    model's plans (:func:`verify_replan`), on a plan on the card
    (:func:`verify_on_card`), and the paper's suite through the kernels
    (:func:`verify_suite`)."""
    replan = verify_replan(model, dev, "[verify granite]")
    verify_on_card(model, dev)
    g_launches, p_launches, g_rec, p_rec = verify_suite(dev)
    return replan, g_launches, p_launches, g_rec, p_rec


# [tune]: the plan tuner on the card.  Granite-3-8b's FFN projections at
# full width (up 4096 -> 12800 from SEED, down 12800 -> 4096 from SEED + 1;
# 64 x 64 blocks at 25 %) at a width of each SpMM path: (path, N, B dtype)
TUNE_CASES = (("split", 4, torch.bfloat16), ("split", 16, torch.bfloat16),
              ("tc", 64, torch.bfloat16), ("tc", 2048, torch.bfloat16),
              ("simt", 64, torch.float32))
#: the knobs the card tells apart, timed for the calibration: each policy,
#: and the segment policy's fold (the only one that folds)
TUNE_CALIBRATION = (("segment", None), ("segment", 8), ("gustavson", None),
                    ("outer", None))
#: a tuned plan may take at most this times the default plan's device time
#: (the best of ``2 * TUNE_ROUNDS`` timings each; card rows agree within ~3 %
#: run to run)
TUNE_SLOWDOWN = 1.10
#: rounds of (default, tuned, tuned, default) timings per comparison: one
#: round let a slow spell of the card fall on both tuned timings (an identical
#: plan measured 1.11 x the default once)
TUNE_ROUNDS = 3


# [check]: the toys' child process gets this long (each toy is milliseconds;
# a toy that stalled an mbarrier would trap after ~9 s)
CHECK_TOY_TIMEOUT = 180
# the checked build's niceness: it runs beside the release build and
# [spgemm], [ops] and [tune] (whose measurements are device times), and
# yields the host to them
CHECKED_BUILD_NICE = 10


def phase_check(dev):
    """[check]: the kernel analyzers over the checked build.  The faulty
    toys of ``csrc/check_toys.cu`` in a child process, each caught by
    exactly its rule (the correct ring and the vmem toy at the default
    limit clean); every shipped path
    (``analysis.jaxpr_lint.shipped_paths``) clean, each holding at least
    one event of every kind its kernels log, its output equal to the
    release kernels' on the same inputs bit for bit."""
    from repro_torch.analysis import jaxpr_lint
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    job = CHECKED_BUILD or build.start_build(release=False, checked=True)
    job.wait()
    print(f"[clock] checked build ({' '.join(build.CHECKED_FLAGS)}, "
          f"{len(build.CHECKED_SOURCES)} libraries): "
          f"{max(job.seconds.values(), default=0.0):.1f} s from its start "
          f"in [build], in the background; [check] waited "
          f"{time.perf_counter() - t0:.1f} s for it; per library "
          + " ".join(f"{Path(k.split()[0]).stem} {v:.0f}" for k, v in
                     sorted(job.seconds.items(), key=lambda kv: -kv[1])))
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.toys"], env=env,
        capture_output=True, text=True, timeout=CHECK_TOY_TIMEOUT)
    toys = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    for r in toys:
        print(f"[check toy] {r['toy']:<20} rules {r['rules']} (want "
              f"{r['want']}) events {r['events']}"
              + (f": {r['messages'][0]}" if r["messages"] else ""))
    check(proc.returncode == 0 and len(toys) == 9
          and all(r["ok"] for r in toys),
          f"[check] toys: rc {proc.returncode}, {len(toys)} results, "
          f"stderr {proc.stderr[-2000:]}")
    t_toys = time.perf_counter() - t0
    reports = jaxpr_lint.analyze_paths(jaxpr_lint.shipped_paths(dev),
                                       compare=True)
    launches = 0
    for r in reports:
        launches += len(r.launches)
        names = sorted({l.name.split(":", 1)[1] for l in r.launches})
        print(f"[check path] {r.label:<26} {len(r.launches)} launch(es) "
              f"{names} events {dict(sorted(r.events.items()))} findings "
              f"{len(r.findings)} release-equal {r.equal}")
        for f in r.findings[:3]:
            print(f"[check path]   {f}")
    bad = [f for r in reports for f in r.findings]
    check(not bad, f"[check] {len(bad)} finding(s) over the shipped paths: "
                   f"{[str(f) for f in bad[:5]]}")
    differ = [(r.label, r.max_diff) for r in reports if not r.equal]
    check(not differ, f"[check] checked outputs differ from the release "
                      f"kernels': {differ}")
    print(f"[check] {len(toys)} toys each caught by exactly its rule "
          f"({t_toys:.1f} s, child process); {len(reports)} shipped paths, "
          f"{launches} checked launches, no finding, every output equal "
          f"to the release kernels' bit for bit")


def _granite_ffn():
    """Granite-3-8b's up and down projection patterns at full width, with
    random values, from ``SEED`` and ``SEED + 1``."""
    from repro_torch.core.formats import BSR
    return {"up": BSR.random(np.random.default_rng(SEED), (12800, 4096),
                             (64, 64), 0.25),
            "down": BSR.random(np.random.default_rng(SEED + 1),
                               (4096, 12800), (64, 64), 0.25)}


def tune_budget(dev, up):
    """The closed forms of ``analysis.budget`` against every compiled
    launcher's own number, exactly, over every instantiation the launchers
    can pick; then a plan one byte under its need raising before any
    launch, and the same plan at the default limit running."""
    from repro_torch import api
    from repro_torch.analysis import budget
    ex = budget.smem_exports()
    modes = ((0, 0), (1, 1), (1, 2), (2, 1), (2, 2))
    rows = []
    for p, s in modes:
        for bm, tn, tr in itertools.product((32, 64), (4, 8, 16, 32), (0, 1)):
            rows.append((f"simt spmm {bm} TN{tn} trans{tr} mode{p}.{s}",
                         ex["segment_spmm_smem_bytes"](bm, tn, tr, p, s),
                         budget.simt_spmm_smem_bytes(bm, tn, bool(tr), p, s)))
        for tn in (4, 8, 16):
            rows.append((f"split TN{tn} mode{p}.{s}",
                         ex["segment_spmm_split_smem_bytes"](tn, p, s),
                         budget.split_spmm_smem_bytes(tn, p, s)))
        for n in (64, 256):
            rows.append((f"tc spmm N{n} mode{p}.{s}",
                         ex["segment_spmm_tc_smem_bytes"](n, p, s),
                         budget.tc_spmm_smem_bytes(n, p, s)))
        for bm, bk, bn in itertools.product((32, 64), repeat=3):
            rows.append((f"simt spgemm {bm}x{bk}x{bn} mode{p}.{s}",
                         ex["segment_spgemm_smem_bytes"](bm, bk, bn, p, s),
                         budget.simt_spgemm_smem_bytes(bm, bk, bn, p, s)))
        rows.append((f"tc spgemm mode{p}.{s}",
                     ex["segment_spgemm_tc_smem_bytes"](p, s),
                     budget.tc_spgemm_smem_bytes(p, s)))
    bad = [r for r in rows if r[1] != r[2]]
    check(not bad, f"[tune budget] closed form != compiled: {bad[:5]}")
    refused = (ex["segment_spmm_smem_bytes"](64, 32, 0, 0, 1),
               ex["segment_spmm_split_smem_bytes"](5, 0, 0),
               ex["segment_spmm_tc_smem_bytes"](64, 3, 1),
               ex["segment_spgemm_smem_bytes"](16, 64, 64, 0, 0),
               ex["segment_spgemm_tc_smem_bytes"](1, 0))
    check(refused == (-1,) * 5, f"[tune budget] refusals {refused}")
    big = max(rows, key=lambda r: r[1])
    print(f"[tune budget] {len(rows)} instantiations: every closed form "
          f"equals its compiled number; largest {big[1]} bytes ({big[0]}) "
          f"of {budget.DEFAULT_VMEM_LIMIT_BYTES}; 5 refusals -1")

    x = torch.randn(64, up.shape[1], device=dev).bfloat16()
    need = budget.plan_vmem_bytes(
        api.plan_matmul(up, 64, with_grad=True, cache=False, device=dev),
        n_cols=64)
    before = _path_counts()
    try:
        api.plan_matmul(up, 64, with_grad=True, cache=False, device=dev,
                        vmem_limit_bytes=need - 1)
        raised = None
    except budget.VmemBudgetError as e:
        raised = str(e)
    check(raised is not None and _path_counts() == before,
          f"[tune budget] {need - 1} bytes: raised {raised!r}, launches "
          f"{_path_counts()} vs {before}")
    plan = api.plan_matmul(up, 64, with_grad=True, cache=False, device=dev,
                           vmem_limit_bytes=budget.DEFAULT_VMEM_LIMIT_BYTES)
    y = plan(x.T)
    torch.cuda.synchronize()
    _check_path("[tune budget] default limit", before, "tc")
    check(bool(torch.isfinite(y).all()), "[tune budget] non-finite output")
    print(f"[tune budget] granite up at N = 64 with its grad plan needs "
          f"{need} bytes (tc, one consumer warpgroup): a limit of "
          f"{need - 1} raised VmemBudgetError with no launch; the default "
          f"limit planned and ran (1 tc launch)")


def _card_work(plan, path, n, b):
    from repro_torch.tune.cost import spmm_card_work
    return spmm_card_work(
        path=path, m=plan.m_idx.cpu().numpy(), valid=plan.valid.cpu().numpy(),
        seg_write=plan.seg_write.cpu().numpy(),
        accum_prev=plan.accum_prev.cpu().numpy(),
        runs=plan.run_offsets.cpu().numpy(), bm=64, bk=64, n=n,
        rhs_dtype=str(b.dtype).removeprefix("torch."))


def _spmm_kern(plan, b):
    from repro_torch.kernels.segment_spmm import segment_spmm
    return lambda: segment_spmm(
        plan.lhs_blocks, plan.slot_idx, plan.m_idx, plan.k_idx,
        plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid, b,
        grid_m=plan.grid_m, n_lanes=plan.n_lanes, unroll=plan.unroll,
        runs=plan.run_offsets, chunks=plan.chunk_offsets)


def _fit(samples, tag):
    """``calibrate`` over ``(bytes, steps, us, label)`` samples, each
    scaled by its own time (so the fit minimizes relative errors, and a
    2 ms sample does not outweigh a 20 µs one); prints the coefficients
    and each sample's residual.  Returns the model."""
    from repro_torch.tune import calibrate
    model = calibrate([(b / us, s / us, 1.0) for b, s, us, _ in samples])
    res = [(model.predict_us(b, s) - us) / us for b, s, us, _ in samples]
    print(f"[tune fit] {tag}: {len(samples)} samples -> bytes_per_us="
          f"{model.bytes_per_us:.6g} step_us={model.step_us:.6g}; residual "
          f"max |{max(abs(r) for r in res):.3f}|, mean "
          f"{sum(abs(r) for r in res) / len(res):.3f}")
    for (b, s, us, label), r in zip(samples, res):
        print(f"[tune fit]   {tag} {label:<34} bytes={b:.0f} steps={s:.0f} "
              f"us={us:.3f} predicted={model.predict_us(b, s):.3f} "
              f"residual={r:+.3f}")
    return model


def _tuned_vs_default(label, kern_d, kern_t, host_s, knobs):
    """Device times of the default and the tuned plan, interleaved (d, t,
    t, d) ``TUNE_ROUNDS`` times; the gate: the tuned plan's best time
    within ``TUNE_SLOWDOWN`` of the default's.  Returns the record."""
    ds, ts = [], []
    for _ in range(TUNE_ROUNDS):
        ds.append(device_ms(kern_d))
        ts.append(device_ms(kern_t))
        ts.append(device_ms(kern_t))
        ds.append(device_ms(kern_d))
    tuned, default = min(ts), min(ds)
    ratio = tuned / default
    t_us = ", ".join(f"{x * 1e3:.2f}" for x in ts)
    d_us = ", ".join(f"{x * 1e3:.2f}" for x in ds)
    print(f"[tune] {label:<34} search {host_s:.3f} s -> {knobs}; tuned "
          f"{tuned * 1e3:.2f} us ({t_us}), default {default * 1e3:.2f} us "
          f"({d_us}), ratio {ratio:.4f}")
    check(ratio <= TUNE_SLOWDOWN, f"[tune] {label}: tuned {tuned:.5f} ms > "
                                  f"{TUNE_SLOWDOWN} x default {default:.5f}")
    return dict(case=label, tuned_ms=tuned, default_ms=default, ratio=ratio,
                host_s=host_s)


def _knobs(res):
    c = res.best.candidate
    return (f"{c.policy} fold={c.fold_len} lanes={c.n_lanes} "
            f"unroll={c.unroll} bn={c.bn}")


def phase_tune(dev):
    """[tune]: the shared-memory budget against the compiled kernels
    (:func:`tune_budget`); the cost model's calibration (every policy ×
    fold of granite-3-8b's FFN patterns on each SpMM path, and of the
    paper's suite A @ Aᵀ on both SpGEMM paths, timed as CUDA-graph
    replays; :func:`~repro_torch.tune.calibrate` per path); then for each
    case and each suite matrix the search under ``"cuda"`` (host seconds),
    its winner against the plain version and the default plan's result,
    and both timed (``TUNE_SLOWDOWN``).  The tuned plans run once more
    through their entry point (``plan(b)``) with the counts set to 0 just
    before; and ``SparseLinear.from_pattern(policy="auto")`` at granite's
    up projection runs forward and ``transpose_lhs`` on the card against
    the ``"reference"`` backend, its searches counted.  Returns the launch
    counts and two kernel records."""
    from repro_torch import api, tune
    from repro_torch.core.formats import BSR
    from repro_torch.models.sparse_ffn import SparseLinear
    from repro_torch.sim import matrices
    from repro_torch.tune.cost import spgemm_card_work

    sg = importlib.import_module("repro_torch.kernels.segment_spgemm")
    sm = importlib.import_module("repro_torch.kernels.segment_spmm")
    api.clear_plan_cache()
    pats = _granite_ffn()
    tune_budget(dev, pats["up"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    # 1. calibration samples: granite's FFN on each SpMM path
    samples = {"split": [], "tc": [], "simt": [], "spgemm_tc": [],
               "spgemm_simt": []}
    bs = {}
    for path, n, dt in TUNE_CASES:
        for name, w in pats.items():
            b = torch.randn(w.shape[1], n, generator=gen, device=dev).to(dt)
            bs[path, n, name] = b
            for policy, fold in TUNE_CALIBRATION:
                plan = api.plan_matmul(w, n, policy=policy, fold_len=fold,
                                       cache=False, device=dev)
                picked = sm.choose_path(n, dt, 64, 64, b.stride(),
                                        b.data_ptr())
                check(picked == path, f"[tune] {name} N={n}: path {picked}")
                work = _card_work(plan, path, n, b)
                us = device_ms(_spmm_kern(plan, b)) * 1e3
                samples[path].append((work["total"], work["steps"], us,
                                      f"{name} N={n} {policy} fold={fold}"))
    # ... and the paper's suite, A @ Aᵀ, on both SpGEMM paths
    suite = matrices.suite(scale_cap=VERIFY_SCALE_CAP)
    mats = {}
    for name, (a, _) in suite.items():
        dense = a.to_dense()
        am = BSR.from_dense(dense, VERIFY_BLOCK)
        at = BSR.from_dense(np.ascontiguousarray(dense.T), VERIFY_BLOCK)
        mats[name] = (am, at, a)
        for policy, fold in TUNE_CALIBRATION:
            g = api.plan_matmul(am, at, policy=policy, fold_len=fold,
                                cache=False, device=dev)
            if g.n_out_blocks == 0:
                continue
            work = spgemm_card_work(
                valid=g.valid.cpu().numpy(),
                seg_write=g.seg_write.cpu().numpy(),
                accum_prev=g.accum_prev.cpu().numpy(),
                runs=g.run_offsets.cpu().numpy(), bm=64, bk=64, bn=64)
            for path in ("tc", "simt"):
                us = device_ms(lambda: _spgemm_call(g, path)) * 1e3
                samples[f"spgemm_{path}"].append(
                    (work["total"], work["steps"], us,
                     f"{name} {policy} fold={fold}"))
    fitted = {path: _fit(s, path) for path, s in samples.items()}
    print("[tune fit] DEFAULT_CUDA = {" + ", ".join(
        f'"{p}": CostModel(bytes_per_us={m.bytes_per_us:.6g}, '
        f'step_us={m.step_us:.6g})' for p, m in fitted.items()) + "}")
    shipped = tune.DEFAULT_CUDA
    print("[tune fit] shipped DEFAULT_CUDA: " + ", ".join(
        f"{p} ({m.bytes_per_us:.6g}, {m.step_us:.6g})"
        for p, m in shipped.items()))

    # 2. tuned vs default, granite's cases
    recs, tuned_plans = [], []
    for path, n, dt in TUNE_CASES:
        for name, w in pats.items():
            b = bs[path, n, name]
            label = f"{name} N={n} {path}"
            t0 = time.perf_counter()
            res = tune.autotune_matmul(
                w, n_cols_hint=n, objective="cuda",
                rhs_dtype=str(dt).removeprefix("torch."))
            host_s = time.perf_counter() - t0
            check(res.objective == "cuda", f"[tune] {label}: objective")
            dflt = api.plan_matmul(w, n, cache=False, device=dev)
            tuned = api.plan_matmul(w, n, cache=False, device=dev,
                                    **res.plan_kwargs())
            y_t, y_d = _spmm_kern(tuned, b)(), _spmm_kern(dflt, b)()
            plain = sm.segment_spmm_plain(
                tuned.lhs_blocks, tuned.slot_idx, tuned.m_idx, tuned.k_idx,
                tuned.valid, b, grid_m=tuned.grid_m)
            rel_p, abs_p = _rel(y_t, plain)
            rel_d, _ = _rel(y_t, y_d)
            del plain
            check(rel_p <= KERNEL_RTOL and rel_d <= KERNEL_RTOL,
                  f"[tune] {label}: tuned vs plain {rel_p:.3g}, vs default "
                  f"{rel_d:.3g} > {KERNEL_RTOL}")
            rec = _tuned_vs_default(label, _spmm_kern(dflt, b),
                                    _spmm_kern(tuned, b), host_s,
                                    _knobs(res))
            rec.update(rel_err=rel_p, max_abs_err=abs_p, path=path,
                       plan=tuned, b=b)
            recs.append(rec)
            tuned_plans.append((tuned, b, path))
    # ... the paper's suite: A @ X (fp32 X, simt) and A @ Aᵀ (tc)
    x_n = VERIFY_N
    suite_g, suite_p = [], []
    for name, (am, at, a) in mats.items():
        x = torch.randn(am.grid[1] * VERIFY_BLOCK[1], x_n, generator=gen,
                        device=dev)
        t0 = time.perf_counter()
        res = tune.autotune_matmul(am, n_cols_hint=x_n,
                                   rhs_dtype="float32")
        host_s = time.perf_counter() - t0
        dflt = api.plan_matmul(am, x_n, cache=False, device=dev)
        tuned = api.plan_matmul(am, x_n, cache=False, device=dev,
                                **res.plan_kwargs())
        y_t = _spmm_kern(tuned, x)()
        rel_p, abs_p = _rel(y_t, sm.segment_spmm_plain(
            tuned.lhs_blocks, tuned.slot_idx, tuned.m_idx, tuned.k_idx,
            tuned.valid, x, grid_m=tuned.grid_m))
        rel_d, _ = _rel(y_t, _spmm_kern(dflt, x)())
        check(rel_p <= KERNEL_RTOL and rel_d <= KERNEL_RTOL,
              f"[tune] suite {name} A @ X: vs plain {rel_p:.3g}, vs default "
              f"{rel_d:.3g}")
        rec = _tuned_vs_default(f"suite {name} A@X simt", _spmm_kern(dflt, x),
                                _spmm_kern(tuned, x), host_s, _knobs(res))
        rec.update(rel_err=rel_p, max_abs_err=abs_p, path="simt")
        suite_p.append(rec)
        tuned_plans.append((tuned, x, "simt"))
        t0 = time.perf_counter()
        res = tune.autotune_matmul(am, at)
        host_s = time.perf_counter() - t0
        dflt = api.plan_matmul(am, at, cache=False, device=dev)
        tuned = api.plan_matmul(am, at, cache=False, device=dev,
                                **res.plan_kwargs())
        if tuned.n_out_blocks == 0:
            continue
        c_t = _spgemm_call(tuned)
        rel_p, abs_p = _rel(c_t, _spgemm_plain(tuned))
        # the C blocks sit at the symbolic pattern, whatever the order
        rel_d, _ = _rel(c_t, _spgemm_call(dflt))
        check(rel_p <= KERNEL_RTOL and rel_d <= KERNEL_RTOL,
              f"[tune] suite {name} A @ Aᵀ: vs plain {rel_p:.3g}, vs "
              f"default {rel_d:.3g}")
        rec = _tuned_vs_default(f"suite {name} A@At tc",
                                lambda: _spgemm_call(dflt),
                                lambda: _spgemm_call(tuned), host_s,
                                _knobs(res))
        rec.update(rel_err=rel_p, max_abs_err=abs_p, path="tc", plan=tuned,
                   out=c_t)
        suite_g.append(rec)
        tuned_plans.append((tuned, None, "spgemm"))

    # 3. the tuned plans through their entry point, counts from 0
    _zero_counts()
    _zero_spgemm_counts()
    for plan, b, _ in tuned_plans:
        plan(b) if b is not None else plan()
    torch.cuda.synchronize()
    spmm_n = sum(b is not None for _, b, _ in tuned_plans)
    spgemm_n = len(tuned_plans) - spmm_n
    got_p, got_g = list(_path_counts()), _spgemm_counts()
    want_tc = sum(p == "tc" for _, b, p in tuned_plans if b is not None)
    want_split = sum(p == "split" for _, _, p in tuned_plans)
    check(got_p == [spmm_n, want_tc, want_split]
          and got_g[0] == got_g[2] == spgemm_n,
          f"[tune] tuned plans' launches: segment_spmm {got_p} != "
          f"({spmm_n}, {want_tc}, {want_split}); segment_spgemm {got_g}")
    print(f"[tune] tuned plans through plan(): segment_spmm {spmm_n} "
          f"launches ({want_tc} tc, {want_split} split, "
          f"{spmm_n - want_tc - want_split} simt), segment_spgemm "
          f"{spgemm_n} (all tc)")

    # 4. through the model: SparseLinear over granite's up pattern
    api.clear_plan_cache()
    up = pats["up"]
    SparseLinear.from_pattern(up, policy="auto", device=dev)
    s1 = api.plan_cache_stats()
    lin = SparseLinear.from_pattern(up, policy="auto", device=dev)
    s2 = api.plan_cache_stats()
    check((s1["searched"], s1["search_cache_hits"]) == (1, 0)
          and (s2["searched"], s2["search_cache_hits"]) == (1, 1),
          f"[tune model] counters {s1} then {s2}")
    xs = torch.randn(64, up.shape[1], generator=gen,
                     device=dev).bfloat16().requires_grad_()
    _zero_counts()
    y = lin(xs)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = _counts()
    check(counts["spmm"] == 2 and counts["spmm_t"] == 1,
          f"[tune model] launches {counts}")
    from repro_torch.api import use_backend
    xr = xs.detach().clone().requires_grad_()
    with use_backend("reference"):
        yr = lin(xr)
        yr.float().square().sum().backward()
    rel_y, _ = _rel(y.detach(), yr.detach())
    rel_dx, _ = _rel(xs.grad, xr.grad)
    check(rel_y <= BF16_RTOL and rel_dx <= BF16_RTOL,
          f"[tune model] cuda vs reference: y {rel_y:.3g}, dx {rel_dx:.3g} "
          f"> {BF16_RTOL}")
    c = lin.plan
    print(f"[tune model] SparseLinear.from_pattern(policy='auto') at granite "
          f"up: plan {c.policy} lanes={c.n_lanes} unroll={c.unroll}; "
          f"searched {s2['searched']}, search_cache_hits "
          f"{s2['search_cache_hits']}; forward + backward at 64 bf16 tokens: "
          f"2 launches ({counts['spmm_tc']} tc, 1 transpose_lhs); vs "
          f"reference y {rel_y:.2e}, dx "
          f"{rel_dx:.2e} (tol {BF16_RTOL})")
    api.clear_plan_cache()
    host = sum(r["host_s"] for r in recs + suite_p + suite_g)
    worst = max(recs + suite_p + suite_g, key=lambda r: r["ratio"])
    print(f"[tune] summary: {len(recs)} granite cases, {len(suite_p)} suite "
          f"A @ X, {len(suite_g)} suite A @ Aᵀ; host search {host:.2f} s in "
          f"all; worst tuned/default {worst['ratio']:.4f} ({worst['case']})")
    # the kernel records of the line: the tuned training-width plan and the
    # suite's largest tuned A @ Aᵀ, each against its plain version again
    tc_case = next(r for r in recs if r["case"] == "up N=2048 tc")
    tc_rec = kernel_case("tuned up", tc_case["plan"], tc_case["b"],
                         tag="tune")
    big = max(suite_g, key=lambda r: int(r["plan"].valid.sum()))
    g_rec = spgemm_case(f"tuned {big['case']}", big["plan"], big["out"])
    counts = dict(spmm=spmm_n, spmm_tc=want_tc, spgemm=spgemm_n)
    return counts, tc_rec, g_rec


# [mixed]: RecurrentGemma-9B's published widths with full-attention layers
# beside its local ones (layer_pattern ("attn", "local")), depth cut 38 -> 4
# to keep the phase short; bf16 activations, block-sparse FFN
MIXED_LAYERS = 4


def phase_mixed(dev):
    """[mixed]: a model with ``"local"`` beside ``"attn"`` layers on the
    card: its cache groups (full-length ``k``/``v``, window rings at
    ``k_local``/``v_local``); ``forward`` over 1 x ``HYBRID_FORWARD_T``
    tokens, its ``flash_attention`` launches counted layer by layer (one
    on ``tc`` per local layer, none per full-attention layer, whose
    attention is chunked torch attention as in ``repro``); forward vs
    stepwise decode; the serve mix through ``Engine``.  Returns the
    forward's launch counts."""
    model = build_family("recurrentgemma-9b", "mixed", dev,
                         layer_pattern=("attn", "local"),
                         n_layers=MIXED_LAYERS, ffn_block_sparse=True,
                         ffn_block=64, ffn_density=0.25)
    cfg = model.cfg
    kinds = model.layer_kinds
    n_sparse = sparse_layers(model)
    cache = model.init_cache(2, 4096)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    kv = (cfg.n_kv, cfg.hd)
    check(shapes == {"k": (2, 2, 4096, *kv), "v": (2, 2, 4096, *kv),
                     "k_local": (2, 2, cfg.local_window, *kv),
                     "v_local": (2, 2, cfg.local_window, *kv)},
          f"[mixed] cache {shapes}")
    del cache
    print(f"[mixed] cache groups: {shapes}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    from repro_torch.kernels.flash_attention import flash_attention
    per_layer = []

    def pre(mod, args, kwargs):
        per_layer.append([flash_attention.tc_launches])

    def post(mod, args, kwargs, out):
        per_layer[-1].append(flash_attention.tc_launches)

    hooks = [blk.register_forward_pre_hook(pre, with_kwargs=True)
             for blk in model.layers]
    hooks += [blk.register_forward_hook(post, with_kwargs=True)
              for blk in model.layers]
    tokens = torch.randint(0, cfg.vocab, (1, HYBRID_FORWARD_T),
                           generator=gen, device=dev)
    n_local = kinds.count("local")
    try:
        fwd, fwd_ms, _, _ = timed_forward(
            model, "mixed", {"flash": n_local, "flash_tc": n_local,
                             "spmm": 3 * n_sparse, "spmm_tc": 3 * n_sparse},
            tokens)
    finally:
        for h in hooks:
            h.remove()
    # the local layers take the kernel; full attention is chunked torch
    # attention, as repro's is
    deltas = [b - a for a, b in per_layer[:len(kinds)]]
    want = [int(k == "local") for k in kinds]
    check(deltas == want, f"[mixed] flash_attention tc launches per layer "
                          f"{list(zip(kinds, deltas))} != {want}")
    print(f"[mixed] forward: flash_attention tc launches per layer "
          f"{list(zip(kinds, deltas))}")
    stepwise_check(model, tokens[:, :HYBRID_CACHE_T], "mixed")
    s = serve_family(model, dev, "mixed", steady=False)
    got = s["counts"]
    check(s["buckets"] == (64, 16) and got["flash"] == 0
          and s["spmm"] == 3 * n_sparse * s["calls"],
          f"[mixed serve] buckets {s['buckets']}, launches {got}")
    print(f"[mixed serve] buckets {s['buckets']}; segment_spmm {s['spmm']} "
          f"launches == 3 x {n_sparse} x {s['calls']} model calls "
          f"({s['split']} split); flash_attention none (cached attention is "
          f"torch)")
    free_model(model)
    return fwd


DIST_LAYERS = 4                # [dist]: granite-3-8b's depth cut 40 -> 4
DIST_STEPS = 3
DIST_ACCUM = 2                 # 8 x 256 tokens a step: 2 microbatches of 4
DIST_MICRO = 4                 # pipeline_forward: 4 microbatches of 2 x 256


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tag, world, timeout):
    """Runs ``world`` processes of this script (``--phase tag --rank R``)
    on the one card, one gloo group on a free local port, and returns each
    rank's numbers (``r<rank>.json`` in a scratch directory).  Every rank's
    log is printed under ``[tag r<rank>]``; the phase fails if a rank does
    not exit with 0 within ``timeout`` seconds, and ranks still running
    then are killed.  Each process's allocator is on
    ``expandable_segments``: the ranks share the card's memory, and
    segments that grow in place keep one's cache from holding blocks the
    others need."""
    import tempfile
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase", tag,
             "--rank", str(r), "--port", str(port), "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, log in enumerate(logs):
            for line in log.splitlines():
                print(f"[{tag} r{r}] {line}")
        for r, p in enumerate(procs):
            tail = "\n".join(logs[r].splitlines()[-8:])
            check(p.returncode == 0, f"[{tag}] rank {r} exited with "
                                     f"{p.returncode}; its last lines:\n"
                                     f"{tail}")
        return [json.load(open(os.path.join(out, f"r{r}.json")))
                for r in range(world)]


def write_repro_checkpoint(directory, step, cfg, state, ffn_patterns):
    """``state`` (a trainer's state dict of full tensors) as ``repro``'s
    trainer writes a checkpoint: the leaves of ``(params, AdamWState)`` in
    ``jax_state_layout``'s order (layers stacked on axis 0), keyed
    ``leaf_%05d`` in ``step_%08d/arrays.npz``, beside the manifest.
    Returns the bytes written."""
    from repro_torch.checkpoint import jax_state_layout
    arrays = {}
    for i, leaf in enumerate(jax_state_layout(cfg, ffn_patterns)):
        ts = [state[n].detach().cpu() for n in leaf.names]
        t = torch.stack(ts) if len(leaf.shape) == ts[0].ndim + 1 else ts[0]
        check(tuple(t.shape) == leaf.shape,
              f"{leaf.path}: shape {tuple(t.shape)} != {leaf.shape}")
        arrays[f"leaf_{i:05d}"] = t.numpy()
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrays),
                   "shapes": [list(a.shape) for a in arrays.values()],
                   "dtypes": [str(a.dtype) for a in arrays.values()]}, f)
    return sum(a.nbytes for a in arrays.values())


def _dist_train(trainer, label, tokens, hook=None):
    """``trainer.run(failure_hook=hook)`` with the launch counts of its run
    and its peak memory above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = trainer.run(failure_hook=hook)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    for h in out["history"]:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"[dist] {label} step {h['step']}: non-finite")
        print(f"[dist] {label} step {h['step']}: loss {h['loss']:.6f}, grad "
              f"norm {h['grad_norm']:.6f}, {h['ms']:.1f} ms/step, "
              f"{tokens * 1e3 / h['ms']:.0f} tokens/s")
    steps = out["history"][1:] or out["history"]
    ms = float(np.median([h["ms"] for h in steps]))
    print(f"[dist] {label}: median {ms:.1f} ms/step; peak "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
          f"{base / 2**30:.2f} GiB resident); segment_spmm {counts['spmm']} "
          f"launches ({counts['spmm_tc']} tc, {counts['spmm_t']} "
          f"transposed)")
    return out["history"], counts


def phase_dist(dev):
    """[dist]: the sharded runtime on an NCCL group of one rank (see the
    module docstring).  Returns the sharded trainer's launch counts and
    the kernel records at its N."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import JaxCheckpoint
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.compression import (init_error_fb,
                                                 make_compressed_dp_step)
    from repro_torch.runtime.elastic import restore_onto_mesh
    from repro_torch.runtime.pipeline_parallel import pipeline_forward

    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        cfg = dataclasses.replace(get_config("granite-3-8b"),
                                  ffn_block_sparse=True, ffn_block=64,
                                  ffn_density=0.25, dtype="bfloat16",
                                  n_layers=DIST_LAYERS)
        shape = ShapeConfig("dist", "train", TRAIN_SEQ, TRAIN_BATCH)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        tcfg = TrainerConfig(steps=DIST_STEPS, log_every=1, warmup=2,
                             accum_steps=DIST_ACCUM)
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        t0 = time.perf_counter()
        plain = Trainer(build_model(cfg, device=dev), cfg, shape, tcfg,
                        seed=SEED)
        sharded = Trainer(build_model(cfg, device=dev), cfg, shape, tcfg,
                          mesh=mesh, seed=SEED)
        n_params = sum(p.numel() for p in plain.params.values())
        print(f"[dist] {cfg.name} full width, {DIST_LAYERS} of 40 layers, "
              f"sparse FFN: {n_params / 1e9:.3f} B fp32 params a trainer; "
              f"plain and sharded (1 x 1 mesh, NCCL, world 1) built in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        master = sharded._step_fn.master
        check(all(master[k].data_ptr() == p.data_ptr()
                  for k, p in sharded.params.items()),
              "[dist] a master shard at world size 1 is not its parameter")
        mlp = plain.model.layers[0].mlp
        pats = {p: (getattr(mlp, p).plan.a_brow.cpu().numpy(),
                    getattr(mlp, p).plan.a_bcol.cpu().numpy())
                for p in ("up", "gate", "down")}

        # (1) plain, writing its state after step 2 in repro's layout, then
        # sharded from the same init
        with tempfile.TemporaryDirectory() as d:
            written = {}

            def writer(step):
                if step == 1:                 # after 2 steps
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    sd = plain.state_dict()
                    written["bytes"] = write_repro_checkpoint(d, 2, cfg, sd,
                                                              pats)
                    written["s"] = time.perf_counter() - t
                    written["probe"] = {
                        k: sd[k].detach().reshape(-1)[:4096].clone()
                        for k in ("params/layers.0.mlp.up.blocks",
                                  "opt/m/embed.table",
                                  f"opt/v/layers.{DIST_LAYERS - 1}.attn.wo.w")}

            want, c_plain = _dist_train(plain, "plain", tokens, writer)
            got, c_sharded = _dist_train(sharded, "sharded", tokens)
            per_step = 3 * DIST_LAYERS * 3 * DIST_ACCUM   # remat fwd x2 + dx
            spmm = {k: v for k, v in c_sharded.items() if "spmm" in k}
            check(spmm == {k: v for k, v in c_plain.items() if "spmm" in k}
                  and spmm["spmm"] == per_step * DIST_STEPS
                  and spmm["spmm_tc"] == spmm["spmm"]
                  and spmm["spmm_t"] == spmm["spmm"] // 3,
                  f"[dist] SpMM launches sharded {spmm} vs plain "
                  f"{c_plain}; want {per_step} x {DIST_STEPS}, all tc, a "
                  f"third transposed")
            for g, w in zip(got, want):
                err = abs(g["loss"] - w["loss"]) / abs(w["loss"])
                check(err <= LOSS_RTOL, f"[dist] step {g['step']} loss "
                                        f"sharded vs plain {err:.3g}")
            dmax = max(float((p.detach() - q.detach()).abs().max())
                       for p, q in zip(sharded.params.values(),
                                       plain.params.values()))
            errs = [f"{abs(g['loss'] - w['loss']) / abs(w['loss']):.2e}"
                    for g, w in zip(got, want)]
            print(f"[dist] sharded vs plain over {DIST_STEPS} steps: loss "
                  f"errors {errs} (tol {LOSS_RTOL}); max parameter "
                  f"difference {dmax:.3e}; SpMM launches equal: {spmm}")

            # (2) the sharded trainer resumes from the repro-layout
            # checkpoint and takes step 3
            t = time.perf_counter()
            sd = restore_onto_mesh(JaxCheckpoint(d, cfg, pats), 2,
                                   sharded.state_dict(), mesh)
            sharded.load_state_dict(sd)
            del sd
            read_s = time.perf_counter() - t
        state = sharded.state_dict()
        for k, v in written["probe"].items():
            check(torch.equal(state[k].to_local().reshape(-1)[:4096], v),
                  f"[dist] {k} after the checkpoint round trip")
        check(sharded.opt_state.step == 2, "[dist] restored step "
                                           f"{sharded.opt_state.step} != 2")
        sharded.start_step = 2
        resumed, _ = _dist_train(sharded, "resumed", tokens)
        err = abs(resumed[0]["loss"] - want[2]["loss"]) / abs(want[2]["loss"])
        print(f"[dist] repro-layout checkpoint: {written['bytes'] / 1e9:.2f} "
              f"GB written in {written['s']:.1f} s, restored onto the mesh in "
              f"{read_s:.1f} s; resumed step 3 loss {resumed[0]['loss']:.6f} "
              f"vs uninterrupted {want[2]['loss']:.6f} (rel {err:.3e}, tol "
              f"{LOSS_RTOL})")
        check(err <= LOSS_RTOL, f"[dist] resumed step 3 loss {err:.3g}")

        # (3) compressed DP and the pipeline at world size 1
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        w_true = torch.randn(cfg.d_model, generator=gen, device=dev)
        xs = [torch.randn(256, cfg.d_model, generator=gen, device=dev)
              for _ in range(3)]

        def lsq(params, batch):
            x, y = batch
            return torch.mean((x @ params["w"] - y) ** 2)

        for method in ("int8", "topk"):
            opt = AdamW(lr=constant(0.05), weight_decay=0.0)
            params = {"w": torch.zeros(cfg.d_model, device=dev)}
            state = (params, opt.init(params), init_error_fb(params))
            step = make_compressed_dp_step(lsq, opt, mesh, method=method)
            ref = {"w": torch.zeros(cfg.d_model, device=dev)}
            ref_opt, ef = opt.init(ref), torch.zeros(cfg.d_model, device=dev)
            for x in xs:
                state, loss = step(state, (x, x @ w_true))
                leaf = ref["w"].detach().requires_grad_(True)
                g = torch.autograd.grad(lsq({"w": leaf}, (x, x @ w_true)),
                                        leaf)[0] + ef
                if method == "int8":
                    s = g.abs().max() / 127.0 + 1e-12
                    sent = torch.clamp(torch.round(g / s), -127, 127) * s
                else:
                    k = max(1, int(g.numel() * 0.1))
                    kth = g.abs().sort(descending=True).values[k - 1]
                    sent = g * (g.abs() >= kth)
                ef = g - sent
                opt.update({"w": sent}, ref_opt, ref)
            e_w, _ = _rel(state[0]["w"], ref["w"])
            e_ef, _ = _rel(state[2]["w"], ef)
            print(f"[dist] make_compressed_dp_step {method}: 3 steps, loss "
                  f"{float(loss):.4f}; weights vs the plain steps {e_w:.2e}, "
                  f"error feedback {e_ef:.2e} (tol {KERNEL_RTOL})")
            check(e_w <= KERNEL_RTOL and e_ef <= KERNEL_RTOL,
                  f"[dist] compressed {method}: {e_w:.3g} / {e_ef:.3g}")

        stage_mesh = make_mesh((1,), ("stage",), device="cuda")
        blocks = sharded.model.layers[:2]

        def stage_fn(_, a):
            pos = torch.arange(a.shape[1], device=dev).expand(a.shape[0], -1)
            for blk in blocks:
                a, _ = blk(a, positions=pos)
            return a

        x = torch.randn(DIST_MICRO, 2, TRAIN_SEQ, cfg.d_model, generator=gen,
                        device=dev).bfloat16()
        with torch.no_grad():
            out = pipeline_forward(stage_fn, torch.zeros(1, device=dev), x,
                                   mesh=stage_mesh, n_micro=DIST_MICRO)
            seq = torch.stack([stage_fn(None, x[i])
                               for i in range(DIST_MICRO)])
        e, _ = _rel(out, seq)
        print(f"[dist] pipeline_forward, 1 stage of 2 layers, {DIST_MICRO} "
              f"microbatches of 2 x {TRAIN_SEQ}: vs sequential {e:.2e}")
        check(bool(torch.isfinite(out).all()) and e <= KERNEL_RTOL,
              f"[dist] pipeline vs sequential {e:.3g}")

        # (4) the collectives of the sharded runtime on NCCL.  At world
        # size 1 the trainer calls none of them (it skips every mesh dim of
        # one rank), so they are called here: on the trainer's tensors in
        # bf16 and fp32, gathered / scattered along a non-leading dim of a
        # transposed (non-contiguous) view, each result equal to its input
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.sharding.rules import _all_gather, _reduce_scatter
        group = mesh.get_group(0)
        n_coll = 0
        for dtype in (torch.bfloat16, torch.float32):
            for k in ("embed.table", "layers.0.attn.wq.w",
                      "layers.0.mlp.up.blocks"):
                x = sharded.params[k].detach().to(dtype).transpose(0, -1)
                dim = x.ndim - 1
                outs = {"all_gather_into_tensor": _all_gather(x, dim, 1,
                                                              group),
                        "reduce_scatter_tensor": _reduce_scatter(x, dim, 1,
                                                                 group)}
                # NCCL takes only contiguous tensors: the all-reduce of
                # Sharding.reduce_scatter copies into a contiguous one too
                r = x.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(r, group=group)
                outs["all_reduce"] = r
                outs["full_tensor"] = DTensor.from_local(
                    x.contiguous(), mesh, (Shard(dim), Shard(0)),
                    run_check=False).full_tensor()
                for name, y in outs.items():
                    check(y.dtype == dtype and torch.equal(y, x),
                          f"[dist] NCCL {name} of {k} ({dtype}) != input")
                    n_coll += 1
        loss = torch.tensor(3.0, device=dev)
        dist.all_reduce(loss, group=group)     # as the dp mean of the loss
        check(float(loss) == 3.0, "[dist] NCCL all_reduce of a scalar")
        torch.cuda.synchronize()
        print(f"[dist] NCCL collectives, world size 1: {n_coll + 1} calls "
              f"(all_gather_into_tensor, reduce_scatter_tensor, all_reduce, "
              f"DTensor.full_tensor on embed.table, wq.w and up.blocks "
              f"transposed, bf16 and fp32, along the last dim; a scalar "
              f"all_reduce), each equal to its input bit for bit")

        # the SpMM kernel vs plain at the trainer's N (a microbatch of
        # 4 x 256 tokens), forward and dx, on layer 0's up plan
        up = mlp.up.plan.with_values(mlp.up.blocks.data)
        n = TRAIN_BATCH // DIST_ACCUM * TRAIN_SEQ
        xk = torch.randn(n, cfg.d_model, generator=gen, device=dev)
        dy = torch.randn(n, cfg.d_ff, generator=gen, device=dev)
        recs = [kernel_case("up", up, xk.bfloat16().T, tag="dist"),
                kernel_case("up dx (transpose_lhs)", up, dy.bfloat16().T,
                            transpose=True, tag="dist")]
        check(all(r["path"] == "tc" for r in recs),
              f"[dist] kernel paths {[r['path'] for r in recs]}")
        # nothing of granite's stays on the card after the phase: the
        # collectives' inputs and outputs went through NCCL's streams
        del plain, sharded, blocks, state, up, outs, x, r, out, seq, xs, \
            xk, dy, mlp, master
        return c_sharded, recs
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


# [tp]: RecurrentGemma-9B at published width, its depth cut 38 -> 3 (one
# (rec, rec, local) unit, the block-sparse FFN, remat), on 1 x 4096 tokens:
# two gloo ranks on the one card, tensor parallel on a (1, 2) mesh, against
# a world-size-1 run of the same model and batch
TP_LAYERS = 3
TP_T = 4096
TP_STEPS = 2
TP_WORLD = 2
TP_TIMEOUT = 600               # seconds for both ranks, the model builds in


def tp_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("recurrentgemma-9b"), dtype="bfloat16",
        n_layers=TP_LAYERS, ffn_block_sparse=True, ffn_block=64,
        ffn_density=0.25)


def _tp_run(model, cfg, dev, mesh=None, t=TP_T, steps=TP_STEPS):
    """One gradient step (loss, gradients off the parameters; the launches
    it makes are not counted), then ``steps`` ``Trainer`` steps on 1 x
    ``t`` tokens from the same initial state with their launch counts,
    step times and peak memory above what was allocated before."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    shape = ShapeConfig("tp", "train", t, 1)
    trainer = Trainer(model, cfg, shape, TrainerConfig(
        steps=steps, log_every=1, warmup=1), mesh=mesh, seed=SEED)
    loss, grads = _grads_on(model, trainer._batch(0), "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    hist = trainer.run()["history"]
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    return trainer, loss, grads, hist, counts, peak


def _tp_kernels(model, dev):
    """Each kernel of the split step against its plain version on random
    inputs at the shapes a rank gives it (one launch each, on the path the
    step takes): ``rg_lru`` and ``rg_lru_bwd`` over (1, 4096, 2048),
    ``flash_attention`` and its backward with 8 query heads on one KV head
    (D = 256, window 2048), the replicated sparse FFN's SpMM at N = 4096,
    forward and ``transpose_lhs``.  Returns ``{kernel: (path, rel err)}``."""
    from repro_torch.kernels.rg_lru import (choose_bwd_path, choose_path,
                                            rg_lru, rg_lru_bwd,
                                            rg_lru_bwd_plain, rg_lru_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    cfg = model.cfg
    rec = next(b.rec for b in model.layers if hasattr(b, "rec"))
    attn = next(b.attn for b in model.layers if hasattr(b, "attn"))
    d = rec.a_param.shape[0] // rec.tp.size
    out = {}

    def rand(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    bf = torch.bfloat16
    x, ag, xg = (rand(1, TP_T, d, dt=bf) for _ in range(3))
    a_param, h0 = rand(d), torch.zeros(1, d, device=dev)
    _zero_counts()
    got = rg_lru(x, ag, xg, a_param, h0, ct=TP_T)
    c = _counts()
    want = rg_lru_plain(x, ag, xg, a_param, h0)
    path = choose_path(1, TP_T, d, bf, bf, bf)
    check(c["rg_lru"] == 1 and c["rg_lru_tile"] == int(path == "tile"),
          f"[tp] rg_lru launches {c}")
    errs = [_rel(g, w)[0] for g, w in zip(got, want)]
    check(max(errs[0] / BF16_RTOL, errs[1] / KERNEL_RTOL) <= 1,
          f"[tp] rg_lru kernel vs plain {errs}")
    out["rg_lru"] = (path, errs)
    with torch.no_grad():
        hs, _ = rg_lru(x.float(), ag, xg, a_param, h0, ct=TP_T)
    args = (x, ag, xg, a_param, h0, hs, rand(1, TP_T, d, dt=bf), rand(1, d))
    _zero_counts()
    got = rg_lru_bwd(*args)
    c = _counts()
    want = rg_lru_bwd_plain(*args)
    path = choose_bwd_path(d, (bf,) * 3)
    check(c["rg_lru_bwd"] == 1 and c["rg_lru_bwd_tile"] == int(
        path == "tile"), f"[tp] rg_lru_bwd launches {c}")
    errs = [_rel(g, w)[0] for g, w in zip(got, want)]
    for g, e in zip(got, errs):
        check(e <= (KERNEL_RTOL if g.dtype == torch.float32 else BF16_RTOL),
              f"[tp] rg_lru_bwd kernel vs plain {errs}")
    out["rg_lru_bwd"] = (path, errs)
    out.update(_attn_local_kernels(attn.n_heads, attn.n_kv, attn.head_dim,
                                   TP_T, cfg.local_window, dev, gen, "tp"))
    mlp = next(b.mlp for b in model.layers if hasattr(b, "attn"))
    b_in = rand(cfg.d_model, TP_T, dt=bf)
    plan = mlp.up.plan.with_values(mlp.up.blocks.data)
    fwd = kernel_case("sparse FFN up", plan, b_in, library=False, tag="tp")
    b_dx = rand(cfg.d_ff, TP_T, dt=bf)
    dx = kernel_case("sparse FFN up dx", plan, b_dx, transpose=True,
                     library=False, tag="tp")
    out["segment_spmm"] = (fwd["path"], [fwd["rel_err"]])
    out["segment_spmm.transpose_lhs"] = (dx["path"], [dx["rel_err"]])
    return out


def _attn_local_kernels(h, hkv, hd, t, window, dev, gen, tag):
    """``flash_attention`` (``tc``, with its row statistics) and its
    backward on random bf16 inputs at one rank's heads (``h`` query heads
    on ``hkv`` KV heads, head dim ``hd``, 1 x ``t`` tokens, causal within
    ``window``), one launch each, held against their plain versions.
    Returns ``{kernel: (path, rel errs)}``."""
    from repro_torch.kernels import ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    bf = torch.bfloat16

    def rand(*shape, scale=0.5):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf)

    out = {}
    q = rand(1, t, h, hd)
    k, v = (rand(1, t, hkv, hd) for _ in range(2))
    qh, kh, vh, kw = ops.stack_heads(q, k, v)
    kw.update(causal=True, window=window)
    _zero_counts()
    o, stats = fa._forward(qh, kh, vh, kw, bf, None, stats=True)
    c = _counts()
    wo, wstats = fa.flash_attention_plain(qh, kh, vh, out_dtype=bf,
                                          stats=True, **kw)
    check(c["flash"] == 1 and c["flash_tc"] == 1,
          f"[{tag}] flash_attention launches {c}")
    errs = [_rel(o, wo)[0], _rel(stats, wstats)[0]]
    check(errs[0] <= BF16_RTOL and errs[1] <= KERNEL_RTOL,
          f"[{tag}] flash_attention kernel vs plain {errs}")
    out["flash_attention"] = ("tc", errs)
    args = (qh, kh, vh, o, rand(*o.shape, scale=1.0), stats)
    _zero_counts()
    got = fa.flash_attention_bwd(*args, **kw)
    c = _counts()
    want = fa.flash_attention_bwd_plain(*args, **kw)
    check(c["flash_bwd"] == 1 and c["flash_bwd_tc"] == 1,
          f"[{tag}] flash_attention_bwd launches {c}")
    errs = [_rel(g, w)[0] for g, w in zip(got, want)]
    check(max(errs) <= BF16_RTOL,
          f"[{tag}] flash_attention_bwd kernel vs plain {errs}")
    out["flash_attention_bwd"] = ("tc", errs)
    return out


def tp_rank(rank, port, out_dir, dev=None):
    """One rank of [tp] (``chip_smoke.py --phase tp --rank R``): rank 0
    first runs the model at world size 1 while rank 1 waits; then both run
    it split on the (1, 2) mesh.  Rank 0 holds the split run to the
    world-size-1 one and checks the kernels at the local shapes; each rank
    writes its numbers to ``out_dir/r<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.tensor_parallel import gather_full

    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=TP_WORLD, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    cfg = tp_config()
    res = {"rank": rank}
    if rank == 0:
        model = build_model(cfg, device=dev)
        trainer, loss, grads, hist, counts, peak = _tp_run(model, cfg, dev)
        one = {"loss": loss, "hist": hist, "counts": counts, "peak": peak,
               "grads": {k: g.cpu() for k, g in grads.items()}}
        del model, trainer, grads
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[tp] world size 1: loss {loss:.5f}; steps " + ", ".join(
            f"{h['loss']:.5f} / {h['grad_norm']:.5f} / {h['ms']:.1f} ms"
            for h in hist) + f"; peak {peak / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    dist.barrier()
    mesh = make_mesh((1, TP_WORLD), ("data", "model"), device=dev.type)
    model = build_model(cfg, device=dev, mesh=mesh)
    check(model.tp.size == TP_WORLD and not model.tp_gathered,
          f"[tp] rank {rank}: split {model.tp}, gathered "
          f"{model.tp_gathered}")
    trainer, loss, grads, hist, counts, peak = _tp_run(model, cfg, dev,
                                                       mesh)
    split = model.tp_local_params()
    errs = {}
    for k in sorted(grads):
        g = (gather_full(grads[k], split[k][0], model.tp) if k in split
             else grads[k])
        if rank == 0:
            errs[k] = _fro(g, one["grads"][k].to(dev))
    res.update(loss=loss, hist=hist, counts=counts, peak=peak,
               local={k: [list(model.get_parameter(k).shape), list(full)]
                      for k, (_, full) in split.items()})
    if rank == 0:
        del one["grads"]
        res["one"] = one
        res["grad_errs"] = errs
    del grads, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        res["kernels"] = _tp_kernels(model, dev)
    dist.barrier()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def free_parent(tag):
    """Before a phase whose ranks share the card: the plan cache dropped,
    garbage collected and the allocator's cache emptied; prints the card's
    free memory, what this process still holds and its largest live
    tensors."""
    from repro_torch.api import clear_plan_cache
    clear_plan_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = sorted((t.untyped_storage().nbytes(), tuple(t.shape), t.dtype)
                  for t in gc.get_objects()
                  if type(t) in (torch.Tensor, torch.nn.Parameter)
                  and t.is_cuda)[::-1][:4]
    print(f"[{tag}] card memory before the ranks start: {free / 1e9:.2f} of "
          f"{total / 1e9:.2f} GB free; this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; its "
          f"largest live tensors: " + (", ".join(
              f"{shape} {str(dt)[6:]} {n / 1e9:.3f} GB"
              for n, shape, dt in held) or "none"))


def phase_tp(dev):
    """[tp]: two processes on the one card (gloo with CUDA tensors; NCCL
    refuses two ranks on one device), RecurrentGemma-9B at published width
    and 3 layers split tensor parallel on a (1, 2) mesh, 2 ``Trainer``
    steps on 1 x 4096 tokens, against a world-size-1 run of the same model
    and batch: loss, norm and every gradient within the training gates,
    each rank's exact launches per path (``rg_lru`` on ``tile`` over 2048
    channels, ``flash_attention`` on ``tc`` with 8 query heads on 1 KV
    head, both backward kernels, the replicated sparse FFN's SpMM as at
    world size 1), each kernel against its plain version at the local
    shapes, peak memory per rank.  The step times are printed as
    information only: two ranks share one card and gloo stages every
    collective through the host."""
    t0 = time.perf_counter()
    ranks = _run_ranks("tp", TP_WORLD, TP_TIMEOUT)
    _tp_report(ranks)
    print(f"[tp] phase {time.perf_counter() - t0:.1f} s")
    return ranks


def _tp_report(ranks):
    """[tp]'s gates over the ranks' numbers (see :func:`phase_tp`)."""
    cfg = tp_config()
    one = ranks[0]["one"]
    kinds = tuple(cfg.layer_kind(i) for i in range(cfg.n_layers))
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    per_step = dict(rg_lru=2 * n_rec, rg_lru_tile=2 * n_rec,
                    rg_lru_bwd=n_rec, rg_lru_bwd_tile=n_rec,
                    flash=2 * n_local, flash_tc=2 * n_local,
                    flash_bwd=n_local, flash_bwd_tc=n_local,
                    spmm=3 * n_local * 3, spmm_tc=3 * n_local * 3,
                    spmm_t=3 * n_local)
    want = {k: v * TP_STEPS for k, v in per_step.items()}
    for r, res in enumerate(ranks):
        bad = {k: (res["counts"][k], v) for k, v in want.items()
               if res["counts"][k] != v}
        check(not bad and res["counts"] == one["counts"],
              f"[tp] rank {r}: launches (got, expected) {bad}; world size "
              f"1 {one['counts']}")
        for name, (shape, full) in res["local"].items():
            check(sum(a != b for a, b in zip(shape, full)) == 1 and
                  math.prod(shape) * TP_WORLD == math.prod(full),
                  f"[tp] rank {r}: {name} local {shape} of {full}")
        for h, w in zip(res["hist"], one["hist"]):
            le = abs(h["loss"] - w["loss"]) / abs(w["loss"])
            ne = abs(h["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            print(f"[tp] rank {r} step {h['step']}: loss {h['loss']:.5f} "
                  f"(world size 1 {w['loss']:.5f}, err {le:.2e}), grad norm "
                  f"{h['grad_norm']:.5f} ({w['grad_norm']:.5f}, err "
                  f"{ne:.2e}), {h['ms']:.1f} ms (world size 1 "
                  f"{w['ms']:.1f} ms; information only)")
            check(le <= LOSS_RTOL and ne <= GNORM_RTOL,
                  f"[tp] rank {r} step {h['step']}: loss err {le:.3g}, "
                  f"norm err {ne:.3g}")
        print(f"[tp] rank {r}: peak {res['peak'] / 2**30:.2f} GiB above "
              f"its model (world size 1 {one['peak'] / 2**30:.2f} GiB); "
              f"{len(res['local'])} split parameters; launches per step "
              f"{ {k: v // TP_STEPS for k, v in res['counts'].items() if v} }")
    le = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    check(le <= LOSS_RTOL, f"[tp] gradient step loss err {le:.3g}")
    errs = ranks[0]["grad_errs"]
    worst = max(errs, key=errs.get)
    print(f"[tp] gradients vs world size 1 (norm-relative, tol {GRAD_RTOL}):"
          f" {len(errs)} parameters, worst {worst} {errs[worst]:.3e}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items())
                      if k.startswith("layers.2.") or "embed" in k))
    check(errs[worst] <= GRAD_RTOL, f"[tp] {worst} gradient err "
                                    f"{errs[worst]:.3g}")
    for name, (path, e) in ranks[0]["kernels"].items():
        print(f"[tp] {name} at the local shapes on {path}: kernel vs plain "
              + ", ".join(f"{x:.2e}" for x in e))
    print(f"[tp] summary: {cfg.name} full width, {cfg.n_layers} layers, "
          f"1 x {TP_T} tokens, (1, {TP_WORLD}) mesh on one card over gloo")


# [zero3]: Phi-3.5-MoE at its published widths, its depth cut 32 -> 1, on a
# (2, 2) data x model mesh of four gloo ranks sharing the card: experts
# split over model, every parameter held as its rule shard and gathered a
# unit at a time; one row of 1024 tokens a dp rank.  In fp32: in bf16 the
# split's other rounding moves some tokens' top-2 choices, and the
# world-size-1 comparison then sees the routing, not the sharding (bf16,
# step 1: loss 1.46e-3 and norm 9.39e-3 off world size 1)
# (one layer: a split step's gloo collectives grow with the depth, ~27 s
# a step at two, and the smoke's time limit is shared by every phase)
ZERO3_LAYERS = 1
ZERO3_T = 1024
ZERO3_STEPS = 2
ZERO3_SIZES = (2, 2)
ZERO3_WORLD = ZERO3_SIZES[0] * ZERO3_SIZES[1]
ZERO3_TIMEOUT = 900            # seconds for all ranks, the models build in


def zero3_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                               n_layers=ZERO3_LAYERS, dtype="float32")


def _zero3_trainer(model, cfg, mesh=None):
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    shape = ShapeConfig("zero3", "train", ZERO3_T, ZERO3_SIZES[0])
    return Trainer(model, cfg, shape, TrainerConfig(
        steps=ZERO3_STEPS, log_every=1, warmup=1), mesh=mesh, seed=SEED)


def _zero3_grads(trainer):
    """One gradient step on the trainer's step-0 batch: the loss (the mean
    over dp) and ``{name: (full gradient, reduced)}`` read one parameter
    at a time through ``yield``: on a mesh each gradient is the mean over
    dp reduced into its shard as autograd accumulates it, then gathered
    full (a collective every rank makes in the same order)."""
    from repro_torch.runtime.train_loop import _dp_mean
    model = trainer.model
    z = model.zero3
    batch = trainer._batch(0)
    if z is None:
        loss, grads = _grads_on(model, batch, "cuda")
        return loss, ((k, grads[k]) for k in sorted(grads))
    shards = {}
    z.on_grad = shards.__setitem__
    loss, _ = model.loss_fn(batch)
    loss.backward()
    z.on_grad = None
    z.after_backward()
    loss = float(_dp_mean(loss.detach(), trainer.mesh))
    return loss, ((k, z.shardings[k].gather_full(shards.pop(k)))
                  for k in sorted(z.master))


def _rule_shard_bytes(z):
    """This rank's parameter bytes by the rules: each parameter's full
    size over the mesh sizes its spec shards it on."""
    full = z.model.full_shapes()
    total = 0
    for k, sh in z.shardings.items():
        div = math.prod(n for _, _, n, _ in sh._sharded(True))
        total += math.prod(full[k]) // div * z.params[k].element_size()
    return total


def zero3_rank(rank, port, out_dir, dev=None):
    """One rank of [zero3] (``chip_smoke.py --phase zero3 --rank R``):
    rank 0 first runs the model at world size 1 while the others wait, keeping
    its gradients on the host; then all four run it on the (2, 2) mesh.
    Rank 0 holds each gathered gradient to world size 1's and checks the
    attention kernels at a rank's local shapes; each rank writes its
    numbers to ``out_dir/r<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.roofline import CommRecorder
    from repro_torch.sharding.zero3 import unit_of

    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=ZERO3_WORLD,
        timeout=datetime.timedelta(seconds=ZERO3_TIMEOUT))
    cfg = zero3_config()
    res = {"rank": rank}
    if rank == 0:
        trainer = _zero3_trainer(build_model(cfg, device=dev), cfg)
        loss, grads = _zero3_grads(trainer)
        one_grads = {k: g.cpu() for k, g in grads}
        del grads
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hist = trainer.run()["history"]
        peak = torch.cuda.max_memory_allocated()
        res["one"] = {"loss": loss, "hist": hist, "peak": peak,
                      "base": base}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[zero3] world size 1: loss {loss:.5f}; steps " + ", ".join(
            f"{h['loss']:.5f} / {h['grad_norm']:.5f} / {h['ms']:.1f} ms"
            for h in hist) + f"; peak {peak / 2**30:.2f} GiB", flush=True)
    dist.barrier()
    mesh = make_mesh(ZERO3_SIZES, ("data", "model"), device=dev.type)
    t0 = time.perf_counter()
    # each rank builds the whole model on the card before splitting it:
    # one rank at a time, its freed blocks handed back before the next
    for r in range(ZERO3_WORLD):
        if r == rank:
            model = build_model(cfg, device=dev, mesh=mesh)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    trainer = _zero3_trainer(model, cfg, mesh)
    z = model.zero3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    print(f"[zero3] rank {rank}: built in {res['build_s']:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved",
          flush=True)
    res["experts"] = [list(b.moe.expert_span()) for b in model.layers]
    res["gathered"] = sorted(model.tp_gathered)
    torch.cuda.reset_peak_memory_stats()
    loss, grads = _zero3_grads(trainer)
    errs = {}
    for k, g in grads:
        if rank == 0:
            errs[k] = _fro(g, one_grads.pop(k).to(dev))
        del g
    res["grad_loss"] = loss
    print(f"[zero3] rank {rank}: gradient step, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    if rank == 0:
        res["grad_errs"] = errs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    res["between"] = z.param_bytes()
    res["rule_shards"] = _rule_shard_bytes(z)
    torch.cuda.reset_peak_memory_stats()
    z.log = []
    _zero_counts()
    with CommRecorder() as comm:
        hist = trainer.run()["history"]
    torch.cuda.synchronize()
    res["counts"] = _counts()
    res["peak"] = torch.cuda.max_memory_allocated()
    res["base"] = base
    res["after"] = z.param_bytes()
    res["held_after"] = [k for k in z.axes
                         if z.params[k].untyped_storage().nbytes()]
    ops = [op for op, _ in comm.records]
    res["ops"] = {op: ops.count(op) for op in set(ops)}
    res["want_gathers"] = sum(z.gather_counts(u) for u, _ in z.log)
    res["log"] = z.log[:len(z.log) // ZERO3_STEPS]
    res["want_scatters"] = z.reduce_scatters() * ZERO3_STEPS
    res["reserved_peak"] = torch.cuda.max_memory_reserved()
    res["units"] = {u: z.unit_bytes(u) for u in z.units}
    res["hist"] = hist
    res["held_units"] = sorted({unit_of(k) for k in z.axes})
    del trainer, grads
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        tp = ZERO3_SIZES[1]
        res["kernels"] = _attn_local_kernels(
            cfg.n_heads // tp, cfg.n_kv // tp, cfg.hd, ZERO3_T, None, dev,
            gen, "zero3")
    dist.barrier()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_zero3(dev):
    """[zero3]: four processes on the one card (gloo with CUDA tensors),
    Phi-3.5-MoE at published widths and 1 layer (fp32) on a (2, 2)
    data x model mesh, 2 ``Trainer`` steps on 2 x 1024 tokens (one row a
    dp rank, remat), against a world-size-1 run of the same model and
    batch: loss, norm and every gradient (gathered full) under [tp]'s
    gates; each
    rank's experts (8 of 16); its parameter bytes between steps equal to
    the sum of its rule shards; its allocator peak beside what holding
    every unit gathered at once would add; its all-gathers and
    reduce-scatters in a step against the count the units give;
    ``flash_attention`` (``tc``) and its backward at a rank's heads (16
    query heads on 4 KV heads, D = 128) against their plain versions.  The
    step times are information only: four ranks share one card and gloo
    stages every collective through the host."""
    t0 = time.perf_counter()
    ranks = _run_ranks("zero3", ZERO3_WORLD, ZERO3_TIMEOUT)
    _zero3_report(ranks)
    print(f"[zero3] phase {time.perf_counter() - t0:.1f} s")
    return ranks


def _zero3_report(ranks):
    """[zero3]'s gates over the ranks' numbers (see :func:`phase_zero3`)."""
    from repro_torch.sharding.rules import BUCKET_BYTES
    cfg = zero3_config()
    one = ranks[0]["one"]
    e_loc = cfg.n_experts // ZERO3_SIZES[1]
    gb = 1e9
    for r, res in enumerate(ranks):
        m = r % ZERO3_SIZES[1]               # the model coordinate
        check(res["experts"] == [[m * e_loc, (m + 1) * e_loc]] * ZERO3_LAYERS,
              f"[zero3] rank {r}: experts {res['experts']}")
        check(all(k.endswith(".moe.router") for k in res["gathered"]),
              f"[zero3] rank {r}: computed whole {res['gathered']}")
        check(res["between"] == res["after"] == res["rule_shards"]
              and not res["held_after"],
              f"[zero3] rank {r}: parameter bytes between steps "
              f"{res['between']} / {res['after']}, rule shards "
              f"{res['rule_shards']}, held {res['held_after'][:4]}")
        units = res["units"]
        largest = max(units.values())
        total = sum(units.values())
        peak = res["peak"]
        gather_all = peak - largest + total
        sizes = ", ".join(f"{u} {b / gb:.2f}"
                          for u, b in sorted(units.items()))
        print(f"[zero3] rank {r}: experts {res['experts'][0]} of "
              f"{cfg.n_experts}; parameter bytes between steps "
              f"{res['between']} = the sum of its rule shards "
              f"{res['rule_shards']}; allocator peak {peak / gb:.2f} GB "
              f"({res['base'] / gb:.2f} GB resident between steps: masters "
              f"and moments; {res['reserved_peak'] / gb:.2f} GB reserved at "
              f"most); units {sizes} GB (sum {total / gb:.2f}); "
              f"every unit gathered at once "
              f"{gather_all / gb:.2f} GB; built in {res['build_s']:.1f} s")
        check(peak < gather_all, f"[zero3] rank {r}: peak {peak} not below "
                                 f"{gather_all}")
        steps = len(res["hist"])
        rs_want = res["want_scatters"]
        ag = res["ops"].get("all-gather", 0)
        print(f"[zero3] rank {r}: collectives in {steps} steps "
              f"{res['ops']}; all-gathers {ag} (the units give "
              f"{res['want_gathers']}: {[u for u, _ in res['log']]} a "
              f"step), reduce-scatters {res['ops'].get('reduce-scatter', 0)}"
              f" (a data-sharded gradient's slices of at most "
              f"{BUCKET_BYTES >> 20} MiB each, in {steps} steps: {rs_want})")
        check(ag == res["want_gathers"]
              and res["ops"].get("reduce-scatter", 0) == rs_want,
              f"[zero3] rank {r}: collectives {res['ops']}")
        for h, w in zip(res["hist"], one["hist"]):
            le = abs(h["loss"] - w["loss"]) / abs(w["loss"])
            ne = abs(h["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            print(f"[zero3] rank {r} step {h['step']}: loss {h['loss']:.5f} "
                  f"(world size 1 {w['loss']:.5f}, err {le:.2e}), grad norm "
                  f"{h['grad_norm']:.5f} ({w['grad_norm']:.5f}, err "
                  f"{ne:.2e}), {h['ms']:.1f} ms (world size 1 "
                  f"{w['ms']:.1f} ms; information only)")
            check(le <= LOSS_RTOL and ne <= GNORM_RTOL,
                  f"[zero3] rank {r} step {h['step']}: loss err {le:.3g}, "
                  f"norm err {ne:.3g}")
        check(not any(res["counts"].values()),
              f"[zero3] rank {r}: kernel launches {res['counts']} (the "
              f"MoE model's step runs einsum experts and chunked attention)")
    le = abs(ranks[0]["grad_loss"] - one["loss"]) / abs(one["loss"])
    check(le <= LOSS_RTOL, f"[zero3] gradient step loss err {le:.3g}")
    errs = ranks[0]["grad_errs"]
    worst = max(errs, key=errs.get)
    print(f"[zero3] gradients vs world size 1 (norm-relative, tol "
          f"{GRAD_RTOL}): {len(errs)} parameters, worst {worst} "
          f"{errs[worst]:.3e}; " + ", ".join(
              f"{k} {v:.2e}" for k, v in sorted(errs.items())
              if k.startswith(f"layers.{ZERO3_LAYERS - 1}.")
              or "embed" in k))
    check(errs[worst] <= GRAD_RTOL, f"[zero3] {worst} gradient err "
                                    f"{errs[worst]:.3g}")
    for name, (path, e) in ranks[0]["kernels"].items():
        print(f"[zero3] {name} at a rank's heads on {path}: kernel vs plain "
              + ", ".join(f"{x:.2e}" for x in e))
    print(f"[zero3] summary: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{ZERO3_SIZES[0]} x {ZERO3_T} tokens, {ZERO3_SIZES} mesh on one "
          f"card over gloo; world size 1 peak {one['peak'] / gb:.2f} GB")


# [seq]: Qwen1.5-4B at its published widths (d_model 2560, 20 heads of 128
# with QKV bias, d_ff 6912, vocab 151936 padded to 152064), its depth cut
# 40 -> 2, the block-sparse FFN (64 x 64 blocks at 25 %), fp32 (greedy
# tokens must match world size 1 exactly): three gloo ranks on the one card
# on a (1, 3) mesh, where the 20 heads do not split, so the attention runs
# whole on every rank and its KV cache splits on time, and ``seq_shard``
# splits the residual stream's T; against a world-size-1 run of the same
# model from the same seed
SEQ_LAYERS = 2
SEQ_WORLD = 3
SEQ_T = 1536                   # training tokens: 512 rows a rank
SEQ_STEPS = 2
SEQ_BATCH = 2                  # decode rows
SEQ_MAX_LEN = 768              # 256 positions a rank
SEQ_CHUNKS = (160, 160)        # prefill chunks: the second crosses 256
SEQ_DECODE = 16                # greedy steps after the prefill
SEQ_TIMEOUT = 600


def seq_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("qwen1.5-4b"), n_layers=SEQ_LAYERS, dtype="float32",
        ffn_block_sparse=True, ffn_block=64, ffn_density=0.25,
        seq_shard=True)


def _seq_decode(model, dev):
    """Chunked prefill of ``SEQ_BATCH`` random prompts (``SEQ_CHUNKS``,
    the second across a shard edge of the split cache), then
    ``SEQ_DECODE`` greedy steps, through ``decode_step``: every call's
    logits and tokens (on the host), the launch counts of the run, its
    time and the KV cache's bytes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    cfg = model.cfg
    prompt = torch.randint(0, cfg.vocab, (SEQ_BATCH, sum(SEQ_CHUNKS)),
                           generator=gen, device=dev)
    cache = model.init_cache(SEQ_BATCH, SEQ_MAX_LEN)
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("k", "v"))
    logits, tokens = [], []
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        pos = 0
        for c in SEQ_CHUNKS:
            out, _ = model.decode_step(cache, prompt[:, pos:pos + c], pos)
            pos += c
        for i in range(SEQ_DECODE):
            tok = out.argmax(-1)
            logits.append(out.cpu())
            tokens.append(tok.cpu())
            out, _ = model.decode_step(cache, tok[:, None], pos + i)
    counts = _counts()
    ms = (time.perf_counter() - t0) * 1e3
    return (torch.stack(logits), torch.stack(tokens), counts, ms, kv_bytes,
            list(cache["k"].shape))


def _seq_kernels(model, dev):
    """``segment_spmm`` against its plain version at the shapes a rank
    gives it on [seq]'s path (layer 0's up plan with random blocks, fp32
    B, so the ``"simt"`` path): forward and ``transpose_lhs`` at a rank's
    ``SEQ_T / SEQ_WORLD`` rows of the training step, forward at the
    decode step's ``SEQ_BATCH`` rows.  Returns the records."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    cfg = model.cfg
    mlp = model.layers[0].mlp
    plan = mlp.up.plan
    plan = plan.with_values(torch.randn(
        plan.lhs_blocks.shape, generator=gen, device=dev) / cfg.d_model ** 0.5)
    n = SEQ_T // SEQ_WORLD
    recs = [
        kernel_case("up, a rank's rows", plan, torch.randn(
            cfg.d_model, n, generator=gen, device=dev), tag="seq"),
        kernel_case("up dx, a rank's rows", plan, torch.randn(
            cfg.d_ff, n, generator=gen, device=dev), transpose=True,
            tag="seq"),
        kernel_case("up, decode", plan, torch.randn(
            cfg.d_model, SEQ_BATCH, generator=gen, device=dev), tag="seq")]
    check(all(r["path"] == "simt" for r in recs),
          f"[seq] kernel paths {[r['path'] for r in recs]}")
    return recs


def seq_rank(rank, port, out_dir, dev=None):
    """One rank of [seq] (``chip_smoke.py --phase seq --rank R``): rank 0
    first runs the model at world size 1 (training and decode) while the others
    wait; then all three run it on the (1, 3) mesh.  Rank 0 holds the split
    runs to world size 1's and checks the kernels at a rank's shapes; each
    rank writes its numbers to ``out_dir/r<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.tensor_parallel import gather_full

    dev = torch.device("cuda", 0) if dev is None else dev
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=SEQ_WORLD, timeout=datetime.timedelta(seconds=SEQ_TIMEOUT))
    cfg = seq_config()
    res = {"rank": rank}
    if rank == 0:
        model = build_model(cfg, device=dev)
        trainer, loss, grads, hist, counts, peak = _tp_run(
            model, cfg, dev, t=SEQ_T, steps=SEQ_STEPS)
        one_logits, tokens, d_counts, d_ms, kv, kshape = _seq_decode(model,
                                                                     dev)
        one = {"loss": loss, "hist": hist, "counts": counts, "peak": peak,
               "decode_counts": d_counts, "decode_ms": d_ms, "kv": kv,
               "kshape": kshape, "tokens": tokens.tolist(),
               "grads": {k: g.cpu() for k, g in grads.items()}}
        del model, trainer, grads
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[seq] world size 1: loss {loss:.5f}; steps " + ", ".join(
            f"{h['loss']:.5f} / {h['grad_norm']:.5f} / {h['ms']:.1f} ms"
            for h in hist) + f"; peak {peak / 2**30:.2f} GiB; decode "
            f"{d_ms:.1f} ms; KV cache {kv / 1e6:.1f} MB {kshape}",
            flush=True)
    dist.barrier()
    mesh = make_mesh((1, SEQ_WORLD), ("data", "model"), device="cuda")
    model = build_model(cfg, device=dev, mesh=mesh)
    gathered = sorted(model.tp_gathered)
    check(model.tp.size == SEQ_WORLD and gathered == [
        f"layers.{i}.attn" for i in range(SEQ_LAYERS)],
        f"[seq] rank {rank}: split {model.tp}, gathered {gathered}")
    if rank == 0:
        res["kernels"] = _seq_kernels(model, dev)
    rows = []
    hooks = [blk.register_forward_pre_hook(
        lambda m, a: rows.append(a[0].shape[1])) for blk in model.layers]
    trainer, loss, grads, hist, counts, peak = _tp_run(
        model, cfg, dev, mesh, t=SEQ_T, steps=SEQ_STEPS)
    for h in hooks:
        h.remove()
    split = model.tp_local_params()
    errs = {}
    for k in sorted(grads):
        g = (gather_full(grads[k], split[k][0], model.tp) if k in split
             else grads[k])
        if rank == 0:
            errs[k] = _fro(g, one["grads"][k].to(dev))
    del grads
    logits, tokens, d_counts, d_ms, kv, kshape = _seq_decode(model, dev)
    res.update(loss=loss, hist=hist, counts=counts, peak=peak, rows=rows,
               decode_counts=d_counts, decode_ms=d_ms, kv=kv, kshape=kshape,
               max_allocated=torch.cuda.max_memory_allocated(),
               max_reserved=torch.cuda.max_memory_reserved(),
               seq=model.seq_parallel(SEQ_T).size,
               tokens=tokens.tolist())
    if rank == 0:
        del one["grads"]
        res["one"] = one
        res["grad_errs"] = errs
        res["logit_err"] = _rel(logits, one_logits)[0]
    dist.barrier()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_seq(dev):
    """[seq]: three processes on the one card (gloo with CUDA tensors),
    Qwen1.5-4B at published widths and 2 layers (fp32, block-sparse FFN)
    on a (1, 3) mesh: its 20 heads do not split, so the attention runs
    whole on every rank.  Against a world-size-1 run of the same model:
    2 ``Trainer`` steps on 1 x 1536 tokens with ``seq_shard`` (each
    block's input holds 512 rows a rank) within the training gates, and
    every gradient; a chunked prefill across a shard edge of the KV cache
    split on time (256 of 768 positions a rank, its bytes exactly a third)
    and 16 greedy steps, the same tokens and logits within the decode
    gate; each rank's exact launches of ``segment_spmm``, equal to world
    size 1's; the kernel against its plain version at a rank's shapes;
    peak memory per rank.  Times are information only: three ranks share
    one card and gloo stages every collective through the host."""
    t0 = time.perf_counter()
    ranks = _run_ranks("seq", SEQ_WORLD, SEQ_TIMEOUT)
    _seq_report(ranks)
    print(f"[seq] phase {time.perf_counter() - t0:.1f} s")
    return ranks


def _seq_report(ranks):
    """[seq]'s gates over the ranks' numbers (see :func:`phase_seq`)."""
    cfg = seq_config()
    one = ranks[0]["one"]
    L = cfg.n_layers
    calls = len(SEQ_CHUNKS) + SEQ_DECODE
    # a step: each layer's three projections forward, again in the remat
    # recompute, and their dx (transposed); fp32 B: every call on simt
    want = {"train": dict(spmm=9 * L * SEQ_STEPS, spmm_t=3 * L * SEQ_STEPS,
                          spmm_tc=0, spmm_split=0, flash=0, rg_lru=0),
            "decode": dict(spmm=3 * L * calls, spmm_t=0, spmm_tc=0,
                           spmm_split=0, flash=0, rg_lru=0)}
    gb = 1e9
    for r, res in enumerate(ranks):
        for run, key in (("train", "counts"), ("decode", "decode_counts")):
            bad = {k: (res[key][k], v) for k, v in want[run].items()
                   if res[key][k] != v}
            check(not bad and res[key] == one[key],
                  f"[seq] rank {r} {run}: launches (got, expected) {bad}; "
                  f"world size 1 {one[key]}")
        check(res["seq"] == SEQ_WORLD and len(res["rows"]) >= L and
              set(res["rows"]) == {SEQ_T // SEQ_WORLD},
              f"[seq] rank {r}: residual rows {sorted(set(res['rows']))} "
              f"over {len(res['rows'])} block calls, split {res['seq']}")
        check(res["kshape"][2] * SEQ_WORLD == one["kshape"][2] == SEQ_MAX_LEN
              and res["kv"] * SEQ_WORLD == one["kv"],
              f"[seq] rank {r}: KV cache {res['kshape']} {res['kv']} B, "
              f"world size 1 {one['kshape']} {one['kv']} B")
        check(res["tokens"] == one["tokens"],
              f"[seq] rank {r}: greedy tokens differ from world size 1")
        for h, w in zip(res["hist"], one["hist"]):
            le = abs(h["loss"] - w["loss"]) / abs(w["loss"])
            ne = abs(h["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            print(f"[seq] rank {r} step {h['step']}: loss {h['loss']:.5f} "
                  f"(world size 1 {w['loss']:.5f}, err {le:.2e}), grad norm "
                  f"{h['grad_norm']:.5f} ({w['grad_norm']:.5f}, err "
                  f"{ne:.2e}), {h['ms']:.1f} ms (world size 1 "
                  f"{w['ms']:.1f} ms; information only)")
            check(le <= LOSS_RTOL and ne <= GNORM_RTOL,
                  f"[seq] rank {r} step {h['step']}: loss err {le:.3g}, "
                  f"norm err {ne:.3g}")
        print(f"[seq] rank {r}: residual {SEQ_T // SEQ_WORLD} of {SEQ_T} "
              f"rows at every block; KV cache {res['kshape']} "
              f"{res['kv'] / 1e6:.1f} MB (world size 1 {one['kshape']} "
              f"{one['kv'] / 1e6:.1f} MB); training peak "
              f"{res['peak'] / gb:.2f} GB above its model (world size 1 "
              f"{one['peak'] / gb:.2f} GB); peak allocated "
              f"{res['max_allocated'] / gb:.2f} GB, reserved "
              f"{res['max_reserved'] / gb:.2f} GB; decode {res['decode_ms']:.1f}"
              f" ms (world size 1 {one['decode_ms']:.1f} ms; information "
              f"only); launches train {res['counts']['spmm']}, decode "
              f"{res['decode_counts']['spmm']}")
    le = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    check(le <= LOSS_RTOL, f"[seq] gradient step loss err {le:.3g}")
    errs = ranks[0]["grad_errs"]
    worst = max(errs, key=errs.get)
    print(f"[seq] gradients vs world size 1 (norm-relative, tol {GRAD_RTOL}):"
          f" {len(errs)} parameters, worst {worst} {errs[worst]:.3e}")
    check(errs[worst] <= GRAD_RTOL, f"[seq] {worst} gradient err "
                                    f"{errs[worst]:.3g}")
    le = ranks[0]["logit_err"]
    print(f"[seq] decode: {len(SEQ_CHUNKS)} prefill chunks {SEQ_CHUNKS} and "
          f"{SEQ_DECODE} greedy steps, tokens equal on every rank, logits vs "
          f"world size 1 {le:.2e} (tol {LOGIT_RTOL})")
    check(le <= LOGIT_RTOL, f"[seq] decode logits err {le:.3g}")
    print(f"[seq] summary: {cfg.name} full width, {L} layers, fp32, "
          f"(1, {SEQ_WORLD}) mesh on one card over gloo; attention whole on "
          f"every rank, KV cache split on time, residual split on T")


# [rwkv_tp]: RWKV-6 1.6B at its published widths (d_model 2048, 32 heads of
# 64, d_ff 7168, vocab 65536, lora 128), its depth cut 24 -> 2, fp32 (greedy
# tokens must match world size 1 exactly): four gloo ranks on the one card
# on a (1, 4) mesh, each running 8 heads of the time mix, 1792 hidden units
# of the channel mix and its 8 heads of the wkv state; against a
# world-size-1 run of the same model from the same seed.  The wkv
# recurrence is a torch loop in both packages: no kernel runs on this path
RWKV_TP_LAYERS = 2
RWKV_TP_SIZES = (1, 4)
RWKV_TP_WORLD = RWKV_TP_SIZES[0] * RWKV_TP_SIZES[1]
RWKV_TP_T = 256                # training tokens: 1 x 256, 64 rows a rank
RWKV_TP_STEPS = 2
RWKV_TP_BATCH = 2              # decode rows
RWKV_TP_PROMPT = 64            # one prefill call
RWKV_TP_DECODE = 16            # greedy steps after the prefill
RWKV_TP_TIMEOUT = 600
RWKV_TP_PROJ = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v")
# the gate for loss, norm, gradients and decode logits against world size
# 1: the run is fp32 over 2 layers, so [tp]'s bf16 gates would let a
# missing or doubled sum of ln_x's statistic through (it moves the input's
# gradient by ~1 %); on an H100 the errors were 1.66e-7 (loss), 5.97e-8
# (norm), 4.865e-6 (gradients) and 1.71e-6 (logits)
RWKV_TP_RTOL = 1e-4


def rwkv_tp_config(**kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("rwkv6-1.6b"),
                               n_layers=RWKV_TP_LAYERS, dtype="float32", **kw)


def _rwkv_decode(model, dev):
    """A prefill of ``RWKV_TP_PROMPT`` random tokens in one call, then
    ``RWKV_TP_DECODE`` greedy steps, through ``decode_step`` from the
    model's seeded initial weights: every step's logits and tokens (on
    the host), its time, and the bytes and shape of S."""
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    prompt = torch.randint(0, model.cfg.vocab,
                           (RWKV_TP_BATCH, RWKV_TP_PROMPT), generator=gen,
                           device=dev)
    cache = model.init_cache(RWKV_TP_BATCH, RWKV_TP_PROMPT + RWKV_TP_DECODE)
    s = cache["S"]
    logits, tokens = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out, _ = model.decode_step(cache, prompt, 0)
        for i in range(RWKV_TP_DECODE):
            tok = out.argmax(-1)
            logits.append(out.cpu())
            tokens.append(tok.cpu())
            out, _ = model.decode_step(cache, tok[:, None],
                                       RWKV_TP_PROMPT + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (torch.stack(logits), torch.stack(tokens), ms,
            s.numel() * s.element_size(), list(s.shape))


def rwkv_tp_rank(rank, port, out_dir, dev=None):
    """One rank of [rwkv_tp] (``chip_smoke.py --phase rwkv_tp --rank R``):
    rank 0 first runs the model at world size 1 (training and decode) while the
    others wait; then all four run it split on the (1, 4) mesh, and one
    ``seq_shard`` step.  Rank 0 holds each gathered gradient to world size
    1's; each rank writes its numbers to ``out_dir/r<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.tensor_parallel import gather_full

    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=RWKV_TP_WORLD,
        timeout=datetime.timedelta(seconds=RWKV_TP_TIMEOUT))
    cfg = rwkv_tp_config()
    res = {"rank": rank}
    if rank == 0:
        model = build_model(cfg, device=dev)
        trainer, loss, grads, hist, counts, peak = _tp_run(
            model, cfg, dev, t=RWKV_TP_T, steps=RWKV_TP_STEPS)
        one_logits, tokens, d_ms, s_bytes, s_shape = _rwkv_decode(model,
                                                                  dev)
        one = {"loss": loss, "hist": hist, "counts": counts, "peak": peak,
               "decode_ms": d_ms, "s_bytes": s_bytes, "s_shape": s_shape,
               "tokens": tokens.tolist(),
               "grads": {k: g.cpu() for k, g in grads.items()}}
        del model, trainer, grads
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[rwkv_tp] world size 1: loss {loss:.5f}; steps " + ", ".join(
            f"{h['loss']:.5f} / {h['grad_norm']:.5f} / {h['ms']:.1f} ms"
            for h in hist) + f"; peak {peak / 2**30:.2f} GiB; decode "
            f"{d_ms:.1f} ms; S {s_bytes / 1e6:.2f} MB {s_shape}",
            flush=True)
    dist.barrier()
    mesh = make_mesh(RWKV_TP_SIZES, ("data", "model"), device=dev.type)
    model = build_model(cfg, device=dev, mesh=mesh)
    split = model.tp_local_params()
    proj = {k: v for k, v in split.items() if ".rwkv." in k}
    res["gathered"] = sorted(model.tp_gathered)
    res["local"] = {k: [list(model.get_parameter(k).shape), list(full)]
                    for k, (_, full) in proj.items()}
    trainer, loss, grads, hist, counts, peak = _tp_run(
        model, cfg, dev, mesh, t=RWKV_TP_T, steps=RWKV_TP_STEPS)
    errs = {}
    for k in sorted(grads):
        g = (gather_full(grads[k], split[k][0], model.tp) if k in split
             else grads[k])
        if rank == 0:
            errs[k] = _fro(g, one["grads"][k].to(dev))
    del grads, trainer
    logits, tokens, d_ms, s_bytes, s_shape = _rwkv_decode(model, dev)
    res.update(loss=loss, hist=hist, counts=counts, peak=peak,
               decode_ms=d_ms, s_bytes=s_bytes, s_shape=s_shape,
               tokens=tokens.tolist(),
               max_allocated=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # one seq_shard step from the same seed: each block's input holds
    # T / 4 rows
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    scfg = rwkv_tp_config(seq_shard=True)
    model = build_model(scfg, device=dev, mesh=mesh)
    rows = []
    for blk in model.layers:
        blk.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[1]))
    trainer = Trainer(model, scfg, ShapeConfig("rwkv_tp", "train",
                                               RWKV_TP_T, 1),
                      TrainerConfig(steps=1, log_every=1, warmup=1),
                      mesh=mesh, seed=SEED)
    _zero_counts()
    res["seq"] = {"hist": trainer.run()["history"], "rows": rows,
                  "split": model.seq_parallel(RWKV_TP_T).size,
                  "counts": _counts()}
    if rank == 0:
        del one["grads"]
        res["one"] = one
        res["grad_errs"] = errs
        res["logit_err"] = _rel(logits, one_logits)[0]
    dist.barrier()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_rwkv_tp(dev):
    """[rwkv_tp]: four processes on the one card (gloo with CUDA tensors),
    RWKV-6 1.6B at published widths and 2 layers (fp32) on a (1, 4) mesh,
    each rank running 8 of the 32 heads and 1792 of the 7168 hidden units.
    Against a world-size-1 run of the same model: 2 ``Trainer`` steps on
    1 x 256 tokens, loss, norm and every gradient (gathered) within
    ``RWKV_TP_RTOL``; one ``seq_shard`` step (each block's input 64 rows a
    rank) against world size 1's first; a 64-token prefill and 16 greedy
    steps, the same tokens and logits within ``RWKV_TP_RTOL``; a rank's S
    bytes and the split projections' parameter bytes exactly a quarter of
    world size 1's; no kernel launch (the wkv recurrence is a torch loop).
    Times and peak memory per rank are information only: four ranks share
    one card and gloo stages every collective through the host."""
    t0 = time.perf_counter()
    ranks = _run_ranks("rwkv_tp", RWKV_TP_WORLD, RWKV_TP_TIMEOUT)
    _rwkv_tp_report(ranks)
    print(f"[rwkv_tp] phase {time.perf_counter() - t0:.1f} s")
    return ranks


def _rwkv_tp_report(ranks):
    """[rwkv_tp]'s gates over the ranks' numbers (see
    :func:`phase_rwkv_tp`)."""
    cfg = rwkv_tp_config()
    one = ranks[0]["one"]
    tp = RWKV_TP_SIZES[1]
    gb = 1e9
    for r, res in enumerate(ranks):
        check(res["gathered"] == [], f"[rwkv_tp] rank {r}: computed whole "
                                     f"{res['gathered']}")
        names = {k.split(".")[3] for k in res["local"]}
        check(names == set(RWKV_TP_PROJ) | {"w_lora_b"}
              and len(res["local"]) == 8 * RWKV_TP_LAYERS,
              f"[rwkv_tp] rank {r}: split {sorted(res['local'])}")
        local = sum(math.prod(s) for s, _ in res["local"].values())
        full = sum(math.prod(f) for _, f in res["local"].values())
        for name, (shape, whole) in res["local"].items():
            check(sum(a != b for a, b in zip(shape, whole)) == 1,
                  f"[rwkv_tp] rank {r}: {name} local {shape} of {whole}")
        check(local * tp == full, f"[rwkv_tp] rank {r}: split projections "
                                  f"{local} of {full} elements")
        check(res["s_bytes"] * tp == one["s_bytes"]
              and res["s_shape"][2] * tp == one["s_shape"][2] == cfg.n_heads,
              f"[rwkv_tp] rank {r}: S {res['s_shape']} {res['s_bytes']} B, "
              f"world size 1 {one['s_shape']} {one['s_bytes']} B")
        check(res["tokens"] == one["tokens"],
              f"[rwkv_tp] rank {r}: greedy tokens differ from world size 1")
        for run, counts in (("train", res["counts"]),
                            ("seq", res["seq"]["counts"])):
            check(not any(counts.values()), f"[rwkv_tp] rank {r} {run}: "
                                            f"kernel launches {counts}")
        for h, w in zip(res["hist"] + res["seq"]["hist"],
                        one["hist"] + one["hist"][:1]):
            le = abs(h["loss"] - w["loss"]) / abs(w["loss"])
            ne = abs(h["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            print(f"[rwkv_tp] rank {r} step {h['step']}: loss "
                  f"{h['loss']:.5f} (world size 1 {w['loss']:.5f}, err "
                  f"{le:.2e}), grad norm {h['grad_norm']:.5f} "
                  f"({w['grad_norm']:.5f}, err {ne:.2e}), {h['ms']:.1f} ms "
                  f"(world size 1 {w['ms']:.1f} ms; information only)")
            check(le <= RWKV_TP_RTOL and ne <= RWKV_TP_RTOL,
                  f"[rwkv_tp] rank {r} step {h['step']}: loss err {le:.3g}, "
                  f"norm err {ne:.3g}")
        seq = res["seq"]
        check(seq["split"] == tp and len(seq["rows"]) >= RWKV_TP_LAYERS
              and set(seq["rows"]) == {RWKV_TP_T // tp},
              f"[rwkv_tp] rank {r}: seq_shard rows {sorted(set(seq['rows']))}"
              f" over {len(seq['rows'])} block calls, split {seq['split']}")
        print(f"[rwkv_tp] rank {r}: split projections {local * 4 / gb:.3f} "
              f"of {full * 4 / gb:.3f} GB; S {res['s_shape']} "
              f"{res['s_bytes'] / 1e6:.2f} MB (world size 1 "
              f"{one['s_shape']} {one['s_bytes'] / 1e6:.2f} MB); seq_shard "
              f"step: {RWKV_TP_T // tp} of {RWKV_TP_T} rows at every block; "
              f"training peak {res['peak'] / gb:.2f} GB above its model "
              f"(world size 1 {one['peak'] / gb:.2f} GB); peak allocated "
              f"{res['max_allocated'] / gb:.2f} GB; decode "
              f"{res['decode_ms']:.1f} ms (world size 1 "
              f"{one['decode_ms']:.1f} ms; information only)")
    le = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    check(le <= RWKV_TP_RTOL, f"[rwkv_tp] gradient step loss err {le:.3g}")
    errs = ranks[0]["grad_errs"]
    worst = max(errs, key=errs.get)
    print(f"[rwkv_tp] gradients vs world size 1 (norm-relative, tol "
          f"{RWKV_TP_RTOL}): {len(errs)} parameters, worst {worst} "
          f"{errs[worst]:.3e}; " + ", ".join(
              f"{k} {v:.2e}" for k, v in sorted(errs.items())
              if k.startswith("layers.1.rwkv.") and not k.endswith(".w")))
    check(errs[worst] <= RWKV_TP_RTOL, f"[rwkv_tp] {worst} gradient err "
                                    f"{errs[worst]:.3g}")
    le = ranks[0]["logit_err"]
    print(f"[rwkv_tp] decode: a {RWKV_TP_PROMPT}-token prefill and "
          f"{RWKV_TP_DECODE} greedy steps over {RWKV_TP_BATCH} rows, tokens "
          f"equal on every rank, logits vs world size 1 {le:.2e} (tol "
          f"{RWKV_TP_RTOL})")
    check(le <= RWKV_TP_RTOL, f"[rwkv_tp] decode logits err {le:.3g}")
    print(f"[rwkv_tp] summary: {cfg.name} full width, {cfg.n_layers} layers, "
          f"fp32, {RWKV_TP_SIZES} mesh on one card over gloo: "
          f"{cfg.n_heads // tp} heads and {cfg.d_ff // tp} hidden units a "
          f"rank")


# [kv_group]: RecurrentGemma-9B at its published widths (d_model 4096, 16
# heads of 256 on 1 KV head, window 2048, RG-LRU width 4096), its depth
# cut 38 -> 3 (one rec, rec, local unit), fp32 (greedy tokens must match
# world size 1 exactly): four gloo ranks on the one card on a (1, 4) mesh,
# each running 4 query heads of the one KV head, its 512 of the ring's
# 2048 slots and 1024 RG-LRU channels; against a world-size-1 run of the
# same model from the same seed
KV_GROUP_LAYERS = 3
KV_GROUP_SIZES = (1, 4)
KV_GROUP_WORLD = KV_GROUP_SIZES[0] * KV_GROUP_SIZES[1]
KV_GROUP_BATCH = 2             # decode rows
KV_GROUP_CHUNKS = (1024, 1024)  # prefill chunks: 2048 tokens, W a call at most
KV_GROUP_DECODE = 24           # greedy steps after the prefill: the ring wraps
# per-row positions after the greedy steps: row 0 goes on, row 1 writes
# positions 511 and 512, ring slots across rank 0's and rank 1's ranges
KV_GROUP_EDGE = 511
KV_GROUP_MAX_LEN = 4096        # the ring holds min(max_len, window) slots
KV_GROUP_TIMEOUT = 600


def kv_group_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("recurrentgemma-9b"),
                               n_layers=KV_GROUP_LAYERS, dtype="float32")


def _kv_group_decode(model, dev):
    """From the model's seeded weights: a chunked prefill of
    ``KV_GROUP_BATCH`` random prompts (``KV_GROUP_CHUNKS``), then
    ``KV_GROUP_DECODE`` greedy steps (past the ring's end), then two calls
    at per-row positions, one row across a shard edge of the ring, all
    through ``decode_step``, with every launch count set to 0 just before
    and read just after.  Returns every call's logits and tokens after the
    prefill (on the host), the counts, the time, the ring's bytes and
    shape and the peak allocated."""
    cfg = model.cfg
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    prompt = torch.randint(0, cfg.vocab, (KV_GROUP_BATCH,
                                          sum(KV_GROUP_CHUNKS)),
                           generator=gen, device=dev)
    cache = model.init_cache(KV_GROUP_BATCH, KV_GROUP_MAX_LEN)
    ring = sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v"))
    logits, tokens = [], []

    def keep(out):
        logits.append(out.cpu())
        tokens.append(out.argmax(-1).cpu())
        return out.argmax(-1)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        pos = 0
        for c in KV_GROUP_CHUNKS:
            out, _ = model.decode_step(cache, prompt[:, pos:pos + c], pos)
            pos += c
        for i in range(KV_GROUP_DECODE):
            tok = keep(out)
            out, _ = model.decode_step(cache, tok[:, None], pos + i)
        pos += KV_GROUP_DECODE
        tok = keep(out)
        rows = torch.tensor([pos, KV_GROUP_EDGE], device=dev)
        out, _ = model.decode_step(cache, torch.stack([tok, tok], 1), rows)
        tok = keep(out)
        out, _ = model.decode_step(cache, tok[:, None], rows + 2)
        keep(out)
    counts = _counts()
    ms = (time.perf_counter() - t0) * 1e3
    return (torch.stack(logits), torch.stack(tokens), counts, ms, ring,
            list(cache["k"].shape), torch.cuda.max_memory_allocated())


def _kv_group_kernels(model, dev):
    """``rg_lru`` against its plain version on random inputs at the shape
    a rank's decode step gives it (``KV_GROUP_BATCH`` rows, one step, its
    1024 channels, fp32: the ``simt`` path), one launch by its own count;
    its device time, the plain version's and the bound.  Returns the
    record."""
    from repro_torch.kernels.rg_lru import choose_path, rg_lru, rg_lru_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    rec = next(b.rec for b in model.layers if hasattr(b, "rec"))
    d = rec.a_param.shape[0] // rec.tp.size
    b = KV_GROUP_BATCH
    x, a_gate, x_gate = (torch.randn(b, 1, d, generator=gen, device=dev)
                         for _ in range(3))
    a_param = torch.randn(d, generator=gen, device=dev)
    h0 = torch.randn(b, d, generator=gen, device=dev)
    check(choose_path(b, 1, d) == "simt",
          f"[kv_group] rg_lru path {choose_path(b, 1, d)} at {(b, 1, d)}")

    def kern():
        return rg_lru(x, a_gate, x_gate, a_param, h0, ct=1)

    def plain():
        return rg_lru_plain(x, a_gate, x_gate, a_param, h0)

    out, h_t = lru_call("simt", kern, "a rank's decode step", "[kv_group]")
    po, ph = plain()
    (rel_o, abs_o), (rel_h, abs_h) = _rel(out, po), _rel(h_t, ph)
    check(max(rel_o, rel_h) <= KERNEL_RTOL,
          f"[kv_group] rg_lru kernel vs plain out {rel_o:.3g}, h_T "
          f"{rel_h:.3g}")
    bound_ms, bound_by, terms = rg_lru_bound(
        _nbytes(x, a_gate, x_gate, po, a_param, h0, ph), x.numel(),
        rg_lru_sfu_per_element())
    rec = dict(case=f"rg_lru decode, {b} x 1 x {d}", kernel="rg_lru",
               path="simt", d=d, rel_err=max(rel_o, rel_h),
               max_abs_err=max(abs_o, abs_h), ms=scaled_device_ms(kern),
               plain_ms=event_ms(plain, 3), bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    print(f"[kv_group] rg_lru B={b} T=1 D={d} fp32 (a rank's channels): "
          f"path simt, rel_err {rec['rel_err']:.2e}, {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; bytes {terms[0]:.4f}, fp32 ops {terms[1]:.4f}, SFU "
          f"{terms[2]:.4f})")
    return rec


def kv_group_rank(rank, port, out_dir, dev=None):
    """One rank of [kv_group] (``chip_smoke.py --phase kv_group --rank
    R``): rank 0 first decodes at world size 1 while the others wait; then
    all four decode split on the (1, 4) mesh, the ring split on time over
    the KV group.  Rank 0 holds the kernel to its plain version at a
    rank's shapes; each rank writes its numbers to
    ``out_dir/r<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0) if dev is None else dev
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=KV_GROUP_WORLD,
        timeout=datetime.timedelta(seconds=KV_GROUP_TIMEOUT))
    cfg = kv_group_config()
    res = {"rank": rank}
    if rank == 0:
        model = build_model(cfg, device=dev)
        (one_logits, tokens, counts, ms, ring, shape,
         peak) = _kv_group_decode(model, dev)
        one = {"tokens": tokens.tolist(), "counts": counts, "ms": ms,
               "ring": ring, "shape": shape, "peak": peak}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[kv_group] world size 1: decode {ms:.1f} ms; ring "
              f"{ring / 1e6:.2f} MB {shape}; peak {peak / 1e9:.2f} GB; "
              f"launches {counts}", flush=True)
    dist.barrier()
    mesh = make_mesh(KV_GROUP_SIZES, ("data", "model"), device=dev.type)
    model = build_model(cfg, device=dev, mesh=mesh)
    logits, tokens, counts, ms, ring, shape, peak = _kv_group_decode(model,
                                                                     dev)
    res.update(tokens=tokens.tolist(), counts=counts, ms=ms, ring=ring,
               shape=shape, peak=peak, gathered=sorted(model.tp_gathered),
               kv=[model.kv_tp.rank, model.kv_tp.size],
               split=model.kv_split_on_time(KV_GROUP_MAX_LEN))
    if rank == 0:
        res["one"] = one
        res["logit_err"] = _rel(logits, one_logits)[0]
        res["kernels"] = [_kv_group_kernels(model, dev)]
    dist.barrier()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_kv_group(dev):
    """[kv_group]: four processes on the one card (gloo with CUDA
    tensors), RecurrentGemma-9B at published widths and 3 layers (fp32) on
    a (1, 4) mesh: its one KV head is shared by all four ranks, so its
    local layer's ring of 2048 slots splits 512 a rank and decode reduces
    the ring attention over the ranks.  Against a world-size-1 run of the
    same model: a 2 x 2048-token prefill in two chunks, 24 greedy steps
    (the ring wraps) and two calls at per-row positions (one row across
    ranks 0 and 1), the same tokens on every rank, logits within
    ``LOGIT_RTOL``; a rank's ring bytes exactly a quarter of world size
    1's; each rank's exact launches (``rg_lru``: ``tile`` for each
    prefill chunk, ``simt`` for each decode call, 2 a call) equal to world
    size 1's; the kernel against its plain version at a rank's 1024
    channels.  Times and peak memory per rank are information only: four
    ranks share one card and gloo stages every collective through the
    host."""
    t0 = time.perf_counter()
    ranks = _run_ranks("kv_group", KV_GROUP_WORLD, KV_GROUP_TIMEOUT)
    _kv_group_report(ranks)
    print(f"[kv_group] phase {time.perf_counter() - t0:.1f} s")
    return ranks


def _kv_group_report(ranks):
    """[kv_group]'s gates over the ranks' numbers (see
    :func:`phase_kv_group`)."""
    cfg = kv_group_config()
    one = ranks[0]["one"]
    tp = KV_GROUP_SIZES[1]
    n_rec = cfg.layer_pattern.count("rec")
    calls = KV_GROUP_DECODE + 2
    want = dict(rg_lru=n_rec * (len(KV_GROUP_CHUNKS) + calls),
                rg_lru_tile=n_rec * len(KV_GROUP_CHUNKS),
                rg_lru_simt=n_rec * calls, flash=0, spmm=0)
    gb = 1e9
    for r, res in enumerate(ranks):
        check(res["gathered"] == [] and res["kv"] == [r, tp] and res["split"],
              f"[kv_group] rank {r}: gathered {res['gathered']}, KV group "
              f"{res['kv']}, split on time {res['split']}")
        bad = {k: (res["counts"][k], v) for k, v in want.items()
               if res["counts"][k] != v}
        check(not bad and res["counts"] == one["counts"],
              f"[kv_group] rank {r}: launches (got, expected) {bad}; world "
              f"size 1 {one['counts']}")
        check(res["ring"] * tp == one["ring"]
              and res["shape"][2] * tp == one["shape"][2] == cfg.local_window,
              f"[kv_group] rank {r}: ring {res['shape']} {res['ring']} B, "
              f"world size 1 {one['shape']} {one['ring']} B")
        check(res["tokens"] == one["tokens"],
              f"[kv_group] rank {r}: greedy tokens differ from world size 1")
        print(f"[kv_group] rank {r}: ring {res['shape']} "
              f"{res['ring'] / 1e6:.2f} MB (world size 1 {one['shape']} "
              f"{one['ring'] / 1e6:.2f} MB); rg_lru simt "
              f"{res['counts']['rg_lru_simt'] // calls} a decode call, tile "
              f"{res['counts']['rg_lru_tile']}; decode {res['ms']:.1f} ms "
              f"(world size 1 {one['ms']:.1f} ms; information only); peak "
              f"allocated {res['peak'] / gb:.2f} GB (world size 1 "
              f"{one['peak'] / gb:.2f} GB)")
    le = ranks[0]["logit_err"]
    print(f"[kv_group] decode: prefill chunks {KV_GROUP_CHUNKS}, "
          f"{KV_GROUP_DECODE} greedy steps past the ring's end, 2 calls at "
          f"per-row positions; tokens equal on every rank, logits vs world "
          f"size 1 {le:.2e} (tol {LOGIT_RTOL})")
    check(le <= LOGIT_RTOL, f"[kv_group] decode logits err {le:.3g}")
    print(f"[kv_group] summary: {cfg.name} full width, {cfg.n_layers} "
          f"layers, fp32, {KV_GROUP_SIZES} mesh on one card over gloo: "
          f"{cfg.n_heads // tp} query heads, {cfg.local_window // tp} ring "
          f"slots and {cfg.d_model // tp} RG-LRU channels a rank")


def _fake_rule_cases(dev):
    """``(label, operator, arguments, kernel, a path's count, its launches)``
    of one launch each: ``moe_gemm`` on its tensor-core kernel (bf16, a
    strided weight and int64 expert ids, which the launch copies) and its
    SIMT kernel (fp32: no tensor-core launch), ``segment_spgemm`` on
    ``"tc"`` (64 x 64 tiles) and ``"simt"`` (32 x 32)."""
    from repro_torch import api
    from repro_torch.core.formats import BSR
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.segment_spgemm import segment_spgemm
    ops = torch.ops.repro_torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    rng = np.random.default_rng(SEED + 53)
    cases = []
    for dt, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        x = torch.randn(4 * 128, 256, generator=gen, device=dev).to(dt)
        w = torch.randn(4, 512, 256, generator=gen, device=dev).to(dt)
        ids = torch.tensor([0, 1, 1, 3], device=dev)
        live = torch.tensor([128, 5, 0, 64], dtype=torch.int32, device=dev)
        cases.append((f"moe_gemm {path}", ops.moe_gemm,
                      (x, w.transpose(1, 2), ids, live, 128, torch.float32),
                      moe_gemm, "tensor_core_launches", int(path == "tc")))
    for block, path in ((64, "tc"), (32, "simt")):
        a = BSR.random(rng, (512, 512), (block, block), 0.3)
        plan = api.plan_matmul(a, a, device=dev)
        cases.append((f"segment_spgemm {path}", ops.segment_spgemm, (
            plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx,
            plan.c_idx, plan.seg_start, plan.seg_write, plan.accum_prev,
            plan.valid, None, None, plan.run_offsets, plan.tc_runs,
            plan.tc_steps, plan.n_out_blocks, torch.float32, None),
            segment_spgemm, f"{path}_launches", 1))
    return cases


def fake_rule_checks(dev):
    """The fake rules of ``moe_gemm`` and ``segment_spgemm`` against one
    real launch each on the card (:func:`_fake_rule_cases`): the same
    outputs and scratch, shape and dtype, in order, and the bytes the
    real launch's results hold in the allocator (``memory_allocated``
    while they live) equal to the fake ones' rounded to the allocator's
    512 bytes; each launch on its path by that path's own count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for label, op, args, kernel, name, n in _fake_rule_cases(dev):
        torch.cuda.synchronize()
        counts = (kernel.launches, getattr(kernel, name))
        before = torch.cuda.memory_allocated()
        outs = op(*args)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        got = (kernel.launches - counts[0], getattr(kernel, name) - counts[1])
        with FakeTensorMode():
            fake = op(*(torch.empty_strided(a.shape, a.stride(),
                                            dtype=a.dtype, device=dev)
                        if isinstance(a, torch.Tensor) else a for a in args))
        real = [(tuple(o.shape), o.dtype) for o in outs]
        want = [(tuple(o.shape), o.dtype) for o in fake]
        rounded = sum(-(-o.numel() * o.element_size() // 512) * 512
                      for o in fake)
        print(f"[dryrun] fake rule {label}: launch {real}, fake rule {want}; "
              f"held {held} B, fake rule {rounded} B (512-byte blocks); "
              f"launches {got}")
        check(real == want and held == rounded and got == (1, n),
              f"[dryrun] fake rule {label}: launch {real} {held} B, fake "
              f"{want} {rounded} B, launches {got}")
        del outs


# [dryrun]: the production cells traced on fake CUDA tensors (pod_16x16)
# (granite's prefill_32k, ~45 s, is left to ``dryrun --all``: its forward
# is the training cell's, without the backward)
DRYRUN_CELLS = (("granite-3-8b", "train_4k"), ("granite-3-8b", "decode_32k"),
                ("recurrentgemma-9b", "train_4k"))
# the predicted peak against max_memory_allocated over the same real step
DRYRUN_PEAK_RTOL = 0.10
# the split step's gates: useful FLOPs of a training cell, and the
# parameter bytes a rank against each arch's whole fp32 parameters (the
# gathered layout's ``Parameter`` bytes a rank, 1e9-byte GB: 32.69 and
# 37.58 when every rank held the whole fp32 model)
DRYRUN_USEFUL_MIN = 0.5
DRYRUN_PARAM_CUT = 12
DRYRUN_GATHERED_PARAMS = {"granite-3-8b": 32.69e9,
                          "recurrentgemma-9b": 37.58e9}


def _closed_form_state(cfg, shape, arch):
    """(master bytes, ``{unit: gathered bytes}``, optimizer bytes) one rank
    holds in a dry-run cell on ``pod_16x16``, from the rules: the model
    split over 16 ``model`` ranks (``Transformer.shard_`` on the meta
    device), each fp32 parameter held as its rule shard (its spec
    sanitized on the mesh), a unit's parameters gathered (the split ones
    to their ``model`` slice) only while it runs, and for a training cell
    the two AdamW moments over each shard; each storage rounded up to 512
    bytes as the caching allocator (and MemTracker) round it."""
    import types

    from repro_torch.launch import dryrun
    from repro_torch.models import Transformer
    from repro_torch.sharding import param_pspec, sanitize_pspec
    from repro_torch.sharding.tensor_parallel import TP
    from repro_torch.sharding.zero3 import unit_of

    def rounded(n):
        return -(-n // 512) * 512

    sizes = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    fsdp = ("data", "pod") if arch in dryrun.CROSS_POD_FSDP else "data"
    item = 2 if arch in dryrun.BF16_OPT else 4
    model = Transformer(cfg, device="meta").shard_(tp=TP(0, sizes["model"]))
    full = model.full_shapes()
    masters = opt = 0
    units: dict = {}
    for k, p in model.named_parameters():
        spec = sanitize_pspec(mesh, param_pspec(k, full[k], dp=fsdp),
                              full[k])
        div = 1
        for axes in spec:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                div *= sizes.get(a, 1)
        shard = math.prod(full[k]) // div
        masters += rounded(shard * 4)
        if shard < p.numel():
            units[unit_of(k)] = (units.get(unit_of(k), 0)
                                 + rounded(p.numel() * 4))
        if shape.kind == "train":
            opt += 2 * rounded(shard * item)
    return masters, units, opt


def _dryrun_real(tag, cfg, shape, accum, dev):
    """One real training step of ``cfg`` against the dry run's trace of
    it: the predicted peak, FLOPs and roofline bound beside the measured
    ones.  Returns the printed numbers."""
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.roofline import CostCounter, roofline_terms
    from repro_torch.runtime import make_train_step

    t0 = time.perf_counter()
    pred = dryrun.trace_cell(cfg, shape, None, dev=dev, accum=accum)
    trace_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = AdamW(lr=constant(3e-4))
    step = make_train_step(model, opt, accum)
    state = opt.init(step.master)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        cfg, shape, seed=SEED + 1).batch(0).items()}
    # the first step under the counter (it also warms up the libraries)
    with CostCounter() as cost:
        step(state, batch)
    torch.cuda.synchronize()
    ms, peaks = [], []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = step(state, batch)["loss"]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        check(bool(torch.isfinite(loss)), f"[dryrun] {tag}: loss {loss}")
    measured = max(peaks)
    predicted = pred["peak"]["Total"]
    terms = roofline_terms(pred["flops"], pred["bytes"], 0.0, 1)
    step_ms = float(np.median(ms))
    bound_ms = terms["bound_s"] * 1e3
    err = abs(predicted - measured) / measured
    cats = ", ".join(f"{k} {v / 2**30:.2f}" for k, v in pred["peak"].items()
                     if k != "Total" and v)
    print(f"[dryrun] {tag}: predicted peak {predicted / 2**30:.3f} GiB "
          f"({cats}; traced in {trace_s:.1f} s) vs max_memory_allocated "
          f"{measured / 2**30:.3f} GiB above the {base / 2**30:.2f} GiB "
          f"resident before: {err * 100:.2f} % (tol "
          f"{DRYRUN_PEAK_RTOL * 100:.0f} %)")
    print(f"[dryrun] {tag}: FLOPs traced {pred['flops']} vs the real step "
          f"{cost.flops}; bytes traced {pred['bytes']} vs {cost.bytes}")
    print(f"[dryrun] {tag}: step {step_ms:.1f} ms (steps {ms[0]:.1f}, "
          f"{ms[1]:.1f}) vs roofline bound {bound_ms:.3f} ms "
          f"({terms['dominant']}; compute {terms['compute_s'] * 1e3:.3f}, "
          f"memory {terms['memory_s'] * 1e3:.3f} ms): ratio "
          f"{step_ms / bound_ms:.2f}")
    check(err <= DRYRUN_PEAK_RTOL,
          f"[dryrun] {tag}: predicted peak off by {err * 100:.2f} %")
    check(pred["flops"] == cost.flops,
          f"[dryrun] {tag}: FLOPs {pred['flops']} != {cost.flops}")
    check(step_ms >= bound_ms,
          f"[dryrun] {tag}: step {step_ms:.3f} ms under its bound "
          f"{bound_ms:.3f} ms")
    del model, step, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"predicted": predicted, "measured": measured, "err": err,
            "flops": cost.flops, "ms": step_ms, "bound_ms": bound_ms}


def _repro_kv_share(cfg, shape, sizes=(16, 16)):
    """``repro``'s ``cache_pspec`` share a rank of a decode cell's KV
    caches on a (data, model) mesh of ``sizes``, in closed form: each
    (layers, B, T, n_kv, hd) leaf, k and v, its B over ``data`` and its T
    (a ring's ``min(T, local_window)`` slots) over ``model`` where they
    divide (``sanitize_pspec``), at the cache dtype's bytes."""
    from repro_torch.models.transformer import act_dtype
    data, model = sizes
    item = torch.empty((), dtype=act_dtype(cfg)).element_size()
    total = 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind in ("rec", "rwkv"):
            continue
        b, t = shape.global_batch, shape.seq_len
        if kind == "local":
            t = min(t, cfg.local_window)
        b //= data if b % data == 0 else 1
        t //= model if t % model == 0 else 1
        total += 2 * b * t * cfg.n_kv * cfg.hd * item
    return total


def phase_dryrun(dev):
    """[dryrun]: the dry run over the production cells, then its
    predictions against two real steps (see the module docstring)."""
    import tempfile

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun

    fake_rule_checks(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"[dryrun] card memory (total_memory) {total} bytes")
    with tempfile.TemporaryDirectory() as out:
        for arch, shape_name in DRYRUN_CELLS:
            res = dryrun.run_cell(arch, shape_name, out_dir=out, device=dev)
            print(f"[dryrun] {dryrun.summary(res)}")
            print(f"[dryrun]   roofline {json.dumps(res['roofline'])}")
            cfg = dryrun.cell_config(arch, SHAPES[shape_name])
            masters, units, opt = _closed_form_state(
                cfg, SHAPES[shape_name], arch)
            cats = res["memory"]["peak_by_category"]
            got = (cats.get("Parameter", 0), cats.get("Optstate", 0))
            # at the peak: the masters and the one unit gathered then
            held = {b: u for u, b in units.items()}.get(got[0] - masters,
                                                      "none")
            print(f"[dryrun]   parameter / optimizer bytes a rank {got}, "
                  f"closed form: masters {masters} + the unit gathered at "
                  f"the peak ({held}: {got[0] - masters}; largest "
                  f"{max(units.values())}), optimizer {opt}")
            check(got[1] == opt and (got[0] == masters or
                                     got[0] - masters in units.values()),
                  f"[dryrun] {arch} {shape_name}: parameter / optimizer "
                  f"bytes {got}, masters {masters}, units {units}, "
                  f"optimizer {opt}")
            # tensor parallel on model: every block split, a training
            # step's useful FLOPs at least half of what it runs, the
            # parameters at least 12 x under the gathered layout's
            check(res["tensor_parallel"] and not res["tp_gathered"],
                  f"[dryrun] {arch} {shape_name}: tensor_parallel "
                  f"{res['tensor_parallel']}, gathered {res['tp_gathered']}")
            if shape_name == "train_4k":
                check(res["useful_flops_ratio"] >= DRYRUN_USEFUL_MIN,
                      f"[dryrun] {arch} {shape_name}: useful_flops_ratio "
                      f"{res['useful_flops_ratio']:.4f} < "
                      f"{DRYRUN_USEFUL_MIN}")
            gathered = DRYRUN_GATHERED_PARAMS[arch]
            print(f"[dryrun]   parameters {got[0] / 1e9:.2f} GB a rank, "
                  f"{gathered / got[0]:.1f} x under the gathered "
                  f"{gathered / 1e9:.2f} GB")
            check(got[0] * DRYRUN_PARAM_CUT <= gathered,
                  f"[dryrun] {arch} {shape_name}: parameters "
                  f"{got[0] / 1e9:.2f} GB, not {DRYRUN_PARAM_CUT} x under "
                  f"{gathered / 1e9:.2f} GB")
            if SHAPES[shape_name].kind == "decode":
                # 8 KV heads on 16 ranks: the two ranks of each KV head
                # split its timeline, so a rank holds repro's share
                share = _repro_kv_share(cfg, SHAPES[shape_name])
                print(f"[dryrun]   KV cache {res['kv_cache_bytes']} B a "
                      f"rank, repro's cache_pspec share {share} B")
                check(res["kv_split_on_time"] and res["fit"]
                      and res["kv_cache_bytes"] == share,
                      f"[dryrun] {arch} {shape_name}: KV cache "
                      f"{res['kv_cache_bytes']} B a rank, repro's share "
                      f"{share} B, split on time {res['kv_split_on_time']},"
                      f" fit {res['fit']}")
        # Qwen1.5's 20 heads do not split over 16 ranks: its attention runs
        # whole on every rank, so its decode cell's KV cache splits on time
        res = dryrun.run_cell("qwen1.5-4b", "decode_32k", out_dir=out,
                              device=dev)
        print(f"[dryrun] {dryrun.summary(res)}")
        check(res["fit"] and res["kv_split_on_time"]
              and res["tp_gathered"] and not dryrun.EXPECTED_OVER_HBM,
              f"[dryrun] qwen1.5-4b decode_32k: fit {res['fit']}, split on "
              f"time {res['kv_split_on_time']}, gathered "
              f"{res['tp_gathered']}, expected over "
              f"{dryrun.EXPECTED_OVER_HBM}")
    granite = dataclasses.replace(
        get_config("granite-3-8b"), ffn_block_sparse=True, ffn_block=64,
        ffn_density=0.25, dtype="bfloat16", n_layers=DIST_LAYERS)
    hybrid = dataclasses.replace(
        get_config("recurrentgemma-9b"), dtype="bfloat16",
        n_layers=HYBRID_TRAIN_LAYERS, ffn_block_sparse=True, ffn_block=64,
        ffn_density=0.25)
    return [
        _dryrun_real(f"granite-3-8b {DIST_LAYERS} layers, sparse FFN, "
                     "8 x 256, accum 2",
                     granite, ShapeConfig("dist", "train", TRAIN_SEQ,
                                          TRAIN_BATCH), DIST_ACCUM, dev),
        _dryrun_real("recurrentgemma-9b 6 layers, 1 x 4096", hybrid,
                     ShapeConfig("hybrid-train", "train", HYBRID_TRAIN_T, 1),
                     1, dev)]


PHASES = ("spgemm", "ops", "tune", "check", "kernel", "crossover", "edges",
          "serve", "qkernel", "qserve", "qgrad", "train", "verify", "hybrid",
          "mixed", "hybrid_train", "ssm", "moe", "vlm", "encdec", "dist",
          "tp", "zero3", "seq", "dryrun", "rwkv_tp", "kv_group")
# the phases that need granite-3-8b built (``--only spgemm,ops,tune,check``,
# ``--only hybrid,mixed`` or ``--only ssm,moe,vlm,encdec`` skips it)
GRANITE_PHASES = PHASES[PHASES.index("kernel"):PHASES.index("hybrid")]


# the function one rank of each multi-rank phase runs
RANK_MAIN = {"tp": tp_rank, "zero3": zero3_rank, "seq": seq_rank,
             "rwkv_tp": rwkv_tp_rank, "kv_group": kv_group_rank}


def main():
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the paper's suite seeds each matrix from hash((name, seed)): one
        # hash seed gives [verify suite] the same matrices in every run
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, PYTHONHASHSEED="0"))
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", default=",".join(PHASES),
        help="comma-separated phases to run (default: all; the kernel JSON "
             "line and the ok line are printed only when all run)")
    # one rank of a multi-rank phase, started by _run_ranks
    parser.add_argument("--phase", choices=sorted(RANK_MAIN),
                        help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    only = args.only.split(",")
    bad = sorted(set(only) - set(PHASES))
    if bad:
        parser.error(f"unknown phases {bad}; choose from {PHASES}")
    full = set(only) == set(PHASES)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase is not None:
        RANK_MAIN[args.phase](args.rank, args.port, args.out)
        return
    from repro_torch.api import clear_plan_cache
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    marks = {"start": time.perf_counter(), "last": time.perf_counter()}

    def clock(tag):
        # wall seconds of each phase and since the start, for the budget
        now = time.perf_counter()
        print(f"[clock] {tag}: {now - marks['last']:.1f} s "
              f"(at {now - marks['start']:.1f} s)")
        marks["last"] = now

    smi = phase_card(checked="check" in only)
    clock("card")
    if "spgemm" in only:
        (spgemm_recs, spgemm_launches, spgemm_quantized,
         spgemm_simt) = phase_spgemm(dev)
        clock("spgemm")
        gc.collect()
        torch.cuda.empty_cache()
    if "ops" in only:
        ops_recs, attn_simt = phase_ops(dev)
        clock("ops")
        gc.collect()                 # Maverick's 21.5 GB of expert weights
        torch.cuda.empty_cache()
    if "tune" in only:
        tune_counts, tune_tc_rec, tune_g_rec = phase_tune(dev)
        clock("tune")
        gc.collect()
        torch.cuda.empty_cache()
    if "check" in only:
        phase_check(dev)
        clock("check")
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()   # [memory] reads the model's peak

    if set(only) & set(GRANITE_PHASES):
        cfg = dataclasses.replace(get_config("granite-3-8b"),
                                  ffn_block_sparse=True, ffn_block=64,
                                  ffn_density=0.25, dtype="bfloat16")
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[model] {cfg.name} full width: {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
              f"(padded {cfg.padded_vocab}); {n_params / 1e9:.3f} B fp32 "
              f"params; built and planned in {time.perf_counter() - t0:.1f} "
              f"s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

        if "kernel" in only or "crossover" in only:
            recs, plans = phase_kernels(model, dev)
            if "crossover" in only:
                phase_crossover(plans, dev)
            del plans
            clock("model, kernel, crossover")
        if "edges" in only:
            simt_launches = phase_edges(dev)
            clock("edges")
        if "serve" in only:
            launches, split, prompts, fp32_tokens = phase_serve(model, dev)
            print(f"[memory] peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            clock("serve")
        if "qkernel" in only:
            qrecs = phase_qkernel(model, dev)
            clock("qkernel")
        if "qserve" in only and "serve" in only:
            q_launches, q_split, _ = phase_qserve(model, dev, prompts,
                                                  fp32_tokens)
            clock("qserve")
        if "qgrad" in only:
            qt_launches = phase_qgrad(model, dev)
            clock("qgrad")
        gc.collect()                 # the serving engines and their caches
        torch.cuda.empty_cache()
        if "train" in only:
            train_launches, transposed = phase_train(model, dev)
            clock("train")
        if "verify" in only:
            (granite_replan, verify_g, verify_p, verify_g_rec,
             verify_p_rec) = phase_verify(model, dev)
            clock("verify")
        # granite's weights, its plans and the trainer's state before the
        # hybrid's 32 GB of parameters
        del model
        clear_plan_cache()
        gc.collect()
        torch.cuda.empty_cache()
    if "hybrid" in only:
        hybrid_lru, hybrid_fwd, hybrid_recs = phase_hybrid(
            dev, replan="verify" in only)
        clock("hybrid")
    # each family's model and plans are freed before the next is built
    clear_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()
    if "mixed" in only:
        mixed_fwd = phase_mixed(dev)
        clock("mixed")
        clear_plan_cache()
    if "hybrid_train" in only:
        train_counts, train_recs = phase_hybrid_train(dev)
        clock("hybrid_train")
        clear_plan_cache()
    if "ssm" in only:
        phase_ssm(dev)
        clock("ssm")
    if "moe" in only:
        phase_moe(dev)
        clock("moe")
    if "vlm" in only:
        vlm_split, vlm_tc, vlm_recs = phase_vlm(dev)
        clock("vlm")
        clear_plan_cache()
    if "encdec" in only:
        encdec_fwd, encdec_t, encdec_recs = phase_encdec(dev)
        clock("encdec")
        clear_plan_cache()
        gc.collect()
        torch.cuda.empty_cache()
    if "dist" in only:
        dist_counts, dist_recs = phase_dist(dev)
        clock("dist")
    # the phases below start ranks of their own, which share the card
    if "tp" in only:
        free_parent("tp")
        phase_tp(dev)
        clock("tp")
    if "zero3" in only:
        free_parent("zero3")
        phase_zero3(dev)
        clock("zero3")
    if "seq" in only:
        free_parent("seq")
        seq_ranks = phase_seq(dev)
        clock("seq")
    if "rwkv_tp" in only:
        free_parent("rwkv_tp")
        phase_rwkv_tp(dev)
        clock("rwkv_tp")
    if "kv_group" in only:
        free_parent("kv_group")
        kv_group_ranks = phase_kv_group(dev)
        clock("kv_group")
    if "dryrun" in only:
        gc.collect()
        torch.cuda.empty_cache()
        phase_dryrun(dev)
        clock("dryrun")
    if not full:
        print(f"chip_smoke: phases {only} passed")
        return

    def entry(name, mode, path, n_launches, main_rec, mine,
              kernel="segment_spmm"):
        if kernel == "segment_spmm" and main_rec.get("path") == "tc":
            kernel = "segment_spmm_tc"
        return {"name": name, "route": "cuda", "mode": mode, "path": path,
                "source": f"src/repro_torch/csrc/{kernel}.cu",
                # the backward kernels have no Pallas counterpart: they
                # stand where repro takes jax.grad of jnp code
                "replaces": "src/repro/" + {
                    "segment_spmm": "kernels/segment_spmm.py:335",
                    "segment_spmm_tc": "kernels/segment_spmm.py:335",
                    "segment_spgemm": "kernels/segment_spgemm.py:227",
                    "segment_spgemm_tc": "kernels/segment_spgemm.py:227",
                    "flash_attention": "kernels/flash_attention.py:93",
                    "moe_gemm": "kernels/moe_gemm.py:39",
                    "rg_lru": "kernels/rg_lru.py:56",
                    "rg_lru_bwd": "models/recurrent.py:69",
                    "flash_attention_bwd": "models/layers.py:114"}[kernel],
                "launches": n_launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"],
                "case": main_rec["case"], "n": main_rec.get("n")}

    def one(rs, **kw):
        return next(r for r in rs if all(r[k] == v for k, v in kw.items()))

    def on(rs, path, mode):
        return [r for r in rs if r["path"] == path and r["mode"] == mode]

    # split: up at decode width, bf16 x.T view (the serve path's decode
    # steps); tensor cores: up and up's dx at the training width (the train
    # path); simt: up at decode width with fp32 B (the edge sweep's fp32
    # calls; no main path runs it)
    fwd_split = on(recs, "split", "forward")
    fwd_tc = on(recs, "tc", "forward")
    t_tc = on(recs, "tc", "transpose_lhs")
    simt = [r for r in recs if r["path"] == "simt"]
    # spgemm: every main-path launch on tc; fp32 timed on down_up,
    # quantized on up_down in int8, with the worst error over the four
    # modes; simt (the edge sweep's 32-wide and non-square tiles, no main
    # path) timed on down_up fp32 forced onto it
    g32 = [r for r in spgemm_recs if r["mode"] == "fp32"]
    gq = [r for r in spgemm_recs if r["mode"] != "fp32"]
    g_simt = dict(g32[0], **g32[0]["by_path"]["simt"], path="simt")
    # quantized SpMM: int8 up at decode width (the qserve path's decode
    # steps), and int8 up's dx at N = 64 (the qgrad path), with the worst
    # error over the four modes of each direction on that path
    qf_rec = one(qrecs, quant="int8", case="up", n=4, mode="forward")
    qt_rec = next(r for r in qrecs if r["quant"] == "int8"
                  and r["case"].startswith("up") and r["n"] == QGRAD_SEQ
                  and r["mode"] == "transpose_lhs")
    # simt: no published-width case picks it (the edge sweep's D = 40 calls
    # that fill the card do); its times are those of granite prefill forced
    # onto it
    prefill = next(r for r in ops_recs if r["kernel"] == "flash_attention"
                   and r["case"] == "granite prefill"
                   and r["dtype"] == "float32")
    simt_rec = dict(prefill, **prefill["by_path"]["simt"], path="simt")
    # the backward kernels' simt paths at the model's calls, forced: their
    # launches are the checked calls of [hybrid_train] (one a case)
    def forced(case, path):
        rec = one(train_recs, case=case)
        f = rec["by_path"][path]
        return dict(rec, ms=f["ms"], path=path,
                    max_abs_err=max(a for _, _, a in f["errs"]),
                    **{k: f[k] for k in ("bound_ms", "bound_by") if k in f})

    bwd_simt = [r for r in train_recs if r["kernel"] == "flash_attention_bwd"
                and "simt" in r["by_path"]]
    bwd_simt_rec = forced("local bwd 1x4096 bf16", "simt")
    lru_simt = [r for r in train_recs if r["kernel"] == "rg_lru_bwd"
                and "simt" in r["by_path"]]
    lru_simt_rec = forced("rg_lru bwd 1x4096 bf16", "simt")
    print(smi)
    print(json.dumps({"kernels": [
        entry("segment_spmm", "split (folded owner runs, CUDA cores): "
              "forward", "serve", split, one(fwd_split, case="up", n=4),
              fwd_split),
        entry("segment_spmm.tensor_core", "tc (3 x bf16 wgmma): forward",
              "train", train_launches - transposed,
              one(fwd_tc, case="up", n=2048), fwd_tc),
        entry("segment_spmm.transpose_lhs", "tc (3 x bf16 wgmma): "
              "transpose_lhs", "train", transposed,
              one(t_tc, case="up dx (transpose_lhs)", n=2048), t_tc),
        entry("segment_spmm.simt", "simt (one block per owner run): fp32 "
              "B", "edges", simt_launches,
              one(simt, case="up", n=4, mode="forward"), simt),
        entry("segment_spgemm.tc", "tc (6 x bf16 wgmma passes, runs in "
              "Z-order): fp32", "spgemm", spgemm_launches - spgemm_quantized,
              next(r for r in g32 if r["case"] == "spgemm_down_up"), g32,
              kernel="segment_spgemm_tc"),
        entry("segment_spgemm.tc.quantized", "tc (1 bf16 pass per block, 3 "
              "rowwise): int8/fp8", "spgemm", spgemm_quantized,
              next(r for r in gq if r["mode"] == "int8"), gq,
              kernel="segment_spgemm_tc"),
        entry("segment_spgemm.simt", "simt (one block per owner run, CUDA "
              "cores): timed forced at down_up fp32", "spgemm-edges",
              spgemm_simt, g_simt, [g_simt], kernel="segment_spgemm"),
        # [verify]: the paper's suite through the kernels, every plan
        # verified; timed at its largest case
        entry("segment_spgemm.tc", "tc: fp32, the paper's suite A @ Aᵀ "
              "at 64 x 64 blocks (verify='full')", "verify", verify_g,
              verify_g_rec, [verify_g_rec], kernel="segment_spgemm_tc"),
        entry("segment_spmm.simt", "simt: fp32 X, the paper's suite A @ X "
              "at 64 x 64 blocks (verify='full')", "verify", verify_p,
              verify_p_rec, [verify_p_rec]),
        entry("segment_spmm.quantized", "split: int8/fp8 forward", "qserve",
              q_split, qf_rec, on(qrecs, "split", "forward")),
        entry("segment_spmm.quantized.transpose_lhs",
              f"{qt_rec['path']}: int8/fp8 transpose_lhs", "qgrad",
              qt_launches, qt_rec, on(qrecs, qt_rec["path"],
                                      "transpose_lhs"))]
        + [entry(name, mode, "ops", sum(r["launches"] for r in mine),
                 next(r for r in mine if r["case"] == case), mine,
                 kernel=kernel)
           for name, kernel, mode, case in (
               ("flash_attention.splitkv", "flash_attention",
                "splitkv (KV axis split over blocks, CUDA cores): fp32, "
                "causal, GQA", "granite decode"),
               ("flash_attention.tc", "flash_attention",
                "tc (6 x bf16 wgmma passes): fp32, causal, GQA",
                "granite prefill"),
               ("moe_gemm", "moe_gemm", "tensor cores (TMA + wgmma): bf16 x "
                "and w, live_rows, fp32 out", "maverick moe T=4096"),
               ("rg_lru.tile", "rg_lru", "tile (TMA-fed tiles of time steps, "
                "gates by two warpgroups, one scan warp): fp32",
                "rg_lru fp32"),
               ("rg_lru.simt", "rg_lru", "simt (one thread a channel): "
                "decode", "rg_lru decode"))
           for mine in ([r for r in ops_recs if r["kernel"] == kernel
                         and r.get("path", kernel) in name],)]
        + [entry("flash_attention.simt", "simt (one block walks all of Tk, "
                 "CUDA cores): fp32, causal, GQA, timed forced at granite "
                 "prefill", "ops-edges", attn_simt, simt_rec, [simt_rec],
                 kernel="flash_attention")]
        # the hybrid's own launches: every serving call's RG-LRU on simt,
        # the forward's RG-LRU on tile and its local attention on tc, each
        # timed at the shape the model gives it (bf16 operands)
        + [entry(name, mode, path, n, one(hybrid_recs, case=case),
                 [one(hybrid_recs, case=case)], kernel=kernel)
           for name, kernel, mode, path, n, case in (
               ("rg_lru.simt", "rg_lru", "simt (one thread a channel): "
                "bf16, 4-slot decode and token-wise prefill", "hybrid-serve",
                hybrid_lru, "rg_lru decode"),
               ("rg_lru.tile", "rg_lru", "tile: bf16, 1 x 4096 forward",
                "hybrid-forward", hybrid_fwd["rg_lru"], "rg_lru forward"),
               ("flash_attention.tc", "flash_attention", "tc: bf16, 16 heads "
                "/ 1 KV, D = 256, window 2048, 1 x 4096 forward",
                "hybrid-forward", hybrid_fwd["flash"], "local forward"))]
        # [mixed]: local layers beside full-attention ones; the local
        # layers' forward launches, timed at the same call in [hybrid]
        + [entry("flash_attention.tc", "tc: bf16, 16 heads / 1 KV, D = 256, "
                 "window 2048, 1 x 4096 forward of the local layers beside "
                 "full-attention ones", "mixed-forward", mixed_fwd["flash_tc"],
                 one(hybrid_recs, case="local forward"),
                 [one(hybrid_recs, case="local forward")],
                 kernel="flash_attention")]
        # [tune]: the tuned plans through plan(), timed at the training
        # width (SpMM) and the suite's largest A @ Aᵀ (SpGEMM)
        + [entry("segment_spmm.tensor_core", "tc: tuned plans "
                 "(autotune_matmul(objective='cuda') knobs), granite FFN",
                 "tune", tune_counts["spmm_tc"], tune_tc_rec, [tune_tc_rec]),
           entry("segment_spgemm.tc", "tc: tuned plans, the paper's suite "
                 "A @ Aᵀ at 64 x 64 blocks", "tune", tune_counts["spgemm"],
                 tune_g_rec, [tune_g_rec], kernel="segment_spgemm_tc")]
        # [hybrid_train]: the two backward kernels, launched by the Trainer
        # run, each timed at the model's call
        + [entry(name, mode, "hybrid-train", train_counts[count],
                 one(train_recs, case=case),
                 [r for r in train_recs if r["kernel"] == kernel
                  and r["path"] == path], kernel=kernel)
           for name, kernel, path, mode, count, case in (
               ("rg_lru_bwd.tile", "rg_lru_bwd", "tile", "tile (TMA-fed "
                "tiles walked last to first, eight gate warps, one chain "
                "warp): bf16, 1 x 4096 x 4096", "rg_lru_bwd_tile",
                "rg_lru bwd 1x4096 bf16"),
               ("flash_attention_bwd.tc", "flash_attention_bwd", "tc", "tc "
                "(wgmma fed by a TMA ring; KV-outer dK/dV over row ranges, "
                "Q-outer dQ recomputing S and dP; P and dS as bf16 parts): "
                "bf16, 16 heads / 1 KV, D = 256, window 2048, 1 x 4096",
                "flash_bwd_tc", "local bwd 1x4096 bf16"))]
        # the backward kernels' simt paths: fp32 D % 16 != 0 attention and
        # short or TMA-unreadable RG-LRU calls, no main path; their launches
        # are the checked calls of [hybrid_train] (one a case), their times
        # those of the model's calls forced onto them
        + [entry(name, mode, "hybrid-train-checks", n, rec, [rec],
                 kernel=kernel)
           for name, kernel, mode, n, rec in (
               ("flash_attention_bwd.simt", "flash_attention_bwd",
                "simt (fp32 on the CUDA cores): timed forced at the local "
                "block, 1 x 4096 bf16", len(bwd_simt), bwd_simt_rec),
               ("rg_lru_bwd.simt", "rg_lru_bwd", "simt (one block of 256 "
                "threads a 16-channel tile, 16 walk the chain): timed "
                "forced at 1 x 4096 x 4096 bf16", len(lru_simt),
                lru_simt_rec))]
        # the last families' SpMM launches, each timed at the shape its
        # path gives it: InternVL2-2B's decode (split) and its forward over
        # 256 vision + 1024 text positions (tc); Whisper-tiny's training
        # steps, forward and dx at the encoder's 8 x 1500 rows (tc)
        + [entry(name, mode, path, n, rec, [rec])
           for name, mode, path, n, rec in (
               ("segment_spmm", "split: bf16 x, InternVL2-2B decode",
                "vlm-serve", vlm_split, one(vlm_recs, n=4)),
               ("segment_spmm.tensor_core", "tc: InternVL2-2B forward, 256 "
                "vision + 1024 text positions", "vlm-forward", vlm_tc,
                one(vlm_recs, mode="forward", path="tc")),
               ("segment_spmm.tensor_core", "tc: Whisper-tiny training "
                "forward (remat)", "encdec-train", encdec_fwd,
                one(encdec_recs, mode="forward")),
               ("segment_spmm.transpose_lhs", "tc: Whisper-tiny training dx",
                "encdec-train", encdec_t,
                one(encdec_recs, mode="transpose_lhs")),
               # [dist]: the sharded Trainer's run (1 x 1 mesh, NCCL),
               # timed at its microbatch of 4 x 256 tokens
               ("segment_spmm.tensor_core",
                f"tc: granite-3-8b, {DIST_LAYERS} layers, sharded Trainer "
                "forward (remat)", "dist-train",
                dist_counts["spmm"] - dist_counts["spmm_t"],
                one(dist_recs, mode="forward")),
               ("segment_spmm.transpose_lhs",
                f"tc: granite-3-8b, {DIST_LAYERS} layers, sharded Trainer dx",
                "dist-train", dist_counts["spmm_t"],
                one(dist_recs, mode="transpose_lhs")))]
        # [seq]: the three ranks' launches on the (1, 3) mesh (fp32 B, so
        # simt), training with seq_shard and decode over the KV cache split
        # on time, each timed at a rank's shape
        + [entry(name, mode, path, sum(n(r) for r in seq_ranks),
                 one(seq_recs, case=case), [one(seq_recs, case=case)])
           for seq_recs in (seq_ranks[0]["kernels"],)
           for name, mode, path, n, case in (
               ("segment_spmm.simt", "simt: fp32 B, Qwen1.5-4B, 2 layers, "
                "seq_shard Trainer forward at a rank's 512 of 1536 rows, "
                "(1, 3) mesh", "seq-train",
                lambda r: r["counts"]["spmm"] - r["counts"]["spmm_t"],
                "up, a rank's rows"),
               ("segment_spmm.transpose_lhs", "simt: fp32 B, Qwen1.5-4B, 2 "
                "layers, seq_shard Trainer dx at a rank's 512 rows",
                "seq-train", lambda r: r["counts"]["spmm_t"],
                "up dx, a rank's rows"),
               ("segment_spmm.simt", "simt: fp32 B, Qwen1.5-4B decode (2 "
                "rows) over the KV cache split on time, (1, 3) mesh",
                "seq-decode", lambda r: r["decode_counts"]["spmm"],
                "up, decode"))]
        # [kv_group]: the four ranks' RG-LRU decode launches (simt) on the
        # (1, 4) mesh over the ring split on time, timed at a rank's call
        + [entry("rg_lru.simt", "simt (one thread a channel): fp32, "
                 "RecurrentGemma-9B decode at a rank's 1024 channels over "
                 "the ring split on time, (1, 4) mesh", "kv_group-decode",
                 sum(r["counts"]["rg_lru_simt"] for r in kv_group_ranks),
                 kv_rec, [kv_rec], kernel="rg_lru")
           for kv_rec in kv_group_ranks[0]["kernels"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
