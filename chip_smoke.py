#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --only tt_linear_batched_a,decode_attention

The second form builds the kernels and runs only the named kernels' rows
of phase 2 (names as in ``KERNELS``), then stops without a result line.

Phases, each printed on its own lines:
  1. the card's name and power limit (nvidia-smi), then an nvcc build of
     every kernel under src/repro_torch/kernels/csrc, with each kernel's
     registers and spills (ptxas -v);
  2. each kernel against its plain PyTorch version on the card, in bf16 at
     the serving path's and the training path's full-width shapes, with
     the stated tolerance; the kernel's, the plain version's and one
     library call's times (the library call is a yardstick only: the port
     never calls it); where a launcher chooses among kernels or splits
     (K1, the flash forward, K2's, #9's and #10's slices of K, #8's
     product and K4's, #8's and #8q's window chunks), which one ran and
     every variant's time; K1 at ranks 256, 512, 1024 and 2048 at M = 64
     and at the training shape as forward and dx; #9, K2 and #10 at ranks
     384 and 1024 (M = 4 and 64); K2 and #10 at M = 4, 8, 16
     and 64, K4 at 256
     and 4096 cells, #9 at M = 16, 64, 128 and 256 and #8 / #8q at C = 1
     and 32 must agree bit for bit across two calls;
     #8q's error beside that of p cut to bf16; K2 and #10 at 72 decode
     rows through ``ops`` (two launches each); at the training shape two
     flash backward calls must agree bit for bit, and
     #5-#7 and K1's forward and dx (on the views the backward passes)
     print their TFLOP/s and share of bound; the same for #5, #6 and #7
     at head_dim 256 (gemma-7b's (4, 1024, 16, 16, 256), T = 1000 and
     GQA group 2; ``_d256`` rows, SDPA's bf16 backward as library, its
     backend named); then the f32 instances
     (``[kernel-f32]`` lines) against their plain f32 versions: K1 at
     M = 4096, K = N = 1024, r = 8 as forward and dx, r = 64, and at
     K = N = 768, r = 1024 (M = 64 and 4096); K3, #5, #6 and #7 at
     (B, T, H, KV, d) = (4, 1024, 16, 16, 64) and T = 1000 — within 1e-4
     of max |plain|, lse within 1e-5, two #6 / #7 calls bit-identical,
     bound = max(bytes / 3.35 TB/s, flops / 164.9 TFLOP/s) and the share
     of FFMA's 67 TFLOP/s, library = torch.matmul / SDPA in f32; and
     the f32 serving instances at roberta-large's shapes: K2 at M = 4,
     8, 64 (K = N = 1024, r = 8) and M = 4 at K = N = 768, #9 (M = 64)
     and #10 (M = 4, 8) over int8 W at K = N = 1024 per channel and in
     groups of 128 rows and at 768, K4 over 4 slots x 256 cells, #8 and
     #8q at C = 32 and C = 1 (8 slots, 34-page tables), each two calls
     bit-identical; then the head_dim
     256 instances (gemma-7b: 16 heads of 256) within 2e-2 of their plain
     versions, two calls bit-identical: K3 at T = 16, 64, 96, 256, #5 at
     T = 64 (lse within 1e-3), K4 over
     4 x 256 and 4 x 4096 cells, #8 and #8q at phase 4's shape; and K1
     (M = 64), K2 (M = 4), #9 (M = 64) and #10 (M = 4) at gemma-7b's q / v
     projection, K = 3072 -> N = 4096, r = 8; then the any-group rows
     (``gqa_rows`` of the record) at granite-34b's H = 48 over KV = 1
     (G = 48) and mistral-large's H = 96 over KV = 8 (G = 12), d = 128:
     K4 over 4 slots x 256 cells, #8 and #8q at C = 1 and 32 (8 slots,
     34-page tables), within 2e-2 of their plain versions, two calls
     bit-identical, SDPA with ``enable_gqa`` as library; and K1 (M = 64)
     and K2 (M = 4) at their q / v projections (6144 -> 6144 and -> 128,
     12288 -> 12288 and -> 1024, r = 8); and #5, #6 and #7 at their
     training shapes, (B, T, H, KV, d) = (4, 1024, 48, 1, 128), its
     ragged T = 1000 and (4, 1024, 96, 8, 128): dq / dk / dv within 2e-2
     of max |plain|, lse 1e-3, two calls bit-identical, #7 timed at
     several slab sizes of the group (``dkv_slab_heads`` picks one), SDPA's
     bf16 backward on k / v repeated to H as library; then the head_dim
     112 instances at kimi-k2's 64 heads over 8 (G = 8), within 2e-2 of
     their plain versions, two calls bit-identical, SDPA with
     ``enable_gqa`` as library: K3 at B = 1, T = S = 64, #5 at 4 x 1024
     (lse within 1e-3), K4 over 4 slots x 256 cells, #8 and #8q at C = 1
     and 32 (8 slots, 34-page tables); and K1 (M = 64), K2 (M = 4), #9
     (M = 64) and #10 (M = 4) at kimi-k2's q / v projections (7168 ->
     7168 and -> 896, r = 8); and #5, #6 and #7 at d = 112 at kimi-k2's
     training shapes, (B, T, H, KV) = (4, 1024, 64, 8), its ragged
     T = 1000 and B = 1 (where #7 runs in slabs of heads): dq / dk / dv
     within 2e-2 of max |plain|, two calls bit-identical, TFLOP/s of the
     112-wide work, SDPA's bf16 backward with ``enable_gqa`` as library;
  3. the dense-cache serving engine on full-width stablelm-1.6b (random
     weights from a seeded generator, 4+1d MetaTT adapter over 3 tasks):
     8 mixed-task requests, with every kernel's launch count read around
     ``generate`` (K2 48 and K4 24 a decode step); under the served
     adapter the kernel leg's prefill
     logits are held against the plain leg's distance from an f32 plain
     leg, and under a mild adapter the prefill logits and one 4-slot
     mixed-task decode step are held against the plain leg;
  4. the paged serving engine (the default ServeConfig mode) on the same
     full-width model: 16 requests of 40-300 prompt tokens over 3 tasks,
     half of them sharing a 100-token prefix per task, served cold then
     warm; every request finished, #8's launches 24 per engine step,
     prefix hits and copy-on-write on the warm run, no leaked block; tok/s,
     decode ms/step, TTFT/TPOT, peak memory and the device-busy share;
     under a mild adapter one pure-decode and one mixed prefill/decode
     paged step, kernel leg against the plain leg;
  5. quantized serving on the same full-width model: the paged engine with
     int8 base weights and int8 KV pools over phase 4's 16 requests, cold
     then warm (#8q 24 launches per engine step, fp #8 none, warm prefix
     hits and copy-on-write, no leaked block, peak KV bytes below phase
     4's), then the dense engine with int8 weights over phase 3's 8
     requests (#9 48 launches per prefill, #10 48 per decode step, K1 / K2
     none; greedy agreement with phase 3's fp tokens printed); under a
     mild adapter one int8 paged step and one w8 dense decode step, kernel
     leg against the plain leg;
  6. training through the port's Trainer on full-width stablelm-1.6b
     (MetaTT 4d on q/v from rank 10, AdamW, remat per block, 4 x 1024
     tokens a step, 6 steps with one DMRG sweep to rank 8): finite losses,
     moved cores, ranks 8 after the sweep, K1 / #5 / #6 / #7 launch counts
     around ``train``, exactly 142 / 48 / 24 / 24 a step; then a gradient
     check at B=1 against the plain bf16 leg with an f32 plain leg as
     witness;
  7. adapters and checkpoints on the same full-width model: (a) LoRA r=8,
     VeRA r=1024 (K1's pre-pass variant), LoTR r=64 and MetaTT-5d r=8,
     3 Trainer steps each on one shared base (finite losses, ΔW moved off
     0, K1 142 / #5 48 / #6 24 / #7 24 launches a step), and gradient
     checks for VeRA and LoRA; (b) phase 6's run checkpointed every 3
     steps, failed at step 5 and resumed by a new Trainer (step 3, ranks
     8, the sweep not replayed), its cores within 1e-3 of phase 6's;
     (c) the dense engine under the live, lora and merged (task 1)
     runtimes (launch counts per prefill and decode step; lora / merged
     prefill logits vs live under a mild adapter within 5%; the merged
     engine rejects task 0; tok/s and decode ms a step), and the paged
     engine under the lora runtime; (d) phase 5's int8 dense engine saves
     its base, a second engine loads it and gives the same tokens;
  8. the rest of training and speculative decode on the same full-width
     model ((a) and (e) at 12 of its 24 layers, ``PHASE8_LAYERS``): (a)
     the dense 4-slot cell over an int8 base with VeRA r=1024
     (#9 above rank 64) and a 4+1d MetaTT r=384 (#10 above rank 64),
     every token within 5% of the largest logit of the plain leg's
     teacher-forced maximum; (b) two full fine-tuning steps (peak memory,
     step time, the base moved, #5 / #6 / #7 launched, loss and gradient
     norm against the plain step); (c) a two-site DMRG sweep of phase 6's
     adapter (ranks, loss before and after, gradient calls); (d) Trainer
     steps with int8 and top-k gradient compression; (e) speculative
     decode (spec_k 3, draft rank 4, layer stride 2) on the dense cell and
     the paged cell (fp, then int8 KV) against the same engine without it
     (acceptance, tokens per step, tok/s; teacher-forced tokens; K4 once
     a verified column; #8 / #8q on the verifier; no leaked block);
  9. the paged adapter registry, chaos and preemption on the same
     full-width model cut to 4 of its 24 layers (the registry, chaos and
     preemption are host bookkeeping, which depth does not change; the
     cut — 12 layers until phase 14 came, 6 until phases 22-23 — keeps
     the script inside its time)
     with a 4+1d adapter
     over 64 tasks at 0.1 of the
     base q projection, every run under a ChaosInjector whose audit runs
     after every host-loop iteration (no pin, no leaked block after it):
     (a) the paged fp cell with 4 pool slots, 48 requests over 24 tasks
     cold then warm (faults + hits = admissions, evictions, waits and
     hits > 0, warm prefix hits after eviction, #8 launched), every
     token within 5% of the plain leg's teacher-forced maximum, the count
     equal to the all-resident engine's printed; (b) the dense cell under
     the lora runtime, fp and w8, with 3 pool slots (K2 / #10 2L = 8 a
     decode step on A gathered from the pool); (c) a seeded chaos run (forced
     allocation failures, two failed fault-ins, a cancel, a NaN row):
     one CANCELLED, one FAILED with 5 tokens, the survivors checked
     against the plain leg; (d) recompute preemption in a 10-block pool
     (the running request preempted, re-queued and finished); (e)
     speculative decode with the registry (dense), tokens equal to the
     same spec engine's without it; tok/s, ms a step and device busy
     share a run, the ms of one fault-in;
  10. RoBERTa, the paper's own targets, in f32 (TF32 off, asserted): (a)
     full-width roberta-large trained as phase 6 (MetaTT 4d on q/v from
     rank 10, 6 steps of 4 x 1024 tokens, one DMRG sweep to rank 8) with
     f32 K1 / #5 / #6 / #7 launches of 6L-2 / 2L / L / L a step and no
     bf16 launch, the median step, tokens/s, peak memory and busy share,
     and a gradient check at B=1 against the plain f32 leg (loss 1e-5,
     gradients 1e-4); (b) full-width roberta-base with Table 1's LoRA
     r=8, VeRA r=1024, LoTR r=40, MetaTT-4d r=8 and MetaTT-5d r=16, 3
     steps each on one base, trainable counts equal to the paper's; (c)
     a no-grad forward of roberta-large over 4 x 1024 tokens (f32 K1 and
     K3) within 1e-4 of the plain leg's largest logit;
  11. RoBERTa served in f32 (TF32 off): roberta-large at full width and
     6 of its 24 layers (``F32_SERVE_LAYERS``) with a
     4+1d MetaTT adapter on q/v (rank 8, 3 tasks) through (a) the dense
     engine (phase 3's cell: 2L K2f + L K4f a decode step, K1f / K3f at
     prefill), (b) the paged engine cold then warm (phase 4's cell: L #8f
     an engine step, prefix hits, COW, no leaked block), (c) the same with
     int8 KV (#8qf in #8f's place, kv_bytes_peak below (b)'s) and (d)
     speculative decode (k 3, drafter rank 4, stride 2) dense and paged,
     tokens equal to (a)'s / (b)'s; no bf16 launch; decode-step and
     paged-step logits and every generated token within 1e-4 of the plain
     f32 leg's largest logit (tokens equal to the plain leg's counted);
     tok/s, step ms, prefill ms, kv_bytes_peak and device busy share; (e)
     roberta-large at 3 of its 24 layers (widths kept) over int8 weights
     through the f32 instances of #9 and #10: (e1) (a)'s cell with ``QuantConfig(weights="int8")`` (2L #9f a
     prefill, 2L #10f + L K4f a decode step, no K1f / K2f), (e2) (b)'s
     cell with int8 weights and int8 KV cold then warm (L #8qf a step;
     its (B, 32) steps run the einsum, so no #9f / #10f), (e3) (e1)'s
     cell over 4 requests with scales per group of 128 rows; decode-step
     and paged-step logits and every token within 1e-4 of the plain f32
     leg over the same int8 base (e2's tokens 1e-3, as (c)); no bf16
     launch; the phases' seconds and the script's;
  12. gemma-7b served at full width (28 x 3072, 16 heads of 256 over 16
     KV heads, GeGLU 24576, vocab 256000, bf16; 8.54 B random weights
     from the seed; at 14 of its 28 layers, ``GEMMA_SERVE_LAYERS``) with a
     4+1d MetaTT q/v adapter (rank 8, 3 tasks) at
     0.25 of the base q projection, through the head_dim 256 instances of
     K3, K4, #8 and #8q: (a) phase 3's dense cell (2L K1 + L K3 a
     prefill, 2L K2 + L K4 a decode step, nothing else), (b) phase 4's
     paged cell cold then warm (L #8 an engine step, prefix hits, COW, no
     leaked block), (c) int8 weights and int8 KV (L #8q a paged step,
     kv_bytes_peak below (b)'s; then the dense engine over int8 weights:
     2L #9 a prefill, 2L #10 a decode step) — prefill, decode-step and
     paged-step logits within 5% of the plain leg's largest; tok/s, step
     ms, prefill ms / TTFT, kv_bytes_peak, device busy share and peak
     memory a cell, each cell's model freed before the next;
  13. gemma-7b trained at full width in phase 6's setting (MetaTT 4d on
     q/v from rank 10, AdamW, remat per block, 6 steps of 4 x 1024 tokens,
     one DMRG sweep to rank 8): finite losses, moved cores, ranks 8,
     exactly 166 K1 / 56 #5d / 28 #6d / 28 #7d launches a step and
     nothing else; median step, tokens/s, peak memory and busy share;
     then, the trainer freed, phase 6's B = 1 gradient check (the f32
     witness's base is 34.2 GB) with its peak memory; ``[phase13]`` lines;
  14. granite-34b (88 x 6144, 48 heads of 128 over ONE KV head: MQA,
     G = 48; gelu 24576; vocab 49152) and mistral-large-123b (12288, 96
     heads of 128 over 8: G = 12; SwiGLU 28672; vocab 32768) in bf16, each
     with a 4+1d MetaTT q/v adapter (rank 8, 3 tasks) at 0.25 of the base
     q projection (the v adapter 6144 -> 128 / 12288 -> 1024), through
     the any-group instances of K4, #8 and #8q, each at 8 of its 88
     layers (``GQA_DEPTHS``; mistral-large's 122.2 B parameters do not
     fit one card), one build a model: (a) the dense cell (the engine must
     allocate no second base), 4 requests of 16-96 tokens, 16 new each
     (2L K1 + L K3 a prefill, 2L K2 + L K4 a decode step), then (b) phase
     4's paged cell cold then warm and (c) the same with int8 KV pools
     over the bf16 base (L #8 / #8q a step, kv_bytes_peak below (b)'s); prefill,
     decode-step and paged-step logits within 5% of the plain leg's
     largest; tok/s, step ms, prefill ms / TTFT, kv_bytes_peak, busy
     share and peak memory a cell; each model freed before the next;
     ``[phase14]`` lines and the phase's seconds on the ``[time]`` line;
  15. granite-34b at 16 of its 88 layers (13 GB of bf16 base) and
     mistral-large-123b at 8 (23.8 GB) trained at full width in phase 6's
     setting (MetaTT 4d on q/v from rank 10, AdamW, remat per block, 6
     steps of 4 x 1024 tokens, one DMRG sweep to rank 8) through K1, #5
     and the any-group #6 / #7 (G = 48: #7 in slabs of 6 heads merged in
     slab order; G = 12): finite losses, moved cores, ranks 8, exactly
     6L - 2 K1 / 2L #5 / L #6 / L #7 launches a step and nothing else;
     median step, tokens/s, peak memory, busy share and the top device
     operations; then phase 6's B = 1 gradient check with its f32 witness
     (granite at 16 layers, mistral on its first 4: at 8 the witness does
     not fit beside the base); each model freed before the next;
     ``[phase15]`` lines and the phase's seconds on the ``[time]`` line;
  16. granite-moe-1b-a400m (MoE, 32 experts, top-8) served at full width
     and 12 of its 24 layers and trained at full width and depth, and
     MetaTT-(4+E)D (``phase_sixteen``; ``[phase16]`` lines);
  17. kimi-k2 (7168, 64 heads of 112 over 8, 384 experts of SwiGLU 2048,
     top-8 at capacity factor 1.25, one shared expert, vocab 163840) at
     full width and 1 of its 61 layers (36.5 GB of bf16 base), served
     through the d = 112 instances of K3, K4, #8 and #8q with a 4+1d
     adapter at 0.25 of the base q projection: (a) the dense cell, (b) the
     paged cell cold then warm, (c) int8 weights + KV paged then the w8
     dense cell, (d) a 4+ed adapter through the dense cell; exact
     launches a step, the paged invariants, every cell's logits under the
     f32 witness rule with the f32 leg run after the bf16 model is freed
     (``Deferred``); ``[phase17]`` lines;
  18. kimi-k2 at the same width and depth trained in phase 6's setting
     with MetaTT-(4+E)D on q, v and ``moe_down`` through K1 and the d = 112
     instances of #5, #6 and #7 (exactly 4 / 2 / 1 / 1 a step), the median
     step, tokens/s, busy share and top device operations, then the B = 1
     gradient check with its 73 GB f32 witness run after the trainer and
     its bf16 base are freed (``deferred_grad_check``); ``[phase18]``
     lines;
  19. jamba-v0.1-52b (4096; a super-block of 7 mamba layers — d_inner
     8192, d_state 16, dt_rank 256, conv 4 — and one attention layer of 32
     heads of 128 over 8; 16 experts of SwiGLU 14336 top-2 on every second
     layer; vocab 65536) at full width and 1 of its 4 super-blocks (25.5 GB
     of bf16 base), MetaTT 4d on attn q / v and mamba in / out: (a) 4
     prompts of 512 tokens prefilled (the chunked scan) and 32 decode steps
     from the prefilled mamba states and KV caches, exact launches (16 K1 +
     1 K3 a prefill, 16 K1 + 1 K4 a step), prefill ms, step ms, tok/s,
     busy share, the prefill / decode / parallel-forward logits under the
     f32 witness rule with the f32 leg deferred, and the decode steps
     against the parallel forward, at capacity factor 2.0 and at 8.0
     (where no pair is dropped: f32 decode within 2e-2 of the f32
     parallel forward); (b) phase 6's training (exactly 47 K1, 2 #5, 1 #6,
     1 #7 a step) and the B = 1 gradient check with its f32 witness
     deferred; ``[phase19]`` lines;
  20. xlstm-125m (12 x 768, alternating mLSTM / sLSTM, 4 heads of 192,
     no FFN) at full width and 6 of its 12 layers (``XLSTM_LAYERS``),
     MetaTT 4d on mLSTM q / v and sLSTM z
     (``phase_twenty``): (a) a parallel forward of 4 x 512 tokens (9 K1)
     and decode from zero states over them and 32 greedy steps (9 K1 a
     step), every K1 of a forward and 8 steps held to its plain version
     on the path's inputs, the bf16 legs' logits reported (the model is
     chaotic in bf16 at random init, the witness vacuous), the f32
     instances of K1 / K2 against the f32 plain leg and the f32 decode
     against the f32 parallel forward asserted, then a 4+1d decode with a
     task a row (9 K2 a step); (b) phase 6's training, 3 steps (25 K1 a
     step), and the B = 1 gradient check; ``[phase20]`` lines;
  21. whisper-large-v3 (32 encoder + 32 decoder layers of 1280, 20 heads
     of 64, gelu 5120, layernorm; 1536 stub frames) at full width and
     depth, MetaTT 4d on self- and cross-attention q / v
     (``phase_twentyone``): (a) 4 x 1536 frames encoded and 4 x 256
     tokens prefilled (192 K1; 96 K3 — encoder, causal, cross — counted
     by kind), 32 greedy decode steps recomputing the cross k / v from
     ``enc_out`` (128 K1, 32 K4, 32 cross K3 at T = 1 a step), logits
     under the f32 witness rule, the f32 decode against the f32 parallel
     forward; (b) phase 6's training over 4 x 1536 frames, 4 steps (508
     K1, 160 #5 of three kinds, 96 #6, 96 #7 a step) and the B = 1
     gradient check; ``[phase21]`` lines;
  22. paligemma-3b (18 x 2048, 8 heads of 256 over one KV head: MQA,
     G = 8; GeGLU 16384; vocab 257216; 256 stub patch embeddings before
     the text) at full width and depth, a 4+1d MetaTT q / v adapter
     (``phase_twentytwo``): (a) ``make_prefill`` over 4 x (256 patches +
     256 tokens) (36 K1, 18 K3 at T = S = 512), (b) 32 greedy steps
     through ``make_serve_step`` from cell 512 with a task a row (36 K2,
     18 K4 a step), prefill and decode logits within 5% of the plain leg
     and under the f32 witness rule, the f32 decode against the f32
     parallel forward; (c) the dense engine (phase 3's cell) and the
     paged engine fp and int8 KV (phase 4's cell, #8 / #8q) on text-only
     requests; (d) phase 6's training, 3 steps of 4 x (256 patches + 768
     tokens) under the prefix loss (106 K1, 36 #5, 18 #6, 18 #7 a step),
     and the B = 1 gradient check; ``[phase22]`` lines;
  23. serve-time tensor parallelism (``phase_twentythree``): a one-rank
     NCCL group over a ``file://`` store, stablelm-1.6b at full width and
     4 of its 24 layers through ``ServeConfig(mesh_shape=(1, 1))`` with
     and without ``row_parallel``: the dense engine (K2, K4), the paged
     engine (#8), the paged engine over int8 weights and KV (#8q) and the
     dense engine over int8 weights (#9, #10), tokens equal to the
     unsharded engine's and the step logits bit-identical;
     ``[phase23]`` lines;
then one JSON line with every kernel's record (launches per path; the
f32, d = 256 and d = 112 instances under their own names with every
phase-2 row; K1, K2, #9 and #10 with their rows at gemma-7b's and
kimi-k2's q / v; K1, K2, K4, #8, #8q, #5, #6 and #7 with their rows at
granite's and mistral's; K1 and K2 at xlstm-125m's, K1, K3, K4, #5,
#6 and #7 at whisper-large-v3's and K3, K4, #8, #8q, #5, #6 and #7 at
paligemma-3b's shapes).
The last line is ``{"ok": true, "device": {...}}``. Any failed check,
build or launch raises, and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOP_S = 989e12     # H100 SXM dense bf16 tensor cores
# f32-accurate work on the tensor cores takes three TF32 products for one
# f32 product: the dense TF32 rate (494.7 TFLOP/s) over three. FFMA (the
# CUDA cores, what the f32 kernels run) peaks at 67 TFLOP/s.
PEAK_F32_FLOP_S = 494.7e12 / 3
PEAK_FFMA_FLOP_S = 67e12
L2_BYTES = 50 * 2 ** 20
SEED = 0

# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "tt_linear": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                  "src/repro/kernels/tt_linear.py:291"),
    "tt_linear_batched_a": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                            "src/repro/kernels/tt_linear.py:156"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:112"),
    "decode_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                         "src/repro/kernels/flash_attention.py:393"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:149"),
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:295"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    "tt_linear_w8": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                     "src/repro/kernels/tt_linear.py:203"),
    "tt_linear_batched_a_w8": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                               "src/repro/kernels/tt_linear.py:250"),
    "paged_decode_attention_int8": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    # the f32 instances (RoBERTa's f32 training), in the same sources
    "tt_linear_f32": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                      "src/repro/kernels/tt_linear.py:291"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_fwd_f32": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:149"),
    "flash_attention_bwd_dq_f32": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:295"),
    "flash_attention_bwd_dkv_f32": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
    # the f32 instances of the serving kernels (RoBERTa's f32 serving)
    "tt_linear_batched_a_f32": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                                "src/repro/kernels/tt_linear.py:156"),
    "decode_attention_f32": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/flash_attention.py:393"),
    "paged_decode_attention_f32": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    "paged_decode_attention_int8_f32": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    # the f32 instances over int8 weights (RoBERTa's w8 serving)
    "tt_linear_w8_f32": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                         "src/repro/kernels/tt_linear.py:203"),
    "tt_linear_batched_a_w8_f32": (
        "src/repro_torch/kernels/csrc/tt_linear.cu",
        "src/repro/kernels/tt_linear.py:250"),
    # the head_dim 256 instances (gemma-7b's serving and training), in the
    # same sources
    "flash_attention_d256": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_fwd_d256": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:149"),
    "flash_attention_bwd_dq_d256": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:295"),
    "flash_attention_bwd_dkv_d256": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
    "decode_attention_d256": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/flash_attention.py:393"),
    "paged_decode_attention_d256": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    "paged_decode_attention_int8_d256": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    # the head_dim 112 instances (kimi-k2's serving), in the same sources
    "flash_attention_d112": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:112"),
    "flash_attention_fwd_d112": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:149"),
    "decode_attention_d112": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/flash_attention.py:393"),
    "paged_decode_attention_d112": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    "paged_decode_attention_int8_d112": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:161"),
    # and kimi-k2's training
    "flash_attention_bwd_dq_d112": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:295"),
    "flash_attention_bwd_dkv_d112": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
}
# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise. Linears: one
# bf16 ulp (2^-7 relative) from a different f32 summation order.
# Attention: the kernel rounds unnormalised p (relative to its running
# max) to bf16 while the plain version rounds the normalised softmax, so
# the P·V inputs differ by up to a bf16 ulp each (the JAX package's own
# bf16 flash tolerance is 2e-2, tests/test_kernels.py).
TOL = {"tt_linear": (1e-2, 1e-2), "tt_linear_batched_a": (1e-2, 1e-2),
       "flash_attention": (2e-2, 2e-2), "decode_attention": (2e-2, 2e-2),
       "flash_attention_fwd": (2e-2, 2e-2),
       "paged_decode_attention": (2e-2, 2e-2),
       "tt_linear_w8": (1e-2, 1e-2), "tt_linear_batched_a_w8": (1e-2, 1e-2),
       "paged_decode_attention_int8": (2e-2, 2e-2)}
TOL.update({k + sfx: (2e-2, 2e-2) for k in (
    "flash_attention", "flash_attention_fwd", "decode_attention",
    "paged_decode_attention", "paged_decode_attention_int8")
    for sfx in ("_d256", "_d112")})
# the paged engine's shape: 8 slots, a pool of 256 blocks of 16 cells,
# 34-page tables (512 / 16 pages + 2 sentinel columns), 32-token chunks
PAGED = dict(max_batch=8, cache_len=512, page_size=16, prefill_chunk=32,
             out_cap=32)


def kernel_name(mangled):
    """``paged_tc_kernel<64,1,0>`` from an Itanium-mangled kernel name in
    an anonymous namespace (template arguments: integers and bools)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:60]
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled[:60]
    n = int(m.group(1))
    name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"L[a-z](\d+)E", rest[:rest.find("EE") + 2])
    return f"{name}<{','.join(args)}>"


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_time_ms(fn, sets, iters=20):
    """Device ms per call: ``iters`` calls, cycling input sets so each
    call finds its operands cold in L2 (as a layer of the model does), are
    captured in one CUDA graph and the replay is timed with CUDA events —
    host launch overhead is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, peak=PEAK_BF16_FLOP_S):
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / peak), (
        "bytes" if nbytes / PEAK_BYTES_S >= flops / peak
        else "operations")


def copies(make, nbytes):
    """Enough independent input sets to exceed 2x the L2 cache."""
    n = max(2, int(np.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(min(n, 64))]


def compare(name, got, want):
    import torch
    torch.cuda.synchronize()
    atol, rtol = TOL[name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def same(fn, args, name):
    """Two calls of a kernel on the same inputs must agree bit for bit
    (no float atomics: split reductions sum in a fixed order)."""
    import torch
    if not torch.equal(fn(*args), fn(*args)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def k1_rows(dev, rn):
    """K1 at the prefill q/v projections (M = prompt bucket), A in the
    layout the model builds (K-contiguous, peft/api.py); both K1 kernels
    timed on the same inputs, the launcher's choice printed."""
    import torch
    from repro_torch.kernels import tt_linear as tl
    rows = []
    alpha = 4.0
    for m in (16, 64, 256):
        k = n = 2048
        r = 8

        def make():
            return (rn(m, k), rn(k, n, scale=k ** -0.5),
                    rn(r, k, scale=k ** -0.5).T, rn(r, n, scale=r ** -0.5))
        nbytes = 2 * (m * k + k * n + k * r + r * n + m * n)
        sets = copies(make, nbytes)
        x, w, a, b = sets[0]
        err = compare("tt_linear", tl.tt_linear(x, w, a, b, alpha),
                      tl.tt_linear_plain(x, w, a, b, alpha))
        flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
        bms, by = bound_ms(nbytes, flops)
        rows.append(dict(
            name="tt_linear", shape=f"M={m} K={k} N={n} r={r}",
            main=m == 64,
            max_abs_err=err,
            ms=cuda_time_ms(lambda *s: tl.tt_linear(*s, alpha), sets),
            plain_ms=cuda_time_ms(
                lambda *s: tl.tt_linear_plain(*s, alpha), sets),
            library_ms=cuda_time_ms(
                lambda x, w, a, b: torch.matmul(x, w)
                + alpha * torch.matmul(torch.matmul(x, a), b), sets),
            bound_ms=bms, bound_by=by, variant=tl.k1_variant(r),
            variants={v: cuda_time_ms(
                lambda *s: tl._launch_k1(*s, alpha, v), sets)
                for v in tl.K1_VARIANTS}))
    return rows


K1_RANKS = (256, 512, 1024, 2048)


def k1_rank_rows(dev, rn):
    """K1 above rank 64 (the pre-pass variant), at ranks 256, 512, 1024
    (VeRA's in the paper's Table 1) and 2048: at M = 64 and at the training
    shape M = 4096, K = N = 2048, as the forward (A K-contiguous, as the
    model folds MetaTT and LoTR) and as the backward's dx on the
    transposed views the backward passes. Each against its plain version
    at the linears' tolerance, with its bound and one library call
    (x·W + α·(x·A)·B in three ``torch.matmul``)."""
    import torch
    from repro_torch.kernels import tt_linear as tl
    rows = []
    alpha = 4.0
    k = n = 2048
    for r in K1_RANKS:
        for m, role in ((64, "forward"), (4096, "forward"), (4096, "dx")):
            def make():
                x = rn(m, k)
                w, a = rn(k, n, scale=k ** -0.5), rn(r, k, scale=k ** -0.5).T
                b = rn(r, n, scale=r ** -0.5)
                if role == "dx":   # g·Wᵀ + α·(g·Bᵀ)·Aᵀ, as _FusedTTLinear
                    return x, w.T, b.T, a.T
                return x, w, a, b
            nbytes = 2 * (m * k + k * n + k * r + r * n + m * n)
            sets = copies(make, nbytes) if m == 64 else [make()]
            ops_ = sets[0]
            err = compare("tt_linear", tl.tt_linear(*ops_, alpha),
                          tl.tt_linear_plain(*ops_, alpha))
            flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
            bms, by = bound_ms(nbytes, flops)
            ms = cuda_time_ms(lambda *t: tl.tt_linear(*t, alpha), sets)
            row = dict(
                name="tt_linear", rank_row=True, main=False,
                shape=f"{role} M={m} K={k} N={n} r={r}", max_abs_err=err,
                ms=ms, plain_ms=event_time_ms(
                    lambda: tl.tt_linear_plain(*ops_, alpha), (), iters=10),
                library_ms=cuda_time_ms(
                    lambda x_, w_, a_, b_: torch.matmul(x_, w_) + alpha
                    * torch.matmul(torch.matmul(x_, a_), b_), sets),
                bound_ms=bms, bound_by=by, variant=tl.k1_variant(r),
                variants={tl.k1_variant(r): ms})
            row["tflops"] = flops / row["ms"] / 1e9
            print(f"[kernel] K1 r={r} {role} M={m}: err {err:.3e}; "
                  f"{row['ms']:.4f} ms = {row['tflops']:.1f} TFLOP/s, "
                  f"{bms / row['ms']:.1%} of its bound ({by}); / "
                  f"torch.matmul {row['ms'] / row['library_ms']:.3f}x; "
                  f"plain {row['plain_ms']:.4f} ms", flush=True)
            rows.append(row)
            del sets, ops_
        torch.cuda.empty_cache()
    return rows


K3_CASES = ((16, 32), (64, 32), (256, 32), (256, 8))   # (T = S, KV)


def k3_rows(dev, rn, h=32, d=64, cases=K3_CASES, sfx="", tag=None, b=1):
    """K3 at prefill attention, causal, T == S (bucketed prompt), B = ``b``
    (default 1), ``h`` heads of ``d`` (``sfx``: the instance's name
    suffix, "_d256" for gemma-7b's heads of 256, "_d112" for kimi-k2's
    112; ``tag``: a model's rows, SDPA with ``enable_gqa`` as library);
    every variant of
    the forward kernel timed (one at d = 256), the launcher's choice
    printed; two calls bit-identical. The main row is T = 64, at H = KV
    (an instance of its own, ``sfx``: at its ``cases``' KV)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    name = "flash_attention" + sfx
    for t, kvh in cases:
        b_ = b

        def make3():
            return (rn(b_, t, h, d), rn(b_, t, kvh, d), rn(b_, t, kvh, d))
        nbytes = 2 * (2 * b_ * t * h * d + 2 * b_ * t * kvh * d)
        sets = copies(make3, nbytes)
        q, kk, vv = sets[0]
        err = compare(name, fa.flash_attention(q, kk, vv, True),
                      fa.flash_attention_plain(q, kk, vv, True))
        same(lambda *s: fa.flash_attention(*s, True), sets[0], name)
        pairs = t * (t + 1) // 2
        bms, by = bound_ms(nbytes, 4 * b_ * h * d * pairs)
        g = 1 if tag else h // kvh
        lib_sets = [(q.transpose(1, 2),
                     kk.repeat_interleave(g, 2).transpose(1, 2),
                     vv.repeat_interleave(g, 2).transpose(1, 2))
                    for q, kk, vv in sets]
        rows.append(dict(
            name=name,
            shape=f"B={b_} T=S={t} H={h} KV={kvh} d={d} causal",
            main=t == 64 and (kvh == h or bool(sfx)),
            max_abs_err=err,
            ms=cuda_time_ms(lambda *s: fa.flash_attention(*s, True), sets),
            plain_ms=cuda_time_ms(
                lambda *s: fa.flash_attention_plain(*s, True), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, **gqa_kw(tag)), lib_sets),
            bound_ms=bms, bound_by=by, variant=fa.fwd_variant(t, d),
            variants={v: cuda_time_ms(
                lambda *s: fa._launch_fwd(*s, True, None, v), sets)
                for v in fa.FWD_VARIANTS if d != 256 or v == "wg1"}))
        if tag:
            rows[-1].update(tag=tag, library="SDPA, enable_gqa, causal")
    return rows


def k2_rows(dev, rn):
    """K2 at the dense decode's q/v projections: M = 4 slots (the
    engine's, the main row), 8, 16 and 64 (a full launch of ``ops``'
    split), K = N = 2048, r = 8, task-routed A rows. Two calls must agree
    bit for bit; the launcher's path (the rank term's form and slices of
    K; the kernel includes the pre-pass that sums P[m] = x[m]·A[m]) is
    printed beside each slice count's time."""
    import torch
    from repro_torch.kernels import tt_linear as tl
    alpha, k, n, r = 4.0, 2048, 2048, 8
    rows = []
    for m in (4, 8, 16, 64):
        def make():
            return (rn(m, k), rn(k, n, scale=k ** -0.5),
                    rn(m, k, r, scale=k ** -0.5), rn(r, n, scale=r ** -0.5))
        nbytes = 2 * (m * k + k * n + m * k * r + r * n + m * n)
        sets = copies(make, nbytes)
        fn = tl.tt_linear_batched_a
        err = compare("tt_linear_batched_a", fn(*sets[0], alpha),
                      tl.tt_linear_batched_a_plain(*sets[0], alpha))
        same(lambda *t: fn(*t, alpha), sets[0], "tt_linear_batched_a")

        path, splits = tl.splitk_path(*sets[0][:2], r)
        variants = {f"s{sp}": cuda_time_ms(
            lambda *t: tl._launch_splitk("tt_linear_batched_a", t[0], t[1],
                                         None, t[2], t[3], alpha, sp), sets)
            for sp in (1, 2, 4, 8)}
        bms, by = bound_ms(nbytes, 2 * m * k * n + 2 * m * k * r
                           + 2 * m * r * n)
        rows.append(dict(
            name="tt_linear_batched_a", shape=f"M={m} K={k} N={n} r={r}",
            main=m == 4, max_abs_err=err,
            ms=cuda_time_ms(lambda *t: fn(*t, alpha), sets),
            plain_ms=cuda_time_ms(
                lambda *t: tl.tt_linear_batched_a_plain(*t, alpha), sets),
            library_ms=cuda_time_ms(
                lambda x, w, a, b: torch.matmul(x, w) + alpha * torch.matmul(
                    torch.bmm(x[:, None], a)[:, 0], b), sets),
            bound_ms=bms, bound_by=by, variant=f"{path} splits={splits}",
            variants=variants))
        del sets
    torch.cuda.empty_cache()
    return rows


K4_CASES = ((32, 256, (0, 37, 130, 255)), (8, 256, (0, 37, 130, 255)),
            (32, 4096, (511, 1500, 3000, 4095)))   # (KV, S, positions)


def k4_rows(dev, rn, h=32, d=64, cases=K4_CASES, sfx="", tag=None):
    """K4 over the dense decode cache: 4 slots at positions 0, 37, 130,
    255 of a 256-cell cache, H = 32, d = 64, with KV = 32 (the engine's,
    the main row) and KV = 8 (G = 4); and a long cache of 4096 cells at
    positions 511, 1500, 3000, 4095 (``h``, ``d``, ``cases``, ``sfx``:
    gemma-7b's 16 heads of 256, "_d256"; ``tag``: the rows of a model
    whose group lies outside {1, 2, 4, 8}, "granite" or "mistral", or
    kimi-k2's, "kimi", whose instance ``sfx`` "_d112" is its own). The
    bound counts q, o and the K/V cells inside each slot's window; the
    library yardstick is SDPA with the boolean position mask (on
    head-repeated K/V where G > 1; tagged rows: ``enable_gqa`` on the
    KV-head cache). Two calls must agree bit for bit; the chunk split the
    launcher takes (``decode_path``) is printed beside the times with and
    without it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    name = "decode_attention" + sfx
    for kvh, s_len, pos in cases:
        b_ = 4
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)

        def make():
            return (rn(b_, h, d), rn(b_, s_len, kvh, d),
                    rn(b_, s_len, kvh, d), pos_t)
        cells = sum(min(p, s_len - 1) + 1 for p in pos)
        nbytes = 2 * (2 * b_ * h * d + 2 * cells * kvh * d) + 4 * b_
        sets = copies(make, nbytes)
        err = compare(name, fa.decode_attention(*sets[0]),
                      fa.decode_attention_plain(*sets[0]))
        same(fa.decode_attention, sets[0], name)
        mode, split = pa.decode_path(b_, h, kvh, s_len, sms)

        def tc(q, k, v, pos, sp):
            o = torch.empty_like(q)
            _build.check(pa.launch_dense(q, k, v, pos, o, sp),
                         "decode_attention")
            return o
        variants = {f"split{sp}": cuda_time_ms(lambda *t: tc(*t, sp), sets)
                    for sp in sorted({0, 2, split})}
        bms, by = bound_ms(nbytes, 4 * h * d * cells)
        g = h // kvh
        mask = (torch.arange(s_len, device=dev)[None, :]
                <= pos_t[:, None])[:, None, None, :]
        if tag:
            lib_sets = [(q[:, :, None], kk.transpose(1, 2),
                         vv.transpose(1, 2)) for q, kk, vv, _ in sets]
        else:
            lib_sets = [(q[:, :, None],
                         kk.repeat_interleave(g, 2).transpose(1, 2),
                         vv.repeat_interleave(g, 2).transpose(1, 2))
                        for q, kk, vv, _ in sets]
        rows.append(dict(
            name=name,
            shape=(f"B={b_} S={s_len} H={h} KV={kvh} d={d} "
                   f"pos={','.join(map(str, pos))}"),
            main=s_len == 256 and (bool(sfx) or (kvh == h and not tag)),
            max_abs_err=err, ms=cuda_time_ms(fa.decode_attention, sets),
            plain_ms=cuda_time_ms(fa.decode_attention_plain, sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, **gqa_kw(tag)), lib_sets),
            bound_ms=bms, bound_by=by, variant=f"{mode} split={split}",
            variants=variants))
        if tag:
            rows[-1].update(tag=tag, library="SDPA, enable_gqa, position "
                                             "mask")
        del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


def phase_kernels(dev, only=None):
    """Every kernel vs its plain version at the serving shapes (bf16);
    ``only``: the names of the kernels whose rows run (default all)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(bf)

    groups = ((("tt_linear",), k1_rows), (("tt_linear",), k1_rank_rows),
              (("tt_linear_batched_a",), k2_rows),
              (("flash_attention",), k3_rows), (("decode_attention",), k4_rows),
              (("paged_decode_attention",), paged_kernel_rows),
              (("tt_linear_w8", "tt_linear_batched_a_w8"), w8_kernel_rows),
              (("tt_linear_w8", "tt_linear_batched_a",
                "tt_linear_batched_a_w8"), splitk_rank_rows),
              (("paged_decode_attention_int8",), paged_int8_kernel_rows),
              (("tt_linear_batched_a", "tt_linear_batched_a_w8"),
               batched_a_split_rows),
              (("flash_attention_d256",), d256_attention_rows),
              (("decode_attention_d256",), functools.partial(
                  k4_rows, h=16, d=256, cases=D256_K4_CASES, sfx="_d256")),
              (("paged_decode_attention_d256",), functools.partial(
                  paged_kernel_rows, h=16, d=256, sfx="_d256")),
              (("paged_decode_attention_int8_d256",), functools.partial(
                  paged_int8_kernel_rows, h=16, d=256, sfx="_d256")),
              (("tt_linear", "tt_linear_batched_a", "tt_linear_w8",
                "tt_linear_batched_a_w8"), gemma_linear_rows),
              (("decode_attention", "paged_decode_attention",
                "paged_decode_attention_int8"), gqa_attention_rows),
              (("tt_linear", "tt_linear_batched_a"), gqa_linear_rows),
              (("flash_attention_d112", "flash_attention_fwd_d112"),
               d112_attention_rows),
              (("decode_attention_d112",), functools.partial(
                  k4_rows, h=KIMI_H, d=112, cases=KIMI_K4_CASES,
                  sfx="_d112", tag="kimi")),
              (("paged_decode_attention_d112",), functools.partial(
                  paged_kernel_rows, h=KIMI_H, d=112, sfx="_d112",
                  kv=KIMI_KV, tag="kimi")),
              (("paged_decode_attention_int8_d112",), functools.partial(
                  paged_int8_kernel_rows, h=KIMI_H, d=112, sfx="_d112",
                  kv=KIMI_KV, tag="kimi")),
              (("tt_linear", "tt_linear_batched_a", "tt_linear_w8",
                "tt_linear_batched_a_w8"), kimi_linear_rows),
              (("tt_linear",), jamba_linear_rows),
              (("flash_attention", "decode_attention"),
               jamba_attention_rows),
              (("tt_linear", "tt_linear_batched_a"), xlstm_linear_rows),
              (("tt_linear",), whisper_linear_rows),
              (("flash_attention", "decode_attention"),
               whisper_attention_rows),
              (("flash_attention_d256", "decode_attention_d256",
                "paged_decode_attention_d256",
                "paged_decode_attention_int8_d256"),
               paligemma_attention_rows))
    rows = []
    for names, fn in groups:
        if only is None or set(names) & set(only):
            rows += fn(dev, rn)
    for r_ in rows:
        print_row(r_)
    return rows


def print_row(r_, width=44):
    """One [kernel] line; where a launcher chooses among kernels, which one
    ran and every variant's time on the same inputs."""
    line = (f"[kernel] {r_['name']:20s} {r_['shape']:{width}s} "
            f"err={r_['max_abs_err']:.3e} ms={r_['ms']:.4f} "
            f"plain_ms={r_['plain_ms']:.4f} "
            f"library_ms={r_['library_ms']:.4f} "
            f"bound_ms={r_['bound_ms']:.4f} ({r_['bound_by']})")
    if "variant" in r_:
        line += f" ran={r_['variant']} " + " ".join(
            f"{v}_ms={ms:.4f}" for v, ms in r_["variants"].items())
    print(line, flush=True)


def batched_a_split_rows(dev, rn):
    """K2 and #10 at M = 72 decode rows (a 4+1d engine with max_batch 72)
    through ``ops``, which splits M into launches of at most 64 rows: held
    against the plain versions, with ⌈72 / 64⌉ = 2 launches a call."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant
    from repro_torch.kernels import tt_linear as tl
    alpha, m, k, n, r = 4.0, 72, 2048, 2048, 8
    rows = []
    for name, w8 in (("tt_linear_batched_a", False),
                     ("tt_linear_batched_a_w8", True)):
        def make():
            w = rn(k, n, scale=k ** -0.5)
            wt = quant.quantize_int8(w, 0) if w8 else (w,)
            return (rn(m, k), *wt, rn(m, k, r, scale=k ** -0.5),
                    rn(r, n, scale=r ** -0.5))
        fn = ops.tt_linear_batched_a_q if w8 else ops.tt_linear_batched_a
        plain = getattr(tl, name + "_plain")
        nbytes = (2 * m * k + (k * n + 4 * n if w8 else 2 * k * n)
                  + 2 * m * k * r + 2 * r * n + 2 * m * n)
        sets = copies(make, nbytes)
        K.reset_launch_counts()
        got = fn(*sets[0], alpha=alpha)
        n_launch = K.launch_counts()[name]
        if n_launch != (m + 63) // 64:
            raise AssertionError(f"{name} at M={m}: {n_launch} launches, "
                                 f"want {(m + 63) // 64}")
        err = compare(name, got, plain(*sets[0], alpha))
        bms, by = bound_ms(nbytes, 2 * m * k * n + 4 * m * k * r)
        rows.append(dict(
            name=name, shape=f"M={m} K={k} N={n} r={r} (ops, {n_launch} "
            "launches)", main=False, max_abs_err=err,
            ms=cuda_time_ms(lambda *t: fn(*t, alpha=alpha), sets),
            plain_ms=cuda_time_ms(lambda *t: plain(*t, alpha), sets),
            library_ms=float("nan"), bound_ms=bms, bound_by=by))
        del sets
    torch.cuda.empty_cache()
    return rows


def paged_kernel_rows(dev, rn, h=32, d=64, sfx="", kv=None, tag=None):
    """#8 at the paged engine's shape, C = 1 (pure decode) and C = 32 (the
    engine's step): 8 slots at ragged positions, H = KV = 32, d = 64
    (``h``, ``d``, ``sfx``: gemma-7b's 16 heads of 256, "_d256"; ``kv``
    and ``tag``: KV heads below H, the rows of "granite" or "mistral",
    SDPA with ``enable_gqa`` as library), a pool of 256 blocks of 16
    cells, 34-page tables whose entries past each
    slot's window are sentinels. Its bound counts q, o and the K/V cells
    inside each slot's window; the library yardstick is SDPA on the
    PRE-GATHERED dense K/V with the boolean position mask (the gather is
    left out of its time; the port never calls SDPA). Two calls must agree
    bit for bit; the launcher's path (``mma`` or ``wgmma``, and the tiles
    a chunk of a split window) is printed beside each split's time."""
    import ctypes

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    b_ = PAGED["max_batch"]
    page, n_blk = PAGED["page_size"], 256
    p_tab = PAGED["cache_len"] // page + 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pos = torch.tensor([0, 37, 100, 161, 230, 299, 407, 479],
                       dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    name = "paged_decode_attention" + sfx
    kv = h if kv is None else kv
    for c in (1, 32):
        last = [min((int(p) + c - 1) // page, p_tab - 1) for p in pos]
        tables = torch.full((b_, p_tab), n_blk, dtype=torch.int32)
        perm = torch.randperm(n_blk, generator=gen)
        used = 0
        for row, j in enumerate(last):
            tables[row, :j + 1] = perm[used:used + j + 1].int()
            used += j + 1
        tables = tables.to(dev)
        cells = sum(min(int(p) + c, p_tab * page) for p in pos)
        nbytes = (2 * 2 * b_ * c * h * d + 2 * 2 * cells * kv * d
                  + 4 * b_ * (p_tab + 1))
        flops = sum(4 * d * h * (int(p) + cc + 1) for p in pos
                    for cc in range(c))

        def make():
            return (rn(b_, c, h, d), rn(n_blk, page, kv, d),
                    rn(n_blk, page, kv, d), tables, pos)
        sets = copies(make, nbytes)
        err = compare(name, pa.paged_decode_attention(*sets[0]),
                      pa.paged_decode_attention_plain(*sets[0]))
        same(pa.paged_decode_attention, sets[0], name)
        mode, split = pa.paged_path(b_, c, h, kv, p_tab, page, sms, d=d)

        def tc(q, k, v, tables, pos, sp):
            o = torch.empty_like(q)
            st = fa._strides(q, k, v, o)
            st = (ctypes.c_longlong * 13)(*st, tables.stride(0))
            _build.check(pa._launch_tc(q, k, v, tables, pos, o, n_blk, page,
                                       st, sp), name)
            return o
        variants = {f"split{sp}": cuda_time_ms(
            lambda *t: tc(*t, sp), sets) for sp in sorted({0, 2, 3, split})}
        s_len = p_tab * page
        mask = (torch.arange(s_len, device=dev)[None, None, :]
                <= (pos[:, None] + torch.arange(c, device=dev)[None])
                [:, :, None])[:, None]                   # (B, 1, C, S)
        tbl = tables.long().clamp(max=n_blk - 1)
        lib_sets = [(q.transpose(1, 2),
                     k[tbl].reshape(b_, s_len, kv, d).transpose(1, 2),
                     v[tbl].reshape(b_, s_len, kv, d).transpose(1, 2))
                    for q, k, v, _, _ in sets]
        bms, by = bound_ms(nbytes, flops)
        heads = f"H=KV={h}" if kv == h else f"H={h} KV={kv}"
        rows.append(dict(
            name=name,
            shape=(f"B={b_} C={c} {heads} d={d} page={page} "
                   f"P={p_tab} N={n_blk}"),
            main=c == PAGED["prefill_chunk"] and (bool(sfx) or not tag),
            max_abs_err=err,
            ms=cuda_time_ms(lambda *t: pa.paged_decode_attention(*t),
                            sets),
            plain_ms=cuda_time_ms(
                lambda *t: pa.paged_decode_attention_plain(*t), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, **gqa_kw(tag)), lib_sets),
            library="SDPA on pre-gathered K/V, boolean mask"
                    + (", enable_gqa" if tag else ""),
            bound_ms=bms, bound_by=by, variant=f"{mode} split={split}",
            variants=variants))
        if tag:
            rows[-1]["tag"] = tag
        del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


def w8_kernel_rows(dev, rn):
    """#9 at the w8 dense prefill's q/v shapes (M = 16, 64, 128, 256 prompt
    rows, K = N = 2048, r = 8, A in the model's K-contiguous layout) and
    #10 at decode shapes (M = 4 slots, the engine's, and 8, 16, 64), per
    output channel (the engine's QuantConfig; the main rows are #9 at M
    = 64 and #10 at M = 4) and with 128-row scale groups. Two calls must
    agree bit for bit; the launcher's path (kernel and slices of K;
    #10's includes the pre-pass that sums P[m] = x[m]·A[m]) is printed
    beside each slice count's time.
    The bound counts W as int8 plus its f32 scales; the library
    yardstick is torch.matmul on a PRE-DEQUANTIZED bf16 W plus the
    rank-r term (the dequantization is left out of its time; the port
    never calls it)."""
    import torch
    from repro_torch.kernels import quant
    from repro_torch.kernels import tt_linear as tl
    alpha, k, n, r = 4.0, 2048, 2048, 8
    rows = []
    for name, ms, batched in (("tt_linear_w8", (16, 64, 128, 256), False),
                              ("tt_linear_batched_a_w8", (4, 8, 16, 64),
                               True)):
        fn = getattr(tl, name)
        plain = getattr(tl, name + "_plain")
        for m, group in ((m, g) for m in ms for g in (0, 128)):
            g = k // group if group else 1

            def make():
                wq, sc = quant.quantize_int8(rn(k, n, scale=k ** -0.5), group)
                a = (rn(m, k, r, scale=k ** -0.5) if batched
                     else rn(r, k, scale=k ** -0.5).T)
                return rn(m, k), wq, sc, a, rn(r, n, scale=r ** -0.5)
            nbytes = (2 * m * k + k * n + 4 * g * n
                      + 2 * (m if batched else 1) * k * r + 2 * r * n
                      + 2 * m * n)
            sets = copies(make, nbytes)
            err = compare(name, fn(*sets[0], alpha), plain(*sets[0], alpha))
            same(lambda *t: fn(*t, alpha), sets[0], name)
            path, splits = tl.splitk_path(*sets[0][:2], r)
            variants = {f"s{sp}": cuda_time_ms(
                lambda *t: tl._launch_splitk(name, *t, alpha, sp), sets)
                for sp in (1, 2, 4, 8)}
            lib_sets = [(x, quant.dequantize(
                {"q8": wq, "scale": sc}, torch.bfloat16), a, b)
                for x, wq, sc, a, b in sets]
            if batched:
                def lib(x, w, a, b):
                    return torch.matmul(x, w) + alpha * torch.matmul(
                        torch.bmm(x[:, None], a)[:, 0], b)
            else:
                def lib(x, w, a, b):
                    return torch.matmul(x, w) + alpha * torch.matmul(
                        torch.matmul(x, a), b)
            bms, by = bound_ms(nbytes, 2 * m * k * n + 2 * m * k * r
                               + 2 * m * r * n)
            scales = f"group={group}" if group else "per-channel"
            rows.append(dict(
                name=name, shape=f"M={m} K={k} N={n} r={r} {scales}",
                main=group == 0 and m == (4 if batched else 64),
                max_abs_err=err,
                ms=cuda_time_ms(lambda *t: fn(*t, alpha), sets),
                plain_ms=cuda_time_ms(lambda *t: plain(*t, alpha), sets),
                library_ms=cuda_time_ms(lib, lib_sets),
                library="torch.matmul on a pre-dequantized bf16 W + rank-r",
                bound_ms=bms, bound_by=by, variant=f"{path} splits={splits}",
                variants=variants))
            del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


SPLITK_RANKS = (384, 1024)


def splitk_rank_rows(dev, rn):
    """#9, K2 and #10 above rank 64 (the hi + lo pre-pass, then the
    split-K kernel over K + 2·rp rows) at ranks 384 and 1024 (VeRA's),
    M = 4 and 64, K = N = 2048, per output channel: each against its plain
    version at the linears' tolerance, two calls bit-identical, with its
    bound and one library call (``torch.matmul`` on a pre-dequantized W
    plus the rank-r term; per-row A: a batched product)."""
    import torch
    from repro_torch.kernels import quant
    from repro_torch.kernels import tt_linear as tl
    alpha, k, n = 4.0, 2048, 2048
    rows = []
    for name in ("tt_linear_w8", "tt_linear_batched_a",
                 "tt_linear_batched_a_w8"):
        batched, w8 = name != "tt_linear_w8", name.endswith("w8")
        fn, plain = getattr(tl, name), getattr(tl, name + "_plain")
        for r in SPLITK_RANKS:
            for m in (4, 64):
                def make():
                    w = rn(k, n, scale=k ** -0.5)
                    wt = quant.quantize_int8(w, 0) if w8 else (w,)
                    a = (rn(m, k, r, scale=k ** -0.5) if batched
                         else rn(r, k, scale=k ** -0.5).T)
                    return (rn(m, k), *wt, a, rn(r, n, scale=r ** -0.5))
                nbytes = (2 * m * k + (k * n + 4 * n if w8 else 2 * k * n)
                          + 2 * (m if batched else 1) * k * r + 2 * r * n
                          + 2 * m * n)
                sets = copies(make, nbytes)
                err = compare(name, fn(*sets[0], alpha),
                              plain(*sets[0], alpha))
                same(lambda *t: fn(*t, alpha), sets[0], name)
                lib_sets = [(t[0], quant.dequantize(
                    {"q8": t[1], "scale": t[2]}, torch.bfloat16)
                    if w8 else t[1], t[-2], t[-1]) for t in sets]
                if batched:
                    def lib(x, w, a, b):
                        return torch.matmul(x, w) + alpha * torch.matmul(
                            torch.bmm(x[:, None], a)[:, 0], b)
                else:
                    def lib(x, w, a, b):
                        return torch.matmul(x, w) + alpha * torch.matmul(
                            torch.matmul(x, a), b)
                path = tl.splitk_path(*sets[0][:2], r)
                bms, by = bound_ms(nbytes, 2 * m * k * n + 2 * m * k * r
                                   + 2 * m * r * n)
                ms = cuda_time_ms(lambda *t: fn(*t, alpha), sets)
                rows.append(dict(
                    name=name, rank_row=True, main=False,
                    shape=f"M={m} K={k} N={n} r={r}", max_abs_err=err,
                    ms=ms, plain_ms=cuda_time_ms(
                        lambda *t: plain(*t, alpha), sets),
                    library_ms=cuda_time_ms(lib, lib_sets),
                    bound_ms=bms, bound_by=by,
                    variant=f"{path[0]} splits={path[1]}",
                    variants={path[0]: ms}))
                rows[-1]["tflops"] = (2 * m * k * n + 4 * m * k * r) / ms / 1e9
                print(f"[kernel] {name} r={r} M={m}: err {err:.3e}; "
                      f"{ms:.4f} ms, {bms / ms:.1%} of its bound ({by}); "
                      f"/ library {ms / rows[-1]['library_ms']:.3f}x; plain "
                      f"{rows[-1]['plain_ms']:.4f} ms", flush=True)
                del sets, lib_sets
            torch.cuda.empty_cache()
    return rows


def paged_int8_kernel_rows(dev, rn, h=32, d=64, sfx="", kv=None, tag=None):
    """#8q at the int8 paged engine's shape (as #8's rows, ``h``, ``d``,
    ``sfx``, ``kv`` and ``tag`` too): int8 pools of
    256 blocks of 16 cells with f32 per-cell scales. The bound counts q
    and o (bf16), and the int8 K/V cells plus their scales inside each
    slot's window; the library yardstick is SDPA on PRE-GATHERED,
    PRE-DEQUANTIZED bf16 K/V with the boolean position mask. Two calls
    must agree bit for bit; the chunk split the launcher takes
    (``paged_path``) is printed beside the times with and without it, and
    the kernel's error beside that of p cut to bf16
    (``int8_p_precision``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant
    b_ = PAGED["max_batch"]
    page, n_blk = PAGED["page_size"], 256
    p_tab = PAGED["cache_len"] // page + 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pos = torch.tensor([0, 37, 100, 161, 230, 299, 407, 479],
                       dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(SEED + 5)
    rows = []
    kv = h if kv is None else kv
    for c in (1, 32):
        last = [min((int(p) + c - 1) // page, p_tab - 1) for p in pos]
        tables = torch.full((b_, p_tab), n_blk, dtype=torch.int32)
        perm = torch.randperm(n_blk, generator=gen)
        used = 0
        for row, j in enumerate(last):
            tables[row, :j + 1] = perm[used:used + j + 1].int()
            used += j + 1
        tables = tables.to(dev)
        cells = sum(min(int(p) + c, p_tab * page) for p in pos)
        nbytes = (2 * 2 * b_ * c * h * d + 2 * cells * kv * (d + 4)
                  + 4 * b_ * (p_tab + 1))
        flops = sum(4 * d * h * (int(p) + cc + 1) for p in pos
                    for cc in range(c))

        def make():
            k8, ks = quant.quantize_kv(rn(n_blk, page, kv, d))
            v8, vs = quant.quantize_kv(rn(n_blk, page, kv, d))
            return rn(b_, c, h, d), k8, v8, ks, vs, tables, pos
        sets = copies(make, nbytes)
        name = "paged_decode_attention_int8" + sfx
        err = compare(name, pa.paged_decode_attention_int8(*sets[0]),
                      pa.paged_decode_attention_int8_plain(*sets[0]))
        same(pa.paged_decode_attention_int8, sets[0], name)
        mode, split = pa.paged_path(b_, c, h, kv, p_tab, page, sms,
                                    quantized=True, d=d)

        def tc(q, k8, v8, ks, vs, tables, pos, sp):
            o = torch.empty_like(q)
            st = pa.int8_strides(q, k8, v8, ks, vs, tables, o)
            _build.check(pa._launch_tc(q, k8, v8, tables, pos, o, n_blk,
                                       page, st, sp, (ks, vs)), name)
            return o
        variants = {f"split{sp}": cuda_time_ms(
            lambda *t: tc(*t, sp), sets) for sp in sorted({0, split})}
        prec = int8_p_precision(sets[0])
        s_len = p_tab * page
        mask = (torch.arange(s_len, device=dev)[None, None, :]
                <= (pos[:, None] + torch.arange(c, device=dev)[None])
                [:, :, None])[:, None]                   # (B, 1, C, S)
        tbl = tables.long().clamp(max=n_blk - 1)

        def deq(x8, xs):
            return (x8[tbl].float() * xs[tbl][..., None]).to(
                torch.bfloat16).reshape(b_, s_len, kv, d).transpose(1, 2)
        lib_sets = [(q.transpose(1, 2), deq(k8, ks), deq(v8, vs))
                    for q, k8, v8, ks, vs, _, _ in sets]
        bms, by = bound_ms(nbytes, flops)
        heads = f"H=KV={h}" if kv == h else f"H={h} KV={kv}"
        rows.append(dict(
            name=name,
            shape=(f"B={b_} C={c} {heads} d={d} page={page} "
                   f"P={p_tab} N={n_blk} int8"),
            main=c == PAGED["prefill_chunk"] and (bool(sfx) or not tag),
            max_abs_err=err,
            ms=cuda_time_ms(lambda *t: pa.paged_decode_attention_int8(*t),
                            sets),
            plain_ms=cuda_time_ms(
                lambda *t: pa.paged_decode_attention_int8_plain(*t), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, **gqa_kw(tag)), lib_sets),
            library="SDPA on pre-gathered, pre-dequantized K/V, boolean mask"
                    + (", enable_gqa" if tag else ""),
            bound_ms=bms, bound_by=by, variant=f"{mode} split={split}",
            variants=variants))
        if tag:
            rows[-1]["tag"] = tag
        print(f"[kernel] {name} C={c} vs the plain "
              f"version in f32: {prec}", flush=True)
        del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


def gqa_kw(tag):
    """SDPA's keyword for a KV-head cache under a GQA group (tagged rows:
    the library reads K / V at their own head count, as the kernel
    does)."""
    return {"enable_gqa": True} if tag else {}


def int8_p_precision(args):
    """Max and mean |error| of #8q's kernel against the plain version with
    an f32 output, beside those of the plain version with p cut to bf16
    before P·V (which the kernel must not do), on the same inputs."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    q, k8, v8, ks, vs, tables, pos = args
    b, c, h, d = q.shape
    n, _, kv = k8.shape[:3]
    want = pa.paged_decode_attention_int8_plain(q.float(), *args[1:])
    tbl = tables.long().clamp(0, n - 1)
    kf = (k8.float() * ks[..., None])[tbl].reshape(b, -1, kv, d)
    vf = (v8.float() * vs[..., None])[tbl].reshape(b, -1, kv, d)
    g = h // kv
    sc = torch.einsum("bchd,bshd->bhcs", q.float(),
                      kf.repeat_interleave(g, 2)) * d ** -0.5
    cell = torch.arange(kf.shape[1], device=q.device)
    lim = pos.long()[:, None] + torch.arange(c, device=q.device)[None]
    sc = sc.masked_fill(cell[None, None, None] > lim[:, None, :, None],
                        -1e30)
    pb = torch.softmax(sc, -1).bfloat16().float()
    got = {"kernel": pa.paged_decode_attention_int8(*args),
           "plain with p in bf16": torch.einsum(
               "bhcs,bshd->bchd", pb, vf.repeat_interleave(g, 2)
           ).bfloat16()}
    torch.cuda.synchronize()
    return " ".join(
        f"{k}: max {float((o.float() - want).abs().max()):.3e} mean "
        f"{float((o.float() - want).abs().mean()):.3e};"
        for k, o in got.items())


def event_time_ms(fn, args, iters=5):
    """Device ms per call for ms-scale work: ``iters`` eager calls between
    two CUDA events after two warm-up calls (the launch overhead is small
    beside the kernels at these shapes; autograd calls do not capture in
    a CUDA graph)."""
    import torch
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, args, iters=10, names=None):
    """Device ms per call from torch.profiler: the kernel time on the card
    of ``iters`` calls (after two warm-up calls) over ``iters``. For a call
    whose host work may outlast its kernels (an eager autograd backward),
    where CUDA events around the calls would time the host too. ``names``
    (a set) collects the names of the kernels that ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in dev_events)
    if names is not None:
        names.update(e.name for e in dev_events)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / iters


def rel_max(got, want):
    """max |got - want| / max |want|, after a finiteness check."""
    import torch
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("non-finite kernel output")
    return float((g - w).abs().max() / w.abs().max())


# the first row of each head dim is its main path's: stablelm-1.6b's 32
# heads of 64, gemma-7b's 16 heads of 256 (phase 13), kimi-k2's 64 heads
# of 112 over 8 (phase 18); T = 1000 tile edges and GQA groups 4 (d = 64)
# and 2 (d = 256); then granite-34b's and mistral-large's training shapes
# (phase 15, ``GQA_TRAIN_TAGS``), kimi-k2's (``KIMI_TRAIN_TAGS``), jamba's
# and paligemma-3b's (``PALIGEMMA_TRAIN_TAGS``: 8 heads of 256 over 1)
TRAIN_ATTN_SHAPES = ((4, 1024, 32, 32, 64), (4, 1000, 32, 32, 64),
                     (4, 1024, 32, 8, 64), (2, 1024, 16, 16, 128),
                     (4, 1024, 16, 16, 256), (4, 1000, 16, 16, 256),
                     (4, 1024, 16, 8, 256), (4, 1024, 48, 1, 128),
                     (4, 1024, 96, 8, 128), (4, 1000, 48, 1, 128),
                     (4, 1024, 64, 8, 112), (4, 1000, 64, 8, 112),
                     (1, 1024, 64, 8, 112), (4, 1024, 32, 8, 128),
                     (4, 1024, 8, 1, 256))
#: the any-group training rows of #5, #6 and #7 (``gqa_rows`` of their
#: records): granite-34b's 48 heads over one KV head (G = 48, and a
#: ragged T = 1000) and mistral-large's 96 over 8 (G = 12); the T = 1024
#: rows are phase 15's shapes and are timed
GQA_TRAIN_TAGS = {(4, 1024, 48, 1, 128): "granite",
                  (4, 1024, 96, 8, 128): "mistral",
                  (4, 1000, 48, 1, 128): "granite"}
GQA_TRAIN = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
#: kimi-k2's training rows of #5, #6 and #7 at d = 112 (phase 18's
#: 4 x 1024, a ragged T = 1000, and B = 1, the gradient check's, where
#: #7's 128 blocks run in slabs of heads), every one timed, SDPA with
#: ``enable_gqa`` as library
KIMI_TRAIN_TAGS = {(4, 1024, 64, 8, 112): "kimi",
                   (4, 1000, 64, 8, 112): "kimi",
                   (1, 1024, 64, 8, 112): "kimi"}
D112_TRAIN = ("flash_attention_bwd_dq_d112", "flash_attention_bwd_dkv_d112")
#: jamba-v0.1-52b's training rows of #5, #6 and #7 (phase 19 (b)'s
#: shape: 32 heads of 128 over 8), timed, SDPA with ``enable_gqa`` as
#: library
JAMBA_TRAIN_TAGS = {(4, 1024, 32, 8, 128): "jamba"}
TRAIN_LINEAR_SHAPE = (4096, 2048, 2048, 8)   # M = B x T, K, N, r


def sdpa_backend(names):
    """Which SDPA backend ran, from the names of its kernels."""
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cuDNN"), ("flash", "flash"),
                         ("fmha", "memory-efficient"),
                         ("cutlass", "memory-efficient")):
        if key in text:
            return backend
    return "math"


def phase_train_kernels(dev, attn_shapes=TRAIN_ATTN_SHAPES,
                        linear_shape=TRAIN_LINEAR_SHAPE):
    """#5, #6, #7 and K1-as-dx against their plain versions at the
    training shapes (bf16; the first attention shape of each head dim is
    its main path's, d = 256 rows under the ``_d256`` names): out within
    2e-2 abs+rel, lse within 1e-3 abs, each of dq, dk, dv within 2e-2 of
    the largest plain gradient (the JAX package's bf16 gradient limit,
    tests/test_grads.py); at each main shape and each any-group shape
    (``GQA_TRAIN_TAGS``) two backward calls give the same dq, dk and dv
    bit for bit (no float atomics; #7's slabs merge in a fixed order).
    Timed shapes print each attention kernel's TFLOP/s and share of its
    bound, and (#6 + #7) over SDPA's autograd backward (the backend it
    picked named from its kernels); the any-group ones also #7 at several
    slab sizes (``dkv_slab_heads`` picks one)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tt_linear as tl

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(bf)

    rows = []
    firsts = {}
    for sh_ in attn_shapes:
        firsts.setdefault(sh_[4], sh_)
    for b_, t, h, kvh, d in attn_shapes:
        main = (b_, t, h, kvh, d) == firsts[d] and d != 128
        tag = next((tags[(b_, t, h, kvh, d)] for tags in (
            GQA_TRAIN_TAGS, KIMI_TRAIN_TAGS, JAMBA_TRAIN_TAGS,
            PALIGEMMA_TRAIN_TAGS)
            if (b_, t, h, kvh, d) in tags), None)
        sfx = {256: "_d256", 112: "_d112"}.get(d, "")
        shape = f"B={b_} T=S={t} H={h} KV={kvh} d={d} causal"
        q, k, v = rn(b_, t, h, d), rn(b_, t, kvh, d), rn(b_, t, kvh, d)
        g = rn(b_, t, h, d)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, True)
        err = compare("flash_attention_fwd" + sfx, o, po)
        lse_err = float((lse - plse).abs().max())
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_attention_fwd lse: max abs err "
                                 f"{lse_err:.3e} > 1e-3 at {shape}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, True)
        errs = {}
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            errs[name] = rel_max(x, y)
            if not errs[name] <= 2e-2:
                raise AssertionError(f"flash_attention_bwd {name}: "
                                     f"{errs[name]:.3e} of max |plain| > "
                                     f"2e-2 at {shape}")
        abs_err = {n: float((x.float() - y.float()).abs().max())
                   for n, x, y in zip(("dq", "dk", "dv"), got, want)}
        if main or tag:
            again = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
            torch.cuda.synchronize()
            for name, x, y in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(x, y):
                    raise AssertionError(f"flash_attention_bwd {name}: two "
                                         f"calls differ at {shape}")
            del again
        pairs = b_ * h * t * (t + 1) // 2
        bq, bkv = b_ * t * h * d * 2, b_ * t * kvh * d * 2   # bytes
        lse_b = b_ * h * t * 4
        g_ = h // kvh
        gqa_lib = tag in ("kimi", "jamba", "paligemma")   # SDPA's own
        # GQA, k / v not
        # repeated
        lib = [x.detach().transpose(1, 2) for x in
               ((q, k, v) if gqa_lib else
                (q, k.repeat_interleave(g_, 2), v.repeat_interleave(g_, 2)))]
        sdpa_kw = dict(is_causal=True, enable_gqa=gqa_lib)
        timed = {}
        if main or (t != attn_shapes[0][1] and d == 64) or (
                tag and t == 1024) or gqa_lib:
            # the forward's device time in a CUDA-graph replay (its eager
            # launches would time the host at this speed)
            timed["fwd_ms"] = cuda_time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, True), [()])
            timed["fwd_variants"] = {   # two warpgroups do not fit at 256
                var: cuda_time_ms(lambda: fa._launch_fwd(
                    q, k, v, True, torch.empty_like(lse), var), [()])
                for var in fa.FWD_VARIANTS if d != 256 or var == "wg1"}
            timed["fwd_plain_ms"] = event_time_ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, True), ())
            timed["fwd_lib_ms"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(*lib, **sdpa_kw),
                [()])
            # the two passes apart, through the launchers the wrapper runs
            timed["dq_ms"] = event_time_ms(
                lambda: fa._launch_bwd_dq(q, k, v, o, lse, g, True), ())
            _, delta = fa._launch_bwd_dq(q, k, v, o, lse, g, True)
            timed["dkv_ms"] = event_time_ms(
                lambda: fa._launch_bwd_dkv(q, k, v, g, lse, delta, True), ())
            if tag:   # #7 at several slab sizes, the unsplit pass first
                g_ = h // kvh
                timed["slab_heads"] = fa.dkv_slab_heads(
                    b_, t, kvh, g_, d, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                timed["dkv_variants"] = {
                    f"heads={x}": event_time_ms(
                        lambda x=x: fa._launch_bwd_dkv(
                            q, k, v, g, lse, delta, True, x), ())
                    for x in sorted({g_, timed["slab_heads"]} | {
                        g_ // n for n in (2, 4, 6, 8, 12)
                        if g_ % n == 0}, reverse=True)}
            timed["bwd_plain_ms"] = event_time_ms(
                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g,
                                                     True), ())
            leaves = [x.clone().requires_grad_(True) for x in lib]
            out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
            gl = g.transpose(1, 2)
            lib_names = set()
            timed["bwd_lib_ms"] = profiled_device_ms(
                lambda: torch.autograd.grad(out, leaves, gl,
                                            retain_graph=True), (),
                names=lib_names)
            timed["bwd_lib"] = (f"SDPA bf16 backward ({sdpa_backend(lib_names)}"
                                " backend"
                                + (", enable_gqa" if gqa_lib else "")
                                + "), profiled")
            timed["bwd_lib_event_ms"] = event_time_ms(
                lambda: torch.autograd.grad(out, leaves, gl,
                                            retain_graph=True), ())
            del out, leaves
        flops = {"fwd": 2 * 2 * d * pairs, "dq": 3 * 2 * d * pairs,
                 "dkv": 4 * 2 * d * pairs}
        fwd_bound = bound_ms(2 * bq + 2 * bkv + lse_b, flops["fwd"])
        dq_bound = bound_ms(4 * bq + 2 * bkv + 2 * lse_b, flops["dq"])
        dkv_bound = bound_ms(2 * bq + 4 * bkv + 2 * lse_b, flops["dkv"])
        for name, err_, bnd, ms, plain, lib_ms in (
                ("flash_attention_fwd", err, fwd_bound, "fwd_ms",
                 "fwd_plain_ms", "fwd_lib_ms"),
                ("flash_attention_bwd_dq", abs_err["dq"], dq_bound, "dq_ms",
                 "bwd_plain_ms", "bwd_lib_ms"),
                ("flash_attention_bwd_dkv", max(abs_err["dk"], abs_err["dv"]),
                 dkv_bound, "dkv_ms", "bwd_plain_ms", "bwd_lib_ms")):
            rows.append(dict(
                name=name + sfx, shape=shape, main=main, max_abs_err=err_,
                ms=timed.get(ms), plain_ms=timed.get(plain),
                library_ms=timed.get(lib_ms), bound_ms=bnd[0],
                bound_by=bnd[1]))
            if timed:   # of the real (d-wide) work
                rows[-1]["tflops"] = flops[ms.removesuffix("_ms")] / \
                    timed[ms] / 1e9
            if "bwd" in name and timed:
                rows[-1]["library"] = timed["bwd_lib"]
            if tag:
                rows[-1]["tag"] = tag
            if name.endswith("dkv") and "dkv_variants" in timed:
                rows[-1].update(slab_heads=timed["slab_heads"],
                                variants=timed["dkv_variants"])
            if name == "flash_attention_fwd" and timed:
                rows[-1].update(variant=fa.fwd_variant(t, d),
                                variants=timed["fwd_variants"])
        print(f"[train-kernel] {shape}: out err {err:.3e}, lse err "
              f"{lse_err:.3e}, dq/dk/dv rel err {errs['dq']:.3e} / "
              f"{errs['dk']:.3e} / {errs['dv']:.3e} of max |plain|"
              + ("; two backward calls bit-identical" if main or tag
                 else ""), flush=True)
        if timed:
            rate = ", ".join(
                f"{label} {ms_:.4f} ms = {flops[key] / ms_ / 1e9:.1f} "
                f"TFLOP/s, {bnd[0] / ms_:.1%} of its bound"
                for label, key, ms_, bnd in (
                    ("#5", "fwd", timed["fwd_ms"], fwd_bound),
                    ("#6", "dq", timed["dq_ms"], dq_bound),
                    ("#7", "dkv", timed["dkv_ms"], dkv_bound)))
            pair = timed["dq_ms"] + timed["dkv_ms"]
            print(f"[train-kernel] {shape}: {rate}; (#6 + #7) / SDPA "
                  f"backward = {pair:.4f} / {timed['bwd_lib_ms']:.4f} ms = "
                  f"{pair / timed['bwd_lib_ms']:.3f}x ({timed['bwd_lib']}; "
                  f"CUDA events around its eager calls: "
                  f"{timed['bwd_lib_event_ms']:.4f} ms); #5 / SDPA forward "
                  f"= {timed['fwd_ms'] / timed['fwd_lib_ms']:.3f}x; #5 ran "
                  f"{fa.fwd_variant(t, d)}: " + ", ".join(
                      f"{v_} {ms_:.4f} ms" for v_, ms_ in
                      timed["fwd_variants"].items()), flush=True)
        if "dkv_variants" in timed:
            print(f"[train-kernel] {shape}: #7 ran "
                  f"{-(-(h // kvh) // timed['slab_heads'])} slabs of "
                  f"{timed['slab_heads']} heads: " + ", ".join(
                      f"{v_} {ms_:.4f} ms" for v_, ms_ in
                      timed["dkv_variants"].items()), flush=True)
        del q, k, v, g, o, lse, po, plse, got, want, lib
        torch.cuda.empty_cache()
    if linear_shape is None:   # the attention rows alone
        for r_ in rows:
            if r_["ms"] is not None:
                print_row(r_, width=40)
        return rows

    # K1 at the q/v projection of a B=4 x T=1024 step: the forward (and
    # remat recompute) y = x·W + α·(x·A)·B with A in the layout the model
    # builds (K-contiguous), and the backward's dx = g·Wᵀ + α·(g·Bᵀ)·Aᵀ on
    # the transposed views the backward passes (no copy); then the whole
    # Function's backward (dx, dA, dB) against plain autograd
    from repro_torch.kernels import dispatch
    m, kd, n, r = linear_shape
    alpha = 4.0
    x, w = rn(m, kd), rn(kd, n, scale=kd ** -0.5)
    a, b = rn(r, kd, scale=kd ** -0.5).T, rn(r, n, scale=r ** -0.5)
    g = rn(m, n)
    for role, ops_ in (("forward", (x, w, a, b)),
                       ("dx", (g, w.T, b.T, a.T))):
        mm, kk = ops_[0].shape
        nn = ops_[1].shape[1]
        err = compare("tt_linear", tl.tt_linear(*ops_, alpha),
                      tl.tt_linear_plain(*ops_, alpha))
        flops = 2 * mm * kk * nn + 2 * mm * kk * r + 2 * mm * r * nn
        row = dict(
            name="tt_linear", shape=f"{role} M={mm} K={kk} N={nn} r={r}",
            main=False, role=role, max_abs_err=err,
            ms=cuda_time_ms(lambda *t: tl.tt_linear(*t, alpha), [ops_]),
            plain_ms=event_time_ms(
                lambda: tl.tt_linear_plain(*ops_, alpha), (), iters=20),
            library_ms=cuda_time_ms(
                lambda x_, w_, a_, b_: torch.matmul(x_, w_) + alpha
                * torch.matmul(torch.matmul(x_, a_), b_), [ops_]),
            variant=tl.k1_variant(r),
            variants={v: cuda_time_ms(
                lambda *t: tl._launch_k1(*t, alpha, v), [ops_])
                for v in tl.K1_VARIANTS})
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * (mm * kk + kk * nn + kk * r + r * nn + mm * nn), flops)
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
        print(f"[train-kernel] K1 {row['shape']}: err {err:.3e}; "
              f"{row['ms']:.4f} ms = {row['tflops']:.1f} TFLOP/s, "
              f"{row['bound_ms'] / row['ms']:.1%} of its bound; "
              f"/ torch.matmul {row['ms'] / row['library_ms']:.3f}x; ran "
              f"{row['variant']}: " + ", ".join(
                  f"{v_} {ms_:.4f} ms" for v_, ms_ in
                  row["variants"].items()), flush=True)
    dx = rows[-1]

    def fn_backward(fn):
        leaves = [x.clone().requires_grad_(True), w,
                  a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        y = fn(*leaves)
        return y, [leaves[i] for i in (0, 2, 3)]
    yk, lk = fn_backward(lambda *t: dispatch.tt_linear(*t, alpha=alpha))
    yp, lp = fn_backward(lambda *t: tl.tt_linear_plain(*t, alpha))
    gk = torch.autograd.grad(yk, lk, g, retain_graph=True)
    gp = torch.autograd.grad(yp, lp, g, retain_graph=True)
    grad_err = {nm: rel_max(u, v_) for nm, u, v_ in zip(("dx", "da", "db"),
                                                        gk, gp)}
    if max(grad_err.values()) > 2e-2:
        raise AssertionError(f"_FusedTTLinear backward vs plain autograd: "
                             f"{grad_err}")
    dx["function_bwd_ms"] = event_time_ms(
        lambda: torch.autograd.grad(yk, lk, g, retain_graph=True), ())
    dx["plain_autograd_bwd_ms"] = event_time_ms(
        lambda: torch.autograd.grad(yp, lp, g, retain_graph=True), ())
    print(f"[train-kernel] K1 {dx['shape']}: "
          f"_FusedTTLinear backward vs plain autograd rel err "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in grad_err.items())
          + f"; Function backward {dx['function_bwd_ms']:.4f} ms, plain "
          f"autograd {dx['plain_autograd_bwd_ms']:.4f} ms", flush=True)
    for r_ in rows:
        if r_["ms"] is not None:
            print_row(r_, width=40)
    return rows


F32_KERNELS = ("tt_linear_f32", "flash_attention_f32",
               "flash_attention_fwd_f32", "flash_attention_bwd_dq_f32",
               "flash_attention_bwd_dkv_f32", "tt_linear_batched_a_f32",
               "decode_attention_f32", "paged_decode_attention_f32",
               "paged_decode_attention_int8_f32", "tt_linear_w8_f32",
               "tt_linear_batched_a_w8_f32")
# RoBERTa-large's attention at 4 x 1024 tokens (16 heads of 64), ragged T
F32_ATTN_SHAPES = ((4, 1024, 16, 16, 64), (4, 1000, 16, 16, 64))
# K1's f32 rows: (M, K = N, r, role); the first is the main path's
F32_LINEAR_ROWS = ((4096, 1024, 8, "forward"), (4096, 1024, 8, "dx"),
                   (4096, 1024, 64, "forward"), (64, 768, 1024, "forward"),
                   (4096, 768, 1024, "forward"))


def f32_precision_checked():
    """f32 matmuls (the unadapted projections, the readout, dA / dB and
    the plain legs) must stay f32: no TF32 anywhere on this path."""
    import torch
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(
            "f32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}, allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}: TF32 would round "
            "the f32 path")


def f32_err(name, got, want, limit=1e-4):
    """max |kernel - plain| / max |plain| of an f32 kernel, held to
    ``limit`` (1e-4: f32 sums in another order; one TF32 pass, ~4.9e-4
    relative an operand, fails it)."""
    rel = rel_max(got, want)
    if not rel <= limit:
        raise AssertionError(f"{name}: {rel:.3e} of max |plain| > {limit}")
    return float((got.float() - want.float()).abs().max()), rel


def f32_row(name, shape, main, err, rel, flops, nbytes, ms, plain_ms,
            library_ms, **extra):
    bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOP_S)
    row = dict(name=name, shape=shape, main=main, max_abs_err=err,
               rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9, **extra)
    print(f"[kernel-f32] {name:27s} {shape:38s} err={err:.3e} "
          f"({rel:.3e} of max |plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"share of bound {bms / ms:.1%}; {row['tflops']:.1f} TFLOP/s = "
          f"{1e12 * row['tflops'] / PEAK_FFMA_FLOP_S:.1%} of FFMA's 67",
          flush=True)
    return row


def phase_f32_kernels(dev):
    """The f32 instances (RoBERTa trains in f32) against their plain f32
    versions on the card: K1 at roberta-large's q/v projection (M = 4096,
    K = N = 1024, r = 8 as forward and dx, r = 64) and roberta-base's
    VeRA (K = N = 768, r = 1024, M = 64 and 4096); K3, #5, #6 and #7 at
    (B, T, H, KV, d) = (4, 1024, 16, 16, 64) and T = 1000. Outputs within
    1e-4 of max |plain| elementwise, lse within 1e-5 absolute, two #6 / #7
    calls bit-identical. Bound = max(bytes / 3.35 TB/s, flops / 164.9
    TFLOP/s); library = torch.matmul in f32 (TF32 off) and SDPA in f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tt_linear as tl

    f32_precision_checked()
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    rows = []
    alpha = 4.0
    for i, (m, kd, r, role) in enumerate(F32_LINEAR_ROWS):
        n = kd
        x, w = rn(m, kd), rn(kd, n, scale=kd ** -0.5)
        a, b = rn(r, kd, scale=kd ** -0.5).T, rn(r, n, scale=r ** -0.5)
        ops_ = (x, w, a, b) if role == "forward" else (x, w.T, b.T, a.T)
        err, rel = f32_err("tt_linear_f32", tl.tt_linear(*ops_, alpha),
                           tl.tt_linear_plain(*ops_, alpha))
        nbytes = 4 * (m * kd + kd * n + kd * r + r * n + m * n)
        flops = 2 * m * kd * n + 2 * m * kd * r + 2 * m * r * n
        rows.append(f32_row(
            "tt_linear_f32", f"{role} M={m} K={kd} N={n} r={r}", i == 0,
            err, rel, flops, nbytes,
            cuda_time_ms(lambda *t: tl.tt_linear(*t, alpha), [ops_]),
            event_time_ms(lambda: tl.tt_linear_plain(*ops_, alpha), (),
                          iters=10),
            cuda_time_ms(lambda x_, w_, a_, b_: torch.matmul(x_, w_) + alpha
                         * torch.matmul(torch.matmul(x_, a_), b_), [ops_]),
            role=role))
        del x, w, a, b, ops_
    for b_, t, h, kvh, d in F32_ATTN_SHAPES:
        main = (b_, t, h, kvh, d) == F32_ATTN_SHAPES[0]
        shape = f"B={b_} T=S={t} H={h} KV={kvh} d={d} causal"
        q, k, v, g = (rn(b_, t, n_, d) for n_ in (h, kvh, kvh, h))
        o3 = fa.flash_attention(q, k, v, True)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, True)
        e3 = f32_err("flash_attention_f32", o3, po)
        e5 = f32_err("flash_attention_fwd_f32", o, po)
        lse_err = float((lse - plse).abs().max())
        if not lse_err <= 1e-5:
            raise AssertionError(f"flash_attention_fwd_f32 lse: {lse_err:.3e}"
                                 f" > 1e-5 at {shape}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, True)
        eb = {nm: f32_err(f"flash_attention_bwd {nm} (f32)", x_, y_)
              for nm, x_, y_ in zip(("dq", "dk", "dv"), got, want)}
        again = fa.flash_attention_bwd(q, k, v, o, lse, g, True)
        torch.cuda.synchronize()
        for nm, x_, y_ in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(x_, y_):
                raise AssertionError(f"flash_attention_bwd {nm} (f32): two "
                                     f"calls differ at {shape}")
        del again
        pairs = b_ * h * t * (t + 1) // 2
        bq, bkv, lse_b = 4 * b_ * t * h * d, 4 * b_ * t * kvh * d, \
            4 * b_ * h * t
        gg = h // kvh
        lib = [x_.transpose(1, 2) for x_ in
               (q, k.repeat_interleave(gg, 2), v.repeat_interleave(gg, 2))]
        fwd_lib = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(*lib, is_causal=True),
            [()])
        fwd_plain = event_time_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, True), ())
        rows.append(f32_row(
            "flash_attention_f32", shape, main, *e3, 4 * d * pairs,
            2 * bq + 2 * bkv,
            cuda_time_ms(lambda: fa.flash_attention(q, k, v, True), [()]),
            event_time_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                          ()), fwd_lib))
        rows.append(f32_row(
            "flash_attention_fwd_f32", shape, main, *e5, 4 * d * pairs,
            2 * bq + 2 * bkv + lse_b,
            cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                         [()]), fwd_plain, fwd_lib, lse_err=lse_err))
        leaves = [x_.clone().requires_grad_(True) for x_ in lib]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        bwd_lib = profiled_device_ms(
            lambda: torch.autograd.grad(out, leaves, g.transpose(1, 2),
                                        retain_graph=True), ())
        del out, leaves
        bwd_plain = event_time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g, True),
            ())
        dq_ms = event_time_ms(
            lambda: fa._launch_bwd_dq(q, k, v, o, lse, g, True), ())
        _, delta = fa._launch_bwd_dq(q, k, v, o, lse, g, True)
        dkv_ms = event_time_ms(
            lambda: fa._launch_bwd_dkv(q, k, v, g, lse, delta, True), ())
        rows.append(f32_row(
            "flash_attention_bwd_dq_f32", shape, main, *eb["dq"],
            6 * d * pairs, 4 * bq + 2 * bkv + 2 * lse_b, dq_ms, bwd_plain,
            bwd_lib, library="SDPA backward (dq, dk, dv), profiled"))
        rows.append(f32_row(
            "flash_attention_bwd_dkv_f32", shape, main,
            max(eb["dk"][0], eb["dv"][0]), max(eb["dk"][1], eb["dv"][1]),
            8 * d * pairs, 2 * bq + 4 * bkv + 2 * lse_b, dkv_ms, bwd_plain,
            bwd_lib, library="SDPA backward (dq, dk, dv), profiled"))
        print(f"[kernel-f32] {shape}: lse err {lse_err:.3e} (limit 1e-5); "
              "two #6 / #7 calls bit-identical", flush=True)
        del q, k, v, g, o, o3, lse, po, plse, got, want, lib, delta
        torch.cuda.empty_cache()
    return rows + f32_serving_rows(dev, rn)


# the f32 serving rows: K2 at roberta-large's decode q/v (M = 4 slots the
# main row; K = N = 768 is roberta-base's), K4 over phase 11's dense cache,
# #8 / #8q at phase 11's paged shape (C = 32 the engine's step, C = 1 the
# drafter's)
F32_K2_ROWS = ((4, 1024), (8, 1024), (64, 1024), (4, 768))
# #9f / #10f over int8 weights: (name, M, K = N, group size); the first
# of each is the main row (#9f: a 64-token roberta-large prefill; #10f: 4
# decode slots), K = N = 768 is roberta-base's
F32_W8_ROWS = (("tt_linear_w8_f32", 64, 1024, 0),
               ("tt_linear_w8_f32", 64, 1024, 128),
               ("tt_linear_w8_f32", 64, 768, 0),
               ("tt_linear_batched_a_w8_f32", 4, 1024, 0),
               ("tt_linear_batched_a_w8_f32", 4, 1024, 128),
               ("tt_linear_batched_a_w8_f32", 8, 1024, 0),
               ("tt_linear_batched_a_w8_f32", 4, 768, 0))
F32_PAGED_POS = (0, 37, 100, 161, 230, 299, 407, 479)


def f32_serving_rows(dev, rn):
    """K2, K4, #8 and #8q in f32 against their plain f32 versions at
    roberta-large's serving shapes (16 heads of 64): within 1e-4 of max
    |plain| elementwise, two calls bit-identical, ms by CUDA-graph replay
    over input sets that exceed L2. Library: torch.matmul in f32 (TF32
    off) for K2, SDPA in f32 on the gathered window with the boolean
    position mask for K4, #8 and #8q (the gather left out of its time)."""
    import ctypes

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant
    from repro_torch.kernels import tt_linear as tl
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    alpha, r = 4.0, 8
    for m, kd in F32_K2_ROWS:
        n = kd

        def make():
            return (rn(m, kd), rn(kd, n, scale=kd ** -0.5),
                    rn(m, kd, r, scale=kd ** -0.5), rn(r, n, scale=r ** -0.5))
        nbytes = 4 * (m * kd + kd * n + m * kd * r + r * n + m * n)
        sets = copies(make, nbytes)
        fn = tl.tt_linear_batched_a
        err, rel = f32_err("tt_linear_batched_a_f32", fn(*sets[0], alpha),
                           tl.tt_linear_batched_a_plain(*sets[0], alpha))
        same(lambda *t: fn(*t, alpha), sets[0], "tt_linear_batched_a_f32")
        rows.append(f32_row(
            "tt_linear_batched_a_f32", f"M={m} K={kd} N={n} r={r}",
            (m, kd) == F32_K2_ROWS[0], err, rel,
            2 * m * kd * n + 2 * m * kd * r + 2 * m * r * n, nbytes,
            cuda_time_ms(lambda *t: fn(*t, alpha), sets),
            cuda_time_ms(lambda *t: tl.tt_linear_batched_a_plain(*t, alpha),
                         sets),
            cuda_time_ms(lambda x, w, a, b: torch.matmul(x, w) + alpha
                         * torch.matmul(torch.bmm(x[:, None], a)[:, 0], b),
                         sets),
            splits=tl.ba_f32_splits(m, n, kd, r, sms)))
        del sets
    # #9f / #10f: int8 W (per channel, or groups of 128 rows) with f32
    # scales; library: torch.matmul on a pre-dequantized f32 W + rank term
    mains = set()
    for name, m, kd, group in F32_W8_ROWS:
        n, batched = kd, "batched" in name

        def make8():
            wq, sc = quant.quantize_int8(rn(kd, n, scale=kd ** -0.5), group)
            a = (rn(m, kd, r, scale=kd ** -0.5) if batched
                 else rn(r, kd, scale=kd ** -0.5).T)
            return rn(m, kd), wq, sc, a, rn(r, n, scale=r ** -0.5)
        g_ = kd // group if group else 1
        nbytes = (4 * m * kd + kd * n + 4 * g_ * n
                  + 4 * (m if batched else 1) * kd * r + 4 * r * n
                  + 4 * m * n)
        sets = copies(make8, nbytes)
        fn = getattr(tl, name[:-4])
        plain = getattr(tl, name[:-4] + "_plain")
        err, rel = f32_err(name, fn(*sets[0], alpha), plain(*sets[0], alpha))
        same(lambda *t: fn(*t, alpha), sets[0], name)
        lib_sets = [(t[0], quant.dequantize({"q8": t[1], "scale": t[2]}),
                     *t[3:]) for t in sets]

        def lib(x, w, a, b):
            xa = (torch.bmm(x[:, None], a)[:, 0] if batched
                  else torch.matmul(x, a))
            return torch.matmul(x, w) + alpha * torch.matmul(xa, b)
        rows.append(f32_row(
            name, f"M={m} K={kd} N={n} r={r} "
            + (f"groups of {group}" if group else "per channel"),
            name not in mains, err, rel,
            2 * m * kd * n + 2 * m * kd * r + 2 * m * r * n, nbytes,
            cuda_time_ms(lambda *t: fn(*t, alpha), sets),
            cuda_time_ms(lambda *t: plain(*t, alpha), sets),
            cuda_time_ms(lib, lib_sets),
            library="torch.matmul on a pre-dequantized f32 W + rank-r"))
        mains.add(name)
        del sets, lib_sets
    # K4: 4 slots at positions 0, 37, 130, 255 of a 256-cell cache
    b_, h, d, s_len = 4, 16, 64, 256
    pos = torch.tensor((0, 37, 130, 255), dtype=torch.int32, device=dev)

    def make4():
        return (rn(b_, h, d), rn(b_, s_len, h, d), rn(b_, s_len, h, d), pos)
    cells = sum(min(int(p), s_len - 1) + 1 for p in pos)
    nbytes = 4 * (2 * b_ * h * d + 2 * cells * h * d) + 4 * b_
    sets = copies(make4, nbytes)
    err, rel = f32_err("decode_attention_f32", fa.decode_attention(*sets[0]),
                       fa.decode_attention_plain(*sets[0]))
    same(fa.decode_attention, sets[0], "decode_attention_f32")
    mask = (torch.arange(s_len, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    lib_sets = [(q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2))
                for q, kk, vv, _ in sets]
    rows.append(f32_row(
        "decode_attention_f32",
        f"B={b_} S={s_len} H=KV={h} d={d} "
        f"pos={','.join(map(str, pos.tolist()))}",
        True, err, rel, 4 * h * d * cells, nbytes,
        cuda_time_ms(fa.decode_attention, sets),
        cuda_time_ms(fa.decode_attention_plain, sets),
        cuda_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), lib_sets),
        split=pa.decode_path(b_, h, h, s_len, sms)[1],
        library="SDPA f32, boolean position mask"))
    del sets, lib_sets
    # #8 / #8q: 8 slots, 256 blocks of 16 cells, 34-page tables
    b_, page, n_blk = PAGED["max_batch"], PAGED["page_size"], 256
    p_tab = PAGED["cache_len"] // page + 2
    pos = torch.tensor(F32_PAGED_POS, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(SEED + 24)
    for c in (PAGED["prefill_chunk"], 1):
        last = [min((int(p) + c - 1) // page, p_tab - 1) for p in pos]
        tables = torch.full((b_, p_tab), n_blk, dtype=torch.int32)
        perm, used = torch.randperm(n_blk, generator=gen), 0
        for row, j in enumerate(last):
            tables[row, :j + 1] = perm[used:used + j + 1].int()
            used += j + 1
        tables = tables.to(dev)
        cells = sum(min(int(p) + c, p_tab * page) for p in pos)
        flops = sum(4 * d * h * (int(p) + cc + 1) for p in pos
                    for cc in range(c))
        s_len = p_tab * page
        mask = (torch.arange(s_len, device=dev)[None, None, :]
                <= (pos[:, None] + torch.arange(c, device=dev)[None])
                [:, :, None])[:, None]                   # (B, 1, C, S)
        tbl = tables.long().clamp(max=n_blk - 1)
        shape = (f"B={b_} C={c} H=KV={h} d={d} page={page} P={p_tab} "
                 f"N={n_blk}")
        split = pa.paged_path(b_, c, h, h, p_tab, page, sms, f32=True)[1]
        for quantized in (False, True):
            name = ("paged_decode_attention_int8_f32" if quantized
                    else "paged_decode_attention_f32")
            cell_b = 1 + 4 / d if quantized else 4
            nbytes = int(4 * 2 * b_ * c * h * d + 2 * cells * h * d * cell_b
                         + 4 * b_ * (p_tab + 1))

            def make8():
                q = rn(b_, c, h, d)
                k, v = rn(n_blk, page, h, d), rn(n_blk, page, h, d)
                if not quantized:
                    return q, k, v, tables, pos
                k8, ks = quant.quantize_kv(k)
                v8, vs = quant.quantize_kv(v)
                return q, k8, v8, ks, vs, tables, pos
            sets = copies(make8, nbytes)
            fn = (pa.paged_decode_attention_int8 if quantized
                  else pa.paged_decode_attention)
            plain = (pa.paged_decode_attention_int8_plain if quantized
                     else pa.paged_decode_attention_plain)
            err, rel = f32_err(name, fn(*sets[0]), plain(*sets[0]))
            same(fn, sets[0], name)

            def gathered(t):
                q, k, v = t[0], t[1], t[2]
                if quantized:
                    k = k.float() * t[3][..., None]
                    v = v.float() * t[4][..., None]
                return (q.transpose(1, 2),
                        k[tbl].reshape(b_, s_len, h, d).transpose(1, 2),
                        v[tbl].reshape(b_, s_len, h, d).transpose(1, 2))
            lib_sets = [gathered(t) for t in sets]
            rows.append(f32_row(
                name, shape, c == PAGED["prefill_chunk"], err, rel, flops,
                nbytes, cuda_time_ms(fn, sets), cuda_time_ms(plain, sets),
                cuda_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), lib_sets),
                split=split, library="SDPA f32 on the gathered (and "
                "dequantized) window, boolean mask"))
            del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


def logits_rel_err(eng, eng_ref, req):
    """max |kernel - plain| / max |plain| over one request's last-position
    prefill logits."""
    lg = eng.prefill_logits(req.prompt, req.task).float()
    lg_ref = eng_ref.prefill_logits(req.prompt, req.task).float()
    return float((lg - lg_ref).abs().max() / lg_ref.abs().max())


def routed(cfg):
    """Whether ``cfg`` has MoE blocks: top-k routing that bf16 drift can
    flip near a tie, so that its kernel-vs-plain checks take an f32
    witness (``legs_compared``)."""
    return any(f == "moe" for _, f in cfg.block_pattern)


def f32_cfg(cfg):
    """``cfg`` with f32 parameters and compute: the f32 plain leg's."""
    import torch
    return dataclasses.replace(cfg, param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def f32_tree(tree):
    """``tree`` with every floating tensor cast to f32 (a copy); int8
    weights and pools are kept, since their plain versions dequantize in
    the compute dtype."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


def record_routing(run):
    """``run()`` with every MoE router call's top-k indices recorded, in
    call order (one (tokens, k) tensor a layer a forward). Returns
    (the result, the records)."""
    from repro_torch.models import moe
    rec, router = [], moe.router

    def recording(*args):
        out = router(*args)
        rec.append(out[3].clone())
        return out
    moe.router = recording
    try:
        return run(), rec
    finally:
        moe.router = router


def replayed_routing(run, rec):
    """``run()`` with each MoE router call's top-k indices taken from
    ``rec`` (another leg's ``record_routing`` record, in call order) in
    place of its own top-k; the weights are this call's own probabilities
    at those indices, renormalized as ``moe.router`` does. Legs that share
    a record route every token alike (the same capacity drops too), so
    they differ by their numerics alone. Returns (the result, the indices
    used)."""
    from repro_torch.models import moe
    router, calls, used = moe.router, iter(rec), []

    def replaying(x, w_router, n_k):
        logits, probs, _, _ = router(x, w_router, n_k)
        top_i = next(calls, None)
        if top_i is None or tuple(top_i.shape) != (x.shape[0], n_k):
            raise AssertionError("routing replay: this leg's router calls "
                                 "are not the recorded leg's")
        top_p = probs.gather(-1, top_i)
        used.append(top_i)
        return (logits, probs,
                top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), top_i)
    moe.router = replaying
    try:
        out = run()
    finally:
        moe.router = router
    if len(used) != len(rec):
        raise AssertionError(f"routing replay: {len(used)} router calls, "
                             f"{len(rec)} recorded")
    return out, used


def routed_leg(run, rec=None):
    """``run()`` recording its routing (``rec`` None) or replaying ``rec``
    (``replayed_routing``). Returns (the result, the record)."""
    return record_routing(run) if rec is None else replayed_routing(run, rec)


def routing_flips(a, b):
    """Share of (token, layer) rows whose top-k expert SETS differ between
    two lists of per-layer top-k index tensors."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff / sum(x.shape[0] for x in a)


def legs_compared(run, witness):
    """``run(leg)``: one leg's logits rows for the legs "kernel" and
    "plain" (``backend="ref"``) in the model's dtype and, with
    ``witness``, "f32" (the plain leg in f32 on the same weights and
    inputs). Returns (the largest over rows of max |kernel - plain| /
    max |plain|, the rows whose argmax agree, the witness): the witness
    is None, or (kernel vs f32, plain bf16 vs f32, the share of (token,
    layer) top-k sets that differ between each pair of legs), as
    ``logits_checked`` takes it."""
    out, rec = {}, {}
    for leg in ("kernel", "plain") + (("f32",) if witness else ()):
        out[leg], rec[leg] = record_routing(lambda: run(leg).float())
    return legs_verdict(out, rec)


def rel_rows(a, b):
    """The largest over rows of max |a - b| / max |b|."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def legs_verdict(out, rec=None):
    """``legs_compared``'s result from the legs' logits rows ``out``
    ("kernel", "plain" and, for a witness, "f32") and, on a MoE model,
    their top-k records ``rec`` (None: no routing, and no flips in the
    witness)."""
    k, p = out["kernel"], out["plain"]
    res = (rel_rows(k, p), int((k.argmax(-1) == p.argmax(-1)).sum()))
    if "f32" not in out:
        return res + (None,)
    flips = None if rec is None else {
        f"{a}/{b}": routing_flips(rec[a], rec[b]) for a, b in (
            ("kernel", "plain"), ("plain", "f32"), ("kernel", "f32"))}
    return res + ((rel_rows(k, out["f32"]), rel_rows(p, out["f32"]),
                   flips),)


def decode_step_rel_err(cfg, rt, reqs, cache_len, dev, base=None):
    """One decode step of ``len(reqs)`` slots, each at its own task and
    position, from the same prefilled caches through the kernel leg and
    the plain leg (over ``base``, default the runtime's) and, on a MoE
    model, the f32 plain leg on the same caches and base cast to f32.
    Returns ``legs_compared``'s (rel, agree, witness) over the slots'
    logits rows."""
    base = rt.base if base is None else base
    inp = decode_step_inputs(cfg, rt, reqs, cache_len, dev, base)
    return legs_compared(
        lambda leg: decode_step_leg(leg, cfg, rt, base, inp, dev),
        routed(cfg))


def decode_step_inputs(cfg, rt, reqs, cache_len, dev, base):
    """The inputs of ``decode_step_rel_err``'s step: the slots' caches
    filled by a kernel-leg prefill of each prompt over ``base``, the next
    token (its argmax), the positions and tasks. Holds no weight."""
    import torch
    from repro_torch.models import transformer as T
    n = len(reqs)
    caches = T.init_caches(cfg, n, cache_len, cfg.compute_dtype, device=dev)
    tok = torch.zeros((n, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((n,), dtype=torch.long, device=dev)
    with torch.inference_mode():
        for slot, r in enumerate(reqs):
            out = T.forward(base, cfg, rt.spec, rt.broadcast, rt.per_layer,
                            torch.as_tensor(r.prompt, device=dev)[None],
                            task=r.task if rt.tasked else None,
                            return_caches=True, device=dev)
            T.insert_cache_slot(caches, out.caches, slot)
            tok[slot, 0] = out.logits[0, -1].argmax()
            pos[slot] = len(r.prompt)
    task = (torch.tensor([r.task for r in reqs], device=dev)
            if rt.tasked else None)
    return dict(caches=caches, tok=tok, pos=pos, task=task)


def decode_step_leg(leg, cfg, rt, base, inp, dev):
    """One leg of ``decode_step_rel_err``'s step over ``base`` ("f32":
    the plain leg on ``cfg``, ``base`` and the caches cast to f32 — a
    base already in f32 is not copied); ``rt`` lends its adapter factors
    only. Returns the slots' logits rows."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    c, b, kv = cfg, base, tree_map(torch.clone, inp["caches"])
    if leg == "f32":
        c, b, kv = f32_cfg(cfg), f32_tree(base), f32_tree(kv)
    with torch.inference_mode():
        return T.decode_step(b, c, rt.spec, rt.broadcast, rt.per_layer,
                             inp["tok"], kv, inp["pos"], task=inp["task"],
                             policy=dispatch.DEFAULT if leg == "kernel"
                             else dispatch.REF, device=dev)[0]


def adapter_ratio(rt, spec, gen):
    """||α·(x·A)·B|| / ||x·W|| for layer 0's q projection, task 0, on a
    unit-normal x: how strong the adapter is against the frozen base."""
    import torch
    from repro_torch.peft import api as peft_api
    x = torch.randn((16, spec.cfg.d_in[0]), generator=gen,
                    device=gen.device)
    a, b, alpha = peft_api.lora_form_factors(
        spec, rt.broadcast, {"c": rt.per_layer["c"][0]}, "attn_q", task=0)
    base = x @ rt.base["blocks"][0]["mixer"]["wq"][0].float()
    return float((alpha * (x @ a) @ b).norm() / base.norm())


def device_share(label, run, top_n=8, show=()):
    """Device busy share of ``run()`` under torch.profiler: the card's
    activity time (kernels, copies) over the host wall time, and the
    kernels that take the most device time, plus any kernel whose name
    holds one of ``show``. The profiler records the card's activity only
    and its raw events are summed: turning the thousands of events an
    eager step makes into profiler records takes tens of seconds a
    window. Returns (the result of ``run()``, the share or None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:   # kernels / copies
            ns = (e.duration_ns() if hasattr(e, "duration_ns")
                  else 1000 * e.duration_us())
            t, n = per_name.get(e.name(), (0, 0))
            per_name[e.name()] = (t + ns, n + 1)
    read = time.perf_counter() - t0 - wall
    if not per_name:
        print(f"[profile] {label}: no device time in the trace: busy share "
              "not measured")
        return out, None
    busy = sum(t for t, _ in per_name.values()) / 1e9
    print(f"[profile] {label}: wall {wall:.3f}s, device busy {busy:.3f}s = "
          f"{100 * busy / wall:.1f}% (profiled; the trace took {read:.1f}s "
          "to stop and read)")
    ranked = sorted(((t, n, k) for k, (t, n) in per_name.items()),
                    reverse=True)
    top = ranked[:top_n] + [r for r in ranked[top_n:]
                            if any(s in r[2] for s in show)]
    for t, n, key in top:
        print(f"[profile]   {t / 1e6:9.2f} ms  {n:6d}x  {key[:90]}")
    return out, busy / wall


def serving_model(dev, tag, arch="stablelm-1.6b", ratio=None, layers=None,
                  seed=SEED, variant="4+1d"):
    """Full-width ``arch`` (stablelm-1.6b; roberta-large in phase 11,
    gemma-7b in phase 12; ``layers``: its depth cut to that many layers),
    random base weights in the config's dtype from a generator seeded
    with ``seed``, and the served 4+1d MetaTT adapter on q/v (rank 8, 3
    tasks, ``random_tt(scale=0.5)``; with ``ratio``, its last core scaled
    so that the adapter is ``ratio`` of the base q projection). With
    ``variant="4+ed"`` (a MoE model) the adapter is MetaTT-(4+E)D on q, v
    and the expert down-projections, with no task axis. Returns (cfg,
    spec, params, rt, gen)."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import RunConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime

    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    run = RunConfig(model=cfg, adapter_kind="metatt",
                    adapter_variant=variant,
                    num_tasks=3 if variant == "4+1d" else 0, adapter_rank=8)
    spec = M.build_adapter_spec(run)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = M.init_params(cfg, spec, generator=gen, device=dev)
    params["adapter"] = {"cores": ttlib.random_tt(
        gen, spec.cfg.mode_sizes, 8, scale=0.5, device=dev)}
    rt = AdapterRuntime.build("live", params["base"], spec,
                              params["adapter"], params["frozen"])
    note = ""
    if ratio is not None:
        raw = q_ratio(cfg, rt, gen)
        params["adapter"]["cores"][-1] *= ratio / raw   # ΔW is linear in it
        rt = AdapterRuntime.build("live", params["base"], spec,
                                  params["adapter"], params["frozen"])
        note = (f", adapter/base q-projection ratio "
                f"{q_ratio(cfg, rt, gen):.3e} (random_tt(0.5): {raw:.3e})")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in M.tensors(params["base"]))
    dtype = str(cfg.param_dtype).removeprefix("torch.")
    print(f"[{tag}] {arch} {dtype}, {cfg.num_layers} layers: "
          f"{nbytes / 1e9:.3f} GB of base "
          f"weights{note}, init {time.perf_counter() - t0:.1f}s", flush=True)
    return cfg, spec, params, rt, gen


def dense_requests(cfg, seed=SEED):
    """Phase 3's 8 mixed-task requests on ``cfg``'s vocab: 16-96 prompt
    tokens over 3 tasks, 32 new tokens each."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(seed)
    return [Request(rng.randint(0, cfg.vocab_size, size=int(n)), 32,
                    task=i % 3)
            for i, n in enumerate(rng.randint(16, 97, size=8))]


def phase_serving(dev):
    """Dense-cache engine on full-width stablelm-1.6b, 8 mixed-task
    requests; kernel launches counted around ``generate`` only."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import KernelConfig, ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.serving import AdapterRuntime, Engine
    from repro_torch.tree import tree_map

    cfg, spec, params, rt, gen = serving_model(dev, "serve")
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    reqs = dense_requests(cfg)
    eng.generate(reqs[:2])                       # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = eng.last_stats
    fp_tokens = [o.tolist() for o in outs]
    for res in eng.last_results:
        if res.status != "FINISHED" or res.n_generated != 32:
            raise AssertionError(f"request ended {res.status} with "
                                 f"{res.n_generated} tokens")
    for o in outs:
        if not (0 <= int(o.min()) and int(o.max()) < cfg.vocab_size):
            raise AssertionError(f"token id outside the vocab: {o}")
    for name in ("tt_linear", "tt_linear_batched_a", "flash_attention",
                 "decode_attention"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched during generate")
    want = {"tt_linear_batched_a": 2 * cfg.num_layers * st.decode_steps,
            "decode_attention": cfg.num_layers * st.decode_steps}
    for name, n in want.items():   # 48 K2 and 24 K4 a decode step
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"over {st.decode_steps} decode steps, "
                                 f"want {n}")
    print(f"[serve] launches during generate: {json.dumps(launches)}")
    print(f"[serve] {st.requests} requests, {st.tokens_generated} tokens in "
          f"{st.wall_s:.3f}s = {st.tokens_per_s:.1f} tok/s; prefill "
          f"{1e3 * st.prefill_s / max(st.prefills, 1):.2f} ms/request; decode "
          f"{1e3 * st.decode_s / max(st.decode_steps, 1):.2f} ms/step over "
          f"{st.decode_steps} steps; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)

    device_share("generate of 4 requests", lambda: eng.generate(reqs[:4]))

    # the plain-version leg on the same card and weights
    eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
        backend="ref"), device=dev)
    req = reqs[0]
    rel_served = logits_rel_err(eng, eng_ref, req)
    print(f"[serve] served adapter: adapter/base q-projection ratio "
          f"{adapter_ratio(rt, spec, gen):.3e}; prefill last-position "
          f"logits, kernel leg vs plain leg: max rel err {rel_served:.3e}")
    # witness for the served adapter: the plain leg in f32 on the same
    # weights. If bf16 rounding alone sends the model elsewhere, the plain
    # bf16 leg is as far from f32 as the kernel leg is; the kernel leg
    # must be no farther from f32 than twice the plain bf16 leg (+ 5%)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    rt32 = AdapterRuntime.build(
        "live", tree_map(lambda t: t.float(), params["base"]), spec,
        params["adapter"], params["frozen"])
    eng32 = Engine(cfg32, rt32, serve=serve,
                   kernels=KernelConfig(backend="ref"), device=dev)
    plain_vs_f32 = logits_rel_err(eng_ref, eng32, req)
    kernel_vs_f32 = logits_rel_err(eng, eng32, req)
    print(f"[serve] served adapter vs the f32 plain leg: plain bf16 "
          f"{plain_vs_f32:.3e}, kernel bf16 {kernel_vs_f32:.3e} (limit "
          f"2 x plain + 5e-2 = {2 * plain_vs_f32 + 5e-2:.3e})")
    if not kernel_vs_f32 <= 2 * plain_vs_f32 + 5e-2:
        raise AssertionError("kernel leg farther from f32 than the plain "
                             f"bf16 leg: {kernel_vs_f32:.3e} vs "
                             f"{plain_vs_f32:.3e}")
    del eng32, rt32
    # the same base under a mild adapter (its output ~1e-1 of the base
    # projection, as a fine-tuned update is): the kernel leg must give
    # the plain leg's logits to within bf16 drift through 24 layers —
    # held to 5% of the largest logit, at prefill and at one decode step
    mild = AdapterRuntime.build("live", params["base"], spec, {
        "cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                 device=dev)}, params["frozen"])
    eng_mild = Engine(cfg, mild, serve=serve, device=dev)
    eng_mild_ref = Engine(cfg, mild, serve=serve,
                          kernels=KernelConfig(backend="ref"), device=dev)
    rel = logits_rel_err(eng_mild, eng_mild_ref, req)
    print(f"[serve] mild adapter (ratio {adapter_ratio(mild, spec, gen):.3e}"
          f"): prefill logits vs plain leg max rel err {rel:.3e} "
          "(limit 5e-2)")
    if not rel <= 5e-2:
        raise AssertionError(f"prefill logits differ from the plain leg: "
                             f"{rel:.3e}")
    rel_dec, same, _ = decode_step_rel_err(cfg, mild, reqs[:4],
                                           serve.cache_len, dev)
    print(f"[serve] mild adapter, one decode step of 4 slots (tasks "
          f"{[r.task for r in reqs[:4]]}, positions "
          f"{[len(r.prompt) for r in reqs[:4]]}): logits vs plain leg max "
          f"rel err per slot {rel_dec:.3e} (limit 5e-2), argmax equal "
          f"{same}/4")
    if not rel_dec <= 5e-2:
        raise AssertionError(f"decode-step logits differ from the plain "
                             f"leg: {rel_dec:.3e}")
    # greedy agreement with the plain leg, reported, not asserted: bf16
    # argmax near-ties may flip, and one flip changes the rest of a request
    for label, a, b in (("served", eng, eng_ref),
                        ("mild", eng_mild, eng_mild_ref)):
        got, want = a.generate(reqs), b.generate(reqs)
        same = sum(int(x == y) for o, r in zip(got, want)
                   for x, y in zip(o.tolist(), r.tolist()))
        first = sum(int(o[0] == r[0]) for o, r in zip(got, want))
        print(f"[serve] {label} adapter: greedy tokens equal to the plain "
              f"leg {same}/{sum(len(o) for o in got)}, first tokens "
              f"{first}/{len(got)}")
    return launches, dict(reqs=reqs, tokens=fp_tokens)


def prefill_leg(leg, cfg, rt, base, req, dev):
    """One leg of a prefill check: the last-position logits of ``req``'s
    prompt through the model's forward over ``base`` ("f32": the plain
    leg on ``cfg`` and ``base`` cast to f32, a base already in f32 not
    copied); ``rt`` lends its adapter factors only."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    c, b = (f32_cfg(cfg), f32_tree(base)) if leg == "f32" else (cfg, base)
    tokens = torch.as_tensor(req.prompt, device=dev)[None]
    with torch.inference_mode():
        return T.forward(b, c, rt.spec, rt.broadcast, rt.per_layer, tokens,
                         task=req.task if rt.tasked else None,
                         policy=dispatch.DEFAULT if leg == "kernel"
                         else dispatch.REF, device=dev).logits[0, -1:]


def paged_step_rel_err(cfg, rt, prompts, tasks, dev, base=None,
                       kv_quant=False):
    """One pure-decode and one mixed prefill/decode ``paged_step`` (the
    engine's (B, 32) step) from the same pools through the kernel leg and
    the plain leg (over ``base``, default the runtime's; int8 pools with
    ``kv_quant``); ``paged_step_inputs`` makes the pools and steps. On a
    MoE model, also the f32 plain leg on the same pools and base cast to
    f32. Returns {step: ``legs_compared``'s (rel, agree, witness) over the
    slots' logits rows}."""
    base = rt.base if base is None else base
    inp = paged_step_inputs(cfg, rt, prompts, tasks, dev, base, kv_quant)
    return {name: legs_compared(
        lambda leg: paged_step_leg(leg, cfg, rt, base, inp, name, dev),
        routed(cfg)) for name in inp["steps"]}


def paged_step_inputs(cfg, rt, prompts, tasks, dev, base, kv_quant=False):
    """The pools of ``paged_step_rel_err``, filled by chunked prefill of
    every prompt (kernel leg, over ``base``), the tables and tasks, and
    its two steps: decode, every slot one token at position plen; mixed,
    slots 0-1 decode, slots 2-3 prefill the 32 prompt tokens from
    position 96 (the cells they overwrite hold the same tokens' KV).
    Holds no weight."""
    import torch
    from repro_torch.models import transformer as T
    n, c, page = len(prompts), PAGED["prefill_chunk"], PAGED["page_size"]
    pages = PAGED["cache_len"] // page
    caches = T.init_paged_caches(cfg, n * pages, page, cfg.compute_dtype,
                                 kv_quant=kv_quant, device=dev)
    tables = torch.full((n, pages + 2), n * pages, dtype=torch.int32)
    tables[:, :pages] = torch.arange(n * pages).reshape(n, pages)
    task = torch.tensor(tasks, device=dev)
    plen = [len(p) for p in prompts]

    def toks_at(start, width):
        t = torch.zeros((n, c), dtype=torch.long)
        for i, p in enumerate(prompts):
            seg = p[start[i]:start[i] + width[i]]
            t[i, :len(seg)] = torch.as_tensor(seg)
        return t
    with torch.inference_mode():
        done = [0] * n
        while any(d < pl_ for d, pl_ in zip(done, plen)):
            width = [min(c, pl_ - d) for d, pl_ in zip(done, plen)]
            T.paged_step(base, cfg, rt.spec, rt.broadcast, rt.per_layer,
                         toks_at(done, width), caches, tables,
                         torch.tensor(done),
                         torch.tensor([max(w - 1, 0) for w in width]),
                         task=task, device=dev)
            done = [d + w for d, w in zip(done, width)]
    nxt = toks_at(plen, [1] * n)
    nxt[:, 0] = torch.arange(n) + 11         # any next token
    mixed = nxt.clone()
    mixed[2:] = toks_at([96] * n, [c] * n)[2:]
    steps = {"decode": (nxt, plen, [0] * n),
             "mixed": (mixed, plen[:2] + [96] * (n - 2),
                       [0, 0] + [c - 1] * (n - 2))}
    return dict(caches=caches, tables=tables, task=task, steps=steps)


def paged_step_leg(leg, cfg, rt, base, inp, name, dev):
    """One leg of ``paged_step_rel_err``'s step ``name`` over ``base``
    ("f32": the plain leg on ``cfg``, ``base`` and the pools cast to f32,
    int8 pools kept; a base already in f32 is not copied). Returns the
    slots' logits rows."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    toks, pos, sel = inp["steps"][name]
    c, b, kv = cfg, base, tree_map(torch.clone, inp["caches"])
    if leg == "f32":
        c, b, kv = f32_cfg(cfg), f32_tree(base), f32_tree(kv)
    with torch.inference_mode():
        return T.paged_step(
            b, c, rt.spec, rt.broadcast, rt.per_layer, toks, kv,
            inp["tables"], torch.tensor(pos), torch.tensor(sel),
            task=inp["task"], policy=dispatch.DEFAULT if leg == "kernel"
            else dispatch.REF, device=dev)[0]


def serve_checked(eng, reqs, label, tag, new=32):
    """``generate`` with the serving checks: every request FINISHED with
    ``new`` tokens inside the vocab, no leaked block (paged); prints the
    stats."""
    import torch
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    st = eng.last_stats
    for res in eng.last_results:
        if res.status != "FINISHED" or res.n_generated != new:
            raise AssertionError(f"{label}: request ended {res.status} "
                                 f"with {res.n_generated} tokens")
    for o in outs:
        if not (0 <= int(o.min()) and int(o.max()) < eng.cfg.vocab_size):
            raise AssertionError(f"token id outside the vocab: {o}")
    if eng.paged and eng.leaked_blocks():
        raise AssertionError(f"{label}: {eng.leaked_blocks()} KV blocks "
                             "leaked")
    steps = max(st.decode_steps, 1)
    print(f"[{tag}] {label}: w={st.weights_dtype} kv={st.kv_dtype}, "
          f"{st.requests} requests, {st.tokens_generated} tokens in "
          f"{st.wall_s:.3f}s = {st.tokens_per_s:.1f} tok/s; "
          + (f"prefill {1e3 * st.prefill_s / max(st.prefills, 1):.2f} "
             f"ms/request over {st.prefills}; " if st.prefills else "")
          + f"decode {1e3 * st.decode_s / steps:.2f} ms/step over "
          f"{st.decode_steps} steps in {st.decode_calls} loop calls; ttft "
          f"{1e3 * st.ttft_s:.1f} ms, tpot {1e3 * st.tpot_s:.2f} ms; prefix "
          f"hit rate {st.prefix_hit_rate:.3f} ({st.prefix_hit_tokens} of "
          f"{st.prefix_lookup_tokens} tokens), cow {st.cow_copies}, cache "
          f"evictions {st.cache_evictions}, backpressure waits "
          f"{st.backpressure_waits}, kv blocks peak "
          f"{st.kv_blocks_peak}/{st.num_blocks}, kv_bytes_peak "
          f"{st.kv_bytes_peak}", flush=True)
    return outs, st


def phase_paged(dev):
    """The paged engine (the default ServeConfig mode: block pools, prefix
    cache with copy-on-write, in-loop chunked prefill) on full-width
    stablelm-1.6b: 16 requests over 3 tasks, 40-300 prompt tokens, 32 new
    tokens each, half sharing a 100-token prefix per task (it ends
    mid-page, so a warm match copies that page on write), served cold then
    warm. Kernel launches counted around the two ``generate`` calls."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.serving import AdapterRuntime, Engine

    cfg, spec, params, rt, gen = serving_model(dev, "paged")
    serve = ServeConfig(cache_mode="paged", **PAGED)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    pool_gb = sum(t.numel() * t.element_size() for c in eng._paged_caches
                  for t in c["self"].values()) / 1e9
    print(f"[paged] {serve.resolved_num_blocks} blocks of "
          f"{serve.page_size} cells, {pool_gb:.3f} GB of K/V pools; "
          f"chunk {serve.prefill_chunk}, {serve.max_batch} slots", flush=True)
    reqs = paged_requests(cfg)
    print(f"[paged] prompt lengths {[len(r.prompt) for r in reqs]}, tasks "
          f"{[r.task for r in reqs]}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    steps = kv_peak = 0
    for label in ("cold", "warm"):
        _, st = serve_checked(eng, reqs, label, "paged")
        steps += st.decode_steps
        kv_peak = max(kv_peak, st.kv_bytes_peak)
    launches = K.launch_counts()
    print(f"[paged] launches during the two generates: "
          f"{json.dumps(launches)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    n_pa = launches["paged_decode_attention"]
    if not (n_pa > 0 and n_pa == cfg.num_layers * steps):
        raise AssertionError(f"paged_decode_attention launched {n_pa} "
                             f"times in {steps} engine steps")
    # at 4+1d the (B, 32) adapted q/v take the batched einsum: no K1 / K2
    if launches["tt_linear"] or launches["tt_linear_batched_a"]:
        raise AssertionError(f"K1/K2 launched on the paged path: "
                             f"{launches}")
    if not (st.prefix_hit_tokens > 0 and st.cow_copies >= 1):
        raise AssertionError("warm run: no prefix hit or no COW copy")

    device_share("paged generate of 16 requests (warm)",
                 lambda: eng.generate(reqs))
    del eng
    torch.cuda.empty_cache()
    # kernel leg vs plain leg at one paged step, under a mild adapter
    mild = AdapterRuntime.build("live", params["base"], spec, {
        "cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                 device=dev)}, params["frozen"])
    # slots 0-1 decode, slots 2-3 (the longest prompts) prefill a chunk
    picked = reqs[1:3] + sorted(reqs[3:], key=lambda r: len(r.prompt))[-2:]
    res = paged_step_rel_err(cfg, mild, [r.prompt for r in picked],
                             [r.task for r in picked], dev)
    for name, (rel, same, _) in res.items():
        print(f"[paged] mild adapter, one {name} paged step of 4 slots "
              f"(prompts {[len(r.prompt) for r in picked]}): selected-"
              f"column logits vs plain leg max rel err per slot {rel:.3e} "
              f"(limit 5e-2), argmax equal {same}/4")
        if not rel <= 5e-2:
            raise AssertionError(f"{name} paged step logits differ from "
                                 f"the plain leg: {rel:.3e}")
    return launches, dict(reqs=reqs, kv_bytes_peak=kv_peak)


def unadapted_projection_cost(cfg, qbase, dev):
    """Device ms that the unadapted projections (wk, wo, wu, wg, wd) of
    one engine step spend under int8 weights, which dequantize W to bf16
    on every call before a plain matmul: each layer-0 matrix at the int8
    paged step's M = 8 x 32 rows and the dense decode's M = 4, timed with
    CUDA events as dequantize + matmul and as the matmul alone on a
    pre-dequantized bf16 W, summed over the layers. A MoE block's FFN
    (its expert banks) is not quantized: wk and wo alone."""
    import torch
    from repro_torch.kernels import quant
    blk = qbase["blocks"][0]
    names = [(g, n) for g, n in (("mixer", "wk"), ("mixer", "wo"),
                                 ("ffn", "wu"), ("ffn", "wg"), ("ffn", "wd"))
             if quant.is_quantized(blk[g].get(n))]
    mats = [{k: v[0] for k, v in blk[g][n].items()} for g, n in names]
    label = ", ".join(n for _, n in names)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for m in (PAGED["max_batch"] * PAGED["prefill_chunk"], 4):
        deq = mm = 0.0
        for w in mats:
            x = torch.randn((m, w["q8"].shape[0]), generator=gen,
                            device=dev).to(torch.bfloat16)
            wb = quant.dequantize(w, torch.bfloat16)
            deq += event_time_ms(
                lambda: x @ quant.dequantize(w, torch.bfloat16), (),
                iters=20)
            mm += event_time_ms(lambda: x @ wb, (), iters=20)
        print(f"[quant] unadapted projections ({label}) at M={m}:"
              f" dequantize + matmul {deq:.4f} ms a layer, "
              f"{cfg.num_layers * deq:.3f} ms a step; matmul on a "
              f"pre-dequantized bf16 W {mm:.4f} ms a layer, "
              f"{cfg.num_layers * mm:.3f} ms a step", flush=True)


def phase_quant(dev, dense_run, paged_run):
    """Quantized serving on full-width stablelm-1.6b (the served 4+1d
    adapter, random weights from the same seed as phases 3 and 4).
    Part 1: the paged engine with QuantConfig(weights="int8", kv="int8")
    over phase 4's 16 requests, cold then warm. Part 2: the dense engine
    with int8 weights over phase 3's 8 requests. Part 3: under a mild
    adapter, one int8 paged step and one w8 dense decode step, kernel leg
    against the plain leg. Each engine's launches are counted around its
    own ``generate`` calls (two paths)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import KernelConfig, QuantConfig, \
        ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime, Engine

    cfg, spec, params, rt, gen = serving_model(dev, "quant")
    torch.cuda.reset_peak_memory_stats(dev)
    eng = Engine(cfg, rt, serve=ServeConfig(
        cache_mode="paged", quant=QuantConfig(weights="int8", kv="int8"),
        **PAGED), device=dev)
    w8_gb = sum(t.numel() * t.element_size()
                for t in M.tensors(eng.base_weights)) / 1e9
    pool_gb = sum(t.numel() * t.element_size() for c in eng._paged_caches
                  for t in c["self"].values()) / 1e9
    print(f"[quant] base after quantize_base: {w8_gb:.3f} GB (int8 matmul "
          f"leaves + f32 scales + bf16 embedding and norms); int8 K/V "
          f"pools with f32 scales: {pool_gb:.3f} GB for "
          f"{eng.sv.resolved_num_blocks} blocks", flush=True)
    reqs = paged_run["reqs"]
    K.reset_launch_counts()
    steps = kv_peak = 0
    for label in ("cold", "warm"):
        _, st = serve_checked(eng, reqs, label, "quant")
        steps += st.decode_steps
        kv_peak = max(kv_peak, st.kv_bytes_peak)
    paged = K.launch_counts()
    print(f"[quant] paged launches during the two generates: "
          f"{json.dumps(paged)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    n_q = paged["paged_decode_attention_int8"]
    if not (n_q > 0 and n_q == cfg.num_layers * steps):
        raise AssertionError(f"paged_decode_attention_int8 launched {n_q} "
                             f"times in {steps} engine steps")
    others = {k: v for k, v in paged.items()
              if v and k != "paged_decode_attention_int8"}
    if others:      # no fp #8; the (B, 32) q/v take the batched einsum
        raise AssertionError(f"other kernels on the int8 paged path: "
                             f"{others}")
    if not (st.prefix_hit_tokens > 0 and st.cow_copies >= 1):
        raise AssertionError("int8 warm run: no prefix hit or no COW copy")
    # peak over the cold and warm runs, as phase 4's
    if not kv_peak < paged_run["kv_bytes_peak"]:
        raise AssertionError(f"int8 kv_bytes_peak {kv_peak} not below the "
                             f"fp paged run's {paged_run['kv_bytes_peak']}")
    print(f"[quant] kv_bytes_peak (cold and warm) int8 {kv_peak} vs fp "
          f"{paged_run['kv_bytes_peak']} "
          f"({kv_peak / paged_run['kv_bytes_peak']:.3f}x)")
    device_share("int8 paged generate of 16 requests (warm)",
                 lambda: eng.generate(reqs), top_n=12)
    unadapted_projection_cost(cfg, eng.base_weights, dev)
    del eng
    torch.cuda.empty_cache()

    # part 2: the dense engine over int8 weights (#9 at prefill, #10 at
    # decode), weights quantized through KernelConfig.quant
    dense = Engine(cfg, rt, serve=ServeConfig(
        cache_mode="dense", max_batch=4, cache_len=256, out_cap=32),
        kernels=KernelConfig(quant=QuantConfig(weights="int8")), device=dev)
    reqs = dense_run["reqs"]
    dense.generate(reqs[:2])                    # warm-up (allocator)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outs, st = serve_checked(dense, reqs, "dense w8", "quant")
    dense_launches = K.launch_counts()
    print(f"[quant] dense w8 launches during generate: "
          f"{json.dumps(dense_launches)}", flush=True)
    want = {"tt_linear_w8": 2 * cfg.num_layers * st.prefills,
            "tt_linear_batched_a_w8": 2 * cfg.num_layers * st.decode_steps}
    for name, n in want.items():
        if not (n > 0 and dense_launches[name] == n):
            raise AssertionError(f"{name} launched {dense_launches[name]} "
                                 f"times, want {n}")
    if dense_launches["tt_linear"] or dense_launches["tt_linear_batched_a"]:
        raise AssertionError(f"K1/K2 launched on the w8 path: "
                             f"{dense_launches}")
    same = sum(int(x == y) for o, r in zip(outs, dense_run["tokens"])
               for x, y in zip(o.tolist(), r))
    total = sum(len(r) for r in dense_run["tokens"])
    print(f"[quant] dense w8 greedy tokens equal to phase 3's fp tokens at "
          f"{same}/{total} positions = {same / total:.3f} (reported: random "
          f"weights make any limit arbitrary)", flush=True)
    device_share("dense w8 generate of 4 requests",
                 lambda: dense.generate(reqs[:4]), top_n=12)
    qbase = dense.base_weights
    del dense
    torch.cuda.empty_cache()

    # part 3: kernel leg vs plain leg under a mild adapter, one int8 paged
    # step and one w8 dense decode step, limit 5% of the largest logit
    mild = AdapterRuntime.build("live", params["base"], spec, {
        "cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                 device=dev)}, params["frozen"])
    preqs = paged_run["reqs"]
    picked = preqs[1:3] + sorted(preqs[3:], key=lambda r: len(r.prompt))[-2:]
    res = {f"int8 paged {k}": v for k, v in paged_step_rel_err(
        cfg, mild, [r.prompt for r in picked], [r.task for r in picked],
        dev, base=qbase, kv_quant=True).items()}
    res["w8 dense decode"] = decode_step_rel_err(
        cfg, mild, reqs[:4], 256, dev, base=qbase)
    for name, (rel, n_same, _) in res.items():
        print(f"[quant] mild adapter, one {name} step of 4 slots: logits vs "
              f"plain leg max rel err per slot {rel:.3e} (limit 5e-2), "
              f"argmax equal {n_same}/4")
        if not rel <= 5e-2:
            raise AssertionError(f"int8 {name} step logits differ from the "
                                 f"plain leg: {rel:.3e}")
    del qbase, mild, params, rt
    torch.cuda.empty_cache()
    return {"quant_paged": paged, "quant_dense": dense_launches}


def rel_fro(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def cosine(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def mild_adapter(spec, gen, dev):
    """The gradient check's default adapter: random MetaTT cores of rank 8
    at scale 0.12, as phase 3's mild adapter."""
    from repro_torch.core import tt as ttlib
    return {"cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8,
                                     scale=0.12, device=dev)}


def grad_legs(legs, spec, adapter, frozen, tokens, dev, routing=None,
              extra=None):
    """{leg: (loss, adapter gradients)} for each (leg, cfg, base, policy)
    of ``legs``: the loss over ``tokens`` (mask all ones; ``extra``: more
    batch entries, an enc-dec model's ``enc_embeds``). On a MoE model
    the legs share one routing (``routed_leg``): the first leg's record,
    kept in ``routing`` ("rec") for a later call's legs, is replayed in
    the others, forward and backward."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    batch = {"tokens": tokens, "mask": torch.ones_like(tokens,
                                                      dtype=torch.float32),
             **(extra or {})}
    routing = {} if routing is None else routing
    out = {}
    for name, c, b, pol in legs:
        params = tree_map(lambda t: t.clone().requires_grad_(True), adapter)

        def run():
            loss, _ = M.loss_fn(params, b, frozen or {}, batch, c, spec,
                                policy=pol, device=dev)
            return (float(loss.detach()),
                    torch.autograd.grad(loss, M.tensors(params)))
        out[name], routing["rec"] = routed_leg(run, routing.get("rec"))
    return out


def grad_check(cfg, spec, base, gen, tokens, dev, adapter=None,
               frozen=None, tag="train"):
    """Loss and adapter gradients at B=1, T=1024 under a mild adapter (by
    default ``mild_adapter``), in three legs on the same weights: kernels
    (bf16), the plain versions (bf16, ``KernelConfig(backend="ref")``) and
    the plain versions in f32 as the witness, held by
    ``grad_verdict``."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_map
    if adapter is None:
        adapter = mild_adapter(spec, gen, dev)
    base32 = tree_map(lambda t: t.float(), base)
    legs = grad_legs((("kernel", cfg, base, dispatch.DEFAULT),
                      ("plain", cfg, base, dispatch.REF),
                      ("f32", f32_cfg(cfg), base32, dispatch.REF)),
                     spec, adapter, frozen, tokens, dev)
    del base32
    torch.cuda.empty_cache()
    grad_verdict(legs, adapter, tokens, tag)


def grad_verdict(legs, adapter, tokens, tag):
    """``grad_check``'s limits on the legs' (loss, gradients): the loss
    within 1e-2 of the plain bf16 leg and each leaf's gradient no farther
    from the f32 leg than twice the plain bf16 leg's distance + 5e-2
    (relative Frobenius), and its cosine with the f32 leg's at least half
    the plain bf16 leg's. The second limit is what fails a zero, random or
    sign-flipped gradient where bf16 sets the plain leg far from f32
    (jamba's mamba layers: a zero gradient is 1.0 away, inside the first
    limit once the plain leg is 0.475 away)."""
    import torch
    names = [f"{k}/{i}" if isinstance(v, list) else k
             for k, v in adapter.items()
             for i in (range(len(v)) if isinstance(v, list) else [0])]
    (lk, gk), (lp, gp), (l32, g32) = (legs[n] for n in ("kernel", "plain",
                                                        "f32"))
    rel_loss = abs(lk - lp) / abs(lp)
    print(f"[{tag}] gradient check B=1 T={tokens.shape[1]}: loss kernel "
          f"{lk:.6f} plain {lp:.6f} f32 {l32:.6f}; |kernel - plain| / plain "
          f"{rel_loss:.3e} (limit 1e-2)")
    if not rel_loss <= 1e-2:
        raise AssertionError(f"training loss differs from the plain leg: "
                             f"{rel_loss:.3e}")
    for name, a, b, c in zip(names, gk, gp, g32):
        k32, p32 = rel_fro(a, c), rel_fro(b, c)
        kc, pc = cosine(a, c), cosine(b, c)
        print(f"[{tag}]   {name} {tuple(a.shape)}: rel err vs f32 kernel "
              f"{k32:.3e} plain {p32:.3e} (limit {2 * p32 + 5e-2:.3e}); "
              f"cosine vs f32 kernel {kc:.6f} plain {pc:.6f} (limit "
              f"{pc / 2:.6f}); kernel vs plain {cosine(a, b):.6f}")
        if not (torch.isfinite(a).all() and k32 <= 2 * p32 + 5e-2
                and kc >= pc / 2):
            raise AssertionError(f"{name} gradient: kernel leg "
                                 f"{k32:.3e} from f32 at cosine {kc:.6f}, "
                                 f"plain {p32:.3e} at {pc:.6f}")


def phase_training(dev):
    """The port's Trainer on full-width stablelm-1.6b: MetaTT 4d on q/v
    from rank 10, AdamW lr 1e-3, remat per block, LMStream batches of
    4 x 1024 tokens, 6 steps of 3 per epoch with one DMRG sweep to rank 8
    after epoch 1 (step 3). Kernel launches counted around ``train``."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.core.dmrg import RankSchedule
    from repro_torch.data import LMStream
    from repro_torch.train import Trainer

    cfg = configs.get_config("stablelm-1.6b")
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant="4d",
                    adapter_rank=10, optimizer=OptimizerConfig(lr=1e-3),
                    train=TrainConfig(remat="block", seed=SEED))
    batch, seq, steps = 4, 1024, 6
    data = LMStream(vocab_size=cfg.vocab_size, seq_len=seq, batch=batch,
                    seed=0, branching=2)
    t0 = time.perf_counter()
    tr = Trainer(run=run, data=data, total_steps=steps, steps_per_epoch=3,
                 rank_schedule=RankSchedule.linear(10, 8, start_epoch=1,
                                                   every=1, step=2),
                 device=dev,
                 on_metrics=lambda s, m: print(
                     f"[train] step {s} loss {m['loss']:.6f} grad_norm "
                     f"{m['grad_norm']:.4e} lr {m['lr']:.3e} "
                     f"{1e3 * m['step_time_s']:.1f} ms", flush=True))
    torch.cuda.synchronize()
    print(f"[train] stablelm-1.6b MetaTT 4d q/v rank "
          f"{ttlib.ranks(tr.state.adapter['cores'])}, remat per block, "
          f"B={batch} T={seq}: init {time.perf_counter() - t0:.1f}s",
          flush=True)
    before = [c.clone() for c in tr.state.adapter["cores"]]
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    tr.train()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    ranks = ttlib.ranks(tr.state.adapter["cores"])
    if ranks != (8, 8, 8) or tr._dmrg_applied != [1]:
        raise AssertionError(f"ranks after the sweep {ranks}, sweeps at "
                             f"epochs {tr._dmrg_applied}")
    # the first core starts at zero (ΔW = 0): the adapter's norm says
    # whether training moved it
    norms = [float(ttlib.tt_norm(c)) for c in (before,
                                               tr.state.adapter["cores"])]
    if not (norms[0] == 0.0 and norms[1] > 0.0):
        raise AssertionError(f"the adapter did not move: ||ΔW|| {norms}")
    # a step, per layer: K1 on q and v forward, again in the remat
    # recompute and as dx in the backward (6), less the two dx of layer 0,
    # whose input needs no gradient; #5 forward and recompute; #6, #7 once
    per_step = {"tt_linear": 6 * cfg.num_layers - 2,
                "flash_attention_fwd": 2 * cfg.num_layers,
                "flash_attention_bwd_dq": cfg.num_layers,
                "flash_attention_bwd_dkv": cfg.num_layers}
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps, not {n} a step")
    step_ms = [round(1e3 * m["step_time_s"], 1) for _, m in tr.history[1:]]
    med = float(np.median(step_ms))
    # phase 7 resumes this run from a checkpoint and compares its cores
    final_cores = [c.clone() for c in tr.state.adapter["cores"]]
    print(f"[train] launches during train ({steps} steps): "
          f"{json.dumps(launches)}")
    print(f"[train] losses {[round(float(x), 6) for x in losses]}; median "
          f"step {med:.1f} ms after step 1 (steps {step_ms}); "
          f"{batch * seq / (med / 1e3):.1f} tokens/s; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; ranks "
          f"{ranks}; ||ΔW|| {norms[0]:.3e} -> {norms[1]:.3e}", flush=True)
    # one more step (past total_steps: lr 0) under the profiler
    device_share("one training step", lambda: tr.train(steps + 1), top_n=12,
                 show=("flash_bwd", "flash_fwd", "tt_linear"))
    tokens = torch.as_tensor(next(data)["tokens"][:1], device=dev)
    grad_check(cfg, tr.spec, tr.base, torch.Generator(
        device=dev).manual_seed(SEED + 2), tokens, dev)
    return launches, final_cores


ADAPTER_KINDS = (("lora", "4d", 8), ("vera", "4d", 1024),
                 ("lotr", "4d", 64), ("metatt", "5d", 8))


def delta_norm(spec, adapter, frozen):
    """||α·A·B|| of layer 0's adapted q projection, folded to lora form:
    0 at every kind's init."""
    from repro_torch.peft import api as peft_api
    bc, pl = peft_api.adapter_factors(spec, adapter, frozen)
    a, b, alpha = peft_api.lora_form_factors(
        spec, bc, {k: v[0] for k, v in pl.items()}, "attn_q")
    return float((alpha * (a.float() @ b.float())).norm())


def train_adapters(dev, count):
    """Phase 7 (a): each adapter kind trained 3 steps through the Trainer
    on full-width stablelm-1.6b, one base shared by all (q/v, AdamW lr
    1e-3, remat per block, 4 x 1024 tokens a step). ``count(fn)`` runs
    ``fn`` between a reset and a read of the launch counters and adds them
    to the path's."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.data import LMStream
    from repro_torch.kernels import tt_linear as tl
    from repro_torch.peft import api as peft_api
    from repro_torch.train import Trainer

    cfg = configs.get_config("stablelm-1.6b")
    batch, seq, steps = 4, 1024, 3
    per_step = {"tt_linear": 6 * cfg.num_layers - 2,
                "flash_attention_fwd": 2 * cfg.num_layers,
                "flash_attention_bwd_dq": cfg.num_layers,
                "flash_attention_bwd_dkv": cfg.num_layers}
    base = None
    trained = {}
    for kind, variant, rank in ADAPTER_KINDS:
        label = f"{kind}-{variant}" if kind == "metatt" else kind
        run = RunConfig(model=cfg, adapter_kind=kind, adapter_variant=variant,
                        adapter_rank=rank, optimizer=OptimizerConfig(lr=1e-3),
                        train=TrainConfig(remat="block", seed=SEED))
        t0 = time.perf_counter()
        tr = Trainer(run=run, data=LMStream(
            vocab_size=cfg.vocab_size, seq_len=seq, batch=batch, seed=0,
            branching=2), total_steps=steps, device=dev)
        if base is None:
            base = tr.base
        tr.base = base
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        d0 = delta_norm(tr.spec, tr.state.adapter, tr.frozen)
        bc, pl = peft_api.adapter_factors(tr.spec, tr.state.adapter,
                                          tr.frozen)
        fa, fb, _ = peft_api.lora_form_factors(
            tr.spec, bc, {k: v[0] for k, v in pl.items()}, "attn_q")
        torch.cuda.reset_peak_memory_stats(dev)
        launches = count(tr.train)
        losses = tr.losses()
        d1 = delta_norm(tr.spec, tr.state.adapter, tr.frozen)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if not (d0 == 0.0 and d1 > 0.0):
            raise AssertionError(f"{label}: the adapter did not move from "
                                 f"ΔW = 0: ||ΔW|| {d0} -> {d1}")
        for name, n in per_step.items():
            if launches[name] != n * steps:
                raise AssertionError(f"{label}: {name} {launches[name]} "
                                     f"launches in {steps} steps, not {n} "
                                     "a step")
        step_ms = [1e3 * m["step_time_s"] for _, m in tr.history]
        print(f"[adapters] {label} r={rank}: {peft_api.count_trainable(tr.spec, tr.state.adapter)} "
              f"trainable; init {init_s:.1f}s; K1 ran {tl.k1_variant(rank)} "
              f"on the folded A {tuple(fa.shape)} strides {fa.stride()} and "
              f"B strides {fb.stride()}; losses "
              f"{[round(float(x), 6) for x in losses]}; ||ΔW|| layer 0 q "
              f"{d0:.3e} -> {d1:.3e}; median step "
              f"{float(np.median(step_ms)):.1f} ms (steps "
              f"{[round(x, 1) for x in step_ms]}); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; "
              f"launches {json.dumps({k: launches[k] for k in per_step})}",
              flush=True)
        trained[kind] = tr
    # gradient checks at B = 1: VeRA at Table 1's rank 1024 and LoRA, each
    # under a mild adapter off its zero init
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    tokens = torch.as_tensor(next(LMStream(
        vocab_size=cfg.vocab_size, seq_len=seq, batch=1, seed=3,
        branching=2))["tokens"], device=dev)
    for kind in ("vera", "lora"):
        tr = trained[kind]
        ad = {k: v.clone() for k, v in tr.state.adapter.items()}
        if kind == "vera":
            ad["d"] += 0.05 * torch.randn(ad["d"].shape, generator=gen,
                                          device=dev)
            ad["g"] = 0.1 * torch.randn(ad["g"].shape, generator=gen,
                                        device=dev)
        else:
            ad["b"] = 0.01 * torch.randn(ad["b"].shape, generator=gen,
                                         device=dev)
        grad_check(cfg, tr.spec, base, gen, tokens, dev, adapter=ad,
                   frozen=tr.frozen, tag=f"adapters {kind}")
    del trained
    return base


def resume_on_the_card(dev, base, uninterrupted, count):
    """Phase 7 (b): phase 6's MetaTT 4d setting (rank 10 -> 8 at epoch 1,
    3 steps an epoch, 6 steps) with checkpoints every 3 steps and a
    failure at step 5, then a new Trainer on the same directory resumes
    and finishes; its cores are held against phase 6's uninterrupted run
    within 1e-3 relative Frobenius."""
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.core.dmrg import RankSchedule
    from repro_torch.data import LMStream
    from repro_torch.distributed import FailureInjector, SimulatedFailure
    from repro_torch.train import Trainer

    cfg = configs.get_config("stablelm-1.6b")
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant="4d",
                    adapter_rank=10, optimizer=OptimizerConfig(lr=1e-3),
                    train=TrainConfig(remat="block", seed=SEED, ckpt_dir=d,
                                      ckpt_every=3))
    saves = []

    def trainer(**kw):
        tr = Trainer(run=run, data=LMStream(
            vocab_size=cfg.vocab_size, seq_len=1024, batch=4, seed=0,
            branching=2), total_steps=6, steps_per_epoch=3,
            rank_schedule=RankSchedule.linear(10, 8, start_epoch=1, every=1,
                                              step=2), device=dev, **kw)
        tr.base = base   # phase 6's base: the same seed drew it
        save = tr.ckpt.save

        def timed(*a, **k):
            t0 = time.perf_counter()
            save(*a, **k)
            saves.append(time.perf_counter() - t0)
        tr.ckpt.save = timed
        return tr
    try:
        a = trainer(failure_injector=FailureInjector(fail_at_step=5))
        failed = []

        def run_a():
            try:
                a.train()
            except SimulatedFailure as e:
                failed.append(str(e))
        launches = count(run_a)
        if not failed:
            raise AssertionError("the injected failure at step 5 did not "
                                 "happen")
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d) if f.startswith("ckpt_00000003"))
        b = trainer()
        ranks = ttlib.ranks(b.state.adapter["cores"])
        if not (b.state.step == 3 and ranks == (8, 8, 8)
                and b._dmrg_applied == [1]):
            raise AssertionError(f"resumed at step {b.state.step}, ranks "
                                 f"{ranks}, sweeps {b._dmrg_applied}")
        more = count(b.train)
        for k, v in more.items():
            launches[k] += v
        if b.state.step != 6:
            raise AssertionError(f"the resumed run ended at {b.state.step}")
        rels = [rel_fro(x, y) for x, y in zip(b.state.adapter["cores"],
                                              uninterrupted)]
        exact = all(torch.equal(x, y) for x, y in zip(
            b.state.adapter["cores"], uninterrupted))
        print(f"[adapters] resume: failed at step 5 ({failed[0]}); resumed "
              f"at step 3 with ranks {ranks}, sweeps {b._dmrg_applied}; "
              f"finished at step {b.state.step}; cores vs the uninterrupted "
              f"run (phase 6) rel Frobenius "
              f"{[f'{x:.3e}' for x in rels]} (limit 1e-3), bit-identical "
              f"{exact}; checkpoint at step 3 {nbytes} bytes; save seconds "
              f"{[round(x, 3) for x in saves]}; resumed losses "
              f"{[round(float(x), 6) for x in b.losses()]}", flush=True)
        if not max(rels) <= 1e-3:
            raise AssertionError(f"resumed cores differ from the "
                                 f"uninterrupted run: {rels}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


#: the depth of phase 8 (a) and (e): stablelm-1.6b at 12 of its 24
#: layers, widths kept (at 24 phase 8 took 75 s of a 907 s script on an
#: H100 80GB HBM3 at 700 W once phases 20-21 came)
PHASE8_LAYERS = 12


def serve_runtimes(dev, dense_run, paged_run, count):
    """Phase 7 (c): phase 3's served 4+1d adapter through the live, lora
    and merged (task 1) runtimes of the dense engine on the same weights,
    then the paged engine under the lora runtime over phase 4's requests.
    Returns the base and the live runtime for (d)."""
    import torch
    from repro_torch.config.base import ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.serving import AdapterRuntime, Engine, Request

    cfg, spec, params, live, gen = serving_model(dev, "adapters")
    t0 = time.perf_counter()
    rts = {"live": live,
           "lora": AdapterRuntime.build("lora", params["base"], spec,
                                        params["adapter"], params["frozen"]),
           "merged": AdapterRuntime.build(
               "merged", params["base"], spec, params["adapter"],
               params["frozen"], model_cfg=cfg, task=1)}
    torch.cuda.synchronize()
    print(f"[adapters] lora and merged runtimes built in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32)
    reqs = dense_run["reqs"]
    reqs1 = [Request(r.prompt, 32, task=1) for r in reqs]
    L = cfg.num_layers
    outs = {}
    # phase 3's mixed-task requests, and the same prompts all on task 1
    # (the merged engine serves only the task folded into its weights)
    runs = {"live": (("live", reqs), ("live task 1", reqs1)),
            "lora": (("lora", reqs),), "merged": (("merged task 1", reqs1),)}
    for mode, jobs in runs.items():
        eng = Engine(cfg, rts[mode], serve=serve, device=dev)
        eng.generate(jobs[0][1][:2])                  # warm-up
        torch.cuda.synchronize()
        for label, rq in jobs:
            n = count(lambda: outs.update(
                {label: [o.tolist() for o in eng.generate(rq)]}))
            st = eng.last_stats
            want = {"flash_attention": L * st.prefills,
                    "decode_attention": L * st.decode_steps,
                    "tt_linear": 0 if mode == "merged" else 2 * L * st.prefills,
                    "tt_linear_batched_a": (0 if mode == "merged"
                                            else 2 * L * st.decode_steps)}
            for name, w in want.items():
                if n[name] != w:
                    raise AssertionError(f"{label}: {name} launched "
                                         f"{n[name]} times, want {w}")
            for res in eng.last_results:
                if res.status != "FINISHED" or res.n_generated != 32:
                    raise AssertionError(f"{label}: a request ended "
                                         f"{res.status}")
            print(f"[adapters] dense {label}: {st.tokens_generated} tokens "
                  f"in {st.wall_s:.3f}s = {st.tokens_per_s:.1f} tok/s; "
                  f"prefill {1e3 * st.prefill_s / max(st.prefills, 1):.2f} "
                  f"ms/request; decode "
                  f"{1e3 * st.decode_s / max(st.decode_steps, 1):.2f} "
                  f"ms/step over {st.decode_steps} steps; launches "
                  f"{json.dumps({k: n[k] for k in want})}", flush=True)
        if mode == "merged":
            try:
                eng.generate([Request(reqs[0].prompt, 4, task=0)])
            except ValueError as e:
                print(f"[adapters] merged engine rejects a task-0 request: "
                      f"{e}")
            else:
                raise AssertionError("the merged (task 1) engine served a "
                                     "task-0 request")
        del eng
        torch.cuda.empty_cache()
    for label, ref in (("lora", "live"), ("merged task 1", "live task 1")):
        same = sum(int(x == y) for o, r in zip(outs[label], outs[ref])
                   for x, y in zip(o, r))
        total = sum(len(o) for o in outs[ref])
        print(f"[adapters] served adapter: {label} greedy tokens equal to "
              f"live's at {same}/{total} (reported: bf16 argmax near-ties "
              "flip)", flush=True)
    # logits under a mild adapter: lora and merged against live
    mild = {"cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                     device=dev)}
    mrt = {m: AdapterRuntime.build(m, params["base"], spec, mild,
                                   params["frozen"], model_cfg=cfg, task=1)
           for m in ("live", "lora", "merged")}
    meng = {m: Engine(cfg, rt, serve=serve, device=dev)
            for m, rt in mrt.items()}
    for m, req in (("lora", reqs[0]), ("merged", reqs1[0])):
        rel = logits_rel_err(meng[m], meng["live"], req)
        print(f"[adapters] mild adapter: {m} prefill logits (task "
              f"{req.task}) vs live max rel err {rel:.3e} (limit 5e-2)")
        if not rel <= 5e-2:
            raise AssertionError(f"{m} runtime logits differ from live: "
                                 f"{rel:.3e}")
    del meng, mrt
    torch.cuda.empty_cache()
    # the paged engine under the lora runtime, phase 4's requests (cold)
    peng = Engine(cfg, rts["lora"], serve=ServeConfig(cache_mode="paged",
                                                      **PAGED), device=dev)
    res = {}

    def paged_gen():
        res["st"] = serve_checked(peng, paged_run["reqs"], "paged lora "
                                  "runtime, cold", "adapters")[1]
    n = count(paged_gen)
    steps = res["st"].decode_steps
    if not n["paged_decode_attention"] == L * steps > 0:
        raise AssertionError(f"paged lora: #8 launched "
                             f"{n['paged_decode_attention']} times in "
                             f"{steps} steps")
    del peng, rts
    torch.cuda.empty_cache()
    return cfg, params["base"], live


def snapshot_roundtrip(dev, cfg, live, reqs, count):
    """Phase 7 (d): phase 5's dense engine with int8 weights saves its
    base; a second engine, its base zeroed, loads the snapshot and must
    give the first engine's greedy tokens on phase 3's 8 requests."""
    import shutil
    import tempfile
    import torch
    from repro_torch.config.base import KernelConfig, QuantConfig, \
        ServeConfig
    from repro_torch.models import model as M
    from repro_torch.serving import Engine

    def engine():
        return Engine(cfg, live, serve=ServeConfig(
            cache_mode="dense", max_batch=4, cache_len=256, out_cap=32),
            kernels=KernelConfig(quant=QuantConfig(weights="int8")),
            device=dev)
    d = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        e1 = engine()
        got = {}
        n = count(lambda: got.update(one=[o.tolist() for o in
                                          e1.generate(reqs)]))
        t0 = time.perf_counter()
        path = e1.save_base_snapshot(os.path.join(d, "w8_base"))
        save_s = time.perf_counter() - t0
        del e1
        torch.cuda.empty_cache()
        e2 = engine()
        for t in M.tensors(e2.base_weights):
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e2.load_base_snapshot(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        int8 = sum(t.numel() for t in M.tensors(e2.base_weights)
                   if t.dtype == torch.int8)
        more = count(lambda: got.update(two=[o.tolist() for o in
                                             e2.generate(reqs)]))
        for k, v in more.items():
            n[k] += v
        print(f"[adapters] int8 base snapshot: {os.path.getsize(path)} "
              f"bytes ({int8} int8 values), save {save_s:.2f}s, load "
              f"{load_s:.2f}s; greedy tokens of the loaded engine equal to "
              f"the saving engine's: {got['two'] == got['one']}; launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
        if got["two"] != got["one"]:
            raise AssertionError("the snapshot engine's tokens differ")
        if not (n["tt_linear_w8"] > 0 and n["tt_linear_batched_a_w8"] > 0):
            raise AssertionError(f"#9 / #10 did not run: {n}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return n


def phase_adapters(dev, dense_run, paged_run, train_cores):
    """Phase 7, adapters and checkpoints, on full-width stablelm-1.6b:
    (a) LoRA, VeRA (r = 1024), LoTR and MetaTT-5d trained through the
    Trainer, with gradient checks for VeRA and LoRA; (b) checkpoint and
    resume against phase 6's uninterrupted run; (c) the live, lora and
    merged serving runtimes, dense and (lora) paged; (d) an int8 base
    snapshot. Launches are counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        return n
    t0 = time.perf_counter()
    base = train_adapters(dev, count)
    t1 = time.perf_counter()
    resume_on_the_card(dev, base, train_cores, count)
    del base
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    cfg, _, live = serve_runtimes(dev, dense_run, paged_run, count)
    t3 = time.perf_counter()
    snapshot_roundtrip(dev, cfg, live, dense_run["reqs"], count)
    del live
    torch.cuda.empty_cache()
    print(f"[adapters] phase seconds: training {t1 - t0:.1f}, resume "
          f"{t2 - t1:.1f}, runtimes {t3 - t2:.1f}, snapshot "
          f"{time.perf_counter() - t3:.1f}; launches on the path "
          f"{json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    return total


def teacher_forced_gap(cfg, spec, rt, base, reqs, outs, dev):
    """The largest gap, over every generated token, between the plain
    leg's best logit and the chosen token's, over the largest |logit|: the
    plain versions' forward (over ``base``: an int8 engine's packed one)
    on [prompt, tokens], teacher-forced."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs):
            toks = [int(t) for t in toks]
            seq = torch.as_tensor([*req.prompt, *toks], device=dev)[None]
            lg = T.forward(base, cfg, spec, rt.broadcast, rt.per_layer, seq,
                           task=req.task if rt.tasked else None,
                           policy=dispatch.REF, device=dev).logits[0].float()
            lg = lg[len(req.prompt) - 1:-1]
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    return worst


def q_ratio(cfg, rt, gen):
    """||α·(x·A)·B|| / ||x·W|| of the first attention layer's q
    projection (an xLSTM model's first mLSTM q projection; task 0) on a
    unit-normal x, for any adapter kind: how strong it is against the
    frozen base. An enc-dec model's layer 0 is its encoder's first."""
    import torch
    from repro_torch.peft import api as peft_api
    mixers = [m for m, _ in cfg.block_pattern]
    mixer = "attn" if "attn" in mixers else "mlstm"
    p = mixers.index(mixer)
    x = torch.randn((16, cfg.d_model), generator=gen, device=gen.device)
    a, b, alpha = peft_api.lora_form_factors(
        rt.spec, rt.broadcast, {k: v[p] for k, v in rt.per_layer.items()},
        f"{mixer}_q", task=0 if rt.tasked else None)
    w = x @ rt.base["blocks"][p]["mixer"]["wq"][0].float()
    return float((alpha * (x @ a.float()) @ b.float()).norm() / w.norm())


def w8_high_rank_serving(dev, reqs, count):
    """Phase 8 (a), at ``PHASE8_LAYERS`` layers: the dense 4-slot x
    256-cell cell over an int8 base
    (``QuantConfig(weights="int8")``) with VeRA at Table 1's rank 1024
    (#9 above rank 64 at prefill and decode) and a 4+1d MetaTT adapter at
    rank 384 (#10 above rank 64 at decode), each scaled to a mild adapter
    (ratio 0.1 to the base projection). Every token within 5% of the
    largest logit of the plain leg's teacher-forced maximum."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import QuantConfig, RunConfig, ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.peft import api as peft_api
    from repro_torch.serving import AdapterRuntime, Engine

    cfg = dataclasses.replace(configs.get_config("stablelm-1.6b"),
                              num_layers=PHASE8_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    base = T.init_base_params(cfg, gen, device=dev)
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32, quant=QuantConfig(weights="int8"))
    for kind, variant, rank, want in (
            ("vera", "4d", 1024, ("tt_linear_w8",)),
            ("metatt", "4+1d", 384, ("tt_linear_w8",
                                     "tt_linear_batched_a_w8"))):
        spec = M.build_adapter_spec(RunConfig(
            model=cfg, adapter_kind=kind, adapter_variant=variant,
            num_tasks=3 if variant == "4+1d" else 0, adapter_rank=rank))
        adapter, frozen = peft_api.init_adapter(spec, gen, device=dev)
        if kind == "vera":
            adapter["g"] = torch.randn(adapter["g"].shape, generator=gen,
                                       device=dev)
        else:
            adapter = {"cores": ttlib.random_tt(
                gen, spec.cfg.mode_sizes, rank, scale=0.05, device=dev)}
        rt = AdapterRuntime.build("live", base, spec, adapter, frozen)
        ratio = q_ratio(cfg, rt, gen)
        # ΔW is linear in g (VeRA) and in G4 (MetaTT): scale it to 0.1
        if kind == "vera":
            adapter["g"] *= 0.1 / ratio
        else:
            adapter["cores"][-1] *= 0.1 / ratio
        rt = AdapterRuntime.build("live", base, spec, adapter, frozen)
        eng = Engine(cfg, rt, serve=serve, device=dev)
        my_reqs = [r if rt.tasked else dataclasses.replace(r, task=0)
                   for r in reqs]
        eng.generate(my_reqs[:1])
        outs = []
        n = count(lambda: outs.extend(eng.generate(my_reqs)))
        st = eng.last_stats
        for res in eng.last_results:
            if res.status != "FINISHED" or res.n_generated != 32:
                raise AssertionError(f"{kind} r={rank} w8: request ended "
                                     f"{res.status}")
        for name in want:
            if not n[name] > 0:
                raise AssertionError(f"{kind} r={rank} w8: {name} never "
                                     f"launched: {n}")
        gap = teacher_forced_gap(cfg, spec, rt, eng.base_weights, my_reqs,
                                 outs, dev)
        print(f"[phase8] (a) w8 dense {kind} r={rank}: q ratio "
              f"{q_ratio(cfg, rt, gen):.3e}; {st.tokens_generated} tokens, "
              f"{st.tokens_per_s:.1f} tok/s, decode "
              f"{1e3 * st.decode_s / max(st.decode_steps, 1):.2f} ms/step; "
              f"launches {json.dumps({k: v for k, v in n.items() if v})}; "
              f"largest teacher-forced gap {gap:.3e} (limit 5e-2)",
              flush=True)
        if not gap <= 5e-2:
            raise AssertionError(f"{kind} r={rank} w8: a token {gap:.3e} "
                                 "below the plain leg's best logit")
        del eng, rt


def full_ft_on_the_card(dev, count):
    """Phase 8 (b): two full fine-tuning steps (``make_full_ft_step``) of
    full-width stablelm-1.6b on 4 x 1024 tokens, remat per block: finite
    losses, the base moved, #5 / #6 / #7 launched; the first step's loss
    and gradient norm against the plain versions' step
    (``KernelConfig(backend="ref")``) on the same weights and batch."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import KernelConfig, OptimizerConfig, \
        TrainConfig
    from repro_torch.data import LMStream
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import make_full_ft_step
    from repro_torch.tree import tree_map

    cfg = configs.get_config("stablelm-1.6b")
    data = LMStream(vocab_size=cfg.vocab_size, seq_len=1024, batch=4,
                    seed=1, branching=2)
    batches = [{"tokens": torch.as_tensor(next(data)["tokens"], device=dev)}
               for _ in range(2)]
    base = T.init_base_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 12), device=dev)
    # lr 1e-3: Adam's first step moves a weight by about lr, above the
    # bf16 spacing of the base's weights (≈ 1.2e-4 at their 0.022 scale)
    opt_cfg = OptimizerConfig(lr=1e-3, schedule="constant")
    tcfg = TrainConfig(remat="block")
    # the plain versions' first step on a copy of the same weights
    ref_step = make_full_ft_step(cfg, opt_cfg, tcfg, 2,
                                 kernels=KernelConfig(backend="ref"),
                                 device=dev)
    copy = tree_map(torch.clone, base)
    _, _, mref = ref_step(copy, adamw.init_state(copy), batches[0])
    ref = {k: float(mref[k]) for k in ("loss", "grad_norm")}
    del copy, mref
    torch.cuda.empty_cache()
    step = make_full_ft_step(cfg, opt_cfg, tcfg, 2, device=dev)
    before = base["blocks"][0]["mixer"]["wq"].clone()
    opt = adamw.init_state(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics, times = [], []

    def run():
        nonlocal base, opt
        for b in batches:
            t0 = time.perf_counter()
            base, opt, m = step(base, opt, b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            times.append(time.perf_counter() - t0)
    n = count(run)
    moved = float((base["blocks"][0]["mixer"]["wq"].float()
                   - before.float()).abs().max())
    rel_loss = abs(metrics[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    rel_gn = abs(metrics[0]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    print(f"[phase8] (b) full fine-tuning, 2 steps of 4 x 1024 tokens: "
          f"losses {[round(m['loss'], 6) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in metrics]}; step times "
          f"{[round(1e3 * t, 1) for t in times]} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; base moved "
          f"{moved:.3e}; vs the plain step: loss {rel_loss:.3e} (limit "
          f"1e-2), grad norm {rel_gn:.3e} (limit 5e-2); launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
    if not all(np.isfinite([m["loss"] for m in metrics])):
        raise AssertionError(f"full FT: non-finite loss {metrics}")
    if not moved > 0:
        raise AssertionError("full FT: the base did not move")
    if not (rel_loss <= 1e-2 and rel_gn <= 5e-2):
        raise AssertionError(f"full FT vs the plain step: loss {rel_loss:.3e}"
                             f", grad norm {rel_gn:.3e}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if not n[name] > 0:
            raise AssertionError(f"full FT: {name} never launched: {n}")
    if n["tt_linear"]:
        raise AssertionError(f"full FT ran K1 with no adapter: {n}")
    del base, opt
    torch.cuda.empty_cache()


def two_site_on_the_card(dev, train_cores, count):
    """Phase 8 (c): one two-site DMRG sweep (local loss optimization) of
    phase 6's trained 4d adapter to rank 6, its loss_fn the model loss on
    1 x 1024 tokens: 2·(d−1)·inner gradient calls through the training
    kernels."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import RunConfig
    from repro_torch.core import dmrg
    from repro_torch.core import tt as ttlib
    from repro_torch.data import LMStream
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = configs.get_config("stablelm-1.6b")
    spec = M.build_adapter_spec(RunConfig(model=cfg, adapter_kind="metatt",
                                          adapter_variant="4d",
                                          adapter_rank=8))
    base = T.init_base_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    tokens = torch.as_tensor(next(LMStream(
        vocab_size=cfg.vocab_size, seq_len=1024, batch=1, seed=5,
        branching=2))["tokens"], device=dev)
    batch = {"tokens": tokens,
             "mask": torch.ones_like(tokens, dtype=torch.float32)}
    calls = {"n": 0}

    def loss_fn(params):
        calls["n"] += 1
        return M.loss_fn(params, base, {}, batch, cfg, spec, remat=True,
                         device=dev)[0]

    def loss(cores):
        with torch.no_grad():
            return float(M.loss_fn({"cores": cores}, base, {}, batch, cfg,
                                   spec, device=dev)[0])
    cores = [c.detach().clone() for c in train_cores]
    inner, out = 2, {}
    t0 = time.perf_counter()
    n = count(lambda: out.update(res=dmrg.two_site_sweep(
        {"cores": cores}, loss_fn, target_rank=6, inner_steps=inner)))
    sweep_s = time.perf_counter() - t0
    res = out["res"]
    before, after = loss(cores), loss(res.params["cores"])
    print(f"[phase8] (c) two-site sweep of the 4d adapter: ranks "
          f"{ttlib.ranks(cores)} -> {res.ranks}; loss on 1 x 1024 tokens "
          f"{before:.6f} -> {after:.6f}; {calls['n']} gradient calls in "
          f"{sweep_s:.1f} s; launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
    if calls["n"] != 2 * (len(cores) - 1) * inner or res.ranks != (6, 6, 6):
        raise AssertionError(f"two-site sweep: {calls['n']} gradient "
                             f"calls, ranks {res.ranks}")
    if not (np.isfinite(after) and all(
            bool(torch.isfinite(c).all()) for c in res.params["cores"])):
        raise AssertionError(f"two-site sweep: non-finite result {after}")
    if not (n["tt_linear"] > 0 and n["flash_attention_bwd_dq"] > 0):
        raise AssertionError(f"two-site sweep missed the kernels: {n}")
    del base
    torch.cuda.empty_cache()


def compressed_training(dev, count):
    """Phase 8 (d): three Trainer steps of the 4d MetaTT adapter on
    full-width stablelm-1.6b (4 x 1024 tokens, remat per block) with int8
    and with top-k gradient compression: finite losses, the adapter
    moved, the top-k residual carried."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.data import LMStream
    from repro_torch.train import Trainer

    cfg = configs.get_config("stablelm-1.6b")
    base = None
    for kind in ("int8", "topk"):
        run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant="4d",
                        adapter_rank=8, optimizer=OptimizerConfig(lr=1e-3),
                        train=TrainConfig(remat="block", seed=SEED,
                                          grad_compression=kind))
        tr = Trainer(run=run, data=LMStream(
            vocab_size=cfg.vocab_size, seq_len=1024, batch=4, seed=0,
            branching=2), total_steps=3, device=dev)
        base = tr.base if base is None else base
        tr.base = base
        n = count(tr.train)
        losses = tr.losses()
        norm = float(ttlib.tt_norm(tr.state.adapter["cores"]))
        res = tr.state.residual
        rnorm = (0.0 if res is None else
                 float(sum(r.float().norm() ** 2 for r in res["cores"])) ** 0.5)
        step_ms = [round(1e3 * m["step_time_s"], 1) for _, m in tr.history]
        print(f"[phase8] (d) {kind} gradient compression, 3 Trainer steps: "
              f"losses {[round(float(x), 6) for x in losses]}; step times "
              f"{step_ms} ms; ||ΔW|| {norm:.3e}; residual norm {rnorm:.3e}; "
              f"launches {json.dumps({k: v for k, v in n.items() if v})}",
              flush=True)
        if not (np.isfinite(losses).all() and norm > 0):
            raise AssertionError(f"{kind} compression: losses {losses}, "
                                 f"||ΔW|| {norm}")
        if (kind == "topk") != (res is not None and rnorm > 0):
            raise AssertionError(f"{kind} compression: residual {rnorm}")
        del tr
    del base
    torch.cuda.empty_cache()


SPEC = dict(spec_k=3, draft_rank=4, draft_layer_stride=2)


def decaying_tt(gen, mode_sizes, rank, scale, decay, dev):
    """Random TT whose bond strength decays geometrically (bond column j
    scaled by decay**j): the spectrum DMRG leaves on a trained adapter,
    where a rank-truncated drafter tracks the target."""
    import torch
    from repro_torch.core import tt as ttlib
    cores = ttlib.random_tt(gen, mode_sizes, rank, scale=scale, device=dev)
    w = decay ** torch.arange(rank, device=dev, dtype=torch.float32)
    out = [cores[0] * w[None, None, :]]
    for c in cores[1:]:
        out.append(c * w[:c.shape[0], None, None])
    return out


def spec_serving(dev, dense_run, paged_run, count):
    """Phase 8 (e): speculative decode, ``SpecConfig(spec_k=3,
    draft_rank=4, draft_layer_stride=2)``, on full-width stablelm-1.6b at
    ``PHASE8_LAYERS`` layers with a decaying-bond-spectrum 4+1d adapter
    (rank 8, decay 0.35, scaled to a mild 0.1 of the base q projection: at the served
    strength bf16 decoding is chaotic, the plain leg as far from f32 as
    the kernel leg) and the blocks' wo / wd damped by 0.05 (each block a
    small residual update, as in a trained network, so the layer-strided
    drafter tracks the target): the dense cell (phase 3's 8 requests) and
    the paged cell (phase 4's 16 requests, fp cold, then int8 KV once),
    each against the same engine without speculation in the same call.
    Every token within 5% of the largest logit of the plain leg's
    teacher-forced maximum (the non-spec engine's gap printed beside);
    paged: no leaked block; K4 once per verified column (dense), #8 /
    #8q on the verifier."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import QuantConfig, RunConfig, \
        ServeConfig, SpecConfig
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import AdapterRuntime, Engine

    cfg = dataclasses.replace(configs.get_config("stablelm-1.6b"),
                              num_layers=PHASE8_LAYERS)
    spec = M.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=8))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    base = T.init_base_params(cfg, gen, device=dev)
    for blk in base["blocks"]:
        blk["mixer"]["wo"].mul_(0.05)
        blk["ffn"]["wd"].mul_(0.05)
    cores = decaying_tt(gen, spec.cfg.mode_sizes, 8, 0.5, 0.35, dev)
    rt = AdapterRuntime.build("live", base, spec, {"cores": cores}, {})
    cores[-1] *= 0.1 / q_ratio(cfg, rt, gen)      # ΔW is linear in G4
    rt = AdapterRuntime.build("live", base, spec, {"cores": cores}, {})
    nb_draft = -(-cfg.num_super_blocks // SPEC["draft_layer_stride"])
    k = SPEC["spec_k"]
    cells = (("dense", dict(cache_mode="dense", max_batch=4, cache_len=256,
                            out_cap=32), dense_run["reqs"], QuantConfig()),
             ("paged fp", dict(cache_mode="paged", **PAGED),
              paged_run["reqs"], QuantConfig()),
             ("paged int8 KV", dict(cache_mode="paged", **PAGED),
              paged_run["reqs"], QuantConfig(kv="int8")))
    for label, sv, reqs, quant in cells:
        res = {}
        for leg in ("base", "spec"):
            serve = ServeConfig(quant=quant, spec=SpecConfig(**SPEC)
                                if leg == "spec" else SpecConfig(), **sv)
            eng = Engine(cfg, rt, serve=serve, device=dev)
            outs = []
            n = count(lambda: outs.extend(eng.generate(reqs)))
            st = eng.last_stats
            for r_ in eng.last_results:
                if r_.status != "FINISHED" or r_.n_generated != 32:
                    raise AssertionError(f"spec {label} {leg}: request "
                                         f"ended {r_.status}")
            if eng.paged and eng.leaked_blocks():
                raise AssertionError(f"spec {label} {leg}: "
                                     f"{eng.leaked_blocks()} blocks leaked")
            res[leg] = (outs, st, n)
            del eng
        (b_out, b_st, _), (s_out, s_st, n) = res["base"], res["spec"]
        gap, b_gap = (teacher_forced_gap(cfg, spec, rt, base, reqs, o, dev)
                      for o in (s_out, b_out))
        same = sum(int(x == y) for o, r in zip(s_out, b_out)
                   for x, y in zip(o.tolist(), r.tolist()))
        print(f"[phase8] (e) spec {label}: acceptance "
              f"{s_st.acceptance_rate:.3f} ({s_st.accepted_tokens}/"
              f"{s_st.draft_tokens}), tokens/step "
              f"{s_st.tokens_per_step:.3f} over {s_st.spec_steps} steps; "
              f"{s_st.tokens_per_s:.1f} tok/s against "
              f"{b_st.tokens_per_s:.1f} without spec "
              f"({s_st.tokens_per_s / b_st.tokens_per_s:.3f}x); decode "
              f"{1e3 * s_st.decode_s / max(s_st.decode_steps, 1):.2f} "
              f"ms/step against {1e3 * b_st.decode_s / max(b_st.decode_steps, 1):.2f}; "
              f"kv_bytes_peak {s_st.kv_bytes_peak} against "
              f"{b_st.kv_bytes_peak}; tokens equal to the non-spec run "
              f"{same}/{sum(len(o) for o in s_out)}; largest teacher-forced "
              f"gap {gap:.3e} (limit 5e-2; the non-spec engine's "
              f"{b_gap:.3e}); launches "
              f"{json.dumps({k_: v for k_, v in n.items() if v})}",
              flush=True)
        if not gap <= 5e-2:
            raise AssertionError(f"spec {label}: a token {gap:.3e} below "
                                 "the plain leg's best logit")
        if label == "dense":
            # K4 once a column: the drafter's k + 1 steps over its layers,
            # the verifier's k + 1 columns over every layer
            want = (k + 1) * (nb_draft + cfg.num_super_blocks) \
                * len(cfg.block_pattern) * s_st.decode_steps
            if n["decode_attention"] != want:
                raise AssertionError(f"spec dense: K4 launched "
                                     f"{n['decode_attention']}, want {want}")
        else:
            name = ("paged_decode_attention_int8" if quant.kv == "int8"
                    else "paged_decode_attention")
            if not n[name] >= cfg.num_layers * s_st.decode_steps:
                raise AssertionError(f"spec {label}: {name} launched "
                                     f"{n[name]} in {s_st.decode_steps} "
                                     "steps")
        if not s_st.draft_tokens > 0:
            raise AssertionError(f"spec {label}: no draft was proposed")
    del base, rt
    torch.cuda.empty_cache()


def phase_rest(dev, dense_run, paged_run, train_cores):
    """Phase 8 on full-width stablelm-1.6b: (a) the w8 dense cell with
    VeRA r = 1024 and a 4+1d MetaTT r = 384; (b) two full fine-tuning
    steps; (c) a two-site DMRG sweep; (d) Trainer steps with int8 and
    top-k gradient compression; (e) speculative decode, dense and paged.
    Launches are counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n
    secs = {}
    for part, fn in (
            ("a", lambda: w8_high_rank_serving(dev, dense_run["reqs"],
                                               count)),
            ("b", lambda: full_ft_on_the_card(dev, count)),
            ("c", lambda: two_site_on_the_card(dev, train_cores, count)),
            ("d", lambda: compressed_training(dev, count)),
            ("e", lambda: spec_serving(dev, dense_run, paged_run, count))):
        t = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        secs[part] = round(time.perf_counter() - t, 1)
    print(f"[phase8] seconds per part {json.dumps(secs)}, phase "
          f"{sum(secs.values()):.1f} s; launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}",
          flush=True)
    return total


# phase 9: the paged adapter registry, chaos with per-step audits, and
# recompute preemption, through Engine.generate
REG_TASKS = 64          # the adapter's task axis (64 columns on the host)
REG_NEW = 16            # tokens a request
#: stablelm-1.6b's depth cut from 24 (widths kept): 4 since phases 22-23
#: came (6 until then, 12 before phase 14)
REG_LAYERS = 4


def registry_model(dev):
    """Phase 9's model: serving_model's full-width stablelm-1.6b base at
    REG_LAYERS of its 24 layers with a 4+1d MetaTT q/v adapter (rank 8)
    over REG_TASKS tasks, scaled to 0.1 of the base q projection (phase 8's mild strength, where bf16 decoding
    is not chaotic). Returns (cfg, spec, base, adapter, live runtime,
    gen)."""
    import torch
    from repro_torch.config.base import RunConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime
    cfg, _, params, _, gen = serving_model(dev, "phase9", layers=REG_LAYERS)
    spec = M.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=REG_TASKS, adapter_rank=8))
    adapter = {"cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8,
                                        scale=0.5, device=dev)}
    rt = AdapterRuntime.build("live", params["base"], spec, adapter, {})
    adapter["cores"][-1] *= 0.1 / q_ratio(cfg, rt, gen)   # ΔW linear in G4
    rt = AdapterRuntime.build("live", params["base"], spec, adapter, {})
    torch.cuda.synchronize()
    return cfg, spec, params["base"], adapter, rt, gen


def registry_requests(cfg, n_distinct=24, repeat=8, seed=SEED + 19,
                      prefix_len=100):
    """2 * n_distinct requests over n_distinct tasks: task t, then a
    repeat of task t % repeat (the first ``repeat`` tasks come back, and
    a repeat can be admitted while its twin still pins the slot); prompts
    of 40-300 tokens, the even ones a task's ``prefix_len``-token prefix
    plus a tail."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(seed)
    prefix = {t: rng.randint(0, cfg.vocab_size, size=prefix_len)
              for t in range(n_distinct)}
    tasks = [t for i in range(n_distinct) for t in (i, i % repeat)]
    reqs = []
    for i, task in enumerate(tasks):
        if i % 2 == 0:
            prompt = np.concatenate([prefix[task], rng.randint(
                0, cfg.vocab_size, size=rng.randint(10, 201))])
        else:
            prompt = rng.randint(0, cfg.vocab_size, size=rng.randint(40, 301))
        reqs.append(Request(prompt, REG_NEW, task=task,
                            request_id=f"q{i}"))
    return reqs


def registry_run(eng, reqs, label, chaos=None, finished=True,
                 profiled=False):
    """One ``generate`` under a ChaosInjector (a fault-free one by
    default: the audit after every host-loop iteration), with the checks:
    every audit held and ran once an iteration (bar the injected stalls),
    no pin left, no leaked block (paged); with ``finished`` every request
    FINISHED with all its tokens. Prints tok/s, ms a step, the counters
    and, ``profiled``, the device busy share of this run (its tok/s is
    then taken under the profiler; ``device_share``'s lines); returns
    (tokens, stats, injector)."""
    import torch
    from repro_torch.serving import ChaosInjector
    chaos = chaos if chaos is not None else ChaosInjector()

    def run():
        return [o.tolist() for o in eng.generate(reqs, chaos=chaos)]
    outs = (device_share(f"phase9 {label}", run, top_n=3)[0] if profiled
            else run())
    torch.cuda.synchronize()
    st = eng.last_stats
    if finished:
        for req, res in zip(reqs, eng.last_results):
            if res.status != "FINISHED" \
                    or res.n_generated != req.max_new_tokens:
                raise AssertionError(f"{label}: request ended {res.status} "
                                     f"with {res.n_generated} tokens")
    for o in outs:
        if o and not (0 <= min(o) and max(o) < eng.cfg.vocab_size):
            raise AssertionError(f"{label}: token id outside the vocab")
    if not (chaos.audits > 0 and chaos.audits + chaos.stalls == chaos.steps):
        raise AssertionError(f"{label}: {chaos.audits} audits over "
                             f"{chaos.steps} host-loop iterations "
                             f"({chaos.stalls} injected stalls)")
    if eng.registry is not None and eng.registry.pinned_slots:
        raise AssertionError(f"{label}: {eng.registry.pinned_slots} "
                             "adapter slots still pinned")
    if eng.paged and eng.leaked_blocks():
        raise AssertionError(f"{label}: {eng.leaked_blocks()} KV blocks "
                             "leaked")
    steps = max(st.decode_steps, 1)
    print(f"[phase9] {label}: {st.requests} requests, "
          f"{st.tokens_generated} tokens in {st.wall_s:.3f}s = "
          f"{st.tokens_per_s:.1f} tok/s, {1e3 * st.decode_s / steps:.2f} "
          f"ms a step over {st.decode_steps} steps; admitted {st.admitted}, "
          f"adapter faults {st.adapter_faults} hits {st.adapter_hits} "
          f"(hit rate {st.adapter_hit_rate:.3f}) evictions "
          f"{st.adapter_evictions} waits {st.adapter_waits}; prefix hit "
          f"rate {st.prefix_hit_rate:.3f}; backpressure waits "
          f"{st.backpressure_waits}; preemptions {st.preemptions}; audits "
          f"{chaos.audits} of {chaos.steps} iterations ({chaos.stalls} "
          "injected stalls)" + (" (profiled run)" if profiled else ""),
          flush=True)
    return outs, st, chaos


def check_registry_counters(sts, label):
    """Every admission either hit or faulted; over ``sts`` the pool
    evicted, made a head wait, and hit."""
    for st in sts:
        if st.adapter_faults + st.adapter_hits != st.admitted:
            raise AssertionError(f"{label}: faults {st.adapter_faults} + "
                                 f"hits {st.adapter_hits} != admissions "
                                 f"{st.admitted}")
    for name in ("adapter_evictions", "adapter_waits", "adapter_hits"):
        if not sum(getattr(st, name) for st in sts) > 0:
            raise AssertionError(f"{label}: {name} is 0")


def tokens_checked(cfg, spec, rt, base, reqs, outs, ref_outs, label, dev):
    """Each token within 5% of the largest logit of the plain leg's
    teacher-forced maximum (the 72-slot test's limit); how many equal
    ``ref_outs`` is printed."""
    t0 = time.perf_counter()
    gap = teacher_forced_gap(cfg, spec, rt, base, reqs, outs, dev)
    same = sum(int(x == y) for o, r in zip(outs, ref_outs)
               for x, y in zip(o, r))
    print(f"[phase9] {label}: tokens equal to the reference run "
          f"{same}/{sum(len(o) for o in outs)}; largest teacher-forced gap "
          f"{gap:.3e} (limit 5e-2; {time.perf_counter() - t0:.1f}s)",
          flush=True)
    if not gap <= 5e-2:
        raise AssertionError(f"{label}: a token {gap:.3e} below the plain "
                             "leg's best logit")


def fault_in_ms(eng, label, iters=20):
    """Mean device-synchronised ms of one fault-in (every layer's q / v
    column of the live C or the lora-form A, from pinned host memory)
    into a mapped slot."""
    import torch
    reg = eng.registry
    task = reg.resident_tasks[0]
    slot = reg.slot_of(task)
    nbytes = sum(t[:, task].numel() * t.element_size()
                 for t in eng._host_per_layer.values())
    eng._adapter_fault_in(slot, task)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._adapter_fault_in(slot, task)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    print(f"[phase9] fault-in, {label}: {ms:.4f} ms a fault ({nbytes} bytes "
          f"host -> card: {eng.cfg.num_layers} layers x q/v; "
          f"{nbytes / ms / 1e6:.3f} GB/s)", flush=True)
    return ms


def phase_registry(dev, count):
    """Phase 9 on full-width stablelm-1.6b (``REG_LAYERS``) with a 64-task 4+1d
    adapter:
    (a) the registry on the paged fp cell (4 pool slots, 48 requests over
    24 tasks, cold then warm) against the all-resident engine; (b) the
    dense cell under the lora runtime, fp and w8, with 3 pool slots (K2 /
    #10 on A gathered from the pool); (c) a seeded chaos run with the
    registry on; (d) recompute preemption in a pool where a long running
    request and the blocked head cannot both fit; (e) speculative decode
    with the registry (dense) against the same spec engine without it.
    The audit runs after every host-loop iteration of every run."""
    import torch
    from repro_torch.config.base import (QuantConfig, RegistryConfig,
                                         ServeConfig, SpecConfig)
    from repro_torch.serving import (AdapterRuntime, ChaosInjector, Engine,
                                     Request)

    cfg, spec, base, adapter, rt, gen = registry_model(dev)
    print(f"[phase9] 4+1d adapter over {REG_TASKS} tasks, q ratio "
          f"{q_ratio(cfg, rt, gen):.3e}", flush=True)
    secs = {}
    t = time.perf_counter()

    # (a) the registry on the paged fp cell, 4 pool slots
    reqs = registry_requests(cfg)
    print(f"[phase9] (a) prompt lengths {[len(r.prompt) for r in reqs]}, "
          f"tasks {[r.task for r in reqs]}", flush=True)
    ref = Engine(cfg, rt, serve=ServeConfig(**PAGED), device=dev)
    ref_outs = registry_run(ref, reqs, "(a) paged fp, all 64 tasks "
                            "resident (reference)")[0]
    del ref
    eng = Engine(cfg, rt, serve=ServeConfig(
        registry=RegistryConfig(max_resident_tasks=4), **PAGED), device=dev)
    runs = {}
    # warm: in reverse order, so the prompts cached last (256 blocks hold
    # about a third of the 48) are looked up first
    for label, rq, refs in (("cold", reqs, ref_outs),
                            ("warm", reqs[::-1], ref_outs[::-1])):
        n = count(lambda: runs.__setitem__(label, registry_run(
            eng, rq, f"(a) paged fp registry K=4 {label}",
            profiled=label == "warm")))
        if not n["paged_decode_attention"] > 0:
            raise AssertionError(f"(a) {label}: #8 never launched: {n}")
        if n["tt_linear_batched_a"] or n["tt_linear"]:
            # the paged (B, 32) block runs the batched einsum (phase 4)
            raise AssertionError(f"(a): K1 / K2 on the paged path: {n}")
        print(f"[phase9] (a) {label} launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}")
        tokens_checked(cfg, spec, rt, base, rq, runs[label][0], refs,
                       f"(a) {label}", dev)
    check_registry_counters([runs[k][1] for k in runs], "(a)")
    if not runs["warm"][1].prefix_hit_rate > 0:
        raise AssertionError("(a) warm: no prefix hit after eviction")
    fault_in_ms(eng, "live C column")
    del eng
    torch.cuda.empty_cache()
    secs["a"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()

    # (b) dense, lora runtime, fp and w8: K2 / #10 on the pooled A
    lora = AdapterRuntime.build("lora", base, spec, adapter, {})
    rng = np.random.RandomState(SEED)
    dreqs = [Request(rng.randint(0, cfg.vocab_size, size=int(n)), REG_NEW,
                     task=i)
             for i, n in enumerate(rng.randint(16, 97, size=8))]
    dense = dict(cache_mode="dense", max_batch=4, cache_len=256,
                 out_cap=32)
    reg3 = RegistryConfig(max_resident_tasks=3)
    for label, quant, name in (
            ("fp", QuantConfig(), "tt_linear_batched_a"),
            ("w8", QuantConfig(weights="int8"), "tt_linear_batched_a_w8")):
        ref = Engine(cfg, lora, serve=ServeConfig(quant=quant, **dense),
                     device=dev)
        ref_outs = registry_run(ref, dreqs, f"(b) dense lora {label}, all "
                                "tasks resident (reference)")[0]
        del ref
        eng = Engine(cfg, lora, serve=ServeConfig(quant=quant, registry=reg3,
                                                  **dense), device=dev)
        sts = []
        # cold in order, then reversed: the last tasks of the first pass
        # are still resident, so the second pass starts with hits
        for order, rq in (("cold", dreqs), ("reversed", dreqs[::-1])):
            got = {}
            n = count(lambda: got.setdefault("r", registry_run(
                eng, rq, f"(b) dense lora {label} registry K=3 {order}",
                profiled=order == "reversed")))
            outs, st, _ = got["r"]
            sts.append(st)
            want = (2 * cfg.num_layers * st.decode_steps
                    if st.decode_steps else 0)
            if not (n[name] > 0 and n[name] == want
                    and n["decode_attention"] > 0):
                raise AssertionError(f"(b) {label} {order}: {name} "
                                     f"launched {n[name]}, want {want}: {n}")
            print(f"[phase9] (b) {label} {order} launches "
                  f"{json.dumps({k: v for k, v in n.items() if v})}")
            refs = ref_outs if order == "cold" else ref_outs[::-1]
            tokens_checked(cfg, spec, lora, eng.base_weights, rq, outs, refs,
                           f"(b) {label} {order}", dev)
        check_registry_counters(sts, f"(b) {label}")
        if label == "fp":
            fault_in_ms(eng, "lora-form A slice")
        del eng
        torch.cuda.empty_cache()
    del lora
    secs["b"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()

    # (c) chaos on the paged fp cell with the registry on
    creqs = reqs[:16]
    sv = ServeConfig(registry=RegistryConfig(max_resident_tasks=4), **PAGED)
    clean = registry_run(Engine(cfg, rt, serve=sv, device=dev), creqs,
                         "(c) clean run")[0]
    chaos = ChaosInjector(seed=7, alloc_fail_steps=(0, 1, 2),
                          alloc_fail_rate=0.2, scatter_failures=2,
                          cancel_at={3: ["q13"]}, nan_after={"q6": 5})
    eng = Engine(cfg, rt, serve=sv, device=dev)
    got = {}
    n = count(lambda: got.setdefault("r", registry_run(
        eng, creqs, "(c) chaos run", chaos=chaos, finished=False,
        profiled=True)))
    outs, st, _ = got["r"]
    status = [r.status for r in eng.last_results]
    print(f"[phase9] (c) statuses {status}; alloc faults "
          f"{chaos.alloc_faults}, scatter faults {chaos.scatter_faults}, "
          f"numerics faults {st.numerics_faults}; launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
    if not (status[13] == "CANCELLED" and status[6] == "FAILED"
            and len(outs[6]) == 5 and status.count("FINISHED") == 14):
        raise AssertionError(f"(c) statuses {status}, q6 emitted "
                             f"{len(outs[6])}")
    if not (st.numerics_faults == 1 and chaos.alloc_faults > 0
            and chaos.scatter_faults == 2):
        raise AssertionError("(c) the injected faults did not all fire")
    keep = [i for i, s in enumerate(status) if s == "FINISHED"]
    tokens_checked(cfg, spec, rt, base, [creqs[i] for i in keep],
                   [outs[i] for i in keep], [clean[i] for i in keep],
                   "(c) survivors against the clean run", dev)
    del eng
    torch.cuda.empty_cache()
    secs["c"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()

    # (d) recompute preemption: a 10-block pool of 16-cell pages where the
    # long running request (5 pages) and the blocked head (8) cannot both
    # fit once the short one (2) has finished
    prng = np.random.RandomState(SEED + 23)
    preqs = [Request(prng.randint(0, cfg.vocab_size, size=n), m, task=i,
                     request_id=f"p{i}")
             for i, (n, m) in enumerate(((20, 12), (60, 20), (100, 28)))]
    psv = dict(max_batch=2, cache_len=128, page_size=16, prefill_chunk=32,
               out_cap=32, num_blocks=10,
               registry=RegistryConfig(max_resident_tasks=4))
    base_outs = registry_run(Engine(cfg, rt, serve=ServeConfig(**psv),
                                    device=dev), preqs,
                             "(d) without preemption")[0]
    eng = Engine(cfg, rt, serve=ServeConfig(preempt_after=1, **psv),
                 device=dev)
    got = {}
    count(lambda: got.setdefault("r", registry_run(
        eng, preqs, "(d) preempt_after=1", profiled=True)))
    outs, st, _ = got["r"]
    pre = [r.preemptions for r in eng.last_results]
    print(f"[phase9] (d) preemptions {st.preemptions}, per request {pre}",
          flush=True)
    if not (st.preemptions >= 1 and pre[1] >= 1):
        raise AssertionError(f"(d) no preemption of the running request: "
                             f"{pre}")
    tokens_checked(cfg, spec, rt, base, preqs, outs, base_outs,
                   "(d) preempted run against the run without", dev)
    del eng
    secs["d"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()

    # (e) speculative decode with the registry (dense), 3 pool slots
    spec_outs = {}
    for leg, reg in (("without the registry", RegistryConfig()),
                     ("registry K=3", reg3)):
        eng = Engine(cfg, rt, serve=ServeConfig(
            spec=SpecConfig(**SPEC), registry=reg, **dense), device=dev)
        got = {}
        n = count(lambda: got.setdefault("r", registry_run(
            eng, dreqs, f"(e) spec dense {leg}",
            profiled=leg != "without the registry")))
        outs, st, _ = got["r"]
        spec_outs[leg] = outs
        print(f"[phase9] (e) {leg}: acceptance {st.acceptance_rate:.3f}, "
              f"tokens/step {st.tokens_per_step:.3f}; launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
        if not (n["tt_linear_batched_a"] > 0 and n["decode_attention"] > 0):
            raise AssertionError(f"(e) {leg}: K2 / K4 not launched: {n}")
        del eng
    a, b = spec_outs.values()
    same = sum(int(x == y) for o, r in zip(a, b) for x, y in zip(o, r))
    print(f"[phase9] (e) tokens with the registry equal to those without "
          f"{same}/{sum(len(o) for o in a)}", flush=True)
    if a != b:
        raise AssertionError("(e) spec tokens with the registry differ from "
                             "the same engine's without it")
    torch.cuda.empty_cache()
    secs["e"] = round(time.perf_counter() - t, 1)
    print(f"[phase9] seconds per part {json.dumps(secs)}", flush=True)
    del base, rt, adapter
    torch.cuda.empty_cache()


def phase_nine(dev):
    """Phase 9, launches counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n
    phase_registry(dev, count)
    print(f"[phase9] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}",
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 10: RoBERTa-base and -large, the paper's own fine-tuning targets,
# trained in f32 through the f32 instances of K1, #5, #6 and #7
# ---------------------------------------------------------------------------

# (kind, variant, rank, the paper's Table 1 column in thousands), the
# roberta-base rows of benchmarks/bench_table1.py that this phase trains
ROBERTA_TABLE1 = (("lora", "4d", 8, 295), ("vera", "4d", 1024, 43),
                  ("lotr", "4d", 40, 100), ("metatt", "4d", 8, 13),
                  ("metatt", "5d", 16, 20))


def f32_train_per_step(cfg):
    """f32 launches a training step (remat per block): K1 on q and v in
    the forward, again in the recompute and as dx in the backward — 6 a
    layer, less layer 0's two dx (its input, the embedding, needs no
    gradient); #5 in the forward and the recompute; #6 and #7 once."""
    n = cfg.num_layers
    return {"tt_linear_f32": 6 * n - 2, "flash_attention_fwd_f32": 2 * n,
            "flash_attention_bwd_dq_f32": n,
            "flash_attention_bwd_dkv_f32": n}


def no_bf16(launches, label):
    """No bf16 instance launched: every launch of the run is an f32 one."""
    bf = {k: v for k, v in launches.items() if v and not k.endswith("_f32")}
    if bf:
        raise AssertionError(f"{label}: bf16 kernels launched on the f32 "
                             f"path: {bf}")


def check_per_step(launches, per_step, steps, label):
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{label}: {name} {launches[name]} "
                                 f"launches in {steps} steps, not {n} a step")


def grad_check_f32(cfg, spec, base, adapter, frozen, tokens, dev, tag):
    """Loss and adapter gradients at B = 1 through the f32 kernels against
    the plain f32 leg (``KernelConfig(backend="ref")``) on the same
    weights, held by ``f32_grad_verdict``."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    batch = {"tokens": tokens,
             "mask": torch.ones_like(tokens, dtype=torch.float32)}
    legs = {}
    for name, pol in (("kernel", dispatch.DEFAULT), ("plain", dispatch.REF)):
        params = tree_map(lambda t: t.clone().requires_grad_(True), adapter)
        loss, _ = M.loss_fn(params, base, frozen, batch, cfg, spec,
                            policy=pol, device=dev)
        legs[name] = (float(loss.detach()),
                      torch.autograd.grad(loss, M.tensors(params)))
        del loss
    f32_grad_verdict(legs["kernel"], legs["plain"], tokens, tag)


def f32_grad_verdict(kernel, plain, tokens, tag, limits=(1e-5, 1e-4)):
    """The f32 kernel leg's (loss, gradients) against the plain f32 leg's:
    loss within ``limits[0]`` relative, each gradient within
    ``limits[1]`` relative Frobenius (f32 sums in another order)."""
    import torch
    (lk, gk), (lp, gp) = kernel, plain
    rel = abs(lk - lp) / abs(lp)
    errs = [rel_fro(a, b) for a, b in zip(gk, gp)]
    print(f"[{tag}] f32 gradient check B=1 T={tokens.shape[1]}: loss kernel "
          f"{lk:.7f} plain {lp:.7f}, rel {rel:.3e} (limit {limits[0]:g}); "
          f"gradients rel Frobenius {', '.join(f'{e:.3e}' for e in errs)} "
          f"(limit {limits[1]:g})", flush=True)
    if not (rel <= limits[0] and all(torch.isfinite(g).all() for g in gk)
            and max(errs) <= limits[1]):
        raise AssertionError(f"{tag}: f32 gradient check failed: loss "
                             f"{rel:.3e}, gradients {errs}")


def roberta_large_training(dev, count):
    """Phase 10 (a): phase 6's setting on full-width roberta-large in f32
    (MetaTT 4d on q/v from rank 10, AdamW lr 1e-3, remat per block, 4 x
    1024 tokens a step, 6 steps of 3 an epoch, one DMRG sweep to rank 8)."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.core.dmrg import RankSchedule
    from repro_torch.data import LMStream
    from repro_torch.models import model as M
    from repro_torch.train import Trainer

    cfg = configs.get_config("roberta-large")
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant="4d",
                    adapter_rank=10, optimizer=OptimizerConfig(lr=1e-3),
                    train=TrainConfig(remat="block", seed=SEED))
    batch, seq, steps = 4, 1024, 6
    data = LMStream(vocab_size=cfg.vocab_size, seq_len=seq, batch=batch,
                    seed=0, branching=2)
    t0 = time.perf_counter()
    tr = Trainer(run=run, data=data, total_steps=steps, steps_per_epoch=3,
                 rank_schedule=RankSchedule.linear(10, 8, start_epoch=1,
                                                   every=1, step=2),
                 device=dev,
                 on_metrics=lambda s_, m: print(
                     f"[roberta] step {s_} loss {m['loss']:.6f} grad_norm "
                     f"{m['grad_norm']:.4e} {1e3 * m['step_time_s']:.1f} ms",
                     flush=True))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in M.tensors(tr.base))
    print(f"[roberta] roberta-large f32 ({nbytes / 1e9:.3f} GB of base "
          f"weights, {tr.base['embed']['tok'].dtype}) MetaTT "
          f"4d q/v rank {ttlib.ranks(tr.state.adapter['cores'])}, remat per "
          f"block, B={batch} T={seq}: init {time.perf_counter() - t0:.1f}s",
          flush=True)
    before = [c.clone() for c in tr.state.adapter["cores"]]
    torch.cuda.reset_peak_memory_stats(dev)
    launches = count(tr.train)
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"roberta-large: non-finite loss {losses}")
    ranks = ttlib.ranks(tr.state.adapter["cores"])
    if ranks != (8, 8, 8) or tr._dmrg_applied != [1]:
        raise AssertionError(f"roberta-large: ranks after the sweep {ranks},"
                             f" sweeps at epochs {tr._dmrg_applied}")
    norms = [float(ttlib.tt_norm(c)) for c in (before,
                                               tr.state.adapter["cores"])]
    if not (norms[0] == 0.0 and norms[1] > 0.0):
        raise AssertionError(f"roberta-large: the adapter did not move: "
                             f"||ΔW|| {norms}")
    per_step = f32_train_per_step(cfg)
    check_per_step(launches, per_step, steps, "roberta-large")
    no_bf16(launches, "roberta-large training")
    step_ms = [round(1e3 * m["step_time_s"], 1) for _, m in tr.history[1:]]
    med = float(np.median(step_ms))
    print(f"[roberta] large: f32 launches a step "
          + ", ".join(f"{k} {launches[k] // steps}" for k in per_step)
          + f" (rule 6L-2 / 2L / L / L, L = {cfg.num_layers}); no bf16 "
          f"launch; losses {[round(float(x), 6) for x in losses]}; median "
          f"step {med:.1f} ms after step 1 (steps {step_ms}); "
          f"{batch * seq / (med / 1e3):.1f} tokens/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; ranks "
          f"{ranks}; ||ΔW|| {norms[0]:.3e} -> {norms[1]:.3e}", flush=True)
    device_share("one roberta-large f32 step", lambda: tr.train(steps + 1),
                 top_n=12, show=("f32",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    tokens = torch.as_tensor(next(data)["tokens"][:1], device=dev)
    grad_check_f32(cfg, tr.spec, tr.base, {"cores": ttlib.random_tt(
        gen, tr.spec.cfg.mode_sizes, 8, scale=0.12, device=dev)}, tr.frozen,
        tokens, dev, "roberta")
    return tr, data


def roberta_no_grad_forward(dev, tr, data, count):
    """Phase 10 (c): a no-grad forward of roberta-large over 4 x 1024
    tokens under (a)'s trained adapter: K1 and K3 in f32, held against the
    plain f32 leg within 1e-4 of the largest logit."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.peft import api as peft_api
    cfg = tr.run.model
    bc, pl = peft_api.adapter_factors(tr.spec, tr.state.adapter, tr.frozen)
    tokens = torch.as_tensor(next(data)["tokens"], device=dev)
    out = []
    with torch.no_grad():
        launches = count(lambda: out.append(T.forward(
            tr.base, cfg, tr.spec, bc, pl, tokens, device=dev).logits))
        ref = T.forward(tr.base, cfg, tr.spec, bc, pl, tokens,
                        policy=dispatch.REF, device=dev).logits
    gap = rel_max(out[0], ref)
    want = {"tt_linear_f32": 2 * cfg.num_layers,
            "flash_attention_f32": cfg.num_layers}
    check_per_step(launches, want, 1, "roberta-large no-grad forward")
    no_bf16(launches, "roberta-large no-grad forward")
    print(f"[roberta] large no-grad forward {tuple(tokens.shape)}: logits "
          f"{tuple(out[0].shape)} {out[0].dtype}, max |kernel - plain| / "
          f"max |plain| {gap:.3e} (limit 1e-4); launches "
          f"{json.dumps({k: launches[k] for k in want})}", flush=True)
    if not gap <= 1e-4:
        raise AssertionError(f"roberta-large no-grad forward: {gap:.3e}")
    del out, ref
    torch.cuda.empty_cache()


def roberta_base_adapters(dev, count):
    """Phase 10 (b): Table 1's adapters on full-width roberta-base, each 3
    Trainer steps on one shared f32 base (q/v, AdamW lr 1e-3, remat per
    block, 4 x 1024 tokens a step); trainable counts equal to the paper's
    closed forms and Table 1's column."""
    import torch
    from repro_torch import configs
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import metatt
    from repro_torch.data import LMStream
    from repro_torch.peft import api as peft_api
    from repro_torch.peft import lora, lotr, vera
    from repro_torch.train import Trainer

    cfg = configs.get_config("roberta-base")
    d, n_l, n_h = cfg.d_model, cfg.num_layers, cfg.num_heads
    closed = {"lora": lambda r: lora.paper_count(d, n_l, 2, r),
              "vera": lambda r: vera.paper_count(d, n_l, 2, r),
              "lotr": lambda r: lotr.paper_count(d, n_l, 2, r),
              "metatt-4d": lambda r: metatt.paper_count_4d(d, n_l, 2, r),
              "metatt-5d": lambda r: metatt.paper_count_5d(d, n_h, n_l, 2,
                                                           r)}
    batch, seq, steps = 4, 1024, 3
    per_step = f32_train_per_step(cfg)
    base = None
    for kind, variant, rank, paper_k in ROBERTA_TABLE1:
        label = f"{kind}-{variant}" if kind == "metatt" else kind
        run = RunConfig(model=cfg, adapter_kind=kind, adapter_variant=variant,
                        adapter_rank=rank, optimizer=OptimizerConfig(lr=1e-3),
                        train=TrainConfig(remat="block", seed=SEED))
        tr = Trainer(run=run, data=LMStream(
            vocab_size=cfg.vocab_size, seq_len=seq, batch=batch, seed=0,
            branching=2), total_steps=steps, device=dev)
        if base is None:
            base = tr.base
        tr.base = base
        n = peft_api.count_trainable(tr.spec, tr.state.adapter)
        if n != closed[label](rank) or not abs(n / 1000 - paper_k) < 1.0:
            raise AssertionError(f"roberta-base {label} r={rank}: {n} "
                                 f"trainable, closed form "
                                 f"{closed[label](rank)}, Table 1 {paper_k}k")
        d0 = delta_norm(tr.spec, tr.state.adapter, tr.frozen)
        torch.cuda.reset_peak_memory_stats(dev)
        launches = count(tr.train)
        losses = tr.losses()
        d1 = delta_norm(tr.spec, tr.state.adapter, tr.frozen)
        if not np.isfinite(losses).all():
            raise AssertionError(f"roberta-base {label}: losses {losses}")
        if not d1 > d0:
            raise AssertionError(f"roberta-base {label}: ΔW did not move: "
                                 f"{d0} -> {d1}")
        check_per_step(launches, per_step, steps, f"roberta-base {label}")
        no_bf16(launches, f"roberta-base {label}")
        step_ms = [1e3 * m["step_time_s"] for _, m in tr.history]
        print(f"[roberta] base {label} r={rank}: {n} trainable (Table 1: "
              f"{paper_k}k); losses {[round(float(x), 6) for x in losses]}; "
              f"||ΔW|| layer 0 q {d0:.3e} -> {d1:.3e}; median step "
              f"{float(np.median(step_ms)):.1f} ms (steps "
              f"{[round(x, 1) for x in step_ms]}); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; "
              f"launches {json.dumps({k: launches[k] for k in per_step})}",
              flush=True)
        del tr
    del base
    torch.cuda.empty_cache()


def phase_roberta(dev):
    """Phase 10, launches counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n
    f32_precision_checked()
    t = [time.perf_counter()]
    tr, data = roberta_large_training(dev, count)
    t.append(time.perf_counter())
    roberta_no_grad_forward(dev, tr, data, count)
    del tr, data
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    roberta_base_adapters(dev, count)
    t.append(time.perf_counter())
    print(f"[phase10] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; (a) "
          f"{t[1] - t[0]:.1f} s, (c) {t[2] - t[1]:.1f} s, (b) "
          f"{t[3] - t[2]:.1f} s", flush=True)
    return total



# ---------------------------------------------------------------------------
# phase 11: RoBERTa served in f32 through the f32 instances of K2, K4, #8
# and #8q (and K1 / K3 at prefill)
# ---------------------------------------------------------------------------

#: kernel-vs-plain limit of the f32 serving checks, of the largest logit:
#: f32 sums in another order (≈ 1e-6); one TF32 pass would miss it
F32_LOGIT_TOL = 1e-4
#: the same for a whole int8-KV run against a plain replay that quantizes
#: its own K / V: an f32 difference of ~1e-7 moves a cell across an int8
#: rounding edge (one step, 1/127 of the cell's largest value), which
#: moved a logit by 1.5e-4 of the largest over 300-token histories on the
#: card — a property of the pools, not of the kernels (the paged-step check
#: over one set of pools holds 1e-4)
INT8_KV_LOGIT_TOL = 1e-3


#: the served adapter's size against the base q projection, as a
#: fine-tuned update's: ``random_tt(scale=0.5)`` is ~260x at d_model 1024,
#: and a model that far off its base is so ill-conditioned that f32
#: summation order alone moves its decode logits by ~0.3 of the largest
SERVED_RATIO = 0.25


#: (e)'s depth: roberta-large's widths at 3 of its 24 layers (the
#: int8-weight cells cost 66 s at 24; phases 14 and 19 needed the time,
#: 6 layers until phases 22-23 came)
W8_LAYERS = 3
#: (a)-(d)'s depth, the same cut: at 24 layers they took 72.0-124.6 s,
#: the script 555-886 s on H100s whose hosts ran at different speeds; at
#: 12 the phase took 59.7-83.7 s and the script 601.0-722.9 s
F32_SERVE_LAYERS = 6


def roberta_serving_model(dev, layers=None):
    """Full-width roberta-large in f32 with a served 4+1d MetaTT adapter
    on q/v (rank 8, 3 tasks, ``random_tt(scale=0.5)`` with its last core
    scaled to ``SERVED_RATIO`` of the base q projection); ``layers``: its
    depth cut to that many layers. Returns (cfg, spec, params, rt)."""
    return serving_model(dev, "phase11", "roberta-large", SERVED_RATIO,
                         layers=layers, seed=SEED + 37)[:4]


def f32_tokens_checked(cfg, spec, rt, reqs, outs, ref_outs, label, dev,
                       kv_int8=False, ref="the plain f32 leg's run",
                       base=None):
    """Every generated token within ``F32_LOGIT_TOL`` of the largest logit
    of the plain f32 leg's teacher-forced maximum (``kv_int8``: through
    int8 pools the replay writes itself, within ``INT8_KV_LOGIT_TOL``;
    ``base``: an int8 engine's packed base, default the runtime's); the
    count of tokens equal to ``ref_outs`` (``ref``: the plain leg's own
    run) printed."""
    base = rt.base if base is None else base
    gap = (paged_teacher_forced_gap(cfg, spec, rt, reqs, outs, dev, base)
           if kv_int8 else
           teacher_forced_gap(cfg, spec, rt, base, reqs, outs, dev))
    tol = INT8_KV_LOGIT_TOL if kv_int8 else F32_LOGIT_TOL
    same = sum(int(x == y) for o, r in zip(outs, ref_outs)
               for x, y in zip(o.tolist(), r.tolist()))
    print(f"[phase11] {label}: tokens equal to {ref} "
          f"{same}/{sum(len(o) for o in outs)}; largest teacher-forced gap "
          f"{gap:.3e} of the largest logit (limit {tol})", flush=True)
    if not gap <= tol:
        raise AssertionError(f"{label}: a token {gap:.3e} below the plain "
                             "f32 leg's best logit")


def paged_teacher_forced_gap(cfg, spec, rt, reqs, outs, dev, base=None):
    """``teacher_forced_gap`` of an int8-KV paged run: the plain leg's
    ``paged_step``s over int8 pools (each cell quantized as it is written,
    as the engine does) on [prompt, tokens], one request at a time in
    chunks of ``prefill_chunk``, every column's logits kept (over
    ``base``, default the runtime's)."""
    base = rt.base if base is None else base
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    c, page = PAGED["prefill_chunk"], PAGED["page_size"]
    pages = PAGED["cache_len"] // page
    tables = torch.arange(pages, dtype=torch.int32, device=dev)[None]
    worst = 0.0
    with torch.inference_mode():
        for req, toks in zip(reqs, outs):
            toks = [int(t) for t in toks]
            seq = [int(t) for t in req.prompt] + toks
            caches = T.init_paged_caches(cfg, pages, page, cfg.compute_dtype,
                                         kv_quant=True, device=dev)
            task = torch.tensor([req.task], device=dev)
            lgs = []
            for s0 in range(0, len(seq) - 1, c):
                chunk = seq[s0:s0 + c]
                t = torch.zeros((1, c), dtype=torch.long, device=dev)
                t[0, :len(chunk)] = torch.as_tensor(chunk, device=dev)
                lg, _ = T.paged_step(
                    base, cfg, spec, rt.broadcast, rt.per_layer, t,
                    caches, tables, torch.tensor([s0], device=dev),
                    torch.tensor([len(chunk) - 1], device=dev), task=task,
                    policy=dispatch.REF, device=dev, all_logits=True)
                lgs.append(lg[0, :len(chunk)].float())
            lg = torch.cat(lgs)[len(req.prompt) - 1:len(seq) - 1]
            chosen = lg.gather(-1, torch.as_tensor(toks, device=dev)[:, None])
            gap = (lg.max(-1).values - chosen[:, 0]) / lg.abs().amax(-1)
            worst = max(worst, float(gap.max()))
    return worst


def roberta_dense_serving(dev, model, count):
    """Phase 11 (a): phase 3's dense cell in f32 — 4 slots x 256 cells, 8
    mixed-task requests of 16-96 prompt tokens, 32 new tokens each; K1f /
    K3f at prefill, 2L K2f + L K4f a decode step, no bf16 launch."""
    import torch
    from repro_torch.config.base import KernelConfig, ServeConfig
    from repro_torch.serving import Engine
    cfg, spec, params, rt = model
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    reqs = dense_requests(cfg, SEED + 41)
    eng.generate(reqs[:2])                       # warm-up (cuBLAS, allocator)
    torch.cuda.reset_peak_memory_stats(dev)
    got = {}
    n = count(lambda: got.update(r=serve_checked(eng, reqs, "(a) dense",
                                                 "phase11")))
    outs, st = got["r"]
    steps, L = st.decode_steps, cfg.num_layers
    want = {"tt_linear_batched_a_f32": 2 * L * steps,
            "decode_attention_f32": L * steps}
    for name, w in want.items():
        if n[name] != w:
            raise AssertionError(f"(a) dense: {name} {n[name]} launches in "
                                 f"{steps} decode steps, want {w}")
    if not (n["tt_linear_f32"] > 0 and n["flash_attention_f32"] > 0):
        raise AssertionError(f"(a) dense: prefill launched {n}")
    no_bf16(n, "(a) dense roberta-large")
    print(f"[phase11] (a) dense: launches "
          f"{json.dumps({k: v for k, v in n.items() if v})} = K2f "
          f"{n['tt_linear_batched_a_f32'] // steps} and K4f "
          f"{n['decode_attention_f32'] // steps} a decode step over {steps} "
          f"(2L / L, L = {L}); no bf16 launch; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    device_share("(a) roberta-large f32 dense generate of 4 requests",
                 lambda: eng.generate(reqs[:4]), show=("f32",))
    eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
        backend="ref"), device=dev)
    ref_outs = eng_ref.generate(reqs)
    rel, agree, _ = decode_step_rel_err(cfg, rt, reqs[:4], serve.cache_len,
                                        dev)
    print(f"[phase11] (a) one decode step of 4 slots (tasks "
          f"{[r.task for r in reqs[:4]]}), kernel leg vs plain f32 leg: max "
          f"|kernel - plain| / max |plain| per slot {rel:.3e} (limit "
          f"{F32_LOGIT_TOL}), argmax equal {agree}/4", flush=True)
    if not rel <= F32_LOGIT_TOL:
        raise AssertionError(f"(a) decode-step logits: {rel:.3e}")
    f32_tokens_checked(cfg, spec, rt, reqs, outs, ref_outs, "(a) dense",
                       dev)
    del eng, eng_ref
    torch.cuda.empty_cache()
    return dict(reqs=reqs, outs=outs, stats=st)


def paged_requests(cfg):
    """Phase 4's 16 requests on ``cfg``'s vocab: 40-300 prompt tokens over
    3 tasks, half sharing a 100-token prefix per task."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED + 3)
    prefix = {t: rng.randint(0, cfg.vocab_size, size=100) for t in range(3)}
    reqs = []
    for i in range(16):
        if i % 2 == 0:
            prompt = np.concatenate([prefix[i % 3], rng.randint(
                0, cfg.vocab_size, size=rng.randint(10, 201))])
        else:
            prompt = rng.randint(0, cfg.vocab_size, size=rng.randint(40, 301))
        reqs.append(Request(prompt, 32, task=i % 3))
    return reqs


def roberta_paged_serving(dev, model, count, kv):
    """Phase 11 (b) (``kv`` None) and (c) (``kv="int8"``): phase 4's paged
    cell in f32 — 8 slots, 256 blocks of 16 cells, chunk 32, 16 requests
    cold then warm; every (B, 32) engine step launches L #8f (#8qf) and
    runs the adapted q/v as the f32 einsum, as the JAX package does; every
    request finished, no leaked block, warm prefix hits and copy-on-write.
    Returns (kv_bytes_peak, the requests, the cold run's tokens and
    stats)."""
    import torch
    from repro_torch.config.base import KernelConfig, QuantConfig, \
        ServeConfig
    from repro_torch.serving import Engine
    cfg, spec, params, rt = model
    tag = "(c) paged int8 KV" if kv else "(b) paged fp"
    serve = ServeConfig(cache_mode="paged", quant=QuantConfig(kv=kv)
                        if kv else QuantConfig(), **PAGED)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    reqs = paged_requests(cfg)
    name = ("paged_decode_attention_int8_f32" if kv
            else "paged_decode_attention_f32")
    total, kv_peak, cold = {}, 0, None
    for label in ("cold", "warm"):
        got = {}
        n = count(lambda: got.update(r=serve_checked(
            eng, reqs, f"{tag} {label}", "phase11")))
        outs, st = got["r"]
        cold = (outs, st) if cold is None else cold
        kv_peak = max(kv_peak, st.kv_bytes_peak)
        if n[name] != cfg.num_layers * st.decode_steps:
            raise AssertionError(f"{tag} {label}: {name} {n[name]} launches "
                                 f"in {st.decode_steps} engine steps")
        for k_, v_ in n.items():
            total[k_] = total.get(k_, 0) + v_
    if not (st.prefix_hit_tokens > 0 and st.cow_copies >= 1):
        raise AssertionError(f"{tag} warm: no prefix hit or no COW copy")
    other = ("paged_decode_attention_f32" if kv
             else "paged_decode_attention_int8_f32")
    if total[other] or total["tt_linear_batched_a_f32"]:
        raise AssertionError(f"{tag}: {other} or K2f launched: {total}")
    no_bf16(total, tag)
    print(f"[phase11] {tag}: launches over cold and warm "
          f"{json.dumps({k: v for k, v in total.items() if v})} ({name} L = "
          f"{cfg.num_layers} an engine step; the (B, 32) adapted q/v run the "
          f"f32 einsum, no K2f); no bf16 launch; kv_bytes_peak {kv_peak}",
          flush=True)
    device_share(f"{tag} generate of 8 requests (warm)",
                 lambda: eng.generate(reqs[:8]), show=("f32",))
    del eng
    torch.cuda.empty_cache()
    eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
        backend="ref"), device=dev)
    ref_outs = eng_ref.generate(reqs)
    del eng_ref
    f32_tokens_checked(cfg, spec, rt, reqs, cold[0], ref_outs,
                       f"{tag} cold", dev, kv_int8=bool(kv))
    picked = reqs[1:3] + sorted(reqs[3:], key=lambda r: len(r.prompt))[-2:]
    res = paged_step_rel_err(cfg, rt, [r.prompt for r in picked],
                             [r.task for r in picked], dev,
                             kv_quant=bool(kv))
    for step, (rel, agree, _) in res.items():
        print(f"[phase11] {tag}: one {step} paged step of 4 slots, kernel "
              f"leg vs plain f32 leg: max |kernel - plain| / max |plain| per "
              f"slot {rel:.3e} (limit {F32_LOGIT_TOL}), argmax equal "
              f"{agree}/4", flush=True)
        if not rel <= F32_LOGIT_TOL:
            raise AssertionError(f"{tag} {step} step logits: {rel:.3e}")
    torch.cuda.empty_cache()
    return kv_peak, (reqs, *cold)


def roberta_spec_serving(dev, model, count, dense, paged):
    """Phase 11 (d): speculative decode (k 3, drafter rank 4, layer stride
    2) on (a)'s dense cell and (b)'s paged cell (cold), tokens equal to
    the same engine's without speculation; the dense verifier runs K4f
    once a column, the drafter's (B, 1) steps K2f (and, paged, #8f at
    C = 1)."""
    import torch
    from repro_torch.config.base import ServeConfig, SpecConfig
    from repro_torch.serving import Engine
    cfg, spec, params, rt = model
    k = SPEC["spec_k"]
    nb_draft = -(-cfg.num_super_blocks // SPEC["draft_layer_stride"])
    cells = (("dense", dict(cache_mode="dense", max_batch=4, cache_len=256,
                            out_cap=32), dense),
             ("paged fp", dict(cache_mode="paged", **PAGED), paged))
    for label, sv, base_run in cells:
        reqs, b_outs, b_st = base_run
        eng = Engine(cfg, rt, serve=ServeConfig(spec=SpecConfig(**SPEC),
                                                **sv), device=dev)
        outs = []
        n = count(lambda: outs.extend(eng.generate(reqs)))
        st = eng.last_stats
        for r_ in eng.last_results:
            if r_.status != "FINISHED" or r_.n_generated != 32:
                raise AssertionError(f"(d) spec {label}: request ended "
                                     f"{r_.status}")
        if eng.paged and eng.leaked_blocks():
            raise AssertionError(f"(d) spec {label}: "
                                 f"{eng.leaked_blocks()} blocks leaked")
        same = sum(int(x == y) for o, r in zip(outs, b_outs)
                   for x, y in zip(o.tolist(), r.tolist()))
        total = sum(len(o) for o in outs)
        no_bf16(n, f"(d) spec {label}")
        if label == "dense":
            want = (k + 1) * (nb_draft + cfg.num_super_blocks) \
                * len(cfg.block_pattern) * st.decode_steps
            if n["decode_attention_f32"] != want:
                raise AssertionError(f"(d) spec dense: K4f "
                                     f"{n['decode_attention_f32']}, want "
                                     f"{want}")
        elif not n["paged_decode_attention_f32"] >= \
                cfg.num_layers * st.decode_steps:
            raise AssertionError(f"(d) spec paged: #8f "
                                 f"{n['paged_decode_attention_f32']}")
        if not (n["tt_linear_batched_a_f32"] > 0 and st.draft_tokens > 0):
            raise AssertionError(f"(d) spec {label}: no drafter step ran on "
                                 f"K2f: {n}")
        dec = 1e3 * st.decode_s / max(st.decode_steps, 1)
        b_dec = 1e3 * b_st.decode_s / max(b_st.decode_steps, 1)
        print(f"[phase11] (d) spec {label}: acceptance "
              f"{st.acceptance_rate:.3f} ({st.accepted_tokens}/"
              f"{st.draft_tokens}), tokens/step {st.tokens_per_step:.3f} over "
              f"{st.spec_steps} steps; {st.tokens_per_s:.1f} tok/s against "
              f"{b_st.tokens_per_s:.1f} without spec "
              f"({st.tokens_per_s / b_st.tokens_per_s:.3f}x); decode "
              f"{dec:.2f} ms/step against {b_dec:.2f}; kv_bytes_peak "
              f"{st.kv_bytes_peak}; tokens equal to the non-spec engine's "
              f"{same}/{total}; launches "
              f"{json.dumps({k_: v for k_, v in n.items() if v})}",
              flush=True)
        if same != total:
            raise AssertionError(f"(d) spec {label}: {total - same} tokens "
                                 "differ from the non-spec engine's")
        f32_tokens_checked(cfg, spec, rt, reqs, outs, b_outs,
                           f"(d) spec {label}", dev,
                           ref="the non-spec engine's")
        del eng
        torch.cuda.empty_cache()


def w8_run(eng, reqs, label, count, want, zero):
    """``serve_checked`` on a w8 engine with its launches counted: each
    name in ``want`` launched exactly that many times a unit of the stats
    (``want[name] = (per, stat)``), each in ``zero`` never, and no bf16
    instance. Returns (tokens, stats, launches)."""
    got = {}
    n = count(lambda: got.update(r=serve_checked(eng, reqs, label,
                                                 "phase11")))
    outs, st = got["r"]
    for name, (per, stat) in want.items():
        units = getattr(st, stat)
        if not (units > 0 and n[name] == per * units):
            raise AssertionError(f"{label}: {name} {n[name]} launches over "
                                 f"{units} {stat}, want {per} each")
    if any(n[z] for z in zero):
        raise AssertionError(f"{label}: launched {n}")
    no_bf16(n, label)
    return outs, st, n


def roberta_w8_serving(dev, model, count, dense):
    """Phase 11 (e): roberta-large (at ``W8_LAYERS`` of its 24 layers,
    full width) served over int8 weights in f32 through #9f and #10f. (e1) phase 3's dense cell (a's 8 requests) with
    ``QuantConfig(weights="int8")``: 2L #9f a prefill, 2L #10f + L K4f a
    decode step, K3f at prefill, no K1f / K2f, no bf16 launch; (e2) phase
    4's paged cell with int8 weights and int8 KV, cold then warm: L #8qf
    an engine step, prefix hits, COW, no leaked block — every paged step
    is (B, 32), whose adapted q / v run the einsum over the dequantized W
    (no kernel in either package), so #9f / #10f do not launch there;
    (e3) the dense cell with grouped scales (``group_size=128``) over 4
    requests. Decode-step (e1, e3) and paged-step (e2) logits within
    ``F32_LOGIT_TOL`` of the plain f32 leg over the same int8 base, every
    token within it of the plain leg's teacher-forced maximum (e2:
    ``INT8_KV_LOGIT_TOL``, as (c)); tok/s, step ms and busy share a run."""
    import torch
    from repro_torch.config.base import KernelConfig, QuantConfig, \
        ServeConfig
    from repro_torch.serving import Engine
    cfg, spec, params, rt = model
    L = cfg.num_layers
    dense_sv = dict(cache_mode="dense", max_batch=4, cache_len=256,
                    out_cap=32)
    zero_dense = ("tt_linear_f32", "tt_linear_batched_a_f32")
    for label, quant, reqs in (
            ("(e1) w8 dense", QuantConfig(weights="int8"), dense["reqs"]),
            ("(e3) w8 dense grouped 128", QuantConfig(
                weights="int8", group_size=128), dense["reqs"][:4])):
        serve = ServeConfig(quant=quant, **dense_sv)
        eng = Engine(cfg, rt, serve=serve, device=dev)
        eng.generate(reqs[:2])                   # warm-up (allocator)
        outs, st, n = w8_run(
            eng, reqs, label, count,
            {"tt_linear_w8_f32": (2 * L, "prefills"),
             "tt_linear_batched_a_w8_f32": (2 * L, "decode_steps"),
             "decode_attention_f32": (L, "decode_steps")}, zero_dense)
        if not n["flash_attention_f32"] > 0:
            raise AssertionError(f"{label}: no K3f at prefill: {n}")
        qbase = eng.base_weights
        wq_ = qbase["blocks"][0]["mixer"]["wq"]
        groups = wq_["scale"].shape[-2]      # (nb, G, N) scales of wq
        if groups != (cfg.d_model // 128 if quant.group_size else 1):
            raise AssertionError(f"{label}: wq scales {wq_['scale'].shape}")
        print(f"[phase11] {label}: launches "
              f"{json.dumps({k: v for k, v in n.items() if v})} = #9f "
              f"{n['tt_linear_w8_f32'] // st.prefills} a prefill over "
              f"{st.prefills}, #10f {n['tt_linear_batched_a_w8_f32'] // st.decode_steps}"
              f" and K4f {n['decode_attention_f32'] // st.decode_steps} a "
              f"decode step over {st.decode_steps} (2L / 2L / L, L = {L}); "
              f"no bf16 launch; {groups} scale row(s) a matrix of K = "
              f"{cfg.d_model}", flush=True)
        device_share(f"{label} generate of 4 requests",
                     lambda: eng.generate(reqs[:4]), show=("f32",))
        del eng
        torch.cuda.empty_cache()
        eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
            backend="ref"), device=dev)
        ref_outs = eng_ref.generate(reqs)
        del eng_ref
        rel, agree, _ = decode_step_rel_err(cfg, rt, reqs[:4], 256, dev,
                                            base=qbase)
        print(f"[phase11] {label}: one decode step of 4 slots over the int8 "
              f"base, kernel leg vs plain f32 leg: max |kernel - plain| / "
              f"max |plain| per slot {rel:.3e} (limit {F32_LOGIT_TOL}), "
              f"argmax equal {agree}/4", flush=True)
        if not rel <= F32_LOGIT_TOL:
            raise AssertionError(f"{label} decode-step logits: {rel:.3e}")
        f32_tokens_checked(cfg, spec, rt, reqs, outs, ref_outs, label, dev,
                           base=qbase)
        del qbase
        torch.cuda.empty_cache()

    label = "(e2) w8 + int8 KV paged"
    serve = ServeConfig(cache_mode="paged", quant=QuantConfig(
        weights="int8", kv="int8"), **PAGED)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    reqs = paged_requests(cfg)
    cold = None
    for run in ("cold", "warm"):
        outs, st, n = w8_run(
            eng, reqs, f"{label} {run}", count,
            {"paged_decode_attention_int8_f32": (L, "decode_steps")},
            zero_dense + ("tt_linear_w8_f32", "tt_linear_batched_a_w8_f32",
                          "paged_decode_attention_f32"))
        cold = cold or (outs, st)
    if not (st.prefix_hit_tokens > 0 and st.cow_copies >= 1):
        raise AssertionError(f"{label} warm: no prefix hit or no COW copy")
    print(f"[phase11] {label}: #8qf L = {L} an engine step; #9f / #10f "
          f"none (every paged step is (B, 32): the einsum over the "
          f"dequantized W); w={st.weights_dtype} kv={st.kv_dtype}, "
          f"kv_bytes_peak {st.kv_bytes_peak}", flush=True)
    device_share(f"{label} generate of 8 requests (warm)",
                 lambda: eng.generate(reqs[:8]), show=("f32",))
    qbase = eng.base_weights
    del eng
    torch.cuda.empty_cache()
    eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
        backend="ref"), device=dev)
    ref_outs = eng_ref.generate(reqs)
    del eng_ref
    f32_tokens_checked(cfg, spec, rt, reqs, cold[0], ref_outs,
                       f"{label} cold", dev, kv_int8=True, base=qbase)
    picked = reqs[1:3] + sorted(reqs[3:], key=lambda r: len(r.prompt))[-2:]
    res = paged_step_rel_err(cfg, rt, [r.prompt for r in picked],
                             [r.task for r in picked], dev, base=qbase,
                             kv_quant=True)
    for step, (rel, agree, _) in res.items():
        print(f"[phase11] {label}: one {step} paged step of 4 slots over "
              f"the int8 base, kernel leg vs plain f32 leg: max |kernel - "
              f"plain| / max |plain| per slot {rel:.3e} (limit "
              f"{F32_LOGIT_TOL}), argmax equal {agree}/4", flush=True)
        if not rel <= F32_LOGIT_TOL:
            raise AssertionError(f"{label} {step} step logits: {rel:.3e}")
    del qbase
    torch.cuda.empty_cache()


def phase_eleven(dev):
    """Phase 11, launches counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n
    f32_precision_checked()
    t = [time.perf_counter()]
    model = roberta_serving_model(dev, F32_SERVE_LAYERS)
    dense = roberta_dense_serving(dev, model, count)
    t.append(time.perf_counter())
    fp_peak, paged = roberta_paged_serving(dev, model, count, None)
    t.append(time.perf_counter())
    q_peak, _ = roberta_paged_serving(dev, model, count, "int8")
    print(f"[phase11] (c) kv_bytes_peak int8 {q_peak} against fp {fp_peak} "
          f"({q_peak / fp_peak:.3f}x)", flush=True)
    if not q_peak < fp_peak:
        raise AssertionError(f"(c) int8 kv_bytes_peak {q_peak} not below "
                             f"(b)'s {fp_peak}")
    t.append(time.perf_counter())
    roberta_spec_serving(dev, model, count,
                         (dense["reqs"], dense["outs"], dense["stats"]),
                         paged)
    t.append(time.perf_counter())
    del model
    torch.cuda.empty_cache()
    roberta_w8_serving(dev, roberta_serving_model(dev, W8_LAYERS), count,
                       dense)
    t.append(time.perf_counter())
    print(f"[phase11] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; (a) "
          f"{t[1] - t[0]:.1f} s, (b) {t[2] - t[1]:.1f} s, (c) "
          f"{t[3] - t[2]:.1f} s, (d) {t[4] - t[3]:.1f} s, (e) "
          f"{t[5] - t[4]:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 12: gemma-7b served at full width in bf16 through the head_dim 256
# instances of K3, K4, #8 and #8q
# ---------------------------------------------------------------------------

GEMMA = "gemma-7b"
#: phase 12's depth: gemma-7b served at 14 of its 28 layers (widths
#: kept), cut to pay for phase 16 in the script's time
GEMMA_SERVE_LAYERS = 14
#: the d = 256 instances: names in ``KERNELS``, and the phase-2 shapes at
#: gemma-7b's 16 heads of 256 (KV 16): prefill T = S (K3), the dense
#: cache (K4: 4 slots x 256 cells, and a 4096-cell one)
D256_KERNELS = ("flash_attention_d256", "decode_attention_d256",
                "paged_decode_attention_d256",
                "paged_decode_attention_int8_d256", "flash_attention_fwd_d256",
                "flash_attention_bwd_dq_d256", "flash_attention_bwd_dkv_d256")
#: the training instances at d = 256, whose rows phase 2 makes at
#: ``TRAIN_ATTN_SHAPES``' head_dim 256 shapes
D256_TRAIN = ("flash_attention_fwd_d256", "flash_attention_bwd_dq_d256",
              "flash_attention_bwd_dkv_d256")
D256_K3_CASES = ((16, 16), (64, 16), (96, 16), (256, 16))
D256_K4_CASES = ((16, 256, (0, 37, 130, 255)),
                 (16, 4096, (511, 1500, 3000, 4095)))
#: #5 at d = 256 (K3's kernel with lse) at a prefill's (B, T = S); its
#: training shape (4 x 1024, phase 13's) is a ``TRAIN_ATTN_SHAPES`` row
D256_FWD_SHAPES = ((1, 64),)
#: gemma-7b's q / v projection: K = d_model, N = q_dim = kv_dim, r
GEMMA_QV = (3072, 4096, 8)


def d256_attention_rows(dev, rn):
    """K3 at d = 256 (``k3_rows`` at gemma-7b's heads), then #5 at d = 256
    against its plain version: output within 2e-2 abs + rel, lse within
    1e-3 absolute, two calls bit-identical (output and lse), its time, the
    plain version's and SDPA's in bf16 (its main row is phase 13's
    training shape, in ``phase_train_kernels``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = k3_rows(dev, rn, 16, 256, D256_K3_CASES, "_d256")
    name, h, d = "flash_attention_fwd_d256", 16, 256
    for b_, t in D256_FWD_SHAPES:
        q, k, v = rn(b_, t, h, d), rn(b_, t, h, d), rn(b_, t, h, d)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, True)
        err = compare(name, o, po)
        lse_err = float((lse - plse).abs().max())
        if not lse_err <= 1e-3:
            raise AssertionError(f"{name} lse: {lse_err:.3e} > 1e-3")
        o2, lse2 = fa.flash_attention_fwd(q, k, v, True)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: two calls differ")
        pairs = b_ * h * t * (t + 1) // 2
        bms, by = bound_ms(2 * 4 * b_ * t * h * d + 4 * b_ * h * t,
                           4 * d * pairs)
        lib = [x.transpose(1, 2) for x in (q, k, v)]
        rows.append(dict(
            name=name, shape=f"B={b_} T=S={t} H=KV={h} d={d} causal",
            main=False, max_abs_err=err, lse_err=lse_err,
            ms=cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                            [()]),
            plain_ms=event_time_ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, True), ()),
            library_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(*lib, is_causal=True),
                [()]),
            bound_ms=bms, bound_by=by))
        del q, k, v, o, lse, po, plse, o2, lse2, lib
    torch.cuda.empty_cache()
    return rows


def gemma_linear_rows(dev, rn):
    """K1 (M = 64 prompt rows) and #9, K2 (M = 4 slots) and #10 at
    gemma-7b's q / v projection (K = 3072 -> N = 4096, r = 8; W bf16, or
    int8 per output channel): ``qv_linear_rows``."""
    return qv_linear_rows(dev, rn, "gemma", (GEMMA_QV,), (
        ("tt_linear", 64), ("tt_linear_batched_a", 4), ("tt_linear_w8", 64),
        ("tt_linear_batched_a_w8", 4)))


def qv_linear_rows(dev, rn, tag, shapes, cases):
    """``cases`` ((kernel, M), ...) at each of a model's q / v projections
    ``shapes`` ((K, N, r), ...; W bf16, or int8 per output channel for #9
    / #10): each against its plain version at the linears' 1e-2, two
    calls bit-identical; its time, the plain version's, one library
    call's (torch.matmul; on a pre-dequantized bf16 W for #9 / #10) and
    its bound. Rows tagged ``tag``."""
    import torch
    from repro_torch.kernels import quant
    from repro_torch.kernels import tt_linear as tl
    alpha = 4.0
    rows = []
    for (k, n, r), (name, m) in ((sh_, c_) for sh_ in shapes
                                 for c_ in cases):
        batched, w8 = "batched" in name, name.endswith("w8")
        fn, plain = getattr(tl, name), getattr(tl, name + "_plain")

        def make():
            w = rn(k, n, scale=k ** -0.5)
            a = (rn(m, k, r, scale=k ** -0.5) if batched
                 else rn(r, k, scale=k ** -0.5).T)
            return (rn(m, k), *(quant.quantize_int8(w, 0) if w8 else (w,)),
                    a, rn(r, n, scale=r ** -0.5))
        nbytes = (2 * m * k + (k * n + 4 * n if w8 else 2 * k * n)
                  + 2 * (m if batched else 1) * k * r + 2 * r * n + 2 * m * n)
        sets = copies(make, nbytes)
        err = compare(name, fn(*sets[0], alpha), plain(*sets[0], alpha))
        same(lambda *t: fn(*t, alpha), sets[0], name)
        lib_sets = [(t[0], quant.dequantize({"q8": t[1], "scale": t[2]},
                                            torch.bfloat16), *t[3:])
                    if w8 else t for t in sets]

        def lib(x, w, a, b):
            xa = (torch.bmm(x[:, None], a)[:, 0] if batched
                  else torch.matmul(x, a))
            return torch.matmul(x, w) + alpha * torch.matmul(xa, b)
        bms, by = bound_ms(nbytes, 2 * m * k * n + 2 * m * k * r
                           + 2 * m * r * n)
        rows.append(dict(
            name=name, tag=tag, main=False,
            shape=f"{tag} q/v M={m} K={k} N={n} r={r}", max_abs_err=err,
            ms=cuda_time_ms(lambda *t: fn(*t, alpha), sets),
            plain_ms=cuda_time_ms(lambda *t: plain(*t, alpha), sets),
            library_ms=cuda_time_ms(lib, lib_sets),
            library=("torch.matmul on a pre-dequantized bf16 W + rank-r"
                     if w8 else "torch.matmul"),
            bound_ms=bms, bound_by=by))
        del sets, lib_sets
    torch.cuda.empty_cache()
    return rows


GRANITE, MISTRAL = "granite-34b", "mistral-large-123b"
#: the two models whose GQA groups lie outside {1, 2, 4, 8}: phase 2's
#: tag -> (arch, H, KV, d, q / v projections (K, N, r))
GQA_MODELS = {"granite": (GRANITE, 48, 1, 128, ((6144, 6144, 8),
                                                (6144, 128, 8))),
              "mistral": (MISTRAL, 96, 8, 128, ((12288, 12288, 8),
                                                (12288, 1024, 8)))}
#: K4's dense cache in those rows: 4 slots x 256 cells at these positions
GQA_K4_POS = (0, 37, 130, 255)


def gqa_attention_rows(dev, rn):
    """K4 (4 slots x 256 cells), #8 and #8q (8 slots, C = 1 and 32,
    34-page tables of 16) at granite-34b's H = 48 over KV = 1 (MQA,
    G = 48) and mistral-large's H = 96 over KV = 8 (G = 12), d = 128:
    each within 2e-2 of its plain version, two calls bit-identical, its
    bound and SDPA with ``enable_gqa`` as library."""
    rows = []
    for tag, (_, h, kv, d, _) in GQA_MODELS.items():
        rows += k4_rows(dev, rn, h, d, ((kv, 256, GQA_K4_POS),), tag=tag)
        rows += paged_kernel_rows(dev, rn, h, d, kv=kv, tag=tag)
        rows += paged_int8_kernel_rows(dev, rn, h, d, kv=kv, tag=tag)
    return rows


def gqa_linear_rows(dev, rn):
    """K1 (M = 64) and K2 (M = 4) at granite-34b's and mistral-large's
    q / v projections (6144 -> 6144 and -> 128; 12288 -> 12288 and ->
    1024; r = 8): ``qv_linear_rows``."""
    return [r_ for tag, (_, _, _, _, shapes) in GQA_MODELS.items()
            for r_ in qv_linear_rows(dev, rn, tag, shapes, (
                ("tt_linear", 64), ("tt_linear_batched_a", 4)))]


def check_launches(n, want, label):
    """``n`` (launch counts) equal to ``want`` wherever ``want`` names a
    kernel, and no kernel outside ``want`` launched."""
    bad = {k: (n.get(k, 0), w) for k, w in want.items() if n.get(k, 0) != w}
    extra = {k: v for k, v in n.items() if v and k not in want}
    if bad or extra:
        raise AssertionError(f"{label}: launches (got, want) {bad}; "
                             f"unexpected {extra}")


def logits_checked(label, rel, agree=None, n=None, tag="phase12",
                   witness=None):
    """A kernel-leg vs plain-leg logits check of phases 12, 14, 16 and
    21: 5% of the largest logit (bf16 drift through 8 to 88 layers),
    asserted. With ``witness`` (``legs_verdict``'s) phase 3's f32-witness
    rule is asserted as well: the kernel leg no farther from the f32
    plain leg than 2 x the bf16 plain leg + 5%. On a MoE model (the
    witness holds routing flips), while the witness holds, a miss of the
    5% limit is reported with the share of routing flips instead of
    failing: bf16 drift flips near-tie top-k routing, and one flip moves
    a token by a whole expert's share, in either bf16 leg. Without
    routing the 5% limit stands. The witness must be able to fail: its
    limit below 1, where a kernel leg of zeros sits (else the check fails
    as vacuous)."""
    tail = f", argmax equal {agree}/{n}" if agree is not None else ""
    print(f"[{tag}] {label}: logits vs plain leg max |kernel - plain| / "
          f"max |plain| {rel:.3e} (limit 5e-2){tail}", flush=True)
    flips = None if witness is None else witness[2]
    if not rel <= 5e-2 and flips is None:
        raise AssertionError(f"{label}: logits differ from the plain "
                             f"leg by {rel:.3e}")
    if witness is None:
        return
    k32, p32, _ = witness
    ok = k32 <= 2 * p32 + 5e-2
    print(f"[{tag}] {label}: vs the f32 plain leg kernel {k32:.3e}, plain "
          f"bf16 {p32:.3e} (limit 2 x plain + 5e-2 = {2 * p32 + 5e-2:.3e}): "
          f"witness {'holds' if ok else 'FAILS'}"
          + ("" if flips is None else "; top-k sets that differ, share of "
             "(token, layer) rows: " + ", ".join(
                 f"{k_} {v:.4f}" for k_, v in flips.items())), flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel leg {k32:.3e} from the f32 "
                             f"leg, plain bf16 {p32:.3e}")
    if not 2 * p32 + 5e-2 < 1:
        raise AssertionError(f"{label}: the witness is vacuous: plain bf16 "
                             f"{p32:.3e} from the f32 leg puts its limit at "
                             "or above a zero kernel leg's 1")
    if not rel <= 5e-2:
        print(f"[{tag}] {label}: the 5e-2 limit is missed ({rel:.3e}) with "
              f"the witness holding: reported, routing flips kernel/plain "
              f"{flips['kernel/plain']:.4f}", flush=True)


def cell_metrics(label, st, busy, tag="phase12"):
    """Phase 12's (and 14's) end-to-end numbers of one run, each on its
    own line."""
    steps = max(st.decode_steps, 1)
    for key, val in (
            ("tok/s", f"{st.tokens_per_s:.1f}"),
            ("step ms", f"{1e3 * st.decode_s / steps:.2f} over "
                        f"{st.decode_steps} steps"),
            ("prefill ms", f"{1e3 * st.prefill_s / st.prefills:.2f} a "
                           f"request" if st.prefills else "in-loop"),
            ("ttft ms", f"{1e3 * st.ttft_s:.1f}" if st.ttft_s
             else "not recorded by the dense engine (see prefill ms)"),
            ("kv_bytes_peak", f"{st.kv_bytes_peak}"),
            ("device busy", "not measured" if busy is None
             else f"{100 * busy:.1f}% (profiled)")):
        print(f"[{tag}] {label} {key}: {val}", flush=True)


def gemma_dense(dev, count, model):
    """Phase 12 (a): ``dense_cell`` on full-width gemma-7b with phase 3's
    8 requests (the d = 256 instances of K3 and K4)."""
    return dense_cell(dev, count, model, "phase12",
                      dense_requests(model[0]))


def attn_sfx(cfg):
    """The ``LAUNCHES`` suffix of ``cfg``'s attention instances: "_d256"
    (gemma-7b), "_d112" (kimi-k2) or ""."""
    return {256: "_d256", 112: "_d112"}.get(cfg.resolved_head_dim, "")


def dense_cell(dev, count, model, tag, reqs, new=32, label="(a) dense",
               check=True, profiled=True):
    """Phase 3's dense cell on a full-width model (phases 12, 14 and 16):
    4 slots x 256 cells, ``reqs`` requests of ``new`` tokens each; 2L K1
    + L K3 a prefill, 2L K2 + L K4 a decode step (their d = 256 instances
    at heads of 256; K1 in K2's place for an adapter without a task axis:
    phase 16's 4+ed), nothing else; the engine holds no second copy of
    the base (its allocation beyond the runtime's is at most 5% of the
    base's bytes); prefill and decode-step logits within 5% of the plain
    leg's largest logit (``logits_checked``; on a MoE model with the f32
    plain leg as witness, through an f32 engine at prefill). ``check``
    False leaves the logits to the caller (phase 17's deferred witness),
    ``profiled`` False the busy share unmeasured."""
    import torch
    from repro_torch.config.base import KernelConfig, ServeConfig
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime, Engine
    cfg, spec, params, rt, gen = model
    sfx = attn_sfx(cfg)
    k3, k4 = "flash_attention" + sfx, "decode_attention" + sfx
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32)
    base_b = sum(t.numel() * t.element_size()
                 for t in M.tensors(params["base"]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    print(f"[{tag}] {label}: the engine allocates {held / 1e9:.3f} GB "
          f"beside the runtime's {base_b / 1e9:.3f} GB of base (limit 5%: "
          "no second copy)", flush=True)
    if held > 0.05 * base_b:
        raise AssertionError(f"{label}: the engine holds {held} bytes "
                             "beside the base: a second copy")
    eng.generate([dataclasses.replace(reqs[0], max_new_tokens=2)])
    got = {}
    n = count(lambda: got.update(r=serve_checked(eng, reqs, label, tag,
                                                 new)))
    outs, st = got["r"]
    L, steps, pre = cfg.num_layers, st.decode_steps, st.prefills
    dec = "tt_linear_batched_a" if rt.tasked else "tt_linear"
    want = {"tt_linear": 2 * L * pre, k3: L * pre, k4: L * steps}
    want[dec] = want.get(dec, 0) + 2 * L * steps
    check_launches(n, want, label)
    k1 = (f"K1 {n['tt_linear'] // pre} + {k3} {n[k3] // pre} a prefill over "
          f"{pre}, K2 {n[dec] // steps} + {k4} {n[k4] // steps} a decode step"
          if rt.tasked else
          f"K1 {n['tt_linear']} over {pre} prefills and {steps} decode steps "
          f"(2L each, asserted), {k3} {n[k3] // pre} a prefill, {k4} "
          f"{n[k4] // steps} a decode step")
    print(f"[{tag}] {label}: launches "
          f"{json.dumps({k: v for k, v in n.items() if v})} = {k1} over "
          f"{steps} (L = {L})", flush=True)
    busy = device_share(f"{label} {cfg.name} generate of 4 requests",
                        lambda: eng.generate(reqs[:4]),
                        show=("paged_tc", "flash_fwd"))[1] if profiled \
        else None
    cell_metrics(label, st, busy, tag)
    if not check:
        return dict(reqs=reqs, stats=st, launches=n)
    ref = KernelConfig(backend="ref")
    engs = {"kernel": eng, "plain": Engine(cfg, rt, serve=serve, kernels=ref,
                                           device=dev)}
    if routed(cfg):
        engs["f32"] = Engine(f32_cfg(cfg), AdapterRuntime.build(
            "live", f32_tree(params["base"]), spec, params["adapter"],
            params["frozen"]), serve=serve, kernels=ref, device=dev)
    rel, agree, wit = legs_compared(lambda leg: torch.stack([
        engs[leg].prefill_logits(r.prompt, r.task) for r in reqs[:2]]),
        routed(cfg))
    logits_checked(f"{label} prefill, last position of 2 requests", rel,
                   agree, 2, tag, wit)
    del eng, engs
    torch.cuda.empty_cache()
    rel, agree, wit = decode_step_rel_err(cfg, rt, reqs[:4], serve.cache_len,
                                          dev)
    logits_checked(f"{label} one decode step of 4 slots (tasks "
                   f"{[r.task for r in reqs[:4]]})", rel, agree, 4, tag, wit)
    return dict(reqs=reqs, stats=st, launches=n)


def gemma_paged(dev, count, model, quant):
    """Phase 12 (b) (``quant`` False) and (c) (int8 weights and int8 KV):
    ``paged_cell`` on full-width gemma-7b (#8 / #8q at d = 256)."""
    from repro_torch.config.base import QuantConfig
    return paged_cell(dev, count, model, QuantConfig(
        weights="int8", kv="int8") if quant else None, "phase12",
        "(c) paged int8" if quant else "(b) paged fp")


def paged_picked(reqs):
    """The 4 of ``paged_requests`` whose prompts a paged-step check
    prefills: two short, the two longest."""
    return reqs[1:3] + sorted(reqs[3:], key=lambda r: len(r.prompt))[-2:]


def paged_cell(dev, count, model, quant, phase, tag, check=True,
               profiled=True):
    """Phase 4's paged cell on a full-width model (phases 12, 14, 16) — 8
    slots, 256 blocks of 16 cells, chunk 32, 16 requests of 40-300 prompt
    tokens, half sharing a 100-token prefix per task, cold then warm,
    under ``quant`` (a QuantConfig with int8 KV, or None for bf16 pools):
    L #8 (#8q; their d = 256 instances at heads of 256) an engine step and
    nothing else (the (B, 32) adapted q/v run the batched einsum, as in
    JAX); every request finished, no leaked block, warm prefix hits and
    COW; a pure-decode and a mixed paged step within 5% of the plain leg's
    largest logit (``logits_checked``, with the f32 witness on a MoE
    model; ``check`` and ``profiled`` as ``dense_cell``'s). Returns
    (kv_bytes_peak, the int8 base or None)."""
    import torch
    from repro_torch.config.base import QuantConfig, ServeConfig
    from repro_torch.models import model as M
    from repro_torch.serving import Engine
    cfg, spec, params, rt, gen = model
    q8 = quant is not None
    name = ("paged_decode_attention_int8" if q8 else "paged_decode_attention"
            ) + attn_sfx(cfg)
    eng = Engine(cfg, rt, serve=ServeConfig(
        cache_mode="paged", quant=quant if q8 else QuantConfig(), **PAGED),
        device=dev)
    pool_gb = sum(t.numel() * t.element_size() for c in eng._paged_caches
                  for t in c["self"].values()) / 1e9
    base_gb = sum(t.numel() * t.element_size()
                  for t in M.tensors(eng.base_weights)) / 1e9
    print(f"[{phase}] {tag}: served base {base_gb:.3f} GB, K/V pools "
          f"{pool_gb:.3f} GB for {eng.sv.resolved_num_blocks} blocks",
          flush=True)
    reqs = paged_requests(cfg)
    kv_peak, total, runs = 0, {}, {}
    for label in ("cold", "warm"):
        got = {}
        n = count(lambda: got.update(r=serve_checked(
            eng, reqs, f"{tag} {label}", phase)))
        st = runs[label] = got["r"][1]
        kv_peak = max(kv_peak, st.kv_bytes_peak)
        check_launches(n, {name: cfg.num_layers * st.decode_steps},
                       f"{tag} {label}")
        for k_, v_ in n.items():
            total[k_] = total.get(k_, 0) + v_
    if not (st.prefix_hit_tokens > 0 and st.cow_copies >= 1):
        raise AssertionError(f"{tag} warm: no prefix hit or no COW copy")
    print(f"[{phase}] {tag}: launches over cold and warm "
          f"{json.dumps({k: v for k, v in total.items() if v})} ({name} "
          f"L = {cfg.num_layers} an engine step); kv_bytes_peak {kv_peak}",
          flush=True)
    busy = device_share(f"{tag} {cfg.name} generate of 16 requests "
                        "(warm)", lambda: eng.generate(reqs), top_n=12,
                        show=("paged_tc",))[1] if profiled else None
    cell_metrics(f"{tag} cold", runs["cold"], None, phase)
    cell_metrics(f"{tag} warm", runs["warm"], busy, phase)
    w8 = q8 and quant.weights == "int8"
    qbase = eng.base_weights if w8 else None
    if w8:
        unadapted_projection_cost(cfg, qbase, dev)
    del eng
    torch.cuda.empty_cache()
    if not check:
        return kv_peak, qbase
    picked = paged_picked(reqs)
    res = paged_step_rel_err(cfg, rt, [r.prompt for r in picked],
                             [r.task for r in picked], dev, base=qbase,
                             kv_quant=q8)
    for step, (rel, agree, wit) in res.items():
        logits_checked(f"{tag}: one {step} paged step of 4 slots", rel,
                       agree, 4, phase, wit)
    return kv_peak, qbase


def w8_dense_cell(dev, count, model, dense, qbase, tag="phase12",
                  label="(c) dense w8", check=True):
    """Phases 12 (c) and 16 (a), dense part: the dense cell's requests
    through the dense engine over int8 weights (phase 5's): 2L #9 + L K3
    a prefill, 2L #10 + L K4 a decode step (their d = 256 instances at
    heads of 256), no K1 / K2; one decode step over the int8 base within
    5% of the plain leg's largest logit (``logits_checked``, with the f32
    witness on a MoE model; ``check`` as ``dense_cell``'s). Returns the
    run's stats."""
    import torch
    from repro_torch.config.base import KernelConfig, QuantConfig, \
        ServeConfig
    from repro_torch.serving import Engine
    cfg, spec, params, rt, gen = model
    sfx = attn_sfx(cfg)
    eng = Engine(cfg, rt, serve=ServeConfig(
        cache_mode="dense", max_batch=4, cache_len=256, out_cap=32),
        kernels=KernelConfig(quant=QuantConfig(weights="int8")), device=dev)
    reqs = dense["reqs"]
    eng.generate(reqs[:2])                       # warm-up (allocator)
    got = {}
    n = count(lambda: got.update(r=serve_checked(eng, reqs, label, tag)))
    st = got["r"][1]
    L, steps, pre = cfg.num_layers, st.decode_steps, st.prefills
    check_launches(n, {"tt_linear_w8": 2 * L * pre,
                       "flash_attention" + sfx: L * pre,
                       "tt_linear_batched_a_w8": 2 * L * steps,
                       "decode_attention" + sfx: L * steps}, label)
    print(f"[{tag}] {label}: launches "
          f"{json.dumps({k: v for k, v in n.items() if v})} (#9 "
          f"{n['tt_linear_w8'] // pre} a prefill, #10 "
          f"{n['tt_linear_batched_a_w8'] // steps} a decode step)",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    if not check:
        return st
    rel, agree, wit = decode_step_rel_err(cfg, rt, reqs[:4], 256, dev,
                                          base=qbase)
    logits_checked(f"{label}: one decode step of 4 slots", rel, agree, 4,
                   tag, wit)
    return st


def phase_twelve(dev):
    """Phase 12: full-width gemma-7b (3072, 16 heads of 256, GeGLU
    24576, vocab 256000, bf16; ``GEMMA_SERVE_LAYERS`` of its 28 layers)
    with a 4+1d MetaTT q/v adapter (rank 8, 3 tasks) at 0.25 of the base
    q projection, served through (a) the dense
    engine, (b) the paged engine cold then warm and (c) int8 weights and
    int8 KV (paged, then the dense engine over int8 weights). Each cell
    builds the model from the seed and frees it before the next; launches
    are counted around each driven run and summed."""
    import torch
    from repro_torch import kernels as K
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    def cell(label, fn):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = serving_model(dev, "phase12", GEMMA, SERVED_RATIO,
                              layers=GEMMA_SERVE_LAYERS)
        torch.cuda.reset_peak_memory_stats(dev)   # serving, not the init
        out = fn(model)
        del model
        torch.cuda.synchronize()
        print(f"[phase12] {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB",
              flush=True)
        secs.append(time.perf_counter() - t0)
        return out

    secs = []
    dense = cell("(a) dense", lambda m: gemma_dense(dev, count, m))
    fp_peak, _ = cell("(b) paged fp",
                      lambda m: gemma_paged(dev, count, m, False))

    def int8_cell(m):
        q_peak, qbase = gemma_paged(dev, count, m, True)
        w8_dense_cell(dev, count, m, dense, qbase)
        return q_peak
    q_peak = cell("(c) int8", int8_cell)
    print(f"[phase12] (c) kv_bytes_peak int8 {q_peak} against fp {fp_peak} "
          f"({q_peak / fp_peak:.3f}x)", flush=True)
    if not q_peak < fp_peak:
        raise AssertionError(f"(c) int8 kv_bytes_peak {q_peak} not below "
                             f"(b)'s {fp_peak}")
    print(f"[phase12] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; (a) "
          f"{secs[0]:.1f} s, (b) {secs[1]:.1f} s, (c) {secs[2]:.1f} s",
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 13: gemma-7b trained at full width through the head_dim 256
# instances of #5, #6 and #7
# ---------------------------------------------------------------------------


#: the adapted matrices each mixer runs through K1, and those of them that
#: read a layer's (normed) input: in layer 0 that input is the embedding,
#: which needs no gradient, so their dx is never computed
K1_MATRICES = {"attn": ("attn_q", "attn_k", "attn_v", "attn_o"),
               "mamba": ("mamba_in", "mamba_out"),
               "mlstm": ("mlstm_q", "mlstm_v", "mlstm_o"),
               "slstm": ("slstm_z", "slstm_o")}
INPUT_MATRICES = ("attn_q", "attn_k", "attn_v", "mamba_in", "mlstm_q",
                  "mlstm_v", "slstm_z")


def bf16_train_per_step(cfg, types=("attn_q", "attn_v")):
    """bf16 launches a training step (remat per block), as
    ``f32_train_per_step``: K1 for each adapted linear (``types``) in the
    forward, again in the recompute and as dx in the backward — 3 a
    linear, less layer 0's linears that read its input (6L - 2 on an
    attention model with q / v adapted; 47 on one jamba super-block with
    q / v and mamba in / out; ``moe_down`` is plain PyTorch); #5 twice
    and #6 and #7 once an attention (under ``_d256`` / ``_d112`` at
    head_dim 256 / 112). An encoder-decoder's decoder layer holds two
    attentions, self and cross (``xattn_*``, 3 K1 a linear: its inputs
    need gradients); its encoder is not rematerialised (as in JAX): 2 K1
    an adapted linear (forward, dx) less encoder layer 0's input linears
    (the frames need no gradient), and one #5, #6 and #7 a layer.
    Returns (launches a step, #5 calls a step by ``flash_kind``)."""
    layers = [m for m, _ in cfg.block_pattern] * cfg.num_super_blocks
    cross = [t for t in types if cfg.is_encdec and t.startswith("xattn_")]
    linears = [[t for t in types if t in K1_MATRICES.get(m, ())]
               for m in layers]
    k1 = 3 * (sum(map(len, linears)) + len(cross) * len(layers)) - sum(
        t in INPUT_MATRICES for t in linears[0])
    n_self = layers.count("attn")
    n_cross = n_self if cfg.is_encdec else 0
    n = n_self + n_cross
    enc = cfg.encoder_layers if cfg.is_encdec else 0
    if enc:
        selfs = [t for t in types if t in K1_MATRICES["attn"]]
        k1 += 2 * len(selfs) * enc - sum(t in INPUT_MATRICES for t in selfs)
    sfx = {256: "_d256", 112: "_d112"}.get(cfg.resolved_head_dim, "")
    return ({"tt_linear": k1, "flash_attention_fwd" + sfx: 2 * n + enc,
             "flash_attention_bwd_dq" + sfx: n + enc,
             "flash_attention_bwd_dkv" + sfx: n + enc},
            {"encoder": enc, "decoder": 2 * n_self, "cross": 2 * n_cross})


def flash_kind(causal, t, s):
    """The kind of a train / prefill / cross attention call."""
    if causal:
        return "decoder"
    return "encoder" if t == s else "cross"


@contextlib.contextmanager
def flash_kinds():
    """Counts the flash-route attention calls of the train / prefill /
    cross branch (``models/attention.py::_prefill_attend``) by kind
    (``flash_kind``) and shape, where the policy routes them to K3 / #5:
    {(kind, T, S): calls}."""
    from repro_torch.models import attention as A
    tally, inner = collections.Counter(), A._prefill_attend

    def counting(q, k, v, ctx, causal, scale):
        if A._flash_ok(ctx) and (not causal or q.shape[1] == k.shape[1]):
            tally[(flash_kind(causal, q.shape[1], k.shape[1]), q.shape[1],
                   k.shape[1])] += 1
        return inner(q, k, v, ctx, causal, scale)
    A._prefill_attend = counting
    try:
        yield tally
    finally:
        A._prefill_attend = inner


def kinds_checked(tally, want, label):
    """``flash_kinds``' tally summed by kind equal to ``want`` ({kind:
    calls})."""
    got = collections.Counter()
    for (kind, _, _), n in tally.items():
        got[kind] += n
    if dict(got) != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: flash calls by kind {dict(got)}, "
                             f"want {want}")
    print(f"[{label.split()[0]}] {label}: flash-route calls by kind and "
          "(T, S): " + ", ".join(f"{k} T={t} S={s_} {n}" for (k, t, s_), n
                                  in sorted(tally.items())), flush=True)


def first_layers(base, cfg, layers):
    """``cfg`` cut to its first ``layers`` layers and the base's stacked
    leaves sliced to them (views: no copy)."""
    from repro_torch.tree import tree_map
    cut = dataclasses.replace(cfg, num_layers=layers)
    nb = cut.num_super_blocks
    return cut, dict(base, blocks=[tree_map(lambda t: t[:nb], blk)
                                   for blk in base["blocks"]])


def base_fingerprint(base):
    """Each leaf's sum in f64, over chunks of 2^26 values in order (no
    full-size f64 copy): equal for two bases that hold the same values,
    whatever their dtypes."""
    from repro_torch.models import model as M
    return [sum(float(p.double().sum()) for p in t.reshape(-1).split(1 << 26))
            for t in M.tensors(base)]


def rebuilt_f32_base(dev, cfg, spec, dtypes, prints, tag, seed=SEED):
    """The f32 witness base, built once the bf16 base is freed (a large
    model's f32 base cannot sit beside its bf16 one): ``witness_base``
    from ``seed``, its values held to the bf16 base's ``base_fingerprint``
    ``prints``; prints its size and build time."""
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    base32 = witness_base(dev, cfg, spec, dtypes, seed=seed)
    torch.cuda.synchronize()
    if base_fingerprint(base32) != prints:
        raise AssertionError(f"{tag}: the rebuilt f32 base does not hold "
                             "the bf16 base's values")
    print(f"[{tag}] f32 witness base: "
          f"{sum(t.numel() * 4 for t in M.tensors(base32)) / 1e9:.3f} GB in "
          f"{time.perf_counter() - t0:.1f}s, value for value the bf16 "
          "base's (per-leaf f64 sums equal)", flush=True)
    return base32


def deferred_grad_check(dev, cfg, run, holder, tokens, tag, layers=None,
                        extra=None, f32_limits=None):
    """``train_full_width``'s B = 1 gradient check on the first ``layers``
    layers (default all) of the trained base, ``grad_check``'s legs and
    limits with the f32 witness leg deferred past the bf16 base's life:
    the plain and kernel bf16 legs over ``holder["base"]``, their losses
    and gradients kept; the bf16 base freed (``holder`` holds the last
    reference); the f32 base rebuilt value for value from the trainer's
    seed (``rebuilt_f32_base``); then the f32 leg and ``grad_verdict``.
    The legs share the plain leg's MoE routing (``grad_legs``; ``extra``:
    its batch entries besides the tokens). With ``f32_limits``, an f32
    kernel leg (the f32 instances) on the f32 base too, held to the f32
    leg by ``f32_grad_verdict`` at those limits. Prints the peak memory of
    each part."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    base = holder.pop("base")
    gcfg, gbase = cfg, base
    if layers is not None and layers < cfg.num_layers:
        gcfg, gbase = first_layers(base, cfg, layers)
    spec = M.build_adapter_spec(dataclasses.replace(run, model=gcfg))
    adapter = mild_adapter(spec, torch.Generator(device=dev).manual_seed(
        SEED + 2), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    routing = {}
    legs = grad_legs((("plain", gcfg, gbase, dispatch.REF),
                      ("kernel", gcfg, gbase, dispatch.DEFAULT)),
                     spec, adapter, None, tokens, dev, routing, extra)
    print(f"[{tag}] gradient check, the bf16 legs: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    dtypes = [t.dtype for t in M.tensors(base)]
    prints = base_fingerprint(base)
    del base, gbase
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base32 = rebuilt_f32_base(dev, cfg, M.build_adapter_spec(run), dtypes,
                              prints, tag, seed=run.train.seed)
    if gcfg is not cfg:
        base32 = first_layers(base32, cfg, layers)[1]
    legs.update(grad_legs(
        (("f32", f32_cfg(gcfg), base32, dispatch.REF),)
        + ((("f32 kernel", f32_cfg(gcfg), base32, dispatch.DEFAULT),)
           if f32_limits else ()),
        spec, adapter, None, tokens, dev, routing, extra))
    del base32
    gc.collect()
    torch.cuda.empty_cache()
    grad_verdict(legs, adapter, tokens, tag)
    if f32_limits:
        f32_grad_verdict(legs["f32 kernel"], legs["f32"], tokens, tag,
                         f32_limits)
    print(f"[{tag}] {cfg.name} gradient check (f32 leg deferred) at "
          f"{gcfg.num_layers} layers: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB (the f32 "
          f"witness base and its leg)", flush=True)


def train_full_width(dev, cfg, tag, grad_layers=None, variant="4d",
                     steps=6, f32_grad_limits=None, profile=True):
    """Phase 6's setting on full-width ``cfg`` at its depth — MetaTT 4d on
    its default matrices (q/v; ``variant="4+ed"``: MetaTT-(4+E)D on q, v
    and the MoE expert down-projections) from rank 10, AdamW lr 1e-3,
    remat per block, LMStream batches of 4 x 1024 tokens (an enc-dec
    model's with 4 x encoder_seq stub frames; a prefix model's of 4 x
    (frontend_seq patch embeddings + 1024 - frontend_seq tokens), under
    the prefix loss: ``FrameStream``), ``steps``
    steps of 3 per epoch with one DMRG sweep to rank 8 after step 3:
    finite losses, moved cores, ranks 8 after the sweep, exactly
    ``bf16_train_per_step`` launches (an enc-dec model's #5 calls by kind
    too) a step and nothing else; the median step, tokens/s, peak memory
    and, with ``profile``, the busy share and the top device operations
    over one more step; then, with the trainer freed, the B = 1 gradient
    check against the plain bf16 leg with an f32 plain leg as witness, on
    the first ``grad_layers`` layers of the same base (default all), the
    f32 leg after the bf16 base is freed (``deferred_grad_check``;
    ``f32_grad_limits``: the f32 kernel leg too), with its peak memory.
    Returns the steps' launches."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import OptimizerConfig, RunConfig, \
        TrainConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.core.dmrg import RankSchedule
    from repro_torch.data import LMStream
    from repro_torch.models import model as M
    from repro_torch.train import Trainer

    L = cfg.num_layers
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant=variant,
                    adapter_rank=10, optimizer=OptimizerConfig(lr=1e-3),
                    train=TrainConfig(remat="block", seed=SEED))
    batch, seq = 4, 1024
    prefix = cfg.frontend_seq if cfg.frontend == "patch_stub" else 0
    data = LMStream(vocab_size=cfg.vocab_size, seq_len=seq - prefix,
                    batch=batch, seed=0, branching=2)
    if cfg.is_encdec or prefix:
        data = FrameStream(data, cfg)
    t0 = time.perf_counter()
    tr = Trainer(run=run, data=data, total_steps=steps, steps_per_epoch=3,
                 rank_schedule=RankSchedule.linear(10, 8, start_epoch=1,
                                                   every=1, step=2),
                 device=dev,
                 on_metrics=lambda s_, m: print(
                     f"[{tag}] step {s_} loss {m['loss']:.6f} grad_norm "
                     f"{m['grad_norm']:.4e} lr {m['lr']:.3e} "
                     f"{1e3 * m['step_time_s']:.1f} ms", flush=True))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in M.tensors(tr.base))
    print(f"[{tag}] {cfg.name} ({L} x {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.resolved_head_dim} over {cfg.num_kv_heads}, "
          f"{cfg.param_dtype}; {nbytes / 1e9:.3f} GB of base) MetaTT "
          f"{variant} {'/'.join(tr.spec.cfg.matrix_types)} rank "
          f"{ttlib.ranks(tr.state.adapter['cores'])}, remat per "
          f"block, B={batch} T={seq}: init {time.perf_counter() - t0:.1f}s",
          flush=True)
    before = float(ttlib.tt_norm(tr.state.adapter["cores"]))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with flash_kinds() as kinds:
        tr.train()
        torch.cuda.synchronize()
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = tr.losses()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag} {cfg.name}: non-finite loss {losses}")
    ranks = ttlib.ranks(tr.state.adapter["cores"])
    if set(ranks) != {8} or tr._dmrg_applied != [1]:
        raise AssertionError(f"{tag} {cfg.name}: ranks after the sweep "
                             f"{ranks}, sweeps at epochs {tr._dmrg_applied}")
    after = float(ttlib.tt_norm(tr.state.adapter["cores"]))
    if not (before == 0.0 and after > 0.0):
        raise AssertionError(f"{tag} {cfg.name}: the adapter did not move: "
                             f"||ΔW|| {before} -> {after}")
    per_step, per_kind = bf16_train_per_step(cfg, tr.spec.cfg.matrix_types)
    if cfg.is_encdec:
        kinds_checked(kinds, {k_: v * steps for k_, v in per_kind.items()},
                      f"{tag} {cfg.name} training ({steps} steps)")
    check_launches(launches, {k_: v * steps for k_, v in per_step.items()},
                   f"{tag} {cfg.name}")
    step_ms = [1e3 * m["step_time_s"] for _, m in tr.history[1:]]
    med = float(np.median(step_ms))
    print(f"[{tag}] {cfg.name} launches during train ({steps} steps): "
          f"{json.dumps({k_: v for k_, v in launches.items() if v})} = "
          + ", ".join(f"{k_} {v} a step" for k_, v in per_step.items())
          + "; nothing else", flush=True)
    print(f"[{tag}] {cfg.name} losses "
          f"{[round(float(x), 6) for x in losses]}; median step {med:.1f} ms "
          f"after step 1 (steps {[round(x, 1) for x in step_ms]}); "
          f"{batch * seq / (med / 1e3):.1f} tokens/s; max_memory_allocated "
          f"{peak:.3f} GB; ranks {ranks}; ||ΔW|| {before:.3e} -> "
          f"{after:.3e}", flush=True)
    if profile:   # one more step (past total_steps: lr 0)
        device_share(f"{tag}: one {cfg.name} training step at {L} layers",
                     lambda: tr.train(steps + 1), top_n=12,
                     show=("flash_bwd", "flash_fwd", "tt_linear"))
    last = next(data)
    tokens = torch.as_tensor(last["tokens"][:1], device=dev)
    extra = {k_: torch.as_tensor(last[k_][:1], device=dev)
             for k_ in ("enc_embeds", "embeds") if k_ in last} or None
    holder = {"base": tr.base}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    deferred_grad_check(dev, cfg, run, holder, tokens, tag, grad_layers,
                        extra, f32_grad_limits)
    return launches


class FrameStream:
    """An LM stream whose batches also carry an enc-dec model's stub frame
    embeddings ``enc_embeds`` (B, encoder_seq, d_model), or a VLM's stub
    patch embeddings ``embeds`` (B, frontend_seq, d_model) prepended to
    the tokens: f32, unit normal, drawn from the stream's step and
    ``SEED``."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def __next__(self):
        rng = np.random.default_rng((SEED, self.stream.state()["step"]))
        out = next(self.stream)
        key, n = (("enc_embeds", self.cfg.encoder_seq) if self.cfg.is_encdec
                  else ("embeds", self.cfg.frontend_seq))
        out[key] = rng.standard_normal(
            (out["tokens"].shape[0], n, self.cfg.d_model), dtype=np.float32)
        return out

    def __iter__(self):
        return self

    def state(self):
        return self.stream.state()

    def restore(self, state):
        self.stream.restore(state)


def phase_thirteen(dev):
    """Phase 13: the port's Trainer on full-width gemma-7b in phase 6's
    setting (``train_full_width``): exactly 6L - 2 K1, 2L #5d, L #6d and
    L #7d launches a step and nothing else; the gradient check's f32
    witness has a base of 34.2 GB alone: the trainer is freed first."""
    from repro_torch import configs
    return train_full_width(dev, configs.get_config(GEMMA), "phase13")


# ---------------------------------------------------------------------------
# phase 14: granite-34b (MQA, G = 48) and mistral-large-123b (G = 12)
# served at full width through the any-group instances of K4, #8 and #8q
# ---------------------------------------------------------------------------

#: phase 14's depths of 88, each model built once for its three cells.
#: granite-34b's 33.66 B bf16 parameters (67.3 GB) fit the card whole; it
#: runs at 8 layers (6.4 GB; its dense cell ran at 44, 34 GB, and its
#: paged cells at 16 until phases 20-21 needed the time). mistral-large's
#: 122.2 B do not fit: its cells keep its widths at 8.
GQA_DEPTHS = {GRANITE: 8, MISTRAL: 8}
GQA_NEW = 16                  # new tokens a request of the dense cell
#: the kernels each phase-14 cell must launch
GQA_KERNELS = ("decode_attention", "paged_decode_attention",
               "paged_decode_attention_int8")


def gqa_requests(cfg):
    """The dense cell's 4 mixed-task requests: 16-96 prompt tokens over 3
    tasks, ``GQA_NEW`` new each."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED + 41)
    return [Request(rng.randint(0, cfg.vocab_size, size=int(n)), GQA_NEW,
                    task=i % 3)
            for i, n in enumerate(rng.randint(16, 97, size=4))]


def phase_fourteen(dev):
    """Phase 14: granite-34b (88 x 6144, 48 heads of 128 over one KV head,
    gelu 24576, vocab 49152) and mistral-large-123b (12288, 96 heads of
    128 over 8, SwiGLU 28672, vocab 32768) in bf16 with a 4+1d MetaTT q/v
    adapter (rank 8, 3 tasks) at 0.25 of the base q projection — the v
    adapter 6144 -> 128 and 12288 -> 1024 — served through K4, #8 and #8q
    at G = 48 and 12: per model (a) the dense cell (the engine must hold
    no second base), (b) the paged cell cold then warm and (c) the same
    with int8 KV pools (#8q, kv_bytes_peak below (b)'s), at
    ``GQA_DEPTHS``; exact launches a step,
    the paged invariants, logits within 5% of the plain leg's largest;
    tok/s, step ms, prefill ms, busy share and peak memory a cell. Each
    model is built from the seed and freed before the next."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import QuantConfig
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    def cell(label, arch, layers, fn):
        # earlier phases' objects in reference cycles (a Trainer, an
        # Engine) keep their tensors until a collection: granite's 34 GB
        # needs them gone
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[phase14] {label}: {torch.cuda.memory_allocated(dev) / 1e9:.3f}"
              " GB allocated before the build", flush=True)
        t0 = time.perf_counter()
        model = serving_model(dev, "phase14", arch, SERVED_RATIO,
                              layers=layers)
        torch.cuda.reset_peak_memory_stats(dev)   # serving, not the init
        out = fn(model)
        del model
        torch.cuda.synchronize()
        print(f"[phase14] {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB",
              flush=True)
        secs[label] = time.perf_counter() - t0
        return out

    def served(arch, m, dense):
        """The cells of one model: (a) when ``dense``, then (b) and (c);
        each cell's launches of ``GQA_KERNELS`` must be above 0."""
        short = arch.split("-")[0]
        out = {}
        if dense:
            out["a"] = dense_cell(dev, count, m, "phase14", gqa_requests(
                m[0]), GQA_NEW, f"{short} (a) dense")["launches"]
        before = dict(total)
        fp_peak, _ = paged_cell(dev, count, m, None, "phase14",
                                f"{short} (b) paged fp")
        out["b"] = {k_: v - before.get(k_, 0) for k_, v in total.items()}
        before = dict(total)
        q_peak, _ = paged_cell(dev, count, m, QuantConfig(kv="int8"),
                               "phase14", f"{short} (c) paged int8 KV")
        out["c"] = {k_: v - before.get(k_, 0) for k_, v in total.items()}
        print(f"[phase14] {short} (c) kv_bytes_peak int8 {q_peak} against "
              f"fp {fp_peak} ({q_peak / fp_peak:.3f}x)", flush=True)
        if not q_peak < fp_peak:
            raise AssertionError(f"{short} (c): int8 kv_bytes_peak {q_peak} "
                                 f"not below (b)'s {fp_peak}")
        return out

    runs = {}
    for arch in (GRANITE, MISTRAL):
        short = arch.split("-")[0]
        runs.update({f"{short} ({k_})": v for k_, v in cell(
            f"{short} (a)-(c)", arch, GQA_DEPTHS[arch],
            lambda m, a_=arch: served(a_, m, True)).items()})
    for label, n in runs.items():
        want = GQA_KERNELS[0 if "(a)" in label else
                           1 if "(b)" in label else 2]
        if not n.get(want):
            raise AssertionError(f"phase 14 {label}: {want} not launched")
    print(f"[phase14] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 15: granite-34b (MQA, G = 48) and mistral-large-123b (G = 12)
# trained at full width through the any-group #6 and #7
# ---------------------------------------------------------------------------

#: phase 15's depths of 88: (training, gradient check). granite at 16
#: layers holds 13 GB of bf16 base, mistral at 8 holds 23.8 GB; mistral's
#: gradient check runs on the first 4 of its 8: at 8 its f32 witness
#: (47.6 GB) beside the bf16 base and the three legs does not fit 80 GB
GQA_TRAIN_DEPTHS = {GRANITE: (16, 16), MISTRAL: (8, 4)}


def phase_fifteen(dev):
    """Phase 15: the port's Trainer on granite-34b (6144, 48 heads of 128
    over one KV head: MQA, G = 48; gelu 24576) and mistral-large-123b
    (12288, 96 heads of 128 over 8: G = 12; SwiGLU 28672) at full width,
    cut in depth to ``GQA_TRAIN_DEPTHS``, in phase 6's setting
    (``train_full_width``): 6L - 2 K1, 2L #5, L #6 and L #7 launches a step
    and nothing else, #7 in slabs of the group where the unsplit grid
    would leave the SMs short (``dkv_slab_heads``: granite); finite,
    moving losses, ranks 8 after the sweep; step ms, tokens/s, peak
    memory, busy share, the top device operations; then the B = 1
    gradient check with its f32 witness. Each model is built from the
    seed and freed before the next."""
    import torch
    from repro_torch import configs
    total, secs = {}, {}
    for arch, (layers, grad_layers) in GQA_TRAIN_DEPTHS.items():
        # earlier phases' objects in reference cycles keep their tensors
        # until a collection
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[phase15] {arch}: "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated "
              "before the build", flush=True)
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
        n = train_full_width(dev, cfg, "phase15", grad_layers)
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        secs[arch] = time.perf_counter() - t0
    print(f"[phase15] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 16: granite-moe-1b (32 experts, top-8) served and trained at full
# width; MetaTT-(4+E)D on its expert down-projections
# ---------------------------------------------------------------------------

GRANITE_MOE = "granite-moe-1b-a400m"


def moe_routing_check(dev, model, reqs, tag="phase16"):
    """Phase 16 (b): under phase 3's mild adapter (random MetaTT cores at
    ``random_tt(0.12)`` on the served model's base), the kernel leg
    against the plain leg (``backend="ref"``) and an f32 plain leg on the
    same weights: the last-position prefill logits of 2 requests (the
    model's forward) and one decode step of 4 slots, each held by
    ``logits_checked`` with its witness. Returns the readings."""
    import torch
    from repro_torch.core import tt as ttlib
    from repro_torch.serving import AdapterRuntime
    cfg, spec, params, _, gen = model
    rt = AdapterRuntime.build("live", params["base"], spec, {
        "cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                 device=dev)}, params["frozen"])
    print(f"[{tag}] (b) mild adapter: adapter/base q-projection ratio "
          f"{q_ratio(cfg, rt, gen):.3e}", flush=True)
    out = {}
    for i, r in enumerate(reqs[:2]):
        out[f"(b) prefill logits, request {i}"] = (*legs_compared(
            lambda leg: prefill_leg(leg, cfg, rt, rt.base, r, dev), True), 1)
    torch.cuda.empty_cache()
    out["(b) one decode step of 4 slots"] = (
        *decode_step_rel_err(cfg, rt, reqs[:4], 256, dev), 4)
    for label, (rel, agree, wit, n) in out.items():
        logits_checked(label, rel, agree, n, tag, wit)
    return out


def expert_banks_unquantized(qbase, tag="phase16"):
    """The int8 base of a MoE model: the attention projections packed,
    every expert bank, shared expert and router left at full precision
    (as the JAX package's allowlist does). Prints the packed and the fp
    bytes."""
    from repro_torch.models import model as M
    packed = fp = 0
    for blk in qbase["blocks"]:
        for name, w in blk["ffn"].items():
            if isinstance(w, dict):
                raise AssertionError(f"(a) int8: MoE leaf {name} quantized")
        for grp in blk.values():
            for w in grp.values():
                ts = M.tensors(w)
                n_ = sum(t.numel() * t.element_size() for t in ts)
                if isinstance(w, dict):
                    packed += n_
                else:
                    fp += n_
    fp += sum(t.numel() * t.element_size() for t in M.tensors(
        [qbase["embed"], qbase["final_norm"]]))
    print(f"[{tag}] (a) int8 base: {packed / 1e9:.3f} GB packed (attention "
          f"q/k/v/o int8 + scales), {fp / 1e9:.3f} GB at full precision "
          "(expert banks, routers, norms, embedding): no expert bank "
          "quantized", flush=True)


#: phase 16's served cells (a)-(b) run 12 of granite-moe-1b's 24 layers
#: (widths kept) for the script's time; (c) trains all 24. Not 6: there
#: the plain bf16 leg sits 7.9e-3 from f32 while the kernel leg's own
#: routing flips 10.8% of top-8 sets, and (b)'s witness (2 x plain + 5%)
#: fails on routing, not numerics (H100 80GB HBM3, 700 W)
GRANITE_MOE_SERVE_LAYERS = 12


def phase_sixteen(dev):
    """Phase 16: full-width granite-moe-1b-a400m (24 x 1024, 16 heads of
    64 over 8, 32 experts of SwiGLU 512, top-8 at capacity factor 2.0,
    vocab 49155, bf16; f32 routers) through the MoE FFN of
    ``models/moe.py`` (plain PyTorch around the capacity dispatch, as the
    JAX package's einsums are) and every attention-side kernel at G = 2.
    (a) served at ``GRANITE_MOE_SERVE_LAYERS`` of its 24 layers with a
    4+1d MetaTT q/v adapter (rank 8, 3 tasks) at 0.25
    of the base q projection through the dense cell, the paged cell cold
    then warm, int8 weights + int8 KV (paged, then the dense engine over
    int8 weights; no expert bank quantized), then a 4+ed q/v +
    ``moe_down`` adapter (no task axis) through the dense cell, each
    cell's kernel-vs-plain logits held by ``logits_checked`` with the f32
    plain leg as witness (bf16 drift flips MoE routing); (b) the same
    checks under phase 3's mild adapter (``moe_routing_check``);
    (c) trained in phase 6's setting with MetaTT 4+ed on q, v and
    moe_down (142 K1, 48 #5, 24 #6, 24 #7 a step and nothing else: the
    moe_down delta is plain PyTorch), then the B = 1 gradient check. Each
    part builds the model from the seed after a collection and frees it."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.config.base import QuantConfig
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    def part(label, fn, variant="4+1d"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = serving_model(dev, "phase16", GRANITE_MOE, SERVED_RATIO,
                              layers=GRANITE_MOE_SERVE_LAYERS,
                              variant=variant)
        torch.cuda.reset_peak_memory_stats(dev)   # serving, not the init
        out = fn(model)
        del model
        torch.cuda.synchronize()
        print(f"[phase16] {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB",
              flush=True)
        secs[label] = time.perf_counter() - t0
        return out

    def served(m):
        cfg = m[0]
        reqs = dense_requests(cfg)
        routing = moe_routing_check(dev, m, reqs)
        dense = dense_cell(dev, count, m, "phase16", reqs)
        fp_peak, _ = paged_cell(dev, count, m, None, "phase16",
                                "(a) paged fp")
        q_peak, qbase = paged_cell(dev, count, m, QuantConfig(
            weights="int8", kv="int8"), "phase16", "(a) paged int8")
        expert_banks_unquantized(qbase)
        w8_dense_cell(dev, count, m, dense, qbase, "phase16",
                      "(a) dense w8")
        print(f"[phase16] (a) kv_bytes_peak int8 {q_peak} against fp "
              f"{fp_peak} ({q_peak / fp_peak:.3f}x)", flush=True)
        if not q_peak < fp_peak:
            raise AssertionError(f"(a) int8 kv_bytes_peak {q_peak} not "
                                 f"below fp's {fp_peak}")
        return routing

    part("(a)-(b) 4+1d served", served)
    part("(a) 4+ed served", lambda m: dense_cell(
        dev, count, m, "phase16",
        [dataclasses.replace(r, task=0) for r in dense_requests(m[0])],
        label="(a) dense 4+ed"), variant="4+ed")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n = train_full_width(dev, configs.get_config(GRANITE_MOE), "phase16",
                         variant="4+ed")
    for k_, v in n.items():
        total[k_] = total.get(k_, 0) + v
    secs["(c) trained"] = time.perf_counter() - t0
    print(f"[phase16] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 17: kimi-k2 (384 experts, heads of 112) served at full width through
# the d = 112 instances of K3, K4, #8 and #8q
# ---------------------------------------------------------------------------

KIMI = "kimi-k2-1t-a32b"
#: phase 17's depth: 1 of kimi-k2's 61 layers, widths kept. One layer is
#: 36.5 GB of bf16 base (its 384 experts x 3 x 7168 x 2048 alone 33.8 GB,
#: the tied 163840 x 7168 embedding 2.3 GB); two do not fit beside the
#: engine, and the f32 witness of one (73 GB) fits the card alone
KIMI_LAYERS = 1
KIMI_H, KIMI_KV = 64, 8                 # 64 heads of 112 over 8 KV heads
#: the d = 112 instances: names in ``KERNELS``
D112_KERNELS = ("flash_attention_d112", "flash_attention_fwd_d112",
                "decode_attention_d112", "paged_decode_attention_d112",
                "paged_decode_attention_int8_d112") + D112_TRAIN
#: K4's phase-2 row at kimi-k2's heads: 4 slots x 256 cells
KIMI_K4_CASES = ((KIMI_KV, 256, (0, 37, 130, 255)),)
#: #5 at d = 112: its training shape (B, T = S), the next slice's
KIMI_FWD_SHAPES = ((4, 1024),)
#: kimi-k2's q / v projections: K = d_model -> N = 64 x 112 and 8 x 112
KIMI_QV = ((7168, 7168, 8), (7168, 896, 8))


def d112_attention_rows(dev, rn):
    """K3 at d = 112, B = 1, T = S = 64, kimi-k2's 64 heads over 8
    (``k3_rows``), then #5 at d = 112 at its training shape (4 x 1024)
    against its plain version: output within 2e-2 abs + rel, lse within
    1e-3 absolute, two calls bit-identical (output and lse), its time, the
    plain version's and SDPA's with ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = k3_rows(dev, rn, KIMI_H, 112, ((64, KIMI_KV),), "_d112", "kimi")
    name, h, kv, d = "flash_attention_fwd_d112", KIMI_H, KIMI_KV, 112
    for b_, t in KIMI_FWD_SHAPES:
        q, k, v = rn(b_, t, h, d), rn(b_, t, kv, d), rn(b_, t, kv, d)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, True)
        err = compare(name, o, po)
        lse_err = float((lse - plse).abs().max())
        if not lse_err <= 1e-3:
            raise AssertionError(f"{name} lse: {lse_err:.3e} > 1e-3")
        o2, lse2 = fa.flash_attention_fwd(q, k, v, True)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: two calls differ")
        del po, plse, o2, lse2
        pairs = b_ * h * t * (t + 1) // 2
        bms, by = bound_ms(2 * (2 * b_ * t * h * d + 2 * b_ * t * kv * d)
                           + 4 * b_ * h * t, 4 * d * pairs)
        lib = [x.transpose(1, 2) for x in (q, k, v)]
        ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                          [()])
        lse_buf = torch.empty_like(lse)
        variants = {vn: cuda_time_ms(
            lambda vn=vn: fa._launch_fwd(q, k, v, True, lse_buf, vn), [()])
            for vn in fa.FWD_VARIANTS}
        rows.append(dict(
            name=name, shape=f"B={b_} T=S={t} H={h} KV={kv} d={d} causal",
            main=True, max_abs_err=err, lse_err=lse_err, ms=ms,
            plain_ms=event_time_ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, True), ()),
            library_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    *lib, is_causal=True, enable_gqa=True), [()]),
            library="SDPA, enable_gqa, causal", tag="kimi",
            bound_ms=bms, bound_by=by, variant=fa.fwd_variant(t, d),
            variants=variants, tflops=4 * d * pairs / ms / 1e9))
        print(f"[kernel] {name} {rows[-1]['shape']}: err {err:.3e}, lse "
              f"{lse_err:.3e}; {ms:.4f} ms = {rows[-1]['tflops']:.1f} "
              f"TFLOP/s, {bms / ms:.1%} of its bound ({by})", flush=True)
        del q, k, v, o, lse, lib, lse_buf
    torch.cuda.empty_cache()
    return rows


def kimi_linear_rows(dev, rn):
    """K1 (M = 64 prompt rows) and #9, K2 (M = 4 slots) and #10 at
    kimi-k2's q / v projections (7168 -> 7168 and -> 896, r = 8; W bf16,
    or int8 per output channel): ``qv_linear_rows``."""
    return qv_linear_rows(dev, rn, "kimi", KIMI_QV, (
        ("tt_linear", 64), ("tt_linear_batched_a", 4), ("tt_linear_w8", 64),
        ("tt_linear_batched_a_w8", 4)))


def packed_leaves(qbase):
    """The int8 leaves ({"q8", "scale"}) of an int8 base, every other leaf
    None: what a deferred check over it keeps once the bf16 base is
    freed."""
    from repro_torch.kernels import quant
    if quant.is_quantized(qbase):
        return qbase
    if isinstance(qbase, dict):
        return {k: packed_leaves(v) for k, v in qbase.items()}
    if isinstance(qbase, (list, tuple)):
        return type(qbase)(packed_leaves(v) for v in qbase)
    return None


def grafted(packed, base):
    """``packed``'s int8 leaves over ``base``'s other leaves: the int8
    base of the f32 witness (its int8 leaves the served ones, as
    ``f32_tree`` keeps them)."""
    from repro_torch.kernels import quant
    if quant.is_quantized(packed):
        return packed
    if isinstance(packed, dict):
        return {k: grafted(v, base[k]) for k, v in packed.items()}
    if isinstance(packed, (list, tuple)):
        return type(packed)(grafted(v, b) for v, b in zip(packed, base))
    return base


def witness_base(dev, cfg, spec, dtypes, seed=SEED):
    """The served base in f32, value for value: ``serving_model``'s
    generator state drawn through an f32 config (the init draws every
    leaf in f32 before its cast), each leaf then rounded in place, 2^28
    values at a time, to ``dtypes`` (the served leaves' dtypes, in
    ``tensors`` order) and kept in f32."""
    import torch
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = M.init_params(f32_cfg(cfg), spec, generator=gen,
                         device=dev)["base"]
    leaves = M.tensors(base)
    assert len(leaves) == len(dtypes)
    for t, dt in zip(leaves, dtypes):
        if dt != t.dtype:
            for part in t.view(-1).split(1 << 28):
                part.copy_(part.to(dt))
    return base


class Deferred:
    """Logits checks whose f32 witness leg runs after the bf16 model is
    freed: kimi-k2's base in f32 (73 GB) cannot sit beside the bf16 one
    (36.5 GB). A check keeps its inputs (caches, pools, tokens: no
    weight), the kernel and plain legs' logits and top-k records, and the
    key of the base its legs run over in ``bases`` ("fp"; "int8", the
    served int8 base, whose packed leaves it keeps). ``replay`` runs each
    f32 leg over the f32 base (the int8 leaves grafted on for "int8") and
    holds the check by ``logits_checked`` with that witness."""

    def __init__(self, tag):
        self.tag, self.items, self.bases, self.packed = tag, [], {}, {}

    def check(self, label, n, run, key):
        """``run(leg, base)``: one leg's logits rows over ``base``."""
        if key == "int8":
            self.packed[key] = packed_leaves(self.bases[key])
        out, rec = {}, {}
        for leg in ("kernel", "plain"):
            out[leg], rec[leg] = record_routing(
                lambda: run(leg, self.bases[key]).float())
        rel, agree, _ = legs_verdict(out, rec)
        print(f"[{self.tag}] {label}: logits vs plain leg max |kernel - "
              f"plain| / max |plain| {rel:.3e}, argmax equal {agree}/{n} "
              "(its f32 witness leg runs after the bf16 model is freed)",
              flush=True)
        self.items.append((label, n, run, key, out, rec))

    def replay(self, base32):
        bases = {"fp": base32}
        bases.update({k: grafted(p, base32) for k, p in self.packed.items()})
        for label, n, run, key, out, rec in self.items:
            out["f32"], rec["f32"] = record_routing(
                lambda: run("f32", bases[key]).float())
            rel, agree, wit = legs_verdict(out, rec)
            logits_checked(label, rel, agree, n, self.tag, wit)


def kimi_checks(wit, label, cfg, rt, dev, reqs=None, paged=None, key="fp",
                kv_quant=False):
    """A served cell's logits checks, deferred (``Deferred``): with
    ``reqs``, the last-position prefill logits of 2 requests (unless
    ``key`` is "int8") and one decode step of 4 slots; with ``paged``
    (requests), a pure-decode and a mixed paged step of 4 slots. The
    inputs are made over the base ``wit.bases[key]`` with the kernel leg;
    ``rt`` lends its adapter factors only."""
    fac = dataclasses.replace(rt, base=None)
    base = wit.bases[key]
    if reqs is not None and key == "fp":
        for i, r in enumerate(reqs[:2]):
            wit.check(f"{label} prefill, request {i}", 1,
                      lambda leg, b, r=r: prefill_leg(leg, cfg, fac, b, r,
                                                      dev), key)
    if reqs is not None:
        inp = decode_step_inputs(cfg, fac, reqs[:4], 256, dev, base)
        wit.check(f"{label} one decode step of 4 slots (tasks "
                  f"{[r.task for r in reqs[:4]]})", 4,
                  lambda leg, b: decode_step_leg(leg, cfg, fac, b, inp, dev),
                  key)
    if paged is not None:
        picked = paged_picked(paged)
        inp = paged_step_inputs(cfg, fac, [r.prompt for r in picked],
                                [r.task for r in picked], dev, base,
                                kv_quant)
        for step in inp["steps"]:
            wit.check(f"{label}: one {step} paged step of 4 slots", 4,
                      lambda leg, b, step=step: paged_step_leg(
                          leg, cfg, fac, b, inp, step, dev), key)


def phase_seventeen(dev):
    """Phase 17: kimi-k2 at full width (7168, 64 heads of 112 over 8, 384
    experts of SwiGLU 2048, top-8 at capacity factor 1.25, one shared
    expert, vocab 163840, bf16 with f32 routers) at ``KIMI_LAYERS`` of its
    61 layers, served with a 4+1d MetaTT q/v adapter (rank 8, 3 tasks) at
    0.25 of the base q projection through the d = 112 instances of K3,
    K4, #8 and #8q: (a) the dense cell (2L K1 + L K3 a prefill, 2L K2 + L
    K4 a decode step; the one profiled window), (b) the paged cell cold
    then warm (L #8 a step), (c) int8 weights + int8 KV paged (L #8q a
    step; no expert bank quantized), then the dense engine over int8
    weights (#9 / #10 in K1's / K2's place), (d) a 4+ed q / v /
    ``moe_down`` adapter (its expert mode 384 wide) through the dense
    cell. Each cell's logits are held under phase 16's witness rule, the
    f32 leg deferred (``Deferred``): the bf16 models are freed, the f32
    base is rebuilt from the seed, held value for value to the bf16
    builds' (``rebuilt_f32_base``), and each check's f32 leg runs then.
    Every request FINISHED, no leaked block, int8 kv_bytes_peak below
    fp's, no second copy of the base; step ms, tok/s, peak memory a
    cell."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.config.base import QuantConfig
    from repro_torch.models import model as M
    total, secs, prints = {}, {}, {}
    wit = Deferred("phase17")

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    def cell(label, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"[phase17] {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB",
              flush=True)
        secs[label] = time.perf_counter() - t0
        return out

    def build(variant):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m = serving_model(dev, "phase17", KIMI, SERVED_RATIO,
                          layers=KIMI_LAYERS, variant=variant)
        secs[f"build {variant}"] = time.perf_counter() - t0
        wit.bases["fp"] = m[3].base
        got = base_fingerprint(m[3].base)
        if prints.setdefault("fp", got) != got:
            raise AssertionError(f"phase 17: the {variant} build's base is "
                                 "not the first build's")
        return m

    m = build("4+1d")
    cfg, spec, rt = m[0], m[1], m[3]
    dtypes = [t.dtype for t in M.tensors(rt.base)]
    base_b = sum(t.numel() * t.element_size() for t in M.tensors(rt.base))
    reqs, preqs = dense_requests(cfg), paged_requests(cfg)
    dense = cell("(a) dense", lambda: dense_cell(
        dev, count, m, "phase17", reqs, check=False))
    kimi_checks(wit, "(a) dense", cfg, rt, dev, reqs=reqs)
    fp_peak, _ = cell("(b) paged fp", lambda: paged_cell(
        dev, count, m, None, "phase17", "(b) paged fp", check=False,
        profiled=False))
    kimi_checks(wit, "(b) paged fp", cfg, rt, dev, paged=preqs)
    q_peak, qbase = cell("(c) paged int8", lambda: paged_cell(
        dev, count, m, QuantConfig(weights="int8", kv="int8"), "phase17",
        "(c) paged int8", check=False, profiled=False))
    expert_banks_unquantized(qbase, "phase17")
    wit.bases["int8"] = qbase
    kimi_checks(wit, "(c) paged int8", cfg, rt, dev, paged=preqs,
                key="int8", kv_quant=True)
    cell("(c) dense w8", lambda: w8_dense_cell(
        dev, count, m, dense, qbase, "phase17", "(c) dense w8",
        check=False))
    kimi_checks(wit, "(c) dense w8", cfg, rt, dev, reqs=reqs, key="int8")
    print(f"[phase17] (c) kv_bytes_peak int8 {q_peak} against fp {fp_peak} "
          f"({q_peak / fp_peak:.3f}x)", flush=True)
    if not q_peak < fp_peak:
        raise AssertionError(f"(c) int8 kv_bytes_peak {q_peak} not below "
                             f"fp's {fp_peak}")
    del m, rt, qbase, dense
    wit.bases.clear()
    m = build("4+ed")
    reqs0 = [dataclasses.replace(r, task=0) for r in reqs]
    cell("(d) dense 4+ed", lambda: dense_cell(
        dev, count, m, "phase17", reqs0, label="(d) dense 4+ed",
        check=False, profiled=False))
    kimi_checks(wit, "(d) dense 4+ed", cfg, m[3], dev, reqs=reqs0)
    del m
    wit.bases.clear()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    print(f"[phase17] the bf16 models freed: {left / 1e9:.3f} GB allocated "
          "before the f32 witness (the checks' inputs; limit 5% of the "
          "base)", flush=True)
    if left > 0.05 * base_b:
        raise AssertionError(f"{left} bytes held past the bf16 models")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    base32 = rebuilt_f32_base(dev, cfg, spec, dtypes, prints["fp"],
                              "phase17")
    wit.replay(base32)
    print(f"[phase17] the f32 witness: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    del base32, wit
    gc.collect()
    torch.cuda.empty_cache()
    secs["f32 witness"] = time.perf_counter() - t0
    for name in D112_KERNELS[:1] + D112_KERNELS[2:5]:   # the served ones
        if not total.get(name):
            raise AssertionError(f"phase 17: {name} not launched")
    print(f"[phase17] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 18: kimi-k2 trained at full width through the d = 112 instances of
# #5, #6 and #7
# ---------------------------------------------------------------------------

def phase_eighteen(dev):
    """Phase 18: kimi-k2 at full width and ``KIMI_LAYERS`` of its 61 layers
    (36.5 GB of bf16 base) trained in phase 6's setting with MetaTT-(4+E)D
    on q, v and the expert down-projections (``train_full_width``): 4 x
    1024 tokens a step, 6 steps, one DMRG sweep; exactly 6L - 2 K1, 2L
    #5_d112, L #6_d112 and L #7_d112 launches a step and nothing else
    (the MoE FFN and its ``moe_down`` delta are plain PyTorch); the median
    step, tokens/s, busy share and top device operations; then the B = 1
    gradient check with its f32 witness deferred: the f32 base (73 GB)
    cannot sit beside the bf16 one, so the kernel and plain legs run
    first, the trainer and its base are freed, and the f32 base is
    rebuilt from the trainer's seed value for value
    (``deferred_grad_check``)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config(KIMI),
                              num_layers=KIMI_LAYERS)
    gc.collect()
    return train_full_width(dev, cfg, "phase18", variant="4+ed")


# ---------------------------------------------------------------------------
# phase 19: jamba-v0.1-52b (mamba + attention, MoE) prefilled, decoded and
# trained at full width
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
#: phase 19's depth: 1 of jamba's 4 super-blocks (8 layers: 7 mamba, 1
#: attention), widths kept. One super-block is 12.76 B parameters (25.5 GB
#: of bf16 base); its f32 witness is 51 GB, so two would not fit beside it
JAMBA_LAYERS = 8
#: (a): 4 prompts of 512 tokens (two scan chunks of 256: the chunked
#: path), then 32 teacher-forced decode steps
JAMBA_PROMPTS, JAMBA_PROMPT_LEN, JAMBA_STEPS = 4, 512, 32
#: (a)'s check that the decode steps compute the parallel forward runs in
#: f32 at this capacity factor, E / k: no call drops a pair. At jamba's
#: own 2.0 a decode step of 4 slots keeps int(2.0 x 8 / 16) = 1 pair an
#: expert and drops the rest, so its logits are not the parallel
#: forward's (in the JAX package too)
JAMBA_NO_DROP_CF = 8.0
#: K1 at jamba's mamba_in (4096 -> 16384) and mamba_out (8192 -> 4096) at
#: a training step's M = 4 x 1024 rows, r = 8
JAMBA_MAMBA = ((4096, 4096, 16384, 8), (4096, 8192, 4096, 8))


def jamba_linear_rows(dev, rn):
    """K1 at jamba's mamba in / out projections, M = 4096 rows, as the
    training forward and as the backward's dx (on the transposed views the
    backward passes): within 1e-2 of the plain version, its time, the
    plain version's, ``torch.matmul``'s and the bound."""
    import torch
    from repro_torch.kernels import tt_linear as tl
    rows, alpha = [], 4.0
    for m, kd, n, r in JAMBA_MAMBA:
        x, w = rn(m, kd), rn(kd, n, scale=kd ** -0.5)
        a, b = rn(r, kd, scale=kd ** -0.5).T, rn(r, n, scale=r ** -0.5)
        g = rn(m, n)
        for role, ops_ in (("forward", (x, w, a, b)),
                           ("dx", (g, w.T, b.T, a.T))):
            mm, kk = ops_[0].shape
            nn = ops_[1].shape[1]
            err = compare("tt_linear", tl.tt_linear(*ops_, alpha),
                          tl.tt_linear_plain(*ops_, alpha))
            flops = 2 * mm * kk * nn + 2 * mm * kk * r + 2 * mm * r * nn
            which = "mamba_in" if n > kd else "mamba_out"
            row = dict(
                name="tt_linear", tag="jamba", main=False, max_abs_err=err,
                shape=f"{which} {role} M={mm} K={kk} N={nn} r={r}",
                ms=cuda_time_ms(lambda *t: tl.tt_linear(*t, alpha), [ops_]),
                plain_ms=event_time_ms(
                    lambda: tl.tt_linear_plain(*ops_, alpha), (), iters=10),
                library_ms=cuda_time_ms(
                    lambda x_, w_, a_, b_: torch.matmul(x_, w_) + alpha
                    * torch.matmul(torch.matmul(x_, a_), b_), [ops_]))
            row["bound_ms"], row["bound_by"] = bound_ms(
                2 * (mm * kk + kk * nn + kk * r + r * nn + mm * nn), flops)
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            print(f"[kernel] K1 jamba {row['shape']}: err {err:.3e}; "
                  f"{row['ms']:.4f} ms = {row['tflops']:.1f} TFLOP/s, "
                  f"{row['bound_ms'] / row['ms']:.1%} of its bound; / "
                  f"torch.matmul {row['ms'] / row['library_ms']:.3f}x",
                  flush=True)
        del x, w, a, b, g
    torch.cuda.empty_cache()
    return rows


#: K3 at phase 19 (a)'s prefill (4 prompts of 512) and at 4 x 1024; K4 at
#: its decode: 4 slots of a 544-cell cache at positions 512 .. 543
JAMBA_K3_CASES = ((512, 8), (1024, 8))
JAMBA_K4_CASES = ((8, 544, (512, 521, 530, 543)),)


def jamba_attention_rows(dev, rn):
    """K3 (B = 4) and K4 at jamba's 32 heads of 128 over 8 (G = 4): each
    within its tolerance of the plain version, two calls bit-identical,
    its bound and SDPA with ``enable_gqa`` as library (``k3_rows``,
    ``k4_rows``; #5, #6 and #7 at its training shape are
    ``JAMBA_TRAIN_TAGS``' rows)."""
    return (k3_rows(dev, rn, h=32, d=128, cases=JAMBA_K3_CASES, tag="jamba",
                    b=4)
            + k4_rows(dev, rn, h=32, d=128, cases=JAMBA_K4_CASES,
                      tag="jamba"))


def jamba_legs(leg, cfg, fac, base, toks, p, dev, routing=None):
    """One leg of phase 19 (a) over ``base`` ("kernel": the CUDA kernels;
    "plain" / "f32": ``backend="ref"``, on ``cfg`` or its f32 version):
    the prefill of ``toks[:, :p]`` (its last position's logits, and the
    residual stream after each layer), then the rest of ``toks``
    teacher-forced one decode step at a time from the prefill's caches
    (its mamba states and conv windows, its k / v placed in caches of the
    whole length), and the parallel forward over all of ``toks``. With
    ``routing`` (another leg's result) each part replays that leg's MoE
    routing (``routed_leg``). Returns {"prefill": (B, V), "decode":
    (B·n, V), "parallel": (B·n, V)} of (f32 logits, the routers' top-k
    record), decode and parallel over the same positions p .. T - 1, and
    "layers": the prefill's per-layer residual streams."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    pol = dispatch.DEFAULT if leg == "kernel" else dispatch.REF
    c = f32_cfg(cfg) if leg == "f32" else cfg
    kw = dict(policy=pol, device=dev)
    b, t = toks.shape
    held, layers, sublayer = {}, [], T._sublayer

    def recorded(*args, **kw_):
        out = sublayer(*args, **kw_)
        layers.append(out[0].clone())
        return out

    def prefill():
        T._sublayer = recorded
        try:
            out = T.forward(base, c, fac.spec, fac.broadcast, fac.per_layer,
                            toks[:, :p], return_caches=True, **kw)
        finally:
            T._sublayer = sublayer
        held["caches"] = prefilled_caches(c, out.caches, b, t, p, dev)
        return out.logits[:, -1].float()

    def decode():
        steps = [T.decode_step(base, c, fac.spec, fac.broadcast,
                               fac.per_layer, toks[:, i:i + 1],
                               held["caches"], i, **kw)[0].float()
                 for i in range(p, t)]
        return torch.stack(steps, 1).reshape(b * (t - p), -1)

    def parallel():
        return T.forward(base, c, fac.spec, fac.broadcast, fac.per_layer,
                         toks, **kw).logits[:, p:].float().reshape(
                             b * (t - p), -1)
    with torch.inference_mode():
        out = {what: routed_leg(fn, routing and routing[what][1])
               for what, fn in (("prefill", prefill), ("decode", decode),
                                ("parallel", parallel))}
    del held
    out["layers"] = layers
    return out


def layer_drift(a, b):
    """Per layer, max |a - b| / max |b| of two legs' residual streams."""
    return [float((x.float() - y.float()).abs().max() / y.float().abs().max())
            for x, y in zip(a, b)]


def prefilled_caches(cfg, got, b, t, p, dev):
    """Decode caches of ``t`` cells from a prefill's caches ``got``
    (``forward(return_caches=True)`` over ``p`` tokens): its k / v in the
    first ``p`` cells, its mamba states and conv windows as they are."""
    from repro_torch.models import transformer as T
    caches = T.init_caches(cfg, b, t, cfg.compute_dtype, device=dev)
    for dst, src in zip(caches, got):
        for kind, leaves in src.items():
            for name, v in leaves.items():
                if kind == "self":
                    dst[kind][name][:, :, :p] = v
                else:
                    dst[kind][name].copy_(v)
    return caches


def jamba_serving(dev, m, count, tag="phase19"):
    """Phase 19 (a): the kernel leg's prefill of ``JAMBA_PROMPTS`` prompts
    of ``JAMBA_PROMPT_LEN`` tokens and ``JAMBA_STEPS`` decode steps timed
    (prefill ms, step ms, tok/s; busy share and top device operations of
    one profiled prefill + decode), exact launches a prefill and a step;
    then the legs of the checks (``jamba_legs``) kept for the deferred f32
    witness: "plain", "kernel" replaying the plain leg's routing, and
    "kernel, own routing". Returns (toks, the adapter factors, the
    legs)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg, spec, _, rt, _ = m
    fac = dataclasses.replace(rt, base=None)
    rng = np.random.RandomState(SEED + 19)
    p, n = JAMBA_PROMPT_LEN, JAMBA_STEPS
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                       size=(JAMBA_PROMPTS, p + n)),
                           device=dev)
    attn = sum(m_ == "attn" for m_, _ in cfg.block_pattern) * \
        cfg.num_super_blocks
    k1 = sum(t in K1_MATRICES.get(m_, ()) for m_, _ in cfg.block_pattern
             for t in spec.cfg.matrix_types) * cfg.num_super_blocks
    kw = dict(device=dev)

    def prefill():
        with torch.inference_mode():
            return T.forward(rt.base, cfg, spec, rt.broadcast, rt.per_layer,
                             toks[:, :p], return_caches=True, **kw)

    def decode(caches):
        with torch.inference_mode():
            for i in range(p, p + n):
                T.decode_step(rt.base, cfg, spec, rt.broadcast,
                              rt.per_layer, toks[:, i:i + 1], caches, i,
                              **kw)

    def fresh_caches(out):
        return prefilled_caches(cfg, out.caches, JAMBA_PROMPTS, p + n, p,
                                dev)

    prefill()                                   # warm-up
    torch.cuda.synchronize()
    held = {}
    t0 = time.perf_counter()
    launches = count(lambda: held.update(out=prefill()))
    pre_ms = 1e3 * (time.perf_counter() - t0)
    check_launches(launches, {"tt_linear": k1, "flash_attention": attn},
                   f"{tag} (a) prefill")
    caches = fresh_caches(held.pop("out"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches = count(lambda: decode(caches))
    step_ms = 1e3 * (time.perf_counter() - t0) / n
    check_launches(launches, {"tt_linear": k1 * n,
                              "decode_attention": attn * n},
                   f"{tag} (a) {n} decode steps")
    base_b = sum(t.numel() * t.element_size() for t in M.tensors(rt.base))
    bms = base_b / PEAK_BYTES_S * 1e3
    print(f"[{tag}] (a) launches: {k1} K1 + {attn} K3 a prefill, {k1} K1 + "
          f"{attn} K4 a decode step, nothing else; prefill of "
          f"{JAMBA_PROMPTS} x {p} tokens {pre_ms:.1f} ms "
          f"({JAMBA_PROMPTS * p / pre_ms * 1e3:.1f} tokens/s); decode "
          f"{step_ms:.2f} ms a step = {JAMBA_PROMPTS / step_ms * 1e3:.1f} "
          f"tok/s against a bound of {bms:.2f} ms (every expert runs: "
          f"capacity max(int(2.0 x 8 / 16), 1) = 1 a step; the step reads "
          f"the whole {base_b / 1e9:.3f} GB base)", flush=True)
    del caches

    def window():
        out = prefill()
        cc = fresh_caches(out)
        del out
        decode(cc)
    device_share(f"{tag}: (a) one prefill of {JAMBA_PROMPTS} x {p} tokens "
                 f"and {n} decode steps", window, top_n=12,
                 show=("tt_linear", "flash_fwd", "paged"))
    legs = {"plain": jamba_legs("plain", cfg, fac, rt.base, toks, p, dev)}
    legs["kernel"] = jamba_legs("kernel", cfg, fac, rt.base, toks, p, dev,
                                legs["plain"])
    legs["kernel, own routing"] = jamba_legs("kernel", cfg, fac, rt.base,
                                             toks, p, dev)
    return toks, fac, legs


def jamba_verdicts(legs, cfg, tag="phase19"):
    """Phase 19 (a)'s checks once the f32 legs have run. The kernel, plain
    and f32 legs share the plain leg's routing, so bf16 drift flips no
    top-k: the prefill's last logits, the decode steps' and the parallel
    forward's are held by ``logits_checked`` (the witness rule asserted,
    and with it that its limit sits below a zero kernel leg's; the 5%
    limit reported: the mamba layers amplify the kernel-vs-plain rounding
    as they do bf16 against f32). The kernel leg with its own routing is
    printed beside them, and the residual streams' drift layer by layer:
    what routing flips add, and where the legs part. Then the decode
    steps against the parallel forward
    (``test_decode_matches_parallel_forward``'s case) in f32 at
    ``JAMBA_NO_DROP_CF``, within that test's 2e-2."""
    legs_ = ("kernel", "plain", "f32")
    for what in ("prefill", "decode", "parallel"):
        out = {leg: legs[leg][what][0] for leg in legs_}
        rel, agree, wit = legs_verdict(out, {leg: legs[leg][what][1]
                                             for leg in legs_})
        logits_checked(f"(a) {what} logits, routing shared", rel, agree,
                       out["kernel"].shape[0], tag, wit)
        own = {"kernel": legs["kernel, own routing"][what][0],
               "plain": out["plain"], "f32": out["f32"]}
        rel, agree, (k32, _, flips) = legs_verdict(own, {
            "kernel": legs["kernel, own routing"][what][1],
            "plain": legs["plain"][what][1], "f32": legs["f32"][what][1]})
        print(f"[{tag}] (a) {what} logits, the kernel leg with its own "
              f"routing (reported): vs plain {rel:.3e}, vs f32 {k32:.3e}, "
              f"argmax equal {agree}/{out['kernel'].shape[0]}, top-k sets "
              f"that differ from the plain leg's {flips['kernel/plain']:.4f} "
              "of (token, layer) rows", flush=True)
    pattern = [f"{m}+{f}" for m, f in cfg.block_pattern] * \
        cfg.num_super_blocks
    rows = {"kernel / plain": ("kernel", "plain"),
            "kernel own routing / plain": ("kernel, own routing", "plain"),
            "plain / f32": ("plain", "f32")}
    for label, (x, y) in rows.items():
        print(f"[{tag}] (a) prefill residual stream after each layer, max "
              f"|{label.replace(' / ', ' - ')}| / max |{y}|: " + ", ".join(
                  f"{i} {m} {d:.3e}" for i, (m, d) in enumerate(zip(
                      pattern, layer_drift(legs[x]["layers"],
                                           legs[y]["layers"])))),
              flush=True)
    d, f = (legs["f32 no drops"][w][0] for w in ("decode", "parallel"))
    gap = float((d - f).abs().max() / f.abs().max())
    print(f"[{tag}] (a) cf {JAMBA_NO_DROP_CF}: f32 decode steps against the "
          f"f32 parallel forward: max |decode - parallel| / max |parallel| "
          f"{gap:.3e} (limit 2e-2, the JAX test's)", flush=True)
    if not gap <= 2e-2:
        raise AssertionError(f"f32 decode differs from the parallel "
                             f"forward by {gap:.3e} at cf {JAMBA_NO_DROP_CF}")


def phase_nineteen(dev):
    """Phase 19: jamba-v0.1-52b at full width (4096, 32 heads of 128 over
    8, mamba d_inner 8192 / d_state 16 / dt_rank 256 / conv 4, 16 experts
    of 14336 top-2 at capacity factor 2.0, vocab 65536, bf16) at
    ``JAMBA_LAYERS`` of its 32 layers (one super-block: 7 mamba, 1
    attention), MetaTT 4d on attn q / v and mamba in / out. (a) The
    adapter at 0.25 of the base q projection: 4 prompts of 512 tokens
    prefilled (the chunked scan), 32 decode steps from the prefilled mamba
    states and KV caches (``jamba_serving``), exact launches, the legs of
    the checks kept; the bf16 model freed, the f32 base rebuilt value for
    value from the seed (``rebuilt_f32_base``, 52 GB) and the f32 legs
    run; the prefill, decode and parallel logits held with the routing
    shared between the legs (the witness rule, which a zero kernel leg
    fails; the 5% limit reported), and the f32 decode steps against the f32 parallel forward at no capacity drop
    (``jamba_verdicts``). (b) Phase 6's training (``train_full_width``):
    exactly 47 K1 (by ``bf16_train_per_step``), 2 #5, 1 #6 and 1 #7 a
    step, then the B = 1 gradient check with the f32 witness deferred and
    the routing shared. Peak memory a part."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.models import model as M
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)   # by earlier phases
    t0 = time.perf_counter()
    m = serving_model(dev, "phase19", JAMBA, SERVED_RATIO,
                      layers=JAMBA_LAYERS, variant="4d")
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, spec = m[0], m[1]
    dtypes = [t.dtype for t in M.tensors(m[3].base)]
    base_b = sum(t.numel() * t.element_size() for t in M.tensors(m[3].base))
    prints = base_fingerprint(m[3].base)
    toks, fac, legs = jamba_serving(dev, m, count)
    print(f"[phase19] (a) the bf16 legs: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - held
    print(f"[phase19] the bf16 model freed: {left / 1e9:.3f} GB allocated "
          "since the phase began (the checks' logits and residual streams; "
          "limit 5% of the base)", flush=True)
    if left > 0.05 * base_b:
        raise AssertionError(f"{left} bytes held past the bf16 model")
    torch.cuda.reset_peak_memory_stats(dev)
    base32 = rebuilt_f32_base(dev, cfg, spec, dtypes, prints, "phase19")
    legs["f32"] = jamba_legs("f32", cfg, fac, base32, toks,
                             JAMBA_PROMPT_LEN, dev, legs["plain"])
    legs["f32 no drops"] = jamba_legs(
        "f32", dataclasses.replace(cfg, moe_capacity_factor=JAMBA_NO_DROP_CF),
        fac, base32, toks, JAMBA_PROMPT_LEN, dev)
    print(f"[phase19] (a) the f32 witness: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    del base32
    gc.collect()
    torch.cuda.empty_cache()
    jamba_verdicts(legs, cfg)
    del legs
    secs["(a) served"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(JAMBA),
                              num_layers=JAMBA_LAYERS)
    gc.collect()
    train = train_full_width(dev, cfg, "phase19")
    for k_, v in train.items():
        total[k_] = total.get(k_, 0) + v
    secs["(b) trained"] = time.perf_counter() - t0
    print(f"[phase19] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 20: xlstm-125m (mLSTM / sLSTM) served and trained at full width
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
#: (a): 4 prompts of 512 tokens through the parallel forms (two mLSTM
#: chunks of 256: the chunked path), then decode from zero states over the
#: same 512 tokens teacher-forced and 32 greedy steps
XLSTM_PROMPTS, XLSTM_PROMPT_LEN, XLSTM_STEPS = 4, 512, 32
#: phase 20's depth: 6 of xlstm-125m's 12 layers (3 mLSTM / sLSTM pairs,
#: widths kept), cut to pay for phases 22-23 in the script's time (its
#: bf16 legs are host-bound eager ops: the time goes with the depth)
XLSTM_LAYERS = 6
#: the 4+1d decode's per-row tasks
XLSTM_TASKS = (0, 1, 2, 0)
#: (b)'s steps: the sweep after step 3; the sLSTM loop runs 6 layers x
#: 1024 eager steps forward, again in the remat recompute, and backward
#: (5.2-8.2 s a step). No step is profiled: a step's trace holds ≈ 250 k
#: events and took 20 s to take and read (busy 8.3%, H100 80GB HBM3 at
#: 700 W); ``train_full_width(..., profile=True)`` takes it
XLSTM_TRAIN_STEPS = 3
#: K1 at xlstm's 768 -> 768 q / v / z projections (r = 8): the prefill's
#: M = 4 x 512 rows and a decode step's 4; K2 at the 4+1d decode's 4 slots
XLSTM_QV = ((768, 768, 8),)


def xlstm_linear_rows(dev, rn):
    """K1 (M = 2048 prefill rows and 4 decode rows) and K2 (M = 4 slots)
    at xlstm-125m's 768 -> 768 projections: ``qv_linear_rows``."""
    return qv_linear_rows(dev, rn, "xlstm", XLSTM_QV, (
        ("tt_linear", XLSTM_PROMPTS * XLSTM_PROMPT_LEN), ("tt_linear", 4),
        ("tt_linear_batched_a", 4)))


def greedy_decode(step, toks, start, new, first=None):
    """Decode steps over positions ``start`` .. T + ``new`` - 1 of
    ``toks`` (B, T): teacher-forced up to T - 1, then ``new`` tokens
    picked greedily (position T's from the logits at T - 1: ``first``,
    the prefill's, when ``start`` == T). ``step(tok (B, 1), pos)`` returns
    (B, V) logits. Returns (the steps' logits (B, n, V) f32, the tokens
    (B, T + new))."""
    import torch
    t_len = toks.shape[1]
    out, toks = [], toks
    prev = first
    for i in range(start, t_len + new):
        if i >= t_len:
            toks = torch.cat([toks, prev.argmax(-1, keepdim=True)], 1)
        prev = step(toks[:, i:i + 1], i).float()
        out.append(prev)
    return torch.stack(out, 1), toks


#: legs of phases 20 / 21's checks: leg -> (f32 model, dispatch policy
#: name): the bf16 kernels, their plain versions, the plain versions in
#: f32 (the witness) and the f32 instances of the kernels
LEGS = {"kernel": (False, "DEFAULT"), "plain": (False, "REF"),
        "f32": (True, "REF"), "f32 kernel": (True, "DEFAULT")}


def xlstm_leg(leg, cfg, fac, base, toks, dev, parallel=0, decode=0, new=0,
              task=None):
    """One leg of phase 20 (a) (``LEGS``, over ``base``): the parallel
    forward over ``toks[:, :parallel]`` (its (B, parallel, V) logits),
    and decode from zero states over positions 0 .. ``decode`` - 1 of
    ``toks`` teacher-forced, then ``new`` greedy steps
    (``greedy_decode``; ``task``: a (B,) task vector). Returns
    {"parallel", "decode": f32 logits, "tokens"}."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    f32, pol = LEGS[leg]
    c = f32_cfg(cfg) if f32 else cfg
    kw = dict(policy=getattr(dispatch, pol), device=dev, task=task)
    out = {}
    with torch.inference_mode():
        if parallel:
            out["parallel"] = T.forward(base, c, fac.spec, fac.broadcast,
                                        fac.per_layer, toks[:, :parallel],
                                        **kw).logits.float()
        if decode or new:
            caches = T.init_caches(c, toks.shape[0], 1, c.compute_dtype,
                                   device=dev)
            out["decode"], out["tokens"] = greedy_decode(
                lambda tok, i: T.decode_step(base, c, fac.spec,
                                             fac.broadcast, fac.per_layer,
                                             tok, caches, i, **kw)[0],
                toks[:, :decode], 0, new)
    return out


@contextlib.contextmanager
def launches_checked():
    """Each K1 / K2 launch of the adapted linears (``dispatch.tt_linear``
    / ``tt_linear_batched_a``, the route of ``adapted_linear``) held
    against the plain version on the same inputs at the linears'
    tolerance (``compare``), as it runs. Yields {kernel: calls checked}."""
    from repro_torch.kernels import dispatch
    checked = collections.Counter()
    saved = {n: getattr(dispatch, n) for n in ("tt_linear",
                                                "tt_linear_batched_a")}

    def wrap(name, fn):
        def call(x, w, a, b, *, alpha=1.0, policy=None):
            out = fn(x, w, a, b, alpha=alpha, policy=policy)
            if x.is_cuda and (policy or dispatch.DEFAULT).backend != "ref":
                compare(name, out, fn(x, w, a, b, alpha=alpha,
                                      policy=dispatch.REF))
                checked[name] += 1
            return out
        return call
    for n, fn in saved.items():
        setattr(dispatch, n, wrap(n, fn))
    try:
        yield checked
    finally:
        for n, fn in saved.items():
            setattr(dispatch, n, fn)


def f32_kernel_checked(legs, what, label, limit, tag):
    """The f32 kernel leg's ``what`` logits against the f32 plain leg's
    over the kernel leg's positions, within ``limit`` of the largest
    logit (asserted; a zero kernel leg sits at 1)."""
    k = legs["f32 kernel"][what]
    p = legs["f32"][what][:, :k.shape[1]]
    rel = rel_rows(k.reshape(-1, k.shape[-1]), p.reshape(-1, p.shape[-1]))
    print(f"[{tag}] {label}: f32 kernel leg (the f32 instances of K1 / K2) "
          f"vs the f32 plain leg, max |kernel - plain| / max |plain| "
          f"{rel:.3e} (limit {limit:g})", flush=True)
    if not rel <= limit:
        raise AssertionError(f"{tag} {label}: f32 kernel leg {rel:.3e} from "
                             "the f32 plain leg")


#: phase 20's f32 kernel-vs-plain limit: f32 sums in another order
#: (≈ 1e-7 relative) come out of xlstm-125m at random init some 1e3
#: larger (its f32 legs sat 2.6e-5 – 4.8e-4 apart on an H100 80GB HBM3);
#: a faulty kernel moves them by O(1)
XLSTM_F32_LIMIT = 2e-3
#: phase 20 (b)'s B = 1 gradient check of the f32 instances of K1 (forward
#: and dx) against the f32 plain leg: (loss, each gradient's relative
#: Frobenius). The bf16 legs cannot hold the kernels there (bf16 sits
#: 0.78-0.99 from f32, a zero gradient at 1); f32 sums in another order
#: came out at 8.7e-8 and 1.33e-4 - 1.46e-4 on an H100 80GB HBM3 at
#: 700 W, a dx 20% wrong would sit near 0.2
XLSTM_F32_GRAD_LIMITS = (1e-5, 2e-3)
#: the decode positions of phase 20 (a)'s f32 plain leg (past the
#: parallel form's chunk of 256, for the decode-vs-parallel check), and of
#: its f32 kernel and 4+1d legs
XLSTM_CHECK_DECODE, XLSTM_TASK_DECODE = 272, 64


def xlstm_serving(dev, count, tag="phase20"):
    """Phase 20 (a): full-width xlstm-125m (bf16, ``XLSTM_LAYERS`` of its
    12 layers) with
    MetaTT 4d on mLSTM q / v and sLSTM z at ``SERVED_RATIO`` of the base
    mLSTM q projection. The kernel leg: a parallel forward of 4 x 512
    tokens (18 K1, nothing else) and decode from zero states over the same
    512 tokens and 32 greedy steps (18 K1 at M = 4 a step), timed, one
    window profiled; every K1 of one parallel forward and of 8 decode
    steps held to its plain version on the path's own inputs
    (``launches_checked``). At random init the model is chaotic in bf16
    (in both packages: ``tests/test_torch_xlstm.py``), so the bf16 legs'
    logits (kernel, plain, f32 witness) are reported, and what is
    asserted runs in f32: the f32 instances of the kernels against the
    f32 plain leg (``XLSTM_F32_LIMIT``) over the parallel forward and
    ``XLSTM_TASK_DECODE`` decode positions, and the f32 decode against
    the f32 parallel forward over ``XLSTM_CHECK_DECODE`` positions within
    the JAX test's 2e-2. Then decode under a 4+1d adapter over 3 tasks with a per-row task vector (18 K2
    a step over ``XLSTM_TASK_DECODE`` positions, every launch of 8 steps
    held to its plain version; its f32 kernel leg against its f32 plain
    leg)."""
    import torch
    from repro_torch.config.base import RunConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.peft import api as peft_api
    from repro_torch.serving import AdapterRuntime
    from repro_torch.tree import tree_map
    cfg, spec, params, rt, gen = serving_model(dev, tag, XLSTM, SERVED_RATIO,
                                               layers=XLSTM_LAYERS,
                                               variant="4d")
    base = params["base"]
    fac = dataclasses.replace(rt, base=None)
    rng = np.random.RandomState(SEED + 20)
    p, n = XLSTM_PROMPT_LEN, XLSTM_STEPS
    b = XLSTM_PROMPTS
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(b, p)),
                           device=dev)
    k1 = sum(t in K1_MATRICES.get(m_, ()) for m_, _ in cfg.block_pattern
             for t in spec.cfg.matrix_types) * cfg.num_super_blocks
    held = {}
    xlstm_leg("kernel", cfg, fac, base, toks, dev, 8, 8)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches = count(lambda: held.update(pre=T.forward(
        base, cfg, spec, rt.broadcast, rt.per_layer, toks, device=dev)))
    pre_ms = 1e3 * (time.perf_counter() - t0)
    check_launches(launches, {"tt_linear": k1},
                   f"{tag} (a) parallel forward")
    del held["pre"]
    t0 = time.perf_counter()
    launches = count(lambda: held.update(kernel=xlstm_leg(
        "kernel", cfg, fac, base, toks, dev, decode=p, new=n)))
    steps = p + n
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    check_launches(launches, {"tt_linear": k1 * steps},
                   f"{tag} (a) {steps} decode steps")
    base_b = sum(t.numel() * t.element_size() for t in M.tensors(base))
    print(f"[{tag}] (a) launches: {k1} K1 a parallel forward, {k1} K1 a "
          f"decode step, nothing else; parallel forward of {b} x {p} "
          f"tokens {pre_ms:.1f} ms ({b * p / pre_ms * 1e3:.1f} tokens/s); "
          f"decode from zero states {step_ms:.3f} ms a step over {steps} "
          f"steps = {b / step_ms * 1e3:.1f} tok/s against a bound of "
          f"{base_b / PEAK_BYTES_S * 1e3:.4f} ms (the step reads the whole "
          f"{base_b / 1e9:.3f} GB base)", flush=True)
    full = held.pop("kernel")["tokens"]

    def window():
        xlstm_leg("kernel", cfg, fac, base, full, dev, 64, 64)
    device_share(f"{tag}: (a) one parallel forward and decode over {b} x "
                 "64 tokens", window, top_n=12, show=("tt_linear",))
    with launches_checked() as checked:
        xlstm_leg("kernel", cfg, fac, base, full, dev, p, 8)
    if dev.type == "cuda" and checked["tt_linear"] != 9 * k1:
        raise AssertionError(f"{tag}: {dict(checked)} K1 launches checked, "
                             f"want {9 * k1}")
    print(f"[{tag}] (a) every K1 of a parallel forward and 8 decode steps "
          f"({checked['tt_linear']} launches) within 1e-2 of the plain "
          "version on the path's own inputs", flush=True)
    base32 = tree_map(lambda t: t.float(), base)
    legs = {"kernel": xlstm_leg("kernel", cfg, fac, base, full, dev, p),
            "plain": xlstm_leg("plain", cfg, fac, base, full, dev, p),
            "f32": xlstm_leg("f32", cfg, fac, base32, full, dev, p,
                             XLSTM_CHECK_DECODE),
            "f32 kernel": xlstm_leg("f32 kernel", cfg, fac, base32, full,
                                    dev, p, XLSTM_TASK_DECODE)}
    out = {leg: legs[leg]["parallel"].reshape(-1, cfg.padded_vocab)
           for leg in ("kernel", "plain", "f32")}
    rel, agree, (k32, p32, _) = legs_verdict(out)
    print(f"[{tag}] (a) bf16 parallel logits (reported): kernel vs plain "
          f"{rel:.3e} (5e-2 not held), argmax equal {agree}/"
          f"{out['kernel'].shape[0]}; vs the f32 plain leg kernel "
          f"{k32:.3e}, plain {p32:.3e}: the witness's limit "
          f"{2 * p32 + 5e-2:.3e} is vacuous (a zero leg sits at 1)",
          flush=True)
    for what in ("parallel", "decode"):
        f32_kernel_checked(legs, what, f"(a) 4d {what} logits",
                           XLSTM_F32_LIMIT, tag)
    d = legs["f32"]["decode"][:, :XLSTM_CHECK_DECODE]
    f = legs["f32"]["parallel"][:, :XLSTM_CHECK_DECODE]
    gap = float((d - f).abs().max() / f.abs().max())
    print(f"[{tag}] (a) f32 decode from zero states against the f32 "
          f"parallel forward (the chunked form, {p} tokens) over positions "
          f"0 .. {XLSTM_CHECK_DECODE - 1}: max |decode - parallel| / max "
          f"|parallel| {gap:.3e} (limit 2e-2, the JAX test's)", flush=True)
    if not gap <= 2e-2:
        raise AssertionError(f"{tag}: f32 decode differs from the parallel "
                             f"forward by {gap:.3e}")
    del legs
    # decode under a 4+1d adapter, a task a row: K2
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
                    num_tasks=3, adapter_rank=8)
    spec41 = M.build_adapter_spec(run)
    _, frozen = peft_api.init_adapter(spec41, gen, device=dev)
    adapter = {"cores": ttlib.random_tt(gen, spec41.cfg.mode_sizes, 8,
                                        scale=0.5, device=dev)}
    rt41 = AdapterRuntime.build("live", base, spec41, adapter, frozen)
    adapter["cores"][-1] *= SERVED_RATIO / q_ratio(cfg, rt41, gen)
    rt41 = AdapterRuntime.build("live", base, spec41, adapter, frozen)
    fac41 = dataclasses.replace(rt41, base=None)
    task = torch.tensor(XLSTM_TASKS, device=dev)
    m_ = XLSTM_TASK_DECODE
    t0 = time.perf_counter()
    launches = count(lambda: xlstm_leg("kernel", cfg, fac41, base, full,
                                       dev, decode=m_, task=task))
    step_ms = 1e3 * (time.perf_counter() - t0) / m_
    check_launches(launches, {"tt_linear_batched_a": k1 * m_},
                   f"{tag} (a) 4+1d, {m_} decode steps")
    with launches_checked() as checked:
        xlstm_leg("kernel", cfg, fac41, base, full, dev, decode=8,
                  task=task)
    if dev.type == "cuda" and checked["tt_linear_batched_a"] != 8 * k1:
        raise AssertionError(f"{tag}: {dict(checked)} K2 launches checked, "
                             f"want {8 * k1}")
    print(f"[{tag}] (a) 4+1d (tasks {XLSTM_TASKS}, ratio "
          f"{q_ratio(cfg, rt41, gen):.3e}): {k1} K2 a decode step over "
          f"{m_} steps, nothing else, {step_ms:.3f} ms a step; every K2 of "
          f"8 steps ({checked['tt_linear_batched_a']} launches) within "
          "1e-2 of the plain version on the path's own inputs", flush=True)
    legs = {leg: xlstm_leg(leg, cfg, fac41, base32, full, dev, decode=m_,
                           task=task) for leg in ("f32", "f32 kernel")}
    f32_kernel_checked(legs, "decode", "(a) 4+1d decode logits",
                       XLSTM_F32_LIMIT, tag)
    del legs, base32
    return base_b


def phase_twenty(dev):
    """Phase 20: xlstm-125m at full width and ``XLSTM_LAYERS`` (6) of its
    12 layers (768, 4 heads of 192, alternating mLSTM / sLSTM, no FFN,
    vocab 50304, bf16): (a) served (``xlstm_serving``), (b) trained in
    phase 6's setting (``train_full_width``, ``XLSTM_TRAIN_STEPS``
    steps): exactly 25 K1 a step (9 adapted linears, 3 each, less layer
    0's q / v) and
    nothing else, then the B = 1 gradient check with its f32 witness and
    the f32 instances of K1 held to the f32 plain leg
    (``XLSTM_F32_GRAD_LIMITS``)."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xlstm_serving(dev, count)
    secs["(a) served"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_full_width(dev, dataclasses.replace(
        configs.get_config(XLSTM), num_layers=XLSTM_LAYERS), "phase20",
                             steps=XLSTM_TRAIN_STEPS,
                             f32_grad_limits=XLSTM_F32_GRAD_LIMITS,
                             profile=False)
    for k_, v in train.items():
        total[k_] = total.get(k_, 0) + v
    secs["(b) trained"] = time.perf_counter() - t0
    print(f"[phase20] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 21: whisper-large-v3 (encoder-decoder) served and trained at full
# width
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"
#: (a): 4 x 1536 stub frames encoded, 4 prompts of 256 decoder tokens
#: prefilled, then 32 greedy decode steps from the prefill's caches
WHISPER_BATCH, WHISPER_PROMPT_LEN, WHISPER_STEPS = 4, 256, 32
WHISPER_H, WHISPER_D, WHISPER_S = 20, 64, 1536
#: K1 at whisper's 1280 -> 1280 q / v (r = 8): the encoder's M = 4 x 1536
#: rows (and a decode step's cross v over enc_out), the prefill's 4 x 256
#: and a decode step's 4
WHISPER_QV = ((1280, 1280, 8),)
#: K3 (B = 4): the encoder (T = S = 1536), the cross-attention of a
#: decode step (T = 1) and of the prefill (T = 256) over S = 1536, none
#: causal
WHISPER_K3_CASES = ((1536, 1536, "encoder"), (1, 1536, "cross decode"),
                    (256, 1536, "cross prefill"))
#: K4 at the decode: 4 slots of a 288-cell cache at positions 256 .. 287
WHISPER_K4_CASES = ((20, 288, (256, 265, 276, 287)),)
#: #5, #6 and #7 at (b)'s encoder (T = S = 1536) and cross (T = 1024
#: over S = 1536) shapes, B = 4, not causal
WHISPER_TRAIN_CASES = ((1536, 1536, "encoder"), (1024, 1536, "cross"))


def whisper_linear_rows(dev, rn):
    """K1 at whisper-large-v3's 1280 -> 1280 projections, M = 6144
    (the encoder), 1024 (the prefill) and 4 (a decode step):
    ``qv_linear_rows``."""
    m = WHISPER_BATCH * WHISPER_S
    return qv_linear_rows(dev, rn, "whisper", WHISPER_QV, (
        ("tt_linear", m), ("tt_linear", WHISPER_BATCH * WHISPER_PROMPT_LEN),
        ("tt_linear", WHISPER_BATCH)))


def whisper_attention_rows(dev, rn):
    """K3 not causal at whisper's 20 heads of 64 (B = 4, ``
    WHISPER_K3_CASES``): within 2e-2 of the plain version, two calls
    bit-identical, its time beside the plain version's, SDPA's and the
    bound (every (query, key) pair); K4 at the decode's 288-cell cache
    (``k4_rows``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    b_, h, d = WHISPER_BATCH, WHISPER_H, WHISPER_D
    for t, s_len, role in WHISPER_K3_CASES:
        def make():
            return (rn(b_, t, h, d), rn(b_, s_len, h, d),
                    rn(b_, s_len, h, d))
        nbytes = 2 * (2 * b_ * t * h * d + 2 * b_ * s_len * h * d)
        sets = copies(make, nbytes)
        err = compare("flash_attention", fa.flash_attention(*sets[0], False),
                      fa.flash_attention_plain(*sets[0], False))
        same(lambda *x: fa.flash_attention(*x, False), sets[0],
             "flash_attention")
        flops = 4 * b_ * h * d * t * s_len
        bms, by = bound_ms(nbytes, flops)
        ms = cuda_time_ms(lambda *x: fa.flash_attention(*x, False), sets)
        lib_sets = [tuple(x.transpose(1, 2) for x in s_) for s_ in sets]
        rows.append(dict(
            name="flash_attention", tag="whisper", main=False,
            shape=f"B={b_} T={t} S={s_len} H={h} KV={h} d={d} non-causal "
                  f"({role})", max_abs_err=err, ms=ms,
            plain_ms=cuda_time_ms(
                lambda *x: fa.flash_attention_plain(*x, False), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
                lib_sets),
            library="SDPA, not causal", bound_ms=bms, bound_by=by,
            variant=fa.fwd_variant(t, d),
            variants={v: cuda_time_ms(
                lambda *x: fa._launch_fwd(*x, False, None, v), sets)
                for v in fa.FWD_VARIANTS},
            tflops=flops / ms / 1e9))
        del sets, lib_sets
    return rows + k4_rows(dev, rn, h=h, d=d, cases=WHISPER_K4_CASES,
                          tag="whisper")


def whisper_train_rows(dev):
    """#5, #6 and #7 not causal at whisper's 20 heads of 64
    (``WHISPER_TRAIN_CASES``, B = 4): out within 2e-2 and lse within 1e-3
    of the plain forward, dq / dk / dv within 2e-2 of the largest plain
    gradient, two backward calls bit-identical; each pass timed beside the
    plain version, SDPA's forward / autograd backward and its bound
    (every (query, key) pair)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)
    rows = []
    b_, h, d = WHISPER_BATCH, WHISPER_H, WHISPER_D
    for t, s_len, role in WHISPER_TRAIN_CASES:
        shape = f"B={b_} T={t} S={s_len} H={h} KV={h} d={d} non-causal " \
                f"({role})"
        q, k, v = rn(b_, t, h, d), rn(b_, s_len, h, d), rn(b_, s_len, h, d)
        g = rn(b_, t, h, d)
        o, lse = fa.flash_attention_fwd(q, k, v, False)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, False)
        err = compare("flash_attention_fwd", o, po)
        lse_err = float((lse - plse).abs().max())
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_attention_fwd lse {lse_err:.3e} at "
                                 f"{shape}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, g, False)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, False)
        again = fa.flash_attention_bwd(q, k, v, o, lse, g, False)
        torch.cuda.synchronize()
        errs = {}
        for name, x, y, z in zip(("dq", "dk", "dv"), got, want, again):
            errs[name] = rel_max(x, y)
            if not errs[name] <= 2e-2 or not torch.equal(x, z):
                raise AssertionError(f"flash_attention_bwd {name} at "
                                     f"{shape}: {errs[name]:.3e} of max "
                                     "|plain| (limit 2e-2), or two calls "
                                     "differ")
        abs_err = {n_: float((x.float() - y.float()).abs().max())
                   for n_, x, y in zip(("dq", "dk", "dv"), got, want)}
        lib = [x.transpose(1, 2) for x in (q, k, v)]
        leaves = [x.clone().requires_grad_(True) for x in lib]
        out = F.scaled_dot_product_attention(*leaves)
        gl = g.transpose(1, 2)
        _, delta = fa._launch_bwd_dq(q, k, v, o, lse, g, False)
        timed = dict(
            fwd_ms=cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                               False), [()]),
            fwd_plain_ms=event_time_ms(
                lambda: fa.flash_attention_fwd_plain(q, k, v, False), ()),
            fwd_lib_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(*lib), [()]),
            dq_ms=event_time_ms(
                lambda: fa._launch_bwd_dq(q, k, v, o, lse, g, False), ()),
            dkv_ms=event_time_ms(
                lambda: fa._launch_bwd_dkv(q, k, v, g, lse, delta, False),
                ()),
            bwd_plain_ms=event_time_ms(
                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g,
                                                     False), ()),
            bwd_lib_ms=profiled_device_ms(
                lambda: torch.autograd.grad(out, leaves, gl,
                                            retain_graph=True), ()))
        pairs = b_ * h * t * s_len
        bq, bkv, lse_b = b_ * t * h * d * 2, b_ * s_len * h * d * 2, \
            b_ * h * t * 4
        flops = {"fwd": 4 * d * pairs, "dq": 6 * d * pairs,
                 "dkv": 8 * d * pairs}
        for name, err_, nbytes, key, plain, lib_ms in (
                ("flash_attention_fwd", err, 2 * bq + 2 * bkv + lse_b, "fwd",
                 "fwd_plain_ms", "fwd_lib_ms"),
                ("flash_attention_bwd_dq", abs_err["dq"],
                 4 * bq + 2 * bkv + 2 * lse_b, "dq", "bwd_plain_ms",
                 "bwd_lib_ms"),
                ("flash_attention_bwd_dkv", max(abs_err["dk"],
                                                abs_err["dv"]),
                 2 * bq + 4 * bkv + 2 * lse_b, "dkv", "bwd_plain_ms",
                 "bwd_lib_ms")):
            bms, by = bound_ms(nbytes, flops[key])
            ms = timed[key + "_ms"]
            rows.append(dict(
                name=name, tag="whisper", main=False, shape=shape,
                max_abs_err=err_, ms=ms, plain_ms=timed[plain],
                library_ms=timed[lib_ms], bound_ms=bms, bound_by=by,
                tflops=flops[key] / ms / 1e9,
                library=("SDPA forward, not causal" if key == "fwd" else
                         "SDPA bf16 autograd backward, profiled")))
        print(f"[train-kernel] {shape}: out err {err:.3e}, lse err "
              f"{lse_err:.3e}, dq/dk/dv rel err {errs['dq']:.3e} / "
              f"{errs['dk']:.3e} / {errs['dv']:.3e} of max |plain|; two "
              f"backward calls bit-identical; #5 {timed['fwd_ms']:.4f} ms, "
              f"#6 {timed['dq_ms']:.4f} ms, #7 {timed['dkv_ms']:.4f} ms; "
              f"(#6 + #7) / SDPA backward "
              f"{(timed['dq_ms'] + timed['dkv_ms']) / timed['bwd_lib_ms']:.3f}"
              f"x; #5 / SDPA forward "
              f"{timed['fwd_ms'] / timed['fwd_lib_ms']:.3f}x", flush=True)
        del q, k, v, g, o, lse, po, plse, got, want, again, lib, leaves, out
        torch.cuda.empty_cache()
    for r_ in rows:
        print_row(r_, width=40)
    return rows


def whisper_leg(leg, cfg, fac, base, toks, frames, p, dev, new=0):
    """One leg of phase 21 (a) (``LEGS``, over ``base``): the forward
    over ``frames`` and ``toks[:, :p]`` (the encoder and the prefill; its
    logits (B, p, V)), then the positions
    p .. T + ``new`` - 1 decoded from the prefill's self-attention caches
    and its ``enc_out`` (``greedy_decode``: teacher-forced over ``toks``,
    then ``new`` greedy steps). Returns {"prefill", "decode": f32 logits,
    "tokens"}."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    f32, pol = LEGS[leg]
    c = f32_cfg(cfg) if f32 else cfg
    kw = dict(policy=getattr(dispatch, pol), device=dev)
    b, t = toks.shape
    with torch.inference_mode():
        pre = T.forward(base, c, fac.spec, fac.broadcast, fac.per_layer,
                        toks[:, :p], enc_embeds=frames, return_caches=True,
                        **kw)
        caches = prefilled_caches(c, pre.caches, b, t + new, p, dev)
        dec, full = greedy_decode(
            lambda tok, i: T.decode_step(base, c, fac.spec, fac.broadcast,
                                         fac.per_layer, tok, caches, i,
                                         enc_out=pre.enc_out, **kw)[0],
            toks, p, new, first=pre.logits[:, -1].float())
    return {"prefill": pre.logits.float(), "decode": dec, "tokens": full}


def whisper_serving(dev, count, tag="phase21"):
    """Phase 21 (a): full-width whisper-large-v3 (bf16, 32 + 32 layers)
    with MetaTT 4d on self- and cross-attention q / v at ``SERVED_RATIO``
    of the base q projection. The kernel leg: 4 x 1536 stub frames
    encoded and 4 x 256 tokens prefilled in one forward (192 K1; 96 K3 —
    32 encoder T = S = 1536, 32 causal T = S = 256, 32 cross T = 256 over
    S = 1536, by ``flash_kinds``), then 32 greedy decode steps from the
    prefill's self-attention caches, each recomputing the cross k / v
    from ``enc_out`` (128 K1 — xattn v over the 6144 rows of ``enc_out``
    among them — 32 K4 and 32 K3 cross at T = 1 a step), timed, one
    window profiled; the plain and f32 legs over the kernel leg's tokens
    (the f32 base, a copy of the bf16 one, built beside it); the prefill
    and decode logits under the witness rule (the 5% limit reported);
    the f32 decode against the f32 parallel forward over all 288
    positions within the JAX test's 2e-2."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg, spec, params, rt, gen = serving_model(dev, tag, WHISPER,
                                               SERVED_RATIO, variant="4d")
    base = params["base"]
    fac = dataclasses.replace(rt, base=None)
    b, p, n = WHISPER_BATCH, WHISPER_PROMPT_LEN, WHISPER_STEPS
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(cfg.compute_dtype)
    rng = np.random.RandomState(SEED + 21)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(b, p)),
                           device=dev)
    enc, dec = cfg.encoder_layers, cfg.num_layers
    w = min(16, p)
    whisper_leg("kernel", cfg, fac, base, toks[:, :w], frames, w, dev,
                new=2)                                   # warm-up
    torch.cuda.synchronize()
    held = {}
    with flash_kinds() as kinds:
        t0 = time.perf_counter()
        launches = count(lambda: held.update(pre=T.forward(
            base, cfg, spec, rt.broadcast, rt.per_layer, toks,
            enc_embeds=frames, return_caches=True, device=dev)))
        pre_ms = 1e3 * (time.perf_counter() - t0)
    check_launches(launches, {"tt_linear": 2 * enc + 4 * dec,
                              "flash_attention": enc + 2 * dec},
                   f"{tag} (a) encode + prefill")
    kinds_checked(kinds, {"encoder": enc, "decoder": dec, "cross": dec},
                  f"{tag} (a) encode + prefill")
    pre = held.pop("pre")
    caches = prefilled_caches(cfg, pre.caches, b, p + n, p, dev)
    with flash_kinds() as kinds:
        t0 = time.perf_counter()
        launches = count(lambda: held.update(dec=greedy_decode(
            lambda tok, i: T.decode_step(
                base, cfg, spec, rt.broadcast, rt.per_layer, tok, caches, i,
                enc_out=pre.enc_out, device=dev)[0],
            toks, p, n, first=pre.logits[:, -1].float())))
        step_ms = 1e3 * (time.perf_counter() - t0) / n
    check_launches(launches, {"tt_linear": 4 * dec * n,
                              "decode_attention": dec * n,
                              "flash_attention": dec * n},
                   f"{tag} (a) {n} decode steps")
    kinds_checked(kinds, {"cross": dec * n}, f"{tag} (a) {n} decode steps")
    del pre, caches, held
    base_b = sum(t_.numel() * t_.element_size() for t_ in M.tensors(base))
    dec_b = base_b - sum(t_.numel() * t_.element_size() for t_ in
                         M.tensors(base["enc_blocks"]))
    cross_flops = 2 * 2 * b * cfg.encoder_seq * cfg.d_model * cfg.kv_dim * dec
    step_bound = max(dec_b / PEAK_BYTES_S, cross_flops / PEAK_BF16_FLOP_S)
    print(f"[{tag}] (a) launches: {2 * enc + 4 * dec} K1 + {enc + 2 * dec} "
          f"K3 an encode + prefill, {4 * dec} K1 + {dec} K4 + {dec} K3 a "
          f"decode step, nothing else; encode of {b} x {cfg.encoder_seq} "
          f"frames + prefill of {b} x {p} tokens {pre_ms:.1f} ms; decode "
          f"{step_ms:.2f} ms a step = {b / step_ms * 1e3:.1f} tok/s against "
          f"a bound of {step_bound * 1e3:.3f} ms (the decoder's "
          f"{dec_b / 1e9:.3f} GB read, {dec_b / PEAK_BYTES_S * 1e3:.3f} ms; "
          f"the cross k / v recomputed from enc_out, {cross_flops:.3e} "
          f"FLOP, {cross_flops / PEAK_BF16_FLOP_S * 1e3:.3f} ms)",
          flush=True)

    def window():
        whisper_leg("kernel", cfg, fac, base, toks, frames, p, dev, new=8)
    device_share(f"{tag}: (a) one encode + prefill of {b} x "
                 f"{cfg.encoder_seq} frames / {p} tokens and 8 decode steps",
                 window, top_n=12, show=("tt_linear", "flash_fwd", "paged"))
    legs = {"kernel": whisper_leg("kernel", cfg, fac, base, toks, frames, p,
                                  dev, new=n)}
    full = legs["kernel"]["tokens"]
    base32 = tree_map(lambda t_: t_.float(), base)
    legs["plain"] = whisper_leg("plain", cfg, fac, base, full, frames, p,
                                dev)
    legs["f32"] = whisper_leg("f32", cfg, fac, base32, full, frames, p, dev)
    for what in ("prefill", "decode"):
        out = {leg: legs[leg][what].reshape(-1, legs[leg][what].shape[-1])
               for leg in ("kernel", "plain", "f32")}
        rel, agree, wit = legs_verdict(out)
        logits_checked(f"(a) {what} logits", rel, agree,
                       out["kernel"].shape[0], tag, wit)
    with torch.inference_mode():
        par = T.forward(base32, f32_cfg(cfg), fac.spec, fac.broadcast,
                        fac.per_layer, full, enc_embeds=frames,
                        policy=dispatch.REF, device=dev).logits[:, p:].float()
    d = legs["f32"]["decode"]
    gap = float((d - par).abs().max() / par.abs().max())
    print(f"[{tag}] (a) f32 prefill + decode steps against the f32 parallel "
          f"forward over positions {p} .. {p + n - 1}: max |decode - "
          f"parallel| / max |parallel| {gap:.3e} (limit 2e-2, the JAX "
          "test's)", flush=True)
    if not gap <= 2e-2:
        raise AssertionError(f"{tag}: f32 decode differs from the parallel "
                             f"forward by {gap:.3e}")
    del legs, base32


def phase_twentyone(dev):
    """Phase 21: whisper-large-v3 at full width and full depth (32
    encoder + 32 decoder layers of 1280, 20 heads of 64, gelu 5120,
    layernorm, vocab 51866, 1536 stub frames, bf16): (a) served
    (``whisper_serving``), (b) trained in phase 6's setting
    (``train_full_width``, 4 x 1024 decoder tokens over 4 x 1536 frames,
    4 steps): exactly ``bf16_train_per_step`` launches a step — 508 K1,
    160 #5 (32 encoder, 64 decoder, 64 cross), 96 #6 and 96 #7 — and
    nothing else, then the B = 1 gradient check with its f32 witness."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper_serving(dev, count)
    secs["(a) served"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_full_width(dev, configs.get_config(WHISPER), "phase21",
                             steps=4)
    for k_, v in train.items():
        total[k_] = total.get(k_, 0) + v
    secs["(b) trained"] = time.perf_counter() - t0
    print(f"[phase21] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 22: paligemma-3b (the patch_stub prefix) served and trained at full
# width and full depth
# ---------------------------------------------------------------------------

PALIGEMMA = "paligemma-3b"
#: (a) / (b): 4 x (256 stub patch embeddings + 256 tokens) prefilled
#: through ``make_prefill`` at task ``PALI_TASK`` (K1), then 32 greedy
#: steps through ``make_serve_step`` with a task a row (K2), from cell 512
PALI_BATCH, PALI_PROMPT_LEN, PALI_STEPS, PALI_TASK = 4, 256, 32, 1
#: the prefill positions whose logits the legs compare (the last ones)
PALI_CHECKED = 64
#: phase 2's rows at paligemma's 8 heads of 256 over one KV head (G = 8):
#: K3 at (a)'s prefill (B = 4, T = S = 512), K4 over (b)'s 544-cell cache
PALI_K3_CASES = ((512, 1),)
PALI_K4_CASES = ((1, 544, (512, 520, 530, 543)),)
#: #5, #6 and #7 at (d)'s training shape: 4 x (256 patches + 768 tokens)
PALIGEMMA_TRAIN_TAGS = {(4, 1024, 8, 1, 256): "paligemma"}


def paligemma_attention_rows(dev, rn):
    """K3 (B = 4, T = S = 512), K4 (4 slots of a 544-cell cache), #8 and
    #8q (8 slots, C = 1 and 32, 34-page tables of 16) at paligemma-3b's 8
    heads of 256 over one KV head (G = 8; the d = 256 instances): each
    within 2e-2 of its plain version, two calls bit-identical, its bound
    and SDPA with ``enable_gqa`` as library (``paligemma_rows`` of the
    records; #5, #6 and #7 at its training shape are
    ``PALIGEMMA_TRAIN_TAGS``' rows)."""
    rows = (k3_rows(dev, rn, h=8, d=256, cases=PALI_K3_CASES, sfx="_d256",
                    tag="paligemma", b=4)
            + k4_rows(dev, rn, h=8, d=256, cases=PALI_K4_CASES, sfx="_d256",
                      tag="paligemma")
            + paged_kernel_rows(dev, rn, h=8, d=256, sfx="_d256", kv=1,
                                tag="paligemma")
            + paged_int8_kernel_rows(dev, rn, h=8, d=256, sfx="_d256", kv=1,
                                     tag="paligemma"))
    for r_ in rows:     # the main rows stay gemma-7b's
        r_["main"] = False
    return rows


def paligemma_leg(leg, cfg, spec, params, base, toks, patches, p, dev,
                  new=0):
    """One leg of phase 22 (a)-(b) (``LEGS``, over ``base``):
    ``make_prefill`` over ``patches`` (B, Tp, d) and ``toks[:, :p]`` at
    task ``PALI_TASK``, then positions p .. T + ``new`` - 1 through
    ``make_serve_step`` with a (B,) task vector from cell Tp + p of the
    prefill's caches (``greedy_decode``). Returns {"prefill": the last
    ``PALI_CHECKED`` positions' f32 logits, "decode", "tokens"}."""
    import torch
    from repro_torch.config.base import KernelConfig
    from repro_torch.serving import engine as E
    f32, pol = LEGS[leg]
    c = f32_cfg(cfg) if f32 else cfg
    kern = None if pol == "DEFAULT" else KernelConfig(backend="ref")
    b, t = toks.shape
    tpl = patches.shape[1]
    prefill = E.make_prefill(c, spec, tpl + t + new, kernels=kern,
                             device=dev)
    step = E.make_serve_step(c, spec, kernels=kern, device=dev)
    w = (base, params["adapter"], params["frozen"])
    task = torch.full((b,), PALI_TASK, dtype=torch.long, device=dev)
    with torch.inference_mode():
        logits, caches, _ = prefill(*w, toks[:, :p], embeds=patches,
                                    task=PALI_TASK)
        dec, full = greedy_decode(
            lambda tok, i: step(*w, tok, caches, tpl + i, task=task)[0],
            toks, p, new, first=logits[:, -1].float())
    return {"prefill": logits[:, -PALI_CHECKED:].float(), "decode": dec,
            "tokens": full}


def paligemma_serving(dev, count, tag="phase22"):
    """Phase 22 (a)-(b): full-width paligemma-3b (bf16, all 18 layers)
    with a 4+1d MetaTT q / v adapter (rank 8, 3 tasks) at
    ``SERVED_RATIO`` of the base q projection. The kernel leg: 4 x 256
    stub patch embeddings (unit normal from the seed, as the JAX tests
    draw them, in bf16) and 4 x 256 tokens prefilled through
    ``make_prefill`` (2L K1 at 2048 -> 2048 / 256 and L K3 at d = 256,
    G = 8, T = S = 512), then 32 greedy steps through ``make_serve_step``
    from cell 512 (2L K2 and L K4 a step), timed, one window profiled;
    the plain and f32 legs over the kernel leg's tokens (the f32 base a
    copy of the bf16 one); the prefill and decode logits within 5% of
    the plain leg and under the f32 witness rule; the f32 decode against
    the f32 parallel forward over the prefix and all 288 tokens within
    the JAX test's 2e-2."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.tree import tree_map
    cfg, spec, params, rt, gen = serving_model(dev, tag, PALIGEMMA,
                                               SERVED_RATIO)
    base = params["base"]
    b, p, n = PALI_BATCH, PALI_PROMPT_LEN, PALI_STEPS
    tpl, L = cfg.frontend_seq, cfg.num_layers
    patches = torch.randn((b, tpl, cfg.d_model), generator=gen,
                          device=dev).to(cfg.compute_dtype)
    rng = np.random.RandomState(SEED + 22)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(b, p)),
                           device=dev)
    paligemma_leg("kernel", cfg, spec, params, base, toks[:, :16],
                  patches, 16, dev, new=2)                   # warm-up
    prefill = E.make_prefill(cfg, spec, tpl + p + n, device=dev)
    step = E.make_serve_step(cfg, spec, device=dev)
    w = (base, params["adapter"], params["frozen"])
    task = torch.full((b,), PALI_TASK, dtype=torch.long, device=dev)
    held = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        launches = count(lambda: held.update(pre=prefill(
            *w, toks, embeds=patches, task=PALI_TASK)))
        pre_ms = 1e3 * (time.perf_counter() - t0)
        check_launches(launches, {"tt_linear": 2 * L,
                                  "flash_attention_d256": L},
                       f"{tag} (a) prefill")
        logits, caches, _ = held.pop("pre")
        t0 = time.perf_counter()
        launches = count(lambda: held.update(dec=greedy_decode(
            lambda tok, i: step(*w, tok, caches, tpl + i, task=task)[0],
            toks, p, n, first=logits[:, -1].float())))
        step_ms = 1e3 * (time.perf_counter() - t0) / n
    check_launches(launches, {"tt_linear_batched_a": 2 * L * n,
                              "decode_attention_d256": L * n},
                   f"{tag} (b) {n} decode steps")
    del logits, caches, held
    base_b = sum(t_.numel() * t_.element_size() for t_ in M.tensors(base))
    print(f"[{tag}] (a) launches: {2 * L} K1 + {L} K3 (d = 256, G = 8) a "
          f"prefill of {b} x ({tpl} patches + {p} tokens) in {pre_ms:.1f} "
          f"ms; (b) {2 * L} K2 + {L} K4 a decode step, nothing else, "
          f"{step_ms:.2f} ms a step = {b / step_ms * 1e3:.1f} tok/s against "
          f"a bound of {base_b / PEAK_BYTES_S * 1e3:.3f} ms (the step reads "
          f"the whole {base_b / 1e9:.3f} GB base)", flush=True)

    def window():
        paligemma_leg("kernel", cfg, spec, params, base, toks, patches, p,
                      dev, new=8)
    device_share(f"{tag}: (a) one prefill of {b} x ({tpl} + {p}) and 8 "
                 "decode steps", window, top_n=12,
                 show=("tt_linear", "flash_fwd", "paged"))
    legs = {"kernel": paligemma_leg("kernel", cfg, spec, params, base, toks,
                                    patches, p, dev, new=n)}
    full = legs["kernel"]["tokens"]
    base32 = tree_map(lambda t_: t_.float(), base)
    legs["plain"] = paligemma_leg("plain", cfg, spec, params, base, full,
                                  patches, p, dev)
    legs["f32"] = paligemma_leg("f32", cfg, spec, params, base32, full,
                                patches, p, dev)
    for what in ("prefill", "decode"):
        out = {leg: legs[leg][what].reshape(-1, legs[leg][what].shape[-1])
               for leg in ("kernel", "plain", "f32")}
        rel, agree, wit = legs_verdict(out)
        logits_checked(f"(a)-(b) {what} logits", rel, agree,
                       out["kernel"].shape[0], tag, wit)
    with torch.inference_mode():
        par = T.forward(base32, f32_cfg(cfg), spec, rt.broadcast,
                        rt.per_layer, full, embeds=patches, task=PALI_TASK,
                        policy=dispatch.REF, device=dev
                        ).logits[:, tpl + p:tpl + p + n].float()
    d = legs["f32"]["decode"]
    gap = float((d - par).abs().max() / par.abs().max())
    print(f"[{tag}] (a)-(b) f32 prefix prefill + decode steps against the "
          f"f32 parallel forward over positions {tpl + p} .. "
          f"{tpl + p + n - 1}: max |decode - parallel| / max |parallel| "
          f"{gap:.3e} (limit 2e-2, the JAX test's)", flush=True)
    if not gap <= 2e-2:
        raise AssertionError(f"{tag}: f32 decode differs from the parallel "
                             f"forward by {gap:.3e}")
    del legs, base32, par
    gc.collect()
    torch.cuda.empty_cache()
    model = (cfg, spec, params, rt, gen)
    dense_cell(dev, count, model, tag, dense_requests(cfg),
               label="(c) dense, text only")
    from repro_torch.config.base import QuantConfig
    for quant, label in ((None, "(c) paged fp, text only"),
                         (QuantConfig(kv="int8"),
                          "(c) paged int8 KV, text only")):
        paged_cell(dev, count, model, quant, tag, label, profiled=False)


def phase_twentytwo(dev):
    """Phase 22: paligemma-3b at full width and full depth (18 layers of
    2048, 8 heads of 256 over one KV head — MQA, G = 8 — GeGLU 16384,
    vocab 257216, a prefix of 256 stub patch embeddings; 2.51 B
    parameters, bf16): (a)-(c) served (``paligemma_serving``), (d)
    trained in phase 6's setting (``train_full_width``, 3 steps of 4 x
    (256 patches + 768 tokens) under the prefix loss, ``PatchStream``):
    exactly 6L - 2 K1, 2L #5, L #6 and L #7 (d = 256) a step and nothing
    else, then the B = 1 gradient check with its f32 witness."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    total, secs = {}, {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paligemma_serving(dev, count)
    secs["(a)-(c) served"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_full_width(dev, configs.get_config(PALIGEMMA), "phase22",
                             steps=3)
    for k_, v in train.items():
        total[k_] = total.get(k_, 0) + v
    secs["(d) trained"] = time.perf_counter() - t0
    print(f"[phase22] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}; "
          + ", ".join(f"{k_} {v:.1f} s" for k_, v in secs.items()),
          flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 23: serve-time tensor parallelism on the card (a one-rank group)
# ---------------------------------------------------------------------------

#: stablelm-1.6b at full width and 4 of its 24 layers (the TP path is
#: per layer: depth adds nothing it does not already run), 16 new tokens
#: a request
TP_LAYERS, TP_NEW = 4, 16


def tp_steps_identical(cfg, rt, base, dev, label, row_parallel, kv_quant,
                       tag="phase23"):
    """Four dense decode steps from zero caches (4 slots, a task a slot)
    and two paged steps (a 16-token chunk, then a decode step) over
    ``base``, each once under the serve-TP context of the one-rank group
    (``row_parallel`` or not; the pools one rank's stripe, here all of
    them) and once without: the logits equal bit for bit."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import serve_tp
    spec, bc, pl = rt.spec, rt.broadcast, rt.per_layer
    b = 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    toks = torch.randint(0, cfg.vocab_size, (b, 17), generator=gen,
                         device=dev)
    task = torch.arange(b, device=dev) % 3
    pos = torch.zeros(b, dtype=torch.long, device=dev)
    tables = torch.tensor([[2 * i, 2 * i + 1, 2 * b] for i in range(b)],
                          dtype=torch.int32, device=dev)

    def run():
        caches = T.init_caches(cfg, b, 32, cfg.compute_dtype, device=dev)
        out = [T.decode_step(base, cfg, spec, bc, pl, toks[:, i:i + 1],
                             caches, i, task=task, device=dev)[0]
               for i in range(4)]
        pools = T.init_paged_caches(cfg, 2 * b, 16, cfg.compute_dtype,
                                    kv_quant=kv_quant, device=dev)
        out.append(T.paged_step(base, cfg, spec, bc, pl, toks[:, :16], pools,
                                tables, pos, pos + 15, task=task,
                                device=dev)[0])
        out.append(T.paged_step(base, cfg, spec, bc, pl, toks[:, 16:], pools,
                                tables, pos + 16, pos, task=task,
                                device=dev)[0])
        return torch.stack(out)

    with torch.inference_mode():
        ref = run()
        with serve_tp(None, 1, row_parallel):
            got = run()
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{tag} {label}: serve-TP logits differ from "
                             "the unsharded ones by "
                             f"{float((got - ref).abs().max()):.3e}")
    print(f"[{tag}] {label}: 4 dense decode steps and 2 paged steps under "
          f"the serve-TP context (one rank, row_parallel={row_parallel}) "
          "bit-identical to the unsharded logits", flush=True)


def phase_twentythree(dev):
    """Phase 23: serve-time tensor parallelism (``ServeConfig(mesh_shape=
    (1, 1))``) over a one-rank NCCL group (a ``file://`` store in the
    checkout's ``build/``) on full-width stablelm-1.6b at ``TP_LAYERS``
    of its 24 layers with the 4+1d adapter: the dense engine (K2, K4 a
    decode step), the paged engine (#8), the paged engine over int8
    weights and KV (#8q) and the dense engine over int8 weights (#9 a
    prefill, #10 a decode step), each with and without ``row_parallel``:
    every request's tokens equal to the unsharded engine's, ``shards ==
    1``; the step logits bit-identical (``tp_steps_identical``); K2, K4,
    #8, #8q, #9 and #10 launched by the TP engines. Multi-rank TP needs
    more than one card: the CPU tests hold 2 and 4 gloo ranks."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.config.base import QuantConfig, ServeConfig
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.serving import Engine
    tag = "phase23"
    total = {}

    def count(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = K.launch_counts()
        for k_, v in n.items():
            total[k_] = total.get(k_, 0) + v
        return n

    gc.collect()
    torch.cuda.empty_cache()
    store = os.path.join(ROOT, "build", f"tp_store_{os.getpid()}")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        cfg, spec, params, rt, gen = serving_model(
            dev, tag, layers=TP_LAYERS, ratio=SERVED_RATIO)
        dense = [dataclasses.replace(r, max_new_tokens=TP_NEW)
                 for r in dense_requests(cfg)[:4]]
        paged = [dataclasses.replace(r, max_new_tokens=TP_NEW)
                 for r in paged_requests(cfg)[:8]]
        q8 = QuantConfig(weights="int8", kv="int8")
        w8 = QuantConfig(weights="int8")
        cells = (("dense", "dense", QuantConfig(), ("tt_linear_batched_a",
                                                    "decode_attention")),
                 ("paged", "paged", QuantConfig(),
                  ("paged_decode_attention",)),
                 ("paged int8 weights + KV", "paged", q8,
                  ("paged_decode_attention_int8",)),
                 ("dense int8 weights", "dense", w8,
                  ("tt_linear_w8", "tt_linear_batched_a_w8")))
        for label, mode, quant, want in cells:
            sv = (dict(PAGED) if mode == "paged"
                  else dict(max_batch=4, cache_len=256, out_cap=32))
            sv.update(cache_mode=mode, quant=quant)
            reqs = paged if mode == "paged" else dense
            eng = Engine(cfg, rt, serve=ServeConfig(**sv), device=dev)
            ref = [o.tolist() for o in eng.generate(reqs)]
            qbase = eng.base_weights
            del eng
            for rp in (False, True):
                eng = Engine(cfg, rt, serve=ServeConfig(
                    mesh_shape=(1, 1), row_parallel=rp, **sv), device=dev)
                got = {}
                n = count(lambda: got.update(o=eng.generate(reqs)))
                st = eng.last_stats
                toks = [o.tolist() for o in got["o"]]
                if toks != ref:
                    raise AssertionError(f"{tag} {label} rp={rp}: tokens "
                                         "differ from the unsharded engine")
                if st.shards != 1 or any(not n.get(k_) for k_ in want):
                    raise AssertionError(f"{tag} {label} rp={rp}: shards "
                                         f"{st.shards}, launches {n}")
                print(f"[{tag}] {label}, mesh (1, 1), row_parallel={rp}: "
                      f"{len(reqs)} requests, {st.tokens_generated} tokens "
                      f"equal to the unsharded engine's, {st.tokens_per_s:.1f}"
                      f" tok/s, shards {st.shards}, kv_bytes_peak "
                      f"{st.kv_bytes_peak} (per shard "
                      f"{st.kv_bytes_peak_per_shard}); launches "
                      f"{json.dumps({k_: v for k_, v in n.items() if v})}",
                      flush=True)
                del eng
                base = qbase if quant.weights == "int8" else params["base"]
                tp_steps_identical(cfg, rt, base, dev,
                                   f"{label}, row_parallel={rp}", rp,
                                   quant.kv == "int8")
            del qbase
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    for k_ in ("tt_linear_batched_a", "decode_attention",
               "paged_decode_attention", "paged_decode_attention_int8",
               "tt_linear_w8", "tt_linear_batched_a_w8"):
        if not total.get(k_):
            raise AssertionError(f"{tag}: {k_} never launched")
    print(f"[{tag}] launches on the path "
          f"{json.dumps({k_: v for k_, v in total.items() if v})}",
          flush=True)
    return total


def main(argv) -> int:
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
        unknown = set(only) - set(KERNELS)
        if unknown:
            print(f"--only: unknown kernels {sorted(unknown)}", file=sys.stderr)
            return 2
    elif argv:
        print("usage: chip_smoke.py [--only KERNEL[,KERNEL...]]",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print(sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0], flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = t_start = time.perf_counter()
    logs = _build.build_all(force=True)
    secs = {"build": time.perf_counter() - t0}
    print(f"[build] nvcc sm_90a: {', '.join(sorted(logs))} in "
          f"{secs['build']:.1f}s", flush=True)
    for name, path in sorted(logs.items()):
        kern = spill = ""
        for line in open(path).read().splitlines():
            if "Compiling entry function" in line:
                kern = kernel_name(line.split("'")[1])
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"[ptxas] {name}: {kern}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")

    if only:   # the named kernels' rows alone, then stop: no result
        phase_kernels(dev, only)
        if set(only) & set(F32_KERNELS):
            phase_f32_kernels(dev)
        if set(only) & set(D256_TRAIN):
            phase_train_kernels(dev, [s_ for s_ in TRAIN_ATTN_SHAPES
                                      if s_[4] == 256], None)
        if set(only) & set(GQA_TRAIN):
            phase_train_kernels(dev, list(GQA_TRAIN_TAGS)
                                + list(JAMBA_TRAIN_TAGS), None)
            whisper_train_rows(dev)
        if set(only) & set(D112_TRAIN):
            phase_train_kernels(dev, list(KIMI_TRAIN_TAGS), None)
        return 0
    secs["phase 1"] = time.perf_counter() - t_start

    def timed(label, fn, *args):
        t_ = time.perf_counter()
        out = fn(*args)
        secs[label] = time.perf_counter() - t_
        return out

    rows = timed("phase 2", lambda: phase_kernels(dev)
                 + phase_train_kernels(dev) + whisper_train_rows(dev)
                 + phase_f32_kernels(dev))
    paths = {}
    paths["serve"], dense_run = timed("phase 3", phase_serving, dev)
    paths["paged"], paged_run = timed("phase 4", phase_paged, dev)
    paths.update(timed("phase 5", phase_quant, dev, dense_run, paged_run))
    paths["train"], train_cores = timed("phase 6", phase_training, dev)
    paths["adapters"] = timed("phase 7", phase_adapters, dev, dense_run,
                              paged_run, train_cores)
    paths["phase8"] = timed("phase 8", phase_rest, dev, dense_run, paged_run,
                            train_cores)
    for n_, fn in ((9, phase_nine), (10, phase_roberta), (11, phase_eleven),
                   (12, phase_twelve), (13, phase_thirteen),
                   (14, phase_fourteen), (15, phase_fifteen),
                   (16, phase_sixteen), (17, phase_seventeen),
                   (18, phase_eighteen), (19, phase_nineteen),
                   (20, phase_twenty), (21, phase_twentyone),
                   (22, phase_twentytwo), (23, phase_twentythree)):
        paths[f"phase{n_}"] = timed(f"phase {n_}", fn, dev)
    print("[time] " + "; ".join(f"{k_} {v:.1f} s" for k_, v in secs.items())
          + f"; the script {time.perf_counter() - t_start:.1f} s "
          "(phase 1: the build and the device query)", flush=True)

    records = []
    for name, (src, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["main"])
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        rec = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"])
        if "library" in main_row:
            rec["library"] = main_row["library"]
        if name in F32_KERNELS:   # every phase-2 row of an f32 instance
            rec["rows"] = [{k: r[k] for k in (
                "shape", "max_abs_err", "rel_err", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "tflops")}
                for r in mine]
        keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")
        if name in D256_KERNELS + D112_KERNELS:   # every phase-2 row of a
            # d = 256 or d = 112 instance
            rec["rows"] = [{k: r[k] for k in keys + (
                "variant", "variants", "slab_heads", "lse_err", "library",
                "tag", "tflops") if k in r} for r in mine]
        for model_tag in ("gemma", "kimi", "jamba", "xlstm", "whisper",
                          "paligemma"):
            # K1, K2, #9, #10 at gemma-7b's and kimi-k2's q / v; K1 at
            # jamba's mamba in / out, K3, K4 and #5-#7 at its attention; K1
            # and K2 at xlstm-125m's projections; K1, K3 (encoder, cross),
            # K4 and #5-#7 (encoder, cross) at whisper-large-v3's (not the
            # _d256 / _d112 instances, whose rows are above); K3, K4, #8,
            # #8q and #5-#7 at paligemma-3b's heads (d = 256 instances,
            # also in their "rows")
            tagged = [{k: r[k] for k in keys} for r in mine
                      if r.get("tag") == model_tag
                      and (model_tag == "paligemma"
                           or not re.search(r"_d\d+$", name))]
            if tagged:
                rec[f"{model_tag}_rows"] = tagged
        gqa = [{k: r[k] for k in keys + ("tag", "variant", "variants",
                                         "slab_heads", "library")
                if k in r} for r in mine if r.get("tag") in GQA_MODELS]
        if gqa:          # K1, K2, K4, #8, #8q, #5-#7 at granite's / mistral's
            rec["gqa_rows"] = gqa
        ranks = [{k: r[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "tflops", "variant")}
            for r in mine if r.get("rank_row")]
        if ranks:        # K1 above rank 64, phase 2
            rec["ranks"] = ranks
        for r in mine:   # K1 again, at the training shape
            if r.get("role"):
                rec[r["role"]] = {k: r[k] for k in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "tflops", "variant", "variants",
                    "function_bwd_ms", "plain_autograd_bwd_ms") if k in r}
            elif r["main"] and "variant" in r:
                rec.update(variant=r["variant"], variants=r["variants"])
        records.append(rec)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
