#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed N]

1. Set-up: exits non-zero without a CUDA card or without the port's
   package beside this script; prints the card's name and power limit;
   builds every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints each kernel's register,
   shared-memory and spill use, and the int8 tensor-core instructions
   (IMMA) in the SASS of ``mbconv_int8``, ``supersite_int8``,
   ``int8_matmul`` and ``group_agg`` (none is a failure, and so is a
   ``__dp4a`` in ``int8_matmul``'s).
2. fp32 phase.
   a. Each fp32 kernel against its plain PyTorch version on the card, at
      every distinct shape of the B1@224 main path at batch 1 and 8:
      ``max|d| <= 1e-4 * max(1, max|ref|)``.  Times are device times
      from CUDA events over back-to-back launches (inputs warm in L2),
      median of 5 windows; the bound is max(bytes / 3.35 TB/s, flops /
      67 TFLOP/s), the H100 SXM's published memory rate and non-tensor
      fp32 rate, with each input read once and each output written once.
      Every kernel runs at the blocks the served plans of 2b's tuned
      engines freeze (band height, mid chunk, cluster size; the
      attention's ``block_n``), so ``[autotune]`` runs before 2a.  The
      super-site chain kernel ``supersite_fused`` runs at the two chains
      of B1@224 (S1.ss0 = S1.mb0..mb1, S2.ss0 = S2.mb0..mb2) with those
      plans' band height and channel chunk; its bound counts the chain's
      input, output and weight pack once and the members' MACs without
      the bands' halo recompute.  Two calls of each of these two kernels
      must give equal bits (fixed summation orders).  Two sweeps time
      the blocks around the choices (the evidence both ``choose_blocks``
      follow): ``mbconv_fused`` at S1.mb1, S3.mb0 (stride 2), S3,
      S4.mb0 (stride 2) and S4 over band x chunk x cluster size, with
      the clusters the card holds at once
      (``cudaOccupancyMaxActiveClusters``), and ``supersite_fused`` at
      both chains over band heights 1-4 x chunks 16-128 that fit.  The
      ``[dsconv sweep]`` lines time ``dsconv_fused`` at stem.ds0, batch 1
      and 8, over band heights (output rows a CTA), the pick of its
      ``choose_blocks`` marked; the ``[dsconv]`` lines hold it within
      ``TOL`` of the plain version at C and F no multiple of 4 (6 -> 10
      at stride 1 and 2, 3 -> 7).
      ``relu_attn_noncausal`` at both MSA shapes (S3, S4), batch 1 and 8,
      with ``out=`` omitted and given (the projection's map): within
      ``TOL`` of the plain version, equal bits on two calls and between
      the forms, and each image's rows of a batch-8 call equal to its
      batch-1 call (``[relu_attn]`` lines).
   b. ``[autotune]`` (run first, before 2a): every plan of the run tunes
      into a fresh cache file under ``build/autotune/``.  B1@224 at both precisions: the
      model's engines (``autotune=False``: each kernel's deterministic
      pick), then the tuned engines, whose builds sweep the cold cache
      (each sweep's candidates and device times, the choice and the
      model's pick printed, and the blocks that differ per bucket); a
      second fp32 engine, the in-process cache dropped, reads the file
      and sweeps nothing; no candidate is disqualified; 19 / 26 launches
      per forward (22 / 29 with ``supersites=False``); the fp32 logits
      within the section-5 gates; the FIX8 plans and logits equal with
      autotune on and off; the batch-8 replay's device time of the
      model's plan and the tuned one, A/B in one process.  The tuned
      engines are the ones 2b and 3b check.
      ``VisionEngine`` over B1@224 fp32 (random weights and BN
      statistics from ``--seed``, microbatch 8), warmed: every bucket
      (1, 2, 4, 8) on the default plan, which groups exactly S1.ss0 and
      S2.ss0 in every bucket (their blocks, band windows and recompute
      factors are printed).  Each group's weight pack is built once per
      engine and hit by every later bucket.  One batch-8 forward under
      the per-site plan
      (``supersites=False``) must match the grouped one within 1e-4 *
      max(1, max|logit|), with the same top-1.  Then the steady state:
      64 images as 8 full buckets (host clock), one batch-8 forward's
      device time (CUDA events, one forward per window) as a graph
      replay and run eagerly, beside the host's time per replay (the
      same for FIX8).  Every executor serves from a CUDA graph captured
      at warm-up: each key's capture must have issued exactly the
      launches per forward of 5 (a replay runs no wrapper and counts
      nothing), and its growth of the cache's graph pool is printed; the
      ``degraded``, ``pinned_fp``, ``retries`` and ``failed`` counters
      stay 0.  The ``[graph]`` lines: at batch 1, 4 and 8 the replayed
      logits equal the eager forward of the same plan bit for bit, and 64
      images sent as 8 buckets of 8 before any is read equal the 8
      forwards run one at a time (the same for FIX8).
3. FIX8 phase.
   a. Each int8 kernel against its plain PyTorch version at every B1@224
      int8 shape of the tuned FIX8 plan, batch 1 and 8, on random int8
      codes: the
      int8 outputs and the fp32 outputs must be EQUAL (both round every
      fp32 step in the same order).  The bound is max(bytes / 3.35 TB/s,
      int8 ops / 1,979 TOPS); ``int8_matmul`` is also timed against
      ``torch._int_mm`` + the same epilogue, a yardstick the port never
      calls.  ``supersite_fused_int8`` runs both chains with the served
      exit (int8 codes + scales + the kept fp map).  The FIX8 MBConv's
      cases name the path they take (``mbconv_int8_path``).  The
      ``[mbconv_int8 sweep]`` lines time it at S3, S4, S3.down, S4.down
      and S2.mb1, batch 1 and 8, on the passes and on the cluster kernel
      at every legal rank count that fits (with the clusters the card
      holds at once), the path rule's choice marked.  The ``[int8_matmul
      sweep]`` lines time ``int8_matmul`` at the four MSA projections,
      batch 1 and 8, at every legal tile, with the pick of
      ``int8_gemm_plan`` marked and its time over the fastest cell; the
      ``[int8_emit sweep]`` lines time the library's ``int8_matmul_emit``
      at the same projections (196 or 49 rows an image) on every cluster
      cell (tile, ranks, the clusters the card holds at once) and on the
      plain grid, each EQUAL to the plain version, with the pick of
      ``int8_emit_plan`` against the fastest cell and the fastest of each
      rank count; the ``[group_agg sweep]`` lines time ``group_agg_int8`` at both
      aggregation maps on the two launches and on the cluster kernel at
      every rank count that holds whole groups and fits a CTA, the choice
      of ``group_agg_path`` marked; the ``[dsconv_int8 sweep]`` lines
      time ``dsconv_fused_int8`` at stem.ds0 on the passes and on the
      cluster kernel at every rank count that fits, each cell EQUAL to
      the plain version, the choice of ``dsconv_int8_path`` marked.
   b. ``VisionEngine.quantized`` over the same fp tree, quantized by the
      port, warmed on the default plan (S1.ss0 and S2.ss0 grouped): row i
      of a batch-8 forward must equal the batch-1 forward of image i bit
      for bit, and the batch-8 forward under the per-site plan must equal
      the grouped one bit for bit.  The site walk prints the first int8
      boundary whose codes differ from the int8 reference forward's
      (``site_walk``).  Pack residency, graphs, steady state and
      ``[graph]`` lines as in 2b.
   c. ``[epilogues]``: FIX8 B1@224 served with ``epilogues=False``
      (no producer epilogue: each int8 consumer quantizes its own input)
      beside 3b's engine: plan launches, the wrappers' launches per
      forward, the batch-8 replay's device time A/B in one process, and
      both held to the FIX8 gates of the int8 reference forward.
      ``[overrides]``: fp32 B1@224 served with a ``group_break`` on
      ``S2.mb1`` (S2.ss0 = S2.mb1..mb2, S2.mb0 alone: 20 plan launches)
      and with ``fused=False`` on ``S3.evit1.mb`` (reason ``"search"``),
      each from its captured graph within the fp32 gates.
   d. ``[faults]``: the fault ladder on the card, B1@224, one bucket of
      8, a ``ManualClock``.  fp32: a ``FaultPlan`` fires ``kernel.launch``
      twice on ``S2.mb1`` (a member of S2.ss0): the key must reach level
      1 with that site demoted, its plan must group as ``plan_program(...,
      demote=)`` says (S1.ss0 only; S2.mb0 and S2.mb2 run alone), a new
      graph must be captured whose replay launches 11 ``mbconv_fused``
      and 1 ``supersite_fused``, and every request must complete within
      the fp32 gate of the reference forward.  FIX8: ``epilogue.numerics``
      fires once; the key pins to fp, a new graph runs no int8 kernel,
      and every request completes within the FIX8 gate.  At both, a
      request whose 1 ms hard deadline passes while queued is shed
      before batch formation and takes no slot.  ``[autotune fault]``:
      fp32, buckets (1, 8), a fresh cache file; with ``FaultSpec(
      "autotune", times=1)`` installed, one request's cold bucket-1 build
      fails at its first tuner consultation (stem.ds0), the retry meets
      the negative cache, the ladder demotes stem.ds0 (level 1), and the
      key is planned, captured anew and served within the fp32 gates.
4. Kernel-library phase: the four kernels no served forward runs, each
   through the JAX package's public op at full width.  Every counter is
   reset just before the ops run once per case and read just after: one
   launch per case, and none of the served kernels.
   a. ``conv1x1_w8a8(epilogue=int8)`` -> ``int8_matmul_emit``: the MSA
      QKV and output projections of B1@224 (S3 128->384 and 256->128 at
      196 rows per image, S4 256->768 and 512->256 at 49), batch 1 and 8,
      keep-fp off and on, with bias; and keep-fp on with a static
      ``x_scale`` from ``calibrate_act_scale``.  Every case takes the
      cluster path (``int8_emit_plan``): one CUDA launch a call.
   b. ``dsconv_apply_int8(epilogue=int8)`` -> ``dsconv_fused_int8_emit``:
      stem.ds0 of B1@224 (112x112x16 -> 16) and a stride-2 56x56x32 ->
      32, batch 1 and 8, keep-fp off and on; every case one cluster
      launch (``dsconv_int8_path(..., emit=True)``).
   c. ``relu_linear_attention(causal=True, block_n=256)`` ->
      ``relu_attn_causal``: Zamba2-1.2B's attention slot (1, 32768, 32,
      64) and the global layer of the repo's Gemma3-12B config (unverified
      tier: head_dim 240, where the published model has 256) under
      relu_linear (1, 32768, 16, 240; 8 kv heads repeated), a ragged
      N = 32668, and bf16 inputs once.
   d. ``ssd_op(chunk=256, D_skip=D)`` -> ``ssd_chunked``: Mamba2-1.3B's
      SSD layer (b 1, s 32768, h 64, p 64, g 1, n 128) and s = 32668.
   Each op's output must be its kernel's (bit for bit, the kernels are
   deterministic), and each kernel is held against its plain version on
   the same inputs: int8 outputs EQUAL, fp32 within ``TOL`` (c and d
   against the plain versions in their kernels' stages:
   ``relu_attn_causal_scan``, ``ssd_scan_ref``).  The lines of a, c and d
   give each call's CUDA launches (a: 1 on the cluster path; c and d:
   states, prefix, outputs, with the workspace bytes) from the wrappers'
   plans; one ``torch.profiler`` capture over one call of each, after
   the phase's timing, must count
   those launches and nothing else.  Bounds as
   in 2a/3a (the int8 peak for a and b, the fp32 non-tensor peak for c
   and d); c and d count only the causal triangle of each chunk, no
   state read in the first chunk and no state update after the last;
   with bf16 inputs the two products of bf16 operands (ReLU(Q)ReLU(K)^T,
   ReLU(K)^T V) count at the bf16 tensor-core peak, 989 TFLOP/s, and the
   two with an fp32 operand at the fp32 one.  ``int8_matmul_emit`` is
   also timed against ``torch._int_mm``
   + the same epilogue and per-image quantize.  The 32k-token cases are
   timed over 3 windows of 2 calls.
   e. ``[B2]`` and ``[B3]`` at 224 px, published widths and depths,
      random weights and BN statistics from ``--seed`` + 2 / + 3, fp32
      then FIX8, each served by ``VisionEngine(microbatch=8, buckets=(1,
      8), autotune=True)`` on the run's cache.  Per precision: the
      launch counters set to 0 before the engine is made and warmed and
      read after (less the sweeps' launches): twice each key's captured
      launches; the plan (its groups and blocks, the sites the Hopper fit
      declines, the runs of conv sites no band of a chain fits); the
      blocks tuned off the model's pick; 8 images' logits against the
      port's reference forward (fp32 within rtol = atol = 1e-3, top-1
      equal; FIX8 within 0.1 * max|logit| of the int8 reference and
      within twice the reference's own noise of it, top-1 equal wherever
      the reference's margin exceeds twice that noise; the noise is the
      farthest the int8 reference's batch-8 rows lie from its batch-1
      forwards, ROADMAP R6; every flip, the noise, the margins and the
      site walk are printed); replay = eager at batch 1 and 8; FIX8 batch
      invariance; the steady state as in 2b.  Then every served kernel
      shape of both plans (the chains with their groups' blocks), batch
      1 and 8, against its plain version as in 2a and 3a
      (``relu_attn_noncausal`` and ``group_agg_int8`` at d = 32 among
      them); the ``[B2]`` / ``[B3]`` lines give each shape's time.
5a. Sharded serving and the observability layer, B1@224 at full width
   and depth, fp32 then FIX8 (before section 5: its profiler comes after
   every timed phase).  A ``VisionEngine(tracer=Tracer())``, warmed, is
   the reference.
   a. ``[trace]``: the 12 mixed-deadline requests of section 5 through
      its scheduler: every request's chain complete (``request_chains``:
      queue; dispatch, device, finalize), no span open after the drain,
      the exported file (in a temporary directory) passes
      ``validate_chrome_trace``.  Printed: the tracer's host cost, the
      time inside its calls per request over 256 served requests, and
      steady-state images/s with and without the tracer (informational).
   b. ``[metrics]``: the engine's telemetry as Prometheus text, p99
      latency per bucket printed; the unlabelled counter samples must
      parse back to the telemetry's counters.
   c. ``[sharded]``: ``VisionServeConfig(devices=("cuda:0",) * 4)`` (four
      fault domains on one card, plus every CUDA device where there are
      several).  Every launch counter is set to 0 just before the sharded
      engine is made and warmed and 8 requests served, and read just
      after: each member's graph (one per member, its own stream, one
      pool per card) captured one forward at its local batch, and the
      wrappers launched twice that per member.  The batch-8 logits (local
      batch 2) against the reference engine: FIX8 bit-equal, fp32 within
      1e-5 * max(1, max|logit|), top-1 equal.  ``device_dropout``: an
      injected ``device.dropout`` on domain 3 shrinks the mesh 4 -> 3,
      bucket 8 runs 2-wide at local batch 4, every request completes with
      ``device_lost`` = 1, ``mesh_shrunk`` = 1, no ladder move, the same
      gates.  ``mesh_loss``: the other three domains lost one per
      dispatch; the in-flight requests and a late one end ``failed`` with
      ``MeshExhausted``, nothing outstanding.  After the served run and
      after the dropout, every kernel case and chain of bucket 8's member
      plan (local batch 2, then 4, planned and tuned at that batch)
      against its plain version as in 2a and 3a.  Printed: each key's
      members and launches per member replay, images/s sharded against
      unsharded (informational).
   d. ``[drift]``: ``profile_execute`` (a pair of CUDA events per site,
      read after the forward) and ``drift_report`` on the reference
      engine's batch-8 plan, grouping off: every site recorded, every
      ratio finite.  Printed: the per-site event sum beside one eager
      per-site forward timed by events, and the ten sites with the
      largest measured time beside the cycle model's predicted cycles
      (the paper's FPGA at 200 MHz).
5. The main path, fp32 then FIX8.  Every launch counter is set to 0
   just before a new engine is made (``VisionEngine``, then
   ``VisionEngine.quantized``) and warmed, and read just after it has
   served 12 requests with mixed deadlines through its scheduler.  The
   wrappers launch only in the warm-up: each key's eager warm-up run
   and its capture, so each kernel's count must be twice its launches
   per forward times the keys.  Per forward: fp32 dsconv_fused 1x,
   mbconv_fused 9x, relu_attn_noncausal 7x and supersite_fused 2x; FIX8
   int8_matmul 14x, group_agg_int8 7x, mbconv_fused_int8 7x,
   mbconv_fused_int8_emit 2x, dsconv_fused_int8 1x, relu_attn_noncausal
   7x and supersite_fused_int8 2x.  The served run is captured by
   ``torch.profiler``, with one eager forward of each dispatched
   bucket after it: split at each copy-in, the run must hold one replay
   per dispatch, and each replay must launch on the device exactly the
   port's kernels of its bucket's eager forward, by name and count (the
   eager forwards' wrappers launching the counts above).  The fp32
   logits must match the port's reference forward (``execute`` with
   ``plan=None``) on the card within rtol = atol = 1e-3, with the same
   top-1; the FIX8 logits must have the top-1 of the port's int8
   reference forward and lie within 0.1 * max|logit| of it (the int8
   requants turn the fp32 attention core's reduction-order ulps into
   whole-code flips; the measured gap is printed).  No ladder counter
   moves.
6. ``torch.profiler``'s kernel time and launches per batch-8 graph
   replay by kernel name, fp32 and FIX8, after every timed phase: CUPTI
   may stay attached once the profiler has run and slow the host's
   launches.  The port's own kernels' CUDA launches, the memsets and the
   zero fills are counted apart, and the port's kernels of each of two
   replays must equal those of one eager forward of the same plan in the
   same capture, by name and count (a warm replay before them, which
   takes what the capture loses at its start, is printed, not counted);
   the same for the ``epilogues=False``
   FIX8 engine and for B2 and B3 at both precisions.  Then one call of
   each served FIX8 MBConv shape, each
   MSA projection GEMM, the library's emitting GEMM at each projection
   (per-image scales with keep-fp off and on, a static scale), each
   aggregation branch, the FIX8 DSConv at
   stem.ds0, the attention core at S3 and S4 (into the projection's
   map), the fp32 DSConv at stem.ds0 and the emitting FIX8 DSConv at
   stem.ds0 with and without keep-fp, at batch 8, must be one CUDA launch
   (the cluster kernels, the tensor-core GEMMs, the attention kernel, the
   fp32 band kernel), with no memset, no zero fill and no allocation but
   its outputs (none for the attention).
6b. ``[search fp32]`` / ``[search fix8]``: the offline schedule search
   and its artifact, B1 at full width and depth (``search_phase``),
   after section 6: a ``torch.profiler`` capture late in a process lost
   device events (``tools/profiler_drift.py``), so this phase does not
   push sections 5 and 6 later; its host seconds may carry the
   profiler's leftover cost.  A
   trace of 96 requests from ``--seed`` (Poisson arrivals at 400/s, 75 %
   at 224 px, 25 % at 256 px) is saved and loaded back (the same
   fingerprint); ``search(buckets=(1, 2, 4, 8), deadline_ms=20,
   iters=64)`` runs on the host with a tuner cache of its own (its
   seconds, the default and searched objectives, the buckets, demoted
   sites and split boundaries printed; searched <= default).  Two cold
   starts over the artifact's (bucket, resolution) keys, each on a fresh
   tuner cache: the default engine (``autotune=True``) and the artifact's
   (``VisionServeConfig(artifact=path)``), their seconds and sweeps; the
   artifact engine must sweep nothing and build every plan as the
   artifact froze it (decisions, groups, blocks).  Every launch counter
   is set to 0 just before the artifact engine is made and read just
   after the trace has been served through its scheduler on a
   ``ManualClock`` (one step per arrival, then the deadline's step and
   the drain): twice the captures' launches, every kernel of the
   precision's path launched; every request completed, none a real
   failure; the dispatches printed beside ``workload``'s model; logits
   per resolution against the reference forward with 2b's fp32 gates or
   3b's FIX8 gates; replay = eager at batch 8, 224 and 256 px.  Every
   kernel case and chain of the artifact's smallest and largest bucket
   at both resolutions against its plain version (as in 2a / 3a, at the
   artifact's blocks); the batch-8 replay A/B against the tuned default
   plan (informational); a JAX-style document (schema 1, no backend,
   Pallas block keys) refused with ``ArtifactError`` before any tuner is
   consulted or any kernel launched.
6c. ``[lm zamba2 fp32]``, ``[lm zamba2 bf16]``, ``[lm mamba2]``: the LM
   serving path (``lm_phase``), after 6b and with no profiler.  Each
   model at its published widths and depth, random weights from
   ``--seed``: Zamba2-1.2B under ``attn_backend="relu_linear"`` (38
   Mamba-2 layers, the shared attention + MLP block called 6 times) at
   fp32 and at its config's bf16, and Mamba2-1.3B (48 layers, state
   128) at fp32.  Each is served by a new ``ServingEngine`` (greedy, 32
   tokens a request): Zamba2 from 8 slots, prompts of 8, 17, 64, 255,
   256, 257, 1000, 2048, 4096 and 100 tokens (bf16: and 32768);
   Mamba2 from 2 slots, prompts of 100, 1000, 2048 and 4096.  Every
   launch counter is set to 0 just before the engine is made and read
   just after the run: ``ssd_chunked`` once per Mamba-2 layer and
   ``relu_attn_causal`` once per call of the shared block, per admitted
   request (38 and 6; 48 and 0), decode neither, every other kernel
   never.  Every request ends with 32 tokens.  fp32: each prefill's
   logits within 1e-3 * max(1, max|logit|) of the reference forward
   (``build_model(cfg, reference=True)``: the two scans' plain versions
   on the card), top-1 equal, and the served tokens equal a reference
   engine's wherever the reference's top-2 margin exceeds that
   tolerance (each flip printed with its margin; a request is compared
   up to its first flip).  bf16: every logit finite, each prefill's
   logits within 0.1 * max|logit| of the bf16 reference forward (the
   gaps printed).  Printed, informational: the peak allocated memory
   while serving; decode tokens/s over the served run and one decode
   step at every slot (host time to enqueue; device time, its launches
   captured into a CUDA graph and the replay timed by events); prefill
   tokens/s per prompt length (the served admission's host seconds);
   at 8, 100, 257, 4096 and 32768 tokens (``LM_PROFILED``) the host time
   to enqueue a prefill, its device time (its launches captured into a
   CUDA graph, the replay timed by events), the two scans' share of it
   and its peak memory, and each scan call held against its plain
   version and timed (``[lm kernel]`` lines, as ``[library]``).
6d. ``[lm softmax ...]``: softmax and sliding-window attention with
   their KV caches (``lm_softmax_phase``), after 6c.  Each model at its
   published widths (random weights from ``--seed``), served by a new
   ``ServingEngine`` from 8 slots, 32 greedy tokens a request,
   ``max_len`` the longest prompt + 64; prompts of 8, 17, 255, 1024,
   1025, 2048 and 4096 tokens (chunk 1024: on and off it), gemma3 also
   1020 (its 1024-slot rings wrap while decoding; 2048 and 4096 take the
   block-local sliding path), the bf16 runs cut to 8, 1025 and 4096
   (gemma3: and 1020): Granite-3-2B at fp32 (fp32 KV) and bf16;
   Zamba2-1.2B as published (the shared block on softmax) at fp32 and
   bf16; Gemma3-12B at fp32 cut to 12 layers (two groups) and at bf16
   full depth; Gemma3-12B under ``attn_backend="relu_linear"`` (its 8
   global layers on ``relu_attn_causal`` at d = 240) with prompts of 8,
   1025 and 32768 tokens; InternVL2-1B at bf16 (text prompts).  Counters
   as in 6c: per admission 38 ``ssd_chunked`` (Zamba2) and 8
   ``relu_attn_causal`` (Gemma3 relu_linear), none for the others, none
   in decode.  Gates: decode = re-prefill (``lm_decode_gate``: each
   request's logits at its first, second and last decode step against a
   fresh batch-1 prefill of its prompt and the tokens chosen before;
   fp32 within 1e-3 * max(1, max|logit|) with top-1 equal where the
   margin exceeds that, bf16 within 0.1 * max|logit|, all finite; the
   32768-token prompt only finite: a re-prefill of 32769 tokens takes
   the sliding fallback's 64 GiB score block); where
   a scan runs, each prefill's logits against the reference forward as
   in 6c.  ``[lm softmax internvl2 fp32]``: a prefill of 256 random patch
   embeddings + 64 tokens equals ``lm_logits_head`` over
   ``forward_hidden`` of the concatenation within 1e-3.  ``[lm softmax
   launch]``: ``launch.serve.main`` at its defaults (granite-3-2b, bf16)
   finishes 12 requests of 16 tokens.  Printed as in 6c, and also the
   plain attention cores' share of a prefill's device time (each core's
   first call at that length captured into a graph and replayed, times
   its calls: ``lm_core_probe``) and the KV cache's bytes, written at
   least twice a decode step (the row write and the re-stack), with the
   device time of two copies of it.
6e. ``[lm moe ...]``, ``[lm encdec ...]``: the MoE layer and family, the
   W8 transform and the encoder-decoder (``lm_moe_phase``), after 6d.
   No kernel of the port runs here (the expert products are
   ``torch.bmm``, as JAX leaves them to XLA): every counter is set to 0
   before each driven run and read after it, and must stay 0.  Random
   weights from ``--seed``, 8 slots, 32 greedy tokens a request, prompts
   of 8, 255, 1024 and 4096 tokens: Grok-1 at its published width (6144,
   48 / 8 heads of 128, 8 experts of 32768, top-2) at fp32 cut to 2 of
   its 64 layers (fp32 KV), and at bf16 cut to 4; Kimi-K2 (7168, 64 / 8
   heads of 112, 384 experts of 2048, top-8) at bf16 cut to 1 of 61.
   Each served run prints the share of prefill assignments its
   published capacity factor dropped per prompt length, and decode must
   drop none (a group per slot); every logit finite.  Decode =
   re-prefill (``lm_decode_gate``, fp32 within ``LM_TOL``, bf16 within
   ``LM_BF16_TOL``) on a second served run at capacity factor
   ``n_experts / top_k`` (capacity >= every length, so a re-prefill
   drops nothing decode kept; Grok-1 up to 1024 tokens, Kimi-K2 up to
   255).  The bf16 runs then take ``quantize_lm_params`` on the card, free
   the bf16 params and serve the W8 params on the same requests; the W8
   decode logits, teacher-forced on the bf16 tokens and routed as the
   bf16 run routed (``lm_route_probe``), must lie within relative L2
   ``LM_W8_TOL`` of the bf16 ones; the same with each run routing its
   own, and the share of (token, layer) whose top-k differs, printed
   (a random router at these widths flips a few per cent of them under
   W8's ~1 % perturbation, and a flipped route moves its token's logits
   far more than the quantization does).
   ``[lm moe slots]``: a smoke-width Kimi-K2 from 16 slots with one
   prompt in every slot gives every slot a batch-1 engine's tokens, no
   decode MoE row zero.  ``[lm encdec fp32|bf16]``: Seamless-M4T-large-v2
   whole (24 + 24 layers), frames B = 4 of 512 and 4096 positions, 32
   greedy decode steps against ``decode_train`` (``lm_encdec_run``).
   Printed: init and serving peaks, params and KV bytes, W8 bytes and
   dequant temporaries, prefill tokens/s, decode host / device time and
   idle, the expert products' and plain attention's share of a step, the
   encoder's time, cross-K/V bytes.
6f. ``[train ...]``: LM training on the card (``train_phase``), after
   6e.  Every launch counter is set to 0 just before each driven pass
   and read just after; a training step launches each scan once per
   layer in the forward and once more in the backward's recompute of
   the block (remat; the backward itself recomputes through the plain
   versions: ``train_scan_calls``), exactly.  ``[train grad zamba2]``:
   one Zamba2-1.2B group (6 Mamba-2 layers and the shared block,
   relu_linear) at published width, fp32, B = 2, S = 512: ``lm_loss``'s
   gradients through the kernels against ``build_model(cfg,
   reference=True)``'s (autograd through the plain scans), every leaf
   and the loss within 1e-4 * max(1, max|ref|); 12 ``ssd_chunked``, 2
   ``relu_attn_causal``; printed: the worst leaf with its max|ref|, and
   the worst leaf over its own max|ref|.  ``[train grad zamba2
   control]``: each scan in turn made wrong, its output times (1 +
   eps) for eps 1e-3, 1e-2, 1e-1, and its launch outside its autograd
   Function (a bare launch: no gradient back through the scan).  The
   same gate must fail the bare launch, or the pass raise (a param that
   reaches the loss only through the scan gets no gradient), and fail
   from eps 1e-2 on for ``ssd_chunked``, 1e-1 for ``relu_attn_causal``;
   below that the result is printed, not gated: the gate does not
   resolve it (the fp32 SSD kernel's own rounding moves the gradients
   by about as much).  ``[train flash granite-3-2b]``: published width,
   fp32, 4 of 40 layers, B = 1: ``flash_vjp=True`` against ``False``,
   loss and every gradient within the same bound, at S = 2048 and 1536
   (off the 1024 chunk: one chunk), the peak memory of each.
   ``[train zamba2 relu_linear]``: Zamba2-1.2B under
   relu_linear at published width and depth (bf16 params, the default
   AdamW: fp32 master, bf16 moments), the port's ``SyntheticLMDataset``
   (V = 32000, transition logits on the card), B = 8, S = 1024, a
   cosine schedule with 10 warmup steps, trained by ``Trainer`` for 30
   steps with checkpoints of the whole state every 10 steps into a
   temporary directory and one injected failure at step 25: steps 0-24,
   then 20-29 again from the step-20 checkpoint.  Gates: 76
   ``ssd_chunked`` and 12 ``relu_attn_causal`` a step over the 35 steps
   run, every loss finite, the last-5 mean (steps 25-29) below the
   first-5 mean by at least 0.1, the latest checkpoint at step 30, and
   steps 20-24's losses after the resume equal to theirs before the
   failure, bit for bit.  Printed: tokens/s per step over steps 0-24
   (median), one more step's host enqueue time and device span, the
   peak memory, the losses.  ``[train kernel]``: one more step keeps
   each scan's first call's inputs (bf16 (256, 1024, 64) for
   ``relu_attn_causal``, fp32 (512, 1024, 64) for ``ssd_chunked``); each
   is held against its plain version there within 1e-4 * max(1,
   max|ref|) and timed, its error feeding the kernels line.
6g. ``[dist ...]``: the distributed layer on a world of one NCCL rank
   in this process (``dist_phase``), after 6f: ``[dist collectives]``
   each collective at axis size 1 on CUDA tensors against its
   ``jax.lax`` meaning there, ``compressed_psum`` of a (4096, 4096) fp32
   tensor against its formula, bit for bit; ``[dist zamba2 1x1]`` 6f's
   Zamba2-1.2B run (same config, data, seed, schedule) for 5 steps
   through ``Trainer(mesh=)`` on a (1, 1) mesh, the sharded step on the
   rank's blocks.  Gates: each loss within 1e-5 * |loss| of 6f's step,
   exactly 12 ``relu_attn_causal`` and 76 ``ssd_chunked`` launches a
   step (the counters at 0 just before the run, read just after), and
   ``[dist kernel]``: one more step's scan calls held against their
   plain versions at the step's shapes.  Printed beside 6f's: tokens/s,
   peak memory, whether the losses are bit-equal.
6h. ``[dryrun ...]``: the dry-run (``launch/dryrun.py``, ``cost.py``)
   against the card, after 6g (``dryrun_phase``).  ``[dryrun predict
   zamba2 1x1]``: a child process (a fake process group of one rank,
   every tensor on meta) builds 6f's Zamba2-1.2B (relu_linear) train
   cell, B = 8, S = 1024, on a (1, 1) mesh with ``dryrun.build_cell``
   and counts its sharded step with ``cost.measure_step``: argument and
   peak bytes, FLOPs, bytes, collective bytes, the kernel calls and the
   roofline terms with the H100 constants (computed, not measured).
   ``[dryrun check zamba2 1x1]``: on a world of one NCCL rank, as 6g's,
   the same params, AdamW state and batch, then 3 steps of
   ``make_train_step(ctx=, specs=)`` (the first a warm-up).  Gates: the
   argument bytes (requested of the caching allocator, which hands out
   a cached block whole when under 1 MiB of it would be left) equal the
   prediction up to the allocator's rounding of each tensor to 512 B; ``max_memory_allocated`` over steps 2-3
   within 10 % of the predicted peak; ``analysis.HBM_BYTES`` the card's
   ``total_memory``; 12 ``relu_attn_causal`` and 76 ``ssd_chunked``
   launches a step, as predicted.  Printed: the step time and the
   predicted bound over it.  ``[dryrun serve zamba2 1x1]``: the sharded
   ``make_prefill_step`` on 8 prompts of 4096 tokens (38 ``ssd_chunked``
   and 6 ``relu_attn_causal`` launches, gated) and 8 sharded
   ``make_serve_step`` steps, logits and every cache leaf bit-equal to
   the unsharded steps'.  ``[dryrun serve grok-1 1x1]``: 6e's 2-layer
   Grok-1 cut (published width, bf16), 8 prompts of 256 tokens, 32
   decode steps: the MoE's per-row groups and the softmax combine over
   KV blocks under a ctx; each step's logits within 1e-2 * max|logit|
   of the unsharded decode's, both fed the unsharded run's tokens, and
   no decode assignment dropped.
6i. ``[tp ...]``: dense tensor parallelism (``distributed/tp.py``) on
   the card, after 6h (``tp_phase``): two processes (this script with
   ``--tp-rank``) on ``cuda:0`` meeting on gloo (NCCL refuses two ranks
   on one GPU), a (1, 2) ``("data", "model")`` mesh; the parent frees
   its cache and prints ``mem_get_info`` first.  ``[tp predict zamba2
   1x2]``: 6h's child on a fake group of two ranks counts rank 0's
   arguments and step peak; B halves from 8 until both ranks' peaks,
   the synthetic data and two contexts fit.  Each rank:
   ``TP_CHECK_STEPS`` steps of ``make_train_step(ctx=, specs=)`` on
   blocks built as the dry-run builds them (argument bytes equal to the
   prediction up to 512 B a tensor, measured / predicted peak within
   ``TP_PEAK_RANGE``, the blocks of ``LM_RULES``' shapes, every param
   leaf that ``loss_terms`` is handed its ``model`` block: 0 B beyond
   them); 6f's run for ``TP_STEPS`` steps through ``Trainer(mesh=,
   device="cuda:0")`` (step 1's loss within ``TP_LOSS_TOL`` of 6f's; 12
   ``relu_attn_causal`` at B x 16 heads and 76 ``ssd_chunked`` at B x
   32 a step, the first step's scan calls probed; tokens/s printed as
   two ranks sharing one card); 6h's Zamba2 serving on its trained
   params, the sharded prefill (6 / 38 launches) of the first
   ``TP_PROMPT`` tokens of 6h's prompts and decode on the unsharded
   run's tokens in fp32 (6h's params cast: a bf16 Zamba2's logits move
   ~5e-2 under any reordering of its sums), each logits block within
   ``TP_SERVE_TOL`` * max|logit| of the fp32 (1, 1) sharded steps' on a
   world of one NCCL rank in the parent (``tp_serve_ref``).  ``[tp
   kernel]``: rank 0's scan calls at the rank's heads held against their
   plain versions and timed beside the full head count.
7. One JSON line with every kernel's launches on its driven run(s)
   (sections 5, 5a's sharded paths, 6b's artifact engines, 6c's, 6d's
   and 6e's served LM runs, 6f's training passes, 6g's sharded run,
   6h's sharded train steps and prefill, 6i's ranks' steps, Trainer
   runs and prefills, and 4),
   error and times (ms are per B1@224 batch-8 forward, the sum over that
   forward's calls; for the four library kernels, the sum over the
   library phase's cases, one call each).
8. The last line: ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32, non-tensor (data sheet)
PEAK_INT8_OPS = 1979e12       # H100 SXM int8 tensor cores, dense
PEAK_BF16_FLOPS = 989e12      # H100 SXM bf16 tensor cores, dense
TOL = 1e-4
CHAOS = 0.1                   # FIX8 served logits vs the int8 reference
# the default plan's super-site groups at B1@224, both precisions
GROUPS = {"S1.ss0": ("S1.mb0", "S1.mb1"),
          "S2.ss0": ("S2.mb0", "S2.mb1", "S2.mb2")}
GROUPED = {m for members in GROUPS.values() for m in members}


def stamp(label: str, t0: float) -> None:
    """One ``[time]`` line: the script's wall time at ``label``."""
    print(f"[time] {label} at {time.perf_counter() - t0:.1f} s", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def device_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the mean device time of ``reps``
    back-to-back calls, from CUDA events.  A sleep kernel queued first
    keeps the card busy while the host enqueues the calls, so host
    overhead between launches does not count."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (1.5 * host_s + 1e-3)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def ops_seconds(ops, peak_ops: float) -> float:
    """Seconds the card's peak rates need for ``ops``: a count at
    ``peak_ops``, or (count, peak) pairs for work whose products run on
    different units."""
    if isinstance(ops, tuple):
        return sum(n / peak for n, peak in ops)
    return ops / peak_ops


def bound(nbytes: float, ops, peak_ops: float = PEAK_FP32_FLOPS
          ) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, ops_seconds(ops, peak_ops)
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def served_sites(cfg, batch, plan, image_size=None):
    """The fusible sites of ``cfg`` at ``batch`` (and ``image_size``, the
    config's by default) whose kernel a plan runs: every site without a
    plan, else the fused ones (a site the Hopper fit declined runs the
    reference path), and the names of those in a super-site group."""
    from repro_torch.core.program import lower
    sites = lower(cfg, batch=batch, image_size=image_size).fusible()
    if plan is None:
        return sites, GROUPED
    d = plan.decisions
    # a member the group rescued from "vmem" has no blocks of its own:
    # its shape runs only inside the chain
    return ([x for x in sites if d[x.name].fused and not (
                d[x.name].group and not d[x.name].blocks
                and d[x.name].precision == "fp")],
            {x.name for x in sites if d[x.name].group})


def kernel_cases(batch: int, gen, cfg=None, plan=None, image_size=None):
    """(kernel, site names, shape label, kernel fn, plain fn, bytes,
    flops) for every distinct fused shape of ``cfg`` (B1) at
    ``image_size`` (the config's, 224 px for B1) and ``batch`` (the sites
    ``plan`` fuses, every site without one).  The
    names are the sites whose per-site launch the served (grouped) plan
    makes; a shape only the super-site members have is still checked,
    with no site to its name (the per-site plan launches it)."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import decision_shape
    from repro_torch.kernels.dsconv.kernel import dsconv_fused
    from repro_torch.kernels.dsconv.ref import dsconv_ref
    from repro_torch.kernels.mbconv.kernel import choose_blocks as mb_blocks
    from repro_torch.kernels.mbconv.kernel import mbconv_fused
    from repro_torch.kernels.mbconv.ref import mbconv_ref
    from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
    from repro_torch.kernels.relu_attn.ref import relu_attn_noncausal_ref

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    groups: dict = {}
    fused, grouped = served_sites(cfg or B1, batch, plan, image_size)
    for site in fused:
        groups.setdefault((site.kind, decision_shape(site)), []).append(site)
    cases = []
    for (kind, shape), sites in groups.items():
        s = sites[0]
        names = [x.name for x in sites if x.name not in grouped]
        if kind == "dsconv":
            B, H, W, C, _, F, st = shape
            x, dw, db = rnd(B, H, W, C), rnd(3, 3, C, scale=1 / 3), rnd(C)
            pw, pb = rnd(C, F, scale=C ** -0.5), rnd(F)
            args = (x, dw, db, pw, pb)
            rows = (plan.decisions[s.name].blocks["block_rows"] if plan
                    else None)
            kfn = lambda a=args, st=st, r=rows: dsconv_fused(
                *a, stride=st, block_rows=r)
            pfn = lambda a=args, st=st: dsconv_ref(*a, stride=st)
            nbytes = 4 * (x.numel() + dw.numel() + db.numel() + pw.numel()
                          + pb.numel() + B * (H // st) * (W // st) * F)
            flops = 2 * B * (H // st) * (W // st) * (9 * C + C * F)
            label = f"x{tuple(x.shape)} F={F} s={st} R={rows or 'pick'}"
            name = "dsconv_fused"
        elif kind == "mbconv":
            B, H, W, C, M, F, st = shape
            Ho, Wo = H // st, W // st
            x = rnd(B, H, W, C)
            w1, b1 = rnd(C, M, scale=C ** -0.5), rnd(M)
            dw, db = rnd(3, 3, M, scale=1 / 3), rnd(M)
            w2, b2 = rnd(M, F, scale=M ** -0.5), rnd(F)
            args = (x, w1, b1, dw, db, w2, b2)
            b = (dict(plan.decisions[s.name].blocks) if plan
                 else mb_blocks(x.shape, M, F, st))
            kfn = lambda a=args, st=st, b=b: mbconv_fused(*a, stride=st, **b)
            pfn = lambda a=args, st=st: mbconv_ref(*a, stride=st)
            nbytes = 4 * (sum(t.numel() for t in args) + B * Ho * Wo * F)
            flops = 2 * B * (H * W * C * M + Ho * Wo * M * (9 + F))
            label = (f"x{tuple(x.shape)} M={M} F={F} s={st} R="
                     f"{b['block_rows']} bm={b['block_m']} "
                     f"split={b['split']}")
            name = "mbconv_fused"
        else:
            B, H, W, C = s.in_shape
            heads, d = s.attrs["heads"], s.attrs["head_dim"]
            G, N, T = s.attrs["n_branches"] * B, H * W, heads * d
            t = rnd(G, N, 3 * T).reshape(G, N, 3, heads, d)
            args = (t[:, :, 0], t[:, :, 1], t[:, :, 2])
            bn = plan.decisions[s.name].blocks["block_n"] if plan else 256
            kfn = lambda a=args, bn=bn: relu_attn_noncausal(*a, block_n=bn)
            pfn = lambda a=args: relu_attn_noncausal_ref(*a)
            nbytes = 4 * 4 * G * N * T
            flops = G * heads * (4 * N * d * d + 3 * N * d)
            label = f"qkv({G},{N},3x{heads}x{d}) block_n={bn}"
            name = "relu_attn_noncausal"
        cases.append((name, names, label, kfn, pfn, nbytes, flops))
    return cases




def int8_kernel_cases(batch: int, gen, cfg=None, plan=None,
                      image_size=None):
    """(kernel, site names, shape label, kernel fn, plain fn, bytes, int8
    ops, library fn or None) for every distinct int8 kernel shape of the
    FIX8 path of ``cfg`` (B1) at ``image_size`` (the config's) and
    ``batch`` (the sites ``plan``
    fuses; MBConvs whose epilogue emits take the emitting kernel, the
    non-residual ones without a plan), on random int8 codes, named as in
    ``kernel_cases``.  Each fn returns a tuple of tensors."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import decision_shape
    from repro_torch.kernels.dsconv.kernel import (
        dsconv_fused_int8, dsconv_int8_path)
    from repro_torch.kernels.dsconv.ref import dsconv_int8_ref
    from repro_torch.kernels.group_conv.kernel import (
        group_agg_int8, group_agg_path)
    from repro_torch.kernels.group_conv.ref import (
        block_diag, group_agg_int8_ref)
    from repro_torch.kernels.int8_matmul.kernel import (
        int8_gemm_plan, int8_matmul)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.mbconv.kernel import (
        mbconv_fused_int8, mbconv_fused_int8_emit, mbconv_int8_path)
    from repro_torch.kernels.mbconv.ref import mbconv_int8_ref
    from repro_torch.core.quantization import quantize_act

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).cuda()

    def sc(*shape, base=1e-2):
        return (base * (0.5 + torch.rand(shape, generator=gen))).cuda()

    def bias(*shape):
        return torch.randn(shape, generator=gen).cuda()

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    groups: dict = {}
    fused, grouped = served_sites(cfg or B1, batch, plan, image_size)
    for site in fused:
        shape = decision_shape(site)
        if site.kind == "mbconv":
            if plan is None:     # the int8 plan's keep-fp producers
                emit = not site.residual
            else:
                ep = plan.decisions[site.name].epilogue
                emit = (ep is not None and ep.emits_q and not site.residual
                        and site.name not in grouped)
            key = ("mbconv_fused_int8_emit" if emit else
                   "mbconv_fused_int8", shape)
            groups.setdefault(key, []).append(site)
        elif site.kind == "dsconv":
            groups.setdefault(("dsconv_fused_int8", shape), []).append(site)
        else:
            B, H, W, C = site.in_shape
            n_br = site.attrs["n_branches"]
            for key in (("int8_matmul", (B * H * W, C, 3 * C)),
                        ("int8_matmul", (B * H * W, n_br * C, C)),
                        ("group_agg_int8", (B, H, W, 3 * C,
                                            site.attrs["head_dim"]))):
                groups.setdefault(key, []).append(site)
    cases = []
    for (name, shape), sites in groups.items():
        names = [x.name for x in sites if x.name not in grouped]
        lib = None
        if name == "int8_matmul":
            M, K, N = shape
            x, w, xs, ws = i8(M, K), i8(K, N), sc(M), sc(N)
            kfn = lambda a=(x, w, xs, ws): (int8_matmul(*a),)
            pfn = lambda a=(x, w, xs, ws): (int8_matmul_ref(*a),)
            if M > 16 and K % 8 == 0 and N % 8 == 0:
                lib = lambda a=(x, w, xs, ws): (
                    torch._int_mm(a[0], a[1]).float() * a[2][:, None]
                    * a[3][None, :],)
            nbytes = nb(x, w, xs, ws) + 4 * M * N
            ops = 2 * M * K * N
            plan = int8_gemm_plan(M, N, K)
            label = f"({M}x{K})@({K}x{N}) tile {plan['bm']}x{plan['bn']}"
        elif name == "group_agg_int8":
            B, H, W, C, d = shape
            args = (i8(B, H, W, C), sc(B), i8(5, 5, C), sc(C), bias(C))
            pw, tail = i8(d, C), (sc(C), bias(C))
            dense = block_diag(pw)
            kfn = lambda a=args, pw=pw, t=tail: (group_agg_int8(*a, pw, *t),)
            pfn = lambda a=args, dn=dense, t=tail: (
                group_agg_int8_ref(*a, dn, *t),)
            nbytes = nb(*args, pw, *tail) + 4 * B * H * W * C
            ops = 2 * B * H * W * C * (25 + d)
            path = group_agg_path(H, W, C, d, 5)
            label = (f"x{(B, H, W, C)} s=5 d={d} "
                     + (f"cluster R={path['ranks']}"
                        if path["path"] == "cluster" else "two-launch"))
        elif name == "dsconv_fused_int8":
            B, H, W, C, _, F, st = shape
            args = (i8(B, H, W, C), sc(B), i8(3, 3, C), sc(C), bias(C),
                    i8(C, F), sc(F), bias(F))
            kfn = lambda a=args, st=st: (dsconv_fused_int8(*a, stride=st),)
            pfn = lambda a=args, st=st: (dsconv_int8_ref(*a, stride=st),)
            nbytes = nb(*args) + 4 * B * (H // st) * (W // st) * F
            ops = 2 * B * (H // st) * (W // st) * (9 * C + C * F)
            path = dsconv_int8_path(H, W, C, F, st)
            label = (f"x{(B, H, W, C)} F={F} s={st} "
                     + (f"cluster R={path['ranks']}"
                        if path["path"] == "cluster" else "passes"))
        else:
            B, H, W, C, M, F, st = shape
            Ho, Wo = H // st, W // st
            args = (i8(B, H, W, C), sc(B), i8(C, M), sc(M, base=2e-3),
                    bias(M), i8(3, 3, M), sc(M), bias(M), i8(M, F), sc(F),
                    bias(F))
            if name == "mbconv_fused_int8":
                kfn = lambda a=args, st=st: (
                    mbconv_fused_int8(*a, stride=st),)
                pfn = lambda a=args, st=st: (mbconv_int8_ref(*a, stride=st),)
                out_bytes = 4 * B * Ho * Wo * F
            else:
                kfn = lambda a=args, st=st: mbconv_fused_int8_emit(
                    *a, stride=st)

                def pfn(a=args, st=st):
                    out = mbconv_int8_ref(*a, stride=st)
                    qt = quantize_act(out)
                    return qt.q, qt.scale, out
                out_bytes = 5 * B * Ho * Wo * F + 4 * B
            nbytes = nb(*args) + out_bytes
            ops = 2 * B * (H * W * C * M + Ho * Wo * M * (9 + F))
            path = mbconv_int8_path(H, W, C, M, F, st, B)
            label = (f"x{(B, H, W, C)} M={M} F={F} s={st} "
                     + (f"cluster R={path['ranks']}"
                        if path["path"] == "cluster" else "passes"))
        cases.append((name, names, label, kfn, pfn, nbytes, ops, lib))
    return cases


def library_cases(seed: int):
    """The kernel-library phase: the four kernels off the vision path,
    each reached through the JAX package's public op at the full width
    of a model the repo ships.  One entry per case: (kernel case as in
    ``int8_kernel_cases``, the public op, a check of the op's output
    against the kernel's, exact, reps, windows, CUDA launches a call
    where the case checks them: the plans of the scans and of
    ``int8_matmul_emit``, else None).  The kernel
    case runs the wrapper on the op's own (folded) inputs; the 32k-token
    cases are timed over fewer windows, never shortened."""
    import math

    import torch
    from repro_torch.core.program import Epilogue
    from repro_torch.core.quantization import (
        calibrate_act_scale, quantize_act, quantize_with_scale)
    from repro_torch.kernels.dsconv.kernel import dsconv_fused_int8_emit
    from repro_torch.kernels.dsconv.ops import dsconv_apply_int8
    from repro_torch.kernels.dsconv.ref import dsconv_int8_emit_ref
    from repro_torch.kernels.int8_matmul.kernel import (
        int8_emit_plan, int8_matmul_emit)
    from repro_torch.kernels.int8_matmul.ops import conv1x1_w8a8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_emit_ref
    from repro_torch.kernels.relu_attn.kernel import (
        relu_attn_causal, relu_attn_causal_cost, relu_attn_causal_plan)
    from repro_torch.kernels.relu_attn.ops import relu_linear_attention
    from repro_torch.kernels.relu_attn.ref import relu_attn_causal_scan
    from repro_torch.kernels.ssd.kernel import (
        ssd_chunked, ssd_cost, ssd_plan)
    from repro_torch.kernels.ssd.ops import ssd_op
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def qconv(k, c, f):
        return {"q": i8(k, k, c, f), "scale": uniform(5e-3, 1.5e-2, f),
                "bias": randn(f)}

    def same_q(out, ref, keep):
        return (torch.equal(out.q.reshape(ref[0].shape), ref[0])
                and torch.equal(out.scale, ref[1])
                and (not keep or torch.equal(out.fp.reshape(ref[2].shape),
                                             ref[2])))

    cases = []
    # int8_matmul_emit: the MSA QKV and output projections of B1@224,
    # the activations quantized per image, or clipped to a static scale
    # calibrated on them (``x_scale=``)
    for batch in (1, 8):
        for hw, C, F in ((196, 128, 384), (196, 256, 128), (49, 256, 768),
                         (49, 512, 256)):
            H = math.isqrt(hw)
            x, qp = randn(batch, H, H, C), qconv(1, C, F)
            M = batch * hw
            plan = int8_emit_plan(M, F, C, hw)
            for keep, static in ((False, False), (True, False),
                                 (True, True)):
                ep = Epilogue("int8", "dynamic",
                              "keep-fp" if keep else "none")
                if static:
                    x_scale = calibrate_act_scale(x)
                    x_q = quantize_with_scale(x.reshape(M, C), x_scale)
                else:
                    x_scale = None
                    xq = quantize_act(x)
                    x_q, xs_in = xq.q.reshape(M, C), xq.scale
                kargs = (x_q, qp["q"].reshape(C, F),
                         x_scale if static else xs_in, qp["scale"])
                kw = dict(rows_per_group=hw, bias=qp["bias"], keep_fp=keep)

                def lib(a=kargs, kw=kw, batch=batch):
                    acc = torch._int_mm(a[0], a[1]).float()
                    xs = a[2].reshape(-1).expand(batch).repeat_interleave(
                        kw["rows_per_group"])
                    out = acc * xs[:, None] * a[3][None, :] + kw["bias"]
                    qt = quantize_act(out.reshape(batch, -1, out.shape[1]))
                    return qt.q, qt.scale, out
                kcase = (
                    "int8_matmul_emit", [],
                    f"({M}x{C})@({C}x{F}) rows/image={hw} keep_fp={keep} "
                    f"x_scale={'static' if static else 'per-image'} "
                    f"{plan['path']} R={plan['ranks']} tile "
                    f"{plan['bm']}x{plan['bn']}",
                    lambda a=kargs, kw=kw: int8_matmul_emit(*a, **kw),
                    lambda a=kargs, kw=kw: int8_matmul_emit_ref(*a, **kw),
                    M * C + C * F + 4 * batch + 8 * F + M * F + 4 * batch
                    + (4 * M * F if keep else 0), 2 * M * C * F, lib)
                cases.append((
                    kcase,
                    lambda x=x, qp=qp, s=x_scale, ep=ep: conv1x1_w8a8(
                        qp, x, x_scale=s, epilogue=ep),
                    lambda out, ref, keep=keep: same_q(out, ref, keep),
                    True, 20, 5, 1 if plan["path"] == "cluster" else 2))
    # dsconv_fused_int8_emit: stem.ds0 of B1@224, and a stride-2 case
    for batch in (1, 8):
        for H, C, st in ((112, 16, 1), (56, 32, 2)):
            x = randn(batch, H, H, C)
            p = {"dw": {"qconv": qconv(3, 1, C)},
                 "pw": {"qconv": qconv(1, C, C)}}
            xq = quantize_act(x)
            qd, qw = p["dw"]["qconv"], p["pw"]["qconv"]
            kargs = (xq.q, xq.scale, qd["q"][:, :, 0, :].contiguous(),
                     qd["scale"], qd["bias"], qw["q"][0, 0].contiguous(),
                     qw["scale"], qw["bias"])
            Ho = H // st
            for keep in (False, True):
                ep = Epilogue("int8", "dynamic",
                              "keep-fp" if keep else "none")
                out_n = batch * Ho * Ho * C
                kcase = (
                    "dsconv_fused_int8_emit", [],
                    f"x{(batch, H, H, C)} F={C} s={st} keep_fp={keep}",
                    lambda a=kargs, st=st, k=keep: dsconv_fused_int8_emit(
                        *a, stride=st, keep_fp=k),
                    lambda a=kargs, st=st, k=keep: dsconv_int8_emit_ref(
                        *a, stride=st, keep_fp=k),
                    batch * H * H * C + 4 * batch + 9 * C + 8 * C + C * C
                    + 8 * C + out_n + 4 * batch + (4 * out_n if keep else 0),
                    2 * out_n * (9 + C), None)
                cases.append((
                    kcase,
                    lambda x=x, p=p, st=st, ep=ep: dsconv_apply_int8(
                        p, x, stride=st, epilogue=ep),
                    lambda out, ref, keep=keep: same_q(out, ref, keep),
                    True, 20, 5, None))
    # relu_attn_causal: Zamba2-1.2B's attention slot (32 heads x 64) and
    # the global layer of the repo's Gemma3-12B config under relu_linear
    # (16 heads x 240, the 8 kv heads repeated; that config is of the
    # unverified tier, and the published model's head_dim is 256), at
    # prefill_32k and a per-chip batch of 1
    C = 256
    for label, heads, kv, D, N, dt in (
            ("Zamba2-1.2B", 32, 32, 64, 32768, torch.float32),
            ("Gemma3-12B(repo cfg) global", 16, 8, 240, 32768,
             torch.float32),
            ("Zamba2-1.2B ragged", 32, 32, 64, 32768 - 100, torch.float32),
            ("Zamba2-1.2B bf16", 32, 32, 64, 32768, torch.bfloat16)):
        q = randn(1, N, heads, D).to(dt)
        k, v = (randn(1, N, kv, D).to(dt).repeat_interleave(heads // kv, 2)
                for _ in range(2))
        fold = tuple(t.transpose(1, 2).reshape(heads, N, D).contiguous()
                     for t in (q, k, v))
        # ReLU(Q)ReLU(K)^T and the S.V product over the triangle, then
        # ReLU(Q).state and the ReLU(K)^T.V update; with bf16 inputs the
        # first and the last take bf16 operands (tensor-core rate), the
        # other two an fp32 one (S and the state are fp32)
        cost = relu_attn_causal_cost(heads, N, D, C)
        tri, read, update = cost["triangle"], cost["read"], cost["update"]
        ops = (((tri / 2 + update, PEAK_BF16_FLOPS),
                (tri / 2 + read, PEAK_FP32_FLOPS))
               if dt == torch.bfloat16 else tri + read + update)
        plan = relu_attn_causal_plan(heads, N, D, C)
        kcase = (
            "relu_attn_causal", [],
            f"{label} q,k,v(1,{N},{heads},{D}) {str(dt)[6:]} chunk={C} "
            f"launches={plan['launches']} workspace={plan['workspace']} B",
            lambda f=fold: relu_attn_causal(*f, chunk=C),
            lambda f=fold: relu_attn_causal_scan(*f, chunk=C),
            3 * q.numel() * q.element_size() + 4 * q.numel(), ops, None)
        cases.append((
            kcase,
            lambda q=q, k=k, v=v: relu_linear_attention(
                q, k, v, causal=True, block_n=C),
            lambda out, ref, h=heads, n=N, d=D: torch.equal(
                out, ref.reshape(1, h, n, d).transpose(1, 2)),
            False, 2, 3, plan["launches"]))
    # ssd_chunked: Mamba2-1.3B's SSD layer (d_inner 4096 = 64 heads x 64,
    # one group, state 128), dt in [1e-3, 0.1] and A in [-16, -1] as the
    # model's initialisation draws them
    h, P, g, n = 64, 64, 1, 128
    for S in (32768, 32768 - 100):
        x = randn(1, S, h, P)
        dt = torch.exp(uniform(math.log(1e-3), math.log(0.1), 1, S, h))
        A, D = -uniform(1.0, 16.0, h), randn(h)
        B, Cm = randn(1, S, g, n), randn(1, S, g, n)
        xf = x.transpose(1, 2).reshape(h, S, P).contiguous()
        dtf = dt.transpose(1, 2).reshape(h, S).contiguous()
        dA = dtf * A[:, None]
        Bf, Cf = (t.repeat_interleave(h // g, 2).transpose(1, 2)
                  .reshape(h, S, n).contiguous() for t in (B, Cm))
        args = (xf, dtf, dA, Bf, Cf)
        plan = ssd_plan(h, S, P, n, C)
        kcase = (
            "ssd_chunked", [], f"Mamba2-1.3B b=1 s={S} h={h} p={P} g={g} "
            f"n={n} chunk={C} launches={plan['launches']} "
            f"workspace={plan['workspace']} B",
            lambda a=args: ssd_chunked(*a, chunk=C),
            lambda a=args: ssd_scan_ref(*a, chunk=C),
            4 * sum(t.numel() for t in args) + 4 * xf.numel(),
            ssd_cost(h, S, P, n, C)["flops"], None)
        cases.append((
            kcase,
            lambda a=(x, dt, A, B, Cm), D=D: ssd_op(*a, chunk=C, D_skip=D),
            lambda out, ref, x=x, D=D, S=S: torch.equal(
                out, ref.reshape(1, h, S, P).transpose(1, 2)
                + D[None, None, :, None] * x),
            False, 2, 3, plan["launches"]))
    return cases


def library_phase(seed, wrappers, expected, per_fwd, max_err) -> dict:
    """Drive the library cases' public ops once each with every counter
    reset just before and read just after (each kernel of ``expected``
    must launch that often, every other kernel never); then hold each
    op's output against its kernel's, and each kernel against its plain
    version, and time them.  Returns the launches of the driven run."""
    import torch
    cases = library_cases(seed)
    for w in wrappers.values():
        w.launches = 0
    outs = [op() for _, op, *_ in cases]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[library] launches {launches}")
    if launches != dict.fromkeys(wrappers, 0) | expected:
        raise AssertionError(f"library phase launches {launches}, "
                             f"expected {expected}")
    for (case, _, same, exact, reps, windows, _), out in zip(cases, outs):
        if not same(out, case[3]()):
            raise AssertionError(f"{case[0]} {case[2]}: the public op's "
                                 f"output is not the kernel's")
        torch.cuda.synchronize()
        err, ref_max, *times = measure(case, exact, reps, windows)
        max_err[case[0]] = max(max_err[case[0]], err)
        kernel_line("library", case, "", err, ref_max, *times)
        add_time(per_fwd[case[0]], 1, case, *times[:4], exact)
    cuda_launches([(case, n) for case, *_, n in cases if n is not None])
    return launches


def cuda_launches(calls) -> None:
    """Each (case, n) of ``calls`` is n CUDA launches of the port's
    kernels a call, and nothing else (no memset, no fill): one
    ``torch.profiler`` capture over one call of each (the calls were
    timed, so warm) must count the sum of the n.  Run after every timed
    phase of the library."""
    import re

    import torch

    with profiled(host=False) as prof:
        for case, _ in calls:
            case[3]()
        torch.cuda.synchronize()
    rows = {e.key: e.count for e in prof.key_averages()
            if device_us(e) > 0 and not is_range(e.key)}
    ours = port_kernel_names()
    port = sum(n for key, n in rows.items() if re.match(
        r"(?:void\s+)?(?:\w+::)*(\w+)", key).group(1) in ours)
    want = sum(n for _, n in calls)
    for case, n in calls:
        print(f"[library] {case[0]} {case[2]}: {n} CUDA launches a call")
    print(f"[library] profiler over one call of each: {port} launches of "
          f"the port's kernels, {sum(rows.values())} in all, expected "
          f"{want}; {sorted(rows.items())}")
    if port != want or sum(rows.values()) != want:
        raise AssertionError(f"the library's calls made {dict(rows)}, "
                             f"expected {want} launches of their kernels")


def chain_macs(sup) -> int:
    """Multiply-adds of one image through a chain's members, without the
    bands' halo recompute."""
    n = 0
    for m in sup.sites:
        _, H, W, C = m.in_shape
        _, Ho, Wo, F = m.out_shape
        if m.kind == "mbconv":
            M = m.attrs["mid"]
            n += H * W * C * M + Ho * Wo * M * (9 + F)
        else:
            n += Ho * Wo * C * (9 + F)
    return n


def chain_cases(batch: int, gen, params, qparams, cfg=None, plans=None,
                image_size=None):
    """(fp32 cases, int8 cases) of the super-site chains of ``cfg`` at
    ``image_size`` (the config's) and ``batch``, as ``kernel_cases`` / ``int8_kernel_cases`` give
    them: random inputs, the weights of the served trees.  Without
    ``plans`` B1's two chains (``GROUPS``) at both precisions, the fp32
    blocks ``choose_blocks``'; with (fp plan, FIX8 plan) each plan's
    groups with its blocks."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import SuperSite, lower
    from repro_torch.kernels.supersite.kernel import supersite_fused
    from repro_torch.kernels.supersite.ops import choose_blocks, make_fp_geom
    from repro_torch.kernels.supersite.pack import pack_weights
    from repro_torch.kernels.supersite.ref import supersite_ref

    program = lower(cfg or B1, batch=batch, image_size=image_size)
    fp_cases, q_cases = [], []
    if plans is None:
        chains = [(name, members, prec, None) for name, members in
                  GROUPS.items() for prec in ("fp", "int8")]
    else:
        chains = [(g.name, g.members, g.precision, dict(g.blocks))
                  for p in plans for g in p.groups.values()]
    for name, members, prec, blocks in chains:
        sup = SuperSite.of(program, members, name=name)
        B = batch
        _, Ho, Wo, F = sup.out_shape
        ops = 2 * B * chain_macs(sup)
        if prec == "int8":
            q_cases.append(int8_chain_case(sup, gen, qparams, B, ops))
            continue
        pack = pack_weights(params, sup, "fp")
        blocks = blocks or choose_blocks(sup)
        geom = make_fp_geom(sup, pack, blocks["block_rows"],
                            blocks["block_m"])
        x = torch.randn(sup.in_shape, generator=gen).cuda()
        fp_cases.append((
            "supersite_fused", [name],
            f"{name} x{tuple(x.shape)} R={geom.block_rows} "
            f"bm={geom.block_m} bands={geom.n_bands}",
            lambda x=x, p=pack, g=geom: supersite_fused(x, p.fp, geom=g),
            lambda x=x, p=pack, g=geom: supersite_ref(x, p.fp, geom=g),
            4 * (x.numel() + B * Ho * Wo * F) + pack.nbytes, ops))
    return fp_cases, q_cases


def int8_chain_case(sup, gen, qparams, B, ops):
    """A FIX8 chain's case with the served exit (int8 codes + scales +
    the kept fp map); the chain's entry fp map where member 0 is
    residual."""
    import torch
    from repro_torch.kernels.supersite.kernel import supersite_fused_int8
    from repro_torch.kernels.supersite.ops import make_int8_geom
    from repro_torch.kernels.supersite.pack import pack_weights
    from repro_torch.kernels.supersite.ref import supersite_int8_ref

    _, Ho, Wo, F = sup.out_shape
    qpack = pack_weights(qparams, sup, "int8")
    qgeom = make_int8_geom(sup, qpack)
    x_q = torch.randint(-128, 128, sup.in_shape, generator=gen,
                        dtype=torch.int8).cuda()
    xs = (1e-2 * (0.5 + torch.rand(B, generator=gen))).cuda()
    x_fp = (x_q.float() * xs[:, None, None, None]
            if sup.sites[0].residual else None)
    return (
        "supersite_fused_int8", [sup.name],
        f"{sup.name} x{tuple(x_q.shape)} exit int8+fp",
        lambda a=(x_q, xs, qpack.q, qpack.fp), g=qgeom, f=x_fp:
            supersite_fused_int8(*a, geom=g, x_fp=f, exit_emit=True,
                                 keep_fp=True),
        lambda a=(x_q, xs, qpack.q, qpack.fp), g=qgeom, f=x_fp:
            supersite_int8_ref(*a, geom=g, x_fp=f, exit_emit=True),
        x_q.numel() + 4 * B + 5 * B * Ho * Wo * F + 4 * B
        + qpack.nbytes, ops, None)


def band_sweep(params, gen) -> None:
    """Time ``supersite_fused`` at both B1@224 chains, batch 1 and 8, over
    band heights 1-4 and channel chunks 16-128 that fit, the planner's
    choice marked (the evidence ``choose_blocks`` follows)."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import SuperSite, lower
    from repro_torch.kernels.registry import SMEM_LIMIT
    from repro_torch.kernels.supersite.kernel import supersite_fused
    from repro_torch.kernels.mbconv_fp import BLOCK_M
    from repro_torch.kernels.supersite.ops import (
        choose_blocks, make_fp_geom, supersite_smem_bytes)
    from repro_torch.kernels.supersite.pack import pack_weights

    for batch in (1, 8):
        program = lower(B1, batch=batch)
        for name, members in GROUPS.items():
            sup = SuperSite.of(program, members, name=name)
            pack = pack_weights(params, sup, "fp")
            x = torch.randn(sup.in_shape, generator=gen).cuda()
            chosen = choose_blocks(sup)
            cells = []
            for rows in (1, 2, 3, 4):
                for bm in sorted(BLOCK_M):
                    if supersite_smem_bytes(sup, rows, bm) > SMEM_LIMIT:
                        continue
                    geom = make_fp_geom(sup, pack, rows, bm)
                    ms = device_ms(lambda g=geom: supersite_fused(
                        x, pack.fp, geom=g), reps=10, windows=3)
                    mark = "*" if chosen == {"block_rows": rows,
                                             "block_m": bm} else ""
                    cells.append(f"{mark}R={rows},bm={bm}:{ms:.4f}")
            print(f"[band sweep] {name} B={batch} chosen {chosen}; ms "
                  f"{' '.join(cells)}")


def mbconv_sweep(gen) -> None:
    """Time ``mbconv_fused`` at S1.mb1, S3.mb0, S3, S4.mb0 and S4 of
    B1@224, batch 1 and 8, over band height x mid chunk x cluster size
    (every legal split, every chunk no wider than the slice, the whole
    map and power-of-two bands), the choice of ``choose_blocks`` marked;
    beside each cell the clusters the card holds at once and the CTA's
    shared memory.  The evidence the block cost model was fitted to."""
    import ctypes

    import torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.mbconv.kernel import (
        choose_blocks, legal_splits, mbconv_fused, mbconv_slice,
        mbconv_smem_bytes)
    from repro_torch.kernels.mbconv_fp import BLOCK_M
    from repro_torch.kernels.registry import SMEM_LIMIT

    occ = library("mbconv").mbconv_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    for batch in (1, 8):
        for name, (H, C, M, F, st) in (("S1.mb1", (56, 32, 128, 32, 1)),
                                       ("S3.mb0", (28, 64, 256, 128, 2)),
                                       ("S3", (14, 128, 512, 128, 1)),
                                       ("S4.mb0", (14, 128, 512, 256, 2)),
                                       ("S4", (7, 256, 1024, 256, 1))):
            rnd = lambda *sh, scale=1.0: (torch.randn(
                sh, generator=gen) * scale).cuda()
            args = (rnd(batch, H, H, C), rnd(C, M, scale=C ** -0.5),
                    rnd(M), rnd(3, 3, M, scale=1 / 3), rnd(M),
                    rnd(M, F, scale=M ** -0.5), rnd(F))
            ho = H // st
            chosen = choose_blocks(args[0].shape, M, F, st)
            cells, times = [], {}
            for rows in sorted({ho} | {r for r in (1, 2, 4, 8, 16, 32)
                                       if r < ho}):
                for split in legal_splits(M):
                    sl = mbconv_slice(M, split)
                    for bm in BLOCK_M:
                        smem = mbconv_smem_bytes(H, F, st, rows, bm)
                        if bm > max(16, -(-sl // 16) * 16) or \
                                smem > SMEM_LIMIT:
                            continue
                        n = ctypes.c_int(0)
                        if occ(batch, H, H, F, st, rows, bm, split,
                               ctypes.byref(n)):
                            raise AssertionError(f"mbconv occupancy query "
                                                 f"failed at {rows, bm, split}")
                        blocks = {"block_rows": rows, "block_m": bm,
                                  "split": split}
                        ms = device_ms(lambda b=blocks: mbconv_fused(
                            *args, stride=st, **b), reps=10, windows=3)
                        times[(rows, bm, split)] = ms
                        mark = "*" if blocks == chosen else ""
                        cells.append(f"{mark}R={rows},bm={bm},S={split}:"
                                     f"{ms:.4f}({n.value}x,{smem // 1024}K)")
            best = min(times, key=times.get)
            pick = times[tuple(chosen.values())]
            print(f"[mbconv sweep] {name} x{tuple(args[0].shape)} B={batch} "
                  f"chosen {chosen} {pick:.4f} ms, fastest R={best[0]},"
                  f"bm={best[1]},S={best[2]} {times[best]:.4f} ms "
                  f"(x{pick / times[best]:.3f}); ms {' '.join(cells)}")


def mbconv_int8_sweep(gen) -> None:
    """Time the FIX8 MBConv at S3, S4, S3.down and S4.down of B1@224 (and
    S2.mb1, the chain member whose image fits a cluster), batch 1 and 8,
    on the passes and on the cluster kernel at every legal rank count that
    fits, the choice of ``mbconv_int8_path`` marked; beside each cluster
    cell the clusters the card holds at once and the CTA's shared memory.
    The evidence the path rule follows, and why the FIX8 chain's members
    take the passes."""
    import ctypes

    import torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.mbconv.kernel import (
        _mbconv_int8, int8_ranks, mbconv_int8_cluster_smem, mbconv_int8_path)
    from repro_torch.kernels.registry import SMEM_LIMIT

    occ = library("mbconv_int8").mbconv_int8_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh, base=1e-2: (base * (0.5 + torch.rand(
        sh, generator=gen))).cuda()
    rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
    for batch in (1, 8):
        for name, (H, C, M, F, st) in (("S3", (14, 128, 512, 128, 1)),
                                       ("S4", (7, 256, 1024, 256, 1)),
                                       ("S3.down", (28, 64, 256, 128, 2)),
                                       ("S4.down", (14, 128, 512, 256, 2)),
                                       ("S2.mb1", (28, 64, 256, 64, 1))):
            emit = st == 2
            args = (i8(batch, H, H, C), sc(batch), i8(C, M), sc(M, base=2e-3),
                    rn(M), i8(3, 3, M), sc(M), rn(M), i8(M, F), sc(F), rn(F))
            chosen = mbconv_int8_path(H, H, C, M, F, st, batch)
            cells, times = [], {}
            for r in (0,) + int8_ranks(M):
                path = "cluster" if r else "passes"
                txt = ""
                if r:
                    smem = mbconv_int8_cluster_smem(H, H, C, M, F, st, r)
                    if smem > SMEM_LIMIT:
                        continue
                    n = ctypes.c_int(0)
                    if occ(batch, H, H, C, M, F, st, r, int(emit),
                           ctypes.byref(n)):
                        raise AssertionError(f"mbconv_int8 occupancy query "
                                             f"failed at {name} ranks {r}")
                    txt = f"({n.value}x,{smem // 1024}K)"
                ms = device_ms(lambda r=r, p=path: _mbconv_int8(
                    *args, st, emit, p, r), reps=10, windows=3)
                times[r] = ms
                mark = "*" if r == chosen["ranks"] else ""
                cells.append(f"{mark}{'R=' + str(r) if r else 'passes'}:"
                             f"{ms:.4f}{txt}")
            best = min(times, key=times.get)
            print(f"[mbconv_int8 sweep] {name} x{tuple(args[0].shape)} "
                  f"M={M} F={F} s={st}{' emit' if emit else ''} B={batch} "
                  f"chosen {chosen['path']} R={chosen['ranks']} "
                  f"{times[chosen['ranks']]:.4f} ms, fastest "
                  f"{'R=' + str(best) if best else 'passes'} "
                  f"{times[best]:.4f} ms; ms {' '.join(cells)}")


# the four MSA projection GEMMs of B1@224 per image: (rows, K, N)
MSA_GEMMS = (("S3 qkv", 196, 128, 384), ("S3 proj", 196, 256, 128),
             ("S4 qkv", 49, 256, 768), ("S4 proj", 49, 512, 256))
# the two MSA aggregation maps of B1@224: (H, C)
AGG_MAPS = (("S3", 14, 384), ("S4", 7, 768))


def int8_matmul_sweep(gen) -> None:
    """Time ``int8_matmul`` at the four MSA projections of B1@224, batch 1
    and 8, at every legal (bm, bn) of ``gemm_cells``, beside each
    cell its CTAs and shared memory; the pick of ``int8_gemm_plan`` marked
    and its time over the fastest cell printed.  The evidence the plan's
    cost model is fitted to."""
    import torch
    from repro_torch.kernels.int8_matmul.kernel import (
        _int8_matmul, gemm_cells, gemm_ctas, int8_gemm_plan, int8_gemm_smem)

    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    for batch in (1, 8):
        for name, rows, K, N in MSA_GEMMS:
            M = batch * rows
            args = (i8(M, K), i8(K, N), sc(M), sc(N))
            plan = int8_gemm_plan(M, N, K)
            pick = (plan["bm"], plan["bn"])
            cells, times = [], {}
            for cell in gemm_cells(M, N, K):
                bm, bn = cell
                ms = device_ms(lambda c=dict(bm=bm, bn=bn):
                               _int8_matmul(*args, c), reps=10, windows=3)
                times[cell] = ms
                mark = "*" if cell == pick else ""
                cells.append(f"{mark}{bm}x{bn}:{ms:.5f}"
                             f"({gemm_ctas(M, N, *cell)},"
                             f"{int8_gemm_smem(K, *cell) // 1024}K)")
            best = min(times, key=times.get)
            print(f"[int8_matmul sweep] {name} ({M}x{K})@({K}x{N}) "
                  f"B={batch} chosen {pick} {times[pick]:.5f} ms, fastest "
                  f"{best} {times[best]:.5f} ms, chosen/fastest "
                  f"{times[pick] / times[best]:.3f}; ms(CTAs,smem) "
                  f"{' '.join(cells)}")


def group_agg_sweep(gen) -> None:
    """Time ``group_agg_int8`` at both MSA aggregation maps of B1@224,
    batch 1 and 8, on the two launches and on the cluster kernel at every
    rank count that holds whole groups and fits a CTA, beside each
    cluster cell the clusters the card holds at once and the CTA's shared
    memory; the choice of ``group_agg_path`` marked."""
    import ctypes

    import torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.group_conv.kernel import (
        _group_agg, group_agg_cluster_smem, group_agg_path, group_agg_ranks)
    from repro_torch.kernels.registry import SMEM_LIMIT

    occ = library("group_agg").group_agg_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
    d, S = 16, 5
    for batch in (1, 8):
        for name, H, C in AGG_MAPS:
            args = (i8(batch, H, H, C), sc(batch), i8(S, S, C), sc(C), rn(C),
                    i8(d, C), sc(C), rn(C))
            chosen = group_agg_path(H, H, C, d, S)
            cells, times = [], {}
            for r in (0,) + group_agg_ranks(C, d):
                txt = ""
                if r and group_agg_cluster_smem(H, H, C, d, S, r) \
                        > SMEM_LIMIT:
                    continue
                if r:
                    n = ctypes.c_int(0)
                    if occ(batch, H, H, C, d, S, r, ctypes.byref(n)):
                        raise AssertionError(f"group_agg occupancy query "
                                             f"failed at {name} ranks {r}")
                    smem = group_agg_cluster_smem(H, H, C, d, S, r)
                    txt = f"({n.value}x,{smem // 1024}K)"
                path = "cluster" if r else "two-launch"
                ms = device_ms(lambda p=path, r=r: _group_agg(
                    *args, path=p, ranks=r), reps=10, windows=3)
                times[r] = ms
                mark = "*" if r == chosen["ranks"] else ""
                cells.append(f"{mark}{'R=' + str(r) if r else 'two-launch'}:"
                             f"{ms:.5f}{txt}")
            best = min(times, key=times.get)
            print(f"[group_agg sweep] {name} x{(batch, H, H, C)} s={S} d={d} "
                  f"B={batch} chosen {chosen['path']} R={chosen['ranks']} "
                  f"{times[chosen['ranks']]:.5f} ms, fastest "
                  f"{'R=' + str(best) if best else 'two-launch'} "
                  f"{times[best]:.5f} ms; ms {' '.join(cells)}")


# the MSA attention cores of B1@224: (site, H, heads, branches); d = 16
ATTN_SITES = (("S3", 14, 8, 2), ("S4", 7, 16, 2))


def attn_inputs(gen, batch, H, heads, S, d=16):
    """The stacked QKV of ``S`` branches x ``batch`` images as the MSA
    passes it (strided q/k/v views of one (S, batch, N, 3, heads, d)
    tensor) and the (batch, H, W, S*heads*d) map its projection reads,
    with the (S, batch, N, heads, d) view the attention writes."""
    import torch
    N = H * H
    t = torch.randn((S, batch, N, 3, heads, d), generator=gen).cuda()
    qkv = t.reshape(S * batch, N, 3, heads, d)
    buf = torch.empty((batch, H, H, S * heads * d), device="cuda")
    view = buf.view(batch, N, S, heads, d).permute(2, 0, 1, 3, 4)
    return t, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), buf, view


def relu_attn_checks(gen) -> None:
    """``relu_attn_noncausal`` at both MSA shapes of B1@224, batch 1 and
    8: within ``TOL`` of its plain version with ``out=`` omitted and
    given (the projection's map, as the MSA serves it), equal bits on two
    calls and between the two forms; row g of the batch-8 call equals
    row g of each image's batch-1 call (its branches) bit for bit."""
    import torch
    from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
    from repro_torch.kernels.relu_attn.ref import relu_attn_noncausal_ref

    for name, H, heads, S in ATTN_SITES:
        for batch in (1, 8):
            t, qkv, buf, view = attn_inputs(gen, batch, H, heads, S)
            ref = relu_attn_noncausal_ref(*qkv)
            ref_max = ref.abs().max().item()
            top = max(1.0, ref_max)
            plain = relu_attn_noncausal(*qkv)
            served = relu_attn_noncausal(*qkv, out=view)
            torch.cuda.synchronize()
            err = (plain - ref).abs().max().item()
            err_out = (served - ref.reshape(served.shape)).abs().max().item()
            if not max(err, err_out) <= TOL * top:
                raise AssertionError(f"relu_attn_noncausal {name} B={batch}: "
                                     f"max|d| {err:.3e} / {err_out:.3e} "
                                     f"(out=) > {TOL} * {top:.3e}")
            if not torch.equal(plain, relu_attn_noncausal(*qkv)):
                raise AssertionError(f"relu_attn_noncausal {name} "
                                     f"B={batch}: two calls differ")
            if not torch.equal(served.reshape(plain.shape), plain):
                raise AssertionError(f"relu_attn_noncausal {name} "
                                     f"B={batch}: out= differs")
            text = ""
            if batch > 1:
                for b in range(batch):
                    one = t[:, b].reshape(S, H * H, 3, heads, 16)
                    got = relu_attn_noncausal(one[:, :, 0], one[:, :, 1],
                                              one[:, :, 2])
                    if not torch.equal(got, plain[b::batch]):
                        raise AssertionError(
                            f"relu_attn_noncausal {name}: image {b}'s rows "
                            f"of the batch-{batch} call differ from its "
                            f"batch-1 call")
                text = ", rows equal to each image's batch-1 call"
            print(f"[relu_attn] {name} qkv({S * batch},{H * H},3x{heads}x16) "
                  f"B={batch}: max|d| {err:.3e} (out= {err_out:.3e}, max|ref| "
                  f"{ref_max:.3e}), two calls and out= equal{text}")


def int8_emit_sweep(gen) -> None:
    """Time ``int8_matmul_emit`` at the four MSA projections of B1@224,
    batch 1 and 8 (the library's shapes, 196 or 49 rows an image), on
    every cluster cell of ``emit_cells`` and on the plain grid (64 x 64
    tiles), each EQUAL to the plain version; beside each cluster cell its
    ranks, the clusters the card holds at once and the CTA's shared
    memory.  The pick of ``int8_emit_plan`` is marked and printed against
    the fastest cell and the fastest cell of each rank count: the
    evidence the plan's cost model is fitted to."""
    import ctypes

    import torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.int8_matmul.kernel import (
        _int8_matmul_emit, emit_cells, emit_tiles, int8_emit_plan,
        int8_emit_smem)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_emit_ref

    occ = library("int8_matmul").int8_emit_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
    for batch in (1, 8):
        for name, rows, K, N in MSA_GEMMS:
            M = batch * rows
            args = (i8(M, K), i8(K, N), sc(batch), sc(N))
            bias = rn(N)
            ref = int8_matmul_emit_ref(*args, rows_per_group=rows, bias=bias)
            plan = int8_emit_plan(M, N, K, rows)
            pick = (plan["path"], plan["bm"], plan["bn"])
            cells = [("cluster", bm, bn) for bm, bn in emit_cells(rows, N, K)]
            cells.append(("grid", 64, 64))
            times, txt, by_r = {}, [], {}
            for cell in cells:
                path, bm, bn = cell
                fn = lambda c=dict(path=path, bm=bm, bn=bn): \
                    _int8_matmul_emit(*args, bias, rows, False, c)
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"int8_matmul_emit {name} B={batch} "
                                         f"{cell}: differs from the plain "
                                         f"version")
                times[cell] = ms = device_ms(fn, reps=10, windows=3)
                ranks = emit_tiles(rows, N, bm, bn) if path == "cluster" \
                    else 0
                by_r[ranks] = min(by_r.get(ranks, ms), ms)
                extra = ""
                if ranks:
                    n = ctypes.c_int(0)
                    if occ(M, N, K, rows, bm, bn, ctypes.byref(n)):
                        raise AssertionError(f"int8_emit occupancy query "
                                             f"failed at {cell}")
                    extra = (f"(R={ranks},{n.value}x,"
                             f"{int8_emit_smem(K, bm, bn) // 1024}K)")
                mark = "*" if cell == pick else ""
                txt.append(f"{mark}{path[0]}{bm}x{bn}:{ms:.5f}{extra}")
            best = min(times, key=times.get)
            print(f"[int8_emit sweep] {name} ({M}x{K})@({K}x{N}) rows/image="
                  f"{rows} B={batch} chosen {pick} {times[pick]:.5f} ms, "
                  f"fastest {best} {times[best]:.5f} ms, chosen/fastest "
                  f"{times[pick] / times[best]:.3f}; fastest by ranks "
                  + " ".join(f"{'R=' + str(r) if r else 'grid'}:{ms:.5f}"
                             for r, ms in sorted(by_r.items()))
                  + f"; every cell equal to the plain version; ms "
                  f"{' '.join(txt)}")


def dsconv_int8_sweep(gen) -> None:
    """Time ``dsconv_fused_int8`` at stem.ds0 of B1@224, batch 1 and 8, on
    the passes and on the cluster kernel at every rank count the map
    takes, each EQUAL to the plain version; beside each cluster cell the
    clusters the card holds at once and the CTA's shared memory; the
    choice of ``dsconv_int8_path`` marked and its time over the fastest
    cell printed."""
    import ctypes

    import torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.dsconv.kernel import (
        _dsconv_int8, dsconv_int8_cluster_smem, dsconv_int8_path,
        dsconv_int8_ranks)
    from repro_torch.kernels.dsconv.ref import dsconv_int8_ref

    occ = library("dsconv_int8").dsconv_int8_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
    H, C, F, st = 112, 16, 16, 1
    for batch in (1, 8):
        args = (i8(batch, H, H, C), sc(batch), i8(3, 3, C), sc(C), rn(C),
                i8(C, F), sc(F), rn(F))
        ref = dsconv_int8_ref(*args, stride=st)
        chosen = dsconv_int8_path(H, H, C, F, st)
        cells, times = [], {}
        for r in (0,) + dsconv_int8_ranks(H, H, C, F, st):
            path = "cluster" if r else "passes"
            fn = lambda p=path, r=r: _dsconv_int8(*args, st, True, p, r)
            if not torch.equal(fn(), ref):
                raise AssertionError(f"dsconv_fused_int8 {path} ranks {r}: "
                                     f"differs from the plain version")
            txt = ""
            if r:
                n = ctypes.c_int(0)
                if occ(batch, H, H, C, F, st, r, ctypes.byref(n)):
                    raise AssertionError(f"dsconv_int8 occupancy query "
                                         f"failed at ranks {r}")
                smem = dsconv_int8_cluster_smem(H, H, C, F, st, r)
                txt = f"({n.value}x,{smem // 1024}K)"
            times[r] = device_ms(fn, reps=10, windows=3)
            mark = "*" if r == chosen["ranks"] else ""
            cells.append(f"{mark}{'R=' + str(r) if r else 'passes'}:"
                         f"{times[r]:.5f}{txt}")
        best = min(times, key=times.get)
        pick = times[chosen["ranks"]]
        print(f"[dsconv_int8 sweep] stem.ds0 x{(batch, H, H, C)} F={F} "
              f"s={st} B={batch} chosen {chosen['path']} R={chosen['ranks']} "
              f"{pick:.5f} ms, fastest "
              f"{'R=' + str(best) if best else 'passes'} {times[best]:.5f} "
              f"ms, chosen/fastest {pick / times[best]:.3f}; every cell "
              f"equal to the plain version; ms {' '.join(cells)}")


def dsconv_sweep(gen) -> None:
    """Time ``dsconv_fused`` at stem.ds0 of B1@224, batch 1 and 8, at every
    band height (output rows a CTA) of a few that fit, each within ``TOL``
    of the plain version; beside each cell its grid and the CTAs an SM
    holds; the pick of ``choose_blocks`` marked and its time over the
    fastest cell printed."""
    import torch
    from repro_torch.kernels.dsconv.kernel import (
        choose_blocks, dsconv_fused, dsconv_smem_bytes)
    from repro_torch.kernels.dsconv.ref import dsconv_ref
    from repro_torch.kernels.registry import SMEM_LIMIT, SMEM_PER_SM

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    H, C, F = 112, 16, 16
    for batch in (1, 8):
        args = (rn(batch, H, H, C), rn(3, 3, C, scale=1 / 3), rn(C),
                rn(C, F, scale=C ** -0.5), rn(F))
        ref = dsconv_ref(*args)
        tol = TOL * max(1.0, ref.abs().max().item())
        chosen = choose_blocks(args[0].shape, F, 1)["block_rows"]
        cells, times = [], {}
        for rows in (1, 2, 3, 4, 6, 7, 8, 14, 16, 28):
            smem = dsconv_smem_bytes(H, C, F, 1, rows)
            if smem > SMEM_LIMIT:
                continue
            fn = lambda r=rows: dsconv_fused(*args, block_rows=r)
            err = (fn() - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"dsconv_fused R={rows} B={batch}: "
                                     f"max|d| {err:.3e} > {tol:.3e}")
            times[rows] = device_ms(fn, reps=20, windows=3)
            mark = "*" if rows == chosen else ""
            # CTAs an SM holds: 4 by the registers (dsconv_band's
            # __launch_bounds__), else by the shared memory
            per_sm = min(4, SMEM_PER_SM // (smem + 1024))
            cells.append(f"{mark}R={rows}:{times[rows]:.5f}"
                         f"({batch * -(-H // rows)}x,{per_sm}/SM)")
        best = min(times, key=times.get)
        print(f"[dsconv sweep] stem.ds0 x{(batch, H, H, C)} F={F} B={batch} "
              f"chosen R={chosen} {times[chosen]:.5f} ms, fastest R={best} "
              f"{times[best]:.5f} ms, chosen/fastest "
              f"{times[chosen] / times[best]:.3f}; every cell within TOL of "
              f"the plain version; ms (CTAs, CTAs an SM) {' '.join(cells)}")
    # channel counts that are no multiple of 4 (zero-padded quads in
    # shared memory, the output stored channel by channel)
    for H, C, F, st in ((28, 6, 10, 1), (28, 6, 10, 2), (14, 3, 7, 1)):
        args = (rn(2, H, H, C), rn(3, 3, C, scale=1 / 3), rn(C),
                rn(C, F, scale=C ** -0.5), rn(F))
        ref = dsconv_ref(*args, stride=st)
        err = (dsconv_fused(*args, stride=st) - ref).abs().max().item()
        tol = TOL * max(1.0, ref.abs().max().item())
        print(f"[dsconv] x{(2, H, H, C)} F={F} s={st}: max|d| {err:.3e} "
              f"(max|ref| {ref.abs().max().item():.3e})")
        if not err <= tol:
            raise AssertionError(f"dsconv_fused C={C} F={F} s={st}: max|d| "
                                 f"{err:.3e} > {tol:.3e}")


def check_groups(engine, tag) -> None:
    """Every bucket's plan groups exactly ``GROUPS``; print each group's
    blocks, its band windows and the rows each member computes per row
    it hands on (the halo recompute), and the pack counters: one build
    per group per engine, a hit for every later bucket."""
    from repro_torch.core.program import SuperSite
    from repro_torch.kernels.supersite.ops import fp_windows

    for key in engine.cache.keys():
        ex = engine.cache.get(key.batch, key.resolution)
        got = {g.name: tuple(g.members) for g in ex.plan.groups.values()}
        if got != GROUPS:
            raise AssertionError(f"bucket {key.batch}: groups {got}, "
                                 f"expected {GROUPS}")
        for g in ex.plan.groups.values():
            text = f"[{tag}] bucket {key.batch} {g.name} {g.precision} " \
                   f"blocks {dict(g.blocks)}"
            if g.precision == "fp":
                sup = SuperSite.of(ex.program, g.members, name=g.name)
                nb, members = fp_windows(sup, g.blocks["block_rows"])
                text += "; windows/recompute " + ", ".join(
                    f"{m_.n_out}<-{m_.length} rows "
                    f"x{m_.n_out * nb / (m_.h_in // m_.stride):.2f}"
                    for m_ in members)
            print(text)
    counters = engine.telemetry.counters
    built = counters.get("weight_pack_built", 0)
    hits = counters.get("weight_pack_hit", 0)
    n_buckets = len(engine.cache.keys())
    print(f"[{tag}] weight packs: built {built}, hit {hits} over "
          f"{n_buckets} buckets")
    if built != len(GROUPS) or hits != len(GROUPS) * (n_buckets - 1):
        raise AssertionError(f"weight packs built {built}, hit {hits}: "
                             f"expected one build per group per engine")


def grouped_vs_per_site(engine, x8, tag, exact: bool):
    """The batch-8 forward of the served (grouped) plan against the same
    forward under ``supersites=False``."""
    import torch
    from repro_torch.core.fusion import plan_program
    from repro_torch.core.program import execute

    ex = engine.cache.get(8, x8.shape[1])
    flat = plan_program(ex.program, engine.params, supersites=False)
    if flat.groups or not ex.plan.groups:
        raise AssertionError("the per-site plan must not group, the "
                             "served one must")
    with torch.inference_mode():
        got = engine.logits(x8)
        want = execute(ex.program, engine.params, x8, plan=flat)
    torch.cuda.synchronize()
    d = (got - want).abs().max().item()
    top = max(1.0, want.abs().max().item())
    print(f"[{tag}] grouped vs per-site plan, batch 8: max|d| {d:.3e} "
          f"(max(1, max|logit|) {top:.3e})")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"grouped FIX8 logits differ from per-site: "
                             f"{int((got != want).sum())} of {got.numel()}")
    if not d <= TOL * top:
        raise AssertionError(f"grouped fp32 logits {d:.3e} from per-site")
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("grouped top-1 differs from per-site")


def randomize_bn(tree, gen) -> None:
    """Give every BatchNorm non-trivial statistics (init is identity,
    which would leave BN folding untested)."""
    import torch
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape[0]
            dev = tree["scale"].device
            tree["scale"] = (0.8 + 0.4 * torch.rand(n, generator=gen)).to(dev)
            tree["bias"] = (0.1 * torch.randn(n, generator=gen)).to(dev)
            tree["mean"] = (0.1 * torch.randn(n, generator=gen)).to(dev)
            tree["var"] = (0.5 + torch.rand(n, generator=gen)).to(dev)
            return
        for v in tree.values():
            randomize_bn(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            randomize_bn(v, gen)


def measure(case, exact: bool, reps: int = 20, windows: int = 5):
    """Run one case's kernel and plain version, hold them together and
    time both (and the library yardstick) -> (max|d|, max|ref| or None
    for the exact kernels, ms, plain_ms, library_ms or None, bound_ms,
    bound_by)."""
    import torch
    name, _, label, kfn, pfn, nbytes, ops = case[:7]
    lib = case[7] if len(case) > 7 else None
    got, ref = kfn(), pfn()
    torch.cuda.synchronize()
    if exact:
        got, ref = tuple(got), tuple(ref)
        diff = [int((g != r).sum()) for g, r in zip(got, ref)]
        if any(diff) or any(g.dtype != r.dtype for g, r in zip(got, ref)):
            raise AssertionError(f"{name} {label}: elements differing "
                                 f"from the plain version: {diff}")
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, ref))
        ref_max = None
    else:
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        if not err <= TOL * max(1.0, ref_max):
            raise AssertionError(f"{name} {label}: max|d| {err:.3e} > "
                                 f"{TOL} * max(1, {ref_max:.3e})")
    del got, ref
    ms = device_ms(kfn, reps, windows)
    plain_ms = device_ms(pfn, min(reps, 5) if exact else reps, windows)
    lib_ms = device_ms(lib, reps, windows) if lib is not None else None
    b_ms, by = bound(nbytes, ops, PEAK_INT8_OPS if exact else PEAK_FP32_FLOPS)
    return err, ref_max, ms, plain_ms, lib_ms, b_ms, by


def kernel_line(tag, case, where, err, ref_max, ms, plain_ms, lib_ms, b_ms,
                by) -> None:
    name, _, label = case[:3]
    lib_txt = f" library_ms={lib_ms:.5f}" if lib_ms is not None else ""
    ref_txt = f" (max|ref| {ref_max:.3e})" if ref_max is not None else ""
    print(f"[{tag}] {name} {where}{label} max|d|={err:.3e}{ref_txt} "
          f"ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f}{lib_txt} bound_ms={b_ms:.5f} ({by}) "
          f"roofline={b_ms / ms:.3f}")


def add_time(acc, n, case, ms, plain_ms, lib_ms, b_ms, exact) -> None:
    """Add ``n`` calls of a case to a kernel's row of the JSON line."""
    nbytes, ops = case[5:7]
    peak = PEAK_INT8_OPS if exact else PEAK_FP32_FLOPS
    acc["ms"] += n * ms
    acc["plain_ms"] += n * plain_ms
    acc["bound_ms"] += n * b_ms
    acc["bytes_s"] += n * nbytes / PEAK_BYTES_PER_S
    acc["ops_s"] += n * ops_seconds(ops, peak)
    if lib_ms is not None:
        acc["library_ms"] = acc.get("library_ms", 0.0) + n * lib_ms


def check_kernels(cases, batch, per_fwd, max_err, exact: bool,
                  tag: str = "kernel"):
    """Hold each case's kernel against its plain version, time both,
    print one [kernel] line each and add the batch-8 times to
    ``per_fwd``.  ``mbconv_fused`` and ``supersite_fused`` must also give
    equal bits on two calls."""
    import torch
    for case in cases:
        name, sites = case[:2]
        if name in ("mbconv_fused", "supersite_fused"):
            if not torch.equal(case[3](), case[3]()):
                raise AssertionError(f"{name} {case[2]}: two calls differ")
        err, ref_max, *times = measure(case, exact)
        max_err[name] = max(max_err[name], err)
        kernel_line(tag, case, f"B={batch} sites={len(sites)} ", err,
                    ref_max, *times)
        if batch == 8:
            add_time(per_fwd[name], len(sites), case, *times[:4], exact)


def serve_trace(make_engine, images, wrappers, expected, tag):
    """The main path's run.  Every launch counter is set to 0, then the
    engine is made and warmed (``make_engine()``, ``warmup()``): each key's
    eager warm-up run and its capture issue every launch the wrappers
    count, since a replay runs no wrapper.  Then 12 requests with mixed
    deadlines are served through the engine's scheduler under one
    ``torch.profiler`` capture, and the counters are read just after.
    In the same capture, one eager forward of each dispatched bucket's
    (program, plan) follows.  Checks: the wrappers launched exactly the
    expected kernels per forward, twice per key (warm-up run, capture);
    each key's capture recorded them; on the device, the served run's
    port kernels split at each copy-in (the pinned batch copied into a
    graph's static input) give one replay per dispatch, and each replay
    launched exactly the port kernels of the eager forward of its
    bucket, by name and count, whose wrappers launched the expected
    kernels.  Returns (engine, logits, launches)."""
    import collections
    import re

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from repro_torch.core.program import execute
    from repro_torch.serving.scheduler import Request

    from repro_torch.kernels import autotune

    for w in wrappers.values():
        w.launches = 0
    autotune.SWEEP_LAUNCHES.clear()
    engine = make_engine()
    engine.warmup()
    keys = engine.cache.keys()
    # a cold autotune cache sweeps at build: those launches are not the
    # path's (none on this run's warm cache)
    swept = dict(autotune.SWEEP_LAUNCHES)
    warm = {k: w.launches - swept.get(k, 0) for k, w in wrappers.items()}
    for name, per in expected.items():
        if warm[name] != 2 * per * len(keys):
            raise AssertionError(
                f"{name}: {warm[name]} launches to warm {len(keys)} keys, "
                f"expected {per} per forward, warm-up run and capture")
    check_graphs(engine, expected, tag)
    sched = engine.scheduler()
    # request 2 is due at once (flushes 3 requests to bucket 4), requests
    # 3..10 fill bucket 8, request 11 goes to bucket 1 at drain
    deadlines = [60_000.0, None, 0.0] + [60_000.0, None] * 4 + [None]
    reqs = [Request(i, images[i], deadline_ms=deadlines[i],
                    timeout_ms=600_000.0) for i in range(12)]
    torch.cuda.synchronize()
    with profiled() as prof:
        with record_function("chip_smoke.serve"):
            t0 = time.perf_counter()
            for r in reqs:
                sched.submit(r)
                sched.step()
            sched.step(drain=True)
            t_fin = time.perf_counter()
            sched.finalize()
            wall = time.perf_counter() - t0
            fin = time.perf_counter() - t_fin
            torch.cuda.synchronize()
        launches = {k: w.launches - swept.get(k, 0)
                    for k, w in wrappers.items()}
        dispatched = sorted(k[0] for k, b in engine.telemetry.buckets.items()
                            for _ in range(b.dispatches))
        for bucket in sorted(set(dispatched)):
            ex = engine.cache.get(bucket, 224)
            x = torch.zeros((bucket, 224, 224, 3), device="cuda")
            with record_function(f"chip_smoke.eager.{bucket}"), \
                    torch.inference_mode():
                execute(ex.program, engine.params, x, plan=ex.plan)
                torch.cuda.synchronize()
    eager_launches = {k: w.launches - swept.get(k, 0) - launches[k]
                      for k, w in wrappers.items()}
    if any(r.status != "completed" for r in reqs):
        raise AssertionError([(r.rid, r.status, r.error) for r in reqs])
    print(f"[{tag}] main path: counters at 0, then the engine made and "
          f"warmed ({len(keys)} keys: warm-up run and capture each), "
          f"{len(reqs)} requests served; launches {launches} (sweeps' "
          f"launches, not counted: {swept})")
    print(f"[{tag}] dispatched buckets {dispatched}; {len(reqs)} images in "
          f"{wall * 1e3:.2f} ms under torch.profiler; host: submit + step "
          f"{(wall - fin) * 1e3:.2f} ms, finalize (waiting on the card) "
          f"{fin * 1e3:.2f} ms")
    if launches != warm:
        raise AssertionError(f"serving launched through the wrappers: "
                             f"{launches} after warm-up {warm}")
    for name, per in expected.items():
        if eager_launches[name] != per * len(set(dispatched)):
            raise AssertionError(f"{name}: {eager_launches[name]} launches "
                                 f"in {len(set(dispatched))} eager "
                                 f"forwards, expected {per} each")

    # the device side, by the profiler.  The window holds the served run
    # (nothing ran on the device before it) and then the eager forwards,
    # split on the device's clock where a range shows on the device side
    events = prof.events()
    host_at = {e.name: e.time_range.start for e in events
               if e.device_type == DeviceType.CPU
               and e.name.startswith("chip_smoke.")}
    dev_at: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name in host_at:
            dev_at[e.name] = min(dev_at.get(e.name, e.time_range.start),
                                 e.time_range.start)
    starts = host_at | dev_at
    skew = {n[len("chip_smoke."):]: round(dev_at[n] - host_at[n], 1)
            for n in dev_at}
    print(f"[{tag}] profiler: each range's first device activity after its "
          f"host start, us: {skew}")
    eager_at = sorted((starts[f"chip_smoke.eager.{b}"], b)
                      for b in set(dispatched))
    ours = port_kernel_names()
    kname = lambda name: re.match(r"(?:void\s+)?(\w+)", name).group(1)
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and not is_range(e.name)),
                    key=lambda e: e.time_range.start)
    replays, eager = [], collections.defaultdict(collections.Counter)
    for e in device:
        t = e.time_range.start
        if t < eager_at[0][0]:
            if "Memcpy HtoD" in e.name:
                replays.append(collections.Counter())
            elif kname(e.name) in ours:
                if not replays:
                    seen = [f"{x.name[:40]}@{x.time_range.start - t:+.1f}us"
                            for x in device[:16]]
                    raise AssertionError(
                        f"{e.name} before any copy-in; the first device "
                        f"events (relative to it): {seen}")
                replays[-1][kname(e.name)] += 1
        else:
            bucket = [b for at, b in eager_at if at <= t][-1]
            if kname(e.name) in ours:
                eager[bucket][kname(e.name)] += 1
    print(f"[{tag}] profiler over the served run: {len(replays)} copy-ins "
          f"(one per dispatch), the port's kernels per replay "
          + "; ".join(f"{dict(c)}" for c in replays))
    for bucket, c in sorted(eager.items()):
        print(f"[{tag}] profiler, eager forward of bucket {bucket}: the "
              f"port's kernels {dict(c)}")
    want = sorted((sorted(eager[b].items()) for b in dispatched))
    got = sorted(sorted(c.items()) for c in replays)
    if len(replays) != len(dispatched) or got != want:
        raise AssertionError(f"the served replays launched {got} on the "
                             f"device; the eager forwards of the "
                             f"dispatched buckets {dispatched}: {want}")
    total = collections.Counter()
    for c in replays:
        total.update(c)
    print(f"[{tag}] each of the {len(dispatched)} dispatched replays "
          f"launched on the device the port's kernels of its bucket's "
          f"eager forward ({sum(total.values())} CUDA launches of the "
          f"port's kernels in all)")
    for key, b in sorted(engine.telemetry.buckets.items()):
        st = b.snapshot()
        print(f"[{tag}] bucket {key}: dispatches={b.dispatches} "
              f"samples={b.samples} padded={b.padded} "
              f"latency_ms p50={st['latency_ms_p50']:.3f} "
              f"max={max(b.latency_ms):.3f}")
    got = np.stack([r.logits for r in reqs])
    if not np.all(np.isfinite(got)) or got.shape[0] != 12:
        raise AssertionError(f"bad logits: shape {got.shape}")
    check_healthy(engine, tag)
    return engine, got, launches


def check_graphs(engine, expected, tag) -> None:
    """Every cached executor holds a CUDA graph whose capture issued
    exactly the expected launches per forward (each replay repeats them
    on the device; ``serve_trace`` counts them there); print each key's
    bytes in the graph pool."""
    want = {k: v for k, v in expected.items() if v}
    for key in engine.cache.keys():
        ex = engine.cache.get(key.batch, key.resolution)
        if ex.graph is None:
            raise AssertionError(f"bucket {key.batch}: no CUDA graph")
        if ex.replay_launches != want:
            raise AssertionError(f"bucket {key.batch}: the capture "
                                 f"recorded {ex.replay_launches}, expected "
                                 f"{want} per forward")
        pool = ("not measured" if ex.graph_bytes is None
                else f"{ex.graph_bytes / 2**20:.1f} MiB")
        print(f"[{tag}] graph bucket {key.batch}@{key.resolution}: "
              f"launches per replay = captured {ex.replay_launches}; "
              f"graph pool grew {pool}")


def check_healthy(engine, tag) -> None:
    """A healthy phase moves no ladder and retries nothing."""
    c = engine.telemetry.counters
    ladder = {k: c.get(k, 0) for k in ("degraded", "pinned_fp", "retries",
                                       "failed")}
    print(f"[{tag}] ladder counters {ladder}")
    if any(ladder.values()):
        raise AssertionError(f"healthy phase moved the ladder: {ladder}")


def steady_state(engine, rng, tag):
    """64 images as 8 full buckets, host clock to a synchronize; then one
    batch-8 forward's device time as a graph replay and run eagerly
    (CUDA events, the host's enqueue hidden behind a sleep kernel) beside
    the host's time per replay.  Returns (replay, eager) of the batch-8
    forward, for ``kernel_profile``."""
    import numpy as np
    import torch
    from repro_torch.core.program import execute
    batch64 = torch.from_numpy(
        rng.standard_normal((64, 224, 224, 3)).astype(np.float32)).cuda()
    engine.logits(batch64[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.logits(batch64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{tag}] steady state: 64 images in 8 buckets of 8: "
          f"{wall * 1e3:.3f} ms = {64 / wall:.1f} images/s")
    ex = engine.cache.get(8, 224)
    x8 = batch64[:8]
    fwd = lambda: ex(engine.params, x8)

    def eager():
        with torch.inference_mode():
            return execute(ex.program, engine.params, x8, plan=ex.plan)
    dev = device_ms(fwd, reps=1, windows=5)
    dev5 = device_ms(fwd, reps=5, windows=5)
    # one eager forward per window: it queues ~660 launches, and five of
    # them overrun the stream's launch queue
    dev_eager = device_ms(eager, reps=1, windows=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fwd()
    host = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        eager()
    host_eager = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    per = wall / 8 * 1e3
    print(f"[{tag}] one batch-8 forward: device {dev:.3f} ms as a graph "
          f"replay ({dev5:.3f} ms a replay over windows of 5), {dev_eager:.3f} "
          f"ms eager; host {host:.3f} ms per replay ({host_eager:.3f} ms "
          f"eager enqueue); steady state {per:.3f} ms per forward (device "
          f"idle {max(0.0, 1 - dev / per):.1%} of it)")
    return fwd, eager


def graph_checks(engine, rng, tag) -> None:
    """``[graph]`` lines: at batch 1, 4 and 8 the replayed logits equal
    the eager forward of the same (program, plan) bit for bit; 64 images
    sent as 8 buckets of 8 before any is read equal the 8 forwards run
    one at a time (a replay's logits are copied out of the graph in
    stream order)."""
    import numpy as np
    import torch
    from repro_torch.core.program import execute
    for batch in (1, 4, 8):
        ex = engine.cache.get(batch, 224)
        x = torch.from_numpy(rng.standard_normal(
            (batch, 224, 224, 3)).astype(np.float32)).cuda()
        got = ex(engine.params, x)
        with torch.inference_mode():
            want = execute(ex.program, engine.params, x, plan=ex.plan)
        torch.cuda.synchronize()
        n = int((got != want).sum())
        print(f"[graph] {tag} batch {batch}: replay vs eager, {n} of "
              f"{got.numel()} logits differ")
        if n:
            raise AssertionError(f"{tag} batch {batch}: replayed logits "
                                 f"differ from eager in {n} places")
    ex = engine.cache.get(8, 224)
    xs = torch.from_numpy(rng.standard_normal(
        (64, 224, 224, 3)).astype(np.float32)).cuda()
    torch.cuda.synchronize()
    in_flight = torch.cat([ex(engine.params, xs[8 * i:8 * i + 8])
                           for i in range(8)])
    one_by_one = []
    for i in range(8):
        one_by_one.append(ex(engine.params, xs[8 * i:8 * i + 8]))
        torch.cuda.synchronize()
    n = int((in_flight != torch.cat(one_by_one)).sum())
    print(f"[graph] {tag}: 64 images as 8 buckets in flight vs 8 forwards "
          f"one at a time: {n} logits differ")
    if n:
        raise AssertionError(f"{tag}: in-flight replays differ in {n}")


def faults_phase(params, images, wrappers, expected_fp) -> None:
    """``[faults]``: the ladder on the card, at B1@224 batch 8.

    fp32: ``kernel.launch`` fires twice on ``S2.mb1`` (a member of
    S2.ss0): the first failure retries, the second moves the key to level
    1 with the site demoted; the rebuilt plan groups as the planner says
    (S2.ss0 split), its graph is captured anew, and the requests complete
    within the fp32 gate of the reference forward.  FIX8:
    ``epilogue.numerics`` once: finalize finds the NaN, the key pins to
    fp, a new graph runs no int8 kernel, and the requests complete within
    the FIX8 gate.  A request whose hard deadline passes while queued is
    swept before batch formation at both."""
    import numpy as np
    import torch
    from repro_torch.common.errors import DeadlineExceeded
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import plan_program
    from repro_torch.core.program import execute, lower
    from repro_torch.kernels import autotune
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import ManualClock, Request
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    x8 = torch.from_numpy(images[:8]).cuda()
    cfg = VisionServeConfig(microbatch=8, buckets=(8,))
    runs = (
        ("fp32", FaultPlan(FaultSpec("kernel.launch", times=2,
                                     match={"batch": 8}, site="S2.mb1")),
         lambda f: VisionEngine(params, B1, cfg, faults=f)),
        ("fix8", FaultPlan(FaultSpec("epilogue.numerics", times=1,
                                     match={"batch": 8})),
         lambda f: VisionEngine.quantized(params, B1, cfg, faults=f)))
    for name, faults, make in runs:
        engine = make(faults)
        old = engine.cache.get(8, 224)
        clock = ManualClock()
        sched = engine.scheduler(clock=clock, backoff_ms=0.0)
        reqs = [Request(i, images[i]) for i in range(8)]
        late = Request(99, images[8], timeout_ms=1.0)
        for r in reqs + [late]:
            sched.submit(r)
        clock.advance(0.01)
        for w in wrappers.values():
            w.launches = 0
        autotune.SWEEP_LAUNCHES.clear()
        rounds = 0
        while sched.outstanding():
            sched.step(drain=True)
            sched.finalize()
            rounds += 1
            if rounds > 8:
                raise AssertionError(f"{name}: not drained")
        launches = {k: w.launches - autotune.SWEEP_LAUNCHES.get(k, 0)
                    for k, w in wrappers.items()}
        launches = {k: v for k, v in launches.items() if v}
        if any(r.status != "completed" for r in reqs):
            raise AssertionError([(r.rid, r.status, r.error) for r in reqs])
        if late.status != "shed" or not isinstance(late.error,
                                                   DeadlineExceeded):
            raise AssertionError(f"late request: {late.status}")
        samples = engine.telemetry.total("samples")
        dispatches = engine.telemetry.total("dispatches")
        if samples != 8 * dispatches:
            raise AssertionError(f"{samples} samples in {dispatches} "
                                 f"dispatches: the expired request took a "
                                 f"slot")
        state = engine.cache.degradation(8, 224)
        ex = engine.cache.get(8, 224)
        if ex is old or ex.graph is None or ex.graph is old.graph:
            raise AssertionError(f"{name}: the key was not captured anew")
        # replays run no wrapper: the wrappers launched only the
        # rebuild's eager warm-up run and its capture
        want = {k: 2 * v for k, v in ex.replay_launches.items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}: the rebuild's warm-up run and "
                                 f"capture of {ex.replay_launches}")
        got = torch.from_numpy(np.stack([r.logits for r in reqs]))
        with torch.inference_mode():
            ref = execute(lower(B1, batch=8), engine.params, x8).cpu()
        d, top = (got - ref).abs().max().item(), ref.abs().max().item()
        same_top1 = torch.equal(got.argmax(-1), ref.argmax(-1))
        groups = {g.name: tuple(g.members)
                  for g in ex.plan.groups.values()}
        print(f"[faults] {name}: fired {faults.fired}; retries "
              f"{[r.retries for r in reqs]}; ladder {state}; groups "
              f"{sorted(groups)}; new graph, launches per replay "
              f"{ex.replay_launches}; logits vs reference max|d| {d:.3e} "
              f"(max|ref| {top:.3e}), top-1 {'equal' if same_top1 else 'DIFFERS'}; "
              f"request with a 1 ms timeout shed before formation")
        if not same_top1:
            raise AssertionError(f"{name}: top-1 differs from reference")
        if name == "fp32":
            want = plan_program(ex.program, engine.params,
                                demote={"S2.mb1"})
            want_groups = {g.name: tuple(g.members)
                           for g in want.groups.values()}
            if (state is None or state.level != 1
                    or state.demoted != {"S2.mb1"} or state.pinned_fp):
                raise AssertionError(f"fp32 ladder state {state}")
            if groups != want_groups or groups != {
                    "S1.ss0": GROUPS["S1.ss0"]}:
                raise AssertionError(f"fp32 level-1 groups {groups}, the "
                                     f"planner says {want_groups}")
            if ex.plan.decisions["S2.mb1"].reason != "fault":
                raise AssertionError("S2.mb1 not demoted for the fault")
            per = {k: v for k, v in expected_fp.items() if v}
            per.update(mbconv_fused=per["mbconv_fused"] + 2,
                       supersite_fused=1)
            if ex.replay_launches != per:
                raise AssertionError(f"level-1 launches "
                                     f"{ex.replay_launches}, expected {per}")
            if any(r.retries != 2 for r in reqs):
                raise AssertionError("fp32: expected two failed attempts")
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       rtol=1e-3, atol=1e-3)
        else:
            if state is None or not state.pinned_fp or state.level:
                raise AssertionError(f"FIX8 ladder state {state}")
            if ex._runs_int8 or any("int8" in k for k in ex.replay_launches):
                raise AssertionError(f"FIX8 pinned key still runs int8 "
                                     f"kernels: {ex.replay_launches}")
            if any(r.retries != 1 for r in reqs):
                raise AssertionError("FIX8: expected one failed attempt")
            if not d <= CHAOS * top:
                raise AssertionError(f"FIX8 pinned logits {d:.3e} from the "
                                     f"int8 reference, above {CHAOS} * "
                                     f"{top:.3e}")
        if not faults.exhausted:
            raise AssertionError(f"{name}: faults left unfired")


def fresh_cache(tag: str) -> str:
    """Point the autotune cache at a new file under the gitignored
    ``build/autotune/`` and drop the in-process cache: the next plan
    sweeps every tuner it consults.  Returns the new path."""
    path = os.path.join(ROOT, "build", "autotune",
                        f"{tag}-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    use_cache(path)
    return path


def use_cache(path: str) -> None:
    """Serve the autotune cache from ``path`` (reloaded from the file)."""
    from repro_torch.kernels import autotune
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
    autotune.clear_memory_cache()


def fmt_blocks(blocks) -> str:
    return ",".join(f"{k}={v}" for k, v in (blocks or {}).items()) or "-"


def print_sweeps(tag, start: int) -> None:
    """One line per sweep logged since ``start``: each candidate's device
    time, the choice and the model's pick (the first candidate)."""
    from repro_torch.kernels import autotune
    for e in autotune.SWEEP_LOG[start:]:
        times = "; ".join(
            f"{fmt_blocks(c)} " + (f"{t * 1e3:.4f} ms" if t is not None
                                   else f"raised {err}")
            for c, t, err in e["times"])
        pick = e["times"][0][0]
        print(f"[{tag}] sweep {e['kind']} {','.join(e['key'][:-1])}: "
              f"{times} -> {fmt_blocks(e['choice'])}"
              f"{'' if e['choice'] == pick else ' (model: ' + fmt_blocks(pick) + ')'}"
              f" in {e['seconds']:.2f} s")


def blocks_vs_model(engine, tag) -> int:
    """Print, per cached key, every site and group whose frozen blocks
    differ from the model's pick (the plan with ``autotune=False``);
    returns how many differ."""
    from repro_torch.core.fusion import plan_program
    n = 0
    for key in engine.cache.keys():
        ex = engine.cache.get(key.batch, key.resolution)
        model = plan_program(ex.program, engine.params, autotune=False,
                             precision=engine.cache.precision,
                             epilogues=engine.cache.epilogues)
        rows = [(d.name, dict(d.blocks), dict(model.decisions[d.name].blocks))
                for d in ex.plan.decisions.values()
                if d.fused and dict(d.blocks)
                != dict(model.decisions[d.name].blocks)]
        rows += [(g.name, dict(g.blocks), dict(model.groups[g.name].blocks))
                 for g in ex.plan.groups.values() if g.name in model.groups
                 and dict(g.blocks) != dict(model.groups[g.name].blocks)]
        n += len(rows)
        print(f"[{tag}] bucket {key.batch}: {len(rows)} of the "
              f"{ex.plan.n_fused()} fused sites and {len(ex.plan.groups)} "
              f"groups tuned off the model's pick"
              + "".join(f"; {name} {fmt_blocks(t)} (model "
                        f"{fmt_blocks(m)})" for name, t, m in rows))
    return n


def site_walk(program, params, x, plan, tag) -> None:
    """Print the first site whose int8 boundary codes differ between the
    fused forward under ``plan`` and the int8 reference forward, each
    run over the program cut after that site: the codes that differ
    there, the largest code step, whether the per-image scales are
    equal, and the largest fp difference at that boundary.  Boundaries
    inside a super-site group are not read (a group runs whole)."""
    import dataclasses

    import torch
    from repro_torch.core.program import execute
    from repro_torch.core.quantization import QTensor, act_fp, quantize_act
    inner = {n for g in plan.groups.values() for n in g.members[:-1]}
    with torch.inference_mode():
        for k, site in enumerate(program.sites, 1):
            if site.name in inner:
                continue
            sub = dataclasses.replace(program, sites=program.sites[:k])
            ref = execute(sub, params, x)
            fused = execute(sub, params, x, plan=plan)
            if not isinstance(fused, QTensor):
                continue
            rq = quantize_act(ref)
            n = int((rq.q != fused.q).sum())
            if n:
                step = int((rq.q.int() - fused.q.int()).abs().max())
                fp = fused.fp if fused.fp is not None else (
                    fused.q.float() * fused.scale_col().reshape(
                        (-1,) + (1,) * (fused.q.dim() - 1)))
                dfp = float((fp.float() - act_fp(ref).float()).abs().max())
                print(f"[{tag}] site walk: first differing int8 boundary "
                      f"{site.name} ({site.kind}): {n} of "
                      f"{fused.q.numel()} codes differ, by at most {step}; "
                      f"scales equal {torch.equal(rq.scale, fused.scale)}; "
                      f"fp max|d| there {dfp:.3e}")
                return
    print(f"[{tag}] site walk: every int8 boundary's codes equal the "
          f"int8 reference's")


def check_logits(got, ref, tag, fix8=False, noise=None) -> None:
    """The §2 gates: fp32 within rtol = atol = 1e-3 of the reference
    forward, FIX8 within 0.1 * max|logit| of the int8 reference; top-1
    equal.  Each image whose top-1 differs is printed with both classes'
    logits on both sides.  ``noise``: how far the reference lies from
    itself, the largest max|d| of its batch-8 rows from its batch-1
    forwards (``reference_noise``; a summation order flips codes in one
    image and not in another, so one image's distance is no bound).
    With it, the logits must lie within twice the noise of the
    reference, and a top-1 need agree only where the reference's margin
    between the two classes exceeds twice the noise: the reference does
    not decide a closer one itself."""
    import numpy as np
    got = got.float().cpu().numpy()
    ref = ref.float().cpu().numpy()
    d, top = np.abs(got - ref).max(), np.abs(ref).max()
    gi, ri = got.argmax(-1), ref.argmax(-1)
    bad = np.flatnonzero(gi != ri)
    print(f"[{tag}] logits vs the {'int8 ' if fix8 else ''}reference "
          f"forward: max|d| {d:.3e} (max|ref| {top:.3e}, {d / top:.3e} of "
          f"it), top-1 equal in {len(ri) - len(bad)} of {len(ri)} images"
          + "".join(f"; image {i}: served class {gi[i]} ({got[i, gi[i]]:.4f}"
                    f", reference {ref[i, gi[i]]:.4f}), reference class "
                    f"{ri[i]} ({ref[i, ri[i]]:.4f}, served "
                    f"{got[i, ri[i]]:.4f})" for i in bad))
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{tag}: non-finite logits")
    for i in bad:
        margin = ref[i, ri[i]] - ref[i, gi[i]]
        if noise is None or margin > 2 * noise:
            raise AssertionError(f"{tag}: top-1 of image {i} differs from "
                                 f"the reference (margin {margin:.4f})")
    if noise is not None and not d <= 2 * noise:
        raise AssertionError(f"{tag}: logits {d:.3e} from the reference, "
                             f"above twice its own noise {noise:.3e}")
    if fix8:
        if not d <= CHAOS * top:
            raise AssertionError(f"{tag}: FIX8 logits {d:.3e} from the "
                                 f"int8 reference, above {CHAOS} * {top:.3e}")
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def reference_noise(cfg, params, x, ref, tag):
    """How far the reference forward lies from itself: the largest max|d|
    between its rows at ``len(x)`` (``ref``) and its forwards of one image
    each.  At FIX8 an fp summation order that follows the batch flips a
    few int8 codes by one step, and random weights amplify them through
    the requants (ROADMAP R6).  Each image's distance is printed beside
    its top-two margin."""
    import torch
    from repro_torch.core.program import execute, lower
    with torch.inference_mode():
        ones = torch.cat([execute(lower(cfg, batch=1), params, x[i:i + 1])
                          for i in range(len(x))])
    noise = (ref - ones).abs().amax(-1).float().cpu().numpy()
    top2 = ref.float().topk(2, -1).values.cpu().numpy()
    print(f"[{tag}] the reference against itself, batch {len(x)} vs "
          f"batch 1: max|d| per image "
          + ", ".join(f"{v:.4f}" for v in noise)
          + "; its top-two margins "
          + ", ".join(f"{a - b:.4f}" for a, b in top2))
    return float(noise.max())


def replay_ab(fwds, tag) -> None:
    """Device time of one batch-8 replay per plan, A/B in one process
    (each named forward timed, then again in reverse order)."""
    names = list(fwds) + list(fwds)[::-1]
    times = {n: [] for n in fwds}
    for n in names:
        times[n].append(device_ms(fwds[n], reps=1, windows=5))
    print(f"[{tag}] batch-8 replay device time, A/B in one process: "
          + "; ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                      for n, ts in times.items()))


def autotune_phase(params, x8, expected_fp, expected_int8):
    """``[autotune]``, B1@224 at both precisions on a fresh cache file.

    The model's engines (``autotune=False``) first; then the tuned
    engines, whose builds sweep on the cold cache (every sweep printed:
    each candidate's time, the choice, the model's pick), the blocks per
    bucket against the model's; a second fp32 engine after the in-process
    cache is dropped reads the file and sweeps nothing.  No candidate is
    disqualified.  Gates: launches per forward 19 / 26 (the captures),
    22 / 29 with ``supersites=False``; fp32 logits within the §2 gates of
    the reference forward; FIX8 plans and logits equal with autotune on
    and off (int8 blocks are not tuned).  Returns the tuned engines."""
    import dataclasses

    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import launch_counts, plan_program
    from repro_torch.core.program import execute, lower
    from repro_torch.kernels import autotune
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    path = fresh_cache("autotune")
    cfg8 = VisionServeConfig(microbatch=8)
    off = dataclasses.replace(cfg8, autotune=False)
    n0 = autotune.SWEEP_COUNT
    model = VisionEngine(params, B1, off).warmup()
    if autotune.SWEEP_COUNT != n0:
        raise AssertionError("autotune=False swept")
    log0 = len(autotune.SWEEP_LOG)
    t0 = time.perf_counter()
    tuned = VisionEngine(params, B1, cfg8).warmup()
    secs = time.perf_counter() - t0
    sweeps = autotune.SWEEP_COUNT - n0
    print_sweeps("autotune", log0)
    swept_s = sum(e["seconds"] for e in autotune.SWEEP_LOG[log0:])
    print(f"[autotune] fp32 engine on a cold cache ({path}): {sweeps} "
          f"sweeps taking {swept_s:.2f} s of its {secs:.2f} s build (4 "
          f"keys: plan, warm-up run, capture); {autotune.DISQUALIFIED} "
          f"candidates disqualified; sweep launches "
          f"{dict(autotune.SWEEP_LAUNCHES)}")
    if not sweeps:
        raise AssertionError("a cold cache swept nothing")
    blocks_vs_model(tuned, "autotune")
    check_graphs(tuned, expected_fp, "autotune")
    for key in tuned.cache.keys():
        ex = tuned.cache.get(key.batch, key.resolution)
        flat = plan_program(ex.program, tuned.params, supersites=False)
        got = (launch_counts(ex.plan)["fused"], launch_counts(flat)["fused"])
        if got != (19, 22):
            raise AssertionError(f"bucket {key.batch}: launches {got}, "
                                 f"expected (19, 22)")
    autotune.clear_memory_cache()
    n1 = autotune.SWEEP_COUNT
    again = VisionEngine(params, B1, cfg8).warmup()
    print(f"[autotune] a second engine after the in-process cache was "
          f"dropped: {autotune.SWEEP_COUNT - n1} new sweeps")
    if autotune.SWEEP_COUNT != n1:
        raise AssertionError("a warm cache swept again")
    for key in tuned.cache.keys():
        a = tuned.cache.get(key.batch, key.resolution).plan
        b = again.cache.get(key.batch, key.resolution).plan
        if [d.to_dict() for d in a.decisions.values()] != \
                [d.to_dict() for d in b.decisions.values()] or \
                [g.to_dict() for g in a.groups.values()] != \
                [g.to_dict() for g in b.groups.values()]:
            raise AssertionError(f"bucket {key.batch}: the warm cache "
                                 f"planned other blocks")
    del again
    with torch.inference_mode():
        ref = execute(lower(B1, batch=8), tuned.params, x8)
    check_logits(tuned.logits(x8), ref, "autotune fp32")
    ex_t, ex_m = tuned.cache.get(8, 224), model.cache.get(8, 224)
    replay_ab({"model": lambda: ex_m(model.params, x8),
               "tuned": lambda: ex_t(tuned.params, x8)}, "autotune fp32")
    del model

    n2 = autotune.SWEEP_COUNT
    qmodel = VisionEngine.quantized(params, B1, off).warmup()
    qtuned = VisionEngine.quantized(params, B1, cfg8).warmup()
    print(f"[autotune] FIX8 engines, autotune off and on: "
          f"{autotune.SWEEP_COUNT - n2} sweeps")
    if autotune.SWEEP_COUNT != n2:
        raise AssertionError("a FIX8 plan swept")
    check_graphs(qtuned, expected_int8, "autotune")
    for key in qtuned.cache.keys():
        a = qtuned.cache.get(key.batch, key.resolution)
        b = qmodel.cache.get(key.batch, key.resolution)
        if [d.to_dict() for d in a.plan.decisions.values()] != \
                [d.to_dict() for d in b.plan.decisions.values()] or \
                [g.to_dict() for g in a.plan.groups.values()] != \
                [g.to_dict() for g in b.plan.groups.values()]:
            raise AssertionError(f"FIX8 bucket {key.batch}: plans differ "
                                 f"with autotune on and off")
        flat = plan_program(a.program, qtuned.params, supersites=False)
        got = (launch_counts(a.plan)["fused"], launch_counts(flat)["fused"])
        if got != (26, 29):
            raise AssertionError(f"FIX8 bucket {key.batch}: launches {got}")
    got_t, got_m = qtuned.logits(x8), qmodel.logits(x8)
    torch.cuda.synchronize()
    n = int((got_t != got_m).sum())
    print(f"[autotune] FIX8 plans equal with autotune on and off in every "
          f"bucket; batch-8 logits: {n} of {got_t.numel()} differ")
    if n:
        raise AssertionError("FIX8 logits differ with autotune on and off")
    del qmodel
    return tuned, qtuned


def epilogues_phase(qengine, params, x8):
    """``[epilogues]``: FIX8 B1@224 served with ``epilogues=False`` (each
    int8 consumer quantizes its own input) beside the served engine's
    producer-side emission: plan launches, the wrappers' launches per
    forward (the captures), the device time per replay A/B in one process,
    and the logits against the int8 reference forward (top-1 equal,
    within 0.1 * max|logit|).  Returns the opt-out's (replay, eager)
    forwards for ``kernel_profile``."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import launch_counts
    from repro_torch.core.program import execute, lower
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    off = VisionEngine.quantized(params, B1, VisionServeConfig(
        microbatch=8, buckets=(8,), epilogues=False))
    ex_off, ex_on = off.cache.get(8, 224), qengine.cache.get(8, 224)
    if ex_off.key.epilogues or not ex_on.key.epilogues:
        raise AssertionError("the executor keys do not carry epilogues")
    if ex_off.plan.epilogues or any(
            d.q_in or d.epilogue is not None
            for d in ex_off.plan.decisions.values()):
        raise AssertionError("epilogues=False planned an epilogue")
    for tag, ex in (("on", ex_on), ("off", ex_off)):
        emits = sum(1 for d in ex.plan.decisions.values()
                    if d.epilogue is not None)
        print(f"[epilogues] {tag}: {launch_counts(ex.plan)['fused']} plan "
              f"launches, {emits} producer epilogues, "
              f"{sum(d.q_in for d in ex.plan.decisions.values())} int8 "
              f"boundaries; wrapper launches per forward "
              f"{ex.replay_launches}")
    if launch_counts(ex_off.plan)["fused"] != 26:
        raise AssertionError("epilogues=False moved the plan's launches")
    if any("emit" in k for k in ex_off.replay_launches):
        raise AssertionError(f"epilogues=False launched an emitting "
                             f"kernel: {ex_off.replay_launches}")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=8), off.params, x8)
    got_off = off.logits(x8)
    check_logits(got_off, ref, "epilogues off", fix8=True)
    check_logits(qengine.logits(x8), ref, "epilogues on", fix8=True)
    replay_ab({"on": lambda: ex_on(qengine.params, x8),
               "off": lambda: ex_off(off.params, x8)}, "epilogues")

    def eager():
        with torch.inference_mode():
            return execute(ex_off.program, off.params, x8, plan=ex_off.plan)
    return (lambda: ex_off(off.params, x8)), eager


def overrides_phase(params, x8) -> None:
    """``[overrides]``, fp32 B1@224, one bucket of 8: a ``group_break``
    on ``S2.mb1`` splits S2.ss0 where JAX's planner splits it (S2.mb0
    alone, S2.ss0 = S2.mb1..mb2: 20 plan launches, 10 ``mbconv_fused`` a
    replay), and ``fused=False`` pins ``S3.evit1.mb`` to the reference
    path (reason ``"search"``: 21 plan launches, its 3 plain ones counted;
    8 ``mbconv_fused`` a replay).  Each is served from its captured graph
    and held to the fp32 gates of the reference forward."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import SiteOverride, launch_counts
    from repro_torch.core.program import execute, lower
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    with torch.inference_mode():
        ref = execute(lower(B1, batch=8), params, x8)
    cases = (
        ("group_break S2.mb1", {"S2.mb1": SiteOverride(group_break=True)},
         {"S1.ss0": ("S1.mb0", "S1.mb1"), "S2.ss0": ("S2.mb1", "S2.mb2")},
         20, 10, None),
        ("fused=False S3.evit1.mb",
         {"S3.evit1.mb": SiteOverride(fused=False)}, GROUPS, 21, 8,
         "S3.evit1.mb"))
    for label, ov, groups, launches, mbconvs, pinned in cases:
        eng = VisionEngine(params, B1, VisionServeConfig(
            microbatch=8, buckets=(8,)), overrides=ov)
        ex = eng.cache.get(8, 224)
        got = {g.name: tuple(g.members) for g in ex.plan.groups.values()}
        n = launch_counts(ex.plan)["fused"]
        print(f"[overrides] {label}: groups {got}; {n} plan launches; "
              f"wrapper launches per replay {ex.replay_launches}")
        if got != groups or n != launches or ex.graph is None or \
                ex.replay_launches.get("mbconv_fused") != mbconvs:
            raise AssertionError(f"{label}: groups {got}, {n} launches, "
                                 f"{ex.replay_launches}")
        if pinned is not None:
            d = ex.plan.decisions[pinned]
            if d.fused or d.reason != "search":
                raise AssertionError(f"{label}: {d}")
        check_logits(eng.logits(x8), ref, f"overrides {label}")
        check_healthy(eng, "overrides")


def autotune_fault_phase(params, images) -> None:
    """``[autotune fault]``, fp32 B1@224, buckets (1, 8), on a fresh
    cache file: the engine is made (bucket 8 swept and captured), then a
    ``FaultPlan`` with ``FaultSpec("autotune", times=1)`` is installed and
    one request arrives: bucket 1's cold build fires the fault at its
    first consultation (stem.ds0), the scheduler retries, the negative
    cache answers the retry, the ladder demotes stem.ds0 (level 1), and
    the key is planned (sweeping its cold shapes), captured anew and
    served within the fp32 gates of the reference forward."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import execute, lower
    from repro_torch.kernels import autotune
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import ManualClock, Request
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    main_cache = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    fresh_cache("fault")
    faults = FaultPlan(FaultSpec("autotune", times=1))
    eng = VisionEngine(params, B1, VisionServeConfig(
        microbatch=8, buckets=(1, 8)), faults=faults)
    n0 = autotune.SWEEP_COUNT
    clock = ManualClock()
    sched = eng.scheduler(clock=clock, backoff_ms=0.0)
    req = Request(0, images[0])
    with faults:
        sched.submit(req)
        rounds = 0
        while sched.outstanding():
            sched.step(drain=True)
            sched.finalize()
            rounds += 1
            if rounds > 8:
                raise AssertionError("autotune fault: not drained")
    state = eng.cache.degradation(1, 224)
    ex = eng.cache.get(1, 224)
    print(f"[autotune fault] fired {faults.fired}; request {req.status} "
          f"after {req.retries} failed attempts; ladder {state}; stem.ds0 "
          f"{ex.plan.decisions['stem.ds0'].reason}; {autotune.SWEEP_COUNT - n0} "
          f"sweeps in the rebuild; new graph, launches per replay "
          f"{ex.replay_launches}; counters "
          f"{ {k: v for k, v in eng.telemetry.counters.items() if k in ('degraded', 'negative_cache_hit', 'executor_build_failed', 'retries')} }")
    if req.status != "completed" or faults.fired != {"autotune": 1}:
        raise AssertionError(f"autotune fault: {req.status}, "
                             f"{faults.fired}, {req.error}")
    if state is None or state.level != 1 or state.demoted != {"stem.ds0"}:
        raise AssertionError(f"autotune fault: ladder {state}")
    if ex.graph is None or ex.plan.decisions["stem.ds0"].reason != "fault":
        raise AssertionError("autotune fault: the key was not rebuilt")
    if "dsconv_fused" in ex.replay_launches:
        raise AssertionError("the demoted stem.ds0 still launches")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=1), eng.params,
                      torch.from_numpy(images[:1]).cuda())
    check_logits(torch.from_numpy(req.logits[None]), ref, "autotune fault")
    use_cache(main_cache)


def fit_report(plan, tag) -> None:
    """The plan: fused sites, groups with their blocks, the sites the
    Hopper fit declined (with the reason), and the runs of fused conv
    sites of one stage left ungrouped (no band of the chain fits one
    CTA)."""
    from repro_torch.core.fusion import launch_counts
    ds = list(plan.decisions.values())
    declined = [(d.name, d.reason) for d in ds if not d.fused]
    runs, run = [], []
    for d in ds + [None]:
        if d is not None and d.fused and not d.group and \
                d.kind in ("mbconv", "dsconv") and (
                    not run or run[-1].split(".")[0] == d.name.split(".")[0]):
            run.append(d.name)
            continue
        if len(run) > 1:
            runs.append(run)
        run = [d.name] if (d is not None and d.fused and not d.group
                           and d.kind in ("mbconv", "dsconv")) else []
    print(f"[{tag}] plan: {plan.n_fused()} of {len(ds)} sites fused, "
          f"{launch_counts(plan)['fused']} launches; groups "
          + "; ".join(f"{g.name} {'+'.join(m.split('.', 1)[1] for m in g.members)} "
                      f"{fmt_blocks(g.blocks)}" for g in plan.groups.values())
          + f"; declined by the Hopper fit or a policy {declined or 'none'}"
          + f"; consecutive fused conv sites left ungrouped (no band fits) "
          + (", ".join("+".join(r) for r in runs) or "none"))


def model_phase(cfg, seed, tag, wrappers):
    """``[B2]`` / ``[B3]``: ``cfg`` at 224 px, published widths and
    depths, random weights and BN statistics from ``seed``, fp32 then
    FIX8, each served by a ``VisionEngine`` over buckets (1, 8) with
    ``autotune=True`` on the current cache (a cold build sweeps).

    Per precision: the counters set to 0 just before the engine is made
    and warmed, read just after (less the sweeps' launches): each key's
    warm-up run and capture, twice the captures' launches; the plan, its
    declines and its groups; the blocks tuned off the model's pick; the
    logits of 8 images against the port's reference forward (fp32 within
    1e-3, FIX8 within 0.1 * max|logit| of the int8 reference, top-1
    equal), replay = eager bit for bit at batch 1 and 8, FIX8 batch
    invariance; the steady state (images/s, device and host time per
    replay, card idle).  Then every served kernel shape, batch 1 and 8,
    against its plain version (``check_kernels``).  Returns the (replay,
    eager) forwards per precision for ``kernel_profile``."""
    import numpy as np
    import torch
    from repro_torch.core.efficientvit import init_efficientvit
    from repro_torch.core.program import execute, lower
    from repro_torch.core.quantization import quantize_efficientvit
    from repro_torch.kernels import autotune
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    gen = torch.Generator().manual_seed(seed)
    params = init_efficientvit(gen, cfg, "cuda")
    randomize_bn(params, gen)
    qparams = quantize_efficientvit(params)
    rng = np.random.default_rng(seed)
    x8 = torch.from_numpy(rng.standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).cuda()
    scfg = VisionServeConfig(microbatch=8, buckets=(1, 8))
    fwds, plans, max_err = {}, {}, {k: 0.0 for k in wrappers}
    for prec in ("fp32", "fix8"):
        ptag = f"{tag} {prec}"
        for w in wrappers.values():
            w.launches = 0
        autotune.SWEEP_LAUNCHES.clear()
        n0, log0, t0 = autotune.SWEEP_COUNT, len(autotune.SWEEP_LOG), \
            time.perf_counter()
        eng = (VisionEngine(params, cfg, scfg) if prec == "fp32" else
               VisionEngine.quantized(params, cfg, scfg)).warmup()
        build_s = time.perf_counter() - t0
        launches = {k: w.launches - autotune.SWEEP_LAUNCHES.get(k, 0)
                    for k, w in wrappers.items()}
        keys = eng.cache.keys()
        want = {k: 2 * sum(eng.cache.get(key.batch, 224).replay_launches
                           .get(k, 0) for key in keys) for k in wrappers}
        swept = sum(e["seconds"] for e in autotune.SWEEP_LOG[log0:])
        print(f"[{ptag}] counters at 0, engine made and warmed in "
              f"{build_s:.2f} s ({autotune.SWEEP_COUNT - n0} sweeps, "
              f"{swept:.2f} s); launches less the sweeps' "
              f"{ {k: v for k, v in launches.items() if v} }")
        if launches != want or not any(launches.values()):
            raise AssertionError(f"{ptag}: launches {launches}, expected "
                                 f"twice the captures' {want}")
        print_sweeps(ptag, log0)
        for key in keys:
            ex = eng.cache.get(key.batch, 224)
            fit_report(ex.plan, f"{ptag} bucket {key.batch}")
            print(f"[{ptag}] graph bucket {key.batch}: launches per replay "
                  f"{ex.replay_launches}; graph pool grew "
                  + ("not measured" if ex.graph_bytes is None
                     else f"{ex.graph_bytes / 2**20:.1f} MiB"))
        blocks_vs_model(eng, ptag)
        with torch.inference_mode():
            ref = execute(lower(cfg, batch=8), eng.params, x8)
        got = eng.logits(x8)
        noise = None
        if prec == "fix8":
            ex = eng.cache.get(8, 224)
            site_walk(ex.program, eng.params, x8, ex.plan, ptag)
            noise = reference_noise(cfg, eng.params, x8, ref, ptag)
        check_logits(got, ref, ptag, fix8=prec == "fix8", noise=noise)
        if prec == "fix8":
            ones = torch.cat([eng.logits(x8[i:i + 1]) for i in range(8)])
            if not torch.equal(got, ones):
                raise AssertionError(f"{ptag}: batch invariance")
            print(f"[{ptag}] batch invariance: the 8 rows of a batch-8 "
                  f"forward equal the 8 batch-1 forwards bit for bit")
        for b in (1, 8):
            ex = eng.cache.get(b, 224)
            rep = ex(eng.params, x8[:b])
            with torch.inference_mode():
                eag = execute(ex.program, eng.params, x8[:b], plan=ex.plan)
            torch.cuda.synchronize()
            n = int((rep != eag).sum())
            print(f"[graph] {ptag} batch {b}: replay vs eager, {n} of "
                  f"{rep.numel()} logits differ")
            if n:
                raise AssertionError(f"{ptag}: replay differs from eager")
        fwds[prec] = steady_state(eng, rng, ptag)
        check_healthy(eng, ptag)
        plans[prec] = {b: eng.cache.get(b, 224).plan for b in (1, 8)}
    # every served kernel shape against its plain version
    per_fwd = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_s": 0.0, "ops_s": 0.0} for k in wrappers}
    for b in (1, 8):
        fp_plan, q_plan = plans["fp32"][b], plans["fix8"][b]
        fp_chains, q_chains = chain_cases(b, gen, params, qparams, cfg,
                                          (fp_plan, q_plan))
        check_kernels(kernel_cases(b, gen, cfg, fp_plan) + fp_chains, b,
                      per_fwd, max_err, exact=False, tag=tag)
        check_kernels(int8_kernel_cases(b, gen, cfg, q_plan) + q_chains, b,
                      per_fwd, max_err, exact=True, tag=tag)
    print(f"[{tag}] every served kernel shape held against its plain "
          f"version at batch 1 and 8; per batch-8 forward (ms, by CUDA "
          f"events): " + "; ".join(
              f"{k} {v['ms']:.4f} (bound {v['bound_ms']:.4f}, plain "
              f"{v['plain_ms']:.4f})" for k, v in per_fwd.items() if v["ms"]))
    return fwds


def port_kernel_names(csrc: str | None = None) -> set:
    """The ``__global__`` functions of the port's CUDA sources (``csrc``,
    by default this tree's)."""
    import glob
    import re
    names = set()
    csrc = csrc or os.path.join(SRC, "repro_torch", "csrc")
    for f in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(f) as fh:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)", fh.read()))
    return names


# host sleep between and around ``kernel_profile``'s forwards: half of it
# is far above the host / device clock offset of a capture late in a run
PROFILE_PAD_S = 0.1


@contextlib.contextmanager
def profiled(host: bool = True):
    """A ``torch.profiler`` capture of the device (and the host) whose
    window opens after one warm-up step: the tracer is enabled in the
    warm-up, so the window loses no device activity at its start (late
    in a run, a capture opened without one missed its first launches: a
    served batch's copy-in, the first of a list of calls).  The step's
    own ranges are named ``ProfilerStep#``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        yield prof


def is_range(name: str) -> bool:
    """A ``record_function`` range of this script or of ``profiled``'s
    step, which shows on the device side too."""
    return name.startswith(("chip_smoke.", "ProfilerStep#"))


def device_us(event) -> float:
    """A profiler row's device time in µs (the attribute's name differs
    across torch versions)."""
    us = getattr(event, "device_time_total", None)
    return event.cuda_time_total if us is None else us


def count_imma() -> None:
    """The int8 tensor-core instructions (IMMA) in the SASS of the four
    libraries whose GEMMs run on ``int8_mma.cuh``; none is a failure, and
    so is a ``__dp4a`` (IDP) in ``int8_matmul``'s, whose two GEMMs run on
    tensor cores only."""
    import shutil
    from repro_torch.kernels.build import library_path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in ("mbconv_int8", "supersite_int8", "int8_matmul",
                 "group_agg"):
        sass = subprocess.run([tool, "-sass", str(library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        n = sum("IMMA" in line for line in sass.splitlines())
        dp4a = sum("IDP" in line for line in sass.splitlines())
        print(f"[build] {name}: {n} IMMA instructions (int8 tensor cores) "
              f"and {dp4a} IDP (__dp4a) in its SASS")
        if not n:
            raise AssertionError(f"{name}: no IMMA instruction in its SASS")
        if name == "int8_matmul" and dp4a:
            raise AssertionError(f"{name}: {dp4a} IDP instructions in its "
                                 f"SASS")


def one_launch_each(calls) -> None:
    """Each call of ``calls`` ((fn, outputs, kernel, label), every fn
    warmed up first) is one CUDA launch of its ``kernel``, with no memset
    and no zero fill, and allocates only its ``outputs``: one
    ``torch.profiler`` capture over all the calls (a capture per call lost
    the device activity of the later ones) must count exactly one launch
    per call, by kernel name and nothing else; the caching allocator's
    allocation count is read around each call."""
    import collections

    import torch

    for fn, *_ in calls:
        fn()
    torch.cuda.synchronize()
    allocs = []
    with profiled(host=False) as prof:
        for fn, *_ in calls:
            n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
            fn()
            torch.cuda.synchronize()
            allocs.append(torch.cuda.memory_stats()[
                "allocation.all.allocated"] - n0)
    rows = {e.key: e.count for e in prof.key_averages()
            if device_us(e) > 0 and not is_range(e.key)}
    want = collections.Counter(kernel for _, _, kernel, _ in calls)
    got = collections.Counter()
    for key, count in rows.items():
        got[next((k for k in want if k in key), key)] += count
    for (_, outputs, kernel, label), n in zip(calls, allocs):
        print(f"[one launch] {label}: {n} allocations (its outputs: "
              f"{outputs})")
        if n != outputs:
            raise AssertionError(f"{label}: {n} allocations, expected "
                                 f"only its {outputs} outputs")
    print(f"[one launch] one launch per call: {len(calls)} calls, device "
          f"activity {sorted(rows.items())}")
    if got != want:
        raise AssertionError(f"device activity {dict(got)}, expected one "
                             f"launch per call: {dict(want)}")


def one_launch_per_site(gen) -> None:
    """Each served FIX8 MBConv shape of B1@224 at batch 8 (S3 and S4's
    evit blocks, S3.down and S4.down emitting), each MSA projection GEMM
    and the library's emitting GEMM at each (keep-fp off and on, a static
    scale), each aggregation branch, the FIX8 DSConv at stem.ds0, the attention
    core at S3 and S4 (written into the projection's map, as the MSA
    serves it), the fp32 DSConv at stem.ds0 and the library's emitting
    FIX8 DSConv at stem.ds0 with and without keep-fp: one call of its
    wrapper is one CUDA launch (the cluster kernels, the tensor-core GEMM,
    the attention kernel, the fp32 band kernel), with no memset and no
    zero fill, allocating only its outputs (the attention none)."""
    import torch
    from repro_torch.kernels.dsconv.kernel import (
        dsconv_fused, dsconv_fused_int8, dsconv_fused_int8_emit)
    from repro_torch.kernels.group_conv.kernel import group_agg_int8
    from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
    from repro_torch.kernels.int8_matmul.kernel import (
        int8_matmul, int8_matmul_emit)
    from repro_torch.kernels.mbconv.kernel import (
        mbconv_fused_int8, mbconv_fused_int8_emit)

    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
    calls = []
    for name, (H, C, M, F, st) in (("S3", (14, 128, 512, 128, 1)),
                                   ("S4", (7, 256, 1024, 256, 1)),
                                   ("S3.down", (28, 64, 256, 128, 2)),
                                   ("S4.down", (14, 128, 512, 256, 2))):
        fn = mbconv_fused_int8_emit if st == 2 else mbconv_fused_int8
        args = (i8(8, H, H, C), sc(8), i8(C, M), sc(M) * 0.2, rn(M),
                i8(3, 3, M), sc(M), rn(M), i8(M, F), sc(F), rn(F))
        calls.append((lambda f=fn, a=args, st=st: f(*a, stride=st),
                      3 if st == 2 else 1,
                      f"mbi8_cluster<{'true' if st == 2 else 'false'}>",
                      f"{fn.__name__} {name} B=8"))
    for name, rows, K, N in MSA_GEMMS:
        args = (i8(8 * rows, K), i8(K, N), sc(8 * rows), sc(N))
        calls.append((lambda a=args: int8_matmul(*a), 1, "int8_mma_gemm",
                      f"int8_matmul {name} B=8"))
        # the library's emitting GEMM: per-image scales, keep-fp off and
        # on, and one static scale (a broadcast scalar)
        for xs, keep in ((sc(8), False), (sc(8), True), (sc(1)[0], True)):
            eargs = (i8(8 * rows, K), i8(K, N), xs, sc(N))
            calls.append((lambda a=eargs, k=keep, r=rows, b=rn(N):
                          int8_matmul_emit(*a, rows_per_group=r, bias=b,
                                           keep_fp=k),
                          3 if keep else 2, "int8_emit_gemm<true>",
                f"int8_matmul_emit {name} B=8 keep_fp={keep} "
                f"x_scale={'static' if xs.dim() == 0 else 'per-image'}"))
    for name, H, C in AGG_MAPS:
        args = (i8(8, H, H, C), sc(8), i8(5, 5, C), sc(C), rn(C), i8(16, C),
                sc(C), rn(C))
        calls.append((lambda a=args: group_agg_int8(*a), 1,
                      "group_agg_cluster<5>", f"group_agg_int8 {name} B=8"))
    args = (i8(8, 112, 112, 16), sc(8), i8(3, 3, 16), sc(16), rn(16),
            i8(16, 16), sc(16), rn(16))
    calls.append((lambda a=args: dsconv_fused_int8(*a), 1,
                  "dsconv_i8_cluster<false>",
                  "dsconv_fused_int8 stem.ds0 B=8"))
    for keep in (False, True):
        calls.append((lambda a=args, k=keep: dsconv_fused_int8_emit(
            *a, keep_fp=k), 3 if keep else 2, "dsconv_i8_cluster<true>",
            f"dsconv_fused_int8_emit stem.ds0 B=8 keep_fp={keep}"))
    fargs = (rn(8, 112, 112, 16), rn(3, 3, 16), rn(16), rn(16, 16) * 0.25,
             rn(16))
    calls.append((lambda a=fargs: dsconv_fused(*a), 1, "dsconv_band",
                  "dsconv_fused stem.ds0 B=8"))
    for name, H, heads, S in ATTN_SITES:
        _, qkv, _, view = attn_inputs(gen, 8, H, heads, S)
        calls.append((lambda a=qkv, o=view: relu_attn_noncausal(*a, out=o),
                      0, "relu_attn_kernel",
                      f"relu_attn_noncausal {name} B=8 out="))
    one_launch_each(calls)


def kernel_profile(fwd, eager, tag, n: int = 2,
                   csrc: str | None = None) -> list:
    """One ``torch.profiler`` capture: ``n`` replays of the batch-8
    forward, then one eager forward of the same (program, plan), each in
    a range of its own and followed by a synchronize and
    ``PROFILE_PAD_S`` of host sleep (one more before the first).  The
    capture's device times run off its host times by an offset that
    grows as the process ages (milliseconds late in a run), and the
    capture drops device events that fall outside its window: the pads
    keep the forwards off the window's ends, and a kernel belongs to the
    last range whose host start, less half a pad, is before it.  Kernel
    time and launches per replay by kernel name (the sum is the device's
    busy time; the gaps between kernels are not in it); the port's own
    kernels' launches (the kernels of ``csrc``, by default this tree's
    sources), the memsets and the zero fills counted apart.  The port's
    kernels in each replay must be those of the eager forward, by name
    and count: the graph launches what the wrappers launched.  -> each
    range's first kernel's start less the range's host start, in µs."""
    import collections
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    fwd()
    eager()
    torch.cuda.synchronize()
    ranges = [f"chip_smoke.replay.{i}" for i in range(n)] + [
        "chip_smoke.eager"]
    with profiled() as prof:
        time.sleep(PROFILE_PAD_S)
        for name in ranges:
            with record_function(name):
                (eager if name == "chip_smoke.eager" else fwd)()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    events = prof.events()
    host = [min(e.time_range.start for e in events
                if e.name == name and e.device_type == DeviceType.CPU)
            for name in ranges]
    bounds = [h - PROFILE_PAD_S * 5e5 for h in host[1:]]
    ours = port_kernel_names(csrc)
    # windows: 0..n - 1 the replays, n eager
    by_name = [collections.defaultdict(lambda: [0.0, 0])
               for _ in range(n + 1)]
    first = [math.inf] * (n + 1)
    for e in events:
        if e.device_type != DeviceType.CUDA or is_range(e.name):
            continue
        t = e.time_range
        w = bisect.bisect_right(bounds, t.start)
        first[w] = min(first[w], t.start)
        row = by_name[w][e.name]
        row[0] += t.elapsed_us() / 1e3
        row[1] += 1
    replays = collections.defaultdict(lambda: [0.0, 0])
    for window in by_name[:n]:
        for name, (ms, cnt) in window.items():
            replays[name][0] += ms
            replays[name][1] += cnt
    rows = sorted(((ms / n, cnt / n, name)
                   for name, (ms, cnt) in replays.items()), reverse=True)
    kname = lambda name: re.match(r"(?:void\s+)?(\w+)", name).group(1)
    port = [r for r in rows if kname(r[2]) in ours]
    memsets = sum(r[1] for r in rows if "Memset" in r[2])
    fills = sum(r[1] for r in rows if "FillFunctor" in r[2])
    top = "; ".join(f"{name[:48]} {ms:.3f} ms x{cnt:g}"
                    for ms, cnt, name in rows[:8])
    print(f"[{tag}] profiler, one batch-8 replay: "
          f"{sum(r[1] for r in rows):g} kernel launches, "
          f"{sum(r[0] for r in rows):.3f} ms of kernel time; top: {top}")
    print(f"[{tag}] profiler, one batch-8 replay: the port's kernels "
          f"{sum(r[1] for r in port):g} CUDA launches, "
          f"{sum(r[0] for r in port):.3f} ms; memsets {memsets:g}; zero "
          f"fills {fills:g}; by kernel: " + "; ".join(
              f"{name[:40]} {ms:.4f} ms x{cnt:g}" for ms, cnt, name in port))
    def count(window):
        out = collections.Counter()
        for name, (_, c) in window.items():
            if kname(name) in ours:
                out[kname(name)] += c
        return out
    *replayed, eager_port = [count(w) for w in by_name]
    offset = [f - h for f, h in zip(first, host)]
    print(f"[{tag}] profiler, the eager forward: "
          f"{sum(c for _, c in by_name[n].values()):g} kernel launches; the "
          f"port's kernels in each of the {n} replays equal the eager "
          f"forward's: {all(r == eager_port for r in replayed)} "
          f"({sum(eager_port.values()):g} CUDA launches); each range's "
          f"first kernel starts {', '.join(f'{x:.1f}' for x in offset)} us "
          f"after its host start")
    if not eager_port or any(r != eager_port for r in replayed):
        raise AssertionError(f"[{tag}] port kernels per replay "
                             f"{[dict(r) for r in replayed]}, eager "
                             f"{dict(eager_port)}")
    return offset


def logits_gate(got, ref, tag, fix8: bool) -> None:
    """The sharded gates against the unsharded engine: FIX8 bit-equal;
    fp32 within 1e-5 * max(1, max|logit|), top-1 equal."""
    import numpy as np
    got, ref = np.asarray(got), np.asarray(ref)
    d, top = np.abs(got - ref).max(), np.abs(ref).max()
    same = np.array_equal(got.argmax(-1), ref.argmax(-1))
    print(f"[{tag}] logits vs the unsharded engine: max|d| {d:.3e} (max|ref| "
          f"{top:.3e}), {'bit-equal' if np.array_equal(got, ref) else 'not bit-equal'}"
          f", top-1 {'equal' if same else 'DIFFERENT'}")
    if not np.all(np.isfinite(got)) or not same:
        raise AssertionError(f"{tag}: non-finite logits or top-1 differs")
    if fix8 and not np.array_equal(got, ref):
        raise AssertionError(f"{tag}: FIX8 logits not bit-equal ({d:.3e})")
    if not fix8 and not d <= 1e-5 * max(1.0, top):
        raise AssertionError(f"{tag}: fp32 logits {d:.3e} above 1e-5 * "
                             f"max(1, {top:.3e})")


def images_per_s(logits, batch64, reps: int = 3) -> float:
    """64 images as 8 buckets of 8 through ``logits``, host clock to a
    synchronize; the median of ``reps`` runs after a warm one."""
    import torch
    logits(batch64)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        logits(batch64)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return 64 / statistics.median(runs)


def served_images_per_s(engine, images, tracer, reps: int = 3) -> float:
    """64 requests through a scheduler of ``engine`` (``tracer`` or
    none), submitted, stepped and finalized; the median of ``reps`` runs
    after a warm one."""
    from repro_torch.serving.scheduler import Request
    runs = []
    for rep in range(reps + 1):
        sched = engine.scheduler(tracer=tracer)
        reqs = [Request(1000 * rep + i, images[i % len(images)])
                for i in range(64)]
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
            sched.step()
        sched.step(drain=True)
        sched.finalize()
        if rep:
            runs.append(time.perf_counter() - t0)
        if any(r.status != "completed" for r in reqs):
            raise AssertionError([(r.rid, r.status) for r in reqs
                                  if r.status != "completed"])
    return 64 / statistics.median(runs)


def drain(sched, clock, rounds: int = 16) -> None:
    for _ in range(rounds):
        if not sched.outstanding():
            return
        sched.step(drain=True)
        sched.finalize()
        clock.advance(0.05)
    raise AssertionError(f"{sched.outstanding()} requests never ended")


def member_kernels(engine, res, gen, per_fwd, max_err, tag,
                   fix8: bool) -> None:
    """2a / 3a at a sharded key's local batch: every kernel case and
    super-site chain of the plan bucket 8's members serve (planned and
    tuned at the local batch), held against its plain version on the
    served tree with the same tolerances (FIX8 bit-exact, fp32 ``TOL``)
    and timed; the launches here are not the path's."""
    from repro_torch.core.efficientvit import B1
    ex = engine.cache.get(8, res)
    lb, plan = ex.shard.local_batch, ex.plan
    cases = (int8_kernel_cases if fix8 else kernel_cases)(lb, gen, B1, plan)
    chains = chain_cases(lb, gen, engine.params, engine.params, B1, (plan,))
    check_kernels(cases + chains[1 if fix8 else 0], lb, per_fwd, max_err,
                  exact=fix8, tag=f"{tag} member kernels")


def sharded_phase(make, ref_engine, images, wrappers, expected, tag, mesh,
                  fix8: bool, gen, per_fwd, max_err) -> dict:
    """``[sharded]``: the mesh ``mesh`` (fault domains; four on one card)
    at B1@224, microbatch 8.  Every launch counter is set to 0 just
    before the sharded engine is made (``make(serve_cfg, faults)``) and
    warmed and 8 requests served through its scheduler, and read just
    after: each member's capture issued the launches of one forward at
    its local batch, and the wrappers launched twice that per member
    (warm-up run, capture).  The served logits against the unsharded
    ``ref_engine``'s (``logits_gate``).  Then ``device_dropout``: domain
    3 lost at dispatch, the mesh 4 -> 3, bucket 8 recaptured 2-wide at
    local batch 4, every request completed with ``device_lost`` = 1,
    ``mesh_shrunk`` = 1 and no ladder move, the same gates; and
    ``mesh_loss``: the other three lost one per dispatch, the in-flight
    requests and a late one failed ``MeshExhausted``, nothing
    outstanding.  After the served run and after the dropout, the
    kernels of bucket 8's member plan (local batch 2, then 4) against
    their plain versions (``member_kernels``).  Returns the path's
    launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import ManualClock, Request
    from repro_torch.serving.vision import VisionServeConfig

    for w in wrappers.values():
        w.launches = 0
    autotune.SWEEP_LAUNCHES.clear()
    faults = FaultPlan()                 # idle until the drills below
    t0 = time.perf_counter()
    engine = make(VisionServeConfig(microbatch=8, devices=mesh), faults)
    engine.warmup()
    build_s = time.perf_counter() - t0
    sched = engine.scheduler()
    reqs = [Request(i, images[i]) for i in range(8)]
    got = sched.serve(reqs)
    swept = dict(autotune.SWEEP_LAUNCHES)
    launches = {k: w.launches - swept.get(k, 0)
                for k, w in wrappers.items()}
    want = {k: v for k, v in expected.items() if v}
    members = 0
    for key in engine.cache.keys():
        ex = engine.cache.get(key.batch, key.resolution)
        if None in ex.graphs or ex.member_launches != \
                [want] * ex.shard.n_devices:
            raise AssertionError(f"{tag} bucket {key.batch}: member "
                                 f"captures {ex.member_launches}, expected "
                                 f"{want} each")
        members += ex.shard.n_devices
        print(f"[{tag}] bucket {key.batch}: {ex.shard.n_devices} members "
              f"(domains {ex.device_ids}) at local batch "
              f"{ex.shard.local_batch}, one graph each, "
              f"{len({m.stream for m in ex.members})} streams, "
              f"{len({m.pool for m in ex.members})} pool; launches per "
              f"member replay {ex.member_launches[0]}")
    for name, per in expected.items():
        if launches[name] != 2 * per * members:
            raise AssertionError(f"{tag} {name}: {launches[name]} launches "
                                 f"for {members} members, expected {per} "
                                 f"per forward, warm-up run and capture")
    print(f"[{tag}] main path: counters at 0, the sharded engine made and "
          f"warmed ({len(engine.cache.keys())} keys, {members} member "
          f"graphs, {build_s:.2f} s) and 8 requests served: launches "
          f"{launches} (sweeps' launches, not counted: {swept})")
    ref = ref_engine.logits(torch.from_numpy(images[:8]).cuda())
    logits_gate(got, ref.cpu().numpy(), tag, fix8)
    x64 = torch.from_numpy(np.concatenate([images] * 6)[:64]).cuda()
    sharded = images_per_s(engine.logits, x64)
    single = images_per_s(ref_engine.logits, x64)
    print(f"[{tag}] steady state, 64 images in 8 buckets of 8: sharded "
          f"over {len(mesh)} domains {sharded:.1f} images/s, unsharded "
          f"{single:.1f} images/s (informational)")
    c = engine.telemetry.counters
    rows = {d: (s.dispatches, s.samples, s.padded)
            for d, s in sorted(engine.telemetry.devices.items())}
    print(f"[{tag}] per-domain rows (dispatches, samples, padded): {rows}")
    res = images.shape[1]
    member_kernels(engine, res, gen, per_fwd, max_err, tag, fix8)

    # device_dropout: domain 3 lost at the next dispatch
    faults.specs.append(FaultSpec("device.dropout", times=1, device=3))
    clock = ManualClock()
    sched = engine.scheduler(clock=clock, backoff_ms=0.0)
    reqs = [Request(100 + i, images[i]) for i in range(8)]
    for r in reqs:
        sched.submit(r)
    drain(sched, clock)
    bad = [(r.rid, r.status, r.error) for r in reqs
           if r.status != "completed"]
    ex = engine.cache.get(8, res)
    moved = {k: c.get(k, 0) for k in ("degraded", "pinned_fp")}
    print(f"[{tag}] device_dropout: domains dead {engine.cache.health.dead_ids()}"
          f", bucket 8 now {ex.shard.n_devices}-wide (domains "
          f"{ex.device_ids}) at local batch {ex.shard.local_batch}; "
          f"device_lost={c.get('device_lost', 0)} mesh_shrunk="
          f"{c.get('mesh_shrunk', 0)} device_failover="
          f"{c.get('device_failover', 0)}; ladder {moved}; "
          f"{8 - len(bad)} of 8 completed")
    if bad or c.get("device_lost") != 1 or c.get("mesh_shrunk") != 1 \
            or any(moved.values()) or ex.device_ids != (0, 1) \
            or engine.cache.degradation(8, res) is not None:
        raise AssertionError(f"{tag} device_dropout: {bad}, {dict(c)}")
    logits_gate(np.stack([r.logits for r in reqs]), ref.cpu().numpy(),
                f"{tag} device_dropout", fix8)
    member_kernels(engine, res, gen, per_fwd, max_err,
                   f"{tag} device_dropout", fix8)

    # mesh_loss: the three survivors lost one per dispatch
    for d in (0, 1, 2):
        faults.specs.append(FaultSpec("device.dropout", times=1, device=d))
    reqs = [Request(200 + i, images[i]) for i in range(8)]
    for r in reqs:
        sched.submit(r)
    drain(sched, clock)
    late = Request(299, images[8])
    sched.submit(late)
    drain(sched, clock)
    ok = all(r.status == "failed" and type(r.error).__name__ ==
             "MeshExhausted" for r in reqs + [late])
    print(f"[{tag}] mesh_loss: domains dead {engine.cache.health.dead_ids()}"
          f", {sum(r.status == 'failed' for r in reqs)} of 8 in-flight and "
          f"the late request failed "
          f"{sorted({type(r.error).__name__ for r in reqs + [late]})}, "
          f"late retries {late.retries}, outstanding {sched.outstanding()}, "
          f"fault firings {faults.fired}")
    if not ok or sched.outstanding() or not engine.cache.mesh_exhausted \
            or late.retries > 1:
        raise AssertionError(f"{tag} mesh_loss: "
                             f"{[(r.status, r.error) for r in reqs + [late]]}")
    return launches


def trace_phase(engine, images, tag) -> None:
    """``[trace]``: the 12 mixed-deadline requests of ``serve_trace``
    through a scheduler with the engine's ``Tracer``: every request's
    chain complete (queue; dispatch, device, finalize), no span open after
    the drain, the exported file (a temporary directory) valid.  Then
    the tracer's own cost, measured directly: the host time inside its
    ``begin`` / ``end`` / ``event`` calls per request, over the 256
    requests of a served run with it; and the steady-state images/s of
    that run and of one without it (informational: the two differ by
    less than their run-to-run spread).  The garbage collector is paused
    for both runs."""
    import collections
    import tempfile
    from repro_torch.obs.trace import request_chains, validate_chrome_trace
    from repro_torch.serving.scheduler import Request

    tracer = engine.tracer
    sched = engine.scheduler()
    deadlines = [60_000.0, None, 0.0] + [60_000.0, None] * 4 + [None]
    reqs = [Request(i, images[i], deadline_ms=deadlines[i],
                    timeout_ms=600_000.0) for i in range(12)]
    for r in reqs:
        sched.submit(r)
        sched.step()
    sched.step(drain=True)
    sched.finalize()
    if any(r.status != "completed" for r in reqs):
        raise AssertionError([(r.rid, r.status, r.error) for r in reqs])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        doc = engine.export_trace(path)
        with open(path) as f:
            n = validate_chrome_trace(json.load(f))
    chains = request_chains(doc)
    broken = [rid for rid in range(12) if rid not in chains
              or not {"queue"} <= chains[rid]["children"]
              or not {"dispatch", "device", "finalize"}
              <= chains[rid]["member_of"]]
    names = dict(collections.Counter(e["name"] for e in doc["traceEvents"]
                                     if e["ph"] == "X"))
    print(f"[{tag}] trace: {n} spans ({names}), {len(chains)} request "
          f"chains, {len(broken)} incomplete, {len(tracer.open_spans())} "
          f"open after the drain, dropped {tracer.dropped}")
    if broken or tracer.open_spans():
        raise AssertionError(f"{tag} trace: incomplete chains {broken}, "
                             f"open {[s.name for s in tracer.open_spans()]}")
    spent, calls = [0.0], [0]

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t
                calls[0] += 1
        return call
    # the cyclic collector paused for both runs: a collection is charged
    # to whichever allocation sets it off, tracer call or not
    gc.collect()
    gc.disable()
    for name in ("begin", "end", "event"):     # span() calls begin / end
        setattr(tracer, name, timed(getattr(tracer, name)))
    try:
        on = served_images_per_s(engine, images, tracer)
    finally:
        for name in ("begin", "end", "event"):
            delattr(tracer, name)
    try:
        off = served_images_per_s(engine, images, None)
    finally:
        gc.enable()
    per_req = spent[0] / 256
    print(f"[{tag}] the tracer's host cost, the garbage collector paused: "
          f"{per_req * 1e6:.2f} us per request inside {calls[0] / 256:.1f} "
          f"tracer calls (256 served requests), {per_req * on:.3%} of the "
          f"served time per request with the tracer")
    print(f"[{tag}] steady state, 64 served requests, median of 3 runs "
          f"(informational): {on:.1f} images/s with the tracer, {off:.1f} "
          f"without")


def metrics_phase(engine, tag) -> None:
    """``[metrics]``: the engine's telemetry as Prometheus text (p99
    latency per bucket printed); the gate: the text's unlabelled counter
    samples parse back to the telemetry's counters."""
    from repro_torch.obs.metrics import _sanitize
    text = engine.metrics().prometheus_text()
    parsed, p99 = {}, []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        if "{" not in name and name.endswith("_total"):
            parsed[name[len("repro_"):-len("_total")]] = float(value)
        if name.startswith("repro_bucket_latency_ms{") \
                and 'quantile="0.99"' in name:
            p99.append(f"{name[len('repro_bucket_latency_ms'):]} "
                       f"{float(value):.3f} ms")
    want = {_sanitize(k): float(v)
            for k, v in engine.telemetry.counters.items()}
    print(f"[{tag}] metrics: {len(text.splitlines())} lines of Prometheus "
          f"text, {len(parsed)} counters parsed back; p99 latency per "
          f"bucket: " + "; ".join(p99))
    if parsed != want or not p99:
        raise AssertionError(f"{tag} metrics: parsed {parsed} != {want}")


class _SitesOnly:
    """A profiler that records nothing: ``execute(profile=)`` with it
    runs the per-site forward (groups off) with no events."""

    def begin(self, site) -> None:
        pass

    def end(self, site, out):
        return out


def drift_phase(engine, x8, tag) -> dict:
    """``[drift]``: ``profile_execute`` (CUDA events per site) and
    ``drift_report`` on the batch-8 plan the engine serves, grouping off.
    The gate: every program site recorded, every ratio finite.  Printed
    (informational): the per-site event sum beside one eager per-site
    forward timed by events, and the ten sites with the largest measured
    time beside their predicted cycles.  Returns the rows."""
    import torch
    from repro_torch.core.program import execute
    from repro_torch.obs.profile import drift_report, profile_execute

    ex = engine.cache.get(8, int(x8.shape[1]))
    prof = profile_execute(ex.program, engine.params, x8, plan=ex.plan,
                           repeats=5, warmup=1)
    rep = drift_report(ex.program, prof, plan=ex.plan)
    missing = {s.name for s in ex.program.sites} - set(prof.records)
    if missing or not rep.finite() or not prof.events:
        raise AssertionError(f"{tag} drift: missing {missing}, finite "
                             f"{rep.finite()}, events {prof.events}")

    def per_site():
        with torch.inference_mode():
            return execute(ex.program, engine.params, x8, plan=ex.plan,
                           profile=_SitesOnly())
    eager = device_ms(per_site, reps=1, windows=5)
    print(f"[{tag}] drift: {len(rep.rows)} sites, {prof.repeats} repeats "
          f"by CUDA events; the per-site sum {rep.measured_ms:.3f} ms "
          f"against one eager per-site forward {eager:.3f} ms by events; "
          f"the cycle model predicts {rep.predicted_ms:.3f} ms on the "
          f"paper's FPGA (aggregate ratio {rep.drift:.2f})")
    kinds = {}
    for r in rep.rows:
        m, p = kinds.get(r["kind"], (0.0, 0.0))
        kinds[r["kind"]] = (m + r["measured_ms"], p + r["predicted_ms"])
    print(f"[{tag}] drift by site kind, share of the measured sum / of the "
          f"predicted: " + "; ".join(
              f"{k} {m / rep.measured_ms:.1%} / {p / rep.predicted_ms:.1%}"
              for k, (m, p) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    top = sorted(rep.rows, key=lambda r: -r["measured_ms"])[:10]
    for r in top:
        print(f"[{tag}] drift site {r['site']} ({r['kind']}, "
              f"{'fused' if r['fused'] else 'ref'}/{r['precision']}): "
              f"{r['measured_ms']:.4f} ms measured, "
              f"{r['predicted_cycles']:.0f} cycles predicted "
              f"({r['predicted_ms']:.4f} ms at 200 MHz), ratio "
              f"{r['drift']:.3f}, {r['measured_ms'] / rep.measured_ms:.1%} "
              f"of the measured sum, {r['predicted_ms'] / rep.predicted_ms:.1%}"
              f" of the predicted")
    return rep.to_dict()


def obs_phases(params, images, wrappers, expected, tag, fix8: bool, gen,
               per_fwd, max_err):
    """Section 5a at one precision: an unsharded engine with a tracer
    serves ``[trace]`` and ``[metrics]`` and is the reference of
    ``[sharded]`` (whose member kernel checks go into ``max_err``);
    ``[drift]`` profiles its batch-8 plan.  Returns the sharded path's
    launches."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    def make(serve_cfg, faults=None, tracer=None):
        if fix8:
            return VisionEngine.quantized(params, B1, serve_cfg,
                                          faults=faults, tracer=tracer)
        return VisionEngine(params, B1, serve_cfg, faults=faults,
                            tracer=tracer)

    engine = make(VisionServeConfig(microbatch=8), tracer=Tracer())
    engine.warmup()
    trace_phase(engine, images, f"trace {tag}")
    metrics_phase(engine, f"metrics {tag}")
    n = torch.cuda.device_count()
    mesh = ("cuda:0",) * 4 + (tuple(f"cuda:{i}" for i in range(n))
                              if n > 1 else ())
    launches = sharded_phase(make, engine, images, wrappers, expected,
                             f"sharded {tag}", mesh, fix8, gen, per_fwd,
                             max_err)
    drift_phase(engine, torch.from_numpy(images[:8]).cuda(), f"drift {tag}")
    return launches


SEARCH_RES = (224, 256)       # the [search] trace's resolutions
SEARCH_BUCKETS = (1, 2, 4, 8)
SEARCH_DEADLINE_MS = 20.0


def search_trace(seed: int, n: int = 96, rate: float = 400.0):
    """``n`` requests, Poisson arrivals at ``rate`` requests/s, 75 % at
    224 px and 25 % at 256 px, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    res = np.where(rng.random(n) < 0.75, *SEARCH_RES)
    return [(float(a), int(r)) for a, r in zip(at, res)]


def replay_trace(engine, trace, images, deadline_ms):
    """Serve ``trace`` through the engine's scheduler on a ManualClock as
    ``search.workload`` models it: one step per arrival, the straggler
    step once the deadline has passed, then the drain.  Returns the
    requests."""
    from repro_torch.serving.scheduler import ManualClock, Request
    clock = ManualClock()
    sched = engine.scheduler(clock=clock)
    reqs = []
    for i, (at, res) in enumerate(trace):
        clock.advance_to(at)
        reqs.append(Request(i, images[res][i], deadline_ms=deadline_ms))
        sched.submit(reqs[-1])
        sched.step()
    clock.advance(deadline_ms / 1e3)
    sched.step()
    sched.step(drain=True)
    sched.finalize()
    drain(sched, clock)
    return reqs


def search_phase(params, seed, wrappers, expected, gen, max_err,
                 fix8: bool) -> dict:
    """``[search]`` at one precision, B1 at full width and depth: the
    trace (``search_trace``) saved and loaded back; the offline search on
    the host; two cold starts on fresh tuner caches over the artifact's
    (bucket, resolution) keys, the default engine (``autotune=True``) and
    the artifact's (``VisionServeConfig(artifact=path)``), which must run
    no sweep and build every plan as the artifact froze it; the trace
    served through the artifact engine's scheduler; every kernel case
    and chain of its smallest and largest bucket at both resolutions
    against its plain version; replay = eager at batch 8; the batch-8
    replay A/B against the tuned default plan; a JAX-style artifact
    refused.  The launch counters are set to 0 just before the artifact
    engine is made and read just after the trace is served (the path's
    launches, returned).  The run's tuner cache is in use again after."""
    import numpy as np
    import torch
    from repro_torch.common.errors import ArtifactError
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import execute, lower
    from repro_torch.core.quantization import quantize_efficientvit
    from repro_torch.kernels import autotune
    from repro_torch.search import (config_hash, load_trace, save_trace,
                                    search, trace_fingerprint, workload)
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    tag = f"search {'fix8' if fix8 else 'fp32'}"
    prec = "int8" if fix8 else "auto"
    main_cache = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    out_dir = os.path.join(ROOT, "build", "search")
    os.makedirs(out_dir, exist_ok=True)

    def make(serve_cfg):
        if fix8:
            return VisionEngine.quantized(params, B1, serve_cfg)
        return VisionEngine(params, B1, serve_cfg)

    # 1. the trace, through its file
    trace = search_trace(seed)
    tpath = os.path.join(out_dir, f"trace-{os.getpid()}.json")
    fp = save_trace(tpath, trace, spec={"n": len(trace), "rate": 400.0,
                                        "resolutions": SEARCH_RES})
    if load_trace(tpath) != trace or trace_fingerprint(load_trace(tpath)) \
            != fp:
        raise AssertionError(f"{tag}: the trace changed through its file")
    wl = workload(trace, SEARCH_BUCKETS, deadline_ms=SEARCH_DEADLINE_MS)
    print(f"[{tag}] trace: {len(trace)} requests over "
          f"{trace[-1][0] * 1e3:.1f} ms, {sum(r == 256 for _, r in trace)} "
          f"at 256 px, fingerprint {fp}; workload {sorted(wl.items())}")

    # 2. the search, on the host, with a tuner cache of its own
    tree = quantize_efficientvit(params) if fix8 else params
    fresh_cache(f"search-host-{prec}")
    t0 = time.perf_counter()
    art = search(B1, tree, trace, buckets=SEARCH_BUCKETS, precision=prec,
                 deadline_ms=SEARCH_DEADLINE_MS, seed=seed, iters=64)
    search_s = time.perf_counter() - t0
    apath = art.save(os.path.join(out_dir, f"{prec}-{os.getpid()}.json"))
    print(f"[{tag}] search: {search_s:.3f} s on the host, objective "
          f"{art.default_objective:.1f} -> {art.objective:.1f} cycles "
          f"({art.objective / art.default_objective:.4f}x); buckets "
          f"{list(art.buckets)}, demoted {list(art.demoted)}, split "
          f"{list(art.breaks)}; {len(art.entries)} keys, tuner entries "
          f"{len(art.tuner_cache)}")
    if not art.objective <= art.default_objective:
        raise AssertionError(f"{tag}: searched objective above the "
                             f"default one")
    keys = [(b, r) for r in art.resolutions for b in art.buckets]
    for b, r in ((min(art.buckets), 224), (max(art.buckets), 256)):
        print(f"[{tag}] artifact {b}x{r}: " + "; ".join(
            f"{d['name']} {fmt_blocks(d['blocks'])}"
            for d in art.decisions_for(b, r) if d["fused"]
            and d["blocks"]) + "; groups " + "; ".join(
            f"{g['name']} {fmt_blocks(g['blocks'])}"
            for g in art.groups_for(b, r)))

    # 3. cold starts, each on a fresh tuner cache
    fresh_cache(f"search-default-{prec}")
    n0 = autotune.SWEEP_COUNT
    t0 = time.perf_counter()
    default = make(VisionServeConfig(microbatch=max(art.buckets),
                                     buckets=art.buckets))
    default.warmup(art.resolutions)
    cold_default = time.perf_counter() - t0
    sweeps_default = autotune.SWEEP_COUNT - n0
    fresh_cache(f"search-artifact-{prec}")
    for w in wrappers.values():
        w.launches = 0
    autotune.SWEEP_LAUNCHES.clear()
    n0 = autotune.SWEEP_COUNT
    t0 = time.perf_counter()
    engine = make(VisionServeConfig(artifact=apath))
    engine.warmup(art.resolutions)
    cold_art = time.perf_counter() - t0
    sweeps_art = autotune.SWEEP_COUNT - n0
    print(f"[{tag}] cold start over {len(keys)} keys: default engine "
          f"(autotune=True) {cold_default:.3f} s, {sweeps_default} sweeps; "
          f"artifact engine {cold_art:.3f} s, {sweeps_art} sweeps")
    if sweeps_art:
        raise AssertionError(f"{tag}: the artifact engine swept "
                             f"{sweeps_art} times at cold start")
    if engine.microbatch != max(art.buckets) \
            or engine.cache.buckets != art.buckets:
        raise AssertionError(f"{tag}: buckets {engine.cache.buckets}, "
                             f"microbatch {engine.microbatch}")
    for b, r in keys:
        plan = engine.cache.get(b, r).plan
        got = [d.to_dict() for d in plan.decisions.values()]
        groups = [g.to_dict() for g in plan.groups.values()]
        if got != art.decisions_for(b, r) or groups != art.groups_for(b, r):
            diff = [(x["name"], x["fused"], x["reason"], x["blocks"])
                    for x, y in zip(got, art.decisions_for(b, r)) if x != y]
            raise AssertionError(f"{tag} {b}x{r}: the plan differs from the "
                                 f"artifact: {diff}; groups {groups}")
    print(f"[{tag}] every plan of the {len(keys)} keys equals the "
          f"artifact decision for decision, groups and blocks included")

    # 4. the trace served through the artifact engine's scheduler
    images = {r: np.random.default_rng(seed + r).standard_normal(
        (len(trace), r, r, 3)).astype(np.float32) for r in art.resolutions}
    t0 = time.perf_counter()
    reqs = replay_trace(engine, trace, images, SEARCH_DEADLINE_MS)
    serve_s = time.perf_counter() - t0
    swept = dict(autotune.SWEEP_LAUNCHES)
    launches = {k: w.launches - swept.get(k, 0) for k, w in wrappers.items()}
    c = engine.telemetry.counters
    bad = [(r.rid, r.status, r.error) for r in reqs
           if r.status != "completed"]
    dispatched = {(k[0], k[1]): s.dispatches
                  for k, s in engine.telemetry.buckets.items()
                  if s.dispatches}
    print(f"[{tag}] main path: counters at 0, the artifact engine made and "
          f"warmed ({len(keys)} keys) and {len(reqs)} requests served in "
          f"{serve_s:.3f} s: launches "
          f"{ {k: v for k, v in launches.items() if v} }; dispatches "
          f"{sorted(dispatched.items())} (the workload model: "
          f"{sorted(workload(trace, art.buckets, deadline_ms=SEARCH_DEADLINE_MS).items())}); "
          f"real_failures {c.get('real_failures', 0)}")
    if bad or c.get("real_failures", 0):
        raise AssertionError(f"{tag}: requests not completed: {bad}")
    check_healthy(engine, tag)
    captured: dict = {}
    for b, r in keys:
        for k, v in engine.cache.get(b, r).replay_launches.items():
            captured[k] = captured.get(k, 0) + v
    if launches != {k: 2 * captured.get(k, 0) for k in wrappers}:
        raise AssertionError(f"{tag}: launches {launches}, expected twice "
                             f"the captures' {captured}")
    for name, per in expected.items():
        if per and not launches[name]:
            raise AssertionError(f"{tag}: {name} never launched")
    for r in art.resolutions:
        idx = [i for i, (_, res) in enumerate(trace) if res == r]
        got = torch.from_numpy(np.stack([reqs[i].logits for i in idx]))
        x = torch.from_numpy(images[r][idx]).cuda()
        with torch.inference_mode():
            ref = torch.cat([execute(lower(B1, batch=len(x[i:i + 8]),
                                           image_size=r),
                                     engine.params, x[i:i + 8])
                             for i in range(0, len(x), 8)])
        check_logits(got, ref, f"{tag} {r} px", fix8=fix8)
        ex = engine.cache.get(max(art.buckets), r)
        xb = x[:max(art.buckets)]
        with torch.inference_mode():
            eager = execute(ex.program, engine.params, xb, plan=ex.plan)
        if not torch.equal(ex(engine.params, xb), eager):
            raise AssertionError(f"{tag} {r} px: replay differs from eager")
    print(f"[{tag}] replay equals eager bit for bit at batch "
          f"{max(art.buckets)}, {' and '.join(map(str, art.resolutions))} px")

    # 5. every kernel case and chain the artifact's plans serve
    scratch = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_s": 0.0, "ops_s": 0.0} for k in wrappers}
    cases_fn = int8_kernel_cases if fix8 else kernel_cases
    for r in art.resolutions:
        for b in sorted({min(art.buckets), max(art.buckets)}):
            plan = engine.cache.get(b, r).plan
            chains = chain_cases(b, gen, engine.params, engine.params, B1,
                                 (plan,), image_size=r)
            check_kernels(cases_fn(b, gen, B1, plan, image_size=r)
                          + chains[1 if fix8 else 0], b, scratch, max_err,
                          exact=fix8, tag=f"{tag} {r} px kernels")

    # 6. the artifact's plan against the tuned default plan (informational)
    for r in art.resolutions:
        b = max(art.buckets)
        xb = torch.from_numpy(images[r][:b]).cuda()
        ea, ed = engine.cache.get(b, r), default.cache.get(b, r)
        differ = [n for n, d in ed.plan.decisions.items()
                  if dict(d.blocks) != dict(ea.plan.decisions[n].blocks)]
        print(f"[{tag} {r} px] sites whose blocks differ from the tuned "
              f"default plan: {differ}")
        replay_ab({"artifact": lambda e=ea, x=xb: e(engine.params, x),
                   "tuned": lambda e=ed, x=xb: e(default.params, x)},
                  f"{tag} {r} px")
    del default

    # 7. a JAX-style document (schema 1, no backend, Pallas block keys)
    jdoc = {"schema": 1, "config_hash": config_hash(B1), "precision": prec,
            "trace_fingerprint": fp, "buckets": list(art.buckets),
            "resolutions": list(art.resolutions),
            "entries": {"8x224": [{"name": "S1.mb0", "kind": "mbconv",
                                   "fused": True, "reason": "ok",
                                   "blocks": {"block_f": 64}}]},
            "tuner_cache": {"mbconv|b=8": {"block_f": 64}},
            "objective": 1.0, "default_objective": 1.0, "seed": seed,
            "config_name": B1.name}
    jpath = os.path.join(out_dir, f"jax-style-{prec}-{os.getpid()}.json")
    with open(jpath, "w") as f:
        json.dump(jdoc, f)
    consults: list = []
    autotune.set_fault_hook(lambda kind, key: consults.append(kind))
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        make(VisionServeConfig(artifact=jpath))
        raise AssertionError(f"{tag}: a JAX-style artifact was adopted")
    except ArtifactError as e:
        print(f"[{tag}] a JAX-style artifact refused before any plan: {e}")
    finally:
        autotune.set_fault_hook(None)
    if consults or any(w.launches != before[k]
                       for k, w in wrappers.items()):
        raise AssertionError(f"{tag}: the refused artifact planned or "
                             f"launched: {consults}")
    del engine
    gc.collect()
    use_cache(main_cache)
    return launches


# the [lm] phase: Zamba2-1.2B (relu_linear) and Mamba2-1.3B served by the
# LM ServingEngine (prompt lengths, tokens per request)
LM_PROMPTS = (8, 17, 64, 255, 256, 257, 1000, 2048, 4096, 100)
LM_MAMBA_PROMPTS = (100, 1000, 2048, 4096)
LM_LONG = 32768
LM_TOKENS = 32
LM_TOL = 1e-3                 # fp32 served vs reference logits, relative
LM_BF16_TOL = 0.1             # bf16 served vs bf16 reference, of max|logit|
LM_SCANS = ("ssd_chunked", "relu_attn_causal")
# prompt lengths profiled on the device, their scan calls held and timed
LM_PROFILED = (8, 100, 257, 4096, LM_LONG)
# the [lm softmax] phase (6d): on- and off-chunk prompt lengths (chunk
# 1024); gemma3 also 1020 (its ring wraps while decoding); gemma3 under
# relu_linear one 32768-token prompt beside two short ones
LM_SOFTMAX_PROMPTS = (8, 17, 255, 1024, 1025, 2048, 4096)
LM_GEMMA_PROMPTS = (8, 17, 255, 1020, 1024, 1025, 2048, 4096)
LM_RELU_PROMPTS = (8, 1025, LM_LONG)
# the bf16 runs, cut to keep the phase near two minutes: a short prompt,
# one off the chunk and the longest (gemma3: its ring wrap too)
LM_SOFTMAX_BF16_PROMPTS = (8, 1025, 4096)
LM_GEMMA_BF16_PROMPTS = (8, 1020, 1025, 4096)
LM_CORES = ("softmax_attention", "sliding_attention")


def lm_scan_calls(cfg) -> dict:
    """Launches of each scan per served prefill: one ``ssd_chunked`` per
    Mamba-2 layer, one ``relu_attn_causal`` per relu_linear attention
    layer (zamba2's shared block per call, gemma3's global layers) under
    ``attn_backend="relu_linear"``."""
    attn = {"zamba2": cfg.n_layers // cfg.shared_attn_every,
            "gemma3": cfg.n_layers // cfg.global_every}.get(cfg.family, 0)
    return {"ssd_chunked": (cfg.n_layers if cfg.family in ("mamba2",
                                                            "zamba2")
                            else 0),
            "relu_attn_causal": (attn if cfg.attn_backend == "relu_linear"
                                 else 0)}


def lm_engine(cfg, params, slots, max_len, reference=False):
    """A ``ServingEngine`` whose model records every prefill's logits and
    host seconds (a synchronize on each side) and every decode step's
    logits with the request in each slot.  ``reference=True`` gives the
    engine the reference forward's model (``build_model(cfg,
    reference=True)``: the scans' plain versions), as a yardstick."""
    import dataclasses

    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(max_slots=slots,
                                                 max_len=max_len))
    rec = {"prefill": [], "prefill_s": [], "decode": []}
    model = build_model(cfg, reference=True) if reference else eng.model

    def prefill(p, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(p, batch)
        torch.cuda.synchronize()
        rec["prefill_s"].append(time.perf_counter() - t0)
        rec["prefill"].append(logits[0])
        return logits, caches

    def decode(p, c, t, pos):
        logits, caches = model.decode(p, c, t, pos)
        rec["decode"].append(([r.rid if r is not None else None
                               for r in eng.slot_req], logits))
        return logits, caches

    eng.model = dataclasses.replace(model, prefill=prefill, decode=decode)
    return eng, rec


def lm_logits_by_request(rec, rids) -> dict:
    """rid -> the (V,) logits that chose each of its tokens: its
    prefill's (admissions in ``rids`` order), then each decode step it
    was active in."""
    out = {rid: [rec["prefill"][i]] for i, rid in enumerate(rids)}
    for slots, logits in rec["decode"]:
        for i, rid in enumerate(slots):
            if rid is not None:
                out[rid].append(logits[i])
    return out


def lm_serve(tag, cfg, params, prompts, slots, max_len, wrappers,
             reference=False):
    """Serve ``prompts`` (``LM_TOKENS`` each, greedy) through a new
    engine; the launch counters are set to 0 just before the engine is
    made and read just after the run, and each scan must have launched
    ``lm_scan_calls`` times per admitted request (none for the
    reference engine), every other kernel never.  -> (tokens by rid,
    logits by rid, launches, record, seconds, engine)."""
    import torch
    from repro_torch.serving.engine import Request
    for w in wrappers.values():
        w.launches = 0
    eng, rec = lm_engine(cfg, params, slots, max_len, reference)
    reqs = [Request(rid=i, prompt=p, max_tokens=LM_TOKENS)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if sorted(r.rid for r in done) != list(range(len(prompts))) or any(
            len(r.out_tokens) != LM_TOKENS for r in done):
        raise AssertionError(f"[{tag}] {len(done)} of {len(prompts)} "
                             f"requests finished, tokens "
                             f"{[len(r.out_tokens) for r in done]}")
    per = lm_scan_calls(cfg)
    n = 0 if reference else len(prompts)
    want = dict.fromkeys(wrappers, 0) | {k: per[k] * n for k in LM_SCANS}
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected "
                             f"{want}")
    tokens = {r.rid: r.out_tokens for r in done}
    return (tokens, lm_logits_by_request(rec, range(len(prompts))),
            launches, rec, secs, eng)


def lm_check_tokens(tag, served, ref_tokens, ref_logits) -> None:
    """The served tokens equal the reference engine's wherever the
    reference's top-2 margin exceeds ``LM_TOL`` * max(1, max|logit|),
    up to each request's first flip (after it the contexts differ).
    Every flip is printed with its margin."""
    import torch
    flips = 0
    for rid, want in ref_tokens.items():
        for i, (got, tok) in enumerate(zip(served[rid], want)):
            if got == tok:
                continue
            lg = ref_logits[rid][i].float()
            top2 = torch.topk(lg, 2).values
            margin = (top2[0] - top2[1]).item()
            tol = LM_TOL * max(1.0, lg.abs().max().item())
            print(f"[{tag}] flip: request {rid} token {i}: served {got}, "
                  f"reference {tok}, reference margin {margin:.3e} "
                  f"(tolerance {tol:.3e})")
            if margin > tol:
                raise AssertionError(f"[{tag}] request {rid} token {i} "
                                     f"differs at margin {margin:.3e}")
            flips += 1
            break
    print(f"[{tag}] tokens: {sum(map(len, served.values()))} served, "
          f"{flips} flips at margins within the tolerance, every other "
          f"token equal to the reference engine's")


def lm_prefill_gate(tag, got, ref, rel, top1: bool) -> float:
    """One prefill's logits against the reference's: within ``rel`` *
    max(1, max|ref|) (fp32) or ``rel`` * max|ref| (bf16, ``top1``
    False), finite, and for fp32 the same top-1.  -> max|d| / max|ref|."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[{tag}] non-finite served logits")
    d, top = (got - ref).abs().max().item(), ref.abs().max().item()
    lim = rel * (max(1.0, top) if top1 else top)
    if not d <= lim:
        raise AssertionError(f"[{tag}] logits {d:.3e} from the reference "
                             f"(max|ref| {top:.3e}), above {lim:.3e}")
    if top1 and int(got.argmax()) != int(ref.argmax()):
        raise AssertionError(f"[{tag}] top-1 differs from the reference")
    return d / top


def lm_scan_case(name, args, kw, label):
    """A ``measure`` case of one scan call captured from the LM layers
    (a served prefill, a training step): the wrapper on those inputs against its plain version; the
    bytes (inputs read once, the fp32 output written once) and products
    as the library cases count them."""
    from repro_torch.kernels.relu_attn.kernel import (
        relu_attn_causal, relu_attn_causal_cost)
    from repro_torch.kernels.relu_attn.ref import relu_attn_causal_scan
    from repro_torch.kernels.ssd.kernel import ssd_chunked, ssd_cost
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    import torch
    C = kw["chunk"]
    if name == "relu_attn_causal":
        q = args[0]
        BH, N, D = q.shape
        cost = relu_attn_causal_cost(BH, N, D, C)
        tri, read, update = cost["triangle"], cost["read"], cost["update"]
        ops = (((tri / 2 + update, PEAK_BF16_FLOPS),
                (tri / 2 + read, PEAK_FP32_FLOPS))
               if q.dtype == torch.bfloat16 else tri + read + update)
        nbytes = 3 * q.numel() * q.element_size() + 4 * q.numel()
        kfn = lambda: relu_attn_causal(*args, **kw)        # noqa: E731
        pfn = lambda: relu_attn_causal_scan(*args, **kw)   # noqa: E731
    else:
        x, Bm = args[0], args[3]
        BH, S, P = x.shape
        n = Bm.shape[-1]
        ops = ssd_cost(BH, S, P, n, C)["flops"]
        nbytes = 4 * sum(t.numel() for t in args) + 4 * x.numel()
        kfn = lambda: ssd_chunked(*args, **kw)             # noqa: E731
        pfn = lambda: ssd_scan_ref(*args, **kw)            # noqa: E731
    return (name, [], label, kfn, pfn, nbytes, ops, None)


@contextlib.contextmanager
def lm_scan_probe():
    """While open, the first scan call from the LM layers at each
    (kernel, tokens) keeps its inputs: -> {(name, tokens): (args,
    kwargs)}."""
    from repro_torch.kernels.relu_attn import ops as relu_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    calls = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (relu_ops, "relu_attn_causal"), (ssd_ops, "ssd_chunked"))]
    for mod, name, fn in saved:
        def probe(*a, _fn=fn, _name=name, **k):
            calls.setdefault((_name, a[0].shape[1]), (a, k))
            return _fn(*a, **k)
        setattr(mod, name, probe)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def lm_core_probe():
    """While open, the plain attention cores of the LM layers
    (``LM_CORES``): -> {(name, tokens): [function, args, kwargs, calls]},
    the first call's inputs at each length and the number of top-level
    calls (a sliding fallback's inner softmax call is part of its
    sliding call)."""
    from repro_torch.layers import attention as ta
    calls, depth = {}, [0]
    saved = [(name, getattr(ta, name)) for name in LM_CORES]
    for name, fn in saved:
        def probe(*a, _fn=fn, _name=name, **k):
            if depth[0] == 0:
                calls.setdefault((_name, a[0].shape[1]),
                                 [_fn, a, k, 0])[3] += 1
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1
        setattr(ta, name, probe)
    try:
        yield calls
    finally:
        for name, fn in saved:
            setattr(ta, name, fn)


def graph_ms(fn, reps: int = 1, windows: int = 3) -> float:
    """Device time of one call of ``fn``, its launches captured into a
    CUDA graph (after a warm-up call on a side stream) and the replay
    timed by ``device_ms``.  An eager call of thousands of launches
    cannot be timed by events behind a sleep kernel: the launch queue
    fills, the host blocks until the sleep ends, and the window then
    times the host."""
    import torch
    torch.cuda.empty_cache()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = device_ms(graph.replay, reps, windows)
    del graph
    return ms


def host_ms(fn, reps: int = 3) -> float:
    """Host time to enqueue one call of ``fn`` (the card synchronized
    before, not waited for inside)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def lm_prefill_profile(tag, cfg, model, params, prompts, prefill_s,
                       max_err, card, profiled=LM_PROFILED) -> None:
    """Informational: per prompt length, prefill tokens/s over the served
    admission (host seconds, synchronized); at the ``profiled`` lengths
    also the host time to enqueue one prefill, its device time
    (``graph_ms``), the two scans' share of it (each scan call at that
    length timed alone, times its calls per prefill), the plain softmax /
    sliding attention cores' share (each core's first call at that
    length, its launches captured and replayed, times its calls) and its
    peak memory, and each scan call held against its plain version and
    timed (``[lm kernel]`` lines)."""
    import torch
    per = lm_scan_calls(cfg)
    cases = []
    for p, secs in zip(prompts, prefill_s):
        line = (f"[{tag}] prefill {len(p)} tokens: {len(p) / secs:.1f} "
                f"tokens/s served ({secs * 1e3:.3f} ms)")
        if len(p) not in profiled:
            print(f"{line} [{card}]")
            continue
        toks = {"tokens": torch.as_tensor(p, device="cuda")[None]}
        run = lambda: model.prefill(params, toks)          # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        h_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with lm_scan_probe() as calls, lm_core_probe() as cores:
            run()
        d_ms = graph_ms(run, 1, 1)
        scans = {}
        for (name, n), (a, k) in calls.items():
            case = lm_scan_case(name, a, k, f"{tag} prefill {n} tokens "
                                f"{tuple(a[0].shape)} {str(a[0].dtype)[6:]}")
            scans[name] = per[name] * device_ms(case[3], 5, 3)
            cases.append(case)
        attn = {}
        for (name, n), (fn, a, k, count) in cores.items():
            one = graph_ms(lambda: fn(*a, **k))            # noqa: B023
            attn[name] = (count, count * one)
        del cores
        experts = lm_expert_share(run, d_ms)
        parts = [experts] if experts else []
        if scans:
            parts.append("scans " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in scans.items())
                + f" ({sum(scans.values()) / d_ms:.3f} of the device time)")
        if attn:
            parts.append("plain attention " + ", ".join(
                f"{k} {v[1]:.3f} ms ({v[0]} calls)" for k, v in attn.items())
                + f" ({sum(v[1] for v in attn.values()) / d_ms:.3f} of the "
                f"device time)")
        print(f"{line}; host {h_ms:.3f} ms to enqueue, device {d_ms:.3f} "
              f"ms (graph replay); " + "; ".join(parts + [
                  f"{peak / 2**30:.3f} GiB allocated at its peak beyond the "
                  f"params and caches [{card}]"]))
    for case in cases:
        err, ref_max, *times = measure(case, False, 5, 3)
        max_err[case[0]] = max(max_err[case[0]], err)
        kernel_line("lm kernel", case, "", err, ref_max, *times)


def lm_decode_profile(tag, eng, decode_tokens, decode_s, card) -> None:
    """Informational: decode tokens/s over the served run, and one decode
    step at every slot: the host time to enqueue it and its device time
    (``graph_ms``), and an estimate of the share of an eager step the
    card idles: 1 - device / host, which assumes the eager step keeps
    the card busy as long as the graph replay does (not traced)."""
    import torch
    B = eng.cfg.max_slots
    tokens = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), 300, device="cuda")
    model, params, caches = eng.model, eng.params, eng.caches
    step = lambda: model.decode(params, caches, tokens, pos)  # noqa: E731
    h_ms, d_ms = host_ms(step), graph_ms(step)
    experts = lm_expert_share(step, d_ms)
    kv = list(lm_kv_leaves(caches))
    copies = f"; {experts}" if experts else ""
    if kv:
        # the step writes each KV leaf anew (the row write) and stacks
        # the layers' leaves again: two copies of the cache
        nbytes = sum(t.numel() * t.element_size() for t in kv)
        c_ms = graph_ms(lambda: [torch.stack(list(t.clone()))
                                 for t in kv])
        copies += (f"; KV cache {nbytes / 2**30:.3f} GiB, written at least "
                  f"twice a step ({2 * nbytes / 2**30:.3f} GiB: the row "
                  f"write and the re-stack), two copies alone {c_ms:.3f} "
                  f"ms on the device")
    print(f"[{tag}] decode: {decode_tokens / decode_s:.1f} tokens/s "
          f"served ({decode_tokens} tokens in {decode_s:.3f} s of decode "
          f"steps); one step at {B} slots: host {h_ms:.3f} ms to enqueue, "
          f"device {d_ms:.3f} ms (graph replay): the card idles an "
          f"estimated {max(0.0, 1 - d_ms / h_ms):.3f} of an eager step "
          f"(1 - device / host, not traced){copies} [{card}]")


def lm_kv_leaves(tree):
    """The KV cache leaves (``k``, ``v``) of a stacked cache tree."""
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from lm_kv_leaves(v)
        elif key in ("k", "v"):
            yield v


def lm_run(tag, cfg, seed, prompts, slots, wrappers, max_err, card, *,
           fp32: bool) -> dict:
    """One ``[lm ...]`` sub-phase: random params from ``seed`` on the
    card, the served run (``lm_serve``), its gates against the reference
    forward / engine, then the informational timings.  -> the served
    run's launches."""
    import numpy as np
    import torch
    from repro_torch.models.registry import build_model
    params = build_model(cfg).init(seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n) for n in prompts]
    max_len = max(map(len, prompts)) + 64      # 4160 at 4096 tokens
    # warm-up (cuBLAS handles, first allocations): before any counter
    build_model(cfg).prefill(params, {"tokens": torch.as_tensor(
        prompts[0][:8], device="cuda")[None]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, logits, launches, rec, secs, eng = lm_serve(
        tag, cfg, params, prompts, slots, max_len, wrappers)
    peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[{tag}] {cfg.name} {cfg.param_dtype}/{cfg.compute_dtype} "
          f"{sum(t.numel() for t in _leaves(params))} params: "
          f"{len(prompts)} requests x {LM_TOKENS} tokens in {secs:.3f} s "
          f"from {slots} slots; launches per prefill "
          f"{lm_scan_calls(cfg)}, run {dict((k, launches[k]) for k in LM_SCANS)}; "
          f"peak allocated while serving {peak / 2**30:.3f} GiB "
          f"(params {param_bytes / 2**30:.3f}) [{card}]")
    ref_model = build_model(cfg, reference=True)
    gaps = []
    if fp32:
        ref_tokens, ref_logits, *_ = lm_serve(
            tag + " reference", cfg, params, prompts, slots, max_len,
            wrappers, reference=True)
        for i, p in enumerate(prompts):
            gaps.append(lm_prefill_gate(tag, logits[i][0],
                                        ref_logits[i][0], LM_TOL, True))
        lm_check_tokens(tag, served, ref_tokens, ref_logits)
    else:
        for i, p in enumerate(prompts):
            ref, _ = ref_model.prefill(params, {"tokens": torch.as_tensor(
                p, device="cuda")[None]})
            gaps.append(lm_prefill_gate(tag, logits[i][0], ref[0],
                                        LM_BF16_TOL, False))
        for rid, lgs in logits.items():
            if not all(bool(torch.isfinite(lg.float()).all())
                       for lg in lgs):
                raise AssertionError(f"[{tag}] request {rid}: non-finite "
                                     f"decode logits")
    print(f"[{tag}] prefill logits vs the reference forward (plain "
          f"scans), max|d| / max|ref| per prompt: "
          + ", ".join(f"{len(p)}: {g:.3e}" for p, g in zip(prompts, gaps))
          + (" (top-1 equal)" if fp32 else " (every logit finite)"))
    decode_tokens = sum(len(t) - 1 for t in served.values())
    eng.model = build_model(cfg)        # no recording from here on
    lm_decode_profile(tag, eng, decode_tokens,
                      secs - sum(rec["prefill_s"]), card)
    lm_prefill_profile(tag, cfg, eng.model, params, prompts,
                       rec["prefill_s"], max_err, card)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def lm_phase(seed, wrappers, max_err, card) -> dict:
    """``[lm zamba2 fp32]``, ``[lm zamba2 bf16]`` and ``[lm mamba2]``:
    the LM serving path at full width and depth.  -> the launches of the
    three served runs, summed."""
    from repro_torch.configs import get_arch
    zamba = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    runs = [
        lm_run("lm zamba2 fp32", zamba.scaled(**fp32), seed, LM_PROMPTS, 8,
               wrappers, max_err, card, fp32=True),
        lm_run("lm zamba2 bf16", zamba, seed + 1, LM_PROMPTS + (LM_LONG,),
               8, wrappers, max_err, card, fp32=False),
        lm_run("lm mamba2", get_arch("mamba2-1.3b").scaled(**fp32),
               seed + 2, LM_MAMBA_PROMPTS, 2, wrappers, max_err, card,
               fp32=True)]
    return {k: sum(r[k] for r in runs) for k in wrappers}


def lm_decode_gate(tag, model, params, prompts, served, logits, rel,
                   fp32: bool) -> None:
    """Decode = re-prefill: each request's logits at its first, second
    and last decode step against the last-row logits of a fresh batch-1
    prefill of its prompt and the tokens chosen before that step: finite,
    within ``rel`` * max(1, max|ref|) (fp32) or ``rel`` * max|ref|
    (bf16), and at fp32 the same top-1 wherever the re-prefill's top-2
    margin exceeds the tolerance.  This holds the KV caches (the ring,
    the slot padding, the slot writes, each slot's positions) on the
    card against the cache-free prefill."""
    import numpy as np
    import torch
    worst, flips, n = 0.0, 0, 0
    for rid, p in enumerate(prompts):
        toks = served[rid]
        last = len(toks) - 1
        for j in sorted({1, 2, last}):
            ctx = np.concatenate([p, np.asarray(toks[:j])])
            ref, _ = model.prefill(params, {"tokens": torch.as_tensor(
                ctx, device="cuda")[None]})
            got, ref = logits[rid][j].float(), ref[0].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"[{tag}] request {rid} step {j}: "
                                     f"non-finite decode logits")
            d, top = (got - ref).abs().max().item(), ref.abs().max().item()
            lim = rel * (max(1.0, top) if fp32 else top)
            if not d <= lim:
                raise AssertionError(
                    f"[{tag}] request {rid} ({len(p)} tokens) decode step "
                    f"{j}: logits {d:.3e} from the re-prefill (max|ref| "
                    f"{top:.3e}), above {lim:.3e}")
            if fp32 and int(got.argmax()) != int(ref.argmax()):
                top2 = torch.topk(ref, 2).values
                margin = (top2[0] - top2[1]).item()
                print(f"[{tag}] top-1 flip: request {rid} step {j}, "
                      f"re-prefill margin {margin:.3e} (tolerance "
                      f"{lim:.3e})")
                if margin > lim:
                    raise AssertionError(f"[{tag}] request {rid} step {j}: "
                                         f"top-1 differs at margin "
                                         f"{margin:.3e}")
                flips += 1
            worst = max(worst, d / top)
            n += 1
    print(f"[{tag}] decode = re-prefill: {n} steps (1, 2 and the last of "
          f"each request), max|d| / max|ref| {worst:.3e}, limit {rel:g} of "
          f"{'max(1, max|ref|)' if fp32 else 'max|ref|'}"
          + (f", top-1 equal but {flips} within the margin" if fp32
             else ", every logit finite"))


def lm_softmax_run(tag, cfg, seed, prompts, slots, wrappers, max_err, card,
                   *, fp32: bool, profiled) -> dict:
    """One ``[lm softmax ...]`` sub-phase: random params from ``seed`` on
    the card, the served run (``lm_serve``: launches per admission
    exact), decode = re-prefill (``lm_decode_gate``), and where a scan
    runs the served prefill logits against the reference forward (the
    scans' plain versions); then the informational timings.  -> the
    served run's launches."""
    import numpy as np
    import torch
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n) for n in prompts]
    max_len = max(map(len, prompts)) + 64
    # warm-up (cuBLAS handles, first allocations): before any counter
    model.prefill(params, {"tokens": torch.as_tensor(
        prompts[0][:8], device="cuda")[None]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, logits, launches, rec, secs, eng = lm_serve(
        tag, cfg, params, prompts, slots, max_len, wrappers)
    peak = torch.cuda.max_memory_allocated()
    leaves = list(_leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in lm_kv_leaves(eng.caches))
    print(f"[{tag}] {cfg.name} {cfg.family} {cfg.n_layers} layers "
          f"{cfg.param_dtype}/{cfg.compute_dtype}, KV {cfg.kv_dtype}, "
          f"{sum(t.numel() for t in leaves)} params: {len(prompts)} "
          f"requests x {LM_TOKENS} tokens in {secs:.3f} s from {slots} "
          f"slots (max_len {max_len}); launches per prefill "
          f"{lm_scan_calls(cfg)}, run "
          f"{dict((k, launches[k]) for k in LM_SCANS)}; peak allocated "
          f"while serving {peak / 2**30:.3f} GiB (params "
          f"{param_bytes / 2**30:.3f}, KV caches {kv_bytes / 2**30:.3f}) "
          f"[{card}]")
    rel = LM_TOL if fp32 else LM_BF16_TOL
    if any(lm_scan_calls(cfg).values()):
        ref_model = build_model(cfg, reference=True)
        gaps = []
        for i, p in enumerate(prompts):
            ref, _ = ref_model.prefill(params, {"tokens": torch.as_tensor(
                p, device="cuda")[None]})
            gaps.append(lm_prefill_gate(tag, logits[i][0], ref[0], rel,
                                        fp32))
        print(f"[{tag}] prefill logits vs the reference forward (plain "
              f"scans), max|d| / max|ref| per prompt: "
              + ", ".join(f"{len(p)}: {g:.3e}"
                          for p, g in zip(prompts, gaps))
              + (" (top-1 equal)" if fp32 else " (every logit finite)"))
    lm_decode_gate(tag, model, params, prompts, served, logits, rel, fp32)
    decode_tokens = sum(len(t) - 1 for t in served.values())
    eng.model = model                   # no recording from here on
    lm_decode_profile(tag, eng, decode_tokens,
                      secs - sum(rec["prefill_s"]), card)
    lm_prefill_profile(tag, cfg, model, params, prompts, rec["prefill_s"],
                       max_err, card, profiled)
    del eng, params, logits, rec
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] {time.perf_counter() - t0:.1f} s")
    return launches


def lm_vlm_check(tag, cfg, seed, card) -> None:
    """vlm at fp32: a prefill of ``cfg.n_patches`` random patch
    embeddings (the stub frontend's) and 64 text tokens gives the
    last-row logits of ``lm_logits_head`` over ``forward_hidden`` of
    [patches | text embeddings], within ``LM_TOL`` * max(1, max|logit|),
    and caches of P + S positions."""
    import torch
    from repro_torch.layers.linear import embed
    from repro_torch.models import lm as tlm
    from repro_torch.models.registry import build_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model(cfg)
    params = model.init(gen, device="cuda")
    patches = torch.randn((1, cfg.n_patches, cfg.d_model), generator=gen,
                          device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 64), generator=gen,
                         device="cuda")
    logits, caches = model.prefill(params, {"tokens": toks,
                                            "patches": patches})
    x = torch.cat([patches, embed(params["embed"], toks, cfg.cdtype)], 1)
    h, _ = tlm.forward_hidden(params, x, cfg, torch.arange(
        x.shape[1], device="cuda"))
    ref = tlm.lm_logits_head(params, h[:, -1:], cfg)[:, 0]
    d, top = (logits - ref).abs().max().item(), ref.abs().max().item()
    if not d <= LM_TOL * max(1.0, top):
        raise AssertionError(f"[{tag}] patch prefill {d:.3e} from the "
                             f"forward (max|ref| {top:.3e})")
    length = caches["blocks"]["k"].shape[2]
    if length != cfg.n_patches + 64:
        raise AssertionError(f"[{tag}] caches of {length} positions")
    print(f"[{tag}] {cfg.name} fp32: prefill of {cfg.n_patches} patch "
          f"embeddings + 64 tokens vs lm_logits_head(forward_hidden) of "
          f"the concatenation: max|d| {d:.3e} (max|ref| {top:.3e}); caches "
          f"hold {length} positions [{card}]")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()


def lm_launch_check(tag, card) -> None:
    """``launch.serve.main`` at its defaults (granite-3-2b, bf16, 12
    requests of 16 tokens from 4 slots) on the card."""
    import torch
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    done = serve.main([])
    torch.cuda.synchronize()
    if sorted(r.rid for r in done) != list(range(12)) or any(
            len(r.out_tokens) != 16 for r in done):
        raise AssertionError(f"[{tag}] {len(done)} of 12 requests "
                             f"finished")
    print(f"[{tag}] python -m repro_torch.launch.serve (defaults): 12 "
          f"requests x 16 tokens in {time.perf_counter() - t0:.3f} s with "
          f"the set-up [{card}]")
    gc.collect()
    torch.cuda.empty_cache()


def lm_softmax_phase(seed, wrappers, max_err, card) -> dict:
    """``[lm softmax ...]``: softmax and sliding-window attention with
    their KV caches at full width, served from 8 slots.  -> the launches
    of the served runs, summed."""
    from repro_torch.configs import get_arch
    fp32 = dict(param_dtype="float32", compute_dtype="float32",
                kv_dtype="float32")
    granite, zamba, gemma, vlm = (get_arch(n) for n in (
        "granite-3-2b", "zamba2-1.2b", "gemma3-12b", "internvl2-1b"))
    runs = [
        lm_softmax_run("lm softmax granite fp32", granite.scaled(**fp32),
                       seed, LM_SOFTMAX_PROMPTS, 8, wrappers, max_err, card,
                       fp32=True, profiled=(8, 4096)),
        lm_softmax_run("lm softmax granite bf16", granite, seed + 1,
                       LM_SOFTMAX_BF16_PROMPTS, 8, wrappers, max_err, card,
                       fp32=False, profiled=(4096,)),
        lm_softmax_run("lm softmax zamba2 fp32", zamba.scaled(**fp32),
                       seed + 2, LM_SOFTMAX_PROMPTS, 8, wrappers, max_err,
                       card, fp32=True, profiled=(8, 4096)),
        lm_softmax_run("lm softmax zamba2 bf16", zamba, seed + 3,
                       LM_SOFTMAX_BF16_PROMPTS, 8, wrappers, max_err, card,
                       fp32=False, profiled=()),
        lm_softmax_run("lm softmax gemma3 fp32 12 layers",
                       gemma.scaled(n_layers=12, **fp32), seed + 4,
                       LM_GEMMA_PROMPTS, 8, wrappers, max_err, card,
                       fp32=True, profiled=(1020, 4096)),
        lm_softmax_run("lm softmax gemma3 bf16", gemma, seed + 5,
                       LM_GEMMA_BF16_PROMPTS, 8, wrappers, max_err, card,
                       fp32=False, profiled=(8, 4096)),
        lm_softmax_run("lm softmax gemma3 relu_linear bf16",
                       gemma.scaled(attn_backend="relu_linear"), seed + 6,
                       LM_RELU_PROMPTS, 8, wrappers, max_err, card,
                       fp32=False, profiled=(8, 1025, LM_LONG)),
        lm_softmax_run("lm softmax internvl2 bf16", vlm, seed + 7,
                       LM_SOFTMAX_BF16_PROMPTS, 8, wrappers, max_err, card,
                       fp32=False, profiled=(4096,)),
    ]
    lm_vlm_check("lm softmax internvl2 fp32", vlm.scaled(**fp32), seed + 8,
                 card)
    lm_launch_check("lm softmax launch", card)
    return {k: sum(r[k] for r in runs) for k in wrappers}


# the [lm moe] / [lm encdec] phase (6e): the MoE models' prompt lengths,
# the lengths their no-drop re-prefill gates take (Kimi-K2: the (384,
# T + 1, 7168) dispatch buffer of a no-drop prefill is 1.4 GB at T =
# 256), and Seamless's encoder lengths, batch and decode steps
LM_MOE_PROMPTS = (8, 255, 1024, 4096)
LM_GROK_GATE = (8, 255, 1024)
LM_KIMI_GATE = (8, 255)
LM_W8_TOL = 0.12              # W8 vs bf16 logits, relative L2 (JAX's bound)
LM_ENCDEC_FRAMES = (512, 4096)
LM_ENCDEC_BATCH = 4
LM_ENCDEC_STEPS = 32


@contextlib.contextmanager
def lm_moe_probe():
    """While open, every MoE call's slotting (``layers/moe.py::
    _slot_assign``): -> [(groups, tokens per group, valid mask)]."""
    from repro_torch.layers import moe as tmoe
    calls, fn = [], tmoe._slot_assign

    def probe(idx, n_experts, capacity):
        slot_c, valid = fn(idx, n_experts, capacity)
        calls.append((idx.shape[0], idx.shape[1], valid))
        return slot_c, valid

    tmoe._slot_assign = probe
    try:
        yield calls
    finally:
        tmoe._slot_assign = fn


@contextlib.contextmanager
def lm_expert_probe():
    """While open, the expert products of every MoE call (``layers/
    moe.py::_expert_ffn``): -> {buffer shape: [args, calls]}."""
    from repro_torch.layers import moe as tmoe
    calls, fn = {}, tmoe._expert_ffn

    def probe(*a):
        calls.setdefault(tuple(a[0].shape), [a, 0])[1] += 1
        return fn(*a)

    tmoe._expert_ffn = probe
    try:
        yield calls
    finally:
        tmoe._expert_ffn = fn


def lm_expert_share(run, d_ms) -> str:
    """The expert products' device time in one call of ``run`` (each
    shape's first call captured into a graph and replayed, times its
    calls) and its share of ``d_ms``; "" where ``run`` calls none."""
    from repro_torch.layers import moe as tmoe
    with lm_expert_probe() as calls:
        run()
    if not calls:
        return ""
    total, n = 0.0, 0
    for a, count in calls.values():
        total += count * graph_ms(lambda: tmoe._expert_ffn(*a))  # noqa: B023
        n += count
    del calls
    return (f"expert products {total:.3f} ms ({n} calls, "
            f"{total / d_ms:.3f} of the device time)")


def lm_drops(tag, cfg, calls) -> None:
    """Print the share of prefill assignments the capacity dropped per
    prompt length (the engine's prefills are batch-1 groups); every
    decode call (one group per slot) must drop none."""
    pre, dec = {}, [0, 0]
    for groups, tokens, valid in calls:
        n, kept = valid.numel(), int(valid.sum())
        acc = pre.setdefault(tokens, [0, 0]) if groups == 1 else dec
        acc[0] += n - kept
        acc[1] += n
    if dec[0]:
        raise AssertionError(f"[{tag}] decode dropped {dec[0]} of {dec[1]} "
                             f"assignments")
    print(f"[{tag}] capacity factor {cfg.capacity_factor:g}: share of "
          f"prefill assignments dropped per prompt length (all layers) "
          + ", ".join(f"{t}: {d / n:.4f}" for t, (d, n) in sorted(
              pre.items()))
          + f"; decode dropped 0 of {dec[1]} (one group per slot)")


def lm_forced(cfg, params, prompts, max_len, tokens) -> dict:
    """Each request's logits through a new engine from 8 slots, every
    token forced to ``tokens[rid]`` (teacher-forced): -> rid -> [prefill
    logits, each decode step's]."""
    import torch
    from repro_torch.serving import engine as teng
    from repro_torch.serving.engine import Request
    eng, rec = lm_engine(cfg, params, 8, max_len)
    reqs = [Request(rid=i, prompt=p, max_tokens=LM_TOKENS)
            for i, p in enumerate(prompts)]
    order, real = iter(reqs), teng.sample

    def forced(logits, generator, scfg):
        if logits.shape[0] == 1:                  # an admission
            return torch.tensor([tokens[next(order).rid][0]])
        return torch.tensor([tokens[r.rid][len(r.out_tokens)]
                             if r is not None else 0 for r in eng.slot_req])

    teng.sample = forced
    try:
        eng.run(reqs)
    finally:
        teng.sample = real
    del eng
    return lm_logits_by_request(rec, range(len(prompts)))


@contextlib.contextmanager
def lm_route_probe(replay=None):
    """While open, every MoE routing (``layers/moe.py::_route``): -> the
    list of each call's top-k expert indices.  With ``replay`` (such a
    list, of a run with the same calls) each call takes the recorded
    experts instead of its own top-k, the gates their probabilities
    renormalized as ``_route`` does: the run keeps another run's routes
    and drops, and only the numbers it routes change."""
    import torch
    from repro_torch.layers import moe as tmoe
    calls, fn = [], tmoe._route

    def probe(xf, router_w, cfg):
        gates, idx, probs = fn(xf, router_w, cfg)
        if replay is not None:
            idx = replay[len(calls)]
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
        calls.append(idx)
        return gates, idx, probs

    tmoe._route = probe
    try:
        yield calls
    finally:
        tmoe._route = fn


def lm_w8_rel(tag, ref, got) -> tuple:
    """W8 against bf16 logits of the same requests and tokens: the
    relative L2 of every request's decode-step logits (steps 1..,
    stacked), the largest of one step's requests stacked, and the
    prefill logits'; all finite."""
    import torch

    def rel(j0, j1):
        a = torch.stack([torch.stack([lg.float() for lg in ref[r][j0:j1]])
                         for r in ref])
        b = torch.stack([torch.stack([lg.float() for lg in got[r][j0:j1]])
                         for r in ref])
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"[{tag}] non-finite W8 logits")
        return ((b - a).norm() / a.norm()).item()

    return (rel(1, LM_TOKENS), max(rel(j, j + 1)
                                   for j in range(1, LM_TOKENS)), rel(0, 1))


def lm_route_flips(ref, got) -> tuple:
    """The share of (token, MoE layer) whose top-k expert set differs
    between two runs of the same calls: (prefill, decode)."""
    out = {True: [0, 0], False: [0, 0]}
    for a, b in zip(ref, got):
        d = (a.sort(-1).values != b.sort(-1).values).any(-1)
        acc = out[a.shape[0] == 1]
        acc[0] += int(d.sum())
        acc[1] += d.numel()
    return tuple(v[0] / max(1, v[1]) for v in (out[True], out[False]))


def lm_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def lm_moe_run(tag, cfg, seed, gate_prompts, wrappers, max_err, card, *,
               fp32: bool, w8: bool) -> dict:
    """One ``[lm moe ...]`` sub-phase: random params from ``seed`` on the
    card; the served run at the published capacity factor (launches
    counted, drop shares printed, decode dropping none, every logit
    finite); the no-drop served run (``capacity_factor = n_experts /
    top_k``: capacity >= every length) of the ``gate_prompts`` held
    decode = re-prefill (``lm_decode_gate``); the timings; with ``w8``
    the W8 twin: ``quantize_lm_params`` on the card, the bf16 params
    freed, the W8 engine served on the same requests and teacher-forced
    on the bf16 tokens, routed as the bf16 run routed (gated) and on its
    own routes (printed).  -> the served runs' launches, summed."""
    import numpy as np
    import torch
    from repro_torch.core.quantization import quantize_lm_params
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LM_MOE_PROMPTS]
    max_len = max(map(len, prompts)) + 64
    # warm-up (cuBLAS handles, first allocations): before any counter
    model.prefill(params, {"tokens": torch.as_tensor(
        prompts[0][:8], device="cuda")[None]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with lm_moe_probe() as calls, lm_route_probe() as routes:
        served, logits, launches, rec, secs, eng = lm_serve(
            tag, cfg, params, prompts, 8, max_len, wrappers)
    peak = torch.cuda.max_memory_allocated()
    param_bytes = lm_bytes(params)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in lm_kv_leaves(eng.caches))
    print(f"[{tag}] {cfg.name} {cfg.n_layers} layers at full width "
          f"({cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}) "
          f"{cfg.param_dtype}/{cfg.compute_dtype}, KV {cfg.kv_dtype}, "
          f"{sum(t.numel() for t in _leaves(params))} params: "
          f"{len(prompts)} requests x {LM_TOKENS} tokens in {secs:.3f} s "
          f"from 8 slots (max_len {max_len}); launches of the port's "
          f"kernels {sum(launches.values())}; peak allocated at init "
          f"{init_peak / 2**30:.3f} GiB, while serving {peak / 2**30:.3f} "
          f"GiB (params {param_bytes / 2**30:.3f}, KV caches "
          f"{kv_bytes / 2**30:.3f}) [{card}]")
    lm_drops(tag, cfg, calls)
    del calls
    for rid, lgs in logits.items():
        if not all(bool(torch.isfinite(lg.float()).all()) for lg in lgs):
            raise AssertionError(f"[{tag}] request {rid}: non-finite "
                                 f"logits")
    rel = LM_TOL if fp32 else LM_BF16_TOL
    nd = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    gp = [p for p in prompts if len(p) in gate_prompts]
    with lm_moe_probe() as calls:
        nd_served, nd_logits, nd_launches, *rest = lm_serve(
            tag + " no-drop", nd, params, gp, 8,
            max(map(len, gp)) + 64, wrappers)
        del rest                        # its engine holds the params
        dropped = sum(int((~v).sum()) for _, _, v in calls)
    if dropped:
        raise AssertionError(f"[{tag} no-drop] {dropped} assignments "
                             f"dropped at capacity factor "
                             f"{nd.capacity_factor:g}")
    del calls
    print(f"[{tag} no-drop] capacity factor {nd.capacity_factor:g} "
          f"(capacity >= every length): none dropped; prompts "
          f"{[len(p) for p in gp]}")
    lm_decode_gate(tag + " no-drop", build_model(nd), params, gp,
                   nd_served, nd_logits, rel, fp32)
    del nd_logits
    launches = {k: launches[k] + nd_launches[k] for k in launches}
    decode_tokens = sum(len(t) - 1 for t in served.values())
    eng.model = model                   # no recording from here on
    lm_decode_profile(tag, eng, decode_tokens,
                      secs - sum(rec["prefill_s"]), card)
    lm_prefill_profile(tag, cfg, model, params, prompts, rec["prefill_s"],
                       max_err, card, (4096,))
    if w8:
        t1 = time.perf_counter()
        qparams = quantize_lm_params(params)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t1
        q_bytes = lm_bytes(qparams)
        del params, eng
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag} w8] quantize_lm_params on the card in {q_s:.3f} s: "
              f"params {param_bytes / 2**30:.3f} GiB ({cfg.param_dtype}) "
              f"-> {q_bytes / 2**30:.3f} GiB (W8), "
              f"{param_bytes / q_bytes:.3f}x fewer bytes; the "
              f"{cfg.param_dtype} params freed [{card}]")
        torch.cuda.reset_peak_memory_stats()
        q_served, q_logits, q_launches, q_rec, q_secs, q_eng = lm_serve(
            tag + " w8", cfg, qparams, prompts, 8, max_len, wrappers)
        q_peak = torch.cuda.max_memory_allocated()
        for rid, lgs in q_logits.items():
            if not all(bool(torch.isfinite(lg.float()).all())
                       for lg in lgs):
                raise AssertionError(f"[{tag} w8] request {rid}: "
                                     f"non-finite logits")
        same = sum(a == b for rid in served
                   for a, b in zip(served[rid], q_served[rid]))
        print(f"[{tag} w8] served {len(prompts)} requests x {LM_TOKENS} "
              f"tokens in {q_secs:.3f} s, {same} of "
              f"{len(prompts) * LM_TOKENS} tokens equal to the "
              f"{cfg.param_dtype} run's; peak allocated "
              f"{q_peak / 2**30:.3f} GiB [{card}]")
        launches = {k: launches[k] + q_launches[k] for k in launches}
        with lm_route_probe() as q_routes:
            forced = lm_forced(cfg, qparams, prompts, max_len, served)
        free = lm_w8_rel(tag + " w8", logits, forced)
        flips = lm_route_flips(routes, q_routes)
        del forced, q_routes
        with lm_route_probe(routes):
            forced = lm_forced(cfg, qparams, prompts, max_len, served)
        held = lm_w8_rel(tag + " w8", logits, forced)
        del forced, routes
        print(f"[{tag} w8] W8 vs {cfg.param_dtype} logits teacher-forced "
              f"on the {cfg.param_dtype} tokens, relative L2 of the "
              f"{LM_TOKENS - 1} decode steps of the {len(prompts)} requests "
              f"(largest single step; prefill): each run routing its own "
              f"{free[0]:.4f} ({free[1]:.4f}; {free[2]:.4f}), with "
              f"{flips[0]:.4f} of the prefill's and {flips[1]:.4f} of the "
              f"decode's (token, layer) top-{cfg.top_k} sets differing; "
              f"the W8 run on the {cfg.param_dtype} run's routes "
              f"{held[0]:.4f} ({held[1]:.4f}; {held[2]:.4f}), limit "
              f"{LM_W8_TOL} [{card}]")
        if not held[0] < LM_W8_TOL:
            raise AssertionError(f"[{tag} w8] W8 decode logits on the "
                                 f"{cfg.param_dtype} routes {held[0]:.4f} "
                                 f"from {cfg.param_dtype} (relative L2), "
                                 f"limit {LM_W8_TOL}")
        E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        tmp = E * D * F * torch.empty((), dtype=cfg.cdtype).element_size()
        q_eng.model = model
        B = q_eng.cfg.max_slots
        tokens = torch.zeros((B, 1), dtype=torch.long, device="cuda")
        pos = torch.full((B,), 300, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.decode(qparams, q_eng.caches, tokens, pos)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - base
        print(f"[{tag} w8] dequant-on-use temporaries: each expert tensor "
              f"({E}, {D}, {F}) dequantized whole on every call, "
              f"{tmp / 2**30:.3f} GiB in {cfg.compute_dtype} (cast, then "
              f"scaled: two), 3 tensors a layer; one decode step peaks "
              f"{step_peak / 2**30:.3f} GiB beyond the params and caches "
              f"[{card}]")
        lm_decode_profile(tag + " w8", q_eng, decode_tokens,
                          q_secs - sum(q_rec["prefill_s"]), card)
        lm_prefill_profile(tag + " w8", cfg, model, qparams, prompts,
                           q_rec["prefill_s"], max_err, card, ())
        del qparams, q_eng, q_logits
    else:
        del params, eng, routes
    del logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] {time.perf_counter() - t0:.1f} s")
    return launches


def lm_slot_isolation(tag, seed, card) -> None:
    """A smoke-width Kimi-K2 (4 experts top-2, capacity factor 1.0) on the
    card from 16 slots, one prompt in every slot: each slot's tokens equal
    a batch-1 engine's on that prompt alone (up to the first token whose
    batch-1 top-2 margin is within ``LM_TOL``), and no row of a decode
    step's MoE output is zero.  JAX's batched call on 16 equal rows (one
    group: capacity 8 for 32 assignments) zeroes rows 8-15; one group per
    row keeps every row, equal to the batch-1 call."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.layers import moe as tmoe
    from repro_torch.models.lm import moe_cfg
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import Request
    cfg = smoke_variant(get_arch("kimi-k2-1t-a32b"))
    params = build_model(cfg).init(seed, device="cuda")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, 24)
    real, rows = tmoe.moe_dense, []

    def probe(p, x, c, groups=1):
        y, aux = real(p, x, c, groups)
        if groups > 1:
            rows.append(y.reshape(-1, y.shape[-1]).abs().amax(-1).min())
        return y, aux

    out = {}
    tmoe.moe_dense = probe
    try:
        for slots in (16, 1):
            eng, rec = lm_engine(cfg, params, slots, 64)
            done = eng.run([Request(rid=i, prompt=prompt,
                                    max_tokens=LM_TOKENS)
                            for i in range(slots)])
            out[slots] = ({r.rid: r.out_tokens for r in done},
                          lm_logits_by_request(rec, range(slots)))
    finally:
        tmoe.moe_dense = real
    one, one_logits = out[1][0][0], out[1][1][0]
    n = len(one)
    for i, lg in enumerate(one_logits):
        top2 = torch.topk(lg.float(), 2).values
        if (top2[0] - top2[1]).item() <= LM_TOL * max(
                1.0, lg.float().abs().max().item()):
            n = i + 1
            break
    for rid, toks in out[16][0].items():
        if toks[:n] != one[:n]:
            raise AssertionError(f"[{tag}] slot {rid}: tokens {toks} "
                                 f"differ from the batch-1 engine's {one}")
    smallest = min(r.item() for r in rows)
    if not smallest > 0:
        raise AssertionError(f"[{tag}] a decode step's MoE output has a "
                             f"zero row")
    mcfg = moe_cfg(cfg)
    p0 = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0])
          for k, v in params["blocks"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 1, cfg.d_model), generator=gen,
                    device="cuda").expand(16, 1, -1)
    y1, _ = tmoe.moe_dense(p0, x, mcfg)
    yg, _ = tmoe.moe_dense(p0, x, mcfg, groups=16)
    y_one, _ = tmoe.moe_dense(p0, x[:1], mcfg)
    z1 = [i for i in range(16) if not bool(y1[i].any())]
    zg = [i for i in range(16) if not bool(yg[i].any())]
    d = (yg - y_one).abs().max().item()
    if zg or not d <= 1e-5 * max(1.0, y_one.abs().max().item()):
        raise AssertionError(f"[{tag}] grouped rows {zg} zero, {d:.3e} "
                             f"from the batch-1 call")
    print(f"[{tag}] {cfg.name} smoke (4 experts top-2, capacity factor "
          f"{cfg.capacity_factor:g}) from 16 slots, one prompt of 24 "
          f"tokens in each: every slot's {LM_TOKENS} tokens equal the "
          f"batch-1 engine's (compared up to token {n}); the smallest "
          f"row max of a decode MoE output {smallest:.3e} (no zero row); "
          f"one MoE on 16 equal rows: one group (JAX's batched call) "
          f"zeroes rows {z1}, a group per row zeroes {zg} and is {d:.3e} "
          f"from the batch-1 call [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def lm_encdec_run(tag, cfg, seed, wrappers, card, *, fp32: bool) -> dict:
    """``[lm encdec ...]``: Seamless-M4T-large-v2 whole on the card,
    random params and frames from ``seed``.  At each encoder length, B =
    ``LM_ENCDEC_BATCH``, the encoder timed, then 32 greedy decode steps
    from a BOS of 0 against ``decode_train`` + ``lm_logits_head`` over the
    tokens so far: at fp32 with the state's caches in fp32
    (``init_encdec_state(..., dtype=torch.float32)``) within ``LM_TOL`` *
    max(1, max|logit|), top-1 equal past that margin; the registry's
    prefill (bf16 state) within ``LM_BF16_TOL`` * max|logit|; all finite.
    The counters are 0 before the params are made and must be 0 after
    (the path runs no kernel of the port).  -> the launches."""
    import torch
    from repro_torch.models import encdec as ted
    from repro_torch.models.lm import lm_logits_head
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, device="cuda")
    B, T = LM_ENCDEC_BATCH, LM_ENCDEC_STEPS
    print(f"[{tag}] {cfg.name} whole ({cfg.n_layers} + {cfg.dec_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}) "
          f"{cfg.param_dtype}/{cfg.compute_dtype}: "
          f"{sum(t.numel() for t in _leaves(params))} params, "
          f"{lm_bytes(params) / 2**30:.3f} GiB [{card}]")
    for S in LM_ENCDEC_FRAMES:
        frames = torch.randn((B, S, cfg.d_model), generator=gen,
                             device="cuda")
        ted.encode(params, frames, cfg)                  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        memory = ted.encode(params, frames, cfg)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t1
        enc_ms = graph_ms(lambda: ted.encode(params, frames, cfg))  # noqa: B023
        paths = [("registry bf16 state", lambda: model.prefill(  # noqa: B023
            params, {"frames": frames, "tokens": torch.zeros(  # noqa: B023
                (B, T), dtype=torch.long, device="cuda")}),
            LM_BF16_TOL, False)]
        if fp32:
            paths.insert(0, ("fp32 state", lambda: ted.init_encdec_state(
                params, frames, cfg, T, dtype=torch.float32),  # noqa: B023
                LM_TOL, True))
        for name, make, rel, tight in paths:
            state = make()
            cross = sum(t.numel() * t.element_size()
                        for t in _leaves(state["cross"]))
            seq = [torch.zeros((B, 1), dtype=torch.long, device="cuda")]
            worst, flips = 0.0, 0
            for t in range(T):
                logits, state = model.decode(params, state, seq[-1], t)
                h = ted.decode_train(params, torch.cat(seq, 1), memory, cfg)
                ref = lm_logits_head(params, h[:, -1:], cfg)[:, 0].float()
                got = logits.float()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"[{tag}] {S} frames, {name}, "
                                         f"step {t}: non-finite logits")
                d = (got - ref).abs().max().item()
                top = ref.abs().max().item()
                lim = rel * (max(1.0, top) if tight else top)
                if not d <= lim:
                    raise AssertionError(
                        f"[{tag}] {S} frames, {name}, step {t}: logits "
                        f"{d:.3e} from decode_train (max|ref| {top:.3e}), "
                        f"above {lim:.3e}")
                for b in range(B if tight else 0):
                    if int(got[b].argmax()) == int(ref[b].argmax()):
                        continue
                    top2 = torch.topk(ref[b], 2).values
                    if (top2[0] - top2[1]).item() > lim:
                        raise AssertionError(
                            f"[{tag}] {S} frames, step {t}, row {b}: "
                            f"top-1 differs past the margin")
                    flips += 1
                worst = max(worst, d / top)
                seq.append(logits.argmax(-1, keepdim=True))

            pos = torch.full((B,), T - 1, device="cuda")

            def step():
                return model.decode(params, state, seq[-1], pos)  # noqa: B023
            h_ms, d_ms = host_ms(step), graph_ms(step)
            print(f"[{tag}] {S} frames x {B}, {name} (cross K/V "
                  f"{cross / 2**30:.3f} GiB): {T} greedy steps vs "
                  f"decode_train, max|d| / max|ref| {worst:.3e} (limit "
                  f"{rel:g} of {'max(1, max|ref|)' if tight else 'max|ref|'}"
                  + (f", top-1 equal but {flips} within the margin"
                     if tight else ", every logit finite")
                  + f"); one decode step: host {h_ms:.3f} ms to enqueue, "
                  f"device {d_ms:.3f} ms (graph replay) [{card}]")
            del state
        print(f"[{tag}] {S} frames x {B}: encoder {enc_s * 1e3:.3f} ms "
              f"(host, synchronized), {enc_ms:.3f} ms (graph replay) "
              f"[{card}]")
        del frames, memory
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"[{tag}] launches {launches}, expected none")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] peak allocated {peak / 2**30:.3f} GiB; launches of the "
          f"port's kernels 0; {time.perf_counter() - t0:.1f} s [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lm_moe_phase(seed, wrappers, max_err, card) -> dict:
    """``[lm moe ...]`` and ``[lm encdec ...]``: Grok-1 and Kimi-K2 at
    their published widths (depth cut to fit the card), their W8 twins,
    slot isolation, and Seamless-M4T-large-v2 whole.  -> the launches of
    the driven runs, summed (the path runs no kernel of the port)."""
    import torch
    from repro_torch.configs import get_arch
    print(f"[lm moe] {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated as the phase starts [{card}]")
    fp32 = dict(param_dtype="float32", compute_dtype="float32",
                kv_dtype="float32")
    grok, kimi, seamless = (get_arch(n) for n in (
        "grok-1-314b", "kimi-k2-1t-a32b", "seamless-m4t-large-v2"))
    runs = [
        lm_moe_run("lm moe grok fp32 2 layers",
                   grok.scaled(n_layers=2, **fp32), seed, LM_GROK_GATE,
                   wrappers, max_err, card, fp32=True, w8=False),
        lm_moe_run("lm moe grok bf16 4 layers", grok.scaled(n_layers=4),
                   seed + 1, LM_GROK_GATE, wrappers, max_err, card,
                   fp32=False, w8=True),
        lm_moe_run("lm moe kimi bf16 1 layer", kimi.scaled(n_layers=1),
                   seed + 2, LM_KIMI_GATE, wrappers, max_err, card,
                   fp32=False, w8=True)]
    lm_slot_isolation("lm moe slots", seed + 3, card)
    runs += [lm_encdec_run("lm encdec fp32", seamless.scaled(
                 param_dtype="float32", compute_dtype="float32"),
                 seed + 4, wrappers, card, fp32=True),
             lm_encdec_run("lm encdec bf16", seamless, seed + 5, wrappers,
                           card, fp32=False)]
    return {k: sum(r[k] for r in runs) for k in wrappers}


# the [train] phase (6f): Zamba2-1.2B (relu_linear) trained at published
# width and depth on the port's synthetic data; the gradient and flash
# gates at published width with depth cut
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 30
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 10, 25
TRAIN_WARMUP = 10
TRAIN_DROP = 0.1              # last-5 mean loss below the first-5 mean by
TRAIN_GRAD_SEQ = 512          # [train grad]: one Zamba2 group, S = 512
TRAIN_FLASH_SEQS = (2048, 1536)   # [train flash]: on and off the 1024 chunk
TRAIN_GRAD_TOL = 1e-4         # per leaf, of max(1, max|g|)
# [train grad control]: a scan's output times (1 + eps) for each eps, the
# gate required to fail from the scan's own eps on (below it, printed)
TRAIN_CONTROL_EPS = (1e-3, 1e-2, 1e-1)
TRAIN_CONTROL = {"ssd_chunked": 1e-2, "relu_attn_causal": 1e-1}
# the [dist] phase (6g): 6f's Zamba2 run through the sharded Trainer on a
# world of one NCCL rank, its first DIST_STEPS steps
DIST_STEPS = 5
DIST_LOSS_TOL = 1e-5          # of |loss|, against 6f's same steps


def train_scan_calls(cfg) -> dict:
    """Launches of each scan per training step: ``lm_scan_calls`` once in
    the forward and, under ``remat``, once more in the backward's
    recompute of each block (the backward itself recomputes through the
    plain versions and launches nothing)."""
    per = 2 if cfg.remat else 1
    return {k: v * per for k, v in lm_scan_calls(cfg).items()}


def train_batch(cfg, seed, batch, seq):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                             device="cuda") for k in ("tokens", "targets")}


def train_grads(model, params, batch):
    """-> (loss, {path: gradient}) of ``model.loss``, and the peak memory
    of the pass, in GiB."""
    import torch
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.launch.steps import value_and_grad
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = value_and_grad(model.loss)(params, batch)
    torch.cuda.synchronize()
    return (loss, dict(flatten_with_paths(grads)),
            torch.cuda.max_memory_allocated() / 2**30)


def train_grad_err(loss, grads, ref_loss, ref_grads) -> dict:
    """The distances the gradient gate reads: the loss's, over max(1,
    |ref|); per leaf max|d| over max(1, max|ref|) (``gate``, the worst
    leaf) and over its own max|ref| (``own``, the worst leaf), each with
    its leaf and that leaf's max|ref|; and whether every leaf is
    finite."""
    import torch
    out = {"loss": abs(loss.item() - ref_loss.item())
           / max(1.0, abs(ref_loss.item())),
           "gate": (0.0, None, 0.0), "own": (0.0, None, 0.0),
           "finite": True}
    for path, ref in ref_grads.items():
        g = grads[path]
        out["finite"] &= bool(torch.isfinite(g).all())
        d = (g.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        for key, r in (("gate", d / max(1.0, top)),
                       ("own", d / top if top else (math.inf if d else 0.0))):
            if r > out[key][0]:
                out[key] = (r, path, top)
    return out


def train_grad_fails(err) -> bool:
    return not (err["finite"] and err["loss"] <= TRAIN_GRAD_TOL
                and err["gate"][0] <= TRAIN_GRAD_TOL)


def train_grad_text(err) -> str:
    return (f"loss {err['loss']:.3e} of max(1, |ref|); worst leaf "
            f"{err['gate'][0]:.3e} of max(1, max|ref|) at {err['gate'][1]} "
            f"(max|ref| {err['gate'][2]:.3e}); worst of its own max|ref| "
            f"{err['own'][0]:.3e} at {err['own'][1]} (max|ref| "
            f"{err['own'][2]:.3e})")


def train_grad_gate(tag, loss, grads, ref_loss, ref_grads) -> dict:
    """Every leaf's gradient finite and within ``TRAIN_GRAD_TOL`` *
    max(1, max|ref|) of the reference's, the losses within it of max(1,
    |ref|) too; -> ``train_grad_err``."""
    err = train_grad_err(loss, grads, ref_loss, ref_grads)
    print(f"[{tag}] loss {loss.item():.6f} vs {ref_loss.item():.6f}; "
          f"{len(ref_grads)} gradient leaves; {train_grad_text(err)}")
    if train_grad_fails(err):
        raise AssertionError(f"[{tag}] gradients from the reference beyond "
                             f"{TRAIN_GRAD_TOL} of max(1, max|ref|)")
    return err


@contextlib.contextmanager
def scan_broken(name: str, eps=None):
    """While open, the LM layers' calls of scan ``name`` are made wrong:
    the kernel's output times (1 + ``eps``), or with ``eps`` None the
    kernel launched outside its autograd Function (no gradient flows
    back through the scan: what a bare launch gives)."""
    from repro_torch.kernels.relu_attn import ops as relu_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    mod = relu_ops if name == "relu_attn_causal" else ssd_ops
    attr = name if eps is not None else "with_recompute_grad"
    fn = getattr(mod, attr)
    setattr(mod, attr, (lambda *a, **k: fn(*a, **k) * (1 + eps))
            if eps is not None else
            (lambda kernel, plain, *a, **k: kernel(*a, **k)))
    try:
        yield
    finally:
        setattr(mod, attr, fn)


def train_grad_check(tag, seed, wrappers, card) -> dict:
    """``[train grad zamba2]``: one Zamba2 group (6 Mamba-2 layers and
    the shared block, relu_linear) at published width, fp32, S =
    ``TRAIN_GRAD_SEQ``: ``lm_loss``'s gradients through the two kernels
    (their autograd Functions) against ``build_model(cfg,
    reference=True)``'s (the plain scans, autograd through them).  The
    counters are set to 0 just before the kernels' pass and read just
    after: each scan exactly ``train_scan_calls``.  Then the controls,
    each scan in turn made wrong (``scan_broken``): its output off by
    each of ``TRAIN_CONTROL_EPS`` and its launch outside the autograd
    Function; the same gate must fail (or the pass raise) for the bare
    launch and from ``TRAIN_CONTROL[name]`` on, and below it the result
    is printed only.  -> the kernels' pass's launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    cfg = get_arch("zamba2-1.2b").scaled(
        attn_backend="relu_linear", n_layers=6, param_dtype="float32",
        compute_dtype="float32")
    params = build_model(cfg).init(seed, device="cuda")
    batch = train_batch(cfg, seed, 2, TRAIN_GRAD_SEQ)
    ref_loss, ref_grads, ref_peak = train_grads(
        build_model(cfg, reference=True), params, batch)
    model = build_model(cfg)
    for w in wrappers.values():
        w.launches = 0
    loss, grads, peak = train_grads(model, params, batch)
    launches = {k: w.launches for k, w in wrappers.items()}
    want = dict.fromkeys(wrappers, 0) | train_scan_calls(cfg)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    print(f"[{tag}] {cfg.name} relu_linear fp32, 6 + 1 blocks, B = 2, S = "
          f"{TRAIN_GRAD_SEQ}: launches {train_scan_calls(cfg)} "
          f"(remat: each block's forward twice); peak {peak:.3f} GiB, "
          f"plain scans {ref_peak:.3f} GiB [{card}]")
    train_grad_gate(tag, loss, grads, ref_loss, ref_grads)
    del grads
    for name in LM_SCANS:
        for eps in TRAIN_CONTROL_EPS + (None,):
            what = (f"output * (1 + {eps})" if eps is not None else
                    "launched outside its autograd Function")
            try:
                with scan_broken(name, eps):
                    loss, grads, _ = train_grads(model, params, batch)
            except RuntimeError as e:
                # a param that reaches the loss only through the scan
                # gets no gradient: ``value_and_grad`` raises
                print(f"[{tag} control] {name} {what}: the pass raises "
                      f"({str(e).splitlines()[0]})")
                continue
            err = train_grad_err(loss, grads, ref_loss, ref_grads)
            fails = train_grad_fails(err)
            print(f"[{tag} control] {name} {what}: {train_grad_text(err)}; "
                  f"the gate {'fails' if fails else 'passes'} it")
            if not fails and (eps is None or eps >= TRAIN_CONTROL[name]):
                raise AssertionError(f"[{tag} control] the gradient gate "
                                     f"passes {name} {what}")
            del grads
    del params, ref_grads
    return launches


def train_flash_check(tag, seed, card) -> None:
    """``[train flash granite-3-2b]``: published width, fp32, depth cut
    to 4 of 40: ``flash_vjp=True`` against ``False`` on one step's loss
    and every gradient, at S in ``TRAIN_FLASH_SEQS`` (1536: one chunk,
    as JAX's); the peak memory of each pass printed."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=4, param_dtype="float32", compute_dtype="float32")
    params = build_model(cfg).init(seed, device="cuda")
    for seq in TRAIN_FLASH_SEQS:
        batch = train_batch(cfg, seed + seq, 1, seq)
        ref_loss, ref_grads, ref_peak = train_grads(build_model(cfg),
                                                    params, batch)
        loss, grads, peak = train_grads(
            build_model(cfg.scaled(flash_vjp=True)), params, batch)
        print(f"[{tag}] {cfg.name} fp32, 4 layers, B = 1, S = {seq}: peak "
              f"{peak:.3f} GiB with flash_vjp, {ref_peak:.3f} GiB without "
              f"[{card}]")
        train_grad_gate(f"{tag} S={seq}", loss, grads, ref_loss, ref_grads)
        del grads, ref_grads
    del params


def train_run(tag, cfg, seed, ckpt_dir, wrappers):
    """The ``Trainer`` run of ``cfg`` on the port's synthetic data
    (``TRAIN_BATCH`` x ``TRAIN_SEQ``, V = the arch's vocab), cosine
    schedule with ``TRAIN_WARMUP`` warmup steps over ``TRAIN_STEPS``,
    checkpoints every ``TRAIN_CKPT_EVERY`` steps and one failure at
    ``TRAIN_FAIL_AT``.  The counters are set to 0 just before ``run``
    and read just after.  -> (trainer, its result, launches, peak GiB,
    seconds)."""
    import torch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.trainer import (
        Trainer, TrainerConfig, make_failure_hook)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    tcfg = TrainerConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        ckpt_dir=ckpt_dir, ckpt_keep=2, log_every=10, seed=seed,
        schedule=ScheduleConfig(kind="cosine", warmup_steps=TRAIN_WARMUP,
                                total_steps=TRAIN_STEPS))
    tr = Trainer(cfg, data, tcfg, device="cuda",
                 failure_hook=make_failure_hook((TRAIN_FAIL_AT,)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"[{tag}] non-finite loss: {out['losses']}")
    return tr, out, launches, peak, secs


def train_step_times(tag, tr, out, card) -> dict:
    """Two more steps from the run's final state, outside the trainer
    and its counted run.  The first keeps the inputs of each scan's
    first call (``lm_scan_probe``); the second is timed: the host's time
    to enqueue it, its span on the device (CUDA events recorded before
    its first launch and after its last: any idle gap while the host
    enqueues is inside), and its wall time to a synchronize.  -> the
    probe's calls."""
    import torch
    params, opt = out["params"], out["opt"]
    batch = tr.data.host_batch(TRAIN_STEPS, 0, 1)
    with lm_scan_probe() as calls:
        tr._step_fn(params, opt, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = tr._step_fn(params, opt, batch, TRAIN_STEPS)
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    del res
    print(f"[{tag}] one step outside the trainer: host enqueue "
          f"{host:.3f} ms, device span {start.elapsed_time(end):.3f} ms, "
          f"wall {wall:.3f} ms [{card}]")
    return calls


def train_phase(seed, wrappers, max_err, card, ref=None) -> dict:
    """``[train ...]``: the gradient gate and its control, the flash
    gate, then Zamba2-1.2B (relu_linear, bf16 params, the default AdamW)
    trained at published width and depth for ``TRAIN_STEPS`` steps with
    checkpoints every ``TRAIN_CKPT_EVERY`` steps and one failure at
    ``TRAIN_FAIL_AT``, and each scan call of a step held against its
    plain version at the step's shapes (``[train kernel]``).  -> the
    launches of the driven runs, summed; ``ref`` (a dict) gets the
    run's first losses, median tokens/s and peak (6g's reference)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.common.tree import param_count
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import default_opt_cfg
    print(f"[train] {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated as the phase starts [{card}]")
    runs = [train_grad_check("train grad zamba2", seed, wrappers, card)]
    train_flash_check("train flash granite-3-2b", seed + 1, card)
    gc.collect()
    torch.cuda.empty_cache()

    tag = "train zamba2 relu_linear"
    cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
    per_step = train_scan_calls(cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tr, out, launches, peak, secs = train_run(tag, cfg, seed + 2, root,
                                                  wrappers)
        runs.append(launches)
        # steps 0..24, the failure, steps 20..29 again from the checkpoint
        losses = out["losses"]
        resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
        ran = TRAIN_FAIL_AT + TRAIN_STEPS - resumed
        want = dict.fromkeys(wrappers, 0) | {
            k: v * ran for k, v in per_step.items()}
        if len(losses) != ran or launches != want:
            raise AssertionError(f"[{tag}] {len(losses)} steps run, "
                                 f"launches {launches}, expected {ran} "
                                 f"steps, {want} ({per_step} a step)")
        first5, last5 = (statistics.mean(losses[:5]),
                         statistics.mean(losses[-5:]))
        tok_s = [TRAIN_BATCH * TRAIN_SEQ / s
                 for s in tr.step_seconds[:TRAIN_FAIL_AT]]
        if ref is not None:
            ref.update(losses=losses[:DIST_STEPS], peak=peak,
                       tok_s=statistics.median(tok_s))
        n = param_count(out["params"])
        print(f"[{tag}] {cfg.name} {cfg.param_dtype}/{cfg.compute_dtype}, "
              f"{n} params, AdamW {default_opt_cfg(cfg)}, B = "
              f"{TRAIN_BATCH}, S = {TRAIN_SEQ}, V = {cfg.vocab}: {ran} "
              f"steps run in {secs:.3f} s, {sum(tr.step_seconds):.3f} s of "
              f"it in the steps (the rest: two inits, 3 checkpoints of the "
              f"full state and one restore); tokens/s per step over steps "
              f"0..{TRAIN_FAIL_AT - 1}: median "
              f"{statistics.median(tok_s):.1f} (steps 1+: min "
              f"{min(tok_s[1:]):.1f}, max {max(tok_s[1:]):.1f}); peak "
              f"{peak:.3f} GiB; launches a step {per_step} [{card}]")
        print(f"[{tag}] losses: first-5 mean {first5:.4f}, last-5 mean "
              f"{last5:.4f} (steps {TRAIN_STEPS - 5}..{TRAIN_STEPS - 1}; "
              f"optimal estimate {tr.data.optimal_loss_estimate():.4f}); "
              + " ".join(f"{x:.4f}" for x in losses))
        if not last5 < first5 - TRAIN_DROP:
            raise AssertionError(f"[{tag}] last-5 mean {last5:.4f} not "
                                 f"below first-5 {first5:.4f} - "
                                 f"{TRAIN_DROP}")
        last = latest_step(root)
        again = losses[TRAIN_FAIL_AT:TRAIN_FAIL_AT + TRAIN_FAIL_AT - resumed]
        before = losses[resumed:TRAIN_FAIL_AT]
        print(f"[{tag}] failure at step {TRAIN_FAIL_AT}: resumed from step "
              f"{resumed}, latest checkpoint {last}; steps {resumed}.."
              f"{TRAIN_FAIL_AT - 1} after the resume against before the "
              f"failure: " + " ".join(f"{a:.6f}/{b:.6f}"
                                      for a, b in zip(again, before)))
        if last != TRAIN_STEPS or again != before:
            raise AssertionError(f"[{tag}] latest checkpoint {last}; the "
                                 f"resumed steps' losses differ from the "
                                 f"same steps' before the failure")
        calls = train_step_times(tag, tr, out, card)
        del tr, out
        gc.collect()
        torch.cuda.empty_cache()
        for (name, _), (a, k) in sorted(calls.items()):
            case = lm_scan_case(name, a, k, f"{tag} step "
                                f"{tuple(a[0].shape)} {str(a[0].dtype)[6:]}")
            err, ref_max, *times = measure(case, False, 5, 3)
            max_err[name] = max(max_err[name], err)
            kernel_line("train kernel", case, "", err, ref_max, *times)
        if {name for name, _ in calls} != set(LM_SCANS):
            raise AssertionError(f"[{tag}] a step called {sorted(calls)}")
        del calls
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(r[k] for r in runs) for k in wrappers}


def dist_collectives(mesh, card) -> None:
    """``[dist collectives]``: each collective of
    ``distributed/collectives.py`` at axis size 1 on CUDA tensors returns
    what its ``jax.lax`` counterpart returns there (its input), and
    ``compressed_psum`` of a (4096, 4096) fp32 tensor equals its formula
    bit for bit."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.optim.compression import compressed_psum
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((8, 12), generator=g, device="cuda")
    checked = []
    for axes in ("data", "model", ("data", "model")):
        if C.axis_index(axes, mesh) != 0 or C.axis_size(axes, mesh) != 1:
            raise AssertionError(f"[dist collectives] axis {axes}: index "
                                 f"{C.axis_index(axes, mesh)}, size "
                                 f"{C.axis_size(axes, mesh)}")
        outs = {"psum": C.psum(x, axes, mesh), "pmean": C.pmean(x, axes, mesh),
                "pmax": C.pmax(x, axes, mesh)}
        for ax in (0, 1):
            outs[f"all_gather axis {ax}"] = C.all_gather(x, axes, axis=ax,
                                                         mesh=mesh)
        for name, y in outs.items():
            if not torch.equal(y, x):
                raise AssertionError(f"[dist collectives] {name} over "
                                     f"{axes} is not its input")
            checked.append(f"{name}/{axes}")
    for name, y in (("all_to_all", C.all_to_all(x, "model", 0, 1,
                                                mesh=mesh)),
                    ("ppermute [(0, 0)]", C.ppermute(x, "model", [(0, 0)],
                                                     mesh=mesh))):
        if not torch.equal(y, x):
            raise AssertionError(f"[dist collectives] {name} is not its "
                                 f"input")
        checked.append(name)
    big = torch.randn((4096, 4096), generator=g, device="cuda")
    one = torch.ones((), device="cuda")
    scale = torch.clamp(big.abs().amax() / (127.0 * one), min=1e-30)
    want = (torch.round(big / scale).to(torch.int32).float() * scale) / one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_psum(big, "data", mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, want):
        raise AssertionError("[dist collectives] compressed_psum differs "
                             "from its formula")
    print(f"[dist collectives] world 1 on NCCL: {len(checked)} collective "
          f"calls equal their input ({', '.join(checked)}); compressed_psum "
          f"(4096, 4096) fp32 = its formula bit for bit, max|err| vs g "
          f"{float((got - big).abs().max()):.3e} (scale "
          f"{float(scale):.3e}), {ms:.3f} ms host to a sync [{card}]")


def dist_phase(seed, wrappers, max_err, card, ref) -> dict:
    """``[dist ...]``: a world of one NCCL rank in this process (a
    ``HashStore``), its (1, 1) ``("data", "model")`` mesh; the
    collectives at axis size 1, then 6f's Zamba2-1.2B run (the same
    config, data, seed and schedule) for ``DIST_STEPS`` steps through
    ``Trainer(mesh=)``: the sharded step (``make_train_step(ctx=)``) on
    the rank's blocks.  Gates: each loss within ``DIST_LOSS_TOL`` *
    |loss| of 6f's same step, exactly 12 ``relu_attn_causal`` and 76
    ``ssd_chunked`` launches a step, and each scan's call of one more
    step held against its plain version at the step's shapes (``[dist
    kernel]``).  Printed beside 6f's: tokens/s, peak memory, whether the
    losses are bit-equal.  -> the launches of the driven run."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        dist_collectives(mesh, card)
        tag = "dist zamba2 1x1"
        cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
        per_step = train_scan_calls(cfg)
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed + 2)
        tcfg = TrainerConfig(
            total_steps=DIST_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=root,
            log_every=10, seed=seed + 2,
            schedule=ScheduleConfig(kind="cosine",
                                    warmup_steps=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS))
        tr = Trainer(cfg, data, tcfg, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = tr.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = dict.fromkeys(wrappers, 0) | {
            k: v * DIST_STEPS for k, v in per_step.items()}
        losses = out["losses"]
        if launches != want or len(losses) != DIST_STEPS:
            raise AssertionError(f"[{tag}] {len(losses)} steps, launches "
                                 f"{launches}, expected {want}")
        tok_s = statistics.median(TRAIN_BATCH * TRAIN_SEQ / s
                                  for s in tr.step_seconds)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        print(f"[{tag}] {cfg.name} on a {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names} NCCL mesh, sharded step, B = "
              f"{TRAIN_BATCH}, S = {TRAIN_SEQ}: {DIST_STEPS} steps in "
              f"{secs:.3f} s; tokens/s per step median {tok_s:.1f} (6f: "
              f"{ref['tok_s']:.1f}); peak {peak:.3f} GiB (6f's run: "
              f"{ref['peak']:.3f}); launches a step {per_step} [{card}]")
        print(f"[{tag}] losses against 6f's steps 0..{DIST_STEPS - 1}: "
              + " ".join(f"{a:.6f}/{b:.6f}"
                         for a, b in zip(losses, ref["losses"]))
              + f"; max relative {max(rel):.3e}; bit-equal "
              f"{losses == ref['losses']}")
        if max(rel) > DIST_LOSS_TOL:
            raise AssertionError(f"[{tag}] losses off 6f's by {max(rel)}")
        params, opt = out["params"], out["opt"]
        batch = tr.data.host_batch(DIST_STEPS, 0, 1)
        with lm_scan_probe() as calls:
            tr._step_fn(params, opt, batch, DIST_STEPS)
        torch.cuda.synchronize()
        del tr, out, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        for (name, _), (a, k) in sorted(calls.items()):
            case = lm_scan_case(name, a, k, f"{tag} step "
                                f"{tuple(a[0].shape)} {str(a[0].dtype)[6:]}")
            err, ref_max, *times = measure(case, False, 5, 3)
            max_err[name] = max(max_err[name], err)
            kernel_line("dist kernel", case, "", err, ref_max, *times)
        if {name for name, _ in calls} != set(LM_SCANS):
            raise AssertionError(f"[{tag}] a step called {sorted(calls)}")
        del calls
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the [dryrun] phase (6h): the dry-run's prediction for 6f's Zamba2 step
# against the card, and the sharded prefill / decode steps on a (1, 1)
# mesh against the unsharded ones
DRYRUN_STEPS = 3              # the first a warm-up
DRYRUN_PEAK_TOL = 0.10        # measured peak within this share of the
DRYRUN_ALLOC = 512            # prediction; the allocator's rounding
DRYRUN_PROMPT = 4096          # Zamba2's prefill: 8 prompts of this length
DRYRUN_DECODE = 8             # Zamba2's decode steps
DRYRUN_GROK_PROMPT = 256      # Grok-1's prompts (8 of them)
DRYRUN_GROK_DECODE = 32
DRYRUN_GROK_TOL = 1e-2        # of max|logit|, Grok-1's decode

DRYRUN_PREDICT = """
import json, sys, time
sys.path.insert(0, {src!r})
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.analysis import RooflineTerms
from repro_torch.launch.cost import _tensors, measure_step
from repro_torch.launch.dryrun import build_cell, fake_world
from repro_torch.launch.mesh import make_mesh
t0 = time.perf_counter()
cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
with fake_world({world}):
    mesh = make_mesh({mesh}, ("data", "model"), device="cpu")
    fn, args, ctx, meta = build_cell(
        cfg, ShapeSpec("train", {seq}, {batch}, "train"), mesh)
    ts = _tensors(args)
    c = measure_step(fn, *args, mesh=mesh)
t = RooflineTerms(c.flops, c.bytes, c.collective_bytes)
print(json.dumps({{"args": c.argument_bytes, "n_args": len(ts),
                  "args_rounded": sum(-(-t.numel() * t.element_size()
                                        // {alloc}) * {alloc} for t in ts),
                  "temp": c.peak_bytes, "flops": c.flops,
                  "dot_flops": c.dot_flops, "bytes": c.bytes,
                  "coll": c.collective_bytes, "coll_by_kind": c.coll_by_kind,
                  "kernels": c.kernels, "roofline": t.to_dict(),
                  "bound_s": t.bound_s, "off_meta_ops": c.off_meta_ops,
                  "off_meta": c.off_meta,
                  "seconds": time.perf_counter() - t0}}))
"""


def dryrun_predict(card) -> dict:
    """``[dryrun predict zamba2 1x1]``: a child process (a fake process
    group of one rank, every tensor on meta) builds 6f's Zamba2 train
    cell with ``dryrun.build_cell`` on a (1, 1) mesh and counts its
    sharded step with ``cost.measure_step``.  -> its numbers."""
    code = DRYRUN_PREDICT.format(src=SRC, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                                 alloc=DRYRUN_ALLOC, world=1, mesh=(1, 1))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=False)
    if run.returncode != 0:
        raise AssertionError(f"[dryrun predict] the child failed: "
                             f"{run.stderr[-3000:]}")
    pred = json.loads(run.stdout.strip().splitlines()[-1])
    r = pred["roofline"]
    print(f"[dryrun predict zamba2 1x1] computed on meta in a child process "
          f"({pred['seconds']:.1f} s in the child, "
          f"{time.perf_counter() - t0:.1f} s with its start), not measured: "
          f"B = {TRAIN_BATCH}, S = {TRAIN_SEQ}: argument bytes "
          f"{pred['args']} ({pred['n_args']} tensors, {pred['args_rounded']} "
          f"rounded to {DRYRUN_ALLOC} B each), peak of the step's own "
          f"tensors {pred['temp']} (peak {pred['args'] + pred['temp']} "
          f"with the arguments), FLOPs {pred['flops']:.6e} (matmuls "
          f"{pred['dot_flops']:.6e}), bytes {pred['bytes']:.6e}, "
          f"collective bytes {pred['coll']:.6e} {pred['coll_by_kind']}, "
          f"kernel calls {pred['kernels']}, ops off meta "
          f"{pred['off_meta_ops']}")
    print(f"[dryrun predict zamba2 1x1] H100 roofline: compute "
          f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, "
          f"collective {r['collective_s']:.6f} s, dominant {r['dominant']}, "
          f"bound {pred['bound_s']:.6f} s [{card}]")
    if pred["off_meta_ops"]:
        raise AssertionError(f"[dryrun predict] ops ran off the meta "
                             f"device: {pred['off_meta']}")
    return pred


def dryrun_check(seed, wrappers, card, mesh, pred) -> dict:
    """``[dryrun check zamba2 1x1]``: the predicted step on the card, on
    ``mesh`` (the NCCL (1, 1) mesh): params, AdamW state and one batch
    built as the dry-run builds them, then ``DRYRUN_STEPS`` steps of
    ``make_train_step(ctx=, specs=)``, the first a warm-up.  Gates: the
    argument bytes (requested of the allocator) equal the prediction up
    to the allocator's rounding of each tensor to 512 B;
    ``max_memory_allocated`` over the steps
    within ``DRYRUN_PEAK_TOL`` of the predicted peak; ``HBM_BYTES`` the
    card's memory; 12 ``relu_attn_causal`` and 76 ``ssd_chunked``
    launches a step, as the prediction's kernel calls.  -> the steps'
    launches and the trained blocks."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.analysis import HBM_BYTES
    from repro_torch.launch.steps import default_opt_cfg, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    tag = "dryrun check zamba2 1x1"
    cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
    per_step = train_scan_calls(cfg)
    if {k: v["calls"] for k, v in pred["kernels"].items()} != per_step:
        raise AssertionError(f"[{tag}] predicted kernel calls "
                             f"{pred['kernels']}, a step launches "
                             f"{per_step}")
    total = torch.cuda.get_device_properties(0).total_memory
    if HBM_BYTES != total:
        raise AssertionError(f"[{tag}] analysis.HBM_BYTES {HBM_BYTES}, the "
                             f"card has {total}")
    model = build_model(cfg)
    ctx = make_ctx(mesh, {"sp": ("model",)})
    opt_cfg = default_opt_cfg(cfg)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    r0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    params = model.init(seed, "cuda")
    specs = match_partition_rules(LM_RULES, params, ctx)
    blocks = shard_tree(params, specs, mesh)
    del params
    opt = adamw_init(blocks, opt_cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "targets")}
    torch.cuda.synchronize()
    # the bytes asked for: the allocator hands out a cached block whole
    # when less than 1 MiB of it would be left, so the allocated bytes
    # can exceed them by up to that much a tensor
    args = torch.cuda.memory_stats()["requested_bytes.all.current"] - r0
    args_alloc = torch.cuda.memory_allocated() - m0
    step = make_train_step(model, opt_cfg, ctx=ctx, specs=specs)
    for w in wrappers.values():
        w.launches = 0
    secs, losses = [], []
    for i in range(DRYRUN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blocks, opt, loss = step(blocks, opt, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - m0
    peak_req = torch.cuda.memory_stats()["requested_bytes.all.peak"] - r0
    launches = {k: w.launches for k, w in wrappers.items()}
    want = dict.fromkeys(wrappers, 0) | {
        k: v * DRYRUN_STEPS for k, v in per_step.items()}
    pred_peak = pred["args"] + pred["temp"]
    step_s = statistics.median(secs[1:])
    print(f"[{tag}] measured on the card: {DRYRUN_STEPS} steps of the "
          f"sharded step (B = {TRAIN_BATCH}, S = {TRAIN_SEQ}), losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; argument bytes "
          f"requested {args}, allocated {args_alloc} (predicted "
          f"{pred['args']}, {pred['args_rounded']} rounded; requested "
          f"{args - pred['args']:+d} B over {pred['n_args']} tensors); "
          f"peak allocated {peak} B = {peak / 2**30:.3f} GiB over steps "
          f"2-{DRYRUN_STEPS}, requested {peak_req} (predicted {pred_peak} "
          f"B = {pred_peak / 2**30:.3f} GiB: measured / predicted "
          f"{peak / pred_peak:.4f}, requested {peak_req / pred_peak:.4f}); "
          f"launches {launches}; HBM_BYTES = total_memory = {total} "
          f"[{card}]")
    print(f"[{tag}] step time median {step_s * 1e3:.3f} ms over steps "
          f"2-{DRYRUN_STEPS} (host to a sync; {[round(x, 4) for x in secs]}"
          f" s); the predicted H100 bound {pred['bound_s'] * 1e3:.3f} ms "
          f"({pred['roofline']['dominant']}): bound / step "
          f"{pred['bound_s'] / step_s:.4f} [{card}]")
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected "
                             f"{want}")
    if abs(args - pred["args"]) > DRYRUN_ALLOC * pred["n_args"]:
        raise AssertionError(f"[{tag}] argument bytes {args} vs the "
                             f"prediction {pred['args']}")
    if abs(peak - pred_peak) > DRYRUN_PEAK_TOL * pred_peak:
        raise AssertionError(f"[{tag}] peak {peak} off the prediction "
                             f"{pred_peak} by more than "
                             f"{DRYRUN_PEAK_TOL:.0%}")
    del opt, batch
    return launches, blocks


def dryrun_pad(tree, template):
    """Zero-pad every leaf of a prefill's caches up to ``template``'s
    shape (the decode's room), as the engine's ``_pad_seq_dims``."""
    import torch
    from repro_torch.common.tree import tree_map

    def pad(a, t):
        if a.shape == t.shape:
            return a
        out = torch.zeros(t.shape, dtype=a.dtype, device=a.device)
        region = out
        for i, n in enumerate(a.shape):
            region = region.narrow(i, 0, n)
        region.copy_(a)
        return out

    return tree_map(pad, tree, template)


def dryrun_serve(tag, cfg, params, mesh, prompt, steps, wrappers, card, *,
                 exact: bool, keep=None) -> dict:
    """The sharded ``make_prefill_step`` on 8 prompts of ``prompt``
    tokens, then ``steps`` sharded ``make_serve_step`` decode steps, on
    ``mesh``, each held against the unsharded step, both decoding the
    unsharded run's greedy tokens from the prefill's caches (padded to
    ``prompt + steps`` positions) and on its MoE routes (as 6e holds W8:
    a bf16 ulp at a router's input flips near-tied top-k sets, and a
    flipped expert moves a logit by far more than the combine's
    rounding; the run on its own routes is printed).  ``exact``: logits
    and every cache leaf bit-equal; else each step's logits within
    ``DRYRUN_GROK_TOL`` * max|logit|.  Every MoE decode call drops
    nothing.  ``keep``: a dict that gets the prompts and the unsharded
    run's tokens (on the host, for 6i).  -> the sharded prefill's
    launches."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules)
    from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    ctx = make_ctx(mesh, {"sp": ("model",)})
    specs = match_partition_rules(LM_RULES, params, ctx)
    g = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (8, prompt), generator=g,
                           device="cuda")
    with torch.no_grad():
        logits1, caches1 = model.prefill(params, {"tokens": tokens})
    c_specs = match_partition_rules(CACHE_RULES, caches1, ctx)
    prefill = make_prefill_step(model, ctx=ctx, specs=specs,
                                cache_specs=c_specs)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits2, caches2 = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    want = dict.fromkeys(wrappers, 0) | lm_scan_calls(cfg)
    if launches != want:
        raise AssertionError(f"[{tag}] a sharded prefill launched "
                             f"{launches}, expected {want}")
    same = torch.equal(logits1, logits2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(caches1),
                                          tree_leaves(caches2)))
    pre_d = float((logits1.float() - logits2.float()).abs().max())
    if exact and not same:
        raise AssertionError(f"[{tag}] the sharded prefill differs from "
                             f"the unsharded one (max|d logits| {pre_d})")
    del caches2
    room = model.init_caches(8, prompt + steps, "cuda")
    c1 = dryrun_pad(caches1, room)
    del caches1, room
    d_specs = match_partition_rules(CACHE_RULES, c1, ctx)
    serve = make_serve_step(model, ctx=ctx, specs=specs, cache_specs=d_specs)
    tok = torch.argmax(logits1, -1)[:, None]
    ref, toks = [], []
    with lm_route_probe() as routes, torch.no_grad():
        c = c1
        for t in range(steps):
            toks.append(tok)
            lg, c = model.decode(params, c, tok, prompt + t)
            ref.append(lg)
            tok = torch.argmax(lg, -1)[:, None]
    ref_caches = c

    def sharded(replay):
        """The sharded decode on the unsharded run's tokens (and, with
        ``replay``, its MoE routes) -> (each step's logits, caches)."""
        out, c = [], c1
        with lm_route_probe(replay) as got:
            for t in range(steps):
                lg, c = serve(params, c, toks[t], prompt + t)
                out.append(lg)
        return out, c, got

    with lm_moe_probe() as calls:
        held, c2, _ = sharded(routes)
    dropped = sum(int((~v).sum()) for _, _, v in calls)
    rel = [float((a.float() - b.float()).abs().max())
           / float(a.float().abs().max()) for a, b in zip(ref, held)]
    equal = all(torch.equal(a, b) for a, b in zip(ref, held))
    caches_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ref_caches), tree_leaves(c2)))
    free = ""
    if routes:           # the MoE routing its own (informational)
        own, _, got = sharded(None)
        own_rel = max(float((a.float() - b.float()).abs().max())
                      / float(a.float().abs().max())
                      for a, b in zip(ref, own))
        free = (f"; routing its own: largest |d| / max|logit| "
                f"{own_rel:.3e}, {lm_route_flips(routes, got)[1]:.4f} of "
                f"(row, layer) top-k sets flipped (printed, not gated)")
        del own
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} {cfg.n_layers} layers {cfg.param_dtype} on "
          f"a (1, 1) NCCL mesh: the sharded prefill of 8 x {prompt} tokens "
          f"({pre_s:.3f} s, launches {launches}) "
          f"{'bit-equal' if same else 'differs'} to the unsharded one "
          f"(max|d logits| {pre_d:.3e}); {steps} sharded decode steps on the "
          f"unsharded run's tokens{' and MoE routes' if routes else ''}: "
          f"logits bit-equal {equal}, largest |d| / max|logit| "
          f"{max(rel):.3e} (by step: {' '.join(f'{x:.1e}' for x in rel)}), "
          f"caches bit-equal {caches_equal}; MoE decode calls {len(calls)}, "
          f"dropped {dropped}{free} [{card}]")
    if dropped:
        raise AssertionError(f"[{tag}] decode dropped {dropped} "
                             f"assignments")
    if exact and not (equal and caches_equal):
        raise AssertionError(f"[{tag}] the sharded decode differs from the "
                             f"unsharded one")
    if max(rel) > DRYRUN_GROK_TOL:
        raise AssertionError(f"[{tag}] decode logits off by {max(rel):.3e} "
                             f"of max|logit|")
    if keep is not None:
        keep.update(tokens=tokens.cpu(), toks=[t.cpu() for t in toks])
    return launches


def dryrun_phase(seed, wrappers, card) -> dict:
    """``[dryrun ...]``: the dry-run's prediction for 6f's Zamba2 train
    step (a child process on meta) against the card on a world of one
    NCCL rank, as 6g's, and the sharded prefill / decode steps on its
    (1, 1) mesh: Zamba2-1.2B (relu_linear) bit-equal to the unsharded
    steps, Grok-1 (6e's 2-layer cut, bf16) within ``DRYRUN_GROK_TOL``.
    -> (the launches of the sharded runs (the train steps and Zamba2's
    sharded prefill), Zamba2's serving for 6i: its params on the host
    and ``dryrun_serve``'s ``keep``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    pred = dryrun_predict(card)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        launches, blocks = dryrun_check(seed, wrappers, card, mesh, pred)
        zamba = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
        serve_ref: dict = {}
        pre = dryrun_serve("dryrun serve zamba2 1x1", zamba, blocks, mesh,
                           DRYRUN_PROMPT, DRYRUN_DECODE, wrappers, card,
                           exact=True, keep=serve_ref)
        launches = {k: launches[k] + pre[k] for k in wrappers}
        from repro_torch.common.tree import tree_map
        serve_ref["params"] = tree_map(lambda t: t.cpu(), blocks)
        del blocks
        gc.collect()
        torch.cuda.empty_cache()
        from repro_torch.models.registry import build_model
        grok = get_arch("grok-1-314b").scaled(n_layers=2)
        params = build_model(grok).init(seed + 1, "cuda")
        dryrun_serve("dryrun serve grok-1 1x1", grok, params, mesh,
                     DRYRUN_GROK_PROMPT, DRYRUN_GROK_DECODE, wrappers, card,
                     exact=False)
        del params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dryrun] phase in {time.perf_counter() - t0:.1f} s [{card}]")
    return launches, serve_ref


# the [tp] phase (6i): Zamba2-1.2B trained and served on a (1, 2) mesh,
# two ranks on the one card meeting on gloo (NCCL refuses two ranks on
# one GPU), the dense layers split over ``model`` (``distributed/tp.py``)
TP_STEPS = 5
TP_CHECK_STEPS = 2            # the memory check's steps, the first a warm-up
TP_LOSS_TOL = 1e-3            # step 1's loss, of |loss|, against 6f's
TP_PEAK_RANGE = (1.00, 1.05)  # each rank's measured / predicted peak
TP_SERVE_TOL = 3e-5           # fp32 logits, of max|logit|, against (1, 1)
                              # (PERF.md, 6i: read 5.7e-6 - 1.6e-5; the
                              # bf16 model's 4.5e-2)
TP_PROMPT = 1024              # the served prompts: 6h's first tokens
TP_HEADS = {"relu_attn_causal": 16, "ssd_chunked": 32}   # a rank's heads
TP_DATASET = 32000 * 32000 * 4   # the synthetic data's transition logits
TP_CONTEXT = 2**30            # a CUDA context and its workspaces, a rank


def tp_predict(card, batch) -> dict:
    """``[tp predict zamba2 1x2]``: ``DRYRUN_PREDICT`` for rank 0 of a
    (1, 2) mesh (a fake group of two ranks, every tensor on meta); rank
    1's blocks and step are the same size."""
    code = DRYRUN_PREDICT.format(src=SRC, seq=TRAIN_SEQ, batch=batch,
                                 alloc=DRYRUN_ALLOC, world=2, mesh=(1, 2))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=False)
    if run.returncode != 0:
        raise AssertionError(f"[tp predict] the child failed: "
                             f"{run.stderr[-3000:]}")
    pred = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"[tp predict zamba2 1x2] computed on meta for rank 0 of a (1, 2) "
          f"mesh, not measured: B = {batch}, S = {TRAIN_SEQ}: argument "
          f"bytes {pred['args']} ({pred['n_args']} tensors), the step's own "
          f"peak {pred['temp']} (peak {pred['args'] + pred['temp']} = "
          f"{(pred['args'] + pred['temp']) / 2**30:.3f} GiB with the "
          f"arguments), collective bytes {pred['coll']:.6e} "
          f"{pred['coll_by_kind']}, kernel calls {pred['kernels']} [{card}]")
    if pred["off_meta_ops"]:
        raise AssertionError(f"[tp predict] ops ran off the meta device: "
                             f"{pred['off_meta']}")
    return pred


def tp_rank(rank: int, tmp: str) -> int:
    """One rank of 6i's world (``chip_smoke.py --tp-rank R --tp-dir D``):
    the rank's dry-run check, ``Trainer`` run and sharded serving on the
    (1, 2) mesh, its numbers written to ``D/rank<R>.json`` (rank 0 also
    saves the Trainer run's scan inputs for ``[tp kernel]``)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch.kernels.registry import kernel_wrappers
    from repro_torch.launch.mesh import make_mesh
    spec = json.load(open(os.path.join(tmp, "spec.json")))
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=2)
    try:
        wrappers = kernel_wrappers()
        mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
        out = {"rank": rank}
        out.update(tp_check(spec, wrappers, mesh))
        dist.barrier()
        out.update(tp_train(rank, spec, wrappers, mesh, tmp))
        dist.barrier()
        out.update(tp_serve(rank, spec, wrappers, mesh, tmp))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_check(spec, wrappers, mesh) -> dict:
    """The rank's blocks built as the dry-run builds them and
    ``TP_CHECK_STEPS`` steps of ``make_train_step(ctx=, specs=)``: the
    argument bytes requested of the allocator and the peak over steps
    2..; the blocks' shapes against ``LM_RULES``' on the global (meta)
    tree; the param leaves ``loss_terms`` is handed (after
    ``_gather_dense``) against their ``model`` blocks: the bytes beyond
    them, gathered over ``model``."""
    import dataclasses
    import torch
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import (
        local_block, make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch import steps as st
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
    B = spec["batch"]
    model = build_model(cfg)
    handed = {}

    def loss_terms(params, *a, _fn=model.loss_terms, **k):
        handed.update((p, (tuple(x.shape), x.numel(), x.element_size()))
                      for p, x in flatten_with_paths(params))
        return _fn(params, *a, **k)

    model = dataclasses.replace(model, loss_terms=loss_terms)
    ctx = make_ctx(mesh, {"sp": ("model",)})
    opt_cfg = st.default_opt_cfg(cfg)
    meta = model.init(0, "meta")
    specs = match_partition_rules(LM_RULES, meta, ctx)
    want, model_block = {}, {}
    for (p, x), (_, s) in zip(flatten_with_paths(meta),
                              flatten_with_paths(specs)):
        want[p] = tuple(local_block(x, s, mesh).shape)
        only = P(*(("model" if "model" in s.axes(d) else None)
                   for d in range(len(s))))
        model_block[p] = local_block(x, only, mesh)
    torch.cuda.synchronize()
    r0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    m0 = torch.cuda.memory_allocated()
    params = model.init(spec["seed"], "cuda")
    blocks = shard_tree(params, specs, mesh)
    del params
    opt = adamw_init(blocks, opt_cfg)
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    batch = {k: torch.randint(0, cfg.vocab, (B, TRAIN_SEQ), generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    torch.cuda.synchronize()
    args = torch.cuda.memory_stats()["requested_bytes.all.current"] - r0
    shapes_ok = all(tuple(b.shape) == want[p]
                    for p, b in flatten_with_paths(blocks))
    split = sum(tuple(x.shape) != want[p]
                for p, x in flatten_with_paths(meta))
    step = st.make_train_step(model, opt_cfg, ctx=ctx, specs=specs)
    for w in wrappers.values():
        w.launches = 0
    secs, losses = [], []
    for i in range(TP_CHECK_STEPS):
        if i == 1:
            # the first step's lazy imports (checkpoint's first call
            # imports torch._dynamo; torch.fx keeps its own frame) leave
            # a cycle through the step's frames that holds its tensors
            # until the collector runs, at a point that varies by run
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blocks, opt, loss = step(blocks, opt, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - m0
    launches = {k: w.launches for k, w in wrappers.items()}
    over = [(p, shape, tuple(model_block[p].shape))
            for p, (shape, _, _) in handed.items()
            if shape != tuple(model_block[p].shape)]
    beyond = sum((n - model_block[p].numel()) * size
                 for p, (_, n, size) in handed.items())
    n_model = sum(tuple(model_block[p].shape) != tuple(x.shape)
                  for p, x in flatten_with_paths(meta))
    del blocks, opt, batch, step, handed
    gc.collect()
    torch.cuda.empty_cache()
    return {"args": args, "peak": peak, "check_losses": losses,
            "check_secs": secs, "check_launches": launches,
            "shapes_ok": shapes_ok, "split_leaves": split,
            "n_leaves": len(want), "model_split": n_model,
            "model_beyond": beyond, "model_over": over}


def tp_train(rank, spec, wrappers, mesh, tmp) -> dict:
    """6f's Zamba2 run (config, data, seed, schedule) for ``TP_STEPS``
    steps through ``Trainer(mesh=, device="cuda:0")``; the counters set
    to 0 just before ``run`` and read just after; the first step's scan
    calls probed (their shapes; rank 0 saves their inputs)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_arch("zamba2-1.2b").scaled(attn_backend="relu_linear")
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=spec["batch"], seed=spec["seed"] + 2)
        tcfg = TrainerConfig(
            total_steps=TP_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=root,
            log_every=10, seed=spec["seed"] + 2,
            schedule=ScheduleConfig(kind="cosine",
                                    warmup_steps=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS))
        tr = Trainer(cfg, data, tcfg, device="cuda:0", mesh=mesh)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with lm_scan_probe() as calls:
            res = tr.run()
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        shapes = {name: [list(a[0].shape), str(a[0].dtype)]
                  for (name, _), (a, _) in calls.items()}
        if rank == 0:
            torch.save({key: (tuple(t.cpu() if torch.is_tensor(t) else t
                                    for t in a), k)
                        for key, (a, k) in calls.items()},
                       os.path.join(tmp, "calls.pt"))
        losses, step_secs = res["losses"], tr.step_seconds
        del tr, res, calls
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "train_secs": secs, "step_secs": step_secs,
            "launches": launches, "call_shapes": shapes}


def tp_serve_cfg():
    """6h's Zamba2 (relu_linear) in fp32 for 6i's serve check: a bf16
    Zamba2's logits move by ~5e-2 of max|logit| under any reordering of
    its sums (6c: the kernels against the plain scans, 3.8e-2 - 5.3e-2),
    so the split is held in fp32 (``TP_SERVE_TOL``)."""
    from repro_torch.configs import get_arch
    return get_arch("zamba2-1.2b").scaled(
        attn_backend="relu_linear", param_dtype="float32",
        compute_dtype="float32", kv_dtype="float32")


def tp_serve_run(ref, mesh, wrappers):
    """The sharded prefill of ``ref``'s prompts and a decode step on each
    of its tokens on ``mesh``, in fp32 (``tp_serve_cfg``) from 6h's
    params: -> (each step's logits block on the host, the prefill's
    launches, its seconds)."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    model = build_model(tp_serve_cfg())
    ctx = make_ctx(mesh, {"sp": ("model",)})
    params = tree_map(lambda t: t.to("cuda", torch.float32), ref["params"])
    specs = match_partition_rules(LM_RULES, params, ctx)
    blocks = shard_tree(params, specs, mesh)
    del params
    tokens = ref["tokens"].to("cuda")
    B, S = tokens.shape
    c_specs = match_partition_rules(
        CACHE_RULES, model.init_caches(B, S + len(ref["toks"]), "meta"), ctx)
    prefill = make_prefill_step(model, ctx=ctx, specs=specs,
                                cache_specs=c_specs)
    serve = make_serve_step(model, ctx=ctx, specs=specs,
                            cache_specs=c_specs)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits, caches = prefill(blocks, {"tokens": tokens})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    out = [logits.cpu()]
    for t, tok in enumerate(ref["toks"]):
        logits, caches = serve(blocks, caches, tok.to("cuda"), S + t)
        out.append(logits.cpu())
    del blocks, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches, pre_s


def tp_serve_ref(serve_ref, wrappers, card):
    """The fp32 (1, 1) sharded steps on 6h's params, prompts and tokens,
    on a world of one NCCL rank in this process, as 6h's: -> each step's
    logits, the reference of ``[tp serve zamba2 1x2]``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        out, _, secs = tp_serve_run(serve_ref, mesh, wrappers)
    finally:
        dist.destroy_process_group()
    print(f"[tp serve zamba2 1x1] the fp32 reference: 6h's params in fp32, "
          f"the first {TP_PROMPT} tokens of its "
          f"{tuple(serve_ref['tokens'].shape[:1])} prompts and "
          f"{len(serve_ref['toks'])} tokens through the (1, 1) sharded "
          f"steps (prefill {secs:.3f} s) [{card}]")
    return out


def tp_serve(rank, spec, wrappers, mesh, tmp) -> dict:
    """``[tp serve zamba2 1x2]`` on the rank: ``tp_serve_run`` on the
    (1, 2) mesh, each logits block against the parent's fp32 (1, 1)
    steps' (``tp_serve_ref``) cut to the rank's vocab block."""
    import torch
    from repro_torch.distributed import collectives as C
    ref = torch.load(os.path.join(tmp, "serve.pt"), weights_only=False)
    out, launches, pre_s = tp_serve_run(ref, mesh, wrappers)
    i = C.axis_index("model", mesh)
    errs = []
    for want, got in zip(ref["logits"], out):
        v = got.shape[1]
        v0 = i * v if v < want.shape[1] else 0
        errs.append([float((want[:, v0:v0 + v] - got).abs().max())
                     / float(want.abs().max()), list(got.shape)])
    return {"serve_errs": errs, "serve_launches": launches,
            "prefill_s": pre_s}


def tp_phase(seed, wrappers, max_err, card, ref, serve_ref) -> dict:
    """``[tp ...]`` (see the module docstring, 6i): the prediction, then
    two ranks (``--tp-rank``) on the card on gloo, their gates, and
    ``[tp kernel]`` on rank 0's scan inputs in this process.  ``ref``:
    6f's losses; ``serve_ref``: 6h's Zamba2 serving (its params, prompts
    and tokens).  -> the ranks' launches on their driven runs
    (the train steps, the Trainer run, the sharded prefill)."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[tp] before the ranks: mem_get_info free {free} of {total} B "
          f"({free / 2**30:.3f} / {total / 2**30:.3f} GiB) [{card}]")
    batch = TRAIN_BATCH
    while True:
        pred = tp_predict(card, batch)
        need = 2 * (pred["args"] + pred["temp"] + TP_DATASET + TP_CONTEXT)
        print(f"[tp predict zamba2 1x2] B = {batch}: two ranks need about "
              f"{need / 2**30:.3f} GiB (each its predicted peak, the "
              f"synthetic data's {TP_DATASET / 2**30:.3f} GiB and a "
              f"{TP_CONTEXT / 2**30:.0f} GiB context) of {free / 2**30:.3f} "
              f"GiB free [{card}]")
        if need <= 0.9 * free or batch == 1:
            break
        batch //= 2
        print(f"[tp] halving B to {batch}: B = {batch * 2} does not fit")
    serve_ref = dict(serve_ref, tokens=serve_ref["tokens"][:, :TP_PROMPT])
    serve_ref["logits"] = tp_serve_ref(serve_ref, wrappers, card)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump({"seed": seed, "batch": batch}, f)
        torch.save(serve_ref, os.path.join(tmp, "serve.pt"))
        # each rank's output to a file: a rank blocked on a full pipe
        # would stall the other in a collective
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(2)]
        procs = []
        try:
            for r in range(2):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--tp-rank", str(r), "--tp-dir", tmp],
                        stdout=f, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(logs[r]) as f:
                    raise AssertionError(f"[tp] rank {r} exited "
                                         f"{p.returncode}: "
                                         f"{f.read()[-4000:]}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(2)]
        calls = torch.load(os.path.join(tmp, "calls.pt"),
                           weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = tp_gates(ranks, pred, batch, wrappers, ref, card)
    tp_kernels(calls, wrappers, max_err, card)
    print(f"[tp] phase in {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def tp_gates(ranks, pred, batch, wrappers, ref, card) -> dict:
    """6i's gates on both ranks' numbers (see the module docstring) ->
    the launches of their driven runs, summed."""
    per_step = {"relu_attn_causal": 12, "ssd_chunked": 76}
    pred_peak = pred["args"] + pred["temp"]
    launches = dict.fromkeys(wrappers, 0)
    for o in ranks:
        r = o["rank"]
        tag = f"tp zamba2 1x2 rank {r}"
        want_check = dict.fromkeys(wrappers, 0) | {
            k: v * TP_CHECK_STEPS for k, v in per_step.items()}
        want_train = dict.fromkeys(wrappers, 0) | {
            k: v * TP_STEPS for k, v in per_step.items()}
        want_serve = dict.fromkeys(wrappers, 0) | {
            "relu_attn_causal": 6, "ssd_chunked": 38}
        losses = o["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        tok_s = statistics.median(batch * TRAIN_SEQ / s
                                  for s in o["step_secs"])
        print(f"[{tag}] Trainer(mesh=(1, 2), device cuda:0) on gloo, B = "
              f"{batch}, S = {TRAIN_SEQ}: {TP_STEPS} steps in "
              f"{o['train_secs']:.3f} s; tokens/s per step median "
              f"{tok_s:.1f} (two ranks sharing one card: no speed); "
              f"losses against 6f's steps 0..{TP_STEPS - 1}: "
              + " ".join(f"{a:.6f}/{b:.6f}" for a, b in
                         zip(losses, ref["losses"]))
              + f"; relative {' '.join(f'{x:.3e}' for x in rel)}; "
              f"launches {o['launches']} [{card}]")
        ratio = o["peak"] / pred_peak
        print(f"[{tag}] memory: argument bytes requested {o['args']} "
              f"(predicted {pred['args']}, {o['args'] - pred['args']:+d} B "
              f"over {pred['n_args']} tensors); peak allocated over steps "
              f"after the first {o['peak']} B = {o['peak'] / 2**30:.3f} "
              f"GiB (predicted {pred_peak} B: measured / predicted "
              f"{ratio:.4f}); {TP_CHECK_STEPS} steps {o['check_secs']} s, "
              f"losses {o['check_losses']}; blocks of LM_RULES' shapes "
              f"{o['shapes_ok']} ({o['split_leaves']} of {o['n_leaves']} "
              f"leaves split); the param leaves loss_terms is handed: "
              f"{o['model_split']} split over model, each handed beyond "
              f"its model block by {o['model_beyond']} B in all (gathered "
              f"over model); scan calls {o['call_shapes']} [{card}]")
        errs = o["serve_errs"]
        print(f"[{tag}] serve fp32: sharded prefill of 6h's prompts in "
              f"{o['prefill_s']:.3f} s (launches {o['serve_launches']}); "
              f"logits block {errs[0][1]} against the (1, 1) steps': "
              f"|d| / max|logit| prefill {errs[0][0]:.3e}, decode "
              + " ".join(f"{e:.3e}" for e, _ in errs[1:])
              + f" (gate {TP_SERVE_TOL}) [{card}]")
        if len(losses) != TP_STEPS or rel[0] > TP_LOSS_TOL:
            raise AssertionError(f"[{tag}] step 1's loss off 6f's by "
                                 f"{rel[0]} (or {len(losses)} steps)")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[{tag}] non-finite loss {losses}")
        for got, want, what in ((o["check_launches"], want_check, "steps"),
                                (o["launches"], want_train, "Trainer"),
                                (o["serve_launches"], want_serve,
                                 "prefill")):
            if got != want:
                raise AssertionError(f"[{tag}] {what} launched {got}, "
                                     f"expected {want}")
        for name, heads in TP_HEADS.items():
            shape = o["call_shapes"][name][0]
            if shape[0] != batch * heads:
                raise AssertionError(f"[{tag}] {name} ran at {shape}, not "
                                     f"{batch} x {heads} heads")
        if abs(o["args"] - pred["args"]) > DRYRUN_ALLOC * pred["n_args"]:
            raise AssertionError(f"[{tag}] argument bytes {o['args']} vs "
                                 f"the prediction {pred['args']}")
        if not TP_PEAK_RANGE[0] <= ratio <= TP_PEAK_RANGE[1]:
            raise AssertionError(f"[{tag}] peak / prediction {ratio:.4f} "
                                 f"outside {TP_PEAK_RANGE}")
        if not o["shapes_ok"] or o["model_over"] or not o["model_split"]:
            raise AssertionError(f"[{tag}] blocks off LM_RULES' shapes, or "
                                 f"leaves gathered over model "
                                 f"{o['model_over']} ({o['model_split']} "
                                 f"split)")
        if max(e for e, _ in errs) > TP_SERVE_TOL:
            raise AssertionError(f"[{tag}] serve logits off (1, 1)'s by "
                                 f"{max(e for e, _ in errs):.3e}, above "
                                 f"{TP_SERVE_TOL}")
        for k in wrappers:
            launches[k] += (o["check_launches"][k] + o["launches"][k]
                            + o["serve_launches"][k])
    return launches


def tp_kernels(calls, wrappers, max_err, card) -> None:
    """``[tp kernel]``: each scan's call of rank 0's probed step at the
    rank's heads, held against its plain version (``measure``: 6f's
    bound) and timed beside the same call at the full head count (its
    inputs twice)."""
    import torch
    for (name, _), (a, k) in sorted(calls.items()):
        a = tuple(t.to("cuda") if torch.is_tensor(t) else t for t in a)
        full = tuple(torch.cat([t, t]) if torch.is_tensor(t) else t
                     for t in a)
        case = lm_scan_case(name, a, k, f"tp rank heads "
                            f"{tuple(a[0].shape)} {str(a[0].dtype)[6:]}")
        err, ref_max, *times = measure(case, False, 5, 3)
        max_err[name] = max(max_err[name], err)
        kernel_line("tp kernel", case, "", err, ref_max, *times)
        fcase = lm_scan_case(name, full, k, f"tp full heads "
                             f"{tuple(full[0].shape)} {str(a[0].dtype)[6:]}")
        ferr, fmax, *ftimes = measure(fcase, False, 5, 3)
        print(f"[tp kernel] {name}: {times[0]:.4f} ms a call at the rank's "
              f"{tuple(a[0].shape)}, {ftimes[0]:.4f} ms at the full head "
              f"count {tuple(full[0].shape)} (ratio "
              f"{times[0] / ftimes[0]:.3f}; max|d| there {ferr:.3e}, max|ref| "
              f"{fmax:.3e}) [{card}]")
        del a, full
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)    # one rank of 6i's world
    ap.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"the port's package is not at {SRC}/repro_torch")
    sys.path.insert(0, SRC)
    if args.tp_rank is not None:
        return tp_rank(args.tp_rank, args.tp_dir)
    import numpy as np

    from repro_torch.core.efficientvit import B1, B2, B3, init_efficientvit
    from repro_torch.core.program import execute, lower
    from repro_torch.kernels.build import build
    from repro_torch.core.quantization import quantize_efficientvit
    from repro_torch.kernels.registry import kernel_wrappers
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    # -- 1. set-up ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    t0 = time.perf_counter()
    logs = build()
    print(f"[build] {len(logs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    count_imma()
    # every kernel wrapper of the port, in the kernels line's order
    wrappers = kernel_wrappers()
    # the library kernels run on neither served path
    expected_fp = dict.fromkeys(wrappers, 0) | {
        "dsconv_fused": 1, "mbconv_fused": 9, "relu_attn_noncausal": 7,
        "supersite_fused": 2}
    expected_int8 = dict.fromkeys(wrappers, 0) | {
        "relu_attn_noncausal": 7, "mbconv_fused_int8": 7,
        "mbconv_fused_int8_emit": 2, "dsconv_fused_int8": 1,
        "int8_matmul": 14, "group_agg_int8": 7, "supersite_fused_int8": 2}
    # launches of each library kernel in the library phase: one per case
    expected_lib = {"int8_matmul_emit": 24, "dsconv_fused_int8_emit": 8,
                    "relu_attn_causal": 4, "ssd_chunked": 2}
    csrc, jk = "src/repro_torch/csrc/", "src/repro/kernels/"
    sources = {
        "dsconv_fused": (csrc + "dsconv.cu", jk + "dsconv/kernel.py:57"),
        "mbconv_fused": (csrc + "mbconv.cu", jk + "mbconv/kernel.py:69"),
        "relu_attn_noncausal": (csrc + "relu_attn.cu",
                                jk + "relu_attn/kernel.py:68"),
        "mbconv_fused_int8": (csrc + "mbconv_int8.cu",
                              jk + "mbconv/kernel.py:168"),
        "mbconv_fused_int8_emit": (csrc + "mbconv_int8.cu",
                                   jk + "mbconv/kernel.py:283"),
        "dsconv_fused_int8": (csrc + "dsconv_int8.cu",
                              jk + "dsconv/kernel.py:138"),
        "int8_matmul": (csrc + "int8_matmul.cu",
                        jk + "int8_matmul/kernel.py:45"),
        "group_agg_int8": (csrc + "group_agg.cu",
                           jk + "group_conv/kernel.py:60"),
        "supersite_fused": (csrc + "supersite.cu",
                            jk + "supersite/kernel.py:191"),
        "supersite_fused_int8": (csrc + "supersite_int8.cu",
                                 jk + "supersite/kernel.py:353"),
        "int8_matmul_emit": (csrc + "int8_matmul.cu",
                             jk + "int8_matmul/kernel.py:127"),
        "dsconv_fused_int8_emit": (csrc + "dsconv_int8.cu",
                                   jk + "dsconv/kernel.py:234"),
        "relu_attn_causal": (csrc + "relu_attn_causal.cu",
                             jk + "relu_attn/kernel.py:146"),
        "ssd_chunked": (csrc + "ssd.cu", jk + "ssd/kernel.py:68"),
    }
    gen = torch.Generator().manual_seed(args.seed)
    per_fwd = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_s": 0.0, "ops_s": 0.0} for k in wrappers}
    max_err = {k: 0.0 for k in wrappers}

    # every plan of this run tunes into files under build/autotune/
    fresh_cache("setup")
    params = init_efficientvit(gen, B1, "cuda")
    randomize_bn(params, gen)
    qparams = quantize_efficientvit(params)
    cfg8 = VisionServeConfig(microbatch=8)
    rng = np.random.default_rng(args.seed)
    images = rng.standard_normal((12, 224, 224, 3)).astype(np.float32)
    x12 = torch.from_numpy(images).cuda()
    # [autotune]: both precisions' engines, tuned on a fresh cache file
    # that every later phase reuses; the kernel checks below run at the
    # blocks of their plans, the ones the served path runs
    engine, qengine = autotune_phase(params, x12[:8], expected_fp,
                                     expected_int8)
    plans = {b: (engine.cache.get(b, 224).plan,
                 qengine.cache.get(b, 224).plan) for b in (1, 8)}
    chains = {b: chain_cases(b, gen, params, qparams, B1, plans[b])
              for b in (1, 8)}

    # -- 2a. fp32 kernels against their plain versions -----------------
    stamp("section 2a", t_start)
    for batch in (1, 8):
        check_kernels(kernel_cases(batch, gen, B1, plans[batch][0])
                      + chains[batch][0], batch, per_fwd, max_err,
                      exact=False)
    mbconv_sweep(gen)
    band_sweep(params, gen)
    relu_attn_checks(gen)
    dsconv_sweep(gen)

    # -- 2b. the fp32 engine: graphs, plans, steady state ---------------
    stamp("section 2b", t_start)
    check_graphs(engine, expected_fp, "serve")
    check_groups(engine, "serve")
    grouped_vs_per_site(engine, x12[:8], "serve", exact=False)
    fwd_fp = steady_state(engine, rng, "serve")
    graph_checks(engine, rng, "fp32")
    check_healthy(engine, "serve")

    # -- 3a. int8 kernels against their plain versions -----------------
    stamp("section 3a", t_start)
    for batch in (1, 8):
        check_kernels(int8_kernel_cases(batch, gen, B1, plans[batch][1])
                      + chains[batch][1], batch, per_fwd, max_err,
                      exact=True)
    mbconv_int8_sweep(gen)
    int8_matmul_sweep(gen)
    int8_emit_sweep(gen)
    group_agg_sweep(gen)
    dsconv_int8_sweep(gen)

    # -- 3b. the FIX8 engine (the [autotune] phase's) ---------------------
    stamp("section 3b", t_start)
    check_graphs(qengine, expected_int8, "fix8")
    check_groups(qengine, "fix8")
    eight = qengine.logits(x12[:8])
    ones = torch.cat([qengine.logits(x12[i:i + 1]) for i in range(8)])
    if not torch.equal(eight, ones):
        raise AssertionError(
            f"batch invariance: {int((eight != ones).sum())} logits of a "
            f"batch-8 forward differ from the batch-1 forwards")
    print("[fix8] batch invariance: the 8 rows of a batch-8 forward equal "
          "the 8 batch-1 forwards bit for bit")
    ex = qengine.cache.get(8, 224)
    site_walk(ex.program, qengine.params, x12[:8], ex.plan, "fix8")
    grouped_vs_per_site(qengine, x12[:8], "fix8", exact=True)
    fwd_q = steady_state(qengine, rng, "fix8")
    graph_checks(qengine, rng, "fix8")
    check_healthy(qengine, "fix8")
    fwd_eoff = epilogues_phase(qengine, params, x12[:8])
    del qengine
    overrides_phase(engine.params, x12[:8])
    del engine

    # -- 3c, 3d. the int8 dataflow's switch, overrides, the fault ladder -
    stamp("section 3c, 3d", t_start)
    faults_phase(params, images, wrappers, expected_fp)
    autotune_fault_phase(params, images)

    # -- 3e. [B2], [B3]: the wider configs through the same planner -----
    stamp("section 3e", t_start)
    wide = {"B2": model_phase(B2, args.seed + 2, "B2", wrappers),
            "B3": model_phase(B3, args.seed + 3, "B3", wrappers)}

    # -- 4. the kernel library: the public ops off the vision path ------
    stamp("section 4", t_start)
    launches_lib = library_phase(args.seed, wrappers, expected_lib, per_fwd,
                                 max_err)

    # -- 5a. sharded serving, the tracer, the metrics, the drift report -
    stamp("section 5a", t_start)
    launches_sh = {
        "fp32": obs_phases(params, images, wrappers, expected_fp, "fp32",
                           False, gen, per_fwd, max_err),
        "fix8": obs_phases(params, images, wrappers, expected_int8, "fix8",
                           True, gen, per_fwd, max_err)}

    # -- 5. the main path, fp32 and FIX8: warm, serve, count -----------
    stamp("section 5", t_start)
    engine, got, launches_fp = serve_trace(
        lambda: VisionEngine(params, B1, cfg8), images, wrappers,
        expected_fp, "serve")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=12), engine.params,
                      x12).cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    if not np.array_equal(got.argmax(-1), ref.argmax(-1)):
        raise AssertionError("top-1 differs from the reference forward")
    print(f"[serve] logits vs reference forward: max|d| "
          f"{np.abs(got - ref).max():.3e} (max|ref| "
          f"{np.abs(ref).max():.3e}), top-1 equal")
    qengine, got, launches_q = serve_trace(
        lambda: VisionEngine.quantized(params, B1, cfg8), images, wrappers,
        expected_int8, "fix8")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=12), qengine.params,
                      x12).cpu().numpy()
    d, top = np.abs(got - ref).max(), np.abs(ref).max()
    print(f"[fix8] logits vs the int8 reference forward: max|d| {d:.3e} "
          f"(max|ref| {top:.3e}, {d / top:.3e} of it)")
    if not np.array_equal(got.argmax(-1), ref.argmax(-1)):
        raise AssertionError("FIX8 top-1 differs from the int8 reference")
    if not d <= CHAOS * top:
        raise AssertionError(f"FIX8 logits {d:.3e} from the reference, "
                             f"above {CHAOS} * {top:.3e}")

    # -- 6. kernel time per forward, after every timed phase -----------
    stamp("section 6", t_start)
    kernel_profile(*fwd_fp, "serve")
    kernel_profile(*fwd_q, "fix8")
    kernel_profile(*fwd_eoff, "epilogues off")
    for name, fwds in wide.items():
        for prec, fwd in fwds.items():
            kernel_profile(*fwd, f"{name} {prec}")
    one_launch_per_site(gen)

    # -- 6b. [search]: a searched schedule, served from its artifact ---
    stamp("section 6b", t_start)
    launches_se = {
        "fp32": search_phase(params, args.seed, wrappers, expected_fp, gen,
                             max_err, False),
        "fix8": search_phase(params, args.seed, wrappers, expected_int8,
                             gen, max_err, True)}

    # -- 6c. [lm]: the LM serving path, Zamba2-1.2B and Mamba2-1.3B -----
    stamp("section 6c", t_start)
    launches_lm = lm_phase(args.seed, wrappers, max_err, card)

    # -- 6d. [lm softmax]: softmax and sliding attention, their caches --
    stamp("section 6d", t_start)
    launches_lm_softmax = lm_softmax_phase(args.seed, wrappers, max_err,
                                           card)

    # -- 6e. [lm moe], [lm encdec]: MoE, W8, the encoder-decoder --------
    stamp("section 6e", t_start)
    launches_lm_moe = lm_moe_phase(args.seed, wrappers, max_err, card)

    # -- 6f. [train]: the gradients, flash, Zamba2-1.2B trained ---------
    stamp("section 6f", t_start)
    train_ref: dict = {}
    launches_train = train_phase(args.seed, wrappers, max_err, card,
                                 train_ref)

    # -- 6g. [dist]: the sharded trainer on a world of one NCCL rank ----
    stamp("section 6g", t_start)
    launches_dist = dist_phase(args.seed, wrappers, max_err, card,
                               train_ref)

    # -- 6h. [dryrun]: the dry-run's prediction and the sharded serving --
    stamp("section 6h", t_start)
    launches_dryrun, serve_ref = dryrun_phase(args.seed, wrappers, card)

    # -- 6i. [tp]: Zamba2-1.2B on a (1, 2) mesh, two ranks on the card --
    stamp("section 6i", t_start)
    launches_tp = tp_phase(args.seed, wrappers, max_err, card, train_ref,
                           serve_ref)
    del serve_ref

    # -- 7. the kernels line --------------------------------------------
    stamp("section 7", t_start)
    rows = []
    for name in wrappers:
        acc = per_fwd[name]
        src, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (launches_fp[name] + launches_q[name]
                         + launches_sh["fp32"][name]
                         + launches_sh["fix8"][name]
                         + launches_se["fp32"][name]
                         + launches_se["fix8"][name] + launches_lib[name]
                         + launches_lm[name] + launches_lm_softmax[name]
                         + launches_lm_moe[name] + launches_train[name]
                         + launches_dist[name] + launches_dryrun[name]
                         + launches_tp[name]),
            "max_abs_err": max_err[name], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_s"] >= acc["ops_s"]
                         else "operations"),
            "library_ms": acc.get("library_ms")})
    stamp("done", t_start)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
