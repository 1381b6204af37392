#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths with seeded random weights:

- paged-KV serving of the full-width ``transformer`` (vocab 32000,
  12 layers, d_model 768, 12 heads, d_ff 3072, bf16 compute, page_len 16)
  through ``ContinuousBatcher`` and the HTTP ``ServeFrontend``, once with
  bf16 KV pages and once with int8 pages: greedy, sampled, speculative
  (``SpecDecodeEngine``) and prefix-shared;
- training through ``AutoDist.build`` / ``step.run``: ``bert_base`` (vocab
  30522, 12 layers, d_model 768, MLM) at seq 512 with flash attention,
  batch 32, AllReduce, default SGD; the causal ``transformer`` at seq 512
  with flash attention; ``resnet`` at its defaults (ResNet-50, 224 px,
  1000 classes, bf16 compute) at batch 128; and the rest of the zoo at the
  published widths of the JAX package's ``examples/benchmark/train.py``
  (``ZOO``, from the port's ``models.PUBLISHED``): VGG-16 and DenseNet-121
  at 224 px and Inception-v3 at 299 px, batch 128; the LM1B LSTM (vocab
  8192, embed 512, hidden 1024, 2 layers, seq 32) at batch 128; NCF (6040
  users, 3706 items, mf 64, MLP 256-256-128-64) at batch 4096; the MoE
  transformer (4 layers, d_model 512, 8 experts) at batch 32; the causal
  ``transformer`` at a 4096-token context under ring and Ulysses attention
  over a ``seq`` axis, and bert_base as a 4-stage pipeline through
  ``AutoDist.build_pipeline`` over a ``pipe`` axis (one rank a card).

Phases, each printing one JSON line:

1. ``device``: CUDA must be present; prints the ``nvidia-smi`` name and
   power limit.
2. ``build``: builds ``autodist_tpu_torch/csrc/paged_attention.cu``,
   ``csrc/flash_attention.cu`` and ``csrc/fused_conv_stats.cu`` with nvcc
   from this checkout, all three at once; prints each kernel's registers
   and spill bytes (``-Xptxas -v``) and the count of tensor-core
   instructions in the SASS (``cuobjdump``, "not found" without it): HMMA
   in the three flash kernels, HGMMA in the six instances of the bf16
   conv-stats kernel; fails on a spill or a kernel without them, and on a
   conv-stats shared-memory plan that differs from the wrapper's mirror.
3. ``kernel_parity``: the paged CUDA kernel against its plain version at
   the main path's shapes (decode B=32 Q=1, prefill B=1 Q=16, verify B=32
   Q=5; H=12, D=64, page_len 16, 32-page shuffled tables, positions that
   reach the last slot), with fp32, bf16 and int8 pages, at the split count
   of its own plan (reported) and at ``PAGED_SPLITS``, a repeated launch
   bitwise equal at each; timed beside the plain version, SDPA over the
   gathered timeline, and the bound.
4. ``serve``: 64 mixed-length requests (max_new 32) per KV mode; every one
   completes, no page leaks, and the kernel's launch count equals
   ``num_layers x (prefill chunks + decode steps)``; then 4 ``POST
   /generate`` and one ``GET /metrics`` over HTTP.
5. ``stream_check``: teacher-forced bf16 logits through the kernel path vs
   the plain path within a stated bound, and identical greedy streams of
   an fp32 2-layer full-width model.
5c. ``checkpoint_serve``: the full-width transformer trained
   ``CKPT_SERVE_STEPS`` steps, saved (``step.save``), and served from its
   checkpoint through ``AutoDist.build_inference(checkpoint=...)`` (a
   template of meta tensors) and through ``SpecDecodeEngine.build(
   checkpoint=, draft_checkpoint=)`` (a 2-layer draft from a params-only
   checkpoint), 32 requests each: the restored params bitwise the trained
   ones, the streams equal serving them from memory, the paged kernel's
   launches counted as in serve_features.
5b. ``serve_features``: the rest of single-engine serving on the same
   model, 64 requests, max_new 32, bf16 and int8 pages, each run through
   ``ContinuousBatcher`` with the paged kernel's launches equal to target
   layers x (prefill chunks + decode steps + verify rounds) + draft layers
   x draft steps. Stochastic sampling (temperature 0.8, top_p 0.9, top_k
   50): every request completes, the same ``(request_id, seed)`` replays
   bitwise, and ``sample_tokens`` on the card equals the CPU's on 1024 rows
   of the model's logits but at near-ties. Speculative decode (k = 4) with
   the same-weights draft and a 2-layer draft of its own weights: streams
   equal plain greedy's or parting only at a near-tie (``_streams_agree``),
   pools balanced; acceptance, tokens a round, ITL p50 and decode tokens/s
   beside plain decode's. Prefix sharing: 32 requests sharing a 512-token
   system prompt (16-64-token suffixes, every 8th diverging mid-page from
   a cached block) against the same without the cache: streams equal, hit
   rate, copy-on-write pages, prefill chunks saved, TTFT p50 cached and
   cold, no page left after a purge. Then the fp32 2-layer full-width
   model: spec streams bitwise equal plain decode's, greedy and sampled.
5e. ``serve_replica``: one supervised serving replica of the same model
   (bf16 pages, 32 slots, the 64 seeded prompts) as a user runs it: the
   CLI ``python -m autodist_tpu_torch.serve --device cuda --slots 32
   --ft-dir D --replica-id 0 --trace-out T`` (its ``main``, in a process of
   this script, ``--serve-cli``, which writes the process's paged launches
   and span counts when the server returns), with ``AUTODIST_FLIGHT_DIR``
   set. ``/healthz`` must answer 503 ``starting`` first and 200 once
   ``READY`` (seconds to READY printed); 64 requests over HTTP, then
   ``POST /drain`` while some are queued: every request ends ``done`` or
   ``preempted``, what the drain found unfinished is what it finished plus
   what it persisted, the journal (format v2) holds exactly the preempted
   request ids and the pool is empty. A restart on ``D`` replays the journal
   once (``D/serve_replayed-0.jsonl``), consumes it, and each replayed (and
   each completed) stream equals the in-process uninterrupted run of the
   same prompt under ``_streams_agree``; ``GET /slo`` equals
   ``replay_flight_records`` over that process's flight records within
   ``SLO_REPLAY_RTOL`` (``slo_compliant`` printed, not gated); SIGTERM
   under load exits 0 (JAX's path: no drain); the part-files hold the
   ``serve.queue_wait``, ``serve.prefill_chunk`` and ``serve.decode_step``
   spans; each process's paged launches equal ``12 x`` its prefill chunks
   and decode steps. Then in process, on the card: ``SEAM_SERVE_STEP``
   raising ``EngineDeadError`` ends all 64 requests typed with no page
   left; ``SEAM_SERVE_PAGES`` ``"exhaust"`` for ``EXHAUST_S`` gives at most
   one ``pool_pressure`` event a second and typed sheds past a 16-request
   queue; a ``SEAM_SERVE_STEP`` stall of ``STALL_S`` trips SNT008 once an
   episode in a ``Sentry`` fed each request's ITL (two episodes, two
   findings); the host ms of a 32-row decode step with the flight hooks off
   and on, in turns.
5f. ``serve_fleet``: the serving fleet's router (``serve/router.py``)
   through ``build_test_fleet`` and ``fleet_trial``, the path of
   ``--selftest-router`` at full width: 3 in-process replicas x 16 slots
   (``FLEET_*``) and a control engine over one shared parameter dict, 64
   seeded requests (max_new 16) from 64 concurrent clients, replica 1
   killed once it holds a request with a delivered token. Fleet B is the
   served configuration (the full-width transformer above, bf16 pages),
   fleet A the bit-identity contract (the fp32 2-layer full-width model of
   ``stream_check``). Each fleet runs once without the kill first: its
   maximum straggler score and the TTFT/ITL ratios to the rolling median
   the sentry judges them against are printed, and a ``RouterConfig`` /
   ``SentryConfig`` field is set above its JAX default only when that run
   crossed it, ``CALIBRATION_MARGIN`` (2x) above the measured maximum;
   every other field is JAX's default (``calibrated_configs``, as
   ``selftest_router`` does). Then the killed run holds
   every bar of ``selftest_router``: every request done and delivered
   exactly once (the ledger), a failover and a reroute, the journal empty,
   2 replicas READY after the kill, a finite ``slo_report`` compliant with
   the selftest's spec (``TEST_SLO_SPEC``; the verdict of JAX's default
   interactive ``SLOSpec`` on the same percentiles is printed beside it,
   not gated), the stitched failover trace, and a
   seeded 1000 s TTFT and ITL tripping SNT007 and SNT008 once and demoting
   the survivor. Fleet A's streams equal the control run's bitwise with 0
   overlap mismatches; fleet B's agree under ``_streams_agree``, and a bf16
   overlap mismatch is allowed only at a near-tie (the request ends typed,
   counted, and its margin printed). A ``RouterFrontend`` in front of fleet
   B answers 4 ``POST /generate``, ``GET /metrics`` (read back by
   ``parse_openmetrics`` with its ``{replica=...}`` samples), ``/healthz``
   and ``/slo``. In every window the paged kernel's launches equal the
   layers times the prefill chunks and decode steps of every engine that
   ran (the killed replica's up to its death, the control engine's).
5g. ``serve_bucketed``: the bucketed baseline engine
   (``BucketedInferenceEngine``, 32 rows in each bucket of 32–512 tokens)
   against paged engines on the kernel over the same full-width params at
   equal KV bytes (the pool holds the buckets' timeline tokens): admitted
   concurrency at the selftest's 6 + 6 mix (>= 2x; the paged engine with a
   row for every page, and with 32 rows), 32 seeded prompts through both
   (streams under ``_streams_agree``; the paged kernel's launches equal 12 x
   the paged engine's programs, the bucketed engine launches none),
   tokens/s of each, and a 32-row decode step's host ms and device ms
   (``device_ms``) of each.
5h. ``serve_selftest``: ``serve.server.selftest`` and ``_selftest_quant``
   on the card in process (each returns 0: >= 2x concurrency at equal KV,
   0 dropped, fp32 paged/bucketed and kernel/gather streams bitwise, int8
   drift under 0.05, the memory pass pricing int8 bytes, 2 programs; the
   JSON lines emitted, the paged kernel's launches counted), then
   ``python -m autodist_tpu_torch.serve --selftest`` as a child process
   (exit 0).
5i. ``serve_infer``: one-shot ``InferenceEngine.infer`` through
   ``AutoDist.build_inference(apply_fn=)`` of bert_base (seq 512, batch 32,
   bf16, "auto" attention: 12 flash forwards a call) and ResNet-50 (224 px,
   batch 128, bf16: 36 conv-stats launches a call): each output finite and
   as close to the plain bf16 forward (dot attention; the plain conv-stats
   op) as ``INFER_DRIFT_FACTOR`` times that forward's distance from the
   plain fp32 forward (relative L2); host and device ms of a call.
6. ``flash_parity``: the flash forward, dK/dV and dQ kernels against their
   plain versions on the same inputs (B=32, H=12, D=64; bf16 at S=512
   causal and not, S=128 and S=256 causal; fp32 at S=512, the FMA
   kernels; then seq_parallel's shapes, B=2, S=4096 causal bf16 at H=12
   and at a 3-head Ulysses group), each output within the stated tolerances; the bf16 O, dK, dV
   and dQ also element by element within ``flash_bounds`` (err/bound and
   the relative L2 distance reported); timed beside the plain versions, SDPA
   pinned to one backend (forward; backward for the two backward kernels)
   and the bound.
7. ``conv_stats_parity``: the fused 1x1-conv + BatchNorm-statistics kernel
   against its plain version at the 15 distinct shapes of ResNet-50's 36
   bottleneck 1x1 convs at batch 128 in bf16, and at the first in fp32, then
   at every distinct shape of an Inception-v3 (299 px, 40 fused convs) and
   a DenseNet-121 (224 px, 58) forward at batch 128 in bf16, found by a
   forward on meta tensors; a repeated launch bitwise equal; timed beside
   the plain version, ``torch.matmul`` + moments, ``torch.matmul`` alone and
   the bound; then ``conv_stats_forward`` for each model: Σ launches x ms
   over a forward beside Σ launches x bound.
7a. ``conv_split_shapes``: the same checks and times at every distinct
   ``(M, K, N)`` one rank launches in a ResNet-50 forward (batch 128, bf16)
   under ``TensorParallel`` at data 1 x model 2 and x model 4, from the
   plan's renderings and a forward on meta tensors: each 1x1 conv on its
   rank's ``N / d`` output columns, column- or row-split alike
   (``layers.conv_batchnorm`` launches a row-split conv on the gathered
   kernel's column block); N down to 16.
7b. ``crossover``: the committed H100 tables (``ops/measured/``, written
   by ``tools/torch_crossover_sweep.py``): ``"auto"`` resolves bert_base's
   seq 512 to flash on the card in bf16 (dot in fp32, which the table does
   not cover) and the serve runs' decode shape as the paged table says;
   bert_base (batch 32) timed with dot and with flash
   (CUDA events, median of 3 windows of 5 steps): flash must be faster.
8. ``train``: bert_base (10 steps) and the causal transformer (4 steps)
   through ``AutoDist(strategy_builder=AllReduce()).build`` and
   ``step.run``, each flash kernel launched exactly ``num_layers x steps``
   times; and ResNet-50 (10 steps), the fused kernel launched exactly
   ``36 x steps`` times and no flash kernel; every loss finite, the last
   below the first.
9. ``train_check``: one step's loss and gradients through the flash
   kernels against the plain (``dot``) path, and both against the same
   model in fp32, at full width within stated bf16 bounds; and
   PSLoadBalancing's first-step loss equal to AllReduce's.
10. ``resnet_check``: ResNet-50 at full width, batch 8, one step's loss and
    gradients: the bf16 kernel path against the model in fp32 on the card
    within stated bf16 bounds (whole model and block by block), and the
    fp32 card run against the fp32 plain path on the CPU within
    summation-order bounds; one forward of every depth (18–152) at 224 px
    launches the kernel once per 1x1 conv; PSLoadBalancing's first-step
    loss equal to AllReduce's.
10b. ``data_fit``: the data pipeline and the training loop as a user runs
    them. An ImageNet-shaped dataset (``DATA_ROWS`` uint8 256x256x3 images
    and int32 labels of 1000 classes, from the seed; two shards, ~126 MB)
    is written with the port's ``DatasetWriter`` into a temporary directory
    and opened with ``DataLoader.from_files(engine="native",
    transform=imagenet.augment(crop=224))``; the augmented loader alone is
    timed with the native and the python engine (images/s), also without
    the augmentation (the gather alone); ``device_prefetch=2`` must give
    the plain plan path's device batches bitwise (its gather and augment
    run on the loader's producer thread). ResNet-50 (224
    px, 1000 classes, bf16, batch 128) is built through ``AutoDist.build``
    and fitted twice per step and once with ``window=4`` over the same
    batches, each with an eval point and
    ``eval_metrics_fn=classification_metrics(top_k=(1, 5))``: every loss
    finite, the windowed history equal to the per-step one (bitwise when the
    two per-step runs are, else within twice their spread), the fused
    conv-stats launches exactly ``36 x`` (train steps + eval forwards +
    metric forwards) in every window, no flash launch. A plain fit gives the
    step's images/s under ``fit``, the same fit under ``torch.profiler``
    the card's busy share (kernel time over the unprofiled wall), and a fit
    from a ``device_prefetch=2`` loader its images/s with the augmentation
    beside the step. ``evaluate_dataset`` over an ``eval_transform(crop=224)``
    loader; on one eval batch whose labels are set from the model's own
    ranking (a quarter top-1 hits, a quarter top-5 hits only, a quarter
    misses at rank 8), ``evaluate_dataset``'s top1 and top5 must equal a
    plain stable-sort top-k of ``spec.apply``'s logits. Then
    the causal ``transformer`` at full width (seq 512, flash) fits
    ``DATA_LM_STEPS`` steps from an in-memory native loader of token rows
    with ``eval_metrics_fn=lm_metrics(pad_id=0)``: the flash forward
    launched ``12 x`` (steps + eval forwards), dK/dV and dQ ``12 x`` steps.
11. ``zoo_train``: each ``ZOO`` configuration through
    ``AutoDist(strategy_builder=AllReduce()).build`` (default SGD), one
    warm-up step and a window of ``ZOO_STEPS``: host wall a step, the rate
    (images, tokens or examples a second), MFU where the spec has
    ``flops_per_example``, the losses (finite, the last below the first),
    peak memory; Inception and DenseNet launch the fused kernel 40 and 58
    times a step (its forward, as the meta-tensor spy of phase 7 counted;
    its backward is two products), the others never.
12. ``zoo_check``: the zoo models with no kernel of the port (VGG-16,
    LM1B, NCF, MoE) at their published widths in fp32, batch 8: the first
    step's loss and whole gradient through the built step on the card
    against the CPU's plain path from the same weights (1e-5, and 1e-4
    relative, VGG-16's 1e-2: ``ZOO_CHECK``).
13. ``optim_check``: the ``mlp`` in fp32, 3 steps on the card with each of
    adagrad, rmsprop, lamb, lion, adafactor, nesterov momentum and the
    cosine, exponential, warmup_cosine, piecewise and linear schedules,
    against the same update rules on the CPU (1e-5 relative).
14. ``remat_check``: bert_base (seq 512, batch 32, flash) built with no
    remat, ``remat=True`` and ``remat="dots_saveable"`` (the whole loss
    checkpointed) and with ``TransformerConfig.remat`` (each block): one
    step's loss and gradients against the run without remat (1e-6 relative;
    whether bitwise equal is reported), the flash forward launched twice a
    layer under remat and dK/dV and dQ once, and each run's host wall and
    peak memory.
15. ``accum_check``: the fp32 causal transformer (full width, seq 512,
    flash), first step at batch 8 with ``grad_accum_steps=4`` against 1:
    loss and whole gradient within 1e-5 relative.
15b. ``checkpoint_train``: one process of this script (``--ckpt-rank``,
    deterministic algorithms): bert_base (seq 512, batch 32, adamw with
    ``clip_norm`` 1.0, "auto" attention) and ResNet-50 (batch 128,
    momentum) through ``AutoDist.build``: 10 steps unbroken, twice (bitwise
    repeatable or not, reported), and 5 steps, ``step.save``, a fresh step
    ``init_or_restore``d, 5 more: the resumed losses equal the unbroken
    run's bitwise (or within its own spread, and which case held is
    printed); one ``block=False`` save, ``wait()``, the same files; save and
    restore ms and the checkpoint's MB; every flash (or conv-stats) launch
    of the 30 steps counted.
15c. ``saved_model``: bert_base's forward (batch 8, seq 512) exported
    (``SavedModelBuilder``, ``torch.export``), loaded and run: bitwise the
    eager forward, the flash forward's operator in the program once a layer
    and its kernel launched that many times by the loaded program.
16. ``dist_train``: the multi-device step on ``torch.distributed``. One
    NCCL rank per visible card (a power of two, at most 8) is started as a
    process of this script (``--dist-rank``) and trains bert_base (seq 512,
    global batch 32, flash) and ResNet-50 (224 px, global batch 128) through
    ``AutoDist(init_method=..., world_size=..., rank=...).build`` for 1 + 5
    Adam steps under AllReduce (``bucket_bytes`` 25 MiB), Zero1 and
    PartitionedPS, and rank 0 also through the one-process step (no group)
    from the same params. At world size 1 the two compute the same thing:
    every loss and every final parameter must be bitwise equal (both run
    with deterministic algorithms). At a larger world size the losses are
    held to ``DIST_LOSS_RTOL``. Each step's gradient and parameter
    collectives equal the plan's prediction; the flash kernels launch
    ``num_layers x 5`` times each in bert_base's window and the fused
    conv-stats kernel ``36 x 5`` in ResNet-50's. Printed: ms a step of
    both, the collectives of a step by purpose and kind. ``dist_checkpoint``
    (in each Zero1 row): the Zero1 state, saved by every rank, restores
    into the one-process (unsharded) step bitwise, and that step's
    checkpoint back into the Zero1 step bitwise. Then a rehearsal,
    not a card result: 4 gloo ranks on the CPU (``--dist-cpu-rank``) train
    a small dense model 3 Adam steps under AllReduce with buckets, Zero1,
    PartitionedPS and PS, against the one-process step within rtol 2e-5 /
    atol 2e-6, and one SGD step of a 128x64 model under Horovod-EF and TopK
    against the mean of the ranks' compressed gradients gathered by hand
    (EF within ``REHEARSAL_BF16_STEPS`` bf16 steps, its residuals and TopK
    bitwise).
17. ``sync_options``: the rest of the synchronizer on one NCCL rank on
    cuda:0, started as a process of this script (``--sync-rank``), with
    deterministic algorithms; 1 warm-up step and a counted window each,
    Adam at 1e-4. bert_base (seq 512, batch 32, flash) under plain
    AllReduce and ``AllReduce(compressor=X)`` for Horovod, Horovod-EF,
    PowerSGD and TopK: one more step's synced gradient (the step's own,
    recorded at its sync) against the plain compressor function on the
    card applied to that step's local gradient and state, bitwise for
    Horovod, EF and TopK (and their new residuals), PowerSGD within
    ``POWERSGD_TOL`` of the largest entry (fp64 Gram-Schmidt against
    cuSOLVER); bert_base under ``PS(staleness=2)``: the first 2 steps leave
    the loss where it was, and the parameters equal, bitwise, the plain
    Adam update driven by the synced gradients of 2 steps before; ResNet-50
    (224 px, batch 128) under ``PS()`` built with ``host_offload=True``
    against the resident step: losses and parameters bitwise equal, the
    offloaded parameters and slots pinned between steps, peak and held
    memory of both; bert_base under ``PS(sync=False, staleness=1)`` with 2
    workers on cuda:0, ``round_robin`` (bitwise equal to the same schedule
    by hand with the port's step and optimizer) and ``threads`` (every push
    applied, lags within the bound). Every run: finite losses that fall, the
    flash kernels ``num_layers x`` gradients and the conv-stats kernel ``36
    x`` steps launched in the window, each step's wire equal to the plan's.

18. ``tp_train``: tensor and expert parallelism at degree 1, one NCCL
    rank on cuda:0 (``--tp-rank``, deterministic algorithms): bert_base
    (seq 512, batch 32, flash) under ``TensorParallel`` with a ``model``
    axis, and the MoE (12 layers, d_model 768, 8 experts, seq 128, batch
    32) under ``AllReduce`` with its expert names and an ``expert`` axis,
    1 + 5 Adam steps each through ``AutoDist(mesh_axes=...).build``:
    every loss and parameter bitwise equal to the one-process AllReduce
    step, the wire equal to the plan's, the flash kernels ``num_layers x
    5`` times each in bert_base's window. Degree 2 has no rendering on one
    card (``TP_MODELS``' comment).
18b. ``tp_cnn``: ResNet-50 (224 px, batch 128, bf16) under
    ``TensorParallel`` at data 1 x model n on n NCCL ranks (``--tp-cnn-rank``,
    n the cards up to 4, a power of two), 1 + 3 Adam steps through
    ``AutoDist.build`` against the one-process AllReduce step: bitwise at
    n = 1; at n > 1 the convs split and the losses within 5e-2 of it. Losses
    fall, the wire equals the plan's, the conv-stats kernel ``36 x 3``
    times in the window. One card has no split (model 1): there every
    variable is then placed as the plan at model 2 renders it
    (``Shard(2)``/``Shard(3)``/``Replicate``) on a one-rank model mesh, so
    the convs, BatchNorms and pools run their ``local_map`` routes and the
    fused kernel its column (9) and row (27) routes: the loss and every
    gradient bitwise equal to the plain forward and backward, the kernel
    36 times (not in the kernels line). At n > 1 one fp32 SGD step through
    ``AutoDist.build`` is held to the one-process step: the whole update
    (relative L2) within 1e-4 or twice the one-process step's own change
    when the batch's rows are reversed.

19. ``auto_plan``: the node model ``ResourceSpec.from_local_devices`` reads
    from the card, and ``explain``'s table for bert_base, ResNet-50, LM1B
    and NCF at the zoo's batches (``AUTO_MODELS``) on this card, an 8-GPU
    node and 4 nodes of 8 with the same node model (resource dicts; nothing
    runs there). Auto must send LM1B and NCF to Parallax, and each ranking
    (names and predicted seconds) must equal the one of the same model made
    on the CPU and a spec built from the same constants.
20. ``auto_train``: ``AutoDist(strategy_builder="Auto")`` on bert_base
    (flash, TRAIN_SEQ, TRAIN_BATCH) and NCF (batch 4096), one NCCL rank
    (``--auto-rank``, deterministic algorithms), 1 + AUTO_STEPS Adam steps:
    finite losses, bitwise equal to the builder Auto chose named
    explicitly (the same Strategy JSON), the flash kernels ``num_layers x
    AUTO_STEPS`` times each in bert_base's windows.
21. ``tune``: ``AutoDist.tune`` on bert_base over the dense slate with
    window TUNE_WINDOW on the card: each candidate's measured and predicted
    seconds a step, the fastest selected, the calibration written to a
    temporary directory; the flash launches of every timed step counted.
    At world size 1 the candidates differ only by overhead: the phase
    checks the mechanism, not a ranking.
22. ``sparse_rehearsal``: not a card result: 4 gloo ranks on the CPU
    (``--sparse-cpu-rank``, the card machine's torch) train the sparse
    cases (``SPARSE_CASES``: a 4096 x 16 table at batch 64 under AllReduce,
    PSLoadBalancing and Parallax; LM1B and NCF at small widths under
    Parallax) 3 Adam steps: no row read's collective, and in the table
    cases no collective of the step, moves a quarter of a table; each
    step's bytes by purpose and kind equal the step's prediction; the
    parameters equal the one-process step's within rtol 2e-5 / atol 2e-6.
23. ``supervised_train``: the port's launcher as a user runs it,
    ``python -m autodist_tpu_torch.runtime.launcher --max-restarts 1
    --ft-dir D --trace-out T -- python chip_smoke.py --supervised-script
    ...``, one rank on cuda:0 (world size 1, so no process group;
    deterministic algorithms):
    bert_base (seq 512, batch 32, flash, AllReduce, SGD) under
    ``AutoDist(fault_tolerance=FTConfig(snapshot_every_steps=2))``, each
    step's batch drawn from the seed and the step index. Attempt 0 sends
    itself SIGTERM from a thread while step 3 runs: the preemption hook
    defers to the step boundary, snapshots step 3 and the process dies.
    The launcher restarts it; attempt 1 resumes from that snapshot
    (``resume_from_snapshot``) and runs to step 6. Its parameters must be
    bitwise those of an uninterrupted 6-step run (a process of its own,
    on the card beside the launcher's),
    each attempt's flash forward, dK/dV and dQ launches ``12 x`` its
    steps, and the stitched trace must hold the launcher's span and both
    attempts' ``ft.snapshot.*`` spans. Prints the restart delay, each
    attempt's wall time, the snapshots' device-to-host and write seconds
    and bytes.
24. ``seq_parallel``: the causal ``transformer`` at full width with a
    ``SEQ_LEN`` (4096) context, batch ``SEQ_BATCH``, bf16, trained 1 +
    ``SEQ_STEPS`` SGD steps through ``AutoDist.build`` with
    ``attention_impl="ring"``, then ``"ulysses"``, over a data x seq mesh
    with seq the largest power of two up to min(cards, 4), one NCCL rank a
    card started as processes of this script (``--parallel-rank``, which
    runs this phase and then ``pipeline`` in one group). Rank 0 also
    trains the same model with ``"flash"`` alone: each run's losses within
    ``CHECK_LOSS_RTOL`` of it and its parameter updates within
    ``CHECK_GLOBAL_RTOL`` (relative L2). The flash forward, dK/dV and dQ
    kernels launch ``12 x SEQ_STEPS`` times each under Ulysses (on each
    rank's head group) and under ring on a seq axis of 1 (its fallback),
    none under ring on a wider axis (its chunk merge is plain tensor
    code). Then, on cuda:0 with no collective, ``_chunk_merge`` over
    ``SEQ_CHUNKS`` chunks of a 4096-token bf16 sequence in ring order,
    causal and not, against the fp32 plain attention within the
    per-element bound ``chunk_merge_check`` derives. The flash kernels are
    held to their plain versions at this phase's shapes in ``flash_parity``
    (``seq_flash_cases``: batch 2, 4096 tokens, causal, 12 heads and a
    3-head Ulysses group).
25. ``pipeline``: bert_base (seq 512, batch 32, bf16, flash) as 4 stages
    of 3 blocks (stacked ``[4, ...]`` block params, the stage function the
    port's ``_block``; its embedding computes the input outside the
    pipeline and its MLM loss over the fixed tied table is the loss head)
    through ``AutoDist.build_pipeline`` with ``PIPE_MICRO`` microbatches,
    1 + ``PIPE_STEPS`` SGD steps, over a data x pipe mesh with pipe as in
    seq_parallel (the same ``--parallel-rank`` processes; on one card the
    sequential fallback).
    Rank 0 also runs the plain sequential step by hand (each microbatch
    through the 12 blocks, the mean loss, SGD): losses within
    ``CHECK_LOSS_RTOL``, updates within ``CHECK_GLOBAL_RTOL``. Flash
    launches: ``12 x PIPE_STEPS`` each on one card; on more, each rank's
    3 blocks x ``PIPE_MICRO`` microbatches a step for dK/dV and dQ and
    twice that for the forward (the interleaved loop recomputes it).
    Printed: ms a step, the plain step's and the sequential fallback's
    (``build_pipeline`` on one card; on more, rank 0 times it alone) and,
    on more than one card, the bubble (``bubble_vs_sequential``: 1 - the
    sequential step's ms over the cards, over the pipeline's ms) and the
    peak memory and ms of one call of each schedule (gpipe, 1f1b,
    interleaved).
26. ``parallel_rehearsal``: not a card result: 4 gloo ranks on the CPU
    (``--parallel-cpu-rank``, the card machine's torch): ring and Ulysses
    forward and gradients at seq 4, causal and not, against the plain
    attention; gpipe, 1f1b and the interleaved loop (outputs, stage and
    input gradients) and ``build_pipeline``'s 3 SGD steps at pipe 4 and
    data 2 x pipe 2 against the stages in sequence; a small transformer's
    3 steps under ring and Ulysses at data 2 x seq 2 against the
    one-process step; all within rtol 2e-5 / atol 2e-6.
27. ``tp_models_rehearsal``: not a card result: 4 gloo ranks on the CPU
    (``--tp-models-cpu-rank``, the card machine's torch) train the zoo
    outside the transformer family at toy widths through ``AutoDist.build``
    (``TPM_CASES``): ResNet-18 under ``TensorParallel`` and
    ``PartitionedAR`` at data 2 x model 2 and under ``AllReduce`` at data 2
    x expert 2, VGG-11, DenseNet and Inception-v3 under ``TensorParallel``
    (one SGD step each: the whole update within 1e-4, relative L2, of the
    one-process step's or twice that step's own change when each data
    rank's rows are reversed), lstm_lm and ncf under ``TensorParallel`` and
    the small transformer under ``Zero1`` with ``clip_norm`` (3 steps,
    within rtol 2e-5 / atol 2e-6); every rank's parameters equal.
28. ``three_axis`` (``--three-axis-rank``, one NCCL rank a card,
    deterministic algorithms). Below four cards, placed checks at full
    width on one rank: the MoE at its registry config (4 layers, d_model
    512, 8 heads, 8 experts, seq 128, bf16, batch 32) with every variable
    placed as ``TensorParallel``'s plan at model 2 x expert 2 splits it on a
    one-rank two-dim (model, expert) mesh (``[Shard(d), Replicate()]`` a
    model-split variable, ``[Replicate(), Shard(0)]`` an expert-split one);
    bert_base (seq 512, batch 32) under Ulysses and under ring, placed as
    the plan at model 2 splits it, on a mesh that names a seq axis of 2
    over a one-rank seq group (``_seq_rig``: the seq-parallel route through
    ``local_map`` runs, each rank's chunk the whole sequence); bert_base
    under flash attention placed at model 2 x expert 2 on the two-dim mesh
    (its heads split on model, whole over expert); ResNet-50 (224 px,
    batch 32) placed at model 2 x expert 2. Each loss and every gradient
    must be bitwise the plain run's; Ulysses and the two-dim flash route
    each launch each flash kernel 12 times, ResNet-50 the fused kernel 36. On four cards, the
    2 x 2 meshes with data 1 (``THREE_MESHES``: the MoE at model x expert
    under ``TensorParallel``, bert_base under Ulysses and ring at seq x
    model, bert_base's 12 blocks as 2 stages through ``build_pipeline`` at
    pipe x model and seq x pipe): 1 + 3 bf16 Adam steps whose losses fall,
    the data-axis wire as the plan's, and one fp32 SGD step within 1e-4 or
    twice the one-process step's own change with the batch's rows reversed
    (relative L2 of the update); printed beside them the ms a step of data
    4 and of the two-axis meshes they extend (``THREE_BASELINES``), and
    ``DTensor``'s collectives of a step by axis. The flash kernels are held
    to their plain versions at the four-card Ulysses shape in
    ``flash_parity`` (3 heads a rank at S=512, batch 32).
29. ``three_axis_rehearsal``: not a card result: 8 gloo ranks on the CPU
    (``--three-axis-cpu-rank``, the card machine's torch) run
    ``tests/test_torch_three_axis*.py``'s configurations at toy widths
    (``THREE_REHEARSAL``: the MoE at data 2 x model 2 x expert 2 and at
    data 2 x seq 2 x expert 2 under Ulysses, the transformer under Ulysses
    and ring at data 2 x seq 2 x model 2, under ``TensorParallel`` at data 2
    x pipe 2 x model 2 and ring at data 2 x seq 2 x pipe 2, pipelines at
    both pipe meshes), 3 SGD steps each, against the one-process step within
    rtol 2e-5 / atol 2e-6.

The CPU rehearsals (16's and phases 22, 26, 27 and 29: gloo ranks on the
CPU) run on a thread beside the card phases from ``dist_train`` on, each of
which runs in processes of its own; ``auto_plan`` and ``tune`` run before
them. So the host-timed numbers of those card phases (ms a step, walls)
are read beside a busy CPU. Every JSON line carries ``t_s``, the seconds
since the script started.
Kernels and library calls are timed as CUDA graphs of repeated calls (card
time without the host's, ``device_ms``), plain versions as eager calls.
Then the kernel table line, the card line and, last, the result line.
Exits non-zero (printing no result) without CUDA, outside a checkout of the
repo, or when any phase fails.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import gc
import io
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import asdict, replace
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.checkpoint import SavedModelBuilder, Saver, load_saved_model
from autodist_tpu_torch.data import DataLoader, DatasetWriter
from autodist_tpu_torch.data import imagenet
from autodist_tpu_torch.checkpoint.saver import ShardedLeaf, flatten_with_names
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer, Mesh, build_mesh
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.models import PUBLISHED, get_model, get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import lstm_lm
from autodist_tpu_torch.models import resnet as rn
from autodist_tpu_torch.models import vgg
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import (flatten_params, map_params,
                                                unflatten_params)
from autodist_tpu_torch.ops import _build
from autodist_tpu_torch.ops import crossover as xo
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.ops import paged_attention as pa
from autodist_tpu_torch import parallel as par
from autodist_tpu_torch.parallel.ring_attention import _chunk_merge as chunk_merge
from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.obs import (SLOSpec, Sentry, SentryConfig, parse_openmetrics,
                                   recorder as obs_recorder, replay_flight_records)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.runtime.async_ps import AsyncPSTrainer
from autodist_tpu_torch.strategy import AllReduce, PSLoadBalancing, StrategyCompiler, from_name
from autodist_tpu_torch.serve import sampling as samp_ops
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve import engine as serve_engine
from autodist_tpu_torch.serve.engine import (BucketedInferenceEngine, EngineDeadError,
                                             InferenceEngine)
from autodist_tpu_torch.serve.router import (TEST_SLO_SPEC, RouterConfig, build_test_fleet,
                                            calibrated_configs, fleet_trial)
from autodist_tpu_torch.serve.server import (RouterFrontend, ServeFrontend,
                                             _admission_capacity, mock_load_prompt)
from autodist_tpu_torch.serve.spec import SpecDecodeEngine, pools_balanced

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and per-type rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

H, D, PAGE_LEN, P = 12, 64, 16, 32
# bf16 kernel vs a plain version computed in fp32 on the same bf16 values:
# the kernel rounds its fp32 result to bf16 once (relative 2^-9), so 1e-2
# bounds it with room; fp32 inputs differ only in summation order.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Split counts of the paged kernel's walk that kernel_parity checks and
# times beside the main path's own (pa.split_plan).
PAGED_SPLITS = (1, 2, 4, 8)
# Teacher-forced max |Δlogit| of the kernel path vs the plain (bf16 gather)
# path at full width: the two round attention to bf16 at different points
# (the kernel once, at its output; the gather path also in its einsums). At
# the random-weight model's |logits| < 4 one bf16 step is at most 2^-6; the
# bound is 8 such steps.
STREAM_LOGIT_BOUND = 0.125
SEED = 0
N_REQUESTS, MAX_NEW = 64, 32
# serve_features: stochastic sampling's params; speculative decode's k and
# the divergent draft's depth; prefix sharing's 512-token system prompt with
# 16-64-token suffixes (the positional table widened to 1024 to hold them),
# every COW_EVERY-th suffix opening with COW_SHARED tokens of a cached one
# (a copy-on-write page and a prefill that starts mid-page).
FEATURE_SAMPLING = dict(temperature=0.8, top_p=0.9, top_k=50)
SPEC_K, DRAFT_LAYERS = 4, 2
SYSTEM_LEN, SUFFIX_LENS, PREFIX_MAX_SEQ = 512, (16, 65), 1024
# The prefix run serves PREFIX_REQUESTS of them (cold, then cached): each
# cold prompt is 33-36 prefill chunks of PAGE_LEN tokens.
PREFIX_REQUESTS = 64
COW_EVERY, COW_SHARED = 8, 5
# The card's sample_tokens against the CPU's on the same logits: the Gumbel
# noise of the two may differ by GUMBEL_ULPS ulps at max(|g|, 1) (their
# logs round differently; tests/test_torch_sampling.py), so a row may pick
# another token only where the two tokens' scores lie within twice that;
# such rows are held to NEAR_TIE_SHARE.
SAMPLE_ROWS, GUMBEL_ULPS, NEAR_TIE_SHARE = 1024, 4, 0.005
# Flash kernels vs their plain versions on the same bf16 inputs: both work
# in fp32 and round each output to bf16 once (2^-8 relative), so 2e-2
# absolute and relative bounds them with room; the fp32 lse differs only in
# summation order (1e-3).
FLASH_TOL, LSE_TOL = 2e-2, 1e-3
# fp32 inputs take the FMA kernels, which differ from the plain versions in
# summation order only.
FLASH_F32_TOL = 1e-4
FLASH_B, FLASH_H, FLASH_D = 32, 12, 64
# The bf16 forward, dK/dV and dQ kernels multiply on the tensor cores; each
# of their outputs is also held, element by element, to a bound on what the
# two arithmetics may differ by (flash_bounds). E is fp32's unit roundoff; a sum
# of n terms in another order moves by at most n E of the terms' magnitudes
# on the plain side and n 2E on the kernel's (the tensor cores align and
# truncate inside an mma, up to one fp32 ulp an addition): 3 n E together.
FLASH_E = 2.0 ** -24
FLASH_BF16_STEP = 2.0 ** -7     # one bf16 step is at most 2^-7 of the value
FLASH_SPLIT = 2.0 ** -16        # hi/lo split of P and dS: 2^-8 of 2^-8
# The bf16 dK, dV and dQ carry the reference's fp32 arithmetic to about
# 2^-16 before their rounding, so they differ from the plain versions only
# where the two fp32 values round to neighbouring bf16 values: about 1e-4
# relative L2 in all (1.0e-4 to 1.1e-4 measured on the H100 at S=512,
# PERF.md). The share of elements that round apart follows the fp32
# disagreement, which grows with the number of terms summed (3 n E above),
# so the relative L2 grows as its square root: above S=512 the limit scales
# by sqrt(S / 512) (flash_grad_rel_l2).
FLASH_GRAD_REL_L2 = 2e-4
FLASH_MMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_dkdv_bf16_kernel",
                     "flash_dq_bf16_kernel")
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 32, 10
LM_BATCH, LM_STEPS = 8, 4
# Flash (kernel) path vs the plain dot path at full width, bf16 compute,
# both also held against the same model in fp32 (dot). Bounds:
# - loss within 1e-2 relative of the dot path's (bf16 rounds at 2^-8);
# - the whole gradient (all tensors as one vector) within 3e-2 relative L2
#   of the fp32 gradient for each path, and of each other: hundreds of
#   independent bf16 roundings average out to about 1% (1.0-1.1% for
#   `tools/torch_flash_accuracy.py --small` on the CPU);
# - each gradient tensor whose norm is at least 1e-3 of the whole within
#   0.15 relative L2 of the dot path's. The flash backward takes delta =
#   rowsum(dO * O) from the bf16-rounded O, as the JAX kernel does, so dS
#   misses summing to zero over the keys by a rounding-sized term; at
#   initialisation the query/key projections' true gradients are small and
#   that term is a sizeable part of them (5.7% vs fp32 for the same tool
#   on the CPU, 1.8% with O kept in fp32). Smaller tensors are covered by
#   the whole-gradient bound.
CHECK_LOSS_RTOL, CHECK_GLOBAL_RTOL, CHECK_GRAD_RTOL = 1e-2, 3e-2, 0.15
CHECK_NORM_FLOOR = 1e-3
CHECK_BATCH = 8
# conv_stats_parity: the 15 distinct shapes of ResNet-50's 36 bottleneck 1x1
# convs at batch 128, 224 px, [M = B*H*W, K, N], with each one's launches in
# a forward (models/resnet.py; stages 0-3). The first is the main shape.
CONV_SHAPES = (((401408, 64, 256), 4), ((401408, 64, 64), 1), ((401408, 256, 64), 2),
               ((401408, 256, 128), 1), ((100352, 128, 512), 4), ((100352, 256, 512), 1),
               ((100352, 512, 128), 3), ((100352, 512, 256), 1), ((25088, 256, 1024), 6),
               ((25088, 512, 1024), 1), ((25088, 1024, 256), 5), ((25088, 1024, 512), 1),
               ((6272, 512, 2048), 3), ((6272, 1024, 2048), 1), ((6272, 2048, 512), 2))
# Kernel vs plain version on the same inputs. Each side sums in fp32 in its
# own order, and a sum of n terms in any order is within n * 2^-24 of the
# terms' magnitudes (the worst case); so
# - y: |dy| <= 2K * 2^-24 * (|x| @ |w|), plus in bf16 one step of the
#   output (2^-7 of |y|) for the rounding of the two sums;
# - s1, s2: |ds| <= 1e-4 * (sum |y32|, sum y32^2): no term goes through more
#   than fcs.chain_length additions (45 at most at these shapes in bf16, 369
#   in fp32; each case checks it against 1e-4 / 2^-24 = 1,677).
CONV_Y_STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 0.0}
CONV_STAT_TOL = 1e-4
RESNET_BATCH, RESNET_STEPS = 128, 10
# resnet_check, ResNet-50 at full width, batch 8.
# - fp32 on the card (kernel, cuDNN without TF32) against fp32 on the CPU
#   (plain version): they differ in summation order only. At
#   initialisation the model amplifies such differences with depth, so the
#   whole gradient is held to 3x the CPU's own change when the batch is
#   reversed (the same sums in another order), measured in the phase; the
#   loss (1e-5) and the head's gradient (1e-4), which see the forward and
#   no backward through BatchNorm, are held directly.
# - bf16 against fp32 on the card: the same amplification carries bf16's
#   rounding (2^-8) to O(1) differences in the deep gradients, as it does
#   in the JAX model (tests/test_torch_resnet.py), so the whole model's
#   gradient difference is reported, not bounded. The loss, a batch average
#   of log-sum-exps, moves far less and is held to 5e-2. Block by block, at
#   each stage's first bottleneck (with its stride and its projection),
#   against a random upstream gradient: the output within
#   2e-2 (a few bf16 roundings of 2^-8), the whole block gradient within
#   0.15 and each tensor of at least 1e-3 of its norm within 0.2 (ReLU masks
#   flip where bf16 rounds a value across 0, and sums of signed gradients
#   cancel, as in train_check's bound).
RESNET_FP32_LOSS_RTOL, RESNET_FP32_HEAD_RTOL, RESNET_SPREAD_FACTOR = 1e-5, 1e-4, 3.0
RESNET_BF16_LOSS_RTOL = 5e-2
RESNET_BLOCK_Y_RTOL, RESNET_BLOCK_GRAD_RTOL, RESNET_BLOCK_TENSOR_RTOL = 2e-2, 0.15, 0.2
# data_fit: DATA_ROWS ImageNet-shaped rows (DATA_STORED px uint8, 1000
# classes) in shards of DATA_SHARD_ROWS, cropped to DATA_CROP; ResNet-50 fits
# DATA_STEPS steps of RESNET_BATCH a run with an eval point at the last
# (window DATA_WINDOW in the windowed run); the causal transformer
# DATA_LM_STEPS steps of LM_BATCH rows from DATA_LM_ROWS, an eval point every
# DATA_LM_EVAL_EVERY, its eval batch padded with 0 from DATA_LM_VALID.
DATA_ROWS, DATA_SHARD_ROWS, DATA_STORED, DATA_CROP, DATA_CLASSES = 640, 320, 256, 224, 1000
DATA_STEPS, DATA_WINDOW = 4, 4
DATA_LM_ROWS, DATA_LM_STEPS, DATA_LM_EVAL_EVERY, DATA_LM_VALID = 32, 4, 2, 448
# zoo_train: the published widths of examples/benchmark/train.py, nothing
# cut (ResNet-50 has its own phase): (key, zoo name, overrides, batch, what
# a step's rate counts).
ZOO = tuple((key, *cfg) for key, cfg in PUBLISHED.items() if key != "resnet50")
ZOO_STEPS = 5
# The two zoo models whose 1x1 convs feed a BatchNorm: their fused conv-stats
# launches a forward, and the shapes conv_stats_parity adds for them.
CONV_ZOO = {"inceptionv3": 40, "densenet121": 58}
# zoo_check: the zoo models with no kernel of the port, at fp32 compute and
# batch CHECK_BATCH: card vs CPU from the same weights. The loss within
# 1e-5 and the whole gradient within 1e-4 relative (summation order), but
# VGG-16's within 1e-2: its convolutions take other algorithms on the two
# devices (cuDNN's, oneDNN's), and a ReLU input or a max-pool pair that lies
# within that difference of a tie sends its gradient another way through 13
# convs and 5 pools of 224 px maps (1.5e-3 measured on an H100). Either
# bound still fails a gradient off by a factor or a table update lost.
ZOO_CHECK_LOSS_RTOL = 1e-5
# model -> its gradient bound.
ZOO_CHECK = {"vgg16": 1e-2, "lm1b": 1e-4, "ncf": 1e-4, "moe": 1e-4}
# optim_check: the mlp in fp32 on the card against the same update rules on
# the CPU, 3 steps; card and CPU differ in summation order only.
OPTIM_RTOL, OPTIM_STEPS, OPTIM_BATCH = 1e-5, 3, 64
OPTIM_CASES = (
    ("momentum", {"learning_rate": 0.05, "nesterov": True}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "weight_decay": 0.01}),
    ("lion", {"learning_rate": 0.001}),
    ("adafactor", {"learning_rate": 0.01}),
    ("sgd", {"learning_rate": {"schedule": "cosine", "init_value": 0.1, "decay_steps": 2}}),
    ("sgd", {"learning_rate": {"schedule": "exponential", "init_value": 0.1,
                               "transition_steps": 2, "decay_rate": 0.5, "staircase": True}}),
    ("sgd", {"learning_rate": {"schedule": "warmup_cosine", "peak_value": 0.1,
                               "warmup_steps": 1, "decay_steps": 3}}),
    ("sgd", {"learning_rate": {"schedule": "piecewise", "init_value": 0.1,
                               "boundaries_and_scales": {"1": 0.5, "2": 0.1}}}),
    ("sgd", {"learning_rate": {"schedule": "linear", "init_value": 0.1, "end_value": 0.01,
                               "transition_steps": 2}}),
)
# remat_check and accum_check: one step's loss and gradients against the
# run without the option. remat recomputes the same ops on the same inputs
# (bitwise equal where the kernels and cuBLAS are deterministic, reported);
# accumulation adds the same terms in another order: 1e-5 relative (the
# whole gradient as one vector).
REMAT_RTOL, ACCUM_RTOL, ACCUM_BATCH, ACCUM_K = 1e-6, 1e-5, 8, 4
# dist_train: 1 + DIST_STEPS Adam steps a (model, strategy), the last
# DIST_STEPS timed; the ranks' and the rehearsal's time limits.
DIST_STEPS, DIST_OPT = 5, ("adam", {"learning_rate": 1e-4})
DIST_BUILDERS = (("AllReduce", {"bucket_bytes": 25 << 20}), ("Zero1", {}),
                 ("PartitionedPS", {}))
DIST_TIMEOUT_S, DIST_GROUP_TIMEOUT_S = 420.0, 120.0
# At a world size above 1 the ranks' mean of local mean losses against the
# one-process step's: bf16 rounds the two orders of summation apart (2^-8),
# and ResNet's BatchNorm under AllReduce with buckets and Zero1 (JAX's
# manual sync) normalises over each rank's images, not the global batch's.
DIST_LOSS_RTOL = {"bert_base": 1e-2, "resnet50": 5e-2}
# The rehearsal: the e2e dense model of tests/test_e2e_numeric.py.
REHEARSAL_RANKS, REHEARSAL_STEPS = 4, 3
REHEARSAL_BUILDERS = (("AllReduce", {"bucket_bytes": 64}), ("Zero1", {}),
                      ("PartitionedPS", {}), ("PS", {}))
REHEARSAL_RTOL, REHEARSAL_ATOL = 2e-5, 2e-6
# The rehearsal's compressed step: a 128x64 kernel (8192 elements, over
# TopK's min_size of 4096) and its bias, SGD at REHEARSAL_LR, one step.
# Gloo sums the four bf16 payloads of EF in bf16, rounding its partial
# sums; each rounding moves a sum by at most one bf16 step (2^-8) of the
# magnitudes summed, so the synced gradient lies within
# REHEARSAL_BF16_STEPS such steps of the exact mean of the payloads
# (tests/test_torch_dist_sync_options.py measures 2.90 with XLA's one
# rounding on the other side). TopK's gathered pairs are scatter-added in
# rank order: bitwise equal to the hand-made sum.
REHEARSAL_COMPRESSORS = ("HorovodCompressorEF", "TopKCompressor")
REHEARSAL_LR, REHEARSAL_BF16_STEPS = 0.05, 3
# sync_options: one NCCL rank on cuda:0 (the checks hold one rank's wire
# to the plain compressor function); bert_base at TRAIN_SEQ, TRAIN_BATCH,
# flash, and ResNet-50 at RESNET_BATCH, each 1 warm-up step and a counted
# window of SYNC_STEPS (the staleness run 1 + SYNC_STALE_STEPS, so that
# its delayed gradients land), Adam at DIST_OPT.
SYNC_STEPS, SYNC_STALENESS, SYNC_STALE_STEPS = 2, 2, 4
SYNC_COMPRESSORS = ("HorovodCompressor", "HorovodCompressorEF", "PowerSGDCompressor",
                    "TopKCompressor")
# PowerSGD on the card (fp32 matmuls, cuSOLVER's Householder QR) against
# the plain function in fp64 with Gram-Schmidt: the synced gradient and the
# residual within POWERSGD_TOL of each tensor's largest entry, the new q
# within it column by column up to sign (QR fixes the columns' signs, which
# the product P Qn^T does not see). fp32 sums over up to 3072 terms carry
# about 1e-6 of the largest term; the orthonormalisation multiplies that
# by the conditioning of the two columns of P.
POWERSGD_TOL = 1e-3
TOPK_RATIO, TOPK_MIN_SIZE = 0.01, 4096
ASYNC_WORKERS, ASYNC_PUSHES, ASYNC_STALENESS = 2, 4, 1
# Host offload: the peak falls by this share of the optimizer slots' bytes,
# and the memory held between steps by this share of all offloaded bytes.
OFFLOAD_SAVING = (0.9, 1.1)
# crossover: bert_base at TRAIN_SEQ and TRAIN_BATCH with dot and with flash,
# each timed as the median of CROSSOVER_WINDOWS CUDA-event windows of
# CROSSOVER_STEPS steps; the serve runs' decode shape (32 rows, a 512-token
# timeline of 32 pages) for the paged rule.
CROSSOVER_STEPS, CROSSOVER_WINDOWS = 5, 3
SERVE_ROWS, SERVE_TABLE_PAGES = 32, 512 // PAGE_LEN
# checkpoint_train: CKPT_STEPS unbroken steps (twice), and CKPT_SPLIT steps,
# a save, a fresh step restored from it and the rest; bert_base under adamw
# with clip_norm 1.0 ("auto" attention: flash at 512 from the H100 table),
# ResNet-50 under momentum, both through AutoDist.build (AllReduce).
CKPT_STEPS, CKPT_SPLIT = 10, 5
CKPT_MODELS = (("bert_base", "bert_base", {"max_seq_len": TRAIN_SEQ}, TRAIN_BATCH,
                ("adamw", {"learning_rate": 1e-4}), 1.0),
               ("resnet50", "resnet", {}, RESNET_BATCH, ("momentum", {"learning_rate": 0.01}),
                None))
# checkpoint_serve: the full-width transformer trained CKPT_SERVE_STEPS steps
# (batch LM_BATCH, seq TRAIN_SEQ) and served from its checkpoint,
# CKPT_SERVE_REQUESTS requests of MAX_NEW tokens; the spec engine's draft
# is a DRAFT_LAYERS-layer model from a params-only checkpoint.
CKPT_SERVE_STEPS, CKPT_SERVE_REQUESTS = 2, 32
# saved_model: bert_base's forward at TRAIN_SEQ, batch EXPORT_BATCH.
EXPORT_BATCH = 8
# tp_train: bert_base at full width (TRAIN_SEQ, TRAIN_BATCH, flash) under
# TensorParallel with a model axis, and the MoE (12 layers, d_model 768, 8
# experts, seq 128, batch 32) under AllReduce with its expert names and an
# expert axis, each through AutoDist.build for 1 + TP_STEPS steps of
# DIST_OPT on one NCCL rank: at degree 1 the plan degrades to data parallelism
# and must be bitwise equal to the one-process AllReduce step. Degree 2 has
# no rendering on this one card: NCCL refuses two ranks on one device, and
# over gloo DTensor's all-gather of CUDA tensors crashes both ranks
# (tools/torch_gloo_cuda_probe.py; PERF.md, ROADMAP.md). The CPU tests'
# 4 gloo ranks are degree 2's proof.
TP_STEPS = 5
TP_MOE = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072, num_experts=8)
TP_MODELS = (
    ("bert_base", "bert_base", {"max_seq_len": TRAIN_SEQ, "attention_impl": "flash"},
     TRAIN_BATCH, "TensorParallel", "model", ()),
    ("moe", "moe_transformer", TP_MOE, 32, "AllReduce", "expert", ("expert_",)),
)

# conv_split_shapes: ResNet-50 (PUBLISHED, batch 128) under TensorParallel
# at data 1 x model d for each d here: the fused kernel at every distinct
# (M, K, N) one rank launches, against its plain version.
CONV_SPLIT_DEGREES = (2, 4)
# tp_models_rehearsal: TPM_CASES (id, model, builder, mesh, steps) on 4
# gloo CPU ranks at toy widths, against the one-process step: ResNet-18
# (width 8), VGG-11, DenseNet (blocks (2, 2), growth 8) and Inception-v3
# (width 1/16) at 32 px, batch 8, 10 classes, fp32, one SGD step at
# TPM_CNN_LR, the whole update (relative L2) within TPM_UPDATE_RTOL or
# twice the one-process step's own change when each data rank's rows are
# reversed; lstm_lm, ncf and the transformer (TPM_LSTM, TPM_NCF, TPM_LM)
# REHEARSAL_STEPS steps at REHEARSAL_LR within REHEARSAL_RTOL / ATOL.
TPM_MESH, TPM_EXPERT = {"data": 2, "model": 2}, {"data": 2, "expert": 2}
TPM_CNN_LR = {"resnet": 3e-3, "vgg": 1e-4, "densenet": 3e-3, "inception": 3e-3}
TPM_UPDATE_RTOL = 1e-4
TPM_LSTM = dict(vocab_size=64, embed_dim=16, hidden=32, num_layers=2, seq_len=8)
TPM_NCF = dict(num_users=64, num_items=48, mf_dim=8, mlp_dims=(16, 16, 8))
TPM_LM = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16,
              attention_impl="dot", dtype="float32")
TPM_CASES = (("resnet/tp", "resnet", "TensorParallel", TPM_MESH, 1),
             ("resnet/partitioned_ar", "resnet", "PartitionedAR", TPM_MESH, 1),
             ("resnet/expert", "resnet", "AllReduce", TPM_EXPERT, 1),
             ("vgg/tp", "vgg", "TensorParallel", TPM_MESH, 1),
             ("densenet/tp", "densenet", "TensorParallel", TPM_MESH, 1),
             ("inception/tp", "inception", "TensorParallel", TPM_MESH, 1),
             ("lstm_lm/tp", "lstm_lm", "TensorParallel", TPM_MESH, REHEARSAL_STEPS),
             ("ncf/tp", "ncf", "TensorParallel", TPM_MESH, REHEARSAL_STEPS),
             ("transformer/zero1-clip", "transformer", "Zero1", TPM_MESH, REHEARSAL_STEPS))
TPM_CLIP = 0.5
# tp_cnn: ResNet-50 (PUBLISHED, batch 128, bf16) under TensorParallel at
# data 1 x model n on n NCCL ranks (_pow2_ranks), 1 + TP_CNN_STEPS steps of
# DIST_OPT, against the one-process AllReduce step: bitwise at n = 1;
# losses within DIST_LOSS_RTOL["resnet50"] and falling at n > 1. Adam's
# first steps scale each element to about the learning rate, so its update
# moves with any rounding (relative L2 about 1 between correct runs): at
# n > 1 one fp32 TP_CNN_SGD step is held to the one-process step within
# TP_CNN_UPDATE_RTOL or twice that step's own change when the batch's rows
# are reversed (the whole update, relative L2). At n = 1 the model is also
# placed as the plan at model TP_CNN_PLACED renders it, on a one-rank mesh.
TP_CNN_STEPS, TP_CNN_PLACED = 3, 2
TP_CNN_SGD, TP_CNN_UPDATE_RTOL = ("sgd", {"learning_rate": 0.1}), 1e-4

# auto_plan: (key, zoo name, overrides, batch) explain ranks, at the zoo's
# batches (bert_base at TRAIN_SEQ and TRAIN_BATCH with flash); Auto must
# send AUTO_SPARSE to Parallax; the clusters beyond this card: one node of
# AUTO_NODE_GPUS GPUs and AUTO_NODES nodes of them, with the card's node model.
AUTO_MODELS = (("bert_base", "bert_base", {"max_seq_len": TRAIN_SEQ, "attention_impl": "flash"},
                TRAIN_BATCH),) + tuple((key, *PUBLISHED[key][:3])
                                      for key in ("resnet50", "lm1b", "ncf"))
AUTO_SPARSE = ("lm1b", "ncf")
AUTO_NODE_GPUS, AUTO_NODES = 8, 4
# auto_train: 1 + AUTO_STEPS Adam steps (DIST_OPT) of each under Auto and
# under the builder Auto chose, named.
AUTO_STEPS = 5
AUTO_TRAIN = (AUTO_MODELS[0], ("ncf", *PUBLISHED["ncf"][:3]))
# tune: bert_base (AUTO_MODELS[0]) over the dense slate, TUNE_WINDOW steps a
# window (one warm-up window and api._TUNE_TRIAL_WINDOWS timed ones).
TUNE_WINDOW = 2
# sparse_rehearsal: (id, model, builder, overrides, batch) on 4 gloo CPU
# ranks, REHEARSAL_STEPS Adam steps at DIST_OPT, against the one-process
# step within REHEARSAL_RTOL / REHEARSAL_ATOL; "embed" is JAX's
# tests/test_sparse_wire.py model (a 4096 x 16 table, batch 64).
SPARSE_EMBED = (4096, 16, 64)
SPARSE_LSTM = dict(vocab_size=4096, embed_dim=16, hidden=32, num_layers=2, seq_len=8)
SPARSE_NCF = dict(num_users=4096, num_items=2048, mf_dim=8, mlp_dims=(16, 16, 8))
SPARSE_CASES = (("embed/AllReduce", "embed", "AllReduce", {}, 64),
                ("embed/PSLoadBalancing", "embed", "PSLoadBalancing", {}, 64),
                ("embed/Parallax", "embed", "Parallax", {}, 64),
                ("lm1b/Parallax", "lstm_lm", "Parallax", SPARSE_LSTM, 8),
                ("ncf/Parallax", "ncf", "Parallax", SPARSE_NCF, 64))
# The bytes a row-split table's collectives and a step's prediction count.
SPARSE_WIRE = ("grad", "param", "sparse", "table")
# supervised_train: SUP_STEPS steps of bert_base, a snapshot every
# SUP_SNAPSHOT_EVERY steps, SIGTERM while step SUP_PREEMPT_AT runs on the
# first attempt; the launcher's restart backoff base (seconds).
SUP_STEPS, SUP_SNAPSHOT_EVERY, SUP_PREEMPT_AT, SUP_BACKOFF_S = 6, 2, 3, 1.0
SUP_TIMEOUT_S = 300.0
# serve_replica: the CLI's replica at 32 slots (REPLICA_ARGS), 64 requests
# over HTTP then POST /drain, a restart that replays the journal, and
# REPLICA_SIGTERM_LOAD requests cut by SIGTERM; each process's own wait
# bound. The live GET /slo percentiles and those replayed from the flight
# records are the same float64 values put through the same arithmetic:
# SLO_REPLAY_RTOL only absorbs a JSON round trip. The in-process chaos: the
# stall each SEAM_SERVE_STEP call sleeps (past the sentry's itl_min_s and
# 2x the ITL median) and the exhaustion window of SEAM_SERVE_PAGES; the
# decode steps timed with the flight hooks off and on (turns of
# HOOK_COST_STEPS, HOOK_COST_TURNS each).
REPLICA_SLOTS = 32
REPLICA_ARGS = ("--device", "cuda", "--slots", str(REPLICA_SLOTS), "--page-len", str(PAGE_LEN))
REPLICA_SIGTERM_LOAD, REPLICA_TIMEOUT_S = 32, 300.0
SLO_REPLAY_RTOL = 1e-9
STALL_S, EXHAUST_S = 0.15, 1.5
HOOK_COST_STEPS, HOOK_COST_TURNS = 32, 6

# serve_fleet: 3 replicas x 16 slots behind the router, 64 requests of 16
# new tokens, replica 1 killed mid-decode, FLEET_HTTP requests over HTTP;
# FLEET_PAGES holds every row's longest request (44 + 16 tokens: 4 pages)
# twice over.
FLEET_REPLICAS, FLEET_SLOTS, FLEET_REQUESTS, FLEET_NEW, FLEET_KILL = 3, 16, 64, 16, 1
FLEET_PAGES = 1 + FLEET_SLOTS * 8
FLEET_HTTP = 4

# serve_bucketed: the bucketed baseline at full width, BUCKETED_ROWS rows in
# each default bucket up to the model's 512 positions (32, 64, ..., 512),
# against paged engines (the kernel) over the same params at equal KV bytes:
# the pool holds the buckets' timeline tokens in PAGE_LEN-token pages. The
# capacity probe (the selftest's 6 + 6 mix) also runs a paged engine with a
# row for every page, so the pool binds, as it does in the selftest. Streams:
# BUCKETED_ROWS seeded prompts, BUCKETED_NEW tokens each. Timing: every row
# at BUCKETED_TIMING_LEN + BUCKETED_TIMING_NEW (one bucket), host ms a step
# over BUCKETED_TIMING_STEPS steps after two warm-up steps.
BUCKETED_ROWS, BUCKETED_NEW = 32, 32
BUCKETED_TIMING_LEN, BUCKETED_TIMING_NEW, BUCKETED_TIMING_STEPS = 16, 48, 10
# serve_infer: one-shot InferenceEngine.infer of bert_base (seq TRAIN_SEQ,
# batch TRAIN_BATCH, bf16, "auto" attention: flash) and ResNet-50 (224 px,
# batch INFER_RESNET_BATCH, bf16). Each output is held to the plain forward
# (dot attention; the plain conv-stats op) in bf16 on the same inputs: its
# relative L2 distance within INFER_DRIFT_FACTOR times the plain bf16
# forward's own distance from the plain fp32 forward, the bound
# tests/test_torch_resnet.py holds the port's bf16 ResNet to (two bf16
# renderings of one model differ by rounding of the same size as either's
# distance from fp32).
INFER_RESNET_BATCH, INFER_DRIFT_FACTOR = 128, 2.0
# seq_parallel: the flagship causal transformer at full width with a
# SEQ_LEN-token context, SEQ_BATCH rows, 1 + SEQ_STEPS SGD steps (SEQ_OPT)
# under each of SEQ_IMPLS over a data x seq mesh (seq = the cards, a power
# of two up to 4), held to the flash step on one rank: losses within
# CHECK_LOSS_RTOL, the parameter updates within CHECK_GLOBAL_RTOL (relative
# L2). The ring's chunk merge on the card alone: SEQ_CHUNKS chunks.
SEQ_LEN, SEQ_BATCH, SEQ_STEPS, SEQ_CHUNKS = 4096, 2, 3, 4
SEQ_IMPLS, SEQ_OPT = ("ring", "ulysses"), ("sgd", {"learning_rate": 0.01})
# pipeline: bert_base's 12 blocks as PIPE_STAGES stages, PIPE_MICRO
# microbatches of the TRAIN_BATCH x TRAIN_SEQ batch, 1 + PIPE_STEPS SGD steps
# at PIPE_LR through AutoDist.build_pipeline over a data x pipe mesh.
PIPE_STAGES, PIPE_MICRO, PIPE_STEPS, PIPE_LR = 4, 4, 2, 0.01
# three_axis. Below four cards, placed on one-rank meshes as TensorParallel's
# plans split them: the MoE (registry config, batch THREE_MOE_BATCH) and
# ResNet-50 (batch THREE_RESNET_BATCH) at THREE_ME, bert_base (TRAIN_SEQ,
# THREE_BERT_BATCH) under each of SEQ_IMPLS on a seq x model mesh and under
# flash at THREE_ME. On four
# cards the 2 x 2 meshes of THREE_MESHES ((id, model, mesh, builder,
# attention), data 1): 1 + THREE_STEPS bf16 steps (THREE_BF16_OPT) whose
# losses must fall, and one fp32 THREE_SGD step within THREE_UPDATE_RTOL or
# twice the one-process step's own change with the batch's rows reversed
# (relative L2 of the update); the ms of THREE_BASELINES beside them.
THREE_ME = {"data": 1, "model": 2, "expert": 2}
THREE_MOE_BATCH, THREE_BERT_BATCH, THREE_RESNET_BATCH = 32, TRAIN_BATCH, 32
THREE_STEPS, THREE_BF16_OPT = 3, DIST_OPT
THREE_SGD, THREE_UPDATE_RTOL = ("sgd", {"learning_rate": 0.1}), 1e-4
THREE_MESHES = (
    ("model2expert2", "moe", THREE_ME, "TensorParallel", None),
    ("seq2model2/ulysses", "bert", {"data": 1, "seq": 2, "model": 2}, "TensorParallel",
     "ulysses"),
    ("seq2model2/ring", "bert", {"data": 1, "seq": 2, "model": 2}, "TensorParallel", "ring"),
    ("pipe2model2", "stages", {"data": 1, "pipe": 2, "model": 2}, None, None),
    ("seq2pipe2", "stages", {"data": 1, "seq": 2, "pipe": 2}, None, None),
)
# (model, attention, mesh, builder): data 4 and the two-axis meshes the
# 2 x 2 ones extend.
THREE_BASELINES = (
    ("moe", None, {"data": 4}, "AllReduce"), ("moe", None, {"data": 2, "expert": 2}, "AllReduce"),
    ("bert", "flash", {"data": 4}, "AllReduce"),
    ("bert", "flash", {"data": 2, "model": 2}, "TensorParallel"),
    ("bert", "ulysses", {"data": 2, "seq": 2}, "AllReduce"),
    ("bert", "ring", {"data": 2, "seq": 2}, "AllReduce"),
    ("stages", None, {"data": 4}, None), ("stages", None, {"data": 2, "pipe": 2}, None),
)
# three_axis_rehearsal: the configurations of tests/test_torch_three_axis*.py
# at toy widths (THREE_TOY, fp32; the MoE with 4 experts at seq 17 and a
# routing that per-rank and global batches share), (id, model/attention,
# builder, mesh, expert names) on THREE_REHEARSAL_RANKS gloo ranks.
THREE_TOY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16)
THREE_REHEARSAL_RANKS = 8
THREE_REHEARSAL = (
    ("moe/tp/model2expert2", "moe/flash", "TensorParallel",
     {"data": 2, "model": 2, "expert": 2}, ("expert_",)),
    ("transformer/ulysses/seq2model2", "transformer/ulysses", "TensorParallel",
     {"data": 2, "seq": 2, "model": 2}, ()),
    ("transformer/ring/seq2model2", "transformer/ring", "TensorParallel",
     {"data": 2, "seq": 2, "model": 2}, ()),
    ("moe/ulysses/seq2expert2", "moe/ulysses", "AllReduce", {"data": 2, "seq": 2, "expert": 2},
     ("expert_",)),
    ("transformer/tp/pipe2model2", "transformer/flash", "TensorParallel",
     {"data": 2, "pipe": 2, "model": 2}, ()),
    ("transformer/ring/seq2pipe2", "transformer/ring", "AllReduce",
     {"data": 2, "seq": 2, "pipe": 2}, ()),
    ("pipeline/pipe2model2", "pipeline", None, {"data": 2, "pipe": 2, "model": 2}, ()),
    ("pipeline/seq2pipe2", "pipeline", None, {"data": 2, "seq": 2, "pipe": 2}, ()),
)

_T0 = time.perf_counter()
_EMIT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, the seconds since this process started
    (``t_s``) and the fields (whole lines from any thread)."""
    line = json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 1), **fields})
    with _EMIT_LOCK:
        print(line, flush=True)


class _Beside(threading.Thread):
    """Phases run one after another on a thread beside the main one, from
    construction on; :meth:`result` waits for them and raises the first
    failure."""

    def __init__(self, *phases):
        super().__init__(name="beside")
        self.phases, self.error = phases, None
        self.start()

    def run(self):
        try:
            for phase in self.phases:
                phase()
        except BaseException as e:          # raised again by result()
            self.error = e

    def result(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_core_report(ptxas: dict) -> dict:
    """Registers, spill bytes and HMMA count of each tensor-core flash kernel;
    fails on a spill or, where cuobjdump is found, on a kernel without HMMA."""
    hmma = _build.sass_counts("flash_attention", "HMMA")
    report = {}
    for kernel in FLASH_MMA_KERNELS:
        info = next((v for name, v in ptxas.items() if kernel in name), None)
        check(info is not None, f"{kernel}: not in the ptxas report")
        count = (next((n for name, n in hmma.items() if kernel in name), 0)
                 if hmma is not None else "not found (no cuobjdump)")
        check(info.get("spill_stores", 0) == 0 and info.get("spill_loads", 0) == 0,
              f"{kernel}: register spills {info}")
        check(hmma is None or count > 0, f"{kernel}: no HMMA instruction in its SASS")
        report[kernel] = {**info, "hmma": count}
    return report


def time_ms(fn, groups: int = 15, per_group: int = 20) -> float:
    """Median over ``groups`` CUDA-event timings of ``per_group`` eager
    calls: the plain versions, whose host time is small beside their work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_group)
    return statistics.median(samples)


def device_ms(fn, calls: int = 20, replays: int = 15, stream=None) -> float:
    """The card's time for one call of ``fn``, without the host's time to
    issue it: ``calls`` calls captured in one CUDA graph, the median over
    ``replays`` CUDA-event timings of a replay, divided by ``calls``. ``fn``
    is warmed up and captured on ``stream`` (a new side stream by default);
    an autograd backward must have run its forward on that stream, since
    autograd puts each backward op on its forward op's stream."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(samples)


# ------------------------------------------------------------ kernel parity
def parity_case(shape: str, page_kind: str, gen: torch.Generator, dev):
    b, n_q = {"decode": (32, 1), "prefill": (1, 16), "verify": (32, 5)}[shape]
    qdt = torch.float32 if page_kind == "float32" else torch.bfloat16
    n_pages = b * P + 1
    timeline = P * PAGE_LEN
    q4 = torch.randn((b, n_q, H, D), generator=gen, device=dev).to(qdt)
    k = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    v = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    ks = vs = None
    if page_kind == "int8":
        k, ks = pa.quantize_kv(k)
        v, vs = pa.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    # Shuffled distinct pages per row (page 0 stays scratch).
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * P] + 1)
    tables = tables.reshape(b, P).to(torch.int32).contiguous()
    if shape == "prefill":
        qpos = torch.arange(timeline - n_q, timeline, device=dev)[None]
    else:
        base = torch.randint(0, timeline, (b,), generator=gen, device=dev)
        base[0] = timeline - n_q
        qpos = torch.clamp(base[:, None] + torch.arange(n_q, device=dev)[None],
                           max=timeline - 1)
    qpos = qpos.to(torch.int32).contiguous()

    # Reference: the plain version in fp32 on the same (bf16 / int8) values.
    ref = pa.paged_attention_plain(
        q4.float(), k if ks is not None else k.float(),
        v if vs is not None else v.float(), tables, qpos, ks, vs)
    tol = TOL[qdt]
    # The main path's split count, and the others of PAGED_SPLITS: each within
    # the tolerance, timed; a repeated launch bitwise equal.
    n_split, per_split = pa.split_plan(n_q, b, H, P, PAGE_LEN, pa._sm_count(0))
    errs, same, split_ms = {}, {}, {}
    for n in sorted({n_split, *PAGED_SPLITS}):
        out = pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n)
        again = pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n)
        torch.cuda.synchronize()
        errs[n] = (out.float() - ref).abs().max().item()
        same[n] = torch.equal(out, again)
        check(torch.allclose(out.float(), ref, atol=tol, rtol=tol),
              f"kernel vs plain {shape}/{page_kind} at {n} splits: max |err| "
              f"{errs[n]} > tol {tol}")
        check(same[n], f"{shape}/{page_kind} at {n} splits: a repeated launch differs")
        split_ms[n] = device_ms(lambda: pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n))
    err = max(errs.values())
    kernel_ms = split_ms[n_split]
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q4, k, v, tables, qpos, ks, vs),
                       groups=7, per_group=5)
    # Library yardstick: SDPA over the gathered (dequantised) timeline.
    kg = pa._gather_timeline(k, ks, tables, qdt).transpose(1, 2).contiguous()
    vg = pa._gather_timeline(v, vs, tables, qdt).transpose(1, 2).contiguous()
    mask = pa.position_mask(timeline, qpos)[:, None]          # [B, 1, Q, T]
    qh = q4.transpose(1, 2).contiguous()
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qh, kg, vg,
                                                                  attn_mask=mask))
    nbytes = pa.kernel_bytes(q4, k, tables, qpos, quantized=ks is not None)
    flops = pa.kernel_flops(q4, k, tables, qpos)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[qdt]
    row = dict(shape=shape, pages=page_kind, B=b, Q=n_q, H=H, D=D,
               page_len=PAGE_LEN, P=P, n_split=n_split, pages_per_split=per_split,
               max_abs_err=err, tol=tol, repeat_bitwise=all(same.values()),
               kernel_ms=kernel_ms, kernel_ms_by_split=split_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    emit("kernel_parity", **row)
    return row


# -------------------------------------------------------------------- serve
async def _http(port: int, method: str, path: str, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload.decode()


async def _frontend_round(batcher, prompts):
    fe = await ServeFrontend(batcher, host="127.0.0.1", port=0).start()
    try:
        gens = await asyncio.gather(*(
            _http(fe.port, "POST", "/generate",
                  {"tokens": [int(t) for t in p], "max_new_tokens": 8})
            for p in prompts))
        metrics = await _http(fe.port, "GET", "/metrics")
    finally:
        await fe.close()
    return gens, metrics


def serve_run(params, kv_quant: bool, dev):
    cfg = get_model("transformer", kv_quant=kv_quant)
    engine = InferenceEngine(params, tt.decode_model(cfg), n_slots=32,
                             page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    engine.generate([1, 2, 3], 2)                        # warm-up, not counted
    torch.cuda.synchronize()
    registry = M.MetricsRegistry()
    rng = np.random.default_rng(SEED)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size)
               for i in range(N_REQUESTS)]

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    engine.decode_invocations = engine.prefill_invocations = 0
    batcher = ContinuousBatcher(engine, max_queue=256, registry=registry)
    reqs = [batcher.submit(p, MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    batcher.start()
    for r in reqs:
        r.wait(timeout=600)
    wall = time.perf_counter() - t0
    batcher.stop()
    snap = registry.snapshot()
    states = [r.state for r in reqs]
    check(all(s is RequestState.DONE for s in states),
          f"kv_quant={kv_quant}: states {[s.value for s in states]}")
    check(all(len(r.tokens) == MAX_NEW for r in reqs), "short token streams")
    check(snap["serve_requests_rejected_total"] == 0, "requests rejected")
    gens, metrics = asyncio.run(_frontend_round(
        ContinuousBatcher(engine, registry=registry), prompts[:4]))
    launches = pa.paged_attention.launches
    programs = engine.prefill_invocations + engine.decode_invocations
    torch.cuda.synchronize()

    check(all(code == 200 for code, _ in gens) and metrics[0] == 200,
          f"HTTP codes {[c for c, _ in gens]} /metrics {metrics[0]}")
    check(all(len(json.loads(body)["tokens"]) == 8 for _, body in gens),
          "HTTP streams short")
    check(engine.pool.used_pages == 0
          and engine.pool.free_pages == engine.pool.usable_pages, "page leak")
    check(launches == cfg.num_layers * programs,
          f"launches {launches} != {cfg.num_layers} x {programs} programs")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    decode_tokens = gen_tokens - len(reqs)
    row = dict(kv_quant=kv_quant, requests=len(reqs), completed=len(reqs),
               n_pages=engine.pool.n_pages, wall_s=wall,
               tokens_per_s=gen_tokens / wall,
               decode_tokens=decode_tokens,
               decode_tokens_per_s_gauge=snap["serve_decode_tokens_per_sec"],
               ttft_p50_s=snap["serve_ttft_s"]["p50"],
               ttft_p99_s=snap["serve_ttft_s"]["p99"],
               itl_p50_s=snap["serve_itl_s"]["p50"],
               latency_p50_s=snap["serve_request_latency_s"]["p50"],
               prefill_chunks=engine.prefill_invocations,
               decode_steps=engine.decode_invocations,
               kernel_launches=launches,
               http_generate=[c for c, _ in gens], http_metrics=metrics[0],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    emit("serve", **row)
    return row


# ------------------------------------------------------------- stream check
def stream_check(params, dev):
    cfg = get_model("transformer")
    paths = {"kernel": replace(cfg, paged_attention_impl="kernel"),
             "gather": replace(cfg, paged_attention_impl="gather")}
    b, plen, steps = 8, 24, 16
    n_pages = 1 + b * 4
    tables = (torch.arange(1, n_pages, device=dev).reshape(b, 4)
              .to(torch.int32).contiguous())
    rng = np.random.default_rng(SEED + 1)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(b, plen))
                               ).to(dev, torch.int32)
    caches = {m: tt.init_paged_kv_cache(c, n_pages, PAGE_LEN, device=dev)
              for m, c in paths.items()}
    first = {}
    with torch.no_grad():
        for m, c in paths.items():
            toks = []
            for row in range(b):
                for start in range(0, plen, PAGE_LEN):
                    chunk = torch.zeros((1, PAGE_LEN), dtype=torch.int32, device=dev)
                    part = prompts[row, start:start + PAGE_LEN]
                    chunk[0, :part.numel()] = part
                    t, caches[m] = tt.forward_paged_prefill_chunk(
                        params, chunk, start, plen, caches[m], tables[row], c)
                toks.append(int(t[0]))
            first[m] = toks
        tok = torch.tensor(first["kernel"], dtype=torch.int32, device=dev)
        pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
        drift, agree = 0.0, 0
        for _ in range(steps):
            out = {m: tt.forward_paged_decode_step(params, tok, pos, caches[m],
                                                   tables, c, return_logits=True)
                   for m, c in paths.items()}
            drift = max(drift, (out["kernel"][1] - out["gather"][1]).abs().max().item())
            agree += int((out["kernel"][0] == out["gather"][0]).sum())
            tok, pos = out["kernel"][0], pos + 1         # teacher-forced
    check(drift <= STREAM_LOGIT_BOUND,
          f"bf16 kernel-vs-plain logit drift {drift} > {STREAM_LOGIT_BOUND}")

    # fp32, full width, 2 layers: kernel and plain greedy streams identical.
    f32 = get_model("transformer", num_layers=2, dtype="float32")
    p32 = tt.init_params(f32, seed=SEED + 2, device=dev)
    streams = {}
    for m in ("kernel", "gather"):
        eng = InferenceEngine(p32, tt.decode_model(replace(f32, paged_attention_impl=m)),
                              n_slots=4, page_len=PAGE_LEN, n_pages=64, device=dev)
        rng = np.random.default_rng(SEED + 3)
        streams[m] = [eng.generate(mock_load_prompt(rng, i, vocab=f32.vocab_size), 24)
                      for i in range(8)]
    same = streams["kernel"] == streams["gather"]
    check(same, "fp32 kernel and plain greedy streams differ")
    emit("stream_check", bf16_max_abs_logit_diff=drift, bound=STREAM_LOGIT_BOUND,
         bf16_token_agreement=agree / (b * steps), fp32_streams_identical=same,
         fp32_streams=len(streams["kernel"]))


# ---------------------------------------------------------- serve features
def _served(engine, prompts, label, layers, draft_layers=0, sampling=None, rids=None,
            max_new=MAX_NEW):
    """The prompts through a ContinuousBatcher on ``engine``, the paged
    kernel's count set to 0 just before and held just after to ``layers``
    times the target's programs run plus ``draft_layers`` times the draft's;
    returns (streams, metrics snapshot, wall s, launches, program counts)."""
    registry = M.MetricsRegistry()
    counts = dict(prefill=engine.prefill_invocations, decode=engine.decode_invocations,
                  verify=getattr(engine, "verify_invocations", 0),
                  draft=getattr(engine, "draft_invocations", 0))
    reset_launches()
    batcher = ContinuousBatcher(engine, max_queue=256, registry=registry)
    reqs = [batcher.submit(p, max_new, request_id=rids[i] if rids else None,
                           sampling=sampling[i] if sampling else None)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    batcher.start()
    for r in reqs:
        r.wait(timeout=600)
    wall = time.perf_counter() - t0
    batcher.stop()
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    ran = dict(prefill=engine.prefill_invocations - counts["prefill"],
               decode=engine.decode_invocations - counts["decode"],
               verify=getattr(engine, "verify_invocations", 0) - counts["verify"],
               draft=getattr(engine, "draft_invocations", 0) - counts["draft"])
    check(all(r.state is RequestState.DONE and len(r.tokens) == max_new for r in reqs),
          f"{label}: states {[r.state.value for r in reqs]}")
    want = (layers * (ran["prefill"] + ran["decode"] + ran["verify"])
            + draft_layers * ran["draft"])
    check(launches == want, f"{label}: paged kernel launches {launches} != {want} "
          f"({layers} + {draft_layers} draft layers x {ran})")
    if engine.prefix_cache is None:
        check(pools_balanced(engine), f"{label}: page leak")
    return [r.tokens for r in reqs], registry.snapshot(), wall, launches, ran


def _parting(params, cfg, prompt, got, want):
    """Where two bf16 greedy streams part: the index and the |Δlogit| of
    the two tokens there under the uncached forward of the common prefix
    (0 when equal)."""
    t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if t is None:
        return None, 0.0
    tokens = torch.tensor([list(prompt) + list(want[:t])], dtype=torch.int32,
                          device=params["embed"]["embedding"].device)
    with torch.no_grad():
        logits = tt.forward(params, tokens, cfg)[0, -1]
    return t, abs(float(logits[got[t]] - logits[want[t]]))


def _streams_agree(params, cfg, prompts, got, want, label, bitwise: bool) -> dict:
    """Equal streams, or (bf16) streams parting only at near-ties: the two
    tokens within STREAM_LOGIT_BOUND of each other where they part."""
    margins = [_parting(params, cfg, p, g, w)[1] for p, g, w in zip(prompts, got, want)
               if g != w]
    if bitwise:
        check(not margins, f"{label}: {len(margins)} streams differ")
    check(all(m <= STREAM_LOGIT_BOUND for m in margins),
          f"{label}: streams part at a margin of {max(margins, default=0)} > "
          f"{STREAM_LOGIT_BOUND}")
    return dict(streams_equal=len(got) - len(margins), streams_parted=len(margins),
                max_parting_margin=max(margins, default=0.0))


def _sampling_card_vs_cpu(params, cfg, dev) -> dict:
    """sample_tokens on the card against the CPU on the same logits (the
    last position of 32 prompts, each under 32 counters): equal but at
    near-ties; and its card time at a decode step's shape (32 rows)."""
    rng = np.random.default_rng(SEED + 7)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(32, 16))).to(dev)
    with torch.no_grad():
        logits = tt.forward(params, tokens, cfg)[:, -1].float()
    logits = logits.repeat_interleave(SAMPLE_ROWS // 32, dim=0).contiguous()
    counters = torch.arange(SAMPLE_ROWS, device=dev) + 100
    keys = np.array([samp_ops.request_key(f"cmp-{i}", 3) for i in range(SAMPLE_ROWS)],
                    np.uint32)
    samp = (np.full(SAMPLE_ROWS, FEATURE_SAMPLING["temperature"], np.float32),
            np.full(SAMPLE_ROWS, FEATURE_SAMPLING["top_k"], np.int32),
            np.full(SAMPLE_ROWS, FEATURE_SAMPLING["top_p"], np.float32),
            keys[:, 0], keys[:, 1])
    card = samp_ops.sample_tokens(logits, counters, samp).cpu().numpy()
    host = samp_ops.sample_tokens(logits.cpu(), counters.cpu(), samp).numpy()
    differ = np.flatnonzero(card != host)
    if len(differ):
        hi, lo = samp_ops.fold_in(torch.from_numpy(keys[differ, 0].astype(np.int64)),
                                  torch.from_numpy(keys[differ, 1].astype(np.int64)),
                                  counters.cpu()[differ])
        noise = samp_ops.gumbel(hi, lo, cfg.vocab_size).numpy().astype(np.float64)
        scaled = logits.cpu().numpy()[differ].astype(np.float64) / samp[0][0]
        rows = np.arange(len(differ))
        a, b = card[differ], host[differ]
        margin = np.abs(scaled[rows, a] + noise[rows, a] - scaled[rows, b] - noise[rows, b])
        bound = 2 * GUMBEL_ULPS * np.spacing(np.maximum(np.maximum(
            np.abs(noise[rows, a]), np.abs(noise[rows, b])), 1.0).astype(np.float32))
        check((margin <= bound).all(), f"sample_tokens card vs CPU: rows {differ} "
              f"part at margins {margin} over {bound}")
    check(len(differ) <= NEAR_TIE_SHARE * SAMPLE_ROWS,
          f"sample_tokens card vs CPU: {len(differ)} of {SAMPLE_ROWS} rows differ")
    step = (logits[:32].contiguous(), counters[:32].contiguous(),
            tuple(torch.as_tensor(a[:32].astype(np.int64) if a.dtype == np.uint32
                                  else a[:32], device=dev) for a in samp))
    return dict(rows=SAMPLE_ROWS, rows_differ=len(differ),
                decode_shape_ms=time_ms(lambda: samp_ops.sample_tokens(*step),
                                        groups=7, per_group=5))


def serve_features(params, card: str, dev) -> list:
    """Stochastic sampling, speculative decode and prefix sharing of the
    full-width transformer, 64 requests, max_new 32, bf16 and int8 pages;
    then the fp32 2-layer full-width model's bitwise spec streams."""
    rows = []
    sample_check = _sampling_card_vs_cpu(params, get_model("transformer"), dev)
    for kv_quant in (False, True):
        cfg = get_model("transformer", kv_quant=kv_quant)
        dm = tt.decode_model(cfg)
        kw = dict(n_slots=32, page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
        rng = np.random.default_rng(SEED)
        prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size) for i in range(N_REQUESTS)]
        rids = [f"feature-{i}" for i in range(N_REQUESTS)]
        hot = [samp_ops.SamplingParams(**FEATURE_SAMPLING, seed=i) for i in range(N_REQUESTS)]
        tag = "int8" if kv_quant else "bf16"

        plain = InferenceEngine(params, dm, **kw)
        plain.generate([1, 2, 3], 2)                       # warm-up, not counted
        L = cfg.num_layers
        greedy, g_snap, g_wall, g_launch, g_ran = _served(plain, prompts, f"plain {tag}", L)
        first, s_snap, s_wall, s_launch, s_ran = _served(plain, prompts, f"sampled {tag}",
                                                         L, sampling=hot, rids=rids)
        again = _served(plain, prompts, f"sampled again {tag}", L, sampling=hot,
                        rids=rids)[0]
        check(first == again, f"sampled {tag}: a (request_id, seed) replays another stream")
        check(first != greedy, f"sampled {tag}: streams equal the greedy ones")
        rows.append(dict(path="sampling", pages=tag, **FEATURE_SAMPLING,
                         requests=len(prompts), replay_bitwise=True,
                         streams_equal_greedy=sum(a == b for a, b in zip(first, greedy)),
                         ttft_p50_s=s_snap["serve_ttft_s"]["p50"],
                         itl_p50_s=s_snap["serve_itl_s"]["p50"],
                         decode_tokens_per_s=(len(prompts) * (MAX_NEW - 1)) / s_wall,
                         greedy_itl_p50_s=g_snap["serve_itl_s"]["p50"],
                         greedy_decode_tokens_per_s=(len(prompts) * (MAX_NEW - 1)) / g_wall,
                         kernel_launches=s_launch, programs=s_ran,
                         card_vs_cpu=sample_check if not kv_quant else None, card=card))
        emit("serve_features", **rows[-1])
        rows[-1]["kernel_launches"] += g_launch
        del plain
        torch.cuda.empty_cache()

        for draft in ("same", f"{DRAFT_LAYERS}-layer"):
            if draft == "same":
                dcfg, dparams = cfg, params
            else:
                dcfg = get_model("transformer", kv_quant=kv_quant, num_layers=DRAFT_LAYERS)
                dparams = tt.init_params(dcfg, seed=SEED + 5, device=dev)
            spec = SpecDecodeEngine(params, dm, dparams, tt.decode_model(dcfg),
                                    spec_k=SPEC_K, **kw)
            spec.generate([1, 2, 3], 2)                    # warm-up, not counted
            streams, snap, wall, launches, ran = _served(
                spec, prompts, f"spec {draft} {tag}", L, dcfg.num_layers)
            agree = _streams_agree(params, cfg, prompts, streams, greedy,
                                   f"spec {draft} {tag}", bitwise=False)
            stats = spec.spec_stats()
            rows.append(dict(path="spec", pages=tag, draft=draft, k=SPEC_K, **agree,
                             acceptance_rate=stats["acceptance_rate"],
                             tokens_per_round=stats["tokens_per_round"],
                             tokens_per_slot_round=stats["emitted"] * SPEC_K
                             / max(stats["proposed"], 1),
                             decode_tokens_per_target_invocation=(
                                 len(prompts) * (MAX_NEW - 1)) / (ran["decode"] + ran["verify"]),
                             itl_p50_s=snap["serve_itl_s"]["p50"],
                             decode_tokens_per_s=(len(prompts) * (MAX_NEW - 1)) / wall,
                             plain_itl_p50_s=g_snap["serve_itl_s"]["p50"],
                             plain_decode_tokens_per_s=(len(prompts) * (MAX_NEW - 1)) / g_wall,
                             draft_starved=stats["draft_starved"], pools_balanced=True,
                             kernel_launches=launches, programs=ran, card=card))
            emit("serve_features", **rows[-1])
            del spec, dparams
            torch.cuda.empty_cache()

        rows.append(_prefix_run(kv_quant, tag, card, dev))
    rows.append(_spec_fp32(card, dev))
    return rows


def _prefix_run(kv_quant: bool, tag: str, card: str, dev) -> dict:
    """PREFIX_REQUESTS requests sharing a SYSTEM_LEN-token system prompt,
    cached against cold; the prefix tree warmed by one request first."""
    cfg = get_model("transformer", kv_quant=kv_quant, max_seq_len=PREFIX_MAX_SEQ)
    params = tt.init_params(cfg, seed=SEED + 6, device=dev)
    kw = dict(n_slots=32, page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    rng = np.random.default_rng(SEED + 8)
    system = rng.integers(1, cfg.vocab_size, size=SYSTEM_LEN)
    warm = np.concatenate([system, rng.integers(1, cfg.vocab_size, size=SUFFIX_LENS[0])])
    prompts = []
    for i in range(PREFIX_REQUESTS):
        suffix = rng.integers(1, cfg.vocab_size, size=int(rng.integers(*SUFFIX_LENS)))
        if i % COW_EVERY == 1:                 # diverges mid-page from the warm-up's
            suffix[:COW_SHARED] = warm[SYSTEM_LEN:SYSTEM_LEN + COW_SHARED]
            suffix[COW_SHARED] = (warm[SYSTEM_LEN + COW_SHARED] % (cfg.vocab_size - 2)) + 1
        prompts.append(np.concatenate([system, suffix]))
    cold = InferenceEngine(params, tt.decode_model(cfg), **kw)
    cold.generate(warm, 2)                                 # warm-up, not counted
    want, c_snap, c_wall, c_launch, c_ran = _served(cold, prompts, f"prefix cold {tag}",
                                                    cfg.num_layers)
    del cold
    torch.cuda.empty_cache()
    engine = InferenceEngine(params, tt.decode_model(cfg), prefix_cache=True, **kw)
    engine.generate(warm, 2)                               # fills the tree, not counted
    cache = engine.prefix_cache
    before = dict(cache.stats())
    got, snap, wall, launches, ran = _served(engine, prompts, f"prefix cached {tag}",
                                             cfg.num_layers)
    agree = _streams_agree(params, cfg, prompts, got, want, f"prefix {tag}",
                           bitwise=False)
    stats = cache.stats()
    check(stats["cow_copies"] > before["cow_copies"], f"prefix {tag}: no copy-on-write")
    check(cache.live_refcount == 0, f"prefix {tag}: refcounts {cache.live_refcount}")
    shared_pages = stats["cached_pages"]
    cache.purge()
    check(pools_balanced(engine), f"prefix {tag}: pages leaked after purge")
    row = dict(path="prefix", pages=tag, system_len=SYSTEM_LEN, requests=len(prompts),
               **agree, hit_rate=(stats["hits"] - before["hits"])
               / max(stats["lookups"] - before["lookups"], 1),
               cow_copies=stats["cow_copies"] - before["cow_copies"],
               cached_pages=shared_pages, prefill_chunks_cold=c_ran["prefill"],
               prefill_chunks_cached=ran["prefill"],
               prefill_chunks_saved=c_ran["prefill"] - ran["prefill"],
               ttft_p50_s_cold=c_snap["serve_ttft_s"]["p50"],
               ttft_p50_s_cached=snap["serve_ttft_cached_s"]["p50"],
               cached_requests=snap["serve_ttft_cached_s"]["count"],
               wall_s_cold=c_wall, wall_s_cached=wall, leaked_pages=0,
               kernel_launches=launches, programs=ran, card=card)
    emit("serve_features", **row)
    row["kernel_launches"] += c_launch
    del engine, params
    torch.cuda.empty_cache()
    return row


def _spec_fp32(card: str, dev) -> dict:
    """The 2-layer full-width model in fp32: spec streams (the same-weights
    and a 2-layer draft of its own weights, greedy and sampled) bitwise
    equal to plain decode's."""
    cfg = get_model("transformer", num_layers=2, dtype="float32")
    params = tt.init_params(cfg, seed=SEED + 2, device=dev)
    dparams = tt.init_params(cfg, seed=SEED + 9, device=dev)
    kw = dict(n_slots=16, page_len=PAGE_LEN, device=dev)
    rng = np.random.default_rng(SEED + 3)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size) for i in range(16)]
    rids = [f"fp32-{i}" for i in range(16)]
    hot = [samp_ops.SamplingParams(**FEATURE_SAMPLING, seed=i) for i in range(16)]
    plain = InferenceEngine(params, tt.decode_model(cfg), **kw)
    L = cfg.num_layers
    want = _served(plain, prompts, "fp32 plain", L)[0]
    want_hot = _served(plain, prompts, "fp32 plain sampled", L, sampling=hot, rids=rids)[0]
    row = dict(path="spec_fp32", layers=2, requests=len(prompts), card=card,
               kernel_launches=0)
    for draft, dp in (("same", params), ("2-layer", dparams)):
        spec = SpecDecodeEngine(params, tt.decode_model(cfg), dp, tt.decode_model(cfg),
                                spec_k=SPEC_K, **kw)
        got, _, _, launches, _ = _served(spec, prompts, f"fp32 spec {draft}", L, L)
        got_hot, _, _, launches_hot, _ = _served(spec, prompts, f"fp32 spec {draft} sampled",
                                                 L, L, sampling=hot, rids=rids)
        check(got == want, f"fp32 spec {draft}: greedy streams differ from plain decode")
        check(got_hot == want_hot, f"fp32 spec {draft}: sampled streams differ")
        row[f"{draft}_acceptance_rate"] = spec.acceptance_rate
        row["kernel_launches"] += launches + launches_hot
    row["streams_bitwise"] = True
    emit("serve_features", **row)
    return row


# ------------------------------------------------------------- flash parity
def flash_bounds(q, k, v, g, lse, delta, causal: bool, plain: dict) -> dict:
    """Per-element bounds on |kernel - plain| for the bf16 kernels' O, dK, dV
    and dQ: one bf16 step of the larger value (each side rounds its fp32 result
    once) plus the arithmetic that differs, in magnitudes of the same
    products (P the softmax from the plain lse):
    - scores, sums of D products in other orders, and exp: each P off by
      ``ds = 3 D E scale (|q| |k|^T) + 4 E`` of itself (both sides);
    - O: p rounded to bf16 against the running max in the kernel and the row
      max in the plain version, 2^-8 each: ``((2^-7 + 3 S E) P + P ds) |V|``,
      plus ``(P ds)`` summed over keys times |O| for the normalisation;
    - dV: P split into hi + lo (2^-16): ``((2^-16 + 3 S E) P + P ds)^T |dO|``;
    - dK: dS = P (dP - delta) split likewise, P's error times |dP - delta|,
      dP's own sums of D products:
      ``w = (2^-16 + 3 S E + ds) |dS| + 3 D E P (|dO| |V|^T)``, then
      ``w^T |q scale|``;
    - dQ: the same dS error summed over keys instead: ``w |K scale|``."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    e = FLASH_E
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    ds = (3 * d * e * scale) * torch.einsum("bqhd,bkhd->bhqk", q32.abs(), k32.abs()) + 4 * e
    p = torch.exp(fa._scores(q32 * scale, k32, causal) - lse[..., None])
    pds = p * ds
    del ds
    o_mag = (torch.einsum("bhqk,bkhd->bqhd", (FLASH_BF16_STEP + 3 * s * e) * p + pds,
                          v32.abs())
             + pds.sum(-1).permute(0, 2, 1)[..., None] * plain["o"].float().abs())
    dv_mag = torch.einsum("bhqk,bqhd->bkhd", (FLASH_SPLIT + 3 * s * e) * p + pds, g32.abs())
    dsd = (torch.einsum("bqhd,bkhd->bhqk", g32, v32) - delta[..., None]).abs()
    w = (FLASH_SPLIT + 3 * s * e) * p * dsd + pds * dsd
    del dsd, pds
    w += (3 * d * e) * p * torch.einsum("bqhd,bkhd->bhqk", g32.abs(), v32.abs())
    dk_mag = torch.einsum("bhqk,bqhd->bkhd", w, (q32 * scale).abs())
    dq_mag = torch.einsum("bhqk,bkhd->bqhd", w, (k32 * scale).abs())
    return {"o": o_mag, "dk": dk_mag, "dv": dv_mag, "dq": dq_mag}


def flash_grad_rel_l2(seq: int) -> float:
    """The relative L2 limit of the bf16 dK, dV and dQ at sequence ``seq``."""
    return FLASH_GRAD_REL_L2 * max(1.0, (seq / 512) ** 0.5)


def flash_case(seq: int, causal: bool, dtype, gen: torch.Generator, dev,
               batch: int = FLASH_B, heads: int = FLASH_H):
    """The three flash kernels against their plain versions at one shape."""
    shape = (batch, seq, heads, FLASH_D)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (want_out.float() * g.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_dkdv(q, k, v, g, want_lse, delta, causal)
    dq = fa.flash_dq(q, k, v, g, want_lse, delta, causal)
    torch.cuda.synchronize()
    pk, pv = fa.flash_dkdv_plain(q, k, v, g, want_lse, delta, causal)
    pq = fa.flash_dq_plain(q, k, v, g, want_lse, delta, causal)
    bf16 = dtype == torch.bfloat16
    tol = FLASH_TOL if bf16 else FLASH_F32_TOL
    case = (f"flash B={batch} S={seq} H={heads} causal={causal} "
            f"{str(dtype).replace('torch.', '')}")
    errs, rel_l2 = {}, {}
    for name, got, want, t in (("o", out, want_out, tol), ("lse", lse, want_lse, min(tol, LSE_TOL)),
                               ("dk", dk, pk, tol), ("dv", dv, pv, tol),
                               ("dq", dq, pq, tol)):
        diff = got.float() - want.float()
        errs[name] = diff.abs().max().item()
        rel_l2[name] = (diff.norm() / want.float().norm()).item()
        check(torch.allclose(got.float(), want.float(), atol=t, rtol=t),
              f"{case}: {name} max |err| {errs[name]} > tol {t}")
    # err/bound of the worst element, 1 = at the bound (bf16: tensor cores).
    over, rel_limit = {}, flash_grad_rel_l2(seq)
    if bf16:
        bounds = flash_bounds(q, k, v, g, want_lse, delta, causal, {"o": want_out})
        for name, got, want in (("o", out, want_out), ("dk", dk, pk), ("dv", dv, pv),
                                ("dq", dq, pq)):
            bound = (FLASH_BF16_STEP * torch.maximum(got.float().abs(), want.float().abs())
                     + bounds[name])
            over[name] = ((got.float() - want.float()).abs() / bound.clamp_min(1e-30)
                          ).max().item()
        del bounds, bound
        for name, ratio in over.items():
            check(ratio <= 1.0, f"{case}: {name} beyond its bound (worst err/bound {ratio})")
        for name in ("dk", "dv", "dq"):
            check(rel_l2[name] <= rel_limit,
                  f"{case}: {name} rel L2 {rel_l2[name]} > {rel_limit}")

    # SDPA pinned to one backend, so that its times do not move between runs:
    # flash attention for bf16, memory-efficient for fp32 (flash takes none).
    # Kernels and SDPA are timed as CUDA graphs (device_ms): card time only.
    backend = SDPBackend.FLASH_ATTENTION if bf16 else SDPBackend.EFFICIENT_ATTENTION
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(backend):
        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                    is_causal=causal))
        # SDPA's backward computes dQ, dK and dV in one call: both backward
        # kernels stand beside it. Its forward runs on the capture stream.
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            leaves = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            gh = g.transpose(1, 2)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, leaves, gh,
                                                         retain_graph=True),
                             stream=stream)
        del sdpa_out, leaves
    times = {
        "fwd": (device_ms(lambda: fa.flash_fwd(q, k, v, causal)),
                time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal), groups=5,
                        per_group=3), sdpa_fwd),
        "dkdv": (device_ms(lambda: fa.flash_dkdv(q, k, v, g, want_lse, delta, causal)),
                 time_ms(lambda: fa.flash_dkdv_plain(q, k, v, g, want_lse, delta,
                                                     causal), groups=5, per_group=3),
                 sdpa_bwd),
        "dq": (device_ms(lambda: fa.flash_dq(q, k, v, g, want_lse, delta, causal)),
               time_ms(lambda: fa.flash_dq_plain(q, k, v, g, want_lse, delta, causal),
                       groups=5, per_group=3), sdpa_bwd),
    }
    outputs = {"fwd": ("o", "lse"), "dkdv": ("dk", "dv"), "dq": ("dq",)}
    rows = []
    for kind, (kernel_ms, plain_ms, library_ms) in times.items():
        nbytes = fa.kernel_bytes(q, kind)
        flops = fa.kernel_flops(q, kind, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_OPS_PER_S[dtype]
        names = outputs[kind]
        row = dict(kernel=kind, B=batch, S=seq, H=heads, D=FLASH_D,
                   causal=causal, dtype=str(dtype).replace("torch.", ""),
                   design="tensor cores" if bf16 else "fp32 FMA",
                   max_abs_err=max(errs[n] for n in names), tol=tol,
                   err_over_bound={n: over[n] for n in names if n in over} or None,
                   rel_l2={n: rel_l2[n] for n in names}, rel_l2_limit=rel_limit,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library=f"sdpa {'forward' if kind == 'fwd' else 'backward'} "
                           f"({backend.name})",
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        emit("flash_parity", **row)
        rows.append(row)
    return rows


# ------------------------------------------------------- conv stats parity
def _matmul_moments(x, w):
    """The library rendering: ``torch.matmul``, then two fp32 column sums."""
    y = x @ w
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def conv_stats_case(m: int, k: int, n: int, dtype, gen: torch.Generator, dev,
                    launches: int = 0, model: str = "resnet50"):
    """The fused conv-stats kernel against its plain version at one shape:
    post-ReLU activations (``|N(0, 1)|``, what the models' 1x1 convs read)
    and He-scaled weights. ``launches``: the shape's launches in a forward
    of ``model``, carried into the row."""
    chain = fcs.chain_length(m, n, dtype)
    x = torch.randn((m, k), generator=gen, device=dev).abs_().to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) * (2.0 / k) ** 0.5).to(dtype)
    y, s1, s2 = fcs.fused_matmul_stats(x, w)
    again = fcs.fused_matmul_stats(x, w)
    torch.cuda.synchronize()
    repeat_bitwise = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    del again
    py, p1, p2 = fcs.fused_matmul_stats_plain(x, w)
    y_err = (y.float() - py.float()).abs()
    y_bound = (CONV_Y_STEP[dtype] * torch.maximum(y.float().abs(), py.float().abs())
               + 2 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs()))
    y_ok = bool((y_err <= y_bound).all())
    y_ratio = (y_err / y_bound.clamp_min(1e-30)).max().item()
    max_abs_err = y_err.max().item()
    del y_err, y_bound, py
    y32_abs_sum = (x.float() @ w.float()).abs_().sum(0)
    s1_rel = ((s1 - p1).abs() / y32_abs_sum).max().item()
    s2_rel = ((s2 - p2).abs() / p2).max().item()
    del y32_abs_sum

    kernel_ms = device_ms(lambda: fcs.fused_matmul_stats(x, w))
    plain_ms = time_ms(lambda: fcs.fused_matmul_stats_plain(x, w), groups=7, per_group=5)
    library_ms = device_ms(lambda: _matmul_moments(x, w))
    matmul_ms = device_ms(lambda: x @ w)
    nbytes, flops = fcs.kernel_bytes(x, w), fcs.kernel_flops(x, w)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    row = dict(model=model, M=m, K=k, N=n, dtype=str(dtype).replace("torch.", ""),
               launches_per_forward=launches, max_abs_err=max_abs_err,
               y_err_over_bound=y_ratio, s1_rel=s1_rel, s2_rel=s2_rel,
               stat_tol=CONV_STAT_TOL, chain_length=chain, repeat_bitwise=repeat_bitwise,
               tiles_per_block=fcs.tiles_per_block(m, n, dtype),
               groups=fcs.groups(m, n, dtype), kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, matmul_ms=matmul_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    if dtype == torch.bfloat16:
        row["plan"] = fcs.smem_plan(k, n)
    emit("conv_stats_parity", **row)
    shape = f"conv stats {m}x{k}x{n} {row['dtype']}"
    check(chain * 2.0 ** -24 <= CONV_STAT_TOL,
          f"{shape}: addition chain {chain} too long for {CONV_STAT_TOL}")
    check(y_ok, f"{shape}: y beyond its bound (worst err/bound {y_ratio})")
    check(s1_rel <= CONV_STAT_TOL and s2_rel <= CONV_STAT_TOL,
          f"{shape}: sums rel {s1_rel}, {s2_rel} > {CONV_STAT_TOL}")
    check(repeat_bitwise, f"{shape}: a repeated launch differs")
    return row


def conv_forward_totals(rows) -> dict:
    """Σ launches x ms over the bf16 rows of one model: a forward's fused
    conv-stats work, beside its bound and the library calls."""
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    total = {key: sum(r["launches_per_forward"] * r[key] for r in bf16)
             for key in ("kernel_ms", "bound_ms", "matmul_ms", "library_ms")}
    return dict(launches=sum(r["launches_per_forward"] for r in bf16), **total)


def conv_tensor_core_report(ptxas: dict, extra_kn=()) -> dict:
    """Registers, spill bytes and HGMMA count of each instance of the bf16
    conv-stats kernel; fails on a spill or, where cuobjdump is found, on an
    instance without HGMMA. Also holds the wrapper's shared-memory plan
    (fcs.smem_plan) to the library's own at every CONV_SHAPES shape and at
    each ``(K, N)`` of ``extra_kn``."""
    hgmma = _build.sass_counts("fused_conv_stats", "HGMMA")
    report = {}
    for name, info in ptxas.items():
        if "conv_stats_wgmma_kernel" not in name:
            continue
        count = (next((c for sass_name, c in hgmma.items() if sass_name == name), 0)
                 if hgmma is not None else "not found (no cuobjdump)")
        check(info.get("spill_stores", 0) == 0 and info.get("spill_loads", 0) == 0,
              f"{name}: register spills {info}")
        check(hgmma is None or count > 0, f"{name}: no HGMMA instruction in its SASS")
        report[name] = {**info, "hgmma": count}
    check(len(report) == 6, f"conv stats: {len(report)} wgmma kernel instances, not 6")
    for k, n in sorted({(k, n) for (_, k, n), _ in CONV_SHAPES} | set(extra_kn)):
        check(fcs.built_plan(k, n) == fcs.smem_plan(k, n),
              f"conv stats plan at K={k} N={n}: {fcs.built_plan(k, n)} in the library, "
              f"{fcs.smem_plan(k, n)} in the wrapper")
    return report


# -------------------------------------------------------------------- train
def _launch_counts():
    return {"fwd": fa.flash_fwd.launches, "dkdv": fa.flash_dkdv.launches,
            "dq": fa.flash_dq.launches}


def reset_launches() -> None:
    """Every kernel's launch count to 0: just before each main-path window."""
    pa.paged_attention.launches = 0
    fa.reset_launches()
    fcs.fused_matmul_stats.launches = 0


def train_run(model: str, batch_size: int, steps: int, card: str, dev):
    """Build through AutoDist (AllReduce, default SGD), one warm-up step,
    then the counted ``step.run`` window."""
    spec = get_model_spec(model, max_seq_len=TRAIN_SEQ, attention_impl="flash")
    cfg = spec.config
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
    t0 = time.perf_counter()
    step = autodist.build(spec.loss_fn, params, batch)
    build_s = time.perf_counter() - t0
    state = step.init(params)
    state, _ = step.run(state, batch, 1)                # warm-up, not counted
    torch.cuda.synchronize()

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, metrics = step.run(state, batch, steps)
    losses = metrics["loss"].tolist()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    check(all(np.isfinite(losses)), f"{model}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{model}: loss did not fall {losses}")
    for kind, n in launches.items():
        check(n == cfg.num_layers * steps,
              f"{model}: flash {kind} launches {n} != {cfg.num_layers} x {steps}")
    check(fcs.fused_matmul_stats.launches == 0, f"{model}: fused conv kernel launched")
    tokens = batch_size * TRAIN_SEQ * steps
    row = dict(model=model, seq=TRAIN_SEQ, batch=batch_size, steps=steps,
               attention_impl="flash", strategy="AllReduce", optimizer="sgd 0.01",
               build_s=build_s, losses=losses, wall_s=wall,
               ms_per_step=wall / steps * 1e3, tokens_per_s=tokens / wall,
               mfu=spec.flops_per_example * batch_size * steps / wall
               / PEAK_OPS_PER_S[torch.bfloat16],
               kernel_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               card=card)
    emit("train", **row)
    return row


def _loss_and_grads(loss_fn, params, batch):
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in flatten_params(params).items()}
    loss = loss_fn(unflatten_params(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def _rel(a: dict, b: dict) -> float:
    """Relative L2 distance of two gradient dicts, as one vector each."""
    num = sum(((a[n].float() - g.float()) ** 2).sum() for n, g in b.items())
    den = sum((g.float() ** 2).sum() for g in b.values())
    return torch.sqrt(num / den).item()


def train_check(dev):
    """Kernel path vs plain path (and both vs fp32), one step at full width;
    PSLoadBalancing's first-step loss vs AllReduce's."""
    specs = {name: get_model_spec("bert_base", max_seq_len=TRAIN_SEQ,
                                  attention_impl=impl, **extra)
             for name, impl, extra in (("flash", "flash", {}), ("dot", "dot", {}),
                                       ("fp32", "dot", {"dtype": "float32"}))}
    flash = specs["flash"]
    params = flash.init(SEED + 4, device=dev)
    batch = flash.example_batch(CHECK_BATCH, device=dev)
    runs = {name: _loss_and_grads(spec.loss_fn, params, batch)
            for name, spec in specs.items()}
    (loss_f, grads_f), (loss_d, grads_d), (loss_32, grads_32) = (
        runs["flash"], runs["dot"], runs["fp32"])
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    check(loss_rel <= CHECK_LOSS_RTOL,
          f"flash vs dot loss {loss_f} vs {loss_d}: rel {loss_rel} > {CHECK_LOSS_RTOL}")
    whole = {"flash_vs_fp32": _rel(grads_f, grads_32), "dot_vs_fp32": _rel(grads_d, grads_32),
             "flash_vs_dot": _rel(grads_f, grads_d)}
    for name, rel in whole.items():
        check(rel <= CHECK_GLOBAL_RTOL, f"whole gradient {name} rel {rel} > "
              f"{CHECK_GLOBAL_RTOL}")
    global_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads_d.values()))
    worst, worst_name, compared = 0.0, "", 0
    for name, gd in grads_d.items():
        norm = gd.float().norm()
        if norm < CHECK_NORM_FLOOR * global_norm:
            continue
        rel = ((grads_f[name].float() - gd.float()).norm() / norm).item()
        check(rel <= CHECK_GRAD_RTOL, f"grad {name}: flash vs dot rel {rel} > "
              f"{CHECK_GRAD_RTOL}")
        compared += 1
        if rel > worst:
            worst, worst_name = rel, name

    first = {}
    for name, builder in (("AllReduce", AllReduce()), ("PSLoadBalancing", PSLoadBalancing())):
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=builder, device=dev)
        step = autodist.build(flash.loss_fn, params, batch)
        _, m = step.run(step.init(params), batch, 1)
        first[name] = m["loss"][0].item()
    ps_rel = abs(first["PSLoadBalancing"] - first["AllReduce"]) / abs(first["AllReduce"])
    check(ps_rel <= 1e-5, f"PSLoadBalancing first loss {first} differ")
    emit("train_check", model="bert_base", seq=TRAIN_SEQ, batch=CHECK_BATCH,
         loss_flash=loss_f, loss_dot=loss_d, loss_fp32=loss_32, loss_rel=loss_rel,
         loss_rtol=CHECK_LOSS_RTOL, whole_gradient_rel=whole,
         whole_rtol=CHECK_GLOBAL_RTOL, worst_tensor_rel=worst,
         worst_tensor=worst_name, tensor_rtol=CHECK_GRAD_RTOL, tensors_compared=compared,
         tensors_total=len(grads_d), first_step_loss=first, ps_vs_allreduce_rel=ps_rel)

def train_resnet(card: str, dev):
    """ResNet-50 at its defaults (224 px, 1000 classes, bf16) through
    AutoDist (AllReduce, default SGD): one warm-up step, then the counted
    ``step.run`` window."""
    spec = get_model_spec("resnet")
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(RESNET_BATCH, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
    t0 = time.perf_counter()
    step = autodist.build(spec.loss_fn, params, batch)
    build_s = time.perf_counter() - t0
    state = step.init(params)
    state, _ = step.run(state, batch, 1)                # warm-up, not counted
    torch.cuda.synchronize()

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, metrics = step.run(state, batch, RESNET_STEPS)
    losses = metrics["loss"].tolist()
    wall = time.perf_counter() - t0
    launches = fcs.fused_matmul_stats.launches
    flash = _launch_counts()
    per_step = rn.fused_launches_per_forward(50)
    row = dict(model=spec.name, image_size=224, batch=RESNET_BATCH, steps=RESNET_STEPS,
               strategy="AllReduce", optimizer="sgd 0.01", build_s=build_s,
               losses=losses, wall_s=wall, ms_per_step=wall / RESNET_STEPS * 1e3,
               images_per_s=RESNET_BATCH * RESNET_STEPS / wall,
               mfu=spec.flops_per_example * RESNET_BATCH * RESNET_STEPS / wall
               / PEAK_OPS_PER_S[torch.bfloat16],
               kernel_launches={"fused_conv_stats": launches, **flash},
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card)
    emit("train", **row)
    check(all(np.isfinite(losses)), f"resnet50: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"resnet50: loss did not fall {losses}")
    check(launches == per_step * RESNET_STEPS,
          f"resnet50: fused conv launches {launches} != {per_step} x {RESNET_STEPS}")
    check(not any(flash.values()), f"resnet50: flash kernels launched {flash}")
    return row


def _bottleneck_grads(p, x, gy, stride, dtype):
    """One bottleneck block's output and the gradients of ``sum(y * gy)``
    with respect to its input and params."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in flatten_params(p).items()}
    xin = x.to(dtype).requires_grad_(True)
    y = rn._bottleneck(unflatten_params(leaves), xin, stride, dtype)
    grads = torch.autograd.grad((y.float() * gy).sum(), [xin, *leaves.values()])
    return y.float(), dict(zip(["input", *leaves], grads))


def resnet_check(dev):
    """ResNet-50 at full width, batch 8: the fp32 kernel path on the card
    against the fp32 plain path on the CPU; the bf16 kernel path against
    fp32 on the card, whole model and block by block; the kernel's launches
    in one forward of every depth at 224 px; PSLoadBalancing's first-step
    loss vs AllReduce's."""
    spec = get_model_spec("resnet")
    params = spec.init(SEED + 5, device=dev)
    batch = spec.example_batch(CHECK_BATCH, device=dev)

    def loss32(p, b):
        return L.softmax_xent(rn.forward(p, b["images"], 50, dtype=torch.float32),
                              b["labels"])

    loss_16, grads_16 = _loss_and_grads(spec.loss_fn, params, batch)
    loss_32, grads_32 = _loss_and_grads(loss32, params, batch)
    cpu = torch.device("cpu")
    cpu_params = map_params(lambda t: t.to(cpu), params)
    cpu_batch = {k: v.to(cpu) for k, v in batch.items()}
    loss_cpu, grads_cpu = _loss_and_grads(loss32, cpu_params, cpu_batch)
    _, grads_flip = _loss_and_grads(loss32, cpu_params,
                                    {k: v.flip(0) for k, v in cpu_batch.items()})
    grads_cpu = {n: g.to(dev) for n, g in grads_cpu.items()}
    spread = _rel({n: g.to(dev) for n, g in grads_flip.items()}, grads_cpu)
    head = [n for n in grads_cpu if n.startswith("head/")]
    fp32 = {"loss_card": loss_32, "loss_cpu": loss_cpu,
            "loss_rel": abs(loss_32 - loss_cpu) / abs(loss_cpu),
            "head_rel": _rel({n: grads_32[n] for n in head},
                             {n: grads_cpu[n] for n in head}),
            "whole_rel": _rel(grads_32, grads_cpu), "cpu_spread_batch_reversed": spread}
    bf16 = {"loss_bf16": loss_16, "loss_rel": abs(loss_16 - loss_32) / abs(loss_32),
            "whole_gradient_rel_reported": _rel(grads_16, grads_32)}
    del grads_16, grads_32, grads_cpu, grads_flip

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    blocks = {}
    for si, (hw, cin) in enumerate(((56, 64), (56, 256), (28, 512), (14, 1024))):
        name, stride = f"stage{si}_block0", 1 if si == 0 else 2
        x = torch.randn((CHECK_BATCH, hw, hw, cin), generator=gen, device=dev).relu_()
        cout = params[name]["conv3"]["kernel"].shape[-1]
        hw_out = -(-hw // stride)
        gy = torch.randn((CHECK_BATCH, hw_out, hw_out, cout), generator=gen, device=dev)
        y16, g16 = _bottleneck_grads(params[name], x, gy, stride, torch.bfloat16)
        y32, g32 = _bottleneck_grads(params[name], x, gy, stride, torch.float32)
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in g32.values()))
        per = {n: ((g16[n].float() - g.float()).norm() / g.float().norm()).item()
               for n, g in g32.items() if g.float().norm() >= CHECK_NORM_FLOOR * norm}
        worst = max(per, key=per.get)
        blocks[name] = {"y_rel": ((y16 - y32).norm() / y32.norm()).item(),
                        "whole_rel": _rel(g16, g32), "worst_tensor": worst,
                        "worst_tensor_rel": per[worst]}

    # Every 1x1 conv of every depth at 224 px is a shape the kernel takes.
    by_depth, finite = {}, True
    for depth in (18, 34, 50, 101, 152):
        dparams = get_model_spec("resnet", depth=depth).init(SEED, device=dev)
        fcs.fused_matmul_stats.launches = 0
        with torch.no_grad():
            logits = rn.forward(dparams, batch["images"][:2], depth)
        by_depth[depth] = fcs.fused_matmul_stats.launches
        finite = finite and bool(torch.isfinite(logits).all())
        del dparams

    first = {}
    for name, builder in (("AllReduce", AllReduce()), ("PSLoadBalancing", PSLoadBalancing())):
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=builder, device=dev)
        step = autodist.build(spec.loss_fn, params, batch)
        _, m = step.run(step.init(params), batch, 1)
        first[name] = m["loss"][0].item()
    ps_rel = abs(first["PSLoadBalancing"] - first["AllReduce"]) / abs(first["AllReduce"])
    emit("resnet_check", model="resnet50", batch=CHECK_BATCH, fp32_card_vs_cpu=fp32,
         bf16_vs_fp32=bf16, bf16_vs_fp32_blocks=blocks, first_step_loss=first,
         ps_vs_allreduce_rel=ps_rel, fused_launches_per_forward_by_depth=by_depth)
    for depth, n in by_depth.items():
        check(n == rn.fused_launches_per_forward(depth),
              f"resnet{depth}: {n} fused launches a forward")
    check(finite, "a resnet depth gave non-finite logits")
    check(fp32["loss_rel"] <= RESNET_FP32_LOSS_RTOL,
          f"resnet fp32 card vs cpu loss rel {fp32['loss_rel']}")
    check(fp32["head_rel"] <= RESNET_FP32_HEAD_RTOL,
          f"resnet fp32 card vs cpu head gradient rel {fp32['head_rel']}")
    check(fp32["whole_rel"] <= RESNET_SPREAD_FACTOR * spread,
          f"resnet fp32 card vs cpu gradient rel {fp32['whole_rel']} > "
          f"{RESNET_SPREAD_FACTOR} x the cpu's own spread {spread}")
    check(bf16["loss_rel"] <= RESNET_BF16_LOSS_RTOL,
          f"resnet bf16 vs fp32 loss rel {bf16['loss_rel']}")
    for name, b in blocks.items():
        check(b["y_rel"] <= RESNET_BLOCK_Y_RTOL, f"{name} bf16 output rel {b['y_rel']}")
        check(b["whole_rel"] <= RESNET_BLOCK_GRAD_RTOL,
              f"{name} bf16 gradient rel {b['whole_rel']}")
        check(b["worst_tensor_rel"] <= RESNET_BLOCK_TENSOR_RTOL,
              f"{name} bf16 {b['worst_tensor']} rel {b['worst_tensor_rel']}")
    check(ps_rel <= 1e-5, f"resnet PSLoadBalancing first loss {first} differ")


# --------------------------------------------------------- zoo conv shapes
# ---------------------------------------------------------------- data_fit
def _write_imagenet(path: str) -> float:
    """DATA_ROWS ImageNet-shaped rows from the seed, written through the
    port's DatasetWriter in blocks; returns the seconds it took."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    with DatasetWriter(path, shard_rows=DATA_SHARD_ROWS) as writer:
        for _ in range(DATA_ROWS // 64):
            writer.append({
                "images": rng.integers(0, 256, (64, DATA_STORED, DATA_STORED, 3),
                                       dtype=np.uint8),
                "labels": rng.integers(0, DATA_CLASSES, 64).astype(np.int32)})
    return time.perf_counter() - t0


def _imagenet_loader(path: str, plan=None, engine: str = "native", train: bool = True,
                     augment: bool = True, device_prefetch: int = 0):
    """The dataset's loader: shuffled with ``imagenet.augment`` (``train``;
    no transform without ``augment``), or in order with ``eval_transform``."""
    transform = (None if not augment
                 else imagenet.augment("images", crop=DATA_CROP, seed=SEED) if train
                 else imagenet.eval_transform("images", crop=DATA_CROP))
    loader = DataLoader.from_files(path, RESNET_BATCH, seed=SEED, shuffle=train, engine=engine,
                                   plan=plan, transform=transform,
                                   device_prefetch=device_prefetch)
    check(loader.engine == engine, f"data_fit: loader engine {loader.engine} != {engine}")
    return loader


def _loader_rate(path: str, engine: str, augment: bool = True) -> float:
    """Images/s of the loader alone over one epoch: augmented, or the
    gather only (``augment=False``)."""
    loader = _imagenet_loader(path, engine=engine, augment=augment)
    t0 = time.perf_counter()
    n = sum(b["images"].shape[0] for b in loader)
    return n / (time.perf_counter() - t0)


def _prefetch_check(path: str, plan) -> dict:
    """``device_prefetch=2`` (pinned buffers, a copy stream) against the
    plain plan path: the same device batches, bitwise; each path's
    images/s to the device. The prefetched epoch runs twice: the first
    is the process's first use of pinned memory (PyTorch's host allocator
    then allocates every buffer), the second reuses what it cached."""
    out = {}
    for label, depth in (("plain", 0), ("prefetch", 2), ("prefetch_again", 2)):
        loader = _imagenet_loader(path, plan, device_prefetch=depth)
        t0 = time.perf_counter()
        batches = [{k: t.clone() for k, t in b.items()} for b in loader]
        torch.cuda.synchronize()
        out[label] = (batches, DATA_ROWS / (time.perf_counter() - t0))
    plain = out["plain"][0]
    check(all(len(plain) == len(out[label][0]) and all(
        torch.equal(a[k], b[k]) and b[k].device == plan.device
        for a, b in zip(plain, out[label][0]) for k in a)
        for label in ("prefetch", "prefetch_again")), "data_fit: device_prefetch batches differ")
    return {f"{label}_images_per_s": rate for label, (_, rate) in out.items()}


def _topk_check(spec, step, state, batch, mfn) -> dict:
    """``classification_metrics`` through ``evaluate_dataset`` against a
    plain top-k on one eval batch. Its labels are set from the model's own
    ranking: per four rows a top-1 hit, a top-5 hit at rank 3, a miss at
    rank 8 and the row's random label. The plain ranking is a stable
    descending sort of ``spec.apply``'s logits, so ties go to the lower
    class index, as in ``lax.top_k``; top1 and top5 must be equal."""
    images = batch["images"]
    with torch.no_grad():
        logits = spec.apply(step.logical_params(state), images).float()
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    n = images.shape[0]
    rank = torch.tensor([0, 2, 7, -1], device=images.device).repeat(n // 4)
    rows = torch.arange(n, device=images.device)
    labels = batch["labels"].clone()
    chosen = rank >= 0
    labels[chosen] = order[rows[chosen], rank[chosen]].to(labels.dtype)
    want = {f"top{k}": (order[:, :k] == labels[:, None]).any(-1).double().mean().item()
            for k in (1, 5)}
    got = M.evaluate_dataset(step, state, [{"images": images, "labels": labels}],
                             metrics_fn=mfn)
    got = {k: got[k] for k in want}
    check(got == want and want["top1"] >= 0.25 and want["top5"] >= 0.5,
          f"data_fit: evaluate_dataset top-k {got} != plain {want}")
    return dict(evaluate_dataset=got, plain=want)


def _busy_union_ms(prof) -> float:
    """The card's busy time in a profiled window: the union of its kernels'
    intervals (ms); 0 when the profiler saw no device activity."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _fit_window(step, params, loader, expect: int, label: str, **fit_kw):
    """One counted ``fit`` from fresh state: (history, host wall s,
    launches); the fused conv-stats launches must be ``expect``, the flash
    kernels none."""
    state = step.init(params)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = step.fit(state, loader, steps=DATA_STEPS, **fit_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fcs.fused_matmul_stats.launches
    check(launches == expect, f"data_fit {label}: fused conv launches {launches} != {expect}")
    check(not any(_launch_counts().values()), f"data_fit {label}: flash launched")
    finite = all(np.isfinite(v) for series in hist.values() for v in series)
    check(finite and len(hist["loss"]) == DATA_STEPS, f"data_fit {label}: history {hist}")
    return hist, wall, launches


def data_fit(card: str, dev) -> dict:
    """The data pipeline and the training loop at full width (phase 10b)."""
    t_phase = time.perf_counter()
    per_fwd = rn.fused_launches_per_forward(50)
    with tempfile.TemporaryDirectory(prefix="data_fit-") as work:
        path = os.path.join(work, "imagenet")
        write_s = _write_imagenet(path)
        shards = sorted(os.listdir(path))
        check(sum(n.startswith("images-") for n in shards) == DATA_ROWS // DATA_SHARD_ROWS,
              f"data_fit: shards {shards}")
        rates = {engine: _loader_rate(path, engine) for engine in ("native", "python")}
        gather = {engine: _loader_rate(path, engine, augment=False)
                  for engine in ("native", "python")}

        spec = get_model_spec("resnet")
        params = spec.init(SEED, device=dev)
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
        step = autodist.build(spec.loss_fn, params, spec.example_batch(RESNET_BATCH, device=dev))
        mfn = M.classification_metrics(spec.apply, top_k=(1, 5))
        prefetch = _prefetch_check(path, autodist.plan)
        eval_batch = next(iter(_imagenet_loader(path, autodist.plan, train=False)))
        fit_kw = dict(eval_batch=eval_batch, eval_every=DATA_STEPS, eval_metrics_fn=mfn)
        # Warm-up (first calls of the step, the eval and the metrics), not counted.
        step.fit(step.init(params), _imagenet_loader(path, autodist.plan), steps=1,
                 eval_batch=eval_batch, eval_every=1, eval_metrics_fn=mfn)
        expect = per_fwd * (DATA_STEPS + 2)      # train steps, evaluate, the metrics
        runs, launches = {}, 0
        for label, window in (("per_step_a", 0), ("per_step_b", 0), ("window", DATA_WINDOW)):
            hist, wall, n = _fit_window(step, params, _imagenet_loader(path, autodist.plan),
                                        expect, label, window=window, **fit_kw)
            runs[label], launches = (hist, wall), launches + n
        a, b, w = (runs[k][0] for k in ("per_step_a", "per_step_b", "window"))
        series = ("loss", "eval_loss", "eval_top1", "eval_top5")
        check(all(len(w[k]) == len(a[k]) == len(b[k]) for k in series),
              f"data_fit: series {w} vs {a}")
        spread = max(abs(x - y) for k in series for x, y in zip(a[k], b[k]))
        apart = max(abs(x - y) for k in series for x, y in zip(w[k], a[k]))
        check(apart <= 2 * spread, f"data_fit: windowed history {w} vs per-step {a}: "
              f"{apart} > 2 x the per-step runs' spread {spread}")

        # The step's rate under fit, then the same fit profiled for the busy share.
        _, fit_wall, n = _fit_window(step, params, _imagenet_loader(path, autodist.plan),
                                     per_fwd * DATA_STEPS, "timed")
        launches += n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, prof_wall, n = _fit_window(step, params, _imagenet_loader(path, autodist.plan),
                                          per_fwd * DATA_STEPS, "profiled")
        launches += n
        busy_ms = _busy_union_ms(prof)
        _, prefetch_wall, n = _fit_window(
            step, params, _imagenet_loader(path, autodist.plan, device_prefetch=2),
            per_fwd * DATA_STEPS, "prefetch")
        launches += n

        state = step.init(params)
        loader = _imagenet_loader(path, autodist.plan, train=False)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = M.evaluate_dataset(step, state, loader, metrics_fn=mfn)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        n_batches = DATA_ROWS // RESNET_BATCH
        n = fcs.fused_matmul_stats.launches
        check(n == per_fwd * 2 * n_batches,
              f"data_fit evaluate_dataset: fused conv launches {n} != {per_fwd} x 2 x {n_batches}")
        check(not any(_launch_counts().values()), "data_fit evaluate_dataset: flash launched")
        check(result["examples"] == DATA_ROWS and np.isfinite(result["loss"])
              and all(0.0 <= result[k] <= 1.0 for k in ("top1", "top5")),
              f"data_fit evaluate_dataset: {result}")
        launches += n
        topk = _topk_check(spec, step, state, eval_batch, mfn)
        del step, state, params, autodist
    lm = _data_fit_lm(card, dev)
    train_images = DATA_STEPS * RESNET_BATCH
    row = dict(model="resnet50", image_size=DATA_CROP, stored=DATA_STORED, rows=DATA_ROWS,
               shards=DATA_ROWS // DATA_SHARD_ROWS, batch=RESNET_BATCH, steps=DATA_STEPS,
               window=DATA_WINDOW, write_s=write_s, loader_images_per_s=rates,
               gather_images_per_s=gather, to_device=prefetch,
               histories={k: v[0] for k, v in runs.items()},
               per_step_spread=spread, windowed_vs_per_step=apart, bitwise=spread == 0.0,
               fit_wall_s=fit_wall, fit_images_per_s=train_images / fit_wall,
               fit_prefetch_wall_s=prefetch_wall,
               fit_prefetch_images_per_s=train_images / prefetch_wall,
               profiled_wall_s=prof_wall,
               busy_ms_per_step=busy_ms / DATA_STEPS if busy_ms else "not measured",
               busy_share=busy_ms / 1e3 / fit_wall if busy_ms else "not measured",
               evaluate_dataset=result, evaluate_s=eval_s, topk_check=topk,
               kernel_launches={"fused_conv_stats": launches},
               lm=lm, seconds=time.perf_counter() - t_phase, card=card)
    emit("data_fit", **row)
    return row


def _data_fit_lm(card: str, dev) -> dict:
    """The causal transformer at full width fitted from an in-memory native
    loader of token rows, with lm_metrics(pad_id=0) at its eval points."""
    spec = get_model_spec("transformer", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    cfg = spec.config
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(1, cfg.vocab_size, (DATA_LM_ROWS, TRAIN_SEQ)).astype(np.int32)
    eval_tokens = rng.integers(1, cfg.vocab_size, (LM_BATCH, TRAIN_SEQ)).astype(np.int32)
    eval_tokens[:, DATA_LM_VALID:] = 0
    params = spec.init(SEED, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
    step = autodist.build(spec.loss_fn, params, spec.example_batch(LM_BATCH, device=dev))
    mfn = M.lm_metrics(spec.apply, pad_id=0)
    eval_batch = {"tokens": torch.from_numpy(eval_tokens).to(dev)}

    def loader():
        out = DataLoader({"tokens": tokens}, LM_BATCH, seed=SEED, engine="native",
                         plan=autodist.plan)
        check(out.engine == "native", f"data_fit lm: engine {out.engine}")
        return out

    step.fit(step.init(params), loader(), steps=1, eval_batch=eval_batch, eval_every=1,
             eval_metrics_fn=mfn)                                  # warm-up
    state = step.init(params)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = step.fit(state, loader(), steps=DATA_LM_STEPS, eval_batch=eval_batch,
                           eval_every=DATA_LM_EVAL_EVERY, eval_metrics_fn=mfn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    evals = DATA_LM_STEPS // DATA_LM_EVAL_EVERY
    want = {"fwd": cfg.num_layers * (DATA_LM_STEPS + 2 * evals),
            "dkdv": cfg.num_layers * DATA_LM_STEPS, "dq": cfg.num_layers * DATA_LM_STEPS}
    check(launches == want, f"data_fit lm: flash launches {launches} != {want}")
    check(fcs.fused_matmul_stats.launches == 0, "data_fit lm: fused conv kernel launched")
    check(all(np.isfinite(v) for series in hist.values() for v in series)
          and len(hist["loss"]) == DATA_LM_STEPS
          and len(hist["eval_token_accuracy"]) == evals, f"data_fit lm: history {hist}")
    return dict(model="transformer", seq=TRAIN_SEQ, batch=LM_BATCH, steps=DATA_LM_STEPS,
                history=hist, wall_s=wall, kernel_launches=launches, card=card)


def fused_conv_shapes(model: str, overrides: dict, batch: int, dev) -> dict:
    """``{(M, K, N): launches}`` of the fused conv-stats op in one forward of
    ``model`` at ``batch``: a forward on meta tensors (no work, no memory)
    with a spy on the op."""
    spec = get_model_spec(model, **overrides)
    params = map_params(lambda t: t.to("meta"), spec.init(SEED, device=dev))
    size = overrides["image_size"]
    shapes: dict = {}
    plain = fcs.fused_matmul_stats

    def spy(x, w):
        key = (x.shape[0], x.shape[1], w.shape[1])
        shapes[key] = shapes.get(key, 0) + 1
        return plain(x, w)

    fcs.fused_matmul_stats = spy
    try:
        with torch.no_grad():
            spec.apply(params, torch.empty((batch, size, size, 3), device="meta"))
    finally:
        fcs.fused_matmul_stats = plain
    return shapes


def zoo_conv_shapes(dev) -> dict:
    """The distinct fused conv-stats shapes of an Inception-v3 (299 px) and a
    DenseNet-121 (224 px) forward at batch 128, each with its model and its
    launches a forward; their launch totals checked against CONV_ZOO."""
    out = {}
    for key, model, overrides, batch, _ in ZOO:
        if key not in CONV_ZOO:
            continue
        shapes = fused_conv_shapes(model, overrides, batch, dev)
        check(sum(shapes.values()) == CONV_ZOO[key],
              f"{key}: {sum(shapes.values())} fused convs a forward, not {CONV_ZOO[key]}")
        out[key] = shapes
    return out


# ----------------------------------------------------------------- zoo train
def zoo_train(card: str, dev, zoo_shapes: dict):
    """Each ZOO configuration through AutoDist (AllReduce, default SGD at
    0.01): one warm-up step, then the counted ``step.run`` window of
    ZOO_STEPS steps, with the fused launches of ``zoo_shapes``'s forward a
    step."""
    rows = []
    for key, model, overrides, batch_size, unit in ZOO:
        spec = get_model_spec(model, **overrides)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
        t0 = time.perf_counter()
        step = autodist.build(spec.loss_fn, params, batch, sparse_names=spec.sparse_names,
                              expert_names=spec.expert_names)
        build_s = time.perf_counter() - t0
        state = step.init(params)
        del params
        state, _ = step.run(state, batch, 1)            # warm-up, not counted
        torch.cuda.synchronize()

        # The main path's window: counts to 0 just before, read just after.
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, metrics = step.run(state, batch, ZOO_STEPS)
        losses = metrics["loss"].tolist()
        wall = time.perf_counter() - t0
        launches = fcs.fused_matmul_stats.launches
        flash = _launch_counts()
        items = batch_size
        if unit == "tokens":
            items *= batch["tokens"].shape[1] - 1           # the predicted positions
        mfu = (spec.flops_per_example * batch_size * ZOO_STEPS / wall
               / PEAK_OPS_PER_S[torch.bfloat16]) if spec.flops_per_example else None
        row = dict(model=key, zoo=model, overrides=overrides, batch=batch_size,
                   steps=ZOO_STEPS, strategy="AllReduce", optimizer="sgd 0.01",
                   build_s=build_s, losses=losses, wall_s=wall,
                   ms_per_step=wall / ZOO_STEPS * 1e3,
                   **{f"{unit}_per_s": items * ZOO_STEPS / wall}, mfu=mfu,
                   kernel_launches={"fused_conv_stats": launches, **flash},
                   fused_per_step=launches / ZOO_STEPS,
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card)
        emit("zoo_train", **row)
        check(all(np.isfinite(losses)), f"{key}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{key}: loss did not fall {losses}")
        want = sum(zoo_shapes.get(key, {}).values())
        check(launches == want * ZOO_STEPS,
              f"{key}: fused conv launches {launches} != {want} x {ZOO_STEPS}")
        check(not any(flash.values()), f"{key}: flash kernels launched {flash}")
        rows.append(row)
        del step, state, batch, metrics
        torch.cuda.empty_cache()
    return rows


def _fp32_spec(key: str):
    """The ModelSpec of PUBLISHED ``key`` with its loss at fp32 compute."""
    zoo, overrides, _, _ = PUBLISHED[key]
    if key == "moe":
        return get_model_spec(zoo, dtype="float32", **overrides)
    spec = get_model_spec(zoo, **overrides)
    if key == "vgg16":
        return replace(spec, loss_fn=lambda p, b: L.softmax_xent(
            vgg.forward(p, b["images"], 16, dtype=torch.float32), b["labels"]))
    if key == "lm1b":      # the lstm_lm defaults: 2 layers of 1024
        return replace(spec, loss_fn=lambda p, b: L.softmax_xent(
            lstm_lm.forward(p, b["tokens"][:, :-1], 2, 1024, dtype=torch.float32),
            b["tokens"][:, 1:]))
    return spec                                       # ncf computes in fp32


def zoo_check(dev):
    """Each ZOO_CHECK model in fp32 at batch CHECK_BATCH: the first step's
    loss and gradients of the built step (``step.loss_and_grads``) on the
    card against the CPU's from the same weights."""
    cpu = torch.device("cpu")
    rows = []
    for key in ZOO_CHECK:
        spec = _fp32_spec(key)
        params = spec.init(SEED, device=cpu)      # the CPU's draws, on both devices
        runs = {}
        for where in (dev, cpu):
            p = map_params(lambda t: t.to(where), params)
            batch = spec.example_batch(CHECK_BATCH, device=where)
            AutoDist.reset_default()
            step = AutoDist(strategy_builder=AllReduce(), device=where).build(
                spec.loss_fn, p, batch, sparse_names=spec.sparse_names,
                expert_names=spec.expert_names)
            loss, _, grads = step.loss_and_grads(step.init(p), batch)
            names = [n for n, t in flatten_params(p).items() if t.is_floating_point()]
            runs[where.type] = (loss.item(), {n: g.to(cpu) for n, g in zip(names, grads)})
        (loss_card, grads_card), (loss_cpu, grads_cpu) = runs["cuda"], runs["cpu"]
        row = dict(model=key, batch=CHECK_BATCH, loss_card=loss_card, loss_cpu=loss_cpu,
                   loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu),
                   whole_gradient_rel=_rel(grads_card, grads_cpu),
                   gradient_norm=torch.sqrt(sum((g ** 2).sum()
                                                for g in grads_cpu.values())).item())
        rows.append(row)
        del runs, params
        torch.cuda.empty_cache()
    emit("zoo_check", loss_rtol=ZOO_CHECK_LOSS_RTOL, grad_rtol=ZOO_CHECK,
         rows=rows)
    for row in rows:
        check(row["loss_rel"] <= ZOO_CHECK_LOSS_RTOL
              and row["whole_gradient_rel"] <= ZOO_CHECK[row["model"]],
              f"zoo_check {row['model']}: card vs cpu {row}")


# -------------------------------------------------------- optimizers, remat
def _mlp_run(name, kwargs, device):
    # The same weights on both devices: drawn on the CPU (a CUDA generator
    # draws other numbers), then moved.
    spec = get_model_spec("mlp")
    params = map_params(lambda t: t.to(device), spec.init(SEED, device="cpu"))
    batch = spec.example_batch(OPTIM_BATCH, device=device)
    AutoDist.reset_default()
    step = AutoDist(strategy_builder=AllReduce(), device=device).build(
        spec.loss_fn, params, batch, optimizer=OptimizerSpec(name, kwargs))
    state, metrics = step.run(step.init(params), batch, OPTIM_STEPS)
    return metrics["loss"].cpu(), {n: t.detach().cpu() for n, t in
                                   flatten_params(state.params).items()}


def optim_check(dev):
    """Each new optimizer and schedule: OPTIM_STEPS fp32 steps of the mlp on
    the card against the same update rules on the CPU."""
    cpu = torch.device("cpu")
    rows = []
    for name, kwargs in OPTIM_CASES:
        card_loss, card = _mlp_run(name, kwargs, dev)
        cpu_loss, host = _mlp_run(name, kwargs, cpu)
        rel = max(((card[n] - t).norm() / t.norm()).item() for n, t in host.items())
        loss_rel = ((card_loss - cpu_loss).abs() / cpu_loss.abs()).max().item()
        label = kwargs["learning_rate"]["schedule"] if name == "sgd" else name
        rows.append(dict(case=label, worst_param_rel=rel, loss_rel=loss_rel,
                         losses=card_loss.tolist()))
        check(rel <= OPTIM_RTOL and loss_rel <= OPTIM_RTOL,
              f"optim {label}: card vs cpu params rel {rel}, losses rel {loss_rel}")
    emit("optim_check", model="mlp", steps=OPTIM_STEPS, batch=OPTIM_BATCH,
         rtol=OPTIM_RTOL, cases=rows)


def _max_diff(a: dict, b: dict) -> float:
    return max((a[n].float() - g.float()).abs().max().item() for n, g in b.items())


def remat_check(dev):
    """bert_base (seq 512, batch 32, flash) built with no remat,
    ``remat=True`` and ``remat="dots_saveable"`` (the whole loss
    checkpointed), and with ``TransformerConfig.remat`` (each block): one
    step's loss and gradients each (flash launches, host wall, peak memory)
    against the run without remat."""
    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    blocks = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash",
                            remat=True)
    params = spec.init(SEED + 7, device=dev)
    batch = spec.example_batch(TRAIN_BATCH, device=dev)
    cfg = spec.config
    runs = {}
    for mode, loss_fn, remat in (("none", spec.loss_fn, False), ("True", spec.loss_fn, True),
                                 ("dots_saveable", spec.loss_fn, "dots_saveable"),
                                 ("blocks", blocks.loss_fn, False)):
        AutoDist.reset_default()
        step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
            loss_fn, params, batch, remat=remat)
        state = step.init(params)
        step.loss_and_grads(state, batch)               # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _, grads = step.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        runs[mode] = dict(loss=loss.item(), launches=_launch_counts(),
                          ms=(time.perf_counter() - t0) * 1e3,
                          peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                          grads=dict(zip(flatten_params(state.params), grads)))
        del step, state, grads
    base = runs["none"]
    rows = {}
    for mode, run in runs.items():
        loss_rel = abs(run["loss"] - base["loss"]) / abs(base["loss"])
        diff = _max_diff(run["grads"], base["grads"])
        rel = _rel(run["grads"], base["grads"])
        bitwise = loss_rel == 0 and diff == 0
        rows[mode] = dict(loss=run["loss"], loss_rel=loss_rel, grad_max_abs_diff=diff,
                          grad_rel=rel, bitwise=bitwise, flash_launches=run["launches"],
                          loss_and_grads_ms=run["ms"], peak_mem_gb=run["peak_mem_gb"])
        fwd = cfg.num_layers * (1 if mode == "none" else 2)
        check(run["launches"] == {"fwd": fwd, "dkdv": cfg.num_layers, "dq": cfg.num_layers},
              f"remat={mode}: flash launches {run['launches']}")
        check(loss_rel <= REMAT_RTOL and rel <= REMAT_RTOL,
              f"remat={mode}: loss rel {loss_rel}, gradient rel {rel} vs no remat")
    emit("remat_check", model="bert_base", seq=TRAIN_SEQ, batch=TRAIN_BATCH,
         attention_impl="flash", rtol=REMAT_RTOL, runs=rows)


def accum_check(dev):
    """The fp32 causal transformer (full width, seq 512, flash), first step at
    batch ACCUM_BATCH: ``grad_accum_steps=ACCUM_K`` against 1."""
    spec = get_model_spec("transformer", max_seq_len=TRAIN_SEQ, attention_impl="flash",
                          dtype="float32")
    params = spec.init(SEED + 8, device=dev)
    batch = spec.example_batch(ACCUM_BATCH, device=dev)
    out = {}
    for k in (1, ACCUM_K):
        AutoDist.reset_default()
        step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
            spec.loss_fn, params, batch, grad_accum_steps=k)
        state = step.init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        loss, _, grads = step.loss_and_grads(state, batch)
        out[k] = (loss.item(), dict(zip(flatten_params(state.params), grads)),
                  torch.cuda.max_memory_allocated(dev) / 1e9)
        del step, state
    (l1, g1, m1), (lk, gk, mk) = out[1], out[ACCUM_K]
    loss_rel = abs(lk - l1) / abs(l1)
    rel = _rel(gk, g1)
    emit("accum_check", model="transformer", dtype="float32", seq=TRAIN_SEQ,
         batch=ACCUM_BATCH, k=ACCUM_K, loss_k1=l1, loss_k=lk, loss_rel=loss_rel,
         whole_gradient_rel=rel, rtol=ACCUM_RTOL, peak_mem_gb={"k1": m1, "k": mk})
    check(loss_rel <= ACCUM_RTOL and rel <= ACCUM_RTOL,
          f"grad_accum_steps={ACCUM_K}: loss rel {loss_rel}, gradient rel {rel}")


# --------------------------------------------------------------- dist_train
def _wire(counts) -> dict:
    """A step's gradient and parameter collectives, by kind."""
    out = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for purpose in ("grad", "param"):
        for kind, n in counts.get(purpose, {}).items():
            out[kind] += n
    return out


def _one_process_step(builder, loss_fn, params, batch, dev, opt=DIST_OPT):
    """The same strategy lowered onto this process alone (no group)."""
    opt = OptimizerSpec(*opt)
    item = ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                 example_batch=batch)
    spec = ResourceSpec.from_local_devices(dev)
    strategy = StrategyCompiler(item).compile(builder.build(item, spec))
    plan = GraphTransformer(strategy, item, build_mesh(spec, device=dev)).transform()
    return DistributedTrainStep(plan, loss_fn, opt.make())


def _train_window(step, params, batch, steps, dev):
    """One step, then ``steps`` counted and timed: ``(state, losses of all,
    ms a timed step, kernel launches of the timed steps, last step's
    collectives)``."""
    state = step.init(params)
    state, first = step(state, batch)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m["loss"])
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {"fused_conv_stats": fcs.fused_matmul_stats.launches, **_launch_counts()}
    losses = [float(first["loss"])] + [float(x) for x in metrics]
    return state, losses, ms, launches, step.last_collectives


def dist_rank(rank: int, world: int, work: str) -> int:
    """One NCCL rank of dist_train (see the module docstring)."""
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    models = (("bert_base", get_model_spec("bert_base", max_seq_len=TRAIN_SEQ,
                                           attention_impl="flash"), TRAIN_BATCH),
              ("resnet50", get_model_spec("resnet"), RESNET_BATCH))
    rows = []
    for key, spec, batch_size in models:
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        for name, kwargs in DIST_BUILDERS:
            plain = None
            if rank == 0:
                step = _one_process_step(from_name(name, **kwargs), spec.loss_fn, params,
                                         batch, dev)
                state, losses, ms, _, _ = _train_window(step, params, batch, DIST_STEPS, dev)
                plain = (flatten_params(step.logical_params(state)), losses, ms)
                del step, state
            AutoDist.reset_default()
            autodist = AutoDist(strategy_builder=from_name(name, **kwargs), device="cuda",
                                init_method=f"file://{work}/pg", world_size=world,
                                rank=rank, timeout_s=DIST_GROUP_TIMEOUT_S)
            step = autodist.build(spec.loss_fn, params, batch,
                                  optimizer=OptimizerSpec(*DIST_OPT))
            state, losses, ms, launches, wire = _train_window(step, params, batch,
                                                              DIST_STEPS, dev)
            dist_ckpt = (_dist_checkpoint(key, step, state, spec, params, batch, work, rank,
                                          dev) if name == "Zero1" else None)
            logical = flatten_params(step.logical_params(state))
            predicted = autodist.plan.collectives_per_step()
            row = dict(model=key, strategy=name, strategy_kwargs=kwargs, world=world,
                       global_batch=batch_size, steps=1 + DIST_STEPS, optimizer=DIST_OPT,
                       losses=losses, ms_per_step=ms, collectives=wire,
                       predicted_wire=predicted, batchnorm_local=step.manual,
                       kernel_launches=launches, dist_checkpoint=dist_ckpt)
            check(_wire(wire) == predicted,
                  f"{key}/{name}: wire {wire} != the plan's {predicted}")
            if rank == 0:
                plain_params, plain_losses, plain_ms = plain
                diff = max((logical[n].float() - t.float()).abs().max().item()
                           for n, t in plain_params.items())
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
                row.update(plain_losses=plain_losses, plain_ms_per_step=plain_ms,
                           max_param_diff=diff, max_loss_rel=rel,
                           bitwise=diff == 0.0 and losses == plain_losses)
                if world == 1:
                    check(row["bitwise"], f"{key}/{name}: world size 1 not bitwise equal "
                          f"to the one-process step (loss rel {rel}, param diff {diff})")
                else:
                    check(rel <= DIST_LOSS_RTOL[key], f"{key}/{name}: loss rel {rel} > "
                          f"{DIST_LOSS_RTOL[key]}")
                del plain, plain_params
            rows.append(row)
            del step, state, logical
            torch.cuda.empty_cache()
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def _rehearsal_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def _rehearsal_inputs():
    gen = torch.Generator().manual_seed(SEED)
    params = {"w": torch.randn(12, 5, generator=gen), "b": torch.randn(5, generator=gen)}
    return params, (torch.randn(16, 12, generator=gen), torch.randn(16, 5, generator=gen))


def _rehearsal_comp_inputs():
    gen = torch.Generator().manual_seed(SEED + 1)
    params = {"w": torch.randn(128, 64, generator=gen) * 0.1,
              "b": torch.randn(64, generator=gen)}
    return params, (torch.randn(16, 128, generator=gen), torch.randn(16, 64, generator=gen))


def _capture_sync(step) -> list:
    """Record each call of the step's gradient sync: ``(local gradients,
    compressor state before, synced gradients)``, cloned."""
    log, sync = [], step._sync

    def recorded(grads, done, comp_state):
        before = {n: {part: {k: t.clone() for k, t in st[part].items()} for part in st}
                  for n, st in comp_state.items()}
        local = {n: g.detach().clone() for n, g in grads.items()}
        out = sync(grads, done, comp_state)
        log.append((local, before, {n: g.clone() for n, g in out.items()}))
        return out

    step._sync = recorded
    return log


def dist_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of the CPU rehearsal."""
    torch.set_num_threads(1)
    params, batch = _rehearsal_inputs()
    out = {}

    def autodist_for(builder):
        AutoDist.reset_default()
        return AutoDist(strategy_builder=builder, device="cpu",
                        resource_spec=ResourceSpec(resource_dict={"nodes": [
                            {"address": "localhost", "gpus": world}]}),
                        init_method=f"file://{work}/pg", world_size=world, rank=rank,
                        timeout_s=DIST_GROUP_TIMEOUT_S)

    for name, kwargs in REHEARSAL_BUILDERS:
        autodist = autodist_for(from_name(name, **kwargs))
        step = autodist.build(_rehearsal_loss, params, batch,
                              optimizer=OptimizerSpec(*DIST_OPT))
        state = step.init(params)
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
        out[name] = {n: t.tolist() for n, t in flatten_params(
            step.logical_params(state)).items()}
        out[name + "/wire"] = [_wire(step.last_collectives),
                               autodist.plan.collectives_per_step()]
    cparams, cbatch = _rehearsal_comp_inputs()
    for name in REHEARSAL_COMPRESSORS:
        autodist = autodist_for(AllReduce(compressor=name))
        step = autodist.build(_rehearsal_loss, cparams, cbatch,
                              optimizer=OptimizerSpec("sgd", {"learning_rate": REHEARSAL_LR}))
        log = _capture_sync(step)
        state, _ = step(step.init(cparams), cbatch)
        local, _, synced = log[0]
        out[name] = {
            "local": {n: g.tolist() for n, g in local.items()},
            "synced": {n: g.tolist() for n, g in synced.items()},
            "residual": {n: st["local"]["residual"].tolist()
                         for n, st in state.comp_state.items() if st["local"]},
            "params": {n: t.tolist() for n, t in flatten_params(
                step.logical_params(state)).items()},
            "wire": [_wire(step.last_collectives), autodist.plan.collectives_per_step()]}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def _spawn_ranks(flag: str, world: int, work: str, env: dict) -> list:
    """Start ``world`` ranks of this script, wait (``DIST_TIMEOUT_S`` in
    all), kill any left, and return rank by rank their results."""
    return _join_ranks(flag, _start_ranks(flag, world, work, env), work)


def _start_ranks(flag: str, world: int, work: str, env: dict) -> list:
    """``world`` ranks of this script started with ``flag``: their processes."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                              str(world), work], env=env)
            for r in range(world)]


def _join_ranks(flag: str, procs: list, work: str) -> list:
    """Wait for ranks started by :func:`_start_ranks` (``DIST_TIMEOUT_S`` in
    all), kill any left, and return rank by rank their results."""
    world = len(procs)
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    check(all(c == 0 for c in codes), f"{flag} ranks exited {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json"), encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def dist_train(card: str) -> list:
    """The dist_train phase: NCCL ranks over the cards (its CPU rehearsal
    is :func:`dist_rehearsal`). Returns rank 0's rows."""
    world = 1
    while world * 2 <= min(torch.cuda.device_count(), 8):
        world *= 2
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--dist-rank", world, work, env)[0]
    seconds = time.perf_counter() - t0
    for row in rows:
        emit("dist_train", **row, ranks_seconds=seconds, card=card)
        model, steps = row["model"], DIST_STEPS
        launches = row["kernel_launches"]
        if model == "bert_base":
            layers = get_model_spec("bert_base").config.num_layers
            for kind in ("fwd", "dkdv", "dq"):
                check(launches[kind] == layers * steps,
                      f"dist {model}: flash {kind} launches {launches[kind]}")
        else:
            per = rn.fused_launches_per_forward(50) * steps
            check(launches["fused_conv_stats"] == per,
                  f"dist {model}: fused conv launches {launches['fused_conv_stats']} != {per}")
    return rows


def dist_rehearsal() -> None:
    """4 gloo ranks on the CPU against the one-process step."""
    t0 = time.perf_counter()
    cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--dist-cpu-rank", REHEARSAL_RANKS, work, cpu_env)
    params, batch = _rehearsal_inputs()
    worst = {}
    for name, kwargs in REHEARSAL_BUILDERS:
        step = _one_process_step(from_name(name, **kwargs), _rehearsal_loss, params, batch,
                                 torch.device("cpu"))
        state = step.init(params)
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
        want = flatten_params(step.logical_params(state))
        for r, got in enumerate(ranks):
            for n, t in want.items():
                check(torch.allclose(torch.tensor(got[name][n]), t, rtol=REHEARSAL_RTOL,
                                     atol=REHEARSAL_ATOL),
                      f"rehearsal {name} rank {r} {n} differs from one process")
            wire, predicted = got[name + "/wire"]
            check(wire == predicted, f"rehearsal {name}: wire {wire} != {predicted}")
        worst[name] = max((torch.tensor(ranks[0][name][n]) - t).abs().max().item()
                          for n, t in want.items())
    comp = {name: _rehearsal_compressed(name, ranks) for name in REHEARSAL_COMPRESSORS}
    emit("dist_train_cpu_rehearsal", note="gloo on the CPU: a rehearsal, not a card result",
         ranks=REHEARSAL_RANKS, steps=REHEARSAL_STEPS, max_abs_diff_vs_one_process=worst,
         rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL, compressed_step=comp,
         seconds=time.perf_counter() - t0)


def _rehearsal_compressed(name: str, ranks: list) -> dict:
    """One compressed step of the 4 gloo ranks against the mean of their
    compressed gradients, gathered by hand from each rank's local gradient:
    EF within REHEARSAL_BF16_STEPS bf16 steps of the payloads' magnitudes
    (gloo rounds its bf16 partial sums), its residual ``inp - bf16(inp)``
    bitwise; TopK's scatter-add in rank order bitwise. Every rank's synced
    gradient the same, the update ``p - lr g`` bitwise, the wire the
    plan's."""
    cparams, _ = _rehearsal_comp_inputs()
    n = len(ranks)
    got = [{k: {v: torch.tensor(x) for v, x in r[name][k].items()}
            for k in ("local", "synced", "residual", "params")} for r in ranks]
    local = [g["local"] for g in got]
    worst = 0.0
    for var, synced in got[0]["synced"].items():
        for r in range(1, n):
            check(torch.equal(got[r]["synced"][var], synced),
                  f"rehearsal {name}: rank {r} synced {var} differs from rank 0's")
        flat = [local[r][var].reshape(-1) for r in range(n)]
        if name == "HorovodCompressorEF":
            payload = [f.to(torch.bfloat16).float() for f in flat]
            for r in range(n):
                check(torch.equal(got[r]["residual"][var].reshape(-1), flat[r] - payload[r]),
                      f"rehearsal EF: rank {r} residual of {var} is not inp - bf16(inp)")
            exact = sum(p.double() for p in payload) / n
            bound = REHEARSAL_BF16_STEPS * 2.0 ** -8 * sum(p.abs().double() for p in payload) / n
            err = (synced.reshape(-1).double() - exact).abs()
            check(bool((err <= bound).all()), f"rehearsal EF {var}: synced off the bf16 "
                  f"mean by {(err / bound).max().item()} of its bound")
            worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
        elif flat[0].numel() >= TOPK_MIN_SIZE:
            k = max(1, int(flat[0].numel() * TOPK_RATIO))
            dense = torch.zeros_like(flat[0])
            for r in range(n):
                idx = torch.argsort(flat[r].abs(), descending=True, stable=True)[:k]
                dense[idx] += flat[r][idx]
                residual = flat[r].clone()
                residual[idx] = 0.0
                check(torch.equal(got[r]["residual"][var].reshape(-1), residual),
                      f"rehearsal TopK: rank {r} residual of {var} differs")
            check(torch.equal(synced.reshape(-1), dense / n),
                  f"rehearsal TopK {var}: synced != the rank-order scatter-add")
        else:
            want = sum(flat) / n
            check(torch.allclose(synced.reshape(-1), want, rtol=1e-6, atol=1e-7),
                  f"rehearsal {name} {var}: dense mean differs")
        want_p = cparams[var] + (-REHEARSAL_LR * synced)
        check(torch.equal(got[0]["params"][var], want_p),
              f"rehearsal {name} {var}: params != p - lr g")
    for r in ranks:
        wire, predicted = r[name]["wire"]
        check(wire == predicted, f"rehearsal {name}: wire {wire} != {predicted}")
    return {"ef_worst_of_bound": worst} if name == "HorovodCompressorEF" else \
        {"topk_bitwise": True}


# ------------------------------------------------------------- sync_options
def _plain_compressed(name: str, g, local: dict, shared: dict):
    """The compressor's function at one rank, written plainly on the card:
    ``(synced gradient, residual or None, q or None)``."""
    if name == "HorovodCompressor":
        return g.to(torch.bfloat16).float(), None, None
    if name == "HorovodCompressorEF":
        inp = g + local["residual"]
        out = inp.to(torch.bfloat16).float()
        return out, inp - out, None
    if name == "TopKCompressor":
        if g.numel() < TOPK_MIN_SIZE:
            return g, None, None
        flat = (g + local["residual"]).reshape(-1)
        idx = torch.argsort(flat.abs(), descending=True, stable=True)[
            :max(1, int(flat.numel() * TOPK_RATIO))]
        out, residual = torch.zeros_like(flat), flat.clone()
        out[idx], residual[idx] = flat[idx], 0.0
        return out.view_as(g), residual.view_as(g), None
    if g.dim() < 2:                                     # PowerSGD's vectors
        return g, None, None
    inp = (g + local["residual"]).double()
    mat = inp.reshape(g.shape[0], -1)
    cols = []
    for col in (mat @ shared["q"].double()).T:          # Gram-Schmidt
        for c in cols:
            col = col - (c @ col) * c
        cols.append(col / col.norm())
    p = torch.stack(cols, 1)
    qn = mat.T @ p
    approx = (p @ qn.T).reshape(g.shape)
    return approx.float(), (inp - approx).float(), qn.float()


def _off_by(got, want, signed_columns: bool = False) -> float:
    """max |got - want| over the largest |want|; with ``signed_columns``
    each column compared up to its sign."""
    got, want = got.double(), want.double()
    if signed_columns:
        diff = torch.stack([torch.minimum((g - w).abs().max(), (g + w).abs().max())
                            for g, w in zip(got.T, want.T)])
    else:
        diff = (got - want).abs()
    return (diff.max() / want.abs().max().clamp_min(1e-30)).item()


def _compressor_check(name: str, step, state, log) -> dict:
    """The step's synced gradient, residual and q against the plain
    function on the card: bitwise, PowerSGD within POWERSGD_TOL."""
    local, before, synced = log[-1]
    comps = step.compressors
    worst, compressed = 0.0, 0
    for var, g in local.items():
        if var not in comps:
            check(torch.equal(synced[var], g), f"{name}: uncompressed {var} changed")
            continue
        st = before[var]
        want, residual, q = _plain_compressed(name, g, st["local"], st["shared"])
        new = state.comp_state[var]
        if name == "PowerSGDCompressor":
            errs = [_off_by(synced[var], want)]
            if residual is not None:
                errs += [_off_by(new["local"]["residual"], residual),
                         _off_by(new["shared"]["q"], q, signed_columns=True)]
            worst = max([worst] + errs)
            check(max(errs) <= POWERSGD_TOL, f"{name} {var}: off the plain function by "
                  f"{max(errs)} of its largest entry > {POWERSGD_TOL}")
        else:
            check(torch.equal(synced[var], want), f"{name} {var}: synced gradient is not "
                  f"the plain function's")
            if residual is not None:
                check(torch.equal(new["local"]["residual"], residual),
                      f"{name} {var}: residual is not inp - compressed")
        compressed += residual is not None
    return {"compressed_vars": len(comps), "with_state": compressed,
            "powersgd_worst_of_largest": worst if name == "PowerSGDCompressor" else None}


def _sync_window(step, params, batch, steps: int, dev):
    """One warm-up step, then a counted window of ``steps``: ``(state,
    losses of all, ms a window step, launches, the window's collectives a
    step, peak memory of the window in bytes)``."""
    state = step.init(params)
    state, first = step(state, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    losses, wire = [float(first["loss"])], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        wire.append(_wire(step.last_collectives))
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {"fused_conv_stats": fcs.fused_matmul_stats.launches, **_launch_counts()}
    return state, losses, ms, launches, wire, torch.cuda.max_memory_allocated(dev)


def _check_run(key: str, model: str, losses, launches, wire, predicted, steps: int,
               falls: bool = True) -> None:
    check(all(np.isfinite(losses)), f"{key}: non-finite loss {losses}")
    if falls:
        check(losses[-1] < losses[0], f"{key}: loss did not fall {losses}")
    for counts in wire:
        check(counts == predicted, f"{key}: wire {counts} != the plan's {predicted}")
    if model == "bert_base":
        layers = get_model_spec("bert_base").config.num_layers
        for kind in ("fwd", "dkdv", "dq"):
            check(launches[kind] == layers * steps,
                  f"{key}: flash {kind} launches {launches[kind]} != {layers} x {steps}")
    else:
        per = rn.fused_launches_per_forward(50) * steps
        check(launches["fused_conv_stats"] == per,
              f"{key}: fused conv launches {launches['fused_conv_stats']} != {per}")


def _build_step(builder, loss_fn, params, batch, world: int, rank: int, work: str,
                **kwargs):
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=builder, device="cuda",
                        init_method=f"file://{work}/pg", world_size=world, rank=rank,
                        timeout_s=DIST_GROUP_TIMEOUT_S)
    step = autodist.build(loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT),
                          **kwargs)
    return autodist, step


def _stale_replay(params, log, k: int, names) -> dict:
    """The plain PS update driven by the synced gradients of K steps before
    (zeros for the first K): the parameters after each step."""
    tx = OptimizerSpec(*DIST_OPT).make()
    flat = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    leaves = [flat[n] for n in names]
    slots = tx.init(leaves)
    with torch.no_grad():
        for t in range(len(log)):
            grads = ([log[t - k][2][n] for n in names] if t >= k
                     else [torch.zeros_like(x) for x in leaves])
            for p, u in zip(leaves, tx.update(grads, slots, leaves)):
                p.add_(u.to(p.dtype))
    return flat


def _async_by_hand(spec, params, batch, pushes: int, workers: int, dev):
    """The round-robin schedule by hand with the port's step: each round's
    workers take gradients (``DistributedTrainStep.loss_and_grads``) at
    one snapshot, then apply in worker order with the port's optimizer."""
    from autodist_tpu_torch.kernel.lowering import TrainState

    step = _one_process_step(from_name("PS"), spec.loss_fn, params, batch, dev)
    tx = OptimizerSpec(*DIST_OPT).make()
    names = [n for n, t in flatten_params(params).items() if t.is_floating_point()]
    flat = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    slots = tx.init([flat[n] for n in names])
    losses, tick = [], pushes
    while tick > 0:
        snap = {n: t.clone().requires_grad_(t.is_floating_point()) for n, t in flat.items()}
        rounds = []
        for _ in range(min(workers, tick)):
            tick -= 1
            loss, _, grads = step.loss_and_grads(
                TrainState(0, unflatten_params(snap), None), batch)
            rounds.append((float(loss.detach()), dict(zip(names, grads))))
        for loss, grads in rounds:
            losses.append(loss)
            with torch.no_grad():
                ups = tx.update([grads[n] for n in names], slots, [flat[n] for n in names])
                for n, u in zip(names, ups):
                    flat[n] = flat[n] + u.to(flat[n].dtype)
    return losses, flat


def sync_rank(rank: int, world: int, work: str) -> int:
    """The sync_options phase's NCCL rank (see the module docstring)."""
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    bert = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    params = bert.init(SEED, device=dev)
    batch = bert.example_batch(TRAIN_BATCH, device=dev)
    rows = []
    base = dict(world=world, global_batch=TRAIN_BATCH, optimizer=DIST_OPT)

    # Plain AllReduce (no buckets): the steps the compressors are timed against.
    ad, step = _build_step(AllReduce(), bert.loss_fn, params, batch, world, rank, work)
    _, losses, plain_ms, launches, wire, _ = _sync_window(step, params, batch, SYNC_STEPS, dev)
    _check_run("AllReduce", "bert_base", losses, launches, wire,
               ad.plan.collectives_per_step(), SYNC_STEPS)
    rows.append(dict(base, model="bert_base", path="AllReduce", losses=losses,
                     ms_per_step=plain_ms, kernel_launches=launches, collectives=wire[-1]))
    del step
    for name in SYNC_COMPRESSORS:
        ad, step = _build_step(AllReduce(compressor=name), bert.loss_fn, params, batch, world,
                          rank, work)
        state, losses, ms, launches, wire, _ = _sync_window(step, params, batch,
                                                            SYNC_STEPS, dev)
        predicted = ad.plan.collectives_per_step()
        _check_run(name, "bert_base", losses, launches, wire, predicted, SYNC_STEPS)
        check(step.manual, f"{name}: the compressed step is not in the manual semantics")
        log = _capture_sync(step)
        state, _ = step(state, batch)                   # the checked step, not counted
        row = dict(base, model="bert_base", path=f"AllReduce({name})", losses=losses,
                   ms_per_step=ms, plain_ms_per_step=plain_ms, kernel_launches=launches,
                   collectives=wire[-1], predicted_wire=predicted,
                   check=_compressor_check(name, step, state, log))
        rows.append(row)
        del step, state, log
        torch.cuda.empty_cache()

    # Bounded staleness: PS(staleness=K) against the plain update driven by
    # the synced gradients of K steps before.
    ad, step = _build_step(from_name("PS", staleness=SYNC_STALENESS), bert.loss_fn, params, batch,
                      world, rank, work)
    log = _capture_sync(step)
    state, losses, ms, launches, wire, _ = _sync_window(step, params, batch,
                                                        SYNC_STALE_STEPS, dev)
    _check_run("PS(staleness)", "bert_base", losses, launches, wire,
               ad.plan.collectives_per_step(), SYNC_STALE_STEPS)
    check(losses[:SYNC_STALENESS + 1] == [losses[0]] * (SYNC_STALENESS + 1),
          f"PS(staleness): the first {SYNC_STALENESS} steps moved the params {losses}")
    names = [n for n, _ in step._floating(state.params)]
    replay = _stale_replay(params, log, SYNC_STALENESS, names)
    got = flatten_params(step.logical_params(state))
    stale_diff = max((got[n].float() - replay[n].float()).abs().max().item() for n in names)
    check(stale_diff == 0.0, f"PS(staleness): params differ from the delayed replay by "
          f"{stale_diff}")
    rows.append(dict(base, model="bert_base", path=f"PS(staleness={SYNC_STALENESS})",
                     losses=losses, ms_per_step=ms, kernel_launches=launches,
                     collectives=wire[-1], replay_max_diff=stale_diff,
                     buffer_bytes=sum(b.numel() * b.element_size()
                                      for b in state.stale_state.values())))
    del step, state, log, replay, got
    torch.cuda.empty_cache()

    # Host offload: ResNet-50 under PS, offloaded against resident.
    resnet = get_model_spec("resnet")
    rparams = resnet.init(SEED, device=dev)
    rbatch = resnet.example_batch(RESNET_BATCH, device=dev)
    runs = {}
    for offload in (False, True):
        ad, step = _build_step(from_name("PS"), resnet.loss_fn, rparams, rbatch, world, rank,
                          work, host_offload=offload)
        state, losses, ms, launches, wire, peak = _sync_window(step, rparams, rbatch,
                                                               SYNC_STEPS, dev)
        _check_run(f"PS(host_offload={offload})", "resnet50", losses, launches, wire,
                   ad.plan.collectives_per_step(), SYNC_STEPS)
        held = [t for n, t in flatten_params(state.params).items() if n in step.offloaded]
        slots = [t for key in ("mu", "nu") for i, t in enumerate(state.opt_state[key])
                 if held and i in step._offload_index(state.params)]
        check(not offload or (held and all(t.is_pinned() for t in held + slots)),
              "host offload: an offloaded leaf is not in pinned host memory between steps")
        runs[offload] = dict(losses=losses, ms=ms, peak=peak, launches=launches,
                             wire=wire[-1], between=torch.cuda.memory_allocated(dev),
                             offloaded_bytes=sum(t.numel() * t.element_size()
                                                 for t in held + slots),
                             slot_bytes=sum(t.numel() * t.element_size() for t in slots),
                             params={n: t.detach().cpu() for n, t in flatten_params(
                                 step.logical_params(state)).items()})
        del step, state, held, slots
        torch.cuda.empty_cache()
    diff = max((runs[True]["params"][n] - t).abs().max().item()
               for n, t in runs[False]["params"].items())
    check(diff == 0.0 and runs[True]["losses"] == runs[False]["losses"],
          f"host offload: differs from the resident step (param diff {diff})")
    # The slots come to the card only after the backward, so the step's peak
    # falls by about them; between steps all the offloaded bytes are off it.
    peak_saved = runs[False]["peak"] - runs[True]["peak"]
    held_saved = runs[False]["between"] - runs[True]["between"]
    slot_bytes, offloaded = runs[True]["slot_bytes"], runs[True]["offloaded_bytes"]
    check(OFFLOAD_SAVING[0] * slot_bytes <= peak_saved <= OFFLOAD_SAVING[1] * slot_bytes,
          f"host offload: peak fell by {peak_saved} bytes, not {OFFLOAD_SAVING} x the "
          f"{slot_bytes} bytes of optimizer slots")
    check(OFFLOAD_SAVING[0] * offloaded <= held_saved <= OFFLOAD_SAVING[1] * offloaded,
          f"host offload: memory between steps fell by {held_saved} bytes, not "
          f"{OFFLOAD_SAVING} x the {offloaded} bytes offloaded")
    rows.append(dict(world=world, global_batch=RESNET_BATCH, optimizer=DIST_OPT,
                     model="resnet50", path="PS(host_offload=True)",
                     losses=runs[True]["losses"], ms_per_step=runs[True]["ms"],
                     resident_ms_per_step=runs[False]["ms"],
                     kernel_launches=runs[True]["launches"], collectives=runs[True]["wire"],
                     offloaded_bytes=runs[True]["offloaded_bytes"], slot_bytes=slot_bytes,
                     copied_bytes_per_step=2 * runs[True]["offloaded_bytes"],
                     peak_bytes=runs[True]["peak"], resident_peak_bytes=runs[False]["peak"],
                     allocated_between_steps=runs[True]["between"],
                     resident_allocated_between_steps=runs[False]["between"],
                     bitwise_vs_resident=True))
    del runs, rparams, rbatch
    torch.cuda.empty_cache()

    # Asynchronous PS: 2 workers on this card. build() gives the threaded
    # trainer; the round-robin one is the same trainer built with that schedule.
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=from_name(
        "PS", sync=False, staleness=ASYNC_STALENESS), device="cuda",
        resource_spec=ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": ASYNC_WORKERS}]}),
        init_method=f"file://{work}/pg", world_size=world, rank=rank,
        timeout_s=DIST_GROUP_TIMEOUT_S)
    built = autodist.build(bert.loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT))
    check(isinstance(built, AsyncPSTrainer) and built.schedule == "threads"
          and built.n_workers == ASYNC_WORKERS, "sync=False not routed to the trainer")
    for schedule in ("round_robin", "threads"):
        trainer = built if schedule == "threads" else AsyncPSTrainer(
            built.loss_fn, built.tx, built.n_workers, staleness=built.staleness,
            schedule=schedule, has_aux=built.has_aux, device=built.device)
        state = trainer.init(params)
        calls = [0]

        def next_batch(tick):
            calls[0] += 1
            return batch

        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        state, m = trainer.run(state, next_batch, ASYNC_PUSHES)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / ASYNC_PUSHES * 1e3
        launches = _launch_counts()
        losses = m["loss"].tolist()
        _check_run(f"async {schedule}", "bert_base", losses, launches, [], None, calls[0])
        check(state.version == ASYNC_PUSHES == len(losses),
              f"async {schedule}: version {state.version}, pushes {len(losses)}")
        check(m["max_lag"] <= ASYNC_STALENESS, f"async {schedule}: lag {m['max_lag']} over "
              f"the bound {ASYNC_STALENESS}")
        row = dict(world=1, global_batch=TRAIN_BATCH, optimizer=DIST_OPT, model="bert_base",
                   path=f"PS(sync=False, staleness={ASYNC_STALENESS}), {schedule}",
                   workers=ASYNC_WORKERS, pushes=ASYNC_PUSHES, gradients=calls[0],
                   losses=losses, lags=m["lag"].tolist(), ms_per_push=ms,
                   kernel_launches=launches)
        if schedule == "round_robin":
            hand_losses, hand = _async_by_hand(bert, params, batch, ASYNC_PUSHES,
                                               ASYNC_WORKERS, dev)
            got = flatten_params(state.params)
            adiff = max((got[n].float() - t.float()).abs().max().item()
                        for n, t in hand.items())
            check(adiff == 0.0 and hand_losses == losses,
                  f"async round_robin: differs from the schedule by hand (param diff "
                  f"{adiff}, losses {losses} vs {hand_losses})")
            row["bitwise_vs_by_hand"] = True
            del hand
        rows.append(row)
        del trainer, state
        torch.cuda.empty_cache()
    del built
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def sync_options(card: str) -> list:
    """The sync_options phase: one NCCL rank on cuda:0 (a process of this
    script). Returns its rows."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--sync-rank", 1, work, env)[0]
    for row in rows:
        emit("sync_options", **row, ranks_seconds=time.perf_counter() - t0, card=card)
    return rows


# ------------------------------------------------------------------ crossover
def crossover_phase(card: str, dev) -> dict:
    """The H100 tables' rules on the card, and bert_base at 512 with dot and
    with flash: "auto" must resolve to flash there, and flash be faster."""
    seq = xo.flash_crossover_seq()
    timeline = xo.paged_crossover_timeline(SERVE_ROWS, H)
    # bert_base attends in bf16, the table's dtype; fp32 keeps the default.
    auto = tt.resolve_attention_impl("auto", TRAIN_SEQ, dev, torch.bfloat16)
    auto_fp32 = tt.resolve_attention_impl("auto", TRAIN_SEQ, dev, torch.float32)
    check(auto == "flash", f"auto at {TRAIN_SEQ} resolves to {auto} (crossover {seq})")
    check(auto_fp32 == "dot", f"fp32 auto at {TRAIN_SEQ} resolves to {auto_fp32}, not "
          f"the default {xo.DEFAULT_FLASH_CROSSOVER_SEQ}'s dot")
    paged = pa.resolve_impl("auto", dev, batch=SERVE_ROWS, table_pages=SERVE_TABLE_PAGES,
                            page_len=PAGE_LEN, heads=H)
    expect = "kernel" if SERVE_TABLE_PAGES * PAGE_LEN >= timeline else "gather"
    check(paged == expect, f"paged auto at the decode shape: {paged}, the table says {expect}")
    ms = {}
    for impl in ("dot", "flash"):
        spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl=impl)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(TRAIN_BATCH, device=dev)
        AutoDist.reset_default()
        step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
            spec.loss_fn, params, batch)
        box = {"state": step.init(params)}

        def one():
            box["state"], _ = step(box["state"], batch)

        ms[impl] = time_ms(one, groups=CROSSOVER_WINDOWS, per_group=CROSSOVER_STEPS)
        del step, box, params, batch
        torch.cuda.empty_cache()
    check(ms["flash"] < ms["dot"], f"flash {ms['flash']} ms not faster than dot {ms['dot']}")
    row = dict(flash_crossover_seq=seq, paged_crossover_timeline=timeline,
               auto_at_seq=auto, auto_at_seq_fp32=auto_fp32,
               paged_auto_at_decode=paged, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
               dot_ms_per_step=ms["dot"], flash_ms_per_step=ms["flash"],
               flash_speedup=ms["dot"] / ms["flash"], card=card)
    emit("crossover", **row)
    return row


# ------------------------------------------------------------ checkpoints
def _deterministic(rank: int):
    """This rank's device, with the deterministic settings of dist_train."""
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    return dev


def _dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files) / 1e6


def _ckpt_step(spec, params, batch, opt, clip, dev):
    AutoDist.reset_default()
    return AutoDist(strategy_builder=AllReduce(), device=dev).build(
        spec.loss_fn, params, batch, optimizer=OptimizerSpec(opt[0], dict(opt[1]),
                                                             clip_norm=clip))


def _run_losses(step, state, batch, n: int):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append(m["loss"])
    return state, [float(x) for x in metrics]


def ckpt_rank(rank: int, world: int, work: str) -> int:
    """checkpoint_train's process (see the module docstring)."""
    dev = _deterministic(rank)
    rows = []
    for key, name, overrides, batch_size, opt, clip in CKPT_MODELS:
        spec = get_model_spec(name, **overrides)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        reset_launches()
        runs = []
        for _ in range(2):
            step = _ckpt_step(spec, params, batch, opt, clip, dev)
            runs.append(_run_losses(step, step.init(params), batch, CKPT_STEPS)[1])
            del step
            torch.cuda.empty_cache()
        step = _ckpt_step(spec, params, batch, opt, clip, dev)
        state, first = _run_losses(step, step.init(params), batch, CKPT_SPLIT)
        saver = Saver(os.path.join(work, key))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        path = step.save(saver, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        async_path = step.save(saver, state, path=os.path.join(work, f"{key}-async",
                                                               f"ckpt-{CKPT_SPLIT}"),
                               block=False)
        async_call_ms = (time.perf_counter() - t0) * 1e3
        saver.wait()
        async_ms = (time.perf_counter() - t0) * 1e3
        check(Saver.read_metadata(async_path) == Saver.read_metadata(path),
              f"{key}: async checkpoint metadata differs")
        blocking = dict(flatten_with_names(Saver().restore(path)))
        for n, t in flatten_with_names(Saver().restore(async_path)):
            check(torch.equal(t, blocking[n]), f"{key}: async checkpoint {n} differs")
        del step, state, blocking
        torch.cuda.empty_cache()
        fresh = _ckpt_step(spec, params, batch, opt, clip, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state = fresh.init_or_restore(params, Saver(os.path.join(work, key)))
        torch.cuda.synchronize(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(state.step == CKPT_SPLIT and state.opt_state["count"] == CKPT_SPLIT,
              f"{key}: restored step {state.step}, count {state.opt_state['count']}")
        state, second = _run_losses(fresh, state, batch, CKPT_STEPS - CKPT_SPLIT)
        launches = {"fused_conv_stats": fcs.fused_matmul_stats.launches, **_launch_counts()}
        want = runs[0][CKPT_SPLIT:]
        if runs[0] == runs[1]:
            case = "bitwise"
            check(first + second == runs[0], f"{key}: resumed losses {first + second} != "
                  f"unbroken {runs[0]}")
            off = spread = 0.0
        else:
            case = "within the unbroken run's spread"
            spread = max(abs(a - b) for a, b in zip(runs[0][CKPT_SPLIT:],
                                                     runs[1][CKPT_SPLIT:]))
            off = max(abs(a - b) for a, b in zip(second, want))
            check(off <= spread, f"{key}: resumed losses off by {off} > spread {spread}")
        steps = 3 * CKPT_STEPS
        if key == "bert_base":
            layers = spec.config.num_layers
            for kind in ("fwd", "dkdv", "dq"):
                check(launches[kind] == layers * steps,
                      f"{key}: flash {kind} launches {launches[kind]} != {layers} x {steps}")
        else:
            per = rn.fused_launches_per_forward(50) * steps
            check(launches["fused_conv_stats"] == per,
                  f"{key}: fused conv launches {launches['fused_conv_stats']} != {per}")
        rows.append(dict(model=key, batch=batch_size, optimizer=opt, clip_norm=clip,
                         steps=CKPT_STEPS, split=CKPT_SPLIT, case=case,
                         unbroken=runs[0], unbroken_again=runs[1], resumed=first + second,
                         max_off=off, spread=spread, save_ms=save_ms,
                         async_call_ms=async_call_ms, async_total_ms=async_ms,
                         restore_ms=restore_ms, checkpoint_mb=_dir_mb(path),
                         entries=len(Saver.read_metadata(path)["entries"]),
                         kernel_launches=launches))
        del fresh, state, params, batch
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def checkpoint_train(card: str) -> list:
    """The checkpoint_train phase: one process of this script on cuda:0
    with deterministic algorithms. Returns its rows."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--ckpt-rank", 1, work, env)[0]
    for row in rows:
        emit("checkpoint_train", **row, process_seconds=time.perf_counter() - t0, card=card)
    return rows


def _holds_checkpoint(step, state, path: str) -> bool:
    """Every leaf of this rank's state equal, bitwise, to the checkpoint's
    region of it."""
    full = dict(flatten_with_names(Saver().restore(path)))
    for name, leaf, _ in step.checkpoint_leaves(state):
        if isinstance(leaf, int):
            if int(full[name]) != leaf:
                return False
            continue
        parts = ([(leaf.blocks[j], t) for j, t in leaf.local.items()]
                 if isinstance(leaf, ShardedLeaf) else [(None, leaf)])
        for region, t in parts:
            want = full[name]
            if region is not None:
                want = want[tuple(slice(a, b) for a, b in zip(*region))]
            if not torch.equal(t.detach().cpu(), want):
                return False
    return True


def _dist_checkpoint(key, step, state, spec, params, batch, work, rank, dev) -> dict:
    """dist_checkpoint: the Zero1 state saved by every rank restores into
    the one-process (unsharded) step bitwise, and that step's save restores
    into the Zero1 step bitwise."""
    path = step.save(Saver(os.path.join(work, f"zero1-{key}")), state)
    back = os.path.join(work, f"zero1-back-{key}")
    out = dict(entries=len(Saver.read_metadata(path)["entries"]), mb=_dir_mb(path))
    if rank == 0:
        one = _one_process_step(AllReduce(), spec.loss_fn, params, batch, dev)
        ostate = one.init_or_restore(params, Saver(os.path.dirname(path)))
        out["into_one_process_bitwise"] = _holds_checkpoint(one, ostate, path)
        check(out["into_one_process_bitwise"], f"{key}: Zero1 checkpoint restored into the "
              f"one-process step differs")
        one.save(Saver(back), ostate)
        del one, ostate
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    rstate = step.init_or_restore(params, Saver(back))
    out["back_into_zero1_bitwise"] = _holds_checkpoint(
        step, rstate, os.path.join(back, f"ckpt-{rstate.step}"))
    check(out["back_into_zero1_bitwise"], f"{key}: one-process checkpoint restored into "
          f"the Zero1 step differs")
    return out


def checkpoint_serve(card: str, dev) -> list:
    """The full-width transformer trained a few steps, saved, and served
    from its ckpt-N through AutoDist.build_inference, then through
    SpecDecodeEngine.build with a params-only draft checkpoint: the same
    streams as the same params served from memory."""
    spec = get_model_spec("transformer", max_seq_len=TRAIN_SEQ)
    cfg, dm = spec.config, tt.decode_model(spec.config)
    params = spec.init(SEED + 8, device=dev)
    batch = spec.example_batch(LM_BATCH, device=dev)
    AutoDist.reset_default()
    step = AutoDist(strategy_builder=AllReduce(), device=dev).build(spec.loss_fn, params, batch)
    state, _ = step.run(step.init(params), batch, CKPT_SERVE_STEPS)
    rng = np.random.default_rng(SEED + 8)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size)
               for i in range(CKPT_SERVE_REQUESTS)]
    kw = dict(n_slots=32, page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    rows = []
    with tempfile.TemporaryDirectory() as work:
        path = step.save(Saver(os.path.join(work, "train")), state)
        trained = step.logical_params(state)
        del step, state
        template = map_params(lambda t: torch.empty_like(t, device="meta"), trained)
        dcfg = get_model("transformer", num_layers=DRAFT_LAYERS)
        dparams = tt.init_params(dcfg, seed=SEED + 9, device=dev)
        Saver(os.path.join(work, "draft")).save(dparams, step=0)
        dtemplate = map_params(lambda t: torch.empty_like(t, device="meta"), dparams)
        for mode in ("plain", "spec"):
            AutoDist.reset_default()
            t0 = time.perf_counter()
            if mode == "plain":
                engine = AutoDist(device=dev).build_inference(
                    template, decode_model=dm, checkpoint=os.path.dirname(path),
                    n_slots=32, page_len=PAGE_LEN, prefill_chunk=PAGE_LEN)
                memory = InferenceEngine(trained, dm, **kw)
                draft_layers = 0
            else:
                engine = SpecDecodeEngine.build(
                    template, dtemplate, dm, tt.decode_model(dcfg), checkpoint=path,
                    draft_checkpoint=os.path.join(work, "draft"), spec_k=SPEC_K, **kw)
                memory = SpecDecodeEngine(trained, dm, dparams, tt.decode_model(dcfg),
                                          spec_k=SPEC_K, **kw)
                draft_layers = DRAFT_LAYERS
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            restored = flatten_params(engine.params)
            check(all(torch.equal(restored[n], t) for n, t in flatten_params(trained).items()),
                  f"checkpoint_serve {mode}: restored params differ from the trained ones")
            for e in (engine, memory):
                e.generate([1, 2, 3], 2)                       # warm-up, not counted
            got, snap, wall, launches, ran = _served(engine, prompts, f"ckpt {mode}",
                                                     cfg.num_layers, draft_layers)
            want = _served(memory, prompts, f"memory {mode}", cfg.num_layers,
                           draft_layers)[0]
            check(got == want, f"checkpoint_serve {mode}: "
                  f"{sum(a != b for a, b in zip(got, want))} streams differ from memory's")
            rows.append(dict(mode=mode, requests=len(prompts), max_new=MAX_NEW,
                             train_steps=CKPT_SERVE_STEPS, checkpoint_mb=_dir_mb(path),
                             build_with_restore_s=build_s, streams_equal=len(got),
                             kernel_launches=launches, programs=ran,
                             decode_tokens_per_s=(len(prompts) * (MAX_NEW - 1)) / wall,
                             card=card))
            emit("checkpoint_serve", **rows[-1])
            del engine, memory
            torch.cuda.empty_cache()
    return rows


def saved_model_phase(card: str, dev) -> dict:
    """bert_base's forward exported, loaded and run: bitwise equal to the
    eager forward, the flash forward kernel launched in the loaded program
    once a layer."""
    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ)
    cfg = spec.config
    params = spec.init(SEED, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, (EXPORT_BATCH, TRAIN_SEQ))).to(dev)

    def forward(p, t):
        return tt.forward(p, t, cfg)

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        SavedModelBuilder(forward).save(work, params, tokens)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = load_saved_model(work)
        load_s = time.perf_counter() - t0
        mb = _dir_mb(work)
    ops = [str(n.target) for n in serve.exported.graph.nodes
           if str(n.target).startswith("autodist_tpu_torch.")]
    check(ops.count("autodist_tpu_torch.flash_fwd.default") == cfg.num_layers,
          f"saved_model: the program calls {ops}")
    with torch.no_grad():
        eager = forward(params, tokens)
    torch.cuda.synchronize(dev)
    reset_launches()
    got = serve(tokens)
    torch.cuda.synchronize(dev)
    launches = _launch_counts()
    check(launches["fwd"] == cfg.num_layers,
          f"saved_model: flash forward launches {launches['fwd']} != {cfg.num_layers}")
    check(torch.equal(got, eager), f"saved_model: exported output differs from eager by "
          f"{(got - eager).abs().max().item()}")
    row = dict(model="bert_base", seq=TRAIN_SEQ, batch=EXPORT_BATCH, export_s=export_s,
               load_s=load_s, mb=mb, program_ops=len(ops), bitwise=True,
               kernel_launches=launches, card=card)
    emit("saved_model", **row)
    return row


# ------------------------------------------------------------ tp_train
def tp_rank(rank: int, world: int, work: str) -> int:
    """tp_train's process (see the module docstring)."""
    dev = _deterministic(rank)
    rows = []
    for key, name, overrides, batch_size, builder, axis, experts in TP_MODELS:
        spec = get_model_spec(name, **overrides)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        step = _one_process_step(AllReduce(), spec.loss_fn, params, batch, dev)
        state, plain_losses, plain_ms, _, _ = _train_window(step, params, batch, TP_STEPS,
                                                            dev)
        plain = flatten_params(step.logical_params(state))
        del step, state
        torch.cuda.empty_cache()
        AutoDist.reset_default()
        mesh = {"data": world, axis: 1}
        autodist = AutoDist(
            strategy_builder=from_name(builder), device="cuda",
            resource_spec=ResourceSpec(resource_dict={
                "nodes": [{"address": "localhost", "gpus": world}], "mesh": mesh}),
            mesh_axes=("data", axis), init_method=f"file://{work}/pg", world_size=world,
            rank=rank, timeout_s=DIST_GROUP_TIMEOUT_S)
        step = autodist.build(spec.loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT),
                              expert_names=experts)
        state, losses, ms, launches, wire = _train_window(step, params, batch, TP_STEPS, dev)
        logical = flatten_params(step.logical_params(state))
        predicted = autodist.plan.collectives_per_step()
        diff = max((logical[n].float() - t.float()).abs().max().item()
                   for n, t in plain.items())
        row = dict(model=key, config=overrides, strategy=builder, mesh=mesh, world=world,
                   global_batch=batch_size, steps=1 + TP_STEPS, optimizer=DIST_OPT,
                   losses=losses, ms_per_step=ms, plain_losses=plain_losses,
                   plain_ms_per_step=plain_ms, collectives=wire, predicted_wire=predicted,
                   kernel_launches=launches, max_param_diff=diff,
                   bitwise=diff == 0.0 and losses == plain_losses,
                   plan=autodist.plan.describe().splitlines()[:4])
        check(_wire(wire) == predicted, f"tp {key}: wire {wire} != the plan's {predicted}")
        check(row["bitwise"], f"tp {key}: {builder} on {mesh} not bitwise equal to the "
              f"one-process AllReduce step (param diff {diff})")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"tp {key}: losses {losses}")
        if spec.config.attention_impl == "flash":
            for kind in ("fwd", "dkdv", "dq"):
                check(launches[kind] == spec.config.num_layers * TP_STEPS,
                      f"tp {key}: flash {kind} launches {launches[kind]}")
        rows.append(row)
        del step, state, logical, plain, params
        torch.cuda.empty_cache()
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def tp_train(card: str) -> list:
    """The tp_train phase: one NCCL rank on cuda:0, with deterministic
    algorithms. Returns its rows."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--tp-rank", 1, work, env)[0]
    for row in rows:
        emit("tp_train", **row, process_seconds=time.perf_counter() - t0, card=card)
    return rows

# ------------------------------------------------- CNNs on a model axis
def _dicts_by_id(tree, prefix: str = "") -> dict:
    """``{id(node): path}`` of every dict of a params tree."""
    out = {id(tree): prefix}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dicts_by_id(v, f"{prefix}/{k}" if prefix else k))
    return out


def _tp_plan(degree: int, dev):
    """The plan of ResNet-50 (PUBLISHED, batch 128) under TensorParallel at
    data 1 x model ``degree``, on a logical mesh."""
    from autodist_tpu_torch.strategy import explain as ex

    model, overrides, batch, _ = PUBLISHED["resnet50"]
    item = ex.model_item_for(model, batch, dev, **overrides)
    mesh = {"data": 1, "model": degree}
    rs = ResourceSpec(resource_dict={"nodes": [{"address": "localhost", "gpus": degree}],
                                     "mesh": mesh})
    strategy = StrategyCompiler(item).compile(from_name("TensorParallel").build(item, rs))
    return GraphTransformer(strategy, item, Mesh.logical(mesh)).transform()


def _split_dims(plan) -> dict:
    """``{name: dim}`` of the variables a plan splits over the model axis."""
    return {n: plan.rendering(n)[1] for n in plan.var_plans
            if plan.rendering(n)[0] == "partitioned"}


def split_conv_shapes(degree: int, dev) -> dict:
    """``{(M, K, N): launches a forward}`` of the fused conv-stats kernel on
    rank 0 of ResNet-50 (PUBLISHED, batch 128) under TensorParallel at data
    1 x model ``degree``: every 1x1 conv's ``(M, K)`` from a forward on meta
    tensors, ``N`` the columns ``layers.fused_block`` gives rank 0 for the
    plan's split of the kernel (a block under a ``cout`` split, or under a
    ``cin`` split the gathered kernel's column block; ROADMAP.md, Queue 3).
    ResNet-50's widths divide by 2 and 4, so every rank's shapes are these."""
    split = _split_dims(_tp_plan(degree, dev))
    model, overrides, batch, _ = PUBLISHED["resnet50"]
    spec = get_model_spec(model, **overrides)
    params = map_params(lambda t: t.to("meta"), spec.init(SEED, device=dev))
    names = _dicts_by_id(params)
    size = overrides["image_size"]
    shapes: dict = {}
    inside: list = []
    plain_cb, plain_op = L.conv_batchnorm, fcs.fused_matmul_stats

    def conv_bn(conv_p, bn_p, x, stride=1, *, compute_dtype=None):
        inside.append(names[id(conv_p)] + "/kernel")
        try:
            return plain_cb(conv_p, bn_p, x, stride, compute_dtype=compute_dtype)
        finally:
            inside.pop()

    def op(x, w):
        _, (lo, hi) = L.fused_block(split.get(inside[-1]), w.shape[1], 0, degree)
        key = (x.shape[0], x.shape[1], hi - lo)
        shapes[key] = shapes.get(key, 0) + 1
        return plain_op(x, w)

    L.conv_batchnorm, fcs.fused_matmul_stats = conv_bn, op
    try:
        with torch.no_grad():
            spec.apply(params, torch.empty((batch, size, size, 3), device="meta"))
    finally:
        L.conv_batchnorm, fcs.fused_matmul_stats = plain_cb, plain_op
    return shapes


def conv_split_shapes(split_shapes: dict, gen, dev) -> list:
    """The conv_split_shapes phase (see the module docstring)."""
    t0 = time.perf_counter()
    rows = []
    for degree, shapes in split_shapes.items():
        check(sum(shapes.values()) == rn.fused_launches_per_forward(50),
              f"conv_split_shapes model {degree}: {sum(shapes.values())} launches a forward")
        model_rows = [conv_stats_case(*shape, torch.bfloat16, gen, dev, launches,
                                      f"resnet50/model{degree}")
                      for shape, launches in sorted(shapes.items())]
        emit("conv_stats_forward", model=f"resnet50/model{degree}",
             **conv_forward_totals(model_rows))
        rows += model_rows
    emit("conv_split_shapes", shapes=len(rows), seconds=time.perf_counter() - t0,
         max_abs_err=max(r["max_abs_err"] for r in rows))
    return rows


def _tpm_inputs(model: str):
    """(loss, params, batch) of a tp_models_rehearsal model at its toy
    width, from the seed, on the CPU (fp32 forwards)."""
    from autodist_tpu_torch.models import densenet, inception

    f32, cpu = torch.float32, torch.device("cpu")
    cnn = {"resnet": (lambda seed: rn.init_params(seed, 18, 10, width=8, device=cpu),
                      lambda p, x: rn.forward(p, x, 18, dtype=f32)),
           "vgg": (lambda seed: vgg.init_params(seed, 11, 10, 32, device=cpu),
                   lambda p, x: vgg.forward(p, x, 11, dtype=f32)),
           "densenet": (lambda seed: densenet.init_params(seed, 121, 10, blocks=(2, 2),
                                                          growth=8, device=cpu),
                        lambda p, x: densenet.forward(p, x, 121, dtype=f32, blocks=(2, 2))),
           "inception": (lambda seed: inception.init_params(seed, 10, width=1 / 16,
                                                            device=cpu),
                         lambda p, x: inception.forward(p, x, dtype=f32))}
    if model in cnn:
        init, forward = cnn[model]
        spec = get_model_spec("resnet", depth=18, image_size=32, num_classes=10)
        return ((lambda p, b: L.softmax_xent(forward(p, b["images"]), b["labels"])),
                init(SEED), spec.example_batch(8, device=cpu))
    if model == "lstm_lm":
        o = TPM_LSTM
        spec = get_model_spec("lstm_lm", **o)

        def loss(p, b):
            t = b["tokens"]
            return L.softmax_xent(lstm_lm.forward(p, t[:, :-1], o["num_layers"], o["hidden"],
                                                  dtype=f32), t[:, 1:])
        gen = torch.Generator().manual_seed(SEED)
        tokens = torch.randint(0, o["vocab_size"], (8, o["seq_len"] + 1), generator=gen)
        return loss, spec.init(SEED, device=cpu), {"tokens": tokens}
    spec = get_model_spec(model, **(TPM_NCF if model == "ncf" else TPM_LM))
    return spec.loss_fn, spec.init(SEED, device=cpu), spec.example_batch(8, device=cpu)


def _tpm_opt(cid: str, model: str) -> tuple:
    """A tp_models_rehearsal case's ``OptimizerSpec`` arguments."""
    return ("sgd", {"learning_rate": TPM_CNN_LR.get(model, REHEARSAL_LR)},
            TPM_CLIP if "clip" in cid else None)


def tp_models_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of tp_models_rehearsal."""
    torch.set_num_threads(1)
    pg.join(torch.device("cpu"), f"file://{work}/pg", world, rank, DIST_GROUP_TIMEOUT_S)
    out = {}
    for cid, model, builder, mesh, steps in TPM_CASES:
        loss, params, batch = _tpm_inputs(model)
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=from_name(builder), device="cpu",
                            mesh_axes=tuple(mesh),
                            resource_spec=ResourceSpec(resource_dict={"nodes": [
                                {"address": "localhost", "gpus": world, "chief": True}],
                                "mesh": mesh}))
        step = autodist.build(loss, params, batch, optimizer=OptimizerSpec(*_tpm_opt(cid, model)))
        state, metrics = step.run(step.init(params), batch, steps)
        plan = autodist.plan
        out[cid] = {"losses": metrics["loss"].tolist(),
                    "params": flatten_params(step.logical_params(state)),
                    "split": sorted(n for n in plan.var_plans
                                    if plan.rendering(n)[0] in ("partitioned", "expert"))}
    pg.leave()
    # The tensors go through torch.save: VGG's 19M parameters as JSON take
    # a minute.
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump({"saved": f"rank{rank}.pt"}, f)
    return 0


def _tpm_one_process(cid, model, steps, batch_order=None):
    """(losses, flat params, flat start) of the one-process AllReduce step
    on the CPU; ``batch_order`` reorders the batch's rows first."""
    loss, params, batch = _tpm_inputs(model)
    if batch_order is not None:
        batch = {k: v[batch_order] for k, v in batch.items()}
    step = _one_process_step(AllReduce(), loss, params, batch, torch.device("cpu"),
                             _tpm_opt(cid, model))
    state, metrics = step.run(step.init(params), batch, steps)
    return (metrics["loss"].tolist(), flatten_params(step.logical_params(state)),
            flatten_params(params))


def tp_models_rehearsal() -> dict:
    """4 gloo ranks on the CPU against one process (see the module docstring)."""
    t0 = time.perf_counter()
    cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        procs = _start_ranks("--tp-models-cpu-rank", REHEARSAL_RANKS, work, cpu_env)
        # The one-process steps (and, for a CNN, the same on each data
        # rank's rows reversed) while the ranks run.
        rows = torch.arange(8).reshape(2, -1).flip(1).reshape(-1)
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, (os.cpu_count() or 8) - REHEARSAL_RANKS))
        try:
            refs = {cid: (_tpm_one_process(cid, model, steps),
                          _tpm_one_process(cid, model, steps, rows)
                          if model in TPM_CNN_LR else None)
                    for cid, model, _, _, steps in TPM_CASES}
        except BaseException:
            for proc in procs:
                proc.kill()
                proc.wait()
            raise
        finally:
            torch.set_num_threads(threads)
        ranks = [torch.load(os.path.join(work, r["saved"]), weights_only=False)
                 for r in _join_ranks("--tp-models-cpu-rank", procs, work)]
    cases = {}
    for cid, model, builder, mesh, steps in TPM_CASES:
        (losses, want, start), reordered = refs[cid]
        got = ranks[0][cid]
        check(bool(got["split"]) == (model != "resnet" or "expert" not in mesh),
              f"tp_models rehearsal {cid}: split variables {got['split'][:4]}")
        for r, res in enumerate(ranks[1:], 1):
            check(all(torch.equal(t, got["params"][n]) for n, t in res[cid]["params"].items()),
                  f"tp_models rehearsal {cid}: rank {r}'s params differ from rank 0's")
        if reordered is not None:
            slosses, spread, _ = reordered
            err, moved = (_update_rel(start, got["params"], want),
                          _update_rel(start, spread, want))
            bound = max(TPM_UPDATE_RTOL, 2 * moved)
            check(err <= bound and abs(got["losses"][0] - losses[0]) <= max(
                REHEARSAL_RTOL * abs(losses[0]), 2 * abs(slosses[0] - losses[0])),
                  f"tp_models rehearsal {cid}: update {err} vs {bound}, losses "
                  f"{got['losses']} vs {losses}")
            cases[cid] = dict(update_rel_l2=err, bound=bound, losses=got["losses"])
            continue
        worst = max((got["params"][n] - t).abs().max().item() for n, t in want.items())
        check(all(torch.allclose(got["params"][n], t, rtol=REHEARSAL_RTOL,
                                 atol=REHEARSAL_ATOL) for n, t in want.items())
              and torch.allclose(torch.tensor(got["losses"]), torch.tensor(losses),
                                 rtol=REHEARSAL_RTOL),
              f"tp_models rehearsal {cid}: differs from one process by {worst}")
        cases[cid] = dict(max_abs_diff=worst, losses=got["losses"])
    row = dict(note="gloo on the CPU: a rehearsal, not a card result", ranks=REHEARSAL_RANKS,
               torch=torch.__version__, cases=cases, seconds=time.perf_counter() - t0)
    emit("tp_models_rehearsal", **row)
    return row


def _resnet_fp32_loss(depth: int):
    """ResNet's loss with an fp32 forward (the zoo's is bf16)."""
    return lambda p, b: L.softmax_xent(rn.forward(p, b["images"], depth, dtype=torch.float32),
                                       b["labels"])


def _one_sgd_step(step, params, batch) -> dict:
    """The flat logical params after one step of ``step`` from ``params``."""
    state, _ = step(step.init(params), batch)
    return flatten_params(step.logical_params(state))


def _placed_run(loss_fn, params, batch, dims, placements, dev) -> dict:
    """A model's loss and gradients with every variable a ``DTensor`` on a
    one-rank mesh of ``dims`` placed as ``placements(mesh, name)`` says
    (the batch replicated), against the plain ones: whether the loss and
    every gradient are bitwise equal, and the kernels' launches in the
    placed run."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from autodist_tpu_torch.utils.placement import placement_list

    def loss_and_grads(p, b):
        p = map_params(lambda t: t.detach().requires_grad_(t.is_floating_point()), p)
        leaves = [t for t in flatten_params(p).values() if t.requires_grad]
        loss = loss_fn(p, b)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]

    want, gwant = loss_and_grads(params, batch)
    mesh = DeviceMesh(dev.type, torch.zeros([1] * len(dims), dtype=torch.int),
                      mesh_dim_names=dims)
    placed = unflatten_params({n: DTensor.from_local(t, mesh, placements(mesh, n),
                                                     run_check=False)
                               for n, t in flatten_params(params).items()})
    rep = placement_list(mesh, None, Replicate())
    dbatch = {k: DTensor.from_local(v, mesh, rep, run_check=False) for k, v in batch.items()}
    reset_launches()
    with implicit_replication():
        got, ggot = loss_and_grads(placed, dbatch)
    torch.cuda.synchronize(dev)
    differ = [i for i, (a, b) in enumerate(zip(ggot, gwant)) if not torch.equal(a, b)]
    worst = max([((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(
        1e-30)).item() for a, b in (zip([ggot[i] for i in differ], [gwant[i] for i in differ]))]
        or [0.0])
    names = [n for n, t in flatten_params(params).items() if t.is_floating_point()]
    return dict(loss=float(got), plain_loss=float(want), grads=len(gwant),
                grads_differ=len(differ), worst_grad_rel=worst,
                differ=[names[i] for i in differ][:8],
                kernel_launches={"fused_conv_stats": fcs.fused_matmul_stats.launches,
                                 **_launch_counts()},
                bitwise=bool(torch.equal(got, want)) and not differ)


def _tp_cnn_placed(spec, params, batch, dev) -> dict:
    """tp_cnn at one rank: ResNet-50's loss and gradients with every
    variable placed as TensorParallel's plan at model TP_CNN_PLACED renders
    it (``Shard(dim)`` a split one, ``Replicate`` else) on a one-rank model
    mesh, against the plain ones (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    split = _split_dims(_tp_plan(TP_CNN_PLACED, dev))
    flat = flatten_params(params)
    routes = collections.Counter(L.fused_block(split.get(n), t.shape[3], 0, 1)[0]
                                 for n, t in flat.items()
                                 if t.dim() == 4 and tuple(t.shape[:2]) == (1, 1))
    run = _placed_run(spec.loss_fn, params, batch, ("model",),
                      lambda mesh, n: [Shard(split[n])] if n in split else [Replicate()], dev)
    return dict(model_degree=TP_CNN_PLACED, split_vars=len(split), fused_routes=dict(routes),
                launches=run["kernel_launches"]["fused_conv_stats"], loss=run["loss"],
                plain_loss=run["plain_loss"], grads_differ=run["grads_differ"],
                bitwise=run["bitwise"])


def tp_cnn_rank(rank: int, world: int, work: str) -> int:
    """tp_cnn's process (see the module docstring)."""
    dev = _deterministic(rank)
    model, overrides, batch_size, _ = PUBLISHED["resnet50"]
    spec = get_model_spec(model, **overrides)
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    step = _one_process_step(AllReduce(), spec.loss_fn, params, batch, dev)
    state, plain_losses, plain_ms, _, _ = _train_window(step, params, batch, TP_CNN_STEPS, dev)
    plain = flatten_params(step.logical_params(state))
    del step, state
    fp32_loss = _resnet_fp32_loss(overrides["depth"])
    if world > 1:
        # The one-process fp32 SGD step, and the same with the rows reversed.
        fp32 = [_one_sgd_step(_one_process_step(AllReduce(), fp32_loss, params, b, dev,
                                                TP_CNN_SGD), params, b)
                for b in (batch, {k: v.flip(0) for k, v in batch.items()})]
    torch.cuda.empty_cache()
    AutoDist.reset_default()
    mesh = {"data": 1, "model": world}
    autodist = AutoDist(
        strategy_builder=from_name("TensorParallel"), device="cuda",
        resource_spec=ResourceSpec(resource_dict={
            "nodes": [{"address": "localhost", "gpus": world}], "mesh": mesh}),
        mesh_axes=tuple(mesh), init_method=f"file://{work}/pg", world_size=world,
        rank=rank, timeout_s=DIST_GROUP_TIMEOUT_S)
    step = autodist.build(spec.loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT))
    state, losses, ms, launches, wire = _train_window(step, params, batch, TP_CNN_STEPS, dev)
    logical = flatten_params(step.logical_params(state))
    update_rel = _update_rel(params, logical, plain)
    plan = autodist.plan
    row = dict(model="resnet50", config=overrides, strategy="TensorParallel", mesh=mesh,
               world=world, global_batch=batch_size, steps=1 + TP_CNN_STEPS,
               optimizer=DIST_OPT, losses=losses, ms_per_step=ms,
               images_per_s=batch_size / ms * 1e3, plain_losses=plain_losses,
               plain_ms_per_step=plain_ms, collectives=wire,
               predicted_wire=plan.collectives_per_step(), kernel_launches=launches,
               update_rel_l2=update_rel,
               bitwise=update_rel == 0.0 and losses == plain_losses,
               split_vars=len(_split_dims(plan)))
    del step, state
    torch.cuda.empty_cache()
    if world == 1:
        row["placed"] = _tp_cnn_placed(spec, params, batch, dev)
    else:
        got = _one_sgd_step(autodist.build(fp32_loss, params, batch,
                                           optimizer=OptimizerSpec(*TP_CNN_SGD)), params, batch)
        spread = _update_rel(params, fp32[1], fp32[0])
        row["fp32_sgd"] = dict(optimizer=TP_CNN_SGD,
                               update_rel_l2=_update_rel(params, got, fp32[0]),
                               reversed_rows_update_rel_l2=spread,
                               bound=max(TP_CNN_UPDATE_RTOL, 2 * spread))
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(row, f)
    return 0


def tp_cnn(card: str) -> dict:
    """The tp_cnn phase (see the module docstring). Returns rank 0's row."""
    torch.cuda.empty_cache()
    world = _pow2_ranks()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        row = _spawn_ranks("--tp-cnn-rank", world, work, env)[0]
    emit("tp_cnn", **row, process_seconds=time.perf_counter() - t0, card=card)
    losses = row["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"tp_cnn: losses {losses}")
    check(_wire(row["collectives"]) == row["predicted_wire"],
          f"tp_cnn: wire {row['collectives']} != the plan's {row['predicted_wire']}")
    check(row["kernel_launches"]["fused_conv_stats"] ==
          rn.fused_launches_per_forward(50) * TP_CNN_STEPS,
          f"tp_cnn: fused launches {row['kernel_launches']['fused_conv_stats']}")
    if row["world"] == 1:
        check(row["bitwise"], f"tp_cnn: not bitwise equal to the one-process AllReduce step "
              f"(update rel L2 {row['update_rel_l2']})")
        placed = row["placed"]
        check(placed["bitwise"] and placed["launches"] == rn.fused_launches_per_forward(50)
              and all(placed["fused_routes"].get(r) for r in ("column", "row")),
              f"tp_cnn: placed on a one-rank model mesh {placed}")
    else:
        sgd = row["fp32_sgd"]
        check(row["split_vars"] > 0 and all(
            abs(a - b) <= DIST_LOSS_RTOL["resnet50"] * abs(b)
            for a, b in zip(losses, row["plain_losses"])),
              f"tp_cnn: losses {losses} vs one process {row['plain_losses']}")
        check(sgd["update_rel_l2"] <= sgd["bound"], f"tp_cnn: fp32 SGD update {sgd}")
    return row


def _builder_name(strategy, item, spec) -> str:
    """The slate name whose builder gives ``strategy``'s JSON (id and path
    aside), first in slate order."""
    from autodist_tpu_torch.strategy.cost_model import candidate_slate

    def key(s):
        d = s.to_json()
        d["id"] = d["path"] = ""
        return json.dumps(d, sort_keys=True)

    want = key(strategy)
    for name, builder in candidate_slate(full=True):
        if key(StrategyCompiler(item).compile(builder.build(item, spec))) == want:
            return name
    raise RuntimeError("no slate builder gives this strategy")


def auto_plan(card: str, dev) -> list:
    """The auto_plan phase (see the module docstring)."""
    from autodist_tpu_torch.strategy import Auto, Parallax, RandomAxisPartitionAR
    from autodist_tpu_torch.strategy import explain as ex
    from autodist_tpu_torch.strategy.cost_model import candidate_slate

    local = ResourceSpec.from_local_devices(dev)
    node = local.gpu.to_dict()
    emit("auto_plan_node", node_model=node, hbm_bytes=local.gpu.hbm_bytes,
         hbm_bandwidth_bytes=local.gpu.hbm_bandwidth_bytes,
         intra_node_gbps=local.gpu.intra_node_gbps, card=card)
    clusters = {
        "this card": local,
        f"{AUTO_NODE_GPUS}-GPU node": ResourceSpec(resource_dict={
            "nodes": [{"address": "localhost", "gpus": AUTO_NODE_GPUS}], "gpu": node}),
        f"{AUTO_NODES} nodes x {AUTO_NODE_GPUS}": ResourceSpec(resource_dict={
            "nodes": [{"address": f"10.0.0.{i}", "gpus": AUTO_NODE_GPUS, "chief": i == 1}
                      for i in range(1, AUTO_NODES + 1)], "gpu": node})}
    # RandomAxisPartitionAR draws its axes: seeded, so the card's table and
    # the CPU's compare.
    slate = [(n, RandomAxisPartitionAR(seed=SEED) if n == "RandomAxisPartitionAR" else b)
             for n, b in candidate_slate(full=True)]
    rows = []
    for key, model, overrides, batch in AUTO_MODELS:
        item = ex.model_item_for(model, batch, dev, **overrides)
        cpu_item = ex.model_item_for(model, batch, "cpu", **overrides)
        for cname, rs in clusters.items():
            out = io.StringIO()
            ranked = ex.explain(item, rs, candidates=slate, out=out)
            print(f"auto_plan {key} on {cname}:{out.getvalue()}", flush=True)
            cpu_ranked = ex.explain(cpu_item, ResourceSpec(resource_dict=rs.to_dict()),
                                    candidates=slate, out=io.StringIO())
            check([(n, c.total_s) for n, c in ranked] == [(n, c.total_s)
                                                          for n, c in cpu_ranked],
                  f"auto_plan {key} on {cname}: the card's ranking differs from the CPU's")
            auto = Auto().build(item, rs)
            chosen = _builder_name(StrategyCompiler(item).compile(auto), item, rs)
            if key in AUTO_SPARSE:
                check(chosen == "Parallax" and json.dumps(auto.to_json()["node_config"]) ==
                      json.dumps(Parallax().build(item, rs).to_json()["node_config"]),
                      f"auto_plan {key} on {cname}: Auto chose {chosen}, not Parallax")
            recommended = next(line for line in out.getvalue().splitlines()
                               if line.startswith("recommended:"))
            row = dict(model=key, cluster=cname, batch=batch, auto=chosen,
                       recommended=recommended,
                       ranking=[(n, c.total_s * 1e3, c.per_chip_bytes / 1e9, c.feasible)
                                for n, c in ranked], card=card)
            emit("auto_plan", **row)
            rows.append(row)
        del item, cpu_item
        torch.cuda.empty_cache()
    return rows


def auto_rank(rank: int, world: int, work: str) -> int:
    """auto_train's process (see the module docstring)."""
    from autodist_tpu_torch.strategy.cost_model import candidate_slate

    dev = _deterministic(rank)
    rows = []
    for key, model, overrides, batch_size in AUTO_TRAIN:
        spec = get_model_spec(model, **overrides)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        runs, chosen = {}, None
        for label in ("Auto", "named"):
            AutoDist.reset_default()
            builder = "Auto" if label == "Auto" else dict(candidate_slate(full=True))[chosen]
            autodist = AutoDist(strategy_builder=builder,
                                device="cuda", init_method=f"file://{work}/pg",
                                world_size=world, rank=rank, timeout_s=DIST_GROUP_TIMEOUT_S)
            step = autodist.build(spec.loss_fn, params, batch,
                                  optimizer=OptimizerSpec(*DIST_OPT),
                                  sparse_names=spec.sparse_names)
            state, losses, ms, launches, wire = _train_window(step, params, batch,
                                                              AUTO_STEPS, dev)
            strategy = autodist.strategy.to_json()
            strategy["id"] = strategy["path"] = ""
            if label == "Auto":
                chosen = _builder_name(autodist.strategy, autodist.model_item,
                                       autodist.resource_spec)
            runs[label] = dict(losses=losses, ms_per_step=ms, kernel_launches=launches,
                               strategy=json.dumps(strategy, sort_keys=True),
                               params=flatten_params(step.logical_params(state)))
            del step, state
            torch.cuda.empty_cache()
        auto, named = runs["Auto"], runs["named"]
        diff = max((auto["params"][n].float() - t.float()).abs().max().item()
                   for n, t in named["params"].items())
        row = dict(model=key, config=overrides, batch=batch_size, steps=1 + AUTO_STEPS,
                   optimizer=DIST_OPT, world=world, chosen=chosen,
                   losses=auto["losses"], named_losses=named["losses"],
                   ms_per_step=auto["ms_per_step"], named_ms_per_step=named["ms_per_step"],
                   kernel_launches=auto["kernel_launches"],
                   named_kernel_launches=named["kernel_launches"], max_param_diff=diff,
                   bitwise=diff == 0.0 and auto["losses"] == named["losses"])
        check(auto["strategy"] == named["strategy"], f"auto {key}: Auto's strategy is not "
              f"{chosen}'s")
        check(all(np.isfinite(auto["losses"])), f"auto {key}: losses {auto['losses']}")
        check(row["bitwise"], f"auto {key}: not bitwise equal to {chosen} (param diff {diff})")
        if spec.config is not None and getattr(spec.config, "attention_impl", "") == "flash":
            for run in (auto, named):
                for kind in ("fwd", "dkdv", "dq"):
                    check(run["kernel_launches"][kind] == spec.config.num_layers * AUTO_STEPS,
                          f"auto {key}: flash {kind} launches {run['kernel_launches'][kind]}")
        rows.append(row)
        del params, runs, auto, named
        torch.cuda.empty_cache()
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def auto_train(card: str) -> list:
    """The auto_train phase: one NCCL rank on cuda:0. Returns its rows."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--auto-rank", 1, work, env)[0]
    for row in rows:
        emit("auto_train", **row, process_seconds=time.perf_counter() - t0, card=card)
    return rows


def tune_phase(card: str, dev) -> dict:
    """The tune phase (see the module docstring)."""
    from autodist_tpu_torch import api
    from autodist_tpu_torch.strategy.cost_model import candidate_slate

    key, model, overrides, batch_size = AUTO_MODELS[0]
    spec = get_model_spec(model, **overrides)
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(device=dev)
    slate = candidate_slate(include_sparse=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calibration.json")
        reset_launches()
        t0 = time.perf_counter()
        autodist.tune(spec.loss_fn, params, batch, candidates=slate, window=TUNE_WINDOW,
                      optimizer=OptimizerSpec(*DIST_OPT), calibration_path=path)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        written = os.path.exists(path)
    rec = autodist.last_tune_results
    calib = rec["calibration"]
    table = {name: dict(measured_ms=row["measured_s"] * 1e3,
                        predicted_ms=row["predicted_s"] * 1e3,
                        calibrated_ms=(calib.base_s + calib.scale * row["predicted_s"]) * 1e3)
             for name, row in rec["table"].items()}
    ran = [n for n, dt in rec["measured"].items() if np.isfinite(dt)]
    row = dict(model=key, batch=batch_size, window=TUNE_WINDOW, candidates=[n for n, _ in slate],
               table=table, selected=rec["selected"],
               calibration=dict(base_ms=calib.base_s * 1e3, scale=calib.scale,
                                device=calib.device, n_points=calib.n_points),
               calibration_written=written, seconds=seconds, kernel_launches=launches,
               card=card)
    emit("tune", **row)
    check(written, "tune: the calibration was not written")
    check(len(ran) == len(slate), f"tune: candidates failed: {rec['measured']}")
    check(rec["selected"] == min(ran, key=rec["measured"].get), "tune: not the fastest")
    steps = len(ran) * (1 + api._TUNE_TRIAL_WINDOWS) * TUNE_WINDOW
    for kind in ("fwd", "dkdv", "dq"):
        check(launches[kind] == spec.config.num_layers * steps,
              f"tune: flash {kind} launches {launches[kind]} != "
              f"{spec.config.num_layers} x {steps}")
    del autodist, params, batch
    AutoDist.reset_default()
    torch.cuda.empty_cache()
    return row


def _sparse_inputs(model: str, overrides: dict, batch_size: int):
    """(loss, params, batch) of a sparse_rehearsal case on the CPU."""
    if model == "embed":
        vocab, edim, _ = SPARSE_EMBED
        gen = torch.Generator().manual_seed(SEED)
        params = {"embedding": torch.randn(vocab, edim, generator=gen),
                  "w": torch.randn(edim, 1, generator=gen)}
        batch = (torch.randint(0, vocab, (batch_size,), generator=gen),
                 torch.randn(batch_size, generator=gen))

        def loss(p, b):
            ids, y = b
            return torch.mean(((p["embedding"][ids] @ p["w"]).squeeze(-1) - y) ** 2)
        return loss, params, batch
    spec = get_model_spec(model, **overrides)
    params = spec.init(SEED, device="cpu")
    batch = spec.example_batch(batch_size, device="cpu")
    if model == "lstm_lm":
        gen = torch.Generator().manual_seed(SEED)
        batch = {"tokens": torch.randint(0, overrides["vocab_size"], batch["tokens"].shape,
                                         generator=gen, dtype=torch.int32)}

        def loss(p, b):          # in fp32, as the one-process comparison needs
            t = b["tokens"]
            return L.softmax_xent(lstm_lm.forward(p, t[:, :-1], overrides["num_layers"],
                                                  overrides["hidden"], dtype=torch.float32),
                                  t[:, 1:])
        return loss, params, batch
    return spec.loss_fn, params, batch


def sparse_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of the sparse rehearsal."""
    torch.set_num_threads(1)
    out = {}
    for cid, model, builder, overrides, batch_size in SPARSE_CASES:
        loss, params, batch = _sparse_inputs(model, overrides, batch_size)
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=from_name(builder), device="cpu",
                            resource_spec=ResourceSpec(resource_dict={"nodes": [
                                {"address": "localhost", "gpus": world}]}),
                            init_method=f"file://{work}/pg", world_size=world, rank=rank,
                            timeout_s=DIST_GROUP_TIMEOUT_S)
        step = autodist.build(loss, params, batch, optimizer=OptimizerSpec(*DIST_OPT))
        state, moved = step.init(params), []
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
            moved.append({p: step.last_bytes.get(p, {}) for p in SPARSE_WIRE
                          if p in step.last_bytes})
        out[cid] = {
            "params": {n: t.tolist() for n, t in flatten_params(
                step.logical_params(state)).items()},
            "bytes": moved, "predicted": step.predicted_bytes(state, batch),
            "largest": {p: dict(k) for p, k in step.coll.largest.items()
                        if p not in ("init", "view")},
            "renderings": {n: autodist.plan.rendering(n) for n in autodist.plan.var_plans},
            "tables": {n: p.var.size * 4 for n, p in autodist.plan.var_plans.items()
                       if p.var.sparse_update}}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def sparse_rehearsal() -> dict:
    """4 gloo ranks on the CPU: the touched-rows wire against its
    prediction, the quarter-table bar and the one-process step."""
    t0 = time.perf_counter()
    cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--sparse-cpu-rank", REHEARSAL_RANKS, work, cpu_env)
    cases = {}
    for cid, model, builder, overrides, batch_size in SPARSE_CASES:
        loss, params, batch = _sparse_inputs(model, overrides, batch_size)
        step = _one_process_step(from_name(builder), loss, params, batch, torch.device("cpu"))
        state = step.init(params)
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
        want = flatten_params(step.logical_params(state))
        got = ranks[0][cid]
        for r, res in enumerate(ranks):
            for n, t in want.items():
                check(torch.allclose(torch.tensor(res[cid]["params"][n]), t,
                                     rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL),
                      f"sparse rehearsal {cid} rank {r} {n} differs from one process")
            for moved in res[cid]["bytes"]:
                check(moved == res[cid]["predicted"],
                      f"sparse rehearsal {cid}: bytes {moved} != {res[cid]['predicted']}")
        tables = got["tables"]
        check(all(got["renderings"][n][0] == "sparse" for n in tables),
              f"sparse rehearsal {cid}: renderings {got['renderings']}")
        quarter = min(tables.values()) // 4
        largest = got["largest"]
        check(max(largest["sparse"].values()) < quarter,
              f"sparse rehearsal {cid}: a row read moved {largest['sparse']}")
        if model == "embed":
            worst = max(max(k.values()) for k in largest.values())
            check(worst < quarter, f"sparse rehearsal {cid}: a collective moved {worst} "
                  f">= a quarter of the table ({quarter})")
        cases[cid] = dict(bytes_per_step=got["bytes"][-1], predicted=got["predicted"],
                          largest=largest, table_bytes=tables,
                          max_abs_diff_vs_one_process=max(
                              (torch.tensor(got["params"][n]) - t).abs().max().item()
                              for n, t in want.items()))
    row = dict(note="gloo on the CPU: a rehearsal, not a card result", ranks=REHEARSAL_RANKS,
               steps=REHEARSAL_STEPS, torch=torch.__version__, cases=cases,
               rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL, seconds=time.perf_counter() - t0)
    emit("sparse_rehearsal", **row)
    return row


def _sup_batch(spec, step_index: int, dev):
    """bert_base's batch of one step: tokens drawn from the seed and the
    step index (the example batch's structure), so a resumed run sees the
    batches the uninterrupted one does."""
    batch = spec.example_batch(TRAIN_BATCH, device=dev)
    gen = torch.Generator().manual_seed(SEED * 1000 + step_index)
    tokens = torch.randint(0, spec.config.vocab_size, tuple(batch["tokens"].shape),
                           generator=gen, dtype=torch.int32).to(dev)
    return {**batch, "tokens": tokens, "labels": tokens.clone()}


def supervised_script(work: str, mode: str) -> int:
    """supervised_train's training script (``mode`` "preempt": under the
    launcher, fault tolerance on; "plain": the uninterrupted run). Writes
    ``<mode>-attempt<k>.json`` (and the final parameters to
    ``<mode>-params.pt``) into ``work``."""
    import signal
    import threading

    from autodist_tpu_torch.ft import FTConfig, resume_from_snapshot
    from autodist_tpu_torch.kernel.lowering import steps_in_flight

    dev = _deterministic(0)
    attempt = int(os.environ.get("AUTODIST_RESTART", "0"))
    t_start = time.perf_counter()
    record = {"mode": mode, "attempt": attempt, "pid": os.getpid()}
    out = os.path.join(work, f"{mode}-attempt{attempt}.json")

    def write_record():
        record["wall_s"] = time.perf_counter() - t_start
        record["kernel_launches"] = _launch_counts()
        with open(out, "w", encoding="utf-8") as f:
            json.dump(record, f)

    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    params = spec.init(SEED, device=dev)
    ft = FTConfig(snapshot_every_steps=SUP_SNAPSHOT_EVERY) if mode == "preempt" else None
    if ft is not None:
        def on_term(sig, frame):
            # Chained by the preemption hook once its snapshot is on disk:
            # the record, then death by the signal.
            record["died_at_step"] = int(state.step)
            record["snapshot"] = dict(autodist.ft.snapshots.last_timing)
            write_record()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev, fault_tolerance=ft)
    step = autodist.build(spec.loss_fn, params, spec.example_batch(TRAIN_BATCH, device=dev))
    state = (resume_from_snapshot(step, params, autodist.ft.snapshots) if ft is not None
             else step.init(params))
    record["start_step"] = int(state.step)
    torch.cuda.synchronize(dev)
    reset_launches()
    record["snapshots"] = []
    while state.step < SUP_STEPS:
        batch = _sup_batch(spec, state.step, dev)
        if ft is not None and attempt == 0 and state.step == SUP_PREEMPT_AT - 1:
            def preempt():
                while steps_in_flight() == 0:
                    time.sleep(0.0005)
                os.kill(os.getpid(), signal.SIGTERM)

            threading.Thread(target=preempt, daemon=True).start()
        state, _ = step(state, batch)
        if ft is not None:
            deferred = autodist.ft.snapshots._pending_signal is not None
            record.setdefault("deferred", []).append(deferred)
            if autodist.ft.maybe_snapshot(state, step_obj=step) is not None:
                autodist.ft.snapshots.wait()
                record["snapshots"].append({"step": int(state.step),
                                            **autodist.ft.snapshots.last_timing})
    torch.cuda.synchronize(dev)
    record["end_step"] = int(state.step)
    torch.save({k: v.detach().cpu() for k, v in
                flatten_params(step.logical_params(state)).items()},
               os.path.join(work, f"{mode}-params.pt"))
    write_record()
    if ft is not None:
        autodist.ft.shutdown()
    return 0


def supervised_train(card: str) -> dict:
    """The supervised_train phase (see the module docstring)."""
    torch.cuda.empty_cache()
    # One card: the launcher starts a rank per visible card.
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", CUDA_VISIBLE_DEVICES=first)
    env.pop("AUTODIST_TRACE_OUT", None)
    env.pop("AUTODIST_TRACE_ID", None)
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as work:
        ft_dir, trace_dir = os.path.join(work, "ft"), os.path.join(work, "traces")
        # The uninterrupted run, on the same card beside the launcher's
        # (deterministic algorithms: the concurrency changes no bit).
        ref = {}

        def run_plain():
            t = time.perf_counter()
            ref["code"] = subprocess.run(
                [sys.executable, me, "--supervised-script", work, "plain"], env=env,
                timeout=SUP_TIMEOUT_S).returncode
            ref["s"] = time.perf_counter() - t

        beside = threading.Thread(target=run_plain)
        beside.start()
        try:
            t0 = time.perf_counter()
            sup = subprocess.run(
                [sys.executable, "-m", "autodist_tpu_torch.runtime.launcher",
                 "--max-restarts", "1", "--restart-backoff", str(SUP_BACKOFF_S),
                 "--ft-dir", ft_dir, "--trace-out", trace_dir, "--",
                 sys.executable, me, "--supervised-script", work, "preempt"],
                env=env, cwd=os.path.dirname(me), stderr=subprocess.PIPE, text=True,
                timeout=SUP_TIMEOUT_S)
            launcher_s = time.perf_counter() - t0
        finally:
            beside.join()
        sys.stderr.write(sup.stderr[-20000:])
        check(sup.returncode == 0, f"supervised_train: launcher exited {sup.returncode}")
        delays = [float(line.rsplit(" in ", 1)[1].rstrip("s"))
                  for line in sup.stderr.splitlines() if "restarting (1/1) in " in line]
        check(len(delays) == 1, f"supervised_train: restarts logged {delays}")
        plain_s = ref.get("s")
        check(ref.get("code") == 0, f"supervised_train: the uninterrupted run exited "
                                    f"{ref.get('code')}")
        attempts = []
        for k in (0, 1):
            with open(os.path.join(work, f"preempt-attempt{k}.json"), encoding="utf-8") as f:
                attempts.append(json.load(f))
        with open(os.path.join(work, "plain-attempt0.json"), encoding="utf-8") as f:
            plain = json.load(f)
        a0, a1 = attempts
        check(a0["start_step"] == 0 and a0.get("died_at_step") == SUP_PREEMPT_AT,
              f"supervised_train: attempt 0 {a0}")
        check(a0["deferred"][SUP_PREEMPT_AT - 1] and not any(a0["deferred"][:SUP_PREEMPT_AT - 1]),
              f"supervised_train: the SIGTERM was not deferred to step "
              f"{SUP_PREEMPT_AT}'s boundary: {a0['deferred']}")
        check(a1["start_step"] == SUP_PREEMPT_AT and a1["end_step"] == SUP_STEPS,
              f"supervised_train: attempt 1 {a1}")
        layers = get_model("bert_base").num_layers
        for rec, steps in ((a0, SUP_PREEMPT_AT), (a1, SUP_STEPS - SUP_PREEMPT_AT),
                           (plain, SUP_STEPS)):
            for kind, n in rec["kernel_launches"].items():
                check(n == layers * steps, f"supervised_train: {rec['mode']} attempt "
                      f"{rec['attempt']} flash {kind} launches {n} != {layers} x {steps}")
        resumed = torch.load(os.path.join(work, "preempt-params.pt"))
        unbroken = torch.load(os.path.join(work, "plain-params.pt"))
        check(sorted(resumed) == sorted(unbroken), "supervised_train: parameter names differ")
        differ = [n for n in unbroken if not torch.equal(resumed[n], unbroken[n])]
        check(not differ, f"supervised_train: resumed parameters not bitwise the "
                          f"uninterrupted run's: {differ[:5]}")
        traces = [n for n in os.listdir(trace_dir) if n.startswith("trace-")]
        check(len(traces) == 1, f"supervised_train: stitched traces {traces}")
        with open(os.path.join(trace_dir, traces[0]), encoding="utf-8") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        check(any(e["name"] == "launcher.fleet" for e in events),
              "supervised_train: no launcher.fleet span in the stitched trace")
        for rec in attempts:
            names = {e["name"] for e in events if e["pid"] == rec["pid"]}
            check({"ft.snapshot.device_to_host", "ft.snapshot.write"} <= names,
                  f"supervised_train: attempt {rec['attempt']}'s snapshot spans missing "
                  f"({sorted(names)})")
    snaps = a0["snapshots"] + [{"step": SUP_PREEMPT_AT, **a0["snapshot"]}] + a1["snapshots"]
    row = dict(model="bert_base", seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=SUP_STEPS,
               preempt_at=SUP_PREEMPT_AT, snapshot_every=SUP_SNAPSHOT_EVERY,
               bitwise=True, restart_delay_s=delays[0],
               attempt_wall_s=[a0["wall_s"], a1["wall_s"]], plain_wall_s=plain["wall_s"],
               launcher_s=launcher_s, plain_process_s=plain_s, snapshots=snaps,
               kernel_launches={k: a0["kernel_launches"][k] + a1["kernel_launches"][k]
                                for k in a0["kernel_launches"]},
               trace_spans=len(events), card=card)
    emit("supervised_train", **row)
    return row


# ---------------------------------------------------------- serve replica
def serve_cli(counts_path: str, argv: list) -> int:
    """``python chip_smoke.py --serve-cli COUNTS ARGS...``: the port's serve
    CLI (``python -m autodist_tpu_torch.serve ARGS``) in this process, which
    writes the paged kernel's launches and the span counts by name to COUNTS
    when the server returns (SIGTERM unwinds it there)."""
    from autodist_tpu_torch.obs import spans as obs_spans
    from autodist_tpu_torch.serve.__main__ import main as serve_main

    reset_launches()
    rc = 1
    try:
        rc = serve_main(argv)
    finally:
        tracer = obs_spans.get_tracer()
        with open(counts_path, "w", encoding="utf-8") as f:
            json.dump({"main_rc": rc, "launches": pa.paged_attention.launches,
                       "spans": collections.Counter(sp.name for sp in tracer.spans()),
                       "spans_dropped": tracer.dropped}, f)
    return rc


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port: int, method: str, path: str, body=None, timeout: float = 120.0):
    """One blocking HTTP/1.1 exchange: (status, JSON body)."""
    data = json.dumps(body).encode() if body is not None else b""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                     f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        raw = b""
        while True:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


class _Replica:
    """One process of the CLI's supervised replica on cuda:0."""

    def __init__(self, work: str, tag: str):
        self.port = _free_port()
        self.counts = os.path.join(work, f"counts-{tag}.json")
        self.flight = os.path.join(work, f"flight-{tag}")
        env = dict(os.environ, AUTODIST_FLIGHT_DIR=self.flight)
        for name in ("AUTODIST_TRACE_OUT", "AUTODIST_TRACE_ID", "AUTODIST_PROCESS_ID",
                     "AUTODIST_FT_DIR"):
            env.pop(name, None)
        me = os.path.abspath(__file__)
        self.log = open(os.path.join(work, f"replica-{tag}.log"), "w", encoding="utf-8")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, me, "--serve-cli", self.counts, *REPLICA_ARGS,
             "--port", str(self.port), "--ft-dir", os.path.join(work, "ft"),
             "--replica-id", "0", "--trace-out", os.path.join(work, "trace")],
            cwd=os.path.dirname(me), env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def wait_ready(self) -> dict:
        """Poll /healthz until 200: the codes seen and the seconds to READY."""
        seen = []
        while time.perf_counter() - self.t0 < REPLICA_TIMEOUT_S:
            check(self.proc.poll() is None, f"serve_replica: the server exited "
                  f"{self.proc.returncode} before READY ({self.tail()})")
            try:
                code, body = _call(self.port, "GET", "/healthz", timeout=5.0)
            except OSError:
                time.sleep(0.05)
                continue
            if not seen or seen[-1] != [code, body["state"]]:
                seen.append([code, body["state"]])
            if code == 200:
                return dict(codes=seen, ready_s=time.perf_counter() - self.t0)
            time.sleep(0.02)
        raise RuntimeError(f"chip_smoke check failed: serve_replica: not READY in "
                           f"{REPLICA_TIMEOUT_S} s ({seen[-3:]})")

    def sigterm(self) -> dict:
        """SIGTERM; the exit code, seconds to exit and the process's counts."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError("chip_smoke check failed: serve_replica: no exit 120 s "
                               f"after SIGTERM ({self.tail()})")
        finally:
            self.log.close()
        with open(self.counts, encoding="utf-8") as f:
            counts = json.load(f)
        return dict(rc=rc, exit_s=time.perf_counter() - t0, **counts)

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name, encoding="utf-8", errors="replace") as f:
            return f.read()[-3000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()


def _post_all(port: int, prompts: dict, results: dict) -> list:
    """One thread a request: POST /generate, the answer (or the error) into
    ``results[request_id]``."""
    def post(rid):
        try:
            results[rid] = _call(port, "POST", "/generate",
                                 {"tokens": prompts[rid], "max_new_tokens": MAX_NEW,
                                  "request_id": rid})[1]
        except (OSError, ValueError, IndexError) as e:
            results[rid] = {"state": "lost", "error": repr(e)}

    threads = [threading.Thread(target=post, args=(rid,), daemon=True) for rid in prompts]
    for t in threads:
        t.start()
    return threads


def _spans_in(trace_dir: str) -> dict:
    names = collections.Counter()
    for name in os.listdir(trace_dir):
        if name.startswith("obs-part-"):
            with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
                names.update(e["name"] for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X")
    return names


def _window_launches(counts: dict, layers: int, label: str) -> int:
    programs = counts["spans"].get("serve.prefill_chunk", 0) + \
        counts["spans"].get("serve.decode_step", 0)
    check(counts["spans_dropped"] == 0, f"serve_replica: {label}: spans dropped")
    check(counts["launches"] == layers * programs > 0,
          f"serve_replica: {label}: paged launches {counts['launches']} != "
          f"{layers} x {programs} programs")
    return counts["launches"]


def _replica_processes(params, cfg, prompts: list, want: list, work: str) -> dict:
    """The CLI's replica: readiness, 64 requests, POST /drain, SIGTERM; the
    restart replaying the journal, GET /slo against the flight records, and
    SIGTERM under load."""
    layers = cfg.num_layers
    rids = [f"replica-{i}" for i in range(len(prompts))]
    by_rid = {rid: [int(t) for t in p] for rid, p in zip(rids, prompts)}
    ft, journal = os.path.join(work, "ft"), os.path.join(work, "ft", "serve_queue-0.json")
    replayed_log = os.path.join(ft, "serve_replayed-0.jsonl")
    row = {}

    first = _Replica(work, "first")
    try:
        ready = first.wait_ready()
        check(ready["codes"][0] == [503, "starting"] and ready["codes"][-1] == [200, "ready"],
              f"serve_replica: /healthz codes {ready['codes']}")
        results = {}
        threads = _post_all(first.port, by_rid, results)
        # Drain once every request is in and the 32 slots are full: the
        # drain then finishes a full batch in flight and persists the queue.
        deadline = time.perf_counter() + 60
        while True:
            health = _call(first.port, "GET", "/healthz")[1]
            if (health["outstanding"] + len(results) >= len(rids)
                    and health["active_slots"] == REPLICA_SLOTS):
                break
            check(time.perf_counter() < deadline, f"serve_replica: requests not "
                  f"admitted ({health})")
            time.sleep(0.005)
        code, drained = _call(first.port, "POST", "/drain")
        for t in threads:
            t.join(timeout=120)
        code_after, health_after = _call(first.port, "GET", "/healthz")
        term = first.sigterm()
    finally:
        first.close()
    check(code == 200 and sorted(drained) == ["drained", "persisted"],
          f"serve_replica: POST /drain answered {code} {drained}")
    check(term["rc"] == 0, f"serve_replica: the drained server exited {term['rc']}")
    states = collections.Counter(r["state"] for r in results.values())
    check(len(results) == len(rids) and set(states) <= {"done", "preempted"},
          f"serve_replica: request states {dict(states)}")
    done = {rid for rid, r in results.items() if r["state"] == "done"}
    preempted = sorted(set(rids) - done)
    # Every request DONE or PREEMPTED, none lost: what the drain found not
    # yet completed (64 - (done - drained)) is what it finished or persisted.
    check(drained["persisted"] == len(preempted) > 0,
          f"serve_replica: persisted {drained['persisted']} != preempted {len(preempted)}")
    check(drained["drained"] + drained["persisted"] == len(rids) - (len(done) - drained["drained"]),
          f"serve_replica: drained {drained} against {len(done)} done")
    check(code_after == 503 and health_after["state"] == "draining"
          and health_after["page_pool_utilization"] == 0.0,
          f"serve_replica: /healthz after the drain {code_after} {health_after}")
    with open(journal, encoding="utf-8") as f:
        doc = json.load(f)
    check(doc["format_version"] == 2
          and sorted(e["request_id"] for e in doc["entries"]) == preempted,
          "serve_replica: the journal's request ids are not the preempted requests'")
    first_launches = _window_launches(term, layers, "first process")
    idx = {rid: i for i, rid in enumerate(rids)}
    done_agree = _streams_agree(params, cfg, [prompts[idx[r]] for r in sorted(done)],
                                [results[r]["tokens"] for r in sorted(done)],
                                [want[idx[r]] for r in sorted(done)],
                                "serve_replica done", bitwise=False)
    row.update(ready_s=ready["ready_s"], healthz_codes=ready["codes"], requests=len(rids),
               done=len(done), drained=drained["drained"], persisted=drained["persisted"],
               journal_entries=len(doc["entries"]), done_streams=done_agree,
               drain_exit_s=term["exit_s"])

    second = _Replica(work, "second")
    try:
        ready2 = second.wait_ready()
        deadline = time.perf_counter() + 120
        while not (os.path.exists(replayed_log) and
                   len(open(replayed_log, encoding="utf-8").readlines()) >= len(preempted)):
            check(time.perf_counter() < deadline, "serve_replica: the replay did not finish")
            time.sleep(0.05)
        # The request record lands before the SLO feed: wait for the feed.
        while True:
            slo_code, live = _call(second.port, "GET", "/slo")
            if slo_code != 200 or live["counts"]["requests"] >= len(preempted):
                break
            check(time.perf_counter() < deadline, "serve_replica: GET /slo incomplete")
            time.sleep(0.05)
        replayed_flight = replay_flight_records(obs_recorder.read_records(second.flight))
        load = {f"term-{i}": by_rid[rids[i]] for i in range(REPLICA_SIGTERM_LOAD)}
        cut = {}
        threads = _post_all(second.port, load, cut)
        deadline = time.perf_counter() + 60
        while _call(second.port, "GET", "/healthz")[1]["outstanding"] == 0:
            check(time.perf_counter() < deadline, "serve_replica: no load before SIGTERM")
            time.sleep(0.005)
        term2 = second.sigterm()
        for t in threads:
            t.join(timeout=30)
    finally:
        second.close()
    check(term2["rc"] == 0, f"serve_replica: SIGTERM under load: exit {term2['rc']}")
    check(not os.path.exists(journal), "serve_replica: the journal was not consumed")
    with open(replayed_log, encoding="utf-8") as f:
        replayed = [json.loads(line) for line in f]
    check(sorted(r["request_id"] for r in replayed) == preempted,
          "serve_replica: the replay did not serve each journaled request exactly once")
    check(all(r["state"] == "done" and len(r["tokens"]) == MAX_NEW for r in replayed),
          "serve_replica: a replayed request did not complete")
    replay_agree = _streams_agree(params, cfg, [prompts[idx[r["request_id"]]] for r in replayed],
                                  [r["tokens"] for r in replayed],
                                  [want[idx[r["request_id"]]] for r in replayed],
                                  "serve_replica replay", bitwise=False)
    second_launches = _window_launches(term2, layers, "restarted process")
    check(slo_code == 200 and live["counts"]["requests"] == len(preempted),
          f"serve_replica: GET /slo {slo_code} {live.get('counts')}")
    off = replayed_flight.report()
    slo_keys = ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s", "queue_wait_p99_s")
    for key in slo_keys:
        a, b = live["measured"][key], off["measured"][key]
        check(abs(a - b) <= SLO_REPLAY_RTOL * abs(b),
              f"serve_replica: {key} live {a} vs flight-record replay {b}")
    spans = _spans_in(os.path.join(work, "trace"))
    check(all(spans[n] > 0 for n in ("serve.queue_wait", "serve.prefill_chunk",
                                     "serve.decode_step")),
          f"serve_replica: --trace-out spans {dict(spans)}")
    row.update(restart_ready_s=ready2["ready_s"], replayed=len(replayed),
               replay_streams=replay_agree, journal_consumed=True,
               slo_live={k: live["measured"][k] for k in slo_keys},
               slo_replayed={k: off["measured"][k] for k in slo_keys},
               slo_compliant=live["compliant"]["overall"], slo_spec=live["slo"],
               sigterm_rc=term2["rc"], sigterm_exit_s=term2["exit_s"],
               sigterm_states=dict(collections.Counter(r["state"] for r in cut.values())),
               sigterm_left_journal=os.path.exists(journal),
               trace_spans=dict(spans),
               process_launches=[first_launches, second_launches])
    return row


def _no_spans():
    return SimpleNamespace(span=lambda *a, **k: contextlib.nullcontext())


def _decode_hook_cost(engine, prompts, work: str) -> dict:
    """Host ms of a 32-row decode step with the flight hooks off (no
    recorder, spans stubbed) and on (recorder and spans), in turns, and the
    full (generation 2) garbage collections each mode's windows ran."""
    slots = [engine.admit(p, 2 * HOOK_COST_STEPS * HOOK_COST_TURNS + 8)
             for p in prompts[:engine.n_slots]]
    for slot in slots:
        while engine.prefill_step(slot) is None:
            pass
    real = serve_engine.obs_spans
    ms = {"off": [], "on": []}
    full_gcs = {"off": 0, "on": 0}
    try:
        for turn in range(HOOK_COST_TURNS):
            for mode in (("off", "on") if turn % 2 == 0 else ("on", "off")):
                if mode == "on":
                    obs_recorder.enable(os.path.join(work, "hook-cost"))
                    serve_engine.obs_spans = real
                else:
                    obs_recorder.disable()
                    serve_engine.obs_spans = _no_spans()
                torch.cuda.synchronize()
                gcs = gc.get_stats()[2]["collections"]
                t0 = time.perf_counter()
                for _ in range(HOOK_COST_STEPS):
                    engine.step()
                torch.cuda.synchronize()
                ms[mode].append((time.perf_counter() - t0) * 1e3 / HOOK_COST_STEPS)
                full_gcs[mode] += gc.get_stats()[2]["collections"] - gcs
    finally:
        serve_engine.obs_spans = real
        obs_recorder.disable()
        for slot in slots:
            engine.release(slot)
    return {k: statistics.median(v) for k, v in ms.items()} | {"turns": ms,
                                                                "full_gcs": full_gcs}


def _replica_chaos(engine, prompts, work: str) -> dict:
    """The seams on the card: an engine death at SEAM_SERVE_STEP, a page
    exhaustion window at SEAM_SERVE_PAGES, and a stall that trips SNT008
    once an episode in a Sentry fed each request's ITL."""
    out = {}
    flight = os.path.join(work, "chaos-flight")
    obs_recorder.enable(flight)
    try:
        # Engine death mid-decode: every request ends typed, no hang, no leak.
        calls = []

        def die(**ctx):
            calls.append(ctx)
            if len(calls) == 5:
                raise EngineDeadError(f"chaos: engine died on host {ctx['host']}")

        chaos_hooks.install(chaos_hooks.SEAM_SERVE_STEP, die)
        batcher = ContinuousBatcher(engine, registry=M.MetricsRegistry())
        reqs = [batcher.submit(p, MAX_NEW) for p in prompts]
        t0 = time.perf_counter()
        batcher.start()
        check(all(r.wait(timeout=60).done for r in reqs), "chaos death: a request hangs")
        out["death_s"] = time.perf_counter() - t0
        chaos_hooks.clear()
        batcher.stop(drain=False)
        states = collections.Counter((r.state.value, r.error.split(":")[0]) for r in reqs)
        check(set(states) == {("rejected", "engine died mid-decode")},
              f"chaos death: states {dict(states)}")
        check(pools_balanced(engine), "chaos death: page leak")
        check(batcher.try_submit([1, 2, 3], 4).state is RequestState.REJECTED,
              "chaos death: try_submit on a dead engine not typed")
        out["death_states"] = {f"{k[0]}: {k[1]}": v for k, v in states.items()}

        # Page exhaustion: pool_pressure once a window, typed sheds past the
        # queue bound, then every admitted request completes.
        chaos_hooks.install(chaos_hooks.SEAM_SERVE_PAGES, lambda **ctx: "exhaust")
        batcher = ContinuousBatcher(engine, max_queue=16, registry=M.MetricsRegistry())
        before = len(obs_recorder.read_records(flight))
        batcher.start()
        reqs = [batcher.try_submit(p, MAX_NEW) for p in prompts]
        time.sleep(EXHAUST_S)
        stalled = engine.active_slots
        chaos_hooks.clear()
        admitted = [r for r in reqs if r.state is not RequestState.REJECTED]
        check(all(r.wait(timeout=120).state is RequestState.DONE for r in admitted),
              "chaos exhaustion: an admitted request did not complete")
        batcher.stop()
        recs = obs_recorder.read_records(flight)[before:]
        pressure = [r for r in recs if r["kind"] == "pool_pressure"]
        sheds = [r for r in recs if r["kind"] == "shed"]
        n_shed = len(reqs) - len(admitted)
        check(stalled == 0 and len(admitted) == 16, f"chaos exhaustion: {stalled} active, "
              f"{len(admitted)} admitted")
        check(1 <= len(pressure) <= int(EXHAUST_S) + 1 and 1 <= len(sheds) <= 2
              and batcher._shed_count == n_shed,
              f"chaos exhaustion: {len(pressure)} pool_pressure, sheds {sheds}, "
              f"{batcher._shed_count} shed of {n_shed}")
        check(all(r.error.startswith("admission rejected: admission queue full")
                  for r in reqs if r.state is RequestState.REJECTED),
              "chaos exhaustion: sheds not typed")
        check(pools_balanced(engine), "chaos exhaustion: page leak")
        out.update(pool_pressure_events=len(pressure), shed_events=len(sheds),
                   shed_requests=n_shed)

        # A stall at the step seam past itl_min_s: SNT008 once an episode.
        sentry = Sentry(registry=M.MetricsRegistry(), process_id=0)
        itls = []

        def run(batch, stall):
            if stall:
                chaos_hooks.install(chaos_hooks.SEAM_SERVE_STEP,
                                    lambda **ctx: time.sleep(STALL_S))
            b = ContinuousBatcher(engine, registry=M.MetricsRegistry()).start()
            done = [b.submit(p, 8) for p in batch]
            for r in done:
                r.wait(timeout=120)
            b.stop()
            chaos_hooks.clear()
            for r in sorted(done, key=lambda r: r.t_done):
                check(r.state is RequestState.DONE, "chaos stall: a request failed")
                itls.append(r.itl_s)
                sentry.observe_serve(itl_s=r.itl_s, replica_id=0)

        run(prompts[:16], False)
        run(prompts[16:24], True)
        first = [f.code for f in sentry.findings]
        run(prompts[24:40], False)
        run(prompts[40:48], True)
        codes = [f.code for f in sentry.findings]
        check(first == ["SNT008"] and codes.count("SNT008") == 2,
              f"chaos stall: findings {codes} (after one stall {first})")
        out.update(snt008_findings=codes.count("SNT008"), findings=codes,
                   itl_normal_p50_s=statistics.median(itls[:16]),
                   itl_stalled_p50_s=statistics.median(itls[16:24]))
    finally:
        chaos_hooks.clear()
        obs_recorder.disable()
    return out


def serve_replica(params, card: str, dev) -> dict:
    """The serve_replica phase (see the module docstring)."""
    t_phase = time.perf_counter()
    cfg = get_model("transformer")
    rng = np.random.default_rng(SEED)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size) for i in range(N_REQUESTS)]
    engine = InferenceEngine(params, tt.decode_model(cfg), n_slots=REPLICA_SLOTS,
                             page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    engine.generate([1, 2, 3], 2)                        # warm-up, not counted
    want, _, _, ref_launches, _ = _served(engine, prompts, "serve_replica reference",
                                          cfg.num_layers)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        row = _replica_processes(params, cfg, prompts, want, work)
        reset_launches()
        programs = engine.prefill_invocations + engine.decode_invocations
        chaos = _replica_chaos(engine, prompts, work)
        cost = _decode_hook_cost(engine, prompts, work)
        chaos_launches = pa.paged_attention.launches
        ran = engine.prefill_invocations + engine.decode_invocations - programs
        check(chaos_launches == cfg.num_layers * ran,
              f"serve_replica: in-process launches {chaos_launches} != "
              f"{cfg.num_layers} x {ran}")
    del engine
    torch.cuda.empty_cache()
    row.update(chaos=chaos, decode_step_host_ms_hooks_off=cost["off"],
               decode_step_host_ms_hooks_on=cost["on"], hook_cost_turns=cost["turns"],
               hook_cost_full_gcs=cost["full_gcs"],
               kernel_launches=ref_launches + sum(row.pop("process_launches")) + chaos_launches,
               wall_s=time.perf_counter() - t_phase, card=card)
    emit("serve_replica", **row)
    return row


# -------------------------------------------------------------- serve fleet
def _fleet(params, cfg, dev, work: str, tag: str, router_cfg, sentry_cfg):
    """The card's fleet: ``build_test_fleet`` at FLEET_* over ``params``
    with the given configs, under the selftest's SLO spec
    (``TEST_SLO_SPEC``): the bar is ``selftest_router``'s (64 requests at
    once onto 48 rows queue a second wave behind the first by design;
    JAX's default interactive spec is judged beside it, ``_slo_verdict``)."""
    return build_test_fleet(
        n_replicas=FLEET_REPLICAS, n_slots=FLEET_SLOTS, page_len=PAGE_LEN,
        n_pages=FLEET_PAGES, journal_dir=os.path.join(work, tag),
        registry=M.MetricsRegistry(), config=router_cfg, device=dev, model_cfg=cfg,
        params=params, sentry_config=sentry_cfg)


def _slo_verdict(router, spec: SLOSpec) -> dict:
    """The router's SLO tracker judged against ``spec`` by its own rule."""
    saved, router.slo.spec = router.slo.spec, spec
    try:
        return router.slo.report()["compliant"]
    finally:
        router.slo.spec = saved


def _engine_programs(engines) -> int:
    return sum(e.prefill_invocations + e.decode_invocations for e in engines)


def _fleet_window(router, prompts, want, cfg, label: str, kill) -> tuple:
    """One fleet_trial with the paged kernel's count set to 0 just before and
    held just after to layers x the programs of every replica engine."""
    reset_launches()
    out = fleet_trial(router, prompts, FLEET_NEW, expected=want, kill_replica=kill)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    programs = {rid: _engine_programs([rep.engine]) for rid, rep in router.replicas.items()}
    check(launches == cfg.num_layers * sum(programs.values()) > 0,
          f"serve_fleet {label}: paged launches {launches} != {cfg.num_layers} x "
          f"{programs} programs")
    return out, launches, programs


def _mismatch_margins(params, cfg, results) -> list:
    """Each request ended on a failover prefix mismatch: the |Δlogit| of the
    regenerated and the delivered token under the uncached forward of
    the prompt and the delivered prefix before it."""
    margins = []
    for r in results:
        if r.state is not RequestState.REJECTED or "prefix mismatch" not in r.error:
            continue
        regen = int(r.error.split("regenerated ")[1].split(",")[0])
        tokens = torch.tensor([list(r.prompt) + list(r.tokens[:-1])], dtype=torch.int32,
                              device=params["embed"]["embedding"].device)
        with torch.no_grad():
            logits = tt.forward(params, tokens, cfg)[0, -1]
        margins.append(abs(float(logits[regen] - logits[r.tokens[-1]])))
    return margins


def _fleet_http(router, cfg, prompts) -> dict:
    """A RouterFrontend in front of the fleet: FLEET_HTTP POST /generate,
    GET /metrics, /healthz and /slo; the paged launches of the window."""
    async def run():
        fe = await RouterFrontend(router, port=0).start()
        gens = await asyncio.gather(*(asyncio.to_thread(
            _call, fe.port, "POST", "/generate",
            {"tokens": [int(t) for t in p], "max_new_tokens": 8}) for p in prompts))
        metrics = await asyncio.to_thread(_call_text, fe.port, "/metrics")
        health = await asyncio.to_thread(_call, fe.port, "GET", "/healthz")
        slo = await asyncio.to_thread(_call, fe.port, "GET", "/slo")
        await fe.close()
        return gens, metrics, health, slo

    before = _engine_programs([rep.engine for rep in router.replicas.values()])
    reset_launches()
    gens, (mcode, text), health, slo = asyncio.run(run())
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    ran = _engine_programs([rep.engine for rep in router.replicas.values()]) - before
    check(all(code == 200 and body["state"] == "done" and len(body["tokens"]) == 8
              for code, body in gens), f"serve_fleet HTTP: {gens}")
    samples = parse_openmetrics(text)
    labelled = sorted({name for name, labels in samples if labels.startswith("replica=")})
    check(mcode == 200 and ("serve_replica_up", 'replica="1"') in samples
          and samples[("serve_replica_up", 'replica="1"')] == 0.0,
          f"serve_fleet /metrics: {mcode}, replica samples {labelled}")
    check(health[0] == 200 and health[1]["replicas"]["1"] == "dead",
          f"serve_fleet /healthz: {health}")
    check(slo[0] == 200 and {"measured", "compliant", "router"} <= set(slo[1]),
          f"serve_fleet /slo: {slo[0]}")
    check(launches == cfg.num_layers * ran,
          f"serve_fleet HTTP: paged launches {launches} != {cfg.num_layers} x {ran}")
    return dict(http_generate=[c for c, _ in gens], http_metrics=mcode,
                http_replica_metrics=labelled, http_healthz=health[0],
                http_replicas=health[1]["replicas"], http_slo=slo[0], http_launches=launches)


def _call_text(port: int, path: str) -> tuple:
    with socket.create_connection(("127.0.0.1", port), timeout=120.0) as sock:
        sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        raw = b""
        while chunk := sock.recv(65536):
            raw += chunk
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


def _fleet_case(params, cfg, dev, work: str, tag: str, bitwise: bool, http: bool) -> dict:
    """One fleet (see the module docstring): control streams, the kill-free
    run, the configs it implies, the killed run and its bars."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    prompts = [np.asarray(mock_load_prompt(rng, i, vocab=cfg.vocab_size), np.int32)
               for i in range(FLEET_REQUESTS)]
    calib_router, control = _fleet(params, cfg, dev, work, f"{tag}-calib", RouterConfig(),
                                   SentryConfig())
    want, _, _, control_launches, _ = _served(control, prompts, f"serve_fleet {tag} control",
                                              cfg.num_layers, max_new=FLEET_NEW)
    try:
        calib, calib_launches, calib_programs = _fleet_window(
            calib_router, prompts, None, cfg, f"{tag} kill-free", None)
    finally:
        calib_router.stop(drain=False)
    line = calib["line"]
    check(line["completed"] == FLEET_REQUESTS and line["exactly_once"] and line["journal_empty"],
          f"serve_fleet {tag} kill-free run: {line}")
    streams = _streams_agree(params, cfg, prompts, [r.tokens for r in calib["results"]], want,
                             f"serve_fleet {tag} kill-free", bitwise)
    kill_free = dict(calib["observed"], replicas_ready=line["replicas_ready_after_kill"],
                     failovers=line["failovers"], streams=streams, wall_s=line["wall_s"],
                     ttft_p50_s=line["ttft_p50_s"], ttft_p99_s=line["ttft_p99_s"],
                     itl_p50_s=line["itl_p50_s"], itl_p99_s=line["itl_p99_s"])
    del calib_router
    router_cfg, sentry_cfg, raised = calibrated_configs(calib["observed"], RouterConfig(),
                                                        SentryConfig())
    emit("serve_fleet_kill_free", fleet=tag, configs_raised=raised, **kill_free)

    router, _ = _fleet(params, cfg, dev, work, tag, router_cfg, sentry_cfg)
    try:
        out, launches, programs = _fleet_window(
            router, prompts, want if bitwise else None, cfg, tag, FLEET_KILL)
        line, results = out["line"], out["results"]
        ledger = router.ledger()
        done = [i for i, r in enumerate(results) if r.state is RequestState.DONE]
        margins = _mismatch_margins(params, cfg, results)
        check(out["killed"] and line["failovers"] >= 1 and line["requests_rerouted"] >= 1,
              f"serve_fleet {tag}: no failover: {line}")
        check(len(ledger) == FLEET_REQUESTS and all(ledger[results[i].request_id] == 1
                                                      for i in done)
              and all(v <= 1 for v in ledger.values()),
              f"serve_fleet {tag}: not exactly once: {ledger}")
        check(len(done) + len(margins) == FLEET_REQUESTS
              and line["prefix_mismatches"] == len(margins),
              f"serve_fleet {tag}: {line['completed']} done, {len(margins)} mismatches of "
              f"{FLEET_REQUESTS}")
        check(not (bitwise and margins) and all(m <= STREAM_LOGIT_BOUND for m in margins),
              f"serve_fleet {tag}: overlap mismatches at margins {margins}")
        for bar in ("journal_empty", "slo_compliant", "failover_trace_stitched",
                    "snt007_snt008_once_per_episode", "sentry_demoted_replica"):
            check(bool(line[bar]), f"serve_fleet {tag}: {bar} false: {line}")
        check(line["replicas_ready_after_kill"] == FLEET_REPLICAS - 1,
              f"serve_fleet {tag}: {line['replicas_ready_after_kill']} replicas READY after "
              f"the kill: {router.slo_report()['router']}")
        streams = _streams_agree(params, cfg, [prompts[i] for i in done],
                                 [results[i].tokens for i in done], [want[i] for i in done],
                                 f"serve_fleet {tag}", bitwise)
        check(not bitwise or line["ok"], f"serve_fleet {tag}: selftest bars {line}")
        decode_tokens = sum(len(results[i].tokens) - 1 for i in done)
        measured = router.slo_report()["measured"]
        row = dict(line, kill_free=kill_free, configs_raised=raised,
                   queue_wait_p99_s=measured["queue_wait_p99_s"],
                   default_slo_spec_verdict=_slo_verdict(router, SLOSpec()),
                   router_config=asdict(router_cfg), sentry_config=asdict(sentry_cfg),
                   slo_spec=asdict(TEST_SLO_SPEC), killed_run=out["observed"],
                   streams=streams, mismatch_margins=margins,
                   decode_tokens_per_s=decode_tokens / line["wall_s"],
                   programs=programs, control_launches=control_launches,
                   kill_free_launches=calib_launches, kill_free_programs=calib_programs,
                   kernel_launches=control_launches + calib_launches + launches)
        if http:
            row.update(_fleet_http(router, cfg, prompts[:FLEET_HTTP]))
            row["kernel_launches"] += row["http_launches"]
    finally:
        router.stop(drain=False)
    row["wall_s_fleet"] = time.perf_counter() - t0
    return row


def serve_fleet(params, card: str, dev) -> dict:
    """The serve_fleet phase (see the module docstring)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as work:
        fleet_b = _fleet_case(params, get_model("transformer"), dev, work, "B", bitwise=False,
                              http=True)
        emit("serve_fleet", fleet="B", model="transformer, full width, bf16 pages", card=card,
             **fleet_b)
        f32 = get_model("transformer", num_layers=2, dtype="float32")
        p32 = tt.init_params(f32, seed=SEED + 2, device=dev)
        fleet_a = _fleet_case(p32, f32, dev, work, "A", bitwise=True, http=False)
        emit("serve_fleet", fleet="A", model="transformer, full width, 2 layers, fp32",
             card=card, **fleet_a)
        del p32
    torch.cuda.empty_cache()
    row = dict(kernel_launches=fleet_b["kernel_launches"] + fleet_a["kernel_launches"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               wall_s=time.perf_counter() - t_phase, card=card)
    emit("serve_fleet", fleet="both", **row)
    return row


# ---------------------------------------------------------- serve_selftest
def serve_selftest(card: str) -> dict:
    """The single-engine serving proofs on the card: ``selftest`` and
    ``_selftest_quant`` in process (each must return 0; their JSON lines are
    emitted), then ``python -m autodist_tpu_torch.serve --selftest`` as a
    child process for the CLI's exit code. The paged kernel's launches of
    the two in-process runs are counted (the kernel engines, and the int8
    engines where "auto" takes the kernel)."""
    from autodist_tpu_torch.serve.server import _selftest_quant, selftest

    t_phase = time.perf_counter()
    launches = {}
    for run, fn in (("plain", selftest), ("kv_quant", _selftest_quant)):
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = fn(device="cuda")
        torch.cuda.synchronize()
        launches[run] = pa.paged_attention.launches
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        emit("serve_selftest", run=run, rc=rc, seconds=time.perf_counter() - t0,
             paged_launches=launches[run], card=card, **line)
        check(rc == 0 and line["ok"], f"serve selftest ({run}) failed: {line}")
        check(launches[run] > 0, f"serve selftest ({run}): the paged kernel never launched")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.serve", "--selftest"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    cli = json.loads(lines[-1]) if lines else {}
    emit("serve_selftest", run="cli", rc=proc.returncode, seconds=time.perf_counter() - t0,
         **cli)
    check(proc.returncode == 0 and cli.get("ok"),
          f"python -m autodist_tpu_torch.serve --selftest exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return dict(kernel_launches=sum(launches.values()), wall_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------- serve_bucketed
def _drive(engine, prompts, max_new: int):
    """Every prompt admitted at once (the bucketed engine prefills as it
    admits, the paged one prefills each slot to its first token), then one
    decode step after another until every stream holds ``max_new`` tokens.
    Returns (streams, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if isinstance(engine, BucketedInferenceEngine):
        admitted = [engine.admit(p, max_new) for p in prompts]
        check(all(a is not None for a in admitted), "bucketed: a prompt found no slot")
        slots = [a[0] for a in admitted]
        streams = [[a[1]] for a in admitted]
    else:
        slots = [engine.admit(p, max_new) for p in prompts]
        check(all(isinstance(s, serve_engine.Slot) for s in slots), f"paged: {slots}")
        streams = []
        for slot in slots:
            first = None
            while first is None:
                first = engine.prefill_step(slot)
            streams.append([first])
    while any(len(st) < max_new for st in streams):
        out = engine.step()
        for slot, st in zip(slots, streams):
            if len(st) < max_new:
                st.append(out[slot])
    wall = time.perf_counter() - t0
    for slot in slots:
        engine.release(slot)
    return streams, wall


def _step_host_ms(engine, steps: int) -> float:
    """Median host wall of one ``engine.step()`` (its tokens read back)."""
    samples = []
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.step()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def serve_bucketed(params, card: str, dev) -> dict:
    """The bucketed engine as the measured baseline at full width (see the
    module docstring): concurrency at equal KV bytes, streams against the
    paged kernel engine, decode-step host and device ms and tokens/s."""
    t_phase = time.perf_counter()
    cfg = get_model("transformer")
    kcfg = replace(cfg, paged_attention_impl="kernel")
    bucketed = BucketedInferenceEngine(params, tt.decode_model(cfg), n_slots=BUCKETED_ROWS,
                                       device=dev)
    kv_tokens = bucketed.kv_pool_tokens
    bucket_bytes = sum(t.numel() * t.element_size() for b in bucketed._buckets.values()
                       for t in b.cache.values())
    n_pages = kv_tokens // PAGE_LEN
    kw = dict(page_len=PAGE_LEN, n_pages=n_pages, prefill_chunk=PAGE_LEN, device=dev)
    paged = InferenceEngine(params, tt.decode_model(kcfg), n_slots=BUCKETED_ROWS, **kw)
    check(paged.page_pool_bytes == bucket_bytes,
          f"unequal KV bytes: paged {paged.page_pool_bytes}, bucketed {bucket_bytes}")

    # Concurrency at equal KV bytes, the selftest's 6 + 6 mix.
    wide = InferenceEngine(params, tt.decode_model(kcfg), n_slots=n_pages, **kw)
    cap = {"bucketed": _admission_capacity(bucketed, 6, 6, limit=4 * n_pages),
           "paged_pool_bound": _admission_capacity(wide, 6, 6, limit=4 * n_pages),
           "paged_rows": _admission_capacity(paged, 6, 6, limit=4 * n_pages)}
    del wide
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 18)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size) for i in range(BUCKETED_ROWS)]
    _drive(paged, prompts[:2], 2)                          # warm-up, not counted
    _drive(bucketed, prompts[:2], 2)
    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    programs = paged.prefill_invocations + paged.decode_invocations
    got, paged_wall = _drive(paged, prompts, BUCKETED_NEW)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    programs = paged.prefill_invocations + paged.decode_invocations - programs
    want, bucketed_wall = _drive(bucketed, prompts, BUCKETED_NEW)
    torch.cuda.synchronize()
    check(pa.paged_attention.launches == launches, "the bucketed engine launched the paged kernel")
    check(launches == cfg.num_layers * programs,
          f"serve_bucketed: paged launches {launches} != {cfg.num_layers} x {programs}")
    agree = _streams_agree(params, cfg, prompts, got, want, "paged vs bucketed", bitwise=False)

    # Decode steps at BUCKETED_ROWS rows, one bucket.
    timing = [np.arange(1, BUCKETED_TIMING_LEN + 1, dtype=np.int32) + i
              for i in range(BUCKETED_ROWS)]
    steps = {}
    for name, engine in (("paged", paged), ("bucketed", bucketed)):
        if name == "paged":
            slots = [engine.admit(p, BUCKETED_TIMING_NEW) for p in timing]
            for slot in slots:
                while engine.prefill_step(slot) is None:
                    pass
        else:
            slots = [engine.admit(p, BUCKETED_TIMING_NEW)[0] for p in timing]
            check(len({s.bucket for s in slots}) == 1, "timing rows span buckets")
        _step_host_ms(engine, 2)
        host = _step_host_ms(engine, BUCKETED_TIMING_STEPS)
        if name == "paged":
            args = (paged._dev(paged._last_token), paged._dev(paged._lengths), paged._cache,
                    paged._dev(paged._decode_table_np))
            dev_ms = device_ms(lambda: tt.forward_paged_decode_step(params, *args, kcfg))
        else:
            b = bucketed._buckets[slots[0].bucket]
            args = (bucketed._dev(b.last_token), bucketed._dev(b.lengths), b.cache)
            dev_ms = device_ms(lambda: tt.forward_decode_step(params, *args, cfg))
        steps[name] = {"host_ms": host, "device_ms": dev_ms,
                       "timeline": (paged.max_len if name == "paged" else slots[0].bucket)}
        for slot in slots:
            engine.release(slot)
    gen = BUCKETED_ROWS * BUCKETED_NEW
    row = dict(model="transformer, full width, bf16", card=card, rows=BUCKETED_ROWS,
               buckets=list(bucketed._bucket_lens), kv_pool_tokens=kv_tokens,
               kv_bytes=bucket_bytes, n_pages=paged.pool.n_pages, capacity_6_6=cap,
               concurrency_x=cap["paged_pool_bound"] / max(cap["bucketed"], 1),
               kernel_launches=launches, paged_programs=programs,
               paged_tokens_per_s=gen / paged_wall, bucketed_tokens_per_s=gen / bucketed_wall,
               decode_step=steps, **agree, wall_s=time.perf_counter() - t_phase)
    emit("serve_bucketed", **row)
    check(row["concurrency_x"] >= 2.0, f"paged concurrency {cap} not 2x the bucketed")
    del bucketed, paged
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------- serve_infer
@contextlib.contextmanager
def _plain_conv_stats():
    """The fused conv-stats op's plain version in place of the kernel."""
    kernel = fcs.fused_matmul_stats
    fcs.fused_matmul_stats = fcs.fused_matmul_stats_plain
    try:
        yield
    finally:
        fcs.fused_matmul_stats = kernel


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _infer_case(name, apply_fn, params, batch, plain, plain_ctx, launches, want, card, dev):
    """``InferenceEngine.infer`` of ``apply_fn`` through
    ``AutoDist.build_inference(apply_fn=)``: its kernel's launches in one
    call (``launches()`` against ``want``), finite output held to the plain
    bf16 forward (``plain["bf16"]``, run under ``plain_ctx``) within
    INFER_DRIFT_FACTOR times that forward's distance from ``plain["fp32"]``,
    host and device ms of a call."""
    AutoDist.reset_default()
    engine = AutoDist(device=dev).build_inference(params, apply_fn=apply_fn)
    AutoDist.reset_default()
    engine.infer(batch)                                 # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    out = engine.infer(batch)
    torch.cuda.synchronize()
    n = launches()
    with torch.inference_mode(), plain_ctx():
        ref16, ref32 = plain["bf16"](), plain["fp32"]()
    rel, drift = _rel_l2(out, ref16), _rel_l2(ref16, ref32)
    err = (out.float() - ref16.float()).abs().max().item()
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.infer(batch)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    with plain_ctx():
        plain_ms = time_ms(plain["bf16"], groups=3, per_group=1)
    row = dict(model=name, card=card, shape=list(out.shape), kernel_launches=n,
               expected_launches=want, rel_l2_vs_plain=rel, plain_bf16_vs_fp32=drift,
               bound=INFER_DRIFT_FACTOR * drift, max_abs_err=err,
               host_ms=statistics.median(samples),
               device_ms=device_ms(lambda: engine.infer(batch), calls=3, replays=5),
               plain_ms=plain_ms)
    emit("serve_infer", **row)
    check(n == want, f"{name} infer: {n} kernel launches, want {want}")
    check(bool(torch.isfinite(out).all()), f"{name} infer: non-finite output")
    check(rel <= INFER_DRIFT_FACTOR * drift,
          f"{name} infer: {rel} from the plain forward > {INFER_DRIFT_FACTOR} x {drift}")
    return row


def serve_infer(card: str, dev) -> list:
    """One-shot inference on the card (see the module docstring)."""
    rows = []
    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ)
    cfg = spec.config
    check(tt.resolve_attention_impl(cfg.attention_impl, TRAIN_SEQ, dev, cfg.dtype) == "flash",
          "bert_base at seq 512 does not resolve to flash")
    params = spec.init(SEED + 19, device=dev)
    tokens = spec.example_batch(TRAIN_BATCH, device=dev)["tokens"]
    dot16 = replace(cfg, attention_impl="dot")
    dot32 = replace(dot16, dtype=torch.float32)
    rows.append(_infer_case(
        "bert_base", spec.apply, params, tokens,
        {"bf16": lambda: tt.forward(params, tokens, dot16),
         "fp32": lambda: tt.forward(params, tokens, dot32)},
        contextlib.nullcontext, lambda: fa.flash_fwd.launches, cfg.num_layers, card, dev))
    del params, tokens
    torch.cuda.empty_cache()

    spec = get_model_spec("resnet")
    params = spec.init(SEED + 19, device=dev)
    images = spec.example_batch(INFER_RESNET_BATCH, device=dev)["images"]
    rows.append(_infer_case(
        "resnet50", spec.apply, params, images,
        {"bf16": lambda: rn.forward(params, images, 50),
         "fp32": lambda: rn.forward(params, images, 50, dtype=torch.float32)},
        _plain_conv_stats, lambda: fcs.fused_matmul_stats.launches,
        rn.fused_launches_per_forward(50), card, dev))
    del params, images
    torch.cuda.empty_cache()
    return rows


def _pow2_ranks() -> int:
    """The largest power of two at most min(device_count, 4)."""
    world = 1
    while world * 2 <= min(torch.cuda.device_count(), 4):
        world *= 2
    return world


def _rank_device(rank: int):
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _axis_autodist(axis: str, world: int, rank: int, work: str) -> AutoDist:
    """An AutoDist over a data x ``axis`` mesh with ``axis`` of ``world``."""
    AutoDist.reset_default()
    mesh = {"data": 1, axis: world}
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}], "mesh": mesh})
    return AutoDist(strategy_builder=AllReduce(), resource_spec=spec, device="cuda",
                    init_method=f"file://{work}/pg", world_size=world, rank=rank,
                    timeout_s=DIST_GROUP_TIMEOUT_S, mesh_axes=tuple(mesh))


def _update_rel(params, got: dict, want: dict) -> float:
    """Relative L2 distance of two runs' parameter updates from ``params``."""
    start = flatten_params(params)
    return _rel({n: got[n] - start[n] for n in want}, {n: want[n] - start[n] for n in want})


def _seq_rows(rank: int, world: int, work: str, dev) -> list:
    """This rank's seq_parallel rows (see the module docstring)."""
    rows, plain = [], None
    for impl in ("flash",) + SEQ_IMPLS:
        if impl == "flash" and rank != 0:
            continue
        spec = get_model_spec("transformer", max_seq_len=SEQ_LEN, attention_impl=impl)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(SEQ_BATCH, device=dev)
        if impl == "flash":
            step = _one_process_step(AllReduce(), spec.loss_fn, params, batch, dev, SEQ_OPT)
        else:
            autodist = _axis_autodist("seq", world, rank, work)
            step = autodist.build(spec.loss_fn, params, batch, optimizer=OptimizerSpec(*SEQ_OPT))
        torch.cuda.reset_peak_memory_stats(dev)
        state, losses, ms, launches, _ = _train_window(step, params, batch, SEQ_STEPS, dev)
        logical = {n: t.detach().clone() for n, t in
                   flatten_params(step.logical_params(state)).items()}
        row = dict(attention_impl=impl, seq=SEQ_LEN, batch=SEQ_BATCH, world=world,
                   mesh={"data": 1, "seq": world} if impl != "flash" else {"data": 1},
                   steps=1 + SEQ_STEPS, optimizer=SEQ_OPT, losses=losses, ms_per_step=ms,
                   tokens_per_s=SEQ_BATCH * SEQ_LEN / ms * 1e3,
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   kernel_launches={k: launches[k] for k in ("fwd", "dkdv", "dq")})
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"seq {impl}: losses {losses}")
        layers = spec.config.num_layers
        want = 0 if impl == "ring" and world > 1 else layers * SEQ_STEPS
        for kind in ("fwd", "dkdv", "dq"):
            check(launches[kind] == want, f"seq {impl}: flash {kind} launches "
                  f"{launches[kind]} != {want}")
        if impl == "flash":
            plain = (losses, logical, ms)
        elif rank == 0:
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain[0]))
            update_rel = _update_rel(params, logical, plain[1])
            row.update(flash_losses=plain[0], flash_ms_per_step=plain[2],
                       max_loss_rel_vs_flash=loss_rel, update_rel_l2_vs_flash=update_rel)
            check(loss_rel <= CHECK_LOSS_RTOL, f"seq {impl}: loss rel {loss_rel} vs flash")
            check(update_rel <= CHECK_GLOBAL_RTOL,
                  f"seq {impl}: update rel L2 {update_rel} vs flash")
        rows.append(row)
        del step, state, logical, params
        torch.cuda.empty_cache()
    return rows


def seq_flash_cases(gen: torch.Generator, dev) -> list:
    """The flash kernels at seq_parallel's shapes: SEQ_BATCH x SEQ_LEN,
    causal, bf16, with the flagship's heads (flash, and ring and Ulysses on
    a seq axis of 1) and with one Ulysses head group on SEQ_CHUNKS cards."""
    heads = get_model_spec("transformer", max_seq_len=SEQ_LEN).config.num_heads
    return [r for h in (heads, heads // SEQ_CHUNKS)
            for r in flash_case(SEQ_LEN, True, torch.bfloat16, gen, dev, SEQ_BATCH, h)]


def chunk_merge_check(card: str, dev) -> list:
    """The ring's inner arithmetic on the card with no collective:
    ``_chunk_merge`` over SEQ_CHUNKS chunks of a SEQ_LEN-token bf16
    sequence, each query chunk merging the key chunks in ring order (``r,
    r-1, ...``, the causal ones above the diagonal skipped), against the
    plain attention in fp32 on the same bf16 inputs, element by element.

    Bound, with ``u = 2^-8`` bf16's unit roundoff and ``a = Σ p|v| / l``
    (the plain attention of ``|v|``): rounding ``p`` to bf16 before ``p·v``
    moves the output by at most ``u·a``; rounding the output to bf16 by
    ``u·|out|/(1-u)``; the fp32 logits and sums of both sides (up to
    SEQ_LEN terms, 2^-24 each) by less than ``2^-10·a``. So
    ``|err| <= u(1+2^-7)·max(|got|, |want|) + (u + 2^-10)·a``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, d, n = 1, 12, 64, SEQ_CHUNKS
    q, k, v = (torch.randn(b, SEQ_LEN, h, d, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    c = SEQ_LEN // n
    u = 2.0 ** -8
    rows = []
    for causal in (False, True):
        def ring_order():
            outs = []
            for r in range(n):
                m = torch.full((b, h, c, 1), -1e30, dtype=torch.float32, device=dev)
                l = torch.zeros((b, h, c, 1), dtype=torch.float32, device=dev)
                acc = torch.zeros((b, h, c, d), dtype=torch.float32, device=dev)
                for t in range(n):
                    j = (r - t) % n
                    if causal and j > r:
                        continue
                    m, l, acc = chunk_merge(
                        q[:, r * c:(r + 1) * c], k[:, j * c:(j + 1) * c],
                        v[:, j * c:(j + 1) * c], r * c, j * c, causal, d ** -0.5, m, l, acc)
                outs.append((acc / l).to(torch.bfloat16).permute(0, 2, 1, 3))
            return torch.cat(outs, dim=1)

        with torch.no_grad():
            got = ring_order().float()
            want = fa.mha_reference(q.float(), k.float(), v.float(), causal)
            a = fa.mha_reference(q.float(), k.float(), v.float().abs(), causal)
            diff = (got - want).abs()
            bound = (u * (1 + 2.0 ** -7) * torch.maximum(got.abs(), want.abs())
                     + (u + 2.0 ** -10) * a)
            err = diff.max().item()
            over = (diff / bound.clamp_min(1e-30)).max().item()
            del got, want, a, diff, bound
            ms = time_ms(ring_order, groups=3, per_group=2)
        row = dict(seq=SEQ_LEN, chunks=n, causal=causal, dtype="bfloat16", max_abs_err=err,
                   err_over_bound=over, ms=ms, card=card)
        emit("seq_chunk_merge", **row)
        check(over <= 1.0, f"chunk merge (causal={causal}): worst err/bound {over} > 1 "
              f"(max |err| {err})")
        rows.append(row)
    return rows


def _pipe_stages(world: int) -> int:
    """PIPE_STAGES on one card or four; as many as the cards otherwise."""
    return PIPE_STAGES if world in (1, PIPE_STAGES) else world


def _bert_stages(dev, stages: int, dtype: str = "bfloat16"):
    """bert_base (seq TRAIN_SEQ, computing in ``dtype``) as ``stages`` stages
    of its blocks: ``(stacked params, stage_fn, loss_head, x, targets,
    config)``. ``x`` is the embedding of the masked batch (outside the
    pipeline, not trained); the loss head is the MLM loss over the fixed
    tied table."""
    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash",
                          dtype=dtype)
    cfg = spec.config
    params = spec.init(SEED, device=dev)
    per = cfg.num_layers // stages
    stacked = {f"block_{j}": map_params(lambda *xs: torch.stack(xs), *[
        params[f"layers_{s * per + j}"] for s in range(stages)]) for j in range(per)}

    def stage_fn(p, h):
        for j in range(per):
            h = tt._block(p[f"block_{j}"], h, cfg)
        return h

    batch = spec.example_batch(TRAIN_BATCH, device=dev)
    mask = batch["mlm_mask"].bool()
    inputs = torch.where(mask, torch.full_like(batch["tokens"], cfg.mlm_mask_token),
                         batch["tokens"])
    with torch.no_grad():
        x = L.embedding_lookup(params["embed"], inputs).to(cfg.dtype)
        pos = torch.arange(TRAIN_SEQ, device=dev)
        x = x + L.embedding_lookup(params["pos_embed"], pos).to(cfg.dtype)
    head = {"ln_f": params["ln_f"], "embed": params["embed"]}

    def loss_head(o, t):
        labels, m = t
        per_tok = L.per_token_xent(tt._logits(head, o, cfg).float(), labels) * m
        return per_tok.sum() / torch.clamp(m.sum(), min=1.0)

    return stacked, stage_fn, loss_head, x, (batch["labels"], mask.float()), cfg


def _pipe_plain(stage_fn, loss_head, stacked, x, tgt, steps: int, stages: int):
    """The plain sequential step by hand: each microbatch through the stages
    one after another, the mean of the microbatch losses, SGD (PIPE_LR).
    ``(losses, flat params, ms a step after the first)``."""
    params = map_params(lambda t: t.detach().clone(), stacked)
    mb = x.shape[0] // PIPE_MICRO
    losses, dev = [], x.device
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        leaves = {n: t.requires_grad_(True) for n, t in flatten_params(params).items()}
        p = unflatten_params(leaves)
        total = 0.0
        for m in range(PIPE_MICRO):
            h = x[m * mb:(m + 1) * mb]
            for s in range(stages):
                h = stage_fn(map_params(lambda a, i=s: a[i], p), h)
            total = total + loss_head(h, tuple(t[m * mb:(m + 1) * mb] for t in tgt))
        loss = total / PIPE_MICRO
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params = unflatten_params({n: t.detach() - PIPE_LR * g for (n, t), g in
                                       zip(leaves.items(), grads)})
        losses.append(loss.item())
    torch.cuda.synchronize(dev)
    return losses, flatten_params(params), (time.perf_counter() - t0) / (steps - 1) * 1e3


def _pipe_sequential(stage_fn, loss_head, stacked, x, tgt, dev) -> float:
    """ms a step of the port's sequential fallback, what ``build_pipeline``
    runs on one card (a PipelineTrainStep over a mesh with no pipe axis),
    over PIPE_STEPS steps after one warm-up step."""
    tx = OptimizerSpec("sgd", {"learning_rate": PIPE_LR}).make()
    step = par.PipelineTrainStep(stage_fn, loss_head, tx, PIPE_MICRO,
                                 mesh=Mesh.logical({"data": 1}, device=dev))
    state, _ = step(step.init(stacked), (x, tgt))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(PIPE_STEPS):
        state, _ = step(state, (x, tgt))
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / PIPE_STEPS * 1e3


def _schedule_memory(stage_fn, loss_head, stacked, x, tgt, dev, group_mesh) -> dict:
    """Peak memory (GB above the state held before) and ms of one call of
    each schedule on this rank: gpipe and 1f1b through ``pipeline_apply`` and
    a backward of the mean microbatch loss, the interleaved loop through
    ``pipeline_value_and_grad``."""
    out = {}
    mb = x.shape[0] // PIPE_MICRO

    def split_loss(y):
        return sum(loss_head(y[m * mb:(m + 1) * mb], tuple(t[m * mb:(m + 1) * mb] for t in tgt))
                   for m in range(PIPE_MICRO)) / PIPE_MICRO

    def gpipe_like(schedule):
        leaves = map_params(lambda t: t.detach().clone().requires_grad_(True), stacked)
        y = par.pipeline_apply(stage_fn, leaves, x, PIPE_MICRO, mesh=group_mesh,
                               schedule=schedule)
        split_loss(y).backward()

    runs = {"gpipe": lambda: gpipe_like("gpipe"), "1f1b": lambda: gpipe_like("1f1b"),
            "interleaved": lambda: par.pipeline_value_and_grad(
                stage_fn, stacked, x, loss_head, PIPE_MICRO, targets=tgt, mesh=group_mesh)}
    for name, fn in runs.items():
        fn()                                        # warm-up
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out[name] = {"peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
                     "ms": (time.perf_counter() - t0) * 1e3}
    return out


def _pipe_row(rank: int, world: int, work: str, dev) -> dict:
    """This rank's pipeline row (see the module docstring)."""
    stages = _pipe_stages(world)
    stacked, stage_fn, loss_head, x, tgt, cfg = _bert_stages(dev, stages)
    plain = _pipe_plain(stage_fn, loss_head, stacked, x, tgt, 1 + PIPE_STEPS, stages) \
        if rank == 0 else None
    seq_ms = _pipe_sequential(stage_fn, loss_head, stacked, x, tgt, dev) \
        if rank == 0 and world > 1 else None
    autodist = _axis_autodist("pipe", world, rank, work)
    step = autodist.build_pipeline(stage_fn, loss_head, PIPE_MICRO,
                                   optimizer=OptimizerSpec("sgd", {"learning_rate": PIPE_LR}))
    state = step.init(stacked)
    state, first = step(state, (x, tgt))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    losses = [float(first["loss"])]
    for _ in range(PIPE_STEPS):
        state, m = step(state, (x, tgt))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / PIPE_STEPS * 1e3
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    logical = flatten_params(step.logical_params(state))
    per = cfg.num_layers // stages
    if world == 1:          # the sequential fallback: every block once a step
        want = {kind: cfg.num_layers * PIPE_STEPS for kind in ("fwd", "dkdv", "dq")}
    else:                   # the interleaved loop recomputes each block's forward
        want = {"fwd": 2 * per * PIPE_MICRO * PIPE_STEPS,
                "dkdv": per * PIPE_MICRO * PIPE_STEPS, "dq": per * PIPE_MICRO * PIPE_STEPS}
    check(launches == want, f"pipeline: flash launches {launches} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"pipeline: losses {losses}")
    row = dict(model="bert_base", seq=TRAIN_SEQ, batch=TRAIN_BATCH, stages=stages,
               blocks_per_stage=per, microbatches=PIPE_MICRO, world=world,
               mesh={"data": 1, "pipe": world}, steps=1 + PIPE_STEPS,
               optimizer=f"sgd {PIPE_LR}", losses=losses, ms_per_step=ms, peak_mem_gb=peak,
               kernel_launches=launches)
    if world > 1:
        row["schedules"] = _schedule_memory(stage_fn, loss_head, stacked, x, tgt, dev,
                                            autodist.mesh)
    if rank == 0:
        plain_losses, plain_params, plain_ms = plain
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        update_rel = _update_rel(stacked, logical, plain_params)
        row.update(plain_losses=plain_losses, plain_ms_per_step=plain_ms,
                   max_loss_rel_vs_plain=loss_rel, update_rel_l2_vs_plain=update_rel,
                   sequential_ms_per_step=ms if world == 1 else seq_ms)
        if world > 1:       # 1 - (the sequential step's share of a card) / the pipeline's
            row["bubble_vs_sequential"] = 1.0 - seq_ms / (world * ms)
        check(loss_rel <= CHECK_LOSS_RTOL, f"pipeline: loss rel {loss_rel} vs plain")
        check(update_rel <= CHECK_GLOBAL_RTOL, f"pipeline: update rel L2 {update_rel}")
    return row


def parallel_rank(rank: int, world: int, work: str) -> int:
    """One NCCL rank of seq_parallel, then of pipeline, in one group."""
    dev = _rank_device(rank)
    out = {"seq": _seq_rows(rank, world, work, dev), "pipe": _pipe_row(rank, world, work, dev)}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def parallel_train(card: str, dev):
    """The seq_parallel and pipeline phases: one NCCL rank a card (started
    once for both), then the chunk merge on cuda:0. Returns rank 0's
    seq_parallel rows and every rank's pipeline row."""
    world = _pow2_ranks()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--parallel-rank", world, work, dict(os.environ))
    seconds = time.perf_counter() - t0
    seq_rows, pipe_rows = ranks[0]["seq"], [r["pipe"] for r in ranks]
    for row in seq_rows:
        emit("seq_parallel", **row, ranks_seconds=seconds, card=card)
    for row in pipe_rows:
        emit("pipeline", **row, ranks_seconds=seconds, card=card)
    chunk_merge_check(card, dev)
    return seq_rows, pipe_rows


# ---------------------------------------------------- the CPU rehearsal
def _par_attn_inputs():
    gen = torch.Generator().manual_seed(SEED)
    return tuple(torch.randn(2, 32, 4, 8, generator=gen) for _ in range(4))


def _par_pipe_inputs(stages: int):
    gen = torch.Generator().manual_seed(SEED + stages)
    params = {"w1": torch.randn(stages, 8, 16, generator=gen) * 0.3,
              "w2": torch.randn(stages, 16, 8, generator=gen) * 0.3,
              "b": torch.randn(stages, 8, generator=gen) * 0.1}
    return params, torch.randn(16, 8, generator=gen), torch.randn(16, 8, generator=gen)


def _par_stage(p, h):
    return torch.tanh(torch.tanh(h @ p["w1"]) @ p["w2"] + p["b"])


def _par_head(o, t):
    return torch.mean((o - t) ** 2)


def _par_attention(impl, causal, mesh, q, k, v, g):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn = par.ring_attention if impl == "ring" else par.ulysses_attention
    out = fn(*leaves, causal=causal, mesh=mesh)
    torch.sum(out * g).backward()
    return [out.detach()] + [t.grad for t in leaves]


def _par_pipeline(mesh, params, x, tgt, stage: int):
    """Each schedule's output (the interleaved loop's loss), ``x``'s
    gradient and the stage slice ``stage`` of each stacked gradient."""
    out = {}
    for schedule in ("gpipe", "1f1b"):
        leaves = map_params(lambda t: t.clone().requires_grad_(True), params)
        xx = x.clone().requires_grad_(True)
        y = par.pipeline_apply(_par_stage, leaves, xx, 4, mesh=mesh, schedule=schedule)
        torch.sum(y ** 2).backward()
        out[schedule] = [y.detach(), xx.grad] + [t.grad[stage] for t in leaves.values()]
    loss, grads, gx = par.pipeline_value_and_grad(_par_stage, params, x, _par_head, 4,
                                                  targets=tgt, mesh=mesh)
    out["interleaved"] = [loss, gx] + [grads[n][stage] for n in params]
    return out


def _par_tiny_transformer(impl):
    spec = get_model_spec("transformer", vocab_size=64, num_layers=2, d_model=32,
                          num_heads=4, d_ff=64, max_seq_len=16, attention_impl=impl,
                          dtype="float32")
    return spec, spec.init(SEED, device="cpu"), spec.example_batch(8, device="cpu")


def parallel_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of parallel_rehearsal."""
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    pg.join(cpu, f"file://{work}/pg", world, rank, DIST_GROUP_TIMEOUT_S)
    out = {}

    def mesh_of(shape):
        spec = ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": world, "chief": True}], "mesh": shape})
        return build_mesh(spec, device=cpu, group=torch.distributed.group.WORLD,
                          axes=tuple(shape))

    seq4 = mesh_of({"data": 1, "seq": world})
    q, k, v, g = _par_attn_inputs()
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            out[f"{impl}/{causal}"] = [t.tolist() for t in
                                       _par_attention(impl, causal, seq4, q, k, v, g)]
    for shape in ({"data": 1, "pipe": world}, {"data": 2, "pipe": world // 2}):
        mesh = mesh_of(shape)
        params, x, tgt = _par_pipe_inputs(shape["pipe"])
        stage = mesh.coords["pipe"]
        res = _par_pipeline(mesh, params, x, tgt, stage)
        out[f"pipe{shape['pipe']}"] = {"stage": stage, **{
            k: [t.tolist() if torch.is_tensor(t) else t for t in vals]
            for k, vals in res.items()}}
        AutoDist.reset_default()
        spec = ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": world, "chief": True}], "mesh": shape})
        autodist = AutoDist(resource_spec=spec, device="cpu", mesh_axes=tuple(shape))
        step = autodist.build_pipeline(_par_stage, _par_head, 4, optimizer=OptimizerSpec(
            "sgd", {"learning_rate": REHEARSAL_LR}))
        state, metrics = step.run(step.init(params), (x, tgt), REHEARSAL_STEPS)
        out[f"step/pipe{shape['pipe']}"] = {
            "losses": metrics["loss"].tolist(),
            "params": {n: t.tolist() for n, t in step.logical_params(state).items()}}
    for impl in ("ring", "ulysses"):
        spec, params, batch = _par_tiny_transformer(impl)
        AutoDist.reset_default()
        shape = {"data": 2, "seq": world // 2}
        autodist = AutoDist(strategy_builder=AllReduce(), device="cpu", mesh_axes=tuple(shape),
                            resource_spec=ResourceSpec(resource_dict={"nodes": [
                                {"address": "localhost", "gpus": world, "chief": True}],
                                "mesh": shape}))
        step = autodist.build(spec.loss_fn, params, batch,
                              optimizer=OptimizerSpec("sgd", {"learning_rate": REHEARSAL_LR}))
        state, metrics = step.run(step.init(params), batch, REHEARSAL_STEPS)
        out[f"transformer/{impl}"] = {
            "losses": metrics["loss"].tolist(),
            "params": {n: t.tolist() for n, t in
                       flatten_params(step.logical_params(state)).items()}}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def _close(got, want, what: str) -> float:
    got = torch.as_tensor(got, dtype=torch.float32)
    want = torch.as_tensor(want, dtype=torch.float32)
    check(got.shape == want.shape and torch.allclose(got, want, rtol=REHEARSAL_RTOL,
                                                     atol=REHEARSAL_ATOL),
          f"parallel rehearsal: {what} differs from one process")
    return (got - want).abs().max().item()


def parallel_rehearsal() -> dict:
    """4 gloo ranks on the CPU against one process (see the module docstring)."""
    t0 = time.perf_counter()
    cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--parallel-cpu-rank", REHEARSAL_RANKS, work, cpu_env)
    worst = {}
    q, k, v, g = _par_attn_inputs()
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = fa.mha_reference(*leaves, causal)
            torch.sum(want * g).backward()
            want = [want.detach()] + [t.grad for t in leaves]
            key = f"{impl}/{causal}"
            worst[key] = max(_close(got, w, f"{key} rank {r}") for r, res in enumerate(ranks)
                             for got, w in zip(res[key], want))
    for pipe in (REHEARSAL_RANKS, REHEARSAL_RANKS // 2):
        params, x, tgt = _par_pipe_inputs(pipe)
        one = Mesh.logical({"data": 1})              # no pipe axis: the stages in turn
        key = f"pipe{pipe}"
        for r, res in enumerate(ranks):
            want = _par_pipeline(one, params, x, tgt, res[key]["stage"])
            for sched, vals in want.items():
                worst[f"{key}/{sched}"] = max(
                    worst.get(f"{key}/{sched}", 0.0),
                    max(_close(got, w, f"{key}/{sched} rank {r}")
                        for got, w in zip(res[key][sched], vals)))
        plain = map_params(lambda t: t.clone(), params)
        losses = []
        for _ in range(REHEARSAL_STEPS):
            loss, grads, _ = par.pipeline_value_and_grad(_par_stage, plain, x, _par_head, 4,
                                                         targets=tgt, mesh=one)
            plain = map_params(lambda p, gg: p - REHEARSAL_LR * gg, plain, grads)
            losses.append(float(loss))
        for r, res in enumerate(ranks):
            got = res[f"step/{key}"]
            _close(got["losses"], losses, f"step/{key} losses rank {r}")
            worst[f"step/{key}"] = max(_close(got["params"][n], t, f"step/{key} {n} rank {r}")
                                       for n, t in plain.items())
    for impl in ("ring", "ulysses"):
        spec, params, batch = _par_tiny_transformer("dot")
        step = _one_process_step(AllReduce(), spec.loss_fn, params, batch, torch.device("cpu"),
                                 ("sgd", {"learning_rate": REHEARSAL_LR}))
        state, metrics = step.run(step.init(params), batch, REHEARSAL_STEPS)
        want = flatten_params(step.logical_params(state))
        for r, res in enumerate(ranks):
            got = res[f"transformer/{impl}"]
            _close(got["losses"], metrics["loss"], f"transformer/{impl} losses rank {r}")
            worst[f"transformer/{impl}"] = max(
                _close(got["params"][n], t, f"transformer/{impl} {n} rank {r}")
                for n, t in want.items())
    row = dict(note="gloo on the CPU: a rehearsal, not a card result", ranks=REHEARSAL_RANKS,
               torch=torch.__version__, max_abs_diff_vs_one_process=worst,
               rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL, seconds=time.perf_counter() - t0)
    emit("parallel_rehearsal", **row)
    return row


# ------------------------------------------------------------ three_axis
def _plan_splits(model: str, overrides: dict, batch: int, mesh: dict, dev) -> dict:
    """``{name: (axis, dim)}`` of the variables TensorParallel's plan splits
    at ``mesh`` (a logical mesh), the zoo's expert names given."""
    from autodist_tpu_torch.strategy import explain as ex

    item = ex.model_item_for(model, batch, dev, **overrides)
    rs = ResourceSpec(resource_dict={"nodes": [{"address": "localhost",
                                                "gpus": int(np.prod(list(mesh.values())))}],
                                     "mesh": mesh})
    strategy = StrategyCompiler(item).compile(from_name("TensorParallel").build(item, rs))
    plan = GraphTransformer(strategy, item, Mesh.logical(mesh)).transform()
    return {n: (plan.var_plans[n].storage_axis, plan.rendering(n)[1]) for n in plan.var_plans
            if plan.rendering(n)[0] in ("partitioned", "expert")}


def _placer(splits: dict):
    """``placements(mesh, name)`` of a plan's splits: ``Shard(dim)`` on the
    variable's own axis's dim, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    from autodist_tpu_torch.utils.placement import placement_list

    def placements(mesh, name):
        axis, dim = splits.get(name, (None, None))
        return placement_list(mesh, axis, Shard(dim) if axis else Replicate())
    return placements


def _seq_rig(dev) -> Mesh:
    """A mesh that names a seq axis of 2 over a one-rank seq group (and a
    model axis of 1): on one card it sends ``ring_attention`` and
    ``ulysses_attention`` through their seq-parallel route, where this
    rank's chunk is the whole sequence."""
    from torch.distributed.device_mesh import DeviceMesh

    dmesh = DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int),
                       mesh_dim_names=("seq", "model"))
    return Mesh(axis_names=("data", "seq", "model"), shape={"data": 1, "seq": 2, "model": 1},
                rank=0, device=dev, group=None, device_mesh=dmesh)


def _three_axis_placed(dev) -> dict:
    """three_axis at one card: the placed checks (see the module
    docstring)."""
    out = {}
    moe = get_model_spec("moe_transformer")
    params = moe.init(SEED, device=dev)
    batch = moe.example_batch(THREE_MOE_BATCH, device=dev)
    splits = _plan_splits("moe_transformer", {}, THREE_MOE_BATCH, THREE_ME, dev)
    run = _placed_run(moe.loss_fn, params, batch, ("model", "expert"), _placer(splits), dev)
    out["moe_model2expert2"] = dict(run, split_vars=collections.Counter(
        ax for ax, _ in splits.values()))
    del params, batch
    bert = {"max_seq_len": TRAIN_SEQ}
    splits = _plan_splits("bert_base", dict(bert, attention_impl="flash"), THREE_BERT_BATCH,
                          {"data": 1, "model": 2}, dev)
    rig = _seq_rig(dev)
    for impl in SEQ_IMPLS:
        spec = get_model_spec("bert_base", **bert, attention_impl=impl)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(THREE_BERT_BATCH, device=dev)
        AutoDist.reset_default()
        autodist = AutoDist(device="cuda")
        autodist._mesh = rig
        out[f"bert_base_{impl}_seq_model"] = dict(
            _placed_run(spec.loss_fn, params, batch, ("model",), _placer(splits), dev),
            split_vars=len(splits))
        AutoDist.reset_default()
        del params, batch
    # bert_base's heads split on model and whole over expert: the flash
    # kernels under local_map on the two-dim mesh.
    splits = _plan_splits("bert_base", dict(bert, attention_impl="flash"), THREE_BERT_BATCH,
                          THREE_ME, dev)
    spec = get_model_spec("bert_base", **bert, attention_impl="flash")
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(THREE_BERT_BATCH, device=dev)
    out["bert_base_flash_model2expert2"] = dict(
        _placed_run(spec.loss_fn, params, batch, ("model", "expert"), _placer(splits), dev),
        split_vars=collections.Counter(ax for ax, _ in splits.values()))
    del params, batch
    model, overrides, _, _ = PUBLISHED["resnet50"]
    spec = get_model_spec(model, **overrides)
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(THREE_RESNET_BATCH, device=dev)
    splits = _plan_splits(model, overrides, THREE_RESNET_BATCH, THREE_ME, dev)
    out["resnet50_model2expert2"] = dict(
        _placed_run(spec.loss_fn, params, batch, ("model", "expert"), _placer(splits), dev),
        split_vars=collections.Counter(ax for ax, _ in splits.values()))
    torch.cuda.empty_cache()
    return out


def _mesh_autodist(mesh: dict, builder, world: int, rank: int, work: str) -> AutoDist:
    """An AutoDist over ``mesh`` (one NCCL rank a card)."""
    AutoDist.reset_default()
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}], "mesh": mesh})
    return AutoDist(strategy_builder=builder, resource_spec=spec, device="cuda",
                    init_method=f"file://{work}/pg", world_size=world, rank=rank,
                    timeout_s=DIST_GROUP_TIMEOUT_S, mesh_axes=tuple(mesh))


def _three_inputs(kind: str, impl, dtype: str, dev):
    """``(build(autodist, opt) -> step, params, batch, one(opt) -> the
    one-process step, flip(batch) -> its rows reversed)`` of a three_axis
    model: the MoE and bert_base through ``AutoDist.build``, the bert_base
    stage stack through ``build_pipeline``."""
    if kind == "stages":
        stacked, stage_fn, loss_head, x, tgt, _ = _bert_stages(dev, 2, dtype)

        def build(autodist, opt):
            return autodist.build_pipeline(stage_fn, loss_head, PIPE_MICRO,
                                           optimizer=OptimizerSpec(*opt))

        def one(opt):
            return par.PipelineTrainStep(stage_fn, loss_head, OptimizerSpec(*opt).make(),
                                         PIPE_MICRO, mesh=Mesh.logical({"data": 1}, device=dev))

        return build, stacked, (x, tgt), one, lambda b: (b[0].flip(0),
                                                         tuple(t.flip(0) for t in b[1]))
    if kind == "moe":
        spec = get_model_spec("moe_transformer", dtype=dtype)
        size, experts = THREE_MOE_BATCH, ("expert_",)
    else:
        spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl=impl,
                              dtype=dtype)
        size, experts = THREE_BERT_BATCH, ()
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(size, device=dev)
    # The one-process step has no seq group: bert_base's computes flash.
    plain = spec if kind == "moe" else get_model_spec(
        "bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash", dtype=dtype)

    def build(autodist, opt):
        return autodist.build(spec.loss_fn, params, batch, optimizer=OptimizerSpec(*opt),
                              expert_names=experts)

    def one(opt):
        return _one_process_step(AllReduce(), plain.loss_fn, params, batch, dev, opt)

    return build, params, batch, one, lambda b: {k: v.flip(0) for k, v in b.items()}


def _flat(step, state) -> dict:
    return {n: t.detach().clone() for n, t in flatten_params(step.logical_params(state)).items()}


def _three_axis_row(cid, kind, mesh, builder, impl, world, rank, work, dev) -> dict:
    """One 2 x 2 mesh of three_axis on four cards (see the module
    docstring): the bf16 steps and one fp32 SGD step against the
    one-process step."""
    build, params, batch, one, flip = _three_inputs(kind, impl, "float32", dev)
    fp32 = []
    for b in (batch, flip(batch)):
        step = one(THREE_SGD)
        state, _ = step(step.init(params), b)
        fp32.append(_flat(step, state))
        del step, state
    step = build(_mesh_autodist(mesh, from_name(builder or "AllReduce"), world, rank,
                                work), THREE_SGD)
    state, _ = step(step.init(params), batch)
    got = _flat(step, state)
    spread = _update_rel(params, fp32[1], fp32[0])
    sgd = dict(update_rel_l2=_update_rel(params, got, fp32[0]),
               reversed_rows_update_rel_l2=spread, bound=max(THREE_UPDATE_RTOL, 2 * spread))
    del step, state, got, fp32, params, batch
    torch.cuda.empty_cache()
    build, params, batch, _, _ = _three_inputs(kind, impl, "bfloat16", dev)
    autodist = _mesh_autodist(mesh, from_name(builder or "AllReduce"), world, rank, work)
    step = build(autodist, THREE_BF16_OPT)
    state, losses, ms, launches, wire = _train_window(step, params, batch, THREE_STEPS, dev) \
        if kind != "stages" else _pipe_window(step, params, batch, THREE_STEPS, dev)
    row = dict(id=cid, model=kind, attention_impl=impl, mesh=mesh, builder=builder or
               "build_pipeline", world=world, steps=1 + THREE_STEPS, losses=losses,
               ms_per_step=ms, kernel_launches=launches, collectives=wire,
               dtensor_by_axis={ax: sum(wire.get(ax, {}).values())
                                for ax in ("model", "expert")}, fp32_sgd=sgd)
    if kind != "stages":
        row["predicted_wire"] = autodist.plan.collectives_per_step()
    del step, state, params, batch
    torch.cuda.empty_cache()
    return row


def _pipe_window(step, stacked, batch, steps, dev):
    """``_train_window`` of a pipeline step (it has no collective count)."""
    state, first = step(step.init(stacked), batch)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    losses = [float(first["loss"])]
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    return state, losses, ms, {"fused_conv_stats": 0, **_launch_counts()}, {}


def _baseline_ms(kind, impl, mesh, builder, world, rank, work, dev) -> float:
    """ms a bf16 step of a model on a baseline mesh (data 4, or the
    two-axis mesh a 2 x 2 one extends)."""
    build, params, batch, _, _ = _three_inputs(kind, impl, "bfloat16", dev)
    step = build(_mesh_autodist(mesh, from_name(builder or "AllReduce"), world, rank,
                                work), THREE_BF16_OPT)
    window = _pipe_window if kind == "stages" else _train_window
    _, _, ms, _, _ = window(step, params, batch, THREE_STEPS, dev)
    del step, params, batch
    torch.cuda.empty_cache()
    return ms


def three_axis_rank(rank: int, world: int, work: str) -> int:
    """One NCCL rank of three_axis: the placed checks below four cards, the
    2 x 2 meshes and their baselines on four."""
    dev = _deterministic(rank)
    if world < 4:
        AutoDist.reset_default()
        AutoDist(device="cuda", init_method=f"file://{work}/pg", world_size=world, rank=rank,
                 timeout_s=DIST_GROUP_TIMEOUT_S)
        out = {"placed": _three_axis_placed(dev) if rank == 0 else None}
    else:
        out = {"meshes": [_three_axis_row(*case, world, rank, work, dev)
                          for case in THREE_MESHES],
               "baselines": [dict(kind=kind, impl=impl, mesh=mesh, builder=builder,
                                  ms_per_step=_baseline_ms(kind, impl, mesh, builder, world,
                                                           rank, work, dev))
                             for kind, impl, mesh, builder in THREE_BASELINES]}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def three_axis(card: str) -> dict:
    """The three_axis phase (see the module docstring). Returns rank 0's
    results."""
    torch.cuda.empty_cache()
    world = _pow2_ranks()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        res = _spawn_ranks("--three-axis-rank", world, work,
                           dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))[0]
    seconds = time.perf_counter() - t0
    if world < 4:
        placed = res["placed"]
        emit("three_axis", world=world, placed=placed, process_seconds=seconds, card=card)
        layers = get_model_spec("bert_base").config.num_layers
        for key, run in placed.items():
            check(run["bitwise"], f"three_axis: {key} placed is not bitwise the plain run "
                  f"({run['grads_differ']} of {run['grads']} gradients differ, worst rel "
                  f"{run['worst_grad_rel']})")
        check(placed["moe_model2expert2"]["split_vars"].get("expert", 0) > 0
              and placed["moe_model2expert2"]["split_vars"].get("model", 0) > 0,
              f"three_axis: MoE splits {placed['moe_model2expert2']['split_vars']}")
        want = {"fwd": layers, "dkdv": layers, "dq": layers}
        for key in ("bert_base_ulysses_seq_model", "bert_base_flash_model2expert2"):
            got = {k: placed[key]["kernel_launches"][k] for k in want}
            check(got == want, f"three_axis: {key} flash launches {got} != {want}")
        check(set(placed["bert_base_flash_model2expert2"]["split_vars"]) == {"model"},
              f"three_axis: bert_base splits {placed['bert_base_flash_model2expert2']}")
        check(placed["resnet50_model2expert2"]["kernel_launches"]["fused_conv_stats"]
              == rn.fused_launches_per_forward(50),
              f"three_axis: ResNet-50 fused launches {placed['resnet50_model2expert2']}")
        return res
    rows = res["meshes"]
    for row in rows:
        emit("three_axis", **row, card=card)
        losses, sgd = row["losses"], row["fp32_sgd"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"three_axis {row['id']}: bf16 losses {losses}")
        check(sgd["update_rel_l2"] <= sgd["bound"], f"three_axis {row['id']}: fp32 SGD {sgd}")
        if "predicted_wire" in row:
            check(_wire(row["collectives"]) == row["predicted_wire"],
                  f"three_axis {row['id']}: wire {row['collectives']}")
    emit("three_axis_baselines", baselines=res["baselines"], process_seconds=seconds,
         card=card)
    return res


# ------------------------------------------- the three-axis CPU rehearsal
def _three_cpu_inputs(key: str):
    """(loss, params, batch, reference loss) of a three_axis_rehearsal model
    at its toy width, from the seed, on the CPU: the small transformer or
    MoE with the case's attention (the reference computes ``dot``)."""
    model, impl = key.split("/")
    over = dict(THREE_TOY, dtype="float32")
    if model == "moe":
        over.update(num_experts=4, max_seq_len=17, capacity_factor=4.0, aux_loss_weight=0.0)
    spec = get_model_spec("moe_transformer" if model == "moe" else "transformer",
                          **over, attention_impl=impl)
    ref = get_model_spec("moe_transformer" if model == "moe" else "transformer",
                         **over, attention_impl="dot")
    cpu = torch.device("cpu")
    return spec.loss_fn, spec.init(SEED, device=cpu), spec.example_batch(8, device=cpu), \
        ref.loss_fn


def three_axis_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of three_axis_rehearsal."""
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    pg.join(cpu, f"file://{work}/pg", world, rank, DIST_GROUP_TIMEOUT_S)
    out = {}
    for cid, key, builder, mesh, experts in THREE_REHEARSAL:
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=from_name(builder or "AllReduce"),
                            device="cpu", mesh_axes=tuple(mesh),
                            resource_spec=ResourceSpec(resource_dict={"nodes": [
                                {"address": "localhost", "gpus": world, "chief": True}],
                                "mesh": mesh}))
        opt = OptimizerSpec("sgd", {"learning_rate": REHEARSAL_LR})
        if key == "pipeline":
            params, x, tgt = _par_pipe_inputs(mesh["pipe"])
            step = autodist.build_pipeline(_par_stage, _par_head, 4, optimizer=opt)
            state, metrics = step.run(step.init(params), (x, tgt), REHEARSAL_STEPS)
            logical = step.logical_params(state)
        else:
            loss, params, batch, _ = _three_cpu_inputs(key)
            step = autodist.build(loss, params, batch, optimizer=opt, expert_names=experts)
            state, metrics = step.run(step.init(params), batch, REHEARSAL_STEPS)
            logical = flatten_params(step.logical_params(state))
        out[cid] = {"losses": metrics["loss"].tolist(),
                    "params": {n: t.tolist() for n, t in logical.items()}}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def three_axis_rehearsal() -> dict:
    """8 gloo ranks on the CPU against one process (see the module
    docstring)."""
    t0 = time.perf_counter()
    cpu, cpu_env = torch.device("cpu"), dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                              OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--three-axis-cpu-rank", THREE_REHEARSAL_RANKS, work, cpu_env)
    worst = {}
    opt = ("sgd", {"learning_rate": REHEARSAL_LR})
    for cid, key, _, mesh, _ in THREE_REHEARSAL:
        if key == "pipeline":
            params, x, tgt = _par_pipe_inputs(mesh["pipe"])
            step = par.PipelineTrainStep(_par_stage, _par_head, OptimizerSpec(*opt).make(), 4,
                                         mesh=Mesh.logical({"data": 1}))
            state, metrics = step.run(step.init(params), (x, tgt), REHEARSAL_STEPS)
            want = step.logical_params(state)
        else:
            _, params, batch, ref = _three_cpu_inputs(key)
            step = _one_process_step(AllReduce(), ref, params, batch, cpu, opt)
            state, metrics = step.run(step.init(params), batch, REHEARSAL_STEPS)
            want = flatten_params(step.logical_params(state))
        for r, res in enumerate(ranks):
            got = res[cid]
            _close(got["losses"], metrics["loss"], f"three-axis {cid} losses rank {r}")
            worst[cid] = max(worst.get(cid, 0.0), max(
                _close(got["params"][n], t, f"three-axis {cid} {n} rank {r}")
                for n, t in want.items()))
    row = dict(note="gloo on the CPU: a rehearsal, not a card result",
               ranks=THREE_REHEARSAL_RANKS, torch=torch.__version__,
               max_abs_diff_vs_one_process=worst, rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL,
               seconds=time.perf_counter() - t0)
    emit("three_axis_rehearsal", **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    zoo_shapes = zoo_conv_shapes(dev)
    split_shapes = {d: split_conv_shapes(d, dev) for d in CONV_SPLIT_DEGREES}
    zoo_kn = {(k, n) for shapes in list(zoo_shapes.values()) + list(split_shapes.values())
              for (_, k, n) in shapes}
    t0 = time.perf_counter()
    libs = ("paged_attention", "flash_attention", "fused_conv_stats")
    _build.build(libs)                       # one nvcc per source, started together
    pa.build_kernel()
    fa.build_kernel()
    fcs.build_kernel()
    ptxas = {name: _build.ptxas_report(name) for name in libs}
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={n: _build.build_seconds.get(n) for n in libs}, ptxas=ptxas,
         flash_tensor_core=tensor_core_report(ptxas["flash_attention"]),
         conv_tensor_core=conv_tensor_core_report(ptxas["fused_conv_stats"], zoo_kn))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = [parity_case(shape, kind, gen, dev)
            for shape in ("decode", "prefill", "verify")
            for kind in ("bfloat16", "int8", "float32")]

    params = tt.init_params(get_model("transformer"), seed=SEED, device=dev)
    serve_rows = [serve_run(params, kv_quant, dev) for kv_quant in (False, True)]
    stream_check(params, dev)
    feature_rows = serve_features(params, card, dev)
    replica_row = serve_replica(params, card, dev)
    fleet_row = serve_fleet(params, card, dev)
    bucketed_row = serve_bucketed(params, card, dev)
    del params
    selftest_row = serve_selftest(card)
    infer_rows = serve_infer(card, dev)
    ckpt_serve_rows = checkpoint_serve(card, dev)

    flash_rows = [r for seq, causal, dtype in ((TRAIN_SEQ, False, torch.bfloat16),
                                               (TRAIN_SEQ, True, torch.bfloat16),
                                               (128, False, torch.bfloat16),
                                               (256, True, torch.bfloat16),
                                               (TRAIN_SEQ, False, torch.float32))
                  for r in flash_case(seq, causal, dtype, gen, dev)]
    flash_rows += seq_flash_cases(gen, dev)
    # three_axis on four cards: Ulysses at seq 2 x model 2 on bert_base's
    # 12 / 4 heads a rank.
    flash_rows += flash_case(TRAIN_SEQ, False, torch.bfloat16, gen, dev, THREE_BERT_BATCH,
                             FLASH_H // 4)
    conv_rows = [conv_stats_case(*shape, torch.bfloat16, gen, dev, launches)
                 for shape, launches in CONV_SHAPES]
    conv_rows.append(conv_stats_case(*CONV_SHAPES[0][0], torch.float32, gen, dev))
    emit("conv_stats_forward", model="resnet50", **conv_forward_totals(conv_rows))
    for key, shapes in zoo_shapes.items():
        model_rows = [conv_stats_case(*shape, torch.bfloat16, gen, dev, launches, key)
                      for shape, launches in sorted(shapes.items())]
        emit("conv_stats_forward", model=key, **conv_forward_totals(model_rows))
        conv_rows += model_rows
    conv_rows += conv_split_shapes(split_shapes, gen, dev)
    crossover_phase(card, dev)
    train_rows = [train_run("bert_base", TRAIN_BATCH, TRAIN_STEPS, card, dev),
                  train_run("transformer", LM_BATCH, LM_STEPS, card, dev)]
    resnet_row = train_resnet(card, dev)
    train_check(dev)
    resnet_check(dev)
    data_row = data_fit(card, dev)
    zoo_rows = zoo_train(card, dev, zoo_shapes)
    zoo_check(dev)
    optim_check(dev)
    remat_check(dev)
    accum_check(dev)
    ckpt_rows = checkpoint_train(card)
    saved_row = saved_model_phase(card, dev)
    auto_plan(card, dev)
    tune_row = tune_phase(card, dev)
    # From here on every card phase runs in processes of its own, and the
    # CPU rehearsals (gloo ranks on the CPU and their one-process steps in
    # this process, none of which touches the card) run beside them.
    rehearsals = _Beside(three_axis_rehearsal, tp_models_rehearsal, dist_rehearsal,
                         sparse_rehearsal, parallel_rehearsal)
    try:
        dist_rows = dist_train(card)
        sync_rows = sync_options(card)
        tp_rows = tp_train(card)
        tp_cnn_row = tp_cnn(card)
        auto_rows = auto_train(card)
        sup_row = supervised_train(card)
        seq_rows, pipe_rows = parallel_train(card, dev)
        three_axis_row = three_axis(card)
    finally:
        rehearsals.join()
    rehearsals.result()
    seq_rows = [r for r in seq_rows if r["attention_impl"] != "flash"]
    pipe_row = pipe_rows[0]
    three_runs = (list((three_axis_row.get("placed") or {}).values())
                  + three_axis_row.get("meshes", []))
    three_launches = {k: sum(run["kernel_launches"][k] for run in three_runs)
                      for k in ("fwd", "dkdv", "dq", "fused_conv_stats")}

    main_row = rows[0]                  # decode, bf16 pages: the serving hot shape
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "autodist_tpu_torch/csrc/paged_attention.cu",
        "replaces": "autodist_tpu/ops/paged_attention.py:137",
        "launches": sum(r["kernel_launches"] for r in serve_rows + feature_rows
                        + ckpt_serve_rows + [replica_row, fleet_row, bucketed_row,
                                             selftest_row]),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    # Flash kernels: the main shape is bert_base's, S=512 non-causal.
    replaces = {"fwd": "autodist_tpu/ops/flash_attention.py:46",
                "dkdv": "autodist_tpu/ops/flash_attention.py:100",
                "dq": "autodist_tpu/ops/flash_attention.py:155"}
    for kind, where in replaces.items():
        row = next(r for r in flash_rows if r["kernel"] == kind and r["S"] == TRAIN_SEQ
                   and not r["causal"] and r["dtype"] == "bfloat16")
        kernels.append({
            "name": f"flash_attention_{kind}",
            "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_attention.cu",
            "replaces": where,
            "launches": sum(t["kernel_launches"][kind]
                            for t in train_rows + dist_rows + sync_rows + ckpt_rows)
            + saved_row["kernel_launches"][kind]
            + sum(t["kernel_launches"][kind] for t in tp_rows)
            + sum(t["kernel_launches"][kind] + t["named_kernel_launches"][kind]
                  for t in auto_rows)
            + tune_row["kernel_launches"][kind]
            + sup_row["kernel_launches"][kind]
            + sum(r["kernel_launches"][kind] for r in seq_rows)
            + pipe_row["kernel_launches"][kind]
            + data_row["lm"]["kernel_launches"][kind]
            + (infer_rows[0]["kernel_launches"] if kind == "fwd" else 0)
            + three_launches[kind],
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                               if r["kernel"] == kind),
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # The fused conv-stats kernel: the main shape is the first bottleneck
    # conv of ResNet-50 at batch 128, bf16; the library call is
    # torch.matmul plus the two fp32 column sums. Its launches are those of
    # the three CNNs' train windows.
    row = conv_rows[0]
    kernels.append({
        "name": "fused_conv_stats",
        "route": "cuda",
        "source": "autodist_tpu_torch/csrc/fused_conv_stats.cu",
        "replaces": "examples/benchmark/fused_conv_stats.py:54",
        "launches": resnet_row["kernel_launches"]["fused_conv_stats"]
        + sum(r["kernel_launches"].get("fused_conv_stats", 0)
              for r in zoo_rows + dist_rows + sync_rows + ckpt_rows + tp_rows)
        + infer_rows[1]["kernel_launches"]
        + data_row["kernel_launches"]["fused_conv_stats"]
        + tp_cnn_row["kernel_launches"]["fused_conv_stats"]
        + three_launches["fused_conv_stats"],
        "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    RANK_MAINS = {"--dist-rank": dist_rank, "--dist-cpu-rank": dist_cpu_rank,
                  "--sync-rank": sync_rank, "--ckpt-rank": ckpt_rank, "--tp-rank": tp_rank,
                  "--auto-rank": auto_rank, "--sparse-cpu-rank": sparse_cpu_rank,
                  "--parallel-rank": parallel_rank,
                  "--parallel-cpu-rank": parallel_cpu_rank, "--tp-cnn-rank": tp_cnn_rank,
                  "--tp-models-cpu-rank": tp_models_cpu_rank,
                  "--three-axis-rank": three_axis_rank,
                  "--three-axis-cpu-rank": three_axis_cpu_rank}
    if len(sys.argv) == 5 and sys.argv[1] in RANK_MAINS:
        sys.exit(RANK_MAINS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--serve-cli":
        sys.exit(serve_cli(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) == 4 and sys.argv[1] == "--supervised-script":
        sys.exit(supervised_script(sys.argv[2], sys.argv[3]))
    sys.exit(main())
