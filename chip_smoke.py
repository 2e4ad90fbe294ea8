#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and check them.

    python3 chip_smoke.py            # needs one card

1. print the card (name, power limit);
2. build the CUDA kernels from ``ops/csrc`` with ``nvcc`` (sm_90a) and
   print ptxas's registers and spills for each Hopper flash kernel and
   each decode kernel;
3. hold each kernel against its plain PyTorch version at GPT-2 124M
   widths (K5: B=8, H=12, hd=64, S=1024, C in {1, 128, 512}, and the
   one-shot's prompt, B=4, C=512; K6: block size 16, shuffled tables,
   ragged lengths, B=8, C in {1, 128}, and the engine's prefill chunk,
   B=1, C=128; bf16 and int8 caches; K5 also at a speculative verify
   chunk, B=4, C=5) and time kernel, plain version,
   bound and, for every bf16 K5 case, one
   ``scaled_dot_product_attention`` call over the live slice (a chunk
   with an explicit boolean mask, or ``is_causal`` where it starts the
   cache) as a yardstick; K5's write index is a device tensor: NaN and
   then 3e38 written past the live length must change no bit of its
   output, and one call captured in a CUDA graph and replayed at three
   indices must give the bits of three eager calls (C = 1, 5, 128, 512,
   bf16 and int8); then time K6's two regimes at chunk widths around the
   threshold that picks between them, and ``sample_rows``'s two top-k
   draws (the device draw the captured steps use, the live-column draw
   with its host sync);
4. serve 12 requests through ``ServeEngine`` on ``gpt2_124m`` in bf16
   (random weights from ``--seed``), greedy and sampled, each with the
   steps captured as CUDA graphs and with the eager step functions: the
   streams must be bitwise equal, each graph captured once; every token
   is checked against a teacher-forced training-view forward, the pool
   must be leak-free, and each drain's K6 launch count (zeroed just
   before it, counted per replay) must equal its steps times the layers,
   both regimes among them (the captured drains' printed by regime);
   prints each run's decode-step and prefill-chunk ms (medians,
   host clock around inputs, replay and readback) and tokens/s, the
   decode graph's device ms a replay and a profile of one replay;
5. run the one-shot generator (K5) at B=4 with a 512-token prompt,
   greedy and sampled: the captured loop (first call captures, second
   timed) bitwise equal to the eager loop, with the same teacher-forced
   check; K5 must launch once a layer in the chunk regime (the prompt)
   and once a layer a later token in the split one, per replay;
6. hold the flash kernels K1 (forward), K2 (dQ) and K3 (dK/dV) against
   their plain versions at B=8, H=12, hd=64: S=1024 bf16 causal and not,
   a ragged S=1000, an f32 case, the SP phase's global shape (B=4,
   S=4096, causal) and hd=128 at H=6 (bf16, causal); time kernel, plain
   version, bound and one ``scaled_dot_product_attention`` forward (K1)
   and backward (K2 and K3 together; captured with its forward, less the
   forward) as yardsticks, and print K2 + K3 against that backward at the
   path's shape and the SP phase's;
   check that the backward kernels are bitwise repeatable and that the
   public ``flash_attention`` at S=1000 launches each kernel with no
   fallback;
7. train ``gpt2_124m`` (bf16 compute, f32 parameters from ``--seed``,
   B=8, S=1024, ``attn_impl="auto"`` -> flash, fused CE, Adam) through
   ``DataParallel().make_train_step`` and ``TrainLoop`` for 20 steps on one
   repeated batch: the first loss must sit near ln(50304), the loss must
   fall, each of K1-K3 must launch 12 times a step with no fallback; one
   step's loss and gradients with flash must agree with the dense
   attention path, two runs of one step must give bitwise-equal
   gradients, and one step under ``bf16_remat`` must launch K1 24 times;
   one more step, with CUDA events around each kernel call, gives the
   flash kernels' share of a step, K1's on its own;
8. hold the ring carry kernel K4 against its plain version at the ring's
   per-rank shape (B=4, H=12, S_loc=1024, hd=64, bf16), a diagonal and a
   full visit, each merged into a carry that already holds one visit;
   time kernel, plain version, bound and one
   ``scaled_dot_product_attention`` on the same shard pair with the same
   mask as a yardstick (it computes the visit without the merge);
9. sequence parallelism at 4 ranks, 4 processes time-sharing the one card
   over gloo (``runtime/multiprocess.py``): ring attention (K4 forward,
   K2/K3 backward) and Ulysses (K1-K3) at GPT-2 124M attention widths,
   global S=4096, B=4, H=12, hd=64, bf16, causal and not, forward and
   backward; each rank holds its output and dq/dk/dv to single-process
   ``flash_attention`` on the whole sequence; the K4/K2/K3 launches summed
   over the ranks and each rank's comm bytes must be exact;
10. data parallelism at 2 ranks on the card: ``gpt2_124m`` widths at depth
   2, B=8 (4 a rank), S=1024, through ``DataParallel(mesh)`` and
   ``TrainLoop`` for 3 steps; the averaged gradients against the 1-rank
   step on the union batch, the replicas bitwise equal after the steps;
   then one ``make_train_step_with_stats`` step of ``ResNet18ish``
   (32x32, ``small_inputs``, bf16, 8 images a rank), whose BatchNorm
   running statistics must be bitwise equal on both ranks;
11. ResNet-50 (1000 classes, 224x224, bf16, plain BatchNorm; random
    weights from ``--seed``, one fixed batch of 256 synthetic ImageNet
    images on the card, as ``bench.py`` times it) trained by SGD
    (lr 0.1, momentum 0.9) through ``make_train_step_with_stats`` and
    ``TrainLoop`` for 20 steps, then one eval step: the loss must be
    finite and fall, the running statistics move, the eval logits be
    finite, and a ``fused_bn`` model on the same weights agree with the
    plain one within ``FUSED_BN_REL``; prints step ms, images/s, model
    FLOPs, MFU, peak memory, images/s over the baseline's A100 yardstick,
    and a ``torch.profiler`` split of one step;
12. the MNIST CNN (f32) at batch 1024, 50 SGD-momentum steps over
    synthetic MNIST, then a held-out evaluation through ``EvalHook``:
    the loss must fall and the accuracy sit well above chance;
13. Wide&Deep at the published widths (vocabularies 100000, 100000,
    10000, 1000, 100; embeddings of 32; MLP 256, 128) at batch 8192, 50
    Adam steps over synthetic click-through batches: the loss must fall;
14. BERT-base classification (``bert_base(num_classes=2)``, bf16, dense
    attention) at batch 256, sequence 128, 20 AdamW steps (peak lr 1e-4
    after a linear warm-up over 10 steps, weight decay 1e-4) on one fixed
    batch: the loss must be finite and fall, and its last 5 steps sit
    below ``BERT_LOSS_LAST5``, well under chance;
15. pipelined GPT-2 124M in one process (``PipelinedLM``, full widths,
    bf16 compute, f32 parameters, pipe = 1 so ``schedule="auto"`` is
    GPipe): M = 4 microbatches of 4 sequences at S = 1024, fused CE, Adam,
    10 steps on one repeated batch: the first loss near ln(50304) and
    falling; the first step's loss and every gradient within
    ``GRAD_REL_GAP`` of the unpipelined ``Transformer`` +
    ``make_lm_loss_fn`` step on the same weights and the union batch; K1,
    K2 and K3 each 12 x 4 launches a step with no fallback; the logits of
    ``to_serving_params`` through ``Transformer`` against the stage's own
    forward on one microbatch; step ms, tokens/s, peak memory;
16. pipelined GPT-2 124M widths at ``MP_LAYERS`` = 4 layers (phases 16-18
    and 20 ran 12 until PR 20) at 4 ranks time-sharing the card over gloo:
    (a) pipe = 4, 1F1B, M = 8 microbatches of 2; (b) pipe = 2 x model = 2,
    interleaved 1F1B (v = 2), M = 4 microbatches of 2, vocab-parallel
    fused CE; 3 Adam steps each. The single-process step on the same
    weights and the union batch is computed once, here, before the ranks
    start; each rank holds its shard of the first step's loss and
    gradients to it within ``GRAD_REL_GAP``. Exact K1-K3 launches in the
    first step and over the timed steps (K1 twice a layer and microbatch
    with 1F1B's recompute, once on the last chunk-stage's layers),
    ``ppermute[pipe]`` wire bytes summed over each pipe group equal to
    2 · M · act · (P·v − 1), and after the steps the embedding and head
    copies bitwise equal across ``pipe``, replicated parameters across
    ``model``;
17. BERT-base widths at 4 layers under ``TensorParallel`` at model = 2, 2
    ranks on the card over gloo, phase 14's batch and AdamW warm-up, 3
    steps: the
    first step's loss and gradient shards within ``GRAD_REL_GAP`` of the
    single-process step, replicated parameters bitwise equal on both
    ranks after the steps;
18. GPT-2 124M widths at 4 layers under ``FSDP`` at 2 ranks (bf16 compute, f32
    parameters, 4 sequences a rank at S = 1024: phase 7's global batch,
    flash, fused CE, Adam, 3 steps): the first step's loss and gradient
    shards within ``GRAD_REL_GAP`` of the single-process step on the same
    weights and the union batch; each rank's parameter and Adam moment
    bytes equal to its shards'; one all-gather and one reduce-scatter a
    sharded leaf and step, one pmean a replicated leaf and metric, wire
    bytes equal to ``fsdp_comm_terms``; K1-K3 once a layer and step each;
19. phase 10's 2-rank run (GPT-2 at depth 2) with ``overlap=True``
    against ``overlap=False``, 3 Adam steps each: the first step's
    gradients and the parameters after the steps bitwise equal, one
    all-reduce a 4 MiB bucket, the same total bytes;
20. GPT-2 124M widths at 4 layers under
    ``TensorParallel(rules=MEGATRON_SP_RULES)`` at
    model = 2, 2 ranks, 2 sequences at S = 1024, flash, vocab-parallel
    fused CE, 3 Adam steps, against the ``DEFAULT_RULES`` run on the same
    weights: the first step's loss and gradient shards within
    ``GRAD_REL_GAP``; no psum left in the blocks; the gather/scatter
    pairs' wire bytes equal to the all-reduces they replace; K1-K3 once a
    layer and step each at 6 heads; both runs' peak memory;
21. the async-PS family on the MNIST CNN at 4 ranks
    (``examples/async_ps_family.py``'s batch and rates): LocalSGD (K=4),
    GossipSGD and AccumulatedAdaptive (K=4), 12 calls each, then
    ``AsyncPSEmulator`` in hogwild, downpour and adag modes, 48 events
    each with the gradients on the card: every loss falls, LocalSGD's
    pmeans run once a call of K local steps, Gossip's replicas disagree
    and agree on their consensus.

22. speculative decoding (run after phase 5, on its model): B=4, a
    512-token prompt, 64 new tokens, 4 draft layers, lookahead 4, greedy
    and sampled (temperature 0.8, top-k 20), bf16 and int8 caches, and a
    copy of the model whose last 8 blocks add nothing (every draft
    agrees): the stream bitwise the vanilla one-shot's, K5's launches
    exact by regime, the verify rounds and accepted drafts, the wall ms
    against vanilla;
23. the multi-LoRA engine (after phase 22): ``gpt2_124m`` with rank 16
    and 4 adapters plus the zero row (a 23.6 MB bank), 8 slots, 12
    sampled requests over ids 0-4 with prompts of 10-32 tokens and a
    32-token prefill chunk: adapter 0's streams bitwise the base
    engine's, adapter k's bitwise the one-shot generator's with
    ``adapter_id=k``; the bank rewritten in place, 12 more requests
    follow the new bank with no recapture; then phase 4's geometry and
    prompt lengths (32-700 tokens, 128-token chunks), every stream held
    to a teacher-forced forward of the LoRA model under its adapter id;
    K6 counted a drain; decode-step ms with LoRA against without; and
    first, the LoRA first product's ``bmm`` must give an 8-row batch the
    one-row bits at qkv, proj and up (inputs that show any reordering).

24. the captured k-step train step (after phase 7, on its model and
    batch shape): GPT-2 124M at full width (B=8, S=1024, flash, fused CE,
    Adam with ``capturable=True``, f32 parameters, bf16 compute) through
    ``DataParallel().make_train_step(steps_per_call=4, stacked_batch=True,
    per_step_metrics=True)`` and ``TrainLoop(steps_per_call=4,
    tail_step_fn=...)``, fed 20 distinct batches by ``DataParallel.
    prefetch``: the 20 losses bitwise equal to the same 20 steps of the
    step's eager twin (``step.eager``), the parameters after them too, one
    capture, K1-K3 4 x 12 launches a replay; step ms (CUDA events around
    each call, / 4), tokens/s, host enqueue a step, the prefetch stats.
    Then phase 15's ``PipelinedLM`` (pipe = 1, M = 4 x 4, S = 1024) at
    ``steps_per_call=4`` captured against eager, the same checks (the last
    inner step's loss a call, the parameters after 20 steps), and one
    ``steps_per_call=1`` captured run of phase 7's step, bitwise the k = 4
    runs' losses, timed beside phase 7's eager step;
25. weight-only quantised serving (after phase 23, on phase 4's model):
    ``Transformer.quantize`` into int8, int4 and fp8 (``ops/quant.
    quantize_params`` of the bf16 model's f32 weights); each through phase
    4's engine geometry with 32-token prefill chunks and 12 greedy requests
    of 10-32 prompt tokens (one K5/K6 regime on both sides), held bitwise
    to phase 5's one-shot generator per request, every token within
    ``LOGIT_MARGIN`` of a teacher-forced forward of the quantised model;
    prints the logit gap to the bf16 model, and the captured decode step's
    ms (host clock, median) and device ms a replay beside the bf16
    engine's at the same prompts;
26. quantised training: phase 7's model, batch and Adam under the
    ``int8`` and ``fp8`` presets (f32 compute around int8 / e4m3 products,
    ``torch._int_mm`` / ``torch._scaled_mm``), 10 steps each on one
    repeated batch: the first loss near ln(50304) and within
    ``QUANT_LOSS0_GAP`` of the bf16 step's on the same weights and batch,
    the loss falling, K1-K3 12 launches a step; step ms.
27. MoE serving (after phase 25): ``gpt2_124m(moe_experts=8,
    moe_capacity=2)`` in bf16 (random weights from ``--seed``; 453 M
    expert parameters), phase 25's engine geometry (8 slots, 32-token
    chunks) and 12 requests of 10-32 prompt tokens, 64 new: greedy,
    sampled (0.8, top-k 20), at capacity 1 (sampled; slots must stall)
    and with int8 banks (``Transformer.quantize``, greedy). Each stream
    bitwise the solo (B = 1) one-shot generator's run of its request;
    the census exact, sum(load) + sum(overflow) = L x (prompt tokens +
    requests x (new - 1) + stalled slot-ticks); one capture a step; K6
    counted a drain and K5 an oracle run; every token within
    ``LOGIT_MARGIN`` of a teacher-forced forward but those after a
    router near tie (``ROUTER_TIE``; at most ``MOE_PAST_MARGIN_SHARE``
    of them). Prints decode-step ms (host clock, median) and device ms a
    replay beside the dense bf16 engine's at the same prompts, the
    stalls, the per-expert load, and a profile of one greedy replay;
28. the Switch LM, one process (``SwitchLM``, data 1 x expert 1):
    ``benchmarks/bench_moe_lm.py``'s shape (12 layers, d 768, ff 3072,
    12 heads, vocab 50304, 8 experts top-1, capacity factor 2.0, Switch
    router, B = 8, S = 512), bf16 compute, flash, fused CE, Adam, 10
    steps on one batch: the first LM loss near ln V, the loss falling,
    K1-K3 12 launches a step; the first step's loss and gradients against
    the same step under dense attention and the one-hot plain dispatch;
    step ms (CUDA events, median of steps 3-10), tokens/s, peak memory,
    step 1's per-expert load and dropped share;
29. expert parallelism at 4 ranks sharing the card over gloo (data 2 x
    expert 2): the Switch LM at phase 28's widths and depth 2, 2
    sequences a rank, the dropless router, so the sharded step computes
    the single-process step's function, which is computed once here
    before the ranks start; each rank's first-step loss and gradient
    shards within ``GRAD_REL_GAP`` of it, 4 ``all_to_all[expert]`` a
    layer and step of E·C·d·2·(n−1)/n wire bytes (C = 1024), half the
    experts' stack bytes a rank, replicated parameters bitwise equal on
    all ranks and expert shards across ``data`` after 3 Adam steps; then
    one Switch-router step with the same census at C = 256.

30. supervised training: ``run_with_recovery`` over phase 7's model cut
    to ``RESIL_LAYERS`` = 4 layers (12 until PR 20), batch shape and loss
    (times a float ``scale`` of 1.0 that a ``nan_batch`` fault poisons),
    Adam with ``capturable=True``, 12 steps, checkpoints every 4 (2 kept;
    1.28 GB of tensors each, 1.96 GB at 12 layers) under a temporary
    directory, under a fault schedule fixed from ``--seed``: a step
    exception before the first checkpoint (a fresh start), a NaN batch
    the sentinel skips, the step-8 checkpoint corrupted in place, a 1 s
    data stall against a 0.5 s deadline (the ladder skips step 8). Sync
    saves, then async ones: parameters, Adam moments and step bitwise the
    uninterrupted run on the stream without the skipped batch, K1-K3 once
    a layer and step call. Then a sync save, an async save's blocking copy,
    its commit and a restore are timed, and the step-12 checkpoint is
    restored in place into a live ``steps_per_call=2`` captured step,
    whose 4 more steps (graph replays, no recapture) equal the
    uninterrupted captured run's bitwise;
31. engine snapshots: phase 4's engine geometry (8 slots, captured
    steps), 16 sampled requests of 32-300 tokens: killed after snapshots
    at ticks 20 (sync) and 30 (async), a fresh engine restored and
    drained, every stream bitwise the uninterrupted engine's; again with
    the tick-30 snapshot corrupted (the ladder restores tick 20); a launch
    failure and a pool-pressure spike in an 80-block pool that preempts;
    a 3 s launch deadline that does not trip (its overhead a decode step)
    and one forced trip from a host stall (retried bitwise); a watchdog
    armed around ``torch.cuda.synchronize()`` over ~2 s of queued
    products, whose trip fires at its deadline and whose interrupt
    arrives when the synchronize returns; then phase 27's MoE engine
    killed and restored, bitwise. A restored or preempted stream
    re-prefills its prompt and feeds its emitted tokens back through
    decode steps (the scheduler's ``"replay"`` continuations, which
    the engine picks on the card); the restore's cost: the restored
    residents' prefill chunks, the decode ticks they spend feeding their
    tokens back, and the time until every one of them emits again,
    beside the same numbers for the same snapshot restored with its
    emitted tokens re-prefilled in chunks (timed only: that form is not
    bitwise on the card);
32. preemption: SIGTERM sent by a hook after step 6 of phase 30's run
    (its 4 layers):
    the run saves step 7 and stops with ``stop_reason == "preemption"``,
    ``EvalHook`` skips its end pass, the SIGTERM handler comes back, and
    the resumed run ends bitwise the uninterrupted one;
33. the elastic world: ``ElasticSupervisor`` over two slices of one
    process sharing the card over gloo (``MultiSliceLocalSGD``,
    ``sync_period=2``, outer Nesterov momentum; the reference's linear
    regression), slice 1 lost after round 3 and back at round 6; the same
    supervisor on the CPU beside it: the same three generations, the
    stream accounting exactly once, final parameters within 1e-6;
34. the host spill tier: 16 sampled requests of 200-400 tokens (96 new)
    through phase 4's engine (8 slots, block 16, captured steps) on a
    97-block pool with 1024 host blocks, bf16 and then int8: preempted
    decoding residents spill and swap back in, every stream bitwise the
    same requests' on a 513-block pool, ``spill_d2h_bytes`` and
    ``spill_h2d_bytes`` exactly blocks x ``kv_block_bytes``, the pool
    leaves' addresses and the graphs' captures unchanged; the fused d2h
    and h2d of 8 and 64 blocks timed (each ended by a synchronize); one
    resident preempted by hand and timed until it emits again, resumed by
    swap-in and rebuilt by ``"replay"``; a warm restart: 4 requests
    sharing a 256-token prefix on a ``persist_cache`` engine, a snapshot,
    a fresh engine restored from it, and the prefix served again with a
    new suffix: zero prefix tokens prefilled again (one suffix chunk), its
    16 blocks swapped in from the host tier, the stream bitwise a cold
    engine's, TTFT warm against cold;
35. the fleet: ``FleetScheduler`` with 2 replicas of 4 slots on the card
    sharing the model, 12 sampled requests of 64-256 tokens (half share a
    128-token prefix), every stream bitwise one uninterrupted 4-slot
    engine's, none dropped, the tenant counters a disjoint sum: (a)
    colocated with prefix routing, (b) disaggregated prefill / decode
    (every stream migrates with its KV; ``migration_bytes`` the closed
    form and the decode replica's h2d bytes), (c) the first
    ``random_fleet`` storm from ``--seed`` with a crash, a stall and a
    torn handoff, plus a ``slice_loss`` and ``slice_return``: the torn
    record adopted once, ``torch.cuda.memory_allocated`` after the storm
    within one replica pool of before it, the ticks from the crash until
    each of its streams emits again; (d) a fleet snapshot at a third of
    the tokens restored into a fresh fleet; then one
    ``make_kv_block_transfer`` of 8 bf16 blocks between 2 gloo ranks
    sharing the card: the blocks arrive bitwise and ``CommTrace`` counts
    the closed form's bytes;
36. the metrics plane: a ``Registry`` over phase 34's engine health,
    pool, prefix and host-store stats, phase 35's storm fleet and phase
    27's MoE census; phase 34's event stream as a Chrome trace (one
    complete span per prefill chunk and per slot of each decode tick),
    its TTFT breakdown, ``obs.cli`` over its dump; ``reconcile`` of one
    captured decode replay (CUDA events) against the H100 roofline under
    two costs, each with its HBM fraction: ``model``, the decode byte
    model of ``models/generation.py`` at K6's live blocks, and ``moved``,
    what the replay moves, term by term (f32 master reads, the bf16 cast
    copies written and read again, the gathered embedding rows, the KV
    term); phase 7's GPT-2 steps under ``MetricsHook`` and
    ``TensorBoardHook`` (logging every 4th step): parameters bitwise the
    hook-free run's, the TensorBoard file's losses exactly the loop's,
    the hooks' ms a step;
37. the data plane: the phase reads its steps, batch, seed and profile
    directory from ``RunConfig.from_argv`` and saves and loads the config
    back equal; builds the native (C++) record loader with ``g++`` and
    prints its seconds; trains ``ByteBPETokenizer`` (vocab 512) on the
    repo's root ``*.md`` files in sorted order, cut to 192 KB, and
    imports them as 1024-token records; holds ``NativeRecordLoader``
    byte-equal to ``PyRecordLoader`` over two epochs (2 shards of the
    token file; the augmented image file below); phase 7's GPT-2 step
    (B=8, S=1024, flash) fed from those records through
    ``DevicePrefetchIterator`` (depth 2, int32 widened on the card) for
    20 steps, wrapping an epoch, under ``ProfilerHook`` (steps 10-12):
    finite, falling losses, the Chrome trace names K1-K3; ``check_runs``
    at rtol 0 over two 5-step runs from the same records and seed;
    ResNet-50 (phase 11's step, B=256) fed 20 steps from 512 augmented
    records (256x256 stored, 224 crop, flip; normalised on the card):
    finite losses, the running statistics move; the loader's records/s;
    ``save_memory_profile``; MNIST (phase 12's step) from IDX files (the
    images gzipped) through ``import_mnist``, and BERT-base (phase 14's
    step and warm-up) from a seeded ``label<TAB>text`` file of the
    corpus's lines (in pieces of at most 512 bytes) through
    ``import_labeled_text``, 10 steps each, every record count equal to
    the importer's. Step ms (CUDA events around the step call) and
    images/s stand beside phases 7's and 11's on their fixed batches,
    with the host clock's ms a step after warm-up (input included).

38. the tuning table (``ops/autotune.py``; phases 1-37 run on a fresh
    table in a temporary directory, online tuning off, and must leave it
    unwritten): (a) the decode split of GPT-2 124M (H=12, hd=64), bf16 and
    int8 caches: each keys candidate's K5 (B=8, S=1024, C=1) and K6 (B=8,
    64 blocks of 16 a request) against ``split_attention_plain`` with the
    same keys (``BF16_ATOL``), then the sweep of K5 + K6 (median of 20
    a candidate), every candidate's ms and the chosen keys; (b) the
    fused-CE chunk at the GPT-2 step's head (N=8192, d=768, V=50257, bf16,
    forward and backward; median of 10), each chunk's f32 loss within
    1e-5 of the default chunk's; (c) on a fresh table, ``ServeEngine(
    online_tune=True)`` on GPT-2 124M serves 8 greedy requests of 10-32
    tokens in 32-row chunks: at least one attempt, no failure, the time
    within the budget, and every stream bitwise the one-shot's (B=1),
    which makes no attempt; then 8 captured 4-step GPT-2 steps through
    ``TrainLoop(online_tune=True)``, their losses within 1e-3 (first)
    and 2e-2 (all) of the default chunk's; (d) a new process reloads the
    table: every key hits with no attempt.
39. the program audit (``analysis/``, part 1): (a) the 12 registered
    collective-free programs (the serve engine's eager steps, the
    one-shot generator, fused CE, the fp8 product) linted on the card:
    every rule passes, the collective census is empty, and K5's and K6's
    launch counters (by regime) move by exactly the kernel nodes each
    census counted; per program, the census's op and kernel-node counts,
    flops, HBM bytes, the census's peak live bytes beside the
    ``torch.cuda.max_memory_allocated`` rise, and whether the structure
    hash equals the CPU census taken in this process (the ops that
    differ where not); (b) one eager decode step of phase 4's
    ``gpt2_124m`` bf16 engine geometry (8 slots at ragged lengths, block
    16, 513 blocks) audited under ``serve_decode_step``'s rules:
    collective-free, no host sync, no global-generator draw, the pool
    updated in place, no f32 tensor of slots x heads x max_len elements
    but the (slots, 1, V) logits the sampler reads, K6 once a layer; its
    census cost beside the decode byte model's (``models/generation.py``
    ``decode_param_bytes_per_step`` with K6's live blocks, phase 36's
    ``model``).
40. the program audit, part 2, the 10 mesh programs: (a) ``lint --world
    8`` in a world of 8 gloo ranks time-sharing ``cuda:0``, online tuning
    off: the DP, bucketed-overlap and int8 steps, FSDP, the GPipe step
    with the fused CE head, the two multislice rounds, the KV transfer
    across slices, the Switch and dropless MoE steps. Each passes every
    rule on every rank with no bypass, with the same per-rank collective
    censuses and world-mean collective bytes as the same world on the
    CPU (run beside it); one line a program, the structure hash against
    the CPU's reported, not gated (gloo's staging copies the CUDA
    messages); (b) one eager GPT-2 124M data-parallel train step (phase
    7's widths at ``MP_LAYERS`` = 4 layers, 12 until PR 20; S=1024, 4
    sequences a rank, SGD with momentum as the
    contract's fixture) at 2 ranks sharing the card over gloo, audited
    under ``dp_train_step``'s rules with its counts and pins re-derived:
    2 ``psum[data]`` calls moving ``dp_allreduce_bytes(G, 2)`` +
    2 ``dp_allreduce_bytes(4, 2)`` a rank (G the f32 parameter bytes), no
    bypass, no host sync, the state updated in place, K1, K2 and K3
    kernel nodes a layer and rank and launches equal to them; its precision and
    memory observations are printed, not gated (a bf16 model under the
    f32 contract's rules).
41. the example family: the 14 scripts of
    ``distributed_tensorflow_guide_tpu_torch/examples/`` through their
    importable bodies on ``cuda:0`` (the single-rank ones in this
    process, the counts zeroed before each and read after; scripts 7, 9
    and 10 at 4 ranks sharing the card over gloo, one after another in
    one ``runtime/multiprocess`` job, each rank returning each body's
    summary, its own launches and its output), at full width where the
    script has it: ResNet-50 at 224,
    B=256; BERT-base widths (768, 12 heads; depth 2) over model = 4;
    ``--full-gpt2 --pipe 4`` at S=1024 then ``--generate``; ring and
    Ulysses at S=4096 over context = 4; GPT-2 124M widths (768, 12
    heads; depth 2) trained at S=1024, then the one-shot generator (and a
    second run with an int8 cache and a one-layer draft) and the engine
    with 128-row prefill chunks, so K6 runs both regimes. Steps and depth
    are cut (each script's argv is printed). One JSON line a script: its
    argv, wall seconds, its ``done`` line, rate and kernel launches. A
    script fails the phase if it raises, lacks its JAX twin's success
    lines, or launches none of its kernels (9: K1-K3 and K5; 10: K4;
    11: K1-K3 and K5; 12: K6 in both regimes), or (script 10) strays
    from dense attention by the JAX example's 2e-4 or more. Then
    ``graft_entry.entry()``, the counterpart of the repository root's
    ``__graft_entry__.py``: GPT-2 124M at bf16 on ``cuda:0``, its forward
    once at (4, 1024) under inference mode: finite (4, 1024, 50304) f32
    logits and exactly one K1 launch a layer (12). Its launches join the
    ``kernels`` line with the scripts'.

Phase 19 also runs ``compress="int8"``: the first step's gradients
within the shared scale's half-step of the uncompressed ones (the JAX
package's ``int8_pmean`` bound), 3 steps whose losses stay within the
JAX test's 2e-2 of the uncompressed run's, and the wire: 1 byte an
element in ``psum[data]`` and 4 bytes a bucket in ``pmax[data]``, each at
the ring's 2 (n - 1) / n.

Phases 16-21, 29 and 33 time-share one card over gloo, which stages
every message through host memory: their times say nothing of NCCL.

The kernels are built once here, before any rank starts. Exits non-zero
on any failure, and when no CUDA card is present. The last line of stdout
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import gc
import glob
import gzip
import hashlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core import precision
from distributed_tensorflow_guide_tpu_torch.core.config import RunConfig
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    MeshSpec,
    build_mesh,
)
from distributed_tensorflow_guide_tpu_torch.data import native_loader
from distributed_tensorflow_guide_tpu_torch.data import synthetic
from distributed_tensorflow_guide_tpu_torch.data.importers import (
    MNIST_FIELDS,
    import_mnist,
    write_idx,
)
from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
    ImageAugment,
    NativeRecordLoader,
    PyRecordLoader,
    make_fields,
    record_bytes,
    write_records,
)
from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
    ByteBPETokenizer,
    import_labeled_text,
    import_text,
    labeled_text_fields,
    text_fields,
)
from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn, resnet
from distributed_tensorflow_guide_tpu_torch.models import generation as gen_mod
from distributed_tensorflow_guide_tpu_torch.models import wide_deep
from distributed_tensorflow_guide_tpu_torch.models.generation import (
    fold_in,
    make_generate_fn,
    sample_rows,
)
from distributed_tensorflow_guide_tpu_torch.models.moe_lm import SwitchLM
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    LORA_ROW_SUM_SITES,
    Transformer,
    TransformerConfig,
    bert_base,
    gpt2_124m,
    make_cls_loss_fn,
    make_lm_loss_fn,
    router_logits,
)
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
    DevicePrefetchIterator,
    pack_batches,
)
from distributed_tensorflow_guide_tpu_torch.ops import _build
from distributed_tensorflow_guide_tpu_torch.ops import autotune
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA
from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
    fused_next_token_loss,
    resolve_fused_ce,
)
from distributed_tensorflow_guide_tpu_torch.parallel import overlap as ov
from distributed_tensorflow_guide_tpu_torch.parallel import sequence
from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
    AccumulatedAdaptive,
    GossipSGD,
    LocalSGD,
)
from distributed_tensorflow_guide_tpu_torch.parallel.fsdp import (
    FSDP,
    fsdp_comm_terms,
)
from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
    PipelinedLM,
)
from distributed_tensorflow_guide_tpu_torch.parallel.ps_emulator import (
    AsyncPSEmulator,
)
from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
    DEFAULT_RULES,
    MEGATRON_SP_RULES,
    TensorParallel,
    split_dim,
)
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
    run_multiprocess,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    Fault,
    FaultSchedule,
)
from distributed_tensorflow_guide_tpu_torch.train.anomaly import (
    AnomalySentinelHook,
)
from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from distributed_tensorflow_guide_tpu_torch.train.elastic import (
    PreemptionHook,
    run_with_recovery,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import (
    BaseHook,
    StopAtStepHook,
)
from distributed_tensorflow_guide_tpu_torch.train.evaluation import (
    EvalHook,
    Evaluator,
)
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from distributed_tensorflow_guide_tpu_torch.utils.determinism import (
    check_runs,
)
from distributed_tensorflow_guide_tpu_torch.utils.flop_accounting import (
    traced_matmul_flops,
)
from distributed_tensorflow_guide_tpu_torch.utils.profiling import (
    ProfilerHook,
    save_memory_profile,
)
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
    init_adapter_bank,
)
from distributed_tensorflow_guide_tpu_torch.serve.fleet import FleetScheduler
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    kv_block_bytes,
    kv_migration_bytes,
)
from distributed_tensorflow_guide_tpu_torch.utils.watchdog import Watchdog

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_S = 989e12  # dense bf16 tensor-core peak (data sheet)
F32_FLOPS_S = 67e12  # float32 outside the tensor cores (data sheet)
L2_BYTES = 50 * 2**20
# bf16 keeps 8 significant bits: two roundings of f32 results that differ
# in their last bits can land one bf16 step apart (<= 2**-7 relative)
BF16_ATOL = BF16_RTOL = 1e-2
# float32 flash outputs: the kernel sums up to 1024 products per output in
# another order than the plain version (measured gaps reach 1e-5 on dV)
F32_TOL = 1e-4
# teacher-forced check: the emitted token's logit may sit this far below
# the best one. bf16 sums run in another order at another batch width, so
# near-ties can flip; a token from a broken path sits ~3 logit std
# (~1.6 at these widths) below the best.
LOGIT_MARGIN = 0.25
K5_REPLACES = "distributed_tensorflow_guide_tpu/ops/decode_attention.py:176"
K6_REPLACES = "distributed_tensorflow_guide_tpu/ops/decode_attention.py:430"
FLASH_REPLACES = {
    "flash_fwd": "distributed_tensorflow_guide_tpu/ops/flash_attention.py:137",
    "flash_dq": "distributed_tensorflow_guide_tpu/ops/flash_attention.py:321",
    "flash_dkv": "distributed_tensorflow_guide_tpu/ops/flash_attention.py:360",
    "flash_carry":
        "distributed_tensorflow_guide_tpu/ops/flash_attention.py:226",
}
K1_K3 = ("flash_fwd", "flash_dq", "flash_dkv")
LN_VOCAB = math.log(50304)
# training checks: the first loss of random weights sits near ln V (the
# logits' spread adds ~0.15); 20 Adam steps on one repeated batch must
# take at least this much off it
LOSS0_MARGIN = 0.5
LOSS_DROP = 1.0
# flash against dense attention, one step's gradients in bf16: relative
# norm of the difference per tensor
GRAD_REL_GAP = 2e-2
# sequence parallelism against single-process flash on the whole sequence,
# bf16: outputs within the JAX package's own bf16 bound for its two rings
# (2e-2 absolute and relative); dq, dk, dv within GRAD_REL_GAP relative
# norm (the ring sums per-visit bf16 partials in f32, flash sums in one
# pass: other roundings). DP's averaged gradients against the union
# step's: GRAD_REL_GAP too (bf16 products over other batch shapes)
SP_TOL = 2e-2
# the baseline's yardstick (bench.py:38): ResNet-50 training images/s per
# A100 of an 8xA100 DGX (MLPerf-class), not a measurement of this port
A100_IMAGES_PER_SEC_PER_GPU = 2770.0
# fused against plain BatchNorm, ResNet-50 logits in bf16 on the same
# weights and batch: relative norm of the difference. Each of the 53
# BatchNorms rounds its folded k and b and x * k + b to bf16 where the
# plain one rounds once. Measured on an H100 after phase 11's 20 steps:
# 0.00094-0.00096. Folds made wrong on purpose read: eps 1e-3 for 1e-5,
# 0.0017; the mean 1% low, 0.0021; the variance 2% high, 0.0097. The
# unbiased variance moves no logit visibly here (at least 12544 values a
# channel, n / (n - 1) < 1 + 1e-4): the CPU tests pin it at batch 8
FUSED_BN_REL = 1.5e-3
# BERT memorises its one fixed batch: the mean of the last 5 of the 20
# losses must sit below this (chance is ln 2 = 0.693). With the warm-up
# it reads ~0.05 on an H100; AdamW at 1e-4 from the first step spikes the
# loss to ~11 at step 2 and is back only to ~0.67 by step 20
BERT_LOSS_LAST5 = 0.35
BERT_WARMUP_STEPS = 10
# phases 24 and 26: phase 7's batch; steps a call, and the steps of a run
TRAIN_B, TRAIN_S = 8, 1024
CAP_K, CAP_STEPS = 4, 20
# phase 25: the quantised engine's chunk and prompt lengths, new tokens
Q_CHUNK, Q_PROMPTS, Q_NEW = 32, (10, 33), 32
# phase 26: steps a preset; the int8 / fp8 first loss against the bf16
# step's on the same weights and batch (ln units: both sit near ln V; the
# quantisers' error moves the logits by ~1e-2)
Q_STEPS = 10
QUANT_LOSS0_GAP = 0.05
# phases 27-29: GPT-2 124M with 8 experts, top-1; the engine's capacity
# (ceil(2 * slots / E), benchmarks/bench_serving.py:1375) and new tokens;
# SwitchLM at benchmarks/bench_moe_lm.py's defaults (S = 512, global
# batch 8, capacity factor 2.0); phase 29's ranks, depth and steps
MOE_E, MOE_CAP, MOE_NEW = 8, 2, 64
MOE_B, MOE_S, MOE_STEPS = 8, 512, 10
EP_N, EP_LAYERS, EP_STEPS = 4, 2, 3
# the MoE teacher-forced check: the router's argmax is discontinuous, so
# where its two best logits at a position lie within bf16 rounding of
# each other, the training view may send that position to the other
# expert than the engine did, and the logits of later tokens move with it
# (an H100 debugging run of this phase: 1 token of 768 at 0.287 below its
# bar, after a tie of 7.5e-5 at an earlier position). A token past
# LOGIT_MARGIN must follow a near tie (a gap below ROUTER_TIE at or before
# its input position), and such tokens may be at most this share of the
# tokens; a broken path moves nearly every token ~1.6 below the bar
ROUTER_TIE = 1e-2
MOE_PAST_MARGIN_SHARE = 0.01


_TYPE_CODES = {"f": "float", "a": "int8_t"}


def _kernel_name(mangled: str) -> str:
    """flash_dq_sm90<64> or decode_split_kernel<bf16, int8_t, true, 64>
    for a kernel's mangled name (template arguments of types, bools and
    ints only)."""
    m = re.search(r"(flash_[a-z]+_sm90|decode_[a-z]+_(?:kernel|sm90))"
                  r"I(.*?)EEv", mangled)
    if not m:
        return mangled
    args, rest, last = [], m.group(2), None
    while rest:
        if rest[0].isdigit():
            n = int(re.match(r"\d+", rest).group())
            skip = len(str(n))
            last = rest[skip:skip + n].replace("__nv_bfloat16", "bf16")
            args.append(last)
            rest = rest[skip + n:]
        elif rest[0] in _TYPE_CODES:
            last = _TYPE_CODES[rest[0]]
            args.append(last)
            rest = rest[1:]
        elif rest[0] == "S":  # a substitution: the type seen before
            args.append(last)
            rest = rest[rest.index("_") + 1:]
        elif rest.startswith("Lb"):
            args.append(("false", "true")[int(rest[2])])
            rest = rest[4:]
        elif rest.startswith("Li"):
            num = re.match(r"Li(\d+)E", rest)
            args.append(num.group(1))
            rest = rest[num.end():]
        else:
            return mangled
    return f"{m.group(1)}<{', '.join(args)}>"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn(i)``: ``n`` calls captured in
    one CUDA graph, replayed back to back, CUDA events around each replay
    (median), so host launch overhead does not enter the time."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def time_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``n`` calls, CUDA
    events around the whole run, after a warm-up."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ---- phase 3: kernels against their plain versions ------------------------


def _cache_copies(make, bytes_each: int):
    """Enough copies of the cache operands that cycling through them
    keeps each launch's cache out of L2 (what a step meets: every layer
    reads its own cache)."""
    n = max(2, math.ceil(2 * L2_BYTES / max(bytes_each, 1)) + 1)
    return [make() for _ in range(n)]


def _visible_pairs(q_pos):
    """(query, key) pairs the mask lets through: query at position p sees
    p + 1 keys."""
    return int(sum(int(p) + 1 for row in q_pos for p in row))


def _record(results, name, case, out, ref, kernel_ms, plain_ms, nbytes,
            flops, library_ms=None, tol=BF16_ATOL, flops_s=BF16_FLOPS_S):
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    row = {"kernel": name, **case, "max_abs_err": err,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "ok": ok}
    print("kernel_case " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        fail(f"{name} {case} disagrees with its plain version "
             f"(max_abs_err {err})")


def _regime(q, cache_dtype) -> str:
    return DA.decode_regime(q.dtype, cache_dtype, q.shape[-1], q.shape[1])


def _k5_case(results, gen, *, B, C, length, kv, S=1024, H=12, hd=64,
             library=False):
    """K5 at one shape against its plain version; times kernel, plain
    version and, with ``library``, one ``scaled_dot_product_attention``
    over the live slice (C=1: no mask; a chunk that starts the cache:
    ``is_causal``; any other chunk: an explicit boolean mask)."""
    dev = torch.device("cuda", 0)
    index = length - C

    def make():
        k = torch.randn(B, H, S, hd, generator=gen, device=dev)
        v = torch.randn(B, H, S, hd, generator=gen, device=dev)
        if kv == "int8":
            k8, ks = DA.quantize_kv(k)
            v8, vs = DA.quantize_kv(v)
            return (k8, v8, ks[:, :, None].contiguous(),
                    vs[:, :, None].contiguous())
        return (k.bfloat16(), v.bfloat16(), None, None)

    cache_dtype = torch.int8 if kv == "int8" else torch.bfloat16
    nbytes = DA.decode_kernel_hbm_bytes(
        b=B, h=H, s=S, d=hd, dtype=cache_dtype, chunk=C,
        effective_len=length)
    sets = _cache_copies(make, nbytes)
    q = torch.randn(B, C, H, hd, generator=gen, device=dev).bfloat16()
    idx = torch.tensor([index], dtype=torch.int32, device=dev)

    def kern(i):
        k, v, ks, vs = sets[i % len(sets)]
        return DA.decode_attention(q, k, v, idx, key_scale=ks,
                                   value_scale=vs)

    def plain(i):
        k, v, ks, vs = sets[i % len(sets)]
        return DA.decode_attention_plain(q, k, v, index, key_scale=ks,
                                         value_scale=vs)

    out, ref = kern(0), plain(0)
    torch.cuda.synchronize()
    kernel_ms = graph_ms(kern, 50)
    plain_ms = time_ms(plain, 5, warmup=1)
    library_ms = None
    if library:
        mask = None
        if C > 1 and index > 0:  # row c sees keys up to index + c
            mask = (torch.arange(length, device=dev)[None, :]
                    <= index + torch.arange(C, device=dev)[:, None])

        def lib(i):
            k, v = sets[i % len(sets)][:2]
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :, :length], v[:, :, :length],
                attn_mask=mask, is_causal=C > 1 and index == 0)

        lib_out = lib(0).transpose(1, 2)
        if not torch.allclose(lib_out.float(), ref.float(),
                              atol=BF16_ATOL, rtol=BF16_RTOL):
            fail(f"the library yardstick disagrees with K5 at C={C}")
        library_ms = graph_ms(lib, 50)
    q_pos = [[index + c for c in range(C)]] * (B * H)
    flops = 4 * hd * _visible_pairs(q_pos)
    _record(results, "decode_attention",
            {"B": B, "C": C, "S": S, "length": length, "cache": kv,
             "regime": _regime(q, cache_dtype)},
            out, ref, kernel_ms, plain_ms, nbytes, flops, library_ms)


def check_k5(results, gen):
    for kv in ("bf16", "int8"):
        for C in (1, 128, 512):
            for length in (1024, 700):
                _k5_case(results, gen, B=8, C=C, length=length, kv=kv,
                         library=kv == "bf16")
    # the one-shot generator's prompt: B=4, 512 tokens in one chunk
    _k5_case(results, gen, B=4, C=512, length=512, kv="bf16", library=True)
    # a speculative verify chunk (G = 4): C = 5 at B=4, split regime
    _k5_case(results, gen, B=4, C=5, length=700, kv="bf16", library=True)


def check_k5_device_index(gen) -> None:
    """K5 reads its write index on the device: (1) rows at or past the
    live length filled with NaN, then with large finite garbage (bf16
    3e38; int8 values 127 with NaN or 3e38 scales), give the bits of the
    same call on a cache that holds zeros there, and agree with the plain
    version; (2) one call captured in a CUDA graph over a static index
    tensor, replayed at three indices, gives the bits of three eager
    calls. GPT-2 widths (H=12, hd=64), S=1024, B=4; C = 1 and 5 (split
    regime), 128 and 512 (chunk regime: TMA tiles, the crossed tile
    gathered), bf16 and int8."""
    dev = torch.device("cuda", 0)
    B, H, S, hd = 4, 12, 1024, 64
    checked = 0
    for kv in ("bf16", "int8"):
        k = torch.randn(B, H, S, hd, generator=gen, device=dev)
        v = torch.randn(B, H, S, hd, generator=gen, device=dev)
        if kv == "int8":
            k, ks = DA.quantize_kv(k)
            v, vs = DA.quantize_kv(v)
            ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
        else:
            k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
        for C in (1, 5, 128, 512):
            q = torch.randn(B, C, H, hd, generator=gen,
                            device=dev).bfloat16()
            indices = (0, 317, S - C) if C < 512 else (0, 100, S - C)
            for index in indices:
                n = index + C
                clean = [None if t is None else t.clone()
                         for t in (k, v, ks, vs)]
                for t, ax in zip(clean, (2, 2, 3, 3)):
                    if t is not None:
                        t.narrow(ax, n, S - n).zero_()
                want = DA.decode_attention(q, clean[0], clean[1], index,
                                           key_scale=clean[2],
                                           value_scale=clean[3])
                plain = DA.decode_attention_plain(
                    q, clean[0], clean[1], index, key_scale=clean[2],
                    value_scale=clean[3])
                if not torch.allclose(want.float(), plain.float(),
                                      atol=BF16_ATOL, rtol=BF16_RTOL):
                    fail(f"K5 {kv} C={C} index {index}: kernel and plain "
                         f"version disagree")
                for garbage in (float("nan"), 3e38):
                    dirty = [None if t is None else t.clone()
                             for t in clean]
                    for t, ax in zip(dirty, (2, 2, 3, 3)):
                        if t is not None:
                            fill = 127 if t.dtype == torch.int8 else garbage
                            t.narrow(ax, n, S - n).fill_(fill)
                    got = DA.decode_attention(
                        q, dirty[0], dirty[1],
                        torch.tensor([index], dtype=torch.int32,
                                     device=dev),
                        key_scale=dirty[2], value_scale=dirty[3])
                    if not torch.equal(got, want):
                        fail(f"K5 {kv} C={C} index {index}: {garbage} past "
                             f"the length reached the output")
                checked += 1
            # one graph, replayed at every index, against eager calls
            idx = torch.zeros(1, dtype=torch.int32, device=dev)
            graph = torch.cuda.CUDAGraph()
            DA.decode_attention(q, k, v, idx, key_scale=ks, value_scale=vs)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                out = DA.decode_attention(q, k, v, idx, key_scale=ks,
                                          value_scale=vs)
            for index in indices:
                idx.fill_(index)
                graph.replay()
                eager = DA.decode_attention(q, k, v, index, key_scale=ks,
                                            value_scale=vs)
                if not torch.equal(out, eager):
                    fail(f"K5 {kv} C={C}: the graph replayed at index "
                         f"{index} differs from the eager call")
    torch.cuda.synchronize()
    print(f"K5 device index: {checked} cases bitwise invariant to NaN and "
          f"3e38 past the length; graph replays at 3 indices bitwise the "
          f"eager calls (bf16, int8; C = 1, 5, 128, 512)", flush=True)


def _k6_case(results, gen, perm, *, B, C, kv, lengths_np, H=12, hd=64,
             bs=16, S=1024):
    """K6 at one shape; ``perm`` (B * S / bs,) shuffles the pool blocks."""
    n_blk = S // bs
    N = B * n_blk + 1  # + the trash block
    dev = torch.device("cuda", 0)
    tables = torch.as_tensor(perm.reshape(B, n_blk), device=dev)
    lengths = torch.as_tensor(lengths_np, device=dev)

    def make():
        k = torch.randn(N, H, bs, hd, generator=gen, device=dev)
        v = torch.randn(N, H, bs, hd, generator=gen, device=dev)
        if kv == "int8":
            k8, ks = DA.quantize_kv(k)
            v8, vs = DA.quantize_kv(v)
            return (k8, v8, ks[:, :, None].contiguous(),
                    vs[:, :, None].contiguous())
        return (k.bfloat16(), v.bfloat16(), None, None)

    cache_dtype = torch.int8 if kv == "int8" else torch.bfloat16
    nbytes = sum(DA.decode_kernel_hbm_bytes(
        b=1, h=H, s=S, d=hd, dtype=cache_dtype, chunk=C,
        effective_len=int(n)) for n in lengths_np)
    pool_bytes = N * H * bs * DA.cache_slot_bytes(hd, cache_dtype)
    sets = _cache_copies(make, pool_bytes)
    q = torch.randn(B, C, H, hd, generator=gen, device=dev).bfloat16()

    def kern(i):
        k, v, ks, vs = sets[i % len(sets)]
        return DA.paged_decode_attention(
            q, k, v, tables, lengths, key_scale_pool=ks,
            value_scale_pool=vs, block_size=bs)

    def plain(i):
        k, v, ks, vs = sets[i % len(sets)]
        return DA.paged_decode_attention_plain(
            q, k, v, tables, lengths, key_scale_pool=ks,
            value_scale_pool=vs, block_size=bs)

    out, ref = kern(0), plain(0)
    torch.cuda.synchronize()
    kernel_ms = graph_ms(kern, 50)
    plain_ms = time_ms(plain, 5, warmup=1)
    q_pos = [[int(n) - C + c for c in range(C)]
             for n in lengths_np for _ in range(H)]
    flops = 4 * hd * _visible_pairs(q_pos)
    _record(results, "paged_decode_attention",
            {"B": B, "C": C, "block_size": bs,
             "lengths": lengths_np.tolist(), "cache": kv,
             "regime": _regime(q, cache_dtype)},
            out, ref, kernel_ms, plain_ms, nbytes, flops)


def check_k6(results, gen, rng, seed):
    B, S, bs = 8, 1024, 16
    perm = rng.permutation(B * S // bs).astype(np.int32)
    # the engine's prefill chunk has a stream of its own, so that ``rng``
    # draws what it drew before this case existed (the ragged lengths
    # here, the prompts of phase 4)
    perm_one = np.random.RandomState(seed + 1).permutation(
        S // bs).astype(np.int32)
    for kv in ("bf16", "int8"):
        for C in (1, 128):
            lengths_np = rng.randint(C, S + 1, size=B).astype(np.int32)
            lengths_np[0] = S  # one request at the full length
            _k6_case(results, gen, perm, B=B, C=C, kv=kv,
                     lengths_np=lengths_np)
        # one request, 128 rows, at its fifth chunk of a 700-token prompt
        _k6_case(results, gen, perm_one, B=1, C=128, kv=kv,
                 lengths_np=np.array([640], np.int32))


def check_regime_threshold(gen) -> None:
    """Both regimes of K6 (B=8, bf16, length 1024, block size 16) at chunk
    widths around ``CHUNK_MIN_ROWS``, each named to the kernel's entry
    point, timed in CUDA graphs: the measurement the threshold rests
    on."""
    dev = torch.device("cuda", 0)
    B, H, hd, bs, S = 8, 12, 64, 16, 1024
    n_blk = S // bs
    k, v = (torch.randn(B * n_blk + 1, H, bs, hd, generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    tables = torch.arange(B * n_blk, dtype=torch.int32,
                          device=dev).view(B, n_blk)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    times = {}
    for C in (4, 8, 10, 12, 16, 32):
        q = torch.randn(B, C, H, hd, generator=gen, device=dev).bfloat16()
        times[C] = {regime: graph_ms(
            lambda i: DA.paged_decode_attention_kernel(
                q, k, v, tables, lengths, block_size=bs, regime=regime), 20)
            for regime in ("split", "chunk")}
    print(f"decode regimes by chunk width (K6, B=8, bf16, length {S}; "
          f"threshold {DA.CHUNK_MIN_ROWS}): " + json.dumps(times),
          flush=True)


# ---- phases 4-5: the engine and the one-shot generator --------------------


def teacher_forced_gap(model, prompt, tokens, top_k=None,
                      adapter=None) -> float:
    """Largest shortfall of an emitted token's logit below the bar at its
    position, from one training-view forward over prompt + tokens (under
    LoRA adapter id ``adapter`` of a LoRA model's bank). The bar is the
    best logit (greedy) or the k-th best (top-k sampling)."""
    seq = torch.as_tensor(np.concatenate([prompt, tokens]),
                          device=model.device)[None]
    ids = (None if adapter is None
           else torch.tensor([adapter], device=model.device))
    with torch.inference_mode():
        logits = model(seq, adapter=ids)[0]  # (L, V) float32
    P = len(prompt)
    rows = logits[P - 1:P - 1 + len(tokens)]
    got = rows[torch.arange(len(tokens)),
               torch.as_tensor(tokens, device=rows.device)]
    bar = (rows.max(dim=-1).values if top_k is None
           else torch.topk(rows, top_k, dim=-1).values[:, -1])
    return float((bar - got).max())


def make_engine(cfg, model, *, temperature, top_k, eager=False,
                prefill_chunk=128, adapters=None):
    """Phase 4's engine geometry (8 slots, block 16, 513 blocks). With
    ``eager`` its steps run without graphs: the eager step functions the
    captured ones are held to."""
    eng = ServeEngine(cfg, model, slots=8, block_size=16, num_blocks=513,
                      prefill_chunk=prefill_chunk, temperature=temperature,
                      top_k=top_k, adapters=adapters)
    if eager:
        eng.fns.decode, eng.fns.prefill = (eng.fns.decode_fn,
                                           eng.fns.prefill_fn)
    return eng


def drain(eng, prompts, *, seed, max_new=64, rid0=0, adapters=None):
    """Submit ``prompts`` (request ``rid0 + i`` with key (seed, i) and
    adapter ``adapters[i]``) and drain the engine. Returns the streams and
    the run's numbers: decode-step and prefill-chunk ms as medians of the
    host clock around each step (inputs, replay, token readback)."""
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=max_new,
                           rng=np.array([seed, i], np.uint32),
                           adapter=0 if adapters is None else adapters[i]))
    ttft, tick_s = {}, {"decode": [], "prefill": []}
    steps0 = dict(eng.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_queued or eng.sched.has_resident:
        events, kind = eng.step(now=time.perf_counter() - t0)
        t = time.perf_counter() - t0
        if kind == "idle":
            fail("engine idle with work queued")
        tick_s[kind].append(eng.last_tick_s)
        for e in events:
            if e.first:
                ttft[e.rid] = t
    wall = time.perf_counter() - t0
    eng.sched.pool.check_leaks()
    got = {rid - rid0: toks for rid, toks in eng.completions().items()
           if rid0 <= rid < rid0 + len(prompts)}
    if sorted(got) != list(range(len(prompts))) or any(
            len(got[r]) != max_new for r in got):
        fail(f"engine did not complete every request with {max_new} "
             f"tokens")
    return got, {
        "tokens_per_s": sum(len(t) for t in got.values()) / wall,
        "mean_ttft_s": float(np.mean(list(ttft.values()))),
        "decode_step_ms": 1e3 * float(np.median(tick_s["decode"])),
        "prefill_chunk_ms": 1e3 * float(np.median(tick_s["prefill"])),
        "decode_steps": eng.steps["decode"] - steps0["decode"],
        "prefill_chunks": eng.steps["prefill"] - steps0["prefill"],
        "wall_s": wall}


def _regime_launches(name: str) -> dict:
    return {regime: DA.REGIME_LAUNCHES[f"{name}.{regime}"]
            for regime in ("split", "chunk")}


def check_k6_launches(what, stats, layers) -> dict:
    """K6's launches since the counts were last zeroed, which cover one
    engine drain: exactly its steps x layers, through both regimes, and
    no K5. Returns them by regime."""
    steps = stats["decode_steps"] + stats["prefill_chunks"]
    launches = DA.LAUNCHES["paged_decode_attention"]
    if launches != steps * layers:
        fail(f"{what}: K6 launched {launches} times, expected {steps} "
             f"steps x {layers} layers")
    if DA.LAUNCHES["decode_attention"]:
        fail(f"{what}: the engine launched K5")
    counted = _regime_launches("paged_decode_attention")
    if sum(counted.values()) != launches or not all(counted.values()):
        fail(f"{what}: K6 regime launches {counted} do not add up to "
             f"{launches} or miss a regime")
    return counted


def check_captures(fns, want: int) -> None:
    if fns.captures != {"decode": want, "prefill": want}:
        fail(f"engine graph captures {fns.captures}, expected {want} each")


def check_sampler(gen, seed) -> None:
    """Both top-k draws at the engine's decode step (8 rows, vocab 50304,
    temperature 0.8, top-k 20): ``sample_rows``'s on the card (the whole
    row's noise on the device, which a graph can capture) and the
    live-column draw the CPU takes (bits of the surviving columns on the
    host, after a sync): the same tokens, and ms a call on the host clock
    around the call and its sync."""
    logits = torch.randn(8, 50304, generator=gen, device="cuda") * 3
    host_keys = fold_in(np.array([seed, 5], np.int64), np.arange(8))
    keys = torch.as_tensor(host_keys, device="cuda")
    draws = {"device": lambda: sample_rows(logits, keys, 0.8, 20),
             "live": lambda: gen_mod._gumbel_max_live(
                 gen_mod._tempered(logits, 0.8, 20), host_keys, 0)}
    times, toks = {}, {}
    for draw in ("device", "live", "device", "live"):
        ms = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks[draw] = draws[draw]()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        times[draw] = float(np.median(ms))
    if not torch.equal(toks["device"], toks["live"]):
        fail("the device and live top-k draws disagree")
    print("sampler ms a call (8 x 50304, top-k 20; median of 20, second "
          "round): " + json.dumps(times), flush=True)


def profile_replay(graph, n: int = 5) -> dict:
    """``n`` replays of a captured step under ``torch.profiler``: its
    kernels a replay, their summed device time a replay and the five that
    take the most (CUPTI sees the kernels a graph launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us_calls = by_name.setdefault(e.name[:80], [0.0, 0])
        us_calls[0] += e.time_range.elapsed_us()
        us_calls[1] += 1
    if not by_name:
        return {"kernels": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"kernels_a_replay": sum(c for _, c in by_name.values()) / n,
            "kernel_ms_a_replay": sum(u for u, _ in by_name.values())
            / n / 1e3,
            "top5_kernels_ms_calls": [[k, u / n / 1e3, c / n]
                                      for k, (u, c) in top]}


def check_engine(cfg, model, rng, kind, seed) -> dict:
    """Phase 4: greedy and sampled engine runs, each captured and eager.
    Each drain's K6 launches are counted alone (zeroed just before it):
    its steps x layers. Returns K6's launches by regime over the captured
    drains, the main path (the eager ones are their bitwise reference)."""
    prompts = [rng.randint(0, 50257, rng.randint(32, 701)).astype(np.int32)
               for _ in range(12)]
    by_regime = {"split": 0, "chunk": 0}
    for temperature, top_k in ((0.0, None), (0.8, 20)):
        mode = "greedy" if top_k is None else "sampled"
        runs = {}
        replay_ms = None
        for eager in (False, True):
            eng = make_engine(cfg, model, temperature=temperature,
                              top_k=top_k, eager=eager)
            DA.reset_launch_counts()
            runs[eager] = drain(eng, prompts, seed=seed)
            counted = check_k6_launches(
                f"engine {mode} {'eager' if eager else 'captured'}",
                runs[eager][1], cfg.num_layers)
            check_captures(eng.fns, 0 if eager else 1)
            if not eager:  # the decode graph's card time, replayed alone
                for r in by_regime:
                    by_regime[r] += counted[r]
                graph = eng.fns.decode.step.graph
                replay_ms = time_ms(lambda i: graph.replay(), 50)
                print(f"engine {mode} decode replay under the profiler: "
                      + json.dumps(profile_replay(graph)), flush=True)
            eng.close()
        got, stats = runs[False]
        stats["decode_replay_device_ms"] = replay_ms
        if got != runs[True][0]:
            fail(f"engine {mode}: the captured steps' streams differ from "
                 f"the eager steps'")
        gap = max(teacher_forced_gap(model, prompts[r], got[r], top_k)
                  for r in got)
        print(f"engine {mode} on {kind}: " + json.dumps(
            {"captured": stats, "eager": runs[True][1],
             "captured_equals_eager": True, "max_logit_gap": gap}),
            flush=True)
        if gap > LOGIT_MARGIN:
            fail(f"engine {mode}: an emitted token sits {gap} below its "
                 f"bar (margin {LOGIT_MARGIN})")
    print(f"K6 launches by regime (captured drains): "
          f"{json.dumps(by_regime)}", flush=True)
    return by_regime


def timed_generate(fn, model, prompt, key):
    """One generator call: its output and its wall seconds (host clock,
    ending in a sync), with the K5 launches it counted by regime."""
    DA.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(model, prompt, key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if DA.LAUNCHES["paged_decode_attention"]:
        fail("the one-shot generator launched K6")
    return out, wall, _regime_launches("decode_attention")


def check_one_shot(cfg, model, rng, kind, seed) -> dict:
    """Phase 5: the one-shot generator at B=4 with a 512-token prompt,
    greedy and sampled: the captured loop (its first call captures; the
    second is timed) against the eager one, bitwise. Returns K5's
    launches by regime over the timed captured calls."""
    B, P, new_tokens = 4, 512, 64
    prompt = rng.randint(0, 50257, (B, P)).astype(np.int64)
    # one prompt chunk, then one call per further token, in every layer
    want = {"split": (new_tokens - 1) * cfg.num_layers,
            "chunk": cfg.num_layers}
    total = {"split": 0, "chunk": 0}
    for temperature, top_k in ((0.0, None), (0.8, 20)):
        mode = "greedy" if top_k is None else "sampled"
        generate = make_generate_fn(cfg, max_new_tokens=new_tokens,
                                    temperature=temperature, top_k=top_k)
        key = np.array([seed, 99], np.uint32)
        first, first_s, counted = timed_generate(generate, model, prompt,
                                                 key)
        out, wall, counted2 = timed_generate(generate, model, prompt, key)
        eager, eager_s, counted3 = timed_generate(generate.eager, model,
                                                  prompt, key)
        for c in (counted, counted2, counted3):
            if c != want:
                fail(f"one-shot {mode}: K5 regime launches {c}, expected "
                     f"{want}")
        if generate.captures != 1:
            fail(f"one-shot {mode}: {generate.captures} captures")
        if not (torch.equal(out, eager) and torch.equal(first, eager)):
            fail(f"one-shot {mode}: the captured loop differs from the "
                 f"eager one")
        for r in total:
            total[r] += counted2[r]
        new = out[:, P:].cpu().numpy()
        gap = max(teacher_forced_gap(model, prompt[b], new[b], top_k)
                  for b in range(B))
        print(f"one-shot {mode} on {kind}: " + json.dumps(
            {"B": B, "prompt": P, "new": new_tokens,
             "captured_wall_s": wall, "first_call_s": first_s,
             "eager_wall_s": eager_s,
             "captured_tokens_per_s": B * new_tokens / wall,
             "eager_tokens_per_s": B * new_tokens / eager_s,
             "captured_equals_eager": True, "max_logit_gap": gap}),
            flush=True)
        if gap > LOGIT_MARGIN:
            fail(f"one-shot {mode}: an emitted token sits {gap} below its "
                 f"bar (margin {LOGIT_MARGIN})")
    return total


# ---- phase 6: the flash kernels against their plain versions --------------


def _flash_case(results, gen, *, S, dtype, causal, B=8, H=12, hd=64):
    """K1, K2 and K3 at one shape against their plain versions. Returns
    the kernel ms of each at this shape and the library backward's ms
    (None where it is not timed)."""
    dev = torch.device("cuda", 0)
    q, k, v, do = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    kw = dict(scale=scale, causal=causal)
    f32 = dtype == torch.float32
    tol = F32_TOL if f32 else BF16_ATOL
    flops_s = F32_FLOPS_S if f32 else BF16_FLOPS_S
    case = {"B": B, "H": H, "S": S, "hd": hd, "causal": causal,
            "dtype": "f32" if f32 else "bf16"}
    shape = dict(b=B, h=H, s=S, d=hd)
    library = S in (1024, 4096) and not f32

    # K1
    out, lse = FA.flash_fwd(q, k, v, **kw)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > F32_TOL:
        fail(f"flash_fwd {case}: lse off by {lse_err}")
    lib_fwd = lib_bwd = None
    if library:
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                 is_causal=causal)
        if not torch.allclose(lib_out.transpose(1, 2).float(), ref.float(),
                              atol=BF16_ATOL, rtol=BF16_RTOL):
            fail("the library yardstick disagrees with K1")
        with torch.no_grad():
            lib_fwd = graph_ms(lambda i: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal), 10)
    ms = {"flash_fwd": graph_ms(lambda i: FA.flash_fwd(q, k, v, **kw), 10)}
    _record(results, "flash_fwd", case, out, ref, ms["flash_fwd"],
            time_ms(lambda i: FA.flash_fwd_plain(q, k, v, scale, causal), 3,
                    warmup=1),
            FA.flash_kernel_bytes("flash_fwd", dtype=dtype, **shape),
            FA.flash_kernel_flops("flash_fwd", causal=causal, **shape),
            lib_fwd, tol, flops_s)
    if library:
        doh = do.transpose(1, 2)

        def lib_fwd_bwd(i):
            # fresh leaves, so that autograd's nodes for them are made on
            # the stream being captured
            leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            return torch.autograd.grad(o, leaves, doh)

        # a backward is captured only with its forward: the library's
        # backward time is the captured forward + backward less the
        # captured forward
        lib_bwd = graph_ms(lib_fwd_bwd, 10) - lib_fwd

    # K2, K3 on the plain forward's out and lse
    delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta)
    dq = FA.flash_bwd_dq(*args, **kw)
    dk, dv = FA.flash_bwd_dkv(*args, **kw)
    dq2 = FA.flash_bwd_dq(*args, **kw)
    dk2, dv2 = FA.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2)):
        fail(f"flash backward {case} is not bitwise repeatable")
    rq = FA.flash_bwd_dq_plain(*args, scale, causal)
    rk, rv = FA.flash_bwd_dkv_plain(*args, scale, causal)
    ms["flash_dq"] = graph_ms(lambda i: FA.flash_bwd_dq(*args, **kw), 10)
    _record(results, "flash_dq", case, dq, rq, ms["flash_dq"],
            time_ms(lambda i: FA.flash_bwd_dq_plain(*args, scale, causal), 3,
                    warmup=1),
            FA.flash_kernel_bytes("flash_dq", dtype=dtype, **shape),
            FA.flash_kernel_flops("flash_dq", causal=causal, **shape),
            lib_bwd, tol, flops_s)
    ms["flash_dkv"] = graph_ms(lambda i: FA.flash_bwd_dkv(*args, **kw), 10)
    _record(results, "flash_dkv", {**case, "out": "dk"}, dk, rk,
            ms["flash_dkv"],
            time_ms(lambda i: FA.flash_bwd_dkv_plain(*args, scale, causal),
                    3, warmup=1),
            FA.flash_kernel_bytes("flash_dkv", dtype=dtype, **shape),
            FA.flash_kernel_flops("flash_dkv", causal=causal, **shape),
            lib_bwd, tol, flops_s)
    err_v = (dv.float() - rv.float()).abs().max().item()
    if not torch.allclose(dv.float(), rv.float(), atol=tol, rtol=tol):
        fail(f"flash_dkv {case}: dV disagrees (max_abs_err {err_v})")
    results[-1]["max_abs_err"] = max(results[-1]["max_abs_err"], err_v)
    return ms, lib_bwd


def check_flash(results, gen) -> dict:
    """Phase 6. Returns the kernel ms of K1-K3 at the training path's
    shape (bf16, causal, S=1024)."""
    path_ms, path_lib = _flash_case(results, gen, S=1024,
                                    dtype=torch.bfloat16, causal=True)
    _flash_case(results, gen, S=1024, dtype=torch.bfloat16, causal=False)
    _flash_case(results, gen, S=1000, dtype=torch.bfloat16, causal=True)
    _flash_case(results, gen, S=1024, dtype=torch.float32, causal=True)
    # the SP phase's global shape, the single-process reference of phase 9
    sp_ms, sp_lib = _flash_case(results, gen, S=SP_S, B=SP_B,
                                dtype=torch.bfloat16, causal=True)
    # the HDP = 128 instances (ptxas spills K3's) at the path's operations
    _flash_case(results, gen, S=1024, H=6, hd=128, dtype=torch.bfloat16,
                causal=True)
    versus = {}
    for label, ms, lib in (("B=8 S=1024", path_ms, path_lib),
                           (f"B={SP_B} S={SP_S}", sp_ms, sp_lib)):
        pair = ms["flash_dq"] + ms["flash_dkv"]
        versus[label] = {"k2_ms": ms["flash_dq"], "k3_ms": ms["flash_dkv"],
                         "k2_k3_ms": pair, "sdpa_backward_ms": lib,
                         "x_sdpa": pair / lib}
    print("flash backward K2 + K3 against the SDPA backward (bf16, causal): "
          + json.dumps(versus), flush=True)

    # the public call at a ragged length: through the kernels, no
    # fallback (the JAX package's block rule binds CPU tensors only)
    q, k, v = (torch.randn(2, 1000, 12, 64, generator=gen, device="cuda")
               .bfloat16().requires_grad_() for _ in range(3))
    before, fell = dict(FA.LAUNCHES), FA.fallback_stats()
    FA.flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    grew = {n: FA.LAUNCHES[n] - before[n] for n in K1_K3}
    print(f"flash_attention at S=1000: launches {json.dumps(grew)}",
          flush=True)
    if set(grew.values()) != {1} or FA.fallback_stats() != fell:
        fail(f"flash_attention at S=1000 launched {grew}, fallbacks "
             f"{FA.fallback_stats()}")
    return path_ms


# ---- phase 7: the training step -------------------------------------------


class _Losses(BaseHook):
    """Keeps each step's loss tensor; nothing is read until the run ends."""

    def __init__(self):
        self.losses = []

    def after_step(self, step, metrics):
        self.losses.append(metrics["loss"])


def timed_run(step, state, data, steps: int, hooks=()):
    """``steps`` steps through ``TrainLoop`` with CUDA events around each
    step call. Returns (losses, step ms each, peak bytes, the loop)."""
    events = []

    def timed_step(st, b):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = step(st, b)
        end.record()
        events.append((start, end))
        return out

    losses = _Losses()
    # a finished TrainLoop and its StopAtStepHook refer to each other: an
    # earlier run's state lives until the cycle is collected, and would
    # count in this run's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(timed_step, state, data,
                     hooks=[StopAtStepHook(steps), losses, *hooks])
    loop.run()
    torch.cuda.synchronize()
    curve = [x.item() for x in losses.losses]
    if not all(math.isfinite(x) for x in curve):
        fail(f"non-finite loss: {curve}")
    return (curve, [a.elapsed_time(b) for a, b in events],
            torch.cuda.max_memory_allocated(), loop)



def _in_step_flash_ms(step, state, batch, layers: int) -> dict:
    """One more train step with CUDA events around each call of the K1-K3
    wrappers: their device milliseconds inside a real step, summed per
    wrapper. An event pair also takes in host time between the first
    event and the launch where the card has run dry."""
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    orig = {n: getattr(FA, n) for n in names}
    pairs = []

    def timed(name, fn):
        def call(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            pairs.append((name, start, end))
            return out
        return call

    try:
        for n in names:
            setattr(FA, n, timed(n, orig[n]))
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(FA, n, fn)
    if len(pairs) != 3 * layers:
        fail(f"the timed step made {len(pairs)} flash calls, expected "
             f"{3 * layers}")
    ms = dict.fromkeys(names, 0.0)
    for name, a, b in pairs:
        ms[name] += a.elapsed_time(b)
    return ms


def _grad_gaps(a: dict, b: dict) -> dict:
    return {n: ((a[n].float() - b[n].float()).norm()
                / b[n].float().norm().clamp_min(1e-30)).item() for n in b}


def check_training(cfg, rng, seed, kind, flash_ms) -> dict:
    """Phase 7. Returns the K1-K3 launches of the 20-step run and its
    median step ms."""
    B, S, steps = 8, 1024, 20
    dev = torch.device("cuda", 0)
    model = Transformer(cfg).init_weights(seed).to(dev)
    if cfg.resolve_attn_impl(S) != "flash":
        fail("attn_impl='auto' did not resolve to flash at S=1024")
    tokens = rng.randint(0, 50257, (B, S)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    loss_fn = make_lm_loss_fn(model)  # fused_ce="auto": on for the card

    # flash against dense on the same weights and batch, and two flash
    # runs against each other
    (l_f, _), g_f = value_and_grad(loss_fn, model, batch)
    (_, _), g_f2 = value_and_grad(loss_fn, model, batch)
    torch.cuda.synchronize()
    differ = [n for n in g_f if not torch.equal(g_f[n], g_f2[n])]
    if differ:
        fail(f"two runs of one step differ in {len(differ)} gradients, "
             f"e.g. {differ[:3]}")
    del g_f2
    dense = model.with_config(dataclasses.replace(cfg, attn_impl="dense"))
    (l_d, _), g_d = value_and_grad(loss_fn, dense, batch)
    gaps = _grad_gaps(g_f, g_d)
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(l_f.item() - l_d.item())
    print("flash_vs_dense: " + json.dumps(
        {"loss_flash": l_f.item(), "loss_dense": l_d.item(),
         "loss_gap": loss_gap, "worst_grad": worst,
         "worst_grad_rel_gap": gaps[worst],
         "median_grad_rel_gap": float(np.median(list(gaps.values())))}),
        flush=True)
    if gaps[worst] > GRAD_REL_GAP or loss_gap > 1e-2:
        fail(f"flash and dense gradients differ: {worst} relative gap "
             f"{gaps[worst]} (limit {GRAD_REL_GAP}), loss gap {loss_gap}")
    del g_f, g_d, dense

    # the head (fused CE, forward and backward) alone, at the step's shape
    hidden = torch.randn(B, S, cfg.d_model, device=dev).to(cfg.dtype)
    hidden.requires_grad_()
    kernel = model.lm_head.weight

    def head(i):
        loss = fused_next_token_loss(hidden, kernel.t(), batch["tokens"])
        return torch.autograd.grad(loss, (hidden, kernel))

    head_ms = time_ms(head, 5)
    del hidden

    # the main path: 20 steps through DataParallel and TrainLoop
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = DataParallel().make_train_step(loss_fn)
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    curve, step_ms, peak, loop = timed_run(
        step, state, iter(lambda: batch, None), steps)
    wall = time.perf_counter() - t0
    launches = {n: FA.LAUNCHES[n] for n in K1_K3}
    steady = float(np.median(step_ms[2:]))
    in_step_ms = _in_step_flash_ms(step, state, batch, cfg.num_layers)
    print(f"training on {kind}: " + json.dumps(
        {"B": B, "S": S, "steps": steps, "loss_curve": curve,
         "step_ms_each": step_ms, "step_ms_median_after_2": steady,
         "tokens_per_s": B * S / (steady / 1e3), "wall_s": wall,
         "max_memory_allocated_bytes": peak, "launches": launches,
         "dispatch": loop.dispatch_stats.as_dict(),
         # flash: events around the 36 wrapper calls of one more step,
         # K1 and K2 + K3 on their own; their phase-6 graph times x layers
         # beside them; the head timed alone at the step's shape; rest =
         # median step less both
         "split_ms": {"flash_kernels_in_step": sum(in_step_ms.values()),
                      "k1_flash_fwd_in_step": in_step_ms["flash_fwd"],
                      "k2_k3_in_step": in_step_ms["flash_bwd_dq"]
                      + in_step_ms["flash_bwd_dkv"],
                      "k2_k3_phase6_x_layers": cfg.num_layers
                      * (flash_ms["flash_dq"] + flash_ms["flash_dkv"]),
                      "flash_kernels_phase6_x_layers":
                          cfg.num_layers * sum(flash_ms.values()),
                      "k1_phase6_x_layers":
                          cfg.num_layers * flash_ms["flash_fwd"],
                      "fused_ce_head_alone": head_ms,
                      "rest": steady - sum(in_step_ms.values())
                      - head_ms}}), flush=True)
    want = {name: steps * cfg.num_layers for name in K1_K3}
    if launches != want or FA.LAUNCHES["flash_carry"]:
        fail(f"flash launches {launches}, expected {want}")
    if FA.fallback_stats():
        fail(f"flash fell back: {FA.fallback_stats()}")
    if abs(curve[0] - LN_VOCAB) > LOSS0_MARGIN:
        fail(f"first loss {curve[0]} is not within {LOSS0_MARGIN} of "
             f"ln(50304) = {LN_VOCAB}")
    if curve[-1] > curve[0] - LOSS_DROP:
        fail(f"the loss fell from {curve[0]} to {curve[-1]}, less than "
             f"{LOSS_DROP}")

    # one step under bf16_remat: K1 runs again in the backward
    remat_cfg = precision.resolve("bf16_remat").apply_to_transformer(cfg)
    remat = model.with_config(remat_cfg)
    remat_state = TrainState(remat, torch.optim.Adam(remat.parameters(),
                                                     lr=1e-3))
    FA.reset_launch_counts()
    DataParallel().make_train_step(make_lm_loss_fn(remat))(remat_state,
                                                           batch)
    torch.cuda.synchronize()
    want = {"flash_fwd": 2 * cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers, "flash_carry": 0}
    print(f"bf16_remat step launches: {json.dumps(FA.LAUNCHES)}",
          flush=True)
    if FA.LAUNCHES != want:
        fail(f"bf16_remat launches {FA.LAUNCHES}, expected {want}")
    return launches, steady


# ---- phase 8: the ring carry kernel K4 ---------------------------------------


def _carry_case(results, gen, *, diag):
    """K4 at the ring's per-rank shape: one visit of (k, v) merged into a
    carry that already holds a full visit of another shard, against the
    plain version from the same carry."""
    B, H, S, hd = 4, 12, 1024, 64
    dev = torch.device("cuda", 0)
    q, k0, v0, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                       .bfloat16() for _ in range(5))
    scale = 1.0 / math.sqrt(hd)
    start = FA.flash_carry_step_plain(q, k0, v0,
                                      *FA.carry_init(B, H, S, hd, dev),
                                      scale, False)
    carry = tuple(t.clone() for t in start)
    FA.flash_carry_step(q, k, v, *carry, scale=scale, diag=diag)
    want = FA.flash_carry_step_plain(q, k, v, *start, scale, diag)
    torch.cuda.synchronize()
    m_err = (carry[0] - want[0]).abs().max().item()
    if m_err > F32_TOL:
        fail(f"flash_carry diag={diag}: the running max is off by {m_err}")
    out, _ = FA.carry_finalize(*carry)
    ref, _ = FA.carry_finalize(*want)

    # timing: the same visit again and again into one carry, in place
    work = tuple(t.clone() for t in start)
    kernel_ms = graph_ms(lambda i: FA.flash_carry_step(
        q, k, v, *work, scale=scale, diag=diag), 10)
    plain_ms = time_ms(lambda i: FA.flash_carry_step_plain(
        q, k, v, *start, scale, diag), 3, warmup=1)
    # the yardstick computes the visit from a fresh carry, without the merge
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=diag)
    one, _ = FA.carry_finalize(*FA.flash_carry_step(
        q, k, v, *FA.carry_init(B, H, S, hd, dev), scale=scale, diag=diag))
    if not torch.allclose(lib_out.transpose(1, 2).float(), one,
                          atol=BF16_ATOL, rtol=BF16_RTOL):
        fail("the library yardstick disagrees with one K4 visit")
    library_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=diag), 10)
    shape = dict(b=B, h=H, s=S, d=hd)
    _record(results, "flash_carry",
            {"B": B, "H": H, "S": S, "hd": hd, "diag": diag,
             "dtype": "bf16"},
            out, ref, kernel_ms, plain_ms,
            FA.flash_kernel_bytes("flash_carry", dtype=torch.bfloat16,
                                  **shape),
            FA.flash_kernel_flops("flash_carry", causal=diag, **shape),
            library_ms)


def check_carry(results, gen) -> None:
    """Phase 8."""
    for diag in (True, False):
        _carry_case(results, gen, diag=diag)


# ---- phases 9-10: ranks on the one card -------------------------------------

SP_N, SP_B, SP_S, SP_H, SP_HD = 4, 4, 4096, 12, 64
SP_CASES = (("ring", True), ("ring", False), ("ulysses", True),
            ("ulysses", False))


def sp_comm_bytes(kind: str) -> int:
    """Each rank's payload bytes of one forward + backward (closed form).
    The ring moves k and v (bf16) forward, and q, the cotangent (bf16),
    lse and delta ((B, H, S_loc) f32) and the dq partial (f32) backward,
    n hops each. Ulysses moves q, k, v and the output forward and their
    cotangents backward, one all-to-all of a bf16 shard each."""
    s_loc = SP_S // SP_N
    t = SP_B * s_loc * SP_H * SP_HD * 2
    rows = SP_B * SP_H * s_loc * 4
    if kind == "ring":
        return SP_N * (2 * t) + SP_N * (2 * t + 2 * rows + 2 * t)
    return 8 * t


def sp_want_launches(kind: str, causal: bool) -> dict:
    """Kernel launches of one forward + backward, summed over the ranks:
    a causal ring has n (n + 1) / 2 live visits each way (n of them
    diagonal), a full one n * n; Ulysses runs K1-K3 once a rank."""
    if kind == "ring":
        live = SP_N * (SP_N + 1) // 2 if causal else SP_N * SP_N
        return {"flash_fwd": 0, "flash_dq": live, "flash_dkv": live,
                "flash_carry": live}
    return {"flash_fwd": SP_N, "flash_dq": SP_N, "flash_dkv": SP_N,
            "flash_carry": 0}


def _rel_gap(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def sp_rank(seed: int) -> dict:
    """One rank of phase 9 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=1, context=SP_N))
    s_loc = SP_S // SP_N
    rows = slice(mesh.axis("context").index * s_loc,
                 (mesh.axis("context").index + 1) * s_loc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn(SP_B, SP_S, SP_H, SP_HD, generator=gen,
                              device=dev).bfloat16() for _ in range(4))
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    for kind, causal in SP_CASES:
        fn = (sequence.ring_attention if kind == "ring"
              else sequence.ulysses_attention)

        def run(fn=fn, causal=causal):
            leaves = [t[:, rows].clone().requires_grad_() for t in (q, k, v)]
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            with cc.trace_comm() as rec:
                o = fn(*leaves, causal=causal, impl="auto", mesh=mesh)
                o.backward(w[:, rows])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0, o.detach(),
                    [t.grad for t in leaves], rec)

        FA.reset_launch_counts()
        _, o, grads, rec = run()
        launches = dict(FA.LAUNCHES)
        wall_s = min(run()[0] for _ in range(3))
        # the reference: flash attention on the whole sequence, one process
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = FA.flash_attention(*leaves, causal=causal)
        ref.backward(w)
        torch.cuda.synchronize()
        out[f"{kind}-{'causal' if causal else 'full'}"] = {
            "launches": launches,
            "comm_calls": dict(rec.calls), "comm_bytes": dict(rec.bytes),
            "fwd_bwd_ms": 1e3 * wall_s,
            "out_max_abs_err": (o.float() - ref[:, rows].float()).abs()
            .max().item(),
            "out_ok": torch.allclose(o.float(), ref[:, rows].float(),
                                     atol=SP_TOL, rtol=SP_TOL),
            "grad_rel_gap": {f"d{n}": _rel_gap(g, t.grad[:, rows])
                             for n, g, t in zip("qkv", grads, leaves)}}
    return out


def _layout(results) -> str:
    """Where the ranks ran: their cards and the group's backend (on a
    machine with one card, every rank time-shares cuda:0 over gloo)."""
    return (f"{len(results)} ranks on {sorted({r['device'] for r in results})}"
            f", backend {results[0]['backend']}")


def check_sp(kind_name: str, seed: int) -> int:
    """Phase 9. Returns the K4 launches of the ring runs."""
    t0 = time.perf_counter()
    results = [r.result for r in run_multiprocess(
        "chip_smoke:sp_rank", SP_N, [seed], timeout=900)]
    carry = 0
    for kind, causal in SP_CASES:
        case = f"{kind}-{'causal' if causal else 'full'}"
        per = [r[case] for r in results]
        total = {n: sum(p["launches"][n] for p in per) for n in FA.LAUNCHES}
        print(f"sp {case} on {kind_name} ({_layout(results)}): "
              + json.dumps({
                  "launches_summed": total,
                  "comm_bytes_per_rank": [p["comm_bytes"] for p in per],
                  "fwd_bwd_ms_per_rank": [p["fwd_bwd_ms"] for p in per],
                  "out_max_abs_err": max(p["out_max_abs_err"] for p in per),
                  "grad_rel_gap": [p["grad_rel_gap"] for p in per]}),
              flush=True)
        want = sp_want_launches(kind, causal)
        if total != want:
            fail(f"sp {case}: launches {total}, expected {want}")
        op = "ppermute[context]" if kind == "ring" else "all_to_all[context]"
        calls = 7 * SP_N if kind == "ring" else 8
        for p in per:
            if p["comm_calls"] != {op: calls} or p["comm_bytes"] != {
                    op: sp_comm_bytes(kind)}:
                fail(f"sp {case}: comm {p['comm_calls']} "
                     f"{p['comm_bytes']}, expected {calls} calls of "
                     f"{sp_comm_bytes(kind)} bytes")
            if not p["out_ok"]:
                fail(f"sp {case}: output off by {p['out_max_abs_err']}")
            if max(p["grad_rel_gap"].values()) > GRAD_REL_GAP:
                fail(f"sp {case}: gradient gaps {p['grad_rel_gap']}")
        if kind == "ring":
            carry += total["flash_carry"]
    print(f"sp phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return carry


DP_N, DP_B, DP_S, DP_STEPS, DP_LAYERS = 2, 8, 1024, 3, 2


def dp_rank(seed: int) -> dict:
    """One rank of phase 10 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=DP_N))
    i = mesh.axis("data").index
    cfg = dataclasses.replace(gpt2_124m(dtype=torch.bfloat16),
                              num_layers=DP_LAYERS)
    model = Transformer(cfg).init_weights(seed).to(dev)
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (DP_B, DP_S)).astype(np.int64)
    per = DP_B // DP_N
    share = {"tokens": torch.as_tensor(tokens[i * per:(i + 1) * per],
                                       device=dev)}
    loss_fn = make_lm_loss_fn(model)
    # the 1-rank step on the union batch, and this rank's averaged grads
    _, union = value_and_grad(loss_fn, model,
                              {"tokens": torch.as_tensor(tokens,
                                                         device=dev)})
    _, mine = value_and_grad(loss_fn, model, share)
    with cc.trace_comm() as rec:
        mean = cc.pmean(mine, "data", mesh=mesh)
    gaps = {n: _rel_gap(mean[n], union[n]) for n in union}
    grad_bytes = sum(g.numel() * g.element_size() for g in union.values())
    del union, mine, mean

    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = DataParallel(mesh).make_train_step(loss_fn)
    FA.reset_launch_counts()
    dist.barrier()
    curve, step_ms, _, _ = timed_run(step, state, iter(lambda: share, None),
                                     DP_STEPS)
    launches = dict(FA.LAUNCHES)
    param_sums = [float(p.double().sum()) for p in model.parameters()]
    worst = max(gaps, key=gaps.get)
    del state, model
    return {"rank": dist.get_rank(), "device": str(dev),
            "backend": dist.get_backend(), "worst_grad": worst,
            "worst_grad_rel_gap": gaps[worst],
            "median_grad_rel_gap": float(np.median(list(gaps.values()))),
            "grad_bytes": grad_bytes,
            "pmean_bytes": rec.bytes["pmean[data]"],
            "pmean_wire": rec.wire["pmean[data]"],
            "loss_curve": curve, "step_ms": step_ms,
            "launches": launches,
            "param_sums": param_sums, **dp_stats_step(mesh, seed)}


DP_STATS_B = 8  # images a rank


def dp_stats_step(mesh, seed: int) -> dict:
    """One ``make_train_step_with_stats`` step of ``ResNet18ish`` (32x32,
    ``small_inputs``, bf16) on this rank's share: its ms (CUDA events)
    and the running statistics it ends with, flat."""
    dev = resolve_device(None)
    i = mesh.axis("data").index
    batch = synthetic.synthetic_imagenet(DP_N * DP_STATS_B, 32,
                                         seed).take(1)[0]
    share = {k: v[i * DP_STATS_B:(i + 1) * DP_STATS_B]
             for k, v in batch.items()}
    model = resnet.ResNet18ish(num_classes=1000, dtype=torch.bfloat16,
                               small_inputs=True).to(dev).init_weights(seed)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                              momentum=0.9))
    step = DataParallel(mesh).make_train_step_with_stats(
        resnet.make_loss_fn(model))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step(state, share)
    end.record()
    torch.cuda.synchronize()
    return {"stats_step_ms": start.elapsed_time(end),
            "stats": torch.cat([b.reshape(-1) for b in model.buffers()])}


def check_dp(kind_name: str, seed: int) -> None:
    """Phase 10."""
    t0 = time.perf_counter()
    res = [r.result for r in run_multiprocess("chip_smoke:dp_rank", DP_N,
                                              [seed], timeout=900)]
    print(f"dp on {kind_name} ({_layout(res)}): "
          + json.dumps({k: [r[k] for r in res] for k in (
              "worst_grad", "worst_grad_rel_gap", "median_grad_rel_gap",
              "grad_bytes", "pmean_wire", "loss_curve", "step_ms",
              "launches", "stats_step_ms")}), flush=True)
    layers = DP_STEPS * DP_LAYERS
    want = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
            "flash_carry": 0}
    for r in res:
        if r["worst_grad_rel_gap"] > GRAD_REL_GAP:
            fail(f"dp rank {r['rank']}: {r['worst_grad']} gap "
                 f"{r['worst_grad_rel_gap']} (limit {GRAD_REL_GAP})")
        if r["launches"] != want:
            fail(f"dp rank {r['rank']}: launches {r['launches']}, "
                 f"expected {want}")
        if r["pmean_bytes"] != r["grad_bytes"] or r["pmean_wire"] != (
                r["grad_bytes"] * 2 * (DP_N - 1) / DP_N):
            fail(f"dp rank {r['rank']}: all-reduce bytes "
                 f"{r['pmean_bytes']} / wire {r['pmean_wire']}")
        if not all(math.isfinite(x) for x in r["loss_curve"]):
            fail(f"dp: non-finite loss {r['loss_curve']}")
    if len({tuple(r["loss_curve"]) for r in res}) != 1:
        fail("dp: the ranks report different losses")
    if res[0]["param_sums"] != res[1]["param_sums"]:
        fail("dp: the replicas' parameters differ after the steps")
    if not np.array_equal(res[0]["stats"], res[1]["stats"]):
        fail("dp: the ResNet18ish ranks' running statistics differ after "
             "the stats step")
    print(f"dp phase: {time.perf_counter() - t0:.1f} s", flush=True)


# ---- phases 11-14: the non-LM judged configs --------------------------------


def check_falls(name: str, curve: list, k: int) -> None:
    """The mean of the last ``k`` losses below the mean of the first
    ``k``."""
    first, last = np.mean(curve[:k]), np.mean(curve[-k:])
    if not last < first:
        fail(f"{name}: the loss did not fall (first {k} mean {first}, last "
             f"{k} mean {last})")


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _under_optimizer(evt) -> bool:
    while evt is not None:
        if evt.name.startswith("Optimizer.step"):
            return True
        evt = evt.cpu_parent
    return False


def profile_split(step, state, batch) -> dict:
    """One step under ``torch.profiler``: the self device time of the
    step's ops, the top 10 ops by it, and the shares of convolution
    forward, convolution backward, the optimizer (the ops under
    ``optimizer.step``) and the rest (BatchNorm, ReLU, casts, the head and
    the loss)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_op, shares = {}, {}
    for e in prof.events():
        ms = _self_device_us(e) / 1e3
        if not str(e.device_type).endswith("CPU") or ms <= 0:
            continue
        ms_calls = by_op.setdefault(e.name, [0.0, 0])
        ms_calls[0] += ms
        ms_calls[1] += 1
        if _under_optimizer(e):
            group = "optimizer"
        elif "convolution" in e.name and "backward" in e.name:
            group = "conv_backward"
        elif "convolution" in e.name:
            group = "conv_forward"
        else:
            group = "bn_elementwise_other"
        shares[group] = shares.get(group, 0.0) + ms
    total = sum(shares.values())
    if total <= 0:
        fail("the profiler recorded no device time")
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ms": total, "wall_ms_profiled": wall_ms,
            "device_busy_share": total / wall_ms,
            "top10_ops_ms_calls": [[k, ms, n] for k, (ms, n) in top],
            "shares": {k: v / total for k, v in shares.items()}}


# ResNet-50's batch (the JAX bench.py's per-chip batch) and image size
RESNET_B, RESNET_IMAGE = 256, 224


def check_resnet50(seed: int, kind: str) -> float:
    """Phase 11. Returns its images/s on the fixed batch."""
    t0 = time.perf_counter()
    B, size, steps = RESNET_B, RESNET_IMAGE, 20
    dev = resolve_device(None)
    torch.backends.cudnn.benchmark = True
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16).to(
        dev).init_weights(seed)
    batch = to_device(synthetic.synthetic_imagenet(B, size, seed).take(1)[0],
                      dev)
    loss_fn = resnet.make_loss_fn(model)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                              momentum=0.9))
    dp = DataParallel()
    step = dp.make_train_step_with_stats(loss_fn)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    curve, step_ms, peak, loop = timed_run(step, state,
                                           iter(lambda: batch, None), steps)
    steady = float(np.median(step_ms[2:]))
    images_per_s = B / (steady / 1e3)
    moved = sum(not torch.equal(b, stats0[n])
                for n, b in model.named_buffers())
    evaluated = dp.make_eval_step_with_stats(resnet.make_metric_fn(model))(
        state, batch)
    with torch.no_grad():
        model.eval()
        logits = model(batch["image"])
        model.train()
    # the FLOPs of one step (forward and backward, as run) on a copy, so
    # that the running statistics stay the trained model's
    twin = copy.deepcopy(model)
    step_flops = traced_matmul_flops(
        lambda: value_and_grad(loss_fn, twin, batch))
    with torch.no_grad():
        fwd_flops = traced_matmul_flops(twin, batch["image"])
    del twin
    # fused BatchNorm on the same weights and batch, both in train mode
    fused = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            fused_bn=True).to(dev)
    fused.load_state_dict(model.state_dict())
    plain = copy.deepcopy(model)
    with torch.no_grad():
        fused_gap = _rel_gap(fused(batch["image"]), plain(batch["image"]))
    del fused, plain
    split = profile_split(step, state, batch)
    torch.backends.cudnn.benchmark = False
    out = {"model": "ResNet50", "B": B, "image": size, "dtype": "bf16",
           "steps": steps, "loss_curve": curve, "step_ms_each": step_ms,
           "step_ms_median_after_2": steady, "images_per_s": images_per_s,
           "images_per_s_over_a100_yardstick_2770":
               images_per_s / A100_IMAGES_PER_SEC_PER_GPU,
           "model_flops_per_step": step_flops,
           "forward_flops_per_image": fwd_flops / B,
           "mfu_vs_989_tflops_bf16": step_flops / (steady / 1e3)
           / BF16_FLOPS_S,
           "max_memory_allocated_bytes": peak,
           "running_stat_buffers_moved": moved,
           "eval": {k: v.item() for k, v in evaluated.items()},
           "fused_bn_logits_rel_gap": fused_gap,
           "dispatch": loop.dispatch_stats.as_dict(),
           "profile": split, "phase_s": time.perf_counter() - t0}
    print(f"resnet50 on {kind}: " + json.dumps(out), flush=True)
    check_falls("resnet50", curve, 5)
    if moved != len(stats0):
        fail(f"resnet50: {len(stats0) - moved} running statistics did not "
             "move")
    if not (torch.isfinite(logits).all()
            and math.isfinite(out["eval"]["loss"])):
        fail("resnet50: non-finite eval logits or loss")
    if not fused_gap <= FUSED_BN_REL:
        fail(f"resnet50: fused BatchNorm logits off by {fused_gap} "
             f"(limit {FUSED_BN_REL})")
    return images_per_s


def check_mnist(seed: int, kind: str) -> None:
    """Phase 12."""
    t0 = time.perf_counter()
    B, steps = 1024, 50
    dev = resolve_device(None)
    model = mnist_cnn.MNISTCNN().to(dev).init_weights(seed)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.05,
                                              momentum=0.9))
    dp = DataParallel()
    held_out = [to_device(b, dev) for b in synthetic.synthetic_mnist(
        B, seed=seed, sample_seed=seed + 100).take(4)]
    hook = EvalHook(Evaluator(dp.make_eval_step(
        mnist_cnn.make_metric_fn(model)), lambda: held_out))
    curve, step_ms, peak, _ = timed_run(
        dp.make_train_step(mnist_cnn.make_loss_fn(model)), state,
        iter(synthetic.synthetic_mnist(B, seed=seed)), steps, [hook])
    steady = float(np.median(step_ms[2:]))
    out = {"model": "MNISTCNN", "B": B, "dtype": "f32", "steps": steps,
           "loss_first_last": [curve[0], curve[-1]],
           "step_ms_median_after_2": steady,
           "images_per_s": B / (steady / 1e3), "eval": hook.latest,
           "max_memory_allocated_bytes": peak,
           "phase_s": time.perf_counter() - t0}
    print(f"mnist on {kind}: " + json.dumps(out), flush=True)
    check_falls("mnist", curve, 5)
    if not hook.latest["accuracy"] > 0.5:
        fail(f"mnist: held-out accuracy {hook.latest['accuracy']} is not "
             "well above chance (0.1)")


WIDE_DEEP_VOCABS = (100000, 100000, 10000, 1000, 100)


def check_wide_deep(seed: int, kind: str) -> None:
    """Phase 13."""
    t0 = time.perf_counter()
    B, steps = 8192, 50
    dev = resolve_device(None)
    model = wide_deep.WideDeep(vocab_sizes=WIDE_DEEP_VOCABS, embed_dim=32,
                               mlp_dims=(256, 128)).to(dev).init_weights(
        seed)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    data = iter(synthetic.SyntheticCTR(B, vocab_sizes=WIDE_DEEP_VOCABS,
                                       seed=seed))
    curve, step_ms, peak, _ = timed_run(
        DataParallel().make_train_step(wide_deep.make_loss_fn(model)),
        state, data, steps)
    steady = float(np.median(step_ms[2:]))
    out = {"model": "WideDeep", "vocab_sizes": WIDE_DEEP_VOCABS,
           "embed_dim": 32, "mlp_dims": [256, 128], "B": B, "dtype": "f32",
           "steps": steps,
           "loss_mean_first_last_10": [float(np.mean(curve[:10])),
                                       float(np.mean(curve[-10:]))],
           "step_ms_median_after_2": steady,
           "examples_per_s": B / (steady / 1e3),
           "max_memory_allocated_bytes": peak,
           "phase_s": time.perf_counter() - t0}
    print(f"wide_deep on {kind}: " + json.dumps(out), flush=True)
    check_falls("wide_deep", curve, 10)


class _Warmup(BaseHook):
    """The learning rate rises linearly to its peak over ``steps``
    steps."""

    def __init__(self, optimizer, steps: int):
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda i: min(1.0, (i + 1) / steps))

    def after_step(self, step, metrics):
        self.sched.step()


def check_bert(seed: int, kind: str) -> None:
    """Phase 14."""
    t0 = time.perf_counter()
    B, S, steps = 256, 128, 20
    dev = resolve_device(None)
    cfg = bert_base(num_classes=2, dtype=torch.bfloat16)
    if cfg.resolve_attn_impl(S) != "dense":
        fail("bert: attn_impl='auto' did not resolve to dense attention")
    model = Transformer(cfg).init_weights(seed).to(dev)
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))
    batch = to_device({"tokens": tokens, "label": tokens[:, 0] % 2}, dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    state = TrainState(model, opt)
    curve, step_ms, peak, _ = timed_run(
        DataParallel().make_train_step(make_cls_loss_fn(model)), state,
        iter(lambda: batch, None), steps,
        [_Warmup(opt, BERT_WARMUP_STEPS)])
    steady = float(np.median(step_ms[2:]))
    out = {"model": "bert_base(num_classes=2)", "B": B, "S": S,
           "dtype": "bf16", "attn": "dense", "steps": steps,
           "adamw_peak_lr": 1e-4, "warmup_steps": BERT_WARMUP_STEPS,
           "loss_curve": curve, "step_ms_median_after_2": steady,
           "sequences_per_s": B / (steady / 1e3),
           "max_memory_allocated_bytes": peak,
           "phase_s": time.perf_counter() - t0}
    print(f"bert on {kind}: " + json.dumps(out), flush=True)
    check_falls("bert", curve, 5)
    last = float(np.mean(curve[-5:]))
    if not last < BERT_LOSS_LAST5:
        fail(f"bert: the last 5 losses average {last}, not below "
             f"{BERT_LOSS_LAST5}: it did not learn its batch")


# ---- phases 15-17: pipeline and tensor parallelism ---------------------------

# phase 15: bench_gpt2_pp.py's 16,384 tokens a step at the sequence where
# "auto" takes flash
PP1_M, PP1_MB, PP_S, PP1_STEPS = 4, 4, 1024, 10
# phase 16: (name, pipe, model, schedule, virtual chunks, M, microbatch)
PP_RANK_CASES = (("pipe4-1f1b", 4, 1, "1f1b", 1, 8, 2),
                 ("pipe2-model2-interleaved-1f1b", 2, 2, "1f1b", 2, 4, 2))
PP_RANK_STEPS = 3
# phases 16-18, 20 and 40 (b), ranks sharing the card over gloo, at a cut
# depth: every layer runs the same code, and at 12 layers these phases
# took 35-70 s each on a slow host (PR 20's runs)
MP_LAYERS = 4


def _mp_gpt2() -> TransformerConfig:
    return dataclasses.replace(gpt2_124m(dtype=torch.bfloat16),
                               num_layers=MP_LAYERS)


def _mp_bert() -> TransformerConfig:
    return dataclasses.replace(bert_base(num_classes=2, dtype=torch.bfloat16),
                               num_layers=MP_LAYERS)

# phase 17: phase 14's batch
TP_N, TP_B, TP_S, TP_STEPS = 2, 256, 128, 3


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().view(torch.uint8)
                        .numpy().tobytes()).hexdigest()


def _stage_logits(module, tokens, dtype) -> torch.Tensor:
    """The logits of a stage that holds every layer (pipe = 1), through
    its own modules: embed, each chunk's blocks, the head."""
    e, h = module.embed, module.head
    with torch.no_grad():
        x = (e.tok_emb(tokens).to(dtype)
             + e.pos_emb.weight[:tokens.shape[1]].to(dtype))
        for chunk in module.chunks:
            for blk in chunk:
                x = blk(x)
        return F.linear(h.ln_f(x).float(), h.lm_head.weight)


def _reference_step(cfg, seed: int, tokens: np.ndarray, dev, path=None,
                    cls: bool = False):
    """The single-process step's loss and gradients on the union batch,
    the weights of ``init_weights(seed)``; saved to ``path`` (CPU tensors)
    when given, for the ranks to read."""
    model = Transformer(cfg).init_weights(seed).to(dev)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cls:
        batch["label"] = batch["tokens"][:, 0] % 2
        loss_fn = make_cls_loss_fn(model)
    else:
        loss_fn = make_lm_loss_fn(model)
    (loss, _), grads = value_and_grad(loss_fn, model, batch)
    ref = {"loss": loss.item(), "grads": grads}
    if path is not None:
        torch.save({"loss": ref["loss"],
                    "grads": {n: g.cpu() for n, g in grads.items()}}, path)
    return ref


def _gaps_vs(ref_grads, grads, dev) -> dict:
    return {n: _rel_gap(grads[n], ref_grads[n].to(dev)) for n in grads}


def check_pipeline(seed: int, kind: str) -> None:
    """Phase 15."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    cfg = gpt2_124m(dtype=torch.bfloat16)
    pp = PipelinedLM(build_mesh(MeshSpec()), cfg, PP1_M, schedule="auto",
                     device=dev)
    if pp.schedule != "gpipe" or not pp.fused_ce:
        fail(f"pipeline: schedule {pp.schedule}, fused CE {pp.fused_ce}; "
             "expected GPipe and fused CE at pipe=1 on the card")
    module = pp.init_params(seed)
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (PP1_M * PP1_MB, PP_S)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}

    # the first step against the unpipelined step on the union batch
    FA.reset_launch_counts()
    loss0, grads = pp.loss_and_grads(module, batch)
    torch.cuda.synchronize()
    launches = dict(FA.LAUNCHES)
    grads = pp.to_serving_params(grads)
    ref = _reference_step(cfg, seed, tokens, dev)
    gaps = _gaps_vs(ref["grads"], grads, dev)
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(loss0.item() - ref["loss"])
    del grads, ref

    # serving: the gathered weights through Transformer against the
    # stage's own forward, one microbatch
    serving = Transformer(cfg).to(dev)
    serving.load_state_dict(pp.to_serving_params(module))
    mb0 = batch["tokens"][:PP1_MB]
    with torch.no_grad():
        serve_gap = _rel_gap(serving(mb0), _stage_logits(module, mb0,
                                                         cfg.dtype))
    del serving
    torch.cuda.empty_cache()

    # the main path: 10 Adam steps through make_train_step and TrainLoop
    opt = pp.init_opt_state(functools.partial(torch.optim.Adam, lr=1e-3),
                            module)
    FA.reset_launch_counts()
    curve, step_ms, peak, _ = timed_run(
        pp.make_train_step(opt), module, iter(lambda: batch, None),
        PP1_STEPS)
    run_launches = {n: FA.LAUNCHES[n] for n in K1_K3}
    steady = float(np.median(step_ms[2:]))
    # one more step under the profiler: how busy the card is, and on what
    prof = profile_split(pp.make_train_step(opt), module, batch)
    out = {"model": "gpt2_124m", "pipe": 1, "schedule": pp.schedule,
           "M": PP1_M, "microbatch": PP1_MB, "S": PP_S,
           "dtype": "bf16 compute, f32 params", "fused_ce": pp.fused_ce,
           "steps": PP1_STEPS, "loss_curve": curve,
           "first_step_loss_gap": loss_gap, "worst_grad": worst,
           "worst_grad_rel_gap": gaps[worst],
           "median_grad_rel_gap": float(np.median(list(gaps.values()))),
           "serving_logits_rel_gap": serve_gap,
           "step_ms_each": step_ms, "step_ms_median_steps_3_10": steady,
           "tokens_per_s": PP1_M * PP1_MB * PP_S / (steady / 1e3),
           "max_memory_allocated_bytes": peak,
           "profiled_step": {k: prof[k] for k in (
               "device_ms", "wall_ms_profiled", "device_busy_share",
               "top10_ops_ms_calls")},
           "phase_s": time.perf_counter() - t0}
    print(f"pipeline (1 process) on {kind}: " + json.dumps(out), flush=True)
    want = dict.fromkeys(K1_K3, cfg.num_layers * PP1_M)
    print("pipeline (1 process) K1-K3 launches: " + json.dumps(
        {"first_step": {n: launches[n] for n in K1_K3},
         "per_step_over_the_run": {n: run_launches[n] / PP1_STEPS
                                   for n in K1_K3},
         "expected_per_step": want}), flush=True)
    if ({n: launches[n] for n in K1_K3} != want
            or run_launches != {n: PP1_STEPS * c for n, c in want.items()}
            or launches["flash_carry"] or FA.fallback_stats()):
        fail(f"pipeline: launches {launches} / {run_launches} over "
             f"{PP1_STEPS} steps, expected {want} a step; fallbacks "
             f"{FA.fallback_stats()}")
    if gaps[worst] > GRAD_REL_GAP or loss_gap > 1e-2:
        fail(f"pipeline: {worst} relative gap {gaps[worst]} (limit "
             f"{GRAD_REL_GAP}), loss gap {loss_gap}")
    if serve_gap > GRAD_REL_GAP:
        fail(f"pipeline: serving logits off by {serve_gap}")
    if abs(curve[0] - LN_VOCAB) > LOSS0_MARGIN:
        fail(f"pipeline: first loss {curve[0]} is not within "
             f"{LOSS0_MARGIN} of ln(50304) = {LN_VOCAB}")
    check_falls("pipeline", curve, 3)


def pp_rank(seed: int, ref_dir: str) -> dict:
    """One rank of phase 16 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    cfg = _mp_gpt2()
    full = Transformer(cfg).init_weights(seed).state_dict()
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    for name, P, tp, schedule, v, M, mb in PP_RANK_CASES:
        mesh = build_mesh(MeshSpec(data=1, pipe=P, model=tp))
        pp = PipelinedLM(mesh, cfg, M, schedule=schedule, virtual_chunks=v,
                         device=dev)
        module = pp.shard_params(full)
        tokens = np.random.RandomState(seed).randint(
            0, 50257, (M * mb, PP_S)).astype(np.int64)
        batch = {"tokens": torch.as_tensor(tokens, device=dev)}
        FA.reset_launch_counts()
        with cc.trace_comm() as rec:
            loss0, grads = pp.loss_and_grads(module, batch)
        torch.cuda.synchronize()
        launches = dict(FA.LAUNCHES)
        ref = torch.load(f"{ref_dir}/{name}.pt")
        gaps = _gaps_vs(pp.stage_state_dict(ref["grads"]), grads, dev)
        worst = max(gaps, key=gaps.get)
        del grads, ref["grads"]
        opt = pp.init_opt_state(functools.partial(torch.optim.Adam, lr=1e-3),
                                module)
        dist.barrier()
        FA.reset_launch_counts()
        curve, step_ms, peak = timed_run(
            pp.make_train_step(opt), module, iter(lambda: batch, None),
            PP_RANK_STEPS)[:3]
        out[name] = {
            "coords": [mesh.axis("pipe").index, mesh.axis("model").index],
            "layers": sum(len(c) for c in module.chunks),
            # the last chunk-stage runs its chunk once a microbatch (1F1B
            # recomputes every other chunk on its backward tick)
            "last_chunk_layers": (pp.layers_per_chunk
                                  if pp.stage == P - 1 else 0),
            "fused_ce": pp.fused_ce, "launches": launches,
            "run_launches": dict(FA.LAUNCHES),
            "loss_gap": abs(loss0.item() - ref["loss"]),
            "worst_grad": worst, "worst_grad_rel_gap": gaps[worst],
            "wire": rec.wire.get("ppermute[pipe]", 0.0),
            "want_wire": pp.pipe_wire_bytes_per_step(mb, PP_S),
            "closed_form": pp.ppermute_bytes_per_step(mb, PP_S),
            "loss_curve": curve, "step_ms": step_ms,
            "max_memory_allocated_bytes": peak,
            "digests": {n: _digest(t) for n, t in module.state_dict().items()
                        if not n.startswith("chunks.")
                        or split_dim(n) is None}}
        del module, opt
        torch.cuda.empty_cache()
    return out


def check_pipeline_ranks(seed: int, kind: str) -> None:
    """Phase 16."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    cfg = _mp_gpt2()
    with tempfile.TemporaryDirectory(prefix="dtg_pp_ref_") as ref_dir:
        for name, _, _, _, _, M, mb in PP_RANK_CASES:
            tokens = np.random.RandomState(seed).randint(
                0, 50257, (M * mb, PP_S)).astype(np.int64)
            _reference_step(cfg, seed, tokens, dev, f"{ref_dir}/{name}.pt")
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        res = [r.result for r in run_multiprocess(
            "chip_smoke:pp_rank", 4, [seed, ref_dir], timeout=900)]
    for name, P, tp, _, v, M, _ in PP_RANK_CASES:
        per = [r[name] for r in res]
        print(f"pipeline {name} on {kind} ({_layout(res)}; gloo on one "
              "card, not NCCL): " + json.dumps(
                  {k: [p[k] for p in per] for k in (
                      "coords", "layers", "fused_ce", "loss_gap",
                      "worst_grad", "worst_grad_rel_gap", "wire",
                      "want_wire", "closed_form", "loss_curve", "step_ms",
                      "max_memory_allocated_bytes")}), flush=True)
        print(f"pipeline {name} K1-K3 launches a rank, first step and "
              f"the {PP_RANK_STEPS} timed steps: " + json.dumps(
                  [{n: [p["launches"][n], p["run_launches"][n]]
                    for n in K1_K3} for p in per]), flush=True)
        for p in per:
            lm = p["layers"] * M
            want = {"flash_fwd": 2 * lm - p["last_chunk_layers"] * M,
                    "flash_dq": lm, "flash_dkv": lm, "flash_carry": 0}
            run_want = {n: PP_RANK_STEPS * c for n, c in want.items()}
            if p["launches"] != want or p["run_launches"] != run_want:
                fail(f"pipeline {name} rank {p['coords']}: launches "
                     f"{p['launches']} in the first step and "
                     f"{p['run_launches']} in {PP_RANK_STEPS} steps, "
                     f"expected {want} a step")
            if p["worst_grad_rel_gap"] > GRAD_REL_GAP or p["loss_gap"] > 1e-2:
                fail(f"pipeline {name} rank {p['coords']}: "
                     f"{p['worst_grad']} gap {p['worst_grad_rel_gap']}, "
                     f"loss gap {p['loss_gap']}")
            if not all(math.isfinite(x) for x in p["loss_curve"]):
                fail(f"pipeline {name}: non-finite loss {p['loss_curve']}")
        act = 2 * PP_S * cfg.d_model * 2  # microbatch 2, bf16
        want_wire = 2 * M * act * (P * v - 1)
        for i in range(tp):
            group = [p for p in per if p["coords"][1] == i]
            wire = sum(p["wire"] for p in group)
            if wire != want_wire or group[0]["want_wire"] != want_wire:
                fail(f"pipeline {name}: pipe group {i} wire {wire}, "
                     f"expected 2*M*act*(P*v-1) = {want_wire}")
            if v == 1 and wire != P * group[0]["closed_form"]:
                fail(f"pipeline {name}: wire {wire} is not P x "
                     f"ppermute_bytes_per_step {group[0]['closed_form']}")
        for p in per:
            s, i = p["coords"]
            for q in per:
                for n, dg in p["digests"].items():
                    same_copy = (not n.startswith("chunks.")
                                 and q["coords"][1] == i)
                    same_repl = split_dim(n) is None and q["coords"][0] == s
                    if (same_copy or same_repl) and q["digests"][n] != dg:
                        fail(f"pipeline {name}: {n} differs between ranks "
                             f"{p['coords']} and {q['coords']}")
    print(f"pipeline ranks phase: {time.perf_counter() - t0:.1f} s "
          f"(references {ref_s:.1f} s)", flush=True)


def tp_rank(seed: int, ref_path: str) -> dict:
    """One rank of phase 17 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=1, model=TP_N))
    cfg = _mp_bert()
    tp = TensorParallel(mesh, device=dev)
    model = tp.shard(Transformer(cfg).init_weights(seed))
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                 (TP_B, TP_S))
    batch = to_device({"tokens": tokens, "label": tokens[:, 0] % 2}, dev)
    loss_fn = make_cls_loss_fn(model)
    with mesh:
        (loss0, _), grads = value_and_grad(loss_fn, model, batch)
    ref = torch.load(ref_path)
    gaps = _gaps_vs(tp.shard_state_dict(ref["grads"]), grads, dev)
    worst = max(gaps, key=gaps.get)
    del grads, ref["grads"]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    dist.barrier()
    curve, step_ms, peak, _ = timed_run(
        tp.make_train_step(loss_fn), TrainState(model, opt),
        iter(lambda: batch, None), TP_STEPS,
        [_Warmup(opt, BERT_WARMUP_STEPS)])
    return {"rank": dist.get_rank(), "device": str(dev),
            "backend": dist.get_backend(),
            "loss_gap": abs(loss0.item() - ref["loss"]),
            "worst_grad": worst, "worst_grad_rel_gap": gaps[worst],
            "loss_curve": curve, "step_ms": step_ms,
            "max_memory_allocated_bytes": peak,
            "digests": {n: _digest(t) for n, t in model.state_dict().items()
                        if split_dim(n) is None}}


def check_bert_tp(seed: int, kind: str) -> None:
    """Phase 17."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    cfg = _mp_bert()
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                 (TP_B, TP_S))
    with tempfile.TemporaryDirectory(prefix="dtg_tp_ref_") as ref_dir:
        _reference_step(cfg, seed, tokens, dev, f"{ref_dir}/bert.pt",
                        cls=True)
        torch.cuda.empty_cache()
        res = [r.result for r in run_multiprocess(
            "chip_smoke:tp_rank", TP_N, [seed, f"{ref_dir}/bert.pt"],
            timeout=900)]
    print(f"bert tensor-parallel on {kind} ({_layout(res)}; gloo on one "
          "card, not NCCL): " + json.dumps(
              {k: [r[k] for r in res] for k in (
                  "loss_gap", "worst_grad", "worst_grad_rel_gap",
                  "loss_curve", "step_ms", "max_memory_allocated_bytes")}
              | {"phase_s": time.perf_counter() - t0}), flush=True)
    for r in res:
        if r["worst_grad_rel_gap"] > GRAD_REL_GAP or r["loss_gap"] > 1e-2:
            fail(f"bert tp rank {r['rank']}: {r['worst_grad']} gap "
                 f"{r['worst_grad_rel_gap']}, loss gap {r['loss_gap']}")
        if not all(math.isfinite(x) for x in r["loss_curve"]):
            fail(f"bert tp: non-finite loss {r['loss_curve']}")
    if res[0]["digests"] != res[1]["digests"]:
        bad = [n for n in res[0]["digests"]
               if res[0]["digests"][n] != res[1]["digests"][n]]
        fail(f"bert tp: replicated parameters differ across model: {bad}")


# ---- phases 18-21: the data-parallel family ---------------------------------

# phase 18: phase 7's global batch of 8 sequences over 2 ranks
FSDP_N, FSDP_B, FSDP_STEPS = 2, 4, 3
# phase 19: phase 10's run, overlap on against off
OV_STEPS = 3
# phase 20: model = 2, 2 sequences at S = 1024
SPTP_N, SPTP_B, SPTP_STEPS = 2, 2, 3
# phase 21: examples/async_ps_family.py's settings: a global batch of 256,
# K = 4, SGD 0.05 with momentum 0.9 (Adam 1e-3 for ADAG); the emulator's
# workers take 64 each
PS_N, PS_B, PS_K, PS_CALLS, PS_EVENTS = 4, 64, 4, 12, 48
PS_LR, PS_ADAG_LR = 0.05, 1e-3


def _shard_bytes(full: dict, specs: dict, world: int) -> int:
    """A rank's bytes of the FSDP shards of ``full`` (f32)."""
    return sum(4 * t.numel() // (world if "data" in specs[n] else 1)
               for n, t in full.items())


def fsdp_rank(seed: int, ref_path: str) -> dict:
    """One rank of phase 18 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=FSDP_N))
    i = mesh.axis("data").index
    cfg = _mp_gpt2()
    fs = FSDP(mesh, device=dev)
    full = Transformer(cfg).init_weights(seed)  # on the host
    model = fs.shard(full)
    full_sd = {n: p.detach() for n, p in full.named_parameters()}
    del full
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (FSDP_N * FSDP_B, PP_S)).astype(np.int64)
    share = {"tokens": torch.as_tensor(tokens[i * FSDP_B:(i + 1) * FSDP_B],
                                       device=dev)}
    loss_fn = make_lm_loss_fn(model)
    (loss0, _), grads = fs.value_and_grad(loss_fn, model, share)
    loss0 = cc.pmean(loss0, "data", mesh=mesh).item()
    ref = torch.load(ref_path)
    gaps = _gaps_vs(fs.shard_state_dict(ref["grads"]), grads, dev)
    worst = max(gaps, key=gaps.get)
    del grads, ref["grads"]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dist.barrier()
    FA.reset_launch_counts()
    with cc.trace_comm() as rec:
        curve, step_ms, peak, _ = timed_run(
            fs.make_train_step(loss_fn), TrainState(model, opt),
            iter(lambda: share, None), FSDP_STEPS)
    launches = dict(FA.LAUNCHES)
    sharded = [n for n, sp in fs.specs.items() if "data" in sp]
    sharded_bytes = sum(4 * full_sd[n].numel() for n in sharded)
    return {"rank": dist.get_rank(), "device": str(dev),
            "backend": dist.get_backend(), "prefetch": fs.prefetch,
            "loss_gap": abs(loss0 - ref["loss"]), "worst_grad": worst,
            "worst_grad_rel_gap": gaps[worst],
            "loss_curve": curve, "step_ms": step_ms,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "n_sharded": len(sharded),
            "n_replicated": len(fs.specs) - len(sharded),
            "sharded_bytes": sharded_bytes,
            "replicated_bytes": sum(4 * t.numel() for t in full_sd.values())
            - sharded_bytes,
            "shard_bytes": _shard_bytes(full_sd, fs.specs, FSDP_N),
            "state_bytes": fs.state_bytes(model, opt),
            "comm": {k: [rec.calls[k], rec.wire[k]] for k in rec.calls}}


def check_fsdp(seed: int, kind: str) -> None:
    """Phase 18."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    cfg = _mp_gpt2()
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (FSDP_N * FSDP_B, PP_S)).astype(np.int64)
    with tempfile.TemporaryDirectory(prefix="dtg_fsdp_ref_") as ref_dir:
        _reference_step(cfg, seed, tokens, dev, f"{ref_dir}/gpt2.pt")
        torch.cuda.empty_cache()
        res = [r.result for r in run_multiprocess(
            "chip_smoke:fsdp_rank", FSDP_N, [seed, f"{ref_dir}/gpt2.pt"],
            timeout=900)]
    print(f"fsdp on {kind} ({_layout(res)}; gloo on one card, not NCCL): "
          + json.dumps({k: [r[k] for r in res] for k in (
              "prefetch", "loss_gap", "worst_grad", "worst_grad_rel_gap",
              "loss_curve", "step_ms", "max_memory_allocated_bytes",
              "state_bytes", "shard_bytes", "n_sharded", "n_replicated",
              "launches", "comm")} | {"phase_s": time.perf_counter() - t0}),
          flush=True)
    want = {"flash_fwd": FSDP_STEPS * cfg.num_layers,
            "flash_dq": FSDP_STEPS * cfg.num_layers,
            "flash_dkv": FSDP_STEPS * cfg.num_layers, "flash_carry": 0}
    frac = (FSDP_N - 1) / FSDP_N
    for r in res:
        if r["worst_grad_rel_gap"] > GRAD_REL_GAP or r["loss_gap"] > 1e-2:
            fail(f"fsdp rank {r['rank']}: {r['worst_grad']} gap "
                 f"{r['worst_grad_rel_gap']}, loss gap {r['loss_gap']}")
        if r["launches"] != want:
            fail(f"fsdp rank {r['rank']}: launches {r['launches']} over "
                 f"{FSDP_STEPS} steps, expected {want}")
        if r["state_bytes"] != {"params": r["shard_bytes"],
                                "optimizer": 2 * r["shard_bytes"]}:
            fail(f"fsdp rank {r['rank']}: state bytes {r['state_bytes']}, "
                 f"expected the shards' {r['shard_bytes']} (and Adam's two "
                 "moments of them)")
        # the port's copy of fsdp_comm_terms, and the two metrics' pmeans
        terms = fsdp_comm_terms(r["sharded_bytes"], FSDP_N,
                                r["replicated_bytes"])
        want_comm = {
            "all_gather[data]": [FSDP_STEPS * r["n_sharded"],
                                 FSDP_STEPS * terms["param_all_gather"]],
            "reduce_scatter[data]": [
                FSDP_STEPS * r["n_sharded"],
                FSDP_STEPS * terms["grad_reduce_scatter"]],
            "pmean[data]": [
                FSDP_STEPS * (r["n_replicated"] + 2),
                FSDP_STEPS * (terms["replicated_grad_allreduce"]
                              + 2 * 2 * 4 * frac)]}
        if r["comm"] != want_comm:
            fail(f"fsdp rank {r['rank']}: comm {r['comm']}, expected "
                 f"{want_comm}")
    if len({tuple(r["loss_curve"]) for r in res}) != 1:
        fail("fsdp: the ranks report different losses")
    check_falls("fsdp", res[0]["loss_curve"], 1)
    print(f"fsdp phase: {time.perf_counter() - t0:.1f} s", flush=True)


def dp_overlap_rank(seed: int) -> dict:
    """One rank of phase 19 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=DP_N))
    i = mesh.axis("data").index
    cfg = dataclasses.replace(gpt2_124m(dtype=torch.bfloat16),
                              num_layers=DP_LAYERS)
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (DP_B, DP_S)).astype(np.int64)
    per = DP_B // DP_N
    share = {"tokens": torch.as_tensor(tokens[i * per:(i + 1) * per],
                                       device=dev)}
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    ref_grads = None
    for name, overlap, compress in (("off", False, None), ("on", True, None),
                                    ("int8", True, "int8")):
        model = Transformer(cfg).init_weights(seed).to(dev)
        dp = DataParallel(mesh, overlap=overlap, compress=compress)
        loss_fn = make_lm_loss_fn(model)
        # the first step's averaged gradients, each way
        extra = {}
        if overlap:
            if compress:
                bound = _int8_bounds(loss_fn, model, share, mesh)
            pending = []
            _, grads = value_and_grad(ov.bucketed_loss_fn(
                loss_fn, "data", pending=pending, mesh=mesh,
                compress=compress), model, share)
            ov.wait_buckets(pending)
            if compress:
                extra = {"grad_rel_gap": max(
                    _rel_gap(grads[n], ref_grads[n]) for n in grads),
                    "bound_ratio": max(
                    ((grads[n] - ref_grads[n]).abs().max()
                     / bound[n]).item() for n in grads)}
                ref_grads = bound = None
        else:
            _, grads = value_and_grad(loss_fn, model, share)
            grads = cc.pmean(grads, "data", mesh=mesh)
            ref_grads = grads
        grad_digests = {n: _digest(g) for n, g in grads.items()}
        del grads
        state = TrainState(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3))
        dist.barrier()
        FA.reset_launch_counts()
        with cc.trace_comm() as rec:
            curve, step_ms, peak = timed_run(
                dp.make_train_step(loss_fn), state,
                iter(lambda: share, None), OV_STEPS)[:3]
        out[name] = {
            "overlap": dp.overlap, "loss_curve": curve, "step_ms": step_ms,
            "max_memory_allocated_bytes": peak,
            "launches": dict(FA.LAUNCHES),
            "pmean_calls": rec.calls["pmean[data]"],
            "pmean_wire": rec.wire["pmean[data]"],
            "psum_calls": rec.calls["psum[data]"],
            "psum_wire": rec.wire["psum[data]"],
            "pmax_calls": rec.calls["pmax[data]"],
            "pmax_wire": rec.wire["pmax[data]"], **extra,
            "buckets": len(ov.bucket_assignment(
                list(model.parameters()), ov.DEFAULT_BUCKET_BYTES)),
            "grad_bytes": sum(p.numel() * 4 for p in model.parameters()),
            "grad_digests": grad_digests,
            "param_digests": {n: _digest(p) for n, p in
                              model.state_dict().items()}}
        del state, model
        torch.cuda.empty_cache()
    return out


def _int8_bounds(loss_fn, model, share, mesh) -> dict:
    """Each parameter's bound under ``compress="int8"``: half the shared
    scale of its bucket, amax over both ranks' local gradients of the
    bucket / (127 // n) (the JAX package's ``int8_pmean`` bound)."""
    _, local = value_and_grad(loss_fn, model, share)
    names = list(local)
    bound = {}
    for group in ov.bucket_assignment([local[n] for n in names],
                                      ov.DEFAULT_BUCKET_BYTES):
        amax = torch.stack([local[names[i]].abs().max() for i in group])
        amax = cc.pmax(amax.max(), "data", mesh=mesh)
        for i in group:
            bound[names[i]] = amax / (127 // DP_N) / 2
    return bound


def check_dp_overlap(seed: int, kind: str) -> None:
    """Phase 19."""
    t0 = time.perf_counter()
    res = [r.result for r in run_multiprocess(
        "chip_smoke:dp_overlap_rank", DP_N, [seed], timeout=900)]
    print(f"bucketed dp on {kind} ({_layout(res)}; gloo on one card, not "
          "NCCL): " + json.dumps({f"{k}_{w}": [r[w][k] for r in res]
                                  for w in ("off", "on", "int8") for k in (
                                      "loss_curve", "step_ms", "pmean_calls",
                                      "pmean_wire", "psum_wire", "pmax_wire",
                                      "buckets",
                                      "max_memory_allocated_bytes")}
                                 | {"int8_grad_rel_gap": [
                                     r["int8"]["grad_rel_gap"] for r in res],
                                    "int8_error_over_bound": [
                                        r["int8"]["bound_ratio"]
                                        for r in res]}
                                 | {"phase_s": time.perf_counter() - t0}),
          flush=True)
    layers = OV_STEPS * DP_LAYERS
    want = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
            "flash_carry": 0}
    frac = 2 * (DP_N - 1) / DP_N
    for r in res:
        off, on = r["off"], r["on"]
        if off["overlap"] or not on["overlap"]:
            fail(f"bucketed dp: overlap resolved {off['overlap']} / "
                 f"{on['overlap']}")
        if on["grad_digests"] != off["grad_digests"]:
            bad = [n for n in on["grad_digests"]
                   if on["grad_digests"][n] != off["grad_digests"][n]]
            fail(f"bucketed dp rank {r['rank']}: gradients differ from the "
                 f"monolithic pmean's: {bad}")
        if on["param_digests"] != off["param_digests"]:
            fail(f"bucketed dp rank {r['rank']}: parameters differ after "
                 f"{OV_STEPS} steps")
        for run in (off, on):
            if run["launches"] != want:
                fail(f"bucketed dp: launches {run['launches']}, expected "
                     f"{want}")
        metric_wire = 2 * 4 * frac  # loss and perplexity
        if (on["pmean_calls"] != OV_STEPS * (on["buckets"] + 1)
                or off["pmean_calls"] != OV_STEPS * 2
                or on["pmean_wire"] != off["pmean_wire"]
                or on["pmean_wire"] != OV_STEPS * (
                    on["grad_bytes"] * frac + metric_wire)):
            fail(f"bucketed dp rank {r['rank']}: all-reduces "
                 f"{on['pmean_calls']} ({on['buckets']} buckets) / "
                 f"{off['pmean_calls']}, wire {on['pmean_wire']} / "
                 f"{off['pmean_wire']}")
        q = r["int8"]
        if q["launches"] != want:
            fail(f"int8 dp: launches {q['launches']}, expected {want}")
        # 1 byte an element, 4 bytes of scale a bucket, the metrics' f32
        want_wire = {"psum": OV_STEPS * q["grad_bytes"] / 4 * frac,
                     "pmax": OV_STEPS * q["buckets"] * 4 * frac,
                     "pmean": OV_STEPS * metric_wire}
        got_wire = {w: q[f"{w}_wire"] for w in want_wire}
        if (got_wire != want_wire or q["psum_calls"] != OV_STEPS
                * q["buckets"] or q["pmax_calls"] != OV_STEPS * q["buckets"]
                or q["pmean_calls"] != OV_STEPS):
            fail(f"int8 dp rank {r['rank']}: wire {got_wire}, expected "
                 f"{want_wire}; calls psum {q['psum_calls']}, pmax "
                 f"{q['pmax_calls']}, pmean {q['pmean_calls']} "
                 f"({q['buckets']} buckets, {OV_STEPS} steps)")
        if q["bound_ratio"] > 1.0 + 1e-3:
            fail(f"int8 dp rank {r['rank']}: a gradient sits "
                 f"{q['bound_ratio']} shared-scale half-steps from the "
                 "uncompressed one")
        # the JAX test's 2e-2 loss band is for SGD on a least-squares toy;
        # under Adam the quantiser's noise on the smallest gradients of a
        # bucket moves the trajectory further (printed above): gated here
        # is that it learns
        check_falls(f"int8 dp rank {r['rank']}", q["loss_curve"], 1)
    print(f"bucketed dp phase: {time.perf_counter() - t0:.1f} s", flush=True)


def sp_tp_rank(seed: int) -> dict:
    """One rank of phase 20 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=1, model=SPTP_N))
    cfg = _mp_gpt2()
    full = Transformer(cfg).init_weights(seed)
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (SPTP_B, PP_S)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    firsts = {}
    for name, rules in (("default", DEFAULT_RULES),
                        ("sp", MEGATRON_SP_RULES)):
        tp = TensorParallel(mesh, rules=rules, device=dev)
        model = tp.shard(full)
        loss_fn = make_lm_loss_fn(model)
        with cc.trace_comm() as rec:
            (loss0, _), grads = tp.value_and_grad(loss_fn, model, batch)
        # on the host, out of the other run's peak memory
        firsts[name] = (loss0.item(), {n: g.cpu() for n, g in grads.items()})
        del grads
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        dist.barrier()
        FA.reset_launch_counts()
        curve, step_ms, peak = timed_run(
            tp.make_train_step(loss_fn), TrainState(model, opt),
            iter(lambda: batch, None), SPTP_STEPS)[:3]
        out[name] = {"loss_curve": curve, "step_ms": step_ms,
                     "max_memory_allocated_bytes": peak,
                     "launches": dict(FA.LAUNCHES),
                     "heads": model.cfg.num_heads,
                     "fused_ce": resolve_fused_ce(
                         "auto", vocab_size=model.cfg.vocab_size,
                         platform=dev.type),
                     "comm": {k: [rec.calls[k], rec.wire[k]]
                              for k in rec.calls}}
        del model, opt
        torch.cuda.empty_cache()
    (l_d, g_d), (l_s, g_s) = firsts["default"], firsts["sp"]
    gaps = _gaps_vs(g_d, g_s, "cpu")
    worst = max(gaps, key=gaps.get)
    out.update({"loss_gap": abs(l_s - l_d), "worst_grad": worst,
                "worst_grad_rel_gap": gaps[worst],
                "replicated_bytes": sum(
                    4 * t.numel() for n, t in full.state_dict().items()
                    if split_dim(n) is None)})
    return out


def check_sp_tp(seed: int, kind: str) -> None:
    """Phase 20."""
    t0 = time.perf_counter()
    res = [r.result for r in run_multiprocess(
        "chip_smoke:sp_tp_rank", SPTP_N, [seed], timeout=900)]
    print(f"megatron sp on {kind} ({_layout(res)}; gloo on one card, not "
          "NCCL): " + json.dumps(
              {k: [r[k] for r in res] for k in (
                  "loss_gap", "worst_grad", "worst_grad_rel_gap")}
              | {f"{k}_{w}": [r[w][k] for r in res]
                 for w in ("default", "sp") for k in (
                     "loss_curve", "step_ms", "max_memory_allocated_bytes",
                     "launches", "comm")}
              | {"phase_s": time.perf_counter() - t0}), flush=True)
    cfg = _mp_gpt2()
    want = dict.fromkeys(K1_K3, SPTP_STEPS * cfg.num_layers) | {
        "flash_carry": 0}
    frac = (SPTP_N - 1) / SPTP_N
    for r in res:
        if r["worst_grad_rel_gap"] > GRAD_REL_GAP or r["loss_gap"] > 1e-2:
            fail(f"megatron sp rank {r['rank']}: {r['worst_grad']} gap "
                 f"{r['worst_grad_rel_gap']}, loss gap {r['loss_gap']}")
        d, s = r["default"], r["sp"]
        for name, run in (("default", d), ("sp", s)):
            if (run["launches"] != want
                    or run["heads"] != cfg.num_heads // SPTP_N):
                fail(f"megatron sp ({name}): launches {run['launches']} at "
                     f"{run['heads']} heads, expected {want} at "
                     f"{cfg.num_heads // SPTP_N}")
            if not all(math.isfinite(x) for x in run["loss_curve"]):
                fail(f"megatron sp ({name}): non-finite loss")
        dc, sc = d["comm"], s["comm"]
        # no psum in the blocks: the loss's two and the replicated
        # gradients' one are all that stay
        if "psum_bwd[model]" in sc or sc["psum[model]"][0] != 3:
            fail(f"megatron sp: psums left {sc}")
        if not (d["fused_ce"] and s["fused_ce"]):
            fail("megatron sp: the vocab-parallel fused CE is not on")
        # the blocks' and the embedding's pairs against the all-reduces
        # they replace (bf16 (B, S, D) activations both ways). The head
        # differs by design: the default rules' fused CE sums an f32 dx
        # over the S - 1 predicting positions, SP gathers the bf16 hidden
        # states of all S and reduce-scatters their gradient
        act = SPTP_B * PP_S * cfg.d_model * 2
        head_pair = 2 * act * frac
        default_head = 2 * frac * 4 * SPTP_B * (PP_S - 1) * cfg.d_model
        loss_sums = sc["psum[model]"][1] - 2 * r["replicated_bytes"] * frac
        pairs = sum(sc[k][1] for k in (
            "all_gather[model]", "reduce_scatter[model]",
            "all_gather_bwd[model]", "reduce_scatter_bwd[model]"))
        replaced = (dc["psum[model]"][1] + dc["psum_bwd[model]"][1]
                    - loss_sums - default_head)
        if pairs - head_pair != replaced:
            fail(f"megatron sp: gather/scatter wire {pairs - head_pair} "
                 f"in the blocks and the embedding, the default rules' "
                 f"all-reduces {replaced}")
    print(f"megatron sp phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


def _ps_superbatch(it, k: int, i: int) -> dict:
    """K global batches stacked, this rank's rows of each."""
    bs = [next(it) for _ in range(k)]
    return {key: np.stack([b[key][i * PS_B:(i + 1) * PS_B] for b in bs])
            for key in bs[0]}


def ps_rank(seed: int) -> dict:
    """One rank of phase 21 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=PS_N))
    i = mesh.axis("data").index
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend()}
    for name in ("local_sgd", "gossip", "accumulated_adaptive"):
        model = mnist_cnn.MNISTCNN().to(dev).init_weights(seed)
        loss_fn = mnist_cnn.make_loss_fn(model)
        data = iter(synthetic.synthetic_mnist(PS_N * PS_B, seed=seed))
        if name == "accumulated_adaptive":
            strat = AccumulatedAdaptive(mesh, PS_K, device=dev)
            opt = torch.optim.Adam(model.parameters(), lr=PS_ADAG_LR)
        else:
            strat = (LocalSGD(mesh, PS_K, device=dev) if name == "local_sgd"
                     else GossipSGD(mesh, device=dev))
            opt = torch.optim.SGD(model.parameters(), lr=PS_LR,
                                  momentum=0.9)
        k = 1 if name == "gossip" else PS_K
        batches = [_ps_superbatch(data, k, i) for _ in range(PS_CALLS)]
        if name == "gossip":
            batches = [{key: v[0] for key, v in b.items()} for b in batches]
        state = TrainState(model, opt)
        dist.barrier()
        with cc.trace_comm() as rec:
            curve, step_ms, peak = timed_run(
                strat.make_train_step(loss_fn), state, iter(batches),
                PS_CALLS)[:3]
        res = {"loss_curve": curve, "step_ms": step_ms,
               "local_steps": state.step,
               "comm": {key: [rec.calls[key], rec.bytes[key]]
                        for key in rec.calls},
               "digest": _digest(torch.cat([p.detach().reshape(-1) for p in
                                            model.parameters()]))}
        if name == "gossip":
            res["consensus_digest"] = _digest(torch.cat(
                [t.reshape(-1) for t in strat.consensus(state).values()]))
        out[name] = res
    return out


def check_async_ps(seed: int, kind: str) -> None:
    """Phase 21."""
    t0 = time.perf_counter()
    res = [r.result for r in run_multiprocess(
        "chip_smoke:ps_rank", PS_N, [seed], timeout=900)]
    for name in ("local_sgd", "gossip", "accumulated_adaptive"):
        per = [r[name] for r in res]
        print(f"{name} on {kind} ({_layout(res)}; gloo on one card, not "
              "NCCL): " + json.dumps({k: [p[k] for p in per] for k in (
                  "loss_curve", "step_ms", "local_steps", "comm")}),
              flush=True)
        for p in per:
            check_falls(name, p["loss_curve"], 3)
        if name != "gossip" and len({p["digest"] for p in per}) != 1:
            fail(f"{name}: the replicas differ after the sync")
    dev = resolve_device(None)
    for p in [r["local_sgd"] for r in res]:
        # one pmean of the parameters, one of the momentum buffers and
        # the loss's, a call of K local steps
        if (p["comm"]["pmean[data]"][0] != 3 * PS_CALLS
                or p["local_steps"] != PS_K * PS_CALLS):
            fail(f"local_sgd: {p['comm']} over {PS_CALLS} calls, "
                 f"{p['local_steps']} local steps")
    gossip = [r["gossip"] for r in res]
    if len({p["digest"] for p in gossip}) != PS_N:
        fail("gossip: the replicas agree before the consensus")
    if len({p["consensus_digest"] for p in gossip}) != 1:
        fail("gossip: the replicas disagree on the consensus")
    for p in gossip:
        if p["comm"]["ppermute[data]"][0] != 2 * PS_CALLS:
            fail(f"gossip: {p['comm']}")
    # the emulator: the PS on the host, the gradients on the card
    emulated = {}
    for mode in ("hogwild", "downpour", "adag"):
        model = mnist_cnn.MNISTCNN().to(dev).init_weights(seed)
        em = AsyncPSEmulator(
            mnist_cnn.make_loss_fn(model), model, n_workers=PS_N, mode=mode,
            lr=PS_ADAG_LR if mode == "adag" else PS_LR, fetch_period=PS_K,
            seed=seed)
        start = time.perf_counter()
        losses = em.run(iter(synthetic.synthetic_mnist(PS_B, seed=seed)),
                        PS_EVENTS)
        emulated[mode] = {"losses_first_last": [losses[0], losses[-1]],
                          "pushes": em.pushes,
                          "events_per_s": PS_EVENTS / (
                              time.perf_counter() - start)}
        check_falls(f"emulator ({mode})", losses, 8)
        if mode != "hogwild" and em.pushes != sum(e // PS_K
                                                  for e in em.events):
            fail(f"emulator ({mode}): {em.pushes} pushes for events "
                 f"{em.events}")
    print(f"async-ps emulator on {kind} (gradients on the card): "
          + json.dumps(emulated | {"phase_s": time.perf_counter() - t0}),
          flush=True)


# ---- phases 22-23: speculative decoding and the multi-LoRA engine --------

SPEC_K, SPEC_G = 4, 4  # draft layers, lookahead
LORA_RANK, LORA_ADAPTERS = 16, 4
# the LoRA phase's prefill chunk, and its prompts' lengths: a prompt goes
# through the engine in one chunk of LORA_CHUNK rows and through the
# one-shot generator in one chunk of its own length, so both must take
# K5/K6's chunk regime (CHUNK_MIN_ROWS rows and up: below it K5 takes the
# split regime, another algorithm) for the streams to be bitwise equal;
# cuBLAS's bf16 GEMMs at GPT-2's widths give each row the bits of a
# one-row product up to 64 rows (measured on an H100: PERF.md section 6)
LORA_CHUNK = 32


def _identity_past(model, layers: int):
    """A copy of ``model`` whose blocks from ``layers`` on add nothing
    (their ``attn.proj`` and ``mlp.down`` weights zero): its first
    ``layers`` blocks compute its logits, so a draft of that depth agrees
    with it everywhere."""
    copy_ = copy.deepcopy(model)
    with torch.no_grad():
        for blk in copy_.blocks[layers:]:
            blk.attn.proj.weight.zero_()
            blk.mlp.down.weight.zero_()
    return copy_


def check_speculative(cfg, model, seed, kind) -> dict:
    """Phase 22: speculative decoding at B=4, P=512, 64 new tokens, draft
    layers 4, lookahead 4, greedy and sampled (temperature 0.8, top-k
    20), bf16 and int8 caches, on the random model (where the 4-layer
    draft's tokens rarely agree with the 12-layer model's) and, bf16, on
    a copy whose last 8 blocks add nothing (every draft agrees): the
    stream equals the vanilla one-shot's bitwise (both captured; the
    first call of each captures, the second is timed); K5's launches
    exact per replay: the two prompts in the chunk regime (12 + 4
    layers), each round's 5 draft steps (4 layers) and its 5-row verify
    chunk (12 layers) in the split one. Returns K5's launches by regime
    over the timed speculative calls."""
    B, P, N = 4, 512, 64
    prompt = np.random.RandomState(seed + 22).randint(
        0, 50257, (B, P)).astype(np.int64)
    total = {"split": 0, "chunk": 0}
    agreeing = _identity_past(model, SPEC_K)
    for kv, net, drafts in ((None, model, "random"), ("int8", model, "random"),
                            (None, agreeing, "agreeing")):
        c = dataclasses.replace(cfg, kv_dtype=kv)
        for temperature, top_k in ((0.0, None), (0.8, 20)):
            mode = "greedy" if top_k is None else "sampled"
            key = np.array([seed, 77], np.uint32)
            kw = dict(max_new_tokens=N, temperature=temperature,
                      top_k=top_k)
            vanilla = make_generate_fn(c, **kw)
            spec = make_generate_fn(c, spec_draft_layers=SPEC_K,
                                    spec_lookahead=SPEC_G, **kw)
            timed_generate(vanilla, net, prompt, key)
            want, van_s, _ = timed_generate(vanilla, net, prompt, key)
            timed_generate(spec, net, prompt, key)
            got, spec_s, counted = timed_generate(spec, net, prompt, key)
            stats = dict(spec.last_stats)
            if not torch.equal(got, want):
                fail(f"speculative {mode} ({kv or 'bf16'} cache): the "
                     f"stream differs from vanilla decoding")
            rounds = stats["verify_steps"]
            expect = {"split": rounds * ((SPEC_G + 1) * SPEC_K
                                         + cfg.num_layers),
                      "chunk": cfg.num_layers + SPEC_K}
            if counted != expect:
                fail(f"speculative {mode}: K5 launches {counted}, expected "
                     f"{expect}")
            if spec.captures != 1 or vanilla.captures != 1:
                fail("speculative: a generator captured more than once")
            if drafts == "agreeing" and stats["accepted_drafts"] != (
                    SPEC_G * stats["verify_steps"]):
                fail(f"speculative {mode}: a draft that agrees with the "
                     f"model everywhere was rejected ({stats})")
            for r in total:
                total[r] += counted[r]
            print(f"speculative {mode} on {kind}: " + json.dumps(
                {"cache": kv or "bf16", "drafts": drafts, **stats,
                 "spec_ms": 1e3 * spec_s,
                 "vanilla_ms": 1e3 * van_s,
                 "spec_over_vanilla": spec_s / van_s,
                 "k5_launches": counted, "equals_vanilla": True}),
                flush=True)
    return total


def _random_bank(cfg, gen) -> dict:
    """A bank of N(0, 0.05) deltas (rank 16: a delta of about half the
    base projection's size), row 0 zero."""
    bank = {}
    for name, zeros in init_adapter_bank(cfg, device="cuda").items():
        t = torch.randn(zeros.shape, generator=gen, device="cuda") * 0.05
        t[0] = 0.0
        bank[name] = t.to(zeros.dtype)
    return bank


def check_lora_first_product(cfg, slots: int = 8, trials: int = 4) -> dict:
    """The premise of ``transformer._lora_delta``'s two routes: a bf16
    ``bmm`` of x (slots, 1, d_in) by the gathered A (slots, d_in, r) gives
    each row the bits of that row's product alone (the one-shot's decode
    step) at the sites it serves, and not at ``LORA_ROW_SUM_SITES``. The
    inputs are built so that any change of summation order shows: each
    row's sum has a +2^26 product near its start and a -2^26 one near its
    end, small integer products between them, which a grouping keeps or
    absorbs. Fails if a ``bmm`` site's rows move; returns the outputs
    that differ a site (of trials x slots x r)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    widths = {"qkv": cfg.d_model, "proj": cfg.num_heads * cfg.head_dim,
              "up": cfg.d_model, "down": cfg.d_ff}
    differing = {}
    for name, d in widths.items():
        differing[name] = 0
        for _ in range(trials):
            x, a = (torch.randint(-3, 4, shape, generator=gen,
                                  device="cuda").float()
                    for shape in ((slots, 1, d), (slots, d, LORA_RANK)))
            x[..., 3] = x[..., d - 5] = 2.0 ** 13
            a[:, 3], a[:, d - 5] = 2.0 ** 13, -(2.0 ** 13)
            x, a = x.bfloat16(), a.bfloat16()
            batched = torch.bmm(x, a)
            differing[name] += sum(
                int((batched[i] != torch.bmm(x[i:i + 1], a[i:i + 1])[0])
                    .sum()) for i in range(slots))
        if name not in LORA_ROW_SUM_SITES and differing[name]:
            fail(f"LoRA {name} site: a {slots}-row bmm moves "
                 f"{differing[name]} outputs off the one-row products")
    print(f"LoRA first product as a bmm, outputs off the one-row bits (of "
          f"{trials * slots * LORA_RANK} a site; the row_sum sites "
          f"{sorted(LORA_ROW_SUM_SITES)} do not take it): "
          + json.dumps(differing), flush=True)
    return differing


def check_lora_engine(cfg, model, seed, kind) -> dict:
    """Phase 23: the engine at 8 slots serving 12 sampled requests
    (temperature 0.8, top-k 20) over adapters 0-4 of a rank-16 bank, on
    GPT-2 124M. With LORA_CHUNK-row prefill chunks and prompts that fit
    one: adapter 0's streams equal the base engine's bitwise; each
    adapter k's equal the one-shot generator's with ``adapter_id=k``
    (B=1, captured) bitwise; at least one adapter stream moves off the
    base one. Then the bank is rewritten in place and 12 more requests
    run on the same engine: no recapture, and their streams follow the
    new bank. Last, phase 4's geometry (128-row chunks) at phase 4's
    prompt lengths (32-700 tokens, up to 6 chunks), where the engine and
    the one-shot prefill through other kernels: every stream is held to
    a teacher-forced forward of the LoRA model under its adapter id,
    within LOGIT_MARGIN. K6's launches are counted a drain. Returns them
    by regime over the LoRA engine's drains. First,
    :func:`check_lora_first_product`."""
    check_lora_first_product(cfg)
    lcfg = dataclasses.replace(cfg, lora_rank=LORA_RANK,
                               lora_adapters=LORA_ADAPTERS)
    rs = np.random.RandomState(seed + 23)
    prompts = [rs.randint(0, 50257, rs.randint(DA.CHUNK_MIN_ROWS,
                                               LORA_CHUNK + 1))
               .astype(np.int32) for _ in range(12)]
    ids = [i % (LORA_ADAPTERS + 1) for i in range(12)]
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    banks = [_random_bank(lcfg, gen), _random_bank(lcfg, gen)]
    bank_mb = sum(t.numel() * t.element_size()
                  for t in banks[0].values()) / 1e6
    kw = dict(temperature=0.8, top_k=20, prefill_chunk=LORA_CHUNK)
    base_eng = make_engine(cfg, model, **kw)
    base, base_stats = drain(base_eng, prompts, seed=seed)
    base_eng.close()
    by_regime = {"split": 0, "chunk": 0}

    def counted_drain(eng, prompts, what, **drain_kw):
        DA.reset_launch_counts()
        got, stats = drain(eng, prompts, seed=seed, adapters=ids,
                           **drain_kw)
        for r, n in check_k6_launches(f"LoRA engine, {what}", stats,
                                      cfg.num_layers).items():
            by_regime[r] += n
        check_captures(eng.fns, 1)
        return got, stats

    eng = make_engine(lcfg, model, adapters=banks[0], **kw)
    runs = []
    for n, bank in enumerate(banks):
        if n:  # in place: the graphs read the new weights, no recapture
            eng.load_adapter_bank(bank)
        got, stats = counted_drain(eng, prompts, f"bank {n}", rid0=100 * n)
        oracles = {}
        for i, a in enumerate(ids):
            if a == 0:
                if got[i] != base[i]:
                    fail(f"LoRA engine, bank {n}: request {i} on adapter 0 "
                         f"differs from the base engine")
                continue
            if a not in oracles:
                oracles[a] = make_generate_fn(
                    lcfg, max_new_tokens=64, temperature=0.8, top_k=20,
                    adapters=bank, adapter_id=a)
            one = oracles[a](model, prompts[i][None].astype(np.int64),
                             np.array([seed, i], np.uint32))
            if got[i] != one[0, len(prompts[i]):].tolist():
                fail(f"LoRA engine, bank {n}: request {i} on adapter {a} "
                     f"differs from the one-shot with adapter_id={a}")
        moved = sum(got[i] != base[i] for i, a in enumerate(ids) if a)
        if not moved:
            fail(f"LoRA engine, bank {n}: no adapter moved a stream")
        runs.append({"bank": n, **stats, "adapter_streams_moved": moved})
    captures = eng.fns.captures
    eng.close()

    long_prompts = [rs.randint(0, 50257, rs.randint(32, 701))
                    .astype(np.int32) for _ in range(12)]
    eng = make_engine(lcfg, model, adapters=banks[1], temperature=0.8,
                      top_k=20)
    got, stats = counted_drain(eng, long_prompts, "phase 4's prompts")
    eng.close()
    lview = model.with_config(lcfg)
    lview.set_adapter_bank(banks[1])
    gap = max(teacher_forced_gap(lview, long_prompts[i], got[i], 20,
                                 adapter=a) for i, a in enumerate(ids))
    if gap > LOGIT_MARGIN:
        fail(f"LoRA engine at phase 4's prompts: an emitted token sits "
             f"{gap} below its bar (margin {LOGIT_MARGIN})")
    runs.append({"bank": 1, "prompts": "32-700 tokens, 128-row chunks",
                 **stats, "max_logit_gap": gap})
    print(f"multi-LoRA engine on {kind}: " + json.dumps(
        {"rank": LORA_RANK, "adapters": LORA_ADAPTERS, "bank_mb": bank_mb,
         "base_decode_step_ms": base_stats["decode_step_ms"],
         "base_tokens_per_s": base_stats["tokens_per_s"], "runs": runs,
         "captures": captures}), flush=True)
    return by_regime


# ---- phases 24-26: the captured k-step step, quantised serving and training


class _CallTimer:
    """A step callable with CUDA events around each call, and the host
    clock around its enqueue."""

    def __init__(self, step):
        self.step, self.events, self.host_s = step, [], []

    def __call__(self, state, batch):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = self.step(state, batch)
        end.record()
        self.host_s.append(time.perf_counter() - t0)
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]


def _loop_run(step, state, data, *, steps, k, tail=None):
    """``steps`` optimizer steps through ``TrainLoop`` at ``k`` steps a
    call. Returns (losses, ms per call, the loop)."""
    timer, losses = _CallTimer(step), _Losses()
    gc.collect()
    torch.cuda.synchronize()
    loop = TrainLoop(timer, state, data, steps_per_call=k,
                     tail_step_fn=tail,
                     hooks=[StopAtStepHook(steps), losses])
    loop.run()
    torch.cuda.synchronize()
    loop.host_s = timer.host_s
    return torch.stack(losses.losses), timer.ms(), loop


def _replay_launches(step, state, batch) -> dict:
    """K1-K3 counted over one more call of a captured step (a replay)."""
    FA.reset_launch_counts()
    step(state, batch)
    torch.cuda.synchronize()
    return {n: FA.LAUNCHES[n] for n in K1_K3}


def _same_params(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


def _timing(ms_calls: list, k: int, tokens_a_step: int, loop) -> dict:
    """Step ms and host enqueue ms a step, medians over the calls after
    the first (which captures)."""
    steady = float(np.median([m / k for m in ms_calls[1:]]))
    return {"call_ms_each": ms_calls, "step_ms_median": steady,
            "tokens_per_s": tokens_a_step / (steady / 1e3),
            "host_enqueue_ms_a_step": 1e3 * float(np.median(
                loop.host_s[1:])) / k,
            "dispatch": loop.dispatch_stats.as_dict()}


def check_captured_training(cfg, rng, seed, kind, eager_step_ms) -> dict:
    """Phase 24. Returns the K1-K3 launches of the captured runs."""
    t0 = time.perf_counter()
    B, S, k, steps = TRAIN_B, TRAIN_S, CAP_K, CAP_STEPS
    dev = resolve_device(None)
    host = [{"tokens": rng.randint(0, 50257, (B, S)).astype(np.int64)}
            for _ in range(steps)]

    def lm():
        model = Transformer(cfg).init_weights(seed).to(dev)
        state = TrainState(model, torch.optim.Adam(
            model.parameters(), lr=1e-3, capturable=dev.type == "cuda"))
        return model, state, make_lm_loss_fn(model)

    dp = DataParallel()
    launches = dict.fromkeys(K1_K3, 0)
    model_c, state_c, loss_fn = lm()
    step_c = dp.make_train_step(loss_fn, steps_per_call=k,
                                stacked_batch=True, per_step_metrics=True)
    tail = dp.make_train_step(loss_fn)
    feed = dp.prefetch(iter(host), steps_per_call=k, drop_remainder=False)
    FA.reset_launch_counts()
    cap_losses, cap_ms, cap_loop = _loop_run(step_c, state_c, feed,
                                             steps=steps, k=k, tail=tail)
    for n in K1_K3:
        launches[n] += FA.LAUNCHES[n]
    run_launches = {n: FA.LAUNCHES[n] for n in K1_K3}
    prefetch_stats = feed.stats.as_dict()

    model_e, state_e, loss_fn_e = lm()
    step_e = dp.make_train_step(loss_fn_e, steps_per_call=k,
                                stacked_batch=True, per_step_metrics=True)
    eag_losses, eag_ms, eag_loop = _loop_run(
        step_e.eager, state_e, dp.prefetch(iter(host), steps_per_call=k),
        steps=steps, k=k)
    same_losses = torch.equal(cap_losses, eag_losses)
    same_params = _same_params(model_c, model_e)
    distinct = len(set(cap_losses.tolist()))
    captures = step_c.captures
    del model_e, state_e, step_e
    packed = dp.shard_packed_batch(pack_batches(host[:k]))
    replay = _replay_launches(step_c, state_c, packed)
    for n in K1_K3:
        launches[n] += replay[n]
    del model_c, state_c, step_c, tail, packed
    torch.cuda.empty_cache()

    # steps_per_call=1, captured: phase 7's step as one graph a step
    model_1, state_1, loss_fn_1 = lm()
    step_1 = dp.make_train_step(loss_fn_1, steps_per_call=1)
    FA.reset_launch_counts()
    one_losses, one_ms, one_loop = _loop_run(
        step_1, state_1, dp.prefetch(iter(host)), steps=steps, k=1)
    for n in K1_K3:
        launches[n] += FA.LAUNCHES[n]
    one_launches = {n: FA.LAUNCHES[n] for n in K1_K3}
    one_same = torch.equal(one_losses, cap_losses)
    one_captures = step_1.captures
    del model_1, state_1, step_1
    torch.cuda.empty_cache()

    out = {"model": "gpt2_124m", "B": B, "S": S, "steps_per_call": k,
           "steps": steps, "loss_curve": cap_losses.tolist(),
           "captured_equals_eager": same_losses,
           "params_equal_after": same_params,
           "distinct_losses": distinct, "captures": captures,
           "k1_k3_a_replay": replay, "k1_k3_over_the_run": run_launches,
           "captured": _timing(cap_ms, k, B * S, cap_loop),
           "eager_k4": _timing(eag_ms, k, B * S, eag_loop),
           "prefetch": prefetch_stats,
           "steps_per_call_1_captured": {
               **_timing(one_ms, 1, B * S, one_loop),
               "losses_equal_k4": one_same, "captures": one_captures,
               "k1_k3_over_the_run": one_launches},
           "phase7_eager_step_ms": eager_step_ms}
    print(f"captured training on {kind}: " + json.dumps(out), flush=True)
    want = dict.fromkeys(K1_K3, k * cfg.num_layers)
    if not (same_losses and same_params):
        fail(f"captured training: captured and eager differ (losses "
             f"{same_losses}, parameters {same_params})")
    if distinct != steps:
        fail(f"captured training: {distinct} distinct losses in {steps} "
             "steps")
    if out["captures"] != 1 or one_captures != 1:
        fail(f"captured training: {out['captures']} / {one_captures} "
             "captures")
    if replay != want or run_launches != {n: steps * cfg.num_layers
                                          for n in K1_K3}:
        fail(f"captured training: K1-K3 {replay} a replay (expected "
             f"{want}), {run_launches} over the run")
    if one_launches != {n: steps * cfg.num_layers for n in K1_K3}:
        fail(f"captured training k=1: K1-K3 {one_launches}")
    if not one_same:
        fail("captured training: steps_per_call=1 losses differ from the "
             "k=4 runs'")
    if abs(cap_losses[0].item() - LN_VOCAB) > LOSS0_MARGIN:
        fail(f"captured training: first loss {cap_losses[0].item()}")
    launches_pp = check_captured_pipeline(cfg, seed, kind)
    for n in K1_K3:
        launches[n] += launches_pp[n]
    print(f"captured training phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def check_captured_pipeline(cfg, seed, kind) -> dict:
    """Phase 24's ``PipelinedLM`` part. Returns its K1-K3 launches."""
    dev = resolve_device(None)
    k, calls = CAP_K, CAP_STEPS // CAP_K
    rng = np.random.RandomState(seed + 24)
    host = [{"tokens": rng.randint(0, 50257, (k, PP1_M * PP1_MB, PP_S))
             .astype(np.int64)} for _ in range(calls)]
    runs, launches = {}, dict.fromkeys(K1_K3, 0)
    for mode in ("captured", "eager"):
        pp = PipelinedLM(build_mesh(MeshSpec()), cfg, PP1_M,
                         schedule="auto", device=dev)
        module = pp.init_params(seed)
        opt = pp.init_opt_state(functools.partial(
            torch.optim.Adam, lr=1e-3, capturable=dev.type == "cuda"),
            module)
        step = pp.make_train_step(opt, steps_per_call=k, stacked_batch=True)
        call = step if mode == "captured" else step.eager
        timer = _CallTimer(call)
        FA.reset_launch_counts()
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in host:
            module, m = timer(module, to_device(b, dev))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {n: FA.LAUNCHES[n] for n in K1_K3}
        runs[mode] = {"losses": torch.stack(losses), "ms": timer.ms(),
                      "wall_s": wall, "launches": counted,
                      "module": module, "step": step}
    cap, eag = runs["captured"], runs["eager"]
    same_losses = torch.equal(cap["losses"], eag["losses"])
    same_params = _same_params(cap["module"], eag["module"])
    cap["captures"] = cap["step"].captures
    replay = _replay_launches(cap["step"], cap["module"],
                              to_device(host[0], dev))
    for n in K1_K3:
        launches[n] += cap["launches"][n] + replay[n]
    tokens_a_step = PP1_M * PP1_MB * PP_S
    steady = {m: float(np.median([x / k for x in r["ms"][1:]]))
              for m, r in runs.items()}
    out = {"model": "gpt2_124m", "pipe": 1, "schedule": "gpipe",
           "M": PP1_M, "microbatch": PP1_MB, "S": PP_S,
           "steps_per_call": k, "steps": k * calls,
           "last_step_losses": cap["losses"].tolist(),
           "captured_equals_eager": same_losses,
           "params_equal_after": same_params,
           "captures": cap["captures"], "k1_k3_a_replay": replay,
           "captured_call_ms_each": cap["ms"],
           "eager_call_ms_each": eag["ms"],
           "captured_step_ms_median": steady["captured"],
           "eager_step_ms_median": steady["eager"],
           "captured_tokens_per_s": tokens_a_step
           / (steady["captured"] / 1e3),
           "eager_tokens_per_s": tokens_a_step / (steady["eager"] / 1e3)}
    print(f"captured pipeline (1 process) on {kind}: " + json.dumps(out),
          flush=True)
    want = {n: k * PP1_M * cfg.num_layers for n in K1_K3}
    if not (same_losses and same_params):
        fail(f"captured pipeline: captured and eager differ (losses "
             f"{same_losses}, parameters {same_params})")
    if cap["captures"] != 1 or replay != want:
        fail(f"captured pipeline: {cap['captures']} captures, K1-K3 "
             f"{replay} a replay, expected {want}")
    del runs, cap, eag
    torch.cuda.empty_cache()
    return launches


def decode_replay_ms(eng) -> float:
    """Device ms of one replay of the engine's decode graph (50 in a
    row, CUDA events)."""
    graph = eng.fns.decode.step.graph
    return time_ms(lambda i: graph.replay(), 50)


def _teacher_logits(model, seq):
    with torch.inference_mode():
        return model(torch.as_tensor(seq, device=model.device)[None])[0]


def check_quantised_serving(cfg, model, seed, kind) -> dict:
    """Phase 25. Returns K5's and K6's launches by regime."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 25)
    prompts = [rng.randint(0, 50257, rng.randint(*Q_PROMPTS))
               .astype(np.int32) for _ in range(12)]
    counts = {"decode_attention": {"split": 0, "chunk": 0},
              "paged_decode_attention": {"split": 0, "chunk": 0}}
    rows = {}
    for wd in (None, "int8", "int4", "fp8"):
        qmodel = model if wd is None else model.quantize(wd)
        qcfg = qmodel.cfg
        if wd == "fp8":
            precision.require_fp8()
        eng = make_engine(qcfg, qmodel, temperature=0.0, top_k=None,
                          prefill_chunk=Q_CHUNK)
        DA.reset_launch_counts()
        got, stats = drain(eng, prompts, seed=seed, max_new=Q_NEW)
        counted = check_k6_launches(f"quantised engine {wd}", stats,
                                    cfg.num_layers)
        check_captures(eng.fns, 1)
        stats["decode_replay_device_ms"] = decode_replay_ms(eng)
        eng.close()
        generate = make_generate_fn(qcfg, max_new_tokens=Q_NEW,
                                    temperature=0.0)
        differ = []
        k5 = {"split": 0, "chunk": 0}
        for i, p in enumerate(prompts):
            out, _, c = timed_generate(generate, qmodel, p[None],
                                       np.array([seed, i], np.uint32))
            for r in k5:
                k5[r] += c[r]
            if out[0, len(p):].tolist() != got[i]:
                differ.append(i)
        gap = max(teacher_forced_gap(qmodel, prompts[r], got[r])
                  for r in got)
        drift = 0.0
        if wd is not None:
            for r in got:
                seq = np.concatenate([prompts[r], got[r]])
                drift = max(drift, float((_teacher_logits(qmodel, seq)
                                          - _teacher_logits(model, seq))
                                         .abs().max()))
        if wd is not None:
            for r in ("split", "chunk"):
                counts["paged_decode_attention"][r] += counted[r]
                counts["decode_attention"][r] += k5[r]
        rows[wd or "bf16"] = {
            "decode_step_ms": stats["decode_step_ms"],
            "decode_replay_device_ms": stats["decode_replay_device_ms"],
            "prefill_chunk_ms": stats["prefill_chunk_ms"],
            "tokens_per_s": stats["tokens_per_s"],
            "engine_equals_one_shot": not differ,
            "max_logit_gap_teacher_forced": gap,
            "max_abs_logit_gap_to_bf16": drift}
        if differ:
            fail(f"quantised engine {wd}: requests {differ} differ from "
                 "the one-shot generator")
        if gap > LOGIT_MARGIN:
            fail(f"quantised engine {wd}: an emitted token sits {gap} "
                 f"below its bar (margin {LOGIT_MARGIN})")
        if wd is not None:
            del qmodel
        torch.cuda.empty_cache()
    print(f"quantised serving on {kind} (8 slots, {Q_CHUNK}-token chunks, "
          f"12 greedy requests of {Q_PROMPTS[0]}-{Q_PROMPTS[1] - 1} "
          f"tokens, {Q_NEW} new): " + json.dumps(rows)
          + f" | phase_s {time.perf_counter() - t0:.1f}", flush=True)
    return counts


def check_quantised_training(cfg, seed, kind) -> dict:
    """Phase 26. Returns its K1-K3 launches."""
    t0 = time.perf_counter()
    B, S = TRAIN_B, TRAIN_S
    dev = resolve_device(None)
    tokens = np.random.RandomState(seed + 26).randint(
        0, 50257, (B, S)).astype(np.int64)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    base = Transformer(cfg).init_weights(seed).to(dev)
    with torch.no_grad():
        loss_bf16 = make_lm_loss_fn(base)(base, batch)[0].item()
    launches = dict.fromkeys(K1_K3, 0)
    rows = {"bf16_first_loss": loss_bf16}
    for name in ("int8", "fp8"):
        if name == "fp8":
            precision.require_fp8()
        qcfg = precision.resolve(name).apply_to_transformer(cfg)
        model = Transformer(qcfg).init_weights(seed).to(dev)
        state = TrainState(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3))
        FA.reset_launch_counts()
        curve, step_ms, peak, _ = timed_run(
            DataParallel().make_train_step(make_lm_loss_fn(model)), state,
            iter(lambda: batch, None), Q_STEPS)
        counted = {n: FA.LAUNCHES[n] for n in K1_K3}
        for n in K1_K3:
            launches[n] += counted[n]
        rows[name] = {"dtype": "f32 compute, f32 params", "loss_curve": curve,
                      "first_loss_gap_to_bf16": abs(curve[0] - loss_bf16),
                      "step_ms_each": step_ms,
                      "step_ms_median_after_2": float(
                          np.median(step_ms[2:])),
                      "tokens_per_s": B * S / (
                          float(np.median(step_ms[2:])) / 1e3),
                      "max_memory_allocated_bytes": peak,
                      "launches": counted}
        del model, state
        torch.cuda.empty_cache()
        if counted != {n: Q_STEPS * cfg.num_layers for n in K1_K3}:
            fail(f"{name} training: K1-K3 {counted}")
        if abs(curve[0] - LN_VOCAB) > LOSS0_MARGIN:
            fail(f"{name} training: first loss {curve[0]}")
        if abs(curve[0] - loss_bf16) > QUANT_LOSS0_GAP:
            fail(f"{name} training: first loss {curve[0]} is "
                 f"{abs(curve[0] - loss_bf16)} from the bf16 step's "
                 f"{loss_bf16} (limit {QUANT_LOSS0_GAP})")
        check_falls(f"{name} training", curve, 3)
    del base
    torch.cuda.empty_cache()
    print(f"quantised training on {kind} (B={B}, S={S}, {Q_STEPS} Adam "
          "steps a preset): " + json.dumps(rows)
          + f" | phase_s {time.perf_counter() - t0:.1f}", flush=True)
    return launches


# ---- phases 27-29: mixture of experts -------------------------------------


def moe_teacher_forced(model, prompt, tokens, top_k=None) -> dict:
    """:func:`teacher_forced_gap` for an MoE model, token by token, with
    the router's margin (the gap between its two best logits, the least
    over the layers) at each token's input position, from the same
    training-view forward. Returns the largest gap, and the gaps and
    margins of the tokens past ``LOGIT_MARGIN``."""
    inputs = []
    hooks = [blk.mlp.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0])) for blk in model.blocks]
    seq = torch.as_tensor(np.concatenate([prompt, tokens]),
                          device=model.device)[None]
    try:
        with torch.inference_mode():
            logits = model(seq)[0]
            margins = []
            for blk, x in zip(model.blocks, inputs):
                lg = router_logits(x.reshape(-1, x.shape[-1]),
                                   blk.mlp.router.weight)
                top2 = lg.topk(2, dim=-1).values
                margins.append(top2[:, 0] - top2[:, 1])
            margin = torch.stack(margins).amin(dim=0)
    finally:
        for h in hooks:
            h.remove()
    P, n = len(prompt), len(tokens)
    rows = logits[P - 1:P - 1 + n]
    got = rows[torch.arange(n), torch.as_tensor(tokens, device=rows.device)]
    bar = (rows.max(dim=-1).values if top_k is None
           else torch.topk(rows, top_k, dim=-1).values[:, -1])
    gaps = (bar - got).cpu()
    # token j was sampled from the forward at position P - 1 + j: a near
    # tie at any position up to it may have moved its hidden state
    at = torch.cummax(-margin[:P - 1 + n].cpu(), dim=0).values.neg()
    over = (gaps > LOGIT_MARGIN).nonzero().flatten().tolist()
    return {"max_gap": float(gaps.max()),
            "over": [[float(gaps[j]), float(margin[P - 1 + j]),
                      float(at[P - 1 + j])] for j in over]}


def _moe_serve(cfg, model, prompts, seed, *, temperature, top_k,
               label) -> dict:
    """One MoE engine drain (captured) and the solo one-shot generator
    of each request: bitwise the same streams, the census balanced, one
    capture a step, K6 launches of the drain and K5 of each oracle run
    exact. Returns the run's numbers and launches."""
    L = cfg.num_layers
    eng = make_engine(cfg, model, temperature=temperature, top_k=top_k,
                      prefill_chunk=Q_CHUNK)
    DA.reset_launch_counts()
    got, stats = drain(eng, prompts, seed=seed, max_new=MOE_NEW)
    k6 = check_k6_launches(label, stats, L)
    check_captures(eng.fns, 1)
    stats["decode_replay_device_ms"] = decode_replay_ms(eng)
    if label == "moe greedy":
        stats["decode_replay_profile"] = profile_replay(
            eng.fns.decode.step.graph)
    health = eng.health()
    moe = health["moe"]
    eng.close()
    routed = (sum(len(p) for p in prompts)
              + len(prompts) * (MOE_NEW - 1) + moe["stall_slot_ticks"])
    balance = sum(moe["expert_load"]) + sum(moe["expert_overflow"])
    if balance != L * routed:
        fail(f"{label}: census {balance} (load + overflow) != {L} layers "
             f"x {routed} routed tokens")
    generate = make_generate_fn(cfg, max_new_tokens=MOE_NEW,
                                temperature=temperature, top_k=top_k)
    k5 = {"split": 0, "chunk": 0}
    differ = []
    for i, p in enumerate(prompts):
        out, _, c = timed_generate(generate, model, p[None],
                                   np.array([seed, i], np.uint32))
        if c != {"chunk": L, "split": (MOE_NEW - 1) * L}:
            fail(f"{label}: the solo oracle launched K5 {c}")
        for r in k5:
            k5[r] += c[r]
        if out[0, len(p):].tolist() != got[i]:
            differ.append(i)
    tf = [moe_teacher_forced(model, prompts[r], got[r], top_k) for r in got]
    over = [o for t in tf for o in t["over"]]
    return {"stats": stats, "moe": moe, "health": health,
            "engine_equals_solo_one_shot":
            not differ, "differ": differ,
            "max_logit_gap_teacher_forced": max(t["max_gap"] for t in tf),
            "tokens_past_margin": len(over),
            "past_margin_gap_margin_least_margin_before": over,
            "k5": k5, "k6": k6}


def check_moe_serving(dense_cfg, dense_model, seed, kind,
                      keep: dict | None = None) -> dict:
    """Phase 27. Returns K5's and K6's launches by regime; leaves the
    greedy engine's health (its census) in ``keep`` for phase 36."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 27)
    prompts = [rng.randint(0, 50257, rng.randint(*Q_PROMPTS))
               .astype(np.int32) for _ in range(12)]
    cfg = gpt2_124m(dtype=torch.bfloat16, moe_experts=MOE_E,
                    moe_capacity=MOE_CAP)
    model = Transformer(cfg).init_weights(seed).to("cuda")
    runs = {}
    for name, c, m, temperature, top_k in (
            ("greedy", cfg, model, 0.0, None),
            ("sampled", cfg, model, 0.8, 20),
            ("capacity1_sampled", dataclasses.replace(cfg, moe_capacity=1),
             model, 0.8, 20),
            ("int8_banks_greedy", None, None, 0.0, None)):
        if m is None:
            m = model.quantize("int8")
            c = m.cfg
        runs[name] = _moe_serve(c, m, prompts, seed,
                                temperature=temperature, top_k=top_k,
                                label=f"moe {name.replace('_', ' ')}")
        if m is not model:
            del m
            torch.cuda.empty_cache()
    eng = make_engine(dense_cfg, dense_model, temperature=0.0, top_k=None,
                      prefill_chunk=Q_CHUNK)
    _, dense = drain(eng, prompts, seed=seed, max_new=MOE_NEW)
    dense["decode_replay_device_ms"] = decode_replay_ms(eng)
    eng.close()
    del model
    torch.cuda.empty_cache()
    counts = {"decode_attention": {"split": 0, "chunk": 0},
              "paged_decode_attention": {"split": 0, "chunk": 0}}
    healths = {name: r.pop("health") for name, r in runs.items()}
    if keep is not None:
        keep["moe_health"] = healths["greedy"]
    for r in runs.values():
        for regime in ("split", "chunk"):
            counts["decode_attention"][regime] += r["k5"][regime]
            counts["paged_decode_attention"][regime] += r["k6"][regime]
    print(f"moe serving on {kind} (gpt2_124m, {MOE_E} experts top-1, "
          f"capacity {MOE_CAP}; 8 slots, {Q_CHUNK}-token chunks, 12 "
          f"requests of {Q_PROMPTS[0]}-{Q_PROMPTS[1] - 1} tokens, "
          f"{MOE_NEW} new): " + json.dumps(
              {"runs": runs, "dense_bf16_greedy": dense})
          + f" | phase_s {time.perf_counter() - t0:.1f}", flush=True)
    for name, r in runs.items():
        if r["differ"]:
            fail(f"moe engine {name}: requests {r['differ']} differ from "
                 "the solo one-shot generator")
        over = r["past_margin_gap_margin_least_margin_before"]
        if (r["tokens_past_margin"] > MOE_PAST_MARGIN_SHARE * 12 * MOE_NEW
                or any(least >= ROUTER_TIE for _, _, least in over)):
            fail(f"moe engine {name}: {r['tokens_past_margin']} tokens past "
                 f"the teacher-forced margin, (gap, router margin, least "
                 f"margin before): {over}")
    if runs["capacity1_sampled"]["moe"]["stall_slot_ticks"] < 1:
        fail("moe engine at capacity 1: no slot stalled")
    return counts


def _switch_cfg(layers: int, attn_impl: str = "flash"):
    return dataclasses.replace(
        gpt2_124m(dtype=torch.bfloat16, attn_impl=attn_impl),
        num_layers=layers, max_len=MOE_S)


def _switch_tokens(seed: int) -> np.ndarray:
    return np.random.RandomState(seed + 28).randint(
        0, 50257, (MOE_B, MOE_S)).astype(np.int64)


def _timed_steps(step, module, tokens, n: int):
    """``n`` train steps, CUDA events around each call: (losses, ms
    each, the last step's metrics)."""
    curve, ms = [], []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, mets = step(module, tokens)
        end.record()
        curve.append(mets["loss"].item())
        ms.append(start.elapsed_time(end))
    return curve, ms, mets


def check_switch_training(seed, kind) -> dict:
    """Phase 28. Returns its K1-K3 launches."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    cfg = _switch_cfg(12)
    mesh = build_mesh(MeshSpec(data=1, expert=1))
    kw = dict(top_k=1, capacity_factor=2.0, router="switch", fused_ce=True)
    lm = SwitchLM(mesh, cfg, MOE_E, **kw)
    full = lm.init_state_dict(seed)
    tokens = torch.as_tensor(_switch_tokens(seed), device=dev)
    module = lm.shard_params(full)
    FA.reset_launch_counts()
    loss0, mets0, grads0 = lm.loss_and_grads(module, tokens)
    first = {n: FA.LAUNCHES[n] for n in K1_K3}
    # the same step through the one-hot plain dispatch, with the kernels'
    # attention and then with the dense one
    plain = {}
    for attn in ("flash", "dense"):
        other = SwitchLM(mesh, _switch_cfg(12, attn), MOE_E,
                         dispatch="onehot", **kw)
        m = other.shard_params(full)
        loss, mets, grads = other.loss_and_grads(m, tokens)
        gaps = _grad_gaps(grads0, grads)
        worst = max(gaps, key=gaps.get)
        flat = (torch.cat([g.float().flatten() for g in grads0.values()]),
                torch.cat([g.float().flatten() for g in grads.values()]))
        plain[attn] = {"loss_gap": abs(loss0.item() - loss.item()),
                       "worst_grad": worst, "worst_grad_rel_gap": gaps[worst],
                       "all_grads_rel_gap": _rel_gap(*flat),
                       "expert_load_change": (mets["expert_load"]
                                              - mets0["expert_load"])
                       .tolist()}
        del m, grads, flat
        torch.cuda.empty_cache()
    del full, grads0
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    curve, ms, _ = _timed_steps(lm.make_train_step(opt), module, tokens,
                                MOE_STEPS)
    counted = {n: FA.LAUNCHES[n] for n in K1_K3}
    step_ms = float(np.median(ms[2:]))
    T = MOE_B * MOE_S
    row = {"loss_curve": curve, "first_lm_loss": mets0["lm_loss"].item(),
           "first_aux": (mets0["load_balance"].item(),
                         mets0["z_loss"].item()),
           "against_onehot_dispatch": plain,
           "step_ms_each": ms, "step_ms_median_3_10": step_ms,
           "tokens_per_s": T / (step_ms / 1e3),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "step1_expert_load": mets0["expert_load"].tolist(),
           "step1_dropped_share": mets0["dropped"].item() / T / 12,
           "launches_first_step": first, "launches_10_steps": counted}
    del module, opt
    torch.cuda.empty_cache()
    print(f"switch lm training on {kind} (12 layers, {MOE_E} experts "
          f"top-1, capacity factor 2.0, B={MOE_B}, S={MOE_S}, flash, fused "
          "CE, Adam): " + json.dumps(row)
          + f" | phase_s {time.perf_counter() - t0:.1f}", flush=True)
    L = cfg.num_layers
    if first != dict.fromkeys(K1_K3, L) or counted != dict.fromkeys(
            K1_K3, MOE_STEPS * L):
        fail(f"switch lm: K1-K3 {first} in one step, {counted} in "
             f"{MOE_STEPS}")
    if abs(row["first_lm_loss"] - LN_VOCAB) > LOSS0_MARGIN:
        fail(f"switch lm: first LM loss {row['first_lm_loss']}")
    # the loss against both plain steps; the gradients against the plain
    # dispatch's on the same attention. Dense attention rounds its scores
    # to bf16, which moves some tokens to another expert (the load
    # changes), and a moved token's gradient is another expert's: those
    # gradient gaps are reported, not held to GRAD_REL_GAP
    same = plain["flash"]
    if (same["worst_grad_rel_gap"] > GRAD_REL_GAP
            or max(p["loss_gap"] for p in plain.values()) > 1e-2):
        fail(f"switch lm: against the one-hot plain dispatch {plain}")
    check_falls("switch lm", curve, 3)
    return {n: first[n] + counted[n] for n in K1_K3}


def _ep_lm(mesh, router: str) -> SwitchLM:
    return SwitchLM(mesh, _switch_cfg(EP_LAYERS), MOE_E, top_k=1,
                    capacity_factor=2.0, router=router, fused_ce=True)


def ep_rank(seed: int, ref_path: str) -> dict:
    """One rank of phase 29 (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=2, expert=2))
    lm = _ep_lm(mesh, "dropless")
    full = lm.init_state_dict(seed)
    share = lm.token_shard(_switch_tokens(seed))
    module = lm.shard_params(full)
    stacks = ("moe.w_in", "moe.w_out")
    FA.reset_launch_counts()
    with cc.trace_comm() as rec:
        loss0, _, grads = lm.loss_and_grads(module, share)
    ref = torch.load(ref_path)
    sl = lm.expert_slice()
    gaps = {n: _rel_gap(g, (ref["grads"][n][:, sl] if n in stacks
                            else ref["grads"][n]).to(dev))
            for n, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    del grads, ref["grads"]
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    dist.barrier()
    curve, ms, _ = _timed_steps(lm.make_train_step(opt), module, share,
                                EP_STEPS)
    sw = _ep_lm(mesh, "switch")
    with cc.trace_comm() as rec_sw:
        sw.loss_and_grads(sw.shard_params(full), share)
    return {"rank": dist.get_rank(), "device": str(dev),
            "backend": dist.get_backend(),
            "coords": [mesh.axis(a).index for a in ("data", "expert")],
            "loss_gap": abs(loss0.item() - ref["loss"]),
            "worst_grad": worst, "worst_grad_rel_gap": gaps[worst],
            "loss_curve": curve, "step_ms": ms,
            "launches": {n: FA.LAUNCHES[n] for n in K1_K3},
            "stack_bytes": sum(module.get_parameter(n).numel()
                               * module.get_parameter(n).element_size()
                               for n in stacks),
            "a2a": [rec.calls["all_to_all[expert]"],
                    rec.wire["all_to_all[expert]"]],
            "a2a_switch": [rec_sw.calls["all_to_all[expert]"],
                           rec_sw.wire["all_to_all[expert]"]],
            "digests": {n: _digest(p) for n, p in
                        module.named_parameters()}}


def check_expert_parallel(seed: int, kind: str) -> dict:
    """Phase 29. Returns the ranks' K1-K3 launches, summed."""
    t0 = time.perf_counter()
    dev = resolve_device(None)
    lm = _ep_lm(build_mesh(MeshSpec(data=1, expert=1)), "dropless")
    module = lm.shard_params(lm.init_state_dict(seed))
    loss, _, grads = lm.loss_and_grads(
        module, torch.as_tensor(_switch_tokens(seed), device=dev))
    with tempfile.TemporaryDirectory(prefix="dtg_ep_ref_") as ref_dir:
        path = f"{ref_dir}/switch.pt"
        torch.save({"loss": loss.item(),
                    "grads": {n: g.cpu() for n, g in grads.items()}}, path)
        del module, grads
        torch.cuda.empty_cache()
        res = [r.result for r in run_multiprocess(
            "chip_smoke:ep_rank", EP_N, [seed, path], timeout=900)]
    cfg = lm.cfg
    L, d, ff = EP_LAYERS, cfg.d_model, cfg.d_ff
    t_local = MOE_B * MOE_S // EP_N
    # each all_to_all: the (E, C, d) bf16 buffer, half of it to the other
    # expert rank; C = T_local dropless, ceil(T_local * 2.0 / E) Switch
    wire = {router: MOE_E * cap * d * 2 * (2 - 1) / 2
            for router, cap in (("dropless", t_local),
                                ("switch", math.ceil(t_local * 2.0
                                                     / MOE_E)))}
    print(f"expert parallelism on {kind} ({_layout(res)}; data 2 x "
          f"expert 2, gloo on one card, not NCCL): " + json.dumps(
              {k: [r[k] for r in res] for k in (
                  "coords", "loss_gap", "worst_grad", "worst_grad_rel_gap",
                  "loss_curve", "step_ms", "launches", "stack_bytes", "a2a",
                  "a2a_switch")}
              | {"a2a_wire_each": wire,
                 "phase_s": time.perf_counter() - t0}), flush=True)
    for r in res:
        if r["worst_grad_rel_gap"] > GRAD_REL_GAP or r["loss_gap"] > 1e-2:
            fail(f"ep rank {r['rank']}: {r['worst_grad']} gap "
                 f"{r['worst_grad_rel_gap']}, loss gap {r['loss_gap']}")
        for key, router in (("a2a", "dropless"), ("a2a_switch", "switch")):
            if r[key] != [4 * L, 4 * L * wire[router]]:
                fail(f"ep rank {r['rank']} {router}: all_to_all[expert] "
                     f"{r[key]}, expected {4 * L} of {wire[router]} bytes")
        if r["stack_bytes"] != 2 * L * (MOE_E // 2) * d * ff * 2:
            fail(f"ep rank {r['rank']}: {r['stack_bytes']} bytes of expert "
                 "stacks, expected half the experts'")
        if r["launches"] != dict.fromkeys(K1_K3, (EP_STEPS + 2) * L):
            fail(f"ep rank {r['rank']}: K1-K3 {r['launches']}")
    by_expert = {}
    for r in res:
        for n, dg in r["digests"].items():
            key = (n, r["coords"][1]) if n.startswith(("moe.w_in",
                                                       "moe.w_out")) else n
            by_expert.setdefault(key, set()).add(dg)
    if any(len(v) != 1 for v in by_expert.values()):
        fail("ep: parameters differ across ranks after the steps: "
             f"{sorted(str(k) for k, v in by_expert.items() if len(v) > 1)}")
    if len({tuple(r["loss_curve"]) for r in res}) != 1:
        fail("ep: the ranks report different losses")
    return {n: sum(r["launches"][n] for r in res) for n in K1_K3}


# ---- phases 30-33: checkpoints, recovery, snapshots, preemption, elastic ----

# phase 30: steps of a supervised run, checkpoint cadence and kept steps;
# the data stall against its deadline; phase 32's preemption step
RESIL_TOTAL, RESIL_EVERY, RESIL_KEEP = 12, 4, 2
# phases 30 and 32 at a cut depth: at 12 layers their checkpoint IO
# (1.96 GB a save) took most of phase 30's 70 s on a slow host (PR 20)
RESIL_LAYERS = 4
STALL_S, DATA_DEADLINE_S = 1.0, 0.5
PREEMPT_AT = 6
# phase 31: requests, their prompt lengths and new tokens; the watchdog
# deadline of a launch (it must cover a first call's capture; the forced
# trip waits it out); the storm's pool (80 blocks for 8 slots: residents
# are preempted) and its pool-pressure fault's blocks
SNAP_REQS, SNAP_PROMPTS, SNAP_NEW = 16, (32, 301), 32
SERVE_DEADLINE_S = 3.0
STORM_BLOCKS, PRESSURE_BLOCKS = 81, 24


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class _Counted:
    """A step that counts the calls reaching it (a chaos-injected failure
    raises before)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, state, batch):
        self.calls += 1
        return self.fn(state, batch)


def _scaled_lm_loss(model):
    """Phase 7's loss times the batch's ``scale`` (1.0): a float leaf, so
    a ``nan_batch`` fault NaNs the loss as it would a float batch."""
    base = make_lm_loss_fn(model)

    def loss_fn(module, batch):
        loss, mets = base(module, batch)
        return loss * batch["scale"].mean(), mets

    return loss_fn


def _resil_batch(seed: int, pos: int, B: int, S: int) -> dict:
    toks = np.random.RandomState(seed * 100003 + pos).randint(0, 50257,
                                                              (B, S))
    return {"tokens": toks.astype(np.int64),
            "scale": np.ones((1,), np.float32)}


_HOST_MODELS: dict = {}


def _resil_state(cfg, seed, dev):
    """A fresh train state: the weights ``init_weights(seed)`` draws (kept
    on the host after the first call: phases 30 and 32 build a dozen
    states), Adam with its counter on the card."""
    key = (repr(cfg), seed)
    if key not in _HOST_MODELS:
        _HOST_MODELS[key] = Transformer(cfg).init_weights(seed)
    model = copy.deepcopy(_HOST_MODELS[key]).to(dev)
    return TrainState(model, torch.optim.Adam(
        model.parameters(), lr=1e-3, capturable=dev.type == "cuda"))


def _state_tensors(state) -> list:
    return ([t for t in state.model.state_dict().values()]
            + [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v)])


def _bitwise(a, b) -> bool:
    ta, tb = _state_tensors(a), _state_tensors(b)
    return (a.step == b.step and len(ta) == len(tb)
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


def _dir_bytes(path) -> int:
    import pathlib

    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*")
               if p.is_file())


def _plain_run(cfg, seed, dev, B, S, positions):
    """The uninterrupted run over the stream ``positions``."""
    state = _resil_state(cfg, seed, dev)
    step = DataParallel(device=dev).make_train_step(
        _scaled_lm_loss(state.model))
    for p in positions:
        state, _ = step(state, to_device(_resil_batch(seed, p, B, S), dev))
    _sync(dev)
    return state


def _supervised_run(cfg, seed, dev, B, S, ckdir, schedule, *, async_save):
    """One supervised run under ``schedule``: (final state, the sentinel,
    calls that reached the step, the recovery trace, wall s)."""
    state = _resil_state(cfg, seed, dev)
    step = _Counted(DataParallel(device=dev).make_train_step(
        _scaled_lm_loss(state.model)))
    rec = obs_events.FlightRecorder()
    sentinel = AnomalySentinelHook(budget=3, skip_offending=True,
                                   recorder=rec)
    ckpt = Checkpointer(ckdir, max_to_keep=RESIL_KEEP, recorder=rec)
    prev = obs_events.install(rec)
    schedule.recorder = rec
    _sync(dev)
    t0 = time.perf_counter()
    try:
        out = run_with_recovery(
            schedule.wrap_step(step), state,
            schedule.inject_data(
                lambda start: (_resil_batch(seed, p, B, S)
                               for p in range(start, 10_000)),
                checkpoint_dir=ckdir),
            ckpt, hooks=[StopAtStepHook(RESIL_TOTAL), sentinel],
            checkpoint_every=RESIL_EVERY, max_restarts=6,
            async_save=async_save, data_deadline_s=DATA_DEADLINE_S,
            device=dev)
        _sync(dev)
    finally:
        obs_events.install(prev)
        ckpt.close()
    wall = time.perf_counter() - t0
    trace = [(e.kind, {k: v for k, v in e.payload.items()
                       if k in ("start", "step", "error", "skipped",
                                "kind", "position", "fresh")})
             for e in rec.events() if e.kind in (
                 "elastic.restore", "elastic.restart", "ckpt.restore",
                 "chaos.fault", "anomaly.trip")]
    return out, sentinel, step.calls, trace, wall


def _resil_schedule(seed):
    """Phase 30's faults, fixed from the seed: a step exception before the
    first checkpoint (a fresh start), a NaN batch after it (the sentinel
    skips it), the step-8 checkpoint corrupted in place (same size), then
    a data stall that the deadline turns into a restart whose ladder skips
    the corrupted step."""
    rng = np.random.RandomState(seed + 30)
    call = int(rng.randint(2, 4))
    nan = int(rng.randint(5, 8))
    corrupt = int(rng.randint(10, 12))
    return [Fault("step_exception", call), Fault("nan_batch", nan),
            Fault("ckpt_corrupt", corrupt),
            Fault("iterator_stall", corrupt + 1, param=STALL_S)], nan


def check_supervised_training(cfg, seed, kind, *, B=TRAIN_B, S=TRAIN_S,
                              dev=None) -> dict:
    """Phase 30. Returns its K1-K3 launches."""
    t_phase = time.perf_counter()
    dev = resolve_device(dev)
    L = cfg.num_layers
    faults, nan_pos = _resil_schedule(seed)
    positions = [p for p in range(64) if p != nan_pos][:RESIL_TOTAL]
    ref = _plain_run(cfg, seed, dev, B, S, positions)
    root = tempfile.mkdtemp(prefix="dtg_phase30_")
    out = {"model": f"gpt2_124m widths, {L} layers",
           "B": B, "S": S, "steps": RESIL_TOTAL,
           "checkpoint_every": RESIL_EVERY, "max_to_keep": RESIL_KEEP,
           "faults": [[f.kind, f.position, f.param] for f in faults]}
    launches = dict.fromkeys(K1_K3, 0)
    try:
        for mode in ("sync", "async"):
            sched = FaultSchedule(faults)
            FA.reset_launch_counts()
            state, sentinel, calls, trace, wall = _supervised_run(
                cfg, seed, dev, B, S, f"{root}/{mode}", sched,
                async_save=mode == "async")
            got = {n: FA.LAUNCHES[n] for n in K1_K3}
            for n in K1_K3:
                launches[n] += got[n]
            same = _bitwise(state, ref)
            out[mode] = {"bitwise_equal_uninterrupted": same,
                         "wall_s": wall, "step_calls": calls,
                         "k1_k3": got, "sentinel_trips": sentinel.trips,
                         "trace": trace}
            if sched.pending:
                fail(f"supervised {mode}: faults never fired: "
                     f"{sched.pending}")
            if not same:
                fail(f"supervised {mode}: the final state differs from the "
                     f"uninterrupted run's")
            if [s for s, _ in sentinel.trips] != [nan_pos]:
                fail(f"supervised {mode}: sentinel trips {sentinel.trips}, "
                     f"expected one at step {nan_pos}")
            if got != dict.fromkeys(K1_K3, calls * L):
                fail(f"supervised {mode}: K1-K3 {got}, expected {calls} "
                     f"steps x {L} layers")
            restarts = sum(k == "elastic.restart" for k, _ in trace)
            if restarts != 3:
                fail(f"supervised {mode}: {restarts} restarts, expected 3")
            if mode == "sync" and not any(
                    k == "ckpt.restore" and p.get("skipped")
                    for k, p in trace):
                fail("supervised sync: the ladder skipped no corrupted "
                     "checkpoint")
            if mode == "sync":
                final_dir = f"{root}/sync"
            del state
        # the checkpoint's own numbers, on the uninterrupted run's state:
        # a sync save (its first: it allocates the pinned buffers), an
        # async save's blocking copy and its commit, a restore
        timing = Checkpointer(f"{root}/timing", max_to_keep=4)
        times = {}
        for name, step_label, asy in (("sync_save_s", 1, False),
                                      ("async_save_blocking_s", 3, True)):
            _sync(dev)
            t0 = time.perf_counter()
            timing.save(step_label, ref, async_=asy)
            times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing.wait()
        times["async_commit_wait_s"] = time.perf_counter() - t0
        nbytes = _dir_bytes(f"{root}/timing/3")
        probe = _resil_state(cfg, seed + 1, dev)
        _sync(dev)
        t0 = time.perf_counter()
        got = timing.restore_latest_valid(probe)
        _sync(dev)
        times["restore_s"] = time.perf_counter() - t0
        if got is None or got[1] != 3 or not _bitwise(probe, ref):
            fail("the timed checkpoint does not restore bitwise on the "
                 "state's device")
        del probe
        timing.close()
        out["checkpoint_bytes"] = nbytes
        out["ms"] = {k: 1e3 * v for k, v in times.items()}
        out["MB_per_s"] = {k.removesuffix("_s"): nbytes / 1e6 / v
                           for k, v in times.items()
                           if k != "async_commit_wait_s"}
        # restore into a live captured step (k = 2) and run 4 more steps:
        # bitwise the uninterrupted captured run
        more = positions[-1] + 1
        packs = [{n: torch.as_tensor(np.stack([
            _resil_batch(seed, more + 2 * c + j, B, S)[n] for j in (0, 1)]),
            device=dev) for n in ("tokens", "scale")} for c in range(3)]
        dp = DataParallel(device=dev)
        k_ref = dp.make_train_step(_scaled_lm_loss(ref.model),
                                   steps_per_call=2, stacked_batch=True,
                                   per_step_metrics=True)
        for p in packs[1:]:
            ref, _ = k_ref(ref, p)
        live = _resil_state(cfg, seed + 2, dev)
        k_live = dp.make_train_step(_scaled_lm_loss(live.model),
                                    steps_per_call=2, stacked_batch=True,
                                    per_step_metrics=True)
        live, _ = k_live(live, packs[0])  # captures over live's tensors
        ptrs = [t.data_ptr() for t in _state_tensors(live)]
        ck = Checkpointer(final_dir, max_to_keep=RESIL_KEEP)
        restored, at = ck.restore_latest_valid(live)
        if at != RESIL_TOTAL or restored is not live or ptrs != [
                t.data_ptr() for t in _state_tensors(live)]:
            fail(f"captured restore: step {at}, in place "
                 f"{restored is live}")
        FA.reset_launch_counts()
        for p in packs[1:]:
            live, _ = k_live(live, p)
        _sync(dev)
        cap = {n: FA.LAUNCHES[n] for n in K1_K3}
        for n in K1_K3:
            launches[n] += cap[n]
        out["captured_restore"] = {
            "captured": k_live.captured, "captures": k_live.captures,
            "bitwise_equal_uninterrupted": _bitwise(live, ref),
            "k1_k3": cap}
        if not _bitwise(live, ref):
            fail("the captured step restored in place does not continue "
                 "bitwise")
        if dev.type == "cuda" and (k_live.captures != 1
                                   or not k_live.captured):
            fail(f"captured restore: {k_live.captures} captures")
        ck.close()
        del live, ref, k_live, k_ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"supervised training on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


class _SigtermAt(BaseHook):
    """Sends this process SIGTERM after step ``at``."""

    def __init__(self, at: int):
        self.at = at

    def after_step(self, step, metrics):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def check_preemption(cfg, seed, kind, *, B=TRAIN_B, S=TRAIN_S,
                     dev=None) -> dict:
    """Phase 32. Returns its K1-K3 launches."""
    t_phase = time.perf_counter()
    dev = resolve_device(dev)
    ref = _plain_run(cfg, seed, dev, B, S, range(RESIL_TOTAL))
    held_out = _resil_batch(seed, 10_000, B, S)
    root = tempfile.mkdtemp(prefix="dtg_phase32_")
    launches = dict.fromkeys(K1_K3, 0)
    original = signal.getsignal(signal.SIGTERM)

    def run(state, ckpt, hooks):
        step = _Counted(DataParallel(device=dev).make_train_step(
            _scaled_lm_loss(state.model)))
        out = run_with_recovery(
            step, state, lambda start: (_resil_batch(seed, p, B, S)
                                        for p in range(start, 10_000)),
            ckpt, hooks=[StopAtStepHook(RESIL_TOTAL), *hooks],
            checkpoint_every=10_000, device=dev)
        _sync(dev)
        return out, step.calls

    def evaluator(calls):
        loss_fn = _scaled_lm_loss(ref.model)

        def eval_step(state, batch):
            calls.append(1)
            with torch.no_grad():
                return {"loss": loss_fn(state.model,
                                        to_device(batch, dev))[0]}

        return Evaluator(eval_step, lambda: [held_out])

    try:
        FA.reset_launch_counts()
        first_evals, second_evals = [], []
        ckpt = Checkpointer(root, max_to_keep=RESIL_KEEP)
        pre = PreemptionHook(ckpt)
        ev1 = EvalHook(evaluator(first_evals))
        t0 = time.perf_counter()
        _, calls1 = run(_resil_state(cfg, seed, dev), ckpt,
                        [_SigtermAt(PREEMPT_AT), pre, ev1])
        t_pre = time.perf_counter() - t0
        ckpt.close()
        stop_reason = ev1._loop.stop_reason
        restored_handler = signal.getsignal(signal.SIGTERM) == original
        ev2 = EvalHook(evaluator(second_evals))
        ckpt = Checkpointer(root, max_to_keep=RESIL_KEEP)
        t0 = time.perf_counter()
        final, calls2 = run(_resil_state(cfg, seed + 1, dev), ckpt, [ev2])
        t_resume = time.perf_counter() - t0
        ckpt.close()
        got = {n: FA.LAUNCHES[n] for n in K1_K3}
        evals = len(second_evals)
        same = _bitwise(final, ref)
        del final
    finally:
        shutil.rmtree(root, ignore_errors=True)
    L = cfg.num_layers
    out = {"preempted_at": pre.preempted_at, "stop_reason": stop_reason,
           "end_eval_skipped": not first_evals,
           "handler_restored": restored_handler,
           "resumed_eval_batches": evals, "first_run_s": t_pre,
           "resumed_run_s": t_resume, "step_calls": [calls1, calls2],
           "bitwise_equal_uninterrupted": same, "k1_k3": got}
    _HOST_MODELS.clear()
    print(f"preemption on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    if pre.preempted_at != PREEMPT_AT + 1 or stop_reason != "preemption":
        fail(f"preemption: saved at {pre.preempted_at}, stop reason "
             f"{stop_reason}")
    if first_evals or evals != 1 or not restored_handler:
        fail(f"preemption: end-pass evaluations {len(first_evals)} / "
             f"{evals}, handler restored {restored_handler}")
    if not same:
        fail("preemption: the resumed run differs from the uninterrupted "
             "one")
    # the eval passes' forwards launch K1 too
    want_fwd = (calls1 + calls2 + evals) * L
    if got != {"flash_fwd": want_fwd, "flash_dq": (calls1 + calls2) * L,
               "flash_dkv": (calls1 + calls2) * L}:
        fail(f"preemption: K1-K3 {got}")
    for n in K1_K3:
        launches[n] += got[n]
    return launches


def _snap_prompts(seed, n, lengths):
    rng = np.random.RandomState(seed + 31)
    return [rng.randint(0, 50257, rng.randint(*lengths)).astype(np.int32)
            for _ in range(n)]


def _snap_engine(cfg, model, *, prefill_chunk, num_blocks=513, **kw):
    """Phase 4's engine geometry (8 slots, block 16, 513 blocks),
    sampled (temperature 0.8, top-k 20), captured steps."""
    return ServeEngine(cfg, model, slots=8, block_size=16,
                       num_blocks=num_blocks, prefill_chunk=prefill_chunk,
                       temperature=0.8, top_k=20, device=model.device, **kw)


def _submit(eng, prompts, seed, max_new):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new,
                           rng=np.array([seed, i], np.uint32)))


def _ticks(eng) -> dict:
    """Drain ``eng`` tick by tick: each kind's tick seconds (host clock
    around inputs, replay and readback)."""
    ticks = {"decode": [], "prefill": []}
    while eng.sched.has_queued or eng.sched.has_resident:
        _, kind = eng.step()
        if kind == "idle":
            fail("engine idle with work queued")
        ticks[kind].append(eng.last_tick_s)
    eng.sched.pool.check_leaks()
    return ticks


def _k6(what, steps, layers) -> dict:
    """K6's launches since the counts were zeroed: ``steps`` x layers,
    both regimes, no K5."""
    return check_k6_launches(what, {"decode_steps": steps,
                                    "prefill_chunks": 0}, layers)


def _n_steps(eng) -> int:
    return eng.steps["decode"] + eng.steps["prefill"]


def _median_ms(xs) -> float:
    return 1e3 * float(np.median(xs))


def _uninterrupted(cfg, model, prompts, seed, max_new, prefill_chunk,
                   **kw):
    eng = _snap_engine(cfg, model, prefill_chunk=prefill_chunk, **kw)
    _submit(eng, prompts, seed, max_new)
    DA.reset_launch_counts()
    ticks = _ticks(eng)
    k6 = _k6("uninterrupted engine", _n_steps(eng), cfg.num_layers)
    check_captures(eng.fns, 1)
    got = eng.completions()
    eng.close()
    return got, ticks, k6


def _restore_cost(eng, back, t0) -> tuple[dict, dict]:
    """Drive a restored engine until every stream that was resident at
    the snapshot (``back``) has emitted a new token. Counts its prefill
    ticks and the decode ticks on which a restored stream was still
    rebuilding its cache: with ``"replay"`` continuations a stream feeds
    each token it had emitted back through one decode step before it
    samples again. Takes the time from ``t0`` (the start of the restore)
    to the last of those first new tokens. Returns (numbers, tick
    seconds by kind)."""
    sched = eng.sched
    base = {rid: len(sched.emitted.get(rid, ())) for rid in back}
    replay_tokens = sum(len(r.replay) for r in sched.queue if r.rid in back)
    waiting = set(back)
    ticks = {"decode": [], "prefill": []}
    rebuild = []
    while waiting:
        rebuilding = any(s is not None and s.rid in waiting
                         and s.phase == "decode" for s in sched.slots)
        _, kind = eng.step()
        if kind == "idle":
            fail("restored engine idle with work queued")
        ticks[kind].append(eng.last_tick_s)
        if kind == "decode" and rebuilding:
            rebuild.append(eng.last_tick_s)
        waiting = {rid for rid in waiting
                   if len(sched.emitted.get(rid, ())) == base[rid]}
    return {"replay_tokens": replay_tokens,
            "prefill_ticks": len(ticks["prefill"]),
            "prefill_ticks_ms": 1e3 * sum(ticks["prefill"]),
            "rebuild_decode_ticks": len(rebuild),
            "rebuild_decode_ms": 1e3 * sum(rebuild),
            "rebuild_decode_median_ms": _median_ms(rebuild) if rebuild
            else None,
            "ms_until_every_restored_stream_emits":
                1e3 * (time.perf_counter() - t0)}, ticks


def _as_prefill_continuations(sched) -> None:
    """Turn a restored scheduler's queued ``"replay"`` continuations into
    the re-prefilling form (prompt and emitted tokens prefilled in
    chunks, the JAX engine's), to time that form on the card. Its
    streams are not held bitwise there: a chunk writes the emitted
    tokens' rows in another summation order than their decode steps."""
    sched.continuations = "prefill"
    sched.queue = [
        dataclasses.replace(r, prompt=np.concatenate([
            np.asarray(r.prompt, np.int32), np.asarray(r.replay, np.int32)]),
            replay=()) if r.replay else r
        for r in sched.queue]


def _kill_restore(cfg, model, prompts, seed, snap, *, max_new,
                  prefill_chunk, kill_at, saves, corrupt_at=None,
                  want=None):
    """Serve, snapshot at the ticks of ``saves`` ({tick: async}), with a
    ``snapshot_corrupt`` fault at ``corrupt_at``, close the engine at tick
    ``kill_at`` (the kill: a pending async snapshot commits at close),
    restore a fresh engine from the newest valid snapshot and drain it.
    K6 is counted over both engines. Given the uninterrupted streams
    ``want``, the same snapshot is then restored once more with its
    continuations re-prefilled (:func:`_as_prefill_continuations`), until
    every restored stream emits, to set the cost of the two forms side
    by side. Returns (streams, numbers, K6 by regime)."""
    L = cfg.num_layers
    chaos = (FaultSchedule([Fault("snapshot_corrupt", corrupt_at)])
             if corrupt_at is not None else None)
    eng = _snap_engine(cfg, model, prefill_chunk=prefill_chunk,
                       snapshot_dir=snap, chaos=chaos)
    _submit(eng, prompts, seed, max_new)
    DA.reset_launch_counts()
    save_ms, residents = {}, {}
    for t in range(kill_at):
        eng.step()
        if t + 1 in saves:
            t0 = time.perf_counter()
            label = eng.save_snapshot(async_=saves[t + 1])
            save_ms["async" if saves[t + 1] else "sync"] = (
                1e3 * (time.perf_counter() - t0))
            residents[label] = {s.rid for s in eng.sched.slots
                                if s is not None}
    steps1 = _n_steps(eng)
    eng.close()
    if chaos is not None and chaos.pending:
        fail(f"snapshot fault never fired: {chaos.pending}")
    rec = obs_events.FlightRecorder()
    eng2 = _snap_engine(cfg, model, prefill_chunk=prefill_chunk,
                        snapshot_dir=snap, recorder=rec)
    t0 = time.perf_counter()
    label = eng2.restore_latest_snapshot()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    at_restore = _n_steps(eng2)
    back = residents.get(label, set())
    replay_cost, ticks = _restore_cost(eng2, back, t0)
    for k, v in _ticks(eng2).items():
        ticks[k] += v
    k6 = _k6("restored engine", steps1 + _n_steps(eng2) - at_restore, L)
    check_captures(eng2.fns, 1)
    reprefill = [e.payload for e in rec.events()
                 if e.kind == "prefill.launch" and e.payload["rid"] in back]
    got = eng2.completions()
    eng2.close()
    stats = {
        "saved_labels": sorted(residents), "restored_label": label,
        "snapshot_bytes": _dir_bytes(f"{snap}/{label}"),
        "save_ms": save_ms, "restore_ms": restore_ms,
        "restored_residents": len(back),
        "reprefill_chunks": len(reprefill),
        "reprefill_ms": 1e3 * sum(p["dur_s"] for p in reprefill),
        "replay": replay_cost,
        "decode_step_ms_after_restore": _median_ms(ticks["decode"])}
    if want is not None:
        eng3 = _snap_engine(cfg, model, prefill_chunk=prefill_chunk,
                            snapshot_dir=snap)
        t0 = time.perf_counter()
        if eng3.restore_latest_snapshot() != label:
            fail(f"engine {snap}: a second restore took another snapshot")
        _as_prefill_continuations(eng3.sched)
        prefill_cost, _ = _restore_cost(eng3, back, t0)
        prefill_cost["first_new_tokens_equal_uninterrupted"] = all(
            eng3.completions()[rid] == want[rid][:len(eng3.completions()[
                rid])] for rid in back)
        eng3.close()
        stats["prefill_continuations"] = prefill_cost
    return got, stats, k6


def _trip_during_sync(dev, diag) -> dict:
    """A watchdog armed around ``torch.cuda.synchronize()`` over ~2 s of
    queued products, deadline 0.3 s: when the trip fires, and when its
    interrupt reaches the main thread."""
    a = torch.randn(16384, 16384, device=dev, dtype=torch.bfloat16)
    b = torch.randn(16384, 16384, device=dev, dtype=torch.bfloat16)
    c = torch.empty_like(a)
    for _ in range(2):
        torch.matmul(a, b, out=c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        torch.matmul(a, b, out=c)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0) / 5
    n = max(1, int(2000 / one_ms))
    wd = Watchdog(name="sync-probe", poll_s=0.01, diag_path=diag)
    arrived = None
    t1 = time.perf_counter()
    for _ in range(n):
        torch.matmul(a, b, out=c)
    queued = time.perf_counter() - t1
    wd.arm("synchronize", 0.3)
    try:
        torch.cuda.synchronize()
        while time.perf_counter() - t1 < 10.0:
            time.sleep(0.005)
    except KeyboardInterrupt:
        arrived = time.perf_counter() - t1
    finally:
        wd.disarm()
        trip = wd.tripped
        wd.close()
    torch.cuda.synchronize()
    del a, b, c
    return {"deadline_s": 0.3, "queued_products": n,
            "one_product_ms": one_ms, "enqueue_s": queued,
            "queued_work_s": n * one_ms / 1e3,
            "trip_fired_after_s": None if trip is None else
            queued + trip.waited_s,
            "interrupt_arrived_after_s": arrived}


def check_engine_snapshots(cfg, model, seed, kind) -> dict:
    """Phase 31. Returns K6's launches by regime."""
    t_phase = time.perf_counter()
    dev = model.device
    L = cfg.num_layers
    prompts = _snap_prompts(seed, SNAP_REQS, SNAP_PROMPTS)
    chunk = 128
    counts = {"split": 0, "chunk": 0}

    def add(k6):
        for r in counts:
            counts[r] += k6[r]

    root = tempfile.mkdtemp(prefix="dtg_phase31_")
    out = {"model": "gpt2_124m" if L == 12 else "small",
           "requests": SNAP_REQS, "prompt_lengths": list(SNAP_PROMPTS),
           "new_tokens": SNAP_NEW}
    try:
        want, ticks, k6 = _uninterrupted(cfg, model, prompts, seed,
                                         SNAP_NEW, chunk)
        add(k6)
        out["uninterrupted_decode_step_ms"] = _median_ms(ticks["decode"])
        runs = {}
        for name, kw in (
                ("kill_restore", dict(kill_at=40, saves={20: False,
                                                         30: True})),
                ("corrupt_newest", dict(kill_at=40, saves={20: False,
                                                           30: True},
                                        corrupt_at=35))):
            got, stats, k6 = _kill_restore(
                cfg, model, prompts, seed, f"{root}/{name}",
                max_new=SNAP_NEW, prefill_chunk=chunk,
                want=want if name == "kill_restore" else None, **kw)
            add(k6)
            stats["bitwise_equal_uninterrupted"] = got == want
            runs[name] = stats
            if got != want:
                fail(f"engine {name}: a restored stream differs from the "
                     "uninterrupted engine's")
        if runs["corrupt_newest"]["restored_label"] != \
                runs["corrupt_newest"]["saved_labels"][0]:
            fail(f"engine corrupt_newest: restored "
                 f"{runs['corrupt_newest']['restored_label']}, not the "
                 "older snapshot")
        out.update(runs)

        # a launch failure and a pool-pressure spike in a pool that
        # preempts residents, no kill
        chaos = FaultSchedule([Fault("serve_step_exception", 12),
                               Fault("pool_pressure", 20,
                                     float(PRESSURE_BLOCKS))])
        eng = _snap_engine(cfg, model, prefill_chunk=chunk, chaos=chaos,
                           retry_base_delay_s=0.001,
                           num_blocks=STORM_BLOCKS)
        _submit(eng, prompts, seed, SNAP_NEW)
        DA.reset_launch_counts()
        eng.run()
        eng.sched.pool.check_leaks()
        add(_k6("engine storm", _n_steps(eng), L))
        storm = {"launch_failures": eng.launch_failures,
                 "preemptions": eng.sched.preemptions,
                 "bitwise_equal_uninterrupted": eng.completions() == want}
        eng.close()
        out["storm"] = storm
        if chaos.pending or not storm["bitwise_equal_uninterrupted"] \
                or storm["launch_failures"] != 1 or not storm["preemptions"]:
            fail(f"engine storm: {storm}, pending {chaos.pending}")

        # the guarded launch: a deadline that does not trip, then one
        # forced trip from a host stall in a decode launch
        eng = _snap_engine(cfg, model, prefill_chunk=chunk,
                           step_deadline_s=SERVE_DEADLINE_S)
        _submit(eng, prompts, seed, SNAP_NEW)
        DA.reset_launch_counts()
        ticks = _ticks(eng)
        add(_k6("engine with a deadline", _n_steps(eng), L))
        guarded = {"decode_step_ms": _median_ms(ticks["decode"]),
                   "launch_failures": eng.launch_failures,
                   "bitwise_equal_uninterrupted": eng.completions() == want}
        guarded["overhead_ms_a_decode_step"] = (
            guarded["decode_step_ms"] - out["uninterrupted_decode_step_ms"])
        eng.close()
        eng = _snap_engine(cfg, model, prefill_chunk=chunk,
                           step_deadline_s=SERVE_DEADLINE_S,
                           retry_base_delay_s=0.001)
        real, hung = eng.fns.decode, []

        def hang_once(*a, **kw):
            if len(hung) == 0 and eng.steps["decode"] >= 5:
                hung.append(time.perf_counter())
                while time.perf_counter() - hung[0] < 60.0:
                    time.sleep(0.02)  # a Python-level stall
            return real(*a, **kw)

        eng.fns.decode = hang_once
        _submit(eng, prompts, seed, SNAP_NEW)
        DA.reset_launch_counts()
        t0 = time.perf_counter()
        _ticks(eng)
        trip_wall = time.perf_counter() - t0
        add(_k6("engine with a forced trip", _n_steps(eng), L))
        guarded["forced_trip"] = {
            "deadline_s": SERVE_DEADLINE_S, "drain_s": trip_wall,
            "launch_failures": eng.launch_failures,
            "bitwise_equal_uninterrupted": eng.completions() == want}
        eng.close()
        guarded["trip_during_synchronize"] = _trip_during_sync(
            dev, f"{root}/stacks.txt")
        out["guarded_launch"] = guarded
        if not (guarded["bitwise_equal_uninterrupted"]
                and guarded["launch_failures"] == 0
                and guarded["forced_trip"]["launch_failures"] == 1
                and guarded["forced_trip"]["bitwise_equal_uninterrupted"]
                and guarded["forced_trip"]["drain_s"] < 30.0):
            fail(f"engine deadlines: {guarded}")
        if guarded["trip_during_synchronize"]["trip_fired_after_s"] is None:
            fail("the watchdog did not trip during a long synchronize")

        # the MoE engine (phase 27's configuration), killed and restored
        mcfg = gpt2_124m(dtype=torch.bfloat16, moe_experts=MOE_E,
                         moe_capacity=MOE_CAP) if L == 12 else \
            dataclasses.replace(cfg, moe_experts=4, moe_capacity=2)
        mmodel = Transformer(mcfg).init_weights(seed).to(dev)
        mprompts = _snap_prompts(seed + 1, 8, Q_PROMPTS)
        mwant, _, k6 = _uninterrupted(mcfg, mmodel, mprompts, seed,
                                      SNAP_NEW, Q_CHUNK)
        add(k6)
        got, stats, k6 = _kill_restore(
            mcfg, mmodel, mprompts, seed, f"{root}/moe", max_new=SNAP_NEW,
            prefill_chunk=Q_CHUNK, kill_at=30, saves={15: False, 22: True})
        add(k6)
        stats["bitwise_equal_uninterrupted"] = got == mwant
        out["moe_kill_restore"] = stats
        del mmodel
        if got != mwant:
            fail("moe engine kill/restore: a restored stream differs from "
                 "the uninterrupted MoE engine's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"engine snapshots on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"K6 launches by regime (phase 31's drains): "
          f"{json.dumps(counts)}", flush=True)
    return counts


# phase 33: the elastic world's storm (two slices of one process, slice 1
# lost after round 3 and back at round 6), its workload and its deadline
ELASTIC_SPEC = dict(total_steps=8, ckpt_every=2, sync_period=2,
                    global_batch=8, dim=4, seed=3, outer_momentum=0.9,
                    outer_lr=0.7)
ELASTIC_TOL = 1e-6


def check_elastic_world(seed, kind) -> None:
    """Phase 33: ``ElasticSupervisor`` over two slices of one process
    sharing the card over gloo (``MultiSliceLocalSGD``, ``sync_period=2``,
    outer Nesterov momentum), one ``slice_loss`` and one
    ``slice_return``; the same supervisor on the CPU beside it."""
    import concurrent.futures

    from distributed_tensorflow_guide_tpu_torch.train.elastic_world import (
        ElasticSupervisor,
        toy_spec,
    )

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dtg_phase33_")

    def run(device):
        sched = FaultSchedule([Fault("slice_loss", 3, 1.0),
                               Fault("slice_return", 6, 1.0)])
        sup = ElasticSupervisor(
            sched, n_slices=2, procs_per_slice=1,
            base_spec=toy_spec(**dict(ELASTIC_SPEC, seed=seed + 3)),
            ckpt_dir=f"{root}/{device}/ckpt",
            workdir=f"{root}/{device}/work", timeout=300,
            failure_grace=2.0, device=device)
        return sup.run(), sup, sched

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = {d: pool.submit(run, d) for d in ("cuda", "cpu")}
            runs = {d: f.result() for d, f in futures.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"slices": 2, "procs_per_slice": 1,
           **dict(ELASTIC_SPEC, seed=seed + 3)}
    for device, (rep, sup, sched) in runs.items():
        ok, problems = rep.accounting(ELASTIC_SPEC["total_steps"],
                                      ELASTIC_SPEC["global_batch"])
        out[device] = {
            "timeline": rep.timeline,
            "generations": len(rep.timeline),
            "restarts": sum(e["outcome"] != "clean" for e in rep.timeline),
            "seconds_a_generation": sup.generation_s,
            "mttr_s": rep.mttr_s, "accounting_ok": ok,
            "problems": problems, "pending_faults": len(sched.pending),
            "final_params": rep.final_params}
    gap = float(np.max(np.abs(np.asarray(out["cuda"]["final_params"])
                              - np.asarray(out["cpu"]["final_params"]))))
    out["max_param_gap_card_vs_cpu"] = gap
    print(f"elastic world on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    for device in ("cuda", "cpu"):
        r = out[device]
        if [e["outcome"] for e in r["timeline"]] != [
                "slice_loss", "clean", "clean"] or r["pending_faults"]:
            fail(f"elastic world on {device}: timeline {r['timeline']}")
        if not r["accounting_ok"]:
            fail(f"elastic world on {device}: accounting {r['problems']}")
    if gap > ELASTIC_TOL:
        fail(f"elastic world: the card's final parameters differ from the "
             f"CPU run's by {gap} (limit {ELASTIC_TOL})")


# ---- phases 34-36: the serving fleet and the metrics plane ------------------

# phase 34: 16 sampled requests of 200-400 tokens, 96 new each, through
# 8 slots; 96 usable blocks of 16 hold the padded prompts of about 4
# residents, so decode growth preempts decoding residents (5 times at
# --seed 0), and 1024 host blocks take every demotion
SPILL_REQS, SPILL_PROMPTS, SPILL_NEW = 16, (200, 401), 96
SPILL_BLOCKS, SPILL_HOST_BLOCKS = 97, 1024
SPILL_CHUNK = 128
WARM_PREFIX, WARM_REQS = 256, 4
# phase 35: 2 replicas of 4 slots on the one card, 12 sampled requests of
# 64-256 tokens (half share a 128-token prefix), 32 new each
FLEET_SLOTS, FLEET_BLOCKS = 4, 257
FLEET_REQS, FLEET_PROMPTS, FLEET_NEW = 12, (64, 257), 32
FLEET_SHARED = 128
KV_XFER_BLOCKS = 8
# phase 36: hooked GPT-2 steps (phase 7's configuration), the hooks
# logging every 4th step (each logged step reads the loss: one wait for
# the card)
HOOK_STEPS, HOOK_EVERY = 8, 4


def _spill_engine(cfg, model, *, num_blocks, recorder=None, **kw):
    """Phase 34's engine: 8 slots, block 16, 128-token chunks, sampled
    (temperature 0.8, top-k 20), captured steps."""
    return ServeEngine(cfg, model, slots=8, block_size=16,
                       num_blocks=num_blocks, prefill_chunk=SPILL_CHUNK,
                       temperature=0.8, top_k=20, recorder=recorder,
                       device=model.device, **kw)


def _drive_clock(eng) -> dict:
    """Drain ``eng`` on the host clock (events carry real seconds): tick
    seconds by kind and each request's TTFT from its submit."""
    ticks, ttft = {"decode": [], "prefill": []}, {}
    t0 = time.perf_counter()
    while eng.sched.has_queued or eng.sched.has_resident:
        events, kind = eng.step(now=time.perf_counter() - t0)
        if kind == "idle":
            fail("engine idle with work queued")
        ticks[kind].append(eng.last_tick_s)
        for e in events:
            if e.first:
                ttft[e.rid] = time.perf_counter() - t0
    return {"ticks": ticks, "ttft": ttft}


def _spill_gates(what, eng, block_bytes) -> dict:
    """The spill counters of a drained engine, held to the closed form."""
    h = eng.health()
    out = {k: h[k] for k in ("preemptions", "spill_out_blocks",
                             "spill_in_blocks", "spill_d2h_bytes",
                             "spill_h2d_bytes", "spill_prefetched_blocks",
                             "spill_resumes", "swapin_tokens_saved")}
    out["block_bytes"] = block_bytes
    if (h["spill_resumes"] < 1 or h["spill_d2h_bytes"]
            != block_bytes * h["spill_out_blocks"]
            or h["spill_h2d_bytes"] != block_bytes * h["spill_in_blocks"]):
        fail(f"{what}: spill counters {out} (closed form {block_bytes} "
             "bytes a block)")
    eng.sched.check_leaks()
    if eng.store.live_blocks():
        fail(f"{what}: {eng.store.live_blocks()} host blocks left")
    return out


def _transfer_ms(eng, n: int) -> dict:
    """One fused d2h and one fused h2d of ``n`` pool blocks (the same
    blocks written back), each ended by a synchronize: median ms of 5
    after a warm-up, and GB/s."""
    blocks = list(range(1, n + 1))
    dev = eng.device
    d2h, h2d = [], []
    for i in range(6):
        _sync(dev)
        t0 = time.perf_counter()
        payloads = eng.kv.d2h(blocks)  # synchronises before it returns
        t1 = time.perf_counter()
        eng.kv.h2d(blocks, payloads)
        _sync(dev)
        t2 = time.perf_counter()
        if i:
            d2h.append(t1 - t0)
            h2d.append(t2 - t1)
    nbytes = n * eng.kv.block_bytes
    return {"blocks": n, "bytes": nbytes,
            "d2h_ms": _median_ms(d2h), "h2d_ms": _median_ms(h2d),
            "d2h_gb_s": nbytes / float(np.median(d2h)) / 1e9,
            "h2d_gb_s": nbytes / float(np.median(h2d)) / 1e9}


def _resume_ms(cfg, model, prompts, seed, want, *, store: bool) -> dict:
    """Serve ``prompts`` on a roomy pool, preempt one decoding resident
    by hand, and time from the preemption until it emits again: resumed
    by swap-in (``store``: the preemption demotes its blocks) or rebuilt
    by ``"replay"``. Every stream must still be the uninterrupted one."""
    eng = _spill_engine(cfg, model, num_blocks=513,
                        host_blocks=SPILL_HOST_BLOCKS if store else 0)
    _submit(eng, prompts, seed, SPILL_NEW)
    sd = eng.sched
    while not (sd.slots and all(s is not None and s.phase == "decode"
                                and s.emitted_here >= 8
                                for s in sd.slots)):
        eng.step()
    i = max(range(len(sd.slots)), key=lambda j: sd.slots[j].admitted_seq)
    rid = sd.slots[i].rid
    n0 = len(sd.emitted[rid])
    _sync(eng.device)
    t0 = time.perf_counter()
    sd._preempt(i)
    ticks = 0
    while len(sd.emitted[rid]) == n0:
        eng.step()
        ticks += 1
    ms = 1e3 * (time.perf_counter() - t0)
    eng.run()
    if eng.completions() != {r: want[r] for r in eng.completions()}:
        fail(f"resume by {'swap-in' if store else 'replay'}: a stream "
             "differs from the uninterrupted engine's")
    out = {"ms_until_it_emits_again": ms, "ticks": ticks,
           "spill_resumes": sd.spill_resumes, "steps": _n_steps(eng)}
    eng.close()
    eng.sched.check_leaks()
    if (sd.spill_resumes == 1) != store:
        fail(f"resume: {sd.spill_resumes} spill resumes, store {store}")
    return out


def _warm_restart(cfg, model, seed, root) -> tuple[dict, int, dict]:
    """Requests sharing a 256-token prefix on a ``persist_cache`` engine;
    snapshot, close, restore a fresh engine and serve the prefix again
    (with a new suffix): its prefix comes back from the host tier by
    swap-in, zero prefix tokens are prefilled again, and its stream
    equals a cold engine's. Returns (numbers, engine steps, the warm
    engine's prefix-index stats)."""
    rng = np.random.RandomState(seed + 34)
    prefix = rng.randint(0, 50257, WARM_PREFIX).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(
        0, 50257, rng.randint(16, 65)).astype(np.int32)])
        for _ in range(WARM_REQS + 1)]
    kw = dict(prefix_cache=True, host_blocks=256, persist_cache=True,
              snapshot_dir=f"{root}/warm")
    eng = _spill_engine(cfg, model, num_blocks=513, **kw)
    _submit(eng, prompts[:WARM_REQS], seed, SPILL_NEW)
    _drive_clock(eng)
    nodes = eng.sched.prefix.size
    label = eng.save_snapshot()
    steps = _n_steps(eng)
    eng.close()

    def repeat(e):
        e.submit(Request(rid=100, prompt=prompts[-1],
                         max_new_tokens=SPILL_NEW,
                         rng=np.array([seed, 100], np.uint32)))
        p0, saved0 = e.steps["prefill"], e.sched.prefill_tokens_saved
        run = _drive_clock(e)
        return (run["ttft"][100], e.steps["prefill"] - p0,
                e.sched.prefill_tokens_saved - saved0,
                e.completions()[100])

    warm = _spill_engine(cfg, model, num_blocks=513, **kw)
    if warm.restore_latest_snapshot() != label:
        fail("warm restart: the restore took another snapshot")
    restored = warm.sched.prefix.size
    at_restore = _n_steps(warm)
    in0 = warm.sched.spill_in_blocks
    warm_ttft, warm_chunks, saved, warm_toks = repeat(warm)
    swapped = warm.sched.spill_in_blocks - in0
    prefix_stats = warm.sched.prefix.stats()
    steps += _n_steps(warm) - at_restore
    warm.close()
    warm.sched.check_leaks()
    cold = _spill_engine(cfg, model, num_blocks=513)
    cold_ttft, cold_chunks, _, cold_toks = repeat(cold)
    steps += _n_steps(cold)
    cold.close()
    suffix_chunks = -(-len(prompts[-1]) // SPILL_CHUNK) - \
        WARM_PREFIX // SPILL_CHUNK
    out = {"prefix_tokens": WARM_PREFIX, "trie_nodes_saved": nodes,
           "trie_nodes_restored": restored,
           "blocks_swapped_in": swapped,
           "prefill_chunks_warm": warm_chunks,
           "prefill_chunks_cold": cold_chunks,
           "prefix_tokens_prefilled_again": WARM_PREFIX - saved,
           "ttft_ms_warm": 1e3 * warm_ttft, "ttft_ms_cold": 1e3 * cold_ttft,
           "bitwise_equal_cold": warm_toks == cold_toks}
    if (saved != WARM_PREFIX or warm_chunks != suffix_chunks
            or restored != nodes or swapped != WARM_PREFIX // 16
            or warm_toks != cold_toks):
        fail(f"warm restart: {out}")
    return out, steps, prefix_stats


def check_spill_tier(cfg, model, seed, kind, keep: dict) -> dict:
    """Phase 34. Returns K6's launches by regime; leaves the bf16 spill
    engine's health, stats and event stream in ``keep`` for phase 36."""
    t_phase = time.perf_counter()
    L = cfg.num_layers
    prompts = _snap_prompts(seed + 34, SPILL_REQS, SPILL_PROMPTS)
    counts = {"split": 0, "chunk": 0}

    def add(what, steps):
        for r, n in _k6(what, steps, L).items():
            counts[r] += n

    out = {"requests": SPILL_REQS, "prompt_lengths": list(SPILL_PROMPTS),
           "new_tokens": SPILL_NEW, "slots": 8, "block_size": 16,
           "num_blocks": SPILL_BLOCKS, "host_blocks": SPILL_HOST_BLOCKS}
    root = tempfile.mkdtemp(prefix="dtg_phase34_")
    try:
        for kv in (None, "int8"):
            c = dataclasses.replace(cfg, kv_dtype=kv)
            name = kv or "bf16"
            roomy = _spill_engine(c, model, num_blocks=513)
            _submit(roomy, prompts, seed, SPILL_NEW)
            DA.reset_launch_counts()
            _drive_clock(roomy)
            add(f"spill {name} roomy", _n_steps(roomy))
            want = roomy.completions()
            if roomy.sched.preemptions:
                fail(f"spill {name}: the roomy pool preempted")
            roomy.close()
            rec = obs_events.FlightRecorder(capacity=1 << 16) \
                if kv is None else None
            eng = _spill_engine(c, model, num_blocks=SPILL_BLOCKS,
                                host_blocks=SPILL_HOST_BLOCKS, recorder=rec)
            ptrs = [t.data_ptr() for t in eng.kv.leaves]
            _submit(eng, prompts, seed, SPILL_NEW)
            DA.reset_launch_counts()
            run = _drive_clock(eng)
            add(f"spill {name}", _n_steps(eng))
            check_captures(eng.fns, 1)
            if [t.data_ptr() for t in eng.kv.leaves] != ptrs:
                fail(f"spill {name}: a pool leaf moved")
            if eng.completions() != want:
                fail(f"spill {name}: a stream differs from the roomy "
                     "pool's")
            stats = _spill_gates(f"spill {name}", eng,
                                 kv_block_bytes(c, 16))
            stats["decode_step_ms"] = _median_ms(run["ticks"]["decode"])
            stats["bitwise_equal_roomy_pool"] = True
            stats["transfers"] = [_transfer_ms(eng, n) for n in (8, 64)]
            out[f"{name}_pool"] = stats
            if kv is None:
                keep.update(health=eng.health(),
                            pool=eng.sched.pool.stats(),
                            store=eng.store.stats(),
                            events=rec.events(), steps=dict(eng.steps),
                            dump=f"{root}/dump.json")
                rec.dump(keep["dump"])
                out["resume"] = {}
                for how, store in (("swap_in", True), ("replay", False)):
                    DA.reset_launch_counts()
                    r = _resume_ms(c, model, prompts, seed, want,
                                   store=store)
                    add(f"resume by {how}", r["steps"])
                    out["resume"][how] = r
            eng.close()
        DA.reset_launch_counts()
        out["warm_restart"], steps, keep["prefix"] = _warm_restart(
            cfg, model, seed, root)
        add("warm restart", steps)
        with open(keep["dump"]) as f:
            keep["dump_text"] = f.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"spill tier on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"K6 launches by regime (phase 34's drains): "
          f"{json.dumps(counts)}", flush=True)
    return counts


class _FleetRun:
    """A fleet driven tick by tick on the host clock: every engine object
    it ever held (a crash replaces one) for K6's count, and the ticks
    from each crash until each of its streams emits again."""

    def __init__(self, fl):
        self.fl, self.seen, self.ticks = fl, list(fl.engines), 0
        self.recovery, self._waiting = [], {}

    def step(self):
        fl = self.fl
        owners = {rid: e["owner"] for rid, e in fl._ledger.items()
                  if not e["done"]}
        crashes = fl.replica_crashes
        evs, kind = fl.step(now=float("inf"))
        self.ticks += 1
        for e in fl.engines:
            if all(e is not s for s in self.seen):
                self.seen.append(e)
        if fl.replica_crashes > crashes:
            dead = {t["replica"] for t in fl.timeline
                    if t["kind"] == "replica_crash"
                    and t["tick"] == fl._tick - 1}
            for rid, owner in owners.items():
                if owner in dead:
                    self._waiting[rid] = self.ticks
        for e in evs:
            if e.rid in self._waiting and e.status == "ok":
                self.recovery.append(self.ticks - self._waiting.pop(e.rid))
        return evs, kind

    def run(self):
        idle = 0
        while self.fl._has_work():
            _, kind = self.step()
            idle = idle + 1 if kind == "idle" else 0
            if idle > 64:
                fail("fleet idle with work queued")

    def steps(self) -> int:
        return sum(_n_steps(e) for e in self.seen)


def _fleet(cfg, model, **kw):
    return FleetScheduler(cfg, model, replicas=["cuda:0", "cuda:0"]
                          if model.device.type == "cuda" else 2,
                          slots=FLEET_SLOTS, num_blocks=FLEET_BLOCKS,
                          block_size=16, prefill_chunk=SPILL_CHUNK,
                          temperature=0.8, top_k=20, device=model.device,
                          **kw)


def _fleet_submit(fl, prompts, seed):
    for i, p in enumerate(prompts):
        fl.submit(Request(rid=i, prompt=p, max_new_tokens=FLEET_NEW,
                          rng=np.array([seed, i], np.uint32),
                          tenant=i % 3))


def _fleet_gates(what, fl, want) -> dict:
    """Every stream the uninterrupted engine's, none dropped, the tenant
    counters a disjoint sum, both tiers of every replica leak-free."""
    got = fl.completions()
    h = fl.health()
    tenants = h["tenants"]
    out = {"completed": h["completed"], "migrations": h["migrations"],
           "replica_crashes": h["replica_crashes"],
           "replica_stalls": h["replica_stalls"],
           "migration_dups_dropped": h["migration_dups_dropped"],
           "replicas_shed": h["replicas_shed"],
           "prefix_route_hits": h["prefix_route_hits"],
           "replica_faults": h["replica_faults"],
           "tenants": {t: {k: c[k] for k in ("submitted", "done",
                                             "preempted")}
                       for t, c in tenants.items()},
           "bitwise_equal_single_engine": got == want}
    if got != want:
        differ = sorted(r for r in want if got.get(r) != want[r])
        fail(f"fleet {what}: streams {differ} differ from the single "
             "engine's")
    if (any(c["submitted"] != c["done"] for c in tenants.values())
            or sum(c["submitted"] for c in tenants.values()) != len(want)
            or h["completed"] != len(want) or h["replica_faults"]):
        fail(f"fleet {what}: {out}")
    fl.check_leaks()
    for e in fl.engines:
        caps = e.fns.captures
        if any(n > 1 for n in caps.values()):
            fail(f"fleet {what}: a replica captured {caps}")
    return out


def _storm(seed) -> FaultSchedule:
    """The first seeded ``random_fleet`` storm from ``seed`` on with a
    crash, a stall and a torn handoff, the torn one armed before a later
    crash or stall re-anchors streams (so its duplicate is made)."""
    s = seed
    while True:
        fc = FaultSchedule.random_fleet(s, max_position=24, replicas=2,
                                        n_faults=4, min_position=3)
        kinds = {f.kind for f in fc.pending}
        torn = [f.position for f in fc.pending
                if f.kind == "migration_torn"]
        later = [f.position for f in fc.pending
                 if f.kind in ("replica_crash", "replica_stall")]
        if len(kinds) == 3 and min(torn) <= max(later):
            return fc
        s += 1


def kv_transfer_rank(seed: int) -> dict:
    """Phase 35's transfer, one of two ranks sharing the card over gloo:
    8 GPT-2 124M bf16 blocks from slice 0 to slice 1, one ppermute."""
    from distributed_tensorflow_guide_tpu_torch.parallel.multislice import (
        make_kv_block_transfer,
        two_tier_mesh,
    )

    dev = resolve_device(None)
    cfg = gpt2_124m(dtype=torch.bfloat16)
    mesh = two_tier_mesh(MeshSpec(), n_slices=2)
    xfer = make_kv_block_transfer(mesh)
    nbytes = kv_block_bytes(cfg, 16)
    payload = torch.from_numpy(np.random.RandomState(seed + 35).randint(
        0, 256, (KV_XFER_BLOCKS, nbytes)).astype(np.uint8)).to(dev)
    me = mesh.axis("dcn").index
    send = payload if me == 0 else torch.zeros_like(payload)
    xfer(send)  # warm-up: connections and pinned staging
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        with cc.trace_comm() as rec:
            got = xfer(send)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"dcn_index": me, "ms": ms,
            "bytes": dict(rec.bytes), "wire": dict(rec.wire),
            "arrived_bitwise": bool(torch.equal(got, payload)),
            "closed_form": kv_migration_bytes(KV_XFER_BLOCKS, cfg, 16)}


def check_fleet(cfg, model, seed, kind, keep: dict) -> dict:
    """Phase 35. Returns K6's launches by regime; leaves the storm fleet's
    health in ``keep`` for phase 36."""
    t_phase = time.perf_counter()
    L = cfg.num_layers
    dev = model.device
    rng = np.random.RandomState(seed + 35)
    shared = rng.randint(0, 50257, FLEET_SHARED).astype(np.int32)
    prompts = []
    for i in range(FLEET_REQS):
        p = rng.randint(0, 50257, rng.randint(*FLEET_PROMPTS)).astype(
            np.int32)
        if i % 2:
            p = np.concatenate([shared, p[:64]])
        prompts.append(p)
    tokens = FLEET_REQS * FLEET_NEW
    counts = {"split": 0, "chunk": 0}

    def add(what, steps):
        for r, n in _k6(what, steps, L).items():
            counts[r] += n

    # the uninterrupted single engine: same slots, block size and chunk
    single = ServeEngine(cfg, model, slots=FLEET_SLOTS, block_size=16,
                         num_blocks=FLEET_BLOCKS, prefill_chunk=SPILL_CHUNK,
                         temperature=0.8, top_k=20, device=dev)
    _submit(single, prompts, seed, FLEET_NEW)
    DA.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    single.run()
    _sync(dev)
    single_s = time.perf_counter() - t0
    add("fleet reference engine", _n_steps(single))
    want = single.completions()
    single.close()
    out = {"replicas": 2, "slots": FLEET_SLOTS, "requests": FLEET_REQS,
           "new_tokens": FLEET_NEW, "single_engine_tokens_per_s":
               tokens / single_s}
    root = tempfile.mkdtemp(prefix="dtg_phase35_")
    try:
        # (a) colocated, prefix routing
        fl = _fleet(cfg, model, prefix_cache=True)
        _fleet_submit(fl, prompts, seed)
        run = _FleetRun(fl)
        DA.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        run.run()
        _sync(dev)
        wall = time.perf_counter() - t0
        add("fleet colocated", run.steps())
        out["colocated"] = _fleet_gates("colocated", fl, want)
        out["colocated"]["tokens_per_s"] = tokens / wall
        fl.close()

        # (b) disaggregated prefill / decode, migration with the KV
        rec = obs_events.FlightRecorder(capacity=1 << 16)
        fl = _fleet(cfg, model, roles="disagg", recorder=rec)
        _fleet_submit(fl, prompts, seed)
        run = _FleetRun(fl)
        DA.reset_launch_counts()
        run.run()
        add("fleet disagg", run.steps())
        stats = _fleet_gates("disagg", fl, want)
        blocks = sum(e.payload["blocks"] for e in rec.events()
                     if e.kind == "fleet.migrate")
        decode_h2d = sum(r["spill_h2d_bytes"]
                         for r in fl.health()["replicas"]
                         if r["role"] == "decode")
        closed = kv_migration_bytes(blocks, cfg, 16)
        stats.update(
            migration_bytes=fl.migration_bytes, migrated_blocks=blocks,
            closed_form_bytes=closed, decode_replica_h2d_bytes=decode_h2d,
            migration_ms_a_record=1e3 * fl.migration_secs / fl.migrations,
            migration_gb_s=fl.migration_bytes / fl.migration_secs / 1e9)
        out["disagg"] = stats
        if (fl.migrations != FLEET_REQS or fl.migration_bytes != closed
                or decode_h2d != closed):
            fail(f"fleet disagg: {stats}")
        fl.close()

        # (c) a seeded storm: crash, stall, torn handoff, slice loss
        fc = _storm(seed)
        schedule = [(f.kind, f.position, f.param) for f in fc.pending]
        torn = sum(k == "migration_torn" for k, _, _ in schedule)
        world = FaultSchedule([Fault("slice_loss", 8, 1.0),
                               Fault("slice_return", 14, 1.0)])
        fl = _fleet(cfg, model, fleet_chaos=fc, world_chaos=world)
        _fleet_submit(fl, prompts, seed)
        run = _FleetRun(fl)
        DA.reset_launch_counts()
        first = min(f.position for f in fc.pending
                    if f.kind == "replica_crash")
        while fl._tick < first:
            run.step()
        _sync(dev)
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        run.run()
        _sync(dev)
        mem1 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        add("fleet storm", run.steps())
        stats = _fleet_gates("storm", fl, want)
        pool_bytes = FLEET_BLOCKS * kv_block_bytes(cfg, 16)
        stats.update(schedule=schedule, world=[["slice_loss", 8],
                                               ["slice_return", 14]],
                     ticks_from_crash_to_emit=run.recovery,
                     memory_allocated_before=mem0,
                     memory_allocated_after=mem1,
                     replica_pool_bytes=pool_bytes)
        out["storm"] = stats
        keep["fleet_health"] = fl.health()
        crashes = sum(k == "replica_crash" for k, _, _ in schedule)
        if (fc.pending or world.pending or stats["replica_crashes"]
                != crashes or stats["replica_stalls"] < 1
                or stats["migration_dups_dropped"] < 1
                or stats["migration_dups_dropped"]
                != torn - fl._torn_pending
                or not run.recovery or mem1 - mem0 >= pool_bytes):
            fail(f"fleet storm: {stats}")
        fl.close()

        # (d) a fleet snapshot mid-run, restored into a fresh fleet
        fl = _fleet(cfg, model, snapshot_dir=f"{root}/fleet")
        _fleet_submit(fl, prompts, seed)
        run = _FleetRun(fl)
        DA.reset_launch_counts()
        emitted = 0
        while emitted < tokens // 3:
            evs, _ = run.step()
            emitted += sum(e.status == "ok" for e in evs)
        t0 = time.perf_counter()
        label = fl.save_snapshot()
        save_ms = 1e3 * (time.perf_counter() - t0)
        steps1 = run.steps()
        fl.close()
        fl2 = _fleet(cfg, model, snapshot_dir=f"{root}/fleet")
        if fl2.restore_latest_snapshot() != label:
            fail("fleet restore: another snapshot came back")
        run2 = _FleetRun(fl2)
        at_restore = run2.steps()
        run2.run()
        add("fleet restore", steps1 + run2.steps() - at_restore)
        stats = _fleet_gates("restore", fl2, want)
        stats.update(label=label, save_ms=save_ms,
                     tokens_at_snapshot=emitted)
        out["restore"] = stats
        fl2.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # one make_kv_block_transfer between two gloo ranks sharing the card
    if dev.type == "cuda":
        res = [r.result for r in run_multiprocess(
            "chip_smoke:kv_transfer_rank", 2, [seed], timeout=300)]
        recv = next(r for r in res if r["dcn_index"] == 1)
        send = next(r for r in res if r["dcn_index"] == 0)
        out["kv_block_transfer"] = {
            "blocks": KV_XFER_BLOCKS, "bytes": send["closed_form"],
            "sender_ms": send["ms"], "receiver_ms": recv["ms"],
            "trace_bytes": send["bytes"], "trace_wire": send["wire"],
            "arrived_bitwise": recv["arrived_bitwise"]}
        if (not recv["arrived_bitwise"] or send["bytes"]
                != {"ppermute[dcn]": send["closed_form"]}
                or send["wire"] != {"ppermute[dcn]": send["closed_form"]}):
            fail(f"kv block transfer: {out['kv_block_transfer']}")
    print(f"fleet on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"K6 launches by regime (phase 35's drains): "
          f"{json.dumps(counts)}", flush=True)
    return counts


def _decode_costs(cfg, model, keys, block_size: int) -> dict:
    """Two costs of one paged decode step (phases 36 and 39) whose
    resident slots read ``keys`` keys each through a pool of
    ``block_size``-slot blocks:

    * ``model``: the JAX package's byte model, the port's
      ``decode_hbm_bytes_per_step`` with K6's live blocks for its KV term
      (``decode_param_bytes_per_step`` + ``paged_decode_cache_bytes_per_
      step``): every non-embedding parameter at its stored bytes, B token
      rows and one position row;
    * ``moved``: what a replay moves, term by term: the f32 masters read
      once; the bf16 copies the blocks' products cast them to at every
      call (``models/transformer.py`` ``_linear``) written, then read
      again by the products (the head multiplies at f32, uncast); B token
      rows and B position rows (each slot sits at its own position); the
      same KV term.

    Both carry 2 x B x (non-embedding parameters) + 4 x L x d x (keys)
    FLOPs (the products, then q.k and p.v)."""
    B = len(keys)
    live = sum(-(-k // block_size) for k in keys)
    kv = gen_mod.paged_decode_cache_bytes_per_step(
        cfg, block_size=block_size, live_blocks=live, active_slots=B)
    sd = model.state_dict()
    emb = {k for k in sd if k.split(".", 1)[0] in ("tok_emb", "pos_emb")}
    n_params = sum(t.numel() for k, t in sd.items() if k not in emb)
    flops = (2.0 * B * n_params
             + 4.0 * cfg.num_layers * cfg.d_model * sum(keys))
    cast = 0
    if cfg.dtype != torch.float32:
        cast = sum(p.numel() * cfg.dtype.itemsize
                   for m in model.blocks.modules()
                   if isinstance(m, torch.nn.Linear)
                   for p in m.parameters())
    row = cfg.d_model * sd["tok_emb.weight"].element_size()
    terms = {"f32_master_reads": float(sum(
                 sd[k].numel() * sd[k].element_size()
                 for k in sd if k not in emb)),
             "bf16_cast_writes": float(cast),
             "bf16_copy_reads": float(cast),
             "token_rows": float(B * row), "position_rows": float(B * row),
             "kv": kv}
    model_bytes = gen_mod.decode_param_bytes_per_step(model, B) + kv
    return {"model": {"flops": flops, "hbm_bytes": model_bytes},
            "moved": {"flops": flops, "hbm_bytes": sum(terms.values()),
                      "terms": terms}}


def reconcile_decode_replay(cfg, seed, dev) -> dict:
    """Phase 36's reconciliation: phase 34's engine with 8 residents
    decoding, one captured decode replay timed (CUDA events) and
    reconciled under :func:`_decode_costs`' ``model`` and ``moved``."""
    from distributed_tensorflow_guide_tpu_torch.obs import recon

    model = Transformer(cfg).init_weights(seed).to(dev)
    eng = _spill_engine(cfg, model, num_blocks=513)
    _submit(eng, _snap_prompts(seed + 36, 8, SPILL_PROMPTS), seed,
            SPILL_NEW)
    while not all(s is not None and s.phase == "decode"
                  for s in eng.sched.slots):
        eng.step()
    eng.step()
    keys = [s.written for s in eng.sched.slots if s is not None]
    cfg_e = eng.fns.cfg
    costs = _decode_costs(cfg_e, eng.model, keys, cfg_e.paged_block_size)
    ms = decode_replay_ms(eng) if dev.type == "cuda" else 1.0
    roof = recon.Roofline.from_env()
    out = {"replay_ms": ms, "keys": keys,
           **{name: {"cost": c, **recon.reconcile(c, ms / 1e3, roof)}
              for name, c in costs.items()}}
    eng.close()
    del eng, model
    torch.cuda.empty_cache()
    return out


def check_metrics_plane(cfg, seed, kind, keep: dict) -> dict:
    """Phase 36. Returns the K1-K3 launches of its hooked and hook-free
    GPT-2 steps."""
    from distributed_tensorflow_guide_tpu_torch.obs import (
        metrics as obs_metrics,
    )
    from distributed_tensorflow_guide_tpu_torch.obs import tracing
    from distributed_tensorflow_guide_tpu_torch.train.hooks import (
        MetricsHook,
        TensorBoardHook,
    )
    from distributed_tensorflow_guide_tpu_torch.utils.tb_writer import (
        SummaryWriter,
        read_scalars,
    )

    t_phase = time.perf_counter()
    dev = resolve_device(None)
    out = {}
    # the registry over phases 34, 35 and 27
    reg = obs_metrics.Registry()
    obs_metrics.absorb_engine(reg, keep["health"])
    obs_metrics.absorb_pool(reg, keep["pool"])
    obs_metrics.absorb_spill_store(reg, keep["store"])
    obs_metrics.absorb_prefix(reg, keep["prefix"])
    obs_metrics.absorb_fleet(reg, keep["fleet_health"])
    # only phase 27's census: its other counters would overwrite phase
    # 34's under the same unlabeled names
    obs_metrics.absorb_engine(reg, {"moe": keep["moe_health"]["moe"]})
    text = reg.to_prometheus()
    snap = reg.snapshot()
    out["exposition_lines"] = len(text.splitlines())
    moe = [k for k in snap if k.startswith("dtg_moe_expert_load_total")]
    if (not moe or snap["dtg_serve_spill_resumes_total"] < 1
            or snap["dtg_fleet_replica_crashes_total"] < 1):
        fail(f"metrics: the registry misses a series ({len(snap)} "
             "series)")
    # phase 34's event stream as a Chrome trace
    events = keep["events"]
    trace = tracing.to_chrome_trace(events)
    json.loads(json.dumps(trace))
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    launches = {k: [e for e in events if e.kind == f"{k}.launch"]
                for k in ("prefill", "decode")}
    x_prefill = sum(e["name"].startswith("prefill ") for e in xs)
    x_decode = sum(e["name"].startswith("decode ") for e in xs)
    want_decode = sum(len(e.payload["slots"]) for e in launches["decode"])
    out["chrome_trace"] = {"events": len(trace["traceEvents"]),
                           "complete_spans_prefill": x_prefill,
                           "complete_spans_decode": x_decode}
    if (len(launches["prefill"]) != keep["steps"]["prefill"]
            or len(launches["decode"]) != keep["steps"]["decode"]
            or x_prefill != len(launches["prefill"])
            or x_decode != want_decode):
        fail(f"chrome trace: {out['chrome_trace']}, steps {keep['steps']}")
    bk = tracing.ttft_breakdown(events)
    out["ttft_breakdown_ms_median"] = {
        k: 1e3 * float(np.median([v[k] for v in bk.values()]))
        for k in ("queue_wait_s", "prefill_s", "first_decode_s")}
    root = tempfile.mkdtemp(prefix="dtg_phase36_")
    try:
        dump = f"{root}/dump.json"
        with open(dump, "w") as f:
            f.write(keep["dump_text"])
        cli = subprocess.run(
            [sys.executable, "-m",
             "distributed_tensorflow_guide_tpu_torch.obs.cli", dump,
             "--chrome", f"{root}/trace.json"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        out["obs_cli_rc"] = cli.returncode
        if cli.returncode:
            fail(f"obs cli: rc {cli.returncode}: {cli.stderr[-2000:]}")

        out["reconcile_decode_replay"] = reconcile_decode_replay(cfg, seed,
                                                                 dev)

        # MetricsHook + TensorBoardHook over phase 7's steps
        B, S = TRAIN_B, TRAIN_S
        tokens = np.random.RandomState(seed + 36).randint(
            0, 50257, (B, S)).astype(np.int64)
        batch = {"tokens": torch.as_tensor(tokens, device=dev)}
        FA.reset_launch_counts()

        def train(hooks):
            model = Transformer(cfg).init_weights(seed).to(dev)
            state = TrainState(model, torch.optim.Adam(model.parameters(),
                                                       lr=1e-3))
            step = DataParallel(device=dev).make_train_step(
                make_lm_loss_fn(model))
            losses = _Losses()
            _sync(dev)
            t0 = time.perf_counter()
            TrainLoop(step, state, iter(lambda: batch, None),
                      hooks=[StopAtStepHook(HOOK_STEPS), losses, *hooks],
                      device=dev).run()
            _sync(dev)
            ms = 1e3 * (time.perf_counter() - t0) / HOOK_STEPS
            return model, [x.item() for x in losses.losses], ms

        plain, losses, _ = train([])
        reg = obs_metrics.Registry()
        with SummaryWriter(f"{root}/metrics") as w:
            hooked, hooked_losses, hooked_ms = train(
                [MetricsHook(reg, every_steps=HOOK_EVERY, writer=w),
                 TensorBoardHook(f"{root}/tb", every_steps=HOOK_EVERY)])
        same = all(torch.equal(a, b) for a, b in zip(
            plain.state_dict().values(), hooked.state_dict().values()))
        del plain, hooked
        _, _, plain_ms = train([])  # the hook-free time, after the hooked
        (tb_file,) = glob.glob(f"{root}/tb/events.out.tfevents.*")
        rows = read_scalars(tb_file)
        (m_file,) = glob.glob(f"{root}/metrics/events.out.tfevents.*")
        m_rows = read_scalars(m_file)
        out["hooks"] = {
            "steps": HOOK_STEPS, "hook_free_ms_a_step": plain_ms,
            "hooked_ms_a_step": hooked_ms,
            "hooks_ms_a_step": hooked_ms - plain_ms,
            "tb_losses": [r[1]["loss"] for r in rows],
            "metrics_rows": [s for s, _ in m_rows],
            "steps_total": reg.snapshot()["dtg_train_steps_total"],
            "params_bitwise_equal_hook_free": same}
        logged = list(range(0, HOOK_STEPS, HOOK_EVERY))
        if ([s for s, _ in rows] != logged or out["hooks"]["tb_losses"]
                != [losses[s] for s in logged]):
            fail(f"TensorBoard losses {rows} != the loop's {losses}")
        if hooked_losses != losses or not same:
            fail("hooked training differs from the hook-free run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {n: FA.LAUNCHES[n] for n in K1_K3}
    if launches != {n: 3 * HOOK_STEPS * cfg.num_layers for n in K1_K3}:
        fail(f"phase 36 flash launches {launches}")
    print(f"metrics plane on {kind}: " + json.dumps(out)
          + f" | phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


# ---- phase 37: the data plane ------------------------------------------------

# the corpus: the repo's root Markdown files in sorted path order, cut to
# their first 192 KB; the BPE's vocabulary; GPT-2's and BERT's sequences
CORPUS_BYTES, BPE_VOCAB, DP_S, DP_BERT_S = 192 * 1024, 512, 1024, 128
# ResNet-50's records: stored 256 x 256, cropped to 224 with a flip
DP_IMAGES, DP_STORED = 512, 256
# the determinism runs' steps; MNIST's records; MNIST and BERT steps
DP_CHECK_STEPS, DP_MNIST_RECORDS, DP_FEW_STEPS = 5, 4096, 10


def _dp_argv(seed: int, profile_dir: str) -> list:
    """The phase's own run configuration, as a command line."""
    return ["--steps", "20", "--global-batch", "8", "--seed", str(seed),
            "--profile-dir", profile_dir]


def _twin_equal(name, path, fields, bs, epochs=2, **kw) -> int:
    """``NativeRecordLoader`` against ``PyRecordLoader`` over ``epochs``
    epochs: byte-equal batches. Returns the batches compared."""
    nat = NativeRecordLoader(path, fields, bs, **kw)
    twin = PyRecordLoader(path, fields, bs, **kw)
    n = epochs * nat.batches_per_epoch
    for i in range(n):
        a, b = nat.next_batch(), twin.next_batch()
        for k in b:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                fail(f"{name}: native batch {i} field {k} differs from the "
                     "Python twin's")
    nat.close()
    return n


class _Wall(BaseHook):
    """Host clock over steps ``[first, last)``, each end after a
    synchronize: the time a step takes with its input (the CUDA events of
    ``timed_run`` time the step call alone)."""

    def __init__(self, first: int, last: int):
        self.first, self.last, self.t = first, last, {}

    def after_step(self, step, metrics):
        if step + 1 in (self.first, self.last):
            torch.cuda.synchronize()
            self.t[step + 1] = time.perf_counter()

    def ms_a_step(self) -> float:
        return (1e3 * (self.t[self.last] - self.t[self.first])
                / (self.last - self.first))


def _widened(feed, widen: dict):
    """The prefetched device batches with ``widen[name](tensor)`` applied
    on the card, after the copy."""
    for b in feed:
        yield {k: widen[k](v) if k in widen else v for k, v in b.items()}


def _corpus_bytes() -> bytes:
    root = os.path.dirname(os.path.abspath(__file__))
    data = b""
    for path in sorted(glob.glob(os.path.join(root, "*.md"))):
        with open(path, "rb") as fh:
            data += fh.read()
    return data[:CORPUS_BYTES]


def _lm_from_records(cfg, rec, seed, steps, dev, hooks=()):
    """``steps`` steps of phase 7's step, fed from the token records by
    the native loader and ``DevicePrefetchIterator`` (depth 2), the int32
    tokens widened on the card. Returns (losses, step ms each, peak bytes,
    the loop, the prefetch stats, the loader's batches an epoch)."""
    model = Transformer(cfg).init_weights(seed).to(dev)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = DataParallel().make_train_step(make_lm_loss_fn(model))
    loader = NativeRecordLoader(rec, text_fields(DP_S), 8, seed=seed)
    feed = DevicePrefetchIterator(loader, depth=2)
    out = timed_run(step, state,
                    _widened(feed, {"tokens": torch.Tensor.long}), steps,
                    hooks)
    per_epoch = loader.batches_per_epoch
    loader.close()
    return (*out, feed.stats, per_epoch)


def check_data_plane(cfg, seed, kind, step7_ms, resnet_images_s) -> dict:
    """Phase 37. Returns the K1-K3 launches of its record-fed GPT-2
    steps."""
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    root = tempfile.mkdtemp(prefix="dtg_data_plane_")
    out = {}
    try:
        # the phase reads its own steps, batch, seed and profile_dir
        rc = RunConfig.from_argv(_dp_argv(seed, os.path.join(root,
                                                             "profile")))
        rc.save(os.path.join(root, "run.json"))
        if RunConfig.load(os.path.join(root, "run.json")) != rc:
            fail("RunConfig did not load back equal")
        if rc.apply_platform() is not None:
            fail("RunConfig: the phase's config selected the CPU")
        B, steps = rc.global_batch, rc.steps
        out["run_config"] = rc.to_dict()

        # the build (g++), not the Python twin
        t0 = time.perf_counter()
        so = native_loader.build_native_lib()
        out["loader_build_s"] = time.perf_counter() - t0
        if native_loader.load_native_lib() is None:
            fail("the native loader did not load")
        out["loader_library"] = os.path.basename(so)

        # GPT-2 124M from BPE records
        corpus = os.path.join(root, "corpus.txt")
        text = _corpus_bytes()
        with open(corpus, "wb") as fh:
            fh.write(text)
        t0 = time.perf_counter()
        tok = ByteBPETokenizer.train(text, BPE_VOCAB)
        out["bpe"] = {"corpus_bytes": len(text), "vocab": tok.vocab_size,
                      "merges": len(tok.merges),
                      "train_s": time.perf_counter() - t0}
        rec = os.path.join(root, "tokens.records")
        t0 = time.perf_counter()
        n_rec = import_text(corpus, rec, tok, DP_S)
        out["bpe"].update(records=n_rec, import_s=time.perf_counter() - t0)
        if n_rec < 2 * B:
            fail(f"{n_rec} token records: too few for 2 shards of batch {B}")
        twins = {f"tokens_shard{i}_of_2": _twin_equal(
            "tokens", rec, text_fields(DP_S), B, seed=rc.seed, shard_id=i,
            num_shards=2) for i in range(2)}
        if cfg.resolve_attn_impl(DP_S) != "flash":
            fail("attn_impl='auto' did not resolve to flash at S=1024")
        FA.reset_launch_counts()
        hook = ProfilerHook(rc.profile_dir, start_step=10, end_step=13)
        wall = _Wall(2, hook.start_step)
        curve, step_ms, peak, loop, pstats, per_epoch = _lm_from_records(
            cfg, rec, rc.seed, steps, dev, [wall, hook])
        dispatch = loop.dispatch_stats.as_dict()
        del loop
        torch.cuda.empty_cache()
        traces = glob.glob(os.path.join(rc.profile_dir, "*.pt.trace.json"))
        if len(traces) != 1:
            fail(f"the profiler hook wrote {traces}, expected one trace")
        with open(traces[0]) as fh:
            trace_text = fh.read()
        named = {k: f"{k}_sm90" in trace_text for k in K1_K3}
        outside = [ms for i, ms in enumerate(step_ms)
                   if i >= 2 and not hook.start_step <= i < hook.end_step]
        out["gpt2"] = {
            "B": B, "S": DP_S, "steps": steps, "loss_curve": curve,
            "step_ms_each": step_ms,
            "step_ms_median_after_2": float(np.median(step_ms[2:])),
            "step_ms_median_after_2_outside_profile":
                float(np.median(outside)),
            "phase7_fixed_batch_step_ms": step7_ms,
            "wall_ms_a_step_steps_2_to_9": wall.ms_a_step(),
            "batches_per_epoch": per_epoch, "prefetch": pstats.as_dict(),
            "dispatch": dispatch, "max_memory_allocated_bytes": peak,
            "trace_bytes": len(trace_text), "trace_names_kernels": named}
        check_falls("data plane gpt2", curve, 5)
        if per_epoch >= steps:
            fail(f"{steps} steps did not wrap an epoch of {per_epoch}")
        if not all(named.values()):
            fail(f"the profiler trace does not name every flash kernel: "
                 f"{named}")

        # determinism: two 5-step runs from the same records and seed
        def five_steps(s):
            losses = _lm_from_records(cfg, rec, s, DP_CHECK_STEPS, dev)[0]
            torch.cuda.empty_cache()
            return [{"loss": x} for x in losses]

        rep = check_runs(five_steps, seed=rc.seed, rtol=0.0)
        out["gpt2"]["check_runs"] = dataclasses.asdict(rep)
        rep.raise_if_failed()
        launches = {n: FA.LAUNCHES[n] for n in K1_K3}
        want = (steps + 2 * DP_CHECK_STEPS) * cfg.num_layers
        if launches != dict.fromkeys(K1_K3, want) or FA.fallback_stats():
            fail(f"phase 37 flash launches {launches}, expected {want} each "
                 f"(fallbacks {FA.fallback_stats()})")

        # ResNet-50 from augmented records, then the allocator's snapshot
        out["twin_batches_compared"] = twins
        out["resnet50"] = _resnet_from_records(root, rc.seed,
                                               resnet_images_s)
        mem = os.path.join(root, "memory.pickle")
        save_memory_profile(mem)
        out["memory_profile_bytes"] = os.path.getsize(mem)
        if not out["memory_profile_bytes"]:
            fail("save_memory_profile wrote an empty file")

        # MNIST and BERT-base from imported records
        out["mnist"] = _mnist_from_records(root, rc.seed)
        out["bert"] = _bert_from_records(root, rc.seed, text, tok)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"data plane on {kind}: " + json.dumps(out), flush=True)
    return launches


def _resnet_from_records(root, seed, fixed_images_s) -> dict:
    """Phase 11's step fed from augmented image records, the native
    loader first held to its twin over two epochs."""
    B, steps, crop = RESNET_B, 20, RESNET_IMAGE
    dev = resolve_device(None)
    fields = make_fields({"image": (np.uint8, (DP_STORED, DP_STORED, 3)),
                          "label": (np.int32, ())})
    path = os.path.join(root, "images.records")
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    for lo in range(0, DP_IMAGES, 128):  # in bounded-memory chunks
        n = min(128, DP_IMAGES - lo)
        write_records(path, {
            "image": rng.randint(0, 256, (n, DP_STORED, DP_STORED, 3),
                                 dtype=np.uint8),
            "label": rng.randint(0, 1000, n).astype(np.int32)},
            fields, append=lo > 0)
    write_s = time.perf_counter() - t0
    aug = ImageAugment(in_shape=(DP_STORED, DP_STORED, 3),
                       crop=(crop, crop), hflip=True)
    twin_batches = _twin_equal("images", path, fields, B, seed=seed,
                               augment=aug)
    # the loader alone: six batches after the ring's first, host clock
    loader = NativeRecordLoader(path, fields, B, seed=seed, augment=aug)
    loader.next_batch()
    t0 = time.perf_counter()
    for _ in range(6):
        loader.next_batch()
    records_s = 6 * B / (time.perf_counter() - t0)
    loader.close()

    torch.backends.cudnn.benchmark = True
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16).to(
        dev).init_weights(seed)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                              momentum=0.9))
    step = DataParallel().make_train_step_with_stats(
        resnet.make_loss_fn(model))
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    loader = NativeRecordLoader(path, fields, B, seed=seed, augment=aug)
    feed = DevicePrefetchIterator(loader, depth=2)
    wall = _Wall(2, steps)
    curve, step_ms, peak, loop = timed_run(
        step, state, _widened(feed, {"image": lambda t: t.float() / 255.0}),
        steps, [wall])
    loader.close()
    torch.backends.cudnn.benchmark = False
    moved = sum(not torch.equal(b, stats0[n])
                for n, b in model.named_buffers())
    steady = float(np.median(step_ms[2:]))
    out = {"B": B, "stored": DP_STORED, "crop": crop, "records": DP_IMAGES,
           "record_bytes": record_bytes(fields), "write_s": write_s,
           "twin_batches_compared": twin_batches,
           "loader_records_per_s": records_s, "loss_curve": curve,
           "step_ms_median_after_2": steady,
           "images_per_s": B / (steady / 1e3),
           "wall_images_per_s_steps_2_to_19": B / (wall.ms_a_step() / 1e3),
           "phase11_fixed_batch_images_per_s": fixed_images_s,
           "prefetch": feed.stats.as_dict(),
           "dispatch": loop.dispatch_stats.as_dict(),
           "running_stat_buffers_moved": moved,
           "max_memory_allocated_bytes": peak}
    del model, state, step, loop
    torch.cuda.empty_cache()
    if moved != len(stats0):
        fail(f"resnet50 from records: {len(stats0) - moved} running "
             "statistics did not move")
    return out


def _mnist_from_records(root, seed) -> dict:
    """Phase 12's step fed from IDX files imported to records."""
    B = 1024
    dev = resolve_device(None)
    raw = os.path.join(root, "mnist_idx")
    os.makedirs(raw)
    b = synthetic.synthetic_mnist(DP_MNIST_RECORDS, seed=seed).take(1)[0]
    images = np.clip(b["image"][..., 0] * 64 + 128, 0, 255).astype(np.uint8)
    plain = os.path.join(raw, "train-images-idx3-ubyte")
    write_idx(plain, images)
    with open(plain, "rb") as fh, open(plain + ".gz", "wb") as gz:
        gz.write(gzip.compress(fh.read()))  # this one gzipped, as shipped
    os.remove(plain)
    write_idx(os.path.join(raw, "train-labels-idx1-ubyte"),
              b["label"].astype(np.uint8))
    rec = import_mnist(raw, os.path.join(root, "mnist"))
    n = os.path.getsize(rec) // record_bytes(MNIST_FIELDS)
    loader = NativeRecordLoader(rec, MNIST_FIELDS, B, seed=seed)
    if not loader.num_records == n == DP_MNIST_RECORDS:
        fail(f"mnist: {loader.num_records} records loaded, {n} in the file, "
             f"{DP_MNIST_RECORDS} imported")
    model = mnist_cnn.MNISTCNN().to(dev).init_weights(seed)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.05,
                                              momentum=0.9))
    feed = DevicePrefetchIterator(loader, depth=2)
    curve, step_ms, _, _ = timed_run(
        DataParallel().make_train_step(mnist_cnn.make_loss_fn(model)),
        state, _widened(feed, {"image": lambda t: t.float() / 255.0}),
        DP_FEW_STEPS)
    loader.close()
    return {"B": B, "records": n, "loss_curve": curve,
            "step_ms_median_after_2": float(np.median(step_ms[2:])),
            "prefetch": feed.stats.as_dict()}


def _bert_from_records(root, seed, text: bytes, tok) -> dict:
    """Phase 14's step, with its warm-up, fed from a seeded
    ``label<TAB>text`` file of the corpus's lines (each cut into pieces of
    at most 512 bytes) imported with the phase's tokenizer."""
    B = 256
    dev = resolve_device(None)
    rng = np.random.RandomState(seed)
    lines = [ln[i:i + 512].replace(b"\t", b" ")
             for ln in text.splitlines() if ln.strip()
             for i in range(0, len(ln), 512)]
    tsv = os.path.join(root, "labeled.tsv")
    with open(tsv, "wb") as fh:
        for ln in lines:
            fh.write(b"%d\t%s\n" % (rng.randint(0, 2), ln))
    rec = os.path.join(root, "labeled.records")
    n = import_labeled_text(tsv, rec, tok, DP_BERT_S)
    loader = NativeRecordLoader(rec, labeled_text_fields(DP_BERT_S), B,
                                seed=seed)
    if not loader.num_records == n == len(lines):
        fail(f"bert: {loader.num_records} records loaded, {n} imported, "
             f"{len(lines)} lines")
    cfg = bert_base(num_classes=2, dtype=torch.bfloat16)
    model = Transformer(cfg).init_weights(seed).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    feed = DevicePrefetchIterator(loader, depth=2)
    curve, step_ms, _, _ = timed_run(
        DataParallel().make_train_step(make_cls_loss_fn(model)),
        TrainState(model, opt),
        _widened(feed, {"tokens": torch.Tensor.long}), DP_FEW_STEPS,
        [_Warmup(opt, BERT_WARMUP_STEPS)])
    loader.close()
    del model, opt
    torch.cuda.empty_cache()
    return {"B": B, "S": DP_BERT_S, "records": n, "loss_curve": curve,
            "step_ms_median_after_2": float(np.median(step_ms[2:])),
            "prefetch": feed.stats.as_dict()}


# ---- phase 38: the tuning table --------------------------------------------

TUNE_ITERS = 20  # timed calls a candidate (median), after a warm-up
TUNE_B, TUNE_S, TUNE_BS, TUNE_NBLK = 8, 1024, 16, 64  # phase 4's engine
TUNE_CE = dict(n=8 * 1024, d=768, v=50257)  # the GPT-2 step's head
TUNE_CE_REL = 1e-5  # a chunk's f32 loss against the default chunk's
TUNE_TRAIN_STEPS = 8  # two captured 4-step calls
# the captured GPT-2 steps at the tuned chunk against the default chunk:
# the first loss (the same weights; only the LSE's summation order and
# the GEMMs' column widths differ) and every later one (Adam carries the
# rounding along)
TUNE_LOSS0_ABS, TUNE_LOSS_ABS = 1e-3, 2e-2

_RELOAD = r"""
import json, sys
import torch
from distributed_tensorflow_guide_tpu_torch.ops import autotune
keys = json.loads(sys.argv[1])
autotune.set_online_tune(True)
got = [autotune.ensure_tuned_online(k["kernel"], device="cuda",
                                    dtype=getattr(torch, k["dtype"]),
                                    **k["key"]) for k in keys]
print(json.dumps({"values": got, **autotune.online_tune_stats()}))
"""


def _swept(kernel_key: str) -> dict:
    """The detail the sweep recorded under ``kernel_key``'s entry."""
    table = json.loads(autotune.table_path().read_text())
    hits = [v for k, v in table.items() if k.startswith(kernel_key)]
    if not hits:
        fail(f"autotune: no table entry under {kernel_key}")
    return hits[0]


def check_autotune(cfg, seed, kind, smi) -> dict:
    """Phase 38. Returns K6's launches by regime over the online engine's
    drain."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    path = autotune.table_path()
    if path.exists():
        fail(f"autotune: phases 1-37 wrote the table {path}")
    autotune.reset()
    plat = autotune._platform(device=dev)
    H, hd = cfg.num_heads, cfg.head_dim
    out = {"card": smi, "platform": plat, "table": str(path)}

    # (a) the decode split: each candidate against the plain split, then
    # the sweep (K5 + K6 at the engine's shapes)
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        r = DA.make_split_runners(b=TUNE_B, h=H, s=TUNE_S, d=hd,
                                  dtype=dtype, block_size=TUNE_BS,
                                  n_blk=TUNE_NBLK, device=dev, seed=seed)
        errs = {}
        for keys in autotune.split_keys_candidates(hd, dtype, TUNE_BS):
            errs[keys] = max(
                (a().float() - b().float()).abs().max().item()
                for a, b in ((lambda: r.k5(keys), lambda: r.k5_plain(keys)),
                             (lambda: r.k6(keys), lambda: r.k6_plain(keys))))
            if errs[keys] > BF16_ATOL:
                fail(f"autotune: {name} keys {keys} differ from the plain "
                     f"split by {errs[keys]} (tolerance {BF16_ATOL})")
        del r
        chosen = autotune.ensure_split_keys_tuned(
            h=H, d=hd, dtype=dtype, b=TUNE_B, s=TUNE_S,
            block_size=TUNE_BS, n_blk=TUNE_NBLK, iters=TUNE_ITERS,
            device=dev)
        ent = _swept(f"decode_split|b0|h{H}|s0|d{hd}|{autotune._dtype_name(dtype)}|")
        out[f"decode_split_{name}"] = {
            "chosen_keys": chosen, "default_keys": DA.split_keys(dtype, hd),
            "max_abs_err_vs_plain": errs,
            "swept_ms": {s["keys"]: {"k5_ms": s["k5_ms"], "k6_ms": s["k6_ms"],
                                     "sum_ms": 1e3 * s["secs_per_call"]}
                         for s in ent["detail"]["swept"]}}
        print(f"autotune decode split ({name} cache, K5 B={TUNE_B} "
              f"S={TUNE_S} C=1 + K6 B={TUNE_B} {TUNE_NBLK} blocks of "
              f"{TUNE_BS}; median of {TUNE_ITERS}) on {smi}: "
              + json.dumps(out[f"decode_split_{name}"]), flush=True)

    # (b) the fused-CE chunk at the GPT-2 step's head, forward + backward
    ce_kw = dict(dtype=torch.bfloat16, device=dev, **TUNE_CE)
    chunk = autotune.ensure_ce_tuned(iters=10, **ce_kw)
    ent = _swept(f"fused_ce|b{TUNE_CE['n']}|")
    gen = torch.Generator(device=dev).manual_seed(seed + 38)
    x = torch.randn(TUNE_CE["n"], TUNE_CE["d"], generator=gen,
                    device=dev).bfloat16()
    w = torch.randn(TUNE_CE["v"], TUNE_CE["d"], generator=gen,
                    device=dev) * 0.02
    tg = torch.randint(0, TUNE_CE["v"], (TUNE_CE["n"],), generator=gen,
                       device=dev)
    with torch.no_grad():
        ref = fused_cross_entropy(x, w.t(), tg, chunk=8192).item()
        ce_rel = {c: abs(fused_cross_entropy(x, w.t(), tg, chunk=c).item()
                         - ref) / ref
                  for c in autotune.ce_chunk_candidates(TUNE_CE["v"])}
    del x, w, tg
    if max(ce_rel.values()) > TUNE_CE_REL:
        fail(f"autotune: a chunk's loss strays from the default chunk's: "
             f"{ce_rel}")
    out["fused_ce"] = {"chosen_chunk": chunk, "default_chunk": 8192,
                       "loss_rel_vs_default": ce_rel,
                       "swept_ms": {s["chunk"]: 1e3 * s["secs_per_call"]
                                    for s in ent["detail"]["swept"]}}
    print(f"autotune fused CE (N={TUNE_CE['n']}, d={TUNE_CE['d']}, "
          f"V={TUNE_CE['v']}, bf16, forward + backward; median of 10) on "
          f"{smi}: " + json.dumps(out["fused_ce"]), flush=True)
    stats = autotune.online_tune_stats()
    if stats["failed"]:
        fail(f"autotune sweeps: failures {stats['failures']}")
    torch.cuda.empty_cache()

    # (c) the online path on a fresh table
    os.environ["DTG_AUTOTUNE_TABLE"] = str(path.with_name("online.json"))
    autotune.reset()
    model = Transformer(cfg).init_weights(seed).to(dev)
    rs = np.random.RandomState(seed + 38)
    prompts = [rs.randint(0, 50257, rs.randint(DA.CHUNK_MIN_ROWS,
                                               LORA_CHUNK + 1))
               .astype(np.int32) for _ in range(8)]
    eng = ServeEngine(cfg, model, slots=8, block_size=TUNE_BS,
                      num_blocks=513, prefill_chunk=LORA_CHUNK,
                      temperature=0.0, online_tune=True)
    tuned_keys = eng.fns.cfg.decode_split_keys
    after_engine = autotune.online_tune_stats()
    DA.reset_launch_counts()
    got, drain_stats = drain(eng, prompts, seed=seed)
    by_regime = check_k6_launches("autotune online engine", drain_stats,
                                  cfg.num_layers)
    check_captures(eng.fns, 1)
    eng.close()
    one = make_generate_fn(cfg, max_new_tokens=64, temperature=0.0)
    for i, p in enumerate(prompts):
        o = one(model, p[None].astype(np.int64),
                np.array([seed, i], np.uint32))
        if got[i] != o[0, len(p):].tolist():
            fail(f"autotune: the online engine's request {i} differs from "
                 f"the one-shot (keys {tuned_keys})")
    after_one_shot = autotune.online_tune_stats()
    del model
    torch.cuda.empty_cache()
    if after_engine["attempted"] < 1 or after_engine["failed"]:
        fail(f"autotune online engine: stats {after_engine}")
    if after_one_shot["attempted"] != after_engine["attempted"]:
        fail("autotune: the one-shot made an attempt of its own")
    losses = {}
    trs = np.random.RandomState(seed + 380)
    host = [{"tokens": trs.randint(0, 50257, (TRAIN_B, TRAIN_S))
             .astype(np.int64)} for _ in range(TUNE_TRAIN_STEPS)]
    for label, online in (("default_chunk", False), ("online", True)):
        dp = DataParallel()
        model = Transformer(cfg).init_weights(seed).to(dev)
        state = TrainState(model, torch.optim.Adam(
            model.parameters(), lr=1e-3, capturable=True))
        loss_fn = make_lm_loss_fn(
            model, ce_chunk=None if online else autotune.DEFAULT_CE_CHUNK)
        step = dp.make_train_step(loss_fn, steps_per_call=CAP_K,
                                  stacked_batch=True, per_step_metrics=True)
        sink = _Losses()
        TrainLoop(step, state, dp.prefetch(iter(host), steps_per_call=CAP_K),
                  steps_per_call=CAP_K, online_tune=online,
                  hooks=[StopAtStepHook(TUNE_TRAIN_STEPS), sink]).run()
        losses[label] = torch.stack(sink.losses).tolist()
        if step.captures != 1:
            fail(f"autotune training ({label}): {step.captures} captures")
        del model, state, step
        torch.cuda.empty_cache()
    stats = autotune.online_tune_stats()
    train_chunk = autotune.ce_chunk_for(
        n=TRAIN_B * (TRAIN_S - 1), d=cfg.d_model, v=cfg.vocab_size,
        dtype=cfg.dtype, device=dev)
    gaps = [abs(a - b) for a, b in zip(losses["online"],
                                       losses["default_chunk"])]
    out["online"] = {
        "engine_keys": tuned_keys, "engine_drain": drain_stats,
        "k6_by_regime": by_regime, "engine_equals_one_shot": True,
        "stats_after_engine": after_engine,
        "stats_after_one_shot": after_one_shot,
        "train_chunk": train_chunk, "train_losses": losses,
        "train_loss_gaps": gaps, "stats": stats}
    print(f"autotune online path on {kind}: " + json.dumps(out["online"]),
          flush=True)
    if stats["failed"] or stats["attempted"] != after_engine["attempted"] + 1:
        fail(f"autotune online training: stats {stats} (one attempt of "
             f"its own expected, for the CE chunk)")
    if stats["spent_s"] > stats["budget_s"]:
        fail(f"autotune online: {stats['spent_s']} s past the budget")
    if gaps[0] > TUNE_LOSS0_ABS or max(gaps) > TUNE_LOSS_ABS:
        fail(f"autotune training at chunk {train_chunk}: losses stray from "
             f"the default chunk's by {gaps}")

    # (d) a new process reloads the table: every key hits, no attempt
    table = json.loads(autotune.table_path().read_text())
    keys = [{"kernel": "decode_split", "dtype": "bfloat16",
             "key": {"h": H, "d": hd,
                     "shape": {"b": TUNE_B, "s": TUNE_S,
                               "block_size": TUNE_BS}}},
            {"kernel": "fused_ce", "dtype": "bfloat16",
             "key": {"n": TRAIN_B * (TRAIN_S - 1), "d": cfg.d_model,
                     "v": cfg.vocab_size}}]
    want = [tuned_keys, train_chunk]
    res = subprocess.run(
        [sys.executable, "-c", _RELOAD, json.dumps(keys)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode:
        fail(f"autotune reload: rc {res.returncode}: {res.stderr[-2000:]}")
    reloaded = json.loads(res.stdout.strip().splitlines()[-1])
    out["reload"] = {"entries": sorted(table), "want": want, **reloaded}
    print("autotune reload in a new process: " + json.dumps(out["reload"]),
          flush=True)
    if reloaded["values"] != want or reloaded["attempted"] or \
            reloaded["failed"]:
        fail(f"autotune reload: {reloaded} (expected {want} with no "
             "attempt)")
    if len(table) != 3:  # decode_split, fused_ce exact-N and N-generic
        fail(f"autotune: the online table holds {sorted(table)}")
    print(f"autotune phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return by_regime


# ---- phase 39: the program audit ----------------------------------------------

AUDIT_PROGRAMS = (
    "serve_decode_step", "serve_decode_step_lora", "serve_decode_step_moe",
    "serve_decode_step_wq8", "serve_decode_step_wqfp8",
    "serve_decode_step_moe_wq8", "serve_prefill_chunk_step",
    "serve_prefill_chunk_step_moe", "decode_step", "decode_spec_step",
    "fused_ce_loss_grad", "fp8_ste_matmul_grad",
)


def _node_regimes(census) -> dict:
    """K5 / K6 kernel nodes of a census, by ``name.regime``."""
    out = {k: 0 for k in DA.REGIME_LAUNCHES}
    for n in census.nodes:
        if n.kind == "kernel" and n.name in DA.LAUNCHES:
            out[f"{n.name}.{n.regime}"] += 1
    return out


def _audit_decode_step(cfg, model, dev, seed) -> tuple[dict, dict]:
    """Phase 39 (b): one eager decode step of phase 4's engine geometry
    under ``serve_decode_step``'s rules. Returns (its printout, K6's
    launches by regime)."""
    from distributed_tensorflow_guide_tpu_torch.analysis import (
        cost as acost,
        lint,
        rules,
        walker,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        build_step_fns,
        paged_cache_pool,
    )

    slots, bs, nblocks = 8, 16, 513
    fns = build_step_fns(cfg, slots=slots, num_blocks=nblocks,
                         block_size=bs, prefill_chunk=128, device=dev)
    view = model.with_config(fns.cfg)
    pool = paged_cache_pool(view)
    rng = np.random.RandomState(seed)
    written = rng.randint(32, 701, slots).astype(np.int32)
    tables = np.zeros((slots, fns.n_blk), np.int32)
    free = iter(rng.permutation(np.arange(1, nblocks)))
    for i, w in enumerate(written):
        for j in range(-(-int(w + 1) // bs)):
            tables[i, j] = next(free)
    last = rng.randint(0, 50257, slots)
    [base] = lint._registered(("serve_decode_step",))
    contract = dataclasses.replace(
        base, name="gpt2_124m_decode_step", policy="bf16",
        max_f32_intermediate_elems=None, cost=None)
    DA.reset_launch_counts()
    torch.cuda.synchronize()
    _, census = walker.record(fns.decode_fn,
                              (view, pool, tables, written, last),
                              device=dev)
    torch.cuda.synchronize()
    launched = {k: DA.REGIME_LAUNCHES[k] for k in DA.REGIME_LAUNCHES
                if k.startswith("paged_decode_attention.")}
    traced = rules.TracedProgram(contract.name, census)
    reports = {r.rule: r for r in (
        rules.rule_collectives(traced, contract),
        rules.rule_donation(traced, contract),
        rules.rule_determinism(traced, contract))}
    bad = {k: [f.message for f in r.findings]
           for k, r in reports.items() if not r.ok}
    if bad:
        fail(f"phase 39 (b): gpt2_124m decode step: {bad}")
    bar = slots * cfg.num_heads * cfg.max_len
    big = sorted({(tuple(m.shape)) for n in census.nodes for m in n.outputs
                  if m.sid in n.new and m.dtype == torch.float32
                  and m.numel >= bar})
    stray = [s for s in big if s[-1] != cfg.vocab_size]
    if stray:
        fail(f"phase 39 (b): f32 tensors of >= {bar} elements besides the "
             f"logits: {stray}")
    k6 = _node_regimes(census)
    n_k6 = sum(v for k, v in k6.items() if k.startswith("paged"))
    if n_k6 != cfg.num_layers or sum(launched.values()) != cfg.num_layers:
        fail(f"phase 39 (b): K6 nodes {k6}, launches {launched}, want one "
             f"a layer ({cfg.num_layers})")
    vec = acost.census_cost(census,
                            donated=acost.donated_sids(contract, census))
    # the step writes position w of each slot and reads its w + 1 keys
    model_cost = _decode_costs(fns.cfg, view, [int(w) + 1 for w in written],
                               bs)["model"]
    out = {"counts": census.counts(), "k6_nodes": k6,
           "k6_launches": launched,
           "f32_at_or_over_bar": [list(s) for s in big],
           "collectives": reports["collectives"].observed["census"],
           "determinism": reports["determinism"].observed["hits"],
           "pool": {k: reports["donation"].observed[k] for k in
                    ("donated_leaves", "moved_leaves", "whole_copies")},
           "cost": vec.to_dict(), "model": model_cost}
    return out, launched


def check_program_audit(cfg, seed, kind) -> dict:
    """Phase 39. Returns K5's and K6's launches by regime over its runs."""
    from distributed_tensorflow_guide_tpu_torch.analysis import (
        fingerprint,
        lint,
    )

    t_phase = time.perf_counter()
    dev = resolve_device(None)
    # phase 38's online engine left online tuning on for the process: a
    # program's build would then sweep K5/K6 for its new shape, launches
    # the census (one run of the program) rightly does not hold
    was = autotune.set_online_tune(False)
    # the one-process programs; phase 40 audits the mesh programs
    names = [c.name for c in lint._registered(None) if c.world is None]
    if sorted(names) != sorted(AUDIT_PROGRAMS):
        fail(f"phase 39: registered one-process programs {names}")
    contracts = lint._registered(AUDIT_PROGRAMS)
    launches = {k: 0 for k in DA.REGIME_LAUNCHES}
    rows = {}
    for c in contracts:
        cpu = lint.lint_contract(c, "cpu")
        before = dict(DA.REGIME_LAUNCHES)
        rep = lint.lint_contract(c, dev)
        moved = {k: DA.REGIME_LAUNCHES[k] - before[k] for k in before}
        if not rep.ok or rep.census is None:
            fail(f"phase 39 (a) {c.name} on the card:\n"
                 + lint.render_text(lint.LintReport([rep])))
            continue
        census = rep.census
        coll = next(r for r in rep.rules if r.rule == "collectives")
        nodes = _node_regimes(census)
        if coll.observed["census"] or moved != nodes:
            fail(f"phase 39 (a) {c.name}: collectives "
                 f"{coll.observed['census']}, kernel nodes {nodes}, "
                 f"launches {moved}")
        for k, n in moved.items():
            launches[k] += n
        vec = rep.fingerprint.cost
        same = rep.fingerprint.structure == cpu.fingerprint.structure
        rows[c.name] = {
            **census.counts(),
            "k5_k6_nodes": {k: v for k, v in nodes.items() if v},
            "flops": vec["flops"], "hbm_bytes": vec["hbm_bytes"],
            "census_peak_live_bytes": vec["peak_live_bytes"],
            # the allocator's rise counts only what the run allocated:
            # set the census's peak beside it less the inputs it holds
            "census_peak_above_inputs": vec["peak_live_bytes"] - sum(
                st.nbytes for st in census.storages.values()
                if st.alloc == -1 and st.device == dev.type),
            "max_memory_allocated_rise": rep.device_peak_bytes,
            "structure_equals_cpu": same,
            "structure_cuda": rep.fingerprint.structure[:12],
            **({} if same else {"differs": fingerprint.census_diff(
                cpu.census, census, limit=6)}),
        }
        print(f"audit {c.name} on {kind}: {json.dumps(rows[c.name])}",
              flush=True)
    t_b = time.perf_counter()
    model = Transformer(cfg).init_weights(seed).to(dev)
    step, k6 = _audit_decode_step(cfg, model, dev, seed)
    for k, n in k6.items():
        launches[k] += n
    del model
    torch.cuda.empty_cache()
    print(f"audit gpt2_124m decode step on {kind} (8 slots, block 16, 513 "
          f"blocks): {json.dumps(step)} | s {time.perf_counter() - t_b:.1f}",
          flush=True)
    print(f"program audit on {kind}: {len(rows)} programs pass on the card, "
          f"{sum(r['structure_equals_cpu'] for r in rows.values())} with the "
          f"CPU census's structure | phase_s "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    print(f"K5/K6 launches by regime (phase 39): {json.dumps(launches)}",
          flush=True)
    autotune.set_online_tune(was)
    return launches


# ---- phase 40: the program audit's mesh programs -------------------------------

MESH_PROGRAMS = (
    "dp_train_step", "dp_overlap_train_step", "dp_overlap_int8_round",
    "fsdp_prefetch_train_step", "pipeline_fused_ce_train_step",
    "multislice_outer_on_round", "multislice_outer_off_round",
    "serve_kv_block_transfer_dcn", "moe_train_step",
    "moe_dropless_train_step",
)
MESH_WORLD = 8
AUDIT_DP_N, AUDIT_DP_B, AUDIT_DP_S = 2, 4, 1024  # ranks, sequences, tokens


def _world_view(p) -> dict:
    """A mesh program's report as phase 40 compares it: every rank's
    collective census and op count, the world-mean collective bytes, the
    bypassing ops and the allocator's peak rise over the ranks."""
    world_cost = next(r for r in p.rules if r.rule == "cost")
    return {
        "census": [r.counts()["collectives"] for r in p.ranks],
        "ops": [r.counts()["ops"] for r in p.ranks],
        "bypassing_ops": sum(
            next(x for x in r.rules if x.rule == "collectives").observed[
                "bypassing_ops"] for r in p.ranks),
        "collective_bytes_world_mean":
            world_cost.observed["collective_bytes_world_mean"],
        "max_memory_allocated_rise_max": max(
            (r.device_peak_bytes or 0) for r in p.ranks),
    }


def check_mesh_programs(kind) -> None:
    """Phase 40 (a): the 10 mesh programs in a world of 8 ranks on the
    CPU and in one on ``cuda:0``, the two worlds side by side."""
    import concurrent.futures

    from distributed_tensorflow_guide_tpu_torch.analysis import lint

    contracts = lint._registered(MESH_PROGRAMS)

    def world(device):
        t0 = time.perf_counter()
        rep = lint.run_contracts(contracts, device, world=MESH_WORLD)
        return rep, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {d: pool.submit(world, d) for d in ("cpu", "cuda:0")}
        (cpu, t_cpu), (card, t_card) = (runs[d].result()
                                        for d in ("cpu", "cuda:0"))
    if not cpu.ok:
        fail("phase 40 (a): the CPU world:\n" + lint.render_text(cpu))
    bad = []
    for c, p, q in zip(contracts, card.programs, cpu.programs):
        if not p.ok:
            bad.append(lint.render_text(lint.LintReport([p])))
            continue
        got, want = _world_view(p), _world_view(q)
        if (len(p.ranks) != MESH_WORLD or got["bypassing_ops"]
                or got["census"] != want["census"]
                or got["collective_bytes_world_mean"]
                != want["collective_bytes_world_mean"]):
            bad.append(f"{c.name}: card {got}, CPU world {want}")
        row = {"ranks": len(p.ranks), "census_rank0": got["census"][0],
               "collective_bytes_world_mean":
                   got["collective_bytes_world_mean"],
               "bypassing_ops": got["bypassing_ops"],
               "ops_rank0_cuda": got["ops"][0],
               "ops_rank0_cpu": want["ops"][0],
               "max_memory_allocated_rise_max":
                   got["max_memory_allocated_rise_max"],
               "structure_equals_cpu":
                   p.fingerprint.structure == q.fingerprint.structure}
        print(f"audit mesh {c.name} on {kind}: {json.dumps(row)}",
              flush=True)
    if bad:
        fail("phase 40 (a) on the card:\n" + "\n".join(bad))
    print(f"mesh audit on {kind}: {sum(p.ok for p in card.programs)}/"
          f"{len(contracts)} programs pass on {MESH_WORLD} ranks sharing "
          f"the card | cpu_world_s {t_cpu:.1f} card_world_s {t_card:.1f} "
          "(side by side)",
          flush=True)


def audit_dp_rank(seed: int) -> dict:
    """One rank of phase 40 (b) (started by ``run_multiprocess``)."""
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.analysis import (
        lint,
        rules,
        walker,
    )

    autotune.set_online_tune(False)
    dev = resolve_device(None)
    mesh = build_mesh(MeshSpec(data=AUDIT_DP_N))
    i = mesh.axis("data").index
    cfg = _mp_gpt2()
    model = Transformer(cfg).init_weights(seed).to(dev)
    if cfg.resolve_attn_impl(AUDIT_DP_S) != "flash":
        raise RuntimeError("attn_impl='auto' did not resolve to flash")
    tokens = np.random.RandomState(seed).randint(
        0, 50257, (AUDIT_DP_N * AUDIT_DP_B, AUDIT_DP_S)).astype(np.int64)
    share = {"tokens": torch.as_tensor(
        tokens[i * AUDIT_DP_B:(i + 1) * AUDIT_DP_B], device=dev)}
    # SGD with momentum, as the contract's fixture: Adam's step count
    # lives on the host and its update reads it back (a host sync)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-3,
                                              momentum=0.9))
    step = DataParallel(mesh, device=dev).make_train_step(
        make_lm_loss_fn(model))
    [base] = lint._registered(("dp_train_step",))
    contract = dataclasses.replace(base, name="gpt2_124m_dp_train_step",
                                   policy="bf16", cost=None, world=None)
    FA.reset_launch_counts()
    dist.barrier()
    torch.cuda.synchronize()
    (_, mets), census = walker.record(step, (state, share), device=dev)
    torch.cuda.synchronize()
    launched = {n: FA.LAUNCHES[n] for n in K1_K3}
    traced = rules.TracedProgram(contract.name, census)
    reports = {r.rule: r for r in (rule(traced, contract)
                                   for rule in rules.ALL_RULES)}
    nodes = {n: sum(1 for x in census.nodes if x.kind == "kernel"
                    and x.name == n) for n in K1_K3}
    return {"rank": dist.get_rank(), "backend": dist.get_backend(),
            "device": str(dev),
            "gated_findings": {k: [f.message for f in reports[k].findings]
                               for k in ("collectives", "donation",
                                         "determinism")
                               if not reports[k].ok},
            "counts": census.counts(),
            "collectives": reports["collectives"].observed,
            "donation": {k: reports["donation"].observed.get(k) for k in
                         ("donated_leaves", "moved_leaves")},
            "determinism": reports["determinism"].observed["hits"],
            "precision": reports["precision"].observed,
            "precision_findings": sorted({f.message for f in reports[
                "precision"].findings}),
            "memory": reports["memory"].observed,
            "collective_bytes": traced.cost_vector.collective_bytes,
            "flops": traced.cost_vector.flops,
            "grad_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
            "kernel_nodes": nodes, "launches": launched,
            "loss": float(mets["loss"])}


def check_mesh_dp_gpt2(seed, kind) -> dict:
    """Phase 40 (b). Returns the ranks' K1-K3 launches, summed."""
    from distributed_tensorflow_guide_tpu_torch.analysis import cost

    t0 = time.perf_counter()
    res = [r.result for r in run_multiprocess(
        "chip_smoke:audit_dp_rank", AUDIT_DP_N, [seed], timeout=900)]
    layers = MP_LAYERS
    want_nodes = dict.fromkeys(K1_K3, layers)
    G = res[0]["grad_bytes"]
    ar = cost.dp_allreduce_bytes
    want_bytes = ar(G, AUDIT_DP_N) + 2 * ar(4, AUDIT_DP_N)
    mean = sum(r["collective_bytes"].get("psum[data]", 0.0)
               for r in res) / AUDIT_DP_N
    for r in res:
        if r["gated_findings"]:
            fail(f"phase 40 (b) rank {r['rank']}: {r['gated_findings']}")
        if r["collectives"] != {"census": {"psum[data]": 2},
                                "bypassing_ops": 0}:
            fail(f"phase 40 (b) rank {r['rank']}: collectives "
                 f"{r['collectives']}")
        if r["kernel_nodes"] != want_nodes or r["launches"] != want_nodes:
            fail(f"phase 40 (b) rank {r['rank']}: K1-K3 nodes "
                 f"{r['kernel_nodes']}, launches {r['launches']}, want "
                 f"{layers} each")
    if mean != want_bytes:
        fail(f"phase 40 (b): psum[data] world mean {mean}, closed form "
             f"{want_bytes}")
    # the loss is the pmean over the ranks: one number, at random init
    # within the margin of ln(V)
    losses = {r["loss"] for r in res}
    if len(losses) != 1 or abs(res[0]["loss"] - LN_VOCAB) > LOSS0_MARGIN:
        fail(f"phase 40 (b): losses {sorted(losses)}, want one within "
             f"{LOSS0_MARGIN} of ln(50304) = {LN_VOCAB}")
    print(f"audit gpt2_124m dp train step on {kind} ({AUDIT_DP_N} ranks "
          f"sharing the card over {res[0]['backend']}, B={AUDIT_DP_B} a "
          f"rank, S={AUDIT_DP_S}): " + json.dumps(
              {"psum_data_world_mean": mean, "closed_form": want_bytes,
               "grad_bytes": G, "loss": res[0]["loss"],
               **{k: [r[k] for r in res] for k in (
                   "counts", "kernel_nodes", "launches", "donation",
                   "determinism", "flops", "precision", "memory")},
               "precision_findings": res[0]["precision_findings"]})
          + f" | s {time.perf_counter() - t0:.1f}", flush=True)
    return {n: sum(r["launches"][n] for r in res) for n in K1_K3}


# ---- phase 41: the example family -------------------------------------------

EX_PKG = "distributed_tensorflow_guide_tpu_torch.examples"
EX_RANKS = 4  # scripts 7, 9 and 10: ranks sharing the card over gloo
# script 10's bound against dense attention, the JAX example's (f32)
SP_MAX_ERR = 2e-4
# GPT-2 124M widths at a cut depth, trained at S=1024 (scripts 11 and 12)
EX_LM = ["--layers", "2", "--d-model", "768", "--heads", "12", "--seq-len",
         "1024", "--global-batch", "8", "--bpe-vocab", "384"]
# the first prompt tokenizes to 12 tokens: the one-shot's prefill takes the
# chunk regime, as the engine's 128-row chunk does (the bitwise check)
EX_PROMPTS = ("the quick brown fox jumps over the lazy dog. pack my box|"
              "how vexingly quick|the lazy dog|pack my box with five dozen")


def _example_runs(root: str) -> list:
    """(label, script, argv, ranks, kernels, success lines) of phase 41;
    ``root`` holds the corpus, the IDX files and the TSV."""
    corpus, idx, tsv = (os.path.join(root, n)
                        for n in ("corpus.txt", "mnist", "demo.tsv"))
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    return [
        ("non_distributed", "non_distributed",
         ["--steps", "20", "--log-every", "0"], 1, (),
         ("platform: cuda", "done: 20 steps")),
        ("mnist_sync_dp", "mnist_sync_dp",
         ["--steps", "20", "--eval-batches", "2", "--log-every", "0",
          "--data", idx], 1, (),
         ("native loader: 2048 records", "done: 20 steps",
          "held-out accuracy")),
        ("async_ps_family/downpour", "async_ps_family",
         ["--algo", "downpour", "--steps", "16"], 1, (),
         ("done: algo=downpour",)),
        ("async_ps_family/emulate-adag", "async_ps_family",
         ["--algo", "emulate-adag", "--steps", "16"], 1, (),
         ("adag emulation: loss",)),
        ("wide_deep_recommender", "wide_deep_recommender",
         ["--steps", "20", "--log-every", "0"], 1, (), ("done: 20 steps",)),
        ("native_data_pipeline", "native_data_pipeline",
         ["--steps", "20", "--steps-per-call", "4"], 1, (),
         ("loader: NativeRecordLoader", "examples/sec/process end-to-end")),
        ("resnet_imagenet_dp", "resnet_imagenet_dp",
         ["--steps", "2", "--eval-batches", "1", "--log-every", "0"], 1, (),
         ("done: 2 steps (resnet50, 224px)", "held-out accuracy")),
        ("bert_tensor_parallel", "bert_tensor_parallel",
         ["--model-parallel", "4", "--layers", "2", "--steps", "4",
          "--make-demo-data", "1024", "--data", tsv, "--bpe-vocab", "300"],
         EX_RANKS, (), ("trained BPE vocab", "held-out: ", "done: ")),
        ("fsdp_zero3", "fsdp_zero3",
         ["--steps", "20", "--fused-ce", "on", "--fsdp-prefetch", "on"], 1,
         (), ("local shard = 1.000", "done: loss")),
        ("gpt2_pipeline", "gpt2_pipeline",
         ["--full-gpt2", "--pipe", "4", "--steps", "2", "--microbatches",
          "4", "--microbatch-size", "1", "--data", corpus, "--bpe-vocab",
          "300", "--generate", "the quick brown", "--max-new", "8"],
         EX_RANKS, flash + ("decode_attention",),
         ("trained BPE vocab", "native loader: ", "done: ",
          "generated: ")),
        ("long_context_sp", "long_context_sp",
         ["--impl", "both", "--seq-len", "4096"], EX_RANKS,
         ("flash_carry",),
         ("ring attention: ", "ulysses: ", "long-context SP ok")),
        ("gpt2_generate", "gpt2_generate",
         [*EX_LM, "--steps", "6", "--data", corpus, "--max-new", "16"], 1,
         flash + ("decode_attention",), ("output : ", "generate ok")),
        ("gpt2_generate/int8-spec", "gpt2_generate",
         [*EX_LM, "--steps", "0", "--data", corpus, "--max-new", "16",
          "--precision", "bf16", "--kv-dtype", "int8",
          "--spec-draft-layers", "1"], 1, ("decode_attention",),
         ("speculative: ", "generate ok")),
        ("gpt2_serve", "gpt2_serve",
         [*EX_LM, "--steps", "4", "--data", corpus, "--precision", "bf16",
          "--slots", "4", "--block-size", "16", "--num-blocks", "257",
          "--prefill-chunk", "128", "--max-new", "16", "--prefix-cache",
          "--prompts", EX_PROMPTS], 1,
         flash + ("paged_decode_attention.split",
                  "paged_decode_attention.chunk"),
         ("engine == one-shot for req 0: ok", "serve ok")),
        ("moe_expert_parallel", "moe_expert_parallel", ["--steps", "10"], 1,
         (), ("experts sharded 1-way over 1 devices",)),
        ("switch_moe_lm", "switch_moe_lm",
         ["--expert", "1", "--steps", "10"], 1, (), ("switch-moe ok",)),
    ]


def _example_inputs(root: str, seed: int) -> None:
    """Phase 41's files: the demo corpus six times over (16 records of 1024
    tokens at vocab 384) and MNIST IDX files of 2048 and 512 images drawn
    from the synthetic task; the BERT script writes its own TSV."""
    from distributed_tensorflow_guide_tpu_torch.examples.gpt2_generate import (
        DEMO_CORPUS,
    )

    with open(os.path.join(root, "corpus.txt"), "w") as fh:
        fh.write(DEMO_CORPUS * 6)
    idx = os.path.join(root, "mnist")
    os.makedirs(idx)
    for split, n, sample in (("train", 2048, seed + 1), ("t10k", 512,
                                                          seed + 2)):
        b = synthetic.synthetic_mnist(n, seed=seed,
                                      sample_seed=sample).take(1)[0]
        pixels = np.clip(b["image"][..., 0] * 64 + 128, 0, 255)
        write_idx(os.path.join(idx, f"{split}-images-idx3-ubyte"),
                  pixels.astype(np.uint8))
        write_idx(os.path.join(idx, f"{split}-labels-idx1-ubyte"),
                  b["label"].astype(np.uint8))


def _example_body(script: str, argv: list) -> tuple:
    """One script's body on this rank's card: (summary, stdout, wall s)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"{EX_PKG}.{script}")
    args = mod.parser().parse_args(argv)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = mod.run(args)
    if torch.cuda.is_available():  # a CPU rehearsal has no card
        torch.cuda.synchronize()
    return summary, out.getvalue(), time.perf_counter() - t0


def examples_rank(runs: list) -> dict:
    """One rank of phase 41's multi-rank scripts (started by
    ``run_multiprocess``): each body in turn, in one world, so the ranks
    start once. Its summary (the body's own launch counts), stdout and
    wall seconds, by label."""
    out = {}
    for label, script, argv in runs:
        summary, text, wall = _example_body(script, argv)
        out[label] = {"summary": summary, "stdout": text, "wall_s": wall}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _example_in_process(script: str, argv: list) -> tuple:
    """One script's body on ``cuda:0`` in this process, the launch counts
    zeroed just before it: (summary, stdout, wall s, launches)."""
    FA.reset_launch_counts()
    DA.reset_launch_counts()
    summary, text, wall = _example_body(script, argv)
    launches = {k: v for k, v in {**FA.LAUNCHES,
                                  **DA.REGIME_LAUNCHES}.items() if v}
    return summary, text, wall, launches


def _example_ranks(runs: list) -> dict:
    """The multi-rank scripts' bodies in ``EX_RANKS`` fresh rank
    processes sharing the card, one after another: by label, (rank 0's
    summary, rank 0's stdout, rank 0's wall s, launches summed over the
    ranks)."""
    results = run_multiprocess(
        "chip_smoke:examples_rank", EX_RANKS,
        [[[label, script, argv] for label, script, argv in runs]],
        timeout=900)
    out = {}
    for label, _, _ in runs:
        launches: dict = {}
        for r in results:
            for k, v in r.result[label]["summary"]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        first = results[0].result[label]
        out[label] = (first["summary"], first["stdout"], first["wall_s"],
                      launches)
    return out


def _launched(launches: dict, kernel: str) -> int:
    if kernel in ("decode_attention", "paged_decode_attention"):
        return sum(launches.get(f"{kernel}.{r}", 0)
                   for r in ("split", "chunk"))
    return launches.get(kernel, 0)


def check_examples(seed: int, kind: str) -> dict:
    """Phase 41. Returns the launches of K1-K6 (by name and regime) summed
    over the scripts."""
    import traceback

    # online tuning off, as a user's process has it (phase 38 turned it on
    # for the process): a sweep would launch K5 / K6 candidates inside a
    # script's run
    was = autotune.set_online_tune(False)
    root = tempfile.mkdtemp(prefix="dtg_examples_")
    _example_inputs(root, seed)
    runs = [(label, script, [*argv, "--device", "cuda"], ranks, kernels,
             lines) for label, script, argv, ranks, kernels, lines
            in _example_runs(root)]
    results, failures = {}, []
    try:
        for label, script, argv, ranks, _, _ in runs:
            if ranks > 1:
                continue
            try:
                results[label] = _example_in_process(script, argv)
            except (Exception, SystemExit) as e:  # the phase fails below
                failures.append(f"{label}: raised {e!r}")
                print(f"phase 41 {label}: argv={argv} raised:", flush=True)
                traceback.print_exc()
            finally:
                gc.collect()
                torch.cuda.empty_cache()
        multi = [(label, script, argv)
                 for label, script, argv, ranks, _, _ in runs if ranks > 1]
        t0 = time.perf_counter()
        try:
            results.update(_example_ranks(multi))
        except Exception as e:  # the phase fails below
            failures.append(f"{[m[0] for m in multi]}: raised {e!r}")
            traceback.print_exc()
        print(f"phase 41: the {EX_RANKS}-rank job "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        autotune.set_online_tune(was)
    total: dict = {}
    for label, script, argv, ranks, kernels, lines in runs:
        if label not in results:
            continue
        summary, out, wall, launches = results[label]
        missing = [ln for ln in lines if ln not in out]
        idle = [k for k in kernels if not _launched(launches, k)]
        rates = {k: v for k, v in summary.items()
                 if k.endswith("_per_s") or k.endswith("_s")}
        errs = {n: r["max_err"]
                for n, r in summary.get("results", {}).items()}
        print(f"phase 41 {label} on {kind}: " + json.dumps({
            "argv": argv, "ranks": ranks, "wall_s": wall,
            "done": summary.get("done"), "rates": rates, "max_err": errs,
            "launches": launches, "missing_lines": missing,
            "idle_kernels": idle}), flush=True)
        if script == "long_context_sp" and not (
                len(errs) == 2 and max(errs.values()) < SP_MAX_ERR):
            failures.append(f"{label}: max errors {errs} (bound "
                            f"{SP_MAX_ERR})")
        if missing:
            failures.append(f"{label}: lacks {missing}")
        if idle:
            failures.append(f"{label}: launched none of {idle}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    try:
        entry_launches = check_entry(kind)
        for k, v in entry_launches.items():
            total[k] = total.get(k, 0) + v
    except Exception as e:  # the phase fails below
        failures.append(f"entry(): raised {e!r}")
        traceback.print_exc()
    if failures:
        fail("phase 41: " + "; ".join(failures))
    return total


def check_entry(kind: str) -> dict:
    """Phase 41's ``graft_entry.entry()``: its forward once on the card,
    the counts zeroed just before it. Returns its K1-K6 launches."""
    from distributed_tensorflow_guide_tpu_torch import graft_entry

    forward, (model, tokens) = graft_entry.entry()
    FA.reset_launch_counts()
    DA.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = forward(model, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in {**FA.LAUNCHES,
                                  **DA.REGIME_LAUNCHES}.items() if v}
    shape = (*tokens.shape, model.cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    print(f"phase 41 entry() on {kind}: " + json.dumps({
        "shape": list(logits.shape), "dtype": str(logits.dtype),
        "finite": finite, "forward_s": wall, "launches": launches}),
        flush=True)
    if (tuple(logits.shape) != shape or logits.dtype != torch.float32
            or not finite
            or launches != {"flash_fwd": model.cfg.num_layers}):
        raise ValueError(f"entry(): logits {tuple(logits.shape)} "
                         f"{logits.dtype} finite={finite}, launches "
                         f"{launches} (want flash_fwd "
                         f"{model.cfg.num_layers})")
    del model, logits
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} | nvidia-smi: {smi}", flush=True)
    last = [t_start]

    def lap(what: str) -> None:
        """The seconds since the last lap, for the phases' time budget."""
        now = time.perf_counter()
        print(f"time: {what} {now - last[0]:.1f} s (at {now - t_start:.1f} "
              "s)", flush=True)
        last[0] = now
    # a fresh tuning table, online tuning off: a table an earlier run left
    # in this machine's home must not change what phases 1-37 run
    tune_dir = tempfile.mkdtemp(prefix="dtg_autotune_")
    os.environ["DTG_AUTOTUNE_TABLE"] = os.path.join(tune_dir, "table.json")
    os.environ.pop("DTG_ONLINE_TUNE", None)
    autotune.reset()
    print(f"autotune table: {autotune.table_path()} (fresh; "
          f"DTG_ONLINE_TUNE cleared)", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib, label in (("flash_attention", "Hopper flash kernels"),
                       ("decode_attention", "decode kernels")):
        usage, warnings = _build.ptxas_usage(lib)
        print(f"ptxas (registers, spill bytes) of the {label}: "
              + json.dumps({_kernel_name(k): v for k, v in usage.items()
                            if "_sm90" in k or "decode_" in k}
                           | {"warnings": warnings}), flush=True)

    lap("build (phase 2)")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    results = []
    check_k5(results, gen)
    check_k5_device_index(gen)
    check_k6(results, gen, rng, args.seed)
    check_regime_threshold(gen)
    lap("phase 3")
    cfg = gpt2_124m(dtype=torch.bfloat16)
    model = Transformer(cfg).init_weights(args.seed).to("cuda")
    check_sampler(gen, args.seed)
    by_regime = {"paged_decode_attention": check_engine(cfg, model, rng,
                                                        kind, args.seed)}
    lap("phase 4")
    by_regime["decode_attention"] = check_one_shot(cfg, model, rng, kind,
                                                   args.seed)
    lap("phase 5")
    # phases 22-23 (speculative decoding, the multi-LoRA engine) run on
    # this model here, before training; their launches join K5's and K6's
    for name, counts in (
            ("decode_attention", check_speculative(cfg, model, args.seed,
                                                   kind)),
            ("paged_decode_attention", check_lora_engine(
                cfg, model, args.seed, kind))):
        for regime, n in counts.items():
            by_regime[name][regime] += n
    lap("phases 22-23")
    # phases 25 (quantised serving) and 27 (MoE serving, against this
    # model's engine) on this model too; phase 36 reads 27's census
    keep = {}
    for phase in (check_quantised_serving,
                  functools.partial(check_moe_serving, keep=keep)):
        for name, counts in phase(cfg, model, args.seed, kind).items():
            for regime, n in counts.items():
                by_regime[name][regime] += n
    lap("phases 25, 27")
    launches = {f"{name}.{regime}": n for name, counts in by_regime.items()
                for regime, n in counts.items()}
    del model
    torch.cuda.empty_cache()
    flash_ms = check_flash(results, gen)
    lap("phase 6")
    phase7, step7_ms = check_training(cfg, rng, args.seed, kind, flash_ms)
    launches.update(phase7)
    lap("phase 7")
    torch.cuda.empty_cache()
    # phases 24, 26 and 28: the captured k-step step, quantised training,
    # the Switch LM
    for more in (check_captured_training(cfg, rng, args.seed, kind,
                                         step7_ms),
                 check_quantised_training(cfg, args.seed, kind),
                 check_switch_training(args.seed, kind)):
        for n, c in more.items():
            launches[n] += c
    lap("phases 24, 26, 28")
    torch.cuda.empty_cache()
    check_carry(results, gen)
    launches["flash_carry"] = check_sp(kind, args.seed)
    lap("phases 8-9")
    check_dp(kind, args.seed)
    lap("phase 10")
    resnet_images_s = check_resnet50(args.seed, kind)
    lap("phase 11")
    torch.cuda.empty_cache()
    check_mnist(args.seed, kind)
    check_wide_deep(args.seed, kind)
    check_bert(args.seed, kind)
    lap("phases 12-14")
    torch.cuda.empty_cache()
    check_pipeline(args.seed, kind)
    lap("phase 15")
    torch.cuda.empty_cache()
    check_pipeline_ranks(args.seed, kind)
    lap("phase 16")
    check_bert_tp(args.seed, kind)
    lap("phase 17")
    torch.cuda.empty_cache()
    check_fsdp(args.seed, kind)
    lap("phase 18")
    check_dp_overlap(args.seed, kind)
    lap("phase 19")
    check_sp_tp(args.seed, kind)
    lap("phase 20")
    check_async_ps(args.seed, kind)
    lap("phase 21")
    for n, c in check_expert_parallel(args.seed, kind).items():
        launches[n] += c
    lap("phase 29")
    # phases 30-33: supervised training with checkpoints, engine
    # snapshots, preemption, the elastic world; their K1-K3 and K6
    # launches join the line
    torch.cuda.empty_cache()
    t_resil = time.perf_counter()
    resil_cfg = dataclasses.replace(cfg, num_layers=RESIL_LAYERS)
    for n, c in check_supervised_training(resil_cfg, args.seed,
                                          kind).items():
        launches[n] += c
    lap("phase 30")
    torch.cuda.empty_cache()
    model = Transformer(cfg).init_weights(args.seed).to("cuda")
    for regime, n in check_engine_snapshots(cfg, model, args.seed,
                                            kind).items():
        launches[f"paged_decode_attention.{regime}"] += n
    lap("phase 31")
    del model
    torch.cuda.empty_cache()
    for n, c in check_preemption(resil_cfg, args.seed, kind).items():
        launches[n] += c
    lap("phase 32")
    check_elastic_world(args.seed, kind)
    lap("phase 33")
    print(f"phases 30-33: {time.perf_counter() - t_resil:.1f} s", flush=True)
    # phases 34-36: the spill tier and the warm restart, the fleet, the
    # metrics plane; their K6 and K1-K3 launches join the line
    t_fleet = time.perf_counter()
    torch.cuda.empty_cache()
    model = Transformer(cfg).init_weights(args.seed).to("cuda")
    for phase in (check_spill_tier, check_fleet):
        for regime, n in phase(cfg, model, args.seed, kind, keep).items():
            launches[f"paged_decode_attention.{regime}"] += n
    del model
    torch.cuda.empty_cache()
    for n, c in check_metrics_plane(cfg, args.seed, kind, keep).items():
        launches[n] += c
    print(f"phases 34-36: {time.perf_counter() - t_fleet:.1f} s",
          flush=True)
    lap("phases 34-36")
    # phase 37: the data plane; its record-fed K1-K3 launches join the line
    torch.cuda.empty_cache()
    for n, c in check_data_plane(cfg, args.seed, kind, step7_ms,
                                 resnet_images_s).items():
        launches[n] += c
    lap("phase 37")
    # phase 38: the tuning table; its online engine's K6 launches join
    torch.cuda.empty_cache()
    for regime, n in check_autotune(cfg, args.seed, kind, smi).items():
        launches[f"paged_decode_attention.{regime}"] += n
    shutil.rmtree(tune_dir, ignore_errors=True)
    lap("phase 38")
    # phase 39: the program audit; its K5 and K6 launches join the line
    torch.cuda.empty_cache()
    for n, c in check_program_audit(cfg, args.seed, kind).items():
        launches[n] += c
    lap("phase 39")
    # phase 40: the mesh programs; the GPT-2 DP step's K1-K3 launches join
    torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    check_mesh_programs(kind)
    for n, c in check_mesh_dp_gpt2(args.seed, kind).items():
        launches[n] += c
    print(f"phase 40: {time.perf_counter() - t_mesh:.1f} s", flush=True)
    lap("phase 40")
    # phase 41: the example family; its K1-K6 launches join the line
    torch.cuda.empty_cache()
    t_ex = time.perf_counter()
    for n, c in check_examples(args.seed, kind).items():
        launches[n] += c
    print(f"phase 41: {time.perf_counter() - t_ex:.1f} s", flush=True)
    lap("phase 41")

    def head(name, pick, regime=None):
        rows = [r for r in results if r["kernel"] == name
                and regime in (None, r.get("regime"))]
        r = next(r for r in rows if pick(r))
        return {"ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "max_abs_err": max(x["max_abs_err"] for x in rows)}

    # K5 and K6 one entry a regime, each at its main-path shape: the
    # decode step (C=1) and the prefill chunk (K5: the one-shot's prompt;
    # K6: the engine's chunk)
    decode_picks = {
        ("decode_attention", "split"): lambda r: (
            r["C"] == 1 and r["B"] == 8 and r["length"] == r["S"]),
        ("decode_attention", "chunk"): lambda r: (
            r["C"] == 512 and r["B"] == 4),
        ("paged_decode_attention", "split"): lambda r: (
            r["C"] == 1 and r["B"] == 8),
        ("paged_decode_attention", "chunk"): lambda r: (
            r["C"] == 128 and r["B"] == 1),
    }
    kernels = [
        {"name": f"{name}.{regime}", "route": "cuda",
         "source": DA.KERNEL_SOURCE,
         "replaces": K5_REPLACES if name == "decode_attention"
         else K6_REPLACES,
         "launches": launches[f"{name}.{regime}"],
         **head(name, lambda r, pick=pick: r["cache"] == "bf16" and pick(r),
                regime)}
        for (name, regime), pick in decode_picks.items()
    ] + [
        {"name": name, "route": "cuda", "source": FA.KERNEL_SOURCE,
         "replaces": FLASH_REPLACES[name], "launches": launches[name],
         **head(name, lambda r: r["S"] == 1024 and r["hd"] == 64
                and r["causal"] and r["dtype"] == "bf16")}
        for name in K1_K3
    ] + [
        {"name": "flash_carry", "route": "cuda", "source": FA.KERNEL_SOURCE,
         "replaces": FLASH_REPLACES["flash_carry"],
         "launches": launches["flash_carry"],
         **head("flash_carry", lambda r: not r["diag"])},
    ]
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
