#!/usr/bin/env python3
"""Drive the PyTorch port's DLRM serving and training paths (one rank, and
the hybrid step and the run loop on meshes of ranks) and its LM serving and
training paths (the five LM archs, dense, MoE and MLA) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which fails the run:

1. build: compile every kernel of ``src/repro_torch/csrc/`` (one ``nvcc``
   each, all at once) and print what ``ptxas`` reports; the two
   warp-specialised TMA + wgmma kernels (flash attention, fused_mlp's wgmma
   route) must not spill;
2. kernels: call each serving kernel's wrapper at dlrm-small's shapes, at
   the config's batch (8192) and at every serving bucket (8, 32, 128), hold
   the result against the kernel's plain PyTorch version on the same inputs
   on the card (each fused_mlp layer names its route, wgmma or mma.sync),
   and, at 8192, time kernel, plain version and a PyTorch
   library call that computes the same function (a yardstick the port never
   calls); the bag and the interaction are timed at every batch, as the
   device time of a CUDA graph of 20 launches (their wrappers take longer on
   the host than their kernels on the card), and so are their library
   calls; the bag also on uniform indices, whose rows are nearly all
   distinct, and weighted (weights U[0.5, 1.5), its library call
   ``F.embedding_bag(per_sample_weights=...)``), all-ones weights bit for
   bit the unweighted bag; the fused bag stage (offset add, bag and bf16
   round in one launch) on zipf, uniform and weighted ids bit for bit the
   kernel's own bag rounded to bf16, and each sum within one bf16 ulp of
   the plain composition (or, where a sum cancels to near zero, within the
   bag's atol), the share of sums that differ printed;
3. serving: dlrm-small at full size (8 tables x 1,000,000 rows x 64, bf16-hi,
   pooling 50; random weights from a seeded ``torch.Generator``) published to
   a ``SnapshotRegistry`` and served by a ``ContinuousBatchingServer`` on
   buckets (8, 32, 128): 1024 requests with zipf(1.05) indices, in bursts
   that reach every bucket.  Every score must be finite and in (0, 1), and
   its logit must match the plain-version forward's on the card; every
   serving kernel must have been launched, fused_mlp 8 times a batch, 6 of
   them (every layer whose K and N are multiples of 8) on the wgmma route;
4. breakdown: per bucket, the host's padding, the score fn's wall time and
   the device's busy time in it (torch.profiler);
5. row kernels: the fused row update (split store and fp32 store) and the
   flat Split-SGD step, bit for bit against their plain versions at
   dlrm-small's shapes (the training stream's first zipf batch and a uniform
   one; the dense update's 3,811,396 values), timed, with the byte bound and
   the serial-chain floor of the longest run, row 6 also against
   ``index_add_``; every row kernel's launch lists its runs of ``long_run()``
   lookups or more on the card, and that count must match the host's; the
   Split-SGD step timed as a CUDA graph, warm and with the L2 flushed
   before each launch (a 64 MiB write: its 30.5 MB of buffers fit the
   50 MB L2);
6. training: dlrm-small at full size (the 2.05 GB split store), batch 8192,
   lr 0.1, ``make_train_step`` over 20 staged zipf batches: every loss
   finite, one launch a step of the bag, interaction, row-update and
   Split-SGD kernels and none of fused_mlp, one step held to the same step
   on the CPU (every kernel's plain version), one step under
   ``torch.cuda.set_sync_debug_mode("error")``, samples per second, each
   stage's time and the device's busy share (torch.profiler); the bag
   stage alone under the profiler must be one launch of the bag kernel and
   nothing else;
7. sgd: 3 steps with the fp32 store (``sparse_optimizer="sgd"``), which runs
   the fp32 row-update kernel;
8. stateful row kernels: the six fused row updates of the stateful
   optimizers (momentum, Adagrad, row-wise Adagrad, frequency-adaptive, and
   momentum and Adagrad with a bf16 state rounded stochastically), bit for
   bit against their plain versions on the weights and on the state, at
   dlrm-small's shapes on the zipf and the uniform stream, timed, with the
   byte bound and the longest run's serial chain; the two bf16 kinds again
   at a second seed, which must change the state and not the weights;
9. weighted and fp32-dY row kernels: all eight row updates bit for bit
   against their plain versions on the zipf stream with weights
   U[0.5, 1.5), zero on one table, and on the unweighted zipf stream with an
   fp32 cotangent, timed beside the bound and the longest run's chain;
10. row-wise Adagrad training: phase 6 again with
    ``sparse_optimizer="adagrad_rowwise"`` (the fp32 table and one
    accumulator a row) at lr 0.01;
11. momentum, Adagrad, frequency-adaptive, bf16 Adagrad (lr 0.01): 3 steps
    each, every loss finite and the optimizer's row kernel launched once a
    step;
12. weighted momentum_bf16 training: phase 6 again with
    ``sparse_optimizer="momentum_bf16"`` and ``weighted=True`` (the fp32
    table, the bf16 momentum, weights U[0.5, 1.5) in every batch), the
    stochastic rounding's seed ``sr`` advancing by one a step on the card;
13. run loop: dlrm-small (Split-SGD) through ``TrainLoop``: 40 steps from a
    seeded state without a checkpoint, and the quickstart's contract cut to
    half its depth from the same state (30 steps, a verified checkpoint
    every 15, keep 2, prefetch 2, a heartbeat; a second loop, built on a
    state from another seed, restores at step 30 and trains on to 40), both
    over one pool of 20 numpy batches:
    the restore bit for bit the first loop's state with its dense ``hi`` in
    one buffer, the later losses and the final state bit for bit the
    uninterrupted run's; the newest checkpoint corrupted, a fresh manager
    falls back to step 30; the eval step's scores of the restored state in
    (0, 1), their logits within 3e-3 of the plain forward on the CPU; the
    loop's samples per second and step-time percentiles beside the bare
    step's, each save's host copy and write, the restore's time;
14. attention kernel: the flash-attention kernel against its plain version
    on the card at internlm2-1.8b's prefill shape (4 x 4096 tokens, 16
    heads on 8 KV heads, causal), gemma2's local (window 4096, softcap 50)
    and global layers at 8192 tokens (the global one also without the
    softcap), ragged, right-aligned, non-causal and blind queries, timed beside its bound, its plain version and (at
    the first shape) ``F.scaled_dot_product_attention``;
15. LM serving: internlm2-1.8b at full size (1.89 B parameters, bf16 from a
    seeded ``torch.Generator``), ``attn_impl="pallas"``: 4 prompts of 4096
    tokens through ``make_prefill_step`` (one kernel launch a layer), 32
    greedy steps through ``make_decode_step`` (none), every logit finite,
    the prefill's logits and cache held to the same prefill with the plain
    attention, two faults planted in the plain attention (a wrong KV head, the
    diagonal masked) rejected by both gates, and the first decode step's
    logits held to a prefill of 4097 tokens; time to first
    token, tokens/s, ms a decode step, the device's busy time, and one
    prefill of 32,768 tokens (:func:`lm_phase`, which phases 25-28 share);
16. hybrid: dlrm-small at full width on the hybrid step of
    ``torch.distributed`` meshes.  16a: table mode (Split-SGD; the store's
    8,000,008 rows, one spare ``row_pad``) on a (1, 1) mesh over an NCCL
    process group of one rank, whose collectives run through NCCL: the
    first step held to the same step on the CPU (the loss and the dense
    weights within phase 6's tolerances, the sparse update bit for bit the
    plain update of the card's own fp32 cotangent, the bags unrounded), one
    step under ``set_sync_debug_mode("error")``, 20 timed steps with one
    launch a step of the bag, interaction, row-update and Split-SGD
    kernels, the busy time under torch.profiler; then row mode on that mesh
    bit for bit (losses and state) the groupless step of phase 6.  16b: two
    processes sharing the card (gloo, every payload staged through pinned
    host memory; the two ranks of a ``launch.local.RankPool`` that starts
    with 16a and serves 16b, 17a, 18d and 23a, another serving 33e and 35,
    :func:`two_ranks`), meshes (1, 2) in row and
    table mode with Split-SGD and in row mode with row-wise Adagrad: each
    rank's first step held to the same two-rank step on the CPU (loss within
    1e-4, the dense shard (and row mode's Split-SGD shard) within 1e-2 of the
    largest update, the sparse update bit for bit), then 3 steps with
    finite losses, their launches (the Split-SGD kernel once a bucket), each
    collective's bytes a step, and the step's host-clock time with the
    staging copies and the gloo calls apart (not a training rate: one card
    does both ranks' work).  A child's failure fails the run;
17. the run loop on a mesh, ranks sharing the card over gloo (the kernels
    built once, in this process, before any rank starts).  17a: dlrm-small
    at full width (Split-SGD, row mode) on a (1, 2) mesh through
    ``TrainLoop`` (prefetch 2; the loop cuts each global batch to the rank's
    block): 10 steps without a checkpoint; 5 with a checkpoint at 5 (the
    2.06 GB of global arrays that every rank gathers and rank 0 writes); a
    second loop, on a state from another seed, that restores step 5 and
    runs to 10.  Gates: the restarted losses and state bit for bit the
    uninterrupted run's; the step-10 checkpoint's CRC32s those of the
    uninterrupted run's gathered state; restored onto a (1, 1) mesh in this
    process (``weights.reshard_global``), placed on the card and gathered
    back bit for bit; one step of it finite; one launch a step of the bag,
    interaction and row-update kernels and four of Split-SGD's.  Prints the
    gathers' ms, the writes' s, each rank's restore s and step ms p50/p99.
    17b: the quickstart's contract on (2, 4) at half its depth, eight
    processes: 40 steps without a checkpoint, 30 with a checkpoint every 15
    and a restart that runs on to 40.  Gates: restored at 30; the losses and
    the state at 40 bit for bit the uninterrupted run's; the loss falls (the
    mean loss over the 40 batches trained on, of the final state against the start state:
    the quickstart's labels are coin flips, so the loss of a fresh batch
    has nothing to fall to); the eval step's scores finite and in (0, 1);
    the launches.  Prints each rank's step ms p50/p99 (a code path on one
    card, not a training rate) and the card's memory in use.  17c: the
    elastic restart: the elastic configuration 10 steps on (2, 4), saved;
    four processes on (1, 4) restore it, lay it out for four shards and
    train 10 more.  Gates: finite losses, the restored shards gathered back
    bit for bit the resharded arrays, the launches.  Any rank's failure
    fails the run;
18. the rest of the train step's exchange surface, dlrm-small at full
    width.  18a: groupless row mode (Split-SGD): for each of the 20 staged
    batches ``data.pipeline.presort_batch``'s fields on the host bit for
    bit the card's sort (``_row_sorted_streams``); 20 ``host_presort``
    steps (no host sync) bit for bit, losses and state, the device-sorted
    steps from the same start, one launch a step of rows 1, 2, 4 and 5 and
    no sort kernel under torch.profiler (the device-sorted step shows one);
    ``TrainLoop`` over ``HostPipeline(presort=True)``, prefetch 2, 20 steps,
    printing the pre-sort's ms a batch on the host, the loop's step p50 /
    p99 and the prefetch wait; then table mode on a one-rank NCCL mesh, 5
    presorted steps bit for bit the device-sorted ones.  18b: table mode
    there on the ``bf16`` wire with the error feedback and on ``bf16_sr``:
    the first step held to the CPU step (phase 6's tolerances; the
    cotangent's exchange, the dither included, bit for bit the CPU's of the
    card's cotangent), 10 finite steps, each collective's bytes a step
    against the ``fp32`` wire's (the all-to-alls 3/4, the dense
    reduce-scatter 1/2), the busy time.  18c: groupless row mode at M = 2
    and 4: the first step held to the CPU M-step, 10 steps with rows 1 and
    2 launched M times a step and rows 4 and 5 once, the busy time against
    M = 1's.  18d: two processes on the card over gloo, (1, 2), row mode,
    the batch-sharded stream: 4 steps (one a warm-up) with the ``ring``
    index exchange bit for bit the ``fused`` one's, then ``bf16`` with the error feedback at M
    = 2, each rank's first step held to the two-rank CPU step;
19. the hot-row cache and the step metrics, dlrm-small at full width.  19a:
    table mode with the sharded stream on a one-rank NCCL group, 64 hot rows
    a table promoted every 2 steps under ``allreduce``, the metrics on: the
    first step held to the CPU step (phase 6's tolerances; the counts and
    the metrics bit for bit), 20 steps (one under
    ``set_sync_debug_mode("error")``) bit for bit the same 20 with the cache
    off (losses, store, dense state), the bag kernel twice a step (the
    owner's bags and the hot bags), the counts the bincount of the batches,
    the hot set a numpy ``lexsort`` of them in the reference's order, the
    mirror the store's rows, the metrics' counts exact; printed: the hit
    rate on a held-out batch, the effective all-to-all payload, the busy ms
    a step with and without the cache, the epilogue's parts under the
    profiler.  19b: ``deferred:8``, finite losses, the store's distance from
    19a's.  19c: ``TrainLoop`` draining the metrics every 10 steps: two
    heartbeat windows with ``cache_hit_rate``, the step p50 with and without
    the metrics.  19d: ``profile_stages`` of dlrm-small (row mode): six
    stages with ms and modelled bytes, flops and µs, the trace read back by
    ``telemetry.summarize``;
20. packed-shard ingestion, train-to-serve publishing and the launcher.
    20a: dlrm-small at full width from packed shards: 10 batches of
    zipf(1.05) samples packed into ``build/ingest/``; the shuffled reader's
    first batch bit for bit numpy's gather of its epoch order, epoch 1's
    order another; ``TrainLoop`` (prefetch 2) over ``HostPipeline(
    ShardedReader(shuffle=True))`` for 20 steps (two epochs) with a
    ``SnapshotPublisher`` every 10 steps: finite losses, the first step bit
    for bit a bare step on its batch, versions 1-3 published and 2 kept,
    version 2's CRC32s unchanged under 10 more in-place steps, the heartbeat
    carrying ``serve.snapshot``, rows 1, 2, 4, 5 once a step; 256 requests
    served from the newest version within 3e-3 of the plain forward;
    printed: the pack's MB/s, the gather's ms a batch shuffled and
    sequential, ``HostPipeline``'s prep and wait, the loop's samples/s each
    way beside the bare step's.  20b: ``launch.train.main`` in process,
    ``--arch dlrm-100m --batch 2048 --steps 40 --host-presort --optimizer
    adagrad_rowwise`` with checkpoints, a trace, publishing and the serving
    smoke, on a dataset packed by ``python -m repro_torch.data``: preempted
    at 30, then resumed from its final checkpoint to 40; the trace read by
    ``python -m repro_torch.telemetry summarize``, every served bucket's
    line printed, row 9 once a step; ``python -m repro_torch.launch.train
    --arch dlrm-smoke --steps 5`` as a subprocess.  20c:
    ``examples/train_dlrm_100m_torch.py`` at its defaults (its loss falls;
    the summary, the smoke and 20c run as three subprocesses at once);
21. the recsys archetypes (FM, BST, SASRec, DIN) at their published widths:
    rows 1 and 5-12 at E 11, 18, 50, then each archetype's train, serve and
    retrieval steps;
22. the paper's Fig. 16 run (``examples/split_sgd_convergence_torch.py``):
    the first ``split`` step (row 1's bag forward, row 4 on each of its 11
    leaves) held to the plain versions on the card, rows 1 and 4 timed at
    the example's shapes, then the four modes for 200 steps each: the
    final-20 means and both gaps printed, Split-SGD within 5e-3 of fp32;
23. serving on a mesh.  23a: dlrm-small at full width in row and in table
    mode on a (1, 2) mesh of two processes sharing the card over gloo
    (``make_bucket_scorers(mesh=)``; rank 0 serves 256 requests through a
    ``ContinuousBatchingServer``, rank 1 follows its batches): every served
    batch bit for bit both ranks' ``make_score_step`` gathered, every logit
    within 3e-3 of the plain forward of the gathered table, p50 / p99 a
    bucket.  23b: ``examples/serve_recsys_torch.py``'s path at one rank.
    23c: ``python -m repro_torch.launch.train --arch dlrm-small --ranks 2
    --publish-every 5 --serve-smoke`` in process;
24. dlrm-mlperf served at full size, row mode: the 48.07 GB bf16 table drawn
    on the card after a check that it fits (``torch.cuda.mem_get_info``),
    rows 1, 2 and 3 at its shapes (E 128, P 1, 26 tables; F 27; K 13, K 479,
    N 1) against their plain versions, timed beside bounds and library
    calls, then 1024 requests over buckets 8, 32, 128 (phase 3's gates, and
    a control with every lookup on the next row of its table, which must
    fall outside them);
25. gemma2-27b at full size (46 layers, 54.45 GB of bf16 weights drawn on
    the card), ``attn_impl="pallas"``, its prefill in 2 microbatches:
    phase 15's steps and gates on 4 x 4096 prompts and 32 greedy decode
    steps past the 4096 window (one flash launch a layer and a microbatch,
    none a decode step), each layer's decode attention held to the prefill
    of 4097 tokens on its inputs (a control one position early failing),
    the kernel alone at its local and global layers;
26. phi3-medium-14b at full size (40 layers, 29.3 GB), the same;
27. qwen3-moe-30b-a3b at full size (48 layers, 128 experts, top 8,
    capacity factor 1.0; 61.06 GB): the same steps, the share of (token,
    expert) pairs its capacity drops; the kernel held to its plain version
    on every call of the prefill (phase 14's gates; the two faults fail
    them), the whole model's logits against the plain and the chunked
    attention logged with the routing pinned (a bf16 step flips a router's
    choice, and the reference's expert init amplifies any step layer over
    layer); its first MoE layer at full width held to a direct computation
    on the card (each kept pair's SwiGLU through its expert, weighted,
    summed: the same kept pairs and slots, a control with the gates
    permuted failing);
28. deepseek-v2-236b at full width with its depth cut to the dense first
    layer and 7 MoE layers (8 of 60, 58.4 GB), MLA on the chunked path:
    prefill and decode finite, each layer's absorbed decode attention held
    to the 4097-token prefill's on its inputs (the control failing), the
    whole model's first decode step against that prefill logged as 27's;
29. dlrm-large served, row mode, its 64 tables cut to the largest multiple
    of 500,000 rows that leaves 8 GB free (6,000,000 uncut: 196 GB): rows
    1, 2 and 3 at its shapes (E 256, P 100; F 65; K 2048, 2336, 4096, N 1)
    at B 16,384 and the buckets against their plain versions, timed beside
    bounds and library calls, then phase 24's serving and its control;
30. internlm2-1.8b trained at full size (1.89 B parameters, Split-SGD state
    of 15.1 GB split from fp32 draws of a seeded generator) through
    ``make_lm_train_step``: B 4 x L 4096 in 2 microbatches, lr 1e-2,
    momentum 0.9, one batch repeated for 6 steps: every loss finite, the
    first near ln V, the last below it, row 4 (its momentum variant, a bf16
    gradient) launched once a leaf a step; step ms wall and busy (p50 of
    steps 2-6), tokens/s, peak memory, the idle share; row 4 alone at the
    model's largest leaf (403 M values) bit for bit its plain version, timed
    beside its bound (:func:`lm_train_phase`);
30a. the gate: one step of internlm2 at full width, 2 layers, B 2 x L 512,
    on the card against the same step on the CPU (the loss within 1e-3
    relative, every leaf's update within 5e-2 of its largest), row 4's
    update bit for bit its plain version on the card's own gradients; two
    planted faults (the labels shifted by one, one layer's gradient of one
    leaf zeroed) must each fail the gate (:func:`lm_gate_phase`);
31. qwen3-moe-30b-a3b at full width, 2 of 48 layers, B 2 x L 2048, 3 steps
    on one batch, the loss falling, the dropped share printed; its MoE block
    forward and backward at full width twice bit for bit, and against the
    plain gathers' autograd with the routing pinned (:func:`moe_train_phase`);
32. the launcher's LM branch: ``launch.train.main`` for each LM arch at the
    reference's ``reduced_lm`` sizes, a restart from ``--ckpt-dir`` after
    ``--preempt-at`` whose losses are the uninterrupted run's bit for bit,
    and ``python -m repro_torch.launch.train --arch internlm2-1.8b`` as a
    subprocess (:func:`lm_launcher_phase`);
33. the EGNN family at ``configs/egnn_arch.py``'s widths (4 layers, hidden
    64), Split-SGD at lr 1e-2, row 4 once a leaf (18) a step: 33a cora's
    shape through ``egnn_arch.build``, one step against the CPU's (30a's
    rule, row 4 bit for bit on the card's gradients, a rolled ``dst`` that
    must fail it), 20 steps, the loss falling; 33b ogb_products on all
    2,449,029 nodes, its edges cut to what leaves 10 GB of the card free, 5
    steps; 33c minibatch_lg through the fanout sampler on a power-law graph
    of Reddit's counts, 10 fresh batches; 33d molecule, 20 steps; 33e cora's
    step on a (1, 2) mesh of two processes on the card, each rank's update 2
    times the one-rank step's (the reference's ``psum`` transpose) and both
    ranks' states one (:func:`egnn_cora_phase` to :func:`egnn_mesh_phase`);
34. the dry run (``launch/dryrun.py``) on the card: 34a every DLRM, recsys
    and EGNN cell of the registry at rank 0 of the shape-only 16 x 16
    production mesh, full size, one step counted and one timed, its built
    state and batch holding its argument bytes to the byte, its loss or
    scores finite, its argument, output and peak bytes and collective bytes
    printed; 34b rank 0's step of dlrm-large ``train`` and
    ``train_tablewise`` and fm ``train_batch``, each at its own batch, held
    stage by stage to the same step with the plain versions on the card
    (the loss by phase 6's rule, the dense shard by phase 21's but in table
    mode, ``DRYRUN_HELD``), its dense and sparse updates bit for bit the
    plain updates of the card's own gradient and cotangent (the rows the
    latter touches; the other rows untouched), and one table's cotangent
    zeroed, a planted fault that must break the sparse one; 34d every
    single-pod LM cell the reference does not skip at rank 0 of that mesh,
    at full width with the cell's own B and L, cut to its first dense
    layers plus one scan unit, ``ok``, its built state (or parameters and
    cache) holding the cut depth's argument bytes, its loss or logits
    finite, its peak and collective bytes printed (row 4 on the train
    cells), run in this process while phase 35's two ranks run
    (:func:`dryrun_lm_phase`); 34c the two-pod cells and every cell without its step at the
    structs level (:func:`dryrun_phase`);
35. the LM steps on meshes of two processes sharing the card (gloo, every
    payload staged through pinned host memory; :func:`lm_mesh_phase`): 35a
    internlm2-1.8b at full size on (1, 2), Megatron TP 2 with sequence
    parallelism, 3 steps on one batch of 2 x 2048: every loss finite, the
    first near ln V, the last below it, row 4 once a leaf-shard a step on
    each rank, the step's host ms, each rank's collective bytes and peak;
    35b one step of it at 2 layers, B 2 x 512, held to the one-rank step on
    the card from the same state (the loss within 1e-3 relative, each
    leaf's update within 3e-2 of its largest), row 4 bit for bit its plain
    version on each rank's own gradient blocks, and two planted faults that
    must fail the gate (the labels shifted by one; one layer's row-parallel
    reduce skipped on one rank); 35c it served with ``attn_impl="pallas"``:
    a prefill of 4 x 4096 with row 13 on each rank's 8 q and 4 KV heads, the
    gathered logits within phase 15's 0.2 of the one-rank prefill's, then
    32 greedy decode steps, the tokens compared with the one rank's and
    logged; 35d qwen3-moe-30b-a3b at full width, 2 of 48 layers, on (2, 1):
    the experts over ``data``, the all-to-all on the card, its MoE block on
    each rank's row held to the one-rank block with the routing pinned
    (:class:`MoeRoutes`), 3 train steps on one batch, the loss falling,
    the dropped share printed; 35e ``python -m repro_torch.launch.train
    --arch internlm2-1.8b --ranks 2`` as three subprocesses: the
    uninterrupted run, a ``--ckpt-dir`` run stopped by ``--preempt-at`` and
    its restart, whose losses must be the uninterrupted run's bit for bit
    (``--losses-json``); and a fourth, the uninterrupted run at ``--ranks
    1``, whose losses the ``--ranks 2`` run's must be within 1e-3 relative
    (on the card they are not bit for bit).  34d and 35e run in this process while 35a-35d's
    ranks run.
A failure raises ``SystemExit`` and prints no result.  Each phase's seconds
and the whole run's so far are printed as it ends.

The line before the last two is ``{"kernels": [...]}`` (times in ms, CUDA
events after warm-up, rows 1-4 and their library calls as CUDA graphs,
with ``ms_by_batch``; row 4 with the L2 flushed before each launch, its
warm reading as ``ms_l2_warm``; ``bound_ms`` from
this run's bytes and operations over the card's published peaks;
``launches`` from each kernel's own path: the bag and the interaction count
the served batches, the Split-SGD train steps, the run loop's 80 steps and
its eval step, rows 4 and 5 the train steps and the loop's, and rows 1, 2,
4, 5 and 9 also phase 16's timed steps, both ranks' in 16b, and rows 1,
2, 4 and 5 every rank's loop and elastic steps of phase 17 and phase 18's
timed steps: 18a's presorted and loop steps, 18b's, 18c's M > 1 steps (rows
1 and 2 M times a step) and both ranks' ring steps in 18d, and every step of
phase 19, row 1 twice a cached table-mode step, and phase 20's loops,
served batches and launcher runs, its stage profiles included; row 13 one
a layer and a microbatch of the main path's prefills in phases 15 and
25-27, by model under ``models``; rows 1-3 at dlrm-large's shapes under
``large``; row 4 also the LM steps of phases 30, 31 and 32, with its
momentum variant at internlm2's largest leaf under ``lm``, the EGNN
steps of phase 33, with its updates of one step timed under ``egnn``, and
the mesh LM steps of phases 34d and 35 (both ranks'), by path under
``lm_mesh``; row 13 also both ranks' prefill of 35c; rows 1, 2, 4 and 5
also phase 34a's steps of the dry run's cells); then
the card's name and power limit from ``nvidia-smi``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device.  No process it started outlives it: on its way out
it stops multiprocessing's resource tracker and any other child still
running.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
ALPHA = 1.05            # zipf skew of the request indices
BUCKETS = (8, 32, 128)  # the default serving ladder (docs/serve.md)
# the main path's traffic, 1024 requests: one burst of 896 (seven full
# batches of 128), then three of 32 and four of 8, each sent once the last
# is answered
BURSTS = (896, 32, 32, 32, 8, 8, 8, 8)
N_REQUESTS = sum(BURSTS)
KERNEL_TOL = {"embedding_bag": (1e-5, 1e-6), "dot_interaction": (1e-5, 1e-5),
              "fused_mlp": (1e-4, 1e-4)}  # (rtol, atol): fp32 sums in another order
FUSED_MLP_BF16_TOL = (2 ** -7, 1e-4)     # a bf16 output may round to the neighbour
# atol for the served logits against the plain forward's: the kernels' fp32
# sums differ in order from the plain versions', so a bf16 rounding between
# layers may fall the other way (1.27e-4 on the scores, about 5e-4 on the
# logits, measured); the logits of this random model span about +-0.08
LOGIT_TOL = 3e-3
SERVING_KERNELS = ("embedding_bag", "dot_interaction", "fused_mlp")
# the plain bag gathers its [B, S, P, E] rows in fp32 a batch chunk of at most this
# many values at a time (1 GiB): dlrm-large's batch of 16,384 would gather 26.8e9
PLAIN_BAG_VALUES = 1 << 28
N_TRAIN = 20  # staged zipf batches of the training phase (and the run loop's pool)
# the hybrid phase: 16a's timed table-mode steps and row-mode steps held bit for bit
# to the groupless step; 16b's cases on two ranks and their timed steps a case
HYBRID_STEPS, HYBRID_ROW_STEPS = 20, 3
HYBRID_TWO_CASES = (("row", "split_sgd"), ("table", "split_sgd"), ("row", "adagrad_rowwise"))
HYBRID_TWO_STEPS = 3
# the run loop at half the quickstart's depth (its 60 steps, a checkpoint every 20, a
# restart, on to 80): 30 steps, a checkpoint every 15, a restart, on to 40
RUN_STEPS, RUN_RESTART, RUN_CKPT_EVERY = 40, 30, 15
# the run loop on a mesh (phase 17): 17a's loops of dlrm-small at full width on (1, 2)
# (10 steps, a checkpoint at 5); 17b's quickstart contract on (2, 4) at the run loop's
# depth (30 steps, a checkpoint every 15, a restart, on to 40); 17c's elastic run (10 steps on (2, 4),
# 10 on (1, 4))
MESH_LOOP_STEPS, MESH_LOOP_SAVE = 10, 5
QUICKSTART = dict(name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
                  table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100), emb_dim=32,
                  pooling=8, batch=512, lr=0.05)
ELASTIC = dict(name="elastic", num_dense=32, bottom=(64, 16), top=(64,),
               table_rows=(5000, 3000, 1000, 500), emb_dim=16, pooling=4, batch=64, lr=0.05)
ELASTIC_STEPS = 10
# the kernels a loop step of the hybrid Split-SGD step launches at N ranks, per step:
# the dense step once a bucket (4 buckets)
MESH_STEP_LAUNCHES = {"embedding_bag": 1, "dot_interaction": 1, "embedding_update": 1,
                      "split_sgd": 4}
# phase 18: 18a's presorted steps (and the loop's) and table mode's; 18b's steps a
# wire; 18c's M-steps; 18d's ring steps
PRESORT_STEPS, PRESORT_TABLE_STEPS = 20, 5
WIRE_STEPS, MB_STEPS, RING_STEPS = 10, 10, 3
# phase 19: the hot-row cache's rows a table and cadence, its steps (19a cached and
# cold, 19b deferred, 19c each loop) and the metrics' drain
HOT_ROWS, PROMOTE_EVERY, CACHE_STEPS, METRICS_EVERY = 64, 2, 20, 10


# a kernel train step against the same step on the CPU (every kernel's plain
# version): the loss within 1e-4 relative; the store and the dense weights
# within 1e-2 of the step's largest update: the two sum the dense network
# in other orders, so a bf16 cotangent may round to its neighbour (2^-8
# relative) and the row sums carry that into the update (the stateful kinds'
# store is not held to it: see training_phase)
TRAIN_TOL = {"loss": 1e-4, "update": 1e-2}
# table mode's Split-SGD store against the plain step: its fp32 cotangent
# carries the dense network's other summation order into the hot rows
# unrounded (row mode's bf16 wire rounds most of it away), so a few values
# pass TRAIN_TOL's 1e-2 of the largest update.  Set from two H100 readings
# at dlrm-small's widths: 9 of 512 M values beyond 1e-2, the worst at
# 1.50e-2 (one rank, table mode); none beyond 1e-2, the worst at 0.77e-2
# (two ranks, one shard each).  Held: every value within 2e-2, at most 32
# beyond 1e-2
TABLE_STORE_TOL = {"update": 2e-2, "beyond": 32}
# the learning rate of the Adagrad kinds: a step moves each touched value by
# about lr, and at 0.1 (100 times the tables' init scale) dlrm-small's loss
# reached NaN within 4 steps in a CPU run at its widths; 0.01 trained
ADAGRAD_LR = 0.01
# each sparse optimizer's row kernel (the name of its wrapper in ops.KERNELS)
ROW_KERNEL = {"split_sgd": "embedding_update", "sgd": "embedding_update_fp32",
              "momentum": "embedding_update_momentum", "adagrad": "embedding_update_adagrad",
              "adagrad_rowwise": "embedding_update_adagrad_rowwise",
              "adagrad_freq": "embedding_update_freq",
              "momentum_bf16": "embedding_update_momentum_bf16",
              "adagrad_bf16": "embedding_update_adagrad_bf16"}
# the stateful kernels: (optimizer, wrapper and plain-version name, hyperparameter)
STATEFUL = (("momentum", "fused_update_momentum", "beta"),
            ("adagrad", "fused_update_adagrad", "eps"),
            ("adagrad_rowwise", "fused_update_adagrad_rowwise", "eps"),
            ("adagrad_freq", "fused_update_freq", "eps"),
            ("momentum_bf16", "fused_update_momentum_bf16", "beta"),
            ("adagrad_bf16", "fused_update_adagrad_bf16", "eps"))
# the stochastic rounding's seeds of the bf16 kinds' checks: the first
# near 2^31, the second negative (both wrap through uint32 in the hash)
SR_SEEDS = (2 ** 31 - 7, -3)
# the attention kernel phase: (case, B, H, Hkv, Lq, Lk, causal, window, softcap); the
# first is the main path's shape (internlm2-1.8b's prefill of 4 x 4096 tokens), the
# second a rank's share of it on phase 35c's (1, 2) mesh, gemma2 reaches the rest of the
# kernel's options (softcap 50, window 4096; its global layer also without the softcap,
# to price it), and the last case's first 400 queries see no key
ATTN_CASES = (("internlm2 prefill", 4, 16, 8, 4096, 4096, True, 0, 0.0),
              ("internlm2 prefill, a rank's heads on (1, 2)", 4, 8, 4, 4096, 4096, True, 0, 0.0),
              ("gemma2 local layer", 1, 32, 16, 8192, 8192, True, 4096, 50.0),
              ("gemma2 global layer", 1, 32, 16, 8192, 8192, True, 0, 50.0),
              ("gemma2 global layer, no softcap", 1, 32, 16, 8192, 8192, True, 0, 0.0),
              ("ragged", 2, 16, 8, 1000, 1000, True, 0, 0.0),
              ("right-aligned", 4, 16, 8, 200, 1000, True, 0, 0.0),
              ("non-causal", 2, 16, 8, 1000, 1000, False, 0, 0.0),
              ("no visible key", 2, 16, 8, 1000, 600, True, 0, 0.0))
# (rtol, atol) of the flash kernel against its plain version (the same 128-key tiles):
# the fp32 score sums and the exponentials differ in their last bits, so a p or an
# output may round to its bf16 neighbour (2^-8 to 2^-7 relative).  An output near 0 is
# a sum of terms that cancel, so a p rounded the other way moves it by a share of
# the v scale (about 1), not of its own value: each output is held to 2^-7 of both.
# The shares below keep the many small outputs to their own ulps: on an H100 up to
# 1.02% of outputs differed and up to 0.13% by more than one bf16 ulp of their value
ATTN_TOL = (2 ** -7, 2 ** -7)
ATTN_MAX_UNEQUAL = 0.02     # share of outputs not equal
ATTN_MAX_PAST_ULP = 0.0025  # share of outputs more than one bf16 ulp of their value apart
# LM serving: internlm2-1.8b at full size, 4 prompts of 4096 tokens (the repo's
# prefill_32k shape, B 32 x L 32768, cut to one card), then 32 greedy decode steps
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 4096, 32
LM_LONG = 32768  # one prefill at the repo's prefill length, B = 1
# atol for the full model's fp32 logits (max |logit| about 4.7 with these random
# weights) and for every layer's bf16 k and v cache (values up to about 6): any two
# right implementations drift apart through 24 layers, since a bf16 rounding that
# falls the other way in one layer moves every layer above it.  On an H100 the
# kernel's prefill and the plain attention's differed by 0.078 in the logits and
# 0.098 in the cache, and the plain and the chunked path's (the reference's two
# attention paths, no kernel on either side) by 0.078 to 0.084 in the logits; the run
# prints that yardstick.  Each run also plants two faults in the plain attention
# and fails unless both gates reject them (the weakest moved the logits by 1.12)
LM_TOL = 0.2
# phases 25-28: the LM family at full width, internlm2's shapes and gates.  Every
# model's decode attention is also held layer by layer to the prefill's on the same
# input and cache: each output within 2^-7 of its value and 2^-7 of the layer's
# largest (a p rounded to its bf16 neighbour moves an output by up to 2^-7 of the v
# scale, phase 14's gate, before the output projection sums it)
DECODE_ATTN_TOL = (2 ** -7, 2 ** -7)
GEMMA2_MICROBATCH = 2   # gemma2's prefill in two chunks: its 36,864-wide FFN transients halve
DEEPSEEK_LAYERS = 8     # deepseek-v2 cut to its dense first layer and 7 MoE layers, 58.4 GB


T_START = time.perf_counter()


def log(*a):
    """A line of the run's log, prefixed with the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f}]", *a, flush=True)


def stop_children() -> list[str]:
    """Stop every child of this process that still runs (multiprocessing's
    resource tracker through its own handle, any other by SIGTERM, then
    SIGKILL after 5 s) and return the command lines of the others."""
    import os
    import signal
    from multiprocessing import resource_tracker
    getattr(resource_tracker._resource_tracker, "_stop", lambda: None)()
    left = {}
    for f in Path(f"/proc/{os.getpid()}/task").glob("*/children"):
        for pid in map(int, f.read_text().split()):
            try:
                left[pid] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
                os.kill(pid, signal.SIGTERM)
            except (OSError, ProcessLookupError):
                continue
    deadline = time.monotonic() + 5
    for pid in left:
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0) and time.monotonic() < deadline:
                time.sleep(0.05)
            if os.waitpid(pid, os.WNOHANG) == (0, 0):
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
        except ChildProcessError:  # reaped already
            pass
    return list(left.values())


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flushed_ms(fn, iters: int = 20) -> float:
    """Device ms a call of ``fn`` that finds the L2 cold: a CUDA graph of
    ``iters`` pairs (a 64 MiB write, which evicts the H100's 50 MB L2, then
    ``fn``) less a graph of the ``iters`` writes alone.  In graphs, so that
    the host's launch (through the wrapper) is not timed."""
    import torch
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.fill_(1)

    def both():
        flush()
        fn()
    return graph_ms(both, iters) - graph_ms(flush, iters)


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms a call of ``fn``: ``iters`` calls captured in one CUDA graph,
    replayed once to warm up and once between CUDA events.  For the kernels
    whose launches take less time on the card than their wrapper on the
    host, where an eager loop would time the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
                    "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc",
                    "mem_free", "batch_mem_op", "conditional")  # CUgraphNodeType, in order


def graph_nodes(fn) -> dict:
    """What one call of ``fn`` enqueues on the card: its nodes in a CUDA graph
    of the call, counted by type (``{"kernel": 1}`` for one launch and nothing
    else).  Exact, where a profiler's trace can drop events.  ``fn`` runs twice:
    once to warm up, once captured."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed with CUresult {rc}")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)))
    counts: dict = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        name = GRAPH_NODE_TYPES[kind.value] if 0 <= kind.value < len(GRAPH_NODE_TYPES) \
            else f"type {kind.value}"
        counts[name] = counts.get(name, 0) + 1
    del graph
    return counts


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def close_or_fail(name, got, want, rtol, atol, failures) -> float:
    d = (got.float() - want.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    bad = int((d > atol + rtol * want.float().abs()).sum())
    finite = bool(got.float().isfinite().all())
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}), {bad} outside, "
        f"finite {finite}")
    if bad or not finite:
        failures.append(f"{name}: {bad} values outside tolerance, finite={finite}")
    return err


def summed_or_fail(name, got, want, size, n: int, rtol: float, failures) -> float:
    """``got`` against ``want`` where each value is a sum of ``n`` fp32
    products whose sizes sum to ``size`` (the same sum of |products|): any
    two summation orders stay within 2 n 2^-24 size of each other (each
    within n 2^-24 size of the exact sum, to first order), and the output's
    own rounding adds ``rtol`` of its value.  The gate of dlrm-large's
    shapes, whose sums of 256 to 4096 products cancel to near zero where a
    fixed atol cannot follow them."""
    d = (got.float() - want.float()).abs()
    tol = rtol * want.float().abs() + 2 * n * 2.0 ** -24 * size.float()
    err = float(d.max()) if d.numel() else 0.0
    bad = int((d > tol).sum())
    finite = bool(got.float().isfinite().all())
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol:g} + 2 * {n} * 2^-24 of the sum of "
        f"|products|, largest {float(size.max()):.3e}), {bad} outside, finite {finite}")
    if bad or not finite:
        failures.append(f"{name}: {bad} values outside the summation bound, finite={finite}")
    return err


def stage_or_fail(name, W, idx, offsets, rows, wgt, failures) -> None:
    """The fused bag stage (offset add, bag, bf16 round in one launch)
    against the kernel's own fp32 bag of the global ids rounded to bf16, bit
    for bit, and against the plain composition: each sum within one bf16 ulp
    of the plain one, or, where the sum cancels to near zero (one bf16 ulp
    of it is then below the fp32 sums' own rounding), within the bag's fp32
    atol; the share of sums that differ printed."""
    import torch
    from repro_torch.kernels import ops
    got = ops.embedding_bag_stage(W, idx, offsets, rows, wgt)
    own = ops.embedding_bag(W, idx + offsets[None, :, None], rows, wgt).to(torch.bfloat16).float()
    want = plain_bag(W, idx + offsets[None, :, None], rows, wgt).to(torch.bfloat16).float()
    same = bool((got.view(torch.int32) == own.view(torch.int32)).all())
    d = (got - want).abs()
    past = bf16_ulps(got, want) > 1
    atol = KERNEL_TOL["embedding_bag"][1]
    bad = int((past & (d > atol)).sum())
    log(f"  {name}: bitwise the kernel's rounded bag {same}; {float((d > 0).float().mean()) * 100:.4f}% "
        f"of {d.numel()} sums differ from the plain composition, {int(past.sum())} by more than "
        f"one bf16 ulp ({bad} of them beyond atol {atol:g}), max_abs_err {float(d.max()):.3e}")
    if not same or bad:
        failures.append(f"{name}: bitwise the kernel's rounded bag {same}, {bad} sums past one bf16 "
                        f"ulp and atol")


def plain_bag(W, gidx, rows, wgt=None):
    """``ref.embedding_bag`` over batch chunks of at most PLAIN_BAG_VALUES
    gathered values (each sample's sums are its own; a batch within the
    limit is one call)."""
    import torch
    from repro_torch.kernels import ref
    B, S, P = gidx.shape
    n = max(1, PLAIN_BAG_VALUES // (S * P * W.shape[1]))
    if n >= B:
        return ref.embedding_bag(W, gidx, rows, wgt)
    return torch.cat([ref.embedding_bag(W, gidx[i:i + n], rows, None if wgt is None else
                                        wgt[i:i + n]) for i in range(0, B, n)])


def make_requests(cfg, n: int, rng) -> list[dict]:
    from repro_torch.data.synthetic import zipf_indices
    idx = np.stack([zipf_indices(rng, m, (n, cfg.pooling), ALPHA) for m in cfg.table_rows], axis=1)
    dense = rng.standard_normal((n, cfg.num_dense)).astype(np.float32)
    return [{"idx": idx[i].astype(np.int32), "dense_x": dense[i]} for i in range(n)]


def plain_logits(cfg, snap, batch, offsets, bag: bool = True, round_bags: bool = True,
                 exact: bool = False):
    """The serving forward before its sigmoid, with every kernel replaced by
    its plain version (``bag=False``: the bag outputs zeroed; ``round_bags``:
    each bag rounded to bf16, row mode's wire, where table mode's is fp32).
    ``exact``: the bags, the interaction and every layer's products and sums
    in float64 instead, still rounded to bf16 between layers (a yardstick:
    how far the fp32 sums of the kernels and of the plain versions drift)."""
    import torch
    from repro_torch.kernels import ref
    rows = snap["emb_w"].shape[0]
    gidx = batch["idx"] + offsets[None, :, None]
    emb = (snap["emb_w"][gidx.long()].double().sum(2) if exact
           else plain_bag(snap["emb_w"], gidx, rows))
    if round_bags:
        emb = emb.to(torch.bfloat16).float()
    if not bag:
        emb = torch.zeros_like(emb)

    def mlp(params, h, final_act):
        n = len(params["w"])
        for i, (w, b) in enumerate(zip(params["w"], params["b"])):
            last = i == n - 1
            act = "relu" if (final_act or not last) else "none"
            out_dtype = torch.float32 if last else torch.bfloat16
            if exact:
                y = h.double() @ w.double() + b.double()
                h = (torch.relu(y) if act == "relu" else y).to(out_dtype)
            else:
                h = ref.fused_mlp_layer(h, w, b, act, out_dtype)
        return h

    bot = mlp(snap["dense_hi"]["bot"], batch["dense_x"], True)
    if exact:   # ref.dot_interaction in float64
        Z = torch.cat([bot[:, None, :], emb], dim=1).double()
        F_ = Z.shape[1]
        li, lj = np.tril_indices(F_, -1)
        pairs = torch.bmm(Z, Z.transpose(1, 2)).reshape(len(Z), -1)[
            :, torch.as_tensor(li * F_ + lj, device=Z.device)]
        z = torch.cat([bot.double(), pairs], dim=1)
    else:
        z = ref.dot_interaction(bot, emb)
    return mlp(snap["dense_hi"]["top"], z.to(torch.bfloat16), False)[:, 0]


def kernel_phase(cfg, snap, offsets, dev, rng, failures, summed: bool = False) -> list[dict]:
    """Each kernel against its plain version at B = cfg.batch (timed) and at
    every bucket the main path serves; returns the kernel entries of the JSON
    line (the bag's entry also holds its uniform-index times).  With
    ``summed`` the interaction and fused_mlp are held by
    :func:`summed_or_fail` (dlrm-large's shapes), else by KERNEL_TOL."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.interaction import tril_indices
    from repro_torch.kernels import fused_mlp, ops, ref

    W = snap["emb_w"]
    rows, E = W.shape
    S, P = len(cfg.table_rows), cfg.pooling
    entries = {}
    # a plain bag cut into chunks (dlrm-large's) is timed over fewer runs
    plain_iters = 20 if cfg.batch * S * P * E <= PLAIN_BAG_VALUES else 3
    for B in (cfg.batch, *BUCKETS):
        reqs = make_requests(cfg, B, rng)
        idx = torch.from_numpy(np.stack([r["idx"] for r in reqs])).to(dev)
        dense_x = torch.from_numpy(np.stack([r["dense_x"] for r in reqs])).to(dev).to(torch.bfloat16)
        gidx = idx + offsets[None, :, None]
        timed = B == cfg.batch
        log(f"kernels at B={B}:")

        # embedding_bag, and the bag stage that fuses the offset add and the round
        got = ops.embedding_bag(W, gidx, rows)
        want = plain_bag(W, gidx, rows)
        err = close_or_fail(f"embedding_bag [{B},{S},{P}] x [{rows},{E}] {W.dtype}", got, want,
                            *KERNEL_TOL["embedding_bag"], failures)
        e = entries.setdefault("embedding_bag", {"name": "embedding_bag", "max_abs_err": 0.0,
                                                 "by_batch": {}})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        stage_or_fail(f"bag stage [{B},{S},{P}]", W, idx, offsets, rows, None, failures)
        e["by_batch"][B] = graph_ms(lambda: ops.embedding_bag(W, gidx, rows))
        log(f"  embedding_bag at B={B}: {e['by_batch'][B]:.4f} ms (device, CUDA graph)")
        if timed:
            unique = int(torch.unique(gidx).numel())
            nbytes = unique * E * W.element_size() + gidx.numel() * 4 + B * S * E * 4
            flops = gidx.numel() * E
            bms, by = bound_ms(nbytes, flops, FP32_FLOPS)
            flat = gidx.view(B * S, P)
            e.update(ms=e["by_batch"][B],
                     plain_ms=time_ms(lambda: plain_bag(W, gidx, rows), iters=plain_iters),
                     library_ms=graph_ms(lambda: F.embedding_bag(flat, W, mode="sum")),
                     bound_ms=bms, bound_by=by)
            if P == 1:  # the lookups gathered, then summed in fp32: the yardstick of a bag of one
                e["library_embedding_ms"] = graph_ms(lambda: F.embedding(gidx, W).float().sum(2))
            log(f"  embedding_bag: {unique} distinct rows of {gidx.numel()} lookups; "
                f"{nbytes / 1e6:.1f} MB needed ({gidx.numel() * (E * W.element_size() + 4) / 1e6 + B * S * E * 4 / 1e6:.1f} MB "
                f"if no row repeated)")
            # the same number of lookups, uniform over each table: nearly
            # every row distinct, so the rows come from HBM and not from L2
            uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                             axis=1).astype(np.int32)).to(dev) + offsets[None, :, None]
            err = close_or_fail(f"embedding_bag, uniform indices [{B},{S},{P}]",
                                ops.embedding_bag(W, uidx, rows), plain_bag(W, uidx, rows),
                                *KERNEL_TOL["embedding_bag"], failures)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            stage_or_fail(f"bag stage, uniform indices [{B},{S},{P}]", W,
                          uidx - offsets[None, :, None], offsets, rows, None, failures)
            u_unique = int(torch.unique(uidx).numel())
            u_bytes = u_unique * E * W.element_size() + uidx.numel() * 4 + B * S * E * 4
            u_bms, u_by = bound_ms(u_bytes, flops, FP32_FLOPS)
            uflat = uidx.view(B * S, P)
            e["uniform"] = dict(distinct=u_unique, mb=u_bytes / 1e6, bound_ms=u_bms, bound_by=u_by,
                                ms=graph_ms(lambda: ops.embedding_bag(W, uidx, rows)),
                                library_ms=graph_ms(lambda: F.embedding_bag(uflat, W, mode="sum")))
            log(f"  embedding_bag, uniform indices: {u_unique} distinct rows, {u_bytes / 1e6:.1f} MB "
                f"needed; kernel {e['uniform']['ms']:.4f} ms, F.embedding_bag "
                f"{e['uniform']['library_ms']:.4f} ms, bound {u_bms:.4f} ms ({u_by})")
            e["weighted"] = weighted_bag(W, idx, offsets, rows, rng, unique, failures,
                                         plain_iters)
            e["max_abs_err"] = max(e["max_abs_err"], e["weighted"]["max_abs_err"])
        emb = got.to(torch.bfloat16).float()

        # fused_mlp, layer by layer on the forward's own activations
        def layers(params, h, final_act, tag):
            n = len(params["w"])
            for i, (w, b) in enumerate(zip(params["w"], params["b"])):
                last = i == n - 1
                act = "relu" if (final_act or not last) else "none"
                out_dtype = torch.float32 if last else torch.bfloat16
                k_out = ops.fused_mlp_layer(h, w, b, act, out_dtype)
                p_out = ref.fused_mlp_layer(h, w, b, act, out_dtype)
                tol = KERNEL_TOL["fused_mlp"] if last else FUSED_MLP_BF16_TOL
                M, K = h.shape
                N = w.shape[1]
                path = fused_mlp.route(M, K, N)
                what = f"fused_mlp {tag}{i} [{M}x{K}]@[{K}x{N}] {act} -> {out_dtype} ({path})"
                if summed:
                    size = ref.fused_mlp_layer(h.abs(), w.abs(), b.abs(), "none", torch.float32)
                    err = summed_or_fail(what, k_out, p_out, size, K, tol[0], failures)
                    del size
                else:
                    err = close_or_fail(what, k_out, p_out, *tol, failures)
                e = entries.setdefault("fused_mlp", {"name": "fused_mlp", "max_abs_err": 0.0,
                                                     "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                                     "library_ms": 0.0, "flops": 0.0, "bytes": 0.0,
                                                     "layers": []})
                e["max_abs_err"] = max(e["max_abs_err"], err)
                if timed:
                    nbytes = (M * K + K * N) * 2 + N * b.element_size() + M * N * k_out.element_size()
                    flops = 2.0 * M * K * N
                    bms, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
                    lib = torch.relu if act == "relu" else (lambda y: y)
                    # the kernel and its library call as CUDA graphs: an eager loop of
                    # launches this short can time the host's wrapper
                    t = dict(ms=graph_ms(lambda: ops.fused_mlp_layer(h, w, b, act, out_dtype)),
                             plain_ms=time_ms(lambda: ref.fused_mlp_layer(h, w, b, act, out_dtype)),
                             library_ms=graph_ms(lambda: lib(torch.addmm(b.to(h.dtype), h, w))),
                             bound_ms=bms)
                    for key, v in t.items():
                        e[key] += v
                    e["flops"] += flops
                    e["bytes"] += nbytes
                    e["layers"].append(dict(layer=f"{tag}{i}", M=M, K=K, N=N, route=path, **t,
                                            bound_by=by))
                    log(f"    {tag}{i} [{M}x{K}]@[{K}x{N}], {path}: kernel {t['ms']:.4f} ms, "
                        f"plain {t['plain_ms']:.4f} ms, addmm {t['library_ms']:.4f} ms, bound "
                        f"{bms:.4f} ms ({by}), {bms / t['ms'] * 100:.1f}% of bound, "
                        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
                h = p_out
            return h

        bot = layers(snap["dense_hi"]["bot"], dense_x, True, "bot")

        # dot_interaction
        got = ops.dot_interaction(bot, emb)
        want = ref.dot_interaction(bot, emb)
        what = f"dot_interaction [{B},{E}] + [{B},{S},{E}]"
        if summed:
            err = summed_or_fail(what, got, want, ref.dot_interaction(bot.abs(), emb.abs()), E,
                                 KERNEL_TOL["dot_interaction"][0], failures)
        else:
            err = close_or_fail(what, got, want, *KERNEL_TOL["dot_interaction"], failures)
        e = entries.setdefault("dot_interaction", {"name": "dot_interaction", "max_abs_err": 0.0,
                                                   "by_batch": {}})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["by_batch"][B] = graph_ms(lambda: ops.dot_interaction(bot, emb))
        log(f"  dot_interaction at B={B}: {e['by_batch'][B]:.4f} ms (device, CUDA graph)")
        if timed:
            F_ = S + 1
            pairs = F_ * (F_ - 1) // 2
            nbytes = (B * E + B * S * E) * 4 + B * (E + pairs) * 4
            bms, by = bound_ms(nbytes, 2.0 * B * pairs * E, FP32_FLOPS)
            Z = torch.cat([bot[:, None, :], emb], dim=1)
            li, lj = tril_indices(F_)
            flat = torch.as_tensor(li * F_ + lj, device=dev)
            e.update(ms=e["by_batch"][B],
                     plain_ms=time_ms(lambda: ref.dot_interaction(bot, emb)),
                     library_ms=graph_ms(
                         lambda: torch.bmm(Z, Z.transpose(1, 2)).view(B, -1)[:, flat]),
                     bound_ms=bms, bound_by=by)

        layers(snap["dense_hi"]["top"], want.to(torch.bfloat16), False, "top")

    fm = entries["fused_mlp"]
    for path in ("wgmma", "mma_sync"):
        ls = [x for x in fm["layers"] if x["route"] == path]
        log(f"fused_mlp at B={cfg.batch}, {path} route ({len(ls)} layers): kernel "
            f"{sum(x['ms'] for x in ls):.4f} ms, addmm {sum(x['library_ms'] for x in ls):.4f} ms, "
            f"bound {sum(x['bound_ms'] for x in ls):.4f} ms")
    fm["bound_by"] = ("operations" if fm["flops"] / BF16_TENSOR_FLOPS >= fm["bytes"] / HBM_BYTES_PER_S
                      else "bytes")
    del fm["flops"], fm["bytes"]
    return [entries[k] for k in ("embedding_bag", "dot_interaction", "fused_mlp")]


def weighted_bag(W, idx, offsets, rows, rng, unique, failures, plain_iters: int = 20) -> dict:
    """The weighted bag at the zipf indices ``idx`` [B, S, P] (table-local;
    ``offsets`` per slot), weights U[0.5, 1.5) from ``rng``: against its
    plain version, all-ones weights bit for bit the unweighted kernel's
    output, the weighted bag stage against its plain composition, timed
    against the plain version and ``F.embedding_bag(per_sample_weights=...)``
    (which wants the weights in the table's dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    gidx = idx + offsets[None, :, None]
    B, S, P = gidx.shape
    E = W.shape[1]
    wgt = torch.from_numpy(rng.uniform(0.5, 1.5, gidx.shape).astype(np.float32)).to(gidx.device)
    err = close_or_fail(f"embedding_bag, weighted [{B},{S},{P}]", ops.embedding_bag(W, gidx, rows, wgt),
                        plain_bag(W, gidx, rows, wgt), *KERNEL_TOL["embedding_bag"], failures)
    bitwise_or_fail("embedding_bag, all-ones weights vs unweighted",
                    ops.embedding_bag(W, gidx, rows, torch.ones_like(wgt)),
                    ops.embedding_bag(W, gidx, rows), failures)
    stage_or_fail(f"bag stage, weighted [{B},{S},{P}]", W, idx, offsets, rows, wgt, failures)
    # the distinct rows, the indices and the weights read once, the sums written once
    nbytes = unique * E * W.element_size() + gidx.numel() * 8 + B * S * E * 4
    bms, by = bound_ms(nbytes, gidx.numel() * E * 2, FP32_FLOPS)
    flat, wflat = gidx.view(B * S, P), wgt.view(B * S, P).to(W.dtype)
    t = dict(max_abs_err=err, ms=graph_ms(lambda: ops.embedding_bag(W, gidx, rows, wgt)),
             plain_ms=time_ms(lambda: plain_bag(W, gidx, rows, wgt), iters=plain_iters),
             library_ms=graph_ms(lambda: F.embedding_bag(flat, W, mode="sum",
                                                         per_sample_weights=wflat)),
             bound_ms=bms, bound_by=by)
    log(f"  embedding_bag, weighted: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"F.embedding_bag(per_sample_weights) {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return t


def serving_phase(cfg, reg, offsets, dev, reqs, failures, control: bool = False,
                  logit_tol: float = LOGIT_TOL, exact: bool = False) -> dict:
    """The main path: the requests through the server, in bursts that each
    wait for the last to be answered (BURSTS), so that every bucket serves;
    every logit within ``logit_tol`` of the plain forward's.  With
    ``control``, the plain forward with every lookup moved to the next row
    of its table must fall beyond ``logit_tol`` of the served logits
    somewhere, or the gate could not see a wrong row.  With ``exact``, both
    the served and the plain logits are also measured against the forward
    in float64 (:func:`plain_logits`), the yardstick of their drift.
    Returns the launch counts of this run."""
    import torch
    from repro_torch.kernels import fused_mlp, ops
    from repro_torch.serve import ContinuousBatchingServer, make_bucket_scorers

    fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: reg.current().state, device=dev)
    scores = []
    ops.reset_launches()
    t0 = time.perf_counter()
    with ContinuousBatchingServer(fns, pad, max_wait_ms=2.0) as srv:
        start = 0
        for n in BURSTS:
            handles = [srv.submit(r) for r in reqs[start:start + n]]
            scores += [h.result(timeout=300.0) for h in handles]
            start += n
        stats = srv.stats()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    routes = dict(ops.fused_mlp_layer.route_launches)
    scores = np.array(scores, dtype=np.float32)
    n_batches = sum(stats["batches"].values())
    log(f"served {stats['requests']} requests in {n_batches} batches {stats['batches']} "
        f"({stats['padded']} padded rows) in {wall:.3f} s")
    for b, p in sorted(stats["buckets"].items()):
        log(f"  bucket {b}: n {p['n']}, p50 {p['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} ms")
    log(f"kernel launches on the main path: {counts}")

    ok = np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all()
    if not ok or scores.shape != (N_REQUESTS,):
        failures.append(f"served scores: shape {scores.shape}, finite and in (0, 1): {ok}")
    if min(counts[k] for k in SERVING_KERNELS) == 0:
        failures.append(f"a kernel was not launched on the main path: {counts}")
    # the model's layers by route: every layer whose K and N a tensor map takes on wgmma
    layers = [(k, n) for sizes in (cfg.bottom_sizes, cfg.top_sizes)
              for k, n in zip(sizes, sizes[1:])]
    if counts["fused_mlp"] != len(layers) * n_batches or counts["embedding_bag"] != n_batches \
            or counts["dot_interaction"] != n_batches \
            or any(v for k, v in counts.items() if k not in SERVING_KERNELS):
        failures.append(f"launches {counts} do not match {n_batches} batches (fused_mlp "
                        f"{len(layers)} each)")
    want_routes = {path: n_batches * sum(fused_mlp.route(BUCKETS[0], k, n) == path
                                         for k, n in layers)
                   for path in ("wgmma", "mma_sync")}
    log(f"fused_mlp launches by route: {routes} (want {want_routes}: of the {len(layers)} layers "
        f"{want_routes['wgmma'] // max(n_batches, 1)} on wgmma)")
    if routes != want_routes:
        failures.append(f"fused_mlp routes {routes}, want {want_routes}")

    # every served score's logit against the plain-version forward's logit
    # of the same rows (fp32 scores near 0.5 invert to within about 3e-7)
    snap = reg.current().state
    want, no_bag, moved, f64 = [], [], [], []
    rows = torch.as_tensor(cfg.table_rows, dtype=torch.int32, device=dev)[None, :, None]
    for i in range(0, N_REQUESTS, BUCKETS[-1]):
        batch = pad(reqs[i:i + BUCKETS[-1]], BUCKETS[-1])
        want.append(plain_logits(cfg, snap, batch, offsets).cpu())
        no_bag.append(plain_logits(cfg, snap, batch, offsets, bag=False).cpu())
        if control:
            moved.append(plain_logits(cfg, snap, dict(batch, idx=(batch["idx"] + 1) % rows),
                                      offsets).cpu())
        if exact:
            f64.append(plain_logits(cfg, snap, batch, offsets, exact=True).cpu())
    want, no_bag = torch.cat(want)[:N_REQUESTS].double(), torch.cat(no_bag)[:N_REQUESTS].double()
    got = torch.logit(torch.from_numpy(scores).double())
    close_or_fail(f"served logits vs plain forward ({N_REQUESTS})", got, want, 0.0, logit_tol,
                  failures)
    if exact:
        f64 = torch.cat(f64)[:N_REQUESTS].double()
        log(f"  the yardstick, the forward in float64 (bf16 between layers): served logits up to "
            f"{float((got - f64).abs().max()):.3e} from it, the plain forward's up to "
            f"{float((want - f64).abs().max()):.3e}")
    if control:
        off = float((torch.cat(moved)[:N_REQUESTS].double() - got).abs().max())
        log(f"  control, every lookup on the next row of its table: the served logits up to "
            f"{off:.3e} from its plain forward (must pass {logit_tol})")
        if not off > logit_tol:
            failures.append(f"served logits: the moved-rows control is within {logit_tol} "
                            f"({off:.3e}): the gate cannot see a wrong row")
    log(f"  scores: min {scores.min():.6f}, max {scores.max():.6f}, mean {scores.mean():.6f}; "
        f"logits: min {float(got.min()):.6f}, max {float(got.max()):.6f}; zeroing the bags "
        f"would move the logits by up to {float((no_bag - want).abs().max()):.3e}")
    counts["fused_mlp_routes"] = routes
    return counts


def device_busy_ms(fn, reps: int) -> tuple[float, float, list]:
    """``fn`` run ``reps`` times under torch.profiler: wall ms a run (ending
    in a synchronise), the device's busy ms a run (its kernels' time summed)
    and its kernels as (name, ms a run, launches a run), the longest first.
    The trace can drop events of a short window: its counts are read, not
    gated on (``graph_nodes`` counts exactly).  It traces the card alone: the
    host's operator events, which nothing reads, cost seconds of trace
    processing a call (about 70 s a step of phase 30's LM training), and
    their recording added to the wall clock beside the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    return wall_ms, busy_ms, [(e.key, e.self_device_time_total / reps / 1e3, round(e.count / reps))
                              for e in kernels]


def top_kernels(top: list) -> str:
    return "; ".join(f"{name[:48]} {ms:.4f} ms x{n}" for name, ms, n in top)


def breakdown_phase(cfg, reg, reqs, dev) -> None:
    """Where one batch's time goes, per bucket: padding on the host, the
    score fn's wall time until the scores are on the host, and the device's
    busy time in it from torch.profiler (kernels by name)."""
    from repro_torch.serve import make_bucket_scorers

    fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: reg.current().state, device=dev)
    reps = 20
    for b in BUCKETS:
        payloads = reqs[:b]
        t0 = time.perf_counter()
        for _ in range(reps):
            batch = pad(payloads, b)
        pad_ms = (time.perf_counter() - t0) / reps * 1e3
        for _ in range(3):
            fns[b](batch)
        wall_ms, busy_ms, top = device_busy_ms(lambda: fns[b](batch), reps)
        log(f"bucket {b}: pad {pad_ms:.3f} ms; score fn {wall_ms:.3f} ms wall, device busy "
            f"{busy_ms:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: "
            + top_kernels(top[:6]))


def sm_clock_ghz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) / 1e3


def bitwise_or_fail(name, got, want, failures) -> float:
    """Bitwise equality of two tensors of one type; returns the max abs
    difference of their values (0.0 when equal)."""
    import torch
    ib = torch.int16 if got.element_size() == 2 else torch.int32
    same = got.shape == want.shape and bool((got.view(ib) == want.view(ib)).all())
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    log(f"  {name}: bitwise {same}, max_abs_err {err:.3e}")
    if not same:
        failures.append(f"{name}: not bitwise equal to its plain version (max_abs_err {err:.3e})")
    return err


# each row kernel's wrapper in kernels.ops
ROW_WRAPPER = {"embedding_update": "fused_update_split",
               "embedding_update_fp32": "fused_update_fp32"}


def check_long_runs(name, wrapper, counts, failures) -> None:
    """The number of runs the wrapper's last launch listed for the long-run
    schedule against the runs of ``eu.long_run()`` lookups or more counted on the
    host (``counts``: each run's length); read after the timed region."""
    from repro_torch.kernels import embedding_update as eu
    T = eu.long_run()
    listed, want = int(wrapper.long_runs), int((counts >= T).sum())
    log(f"  {name}: {listed} runs of {T} lookups or more listed by the first kernel, "
        f"{want} counted on the host")
    if listed != want:
        failures.append(f"{name}: the first kernel listed {listed} long runs, the host counts "
                        f"{want}")


def master(store):
    """The fp32 master rows of an embedding store."""
    from repro_torch.optim.split_sgd import combine_split
    return store["w"] if "w" in store else combine_split(store["hi"], store["lo"])


def card_master(store, dev):
    """:func:`master` of a store put together on the card ``dev`` (a CPU
    store's slabs copied there first): the comparisons of dlrm-small's 512 M
    values with a CPU step's take a fraction of a second there, where the
    CPU's int64 combine and passes over 2 GB took some 20 s each."""
    return master({k: v.to(dev) for k, v in store.items()})


def dense_master(dense, ranks: int = 1, rank: int = 0):
    """The fp32 master values of a rank's shard of the dense state, padding
    included (``repro_torch.testing.dense_master``)."""
    from repro_torch.testing import dense_master as shard_master
    return shard_master(dense, ranks, rank)


def row_kernel_phase(cfg, state, offsets, batch, dev, rng, failures) -> list[dict]:
    """Rows 5 and 6 (the fused row update, split and fp32 store) and row 4
    (the flat Split-SGD step) against their plain versions, bit for bit, at
    dlrm-small's shapes: the main path's first zipf(1.05) batch and a
    uniform one, with a bf16 cotangent of the wire's shape [B * S, E]; the
    plain row update sums on CPU copies to fix its order.  Timed with CUDA
    events; returns the kernel entries of the JSON line."""
    import torch
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import data_parallel as dp

    B, S, P, E = cfg.batch, len(cfg.table_rows), cfg.pooling, cfg.emb_dim
    rows = state["emb"]["hi"].shape[0]
    lr = cfg.lr
    ghz = sm_clock_ghz()
    dY = (torch.randn((B * S, E), device=dev) * 1e-3).to(torch.bfloat16)
    W32 = master(state["emb"])
    uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                     axis=1).astype(np.int32)).to(dev)
    entries = {"embedding_update": {"name": "embedding_update", "max_abs_err": 0.0},
               "embedding_update_fp32": {"name": "embedding_update_fp32", "max_abs_err": 0.0}}
    for tag, idx in (("zipf", batch["idx"]), ("uniform", uidx)):
        stream = eu.sort_lookups((idx + offsets[None, :, None]).reshape(-1), None, rows, P)
        L = stream[0].numel()
        _, counts = torch.unique_consecutive(stream[0], return_counts=True)
        U, longest = counts.numel(), int(counts.max())
        # each touched row read and written once, dY and the sorted stream read once
        base = dY.numel() * 2 + L * 16
        flops = L * E * 2 + U * E * 2
        chain_ms = longest * 4 / (ghz * 1e9) * 1e3  # one dependent fp32 add (4 cycles) a lookup
        log(f"row update, {tag} indices: L {L}, {U} runs, longest {longest} lookups; the serial "
            f"chain of the longest run: {chain_ms:.4f} ms at {ghz:.3f} GHz (4-cycle fp32 add)")
        for name, keys in (("embedding_update", ("hi", "lo")), ("embedding_update_fp32", ("w",))):
            e = entries[name]
            # the plain version, timed on the host clock (it syncs with the
            # host to sum on the CPU), then the kernel on a copy of the table
            if keys == ("w",):
                store, want = {"w": W32.clone()}, {"w": W32.clone()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref.fused_update_fp32(want["w"], *stream, dY, lr)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                ops.fused_update_fp32(store["w"], *stream, dY, lr)
            else:
                store = {k: state["emb"][k].clone() for k in keys}
                want = {k: state["emb"][k].clone() for k in keys}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref.fused_update_split(want["hi"], want["lo"], *stream, dY, lr)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)
            torch.cuda.synchronize()
            for k in keys:
                err = bitwise_or_fail(f"{name} [{L} lookups -> {rows}x{E}] {tag}, {k}", store[k],
                                      want[k], failures)
                e["max_abs_err"] = max(e["max_abs_err"], err)
            bms, by = bound_ms(base + U * E * 4 * 2, flops, FP32_FLOPS)
            if keys == ("w",):
                def kern():
                    ops.fused_update_fp32(store["w"], *stream, dY, lr)
            else:
                def kern():
                    ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)
            t = dict(ms=time_ms(kern), plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, chain_ms=chain_ms, longest=longest, runs=U)
            if keys == ("w",):
                # the library yardstick: index_add_ of pre-gathered rows (atomics: no fixed order)
                g = torch.where(stream[2][:, None] != 0, dY[stream[1].long()].float(), 0.0)
                r64 = stream[0].long()
                t["library_ms"] = time_ms(lambda: store["w"].index_add_(0, r64, g, alpha=-lr))
                del g
            else:
                t["library_ms"] = None  # no PyTorch call splits fp32 into halves
            lib = "none" if t["library_ms"] is None else (
                f"{t['library_ms']:.4f} ms (the kernel at {t['ms'] / t['library_ms']:.3f}x it)")
            log(f"  {name} {tag}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, "
                f"library {lib}, bound {bms:.4f} ms ({by}, {(base + U * E * 8) / 1e6:.1f} MB), "
                f"{t['ms'] / chain_ms:.2f}x the longest run's serial chain")
            check_long_runs(f"{name} {tag}", getattr(ops, ROW_WRAPPER[name]), counts, failures)
            if tag == "zipf":
                e.update(t)
            else:
                e["uniform"] = t
            del store, want

    # row 4 at the dense update's shape: the padded dense vector of dlrm-small
    lo = state["dense"]["lo"]
    n = lo.numel()
    hi = dp.flat_hi(state["dense"]["hi"], n).clone()
    lo = lo.clone()
    g = torch.randn(n, device=dev) * 1e-3
    want_h, want_l = ref.split_sgd(hi.clone(), lo.clone(), g, lr)
    ops.split_sgd(hi, lo, g, lr)
    torch.cuda.synchronize()
    e = {"name": "split_sgd", "max_abs_err": max(
        bitwise_or_fail(f"split_sgd [{n}] hi", hi, want_h, failures),
        bitwise_or_fail(f"split_sgd [{n}] lo", lo, want_l, failures))}
    bms, by = bound_ms(n * 12, n * 2, FP32_FLOPS)
    # timed as CUDA graphs: an eager loop of its launches times the host's wrapper (about 19
    # us a call).  Its 30.5 MB of buffers stay in the 50 MB L2 between launches, so ``ms`` is
    # taken with the L2 flushed before each launch, as in a train step, where the update
    # follows gigabytes of table traffic and reads HBM, the bytes its bound counts; the warm
    # reading is ``ms_l2_warm``
    def kern():
        ops.split_sgd(hi, lo, g, lr)
    e.update(ms=flushed_ms(kern), ms_l2_warm=graph_ms(kern),
             plain_ms=time_ms(lambda: ref.split_sgd(hi, lo, g, lr)), bound_ms=bms, bound_by=by,
             library_ms=None)  # no PyTorch call splits fp32 into halves
    eager = time_ms(kern)
    log(f"  split_sgd [{n}]: kernel {e['ms']:.4f} ms with the L2 flushed before each launch "
        f"({bms / e['ms'] * 100:.1f}% of bound), {e['ms_l2_warm']:.4f} ms back to back in a "
        f"graph, L2 warm ({bms / e['ms_l2_warm'] * 100:.1f}%), {eager:.4f} ms an "
        f"eager launch (the host's wrapper), plain {e['plain_ms']:.4f} ms, bound {bms:.4f} ms "
        f"({by}, {n * 12 / 1e6:.1f} MB)")
    return [entries["embedding_update"], entries["embedding_update_fp32"], e]


def random_state(name, shape, dev, gen, stream):
    """A random state slab of ``name``'s optimizer (the counts bumped by
    ``stream`` first, as ``optim.row.apply_sparse`` does)."""
    import torch
    from repro_torch.optim import row as row_optim
    dtype = row_optim.get(name).state[0][2]
    if dtype == torch.int32:
        S0 = torch.randint(0, 1000, shape, device=dev, dtype=dtype, generator=gen)
        return row_optim.bump_counters(S0, stream[0], stream[2])
    if name.startswith("momentum"):
        return (torch.randn(shape, device=dev, generator=gen) * 1e-3).to(dtype)
    return (torch.rand(shape, device=dev, generator=gen) * 1e-6).to(dtype)


def seed_args(name, seed, dev) -> tuple:
    """The seed argument of a compressed-state kernel, () for the others."""
    import torch
    from repro_torch.optim import row as row_optim
    if not row_optim.get(name).stochastic_round:
        return ()
    return (torch.tensor(seed, dtype=torch.int32, device=dev),)


def stateful_kernel_phase(cfg, W32, offsets, batch, dev, rng, failures) -> list[dict]:
    """Rows 7-12: the stateful row kernels against their plain versions,
    bit for bit on ``w`` and on the state, at dlrm-small's shapes (the main
    path's first zipf batch and a uniform one, a bf16 cotangent [B * S, E])
    from a random state (the counts of ``adagrad_freq`` bumped by this
    stream first, as ``optim.row.apply_sparse`` does).  The bf16 kinds round
    at ``SR_SEEDS[0]``, then again from the same state at ``SR_SEEDS[1]``:
    the same weights, another stored state.  Timed with CUDA events; returns
    the kernel entries of the JSON line."""
    import torch
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import row as row_optim

    B, S, P, E = cfg.batch, len(cfg.table_rows), cfg.pooling, cfg.emb_dim
    rows = W32.shape[0]
    lr = cfg.lr
    ghz = sm_clock_ghz()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dY = (torch.randn((B * S, E), device=dev, generator=gen) * 1e-3).to(torch.bfloat16)
    uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                     axis=1).astype(np.int32)).to(dev)
    entries = {}
    for tag, idx in (("zipf", batch["idx"]), ("uniform", uidx)):
        stream = eu.sort_lookups((idx + offsets[None, :, None]).reshape(-1), None, rows, P)
        L = stream[0].numel()
        _, counts = torch.unique_consecutive(stream[0], return_counts=True)
        U, longest = counts.numel(), int(counts.max())
        chain_ms = longest * 4 / (ghz * 1e9) * 1e3
        log(f"stateful row updates, {tag} indices: L {L}, {U} runs, longest {longest} lookups, "
            f"serial chain {chain_ms:.4f} ms")
        for name, fn_name, hp_key in STATEFUL:
            opt = row_optim.get(name)
            key, width, dtype = opt.state[0]
            S0 = random_state(name, (rows, width or E), dev, gen, stream)
            hp = getattr(opt, hp_key)
            sr = seed_args(name, SR_SEEDS[0], dev)
            want = (W32.clone(), S0.clone())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(ref, fn_name)(*want, *stream, dY, lr, hp, *sr)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = (W32.clone(), S0.clone())
            kernel = getattr(ops, fn_name)
            kernel(*got, *stream, dY, lr, hp, *sr)
            torch.cuda.synchronize()
            kname = ROW_KERNEL[name]
            e = entries.setdefault(kname, {"name": kname, "max_abs_err": 0.0})
            for k, g, w in (("w", got[0], want[0]), (key, got[1], want[1])):
                err = bitwise_or_fail(f"{kname} [{L} lookups -> {rows}x{E}] {tag}, {k}", g, w,
                                      failures)
                e["max_abs_err"] = max(e["max_abs_err"], err)
            del want
            if sr:  # the second seed, from the same state
                sr2 = seed_args(name, SR_SEEDS[1], dev)
                want2 = getattr(ref, fn_name)(W32.clone(), S0.clone(), *stream, dY, lr, hp, *sr2)
                got2 = kernel(W32.clone(), S0.clone(), *stream, dY, lr, hp, *sr2)
                torch.cuda.synchronize()
                for k, g, w in (("w", got2[0], want2[0]), (key, got2[1], want2[1])):
                    err = bitwise_or_fail(f"{kname} {tag}, seed {SR_SEEDS[1]}, {k}", g, w, failures)
                    e["max_abs_err"] = max(e["max_abs_err"], err)
                same_w = bool(torch.equal(got2[0], got[0]))
                moved = int((got2[1].view(torch.int16) != got[1].view(torch.int16)).sum())
                log(f"  {kname} {tag}: seed {SR_SEEDS[1]} vs {SR_SEEDS[0]}: weights equal {same_w}, "
                    f"{moved} stored state values differ")
                if not same_w or not moved:
                    failures.append(f"{kname} {tag}: a second seed gave weights equal {same_w} and "
                                    f"{moved} other state values")
                del want2, got2
            # touched rows: w read and written (8 B a value); an [M, E] state
            # as much again (4 B a value in bf16), the row-wise acc 8 B a row,
            # cnt 4 B a row read; the cotangent and the sorted stream read once
            state_bytes = ({0: U * E * 2 * S0.element_size(), 1: U * 8}[width]
                           if dtype != torch.int32 else U * 4)
            nbytes = dY.numel() * 2 + L * 16 + U * E * 8 + state_bytes
            bms, by = bound_ms(nbytes, L * E * 2 + U * E * 6, FP32_FLOPS)
            t = dict(ms=time_ms(lambda: kernel(*got, *stream, dY, lr, hp, *sr)), plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, chain_ms=chain_ms, longest=longest, runs=U,
                     library_ms=None)  # no PyTorch call computes a row optimizer's fused step
            del got, S0
            log(f"  {kname} {tag}: kernel {t['ms']:.4f} ms, plain {plain_ms:.1f} ms, bound "
                f"{bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), "
                f"{t['ms'] / chain_ms:.2f}x the longest run's serial chain")
            check_long_runs(f"{kname} {tag}", kernel, counts, failures)
            if tag == "zipf":
                e.update(t)
            else:
                e["uniform"] = t
    return [entries[ROW_KERNEL[name]] for name, _, _ in STATEFUL]


def row_variants_phase(cfg, state, offsets, batch, dev, rng, failures) -> dict:
    """Rows 5-12 on the main path's first zipf batch in two variants, bit for
    bit against their plain versions on the weights and the state, timed
    beside the bound and the longest run's chain: weights U[0.5, 1.5) from
    ``rng``, zero on the last table's lookups, with a bf16 cotangent
    (weights that differ inside a bag split the groups of equal bag and
    weight that the walk sums with one load and one product); and no
    weights with an fp32 cotangent (the reference's own type, values bf16
    cannot hold).  Returns ``{kernel: {"max_abs_err", "weighted":
    {"ms", "bound_ms", "bound_by", "chain_ms"}}}`` (the error 0.0 when
    bitwise)."""
    import torch
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import row as row_optim

    B, S, P, E = cfg.batch, len(cfg.table_rows), cfg.pooling, cfg.emb_dim
    W32 = master(state["emb"])
    rows = W32.shape[0]
    ghz = sm_clock_ghz()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dY = (torch.randn((B * S, E), device=dev, generator=gen) * 1e-3)
    w = rng.uniform(0.5, 1.5, batch["idx"].shape).astype(np.float32)
    w[:, -1, :] = 0.0
    wgt = torch.from_numpy(w).to(dev)
    flat = (batch["idx"] + offsets[None, :, None]).reshape(-1)
    plain_stream = eu.sort_lookups(flat, None, rows, P)

    def groups(st):  # runs of equal (row, bag, weight) in the sorted stream
        r, b, _, w = st
        return 1 + int(((r[1:] != r[:-1]) | (b[1:] != b[:-1]) | (w[1:] != w[:-1])).sum())

    out = {}
    for tag, stream, cot in (
            ("weighted zipf", eu.sort_lookups(flat, None, rows, P, wgt.reshape(-1)),
             dY.to(torch.bfloat16)),
            ("fp32-dY zipf", plain_stream, dY)):
        L = stream[0].numel()
        _, counts = torch.unique_consecutive(stream[0], return_counts=True)
        U, longest = counts.numel(), int(counts.max())
        chain_ms = longest * 4 / (ghz * 1e9) * 1e3
        log(f"row updates, {tag}: {int(torch.unique(stream[3]).numel())} distinct weights; "
            f"{L} lookups in {groups(stream)} groups of equal (row, bag, weight) "
            f"({groups(plain_stream)} unweighted), {U} runs, longest {longest}, serial chain "
            f"{chain_ms:.4f} ms; dY {cot.dtype}")
        for name in ROW_KERNEL:
            opt = row_optim.get(name)
            if opt.split:
                store = (state["emb"]["hi"], state["emb"]["lo"])
                fn_name, extra, state_bytes = "fused_update_split", (), 0
            elif not opt.state:
                store, fn_name, extra, state_bytes = (W32,), "fused_update_fp32", (), 0
            else:
                _, width, dtype = opt.state[0]
                store = (W32, random_state(name, (rows, width or E), dev, gen, stream))
                _, fn_name, hp_key = next(k for k in STATEFUL if k[0] == name)
                extra = (getattr(opt, hp_key), *seed_args(name, SR_SEEDS[0], dev))
                state_bytes = ({0: U * E * 2 * store[1].element_size(), 1: U * 8}[width]
                               if dtype != torch.int32 else U * 4)
            kname = ROW_KERNEL[name]
            want = [t.clone() for t in store]
            getattr(ref, fn_name)(*want, *stream, cot, cfg.lr, *extra)
            got = [t.clone() for t in store]
            getattr(ops, fn_name)(*got, *stream, cot, cfg.lr, *extra)
            torch.cuda.synchronize()
            e = out.setdefault(kname, {"max_abs_err": 0.0})
            e["max_abs_err"] = max(e["max_abs_err"], *(
                bitwise_or_fail(f"{kname} {tag}, slab {i}", g, w_, failures)
                for i, (g, w_) in enumerate(zip(got, want))))
            ms = time_ms(lambda: getattr(ops, fn_name)(*got, *stream, cot, cfg.lr, *extra))
            # as in the other row phases: the touched rows read and written once,
            # the cotangent and the sorted stream read once
            nbytes = cot.numel() * cot.element_size() + L * 16 + U * E * 8 + state_bytes
            bms, by = bound_ms(nbytes, L * E * 2 + U * E * (6 if opt.state else 2), FP32_FLOPS)
            log(f"  {kname} {tag}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{ms / chain_ms:.2f}x the longest run's serial chain")
            if tag.startswith("weighted"):
                e["weighted"] = dict(ms=ms, bound_ms=bms, bound_by=by, chain_ms=chain_ms)
            del want, got, store
    return out


def stage_batches(cfg, n: int, dev) -> list[dict]:
    """n zipf(1.05) batches from the port's synthetic stream, on the card;
    with ``cfg.weighted``, weights U[0.5, 1.5) from a numpy generator."""
    import torch
    from repro_torch.data.synthetic import dlrm_stream
    rng = np.random.default_rng(SEED + 4)
    out = []
    for b, _ in zip(dlrm_stream(SEED, cfg, ALPHA), range(n)):
        out.append({"idx": torch.from_numpy(b["idx"]).to(dev),
                    "dense_x": torch.from_numpy(b["dense_x"]).to(dev).to(torch.bfloat16),
                    "labels": torch.from_numpy(b["labels"]).to(dev)})
        if cfg.weighted:
            w = rng.uniform(0.5, 1.5, b["idx"].shape).astype(np.float32)
            out[-1]["weights"] = torch.from_numpy(w).to(dev)
    return out


def training_phase(cfg, state, batches, dev, failures) -> dict:
    """The main path of training: make_train_step over the staged batches,
    every loss finite, one launch a step of each training kernel (the row
    kernel of the config's optimizer), one step without a host sync, one
    step against the same step on the CPU (every kernel's plain version)
    and its sparse update bit for bit against the plain update of the
    card's own cotangent, samples per second, and where a step's time goes.
    The timed steps run under ``set_sync_debug_mode("error")``; a state
    with ``sr`` must come out of them with ``sr`` advanced by one a step.
    Returns the launch counts of the timed steps and their samples per
    second."""
    import torch
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.kernels import ops
    from repro_torch.optim import row as row_optim

    step = dlrm.make_train_step(cfg, device=dev)
    cpu_step = dlrm.make_train_step(cfg, device="cpu")

    # one step against the plain versions, from a copy of the state on the CPU;
    # on the card the step's stages in step()'s order, keeping its cotangent
    opt = row_optim.resolve(cfg)
    ref_state = weights.state_to(state, "cpu")
    before = weights.state_to(state, "cpu")
    b0 = batches[0]
    t0 = time.perf_counter()
    ref_state, ref_loss = cpu_step(ref_state, {k: v.cpu() for k, v in b0.items()})
    cpu_s = time.perf_counter() - t0
    st = step.stages
    sr = state.get("sr")
    idx_fwd, idx_upd = st.index_exchange(b0["idx"])
    wgt_fwd, wgt_upd = st.index_exchange(b0["weights"]) if cfg.weighted else (None, None)
    emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd, wgt_fwd)
    loss, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b0)
    dY = st.dY_exchange(d_emb)
    state["emb"] = st.sparse_update(state["emb"], idx_upd, dY, wgt_upd, sr)
    state["dense"] = st.dense_update(state["dense"], g_dense)
    if sr is not None:
        sr.add_(1)
    torch.cuda.synchronize()
    log(f"one step against the plain versions on the CPU ({cpu_s:.1f} s there): loss {float(loss):.7f} "
        f"vs {float(ref_loss):.7f}")
    close_or_fail("train step loss vs plain step", loss.cpu(), ref_loss, TRAIN_TOL["loss"], 0.0,
                  failures)
    # the sparse update against its plain version on the card's own cotangent
    layout = se.make_layout(cfg.spec, 1)
    g = (idx_upd.cpu() + torch.as_tensor(layout.row_offsets, dtype=torch.int32)[None, :, None])
    plain = row_optim.apply_sparse(
        opt, {k: v.clone() for k, v in before["emb"].items()},
        se._row_sorted_streams(layout, g.reshape(-1), cfg.pooling,
                               b0["weights"].reshape(-1).cpu() if cfg.weighted else None),
        dY.reshape(-1, cfg.emb_dim).cpu(), cfg.lr, seed=before.get("sr"))
    for k, v in plain.items():
        bitwise_or_fail(f"train step, {k} vs the plain update of the card's cotangent",
                        state["emb"][k], v.to(dev), failures)
    parts = [("dense weights", dense_master(state["dense"]).cpu(), dense_master(ref_state["dense"]),
              dense_master(before["dense"]))]
    got_w, want_w = master(state["emb"]), card_master(ref_state["emb"], dev)
    old_w = card_master(before["emb"], dev)
    if opt.state_keys:
        # The stateful kinds' stores are compared and not held.  Adagrad
        # scales each row's step by 1 / sqrt(acc): a row whose few cotangents
        # the card and the CPU compute apart, relative to the row's own size
        # (the dense network's sums in other orders, with bf16 between its
        # layers), takes a full step in another direction.  The weighted
        # momentum cell's hot rows sum some 200 K such cotangents, each
        # scaled by its weight, and a few values end up past 1e-2 of the
        # largest update.  The cotangent's path is held by the loss and the
        # dense weights, the update by the bitwise check.
        d, upd = (got_w - want_w).abs(), float((want_w - old_w).abs().max())
        log(f"  train step, embedding store vs plain step (not held, above): max_abs_err "
            f"{float(d.max()):.3e}, largest update {upd:.3e}, "
            f"{int((d > TRAIN_TOL['update'] * upd).sum())} values beyond {TRAIN_TOL['update']:g} of it")
    else:
        parts.insert(0, ("embedding store", got_w, want_w, old_w))
    for part, got, want, old in parts:
        upd = float((want - old).abs().max())
        close_or_fail(f"train step, {part} vs plain step (atol {TRAIN_TOL['update']:g} x the "
                      f"largest update, {upd:.3e})", got, want, 0.0, TRAIN_TOL["update"] * upd,
                      failures)
    del ref_state, before, plain, got_w, want_w, old_w

    # no host sync between the batch's arrival and the returned loss
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batches[1])
    except RuntimeError as e:
        failures.append(f"the train step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("one train step under torch.cuda.set_sync_debug_mode('error'): no host sync")

    sr0 = state["sr"].clone() if "sr" in state else None
    ops.reset_launches()
    losses = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss)
    except RuntimeError as e:
        failures.append(f"a timed train step synchronised with the host: {e}")
        return ops.launches(), 0.0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    losses = torch.stack(losses).cpu().numpy()
    n = len(batches)
    log(f"{opt.name} at lr {cfg.lr:g}: trained {n} steps of B={cfg.batch} in {wall:.3f} s: "
        f"{n * cfg.batch / wall:.0f} samples/s, "
        f"{wall / n * 1e3:.2f} ms a step; losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    log(f"losses: {np.array2string(losses, precision=6, max_line_width=200)}")
    log(f"kernel launches in {n} steps: {counts}")
    if not np.isfinite(losses).all():
        failures.append(f"a loss is not finite: {losses}")
    want = {**{k: 0 for k in counts}, "embedding_bag": n, "dot_interaction": n,
            ROW_KERNEL[opt.name]: n, "split_sgd": n}
    if counts != want:
        failures.append(f"launches {counts}, want {want} (one a step, fused_mlp none)")
    if sr0 is not None:
        sr_from, sr_to = int(sr0), int(state["sr"])
        log(f"sr: {sr_from} -> {sr_to} over {n} steps under set_sync_debug_mode('error')")
        if sr_to - sr_from != n:
            failures.append(f"sr advanced from {sr_from} to {sr_to} in {n} steps")

    # where a step's time goes: the stages one by one between CUDA events
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    names = ("sort", "bag fwd", "dense fwd+bwd", "row update", "dense update")
    totals = dict.fromkeys(names, 0.0)
    reps = 5
    for b in batches[:reps]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        g = (b["idx"] + offsets[None, :, None]).reshape(-1)
        wgt = b.get("weights")
        stream = se._row_sorted_streams(layout, g, cfg.pooling,
                                        None if wgt is None else wgt.reshape(-1))
        ev[1].record()
        emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), b["idx"], wgt)
        ev[2].record()
        _, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b)
        dY = st.dY_exchange(d_emb)
        ev[3].record()
        row_optim.apply_sparse(opt, state["emb"], stream, dY.reshape(-1, cfg.emb_dim), cfg.lr,
                               seed=state.get("sr"))
        ev[4].record()
        state["dense"] = st.dense_update(state["dense"], g_dense)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            totals[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    log("a step by stage (ms, CUDA events, mean of 5): "
        + "; ".join(f"{k} {v:.3f}" for k, v in totals.items()))
    # the bag stage is one launch: no elementwise kernel for the offset add or the round.
    # The launch counters say how often the bag kernel ran; a CUDA graph of one call says
    # that nothing else was enqueued (torch.profiler's trace was tried first and dropped
    # launches of a window this short, at times more than half of them).
    W_fwd, b0 = row_optim.fwd_weights(opt, state["emb"]), batches[0]
    bag_call = lambda: st.embedding_fwd(W_fwd, b0["idx"], b0.get("weights"))  # noqa: E731
    ops.reset_launches()
    bag_nodes = graph_nodes(bag_call)
    stage_counts = ops.launches()
    log(f"bag stage: {graph_ms(bag_call):.4f} ms device a call (CUDA graph); one call's graph "
        f"holds {bag_nodes}; launch counts in 2 calls: {stage_counts}")
    if bag_nodes != {"kernel": 1}:
        failures.append(f"one call of the bag stage enqueued {bag_nodes}, want one kernel alone")
    if stage_counts != {**{k: 0 for k in stage_counts}, "embedding_bag": 2}:
        failures.append(f"the bag stage launched {stage_counts} in 2 calls, "
                        "want the bag kernel once a call")
    it = iter(batches[:reps])
    wall_ms, busy_ms, top = device_busy_ms(lambda: step(state, next(it)), reps)
    log(f"train step under torch.profiler: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: " + top_kernels(top[:8]))
    return counts, n * cfg.batch / wall


def short_phase(cfg, dev, batches, failures) -> dict:
    """A few steps of ``cfg``'s optimizer from a fresh state: every loss
    finite and its row kernel launched once a step, no other row kernel.
    Returns the launch counts of those steps."""
    import torch
    from repro_torch.core import dlrm
    from repro_torch.kernels import ops
    name = cfg.sparse_optimizer
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    state = dlrm.init_state(cfg, gen, device=dev)
    log(f"{name} state: " + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in state["emb"].items())
        + f", {sum(v.numel() * v.element_size() for v in state['emb'].values()) / 1e9:.3f} GB")
    step = dlrm.make_train_step(cfg, device=dev)
    ops.reset_launches()
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = ops.launches()
    losses = torch.stack(losses).cpu().numpy()
    log(f"{name}: {len(batches)} steps at lr {cfg.lr:g}, losses {losses}; launches {counts}")
    if not np.isfinite(losses).all():
        failures.append(f"{name}: a loss is not finite: {losses}")
    rows = {k: counts[k] for k in ROW_KERNEL.values()}
    if rows != {**{k: 0 for k in rows}, ROW_KERNEL[name]: len(batches)}:
        failures.append(f"{name}: launches {counts}")
    del state, step
    torch.cuda.empty_cache()
    return counts


def state_bytes(state) -> int:
    from repro_torch.optim import data_parallel as dp
    return sum(t.numel() * t.element_size() for t in dp.tree_leaves(state))


def bitwise_equal(a, b) -> bool:
    """Two train states (or leaves) bit for bit."""
    import torch
    from repro_torch.optim import data_parallel as dp
    la, lb = dp.tree_leaves(a), dp.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def run_loop_phase(cfg, dev, bare_rate, failures) -> dict:
    """The run loop at full width: ``TrainLoop`` with verified checkpoints,
    a restore, a corrupt-checkpoint fallback and the eval step.

    Run A trains a state S0 (seed 0) for ``RUN_STEPS`` loop steps without a
    checkpoint.  Run B is the quickstart's contract: ``RUN_RESTART`` steps
    from a copy of S0 with a checkpoint every ``RUN_CKPT_EVERY`` (keep 2,
    prefetch 2, a heartbeat), then a second loop built on a state from
    another seed restores the newest checkpoint and trains on to
    ``RUN_STEPS``.  Both read one pool of ``N_TRAIN`` numpy batches in turn,
    through prefetch's pinned copies.  Gates: the restore lands at
    ``RUN_RESTART``, equals the first loop's state bit for bit and keeps the
    dense ``hi`` leaves in one buffer; run B's later losses and final state
    equal run A's bit for bit (if two runs A differ, the card is not
    deterministic, and the losses are held within 1e-6 relative instead);
    every loss finite.  Then the newest checkpoint is corrupted, a fresh
    manager must fall back to ``RUN_RESTART``, and the eval step scores a
    batch of the restored state: finite, in (0, 1), its logits within
    ``LOGIT_TOL`` of the plain forward on the CPU.  Returns the launch counts
    of run B and the eval step."""
    import itertools
    import shutil
    import torch
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.faults import corrupt_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.optim import data_parallel as dp
    from repro_torch.train import TrainLoop, TrainLoopConfig

    ckdir = ROOT / "build" / "run_loop"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.mkdir(parents=True)
    try:
        S0 = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        need, free = 3 * state_bytes(S0), shutil.disk_usage(ckdir).free
        log(f"run loop: checkpoints in {ckdir}: {free / 1e9:.2f} GB free, 3 checkpoints of "
            f"{state_bytes(S0) / 1e9:.3f} GB need {need / 1e9:.2f} GB")
        if free < need:
            failures.append(f"run loop: {free / 1e9:.2f} GB free in {ckdir}, 3 checkpoints need "
                            f"{need / 1e9:.2f} GB")
            return {}
        pool = [b for b, _ in zip(dlrm_stream(SEED, cfg, ALPHA), range(N_TRAIN))]

        def batches(start):
            return (pool[i % N_TRAIN] for i in itertools.count(start))

        step = dlrm.make_train_step(cfg, device=dev)

        def loop_cfg(steps, **kw):
            return TrainLoopConfig(**{"steps": steps, "log_every": RUN_CKPT_EVERY, "prefetch": 2,
                                      "straggler_window": RUN_STEPS, **kw})

        def run_a(tag):
            loop = TrainLoop(loop_cfg(RUN_STEPS), step, weights.state_to(S0, dev), batches(0),
                             device=dev)
            t0 = time.perf_counter()
            loop.run()
            wall = time.perf_counter() - t0
            log(f"run {tag}: {RUN_STEPS} loop steps, no checkpoint, {wall:.2f} s: "
                f"{RUN_STEPS * cfg.batch / wall:.0f} samples/s wall; losses "
                f"{loop.losses[0]:.6f} -> {loop.losses[-1]:.6f}")
            return loop

        run = run_a("A")
        hb = ckdir / "heartbeat.jsonl"
        ckpt_kw = dict(ckpt_dir=str(ckdir / "ckpt"), ckpt_every=RUN_CKPT_EVERY, keep=2,
                       heartbeat_path=str(hb))
        torch.cuda.synchronize()
        ops.reset_launches()
        first = TrainLoop(loop_cfg(RUN_RESTART, **ckpt_kw), step, weights.state_to(S0, dev),
                          batches(0), device=dev)
        t0 = time.perf_counter()
        first.run()
        first_wall = time.perf_counter() - t0
        other = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 7),
                                device=dev)
        t0 = time.perf_counter()
        second = TrainLoop(loop_cfg(RUN_STEPS, **ckpt_kw), step, other, batches(RUN_RESTART),
                           device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del other
        restored = second.state
        same = bitwise_equal(restored, first.state)
        flat = dp.flat_hi(restored["dense"]["hi"], restored["dense"]["lo"].numel())
        log(f"restart: start_step {second.start_step}, verify + restore {restore_s:.2f} s; the "
            f"restored state bit for bit the first loop's: {same}; dense hi one flat buffer: "
            f"{flat is not None}")
        if second.start_step != RUN_RESTART or not same or flat is None:
            failures.append(f"restart: start_step {second.start_step} (want {RUN_RESTART}), "
                            f"bitwise {same}, flat hi {flat is not None}")
            return {}
        t0 = time.perf_counter()
        second.run()
        second_wall = time.perf_counter() - t0
        losses = first.losses + second.losses
        if not np.isfinite(losses).all():
            failures.append(f"run B: a loss is not finite: {losses}")
        later_same = losses[RUN_RESTART:] == run.losses[RUN_RESTART:]
        state_same = bitwise_equal(second.state, run.state)
        log(f"run B against run A: losses {RUN_RESTART}-{RUN_STEPS - 1} bitwise {later_same}, "
            f"final state bitwise {state_same}; all {RUN_STEPS} losses bitwise "
            f"{losses == run.losses}")

        # the corruption drill: the newest checkpoint fails its checksums
        mgr_dir = ckdir / "ckpt"
        steps_on_disk = CheckpointManager(mgr_dir).steps()
        corrupt_checkpoint(mgr_dir, RUN_STEPS, "flip")
        mgr = CheckpointManager(mgr_dir)
        t0 = time.perf_counter()
        fallback = mgr.latest_valid_step()
        at, back = mgr.restore(second.state, device=dev)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        back_same = bitwise_equal(back, first.state)
        log(f"corruption drill: steps on disk {steps_on_disk}, step {RUN_STEPS} flipped; "
            f"latest_valid_step {fallback}, restored step {at} in {drill_s:.2f} s (two scans "
            f"of the steps, the restore's checking the arrays it loads), bit for bit the first "
            f"loop's state: {back_same}")
        if fallback != RUN_RESTART or at != RUN_RESTART or not back_same:
            failures.append(f"corruption drill: fell back to {fallback}, restored {at}, "
                            f"bitwise {back_same}")

        # the eval step on the restored state, held to the plain forward on the CPU
        b0 = {k: torch.from_numpy(v).to(dev) for k, v in pool[0].items()}
        b0["dense_x"] = b0["dense_x"].to(torch.bfloat16)
        scores = dlrm.make_eval_step(cfg, device=dev)(back, b0)
        torch.cuda.synchronize()
        counts = ops.launches()
        snap = {"emb_w": back["emb"]["hi"].cpu(),
                "dense_hi": dp.tree_unflatten(back["dense"]["hi"],
                                              [t.cpu() for t in dp.tree_leaves(back["dense"]["hi"])])}
        offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32)
        want = plain_logits(cfg, snap, {k: v.cpu() for k, v in b0.items()}, offsets)
        inside = bool(((scores > 0) & (scores < 1)).all())
        log(f"eval step: scores {tuple(scores.shape)}, mean {float(scores.mean()):.6f}, "
            f"in (0, 1): {inside}")
        close_or_fail("eval logits vs the plain forward on the CPU",
                      torch.logit(scores.double()).cpu(), want.double(), 0.0, LOGIT_TOL, failures)
        if not inside:
            failures.append("eval: a score is outside (0, 1)")

        n = RUN_STEPS + 1
        want_counts = {**{k: 0 for k in counts}, "embedding_bag": n, "dot_interaction": n,
                       "embedding_update": RUN_STEPS, "split_sgd": RUN_STEPS}
        log(f"launches in run B ({RUN_STEPS} loop steps) and one eval step: {counts}")
        if counts != want_counts:
            failures.append(f"run loop launches {counts}, want {want_counts}")

        if not (later_same and state_same):
            again = run_a("A again")
            det = again.losses == run.losses and bitwise_equal(again.state, run.state)
            diff = [i for i, (x, y) in enumerate(zip(again.losses, run.losses)) if x != y]
            log(f"two runs A bit for bit: {det}; first loss apart at step "
                f"{diff[0] if diff else None}")
            if det:
                failures.append("run B's later losses or final state differ from run A's, and "
                                "two runs A agree bit for bit")
            else:
                rel = max(abs(x / y - 1) for x, y in zip(losses[RUN_RESTART:],
                                                         run.losses[RUN_RESTART:]))
                log(f"the card is not deterministic across runs: run B's later losses within "
                    f"{rel:.3e} relative of run A's (held to 1e-6)")
                if rel > 1e-6:
                    failures.append(f"run B's later losses {rel:.3e} relative of run A's")
            del again

        # where the time goes
        dts = np.asarray(list(first.monitor.times) + list(second.monitor.times)) * 1e3
        saves = first.ckpt.copy_durations + second.ckpt.copy_durations
        writes = first.ckpt.save_durations + second.ckpt.save_durations
        npz = (mgr_dir / f"step_{RUN_RESTART}" / "arrays.npz").stat().st_size
        rate = RUN_STEPS * cfg.batch / (dts.sum() / 1e3)
        wall = first_wall + second_wall
        log(f"run B: {rate:.0f} samples/s by the loop's own step times, step ms p50 "
            f"{np.percentile(dts, 50):.3f} p99 {np.percentile(dts, 99):.3f}; "
            f"{RUN_STEPS * cfg.batch / wall:.0f} samples/s over both runs' wall "
            f"({first_wall:.2f} + {second_wall:.2f} s, of which {wall - dts.sum() / 1e3:.2f} s "
            f"outside the steps: saves, joins of the writer, batches); the bare step "
            f"{bare_rate:.0f} samples/s (training phase)")
        log(f"saves: {len(saves)}, ms from each host copy's start to its landing (pinned, "
            f"behind the step's kernels) " + ", ".join(f"{x * 1e3:.1f}" for x in saves)
            + "; write + CRC s " + ", ".join(f"{x:.2f}" for x in writes)
            + f"; {len(writes) * npz / 1e9:.2f} GB written ({npz / 1e9:.3f} GB a checkpoint)")
        for tag, loop in (("first", first), ("second", second)):
            st = loop.batches.stats
            log(f"prefetch ({tag} loop): prep_s {st['prep_s']:.3f}, wait_s {st['wait_s']:.3f}, "
                f"batches {st['batches']}")
        log("heartbeat: " + hb.read_text().splitlines()[-1])
        del first, second, back, restored
        torch.cuda.empty_cache()
        # the loop's steps under the profiler, on run A's state
        wall_ms, busy_ms, _ = device_busy_ms(
            lambda: TrainLoop(loop_cfg(10, log_every=100), step, run.state, batches(0),
                              device=dev).run(), 1)
        log(f"10 loop steps under torch.profiler: {wall_ms / 10:.3f} ms wall a step, device busy "
            f"{busy_ms / 10:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); "
            + nvidia_smi())
        return counts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of ``want``'s own value."""
    import torch
    w = want.float().abs().clamp_min(2.0 ** -126)
    return (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(w)) - 7)


def visible_pairs(Lq: int, Lk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs attention computes for one head: query i at
    key position Lk - Lq + i sees the keys its mask lets through."""
    p = np.arange(Lq, dtype=np.int64) + (Lk - Lq)
    hi = np.minimum(p, Lk - 1) if causal else np.full(Lq, Lk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(Lq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_kernel_phase(dev, failures) -> dict:
    """The flash kernel against its plain version on the card at each of
    ATTN_CASES, timed with CUDA events beside its bound (the visible pairs'
    two products at the bf16 tensor rate against q, k, v and o read or
    written once), the plain version's time and, at the main path's shape,
    ``F.scaled_dot_product_attention`` (the yardstick; the port never calls
    it).  Returns the kernel's entry of the JSON line, at the main path's
    shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    entry = {"name": "flash_attention", "max_abs_err": 0.0}
    for case, B, H, Hkv, Lq, Lk, causal, window, softcap in ATTN_CASES:
        D = 128
        q = torch.randn((B, H, Lq, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, Hkv, Lk, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention(q, k, v, **kw)
        tag = (f"flash_attention {case}: q [{B},{H},{Lq},{D}], k/v [{B},{Hkv},{Lk},{D}], "
               f"causal {causal}, window {window}, softcap {softcap:g}")
        err = close_or_fail(tag, got, want, *ATTN_TOL, failures)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        unequal = float((got != want).float().mean())
        past_ulp = float((bf16_ulps(got, want) > 1).float().mean())
        if unequal > ATTN_MAX_UNEQUAL or past_ulp > ATTN_MAX_PAST_ULP:
            failures.append(f"{case}: {unequal:.3%} of outputs not equal, {past_ulp:.3%} more "
                            f"than one bf16 ulp apart (at most {ATTN_MAX_UNEQUAL:.2%} and "
                            f"{ATTN_MAX_PAST_ULP:.2%})")
        blind = list(range(Lq - Lk)) if causal else []   # queries left of every key
        if blind and not bool((got[:, :, blind] == 0).all()):
            failures.append(f"{case}: a query that sees no key did not give 0")
        pairs = B * H * visible_pairs(Lq, Lk, causal, window)
        nbytes = 2 * (2 * B * H * Lq * D + 2 * B * Hkv * Lk * D)
        bms, by = bound_ms(nbytes, 4.0 * pairs * D, BF16_TENSOR_FLOPS)
        t = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                 plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, **kw), iters=3, warmup=1),
                 bound_ms=bms, bound_by=by, library_ms=None)
        if case == ATTN_CASES[0][0]:
            t["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            entry.update(t)
        lib = "" if t["library_ms"] is None else f", SDPA {t['library_ms']:.4f} ms"
        log(f"  {unequal * 100:.4f}% of outputs not equal, {past_ulp * 100:.4f}% more than one "
            f"bf16 ulp apart; {len(blind)} queries see no key; "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.2f} ms{lib}, bound {bms:.4f} ms "
            f"({by}), {bms / t['ms'] * 100:.1f}% of bound, "
            f"{4.0 * pairs * D / t['ms'] / 1e9:.1f} TFLOP/s")
    return entry


def param_total(tree: dict) -> int:
    return sum(param_total(v) if isinstance(v, dict) else v.numel() for v in tree.values())


def microbatches(cfg, B: int) -> int:
    """The chunks ``make_prefill_step`` runs a batch of B in."""
    mb = max(1, min(cfg.prefill_microbatch, B))
    while B % mb:
        mb -= 1
    return mb


@contextlib.contextmanager
def attention_as(fn):
    """The transformer's flash-attention call replaced by ``fn`` inside the
    context."""
    from repro_torch.models import attention
    kernel = attention.ops.flash_attention
    attention.ops.flash_attention = fn
    try:
        yield
    finally:
        attention.ops.flash_attention = kernel


class MoeTally:
    """Inside ``with tally:``, every ``transformer.moe_block`` call also
    tallies its routing (``moe_route`` again, outside the block): pairs,
    dropped pairs and the largest expert load of a sequence over the mean
    load (L k / E).  Not on a timed path."""

    def __init__(self):
        self.pairs = self.dropped = 0
        self.max_load = 0.0

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.block = block = tf.moe_block

        def tallied(x, p, cfg):
            import torch
            _, eidx, _, keep, _, _ = tf.moe_route(x, p["router"], cfg)
            B, L, k = eidx.shape
            load = torch.zeros((B, cfg.n_experts), device=x.device).scatter_add_(
                1, eidx.reshape(B, -1), torch.ones((B, L * k), device=x.device))
            self.pairs += keep.numel()
            self.dropped += int((~keep).sum())
            self.max_load = max(self.max_load, float(load.max()) * cfg.n_experts / (L * k))
            return block(x, p, cfg)
        tf.moe_block = tallied
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf.moe_block = self.block
        return False

    def share(self) -> float:
        return self.dropped / max(self.pairs, 1)


class AttnTap:
    """Inside ``with tap:``, every flash-attention call of the transformer
    runs the kernel, then ``plain`` (the kernel's plain version, or a fault
    planted in it) on the same q, k, v, and holds the two by phase 14's
    gates (each output within ATTN_TOL, at most ATTN_MAX_UNEQUAL of them not
    equal and ATTN_MAX_PAST_ULP past one bf16 ulp); the kernel's output goes
    on.  ``bad`` lists the calls outside the gates."""

    def __init__(self, plain):
        self.plain, self.calls, self.bad = plain, 0, []
        self.err = self.unequal = self.past = 0.0

    def __enter__(self):
        from repro_torch.models import attention
        self.kernel = kernel = attention.ops.flash_attention

        def tapped(q, k, v, **kw):
            got, want = kernel(q, k, v, **kw), self.plain(q, k, v, **kw)
            d = (got.float() - want.float()).abs()
            outside = bool((d > ATTN_TOL[1] + ATTN_TOL[0] * want.float().abs()).any())
            unequal = float((got != want).float().mean())
            past = float((bf16_ulps(got, want) > 1).float().mean())
            self.err = max(self.err, float(d.max()))
            self.unequal, self.past = max(self.unequal, unequal), max(self.past, past)
            if outside or unequal > ATTN_MAX_UNEQUAL or past > ATTN_MAX_PAST_ULP:
                self.bad.append(self.calls)
            self.calls += 1
            return got
        attention.ops.flash_attention = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.ops.flash_attention = self.kernel
        return False


class LastTokenAttn:
    """Inside ``with rec:``, every ``transformer.attn_block`` call keeps its
    input's and its output's last token ([b, 1, d] each), in call order."""

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.block = block = tf.attn_block
        self.calls = []

        def kept(x, ap, cfg, positions, window):
            o, entry = block(x, ap, cfg, positions, window)
            self.calls.append((x[:, -1:].clone(), o[:, -1:].clone()))
            return o, entry
        tf.attn_block = kept
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf.attn_block = self.block
        return False

    def layer(self, i: int, n_layers: int) -> tuple:
        """Layer i's input and output, the prefill's microbatches joined."""
        import torch
        parts = self.calls[i::n_layers]
        return torch.cat([z for z, _ in parts]), torch.cat([h for _, h in parts])


def decode_attn_check(cfg, params, rec, cache, at: int) -> tuple[float, int]:
    """Each layer's decode attention (``transformer._decode_attn``) on the
    last token's recorded input, writing its entry at position ``at`` of
    that layer's recorded cache (a copy), against the recorded output: the
    largest gap over the layer's largest output, and the layers outside
    DECODE_ATTN_TOL."""
    import torch
    from repro_torch.models import transformer as tf
    worst, bad = 0.0, 0
    for i, (stack, j, _, _, w) in enumerate(tf._layer_plan(cfg)):
        z, want = rec.layer(i, cfg.n_layers)
        pos = torch.full((z.shape[0],), at, dtype=torch.long, device=z.device)
        got = tf._decode_attn(z, tf._layer(params[stack], j)["attn"],
                              {k: c[i].clone() for k, c in cache.items()}, cfg, pos,
                              w if w > 0 else 1 << 30)
        d = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        bad += bool((d > DECODE_ATTN_TOL[0] * want.float().abs()
                     + DECODE_ATTN_TOL[1] * scale).any())
        worst = max(worst, float(d.max()) / scale)
    return worst, bad


def largest_divisor(n: int, at_most: int) -> int:
    return max(c for c in range(1, min(n, at_most) + 1) if n % c == 0)


class MoeRoutes:
    """An MoE model's discrete routing pinned from one run to others.
    Inside ``record()`` every ``transformer.moe_route`` call's experts,
    slots, kept pairs and capacity are kept; inside ``replay(part)`` each
    call takes its counterpart's ("all": the same call; "head": the same
    call cut to its first L tokens, a causal cut since a pair's slot counts
    only earlier pairs; "last": the same layer's last token, the recorded
    microbatches joined), its gates recomputed from its own router's
    probabilities at those experts.  The top-k choice is not continuous: an
    input one bf16 step away flips a choice between near-equal experts, and
    that token's output moves by an expert's whole share, which no tolerance
    holds; all that is continuous stays the run's own.  ``flips`` counts the
    tokens whose own top-k set differed from the pinned one."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []
        self.flips = self.tokens = 0

    def record(self):
        return self._patched(None)

    def replay(self, part: str):
        return self._patched(part)

    @contextlib.contextmanager
    def _patched(self, part):
        from repro_torch.models import transformer as tf
        route = tf.moe_route
        self.part, self.i = part, 0

        def patched(x, router, cfg):
            got = route(x, router, cfg)
            if part is None:
                self.calls.append((got[1], got[2], got[3], got[5]))
                return got
            return self._pinned(x, router, got[1])
        tf.moe_route = patched
        try:
            yield self
        finally:
            tf.moe_route = route

    def _pinned(self, x, router, own):
        import torch
        from repro_torch.models.attention import _softmax
        k, E = self.cfg.top_k, self.cfg.n_experts
        L = x.shape[1]
        if self.part == "last":
            n_moe = self.cfg.n_layers - self.cfg.first_dense_layers
            recs = self.calls[self.i::n_moe]
            eidx, slot, keep = (torch.cat([r[j] for r in recs]) for j in range(3))
            eidx, slot, keep, C = eidx[:, -1:], slot[:, -k:], keep[:, -k:], recs[0][3]
        else:
            eidx, slot, keep, C = self.calls[self.i]
            eidx, slot, keep = eidx[:, :L], slot[:, :L * k], keep[:, :L * k]
        self.i += 1
        self.flips += int((own.sort(-1).values != eidx.sort(-1).values).any(-1).sum())
        self.tokens += own.shape[0] * own.shape[1]
        gate = _softmax(x.float() @ router.float()).gather(-1, eidx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        dest = torch.where(keep, eidx.reshape(keep.shape) * C + slot, E * C)
        return gate, eidx, slot, keep, dest, C



def lm_phase(cfg, dev, failures, tag: str, *, yardstick: bool = False,
             long_prefill: bool = False, moe_check: bool = False) -> dict:
    """One LM at full width on the card (bf16 weights drawn on the card from
    a seeded generator), served through ``lm_steps``: LM_BATCH prompts of
    LM_PROMPT tokens through ``make_prefill_step`` (time to first token;
    with ``attn_impl="pallas"`` exactly one flash launch a layer and a
    prefill microbatch), LM_DECODE greedy steps through ``make_decode_step``
    on the cache grown to LM_PROMPT + LM_DECODE (no kernel launch), every
    logit finite; the decode step's device busy time (torch.profiler).  On
    the kernel path, a dense model: the prefill's logits and cache held to
    the same prefill with the kernel's plain version in its place, and again
    with two faults planted in it, which must fail; an MoE model (no
    whole-model gate holds, see below): the kernel held to its plain version
    on every call of the prefill (:class:`AttnTap`), each fault failing it,
    and the whole model's distances logged with the routing pinned
    (:class:`MoeRoutes`).  Every model: each layer's decode attention held
    to a prefill of LM_PROMPT + 1 tokens on that prefill's input and cache
    (:func:`decode_attn_check`), a control at the position before failing
    it; a dense model's first decode step held to that prefill's logits, an
    MoE model's logged with its routing pinned.  An MoE model's drop share
    is tallied in the warm-up prefill (:class:`MoeTally`).  With
    ``yardstick`` the plain prefill against the chunked path's and the
    prefill's busy time, with ``long_prefill`` one prefill of LM_LONG
    tokens, with ``moe_check`` :func:`moe_layer_check`; the flash kernel
    alone at the model's shapes (:func:`flash_at_model`).  Frees its
    tensors.  Returns the launch counts of the main path's run and the
    phase's numbers."""
    import torch
    from repro_torch import weights
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm_steps

    B, L, N = LM_BATCH, LM_PROMPT, LM_DECODE
    kernel = cfg.attn_impl == "pallas"
    mb = microbatches(cfg, B)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers; the card has {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free ({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by "
        "this process)")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = weights.init_lm_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    nparams = param_total(params)
    log(f"{cfg.name}: {nparams} parameters, {nparams * 2 / 1e9:.3f} GB bf16, drawn in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.active_param_count()} active a token")
    # param_count leaves out the final norm and MLA's two norms a layer
    norms = cfg.d_model + cfg.n_layers * (cfg.q_lora + cfg.kv_lora) * cfg.mla
    if nparams != cfg.param_count() + norms:
        failures.append(f"{nparams} parameters, the config counts {cfg.param_count()} + {norms}")
    prefill, _ = lm_steps.make_prefill_step(cfg, B, L, device=dev)
    decode, (_, cstructs, _, _) = lm_steps.make_decode_step(cfg, B, L + N, device=dev)
    tally = MoeTally()
    with tally:   # warm-up: cuBLAS's plans for these shapes; an MoE model's drops tallied
        prefill(params, toks)
    torch.cuda.synchronize()
    out = {"model": cfg.name, "layers": cfg.n_layers, "gb": nparams * 2 / 1e9}
    if cfg.moe:
        out.update(dropped_share=tally.share(), max_load=tally.max_load)
        log(f"  MoE at capacity factor {cfg.capacity_factor:g}: {tally.dropped} of {tally.pairs} "
            f"(token, expert) pairs dropped ({tally.share() * 100:.3f}%); the largest expert "
            f"load of a sequence {tally.max_load:.2f} times the mean")

    # the main path: prefill, then greedy decode, the counts read after both
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    nxt = logits.argmax(-1).to(torch.int32)
    first = nxt.cpu()
    ttft = time.perf_counter() - t0

    def grown(c, Lmax):
        g = {k: torch.zeros(t.shape[:-2] + (Lmax, t.shape[-1]), dtype=t.dtype, device=dev)
             for k, t in c.items()}
        for k in g:
            g[k][..., :L, :] = c[k]
        return g

    big = grown(cache, L + N)
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    step_logits = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(N):
        o, big = decode(params, big, nxt, pos)
        step_logits.append(o if i == 0 else o.isfinite().all())
        nxt = o.argmax(-1).to(torch.int32)
        pos = pos + 1
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) / N * 1e3
    counts = ops.launches()
    log(f"prefill {B} x {L} tokens: time to first token {ttft * 1e3:.2f} ms "
        f"({B * L / ttft:.0f} tokens/s); {N} greedy decode steps: {decode_ms:.3f} ms a step "
        f"({B / decode_ms * 1e3:.1f} tokens/s); launches {counts}")
    out.update(ttft_ms=ttft * 1e3, prefill_tokens_s=B * L / ttft, decode_ms=decode_ms,
               flash_launches=counts["flash_attention"])
    want = {**{k: 0 for k in counts}, "flash_attention": cfg.n_layers * mb if kernel else 0}
    if counts != want:
        failures.append(f"{cfg.name} serving launches {counts}, want {want} (one a layer and a "
                        f"microbatch in the prefill, {mb} microbatches)")
    finite = bool(logits.isfinite().all()) and all(bool(f) for f in step_logits[1:]) \
        and bool(step_logits[0].isfinite().all())
    if tuple(logits.shape) != (B, cfg.vocab) or not finite:
        failures.append(f"{cfg.name} logits: shape {tuple(logits.shape)}, all finite {finite}")
    log(f"prefill logits: |max| {float(logits.abs().max()):.4f}, std {float(logits.std()):.4f}; "
        f"first tokens {first.tolist()}, last tokens {nxt.tolist()}")
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    wall_ms, busy_ms, top = device_busy_ms(lambda: decode(params, big, nxt, pos), 2)
    log(f"decode step under torch.profiler: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: " + top_kernels(top[:6]))
    out.update(decode_busy_ms=busy_ms, decode_idle=1 - busy_ms / wall_ms)
    del big
    torch.cuda.empty_cache()

    def cache_gap(a, b):
        return max(float((a[k][i].float() - b[k][i].float()).abs().max())
                   for k in a for i in range(cfg.n_layers))

    # two faults planted in the plain attention, which every gate must reject
    def wrong_kv_head(q, k, v, **kw):   # head h reads KV head h % Hkv, not h // (H / Hkv)
        idx = torch.arange(q.shape[1], device=q.device) % k.shape[1]
        return ref.flash_attention(q, k[:, idx], v[:, idx], **kw)

    def diagonal_masked(q, k, v, **kw):  # query at p sees keys < p, not <= p
        return ref.flash_attention(q, k[:, :, :-1], v[:, :, :-1], **kw)

    faults = (("KV head h % Hkv", wrong_kv_head), ("diagonal masked", diagonal_masked))
    if kernel and not cfg.moe:   # the prefill with the kernel's plain version in its place
        with attention_as(ref.flash_attention):
            p_logits, p_cache = prefill(params, toks)
        close_or_fail(f"prefill logits, kernel against plain attention [{B},{cfg.vocab}]",
                      logits, p_logits, 0.0, LM_TOL, failures)
        gap = cache_gap(cache, p_cache)
        log(f"  prefill k and v cache, kernel against plain attention [{cfg.n_layers},{B},"
            f"{cfg.n_kv_heads},{L},{cfg.d_head}]: max_abs_err {gap:.3e} (atol {LM_TOL:g}); "
            f"top-1 tokens equal in {int((logits.argmax(-1) == p_logits.argmax(-1)).sum())} of "
            f"{B}; last layer's v cache max_abs_err "
            f"{float((cache['v'][-1].float() - p_cache['v'][-1].float()).abs().max()):.3e}")
        out.update(plain_logit_gap=float((logits - p_logits).abs().max()), plain_cache_gap=gap)
        if not gap <= LM_TOL:
            failures.append(f"prefill cache: max_abs_err {gap:.3e} past {LM_TOL:g}")
        del p_cache
        if yardstick:
            chunked, _ = lm_steps.make_prefill_step(dataclasses.replace(cfg, attn_impl="chunked"),
                                                    B, L, device=dev)
            c_logits, _ = chunked(params, toks)
            log(f"  the yardstick, plain against chunked attention: max_abs_err "
                f"{float((p_logits - c_logits).abs().max()):.3e}")
        torch.cuda.empty_cache()
        for name, fault in faults:   # the gates' power
            with attention_as(fault):
                f_logits, f_cache = prefill(params, toks)
            lgap, cgap = float((f_logits - logits).abs().max()), cache_gap(f_cache, cache)
            log(f"  planted fault, {name}: logits max_abs_err {lgap:.3e}, cache {cgap:.3e}")
            if not (lgap > LM_TOL and cgap > LM_TOL):
                failures.append(f"planted fault {name} passes the LM gate ({lgap:.3e}, "
                                f"{cgap:.3e})")
            del f_cache
            torch.cuda.empty_cache()
    del cache
    torch.cuda.empty_cache()
    if kernel and cfg.moe:
        # no whole-model gate holds here: with the routing pinned, two right prefills (plain
        # and chunked attention) still part by more than LM_TOL, since the reference's expert
        # init (N(0, 1/E), 4 times the fan-in scale at d 2048) amplifies a bf16 step layer
        # over layer.  So the kernel is held on every call of the prefill to its plain version
        # on the same inputs (phase 14's gates), and the whole models' distances are logged
        pin = MoeRoutes(cfg)
        with AttnTap(ref.flash_attention) as tap, pin.record():
            k_logits, _ = prefill(params, toks)
        log(f"  flash kernel against its plain version on each of the prefill's {tap.calls} "
            f"calls: max_abs_err {tap.err:.3e}, at most {tap.unequal * 100:.4f}% of outputs not "
            f"equal and {tap.past * 100:.4f}% past one bf16 ulp; calls outside phase 14's gates "
            f"{tap.bad}")
        out.update(tap_err=tap.err, tap_unequal=tap.unequal, tap_past_ulp=tap.past)
        if tap.bad or tap.calls != cfg.n_layers * mb:
            failures.append(f"{cfg.name}: the kernel outside phase 14's gates at calls {tap.bad} "
                            f"of {tap.calls}")
        for name, fault in faults:
            with AttnTap(fault) as ft:
                prefill(params, toks)
            log(f"  planted fault, {name}: {len(ft.bad)} of {ft.calls} calls outside the gates, "
                f"max_abs_err {ft.err:.3e}")
            if not ft.bad:
                failures.append(f"planted fault {name} passes the per-call gate")
        torch.cuda.empty_cache()
        with attention_as(ref.flash_attention), pin.replay("all"):
            p_logits, _ = prefill(params, toks)
        flips = pin.flips
        with pin.replay("all"):
            c_logits, _ = lm_steps.make_prefill_step(dataclasses.replace(cfg, attn_impl="chunked"),
                                                     B, L, device=dev)[0](params, toks)
        out.update(plain_logit_gap=float((k_logits - p_logits).abs().max()),
                   chunked_logit_gap=float((c_logits - p_logits).abs().max()))
        log(f"  the whole model, routing pinned from the kernel's prefill: logits max_abs_err "
            f"{out['plain_logit_gap']:.3e} kernel against plain attention ({flips} of "
            f"{pin.tokens // 2} token-layers of the plain run would have chosen other experts), "
            f"{out['chunked_logit_gap']:.3e} plain against chunked (no kernel on either side)")
        torch.cuda.empty_cache()

    # the first decode step against the prefill of the prompt and its first token: every
    # layer's decode attention on that prefill's inputs and cache, then the whole model
    full_toks = torch.cat([toks, first.to(dev)[:, None]], dim=1)
    fcfg = dataclasses.replace(cfg, attn_chunk=largest_divisor(L + 1, cfg.attn_chunk))
    full, _ = lm_steps.make_prefill_step(fcfg, B, L + 1, device=dev)
    pin = MoeRoutes(cfg) if cfg.moe else None
    with pin.record() if pin else contextlib.nullcontext(), LastTokenAttn() as rec:
        f_logits, f_cache = full(params, full_toks)
    worst, bad = decode_attn_check(cfg, params, rec, f_cache, L)
    c_worst, c_bad = decode_attn_check(cfg, params, rec, f_cache, L - 1)
    del f_cache
    torch.cuda.empty_cache()
    log(f"  each layer's decode attention at position {L} on the {L + 1}-token prefill's input "
        f"and cache, against that prefill's: largest gap {worst:.3e} of the layer's largest "
        f"output, {bad} of {cfg.n_layers} layers outside {DECODE_ATTN_TOL}; control, at "
        f"position {L - 1} (written over the prompt's last entry): {c_bad} layers outside, "
        f"largest gap {c_worst:.3e}")
    out.update(decode_attn_gap=worst, decode_control_layers=c_bad)
    if bad or not c_bad:
        failures.append(f"{cfg.name}: {bad} layers' decode attention outside the gate, the "
                        f"control outside at {c_bad}")
    d_first = step_logits[0]
    if pin:   # the whole model, routing pinned from the (L + 1)-token prefill
        with pin.replay("head"):
            _, cache = prefill(params, toks)
        one, _ = lm_steps.make_decode_step(cfg, B, L + 1, device=dev)
        with pin.replay("last"):
            d_first, _ = one(params, grown(cache, L + 1), first.to(dev),
                             torch.full((B,), L, dtype=torch.int32, device=dev))
        del cache
        out["decode_prefill_gap"] = float((d_first - f_logits).abs().max())
        log(f"  the whole model's first decode step against the {L + 1}-token prefill, routing "
            f"pinned from it: logits max_abs_err {out['decode_prefill_gap']:.3e} "
            f"({pin.flips} of {pin.tokens} token-layers would have chosen other experts)")
    else:
        out["decode_prefill_gap"] = close_or_fail(
            f"first decode step against a prefill of {L + 1} tokens", d_first, f_logits, 0.0,
            LM_TOL, failures)
    log(f"  top-1 tokens equal in {int((d_first.argmax(-1) == f_logits.argmax(-1)).sum())} of {B}")
    torch.cuda.empty_cache()

    if yardstick:   # the prefill's steady time under torch.profiler: wall clock and busy
        wall_ms, busy_ms, top = device_busy_ms(lambda: prefill(params, toks), 2)
        log(f"prefill under torch.profiler: {wall_ms:.3f} ms wall ({B * L / wall_ms * 1e3:.0f} "
            f"tokens/s), device busy {busy_ms:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% "
            "idle); top kernels: " + top_kernels(top[:6]))
        out.update(prefill_busy_ms=busy_ms, prefill_idle=1 - busy_ms / wall_ms)
        torch.cuda.empty_cache()

    if long_prefill:   # the repo's prefill length, one prompt: the kernel's causal skip at length
        long_toks = torch.randint(0, cfg.vocab, (1, LM_LONG), generator=gen, device=dev,
                                  dtype=torch.int32)
        long_prefill_step, _ = lm_steps.make_prefill_step(cfg, 1, LM_LONG, device=dev)
        long_prefill_step(params, long_toks)
        torch.cuda.synchronize()
        before = ops.flash_attention.launches
        t0 = time.perf_counter()
        l_logits, _ = long_prefill_step(params, long_toks)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        if not bool(l_logits.isfinite().all()) \
                or ops.flash_attention.launches - before != cfg.n_layers:
            failures.append(f"the {LM_LONG}-token prefill: finite "
                            f"{bool(l_logits.isfinite().all())}, "
                            f"{ops.flash_attention.launches - before} launches")
        log(f"prefill 1 x {LM_LONG} tokens: {long_ms:.2f} ms ({LM_LONG / long_ms * 1e3:.0f} "
            "tokens/s)")
        torch.cuda.empty_cache()
    if moe_check:
        out["moe_layer"] = moe_layer_check(cfg, params, dev, failures)
        torch.cuda.empty_cache()
    if kernel:
        out["flash"] = flash_at_model(cfg, dev, gen, LM_LONG if long_prefill else L,
                                      1 if long_prefill else B)
    del params
    torch.cuda.empty_cache()
    return counts, out


def flash_at_model(cfg, dev, gen, L: int, B: int) -> list[dict]:
    """The flash kernel alone at the model's attention shape, [B, H, L, D]
    causal, once a distinct (window, softcap) of its layers: its time beside
    the bound (:func:`attention_kernel_phase`'s) and, with no softcap and no
    window, ``F.scaled_dot_product_attention``'s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn((B, H, L, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, L, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    rows = []
    for window in sorted(set(cfg.layer_windows())):
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        pairs = B * H * visible_pairs(L, L, True, window)
        bms, by = bound_ms(2 * (2 * B * H * L * D + 2 * B * Hkv * L * D), 4.0 * pairs * D,
                           BF16_TENSOR_FLOPS)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=5, warmup=1)
        lib = None if window or cfg.attn_softcap else time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            iters=5, warmup=1)
        rows.append(dict(model=cfg.name, B=B, H=H, Hkv=Hkv, L=L, window=window,
                         softcap=cfg.attn_softcap, ms=ms, bound_ms=bms, bound_by=by,
                         library_ms=lib))
        log(f"  flash_attention at {cfg.name}'s layer [{B},{H},{L},{D}] / {Hkv} KV heads, window "
            f"{window}, softcap {cfg.attn_softcap:g}: {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / ms * 100:.1f}% of bound"
            + ("" if lib is None else f", SDPA {lib:.4f} ms"))
    return rows


def bf16_step(v):
    """One bf16 step at each value of ``v``."""
    import torch
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def moe_layer_check(cfg, params, dev, failures) -> dict:
    """Phase 27's MoE layer at full width: layer 0's ``moe_block`` on
    LM_BATCH x LM_PROMPT inputs of RMSNorm's scale, against a computation
    of its own on the card: each token's experts by ``torch.topk`` of the
    router's softmax, each sequence's slots by a stable sort of its pairs
    by expert (a pair's slot its rank among its expert's pairs, token-major
    then rank), each kept pair's SwiGLU through its own expert times its
    gate in fp32, summed.  The experts, slots and kept set must equal
    ``moe_route``'s exactly; each output within two bf16 steps of its value
    plus 2^-7 of the sum of its terms' sizes; a control with each token's
    gates rolled by one rank must fail that.  Returns the layer's numbers
    (the share of pairs dropped among them)."""
    import torch
    from repro_torch.models import transformer as tf

    B, L, d, E, k = LM_BATCH, LM_PROMPT, cfg.d_model, cfg.n_experts, cfg.top_k
    p = tf._layer(params["layers"], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    x = torch.randn((B, L, d), generator=gen, device=dev).to(torch.bfloat16)
    y = tf.moe_block(x, p, cfg).float()
    _, eidx, slot, keep, _, C = tf.moe_route(x, p["router"], cfg)
    s_ = x.float() @ p["router"].float()
    e_ = torch.exp(s_ - s_.amax(-1, keepdim=True))
    g2, e2 = (e_ / e_.sum(-1, keepdim=True)).topk(k, dim=-1)
    g2 = g2 / g2.sum(-1, keepdim=True).clamp_min(1e-9)
    ef = e2.reshape(B, L * k)
    slot2 = torch.empty_like(ef)
    for b in range(B):
        order = torch.sort(ef[b], stable=True).indices
        n = torch.bincount(ef[b], minlength=E)
        slot2[b, order] = torch.arange(L * k, device=dev) - (n.cumsum(0) - n)[ef[b, order]]
    keep2 = slot2 < C
    same = {"experts": torch.equal(e2, eidx), "slots": torch.equal(slot2, slot),
            "kept": torch.equal(keep2, keep)}
    want, size, ctrl = (torch.zeros((B, L, d), device=dev) for _ in range(3))
    rolled = g2.roll(1, dims=-1)
    tok = torch.arange(L, device=dev).repeat_interleave(k)
    rank = torch.arange(k, device=dev).repeat(L)
    for b in range(B):
        for e in range(E):
            sel = ((ef[b] == e) & keep2[b]).nonzero()[:, 0]
            if sel.numel():
                t, r = tok[sel], rank[sel]
                h = tf.swiglu(x[b, t], p["wg"][e], p["wu"][e], p["wd"][e]).float()
                want[b].index_add_(0, t, g2[b, t, r, None] * h)
                size[b].index_add_(0, t, (g2[b, t, r, None] * h).abs())
                ctrl[b].index_add_(0, t, rolled[b, t, r, None] * h)
    if "shared" in p:
        sh = tf.swiglu(x, p["shared"]["wg"], p["shared"]["wu"], p["shared"]["wd"]).float()
        want, ctrl, size = want + sh, ctrl + sh, size + sh.abs()
    tol = 2 * bf16_step(want) + 2 ** -7 * size
    bad = int(((y - want).abs() > tol).sum())
    ctrl_bad = int(((y - ctrl).abs() > tol).sum())
    dropped = float((~keep).float().mean())
    log(f"  MoE layer 0 at [{B},{L},{d}], {E} experts, top {k}, C {C}: {dropped * 100:.3f}% of "
        f"pairs dropped; experts, slots and kept set equal to the direct computation's {same}; "
        f"output max_abs_err {float((y - want).abs().max()):.3e}, {bad} outside two bf16 steps "
        f"and 2^-7 of the terms; control (gates rolled a rank) {ctrl_bad} outside, max_abs_err "
        f"{float((y - ctrl).abs().max()):.3e}")
    if not all(same.values()) or bad or not ctrl_bad or not dropped:
        failures.append(f"27, the MoE layer: equal {same}, {bad} outputs outside, the control "
                        f"{ctrl_bad} outside, {dropped:.4%} dropped (a check at C {C} must drop)")
    return dict(capacity=C, dropped_share=dropped, max_abs_err=float((y - want).abs().max()),
                control_err=float((y - ctrl).abs().max()))


def lm_family_phase(dev, failures) -> tuple[dict, list]:
    """Phases 25-28: gemma2-27b, phi3-medium-14b and qwen3-moe-30b-a3b at
    full size on the flash kernel, deepseek-v2-236b at full width with its
    depth cut to DEEPSEEK_LAYERS (its dense first layer and 7 MoE layers) on
    the chunked path (the reference's only MLA path): :func:`lm_phase` each,
    gemma2 in PREFILL_MICROBATCH chunks; qwen3 also :func:`moe_layer_check`.
    Returns the flash launches of the main path's runs and each model's
    numbers."""
    from repro_torch.configs import deepseek_v2_236b, gemma2_27b, phi3_medium_14b, \
        qwen3_moe_30b_a3b

    runs, flash = [], 0
    for tag, cfg in (("25", dataclasses.replace(gemma2_27b.config(), attn_impl="pallas",
                                                prefill_microbatch=GEMMA2_MICROBATCH)),
                     ("26", dataclasses.replace(phi3_medium_14b.config(), attn_impl="pallas")),
                     ("27", dataclasses.replace(qwen3_moe_30b_a3b.config(), attn_impl="pallas")),
                     ("28", dataclasses.replace(deepseek_v2_236b.config(),
                                                n_layers=DEEPSEEK_LAYERS))):
        t0 = time.perf_counter()
        got, out = lm_phase(cfg, dev, failures, tag, moe_check=tag == "27")
        if failures:
            raise SystemExit(f"phase {tag}, {cfg.name} failed:\n" + "\n".join(failures))
        flash += got["flash_attention"]
        out["seconds"] = time.perf_counter() - t0
        runs.append(out)
        log(f"phase {tag} numbers: " + json.dumps(out))
    return {"flash_attention": flash}, runs


# phase 29: dlrm-large served with its tables cut to the largest multiple of
# LARGE_ROW_STEP rows that leaves LARGE_FREE bytes free; its drawn rows are scaled in
# place to U(-0.05, 0.05) (phase 24's): at the init scale 1 / sqrt(rows) its 16 top
# layers shrink the logits below 1e-4 and no wrong row could pass the serving gate;
# at 0.05 the moved-rows control moved 62 of 64 logits past 3e-3 in a CPU run of its
# widths (tables of 2000 rows)
LARGE_BATCH = 16384
LARGE_ROW_STEP = 500_000
LARGE_FREE = 8e9
LARGE_SCALE = 0.05
# atol for dlrm-large's served logits (-0.055 to 0.099 at this row scale) against the
# plain forward's: each of its 25 layers rounds to bf16, and a rounding that falls the
# other way in one layer moves every layer above it; on an H100 the two were 5.154e-3
# apart (phase 24's LOGIT_TOL, 3e-3, is set at 7 and 8 layers) and the moved-rows
# control 0.173 from the served logits.  The run prints both paths' distance from the
# forward in float64
LARGE_LOGIT_TOL = 1e-2


def large_phase(dev, rng, failures) -> tuple[list, dict]:
    """Phase 29: dlrm-large (paper Tab. I: 64 tables x 6,000,000 rows x E
    256, P 100, bottom 2048-2048x7-256, top 2336-4096x16-1; 196 GB in bf16)
    served on the card in row mode with each table cut to the largest
    multiple of LARGE_ROW_STEP rows that leaves LARGE_FREE bytes free
    (``torch.cuda.mem_get_info``): rows 1, 2 and 3 at its shapes at B
    LARGE_BATCH (:func:`kernel_phase`, the plain bag in batch chunks) and
    the buckets, then 1024 requests over buckets 8, 32, 128 with phase 24's
    gates and control.  Returns the kernel entries and the serving's launch
    counts."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_large
    from repro_torch.core import sharded_embedding as se
    from repro_torch.serve import SnapshotRegistry

    full = dlrm_large(batch=LARGE_BATCH)
    S, E = len(full.table_rows), full.emb_dim
    dense = 2 * sum(k * n + n for sizes in (full.bottom_sizes, full.top_sizes)
                    for k, n in zip(sizes, sizes[1:]))
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    rows = int((free - LARGE_FREE - dense) // (S * E * 2)) // LARGE_ROW_STEP * LARGE_ROW_STEP
    rows = min(rows, full.table_rows[0])
    need = S * rows * E * 2
    log(f"29 dlrm-large: the card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by this process); each table "
        f"cut from {full.table_rows[0]} to {rows} rows: {S} x {rows} x {E} bf16 = "
        f"{need / 1e9:.2f} GB (uncut {S * full.table_rows[0] * E * 2 / 1e9:.2f} GB), dense "
        f"{dense / 1e9:.3f} GB bf16")
    if rows < LARGE_ROW_STEP:
        failures.append(f"29: no table of {LARGE_ROW_STEP} rows fits beside "
                        f"{LARGE_FREE / 1e9:.0f} GB free")
        return [], {}
    cfg = dataclasses.replace(full, table_rows=(rows,) * S, mlp_impl="pallas")
    t0 = time.perf_counter()
    reg = SnapshotRegistry()
    state = weights.init_snapshot(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    state["emb_w"].mul_(LARGE_SCALE * float(np.sqrt(rows)))
    snap = reg.publish(state)
    del state
    torch.cuda.synchronize()
    log(f"29 snapshot: emb_w {tuple(snap.state['emb_w'].shape)} {snap.state['emb_w'].dtype}, "
        f"{snap.emb_bytes / 1e9:.3f} GB, total {snap.total_bytes / 1e9:.3f} GB, drawn in "
        f"{time.perf_counter() - t0:.1f} s; the card's memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB free")
    offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32,
                              device=dev)
    entries = kernel_phase(cfg, snap.state, offsets, dev, rng, failures, summed=True)
    if failures:
        return entries, {}
    torch.cuda.empty_cache()
    reqs = make_requests(cfg, N_REQUESTS, rng)
    counts = serving_phase(cfg, reg, offsets, dev, reqs, failures, control=True,
                           logit_tol=LARGE_LOGIT_TOL, exact=True)
    del snap, reg
    torch.cuda.empty_cache()
    return entries, counts


def hybrid_batches(cfg, mesh, batches: list) -> list[dict]:
    """The staged global batches as this rank of ``mesh`` takes them
    (``core.hybrid.local_batch``); table mode with the replicated stream in
    padded-slot order, as the reference's loader gives it."""
    from repro_torch.core import hybrid
    from repro_torch.core import sharded_embedding as se
    layout = hybrid.make_layout(cfg, mesh)
    out = []
    for b in batches:
        if cfg.emb_mode == "table" and cfg.idx_input == "replicated":
            b = {**b, **{k: se.permute_indices(layout, b[k]) for k in ("idx", "weights") if k in b}}
        out.append(hybrid.local_batch(cfg, mesh, b))
    return out


def held_first_step(cfg, mesh, cpu_mesh, state, batch, failures, tag: str) -> dict:
    """One train step of ``cfg`` on this rank of ``mesh`` (the card), stage by
    stage as the step runs them, held to the same step on ``cpu_mesh`` (the
    plain versions; a mesh of the same shape whose collectives move CPU
    tensors): the loss within ``TRAIN_TOL["loss"]``, the rank's dense shard
    and (Split-SGD) its embedding shard within ``TRAIN_TOL["update"]`` of
    the state's largest update over all ranks (table mode's store within
    ``TABLE_STORE_TOL``), its sparse update bit for bit the plain update
    of the card's own cotangent, and the cotangent's exchange (the config's
    wire, the ``bf16_sr`` dither keyed on ``sr``) bit for bit the same
    exchange on the CPU of the card's cotangent; the stateful kinds' stores
    are compared.  Table mode's cotangent must reach the row kernel as fp32
    on the ``fp32`` wire (bf16 on the others) and its bags unrounded; row
    mode's as bf16.  Updates ``state`` in place; returns the cotangent's
    type and the share of bag sums bf16 does not hold."""
    import torch
    from repro_torch import weights
    from repro_torch.core import dlrm, hybrid
    from repro_torch.core import sharded_embedding as se
    from repro_torch.core.pipeline import emb_axes
    from repro_torch.dist import comm
    from repro_torch.dist.exchange import resolve_exchange
    from repro_torch.optim import row as row_optim

    step = dlrm.make_train_step(cfg, mesh)
    cpu_step = dlrm.make_train_step(cfg, cpu_mesh)
    opt = row_optim.resolve(cfg)
    layout = hybrid.make_layout(cfg, mesh)
    shard = hybrid.emb_shard(cfg, mesh)
    before = weights.state_to(state, "cpu")
    ref_state, ref_loss = cpu_step(weights.state_to(state, "cpu"),
                                   {k: v.cpu() for k, v in batch.items()})
    st, sr = step.stages, state.get("sr")
    idx_fwd, idx_upd = st.index_exchange(batch["idx"])
    wgt_fwd, wgt_upd = st.index_exchange(batch["weights"]) if cfg.weighted else (None, None)
    emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd, wgt_fwd)
    loss, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, batch)
    dY = st.dY_exchange(d_emb, sr, 0)
    state["emb"] = st.sparse_update(state["emb"], idx_upd, dY, wgt_upd, sr)
    state["dense"] = st.dense_update(state["dense"], g_dense, sr)
    loss = comm.psum(loss, mesh.group(mesh.axis_names))
    if sr is not None:
        sr.add_(1)
    torch.cuda.synchronize()
    cpu_dY = cpu_step.stages.dY_exchange(d_emb.cpu(), before.get("sr"), 0)
    same_dY = dY.dtype == cpu_dY.dtype and bitwise_equal(dY.cpu(), cpu_dY)
    wire = resolve_exchange(cfg).dY_dtype
    log(f"  {tag}: the cotangent's exchange ({wire} wire) bit for bit the CPU's of the card's "
        f"cotangent: {same_dY}")
    if not same_dY:
        failures.append(f"{tag}: the {wire} cotangent exchange differs from the CPU's")
    unrounded = float((emb_out != emb_out.to(torch.bfloat16).float()).float().mean())
    want_dY = torch.float32 if cfg.emb_mode == "table" and wire == "fp32" else torch.bfloat16
    log(f"  {tag}: one step vs the plain step on the CPU: loss {float(loss):.7f} vs "
        f"{float(ref_loss):.7f}; cotangent {dY.dtype} {tuple(dY.shape)}; {unrounded:.1%} of the "
        "bag sums are not bf16 values")
    if dY.dtype != want_dY:
        failures.append(f"{tag}: the row kernel read a {dY.dtype} cotangent, want {want_dY}")
    if (unrounded > 0.5) != (cfg.emb_mode == "table"):
        failures.append(f"{tag}: {unrounded:.1%} of the bag sums are not bf16 values (table mode's "
                        "forward all-to-all is fp32, row mode's reduce-scatter bf16)")
    close_or_fail(f"{tag}: loss vs plain step", loss.cpu(), ref_loss, TRAIN_TOL["loss"], 0.0,
                  failures)
    offsets = torch.as_tensor(se.local_offsets(layout, shard), dtype=torch.int32)
    plain = se.apply_update(layout, {k: v.clone() for k, v in before["emb"].items()}, opt,
                            idx_upd.cpu(), dY.cpu(), cfg.lr, offsets,
                            weights=None if wgt_upd is None else wgt_upd.cpu(),
                            seed=before.get("sr"), group=mesh.group(emb_axes(cfg, mesh)[0]))
    for k, v in plain.items():
        bitwise_or_fail(f"{tag}: {k} vs the plain update of the card's cotangent",
                        state["emb"][k], v.to(mesh.device), failures)
    n, r = mesh.size, mesh.rank
    g_cpu = cpu_mesh.group(cpu_mesh.axis_names)
    table = cfg.emb_mode == "table"
    for part, got, want, old, held in (
            ("embedding shard", master(state["emb"]), card_master(ref_state["emb"], mesh.device),
             card_master(before["emb"], mesh.device), not opt.state_keys),
            ("dense shard", dense_master(state["dense"], n, r).cpu(),
             dense_master(ref_state["dense"], n, r), dense_master(before["dense"], n, r), True)):
        # the largest update of the whole state, over every rank's shard
        upd = float(comm.all_gather((want - old).abs().max()[None].cpu(), g_cpu).max())
        beyond = int(((got - want).abs() > TRAIN_TOL["update"] * upd).sum())
        if not held:
            # Compared, not held: the stateful kinds' stores (training_phase says why)
            log(f"  {tag}: {part} vs plain step (not held, above): max_abs_err "
                f"{float((got - want).abs().max()):.3e}, largest update {upd:.3e}, {beyond} "
                f"values beyond {TRAIN_TOL['update']:g} of it")
            continue
        tol, allowed = ((TABLE_STORE_TOL["update"], TABLE_STORE_TOL["beyond"])
                        if table and part == "embedding shard" else (TRAIN_TOL["update"], 0))
        close_or_fail(f"{tag}: {part} vs plain step (atol {tol:g} x the largest update, "
                      f"{upd:.3e}; {beyond} values beyond {TRAIN_TOL['update']:g} of it, at most "
                      f"{allowed})", got, want, 0.0, tol * upd, failures)
        if beyond > allowed:
            failures.append(f"{tag}: {part}: {beyond} values beyond {TRAIN_TOL['update']:g} of "
                            f"the largest update, at most {allowed}")
    return {"dY": str(dY.dtype), "unrounded": unrounded}


def hybrid_one_rank_phase(dev, batches, failures) -> dict:
    """Phase 16a: table mode at full width on a (1, 1) mesh over an NCCL
    process group of one rank, whose collectives (of one rank) run through
    NCCL: the first step held to the CPU step, one step under
    ``set_sync_debug_mode("error")``, ``HYBRID_STEPS`` timed steps with one
    launch a step of the bag, interaction, row-update and Split-SGD kernels,
    the busy time under torch.profiler; then row mode on the same mesh bit
    for bit the groupless step of phase 6 (losses and state) over
    ``HYBRID_ROW_STEPS`` steps.  Returns the launch counts of the timed
    steps, and the table-mode step's collective bytes in a step (by kind)
    and busy ms: phase 18b's yardstick of the ``fp32`` wire."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(dev)
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev, group=dist.group.WORLD)
        cpu_mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        log(f"16a mesh {mesh.shape} over {dist.get_backend()} (world of 1); host staging "
            f"{mesh.host_staging}")
        cfg = dataclasses.replace(dlrm_small(), emb_mode="table")
        state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        log(f"16a table-mode state: hi {tuple(state['emb']['hi'].shape)} bf16 + lo int16, "
            f"{state_bytes(state['emb']) / 1e9:.3f} GB")
        bs = hybrid_batches(cfg, mesh, batches)
        held_first_step(cfg, mesh, cpu_mesh, state, bs[0], failures, "16a table")
        step = dlrm.make_train_step(cfg, mesh)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, loss = step(state, bs[1])
        except RuntimeError as e:
            failures.append(f"16a: the table-mode step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log("16a: one table-mode step under torch.cuda.set_sync_debug_mode('error')")
        ops.reset_launches()
        mesh.stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in bs[:HYBRID_STEPS]:
            state, loss = step(state, b)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches()
        n = len(losses)
        losses = torch.stack(losses).cpu().numpy()
        stats = mesh.stats.as_dict()
        log(f"16a table mode: {n} steps of B={cfg.batch} in {wall:.3f} s, {wall / n * 1e3:.2f} ms "
            f"a step; losses {losses[0]:.6f} -> {losses[-1]:.6f}; launches {counts}")
        log("16a collectives a step (NCCL, one rank), bytes in / out: " + "; ".join(
            f"{k} x{stats['calls'][k] // n} {stats['bytes_in'][k] // n} / "
            f"{stats['bytes_out'][k] // n}" for k in stats["calls"]))
        if not np.isfinite(losses).all():
            failures.append(f"16a: a loss is not finite: {losses}")
        want = {**{k: 0 for k in counts}, "embedding_bag": n, "dot_interaction": n,
                "embedding_update": n, "split_sgd": n}
        if counts != want:
            failures.append(f"16a: launches {counts}, want {want}")
        it = iter(bs[:5])
        wall_ms, busy_ms, top = device_busy_ms(lambda: step(state, next(it)), 5)
        fp32_wire = {"bytes_in": {k: v // n for k, v in stats["bytes_in"].items()},
                     "busy_ms": busy_ms}
        log(f"16a table-mode step under torch.profiler: {wall_ms:.3f} ms wall, device busy "
            f"{busy_ms:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: "
            + top_kernels(top[:8]))
        del state, step, bs
        torch.cuda.empty_cache()

        # row mode on the NCCL mesh, bit for bit the groupless step
        r_cfg = dlrm_small()
        alone = dlrm.init_state(r_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        grouped = weights.state_to(alone, dev)
        s_alone = dlrm.make_train_step(r_cfg, device=dev)
        s_grouped = dlrm.make_train_step(r_cfg, mesh)
        la, lg = [], []
        for b in batches[:HYBRID_ROW_STEPS]:
            alone, l1 = s_alone(alone, b)
            grouped, l2 = s_grouped(grouped, b)
            la.append(l1)
            lg.append(l2)
        torch.cuda.synchronize()
        same_loss = bool(torch.equal(torch.stack(la).view(torch.int32),
                                     torch.stack(lg).view(torch.int32)))
        same_state = bitwise_equal(alone, grouped)
        log(f"16a row mode on the NCCL mesh vs the groupless step, {HYBRID_ROW_STEPS} steps: losses "
            f"bitwise {same_loss}, state bitwise {same_state}")
        if not (same_loss and same_state):
            failures.append("16a: row mode on the one-rank NCCL mesh is not bit for bit the "
                            "groupless step")
        del alone, grouped
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts, fp32_wire


def mesh_rank_setup(device: str):
    """A rank process's card, made current, with fp32 products in full fp32."""
    import torch
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


# the two ranks that the two-rank phases share (``launch.local.RankPool``): one pool for
# 16b-23a, another for 33e and 35 (phases 24-33b size their work by the card's free memory,
# which the ranks' contexts would take from)
_POOL: list = []


def open_pool() -> None:
    """Start two gloo ranks on the card for the two-rank phases that follow:
    they start and join their group while this process goes on."""
    from repro_torch.launch.local import RankPool
    close_pool()
    _POOL.append(RankPool(2, backend="gloo", timeout_s=900))


def close_pool() -> None:
    while _POOL:
        _POOL.pop().close()


def two_ranks(fn, args: tuple = (), *, timeout_s: float = 900) -> list:
    """``fn(rank, 2, *args)`` in two processes sharing the card over gloo:
    the open pool's (:func:`open_pool`), else two started for the call
    (``launch.local.run_ranks``)."""
    from repro_torch.launch.local import run_ranks
    if _POOL:
        return _POOL[-1].run(fn, args, timeout_s=timeout_s)
    return run_ranks(fn, 2, args, backend="gloo", timeout_s=timeout_s)


def hybrid_rank(rank: int, world: int, cases: tuple, device: str = "cuda:0") -> list[dict]:
    """Phase 16b in one of two processes sharing the card (gloo, so every
    collective stages its payload through pinned host memory): for each
    ``(emb_mode, optimizer)`` of ``cases`` on a (1, 2) mesh, a state from
    the seed, the first step held to the same two-rank step on the CPU
    (:func:`held_first_step`), then ``HYBRID_TWO_STEPS`` timed steps.
    Returns per case the losses, the launch counts, the collectives' bytes
    and the host clock's staging and wire time, the failures, and this
    rank's sparse update timed alone (one rank at a time) with the share of
    its lookups outside its rows."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm, hybrid
    from repro_torch.core import sharded_embedding as se
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import row as row_optim

    dev = mesh_rank_setup(device)
    mesh = make_mesh((1, 2), ("data", "model"), dev)
    cpu_mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out = []
    for mode, opt in cases:
        failures: list[str] = []
        cfg = dataclasses.replace(dlrm_small(), emb_mode=mode, sparse_optimizer=opt,
                                  lr=ADAGRAD_LR if opt.startswith("adagrad") else 0.1)
        tag = f"16b rank {rank} {mode} {opt}"
        state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        bs = hybrid_batches(cfg, mesh, stage_batches(cfg, HYBRID_TWO_STEPS + 1, dev))
        held = held_first_step(cfg, mesh, cpu_mesh, state, bs[0], failures, tag)
        step = dlrm.make_train_step(cfg, mesh)
        ops.reset_launches()
        mesh.stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in bs[1:]:
            state, loss = step(state, b)
            losses.append(float(loss))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            failures.append(f"{tag}: a loss is not finite: {losses}")
        counts, stats = ops.launches(), mesh.stats.as_dict()
        # this rank's sparse update alone, one rank at a time, between CUDA events; and
        # the share of its stream's lookups that fall outside its rows (msk = 0)
        st, b = step.stages, bs[-1]
        idx_fwd, idx_upd = st.index_exchange(b["idx"])
        emb_out = st.embedding_fwd(row_optim.fwd_weights(row_optim.resolve(cfg), state["emb"]),
                                   idx_fwd)
        dY = st.dY_exchange(st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b)[2])
        layout = hybrid.make_layout(cfg, mesh)
        local = idx_upd + torch.as_tensor(se.local_offsets(layout, hybrid.emb_shard(cfg, mesh)),
                                          dtype=torch.int32, device=dev)[None, :, None]
        outside = float(((local < 0) | (local >= layout.rows_per_shard)).float().mean())
        update_ms = 0.0
        for r in range(world):
            dist.barrier()
            if r == rank:
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                st.sparse_update(state["emb"], idx_upd, dY, None, state.get("sr"))
                ev[1].record()
                torch.cuda.synchronize()
                update_ms = ev[0].elapsed_time(ev[1])
        dist.barrier()
        out.append({"mode": mode, "opt": opt, "losses": losses, "counts": counts, "stats": stats,
                    "wall_s": wall, "steps": len(losses), "held": held, "failures": failures,
                    "rows": int(state["emb"][next(iter(state["emb"]))].shape[0]),
                    "update_ms": update_ms, "outside": outside})
        del state, step, bs
        torch.cuda.empty_cache()
    return out


def hybrid_two_rank_phase(failures) -> dict:
    """Phase 16b: two processes on the one card (:func:`two_ranks`, gloo),
    meshes (1, 2) in row and table mode with Split-SGD and in row
    mode with row-wise Adagrad; any child's failure fails the run.  Prints
    per case the collectives' bytes a step and the step's host-clock ms with
    the staging share apart.  Returns the launch counts of both ranks' timed
    steps, summed."""
    t0 = time.perf_counter()
    ranks = two_ranks(hybrid_rank, (HYBRID_TWO_CASES,), timeout_s=900)
    log(f"16b: 2 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s")
    counts: dict = {}
    for i, (mode, opt) in enumerate(HYBRID_TWO_CASES):
        for r, res in enumerate(rk[i] for rk in ranks):
            failures.extend(res["failures"])
            for k, v in res["counts"].items():
                counts[k] = counts.get(k, 0) + v
            st, n = res["stats"], res["steps"]
            log(f"16b {mode} {opt}, rank {r} ({res['rows']} rows): losses "
                + ", ".join(f"{x:.6f}" for x in res["losses"]) + f"; launches {res['counts']}")
            log(f"16b {mode} {opt}, rank {r}, collectives a step, bytes in / out: " + "; ".join(
                f"{k} x{st['calls'][k] // n} {st['bytes_in'][k] // n} / {st['bytes_out'][k] // n}"
                for k in st["calls"]))
            log(f"16b {mode} {opt}, rank {r}: {res['wall_s'] / n * 1e3:.1f} ms a step (host "
                f"clock; two ranks' work on one card, payloads through host memory: not a "
                f"training rate), of which host staging copies {st['staging_s'] / n * 1e3:.1f} ms "
                f"({st['staging_s'] / res['wall_s']:.1%}) and gloo {st['wire_s'] / n * 1e3:.1f} "
                f"ms ({st['wire_s'] / res['wall_s']:.1%}); its sparse update alone "
                f"{res['update_ms']:.3f} ms (CUDA events, the other rank idle), "
                f"{res['outside']:.1%} of its lookups outside its rows")
        want_row = "embedding_update_adagrad_rowwise" if opt == "adagrad_rowwise" \
            else "embedding_update"
        for r, rk in enumerate(ranks):
            c, n = rk[i]["counts"], rk[i]["steps"]
            want = {**{k: 0 for k in c}, "embedding_bag": n, "dot_interaction": n,
                    want_row: n, "split_sgd": 4 * n}
            if c != want:
                failures.append(f"16b {mode} {opt} rank {r}: launches {c}, want {want} (the "
                                "dense step once a bucket)")
    return counts


def loop_crcs(glob) -> dict:
    """CRC32 of every leaf of a global state of CPU tensors, by tree path."""
    import zlib
    import torch
    from repro_torch.checkpoint.manager import tree_paths
    return {k: zlib.crc32(v.contiguous().view(-1).view(torch.uint8).numpy())
            for k, v in tree_paths(glob)}


def step_launches(counts: dict, steps: int) -> dict:
    want = {k: 0 for k in counts}
    want.update({k: n * steps for k, n in MESH_STEP_LAUNCHES.items()})
    return want


def mesh_loop_rank(rank: int, world: int, ckdir: str, device: str = "cuda:0") -> dict:
    """Phase 17a in one of two processes sharing the card (gloo): dlrm-small
    at full width on a (1, 2) mesh through ``TrainLoop`` over one pool of
    ``MESH_LOOP_STEPS`` numpy global batches (the loop cuts each rank's block
    before its prefetch copy): 10 steps without a checkpoint; 5 steps with a
    checkpoint at 5 (the gathered 2.06 GB that rank 0 writes); a second loop,
    on a state from another seed, that restores step 5 and runs to 10,
    saving at 10.  Returns the losses, whether the restarted shard equals the
    uninterrupted one bit for bit, the launches of the loops, the gather,
    write and restore times, step times, and on rank 0 the CRC32s of the
    uninterrupted run's gathered state."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainLoop, TrainLoopConfig

    dev = mesh_rank_setup(device)
    cfg = dlrm_small()
    mesh = make_mesh((1, world), ("data", "model"), dev)
    S0 = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
    pool = [b for b, _ in zip(dlrm_stream(SEED, cfg, ALPHA), range(MESH_LOOP_STEPS))]
    step = dlrm.make_train_step(cfg, mesh)

    def loop(steps, state, start, **kw):
        return TrainLoop(TrainLoopConfig(steps=steps, log_every=100, prefetch=2,
                                         straggler_window=MESH_LOOP_STEPS, **kw),
                         step, state, iter(pool[start:]), mesh=mesh, model_cfg=cfg)

    ckpt = dict(ckpt_dir=ckdir, ckpt_every=MESH_LOOP_SAVE)
    torch.cuda.synchronize()
    ops.reset_launches()
    whole = loop(MESH_LOOP_STEPS, weights.state_to(S0, dev), 0)
    whole.run()
    first = loop(MESH_LOOP_SAVE, weights.state_to(S0, dev), 0, **ckpt)
    first.run()
    del S0
    other = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 7), mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = loop(MESH_LOOP_STEPS, other, MESH_LOOP_SAVE, **ckpt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del other
    second.run()
    torch.cuda.synchronize()
    counts = ops.launches()
    same = bitwise_equal(second.state, whole.state)
    glob = weights.state_to_global(whole.state, mesh, cfg)  # a collective: every rank
    crcs = loop_crcs(glob) if rank == 0 else None
    del glob
    dts = np.asarray(list(first.monitor.times) + list(second.monitor.times)) * 1e3
    out = {"losses": first.losses + second.losses, "whole_losses": whole.losses,
           "start_step": second.start_step, "same": same, "counts": counts,
           "want": step_launches(counts, 2 * MESH_LOOP_STEPS),
           "gather_s": first.gather_durations + second.gather_durations,
           "write_s": (first.ckpt.save_durations + second.ckpt.save_durations) if rank == 0
           else [], "restore_s": restore_s, "step_ms": (float(np.percentile(dts, 50)),
                                                         float(np.percentile(dts, 99))),
           "rows": int(whole.state["emb"]["hi"].shape[0]), "crcs": crcs,
           "mem_gb": (torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0]) / 1e9}
    del whole, first, second
    torch.cuda.empty_cache()
    return out


def mesh_loop_phase(dev, failures) -> dict:
    """Phase 17a: two ranks on the card (``mesh_loop_rank``), then in this
    process the step-10 checkpoint restored (its CRC32s those of the
    uninterrupted run's gathered state), laid out for a (1, 1) mesh
    (``weights.reshard_global``) and placed on the card, gathered back bit for
    bit, and one step of it with a finite loss.  Returns the launches of both
    ranks' loops."""
    import shutil
    import torch
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.launch.mesh import Mesh, make_mesh

    ckdir = ROOT / "build" / "loop_mesh"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        ranks = two_ranks(mesh_loop_rank, (str(ckdir),), timeout_s=900)
        log(f"17a: 2 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s")
        counts: dict = {}
        for r, res in enumerate(ranks):
            for k, v in res["counts"].items():
                counts[k] = counts.get(k, 0) + v
            log(f"17a rank {r} ({res['rows']} rows): losses " + ", ".join(
                f"{x:.6f}" for x in res["losses"]) + f"; restored at {res['start_step']} in "
                f"{res['restore_s']:.2f} s (verify + load + cut); gathers ms " + ", ".join(
                f"{x * 1e3:.1f}" for x in res["gather_s"]) + (
                "; write + CRC32 s " + ", ".join(f"{x:.2f}" for x in res["write_s"])
                if res["write_s"] else "") + f"; loop step ms p50 {res['step_ms'][0]:.3f} p99 "
                f"{res['step_ms'][1]:.3f}; the card's memory in use {res['mem_gb']:.2f} GB; "
                f"launches {res['counts']}")
            if res["start_step"] != MESH_LOOP_SAVE or not res["same"] \
                    or res["losses"] != res["whole_losses"] or res["counts"] != res["want"]:
                failures.append(f"17a rank {r}: restored at {res['start_step']} (want "
                                f"{MESH_LOOP_SAVE}), the restarted shard bit for bit the "
                                f"uninterrupted one: {res['same']}, losses equal: "
                                f"{res['losses'] == res['whole_losses']}, launches "
                                f"{res['counts']} (want {res['want']})")
            if not np.isfinite(res["losses"]).all():
                failures.append(f"17a rank {r}: a loss is not finite")
        if failures:
            return counts
        # the gathered checkpoint onto one rank, in this process
        cfg = dlrm_small()
        t0 = time.perf_counter()
        mgr = CheckpointManager(ckdir)
        old = Mesh(shape={"data": 1, "model": 2}, device=torch.device("cpu"))  # its shape alone
        at, glob = mgr.restore(weights.global_like(cfg, old), device="cpu")
        crcs = loop_crcs(glob)
        one = make_mesh((1, 1), ("data", "model"), dev)
        flat = weights.reshard_global(glob, cfg, old, one)
        state = weights.state_from_global(flat, cfg, one)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = weights.state_to_global(state, one, cfg)
        placed = bitwise_equal(back, flat)
        npz = (ckdir / f"step_{at}" / "arrays.npz").stat().st_size
        log(f"17a: step {at} ({npz / 1e9:.3f} GB) restored onto a (1, 1) mesh in {restore_s:.2f} "
            f"s; CRC32s those of the uninterrupted run's gathered state: "
            f"{crcs == ranks[0]['crcs']}; placed and gathered back bit for bit: {placed}")
        if at != MESH_LOOP_STEPS or crcs != ranks[0]["crcs"] or not placed:
            failures.append(f"17a: restored step {at} (want {MESH_LOOP_STEPS}), CRC32s "
                            f"{'equal' if crcs == ranks[0]['crcs'] else 'differ'}, placement "
                            f"bitwise {placed}")
        del glob, flat, back
        b = next(dlrm_stream(SEED + 1, cfg, ALPHA))
        _, loss = dlrm.make_train_step(cfg, one)(state, {k: torch.from_numpy(v).to(dev)
                                                         for k, v in b.items()})
        log(f"17a: one step on the (1, 1) state: loss {float(loss):.6f}")
        if not np.isfinite(float(loss)):
            failures.append(f"17a: the (1, 1) step's loss is {float(loss)}")
        del state
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def quickstart_rank(rank: int, world: int, qs_dir: str, el_dir: str,
                    device: str = "cuda:0") -> dict:
    """Phase 17b and 17c's first half in one of eight processes sharing the
    card (gloo) on a (2, 4) mesh.  17b, the quickstart's contract: 80 steps
    without a checkpoint; 60 with a checkpoint every 20 and a second loop,
    on a state from another seed, that restores and runs on to 80, over one
    stream of global batches; the mean loss of the start and of the final
    state over the 80 batches trained on (the eval step's scores; this
    rank's samples); the eval step on the next batch.  17c: the elastic
    configuration 10 steps from a seed, gathered, rank 0 saving step 10."""
    import itertools
    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm, hybrid
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainLoop, TrainLoopConfig

    dev = mesh_rank_setup(device)
    mesh = make_mesh((2, 4), ("data", "model"), dev)
    cfg = dlrm.DLRMConfig(**QUICKSTART)
    pool = [b for b, _ in zip(dlrm_stream(0, cfg, alpha=0.6), range(RUN_STEPS + 1))]
    S0 = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
    step = dlrm.make_train_step(cfg, mesh)

    def loop(steps, state, stream, **kw):
        return TrainLoop(TrainLoopConfig(steps=steps, log_every=100, **kw), step, state, stream,
                         mesh=mesh, model_cfg=cfg)

    torch.cuda.synchronize()
    ops.reset_launches()
    whole = loop(RUN_STEPS, weights.state_to(S0, dev), iter(pool))
    whole.run()
    stream = iter(pool)
    ckpt = dict(ckpt_dir=qs_dir, ckpt_every=RUN_CKPT_EVERY)
    first = loop(RUN_RESTART, weights.state_to(S0, dev), stream, **ckpt)
    first.run()
    other = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 7), mesh=mesh)
    second = loop(RUN_STEPS, other, stream, **ckpt)
    second.run()
    torch.cuda.synchronize()
    counts = ops.launches()
    ev = dlrm.make_eval_step(cfg, mesh)

    def local(b):
        return {k: v.to(dev) for k, v in hybrid.local_batch(
            cfg, mesh, {k: torch.from_numpy(v) for k, v in b.items()}).items()}

    def bce_sum(state) -> float:  # over this rank's samples of the batches trained on
        tot = 0.0
        for b in pool[:RUN_STEPS]:
            lb = local(b)
            p = ev(state, lb).double().clamp(1e-12, 1 - 1e-12)
            y = lb["labels"].double()
            tot += float(-(y * p.log() + (1 - y) * (1 - p).log()).sum())
        return tot

    fit = (bce_sum(S0), bce_sum(second.state))
    scores = ev(second.state, local(pool[RUN_STEPS])).cpu().numpy()
    dts = np.asarray(list(first.monitor.times) + list(second.monitor.times)) * 1e3
    free, total = torch.cuda.mem_get_info()
    out = {"losses": first.losses + second.losses, "whole_losses": whole.losses,
           "start_step": second.start_step, "same": bitwise_equal(second.state, whole.state),
           "counts": counts, "want": step_launches(counts, 2 * RUN_STEPS), "fit": fit,
           "scores": scores, "step_ms": (float(np.percentile(dts, 50)),
                                         float(np.percentile(dts, 99))),
           "mem_gb": (total - free) / 1e9, "own_gb": torch.cuda.memory_allocated() / 1e9}
    del whole, first, second, other, S0

    # 17c: the elastic configuration on (2, 4), saved for the (1, 4) ranks
    ecfg = dlrm.DLRMConfig(**ELASTIC)
    state = dlrm.init_state(ecfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
    estep = dlrm.make_train_step(ecfg, mesh)
    ops.reset_launches()
    losses = []
    for b in itertools.islice(dlrm_stream(0, ecfg), ELASTIC_STEPS):
        state, loss = estep(state, {k: v.to(dev) for k, v in hybrid.local_batch(
            ecfg, mesh, {k: torch.from_numpy(v) for k, v in b.items()}).items()})
        losses.append(float(loss))
    out["el_counts"] = ops.launches()
    out["el_want"] = step_launches(out["el_counts"], ELASTIC_STEPS)
    out["el_losses"] = losses
    glob = weights.state_to_global(state, mesh, ecfg)
    if rank == 0:
        CheckpointManager(el_dir).save(ELASTIC_STEPS, glob, blocking=True)
    dist.barrier()
    return out


def elastic_rank(rank: int, world: int, el_dir: str, device: str = "cuda:0") -> dict:
    """Phase 17c's second half in one of four processes sharing the card: the
    (2, 4) checkpoint restored, laid out for (1, 4) (``weights.reshard_global``)
    and cut; this rank's shard gathered back against the resharded arrays bit
    for bit; then 10 steps on the stream past the batches (2, 4) trained on."""
    import itertools
    import torch
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm, hybrid
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh, make_mesh

    dev = mesh_rank_setup(device)
    mesh = make_mesh((1, 4), ("data", "model"), dev)
    old = Mesh(shape={"data": 2, "model": 4}, device=torch.device("cpu"))  # its shape alone
    cfg = dlrm.DLRMConfig(**ELASTIC)
    at, glob = CheckpointManager(el_dir).restore(weights.global_like(cfg, old), device="cpu")
    resharded = weights.reshard_global(glob, cfg, old, mesh)
    state = weights.state_from_global(resharded, cfg, mesh)
    same = bitwise_equal(weights.state_to_global(state, mesh, cfg), resharded)
    step = dlrm.make_train_step(cfg, mesh)
    ops.reset_launches()
    losses = []
    for b in itertools.islice(dlrm_stream(0, cfg), ELASTIC_STEPS, 2 * ELASTIC_STEPS):
        state, loss = step(state, {k: v.to(dev) for k, v in hybrid.local_batch(
            cfg, mesh, {k: torch.from_numpy(v) for k, v in b.items()}).items()})
        losses.append(float(loss))
    counts = ops.launches()
    return {"step": at, "same": same, "losses": losses, "counts": counts,
            "want": step_launches(counts, ELASTIC_STEPS)}


def quickstart_mesh_phase(failures) -> dict:
    """Phases 17b and 17c: eight processes on the card (``quickstart_rank``),
    then four (``elastic_rank``).  Returns the launches of all their steps."""
    import shutil
    from repro_torch.launch.local import run_ranks

    base = ROOT / "build" / "quickstart_mesh"
    shutil.rmtree(base, ignore_errors=True)
    qs_dir, el_dir = base / "quickstart", base / "elastic"
    qs_dir.mkdir(parents=True)
    el_dir.mkdir(parents=True)
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(quickstart_rank, 8, (str(qs_dir), str(el_dir)), backend="gloo",
                          timeout_s=900)
        log(f"17b: 8 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s")
        fit0 = sum(r["fit"][0] for r in ranks) / (RUN_STEPS * QUICKSTART["batch"])
        fit1 = sum(r["fit"][1] for r in ranks) / (RUN_STEPS * QUICKSTART["batch"])
        scores = np.concatenate([r["scores"] for r in ranks])
        inside = bool(np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all())
        l = ranks[0]["losses"]
        log(f"17b: losses {l[0]:.4f} -> {l[RUN_RESTART - 1]:.4f} (60 steps) -> {l[-1]:.4f}; the "
            f"mean loss over the {RUN_STEPS} batches trained on, start state {fit0:.6f}, final "
            f"state {fit1:.6f}; eval scores {scores.shape}, mean {scores.mean():.4f}, in (0, 1): "
            f"{inside}")
        if not fit1 < fit0:
            failures.append(f"17b: the loss over the batches trained on did not fall: {fit0:.6f} "
                            f"-> {fit1:.6f}")
        if not inside or scores.shape != (QUICKSTART["batch"],):
            failures.append(f"17b: eval scores {scores.shape}, finite and in (0, 1): {inside}")
        for r, res in enumerate(ranks):
            add(res["counts"])
            add(res["el_counts"])
            log(f"17b rank {r}: restored at {res['start_step']}; step ms p50 "
                f"{res['step_ms'][0]:.3f} p99 {res['step_ms'][1]:.3f} (host clock; eight ranks' "
                f"work on one card: not a training rate); the card's memory in use "
                f"{res['mem_gb']:.2f} GB, this rank's tensors {res['own_gb']:.3f} GB; "
                f"launches {res['counts']}")
            if res["start_step"] != RUN_RESTART or not res["same"] \
                    or res["losses"] != res["whole_losses"] or res["counts"] != res["want"] \
                    or res["losses"] != l or not np.isfinite(res["losses"]).all():
                failures.append(f"17b rank {r}: restored at {res['start_step']} (want "
                                f"{RUN_RESTART}), the state at {RUN_STEPS} bit for bit the "
                                f"uninterrupted run's: {res['same']}, losses equal to it: "
                                f"{res['losses'] == res['whole_losses']}, launches "
                                f"{res['counts']} (want {res['want']})")
            if res["el_counts"] != res["el_want"] or not np.isfinite(res["el_losses"]).all():
                failures.append(f"17c rank {r} on (2, 4): losses {res['el_losses']}, launches "
                                f"{res['el_counts']} (want {res['el_want']})")
        log("17c: (2, 4) losses " + ", ".join(f"{x:.6f}" for x in ranks[0]["el_losses"]))
        t0 = time.perf_counter()
        small = run_ranks(elastic_rank, 4, (str(el_dir),), backend="gloo", timeout_s=600)
        log(f"17c: 4 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s; (1, 4) "
            "losses " + ", ".join(f"{x:.6f}" for x in small[0]["losses"]))
        for r, res in enumerate(small):
            add(res["counts"])
            if res["step"] != ELASTIC_STEPS or not res["same"] or res["counts"] != res["want"] \
                    or not np.isfinite(res["losses"]).all() or res["losses"] != small[0]["losses"]:
                failures.append(f"17c rank {r} on (1, 4): restored step {res['step']}, the shard "
                                f"gathered back bit for bit the resharded arrays: {res['same']}, "
                                f"losses {res['losses']}, launches {res['counts']} (want "
                                f"{res['want']})")
        return counts
    finally:
        shutil.rmtree(base, ignore_errors=True)


def profile_kernels(fn, reps: int) -> tuple[float, list[str]]:
    """:func:`device_busy_ms`'s busy ms a run and the kernels' full names."""
    _, busy_ms, top = device_busy_ms(fn, reps)
    return busy_ms, [name for name, _, _ in top]


def sort_kernels(names: list) -> list:
    return [n[:80] for n in names if "sort" in n.lower()]


def run_steps(step, state, batches, sync_free: bool = False) -> tuple:
    """``step`` over ``batches`` from ``state`` (updated in place): the
    state, the losses as a CPU tensor, the launch counts and the wall s (the
    steps under ``set_sync_debug_mode("error")`` where ``sync_free``)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    losses = []
    t0 = time.perf_counter()
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, torch.stack(losses).cpu(), ops.launches(), time.perf_counter() - t0


def same_losses(a, b) -> bool:
    import torch
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def presort_phase(dev, batches, failures) -> dict:
    """Phase 18a, groupless row mode (Split-SGD): for each staged batch
    ``presort_batch``'s fields on the host bit for bit the card's
    ``_row_sorted_streams``; ``PRESORT_STEPS`` ``host_presort`` steps (no
    host sync) bit for bit, losses and state, phase 6's device-sorted steps
    from the same start, with one launch a step of rows 1, 2, 4 and 5 and
    no sort kernel under torch.profiler (the device-sorted step shows one);
    then ``TrainLoop`` over ``HostPipeline(presort=True)``, prefetch 2,
    ``PRESORT_STEPS`` steps: the pre-sort's ms a batch on the host, the
    loop's step p50 / p99 and the prefetch's wait.  Returns the launches of
    the presorted steps and the loop's, and the device-sorted (M = 1) step's
    busy ms, phase 18c's yardstick."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.pipeline import PSORT_KEYS, HostPipeline, presort_batch
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.train import TrainLoop, TrainLoopConfig

    cfg = dlrm_small()
    p_cfg = dataclasses.replace(cfg, host_presort=True)
    layout = se.make_layout(cfg.spec, 1)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    host_ms, same, pre = [], True, []
    for b in batches:
        idx = b["idx"].cpu().numpy()
        t0 = time.perf_counter()
        fields = presort_batch(layout, idx)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        card = se._row_sorted_streams(layout, (b["idx"] + offsets[None, :, None]).reshape(-1),
                                      cfg.pooling)
        same &= all(bitwise_equal(t.cpu(), torch.from_numpy(fields[k][0]))
                    for k, t in zip(PSORT_KEYS, card))
        pre.append({**b, **{k: torch.from_numpy(v).to(dev) for k, v in fields.items()}})
    L = pre[0]["psort_rows"].shape[1]
    log(f"18a: presort_batch of {len(batches)} batches ({L} lookups each, torch.sort(stable=True) "
        f"on the host, one thread): {np.mean(host_ms):.1f} ms a batch (min {min(host_ms):.1f}, "
        f"max {max(host_ms):.1f}); every field bit for bit the card's _row_sorted_streams: {same}")
    if not same:
        failures.append("18a: presort_batch's fields differ from the card's sorted streams")

    s_dev = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    s_pre = weights.state_to(s_dev, dev)
    step_dev = dlrm.make_train_step(cfg, device=dev)
    step_pre = dlrm.make_train_step(p_cfg, device=dev)
    s_dev, l_dev, _, w_dev = run_steps(step_dev, s_dev, batches, sync_free=True)
    s_pre, l_pre, counts, w_pre = run_steps(step_pre, s_pre, pre, sync_free=True)
    n = len(pre)
    ok_l, ok_s = same_losses(l_dev, l_pre), bitwise_equal(s_dev, s_pre)
    log(f"18a: {n} host_presort steps (under set_sync_debug_mode('error')) against {n} "
        f"device-sorted steps from one state: losses bitwise {ok_l}, state bitwise {ok_s}; "
        f"losses {float(l_pre[0]):.6f} -> {float(l_pre[-1]):.6f}; wall {w_pre / n * 1e3:.2f} vs "
        f"{w_dev / n * 1e3:.2f} ms a step; launches {counts}")
    if not (ok_l and ok_s):
        failures.append("18a: the presorted steps are not bit for bit the device-sorted steps")
    want = {**{k: 0 for k in counts}, "embedding_bag": n, "dot_interaction": n,
            "embedding_update": n, "split_sgd": n}
    if counts != want:
        failures.append(f"18a: launches {counts}, want {want}")
    it_d, it_p = iter(batches), iter(pre)
    busy_d, names_d = profile_kernels(lambda: step_dev(s_dev, next(it_d)), 3)
    busy_p, names_p = profile_kernels(lambda: step_pre(s_pre, next(it_p)), 3)
    log(f"18a under torch.profiler, 3 steps each: device-sorted busy {busy_d:.3f} ms a step, sort "
        f"kernels {sort_kernels(names_d)}; presorted busy {busy_p:.3f} ms, sort kernels "
        f"{sort_kernels(names_p)}; {busy_d - busy_p:.3f} ms less")
    if sort_kernels(names_p) or not sort_kernels(names_d):
        failures.append(f"18a: sort kernels, presorted step {sort_kernels(names_p)}, device-sorted "
                        f"{sort_kernels(names_d)} (want none, and some)")
    del s_dev, pre
    torch.cuda.empty_cache()

    pool = [b for b, _ in zip(dlrm_stream(SEED, cfg, ALPHA), range(N_TRAIN))]
    pipe = HostPipeline(iter(pool), layout=layout, presort=True)
    loop = TrainLoop(TrainLoopConfig(steps=PRESORT_STEPS, log_every=PRESORT_STEPS, prefetch=2,
                                     straggler_window=PRESORT_STEPS), step_pre, s_pre, pipe,
                     device=dev)
    torch.cuda.synchronize()
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    loop.run()
    wall = time.perf_counter() - t0
    pipe.close()
    loop_counts = ops.launches()
    dts = np.asarray(loop.monitor.times) * 1e3
    ps, ws = pipe.stats, loop.batches.stats
    log(f"18a loop: TrainLoop over HostPipeline(presort=True), prefetch 2, {PRESORT_STEPS} steps in "
        f"{wall:.2f} s ({PRESORT_STEPS * cfg.batch / wall:.0f} samples/s wall); step ms p50 "
        f"{np.percentile(dts, 50):.3f} p99 {np.percentile(dts, 99):.3f}; the pre-sort worker "
        f"{ps['prep_s'] / max(ps['batches'], 1) * 1e3:.1f} ms a batch over {ps['batches']} "
        f"batches; the loop waited {ws['wait_s']:.3f} s on the prefetch ({ws['wait_s'] / wall:.1%} "
        f"of the wall); losses {loop.losses[0]:.6f} -> {loop.losses[-1]:.6f}")
    if not np.isfinite(loop.losses).all() or len(loop.losses) != PRESORT_STEPS:
        failures.append(f"18a loop: losses {loop.losses}")
    for k, v in loop_counts.items():
        counts[k] = counts.get(k, 0) + v
    del loop, s_pre
    torch.cuda.empty_cache()
    return counts, busy_d


def exchange_nccl_phase(dev, batches, failures, fp32_wire: dict) -> dict:
    """Phases 18a (table mode) and 18b on a (1, 1) mesh over a one-rank NCCL
    group, as 16a's.  18a: ``PRESORT_TABLE_STEPS`` table-mode
    ``host_presort`` steps bit for bit the device-sorted ones.  18b: table
    mode on the ``bf16`` wire with the error feedback and on ``bf16_sr``:
    each wire's first step held to the same step on the CPU
    (:func:`held_first_step`: phase 6's tolerances, the cotangent's
    exchange, dither included, bit for bit the CPU's), then ``WIRE_STEPS``
    finite steps; each collective's bytes a step against ``fp32_wire``, 16a's
    step of the same configuration on the ``fp32`` wire (the all-to-alls
    3/4: the forward's fp32 payload and the cotangent's halved; the dense
    reduce-scatter 1/2), and the busy time against its.  Returns the
    launches of the timed steps."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm, hybrid
    from repro_torch.data.pipeline import presort_batch
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(dev)
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl18_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            world_size=1, rank=0)
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev, group=dist.group.WORLD)
        cpu_mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        cfg = dataclasses.replace(dlrm_small(), emb_mode="table")
        layout = hybrid.make_layout(cfg, mesh)
        bs = hybrid_batches(cfg, mesh, batches)
        pre = [{**b, **{k: torch.from_numpy(v).to(dev)
                        for k, v in presort_batch(layout, ob["idx"].cpu().numpy()).items()}}
               for b, ob in zip(bs[:PRESORT_TABLE_STEPS], batches)]
        s_dev = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        s_pre = weights.state_to(s_dev, dev)
        s_dev, l_dev, _, _ = run_steps(dlrm.make_train_step(cfg, mesh), s_dev,
                                       bs[:PRESORT_TABLE_STEPS])
        s_pre, l_pre, c, _ = run_steps(
            dlrm.make_train_step(dataclasses.replace(cfg, host_presort=True), mesh), s_pre, pre)
        add(c)
        ok = same_losses(l_dev, l_pre) and bitwise_equal(s_dev, s_pre)
        log(f"18a table mode on the NCCL mesh: {PRESORT_TABLE_STEPS} host_presort steps bit for "
            f"bit the device-sorted steps (losses and state): {ok}; launches {c}")
        if not ok:
            failures.append("18a: table mode's presorted steps differ from the device-sorted ones")
        del s_dev, s_pre, pre
        torch.cuda.empty_cache()

        per_step, busy = {}, {}
        for wire in ("bf16", "bf16_sr"):
            w_cfg = dataclasses.replace(cfg, exchange_dtype=wire)
            state = dlrm.init_state(w_cfg, torch.Generator(device=dev).manual_seed(SEED),
                                    mesh=mesh)
            tag = f"18b table {wire}"
            held_first_step(w_cfg, mesh, cpu_mesh, state, bs[0], failures, tag)
            step = dlrm.make_train_step(w_cfg, mesh)
            n = WIRE_STEPS
            mesh.stats.reset()
            state, losses, c, wall = run_steps(step, state, bs[1:1 + n], sync_free=True)
            st = mesh.stats.as_dict()
            per_step[wire] = {k: {kind: v // n for kind, v in st[k].items()}
                              for k in ("calls", "bytes_in", "bytes_out")}
            it = iter(bs[1:6])
            busy[wire], _ = profile_kernels(lambda: step(state, next(it)), 5)
            extra = ""
            if state["dense"]["err"] is not None:
                err = state["dense"]["err"]
                extra = (f"; err slab {tuple(err.shape)} fp32, finite {bool(torch.isfinite(err).all())}"
                         f", max |err| {float(err.abs().max()):.3e} (M = 1: the dense gradients "
                         "are bf16 values, which the wire keeps)")
                if not bool(torch.isfinite(err).all()):
                    failures.append(f"{tag}: the err slab is not finite")
            if "sr" in state:
                extra += f"; sr {int(state['sr'])}"
            log(f"{tag}: {n} steps (no host sync), {wall / n * 1e3:.2f} ms a step wall, busy "
                f"{busy[wire]:.3f} ms a step; losses {float(losses[0]):.6f} -> "
                f"{float(losses[-1]):.6f}; launches {c}" + extra)
            log(f"{tag}: collectives a step, bytes in / out: " + "; ".join(
                f"{k} x{per_step[wire]['calls'][k]} {per_step[wire]['bytes_in'][k]} / "
                f"{per_step[wire]['bytes_out'][k]}" for k in per_step[wire]["calls"]))
            if not bool(torch.isfinite(losses).all()):
                failures.append(f"{tag}: a loss is not finite: {losses}")
            add(c)
            f32 = fp32_wire["bytes_in"]
            got = per_step[wire]["bytes_in"]
            a2a, rs = got["all-to-all"] / f32["all-to-all"], \
                got["reduce-scatter"] / f32["reduce-scatter"]
            log(f"{tag}: against 16a's fp32 wire, all-to-all bytes x{a2a:.4f} (want 0.75: the "
                f"forward's fp32, the cotangent's halved), dense reduce-scatter x{rs:.4f} (want "
                f"0.5); busy {busy[wire] - fp32_wire['busy_ms']:+.3f} ms a step "
                f"({fp32_wire['busy_ms']:.3f} there)")
            if a2a != 0.75 or rs != 0.5:
                failures.append(f"{tag}: bytes against the fp32 wire: all-to-all x{a2a}, "
                                f"reduce-scatter x{rs}")
            del state, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts


def microbatch_phase(dev, batches, failures, busy_m1: float) -> dict:
    """Phase 18c: groupless row mode with M = 2 and M = 4: each M-step's
    first step held to the same M-step on the CPU (the loss within
    ``TRAIN_TOL["loss"]``, the store and the dense weights within
    ``TRAIN_TOL["update"]`` of the largest update), then ``MB_STEPS`` steps
    with no host sync, rows 1 and 2 launched M times a step and rows 5 and
    4 once, the busy time under torch.profiler against ``busy_m1``, 18a's
    device-sorted step's (M = 1).  Returns the launches of the timed
    steps."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm

    counts: dict = {}
    busy = {1: busy_m1}
    for M in (2, 4):
        cfg = dataclasses.replace(dlrm_small(), microbatches=M)
        tag = f"18c M={M}"
        state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        step = dlrm.make_train_step(cfg, device=dev)
        before = weights.state_to(state, "cpu")
        t0 = time.perf_counter()
        ref_state, ref_loss = dlrm.make_train_step(cfg, device="cpu")(
            weights.state_to(state, "cpu"), {k: v.cpu() for k, v in batches[0].items()})
        cpu_s = time.perf_counter() - t0
        state, loss = step(state, batches[0])
        torch.cuda.synchronize()
        log(f"{tag}: one step vs the same M-step on the CPU ({cpu_s:.1f} s there): loss "
            f"{float(loss):.7f} vs {float(ref_loss):.7f}")
        close_or_fail(f"{tag}: loss vs plain step", loss.cpu(), ref_loss, TRAIN_TOL["loss"],
                      0.0, failures)
        for part, got, want, old in (
                ("embedding store", master(state["emb"]), card_master(ref_state["emb"], dev),
                 card_master(before["emb"], dev)),
                ("dense weights", dense_master(state["dense"]).cpu(),
                 dense_master(ref_state["dense"]), dense_master(before["dense"]))):
            upd = float((want - old).abs().max())
            close_or_fail(f"{tag}: {part} vs plain step (atol {TRAIN_TOL['update']:g} x the "
                          f"largest update, {upd:.3e})", got, want, 0.0,
                          TRAIN_TOL["update"] * upd, failures)
        del ref_state, before
        state, losses, c, wall = run_steps(step, state, batches[1:1 + MB_STEPS], sync_free=True)
        n = MB_STEPS
        it = iter(batches[1:6])
        busy[M], _ = profile_kernels(lambda: step(state, next(it)), 5)
        log(f"{tag}: {n} steps (no host sync) {wall / n * 1e3:.2f} ms a step wall, busy "
            f"{busy[M]:.3f} ms a step ({busy[M] - busy[1]:+.3f} against M = 1); losses "
            f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f}; launches {c}")
        if not bool(torch.isfinite(losses).all()):
            failures.append(f"{tag}: a loss is not finite: {losses}")
        want = {**{k: 0 for k in c}, "embedding_bag": M * n, "dot_interaction": M * n,
                "embedding_update": n, "split_sgd": n}
        if c != want:
            failures.append(f"{tag}: launches {c}, want {want} (rows 1 and 2 M times a step)")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        del state, step
        torch.cuda.empty_cache()
    return counts


def ring_rank(rank: int, world: int, device: str = "cuda:0") -> dict:
    """Phase 18d in one of two processes sharing the card (gloo): dlrm-small
    in row mode with the batch-sharded index stream on (1, 2), a warm-up
    step and ``RING_STEPS`` timed steps with the ``ring`` index exchange bit
    for bit the ``fused`` one's (losses and this rank's state); then ``bf16``
    with the error feedback at M = 2, the first step held to the same two-rank step
    on the CPU (the loss, this rank's embedding and dense shards within
    phase 6's tolerances of the whole state's largest update).  Returns the
    losses, launches, collective bytes, the err slab's reading and the
    failures."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.dist import comm
    from repro_torch.dist.exchange import ExchangeConfig
    from repro_torch.launch.mesh import make_mesh

    dev = mesh_rank_setup(device)
    failures: list[str] = []
    mesh = make_mesh((1, 2), ("data", "model"), dev)
    cpu_mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    base = dataclasses.replace(dlrm_small(), idx_input="sharded")
    bs = hybrid_batches(base, mesh, stage_batches(base, RING_STEPS + 1, dev))
    out = {"counts": {}, "stats": {}, "wall_s": {}}
    runs = {}
    for impl in ("fused", "ring"):
        cfg = dataclasses.replace(base, exchange=ExchangeConfig(impl=impl))
        state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        step = dlrm.make_train_step(cfg, mesh)
        state, first, _, _ = run_steps(step, state, bs[:1])  # a warm-up, held as the rest
        mesh.stats.reset()
        state, losses, c, wall = run_steps(step, state, bs[1:])
        runs[impl] = (state, torch.cat([first, losses]))
        out["counts"][impl], out["wall_s"][impl] = c, wall
        out["stats"][impl] = {k: {kind: v // RING_STEPS for kind, v in d.items()}
                              for k, d in mesh.stats.as_dict().items() if isinstance(d, dict)}
    out["ring_same"] = (same_losses(runs["fused"][1], runs["ring"][1])
                        and bitwise_equal(runs["fused"][0], runs["ring"][0]))
    out["losses"] = runs["ring"][1].tolist()
    if not out["ring_same"]:
        failures.append(f"18d rank {rank}: the ring exchange's steps differ from the fused one's")
    del runs
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(base, exchange_dtype="bf16", microbatches=2)
    state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
    before = weights.state_to(state, "cpu")
    ref_state, ref_loss = dlrm.make_train_step(cfg, cpu_mesh)(
        weights.state_to(state, "cpu"), {k: v.cpu() for k, v in bs[0].items()})
    state, loss = dlrm.make_train_step(cfg, mesh)(state, bs[0])
    torch.cuda.synchronize()
    tag = f"18d rank {rank} bf16 M=2"
    close_or_fail(f"{tag}: loss vs plain step", loss.cpu(), ref_loss, TRAIN_TOL["loss"], 0.0,
                  failures)
    g_cpu = cpu_mesh.group(cpu_mesh.axis_names)
    for part, got, want, old in (
            ("embedding shard", master(state["emb"]), card_master(ref_state["emb"], dev),
             card_master(before["emb"], dev)),
            ("dense shard", dense_master(state["dense"], 2, rank).cpu(),
             dense_master(ref_state["dense"], 2, rank), dense_master(before["dense"], 2, rank))):
        upd = float(comm.all_gather((want - old).abs().max()[None].cpu(), g_cpu).max())
        close_or_fail(f"{tag}: {part} vs plain step (atol {TRAIN_TOL['update']:g} x the largest "
                      f"update, {upd:.3e})", got, want, 0.0, TRAIN_TOL["update"] * upd, failures)
    err, ref_err = state["dense"]["err"].cpu(), ref_state["dense"]["err"]
    out["err"] = {"max": float(err.abs().max()), "cpu_max": float(ref_err.abs().max()),
                  "max_abs_diff": float((err - ref_err).abs().max()),
                  "finite": bool(torch.isfinite(err).all())}
    if not out["err"]["finite"] or out["err"]["max"] == 0:
        failures.append(f"{tag}: the err slab {out['err']} (want finite, nonzero at M = 2)")
    out["loss"], out["ref_loss"] = float(loss), float(ref_loss)
    out["failures"] = failures
    return out


def ring_two_rank_phase(failures) -> dict:
    """Phase 18d: :func:`ring_rank` in two processes on the card
    (:func:`two_ranks`, gloo); any rank's failure fails the run.
    Returns both ranks' launches of the ring steps."""
    t0 = time.perf_counter()
    ranks = two_ranks(ring_rank, timeout_s=600)
    log(f"18d: 2 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s")
    counts: dict = {}
    for r, res in enumerate(ranks):
        failures.extend(res["failures"])
        for impl in ("fused", "ring"):
            st = res["stats"][impl]
            log(f"18d rank {r} {impl}: {res['wall_s'][impl] / RING_STEPS * 1e3:.1f} ms a step "
                f"(host clock, two ranks on one card over gloo); launches {res['counts'][impl]}; "
                "collectives a step, calls and bytes out: " + "; ".join(
                    f"{k} x{st['calls'][k]} {st['bytes_out'][k]}" for k in st["calls"]))
        log(f"18d rank {r}: ring bit for bit fused over {RING_STEPS + 1} steps: {res['ring_same']}; "
            f"losses {', '.join(f'{x:.6f}' for x in res['losses'])}; bf16 + error feedback M=2, "
            f"first step loss {res['loss']:.7f} vs the CPU's {res['ref_loss']:.7f}, err slab "
            f"{res['err']}")
        for k, v in res["counts"]["ring"].items():
            counts[k] = counts.get(k, 0) + v
        c = res["counts"]["ring"]
        want = {**{k: 0 for k in c}, "embedding_bag": RING_STEPS, "dot_interaction": RING_STEPS,
                "embedding_update": RING_STEPS, "split_sgd": 4 * RING_STEPS}
        if c != want:
            failures.append(f"18d rank {r}: ring launches {c}, want {want}")
    return counts


def plain_select_hot(layout, cnt: np.ndarray, hot_rows: int, seed: int) -> np.ndarray:
    """The hot set of ``cnt`` (the counts in layout order) in the reference's
    total order, on the host with numpy alone: per table a ``lexsort`` by
    count descending, then lowbias32(gid ^ seed) ascending (uint32)."""
    from repro_torch.core import sharded_embedding as se
    spec = layout.spec
    _, g2l = se.layout_gid_maps(layout)
    out = []
    for t, rows_t in enumerate(spec.table_rows):
        gids = int(spec.row_offsets[t]) + np.arange(rows_t, dtype=np.int64)
        c = cnt[g2l[gids]].astype(np.int64)
        x = (gids.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)).astype(np.uint64)
        for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
            x = ((x ^ (x >> np.uint64(shift))) * np.uint64(mul)) & np.uint64(0xFFFFFFFF)
        h = x ^ (x >> np.uint64(16))
        top = np.lexsort((h, -c))[:hot_rows]
        ids = np.where(c[top] > 0, gids[top], -1)
        out.append(np.concatenate([ids, np.full(hot_rows - ids.size, -1)]))
    return np.concatenate(out).astype(np.int32)


def plain_hit_counts(layout, hot_ids: list, batches: list) -> tuple[float, float]:
    """(hit lookups, all-hot bags) of ``batches``, batch i against the hot
    set ``hot_ids[i]`` (gids, -1 empty), on the host with numpy alone: a
    lookup hits when it is in its table's range and its gid is hot; a bag
    when all its lookups do.  Each batch's counts are exact and are added
    up in fp32, one batch at a time, as the step's metrics vector adds them
    (a total past 2^24 rounds)."""
    spec = layout.spec
    s2t = np.asarray(layout.slot_to_table)
    off = np.asarray(spec.row_offsets, np.int64)[s2t][None, :, None]
    cap = np.asarray(spec.table_rows, np.int64)[s2t][None, :, None]
    lookups = bags = np.float32(0)
    for ids, b in zip(hot_ids, batches):
        idx = b["idx"].cpu().numpy().astype(np.int64)
        hot = np.zeros(spec.total_rows + 1, bool)
        hot[ids[ids >= 0]] = True
        ok = (idx >= 0) & (idx < cap)
        hit = ok & hot[np.where(ok, idx + off, -1)]
        lookups = np.float32(lookups + np.float32(hit.sum()))
        bags = np.float32(bags + np.float32(hit.all(axis=2).sum()))
    return float(lookups), float(bags)


def cache_phase(dev, batches, held, failures) -> dict:
    """Phase 19a-d: the hot-row cache, the step metrics, their drain and the
    stage profile, dlrm-small at full size.  19a: table mode with the
    sharded stream on a one-rank NCCL group, ``HOT_ROWS`` a table, promoted
    every ``PROMOTE_EVERY`` steps, ``allreduce``, the metrics on: the first
    step held to the CPU step; ``CACHE_STEPS`` steps (one under
    ``set_sync_debug_mode("error")``) bit for bit the same steps with the
    cache off (losses, store, dense state); the counts the bincount of the
    batches; the hot set the host's reference-order selection of them; the
    mirror the store's rows; the metrics' counts exact (the hit counts
    :func:`plain_hit_counts`'); the hit rate on a
    held-out batch, the busy ms a step with and without the cache and the
    epilogue's parts under the profiler.  19b: ``deferred:8``, the losses
    finite, the store's distance from 19a's.  19c: ``TrainLoop`` with the
    metrics drained every ``METRICS_EVERY`` steps: two heartbeat windows
    with a hit rate; the step p50 beside the loop without the metrics.
    19d: ``profile_stages`` of dlrm-small in row mode: six stages timed with
    their modelled bytes, flops and µs, the trace read back by the port's
    summary.  Returns the launch counts of the train steps and the loops
    (not of the epilogue's parts or the stage profile, each run alone)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import cache, dlrm, hybrid
    from repro_torch.core import sharded_embedding as se
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import data_parallel as dp
    from repro_torch.optim import row as row_optim
    from repro_torch.telemetry import Tracer
    from repro_torch.telemetry import metrics as step_mx
    from repro_torch.telemetry import stages as t_stages
    from repro_torch.telemetry import summarize as t_sum
    from repro_torch.train import TrainLoop, TrainLoopConfig

    counts: dict = {}

    def tally(got: dict) -> dict:
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return got

    torch.cuda.set_device(dev)
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev, group=dist.group.WORLD)
        cpu_mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        cold_cfg = dataclasses.replace(dlrm_small(), emb_mode="table", idx_input="sharded")
        cfg = dataclasses.replace(cold_cfg, hot_rows=HOT_ROWS, promote_every=PROMOTE_EVERY,
                                  hot_sync="allreduce", step_metrics=True)
        layout = hybrid.make_layout(cfg, mesh)
        E, B, S, P = cfg.emb_dim, cfg.batch, layout.num_orig_slots, cfg.pooling
        hot = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        start = weights.state_to(hot, dev)
        cold = weights.state_to({"emb": {k: v for k, v in hot["emb"].items() if k != "cnt"},
                                 "dense": hot["dense"]}, dev)
        log(f"19a mesh {mesh.shape} over {dist.get_backend()}; cache state: cnt "
            f"{tuple(hot['emb']['cnt'].shape)}, " + ", ".join(
                f"{k} {tuple(v.shape)} {v.dtype}" for k, v in hot["cache"].items())
            + f", metrics {tuple(hot['metrics'].shape)}")
        t0 = time.perf_counter()
        step, cold_step = dlrm.make_train_step(cfg, mesh), dlrm.make_train_step(cold_cfg, mesh)
        log(f"19a steps built in {time.perf_counter() - t0:.2f} s (the promotion's plan)")

        # the first step against the same step on the CPU
        t0 = time.perf_counter()
        cpu_state, cpu_loss = dlrm.make_train_step(cfg, cpu_mesh)(
            weights.state_to(hot, "cpu"), {k: v.cpu() for k, v in batches[0].items()})
        log(f"19a CPU step: {time.perf_counter() - t0:.1f} s")

        # 19a: the cached steps; the hot set each step enters with, kept on
        # the host for the hit counts
        gid_off = torch.as_tensor(layout.spec.row_offsets[layout.slot_to_table],
                                  dtype=torch.int32, device=dev)
        losses, step_hot_ids = [], []
        torch.cuda.synchronize()
        ops.reset_launches()
        for i, b in enumerate(batches[:CACHE_STEPS]):
            step_hot_ids.append(hot["cache"]["hot_ids"].cpu().numpy())
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                hot, loss = step(hot, b)
            except RuntimeError as e:
                failures.append(f"19a: a cached step synchronised with the host: {e}")
                raise SystemExit("19a failed:\n" + "\n".join(failures))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses.append(loss)
            if i == 0:
                torch.cuda.synchronize()
                close_or_fail("19a first step: loss vs the CPU step", loss.cpu(), cpu_loss,
                              TRAIN_TOL["loss"], 0.0, failures)
                for part, got, want, old, tol in (
                        ("embedding store", master(hot["emb"]), card_master(cpu_state["emb"], dev),
                         master(start["emb"]), TABLE_STORE_TOL["update"]),
                        ("dense", dense_master(hot["dense"]).cpu(),
                         dense_master(cpu_state["dense"]), dense_master(start["dense"]).cpu(),
                         TRAIN_TOL["update"])):
                    upd = float((want - old).abs().max())
                    close_or_fail(f"19a first step: {part} vs the CPU step (atol {tol:g} x the "
                                  f"largest update, {upd:.3e})", got, want, 0.0, tol * upd,
                                  failures)
                bitwise_or_fail("19a first step: cnt vs the CPU step", hot["emb"]["cnt"].cpu(),
                                cpu_state["emb"]["cnt"], failures)
                bitwise_or_fail("19a first step: metrics vs the CPU step", hot["metrics"].cpu(),
                                cpu_state["metrics"], failures)
                del cpu_state
        torch.cuda.synchronize()
        launches = tally(ops.launches())
        ops.reset_launches()
        losses = torch.stack(losses).cpu()
        log(f"19a cached: {CACHE_STEPS} steps, launches {launches}; losses {float(losses[0]):.6f} "
            f"-> {float(losses[-1]):.6f}; one step under set_sync_debug_mode('error')")
        want_l = {**{k: 0 for k in launches}, "embedding_bag": 2 * CACHE_STEPS,
                  "dot_interaction": CACHE_STEPS, "embedding_update": CACHE_STEPS,
                  "split_sgd": CACHE_STEPS}
        if launches != want_l:
            failures.append(f"19a: launches {launches}, want {want_l} (the bag kernel twice a "
                            "step: the owner's bags and the hot bags)")
        cold, cold_losses, cold_launches, _ = run_steps(cold_step, cold, batches[:CACHE_STEPS])
        tally(cold_launches)
        same = {"losses": same_losses(losses, cold_losses),
                "store": all(bitwise_equal(hot["emb"][k], cold["emb"][k]) for k in cold["emb"]),
                "dense": bitwise_equal(hot["dense"], cold["dense"])}
        log(f"19a cached vs cold, {CACHE_STEPS} steps, bit for bit: {same}")
        for k, v in same.items():
            if not v:
                failures.append(f"19a: the cached steps' {k} differ from the cold steps'")

        # the counts, the hot set, the mirror and the metrics
        slot_off = torch.as_tensor(layout.slot_local_offsets[layout.slot_position],
                                   dtype=torch.int64, device=dev)
        want_cnt = torch.zeros(layout.total_rows, dtype=torch.int64, device=dev)
        for b in batches[:CACHE_STEPS]:
            want_cnt += torch.bincount((b["idx"].long() + slot_off[None, :, None]).reshape(-1),
                                       minlength=layout.total_rows)
        cnt = hot["emb"]["cnt"][:, 0]
        bitwise_or_fail("19a: cnt vs the bincount of the batches", cnt, want_cnt.to(torch.int32),
                        failures)
        t0 = time.perf_counter()
        want_ids = plain_select_hot(layout, cnt.cpu().numpy(), HOT_ROWS, cfg.sr_seed)
        log(f"19a: the host's reference-order selection in {time.perf_counter() - t0:.1f} s")
        ids = hot["cache"]["hot_ids"]
        bitwise_or_fail("19a: hot_ids vs the host's selection of cnt", ids.cpu(),
                        torch.from_numpy(want_ids), failures)
        _, g2l = se.layout_gid_maps(layout)
        g2l_t = torch.as_tensor(g2l, device=dev)
        members = ids >= 0
        bitwise_or_fail("19a: hot_w vs the store's rows",
                        hot["cache"]["hot_w"][members],
                        hot["emb"]["hi"][g2l_t[ids[members].long()].long()], failures)
        m = step_mx.drain(hot)
        hit_lookups, skipped = plain_hit_counts(layout, step_hot_ids, batches[:CACHE_STEPS])
        want_m = {"steps": float(CACHE_STEPS), "bags": float(CACHE_STEPS * B * S),
                  "rows_touched": float(CACHE_STEPS * B * S * P),
                  "hit_lookups": float(hit_lookups), "skipped_bags": float(skipped)}
        want_m["exchange_payload_bytes"] = (want_m["bags"] - want_m["skipped_bags"]) * E * 4
        log(f"19a metrics: {m}; counted on the host: {want_m}")
        for k, v in want_m.items():
            if m[k] != v:
                failures.append(f"19a: metrics {k} {m[k]}, want {v}")
        hit, _ = cache.hot_bag_local(layout, hot["cache"]["hot_w"], hot["cache"]["hot_pos"],
                                     held["idx"], None, gid_off)
        hit_rate = float(hit.float().mean())
        full = B * S * E * 4
        log(f"19a hit rate on a held-out batch: {hit_rate:.6f} of the bags all-hot (predicted "
            f"0.53); over the 20 steps {m['skipped_bags'] / m['bags']:.6f}; the forward "
            f"all-to-all's effective payload {m['exchange_payload_bytes'] / CACHE_STEPS / 1e6:.3f}"
            f" MB a step of {full / 1e6:.3f} MB (predicted 7.9)")
        if not 0 < hit_rate < 1:
            failures.append(f"19a: hit rate {hit_rate} on the held-out batch")

        # 19b: deferred:8 from the same start
        d_cfg = dataclasses.replace(cfg, hot_sync="deferred:8")
        d_state, d_losses, d_launch, _ = run_steps(dlrm.make_train_step(d_cfg, mesh),
                                                   weights.state_to(start, dev),
                                                   batches[:CACHE_STEPS])
        tally(d_launch)
        drift = float((master(d_state["emb"]) - master(hot["emb"])).abs().max())
        log(f"19b deferred:8, {CACHE_STEPS} steps: losses finite "
            f"{bool(d_losses.isfinite().all())}, {float(d_losses[0]):.6f} -> "
            f"{float(d_losses[-1]):.6f}; the store's largest distance from 19a's {drift:.3e}; "
            f"hot bags served {step_mx.drain(d_state)['skipped_bags']:.0f}")
        if not bool(d_losses.isfinite().all()):
            failures.append(f"19b: a deferred:8 loss is not finite: {d_losses}")
        del d_state
        torch.cuda.empty_cache()

        # the busy ms a step with and without the cache, and the epilogue's parts,
        # each alone under the profiler, at the step's inputs (the parts' launches
        # are side runs, not the steps', and are not counted)
        ops.reset_launches()
        it_h, it_c = iter(batches[:5]), iter(batches[:5])
        wall_h, busy_h, top_h = device_busy_ms(lambda: step(hot, next(it_h)), 5)
        wall_c, busy_c, top_c = device_busy_ms(lambda: cold_step(cold, next(it_c)), 5)
        tally(ops.launches())
        log(f"19a step under torch.profiler: cached {wall_h:.3f} ms wall, busy {busy_h:.3f} ms; "
            f"cold {wall_c:.3f} ms wall, busy {busy_c:.3f} ms; the cache adds "
            f"{busy_h - busy_c:.3f} ms busy a step (predicted 1-15)")
        log("19a cached step's top kernels: " + top_kernels(top_h[:10]))

        opt = row_optim.resolve(cfg)
        b0 = batches[0]
        idx_upd = step.stages.index_exchange(b0["idx"])[1]
        offs = torch.as_tensor(se.local_offsets(layout, 0), dtype=torch.int32, device=dev)
        srows, _, smsk, _ = se._row_sorted_streams(
            layout, (idx_upd + offs[None, :, None]).reshape(-1), P)
        scratch = hot["emb"]["cnt"].clone()
        epi = cache.CacheEpilogue(cfg, layout, opt, mesh.group(("model",)), dev)
        cnt_full = hot["emb"]["cnt"][:, 0].contiguous()
        emb_out = torch.zeros((B, S, E), device=dev)

        def bypass(idx):
            hit, bag = cache.hot_bag_local(layout, hot["cache"]["hot_w"], hot["cache"]["hot_pos"],
                                           idx, None, gid_off, layout_bags=B * S)
            return torch.where(hit[..., None], bag, emb_out)
        parts = {
            "cnt bump (one write a run)": lambda: row_optim.bump_counters(scratch, srows, smsk),
            "cnt bump as index_add_ (a yardstick, not on the path)":
                lambda: scratch.index_add_(0, srows, smsk[:, None]),
            "select_hot (topk)": lambda: cache.select_hot(layout, cnt_full, HOT_ROWS, cfg.sr_seed,
                                                          epi.plan),
            "refresh (int32 psum)": lambda: cache.refresh_hot_slab(
                layout, hot["emb"]["hi"], ids, epi.g2l, epi.group),
            "hot_positions": lambda: cache.hot_positions(layout.spec.total_rows, ids),
            "bypass (hot bags + where)": lambda: bypass(b0["idx"]),
            "the whole cache epilogue": lambda: epi(hot["cache"], hot["emb"]),
        }
        for name, fn in parts.items():
            _, busy, top = device_busy_ms(fn, 5)
            log(f"19a epilogue part {name}: busy {busy:.4f} ms; " + top_kernels(top[:4]))
        del scratch, emb_out, cold
        ops.reset_launches()
        torch.cuda.empty_cache()

        # 19c: the run loop draining the metrics
        base = ROOT / "build" / "cache_loop"
        base.mkdir(parents=True, exist_ok=True)
        p50 = {}
        for name, c in (("metrics", cfg), ("no metrics", dataclasses.replace(cfg,
                                                                          step_metrics=False))):
            hb = base / f"heartbeat_{name.replace(' ', '_')}.jsonl"
            hb.unlink(missing_ok=True)
            s0 = weights.state_to(start, dev)
            if not c.step_metrics:
                s0.pop("metrics")
            ops.reset_launches()
            loop = TrainLoop(TrainLoopConfig(steps=CACHE_STEPS, metrics_every=METRICS_EVERY,
                                             heartbeat_every=METRICS_EVERY,
                                             heartbeat_path=str(hb), log_every=1000),
                             dlrm.make_train_step(c, mesh), s0, iter(batches[:CACHE_STEPS]),
                             device=dev)
            loop.run()
            tally(ops.launches())
            recs = [json.loads(x) for x in hb.read_text().splitlines()]
            p50[name] = recs[0]["step_ms_p50"], recs[1]["step_ms_p50"]
            if c.step_metrics:
                rates = [(r["step"], r.get("cache_hit_rate")) for r in recs]
                log(f"19c heartbeats (step, cache_hit_rate): {rates}; windows "
                    f"{[r.get('metrics_window') for r in recs[:2]]}")
                if len(recs) < 2 or not all(r.get("cache_hit_rate", 0) > 0 for r in recs[:2]) \
                        or [r["step"] for r in recs[:2]] != [METRICS_EVERY, 2 * METRICS_EVERY]:
                    failures.append(f"19c: want two heartbeat windows with a hit rate, got {rates}")
            del loop, s0
        log(f"19c TrainLoop step p50 ms (first window, second): with the metrics "
            f"{p50['metrics']}, without {p50['no metrics']}")
        shutil_rmtree(base)
        del hot, start
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # 19d: the stage profile of dlrm-small in row mode, one rank, and its summary
    # (each stage run alone: side runs, whose launches are not counted)
    tr = Tracer(enabled=True)
    prof = t_stages.profile_stages(dlrm_small(), steps=3, tracer=tr, device=dev)
    ops.reset_launches()
    for name, r in prof["stages"].items():
        log(f"19d stage {name}: {r['ms']:.4f} ms; modelled at {prof['ranks_model']} ranks on "
            f"{prof['chip']}: {r['bytes'] / 1e6:.3f} MB, {r['flops'] / 1e9:.3f} GFLOP, "
            f"{r['modeled_us']:.2f} us ({r['comm']})")
    path = tr.export(str(ROOT / "build" / "stages_trace.json"))
    track = t_sum.summarize(path)["tracks"].get("pipeline_stages", {})
    log("19d summary of the exported trace, track pipeline_stages:\n"
        + t_sum.format_summary({"tracks": {"pipeline_stages": track}, "metrics": {},
                                "instants": {}, "serve": {}}))
    if sorted(track) != sorted(f"stage/{n}" for n in prof["stages"]) or len(track) != 6 \
            or any(r["count"] != 3 for r in track.values()):
        failures.append(f"19d: the summary's pipeline_stages track is {sorted(track)}")
    path.unlink()
    torch.cuda.empty_cache()
    return counts


INGEST_BATCHES = 10     # dlrm-small batches packed for phase 20a: 20 loop steps are two epochs
INGEST_STEPS = 20
INGEST_TIMED = 10       # loop steps timed each way (shuffled, sequential)
INGEST_BURSTS = (128, 32, 32, 32, 8, 8, 8, 8)   # 256 requests that reach every bucket
LAUNCH_ARGV = ("--arch", "dlrm-100m", "--batch", "2048", "--steps", "40", "--host-presort",
               "--optimizer", "adagrad_rowwise", "--lr", "0.03", "--ckpt-every", "20",
               "--publish-every", "10", "--serve-smoke")
LAUNCH_PREEMPT = 30
PROFILE_RUNS = 4        # profile_stages' runs of each stage: warmup 1 + steps 3
PATH_KERNELS = ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd")


def leaf_crcs(tree) -> list:
    """CRC32 of every leaf of a tree of tensors (copied to the host)."""
    import zlib
    import torch
    from repro_torch.optim import data_parallel as dp
    return [zlib.crc32(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())
            for t in dp.tree_leaves(tree)]


def ingest_phase(dev, failures) -> dict:
    """20a: dlrm-small at full width trained from packed shards.

    ``pack_synthetic`` writes ``INGEST_BATCHES`` batches of zipf(1.05)
    samples into ``build/ingest/`` (deleted at the end).  Gates: the
    shuffled reader's first batch bit for bit numpy's gather of
    ``epoch_order(0)`` from the packed arrays; epoch 1's order not epoch
    0's; a ``TrainLoop`` of ``INGEST_STEPS`` steps (two epochs) over
    ``HostPipeline(ShardedReader(shuffle=True, seed=0))`` (prefetch 2) with
    ``SnapshotPublisher(publish_every=10)`` as its step hook and
    ``combined_serve_stats`` in its heartbeat: every loss finite, its first
    step bit for bit a bare step on the same batch from the same start
    state, versions 1, 2 and 3 published with 2 and 3 kept, version 2's
    CRC32s unchanged after 10 more in-place steps, every heartbeat carrying
    ``serve.snapshot``, rows 1, 2, 4 and 5 once a step; then 256 requests
    served from ``registry.current()``, their logits within ``LOGIT_TOL``
    of the plain forward.  Prints the pack's s and MB/s, the gather's ms a
    batch shuffled and sequential, ``HostPipeline``'s prep and wait, and the
    loop's samples/s for ``INGEST_TIMED`` steps each way beside the bare
    step's.  Returns the launch counts of the loops and the served
    batches."""
    import json
    import shutil
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data import HostPipeline, ShardedReader
    from repro_torch.data.format import pack_synthetic
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousBatchingServer, SnapshotPublisher,
                                   combined_serve_stats, make_bucket_scorers)
    from repro_torch.train import TrainLoop, TrainLoopConfig

    cfg = dlrm_small()
    B = cfg.batch
    root = ROOT / "build" / "ingest"
    shutil.rmtree(root, ignore_errors=True)
    counts = {k: 0 for k in ops.launches()}
    try:
        t0 = time.perf_counter()
        man = pack_synthetic(root / "ds", cfg.table_rows, cfg.pooling, INGEST_BATCHES * B,
                             num_dense=cfg.num_dense, alpha=ALPHA, seed=SEED,
                             samples_per_shard=B)
        pack_s = time.perf_counter() - t0
        mb = sum(f.stat().st_size for f in (root / "ds").iterdir()) / 1e6
        log(f"20a: packed {man['num_samples']} dlrm-small samples into {len(man['shards'])} "
            f"shards, {mb:.1f} MB, in {pack_s:.3f} s: {mb / pack_s:.1f} MB/s")

        rd = ShardedReader(root / "ds", batch=B, seed=0, shuffle=True)
        o0, o1 = rd.epoch_order(0), rd.epoch_order(1)
        if np.array_equal(o0, o1):
            failures.append("20a: epoch 1's order is epoch 0's")
        S, P = cfg.spec.num_tables, cfg.pooling
        dense = np.concatenate([sh.dense for sh in rd.shards])
        labels = np.concatenate([sh.labels for sh in rd.shards])
        idx = np.stack([np.concatenate([sh._indices[k].reshape(sh.num_samples, P)
                                        for sh in rd.shards]) for k in range(S)], axis=1)
        first = next(iter(rd.epoch_batches(0)))
        sel = o0[:B]
        same = (np.array_equal(first["idx"], idx[sel]) and np.array_equal(first["dense_x"],
                                                                          dense[sel])
                and np.array_equal(first["labels"], labels[sel]))
        log(f"20a: the reader's first batch bit for bit numpy's gather of epoch_order(0): {same}; "
            f"epoch 1's order differs: {not np.array_equal(o0, o1)}")
        if not same:
            failures.append("20a: the reader's first batch is not numpy's gather of epoch_order(0)")
        del dense, labels, idx

        def gather_ms(reader) -> float:
            t = time.perf_counter()
            n = sum(1 for _ in reader.epoch_batches(0))
            return (time.perf_counter() - t) / n * 1e3
        shuffled_ms = gather_ms(rd)
        seq_ms = gather_ms(ShardedReader(root / "ds", batch=B, shuffle=False))
        log(f"20a: gather a batch of {B}: shuffled {shuffled_ms:.3f} ms, sequential {seq_ms:.3f} "
            f"ms (the mmap views), {INGEST_BATCHES} batches each")

        S0 = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        step = dlrm.make_train_step(cfg, device=dev)
        staged = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in first.items()}
        bare, bare_loss = step(weights.state_to(S0, dev), staged)
        bare_loss = float(bare_loss)
        staged_all = [{k: torch.from_numpy(np.array(v)).to(dev) for k, v in b.items()}
                      for b in rd.epoch_batches(0)]
        timing = weights.state_to(S0, dev)
        step(timing, staged_all[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in staged_all:
            timing, loss = step(timing, b)
            float(loss)
        torch.cuda.synchronize()
        bare_rate = len(staged_all) * B / (time.perf_counter() - t)
        del timing, staged_all
        torch.cuda.empty_cache()

        pub = SnapshotPublisher(cfg, publish_every=10)
        pub.publish(0, S0)
        seen = {}

        def hook(completed, state):
            if completed == 1:
                seen["first"] = bitwise_equal(state, bare)
            pub(completed, state)
            if completed == 10:
                seen["v2"] = leaf_crcs(pub.registry.get(2).state)

        hb = root / "heartbeat.jsonl"
        pipe = HostPipeline(ShardedReader(root / "ds", batch=B, seed=0, shuffle=True))
        loop = TrainLoop(TrainLoopConfig(steps=INGEST_STEPS, prefetch=2, log_every=10,
                                         heartbeat_path=str(hb), heartbeat_every=10),
                         step, S0, pipe, device=dev, step_hook=hook,
                         serve_stats=combined_serve_stats(pub))
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        state = loop.run()
        wall = time.perf_counter() - t
        pipe.close()
        got = ops.launches()
        log(f"20a: {INGEST_STEPS} loop steps over the shuffled reader in {wall:.3f} s "
            f"({INGEST_STEPS * B / wall:.0f} samples/s with the gated hook's compare and CRCs); "
            f"losses {loop.losses[0]:.6f} -> {loop.losses[-1]:.6f}; launches {got}")
        for k, v in got.items():
            counts[k] += v
        if not np.isfinite(loop.losses).all() or len(loop.losses) != INGEST_STEPS:
            failures.append(f"20a: losses {loop.losses}")
        if got != {k: INGEST_STEPS if k in PATH_KERNELS else 0 for k in got}:
            failures.append(f"20a: launches {got}, want {INGEST_STEPS} of each of {PATH_KERNELS}")
        log(f"20a: the loop's first step bit for bit the bare step (loss {bare_loss:.6f}): "
            f"{seen.get('first')}; its loss {loop.losses[0]:.6f}")
        if not seen.get("first") or loop.losses[0] != bare_loss:
            failures.append("20a: the loop's first step is not the bare step on its batch")
        del bare
        v2_after = leaf_crcs(pub.registry.get(2).state) if pub.registry.get(2) else None
        log(f"20a: published {pub.publishes} versions, kept {pub.registry.versions()}; version "
            f"2's CRC32s after 10 more in-place steps unchanged: {v2_after == seen.get('v2')}")
        if pub.publishes != 3 or pub.registry.versions() != [2, 3]:
            failures.append(f"20a: publishes {pub.publishes}, kept {pub.registry.versions()}")
        if v2_after is None or v2_after != seen.get("v2"):
            failures.append("20a: version 2 changed under the in-place steps")
        recs = [json.loads(ln) for ln in hb.read_text().splitlines()]
        log(f"20a: heartbeats at steps {[r['step'] for r in recs]}, serve "
            f"{[r.get('serve', {}).get('snapshot') for r in recs]}")
        if not recs or any("version" not in r.get("serve", {}).get("snapshot", {})
                           for r in recs):
            failures.append("20a: a heartbeat lacks serve.snapshot")

        # the loop's samples/s each way, on the trained state
        for tag, shuffle in (("shuffled", True), ("sequential", False)):
            pipe = HostPipeline(ShardedReader(root / "ds", batch=B, seed=1, shuffle=shuffle))
            timed = TrainLoop(TrainLoopConfig(steps=INGEST_TIMED, prefetch=2,
                                              log_every=INGEST_TIMED), step, state, pipe,
                              device=dev)
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            state = timed.run()
            wall = time.perf_counter() - t
            pipe.close()
            for k, v in ops.launches().items():
                counts[k] += v
            a = np.asarray(timed.monitor.times) * 1e3
            pst, fst = pipe.stats, timed.batches.stats
            log(f"20a: loop {tag}: {INGEST_TIMED * B / wall:.0f} samples/s over {wall:.3f} s "
                f"(bare step {bare_rate:.0f}: {INGEST_TIMED * B / wall / bare_rate:.3f}x); step "
                f"ms p50 {np.percentile(a, 50):.3f}; HostPipeline prep {pst['prep_s']:.3f} s for "
                f"{pst['batches']} batches ({pst['prep_s'] / max(pst['batches'], 1) * 1e3:.2f} "
                f"ms each), prefetch's wait on it {pst['wait_s']:.3f} s; the loop's wait on "
                f"prefetch {fst['wait_s']:.3f} s ({fst['wait_s'] / wall * 100:.1f} % of the wall)")
            if not np.isfinite(timed.losses).all():
                failures.append(f"20a: {tag} losses {timed.losses}")

        # 256 requests from the newest version
        reg = pub.registry
        offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32,
                                  device=dev)
        reqs = make_requests(cfg, sum(INGEST_BURSTS), np.random.default_rng(SEED + 20))
        fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: reg.current().state, device=dev)
        scores = []
        ops.reset_launches()
        with ContinuousBatchingServer(fns, pad, max_wait_ms=2.0) as srv:
            start = 0
            for n in INGEST_BURSTS:
                scores += [h.result(timeout=300.0)
                           for h in [srv.submit(r) for r in reqs[start:start + n]]]
                start += n
            stats = srv.stats()
        for k, v in ops.launches().items():
            counts[k] += v
        scores = np.asarray(scores, np.float32)
        snap = reg.current().state
        want = torch.cat([plain_logits(cfg, snap, pad(reqs[i:i + BUCKETS[-1]], BUCKETS[-1]),
                                       offsets).cpu()
                          for i in range(0, len(reqs), BUCKETS[-1])])[:len(reqs)].double()
        gotl = torch.logit(torch.from_numpy(scores).double())
        err = close_or_fail(f"20a: {len(reqs)} served logits (v{reg.current().version}) vs the "
                            "plain forward", gotl, want, 0.0, LOGIT_TOL, failures)
        log(f"20a: served {stats['requests']} requests in {stats['batches']}, logits within "
            f"{err:.3e} of the plain forward")
        del state, S0, pub, reg, snap
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts


def launcher_phase(dev, failures) -> dict:
    """20b: the launcher on the card, then 20c: the 100M example.

    A dataset of dlrm-100m samples packed by ``python -m repro_torch.data
    synthetic`` into ``build/launch/`` (deleted at the end); then
    ``launch.train.main`` in this process (so its launches count) with
    ``LAUNCH_ARGV`` and a checkpoint, trace and event directory there:
    once with ``--preempt-at 30`` (a ``preempted`` event, a final
    checkpoint), once without (it restores the final checkpoint and runs to
    40).  Gates: every loss finite; the restore at the preempted run's
    last step; ``trace.json`` parses and ``python -m repro_torch.telemetry
    summarize`` reads it; a line for every bucket the serving smoke served;
    row 9 launched once a step (and ``PROFILE_RUNS`` times by each run's
    stage profile).  Beside the summary, at once, one subprocess ``python -m
    repro_torch.launch.train --arch dlrm-smoke --steps 5`` and one ``python
    examples/train_dlrm_100m_torch.py`` at its defaults (its own assert: the
    loss falls).  Returns the launch counts of the two in-process runs."""
    import contextlib
    import io
    import json
    import os
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    root = ROOT / "build" / "launch"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    counts = {k: 0 for k in ops.launches()}

    procs = []

    def start(args):
        procs.append(subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        return args, time.perf_counter(), procs[-1]

    def finish(run, timeout=600) -> str:
        args, t, proc = run
        out, err = proc.communicate(timeout=timeout)
        log(f"20: `{' '.join(args[:4])} ...` exit {proc.returncode} in "
            f"{time.perf_counter() - t:.1f} s; its last lines:\n    "
            + "\n    ".join(out.strip().splitlines()[-3:]))
        if proc.returncode != 0:
            failures.append(f"20: {' '.join(args)} exited {proc.returncode}:\n"
                            + out[-2000:] + err[-4000:])
        return out

    try:
        ds, tr, ck = root / "ds", root / "trace", root / "ckpt"
        finish(start(["-m", "repro_torch.data", "synthetic", "--out", str(ds), "--tables",
                      ",".join(["200000"] * 8), "--pooling", "20", "--num-dense", "64",
                      "--num-samples", "16384", "--samples-per-shard", "4096", "--alpha",
                      str(ALPHA)]))
        if failures:
            return counts
        argv = [*LAUNCH_ARGV, "--data-dir", str(ds), "--ckpt-dir", str(ck), "--trace-dir",
                str(tr)]
        runs = []
        for extra in (["--preempt-at", str(LAUNCH_PREEMPT)], []):
            buf = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = launch.main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = ops.launches()
            for k, v in got.items():
                counts[k] += v
            text = buf.getvalue()
            log(f"20b: launch.train.main({' '.join(argv[:6])} ... {' '.join(extra)}) in "
                f"{wall:.1f} s: {len(out['losses'])} steps from {out['start_step']}, launches "
                f"{got}; its output:\n    " + "\n    ".join(text.strip().splitlines()))
            runs.append((out, got, text))
            n = len(out["losses"])
            if not n or not np.isfinite(out["losses"]).all():
                failures.append(f"20b: losses {out['losses']}")
            rows9 = got["embedding_update_adagrad_rowwise"]
            if rows9 != n + PROFILE_RUNS:
                failures.append(f"20b: row 9 launched {rows9} times for {n} steps "
                                f"(+{PROFILE_RUNS} by the stage profile)")
            pct = out.get("serve", {}).get("percentiles", {})
            missing = [b for b in pct if f"[serve]   bucket {b:>4}:" not in text]
            if not pct or missing:
                failures.append(f"20b: bucket lines missing for {missing or 'every bucket'}")
        (first, _, _), (second, _, text2) = runs
        events = [json.loads(ln) for ln in (tr / "events.jsonl").read_text().splitlines()]
        stop = next((e["step"] for e in events if e["kind"] == "preempted"), None)
        log(f"20b: events {[(e['kind'], e.get('step')) for e in events]}; the second run "
            f"restored at {second['start_step']}")
        if stop is None or stop != len(first["losses"]) or second["start_step"] != stop \
                or stop + len(second["losses"]) != 40:
            failures.append(f"20b: preempted at {stop}, restored at {second['start_step']}, "
                            f"{len(second['losses'])} more steps")
        if CheckpointManager(ck).latest_valid_step() != 40:
            failures.append("20b: no valid checkpoint at step 40")
        json.loads((tr / "trace.json").read_text())
        summary, smoke, example = map(finish, [start(a) for a in (
            ["-m", "repro_torch.telemetry", "summarize", str(tr / "trace.json")],
            ["-m", "repro_torch.launch.train", "--arch", "dlrm-smoke", "--steps", "5"],
            ["examples/train_dlrm_100m_torch.py"])])
        if "track: pipeline_stages" not in summary or "train/step" not in summary:
            failures.append("20b: the trace summary lacks the stage profile or the steps")
        if "[train] done: first loss" not in smoke:
            failures.append("20b: the module entry did not finish its run")
        if "mean loss first-10" not in example:
            failures.append("20c: the 100M example did not report its losses")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts


# phase 21: the four recsys archetypes at their published widths
# (configs/{fm,bst,sasrec,din}_arch.py, configs/recsys_common.RECSYS_SHAPES)
RECSYS_ARCHS = ("fm", "bst", "sasrec", "din")
RECSYS_STEPS = 10        # timed train steps at train_batch, zipf and uniform in turn
RECSYS_REQUESTS = 256    # serve_p99: one burst through the server, buckets up to 512
RECSYS_BUCKETS = BUCKETS + (512,)
RECSYS_TOPK = 128
# the first step's dense weights against the CPU step: within 1e-2 of the step's
# largest update (TRAIN_TOL) plus one fp32 ulp of the weight, relative (2^-23):
# SASRec's largest dense update is 3.5e-7, and 1e-2 of it is below one ulp of a
# weight of 0.05, so a bound of 1e-2 alone asks for bits no two summation orders
# give
RECSYS_DENSE_ULP = 2.0 ** -23
# the served scores against the CPU forward of the same requests: each within this
# share of the largest CPU score's magnitude.  The scores of a state drawn at the
# published widths are small (the tables start at U(+-1/sqrt(mean rows)), the logits
# at 1e-4 to 5e-3), so a fixed atol would pass any answer.  FM has no bf16 product
# (1.2e-10 against scores up to 5.1e-3 on the H100); in the others a bf16
# intermediate may round the other way on the two devices (BST 6.4e-5 against
# 3.0e-3, 2.1 % of it).  A control (the snapshot's rows rolled by one) must fall
# outside it.
RECSYS_SERVE_SHARE = {"fm": 1e-5, "bst": 5e-2, "sasrec": 5e-2, "din": 5e-2}
# rows 1 and 5-12 at the archetypes' widths: (archetype, E, slots); the bag at
# train_batch, the row updates on a stream of NARROW_UPDATE_BATCH samples (their
# plain versions sum on the CPU), tables of NARROW_ROWS rows
NARROW_WIDTHS = (("fm", 11, 39), ("din", 18, 105), ("sasrec", 50, 150))
NARROW_ROWS = 1_000_000
NARROW_BAG_BATCH = 65536
NARROW_UPDATE_BATCH = 8192
NARROW_KINDS = (("split_sgd", "fused_update_split"), ("sgd", "fused_update_fp32"),
                *((name, fn) for name, fn, _ in STATEFUL))


def recsys_mdef(name: str, batch: int):
    """The archetype ``name`` at its published widths (its config's
    ``make_mdef``) and its retrieval target slot."""
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{name}_arch")
    return mod.make_mdef(batch), mod.TARGET_SLOT


def to_card(batch: dict, dev) -> dict:
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def narrow_kernel_phase(dev, rng, failures) -> dict:
    """Rows 1 and 5-12 at the archetypes' widths E = 11, 18, 50, whose rows
    are no whole number of 16-byte chunks (the narrow paths), against their
    plain versions bit for bit.  Row 1: the bag stage at train_batch
    (65,536 samples, the archetype's slots, one lookup a bag) on zipf ids of
    a bf16 table of NARROW_ROWS rows, unweighted and weighted, and on a view
    of the table one value past the allocator's alignment.  Rows 5-12: each
    kind on the sorted stream of NARROW_UPDATE_BATCH samples of those ids,
    with a bf16 cotangent.  Timed on the card (the bag as a CUDA graph);
    returns ``{kernel: {E: timings}}`` for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data.synthetic import zipf_indices
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import row as row_optim
    from repro_torch.optim.split_sgd import split_fp32

    out: dict = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    B, M, lr = NARROW_BAG_BATCH, NARROW_ROWS, 0.01
    for arch, E, S in NARROW_WIDTHS:
        W32 = (torch.rand((M, E), device=dev, generator=gen) - 0.5) * 2e-3
        hi = split_fp32(W32)[0]
        idx = torch.from_numpy(zipf_indices(rng, M, (B, S, 1), ALPHA).astype(np.int32)).to(dev)
        zero = torch.zeros(S, dtype=torch.int32, device=dev)
        wgt = torch.rand((B, S, 1), device=dev, generator=gen) + 0.5
        view = torch.empty(M * E + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, E)
        view.copy_(hi)
        e = out.setdefault("embedding_bag", {})
        err = 0.0
        for tag, W, w in (("", hi, None), (" weighted", hi, wgt), (" offset view", view, None)):
            got = ops.embedding_bag_stage(W, idx, zero, M, w)
            want = ref.embedding_bag_stage(W, idx, zero, M, w)
            torch.cuda.synchronize()
            err = max(err, bitwise_or_fail(f"embedding_bag {arch} E={E} [{B}x{S}]{tag}", got, want,
                                           failures))
        U = int(torch.unique(idx).numel())
        # each distinct row read once (bf16), the ids read, the fp32 sums written
        bms, by = bound_ms(U * E * 2 + idx.numel() * 4 + B * S * E * 4, B * S * E, FP32_FLOPS)
        gid = idx.reshape(-1).long()
        e[str(E)] = dict(ms=graph_ms(lambda: ops.embedding_bag_stage(hi, idx, zero, M)),
                         plain_ms=time_ms(lambda: ref.embedding_bag_stage(hi, idx, zero, M)),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         # a bag of one lookup is a gather: F.embedding of the same rows,
                         # timed as the kernel is (a graph)
                         library_ms=graph_ms(lambda: F.embedding(gid, hi)))
        t = e[str(E)]
        log(f"embedding_bag {arch} E={E}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / t['ms'] * 100:.1f}% of bound")
        del view, wgt

        # rows 5-12 on the sorted stream of the first NARROW_UPDATE_BATCH samples
        stream = eu.sort_lookups(idx[:NARROW_UPDATE_BATCH].reshape(-1), None, M, 1)
        L = stream[0].numel()
        _, run_counts = torch.unique_consecutive(stream[0], return_counts=True)
        U, longest = int(run_counts.numel()), int(run_counts.max())
        dY = (torch.randn((L, E), device=dev, generator=gen) * 1e-3).to(torch.bfloat16)
        for name, fn_name in NARROW_KINDS:
            opt = row_optim.get(name)
            kname = ROW_KERNEL[name]
            if opt.split:
                store = (hi.clone(), split_fp32(W32)[1])
            else:
                key, width, dtype = opt.state[0] if opt.state else (None, 0, None)
                store = (W32.clone(),) + (() if key is None else
                                          (random_state(name, (M, width or E), dev, gen, stream),))
            extra = (() if name in ("split_sgd", "sgd") else
                     (getattr(opt, dict((n, h) for n, _, h in STATEFUL)[name]),))
            sr = seed_args(name, SR_SEEDS[0], dev)
            want = tuple(t.clone() for t in store)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(ref, fn_name)(*want, *stream, dY, lr, *extra, *sr)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = tuple(t.clone() for t in store)
            kernel = getattr(ops, fn_name)
            kernel(*got, *stream, dY, lr, *extra, *sr)
            torch.cuda.synchronize()
            err = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                err = max(err, bitwise_or_fail(f"{kname} {arch} E={E} [{L} lookups], slab {i}", g,
                                               w, failures))
            # touched rows of every slab read and written, the cotangent and the stream read
            row_bytes = sum(t.element_size() * (t.shape[1] if t.dim() > 1 else 1) for t in store)
            bms, by = bound_ms(U * row_bytes * 2 + dY.numel() * 2 + L * 16, L * E * 2, FP32_FLOPS)
            ms = time_ms(lambda: kernel(*got, *stream, dY, lr, *extra, *sr))
            library_ms = None  # no PyTorch call computes a row optimizer's fused step
            if name == "sgd":
                # row 6's yardstick, as at E = 64: index_add_ of pre-gathered rows (atomics)
                g = torch.where(stream[2][:, None] != 0, dY[stream[1].long()].float(), 0.0)
                r64 = stream[0].long()
                library_ms = time_ms(lambda: got[0].index_add_(0, r64, g, alpha=-lr))
                del g
            out.setdefault(kname, {})[str(E)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                library_ms=library_ms, longest=longest,
                # the walk of the longest run, which one block takes while the rest finish
                ns_per_position=ms * 1e6 / longest)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            log(f"{kname} {arch} E={E}: kernel {ms:.4f} ms ({ms * 1e6 / longest:.2f} ns a position "
                f"of the longest run, {longest}), plain {plain_ms:.1f} ms, library {lib}, bound "
                f"{bms:.4f} ms ({by}), {bms / ms * 100:.1f}% of bound")
            del store, want, got
        del W32, hi, idx, dY, stream
        torch.cuda.empty_cache()
    return out


def recsys_batches(mdef, dev, n: int) -> list[dict]:
    """n batches of ``mdef``'s synthetic stream on the card, zipf(1.05) and
    uniform ids in turn (the masks all ones, as the stream makes them)."""
    from repro_torch.data.synthetic import hybrid_stream
    zipf, uniform = hybrid_stream(SEED, mdef, ALPHA), hybrid_stream(SEED + 1, mdef, 0.0)
    return [to_card(next(zipf if i % 2 == 0 else uniform), dev) for i in range(n)]


def recsys_train_phase(name, mdef, state, batches, dev, failures) -> tuple[dict, dict]:
    """The archetype's train step at train_batch: its first step held to
    the same step's plain versions on the CPU (the loss within TRAIN_TOL's
    1e-4 relative, the dense weights within 1e-2 of the step's largest
    update plus one fp32 ulp of each weight, RECSYS_DENSE_ULP) and its
    sparse update bit for bit against the plain update of the card's own
    cotangent.  Both run on a gather of the batch's touched rows (FM's store
    is 8.26 GB): a lookup's row is its table's whatever the gather, so the
    bags and the runs' sums are the full table's.  Then one step without a
    host sync and RECSYS_STEPS timed steps under
    ``set_sync_debug_mode("error")``, one launch of rows 1, 5 and 4 a step.
    Returns the timed steps' launch counts and their numbers."""
    import torch
    from repro_torch.core import hybrid, pipeline
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.optim import data_parallel as dp
    from repro_torch.optim import row as row_optim

    step = hybrid.make_train_step(mdef, device=dev)
    opt = row_optim.resolve(mdef)
    layout = hybrid.make_layout(mdef)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    b0 = batches[0]
    gids = (b0["idx"] + offsets[None, :, None]).reshape(-1)
    touched = torch.unique(gids)
    local = torch.searchsorted(touched, gids).to(torch.int32).cpu()
    before = {k: v[touched].cpu() for k, v in state["emb"].items()}
    lo0, err0 = state["dense"]["lo"], state["dense"]["err"]
    dense0 = {"hi": dp.pack_hi(dp.tree_map(lambda t: t.cpu(), state["dense"]["hi"]),
                               lo0.numel())[1],  # a copy, one flat buffer as the step keeps it
              "lo": lo0.to("cpu", copy=True),
              "err": None if err0 is None else err0.to("cpu", copy=True)}
    before_dense = dense_master(dense0)
    # the plain step on the CPU: the bag of the gathered forward rows, the dense
    # forward and backward, the dense update
    t0 = time.perf_counter()
    S = layout.num_orig_slots
    cpu_b0 = {k: v.cpu() for k, v in b0.items()}
    emb_cpu = ref.embedding_bag_stage(row_optim.fwd_weights(opt, before),
                                      local.reshape(b0["idx"].shape),
                                      torch.zeros(S, dtype=torch.int32), touched.numel())
    cpu_stages = pipeline.build_stages(mdef, layout, resolve_mesh(None, "cpu"))
    ref_loss, ref_g, _ = cpu_stages.dense_fwd_bwd(dense0["hi"], emb_cpu, cpu_b0)
    ref_dense = cpu_stages.dense_update(dense0, ref_g)
    cpu_s = time.perf_counter() - t0
    st = step.stages
    idx_fwd, idx_upd = st.index_exchange(b0["idx"])
    emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd)
    # the loss sits at ln 2 whatever the rows at this init; the bag output and the
    # dense weights below are what read them
    bitwise_or_fail(f"{name} train step, bag output vs the plain bag of the gathered rows",
                    emb_out.float(), emb_cpu.to(dev), failures)
    loss, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b0)
    dY = st.dY_exchange(d_emb)
    state["emb"] = st.sparse_update(state["emb"], idx_upd, dY, None, state.get("sr"))
    state["dense"] = st.dense_update(state["dense"], g_dense)
    torch.cuda.synchronize()
    log(f"{name}: one step against the plain versions on the CPU ({cpu_s:.1f} s there, "
        f"{touched.numel()} touched rows gathered): loss {float(loss):.7f} vs "
        f"{float(ref_loss):.7f}")
    close_or_fail(f"{name} train step loss vs plain step", loss.cpu(), ref_loss,
                  TRAIN_TOL["loss"], 0.0, failures)
    got, want = dense_master(state["dense"]).cpu(), dense_master(ref_dense)
    upd = float((want - before_dense).abs().max())
    close_or_fail(f"{name} train step, dense weights vs plain step (atol {TRAIN_TOL['update']:g} "
                  f"x the largest update, {upd:.3e}, rtol one fp32 ulp)", got, want,
                  RECSYS_DENSE_ULP, TRAIN_TOL["update"] * upd, failures)
    # the sparse update against its plain version on the card's own cotangent
    plain = row_optim.apply_sparse(opt, {k: v.clone() for k, v in before.items()},
                                   eu.sort_lookups(local, None, touched.numel(), mdef.pooling),
                                   dY.reshape(-1, mdef.spec.dim).cpu(), mdef.emb_lr)
    for k, v in plain.items():
        bitwise_or_fail(f"{name} train step, {k} ({touched.numel()} touched rows) vs the plain "
                        f"update of the card's cotangent", state["emb"][k][touched].cpu(), v,
                        failures)
    del before, plain, emb_out, d_emb, dY, g_dense, dense0, ref_dense, emb_cpu
    torch.cuda.empty_cache()

    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batches[1])
    except RuntimeError as e:
        failures.append(f"{name}: the train step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ops.reset_launches()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for i in range(RECSYS_STEPS):
            state, loss = step(state, batches[i % len(batches)])
            losses.append(loss)
    except RuntimeError as e:
        failures.append(f"{name}: a timed train step synchronised with the host: {e}")
        return ops.launches(), {}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    losses = torch.stack(losses).cpu().numpy()
    n = RECSYS_STEPS
    want = {**{k: 0 for k in counts}, "embedding_bag": n, ROW_KERNEL[opt.name]: n, "split_sgd": n}
    if counts != want:
        failures.append(f"{name}: launches {counts}, want {want}")
    if not np.isfinite(losses).all():
        failures.append(f"{name}: a loss is not finite: {losses}")
    stats = {"samples_per_s": n * mdef.batch / wall, "step_ms": wall / n * 1e3}
    log(f"{name}: {n} steps of B={mdef.batch} (zipf and uniform in turn) in {wall:.3f} s: "
        f"{stats['samples_per_s']:.0f} samples/s, {stats['step_ms']:.2f} ms a step; losses "
        f"{np.array2string(losses, precision=5, max_line_width=200)}")
    for tag, b in (("zipf", batches[0]), ("uniform", batches[1])):
        wall_ms, busy_ms, top = device_busy_ms(lambda: step(state, b), 2)
        stats[f"busy_ms_{tag}"], stats[f"wall_ms_{tag}"] = busy_ms, wall_ms
        log(f"{name} {tag}: device busy {busy_ms:.3f} ms a step "
            f"({(1 - busy_ms / wall_ms) * 100:.1f}% idle of {wall_ms:.3f} ms under the profiler); "
            "top kernels: "
            + top_kernels(top[:6]))
    return counts, stats


def recsys_serve_phase(name, mdef, state, dev, failures) -> dict:
    """serve_p99: RECSYS_REQUESTS requests of one sample, in one burst,
    through ``ContinuousBatchingServer`` and ``make_bucket_scorers`` on a
    snapshot published from the train state (``SnapshotPublisher``, which
    clones the forward slabs); every score finite and within
    RECSYS_SERVE_SHARE of the largest CPU score of the CPU forward
    (``dense_score`` on the CPU of the same rows).  Then the bucket scorer
    of the largest bucket, called on the padded requests, bit for bit
    against the plain forward on the card at the same shape (the plain bag,
    then the same ``dense_score``).  A control, the snapshot's rows rolled
    by one (each lookup reads its neighbour's row), scored by the same
    scorer, must fail both checks.  Returns the launch counts."""
    import dataclasses
    import torch
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.synthetic import hybrid_stream
    from repro_torch.kernels import ops, ref
    from repro_torch.optim.data_parallel import tree_map
    from repro_torch.serve import ContinuousBatchingServer, SnapshotPublisher, make_bucket_scorers

    publisher = SnapshotPublisher(mdef, publish_every=1)
    publisher.publish(RECSYS_STEPS, state)
    reg = publisher.registry
    fns, pad = make_bucket_scorers(mdef, RECSYS_BUCKETS, lambda: reg.current().state, device=dev)
    req = next(hybrid_stream(SEED + 5, dataclasses.replace(mdef, batch=RECSYS_REQUESTS), ALPHA))
    req.pop("labels", None)
    payloads = [{k: v[i] for k, v in req.items()} for i in range(RECSYS_REQUESTS)]
    ops.reset_launches()
    t0 = time.perf_counter()
    with ContinuousBatchingServer(fns, pad, max_wait_ms=2.0) as srv:
        scores = np.array([h.result(timeout=300.0) for h in [srv.submit(p) for p in payloads]],
                          np.float32)
        stats = srv.stats()
        pct = srv.percentiles()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    n_batches = sum(stats["batches"].values())
    log(f"{name}: served {stats['requests']} requests in {n_batches} batches {stats['batches']} "
        f"in {wall:.3f} s; " + "; ".join(f"bucket {b}: p50 {p['p50_ms']:.3f} ms, p99 "
                                         f"{p['p99_ms']:.3f} ms, n {p['n']}"
                                         for b, p in sorted(pct.items())))
    if counts != {**{k: 0 for k in counts}, "embedding_bag": n_batches}:
        failures.append(f"{name}: serving launches {counts}, want the bag once a batch")
    snap = reg.current().state
    layout = se.make_layout(mdef.spec, 1, "row", slot_to_table=mdef.slot_to_table)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)

    def cpu_forward(emb_w):
        gids = torch.from_numpy(req["idx"]).to(dev) + offsets[None, :, None]
        emb = emb_w[gids[..., 0].long()].float().cpu()
        return mdef.dense_score(tree_map(lambda t: t.cpu(), snap["dense_hi"]), emb,
                                {k: torch.from_numpy(v) for k, v in req.items()})
    want = cpu_forward(snap["emb_w"])
    if scores.shape != (RECSYS_REQUESTS,) or not np.isfinite(scores).all():
        failures.append(f"{name}: served scores shape {scores.shape}, finite "
                        f"{np.isfinite(scores).all()}")
    atol = RECSYS_SERVE_SHARE[name] * float(want.abs().max())
    label = (f"{name} served scores vs the CPU forward ({RECSYS_REQUESTS}; atol "
             f"{RECSYS_SERVE_SHARE[name]:g} x the largest |score|)")
    close_or_fail(label, torch.from_numpy(scores), want, 0.0, atol, failures)
    log(f"  {name} scores: min {scores.min():.6g}, max {scores.max():.6g}")

    # the largest bucket's scorer against the plain forward on the card, same shape
    bucket = max(RECSYS_BUCKETS)
    padded = pad(payloads, bucket)
    emb = ref.embedding_bag_stage(snap["emb_w"], padded["idx"], offsets, layout.rows_per_shard,
                                  padded.get("weights"))
    plain = mdef.dense_score(snap["dense_hi"], emb, padded)[:RECSYS_REQUESTS].cpu()
    direct = torch.from_numpy(fns[bucket](padded)[:RECSYS_REQUESTS])
    bitwise_or_fail(f"{name} bucket {bucket} scorer vs the plain forward on the card", direct,
                    plain, failures)
    # the control: rows rolled by one, through the same scorer, must fail both checks
    rolled = torch.roll(snap["emb_w"], 1, 0)
    reg.publish(dict(snap, emb_w=rolled))
    control = torch.from_numpy(fns[bucket](padded)[:RECSYS_REQUESTS])
    seen: list = []
    err_cpu = close_or_fail(f"control: {label}", control, want, 0.0, atol, seen)
    err_card = bitwise_or_fail(f"control: {name} bucket {bucket} scorer vs the plain forward",
                               control, plain, seen)
    if len(seen) != 2:
        failures.append(f"{name}: a snapshot with its rows rolled by one passes the serving "
                        f"checks ({seen})")
    log(f"  {name} serving control (rows rolled by one): {err_cpu:.3e} from the CPU forward "
        f"(atol {atol:.3e}), {err_card:.3e} from the plain forward on the card")
    del publisher, reg, snap, rolled, emb
    return counts


def recsys_retrieval_phase(name, mdef, target, state, query, dev, failures) -> dict:
    """retrieval_cand: one query against 2^20 candidates (the first 2^20 rows
    of the target slot's table, as bf16 forward rows), twice, the second
    timed; its top-128 held to the plain scorer's on the same candidates
    (the plain bag, then the same chunked ``dense_score`` and ``topk``).
    Returns the launch counts of the two calls and the numbers."""
    import torch
    from repro_torch.configs.recsys_common import RECSYS_SHAPES
    from repro_torch.core import hybrid
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import row as row_optim

    n = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    fn = hybrid.make_retrieval_step(mdef, None, n, target, RECSYS_TOPK, device=dev)
    W = row_optim.fwd_weights(row_optim.resolve(mdef), state["emb"])
    layout = hybrid.make_layout(mdef)
    t = int(layout.slot_to_table[target])
    start = int(mdef.spec.row_offsets[t])
    cand = W[start:start + n].to(torch.bfloat16)
    q = {k: v[:1] for k, v in query.items() if k != "labels"}
    ops.reset_launches()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, i = fn(state, q, cand)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launches()
    # the plain scorer
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    emb = ref.embedding_bag_stage(W, q["idx"], offsets, layout.rows_per_shard, round_bf16=False)
    scores = torch.empty(n, device=dev)
    chunk = hybrid.RETRIEVAL_CHUNK
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        e = emb.expand((m,) + tuple(emb.shape[1:])).clone()
        e[:, target] = cand[c0:c0 + m].float()
        scores[c0:c0 + m] = mdef.dense_score(
            state["dense"]["hi"], e, {k: q[k].expand((m,) + tuple(q[k].shape[1:])) for k in q
                                      if k != "idx"})
    pv, pi = hybrid.topk_stable(scores, RECSYS_TOPK)
    # the top-k alone on these scores: the stable sort the step takes (the
    # reference's order among ties) against torch.topk, which it replaced
    topk_ms = {"topk_stable": time_ms(lambda: hybrid.topk_stable(scores, RECSYS_TOPK)),
               "torch.topk": time_ms(lambda: torch.topk(scores, RECSYS_TOPK))}
    torch.cuda.synchronize()
    log(f"{name}: retrieval of {n} candidates at slot {target} in chunks of {chunk}: "
        f"{times[1]:.2f} ms (first call {times[0]:.2f} ms); top score {float(v[0]):.6f}, "
        f"launches {counts}; the top-{RECSYS_TOPK} of {n} scores alone: topk_stable "
        f"{topk_ms['topk_stable']:.4f} ms, torch.topk {topk_ms['torch.topk']:.4f} ms")
    close_or_fail(f"{name} retrieval top-{RECSYS_TOPK} vs the plain scorer's", v, pv, 1e-6, 0.0,
                  failures)
    if not torch.equal(i.cpu(), pi.cpu()):
        failures.append(f"{name}: the retrieval's top-{RECSYS_TOPK} candidates are not the plain "
                        "scorer's")
    if counts != {**{k: 0 for k in counts}, "embedding_bag": 2}:
        failures.append(f"{name}: retrieval launches {counts}, want the bag once a call")
    return counts, {"ms": times[1], "first_ms": times[0], "chunk": chunk, "candidates": n,
                    "topk_ms": topk_ms}


def recsys_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 21: FM, BST, SASRec and DIN at their published widths, each
    from a state drawn on the card: train_batch (recsys_train_phase),
    serve_p99 (recsys_serve_phase), retrieval_cand (recsys_retrieval_phase).
    Returns the launch counts of the three and each archetype's numbers."""
    import torch
    from repro_torch.configs.recsys_common import RECSYS_SHAPES
    from repro_torch.core import hybrid

    counts: dict = {}
    numbers: dict = {}

    def add(got):
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    for name in RECSYS_ARCHS:
        t0 = time.perf_counter()
        mdef, target = recsys_mdef(name, RECSYS_SHAPES["train_batch"]["batch"])
        state = hybrid.init_state(mdef, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        batches = recsys_batches(mdef, dev, 4)
        torch.cuda.synchronize()
        log(f"{name}: {mdef.spec.total_rows} rows x E={mdef.spec.dim} "
            f"({sum(v.numel() * v.element_size() for v in state['emb'].values()) / 1e9:.2f} GB "
            f"store), {hybrid.dense_sizes(mdef)} dense values, "
            f"{hybrid.make_layout(mdef).num_orig_slots} slots; state and 4 batches in "
            f"{time.perf_counter() - t0:.1f} s")
        got, train = recsys_train_phase(name, mdef, state, batches, dev, failures)
        add(got)
        if failures:
            return counts, numbers
        add(recsys_serve_phase(name, mdef, state, dev, failures))
        got, retr = recsys_retrieval_phase(name, mdef, target, state, batches[0], dev, failures)
        add(got)
        numbers[name] = {"train": train, "retrieval": retr,
                         "seconds": time.perf_counter() - t0}
        del state, batches
        torch.cuda.empty_cache()
        if failures:
            return counts, numbers
        log(f"{name}: {numbers[name]['seconds']:.1f} s in all")
    return counts, numbers


# phase 22: the paper's Fig. 16 run (examples/split_sgd_convergence_torch.py)
FIG16_STEPS = 200
FIG16_GAP = 5e-3        # the example's own check: split's final-20 mean within it of fp32's
# phase 23: mesh serving, ranks sharing the card over gloo; the launcher's smoke at two ranks
MESH_SERVE_MODES = ("row", "table")
# 23a's rows are scaled in place to U(-0.01, 0.01), from the trainer's init scale
# 1 / sqrt(mean rows) = 1e-3, at which the moved-rows control (which must fail the
# serving gate's 3e-3) moved only 44 of 256 logits past it; at 0.01 it moved 229, the
# served logits' gap unchanged (5.8e-4)
MESH_SERVE_SCALE = 1e-2
MESH_SERVE_ARGV = ("--arch", "dlrm-small", "--ranks", "2", "--steps", "10", "--batch", "512",
                   "--publish-every", "5", "--serve-smoke")
# phase 24: dlrm-mlperf served at full size.  Its drawn rows are scaled in place to
# U(-0.05, 0.05), from the trainer's init scale 1 / sqrt(mean rows) = 3.7e-4, at which
# the bags move a logit by less than the serving gate's 3e-3 and a wrong row could not
# fail it
MLPERF_SCALE = 0.05
MLPERF_MARGIN = 4e9     # bytes left free beside the table for the batches and plain forwards


class PhaseClock:
    """The seconds of each phase of the run, logged as each ends; once
    ``counts`` (the run's launch counts by kernel) is set, also what each
    phase added to them."""

    def __init__(self, t_run: float):
        self.t_run = self.t_last = t_run
        self.seconds: dict = {}
        self.counts: dict | None = None
        self.seen: dict = {}

    def mark(self, tag: str) -> None:
        now = time.perf_counter()
        self.seconds[tag] = round(now - self.t_last, 1)
        added = ""
        if self.counts is not None:
            delta = {k: v - self.seen.get(k, 0) for k, v in self.counts.items()
                     if isinstance(v, int) and v != self.seen.get(k, 0)}
            self.seen = {k: v for k, v in self.counts.items() if isinstance(v, int)}
            added = f"; launches added {delta}"
        log(f"phase {tag}: {now - self.t_last:.1f} s; the whole run so far "
            f"{now - self.t_run:.1f} s{added}")
        self.t_last = now


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fig16_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 22: the paper's Fig. 16 claim on the card, the four modes of
    ``examples/split_sgd_convergence_torch.py`` for 200 steps each from one
    seeded start.  First the first ``split`` step, kernels (row 1's bag
    forward, row 2's interaction, row 4 on each of the 11 leaves) against
    the plain versions on
    the card (the bag's autograd through ``ref.embedding_bag``, each leaf's
    step ``ref.split_sgd``): the loss within 1e-5 relative, every fp32 master
    within 1e-2 of the step's largest update; row 1 and row 4 timed at the
    example's shapes.  Then the run: the four final-20 means and both gaps
    printed, ``gap_split`` under 5e-3, every loss finite, rows 1 and 2 once
    a step and row 4 once a leaf of a split step.  Returns the run's launch counts
    and the two kernels' entries at these shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import split_sgd as S
    from repro_torch.optim.data_parallel import tree_leaves, tree_map

    ex = load_example("split_sgd_convergence_torch")
    cfg = ex.config()
    data = ex.batches(cfg, FIG16_STEPS, dev)
    params = ex.init_params(cfg, dev)
    n_leaves = len(tree_leaves(params))
    k_state = ex.start("split", tree_map(torch.clone, params))
    p_state = ex.start("split", tree_map(torch.clone, params))
    ops.reset_launches()
    _, k_loss = ex.step("split", cfg, k_state, data[0], ex.LR)
    torch.cuda.synchronize()
    first = ops.launches()
    want = {**{k: 0 for k in first}, "embedding_bag": 1, "dot_interaction": 1,
            "split_sgd": n_leaves}
    if first != want:
        failures.append(f"22 first split step: launches {first}, want {want}")

    def plain_bag(W, g):
        return ref.embedding_bag(W, g, W.shape[0])
    p_loss, grads = ex.value_and_grad(cfg, p_state.params.hi, data[0], bag=plain_bag)
    for h, lo, g in zip(tree_leaves(p_state.params.hi), tree_leaves(p_state.params.lo),
                        tree_leaves(grads)):
        ref.split_sgd(h.view(-1), lo.view(-1), g.float().reshape(-1).contiguous(), ex.LR)
    got = tree_leaves(S.materialize_fp32(k_state))
    want_m = tree_leaves(S.materialize_fp32(p_state))
    start = tree_leaves(S.materialize_fp32(ex.start("split", params)))
    largest = max(float((w - s).abs().max()) for w, s in zip(want_m, start))
    err_loss = close_or_fail("22 first split step: loss, kernels vs plain versions on the card",
                             k_loss.view(1), p_loss.view(1), 1e-5, 0.0, failures)
    atol = TRAIN_TOL["update"] * largest
    err = max(close_or_fail(f"22 first split step: leaf {i} {tuple(a.shape)} master vs plain "
                            f"(atol 1e-2 x the largest update {largest:.3e})", a, b, 0.0, atol,
                            failures)
              for i, (a, b) in enumerate(zip(got, want_m)))

    # row 1 and row 4 at the example's shapes: the batch's bag of the bf16 table, the
    # largest leaf's step (the table, 8000 x 16)
    W = k_state.params.hi["emb"]
    g = data[0]["idx"] + torch.as_tensor(cfg.spec.row_offsets, dtype=torch.int32,
                                         device=dev)[None, :, None]
    B, Sl, P = g.shape
    E, rows = W.shape[1], W.shape[0]
    bag_err = close_or_fail(f"22 embedding_bag [{B},{Sl},{P}] x [{rows},{E}] bf16",
                            ops.embedding_bag(W, g, rows), ref.embedding_bag(W, g, rows),
                            *KERNEL_TOL["embedding_bag"], failures)
    unique = int(torch.unique(g).numel())
    bms, by = bound_ms(unique * E * 2 + g.numel() * 4 + B * Sl * E * 4, g.numel() * E, FP32_FLOPS)
    flat = g.view(B * Sl, P)
    bag = dict(max_abs_err=bag_err, ms=graph_ms(lambda: ops.embedding_bag(W, g, rows)),
               plain_ms=time_ms(lambda: ref.embedding_bag(W, g, rows)),
               library_ms=graph_ms(lambda: F.embedding_bag(flat, W, mode="sum")),
               bound_ms=bms, bound_by=by, shape=[B, Sl, P, E])
    hi = k_state.params.hi["emb"].reshape(-1).clone()
    lo = k_state.params.lo["emb"].reshape(-1).clone()
    n = hi.numel()
    gr = torch.randn(n, device=dev) * 1e-2
    want_h, want_l = ref.split_sgd(hi.clone(), lo.clone(), gr, ex.LR)
    ops.split_sgd(hi, lo, gr, ex.LR)
    sgd_err = max(bitwise_or_fail(f"22 split_sgd [{n}] hi", hi, want_h, failures),
                  bitwise_or_fail(f"22 split_sgd [{n}] lo", lo, want_l, failures))
    bms4, by4 = bound_ms(n * 12, n * 2, FP32_FLOPS)

    def kern():
        ops.split_sgd(hi, lo, gr, ex.LR)
    step4 = dict(max_abs_err=sgd_err, first_step_err=err, ms=flushed_ms(kern),
                 ms_l2_warm=graph_ms(kern),
                 plain_ms=time_ms(lambda: ref.split_sgd(hi, lo, gr, ex.LR)), bound_ms=bms4,
                 bound_by=by4, library_ms=None, shape=[n])
    log(f"22 embedding_bag [{B},{Sl},{P}] E {E}: kernel {bag['ms']:.4f} ms, plain "
        f"{bag['plain_ms']:.4f} ms, F.embedding_bag {bag['library_ms']:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); split_sgd [{n}]: kernel {step4['ms']:.4f} ms (L2 flushed), "
        f"{step4['ms_l2_warm']:.4f} ms warm, plain {step4['plain_ms']:.4f} ms, bound "
        f"{bms4:.4f} ms ({by4})")

    ops.reset_launches()
    means, seconds = {}, {}
    for mode in ex.MODES:
        t0 = time.perf_counter()
        losses, _ = ex.train(mode, FIG16_STEPS, device=dev, params=params, data=data)
        seconds[mode] = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            failures.append(f"22 {mode}: a loss is not finite")
        means[mode] = float(np.mean(losses[-20:]))
        log(f"22 {mode:7s}: final-20 mean loss {means[mode]:.5f} (first {losses[0]:.5f}); "
            f"{FIG16_STEPS} steps in {seconds[mode]:.2f} s")
    counts = ops.launches()
    gap_split = abs(means["split"] - means["fp32"])
    gap_bf16 = abs(means["bf16"] - means["fp32"])
    log(f"22 split-vs-fp32 gap {gap_split:.5f} | bf16-vs-fp32 gap {gap_bf16:.5f} | split8-vs-fp32 "
        f"gap {abs(means['split8'] - means['fp32']):.5f}")
    if not gap_split < FIG16_GAP:
        failures.append(f"22: Split-SGD's final-20 mean {means['split']:.5f} is {gap_split:.5f} "
                        f"from fp32's {means['fp32']:.5f}, not under {FIG16_GAP} (paper Fig. 16)")
    steps = len(ex.MODES) * FIG16_STEPS
    want = {**{k: 0 for k in counts}, "embedding_bag": steps, "dot_interaction": steps,
            "split_sgd": 2 * FIG16_STEPS * n_leaves}
    if counts != want:
        failures.append(f"22 Fig. 16 run: launches {counts}, want {want}")
    log("22 numbers: " + json.dumps({"means": means, "gap_split": gap_split, "gap_bf16": gap_bf16,
                                     "seconds": seconds, "first_loss_err": err_loss}))
    return counts, {"embedding_bag": bag, "split_sgd": step4}


def table_global_offsets(layout) -> np.ndarray:
    """Each original slot's first row in the global row space of a table-mode
    layout (its shard's window, then its table's offset in the shard)."""
    pos = np.asarray(layout.slot_position)
    return (pos // layout.slots_per_shard) * layout.rows_per_shard \
        + np.asarray(layout.slot_local_offsets)[pos]


def mesh_serve_rank(rank: int, world: int, device: str = "cuda:0",
                    scale: float = MESH_SERVE_SCALE) -> list[dict]:
    """Phase 23a in one of two processes sharing the card (gloo): dlrm-small
    at full width (``mlp_impl="pallas"``) on a (1, 2) mesh, in row and in
    table mode, a seeded state with its rows scaled to U(-scale, scale), its
    snapshot (this rank's shard) behind ``make_bucket_scorers(mesh=)``.
    Rank 0 serves 256 requests through a ``ContinuousBatchingServer``
    (buckets 8, 32, 128; bursts that reach each), rank 1 follows its
    batches.  Then every served batch again through both ranks'
    ``make_score_step``, gathered: bit for bit the served scores; and on
    rank 0 the plain forward of the gathered table: each served logit
    within ``LOGIT_TOL``, and the plain forward with every lookup moved to
    the next row of its table beyond it (the control).  Returns per mode
    the launch counts of the serving, the batches, the percentiles, the
    gaps and the failures."""
    import torch
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm, hybrid, pipeline
    from repro_torch.dist import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import (ContinuousBatchingServer, follow, make_bucket_scorers, release,
                                   snapshot_state)

    dev = mesh_rank_setup(device)
    mesh = make_mesh((1, 2), ("data", "model"), dev)
    g_all = mesh.group(("data", "model"))
    out = []
    for mode in MESH_SERVE_MODES:
        failures: list[str] = []
        tag = f"23a rank {rank} {mode}"
        cfg = dataclasses.replace(dlrm_small(), emb_mode=mode, mlp_impl="pallas")
        state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh=mesh)
        snap = snapshot_state(cfg, state)     # the state's own slabs: the scaling is both's
        snap["emb_w"].mul_(scale * float(np.sqrt(np.mean(cfg.table_rows))))
        fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: snap, mesh=mesh, device=dev)
        served = []

        def recorded(b, fn):
            def run(batch):
                s = fn(batch)
                served.append((b, {k: v.cpu() for k, v in batch.items()}, s))
                return s
            return run
        rec = {b: recorded(b, f) for b, f in fns.items()}
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pct = {}
        if mesh.rank == 0:
            reqs = make_requests(cfg, sum(INGEST_BURSTS), np.random.default_rng(SEED + 23))
            try:
                with ContinuousBatchingServer(rec, pad, max_wait_ms=2.0) as srv:
                    start = 0
                    for n in INGEST_BURSTS:
                        handles = [srv.submit(r) for r in reqs[start:start + n]]
                        for h in handles:
                            h.result(timeout=300.0)
                        start += n
                    pct = srv.percentiles()
            finally:
                release(mesh)
        else:
            follow(rec, mesh)
        wall = time.perf_counter() - t0
        counts = ops.launches()
        n_b = len(served)
        want = {**{k: 0 for k in counts}, "embedding_bag": n_b, "dot_interaction": n_b,
                "fused_mlp": 8 * n_b}
        if counts != want:
            failures.append(f"{tag}: launches {counts}, want {want} for {n_b} batches")
        score = hybrid.make_score_step(cfg, mesh)
        same = 0
        for b, batch, s in served:
            local = hybrid.local_batch(cfg, mesh, {k: v.to(dev) for k, v in batch.items()})
            want_s = comm.all_gather(score(state, local), g_all).cpu().numpy()
            same += int(want_s.tobytes() == np.asarray(s).tobytes())
        if same != n_b:
            failures.append(f"{tag}: {n_b - same} of {n_b} served batches differ from the ranks' "
                            "make_score_step")
        layout = hybrid.make_layout(cfg, mesh)
        emb_g = mesh.group(pipeline.emb_axes(cfg, mesh)[0])
        table = comm.all_gather(snap["emb_w"], emb_g)
        gap = off = 0.0
        n_off = n_req = 0
        if mesh.rank == 0:
            offs = layout.row_offsets if mode == "row" else table_global_offsets(layout)
            offs = torch.as_tensor(offs, dtype=torch.int32, device=dev)
            rows = torch.as_tensor(cfg.table_rows, dtype=torch.int32, device=dev)[None, :, None]
            glob = {"emb_w": table, "dense_hi": snap["dense_hi"]}

            def plain(bd, moved):
                idx = bd["idx"]       # table mode's in padded-slot order: back to the slots'
                if mode == "table":
                    idx = idx[:, torch.as_tensor(layout.slot_position, device=dev)]
                if moved:
                    idx = (idx + 1) % rows
                return plain_logits(cfg, glob, dict(bd, idx=idx), offs,
                                    round_bags=mode == "row").double().cpu()
            for b, batch, s in served:
                bd = {k: v.to(dev) for k, v in batch.items()}
                got_l = torch.logit(torch.from_numpy(np.asarray(s)).double())
                gap = max(gap, float((got_l - plain(bd, False)).abs().max()))
                d = (got_l - plain(bd, True)).abs()
                off, n_off, n_req = max(off, float(d.max())), n_off + int((d > LOGIT_TOL).sum()), \
                    n_req + d.numel()
            if gap > LOGIT_TOL:
                failures.append(f"{tag}: a served logit is {gap:.3e} from the plain forward's "
                                f"(limit {LOGIT_TOL})")
            if not off > LOGIT_TOL:
                failures.append(f"{tag}: the moved-rows control is within {LOGIT_TOL} of the "
                                f"served logits ({off:.3e}): the gate cannot see a wrong row")
        out.append({"mode": mode, "counts": counts, "batches": n_b, "bitwise": same,
                    "wall_s": wall, "percentiles": pct, "gap": gap, "control": off,
                    "control_outside": [n_off, n_req], "failures": failures,
                    "rows": int(snap["emb_w"].shape[0])})
        del state, snap, fns, rec, served, table, score
        torch.cuda.empty_cache()
    return out


def mesh_serving_phase(dev, failures) -> dict:
    """Phase 23: 23a serving on a (1, 2) mesh of two processes sharing the
    card (:func:`mesh_serve_rank`, row and table mode); 23b
    ``examples/serve_recsys_torch.py``'s path at one rank (DIN, 400 requests
    through a ``BatchingServer``, a top-16 of 4,096 candidates of 16 distinct
    ids); 23c the launcher's ``--serve-smoke`` (and ``--publish-every 5``) at
    two ranks: every score finite and in (0, 1), the snapshot 0 steps behind.
    Returns the launch counts of 23a's ranks and 23b."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    counts: dict = {}
    t0 = time.perf_counter()
    ranks = two_ranks(mesh_serve_rank, timeout_s=900)
    log(f"23a: 2 processes on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s")
    for i, mode in enumerate(MESH_SERVE_MODES):
        for r, res in enumerate(rk[i] for rk in ranks):
            failures.extend(res["failures"])
            for k, v in res["counts"].items():
                counts[k] = counts.get(k, 0) + v
            log(f"23a {mode}, rank {r} ({res['rows']} rows): {res['batches']} batches in "
                f"{res['wall_s']:.2f} s, {res['bitwise']} of them bit for bit make_score_step; "
                f"launches {res['counts']}"
                + (f"; largest logit gap to the plain forward {res['gap']:.3e}, the moved-rows "
                   f"control up to {res['control']:.3e} from the served logits, "
                   f"{res['control_outside'][0]} of {res['control_outside'][1]} beyond "
                   f"{LOGIT_TOL}" if r == 0 else ""))
            for b, p in sorted(res["percentiles"].items()):
                log(f"23a {mode} bucket {b}: n {p['n']}, p50 {p['p50_ms']:.3f} ms, p99 "
                    f"{p['p99_ms']:.3f} ms (host clock; two ranks on one card, payloads through "
                    "host memory)")
    if failures:
        return counts

    ex = load_example("serve_recsys_torch")
    ops.reset_launches()
    t0 = time.perf_counter()
    out = ex.serve(0, 1, "cuda")
    torch.cuda.synchronize()
    got = ops.launches()
    log(f"23b: serve_recsys_torch at one rank in {time.perf_counter() - t0:.1f} s: "
        f"{out['scored']} requests in {out['batches']} batches, {out['percentiles']}; top-"
        f"{ex.TOPK} ids {out['ids'].tolist()}; launches {got}")
    if out["scored"] != ex.REQUESTS or len(set(out["ids"].tolist())) != ex.TOPK:
        failures.append(f"23b: {out['scored']} requests scored, {len(set(out['ids'].tolist()))} "
                        f"distinct of the top {ex.TOPK}")
    if got["embedding_bag"] != out["batches"] + 1:  # a bag a batch, one for the query
        failures.append(f"23b: launches {got} for {out['batches']} batches and one query")
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    res = launch.main(list(MESH_SERVE_ARGV))
    serve = res["serve"]
    sc = serve["scores"]
    ok = bool(np.isfinite(sc).all() and ((sc > 0) & (sc < 1)).all())
    log(f"23c: {' '.join(MESH_SERVE_ARGV)}: {time.perf_counter() - t0:.1f} s; losses "
        f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}; {sc.shape[0]} scores finite and in "
        f"(0, 1): {ok}; freshness {serve['freshness']}; snapshot {res['snapshot']}")
    if not ok or sc.shape != (512,) or serve["freshness"]["steps_behind"] != 0 \
            or res["snapshot"]["publishes"] != 3:
        failures.append(f"23c: scores {sc.shape} ok {ok}, freshness {serve['freshness']}, "
                        f"snapshot {res['snapshot']}")
    return counts


def mlperf_phase(dev, rng, failures) -> tuple[list, dict]:
    """Phase 24: dlrm-mlperf served at full size on the card, row mode: its
    snapshot state ``{emb_w: bf16 [187,767,480, 128], dense_hi}`` (48.07
    GB) drawn on the card (``weights.init_snapshot``, which holds only a
    chunk of the table in fp32: a Split-SGD store, 96.1 GB, and an fp32
    table do not fit the 80 GB card), its rows scaled to ``MLPERF_SCALE``,
    after ``torch.cuda.empty_cache()`` and a check of
    ``torch.cuda.mem_get_info()`` that fails the run if it does not fit.
    Rows 1, 2 and 3 at its shapes (:func:`kernel_phase`: E 128, P 1, 26
    tables, the interaction's 27 features, fused_mlp's K 13, K 479 and N 1
    layers) against their plain versions, timed beside their bounds and
    library calls; then 1024 requests over buckets 8, 32, 128
    (:func:`serving_phase`): every score finite and in (0, 1), its logit
    within ``LOGIT_TOL`` of the plain forward's, and a control (each lookup
    moved to the next row of its table) beyond it.  Returns the kernel
    entries and the serving's launch counts."""
    import torch
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_mlperf
    from repro_torch.core import sharded_embedding as se
    from repro_torch.serve import SnapshotRegistry

    cfg = dataclasses.replace(dlrm_mlperf(batch=8192), mlp_impl="pallas")
    layout = se.make_layout(cfg.spec, 1)
    need = layout.total_rows * cfg.emb_dim * 2
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"24 dlrm-mlperf: {layout.total_rows} rows x {cfg.emb_dim} bf16 = {need / 1e9:.2f} GB "
        f"table; the card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by this process)")
    if free < need + MLPERF_MARGIN:
        failures.append(f"24: the {need / 1e9:.2f} GB table and {MLPERF_MARGIN / 1e9:.0f} GB "
                        f"beside it do not fit the {free / 1e9:.2f} GB free")
        return [], {}
    t0 = time.perf_counter()
    reg = SnapshotRegistry()
    state = weights.init_snapshot(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    state["emb_w"].mul_(MLPERF_SCALE * float(np.sqrt(np.mean(cfg.table_rows))))
    snap = reg.publish(state)
    del state
    torch.cuda.synchronize()
    log(f"24 snapshot: emb_w {tuple(snap.state['emb_w'].shape)} {snap.state['emb_w'].dtype}, "
        f"{snap.emb_bytes / 1e9:.3f} GB (fp32 would be {snap.fp32_emb_bytes / 1e9:.3f} GB), "
        f"total {snap.total_bytes / 1e9:.3f} GB, drawn in {time.perf_counter() - t0:.1f} s; the "
        f"card's memory in use {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    entries = kernel_phase(cfg, snap.state, offsets, dev, rng, failures)
    if failures:
        return entries, {}
    reqs = make_requests(cfg, N_REQUESTS, rng)
    counts = serving_phase(cfg, reg, offsets, dev, reqs, failures, control=True)
    del snap, reg
    torch.cuda.empty_cache()
    return entries, counts


# phase 30: internlm2-1.8b trained at full size (arXiv:2403.17297, nothing cut): B 4 x L
# 4096 in 2 microbatches, lr 1e-2, momentum 0.9, one batch repeated for 6 steps (the
# reference's own test memorises a repeated batch, tests/test_distributed.py)
LM_TRAIN = dict(batch=4, seq=4096, microbatch=2, steps=6, lr=1e-2, beta=0.9)
# 30a: one step of internlm2 at full width, its depth cut to 2 layers, B 2 x L 512, on the
# card and on the CPU (every kernel's plain version).  The loss within LM_GATE_TOL["loss"]
# relative; every leaf's update within LM_GATE_TOL["update"] of that leaf's largest: the
# bf16 products sum in other orders on the two (cuBLAS against the CPU's), so bf16
# cotangents round apart, as the port's CPU tests find against the JAX package (2.6e-2 of
# the largest update there)
LM_GATE = dict(layers=2, batch=2, seq=512)
# set from an H100 reading: the loss 1.85e-6 relative apart, the worst leaf's update
# 1.36e-2 of its largest (the embedding); the planted faults moved the loss by 2.16e-3 and
# an update by 0.37 to 1.45
LM_GATE_TOL = {"loss": 1e-4, "update": 3e-2}
# phase 31: qwen3-moe-30b-a3b at full width (hf:Qwen/Qwen3-30B-A3B; 128 experts, top 8,
# capacity factor 1.0), its depth cut to 2 of 48 layers, B 2 x L 2048, 3 steps on one
# batch.  Its MoE block's gradients against the plain version (autograd of plain gathers)
# with the routing pinned: dx and the router's within 2^-6 of each one's largest value (the
# plain backward adds a token's k = 8 cotangents in the index sort's order; dx 8.62e-3
# apart on an H100, the router's bit for bit)
MOE_TRAIN = dict(layers=2, batch=2, seq=2048, steps=3)
MOE_GRAD_TOL = 2 ** -6
# phase 32: the launcher's LM branch, each arch at the reference's reduced_lm sizes
LM_ARCHS = ("internlm2-1.8b", "gemma2-27b", "phi3-medium-14b", "qwen3-moe-30b-a3b",
            "deepseek-v2-236b")
LM_LAUNCH_ARGV = ("--batch", "8", "--seq", "128")
LM_LAUNCH_STEPS, LM_LAUNCH_PREEMPT = 4, 1


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}" if prefix
                                                           else k)]
    return [prefix]


def plain_update(h, lo, g, lr, mom, beta, chunk: int = 1 << 24) -> None:
    """Row 4's plain version over a flat leaf, ``chunk`` values at a time (its
    float64 temporaries stay the size of a chunk), in place."""
    from repro_torch.kernels import ref
    for s in range(0, h.numel(), chunk):
        e = min(s + chunk, h.numel())
        ref.split_sgd(h[s:e], lo[s:e], g[s:e], lr, None if mom is None else mom[s:e], beta)


class UpdateTap:
    """Inside ``with tap:``, every ``update_leaf`` of the LM step (row 4's
    kernel on the card) keeps copies of its inputs, runs, and is held bit for
    bit to row 4's plain version on those copies, so on the card's own
    gradients (``err`` the largest difference, ``leaves`` the count).
    ``check=False`` holds nothing; ``zero=(leaf, layer)`` plants a fault (and
    holds nothing): that leaf's gradient at that layer zeroed before the
    update.  ``seconds``: the updates' host time when nothing is held;
    ``tag`` the phase a failure names."""

    def __init__(self, failures, check: bool = True, zero=None, tag: str = "30a"):
        self.failures, self.check, self.zero = failures, check and zero is None, zero
        self.tag = tag
        self.leaves, self.err, self.seconds = 0, 0.0, 0.0

    def __enter__(self):
        from repro_torch.optim import split_sgd
        self.orig = update = split_sgd.update_leaf

        def tapped(h, lo, g, lr, mom=None, beta=0.0):
            import torch
            i = self.leaves
            self.leaves += 1
            if self.zero is not None and self.zero[0] == i:
                g = g.clone()
                g[self.zero[1]] = 0
            if not self.check:
                t0 = time.perf_counter()
                out = update(h, lo, g, lr, mom, beta)
                self.seconds += time.perf_counter() - t0
                return out
            want = [t.clone().view(-1) for t in (h, lo)] + [None if mom is None else
                                                           mom.clone().view(-1)]
            out = update(h, lo, g, lr, mom, beta)
            plain_update(*want[:2], g.reshape(-1), lr, want[2], beta)
            got = [h.view(-1), lo.view(-1)] + ([] if mom is None else [mom.view(-1)])
            for a, b in zip(got, want):
                ib = torch.int16 if a.element_size() == 2 else torch.int32
                if not bool((a.view(ib) == b.view(ib)).all()):
                    self.err = max(self.err, float((a.float() - b.float()).abs().max()))
                    self.failures.append(f"{self.tag}: leaf {i}: row 4 not bit for bit its plain "
                                         "version on the card's gradients")
            return out
        split_sgd.update_leaf = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.optim import split_sgd
        split_sgd.update_leaf = self.orig
        return False


def lm_train_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 30: internlm2-1.8b trained at full size on the card
    (``models.lm_steps``: the state's 1.89 B parameters split from fp32
    draws of a seeded generator, ``make_lm_train_step`` with LM_TRAIN), one
    batch repeated: every loss finite, the first within 0.5 of ln V (a
    random model), the last below the first, row 4 launched once a leaf a
    step (counted); step ms wall and the device's busy ms (torch.profiler,
    steps 2-6, p50; busy: the last step, traced), tokens/s, peak memory,
    the idle share.  Then row 4 at
    the model's largest leaf (its momentum variant, the gradient bf16) bit
    for bit its plain version, timed beside its bound and the plain version.
    Returns row 4's launches of the run and the phase's numbers."""
    import torch
    from repro_torch.configs import internlm2_1_8b
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps
    from repro_torch.optim.data_parallel import tree_leaves

    c = LM_TRAIN
    cfg = dataclasses.replace(internlm2_1_8b.config(), microbatch=c["microbatch"])
    B, L = c["batch"], c["seq"]
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    state = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(state["hi"])
    n_params = sum(t.numel() for t in leaves)
    s_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    log(f"30: {cfg.name} state: {n_params} parameters (param_count {cfg.param_count()}), "
        f"{s_bytes / 1e9:.2f} GB (hi bf16 + lo int16 + mom fp32), {len(leaves)} leaves, drawn "
        f"in {time.perf_counter() - t0:.1f} s; {free0 / 1e9:.2f} GB free before")
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(token_stream(SEED, cfg.vocab, B, L)).items()}
    step, _ = lm_steps.make_lm_train_step(cfg, B, L, lr=c["lr"], beta=c["beta"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    losses, walls, busy, tops = [], [], float("nan"), []
    for i in range(c["steps"]):
        out = {}

        def run():
            out["loss"] = step(state, batch)[1]
        if i < c["steps"] - 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        else:  # the last step traced: the card's kernels alone
            wall, busy, tops = device_busy_ms(run, 1)
        losses.append(float(out["loss"]))
        walls.append(wall)
        log(f"  step {i}: loss {losses[-1]:.4f}, wall {wall:.1f} ms")
    launches = ops.split_sgd.launches - before
    peak = torch.cuda.max_memory_allocated()
    wall50 = float(np.median(walls[1:]))
    log(f"  the last step: {walls[-1]:.1f} ms wall (traced), {busy:.1f} ms busy; its busiest "
        f"kernels: {top_kernels(tops[:8])}")
    if not all(np.isfinite(losses)):
        failures.append(f"30: a loss is not finite: {losses}")
    if abs(losses[0] - np.log(cfg.vocab)) > 0.5:
        failures.append(f"30: first loss {losses[0]:.4f}, not near ln V = "
                        f"{np.log(cfg.vocab):.4f}")
    if not losses[-1] < losses[0]:
        failures.append(f"30: the loss did not fall: {losses}")
    if launches != c["steps"] * len(leaves):
        failures.append(f"30: row 4 launched {launches} times in {c['steps']} steps, not once a "
                        f"leaf ({len(leaves)}) a step")
    nums = {"model": cfg.name, "params": n_params, "state_gb": s_bytes / 1e9,
            "batch": [B, L], "microbatch": c["microbatch"], "losses": losses,
            "ln_vocab": float(np.log(cfg.vocab)), "step_ms_wall": walls,
            "step_ms_wall_p50": wall50, "last_step_ms_busy": busy,
            "idle_share": 1 - busy / walls[-1], "tokens_per_s": B * L / wall50 * 1e3,
            "peak_gb": peak / 1e9, "split_sgd_launches_a_step": launches / c["steps"],
            "leaves": len(leaves)}
    log(f"30: losses {losses[0]:.4f} -> {losses[-1]:.4f} (ln V {np.log(cfg.vocab):.4f}); step "
        f"p50 {wall50:.1f} ms wall; the last {busy:.1f} ms busy (idle "
        f"{nums['idle_share']:.3f}); "
        f"{nums['tokens_per_s']:.0f} tokens/s; peak {peak / 1e9:.2f} GB; row 4 "
        f"{launches / c['steps']:.0f} launches a step")

    # row 4 at the largest leaf: the momentum variant with a bf16 gradient, as the step runs it
    names = leaf_names(state["hi"])
    j = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    n = leaves[j].numel()
    hi = leaves[j].view(-1).clone()
    lo = tree_leaves(state["lo"])[j].view(-1).clone()
    mom = tree_leaves(state["mom"])[j].view(-1).clone()
    del state, step, batch
    torch.cuda.empty_cache()
    g = (torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
         * 1e-2).to(torch.bfloat16)
    want = [hi.clone(), lo.clone(), mom.clone()]
    plain_update(*want[:2], g, c["lr"], want[2], c["beta"])
    ops.split_sgd(hi, lo, g, c["lr"], mom, c["beta"])
    torch.cuda.synchronize()
    err = max(bitwise_or_fail(f"30: split_sgd momentum [{n}] {names[j]} {part}", a, b, failures)
              for part, a, b in zip(("hi", "lo", "mom"), (hi, lo, mom), want))
    del want
    torch.cuda.empty_cache()

    def kern():
        ops.split_sgd(hi, lo, g, c["lr"], mom, c["beta"])
    ms = graph_ms(kern, 10)
    plain = time_ms(lambda: plain_update(hi, lo, g, c["lr"], mom, c["beta"]), iters=1, warmup=1)
    bms, by = bound_ms(n * 18, n * 4, FP32_FLOPS)
    nums["row4"] = {"leaf": names[j], "values": n, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "bytes_a_value": 18}
    log(f"30: row 4 with momentum at {names[j]} [{n}]: kernel {ms:.4f} ms, plain {plain:.1f} ms, "
        f"bound {bms:.4f} ms ({by}; 18 bytes a value: hi, lo, a bf16 g, mom in; hi, lo, mom "
        f"out), {bms / ms * 100:.1f}% of bound")
    del hi, lo, mom, g
    torch.cuda.empty_cache()
    return {"split_sgd": launches}, nums


def lm_update_gaps(start: dict, card: dict, cpu: dict) -> list:
    """Each leaf's largest gap between the card's and the CPU's update
    (fp32 masters less the start's), over the CPU update's largest: on the
    card, a leaf at a time."""
    from repro_torch.optim.data_parallel import tree_leaves
    from repro_torch.optim.split_sgd import combine_split
    out = []
    for h0, l0, h1, l1, h2, l2 in zip(*(tree_leaves(s[k]) for s in (start, card, cpu)
                                        for k in ("hi", "lo"))):
        w0 = combine_split(h0, l0)
        d_card = combine_split(h1, l1) - w0
        d_cpu = combine_split(h2.to(h1.device), l2.to(h1.device)) - w0
        top = float(d_cpu.abs().max())
        out.append(float((d_card - d_cpu).abs().max()) / max(top, 1e-30))
    return out


def lm_gate_phase(dev, failures) -> dict:
    """Phase 30a: one step of internlm2 at full width with its depth cut to
    LM_GATE["layers"], on the card against the same step on the CPU (every
    kernel's plain version), from one state and batch: the loss and every
    leaf's update within LM_GATE_TOL; row 4's update on the card bit for bit
    its plain version on the card's own gradients (:class:`UpdateTap`).  Two
    planted faults must fail the gate: the labels shifted by one position,
    and one layer's gradient of one leaf zeroed.  Returns its numbers."""
    import torch
    from repro_torch.configs import internlm2_1_8b
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import lm_steps
    from repro_torch.optim.data_parallel import tree_map

    g = LM_GATE
    cfg = dataclasses.replace(internlm2_1_8b.config(), n_layers=g["layers"])
    B, L = g["batch"], g["seq"]
    lr, beta = LM_TRAIN["lr"], LM_TRAIN["beta"]
    start = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                                   device=dev)
    # a step of momentum first, so that the gated step's momentum is not zero
    warm = {k: torch.as_tensor(v, device=dev)
            for k, v in next(token_stream(SEED + 2, cfg.vocab, B, L)).items()}
    lm_steps.make_lm_train_step(cfg, B, L, lr=lr, beta=beta, device=dev)[0](start, warm)
    batch = next(token_stream(SEED + 1, cfg.vocab, B, L))
    cpu_state = tree_map(lambda t: t.to("cpu", copy=True), start)
    t0 = time.perf_counter()
    with UpdateTap(failures, check=False) as timed:
        _, cpu_loss = lm_steps.make_lm_train_step(cfg, B, L, lr=lr, beta=beta, device="cpu")[0](
            cpu_state, batch)
    cpu_s, cpu_update_s = time.perf_counter() - t0, timed.seconds
    step, _ = lm_steps.make_lm_train_step(cfg, B, L, lr=lr, beta=beta, device=dev)
    dbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def card_step(b, tap):
        s = tree_map(torch.clone, start)
        with tap:
            _, loss = step(s, b)
        return s, float(loss)

    tap = UpdateTap(failures)
    card, loss = card_step(dbatch, tap)
    gaps = lm_update_gaps(start, card, cpu_state)
    loss_gap = abs(loss - float(cpu_loss)) / abs(float(cpu_loss))
    names = leaf_names(start["hi"])
    nums = {"layers": g["layers"], "batch": [B, L], "cpu_s": cpu_s,
            "cpu_update_s": cpu_update_s, "loss_card": loss,
            "loss_cpu": float(cpu_loss), "loss_rel_gap": loss_gap,
            "update_gaps": dict(zip(names, gaps)), "row4_leaves_bitwise": tap.leaves,
            "row4_max_abs_err": tap.err}
    log(f"30a: loss card {loss:.6f}, CPU {float(cpu_loss):.6f} (relative gap {loss_gap:.2e}, "
        f"gate {LM_GATE_TOL['loss']}); worst update gap {max(gaps):.3e} of the leaf's largest "
        f"({names[int(np.argmax(gaps))]}; gate {LM_GATE_TOL['update']}); the CPU step "
        f"{cpu_s:.1f} s, its update {cpu_update_s:.1f} s; row 4 bit for bit its plain version "
        f"on {tap.leaves} leaves")
    if loss_gap > LM_GATE_TOL["loss"] or max(gaps) > LM_GATE_TOL["update"]:
        failures.append(f"30a: the card's step is not the CPU's: loss gap {loss_gap:.2e}, "
                        f"update gap {max(gaps):.3e}")
    del card
    # the planted faults, each of which the gate must reject
    shifted = dict(dbatch, labels=torch.roll(dbatch["labels"], 1, dims=1))
    wg = names.index("layers/mlp/wg")
    for fault, b, t in (("labels shifted by one", shifted, UpdateTap(failures, check=False)),
                        ("layer 1's mlp.wg gradient zeroed", dbatch,
                         UpdateTap(failures, zero=(wg, 1)))):
        s, fl = card_step(b, t)
        fg = lm_update_gaps(start, s, cpu_state)
        fl_gap = abs(fl - float(cpu_loss)) / abs(float(cpu_loss))
        caught = fl_gap > LM_GATE_TOL["loss"] or max(fg) > LM_GATE_TOL["update"]
        nums[f"fault: {fault}"] = {"loss_rel_gap": fl_gap, "worst_update_gap": max(fg),
                                   "caught": caught}
        log(f"30a: fault '{fault}': loss gap {fl_gap:.2e}, worst update gap {max(fg):.3e} "
            f"({names[int(np.argmax(fg))]}): {'rejected' if caught else 'PASSED THE GATE'}")
        if not caught:
            failures.append(f"30a: the fault '{fault}' passed the gate")
        del s
    del start, cpu_state
    torch.cuda.empty_cache()
    return nums


def plain_moe_block(x, p, cfg):
    """``moe_block`` with plain gathers in place of its dispatch and combine
    Functions: autograd's backward of an index is an accumulating
    ``index_put_``, which adds a token's k cotangents in the index sort's
    order."""
    import torch
    from repro_torch.models import transformer as tf
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gate, _, _, keep, dest, C = tf.moe_route(x, p["router"], cfg)
    rows, filled, at, _ = tf.moe_slots(dest, L, k, E, C)
    buf = torch.where(filled[..., None], x.reshape(B * L, d)[rows], 0)
    out = tf._expert_ffn(buf, p["wg"], p["wu"], p["wd"])
    y_pair = torch.where(keep[..., None], out.reshape(-1, d)[at], 0)
    y_pair = y_pair * (keep * gate.reshape(B, L * k)).to(y_pair.dtype)[..., None]
    y = y_pair.view(B, L, k, d).sum(dim=2).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        y = y + tf.swiglu(x, sh["wg"], sh["wu"], sh["wd"])
    return y


def moe_train_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 31: qwen3-moe-30b-a3b at full width, MOE_TRAIN's depth, trained
    MOE_TRAIN["steps"] steps on one batch: every loss finite and the last
    below the first, row 4 once a leaf a step, the dropped share of (token,
    expert) pairs (:class:`MoeTally`).  Then its first MoE block at full
    width, forward and backward (dx, the router's and the experts'
    gradients) on the model's layer-0 input: two runs bit for bit; against
    :func:`plain_moe_block` with the routing pinned (:class:`MoeRoutes`):
    the output and the experts' gradients bit for bit, dx and the router's
    within MOE_GRAD_TOL of each one's largest.  Returns row 4's launches and
    the phase's numbers."""
    import torch
    from repro_torch.configs import qwen3_moe_30b_a3b
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import rms_norm
    from repro_torch.optim.data_parallel import tree_leaves, tree_map

    m = MOE_TRAIN
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.config(), n_layers=m["layers"], microbatch=1)
    B, L = m["batch"], m["seq"]
    torch.cuda.empty_cache()
    state = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    leaves = tree_leaves(state["hi"])
    n_params = sum(t.numel() for t in leaves)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(token_stream(SEED + 3, cfg.vocab, B, L)).items()}
    step, _ = lm_steps.make_lm_train_step(cfg, B, L, lr=LM_TRAIN["lr"], beta=LM_TRAIN["beta"],
                                          device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    losses, walls = [], []
    with MoeTally() as tally:
        for i in range(m["steps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(state, batch)[1]))
            walls.append((time.perf_counter() - t) * 1e3)
    launches = ops.split_sgd.launches - before
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"31: losses {losses}: not finite or not falling")
    if launches != m["steps"] * len(leaves):
        failures.append(f"31: row 4 launched {launches} times in {m['steps']} steps, not once a "
                        f"leaf ({len(leaves)}) a step")
    nums = {"model": cfg.name, "layers": m["layers"], "params": n_params, "batch": [B, L],
            "losses": losses, "step_ms_wall": walls, "peak_gb": peak / 1e9,
            "dropped_share": tally.share(), "max_load": tally.max_load,
            "split_sgd_launches_a_step": launches / m["steps"]}
    log(f"31: {cfg.name} at {m['layers']} layers ({n_params} parameters): losses "
        f"{[round(x, 4) for x in losses]}, steps {[round(w, 1) for w in walls]} ms, peak "
        f"{peak / 1e9:.2f} GB, dropped share {tally.share():.4f} (largest load "
        f"{tally.max_load:.2f}x the mean), row 4 {launches / m['steps']:.0f} launches a step")

    # the first MoE block on the layer-0 input of the batch (its attention block run once)
    with torch.no_grad():
        x0 = tf._embed(state["hi"], batch["tokens"], cfg)
        lp = tf._layer(state["hi"]["layers"], 0)
        h, _ = tf.attn_block(rms_norm(x0, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
                             torch.arange(L, device=dev), 0)
        z = rms_norm(x0 + h, lp["ln2"], cfg.norm_eps)
    p = lp["moe"]
    ct = (torch.randn(z.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
          ).to(torch.bfloat16)
    names = ["x"] + leaf_names(p)

    def fwd_bwd(block):
        pp = tree_map(lambda t: t.detach().requires_grad_(), p)
        xx = z.detach().requires_grad_()
        y = block(xx, pp, cfg)
        return [y.detach()] + list(torch.autograd.grad(y, [xx] + tree_leaves(pp), ct))
    routes = MoeRoutes(cfg)
    with routes.record():
        run1 = fwd_bwd(tf.moe_block)
    with routes.replay("all"):
        run2 = fwd_bwd(tf.moe_block)
    with routes.replay("all"):
        plain = fwd_bwd(plain_moe_block)
    torch.cuda.synchronize()
    det = all(torch.equal(a, b) for a, b in zip(run1, run2))
    if not det:
        failures.append("31: two backward runs of the MoE block differ")
    gaps = {}
    for name, a, b in zip(["y"] + names, run1, plain):
        gap = float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)
        gaps[name] = gap
        exact = name in ("y", "wd", "wu", "wg")
        if (exact and not torch.equal(a, b)) or gap > MOE_GRAD_TOL:
            failures.append(f"31: the MoE block's {name} against the plain version: {gap:.3e} "
                            f"of its largest" + (" (must be bit for bit)" if exact else ""))
    nums.update(moe_block_deterministic=det, moe_block_gaps=gaps, routing_flips=routes.flips)
    log(f"31: MoE block at [{B}, {L}, {cfg.d_model}]: two backward runs bit for bit {det}; "
        "against the plain version (routing pinned), each gap over its largest: "
        + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    del state, step, batch, run1, run2, plain, z, x0, h, p, lp
    torch.cuda.empty_cache()
    return {"split_sgd": launches}, nums


def lm_launcher_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 32: ``launch.train.main`` in process for each LM arch at the
    reference's ``reduced_lm`` sizes (LM_LAUNCH_ARGV, LM_LAUNCH_STEPS steps):
    every loss finite, row 4 once a leaf a step; qwen3-moe again with
    ``--ckpt-dir`` and ``--preempt-at``: the relaunch restores the final
    checkpoint and its losses are the uninterrupted run's bit for bit (the
    module's ``python -m`` entry is phase 20b's subprocess).  Returns row 4's
    launches and the phase's numbers."""
    import shutil
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf

    before = ops.split_sgd.launches
    nums = {}
    for arch in LM_ARCHS:
        n0 = ops.split_sgd.launches
        cfg = launch.reduced_lm(arch, 8, 128)[0]
        n_leaves = len(leaf_names(tf.param_shapes(cfg)))
        out = launch.main(["--arch", arch, *LM_LAUNCH_ARGV, "--steps", str(LM_LAUNCH_STEPS)])
        got = ops.split_sgd.launches - n0
        nums[arch] = {"losses": out["losses"], "split_sgd_launches": got}
        if len(out["losses"]) != LM_LAUNCH_STEPS or not all(np.isfinite(out["losses"])):
            failures.append(f"32: {arch}: losses {out['losses']}")
        if got != LM_LAUNCH_STEPS * n_leaves:
            failures.append(f"32: {arch}: row 4 launched {got} times, not {n_leaves} a step")
    ck = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "qwen3-moe-30b-a3b", *LM_LAUNCH_ARGV, "--steps", str(LM_LAUNCH_STEPS)]
    whole = launch.main(argv)["losses"]
    ckargv = argv + ["--ckpt-dir", str(ck), "--ckpt-every", "2"]
    first = launch.main(ckargv + ["--preempt-at", str(LM_LAUNCH_PREEMPT)])
    second = launch.main(ckargv)
    shutil.rmtree(ck, ignore_errors=True)
    restarted = second["start_step"] == len(first["losses"]) and \
        first["losses"] + second["losses"] == whole
    nums["restart"] = {"whole": whole, "first": first["losses"], "second": second["losses"],
                       "restored_at": second["start_step"], "bitwise": restarted}
    log(f"32: qwen3-moe restart: stopped after {len(first['losses'])} steps, restored at "
        f"{second['start_step']}, losses bit for bit the uninterrupted run's: {restarted}")
    if not restarted:
        failures.append(f"32: the restart's losses {first['losses']} + {second['losses']} are "
                        f"not the uninterrupted {whole}")
    torch.cuda.empty_cache()
    return {"split_sgd": ops.split_sgd.launches - before}, nums


# phases 33a-e: the EGNN family (models/egnn.py, models/egnn_steps.py) at the widths of
# configs/egnn_arch.py (4 layers, hidden 64, each shape's d_feat and n_classes), Split-SGD
# at lr 1e-2, weights split from fp32 draws of seed 0
EGNN_LR = 1e-2
# 33d: the pooled MSE of a random model diverges at lr 1e-2 on the CPU (15.27, 9.2e5, then
# NaN; at 3e-5 NaN by step 6: the reference's model, its sums of 30 nodes' outputs); at
# 1e-5 it climbs to 2e4 by step 4 and falls to 1.83 by step 20 (on the CPU)
EGNN_MOLECULE_LR = 1e-5
# 33b: ogb_products' sums over a node's in-edges (the reference's segment sums, no mean)
# grow the random model's logits with the degree: its first loss 39.27 at a mean in-degree of
# 8 and 1288 at 25 (the published graph's) on a CPU graph of 9,796 nodes, where lr 1e-2
# reaches NaN within 5 steps at both, 1e-3 at 25; 1e-4 stays finite at both
EGNN_OGB_LR = 1e-4
EGNN_STEPS = dict(cora=20, ogb=5, minibatch=10, molecule=20)
# 33a: the first cora step on the card against the CPU's, 30a's rule: the loss within 1e-4
# relative, each leaf's update within 3e-2 of its largest
EGNN_GATE_TOL = {"loss": 1e-4, "update": 3e-2}
# 33a: the card's first step again this many times from the same start (the bf16 atomics
# add in another order each run): the gaps' spread, logged
EGNN_GATE_REPEATS = 8
# 33b: ogb_products' edge list cut to the largest multiple of 1,000,000 edges whose step's
# peak leaves EGNN_FREE bytes of the card free, the peak's growth an edge read from one step
# at each of EGNN_PROBE_EDGES; the peak is PyTorch's reserved memory (an H100 reading: the
# allocated peak at 2 M and 4 M edges predicted 72.1 GB at 26 M, where 73.6 GB allocated and
# 4.7 GB reserved beside it left no room)
EGNN_PROBE_EDGES = (4_000_000, 12_000_000)
EGNN_FREE = 10e9
# 33c: the counts of PyG's Reddit dataset, whose 602 features and 41 classes the shape uses
REDDIT = dict(n_nodes=232_965, n_edges=114_615_892)


def egnn_masters(state) -> list:
    """Every leaf's fp32 master values, as numpy (no ``ml_dtypes`` on the
    card's machine)."""
    from repro_torch.optim.data_parallel import tree_leaves
    from repro_torch.optim.split_sgd import combine_split
    return [combine_split(h, lo).cpu().numpy()
            for h, lo in zip(tree_leaves(state["hi"]), tree_leaves(state["lo"]))]


def egnn_node_batch(cfg, structs: dict, n_real: int, src, dst, dev, seed: int) -> dict:
    """A node-level full-graph batch of ``structs``' padded shapes on
    ``dev``: features, coordinates and labels drawn there from ``seed``
    (every node's), ``label_mask`` 1 on the ``n_real`` real nodes; the
    edges ``src`` / ``dst`` (numpy) padded with masked edges."""
    import torch
    N, E = structs["feats"][0][0], structs["src"][0][0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = len(src)
    pad = np.zeros(E - e, np.int32)
    return {"feats": torch.randn((N, cfg.d_feat), generator=gen, device=dev).to(torch.bfloat16),
            "coords": torch.randn((N, cfg.coord_dim), generator=gen, device=dev),
            "labels": torch.randint(0, cfg.n_classes, (N,), generator=gen, device=dev,
                                    dtype=torch.int32),
            "label_mask": (torch.arange(N, device=dev) < n_real).float(),
            "src": torch.from_numpy(np.concatenate([src, pad])).to(dev),
            "dst": torch.from_numpy(np.concatenate([dst, pad])).to(dev),
            "edge_mask": (torch.arange(E, device=dev) < e).float()}


def egnn_run(step, state, batches, steps: int) -> dict:
    """``steps`` train steps, the batch ``batches(i)`` each (the host's work
    to make it timed apart): the losses, each step's wall ms (host clock,
    ending in a synchronise), the last step traced (its busy ms on the card
    alone, the idle share), the host ms a batch took."""
    import torch
    losses, walls, host = [], [], []
    busy, tops = float("nan"), []
    for i in range(steps):
        t = time.perf_counter()
        b = batches(i)
        host.append((time.perf_counter() - t) * 1e3)
        out = {}

        def run():
            out["loss"] = step(state, b)[1]
        if i < steps - 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        else:
            wall, busy, tops = device_busy_ms(run, 1)
        losses.append(float(out["loss"]))
        walls.append(wall)
    p50 = float(np.median(walls[1:] if steps > 1 else walls))
    return {"losses": losses, "step_ms_wall": walls, "step_ms_p50": p50,
            "last_step_ms_busy": busy, "idle_share": 1 - busy / walls[-1],
            "host_batch_ms": host, "top": tops[:6]}


def egnn_losses_or_fail(tag: str, losses: list, failures, fall: bool = True) -> None:
    if not all(np.isfinite(losses)):
        failures.append(f"{tag}: a loss is not finite: {losses}")
    elif fall and not losses[-1] < losses[0]:
        failures.append(f"{tag}: the loss did not fall: {losses}")


def egnn_row4(state, dev, lr: float) -> dict:
    """Row 4 on one step's 18 updates of ``state``'s leaves (copies, bf16
    gradients drawn from the seed), as one CUDA graph: ms a step beside the
    bound (hi, lo, a bf16 g in; hi, lo out: 10 bytes a value) and the plain
    version's ms (on the card, eager)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim.data_parallel import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(SEED)
    his = [t.clone() for t in tree_leaves(state["hi"])]
    los = [t.clone() for t in tree_leaves(state["lo"])]
    gs = [(torch.randn(t.shape, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
          for t in his]

    def updates():
        for h, lo, g in zip(his, los, gs):
            ops.split_sgd(h.view(-1), lo.view(-1), g.view(-1), lr)

    def plain():
        for h, lo, g in zip(his, los, gs):
            plain_update(h.view(-1), lo.view(-1), g.view(-1), lr, None, 0.0)
    n = sum(t.numel() for t in his)
    ms = graph_ms(updates, 10)
    plain_ms = time_ms(plain, iters=3, warmup=1)
    bms, by = bound_ms(n * 10, n * 2, FP32_FLOPS)
    return {"leaves": len(his), "values": n, "ms_a_step": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def egnn_cora_phase(dev, failures) -> tuple[int, dict]:
    """Phase 33a: EGNN on cora's shape (``configs/egnn_arch.py``
    ``full_graph_sm``: 2,708 nodes, 10,556 uniform edges, 1,433 features, 7
    classes; nothing cut) through ``egnn_arch.build``.  First one step from
    a state of seed 0 on the card against the same step on the CPU (every
    kernel's plain version): the loss and every leaf's update within
    EGNN_GATE_TOL, row 4 bit for bit its plain version on the card's own
    gradients (:class:`UpdateTap`), and a planted fault (``dst`` rolled by
    one) that must fail the gate.  Then 20 steps on the batch: losses finite
    and falling, row 4 launched once a leaf a step.  Returns row 4's
    launches of the 20 steps and the phase's numbers."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.data import graph
    from repro_torch.kernels import ops
    from repro_torch.models import egnn_steps
    from repro_torch.optim.data_parallel import tree_leaves, tree_map

    sh = egnn_arch.SHAPES["full_graph_sm"]
    cfg = egnn_arch.config("full_graph_sm")
    built = egnn_arch.build("full_graph_sm", device=dev)
    src, dst = graph.random_edge_list(sh["n_nodes"], sh["n_edges"], SEED)
    batch = egnn_node_batch(cfg, built.args[1], sh["n_nodes"], src, dst, dev, SEED)
    start = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    names = leaf_names(start["hi"])
    cpu_state = tree_map(lambda t: t.to("cpu", copy=True), start)
    t0 = time.perf_counter()
    _, cpu_loss = egnn_arch.build("full_graph_sm", device="cpu").fn(
        cpu_state, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0

    def card_step(b, tap):
        s = tree_map(torch.clone, start)
        with tap:
            _, loss = built.fn(s, b)
        return s, float(loss)

    tap = UpdateTap(failures, tag="33a")
    card, loss = card_step(batch, tap)
    gaps = lm_update_gaps(start, card, cpu_state)
    loss_gap = abs(loss - float(cpu_loss)) / abs(float(cpu_loss))
    log(f"33a: loss card {loss:.6f}, CPU {float(cpu_loss):.6f} (relative gap {loss_gap:.2e}, "
        f"gate {EGNN_GATE_TOL['loss']}); worst update gap {max(gaps):.3e} of the leaf's "
        f"largest ({names[int(np.argmax(gaps))]}; gate {EGNN_GATE_TOL['update']}); the CPU step "
        f"{cpu_s:.1f} s; row 4 bit for bit its plain version on {tap.leaves} leaves")
    if loss_gap > EGNN_GATE_TOL["loss"] or max(gaps) > EGNN_GATE_TOL["update"]:
        failures.append(f"33a: the card's step is not the CPU's: loss gap {loss_gap:.2e}, "
                        f"update gap {max(gaps):.3e}")
    rolled = dict(batch, dst=torch.roll(batch["dst"], 1))
    s, fl = card_step(rolled, UpdateTap(failures, check=False, tag="33a"))
    fg = lm_update_gaps(start, s, cpu_state)
    fl_gap = abs(fl - float(cpu_loss)) / abs(float(cpu_loss))
    caught = fl_gap > EGNN_GATE_TOL["loss"] or max(fg) > EGNN_GATE_TOL["update"]
    log(f"33a: fault 'dst rolled by one': loss gap {fl_gap:.2e}, worst update gap {max(fg):.3e} "
        f"({names[int(np.argmax(fg))]}): {'rejected' if caught else 'PASSED THE GATE'}")
    if not caught:
        failures.append("33a: the fault 'dst rolled by one' passed the gate")
    spread = [max(lm_update_gaps(start, card_step(batch, UpdateTap(failures, check=False,
                                                                     tag="33a"))[0], cpu_state))
              for _ in range(EGNN_GATE_REPEATS)]
    log(f"33a: the card's step {EGNN_GATE_REPEATS} times more from the same start: worst update "
        f"gaps {min(spread):.3e} to {max(spread):.3e} (logged, not held)")
    del card, s, cpu_state

    state = tree_map(torch.clone, start)
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    run = egnn_run(built.fn, state, lambda i: batch, EGNN_STEPS["cora"])
    launches = ops.split_sgd.launches - before
    n_leaves = len(tree_leaves(state["hi"]))
    egnn_losses_or_fail("33a", run["losses"], failures)
    if launches != EGNN_STEPS["cora"] * n_leaves:
        failures.append(f"33a: row 4 launched {launches} times in {EGNN_STEPS['cora']} steps, "
                        f"not once a leaf ({n_leaves}) a step")
    row4 = egnn_row4(state, dev, EGNN_LR)
    row4.update(launches_a_step=launches / EGNN_STEPS["cora"], max_abs_err=tap.err,
                leaves_bitwise=tap.leaves)
    nums = {"shape": "full_graph_sm", "n_nodes": sh["n_nodes"], "n_edges": sh["n_edges"],
            "padded": list(batch["feats"].shape[:1]) + list(batch["src"].shape),
            "losses": run["losses"], "step_ms_p50": run["step_ms_p50"],
            "last_step_ms_busy": run["last_step_ms_busy"], "idle_share": run["idle_share"],
            "edges_per_s": sh["n_edges"] / run["step_ms_p50"] * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "cpu_step_s": cpu_s,
            "loss_card": loss, "loss_cpu": float(cpu_loss), "loss_rel_gap": loss_gap,
            "worst_update_gap": max(gaps), "update_gaps": dict(zip(names, gaps)),
            "fault_dst_rolled": {"loss_rel_gap": fl_gap, "worst_update_gap": max(fg),
                                 "caught": caught}, "repeated_worst_update_gaps": spread,
            "row4": row4, "top_kernels": run["top"]}
    log(f"33a: losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; step p50 "
        f"{run['step_ms_p50']:.2f} ms wall, the last {run['last_step_ms_busy']:.2f} ms busy (idle "
        f"{run['idle_share']:.3f}); row 4 {row4['launches_a_step']:.0f} launches a step, "
        f"{row4['ms_a_step']:.4f} ms a step as a graph, bound {row4['bound_ms']:.4f} ms "
        f"({row4['values']} values)")
    return launches, nums


def egnn_ogb_phase(dev, failures) -> tuple[int, dict]:
    """Phase 33b: ogb_products at full width (all 2,449,029 nodes, 100
    features, 47 classes, uniform edges), its edge list cut: one step at
    each of EGNN_PROBE_EDGES gives the peak memory's growth an edge, and the
    run takes the largest multiple of 1,000,000 edges (at most the published
    61,859,140) whose predicted peak leaves EGNN_FREE bytes free, one step
    at it measured and the edges cut further until it does.  5 steps on
    one batch at EGNN_OGB_LR: losses finite; step ms (p50), edges a
    second, busy ms and idle share of the last (traced), the peak.  Returns
    row 4's launches and the numbers."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.data import graph
    from repro_torch.kernels import ops
    from repro_torch.models import egnn_steps
    from repro_torch.optim.data_parallel import tree_map

    sh = egnn_arch.SHAPES["ogb_products"]
    cfg = egnn_arch.config("ogb_products")
    N = sh["n_nodes"]
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    held0 = torch.cuda.memory_reserved()
    start = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)

    def setup(E):
        t = time.perf_counter()
        src, dst = graph.random_edge_list(N, E, SEED)
        step, (_, bs) = egnn_steps.make_fullgraph_train_step(cfg, None, N, E, EGNN_OGB_LR,
                                                             device=dev)
        b = egnn_node_batch(cfg, bs, N, src, dst, dev, SEED)
        torch.cuda.synchronize()
        return step, b, time.perf_counter() - t

    peaks = []
    for E in EGNN_PROBE_EDGES:
        step, b, _ = setup(E)
        torch.cuda.reset_peak_memory_stats()
        step(tree_map(torch.clone, start), b)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_reserved() - held0)
        del step, b
        torch.cuda.empty_cache()
    (e1, e2), (p1, p2) = EGNN_PROBE_EDGES, peaks
    per_edge = (p2 - p1) / (e2 - e1)
    fixed = p1 - per_edge * e1
    E = int(min(sh["n_edges"], (free0 - EGNN_FREE - fixed) / per_edge // 1_000_000 * 1_000_000))
    log(f"33b: reserved peaks {p1 / 1e9:.3f} / {p2 / 1e9:.3f} GB at {e1} / {e2} edges: "
        f"{per_edge:.0f} bytes an edge beside {fixed / 1e9:.3f} GB; {free0 / 1e9:.2f} GB free: "
        f"{E} edges predicted to peak at {(fixed + per_edge * E) / 1e9:.2f} GB")
    tries = []
    while True:  # the fit's guess measured, and cut further while it leaves too little free
        step, b, setup_s = setup(E)
        torch.cuda.reset_peak_memory_stats()
        step(tree_map(torch.clone, start), b)
        torch.cuda.synchronize()
        tries.append([E, (torch.cuda.max_memory_reserved() - held0) / 1e9])
        short = EGNN_FREE - (free0 - tries[-1][1] * 1e9)
        if short <= 0 or E <= 1_000_000:
            break
        E = max(1_000_000, E - int(max(1, np.ceil(short / per_edge / 1e6))) * 1_000_000)
        del step, b
        torch.cuda.empty_cache()
    log(f"33b: the edges cut from {sh['n_edges']} to {E} ({E / sh['n_edges']:.1%}); measured "
        f"[edges, reserved peak GB]: {tries}")
    state = tree_map(torch.clone, start)
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    run = egnn_run(step, state, lambda i: b, EGNN_STEPS["ogb"])
    launches = ops.split_sgd.launches - before
    peak = torch.cuda.max_memory_reserved() - held0
    peak_alloc = torch.cuda.max_memory_allocated()
    egnn_losses_or_fail("33b", run["losses"], failures, fall=False)
    if launches != EGNN_STEPS["ogb"] * 18:
        failures.append(f"33b: row 4 launched {launches} times in {EGNN_STEPS['ogb']} steps")
    nums = {"shape": "ogb_products", "n_nodes": N, "n_edges_published": sh["n_edges"],
            "n_edges": E, "edge_share": E / sh["n_edges"], "probe_peaks_gb": [p1 / 1e9, p2 / 1e9],
            "bytes_an_edge": per_edge, "fixed_gb": fixed / 1e9, "free_gb": free0 / 1e9,
            "tries": tries,
            "lr": EGNN_OGB_LR,
            "setup_s": setup_s, "losses": run["losses"], "step_ms_wall": run["step_ms_wall"],
            "step_ms_p50": run["step_ms_p50"], "edges_per_s": E / run["step_ms_p50"] * 1e3,
            "last_step_ms_busy": run["last_step_ms_busy"], "idle_share": run["idle_share"],
            "peak_reserved_gb": peak / 1e9, "peak_allocated_gb": peak_alloc / 1e9,
            "free_at_peak_gb": (free0 - peak) / 1e9,
            "row4_launches_a_step": launches / EGNN_STEPS["ogb"],
            "row4": egnn_row4(state, dev, EGNN_OGB_LR),
            "top_kernels": run["top"]}
    log(f"33b: {E} edges: losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; step p50 "
        f"{run['step_ms_p50']:.1f} ms wall ({nums['edges_per_s']:.3e} edges/s), the last "
        f"{run['last_step_ms_busy']:.1f} ms busy (idle {run['idle_share']:.3f}); peak "
        f"{peak / 1e9:.2f} GB reserved ({peak_alloc / 1e9:.2f} GB allocated), "
        f"{(free0 - peak) / 1e9:.2f} GB of the card left free; setup {setup_s:.1f} s; its "
        f"busiest kernels: "
        f"{top_kernels(run['top'])}")
    del step, b, state, start
    torch.cuda.empty_cache()
    return launches, nums


def egnn_minibatch_phase(dev, failures) -> tuple[int, dict]:
    """Phase 33c: ``minibatch_lg`` (fanout 15-10, 192 nodes and 192 edges a
    subgraph, 1,024 targets a step, 602 features, 41 classes) on a
    ``random_powerlaw_graph`` of Reddit's counts (REDDIT) with features of
    seed 0, through ``egnn_arch.build``; the targets drawn among the nodes
    with neighbours, a fresh batch a step from ``NeighborSampler``.  10
    steps: losses finite; the CSR build s, the host's sample ms a batch
    against the step ms (the batch's copy to the card inside the step).
    Returns row 4's launches and the numbers."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.data import graph
    from repro_torch.kernels import ops
    from repro_torch.models import egnn_steps

    sh = egnn_arch.SHAPES["minibatch_lg"]
    cfg = egnn_arch.config("minibatch_lg")
    t0 = time.perf_counter()
    g = graph.random_powerlaw_graph(REDDIT["n_nodes"], REDDIT["n_edges"], SEED)
    csr_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    feats = rng.standard_normal((REDDIT["n_nodes"], cfg.d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, REDDIT["n_nodes"])
    feats_s = time.perf_counter() - t0
    has = np.flatnonzero(np.diff(g.indptr))
    log(f"33c: CSR of {g.n_nodes} nodes and {g.n_edges} edges built in {csr_s:.1f} s, features "
        f"[{REDDIT['n_nodes']}, {cfg.d_feat}] in {feats_s:.1f} s; {len(has)} nodes have "
        f"neighbours (the largest degree {int(np.diff(g.indptr).max())})")
    sampler = graph.NeighborSampler(g, sh["fanout"], sh["n_pad"], sh["e_pad"], seed=SEED)
    built = egnn_arch.build("minibatch_lg", device=dev)
    state = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    real = []

    def batch(i):
        b = sampler.sample_batch(rng.choice(has, sh["n_graphs"], replace=False), feats, labels)
        real.append(float(b["edge_mask"].sum(1).mean()))
        return b
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    run = egnn_run(built.fn, state, batch, EGNN_STEPS["minibatch"])
    launches = ops.split_sgd.launches - before
    egnn_losses_or_fail("33c", run["losses"], failures, fall=False)
    if launches != EGNN_STEPS["minibatch"] * 18:
        failures.append(f"33c: row 4 launched {launches} times in {EGNN_STEPS['minibatch']} "
                        "steps")
    sample50 = float(np.median(run["host_batch_ms"]))
    nums = {"shape": "minibatch_lg", "graph": dict(REDDIT), "csr_s": csr_s, "feats_s": feats_s,
            "nodes_with_neighbours": int(len(has)), "graphs": sh["n_graphs"],
            "real_edges_a_graph": float(np.mean(real)), "losses": run["losses"],
            "sample_ms": run["host_batch_ms"], "sample_ms_p50": sample50,
            "step_ms_wall": run["step_ms_wall"], "step_ms_p50": run["step_ms_p50"],
            "last_step_ms_busy": run["last_step_ms_busy"], "idle_share": run["idle_share"],
            "targets_per_s": sh["n_graphs"] / (run["step_ms_p50"] + sample50) * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "row4_launches_a_step": launches / EGNN_STEPS["minibatch"],
            "row4": egnn_row4(state, dev, EGNN_LR), "top_kernels": run["top"]}
    log(f"33c: losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; sample p50 "
        f"{sample50:.1f} ms a batch on the host ({nums['real_edges_a_graph']:.1f} real edges a "
        f"graph of {sh['e_pad']}), step p50 {run['step_ms_p50']:.1f} ms wall, the last "
        f"{run['last_step_ms_busy']:.1f} ms busy (idle {run['idle_share']:.3f}); "
        f"{nums['targets_per_s']:.0f} targets/s sampled and trained in turn")
    del g, feats, sampler, state
    torch.cuda.empty_cache()
    return launches, nums


def egnn_molecule_phase(dev, failures) -> tuple[int, dict]:
    """Phase 33d: ``molecule`` (128 graphs of 30 nodes and 64 edges, 11
    features, the pooled MSE), the full-graph step at EGNN_MOLECULE_LR, the
    batch drawn on the card from seed 0 (each graph's edges within it).
    20 steps on the batch: losses finite (the random model's pooled MSE
    climbs by three orders of magnitude before it falls, on the CPU too).
    Returns row 4's launches and the numbers."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.kernels import ops
    from repro_torch.models import egnn_steps

    sh = egnn_arch.SHAPES["molecule"]
    cfg = egnn_arch.config("molecule")
    G, per, epg = sh["n_graphs"], sh["nodes_per"], sh["edges_per"]
    step, (_, bs) = egnn_steps.make_fullgraph_train_step(
        cfg, None, G * per, G * epg, EGNN_MOLECULE_LR, graph_level_graphs=G, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    off = torch.arange(G, device=dev)[:, None] * per
    b = {"feats": torch.randn(bs["feats"][0], generator=gen, device=dev).to(torch.bfloat16),
         "coords": torch.randn(bs["coords"][0], generator=gen, device=dev),
         "src": (torch.randint(0, per, (G, epg), generator=gen, device=dev) + off).view(-1).int(),
         "dst": (torch.randint(0, per, (G, epg), generator=gen, device=dev) + off).view(-1).int(),
         "edge_mask": torch.ones(G * epg, device=dev),
         "graph_ids": (torch.arange(G * per, device=dev) // per).int(),
         "targets": torch.randn((G,), generator=gen, device=dev)}
    state = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    before = ops.split_sgd.launches
    run = egnn_run(step, state, lambda i: b, EGNN_STEPS["molecule"])
    launches = ops.split_sgd.launches - before
    egnn_losses_or_fail("33d", run["losses"], failures, fall=False)
    if launches != EGNN_STEPS["molecule"] * 18:
        failures.append(f"33d: row 4 launched {launches} times in {EGNN_STEPS['molecule']} steps")
    nums = {"shape": "molecule", "graphs": G, "nodes": G * per, "edges": G * epg,
            "lr": EGNN_MOLECULE_LR, "losses": run["losses"], "step_ms_p50": run["step_ms_p50"],
            "last_step_ms_busy": run["last_step_ms_busy"], "idle_share": run["idle_share"],
            "graphs_per_s": G / run["step_ms_p50"] * 1e3,
            "row4_launches_a_step": launches / EGNN_STEPS["molecule"],
            "row4": egnn_row4(state, dev, EGNN_MOLECULE_LR)}
    log(f"33d: losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f} (lr {EGNN_MOLECULE_LR}); "
        f"step p50 {run['step_ms_p50']:.2f} ms wall, the last {run['last_step_ms_busy']:.2f} ms "
        f"busy (idle {run['idle_share']:.3f})")
    return launches, nums


def egnn_mesh_rank(rank: int, world: int, device: str = "cuda:0") -> dict:
    """Phase 33e in one of two processes sharing the card (gloo, the
    payloads staged through host memory): cora's full-graph step on a (1, 2)
    mesh from the state of seed 0, one step.  Returns the fp32 masters
    before and after, the loss, row 4's launches, the collectives' bytes
    and the step's host ms."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.data import graph
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import egnn_steps

    dev = mesh_rank_setup(device)
    mesh = make_mesh((1, 2), ("data", "model"), dev)
    sh = egnn_arch.SHAPES["full_graph_sm"]
    cfg = egnn_arch.config("full_graph_sm")
    built = egnn_arch.build("full_graph_sm", mesh)
    src, dst = graph.random_edge_list(sh["n_nodes"], sh["n_edges"], SEED)
    batch = egnn_node_batch(cfg, built.args[1], sh["n_nodes"], src, dst, dev, SEED)
    state = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    start = egnn_masters(state)
    mesh.stats.reset()
    before = ops.split_sgd.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = built.fn(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"start": start, "after": egnn_masters(state), "loss": float(loss),
            "launches": ops.split_sgd.launches - before, "stats": mesh.stats.as_dict(),
            "wall_s": wall, "padded": [int(batch["feats"].shape[0]), int(batch["src"].shape[0])]}


def egnn_mesh_phase(dev, failures) -> tuple[int, dict]:
    """Phase 33e: cora's full-graph step on a (1, 2) mesh, two processes on
    the card over gloo.  Each rank's update must be 2 times the one-rank
    step's on the same padded batch (the reference's factor: its psum
    transposes to psum, ``models/egnn_steps.py::grad_psum``), each leaf
    within EGNN_GATE_TOL["update"] of its largest; both ranks end with one
    state, bit for bit.  The loss beside the one-rank loss is logged, not
    held (a rank's products of half the rows sum in another order, and h
    is rounded to bf16 after each layer).  Returns both ranks' row 4
    launches and the numbers."""
    import torch
    from repro_torch.configs import egnn_arch
    from repro_torch.data import graph
    from repro_torch.models import egnn_steps

    t0 = time.perf_counter()
    ranks = two_ranks(egnn_mesh_rank, timeout_s=600)
    ranks_s = time.perf_counter() - t0
    sh = egnn_arch.SHAPES["full_graph_sm"]
    cfg = egnn_arch.config("full_graph_sm")
    N, E = ranks[0]["padded"]
    step, (_, bs) = egnn_steps.make_fullgraph_train_step(cfg, None, N, E, EGNN_LR, device=dev)
    src, dst = graph.random_edge_list(sh["n_nodes"], sh["n_edges"], SEED)
    batch = egnn_node_batch(cfg, bs, sh["n_nodes"], src, dst, dev, SEED)
    state = egnn_steps.init_egnn_state(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    start = egnn_masters(state)
    _, loss1 = step(state, batch)
    one = [a - s for a, s in zip(egnn_masters(state), start)]
    gaps = []
    for r, res in enumerate(ranks):
        if not all(np.array_equal(a, b) for a, b in zip(res["start"], start)):
            failures.append(f"33e: rank {r}'s start state is not the one-rank step's")
        gaps.append(max(float(np.abs((a - s) - 2 * d).max()) / max(float(np.abs(2 * d).max()),
                                                                  1e-30)
                        for a, s, d in zip(res["after"], start, one)))
    same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip(ranks[0]["after"], ranks[1]["after"]))
    loss_gap = max(abs(res["loss"] - float(loss1)) / abs(float(loss1)) for res in ranks)
    if max(gaps) > EGNN_GATE_TOL["update"]:
        failures.append(f"33e: a rank's update is not 2 times the one-rank update: {gaps}")
    if not same:
        failures.append("33e: the two ranks end with different states")
    launches = sum(res["launches"] for res in ranks)
    if launches != 2 * 18:
        failures.append(f"33e: row 4 launched {launches} times by two ranks in one step")
    st = ranks[0]["stats"]
    nums = {"padded": [N, E], "loss_one_rank": float(loss1),
            "losses": [res["loss"] for res in ranks], "loss_rel_gap": loss_gap,
            "update_gap_to_2x": gaps, "ranks_bitwise": same, "ranks_s": ranks_s,
            "step_wall_s": [res["wall_s"] for res in ranks],
            "collectives": {k: [st["calls"][k], st["bytes_out"][k]] for k in st["calls"]
                            if st["calls"][k]},
            "staging_s": st["staging_s"], "wire_s": st["wire_s"]}
    log(f"33e: 2 ranks on cuda:0 over gloo in {ranks_s:.1f} s: losses "
        f"{nums['losses']} against the one-rank {float(loss1):.6f}; each rank's update against 2 "
        f"times the one-rank update: worst gap {max(gaps):.3e} of the leaf's largest (gate "
        f"{EGNN_GATE_TOL['update']}); the ranks' states {'bit for bit one' if same else 'DIFFER'}; "
        f"the step {ranks[0]['wall_s'] * 1e3:.1f} ms (host clock, staged through host memory: not "
        f"a training rate); collectives (calls, bytes out): {nums['collectives']}")
    return launches, nums


# the dry run's cells whose rank-0 step phase 34b holds to the plain versions, each at its own
# batch, and whether its dense shard is held to the plain step's (phase 21's rule).
# dlrm-large's table-mode stream at B 16,384 is 6.5 M lookups a step on rank 0 (the other 15
# replicas' ids come back as row 0), whose plain sums gather 6.7 GB of cotangents on the CPU.
# Its dense shard is not held to the plain step's: its rank's dense update is a few fp32 ulps
# of the weights, and two steps whose bag and interaction outputs differ in their last fp32
# bits flip the rounding of w + update (gaps up to 15.8 % of the largest update) and move 37
# of its 14,592 zero-initialised biases by up to 2.6 % of it, past phase 21's rule (H100,
# tools/dryrun_dense_gap.py).  Its dense update is held bit for bit instead, as every cell's is
DRYRUN_HELD = (("dlrm-large", "train", True), ("dlrm-large", "train_tablewise", False),
               ("fm", "train_batch", True))
DRYRUN_TIMED = 1      # timed steps a cell, after its counted step


@contextlib.contextmanager
def plain_kernels():
    """The kernel wrappers that the DLRM and recsys steps call (rows 1, 2,
    4 and 5) replaced by their plain versions for card tensors too, so that
    a step runs "with the plain versions on the card"; the bag in batch
    chunks of at most PLAIN_BAG_VALUES gathered values (:func:`plain_bag`)."""
    import torch
    from repro_torch.kernels import ops, ref

    def bag_stage(W, idx, offsets, rows, weights=None, round_bf16=True):
        B, S, P = idx.shape
        n = max(1, PLAIN_BAG_VALUES // (S * P * W.shape[1]))
        return torch.cat([ref.embedding_bag_stage(W, idx[i:i + n], offsets, rows,
                                                  None if weights is None else weights[i:i + n],
                                                  round_bf16) for i in range(0, B, n)])

    plain = {"embedding_bag_stage": bag_stage, "dot_interaction": ref.dot_interaction,
             "split_sgd": ref.split_sgd, "fused_update_split": ref.fused_update_split}
    kept = {k: getattr(ops, k) for k in plain}
    for k, fn in plain.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in kept.items():
            setattr(ops, k, fn)


def bit_sum(t) -> int:
    """The sum of a tensor's bit patterns as int64: a checksum of its rows."""
    import torch
    ib = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return int(t.view(ib).sum(dtype=torch.int64))


def dryrun_held(arch: str, shape: str, dense_held: bool, dev, failures) -> dict:
    """Phase 34b: rank 0's step of a dry-run cell on the card, stage by stage
    as the step runs them, held to the same step with the plain versions on
    the card (:func:`plain_kernels`, on a copy of the dense state; the
    forward reads the same table before either update): the loss within
    ``TRAIN_TOL["loss"]``; the rank's dense shard bit for bit the plain
    update (row 4's plain version) of the card's own dense gradient, and
    where ``dense_held`` within ``TRAIN_TOL["update"]`` of the plain step's
    largest update plus one fp32 ulp of each weight (phase 21's rule: at
    dlrm-large's B 16,384 a rank's dense update is a few ulps of the
    weights it moves, and gradients that differ in their last bits flip the
    rounding of ``w + update``), else its gap to the plain step logged; the
    sparse update (row 5) bit for bit the plain update of the card's own
    cotangent on the rows it touched (the stream's lookups that hit this
    shard, in the step's sorted order, summed on a compact copy of those
    rows), every other row's bits unchanged (a checksum); and the same plain
    update with one table's cotangent zeroed (the slot with the most
    nonzero lookups; run on the rows its lookups touch) must differ from the
    card's store."""
    from repro_torch.launch.mesh import shape_only_meshes

    with shape_only_meshes():
        return _dryrun_held(f"34b {arch} {shape}", arch, shape, dense_held, dev, failures)


def _dryrun_held(tag: str, arch: str, shape: str, dense_held: bool, dev, failures) -> dict:
    import torch
    from repro_torch import weights
    from repro_torch.configs import base
    from repro_torch.core import hybrid, pipeline
    from repro_torch.core import sharded_embedding as se
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import data_parallel as dp
    from repro_torch.optim import row as row_optim

    mesh = make_production_mesh(device=dev)
    build = base.get(arch).build(shape, mesh)
    (state, b), _ = dryrun.cell_inputs(build, mesh,
                                       torch.Generator(device=dev).manual_seed(dryrun.SEED))
    cfg, st = hybrid.as_hybrid(build.model), build.fn.stages
    opt = row_optim.resolve(cfg)
    layout = hybrid.make_layout(cfg, mesh)
    dense_p, dense_own = (weights.state_to({"emb": {}, "dense": state["dense"]}, dev)["dense"]
                          for _ in range(2))
    before = dense_master(state["dense"], mesh.size, mesh.rank).clone()
    with plain_kernels():
        idx_fwd, _ = st.index_exchange(b["idx"])
        emb_p = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd)
        loss_p, g_p, _ = st.dense_fwd_bwd(dense_p["hi"], emb_p, b)
        st.dense_update(dense_p, g_p)
    idx_fwd, idx_upd = st.index_exchange(b["idx"])
    emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd)
    loss, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b)
    dY = st.dY_exchange(d_emb, None, 0)
    # the stream the step's update sorts, its lookups on this shard, the rows they touch
    shard = mesh.group(pipeline.emb_axes(cfg, mesh)[0]).index
    offs = torch.as_tensor(se.local_offsets(layout, shard), dtype=torch.int32, device=dev)
    stream = se._row_sorted_streams(layout, (idx_upd + offs[None, :, None]).reshape(-1),
                                    idx_upd.shape[-1], None, shard)
    keep = stream[2] != 0
    rows, bags, msk, wgt = (t[keep] for t in stream)
    T = torch.unique_consecutive(rows)
    pos = torch.searchsorted(T, rows).to(torch.int32)
    compact = {k: v[T].clone() for k, v in state["emb"].items()}
    rest = {k: bit_sum(v) - bit_sum(compact[k]) for k, v in state["emb"].items()}
    st.sparse_update(state["emb"], idx_upd, dY, None, None)
    with plain_kernels():
        st.dense_update(dense_own, dp.tree_map(torch.clone, g_dense))
    st.dense_update(state["dense"], g_dense)
    torch.cuda.synchronize()
    dY2 = dY.reshape(-1, dY.shape[-1])
    log(f"  {tag}: {int(stream[0].numel())} lookups in the update stream, {int(keep.sum())} on "
        f"this shard, {int(T.numel())} rows touched; cotangent {dY.dtype} {tuple(dY.shape)}")
    close_or_fail(f"{tag}: loss vs the plain step on the card", loss, loss_p, TRAIN_TOL["loss"],
                  0.0, failures)
    got, want = dense_master(state["dense"], mesh.size, mesh.rank), dense_master(
        dense_p, mesh.size, mesh.rank)
    bitwise_or_fail(f"{tag}: dense shard vs the plain update of the card's own gradient", got,
                    dense_master(dense_own, mesh.size, mesh.rank), failures)
    upd = float((want - before).abs().max())
    if not upd > 0:
        failures.append(f"{tag}: the plain step moved no dense weight")
    gap = (got - want).abs() / upd
    dense_gap = {"largest_update": upd, "gap_max": float(gap.max()),
                 "beyond_1e-2": int((gap > TRAIN_TOL["update"]).sum())}
    if dense_held:
        close_or_fail(f"{tag}: dense shard vs the plain step (atol {TRAIN_TOL['update']:g} x the "
                      f"largest update, {upd:.3e}, rtol one fp32 ulp)", got, want,
                      RECSYS_DENSE_ULP, TRAIN_TOL["update"] * upd, failures)
    else:
        log(f"  {tag}: dense shard vs the plain step (not held, DRYRUN_HELD): largest gap "
            f"{dense_gap['gap_max']:.4f} of the largest update {upd:.3e}, "
            f"{dense_gap['beyond_1e-2']} of {got.numel()} values beyond {TRAIN_TOL['update']:g}")
    plain = {k: v.clone() for k, v in compact.items()}
    with plain_kernels():
        row_optim.apply_sparse(opt, plain, (pos, bags, msk, wgt), dY2, cfg.emb_lr)
    for k, v in plain.items():
        bitwise_or_fail(f"{tag}: {k} of the {int(T.numel())} touched rows vs the plain update of "
                        "the card's cotangent", state["emb"][k][T], v, failures)
        moved = bit_sum(state["emb"][k]) - bit_sum(state["emb"][k][T])
        if moved != rest[k]:
            failures.append(f"{tag}: {k}: rows the stream does not touch changed")
    live = dY2[bags.long()].abs().amax(1) > 0
    slot = int(torch.bincount(bags[live].long() % dY.shape[1]).argmax())
    faulty = dY.clone()
    faulty[:, slot] = 0
    # the fault moves only the rows that the slot's lookups touch: the plain update of the
    # faulty cotangent runs on their part of the stream, from their rows before the step, and
    # every other row keeps the card's store (bit for bit the plain update, held above)
    mine = torch.isin(pos, pos[bags.long() % dY.shape[1] == slot])
    at = pos[mine].long()
    plain = {k: state["emb"][k][T] for k in compact}
    for k, v in plain.items():
        v[at] = compact[k][at]
    with plain_kernels():
        row_optim.apply_sparse(opt, plain, (pos[mine], bags[mine], msk[mine], wgt[mine]),
                               faulty.reshape(-1, dY.shape[-1]), cfg.emb_lr)
    differ = sum(int((state["emb"][k][T].view(torch.int16) != v.view(torch.int16)).sum())
                 for k, v in plain.items() if v.element_size() == 2)
    log(f"  {tag}: planted fault (slot {slot}'s cotangent zeroed): {differ} values differ from "
        "the card's store")
    if not differ:
        failures.append(f"{tag}: the planted fault (slot {slot}'s cotangent zeroed) was not seen")
    return {"loss": float(loss), "loss_plain": float(loss_p), "rows_touched": int(T.numel()),
            "lookups_here": int(keep.sum()), "fault_values_differ": differ,
            "dense_gap": dense_gap}


def dryrun_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 34: the dry run on the card (34a, 34b, 34c in the module
    docstring).  Returns rows 1, 2, 4 and 5's launches in 34a's steps and
    the phase's numbers (each cell's record)."""
    import torch
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cells = {"pod1x16x16": [], "pod2x16x16": []}
    ops.reset_launches()
    t0 = time.perf_counter()
    for arch in base.list_archs():
        ad = base.get(arch)
        if ad.family == "lm":
            continue
        for cell in ad.cells:
            try:
                rec = dryrun.run_cell(arch, cell.shape, make_production_mesh(device="cpu"),
                                      "pod1x16x16", device=dev, timed=DRYRUN_TIMED)
            except Exception as e:  # noqa: BLE001  (each failed cell fails the run)
                failures.append(f"34a {arch} {cell.shape}: {type(e).__name__}: {e}")
                continue
            m, c = rec["memory"], rec["collectives"]
            log(f"  34a {arch} {cell.shape}: {rec['status']}; arguments {m['argument_bytes']} B "
                f"(built {m['built_bytes']}), outputs {m['output_bytes']} B, peak "
                f"{m.get('peak_bytes')} B; collectives {c['bytes_out']} ({c['total_bytes']} B); "
                f"product_flops {rec['cost']['product_flops']:.4g}; step {rec['step_ms']:.3f} ms")
            if rec["status"] != "ok" or m["built_bytes"] != m["argument_bytes"]:
                failures.append(f"34a {arch} {cell.shape}: status {rec['status']}, built "
                                f"{m['built_bytes']} B of {m['argument_bytes']}")
            cells["pod1x16x16"].append(rec)
            torch.cuda.empty_cache()
    got = ops.launches()
    launches = {k: got[k] for k in ("embedding_bag", "dot_interaction", "split_sgd",
                                    "embedding_update")}
    log(f"  34a: {len(cells['pod1x16x16'])} cells in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    for k, n in launches.items():
        if not n:
            failures.append(f"34a: the dry run's steps launched no {k}")
    held = {}
    for arch, shape, dense_held in DRYRUN_HELD:
        held[f"{arch} {shape}"] = dryrun_held(arch, shape, dense_held, dev, failures)
        torch.cuda.empty_cache()
    ops.reset_launches()
    for name in ("pod1x16x16", "pod2x16x16"):
        mesh = make_production_mesh(**dryrun.MESHES[name], device="cpu")
        for arch in base.list_archs():
            ad = base.get(arch)
            if ad.family != "lm" and name == "pod1x16x16":
                continue
            for cell in ad.cells:
                rec = dryrun.run_cell(arch, cell.shape, mesh, name, device=dev, step=False)
                want = "skipped" if cell.skip else "structs_only"
                if rec["status"] != want:
                    failures.append(f"34c {arch} {cell.shape} {name}: {rec['status']}, want {want}")
                cells[name].append(rec)
    log("  34c: " + "; ".join(
        f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']}"
        + (f" {r['memory']['argument_bytes']} B" if "memory" in r else "")
        for rs in cells.values() for r in rs if r["status"] != "ok"))
    return launches, {"cells": cells, "held": held}


# phase 35: LM training and serving on a mesh, two processes sharing the card over gloo
# (every payload staged through pinned host memory), one call of the pool's ranks for 35a-35d.
# 35a: internlm2-1.8b at full size on (1, 2), TP 2 with sequence parallelism, 3 steps on
# one batch
LM_MESH_TRAIN = dict(batch=2, seq=2048, steps=3, lr=1e-2, beta=0.9)
# 35b: one step at full width cut to 2 layers on (1, 2) against the one-rank step on the
# card from the same state: the loss within 1e-3 relative, each leaf's update within 3e-2
# of its largest (30a's rule); the mesh's sums (row-parallel partial sums reduced in fp32,
# each rank's bf16 gradient blocks) round apart from one rank's
LM_MESH_GATE = dict(layers=2, batch=2, seq=512)
LM_MESH_GATE_TOL = {"loss": 1e-3, "update": 3e-2}
# 35c: internlm2-1.8b served on (1, 2) with attn_impl="pallas": the gathered prefill logits
# held to the one-rank prefill within phase 15's gate, then greedy decode steps
LM_MESH_SERVE = dict(batch=LM_BATCH, prompt=LM_PROMPT, decode=LM_DECODE)
LM_MESH_SERVE_TOL = 0.2
# 35d: qwen3-moe-30b-a3b at full width cut to 2 of 48 layers on (2, 1): experts over data,
# the all-to-all on the card; its first MoE block held to the one-rank block on the rank's
# rows with the routing pinned, within MOE_MESH_TOL of the largest output
MOE_MESH = dict(layers=2, batch=2, seq=2048, steps=3, lr=1e-2)
MOE_MESH_TOL = 2 ** -6
# 35e: the launcher at --ranks 2; its uninterrupted run is also held to the same run at
# --ranks 1 within 35b's loss gate (on the card the two are not bit for bit: the ranks'
# gradients sum in another order than one rank's)
LM_MESH_LAUNCH_ARGV = ("--arch", "internlm2-1.8b", "--batch", "8", "--seq", "128", "--steps",
                       "4")


def lm_mesh_cfg(layers: int = 0):
    """internlm2-1.8b (its published widths) on the (1, 2) mesh: TP 2 over
    ``model``, sequence parallel, no microbatches; ``layers`` cuts its
    depth."""
    from repro_torch.configs import internlm2_1_8b
    cfg = dataclasses.replace(internlm2_1_8b.config(), dp_axes=("data",), tp_size=2,
                              seq_shard=True, microbatch=1)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def lm_mesh_rank_train(mesh, dev, failures) -> dict:
    """35a on this rank: the state drawn from the seed and cut, 3 steps on
    one batch; per step the loss, the host ms and the collectives' bytes;
    row 4's launches, the peak memory."""
    import torch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps
    from repro_torch.optim.data_parallel import tree_leaves

    c, cfg = LM_MESH_TRAIN, lm_mesh_cfg()
    B, L = c["batch"], c["seq"]
    t0 = time.perf_counter()
    state = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    batch = lm_steps.local_batch(cfg, mesh, {k: torch.as_tensor(v, device=dev) for k, v in
                                             next(token_stream(SEED, cfg.vocab, B, L)).items()})
    step, _ = lm_steps.make_lm_train_step(cfg, mesh, B, L, lr=c["lr"], beta=c["beta"])
    torch.cuda.reset_peak_memory_stats()
    before = ops.split_sgd.launches
    losses, walls, stats = [], [], []
    for _ in range(c["steps"]):
        mesh.stats.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = step(state, batch)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t) * 1e3)
        stats.append(mesh.stats.as_dict())
    leaves = len(tree_leaves(state["hi"]))
    launches = ops.split_sgd.launches - before
    if launches != c["steps"] * leaves:
        failures.append(f"35a: rank {mesh.rank}: row 4 launched {launches} times in "
                        f"{c['steps']} steps, not once a leaf-shard ({leaves}) a step")
    out = {"losses": losses, "step_ms_wall": walls, "launches": launches, "leaves": leaves,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "draw_s": draw_s,
           "state_gb": sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9,
           "bytes_out": {k: v for k, v in stats[-1]["bytes_out"].items() if v},
           "calls": {k: v for k, v in stats[-1]["calls"].items() if v},
           "staging_s": stats[-1]["staging_s"], "wire_s": stats[-1]["wire_s"]}
    del state, step
    torch.cuda.empty_cache()
    return out


class SkippedReduce:
    """Inside ``with``, this rank's row-parallel product on ``w`` (a layer's
    weight, found by its memory) keeps its own partial sums: the reduce
    still runs, so the ranks stay in step, and its result is dropped (kept
    in the graph at zero weight, so the backward's collectives run too)."""

    def __init__(self, w, on: bool):
        self.ptr, self.on = w.data_ptr(), on

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.orig = row = tf.MeshPlan.row
        ptr, on = self.ptr, self.on

        def skipped(plan, x, w):
            out = row(plan, x, w)
            if not on or w.data_ptr() != ptr:
                return out
            return plan.own_tokens(x.float() @ w.float()).to(x.dtype) + 0 * out
        tf.MeshPlan.row = skipped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf.MeshPlan.row = self.orig
        return False


def lm_mesh_block_gaps(start: dict, mesh_after: dict, one_after: dict, mesh) -> list:
    """Each leaf's largest gap between the mesh's and the one-rank update
    (fp32 masters less the start's) over the one-rank update's largest:
    every argument this rank's blocks, the two maxima of each leaf taken
    over the mesh (an all-gather of two numbers a leaf), so no state is
    gathered."""
    import torch
    from repro_torch.dist import comm
    from repro_torch.optim.data_parallel import tree_leaves
    from repro_torch.optim.split_sgd import combine_split
    part = []
    for h0, l0, h1, l1, h2, l2 in zip(*(tree_leaves(s[k]) for s in (start, mesh_after, one_after)
                                        for k in ("hi", "lo"))):
        w0 = combine_split(h0, l0)
        d_one = combine_split(h2, l2) - w0
        part.append(torch.stack([(combine_split(h1, l1) - w0 - d_one).abs().max(),
                                 d_one.abs().max()]))
    top = comm.all_gather(torch.stack(part)[None], mesh.group(mesh.axis_names)).amax(dim=0)
    return [float(n) / max(float(d), 1e-30) for n, d in top.tolist()]


def lm_mesh_rank_gate(mesh, dev, failures) -> dict:
    """35b on this rank: one step at full width cut to LM_MESH_GATE["layers"]
    on (1, 2), row 4 held bit for bit to its plain version on the rank's own
    gradient blocks; each rank also runs the one-rank step on the card from
    the same state (drawn whole from the same seed, which must cut to the
    mesh's start bit for bit) and holds its blocks of the mesh step to its
    blocks of it (LM_MESH_GATE_TOL; :func:`lm_mesh_block_gaps`), then the
    two planted faults, which must fail the gate.  ``launches``: row 4's in
    the mesh step alone (not in the faults' steps or the one-rank step)."""
    import torch
    from repro_torch import weights
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps
    from repro_torch.optim.data_parallel import tree_leaves, tree_map

    g, cfg = LM_MESH_GATE, lm_mesh_cfg(LM_MESH_GATE["layers"])
    B, L = g["batch"], g["seq"]
    lr, beta = LM_MESH_TRAIN["lr"], LM_MESH_TRAIN["beta"]
    start = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), mesh)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(token_stream(SEED + 1, cfg.vocab, B, L)).items()}
    step, _ = lm_steps.make_lm_train_step(cfg, mesh, B, L, lr=lr, beta=beta)

    def mesh_step(b, tap, skip=None):
        s = tree_map(torch.clone, start)
        with tap, SkippedReduce(s["hi"]["layers"]["mlp"]["wd"][1], skip == mesh.rank):
            _, loss = step(s, lm_steps.local_batch(cfg, mesh, b))
        return s, float(loss)

    tap = UpdateTap(failures, tag="35b")
    before = ops.split_sgd.launches
    got, loss = mesh_step(batch, tap)
    launches = ops.split_sgd.launches - before
    if launches != len(tree_leaves(start["hi"])):
        failures.append(f"35b: rank {mesh.rank}: row 4 launched {launches} times in the mesh "
                        "step, not once a leaf-shard")
    shifted = dict(batch, labels=torch.roll(batch["labels"], 1, dims=1))
    faults = [("labels shifted by one", shifted, None),
              ("layer 1's mlp row-parallel reduce skipped on rank 1", batch, 1)]
    faulty = [mesh_step(b, UpdateTap(failures, check=False), skip) for _, b, skip in faults]
    # the one-rank step from the same state, whole on this rank, then cut to its blocks
    whole = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    cut = weights.lm_state_from_global(whole, cfg, mesh)
    if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(tree_leaves(cut), tree_leaves(start))):
        failures.append(f"35b: rank {mesh.rank}: the mesh's start is not the one-rank draw cut")
    _, one_loss = lm_steps.make_lm_train_step(cfg, B, L, lr=lr, beta=beta, device=dev)[0](
        whole, batch)
    one_loss = float(one_loss)
    one = weights.lm_state_from_global(whole, cfg, mesh)
    del whole
    names = leaf_names(start["hi"])

    def gaps(state, fl):
        return abs(fl - one_loss) / abs(one_loss), lm_mesh_block_gaps(start, state, one, mesh)

    lg, ug = gaps(got, loss)
    out = {"row4_leaves_bitwise": tap.leaves, "row4_max_abs_err": tap.err, "launches": launches,
           "loss_mesh": loss,
           "loss_one_rank": one_loss, "loss_rel_gap": lg, "update_gaps": dict(zip(names, ug))}
    lead = mesh.rank == 0
    if lead:
        log(f"35b: loss (1, 2) {loss:.6f}, one rank {one_loss:.6f} (relative gap {lg:.2e}, gate "
            f"{LM_MESH_GATE_TOL['loss']}); worst update gap {max(ug):.3e} of the leaf's largest "
            f"({names[int(np.argmax(ug))]}; gate {LM_MESH_GATE_TOL['update']}); row 4 bit for "
            f"bit its plain version on {tap.leaves} leaf-shards of rank 0")
    if lg > LM_MESH_GATE_TOL["loss"] or max(ug) > LM_MESH_GATE_TOL["update"]:
        failures.append(f"35b: rank {mesh.rank}: the (1, 2) step is not the one-rank step: "
                        f"loss gap {lg:.2e}, update gap {max(ug):.3e}")
    for (fault, _, _), (state, fl) in zip(faults, faulty):
        flg, fug = gaps(state, fl)
        caught = flg > LM_MESH_GATE_TOL["loss"] or max(fug) > LM_MESH_GATE_TOL["update"]
        out[f"fault: {fault}"] = {"loss_rel_gap": flg, "worst_update_gap": max(fug),
                                  "caught": caught}
        if lead:
            log(f"35b: fault '{fault}': loss gap {flg:.2e}, worst update gap {max(fug):.3e} "
                f"({names[int(np.argmax(fug))]}): {'rejected' if caught else 'PASSED THE GATE'}")
        if not caught:
            failures.append(f"35b: rank {mesh.rank}: the fault '{fault}' passed the gate")
    del got, faulty, one, start
    torch.cuda.empty_cache()
    return out


def lm_mesh_want(path, timeout_s: float = 600.0) -> dict:
    """35c's one-rank reference, which the parent writes to ``path`` (an
    ``.npz``, then ``path`` + ``.done``) while the ranks run 35b and 35a."""
    done = Path(str(path) + ".done")
    t0 = time.perf_counter()
    while not done.exists():
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"35c: no one-rank reference at {path} within {timeout_s} s")
        time.sleep(0.2)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def lm_mesh_rank_serve(mesh, dev, failures, want) -> dict:
    """35c on this rank: internlm2-1.8b's bf16 weights drawn from the seed and
    cut, ``attn_impl="pallas"``: the prefill of LM_MESH_SERVE's prompts (row
    13 on the rank's 8 q and 4 KV heads, one launch a layer), its logits
    gathered; then greedy decode steps on the grown cache, each step's
    logits gathered and its argmax fed back.  ``want``: where the parent
    writes the one-rank prefill's prompts, logits and greedy tokens
    (:func:`lm_mesh_want`)."""
    import torch
    from repro_torch import weights
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps

    s = LM_MESH_SERVE
    cfg = dataclasses.replace(lm_mesh_cfg(), attn_impl="pallas")
    B, L, N = s["batch"], s["prompt"], s["decode"]
    params = weights.init_lm_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                    mesh=mesh)
    want = lm_mesh_want(want)
    prompts = torch.as_tensor(want["prompts"], device=dev)
    prefill, _ = lm_steps.make_prefill_step(cfg, mesh, B, L)
    decode, _ = lm_steps.make_decode_step(cfg, mesh, B, L + N)
    spec = (("data",), "model")
    flash0 = ops.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    full = shd.gather_block(logits, spec, mesh)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    flash = ops.flash_attention.launches - flash0
    gap = float((full.cpu() - torch.as_tensor(want["logits"])).abs().max())
    if flash != cfg.n_layers:
        failures.append(f"35c: rank {mesh.rank}: row 13 launched {flash} times in the prefill, "
                        f"not once a layer ({cfg.n_layers})")
    if gap > LM_MESH_SERVE_TOL or not bool(torch.isfinite(full).all()):
        failures.append(f"35c: the (1, 2) prefill's logits are {gap:.3e} from the one-rank "
                        f"prefill's (gate {LM_MESH_SERVE_TOL})")
    big = {}
    for k, c in cache.items():
        big[k] = torch.zeros(c.shape[:3] + (L + N,) + c.shape[4:], dtype=c.dtype, device=dev)
        big[k][:, :, :, :L] = c
    del cache
    tok = full.argmax(-1).to(torch.int32)
    tokens, walls = [tok.cpu().tolist()], []
    for i in range(N - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, big = decode(params, big, tok, torch.full((B,), L + i, dtype=torch.int32, device=dev))
        whole = shd.gather_block(lg, spec, mesh)
        tok = whole.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        if not bool(torch.isfinite(whole).all()):
            failures.append(f"35c: decode step {i}'s logits are not finite")
        tokens.append(tok.cpu().tolist())
    same = sum(a == b for x, y in zip(tokens, want["tokens"].tolist()) for a, b in zip(x, y))
    out = {"prefill_logit_gap": gap, "ttft_s": ttft, "flash_launches": flash,
           "decode_ms_wall": walls, "tokens": tokens,
           "tokens_as_one_rank": same, "tokens_total": B * N}
    del params, big
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank_moe(mesh, dev, failures) -> dict:
    """35d on this rank of the (2, 1) mesh: qwen3-moe at full width cut to
    MOE_MESH["layers"], experts over ``data``: the first MoE block on the
    rank's row against the one-rank block (:func:`models.transformer.moe_block`,
    the whole experts gathered) with the routing pinned
    (:class:`MoeRoutes`), then 3 train steps on one batch; the dropped share
    of (token, expert) pairs."""
    import torch
    from repro_torch.configs import qwen3_moe_30b_a3b
    from repro_torch.data.synthetic import token_stream
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import lm_steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim.data_parallel import tree_leaves

    m = MOE_MESH
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.config(), n_layers=m["layers"],
                              dp_axes=("data",), tp_size=1, seq_shard=True, microbatch=1)
    B, L = m["batch"], m["seq"]
    state = lm_steps.init_lm_state(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh)
    par = tf.mesh_plan(cfg, mesh, ("data",))
    p = {k: v[0] for k, v in state["hi"]["layers"]["moe"].items()}
    s = tf._layer_specs(par.specs["layers"])["moe"]
    x = (torch.randn((B, L, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev) * 0.5).to(torch.bfloat16)
    rows = x[mesh.rank * (B // 2):(mesh.rank + 1) * (B // 2)]
    whole = {k: shd.gather_block(v, s[k], mesh) for k, v in p.items()}
    routes = MoeRoutes(cfg)
    with torch.no_grad():
        with routes.record():
            want = tf.moe_block(rows, whole, cfg)
        a2a0 = mesh.stats.calls["all-to-all"]
        with routes.replay("all"):
            got = tf.mesh_moe_block(par, rows, p, s)
    keep = routes.calls[0][2]
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    if err > MOE_MESH_TOL or mesh.stats.calls["all-to-all"] - a2a0 != 2:
        failures.append(f"35d: rank {mesh.rank}: the expert-parallel block is {err:.3e} of its "
                        f"largest from the one-rank block (gate {MOE_MESH_TOL})")
    del whole, want, got
    batch = lm_steps.local_batch(cfg, mesh, {k: torch.as_tensor(v, device=dev) for k, v in
                                             next(token_stream(SEED, cfg.vocab, B, L)).items()})
    step, _ = lm_steps.make_lm_train_step(cfg, mesh, B, L, lr=m["lr"])
    before = ops.split_sgd.launches
    losses, walls = [], []
    for _ in range(m["steps"]):
        mesh.stats.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(state, batch)[1]))
        walls.append((time.perf_counter() - t) * 1e3)
    launches = ops.split_sgd.launches - before
    leaves = len(tree_leaves(state["hi"]))
    if launches != m["steps"] * leaves:
        failures.append(f"35d: rank {mesh.rank}: row 4 launched {launches} times, not "
                        f"{leaves} a step")
    out = {"block_rel_err": err, "route_flips": routes.flips,
           "dropped_share": 1 - float(keep.float().mean()), "losses": losses,
           "step_ms_wall": walls, "launches": launches,
           "a2a_bytes_a_step": mesh.stats.bytes_out["all-to-all"],
           "bytes_out": {k: v for k, v in mesh.stats.bytes_out.items() if v}}
    del state, step
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(rank: int, world: int, want: str, device: str = "cuda:0") -> dict:
    """Phases 35a-35d in one of two processes sharing the card: the (1, 2)
    and (2, 1) meshes made, then each part in turn, 35b's small gate first
    (every part runs on both ranks: their collectives pair).  Returns each part's numbers, the
    failures, and row 4's and row 13's launches on the mesh paths alone, by part: 35a's and
    35d's train steps, 35b's mesh step (not its faults' or its one-rank step), 35c's
    prefill."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    dev = mesh_rank_setup(device)
    tp = make_mesh((1, 2), ("data", "model"), dev)
    ep = make_mesh((2, 1), ("data", "model"), dev)
    failures, out = [], {}
    ops.reset_launches()
    for tag, fn in (("35b", lambda: lm_mesh_rank_gate(tp, dev, failures)),
                    ("35a", lambda: lm_mesh_rank_train(tp, dev, failures)),
                    ("35c", lambda: lm_mesh_rank_serve(tp, dev, failures, want)),
                    ("35d", lambda: lm_mesh_rank_moe(ep, dev, failures))):
        t0 = time.perf_counter()
        out[tag] = fn()
        out[tag]["seconds"] = time.perf_counter() - t0
    out["failures"] = failures
    out["launches"] = {"split_sgd": {t: out[t]["launches"] for t in ("35a", "35b", "35d")},
                       "flash_attention": {"35c": out["35c"]["flash_launches"]}}
    return out


def lm_mesh_reference(dev, path) -> None:
    """35c's one-rank reference on the card: internlm2-1.8b's weights from
    the seed (the draw the ranks cut), its prefill of seeded prompts with
    ``attn_impl="pallas"`` and the greedy tokens of LM_MESH_SERVE's decode
    steps; written to ``path`` for :func:`lm_mesh_want`."""
    import torch
    from repro_torch import weights
    from repro_torch.models import lm_steps

    s = LM_MESH_SERVE
    cfg = dataclasses.replace(lm_mesh_cfg(), attn_impl="pallas")
    B, L, N = s["batch"], s["prompt"], s["decode"]
    params = weights.init_lm_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab, (B, L), dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 7))
    logits, cache = lm_steps.make_prefill_step(cfg, B, L, device=dev)[0](params, prompts)
    decode, _ = lm_steps.make_decode_step(cfg, B, L + N, device=dev)
    big = {k: torch.zeros(c.shape[:3] + (L + N,) + c.shape[4:], dtype=c.dtype, device=dev)
           for k, c in cache.items()}
    for k, c in cache.items():
        big[k][:, :, :, :L] = c
    del cache
    tok = logits.argmax(-1).to(torch.int32)
    tokens = [tok.cpu().tolist()]
    for i in range(N - 1):
        lg, big = decode(params, big, tok, torch.full((B,), L + i, dtype=torch.int32, device=dev))
        tok = lg.argmax(-1).to(torch.int32)
        tokens.append(tok.cpu().tolist())
    np.savez(path, prompts=prompts.cpu().numpy(), logits=logits.cpu().numpy(),
             tokens=np.array(tokens))
    Path(str(path) + ".done").touch()
    del params, big, logits
    torch.cuda.empty_cache()


def lm_mesh_phase(dev, failures, meanwhile=None) -> tuple[dict, dict]:
    """Phase 35: the LM steps on meshes of two processes sharing the card
    (gloo, payloads staged through host memory).  35e's launcher runs start
    first, as subprocesses (:class:`LauncherRuns`); then 35a-35d on the
    pool's two ranks (:func:`lm_mesh_rank`); while they run (their time goes to
    gloo's host copies) this process computes 35c's one-rank reference
    (:func:`lm_mesh_reference`), runs ``meanwhile()`` (phase 34d's rank-0
    steps) and ends 35e.  Returns rows 4 and 13's launches and the phase's
    numbers."""
    import threading
    import torch

    want = ROOT / "build" / "lm_mesh_want.npz"
    for f in (want, Path(str(want) + ".done")):
        f.unlink(missing_ok=True)
    launcher = LauncherRuns(failures)
    t0 = time.perf_counter()
    box = {}

    def ranks_run():
        try:
            box["ranks"] = two_ranks(lm_mesh_rank, (str(want),), timeout_s=900)
        except BaseException as e:  # noqa: BLE001  (raised below, in this thread)
            box["error"] = e
    runner = threading.Thread(target=ranks_run)
    runner.start()
    try:
        lm_mesh_reference(dev, want)
        if meanwhile is not None:
            meanwhile()
        box["35e"] = launcher.finish()
    finally:
        runner.join()
        launcher.stop()
        for f in (want, Path(str(want) + ".done")):
            f.unlink(missing_ok=True)
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        failures += r["failures"]
    nums = {"ranks_s": ranks_s, **{tag: [r[tag] for r in ranks] for tag in
                                   ("35a", "35b", "35c", "35d")}}
    a = [r["35a"] for r in ranks]
    if not all(np.isfinite(x["losses"]).all() for x in a):
        failures.append(f"35a: a loss is not finite: {[x['losses'] for x in a]}")
    if abs(a[0]["losses"][0] - np.log(lm_mesh_cfg().vocab)) > 0.5 or \
            not a[0]["losses"][-1] < a[0]["losses"][0]:
        failures.append(f"35a: losses {a[0]['losses']}: not near ln V, then falling")
    log(f"35a: internlm2-1.8b on (1, 2): losses {a[0]['losses']}; step ms (host clock, both "
        f"ranks on one card, gloo through host memory) {[x['step_ms_wall'] for x in a]}; "
        f"collective bytes out a step {a[0]['bytes_out']} (calls {a[0]['calls']}), staging "
        f"{a[0]['staging_s']:.2f} s, wire {a[0]['wire_s']:.2f} s; state "
        f"{[round(x['state_gb'], 2) for x in a]} GB a rank, peak "
        f"{[round(x['peak_gb'], 2) for x in a]} GB a rank")
    c = ranks[0]["35c"]
    log(f"35c: prefill logits {c['prefill_logit_gap']:.3e} from the one-rank prefill's (gate "
        f"{LM_MESH_SERVE_TOL}); row 13 {c['flash_launches']} launches a rank; TTFT "
        f"{c['ttft_s']:.2f} s; decode ms (host clock) p50 {np.median(c['decode_ms_wall']):.1f}; "
        f"greedy tokens as the one rank's: {c['tokens_as_one_rank']} of {c['tokens_total']}")
    for r, d in enumerate(x["35d"] for x in ranks):
        log(f"35d rank {r}: the expert-parallel block {d['block_rel_err']:.3e} of its largest "
            f"from the one-rank block ({d['route_flips']} routes pinned that flipped); dropped "
            f"share {d['dropped_share']:.4f}; losses {d['losses']}; all-to-all bytes a step "
            f"{d['a2a_bytes_a_step']}")
    if not ranks[0]["35d"]["losses"][-1] < ranks[0]["35d"]["losses"][0]:
        failures.append(f"35d: the loss did not fall: {ranks[0]['35d']['losses']}")
    # each kernel's launches on the mesh paths, summed over the ranks, by part and in all
    launches = {k: {t: sum(r["launches"][k][t] for r in ranks) for t in ranks[0]["launches"][k]}
                for k in ("split_sgd", "flash_attention")}
    launches = {k: {**v, "all": sum(v.values())} for k, v in launches.items()}

    nums["35e"] = box["35e"]
    torch.cuda.empty_cache()
    return launches, nums


class LauncherRuns:
    """Phase 35e: ``python -m repro_torch.launch.train`` at ``--ranks 2``
    (two processes on the card over gloo) as subprocesses: the
    uninterrupted run, a ``--ckpt-dir`` run stopped by ``--preempt-at 1``
    after its checkpoint at step 2, and the uninterrupted run at ``--ranks
    1`` start at once; :meth:`finish` starts the second's restart when it
    ends, holds the restart's losses to the uninterrupted run's bit for bit
    and the uninterrupted run's to the one-rank run's within
    LM_MESH_GATE_TOL["loss"] relative (each run writes them with
    ``--losses-json``)."""

    def __init__(self, failures):
        import os
        import shutil
        self.failures, self.runs, self.procs = failures, {}, {}
        self.dir = ROOT / "build" / "lm_mesh_launch"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        self.ck = ["--ckpt-dir", str(self.dir / "ckpt"), "--ckpt-every", "2"]
        self.start("uninterrupted", [])
        self.start("first", self.ck + ["--preempt-at", "1"])
        self.start("one_rank", [], ranks=1)

    def start(self, name: str, extra: list, ranks: int = 2) -> None:
        import subprocess
        self.procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *LM_MESH_LAUNCH_ARGV, "--ranks",
             str(ranks), *extra,
             "--losses-json", str(self.dir / f"{name}.json")], cwd=ROOT, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def wait(self, name: str) -> bool:
        t0, proc = self.procs[name]
        _, err = proc.communicate(timeout=600)
        path = self.dir / f"{name}.json"
        if proc.returncode != 0 or not path.exists():
            self.failures.append(f"35e: the launcher's {name} run exited "
                                 f"{proc.returncode}: {err[-2000:]}")
            return False
        self.runs[name] = {**json.loads(path.read_text()), "seconds": time.perf_counter() - t0}
        return True

    def finish(self) -> dict:
        if not self.wait("first"):
            return {}
        self.start("restart", self.ck)
        if not all([self.wait("restart"), self.wait("uninterrupted"), self.wait("one_rank")]):
            return {}
        whole, first, again, one = (self.runs[k]["losses"] for k in
                                    ("uninterrupted", "first", "restart", "one_rank"))
        bitwise = (self.runs["restart"]["start_step"] == len(first) == 2
                   and first + again == whole)
        gap = max(abs(a - b) / abs(b) for a, b in zip(whole, one))
        log(f"35e: the launcher at --ranks 2 "
            f"({ {k: round(r['seconds'], 1) for k, r in self.runs.items()} } s): uninterrupted "
            f"{whole}; stopped after {len(first)} steps, restored at "
            f"{self.runs['restart']['start_step']}, its losses bit for bit the uninterrupted "
            f"run's: {bitwise}; at --ranks 1 {one}, {gap:.3e} relative from --ranks 2 (gate "
            f"{LM_MESH_GATE_TOL['loss']}), bit for bit: {whole == one}")
        if not bitwise:
            self.failures.append(f"35e: the restart's losses {first} + {again} are not the "
                                 f"uninterrupted {whole}")
        if len(one) != len(whole) or gap > LM_MESH_GATE_TOL["loss"]:
            self.failures.append(f"35e: the losses at --ranks 2 {whole} are {gap:.3e} relative "
                                 f"from those at --ranks 1 {one}")
        return {**self.runs, "bitwise": bitwise, "ranks_1_vs_2_rel_gap": gap,
                "ranks_1_vs_2_bitwise": whole == one}

    def stop(self) -> None:
        import shutil
        for _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_lm_phase(dev, failures) -> tuple[dict, dict]:
    """Phase 34d: every single-pod LM cell the reference does not skip at
    rank 0 of the 16 x 16 mesh (the module docstring).  Returns row 4's
    launches and each cell's record."""
    import torch
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cells = []
    # 34d: every single-pod LM cell, rank 0's step cut to its dense layers and one scan unit
    ops.reset_launches()
    t0 = time.perf_counter()
    for arch in base.list_archs():
        ad = base.get(arch)
        if ad.family != "lm":
            continue
        for cell in ad.cells:
            if cell.skip:
                continue
            try:
                rec = dryrun.run_cell(arch, cell.shape, make_production_mesh(device="cpu"),
                                      "pod1x16x16", device=dev, timed=0)
            except Exception as e:  # noqa: BLE001  (each failed cell fails the run)
                failures.append(f"34d {arch} {cell.shape}: {type(e).__name__}: {e}")
                continue
            m, c = rec["memory"], rec.get("collectives", {})
            log(f"  34d {arch} {cell.shape}: {rec['status']}; {rec['meta'].get('stepped_layers')} "
                f"of {rec['meta']['n_layers']} layers stepped; arguments {m['argument_bytes']} B "
                f"(full depth), {m.get('stepped_argument_bytes')} B stepped (built "
                f"{m.get('built_bytes')}), peak {m.get('peak_bytes')} B; collectives "
                f"{c.get('bytes_out')} ({c.get('total_bytes')} B)")
            if rec["status"] != "ok" or m["built_bytes"] != m["stepped_argument_bytes"]:
                failures.append(f"34d {arch} {cell.shape}: status {rec['status']} "
                                f"{rec.get('error', '')}")
            cells.append(rec)
            torch.cuda.empty_cache()
    got = ops.launches()
    lm_s = time.perf_counter() - t0
    log(f"  34d: the LM cells in {lm_s:.1f} s; row 4 launches {got['split_sgd']}")
    if not got["split_sgd"]:
        failures.append("34d: the LM train cells launched no split_sgd")
    return {"split_sgd": got["split_sgd"]}, {"cells": cells, "seconds": lm_s}


def shutil_rmtree(path) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.kernels import build
    from repro_torch.serve import SnapshotRegistry
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se

    # plain fp32 products in full fp32, not TF32, on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()
    clock = PhaseClock(t_run)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"peaks for the bounds (H100 SXM data sheet, at 700 W): {HBM_BYTES_PER_S / 1e12} TB/s, "
        f"{BF16_TENSOR_FLOPS / 1e12} TFLOP/s bf16 tensor, {FP32_FLOPS / 1e12} TFLOP/s fp32")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.build_log)} libraries")
    for stem, rec in build.build_log.items():
        info = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
        log(f"  {stem}: nvcc {rec['seconds']:.1f} s; " + " | ".join(info))
    clock.mark("1, build")
    for stem in ("flash_attention", "fused_mlp"):  # the warp-specialised TMA + wgmma kernels
        report = build.ptxas_report(stem)
        if not report:
            log(f"  {stem}: no ptxas report (the library was already built)")
        for r in report:
            if "warning" in r:
                log(f"  {stem}: {r['warning']}")
                continue
            spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
            log(f"  ptxas {r['kernel']}: {r.get('registers')} registers, {r.get('smem')} bytes "
                f"static smem, {r.get('spill_stores')} bytes spill stores, "
                f"{r.get('spill_loads')} bytes spill loads")
            if spills and r["kernel"].startswith(("flash_attention_kernel",
                                                  "fused_mlp_wgmma_kernel")):
                raise SystemExit(f"build failed: {r['kernel']} spills {spills} bytes")

    cfg = dataclasses.replace(dlrm_small(), mlp_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    reg = SnapshotRegistry()
    snap = reg.publish(weights.init_snapshot(cfg, gen, device=dev), step=0)
    torch.cuda.synchronize()
    log(f"snapshot v{snap.version}: emb_w {tuple(snap.state['emb_w'].shape)} "
        f"{snap.state['emb_w'].dtype}, {snap.emb_bytes / 1e9:.3f} GB "
        f"(fp32 would be {snap.fp32_emb_bytes / 1e9:.3f} GB), total {snap.total_bytes / 1e9:.3f} GB, "
        f"made in {time.perf_counter() - t0:.1f} s")
    offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED)

    failures: list[str] = []
    kernels = kernel_phase(cfg, snap.state, offsets, dev, rng, failures)
    if failures:
        raise SystemExit("kernel phase failed:\n" + "\n".join(failures))
    reqs = make_requests(cfg, N_REQUESTS, rng)
    counts = serving_phase(cfg, reg, offsets, dev, reqs, failures)
    clock.counts = counts
    if failures:
        raise SystemExit("serving phase failed:\n" + "\n".join(failures))
    breakdown_phase(cfg, reg, reqs, dev)
    clock.mark("2-4, kernels, serving, breakdown")

    # training: dlrm-small at full size, split_sgd, then sgd
    t_cfg = dlrm_small()
    t0 = time.perf_counter()
    state = dlrm.init_state(t_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batches = stage_batches(t_cfg, N_TRAIN, dev)
    torch.cuda.synchronize()
    log(f"train state: hi {tuple(state['emb']['hi'].shape)} bf16 + lo int16, "
        f"{sum(v.numel() * v.element_size() for v in state['emb'].values()) / 1e9:.3f} GB, dense "
        f"{state['dense']['lo'].numel()} values padded; {N_TRAIN} batches staged; "
        f"{time.perf_counter() - t0:.1f} s")
    kernels += row_kernel_phase(t_cfg, state, offsets, batches[0], dev, rng, failures)
    if failures:
        raise SystemExit("row kernel phase failed:\n" + "\n".join(failures))
    kernels += stateful_kernel_phase(t_cfg, master(state["emb"]), offsets, batches[0], dev, rng,
                                     failures)
    if failures:
        raise SystemExit("stateful row kernel phase failed:\n" + "\n".join(failures))
    variants = row_variants_phase(t_cfg, state, offsets, batches[0], dev, rng, failures)
    if failures:
        raise SystemExit("weighted and fp32-dY row kernel phase failed:\n" + "\n".join(failures))
    for k in kernels:  # rows 5-12 on the weighted and fp32-dY streams: their largest error too
        if k["name"] in variants:
            k["max_abs_err"] = max(k["max_abs_err"], variants[k["name"]]["max_abs_err"])
            k["weighted"] = variants[k["name"]]["weighted"]
    clock.mark("5, 8, 9, row kernels")
    torch.cuda.empty_cache()
    train_counts, bare_rate = training_phase(t_cfg, state, batches, dev, failures)
    if failures:
        raise SystemExit("training phase failed:\n" + "\n".join(failures))
    del state
    torch.cuda.empty_cache()
    counts.update(embedding_update=train_counts["embedding_update"],
                  split_sgd=train_counts["split_sgd"])
    for name in ("embedding_bag", "dot_interaction"):  # one a served batch and one a train step
        counts[name] += train_counts[name]
    for name in ("sgd", "momentum", "adagrad", "adagrad_freq", "adagrad_bf16"):
        c = short_phase(dataclasses.replace(t_cfg, sparse_optimizer=name,
                                            lr=ADAGRAD_LR if name in ("adagrad", "adagrad_bf16")
                                            else t_cfg.lr),
                        dev, batches[:3], failures)
        if failures:
            raise SystemExit(f"{name} phase failed:\n" + "\n".join(failures))
        counts[ROW_KERNEL[name]] = c[ROW_KERNEL[name]]
    clock.mark("6, 7, 11, training, sgd and the short runs")

    # the production default of the repo's 100M example: row-wise Adagrad
    r_cfg = dataclasses.replace(t_cfg, sparse_optimizer="adagrad_rowwise", lr=ADAGRAD_LR)
    state = dlrm.init_state(r_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    log("adagrad_rowwise train state: " + ", ".join(
        f"{k} {tuple(v.shape)} {v.dtype} {v.numel() * v.element_size() / 1e9:.3f} GB"
        for k, v in state["emb"].items()))
    r_counts, _ = training_phase(r_cfg, state, batches, dev, failures)
    if failures:
        raise SystemExit("adagrad_rowwise training phase failed:\n" + "\n".join(failures))
    del state
    torch.cuda.empty_cache()
    counts[ROW_KERNEL["adagrad_rowwise"]] = r_counts[ROW_KERNEL["adagrad_rowwise"]]

    # the compressed momentum with weighted bags: the fp32 table, the bf16
    # momentum, a weight on every lookup, the seed counter on the card
    m_cfg = dataclasses.replace(t_cfg, sparse_optimizer="momentum_bf16", weighted=True)
    state = dlrm.init_state(m_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    log("momentum_bf16 train state: " + ", ".join(
        f"{k} {tuple(v.shape)} {v.dtype} {v.numel() * v.element_size() / 1e9:.3f} GB"
        for k, v in state["emb"].items()) + f", sr {int(state['sr'])}")
    del batches
    m_counts, _ = training_phase(m_cfg, state, stage_batches(m_cfg, N_TRAIN, dev), dev,
                                 failures)
    if failures:
        raise SystemExit("weighted momentum_bf16 training phase failed:\n" + "\n".join(failures))
    del state
    torch.cuda.empty_cache()
    counts[ROW_KERNEL["momentum_bf16"]] = m_counts[ROW_KERNEL["momentum_bf16"]]
    clock.mark("10, 12, adagrad_rowwise and weighted momentum_bf16 training")

    # the run loop: dlrm-small trains, checkpoints, restarts and scores through TrainLoop
    loop_counts = run_loop_phase(t_cfg, dev, bare_rate, failures)
    if failures:
        raise SystemExit("run loop phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd"):
        counts[name] += loop_counts[name]
    clock.mark("13, the run loop")

    # LM serving: the flash-attention kernel, then internlm2-1.8b's prefill and decode
    attn_entry = attention_kernel_phase(dev, failures)
    if failures:
        raise SystemExit("attention kernel phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    from repro_torch.configs import internlm2_1_8b
    lm_counts, lm = lm_phase(dataclasses.replace(internlm2_1_8b.config(), attn_impl="pallas"),
                             dev, failures, "15", yardstick=True, long_prefill=True)
    if failures:
        raise SystemExit("LM serving phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    counts["flash_attention"] = lm_counts["flash_attention"]
    lm_runs = [lm]
    clock.mark("14, 15, attention and LM serving")

    # the hybrid step: table mode on one rank over NCCL, then two ranks on the one card (the
    # pool of phases 16b-23a starts meanwhile)
    open_pool()
    h_batches = stage_batches(t_cfg, N_TRAIN, dev)
    h_one, fp32_wire = hybrid_one_rank_phase(dev, h_batches, failures)
    if failures:
        raise SystemExit("hybrid phase (16a, one rank) failed:\n" + "\n".join(failures))
    del h_batches
    torch.cuda.empty_cache()
    clock.mark("16a, the hybrid step on one rank")
    h_two = hybrid_two_rank_phase(failures)
    if failures:
        raise SystemExit("hybrid phase (16b, two ranks) failed:\n" + "\n".join(failures))
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd",
                 "embedding_update_adagrad_rowwise"):
        counts[name] += h_one[name] + h_two.get(name, 0)
    clock.mark("16b, the hybrid step on two ranks")

    # the run loop on a mesh: dlrm-small on (1, 2), then the quickstart's contract on
    # (2, 4) and the elastic restart from (2, 4) to (1, 4), ranks sharing the card
    m_counts = mesh_loop_phase(dev, failures)
    if failures:
        raise SystemExit("run loop on a mesh (17a) failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    clock.mark("17a, the run loop on (1, 2)")
    q_counts = quickstart_mesh_phase(failures)
    if failures:
        raise SystemExit("quickstart and elastic restart on a mesh (17b, 17c) failed:\n"
                         + "\n".join(failures))
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd"):
        counts[name] += m_counts.get(name, 0) + q_counts.get(name, 0)
    torch.cuda.empty_cache()
    clock.mark("17b, 17c, the quickstart and the elastic restart on meshes")

    # the rest of the step's exchange surface: the host pre-sort, the bf16 and bf16_sr
    # wires, microbatches and the ring index exchange
    x_batches = stage_batches(t_cfg, N_TRAIN, dev)

    def gate(tag: str, got: dict) -> None:
        if failures:
            raise SystemExit(f"phase {tag} failed:\n" + "\n".join(failures))
        for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd"):
            counts[name] += got.get(name, 0)
        torch.cuda.empty_cache()

    got, busy_m1 = presort_phase(dev, x_batches, failures)
    gate("18a, the host pre-sort", got)
    gate("18a/18b, table mode on the NCCL mesh",
         exchange_nccl_phase(dev, x_batches, failures, fp32_wire))
    gate("18c, microbatches", microbatch_phase(dev, x_batches, failures, busy_m1))
    del x_batches
    gate("18d, the ring on two ranks", ring_two_rank_phase(failures))
    clock.mark("18, the exchange surface")

    # the hot-row cache, the step metrics and their drain, the stage profile
    c_batches = stage_batches(t_cfg, N_TRAIN + 1, dev)
    c_counts = cache_phase(dev, c_batches[:N_TRAIN], c_batches[N_TRAIN], failures)
    del c_batches
    gate("19, the hot-row cache and the step metrics", c_counts)
    clock.mark("19, the hot-row cache and the step metrics")

    # packed-shard ingestion, train-to-serve publishing and the launcher
    gate("20a, ingestion and publishing", ingest_phase(dev, failures))
    got = launcher_phase(dev, failures)
    if failures:
        raise SystemExit("phase 20b/20c, the launcher failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] = counts.get(name, 0) + v
    clock.mark("20, ingestion, publishing and the launcher")

    # the recsys archetypes at their published widths: rows 1 and 5-12 at their
    # widths, then each archetype's train, serve and retrieval steps
    widths = narrow_kernel_phase(dev, rng, failures)
    if failures:
        raise SystemExit("phase 21a, rows 1 and 5-12 at the archetypes' widths failed:\n"
                         + "\n".join(failures))
    got, recsys = recsys_phase(dev, failures)
    if failures:
        raise SystemExit("phase 21b, the recsys archetypes failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] = counts.get(name, 0) + v
    log("phase 21 numbers: " + json.dumps(recsys))
    clock.mark("21, the recsys archetypes")

    # the paper's Fig. 16 run: rows 1 and 4 on the example's training path
    got, fig16 = fig16_phase(dev, failures)
    if failures:
        raise SystemExit("phase 22, the Fig. 16 run failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] = counts.get(name, 0) + v
    torch.cuda.empty_cache()
    clock.mark("22, the Fig. 16 run")

    # serving on a mesh (two ranks on the card), the serve_recsys twin, the launcher's
    # smoke at two ranks
    got = mesh_serving_phase(dev, failures)
    close_pool()
    if failures:
        raise SystemExit("phase 23, serving on a mesh failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] = counts.get(name, 0) + v
    torch.cuda.empty_cache()
    clock.mark("23, serving on a mesh")

    # dlrm-mlperf served at full size: rows 1, 2 and 3 at its shapes
    mlperf, got = mlperf_phase(dev, rng, failures)
    if failures:
        raise SystemExit("phase 24, dlrm-mlperf served at full size failed:\n"
                         + "\n".join(failures))
    for name, v in got.items():
        if name != "fused_mlp_routes":
            counts[name] = counts.get(name, 0) + v
    clock.mark("24, dlrm-mlperf served at full size")

    # the rest of the LM family at full width: row 13 on gemma2's, phi3's and qwen3's
    # prefills, MoE and MLA through the port's serving steps
    got, lm_family = lm_family_phase(dev, failures)
    counts["flash_attention"] += got["flash_attention"]
    lm_runs += lm_family
    clock.mark("25-28, gemma2, phi3, qwen3-moe and deepseek-v2 served")

    # dlrm-large served with its tables cut: rows 1, 2 and 3 at its shapes
    large, got = large_phase(dev, rng, failures)
    if failures:
        raise SystemExit("phase 29, dlrm-large served failed:\n" + "\n".join(failures))
    for name, v in got.items():
        if name != "fused_mlp_routes":
            counts[name] = counts.get(name, 0) + v
    clock.mark("29, dlrm-large served")

    # LM training: internlm2-1.8b at full size and its gate at 2 layers, qwen3-moe's MoE
    # backward at full width, the launcher's LM branch
    got, lm_train = lm_train_phase(dev, failures)
    if failures:
        raise SystemExit("phase 30, internlm2-1.8b trained at full size failed:\n"
                         + "\n".join(failures))
    lm_launches = got["split_sgd"]
    log("phase 30 numbers: " + json.dumps(lm_train))
    clock.mark("30, internlm2-1.8b trained at full size")
    gate = lm_gate_phase(dev, failures)
    if failures:
        raise SystemExit("phase 30a, the LM step's gate failed:\n" + "\n".join(failures))
    log("phase 30a numbers: " + json.dumps(gate))
    clock.mark("30a, the LM step against the CPU's")
    got, moe_train = moe_train_phase(dev, failures)
    if failures:
        raise SystemExit("phase 31, qwen3-moe trained failed:\n" + "\n".join(failures))
    lm_launches += got["split_sgd"]
    log("phase 31 numbers: " + json.dumps(moe_train))
    clock.mark("31, qwen3-moe-30b-a3b trained at full width")
    got, lm_launch = lm_launcher_phase(dev, failures)
    if failures:
        raise SystemExit("phase 32, the launcher's LM branch failed:\n" + "\n".join(failures))
    lm_launches += got["split_sgd"]
    counts["split_sgd"] += lm_launches
    log("phase 32 numbers: " + json.dumps(lm_launch))
    clock.mark("32, the launcher's LM branch")

    # the EGNN family: cora, ogb_products with its edges cut, the sampled minibatch on a
    # graph of Reddit's counts, molecules, cora on a (1, 2) mesh of two processes
    egnn = {"launches": 0}
    for tag, name, phase in (("33a", "cora", egnn_cora_phase),
                             ("33b", "ogb_products", egnn_ogb_phase),
                             ("33c", "minibatch_lg", egnn_minibatch_phase),
                             ("33d", "molecule", egnn_molecule_phase),
                             ("33e", "cora on (1, 2)", egnn_mesh_phase)):
        if tag == "33c":  # the pool of 33e and 35 starts once 33b has sized its edges
            open_pool()
        got, nums = phase(dev, failures)
        if failures:
            raise SystemExit(f"phase {tag}, EGNN {name} failed:\n" + "\n".join(failures))
        egnn["launches"] += got
        egnn[tag] = nums
        log(f"phase {tag} numbers: " + json.dumps(nums))
        torch.cuda.empty_cache()
        clock.mark(f"{tag}, EGNN {name}")
    counts["split_sgd"] += egnn["launches"]

    # the dry run: every DLRM, recsys and EGNN cell at rank 0 of the production mesh
    got, dry = dryrun_phase(dev, failures)
    if failures:
        raise SystemExit("phase 34, the dry run failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] += v
    log("phase 34 numbers: " + json.dumps(dry))
    torch.cuda.empty_cache()
    clock.mark("34, the dry run")

    # the LM steps on meshes of two processes on the card, and the launcher at --ranks 2;
    # the dry run's LM cells (34d) step at rank 0 in this process while the ranks run
    dry_lm = {}

    def dry_lm_cells():
        dry_lm["launches"], dry_lm["nums"] = dryrun_lm_phase(dev, failures)
        log("phase 34d numbers: " + json.dumps(dry_lm["nums"]))
    mesh_launches, lm_mesh = lm_mesh_phase(dev, failures, dry_lm_cells)
    close_pool()
    if failures:
        raise SystemExit("phases 34d and 35, the LM steps on a mesh failed:\n"
                         + "\n".join(failures))
    counts["split_sgd"] += dry_lm["launches"]["split_sgd"]
    counts["split_sgd"] += mesh_launches["split_sgd"]["all"]
    counts["flash_attention"] += mesh_launches["flash_attention"]["all"]
    log("phase 35 numbers: " + json.dumps(lm_mesh))
    torch.cuda.empty_cache()
    clock.mark("34d and 35, the LM steps on a mesh")
    log("phase seconds: " + json.dumps(clock.seconds))

    routes = {"embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                                "src/repro/kernels/embedding_bag.py:31"),
              "dot_interaction": ("src/repro_torch/csrc/interaction.cu",
                                  "src/repro/kernels/interaction.py:22"),
              "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                            "src/repro/kernels/fused_mlp.py:22"),
              "embedding_update": ("src/repro_torch/csrc/embedding_update.cuh",
                                   "src/repro/kernels/embedding_update.py:82"),
              "embedding_update_fp32": ("src/repro_torch/csrc/embedding_update.cuh",
                                        "src/repro/kernels/embedding_update.py:114"),
              "split_sgd": ("src/repro_torch/csrc/split_sgd.cu",
                            "src/repro/kernels/split_sgd.py:18"),
              "embedding_update_momentum": ("src/repro_torch/csrc/embedding_update.cuh",
                                            "src/repro/kernels/embedding_update.py:151"),
              "embedding_update_adagrad": ("src/repro_torch/csrc/embedding_update.cuh",
                                           "src/repro/kernels/embedding_update.py:169"),
              "embedding_update_adagrad_rowwise": ("src/repro_torch/csrc/embedding_update.cuh",
                                                   "src/repro/kernels/embedding_update.py:190"),
              "embedding_update_freq": ("src/repro_torch/csrc/embedding_update.cuh",
                                        "src/repro/kernels/embedding_update.py:219"),
              "embedding_update_momentum_bf16": ("src/repro_torch/csrc/embedding_update.cuh",
                                                 "src/repro/kernels/embedding_update.py:243"),
              "embedding_update_adagrad_bf16": ("src/repro_torch/csrc/embedding_update.cuh",
                                                "src/repro/kernels/embedding_update.py:268"),
              "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:27")}
    line = []
    for k in kernels[:2]:
        log(f"{k['name']} by batch (device ms, CUDA graph): "
            + ", ".join(f"B={b} {ms:.4f}" for b, ms in k["by_batch"].items()))
    for tag in ("uniform", "weighted"):
        u = kernels[0][tag]
        log(f"embedding_bag, {tag}: kernel {u['ms']:.4f} ms, library {u['library_ms']:.4f} ms, "
            f"bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['bound_ms'] / u['ms'] * 100:.1f}% "
            "of bound")
    for k in kernels[3:5] + kernels[6:]:
        u, w = k["uniform"], k["weighted"]
        log(f"{k['name']}, uniform indices: kernel {u['ms']:.4f} ms, plain {u['plain_ms']:.1f} ms, "
            f"bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['bound_ms'] / u['ms'] * 100:.1f}% "
            f"of bound; zipf: {k['ms']:.4f} ms, longest run {k['longest']}, serial chain "
            f"{k['chain_ms']:.4f} ms, {k['ms'] / k['chain_ms']:.2f}x it; weighted zipf: "
            f"{w['ms']:.4f} ms, bound {w['bound_ms']:.4f} ms, "
            f"{w['ms'] / w['chain_ms']:.2f}x the chain"
            + ("" if k["library_ms"] is None else
               f"; zipf {k['ms'] / k['library_ms']:.3f}x index_add_ ({k['library_ms']:.4f} ms)"))
    kernels.append(attn_entry)
    for k in kernels:
        src, replaces = routes[k["name"]]
        line.append({"name": k["name"], "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
        if k["name"] == "fused_mlp":  # the serving run's launches by kernel (wgmma or mma.sync)
            line[-1]["route_launches"] = counts["fused_mlp_routes"]
        if "by_batch" in k:  # rows 1 and 2 at every batch the main path runs
            line[-1]["ms_by_batch"] = k["by_batch"]
        if "ms_l2_warm" in k:  # row 4 back to back, its buffers still in the L2
            line[-1]["ms_l2_warm"] = k["ms_l2_warm"]
        if k["name"] in widths:  # rows 1 and 5-12 at the recsys archetypes' widths
            line[-1]["widths"] = widths[k["name"]]
        if k["name"] == "split_sgd":  # row 4 on the LM steps: their launches, the largest leaf
            line[-1]["lm"] = {**lm_train["row4"], "launches": lm_launches}
            line[-1]["max_abs_err"] = max(line[-1]["max_abs_err"], lm_train["row4"]["max_abs_err"])
            # and on the EGNN steps: their launches, one cora step's 18 updates as a graph
            line[-1]["egnn"] = {**egnn["33a"]["row4"], "launches": egnn["launches"]}
            # and on the mesh LM steps: the dry run's LM cells, phase 35's ranks by part
            line[-1]["lm_mesh"] = {"34d": dry_lm["launches"]["split_sgd"],
                                   "35": mesh_launches["split_sgd"]}
            line[-1]["max_abs_err"] = max(line[-1]["max_abs_err"],
                                          egnn["33a"]["row4"]["max_abs_err"])
        if k["name"] in fig16:  # rows 1 and 4 at the Fig. 16 example's shapes
            line[-1]["fig16"] = fig16[k["name"]]
            line[-1]["max_abs_err"] = max(line[-1]["max_abs_err"], fig16[k["name"]]["max_abs_err"])
        for key, entries in (("mlperf", mlperf), ("large", large)):
            for m in entries:  # rows 1, 2 and 3 at dlrm-mlperf's and dlrm-large's shapes
                if m["name"] != k["name"]:
                    continue
                line[-1][key] = {f: m[f] for f in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "by_batch", "uniform", "weighted", "layers") if f in m}
                if "library_embedding_ms" in m:  # row 1 at P 1: F.embedding then a sum
                    line[-1][key].update(library_ms=m["library_embedding_ms"],
                                         library_bag_ms=m["library_ms"])
                line[-1]["max_abs_err"] = max(line[-1]["max_abs_err"], m["max_abs_err"])
        if k["name"] == "flash_attention":  # the LM phases: launches and shapes by model
            line[-1]["models"] = [{f: r[f] for f in ("model", "flash_launches", "flash")
                                   if f in r} for r in lm_runs]
            line[-1]["lm_mesh"] = {"35c": mesh_launches["flash_attention"]["35c"]}
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {lib}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
            f"{k['bound_ms'] / k['ms'] * 100:.1f}% of bound")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for cmd in stop_children():
            print(f"chip_smoke: stopped a process left running: {cmd}", file=sys.stderr)
    sys.exit(rc)
