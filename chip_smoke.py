#!/usr/bin/env python3
"""Drive the PyTorch port's DLRM serving and training paths (one rank, and
the hybrid step and the run loop on meshes of ranks) and its LM serving path
on one CUDA card.

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
13. run loop: dlrm-small (Split-SGD) through ``TrainLoop``: 80 steps from a
    seeded state without a checkpoint, and the quickstart's contract from the
    same state (60 steps, a verified checkpoint every 20, keep 2, prefetch 2,
    a heartbeat; a second loop, built on a state from another seed, restores
    at step 60 and trains on to 80), both over one pool of 20 numpy batches:
    the restore bit for bit the first loop's state with its dense ``hi`` in
    one buffer, the later losses and the final state bit for bit the
    uninterrupted run's; the newest checkpoint corrupted, a fresh manager
    falls back to step 60; the eval step's scores of the restored state in
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
    prefill of 32,768 tokens;
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
    processes sharing the card (``launch.local.run_ranks``, gloo, every
    payload staged through pinned host memory), meshes (1, 2) in row and
    table mode with Split-SGD and in row mode with row-wise Adagrad: each
    rank's first step held to the same two-rank step on the CPU (loss within
    1e-4, the dense shard (and row mode's Split-SGD shard) within 1e-2 of the
    largest update, the sparse update bit for bit), then 5 steps with
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
    17b: the quickstart's contract on (2, 4), eight processes: 80 steps
    without a checkpoint, 60 with a checkpoint every 20 and a restart that
    runs on to 80.  Gates: restored at 60; the losses and the state at 80
    bit for bit the uninterrupted run's; the loss falls (the mean loss over
    the 80 batches trained on, of the final state against the start state:
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
    ``examples/train_dlrm_100m_torch.py`` at its defaults (its loss falls).
    A failure raises ``SystemExit`` and prints no result.

The line before the last two is ``{"kernels": [...]}`` (times in ms, CUDA
events after warm-up, rows 1, 2 and 4 and their library calls as CUDA graphs,
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
served batches and launcher runs, its stage profiles included); then
the card's name and power limit from ``nvidia-smi``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device.  No process it started outlives it: on its way out
it stops multiprocessing's resource tracker and any other child still
running.
"""

from __future__ import annotations

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
N_TRAIN = 20  # staged zipf batches of the training phase (and the run loop's pool)
# the hybrid phase: 16a's timed table-mode steps and row-mode steps held bit for bit
# to the groupless step; 16b's cases on two ranks and their timed steps a case
HYBRID_STEPS, HYBRID_ROW_STEPS = 20, 3
HYBRID_TWO_CASES = (("row", "split_sgd"), ("table", "split_sgd"), ("row", "adagrad_rowwise"))
HYBRID_TWO_STEPS = 5
# the run loop: the quickstart's 60 steps, a checkpoint every 20, a restart, on to 80
RUN_STEPS, RUN_RESTART, RUN_CKPT_EVERY = 80, 60, 20
# the run loop on a mesh (phase 17): 17a's loops of dlrm-small at full width on (1, 2)
# (10 steps, a checkpoint at 5); 17b's quickstart contract on (2, 4) (60 steps, a
# checkpoint every 20, a restart, on to 80); 17c's elastic run (10 steps on (2, 4),
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
# first is the main path's shape (internlm2-1.8b's prefill of 4 x 4096 tokens), gemma2
# reaches the rest of the kernel's options (softcap 50, window 4096; its global layer
# also without the softcap, to price it), and the last case's first 400 queries see
# no key
ATTN_CASES = (("internlm2 prefill", 4, 16, 8, 4096, 4096, True, 0, 0.0),
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


def log(*a):
    print(*a, flush=True)


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


def stage_or_fail(name, W, idx, offsets, rows, wgt, failures) -> None:
    """The fused bag stage (offset add, bag, bf16 round in one launch)
    against the kernel's own fp32 bag of the global ids rounded to bf16, bit
    for bit, and against the plain composition: each sum within one bf16 ulp
    of the plain one, or, where the sum cancels to near zero (one bf16 ulp
    of it is then below the fp32 sums' own rounding), within the bag's fp32
    atol; the share of sums that differ printed."""
    import torch
    from repro_torch.kernels import ops, ref
    got = ops.embedding_bag_stage(W, idx, offsets, rows, wgt)
    own = ops.embedding_bag(W, idx + offsets[None, :, None], rows, wgt).to(torch.bfloat16).float()
    want = ref.embedding_bag_stage(W, idx, offsets, rows, wgt)
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


def make_requests(cfg, n: int, rng) -> list[dict]:
    from repro_torch.data.synthetic import zipf_indices
    idx = np.stack([zipf_indices(rng, m, (n, cfg.pooling), ALPHA) for m in cfg.table_rows], axis=1)
    dense = rng.standard_normal((n, cfg.num_dense)).astype(np.float32)
    return [{"idx": idx[i].astype(np.int32), "dense_x": dense[i]} for i in range(n)]


def plain_logits(cfg, snap, batch, offsets, bag: bool = True):
    """The serving forward before its sigmoid, with every kernel replaced by
    its plain version (``bag=False``: the bag outputs zeroed)."""
    import torch
    from repro_torch.kernels import ref
    rows = snap["emb_w"].shape[0]
    emb = ref.embedding_bag(snap["emb_w"], batch["idx"] + offsets[None, :, None], rows)
    emb = emb.to(torch.bfloat16).float()
    if not bag:
        emb = torch.zeros_like(emb)

    def mlp(params, h, final_act):
        n = len(params["w"])
        for i, (w, b) in enumerate(zip(params["w"], params["b"])):
            last = i == n - 1
            h = ref.fused_mlp_layer(h, w, b, "relu" if (final_act or not last) else "none",
                                    torch.float32 if last else torch.bfloat16)
        return h

    bot = mlp(snap["dense_hi"]["bot"], batch["dense_x"], True)
    z = ref.dot_interaction(bot, emb).to(torch.bfloat16)
    return mlp(snap["dense_hi"]["top"], z, False)[:, 0]


def kernel_phase(cfg, snap, offsets, dev, rng, failures) -> list[dict]:
    """Each kernel against its plain version at B = cfg.batch (timed) and at
    every bucket the main path serves; returns the kernel entries of the JSON
    line (the bag's entry also holds its uniform-index times)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.interaction import tril_indices
    from repro_torch.kernels import fused_mlp, ops, ref

    W = snap["emb_w"]
    rows, E = W.shape
    S, P = len(cfg.table_rows), cfg.pooling
    entries = {}
    for B in (cfg.batch, *BUCKETS):
        reqs = make_requests(cfg, B, rng)
        idx = torch.from_numpy(np.stack([r["idx"] for r in reqs])).to(dev)
        dense_x = torch.from_numpy(np.stack([r["dense_x"] for r in reqs])).to(dev).to(torch.bfloat16)
        gidx = idx + offsets[None, :, None]
        timed = B == cfg.batch
        log(f"kernels at B={B}:")

        # embedding_bag, and the bag stage that fuses the offset add and the round
        got = ops.embedding_bag(W, gidx, rows)
        want = ref.embedding_bag(W, gidx, rows)
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
                     plain_ms=time_ms(lambda: ref.embedding_bag(W, gidx, rows)),
                     library_ms=graph_ms(lambda: F.embedding_bag(flat, W, mode="sum")),
                     bound_ms=bms, bound_by=by)
            log(f"  embedding_bag: {unique} distinct rows of {gidx.numel()} lookups; "
                f"{nbytes / 1e6:.1f} MB needed ({gidx.numel() * (E * W.element_size() + 4) / 1e6 + B * S * E * 4 / 1e6:.1f} MB "
                f"if no row repeated)")
            # the same number of lookups, uniform over each table: nearly
            # every row distinct, so the rows come from HBM and not from L2
            uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                             axis=1).astype(np.int32)).to(dev) + offsets[None, :, None]
            err = close_or_fail(f"embedding_bag, uniform indices [{B},{S},{P}]",
                                ops.embedding_bag(W, uidx, rows), ref.embedding_bag(W, uidx, rows),
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
            e["weighted"] = weighted_bag(W, idx, offsets, rows, rng, unique, failures)
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
                err = close_or_fail(f"fused_mlp {tag}{i} [{M}x{K}]@[{K}x{N}] {act} -> {out_dtype} "
                                    f"({path})", k_out, p_out, *tol, failures)
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
                    t = dict(ms=time_ms(lambda: ops.fused_mlp_layer(h, w, b, act, out_dtype)),
                             plain_ms=time_ms(lambda: ref.fused_mlp_layer(h, w, b, act, out_dtype)),
                             library_ms=time_ms(lambda: lib(torch.addmm(b.to(h.dtype), h, w))),
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
        err = close_or_fail(f"dot_interaction [{B},{E}] + [{B},{S},{E}]", got, want,
                            *KERNEL_TOL["dot_interaction"], failures)
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


def weighted_bag(W, idx, offsets, rows, rng, unique, failures) -> dict:
    """The weighted bag at the zipf indices ``idx`` [B, S, P] (table-local;
    ``offsets`` per slot), weights U[0.5, 1.5) from ``rng``: against its
    plain version, all-ones weights bit for bit the unweighted kernel's
    output, the weighted bag stage against its plain composition, timed
    against the plain version and ``F.embedding_bag(per_sample_weights=...)``
    (which wants the weights in the table's dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gidx = idx + offsets[None, :, None]
    B, S, P = gidx.shape
    E = W.shape[1]
    wgt = torch.from_numpy(rng.uniform(0.5, 1.5, gidx.shape).astype(np.float32)).to(gidx.device)
    err = close_or_fail(f"embedding_bag, weighted [{B},{S},{P}]", ops.embedding_bag(W, gidx, rows, wgt),
                        ref.embedding_bag(W, gidx, rows, wgt), *KERNEL_TOL["embedding_bag"], failures)
    bitwise_or_fail("embedding_bag, all-ones weights vs unweighted",
                    ops.embedding_bag(W, gidx, rows, torch.ones_like(wgt)),
                    ops.embedding_bag(W, gidx, rows), failures)
    stage_or_fail(f"bag stage, weighted [{B},{S},{P}]", W, idx, offsets, rows, wgt, failures)
    # the distinct rows, the indices and the weights read once, the sums written once
    nbytes = unique * E * W.element_size() + gidx.numel() * 8 + B * S * E * 4
    bms, by = bound_ms(nbytes, gidx.numel() * E * 2, FP32_FLOPS)
    flat, wflat = gidx.view(B * S, P), wgt.view(B * S, P).to(W.dtype)
    t = dict(max_abs_err=err, ms=graph_ms(lambda: ops.embedding_bag(W, gidx, rows, wgt)),
             plain_ms=time_ms(lambda: ref.embedding_bag(W, gidx, rows, wgt)),
             library_ms=graph_ms(lambda: F.embedding_bag(flat, W, mode="sum",
                                                         per_sample_weights=wflat)),
             bound_ms=bms, bound_by=by)
    log(f"  embedding_bag, weighted: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"F.embedding_bag(per_sample_weights) {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return t


def serving_phase(cfg, reg, offsets, dev, reqs, failures) -> dict:
    """The main path: the requests through the server, in bursts that each
    wait for the last to be answered (BURSTS), so that every bucket serves.
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
    if counts["fused_mlp"] != 8 * n_batches or counts["embedding_bag"] != n_batches \
            or counts["dot_interaction"] != n_batches \
            or any(v for k, v in counts.items() if k not in SERVING_KERNELS):
        failures.append(f"launches {counts} do not match {n_batches} batches (fused_mlp 8 each)")
    # dlrm-small's layers by route: every layer whose K and N a tensor map takes on wgmma
    layers = [(k, n) for sizes in (cfg.bottom_sizes, cfg.top_sizes)
              for k, n in zip(sizes, sizes[1:])]
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
    want, no_bag = [], []
    for i in range(0, N_REQUESTS, BUCKETS[-1]):
        batch = pad(reqs[i:i + BUCKETS[-1]], BUCKETS[-1])
        want.append(plain_logits(cfg, snap, batch, offsets).cpu())
        no_bag.append(plain_logits(cfg, snap, batch, offsets, bag=False).cpu())
    want, no_bag = torch.cat(want)[:N_REQUESTS].double(), torch.cat(no_bag)[:N_REQUESTS].double()
    got = torch.logit(torch.from_numpy(scores).double())
    close_or_fail(f"served logits vs plain forward ({N_REQUESTS})", got, want, 0.0, LOGIT_TOL,
                  failures)
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
    gated on (``graph_nodes`` counts exactly)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                        state["emb"][k].cpu(), v, failures)
    parts = [("dense weights", dense_master(state["dense"]).cpu(), dense_master(ref_state["dense"]),
              dense_master(before["dense"]))]
    got_w, want_w, old_w = master(state["emb"]).cpu(), master(ref_state["emb"]), master(before["emb"])
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
            f"latest_valid_step {fallback}, restored step {at} in {drill_s:.2f} s (two verifies "
            f"and a load), bit for bit the first loop's state: {back_same}")
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


def lm_serving_phase(dev, failures) -> dict:
    """internlm2-1.8b at full size (bf16 weights drawn on the card from a
    seeded generator), ``attn_impl="pallas"``: LM_BATCH prompts of LM_PROMPT
    tokens through ``make_prefill_step`` (time to first token, exactly one
    kernel launch a layer), LM_DECODE greedy steps through
    ``make_decode_step`` on the cache grown to LM_PROMPT + LM_DECODE (no
    kernel launch), every logit finite; then the prefill's logits and cache
    held to the same prefill with the kernel's plain version in its place,
    and again with two faults planted in it, which must fail; the first decode
    step to a prefill of LM_PROMPT + 1 tokens, prefill tokens/s, decode ms a
    step and the device's busy time (torch.profiler), and one prefill of
    LM_LONG tokens.  Returns the launch counts of the main path's run."""
    import contextlib
    import torch
    from repro_torch import weights
    from repro_torch.configs.internlm2_1_8b import config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention, lm_steps

    cfg = dataclasses.replace(config(), attn_impl="pallas")
    B, L, N = LM_BATCH, LM_PROMPT, LM_DECODE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = weights.init_lm_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel() for v in tree.values())

    nparams = count(params)
    log(f"{cfg.name}: {nparams} parameters, {nparams * 2 / 1e9:.3f} GB bf16, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    if nparams != cfg.param_count() + cfg.d_model:   # param_count leaves out the final norm
        failures.append(f"{nparams} parameters, the config counts {cfg.param_count()} + "
                        f"{cfg.d_model}")
    prefill, _ = lm_steps.make_prefill_step(cfg, B, L, device=dev)
    decode, (_, cstructs, _, _) = lm_steps.make_decode_step(cfg, B, L + N, device=dev)
    prefill(params, toks)  # warm-up: cuBLAS's plans for these shapes
    torch.cuda.synchronize()

    # the main path: prefill, then greedy decode, the counts read after both
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    nxt = logits.argmax(-1).to(torch.int32)
    first = nxt.cpu()
    ttft = time.perf_counter() - t0
    grown = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k, (shape, dtype) in cstructs.items()}
    for k in grown:
        grown[k][..., :L, :] = cache[k]
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    step_logits = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(N):
        out, grown = decode(params, grown, nxt, pos)
        step_logits.append(out if i == 0 else out.isfinite().all())
        nxt = out.argmax(-1).to(torch.int32)
        pos = pos + 1
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) / N * 1e3
    counts = ops.launches()
    log(f"prefill {B} x {L} tokens: time to first token {ttft * 1e3:.2f} ms "
        f"({B * L / ttft:.0f} tokens/s); {N} greedy decode steps: {decode_ms:.3f} ms a step "
        f"({B / decode_ms * 1e3:.1f} tokens/s); launches {counts}")
    want = {**{k: 0 for k in counts}, "flash_attention": cfg.n_layers}
    if counts != want:
        failures.append(f"LM serving launches {counts}, want {want} (one a layer in the prefill)")
    finite = bool(logits.isfinite().all()) and all(bool(f) for f in step_logits[1:]) \
        and bool(step_logits[0].isfinite().all())
    if tuple(logits.shape) != (B, cfg.vocab) or not finite:
        failures.append(f"LM logits: shape {tuple(logits.shape)}, all finite {finite}")
    log(f"prefill logits: |max| {float(logits.abs().max()):.4f}, std {float(logits.std()):.4f}; "
        f"first tokens {first.tolist()}, last tokens {nxt.tolist()}")

    # the prefill with the kernel's plain version in its place
    @contextlib.contextmanager
    def attention_as(fn):
        kernel = attention.ops.flash_attention
        attention.ops.flash_attention = fn
        try:
            yield
        finally:
            attention.ops.flash_attention = kernel

    def cache_gap(a, b):
        return max(float((a[kv][i].float() - b[kv][i].float()).abs().max())
                   for kv in ("k", "v") for i in range(cfg.n_layers))

    with attention_as(ref.flash_attention):
        p_logits, p_cache = prefill(params, toks)
    close_or_fail(f"prefill logits, kernel against plain attention [{B},{cfg.vocab}]", logits,
                  p_logits, 0.0, LM_TOL, failures)
    gap = cache_gap(cache, p_cache)
    log(f"  prefill k and v cache, kernel against plain attention [{cfg.n_layers},{B},"
        f"{cfg.n_kv_heads},{L},{cfg.d_head}]: max_abs_err {gap:.3e} (atol {LM_TOL:g})")
    if not gap <= LM_TOL:
        failures.append(f"prefill cache: max_abs_err {gap:.3e} past {LM_TOL:g}")

    # the gates' power: two faults planted in the plain attention must fail both
    def wrong_kv_head(q, k, v, **kw):   # head h reads KV head h % Hkv, not h // (H / Hkv)
        idx = torch.arange(q.shape[1], device=q.device) % k.shape[1]
        return ref.flash_attention(q, k[:, idx], v[:, idx], **kw)

    def diagonal_masked(q, k, v, **kw):  # query at p sees keys < p, not <= p
        return ref.flash_attention(q, k[:, :, :-1], v[:, :, :-1], **kw)

    for name, fault in (("KV head h % Hkv", wrong_kv_head), ("diagonal masked", diagonal_masked)):
        with attention_as(fault):
            f_logits, f_cache = prefill(params, toks)
        lgap, cgap = float((f_logits - logits).abs().max()), cache_gap(f_cache, cache)
        log(f"  planted fault, {name}: logits max_abs_err {lgap:.3e}, cache {cgap:.3e}")
        if not (lgap > LM_TOL and cgap > LM_TOL):
            failures.append(f"planted fault {name} passes the LM gate ({lgap:.3e}, {cgap:.3e})")
        del f_cache
    chunked, _ = lm_steps.make_prefill_step(dataclasses.replace(cfg, attn_impl="chunked"), B, L,
                                            device=dev)
    c_logits, _ = chunked(params, toks)
    log(f"  top-1 tokens equal in {int((logits.argmax(-1) == p_logits.argmax(-1)).sum())} of {B}; "
        f"last layer's v cache max_abs_err "
        f"{float((cache['v'][-1].float() - p_cache['v'][-1].float()).abs().max()):.3e}; the "
        f"yardstick, plain against chunked attention: max_abs_err "
        f"{float((p_logits - c_logits).abs().max()):.3e}")
    del p_cache, cache
    # the first decode step against the prefill of the prompt and its first token
    full, _ = lm_steps.make_prefill_step(cfg, B, L + 1, device=dev)
    f_logits, _ = full(params, torch.cat([toks, first.to(dev)[:, None]], dim=1))
    close_or_fail(f"first decode step against a prefill of {L + 1} tokens", step_logits[0],
                  f_logits, 0.0, LM_TOL, failures)
    log(f"  top-1 tokens equal in {int((step_logits[0].argmax(-1) == f_logits.argmax(-1)).sum())} "
        f"of {B}")

    # steady times under torch.profiler: wall clock (ending in a sync) and device busy time
    wall_ms, busy_ms, top = device_busy_ms(lambda: prefill(params, toks), 3)
    log(f"prefill under torch.profiler: {wall_ms:.3f} ms wall ({B * L / wall_ms * 1e3:.0f} "
        f"tokens/s), device busy {busy_ms:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); "
        "top kernels: " + top_kernels(top[:6]))
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    wall_ms, busy_ms, top = device_busy_ms(lambda: decode(params, grown, nxt, pos), 8)
    log(f"decode step under torch.profiler: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: "
        + top_kernels(top[:6]))
    del grown
    torch.cuda.empty_cache()

    # the repo's prefill length, one prompt: the kernel's causal skip at length
    long_toks = torch.randint(0, cfg.vocab, (1, LM_LONG), generator=gen, device=dev,
                              dtype=torch.int32)
    long_prefill, _ = lm_steps.make_prefill_step(cfg, 1, LM_LONG, device=dev)
    long_prefill(params, long_toks)
    torch.cuda.synchronize()
    before = ops.flash_attention.launches
    t0 = time.perf_counter()
    l_logits, _ = long_prefill(params, long_toks)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) * 1e3
    if not bool(l_logits.isfinite().all()) or ops.flash_attention.launches - before != cfg.n_layers:
        failures.append(f"the {LM_LONG}-token prefill: finite {bool(l_logits.isfinite().all())}, "
                        f"{ops.flash_attention.launches - before} launches")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn((1, H, LM_LONG, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, Hkv, LM_LONG, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    k_ms = time_ms(lambda: ops.flash_attention(q, k, v), iters=5, warmup=1)
    pairs = H * visible_pairs(LM_LONG, LM_LONG, True, 0)
    bms, by = bound_ms(2 * (2 * H * LM_LONG * D + 2 * Hkv * LM_LONG * D), 4.0 * pairs * D,
                       BF16_TENSOR_FLOPS)
    log(f"prefill 1 x {LM_LONG} tokens: {long_ms:.2f} ms ({LM_LONG / long_ms * 1e3:.0f} tokens/s); "
        f"the kernel alone at [1,{H},{LM_LONG},{D}] causal: {k_ms:.4f} ms a layer, bound "
        f"{bms:.4f} ms ({by}), {bms / k_ms * 100:.1f}% of bound, "
        f"{4.0 * pairs * D / k_ms / 1e9:.1f} TFLOP/s")
    return counts


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
                        state["emb"][k].cpu(), v, failures)
    n, r = mesh.size, mesh.rank
    g_cpu = cpu_mesh.group(cpu_mesh.axis_names)
    table = cfg.emb_mode == "table"
    for part, got, want, old, held in (
            ("embedding shard", master(state["emb"]).cpu(), master(ref_state["emb"]),
             master(before["emb"]), not opt.state_keys),
            ("dense shard", dense_master(state["dense"], n, r).cpu(),
             dense_master(ref_state["dense"], n, r), dense_master(before["dense"], n, r), True)):
        # the largest update of the whole state, over every rank's shard
        upd = float(comm.all_gather((want - old).abs().max()[None], g_cpu).max())
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
    """Phase 16b: two processes on the one card (``launch.local.run_ranks``,
    gloo), meshes (1, 2) in row and table mode with Split-SGD and in row
    mode with row-wise Adagrad; any child's failure fails the run.  Prints
    per case the collectives' bytes a step and the step's host-clock ms with
    the staging share apart.  Returns the launch counts of both ranks' timed
    steps, summed."""
    from repro_torch.launch.local import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(hybrid_rank, 2, (HYBRID_TWO_CASES,), backend="gloo", timeout_s=900)
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
    from repro_torch.launch.local import run_ranks
    from repro_torch.launch.mesh import Mesh, make_mesh

    ckdir = ROOT / "build" / "loop_mesh"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_loop_rank, 2, (str(ckdir),), backend="gloo", timeout_s=900)
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
                ("embedding store", master(state["emb"]).cpu(), master(ref_state["emb"]),
                 master(before["emb"])),
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
            ("embedding shard", master(state["emb"]).cpu(), master(ref_state["emb"]),
             master(before["emb"])),
            ("dense shard", dense_master(state["dense"], 2, rank).cpu(),
             dense_master(ref_state["dense"], 2, rank), dense_master(before["dense"], 2, rank))):
        upd = float(comm.all_gather((want - old).abs().max()[None], g_cpu).max())
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
    (``launch.local.run_ranks``, gloo); any rank's failure fails the run.
    Returns both ranks' launches of the ring steps."""
    from repro_torch.launch.local import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(ring_rank, 2, (), backend="gloo", timeout_s=600)
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
                        ("embedding store", master(hot["emb"]).cpu(), master(cpu_state["emb"]),
                         master(start["emb"]).cpu(), TABLE_STORE_TOL["update"]),
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
    stage profile).  Then one subprocess ``python -m repro_torch.launch.train
    --arch dlrm-smoke --steps 5`` and one ``python
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

    def sub(args, timeout=600) -> str:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=timeout)
        log(f"20: `{' '.join(args[:4])} ...` exit {proc.returncode} in "
            f"{time.perf_counter() - t:.1f} s; its last lines:\n    "
            + "\n    ".join(proc.stdout.strip().splitlines()[-3:]))
        if proc.returncode != 0:
            failures.append(f"20: {' '.join(args)} exited {proc.returncode}:\n"
                            + proc.stdout[-2000:] + proc.stderr[-4000:])
        return proc.stdout

    try:
        ds, tr, ck = root / "ds", root / "trace", root / "ckpt"
        sub(["-m", "repro_torch.data", "synthetic", "--out", str(ds), "--tables",
             ",".join(["200000"] * 8), "--pooling", "20", "--num-dense", "64", "--num-samples",
             "16384", "--samples-per-shard", "4096", "--alpha", str(ALPHA)])
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
        summary = sub(["-m", "repro_torch.telemetry", "summarize", str(tr / "trace.json")])
        if "track: pipeline_stages" not in summary or "train/step" not in summary:
            failures.append("20b: the trace summary lacks the stage profile or the steps")
        smoke = sub(["-m", "repro_torch.launch.train", "--arch", "dlrm-smoke", "--steps", "5"])
        if "[train] done: first loss" not in smoke:
            failures.append("20b: the module entry did not finish its run")
        example = sub(["examples/train_dlrm_100m_torch.py"])
        if "mean loss first-10" not in example:
            failures.append("20c: the 100M example did not report its losses")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts


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
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"peaks for the bounds (H100 SXM data sheet, at 700 W): {HBM_BYTES_PER_S / 1e12} TB/s, "
        f"{BF16_TENSOR_FLOPS / 1e12} TFLOP/s bf16 tensor, {FP32_FLOPS / 1e12} TFLOP/s fp32")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.build_log)} sources")
    for stem, rec in build.build_log.items():
        info = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
        log(f"  {stem}: nvcc {rec['seconds']:.1f} s; " + " | ".join(info))
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
    if failures:
        raise SystemExit("serving phase failed:\n" + "\n".join(failures))
    breakdown_phase(cfg, reg, reqs, dev)

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

    # the run loop: dlrm-small trains, checkpoints, restarts and scores through TrainLoop
    loop_counts = run_loop_phase(t_cfg, dev, bare_rate, failures)
    if failures:
        raise SystemExit("run loop phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd"):
        counts[name] += loop_counts[name]

    # LM serving: the flash-attention kernel, then internlm2-1.8b's prefill and decode
    attn_entry = attention_kernel_phase(dev, failures)
    if failures:
        raise SystemExit("attention kernel phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    lm_counts = lm_serving_phase(dev, failures)
    if failures:
        raise SystemExit("LM serving phase failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    counts["flash_attention"] = lm_counts["flash_attention"]

    # the hybrid step: table mode on one rank over NCCL, then two ranks on the one card
    h_batches = stage_batches(t_cfg, N_TRAIN, dev)
    h_one, fp32_wire = hybrid_one_rank_phase(dev, h_batches, failures)
    if failures:
        raise SystemExit("hybrid phase (16a, one rank) failed:\n" + "\n".join(failures))
    del h_batches
    torch.cuda.empty_cache()
    h_two = hybrid_two_rank_phase(failures)
    if failures:
        raise SystemExit("hybrid phase (16b, two ranks) failed:\n" + "\n".join(failures))
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd",
                 "embedding_update_adagrad_rowwise"):
        counts[name] += h_one[name] + h_two.get(name, 0)

    # the run loop on a mesh: dlrm-small on (1, 2), then the quickstart's contract on
    # (2, 4) and the elastic restart from (2, 4) to (1, 4), ranks sharing the card
    m_counts = mesh_loop_phase(dev, failures)
    if failures:
        raise SystemExit("run loop on a mesh (17a) failed:\n" + "\n".join(failures))
    torch.cuda.empty_cache()
    q_counts = quickstart_mesh_phase(failures)
    if failures:
        raise SystemExit("quickstart and elastic restart on a mesh (17b, 17c) failed:\n"
                         + "\n".join(failures))
    for name in ("embedding_bag", "dot_interaction", "embedding_update", "split_sgd"):
        counts[name] += m_counts.get(name, 0) + q_counts.get(name, 0)
    torch.cuda.empty_cache()

    # the rest of the step's exchange surface: the host pre-sort, the bf16 and bf16_sr
    # wires, microbatches and the ring index exchange
    t18 = time.perf_counter()
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
    log(f"phase 18: {time.perf_counter() - t18:.1f} s; the whole run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # the hot-row cache, the step metrics and their drain, the stage profile
    t19 = time.perf_counter()
    c_batches = stage_batches(t_cfg, N_TRAIN + 1, dev)
    c_counts = cache_phase(dev, c_batches[:N_TRAIN], c_batches[N_TRAIN], failures)
    del c_batches
    gate("19, the hot-row cache and the step metrics", c_counts)
    log(f"phase 19: {time.perf_counter() - t19:.1f} s; the whole run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # packed-shard ingestion, train-to-serve publishing and the launcher
    t20 = time.perf_counter()
    gate("20a, ingestion and publishing", ingest_phase(dev, failures))
    got = launcher_phase(dev, failures)
    if failures:
        raise SystemExit("phase 20b/20c, the launcher failed:\n" + "\n".join(failures))
    for name, v in got.items():
        counts[name] = counts.get(name, 0) + v
    log(f"phase 20: {time.perf_counter() - t20:.1f} s; the whole run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    routes = {"embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                                "src/repro/kernels/embedding_bag.py:31"),
              "dot_interaction": ("src/repro_torch/csrc/interaction.cu",
                                  "src/repro/kernels/interaction.py:22"),
              "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                            "src/repro/kernels/fused_mlp.py:22"),
              "embedding_update": ("src/repro_torch/csrc/embedding_update.cu",
                                   "src/repro/kernels/embedding_update.py:82"),
              "embedding_update_fp32": ("src/repro_torch/csrc/embedding_update.cu",
                                        "src/repro/kernels/embedding_update.py:114"),
              "split_sgd": ("src/repro_torch/csrc/split_sgd.cu",
                            "src/repro/kernels/split_sgd.py:18"),
              "embedding_update_momentum": ("src/repro_torch/csrc/embedding_update.cu",
                                            "src/repro/kernels/embedding_update.py:151"),
              "embedding_update_adagrad": ("src/repro_torch/csrc/embedding_update.cu",
                                           "src/repro/kernels/embedding_update.py:169"),
              "embedding_update_adagrad_rowwise": ("src/repro_torch/csrc/embedding_update.cu",
                                                   "src/repro/kernels/embedding_update.py:190"),
              "embedding_update_freq": ("src/repro_torch/csrc/embedding_update.cu",
                                        "src/repro/kernels/embedding_update.py:219"),
              "embedding_update_momentum_bf16": ("src/repro_torch/csrc/embedding_update.cu",
                                                 "src/repro/kernels/embedding_update.py:243"),
              "embedding_update_adagrad_bf16": ("src/repro_torch/csrc/embedding_update.cu",
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
