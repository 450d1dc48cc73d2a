#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repo, one card

Phases, one JSON line each (any failed check raises and the exit code is
not 0):

1. device  — the card (nvidia-smi's name and power limit), torch and CUDA.
2. build   — nvcc builds the port's kernels from `src/repro_torch/kernels/
             csrc/` (one nvcc per source, all started together), on a
             thread of its own while phase 3 synthesizes the data.
3. data    — the `synth_192d` spec at 1,000,000 rows and 192 dimensions,
             opened as `FilteredIndex(ds)` on the card.
4. kernels — each kernel against its plain PyTorch version on the card:
             bit-identical on an integer grid with forced ties, within the
             stated fp32 summation-order tolerance on random floats at the
             exact-search path's shapes, exact for selectivity (word widths
             1, 7, 13, 16, 32 and 63, the dataset's 1M rows among them);
             the fvamana graph built on the card against the numpy build
             on integer-grid sets, bit-identical; then timed (CUDA events,
             warm, L2 flushed) on the path's own inputs.
5. path    — the port's main path through its entry points: (a) exact
             search `fx.search(batch, "prefilter")` for each predicate,
             held against numpy ground truth; (b) the offline stage: every
             build of the five router candidates (labelnav, postfilter,
             sieve, ivf_gamma, fvamana; the fvamana graph built on the
             card), one line each with its seconds and peak device memory,
             then their table-B rows via `bench.run_method`; (c) routed
             serving, `RouterService(fx, router, t=0.9).search` and
             `search_chunked`, with the five-method router artifact in
             `src/repro_torch/assets/router_all/`: the decisions and
             recall@10 of each predicate; (d) the kernels' launch counts,
             set to 0 just before (a) and read just after (c). The
             sharded path, the queue, the live phase and the sharded
             live phase route with the same router and table rows.
6. profile — one pass of the exact and the routed path under
             torch.profiler; then each kernel timed on the path's inputs.
7. slice 2 — the sharded path's kernels against their plain versions
             (`merge_topk` and `masked_topk_blocks` bit-identical on tie
             grids, bf16 `masked_topk` too, and both held to summation
             order at 1M × 192; `merge_topk`'s regimes bit-identical on
             unordered lists of S = 1-3 at K = 416, 1,016, 4,096 and
             60,000, with the staged read's holes, NaN, ±0.0 and ties at
             the k-th place, all slots tied, k = 1, 10, 128, 129, 1,016
             and past S·K, and sorted lists with and without the scans'
             promise, past shared memory too, `check_merge_regimes`);
             then, each with the launch counts set to 0 just before and
             read just after: (a) the sharded path,
             `ShardedFilteredIndex(ds, 4)` on the card, its exact search
             bit-identical to the single index and
             `ShardedRouterService.search` routing as `RouterService`
             does; (b) `AsyncBatchQueue` over the sharded service, fed
             single queries from 8 threads, answering as the batched
             searches do; (c) `ops.masked_topk_multiblock` equal to
             `ops.masked_topk`. Then profiles and times of these paths
             and kernels.
8. live    — the live slice: `fused_live` (both variants) and the
             k > 128 masked top-k against their plain versions (bit-
             identical on grids, and held to summation order on the live
             path's inputs); then `LiveFilteredIndex(ds, delta_chunk=512)`
             on the card: 32,768 upserts (base rows picked by a seeded
             generator, + 0.01, with their bitmaps), 1,000 base and 500
             delta deletes, and the reference answers (the exact batches
             read with the chunk pruner off, recall truths, the queue's
             batched answers); then, with the launch counts set to 0 just
             before and read just after, the three exact batches fused
             with the chunk pruner (bit-identical to the unpruned read,
             the first GT_QUERIES against a host exact answer over the
             live rows), routed search through `RouterService` (the five
             candidates' indexes built on the live base first) and single
             queries through `AsyncBatchQueue` over the live handle; the
             staged read, counted on its own and bit-identical to the
             fused; a snapshot read across a further write, and
             `compact()` (the fvamana graph and the IVF lists grafted,
             sieve rebuilt, each graft or build timed; the compacted
             index equal to a fresh `FilteredIndex` over its dataset,
             `last_remap` translating ids). Then profiles and times of the
             live path and kernels; `merge_topk` held bit for bit to its
             plain version and timed beside `torch.topk` on its kinds of
             input: the staged read's [2, 256, KK] lists, the multi-block
             entry point's [NB, 256, 10] block lists, the sharded path's
             [4, 256, 10] shard lists, the folds inside `masked_topk` on
             the first 64-query chunk (at the batch's k, and at k = 32 and
             128, past shared memory, where the scans' promise that the
             lists are sorted also times the workspace select without it)
             and inside `fused_live` on the live read's inputs
             (`live.merge_topk.yardstick`).
9. any k   — slice 4: the select of the k > 128 paths, `merge_topk`,
             `fused_live` and `masked_topk_blocks` past k = 128 and the
             register-blocked tile scan (odd and wide D, bf16, W = 1 and
             8, ragged query groups) against their plain versions, bit-
             identical on grids; then, with the launch counts set to 0
             just before and read just after, k = 200 (a reranking stage's
             candidate count) on the three exact batches through
             `ShardedFilteredIndex(ds, 4).search` (bit-identical to the
             single index), `LiveFilteredIndex.search` fused and staged
             (bit-identical to each other, the first GT_QUERIES against the
             host exact answer) and `ops.masked_topk_multiblock` (equal to
             `ops.masked_topk`, whose answers are made before the counts
             are set to 0). `masked_topk_large` and `masked_topk_blocks`
             are held to their plain versions at k = 200 on the paths'
             inputs (phases 7 and 8) and timed at k = 200 too. PERF.md's
             earlier times are printed on a line of their own, labelled
             as copied.
10. sharded live — `ShardedLiveIndex(ds, 4, delta_chunk=512)` on the
             card with phase 8's writes, and the reference answers first
             (the single live handle's fused answers and routed decisions
             over the same writes, the host exact answers, the queue's
             batched answers, every candidate's index built on each
             shard); then, with the launch counts set to 0 just before and
             read just after: (a) exact search of each predicate, ids and
             distance bits identical to the single live handle's fused
             read, the first GT_QUERIES against the host exact answer;
             (b) `ShardedRouterService` routing as `RouterService` over
             the single live handle, with recall@10; (c) `AsyncBatchQueue`
             over it, 300 single queries from 8 threads, answering as the
             batched calls do. Then a snapshot read across a further
             write, and `compact()` (a global rebuild; each shard's
             indexes rebuilt and timed; the compacted handle bit-identical
             to a `ShardedFilteredIndex(new_ds, 4)`, `last_remap`
             translating ids), a profiled pass of (a) and (b), and the
             path's kernels held to their plain versions on the phase's
             own inputs (`merge_topk` bit for bit on the [4, 256, 10]
             shard candidates; `fused_live` on shard 0's read; shard 0's
             base overfetch, its first 64-query chunk at its own KB,
             through `masked_topk_large` past k = 128), then `merge_topk`
             and `fused_live` timed there.
11. store  — durable storage, in a directory under `build/` removed at
             the end (its bytes printed): (a) a `LiveFilteredIndex(ds,
             delta_chunk=512)` on the card adopting phase 5's five
             candidates' indexes (`adopt_index`, nothing built twice),
             `IndexStore.create` linking `router_all`; phase 8's writes
             through the store's handle, logged with `sync_every=1`: the
             exact reads after the upserts (A) and after the deletes (B),
             B bit-identical to phase 8's fused answers, routed with phase
             8's decisions and answers; `close()` and `IndexStore.open` (the exact and
             routed reads bit-identical, the same decisions, 0 method
             builds under `method_seconds`); the WAL cut mid-way through
             its last record (the deletes) and reopened (truncated to the
             upserts' record, the reads equal A, their `fused_live` and
             base top-k held to the plain versions), the deletes
             re-issued;
             `checkpoint()`, close and open (only the checkpoint's seeded
             records replayed, the 64 delta-chunk indexes adopted, none
             built, reads equal B); a byte inside the WAL's first record
             damaged, and open refused the mid-log corruption without
             truncating; a byte of a linked router copy's `table.json`
             changed, and open refused. (b)
             `IndexStore.create` over `ShardedLiveIndex(ds, 4)` with the
             IVF pair built on each shard; the same writes, a
             `compact_async()` barrier logged between the upserts and the
             deletes (the deletes race the compaction, before its swap);
             close and open (the replay re-runs the compaction: the IVF
             pair rebuilt on the 4 new shards and nothing else, reads
             bit-identical to the handle's before the close, shard 0's
             overfetch and every `merge_topk` fold held to the plain
             versions, and every fold timed beside `torch.topk`,
             `store.merge_topk.yardstick`); then
             `checkpoint()` and open (every per-shard index adopted, 0
             builds). One line a step: seconds, the adoption of each
             index file, WAL bytes and records, segment bytes, peak device
             memory, and the launch counts over the recovered reads, set
             to 0 just before each and read just after.
12. serving ops — the serving-ops layer on the handles above, one line a
             step with the launch counts set to 0 just before it and read
             just after. Its live steps run where those handles hold
             their phase's state: (b) on phase 8's live handle before its
             compaction and on phase 10's sharded live handle before
             theirs, a hooked service serves the routed batches and one
             `RecallAuditor` pass replays its reservoir through the exact
             `prefilter` oracle on a pinned snapshot, every audited
             query's exact keys equal to the phase's exact read
             (`fused_live`, and `merge_topk` across the shards, launched);
             after phase 8's compaction, (c) a `SemanticResultCache` in
             front of `RouterService(live, router)`: an upsert carrying a
             cached AND entry's labels evicts it as stale while an entry
             over disjoint labels still hits; (e) a traced exact search
             on that live handle, fused and staged, with the span tree
             search → execute → group → live.base / live.delta (/
             live.merge), each span's host ms beside the device ms between
             CUDA events at its open and close, and the ledger's live
             gauges and `snapshot_pin` lease. Then, at the end, on phase
             5's handle and router: (a) `RouterService` with `telemetry=`,
             `tracer=`, `slo=` and `obslog=` (its log under `build/`),
             decisions, ids and distance bits identical to the unhooked
             service's, and the median seconds a batch of each over 5
             passes; (b) one audit pass, exact keys equal to phase 5's
             exact answers; (c) the cache behind `AsyncBatchQueue(
             max_batch=32, max_wait_ms=5)`: 300 single queries from 8
             threads (100 distinct, each twice, and 100 seeded
             near-duplicates), every exact hit bit-identical to a fresh
             search of its query, every semantic hit a cached neighbour's
             rows with distances within 1e-4 of float64, the hits by kind
             and the median hit and miss latency; (d) `constant_router`
             over the IVF pair with ivf_gamma degraded (`DegradedMethod(
             keep=2)`): `OnlineRouterAdapter` routes off it within 6
             steps, no retrain; (e) a post-mortem dump, `metrics_text`
             over every surface parsed strictly (no duplicate samples),
             and one scrape of `MetricsServer` on 127.0.0.1 (/metrics and
             /healthz answer 200). Everything the phase opens (the logs'
             writer threads, the server, the cache, the queue, the
             post-mortem handlers) is closed before the last line.
13. train  — the router's offline stage on the card, the launch counts
             set to 0 just before it and read just after (the kernels'
             line's `launches_by_path.train`): (a) `training.collect` on
             the six training specs (`get_dataset`, each `FilteredIndex(
             ds)` on the card; 60 queries a predicate, seed 0, the five
             candidates: `router_all`'s recipe), one line a cell (its
             searches' seconds, each method's best setting and mean
             recall), every table-B recall against `router_all/
             table.json` key by key (counts equal and differing, the
             largest |delta|, SWEEP_TOL); (b) `training.train_models`
             (minimal features, (64, 32), 200 epochs) on the card and on
             the CPU from the same initial parameters and batches:
             seconds a method on each, the final MSE (MSE_RTOL), the
             largest |delta prediction| (FIT_TOL) beside a CPU fit of
             one-ulp-moved inputs; (c) a router from the card's
             fit over the sweep's table merged with phase 5's rows, saved
             and loaded with the same decisions, serving phase 5's three
             batches on the 1M handle: every answer passes its predicate
             and is bit-identical to `fx.run_method` of its decision,
             decisions and recall@10 beside `router_all`'s; (d) the
             adapter's default retrain from audit labels over a degraded
             ivf_gamma on the 1M handle. Then one profiled pass of the
             sweep over `ytb_audio` (its indexes built) and of a 20-epoch
             fit.
14. rag    — the RAG example's served LM (`examples/rag_serve.py`'s
             default architecture, qwen2-0.5b) at its full width on the
             card, random weights from seed 0: (a) `init_params` of its
             630,167,424 parameters, their fp32 and bf16 bytes and the
             peak device memory; (b) fp32 compute, TF32 off, the same
             weights on the card and on the machine's CPU: 2 prompts of
             64 tokens, prefill's and the first decode step's logits
             within B_TOL, 8 greedy tokens equal or parted at a near-tie,
             `generate` equal to the step trace, the CPU's one-ulp move
             of the input embeddings printed beside; (c) prefill against
             decode in bf16 (the reference's consistency test at full
             width): argmax equal, logits within 0.15; (d) the RAG path
             on phase 5's handle and router: 32 requests drawn as the
             example draws them, embedded by the LM (prefill's first 192
             logits), sent one by one through `AsyncBatchQueue(
             RouterService(fx, router_all), max_batch=16, max_wait_ms=20)`
             and through one with `method="prefilter"`, the launch counts
             set to 0 just before and read just after (the kernels line's
             `launches_by_path.rag`): every answer equal to the batched
             search of its predicate's requests, every id passing its
             predicate; then up to 4 retrieved ids appended as tokens and
             8 tokens generated, the first decode step within 0.15 of a
             prefill over prompt plus first token; the embed, route and
             retrieve, and generate milliseconds and routed recall@5
             against the `prefilter` answers; (e) 8 prompts of 2,048
             tokens and 32 new ones in bf16: prefill ms and decode ms a
             step (medians of 3 passes after a warm-up), tokens a second,
             peak memory, one profiled pass's idle share (the device's
             activity alone), and the bounds from the shapes.
15. families — every other LM family's serving forward at full width,
             one family at a time, freed before the next: deepseek-v2
             (MoE + MLA) cut to 2 layers and grok-1 (MoE) to 1,
             xlstm-125m, hymba-1.5b and whisper-medium whole, every
             family's weights drawn on the card from a seeded generator
             with `init_params`'s per-leaf std (`fam.model`: each count
             held to the reference's). (d) first:
             `moe.dispatch` and `_moe_local` on the card against the
             machine's CPU at deepseek-v2's gate width (E = 160, k = 6)
             and grok-1's (E = 8, k = 2), 4,096 integer-grid tokens,
             forced overflow and gate ties: experts, positions, slot
             table and reach mask bit-identical, y within fp32 order.
             Then per family: (b) fp32, TF32 off, the same weights on
             the card and the CPU (the giants at 1 layer, whisper at
             FAM_CHECK_DEPTH's 4 encoder and 4 decoder layers): 2 prompts of
             64 tokens, prefill and 2 decode steps (8 greedy tokens for
             the small three), logits within B_TOL except rows whose
             MoE dispatch parted at a near-tie of the gate (each MoE
             call compared), the one-ulp move beside; (c) prefill
             against decode in bf16 (the MoE families at capacity
             factor E/k, with their drops and error at 1.25 beside); (f)
             8 prompts of 2,048 tokens (whisper: 416 over 1,500 frames)
             and 32 new ones in bf16 at `ModelCtx()`'s defaults
             (`gla_chunk` 256), every logit finite, prefill and decode
             ms, tokens a second, peak memory, the bounds from the
             shapes (deepseek-v2's also for the routed form, and one
             profiled pass's idle share). (e) with deepseek-v2: phase
             14 (d)'s RAG path on phase 5's handle and router, the
             launch counts set to 0 just before its queues and read
             just after (`launches_by_path.rag_deepseek`).
16. training — LM training on the card (`launch.train.train_loop`, each
             step in deterministic mode): (a) qwen2-0.5b whole at full
             width in its own config (fp32 parameters, remat,
             `default_opt_cfg`'s AdamW), `TokenStream(vocab, 4096, 8,
             seed=1)`, accumulation 2 x 4 sequences (32,768 tokens a
             step), 6 steps with a `CheckpointManager` saving every 3:
             every loss finite and the last below the first, the median
             step of steps 3-6, tokens a second, peak memory, the bound;
             (b) a fresh `train_loop` resumed from step 3 to 6: its losses,
             parameters and moments bit-identical to the uninterrupted
             run's; a third run (the full width cut to 2 layers, 512
             tokens) gets SIGUSR1 during step 2, checkpoints at 2 and
             stops; then one step in deterministic mode under the profiler
             (the device's activity alone) and one in the default mode,
             timed; (c) one step of qwen2-0.5b cut to 2 layers, fp32
             compute, TF32 off, 2 x 512 tokens, on the card and on the
             machine's CPU from the same weights: loss and grad norm within
             1e-5 and 1e-4 relative, the largest parameter difference, and
             with 8-bit moments the count of int8 moments that part (each
             within 1e-3 of a rounding tie); (d) one step of deepseek-v2
             (1 layer; bf16 parameters, 8-bit moments), xlstm-125m,
             hymba-1.5b and whisper-medium (448 decoder positions over
             1,500 frames) at full width, 2,048 tokens, accumulation 2 x
             microbatch_seqs, weights drawn on the card: a finite loss,
             every leaf changed, the step time and peak memory; (e) (a)'s
             step-6 checkpoint restored through `CheckpointManager`, cast
             to bf16, serving phase 14 (d)'s RAG path on phase 5's handle
             and router, the launch counts set to 0 just before its queues
             and read just after (`launches_by_path.rag_trained`).
17. mesh   — the mesh level (`launch/mesh.py`, `launch/specs.py`,
             `ann/distributed.py`, the models' mesh paths), the kernels
             built before any rank starts. (a) One rank on NCCL, a
             (1, 1) mesh on the card: `make_sharded_search` over phase
             3's arrays for phase 5's three exact batches at k = 10 and
             ANY_K, its ids bit-identical to `fx.search(batch,
             "prefilter")`, the launch counts set to 0 just before and
             read just after (`launches_by_path.mesh`: `masked_topk`,
             `masked_topk_large` at k = 200, `merge_topk`); one qwen2-0.5b
             step (full width cut to MESH_DEPTH layers, fp32 compute, TF32
             off, 4 x 2,048 tokens, weights drawn on the card from a seed)
             with DTensor parameters, its loss the plain step's bits
             (else within 1e-6). (b) MESH_RANKS processes sharing the
             card on this script's host-staged gloo backend
             (`HOST_STAGED`: NCCL refuses two ranks on one card, and
             gloo's own CUDA collectives crash under DTensor's functional
             collectives), each joined with a timeout: the search on a
             (4, 1) mesh (a quarter of the rows a rank) equal to (a)'s;
             the same step on a (2, 2) mesh, FSDP over "data" and TP over
             "model", loss within 1e-5 and grad norm within 1e-4 of (a)'s
             plain step, its collectives counted (CommDebugMode) and
             logged, no parameter sharded over "model" gathered over it;
             the trained state gathered to the host and resharded onto a
             (1, 4) mesh (`runtime.elastic_reshard`), one step there
             within 1e-5 of the same step on one rank; deepseek-v2 (1
             layer, full width, bf16) on a (1, 2) mesh (160 experts on 2
             ranks: expert-parallel) at capacity factor E/k (nothing
             drops, so a flip parts only its own row): the MoE layer
             dispatching as one rank does on the same input, bit for bit,
             and a prefill within BF16_TOL of one rank's on the rows whose
             dispatch did not part at a near-tie, the tie twice the
             measured largest gate-logit difference between the two.
             Each step's collectives are counted in one pass and its time
             read in a second pass without the counting. Per rank: peak
             memory and step milliseconds, four ranks sharing one card
             (not scaling numbers).
18. mesh_families — (a) the port's dry run (`launch/dryrun.py`) in two
             subprocesses with a timeout, under this machine's torch,
             started before the build and run beside it, the data's
             synthesis and phase 4's checks, collected before phase 5 (no
             timed phase runs beside it) and reported here: qwen2-0.5b,
             xlstm-125m,
             hymba-1.5b and whisper-medium at decode_32k and train_4k on
             the 16×16 mesh, each cell under a fake process group of 256
             ranks with the mesh's device type "cuda"; each cell's summary
             line printed, every cell "ok", the decode cells' argument
             bytes equal to the JAX package's and their per-rank dot FLOPs
             within 2% of its, or at the ratio tests/test_torch_dryrun.py
             pins within 1% (counts of a rank's work, not times). (b)
             phase 17 (b)'s MESH_RANKS processes after their work there,
             on the same HOST_STAGED group, a (2, 2) mesh: xlstm-125m (4
             blocks, one whole block pattern), hymba-1.5b (2 layers) and
             whisper-medium (2 encoder and 2 decoder layers) at full
             width, fp32 compute, TF32 off, weights drawn on the card from
             a seed: a train step on 2 x 512 tokens, a prefill of 2
             prompts of 60 tokens and 4 greedy decode steps, held on rank
             0 to the same calls on one rank (loss within 1e-5 and grad
             norm within 1e-4 relative, logits within B_TOL, the tokens
             equal); hymba's 25 heads and 5 kv heads do not divide
             "model" = 2, so its heads run whole on every rank. The ranks'
             launch counts set to 0 just before and read just after
             (`launches_by_path.mesh_families`).

Every line carries "t", the seconds since the script started. The last
three lines are nvidia-smi's name and power limit, the kernels'
JSON line (`merge_topk`'s row with `by_input`: each input kind's ms,
`torch.topk` ms and bound, and the time before its redesign where
PERF.md has one, labelled as copied) and `{"ok": true, "device":
{...}}`. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# phase 16 trains in deterministic mode, which needs cuBLAS's workspace
# fixed before cuBLAS first starts in this process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from torch._C._distributed_c10d import \
    _create_work_from_future  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.ann import bench  # noqa: E402
from repro_torch.ann import live as live_mod  # noqa: E402
from repro_torch.ann.dataset import (ANNDataset,  # noqa: E402
                                     ground_truth_topk, recall_at_k)
from repro_torch.ann.engine import (DEFAULT_QCHUNK,  # noqa: E402
                                    resolve_setting, to_device)
from repro_torch.ann.index import (FilteredIndex, QueryBatch,  # noqa: E402
                                   exact_distances)
from repro_torch.ann.live import (LiveFilteredIndex,  # noqa: E402
                                  ShardedLiveIndex)
from repro_torch.ann.predicates import (PREDICATES, Predicate,  # noqa: E402
                                        eval_predicate_np)
from repro_torch.ann import graph  # noqa: E402
from repro_torch.ann import labels as lb  # noqa: E402
from repro_torch.ann import trace as trace_mod  # noqa: E402
from repro_torch.ann.cache import SemanticResultCache  # noqa: E402
from repro_torch.ann.ledger import get_ledger  # noqa: E402
from repro_torch.ann.metrics import (MetricsServer,  # noqa: E402
                                     backpressure_health, metrics_text)
from repro_torch.ann.obslog import PostmortemDumper, WideEventLog  # noqa: E402
from repro_torch.ann.slo import Objective, SLOEngine  # noqa: E402
from repro_torch.ann.telemetry import (DegradedMethod,  # noqa: E402
                                       OnlineBenchmarkTable,
                                       OnlineRouterAdapter, RecallAuditor,
                                       TelemetrySink, constant_router)
from repro_torch.ann.trace import Tracer  # noqa: E402
from repro_torch.ann.registry import (all_methods,  # noqa: E402
                                      candidate_methods, get_method)
from repro_torch.ann.service import (AsyncBatchQueue,  # noqa: E402
                                     RouterService, ShardedRouterService)
from repro_torch.ann.sharded import (ShardedFilteredIndex,  # noqa: E402
                                     stack_candidates)
from repro_torch.ann.store import IndexStore, WriteAheadLog  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core import mlp, training  # noqa: E402
from repro_torch.core.router import MLRouter  # noqa: E402
from repro_torch.core.table import BenchmarkTable  # noqa: E402
from repro_torch.data.ann_synth import (TRAIN_SPECS,  # noqa: E402
                                        VALIDATION_SPECS, get_dataset,
                                        make_queries, synthesize)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitmap_filter as bf  # noqa: E402
from repro_torch.kernels import masked_topk as mk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import common as lm_common  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import adam as adam_mod  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): fp32
# outside the tensor cores, and HBM3. 32-bit integer operations (add,
# compare, AND/OR/XOR) issue at 64 results per clock per SM on compute
# capability 9.0 (the CUDA C++ Programming Guide's table of arithmetic
# instruction throughput), over 132 SMs at the 1.98 GHz boost clock that
# the fp32 figure (128 lanes, an FMA counted as two) also assumes.
FP32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9
HBM_BYTES_S = 3.35e12

# The main path's size: `synth_192d` at 1M rows, 256-query batches, the
# first 32 exact-search queries of each held against numpy ground truth.
ROWS = 1_000_000
QUERIES = 256
GT_QUERIES = 32

# The sharded path: the same 1M rows in 4 row shards, all on the one card
# (as the JAX package puts every shard on the one device of a one-device
# host); the queue takes QUEUE_PER_PRED single queries of each predicate.
SHARDS = 4
QUEUE_PER_PRED = 100

# The live path: upserts into the 1M-row base (25 MB of delta vectors,
# 64 sealed chunks of LIVE_CHUNK rows, 16 times the pruner's 4 x
# LIVE_CHUNK), then deletes that make the base overfetch k + 1,000 ->
# 1,016 and the staged delta overfetch k + 500 -> 512, both past MAX_K.
# (65,536 upserts until phase 14 was added; halved to keep the script
# within its time: the fvamana graft's host loop, most of the live
# compaction, runs over every upserted row.)
LIVE_UPSERTS = 32_768
LIVE_BASE_DELETES = 1_000
LIVE_DELTA_DELETES = 500
LIVE_CHUNK = 512

PRED_NAMES = ("EQUALITY", "AND", "OR")

# Slice 4: the any-k phase's k, a reranking stage's candidate count.
ANY_K = 200

# Each kernel's time per predicate (E, A, O) before `selectivity` was
# redesigned, copied from PERF.md's kernel table (this script's run 4 of
# the any-k slice on an NVIDIA H100 80GB HBM3 at 700 W). Not measured by
# this run: printed on a line of their own, labelled so, and kept out of
# the kernels' line.
EARLIER_MS = {"masked_topk": (0.395, 1.512, 1.721),
              "selectivity": (0.489, 0.621, 0.582),
              "merge_topk": (0.0106, 0.0106, 0.0107),
              "masked_topk_blocks": (1.228, 5.251, 6.455),
              "fused_live": (0.242, 0.483, 0.521),
              "masked_topk_large": (0.644, 1.641, 1.801)}

# `merge_topk`'s time per predicate (E, A, O) on each input kind before
# its redesign, copied from PERF.md (this script's run 1 of the store
# slice for the staged and block lists, run 4 of the any-k slice for the
# shard lists, both on an NVIDIA H100 80GB HBM3 at 700 W). Not measured
# by this run: labelled so where the kernels' line carries them.
MERGE_EARLIER_MS = {"staged": (0.686, 0.684, 0.684),
                    "blocks": (0.0514, 0.0505, 0.0508),
                    "shards": EARLIER_MS["merge_topk"]}

# The router artifacts (the five candidates, `router_all`, for every
# routed path).
ASSETS = os.path.join(ROOT, "src", "repro_torch", "assets")

# Word widths of the selectivity checks: the training specs' 1 (universe
# 14-30), 7, 13, 16, 32 and 63 (universe 2,000).
SELECTIVITY_WIDTHS = (1, 7, 13, 16, 32, 63)

# Every kernel wrapper and its launch counter, by the name the kernels'
# JSON line gives it.
KERNEL_WRAPPERS = {"masked_topk": mk.masked_topk_accum,
                   "selectivity": bf.selectivity_count,
                   "merge_topk": mk.merge_topk_accum,
                   "masked_topk_blocks": mk.masked_topk_blocks,
                   "fused_live": mk.fused_live_accum,
                   "masked_topk_large": mk.masked_topk_large}


# The clock every line's "t" (seconds since the script started) reads.
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0,
                      **fields}, default=float), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, flush) -> float:
    """Median device time of one `fn()` call: CUDA events around each call,
    after two warm calls; the L2 cache is flushed and the host is let ahead
    (a device-side sleep) before every timed call, so the events bracket
    device work and not the host's enqueue."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def masked_topk_bound(mask, d: int, w: int, k: int) -> tuple[float, float]:
    """(operations time, bytes time) in seconds for one masked_topk launch whose predicate
    mask [Q, N] is `mask`: each input byte read once (the bitmaps, the
    queries, and the base rows and norms of rows that pass for some
    query), each output written once; fp32 work 2·D + 2 per passing
    (query, row) pair, and one 32-bit op per (query, row, word) for the
    predicate."""
    q, n = mask.shape
    rows = int(mask.any(0).sum())
    pairs = int(mask.sum())
    nbytes = n * w * 4 + rows * (d + 1) * 4 + q * (d + w) * 4 + q * k * 8
    t_ops = pairs * (2 * d + 2) / FP32_FLOPS + q * n * w / INT32_OPS
    return t_ops, nbytes / HBM_BYTES_S


def selectivity_bound(q: int, n: int, w: int) -> tuple[float, float]:
    """(operations time, bytes time) in seconds for one selectivity launch: the bitmaps and
    queries read once, the counts written once; one 32-bit op per
    (query, row, word)."""
    nbytes = n * w * 4 + q * w * 4 + q * 4
    return q * n * w / INT32_OPS, nbytes / HBM_BYTES_S


def merge_topk_bound(s: int, q: int, kk: int, k: int,
                     sorted_lists: bool = False) -> tuple[float, float]:
    """(operations time, bytes time) in seconds for one merge_topk launch:
    [S, Q, K] dists and ids read once, [Q, k] written once; one compare
    per candidate, which is nothing beside the bytes. Lists known to be
    sorted need only each list's head and the k winners read."""
    read = s * q + q * min(k, s * kk) if sorted_lists else s * q * kk
    return read / INT32_OPS, (read + q * k) * 8 / HBM_BYTES_S


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def tie_case(rng, q: int, n: int, d: int = 24, w: int = 2):
    """Integer-grid vectors (multiples of 1/4) with duplicated rows: every
    score is exact in fp32 whatever the summation order, ties are
    frequent. Query 0 carries no labels."""
    qv = (rng.integers(-6, 7, (q, d)) / 4.0).astype(np.float32)
    base = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    base[n // 2: n // 2 + n // 4] = base[: n // 4]
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qb = (rng.integers(0, 2, (q, w)) * rng.integers(1, 8, (q, w))
          ).astype(np.uint32)
    bm = (rng.integers(0, 2, (n, w)) * rng.integers(1, 8, (n, w))
          ).astype(np.uint32)
    qb[0] = 0
    return qv, qb, base, norms, bm


def pattern_bitmaps(rng, q: int, n: int, w: int, pred: int):
    """Row label sets drawn from 32 random patterns, so each predicate
    passes a sizeable share of rows; queries built for `pred` (a pattern
    for EQUALITY, a subset of one for AND, a few random bits for OR).
    Query 0 carries no labels. Returns (qbms [q, w], bitmaps [n, w])."""
    def words(shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(
            np.uint32)

    pats = words((32, w)) & words((32, w)) & words((32, w))
    bm = pats[rng.integers(0, 32, n)]
    src = pats[rng.integers(0, 32, q)]
    if pred == 0:
        qb = src.copy()
    elif pred == 1:
        qb = src & words((q, w))
    else:
        qb = (rng.random((q, w)) < 0.3).astype(np.uint32) << \
            rng.integers(0, 32, (q, w)).astype(np.uint32)
    qb[0] = 0
    return qb, bm


def on_card(dev, *arrays):
    """numpy arrays -> tensors on `dev`; uint32 bitmaps as int32 views."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                         if a.dtype == np.uint32 else a).to(dev)
        for a in arrays)


def hold_to_plain(what: str, pred: int, args, gd, gi, pd, pi,
                  tol: float) -> float:
    """A top-k kernel's output (gd, gi) against its plain version's (pd,
    pi) on random floats, where the two sum the scores in different
    orders. [Q, k] lists, or [NB, Q, k] per-block lists. The fill is
    identical and scores agree to `tol`; each returned id passes the
    predicate, comes once per query and carries its own plain score; ids
    may differ only where the plain scores of both ids lie within tol.
    Returns the largest score difference."""
    torch.cuda.synchronize()
    if not torch.equal(gi < 0, pi < 0):
        raise AssertionError(f"{what} fill differs, pred {pred}")
    real = gi >= 0
    err = float((gd - pd)[real].abs().max()) if bool(real.any()) else 0.0
    if err > tol:
        raise AssertionError(f"{what} scores differ by {err} > {tol}, "
                             f"pred {pred}")
    qv, qbt, base, norms, bmt = args
    mask = mk._predicate_mask_block(bmt, qbt, pred)
    scores = norms[None] - 2.0 * (qv.float() @ base.float().T)
    if gi.dim() == 3:                  # [NB, Q, k] -> [Q, NB·k]
        gd, gi, pi, real = (t.transpose(0, 1).reshape(gi.shape[1], -1)
                            for t in (gd, gi, pi, real))
    gil, pil = gi.long().clamp(min=0), pi.long().clamp(min=0)
    got_s = scores.gather(1, gil)
    differ = (gi != pi) & real
    id_err = float((got_s - gd)[real].abs().max()) if bool(
        real.any()) else 0.0
    swap_err = float((got_s - scores.gather(1, pil))[differ].abs().max()
                     ) if bool(differ.any()) else 0.0
    if id_err > tol or swap_err > tol:
        raise AssertionError(
            f"{what} ids disagree with their scores, pred {pred}: "
            f"{id_err} / {swap_err} > {tol}")
    if not bool(mask.gather(1, gil)[real].all()):
        raise AssertionError(f"{what} returned a row that fails the "
                             f"predicate, pred {pred}")
    kept = torch.sort(gi.masked_fill(~real, -1), dim=1).values
    if bool(((kept[:, 1:] == kept[:, :-1]) & (kept[:, 1:] >= 0)).any()):
        raise AssertionError(f"{what} returned an id twice, pred {pred}")
    emit(f"kernels.{what}.random", pred=PRED_NAMES[pred], q=qv.shape[0],
         n=base.shape[0], d=base.shape[1], w=bmt.shape[1],
         k=pd.shape[-1], dtype=str(qv.dtype), max_abs_err=err, tol=tol,
         ids_differing=int(differ.sum()), id_score_err=id_err,
         swapped_score_err=swap_err, pairs_passing=int(mask.sum()))
    return err


def check_kernels(dev, n: int, d: int, w: int) -> dict:
    """Kernel vs plain version on the card. Returns max abs errors."""
    rng = np.random.default_rng(0)
    tie_cases = 0
    for q, nn, k in [(1, 64, 5), (7, 256, 41), (25, 1024, 10),
                     (5, 1001, 10), (3, 20011, 128), (37, 70001, 10)]:
        args = on_card(dev, *tie_case(rng, q, nn))
        for pred in range(3):
            gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
            pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(gd, pd)):
                raise AssertionError(
                    f"masked_topk differs from its plain version on the tie "
                    f"grid: pred {pred}, q {q}, n {nn}, k {k}")
            tie_cases += 1

    # Random fp32 at the exact-search path's shapes. Two fp32 sums of D
    # products taken in different orders differ by at most about
    # 2·D·u·Σ|q_i·v_i| (u = 2^-24), and Σ|q_i·v_i| <= ‖q‖·‖v‖, so scores
    # may differ by tol = 2·D·u·max(‖v‖² + 2‖q‖‖v‖). Each returned id must
    # pass the predicate, come once per query and carry its own plain
    # score; ids may differ only where the plain scores of both ids lie
    # within tol of each other.
    topk_err, q, k = 0.0, 64, 10
    qv = rng.normal(size=(q, d)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    norms = (base.astype(np.float64) ** 2).sum(1).astype(np.float32)
    vn = float(np.sqrt(norms.max()))
    qn = float(np.sqrt((qv.astype(np.float64) ** 2).sum(1).max()))
    tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn)
    vecs = on_card(dev, qv, base, norms)
    for pred in range(3):
        qbt, bmt = on_card(dev, *pattern_bitmaps(rng, q, n, w, pred))
        args = (vecs[0], qbt, vecs[1], vecs[2], bmt)
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=k)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
        err = hold_to_plain("masked_topk", pred, args, gd, gi, pd, pi, tol)
        topk_err = max(topk_err, err)
    del vecs, args

    # selectivity at every width class of the kernel (W <= 16 in
    # registers, the chunked path above), query counts that are not a
    # multiple of its block's, ragged row counts, and the dataset's own
    # row count at its width
    sel_cases = 0
    for ww in sorted(set(SELECTIVITY_WIDTHS) | {w}):
        shapes = [(1, 50), (7, 4099), (255, 100003), (300, 70001)]
        if ww == w:
            shapes.append((256, n))
        for qq, nn in shapes:
            for pred in range(3):
                qbt, bmt = on_card(dev, *pattern_bitmaps(rng, qq, nn, ww,
                                                         pred))
                got = bf.selectivity_count(qbt, bmt, pred=pred)
                want = bf.selectivity_plain(qbt, bmt, pred=pred)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"selectivity differs from its plain version: "
                        f"pred {pred}, q {qq}, n {nn}, w {ww}")
                sel_cases += 1
    emit("kernels.check", masked_topk_tie_grid_cases=tie_cases,
         masked_topk_tie_grid="bit-identical", masked_topk_random_max_abs_err=
         topk_err, selectivity_cases=sel_cases, selectivity="exact",
         selectivity_widths=sorted(set(SELECTIVITY_WIDTHS) | {w}))
    return {"masked_topk": topk_err, "selectivity": 0.0}


def grid_labels(rng, n: int, d: int, universe: int):
    """Integer-grid vectors (multiples of 1/4, an eighth of the rows
    duplicated) with 1-3 labels a row: every distance of the graph build
    is exact in fp32 in any summation order."""
    v = (rng.integers(-6, 7, (n, d)) / 4.0).astype(np.float32)
    v[n // 2: n // 2 + n // 8] = v[: n // 8]
    bm = np.zeros((n, (universe + 31) // 32), dtype=np.uint32)
    for i in range(n):
        for lab in rng.choice(universe, rng.integers(1, 4), replace=False):
            bm[i, lab >> 5] |= np.uint32(1) << np.uint32(lab & 31)
    return v, bm


def check_graph_build(dev) -> int:
    """The fvamana graph built on the card (`graph.build_graph_torch`)
    against the numpy build on integer-grid sets: the same neighbours,
    medoid and label entries. Returns the number of sets."""
    rng = np.random.default_rng(5)
    sets = [(5000, 16, 40, 16), (20_000, 48, 64, 32)]
    for n, d, u, r in sets:
        v, bm = grid_labels(rng, n, d, u)
        host = graph.build_graph(v, bm, u, r=r, seed=17)
        card = graph.build_graph_torch(v, bm, u, device=dev, r=r, seed=17)
        if not (np.array_equal(card.neighbors, host.neighbors)
                and card.medoid == host.medoid
                and np.array_equal(card.label_entry, host.label_entry)):
            raise AssertionError(f"the card's graph build differs from the "
                                 f"numpy build: n {n}, d {d}, r {r}")
    return len(sets)


def merge_grid(rng, s: int, q: int, kk: int):
    """[S, Q, K] candidates on a coarse grid (ties within and across
    shards) with ±0.0, NaN, ±inf, values past PAD_SCORE, repeated ids and
    −1 slots. Returns (dists, ids) numpy."""
    d = np.round(rng.normal(size=(s, q, kk)).astype(np.float32) ** 2, 1)
    d[rng.random(d.shape) < 0.2] *= -1
    zero = rng.random(d.shape) < 0.3
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0),
                       np.float32(-0.0))
    for val, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.03),
                      (np.float32(3.2e38), 0.03)):
        d[rng.random(d.shape) < frac] = val
    ids = rng.integers(0, 10, (s, q, kk)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.1] = -1
    return d, ids


def staged_lists(rng, s: int, q: int, kk: int, dead: float = 0.35):
    """The staged live read's fold on a coarse grid: a base overfetch of kk
    ascending candidates with (−1, +inf) holes where rows are tombstoned,
    and for s >= 2 delta top-k lists half as wide with a tail of (−1,
    +inf) pads, padded to kk as `stack_candidates` pads them; ±0.0 among
    the distances. Returns (dists, ids) numpy."""
    def grid(n):
        x = np.round(rng.normal(size=(q, n)), 1).astype(np.float32)
        x[rng.random(x.shape) < 0.1] = np.float32(-0.0)
        key = mk.order_key(torch.from_numpy(x)).numpy()
        return np.take_along_axis(x, np.argsort(key, 1, kind="stable"), 1)
    d = np.full((s, q, kk), np.inf, np.float32)
    ids = np.full((s, q, kk), -1, np.int32)
    d[0] = grid(kk)
    ids[0] = rng.permutation(q * kk).reshape(q, kk)
    hole = rng.random((q, kk)) < dead
    d[0][hole], ids[0][hole] = np.inf, -1
    kd = max(1, kk // 2)
    for j in range(1, s):
        d[j, :, :kd] = grid(kd)
        ids[j, :, :kd] = j * q * kk + np.arange(q * kd).reshape(q, kd)
        for qi, nval in enumerate(rng.integers(0, kd + 1, q)):
            d[j, qi, nval:], ids[j, qi, nval:] = np.inf, -1
    return d, ids


def check_merge_regimes(dev, rng) -> int:
    """`merge_topk`'s regimes against its plain version, bit for bit:
    unordered lists of S = 1, 2, 3 at K = 416, 1,016 and 4,096 (the
    shared-memory select) and K = 60,000 (past shared memory: the
    workspace select), each as the coarse grid of `merge_grid` (NaN,
    ±inf, ±0.0 and −1 ids), as the staged read's lists with holes, and
    with every slot at one distance (ties across the lanes' stripes and
    the select's blocks); k = 1, 10, 128, 129, 1,016 and past S·K; and
    sorted lists with and without the scans' promise (`merge_fold`), past
    shared memory too (the stepping merge, a thread that owns two lists
    past 1,024). Returns the number of cases."""
    cases = 0

    def held(what, dt, it, k, promise=False):
        nonlocal cases
        gd, gi = (merge_fold(dt, it, k, True) if promise
                  else mk.merge_topk_accum(dt, it, k=k))
        pd, pi = mk.merge_topk_plain(dt, it, k=k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(
                gd.view(torch.int32), pd.view(torch.int32))):
            raise AssertionError(f"merge_topk differs from its plain "
                                 f"version: {what}, {list(dt.shape)}, k {k}")
        cases += 1

    for s, q, kk in [(1, 256, 416), (2, 256, 1016), (3, 64, 4096),
                     (2, 3, 60_000)]:
        tied_d = np.full((s, q, kk), 2.5, np.float32)
        tied_i = rng.integers(0, 1 << 30, (s, q, kk)).astype(np.int32)
        tied_i[rng.random(tied_i.shape) < 0.2] = -1
        kinds = {"grid": merge_grid(rng, s, q, kk),
                 "staged": staged_lists(rng, s, q, kk),
                 "tied": (tied_d, tied_i)}
        for kind, arrays in kinds.items():
            dt, it = on_card(dev, *arrays)
            for k in (1, 10, 128, 129, 1016, s * kk + 5):
                held(kind, dt, it, k)
    for s, q, kk, k in [(4, 256, 10, 10), (977, 64, 10, 10),
                        (2, 256, 1016, 10), (1, 3, 60_000, 129),
                        (977, 16, 32, 32), (1025, 4, 128, 128),
                        (3, 8, 10_000, 10)]:
        d, ids = merge_grid(rng, s, q, kk)
        d = np.where(np.isnan(d) | (ids < 0), np.float32(mk.PAD_SCORE), d)
        key = mk.order_key(torch.from_numpy(d)).numpy()
        order = np.argsort(key, axis=2, kind="stable")
        dt, it = on_card(dev, np.take_along_axis(d, order, 2),
                         np.take_along_axis(ids, order, 2))
        for promise in (False, True):
            held(f"sorted, promised {promise}", dt, it, k, promise)
    return cases


def check_slice2_kernels(dev, fx, batches: dict) -> dict:
    """`merge_topk`, `masked_topk_blocks` and bf16 `masked_topk` against
    their plain versions on the card. Returns max abs errors."""
    rng = np.random.default_rng(1)
    dd = fx.device
    n, w = dd.bitmaps.shape
    d = dd.vectors.shape[1]

    # merge_topk: bit-identical ids and distance bits, including the
    # sharded path's shape (4 shards, 256 queries, K = k = 10), the
    # multi-block entry point's (977 blocks, 256 queries), the fused
    # scan's fold (977 splits, 64 queries), both launch shapes at k = 128
    # and k > S·K
    merge_cases = 0
    for s, q, kk, k in [(4, 256, 10, 10), (977, 256, 10, 10),
                        (977, 64, 10, 10), (1, 11, 8, 8), (5, 64, 10, 41),
                        (3, 9, 4, 10), (2, 300, 64, 128), (40, 7, 30, 128)]:
        dt, it = on_card(dev, *merge_grid(rng, s, q, kk))
        gd, gi = mk.merge_topk_accum(dt, it, k=k)
        pd, pi = mk.merge_topk_plain(dt, it, k=k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(
                gd.view(torch.int32), pd.view(torch.int32))):
            raise AssertionError(f"merge_topk differs from its plain "
                                 f"version: S {s}, Q {q}, K {kk}, k {k}")
        merge_cases += 1
    merge_cases += check_merge_regimes(dev, rng)

    # masked_topk_blocks and bf16 masked_topk: bit-identical on the tie
    # grid (exact in bf16 too)
    tie_cases = 0
    for q, nn, bn, k in [(8, 512, 128, 10), (16, 256, 64, 41),
                         (5, 1001, 256, 10), (37, 70001, 1024, 10),
                         (3, 20011, 1024, 128)]:
        args = on_card(dev, *tie_case(rng, q, nn))
        b16 = (args[0].bfloat16(), args[1], args[2].bfloat16(), *args[3:])
        for pred in range(3):
            gd, gi = mk.masked_topk_blocks(*args, pred=pred, k=k, bn=bn)
            pd, pi = mk.masked_topk_blocks_plain(*args, pred=pred, k=k,
                                                 bn=bn)
            hd, hi = mk.masked_topk_accum(*b16, pred=pred, k=k)
            fd, fi = mk.masked_topk_plain(*b16, pred=pred, k=k)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(gd, pd)):
                raise AssertionError(
                    f"masked_topk_blocks differs from its plain version on "
                    f"the tie grid: pred {pred}, q {q}, n {nn}, bn {bn}")
            if not (torch.equal(hi, fi) and torch.equal(hd, fd)):
                raise AssertionError(
                    f"bf16 masked_topk differs from its plain version on "
                    f"the tie grid: pred {pred}, q {q}, n {nn}, k {k}")
            tie_cases += 1

    # the paths' inputs over the 1M rows: masked_topk_blocks on each whole
    # 256-query exact batch at its k and at ANY_K, as
    # ops.masked_topk_multiblock gets it in the multi-block and any-k
    # phases, and
    # bf16 masked_topk on its first 64-query chunk, as exact search cuts
    # it; scores from two summation orders, held as `hold_to_plain` says.
    # bf16 products are exact in fp32, so the same bound holds for them,
    # on norms up to 2^-8 larger once rounded to bf16 (hence the 1.01).
    errs = {"masked_topk_blocks": 0.0, "masked_topk_bf16": 0.0}
    base16 = dd.vectors.bfloat16()
    for pred, batch in batches.items():
        qv = to_device(batch.vectors, dev)
        qb = to_device(batch.bitmaps, dev)
        vn = float(dd.norms.max().sqrt())
        qn = float(qv.norm(dim=1).max())
        tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn) * 1.01
        args = (qv, qb, dd.vectors, dd.norms, dd.bitmaps)
        for k in (batch.k, ANY_K):
            gd, gi = mk.masked_topk_blocks(*args, pred=pred, k=k)
            pd, pi = mk.masked_topk_blocks_plain(*args, pred=pred, k=k)
            errs["masked_topk_blocks"] = max(errs["masked_topk_blocks"],
                                             hold_to_plain(
                "masked_topk_blocks", pred, args, gd, gi, pd, pi, tol))
            del gd, gi, pd, pi
        qv, qb = qv[:DEFAULT_QCHUNK], qb[:DEFAULT_QCHUNK]
        args = (qv.bfloat16(), qb, base16, dd.norms, dd.bitmaps)
        gd, gi = mk.masked_topk_accum(*args, pred=pred, k=10)
        pd, pi = mk.masked_topk_plain(*args, pred=pred, k=10)
        errs["masked_topk_bf16"] = max(errs["masked_topk_bf16"],
                                       hold_to_plain(
            "masked_topk_bf16", pred, args, gd, gi, pd, pi, tol))
    del base16
    emit("kernels.slice2_check", merge_topk_cases=merge_cases,
         merge_topk="bit-identical", tie_grid_cases=tie_cases,
         masked_topk_blocks_tie_grid="bit-identical",
         masked_topk_bf16_tie_grid="bit-identical", **errs)
    return {"merge_topk": 0.0, **errs}


def time_kernels(fx, batches: dict, dev) -> dict:
    """Kernel and plain-version times on the path's inputs: masked_topk on
    the first 64-query chunk of each predicate's exact-search batch,
    selectivity on the whole batch (the routing stage's 256 queries).
    Returns per-kernel sums over the three predicates."""
    dd = fx.device
    n, w = dd.bitmaps.shape
    d = dd.vectors.shape[1]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    out = {name: dict(ms=0.0, plain_ms=0.0, bound_s=0.0, ops_s=0.0,
                      bytes_s=0.0) for name in ("masked_topk", "selectivity")}

    def add(name, ms, plain_ms, bound):
        o = out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        o["bound_s"] += max(bound)
        o["ops_s"] += bound[0]
        o["bytes_s"] += bound[1]
    for pred, batch in batches.items():
        qv = to_device(batch.vectors[:DEFAULT_QCHUNK], dev)
        qb = to_device(batch.bitmaps[:DEFAULT_QCHUNK], dev)
        base = (qv, qb, dd.vectors, dd.norms, dd.bitmaps)
        ms = time_ms(lambda: mk.masked_topk_accum(*base, pred=pred, k=10),
                     10, flush)
        pms = time_ms(lambda: mk.masked_topk_plain(*base, pred=pred, k=10),
                      5, flush)
        bound = masked_topk_bound(
            mk._predicate_mask_block(dd.bitmaps, qb, pred), d, w, 10)
        add("masked_topk", ms, pms, bound)

        qball = to_device(batch.bitmaps, dev)
        sms = time_ms(lambda: bf.selectivity_count(qball, dd.bitmaps,
                                                   pred=pred),
                      20, flush)
        spms = time_ms(lambda: bf.selectivity_plain(qball, dd.bitmaps,
                                                    pred=pred),
                       5, flush)
        sbound = selectivity_bound(batch.q, n, w)
        add("selectivity", sms, spms, sbound)
        emit("kernels.time", pred=PRED_NAMES[pred], masked_topk_q=qv.shape[0],
             masked_topk_ms=ms, masked_topk_plain_ms=pms,
             masked_topk_bound_ms=max(bound) * 1e3,
             masked_topk_bound_ops_ms=bound[0] * 1e3,
             masked_topk_bound_bytes_ms=bound[1] * 1e3,
             selectivity_q=batch.q, selectivity_ms=sms,
             selectivity_plain_ms=spms, selectivity_bound_ms=max(sbound) * 1e3,
             selectivity_bound_ops_ms=sbound[0] * 1e3,
             selectivity_bound_bytes_ms=sbound[1] * 1e3)

    # selectivity at the other width classes, 256 queries over as many
    # rows as the dataset's (random label patterns): W = 1 and 13 in
    # registers, W = 63 chunked
    rng = np.random.default_rng(2)
    widths = out["selectivity"]["widths"] = {}
    for ww in (1, 13, 63):
        per = widths[ww] = {"ms": [], "bound_ms": max(
            selectivity_bound(QUERIES, n, ww)) * 1e3}
        for pred in range(3):
            qbt, bmt = on_card(dev, *pattern_bitmaps(rng, QUERIES, n, ww,
                                                     pred))
            per["ms"].append(time_ms(lambda: bf.selectivity_count(
                qbt, bmt, pred=pred), 20, flush))
            del qbt, bmt
    emit("kernels.time_selectivity_widths", q=QUERIES, n=n, widths=widths)
    del flush
    return out


def time_slice2_kernels(fx, sfx, batches: dict, dev) -> dict:
    """Kernel, plain-version and library times on the paths' inputs:
    masked_topk_blocks on each predicate's whole 256-query exact batch (as
    ops.masked_topk_multiblock gets it), bf16 masked_topk on its first
    64-query chunk (as masked_topk is timed), merge_topk on the
    [4, 256, 10] candidates the shards return for that batch. Returns
    per-kernel sums over the three predicates."""
    dd = fx.device
    n, w = dd.bitmaps.shape
    d = dd.vectors.shape[1]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    out = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_s=0.0,
                      ops_s=0.0, bytes_s=0.0)
           for name in ("masked_topk_blocks", "merge_topk")}
    out["masked_topk_blocks"].update(k200_ms=0.0, k200_bound_s=0.0)

    def add(name, ms, plain_ms, bound, library_ms=0.0):
        o = out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        o["library_ms"] += library_ms
        o["bound_s"] += max(bound)
        o["ops_s"] += bound[0]
        o["bytes_s"] += bound[1]
    prefilter = get_method("prefilter")
    setting = prefilter.param_settings()[0]
    base16 = dd.vectors.bfloat16()
    for pred, batch in batches.items():
        qv = to_device(batch.vectors, dev)
        qb = to_device(batch.bitmaps, dev)
        args = (qv, qb, dd.vectors, dd.norms, dd.bitmaps)
        ms = time_ms(lambda: mk.masked_topk_blocks(*args, pred=pred,
                                                   k=batch.k), 10, flush)
        pms = time_ms(lambda: mk.masked_topk_blocks_plain(*args, pred=pred,
                                                          k=batch.k),
                      5, flush)
        mask = mk._predicate_mask_block(dd.bitmaps, qb, pred)
        nb = -(-n // mk.DEFAULT_BN)

        def blocks_bound(k):
            t_ops, t_bytes = masked_topk_bound(mask, d, w, k)
            return (t_ops, t_bytes + (nb - 1) * batch.q * k * 8
                    / HBM_BYTES_S)
        bound = blocks_bound(batch.k)
        add("masked_topk_blocks", ms, pms, bound)
        b200_ms = time_ms(lambda: mk.masked_topk_blocks(*args, pred=pred,
                                                        k=ANY_K), 10, flush)
        b200 = blocks_bound(ANY_K)
        out["masked_topk_blocks"]["k200_ms"] += b200_ms
        out["masked_topk_blocks"]["k200_bound_s"] += max(b200)
        del mask
        args16 = (qv[:DEFAULT_QCHUNK].bfloat16(), qb[:DEFAULT_QCHUNK],
                  base16, dd.norms, dd.bitmaps)
        bf16_ms = time_ms(lambda: mk.masked_topk_accum(*args16, pred=pred,
                                                       k=batch.k), 10, flush)

        ids, raw = stack_candidates(sfx.shard_candidates(prefilter, setting,
                                                         batch))
        dt, it = on_card(dev, raw, ids)
        s_, q_, kk = dt.shape
        flat = dt.transpose(0, 1).reshape(q_, s_ * kk).contiguous()
        mms = time_ms(lambda: mk.merge_topk_accum(dt, it, k=batch.k), 20,
                      flush)
        mpms = time_ms(lambda: mk.merge_topk_plain(dt, it, k=batch.k), 10,
                       flush)
        lms = time_ms(lambda: torch.topk(flat, batch.k, dim=1,
                                         largest=False), 20, flush)
        mbound = merge_topk_bound(s_, q_, kk, batch.k)
        add("merge_topk", mms, mpms, mbound, lms)
        emit("kernels.time2", pred=PRED_NAMES[pred],
             masked_topk_bf16_ms=bf16_ms,
             masked_topk_blocks_q=batch.q, masked_topk_blocks_ms=ms,
             masked_topk_blocks_plain_ms=pms,
             masked_topk_blocks_bound_ms=max(bound) * 1e3,
             masked_topk_blocks_k200_ms=b200_ms,
             masked_topk_blocks_k200_bound_ms=max(b200) * 1e3,
             merge_topk_shape=[s_, q_, kk], merge_topk_ms=mms,
             merge_topk_plain_ms=mpms, merge_topk_torch_topk_ms=lms,
             merge_topk_bound_ms=max(mbound) * 1e3)
    del flush, base16
    return out


def check_slice4_grids(dev) -> dict:
    """Slice 4's kernels against their plain versions on grids, bit for
    bit: the select of the k > 128 paths (k = 129, 200, 1,016 and 20,000,
    the last past the shared-memory sort; every passing key equal, so
    the ties at T straddle the blocks' ranges; a query that passes no
    row; k past N), `merge_topk` at k = 200 in warp and block mode,
    `fused_live` at k = 200 with and without `sel` and a −0.0 base
    candidate, `masked_topk_blocks` at k = 200 with a ragged last block,
    and the register-blocked scan at odd and wide D, bf16, W = 1 and 8
    and query counts that are not a multiple of the block's. Returns the
    number of cases of each."""
    rng = np.random.default_rng(4)
    cases = {"select": 0, "merge_topk": 0, "fused_live": 0,
             "masked_topk_blocks": 0, "scan": 0}

    def same(what, got, want, bits=False):
        torch.cuda.synchronize()
        (gd, gi), (pd, pi) = got, want
        eq_d = (torch.equal(gd.view(torch.int32), pd.view(torch.int32))
                if bits else torch.equal(gd, pd))
        if not (torch.equal(gi, pi) and eq_d):
            raise AssertionError(f"{what} differs from its plain version")
        cases[what.split(" ")[0]] += 1

    qv, qb, base, norms, bm = tie_case(rng, 4, 100_003)
    base[:] = base[0]                      # every passing key equal
    norms[:] = norms[0]
    bm[rng.random(bm.shape[0]) < 0.3] = 0
    qb[1] = 0x7fffffff                     # AND/EQUALITY: no row passes
    flat = on_card(dev, qv, qb, base, norms, bm)
    for k in (129, ANY_K, 1016, 20_000):
        for pred in range(3):
            same(f"select flat k {k} pred {pred}",
                 mk.masked_topk_large(*flat, pred=pred, k=k),
                 mk.masked_topk_plain(*flat, pred=pred, k=k))
    for q, n, k in [(3, 5000, 6000), (33, 70_001, ANY_K), (2, 4097, 129)]:
        args = on_card(dev, *tie_case(rng, q, n))
        for pred in range(3):
            same(f"select q {q} n {n} k {k} pred {pred}",
                 mk.masked_topk_large(*args, pred=pred, k=k),
                 mk.masked_topk_plain(*args, pred=pred, k=k))
    for s_, q, kk in [(3, 40, 100), (977, 9, 10), (40, 7, 30)]:
        dt, it = on_card(dev, *merge_grid(rng, s_, q, kk))
        same(f"merge_topk S {s_}", mk.merge_topk_accum(dt, it, k=ANY_K),
             mk.merge_topk_plain(dt, it, k=ANY_K), bits=True)
    base_n = 5000
    for q, kb, nd, ns in [(37, 1016, 5000, None), (20, 1016, 70_000, 30_000),
                          (5, 300, 200, None), (33, 0, 9000, 6000)]:
        *arrays, sel = live_grid(rng, q, kb, nd, base_n, ns)
        if kb:
            arrays[2][:, 0], arrays[2][:, 1] = np.float32(0.0), np.float32(-0.0)
        args = on_card(dev, *arrays)
        s = None if sel is None else on_card(dev, sel)[0]
        for pred in range(3):
            same(f"fused_live KB {kb} sel {ns} pred {pred}",
                 mk.fused_live_accum(*args, base_n=base_n, sel=s, pred=pred,
                                     k=ANY_K),
                 mk.fused_live_plain(*args, base_n=base_n, sel=s, pred=pred,
                                     k=ANY_K), bits=True)
    for q, n, bn in [(7, 5000, 1000), (3, 20_000, 8192), (40, 3001, 256)]:
        args = on_card(dev, *tie_case(rng, q, n))
        for pred in range(3):
            same(f"masked_topk_blocks n {n} bn {bn} pred {pred}",
                 mk.masked_topk_blocks(*args, pred=pred, k=ANY_K, bn=bn),
                 mk.masked_topk_blocks_plain(*args, pred=pred, k=ANY_K,
                                             bn=bn), bits=True)
    for q, n, d, w in [(33, 3001, 5, 1), (45, 5000, 192, 8),
                       (17, 2500, 192, 1), (70, 4099, 37, 3),
                       (3, 700, 1300, 2)]:
        args = on_card(dev, *tie_case(rng, q, n, d, w))
        b16 = (args[0].bfloat16(), args[1], args[2].bfloat16(), *args[3:])
        for a in (args, b16):
            for pred in range(3):
                for k in (10, ANY_K):
                    same(f"scan q {q} d {d} w {w} {a[0].dtype} k {k}",
                         mk.masked_topk_accum(*a, pred=pred, k=k),
                         mk.masked_topk_plain(*a, pred=pred, k=k))
    return cases


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def check_result(ds, batch, res, what: str) -> None:
    """Shapes, id range, finite exact distances that agree with a float64
    recomputation, and every returned row passing the predicate."""
    ids, dist = res.ids, res.distances
    if ids.shape != (batch.q, batch.k) or dist.shape != ids.shape:
        raise AssertionError(f"{what}: shapes {ids.shape} / {dist.shape}")
    if ids.min() < -1 or ids.max() >= ds.n:
        raise AssertionError(f"{what}: ids outside [-1, {ds.n})")
    ok = ids >= 0
    if not np.isfinite(dist[ok]).all() or not np.isnan(dist[~ok]).all():
        raise AssertionError(f"{what}: distances not finite at real ids")
    safe = np.maximum(ids, 0)
    exact = ((ds.vectors[safe].astype(np.float64)
              - batch.vectors[:, None, :].astype(np.float64)) ** 2).sum(-1)
    scale = ((np.linalg.norm(ds.vectors[safe], axis=-1)
              + np.linalg.norm(batch.vectors, axis=-1)[:, None]) ** 2)
    tol = 4 * ds.dim * 2.0 ** -24 * scale
    if (np.abs(exact - dist)[ok] > tol[ok]).any():
        raise AssertionError(f"{what}: distances disagree with float64")
    passes = eval_predicate_np(ds.bitmaps[safe], batch.bitmaps[:, None, :],
                               batch.pred)
    if not passes[ok].all():
        raise AssertionError(f"{what}: a returned row fails the predicate")


def hold_against_ground_truth(ds, batch, ids, n_gt: int) -> int:
    """The first `n_gt` queries' exact-search ids against numpy brute
    force: equal, or equal in their sorted float64 distances up to fp32
    summation order (near-ties may swap). Returns the count of queries
    whose ids are identical."""
    gt = ground_truth_topk(ds, batch.vectors[:n_gt], batch.bitmaps[:n_gt],
                           batch.pred, batch.k)
    same = 0
    for qi in range(n_gt):
        a, b = ids[qi], gt[qi]
        if np.array_equal(a, b):
            same += 1
            continue
        if not np.array_equal(a >= 0, b >= 0):
            raise AssertionError(f"query {qi}: fill differs from ground truth")
        q = batch.vectors[qi].astype(np.float64)

        def dists(x):
            v = ds.vectors[x[x >= 0]].astype(np.float64)
            return np.sort(((v - q) ** 2).sum(1))

        da, db = dists(a), dists(b)
        tol = 4 * ds.dim * 2.0 ** -24 * (np.sqrt(db.max()) +
                                         2 * np.linalg.norm(q)) ** 2
        if np.abs(da - db).max() > tol:
            raise AssertionError(
                f"query {qi}: exact-search ids are not a top-k "
                f"({np.abs(da - db).max()} > {tol})")
    return same


def build_indexes(fx, names) -> float:
    """Every build setting of the methods `names` on the handle `fx`, one
    line each with its seconds and its peak device memory (the fvamana
    graph builds on the card of a CUDA handle). Returns the largest
    peak in MB."""
    peak = 0.0
    for name in names:
        method = get_method(name)
        for build in dict.fromkeys(s.build for s in method.param_settings()):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fx.get_index(method, build)
            torch.cuda.synchronize()
            mb = torch.cuda.max_memory_allocated() / 1e6
            peak = max(peak, mb)
            emit("path.build", method=name, build=dict(build),
                 seconds=time.perf_counter() - t0, peak_device_mb=mb,
                 on=("card" if method.builds_on_device
                     and fx.torch_device.type == "cuda" else "host"))
    return peak


def run_path(fx, router_dir: str, nq: int, n_gt: int, seed: int = 11):
    """The main path on the handle `fx`. Returns (the exact-search query
    sets with their ground truth, the routed batches, the service, a
    summary, the table-B rows)."""
    ds = fx.ds
    summary = {}
    names = list(candidate_methods())

    # (a) exact search, held against numpy ground truth
    t0 = time.perf_counter()
    exact = {}
    for pred in PREDICATES:
        qs = make_queries(ds, pred, nq, seed=seed, with_ground_truth=False)
        batch = QueryBatch.from_queryset(qs)
        res = fx.search(batch, "prefilter")
        check_result(ds, batch, res, f"prefilter {pred.name}")
        same = hold_against_ground_truth(ds, batch, res.ids, n_gt)
        exact[int(pred)] = dataclasses.replace(qs, ground_truth=res.ids)
        emit("path.exact", pred=pred.name, q=batch.q,
             search_s=res.timings["search_s"],
             matched=int((res.ids >= 0).sum()),
             gt_queries=n_gt, gt_identical=same)
    summary["exact_s"] = time.perf_counter() - t0

    # (b) the offline stage: the candidates' indexes, then table-B rows
    #     for this deployment dataset
    t0 = time.perf_counter()
    build_peak = build_indexes(fx, names)
    summary["build_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = []
    for name in names:
        method = get_method(name)
        for setting in method.param_settings():
            for pred in PREDICATES:
                r = bench.run_method(fx, method, setting, exact[int(pred)])
                rows.append(r)
                emit("path.table", method=name, ps=setting.ps_id,
                     pred=pred.name, recall=r.mean_recall, qps=r.qps)
    summary["table_s"] = time.perf_counter() - t0

    # (c) online stage: route and serve fresh batches
    t0 = time.perf_counter()
    router = MLRouter.load(router_dir)
    for r in rows:
        router.table.add(ds.name, r.pred, r.method, r.ps_id, r.mean_recall,
                         r.qps)
    svc = RouterService(fx, router, t=0.9)
    t1 = time.perf_counter()
    F.dataset_features(ds, fx=fx)       # once per handle, cached on it
    emit("path.dataset_features", seconds=time.perf_counter() - t1)
    recalls, routed, chosen = {}, {}, {}
    for pred in PREDICATES:
        qs = make_queries(ds, pred, nq, seed=seed + 1,
                          with_ground_truth=False)
        batch = routed[int(pred)] = QueryBatch.from_queryset(qs)
        res = svc.search(batch)
        check_result(ds, batch, res, f"routed {pred.name}")
        truth = fx.search(batch, "prefilter").ids
        rec = float(recall_at_k(res.ids, truth).mean())
        recalls[pred.name] = rec
        hist = {}
        for m, ps in res.decisions:
            hist[f"{m}/{ps}"] = hist.get(f"{m}/{ps}", 0) + 1
            chosen[m] = chosen.get(m, 0) + 1
        emit("path.routed", pred=pred.name, q=batch.q, recall_at_10=rec,
             decisions=hist, route_s=res.timings["route_s"],
             search_s=res.timings["search_s"])
        if pred == Predicate.AND:        # mixed decisions
            chunked = svc.search_chunked(batch, chunk=64)
            if not (np.array_equal(chunked.ids, res.ids)
                    and chunked.decisions == res.decisions):
                raise AssertionError(
                    "search_chunked disagrees with search on one batch")
            emit("path.routed_chunked", pred=pred.name, q=batch.q, chunk=64,
                 route_s=chunked.timings["route_s"],
                 search_s=chunked.timings["search_s"],
                 same_as_search=True)
    summary["routed_s"] = time.perf_counter() - t0
    summary["recall_at_10"] = recalls
    summary["decisions"] = chosen
    summary["peak_device_mb"] = max(
        build_peak, torch.cuda.max_memory_allocated() / 1e6)
    return exact, routed, svc, summary, rows


def build_on(fxs, names) -> dict:
    """Every build setting of the methods `names` on each `FilteredIndex`
    in `fxs` (a live handle's base, or each shard's), before a path's
    launch counts are set to 0, so that its routed timings are those of
    serving. Returns the seconds of each method over all of `fxs`."""
    out = {}
    for name in names:
        method = get_method(name)
        t0 = time.perf_counter()
        for build in dict.fromkeys(s.build for s in method.param_settings()):
            for fx in fxs:
                fx.get_index(method, build)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    return out


# The graph graft's steps `method_seconds` times, by their names in
# `repro_torch.ann.graph`; `step_seconds` fails if a graft ran without one
GRAFT_STEPS = ("beam_search", "_graft_edges_torch", "_back_insert")


@contextlib.contextmanager
def method_seconds():
    """Time every method build and graft run while the block runs (a
    compaction's): each registered method's `build` and `graft_index`
    wrapped for the block, the card synchronised around each call; and
    the steps of the graph graft (`graph.beam_search`, the new rows'
    edges on the card, the host's reverse-edge loop `_back_insert`).
    Yields the list of {method, step, seconds, grafted} it fills;
    `step_seconds` sums it by method and step."""
    calls = []
    methods = [get_method(n) for n in all_methods()]

    def timed(fn, name, step):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls.append({"method": name, "step": step,
                          "seconds": time.perf_counter() - t0,
                          "grafted": step == "graft" and out is not None})
            return out
        return call

    for m in methods:
        m.build = timed(m.build, m.name, "build")
        m.graft_index = timed(m.graft_index, m.name, "graft")
    saved = {p: getattr(graph, p) for p in GRAFT_STEPS}
    for p in GRAFT_STEPS:
        setattr(graph, p, timed(saved[p], "fvamana", "graft." + p))
    try:
        yield calls
    finally:
        for m in methods:
            del m.build, m.graft_index
        for p in GRAFT_STEPS:
            setattr(graph, p, saved[p])


def step_seconds(calls) -> dict:
    """`method_seconds`'s calls summed by method: graft and build seconds
    (over every build setting and shard), the graph graft's steps
    (`graft.beam_search_s`, ...), and whether a graft took. Fails when
    fvamana grafted but a step of `GRAFT_STEPS` was never timed."""
    out = {}
    for c in calls:
        o = out.setdefault(c["method"], {"graft_s": 0.0, "build_s": 0.0,
                                         "grafted": False})
        key = c["step"] + "_s"
        o[key] = o.get(key, 0.0) + c["seconds"]
        o["grafted"] |= c["grafted"]
    fv = out.get("fvamana", {})
    missing = [p for p in GRAFT_STEPS
               if fv.get("grafted") and "graft." + p + "_s" not in fv]
    if missing:
        raise AssertionError(f"the fvamana graft ran without the timed "
                             f"steps {missing}: graph.graft_graph no "
                             f"longer calls them by these names")
    return out


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def stage_summary(timings: dict) -> dict:
    return {k: v for k, v in timings.items()
            if k in ("route_s", "search_s", "shard_max_s", "merge_s")
            or (k.startswith("shard") and k.endswith("_s"))}


def single_index_answers(fx, svc, exact: dict, routed: dict) -> dict:
    """What `run_sharded` holds the sharded path to, from the single index
    `fx` and its service `svc`, made before the sharded path's launch
    counts are set to 0: each exact batch's `fx.search(batch,
    "prefilter")` and each routed batch's decisions."""
    return {"exact": {p: fx.search(QueryBatch.from_queryset(qs), "prefilter")
                      for p, qs in exact.items()},
            "decisions": {p: svc.route(b) for p, b in routed.items()}}


def run_sharded(sfx, ds, svc, exact: dict, routed: dict, want: dict) -> dict:
    """The sharded path on the handle `sfx` over the dataset `ds`: (a)
    exact search of each predicate's batch, bit-identical to the single
    index's answer in `want` (`single_index_answers`); (b) routed serving
    through `ShardedRouterService` with the router of the single-index
    service `svc`: the decisions in `want`, every row passing its
    predicate with float64-exact distances, recall@10 against the
    sharded exact answer. Returns a summary."""
    out = {"recall_at_10": {}}
    t0 = time.perf_counter()
    for pred, qs in exact.items():
        batch = QueryBatch.from_queryset(qs)
        res = sfx.search(batch, "prefilter")
        single = want["exact"][pred]
        if not (np.array_equal(res.ids, single.ids) and np.array_equal(
                res.distances.view(np.int32),
                single.distances.view(np.int32))):
            raise AssertionError(f"sharded exact search differs from the "
                                 f"single index, {PRED_NAMES[pred]}")
        emit("sharded.exact", pred=PRED_NAMES[pred], q=batch.q,
             bit_identical=True, **stage_summary(res.timings))
    out["exact_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ssvc = ShardedRouterService(sfx, svc.router, t=svc.t)
    # what the single index built in its table stage, built here first so
    # that the routed timings below are those of serving: each shard's
    # IVF index for each candidate method, the full-dataset feature
    # tensors, the dataset-level features
    t1 = time.perf_counter()
    for name in svc.router.methods:
        method = ssvc.methods[name]
        for setting in method.param_settings():
            for shard in sfx.shards:
                shard.get_index(method, setting.build)
    t2 = time.perf_counter()
    F.dataset_features(ds, fx=sfx)       # once per handle, cached on it
    sfx.device
    torch.cuda.synchronize()
    emit("sharded.build", shard_indexes_s=t2 - t1,
         features_s=time.perf_counter() - t2,
         built=sfx.stats()["shards"][0]["built_indexes"])
    for pred, batch in routed.items():
        res = ssvc.search(batch)
        if res.decisions != want["decisions"][pred]:
            raise AssertionError(f"sharded routing decisions differ from "
                                 f"the single-index service's, "
                                 f"{PRED_NAMES[pred]}")
        check_result(ds, batch, res, f"sharded routed {PRED_NAMES[pred]}")
        truth = sfx.search(batch, "prefilter").ids
        rec = float(recall_at_k(res.ids, truth).mean())
        out["recall_at_10"][PRED_NAMES[pred]] = rec
        hist = {}
        for m, ps in res.decisions:
            hist[f"{m}/{ps}"] = hist.get(f"{m}/{ps}", 0) + 1
        emit("sharded.routed", pred=PRED_NAMES[pred], q=batch.q,
             recall_at_10=rec, decisions=hist, same_decisions=True,
             **stage_summary(res.timings))
    out["routed_s"] = time.perf_counter() - t0
    return out


def queue_workload(sfx, svc_sharded, exact: dict, n_per_pred: int) -> dict:
    """The queue's single queries, `n_per_pred` of each predicate (from
    the query sets or batches `exact`) in a mixed order, with what
    `run_queue` holds them to: the batched route's decisions and the
    batched exact search's ids."""
    subs, want_dec, want_ids = [], [], []
    for pred, qs in exact.items():
        batch = QueryBatch(qs.vectors[:n_per_pred], qs.bitmaps[:n_per_pred],
                           pred, qs.k)
        want_dec += svc_sharded.route(batch)
        want_ids += list(sfx.search(batch, "prefilter").ids)
        subs += [(pred, batch.vectors[i], batch.bitmaps[i])
                 for i in range(batch.q)]
    return {"subs": subs, "decisions": want_dec, "ids": want_ids,
            "order": np.random.default_rng(3).permutation(len(subs))}


def run_queue(sfx, svc_sharded, work: dict, threads: int = 8,
              label: str = "queue") -> dict:
    """`AsyncBatchQueue` over the sharded service: the single queries of
    `work` (`queue_workload`) submitted from `threads` threads, once
    routed (each answer's decision equals the batched route's) and once
    with `method="prefilter"` (each answer's ids equal the batched exact
    search's). Returns the two queues' stats."""
    subs, order = work["subs"], work["order"]

    def serve(queue):
        futs = [None] * len(subs)

        def work(t):
            for j in order[t::threads]:
                pred, v, b = subs[j]
                futs[j] = queue.submit(v, b, pred)

        workers = [threading.Thread(target=work, args=(t,))
                   for t in range(threads)]
        for th in workers:
            th.start()
        for th in workers:
            th.join(timeout=300)
        if any(th.is_alive() for th in workers):
            raise AssertionError("queue submitters did not finish")
        return [f.result(timeout=300) for f in futs]

    stats = {}
    t0 = time.perf_counter()
    with AsyncBatchQueue(svc_sharded, max_batch=32, max_wait_ms=5) as q:
        got = serve(q)
        stats["routed"] = q.stats()
    stats["routed"]["seconds"] = time.perf_counter() - t0
    if [r.decision for r in got] != work["decisions"]:
        raise AssertionError("queue decisions differ from the batched "
                             "routed search's")
    t0 = time.perf_counter()
    with AsyncBatchQueue(sfx, max_batch=32, max_wait_ms=5,
                         method="prefilter") as q:
        got = serve(q)
        stats["exact"] = q.stats()
    stats["exact"]["seconds"] = time.perf_counter() - t0
    if not all(np.array_equal(r.ids, ids)
               for r, ids in zip(got, work["ids"])):
        raise AssertionError("queue ids differ from the batched exact "
                             "search's")
    for name, st in stats.items():
        emit(f"{label}.{name}", queries=st["queries"], batches=st["batches"],
             flush_reasons=st["flush_reasons"],
             max_batch_seen=st["max_batch_seen"],
             max_queue_depth=st["max_queue_depth"], seconds=st["seconds"],
             threads=threads, same_as_batched=True)
    return stats


def run_multiblock(fx, exact_batches: dict) -> None:
    """The second entry point of exact search: `ops.masked_topk_multiblock`
    on each exact batch equals `ops.masked_topk` bit for bit."""
    dd = fx.device
    for pred, batch in exact_batches.items():
        qv = to_device(batch.vectors, fx.torch_device)
        qb = to_device(batch.bitmaps, fx.torch_device)
        args = (qv, qb, dd.vectors, dd.norms, dd.bitmaps)
        ids, dists = ops.masked_topk_multiblock(*args, pred=pred, k=batch.k)
        want_i, want_d = ops.masked_topk(*args, pred=pred, k=batch.k)
        if not (torch.equal(ids, want_i) and torch.equal(
                dists.view(torch.int32), want_d.view(torch.int32))):
            raise AssertionError(f"masked_topk_multiblock differs from "
                                 f"masked_topk, {PRED_NAMES[pred]}")
        emit("multiblock", pred=PRED_NAMES[pred], q=batch.q,
             same_as_masked_topk=True)


# ---------------------------------------------------------------------------
# phase 8: the live slice
# ---------------------------------------------------------------------------

def fused_live_bound(mask, d: int, w: int, kb: int, k: int, tw: int,
                     has_sel: bool) -> tuple[float, float]:
    """(operations time, bytes time) in seconds for one fused_live launch
    whose scanned delta rows give `mask`, the [Q, NS] passing and live
    (query, row) pairs: the base candidates (8 bytes a slot), the scanned
    rows' label words (and `sel`), the tombstone words, the vectors and
    norms of rows some query passes and the queries, each read once;
    [Q, k] written once; fp32 work 2·D + 2 per passing pair, one 32-bit
    op per (query, scanned row, word) for the predicate and one per
    (query, candidate) for the fold."""
    q, ns = mask.shape
    rows = int(mask.any(0).sum())
    pairs = int(mask.sum())
    nbytes = (q * kb * 8 + ns * w * 4 + (ns * 4 if has_sel else 0)
              + tw * 4 + rows * (d + 1) * 4 + q * (d + w) * 4 + q * k * 8)
    t_ops = (pairs * (2 * d + 2) / FP32_FLOPS
             + (q * ns * w + q * kb) / INT32_OPS)
    return t_ops, nbytes / HBM_BYTES_S


def live_grid(rng, q: int, kb: int, nd: int, base_n: int, ns=None,
              d: int = 24, w: int = 2):
    """Fused-live inputs on the tie grid: base candidates with −1 ids,
    NaN, ±inf, values past PAD_SCORE and ±0.0; a delta mirror with
    duplicated rows; one in five base and delta ids tombstoned; an
    optional pruner-style sel (sorted rows, −1 pads). Returns numpy
    (qv, qb, cand_d, cand_i, dvec, dnorm, dbm, tomb_words, sel)."""
    qv, qb, dvec, dn, dbm = tie_case(rng, q, max(nd, 1), d, w)
    dvec, dn, dbm = dvec[:nd], dn[:nd], dbm[:nd]
    cd = (rng.integers(-40, 400, (q, kb)) / 4.0).astype(np.float32)
    ci = rng.integers(0, base_n, (q, kb)).astype(np.int32)
    for val, frac in ((np.nan, 0.03), (np.inf, 0.03), (-np.inf, 0.02),
                      (np.float32(3.1e38), 0.02), (np.float32(-0.0), 0.05),
                      (np.float32(0.0), 0.05)):
        cd[rng.random(cd.shape) < frac] = val
    ci[rng.random(ci.shape) < 0.1] = -1
    tomb = rng.random(base_n + nd) < 0.2
    words = np.zeros(-(-(base_n + nd) // 4096) * 128, np.uint32)
    packed = np.packbits(tomb, bitorder="little")
    words.view(np.uint8)[: packed.size] = packed
    sel = None
    if ns is not None:
        sel = np.sort(rng.choice(nd, size=min(ns, nd), replace=False)
                      ).astype(np.int32)
        sel = np.concatenate([sel, np.full(3, -1, np.int32)])
    return qv, qb, cd, ci, dvec, dn, dbm, words, sel


def check_live_grids(dev) -> int:
    """`fused_live` (both variants) and the k > MAX_K masked top-k against
    their plain versions on grids: ids and distance bits. Returns the
    number of cases."""
    rng = np.random.default_rng(2)
    cases = 0
    for q, n, k in [(3, 2000, 129), (64, 100_003, 1016), (5, 1001, 10_000),
                    (2, 40_000, 20_000), (17, 5000, 512)]:
        args = on_card(dev, *tie_case(rng, q, n))
        for pred in range(3):
            gd, gi = mk.masked_topk_large(*args, pred=pred, k=k)
            pd, pi = mk.masked_topk_plain(*args, pred=pred, k=k)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(gd, pd)):
                raise AssertionError(
                    f"masked_topk_large differs from its plain version on "
                    f"the tie grid: pred {pred}, q {q}, n {n}, k {k}")
            cases += 1
    base_n = 5000
    for q, kb, nd, k, ns in [(5, 1, 200, 10, None), (37, 1016, 5000, 10, None),
                             (20, 1016, 70_000, 10, 30_000),
                             (3, 50, 2000, 128, 700), (6, 20, 0, 10, None),
                             (256, 1016, 65_536, 10, 20_000)]:
        *arrays, sel = live_grid(rng, q, kb, nd, base_n, ns)
        args = on_card(dev, *arrays)
        s = None if sel is None else on_card(dev, sel)[0]
        for pred in range(3):
            gd, gi = mk.fused_live_accum(*args, base_n=base_n, sel=s,
                                         pred=pred, k=k)
            pd, pi = mk.fused_live_plain(*args, base_n=base_n, sel=s,
                                         pred=pred, k=k)
            torch.cuda.synchronize()
            if not (torch.equal(gi, pi) and torch.equal(
                    gd.view(torch.int32), pd.view(torch.int32))):
                raise AssertionError(
                    f"fused_live differs from its plain version on the "
                    f"grid: pred {pred}, q {q}, KB {kb}, ND {nd}, k {k}, "
                    f"sel {ns}")
            cases += 1
    return cases


def live_kernel_inputs(live, batch):
    """The fused_live kernel's inputs on the live read path for `batch`,
    made as `LiveFilteredIndex._run_fused` makes them: the base
    overfetch's candidates, the delta mirror, the packed tombstones, the
    pruner's rows (None when it keeps every row). Returns (args, kwargs)
    for `mk.fused_live_accum` / `mk.fused_live_plain`, plus the
    overfetch width."""
    dev = live.torch_device
    prefilter = get_method("prefilter")
    with live.snapshot() as snap:
        dead = int(snap.tombstones[: snap.base_n].sum())
        b_ids, b_raw = live._run_base(prefilter, prefilter.param_settings()[0],
                                      batch, snap, dead)
        dvec, dnorm, dbm = snap.delta.device_view(snap.delta_rows)
        tomb = live._tomb_words(snap)
        sel = live._delta_select(snap, batch, b_ids, b_raw)
        base_n = snap.base_n
    args = (to_device(batch.vectors, dev), to_device(batch.bitmaps, dev),
            to_device(b_raw, dev), to_device(b_ids, dev), dvec, dnorm, dbm,
            tomb)
    kw = {"base_n": base_n, "sel": None if sel is None else to_device(sel, dev)}
    return args, kw, b_ids.shape[1]


def own_scores(args, kw, ids):
    """Each returned id's own score: a base id its candidate distance, a
    delta id its ‖v‖² − 2·q·v in float64. [Q, k] float64, +inf at −1."""
    qv, _, cd, ci, dvec, dnorm, _, _ = args
    base_n = kw["base_n"]
    out = torch.full(ids.shape, float("inf"), dtype=torch.float64,
                     device=ids.device)
    is_base = (ids >= 0) & (ids < base_n)
    match = (ids[:, :, None] == ci[:, None, :]) & is_base[:, :, None]
    base_d = torch.where(match, cd[:, None, :].double(),
                         torch.full_like(match, float("inf"),
                                         dtype=torch.float64)).amin(-1)
    out = torch.where(is_base, base_d, out)
    rows = (ids.long() - base_n).clamp(0, max(dvec.shape[0] - 1, 0))
    dots = (qv.double()[:, None, :] * dvec.double()[rows]).sum(-1)
    delta_d = dnorm.double()[rows] - 2.0 * dots
    return torch.where(ids >= base_n, delta_d, out)


def hold_fused_to_plain(pred: int, args, kw, gd, gi, pd, pi,
                        tol: float) -> float:
    """The fused kernel's output against its plain version's on the live
    path's random floats, where the delta dots are summed in different
    orders: the fill is identical, distances agree to `tol`, every
    returned id carries its own score (its candidate distance, or its
    delta row's float64 score, within tol), passes the predicate, is
    live and comes once; ids may differ only where both ids' own scores
    lie within tol. Returns the largest distance difference."""
    torch.cuda.synchronize()
    if not torch.equal(gi < 0, pi < 0):
        raise AssertionError(f"fused_live fill differs, pred {pred}")
    real = gi >= 0
    err = float((gd - pd)[real].abs().max()) if bool(real.any()) else 0.0
    own_g, own_p = own_scores(args, kw, gi), own_scores(args, kw, pi)
    id_err = float((own_g - gd.double())[real].abs().max()) if bool(
        real.any()) else 0.0
    differ = (gi != pi) & real
    swap_err = float((own_g - own_p)[differ].abs().max()) if bool(
        differ.any()) else 0.0
    if max(err, id_err, swap_err) > tol:
        raise AssertionError(f"fused_live disagrees with its plain version, "
                             f"pred {pred}: {err} / {id_err} / {swap_err} "
                             f"> {tol}")
    qv, qb, _, _, _, _, dbm, tomb = args
    base_n = kw["base_n"]
    if bool(mk.tombstone_bits_plain(tomb, gi[real]).any()):
        raise AssertionError(f"fused_live returned a dead id, pred {pred}")
    delta = (gi >= base_n)
    rows = (gi.long() - base_n).clamp(min=0)
    passes = mk._predicate_mask_block(dbm, qb, pred).gather(
        1, rows.clamp(max=dbm.shape[0] - 1))
    if not bool(passes[delta].all()):
        raise AssertionError(f"fused_live returned a delta row that fails "
                             f"the predicate, pred {pred}")
    kept = torch.sort(gi.masked_fill(~real, -1), dim=1).values
    if bool(((kept[:, 1:] == kept[:, :-1]) & (kept[:, 1:] >= 0)).any()):
        raise AssertionError(f"fused_live returned an id twice, pred {pred}")
    return err


def check_live_path_kernels(live, batches: dict) -> dict:
    """The live path's kernels on its own inputs against their plain
    versions: `fused_live` on each exact batch's (256 queries, 1,016
    base candidates a query, the delta mirror, the pruner's rows) at the
    batch's k and at ANY_K, the k > MAX_K top-k on the first 64-query
    chunk of each base overfetch (k = 1,016 and ANY_K over the 1M base
    rows). Returns max abs errors."""
    dd = live.device
    d = dd.vectors.shape[1]
    errs = {"fused_live": 0.0, "masked_topk_large": 0.0}
    for pred, batch in batches.items():
        args, kw, kb = live_kernel_inputs(live, batch)
        qv, dvec = args[0], args[4]
        vn = max(float(dd.norms.max()), float((dvec ** 2).sum(1).max())) ** 0.5
        qn = float(qv.norm(dim=1).max())
        tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn)
        for k in (batch.k, ANY_K):
            gd, gi = mk.fused_live_accum(*args, **kw, pred=pred, k=k)
            pd, pi = mk.fused_live_plain(*args, **kw, pred=pred, k=k)
            err = hold_fused_to_plain(pred, args, kw, gd, gi, pd, pi, tol)
            errs["fused_live"] = max(errs["fused_live"], err)
            emit("live.kernels.fused_live.random", pred=PRED_NAMES[pred],
                 q=batch.q, kb=kb, k=k, delta_rows=int(dvec.shape[0]),
                 scanned=int(dvec.shape[0] if kw["sel"] is None
                             else kw["sel"].shape[0]),
                 max_abs_err=err, tol=tol,
                 ids_differing=int(((gi != pi) & (gi >= 0)).sum()))
        base = (qv[:DEFAULT_QCHUNK], args[1][:DEFAULT_QCHUNK], dd.vectors,
                dd.norms, dd.bitmaps)
        for k in (kb, ANY_K):
            gd, gi = mk.masked_topk_large(*base, pred=pred, k=k)
            pd, pi = mk.masked_topk_plain(*base, pred=pred, k=k)
            errs["masked_topk_large"] = max(
                errs["masked_topk_large"],
                hold_to_plain("masked_topk_large", pred, base, gd, gi, pd,
                              pi, tol))
    return errs


def live_rows(live):
    """Host (vectors, bitmaps, norms, tombstones) of the live handle's rows
    in id order: the base, then the delta."""
    dvec, dbm, dn = live._delta.host_view(live._delta.rows)
    return (np.concatenate([live.ds.vectors, dvec]),
            np.concatenate([live.ds.bitmaps, dbm]),
            np.concatenate([live.ds.norms_sq, dn]), live._tomb.copy())


def check_live_result(rows, batch, res, what: str) -> None:
    """As `check_result`, over the live rows: ids in range and live,
    finite distances that agree with float64, each row passing the
    predicate."""
    vec, bm, _, tomb = rows
    ids, dist = res.ids, res.distances
    if ids.shape != (batch.q, batch.k) or dist.shape != ids.shape:
        raise AssertionError(f"{what}: shapes {ids.shape} / {dist.shape}")
    if ids.min() < -1 or ids.max() >= vec.shape[0]:
        raise AssertionError(f"{what}: ids outside [-1, {vec.shape[0]})")
    ok = ids >= 0
    safe = np.maximum(ids, 0)
    if tomb[safe][ok].any():
        raise AssertionError(f"{what}: a deleted row came back")
    if not np.isfinite(dist[ok]).all() or not np.isnan(dist[~ok]).all():
        raise AssertionError(f"{what}: distances not finite at real ids")
    exact = ((vec[safe].astype(np.float64)
              - batch.vectors[:, None, :].astype(np.float64)) ** 2).sum(-1)
    scale = ((np.linalg.norm(vec[safe], axis=-1)
              + np.linalg.norm(batch.vectors, axis=-1)[:, None]) ** 2)
    if (np.abs(exact - dist)[ok] > (4 * vec.shape[1] * 2.0 ** -24
                                    * scale)[ok]).any():
        raise AssertionError(f"{what}: distances disagree with float64")
    passes = eval_predicate_np(bm[safe], batch.bitmaps[:, None, :],
                               batch.pred)
    if not passes[ok].all():
        raise AssertionError(f"{what}: a returned row fails the predicate")


def hold_live_against_ground_truth(rows, batch, ids, n_gt: int) -> int:
    """The first `n_gt` queries' live ids against a host exact answer over
    the live rows (fp32 scores, then float64 distances where the ids
    differ, as `hold_against_ground_truth`). Returns the count of queries
    whose ids are identical."""
    vec, bm, norms, tomb = rows
    same = 0
    for qi in range(n_gt):
        q = batch.vectors[qi]
        ok = eval_predicate_np(bm, batch.bitmaps[qi][None],
                               batch.pred) & ~tomb
        d = np.where(ok, norms - 2.0 * (vec @ q), np.inf)
        take = min(batch.k, int(ok.sum()))
        want = np.full(batch.k, -1, np.int64)
        if take:
            part = np.argpartition(d, take - 1)[:take]
            want[:take] = part[np.argsort(d[part], kind="stable")]
        a = ids[qi]
        if np.array_equal(a, want):
            same += 1
            continue
        if not np.array_equal(a >= 0, want >= 0):
            raise AssertionError(f"live query {qi}: fill differs from the "
                                 f"host answer")
        qd = q.astype(np.float64)

        def dists(x):
            return np.sort(((vec[x[x >= 0]].astype(np.float64) - qd) ** 2
                            ).sum(1))

        da, db = dists(a), dists(want)
        tol = 4 * vec.shape[1] * 2.0 ** -24 * (np.sqrt(db.max())
                                               + 2 * np.linalg.norm(qd)) ** 2
        if np.abs(da - db).max() > tol:
            raise AssertionError(f"live query {qi}: ids are not a top-k")
    return same


def live_writes(live, ds, seed: int = 23, between=None) -> dict:
    """The live path's writes: LIVE_UPSERTS base rows picked by a seeded
    generator (in row order, as a catalogue re-ingested group by group),
    + 0.01, with their bitmaps; then LIVE_BASE_DELETES base ids and
    LIVE_DELTA_DELETES delta ids deleted. `between()`, if given, runs
    after the upserts and before the deletes. Returns what was written."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(ds.n, LIVE_UPSERTS, replace=False))
    ids = live.upsert(ds.vectors[pick] + np.float32(0.01), ds.bitmaps[pick])
    dead = np.concatenate([rng.choice(ds.n, LIVE_BASE_DELETES,
                                      replace=False),
                           ids[rng.choice(LIVE_UPSERTS, LIVE_DELTA_DELETES,
                                          replace=False)]])
    if between is not None:
        between()
    if live.delete(dead) != dead.size:
        raise AssertionError("live deletes were not all fresh")
    return {"pick": pick, "ids": ids, "dead": dead}


def same_bits(a, b) -> bool:
    return (np.array_equal(a.ids, b.ids) and np.array_equal(a.keys, b.keys)
            and np.array_equal(a.distances.view(np.int32),
                               b.distances.view(np.int32)))


def live_answers(live, live_full, ds, batches: dict, routed: dict,
                 svc) -> dict:
    """The live path's writes on `live` (chunk pruner on) and `live_full`
    (pruner off), then what `run_live_reads` holds the path to, made
    before its launch counts are set to 0: each exact batch's unpruned
    fused read on `live_full`, each routed batch's exact answer on `live`
    (recall@10's truth) and the queue's workload over `svc`, the
    `RouterService` on `live`. Every candidate's index is built on the
    live base first."""
    for h in (live, live_full):
        live_writes(h, ds)
    emit("live.writes", upserts=LIVE_UPSERTS, base_deletes=LIVE_BASE_DELETES,
         delta_deletes=LIVE_DELTA_DELETES, **{
             k: v for k, v in live.stats().items()
             if k in ("base_n", "delta_rows", "tombstones", "n_live")})
    emit("live.build", seconds=build_on([live._base_fx], svc.router.methods),
         built=[list(k) for k in live.built_keys()])
    F.dataset_features(ds, fx=live)       # once per handle, cached on it
    return {"unpruned": {p: live_full.search(b, "prefilter")
                         for p, b in batches.items()},
            "truth": {p: live.search(b, "prefilter").ids
                      for p, b in routed.items()},
            "queue": queue_workload(live, svc, batches, QUEUE_PER_PRED)}


def run_live_reads(live, svc, batches: dict, routed: dict, want: dict,
                   n_gt: int) -> tuple[dict, dict]:
    """The live read path on `live` after `live_answers`: each exact batch
    fused with the chunk pruner, bit-identical to the unpruned read in
    `want`, the first `n_gt` queries against the host exact answer;
    routed search through `svc` on the live handle; single queries
    through `AsyncBatchQueue` over it, answering as the batched calls do.
    Returns (a summary, the fused answers)."""
    out = {"recall_at_10": {}}
    rows = live_rows(live)
    fused = {}
    t0 = time.perf_counter()
    for pred, batch in batches.items():
        before = live.stats()["delta_prune"]["pruned"]
        res = fused[pred] = live.search(batch, "prefilter")
        pruned = live.stats()["delta_prune"]["pruned"] - before
        full = want["unpruned"][pred]
        if not same_bits(res, full):
            raise AssertionError(f"live fused answers with and without the "
                                 f"chunk pruner differ, {PRED_NAMES[pred]}")
        check_live_result(rows, batch, res, f"live {PRED_NAMES[pred]}")
        same = hold_live_against_ground_truth(rows, batch, res.ids, n_gt)
        emit("live.exact", pred=PRED_NAMES[pred], q=batch.q,
             fused_s=res.timings["search_s"],
             fused_base_s=res.timings["base_s"],
             fused_delta_s=res.timings["delta_s"],
             unpruned_s=full.timings["search_s"],
             pruned_clusters=pruned, same_as_unpruned="bit-identical",
             gt_queries=n_gt, gt_identical=same)
    out["exact_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for pred, batch in routed.items():
        res = svc.search(batch)
        check_live_result(rows, batch, res, f"live routed {PRED_NAMES[pred]}")
        rec = float(recall_at_k(res.ids, want["truth"][pred]).mean())
        out["recall_at_10"][PRED_NAMES[pred]] = rec
        hist = {}
        for m, ps in res.decisions:
            hist[f"{m}/{ps}"] = hist.get(f"{m}/{ps}", 0) + 1
        emit("live.routed", pred=PRED_NAMES[pred], q=batch.q,
             recall_at_10=rec, decisions=hist, route_s=res.timings["route_s"],
             search_s=res.timings["search_s"], base_s=res.timings["base_s"],
             delta_s=res.timings["delta_s"])
    out["routed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = run_queue(live, svc, want["queue"], label="live.queue")
    out["queue_s"] = time.perf_counter() - t0
    out["queue_batches"] = {k: v["batches"] for k, v in stats.items()}
    return out, fused


def run_live_staged(live, batches: dict, fused: dict) -> float:
    """The staged live read (`fused=False`: the base overfetch, the delta
    top-k, `merge_topk`) of each exact batch, bit-identical to the fused
    answers `fused` of `run_live_reads`. Returns its seconds."""
    t0 = time.perf_counter()
    live.fused = False
    try:
        for pred, batch in batches.items():
            staged = live.search(batch, "prefilter")
            if not same_bits(staged, fused[pred]):
                raise AssertionError(f"live fused and staged answers "
                                     f"differ, {PRED_NAMES[pred]}")
            emit("live.staged", pred=PRED_NAMES[pred], q=batch.q,
                 staged_s=staged.timings["search_s"],
                 staged_base_s=staged.timings["base_s"],
                 staged_delta_s=staged.timings["delta_s"],
                 staged_merge_s=staged.timings["merge_s"],
                 same_as_fused="bit-identical")
    finally:
        live.fused = True
    return time.perf_counter() - t0


def run_live_compaction(live, ds, batches: dict) -> dict:
    """A snapshot read across a further write (the queries' own vectors
    upserted, each query's current top-1 deleted: the pinned epoch
    answers unchanged, the current one sees the write), then `compact()`:
    the compacted handle's exact answers bit-identical to a fresh
    `FilteredIndex` over its dataset, `last_remap` taking the ids of the
    answers before to those after, with the same keys."""
    batch = batches[int(Predicate.AND)]
    with live.snapshot() as snap:
        before = live.search(batch, "prefilter", snapshot=snap)
        new = live.upsert(batch.vectors[:64], batch.bitmaps[:64])
        live.delete(np.unique(before.ids[:64, 0][before.ids[:64, 0] >= 0]))
        pinned = live.search(batch, "prefilter", snapshot=snap)
        now = live.search(batch, "prefilter")
    if not same_bits(pinned, before):
        raise AssertionError("a snapshot's answer changed under a write")
    if not np.array_equal(now.ids[:64, 0], new):
        raise AssertionError("the current epoch does not see the write")
    emit("live.snapshot", pinned_unchanged=True, write_seen=True,
         upserted=int(new.size))
    pre = {p: live.search(b, "prefilter") for p, b in batches.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with method_seconds() as steps:
        gen = live.compact()
    compact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    remap = live.last_remap()
    fresh = FilteredIndex(live.ds, device=live.torch_device)
    t0 = time.perf_counter()
    for pred, b in batches.items():
        got = live.search(b, "prefilter")
        want = fresh.search(b, "prefilter")
        if not (np.array_equal(got.ids, want.ids) and np.array_equal(
                got.distances.view(np.int32), want.distances.view(np.int32))):
            raise AssertionError(f"the compacted index differs from a fresh "
                                 f"FilteredIndex, {PRED_NAMES[pred]}")
        ok = pre[pred].ids >= 0
        moved = np.where(ok, remap[np.maximum(pre[pred].ids, 0)], -1)
        if not (np.array_equal(moved, got.ids)
                and np.array_equal(pre[pred].keys, got.keys)):
            raise AssertionError(f"last_remap does not translate the ids, "
                                 f"{PRED_NAMES[pred]}")
    st = live.stats()
    emit("live.compact", compact_s=compact_s, generation=gen,
         base_n=st["base_n"], delta_rows=st["delta_rows"],
         tombstones=st["tombstones"], built=[list(k) for k in
                                             live.built_keys()],
         steps=step_seconds(steps), peak_device_mb_during_compact=peak,
         same_as_fresh="bit-identical", remap_translates_ids=True,
         check_s=time.perf_counter() - t0)
    if not any(c["method"] == "fvamana" and c["grafted"] for c in steps):
        raise AssertionError("compaction did not graft the fvamana graph")
    fresh.close()
    return {"compact_s": compact_s, "peak_device_mb_compact": peak}


def time_fused_live(live, batch, dev, flush):
    """`fused_live` and its plain version timed on the live handle's
    inputs for `batch` (as `_run_fused` makes them), with the bound of
    this launch's scanned rows and passing pairs. Returns (args, kwargs,
    the overfetch width, ms, plain ms, (operations s, bytes s), rows
    scanned, pairs passing)."""
    pred = int(batch.pred)
    d = live.device.vectors.shape[1]
    args, kw, kb = live_kernel_inputs(live, batch)
    _, qb, _, _, dvec, _, dbm, tomb = args
    w = dbm.shape[1]
    ms = time_ms(lambda: mk.fused_live_accum(*args, **kw, pred=pred,
                                             k=batch.k), 10, flush)
    pms = time_ms(lambda: mk.fused_live_plain(*args, **kw, pred=pred,
                                              k=batch.k), 5, flush)
    sel = kw["sel"]
    rows = (torch.arange(dvec.shape[0], device=dev) if sel is None
            else sel.long())
    safe = rows.clamp(min=0)
    live_row = ((rows >= 0) & (rows < live._delta.rows)
                & ~mk.tombstone_bits_plain(tomb, safe + kw["base_n"]))
    mask = mk._predicate_mask_block(dbm[safe], qb, pred) & live_row[None, :]
    bound = fused_live_bound(mask, d, w, kb, batch.k, tomb.shape[0],
                             sel is not None)
    return args, kw, kb, ms, pms, bound, int(rows.shape[0]), int(mask.sum())


def time_live_kernels(live, batches: dict, dev) -> dict:
    """Kernel and plain-version times on the live path's inputs:
    `fused_live` on each exact batch's (as `_run_fused` makes them), the
    k > MAX_K top-k on the first 64-query chunk of each base overfetch
    (k = 1,016 over the 1M base rows, as exact search cuts it). Returns
    per-kernel sums over the three predicates."""
    dd = live.device
    n, w = dd.bitmaps.shape
    d = dd.vectors.shape[1]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    out = {name: dict(ms=0.0, plain_ms=0.0, bound_s=0.0, ops_s=0.0,
                      bytes_s=0.0) for name in ("fused_live",
                                                "masked_topk_large")}
    out["masked_topk_large"].update(k200_ms=0.0, k200_bound_s=0.0)

    def add(name, ms, plain_ms, bound):
        o = out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        o["bound_s"] += max(bound)
        o["ops_s"] += bound[0]
        o["bytes_s"] += bound[1]
    for pred, batch in batches.items():
        args, kw, kb, ms, pms, bound, scanned, pairs = time_fused_live(
            live, batch, dev, flush)
        qv, qb = args[:2]
        add("fused_live", ms, pms, bound)

        base = (qv[:DEFAULT_QCHUNK], qb[:DEFAULT_QCHUNK], dd.vectors,
                dd.norms, dd.bitmaps)
        lms = time_ms(lambda: mk.masked_topk_large(*base, pred=pred, k=kb),
                      10, flush)
        lpms = time_ms(lambda: mk.masked_topk_plain(*base, pred=pred, k=kb),
                       5, flush)
        lmask = mk._predicate_mask_block(dd.bitmaps, base[1], pred)
        lbound = masked_topk_bound(lmask, d, w, kb)
        add("masked_topk_large", lms, lpms, lbound)
        l200 = time_ms(lambda: mk.masked_topk_large(*base, pred=pred,
                                                    k=ANY_K), 10, flush)
        b200 = masked_topk_bound(lmask, d, w, ANY_K)
        out["masked_topk_large"]["k200_ms"] += l200
        out["masked_topk_large"]["k200_bound_s"] += max(b200)
        emit("live.kernels.time", pred=PRED_NAMES[pred], fused_live_q=batch.q,
             fused_live_kb=kb, fused_live_scanned=scanned,
             fused_live_pairs=pairs, fused_live_ms=ms,
             fused_live_plain_ms=pms, fused_live_bound_ms=max(bound) * 1e3,
             fused_live_bound_ops_ms=bound[0] * 1e3,
             fused_live_bound_bytes_ms=bound[1] * 1e3,
             masked_topk_large_q=base[0].shape[0], masked_topk_large_k=kb,
             masked_topk_large_ms=lms, masked_topk_large_plain_ms=lpms,
             masked_topk_large_bound_ms=max(lbound) * 1e3,
             masked_topk_large_bound_ops_ms=lbound[0] * 1e3,
             masked_topk_large_bound_bytes_ms=lbound[1] * 1e3,
             masked_topk_large_k200_ms=l200,
             masked_topk_large_k200_bound_ms=max(b200) * 1e3)
    del flush
    return out


def merge_fold(dt, it, k: int, promise: bool):
    """`merge_topk`'s kernel launched as the scans launch their fold
    (`masked_topk._merge_launch`), with or without their promise that
    every list is sorted: raw (dists [Q, k], ids [Q, k]). CPU tensors
    (a rehearsal) take the plain version, as the wrappers do."""
    if not dt.is_cuda:
        return mk.merge_topk_plain(dt, it, k=k)
    q_ = dt.shape[1]
    od = torch.empty((q_, k), dtype=torch.float32, device=dt.device)
    oi = torch.empty((q_, k), dtype=torch.int32, device=dt.device)
    _build.check(mk._merge_launch(_build.library(), dt.device, dt, it, od,
                                  oi, k, promise), "merge_topk")
    return od, oi


@contextlib.contextmanager
def captured_folds():
    """Record copies of the (dists, ids, k) every scan's fold merges
    (`masked_topk._merge_launch`) while the block runs."""
    calls = []
    orig = mk._merge_launch

    def capture(lib, dev, dists, ids, out_d, out_i, k, sorted_lists):
        calls.append((dists.clone(), ids.clone(), k))
        return orig(lib, dev, dists, ids, out_d, out_i, k, sorted_lists)
    mk._merge_launch = capture
    try:
        yield calls
    finally:
        mk._merge_launch = orig


@contextlib.contextmanager
def captured_merges():
    """Record the (ids, dists, k) of every `ops.merge_topk` call while the
    block runs (the staged live read's fold through `merge_candidates`,
    the multi-block entry point's fold of its block lists)."""
    calls = []
    orig = ops.merge_topk

    def capture(ids, dists, *, k=None):
        calls.append((ids, dists, k))
        return orig(ids, dists, k=k)
    ops.merge_topk = capture
    try:
        yield calls
    finally:
        ops.merge_topk = orig


def merge_yardstick(dt, it, k: int, flush, promise: bool = False) -> dict:
    """`merge_topk` on [S, Q, K] lists, through the public wrapper or, with
    `promise`, as the scans launch their fold (`merge_fold`): held bit for
    bit to its plain version, then timed beside one library call on the
    same inputs, `torch.topk` over the query-major [Q, S·K] copy (which
    finds the same set with no tie order). Where the promise makes the
    kernel step through the lists (keys past shared memory), the
    workspace select it would take without the promise is timed too.
    Returns the shape, k, the regime and the times."""
    s_, q_, kk = dt.shape
    past = dt.is_cuda and _build.library().merge_topk_workspace_bytes(
        s_, q_, kk, k, 0) > 0
    run = ((lambda: merge_fold(dt, it, k, True)) if promise
           else (lambda: mk.merge_topk_accum(dt, it, k=k)))
    pd, pi = mk.merge_topk_plain(dt, it, k=k)
    for f in (run, lambda: merge_fold(dt, it, k, False)) if past else (run,):
        gd, gi = f()
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(gd.view(torch.int32),
                                                    pd.view(torch.int32))):
            raise AssertionError(f"merge_topk differs from its plain "
                                 f"version on the {list(dt.shape)} lists, "
                                 f"k {k}, promise {promise}")
    flat = dt.transpose(0, 1).reshape(q_, s_ * kk).contiguous()
    y = {"shape": [s_, q_, kk], "k": k, "promise": promise,
         "regime": ("stepping" if promise else "workspace select") if past
         else "shared select",
         "ms": time_ms(run, 20, flush),
         "torch_topk_ms": time_ms(lambda: torch.topk(
             flat, min(k, s_ * kk), dim=1, largest=False), 20, flush),
         "bound_ms": max(merge_topk_bound(s_, q_, kk, k, promise)) * 1e3}
    if promise and past:
        y["workspace_select_ms"] = time_ms(
            lambda: merge_fold(dt, it, k, False), 20, flush)
    return y


MERGE_KINDS = ("staged", "blocks", "shards", "fold", "fold_k32",
               "fold_k128", "fused_fold")


def time_merge_yardsticks(live, fx, sfx, batches: dict, dev) -> dict:
    """`merge_topk` beside `torch.topk` (`merge_yardstick`) on its kinds
    of input, each held to its plain version first: the staged live
    read's fold of the base overfetch and the delta top-k ([2, 256, KK]
    lists with tombstoned slots, unordered), the multi-block entry
    point's fold of its [NB, 256, 10] block lists, the sharded path's
    [4, 256, 10] shard lists; and, launched as the scans launch them with
    their promise that the lists are sorted, the fold inside
    `masked_topk` on the first 64-query chunk ([splits, 64, k] per-split
    lists) at the batch's k and at k = 32 and 128 (past shared memory),
    and the fold inside `fused_live` on the live read's inputs
    ([1 + splits, 256, k]). Returns per-kind sums over the three
    predicates and the per-predicate lines."""
    dd = fx.device
    prefilter = get_method("prefilter")
    setting = prefilter.param_settings()[0]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    out = {kind: dict(ms=0.0, library_ms=0.0, bound_s=0.0, per_predicate=[])
           for kind in MERGE_KINDS}
    for pred, batch in batches.items():
        live.fused = False
        try:
            with captured_merges() as staged:
                live.search(batch, "prefilter")
        finally:
            live.fused = True
        qv = to_device(batch.vectors, dev)
        qb = to_device(batch.bitmaps, dev)
        with captured_merges() as blocks:
            ops.masked_topk_multiblock(qv, qb, dd.vectors, dd.norms,
                                       dd.bitmaps, pred=pred, k=batch.k)
        inputs = {}
        for kind, (ids, dists, k) in (("staged", staged[-1]),
                                      ("blocks", blocks[-1])):
            inputs[kind] = (dists.to(torch.float32).contiguous(),
                            ids.to(torch.int32).contiguous(), k, False)
        ids, raw = stack_candidates(sfx.shard_candidates(prefilter, setting,
                                                         batch))
        inputs["shards"] = (*on_card(dev, raw, ids), batch.k, False)
        for kind, k in (("fold", batch.k), ("fold_k32", 32),
                        ("fold_k128", 128)):
            with captured_folds() as folds:
                mk.masked_topk_accum(qv[:DEFAULT_QCHUNK], qb[:DEFAULT_QCHUNK],
                                     dd.vectors, dd.norms, dd.bitmaps,
                                     pred=pred, k=k)
            inputs[kind] = (*folds[-1], True)
        args, kw, _ = live_kernel_inputs(live, batch)
        with captured_folds() as folds:
            mk.fused_live_accum(*args, **kw, pred=pred, k=batch.k)
        inputs["fused_fold"] = (*folds[-1], True)
        line = {}
        for kind, (dt, it, k, promise) in inputs.items():
            y = line[kind] = merge_yardstick(dt, it, k, flush, promise)
            o = out[kind]
            o["ms"] += y["ms"]
            o["library_ms"] += y["torch_topk_ms"]
            o["bound_s"] += y["bound_ms"] / 1e3
            o["per_predicate"].append(y)
        emit("live.merge_topk.yardstick", pred=PRED_NAMES[pred],
             staged_merges=len(staged), held_to_plain="bit-identical",
             **line)
    del flush
    return out


def anyk_batches(batches: dict) -> dict:
    return {p: QueryBatch(b.vectors, b.bitmaps, b.pred, ANY_K)
            for p, b in batches.items()}


def anyk_args(fx, batch):
    """`batch` on the card beside the index's rows, as `ops.masked_topk`
    and `ops.masked_topk_multiblock` take them."""
    dd = fx.device
    return (to_device(batch.vectors, fx.torch_device),
            to_device(batch.bitmaps, fx.torch_device), dd.vectors, dd.norms,
            dd.bitmaps)


def anyk_answers(fx, batches: dict) -> tuple[dict, dict]:
    """The any-k phase's reference answers, made before its launch counts
    are set to 0: the single index's search and `ops.masked_topk` (ids,
    distances) for each batch."""
    want = {p: fx.search(b, "prefilter") for p, b in batches.items()}
    want_mb = {p: ops.masked_topk(*anyk_args(fx, b), pred=p, k=b.k)
               for p, b in batches.items()}
    torch.cuda.synchronize()
    return want, want_mb


def run_anyk(fx, sfx, live, batches: dict, want: dict, want_mb: dict,
             n_gt: int) -> None:
    """The any-k phase: each exact batch at k = ANY_K through the sharded
    handle `sfx` (bit-identical to the single index's answers in `want`),
    the live handle `live` fused and staged (bit-identical to each other,
    the first `n_gt` queries against the host exact answer over the live
    rows), and `ops.masked_topk_multiblock` (equal to `ops.masked_topk`'s
    answers in `want_mb`). `anyk_answers` makes both references."""
    rows = live_rows(live)
    for pred, batch in batches.items():
        res = sfx.search(batch, "prefilter")
        single = want[pred]
        if not (np.array_equal(res.ids, single.ids) and np.array_equal(
                res.distances.view(np.int32), single.distances.view(np.int32))):
            raise AssertionError(f"sharded k = {ANY_K} differs from the "
                                 f"single index, {PRED_NAMES[pred]}")
        fused = live.search(batch, "prefilter")
        live.fused = False
        try:
            staged = live.search(batch, "prefilter")
        finally:
            live.fused = True
        if not same_bits(fused, staged):
            raise AssertionError(f"live fused and staged answers differ at "
                                 f"k = {ANY_K}, {PRED_NAMES[pred]}")
        check_live_result(rows, batch, fused, f"live k {ANY_K}")
        same = hold_live_against_ground_truth(rows, batch, fused.ids, n_gt)
        ids, dists = ops.masked_topk_multiblock(*anyk_args(fx, batch),
                                                pred=pred, k=ANY_K)
        want_i, want_d = want_mb[pred]
        if not (torch.equal(ids, want_i) and torch.equal(
                dists.view(torch.int32), want_d.view(torch.int32))):
            raise AssertionError(f"masked_topk_multiblock differs from "
                                 f"masked_topk at k = {ANY_K}, "
                                 f"{PRED_NAMES[pred]}")
        emit("anyk", pred=PRED_NAMES[pred], q=batch.q, k=ANY_K,
             sharded_same_as_single="bit-identical",
             live_fused_s=fused.timings["search_s"],
             live_staged_s=staged.timings["search_s"],
             live_fused_same_as_staged="bit-identical", gt_queries=n_gt,
             gt_identical=same, multiblock_same_as_masked_topk=True,
             matched=int((fused.ids >= 0).sum()))


# ---------------------------------------------------------------------------
# phase 10: the sharded live index
# ---------------------------------------------------------------------------

def single_live_answers(live, svc, routed: dict, fused: dict,
                        truth: dict) -> dict:
    """What phase 10 holds the sharded live handle to, from the single live
    handle `live` after phase 8's writes and its service `svc`: the fused
    answers `fused` of `run_live_reads`, each routed batch's decisions, the
    exact truths `truth` and the live rows in id order (the host exact
    answer's input); and, for phase 11, each routed batch's answer. The
    global ids of both handles agree: base rows keep their row ids,
    upserts number on in insertion order."""
    return {"fused": fused, "truth": truth, "rows": live_rows(live),
            "decisions": {p: svc.route(b) for p, b in routed.items()},
            "routed": {p: svc.search(b) for p, b in routed.items()}}


def sharded_live_answers(live4, ds, svc4, batches: dict) -> dict:
    """Phase 8's writes on the sharded live handle `live4`, then, before
    the phase's launch counts are set to 0: every candidate's index built
    on each shard, the dataset-level features and the full-base feature
    tensors, and the queue's workload over `svc4` (the batched route's
    decisions and the batched exact ids)."""
    live_writes(live4, ds)
    st = live4.stats()
    emit("sharded_live.writes", upserts=LIVE_UPSERTS,
         base_deletes=LIVE_BASE_DELETES, delta_deletes=LIVE_DELTA_DELETES,
         base_n=st["base_n"], delta_rows=st["delta_rows"],
         n_live=st["n_live"],
         shard_delta_rows=[sh["delta_rows"] for sh in st["shards"]],
         shard_tombstones=[sh["tombstones"] for sh in st["shards"]])
    emit("sharded_live.build",
         seconds=build_on([sh._base_fx for sh in live4.shards],
                          svc4.router.methods),
         built=[list(k) for k in live4.shards[0].built_keys()])
    F.dataset_features(ds, fx=live4)      # once per handle, cached on it
    live4.device
    return {"queue": queue_workload(live4, svc4, batches, QUEUE_PER_PRED)}


def run_sharded_live(live4, svc4, batches: dict, routed: dict, single: dict,
                     want: dict, n_gt: int) -> dict:
    """The sharded live path: (a) exact search of each batch, ids, keys
    and distance bits identical to the single live handle's fused answers
    in `single` (`single_live_answers`), the first `n_gt` queries against
    the host exact answer; (b) `ShardedRouterService` `svc4`, the single
    live service's decisions, recall@10 against the exact truth; (c) the
    queue over it (`want`, `sharded_live_answers`). Returns a summary."""
    out = {"recall_at_10": {}}
    rows = single["rows"]
    t0 = time.perf_counter()
    for pred, batch in batches.items():
        res = live4.search(batch, "prefilter")
        if not same_bits(res, single["fused"][pred]):
            raise AssertionError(f"sharded live exact search differs from "
                                 f"the single live handle's, "
                                 f"{PRED_NAMES[pred]}")
        check_live_result(rows, batch, res,
                          f"sharded live {PRED_NAMES[pred]}")
        same = hold_live_against_ground_truth(rows, batch, res.ids, n_gt)
        emit("sharded_live.exact", pred=PRED_NAMES[pred], q=batch.q,
             same_as_single_live="bit-identical", gt_queries=n_gt,
             gt_identical=same, base_s=res.timings["base_s"],
             delta_s=res.timings["delta_s"], **stage_summary(res.timings))
    out["exact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pred, batch in routed.items():
        res = svc4.search(batch)
        if res.decisions != single["decisions"][pred]:
            raise AssertionError(f"sharded live routing decisions differ "
                                 f"from the single live service's, "
                                 f"{PRED_NAMES[pred]}")
        check_live_result(rows, batch, res,
                          f"sharded live routed {PRED_NAMES[pred]}")
        rec = float(recall_at_k(res.ids, single["truth"][pred]).mean())
        out["recall_at_10"][PRED_NAMES[pred]] = rec
        hist = {}
        for m, ps in res.decisions:
            hist[f"{m}/{ps}"] = hist.get(f"{m}/{ps}", 0) + 1
        emit("sharded_live.routed", pred=PRED_NAMES[pred], q=batch.q,
             recall_at_10=rec, decisions=hist, same_decisions=True,
             base_s=res.timings["base_s"], delta_s=res.timings["delta_s"],
             **stage_summary(res.timings))
    out["routed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = run_queue(live4, svc4, want["queue"], label="sharded_live.queue")
    out["queue_s"] = time.perf_counter() - t0
    out["queue_batches"] = {k: v["batches"] for k, v in stats.items()}
    return out


def pinned_search(live4, batch, snap):
    """Exact search of `batch` on the pinned epoch `snap`: (ids, scores,
    keys)."""
    prefilter = get_method("prefilter")
    ids, raw = live4.run_method(prefilter, prefilter.param_settings()[0],
                                batch, snapshot=snap)
    return ids, raw, live4.keys_of(ids, snapshot=snap)


def run_sharded_live_compaction(live4, batches: dict) -> dict:
    """A snapshot read across a further write (the queries' own vectors
    upserted, each query's current top-1 deleted: the pinned epoch
    answers unchanged, a fresh one sees the write), then `compact()`: a
    global rebuild (each shard's indexes rebuilt and timed), the
    compacted handle's exact answers bit-identical to a
    `ShardedFilteredIndex(new_ds, SHARDS)`, `last_remap` taking the ids of
    the answers before to those after, with the same keys."""
    batch = batches[int(Predicate.AND)]
    with live4.snapshot() as snap:
        before = pinned_search(live4, batch, snap)
        top = before[0][:64, 0]
        new = live4.upsert(batch.vectors[:64], batch.bitmaps[:64])
        live4.delete(np.unique(top[top >= 0]))
        pinned = pinned_search(live4, batch, snap)
    now = live4.search(batch, "prefilter")
    if not (np.array_equal(pinned[0], before[0])
            and np.array_equal(pinned[1].view(np.int32),
                               before[1].view(np.int32))
            and np.array_equal(pinned[2], before[2])):
        raise AssertionError("a sharded snapshot's answer changed under a "
                             "write")
    if not np.array_equal(now.ids[:64, 0], new):
        raise AssertionError("the current sharded epoch does not see the "
                             "write")
    emit("sharded_live.snapshot", pinned_unchanged=True, write_seen=True,
         upserted=int(new.size))
    pre = {p: live4.search(b, "prefilter") for p, b in batches.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with method_seconds() as steps:
        gen = live4.compact()
    compact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    remap = live4.last_remap()
    t0 = time.perf_counter()
    with ShardedFilteredIndex(live4.ds, SHARDS,
                              device=live4.torch_device) as sfx:
        for pred, b in batches.items():
            got = live4.search(b, "prefilter")
            want = sfx.search(b, "prefilter")
            if not (np.array_equal(got.ids, want.ids) and np.array_equal(
                    got.distances.view(np.int32),
                    want.distances.view(np.int32))):
                raise AssertionError(f"the compacted sharded live index "
                                     f"differs from a ShardedFilteredIndex, "
                                     f"{PRED_NAMES[pred]}")
            ok = pre[pred].ids >= 0
            moved = np.where(ok, remap[np.maximum(pre[pred].ids, 0)], -1)
            if not (np.array_equal(moved, got.ids)
                    and np.array_equal(pre[pred].keys, got.keys)):
                raise AssertionError(f"sharded last_remap does not "
                                     f"translate the ids, "
                                     f"{PRED_NAMES[pred]}")
    st = live4.stats()
    emit("sharded_live.compact", compact_s=compact_s, generation=gen,
         base_n=st["base_n"], delta_rows=st["delta_rows"],
         shard_rows=np.diff(live4.bounds).tolist(),
         steps=step_seconds(steps),
         peak_device_mb_during_compact=peak,
         same_as_sharded_index="bit-identical", remap_translates_ids=True,
         check_s=time.perf_counter() - t0)
    return {"compact_s": compact_s, "peak_device_mb_compact": peak}


def time_sharded_live_kernels(live4, batches: dict, dev) -> dict:
    """`merge_topk` on the [4, 256, 10] globalised candidates the shards'
    live reads give each exact batch (with `torch.topk` over the
    shard-major copy), and `fused_live` on shard 0's inputs for it, each
    with its plain version and bound. Each output is held against its
    plain version's on the same inputs first: `merge_topk` bit for bit,
    `fused_live` as `hold_fused_to_plain` holds it, and the shard's base
    overfetch (its first 64-query chunk at the shard's own KB, past
    MAX_K through `masked_topk_large`) as `hold_to_plain` holds it, all
    with the tolerance `check_live_path_kernels` uses. Returns per-kernel
    sums over the three predicates, and under "max_abs_err" the largest
    error of each kernel it held."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    out = {name: dict(ms=0.0, plain_ms=0.0, bound_s=0.0)
           for name in ("merge_topk", "fused_live")}
    out["merge_topk"]["library_ms"] = 0.0
    errs = {"merge_topk": 0.0, "fused_live": 0.0}
    shard = live4.shards[0]
    d = shard.device.vectors.shape[1]
    prefilter = get_method("prefilter")
    setting = prefilter.param_settings()[0]
    for pred, batch in batches.items():
        with live4.snapshot() as snap:
            parts = live4.shard_candidates(prefilter, setting, batch, snap)
        ids, raw = stack_candidates(parts)
        dt, it = on_card(dev, raw, ids)
        s_, q_, kk = dt.shape
        flat = dt.transpose(0, 1).reshape(q_, s_ * kk).contiguous()
        mms = time_ms(lambda: mk.merge_topk_accum(dt, it, k=batch.k), 20,
                      flush)
        mpms = time_ms(lambda: mk.merge_topk_plain(dt, it, k=batch.k), 10,
                       flush)
        lms = time_ms(lambda: torch.topk(flat, batch.k, dim=1,
                                         largest=False), 20, flush)
        mbound = merge_topk_bound(s_, q_, kk, batch.k)
        gd, gi = mk.merge_topk_accum(dt, it, k=batch.k)
        pd, pi = mk.merge_topk_plain(dt, it, k=batch.k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, pi) and torch.equal(
                gd.view(torch.int32), pd.view(torch.int32))):
            raise AssertionError(f"merge_topk differs from its plain "
                                 f"version on the sharded live candidates, "
                                 f"{PRED_NAMES[pred]}")
        args, kw, kb, fms, fpms, fbound, scanned, pairs = time_fused_live(
            shard, batch, dev, flush)
        qv, qb, dvec = args[0], args[1], args[4]
        vn = max(float(shard.device.norms.max()),
                 float((dvec ** 2).sum(1).max()) if dvec.shape[0] else 0.0
                 ) ** 0.5
        qn = float(qv.norm(dim=1).max())
        tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn)
        gd, gi = mk.fused_live_accum(*args, **kw, pred=pred, k=batch.k)
        pd, pi = mk.fused_live_plain(*args, **kw, pred=pred, k=batch.k)
        ferr = hold_fused_to_plain(pred, args, kw, gd, gi, pd, pi, tol)
        errs["fused_live"] = max(errs["fused_live"], ferr)
        base = (qv[:DEFAULT_QCHUNK], qb[:DEFAULT_QCHUNK],
                shard.device.vectors, shard.device.norms,
                shard.device.bitmaps)
        large = kb > mk.MAX_K
        scan = "masked_topk_large" if large else "masked_topk"
        gd, gi = (mk.masked_topk_large if large else mk.masked_topk_accum)(
            *base, pred=pred, k=kb)
        pd, pi = mk.masked_topk_plain(*base, pred=pred, k=kb)
        serr = hold_to_plain(scan, pred, base, gd, gi, pd, pi, tol)
        errs[scan] = max(errs.get(scan, 0.0), serr)
        for name, ms, pms, bound in (("merge_topk", mms, mpms, mbound),
                                     ("fused_live", fms, fpms, fbound)):
            out[name]["ms"] += ms
            out[name]["plain_ms"] += pms
            out[name]["bound_s"] += max(bound)
        out["merge_topk"]["library_ms"] += lms
        emit("sharded_live.kernels.time", pred=PRED_NAMES[pred],
             merge_topk_shape=[s_, q_, kk], merge_topk_ms=mms,
             merge_topk_plain_ms=mpms, merge_topk_torch_topk_ms=lms,
             merge_topk_bound_ms=max(mbound) * 1e3, fused_live_shard=0,
             fused_live_kb=kb, fused_live_scanned=scanned,
             fused_live_pairs=pairs, fused_live_ms=fms,
             fused_live_plain_ms=fpms, fused_live_bound_ms=max(fbound) * 1e3,
             merge_topk_same_as_plain="bit-identical",
             fused_live_max_abs_err=ferr, base_scan=scan, base_scan_k=kb,
             base_scan_q=int(base[0].shape[0]),
             base_scan_max_abs_err=serr, tol=tol)
    del flush
    out["max_abs_err"] = errs
    return out


# ---------------------------------------------------------------------------
# phase 11: durable storage
# ---------------------------------------------------------------------------
# phase 12: serving ops — the hooks, the auditor, the cache, adaptation,
# spans, the ledger and /metrics
# ---------------------------------------------------------------------------

SERVE_RESERVOIR = 64          # audited samples a pass
SERVE_PASSES = 5              # hooked / unhooked timing passes
CACHE_DISTINCT = 100          # the cache phase's distinct queries
CACHE_THRESHOLD = 0.98        # the semantic hit's cosine threshold
CACHE_NOISE = 0.002           # near-duplicates: this times each query's
#                               norm, as seeded Gaussian noise a dimension


def serving_hooks(build_dir: str, tag: str) -> dict:
    """A telemetry sink, a tracer, an SLO engine and a wide-event log
    (its file under `build_dir`), as a service takes them."""
    tracer = Tracer(slow_ms=None, sample=1.0, flight_capacity=16, seed=7)
    return {
        "telemetry": TelemetrySink(capacity=4096,
                                   reservoir=SERVE_RESERVOIR, seed=0),
        "tracer": tracer,
        "slo": SLOEngine([Objective(name="latency_p99", kind="latency",
                                    target=0.99, threshold_us=50_000.0),
                          Objective(name="availability",
                                    kind="availability", target=0.999),
                          Objective(name="recall_floor", kind="recall",
                                    target=0.9, floor=0.5)],
                         min_events=1, tracer=tracer),
        "obslog": WideEventLog(os.path.join(build_dir, f"{tag}.jsonl"))}


def query_index(batches: dict) -> dict:
    """(pred, vector bytes) -> the query's row in its batch."""
    return {(int(p), b.vectors[i].tobytes()): i
            for p, b in batches.items() for i in range(b.q)}


def audit_and_hold(auditor, where: dict, want_keys: dict, what: str
                   ) -> dict:
    """One `run_once` pass with the launch counts set to 0 just before and
    read just after; every audited sample's exact keys equal `want_keys`
    (pred -> [Q, k] keys of the phase's exact read) at its query's row.
    Returns the pass's report fields."""
    reset_launches()
    t0 = time.perf_counter()
    rep = auditor.run_once()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if rep["samples"] == 0:
        raise AssertionError(f"{what}: the audit had no samples")
    for s, _r, ex in rep["results"]:
        row = where[(int(s.pred), s.vector.tobytes())]
        if not np.array_equal(np.asarray(ex), want_keys[int(s.pred)][row]):
            raise AssertionError(f"{what}: an audited query's exact keys "
                                 f"differ from the exact read's")
    return {"samples": rep["samples"], "seconds": seconds,
            "launches": launches, "recall_by_cell": {
                c: v["recall"] for c, v in rep["cells"].items()},
            "exact_keys": "equal to the exact read"}


def run_serving_audit_live(handle, router, routed: dict, want_ids: dict,
                           build_dir: str, label: str, kernel: str) -> dict:
    """Phase 12 (b) on a live handle in its phase's state: a hooked
    service of `router` serves the routed batches (the sink's reservoir
    samples them), then one audit pass, whose exact keys must equal the
    handle's keys of the phase's exact ids `want_ids`; the pass must
    launch `kernel`."""
    svc_cls = (ShardedRouterService if isinstance(handle, ShardedLiveIndex)
               else RouterService)
    hooks = serving_hooks(build_dir, label)
    hooked = svc_cls(handle, router, t=0.9, **hooks)
    for b in routed.values():
        hooked.search(b)
    table = OnlineBenchmarkTable(router.table)
    auditor = RecallAuditor(handle, hooks["telemetry"], table=table,
                            slo=hooks["slo"])
    want = {p: handle.keys_of(ids) for p, ids in want_ids.items()}
    out = audit_and_hold(auditor, query_index(routed), want, label)
    hooks["obslog"].close()
    if out["launches"][kernel] == 0:
        raise AssertionError(f"{label}: the audit never launched {kernel}")
    emit(f"serving.audit.{label}", table_version=table.version,
         slo=hooks["slo"].stats(), **out)
    return out["launches"]


def time_median(fn, passes: int) -> float:
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def run_serving_hooked(fx, svc, routed: dict, hooks: dict) -> tuple:
    """Phase 12 (a): `RouterService` with every hook on the phase-5
    handle and router; each routed batch's decisions, ids and distance
    bits equal the unhooked service's, and the median wall time a batch
    over SERVE_PASSES passes of each. Returns (the hooked service, a
    summary with the launch counts of its first pass)."""
    want = {p: svc.search(b) for p, b in routed.items()}
    hooked = RouterService(fx, svc.router, t=0.9, **hooks)
    reset_launches()
    got = {p: hooked.search(b) for p, b in routed.items()}
    launches = read_launches()
    for p, res in got.items():
        if not (res.decisions == want[p].decisions
                and same_bits(res, want[p])):
            raise AssertionError(f"hooked routed answers differ from the "
                                 f"unhooked, {PRED_NAMES[p]}")
    med = {}
    for name, s in (("unhooked", svc), ("hooked", hooked),
                    ("unhooked_again", svc)):
        med[name] = {PRED_NAMES[p]: time_median(lambda: s.search(b),
                                                SERVE_PASSES)
                     for p, b in routed.items()}
    hooks["obslog"].flush()
    summary = {"same_as_unhooked": "bit-identical", "launches": launches,
               "median_batch_s": med, "passes": SERVE_PASSES,
               "sink": hooks["telemetry"].stats(),
               "obslog": hooks["obslog"].stats(),
               "slo_state": hooks["slo"].state()}
    if launches["selectivity"] == 0:
        raise AssertionError("hooked serving never launched selectivity")
    return hooked, summary


def cache_workload(routed: dict, seed: int = 5) -> list:
    """CACHE_DISTINCT distinct queries (the routed batches' first rows,
    the three predicates in turn), each twice, and a seeded near-duplicate
    of each, in a seeded order: (kind, pred, distinct index, vector,
    bitmap)."""
    rng = np.random.default_rng(seed)
    preds = list(routed)
    out = []
    for j in range(CACHE_DISTINCT):
        p = preds[j % len(preds)]
        b = routed[p]
        v, bm = b.vectors[j // len(preds)], b.bitmaps[j // len(preds)]
        noise = rng.standard_normal(v.shape).astype(np.float32)
        near = (v + CACHE_NOISE * float(np.linalg.norm(v))
                / np.sqrt(v.size) * noise).astype(np.float32)
        out += [("first", p, j, v, bm), ("again", p, j, v, bm),
                ("near", p, j, near, bm)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def run_serving_cache(fx, hooked, routed: dict, threads: int = 8) -> tuple:
    """Phase 12 (c): `SemanticResultCache(hooked)` behind
    `AsyncBatchQueue(max_batch=32, max_wait_ms=5)`, 300 single queries
    from `threads` threads. Every exact hit bit-identical to a fresh
    search of its query; every semantic hit the row set of a cached
    same-bitmap neighbour past the threshold, with distances within 1e-4
    relative of a float64 recompute. Returns (the cache, the queue, a
    summary)."""
    work = cache_workload(routed)
    cache = SemanticResultCache(hooked, threshold=CACHE_THRESHOLD,
                                capacity=1024)
    queue = AsyncBatchQueue(cache, max_batch=32, max_wait_ms=5)
    got = [None] * len(work)
    lat = [0.0] * len(work)

    def submit(t):
        for i in range(t, len(work), threads):
            _kind, p, _j, v, bm = work[i]
            t0 = time.perf_counter()
            got[i] = queue.submit(v, bm, p).result(timeout=300)
            lat[i] = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    workers = [threading.Thread(target=submit, args=(t,))
               for t in range(threads)]
    for th in workers:
        th.start()
    for th in workers:
        th.join(timeout=600)
    if any(th.is_alive() for th in workers):
        raise AssertionError("cache submitters did not finish")
    seconds = time.perf_counter() - t0
    launches = read_launches()
    kinds, lat_by = {}, {"hit": [], "miss": []}
    for (kind, p, j, v, bm), res, dt in zip(work, got, lat):
        tag = res.cache or "miss"
        kinds[tag] = kinds.get(tag, 0) + 1
        lat_by["miss" if res.cache is None else "hit"].append(dt)
        if res.cache == "exact":
            fresh = hooked.search(QueryBatch(v[None], bm[None], p, 10))
            if not (np.array_equal(res.ids, fresh.ids[0])
                    and np.array_equal(res.keys, fresh.keys[0])
                    and np.array_equal(res.distances.view(np.int32),
                                       fresh.distances[0].view(np.int32))):
                raise AssertionError("an exact cache hit differs from a "
                                     "fresh search of its query")
        elif res.cache == "semantic":
            hold_semantic_hit(fx, work, got, p, v, bm, res)
        elif res.cache is not None:
            raise AssertionError(f"unexpected cache kind {res.cache!r}")
    if kinds.get("exact", 0) == 0 or kinds.get("semantic", 0) == 0:
        raise AssertionError(f"the cache phase lacks a hit kind: {kinds}")
    med = {k: (float(np.median(v)) * 1e3 if v else None)
           for k, v in lat_by.items()}
    summary = {"queries": len(work), "threads": threads, "seconds": seconds,
               "launches": launches, "by_kind": kinds,
               "median_ms": med, "cache": cache.stats(),
               "queue": {k: v for k, v in queue.stats().items()
                         if k != "telemetry"},
               "exact_hits": "bit-identical to fresh searches",
               "semantic_hits": "a cached neighbour's rows, distances "
                                "within 1e-4 of float64"}
    return cache, queue, summary


def hold_semantic_hit(fx, work, got, p, v, bm, res) -> None:
    """A semantic hit serves the row set of a cached query of the same
    predicate and bitmap whose cosine to `v` clears the threshold, with
    distances within 1e-4 relative of float64, ascending."""
    vd = v.astype(np.float64)
    cands = []
    for (kind, p2, _j, v2, bm2), r2 in zip(work, got):
        if (r2.cache is None and p2 == p and np.array_equal(bm2, bm)):
            v2d = v2.astype(np.float64)
            cos = vd @ v2d / (np.linalg.norm(vd) * np.linalg.norm(v2d))
            if cos >= CACHE_THRESHOLD:
                cands.append(set(r2.ids[r2.ids >= 0].tolist()))
    ids = res.ids[res.ids >= 0]
    if set(ids.tolist()) not in cands:
        raise AssertionError("a semantic hit is no cached neighbour's rows")
    d = ((fx.ds.vectors[ids].astype(np.float64) - vd) ** 2).sum(1)
    got_d = res.distances[res.ids >= 0].astype(np.float64)
    if (np.abs(got_d - d) > 1e-4 * np.maximum(d, 1e-12)).any():
        raise AssertionError("a semantic hit's distances disagree with "
                             "float64")
    if (np.diff(got_d) < 0).any():
        raise AssertionError("a semantic hit's rows are not sorted")


def two_method_table(ds_name: str):
    """The IVF pair's table of the adaptation check: both pass t = 0.9,
    ivf_gamma with the better QPS (the JAX package's adaptation test)."""
    table = BenchmarkTable.new()
    cand = candidate_methods()
    for pt in range(3):
        for s in cand["ivf_gamma"].param_settings():
            table.add(ds_name, pt, "ivf_gamma", s.ps_id, 0.97, 5000.0)
        for s in cand["postfilter"].param_settings():
            table.add(ds_name, pt, "postfilter", s.ps_id, 0.95, 500.0)
    return table


def run_serving_adaptation(fx, routed: dict) -> dict:
    """Phase 12 (d): `constant_router` over the IVF pair, ivf_gamma
    served through `DegradedMethod(keep=2)`; `OnlineRouterAdapter` with
    a drift threshold no drift reaches must route the AND batch off the
    degraded method within 6 steps, without a retrain."""
    table = two_method_table(fx.ds.name)
    router = constant_router(F.MINIMAL_FEATURES, ["ivf_gamma", "postfilter"],
                             table)
    serving = dict(candidate_methods())
    serving["ivf_gamma"] = DegradedMethod(serving["ivf_gamma"], keep=2)
    sink = TelemetrySink(capacity=1024, reservoir=SERVE_RESERVOIR, seed=5)
    svc = RouterService(fx, router, t=0.9, methods=serving, telemetry=sink)
    adapter = OnlineRouterAdapter(svc, sink, alpha=0.5, drift_threshold=2.0,
                                  seed=0)
    batch = routed[int(Predicate.AND)]
    if {d.method for d in svc.route(batch)} != {"ivf_gamma"}:
        raise AssertionError("the adaptation check does not start on "
                             "ivf_gamma")
    reset_launches()
    t0 = time.perf_counter()
    steps = []
    for _ in range(6):
        svc.search(batch)
        rep = adapter.step()
        routes = {d.method for d in svc.route(batch)}
        steps.append({**rep, "routes": sorted(routes)})
        if "ivf_gamma" not in routes:
            break
    launches = read_launches()
    if "ivf_gamma" in steps[-1]["routes"]:
        raise AssertionError(f"no reroute off the degraded method: {steps}")
    if any(s["retrained"] for s in steps):
        raise AssertionError("the adaptation check retrained")
    return {"steps": steps, "rerouted_after": len(steps),
            "seconds": time.perf_counter() - t0, "launches": launches,
            "max_drift": adapter.table.max_drift()}


@contextlib.contextmanager
def span_device_events():
    """While open, every span opened through `trace.span` records a CUDA
    event at its open and at its close: the device time between the two
    reads beside the span's host time. Yields {id(span): (span, start,
    end)}."""
    marks: dict = {}
    enter, leave = trace_mod._SpanCtx.__enter__, trace_mod._SpanCtx.__exit__

    def on_enter(self):
        s = enter(self)
        if s is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[id(s)] = [s, ev, None]
        return s

    def on_exit(self, et, ev, tb):
        s = self._span
        if s is not None and id(s) in marks:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            marks[id(s)][2] = end
        return leave(self, et, ev, tb)

    trace_mod._SpanCtx.__enter__, trace_mod._SpanCtx.__exit__ = (on_enter,
                                                                 on_exit)
    try:
        yield marks
    finally:
        trace_mod._SpanCtx.__enter__ = enter
        trace_mod._SpanCtx.__exit__ = leave


def span_rows(root, marks: dict, depth: int = 0) -> list:
    out = [{"span": "  " * depth + root.name,
            "host_ms": root.duration_s * 1e3,
            "device_ms": (marks[id(root)][1].elapsed_time(marks[id(root)][2])
                          if id(root) in marks and marks[id(root)][2]
                          else None)}]
    for c in root.children:
        out += span_rows(c, marks, depth + 1)
    return out


def span_paths(root, prefix: tuple = ()) -> set:
    path = prefix + (root.name,)
    out = {path}
    for c in root.children:
        out |= span_paths(c, path)
    return out


def exact_router(ds_name: str):
    """A router whose one candidate is `prefilter` (exact search through
    the service's route → execute → group spans)."""
    table = BenchmarkTable.new()
    for pt in range(3):
        table.add(ds_name, pt, "prefilter", "exact", 1.0, 1.0)
    return constant_router(F.MINIMAL_FEATURES, ["prefilter"], table)


def run_serving_live_ops(live, router, routed: dict, build_dir: str) -> dict:
    """Phase 12 on phase 8's live handle after its compaction: (c) a cache
    in front of `RouterService(live, router)`, an upsert carrying the
    labels of one cached AND entry stales it while an entry over disjoint
    labels still hits; (e) a traced exact search, fused and staged, shows
    search → execute → group → live.base / live.delta (/ live.merge),
    each span's host ms beside the device ms between CUDA events at its
    open and close; the ledger shows the live gauges, a pinned
    snapshot's lease while pinned and none after its release."""
    batch = routed[int(Predicate.AND)]
    labels = [set(np.nonzero(np.unpackbits(batch.bitmaps[i].view(np.uint8),
                                           bitorder="little"))[0].tolist())
              for i in range(batch.q)]
    a = 0
    b = next(i for i in range(1, batch.q)
             if labels[i] and labels[a] and not labels[i] & labels[a])
    pair = QueryBatch(batch.vectors[[a, b]], batch.bitmaps[[a, b]],
                      Predicate.AND, 10)
    svc = RouterService(live, router, t=0.9)
    cache = SemanticResultCache(svc, threshold=None)
    reset_launches()
    tags = [cache.search(pair).cache, cache.search(pair).cache]
    live.upsert(pair.vectors[:1] + np.float32(0.01), pair.bitmaps[:1])
    after = cache.search(pair)
    tags.append(after.cache)
    fresh = svc.search(pair)
    launches = read_launches()
    st = cache.stats()
    cache.close()
    if tags != [[None, None], ["exact", "exact"], [None, "exact"]] \
            or st["evictions_stale"] != 1:
        raise AssertionError(f"live cache staleness: tags {tags}, {st}")
    if not np.array_equal(after.ids[0], fresh.ids[0]):
        raise AssertionError("the refilled live entry differs from a "
                             "fresh search")
    emit("serving.cache.live", tags=tags, launches=launches,
         stale_evicted=st["evictions_stale"], disjoint_labels_hit=True,
         cache=st)

    tracer = Tracer(seed=3)
    exact_svc = RouterService(live, exact_router(live.ds.name), t=0.9,
                              methods={"prefilter": get_method("prefilter")},
                              tracer=tracer)
    exact_svc.search(batch)                   # warm: features, tombstones
    trees = {}
    for mode in ("fused", "staged"):
        live.fused = mode == "fused"
        try:
            torch.cuda.synchronize()
            with span_device_events() as marks:
                exact_svc.search(batch)
                torch.cuda.synchronize()
        finally:
            live.fused = True
        root = tracer.recent()[-1]
        paths = span_paths(root)
        need = {("search", "execute", "group", "live.base"),
                ("search", "execute", "group", "live.delta")}
        if mode == "staged":
            need.add(("search", "execute", "group", "live.merge"))
        if not need <= paths:
            raise AssertionError(f"live span tree lacks {need - paths}")
        trees[mode] = span_rows(root, marks)
        emit(f"serving.spans.live_{mode}", tree=trees[mode],
             device_ms="CUDA events at each span's open and close")
    led = get_ledger()
    mine = led.snapshot()["gauges"].get(live._ledger_key)
    # one delta row: the mirror covers whole chunks only, so its device
    # bytes read 0 until a chunk seals
    if not mine or mine["delta_rows"] != 1 or mine["delta_host_bytes"] <= 0 \
            or "delta_device_bytes" not in mine:
        raise AssertionError(f"the ledger lacks the live gauges: {mine}")
    snap = live.snapshot()
    held = led.snapshot()["held"].get("snapshot_pin", {})
    snap.release()
    left = led.snapshot()["held"].get("snapshot_pin", {})
    if sum(a["leases"] for a in held.values()) < 1 or left:
        raise AssertionError(f"snapshot_pin leases: pinned {held}, after "
                             f"release {left}")
    emit("serving.ledger.live", gauges=mine, pinned_lease=held,
         after_release=left or None)
    return {"launches": launches}


def parse_exposition(text: str) -> dict:
    """Prometheus text format 0.0.4, strictly: HELP before TYPE once a
    family, every sample under a typed family, well-formed names and
    label sets, no duplicate samples, histogram buckets cumulative up to
    a +Inf equal to _count. Returns {family: samples}."""
    name_re = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    helps, types, seen, fams = set(), {}, set(), {}
    buckets: dict = {}
    counts: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split(" ")[2]
            if name in helps:
                raise AssertionError(f"two HELP lines for {name}")
            helps.add(name)
        elif line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            if name not in helps or name in types:
                raise AssertionError(f"TYPE of {name} out of order")
            types[name] = mtype
        else:
            m = re.fullmatch(rf"({name_re})(\{{(.*)\}})? (\S+)", line)
            if m is None:
                raise AssertionError(f"unparseable sample {line!r}")
            name, _, labels, value = m.groups()
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            fam = base if types.get(base) == "histogram" else name
            if fam not in types:
                raise AssertionError(f"sample {name} without TYPE")
            key = (name, labels)
            if key in seen:
                raise AssertionError(f"duplicate sample {key}")
            seen.add(key)
            float(value.replace("Inf", "inf"))
            fams[fam] = fams.get(fam, 0) + 1
            if name.endswith("_bucket"):
                series = re.sub(r',?le="[^"]*"', "", labels or "")
                buckets.setdefault((fam, series), []).append(
                    float(value.replace("Inf", "inf")))
            elif name.endswith("_count") and fam != name:
                counts[(fam, labels or "")] = float(value)
    for (fam, series), vals in buckets.items():
        if vals != sorted(vals) or vals[-1] != counts[(fam, series)]:
            raise AssertionError(f"histogram {fam}{{{series}}} is not "
                                 f"cumulative up to its count")
    return fams


def run_serving_metrics(surfaces: dict, queue) -> dict:
    """Phase 12 (e): `metrics_text` over every surface parses strictly
    with no duplicate samples; one scrape of `MetricsServer` on
    127.0.0.1:0 gets /metrics and /healthz with 200."""
    text = metrics_text(**surfaces)
    fams = parse_exposition(text)
    srv = MetricsServer(lambda: metrics_text(**surfaces),
                        health=backpressure_health(queue=queue),
                        ledger=surfaces["ledger"], slo=surfaces["slo"],
                        obslog=surfaces["obslog"])
    try:
        codes = {}
        for route in ("/metrics", "/healthz"):
            with urllib.request.urlopen(srv.url + route, timeout=30) as r:
                codes[route] = r.status
                body = r.read().decode()
            if route == "/metrics":
                parse_exposition(body)
            elif json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {body}")
    finally:
        srv.close()
    if codes != {"/metrics": 200, "/healthz": 200}:
        raise AssertionError(f"scrape codes {codes}")
    return {"families": len(fams), "samples": sum(fams.values()),
            "bytes": len(text), "scrape": codes, "port": srv.port}


# ---------------------------------------------------------------------------

# The sharded store's methods: the IVF pair, built on each shard.
IVF_PAIR = ("postfilter", "ivf_gamma")


def tree_bytes(path: str) -> int:
    """Bytes of every file under `path` (0 if it does not exist)."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def wal_records(store) -> int:
    """The committed WAL's complete records, read without repairing it."""
    m = store.manifest
    return len(WriteAheadLog.replay(os.path.join(store.path, m["wal"]),
                                    dim=m["dim"], width=m["width"],
                                    truncate=False))


def store_files(store) -> dict:
    """The committed generation on disk: the segment directory (vectors,
    bitmaps, groups, keys, index files), its index and delta-chunk files
    apart, and the WAL (bytes and records)."""
    seg = os.path.join(store.path, store.manifest["segment"])
    return {"segment_bytes": tree_bytes(seg),
            "index_bytes": tree_bytes(os.path.join(seg, "indexes")),
            "delta_chunk_bytes": tree_bytes(os.path.join(seg,
                                                         "delta_chunks")),
            "wal_bytes": os.path.getsize(os.path.join(
                store.path, store.manifest["wal"])),
            "wal_records": wal_records(store)}


@contextlib.contextmanager
def store_steps():
    """Time the steps of `IndexStore.open` while the block runs: the
    segment's load, each persisted index file's adoption, the WAL's read
    and the replay of its records, the delta-chunk adoption; and count
    the delta-chunk index builds (`live.build_chunk_index`). Yields the
    dict it fills."""
    out = {"load_segment_s": 0.0, "adopt": [], "wal_read_s": 0.0,
           "replay_s": 0.0, "adopt_chunks_s": 0.0, "chunk_builds": 0}
    saved = {"load": ANNDataset.__dict__["load_segment"],
             "read": WriteAheadLog.__dict__["replay"],
             "file": IndexStore.__dict__["_adopt_index_file"],
             "apply": IndexStore._apply_records,
             "chunks": IndexStore._adopt_chunk_indexes,
             "build": live_mod.build_chunk_index}

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                out[key] += time.perf_counter() - t0
        return call

    def adopt(fx, seg_dir, fname, method, bp_t):
        t0 = time.perf_counter()
        saved["file"].__func__(fx, seg_dir, fname, method, bp_t)
        out["adopt"].append({
            "method": method.name, "file": fname,
            "bytes": os.path.getsize(os.path.join(seg_dir, fname)),
            "seconds": time.perf_counter() - t0})

    def build(*a, **kw):
        out["chunk_builds"] += 1
        return saved["build"](*a, **kw)
    ANNDataset.load_segment = staticmethod(
        timed(saved["load"].__func__, "load_segment_s"))
    WriteAheadLog.replay = staticmethod(
        timed(saved["read"].__func__, "wal_read_s"))
    IndexStore._adopt_index_file = staticmethod(adopt)
    IndexStore._apply_records = timed(saved["apply"], "replay_s")
    IndexStore._adopt_chunk_indexes = timed(saved["chunks"],
                                            "adopt_chunks_s")
    live_mod.build_chunk_index = build
    try:
        yield out
    finally:
        ANNDataset.load_segment = saved["load"]
        WriteAheadLog.replay = saved["read"]
        IndexStore._adopt_index_file = saved["file"]
        IndexStore._apply_records = saved["apply"]
        IndexStore._adopt_chunk_indexes = saved["chunks"]
        live_mod.build_chunk_index = saved["build"]


def open_store(path: str):
    """`IndexStore.open(path)` on the card, timed, under `method_seconds`
    and `store_steps`. Returns (the store, a line's fields, the method
    builds the open ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with method_seconds() as calls, store_steps() as steps:
        t0 = time.perf_counter()
        store = IndexStore.open(path)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
    builds = [c for c in calls if c["step"] == "build"]
    fields = {"open_s": open_s, **steps,
              "adopt_s": sum(a["seconds"] for a in steps["adopt"]),
              "replayed_records": store.stats()["replayed_records"],
              "generation": store.index.generation,
              "method_builds": len(builds),
              "peak_device_mb_open": torch.cuda.max_memory_allocated() / 1e6}
    return store, fields, builds


def store_exact(index, batches: dict, want: dict | None, what: str) -> dict:
    """Each exact batch read on a store's handle; ids, keys and distance
    bits identical to `want` when given. Returns the answers."""
    got = {}
    for pred, batch in batches.items():
        got[pred] = index.search(batch, "prefilter")
        if want is not None and not same_bits(got[pred], want[pred]):
            raise AssertionError(f"{what}: the read differs, "
                                 f"{PRED_NAMES[pred]}")
    return got


def store_routed(store, ds, table_rows, routed: dict, decisions: dict,
                 want: dict | None, what: str) -> dict:
    """Each routed batch through `RouterService` over the store's handle
    with the store's linked router (`load_router`, validated against its
    version stamps) and the main path's table-B rows: the decisions
    `decisions`, and the answers bit-identical to `want` when given.
    Returns the answers."""
    router = store.load_router()
    for r in table_rows:
        router.table.add(ds.name, r.pred, r.method, r.ps_id, r.mean_recall,
                         r.qps)
    svc = RouterService(store.index, router, t=0.9)
    got = {}
    for pred, batch in routed.items():
        res = got[pred] = svc.search(batch)
        if res.decisions != decisions[pred]:
            raise AssertionError(f"{what}: routing decisions differ from "
                                 f"phase 8's, {PRED_NAMES[pred]}")
        if want is not None and not same_bits(res, want[pred]):
            raise AssertionError(f"{what}: the routed read differs, "
                                 f"{PRED_NAMES[pred]}")
    return got


def counted_reads(total: dict, reads) -> tuple[dict, float]:
    """Run `reads()` with the launch counts set to 0 just before and read
    just after; adds them to `total`. Returns (the counts, seconds)."""
    t0 = time.perf_counter()
    reset_launches()
    reads()
    counts = read_launches()
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    return counts, time.perf_counter() - t0


def hold_store_kernels(live, batches: dict) -> dict:
    """The kernels of a recovered handle's exact reads held against their
    plain versions on that handle's own inputs, as phases 8 and 10 hold
    theirs, with the tolerance of `check_live_path_kernels`: on the single
    handle, or shard 0 of a sharded one, `fused_live` on the fused read's
    inputs (when its delta holds rows) through `hold_fused_to_plain`, and
    the base overfetch's first 64-query chunk at the read's own KB
    (`masked_topk` up to MAX_K, `masked_topk_large` past it) through
    `hold_to_plain`; and every `merge_topk` fold of the whole read (each
    shard's staged fold, the cross-shard fold) bit for bit against
    `merge_topk_plain`, then timed beside `torch.topk` (`merge_yardstick`).
    Its launches are made outside the counted reads. Returns the largest
    error of each kernel held, each batch's KB, the folds held and their
    times."""
    shard = live.shards[0] if isinstance(live, ShardedLiveIndex) else live
    dd = shard.device
    dev = shard.torch_device
    d = dd.vectors.shape[1]
    prefilter = get_method("prefilter")
    errs, kbs, folds, fold_times = {}, {}, 0, []
    flush = None
    for pred, batch in batches.items():
        with shard.snapshot() as snap:
            dead = int(snap.tombstones[: snap.base_n].sum())
            b_ids, _ = shard._run_base(
                prefilter, prefilter.param_settings()[0], batch, snap, dead)
            fused = shard.fused and snap.delta_rows > 0
        kb = kbs[PRED_NAMES[pred]] = b_ids.shape[1]
        if fused:
            args, kw, _ = live_kernel_inputs(shard, batch)
            qv, qb, dvec = args[0], args[1], args[4]
        else:
            qv = to_device(batch.vectors, dev)
            qb = to_device(batch.bitmaps, dev)
            dvec = dd.vectors[:0]
        vn = max(float(dd.norms.max()),
                 float((dvec ** 2).sum(1).max()) if dvec.shape[0] else 0.0
                 ) ** 0.5
        qn = float(qv.norm(dim=1).max())
        tol = 2 * d * 2.0 ** -24 * (vn * vn + 2 * qn * vn)
        if fused:
            gd, gi = mk.fused_live_accum(*args, **kw, pred=pred, k=batch.k)
            pd, pi = mk.fused_live_plain(*args, **kw, pred=pred, k=batch.k)
            errs["fused_live"] = max(errs.get("fused_live", 0.0),
                                     hold_fused_to_plain(pred, args, kw, gd,
                                                         gi, pd, pi, tol))
        base = (qv[:DEFAULT_QCHUNK], qb[:DEFAULT_QCHUNK], dd.vectors,
                dd.norms, dd.bitmaps)
        large = kb > mk.MAX_K
        scan = "masked_topk_large" if large else "masked_topk"
        gd, gi = (mk.masked_topk_large if large else mk.masked_topk_accum)(
            *base, pred=pred, k=kb)
        pd, pi = mk.masked_topk_plain(*base, pred=pred, k=kb)
        errs[scan] = max(errs.get(scan, 0.0),
                         hold_to_plain(scan, pred, base, gd, gi, pd, pi, tol))
        with captured_merges() as merges:
            live.search(batch, "prefilter")
        if merges and flush is None:
            flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        for ids, dists, k in merges:
            it = ids.to(torch.int32).contiguous()
            k = it.shape[-1] if k is None else k
            fold_times.append(merge_yardstick(
                dists.to(torch.float32).contiguous(), it, k, flush))
            errs["merge_topk"] = 0.0
        folds += len(merges)
    return {"max_abs_err": errs, "kb": kbs, "merge_folds_held": folds,
            "merge_folds": fold_times}


def flip_table_digit(router_dir: str) -> None:
    """Change one digit of the first recall in the router's table.json:
    the same format versions, other content."""
    path = os.path.join(router_dir, "table.json")
    with open(path) as f:
        text = f.read()
    at = text.index('"recall": ') + len('"recall": ') + 2
    with open(path, "w") as f:
        f.write(text[:at] + ("1" if text[at] != "1" else "2")
                + text[at + 1:])


def run_single_store(root: str, fx, ds, table_rows, phase8: dict,
                     batches: dict, routed: dict, launches: dict) -> dict:
    """Phase 11's single store, in `root`: a `LiveFilteredIndex(ds,
    delta_chunk=LIVE_CHUNK)` on the card adopting phase 5's built indexes,
    `IndexStore.create` linking `router_all`; phase 8's writes through
    the WAL (A: the exact reads after the upserts, B: after the deletes,
    equal to phase 8's fused answers `phase8["fused"]`, routed with its
    decisions to its answers `phase8["routed"]`); then close/open (reads
    equal B, 0 builds), a torn WAL tail (reads equal A, their kernels
    held to the plain versions; the deletes re-issued), `checkpoint()` and
    open (the seeded records replayed, the 64 delta-chunk indexes adopted
    and none built), a byte of the WAL's first record damaged (open
    refuses the mid-log corruption and leaves the file), and a router
    artifact edited under the store (open refuses it). Recovered reads add
    their launch counts to `launches`. Returns a summary."""
    out = {}
    path = os.path.join(root, "single")
    router_dir = os.path.join(ASSETS, "router_all")
    t0 = time.perf_counter()
    live = LiveFilteredIndex(ds, delta_chunk=LIVE_CHUNK)
    for m_name, bp in fx.built_keys():
        live._base_fx.adopt_index(m_name, bp, fx.get_index(m_name, bp))
    live.device
    torch.cuda.synchronize()
    handle_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with method_seconds() as calls:
        store = IndexStore.create(path, live, router_dir=router_dir)
    out["create_s"] = time.perf_counter() - t0
    if calls:
        raise AssertionError("IndexStore.create built or grafted an index")
    emit("store.create", handle_s=handle_s, create_s=out["create_s"],
         adopted_from_phase5=[list(k) for k in live.built_keys()],
         persisted=[[b[0], b[2]] for b in store.manifest["built"]],
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6,
         **store_files(store))

    wal_path = os.path.join(path, store.manifest["wal"])
    answers = {}

    def after_upserts():
        answers["wal_bytes"] = os.path.getsize(wal_path)
        answers["A"] = store_exact(store.index, batches, None, "")
    t0 = time.perf_counter()
    w = live_writes(store.index, ds, between=after_upserts)
    writes_s = time.perf_counter() - t0
    want_a = answers["A"]
    want_b = store_exact(store.index, batches, phase8["fused"],
                         "the store's handle against phase 8's fused read")
    routed_b = store_routed(store, ds, table_rows, routed,
                            phase8["decisions"], phase8["routed"],
                            "the store's handle")
    emit("store.writes", upserts=LIVE_UPSERTS, deletes=int(w["dead"].size),
         sync_every=1, writes_s=writes_s,
         same_as_phase8_fused="bit-identical", same_decisions=True,
         routed_same_as_phase8="bit-identical",
         **store_files(store))
    store.close()

    store, fields, _ = open_store(path)
    if fields["method_builds"] or fields["replayed_records"] != 2:
        raise AssertionError(f"open: {fields['method_builds']} builds, "
                             f"{fields['replayed_records']} records")

    def recovered():
        store_exact(store.index, batches, want_b, "recovered exact")
        store_routed(store, ds, table_rows, routed, phase8["decisions"],
                     routed_b, "recovered routed")
    counts, reads_s = counted_reads(launches, recovered)
    out["open_s"] = fields["open_s"]
    emit("store.open", **fields, reads_s=reads_s, launches=counts,
         same_as_before_close="bit-identical", same_decisions=True,
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6)
    store.close()

    # a crash mid-way through the last record (the deletes)
    size = os.path.getsize(wal_path)
    last = size - answers["wal_bytes"]
    with open(wal_path, "r+b") as f:
        f.truncate(size - last // 2)
    store, fields, _ = open_store(path)
    if (fields["method_builds"] or fields["replayed_records"] != 1
            or os.path.getsize(wal_path) != answers["wal_bytes"]):
        raise AssertionError("the torn tail was not truncated to the "
                             "upserts' record")
    counts, reads_s = counted_reads(launches, lambda: store_exact(
        store.index, batches, want_a, "torn-tail reopen"))
    held = hold_store_kernels(store.index, batches)
    out["max_abs_err"] = held["max_abs_err"]
    if store.index.delete(w["dead"]) != w["dead"].size:
        raise AssertionError("the re-issued deletes were not all fresh")
    store_exact(store.index, batches, want_b, "deletes re-issued")
    emit("store.torn_tail", cut_bytes=last - last // 2, record_bytes=last,
         **fields, reads_s=reads_s, launches=counts, held_to_plain=held,
         same_as_upserts_only="bit-identical", deletes_reissued=True,
         **store_files(store))

    chunks = store.index.stats()["delta_chunk_indexes"]
    t0 = time.perf_counter()
    store.checkpoint()
    out["checkpoint_s"] = time.perf_counter() - t0
    files = store_files(store)
    seeds = files["wal_records"]
    if len(store.manifest["delta_chunks"]["files"]) != chunks:
        raise AssertionError("checkpoint did not persist every chunk index")
    emit("store.checkpoint", checkpoint_s=out["checkpoint_s"],
         delta_chunk_indexes=chunks, **files)
    store.close()
    store, fields, _ = open_store(path)
    adopted = store.index.stats()["delta_chunk_indexes"]
    if (fields["method_builds"] or fields["chunk_builds"]
            or adopted != chunks or chunks != LIVE_UPSERTS // LIVE_CHUNK
            or fields["replayed_records"] != seeds):
        raise AssertionError(f"open after checkpoint: {fields}, {adopted} "
                             f"chunk indexes of {chunks}")
    counts, reads_s = counted_reads(launches, lambda: store_exact(
        store.index, batches, want_b, "open after checkpoint"))
    if store.index.stats()["delta_chunk_indexes"] != chunks:
        raise AssertionError("a read rebuilt a delta-chunk index")
    emit("store.open_checkpointed", **fields, delta_chunk_indexes=adopted,
         reads_s=reads_s, launches=counts, same_as_before="bit-identical")

    copy = os.path.join(root, "router_copy")
    shutil.copytree(router_dir, copy)
    store.link_router(copy)
    store.close()

    # a damaged byte inside the first record, valid records after it
    wal_path = os.path.join(path, store.manifest["wal"])
    size = os.path.getsize(wal_path)
    at = 24 + 21 + 4 + 8               # the first record's second key
    with open(wal_path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))
    t0 = time.perf_counter()
    try:
        IndexStore.open(path).close()
    except ValueError as e:
        if "mid-log corruption" not in str(e):
            raise
        refused = str(e).split(":")[0]
    else:
        raise AssertionError("a WAL with a damaged first record opened")
    refuse_s = time.perf_counter() - t0
    if os.path.getsize(wal_path) != size:
        raise AssertionError("the refused WAL was truncated")
    with open(wal_path, "r+b") as f:
        f.seek(at)
        f.write(byte)
    emit("store.midlog_corruption", refused=refused, refuse_s=refuse_s,
         damaged_byte=at, wal_bytes=size, wal_untouched=True)
    flip_table_digit(copy)
    try:
        IndexStore.open(path).close()
    except ValueError as e:
        if "content changed" not in str(e):
            raise
        refused = str(e).split(";")[0]
    else:
        raise AssertionError("a store opened over an edited router artifact")
    out["dir_bytes"] = tree_bytes(root)
    emit("store.router_swap", refused=refused, dir_bytes=out["dir_bytes"])
    shutil.rmtree(path)
    return out


def run_sharded_store(root: str, ds, batches: dict, launches: dict) -> dict:
    """Phase 11's sharded store, in `root`: `ShardedLiveIndex(ds, SHARDS,
    delta_chunk=LIVE_CHUNK)` on the one card with the IVF pair built on
    each shard, `IndexStore.create`; phase 8's writes with a
    `compact_async()` barrier logged between the upserts and the deletes,
    which race the compaction (logged at the old generation, before its
    swap); close and open (the replay re-runs the compaction: only its
    rebuilds on the new shards, none of the persisted files; reads
    bit-identical to the handle's before the close, their kernels held to
    the plain versions), then `checkpoint()` and open again (every
    per-shard index adopted, 0 builds). Recovered reads add their launch
    counts to `launches`. Returns a summary."""
    out = {}
    path = os.path.join(root, "sharded")
    t0 = time.perf_counter()
    live4 = ShardedLiveIndex(ds, SHARDS, delta_chunk=LIVE_CHUNK)
    for shard in live4.shards:
        shard.device
    build = build_on([sh._base_fx for sh in live4.shards], IVF_PAIR)
    handle_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with method_seconds() as calls:
        store = IndexStore.create(path, live4)
    out["create_s"] = time.perf_counter() - t0
    if calls:
        raise AssertionError("IndexStore.create built or grafted an index")
    emit("store.sharded.create", shards=SHARDS, handle_s=handle_s,
         build_s=build, create_s=out["create_s"],
         persisted=[[b[0], b[2]] for b in store.manifest["built"]],
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6,
         **store_files(store))

    wal_path = os.path.join(path, store.manifest["wal"])
    index = store.index
    state = {}

    def barrier():
        size = os.path.getsize(wal_path)
        state["fut"] = index.compact_async()
        deadline = time.perf_counter() + 300
        while os.path.getsize(wal_path) == size:   # the barrier's record
            if time.perf_counter() > deadline:
                raise AssertionError("the compaction logged no barrier")
            time.sleep(0.001)
        index._lock.acquire()        # the deletes land before the swap
        state["locked"] = True
    t0 = time.perf_counter()
    try:
        live_writes(index, ds, between=barrier)
    finally:
        if state.get("locked"):
            index._lock.release()
    gen = state["fut"].result()
    writes_s = time.perf_counter() - t0
    want = store_exact(index, batches, None, "")
    emit("store.sharded.writes", upserts=LIVE_UPSERTS,
         deletes=LIVE_BASE_DELETES + LIVE_DELTA_DELETES,
         deletes_raced_the_compaction=True, generation=gen,
         writes_and_compaction_s=writes_s, **store_files(store))
    store.close()

    # the replayed compaction rebuilds the IVF pair on each new shard; the
    # files of generation 0's shards are adopted, not rebuilt
    store, fields, builds = open_store(path)
    if (fields["method_builds"] != SHARDS * len(IVF_PAIR)
            or fields["replayed_records"] != 3 or fields["generation"] != 1):
        raise AssertionError(f"sharded open: {fields}")
    counts, reads_s = counted_reads(launches, lambda: store_exact(
        store.index, batches, want, "recovered sharded exact"))
    held = hold_store_kernels(store.index, batches)
    out["max_abs_err"] = held["max_abs_err"]
    out["merge_folds"] = held.pop("merge_folds")
    out["open_replay_s"] = fields["open_s"]
    emit("store.sharded.open", **fields,
         compaction_rebuilds=[[b["method"], b["seconds"]] for b in builds],
         reads_s=reads_s, launches=counts, held_to_plain=held,
         same_as_before_close="bit-identical")
    t0 = time.perf_counter()
    store.checkpoint()
    out["checkpoint_s"] = time.perf_counter() - t0
    emit("store.sharded.checkpoint", checkpoint_s=out["checkpoint_s"],
         **store_files(store))
    files = sum(len([f for f in b[2] if f]) for b in store.manifest["built"]
                if isinstance(b[2], list))
    store.close()
    store, fields, _ = open_store(path)
    if (fields["method_builds"] or len(fields["adopt"]) != files
            or files < SHARDS * len(IVF_PAIR) or fields["generation"] != 1):
        raise AssertionError(f"sharded open after checkpoint: {fields}")
    counts, reads_s = counted_reads(launches, lambda: store_exact(
        store.index, batches, want, "sharded open after checkpoint"))
    out["open_s"] = fields["open_s"]
    emit("store.sharded.open_checkpointed", **fields, reads_s=reads_s,
         launches=counts, same_as_before_close="bit-identical")
    store.close()
    out["dir_bytes"] = tree_bytes(root)
    shutil.rmtree(path)
    return out


def merge_by_input(yard: dict, store_folds: list) -> dict:
    """`merge_topk`'s entries of the kernels' line by input kind: phase
    8's kinds (sums over the predicates, with each predicate's), and
    phase 11's recovered sharded store's folds (each shard's [1, 256, KB]
    staged fold, the cross-shard [4, 256, 10] fold): the regime, ms,
    `torch.topk` ms on the query-major copy, the bound, the workspace
    select's ms where the scans' promise makes the kernel step, and where
    PERF.md has one the time before the redesign, labelled as copied."""
    out = {}
    for kind, o in yard.items():
        pp = o["per_predicate"]
        out[kind] = {
            "shape": pp[0]["shape"], "k": pp[0]["k"],
            "promise": pp[0]["promise"], "regime": pp[0]["regime"],
            "ms": o["ms"],
            "torch_topk_ms": o["library_ms"], "bound_ms": o["bound_s"] * 1e3,
            "per_predicate_ms": [y["ms"] for y in pp],
            "per_predicate_torch_topk_ms": [y["torch_topk_ms"] for y in pp]}
        if "workspace_select_ms" in pp[0]:
            out[kind]["workspace_select_per_predicate_ms"] = [
                y["workspace_select_ms"] for y in pp]
        if kind in MERGE_EARLIER_MS:
            out[kind].update(
                earlier_ms=sum(MERGE_EARLIER_MS[kind]),
                earlier_per_predicate_ms=MERGE_EARLIER_MS[kind],
                earlier_source="copied from PERF.md (before the redesign), "
                               "not measured by this run")
    for kind, folds in (
            ("store_shard_folds", [y for y in store_folds
                                   if y["shape"][0] == 1]),
            ("store_cross_shard_folds", [y for y in store_folds
                                         if y["shape"][0] > 1])):
        if folds:
            out[kind] = {
                "shapes": sorted({tuple(y["shape"]) for y in folds}),
                "k": sorted({y["k"] for y in folds}), "folds": len(folds),
                "ms": sum(y["ms"] for y in folds),
                "torch_topk_ms": sum(y["torch_topk_ms"] for y in folds),
                "bound_ms": sum(y["bound_ms"] for y in folds),
                "slowest_over_torch_topk": max(
                    y["ms"] / y["torch_topk_ms"] for y in folds)}
    return out


# ---------------------------------------------------------------------------
# phase 13: the router's offline stage
# ---------------------------------------------------------------------------

# (a) is `router_all`'s own recipe (CHANGES.md, PR 16): the six training
# specs at the repo's sizes, TRAIN_QUERIES queries a predicate, seed 0,
# the five candidates in the router's method order. (b) is its fit.
TRAIN_QUERIES = 60
TRAIN_HIDDEN = (64, 32)
TRAIN_EPOCHS = 200
# (a) The port's sweep on the CPU gives the JAX package's table-B recalls
# exactly on the tiny spec (tests/test_torch_training.py), and at this
# recipe 281 of `router_all`'s 288 entries; the 7 others are fvamana
# entries at the beam search's fp32 near-ties (ROADMAP queue 3 item 3),
# |delta mean recall| <= 0.005, 3 of a cell's 600 result slots
# (`run_train_sweep(torch.device("cpu"))`). On the card an id can part
# from the CPU's only at such ties too, in a search or in the card's
# graph build. SWEEP_TOL, ten times that, bounds every entry.
SWEEP_TOL = 0.05
# (b) A fit on the card and one on the CPU start from the same
# parameters (`init_mlp` draws on the host) and take the same batches,
# and part only by the two devices' fp32 rounding. On these labels (many
# queries share a feature row, with different recalls) the fit is
# chaotic in that rounding: on the CPU, inputs moved by one ulp move the
# fitted predictions about as far as the card's fit parts from the CPU's
# (PERF.md, PR 21: 0.003 against 0.0049), while the final MSE stays
# within 5e-4 relative. So the card's fit is held to the CPU's by its
# final MSE (MSE_RTOL) and its predictions within FIT_TOL, each about 20
# times those; each run prints the one-ulp spread beside them.
MSE_RTOL = 0.01
FIT_TOL = 0.1


def run_train_sweep(dev) -> tuple:
    """Phase 13 (a): `training.collect` over the six training specs from
    `get_dataset`, each opened as `FilteredIndex(ds)` on `dev`, one call a
    dataset; one line a cell (its timed searches' seconds, each method's
    best setting and mean recall); every table-B recall entry against
    `router_all/table.json`, key by key (a missing or extra key fails, an
    entry past SWEEP_TOL fails). Returns (the merged collection, the
    handles, a summary)."""
    methods = {m: get_method(m) for m in training.METHOD_ORDER}
    cells, table, handles, dataset_s = {}, BenchmarkTable.new(), {}, {}
    t_all = time.perf_counter()
    for name in TRAIN_SPECS:
        t0 = time.perf_counter()
        ds = get_dataset(name)
        fx = handles[name] = FilteredIndex(ds, device=dev)
        coll = training.collect({name: fx}, methods, n_queries=TRAIN_QUERIES,
                                seed=0, verbose=False)
        dataset_s[name] = time.perf_counter() - t0
        cells.update(coll.cells)
        table.entries.update(coll.table.entries)
        for (d, pt), cell in sorted(coll.cells.items()):
            emit("train.sweep", dataset=d, pred=PRED_NAMES[pt],
                 search_s=sum(TRAIN_QUERIES / qps for *_, qps in cell.sweep),
                 best={m: [cell.best_ps[m], float(cell.recall[m].mean())]
                       for m in training.METHOD_ORDER})
        emit("train.sweep.dataset", dataset=name, rows=ds.n, dim=ds.dim,
             seconds=dataset_s[name])
    want = BenchmarkTable.load(os.path.join(ASSETS, "router_all",
                                            "table.json")).entries
    if set(want) != set(table.entries):
        raise AssertionError(
            f"table B's keys differ from router_all's: missing "
            f"{sorted(set(want) - set(table.entries))[:5]}, extra "
            f"{sorted(set(table.entries) - set(want))[:5]}")
    delta = {key: table.entries[key]["recall"] - cell["recall"]
             for key, cell in want.items()}
    differ = {key: d for key, d in delta.items() if d != 0.0}
    worst = max(abs(d) for d in delta.values())
    summary = {"seconds": time.perf_counter() - t_all, "dataset_s": dataset_s,
               "entries": len(want), "equal": len(want) - len(differ),
               "differ": len(differ),
               "differ_by_method": {m: sum(k[2] == m for k in differ)
                                    for m in training.METHOD_ORDER},
               "max_abs_delta": worst, "tolerance": SWEEP_TOL,
               "differing": [[*k, d] for k, d in sorted(differ.items())]}
    emit("train.sweep.summary", **summary)
    if worst > SWEEP_TOL:
        raise AssertionError(f"table B parts from router_all's by {worst} "
                             f"> {SWEEP_TOL}: {summary['differing'][:10]}")
    return training.Collection(cells=cells, table=table), handles, summary


@contextlib.contextmanager
def timed_fits():
    """While open, the seconds of each `mlp.train_mlp` call, to the end of
    its device work, are appended to the yielded list."""
    real, out = mlp.train_mlp, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        params = real(*args, **kw)
        if params[0]["w"].is_cuda:
            torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return params
    mlp.train_mlp = timed
    try:
        yield out
    finally:
        mlp.train_mlp = real


def run_train_fits(coll, dev) -> tuple:
    """Phase 13 (b): `training.train_models` on the collection with the
    minimal features, hidden TRAIN_HIDDEN and TRAIN_EPOCHS epochs, on
    `dev`, then the same call on the host's CPU (the same initial
    parameters and batch order), and a CPU fit of the inputs moved up by
    one ulp (the fit's own rounding sensitivity): each method's seconds
    on each device, its final MSE on the training X, and the largest
    |delta prediction| of the card's fit and of the moved one against
    the CPU's. Fails past MSE_RTOL or FIT_TOL. Returns (the card's
    models, its scaler, a summary)."""
    x_raw, y, _ = training.assemble_xy(coll, F.MINIMAL_FEATURES)
    kw = dict(hidden=TRAIN_HIDDEN, epochs=TRAIN_EPOCHS)
    fits, secs = {}, {}
    for where in (dev, torch.device("cpu")):
        with timed_fits() as s:
            fits[where.type] = training.train_models(
                coll, F.MINIMAL_FEATURES, device=where, **kw)
        secs[where.type] = dict(zip(training.METHOD_ORDER, s))
    moved, _ = training.train_models_from_xy(
        np.nextafter(x_raw, np.float32(np.inf)), y, training.METHOD_ORDER,
        device="cpu", **kw)
    (models, scaler), (cpu_models, cpu_scaler) = fits[dev.type], fits["cpu"]
    if not (np.array_equal(scaler.mean, cpu_scaler.mean)
            and np.array_equal(scaler.std, cpu_scaler.std)):
        raise AssertionError("the two fits' scalers differ")
    xs = scaler.transform(x_raw)

    def fitted(layers, where):
        return mlp.predict(mlp.params_from_numpy(layers, where), xs)[:, 0]
    per = {}
    for j, m in enumerate(training.METHOD_ORDER):
        got, ref = fitted(models[m], dev), fitted(cpu_models[m], "cpu")
        mse = float(np.mean((got - y[:, j]) ** 2))
        cpu_mse = float(np.mean((ref - y[:, j]) ** 2))
        per[m] = {"card_s": secs[dev.type][m], "cpu_s": secs["cpu"][m],
                  "mse": mse, "cpu_mse": cpu_mse,
                  "mse_rel_delta": abs(mse - cpu_mse) / cpu_mse,
                  "max_abs_delta": float(np.abs(got - ref).max()),
                  "cpu_one_ulp_max_abs_delta": float(np.abs(
                      fitted(moved[m], "cpu") - ref).max())}
    summary = {"rows": int(x_raw.shape[0]), "features": F.MINIMAL_FEATURES,
               "hidden": list(TRAIN_HIDDEN), "epochs": TRAIN_EPOCHS,
               "steps": TRAIN_EPOCHS * (x_raw.shape[0]
                                        // min(256, x_raw.shape[0])),
               "methods": per,
               "max_abs_delta": max(v["max_abs_delta"] for v in per.values()),
               "max_mse_rel_delta": max(v["mse_rel_delta"]
                                        for v in per.values()),
               "fit_tol": FIT_TOL, "mse_rtol": MSE_RTOL}
    emit("train.fit", **summary)
    if summary["max_abs_delta"] > FIT_TOL \
            or summary["max_mse_rel_delta"] > MSE_RTOL:
        raise AssertionError(f"the card's fit parts from the CPU's: {per}")
    return models, scaler, summary


def run_train_router(fx, models, scaler, train_table, rows, routed: dict,
                     truth: dict, router_all_recall: dict,
                     build_dir: str) -> dict:
    """Phase 13 (c): a router from the card's fit, its table the sweep's
    entries merged with phase 5's rows for the handle `fx` (as
    `build_all` merges two collections), saved with `MLRouter.save` and
    opened with `MLRouter.load` (decisions identical before and after);
    then `RouterService(fx, router, t=0.9)` on phase 5's routed batches:
    every answer passes its predicate (`check_result`) and is bit-identical
    to `fx.run_method` of its query's decision; the decisions and
    recall@10 against `truth` beside `router_all`'s."""
    table = BenchmarkTable.new()
    table.entries.update(train_table.entries)
    for r in rows:
        table.add(fx.ds.name, r.pred, r.method, r.ps_id, r.mean_recall,
                  r.qps)
    router = MLRouter(feature_names=F.MINIMAL_FEATURES,
                      methods=training.METHOD_ORDER, models=models,
                      scaler=scaler, table=table)
    path = tempfile.mkdtemp(prefix="router-", dir=build_dir)
    try:
        router.save(path)
        loaded = MLRouter.load(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    svc = RouterService(fx, loaded, t=0.9)
    out = {}
    for pred, batch in routed.items():
        name = PRED_NAMES[pred]
        before = router.route(fx.ds, batch.bitmaps, pred, 0.9, fx=fx)
        if loaded.route(fx.ds, batch.bitmaps, pred, 0.9, fx=fx) != before:
            raise AssertionError(f"the trained router decides otherwise "
                                 f"after save and load, {name}")
        res = svc.search(batch)
        if list(res.decisions) != before:
            raise AssertionError(f"the service's decisions are not the "
                                 f"router's, {name}")
        check_result(fx.ds, batch, res, f"trained router {name}")
        groups = {}
        for qi, d in enumerate(res.decisions):
            groups.setdefault(tuple(d), []).append(qi)
        for (m, ps), idxs in groups.items():
            idxs = np.asarray(idxs)
            sub = batch.take(idxs)
            method = get_method(m)
            ids, raw = fx.run_method(method, resolve_setting(method, ps), sub)
            dist = exact_distances(raw, ids, sub.vectors)
            if not (np.array_equal(ids, res.ids[idxs]) and np.array_equal(
                    dist.view(np.int32), res.distances[idxs].view(np.int32))):
                raise AssertionError(f"routed answers differ from "
                                     f"run_method's, {name} {m}/{ps}")
        hist = {}
        for m, ps in res.decisions:
            hist[f"{m}/{ps}"] = hist.get(f"{m}/{ps}", 0) + 1
        out[name] = {"decisions": hist, "recall_at_10": float(
            recall_at_k(res.ids, truth[pred]).mean()),
            "router_all_recall_at_10": router_all_recall[name],
            "route_s": res.timings["route_s"],
            "search_s": res.timings["search_s"]}
        emit("train.routed", pred=name, q=batch.q, **out[name],
             same_after_save_load=True, answers_as_run_method=True)
    return out


def run_train_retrain(fx, batch) -> dict:
    """Phase 13 (d): the JAX package's `test_default_retrain_learns_from_
    audit_labels` on the handle `fx`: `constant_router` over the IVF pair
    with ivf_gamma served through `DegradedMethod(keep=1)`, and an
    `OnlineRouterAdapter` with no `retrain_fn`, whose default retrain
    fits `train_models_from_xy` on audit labels on the handle's device.
    It must retrain within 8 steps; a promotion must have beaten the
    incumbent, a rollback keeps it."""
    router = constant_router(F.MINIMAL_FEATURES, ["ivf_gamma", "postfilter"],
                             two_method_table(fx.ds.name))
    serving = dict(candidate_methods())
    serving["ivf_gamma"] = DegradedMethod(serving["ivf_gamma"], keep=1)
    sink = TelemetrySink(capacity=512, reservoir=96, seed=6)
    svc = RouterService(fx, router, t=0.9, methods=serving, telemetry=sink)
    adapter = OnlineRouterAdapter(svc, sink, alpha=0.5, drift_threshold=0.05,
                                  min_samples=8, retrain_epochs=30,
                                  retrain_hidden=(16,), seed=7)
    t0 = time.perf_counter()
    report = None
    for step in range(8):
        svc.search(batch)
        rep = adapter.step()
        if rep["retrained"]:
            report = rep
            break
    if report is None or "shadow" not in report:
        raise AssertionError(f"no retrain from audit labels: "
                             f"{adapter.history}")
    shadow = report["shadow"]
    if report["promoted"]:
        if svc.router is router or not (shadow["candidate_recall"]
                                        > shadow["incumbent_recall"]):
            raise AssertionError(f"a promotion that did not win: {report}")
    elif svc.router is not router:
        raise AssertionError("a rollback replaced the incumbent")
    return {"steps": step + 1, "seconds": time.perf_counter() - t0,
            "retrained": report["retrained"],
            "promoted": report["promoted"], "shadow": shadow,
            "routes_after": sorted({d.method for d in svc.route(batch)})}


# ---------------------------------------------------------------------------
# phase 14: the RAG example's served LM at qwen2-0.5b's full width
# ---------------------------------------------------------------------------

# The model `examples/rag_serve.py` serves by default, at its full width
# (24 layers, d_model 896, 14 heads, 2 KV heads, d_ff 4,864, vocab
# 151,936), random weights from seed 0 as both serving drivers use.
RAG_ARCH = "qwen2-0.5b"
RAG_PARAMS = 630_167_424
# (b) the card against the machine's CPU, fp32 compute with TF32 off:
# B_PROMPTS prompts of B_LEN tokens, B_NEW greedy tokens each. On the
# CPU (this port at 2-8 layers of full width) the prefill's and the first
# decode step's logits move by 4-6e-6 when the input embeddings move by
# one ulp, at logits of magnitude 4.5; the card's and the CPU's fp32
# GEMMs part by their summation orders in each of the 24 layers' seven
# products, a random walk of about 170 such roundings. B_TOL is about
# 200 times the one-ulp move; each run prints the one-ulp move at full
# depth on the machine's CPU beside it.
B_PROMPTS, B_LEN, B_NEW = 2, 64, 8
B_TOL = 1e-3
# (c) and (d): the reference's own prefill/decode tolerance on bf16
# (tests/test_models.py::test_prefill_decode_consistency).
C_LEN = 16
BF16_TOL = 0.15
# (d) the RAG example's traffic: RAG_REQUESTS requests of RAG_PROMPT
# tokens drawn as `examples/rag_serve.py` draws them, k = RAG_K through
# AsyncBatchQueue(max_batch=16, max_wait_ms=20), RAG_NEW tokens each.
RAG_REQUESTS, RAG_PROMPT, RAG_K, RAG_NEW = 32, 32, 5, 8
# (e) a longer serving shape: E_BATCH prompts of E_LEN tokens, E_NEW new
# tokens (the cache holds 2,112 positions), bf16 compute, ModelCtx's
# default query chunk (256); E_PASSES timed passes after a warm-up.
E_BATCH, E_LEN, E_NEW, E_PASSES = 8, 2048, 32, 3
BF16_FLOPS = 989e12


def lm_trace(params, cfg, prompts, max_new: int, ctx, enc=None):
    """What `serve.generate` computes, step by step: the padded prefill
    with `prompt_len`, then greedy decode; returns (tokens [B, max_new]
    int, each step's next-token logits [B, V] as fp32 numpy). The
    parameters must already be in the compute dtype; `enc` are the
    encoder-decoder's frame embeddings."""
    max_len = len(prompts[0])
    s_max = -(-(max_len + max_new) // 64) * 64
    tokens, _ = serve.pad_prompts(prompts, s_max)
    dev = params["embed"].device
    batch = {"tokens": tokens.to(dev)}
    if enc is not None:
        batch["enc_inputs"] = enc.to(dev)
    logits, cache = lm.forward_prefill(params, batch, cfg, ctx,
                                       prompt_len=max_len)
    out, steps = [], []
    for i in range(max_new):
        steps.append(logits[:, -1].float().cpu().numpy())
        nxt = torch.argmax(logits[:, -1], dim=-1)
        out.append(nxt)
        if i + 1 < max_new:
            logits, cache = lm.forward_decode(params, cache, nxt[:, None],
                                              max_len + i, cfg, ctx)
    return torch.stack(out, 1).cpu().numpy(), steps


def top2_gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


def run_rag_model(dev) -> tuple:
    """Phase 14 (a): qwen2-0.5b at full width, `init_params(seed=0)` on
    the card; its size, bytes and peak device memory. Returns (the
    config, the fp32 parameters, the line's fields)."""
    cfg = lm_configs.get_config(RAG_ARCH)
    desc = lm.model_desc(cfg)
    n = lm_common.count_params(desc)
    if n != RAG_PARAMS:
        raise AssertionError(f"{RAG_ARCH}: {n} parameters, not {RAG_PARAMS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_common.init_params(desc, seed=0, device=dev)
    torch.cuda.synchronize()
    fields = {"arch": RAG_ARCH, "config": dataclasses.asdict(cfg),
              "params": n, "fp32_bytes": 4 * n, "bf16_bytes": 2 * n,
              "init_s": time.perf_counter() - t0,
              "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6,
              "seconds": time.perf_counter() - t0}
    emit("rag.model", **fields)
    return cfg, params, fields


def run_rag_devices(cfg, params, dev) -> dict:
    """Phase 14 (b): fp32 compute, TF32 off, the same weights on the card
    and on the machine's CPU: B_PROMPTS prompts of B_LEN tokens through
    `lm_trace` on each device. Prefill's logits and the first decode
    step's within B_TOL; the B_NEW greedy tokens equal, or parted at a
    near-tie (the top-2 gap within B_TOL on both devices). `generate` on
    the card gives the trace's tokens. Beside it, the CPU's prefill with
    the input embeddings moved by one ulp."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    t_phase = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ctx = lm.ModelCtx(qc_prefill=64, gla_chunk=64)      # generate's own
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, size=B_LEN)))
               for _ in range(B_PROMPTS)]
    t0 = time.perf_counter()
    card_toks, card_steps = lm_trace(params, cfg32, prompts, B_NEW, ctx)
    card_s = time.perf_counter() - t0
    gen = serve.generate(params, cfg32, prompts, max_new=B_NEW)
    if not np.array_equal(gen, card_toks):
        raise AssertionError("generate() differs from the step trace")
    host = lm_common.map_descs(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu_toks, cpu_steps = lm_trace(host, cfg32, prompts, B_NEW, ctx)
    cpu_s = time.perf_counter() - t0
    moved = dict(host, embed=torch.nextafter(
        host["embed"], torch.tensor(float("inf"))))
    ulp_steps = lm_trace(moved, cfg32, prompts, 2, ctx)[1]
    del host, moved
    one_ulp = [float(np.abs(a - b).max())
               for a, b in zip(cpu_steps[:2], ulp_steps)]
    errs = [float(np.abs(a - b).max()) for a, b in zip(card_steps,
                                                       cpu_steps)]
    if max(errs[:2]) > B_TOL:
        raise AssertionError(f"card vs CPU: prefill/first decode logits "
                             f"differ by {errs[:2]} > {B_TOL}")
    parted = None
    for i in range(B_NEW):
        if not np.array_equal(card_toks[:, i], cpu_toks[:, i]):
            parted = i
            rows = card_toks[:, i] != cpu_toks[:, i]
            gaps = (top2_gap(card_steps[i])[rows],
                    top2_gap(cpu_steps[i])[rows])
            if max(g.max() for g in gaps) > B_TOL:
                raise AssertionError(
                    f"greedy tokens part at step {i} without a near-tie: "
                    f"top-2 gaps {gaps}")
            break
    fields = {"prompts": B_PROMPTS, "prompt_len": B_LEN, "new": B_NEW,
              "tol": B_TOL, "max_abs_err_prefill": errs[0],
              "max_abs_err_decode1": errs[1],
              "max_abs_err_later_steps": errs[2:],
              "one_ulp_embed_move_cpu": one_ulp,
              "logit_max_abs": float(np.abs(cpu_steps[0]).max()),
              "tokens_equal": parted is None, "parted_at_step": parted,
              "min_top2_gap": float(min(top2_gap(s).min()
                                        for s in card_steps)),
              "card_s": card_s, "cpu_s": cpu_s, "tokens": cpu_toks.tolist(),
              "seconds": time.perf_counter() - t_phase}
    emit("rag.card_vs_cpu", **fields)
    return fields


def prefill_vs_decode(cfg, params16, dev, enc=None) -> tuple:
    """The reference's prefill/decode consistency on the card: prefill
    over C_LEN tokens, and a prefill over C_LEN - 1 (padded,
    `prompt_len`) then one decode step of the last token. Returns both
    next-token logits [2, V] as numpy."""
    ctx = lm.ModelCtx(qc_prefill=C_LEN, gla_chunk=C_LEN)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, size=(2, C_LEN))
                            ).to(dev)
    batch = {"tokens": toks}
    if enc is not None:
        batch["enc_inputs"] = enc[:2].to(dev)
    full, _ = lm.forward_prefill(params16, batch, cfg, ctx)
    _, cache = lm.forward_prefill(params16, batch, cfg, ctx,
                                  prompt_len=C_LEN - 1)
    step, _ = lm.forward_decode(params16, cache, toks[:, -1:], C_LEN - 1,
                                cfg, ctx)
    return full[:, -1].cpu().numpy(), step[:, -1].cpu().numpy()


def run_rag_consistency(cfg, params16, dev) -> dict:
    """Phase 14 (c): the reference's prefill/decode consistency at full
    width in bf16 on the card (`prefill_vs_decode`); argmax equal,
    logits within BF16_TOL."""
    t_phase = time.perf_counter()
    a, b = prefill_vs_decode(cfg, params16, dev)
    err = float(np.abs(a - b).max())
    if not (a.argmax(-1) == b.argmax(-1)).all() or err > BF16_TOL:
        raise AssertionError(f"prefill vs decode: argmax {a.argmax(-1)} / "
                             f"{b.argmax(-1)}, max |delta| {err}")
    fields = {"len": C_LEN, "tol": BF16_TOL, "max_abs_err": err,
              "argmax_equal": True, "seconds": time.perf_counter() - t_phase}
    emit("rag.prefill_vs_decode", **fields)
    return fields


def rag_requests(ds):
    """`examples/rag_serve.py`'s requests over `ds`: prompts, predicates
    and query bitmaps (one label of a random row, two for OR), from
    `np.random.default_rng(0)`."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, 400, size=(RAG_REQUESTS, RAG_PROMPT))
    preds = [Predicate(int(p)) for p in rng.integers(0, 3,
                                                     size=RAG_REQUESTS)]
    qbms = np.zeros((RAG_REQUESTS, ds.bitmaps.shape[1]), np.uint32)
    for i in range(RAG_REQUESTS):
        src = sorted(lb.unpack_one(ds.bitmaps[rng.integers(0, ds.n)]))
        qbms[i] = lb.pack_one(src[: 1 + int(preds[i] == Predicate.OR)],
                              ds.universe)
    return prompts, preds, qbms


def queue_answers(queue, emb, qbms, preds) -> list:
    futs = [queue.submit(emb[i], qbms[i], preds[i], k=RAG_K)
            for i in range(len(preds))]
    return [f.result(timeout=300) for f in futs]


def run_rag_path(fx, router, cfg, params16, dev, tag: str = "rag.path",
                 check_cfg=None) -> tuple:
    """Phase 14 (d): the RAG example's path at full width. The LM embeds
    RAG_REQUESTS prompts (prefill's logits[:, 0, :dim]); the requests go
    one by one through `AsyncBatchQueue(RouterService(fx, router, t=0.9),
    max_batch=16, max_wait_ms=20)` and through one over `fx` with
    `method="prefilter"`, with the launch counts set to 0 just before and
    read just after; every answer equals the batched search of its
    predicate's requests (made before the counts are set to 0) and every
    id passes its predicate; then up to 4 retrieved ids are appended as
    tokens and `generate` makes RAG_NEW tokens, whose first decode step
    agrees with a prefill over prompt plus first token within BF16_TOL
    (both under `check_cfg`, default `cfg`: an MoE model's two calls
    dispatch different token sets, so they are held where nothing drops).
    Returns (the line's fields, the launch counts); the line is `tag`."""
    t_phase = time.perf_counter()
    ds = fx.ds
    ctx = lm.ModelCtx(qc_prefill=32, gla_chunk=32)   # the example's
    prompts, preds, qbms = rag_requests(ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = lm.forward_prefill(
        params16, {"tokens": torch.from_numpy(prompts).to(dev)}, cfg, ctx)
    emb = logits[:, 0, :ds.dim].float().cpu().numpy()
    embed_s = time.perf_counter() - t0
    svc = RouterService(fx, router, t=0.9)
    want = {}
    for pred in PREDICATES:
        rows = np.array([i for i in range(RAG_REQUESTS) if preds[i] == pred])
        if rows.size:
            batch = QueryBatch(emb[rows], qbms[rows], int(pred), RAG_K)
            want[int(pred)] = (rows, svc.search(batch),
                               fx.search(batch, "prefilter"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with AsyncBatchQueue(svc, max_batch=16, max_wait_ms=20.0) as queue:
        routed = queue_answers(queue, emb, qbms, preds)
        q_routed = queue.stats()
    route_s = time.perf_counter() - t0
    with AsyncBatchQueue(fx, max_batch=16, max_wait_ms=20.0,
                         method="prefilter") as queue:
        exact = queue_answers(queue, emb, qbms, preds)
        q_exact = queue.stats()
    launches = read_launches()
    for name in ("masked_topk", "selectivity"):
        if launches[name] == 0:
            raise AssertionError(f"the RAG path never launched {name}")
    got_r = np.stack([r.ids for r in routed])
    got_e = np.stack([r.ids for r in exact])
    for pred, (rows, w_routed, w_exact) in want.items():
        if [routed[i].decision for i in rows] != w_routed.decisions:
            raise AssertionError(f"queued decisions differ from the batched "
                                 f"search's, {PRED_NAMES[pred]}")
        for got, w, what in ((got_r, w_routed, "routed"),
                             (got_e, w_exact, "prefilter")):
            if not np.array_equal(got[rows], w.ids):
                raise AssertionError(f"queued {what} ids differ from the "
                                     f"batched search's, {PRED_NAMES[pred]}")
        for i in rows:
            ok = ds.matching_mask(qbms[i], Predicate(pred))
            if not all(ok[x] for x in np.concatenate([got_r[i], got_e[i]])
                       if x >= 0):
                raise AssertionError(f"request {i}: an id fails its "
                                     f"predicate")
    recall = float(recall_at_k(got_r, got_e).mean())
    aug = [list(map(int, prompts[i])) +
           [int(x) % cfg.vocab for x in got_r[i] if x >= 0][:4]
           for i in range(RAG_REQUESTS)]
    width = max(len(a) for a in aug)
    aug = [a + [0] * (width - len(a)) for a in aug]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.generate(params16, cfg, aug, max_new=RAG_NEW)
    gen_s = time.perf_counter() - t0
    ctx64 = lm.ModelCtx(qc_prefill=64, gla_chunk=64)
    toks, steps = lm_trace(params16, cfg, aug, 2, ctx64)
    if not np.array_equal(toks, out[:, :2]):
        raise AssertionError("generate() differs from the step trace")
    if check_cfg is not None:
        toks, steps = lm_trace(params16, check_cfg, aug, 2, ctx64)
    longer = [a + [int(t)] for a, t in zip(aug, toks[:, 0])]
    again, _ = lm.forward_prefill(
        params16, {"tokens": torch.tensor(longer, device=dev)},
        check_cfg or cfg, ctx64)
    again = again[:, -1].cpu().numpy()
    err = float(np.abs(steps[1] - again).max())
    # the argmax is held where the prefill's top-2 gap is past 2 BF16_TOL;
    # at random init some of the 32 rows are near-ties
    differs = steps[1].argmax(-1) != again.argmax(-1)
    gaps = top2_gap(again)
    if err > BF16_TOL or (differs & (gaps > 2 * BF16_TOL)).any():
        raise AssertionError(f"the first decode step vs a prefill over prompt "
                             f"+ first token: max |delta| {err}, argmax "
                             f"differs at top-2 gaps {gaps[differs]}")
    fields = {"requests": RAG_REQUESTS, "prompt_len": RAG_PROMPT, "k": RAG_K,
              "new": RAG_NEW, "aug_width": width,
              "embed_ms": embed_s * 1e3, "route_retrieve_ms": route_s * 1e3,
              "route_retrieve_us_per_request": route_s / RAG_REQUESTS * 1e6,
              "generate_ms": gen_s * 1e3,
              "routed_recall_at_5_vs_prefilter": recall,
              "decisions": sorted(Counter(r.decision.method
                                          for r in routed).items()),
              "queue_routed": {k: q_routed[k] for k in
                               ("batches", "max_batch_seen",
                                "flush_reasons")},
              "queue_prefilter_batches": q_exact["batches"],
              "same_as_batched": True, "ids_pass_predicates": True,
              "decode_vs_prefill_max_abs_err": err,
              "decode_vs_prefill_argmax_differs": int(differs.sum()),
              "decode_vs_prefill_gaps_where_differs": gaps[differs].tolist(),
              "hit_rate": float((got_r >= 0).any(1).mean()),
              "sample_generations": out[:2].tolist(), "launches": launches,
              "seconds": time.perf_counter() - t_phase}
    emit(tag, **fields)
    return fields, launches


def run_rag_serving(cfg, params16, dev) -> dict:
    """Phase 14 (e): E_BATCH prompts of E_LEN tokens and E_NEW new tokens
    in bf16, the way `generate` runs them (padded prefill, then greedy
    decode steps): prefill ms and decode ms a step (medians of E_PASSES
    passes after a warm-up, host clock after `torch.cuda.synchronize()`),
    generated tokens a second, peak device memory, one profiled pass's
    idle share, and the two bounds from the shapes."""
    t_phase = time.perf_counter()
    ctx = lm.ModelCtx()
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, size=E_LEN)))
               for _ in range(E_BATCH)]
    s_max = -(-(E_LEN + E_NEW) // 64) * 64
    tokens = serve.pad_prompts(prompts, s_max)[0].to(dev)

    def one_pass():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.forward_prefill(params16, {"tokens": tokens},
                                           cfg, ctx, prompt_len=E_LEN)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(E_NEW - 1):
            logits, cache = lm.forward_decode(params16, cache, nxt[:, None],
                                              E_LEN + i, cfg, ctx)
            nxt = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        return t1 - t0, (time.perf_counter() - t1) / (E_NEW - 1)

    torch.cuda.reset_peak_memory_stats()
    one_pass()
    passes = [one_pass() for _ in range(E_PASSES)]
    peak = torch.cuda.max_memory_allocated() / 1e6
    prefill_s = sorted(p[0] for p in passes)[E_PASSES // 2]
    step_s = sorted(p[1] for p in passes)[E_PASSES // 2]
    t_prof = time.perf_counter()
    prof = profile_phase("rag_serving", one_pass, host_ops=False)
    profile_s = time.perf_counter() - t_prof
    n_embed = cfg.vocab * cfg.d_model
    n_body = lm_common.count_params(lm.model_desc(cfg)) - 2 * n_embed
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2   # bf16 K and V
    # prefill: every layer over the B x s_max padded tokens, the head at
    # the last position only, and the attention products unskipped (each
    # query chunk against all s_max keys); the operations bound it
    toks = E_BATCH * s_max
    attn = 2 * 2 * E_BATCH * cfg.n_heads * s_max * s_max * cfg.hd \
        * cfg.n_layers
    pre_ops = 2 * n_body * toks + 2 * n_embed * E_BATCH + attn
    pre_bytes = 2 * (n_body + n_embed) + toks * kv_row
    # decode: a step reads the bf16 layers and head once (the embedding
    # table only at B rows) and the cache up to its position; the mean
    # step is at E_LEN + (E_NEW - 2) / 2
    mean_len = E_LEN + (E_NEW - 2) / 2 + 1
    dec_bytes = 2 * (n_body + n_embed) + E_BATCH * mean_len * kv_row \
        + E_BATCH * cfg.vocab * 4
    dec_ops = 2 * (n_body + n_embed) * E_BATCH + 2 * 2 * E_BATCH \
        * cfg.n_heads * mean_len * cfg.hd * cfg.n_layers
    bound = lambda ops, nbytes: max(ops / BF16_FLOPS, nbytes / HBM_BYTES_S)
    fields = {
        "batch": E_BATCH, "prompt_len": E_LEN, "new": E_NEW, "s_max": s_max,
        "qc_prefill": ctx.qc_prefill, "passes": E_PASSES,
        "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": step_s * 1e3,
        "prefill_ms_passes": [p[0] * 1e3 for p in passes],
        "decode_ms_per_step_passes": [p[1] * 1e3 for p in passes],
        "tokens_per_s": E_BATCH * E_NEW / (prefill_s
                                           + (E_NEW - 1) * step_s),
        "peak_device_mb": peak,
        "device_idle_share": prof["device_idle_share"],
        "prefill_bound_ms": bound(pre_ops, pre_bytes) * 1e3,
        "prefill_bound_by": ("operations" if pre_ops / BF16_FLOPS
                             >= pre_bytes / HBM_BYTES_S else "bytes"),
        "prefill_tflop": pre_ops / 1e12, "attention_tflop": attn / 1e12,
        "decode_bound_ms": bound(dec_ops, dec_bytes) * 1e3,
        "decode_bound_by": ("operations" if dec_ops / BF16_FLOPS
                            >= dec_bytes / HBM_BYTES_S else "bytes"),
        "decode_gb_per_step": dec_bytes / 1e9, "profile_s": profile_s,
        "seconds": time.perf_counter() - t_phase}
    emit("rag.serving", **fields)
    return fields


def run_rag(fx, router, dev) -> dict:
    """Phase 14: (a)-(e) above; returns the phase's summary and the RAG
    path's launch counts under "launches"."""
    cfg, params, model = run_rag_model(dev)
    devices = run_rag_devices(cfg, params, dev)
    params16 = lm_common.cast_floats(params, torch.bfloat16)
    del params
    consistency = run_rag_consistency(cfg, params16, dev)
    path, launches = run_rag_path(fx, router, cfg, params16, dev)
    serving = run_rag_serving(cfg, params16, dev)
    del params16
    torch.cuda.empty_cache()
    return {"model": {k: model[k] for k in ("params", "fp32_bytes",
                                            "bf16_bytes", "peak_device_mb")},
            "card_vs_cpu": {k: devices[k] for k in (
                "max_abs_err_prefill", "max_abs_err_decode1", "tol",
                "one_ulp_embed_move_cpu", "tokens_equal", "parted_at_step")},
            "prefill_vs_decode": consistency,
            "path": {k: path[k] for k in (
                "embed_ms", "route_retrieve_ms", "generate_ms",
                "routed_recall_at_5_vs_prefilter")},
            "serving": {k: serving[k] for k in (
                "prefill_ms", "decode_ms_per_step", "tokens_per_s",
                "peak_device_mb", "device_idle_share", "prefill_bound_ms",
                "decode_bound_ms")},
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 15: every other family's serving forward at full width
# ---------------------------------------------------------------------------

# The five families beside the dense decoders, at their published widths.
# The giants are cut in depth only, as far as one 80 GB card forces (the
# bf16 weights of deepseek-v2's 60 layers are 488 GB): deepseek-v2 to 2
# layers (this slice's path), grok-1 to 1; the other three run whole.
# FAM_PARAMS holds the reference's `count_params` at each depth run.
FAMILIES = ("deepseek-v2-236b", "grok-1-314b", "xlstm-125m", "hymba-1.5b",
            "whisper-medium")
FAM_DEPTH = {"deepseek-v2-236b": 2, "grok-1-314b": 1}
FAM_PARAMS = {("deepseek-v2-236b", 2): 9_153_243_136,
              ("deepseek-v2-236b", 1): 5_100_912_128,
              ("grok-1-314b", 1): 6_530_598_912,
              ("xlstm-125m", 12): 114_491_136,
              ("hymba-1.5b", 32): 1_350_610_400,
              ("whisper-medium", 24): 812_523_520}
# (b) the card against the machine's CPU, fp32, TF32 off: B_PROMPTS
# prompts of B_LEN tokens; the giants (at 1 layer) prefill and take 2
# decode steps, the others B_NEW greedy tokens. GATE_TIE: an MoE gate's
# k-th and k+1-th logits closer than this are a near-tie (the devices'
# fp32 gate logits part by about 1e-5 at these widths).
GIANT_STEPS = 3
# (b) whisper at 4 of its 24 encoder and decoder layers: its CPU side (the
# encoder over 1,500 frames, three traces) took 37-46 s of the phase at
# full depth; cut when phase 16 was added, to keep the script near 900 s.
FAM_CHECK_DEPTH = {"whisper-medium": 4}
GATE_TIE = 1e-3
# (d) the dispatch at each giant's gate width: D_TOKENS tokens on an
# integer grid (exact fp32 gate logits on both devices), experts of
# width D_FF (the dispatch's arithmetic does not depend on it); y within
# D_TOL of the CPU's (fp32 summation order over d_model terms).
D_TOKENS, D_FF, D_TOL = 4096, 128, 1e-4
# (f) F_BATCH prompts of F_LEN tokens and F_NEW new ones in bf16 with
# ModelCtx()'s defaults (qc_prefill 256, gla_chunk 256); whisper's
# decoder takes W_LEN + F_NEW = 448 positions (openai/whisper-medium's
# max_target_positions) over its 1,500 frames. F_PASSES timed passes
# after a warm-up (one: phase 15's budget is 150 s, and in a check run on
# the card two passes parted by under 1% on every family but xlstm's
# launch-bound prefill; PERF.md §6).
F_BATCH, F_LEN, F_NEW, F_PASSES = 8, 2048, 32, 1
W_LEN = 416


def fam_config(arch: str, layers: int | None = None):
    cfg = lm_configs.get_config(arch)
    depth = layers or FAM_DEPTH.get(arch, cfg.n_layers)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    n = lm_common.count_params(lm.model_desc(cfg))
    if n != FAM_PARAMS[(arch, depth)]:
        raise AssertionError(f"{arch} at {depth} layers: {n} parameters, "
                             f"not {FAM_PARAMS[(arch, depth)]}")
    return cfg, n


def draw_on_card(desc, seed: int, dev, dtype=torch.float32):
    """`init_params`'s leaves (ones, zeros, N(0, init_std^2)) drawn in
    fp32 on the card from a seeded `torch.Generator(device=...)`, each
    cast to `dtype` as it is drawn: the host draws 1e8 normals a second,
    the giants need 1e10."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def one(d):
        if d.one:
            return torch.ones(d.shape, device=dev, dtype=dtype)
        if d.zero:
            return torch.zeros(d.shape, device=dev, dtype=dtype)
        return torch.randn(d.shape, generator=gen, device=dev).mul_(
            np.float32(lm_common.init_std(d))).to(dtype)
    return lm_common.map_descs(one, desc)


def first_layers(params, n: int):
    """The parameters of a stacked model's first n layers, the
    encoder's too (views)."""
    cut = {k: lm_common.map_descs(lambda t: t[:n], params[k])
           for k in ("layers", "enc_layers") if k in params}
    return dict(params, **cut)


def frames(cfg, b: int, seed: int):
    """The reference launcher's stand-in frame embeddings, 0.05·N(0, 1)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(0.05 * rng.normal(
        size=(b, cfg.encoder_seq, cfg.d_model))).float()


class DispatchSpy:
    """While installed, records every MoE dispatch the port makes: per
    call, each token's chosen experts (as a sorted set), the gap between
    its k-th and k+1-th gate logit, and whether each assignment reaches
    its expert (its slot holds its token; past capacity, or the last
    in-capacity token of an expert that overflowed, it does not); with
    `keep_logits`, the gate logits too."""

    def __init__(self, keep_logits: bool = False):
        self.calls = []
        self.keep_logits = keep_logits
        self._orig = moe_mod.dispatch

    def __enter__(self):
        moe_mod.dispatch = self._spy
        return self

    def __exit__(self, *exc):
        moe_mod.dispatch = self._orig

    def _spy(self, x, wg, cfg):
        g = self._orig(x, wg, cfg)
        k, cap = cfg.experts_per_token, g["cap"]
        top = torch.topk(g["logits"], k + 1, dim=-1).values
        tok = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
        reach = g["table"][g["flat_e"], g["slot_pos"].clamp(max=cap - 1)] \
            == tok
        self.calls.append({
            "sets": torch.sort(g["gidx"], -1).values.cpu().numpy(),
            "gap": (top[:, k - 1] - top[:, k]).cpu().numpy(),
            "reach": reach.reshape(-1, k).cpu().numpy()})
        if self.keep_logits:
            self.calls[-1]["logits"] = g["logits"].float().cpu().numpy()
        return g

    def drops(self) -> int:
        return int(sum((~c["reach"]).sum() for c in self.calls))


def parted_rows(a: list, b: list, rows: int, tie: float = GATE_TIE) -> tuple:
    """Compare two runs' dispatches call by call (`DispatchSpy.calls` of
    the same forwards over `rows` batch rows). A token whose expert set
    parts must do so at a near-tie (`tie` on both runs' gaps) unless
    its row parted in an earlier call; capacity drops may part only after
    an expert set has (a flip moves loads). Returns (the parted rows, the
    gaps where sets parted)."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} MoE calls")
    parted, gaps = set(), []
    for ca, cb in zip(a, b):
        s = ca["sets"].shape[0] // rows
        tok = np.nonzero((ca["sets"] != cb["sets"]).any(-1))[0]
        for t in tok:
            gap = float(max(ca["gap"][t], cb["gap"][t]))
            gaps.append(gap)
            if t // s not in parted and gap > tie:
                raise AssertionError(f"token {t}'s experts part without a "
                                     f"near-tie: k/k+1 gap {gap}")
        parted.update(int(t) // s for t in tok)
        drop = np.nonzero((ca["reach"] != cb["reach"]).any(-1))[0]
        if drop.size and not parted:
            raise AssertionError("capacity drops part with no expert flip")
        parted.update(int(t) // s for t in drop)
    return parted, gaps


def fam_trace(params, cfg, prompts, n: int, enc):
    """`lm_trace` at generate's chunks, with the MoE dispatches recorded."""
    ctx = lm.ModelCtx(qc_prefill=64, gla_chunk=64)
    with DispatchSpy() as spy:
        t0 = time.perf_counter()
        toks, steps = lm_trace(params, cfg, prompts, n, ctx, enc)
        seconds = time.perf_counter() - t0
    return toks, steps, spy.calls, seconds


def run_fam_devices(arch, cfg, params, dev) -> dict:
    """Phase 15 (b): fp32 compute, TF32 off, the same weights on the card
    and on the machine's CPU (copied to the host): B_PROMPTS prompts of
    B_LEN tokens through `lm_trace`, prefill and GIANT_STEPS - 1 decode
    steps for the giants (at 1 layer), B_NEW greedy tokens for the rest.
    Prefill's and the first decode step's logits within B_TOL, except on
    rows whose MoE dispatch parted at a near-tie (`parted_rows`); the
    greedy tokens equal, or parted at a near-tie of the logits; the CPU's
    one-ulp move of the input embeddings beside."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    t_phase = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    n = GIANT_STEPS if arch in FAM_DEPTH else B_NEW
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, size=B_LEN)))
               for _ in range(B_PROMPTS)]
    enc = frames(cfg, B_PROMPTS, 1) if cfg.encoder_layers else None
    card_toks, card_steps, card_calls, card_s = fam_trace(
        params, cfg32, prompts, n, enc)
    t0 = time.perf_counter()
    host = lm_common.map_descs(lambda t: t.cpu(), params)
    copy_s = time.perf_counter() - t0
    cpu_toks, cpu_steps, cpu_calls, cpu_s = fam_trace(
        host, cfg32, prompts, n, enc)
    moved = dict(host, embed=torch.nextafter(
        host["embed"], torch.tensor(float("inf"))))
    ulp_steps = fam_trace(moved, cfg32, prompts, 2, enc)[1]
    del host, moved
    parted, gaps = parted_rows(card_calls, cpu_calls, B_PROMPTS)
    keep = [r for r in range(B_PROMPTS) if r not in parted]
    one_ulp = [float(np.abs(a - b).max())
               for a, b in zip(cpu_steps[:2], ulp_steps)]
    errs = [float(np.abs(a[keep] - b[keep]).max()) if keep else None
            for a, b in zip(card_steps, cpu_steps)]
    if keep and max(errs[:2]) > B_TOL:
        raise AssertionError(f"{arch} card vs CPU: prefill/first decode "
                             f"logits differ by {errs[:2]} > {B_TOL}")
    parted_at = None
    for i in range(n):
        rows = (card_toks[:, i] != cpu_toks[:, i])
        rows[list(parted)] = False
        if rows.any():
            parted_at = i
            gap = max(top2_gap(card_steps[i])[rows].max(),
                      top2_gap(cpu_steps[i])[rows].max())
            if gap > B_TOL:
                raise AssertionError(f"{arch}: greedy tokens part at step "
                                     f"{i} without a near-tie: top-2 gap "
                                     f"{gap}")
            break
    fields = {"arch": arch, "layers": cfg.n_layers, "prompts": B_PROMPTS,
              "prompt_len": B_LEN, "steps": n, "tol": B_TOL,
              "max_abs_err_prefill": errs[0], "max_abs_err_decode1": errs[1],
              "max_abs_err_later_steps": errs[2:],
              "one_ulp_embed_move_cpu": one_ulp,
              "logit_max_abs": float(np.abs(cpu_steps[0]).max()),
              "moe_calls": len(card_calls),
              "moe_rows_parted": sorted(parted),
              "moe_gaps_where_parted": gaps,
              "moe_min_gap": (float(min(c["gap"].min() for c in card_calls))
                              if card_calls else None),
              "tokens_equal": parted_at is None and not parted,
              "parted_at_step": parted_at, "card_s": card_s,
              "host_copy_s": copy_s, "cpu_s": cpu_s,
              "tokens": cpu_toks.tolist(),
              "seconds": time.perf_counter() - t_phase}
    emit("fam.card_vs_cpu", **fields)
    return fields


def run_fam_consistency(arch, cfg, params16, dev) -> dict:
    """Phase 15 (c): `prefill_vs_decode` in bf16 on the card: the argmax
    equal where the top-2 gap is past 2 BF16_TOL, the logits within
    BF16_TOL. The MoE families are held at capacity_factor E/k, where
    nothing drops (prefill at C_LEN - 1 and at C_LEN dispatch other token
    sets, so drops alone could part them); beside it their drops and
    error at the configuration's own factor, not held."""
    t_phase = time.perf_counter()
    enc = frames(cfg, 2, 0) if cfg.encoder_layers else None
    held = cfg
    if cfg.is_moe:
        held = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    with DispatchSpy() as spy:
        a, b = prefill_vs_decode(held, params16, dev, enc)
    err = float(np.abs(a - b).max())
    clear = top2_gap(a) > 2 * BF16_TOL
    differs = a.argmax(-1) != b.argmax(-1)
    if err > BF16_TOL or (differs & clear).any():
        raise AssertionError(f"{arch} prefill vs decode: max |delta| {err}, "
                             f"argmax differs at top-2 gaps "
                             f"{top2_gap(a)[differs]}")
    fields = {"arch": arch, "layers": cfg.n_layers, "len": C_LEN,
              "tol": BF16_TOL, "max_abs_err": err,
              "argmax_differs": int(differs.sum()),
              "capacity_factor": held.capacity_factor,
              "drops": spy.drops()}
    if cfg.is_moe:
        with DispatchSpy() as own:
            a, b = prefill_vs_decode(cfg, params16, dev, enc)
        fields.update(own_capacity_factor=cfg.capacity_factor,
                      own_drops=own.drops(),
                      own_max_abs_err=float(np.abs(a - b).max()),
                      own_argmax_differs=int(
                          (a.argmax(-1) != b.argmax(-1)).sum()))
    fields["seconds"] = time.perf_counter() - t_phase
    emit("fam.prefill_vs_decode", **fields)
    return fields


def dispatch_case(rng, gen, dev, arch: str, case: str):
    """An integer-grid gate input for `arch`'s gate width: x [D_TOKENS, D]
    and wg [D, E] in {-1, 0, 1} (exact fp32 logits, many exact ties);
    `overflow` adds 3 to expert 0's gate column and takes x in {0, 1, 2}
    (every token picks expert 0, far past its capacity). The experts'
    weights, N(0, 1/fan-in), are drawn on the card from `gen` (the host
    draws 1e8 normals a second) and returned on the card."""
    cfg = dataclasses.replace(lm_configs.get_config(arch), moe_d_ff=D_FF)
    d, e = cfg.d_model, cfg.n_experts
    if case == "overflow":
        x = rng.integers(0, 3, size=(D_TOKENS, d))
    else:
        x = rng.integers(-1, 2, size=(D_TOKENS, d))
    wg = rng.integers(-1, 2, size=(d, e))
    if case == "overflow":
        wg[:, 0] += 3
    experts = [torch.randn(shape, generator=gen, device=dev).mul_(
        np.float32(1.0 / np.sqrt(shape[1])))
        for shape in ((e, d, D_FF), (e, d, D_FF), (e, D_FF, d))]
    return cfg, torch.from_numpy(x).float(), torch.from_numpy(wg).float(), \
        experts


def run_fam_dispatch(dev) -> dict:
    """Phase 15 (d): `moe.dispatch` and `moe._moe_local` on the card
    against the machine's CPU at deepseek-v2's gate width (E = 160,
    k = 6) and grok-1's (E = 8, k = 2), D_TOKENS tokens (cap 192 and
    1,280), forced overflow and gate ties: the chosen experts, positions,
    slot table and reach mask bit-identical, y within D_TOL."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(15)
    out = []
    for arch in ("deepseek-v2-236b", "grok-1-314b"):
        for case in ("overflow", "ties"):
            cfg, x, wg, experts = dispatch_case(rng, gen, dev, arch, case)
            got = []
            for where in (dev, torch.device("cpu")):
                args = [t.to(where) for t in (x, wg, *experts)]
                g = moe_mod.dispatch(args[0], args[1], cfg)
                y, aux = moe_mod._moe_local(*args, cfg=cfg)
                got.append(({k: g[k].cpu() for k in (
                    "gidx", "slot_pos", "valid", "table")},
                    y.cpu(), float(aux)))
            (gc, yc, auxc), (gh, yh, auxh) = got
            for name in gc:
                if not torch.equal(gc[name], gh[name]):
                    raise AssertionError(f"(d) {arch} {case}: {name} "
                                         f"differs across devices")
            err = float((yc - yh).abs().max())
            if err > D_TOL * (1 + float(yh.abs().max())):
                raise AssertionError(f"(d) {arch} {case}: y differs by "
                                     f"{err}")
            logits = x @ wg
            top = torch.topk(logits, cfg.experts_per_token + 1).values
            k = cfg.experts_per_token
            load = torch.bincount(gh["gidx"].reshape(-1),
                                  minlength=cfg.n_experts)
            cap = gh["table"].shape[1]
            out.append({"arch": arch, "case": case, "tokens": D_TOKENS,
                        "d_model": cfg.d_model, "experts": cfg.n_experts,
                        "k": k, "cap": cap,
                        "overflowed_experts": int((load > cap).sum()),
                        "dropped_assignments": int((~gh["valid"]).sum()),
                        "cap_minus_1_dropped": int(
                            (gh["table"][load > cap, -1] == -1).sum()),
                        "tied_tokens": int((top[:, k - 1] == top[:, k])
                                           .sum()),
                        "y_max_abs_err": err, "aux_delta": abs(auxc - auxh),
                        "bit_identical": ["gidx", "slot_pos", "valid",
                                          "table"]})
    fields = {"cases": out, "tol": D_TOL,
              "seconds": time.perf_counter() - t_phase}
    emit("fam.dispatch", **fields)
    return fields


def fam_bounds(cfg, n_params: int, b: int, s_max: int, s_enc: int,
               mean_len: float) -> dict:
    """The least time of a prefill over b x s_max positions and of a mean
    decode step at mean_len positions, from the shapes: bf16 weights read
    once (every expert: the dense dispatch reads them all; the encoder's
    only in prefill), the caches read and written (Hymba's ring holds its
    window), and the products each algorithm does (the decoder's weights
    over every padded position, the encoder's and the cross K/V
    projections over the frames, the dense [E, C, D] expert batches at
    their capacity, attention's score and PV products unskipped over
    every key, MLA's keys and values recomputed from c_kv each step; the
    recurrent scans' products are left out). Returns the bounds in ms and
    what bounds them."""
    d, v, L = cfg.d_model, cfg.vocab, cfg.n_layers
    kinds = set(lm.layer_kinds(cfg))
    n_embed = v * d
    n_enc = 0
    if cfg.encoder_layers:
        desc = lm.model_desc(cfg)
        n_enc = lm_common.count_params({k: desc[k] for k in (
            "enc_pos", "enc_layers", "enc_ln_f")})
    n_body = n_params - 2 * n_embed - n_enc
    n_cross_kv = 2 * d * d * L if cfg.encoder_layers else 0
    experts = 0
    if cfg.is_moe:
        experts = L * 3 * cfg.n_experts * d * (cfg.moe_d_ff or cfg.d_ff)
    dense = n_body - experts - n_cross_kv

    def cached(t):            # positions an attention cache holds
        return min(t, cfg.sliding_window) if cfg.sliding_window else t

    def moe_ops(t):
        if not cfg.is_moe:
            return 0.0
        cap = moe_mod.capacity(t, cfg)
        f = cfg.moe_d_ff or cfg.d_ff
        return 2 * 3 * cfg.n_experts * cap * d * f * L

    def attn_ops(q, t):       # scores and PV, every key, per layer
        if cfg.use_mla:
            return 2 * b * cfg.n_heads * q * t * (
                2 * lm_attn.MLA_NOPE + cfg.mla_rope_dim) * L
        if kinds & {"attn", "hymba", "dec"}:
            return 2 * 2 * b * cfg.n_heads * q * t * cfg.hd * L
        return 0.0

    def cache_row():          # bytes a position holds in the cache
        if cfg.use_mla:
            return 2 * L * (cfg.kv_lora_rank + cfg.mla_rope_dim)
        if kinds & {"attn", "hymba", "dec"}:
            return 2 * 2 * L * cfg.n_kv_heads * cfg.hd
        return 0

    toks = b * s_max
    pre_ops = 2 * dense * toks + moe_ops(toks) + attn_ops(s_max, s_max) \
        + 2 * n_embed * b
    if cfg.encoder_layers:    # the encoder and the cross K/V, over frames
        pre_ops += 2 * (n_enc + n_cross_kv) * b * s_enc \
            + 2 * 2 * b * cfg.n_heads * s_enc * s_enc * cfg.hd \
            * cfg.encoder_layers + 2 * 2 * b * cfg.n_heads * s_max \
            * s_enc * cfg.hd * L
    pre_bytes = 2 * n_params + b * cached(s_max) * cache_row()
    dec_bytes = 2 * (n_body + n_embed) + b * cached(mean_len) \
        * cache_row() + b * v * 4
    if cfg.use_mla:           # k_c and v written and read once a layer
        dec_bytes += 2 * 2 * 2 * b * mean_len * cfg.n_heads \
            * lm_attn.MLA_NOPE * L
    if cfg.encoder_layers:    # the cross K/V read each step
        dec_bytes += 2 * 2 * b * s_enc * cfg.n_heads * cfg.hd * L
    dec_ops = 2 * dense * b + moe_ops(b) + attn_ops(1, cached(mean_len)) \
        + 2 * n_embed * b
    if cfg.encoder_layers:
        dec_ops += 2 * 2 * b * cfg.n_heads * s_enc * cfg.hd * L
    if cfg.use_mla:
        dec_ops += 2 * b * mean_len * cfg.kv_lora_rank * cfg.n_heads \
            * (lm_attn.MLA_NOPE + lm_attn.MLA_V) * L

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / BF16_FLOPS, nbytes / HBM_BYTES_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    pre_ms, pre_by = bound(pre_ops, pre_bytes)
    dec_ms, dec_by = bound(dec_ops, dec_bytes)
    out = {"prefill_bound_ms": pre_ms, "prefill_bound_by": pre_by,
           "prefill_tflop": pre_ops / 1e12, "decode_bound_ms": dec_ms,
           "decode_bound_by": dec_by, "decode_gb_per_step": dec_bytes / 1e9}
    if cfg.is_moe:
        f = cfg.moe_d_ff or cfg.d_ff
        expert_bytes = 2 * 3 * d * f
        routed = min(cfg.n_experts, b * cfg.experts_per_token)
        out.update(
            decode_expert_gb_per_step=2 * experts / 1e9,
            routed_form_expert_gb_per_layer=routed * expert_bytes / 1e9,
            routed_form_decode_bound_ms=(dec_bytes - 2 * experts
                                         + L * routed * expert_bytes)
            / HBM_BYTES_S * 1e3,
            routed_form_note="a step that read only the routed experts' "
                             "weights: not the work the code does")
    return out


def run_fam_serving(arch, cfg, n_params, params16, dev) -> dict:
    """Phase 15 (f): a serving shape in bf16 with ModelCtx()'s defaults,
    run the way `generate` runs it (padded prefill, then greedy decode):
    F_BATCH prompts of F_LEN tokens (whisper: W_LEN, over its frames) and
    F_NEW new ones. The cache holds prompt + new positions, rounded up
    to 64 and to the GLA chunk where a recurrent layer scans. Prefill ms
    and decode ms a step (medians of F_PASSES passes after a warm-up),
    tokens a second, peak device memory, every logit finite, the bounds
    from the shapes; for deepseek-v2 one profiled pass's idle share."""
    t_phase = time.perf_counter()
    ctx = lm.ModelCtx()
    length = W_LEN if cfg.encoder_layers else F_LEN
    step = 64
    if set(lm.layer_kinds(cfg)) & {"mlstm", "hymba"}:
        step = int(np.lcm(64, ctx.gla_chunk))
    s_max = -(-(length + F_NEW) // step) * step
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, size=length)))
               for _ in range(F_BATCH)]
    batch = {"tokens": serve.pad_prompts(prompts, s_max)[0].to(dev)}
    if cfg.encoder_layers:
        batch["enc_inputs"] = frames(cfg, F_BATCH, 2).to(dev)
    finite = []

    def one_pass():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.forward_prefill(params16, batch, cfg, ctx,
                                           prompt_len=length)
        ok = [torch.isfinite(logits).all()]
        nxt = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(F_NEW - 1):
            logits, cache = lm.forward_decode(params16, cache, nxt[:, None],
                                              length + i, cfg, ctx)
            ok.append(torch.isfinite(logits).all())
            nxt = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        finite.append(bool(torch.stack(ok).all()))
        return t1 - t0, (time.perf_counter() - t1) / (F_NEW - 1)

    torch.cuda.reset_peak_memory_stats()
    first = one_pass()
    passes = [one_pass() for _ in range(F_PASSES)]
    peak = torch.cuda.max_memory_allocated() / 1e6
    if not all(finite):
        raise AssertionError(f"{arch}: non-finite logits at gla_chunk "
                             f"{ctx.gla_chunk}")
    prefill_s = float(np.median([p[0] for p in passes]))
    step_s = float(np.median([p[1] for p in passes]))
    fields = {"arch": arch, "layers": cfg.n_layers, "batch": F_BATCH,
              "prompt_len": length, "new": F_NEW, "s_max": s_max,
              "qc_prefill": ctx.qc_prefill, "gla_chunk": ctx.gla_chunk,
              "passes": F_PASSES, "prefill_ms": prefill_s * 1e3,
              "decode_ms_per_step": step_s * 1e3,
              "first_pass_ms": [first[0] * 1e3, first[1] * 1e3],
              "prefill_ms_passes": [p[0] * 1e3 for p in passes],
              "decode_ms_per_step_passes": [p[1] * 1e3 for p in passes],
              "tokens_per_s": F_BATCH * F_NEW / (prefill_s
                                                 + (F_NEW - 1) * step_s),
              "peak_device_mb": peak, "logits_finite": True}
    if arch == "deepseek-v2-236b":
        t_prof = time.perf_counter()
        prof = profile_phase("fam_serving_" + arch, one_pass,
                             host_ops=False)
        fields.update(device_idle_share=prof["device_idle_share"],
                      profile_s=time.perf_counter() - t_prof)
    fields.update(fam_bounds(cfg, n_params, F_BATCH, s_max,
                             cfg.encoder_seq, length + (F_NEW - 2) / 2 + 1))
    fields["seconds"] = time.perf_counter() - t_phase
    emit("fam.serving", **fields)
    return fields


def run_fam_model(arch, dev):
    """Phase 15 (a): the family's configuration at its depth, its count
    held to FAM_PARAMS, fp32 weights drawn on the card from seed 0
    (`draw_on_card`; the host's draws of hymba's and whisper's took 18 s
    of the phase). Returns (config, count, fp32 parameters on the card,
    the line's fields)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, n = fam_config(arch)
    params = draw_on_card(lm.model_desc(cfg), 0, dev)
    torch.cuda.synchronize()
    fields = {"arch": arch, "layers": cfg.n_layers,
              "published_layers": lm_configs.get_config(arch).n_layers,
              "cut": ("depth only, every width published" if arch in
                      FAM_DEPTH else "none"),
              "config": dataclasses.asdict(cfg), "params": n,
              "bf16_bytes": 2 * n, "fp32_bytes": 4 * n,
              "drawn_on": "card",
              "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6,
              "seconds": time.perf_counter() - t0}
    emit("fam.model", **fields)
    return cfg, n, params, fields


def run_families(fx, router, dev) -> dict:
    """Phase 15: (d) once, then for each family (a), (b), (c) and (f), and
    (e) on deepseek-v2; each family freed before the next. Returns the
    phase's summary with (e)'s launch counts under "launches"."""
    summary = {"dispatch": run_fam_dispatch(dev)["cases"]}
    launches = None
    for arch in FAMILIES:
        t0 = time.perf_counter()
        cfg, n, params, model = run_fam_model(arch, dev)
        if arch in FAM_DEPTH:
            cfg1, _ = fam_config(arch, 1)
            devices = run_fam_devices(arch, cfg1, first_layers(params, 1),
                                      dev)
        elif arch in FAM_CHECK_DEPTH:
            k = FAM_CHECK_DEPTH[arch]
            devices = run_fam_devices(
                arch, dataclasses.replace(cfg, n_layers=k, encoder_layers=k),
                first_layers(params, k), dev)
        else:
            devices = run_fam_devices(arch, cfg, params, dev)
        params16 = lm_common.cast_floats(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        consistency = run_fam_consistency(arch, cfg, params16, dev)
        if arch == "deepseek-v2-236b":
            nodrop = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
            _, launches = run_rag_path(fx, router, cfg, params16, dev,
                                       tag="fam.rag_path",
                                       check_cfg=nodrop)
        serving = run_fam_serving(arch, cfg, n, params16, dev)
        del params16
        torch.cuda.empty_cache()
        summary[arch] = {
            "layers": cfg.n_layers, "params": n,
            "peak_device_mb": max(model["peak_device_mb"],
                                  serving["peak_device_mb"]),
            "card_vs_cpu": {k: devices[k] for k in (
                "max_abs_err_prefill", "max_abs_err_decode1",
                "moe_rows_parted", "tokens_equal")},
            "prefill_vs_decode_err": consistency["max_abs_err"],
            "serving": {k: serving[k] for k in (
                "prefill_ms", "decode_ms_per_step", "tokens_per_s",
                "prefill_bound_ms", "decode_bound_ms")},
            "seconds": time.perf_counter() - t0}
        emit("fam.done", arch=arch, **summary[arch])
    summary["launches"] = launches
    return summary


# ---------------------------------------------------------------------------
# Phase 16: LM training on the card
# ---------------------------------------------------------------------------

# (a) qwen2-0.5b whole at its full width and its own config (fp32
# parameters, remat, `default_opt_cfg`): train_4k's sequence, a global
# batch of L_ACCUM x microbatch_seqs 4 = 8 (32,768 tokens a step), L_STEPS
# steps through `train_loop` with checkpoints every L_SAVE steps. (b) a
# fresh `train_loop` resumes from step L_SAVE to L_STEPS; a third run
# (the full width cut to LC_LAYERS layers, L_SIGNAL_SEQ tokens: its
# weights drawn and its checkpoint written in half the time) gets
# SIGUSR1 during step L_SIGNAL_STEP.
TRAIN_LM = "qwen2-0.5b"
L_SEQ, L_BATCH, L_ACCUM, L_STEPS, L_SAVE = 4096, 8, 2, 6, 3
L_SIGNAL_SEQ, L_SIGNAL_STEP = 512, 2
# (c) one train step on the card and on the machine's CPU: qwen2-0.5b at
# full width cut to LC_LAYERS layers, fp32 compute, TF32 off, a batch of
# LC_BATCH x LC_SEQ tokens; the loss within LC_LOSS_RTOL and the grad
# norm within LC_GNORM_RTOL (relative); an 8-bit moment may part only
# within LC_TIE of a half-integer of its block's scale (a rounding tie).
LC_LAYERS, LC_BATCH, LC_SEQ = 2, 2, 512
LC_LOSS_RTOL, LC_GNORM_RTOL, LC_TIE = 1e-5, 1e-4, 1e-3
# (d) one train step of each other family at its published width
# (deepseek-v2 cut to 1 layer, the rest whole): D_TRAIN_SEQ tokens
# (whisper's decoder its 448 positions over 1,500 frames), a global batch
# of 2 x microbatch_seqs, accumulation 2; weights drawn on the card.
TRAIN_FAMS = ("deepseek-v2-236b", "xlstm-125m", "hymba-1.5b",
              "whisper-medium")
TRAIN_DEPTH = {"deepseek-v2-236b": 1}
D_TRAIN_SEQ, W_TRAIN_SEQ, D_ACCUM = 2048, 448, 2


def train_batch(cfg, b: int, seq: int, step: int, dev):
    """`train_loop`'s batch of step `step` (seed 0) on `dev`."""
    return train_mod.step_batch(cfg, TokenStream(cfg.vocab, seq, b, seed=1),
                                0, step, dev)


def train_bounds(cfg, n_params: int, b: int, seq: int,
                 s_enc: int = 0) -> dict:
    """The least time of one train step (forward, remat's second forward,
    backward, AdamW) at the card's dense bf16 peak and its memory rate.
    Operations: 2 a token for each matmul parameter (every parameter but
    the embedding table's gather) forward and 4 backward, 2 more for the
    layers' recomputed forward; attention's score and value products
    over every key of each query chunk (the chunks are not skipped),
    forward, recomputed and twice backward. Bytes: the parameters and the
    fp32 moments read and written once, the gradients written and read
    once; activations not counted."""
    n_embed = cfg.vocab * cfg.d_model
    n_matmul = n_params - n_embed
    n_layers = n_params - 2 * n_embed
    toks = b * seq
    dense = toks * (6 * n_matmul + (2 * n_layers if cfg.remat else 0))
    heads = cfg.n_heads
    passes = 4 if cfg.remat else 3
    if cfg.use_mla:
        per_tok = 2 * seq * heads * (2 * lm_attn.MLA_NOPE + cfg.mla_rope_dim)
    elif cfg.family == "ssm":
        per_tok = 0          # the GLA scan and the sLSTM loop: no attention
    else:
        per_tok = 2 * 2 * seq * heads * cfg.hd
    attn = toks * per_tok * cfg.n_layers * passes
    if cfg.encoder_layers:   # the encoder's own, and the decoder's cross
        enc = b * s_enc * 2 * 2 * s_enc * heads * cfg.hd * cfg.encoder_layers
        cross = toks * 2 * 2 * s_enc * heads * cfg.hd * cfg.n_layers
        attn += (enc + cross) * passes
    ops = dense + attn
    p_bytes = 2 if cfg.param_dtype == "bfloat16" else 4
    m_bytes = 2 * (1 if cfg.opt_compress else 4)
    nbytes = n_params * (2 * p_bytes + 2 * m_bytes + 2 * 4)
    ops_s, bytes_s = ops / BF16_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "tflop": ops / 1e12, "attention_tflop": attn / 1e12,
            "gb": nbytes / 1e9}


def timed_step(step_fn, params, opt, batch, det: bool, dev) -> tuple:
    """One train step, in deterministic mode or not, timed on the host
    clock between `torch.cuda.synchronize()` calls; (seconds, metrics)."""
    mode = train_mod.deterministic(dev) if det else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mode:
        _, _, met = step_fn(params, opt, batch)
    loss = float(met["loss"])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {"loss": loss,
                                      "grad_norm": float(met["grad_norm"])}


def same_tree_bits(a, b) -> bool:
    la, lb_ = lm_common.tree_leaves(a), lm_common.tree_leaves(b)
    return len(la) == len(lb_) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb_))


class SignalAtStep(TokenStream):
    """A token stream that sends this process SIGUSR1 when the batch of
    step `L_SIGNAL_STEP` is drawn (during that step)."""

    def batch(self, step):
        if step == L_SIGNAL_STEP - 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return super().batch(step)


def run_train_lm(dev, root: str) -> dict:
    """Phase 16 (a) and (b). Returns the line's fields; the step-6
    checkpoint stays in `root`/a for (e)."""
    t_phase = time.perf_counter()
    cfg = lm_configs.get_config(TRAIN_LM)
    if cfg.param_dtype != "float32" or not cfg.remat or cfg.opt_compress \
            or L_BATCH != L_ACCUM * cfg.microbatch_seqs:
        raise AssertionError(f"{TRAIN_LM}: not its own training config")
    n = lm_common.count_params(lm.model_desc(cfg))
    opt_cfg = steps_mod.default_opt_cfg(cfg)
    kw = dict(global_batch=L_BATCH, seq_len=L_SEQ, accum=L_ACCUM,
              save_every=L_SAVE, lr=opt_cfg.lr, seed=0, verbose=False,
              device=dev)
    dirs = {k: os.path.join(root, k) for k in ("a", "b", "c")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, hist = train_mod.train_loop(cfg, steps=L_STEPS,
                                             ckpt_dir=dirs["a"], **kw)
    run_a_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_LM} training: losses {losses}")
    step_s = float(np.median([h["step_time_s"] for h in hist[2:]]))
    manager = CheckpointManager(dirs["a"])
    if manager.steps() != [L_SAVE, L_STEPS]:
        raise AssertionError(f"checkpoints {manager.steps()}")
    bounds = train_bounds(cfg, n, L_BATCH, L_SEQ)
    fields = {"arch": TRAIN_LM, "params": n, "steps": L_STEPS,
              "global_batch": L_BATCH, "accum": L_ACCUM, "seq": L_SEQ,
              "tokens_per_step": L_BATCH * L_SEQ,
              "opt": dataclasses.asdict(opt_cfg), "losses": losses,
              "step_s": [h["step_time_s"] for h in hist],
              "step_ms_median_3_6": step_s * 1e3,
              "tokens_per_s": L_BATCH * L_SEQ / step_s,
              "peak_device_mb": peak, "run_s": run_a_s, **bounds}
    emit("train_lm.run", **fields)

    # (b) a fresh train_loop resumes from step L_SAVE's checkpoint
    os.makedirs(dirs["b"])
    name = os.path.basename(manager._step_dir(L_SAVE))
    os.rename(os.path.join(dirs["a"], name), os.path.join(dirs["b"], name))
    t0 = time.perf_counter()
    p_b, o_b, hist_b = train_mod.train_loop(cfg, steps=L_STEPS,
                                            ckpt_dir=dirs["b"], **kw)
    resume_s = time.perf_counter() - t0
    if [h["step"] for h in hist_b] != list(range(L_SAVE + 1, L_STEPS + 1)):
        raise AssertionError(f"resumed steps {[h['step'] for h in hist_b]}")
    if [h["loss"] for h in hist_b] != losses[L_SAVE:]:
        raise AssertionError(f"resumed losses {[h['loss'] for h in hist_b]} "
                             f"!= {losses[L_SAVE:]}")
    if not same_tree_bits((params, opt["mu"], opt["nu"]),
                          (p_b, o_b["mu"], o_b["nu"])) or \
            not int(o_b["step"]) == int(opt["step"]) == L_STEPS:
        raise AssertionError("the resumed run's parameters or moments "
                             "differ from the uninterrupted run's")
    del p_b, o_b
    torch.cuda.empty_cache()
    # a third run, preempted by SIGUSR1 during step L_SIGNAL_STEP
    before = signal.getsignal(signal.SIGUSR1)
    train_mod.TokenStream = SignalAtStep
    try:
        t0 = time.perf_counter()
        _, _, hist_c = train_mod.train_loop(
            dataclasses.replace(cfg, n_layers=LC_LAYERS), steps=L_STEPS,
            ckpt_dir=dirs["c"], **dict(kw, seq_len=L_SIGNAL_SEQ))
        signal_s = time.perf_counter() - t0
    finally:
        train_mod.TokenStream = TokenStream
    if [h["step"] for h in hist_c] != list(range(1, L_SIGNAL_STEP + 1)) \
            or CheckpointManager(dirs["c"]).steps() != [L_SIGNAL_STEP] \
            or signal.getsignal(signal.SIGUSR1) != before:
        raise AssertionError(f"preempted run: steps {hist_c}, checkpoints "
                             f"{CheckpointManager(dirs['c']).steps()}")
    shutil.rmtree(dirs["c"])
    emit("train_lm.resume", resumed_from=L_SAVE,
         resumed_losses=[h["loss"] for h in hist_b], bitwise=True,
         resume_run_s=resume_s, preempted_at=L_SIGNAL_STEP,
         preempted_checkpoints=[L_SIGNAL_STEP], signal_run_s=signal_s,
         signal_layers=LC_LAYERS, signal_seq=L_SIGNAL_SEQ)

    # two more steps of (a)'s state: one in deterministic mode under the
    # profiler (the device's activity alone; its wall time is the mode's
    # step time), one in the default mode, timed
    step_fn = steps_mod.make_train_step(cfg, train_mod.model_ctx(L_SEQ),
                                        accum=L_ACCUM, opt_cfg=opt_cfg)
    batch = train_batch(cfg, L_BATCH, L_SEQ, L_STEPS, dev)
    out = {}
    prof = profile_phase("train_lm_step", lambda: out.update(
        det=timed_step(step_fn, params, opt, batch, True, dev)),
        host_ops=False)
    det_s, det = out["det"]
    free_s, free = timed_step(step_fn, params, opt, batch, False, dev)
    for m in (det, free):
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"non-finite loss {m}")
    del params, opt
    torch.cuda.empty_cache()
    fields.update(device_idle_share=prof["device_idle_share"],
                  deterministic_step_ms=det_s * 1e3,
                  nondeterministic_step_ms=free_s * 1e3,
                  resume_run_s=resume_s, signal_run_s=signal_s,
                  seconds=time.perf_counter() - t_phase)
    emit("train_lm.modes", deterministic_step_ms=det_s * 1e3,
         nondeterministic_step_ms=free_s * 1e3,
         device_idle_share=prof["device_idle_share"],
         seconds=time.perf_counter() - t_phase)
    return fields


def moment_entries(run, part: str) -> list:
    """A run's `part` moments ("mu" or "nu") in the parameters' order."""
    return adam_mod.flatten_up_to(run["params"], run["opt"][part])


def parted_moments(plain, card, cpu, block: int) -> tuple:
    """The 8-bit moments of the card's and the CPU's compressed steps,
    compared: (count, parted count, the largest distance of a parted
    moment's value from a rounding tie, in units of its block's scale).
    A moment's value is the CPU's plain step's fp32 moment (the
    compressed step quantizes the same value, both starting from zero
    moments), over the CPU's compressed scale."""
    total, parted, worst = 0, 0, 0.0
    for part in ("mu", "nu"):
        for x, mc, mh in zip(moment_entries(plain, part),
                             moment_entries(card, part),
                             moment_entries(cpu, part)):
            total += x.numel()
            diff = mc["q"].cpu() != mh["q"]
            if not diff.any():
                continue
            n = x.shape[-1]
            blk = adam_mod._block_of(n, block)
            r = (x.reshape(x.shape[:-1] + (n // blk, blk))
                 / mh["s"][..., None]).reshape(x.shape)[diff].abs()
            worst = max(worst, float((r - r.floor() - 0.5).abs().max()))
            parted += int(diff.sum())
    return total, parted, worst


def run_train_devices(dev) -> dict:
    """Phase 16 (c): one train step of qwen2-0.5b at full width cut to
    LC_LAYERS layers, fp32 compute with TF32 off, the same weights on the
    card and on the machine's CPU: with `default_opt_cfg`, then with
    8-bit moments. The loss within LC_LOSS_RTOL, the grad norm within
    LC_GNORM_RTOL; the largest difference in the updated parameters; the
    8-bit moments equal except where a value sits within LC_TIE of a
    rounding tie of its block's scale (the count printed)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(lm_configs.get_config(TRAIN_LM),
                              n_layers=LC_LAYERS, compute_dtype="float32")
    host0 = lm_common.init_params(lm.model_desc(cfg), seed=0, device="cpu")
    ctx = train_mod.model_ctx(LC_SEQ)
    runs, times = {}, {}
    for compress in (False, True):
        opt_cfg = dataclasses.replace(steps_mod.default_opt_cfg(cfg),
                                      compress=compress)
        step_fn = steps_mod.make_train_step(cfg, ctx, accum=1,
                                            opt_cfg=opt_cfg)
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            params = lm_common.map_descs(lambda t: t.clone().to(d), host0)
            opt = adam_mod.adam_init(params, opt_cfg)
            batch = train_batch(cfg, LC_BATCH, LC_SEQ, 0, d)
            t0 = time.perf_counter()
            with train_mod.deterministic(d):
                _, _, met = step_fn(params, opt, batch)
            met = {k: float(v) for k, v in met.items()}
            times[(compress, where)] = time.perf_counter() - t0
            runs[(compress, where)] = {"params": params, "opt": opt,
                                       "met": met}
    out = {}
    for compress in (False, True):
        card, cpu = runs[(compress, "card")], runs[(compress, "cpu")]
        loss_err = abs(card["met"]["loss"] - cpu["met"]["loss"]) / \
            abs(cpu["met"]["loss"])
        gn_err = abs(card["met"]["grad_norm"] - cpu["met"]["grad_norm"]) / \
            abs(cpu["met"]["grad_norm"])
        if loss_err > LC_LOSS_RTOL or gn_err > LC_GNORM_RTOL:
            raise AssertionError(f"card vs CPU train step (compress="
                                 f"{compress}): loss {loss_err}, grad norm "
                                 f"{gn_err}")
        dp = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            lm_common.tree_leaves(card["params"]),
            lm_common.tree_leaves(cpu["params"])))
        out["compress" if compress else "plain"] = {
            "loss_card": card["met"]["loss"], "loss_cpu": cpu["met"]["loss"],
            "loss_rel_err": loss_err, "grad_norm_card":
            card["met"]["grad_norm"], "grad_norm_cpu":
            cpu["met"]["grad_norm"], "grad_norm_rel_err": gn_err,
            "max_abs_param_diff": dp, "card_s": times[(compress, "card")],
            "cpu_s": times[(compress, "cpu")]}
    # the 8-bit moments: equal but at rounding ties
    total, parted, worst = parted_moments(
        runs[(False, "cpu")], runs[(True, "card")], runs[(True, "cpu")],
        steps_mod.default_opt_cfg(cfg).block)
    if worst > LC_TIE:
        raise AssertionError(f"an 8-bit moment parts {worst} from a tie")
    scale_err = max(float(((a["s"].cpu() - b["s"]).abs() / b["s"]).max())
                    for part in ("mu", "nu")
                    for a, b in zip(moment_entries(runs[(True, "card")], part),
                                    moment_entries(runs[(True, "cpu")], part)))
    out["compress"].update(int8_moments=total, int8_parted=parted,
                           int8_parted_worst_tie_distance=worst,
                           scale_max_rel_err=scale_err)
    del runs
    fields = {"arch": TRAIN_LM, "layers": LC_LAYERS, "batch": LC_BATCH,
              "seq": LC_SEQ, "loss_rtol": LC_LOSS_RTOL,
              "grad_norm_rtol": LC_GNORM_RTOL, "tie": LC_TIE, **out,
              "seconds": time.perf_counter() - t_phase}
    emit("train.card_vs_cpu", **fields)
    return fields


def bits_sum(t: torch.Tensor) -> int:
    """The sum of a leaf's raw bits (as int64), slice by slice: a cheap
    fingerprint that a change of any element moves."""
    view = t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)
    rows = adam_mod.leaf_rows(view)
    return int(sum(torch.sum(rows[r], dtype=torch.int64)
                   for r in adam_mod.row_ranges(view.shape)))


def run_train_family(arch, dev) -> dict:
    """Phase 16 (d): one train step of `arch` at its published width
    (TRAIN_DEPTH's cut), in its own dtypes and optimizer (deepseek-v2:
    bf16 parameters, 8-bit moments): D_ACCUM microbatches of
    microbatch_seqs sequences, in deterministic mode. The loss finite,
    every leaf changed (a bf16 leaf whose step is below half its ulp
    excepted, and counted), the step time and peak memory."""
    t_phase = time.perf_counter()
    cfg, n = fam_config(arch, TRAIN_DEPTH.get(arch))
    seq = W_TRAIN_SEQ if cfg.encoder_layers else D_TRAIN_SEQ
    b = D_ACCUM * cfg.microbatch_seqs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = draw_on_card(lm.model_desc(cfg), 0, dev,
                          dtype=getattr(torch, cfg.param_dtype))
    opt_cfg = steps_mod.default_opt_cfg(cfg)
    opt = adam_mod.adam_init(params, opt_cfg)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    before = [bits_sum(t) for t in lm_common.tree_leaves(params)]
    batch = train_batch(cfg, b, seq, 0, dev)
    step_fn = steps_mod.make_train_step(cfg, train_mod.model_ctx(seq),
                                        accum=D_ACCUM, opt_cfg=opt_cfg)
    step_s, met = timed_step(step_fn, params, opt, batch, True, dev)
    peak = torch.cuda.max_memory_allocated() / 1e6
    if not np.isfinite(met["loss"]):
        raise AssertionError(f"{arch}: non-finite loss {met}")
    unchanged = []
    for i, (t, s) in enumerate(zip(lm_common.tree_leaves(params), before)):
        if bits_sum(t) != s:
            continue
        # an unchanged leaf: only a bf16 one whose step lr·(1 + wd·|p|),
        # |update| <= 1 at step 1, is below half its smallest ulp
        small = float(t.abs().min())
        half_ulp = 0.5 * small * 2.0 ** -7
        if t.dtype != torch.bfloat16 or small == 0 or \
                opt_cfg.lr * (1 + opt_cfg.weight_decay * float(
                    t.abs().max())) >= half_ulp:
            raise AssertionError(f"{arch}: leaf {i} {tuple(t.shape)} "
                                 f"unchanged by the step")
        unchanged.append(i)
    bounds = train_bounds(cfg, n, b, seq, cfg.encoder_seq)
    fields = {"arch": arch, "layers": cfg.n_layers, "params": n,
              "param_dtype": cfg.param_dtype, "compute_dtype":
              cfg.compute_dtype, "compressed_moments": opt_cfg.compress,
              "remat": cfg.remat, "global_batch": b, "accum": D_ACCUM,
              "seq": seq, "loss": met["loss"], "grad_norm": met["grad_norm"],
              "leaves": len(before), "unchanged_bf16_leaves_below_half_ulp":
              len(unchanged), "draw_s": draw_s, "step_ms": step_s * 1e3,
              "tokens_per_s": b * seq / step_s, "peak_device_mb": peak,
              **bounds, "seconds": time.perf_counter() - t_phase}
    del params, opt, batch
    torch.cuda.empty_cache()
    emit("train.family", **fields)
    return fields


def run_training(fx, router, dev) -> dict:
    """Phase 16: (a)-(b) `run_train_lm`, (c) `run_train_devices`, (d)
    `run_train_family` for each of TRAIN_FAMS, then (e): (a)'s step-6
    checkpoint restored through `CheckpointManager`, cast to bf16, serving
    phase 14 (d)'s RAG path on phase 5's handle and router with the launch
    counts set to 0 just before its queues and read just after. Returns
    the phase's summary with (e)'s counts under "launches"."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-lm-",
                            dir=os.path.join(ROOT, "build"))
    try:
        lm_run = run_train_lm(dev, root)
        devices = run_train_devices(dev)
        fams = {arch: run_train_family(arch, dev) for arch in TRAIN_FAMS}
        t0 = time.perf_counter()
        cfg = lm_configs.get_config(TRAIN_LM)
        desc = lm.model_desc(cfg)
        state, meta = CheckpointManager(os.path.join(root, "a")).restore(
            {"params": desc}, device=dev)
        if meta["step"] != L_STEPS:
            raise AssertionError(f"restored step {meta['step']}")
        params16 = lm_common.cast_floats(state["params"], torch.bfloat16)
        del state
        restore_s = time.perf_counter() - t0
        path, launches = run_rag_path(fx, router, cfg, params16, dev,
                                      tag="train.rag_path")
        del params16
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"lm": {k: lm_run[k] for k in (
                "losses", "step_ms_median_3_6", "tokens_per_s",
                "peak_device_mb", "bound_ms", "device_idle_share",
                "deterministic_step_ms", "nondeterministic_step_ms")},
            "card_vs_cpu": {k: devices[k] for k in ("plain", "compress")},
            "families": {a: {k: f[k] for k in (
                "loss", "step_ms", "peak_device_mb", "bound_ms",
                "unchanged_bf16_leaves_below_half_ulp")}
                for a, f in fams.items()},
            "rag": {"restore_s": restore_s,
                    **{k: path[k] for k in ("embed_ms", "route_retrieve_ms",
                                            "generate_ms")}},
            "launches": launches}


# ---------------------------------------------------------------------------
# ranks that share the card
# ---------------------------------------------------------------------------
# Phase 17 (b) runs MESH_RANKS processes on one card. NCCL refuses two
# ranks on one card, and gloo's own CUDA collectives crash under DTensor's
# functional collectives (torch 2.11 on an H100: a segmentation fault in
# the first all-gather). So those ranks take HOST_STAGED, a backend that
# copies each CUDA collective's tensors to the host, runs the collective
# there over an inner gloo group and copies the results back. Only this
# script chooses it, by name: `register_host_staged()` in every rank,
# then `init_process_group(HOST_STAGED, ...)`. A deployment has a card a
# rank and takes NCCL; the package holds nothing of this. The class
# leans on c10d's private hooks for Python groups (a work from a future,
# a backend registered by device type, the group's name), which is why
# it stays beside the one check that needs it.

HOST_STAGED = "gloo_host"


def _done(result):
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(tensors):
    return [t.detach().cpu() for t in tensors]


def _back(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class HostStagedGroup(tdist.ProcessGroup):
    """Every collective of a CUDA tensor staged through host memory: the
    inputs copied to the host, the collective run there by an inner gloo
    group, the outputs copied back. Each call returns once the outputs
    are written (the copies to the host wait for the card's queue). It
    serves what DTensor and the port call: all-reduce, all-gather,
    reduce-scatter (and their tensor and coalesced forms), barrier."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._inner = tdist.ProcessGroupGloo(store, rank, size, timeout)
        self._name = self._desc = None
        # the few collectives that reach a group's backend by device type
        # and not through its methods (DTensor's shard-to-shard
        # all-to-all) find gloo, whose all-to-all takes CUDA tensors
        for device in ("cpu", "cuda"):
            self._register_backend(torch.device(device),
                                   tdist.ProcessGroup.BackendType.GLOO,
                                   self._inner)

    def getBackendName(self):
        return HOST_STAGED

    # a Python group holds its own name: the base class reads it from a
    # backend, which this group has none of
    def _set_group_name(self, name):
        self._name = name

    def _set_group_desc(self, desc):
        self._desc = desc

    @property
    def group_name(self):
        return self._name

    @property
    def group_desc(self):
        return self._desc

    def allreduce(self, tensors, opts=None):
        host = _host(tensors)
        self._inner.allreduce(host, opts).wait()
        _back(tensors, host)
        return _done(tensors)

    def allgather(self, outputs, inputs, opts=None):
        host_out = [_host(o) for o in outputs]
        self._inner.allgather(host_out, _host(inputs), opts).wait()
        for o, h in zip(outputs, host_out):
            _back(o, h)
        return _done(outputs)

    def all_gather_single(self, output, input, opts=None):
        chunks = list(torch.chunk(output, self.size()))
        return self.allgather([chunks], [input], opts)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    def reduce_scatter(self, outputs, input_lists, opts=None):
        host_out = _host(outputs)
        self._inner.reduce_scatter(host_out, [_host(lst) for lst in
                                              input_lists], opts).wait()
        _back(outputs, host_out)
        return _done(outputs)

    def reduce_scatter_single(self, output, input, opts=None):
        return self.reduce_scatter(
            [output], [list(torch.chunk(input, self.size()))], opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    def barrier(self, opts=None):
        self._inner.barrier(opts).wait()
        return _done([])


def _create_host_staged(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


def register_host_staged() -> None:
    """Registers `HOST_STAGED` for CUDA and host tensors, in this process
    (every rank registers it before `init_process_group`)."""
    if HOST_STAGED not in tdist.Backend.backend_list:
        tdist.Backend.register_backend(HOST_STAGED, _create_host_staged,
                                       devices=["cpu", "cuda"])


def split_mesh(shape, axes):
    """Every block of prod(shape) consecutive ranks of the default process
    group as a mesh of its own of `shape` named `axes`; returns this
    rank's (phase 17's (1, 2) mesh inside its four ranks). Every rank
    calls it, since every rank creates every group."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n, world, me = math.prod(shape), tdist.get_world_size(), tdist.get_rank()
    if world % n:
        raise ValueError(f"{world} ranks do not split into meshes {shape}")
    ranks = torch.arange(world).view(world // n, *shape)
    groups = []
    for d in range(len(shape)):
        own = None
        for line in ranks.movedim(d + 1, -1).reshape(-1, shape[d]).tolist():
            g = tdist.new_group(line)
            if me in line:
                own = g
        groups.append(own)
    return DeviceMesh.from_group(groups, "cuda", mesh=ranks[me // n],
                                 mesh_dim_names=axes)


# ---------------------------------------------------------------------------
# phase 17: the mesh level on the card
# ---------------------------------------------------------------------------

# (a) one rank on NCCL, a (1, 1) mesh; (b) MESH_RANKS ranks sharing the
# card on the host-staged gloo backend (NCCL refuses two ranks on one
# card, and gloo's own CUDA collectives crash under DTensor's functional
# collectives). The qwen2-0.5b steps: full width at MESH_DEPTH layers,
# fp32 compute and TF32 off (the parity is to fp32), MESH_BATCH x
# MESH_SEQ tokens of `train_loop`'s step-0 and step-1 batches, the
# weights drawn on the card from MESH_SEED, accumulation 1; the (2, 2)
# step within MESH_LOSS_RTOL (loss) and MESH_GNORM_RTOL (grad norm) of
# the single-rank step. deepseek-v2 at 1 layer and full width, bf16, at
# capacity factor E/k (phase 15 (c)'s: nothing drops, so an expert flip
# moves no other token out of its expert): MESH_DS_BATCH prompts of
# MESH_DS_LEN tokens prefilled on a (1, 2) mesh (160 experts on 2
# "model" ranks: expert-parallel). The mesh's and one rank's bf16
# residuals part by their summation orders, and so do their gate logits:
# two logits can change places only where they lie within twice the
# largest measured difference, which is the near-tie of that
# comparison.
MESH_RANKS = 4
MESH_DEPTH = 4
MESH_BATCH, MESH_SEQ, MESH_SEED = 4, 2048, 7
MESH_LOSS_RTOL, MESH_GNORM_RTOL, MESH_ONE_RANK_RTOL = 1e-5, 1e-4, 1e-6
MESH_DS_BATCH, MESH_DS_LEN = 8, 32
# the resharded (1, 4) step: every rank holds the whole batch (no data
# axis), so it takes MESH_RESHARD_BATCH of the step-1 batch's sequences
MESH_RESHARD_BATCH = 2
MESH_JOIN_S = 150


def mesh_lm_config():
    cfg = lm_configs.get_config(TRAIN_LM)
    return dataclasses.replace(cfg, n_layers=MESH_DEPTH,
                               compute_dtype="float32")


class CollectiveLog(torch.utils._python_dispatch.TorchDispatchMode):
    """While entered, records each functional collective this process
    issues: its op, the mesh axis of its group, and its input's shape."""

    OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
           "all_to_all_single")

    def __init__(self, mesh):
        super().__init__()
        self.axis = {mesh.get_group(n).group_name: n
                     for n in mesh.mesh_dim_names}
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in self.OPS:
            group = args[-1] if isinstance(args[-1], str) else kwargs.get(
                "group_name")
            self.calls.append((name, self.axis.get(group, str(group)),
                               tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def gathered_params_over(log, params, mesh, axis: str) -> list:
    """The parameters whose shards an all-gather over `axis` took as its
    input (by shape: a parameter's local shard, or that shard gathered
    over the data axes; parameters are 1-D and 2-D, the step's
    activations have a batch and a sequence dimension)."""
    from torch.distributed.tensor import Shard

    shapes = set()
    for p in lm_common.tree_leaves(params):
        if not any(isinstance(pl, Shard) for pl, n in
                   zip(p.placements, mesh.mesh_dim_names) if n == axis):
            continue
        local = list(p.to_local().shape)
        shapes.add(tuple(local))
        for pl, n in zip(p.placements, mesh.mesh_dim_names):
            if n != axis and isinstance(pl, Shard):
                local[pl.dim] *= mesh.size(mesh.mesh_dim_names.index(n))
        shapes.add(tuple(local))
    return [c for c in log.calls if c[0] == "all_gather_into_tensor"
            and c[1] == axis and c[2] in shapes]


def mesh_step(cfg, params, opt, batch, ctx, dev, timed: bool = True):
    """One train step with its collectives counted (CommDebugMode) and
    logged, then, with `timed`, a second step (the state moves on by it)
    without the counting. Both timed on the host clock: (times in ms,
    the first step's metrics, counts, log)."""
    from torch.distributed.tensor.debug import CommDebugMode

    step_fn = steps_mod.make_train_step(cfg, ctx, accum=1)
    log = CollectiveLog(ctx.mesh) if lm_common.on_mesh(ctx) else None
    comm = CommDebugMode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with train_mod.deterministic(dev), comm, (log or contextlib.nullcontext()):
        _, _, met = step_fn(params, opt, batch)
    metrics = {"loss": float(met["loss"]),
               "grad_norm": float(met["grad_norm"])}
    torch.cuda.synchronize()
    times = {"counted_step_ms": (time.perf_counter() - t0) * 1e3}
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    if timed:
        t0 = time.perf_counter()
        with train_mod.deterministic(dev):
            _, _, met = step_fn(params, opt, batch)
        float(met["loss"])
        torch.cuda.synchronize()
        times["step_ms"] = (time.perf_counter() - t0) * 1e3
    return times, metrics, counts, log


def mesh_lm_state(cfg, dev):
    """The parity steps' weights (drawn on the card from MESH_SEED) and
    their optimizer state."""
    params = draw_on_card(lm.model_desc(cfg), MESH_SEED, dev)
    return params, adam_mod.adam_init(params, steps_mod.default_opt_cfg(cfg))


def mesh_batch(cfg, step: int, dev):
    return train_batch(cfg, MESH_BATCH, MESH_SEQ, step, dev)


def mesh_answers(fx, batches: dict) -> dict:
    """The single index's exact answers at k = 10 and ANY_K, by (k,
    predicate)."""
    return {(k, p): fx.search(QueryBatch(b.vectors, b.bitmaps, b.pred, k),
                              "prefilter").ids
            for k in (10, ANY_K) for p, b in batches.items()}


def run_mesh_one_rank(fx, batches: dict, want: dict, dev) -> tuple:
    """Phase 17 (a): a (1, 1) mesh on NCCL in this process: the sharded
    search at k = 10 and ANY_K against the single index's exact answers
    `want`, with the launch counts set to 0 just before and read just
    after; a qwen2-0.5b step with DTensor parameters against the plain
    step on the same weights and batch. Returns (the summary, the launch
    counts, the plain step's loss and grad norm)."""
    from repro_torch.ann import distributed as dist_mod
    from repro_torch.launch import mesh as mesh_mod

    out = {"backend": "nccl", "mesh": [1, 1]}
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    try:
        dd = fx.device
        base = [dist_mod.shard_rows(t, mesh) for t in
                (dd.vectors, dd.norms, dd.bitmaps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        got = {}
        for k in (10, ANY_K):
            fn = dist_mod.make_sharded_search(mesh, k=k)
            for p, b in batches.items():
                got[(k, p)] = fn(b.vectors, b.bitmaps, p, *base)
        launches = read_launches()
        out["search_s"] = time.perf_counter() - t0
        for key, ids in got.items():
            if not np.array_equal(ids.cpu().numpy(), want[key]):
                raise AssertionError(f"mesh search at k, pred = {key} parts "
                                     f"from the single index")
        out["search"] = "bit-identical to fx.search(batch, 'prefilter') at "\
            f"k = 10 and {ANY_K}"
        del base
        cfg = mesh_lm_config()
        params, opt = mesh_lm_state(cfg, dev)
        batch = mesh_batch(cfg, 0, dev)
        ctx1 = train_mod.model_ctx(MESH_SEQ)
        t1, m1, _, _ = mesh_step(cfg, params, opt, batch, ctx1, dev)
        del params, opt
        torch.cuda.empty_cache()
        params, opt = mesh_lm_state(cfg, dev)
        params, opt = train_mod.place_state(
            params, opt, cfg, steps_mod.default_opt_cfg(cfg), mesh)
        ctx = train_mod.model_ctx(MESH_SEQ, mesh)
        torch.cuda.reset_peak_memory_stats()
        tm, mm, counts, _ = mesh_step(
            cfg, params, opt, train_mod.place_batch(cfg, batch, mesh), ctx,
            dev)
        del params, opt
        torch.cuda.empty_cache()
        rel = abs(mm["loss"] - m1["loss"]) / abs(m1["loss"])
        if rel > MESH_ONE_RANK_RTOL:
            raise AssertionError(f"(1, 1) mesh loss {mm['loss']} vs plain "
                                 f"{m1['loss']}")
        out["step"] = {"plain": m1, "mesh": mm, "same_bits":
                       mm["loss"] == m1["loss"], "loss_rel_diff": rel,
                       "plain_ms": t1["step_ms"],
                       "plain_counted_ms": t1["counted_step_ms"],
                       "mesh_ms": tm["step_ms"],
                       "mesh_counted_ms": tm["counted_step_ms"],
                       "peak_device_mb": torch.cuda.max_memory_allocated()
                       / 1e6, "collectives": counts}
    finally:
        tdist.destroy_process_group()
    return out, launches, m1


def mesh_rank_main(rank: int, store_path: str, data_dir: str,
                   queue) -> None:
    """Phase 17 (b) in one of MESH_RANKS processes sharing the card."""
    try:
        queue.put((rank, mesh_rank_work(rank, store_path, data_dir)))
    except BaseException as e:
        import traceback
        queue.put((rank, {"error": f"{type(e).__name__}: {e}",
                          "traceback": traceback.format_exc()[-4000:]}))
        raise


def mesh_rank_work(rank, store_path, data_dir) -> dict:
    import datetime

    from repro_torch.ann import distributed as dist_mod
    from repro_torch.launch import mesh as mesh_mod

    # four processes share the card: free blocks go back to the pool
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    say = (lambda what, **kw: emit(f"mesh.rank0.{what}", **kw)) \
        if rank == 0 else (lambda what, **kw: None)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    register_host_staged()
    tdist.init_process_group(
        HOST_STAGED, store=tdist.FileStore(store_path, MESH_RANKS),
        rank=rank, world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    out = {"backend": HOST_STAGED}
    t_all = time.perf_counter()
    try:
        # the search on a (4, 1) mesh: each rank's 250,000 rows
        mesh = mesh_mod.make_mesh((MESH_RANKS, 1), ("data", "model"))
        arr = {n: np.load(os.path.join(data_dir, n + ".npy"), mmap_mode="r")
               for n in ("vectors", "norms", "bitmaps")}
        base = [dist_mod.shard_rows(arr[n], mesh) for n in
                ("vectors", "norms", "bitmaps")]
        t0 = time.perf_counter()
        same = True
        for k in (10, ANY_K):
            fn = dist_mod.make_sharded_search(mesh, k=k)
            for p in range(3):
                qv = np.load(os.path.join(data_dir, f"q{p}.npy"))
                qb = np.load(os.path.join(data_dir, f"b{p}.npy"))
                ids = fn(qv, qb, p, *base).cpu().numpy()
                same &= np.array_equal(ids, np.load(os.path.join(
                    data_dir, f"ids{k}_{p}.npy")))
        out["search"] = {"mesh": [MESH_RANKS, 1], "rows_a_rank": int(
            base[0].to_local().shape[0]), "equal_to_one_rank": bool(same),
            "seconds": time.perf_counter() - t0}
        say("search", **out["search"])
        del base, arr
        # qwen2-0.5b on (2, 2): FSDP over "data", TP over "model"
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
        cfg = mesh_lm_config()
        opt_cfg = steps_mod.default_opt_cfg(cfg)
        t0 = time.perf_counter()
        params, opt = mesh_lm_state(cfg, dev)
        params, opt = train_mod.place_state(params, opt, cfg, opt_cfg, mesh)
        torch.cuda.empty_cache()
        say("state_2x2", seconds=time.perf_counter() - t0)
        ctx = train_mod.model_ctx(MESH_SEQ, mesh)
        batch = train_mod.place_batch(cfg, mesh_batch(cfg, 0, dev), mesh)
        torch.cuda.reset_peak_memory_stats()
        ts, m, counts, log = mesh_step(cfg, params, opt, batch, ctx, dev)
        whole = gathered_params_over(log, params, mesh, "model")
        out["step_2x2"] = {
            **m, **ts, "collectives": counts,
            "params_gathered_over_model": len(whole),
            "gathers_by_axis": dict(Counter(
                c[1] for c in log.calls
                if c[0] == "all_gather_into_tensor")),
            "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6}
        say("step_2x2", **out["step_2x2"])
        del batch, log
        # the trained state on the host, then resharded onto (1, 4)
        t0 = time.perf_counter()
        host_p = lm_common.map_descs(lambda t: t.full_tensor().cpu(), params)
        host_o = {"step": opt["step"], **{
            k: lm_common.map_descs(lambda t: t.full_tensor().cpu(), opt[k])
            for k in ("mu", "nu")}}
        del params, opt
        torch.cuda.empty_cache()
        gather_s = time.perf_counter() - t0
        mesh4 = mesh_mod.make_mesh((1, MESH_RANKS), ("data", "model"))
        t0 = time.perf_counter()
        params, opt = train_mod.place_state(host_p, host_o, cfg, opt_cfg,
                                            mesh4)
        reshard_s = time.perf_counter() - t0
        say("reshard", gather_s=gather_s, reshard_s=reshard_s)
        ctx4 = train_mod.model_ctx(MESH_SEQ, mesh4)
        batch1 = {k: v[:MESH_RESHARD_BATCH] for k, v in
                  mesh_batch(cfg, 1, dev).items()}
        t4, m4, counts4, _ = mesh_step(
            cfg, params, opt, train_mod.place_batch(cfg, batch1, mesh4),
            ctx4, dev)
        del params, opt
        torch.cuda.empty_cache()
        out["reshard_1x4"] = {**m4, **t4,
                              "gather_s": gather_s, "reshard_s": reshard_s,
                              "batch": [MESH_RESHARD_BATCH, MESH_SEQ],
                              "collectives": counts4}
        say("step_1x4", **out["reshard_1x4"])
        tdist.barrier()
        if rank == 0:   # the same step on one rank from the same state
            p1 = lm_common.map_descs(lambda t: t.to(dev), host_p)
            o1 = {"step": host_o["step"], **{
                k: lm_common.map_descs(lambda t: t.to(dev), host_o[k])
                for k in ("mu", "nu")}}
            _, m1, _, _ = mesh_step(cfg, p1, o1, batch1,
                                    train_mod.model_ctx(MESH_SEQ), dev,
                                    timed=False)
            out["reshard_1x4"]["one_rank"] = m1
            del p1, o1
            torch.cuda.empty_cache()
        del host_p, host_o
        tdist.barrier()
        t0 = time.perf_counter()
        out["deepseek_1x2"] = mesh_deepseek(rank, dev)
        say("deepseek", seconds=time.perf_counter() - t0,
            **(out["deepseek_1x2"] or {}))
        out["peak_device_mb"] = torch.cuda.max_memory_allocated() / 1e6
        out["seconds"] = time.perf_counter() - t_all
        tdist.barrier()
        # phase 18 (b) in these processes: no second start of the ranks
        out["families"] = fam_mesh_work(rank, dev)
    finally:
        tdist.destroy_process_group()
    return out


def mesh_deepseek(rank: int, dev) -> dict | None:
    """deepseek-v2 (1 layer, full width, bf16) prefilled on a (1, 2) mesh
    by ranks 0 and 1 (ranks 2 and 3 only join the groups) at capacity
    factor E/k: the MoE layer on the same input dispatching as one rank
    does, bit for bit; the prefill's logits within BF16_TOL of one
    rank's on the rows whose dispatch did not part at a near-tie of the
    gate (twice the largest gate-logit difference measured between the
    two prefills; at least one row held)."""
    from repro_torch.launch import mesh as mesh_mod

    mesh = split_mesh((1, 2), ("data", "model"))
    if rank >= 2:
        return None
    cfg, _ = fam_config("deepseek-v2-236b", 1)
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    desc = lm.model_desc(cfg)
    full = draw_on_card(desc, MESH_SEED, dev, torch.bfloat16)
    axes = mesh_mod.mesh_axes(mesh)
    specs = lm_common.partition_specs(desc, tp_axis="model",
                                      tp_size=axes.tp_size)
    params = lm_common.tree_unflatten(full, iter(
        lm_common.distribute(t, s, mesh) for t, s in
        zip(lm_common.tree_leaves(full), lm_common.tree_leaves(specs))))
    if rank != 0:
        del full
        torch.cuda.empty_cache()
    ctx = lm.mesh_ctx(mesh, qc_prefill=64)
    rng = np.random.default_rng(MESH_SEED)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab, size=(MESH_DS_BATCH, MESH_DS_LEN))).to(dev)
    h = torch.from_numpy((rng.normal(size=(
        MESH_DS_BATCH, MESH_DS_LEN, cfg.d_model))).astype(np.float32)).to(
        dev, torch.bfloat16)
    row = lm_common.PartitionSpec("data", None)
    moe_p = lm_common.map_descs(lambda t: t[0], params["layers"]["moe"])
    with DispatchSpy(keep_logits=True) as spy_m:
        with lm.mesh_mode(ctx):
            y_m, _ = moe_mod.moe_apply(
                moe_p, lm_common.distribute(
                    h, lm_common.PartitionSpec("data", None, None), mesh),
                cfg, ctx)
        y_m = y_m.full_tensor()
        t0 = time.perf_counter()
        logits_m, _ = lm.forward_prefill(
            params, {"tokens": lm_common.distribute(toks, row, mesh)}, cfg,
            ctx)
        logits_m = logits_m.full_tensor()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    del params
    torch.cuda.empty_cache()
    if rank != 0:
        tdist.barrier(group=mesh.get_group("model"))
        return {"prefill_ms": prefill_ms}
    with DispatchSpy(keep_logits=True) as spy_1:
        y_1, _ = moe_mod.moe_apply(
            lm_common.map_descs(lambda t: t[0], full["layers"]["moe"]), h,
            cfg, lm.ModelCtx())
        logits_1, _ = lm.forward_prefill(full, {"tokens": toks}, cfg,
                                         lm.ModelCtx(qc_prefill=64))
    del full
    torch.cuda.empty_cache()
    tdist.barrier(group=mesh.get_group("model"))
    a, b = spy_m.calls[0], spy_1.calls[0]
    if not all(np.array_equal(a[key], b[key]) for key in ("sets", "gap",
                                                          "reach")):
        raise AssertionError("the mesh MoE layer dispatches otherwise than "
                             "one rank on the same input")
    logit_diff = max(float(np.abs(cm["logits"] - c1["logits"]).max())
                     for cm, c1 in zip(spy_m.calls[1:], spy_1.calls[1:]))
    parted, gaps = parted_rows(spy_m.calls[1:], spy_1.calls[1:],
                               MESH_DS_BATCH, tie=2 * logit_diff)
    keep = [r for r in range(MESH_DS_BATCH) if r not in parted]
    if not keep:
        raise AssertionError("every prefill row's dispatch parted")
    err = float((logits_m[keep] - logits_1[keep]).abs().max())
    if err > BF16_TOL:
        raise AssertionError(f"deepseek-v2 (1, 2) prefill logits differ by "
                             f"{err} > {BF16_TOL}")
    return {"mesh": [1, 2], "layout": "expert-parallel (160 experts, 80 a "
            "rank)", "moe_dispatch": "bit-identical to one rank on the "
            "same input", "moe_y_max_abs_err": float(
                (y_m - y_1).abs().max()),
            "prefill_rows_parted_at_near_tie": sorted(parted),
            "gate_gaps_where_parted": gaps,
            "gate_logit_max_abs_diff": logit_diff, "gate_tie": 2 * logit_diff,
            "rows_held": len(keep), "rows": MESH_DS_BATCH,
            "capacity_factor": cfg.capacity_factor,
            "drops": spy_m.drops() + spy_1.drops(),
            "prefill_max_abs_err": err, "tol": BF16_TOL,
            "prefill_ms": prefill_ms}


def run_mesh(fx, batches: dict, dev) -> dict:
    """Phase 17: (a) `run_mesh_one_rank`, then (b) MESH_RANKS processes
    sharing the card (`mesh_rank_main`), each joined with a timeout; the
    arrays they search written under `build/` for them. The kernels are
    built before any rank starts."""
    import multiprocessing

    t_all = time.perf_counter()
    _build.library()
    want = mesh_answers(fx, batches)
    one, launches, single = run_mesh_one_rank(fx, batches, want, dev)
    emit("mesh.one_rank", seconds=time.perf_counter() - t_all, **one)
    for name in ("masked_topk", "merge_topk"):
        if launches[name] == 0:
            raise AssertionError(f"the mesh path never launched {name}")
    data_dir = tempfile.mkdtemp(prefix="mesh-", dir=os.path.join(ROOT,
                                                                 "build"))
    procs = []
    try:
        dd = fx.device
        for n, t in (("vectors", dd.vectors), ("norms", dd.norms),
                     ("bitmaps", dd.bitmaps)):
            np.save(os.path.join(data_dir, n + ".npy"), t.cpu().numpy())
        for p, b in batches.items():
            np.save(os.path.join(data_dir, f"q{p}.npy"), b.vectors)
            np.save(os.path.join(data_dir, f"b{p}.npy"), b.bitmaps)
            for k in (10, ANY_K):
                np.save(os.path.join(data_dir, f"ids{k}_{p}.npy"),
                        want[(k, p)])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        store = os.path.join(data_dir, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank_main, args=(
            r, store, data_dir, queue)) for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        res = {}
        # the ranks go on to phase 18 (b) after their phase 17 work
        deadline = time.perf_counter() + MESH_JOIN_S + FM_JOIN_S
        while len(res) < MESH_RANKS:
            left = deadline - time.perf_counter()
            if left <= 0:
                late = sorted(set(range(MESH_RANKS)) - set(res))
                raise AssertionError(f"mesh ranks {late} did not finish in "
                                     f"{MESH_JOIN_S + FM_JOIN_S} s")
            try:
                r, o = queue.get(timeout=min(left, 5.0))
                res[r] = o
            except Exception:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=30)
        ranks_s = time.perf_counter() - t0
        bad = {r: o for r, o in res.items() if "error" in o}
        if bad or len(res) < MESH_RANKS:
            raise AssertionError(f"mesh ranks failed: {bad or res}; exit "
                                 f"codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(data_dir, ignore_errors=True)
    r0 = res[0]
    if not all(o["search"]["equal_to_one_rank"] for o in res.values()):
        raise AssertionError("the (4, 1) mesh search parts from (a)'s")
    st = r0["step_2x2"]
    for key, tol in (("loss", MESH_LOSS_RTOL),
                     ("grad_norm", MESH_GNORM_RTOL)):
        rel = abs(st[key] - single[key]) / abs(single[key])
        if rel > tol:
            raise AssertionError(f"(2, 2) step {key} {st[key]} vs one rank "
                                 f"{single[key]}: {rel} > {tol}")
    if any(o["step_2x2"]["params_gathered_over_model"] for o in
           res.values()):
        raise AssertionError("a parameter sharded over 'model' was "
                             "gathered over it")
    rs = r0["reshard_1x4"]
    if abs(rs["loss"] - rs["one_rank"]["loss"]) > MESH_LOSS_RTOL * abs(
            rs["one_rank"]["loss"]):
        raise AssertionError(f"resharded step loss {rs['loss']} vs one rank "
                             f"{rs['one_rank']['loss']}")
    emit("mesh.ranks", note=f"{MESH_RANKS} ranks sharing one card: per-rank "
         "times and memory, not scaling numbers", ranks_s=ranks_s,
         single_rank=single, per_rank={r: {
             "backend": o["backend"], "seconds": o["seconds"],
             "peak_device_mb": o["peak_device_mb"],
             "step_2x2_ms": o["step_2x2"]["step_ms"],
             "step_2x2_counted_ms": o["step_2x2"]["counted_step_ms"],
             "reshard_1x4_step_ms": o["reshard_1x4"]["step_ms"],
             "reshard_1x4_counted_ms": o["reshard_1x4"]["counted_step_ms"]}
             for r, o in sorted(res.items())},
         search=r0["search"], step_2x2=st, reshard_1x4=rs,
         deepseek_1x2=r0["deepseek_1x2"])
    return {"seconds": time.perf_counter() - t_all, "launches": launches,
            "families": {r: o["families"] for r, o in res.items()}}


# ---------------------------------------------------------------------------
# phase 18: the dry run, and the recurrent and encoder-decoder families on
# a mesh
# ---------------------------------------------------------------------------

# (a) The port's dry run (`launch/dryrun.py`) under this machine's torch,
# in DRY_GROUPS subprocesses of one thread each (the cells split so the
# two take about as long), started before the build and collected, with
# a timeout counted from their start, before the first timed phase (the
# main path): they run beside the build, the data's synthesis and the
# kernels' checks only, so no timed phase shares the host's cores with
# them. DRY_ARCHS × DRY_SHAPES on the 16×16
# mesh, a fake process group of 256 ranks a cell, the mesh's device type
# "cuda". Every cell must end "ok"; each decode cell's
# argument bytes must equal the JAX package's, and its per-rank dot
# FLOPs the JAX package's within DRY_FLOPS_RTOL, or where the port
# partitions otherwise the ratio DRY_PINNED within DRY_PIN_RTOL (both as
# tests/test_torch_dryrun.py holds them; the JAX package's figures,
# device-independent, from its own dry run, `repro.launch.dryrun`). The
# counts are a rank's work, not this card's speed.
DRY_GROUPS = (("xlstm-125m", "qwen2-0.5b"), ("whisper-medium", "hymba-1.5b"))
DRY_ARCHS = tuple(a for g in DRY_GROUPS for a in g)
DRY_SHAPES = ("decode_32k", "train_4k")
DRY_REF_DECODE = {"qwen2-0.5b": (1_903_247_360, 359_136_804),
                  "xlstm-125m": (77_347_584, 78_449_696),
                  "hymba-1.5b": (4_391_756_800, 1_242_347_428),
                  "whisper-medium": (2_886_418_432, 2_197_598_244)}
DRY_FLOPS_RTOL, DRY_PIN_RTOL = 0.02, 0.01
DRY_PINNED = {"qwen2-0.5b": 12.107, "xlstm-125m": 1.6104}
DRY_TIMEOUT_S = 300
DRY_SCRIPT = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun\n"
    "out = []\n"
    "for arch, shape in json.loads(sys.argv[1]):\n"
    "    res = dryrun.run_cell(arch, shape, False)\n"
    "    print(dryrun.summary_line(res), flush=True)\n"
    "    out.append(res)\n"
    "print('CELLS ' + json.dumps(out), flush=True)\n")
# (b) Phase 17 (b)'s MESH_RANKS processes, after their work there (no
# second start of four processes), on the same HOST_STAGED group, a
# (2, 2) (data, model) mesh. Each family at full width, its depth cut to
# FM_DEPTH (xlstm-125m one whole block pattern), fp32 compute and TF32
# off, the weights drawn on the card from FM_SEED: a train step on
# `train_loop`'s step-0 batch of FM_BATCH × FM_SEQ tokens (accumulation
# 1), a prefill of FM_PROMPTS prompts of FM_PROMPT_LEN tokens
# right-padded to FM_S_MAX, and FM_NEW greedy decode steps. Rank 0 runs
# the same calls on one rank (no mesh) from the same weights: the loss
# within FM_LOSS_RTOL and the grad norm within FM_GNORM_RTOL, relative;
# prefill's and every decode step's logits within B_TOL (the tolerance
# phase 15 holds these families' card against the CPU to); the greedy
# tokens equal.
FM_DEPTH = {"xlstm-125m": {"n_layers": 4},
            "hymba-1.5b": {"n_layers": 2},
            "whisper-medium": {"n_layers": 2, "encoder_layers": 2}}
FM_BATCH, FM_SEQ, FM_SEED = 2, 512, 11
FM_PROMPTS, FM_PROMPT_LEN, FM_S_MAX, FM_NEW = 2, 60, 64, 4
FM_LOSS_RTOL, FM_GNORM_RTOL = 1e-5, 1e-4
FM_JOIN_S = 240


def fam_mesh_serve(params, cfg, ctx, toks, enc):
    """Prefill of `toks` (right-padded, FM_PROMPT_LEN real) and FM_NEW
    greedy decode steps: (each call's logits, whole, as numpy; the
    greedy tokens [B, FM_NEW]; prefill ms; decode ms a step). On a mesh
    the rows go over the data axes and the cache is laid out by its
    specs."""
    mesh = ctx.mesh
    batch = {"tokens": toks}
    if enc is not None:
        batch["enc_inputs"] = enc
    if mesh is not None:
        batch = {k: serve._rows(v, ctx) for k, v in batch.items()}
    whole = (lambda t: t.full_tensor()) if mesh is not None else \
        (lambda t: t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = lm.forward_prefill(params, batch, cfg, ctx,
                                           prompt_len=FM_PROMPT_LEN)
        if mesh is not None:
            cache = serve._place_cache(cache, cfg, ctx, FM_PROMPTS,
                                       FM_S_MAX)
        out = [whole(logits).cpu().numpy()]
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks_out = []
        t0 = time.perf_counter()
        for i in range(FM_NEW):
            nxt = torch.argmax(whole(logits)[:, -1], dim=-1)
            toks_out.append(nxt.cpu().numpy())
            step = nxt[:, None] if mesh is None else serve._rows(
                nxt[:, None], ctx)
            logits, cache = lm.forward_decode(params, cache, step,
                                              FM_PROMPT_LEN + i, cfg, ctx)
            out.append(whole(logits).cpu().numpy())
        torch.cuda.synchronize()
    return out, np.stack(toks_out, 1), prefill_ms, \
        (time.perf_counter() - t0) * 1e3 / FM_NEW


def fam_mesh_one(arch: str, mesh, rank: int, dev) -> dict:
    """One family on the (2, 2) mesh, and on rank 0 the same calls on
    one rank, compared there."""
    cfg = dataclasses.replace(lm_configs.get_config(arch),
                              compute_dtype="float32", **FM_DEPTH[arch])
    desc = lm.model_desc(cfg)
    opt_cfg = steps_mod.default_opt_cfg(cfg)
    batch = train_batch(cfg, FM_BATCH, FM_SEQ, 0, dev)
    rng = np.random.default_rng(FM_SEED)
    toks = np.zeros((FM_PROMPTS, FM_S_MAX), np.int64)
    toks[:, :FM_PROMPT_LEN] = rng.integers(1, cfg.vocab, size=(
        FM_PROMPTS, FM_PROMPT_LEN))
    toks = torch.from_numpy(toks).to(dev)
    enc = frames(cfg, FM_PROMPTS, FM_SEED).to(dev) \
        if cfg.encoder_layers else None
    ctx = lm.mesh_ctx(mesh)
    heads = lm_attn.heads_part(ctx, cfg.n_heads, cfg.n_kv_heads)

    def step_on(placed_ctx, place):
        params = draw_on_card(desc, FM_SEED, dev)
        params, opt = place(params, adam_mod.adam_init(params, opt_cfg))
        b = train_mod.place_batch(cfg, batch, mesh) \
            if placed_ctx.mesh is not None else batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with train_mod.deterministic(dev):
            _, _, met = steps_mod.make_train_step(
                cfg, placed_ctx, accum=1, opt_cfg=opt_cfg)(params, opt, b)
        m = {"loss": float(met["loss"]),
             "grad_norm": float(met["grad_norm"])}
        m["step_ms"] = (time.perf_counter() - t0) * 1e3
        return m

    res = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "heads": [cfg.n_heads, cfg.n_kv_heads],
           "heads_over_model": heads is not None}
    res["step"] = step_on(ctx, lambda p, o: train_mod.place_state(
        p, o, cfg, opt_cfg, mesh))
    torch.cuda.empty_cache()
    full = draw_on_card(desc, FM_SEED, dev)
    specs = lm_common.partition_specs(desc, tp_axis="model", tp_size=2)
    params = lm_common.tree_unflatten(full, iter(
        lm_common.distribute(t, s, mesh) for t, s in
        zip(lm_common.tree_leaves(full), lm_common.tree_leaves(specs))))
    del full
    logits_m, toks_m, res["prefill_ms"], res["decode_ms"] = \
        fam_mesh_serve(params, cfg, ctx, toks, enc)
    del params
    torch.cuda.empty_cache()
    if rank != 0:
        return res
    one = step_on(lm.ModelCtx(), lambda p, o: (p, o))
    torch.cuda.empty_cache()
    params = draw_on_card(desc, FM_SEED, dev)
    logits_1, toks_1, one["prefill_ms"], one["decode_ms"] = \
        fam_mesh_serve(params, cfg, lm.ModelCtx(), toks, enc)
    del params
    torch.cuda.empty_cache()
    res["one_rank"] = one
    for key, tol in (("loss", FM_LOSS_RTOL), ("grad_norm", FM_GNORM_RTOL)):
        rel = abs(res["step"][key] - one[key]) / abs(one[key])
        res[f"{key}_rel_diff"] = rel
        if not np.isfinite(one[key]) or rel > tol:
            raise AssertionError(f"{arch} (2, 2) step {key} "
                                 f"{res['step'][key]} vs one rank "
                                 f"{one[key]}: {rel} > {tol}")
    errs = [float(np.abs(a - b).max()) for a, b in zip(logits_m, logits_1)]
    res["logits_max_abs_err"] = errs
    res["tol"] = B_TOL
    if not all(np.isfinite(x).all() for x in logits_1) or max(errs) > B_TOL:
        raise AssertionError(f"{arch} (2, 2) logits differ from one rank's "
                             f"by {errs} > {B_TOL}")
    if not np.array_equal(toks_m, toks_1):
        raise AssertionError(f"{arch} (2, 2) greedy tokens {toks_m.tolist()}"
                             f" vs one rank {toks_1.tolist()}")
    res["tokens_equal"] = True
    return res


def fam_mesh_work(rank: int, dev) -> dict:
    """Phase 18 (b) in one of phase 17's MESH_RANKS processes, after its
    work there, on the same host-staged group: the families on a (2, 2)
    mesh, the launch counts set to 0 just before and read just after."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    t_all = time.perf_counter()
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for arch in FM_DEPTH:
        t0 = time.perf_counter()
        out[arch] = fam_mesh_one(arch, mesh, rank, dev)
        out[arch]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            emit(f"mesh_families.rank0.{arch}", **out[arch])
    out["launches"] = read_launches()
    out["peak_device_mb"] = torch.cuda.max_memory_allocated() / 1e6
    out["seconds"] = time.perf_counter() - t_all
    return out


def check_dry_cells(cells: list) -> dict:
    """Every dry-run cell "ok"; the decode cells' argument bytes equal the
    JAX package's and their dot FLOPs within DRY_FLOPS_RTOL of it, or at
    the pinned ratio within DRY_PIN_RTOL."""
    out = {}
    for c in cells:
        key = f"{c['arch']} {c['shape']}"
        if c["status"] != "ok":
            raise AssertionError(f"dry run {key}: {c['status']} "
                                 f"{c.get('error', c.get('reason'))}")
        out[key] = {k: c[k] for k in (
            "dot_flops", "hbm_bytes", "collective_bytes",
            "collective_by_kind", "argument_size_in_bytes", "wall_s",
            "traced", "dot_flops_by_op")}
        if c["shape"] != "decode_32k":
            continue
        flops, args = DRY_REF_DECODE[c["arch"]]
        if c["argument_size_in_bytes"] != args:
            raise AssertionError(f"dry run {key}: argument bytes "
                                 f"{c['argument_size_in_bytes']} vs the JAX "
                                 f"package's {args}")
        ratio = c["dot_flops"] / flops
        want = DRY_PINNED.get(c["arch"], 1.0)
        tol = DRY_PIN_RTOL if c["arch"] in DRY_PINNED else DRY_FLOPS_RTOL
        out[key]["flops_ratio_to_reference"] = ratio
        if abs(ratio / want - 1) > tol:
            raise AssertionError(f"dry run {key}: dot FLOPs {ratio} times "
                                 f"the JAX package's, not {want}")
    return out


class DryRun:
    """Phase 18 (a)'s subprocesses, one per DRY_GROUPS entry: started by
    the constructor, each with its output in a file under `build/`;
    `stop` kills any that still runs and removes their directory (also
    at exit, so no path leaves one running)."""

    def __init__(self):
        import atexit

        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="dryrun-",
                                    dir=os.path.join(ROOT, "build"))
        env = dict(os.environ, REPRO_ARTIFACTS=self.dir,
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.t0 = time.perf_counter()
        self.logs, self.procs = [], []
        for i, group in enumerate(DRY_GROUPS):
            cells = [(a, s) for a in group for s in DRY_SHAPES]
            self.logs.append(open(os.path.join(self.dir, f"log{i}.txt"),
                                  "w+"))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", DRY_SCRIPT, json.dumps(cells)],
                cwd=ROOT, env=env, stdout=self.logs[-1],
                stderr=subprocess.STDOUT))
        atexit.register(self.stop)

    def collect(self) -> dict:
        """Waits out the rest of DRY_TIMEOUT_S from the start, prints each
        cell's summary line and checks the cells (`check_dry_cells`);
        returns {"cells", "wall_s" (start to the last exit), "wait_s"}."""
        t_wait = time.perf_counter()
        try:
            cells = []
            for proc, log in zip(self.procs, self.logs):
                left = DRY_TIMEOUT_S - (time.perf_counter() - self.t0)
                try:
                    proc.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"the dry run did not finish in "
                                         f"{DRY_TIMEOUT_S} s")
                log.seek(0)
                text = log.read()
                lines = [ln for ln in text.splitlines() if ln.startswith(
                    ("ok ", "error ", "skipped ", "CELLS "))]
                if proc.returncode != 0 or not lines or \
                        not lines[-1].startswith("CELLS "):
                    raise AssertionError(f"the dry run exited "
                                         f"{proc.returncode}: {text[-3000:]}")
                for ln in lines[:-1]:
                    print(ln, flush=True)
                cells += json.loads(lines[-1][len("CELLS "):])
            done = time.perf_counter()
        finally:
            self.stop()
        return {"cells": check_dry_cells(cells), "wall_s": done - self.t0,
                "wait_s": done - t_wait}

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for log in self.logs:
            if not log.closed:
                log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def run_mesh_families(dry: dict, ranks: dict) -> dict:
    """Phase 18: (a) the dry run's cells, collected and checked before
    the first timed phase (`DryRun.collect`), and (b) the families' results
    from phase 17's ranks (`fam_mesh_work`, checked on rank 0 there).
    Returns the ranks' launch counts, summed."""
    emit("mesh_families.dryrun", note="a rank's work on the 16x16 mesh, "
         "counted on meta tensors under a fake process group: no time on "
         "any chip; run beside the build, the data's synthesis and the "
         "kernels' checks",
         wall_s=dry["wall_s"], wait_s=dry["wait_s"], cells=dry["cells"])
    launches = {name: sum(o["launches"][name] for o in ranks.values())
                for name in KERNEL_WRAPPERS}
    emit("mesh_families.ranks", note=f"{MESH_RANKS} ranks sharing one card "
         "on (2, 2), phase 17's processes after their work there: per-rank "
         "times, not scaling numbers; hymba-1.5b's 25 heads and 5 kv heads "
         "do not divide 'model' = 2, so its heads run whole on every rank",
         per_rank={r: {"seconds": o["seconds"],
                       "peak_device_mb": o["peak_device_mb"],
                       **{a: {k: o[a][k] for k in ("step", "prefill_ms",
                                                   "decode_ms", "seconds")}
                          for a in FM_DEPTH}}
                   for r, o in sorted(ranks.items())},
         families={a: ranks[0][a] for a in FM_DEPTH})
    return {"launches": launches}


PROFILE_ATTEMPTS = 3


def profile_phase(name: str, fn, host_ops: bool = True) -> dict:
    """`fn()` once under torch.profiler: wall time, the device's busy time
    (the sum of its kernel, copy and fill intervals, which one stream runs
    one at a time), the idle share, and the kernels that took most (by
    operator, or by kernel name without `host_ops`, which records the
    device's activity alone: a pass of hundreds of thousands of operators
    costs the profiler tens of seconds to read back). Returns the line's
    fields.

    CUPTI now and then hands back no device record for a session (seen
    once on a pass of 7 ms), so a session without one is run again, up to
    `PROFILE_ATTEMPTS` times; if none records the device, the pass is
    timed between CUDA events instead, and the busy time and idle share
    are `None` (not measured)."""
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            break
        print(f"chip_smoke: profile {name}: the profiler recorded no "
              f"device activity (attempt {attempt} of {PROFILE_ATTEMPTS})",
              file=sys.stderr, flush=True)
    else:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fields = {"wall_s": wall, "device_busy_s": None,
                  "device_idle_share": None, "top_device_ms": [],
                  "device_span_s_cuda_events": start.elapsed_time(end) / 1e3,
                  "profiler_attempts": PROFILE_ATTEMPTS}
        emit(f"profile.{name}", **fields)
        return fields
    avgs = sorted(prof.key_averages(),
                  key=lambda a: a.self_device_time_total, reverse=True)
    top = [[a.key[:70], a.self_device_time_total / 1e3, a.count]
           for a in avgs[:6] if a.self_device_time_total > 0]
    fields = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
              "device_idle_share": 1.0 - busy_us / 1e6 / wall,
              "top_device_ms": top, "profiler_attempts": attempt}
    emit(f"profile.{name}", **fields)
    return fields


# ---------------------------------------------------------------------------

def check_features_across_devices(fx, routed: dict) -> None:
    """The selectivity feature on the handle's device against the
    group-table path the CPU takes: both exact, so bit-identical."""
    for pred, batch in routed.items():
        if not np.array_equal(
                F.batch_selectivity(fx.ds, batch.bitmaps, pred, fx=fx),
                F.batch_selectivity(fx.ds, batch.bitmaps, pred)):
            raise AssertionError(f"selectivity features differ across "
                                 f"devices, {PRED_NAMES[pred]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "card", file=sys.stderr)
        return 1

    # parity is to fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # phase 18 (a), the dry run, beside the build, the data's synthesis
    # and the kernels' checks; collected before the first timed phase
    dry = DryRun()
    # the build (nvcc in subprocesses) on a thread of its own while this
    # one synthesizes the data
    built = {}

    def build_library():
        t = time.perf_counter()
        try:
            built["lib"] = _build.build()
        except BaseException as e:
            built["error"] = e
        built["seconds"] = time.perf_counter() - t

    builder = threading.Thread(target=build_library, daemon=True)
    builder.start()
    t0 = time.perf_counter()
    spec = dataclasses.replace(VALIDATION_SPECS["synth_192d"], n=ROWS,
                               dim=192)
    ds = synthesize(spec)
    t_syn = time.perf_counter() - t0
    builder.join()
    if "error" in built:
        raise built["error"]
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=built["seconds"], library=os.path.relpath(
        built["lib"], ROOT), nvcc_seconds=_build.build_seconds, ptxas=ptxas,
         beside="the data's synthesis and the dry run")

    t0 = time.perf_counter()
    fx = FilteredIndex(ds)                    # device="cuda", the default
    dd = fx.device
    torch.cuda.synchronize()
    emit("data", spec=dataclasses.asdict(spec), n=ds.n, dim=ds.dim,
         words=int(ds.bitmaps.shape[1]), groups=ds.n_groups,
         synth_s=t_syn, upload_s=time.perf_counter() - t0,
         device_mb=(dd.vectors.nbytes + dd.bitmaps.nbytes) / 1e6)

    t0 = time.perf_counter()
    errs = check_kernels(dev, ds.n, ds.dim, int(ds.bitmaps.shape[1]))
    emit("kernels", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("graph.check", sets=check_graph_build(dev),
         card_build="bit-identical to the numpy build",
         seconds=time.perf_counter() - t0)

    # phase 18 (a)'s dry run, collected before the first timed phase (it
    # ran beside the build, the data's synthesis and the checks above)
    dry_run = dry.collect()
    emit("dryrun", wall_s=dry_run["wall_s"], wait_s=dry_run["wait_s"],
         cells=len(dry_run["cells"]), checked="every cell ok; the decode "
         "cells held to the JAX package's (phase 18 (a))")

    # (a)-(d): the main path, with every launch count set to 0 just before
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    exact, routed, svc, summary, rows = run_path(
        fx, os.path.join(ASSETS, "router_all"), QUERIES, GT_QUERIES)
    launches = read_launches()
    emit("path", seconds=time.perf_counter() - t0, launches=launches,
         **summary)
    for name in ("masked_topk", "selectivity"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    check_features_across_devices(fx, routed)
    emit("path.features_across_devices", selectivity="bit-identical")

    # where the time goes: one pass of each path under the profiler
    exact_batches = {p: QueryBatch.from_queryset(qs)
                     for p, qs in exact.items()}
    profile_phase("exact", lambda: [fx.search(b, "prefilter")
                                    for b in exact_batches.values()])
    profile_phase("routed", lambda: [svc.search(b)
                                     for b in routed.values()])

    t0 = time.perf_counter()
    times = time_kernels(fx, exact_batches, dev)
    emit("kernels.timing", seconds=time.perf_counter() - t0)

    # slice 2: the kernels of the sharded path and of the multi-block
    # entry point against their plain versions, on the card
    t0 = time.perf_counter()
    errs.update(check_slice2_kernels(dev, fx, exact_batches))
    emit("kernels.slice2", seconds=time.perf_counter() - t0)

    # the sharded path: 4 shards of the same rows, launch counts set to 0
    # just before and read just after
    t0 = time.perf_counter()
    sfx = ShardedFilteredIndex(ds, SHARDS)    # device="cuda", the default
    for fxj in sfx.shards:
        fxj.device                            # upload the shards
    torch.cuda.synchronize()
    emit("sharded.open", shards=SHARDS, shard_rows=np.diff(
        sfx.bounds).tolist(), devices=[str(f.torch_device)
                                       for f in sfx.shards],
         seconds=time.perf_counter() - t0)
    want = single_index_answers(fx, svc, exact, routed)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sharded = run_sharded(sfx, ds, svc, exact, routed, want)
    launches_sharded = read_launches()
    emit("sharded", seconds=time.perf_counter() - t0,
         launches=launches_sharded,
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6, **sharded)
    for name in ("masked_topk", "selectivity", "merge_topk"):
        if launches_sharded[name] == 0:
            raise AssertionError(f"the sharded path never launched {name}")

    # the queue over the sharded service
    ssvc = ShardedRouterService(sfx, svc.router, t=svc.t)
    work = queue_workload(sfx, ssvc, exact, QUEUE_PER_PRED)
    t0 = time.perf_counter()
    reset_launches()
    run_queue(sfx, ssvc, work)
    launches_queue = read_launches()
    emit("queue", seconds=time.perf_counter() - t0,
         launches=launches_queue)
    for name in ("masked_topk", "merge_topk"):
        if launches_queue[name] == 0:
            raise AssertionError(f"the queue never launched {name}")

    # the multi-block entry point of exact search
    t0 = time.perf_counter()
    reset_launches()
    run_multiblock(fx, exact_batches)
    launches_mb = read_launches()
    emit("multiblock.path", seconds=time.perf_counter() - t0,
         launches=launches_mb)
    for name in ("masked_topk_blocks", "merge_topk"):
        if launches_mb[name] == 0:
            raise AssertionError(f"the multi-block entry point never "
                                 f"launched {name}")

    profile_phase("sharded_exact", lambda: [sfx.search(b, "prefilter")
                                            for b in exact_batches.values()])
    profile_phase("sharded_routed", lambda: [ssvc.search(b)
                                             for b in routed.values()])
    dd = fx.device

    def multiblock_pass():
        for p, b in exact_batches.items():
            ops.masked_topk_multiblock(
                to_device(b.vectors, dev), to_device(b.bitmaps, dev),
                dd.vectors, dd.norms, dd.bitmaps, pred=p, k=b.k)
    profile_phase("multiblock", multiblock_pass)

    t0 = time.perf_counter()
    times.update(time_slice2_kernels(fx, sfx, exact_batches, dev))
    emit("kernels.timing2", seconds=time.perf_counter() - t0)

    # slice 3, the live index: the kernels against their plain versions on
    # grids, then (a) the live read path with the launch counts set to 0
    # just before and read just after, (b) the kernels on its inputs,
    # profiles and times, (c) snapshot and compaction, counted on their own
    t0 = time.perf_counter()
    live_cases = check_live_grids(dev)
    emit("live.kernels.check", grid_cases=live_cases,
         fused_live_and_masked_topk_large="bit-identical",
         seconds=time.perf_counter() - t0)
    live = LiveFilteredIndex(ds, delta_chunk=LIVE_CHUNK)
    live_full = LiveFilteredIndex(ds, delta_chunk=LIVE_CHUNK,
                                  delta_prune_min_rows=LIVE_UPSERTS + 1)
    for h in (live, live_full):
        h.device                              # upload the bases
    live_svc = RouterService(live, svc.router, t=0.9)
    want_live = live_answers(live, live_full, ds, exact_batches, routed,
                             live_svc)
    live_full.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    live_summary, live_fused = run_live_reads(
        live, live_svc, exact_batches, routed, want_live, GT_QUERIES)
    launches_live = read_launches()
    emit("live", seconds=time.perf_counter() - t0, launches=launches_live,
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6,
         prune=live.stats()["delta_prune"], **live_summary)
    for name in ("fused_live", "masked_topk_large", "selectivity"):
        if launches_live[name] == 0:
            raise AssertionError(f"the live path never launched {name}")
    # phase 10's references: the single live handle over the same writes
    single_live = single_live_answers(live, live_svc, routed, live_fused,
                                      want_live["truth"])
    reset_launches()
    staged_s = run_live_staged(live, exact_batches, live_fused)
    launches_staged = read_launches()
    emit("live.staged_path", seconds=staged_s, launches=launches_staged)
    for name in ("masked_topk_large", "merge_topk"):
        if launches_staged[name] == 0:
            raise AssertionError(f"the staged live read never launched "
                                 f"{name}")

    t0 = time.perf_counter()
    errs.update(check_live_path_kernels(live, exact_batches))
    emit("live.kernels.path_check", seconds=time.perf_counter() - t0,
         fused_live=errs["fused_live"],
         masked_topk_large=errs["masked_topk_large"])
    profile_phase("live_exact", lambda: [live.search(b, "prefilter")
                                         for b in exact_batches.values()])

    def staged_pass():
        live.fused = False
        try:
            for b in exact_batches.values():
                live.search(b, "prefilter")
        finally:
            live.fused = True
    profile_phase("live_staged", staged_pass)
    profile_phase("live_routed", lambda: [live_svc.search(b)
                                          for b in routed.values()])
    t0 = time.perf_counter()
    times.update(time_live_kernels(live, exact_batches, dev))
    emit("live.kernels.timing", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    yard = time_merge_yardsticks(live, fx, sfx, exact_batches, dev)
    emit("live.merge_topk.yardstick_timing",
         seconds=time.perf_counter() - t0,
         sums={kind: {f: v for f, v in o.items() if f != "per_predicate"}
               for kind, o in yard.items()})

    # slice 4, any k: the kernels against their plain versions on grids,
    # then k = ANY_K through the sharded, live and multi-block entry points
    # with the launch counts set to 0 just before and read just after
    t0 = time.perf_counter()
    grid4 = check_slice4_grids(dev)
    emit("anyk.kernels.check", cases=grid4, result="bit-identical",
         seconds=time.perf_counter() - t0)
    batches_k = anyk_batches(exact_batches)
    want_k, want_mb = anyk_answers(fx, batches_k)
    t0 = time.perf_counter()
    reset_launches()
    run_anyk(fx, sfx, live, batches_k, want_k, want_mb, GT_QUERIES)
    launches_anyk = read_launches()
    emit("anyk.path", seconds=time.perf_counter() - t0,
         launches=launches_anyk)
    for name in ("merge_topk", "fused_live", "masked_topk_large",
                 "masked_topk_blocks"):
        if launches_anyk[name] == 0:
            raise AssertionError(f"the any-k phase never launched {name}")
    sfx.close()

    def large_pass(k):
        for p, b in exact_batches.items():
            mk.masked_topk_large(
                to_device(b.vectors[:DEFAULT_QCHUNK], dev),
                to_device(b.bitmaps[:DEFAULT_QCHUNK], dev), dd.vectors,
                dd.norms, dd.bitmaps, pred=p, k=k)
    profile_phase("masked_topk_large_k1016", lambda: large_pass(1016))
    profile_phase("masked_topk_large_k200", lambda: large_pass(ANY_K))

    # phase 12 (b) on the live handle in phase 8's state: an audit pass,
    # its exact keys those of phase 8's exact reads
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    serve_dir = tempfile.mkdtemp(prefix="serving-",
                                 dir=os.path.join(ROOT, "build"))
    launches_serving = {"live": run_serving_audit_live(
        live, svc.router, routed, want_live["truth"], serve_dir, "live",
        "fused_live")}

    t0 = time.perf_counter()
    reset_launches()
    live_summary.update(run_live_compaction(live, ds, exact_batches))
    emit("live.compaction_path", seconds=time.perf_counter() - t0,
         launches=read_launches())
    # phase 12 (c, e) on the compacted live handle: cache staleness under
    # a write, the live span tree, the ledger's gauges and leases
    t0 = time.perf_counter()
    launches_serving["live_ops"] = run_serving_live_ops(
        live, svc.router, routed, serve_dir)["launches"]
    emit("serving.live", seconds=time.perf_counter() - t0)
    live.close()

    # phase 10, the sharded live index: phase 8's writes and the reference
    # answers first, then (a)-(c) with the launch counts set to 0 just
    # before and read just after; snapshot and compaction counted apart
    t0 = time.perf_counter()
    live4 = ShardedLiveIndex(ds, SHARDS, delta_chunk=LIVE_CHUNK)
    for shard in live4.shards:
        shard.device                          # upload the shards' bases
    torch.cuda.synchronize()
    emit("sharded_live.open", shards=SHARDS,
         shard_rows=np.diff(live4.bounds).tolist(),
         devices=live4.stats()["devices"], seconds=time.perf_counter() - t0)
    svc4 = ShardedRouterService(live4, svc.router, t=0.9)
    want4 = sharded_live_answers(live4, ds, svc4, exact_batches)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sl_summary = run_sharded_live(live4, svc4, exact_batches, routed,
                                  single_live, want4, GT_QUERIES)
    launches_sl = read_launches()
    emit("sharded_live", seconds=time.perf_counter() - t0,
         launches=launches_sl,
         peak_device_mb=torch.cuda.max_memory_allocated() / 1e6,
         prune=[sh.stats()["delta_prune"] for sh in live4.shards],
         **sl_summary)
    if launches_sl["masked_topk"] + launches_sl["masked_topk_large"] == 0:
        raise AssertionError("the sharded live path never launched a "
                             "masked top-k")
    for name in ("fused_live", "merge_topk", "selectivity"):
        if launches_sl[name] == 0:
            raise AssertionError(f"the sharded live path never launched "
                                 f"{name}")
    # phase 12 (b) on the sharded live handle in phase 10's state
    launches_serving["sharded_live"] = run_serving_audit_live(
        live4, svc.router, routed, single_live["truth"], serve_dir,
        "sharded_live", "merge_topk")
    phase8 = {k: single_live[k] for k in ("fused", "decisions", "routed")}
    del single_live
    profile_phase("sharded_live_exact",
                  lambda: [live4.search(b, "prefilter")
                           for b in exact_batches.values()])
    profile_phase("sharded_live_routed", lambda: [svc4.search(b)
                                                  for b in routed.values()])
    t0 = time.perf_counter()
    sl_times = time_sharded_live_kernels(live4, exact_batches, dev)
    emit("sharded_live.kernels.timing", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    reset_launches()
    sl_summary.update(run_sharded_live_compaction(live4, exact_batches))
    emit("sharded_live.compaction_path", seconds=time.perf_counter() - t0,
         launches=read_launches())
    live4.close()

    # phase 11, durable storage: the single and the sharded store in a
    # directory under build/, removed at the end; the recovered reads'
    # launch counts set to 0 just before each and read just after
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store_root = tempfile.mkdtemp(prefix="store-",
                                  dir=os.path.join(ROOT, "build"))
    launches_store = {}
    try:
        single = run_single_store(store_root, fx, ds, rows, phase8,
                                  exact_batches, routed, launches_store)
        sharded4 = run_sharded_store(store_root, ds, exact_batches,
                                     launches_store)
    finally:
        shutil.rmtree(store_root, ignore_errors=True)
    store_folds = sharded4.pop("merge_folds")
    emit("store.merge_topk.yardstick", folds=store_folds)
    store_errs = {}
    for part in (single, sharded4):
        for name, err in part.pop("max_abs_err").items():
            store_errs[name] = max(store_errs.get(name, 0.0), err)
    emit("store", seconds=time.perf_counter() - t0, launches=launches_store,
         max_abs_err=store_errs,
         dir_bytes_max=max(single["dir_bytes"], sharded4["dir_bytes"]),
         single=single, sharded=sharded4)
    for name in ("fused_live", "masked_topk_large", "selectivity",
                 "merge_topk"):
        if launches_store.get(name, 0) == 0:
            raise AssertionError(f"the recovered stores' reads never "
                                 f"launched {name}")
    # phase 12, serving ops on the phase-5 handle and router: (a) hooked
    # serving, (b) an audit, (c) the cache behind the queue, (d)
    # adaptation, (e) /metrics; everything it opens closed before the end
    t0 = time.perf_counter()
    closers = []
    try:
        hooks = serving_hooks(serve_dir, "wide_events")
        closers.append(hooks["obslog"].close)
        hooked, hooked_summary = run_serving_hooked(fx, svc, routed, hooks)
        launches_serving["hooked"] = hooked_summary["launches"]
        emit("serving.hooked", **hooked_summary)

        want_exact = {p: fx.search(b, "prefilter").keys
                      for p, b in routed.items()}
        table = OnlineBenchmarkTable(svc.router.table)
        auditor = RecallAuditor(fx, hooks["telemetry"], table=table,
                                slo=hooks["slo"])
        audit = audit_and_hold(auditor, query_index(routed), want_exact,
                               "sealed")
        if audit["launches"]["masked_topk"] == 0:
            raise AssertionError("the audit never launched masked_topk")
        launches_serving["audit"] = audit["launches"]
        emit("serving.audit.sealed", table_version=table.version,
             slo=hooks["slo"].stats(), **audit)

        cache, queue, cache_summary = run_serving_cache(fx, hooked, routed)
        closers += [cache.close, queue.close]
        launches_serving["cache"] = cache_summary["launches"]
        emit("serving.cache", **cache_summary)

        adapt = run_serving_adaptation(fx, routed)
        launches_serving["adaptation"] = adapt["launches"]
        emit("serving.adaptation", **adapt)

        dumper = PostmortemDumper(tracer=hooks["tracer"],
                                  ledger=get_ledger(), slo=hooks["slo"],
                                  obslog=hooks["obslog"],
                                  out_dir=serve_dir).install()
        closers.append(dumper.uninstall)
        with open(dumper.dump("chip_smoke")) as f:
            sections = sorted(json.load(f))
        surfaces = dict(sink=hooks["telemetry"], tracer=hooks["tracer"],
                        cache=cache, queue=queue, ledger=get_ledger(),
                        slo=hooks["slo"], obslog=hooks["obslog"],
                        table=table)
        emit("serving.metrics", postmortem_sections=sections,
             **run_serving_metrics(surfaces, queue))
    finally:
        for close in reversed(closers):
            close()
        shutil.rmtree(serve_dir, ignore_errors=True)
    emit("serving", seconds=time.perf_counter() - t0,
         launches=launches_serving)

    # phase 13, the router's offline stage: (a) the sweep into table B,
    # (b) the fits on the card and the CPU, (c) the trained router serving
    # the 1M handle, (d) the default retrain; launch counts set to 0 just
    # before (after the routed batches' exact answers) and read just after
    truth = {p: fx.search(b, "prefilter").ids for p, b in routed.items()}
    t0 = time.perf_counter()
    reset_launches()
    coll, train_handles, sweep = run_train_sweep(dev)
    models, scaler, fit = run_train_fits(coll, dev)
    train_dir = tempfile.mkdtemp(prefix="train-",
                                 dir=os.path.join(ROOT, "build"))
    try:
        trained = run_train_router(fx, models, scaler, coll.table, rows,
                                   routed, truth, summary["recall_at_10"],
                                   train_dir)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    retrain = run_train_retrain(
        fx, routed[int(Predicate.AND)].take(np.arange(32)))
    emit("train.retrain", **retrain)
    launches_train = read_launches()
    emit("train", seconds=time.perf_counter() - t0, launches=launches_train,
         sweep_s=sweep["seconds"], fit_card_s=sum(
             v["card_s"] for v in fit["methods"].values()), routed=trained)
    for name in ("masked_topk", "selectivity"):
        if launches_train[name] == 0:
            raise AssertionError(f"the offline stage never launched {name}")
    # the device's activity alone: read back with the host's operators,
    # these two passes cost the profiler about 50 and 20 s
    profile_phase("train_sweep", lambda: training.collect(
        {"ytb_audio": train_handles["ytb_audio"]},
        {m: get_method(m) for m in training.METHOD_ORDER},
        n_queries=TRAIN_QUERIES, verbose=False), host_ops=False)
    profile_phase("train_fit", lambda: training.train_models(
        coll, F.MINIMAL_FEATURES, hidden=TRAIN_HIDDEN,
        epochs=TRAIN_EPOCHS // 10, device=dev), host_ops=False)
    for h in train_handles.values():
        h.close()

    # phase 14, the RAG example's served LM at qwen2-0.5b's full width on
    # phase 5's handle and router; the RAG path's launch counts set to 0
    # just before its queues and read just after
    t0 = time.perf_counter()
    rag = run_rag(fx, svc.router, dev)
    launches_rag = rag.pop("launches")
    emit("rag", seconds=time.perf_counter() - t0, launches=launches_rag,
         **rag)
    # phase 15, every other family's serving forward at full width; the
    # RAG path with deepseek-v2 as its LM counted as phase 14's is
    t0 = time.perf_counter()
    fam = run_families(fx, svc.router, dev)
    launches_fam = fam.pop("launches")
    emit("families", seconds=time.perf_counter() - t0,
         launches=launches_fam, **fam)
    for name in ("masked_topk", "selectivity"):
        if launches_fam[name] == 0:
            raise AssertionError(f"the RAG path with deepseek-v2 never "
                                 f"launched {name}")
    # phase 16, LM training: qwen2-0.5b trained, resumed and preempted at
    # full width, one step card against CPU, one step of each other
    # family, then the trained model serving the RAG path, its launch
    # counts set to 0 just before its queues and read just after
    t0 = time.perf_counter()
    trained = run_training(fx, svc.router, dev)
    launches_trained = trained.pop("launches")
    emit("training", seconds=time.perf_counter() - t0,
         launches=launches_trained, **trained)
    for name in ("masked_topk", "selectivity"):
        if launches_trained[name] == 0:
            raise AssertionError(f"the RAG path with the trained model never "
                                 f"launched {name}")
    # phase 17, the mesh level: one rank on NCCL, then four ranks sharing
    # the card; the mesh search's launch counts set to 0 just before it
    # and read just after
    t0 = time.perf_counter()
    mesh_run = run_mesh(fx, exact_batches, dev)
    launches_mesh = mesh_run.pop("launches")
    fam_ranks = mesh_run.pop("families")
    fam_s = max(o["seconds"] for o in fam_ranks.values())
    emit("mesh", seconds=time.perf_counter() - t0 - fam_s,
         launches=launches_mesh, note="the phase's wall time less phase 18 "
         "(b)'s span, which ran in the ranks after phase 17 (b)")
    # phase 18, the dry run's cells (run beside phases 2-4) and the
    # recurrent and encoder-decoder families on a (2, 2) mesh of phase
    # 17's four ranks sharing the card, each rank's launch counts set to
    # 0 just before and read just after (summed over the ranks)
    t0 = time.perf_counter()
    fm_run = run_mesh_families(dry_run, fam_ranks)
    launches_fm = fm_run.pop("launches")
    emit("mesh_families", seconds=fam_s + time.perf_counter() - t0,
         launches=launches_fm, note="(b)'s span in the ranks, the longest "
         "rank's; (a) ran beside the build, the data's synthesis and the "
         "kernels' checks (its wall time in mesh_families.dryrun), not in "
         "this span")
    serving_total = {name: sum(c[name] for c in launches_serving.values())
                     for name in KERNEL_WRAPPERS}
    launches_by_path = {"main": launches, "sharded": launches_sharded,
                        "queue": launches_queue, "multiblock": launches_mb,
                        "live": launches_live, "live_staged": launches_staged,
                        "anyk": launches_anyk, "sharded_live": launches_sl,
                        "store": launches_store, "serving": serving_total,
                        "train": launches_train, "rag": launches_rag,
                        "rag_deepseek": launches_fam,
                        "rag_trained": launches_trained,
                        "mesh": launches_mesh,
                        "mesh_families": launches_fm}

    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for name, source, replaces, n_launch, work in (
            ("masked_topk", src + "masked_topk.cu",
             "src/repro/kernels/masked_topk.py:124", launches,
             "one launch per predicate on the first 64-query chunk of the "
             "exact batch over the 1M rows (exact search cuts its batches "
             "into 64-query chunks), summed"),
            ("selectivity", src + "selectivity.cu",
             "src/repro/kernels/bitmap_filter.py:36", launches,
             "one launch per predicate on a whole 256-query batch over the "
             "1M rows (W = 7), as the routing features give it, summed; "
             "widths: 256 random-pattern queries over 1M rows at W = 1, "
             "13 and 63, per predicate"),
            ("merge_topk", src + "merge_topk.cu",
             "src/repro/kernels/masked_topk.py:191", launches_sharded,
             "one launch per predicate on the [4, 256, 10] shard candidates "
             "of the sharded exact batch, summed; launches from the sharded "
             "path; library_ms is torch.topk over the shard-major [256, 40] "
             "copy, which finds the same set with no tie order; by_input: "
             "the same on each kind of input (phases 8 and 11)"),
            ("masked_topk_blocks", src + "masked_topk.cu",
             "src/repro/kernels/masked_topk.py:367", launches_mb,
             "one launch per predicate on the whole 256-query exact batch "
             "over the 1M rows, summed; launches from "
             "ops.masked_topk_multiblock on the three exact batches; "
             "k200_ms: the same at k = 200"),
            ("fused_live", src + "fused_live.cu",
             "src/repro/kernels/masked_topk.py:294", launches_live,
             "one launch per predicate on the live read's inputs for the "
             "256-query exact batch (1,016 base candidates a query, the "
             "chunk pruner's delta rows of 32,768, packed tombstones), "
             "summed; launches from the live read path (fused exact, "
             "routed and queued reads; its reference answers are made "
             "before the counts are set to 0)"),
            ("masked_topk_large", src + "masked_topk.cu",
             "src/repro/kernels/masked_topk.py:124", launches_live,
             "masked_topk for k > 128 (the key and select kernels): one "
             "launch per predicate on the first 64-query chunk of the live "
             "base overfetch, k = 1,016 over the 1M base rows, summed; "
             "launches from the live read path (fused exact, routed and "
             "queued reads; its reference answers are made before the "
             "counts are set to 0); k200_ms: the same at k = 200")):
        t = times[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch[name],
            "max_abs_err": max(errs[name],
                               sl_times["max_abs_err"].get(name, 0.0),
                               store_errs.get(name, 0.0)),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_s"] * 1e3,
            "bound_by": ("operations" if t["ops_s"] >= t["bytes_s"]
                         else "bytes"),
            "library_ms": (t["library_ms"] if name == "merge_topk"
                           else None),
            "launches_by_path": {p: c[name]
                                 for p, c in launches_by_path.items()},
            "work": work}
        if name in sl_times:
            row.update(sharded_live_ms=sl_times[name]["ms"],
                       sharded_live_plain_ms=sl_times[name]["plain_ms"],
                       sharded_live_bound_ms=sl_times[name]["bound_s"] * 1e3)
        if name in sl_times["max_abs_err"]:
            row["sharded_live_max_abs_err"] = sl_times["max_abs_err"][name]
        if name in store_errs:
            row["store_max_abs_err"] = store_errs[name]
        if name in ("masked_topk_large", "masked_topk_blocks"):
            row.update(k200_ms=t["k200_ms"],
                       k200_bound_ms=t["k200_bound_s"] * 1e3)
        if name == "selectivity":
            row["widths"] = t["widths"]
        if name == "merge_topk":
            row["by_input"] = merge_by_input(yard, store_folds)
        rows.append(row)
    emit("kernels.earlier", source="copied from PERF.md, not measured by "
         "this run", ms={name: sum(t) for name, t in EARLIER_MS.items()},
         per_predicate_ms=EARLIER_MS)
    emit("done", seconds=time.perf_counter() - t_all)
    fx.close()
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
