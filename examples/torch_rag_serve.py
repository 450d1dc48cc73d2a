"""End-to-end serving driver on the PyTorch port (the paper's deployment
scenario; the counterpart of `examples/rag_serve.py`): a served LM
handles concurrent requests — each request embeds a query, the query-aware
router picks the filtered-ANN method + parameter setting, the engine
retrieves, and the LM generates conditioned on the retrieved ids.

Requests are served through `AsyncBatchQueue`: every request `submit()`s
its single query independently (as concurrent callers would) and the
queue coalesces them into routed micro-batches. `--shards N` swaps the
single `FilteredIndex` for a row-sharded `ShardedFilteredIndex` +
`ShardedRouterService`. `--live` serves a `LiveFilteredIndex`
(`ShardedLiveIndex` with shards) instead and runs a writer thread that
streams upserts/deletes into the corpus *while* requests are in flight,
then compacts and serves one more round from the swapped base.

`--data-dir DIR` makes the corpus durable through `repro_torch.ann.store`:
the first run builds + trains as usual, then persists the corpus, the
router artifact, and every subsequent upsert/delete (write-ahead
logged) under DIR; later runs skip the offline stage entirely and
recover the index — including writes from previous sessions — plus the
version-stamped router from disk. Composes with `--live` and
`--shards N` (the store remembers the shard layout).

`--cache` fronts the service with a `SemanticResultCache`: every
`submit()` probes it before batching (exact-key hits bypass routing and
search entirely; near-duplicate embeddings serve re-scored semantic
hits), only misses flow through the routed pipeline, and the run
replays the request round to report hit/miss/eviction counters. With
`--live`, the concurrent writer's upserts/deletes evict exactly the
entries whose label sets they touch.

`--telemetry` attaches a `TelemetrySink` to the service: every routed
batch records per-query events (method, ps, predicate, latency share,
live generation) and the run prints counters + latency percentiles.
`--online-router` (implies `--telemetry`) additionally runs the
`OnlineRouterAdapter` between request rounds: reservoir-sampled
queries are replayed against the brute-force oracle on a pinned
snapshot, exact recall folds into an EWMA `OnlineBenchmarkTable`, and
if drift crosses the threshold the router retrains off the serving
path and promotes only after shadow-eval (with `--data-dir`, the
promoted artifact links into the store manifest atomically).

`--trace` attaches a `repro_torch.ann.trace.Tracer`: every request grows a
hierarchical span tree (queue wait -> batch assembly -> route ->
execute -> per-shard / live stages), the flight recorder keeps the
worst trees, and the run prints the slowest one and dumps Perfetto
JSON + the flight recorder under artifacts/serve/. `--metrics-port P`
serves Prometheus `/metrics` (sink counters, per-shard cells, span
histograms, cache/queue stats, ledger/SLO/obslog when attached),
`/healthz` (degrades to 503 on queue/WAL backpressure), `/statusz`,
`/debug/ledger` and `/debug/slo` for the run's duration.

`--slo` attaches an `SLOEngine` (implies `--trace` so alerts carry
flight-recorder trace ids): p99-latency, audited-recall-floor and
availability objectives evaluated with multi-window burn-rate
alerting; audit reports from `--online-router` feed the recall
objective. `--obslog` attaches a `WideEventLog`: one JSONL wide event
per request (trace id, route decision, cache provenance, shard
timings, live generation, SLO state) under artifacts/serve/, plus a
post-mortem dumper on SIGUSR2/exit writing flight + ledger + SLO
state. The resource ledger (snapshot pins, retired generations, WAL
backlog, queue depth, cache/delta bytes) is always on — both flags
print its summary at shutdown.

Everything runs on one torch device, the card unless `--device cpu`
asks for the CPU: the corpus's handles, the router's fits and the LM
(`get_smoke_config(--arch)` at random init from seed 0, its embeddings
the first `dim` prefill logits, as in the JAX package's example).

    PYTHONPATH=src python examples/torch_rag_serve.py [--requests 32] \
        [--shards 2] [--live] [--data-dir /tmp/rag-store] \
        [--cache] [--telemetry] [--online-router] \
        [--trace] [--metrics-port 9100] [--slo] [--obslog] \
        [--device cuda]
"""

import argparse
import os
import threading
import time

import numpy as np
import torch

from repro_torch.ann.index import FilteredIndex
from repro_torch.ann.live import LiveFilteredIndex, ShardedLiveIndex
from repro_torch.ann.predicates import Predicate
from repro_torch.ann.service import (AsyncBatchQueue, RouterService,
                                     ShardedRouterService)
from repro_torch.ann.sharded import ShardedFilteredIndex
from repro_torch.ann.store import MANIFEST, IndexStore
from repro_torch.ann import labels as lb
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import training as T
from repro_torch.data.ann_synth import DatasetSpec, synthesize
from repro_torch.launch.serve import generate
from repro_torch.models import common, lm


def _sync(device) -> None:
    """Wait for the card's queued work before a host clock is read."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _open_or_create_store(args, sink=None, tracer=None, slo=None,
                          obslog=None):
    """Recover (or initialise) the durable corpus + router.

    Returns (store, router, service). A recovered store restores the
    live handle — base segment memmap + WAL replay — and the linked,
    version-stamped router artifact; a fresh directory runs the offline
    stage once and persists everything for the next session.
    """
    if os.path.exists(os.path.join(args.data_dir, MANIFEST)):
        store = IndexStore.open(args.data_dir, device=args.device)
        router = store.load_router()
        lfx = store.index
        st = store.stats()
        print(f"restored store: generation {st['index']['generation']}, "
              f"{st['index']['n_live']} live rows, "
              f"{st['replayed_records']} WAL record(s) replayed")
        if isinstance(lfx, ShardedLiveIndex) and lfx.n_shards != \
                args.shards and args.shards > 1:
            print(f"  (store layout wins: {lfx.n_shards} shard(s), "
                  f"ignoring --shards {args.shards})")
    else:
        ds = synthesize(
            DatasetSpec("corpus", 4000, 32, 48, 8, 12, 1.3, 2.0, 0.5,
                        0.3, 7))
        with FilteredIndex(ds, device=args.device) as fx:
            coll = T.collect({"corpus": fx}, n_queries=60, seed=0,
                             verbose=False, device=args.device)
            router = T.train_router(coll, coll.table, epochs=80,
                                    device=args.device)
        os.makedirs(args.data_dir, exist_ok=True)
        router_dir = os.path.join(args.data_dir, "router")
        router.save(router_dir)
        store = IndexStore.create(args.data_dir, ds,
                                  n_shards=args.shards,
                                  router_dir=router_dir,
                                  device=args.device)
        lfx = store.index
        print(f"created store at {args.data_dir}: {ds.n} vectors, "
              f"router artifact linked")
    svc = (ShardedRouterService(lfx, router, t=0.9, telemetry=sink,
                                tracer=tracer, slo=slo, obslog=obslog)
           if isinstance(lfx, ShardedLiveIndex)
           else RouterService(lfx, router, t=0.9, telemetry=sink,
                              tracer=tracer, slo=slo, obslog=obslog))
    return store, router, svc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shards", type=int, default=1,
                    help="row shards for the corpus (1 = single index)")
    ap.add_argument("--live", action="store_true",
                    help="serve a live index with a concurrent writer "
                         "thread (streaming upserts/deletes + compaction)")
    ap.add_argument("--data-dir", default=None,
                    help="durable IndexStore directory: restore the "
                         "corpus + router from it on startup (skipping "
                         "the offline stage), persist all writes to it, "
                         "checkpoint on shutdown")
    ap.add_argument("--cache", action="store_true",
                    help="front the service with a SemanticResultCache "
                         "(exact-key + cosine-threshold hits bypass "
                         "routing and search; label-clock invalidation "
                         "under --live) and replay the round to show "
                         "hit/miss/eviction counters")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach a TelemetrySink: per-query events, "
                         "counters, latency percentiles, audit reservoir")
    ap.add_argument("--online-router", action="store_true",
                    help="run the OnlineRouterAdapter (implies "
                         "--telemetry): sampled exact-recall audits fold "
                         "into an EWMA table; drift triggers background "
                         "retrain + shadow-eval + atomic artifact swap")
    ap.add_argument("--trace", action="store_true",
                    help="attach a Tracer: hierarchical spans across "
                         "route/execute/queue/cache/live stages with "
                         "tail-based sampling; prints the slowest span "
                         "tree and dumps Perfetto JSON + the flight "
                         "recorder under artifacts/serve/")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics and /healthz on this "
                         "port (0 = auto-pick) for the duration of the "
                         "run; composes with --telemetry/--trace/--cache")
    ap.add_argument("--slo", action="store_true",
                    help="attach an SLOEngine (implies --trace): p99 "
                         "latency / audited-recall / availability "
                         "objectives with multi-window burn-rate "
                         "alerting; alerts carry trace ids + table "
                         "version")
    ap.add_argument("--obslog", action="store_true",
                    help="write one JSONL wide event per request "
                         "(trace id, route, cache, timings, SLO state) "
                         "under artifacts/serve/, and install the "
                         "SIGUSR2/atexit post-mortem dumper")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the corpus, the router's fits "
                         "and the LM (the card by default)")
    args = ap.parse_args()
    if args.online_router:
        args.telemetry = True
    if args.slo:
        args.trace = True        # alerts want flight-recorder trace ids
    rng = np.random.default_rng(0)

    # --- corpus + router (offline stage, or store recovery) ---
    from repro_torch.ann.telemetry import OnlineRouterAdapter, TelemetrySink
    sink = (TelemetrySink(capacity=4096, reservoir=128, seed=11)
            if args.telemetry else None)
    tracer = None
    if args.trace:
        from repro_torch.ann.trace import Tracer
        # slow_ms=0: keep everything in this short demo run so the
        # flight recorder and Perfetto dump are never empty
        tracer = Tracer(slow_ms=0.0, sample=1.0, flight_capacity=32,
                        seed=11)
    slo_eng = None
    if args.slo:
        from repro_torch.ann.slo import Objective, SLOEngine
        # demo-scale alert windows (seconds, not hours) so a single
        # short run exercises the full observe -> burn -> alert path
        slo_eng = SLOEngine(
            [Objective(name="latency_p99", kind="latency", target=0.99,
                       threshold_us=50_000.0,
                       description="<=1% of queries slower than 50 ms"),
             Objective(name="recall_floor", kind="recall", target=0.90,
                       floor=0.80,
                       description="<=10% of audited samples below 0.80"),
             Objective(name="availability", kind="availability",
                       target=0.999)],
            windows=((60.0, 5.0, 2.0),), min_events=8, tracer=tracer)
    obslog = None
    if args.obslog:
        from repro_torch.ann.obslog import WideEventLog
        from repro_torch.common import artifacts_dir
        obslog = WideEventLog(os.path.join(artifacts_dir("serve"),
                                           "wide_events.jsonl"))
    store = None
    if args.data_dir:
        store, router, svc = _open_or_create_store(args, sink, tracer,
                                                   slo_eng, obslog)
        ds = svc.index.ds        # the recovered sealed base
    else:
        spec = DatasetSpec("corpus", 4000, 32, 48, 8, 12, 1.3, 2.0, 0.5,
                           0.3, 7)
        ds = synthesize(spec)
        fx = FilteredIndex(ds, device=args.device)
        coll = T.collect({"corpus": fx}, n_queries=60, seed=0,
                         verbose=False, device=args.device)
        router = T.train_router(coll, coll.table, epochs=80,
                                device=args.device)
        if args.live:
            fx.close()           # the live handle owns its own tensors
            lfx = (ShardedLiveIndex(ds, args.shards, device=args.device)
                   if args.shards > 1
                   else LiveFilteredIndex(ds, device=args.device))
            svc = (ShardedRouterService(lfx, router, t=0.9, telemetry=sink,
                                        tracer=tracer, slo=slo_eng,
                                        obslog=obslog)
                   if args.shards > 1
                   else RouterService(lfx, router, t=0.9, telemetry=sink,
                                      tracer=tracer, slo=slo_eng,
                                      obslog=obslog))
        elif args.shards > 1:
            fx.close()           # collect() is done; shards own their tensors
            sfx = ShardedFilteredIndex(ds, args.shards, device=args.device)
            svc = ShardedRouterService(sfx, router, t=0.9, telemetry=sink,
                                       tracer=tracer, slo=slo_eng,
                                       obslog=obslog)
        else:
            svc = RouterService(fx, router, t=0.9, telemetry=sink,
                                tracer=tracer, slo=slo_eng, obslog=obslog)
    serving = svc
    if args.cache:
        from repro_torch.ann.cache import SemanticResultCache
        serving = SemanticResultCache(svc, threshold=0.98, capacity=2048)
    from repro_torch.ann.ledger import get_ledger
    postmortem = None
    if args.obslog:
        from repro_torch.ann.obslog import install_postmortem
        postmortem = install_postmortem(tracer=tracer, ledger=get_ledger(),
                                        slo=slo_eng, obslog=obslog)
        print(f"obslog: wide events -> {obslog.path} "
              f"(post-mortem on SIGUSR2/exit)")
    metrics_srv = None
    if args.metrics_port is not None:
        from repro_torch.ann.metrics import (MetricsServer,
                                             backpressure_health,
                                             metrics_text)
        cache_obj = serving if args.cache else None
        # service=svc late-binds the router's table: once the online
        # adapter swaps in its OnlineBenchmarkTable, scrapes pick up
        # the shard-keyed EWMA cells without rebuilding the closure
        metrics_srv = MetricsServer(
            lambda: metrics_text(sink=sink, tracer=tracer,
                                 cache=cache_obj, ledger=get_ledger(),
                                 slo=slo_eng, obslog=obslog,
                                 service=svc),
            port=args.metrics_port,
            health=backpressure_health(
                wal=getattr(store, "_wal", None)),
            ledger=get_ledger(), slo=slo_eng, obslog=obslog)
        print(f"metrics: {metrics_srv.url}/metrics + /healthz + "
              f"/statusz + /debug/ledger + /debug/slo")
    print(f"corpus: {ds.n} vectors ({args.shards} shard(s), "
          f"live={args.live}, durable={bool(args.data_dir)}, "
          f"cache={args.cache}); router "
          f"ready ({len(router.table.entries)} table entries)")

    # --- served LM (reduced config; embeddings from its hidden states) ---
    cfg = get_smoke_config(args.arch)
    params = common.init_params(lm.model_desc(cfg), seed=0,
                                device=args.device)
    ctx = lm.ModelCtx(qc_prefill=32, gla_chunk=32)
    embed_fn = lambda p, b: lm.forward_prefill(p, b, cfg, ctx)

    # --- batched requests: prompt tokens + label predicate ---
    b = args.requests
    prompts = rng.integers(1, 400, size=(b, 32))
    preds = [Predicate(int(p)) for p in rng.integers(0, 3, size=b)]
    qbms = np.zeros((b, ds.bitmaps.shape[1]), np.uint32)
    for i in range(b):
        src = sorted(lb.unpack_one(ds.bitmaps[rng.integers(0, ds.n)]))
        take = src[: 1 + int(preds[i] == Predicate.OR)]
        qbms[i] = lb.pack_one(take, ds.universe)

    t0 = time.perf_counter()
    logits, _ = embed_fn(params, {"tokens": torch.from_numpy(prompts).to(
        params["embed"].device)})
    emb = logits[:, 0, : ds.dim].float().cpu().numpy()     # query embeddings
    t_embed = time.perf_counter() - t0

    # --- route + retrieve through the async micro-batch queue: each
    # request submits independently (concurrent callers), the queue
    # coalesces them into routed batches. With --live a writer thread
    # streams upserts/deletes into the corpus while requests fly ---
    writer_stats = {"upserts": 0, "deletes": 0}
    stop_writer = threading.Event()
    # cap the stream below one delta mirror chunk: the first routed batch
    # pays one delta-kernel compile and every later search reuses it (an
    # unbounded writer would grow the delta mid-compile and force a
    # recompile at every chunk crossing)
    writer_budget = 400

    def writer():
        wrng = np.random.default_rng(42)
        while not stop_writer.is_set() and \
                writer_stats["upserts"] < writer_budget:
            src = wrng.integers(0, ds.n, size=8)
            ids = svc.index.upsert(
                ds.vectors[src] + wrng.normal(
                    scale=0.01, size=(8, ds.dim)).astype(np.float32),
                ds.bitmaps[src])
            writer_stats["upserts"] += len(ids)
            if writer_stats["upserts"] % 32 == 0:
                svc.index.delete(ids[:2])
                writer_stats["deletes"] += 2
            time.sleep(0.01)

    t0 = time.perf_counter()
    retrieved = np.full((b, 5), -1, np.int32)
    wt = None
    if args.live:
        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
    replay_tags: list = []
    with AsyncBatchQueue(serving, max_batch=16, max_wait_ms=20.0) as queue:
        futs = [queue.submit(emb[i], qbms[i], preds[i], k=5)
                for i in range(b)]
        for i, f in enumerate(futs):
            retrieved[i] = f.result(timeout=300).ids
        if args.cache:
            # replay the round — repeat traffic is the cache's case;
            # hits resolve at submit, before the queue ever batches
            rfuts = [queue.submit(emb[i], qbms[i], preds[i], k=5)
                     for i in range(b)]
            replay_tags = [f.result(timeout=300).cache for f in rfuts]
        qstats = queue.stats()
    if wt is not None:
        stop_writer.set()
        wt.join(timeout=30)
    t_retrieve = time.perf_counter() - t0
    print(f"queue: {qstats['batches']} micro-batches for "
          f"{qstats['queries']} requests "
          f"(largest {qstats['max_batch_seen']}, depth "
          f"{qstats['max_queue_depth']}, "
          f"flushes {qstats['flush_reasons']})")
    if args.cache:
        cs = serving.stats()
        print(f"cache: replay served "
              f"{sum(t is not None for t in replay_tags)}/{b} from cache "
              f"({qstats['cache_hits']} at submit; exact "
              f"{cs['hits_exact']}, semantic {cs['hits_semantic']}, "
              f"misses {cs['misses']}, hit_rate {cs['hit_rate']}, "
              f"evictions ttl/stale/cap {cs['evictions_ttl']}/"
              f"{cs['evictions_stale']}/{cs['evictions_capacity']})")
    if sink is not None:
        ts = sink.stats()
        print(f"telemetry: {ts['queries']} events, p50 "
              f"{ts['latency_us']['p50']:.0f} us, p99 "
              f"{ts['latency_us']['p99']:.0f} us, by_method "
              f"{ts['by_method']}, reservoir {ts['reservoir']['size']}")
    if args.online_router:
        adapter = OnlineRouterAdapter(svc, sink, store=store,
                                      drift_threshold=0.05,
                                      min_samples=16, retrain_epochs=40,
                                      seed=3, slo=slo_eng)
        rep = adapter.step()
        print(f"adapter: audited {rep['samples']} sampled queries, "
              f"max_drift {rep['max_drift']:.3f}, table v"
              f"{rep['table_version']}, retrained={rep['retrained']}, "
              f"promoted={rep['promoted']}"
              + (f", artifact {rep['artifact']}" if "artifact" in rep
                 else ""))
    if args.live:
        st = svc.index.stats()
        print(f"live writer: {writer_stats['upserts']} upserts, "
              f"{writer_stats['deletes']} deletes concurrent with "
              f"serving (delta={st['delta_rows']} rows, "
              f"n_live={st['n_live']})")
        # with a store, compaction commits the new generation through
        # the manifest before the old segment is retired
        gen = store.compact() if store is not None else svc.index.compact()
        st = svc.index.stats()
        print(f"compacted -> generation {gen}: base_n={st['base_n']}, "
              f"delta_rows={st['delta_rows']}")
        # one more request round from the freshly swapped base
        with AsyncBatchQueue(serving, max_batch=16,
                             max_wait_ms=20.0) as queue:
            futs = [queue.submit(emb[i], qbms[i], preds[i], k=5)
                    for i in range(min(b, 8))]
            for i, f in enumerate(futs):
                retrieved[i] = f.result(timeout=300).ids
        print("post-compact serving OK")

    # --- generate conditioned on retrieval (ids appended as tokens) ---
    t0 = time.perf_counter()
    aug = [list(prompts[i]) +
           [int(x) % cfg.vocab for x in retrieved[i] if x >= 0][:4]
           for i in range(b)]
    width = max(len(a) for a in aug)
    aug = [a + [0] * (width - len(a)) for a in aug]
    out = generate(params, cfg, aug, max_new=8, ctx=ctx)
    _sync(args.device)
    t_gen = time.perf_counter() - t0

    print(f"served {b} requests: embed {t_embed*1e3:.0f} ms, "
          f"route+retrieve {t_retrieve*1e3:.0f} ms "
          f"({t_retrieve/b*1e6:.0f} us/req), generate {t_gen*1e3:.0f} ms")
    print("sample generations:", out[:2].tolist())
    hit = (retrieved >= 0).any(1).mean()
    print(f"retrieval hit rate: {hit:.2f}")
    if tracer is not None:
        from repro_torch.common import artifacts_dir
        ts = tracer.stats()
        flight = tracer.flight()
        out_dir = artifacts_dir("serve")
        tracer.dump_flight_json(os.path.join(out_dir, "flight.json"))
        with open(os.path.join(out_dir, "trace_perfetto.json"), "w") as f:
            f.write(tracer.perfetto_json())
        print(f"trace: {ts['traces']} traces ({ts['kept']} kept, "
              f"{ts['slow']} slow, {ts['errors']} errored); flight + "
              f"Perfetto JSON -> {out_dir}")
        if flight:
            worst = max(flight, key=lambda r: r["duration_ms"])
            root = worst["root"]
            print(f"  slowest: {root.name} {worst['duration_ms']:.1f} ms "
                  f"[{worst['reason']}] {worst['annotations']}")
            for child in root.children:
                print(f"    {child.name}: {child.duration_s*1e3:.1f} ms "
                      f"{child.attrs}")
    if slo_eng is not None:
        slo_eng.evaluate()
        alerts = slo_eng.alerts()
        print(f"slo: state {slo_eng.state()}, "
              f"{slo_eng.stats()['evaluations']} evaluation(s), "
              f"{len(alerts)} alert(s)")
        for a in alerts[-2:]:
            print(f"  alert {a.objective} burn {a.burn_long:.1f}x "
                  f"(window {a.window[0]:.0f}s/{a.window[1]:.0f}s), "
                  f"{len(a.trace_ids)} trace id(s), "
                  f"provenance {a.provenance}")
    if obslog is not None:
        obslog.flush()
        os_ = obslog.stats()
        print(f"obslog: {os_['emitted']} wide events emitted, "
              f"{os_['written']} written, {os_['dropped']} dropped, "
              f"{os_['file_bytes']} bytes -> {os_['path']}")
    if args.slo or args.obslog:
        snap = get_ledger().snapshot()
        held = {k: sum(o["leases"] for o in v.values())
                for k, v in snap["held"].items()}
        print(f"ledger: held {held or '{}'}, "
              f"{len(snap['gauges'])} collector(s), "
              f"{len(snap['leaks'])} leak(s) past "
              f"{get_ledger().leak_age_s:.0f}s")
    if metrics_srv is not None:
        import urllib.request
        n_lines = len(urllib.request.urlopen(
            metrics_srv.url + "/metrics", timeout=5).read().splitlines())
        print(f"metrics: final scrape {n_lines} exposition lines")
        metrics_srv.close()
    if args.cache:
        serving.close()          # drop entries; the service stays open
    if store is not None:
        store.checkpoint()       # fold this session's WAL into a segment
        st = store.stats()
        print(f"persisted store generation {st['store_generation']} at "
              f"{st['path']} (segment {st['segment']}) — rerun with the "
              f"same --data-dir to restore")
        store.close()
    else:
        svc.index.close()
    if obslog is not None:
        obslog.close()           # the atexit post-mortem still reads stats


if __name__ == "__main__":
    main()
