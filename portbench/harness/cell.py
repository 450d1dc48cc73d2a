"""One run of one cell: set-up, the measured window, the comparison, the
metrics.

A cell (an entry of `workloads` in BENCHMARK.json) names a
configuration (`portbench/configs/<config>.json`, its file given in
BENCHMARK.json) and a traffic mix (`portbench/traffic/<mix>.json`). The
mix names its entry (`portbench/entries/<entry>.py`), the limits of the
comparison are `portbench/limits/<cell>.json`, and each metric is read
by `portbench/metrics/<metric>.py`. All are found by name, under the
checkout the cell was loaded from; nothing here names one of them.

An entry module has `setup(ctx)`, which builds what the cell serves and
returns an object with:

* `warm(pred, qv, qb)`: serve one warm-up batch (and whatever else the
  shapes of this cell's traffic need);
* `serve(i, pred, qv, qb)`: serve window batch `i`, return its
  `SearchResult`-like timings dict, keeping what the comparison needs;
* `attach_tracer(tracer)`: serve under the program's tracer;
* `probes`: names of the kernel ops (`repro_torch.kernels.ops.<op>`)
  whose calls the comparison needs; `listen(probe)` gets each probe;
* `close()`: free every device tensor the program holds;
* `judge(ref, pool, seed, limits)`: the numbers compared and
  {"recall": mean recall or None, "failed": queries answered wrongly}.

An entry module also has `control(ctl)`: the numbers its comparison
gives when the reference takes the program's place (`harness/control.py`).

A metric module has `UNIT` and `read(run)`. A metric read from an op's
calls also has `OP` (the op to probe), `record(args, kwargs, out)` (what
it keeps of each call in the profiled stretch) and
`least_seconds(records, peaks)`; `run.least_s[<metric>]` is what that
gives.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.harness import gen, judge as judge_mod, profiling
from portbench.harness.peaks import peaks_for
from portbench.harness.probes import Probes

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    root: str


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    wl = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(_file(root, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(_file(root, "limits", name + ".json")) as f:
        limits = json.load(f)["limits"]

    def names(metrics):
        return [m["name"] for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(name=name, config_name=wl["config"], config=config,
                traffic=traffic,
                chips=int(wl["chips"]), end_to_end=names(bench["end_to_end"]),
                per_layer=names(bench["per_layer"]), limits=limits,
                root=root)


def _file(root: str, kind: str, name: str) -> str:
    return os.path.join(root, os.path.basename(PB), kind, name)


def load_module(kind: str, name: str, root: str = ROOT):
    """`portbench/<kind>/<name>.py` of the checkout `root` as a module
    (any name of BENCHMARK.json's characters)."""
    path = _file(root, kind, name + ".py")
    mod_name = "portbench._{}_{}".format(
        kind, "".join(c if c.isalnum() else "_" for c in name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What an entry's set-up gets: the cell, the device, and the drawn
    rows on the host (float32 vectors, uint32 bitmaps)."""
    cell: Cell
    device: torch.device
    vectors: np.ndarray
    bitmaps: np.ndarray
    spec: gen.DataSpec


@dataclasses.dataclass
class Inputs:
    """What a run of the cell draws: the deployment's rows on the host,
    the window's query pool and the warm-up's."""
    spec: gen.DataSpec
    vectors: np.ndarray
    bitmaps: np.ndarray
    pool: gen.QueryPool
    warm: gen.QueryPool


def inputs(cell: Cell, seed: int, dev: torch.device,
           n_batches: int | None = None, phase=lambda name: None
           ) -> Inputs:
    """The cell's inputs: one deployment, the same rows in the same
    order for every run, drawn from the configuration's own `data.seed`;
    `seed` draws the queries. The served order decides what the program
    builds and estimates (its k-means samples, the sample rows of its
    `lid_mean` feature): rows in a seed's order moved the router's
    choices, and so the work, by a quarter from seed to seed. The pool
    draws `n_batches` batches ahead (by default the mix's `pool_mb`);
    later batches are drawn from host copies of the rows, the same
    queries."""
    tr = cell.traffic
    spec = gen.DataSpec.from_config(cell.config)
    preds, batch = tr["predicates"], int(tr["batch"])
    data = gen.make_data(spec, int(cell.config["data"]["seed"]), dev)
    phase("data")
    vectors = data.vectors.cpu().numpy()
    bitmaps = data.bitmaps.cpu().numpy().view(np.uint32)
    pool = gen.QueryPool(data, seed, "window", batch, preds)
    if n_batches is None:
        per_batch = batch * (spec.dim + spec.words) * 4
        n_batches = max(len(preds),
                        int(tr["pool_mb"]) * 2 ** 20 // per_batch)
    pool.prepare(n_batches)
    warm = gen.QueryPool(data, seed, "warm", batch, preds, chunk=len(preds))
    warm.prepare(len(preds))
    phase("queries")
    pool.keep_host_rows(vectors, bitmaps)
    data.vectors = data.bitmaps = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Inputs(spec, vectors, bitmaps, pool, warm)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float
    latencies_s: list
    batch_queries: list
    timings: list              # per batch, unprofiled batches in a traced run
    spans: list | None         # tracer roots of the unprofiled batches
    profile: profiling.DeviceProfile | None
    least_s: dict              # metric -> its `least_seconds` of the
                               # profiled calls
    recall: float | None
    device_name: str
    power_limit: str | None


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mean_ms(xs: list) -> float | None:
    return 1e3 * sum(xs) / len(xs) if xs else None


def _recorder(mod, records: list, on: list):
    """A listener keeping `mod.record` of each call while `on[0]`."""
    def listen(args, kwargs, out):
        if on[0]:
            records.append(mod.record(args, kwargs, out))
    return listen


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> tuple[dict, dict, bool]:
    """One run. Returns (the result line's dict without `checks`, the
    checks, correct)."""
    dev = torch.device(device)
    tr = cell.traffic
    preds = tr["predicates"]

    # ---- set-up: data, queries, the program, warm-up --------------------
    phases = {}

    def phase(name):
        _sync(dev)
        phases[name] = time.perf_counter() - t_start

    phase("start")
    inp = inputs(cell, seed, dev, phase=phase)
    pool, warm, vectors, bitmaps = inp.pool, inp.warm, inp.vectors, \
        inp.bitmaps

    entry = load_module("entries", tr["entry"], cell.root)
    served = entry.setup(Context(cell, dev, vectors, bitmaps, inp.spec))
    phase("program")
    from repro_torch.ann import trace as trace_mod
    from repro_torch.kernels import ops as ops_mod

    # the per-layer metrics read from an op's calls: their op is probed,
    # and what each keeps of a call is recorded in the profiled stretch
    recorders = {}               # metric -> (module, records)
    if trace:
        for name in cell.per_layer:
            mod = load_module("metrics", name, cell.root)
            if hasattr(mod, "OP"):
                recorders[name] = (mod, [])
    ops = list(dict.fromkeys(list(served.probes) + [
        mod.OP for mod, _ in recorders.values()]))
    probes = Probes(ops_mod, ops, trace_mod if trace else None)
    recording = [False]
    for op in served.probes:
        served.listen(probes.ops[op])
    for mod, records in recorders.values():
        probes.ops[mod.OP].listeners.append(
            _recorder(mod, records, recording))
    tracer = None
    if trace:
        tracer = trace_mod.Tracer(sample=1.0, recent_capacity=1 << 20)
        served.attach_tracer(tracer)
    for i in range(len(preds)):
        served.warm(*warm.get(i))
    phase("warm")
    if trace and dev.type == "cuda":
        # the profiler's first start in a process sets up CUPTI, which
        # takes seconds: done here, not in the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p0:
            torch.ones(1, device=dev).add_(1)
            _sync(dev)
        p0.events()
        phase("profiler")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window -------------------------------------------------------
    lat, nq, timings = [], [], []
    prof, prof_from, n_roots, win = None, None, None, None
    profile_s = min(float(tr["profile_s"]), seconds / 3.0)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if trace and prof is None and now - t0 >= seconds - profile_s:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(dev)
            prof = profile(activities=acts)
            prof.__enter__()
            from torch.autograd.profiler import record_function
            win = record_function(profiling.WINDOW_RANGE)
            win.__enter__()
            probes.set_ranges(True)
            recording[0] = True
            prof_from = i
            n_roots = len(tracer.recent())
        pred, qv, qb = pool.get(i)
        ts = time.perf_counter()
        timing = served.serve(i, pred, qv, qb)
        lat.append(time.perf_counter() - ts)
        nq.append(qv.shape[0])
        timings.append(timing)
        i += 1
    window_s = time.perf_counter() - t0
    if prof is not None:
        _sync(dev)
        recording[0] = False
        probes.set_ranges(False)
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    _sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    spans = None
    if tracer is not None:
        roots = tracer.recent()
        spans = roots[:n_roots] if n_roots is not None else roots
    probes.close()
    served.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the trace, the comparison, the metrics ---------------------------
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    profile, least = None, {}
    if prof is not None:
        profile = profiling.from_profiler(prof, probes.range_names())
        peaks = peaks_for(device_name)
        for name, (mod, records) in recorders.items():
            value = mod.least_seconds(records, peaks) if records else None
            if value is not None:
                least[name] = value
        del prof
    recorders.clear()
    t_ref = time.perf_counter()
    ref = judge_mod.Reference(vectors, bitmaps, dev)
    numbers, extras = served.judge(ref, pool, seed, cell.limits)
    del ref
    t_ref = time.perf_counter() - t_ref
    correct, checks = judge_mod.verdict(numbers, cell.limits)

    rec = RunRecord(
        cell=cell, setup_s=setup_s, window_s=window_s, latencies_s=lat,
        batch_queries=nq,
        timings=timings[:prof_from] if prof_from is not None else timings,
        spans=spans, profile=profile, least_s=least,
        recall=extras.get("recall"), device_name=device_name,
        power_limit=power_limit() if dev.type == "cuda" else None)
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module("metrics", name, cell.root)
        value = reader.read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(sum(nq)),
              "failed": int(extras.get("failed", 0)), "metrics": metrics,
              "device": device}
    if trace and profile is not None:
        device["busy_s"] = profile.busy_s
        device["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops,
                               "idle_gaps": profile.idle_gaps}
    if prof_from is not None:
        # what the profiler costs the host-paced batches: the mean batch
        # inside the profiled stretch beside those before it
        device["batch_ms_profiled"] = _mean_ms(lat[prof_from:])
        device["batch_ms_unprofiled"] = _mean_ms(lat[:prof_from])
    log(f"portbench: {cell.name} seed {seed}: {len(lat)} batches, "
        f"{sum(nq)} queries in {window_s:.3f} s, set-up {setup_s:.3f} s "
        f"(seconds since start: " + ", ".join(
            f"{k} {v:.2f}" for k, v in phases.items()) + f"), the "
        f"comparison {t_ref:.2f} s, late pool chunks {pool.drawn_late}, "
        f"card {rec.power_limit}"
        + (f", mean batch {device['batch_ms_unprofiled']:.3f} ms before "
           f"the profiled stretch, {device['batch_ms_profiled']:.3f} ms "
           f"in it" if prof_from is not None else "")
        + (f", decisions {extras['decisions']}" if "decisions" in extras
           else ""))
    return result, checks, correct


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's, flax's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
