"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, entry, limits and metric readers are there, found by name;
the names and keys keep to the benchmark's format; and a run of the
harness loads neither JAX nor the JAX package."""

import json
import os
import re
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_keep_their_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    from portbench.harness.cell import load_cell, load_module

    c = load_cell(ROOT, cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    assert os.path.isfile(os.path.join(ROOT, c.config["router"],
                                       "router.json"))
    assert os.path.isfile(os.path.join(ROOT, c.config["table_b"]))
    entry = load_module("entries", c.traffic["entry"])
    assert callable(entry.setup) and callable(entry.control)
    for name in c.end_to_end + c.per_layer:
        reader = load_module("metrics", name)
        assert callable(reader.read) and UNIT.match(reader.UNIT)
    assert all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert set(cfg["data"]) == {"n", "dim", "universe", "latent_dim",
                                "n_clusters", "zipf_a", "avg_labels",
                                "coupling", "noise", "seed"}


def test_run_refuses_without_a_card():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_a_run_loads_no_jax():
    """A whole run of each entry at a tiny size on the CPU, in a fresh
    process: the program loads, JAX and the JAX package do not."""
    code = r"""
import dataclasses, copy, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from portbench.harness import cell as C
for name in ("s192.exact", "s192.routed"):
    c = C.load_cell(sys.argv[1], name)
    cfg = copy.deepcopy(c.config); cfg["data"]["n"] = 1200
    tr = dict(c.traffic, batch=16, pool_mb=1, profile_s=0.2)
    c = dataclasses.replace(c, config=cfg, traffic=tr)
    C.run(c, 3, 0.3, False, "cpu", time.perf_counter(), log=lambda m: None)
print(sorted({m.split(".")[0] for m in sys.modules}))
print(C.forbidden_modules())
"""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top, found = out.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in eval(top)
    assert eval(found) == []
