"""The port's dry run (`launch/dryrun.py`) against the JAX package's on
the cells they share. The reference's `run_cell` runs in one subprocess
(its module forces 512 host devices at import; `REPRO_ARTIFACTS` points
at the test's directory, so nothing under `artifacts/` is read or
written), the port's cells in this process, each under its own fake
process group:

  * decode_32k on 16×16 for qwen2-0.5b, xlstm-125m, hymba-1.5b and
    whisper-medium, and qwen2-0.5b's on 2×16×16: `argument_size_in_bytes`
    equal; per-rank dot FLOPs within FLOPS_RTOL, or, where the gap is
    larger, at the ratio PINNED (PERF.md §6 names the product behind
    each gap) within PIN_RTOL; the collective bytes by kind
    reported beside the reference's, not held (the port's partitioning
    is its own: DTensor redistributions where XLA's partitioner chooses);
  * the skip matrix: internlm2-20b long_500k is skipped through the CLI
    with the reference's reason, which names attention.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun as DR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("qwen2-0.5b", False), ("xlstm-125m", False),
         ("hymba-1.5b", False), ("whisper-medium", False),
         ("qwen2-0.5b", True)]
FLOPS_RTOL = 0.02
PIN_RTOL = 0.01
# the port's per-rank dot FLOPs over the reference's where they part by
# more than 2%: qwen2-0.5b attends over the whole gathered cache with
# every head on every rank (XLA keeps the sequence sharded); xlstm-125m's
# 4 heads do not divide "model" = 16, so every rank runs every head's
# recurrence (XLA shards the head dimension)
PINNED = {"qwen2-0.5b": 12.107, "xlstm-125m": 1.6104}
TIMEOUT_S = 600

REF_SCRIPT = """
import json, sys
from repro.launch import dryrun as D
cells = json.loads(sys.argv[1])
out = [D.run_cell(a, s, m) for a, s, m in cells]
json.dump(out, open(sys.argv[2], "w"))
"""


def _env(tmp):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", REPRO_ARTIFACTS=str(tmp))
    return env


def _key(arch, shape, multi_pod):
    return (arch, shape, "2x16x16" if multi_pod else "16x16")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{(arch, shape, mesh): (the reference's result, the port's)}: the
    reference's subprocess runs while the port counts its cells."""
    tmp = tmp_path_factory.mktemp("dryrun")
    want = [(a, "decode_32k", m) for a, m in CELLS] + \
        [("internlm2-20b", "long_500k", False)]
    out = os.path.join(tmp, "ref.json")
    log = open(os.path.join(tmp, "ref.log"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(want), out], cwd=ROOT,
                            env=_env(tmp), stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
        port = {_key(*c): DR.run_cell(*c, device="cpu") for c in want}
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log.seek(0)
    assert proc.returncode == 0, log.read()[-4000:]
    log.close()
    with open(out) as f:
        ref = {_key(r["arch"], r["shape"], r["mesh"] == "2x16x16"): r
               for r in json.load(f)}
    return {k: (ref[k], port[k]) for k in port}


@pytest.mark.parametrize("arch,multi_pod", CELLS)
def test_argument_bytes_equal(cells, arch, multi_pod):
    ref, port = cells[_key(arch, "decode_32k", multi_pod)]
    assert ref["status"] == port["status"] == "ok", (ref, port)
    assert port["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,multi_pod", CELLS)
def test_dot_flops_within_2pct_or_pinned(cells, arch, multi_pod):
    ref, port = cells[_key(arch, "decode_32k", multi_pod)]
    ratio = port["dot_flops"] / ref["hlo_dot_flops"]
    print(f"{arch} decode_32k {port['mesh']}: port {port['dot_flops']} "
          f"reference {ref['hlo_dot_flops']:.0f} ratio {ratio:.5f}")
    if arch in PINNED:
        assert ratio == pytest.approx(PINNED[arch], rel=PIN_RTOL)
    else:
        assert ratio == pytest.approx(1.0, rel=FLOPS_RTOL)


@pytest.mark.parametrize("arch,multi_pod", CELLS)
def test_collective_kinds_reported(cells, arch, multi_pod):
    ref, port = cells[_key(arch, "decode_32k", multi_pod)]
    kinds = port["collective_by_kind"]
    print(f"{arch} decode_32k {port['mesh']} collective bytes by kind: "
          f"port {kinds} reference {ref['collective_by_kind']}")
    assert set(kinds) == {"all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"}
    assert set(ref["collective_by_kind"]) <= set(kinds)
    assert all(v >= 0 for v in kinds.values())
    assert sum(kinds.values()) == port["collective_bytes"] > 0


def test_skip_matrix_through_the_cli(cells, tmp_path):
    ref, _ = cells[_key("internlm2-20b", "long_500k", False)]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-20b", "--shape", "long_500k", "--mesh", "pod",
         "--device", "cpu"], cwd=ROOT, env=_env(tmp_path),
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "DRY-RUN SUMMARY: ok=0 skipped=1 errors=0" in res.stdout
    with open(os.path.join(tmp_path, "dryrun_torch",
                           "internlm2-20b_long_500k_16x16.json")) as f:
        got = json.load(f)
    assert got["status"] == ref["status"] == "skipped"
    assert "attention" in got["reason"]
    assert got["reason"] == ref["reason"]
