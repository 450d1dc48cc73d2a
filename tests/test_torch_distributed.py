"""The port's mesh level against the JAX package's on the CPU: the same
mesh cases run by the reference in one subprocess on 4 forced host
devices (`tests/mesh_reference_jax.py`) and by the port on 4 `gloo`
ranks (`tests/mesh_ranks_torch.py`, four subprocesses meeting through a
FileStore under the test's directory), both started once for the module
and side by side, on the same inputs and weights (the reference's
`init_params`, carried across with `params_from_numpy`):

  * `make_sharded_search` on (2, 2) over "data" and on (pod, data, model)
    = (2, 2, 1) over ("pod", "data"), each predicate: the ids equal the
    reference's on the same shards (for the second, its 4 shards over a
    (4, 1) mesh: the reference's in_specs P("pod", "data") give a rank-1
    input two dimensions, which its shard_map refuses, ROADMAP.md queue 3
    item 4);
  * the internlm2-1.8b smoke train step, 2 steps on (2, 2) with
    accumulation 2, and 1 step with `opt_acts`: losses within LOSS_RTOL,
    grad norms within 10 GRAD_TOL, parameters after each step within the
    limits of `test_torch_train.py`'s `_hold_step` (1e-6 where the
    reference's first moment is firm, 2 lr (1 + wd |p|) + 1e-6 a step
    everywhere);
  * the same step with 8-bit moments, blocks whole on each rank and
    blocks spanning ranks: int8 moments within one step of the
    reference's, scales within 1e-3;
  * the elastic reshard of that state from (2, 2) to (1, 4), then a step;
  * `train_loop` on (2, 2) against one device (the same seed), and a
    run checkpointed on (2, 2) (rank 0 writes the full tensors) resumed
    on (1, 4);
  * grok-1 smoke (4 experts on tp = 2: expert-parallel) and the same with
    3 experts (tensor-parallel inside every expert), deepseek-v2 smoke
    (MLA + shared experts) on (2, 2): the loss and the aux loss of a
    forward, and a step;
  * internlm2 smoke decode with `opt_flash_decode` on (1, 4), where its 2
    kv heads do not divide tp = 4: prefill's and 3 decode steps' logits
    within fp32 tolerance, through the port's flash decode;
  * qwen2 smoke `generate` on (2, 2): the greedy tokens equal.

The recurrent and encoder-decoder families on a mesh are
`test_torch_mesh_families.py`'s.

Every array comes from seeded numpy generators of this file's own.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro.configs import base as jconfigs
from repro.data.ann_synth import DatasetSpec, make_queries, synthesize
from repro.models import common as JC
from repro.models import lm as JLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FP32_TOL = 1e-5
LR, WD = 3e-4, 0.01     # `default_opt_cfg`'s
TIMEOUT_S = 600

PLAN = {
    "train": {
        "dense": {"arch": "internlm2-1.8b", "mesh": [2, 2], "accum": 2,
                  "steps": 2, "batch": [8, 32]},
        "dense_acts": {"arch": "internlm2-1.8b", "mesh": [2, 2], "accum": 2,
                       "steps": 1, "batch": [8, 32], "opt_acts": True},
        "grok_ep": {"arch": "grok-1-314b", "mesh": [2, 2], "accum": 1,
                    "steps": 1, "batch": [4, 32], "forward": True},
        "grok_tp": {"arch": "grok-1-314b", "mesh": [2, 2], "accum": 1,
                    "steps": 1, "batch": [4, 32], "forward": True,
                    "cfg": {"n_experts": 3}},
        "deepseek": {"arch": "deepseek-v2-236b", "mesh": [2, 2], "accum": 1,
                     "steps": 1, "batch": [4, 32], "forward": True},
        # 8-bit moments: blocks of 16 whole on each rank, and blocks of a
        # whole row (256 does not tile the smoke widths) across ranks
        "compress_blocks": {"arch": "internlm2-1.8b", "mesh": [2, 2],
                            "accum": 1, "steps": 1, "batch": [4, 32],
                            "opt": {"compress": True, "block": 16}},
        "compress_rows": {"arch": "internlm2-1.8b", "mesh": [2, 2],
                          "accum": 1, "steps": 1, "batch": [4, 32],
                          "opt": {"compress": True, "block": 256}},
    },
    "reshard": {"from": "dense", "mesh": [1, 4], "batch": [8, 32]},
    "decode": {"arch": "internlm2-1.8b", "mesh": [1, 4], "prompt_len": 16,
               "steps": 3, "batch": 2, "s_max": 64},
    "generate": {"arch": "qwen2-0.5b", "mesh": [2, 2], "max_new": 6,
                 "batch": 4, "prompt_len": 12},
    "loop": {"arch": "qwen2-0.5b", "steps": 3, "batch": [8, 32],
             "save_every": 2, "accum": 2},
    "search": {"data": {"mesh": [2, 2], "data_axes": ["data"], "k": 10},
               "pod_data": {"mesh": [2, 2, 1], "data_axes": ["pod", "data"],
                            "k": 10, "ref_mesh": [4, 1],
                            "ref_data_axes": ["data"]}},
}


def _cfg(case):
    return dataclasses.replace(jconfigs.get_smoke_config(case["arch"]),
                               compute_dtype="float32",
                               **case.get("cfg", {}))


def _inputs(seed=0) -> dict:
    """The weights (the reference's init), batches, prompts and the
    search's dataset and queries, as flat numpy arrays."""
    rng = np.random.default_rng(seed)
    inp = {}

    def weights(name, case, key):
        leaves = jax.tree.leaves(JC.init_params(
            JLM.model_desc(_cfg(case)), jax.random.PRNGKey(key)))
        for i, a in enumerate(leaves):
            inp[f"{name}/p{i:04d}"] = np.asarray(a)

    def batch(key, cfg, b, s):
        toks = rng.integers(1, cfg.vocab, size=(b, s + 1)).astype(np.int32)
        inp[f"{key}/tokens"] = toks[:, :-1]
        inp[f"{key}/targets"] = toks[:, 1:].copy()
        inp[f"{key}/targets"][0, :3] = -1

    for i, (name, case) in enumerate(PLAN["train"].items()):
        weights(name, case, 10 + i)
        for s in range(case["steps"]):
            batch(f"{name}/b{s}", _cfg(case), *case["batch"])
    batch("reshard/b0", _cfg(PLAN["train"]["dense"]),
          *PLAN["reshard"]["batch"])
    d = PLAN["decode"]
    weights("decode", d, 20)
    toks = np.zeros((d["batch"], d["s_max"]), np.int32)
    toks[:, :d["prompt_len"]] = rng.integers(
        1, _cfg(d).vocab, size=(d["batch"], d["prompt_len"]))
    inp["decode/tokens"] = toks
    g = PLAN["generate"]
    weights("generate", g, 21)
    inp["generate/prompts"] = rng.integers(
        1, _cfg(g).vocab, size=(g["batch"], g["prompt_len"])).astype(np.int32)
    ds = synthesize(DatasetSpec("mesh", 1600, 24, 40, 6, 8, 1.3, 2.0, 0.5,
                                0.3, 7))
    inp["search/vectors"] = ds.vectors
    inp["search/norms"] = ds.norms_sq
    inp["search/bitmaps"] = ds.bitmaps
    for p in range(3):
        qs = make_queries(ds, p, 8, seed=5 + p)
        inp[f"search/q{p}"] = qs.vectors
        inp[f"search/b{p}"] = qs.bitmaps
    return inp


def _env(**extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def _finish(procs, what) -> None:
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p, log in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in procs:
        log.seek(0)
        assert p.returncode == 0, f"{what}: {log.read()[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's), each run once."""
    root = str(tmp_path_factory.mktemp("mesh"))
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump(PLAN, f)
    np.savez(os.path.join(root, "inputs.npz"), **_inputs())
    logs = []

    def start(args, env):
        log = open(os.path.join(root, f"log{len(logs)}.txt"), "w+")
        logs.append(log)
        return subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT), log

    try:
        ref = [start([os.path.join(TESTS, "mesh_reference_jax.py"), root],
                     _env(JAX_PLATFORMS="cpu"))]
        ranks = [start([os.path.join(TESTS, "mesh_ranks_torch.py"), root,
                        str(r)], _env()) for r in range(4)]
        _finish(ranks, "the port's ranks")
        _finish(ref, "the reference")
    finally:
        for log in logs:
            log.close()
    return (dict(np.load(os.path.join(root, "jax.npz"))),
            dict(np.load(os.path.join(root, "torch.npz"))))


def _leaves(res, prefix):
    keys = sorted(k for k in res if k.startswith(prefix + "/"))
    return [res[k] for k in keys]


@pytest.mark.parametrize("name", sorted(PLAN["search"]))
def test_sharded_search_ids(runs, name):
    ref, port = runs
    for p in range(3):
        got, want = port[f"search/{name}/{p}"], ref[f"search/{name}/{p}"]
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PLAN["train"]))
def test_train_steps(runs, name):
    ref, port = runs
    case = PLAN["train"][name]
    if "opt" in case:
        return _hold_compressed(ref, port, name)
    for s in range(case["steps"]):
        key = f"{name}/s{s}"
        np.testing.assert_allclose(port[key + "/loss"], ref[key + "/loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[key + "/grad_norm"],
                                   ref[key + "/grad_norm"],
                                   rtol=10 * GRAD_TOL)
        got, want = _leaves(port, key + "/params"), \
            _leaves(ref, key + "/params")
        mus = _leaves(ref, key + "/mu")
        assert len(got) == len(want) == len(mus) > 0
        for p, w, mu in zip(got, want, mus):
            err = np.abs(p - w)
            assert (err <= (s + 1) * (2 * LR * (1 + WD * np.abs(w)) + 1e-6)
                    ).all()
            mu = np.abs(mu)
            firm = mu > 1e-3 * max(mu.max(), 1e-30)
            np.testing.assert_allclose(p[firm], w[firm], rtol=0,
                                       atol=1e-6 * 10 ** s)


def _hold_compressed(ref, port, name):
    """A step with 8-bit moments: the loss, the grad norm, the parameters
    within a step's limit, each int8 moment within one of the
    reference's (a rounding tie) and each scale within 1e-3."""
    key = f"{name}/s0"
    np.testing.assert_allclose(port[key + "/loss"], ref[key + "/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port[key + "/grad_norm"],
                               ref[key + "/grad_norm"], rtol=10 * GRAD_TOL)
    for p, w in zip(_leaves(port, key + "/params"),
                    _leaves(ref, key + "/params")):
        assert (np.abs(p - w) <= 2 * LR * (1 + WD * np.abs(w)) + 1e-6).all()
    got, want = _leaves(port, key + "/mu"), _leaves(ref, key + "/mu")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3)


@pytest.mark.parametrize("name", ["grok_ep", "grok_tp", "deepseek"])
def test_moe_forward_loss_and_aux(runs, name):
    ref, port = runs
    np.testing.assert_allclose(port[f"{name}/fwd_loss"],
                               ref[f"{name}/fwd_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port[f"{name}/fwd_aux"],
                               ref[f"{name}/fwd_aux"], rtol=LOSS_RTOL)
    assert float(ref[f"{name}/fwd_aux"]) > 0


def test_elastic_reshard_step(runs):
    ref, port = runs
    np.testing.assert_allclose(port["reshard/loss"], ref["reshard/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["reshard/grad_norm"],
                               ref["reshard/grad_norm"], rtol=10 * GRAD_TOL)


def test_flash_decode(runs):
    ref, port = runs
    d = PLAN["decode"]
    assert int(port["decode/flash_calls"]) == d["steps"] * _cfg(d).n_layers
    # the cache shards its sequence over "model" (2 kv heads, tp = 4)
    assert "S(2)" in list(port["decode/k_placements"])
    for i in range(d["steps"] + 1):
        np.testing.assert_allclose(port[f"decode/logits{i}"],
                                   ref[f"decode/logits{i}"], rtol=0,
                                   atol=FP32_TOL)


def test_generate_tokens(runs):
    ref, port = runs
    np.testing.assert_array_equal(port["generate/tokens"],
                                  ref["generate/tokens"])


def test_train_loop_on_a_mesh(runs):
    _, port = runs
    np.testing.assert_allclose(port["loop/mesh"], port["loop/one"],
                               rtol=LOSS_RTOL)
    assert port["loop/resumed"].shape == (1,)
    np.testing.assert_allclose(port["loop/resumed"][0], port["loop/mesh"][-1],
                               rtol=LOSS_RTOL)

