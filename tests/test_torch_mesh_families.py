"""The recurrent and encoder-decoder families on a mesh, against the JAX
package's on the CPU. The smoke configs of xlstm-125m (4 blocks: one
sLSTM, three mLSTM; 2 heads), hymba-1.5b (4 heads, 2 kv heads, Mamba
heads beside the sliding-window attention) and whisper-medium (2 encoder
and 2 decoder layers, 4 heads) run on a (2, 2) (data, model) mesh, where
every head count divides "model", so each runs tensor-parallel: the
port on 4 `gloo` ranks (`tests/mesh_ranks_torch.py`), the reference on 4
forced host devices (`tests/mesh_reference_jax.py`), both started once
for the module and side by side, on the same inputs and the reference's
weights (`params_from_numpy`), in fp32:

  * a train step (4 × 32 tokens, accumulation 1, GLA chunks and query
    chunks of 16): the loss within LOSS_RTOL and the grad norm within
    GRAD_RTOL, relative;
  * prefill of 2 prompts of 12 tokens right-padded to 24 (chunks of 8:
    the recurrent writes masked past the prompt, Hymba's ring of 8 slots
    wrapped, whisper's cross K/V over 16 frames) and 4 greedy decode
    steps: the logits of prefill and of each step within LOGIT_TOL of the
    reference's (xlstm's within XLSTM_TOL: its gates amplify rounding
    about a hundredfold), and the greedy tokens equal.

Every array comes from seeded numpy generators of this file's own.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as jconfigs
from repro.models import common as JC
from repro.models import lm as JLM

from test_torch_distributed import ROOT, TESTS, _env, _finish

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_TOL = 1e-5
XLSTM_TOL = 1e-3

FAMILIES = {
    "xlstm": {"arch": "xlstm-125m", "mesh": [2, 2], "batch": [4, 32],
              "prompt": [2, 24], "prompt_len": 12, "steps": 4},
    "hymba": {"arch": "hymba-1.5b", "mesh": [2, 2], "batch": [4, 32],
              "prompt": [2, 24], "prompt_len": 12, "steps": 4},
    "whisper": {"arch": "whisper-medium", "mesh": [2, 2], "batch": [4, 32],
                "prompt": [2, 24], "prompt_len": 12, "steps": 4},
}


def _cfg(case):
    return dataclasses.replace(jconfigs.get_smoke_config(case["arch"]),
                               compute_dtype="float32")


def _inputs(seed=1) -> dict:
    """The weights (the reference's init), the train batch, the prompts
    and whisper's frame embeddings, as flat numpy arrays."""
    rng = np.random.default_rng(seed)
    inp = {}
    for i, (name, case) in enumerate(FAMILIES.items()):
        cfg = _cfg(case)
        leaves = jax.tree.leaves(JC.init_params(
            JLM.model_desc(cfg), jax.random.PRNGKey(30 + i)))
        for j, a in enumerate(leaves):
            inp[f"{name}/p{j:04d}"] = np.asarray(a)
        b, s = case["batch"]
        toks = rng.integers(1, cfg.vocab, size=(b, s + 1)).astype(np.int32)
        inp[f"{name}/b0/tokens"] = toks[:, :-1]
        inp[f"{name}/b0/targets"] = toks[:, 1:].copy()
        inp[f"{name}/b0/targets"][0, :3] = -1
        pb, ps = case["prompt"]
        prompt = np.zeros((pb, ps), np.int32)
        prompt[:, :case["prompt_len"]] = rng.integers(
            1, cfg.vocab, size=(pb, case["prompt_len"]))
        inp[f"{name}/prompt/tokens"] = prompt
        if cfg.encoder_layers:
            for key, rows in (("b0", b), ("prompt", pb)):
                inp[f"{name}/{key}/enc_inputs"] = (0.5 * rng.normal(
                    size=(rows, cfg.encoder_seq, cfg.d_model))).astype(
                    np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's), each run once."""
    root = str(tmp_path_factory.mktemp("families"))
    with open(os.path.join(root, "plan.json"), "w") as f:
        json.dump({"families": FAMILIES}, f)
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


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_step(runs, name):
    ref, port = runs
    loss, gnorm = float(ref[f"{name}/loss"]), float(ref[f"{name}/grad_norm"])
    assert np.isfinite(loss) and gnorm > 0
    np.testing.assert_allclose(port[f"{name}/loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(port[f"{name}/grad_norm"], gnorm,
                               rtol=GRAD_RTOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_prefill_and_decode_logits(runs, name):
    ref, port = runs
    tol = XLSTM_TOL if name == "xlstm" else LOGIT_TOL
    for i in range(FAMILIES[name]["steps"] + 1):
        got, want = port[f"{name}/logits{i}"], ref[f"{name}/logits{i}"]
        assert got.shape == want.shape == (FAMILIES[name]["prompt"][0], 1,
                                           _cfg(FAMILIES[name]).vocab)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_tokens(runs, name):
    ref, port = runs
    assert port[f"{name}/tokens"].shape == (FAMILIES[name]["prompt"][0],
                                            FAMILIES[name]["steps"])
    np.testing.assert_array_equal(port[f"{name}/tokens"],
                                  ref[f"{name}/tokens"])
