"""The port's checkpoints and training loop against the JAX package's on
the CPU: a checkpoint written by either package opens in the other bit
for bit — bf16 parameters, 8-bit moments (`q`/`s`) and xLSTM's tuple
stack included — with the same keys and dtypes in its manifest; a
training run of the reference resumed by the port's `train_loop`
continues as the reference's own resume does; the manager's rotation,
background saves and atomic writes; the training CLI and
`examples/torch_train_lm.py`, each run twice in a one-thread subprocess
(the second run resumes); the token stream, the step monitor and the
preemption handler against the reference's; `train_loop` resumed bit for
bit and checkpointing at a preemption signal.
Every array is drawn from a seeded numpy generator or seeded init of its
own."""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import base as jconfigs
from repro.data.tokens import TokenStream as JStream
from repro.launch import train as jtrain
from repro.models import common as JC
from repro.models import lm as JLM
from repro.optim import adam as jadam
from repro.runtime import fault as jfault
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import base as tconfigs
from repro_torch.data.tokens import TokenStream as TStream
from repro_torch.launch import train as ttrain
from repro_torch.models import common as TC
from repro_torch.models import lm as TLM
from repro_torch.optim import adam as tadam
from repro_torch.runtime import fault as tfault
from test_torch_train import _one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
# (arch, param dtype, compressed moments): xLSTM's tuple stack in fp32
# with fp32 moments, deepseek-v2 (MoE + MLA) in bf16 with 8-bit moments
CASES = [("xlstm-125m", "float32", False),
         ("deepseek-v2-236b", "bfloat16", True)]


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as uint16), from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _trees(arch, dtype, compress):
    """One training state in each package: the reference's smoke
    parameters (cast to `dtype`) and their AdamW state after one update
    on the same gradients (equal to fp32 rounding, not bit for bit)."""
    cfg = jconfigs.get_smoke_config(arch)
    jp = JC.init_params(JLM.model_desc(cfg), jax.random.PRNGKey(7),
                        dtype=jnp.dtype(dtype))
    tp = TC.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jcfg = jadam.AdamConfig(lr=1e-2, compress=compress)
    tcfg = tadam.AdamConfig(lr=1e-2, compress=compress)
    rng = np.random.default_rng(8)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), jp)
    jp, js = jadam.adam_update(jax.tree.map(jnp.asarray, grads),
                               jadam.adam_init(jp, jcfg), jp, jcfg)
    tp, ts = tadam.adam_update(
        TC.map_descs(lambda g: torch.from_numpy(g.copy()), grads),
        tadam.adam_init(tp, tcfg), tp, tcfg)
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _hold_bits(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,dtype,compress", CASES)
def test_port_checkpoint_opens_in_reference(arch, dtype, compress, tmp_path):
    jtree, ttree = _trees(arch, dtype, compress)
    tck.save_pytree(str(tmp_path / "port"), ttree, metadata={"step": 1})
    jck.save_pytree(str(tmp_path / "ref"), jtree, metadata={"step": 1})
    mans = [json.loads((tmp_path / d / "manifest.json").read_text())
            for d in ("port", "ref")]
    for k in ("keys", "dtypes", "metadata"):
        assert mans[0][k] == mans[1][k]
    if arch == "xlstm-125m":
        assert "params/layers/0/slstm/wr" in mans[0]["keys"]
    if compress:
        assert mans[0]["dtypes"]["opt/mu/embed/q"] == "int8"
        assert mans[0]["dtypes"]["params/embed"] == "bfloat16"
    assert mans[0]["dtypes"]["opt/step"] == "int32"
    with np.load(tmp_path / "port" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "arrays.npz") as b:
        assert list(a.keys()) == list(b.keys())
    restored = jck.restore_pytree(str(tmp_path / "port"), jtree)
    _hold_bits(jax.tree.leaves(restored), TC.tree_leaves(ttree))
    assert jck.restore_metadata(str(tmp_path / "port")) == {"step": 1}


@pytest.mark.parametrize("arch,dtype,compress", CASES)
def test_reference_checkpoint_opens_in_port(arch, dtype, compress, tmp_path):
    jtree, ttree = _trees(arch, dtype, compress)
    jck.save_pytree(str(tmp_path / "ref"), jtree, metadata={"step": 1})
    restored = tck.restore_pytree(str(tmp_path / "ref"), ttree)
    _hold_bits(TC.tree_leaves(restored), jax.tree.leaves(jtree))
    # the descriptors serve as `like` too (what `train_loop` restores into)
    cfg = tconfigs.get_smoke_config(arch)
    desc = TLM.model_desc(cfg)
    like = {"params": desc, "opt": tadam.adam_state_desc(
        desc, tadam.AdamConfig(compress=compress))}
    again = tck.restore_pytree(str(tmp_path / "ref"), like)
    _hold_bits(TC.tree_leaves(again), jax.tree.leaves(jtree))
    assert tck.restore_metadata(str(tmp_path / "ref")) == {"step": 1}


def test_reference_run_resumes_in_port(tmp_path):
    """The reference's `train_loop` checkpoints deepseek-v2's smoke
    config (bf16 parameters, 8-bit moments, fp32 compute) at step 2; the
    port's `train_loop` resumes it to step 3 as the reference's own
    resume does: step 3's loss (the forward of the restored parameters)
    within 1e-5 relative, and a step taken from there. The parameters
    after that step are not compared: where an 8-bit second moment
    quantizes to 0 beside a nonzero first moment, the update is
    mu / eps, and rounding-level gradient differences move it by
    orders of magnitude, in both packages."""
    kw = dict(param_dtype="bfloat16", opt_compress=True,
              compute_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("deepseek-v2-236b"),
                               **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("deepseek-v2-236b"),
                               **kw)
    run = dict(global_batch=4, seq_len=16, accum=2, verbose=False)
    jtrain.train_loop(jcfg, steps=2, ckpt_dir=str(tmp_path / "ref"), **run)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    at2 = tck.CheckpointManager(str(tmp_path / "port")).restore(
        {"params": TLM.model_desc(tcfg)})[0]["params"]
    _, _, jh = jtrain.train_loop(jcfg, steps=3,
                                 ckpt_dir=str(tmp_path / "ref"), **run)
    tp, ts, th = ttrain.train_loop(tcfg, steps=3,
                                   ckpt_dir=str(tmp_path / "port"),
                                   device="cpu", **run)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [3]
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-5)
    assert int(ts["step"]) == 3
    assert ts["mu"]["embed"]["q"].dtype == torch.int8
    for p in TC.tree_leaves(tp):
        assert p.dtype == torch.bfloat16 and torch.isfinite(p).all()
    assert not torch.equal(tp["embed"], at2["embed"])


def _small(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(16, 8)).astype(
                np.float32)),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": (torch.ones(3, dtype=torch.bfloat16),
                             torch.zeros((), dtype=torch.float32))}}


def test_save_restore_bitwise_and_shape_checked(tmp_path):
    t = _small()
    tck.save_pytree(str(tmp_path / "ck"), t, metadata={"step": 7})
    r = tck.restore_pytree(str(tmp_path / "ck"), t)
    _hold_bits(TC.tree_leaves(r), TC.tree_leaves(t))
    bad = dict(t, a=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="mismatch"):
        tck.restore_pytree(str(tmp_path / "ck"), bad)
    on = tck.restore_pytree(str(tmp_path / "ck"), t, device="cpu")
    assert on["nested"]["c"][0].dtype == torch.bfloat16


def test_manager_rotation_background_and_atomicity(tmp_path):
    m = tck.CheckpointManager(str(tmp_path), keep_n=2)
    t = _small()
    for step in (5, 10, 15):
        m.save(step, t)
    assert m.steps() == [10, 15] and m.latest_step() == 15
    os.makedirs(tmp_path / "step_0000000020.tmp")     # a save cut short
    assert m.latest_step() == 15
    r, meta = m.restore(t)
    assert meta == {"step": 15}
    _hold_bits(TC.tree_leaves(r), TC.tree_leaves(t))
    m.save(16, _small(1), background=True, metadata={"note": "bg"})
    m.wait()
    assert m.latest_step() == 16
    r, meta = m.restore(t, step=16)
    assert meta == {"step": 16, "note": "bg"}
    _hold_bits(TC.tree_leaves(r), TC.tree_leaves(_small(1)))
    assert not (tmp_path / "step_0000000016.tmp").exists()
    assert tck.CheckpointManager(str(tmp_path / "new")).restore(t) == \
        (None, None)


def test_background_save_is_a_snapshot(tmp_path):
    """A background save holds the tree as it was at `save`, though the
    caller updates its tensors in place before the thread has written."""
    m = tck.CheckpointManager(str(tmp_path))
    t = _small()
    want = TC.map_descs(lambda x: x.clone(), t)
    m.save(1, t, background=True)
    for leaf in TC.tree_leaves(t):
        leaf.add_(1)
    m.wait()
    r, _ = m.restore(t)
    _hold_bits(TC.tree_leaves(r), TC.tree_leaves(want))


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_runs_and_resumes_on_cpu(tmp_path):
    args = ["-m", "repro_torch.launch.train", "--smoke", "--arch",
            "deepseek-v2-236b", "--batch", "4", "--seq", "16", "--accum",
            "2", "--device", "cpu", "--ckpt", str(tmp_path / "ck")]
    out = _run(args + ["--steps", "2"], tmp_path)
    assert "first loss" in out
    out = _run(args + ["--steps", "3"], tmp_path)
    assert "resumed from step 2" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000002",
                                                  "step_0000000003"]


def test_train_example_runs_and_resumes_on_cpu(tmp_path):
    args = [str(ROOT / "examples" / "torch_train_lm.py"), "--steps", "10",
            "--batch", "4", "--seq", "32", "--device", "cpu", "--ckpt",
            str(tmp_path / "ck")]
    out = _run(args, tmp_path)
    assert "over 10 steps" in out
    out = _run(args[:2] + ["12"] + args[3:], tmp_path)
    assert "resumed from step 10" in out and "over 2 steps" in out


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 32, 4, 5), (512, 17, 3, 0), (151936, 64, 2, 1)])
def test_token_stream_matches_reference(vocab, seq, batch, seed):
    js, ts = JStream(vocab, seq, batch, seed=seed), \
        TStream(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17, 1000):
        jb, tb = js.batch(step), ts.batch(step)
        for k in ("tokens", "targets"):
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])


def test_step_monitor_matches_reference(monkeypatch):
    """Both monitors on one fake clock: the same straggler, escalation
    and median on every step (a deadline, a window of 5)."""
    times = [0.10] * 6 + [0.50, 0.55, 0.60, 0.10, 0.32, 0.09, 0.70, 0.2]
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["t"])
    for kw in ({}, {"factor": 2.0, "window": 5, "escalate_after": 2,
                    "deadline_s": 0.3}):
        mons = [jfault.StepMonitor(**kw), tfault.StepMonitor(**kw)]
        for dt in times:
            for m in mons:
                m.start_step()
            clock["t"] += dt
            out = [m.end_step() for m in mons]
            assert out[0] == out[1]
        assert mons[0].straggler_events == mons[1].straggler_events > 0


def test_preemption_handler_matches_reference():
    for cls in (jfault.PreemptionHandler, tfault.PreemptionHandler):
        before = signal.getsignal(signal.SIGUSR1)
        h = cls(signals=(signal.SIGUSR1,))
        try:
            assert not h.requested
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + 5
            while not h.requested and time.monotonic() < deadline:
                time.sleep(0.01)
            assert h.requested
        finally:
            h.restore()
        assert signal.getsignal(signal.SIGUSR1) == before


RESUME_CASES = {
    "qwen2-0.5b": {},
    "deepseek-v2-236b": {"param_dtype": "bfloat16", "opt_compress": True},
    "xlstm-125m": {},
    "whisper-medium": {},
}


@pytest.mark.parametrize("arch", sorted(RESUME_CASES))
def test_train_loop_resume_is_bitwise(arch, tmp_path):
    """4 steps equal 2 steps, then a fresh `train_loop` resuming to 4:
    every loss, parameter and moment bit for bit (accumulation 2;
    deepseek-v2 with bf16 parameters and 8-bit moments)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              **RESUME_CASES[arch])
    kw = dict(global_batch=4, seq_len=32, accum=2, save_every=2,
              device="cpu", verbose=False)
    p1, s1, h1 = ttrain.train_loop(cfg, steps=4, ckpt_dir=str(tmp_path / "a"),
                                   **kw)
    _, _, h2 = ttrain.train_loop(cfg, steps=2, ckpt_dir=str(tmp_path / "b"),
                                 **kw)
    p2, s2, h3 = ttrain.train_loop(cfg, steps=4,
                                   ckpt_dir=str(tmp_path / "b"), **kw)
    assert [h["step"] for h in h2 + h3] == [1, 2, 3, 4]
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2 + h3]
    assert all(np.isfinite(h["loss"]) for h in h1)
    want = TC.tree_leaves((p1, s1["mu"], s1["nu"]))
    got = TC.tree_leaves((p2, s2["mu"], s2["nu"]))
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(s1["step"]) == int(s2["step"]) == 4
    if cfg.param_dtype == "bfloat16":
        assert p1["embed"].dtype == torch.bfloat16
        assert s1["mu"]["embed"]["q"].dtype == torch.int8


def test_train_loop_checkpoints_at_preemption(tmp_path, monkeypatch):
    """SIGUSR1 during step 2: the loop checkpoints at step 2 and stops;
    a rerun resumes from there."""

    class Signalling(TStream):
        def batch(self, step):
            if step == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            return super().batch(step)

    monkeypatch.setattr(ttrain, "TokenStream", Signalling)
    cfg = tconfigs.get_smoke_config("internlm2-1.8b")
    before = signal.getsignal(signal.SIGUSR1)
    _, _, hist = ttrain.train_loop(cfg, steps=6, global_batch=2, seq_len=16,
                                   ckpt_dir=str(tmp_path), device="cpu",
                                   verbose=False)
    assert [h["step"] for h in hist] == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002"]
    assert signal.getsignal(signal.SIGUSR1) == before
    monkeypatch.setattr(ttrain, "TokenStream", TStream)
    _, _, hist = ttrain.train_loop(cfg, steps=3, global_batch=2, seq_len=16,
                                   ckpt_dir=str(tmp_path), device="cpu",
                                   verbose=False)
    assert [h["step"] for h in hist] == [3]
