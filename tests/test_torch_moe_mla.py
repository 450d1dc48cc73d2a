"""The port's MoE layer and MLA against the JAX package on the CPU.

MoE: the reference's own slot table, chosen experts and positions are
read out of its `moe_apply` (run as it runs, under `shard_map` on a
1 x 1 mesh) by `jax.debug.callback`s on the arguments of the one
`take_along_axis` (the flattened top-k experts), the one `maximum` (the
slot table) and the `minimum`s (the positions in expert) of its
`_moe_local`; the port's `moe.dispatch` must give them bit for bit, on
random floats, on forced overflow (the reference drops an overflowing
expert's last in-capacity token: slot cap - 1 holds -1), on integer-grid
gates with exact ties (ties go to the lowest expert) and at token counts
on both sides of the capacity formula's steps, with 0, 1 and 2 shared
experts. The outputs and the aux loss agree within FP32_TOL.

MLA: prefill's output and cache (c_kv, k_r) and a decode step into a
preallocated cache, written in place, against the reference, in fp32
within FP32_TOL and bf16 within BF16_TOL. And the family end to end:
`examples/torch_rag_serve.py --arch deepseek-v2-236b` on the CPU (here
rather than in `test_torch_lm.py`, whose file is the suite's longest). Every array comes from a seeded
numpy generator of its own; the reference's parameters are carried
across with `params_from_numpy`.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.launch.mesh import make_mesh_compat
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import lm as JLM
from repro.models import moe as JM
from repro_torch.configs import base as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import moe as TM

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-5
BF16_TOL = 0.08
MESH = make_mesh_compat((1, 1), ("data", "model"))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _carry(jparams):
    return TC.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _moe_cfgs(shared: int, **kw):
    """deepseek-v2's smoke config (8 experts, top-2) with `shared` shared
    experts, fp32 compute, in both packages."""
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_smoke_config("deepseek-v2-236b")
        out.append(dataclasses.replace(cfg, n_shared_experts=shared,
                                       compute_dtype="float32", **kw))
    return out


class _RefSpy:
    """Records what the reference's `_moe_local` computes inside its
    `shard_map`: the flattened top-k experts, the slot table and the
    positions in expert, one entry per call."""

    def __init__(self, monkeypatch):
        self.flat_e, self.table, self.slot_pos = [], [], []
        spy = self

        class Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            def take_along_axis(self, a, idx, axis):
                jax.debug.callback(
                    lambda v: spy.flat_e.append(np.asarray(v)[:, 0]), idx)
                return jnp.take_along_axis(a, idx, axis=axis)

            def maximum(self, a, b):
                jax.debug.callback(
                    lambda v: spy.table.append(np.asarray(v)), a)
                return jnp.maximum(a, b)

            def minimum(self, a, b):      # both calls clip slot_pos
                jax.debug.callback(
                    lambda v: spy.slot_pos.append(np.asarray(v)), a)
                return jnp.minimum(a, b)

        monkeypatch.setattr(JM, "jnp", Jnp())


def _run_both(monkeypatch, jcfg, tcfg, jp, x):
    """The reference's `moe_apply` (with its dispatch read out) and the
    port's `moe_apply` and `dispatch` on x [B, S, D]."""
    spy = _RefSpy(monkeypatch)
    with MESH:
        jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg,
                                JLM.ModelCtx(mesh=MESH))
        jax.block_until_ready(jy)
    tp = _carry(jp)
    tx = torch.from_numpy(x)
    ty, taux = TM.moe_apply(tp, tx, tcfg)
    g = TM.dispatch(tx.reshape(-1, x.shape[-1]), tp["wg"], tcfg)
    assert len(spy.table) == len(spy.flat_e) == 1
    assert len(spy.slot_pos) == 2
    return (jy, jaux, spy.flat_e[0], spy.table[0], spy.slot_pos[0]), \
        (ty, taux, g)


def _hold_dispatch(ref, port):
    (jy, jaux, flat_e, table, slot_pos), (ty, taux, g) = ref, port
    np.testing.assert_array_equal(g["flat_e"].numpy(), flat_e)
    np.testing.assert_array_equal(g["slot_pos"].numpy(), slot_pos)
    np.testing.assert_array_equal(g["table"].numpy(), table)
    assert g["cap"] == table.shape[1]
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=FP32_TOL,
                               atol=FP32_TOL)


def _overflowed(g):
    return (g["onehot"].sum(0) > g["cap"]).numpy()


@pytest.mark.parametrize("shared", [0, 1, 2])
@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_moe_dispatch_matches_reference(monkeypatch, case, shared):
    """Random floats; forced overflow (expert 3's gate column dominant:
    every token picks it, its load 24 past cap 8, and slot cap - 1 holds
    -1, so the token in it gets nothing from expert 3); integer-grid x
    and gate (exact fp32 logits, many exact ties, broken to the lowest
    expert)."""
    jcfg, tcfg = _moe_cfgs(shared)
    assert TC.count_params(TM.moe_desc(tcfg)) == \
        JC.count_params(JM.moe_desc(jcfg))
    rng = np.random.default_rng(["random", "overflow", "ties"].index(case)
                                * 10 + shared)
    jp = JC.init_params(JM.moe_desc(jcfg), jax.random.PRNGKey(shared))
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    if case == "overflow":
        wg = np.asarray(jp["wg"]).copy()
        wg[:, 3] = 10.0 * np.abs(wg).max()
        x = np.abs(x)
        jp = dict(jp, wg=jnp.asarray(wg))
    elif case == "ties":
        x = rng.integers(-1, 2, size=x.shape).astype(np.float32)
        jp = dict(jp, wg=jnp.asarray(rng.integers(
            -1, 2, size=jp["wg"].shape).astype(np.float32)))
    ref, port = _run_both(monkeypatch, jcfg, tcfg, jp, x)
    _hold_dispatch(ref, port)
    g = port[2]
    if case == "overflow":
        assert _overflowed(g)[3] and g["table"][3, -1] == -1
        last = g["table"][3, -2] + 1                # the dropped token
        hit = (g["flat_e"] == 3) & (g["slot_pos"] == g["cap"] - 1)
        assert hit.sum() == 1 and g["valid"][hit].all()
        assert int(torch.nonzero(hit)[0, 0]) // 2 == last
    if case == "ties":
        top = torch.sort(g["logits"], -1, descending=True).values
        assert (top[:, 1] == top[:, 2]).any()          # a tie at the k-th
        for t in range(g["logits"].shape[0]):          # the lowest wins
            row = g["logits"][t].tolist()
            want = sorted(range(len(row)), key=lambda e: (-row[e], e))[:2]
            assert g["gidx"][t].tolist() == want


@pytest.mark.parametrize("t", [1, 22, 23, 35, 36, 100])
def test_moe_capacity_steps_match_reference(monkeypatch, t):
    """Token counts on both sides of the capacity formula's steps (8
    experts, top-2, factor 1.25: cap 4 to T = 22, 8 from 23, 12 from 36;
    the floor of 4 at T = 1), random floats."""
    jcfg, tcfg = _moe_cfgs(1)
    rng = np.random.default_rng(100 + t)
    jp = JC.init_params(JM.moe_desc(jcfg), jax.random.PRNGKey(t))
    x = rng.normal(size=(1, t, jcfg.d_model)).astype(np.float32)
    ref, port = _run_both(monkeypatch, jcfg, tcfg, jp, x)
    _hold_dispatch(ref, port)
    assert port[2]["cap"] == TM.capacity(t, tcfg) == \
        {1: 4, 22: 4, 23: 8, 35: 8, 36: 12, 100: 32}[t]


def test_moe_bf16_matches_reference(monkeypatch):
    """grok-1's smoke layer (4 experts, no shared) on bf16 inputs and
    weights: the same experts and table, y within BF16_TOL."""
    jcfg = jconfigs.get_smoke_config("grok-1-314b")
    tcfg = tconfigs.get_smoke_config("grok-1-314b")
    rng = np.random.default_rng(7)
    jp = JC.cast_floats(JC.init_params(JM.moe_desc(jcfg),
                                       jax.random.PRNGKey(7)), jnp.bfloat16)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    spy = _RefSpy(monkeypatch)
    with MESH:
        jy, _ = JM.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                             JLM.ModelCtx(mesh=MESH))
        jax.block_until_ready(jy)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = _carry(jp)
    ty, _ = TM.moe_apply(tp, tx, tcfg)
    g = TM.dispatch(tx.reshape(-1, x.shape[-1]), tp["wg"], tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(g["table"].numpy(), spy.table[0])
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=BF16_TOL,
                               atol=BF16_TOL)


# ---- MLA --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qc", [16, 5])
def test_mla_prefill_and_decode_match_reference(qc, dtype):
    """deepseek-v2's smoke MLA: prefill over 20 tokens (a query chunk
    that tiles them and one that `pick_qc` cuts to 5), its cache, then a
    decode step at position 20 of a 24-slot cache, written in place."""
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("deepseek-v2-236b"), compute_dtype=dtype)
    tcfg = dataclasses.replace(
        tconfigs.get_smoke_config("deepseek-v2-236b"), compute_dtype=dtype)
    assert TC.count_params(TA.mla_desc(tcfg)) == \
        JC.count_params(JA.mla_desc(jcfg))
    rng = np.random.default_rng(qc)
    jp = JC.cast_floats(JC.init_params(JA.mla_desc(jcfg),
                                       jax.random.PRNGKey(qc)),
                        jnp.dtype(dtype))
    tp = _carry(jp)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    s = 20
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    jy, jc = JA.mla_prefill(jp, jnp.asarray(x, jdt), jcfg, jnp.asarray(pos),
                            qc=qc)
    ty, tc = TA.mla_prefill(tp, torch.from_numpy(x).to(tdt), tcfg,
                            torch.from_numpy(pos), qc=qc)
    for got, want in ((ty, jy), (tc["c_kv"], jc["c_kv"]),
                      (tc["k_r"], jc["k_r"])):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=tol, atol=tol)
    slots = 24
    c_kv = rng.normal(size=(2, slots, jcfg.kv_lora_rank)).astype(np.float32)
    k_r = rng.normal(size=(2, slots, jcfg.mla_rope_dim)).astype(np.float32)
    xn = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, jc = JA.mla_decode(jp, jnp.asarray(xn, jdt),
                           {"c_kv": jnp.asarray(c_kv, jdt),
                            "k_r": jnp.asarray(k_r, jdt)}, jcfg,
                           jnp.int32(s))
    cache = {"c_kv": torch.from_numpy(c_kv).to(tdt),
             "k_r": torch.from_numpy(k_r).to(tdt)}
    ty, tc = TA.mla_decode(tp, torch.from_numpy(xn).to(tdt), cache, tcfg, s)
    assert tc["c_kv"] is cache["c_kv"] and tc["k_r"] is cache["k_r"]
    for got, want in ((ty, jy), (tc["c_kv"], jc["c_kv"]),
                      (tc["k_r"], jc["k_r"])):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=tol, atol=tol)
    with pytest.raises(IndexError):
        TA.mla_decode(tp, torch.from_numpy(xn).to(tdt), cache, tcfg, slots)


def test_rag_example_serves_deepseek_on_cpu(tmp_path):
    """`examples/torch_rag_serve.py --arch deepseek-v2-236b` (the smoke
    config: MoE + MLA) end to end on the CPU: the offline stage, the
    queue, generation."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               REPRO_ARTIFACTS=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_rag_serve.py"),
         "--arch", "deepseek-v2-236b", "--device", "cpu", "--requests", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests" in out.stdout
    assert "retrieval hit rate: 1.00" in out.stdout
