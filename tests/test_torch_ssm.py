"""The port's recurrent mixers against the JAX package on the CPU: the GLA
chunk scan and its decode step, mLSTM, sLSTM and the Mamba heads, and the
two recurrent families' serving paths (xlstm-125m's masked prefill,
Hymba's ring cache).

The GLA scan is the one deliberate divergence (ROADMAP.md queue 1 item
7): the port weights a chunk's causal pairs by exp(cum_q - cum_k), the
reference by exp(cum_q) · exp(-cum_k), whose second factor passes fp32's
range once a chunk's summed log-decay falls below about -88. Where the
reference is finite the two agree within FP32_TOL; at chunk 256 and a
log-decay of -0.35 or -0.7 the reference is non-finite (pinned here) and
the port is finite and within LOOP_TOL of the reference's own
step-by-step recurrence (`gla_decode_step` over every position). The
chunked and the step forms sum in other orders: over 256 positions they
part by up to 2.4e-5 relative in the port, and by 1.2e-5 in the
reference's own chunk-64 scan; LOOP_TOL is 1e-4.

Tolerances otherwise FP32_TOL = 1e-5 (fp32) and BF16_TOL = 0.08 (bf16).
Every array comes from a seeded numpy generator of its own; the
reference's parameters are carried across with `params_from_numpy`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.launch.mesh import make_mesh_compat
from repro.models import common as JC
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro_torch.configs import base as tconfigs
from repro_torch.models import common as TC
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS

FP32_TOL = 1e-5
BF16_TOL = 0.08
LOOP_TOL = 1e-4
XLSTM_TOL = 2e-4          # test_torch_lm.py's XLSTM_TOL["float32"]
MESH = make_mesh_compat((1, 1), ("data", "model"))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _carry(jparams):
    return TC.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _hold(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _gla_inputs(seed, s, decay, h=2, dk=8, dv=8, b=2):
    """q, k, v ~ N(0, 1) and a log-decay of `decay` ± 0.05 at every
    position."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    log_f = (decay + 0.05 * rng.uniform(-1, 1, size=(b, s, h))).astype(
        np.float32)
    return q, k, v, log_f


def _ref_loop(q, k, v, log_f, normalize):
    """The reference's recurrence: `gla_decode_step` at every position."""
    b, s, h, dk = q.shape
    state = jnp.zeros((b, h, dk, v.shape[-1] + int(normalize)), jnp.float32)
    step = jax.jit(lambda *a: JS.gla_decode_step(*a, normalize=normalize))
    ys = []
    for t in range(s):
        y, state = step(*(jnp.asarray(a[:, t:t + 1]) for a in (q, k, v,
                                                               log_f)),
                        state)
        ys.append(np.asarray(y))
    return np.concatenate(ys, 1), np.asarray(state)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("decay", [-0.1, -0.35, -0.7])
@pytest.mark.parametrize("chunk", [16, 64])
def test_gla_chunk_scan_matches_reference(chunk, decay, normalize):
    """128 positions in chunks of 16 and 64, log-decays -0.1 to -0.7,
    with a carried initial state; outputs and final state."""
    q, k, v, log_f = _gla_inputs(int(chunk - 100 * decay), 128, decay)
    rng = np.random.default_rng(chunk)
    state0 = rng.normal(size=(2, 2, 8, 8 + int(normalize))).astype(
        np.float32)
    jy, js = JS.gla_chunk_scan(*map(jnp.asarray, (q, k, v, log_f)),
                               jnp.asarray(state0), chunk=chunk,
                               normalize=normalize)
    assert np.isfinite(np.asarray(jy)).all()
    ty, ts = TS.gla_chunk_scan(*map(torch.from_numpy, (q, k, v, log_f)),
                               torch.from_numpy(state0), chunk=chunk,
                               normalize=normalize)
    _hold(ty, jy, FP32_TOL)
    _hold(ts, js, FP32_TOL)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("decay", [-0.35, -0.7])
def test_gla_chunk256_finite_where_reference_overflows(decay, normalize):
    """One chunk of 256 positions: the reference's exp(-cum) overflows
    (its outputs non-finite, pinned), the port's outputs and state are
    finite and within LOOP_TOL of the reference's recurrence."""
    q, k, v, log_f = _gla_inputs(int(-100 * decay), 256, decay)
    jy, _ = JS.gla_chunk_scan(*map(jnp.asarray, (q, k, v, log_f)),
                              chunk=256, normalize=normalize)
    assert not np.isfinite(np.asarray(jy)).all()
    ty, ts = TS.gla_chunk_scan(*map(torch.from_numpy, (q, k, v, log_f)),
                               chunk=256, normalize=normalize)
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    want_y, want_state = _ref_loop(q, k, v, log_f, normalize)
    np.testing.assert_allclose(ty.numpy(), want_y, rtol=LOOP_TOL,
                               atol=LOOP_TOL)
    np.testing.assert_allclose(ts.numpy(), want_state, rtol=LOOP_TOL,
                               atol=LOOP_TOL)


def test_gla_chunk_must_tile_the_sequence():
    q, k, v, log_f = map(torch.from_numpy, _gla_inputs(0, 40, -0.1))
    with pytest.raises(ValueError, match="does not tile"):
        TS.gla_chunk_scan(q, k, v, log_f, chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [True, False])
def test_gla_decode_step_matches_reference(normalize, dtype):
    q, k, v, log_f = _gla_inputs(5, 1, -0.3)
    rng = np.random.default_rng(6)
    state = rng.normal(size=(2, 2, 8, 8 + int(normalize))).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jy, js = JS.gla_decode_step(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(log_f),
        jnp.asarray(state), normalize=normalize)
    ty, ts = TS.gla_decode_step(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(log_f), torch.from_numpy(state),
        normalize=normalize)
    assert ty.dtype == tdt and ts.dtype == torch.float32
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    _hold(ty, jy, tol)
    _hold(ts, js, FP32_TOL)


# ---- the blocks ---------------------------------------------------------------

def _xlstm(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config("xlstm-125m"),
                                compute_dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config("xlstm-125m"),
                                compute_dtype=dtype))


@pytest.mark.parametrize("prompt_len", [None, 5, 12])
def test_slstm_matches_reference(prompt_len):
    """`slstm_train` over 12 positions with `valid` false past
    prompt_len (no writes, the state kept), then a decode step from its
    state; outputs and (c, n, h, m)."""
    jcfg, tcfg = _xlstm()
    rng = np.random.default_rng(prompt_len or 0)
    jp = JC.init_params(JS.slstm_desc(jcfg), jax.random.PRNGKey(1))
    tp = _carry(jp)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    valid = None if prompt_len is None else np.arange(12) < prompt_len
    jy, jst = JS.slstm_train(jp, jnp.asarray(x), jcfg,
                             valid=None if valid is None
                             else jnp.asarray(valid))
    ty, tst = TS.slstm_train(tp, torch.from_numpy(x), tcfg,
                             valid=None if valid is None
                             else torch.from_numpy(valid))
    _hold(ty, jy, FP32_TOL)
    for got, want in zip(tst, jst):
        _hold(got, want, FP32_TOL)
    if prompt_len is not None:                  # the state stops moving
        _, short = TS.slstm_train(tp, torch.from_numpy(x[:, :prompt_len]),
                                  tcfg)
        for got, want in zip(tst, short):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    xn = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, jst = JS.slstm_decode(jp, jnp.asarray(xn), jst, jcfg)
    ty, tst = TS.slstm_decode(tp, torch.from_numpy(xn), tst, tcfg)
    _hold(ty, jy, FP32_TOL)
    for got, want in zip(tst, jst):
        _hold(got, want, FP32_TOL)


def test_mlstm_gates_and_decode_match_reference():
    jcfg, tcfg = _xlstm()
    rng = np.random.default_rng(3)
    jp = JC.init_params(JS.mlstm_desc(jcfg), jax.random.PRNGKey(3))
    tp = _carry(jp)
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    for got, want in zip(TS._mlstm_qkvgates(tp, torch.from_numpy(x), tcfg),
                         JS._mlstm_qkvgates(jp, jnp.asarray(x), jcfg)):
        _hold(got, want, FP32_TOL)
    shape = JS.mlstm_state_shape(jcfg, 2)
    assert TS.mlstm_state_shape(tcfg, 2) == shape
    state = rng.normal(size=shape).astype(np.float32)
    xn = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, js = JS.mlstm_decode(jp, jnp.asarray(xn), jnp.asarray(state), jcfg)
    ty, ts = TS.mlstm_decode(tp, torch.from_numpy(xn),
                             torch.from_numpy(state), tcfg)
    _hold(ty, jy, FP32_TOL)
    _hold(ts, js, FP32_TOL)


def test_mamba_qkv_and_decode_match_reference():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("hymba-1.5b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("hymba-1.5b"),
                               compute_dtype="float32")
    rng = np.random.default_rng(4)
    jp = JC.init_params(JS.mamba_desc(jcfg), jax.random.PRNGKey(4))
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=jp["a_log"].shape),
                                    jnp.float32))
    tp = _carry(jp)
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    for got, want in zip(TS._mamba_qkv(tp, torch.from_numpy(x), tcfg),
                         JS._mamba_qkv(jp, jnp.asarray(x), jcfg)):
        _hold(got, want, FP32_TOL)
    shape = JS.mamba_state_shape(jcfg, 2)
    assert TS.mamba_state_shape(tcfg, 2) == shape
    state = rng.normal(size=shape).astype(np.float32)
    xn = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, js = JS.mamba_decode(jp, jnp.asarray(xn), jnp.asarray(state), jcfg)
    ty, ts = TS.mamba_decode(tp, torch.from_numpy(xn),
                             torch.from_numpy(state), tcfg)
    _hold(ty, jy, FP32_TOL)
    _hold(ts, js, FP32_TOL)


# ---- the families' serving paths ------------------------------------------------

def _serve_both(arch, s, prompt_len, steps, seed):
    """Prefill over `s` right-padded tokens with `prompt_len`, then
    `steps` greedy decode steps, in both packages on fp32 compute with
    query and GLA chunks of 16; yields (logits, logits, cache, cache)
    after prefill and after each step."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               compute_dtype="float32")
    jctx = JLM.ModelCtx(mesh=MESH, qc_prefill=16, gla_chunk=16)
    tctx = TLM.ModelCtx(qc_prefill=16, gla_chunk=16)
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(seed))
    tp = _carry(jp)
    toks = np.random.default_rng(seed).integers(1, jcfg.vocab, size=(2, s))
    with MESH:
        jl, jc = jax.jit(lambda p, t: JLM.forward_prefill(
            p, {"tokens": t}, jcfg, jctx, prompt_len=prompt_len))(
                jp, jnp.asarray(toks, jnp.int32))
    tl, tc = TLM.forward_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tcfg, tctx, prompt_len=prompt_len)
    yield tl, jl, tc, jc
    decode = jax.jit(lambda p, c, t, pos: JLM.forward_decode(
        p, c, t, pos, jcfg, jctx))
    for i in range(steps):
        nxt = _np(jl[:, -1]).argmax(-1)[:, None]
        with MESH:
            jl, jc = decode(jp, jc, jnp.asarray(nxt, jnp.int32),
                            jnp.int32(prompt_len + i))
        tl, tc = TLM.forward_decode(tp, tc, torch.from_numpy(nxt),
                                    prompt_len + i, tcfg, tctx)
        yield tl, jl, tc, jc


def _hold_tree(got, want, tol):
    got, want = TC.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.is_floating_point():
            _hold(g, w, tol)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prompt_len", [3, 16, 29])
def test_xlstm_masked_prefill_and_decode_match_reference(prompt_len):
    """xlstm-125m's smoke stack (sLSTM, then three mLSTM) over 32 padded
    positions: prompts ending inside the first chunk, at its end and in
    the second; the recurrent states take nothing from the padding, and
    four decode steps continue from them. fp32 within XLSTM_TOL (see
    `test_torch_lm.py`: the stack amplifies rounding; the largest
    difference measured here was 8.3e-5, in an mLSTM state after the
    decode steps)."""
    for tl, jl, tc, jc in _serve_both("xlstm-125m", 32, prompt_len, 4,
                                      prompt_len):
        _hold(tl, jl, XLSTM_TOL)
        _hold_tree(tc, jc, XLSTM_TOL)


@pytest.mark.parametrize("prompt_len", [5, 8, 21])
def test_hymba_ring_matches_reference(prompt_len):
    """Hymba's smoke config (window 8) over 32 padded positions: the ring
    for a prompt shorter than the window (slots past it hold 2^30), as
    long, and longer (the slots wrapped), its positions exactly; then
    twelve decode steps, which wrap the ring again."""
    for i, (tl, jl, tc, jc) in enumerate(_serve_both(
            "hymba-1.5b", 32, prompt_len, 12, prompt_len)):
        _hold(tl, jl, FP32_TOL)
        _hold_tree(tc, jc, FP32_TOL)
        slot_pos = tc["slot_pos"][0].tolist()
        end = prompt_len + i
        want = [p for p in range(max(0, end - 8), end)]
        assert sorted(p for p in slot_pos if p < 2 ** 30) == want
        assert all(p % 8 == j for j, p in enumerate(slot_pos)
                   if p < 2 ** 30)
