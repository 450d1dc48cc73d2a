"""The port's served LM against the JAX package on the CPU: descriptors,
the layer math, every family's prefill and cached decode (the dense
decoders, MoE and MLA, the xLSTM stack, Hymba, whisper's encoder-decoder),
greedy generation and the RAG example's path, with the reference's
parameters carried across by `params_from_numpy` (the two packages draw
initial weights from different generators). Also the small pieces ported
beside it: `query_features`, `route_from_predictions_loop`, `unregister`
and `timer`. The families' modules have their own files:
`test_torch_moe_mla.py`, `test_torch_ssm.py` and `test_torch_encdec.py`.

Tolerances: fp32 compute agrees to 1e-5 (FP32_TOL; the largest
difference measured over the five dense smoke configs was 2.1e-6). The
shipped bf16 compute rounds every product's output to bf16 in both
packages, in other summation orders: the largest logit or cache
difference measured over the five configs, six seeds, prefill with and
without `prompt_len` and four decode steps was 0.040, and BF16_TOL is
twice that (below the reference's own prefill/decode tolerance, 0.15).
Over the other five families and six seeds the largest measured
difference was 0.94 of these tolerances (deepseek-v2's bf16 logits),
except xlstm-125m, whose exponential gates at random init amplify
rounding about a hundredfold: one fp32 decode step from the reference's
own cache parts the two packages' logits by 1.6e-5 while no layer parts
them by more than 2e-6 on equal inputs (the reference's own jitted and
eager steps part by 4e-6). Over twelve seeds it needed 2.2e-5 in fp32
and 0.51 in bf16 (as rtol = atol), and 8.3e-5 in fp32 after four decode
steps (`test_torch_ssm.py`), so xlstm-125m is held to XLSTM_TOL: 2e-4
and 0.6.
Every array is drawn from a seeded numpy generator of its own.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import bench as jbench
from repro.ann import labels as jlb
from repro.ann.index import FilteredIndex as JIndex
from repro.ann.index import QueryBatch as JQB
from repro.ann.registry import get_method as j_get
from repro.ann.service import RouterService as JService
from repro.configs import base as jconfigs
from repro.core import features as JF
from repro.core.router import MLRouter as JRouter
from repro.core.training import METHOD_ORDER
from repro.data import ann_synth as jsynth
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh_compat
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import lm as JLM
from repro_torch import common as tcommon
from repro_torch.ann import engine as tengine
from repro_torch.ann import registry as treg
from repro_torch.ann.index import FilteredIndex as TIndex
from repro_torch.ann.index import QueryBatch as TQB
from repro_torch.ann.predicates import PREDICATES, Predicate
from repro_torch.ann.service import AsyncBatchQueue
from repro_torch.ann.service import RouterService as TService
from repro_torch.configs import base as tconfigs
from repro_torch.core import features as TF
from repro_torch.core.mlp import Scaler
from repro_torch.core.router import MLRouter as TRouter
from repro_torch.core.table import BenchmarkTable
from repro_torch.data import ann_synth as tsynth
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import lm as TLM

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "router_all"
DENSE = ["qwen2-0.5b", "internlm2-1.8b", "internlm2-20b", "codeqwen1.5-7b",
         "chameleon-34b"]
ARCH_IDS = jconfigs.ARCH_IDS
FP32_TOL = 1e-5
BF16_TOL = 0.08
XLSTM_TOL = {"float32": 2e-4, "bfloat16": 0.6}
# full-width parameter counts (the reference's count_params)
FULL_PARAMS = {"qwen2-0.5b": 630_167_424,
               "deepseek-v2-236b": 244_188_441_600,
               "xlstm-125m": 114_491_136, "hymba-1.5b": 1_350_610_400,
               "whisper-medium": 812_523_520}
TINY = ("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)
MESH = make_mesh_compat((1, 1), ("data", "model"))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _carry(jparams):
    return TC.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _cfgs(arch, dtype=None):
    j, t = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if dtype is not None:
        j = dataclasses.replace(j, compute_dtype=dtype)
        t = dataclasses.replace(t, compute_dtype=dtype)
    return j, t


# ---- (1) descriptors -----------------------------------------------------

def _same_tree(a, b, path=()):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same_tree(a[k], b[k], path + (k,))
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, path + (i,))
        return
    assert JC.is_desc(a) and TC.is_desc(b), path
    assert (tuple(a.shape), a.one, a.zero, a.scale, a.tp, a.fsdp) == \
        (tuple(b.shape), b.one, b.zero, b.scale, b.tp, b.fsdp), path
    assert jnp.dtype(a.dtype).name == str(b.dtype).removeprefix("torch."), \
        path


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_desc_matches_reference(arch, size):
    """Parameter and cache trees (stacked, or tuples of per-layer dicts
    for xLSTM's mixed kinds), shapes, dtypes and counts."""
    get = "get_config" if size == "full" else "get_smoke_config"
    jcfg = getattr(jconfigs, get)(arch)
    tcfg = getattr(tconfigs, get)(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jd, td = JLM.model_desc(jcfg), TLM.model_desc(tcfg)
    _same_tree(jd, td)
    assert TC.count_params(td) == JC.count_params(jd)
    _same_tree(JLM.cache_desc(jcfg, 2, 64), TLM.cache_desc(tcfg, 2, 64))
    assert TLM.layer_kinds(tcfg) == JLM.layer_kinds(jcfg)
    if size == "full" and arch in FULL_PARAMS:
        assert TC.count_params(td) == FULL_PARAMS[arch]


def test_configs_registry_and_shapes():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    treg_, jreg = tconfigs.registry(), jconfigs.registry()
    assert {k: dataclasses.asdict(v) for k, v in treg_.items()} == \
        {k: dataclasses.asdict(v) for k, v in jreg.items()}
    for arch in tconfigs.ARCH_IDS:
        for s in tconfigs.SHAPES.values():
            assert tconfigs.shape_supported(treg_[arch], s) == \
                jconfigs.shape_supported(jreg[arch], jconfigs.SHAPES[s.name])


# ---- (2) the layer math ----------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        TC.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
        _np(JC.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=FP32_TOL, atol=FP32_TOL)
    bias = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        TC.layer_norm(_t(x), _t(scale), _t(bias)).numpy(),
        _np(JC.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias))), rtol=FP32_TOL, atol=FP32_TOL)
    for theta in (1e4, 1e6):
        pos = np.arange(9) + 40
        np.testing.assert_allclose(
            TC.apply_rope(_t(x), torch.from_numpy(pos), theta).numpy(),
            _np(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=FP32_TOL, atol=FP32_TOL)
    # the cast points: bf16 in, bf16 out, the normalisation in fp32
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = TC.rms_norm(_t(x).to(torch.bfloat16), _t(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(JC.rms_norm(xb, jnp.asarray(scale))))


@pytest.mark.parametrize("s,qc,window", [(16, 8, 0), (15, 4, 0), (12, 5, 3),
                                         (20, 64, 6)])
def test_attend_chunked_matches_reference(s, qc, window):
    """A qc that divides s, one that does not (`pick_qc` takes the largest
    divisor), a sliding window, and a qc past s."""
    assert TA.pick_qc(s, qc) == JA.pick_qc(s, qc)
    rng = np.random.default_rng(s * 100 + qc)
    q = rng.normal(size=(2, s, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    for causal in (True, False):
        kw = dict(causal=causal, window=window, q_offset=0, qc=qc, n_rep=3)
        want = JA._attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
        got = TA._attend_chunked(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=FP32_TOL,
                                   atol=FP32_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_prefill_and_decode_match_reference(window):
    jcfg, tcfg = _cfgs("qwen2-0.5b", "float32")
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    rng = np.random.default_rng(7 + window)
    jp = JC.init_params(JA.gqa_desc(jcfg), jax.random.PRNGKey(3))
    jp = {k: v + 0.1 for k, v in jp.items()}      # non-zero biases
    tp = _carry(jp)
    s = 12
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    jy, jc = JA.gqa_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                            qc=5)
    ty, tc = TA.gqa_prefill(tp, _t(x), tcfg, torch.from_numpy(pos), qc=5)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=FP32_TOL,
                               atol=FP32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=FP32_TOL, atol=FP32_TOL)
    # decode into a preallocated cache of 16 slots at position 12
    t_slots = 16
    kc = rng.normal(size=(2, t_slots, 2, jcfg.hd)).astype(np.float32)
    vc = rng.normal(size=(2, t_slots, 2, jcfg.hd)).astype(np.float32)
    xn = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    jy, jc = JA.gqa_decode(jp, jnp.asarray(xn), {"k": jnp.asarray(kc),
                                                 "v": jnp.asarray(vc)},
                           jcfg, jnp.int32(s))
    cache = {"k": _t(kc), "v": _t(vc)}
    ty, tc = TA.gqa_decode(tp, _t(xn), cache, tcfg, s)
    assert tc["k"] is cache["k"]                   # written in place
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=FP32_TOL,
                               atol=FP32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=FP32_TOL, atol=FP32_TOL)
    with pytest.raises(IndexError):
        TA.gqa_decode(tp, _t(xn), cache, tcfg, t_slots)


def test_mlp_apply_matches_reference():
    jcfg, tcfg = _cfgs("qwen2-0.5b", "float32")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    from repro.models import moe as JM
    from repro_torch.models import moe as TM
    for gated in (True, False):
        jp = JC.init_params(JM.mlp_desc(jcfg, gated=gated),
                            jax.random.PRNGKey(2))
        act = jax.nn.silu if gated else jax.nn.gelu
        want = JM.mlp_apply(jp, jnp.asarray(x), gated=gated, act=act)
        got = TM.mlp_apply(_carry(jp), _t(x), gated=gated,
                           act=torch.nn.functional.silu if gated
                           else TM.gelu)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=FP32_TOL,
                                   atol=FP32_TOL)


# ---- (3) the forwards --------------------------------------------------------

_JITS = {}


def _ref_forwards(jcfg, qc, fresh=False):
    """The reference's jitted prefill and decode (cached unless `fresh`:
    a spy installed in the reference's modules needs a new trace)."""
    key = (jcfg, qc)
    if fresh or key not in _JITS:
        ctx = JLM.ModelCtx(mesh=MESH, qc_prefill=qc, gla_chunk=qc)
        _JITS[key] = (
            jax.jit(lambda p, b, pl: JLM.forward_prefill(
                p, b, jcfg, ctx, prompt_len=pl), static_argnums=2),
            jax.jit(lambda p, c, t, pos: JLM.forward_decode(
                p, c, t, pos, jcfg, ctx)))
    return _JITS[key]


def _hold(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _hold_argmax(got, want, tol):
    """The argmax equal wherever the reference's top-2 gap exceeds 2·tol."""
    w = _np(want).reshape(-1, want.shape[-1])
    g = got.float().numpy().reshape(-1, w.shape[-1])
    top2 = np.sort(w, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])


class _GateSpy:
    """What each MoE call of both packages dispatched, in call order: the
    chosen experts and whether each assignment reaches its expert (its
    slot in the table holds its token; an assignment past capacity, or
    the last in-capacity one of an expert that overflowed, does not).
    The port's through a wrapper of `moe.dispatch` (with each token's
    gap between its k-th and k+1-th gate logit), the reference's through
    `jax.debug.callback`s on the arguments of the one `take_along_axis`
    (the flattened top-k experts) and the one `maximum` (the slot table)
    of its `_moe_local`. `parted_rows` names the batch rows whose
    dispatch parts: in bf16 the packages' gate inputs differ by rounding,
    and one flipped expert moves a row far past any rounding tolerance.
    A row's first expert flip, in layer order, is at a near-tie of the
    port's gate (gap < NEAR_TIE); a flip moves its experts' loads, so
    other rows' capacity drops may part after it (never before), and a
    parted row's later layers see other inputs and part anywhere."""

    NEAR_TIE = 0.05

    def __init__(self, monkeypatch):
        from repro.models import moe as JM
        from repro_torch.models import moe as TM
        self.port, self.ref = [], []
        self.ref_tables = []
        dispatch = TM.dispatch

        def port_dispatch(x, wg, cfg):
            g = dispatch(x, wg, cfg)
            top = torch.sort(g["logits"], -1, descending=True).values
            k = cfg.experts_per_token
            self.port.append((g["flat_e"].numpy(), g["table"].numpy(),
                              (top[:, k - 1] - top[:, k]).numpy()))
            return g

        spy = self

        class Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            def take_along_axis(self, a, idx, axis):
                jax.debug.callback(
                    lambda v: spy.ref.append(np.asarray(v)[:, 0]), idx)
                return jnp.take_along_axis(a, idx, axis=axis)

            def maximum(self, a, b):
                jax.debug.callback(
                    lambda v: spy.ref_tables.append(np.asarray(v)), a)
                return jnp.maximum(a, b)

        monkeypatch.setattr(TM, "dispatch", port_dispatch)
        monkeypatch.setattr(JM, "jnp", Jnp())

    @staticmethod
    def _reaches(flat_e, table, k):
        """[T·k] bool: the assignment's token sits in one of its expert's
        slots."""
        tok = np.arange(flat_e.size) // k
        return (table[flat_e] == tok[:, None]).any(-1)

    def parted_rows(self, s: int, k: int, parted: set) -> set:
        """`parted` and the rows (of S tokens each) whose dispatch parted
        in the calls since the last read (see the class docstring)."""
        assert len(self.port) == len(self.ref) == len(self.ref_tables) > 0
        rows = set(parted)
        for (fe, table, gap), re_, rtable in zip(self.port, self.ref,
                                                 self.ref_tables):
            # the chosen sets (an order swap within a token's k moves
            # nothing: each expert sees the token once, in token order)
            tok = np.nonzero((np.sort(fe.reshape(-1, k), -1) != np.sort(
                re_.reshape(-1, k), -1)).any(-1))[0]
            new = [t for t in tok if t // s not in rows]
            assert (gap[new] < self.NEAR_TIE).all(), gap[new]
            rows.update(int(t) // s for t in tok)
            drop = np.unique(np.nonzero(self._reaches(fe, table, k)
                                        != self._reaches(re_, rtable, k)
                                        )[0] // k)
            assert rows or not drop.size, "drops part with no expert flip"
            rows.update(int(t) // s for t in drop)
        for rec in (self.port, self.ref, self.ref_tables):
            rec.clear()
        return rows


def _keep(x, rows, axis):
    """x without the batch rows `rows` along `axis`, as numpy."""
    x = x.float().numpy() if isinstance(x, torch.Tensor) else _np(x)
    return np.delete(x, sorted(rows), axis=axis)


def _hold_cache(got, want, tol):
    """Every leaf of the port's cache (in `jax.tree.leaves` order) against
    the reference's: shape and dtype equal, values within `tol` (integer
    leaves, Hymba's ring positions, exactly)."""
    got, want = TC.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
        if g.is_floating_point():
            _hold(g, w, tol)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _tokens(jcfg, rng, b, s):
    """[B, S] tokens (and whisper's 0.05·N(0, 1) frame embeddings) as the
    reference's and the port's batches."""
    toks = rng.integers(1, jcfg.vocab, size=(b, s))
    jt = {"tokens": jnp.asarray(toks, jnp.int32)}
    tt = {"tokens": torch.from_numpy(toks)}
    if jcfg.encoder_layers:
        enc = (0.05 * rng.normal(size=(b, jcfg.encoder_seq, jcfg.d_model))
               ).astype(np.float32)
        jt["enc_inputs"], tt["enc_inputs"] = jnp.asarray(enc), _t(enc)
    return jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forwards_match_reference(arch, dtype, monkeypatch):
    """Prefill without and with `prompt_len` (right-padded tokens), then
    three greedy decode steps into the prefill's cache: logits and every
    cache leaf against the reference's. 48 tokens with query and GLA
    chunks of 16; prompt_len 41 takes Hymba's 8-slot ring past a wrap.
    The MoE families in bf16 hold every row whose experts both packages
    chose alike; a row parted at a near-tie of the gate (`_GateSpy`)
    drops out of the comparison from then on."""
    jcfg, tcfg = _cfgs(arch, dtype)
    tol = XLSTM_TOL[dtype] if arch == "xlstm-125m" else \
        FP32_TOL if dtype == "float32" else BF16_TOL
    spy = _GateSpy(monkeypatch) if jcfg.is_moe and dtype == "bfloat16" \
        else None
    prefill, decode = _ref_forwards(jcfg, 16, fresh=spy is not None)
    tctx = TLM.ModelCtx(qc_prefill=16, gla_chunk=16)
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(5))
    tp = _carry(jp)
    jt, tt = _tokens(jcfg, np.random.default_rng(ARCH_IDS.index(arch)), 3,
                     48)
    parted = set()

    def hold(tl, jl, s, tc=None, jc=None):
        if spy is not None:
            parted.update(spy.parted_rows(s, jcfg.experts_per_token,
                                          parted))
            assert len(parted) < 3, "every row parted"
        if parted:
            np.testing.assert_allclose(_keep(tl, parted, 0),
                                       _keep(jl, parted, 0), rtol=tol,
                                       atol=tol)
            for g, w in zip(TC.tree_leaves(tc or {}), jax.tree.leaves(jc)):
                np.testing.assert_allclose(_keep(g, parted, 1),
                                           _keep(w, parted, 1), rtol=tol,
                                           atol=tol)
            return
        _hold(tl, jl, tol)
        _hold_argmax(tl, jl, tol)
        if tc is not None:
            _hold_cache(tc, jc, tol)

    with MESH:
        jl, _ = prefill(jp, jt, None)
    tl, _ = TLM.forward_prefill(tp, tt, tcfg, tctx)
    assert tl.shape == (3, 1, jcfg.vocab) and tl.dtype == torch.float32
    hold(tl, jl, 48)
    parted.clear()                    # the next prefill starts afresh
    with MESH:
        jl, jc = prefill(jp, jt, 41)
    tl, tc = TLM.forward_prefill(tp, tt, tcfg, tctx, prompt_len=41)
    assert isinstance(tc, tuple) == (arch == "xlstm-125m")
    hold(tl, jl, 48, tc, jc)
    for pos in (41, 42, 43):
        nxt = _np(jl[:, -1]).argmax(-1)[:, None]
        with MESH:
            jl, jc = decode(jp, jc, jnp.asarray(nxt, jnp.int32),
                            jnp.int32(pos))
        tl, tc2 = TLM.forward_decode(tp, tc, torch.from_numpy(nxt), pos,
                                     tcfg, tctx)
        assert tc2 is tc                               # updated in place
        hold(tl, jl, 1, tc, jc)


# ---- (4) generation ------------------------------------------------------------

def test_generate_greedy_equals_reference():
    """qwen2 smoke on fp32 compute: 4 prompts of 36 tokens, 8 new."""
    jcfg, tcfg = _cfgs("qwen2-0.5b", "float32")
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    prompts = [list(map(int, rng.integers(1, 200, size=36)))
               for _ in range(4)]
    want = jserve.generate(jp, jcfg, prompts, max_new=8)
    got = tserve.generate(_carry(jp), tcfg, prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)
    toks, lens = tserve.pad_prompts(prompts, 64)
    jt, jlens = jserve.pad_prompts(prompts, 64)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    with pytest.raises(ValueError, match="uniform prompt lengths"):
        tserve.generate(_carry(jp), tcfg, [[1, 2, 3], [1, 2]], max_new=2)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in DENSE])
def test_generate_families_equal_reference(arch):
    """`generate`'s greedy tokens equal the reference's for each family
    beside the dense decoders, on fp32 compute: 3 prompts of 20 tokens,
    6 new (the cache holds 64 positions; Hymba's 8-slot ring wraps);
    whisper gets the reference launcher's 0.05·N(0, 1) frame
    embeddings."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    prompts = [list(map(int, rng.integers(1, 200, size=20)))
               for _ in range(3)]
    enc = None
    if jcfg.encoder_layers:
        enc = (0.05 * rng.normal(size=(3, jcfg.encoder_seq, jcfg.d_model))
               ).astype(np.float32)
    want = jserve.generate(jp, jcfg, prompts, max_new=6,
                           enc_inputs=None if enc is None
                           else jnp.asarray(enc))
    got = tserve.generate(_carry(jp), tcfg, prompts, max_new=6,
                          enc_inputs=enc)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_generate_sampled_is_seeded():
    _, tcfg = _cfgs("qwen2-0.5b")
    params = TC.init_params(TLM.model_desc(tcfg), seed=0, device="cpu")
    prompts = [[5, 6, 7, 8]] * 3
    a = tserve.generate(params, tcfg, prompts, max_new=6, greedy=False,
                        seed=3)
    b = tserve.generate(params, tcfg, prompts, max_new=6, greedy=False,
                        seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < tcfg.vocab)).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """The reference's own check (tests/test_models.py) on the port, as
    shipped in bf16: prefill over s tokens gives the next-token logits of
    prefill over s - 1 followed by one decode step of token s - 1. The
    MoE families run at capacity_factor E/k, where nothing drops: the two
    prefills dispatch different token sets, so capacity drops alone
    could part them."""
    cfg = tconfigs.get_smoke_config(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    ctx = TLM.ModelCtx(qc_prefill=16, gla_chunk=16)
    params = TC.init_params(TLM.model_desc(cfg), seed=1, device="cpu")
    rng = np.random.default_rng(0)
    s = 16
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, size=(2, s)))
    batch = {"tokens": toks}
    if cfg.encoder_layers:
        batch["enc_inputs"] = torch.from_numpy(0.05 * rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model))).float()
    full, _ = TLM.forward_prefill(params, batch, cfg, ctx)
    _, cache = TLM.forward_prefill(params, batch, cfg, ctx,
                                   prompt_len=s - 1)
    lg_b, _ = TLM.forward_decode(params, cache, toks[:, s - 1:s], s - 1,
                                 cfg, ctx)
    a, b = full[:, -1].numpy(), lg_b[:, -1].numpy()
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=0.15, atol=0.15)


# ---- (5) the RAG path ------------------------------------------------------------

@pytest.fixture(scope="module")
def rag_services():
    """The tiny spec in both packages behind each package's
    `RouterService` with `router_all`; table-B rows for the tiny dataset
    measured once, by the JAX package, and added to both routers."""
    jds = jsynth.synthesize(jsynth.DatasetSpec(*TINY))
    jfx = JIndex(jds)
    jr, tr = JRouter.load(str(ASSET)), TRouter.load(str(ASSET))
    for pred in PREDICATES:
        qs = jsynth.make_queries(jds, pred, 20, seed=1)
        for name in METHOD_ORDER:
            m = j_get(name)
            for setting in m.param_settings():
                r = jbench.run_method(jfx, m, setting, qs)
                for router in (jr, tr):
                    router.table.add(jds.name, int(pred), name, r.ps_id,
                                     r.mean_recall, r.qps)
    tds = tsynth.synthesize(tsynth.DatasetSpec(*TINY))
    tfx = TIndex(tds, device="cpu")
    yield JService(jfx, jr, t=0.9), TService(tfx, tr, t=0.9), jds, tds
    tfx.close()
    jfx.close()


def test_rag_path_matches_reference(rag_services):
    """`examples/rag_serve.py`'s path at the tiny spec: the LM embeds
    (the first `dim` prefill logits, bf16 as shipped, within BF16_TOL of
    the reference's LM on the same weights); the port's embeddings are
    routed through both packages' services with the same decisions and
    ids, and through the port's queue with the batched answers; every id
    passes its predicate; then generation conditioned on the ids (fp32
    compute) gives the reference's tokens."""
    jsvc, tsvc, jds, tds = rag_services
    jcfg, tcfg = _cfgs("qwen2-0.5b")
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(0))
    tp = _carry(jp)
    rng = np.random.default_rng(0)
    b = 12
    prompts = rng.integers(1, 400, size=(b, 32))
    preds = [Predicate(int(p)) for p in rng.integers(0, 3, size=b)]
    qbms = np.zeros((b, tds.bitmaps.shape[1]), np.uint32)
    for i in range(b):
        src = sorted(jlb.unpack_one(jds.bitmaps[rng.integers(0, jds.n)]))
        qbms[i] = jlb.pack_one(src[: 1 + int(preds[i] == Predicate.OR)],
                               jds.universe)
    prefill, _ = _ref_forwards(jcfg, 32)
    with MESH:
        jl, _ = prefill(jp, {"tokens": jnp.asarray(prompts, jnp.int32)},
                        None)
    tl, _ = TLM.forward_prefill(tp, {"tokens": torch.from_numpy(prompts)},
                                tcfg, TLM.ModelCtx(qc_prefill=32,
                                                   gla_chunk=32))
    emb = tl[:, 0, :tds.dim].numpy().astype(np.float32)
    np.testing.assert_allclose(emb, _np(jl[:, 0, :jds.dim]), rtol=BF16_TOL,
                               atol=BF16_TOL)
    retrieved = np.full((b, 5), -1, np.int64)
    with AsyncBatchQueue(tsvc, max_batch=8, max_wait_ms=5.0) as queue:
        futs = [queue.submit(emb[i], qbms[i], int(preds[i]), k=5)
                for i in range(b)]
        queued = [f.result(timeout=60) for f in futs]
    for pred in PREDICATES:
        rows = [i for i in range(b) if preds[i] == pred]
        if not rows:
            continue
        got = tsvc.search(TQB(emb[rows], qbms[rows], int(pred), 5))
        want = jsvc.search(JQB(emb[rows], qbms[rows], int(pred), 5))
        assert [tuple(d) for d in got.decisions] == \
            [tuple(d) for d in want.decisions]
        np.testing.assert_array_equal(got.ids, want.ids)
        for j, i in enumerate(rows):
            np.testing.assert_array_equal(queued[i].ids, got.ids[j])
            retrieved[i] = got.ids[j]
            ok = tds.matching_mask(qbms[i], pred)
            assert all(ok[x] for x in got.ids[j] if x >= 0)
    assert (retrieved >= 0).any(1).all()
    jcfg32, tcfg32 = _cfgs("qwen2-0.5b", "float32")
    aug = [list(map(int, prompts[i])) +
           [int(x) % tcfg.vocab for x in retrieved[i] if x >= 0][:4]
           for i in range(b)]
    width = max(len(a) for a in aug)
    aug = [a + [0] * (width - len(a)) for a in aug]
    np.testing.assert_array_equal(
        tserve.generate(tp, tcfg32, aug, max_new=8),
        jserve.generate(jp, jcfg32, aug, max_new=8))


def test_rag_example_runs_on_cpu(tmp_path):
    """`examples/torch_rag_serve.py --device cpu --requests 4` end to end
    (about 10 s here): offline stage, the queue, generation."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_ARTIFACTS=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_rag_serve.py"),
         "--device", "cpu", "--requests", "4"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests" in out.stdout
    assert "retrieval hit rate: 1.00" in out.stdout


def test_serve_launcher_encoder_decoder_on_cpu():
    """The launcher's whisper smoke run: its stand-in frame embeddings
    through the encoder, then generation."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--arch", "whisper-medium", "--device", "cpu", "--batch", "2",
         "--max-new", "4"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "shape (2, 4)" in out.stdout


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--max-new", "4"], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "shape (2, 4)" in out.stdout


# ---- (6) the small pieces -------------------------------------------------------

def test_query_features_match_reference(rag_services):
    _, _, jds, tds = rag_services
    jdsf, tdsf = JF.dataset_features(jds), TF.dataset_features(tds)
    np.testing.assert_array_equal(tdsf.label_freq, jdsf.label_freq)
    for pred in PREDICATES:
        qs = jsynth.make_queries(jds, pred, 20, seed=4,
                                 with_ground_truth=False)
        got = TF.query_feature_arrays(tds, tdsf, qs.bitmaps, pred)
        for i in range(20):
            want = JF.query_features(jds, jdsf, qs.bitmaps[i], pred)
            one = TF.query_features(tds, tdsf, qs.bitmaps[i], pred)
            assert one == want
            assert {k: float(v[i]) for k, v in got.items()} == \
                pytest.approx(one, rel=1e-12, abs=0)


@pytest.mark.parametrize("seed", range(4))
def test_route_from_predictions_loop_matches(seed):
    """Randomised tables and r̂: the port's loop equals the reference's
    loop and the port's vectorised Algorithm 2, fallbacks and ties
    included; an unknown dataset falls back with no setting."""
    rng = np.random.default_rng(seed)
    methods = [f"m{j}" for j in range(int(rng.integers(2, 6)))]
    rows = []
    for pt in range(3):
        for m in methods:
            for ps_id in ("a", "b", "c"):
                if rng.random() < 0.8:
                    rows.append(("ds", pt, m, ps_id,
                                 float(rng.uniform(0.5, 1.0)),
                                 float(rng.choice([10.0, 500.0, 5000.0]))))
    from repro.core.mlp import Scaler as JScaler
    from repro.core.table import BenchmarkTable as JTable
    tables = (BenchmarkTable.new(), JTable.new())
    for row in rows:
        for table in tables:
            table.add(*row[:4], recall=row[4], qps=row[5])
    kw = dict(feature_names=["selectivity", "lid_mean", "pred"],
              methods=methods, models={})
    tr = TRouter(**kw, scaler=Scaler(np.zeros(5), np.ones(5)),
                 table=tables[0])
    jr = JRouter(**kw, scaler=JScaler(np.zeros(5), np.ones(5)),
                 table=tables[1])
    r_hat = rng.uniform(0.3, 1.05, size=(48, len(methods)))
    r_hat[:4] = 0.95                                  # ties in r̂
    for pred in Predicate:
        for t in (0.7, 0.9, 0.999):
            got = tr.route_from_predictions_loop(r_hat, "ds", pred, t)
            assert got == jr.route_from_predictions_loop(r_hat, "ds", pred,
                                                         t)
            assert got == tr.route_from_predictions(r_hat, "ds", pred, t)
        assert tr.route_from_predictions_loop(r_hat[:2], "unknown", pred,
                                              0.9) == \
            [(methods[int(np.argmax(r))], None) for r in r_hat[:2]]


def test_unregister_method():
    class Dummy(tengine.Method):
        name = "dummy_lm_test"

        def param_settings(self):
            return [tengine.ps("d1")]

    m = Dummy()
    try:
        treg.register_method(m, candidate=False)
        assert treg.get_method("dummy_lm_test") is m
        assert "dummy_lm_test" in list(treg.all_methods())
    finally:
        treg.unregister_method("dummy_lm_test")
    assert "dummy_lm_test" not in list(treg.all_methods())
    with pytest.raises(KeyError, match="unknown method"):
        treg.get_method("dummy_lm_test")
    treg.unregister_method("dummy_lm_test")           # absent: a no-op
    reg = treg.MethodRegistry()
    reg.register(m)
    reg.unregister("dummy_lm_test")
    assert reg.names() == [] and not reg.is_candidate("dummy_lm_test")


def test_timer():
    with tcommon.timer() as t:
        assert t() == 0.0
        time.sleep(0.01)
    assert 0.01 <= t() < 5.0
    assert t() == t()                                  # frozen after exit


# ---- (7) initialisation ----------------------------------------------------------

def test_init_params_seeded_and_as_declared():
    cfg = tconfigs.get_smoke_config("qwen2-0.5b")
    desc = TLM.model_desc(cfg)
    a = TC.init_params(desc, seed=0, device="cpu")
    b = TC.init_params(desc, seed=0, device="cpu")
    c = TC.init_params(desc, seed=1, device="cpu")
    la, lb_, lc = (TC.tree_leaves(x) for x in (a, b, c))
    ld = TC.tree_leaves(desc)
    assert len(la) == len(ld) == len(lc)
    assert sorted(a) == sorted(desc) and sorted(a["layers"]) == \
        sorted(desc["layers"])
    for d, x, y, z in zip(ld, la, lb_, lc):
        assert tuple(x.shape) == d.shape and x.dtype == torch.float32
        assert torch.equal(x, y)
        if d.one:
            assert torch.equal(x, torch.ones_like(x))
        elif d.zero:
            assert torch.equal(x, torch.zeros_like(x))
        else:
            assert not torch.equal(x, z)
            std = d.scale if d.scale is not None else 1.0 / np.sqrt(
                d.shape[0] if len(d.shape) <= 2 else np.prod(d.shape[:-1]))
            assert abs(float(x.std()) / std - 1.0) < 0.1
            assert abs(float(x.mean())) < 0.1 * std
    # the JAX package's flatten order: the same leaf count and shapes
    jd = JLM.model_desc(jconfigs.get_smoke_config("qwen2-0.5b"))
    jl = jax.tree.leaves(jd, is_leaf=JC.is_desc)
    assert [tuple(x.shape) for x in jl] == [d.shape for d in ld]
    bf = TC.init_params(desc, seed=0, device="cpu", dtype="bfloat16")
    assert all(x.dtype == torch.bfloat16 for x in TC.tree_leaves(bf))
    np.testing.assert_array_equal(
        TC.tree_leaves(bf)[3].float().numpy(),
        la[3].to(torch.bfloat16).float().numpy())


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """Without a card the LM's entry points raise on their default
    device instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("qwen2-0.5b")
    jp = JC.init_params(JLM.model_desc(cfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke"])
    for call in (lambda: TC.init_params(TLM.model_desc(cfg), seed=0),
                 lambda: TC.params_from_numpy(
                     jax.tree.map(np.asarray, jp)),
                 tserve.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_params_from_numpy_keeps_keys_and_dtypes():
    jcfg = jconfigs.get_smoke_config("qwen2-0.5b")
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(0))
    tp = _carry(jp)
    for x, y in zip(jax.tree.leaves(jp), TC.tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    jb = JC.cast_floats(jp, jnp.bfloat16)
    tb = _carry(jb)
    assert all(x.dtype == torch.bfloat16 for x in TC.tree_leaves(tb))
    np.testing.assert_array_equal(
        TC.tree_leaves(tb)[0].float().numpy(),
        np.asarray(jax.tree.leaves(jb)[0].astype(jnp.float32)))
    assert TC.tree_leaves(TC.cast_floats(tb, "bfloat16"))[0] is \
        TC.tree_leaves(tb)[0]
