"""The port's encoder-decoder (whisper) against the JAX package on the CPU:
the encoder over frame embeddings, cross-attention's K/V and attend, and
the decoder's prefill and decode with the cross K/V cached (`xk`, `xv`).

Tolerances: FP32_TOL = 1e-5 (fp32) and BF16_TOL = 0.08 (bf16). Every
array comes from a seeded numpy generator of its own; the reference's
parameters are carried across with `params_from_numpy`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jconfigs
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh_compat
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import lm as JLM
from repro_torch.configs import base as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import lm as TLM

FP32_TOL = 1e-5
BF16_TOL = 0.08
MESH = make_mesh_compat((1, 1), ("data", "model"))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _carry(jparams):
    return TC.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _hold(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _cfgs(dtype, **kw):
    return tuple(dataclasses.replace(mod.get_smoke_config("whisper-medium"),
                                     compute_dtype=dtype, **kw)
                 for mod in (jconfigs, tconfigs))


def _frames(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    return (0.05 * rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
            ).astype(np.float32)


def test_pick_qc_takes_whisper_encoder_chunk():
    """The encoder's 1,500 frames under qc_train 1,024 take chunks of
    750 in both packages."""
    assert TA.pick_qc(1500, 1024) == JA.pick_qc(1500, 1024) == 750
    assert TLM.ModelCtx().qc_train == JLM.ModelCtx().qc_train == 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qc_train", [1024, 8])
def test_encoder_matches_reference(qc_train, dtype):
    """`_encode` over 30 frames (the smoke config's encoder at
    encoder_seq 30): bidirectional attention in one chunk, and in chunks
    of 6 (`pick_qc(30, 8)`)."""
    jcfg, tcfg = _cfgs(dtype, encoder_seq=30)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(2))
    tp = TC.cast_floats(_carry(jp), getattr(torch, dtype))
    enc = _frames(jcfg, qc_train)
    with MESH:
        want = JLM._encode(JC.cast_floats(jp, jnp.dtype(dtype)),
                           jnp.asarray(enc), jcfg,
                           JLM.ModelCtx(mesh=MESH, qc_train=qc_train))
    got = TLM._encode(tp, torch.from_numpy(enc), tcfg,
                      TLM.ModelCtx(qc_train=qc_train))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _hold(got, want, tol)


@pytest.mark.parametrize("qc", [1, 4, 1024])
def test_cross_kv_and_attend_match_reference(qc):
    """Cross K/V from encoder outputs and unmasked attention of 12 decoder
    positions over 16 frames: one query at a time (decode's chunk), in
    chunks of 4, and in one chunk."""
    jcfg, tcfg = _cfgs("float32")
    rng = np.random.default_rng(qc)
    jp = JC.init_params(JA.cross_desc(jcfg), jax.random.PRNGKey(qc))
    tp = _carry(jp)
    enc_out = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    jkv = JA.cross_kv(jp, jnp.asarray(enc_out), jcfg)
    tkv = TA.cross_kv(tp, torch.from_numpy(enc_out), tcfg)
    for name in ("k", "v"):
        assert tuple(tkv[name].shape) == (2, 16, jcfg.n_heads, jcfg.hd)
        _hold(tkv[name], jkv[name], FP32_TOL)
    _hold(TA.cross_attend(tp, torch.from_numpy(x), tkv, tcfg, qc=qc),
          JA.cross_attend(jp, jnp.asarray(x), jkv, jcfg, qc=qc), FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_prefill_and_decode_match_reference(dtype):
    """The smoke model over 20 decoder positions (prompt_len 13) and its
    16 frames, then four decode steps: logits and the cache (self K/V,
    and `xk`/`xv`, which equal `cross_kv` of the encoder's output and do
    not move while decode runs)."""
    jcfg, tcfg = _cfgs(dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    jctx = JLM.ModelCtx(mesh=MESH, qc_prefill=8, gla_chunk=8)
    tctx = TLM.ModelCtx(qc_prefill=8, gla_chunk=8)
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(3))
    tp = _carry(jp)
    enc = _frames(jcfg, 3)
    toks = np.random.default_rng(4).integers(1, jcfg.vocab, size=(2, 20))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "enc_inputs": jnp.asarray(enc)}
    tb = {"tokens": torch.from_numpy(toks), "enc_inputs":
          torch.from_numpy(enc)}
    with MESH:
        jl, jc = jax.jit(lambda p, b: JLM.forward_prefill(
            p, b, jcfg, jctx, prompt_len=13))(jp, jb)
    tl, tc = TLM.forward_prefill(tp, tb, tcfg, tctx, prompt_len=13)
    assert sorted(tc) == ["k", "v", "xk", "xv"]
    assert tuple(tc["xk"].shape) == (jcfg.n_layers, 2, jcfg.encoder_seq,
                                     jcfg.n_heads, jcfg.hd)
    _hold(tl, jl, tol)
    for name in tc:
        _hold(tc[name], jc[name], tol)
    params = TC.cast_floats(tp, getattr(torch, dtype))
    enc_out = TLM._encode(params, tb["enc_inputs"], tcfg, tctx)
    for i in range(jcfg.n_layers):
        kv = TA.cross_kv(TLM._layer(params["layers"], i)["cross"], enc_out,
                         tcfg)
        torch.testing.assert_close(tc["xk"][i], kv["k"], rtol=0, atol=0)
        torch.testing.assert_close(tc["xv"][i], kv["v"], rtol=0, atol=0)
    xk = tc["xk"].clone()
    decode = jax.jit(lambda p, c, t, pos: JLM.forward_decode(
        p, c, t, pos, jcfg, jctx))
    for pos in range(13, 17):
        nxt = _np(jl[:, -1]).argmax(-1)[:, None]
        with MESH:
            jl, jc = decode(jp, jc, jnp.asarray(nxt, jnp.int32),
                            jnp.int32(pos))
        tl, tc = TLM.forward_decode(tp, tc, torch.from_numpy(nxt), pos,
                                    tcfg, tctx)
        _hold(tl, jl, tol)
        for name in tc:
            _hold(tc[name], jc[name], tol)
    assert torch.equal(tc["xk"], xk)


def test_encoder_decoder_needs_frames():
    _, tcfg = _cfgs("float32")
    params = TC.init_params(TLM.model_desc(tcfg), seed=0, device="cpu")
    with pytest.raises(ValueError, match="enc_inputs"):
        TLM.forward_prefill(params, {"tokens": torch.ones(
            (1, 4), dtype=torch.long)}, tcfg, TLM.ModelCtx())


def test_generate_takes_frames_as_array_or_tensor():
    """`generate(enc_inputs=)` with a numpy array and with a tensor gives
    the reference's greedy tokens (fp32 compute)."""
    jcfg, tcfg = _cfgs("float32")
    jp = JC.init_params(JLM.model_desc(jcfg), jax.random.PRNGKey(6))
    tp = _carry(jp)
    enc = _frames(jcfg, 6)
    prompts = [[5, 9, 17, 3, 250, 11]] * 2
    want = jserve.generate(jp, jcfg, prompts, max_new=5,
                           enc_inputs=jnp.asarray(enc))
    for frames in (enc, torch.from_numpy(enc)):
        np.testing.assert_array_equal(
            tserve.generate(tp, tcfg, prompts, max_new=5,
                            enc_inputs=frames), want)
