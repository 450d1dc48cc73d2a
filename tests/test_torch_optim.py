"""The port's optimizer against the JAX package on the CPU: AdamW (plain
and with 8-bit moments) over three steps on the same parameters and
gradients, given as numpy, with a ragged last axis; global-norm clipping;
both schedules. The int8 moments and their scales must be bit-identical
(the quantizer's scale and its round-half-to-even are the reference's);
the parameters agree to fp32 rounding (the bias corrections' powers are
computed by different fp32 `pow`s). Every array is drawn from a seeded
numpy generator of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import clip as jclip
from repro.optim import schedule as jsched
from repro_torch.models import common as TC
from repro_torch.optim import adam as tadam
from repro_torch.optim import clip as tclip
from repro_torch.optim import schedule as tsched
from test_torch_train import _one_torch_thread  # noqa: F401 (a fixture)

# shapes: a stacked [L, ...] leaf, a block-tiled last axis (512 = 2 x 256),
# a ragged one (300: one block of the whole axis), a vector, a tuple
SHAPES = {"layers": {"w": (2, 4, 512), "b": (2, 300)},
          "ln": (48,), "pair": ((5, 256), (3, 7))}


def _tree(rng, scale=1.0):
    def draw(shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"layers": {k: draw(v) for k, v in SHAPES["layers"].items()},
            "ln": draw(SHAPES["ln"]),
            "pair": tuple(draw(s) for s in SHAPES["pair"])}


def _torch(tree):
    return TC.map_descs(lambda a: torch.from_numpy(a.copy()), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_np(ttree, jtree):
    got = [t.numpy() for t in TC.tree_leaves(ttree)]
    want = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    assert len(got) == len(want)
    return got, want


@pytest.mark.parametrize("compress", [False, True])
def test_adam_three_steps_match_reference(compress):
    rng = np.random.default_rng(31)
    params = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -i) for i in range(3)]
    cfg_kw = dict(lr=1e-2, weight_decay=0.01, compress=compress)
    jcfg, tcfg = jadam.AdamConfig(**cfg_kw), tadam.AdamConfig(**cfg_kw)
    jp = _jax(params)
    js = jadam.adam_init(jp, jcfg)
    tp = _torch(params)
    ts = tadam.adam_init(tp, tcfg)
    got, want = _leaves_np(ts, js)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g in grads:
        jp, js = jadam.adam_update(_jax(g), js, jp, jcfg)
        tp2, ts2 = tadam.adam_update(_torch(g), ts, tp, tcfg)
        assert tp2 is tp and ts2 is ts
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    got, want = _leaves_np(tp, jp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7)
    for part in ("mu", "nu"):
        got, want = _leaves_np(ts[part], js[part])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_adam_sliced_leaf_equals_whole(monkeypatch):
    """A leaf updated in slices of whole rows gives the bits of one
    update over the whole leaf."""
    rng = np.random.default_rng(32)
    params = _tree(rng)
    grads = _tree(rng)
    out = []
    for slice_elems in (tadam.SLICE_ELEMS, 600):
        monkeypatch.setattr(tadam, "SLICE_ELEMS", slice_elems)
        cfg = tadam.AdamConfig(lr=1e-2, compress=True)
        tp = _torch(params)
        ts = tadam.adam_init(tp, cfg)
        for _ in range(2):
            tadam.adam_update(_torch(grads), ts, tp, cfg)
        out.append(TC.tree_leaves((tp, ts["mu"], ts["nu"])))
    assert len(tadam.row_ranges(SHAPES["layers"]["w"])) > 1
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_quantize_matches_reference_on_ties():
    """Values on the half-step grid of their scale: round half to even in
    both packages."""
    rng = np.random.default_rng(33)
    x = rng.integers(-254, 255, size=(6, 512)).astype(np.float32) / 2
    x[:, 0] = 127.0                      # scale 1 (+1e-12) in every block
    x[:, 256] = -127.0
    jq, js = jadam._quantize(jnp.asarray(x), 256)
    tq, ts = tadam._quantize(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tadam._dequantize(tq, ts, 256).numpy(),
        np.asarray(jadam._dequantize(jq, js, 256)))


def test_adam_state_desc_matches_reference():
    from repro.models.common import ParamDesc as JP
    from repro_torch.models.common import ParamDesc as TPD
    jd = {"w": JP((4, 512), tp=1, fsdp=0), "v": JP((7, 300), tp=1)}
    td = {"w": TPD((4, 512), tp=1, fsdp=0), "v": TPD((7, 300), tp=1)}
    for compress in (False, True):
        j = jadam.adam_state_desc(jd, jadam.AdamConfig(compress=compress))
        t = tadam.adam_state_desc(td, tadam.AdamConfig(compress=compress))
        jl = jax.tree.leaves(j, is_leaf=lambda x: isinstance(x, JP))
        tl = TC.tree_leaves(t)
        assert [(d.shape, d.tp, d.fsdp) for d in tl] == \
            [(d.shape, d.tp, d.fsdp) for d in jl]
        assert [str(d.dtype).removeprefix("torch.") for d in tl] == \
            [jnp.dtype(d.dtype).name for d in jl]


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(34)
    grads = _tree(rng)
    jg, jn = jclip.clip_by_global_norm(_jax(grads), max_norm)
    tg, tn = tclip.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    got, want = _leaves_np(tg, jg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-9)
    if max_norm > float(jn):
        for g, a in zip(got, TC.tree_leaves(_torch(grads))):
            np.testing.assert_array_equal(g, a.numpy())


def test_schedules_match_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for total in (1, 50, 100):
        np.testing.assert_allclose(
            tsched.cosine_schedule(torch.from_numpy(steps), total).numpy(),
            np.asarray(jsched.cosine_schedule(jnp.asarray(steps), total)),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tsched.linear_warmup_cosine(torch.from_numpy(steps), 10,
                                        total, floor=0.05).numpy(),
            np.asarray(jsched.linear_warmup_cosine(jnp.asarray(steps), 10,
                                                   total, floor=0.05)),
            rtol=1e-6, atol=1e-7)
    assert float(tsched.cosine_schedule(7, 50)) == pytest.approx(
        float(jsched.cosine_schedule(jnp.int32(7), 50)), rel=1e-6)
