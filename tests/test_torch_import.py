"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points never move to the CPU by themselves."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.index import FilteredIndex
from repro_torch.kernels import bitmap_filter as bf
from repro_torch.kernels import masked_topk as mk

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT / "src").with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_port_imports_with_jax_and_reference_blocked():
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"for name in {_module_names()!r}:",
        "    importlib.import_module(name)",
        "from repro_torch.ann.live import ShardedLiveIndex, "
        "ShardedLiveSnapshot",
        "from repro_torch.ann.service import ShardedRouterService",
        "from repro_torch.ann.cache import SemanticResultCache",
        "from repro_torch.ann.telemetry import (TelemetrySink, "
        "RecallAuditor, OnlineBenchmarkTable, OnlineRouterAdapter, "
        "DegradedMethod, constant_router)",
        "from repro_torch.ann.slo import SLOEngine",
        "from repro_torch.ann.obslog import WideEventLog, PostmortemDumper",
        "from repro_torch.ann.metrics import metrics_text, MetricsServer",
        "from repro_torch.common import artifacts_dir",
        "from repro_torch.core.training import (collect, assemble_xy, "
        "train_models_from_xy, train_models, train_router, build_all, "
        "Collection, CellRecord, METHOD_ORDER)",
        "from repro_torch.core.mlp import (init_mlp, train_mlp, predict, "
        "params_to_numpy)",
        "from repro_torch.core.baselines import (PerMethodRegressor, "
        "BestMethodClassifier, ridge_fit)",
        "from repro_torch.core.forest import RandomForest",
        "from repro_torch.core.oracle import oracle_recall, oracle_choice",
        "from repro_torch.core.rule_router import RuleRouter",
        "from repro_torch.ann.bench import sweep",
        "from repro_torch.ann.index import default_index, as_index, "
        "clear_pool",
        "from repro_torch.data.ann_synth import get_dataset",
        "from repro_torch.common import timer",
        "from repro_torch.ann.registry import unregister_method",
        "from repro_torch.core.features import query_features",
        "from repro_torch.core.router import MLRouter as R",
        "assert hasattr(R, 'route_from_predictions_loop')",
        "from repro_torch.configs import (ModelConfig, ShapeSpec, SHAPES, "
        "ARCH_IDS, get_config, get_smoke_config, registry, "
        "shape_supported)",
        "assert len(registry()) == 10",
        "from repro_torch.models.common import (ParamDesc, is_desc, "
        "map_descs, count_params, init_params, params_from_numpy, "
        "cast_floats, rms_norm, layer_norm, rope_freqs, apply_rope)",
        "from repro_torch.models.attention import (NEG_INF, pick_qc, "
        "gqa_desc, gqa_train, gqa_prefill, gqa_decode, MLA_NOPE, MLA_V, "
        "mla_desc, mla_prefill, mla_decode, cross_desc, cross_kv, "
        "cross_attend)",
        "from repro_torch.models.moe import (mlp_desc, mlp_apply, "
        "moe_desc, moe_apply, dispatch, capacity)",
        "from repro_torch.models.ssm import (gla_chunk_scan, "
        "gla_decode_step, mlstm_desc, mlstm_decode, mlstm_state_shape, "
        "slstm_desc, slstm_train, slstm_decode, slstm_init_state, "
        "mamba_desc, mamba_decode, mamba_state_shape)",
        "from repro_torch.models.lm import (ModelCtx, layer_kinds, "
        "layer_desc, model_desc, cache_desc, forward_prefill, "
        "forward_decode)",
        "from repro_torch.launch.serve import pad_prompts, generate, main",
        "from repro_torch.models.lm import forward_train",
        "from repro_torch.models.attention import mla_train",
        "from repro_torch.models.ssm import mlstm_train, mamba_train",
        "from repro_torch.optim import (AdamConfig, adam_init, "
        "adam_update, clip_by_global_norm, cosine_schedule, "
        "linear_warmup_cosine)",
        "from repro_torch.checkpoint import (CheckpointManager, "
        "save_pytree, restore_pytree, restore_metadata)",
        "from repro_torch.runtime import StepMonitor, PreemptionHandler",
        "from repro_torch.data.tokens import TokenStream",
        "from repro_torch.launch.steps import (default_opt_cfg, "
        "accum_steps, make_train_step, init_train_state, "
        "make_prefill_step, make_decode_step)",
        "from repro_torch.launch.train import train_loop, main",
        "assert hasattr(__import__('repro_torch.ann.dataset', "
        "fromlist=['ANNDataset']).ANNDataset, 'cache_key')",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_reference(path):
    bad = [ln for ln in path.read_text().splitlines() if IMPORT_RE.match(ln)]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def _small_ds():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    bms = rng.integers(0, 4, (40, 1)).astype(np.uint32)
    return ANNDataset.from_packed("small", vecs, bms, 32)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = _small_ds()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FilteredIndex(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FilteredIndex(ds, device="cuda:0")
    fx = FilteredIndex(ds, device="cpu")
    assert fx.device.vectors.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; any other device raises
    instead of falling back."""
    meta = torch.device("meta")
    q = torch.empty((2, 8), device=meta)
    qb = torch.empty((2, 1), dtype=torch.int32, device=meta)
    base = torch.empty((5, 8), device=meta)
    norms = torch.empty((5,), device=meta)
    bm = torch.empty((5, 1), dtype=torch.int32, device=meta)
    wrappers = (mk.masked_topk_accum, mk.masked_topk_blocks,
                mk.merge_topk_accum, bf.selectivity_count,
                mk.masked_topk_large, mk.fused_live_accum)
    before = [fn.launches for fn in wrappers]
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.masked_topk_accum(q, qb, base, norms, bm, pred=0, k=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.masked_topk_blocks(q, qb, base, norms, bm, pred=0, k=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.merge_topk_accum(torch.empty((2, 3, 4), device=meta),
                            torch.empty((2, 3, 4), dtype=torch.int32,
                                        device=meta), k=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bf.selectivity_count(qb, bm, pred=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.masked_topk_accum(q, qb, base, norms, bm, pred=0, k=300)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.masked_topk_large(q, qb, base, norms, bm, pred=0, k=300)
    cand_d = torch.empty((2, 4), device=meta)
    cand_i = torch.empty((2, 4), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.fused_live_accum(q, qb, cand_d, cand_i, base, norms, bm,
                            torch.empty((4,), dtype=torch.int32, device=meta),
                            base_n=10, pred=0, k=3)
    assert [fn.launches for fn in wrappers] == before
