import numpy as np
import pytest

from repro.ann.dataset import ANNDataset
from repro.data.ann_synth import DatasetSpec, synthesize, make_queries
from repro.ann.predicates import Predicate


TINY_SPEC = DatasetSpec("tiny", 600, 24, 40, 6, 8, 1.3, 2.0, 0.5, 0.3, 7)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running sweeps (deselect with '-m \"not slow\"'; "
        "run with '-m slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return                        # explicit marker expression wins
    skip = pytest.mark.skip(reason="slow sweep; run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def tiny_ds() -> ANNDataset:
    return synthesize(TINY_SPEC)


@pytest.fixture(scope="session")
def tiny_index(tiny_ds):
    from repro.ann.index import FilteredIndex

    fx = FilteredIndex(tiny_ds)
    yield fx
    fx.close()


@pytest.fixture(scope="session")
def tiny_queries(tiny_ds):
    return {pred: make_queries(tiny_ds, pred, 25, seed=3)
            for pred in (Predicate.EQUALITY, Predicate.AND, Predicate.OR)}


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def toy_router(tiny_ds):
    """Randomly initialised MLRouter with a dense synthetic benchmark
    table over tiny_ds — routing exercises Algorithm 2 end to end without
    the offline collection sweep."""
    import jax

    from repro.ann import registry as registry_mod
    from repro.core import features as F
    from repro.core import mlp as mlp_mod
    from repro.core.router import MLRouter
    from repro.core.table import BenchmarkTable

    methods = list(registry_mod.candidate_methods())
    rand = np.random.default_rng(5)
    table = BenchmarkTable.new()
    for pt in range(3):
        for name, m in registry_mod.candidate_methods().items():
            for s in m.param_settings():
                table.add(tiny_ds.name, pt, name, s.ps_id,
                          recall=float(rand.uniform(0.7, 1.0)),
                          qps=float(rand.uniform(100, 2000)))
    models = {m: mlp_mod.params_to_numpy(
        mlp_mod.init_mlp((5, 16, 8, 1), jax.random.PRNGKey(j)))
        for j, m in enumerate(methods)}
    return MLRouter(feature_names=F.MINIMAL_FEATURES, methods=methods,
                    models=models,
                    scaler=mlp_mod.Scaler(np.zeros(5), np.ones(5)),
                    table=table)
