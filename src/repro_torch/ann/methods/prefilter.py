"""Pre-filter: exact masked brute-force scan (recall = 1 by construction).

The search goes through `kernels.ops.masked_topk`: on a CUDA handle the
hand-written kernel, on a CPU handle its plain PyTorch version — the
same function either way.
"""

from __future__ import annotations

from repro_torch.ann import engine
from repro_torch.ann.dataset import ANNDataset
from repro_torch.ann.predicates import Predicate
from repro_torch.kernels import ops


class PreFilter(engine.Method):
    name = "prefilter"

    def param_settings(self):
        return [engine.ps("exact")]

    def build(self, ds: ANNDataset, build_params: dict):
        return None

    def index_arrays(self, index) -> dict:
        return {}          # stateless build: persists as nothing

    def index_from_arrays(self, ds: ANNDataset, build_params: dict,
                          arrays: dict):
        return None

    def search(self, fx, index, qvecs, qbms, pred: Predicate, k: int,
               search_params: dict):
        dev = fx.device
        p = int(Predicate(pred))

        def fn(qv, qb):
            return ops.masked_topk(
                engine.to_device(qv, fx.torch_device),
                engine.to_device(qb, fx.torch_device),
                dev.vectors, dev.norms, dev.bitmaps, pred=p, k=k)

        return engine.run_chunked(fn, qvecs.shape[0], qvecs, qbms)
