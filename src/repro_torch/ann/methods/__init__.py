"""The ported filtered-ANN methods.

Importing this package registers them in the default
`repro_torch.ann.registry`: Pre-filter as the exact non-candidate
baseline, Post-filter and IVF-γ (the ACORN-γ analogue) as router
candidates. The JAX package's other candidates (UNG, SIEVE and
FilteredVamana analogues) are not ported yet.
"""

from repro_torch.ann import registry as _registry
from repro_torch.ann.methods.prefilter import PreFilter
from repro_torch.ann.methods.postfilter import PostFilter
from repro_torch.ann.methods.ivf_gamma import IVFGamma

_BUILTINS = (
    (PreFilter(), False),
    (PostFilter(), True),     # Post-filter analogue
    (IVFGamma(), True),       # ACORN-γ analogue
)
for _m, _cand in _BUILTINS:
    if _m.name not in _registry._DEFAULT:
        _registry._DEFAULT.register(_m, candidate=_cand)

