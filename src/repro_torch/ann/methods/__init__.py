"""The six filtered-ANN methods.

Importing this package registers them in the default
`repro_torch.ann.registry`, in the JAX package's order and with its
candidate flags: Pre-filter as the exact non-candidate baseline, and
the router's five candidates (the paper's UNG, Post-filter, SIEVE,
ACORN-γ and FilteredVamana analogues).
"""

from repro_torch.ann import registry as _registry
from repro_torch.ann.methods.prefilter import PreFilter
from repro_torch.ann.methods.postfilter import PostFilter
from repro_torch.ann.methods.labelnav import LabelNav
from repro_torch.ann.methods.sieve import Sieve
from repro_torch.ann.methods.ivf_gamma import IVFGamma
from repro_torch.ann.methods.fvamana import FVamana

_BUILTINS = (
    (PreFilter(), False),
    (LabelNav(), True),       # UNG analogue
    (PostFilter(), True),     # Post-filter analogue
    (Sieve(), True),          # SIEVE analogue
    (IVFGamma(), True),       # ACORN-γ analogue
    (FVamana(), True),        # FilteredVamana analogue
)
for _m, _cand in _BUILTINS:
    if _m.name not in _registry._DEFAULT:
        _registry._DEFAULT.register(_m, candidate=_cand)

# paper-name aliases for reporting
PAPER_NAMES = {
    "prefilter": "Pre-filter",
    "postfilter": "Post-filter",
    "labelnav": "UNG",
    "sieve": "SIEVE",
    "ivf_gamma": "ACORN-g",
    "fvamana": "FilteredVamana",
}
