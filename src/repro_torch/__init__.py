"""PyTorch/CUDA port of the query-aware filtered-ANN router.

Laid out like the JAX package: `ann/` (dataset, index handle, methods,
service), `core/` (features, MLP-Reg, benchmark table, router), `data/`
(synthetic datasets) and `kernels/` (hand-written CUDA kernels for
Hopper, each with a plain PyTorch version beside it).

Entry points place their tensors on the card (`device="cuda"`) unless
the caller passes `device="cpu"`; without a card the default raises
rather than moving to the CPU by itself.
"""
