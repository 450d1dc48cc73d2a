"""The benchmark of the PyTorch and CUDA port (`repro_torch`): filtered
vector search on one H100, driven by `BENCHMARK.json` at the repo root.
See README.md."""
