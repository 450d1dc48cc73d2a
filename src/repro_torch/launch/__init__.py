"""Launchers: the serving driver (`serve`), the step builders (`steps`),
the training driver (`train`), device meshes (`mesh`) and the partition
specs of every input and state (`specs`). The JAX package's dry run and
HLO analysis wait (ROADMAP.md queue 1 item 1d)."""
