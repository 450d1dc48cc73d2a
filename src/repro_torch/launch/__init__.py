"""Launchers: the serving driver (`serve`), the step builders (`steps`)
and the training driver (`train`). The JAX package's mesh-level
launchers wait (ROADMAP.md queue 1 item 3)."""
