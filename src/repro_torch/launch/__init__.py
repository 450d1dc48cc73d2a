"""Launchers: the serving driver (`serve`). The JAX package's training
driver and its mesh-level launchers wait (ROADMAP.md queue 1 items 2c
and 3)."""
