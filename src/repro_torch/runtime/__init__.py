"""The training driver's fault-tolerance primitives. The JAX package's
`elastic_reshard` places a checkpoint on a mesh and waits for the mesh
level (ROADMAP.md queue 1 item 3)."""

from repro_torch.runtime.fault import PreemptionHandler, StepMonitor

__all__ = ["StepMonitor", "PreemptionHandler"]
