"""Architecture configs: one module per architecture the JAX package
supports, and the registry over them. They are data, copied from the JAX
package's `configs/`; the port runs the dense decoders' serving forward
(`repro_torch.models.lm`), and the other families' configs wait here for
their forwards (ROADMAP.md queue 1 item 2b)."""

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeSpec, get_config,
                                      get_smoke_config, registry,
                                      shape_supported)

__all__ = ["ARCH_IDS", "ModelConfig", "ShapeSpec", "SHAPES", "get_config",
           "get_smoke_config", "registry", "shape_supported"]
