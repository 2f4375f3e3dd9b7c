"""Model configurations of the port and their registry."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: F401
                                      ModelConfig, ShapeConfig, cells,
                                      get_config, get_smoke_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "cells",
           "get_config", "get_smoke_config"]
