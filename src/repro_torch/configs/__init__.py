"""Model configurations of the port (pure dataclasses, no framework)."""
from .base import ModelConfig
from .registry import ARCH_IDS, PORTED_ARCH_IDS, get_config, get_smoke_config

__all__ = ["ModelConfig", "ARCH_IDS", "PORTED_ARCH_IDS", "get_config", "get_smoke_config"]
