"""Architecture registry of the port: ``repro_torch.configs.get(name)`` →
``ModelConfig``.  Importing a config module registers it; the port carries
the architectures whose family it runs."""
from .base import ModelConfig, MoEConfig, get, names, register, tiny  # noqa: F401

from . import recurrentgemma_9b  # noqa: F401

ARCH_NAMES = ("recurrentgemma-9b",)
