"""Architecture registry of the port: ``repro_torch.configs.get(name)`` →
``ModelConfig``.  Importing a config module registers it; each module is a
copy of the JAX package's (plain data)."""
from .base import ModelConfig, MoEConfig, get, names, register, tiny  # noqa: F401

# one module per assigned architecture — importing registers the config
from . import (  # noqa: F401
    mixtral_8x7b, mixtral_8x22b, granite_8b, gemma_7b, phi3_mini,
    nemotron_4_15b, recurrentgemma_9b, xlstm_1_3b, pixtral_12b,
    whisper_small,
)
from .shapes import SHAPES, applicable  # noqa: F401

ARCH_NAMES = (
    "mixtral-8x7b", "mixtral-8x22b", "granite-8b", "gemma-7b",
    "phi3-mini-3.8b", "nemotron-4-15b", "recurrentgemma-9b", "xlstm-1.3b",
    "pixtral-12b", "whisper-small",
)
