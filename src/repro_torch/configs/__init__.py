"""Dense architecture configs (one module per arch) + registry.

The port's own copies of ``repro.configs``; the other families arrive
with their model slices.
"""
from .base import ModelConfig

from .stablelm_12b import CONFIG as STABLELM_12B
from .llama3_405b import CONFIG as LLAMA3_405B
from .llama3_8b import CONFIG as LLAMA3_8B
from .deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B

ARCHS = {
    c.name: c for c in (STABLELM_12B, LLAMA3_405B, LLAMA3_8B,
                        DEEPSEEK_CODER_33B)
}

__all__ = ["ARCHS", "ModelConfig"]
