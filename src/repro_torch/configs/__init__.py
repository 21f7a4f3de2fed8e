"""Architecture configs (one module per arch) + registry.

The port's own copies of ``repro.configs``: all ten of the reference's
architectures (dense, MoE, VLM, hybrid, ssm and audio families), and the
production shape cells (``SHAPE_CELLS``, and ``cell_applicable``, which
says which architectures run which cell).
"""
from .base import (SHAPE_CELLS, SUBQUADRATIC_FAMILIES, ModelConfig, ShapeCell,
                   cell_applicable)

from .stablelm_12b import CONFIG as STABLELM_12B
from .llama3_405b import CONFIG as LLAMA3_405B
from .llama3_8b import CONFIG as LLAMA3_8B
from .deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from .qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
from .qwen2_vl_2b import CONFIG as QWEN2_VL
from .hymba_1_5b import CONFIG as HYMBA
from .xlstm_350m import CONFIG as XLSTM
from .whisper_small import CONFIG as WHISPER

ARCHS = {
    c.name: c for c in (STABLELM_12B, LLAMA3_405B, LLAMA3_8B,
                        DEEPSEEK_CODER_33B, LLAMA4_MAVERICK, QWEN2_MOE,
                        QWEN2_VL, HYMBA, XLSTM, WHISPER)
}

__all__ = ["ARCHS", "ModelConfig", "SHAPE_CELLS", "SUBQUADRATIC_FAMILIES",
           "ShapeCell", "cell_applicable"]
