"""Model families (dense and MoE so far) and their shared primitives."""
from .dense import DenseLM
from .moe import MoELM
from .registry import build_model
