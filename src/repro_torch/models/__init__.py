"""Model families (dense, MoE, VLM and hybrid so far) and their shared
primitives."""
from .dense import DenseLM
from .hymba import HymbaLM
from .moe import MoELM
from .registry import build_model
from .vlm import VLM
