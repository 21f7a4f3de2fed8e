"""Model families (dense, MoE, VLM, hybrid, ssm and audio) and their
shared primitives."""
from .dense import DenseLM
from .hymba import HymbaLM
from .moe import MoELM
from .registry import build_model
from .vlm import VLM
from .whisper import WhisperLM
from .xlstm import XLSTMLM
