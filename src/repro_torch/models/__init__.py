"""Model families (dense so far) and their shared primitives."""
from .dense import DenseLM
from .registry import build_model
