"""Continuous-batching serving over packed FAQ int4 weights (dense,
single-device subset)."""
from .buckets import bucket_for, default_buckets
from .cache_ops import merge_slots, write_slot
from .engine import Request, ServeEngine
from .sampler import sample_tokens
