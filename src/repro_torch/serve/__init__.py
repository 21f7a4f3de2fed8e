"""Continuous-batching serving over packed FAQ int4 weights (dense,
single-device subset), with speculative decoding."""
from .buckets import bucket_for, default_buckets
from .cache_ops import merge_slots, truncate_slot, write_slot
from .draft import ModelDraft, SelfDraft, registry_draft, self_int8_draft
from .engine import Request, ServeEngine
from .sampler import policy_probs, sample_tokens, spec_accept
from .spec import SpecConfig
