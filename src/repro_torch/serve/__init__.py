"""Serving: bucketed continuous batching over packed FAQ int4 weights
(dense and paged caches, speculative decoding), with the EDF scheduler,
open-loop traffic, SLO admission, fault injection and tracing.  The
reference's exports, less its jit trace counter (eager PyTorch compiles
nothing)."""
from .buckets import bucket_for, default_buckets
from .cache_ops import (copy_page, merge_slots, scatter_prefill_pages,
                        truncate_slot, write_slot)
from .draft import ModelDraft, SelfDraft, registry_draft, self_int8_draft
from .engine import Request, ServeEngine
from .faults import FaultConfig, FaultInjector, burstify
from . import instrument
from .loadgen import ArrivalFeed, TrafficConfig, make_trace, summarize
from .overload import SLOAdmission, SLOConfig, request_tokens
from .pages import PagePool, PagePressure, PoolExhausted, block_hashes
from .slots import SlotTable, effective_prompt
from .sampler import (draw_from_probs, policy_probs, sample_tokens,
                      spec_accept)
from .scheduler import RunResult, Scheduler
from .spec import SpecConfig, SpecRunner
