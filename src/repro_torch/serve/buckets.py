"""Prompt-length bucketing for batched prefill admission.

Padding prompts up to a small fixed grid of length buckets bounds the
number of distinct prefill shapes (and so the kernel shapes a run sees)
by the bucket count, independent of traffic.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def default_buckets(max_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Doubling grid ``[min_bucket, 2*min_bucket, ..., max_len]``.

    The largest bucket is always exactly ``max_len`` so every admissible
    prompt has a bucket.
    """
    if max_len <= min_bucket:
        return (max_len,)
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(buckets: Sequence[int], prompt_len: int) -> int:
    """Smallest bucket >= prompt_len.  Raises if the prompt doesn't fit."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise ValueError(
        f"prompt length {prompt_len} exceeds largest bucket {max(buckets)}")
