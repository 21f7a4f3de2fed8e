"""Deterministic synthetic LM data pipeline.

A fixed random bigram ("structured Zipf") language: a seeded transition
matrix over the vocab gives the data real learnable structure, so tiny
LMs trained here reach meaningfully-different perplexities and the
quantization benchmarks (paper-table analogs) measure something real.

Properties needed at scale and provided here:
* **index-addressable**: sequence ``i`` depends only on ``(seed, i)`` —
  no shared iterator state, so any host can materialize any shard.
* **shardable**: host ``h`` of ``H`` takes indices ``i*H + h``.
* **resumable**: a step counter fully determines the next batch
  (checkpoint restores data position exactly; elastic restarts with a
  different host count re-shard deterministically).
* **bias knob** for the calibration-robustness experiments (paper
  Table 3): ``first_token_range`` restricts the starting state, skewing
  the sampled distribution exactly like topic-biased calibration text.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seed: int = 1234
    zipf_a: float = 1.2        # unigram skew
    branching: int = 24        # plausible successors per token


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.Generator(np.random.PCG64(cfg.seed))
        v = cfg.vocab_size
        # Zipf-ish unigram prior
        prior = 1.0 / np.arange(1, v + 1) ** cfg.zipf_a
        prior /= prior.sum()
        self.prior_cum = np.cumsum(prior)
        # per-token successor sets with random weights
        succ = rng.integers(0, v, size=(v, cfg.branching))
        w = rng.dirichlet(np.ones(cfg.branching) * 0.5, size=v)
        trans = np.zeros((v, v), np.float64)
        rows = np.repeat(np.arange(v), cfg.branching)
        trans[rows, succ.reshape(-1)] += w.reshape(-1)
        trans += 1e-3 * prior[None, :]     # smoothing mass
        trans /= trans.sum(axis=1, keepdims=True)
        self.trans_cum = np.cumsum(trans, axis=1)

    def sequence(self, index: int, length: int,
                 first_token_range: Optional[Tuple[int, int]] = None
                 ) -> np.ndarray:
        """Deterministic sequence for a global index."""
        rng = np.random.Generator(np.random.PCG64((self.cfg.seed << 20)
                                                  ^ (index + 1)))
        out = np.empty(length, np.int32)
        if first_token_range is not None:
            lo, hi = first_token_range
            out[0] = rng.integers(lo, hi)
        else:
            out[0] = np.searchsorted(self.prior_cum, rng.random())
        u = rng.random(length - 1)
        for t in range(1, length):
            out[t] = np.searchsorted(self.trans_cum[out[t - 1]], u[t - 1])
        return out

    def batch(self, step: int, batch_size: int, length: int,
              host: int = 0, n_hosts: int = 1,
              first_token_range: Optional[Tuple[int, int]] = None) -> dict:
        """Batch for a global step; host h materializes its shard only.

        Index layout is delegated to ``dist.elastic.resume_batch_indices``
        (the single source of truth), so elastic restarts resume the exact
        same global sample stream by construction."""
        from repro_torch.dist.elastic import resume_batch_indices
        idx = resume_batch_indices(step, batch_size, host, n_hosts)
        toks = np.stack([self.sequence(i, length, first_token_range)
                         for i in idx])
        return {"tokens": toks, "labels": toks}

    def perplexity_upper_bound(self) -> float:
        """Entropy of the true process (nats) -> the floor a perfect model
        can reach; useful to sanity-check training."""
        # H(next | prev) under the stationary-ish prior
        trans = np.diff(np.concatenate([np.zeros((self.cfg.vocab_size, 1)),
                                        self.trans_cum], axis=1), axis=1)
        prior = np.diff(np.concatenate([[0.0], self.prior_cum]))
        h = -np.sum(prior[:, None] * trans * np.log(np.maximum(trans, 1e-12)))
        return float(np.exp(h))


def calibration_batches(data: SyntheticLM, n_samples: int, length: int,
                        batch_size: int = 8, biased: bool = False,
                        seed_offset: int = 10_000_000):
    """Calibration set of ``n_samples`` sequences (disjoint from training
    indices via a large offset).  ``biased=True`` restricts start states,
    reproducing paper-Table-3-style calibration bias."""
    rng_range = (0, max(2, data.cfg.vocab_size // 64)) if biased else None
    batches = []
    i = 0
    while i < n_samples:
        bs = min(batch_size, n_samples - i)
        toks = np.stack([data.sequence(seed_offset + i + j, length, rng_range)
                         for j in range(bs)])
        batches.append({"tokens": toks})
        i += bs
    return batches
