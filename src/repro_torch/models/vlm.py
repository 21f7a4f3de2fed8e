"""Qwen2-VL backbone: DenseLM + M-RoPE + stub vision frontend (the
reference's ``repro/models/vlm.py``).

The vision tower is a stub: batches carry precomputed patch embeddings
``patches (B, P, d_model)``, which are prepended to the token embeddings.
M-RoPE lives in :func:`~repro_torch.models.common.apply_rope` (sections
over head_dim/2); with the stub's text-style position ids it reduces to
standard RoPE, which is Qwen2-VL's behaviour for text tokens.

``prefill`` takes ``patches`` and no ``prompt_len``, so the serving engine
admits a VLM one request at a time at its exact length (``SingleAdmission``)
and serves it from the dense cache; decode is :class:`DenseLM`'s.  The KV
cache stays in the model's dtype: the reference's VLM prefill writes only
``k`` / ``v``, so an int8 cache is refused.  Under a mesh it is
:class:`DenseLM`'s tensor-parallel path (qwen2-vl-2b's 12 / 2 heads give
each of 2 ranks 6 query heads on 1 KV head), with the patches, whole on
every rank, prepended to the vocab-sharded embedding's rows.  Training on
a mesh runs the same layers (:meth:`DenseLM._forward_block`: FSDP
gathers, ``copy_to`` before the column products); the embedding and the
head are gathered over ``data`` as :meth:`DenseLM.forward` gathers them,
and a data rank's batch carries its rows of the patches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from .common import embed_tokens, fsdp_leaf, logits_from_hidden, rms_norm
from .dense import DenseLM, _layer


class VLM(DenseLM):
    def __init__(self, cfg: ModelConfig):
        if cfg.kv_cache_bits == 8:
            raise NotImplementedError("the VLM family keeps its KV cache in "
                                      "the model's dtype (as the "
                                      "reference's does)")
        super().__init__(cfg)

    def _embed(self, params, tokens, patches):
        """Token embeddings with the patch embeddings prepended; returns
        (x (B, P + T, d), P, positions over all P + T)."""
        b, t = tokens.shape
        embed = fsdp_leaf(params["embed"], self.param_axes()["embed"],
                          self.cfg.d_model)
        x = embed_tokens(embed, tokens, self.cfg.vocab_size).to(self.dtype)
        n_patch = 0
        if patches is not None:
            n_patch = patches.shape[1]
            x = torch.cat([patches.to(self.dtype), x], dim=1)
        total = n_patch + t
        positions = self._maybe_mrope(
            torch.arange(total, device=tokens.device).expand(b, total))
        return x, n_patch, positions

    def forward(self, params, batch, collect_stats: bool = False):
        """:meth:`DenseLM.forward` over ``patches`` + tokens; the logits
        cover the token positions only (patch positions carry no labels),
        the statistics every position."""
        x, n_patch, positions = self._embed(params, batch["tokens"],
                                            batch.get("patches"))
        x, stacked, moe_aux = self._forward_layers(params, x, positions,
                                                   collect_stats)
        head = fsdp_leaf(params["lm_head"], self.param_axes()["lm_head"],
                         self.cfg.d_model)
        logits = logits_from_hidden(x[:, n_patch:], head, self.cfg.vocab_size)
        return logits, {"stats": stacked, "moe_aux": moe_aux}

    @torch.no_grad()
    def prefill(self, params, tokens, cache, patches=None):
        """Run ``patches`` + the prompt and write their K/V at positions
        0 .. P + T - 1 of the cache (in place).  Returns (logits of the last
        position (B, 1, V), cache) with ``len`` = P + T."""
        b = tokens.shape[0]
        x, _, positions = self._embed(params, tokens, patches)
        total = x.shape[1]
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, (k, v), _ = self._block(_layer(blocks, l), x, positions, False)
            cache["k"][l, :, :, :total] = k.transpose(1, 2)
            cache["v"][l, :, :, :total] = v.transpose(1, 2)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=torch.full(
            (b,), total, dtype=torch.int32, device=tokens.device))
