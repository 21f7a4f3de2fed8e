"""Dense llama-style decoder LM (stablelm / llama3 / deepseek-coder).

The model object holds only its config; the weights live in a nested
dict (``init``) whose per-layer leaves are stacked on a leading L axis,
the reference's layout — so :func:`repro_torch.core.quantize_model` can
swap float leaves for packed :class:`QuantizedTensor` stacks and the same
entry points serve both.  ``forward`` / ``prefill`` / ``decode_step``
loop over layers.  KV cache layout is ``(L, B, KH, S, hd)``; prefill and
decode write it in place and return it.  With ``cfg.kv_cache_bits = 8``
the cache holds int8 codes with f32 per-(token, head) scales
``(L, B, KH, S, 1)`` beside them.  ``decode_step_paged`` runs against the
paged store ``(L, P, KH, ps, hd)`` of :meth:`init_paged_cache` through a
per-slot page table (the serving engine owns the table and the lengths).
Both decode entry points take T >= 1 tokens per slot: T > 1 is the
speculative verify burst (``verify_step`` / ``verify_step_paged``), whose
attention is one T-query launch per layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (decode_attention, decode_attention_q8,
                                    paged_decode_attention,
                                    paged_decode_attention_q8,
                                    paged_verify_attention,
                                    paged_verify_attention_q8,
                                    verify_attention, verify_attention_q8)
from .common import (apply_rope, chunked_attention, embed_tokens,
                     last_valid_hidden, logits_from_hidden, padded_vocab,
                     qlinear, quantize_kv, rms_norm, update_cache_at,
                     update_pages_at)


def _layer(blocks: dict, l: int) -> dict:
    """Layer ``l`` of the stacked block params (views)."""
    return {k: v[l] for k, v in blocks.items()}


class DenseLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.mrope_sections or cfg.sliding_window:
            raise NotImplementedError("M-RoPE and sliding-window attention "
                                      "arrive with their model families")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        in the config's dtype (bf16 at full width): normal with std
        ``1/sqrt(n_in)`` for linears, 0.02 for the embedding, norms at 1.
        Each layer is drawn in f32 and cast, so the f32 temporary is one
        layer's matrix."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        hd = cfg.head_dim_
        v_pad = padded_vocab(cfg.vocab_size)
        n_layers = cfg.n_layers

        def dense(n_in, n_out, scale=None, stack=None):
            scale = (1.0 / n_in) ** 0.5 if scale is None else scale
            shape = (n_in, n_out) if stack is None else (stack, n_in, n_out)
            out = torch.empty(shape, dtype=self.dtype, device=dev)
            for view in (out,) if stack is None else out:
                view.copy_(torch.randn((n_in, n_out), generator=gen,
                                       device=dev) * scale)
            return out

        def ones(*shape):
            return torch.ones(shape, dtype=self.dtype, device=dev)

        d, h, kv = cfg.d_model, cfg.n_heads * hd, cfg.n_kv_heads * hd
        return {
            "embed": dense(v_pad, d, scale=0.02),
            "blocks": {
                "attn_norm": ones(n_layers, d),
                "wq": dense(d, h, stack=n_layers),
                "wk": dense(d, kv, stack=n_layers),
                "wv": dense(d, kv, stack=n_layers),
                "wo": dense(h, d, stack=n_layers),
                "mlp_norm": ones(n_layers, d),
                "w_gate": dense(d, cfg.d_ff, stack=n_layers),
                "w_up": dense(d, cfg.d_ff, stack=n_layers),
                "w_down": dense(cfg.d_ff, d, stack=n_layers),
            },
            "final_norm": ones(d),
            "lm_head": dense(d, v_pad),
        }

    def quant_site_map(self) -> dict:
        return {
            ("blocks", "wq"): "attn_in",
            ("blocks", "wk"): "attn_in",
            ("blocks", "wv"): "attn_in",
            ("blocks", "wo"): "attn_out",
            ("blocks", "w_gate"): "mlp_in",
            ("blocks", "w_up"): "mlp_in",
            ("blocks", "w_down"): "mlp_down",
        }

    # -- block -------------------------------------------------------------
    def _attn(self, p, x, positions, *, cache=None, cache_len=None,
              kv_lens=None, paged=None):
        """Attention sub-block.  Returns (out, kv, o_pre): kv is k/v as
        produced (prefill cache capture) or the updated caches (decode).

        ``cache`` holds this layer's dense caches — ``(k, v)``, or ``(k,
        k_scale, v, v_scale)`` for the int8 cache — or, with ``paged`` (a
        ``(page_table, page_ids, offsets)`` triple), its page stores in the
        same order."""
        cfg = self.cfg
        hd = cfg.head_dim_
        b, t, _ = x.shape
        q = qlinear(x, p["wq"]).reshape(b, t, cfg.n_heads, hd)
        k = qlinear(x, p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
        v = qlinear(x, p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        q8 = cfg.kv_cache_bits == 8
        if cache is None:
            o = chunked_attention(q, k, v, causal=True, kv_lens=kv_lens)
            kv = (k, v)
        else:
            if q8:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                fresh = (kq, ks, vq, vs)
            else:
                fresh = (k, v)
            fresh = tuple(f.transpose(1, 2) for f in fresh)  # (B, KH, T, .)
            # T = 1 attends cache_len entries; a T-token burst starts at
            # base = cache_len - T, row i attending base + i + 1
            if paged is not None:
                table, page_ids, offsets = paged
                for st, new in zip(cache, fresh):
                    update_pages_at(st, new, page_ids, offsets)
                if t == 1:
                    attend = (paged_decode_attention_q8 if q8
                              else paged_decode_attention)
                    o = attend(q, *cache, table, cache_len)
                else:
                    attend = (paged_verify_attention_q8 if q8
                              else paged_verify_attention)
                    o = attend(q, *cache, table, cache_len - t)
            else:
                pos = cache_len - t
                for c, new in zip(cache, fresh):
                    update_cache_at(c, new, pos)
                if t == 1:
                    attend = decode_attention_q8 if q8 else decode_attention
                    o = attend(q, *cache, cache_len)
                else:
                    attend = verify_attention_q8 if q8 else verify_attention
                    o = attend(q, *cache, pos)
            kv = cache
        o = o.reshape(b, t, cfg.n_heads * hd)
        return qlinear(o, p["wo"]), kv, o

    def _block(self, p, x, positions, collect, *, cache=None, cache_len=None,
               kv_lens=None, paged=None):
        h = rms_norm(x, p["attn_norm"], self.cfg.norm_eps)
        stats = {}
        if collect:
            stats["attn_in"] = site_stat(h)
        attn_out, kv, o_pre = self._attn(p, h, positions, cache=cache,
                                         cache_len=cache_len, kv_lens=kv_lens,
                                         paged=paged)
        if collect:
            stats["attn_out"] = site_stat(o_pre)
        x = x + attn_out
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        if collect:
            stats["mlp_in"] = site_stat(h)
        hidden = F.silu(qlinear(h, p["w_gate"])) * qlinear(h, p["w_up"])
        if collect:
            stats["mlp_down"] = site_stat(hidden)
        x = x + qlinear(hidden, p["w_down"])
        return x, kv, stats

    # -- entry points --------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch, collect_stats: bool = False):
        """Full causal forward (evaluation / calibration).

        Returns (logits, aux) with aux = {"stats": ..., "moe_aux": scalar};
        ``stats[site][key]`` is stacked over layers (``(L, d)`` moments,
        ``(L, K, d)`` samples)."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = embed_tokens(params["embed"], tokens).to(self.dtype)
        per_layer = []
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, _, stats = self._block(_layer(blocks, l), x, positions,
                                      collect_stats)
            per_layer.append(stats)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        stacked = {}
        if collect_stats:
            stacked = {site: {key: torch.stack([s[site][key]
                                                for s in per_layer])
                              for key in per_layer[0][site]}
                       for site in per_layer[0]}
        aux = {"stats": stacked,
               "moe_aux": torch.zeros((), device=logits.device)}
        return logits, aux

    @torch.no_grad()
    def prefill(self, params, tokens, cache, prompt_len=None):
        """Run the prompt and write the KV cache (in place).

        cache: dict(k=(L,B,KH,S,hd), v=..., len=(B,)) with S >= T (plus
        k_scale/v_scale (L,B,KH,S,1) for the int8 cache, whose codes are
        written quantized).
        ``prompt_len`` (B,) int32 marks each row's true prompt length for
        bucket-padded batched prefill: keys at positions >= prompt_len[b]
        are masked, the returned logits are each row's *last valid*
        position, and cache["len"] is per-row.  ``None`` keeps the dense
        full-length behavior.  Returns (logits_last (B, 1, V), cache)."""
        b, t = tokens.shape
        dev = tokens.device
        positions = torch.arange(t, device=dev).expand(b, t)
        if prompt_len is None:
            plen = torch.full((b,), t, dtype=torch.int32, device=dev)
            kv_lens = None
        else:
            plen = torch.as_tensor(prompt_len, dtype=torch.int32,
                                   device=dev).reshape(-1).expand(b)
            kv_lens = plen
        x = embed_tokens(params["embed"], tokens).to(self.dtype)
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, (k, v), _ = self._block(_layer(blocks, l), x, positions, False,
                                       kv_lens=kv_lens)
            if self.cfg.kv_cache_bits == 8:
                for key, fresh in (("k", k), ("v", v)):
                    codes, scale = quantize_kv(fresh)
                    cache[key][l, :, :, :t] = codes.transpose(1, 2)
                    cache[key + "_scale"][l, :, :, :t] = scale.transpose(1, 2)
            else:
                cache["k"][l, :, :, :t] = k.transpose(1, 2)
                cache["v"][l, :, :, :t] = v.transpose(1, 2)
        x = x[:, -1:] if prompt_len is None else last_valid_hidden(x, plen)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=plen.clone())

    def _cache_keys(self):
        """Cache / page-store leaves per layer, in ``_attn``'s order."""
        if self.cfg.kv_cache_bits == 8:
            return ("k", "k_scale", "v", "v_scale")
        return ("k", "v")

    @torch.no_grad()
    def decode_step(self, params, cache, token):
        """One decode step: token (B, T) int32 with T >= 1.  T = 1 is the
        decode loop; T > 1 is the speculative verify burst: the T fresh K/V
        entries are written as one span at each slot's ``cache["len"]`` (in
        place) and ``logits[:, i]`` is the next-token distribution after
        ``token[:, :i + 1]`` (position i attends ``len + i + 1`` entries).
        Returns (logits (B, T, V), cache) with ``len`` advanced by T."""
        t = token.shape[1]
        base = cache["len"].to(torch.int32)
        new_len = base + t
        positions = base[:, None] + torch.arange(t, dtype=torch.int32,
                                                 device=token.device)
        logits = self._decode_layers(params, token, positions, new_len,
                                     lambda l: tuple(cache[key][l] for key
                                                     in self._cache_keys()))
        return logits, dict(cache, len=new_len)

    @torch.no_grad()
    def decode_step_paged(self, params, store, token, page_table, lens):
        """One decode step against the paged KV store.

        store: page stores from :meth:`init_paged_cache` (leaves (L, P, KH,
        ps, .), no ``len``: the engine keeps lengths and tables); token
        (B, T) int32 (T = 1 the decode loop, T > 1 a verify burst, as in
        :meth:`decode_step`); page_table (B, NP) int32 physical ids, shared
        by all layers; lens (B,) int32 valid entries *before* this step.
        Fresh entry i of slot b is written at offset ``(lens[b] + i) % ps``
        of page ``page_table[b, (lens[b] + i) // ps]`` (in place; a burst
        may cross a page boundary, so pages resolve per position).  Returns
        (logits (B, T, V), store)."""
        b, t = token.shape
        lens = torch.as_tensor(lens, dtype=torch.int32,
                               device=token.device).reshape(-1).expand(b)
        table = torch.as_tensor(page_table, dtype=torch.int32,
                                device=token.device)
        ps = store["k"].shape[3]
        positions = lens[:, None] + torch.arange(t, dtype=torch.int32,
                                                 device=token.device)
        pos = positions.long()
        paged = (table, table.gather(1, pos // ps), pos % ps)
        logits = self._decode_layers(params, token, positions, lens + t,
                                     lambda l: tuple(store[key][l] for key
                                                     in self._cache_keys()),
                                     paged=paged)
        return logits, store

    def verify_step(self, params, cache, tokens):
        """Score a K+1-token speculative burst in one forward pass.

        ``tokens`` (B, K+1) is each slot's last committed token followed by
        the draft's proposals; the burst starts at the slot's own
        ``cache["len"]``.  Writes the burst's K/V span and returns (logits
        (B, K+1, V), cache) with ``len`` advanced by K+1; the engine rolls
        rejected suffixes back (:func:`~repro_torch.serve.cache_ops.
        truncate_slot`).  This is :meth:`decode_step`'s T > 1 form."""
        return self.decode_step(params, cache, tokens)

    def verify_step_paged(self, params, store, tokens, page_table, lens):
        """Paged form of :meth:`verify_step`: the burst writes through
        per-position physical pages (made exclusively owned by the engine
        first) and the engine trims rejected-suffix pages."""
        return self.decode_step_paged(params, store, tokens, page_table,
                                      lens)

    def _decode_layers(self, params, token, positions, new_len, layer_cache,
                       paged=None):
        """Embed ``token``, run every layer against ``layer_cache(l)`` and
        return the logits."""
        x = embed_tokens(params["embed"], token).to(self.dtype)
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, _, _ = self._block(_layer(blocks, l), x, positions, False,
                                  cache=layer_cache(l), cache_len=new_len,
                                  paged=paged)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)

    # -- cache -------------------------------------------------------------
    def _kv_leaves(self, shape, dev) -> dict:
        """The K/V leaves of ``shape`` (.., hd): the model's float type, or
        int8 codes with f32 (.., 1) scales."""
        if self.cfg.kv_cache_bits == 8:
            sshape = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(sshape, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v_scale": torch.zeros(sshape, device=dev)}
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        return dict(self._kv_leaves(shape, dev),
                    len=torch.zeros((batch,), dtype=torch.int32, device=dev))

    def init_paged_cache(self, n_pages: int, page_size: int,
                         device="cuda") -> dict:
        """Physical page store: ``n_pages`` pages of ``page_size`` positions
        shared by all slots through per-slot page tables (serve/pages.py
        owns the allocator; tables and lengths stay with the engine, so the
        store has no ``len`` leaf)."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                 cfg.head_dim_)
        return self._kv_leaves(shape, resolve_device(device))

    def supports_paged(self) -> bool:
        """Paged serving relies on this class's prefill/decode cache
        layout; a subclass that overrides either serves from the dense
        cache."""
        return (type(self).prefill is DenseLM.prefill
                and type(self).decode_step is DenseLM.decode_step)

    def supports_spec(self) -> bool:
        """Speculative verification relies on this class's span-write
        decode path; a subclass that overrides it serves
        non-speculatively."""
        return (type(self).prefill is DenseLM.prefill
                and type(self).decode_step is DenseLM.decode_step)
