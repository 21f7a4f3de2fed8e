"""Dense llama-style decoder LM (stablelm / llama3 / deepseek-coder).

The model object holds only its config; the weights live in a nested
dict (``init``) whose per-layer leaves are stacked on a leading L axis,
the reference's layout — so :func:`repro_torch.core.quantize_model` can
swap float leaves for packed :class:`QuantizedTensor` stacks and the same
entry points serve both.  ``forward`` / ``prefill`` / ``decode_step``
loop over layers.  KV cache layout is ``(L, B, KH, S, hd)``; prefill and
decode write it in place and return it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import decode_attention
from .common import (apply_rope, chunked_attention, embed_tokens,
                     last_valid_hidden, logits_from_hidden, padded_vocab,
                     qlinear, rms_norm, update_cache_at)


def _layer(blocks: dict, l: int) -> dict:
    """Layer ``l`` of the stacked block params (views)."""
    return {k: v[l] for k, v in blocks.items()}


class DenseLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.kv_cache_bits != 16:
            raise NotImplementedError("the int8 KV cache arrives with the "
                                      "q8 flash-decode kernel")
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
              kv_lens=None):
        """Attention sub-block.  Returns (out, (k, v), o_pre): k/v as
        produced (prefill cache capture) or the updated caches (decode)."""
        cfg = self.cfg
        hd = cfg.head_dim_
        b, t, _ = x.shape
        q = qlinear(x, p["wq"]).reshape(b, t, cfg.n_heads, hd)
        k = qlinear(x, p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
        v = qlinear(x, p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cache is None:
            o = chunked_attention(q, k, v, causal=True, kv_lens=kv_lens)
        else:
            k_cache, v_cache = cache                 # (B, KH, S, hd)
            pos = cache_len - t
            update_cache_at(k_cache, k.transpose(1, 2), pos)
            update_cache_at(v_cache, v.transpose(1, 2), pos)
            o = decode_attention(q, k_cache, v_cache, cache_len)
            k, v = k_cache, v_cache
        o = o.reshape(b, t, cfg.n_heads * hd)
        return qlinear(o, p["wo"]), (k, v), o

    def _block(self, p, x, positions, collect, *, cache=None, cache_len=None,
               kv_lens=None):
        h = rms_norm(x, p["attn_norm"], self.cfg.norm_eps)
        stats = {}
        if collect:
            stats["attn_in"] = site_stat(h)
        attn_out, kv, o_pre = self._attn(p, h, positions, cache=cache,
                                         cache_len=cache_len, kv_lens=kv_lens)
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

        cache: dict(k=(L,B,KH,S,hd), v=..., len=(B,)) with S >= T.
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
            cache["k"][l, :, :, :t] = k.transpose(1, 2)
            cache["v"][l, :, :, :t] = v.transpose(1, 2)
        x = x[:, -1:] if prompt_len is None else last_valid_hidden(x, plen)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=plen.clone())

    @torch.no_grad()
    def decode_step(self, params, cache, token):
        """One decode step: token (B, 1) int32.  Each slot's fresh K/V is
        written at its own ``cache["len"]`` (in place) and attends to its
        first ``len + 1`` positions through the flash-decode kernel.
        Returns (logits (B, 1, V), cache) with ``len`` advanced by 1."""
        b, t = token.shape
        if t != 1:
            raise NotImplementedError(
                "multi-token decode (speculative verify) arrives with "
                "speculative decoding")
        base = cache["len"].to(torch.int32)
        new_len = base + 1
        positions = base[:, None]
        x = embed_tokens(params["embed"], token).to(self.dtype)
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, _, _ = self._block(_layer(blocks, l), x, positions, False,
                                  cache=(cache["k"][l], cache["v"][l]),
                                  cache_len=new_len)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=new_len)

    # -- cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
