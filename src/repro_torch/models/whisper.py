"""Whisper-small: an encoder-decoder transformer over stub frame
embeddings (the reference's ``repro/models/whisper.py``).

The conv / mel frontend is a stub, as in the reference: every entry point
takes precomputed frame embeddings ``frames (B, T_enc, d_model)``.
LayerNorm with bias, a tanh-GELU MLP with biases, learned positional
embeddings (no RoPE), a non-causal encoder, and a decoder with causal
self-attention and cross-attention over the encoder's output.  FAQ
previews run per stack: the ``enc_*`` sites over the encoder's layers,
the others over the decoder's.

Kernels on the card: the encoder's self-attention (T_enc == T_enc) and
the decoder's causal self-attention run the flash-attention kernel
through :func:`~repro_torch.models.common.chunked_attention` (G 1, MHA);
cross-attention in a forward or a prefill (T_dec != T_enc) stays on the
plain chunked path, as the reference's jnp path; a decode step's self-
and cross-attention are flash-decode launches over the (B, KH, S, hd)
caches, the cross one at every slot's length ``encoder_len``.  The cache
holds self ``k`` / ``v`` (L, B, KH, max_len, hd), cross ``xk`` / ``xv`` (L, B,
KH, encoder_len, hd) and ``len``; ``prefill(frames=)`` writes them in
place.  The serving engine passes no ``frames`` (neither does the
reference's), so whisper is driven through ``prefill`` / ``decode_step``.

Tensor parallelism (an engine's mesh: its ``place`` cuts the weights,
``new_cache`` the caches, and ``prefill`` / ``decode_step`` run under its
``_mesh_ctx()``): every attention is cut on heads (``wk`` / ``wv``
column-parallel, so each rank computes its heads of the whole K/V, and
the self and cross caches hold them), every MLP on ``ff`` (``b1`` with
``w1``'s columns); ``wo``'s and ``w2``'s row-parallel outputs are each
reduced over ``model`` (one all_reduce), ``b2`` is added after that
reduction, and the logits are gathered once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import serving_rules
from repro_torch.kernels.ops import decode_attention
from .common import (chunked_attention, dense_init, embed_tokens, layer_norm,
                     logits_from_hidden, normal_init, padded_vocab, qlinear,
                     reduce_row_parallel, run_block, stack_layer_stats,
                     update_cache_at)
from .dense import _layer

MAX_DEC_POS = 36864  # learned positional table (covers 32k prefill + decode)


class WhisperLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)

    # -- params ------------------------------------------------------------
    def _blocks_init(self, gen, n_layers, cross: bool, dev) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.head_dim_

        def dense(n_in, n_out):
            return dense_init(gen, n_in, n_out, self.dtype, dev,
                              stack=n_layers)

        def attn():
            return {"wq": dense(d, cfg.n_heads * hd),
                    "wk": dense(d, cfg.n_kv_heads * hd),
                    "wv": dense(d, cfg.n_kv_heads * hd),
                    "wo": dense(cfg.n_heads * hd, d)}

        ones = lambda n: torch.ones((n_layers, n), dtype=self.dtype,
                                    device=dev)
        zeros = lambda n: torch.zeros((n_layers, n), dtype=self.dtype,
                                      device=dev)
        p = {"ln1_w": ones(d), "ln1_b": zeros(d), "attn": attn(),
             "ln2_w": ones(d), "ln2_b": zeros(d),
             "w1": dense(d, cfg.d_ff), "b1": zeros(cfg.d_ff),
             "w2": dense(cfg.d_ff, d), "b2": zeros(d)}
        if cross:
            p.update(lnx_w=ones(d), lnx_b=zeros(d), cross=attn())
        return p

    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        in the config's dtype, the reference's tree: linears normal with std
        ``1/sqrt(n_in)``, the positional tables and the embedding with std
        0.02, LayerNorms at (1, 0), biases 0."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_model
        v_pad = padded_vocab(cfg.vocab_size)
        ones = lambda: torch.ones((d,), dtype=self.dtype, device=dev)
        zeros = lambda: torch.zeros((d,), dtype=self.dtype, device=dev)
        return {
            "enc_pos": normal_init(gen, (cfg.encoder_len, d), 0.02,
                                   self.dtype, dev),
            "enc_blocks": self._blocks_init(gen, cfg.n_encoder_layers, False,
                                            dev),
            "enc_norm_w": ones(), "enc_norm_b": zeros(),
            "embed": dense_init(gen, v_pad, d, self.dtype, dev, scale=0.02),
            "dec_pos": normal_init(gen, (MAX_DEC_POS, d), 0.02, self.dtype,
                                   dev),
            "dec_blocks": self._blocks_init(gen, cfg.n_layers, True, dev),
            "dec_norm_w": ones(), "dec_norm_b": zeros(),
            "lm_head": dense_init(gen, d, v_pad, self.dtype, dev),
        }

    def param_axes(self) -> dict:
        """Logical axes of :meth:`init`'s tree: the reference's, with
        ``wk`` / ``wv`` column-parallel on ``kv_heads`` (the reference
        replicates them and cuts K/V after the product; each rank here
        computes its heads' columns) and ``b1`` cut on ``ff`` with ``w1``'s
        columns."""
        def attn_ax():
            return {"wq": (None, "fsdp", "heads"),
                    "wk": (None, "fsdp", "kv_heads"),
                    "wv": (None, "fsdp", "kv_heads"),
                    "wo": (None, "heads", "fsdp")}

        def block_ax(cross):
            ax = {"ln1_w": (None, None), "ln1_b": (None, None),
                  "attn": attn_ax(),
                  "ln2_w": (None, None), "ln2_b": (None, None),
                  "w1": (None, "fsdp", "ff"), "b1": (None, "ff"),
                  "w2": (None, "ff", "fsdp"), "b2": (None, None)}
            if cross:
                ax.update(lnx_w=(None, None), lnx_b=(None, None),
                          cross=attn_ax())
            return ax

        return {
            "enc_pos": (None, None), "enc_blocks": block_ax(False),
            "enc_norm_w": (None,), "enc_norm_b": (None,),
            "embed": ("vocab", "fsdp"), "dec_pos": (None, None),
            "dec_blocks": block_ax(True),
            "dec_norm_w": (None,), "dec_norm_b": (None,),
            "lm_head": ("fsdp", "vocab"),
        }

    def tp_all_reduces(self, mesh, prefill: bool = False) -> int:
        """The all_reduces of one step (``prefill``: with the encoder)
        under ``mesh`` and its serving rules, where every cut dimension
        divides ``model``, beside the one logits all_gather: the vocab-cut
        embedding's one; a decoder layer's self and cross ``wo`` where
        attention is cut on heads and ``w2`` where ``ff`` is; an encoder
        layer's ``wo`` and ``w2``.  0 without a mesh or a ``model``
        axis."""
        m = 1 if mesh is None else mesh.size("model")
        if m == 1:
            return 0
        rules = serving_rules(self.cfg, mesh)
        a, f = (int(rules[ax] is not None) for ax in ("heads", "ff"))
        enc = self.cfg.n_encoder_layers * (a + f) if prefill else 0
        return (self.cfg.n_layers * (2 * a + f) + enc
                + int(padded_vocab(self.cfg.vocab_size) % m == 0))

    def cache_axes(self) -> dict:
        """Logical axes of :meth:`init_cache`'s leaves (the reference's):
        self and cross K/V on ``kv_heads``."""
        ax = (None, "batch", "kv_heads", "kv_seq", None)
        return {"k": ax, "v": ax, "xk": ax, "xv": ax, "len": None}

    def quant_site_map(self) -> dict:
        m = {}
        for w in ("wq", "wk", "wv"):
            m[("enc_blocks", "attn", w)] = "enc_attn_in"
            m[("dec_blocks", "attn", w)] = "dec_attn_in"
        m[("enc_blocks", "attn", "wo")] = "enc_attn_out"
        m[("dec_blocks", "attn", "wo")] = "dec_attn_out"
        m[("enc_blocks", "w1")] = "enc_mlp_in"
        m[("enc_blocks", "w2")] = "enc_mlp_down"
        m[("dec_blocks", "w1")] = "dec_mlp_in"
        m[("dec_blocks", "w2")] = "dec_mlp_down"
        m[("dec_blocks", "cross", "wq")] = "cross_q_in"
        m[("dec_blocks", "cross", "wk")] = "cross_kv_in"
        m[("dec_blocks", "cross", "wv")] = "cross_kv_in"
        m[("dec_blocks", "cross", "wo")] = "cross_out"
        return m

    # -- attention / MLP -----------------------------------------------------
    def _mha(self, p, xq, xkv, causal, stats, prefix, cache=None,
             cache_len=None, append=False):
        """Multi-head attention of ``xq`` over ``xkv`` (self-attention when
        None).  With ``cache`` and not ``append``: cross-attention at decode
        over the precomputed encoder K/V; with ``append``: a self-attention
        decode step writing position ``cache_len - 1`` (in place).  Returns
        (out, (k, v) as produced or the caches).  ``stats`` (a dict, or
        None) takes the ``wo`` input under ``prefix + "_out"``."""
        cfg = self.cfg
        hd = cfg.head_dim_
        b, tq, _ = xq.shape
        # this rank's heads: all of them, or H/m and KH/m under TP
        q = qlinear(xq, p["wq"])
        n_h = q.shape[-1] // hd
        q = q.reshape(b, tq, n_h, hd)
        if cache is not None and not append:
            k_c, v_c = cache
            enc_len = torch.full((b,), k_c.shape[2], dtype=torch.int32,
                                 device=xq.device)
            o = decode_attention(q, k_c, v_c, enc_len)
            kv = cache
        else:
            src = xq if xkv is None else xkv
            tk = src.shape[1]
            k = qlinear(src, p["wk"])
            n_kv = k.shape[-1] // hd
            k = k.reshape(b, tk, n_kv, hd)
            v = qlinear(src, p["wv"]).reshape(b, tk, n_kv, hd)
            if cache is not None:
                k_c, v_c = cache
                update_cache_at(k_c, k.transpose(1, 2), cache_len - 1)
                update_cache_at(v_c, v.transpose(1, 2), cache_len - 1)
                o = decode_attention(q, k_c, v_c, cache_len)
                kv = cache
            else:
                o = chunked_attention(q, k, v, causal=causal)
                kv = (k, v)
        o = o.reshape(b, tq, n_h * hd)
        if stats is not None:
            stats[prefix + "_out"] = site_stat(o)
        return reduce_row_parallel(qlinear(o, p["wo"]), n_h, cfg.n_heads), kv

    def _mlp(self, p, x, stats, prefix):
        h = qlinear(x, p["w1"]) + p["b1"].to(x.dtype)
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
        if stats is not None:
            stats[prefix + "_down"] = site_stat(h)
        y = reduce_row_parallel(qlinear(h, p["w2"]), h.shape[-1],
                                self.cfg.d_ff)
        return y + p["b2"].to(x.dtype)

    # -- encoder -------------------------------------------------------------
    def _enc_block(self, p, x, collect):
        stats = {} if collect else None
        h = layer_norm(x, p["ln1_w"], p["ln1_b"])
        if collect:
            stats["enc_attn_in"] = site_stat(h)
        x = x + self._mha(p["attn"], h, None, False, stats, "enc_attn")[0]
        h = layer_norm(x, p["ln2_w"], p["ln2_b"])
        if collect:
            stats["enc_mlp_in"] = site_stat(h)
        return x + self._mlp(p, h, stats, "enc_mlp"), stats or {}

    def encode(self, params, frames, collect: bool = False):
        """The encoder over ``frames`` (B, T_enc, d): (memory (B, T_enc, d),
        its stacked statistics)."""
        x = frames.to(self.dtype) + params["enc_pos"][None, :frames.shape[1]]
        per_layer = []
        for l in range(self.cfg.n_encoder_layers):
            x, stats = run_block(self.cfg.remat, self._enc_block,
                                 _layer(params["enc_blocks"], l), x, collect)
            per_layer.append(stats)
        x = layer_norm(x, params["enc_norm_w"], params["enc_norm_b"])
        return x, stack_layer_stats(per_layer)

    # -- decoder -------------------------------------------------------------
    def _dec_block(self, p, x, memory, collect, self_cache=None,
                   cross_cache=None, cache_len=None):
        """Returns (x, self (k, v), cross (k, v), stats)."""
        stats = {} if collect else None
        h = layer_norm(x, p["ln1_w"], p["ln1_b"])
        if collect:
            stats["dec_attn_in"] = site_stat(h)
        a, new_self = self._mha(p["attn"], h, None, True, stats, "dec_attn",
                                cache=self_cache, cache_len=cache_len,
                                append=self_cache is not None)
        x = x + a
        h = layer_norm(x, p["lnx_w"], p["lnx_b"])
        if collect:
            stats["cross_q_in"] = site_stat(h)
            stats["cross_kv_in"] = site_stat(memory)
        a, new_cross = self._mha(p["cross"], h, memory, False, stats, "cross",
                                 cache=cross_cache)
        x = x + a
        h = layer_norm(x, p["ln2_w"], p["ln2_b"])
        if collect:
            stats["dec_mlp_in"] = site_stat(h)
        x = x + self._mlp(p, h, stats, "dec_mlp")
        return x, new_self, new_cross, stats or {}

    def _embed(self, params, tokens, positions):
        x = embed_tokens(params["embed"], tokens,
                         self.cfg.vocab_size).to(self.dtype)
        return x + params["dec_pos"][positions]

    def _head(self, params, x):
        x = layer_norm(x, params["dec_norm_w"], params["dec_norm_b"])
        return logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)

    def forward(self, params, batch, collect_stats: bool = False):
        """Teacher-forced decoder over the encoder's memory.  batch:
        {"tokens": (B, T), "frames": (B, T_enc, d)}.  Returns (logits, aux)
        with aux["stats"] the encoder's and the decoder's sites, each
        stacked over its own stack's layers."""
        tokens = batch["tokens"]
        t = tokens.shape[1]
        memory, enc_stats = self.encode(params, batch["frames"],
                                        collect_stats)
        x = self._embed(params, tokens,
                        torch.arange(t, device=tokens.device)[None])

        def block(p, x, memory):
            x, _, _, stats = self._dec_block(p, x, memory, collect_stats)
            return x, stats

        per_layer = []
        for l in range(self.cfg.n_layers):
            x, stats = run_block(self.cfg.remat, block,
                                 _layer(params["dec_blocks"], l), x, memory)
            per_layer.append(stats)
        stats = dict(enc_stats, **stack_layer_stats(per_layer))
        return self._head(params, x), {
            "stats": stats, "moe_aux": torch.zeros((), device=x.device)}

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        cfg = self.cfg
        dev = resolve_device(device)
        hd = cfg.head_dim_
        self_shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, hd)
        cross_shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_len,
                       hd)
        z = lambda shape: torch.zeros(shape, dtype=self.dtype, device=dev)
        return {"k": z(self_shape), "v": z(self_shape),
                "xk": z(cross_shape), "xv": z(cross_shape),
                "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(self, params, tokens, cache, frames=None):
        """Encode ``frames``, run the prompt, and write (in place) its self
        K/V from position 0 and each layer's cross K/V of the whole
        encoder output.  Returns (logits of the last position (B, 1, V),
        cache) with ``len`` = T."""
        b, t = tokens.shape
        memory, _ = self.encode(params, frames)
        x = self._embed(params, tokens,
                        torch.arange(t, device=tokens.device)[None])
        for l in range(self.cfg.n_layers):
            x, (k, v), (xk, xv), _ = self._dec_block(
                _layer(params["dec_blocks"], l), x, memory, False)
            cache["k"][l, :, :, :t] = k.transpose(1, 2)
            cache["v"][l, :, :, :t] = v.transpose(1, 2)
            cache["xk"][l] = xk.transpose(1, 2)
            cache["xv"][l] = xv.transpose(1, 2)
        return self._head(params, x[:, -1:]), dict(cache, len=torch.full(
            (b,), t, dtype=torch.int32, device=tokens.device))

    @torch.no_grad()
    def decode_step(self, params, cache, token):
        """One decode step: token (B, 1) int32 at position ``len`` (its
        learned position ``dec_pos[len]``).  Writes the self K/V entry in
        place and attends the cross cache; returns (logits (B, 1, V),
        cache) with ``len`` + 1."""
        if token.shape[1] != 1:
            raise ValueError("whisper decodes one token per step")
        new_len = cache["len"].to(torch.int32) + 1
        x = self._embed(params, token, (new_len - 1).long()[:, None])
        for l in range(self.cfg.n_layers):
            x, _, _, _ = self._dec_block(
                _layer(params["dec_blocks"], l), x, None, False,
                self_cache=(cache["k"][l], cache["v"][l]),
                cross_cache=(cache["xk"][l], cache["xv"][l]),
                cache_len=new_len)
        return self._head(params, x), dict(cache, len=new_len)
