"""Hymba: hybrid blocks with parallel attention + Mamba heads (the
reference's ``repro/models/hymba.py``).

Per block (arXiv:2411.13676, adapted): both branches read the same normed
input and their outputs are averaged.  The attention branch masks a
sliding window (``cfg.sliding_window``), and the decode KV cache is a
**ring buffer of window size**: RoPE is applied before caching, so the
slot order does not matter to the attention sum, and a decode step
attends ``min(len, W)`` entries.  The Mamba branch carries its recurrent
state ``h`` (L, B, d_inner, S) f32 and its conv tail ``conv`` (L, B, k-1,
d_inner) in the cache's nested ``mamba`` dict.

``prefill`` takes no ``prompt_len``: the serving engine admits hymba one
request at a time at its exact length (``SingleAdmission``), from the
dense cache only (no page store, no speculative verify, no int8 KV
cache, as in the reference).  Prefill and decode write the cache in
place.

Tensor parallelism (``ServeEngine(mesh=)``): attention is cut on heads
where both head counts divide ``model`` and whole on every rank otherwise
(hymba-1.5b's 25 / 5 heads on 2 ranks), while the MLP and the Mamba branch
are cut on ``ff`` either way (:func:`~repro_torch.models.ssm.mamba_axes`);
each branch's row-parallel output is reduced before ``x + 0.5 * (attn +
mamba)`` adds it, the Mamba branch's and ``w_down``'s in f32
(:func:`~repro_torch.models.common.row_parallel_f32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import decode_attention
from . import ssm
from .common import (apply_rope, embed_tokens, logits_from_hidden, qlinear,
                     reduce_row_parallel, rms_norm, row_parallel_f32,
                     update_cache_at)
from .dense import DenseLM, _layer


class HymbaLM(DenseLM):
    # this family's own layers take no FSDP gather or copy_to: no training
    # on a mesh yet (ROADMAP: mesh training of the non-dense families)
    mesh_training = False

    def __init__(self, cfg: ModelConfig):
        if cfg.kv_cache_bits == 8:
            raise NotImplementedError("the hybrid family keeps its ring KV "
                                      "cache in the model's dtype (as the "
                                      "reference's does)")
        super().__init__(cfg)

    @property
    def _d_inner(self) -> int:
        return self.cfg.ssm_expand * self.cfg.d_model

    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """:meth:`DenseLM.init`'s tree with each block's Mamba branch under
        ``blocks/mamba`` (:func:`~repro_torch.models.ssm.mamba_init`, drawn
        from a generator seeded ``seed + 1``)."""
        params = super().init(seed, device)
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        params["blocks"]["mamba"] = ssm.mamba_init(
            gen, cfg.n_layers, cfg.d_model, self._d_inner, cfg.ssm_state,
            cfg.dt_rank, cfg.ssm_conv, self.dtype, dev)
        return params

    def param_axes(self) -> dict:
        """:meth:`DenseLM.param_axes` with the Mamba branch's
        (:func:`~repro_torch.models.ssm.mamba_axes`) under
        ``blocks/mamba``."""
        ax = super().param_axes()
        ax["blocks"]["mamba"] = ssm.mamba_axes()
        return ax

    def _layers_all_reduces(self, a: int, f: int, prefill: bool) -> int:
        """``wo`` where attention is cut; Mamba ``x_proj`` and ``out_proj``
        and ``w_down`` where ``ff`` is."""
        return self.cfg.n_layers * (a + 3 * f)

    def cache_axes(self) -> dict:
        """Logical axes of :meth:`init_cache`'s leaves: the ring K/V on
        ``kv_heads``, the Mamba state's channels on ``ff`` (the
        reference's)."""
        ax = (None, "batch", "kv_heads", "kv_seq", None)
        return {"k": ax, "v": ax,
                "mamba": {"h": (None, "batch", "ff", None),
                          "conv": (None, "batch", None, "ff")},
                "len": None}

    def quant_site_map(self) -> dict:
        m = super().quant_site_map()
        m.update({
            ("blocks", "mamba", "in_proj"): "attn_in",   # same normed input
            ("blocks", "mamba", "x_proj"): "mamba_x",
            ("blocks", "mamba", "out_proj"): "mamba_out",
        })
        return m

    # -- block -------------------------------------------------------------
    def _block(self, p, x, positions, collect, *, cache=None, cache_len=None):
        """Attention and Mamba on the same normed input, averaged, then the
        MLP.  ``cache`` = ((k ring, v ring), mamba state) for a decode
        step.  Returns (x, (kv, new mamba state), stats)."""
        cfg = self.cfg
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        stats = {}
        if collect:
            stats["attn_in"] = site_stat(h)
        collected = {}
        cb = ((lambda name, val: collected.__setitem__(name, site_stat(val)))
              if collect else None)
        if cache is None:
            attn_out, kv, o_pre = self._attn(p, h, positions)
            mamba_out = ssm.mamba_scan(p["mamba"], h, collect_cb=cb,
                                       d_inner=self._d_inner)
            new_mamba = None
        else:
            kv_cache, mamba_state = cache
            attn_out, kv, o_pre = self._attn_ring(p, h, positions, kv_cache,
                                                  cache_len)
            mamba_out, new_mamba = ssm.mamba_step(p["mamba"], h, mamba_state,
                                                  self._d_inner)
        if collect:
            stats["attn_out"] = site_stat(o_pre)
            stats.update(collected)
        x = x + 0.5 * (attn_out + mamba_out)
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        if collect:
            stats["mlp_in"] = site_stat(h)
        hidden = F.silu(qlinear(h, p["w_gate"])) * qlinear(h, p["w_up"])
        if collect:
            stats["mlp_down"] = site_stat(hidden)
        return x + self._down(p, hidden), (kv, new_mamba), stats

    def _down(self, p, hidden):
        """``w_down`` of ``hidden``, summed over ``model`` in f32 when it
        holds a rank's ``ff`` columns (as the Mamba branch's products)."""
        return row_parallel_f32(hidden, p["w_down"], self.cfg.d_ff)

    def _attn_ring(self, p, x, positions, kv_cache, cache_len):
        """Decode attention against the ring-buffer window cache: the fresh
        entry goes to slot ``(len - 1) % window`` (in place) and the step
        attends ``min(len, window)`` entries."""
        cfg = self.cfg
        hd = cfg.head_dim_
        w = cfg.sliding_window
        b, t, _ = x.shape
        # this rank's heads: all of them, or H/m and KH/m under TP
        q = qlinear(x, p["wq"])
        n_h = q.shape[-1] // hd
        q = q.reshape(b, t, n_h, hd)
        k = qlinear(x, p["wk"])
        n_kv = k.shape[-1] // hd
        k = k.reshape(b, t, n_kv, hd)
        v = qlinear(x, p["wv"]).reshape(b, t, n_kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_cache, v_cache = kv_cache                       # (B, KH, W, hd)
        slot = (cache_len - 1) % w
        update_cache_at(k_cache, k.transpose(1, 2), slot)
        update_cache_at(v_cache, v.transpose(1, 2), slot)
        valid = torch.clamp(cache_len, max=w)
        o = decode_attention(q, k_cache, v_cache, valid)
        o = o.reshape(b, t, n_h * hd)
        out = reduce_row_parallel(qlinear(o, p["wo"]), n_h, cfg.n_heads)
        return out, (k_cache, v_cache), o

    # -- entry points (the cache differs from DenseLM's) ----------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """Ring K/V of ``W = min(sliding_window, max_len)`` slots (L, B, KH,
        W, hd), the Mamba state (L, B, ...) and ``len`` (B,)."""
        cfg = self.cfg
        dev = resolve_device(device)
        w = min(cfg.sliding_window or max_len, max_len)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, w, cfg.head_dim_)
        state = ssm.mamba_state_init(batch, self._d_inner, cfg.ssm_state,
                                     cfg.ssm_conv, self.dtype, dev)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
            "mamba": {key: leaf[None].repeat((cfg.n_layers,)
                                             + (1,) * leaf.dim())
                      for key, leaf in state.items()},
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def prefill(self, params, tokens, cache):
        """Full forward capturing the final states (in place): the attention
        branch keeps the last W rope'd K/V entries at ring slots ``pos %
        W``; the Mamba branch runs its scan from the cache's state and keeps
        the final carry.  Returns (logits of the last position (B, 1, V),
        cache) with ``len`` = T."""
        b, t = tokens.shape
        dev = tokens.device
        positions = torch.arange(t, device=dev).expand(b, t)
        x = embed_tokens(params["embed"], tokens,
                         self.cfg.vocab_size).to(self.dtype)
        w = cache["k"].shape[3]
        blocks, mst = params["blocks"], cache["mamba"]
        eps = self.cfg.norm_eps
        for l in range(self.cfg.n_layers):
            p = _layer(blocks, l)
            h = rms_norm(x, p["attn_norm"], eps)
            attn_out, (k, v), _ = self._attn(p, h, positions)
            _ring_store(cache["k"][l], k.transpose(1, 2)[:, :, -w:], t, w)
            _ring_store(cache["v"][l], v.transpose(1, 2)[:, :, -w:], t, w)
            mamba_out, new = ssm.mamba_scan_final(
                p["mamba"], h, {key: leaf[l] for key, leaf in mst.items()},
                self._d_inner)
            for key, leaf in mst.items():
                leaf[l] = new[key]
            x = x + 0.5 * (attn_out + mamba_out)
            h2 = rms_norm(x, p["mlp_norm"], eps)
            hidden = F.silu(qlinear(h2, p["w_gate"])) * qlinear(h2, p["w_up"])
            x = x + self._down(p, hidden)
        x = rms_norm(x[:, -1:], params["final_norm"], eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=torch.full((b,), t, dtype=torch.int32,
                                                  device=dev))

    @torch.no_grad()
    def decode_step(self, params, cache, token):
        """One decode step: token (B, 1) int32.  Writes each layer's ring slot
        and Mamba state in place; returns (logits (B, 1, V), cache) with
        ``len`` advanced by 1."""
        if token.shape[1] != 1:
            raise ValueError("hymba decodes one token per step (its ring "
                             "cache has no span write)")
        new_len = cache["len"].to(torch.int32) + 1
        positions = (new_len - 1)[:, None]
        x = embed_tokens(params["embed"], token,
                         self.cfg.vocab_size).to(self.dtype)
        blocks, mst = params["blocks"], cache["mamba"]
        for l in range(self.cfg.n_layers):
            state = {key: leaf[l] for key, leaf in mst.items()}
            x, (_, new), _ = self._block(
                _layer(blocks, l), x, positions, False,
                cache=((cache["k"][l], cache["v"][l]), state),
                cache_len=new_len)
            for key, leaf in mst.items():
                leaf[l] = new[key]
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=new_len)


def _ring_store(cache: torch.Tensor, tail: torch.Tensor, t: int, w: int):
    """Store the last min(t, w) entries ``tail`` (B, KH, n, hd) of a
    t-token prompt at the ring slots of their absolute positions (slot =
    pos % w) of ``cache`` (B, KH, W, hd), in place."""
    n = tail.shape[2]
    slots = (t - n + torch.arange(n, device=cache.device)) % w
    cache[:, :, slots] = tail.to(cache.dtype)
