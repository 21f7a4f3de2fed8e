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

Tensor parallelism (a serving engine's ``mesh=``): the entry points run
on this rank's shards (:func:`repro_torch.dist.sharding.shard_tree` over
:meth:`DenseLM.param_axes`).  Attention runs on the rank's H/m query and
KH/m KV heads (``wq`` / ``wk`` / ``wv`` column-parallel, its caches hold
those KV heads), ``wo`` and ``w_down`` are row-parallel (the local
product, then one all_reduce over ``model``), the embedding and the head
are vocab-sharded.  The head counts are read from the shards' widths, so
the same code runs whole weights, and attention whose heads do not divide
``model`` (replicated on every rank).  Nothing in a decode step moves a
cache between ranks.

Training on a mesh (``train.trainer.make_train_step(mesh=)``) runs
:meth:`DenseLM.forward` on shards cut by ``training_rules``: each weight
whose ``fsdp`` axis the rules cut over ``data`` is this rank's FSDP shard,
gathered as its layer starts (:func:`fsdp_gather`, whose backward is a
reduce_scatter); a column-parallel product's replicated input passes
``copy_to`` (its gradient summed over ``model``).  Without ``cfg.remat``
the products save the gathered weights for the backward, so every layer's
stay on the device until its backward; with it only the running layer's.
Serving's rules cut no ``fsdp`` axis and without grad ``copy_to`` is the
identity, so serving runs as before.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import serving_rules
from repro_torch.kernels.ops import (decode_attention, decode_attention_q8,
                                    paged_decode_attention,
                                    paged_decode_attention_q8,
                                    paged_verify_attention,
                                    paged_verify_attention_q8,
                                    verify_attention, verify_attention_q8)
from .common import (apply_rope, chunked_attention, collectives_per_step,
                     column_input, dense_init, embed_tokens, fsdp_leaf,
                     gather_layer, mesh_cuts, meta_tree,
                     last_valid_hidden, logits_from_hidden, make_generator,
                     padded_vocab, qlinear, quantize_kv, reduce_row_parallel,
                     rms_norm, run_block, stack_layer_stats, update_cache_at,
                     update_pages_at)


def _layer(blocks: dict, l: int) -> dict:
    """Layer ``l`` of the stacked block params (views; nested dicts, such
    as hymba's ``mamba`` branch, alike)."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


class DenseLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self._meta = None

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        in the config's dtype (bf16 at full width): normal with std
        ``1/sqrt(n_in)`` for linears, 0.02 for the embedding, norms at 1.
        Each layer is drawn in f32 and cast, so the f32 temporary is one
        layer's matrix.  ``device="meta"`` gives the shapes alone."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = make_generator(dev, seed)
        hd = cfg.head_dim_
        v_pad = padded_vocab(cfg.vocab_size)
        n_layers = cfg.n_layers

        def dense(n_in, n_out, scale=None, stack=None):
            return dense_init(gen, n_in, n_out, self.dtype, dev, scale=scale,
                              stack=stack)

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

    def param_axes(self) -> dict:
        """Logical axes of :meth:`init`'s tree, the reference's with
        ``wk`` / ``wv`` column-parallel on ``kv_heads`` (the reference
        replicates them and slices K/V after the product; the port's
        ranks compute only their KV heads' columns)."""
        return {
            "embed": ("vocab", "fsdp"),
            "blocks": {
                "attn_norm": (None, None),
                "wq": (None, "fsdp", "heads"),
                "wk": (None, "fsdp", "kv_heads"),
                "wv": (None, "fsdp", "kv_heads"),
                "wo": (None, "heads", "fsdp"),
                "mlp_norm": (None, None),
                "w_gate": (None, "fsdp", "ff"),
                "w_up": (None, "fsdp", "ff"),
                "w_down": (None, "ff", "fsdp"),
            },
            "final_norm": (None,),
            "lm_head": ("fsdp", "vocab"),
        }

    def tp_all_reduces(self, mesh, prefill: bool = False) -> int:
        """The all_reduces of one serving step (a prefill or a decode step)
        under ``mesh`` and its serving rules, where every cut dimension
        divides ``model``, beside the step's one logits all_gather: the
        vocab-cut embedding's one and :meth:`_layers_all_reduces`.  0
        without a mesh or a ``model`` axis."""
        m = 1 if mesh is None else mesh.size("model")
        if m == 1:
            return 0
        rules = serving_rules(self.cfg, mesh)
        a, f = (int(rules[ax] is not None) for ax in ("heads", "ff"))
        return (self._layers_all_reduces(a, f, prefill)
                + int(padded_vocab(self.cfg.vocab_size) % m == 0))

    def _layers_all_reduces(self, a: int, f: int, prefill: bool) -> int:
        """The layers' all_reduces of a serving step, ``a`` / ``f`` 1 where
        attention is cut on heads / ``ff`` is cut: ``wo`` and ``w_down``
        in each layer."""
        return self.cfg.n_layers * (a + f)

    # -- collectives of a train step on a mesh -------------------------------
    def train_collectives(self, mesh_shape, *, remat: bool = False,
                          microbatches: int = 1,
                          grad_compress: bool = False) -> dict:
        """Collective calls per kind of one train step
        (``make_train_step(mesh=)``) on a ``(data, model)`` mesh of
        ``mesh_shape``: :meth:`_microbatch_collectives` per microbatch and
        the step's own (:func:`~repro_torch.models.common.
        collectives_per_step`); :func:`~repro_torch.train.trainer.
        step_collectives` is llama3-8b's."""
        return collectives_per_step(self, mesh_shape, remat=remat,
                                    microbatches=microbatches,
                                    grad_compress=grad_compress)

    def _microbatch_collectives(self, mesh, remat: bool) -> dict:
        """One microbatch's forward and backward: all_gather, the FSDP
        gathers of each layer's cut leaves and of the embedding and the
        head (``remat``: each layer's again in its recompute) and, with the
        vocabulary cut, the logits' columns; reduce_scatter, the gathers'
        backward; all_reduce, the vocab-cut embedding's and the logits'
        input's backward sum and :meth:`_train_layer_all_reduces` per
        layer."""
        cut, gathered = mesh_cuts(self, mesh)
        n, g = self.cfg.n_layers, gathered("['blocks']")
        a = cut("['blocks']['wq']", "model")
        f = cut("['blocks']['w_gate']", "model")
        v = cut("['embed']", "model")
        gathers = n * g + gathered("['embed']") + gathered("['lm_head']")
        return {"all_gather": gathers + v + remat * n * g,
                "reduce_scatter": gathers,
                "all_reduce": 2 * v + n * self._train_layer_all_reduces(
                    a, f, remat)}

    def _train_layer_all_reduces(self, a: int, f: int, remat: bool) -> int:
        """A layer's all_reduces in a train step, ``a`` / ``f`` 1 where
        attention is cut on heads / ``ff`` is cut: ``wo``'s and
        ``w_down``'s sums and their inputs' backward sums (``copy_to``);
        under ``remat`` the recompute's ``wo`` sum again (torch's
        non-reentrant checkpoint stops before ``w_down``'s, whose output
        the backward does not need)."""
        return 2 * a + 2 * f + remat * a

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
        # this rank's heads: all of them, or H/m and KH/m under TP
        x = column_input(x, p["wq"], cfg.n_heads * hd)
        q = qlinear(x, p["wq"])
        n_h = q.shape[-1] // hd
        q = q.reshape(b, t, n_h, hd)
        k = qlinear(x, p["wk"])
        n_kv = k.shape[-1] // hd
        k = k.reshape(b, t, n_kv, hd)
        v = qlinear(x, p["wv"]).reshape(b, t, n_kv, hd)
        mrope = cfg.mrope_sections or None
        q = apply_rope(q, positions, cfg.rope_theta, mrope_sections=mrope)
        k = apply_rope(k, positions, cfg.rope_theta, mrope_sections=mrope)
        q8 = cfg.kv_cache_bits == 8
        window = cfg.sliding_window or None
        if cache is None:
            o = chunked_attention(q, k, v, causal=True, window=window,
                                  kv_lens=kv_lens)
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
                    o = attend(q, *cache, table, cache_len, window=window)
                else:
                    attend = (paged_verify_attention_q8 if q8
                              else paged_verify_attention)
                    o = attend(q, *cache, table, cache_len - t,
                               window=window)
            else:
                pos = cache_len - t
                for c, new in zip(cache, fresh):
                    update_cache_at(c, new, pos)
                if t == 1:
                    attend = decode_attention_q8 if q8 else decode_attention
                    o = attend(q, *cache, cache_len, window=window)
                else:
                    attend = verify_attention_q8 if q8 else verify_attention
                    o = attend(q, *cache, pos, window=window)
            kv = cache
        o = o.reshape(b, t, n_h * hd)
        out = reduce_row_parallel(qlinear(o, p["wo"]), n_h, cfg.n_heads)
        return out, kv, o

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
        h = column_input(h, p["w_gate"], self.cfg.d_ff)
        hidden = F.silu(qlinear(h, p["w_gate"])) * qlinear(h, p["w_up"])
        if collect:
            stats["mlp_down"] = site_stat(hidden)
        x = x + reduce_row_parallel(qlinear(hidden, p["w_down"]),
                                    hidden.shape[-1], self.cfg.d_ff)
        return x, kv, stats

    # -- entry points --------------------------------------------------------
    def forward(self, params, batch, collect_stats: bool = False):
        """Full causal forward (training / evaluation / calibration).

        Returns (logits, aux) with aux = {"stats": ..., "moe_aux": scalar};
        ``stats[site][key]`` is stacked over layers (``(L, d)`` moments,
        ``(L, K, d)`` samples).  Differentiable: gradients reach every
        parameter that requires grad (on the card through the
        flash-attention and rms_norm kernels' backward).  ``cfg.remat``
        recomputes each block in the backward (``torch.utils.checkpoint``,
        the reference's ``jax.checkpoint``).  Calibration calls it under
        ``torch.no_grad()``."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = self._maybe_mrope(
                torch.arange(t, device=tokens.device).expand(b, t))
        axes, d = self.param_axes(), self.cfg.d_model
        x = embed_tokens(fsdp_leaf(params["embed"], axes["embed"], d), tokens,
                         self.cfg.vocab_size).to(self.dtype)
        x, stacked, moe_aux = self._forward_layers(params, x, positions,
                                                   collect_stats)
        logits = logits_from_hidden(
            x, fsdp_leaf(params["lm_head"], axes["lm_head"], d),
            self.cfg.vocab_size)
        return logits, {"stats": stacked, "moe_aux": moe_aux}

    def _forward_layers(self, params, x, positions, collect_stats):
        """The layer stack of :meth:`forward` over the embedded input ``x``
        and the final norm.  Returns (hidden, stacked stats, moe_aux)."""
        per_layer, layer_aux = [], []
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, stats, aux = run_block(self.cfg.remat, self._forward_block,
                                      _layer(blocks, l), x, positions,
                                      collect_stats)
            per_layer.append(stats)
            layer_aux.append(aux)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        stacked = stack_layer_stats(per_layer) if collect_stats else {}
        moe_aux = (torch.zeros((), device=x.device)
                   if layer_aux[0] is None else torch.stack(layer_aux).mean())
        return x, stacked, moe_aux

    def _gathered(self, p, stack: str = "blocks") -> dict:
        """Layer view ``p`` of the stacked leaves under ``stack`` with its
        FSDP shards gathered (:func:`~repro_torch.models.common.
        gather_layer`; nested dicts, such as hymba's ``mamba`` branch,
        alike)."""
        return gather_layer(p, self.param_axes()[stack],
                            meta_tree(self)[stack])

    def _forward_block(self, p, x, positions, collect):
        """One layer of :meth:`forward`: (x, stats, aux), aux the layer's
        load-balance loss (None for a dense block).  The layer's FSDP
        shards are gathered here as it starts (the products keep them for
        the backward; under ``cfg.remat`` they are dropped and gathered
        again in the backward's recompute)."""
        x, _, stats = self._block(self._gathered(p), x, positions, collect)
        return x, stats, None

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
        positions = self._maybe_mrope(torch.arange(t, device=dev).expand(b, t))
        if prompt_len is None:
            plen = torch.full((b,), t, dtype=torch.int32, device=dev)
            kv_lens = None
        else:
            plen = torch.as_tensor(prompt_len, dtype=torch.int32,
                                   device=dev).reshape(-1).expand(b)
            kv_lens = plen
        x = embed_tokens(params["embed"], tokens,
                         self.cfg.vocab_size).to(self.dtype)
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
        positions = self._maybe_mrope(
            base[:, None] + torch.arange(t, dtype=torch.int32,
                                         device=token.device))
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
        logits = self._decode_layers(params, token,
                                     self._maybe_mrope(positions), lens + t,
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
        x = embed_tokens(params["embed"], token,
                         self.cfg.vocab_size).to(self.dtype)
        blocks = params["blocks"]
        for l in range(self.cfg.n_layers):
            x, _, _ = self._block(_layer(blocks, l), x, positions, False,
                                  cache=layer_cache(l), cache_len=new_len,
                                  paged=paged)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)

    def _maybe_mrope(self, positions: torch.Tensor) -> torch.Tensor:
        """(B, T) position ids, or the same ids three times as M-RoPE's (3,
        B, T) (temporal / height / width) when the config has sections."""
        if self.cfg.mrope_sections:
            return positions[None].expand((3,) + tuple(positions.shape))
        return positions

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

    def cache_axes(self) -> dict:
        """Logical axes of :meth:`init_cache`'s leaves (L, B, KH, S, .):
        slots on ``batch``, KV heads on ``kv_heads``."""
        ax = (None, "batch", "kv_heads", "kv_seq", None)
        keys = self._cache_keys()
        return dict({key: ax for key in keys}, len=None)

    def paged_cache_axes(self) -> dict:
        """Logical axes of :meth:`init_paged_cache`'s leaves (L, P, KH, ps,
        .): pages replicated (any slot's table may point anywhere), KV
        heads on ``kv_heads``, the dense cache's head split."""
        ax = (None, None, "kv_heads", None, None)
        return {key: ax for key in self._cache_keys()}

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
