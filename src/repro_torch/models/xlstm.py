"""xLSTM LM: mLSTM blocks with an sLSTM block every ``slstm_every``
layers (the reference's ``repro/models/xlstm.py``).

Every layer's parameters hold **both** block types, as the reference's
(whose layer scan stays homogeneous); layer l runs the sLSTM branch when
``l % slstm_every == slstm_every - 1`` and the mLSTM branch otherwise,
selected by a Python ``if`` (the reference's ``lax.cond``).  A forward
that collects statistics runs both branches in every layer, as the
reference's does, so every layer reports the four sites ``xin``,
``m_qkv``, ``m_out`` and ``s_out`` (``s_out`` of an mLSTM layer is the
sLSTM branch's, computed there and not used).

The recurrent state replaces the KV cache and is O(1) in the sequence
length: ``mlstm`` {C (L, B, H, hd_m, hd_m), n (L, B, H, hd_m)} and
``slstm`` a list of four (L, B, H, hd_s) arrays (h, c, n, m), all f32.
The mLSTM head is d_inner / H wide, the sLSTM head d_model / H.
``prefill`` takes no ``prompt_len``, so the serving engine admits xLSTM one
request at a time at its exact length (``SingleAdmission``), from the
dense cache only (no page store, no speculative verify).  Prefill and
decode write the state in place.

Tensor parallelism (``ServeEngine(mesh=)``): each rank runs its block of
the mLSTM heads (their state ``C`` / ``n`` cut on ``heads``) and the whole
sLSTM (its state whole on every rank); see
:mod:`~repro_torch.models.ssm`.  The collectives of a step: the
embedding's all_reduce, one all_reduce per mLSTM layer (the heads'
outputs put together, each rank's in its place and zeros elsewhere,
before a whole output norm and ``down_proj``) and the logits'
all_gather.
"""
from __future__ import annotations

import torch

from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from . import ssm
from .common import (dense_init, embed_tokens, logits_from_hidden,
                     padded_vocab, rms_norm, run_block, stack_layer_stats)
from .dense import DenseLM, _layer


class XLSTMLM(DenseLM):
    # this family's own layers take no FSDP gather or copy_to: no training
    # on a mesh yet (ROADMAP: mesh training of the non-dense families)
    mesh_training = False

    @property
    def _d_inner(self) -> int:
        return self.cfg.ssm_expand * self.cfg.d_model

    def _is_slstm(self, l: int) -> bool:
        k = self.cfg.slstm_every
        return bool(k) and l % k == k - 1

    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        in the config's dtype, the reference's tree: ``embed`` (std 0.02),
        ``blocks`` {``norm``, ``mlstm`` (:func:`~repro_torch.models.ssm.
        mlstm_init`), ``slstm`` (:func:`~repro_torch.models.ssm.
        slstm_init`)}, ``final_norm``, ``lm_head``."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        v_pad = padded_vocab(cfg.vocab_size)
        d, n_layers = cfg.d_model, cfg.n_layers
        return {
            "embed": dense_init(gen, v_pad, d, self.dtype, dev, scale=0.02),
            "blocks": {
                "norm": torch.ones((n_layers, d), dtype=self.dtype,
                                   device=dev),
                "mlstm": ssm.mlstm_init(gen, n_layers, d, self._d_inner,
                                        cfg.n_heads, self.dtype, dev),
                "slstm": ssm.slstm_init(gen, n_layers, d, cfg.n_heads,
                                        self.dtype, dev),
            },
            "final_norm": torch.ones((d,), dtype=self.dtype, device=dev),
            "lm_head": dense_init(gen, d, v_pad, self.dtype, dev),
        }

    def param_axes(self) -> dict:
        """Logical axes of :meth:`init`'s tree (the reference's)."""
        return {
            "embed": ("vocab", "fsdp"),
            "blocks": {"norm": (None, None),
                       "mlstm": ssm.mlstm_axes(),
                       "slstm": ssm.slstm_axes()},
            "final_norm": (None,),
            "lm_head": ("fsdp", "vocab"),
        }

    def _layers_all_reduces(self, a: int, f: int, prefill: bool) -> int:
        """One in each mLSTM layer where its heads are cut (the heads'
        outputs put together); the sLSTM layers run whole."""
        n = self.cfg.n_layers
        return f * (n - n // self.cfg.slstm_every)

    def cache_axes(self) -> dict:
        """Logical axes of :meth:`init_cache`'s leaves: the mLSTM state on
        ``heads`` (the reference's); the sLSTM state, a list of four, whole
        (the reference cuts it on ``heads``, but the port's ranks run the
        whole sLSTM)."""
        return {"mlstm": {"C": (None, "batch", "heads", None, None),
                          "n": (None, "batch", "heads", None)},
                "slstm": [(None, "batch", None, None)] * 4,
                "len": None}

    def quant_site_map(self) -> dict:
        return {
            ("blocks", "mlstm", "up_proj"): "xin",
            ("blocks", "mlstm", "wq"): "m_qkv",
            ("blocks", "mlstm", "wk"): "m_qkv",
            ("blocks", "mlstm", "wv"): "m_qkv",
            ("blocks", "mlstm", "down_proj"): "m_out",
            ("blocks", "slstm", "w_in"): "xin",
            ("blocks", "slstm", "out_proj"): "s_out",
        }

    # -- forward -------------------------------------------------------------
    def _forward_block(self, p, x, is_s, collect):
        """One layer of :meth:`forward`: (x, stats)."""
        n_heads = self.cfg.n_heads
        h = rms_norm(x, p["norm"], self.cfg.norm_eps)
        if not collect:
            if is_s:
                return x + ssm.slstm_scan(p["slstm"], h, n_heads), {}
            return x + ssm.mlstm_chunked(p["mlstm"], h, n_heads), {}
        seen = {}
        cb = lambda name, val: seen.__setitem__(name, site_stat(val))
        y_m = ssm.mlstm_chunked(p["mlstm"], h, n_heads, collect_cb=cb)
        y_s = ssm.slstm_scan(p["slstm"], h, n_heads, collect_cb=cb)
        stats = {"xin": site_stat(h), "m_qkv": seen["mlstm_in"],
                 "m_out": seen["mlstm_out"], "s_out": seen["slstm_out"]}
        return x + (y_s if is_s else y_m), stats

    def forward(self, params, batch, collect_stats: bool = False):
        """Full forward (training / evaluation / calibration).  Returns
        (logits, aux) with aux = {"stats": {site: {key: (L, ...)}},
        "moe_aux": 0}.  Differentiable; ``cfg.remat`` recomputes each
        block in the backward."""
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens,
                         self.cfg.vocab_size).to(self.dtype)
        blocks = params["blocks"]
        per_layer = []
        for l in range(self.cfg.n_layers):
            x, stats = run_block(self.cfg.remat, self._forward_block,
                                 _layer(blocks, l), x, self._is_slstm(l),
                                 collect_stats)
            per_layer.append(stats)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        stacked = stack_layer_stats(per_layer) if collect_stats else {}
        return logits, {"stats": stacked,
                        "moe_aux": torch.zeros((), device=x.device)}

    # -- recurrent "cache" ---------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """The zero state of every layer (``max_len`` does not size it)."""
        cfg = self.cfg
        dev = resolve_device(device)
        rep = lambda leaf: leaf[None].repeat((cfg.n_layers,)
                                             + (1,) * leaf.dim())
        m_state = ssm.mlstm_state_init(batch, cfg.n_heads,
                                       self._d_inner // cfg.n_heads, dev)
        s_state = ssm.slstm_state_init(batch, cfg.n_heads,
                                       cfg.d_model // cfg.n_heads, dev)
        return {"mlstm": {k: rep(v) for k, v in m_state.items()},
                "slstm": [rep(v) for v in s_state],
                "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def _layers(self, params, x, cache, step):
        """Run every layer from the cache's state with ``step`` (the
        mLSTM's and the sLSTM's (block params, h, state) -> (y, state)),
        writing each layer's new state into the cache in place; returns
        the final-normed hidden state."""
        blocks, mst, sst = params["blocks"], cache["mlstm"], cache["slstm"]
        m_step, s_step = step
        for l in range(self.cfg.n_layers):
            p = _layer(blocks, l)
            h = rms_norm(x, p["norm"], self.cfg.norm_eps)
            if self._is_slstm(l):
                y, new = s_step(p["slstm"], h, [leaf[l] for leaf in sst])
                for leaf, value in zip(sst, new):
                    leaf[l] = value
            else:
                y, new = m_step(p["mlstm"], h,
                                {k: leaf[l] for k, leaf in mst.items()})
                for k, leaf in mst.items():
                    leaf[l] = new[k]
            x = x + y
        return x

    @torch.no_grad()
    def prefill(self, params, tokens, cache):
        """Run the prompt from the cache's state and keep each layer's final
        state (in place): the chunked mLSTM with ``return_state``, the sLSTM
        scan's final carry.  Returns (logits of the last position (B, 1,
        V), cache) with ``len`` = T."""
        b, t = tokens.shape
        n_heads = self.cfg.n_heads
        x = embed_tokens(params["embed"], tokens,
                         self.cfg.vocab_size).to(self.dtype)
        x = self._layers(params, x, cache, (
            lambda p, h, st: ssm.mlstm_chunked(p, h, n_heads, state=st,
                                               return_state=True),
            lambda p, h, st: ssm.slstm_scan_final(p, h, n_heads, st)))
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=torch.full((b,), t, dtype=torch.int32,
                                                  device=tokens.device))

    @torch.no_grad()
    def decode_step(self, params, cache, token):
        """One decode step: token (B, 1) int32.  Advances each layer's state
        in place; returns (logits (B, 1, V), cache) with ``len`` + 1."""
        if token.shape[1] != 1:
            raise ValueError("xLSTM decodes one token per step (its "
                             "recurrent state has no span write)")
        n_heads = self.cfg.n_heads
        x = embed_tokens(params["embed"], token,
                         self.cfg.vocab_size).to(self.dtype)
        x = self._layers(params, x, cache, (
            lambda p, h, st: ssm.mlstm_step(p, h, st, n_heads),
            lambda p, h, st: ssm.slstm_step(p, h, st, n_heads)))
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = logits_from_hidden(x, params["lm_head"], self.cfg.vocab_size)
        return logits, dict(cache, len=cache["len"].to(torch.int32) + 1)
