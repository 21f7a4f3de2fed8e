"""Mixture-of-Experts LM (qwen2-moe, llama4-maverick): the local path of
``repro/models/moe.py``.

Dispatch is gather/scatter (sort-by-expert + capacity buffers), O(N·d),
never the one-hot einsum.  Experts are padded to a multiple of 16 and the
pad experts masked in the router.  The router stays full-precision; the
expert and shared-expert linears are quantizable sites.  Routed-expert
statistics are the reference's: ``mlp_in`` is the block input before
dispatch (all of a layer's experts share it), ``mlp_down`` the whole
``(E, C, f)`` expert hidden buffer, empty capacity slots included, and the
shared expert has its own ``shared_down`` site.

Nothing here accumulates with atomics, so a run gives the same bits twice
on the card: dispatch writes each kept (token, choice) to its own slot, and
combine adds each token's k expert rows in ascending expert order, one
rounding per add in the activation dtype, as the reference's scatter-add
does.  The top-k is a stable descending sort, so equal logits go to the
lower expert index first, as ``jax.lax.top_k`` does.  Packed expert weights
run through :func:`~repro_torch.kernels.ops.quant_matmul_experts`, one
launch per projection for all experts.

Capacity is a function of the routed token count N = B·T, as in the
reference: bucket-padding tokens of a batched prefill are routed and
compete for it, and a batched decode step depends on which requests share
the batch.  A speculative verify span routes each position on its own, so
that a burst drops the same tokens as sequential decode.

Expert parallelism (a serving engine's ``mesh=``, :meth:`MoELM.param_axes`
put E/m experts on each rank of ``model``): :func:`moe_ffn` routes this
rank's tokens (the sequence split over ``model`` where T divides, else
every rank routes the same tokens), exchanges the ``(m, E/m, C, d)``
dispatch buffer with one all_to_all, runs the local experts'
``quant_matmul_experts`` over ``m * C`` rows each, and sends the rows
back with a second.  Capacity is per (rank, expert) sub-batch, so the
result equals the local path where nothing drops.  Calibration
(``collect``) runs the local path on whole weights, as in the reference.

Training on a mesh (``make_train_step(mesh=)``): each layer gathers its
FSDP shards over ``data`` as it starts, the expert stacks on their
``fsdp`` dimension (d_model) too, and runs :func:`moe_ffn` under
autograd (see there); the aux loss is each rank's own on its tokens,
averaged over ``model`` here and over ``data`` by the train step, the
reference's ``pmean`` over ``model`` and the FSDP axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.core.stats import site_stat
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import (all_gather, all_reduce, all_to_all,
                                         copy_to)
from repro_torch.dist.sharding import axis_index, axis_size
from repro_torch.kernels.ops import quant_matmul_experts
from .common import (NEG_INF, column_input, make_generator, mesh_cuts,
                     normal_init, padded_vocab, qlinear, reduce_row_parallel,
                     rms_norm)
from .dense import DenseLM


def padded_experts(n_experts: int, multiple: int = 16) -> int:
    return ((n_experts + multiple - 1) // multiple) * multiple


def _capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    return max(1, int(n_tokens * k * factor / n_experts + 0.999))


def _route(x_flat, router_w, n_experts_real, k):
    """Top-k routing.  Returns (probs (N, k) f32, ids (N, k), aux_loss)."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    e_pad = router_w.shape[-1]
    pad_mask = torch.where(torch.arange(e_pad, device=logits.device)
                           < n_experts_real, 0.0, NEG_INF)
    logits = logits + pad_mask
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    probs = torch.softmax(topv, dim=-1)
    # switch-style load-balance aux loss
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    ce = torch.mean(F.one_hot(topi, e_pad).float().sum(dim=1), dim=0) / k
    aux = n_experts_real * torch.sum(me * ce)
    return probs, topi, aux


def _dispatch(x_flat, topi, probs, e_pad, capacity):
    """Sort-by-expert capacity dispatch.

    Returns (buffers (E, C, d), dest (N*k,), keep (N*k,), src (N*k,),
    gate (N*k,)), all in sorted-by-expert order.  Kept entries land in
    distinct slots; a dropped entry (rank >= capacity) adds nothing in the
    reference, so it is not written."""
    n, d = x_flat.shape
    k = topi.shape[-1]
    flat_e = topi.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=e_pad)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=x_flat.device) - offsets[sorted_e]
    kept = rank < capacity
    keep = kept.to(x_flat.dtype)
    dest = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    src = order // k
    gate = probs.reshape(-1)[order].to(x_flat.dtype)
    # dropped entries go to one trash row past the buffer (no host sync)
    trash = e_pad * capacity
    buf = x_flat.new_zeros((trash + 1, d))
    buf[torch.where(kept, dest, trash)] = x_flat[src]
    return buf[:trash].reshape(e_pad, capacity, d), dest, keep, src, gate


def _expert_matmul(x, w):
    """(E, C, d) @ per-expert weight; float tensor or QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        return quant_matmul_experts(x, w).to(x.dtype)
    return torch.bmm(x, w.to(x.dtype))


def _expert_ffn(buf, wg, wu, wd):
    """buf (E, C, d) through per-expert SwiGLU.  Returns (out, hidden)."""
    h = F.silu(_expert_matmul(buf, wg)) * _expert_matmul(buf, wu)
    return _expert_matmul(h, wd), h


def _combine(out_buf, dest, keep, src, gate, n, d):
    """Each token's sum of its kept expert rows times their gates, added
    in ascending expert order (the order of the reference's scatter-add
    over the sorted entries), starting from zero, in out_buf's dtype."""
    k = dest.shape[0] // n
    contrib = out_buf.reshape(-1, d)[dest] * (keep * gate)[:, None]
    # sorted entry p is token src[p]'s choice; a token's entries are
    # consecutive in token-major order after a stable sort by token
    by_token = torch.sort(src, stable=True).indices
    contrib = contrib[by_token].reshape(n, k, d)
    y = torch.zeros((n, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def moe_ffn_local(x, router_w, wg, wu, wd, cfg: ModelConfig,
                  collect: bool = False):
    """Single-device MoE FFN.  x: (B, T, d).  Returns (y, aux, stats)."""
    b, t, d = x.shape
    x_flat = x.reshape(-1, d)
    n = b * t
    e_pad = router_w.shape[-1]
    k = cfg.experts_per_token
    cap = _capacity(n, k, cfg.n_experts, cfg.moe_capacity_factor)
    probs, topi, aux = _route(x_flat, router_w, cfg.n_experts, k)
    buf, dest, keep, src, gate = _dispatch(x_flat, topi, probs, e_pad, cap)
    out_buf, hidden = _expert_ffn(buf, wg, wu, wd)
    y = _combine(out_buf, dest, keep, src, gate, n, d)
    stats = {}
    if collect:
        stats["mlp_down"] = site_stat(hidden)
    return y.reshape(b, t, d), aux, stats


def _moe_body_sharded(x, router_w, wg, wu, wd, *, cfg: ModelConfig,
                      data_axes=()):
    """One rank's expert-parallel MoE FFN over ``model``.  Shapes are this
    rank's: x (b, T, d) its tokens, ``router_w`` (d, E) whole, ``wg`` /
    ``wu`` (E/m, d, f) and ``wd`` (E/m, f, d) its experts (float or
    QuantizedTensor), experts ``rank * E/m ...``.  Returns (y (b, T, d),
    aux averaged over ``model`` and ``data_axes``)."""
    b, t, d = x.shape
    x_flat = x.reshape(-1, d)
    n = b * t
    e_pad = router_w.shape[-1]
    m = axis_size("model")
    e_loc = e_pad // m
    k = cfg.experts_per_token
    cap = _capacity(n, k, cfg.n_experts, cfg.moe_capacity_factor)
    probs, topi, aux = _route(x_flat, router_w, cfg.n_experts, k)
    buf, dest, keep, src, gate = _dispatch(x_flat, topi, probs, e_pad, cap)
    # exchange (E, C, d) as (dest rank, e_loc, C, d): after it, block j is
    # source rank j's rows for this rank's experts
    buf = all_to_all(buf.reshape(m, e_loc, cap, d), "model")
    buf = buf.transpose(0, 1).reshape(e_loc, m * cap, d)
    out_buf, _ = _expert_ffn(buf, wg, wu, wd)
    # back: rows return to their source rank; block j then holds expert
    # owner j's rows, so global expert j * e_loc + e matches the dispatch
    out_buf = out_buf.reshape(e_loc, m, cap, d).transpose(0, 1).contiguous()
    out_buf = all_to_all(out_buf, "model").reshape(e_pad, cap, d)
    y = _combine(out_buf, dest, keep, src, gate, n, d)
    ranks = m
    aux = all_reduce(aux, "model")
    for a in data_axes:
        aux = all_reduce(aux, a)
        ranks *= axis_size(a)
    return y.reshape(b, t, d), aux / ranks


def _expert_specs(w):
    """This rank's block of one expert weight, per child: the mesh axis of
    each dimension of a float ``(E, d_in, d_out)`` weight, or a dict of the
    same for a QuantizedTensor's ``codes`` / ``scale`` / ``zero`` (``(E,
    rows, d_out)``) and ``act_scale`` (``(E, d_in)``, None without one).
    Experts split over ``model``; the rest stays whole (the reference's
    FSDP also splits the input dimension over ``data``; the port's serving
    keeps it whole)."""
    spec = ("model", None, None)
    if not isinstance(w, QuantizedTensor):
        return spec
    return {"codes": spec, "scale": spec, "zero": spec,
            "act_scale": None if w.act_scale is None else ("model", None)}


def _n_experts(w) -> int:
    return (w.codes if isinstance(w, QuantizedTensor) else w).shape[-3]


def moe_ffn(x, router_w, wg, wu, wd, cfg: ModelConfig,
            collect: bool = False):
    """The MoE FFN: expert-parallel when the expert weights are this
    rank's E/m of them, local otherwise (and for ``collect``).  Tokens
    split over ``model`` on the sequence where T divides; the ranks' rows
    are gathered back.  Returns (y, aux, stats); aux is the mean over
    ``model`` of the ranks' own (the mean over ``data`` is the train
    step's, which averages the data ranks' losses and their gradients).

    Under autograd the split is the rank's part of the work: ``x`` passes
    ``copy_to`` before its tokens are sliced and the router (whole on
    every rank, used on the rank's tokens) passes it too, so both
    gradients arrive summed over ``model``; the two all_to_alls and the
    rows' all_gather carry the gradients back.  A sequence that ``model``
    does not split (every rank routes every token) is refused there: each
    expert would take every rank's copy of a token's gradient."""
    m = axis_size("model")
    if m == 1 or _n_experts(wg) == router_w.shape[-1]:
        return moe_ffn_local(x, router_w, wg, wu, wd, cfg, collect)
    if collect:
        raise ValueError("statistics are collected on whole expert weights "
                         "(the local path)")
    t = x.shape[1]
    split = t % m == 0
    if not split and torch.is_grad_enabled() and (
            x.requires_grad or router_w.requires_grad):
        raise ValueError(f"moe: training on {m} expert-parallel ranks "
                         f"splits the sequence, and {t} tokens do not "
                         f"split in {m}")
    if split:
        part = t // m
        x = copy_to(x, "model")[:, axis_index("model") * part:][:, :part]
        router_w = copy_to(router_w, "model")
    y, aux = _moe_body_sharded(x, router_w, wg, wu, wd, cfg=cfg)
    if split:
        y = all_gather(y, "model", dim=1)
    return y, aux, {}


class MoELM(DenseLM):
    """Dense attention + MoE FFN blocks, with an optional shared expert.

    Serving uses the dense cache only (no paged store, no int8 KV cache),
    as in the reference, whose MoE overrides the dense prefill / decode
    pair: :meth:`supports_paged` is False and the engine's ``paged=True``
    serves from the dense cache.  Speculative decoding is supported."""

    def __init__(self, cfg: ModelConfig):
        if cfg.kv_cache_bits == 8:
            raise NotImplementedError("the MoE family keeps a bf16 KV cache "
                                      "(as the reference's does)")
        super().__init__(cfg)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        in the config's dtype, the reference's tree: ``router`` (L, d,
        E_pad), ``wg_exp`` / ``wu_exp`` (L, E_pad, d, d_ff) and ``wd_exp``
        (L, E_pad, d_ff, d) normal with std 1/sqrt(n_in), the shared
        expert ``wg_sh`` / ``wu_sh`` / ``wd_sh`` as dense linears.  Each
        layer's expert stack is drawn in f32 and cast."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = make_generator(dev, seed)
        hd = cfg.head_dim_
        n_layers = cfg.n_layers
        e_pad = padded_experts(cfg.n_experts)

        def normal(shape, n_in, scale=None):
            scale = (1.0 / n_in) ** 0.5 if scale is None else scale
            return normal_init(gen, shape, scale, self.dtype, dev, n_layers)

        def ones(*shape):
            return torch.ones(shape, dtype=self.dtype, device=dev)

        d, h, kv, f = (cfg.d_model, cfg.n_heads * hd, cfg.n_kv_heads * hd,
                       cfg.d_ff)
        blocks = {
            "attn_norm": ones(n_layers, d),
            "wq": normal((d, h), d),
            "wk": normal((d, kv), d),
            "wv": normal((d, kv), d),
            "wo": normal((h, d), h),
            "mlp_norm": ones(n_layers, d),
            "router": normal((d, e_pad), d),
            "wg_exp": normal((e_pad, d, f), d),
            "wu_exp": normal((e_pad, d, f), d),
            "wd_exp": normal((e_pad, f, d), f),
        }
        if cfg.n_shared_experts:
            f_sh = cfg.shared_expert_ff
            blocks.update(wg_sh=normal((d, f_sh), d),
                          wu_sh=normal((d, f_sh), d),
                          wd_sh=normal((f_sh, d), f_sh))
        v_pad = padded_vocab(cfg.vocab_size)
        embed = torch.empty((v_pad, d), dtype=self.dtype, device=dev)
        embed.copy_(torch.randn((v_pad, d), generator=gen, device=dev) * 0.02)
        head = torch.empty((d, v_pad), dtype=self.dtype, device=dev)
        head.copy_(torch.randn((d, v_pad), generator=gen, device=dev)
                   * (1.0 / d) ** 0.5)
        return {"embed": embed, "blocks": blocks, "final_norm": ones(d),
                "lm_head": head}

    def tp_all_reduces(self, mesh, prefill: bool = False) -> int:
        """Not counted: a MoE step also exchanges tokens (all_to_all)."""
        raise ValueError("moe: its steps also run all_to_alls")

    def param_axes(self) -> dict:
        """Logical axes of :meth:`init`'s tree: the dense attention's, the
        router whole, experts on ``experts``, the shared expert on
        ``ff``."""
        ax = DenseLM.param_axes(self)
        blocks = {k: v for k, v in ax["blocks"].items()
                  if k in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")}
        blocks.update({
            "router": (None, None, None),
            "wg_exp": (None, "experts", "fsdp", None),
            "wu_exp": (None, "experts", "fsdp", None),
            "wd_exp": (None, "experts", None, "fsdp"),
        })
        if self.cfg.n_shared_experts:
            blocks.update({
                "wg_sh": (None, "fsdp", "ff"),
                "wu_sh": (None, "fsdp", "ff"),
                "wd_sh": (None, "ff", "fsdp"),
            })
        return dict(ax, blocks=blocks)

    def quant_site_map(self) -> dict:
        m = {
            ("blocks", "wq"): "attn_in",
            ("blocks", "wk"): "attn_in",
            ("blocks", "wv"): "attn_in",
            ("blocks", "wo"): "attn_out",
            ("blocks", "wg_exp"): "mlp_in",
            ("blocks", "wu_exp"): "mlp_in",
            ("blocks", "wd_exp"): "mlp_down",
        }
        if self.cfg.n_shared_experts:
            m.update({
                ("blocks", "wg_sh"): "mlp_in",
                ("blocks", "wu_sh"): "mlp_in",
                ("blocks", "wd_sh"): "shared_down",
            })
        return m

    # -- block -------------------------------------------------------------
    def _moe_block(self, p, x, positions, collect, *, cache=None,
                   cache_len=None, kv_lens=None):
        """Attention + MoE FFN (+ shared expert).  Returns (x, kv, stats,
        aux)."""
        cfg = self.cfg
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        stats = {}
        if collect:
            stats["attn_in"] = site_stat(h)
        attn_out, kv, o_pre = self._attn(p, h, positions, cache=cache,
                                         cache_len=cache_len, kv_lens=kv_lens)
        if collect:
            stats["attn_out"] = site_stat(o_pre)
        x = x + attn_out
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        if collect:
            stats["mlp_in"] = site_stat(h)
        experts = (p["router"], p["wg_exp"], p["wu_exp"], p["wd_exp"])
        if cache is not None and h.shape[1] > 1:
            # speculative verify span: route each position on its own, so
            # the capacity cutoff (a function of the routed token count)
            # drops what sequential T = 1 decode drops
            outs, auxes = [], []
            for i in range(h.shape[1]):
                y_i, aux_i, _ = moe_ffn(h[:, i:i + 1], *experts, cfg)
                outs.append(y_i)
                auxes.append(aux_i)
            y = torch.cat(outs, dim=1)
            aux = torch.stack(auxes).mean()
        else:
            y, aux, moe_stats = moe_ffn(h, *experts, cfg, collect)
            stats.update(moe_stats)
        if cfg.n_shared_experts:
            h = column_input(h, p["wg_sh"], cfg.shared_expert_ff)
            hidden = F.silu(qlinear(h, p["wg_sh"])) * qlinear(h, p["wu_sh"])
            if collect:
                stats["shared_down"] = site_stat(hidden)
            y = y + reduce_row_parallel(qlinear(hidden, p["wd_sh"]),
                                        hidden.shape[-1],
                                        cfg.shared_expert_ff)
        return x + y, kv, stats, aux

    def _block(self, p, x, positions, collect, *, cache=None, cache_len=None,
               kv_lens=None, paged=None):
        if paged is not None:
            raise NotImplementedError("the MoE family serves from the dense "
                                      "cache")
        x, kv, stats, _ = self._moe_block(p, x, positions, collect,
                                          cache=cache, cache_len=cache_len,
                                          kv_lens=kv_lens)
        return x, kv, stats

    def _forward_block(self, p, x, positions, collect):
        """One layer of :meth:`forward` on its FSDP-gathered weights (the
        expert stacks on their ``fsdp`` dimension too): (x, stats, aux)."""
        x, _, stats, aux = self._moe_block(self._gathered(p), x, positions,
                                           collect)
        return x, stats, aux

    def _microbatch_collectives(self, mesh, remat: bool) -> dict:
        """:meth:`DenseLM._microbatch_collectives` of the MoE stack: per
        layer the FSDP gathers of its cut leaves (the expert stacks
        included), the attention's sums where it is cut on heads (``a``),
        and where the experts are cut over ``model`` (``e``) the aux
        loss's all_reduce, the backward sums of the block input and the
        router (``copy_to``), two all_to_alls each way and the rows'
        all_gather; the shared expert's two sums where ``ff`` cuts it
        (``f``).  ``remat`` recomputes the gathers, ``wo``'s sum, the aux
        all_reduce, the forward all_to_alls and the rows' all_gather
        (torch's checkpoint stops before the shared expert's sum)."""
        cut, gathered = mesh_cuts(self, mesh)
        n, g = self.cfg.n_layers, gathered("['blocks']")
        a = cut("['blocks']['wq']", "model")
        e = cut("['blocks']['wg_exp']", "model")
        f = cut("['blocks']['wg_sh']", "model")
        v = cut("['embed']", "model")
        gathers = n * g + gathered("['embed']") + gathered("['lm_head']")
        return {"all_gather": gathers + v + n * e + remat * n * (g + e),
                "reduce_scatter": gathers,
                "all_reduce": 2 * v + n * (2 * a + 3 * e + 2 * f
                                           + remat * (a + e)),
                "all_to_all": n * (4 * e + remat * 2 * e)}

    # -- entry points --------------------------------------------------------
    # The reference's MoE overrides the dense prefill / decode pair (same
    # cache layout, same span-write attention); so do these, which makes
    # DenseLM.supports_paged False, as there.
    def prefill(self, params, tokens, cache, prompt_len=None):
        """:meth:`DenseLM.prefill` through the MoE blocks (dense cache)."""
        return DenseLM.prefill(self, params, tokens, cache, prompt_len)

    def decode_step(self, params, cache, token):
        """:meth:`DenseLM.decode_step` through the MoE blocks; T > 1 (a
        verify burst) routes each position on its own."""
        return DenseLM.decode_step(self, params, cache, token)

    def supports_spec(self) -> bool:
        """The MoE decode pair keeps the dense cache layout and span-write
        attention, so speculative verification works; a subclass that
        overrides the pair again declines."""
        return (type(self).prefill is MoELM.prefill
                and type(self).decode_step is MoELM.decode_step)
