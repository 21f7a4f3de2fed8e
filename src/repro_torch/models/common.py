"""Shared model primitives: init, norms, RoPE, chunked attention, SwiGLU,
linears.

All weights are stored ``(n_in, n_out)`` (``y = x @ W``) so the quantizer's
input-channel-group convention applies directly.  Every quantizable matmul
goes through :func:`qlinear`, which dispatches on the leaf type: plain
tensors matmul directly; :class:`~repro_torch.core.quantizer.QuantizedTensor`
leaves route through the dequant-matmul kernel (serving path).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.dist.collectives import (all_gather, all_reduce, copy_to,
                                          step_totals)
from repro_torch.dist.sharding import (MeshShape, active_mesh, active_rules,
                                       axis_index, axis_rules, axis_size,
                                       logical_to_spec, spec_axes,
                                       training_rules, tree_specs)
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, flash_attention
from repro_torch.kernels.ops import quant_matmul
# the row kernel on a CUDA tensor (a row's bits do not depend on how many
# rows come with it), its plain version on a CPU tensor
from repro_torch.kernels.rms_norm import rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def make_generator(dev: torch.device, seed: int):
    """``torch.Generator(dev).manual_seed(seed)``; None on the meta device,
    whose init gives the tree's shapes alone (nothing is drawn)."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def dense_init(gen: torch.Generator, n_in: int, n_out: int, dtype, device,
               scale: Optional[float] = None,
               stack: Optional[int] = None) -> torch.Tensor:
    """An (n_in, n_out) matrix, or ``stack`` of them (L, n_in, n_out), drawn
    from ``gen`` normal with std ``scale`` (default ``1/sqrt(n_in)``).  Each
    matrix is drawn in f32 and cast to ``dtype``, so the f32 temporary is
    one matrix."""
    scale = (1.0 / n_in) ** 0.5 if scale is None else scale
    return normal_init(gen, (n_in, n_out), scale, dtype, device, stack)


def normal_init(gen: torch.Generator, shape: tuple, scale: float, dtype,
                device, stack: Optional[int] = None) -> torch.Tensor:
    """``shape``, or (stack, *shape), of normal draws from ``gen`` times
    ``scale``, one ``shape`` at a time in f32, cast to ``dtype``.  On the
    meta device the shape alone (nothing drawn; ``gen`` may be None)."""
    shape = tuple(shape)
    out = torch.empty(shape if stack is None else (stack,) + shape,
                      dtype=dtype, device=device)
    if out.is_meta:
        return out
    for view in (out,) if stack is None else out:
        view.copy_(torch.randn(shape, generator=gen, device=device) * scale)
    return out


def run_block(remat: bool, block, *args):
    """``block(*args)``; with ``remat`` and grad enabled its activations are
    recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``).  Under a mesh the recompute runs in
    the forward's ``(mesh, rules)`` context (autograd may run it in a
    thread that has none), so it re-runs the block's collectives."""
    if remat and torch.is_grad_enabled():
        mesh = active_mesh()
        if mesh is None:
            return checkpoint(block, *args, use_reentrant=False)
        rules = active_rules()
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              axis_rules(mesh, rules)))
    return block(*args)


def stack_layer_stats(per_layer: list) -> dict:
    """Per-layer ``{site: {key: tensor}}`` -> ``{site: {key: (L, ...)}}``
    (empty when the layers collected nothing)."""
    if not per_layer or not per_layer[0]:
        return {}
    return {site: {key: torch.stack([s[site][key] for s in per_layer])
                   for key in per_layer[0][site]}
            for site in per_layer[0]}


# ---------------------------------------------------------------------------
# Linear dispatch (FP or quantized)
# ---------------------------------------------------------------------------

def qlinear(x: torch.Tensor, w,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` where ``w`` is a tensor or a QuantizedTensor, in
    ``out_dtype`` (default x's dtype; float32 from bf16 x: the f32 sums
    unrounded, ``w`` as x's dtype takes it)."""
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x, w, out_dtype)
    w = w.to(x.dtype)
    if out_dtype in (None, x.dtype):
        return x @ w
    return x.to(out_dtype) @ w.to(out_dtype)


def out_width(w) -> int:
    """The output columns of ``w`` (a tensor or a QuantizedTensor)."""
    return (w.codes if isinstance(w, QuantizedTensor) else w).shape[-1]


def in_width(w) -> int:
    """The input rows of ``w`` (a tensor or a QuantizedTensor)."""
    return w.n_in if isinstance(w, QuantizedTensor) else w.shape[-2]


def column_input(x: torch.Tensor, w, full: int) -> torch.Tensor:
    """``x`` as the input of a product with ``w``: a ``w`` of fewer than
    ``full`` output columns is this rank's column shard over ``model``, and
    ``x`` (the same on every rank) then passes :func:`copy_to`, whose
    gradient sums the ranks' parts over ``model``."""
    return copy_to(x, "model") if out_width(w) < full else x


def fsdp_gather(w, dim: int, full: int):
    """The FSDP gather of a float ``w`` whose ``dim`` is its ``fsdp`` axis,
    of logical size ``full``: where the active rules cut that axis over
    ``data`` (:func:`~repro_torch.dist.sharding.logical_to_spec`, as
    ``shard_tree`` and ``tree_specs`` read them), ``w`` is this rank's
    shard, gathered whole (the gradient summed over ``data`` and cut back
    to the shard: a reduce_scatter); else (no mesh, serving's rules,
    ``data`` 1 or not dividing ``full``) ``w`` itself.  The gathered weight
    lives as long as autograd keeps it: without ``remat`` a product saves
    it for the backward, so every layer's stays until its backward."""
    mesh = active_mesh()
    if isinstance(w, QuantizedTensor) or mesh is None:
        return w
    cut = spec_axes(logical_to_spec(("fsdp",), shape=(full,), mesh=mesh),
                    mesh)
    if not cut:
        return w
    return all_gather(w, "data", dim=dim, reduce_grad=True)


def fsdp_leaf(w, axes, full: int):
    """``w`` annotated ``axes`` (its logical axes; a layer's view of a
    stacked leaf lacks the leading layer axis, so dimensions count from the
    end), gathered over ``data`` where the rules cut its ``fsdp`` dimension
    of logical size ``full`` (:func:`fsdp_gather`); ``w`` itself where
    ``axes`` names no ``fsdp``."""
    if not isinstance(axes, tuple) or "fsdp" not in axes:
        return w
    return fsdp_gather(w, axes.index("fsdp") - len(axes), full)


def gather_layer(p: dict, axes, shapes: dict) -> dict:
    """A layer's view ``p`` (nested dicts of its leaves) with every float
    leaf whose annotation in ``axes`` (the stacked leaves' logical axes,
    :meth:`param_axes`'s subtree) names ``fsdp`` gathered over ``data``
    (:func:`fsdp_leaf`, the dimension's logical size read from ``shapes``,
    the stacked leaves' logical tree: :func:`meta_tree`)."""
    out = {}
    for key, w in p.items():
        ax = axes.get(key) if isinstance(axes, dict) else None
        if isinstance(w, dict):
            out[key] = gather_layer(w, ax, shapes[key])
        elif isinstance(ax, tuple) and "fsdp" in ax:
            full = shapes[key].shape[ax.index("fsdp") - len(ax)]
            out[key] = fsdp_leaf(w, ax, full)
        else:
            out[key] = w
    return out


def meta_tree(model) -> dict:
    """``model.init``'s tree on the meta device (shapes alone), made once
    and kept on the model (``model._meta``): the logical sizes the FSDP
    gathers and the collectives formulas read."""
    if model._meta is None:
        model._meta = model.init(device="meta")
    return model._meta


def mesh_cuts(model, mesh):
    """(cut, gathered) under ``mesh``'s training rules for ``model``:
    ``cut(key, axis)`` 1 where ``axis`` cuts the leaf of checkpoint key
    ``key``, ``gathered(prefix)`` the leaves under ``prefix`` cut on
    ``data`` (one FSDP gather each per use)."""
    specs = tree_specs(meta_tree(model), model.param_axes(), mesh,
                       training_rules(model.cfg, mesh))

    def cut(key, axis):
        return int(axis in spec_axes(specs.get(key), mesh))

    def gathered(prefix):
        return sum("data" in spec_axes(s, mesh) for k, s in specs.items()
                   if k.startswith(prefix))
    return cut, gathered


def collectives_per_step(model, mesh_shape, *, remat: bool = False,
                         microbatches: int = 1,
                         grad_compress: bool = False) -> dict:
    """Collective calls per kind of one train step of ``model``
    (``make_train_step(mesh=)``) on a ``(data, model)`` mesh of
    ``mesh_shape``: the model's ``_microbatch_collectives`` per microbatch
    and the step's own (:func:`~repro_torch.dist.collectives.
    step_totals`)."""
    return step_totals(model._microbatch_collectives(MeshShape(mesh_shape),
                                                     remat),
                       mesh_shape, microbatches=microbatches,
                       grad_compress=grad_compress)


def for_part(x: torch.Tensor, part: bool) -> torch.Tensor:
    """``x`` (a weight or an activation, the same on every rank of
    ``model``) where it meets only this rank's part of the work
    (``part``: the rank's channels, heads or tokens): it passes
    :func:`copy_to`, so its gradient, a partial sum on each rank, arrives
    summed over ``model``; ``x`` itself otherwise."""
    return copy_to(x, "model") if part else x


# ---------------------------------------------------------------------------
# Norms (rms_norm is the kernel imported above)
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias over the last axis, in f32, cast to x's dtype
    (whisper).  Plain PyTorch on any device, as the reference's is plain
    jnp."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mu).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotary embedding.

    ``x``: (B, T, H, hd).  ``positions``: (B, T) for standard RoPE or
    (3, B, T) for M-RoPE: temporal / height / width position ids per
    token, section i of the hd/2 frequencies rotated by row i (text-only
    inputs pass the same ids three times, which reduces exactly to
    standard RoPE).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    if mrope_sections is None:
        ang = positions.float()[..., None] * freqs          # (B, T, hd/2)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, B, T) position ids, got "
                             f"{tuple(positions.shape)}")
        secs, start = [], 0
        for i, sec in enumerate(mrope_sections):
            secs.append(positions[i].float()[..., None]
                        * freqs[start:start + sec])
            start += sec
        ang = torch.cat(secs, dim=-1)                       # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: chunked (flash-style) for train/prefill; decode attention is
# the flash-decode kernel (kernels/ops.py::decode_attention).
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      q_offset: int = 0,
                      chunk: int = 512,
                      kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory-O(T·chunk) attention with an online softmax over KV chunks.

    q: (B, Tq, H, hd); k, v: (B, Tk, KH, hd) with H % KH == 0 (GQA).
    ``q_offset`` is the absolute position of q[0].  ``window`` enables
    sliding-window masking.  ``kv_lens`` (B,) int32 masks keys at positions
    >= kv_lens[b] — the length-aware causal mask for bucket-padded batched
    prefill.

    Causal windowed self-attention from position 0 longer than twice the
    window runs :func:`local_window_attention`, as in the reference.  On a
    CUDA tensor, self-attention from position 0 (Tq == Tk) with hd <=
    128 and no window runs the flash-attention kernel in the grouped GQA
    layout, at any T and with or without ``kv_lens``: every prefill.  The
    kernel's rows do not depend on T, the bucket or the batch, so a
    bucket-padded batched prefill gives each prompt the bits of its exact-
    length batch-1 prefill.  (The reference's TPU condition, T a multiple
    of 128 and no ``kv_lens``, is a TPU tiling rule, not semantics.)
    Everything else, and every CPU tensor, runs the chunked path below in
    plain PyTorch, the parity path against the reference.
    """
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if (kv_lens is None and window is not None and causal and tq == tk
            and q_offset == 0 and tk > 2 * window):
        # sliding-window self-attention: the block-local path is O(T * 2w)
        # instead of O(T^2)
        return local_window_attention(q, k, v, window)
    if (q.is_cuda and window is None and q_offset == 0 and tq == tk
            and hd <= MAX_HEAD_DIM):
        g = h // kh
        qr = q.reshape(b, tq, kh, g, hd).permute(0, 2, 3, 1, 4) \
              .reshape(b * kh, g, tq, hd)
        kr = k.permute(0, 2, 1, 3).reshape(b * kh, tk, hd)
        vr = v.permute(0, 2, 1, 3).reshape(b * kh, tk, hd)
        o = flash_attention(qr, kr, vr, causal=causal, kv_lens=kv_lens)
        return o.reshape(b, kh, g, tq, hd).permute(0, 3, 1, 2, 4) \
                .reshape(b, tq, h, hd)
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    chunk = min(chunk, tk)
    n_chunks = tk // chunk
    scale = hd ** -0.5
    q32 = q.float() * scale
    qpos = q_offset + torch.arange(tq, device=q.device)

    def attend_block(carry, kb, vb, kpos):
        m, l, acc = carry
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float())
        mask = torch.ones((tq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        if kv_lens is not None:
            mask = (mask[None] & (kpos[None, None, :]
                                  < kv_lens[:, None, None]))[:, None]
        else:
            mask = mask[None, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb.float())
        return m_new, l_new, acc_new

    carry = (torch.full((b, h, tq), -torch.inf, device=q.device),
             torch.zeros((b, h, tq), device=q.device),
             torch.zeros((b, h, tq, hd), device=q.device))
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry = attend_block(carry, k[:, sl], v[:, sl],
                             torch.arange(sl.start, sl.stop, device=q.device))
    if tk > n_chunks * chunk:
        sl = slice(n_chunks * chunk, tk)
        carry = attend_block(carry, k[:, sl], v[:, sl],
                             torch.arange(sl.start, sl.stop, device=q.device))
    m, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)            # (B, Tq, H, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def reduce_row_parallel(y: torch.Tensor, local: int,
                        full: int) -> torch.Tensor:
    """``y`` of a row-parallel product, summed over ``model``: a product
    whose input dimension is this rank's ``local`` of ``full`` columns is
    a partial sum (one all_reduce); a whole one is ``y`` itself."""
    return all_reduce(y, "model") if local < full else y


def row_parallel_f32(x: torch.Tensor, w, full: int) -> torch.Tensor:
    """``x @ w`` where ``x`` may hold this rank's ``x.shape[-1]`` of
    ``full`` input columns (``w`` their rows): then the rank's partial
    product is taken in f32 before its rounding (quant_matmul's f32
    output), the partials are summed over ``model`` in f32 and the sum is
    rounded once to ``x``'s dtype, as the single-device product rounds
    once; else ``qlinear(x, w)``.  A second rounding's error reaches the
    selective scan's ``exp(dt * A)`` amplified, so the hybrid family takes
    this where the others take :func:`reduce_row_parallel`."""
    if x.shape[-1] >= full:
        return qlinear(x, w)
    return all_reduce(qlinear(x, w, torch.float32), "model").to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return qlinear(F.silu(qlinear(x, w_gate)) * qlinear(x, w_up), w_down)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Row lookup.  Given the model's ``vocab_size``, a table of fewer rows
    than its padded vocabulary is this rank's vocab shard (rows ``rank *
    rows ...``): a masked local lookup (ids outside the shard read zeros)
    and one all_reduce over ``model``, which adds each id's row to zeros
    exactly."""
    rows = embedding.shape[0]
    if (vocab_size is None or axis_size("model") == 1
            or rows >= padded_vocab(vocab_size)):
        return F.embedding(tokens.long(), embedding)
    ids = tokens.long() - axis_index("model") * rows
    mine = (ids >= 0) & (ids < rows)
    x = F.embedding(torch.where(mine, ids, 0), embedding)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return all_reduce(x, "model")


# rows per lm_head product: every call has this many rows (zero-padded)
LM_HEAD_ROWS = 64


def _fixed_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a ``fn`` that maps rows (axis 0) independently,
    computed on blocks of exactly :data:`LM_HEAD_ROWS` rows, each read from
    a freshly allocated zero-padded buffer.  A library GEMM picks its
    kernel, and so its summation order, from the shape and the operands'
    alignment; fixing both makes a row's bits independent of how many rows
    come with it (a decode step of any batch, a verify pass of B * (K + 1)
    rows)."""
    outs = []
    for i in range(0, x.shape[0], LM_HEAD_ROWS):
        rows = x[i:i + LM_HEAD_ROWS]
        buf = torch.zeros((LM_HEAD_ROWS,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        buf[:rows.shape[0]] = rows
        outs.append(fn(buf)[:rows.shape[0]])
    return torch.cat(outs)


def _fixed_rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over any leading dims, in :func:`_fixed_rows` blocks."""
    lead, d = x.shape[:-1], x.shape[-1]
    w = w.to(x.dtype)
    return _fixed_rows(lambda rows: torch.matmul(rows, w),
                       x.reshape(-1, d)).reshape(lead + (w.shape[-1],))


def logits_from_hidden(x: torch.Tensor, lm_head, vocab_size: int) -> torch.Tensor:
    """Final projection.  Logits keep the *padded* vocab width; padded
    columns get a -1e30 additive mask so softmax, cross-entropy, and argmax
    all behave as if the vocab were unpadded.  A float head is multiplied
    in fixed-size row blocks, so each row's logits are the same bits at any
    batch (:func:`_fixed_rows_matmul`).  A head of fewer columns than the
    padded vocabulary is this rank's vocab shard (columns ``rank * cols
    ...``): the rank's columns, masked by their global index, then one
    all_gather over ``model`` to the padded width (under autograd the
    hidden state passes :func:`copy_to` first, and each rank's gradient is
    its columns' block)."""
    cols = out_width(lm_head)
    sharded = axis_size("model") > 1 and cols < padded_vocab(vocab_size)
    if sharded:
        x = copy_to(x, "model")
    if isinstance(lm_head, QuantizedTensor):
        out = qlinear(x, lm_head)
    else:
        out = _fixed_rows_matmul(x, lm_head)
    v_pad = padded_vocab(vocab_size) if sharded else cols
    if v_pad != vocab_size:
        first = axis_index("model") * cols if sharded else 0
        bias = torch.where(torch.arange(first, first + cols,
                                        device=out.device) < vocab_size,
                           0.0, NEG_INF)
        out = out.float() + bias
    if sharded:
        out = all_gather(out, "model", dim=-1)
    return out


def last_valid_hidden(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Gather the hidden state of each row's last valid token.

    x: (B, T, d); lens: (B,) int32 with 1 <= lens[b] <= T.  Returns
    (B, 1, d) — row b's position ``lens[b] - 1``.
    """
    idx = torch.clamp(lens.long() - 1, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


def update_cache_at(cache: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Write the span ``new`` (B, KH, T, hd) into ``cache`` (B, KH, S, hd)
    starting at per-slot positions ``pos`` (B,), in place (one indexed
    copy; the reference's functional update copies the cache).  T = 1 is
    the decode step, T > 1 a speculative verify burst; the caller keeps
    ``pos + T <= S`` (an index past S raises, where the reference's
    update clamps).  Returns ``cache``."""
    b, t = cache.shape[0], new.shape[2]
    pos = pos.long().reshape(-1).expand(b)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = pos[:, None] + torch.arange(t, device=cache.device)
    cache[rows, :, cols] = new.transpose(1, 2).to(cache.dtype)
    return cache


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of fresh K/V entries.

    x: (B, T, KH, hd) -> (codes int8 of x's shape, scale (B, T, KH, 1)
    f32); codes round half to even and clip to +-127.  The int8 KV cache
    (``cfg.kv_cache_bits = 8``) halves the cache's memory and traffic."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    codes = torch.clamp(torch.round(x32 / scale), -127, 127)
    return codes.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Paged KV cache (serve/pages.py holds the host-side allocator; this is the
# device-side write; the read side is the paged flash-decode kernel)
# ---------------------------------------------------------------------------

def update_pages_at(store: torch.Tensor, new: torch.Tensor,
                    page_ids: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Write each slot's fresh KV span into its physical pages, in place
    (one indexed copy).

    store: (P, KH, ps, d); new: (B, KH, T, d); page_ids/offsets: (B, T),
    resolved per position since a verify burst may cross a page boundary
    ((B,) for T = 1, the reference's form).  The engine makes every written
    page exclusively owned first (copy-on-write on the host), and inactive
    slots' tables point at the trash page 0, so only the trash page can
    take two writes, and nothing reads it.  Returns ``store``."""
    b, t = new.shape[0], new.shape[2]
    store[page_ids.long().reshape(b, t), :, offsets.long().reshape(b, t)] = \
        new.transpose(1, 2).to(store.dtype)
    return store


def local_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int) -> torch.Tensor:
    """Causal sliding-window self-attention in block-local form.

    q/k/v: (B, T, H|KH, hd).  The sequence is cut into blocks of size
    ``window``; block j's queries attend only to blocks (j-1, j), which
    covers every in-window key exactly once, so compute and score memory
    drop from O(T^2) to O(T * 2*window).  One block at a time, as the
    reference's scan: the scores of one block are (B, H, w, 2w).  Used by
    hymba (the attention half of its hybrid blocks); plain PyTorch on any
    device, as the reference runs it as plain jnp.
    """
    b, t, h, hd = q.shape
    kh = k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    w = window
    pad = (-t) % w
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    tp = t + pad
    nb = tp // w
    qb = q.reshape(b, nb, w, h, hd).float() * hd ** -0.5
    kb = k.reshape(b, nb, w, h, hd)
    vb = v.reshape(b, nb, w, h, hd)
    zeros = torch.zeros_like(kb[:, :1])
    k_cat = torch.cat([torch.cat([zeros, kb[:, :-1]], dim=1), kb], dim=2)
    v_cat = torch.cat([torch.cat([zeros, vb[:, :-1]], dim=1), vb], dim=2)

    dev = q.device
    i = torch.arange(w, device=dev)[:, None]
    l = torch.arange(2 * w, device=dev)[None, :]
    dist = i + w - l
    base_mask = (dist >= 0) & (dist < w)                    # (w, 2w)
    outs = []
    for j in range(nb):
        # absolute key positions for validity (padding + first block)
        kpos = j * w - w + torch.arange(2 * w, device=dev)
        mask = base_mask & ((kpos >= 0) & (kpos < t))[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qb[:, j], k_cat[:, j].float())
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v_cat[:, j].float()))
    out = torch.stack(outs, dim=1).reshape(b, tp, h, hd)[:, :t]
    return out.to(q.dtype)
