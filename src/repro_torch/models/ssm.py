"""Sequence-mixing primitives for the sub-quadratic families (the
reference's ``repro/models/ssm.py``):

* ``mamba_*`` — the selective SSM branch of hymba (a scan over time for
  train / prefill, an O(1) state step for decode);
* ``mlstm_*`` — xLSTM's matrix LSTM in chunked parallel form (exact
  recurrence, chunks of 64 steps, an O(hd^2) carried state (C, n));
* ``slstm_*`` — xLSTM's scalar LSTM with exponential gating, the
  stabilizer state m and head-wise recurrent memory mixing (a strictly
  sequential scan).

The weights FAQ quantizes are plain (n_in, n_out) matrices routed through
``qlinear``; the recurrent and gate parameters stay float (``dt_proj``,
``w_gates``, ``r``, as in the reference).  Every scan is plain PyTorch
on any device, as the reference's ``lax.scan`` bodies are plain jnp: the
Mamba scan forms its discretized terms a chunk of steps at a time (the
(B, T, d_in, S) tensor is never materialized), the sLSTM runs a Python
loop over T.

On the card, the float products of a decode step are written so that a
row's bits do not depend on how many rows come with it (a decode step of
any batch gives batch-1's bits): ``dt_proj``, ``w_gates`` and the sLSTM
recurrence multiply fixed-size zero-padded row blocks
(:func:`~repro_torch.models.common._fixed_rows`); the mLSTM read-out and
normaliser, whose operands are per-slot states, run one slot at a time
(:func:`_per_slot`); the Mamba read-out is an elementwise product summed
over S.

Tensor parallelism (serving under a mesh, :func:`mamba_axes` /
:func:`mlstm_axes` / :func:`slstm_axes`): the Mamba branch and the mLSTM
are cut on ``ff`` (d_inner's channels), the sLSTM is whole on every rank.
A rank's Mamba holds its channels of ``u`` and ``z`` (``in_proj``'s two
halves cut alike), of the conv, ``A``, the skip and the state;
``x_proj`` and ``out_proj`` are row-parallel, each followed by one
all_reduce over ``model`` (the collectives GSPMD inserts for the
reference), summed in f32 and rounded once
(:func:`~repro_torch.models.common.row_parallel_f32`): ``dt`` enters
``exp(dt * A)``, which turns a 1-ulp change of ``dt_low`` into up to 16
times that change of the decay, so the rank keeps the single-device bits
there, and ``dt_proj`` runs whole on every rank before the rank takes
its channels of ``dt``.

Training on a mesh (``make_train_step(mesh=)``) runs the same cuts under
autograd: the leaves annotated ``fsdp`` arrive gathered over ``data``
(the models' blocks gather them), a rank's channels or heads are its part
of the work, so the replicated inputs of its column products and the
whole weights it uses on its part only pass ``copy_to`` (their gradients
summed over ``model``), and ``row_parallel_f32``'s f32 sum is
differentiated through its all_reduce (the gradient reaches a bf16
weight in bf16 through the casts).

A rank's mLSTM computes its heads: q / k / v (``wq`` / ``wk`` / ``wv``
column shards over the whole ``xi``), their gates and their state; the
heads' outputs are put together exactly (one all_reduce of the
zero-padded row), and the output norm over all d_inner, the gate and
``down_proj`` run whole on every rank.  In bf16 the recurrent state
carries a rounding's error to every later step and grows it (the
reference's own decode and forward part within 32 tokens: ROADMAP
section 3), so the mLSTM keeps the single-device bits outside its heads
instead of cutting ``down_proj`` (partial sums rounded twice) or summing
the norm's squares over ranks (in another order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import all_reduce
from repro_torch.dist.sharding import axis_index
from .common import (_fixed_rows, _fixed_rows_matmul, dense_init, for_part,
                     in_width, normal_init, out_width, qlinear, rms_norm,
                     row_parallel_f32)


def mamba_axes() -> dict:
    """Logical axes of :func:`mamba_init`'s leaves: the reference's, with
    ``in_proj``'s output annotated as its two halves ``u | z`` each cut on
    ``ff`` (a contiguous cut would give one rank all of ``u``), ``d_skip``
    cut with the channels it meets (the reference replicates it and GSPMD
    slices it there), and ``dt_proj`` whole (the reference cuts its
    output; see the module docstring)."""
    return {"in_proj": (None, "fsdp", ("ff", "ff")),
            "conv_w": (None, None, "ff"), "x_proj": (None, "ff", None),
            "dt_proj": (None, None, None), "dt_bias": (None, None),
            "a_log": (None, "ff", None), "d_skip": (None, "ff"),
            "out_proj": (None, "ff", "fsdp")}


def mamba_init(gen: torch.Generator, n_layers: int, d_model: int,
               d_inner: int, d_state: int, dt_rank: int, d_conv: int, dtype,
               device) -> dict:
    """The Mamba branch of ``n_layers`` layers, leaves stacked (L, ...), in
    the reference's ``mamba_init`` layout: linears normal with std
    ``1/sqrt(n_in)``, ``conv_w`` with std 0.1, ``dt_bias`` 0, ``a_log`` =
    log(1..S) per channel, ``d_skip`` 1.  Each layer is drawn from ``gen``
    in f32 and cast."""
    def dense(n_in, n_out, scale=None):
        return dense_init(gen, n_in, n_out, dtype, device, scale=scale,
                          stack=n_layers)

    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense(d_model, 2 * d_inner),
        "conv_w": dense(d_conv, d_inner, scale=0.1),
        "x_proj": dense(d_inner, dt_rank + 2 * d_state),
        "dt_proj": dense(dt_rank, d_inner),
        "dt_bias": torch.zeros((n_layers, d_inner), dtype=dtype,
                               device=device),
        "a_log": a_log.expand(n_layers, d_inner, d_state).to(dtype).clone(),
        "d_skip": torch.ones((n_layers, d_inner), dtype=dtype, device=device),
        "out_proj": dense(d_inner, d_model),
    }


def _float_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A float (unquantized) linear, ``dt_proj`` or ``w_gates``: on the card
    in fixed-size row blocks (bits independent of the row count), on the
    CPU the reference's ``x @ w``."""
    if x.is_cuda:
        return _fixed_rows_matmul(x, w)
    return x @ w.to(x.dtype)


def _mamba_gates(p, x, conv_state=None, d_inner=None):
    """Shared front: projections + causal depthwise conv.

    x: (B, T, d_model).  Returns (u, z, dt, B_, C_, new_conv_state) where u
    is the conv+silu'd SSM input (B, T, d_in): this rank's channels when
    they are fewer than ``d_inner`` (None: the leaves' own width), whose
    ``x_proj`` partial sum is then reduced over ``model``.

    Under autograd a rank's channels are its part of the work: ``x``
    passes ``copy_to`` before ``in_proj``'s columns, and the reduced
    ``x_proj`` output, ``dt_proj`` and ``dt_bias`` (whole on every rank,
    used on the rank's channels only) pass it too, so that each gradient
    arrives summed over ``model``."""
    d_state = p["a_log"].shape[1]
    part = d_inner is not None and out_width(p["in_proj"]) < 2 * d_inner
    xz = qlinear(for_part(x, part), p["in_proj"])
    u, z = xz.chunk(2, dim=-1)
    k = p["conv_w"].shape[0]
    if conv_state is None:
        pad = F.pad(u, (0, 0, k - 1, 0))
        new_conv_state = pad[:, -(k - 1):, :] if k > 1 else None
    else:
        pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
        new_conv_state = pad[:, -(k - 1):, :]
    t = u.shape[1]
    u = sum(pad[:, i:i + t, :] * p["conv_w"][i].to(u.dtype) for i in range(k))
    u = F.silu(u)
    d_in = u.shape[-1]
    proj = for_part(row_parallel_f32(
        u, p["x_proj"], d_in if d_inner is None else d_inner), part)
    dt_rank = proj.shape[-1] - 2 * d_state
    dt_low, b_, c_ = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = (_float_linear(dt_low, for_part(p["dt_proj"], part))
          + for_part(p["dt_bias"], part).to(x.dtype))
    if d_in < dt.shape[-1]:
        first = axis_index("model") * d_in
        dt = dt[..., first:first + d_in]
    return u, z, F.softplus(dt), b_, c_, new_conv_state


# time steps whose discretized terms are formed in one go: (B, SCAN_CHUNK,
# d_in, S) f32 each, never the whole (B, T, d_in, S)
SCAN_CHUNK = 64


def _scan(p, x, u, z, dt, b_, c_, h):
    """The selective scan from state ``h`` over T, the skip and the gate.
    Returns (y (B, T, d_in) in x's dtype, final h).

    Per chunk of time steps the elementwise terms ``exp(dt * A)`` and ``dt
    * B * u`` are formed at once (each element is the same arithmetic as
    forming it in its own step), the recurrence ``h = dA * h + dBu`` runs
    step by step, and the read-out ``sum_S h * C`` once over the chunk's
    states: two launches a step instead of eight."""
    a = -torch.exp(p["a_log"].float())                       # (d_in, S)
    dt32, u32 = dt.float(), u.float()
    b32, c32 = b_.float(), c_.float()
    ys = []
    for s in range(0, u.shape[1], SCAN_CHUNK):
        e = min(s + SCAN_CHUNK, u.shape[1])
        dtc = dt32[:, s:e, :, None]                          # (B, n, d_in, 1)
        da = torch.exp(dtc * a)                              # (B, n, d_in, S)
        dbu = dtc * b32[:, s:e, None, :] * u32[:, s:e, :, None]
        hs = []
        for i in range(e - s):
            h = da[:, i] * h + dbu[:, i]
            hs.append(h)
        ys.append((torch.stack(hs, dim=1) * c32[:, s:e, None, :]).sum(-1))
    y = torch.cat(ys, dim=1) + u32 * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y, h


def _mamba_out(p, y, d_inner):
    """``out_proj`` of this rank's channels ``y``, summed over ``model``
    where they are fewer than ``d_inner`` (None: whole)."""
    return row_parallel_f32(y, p["out_proj"],
                            y.shape[-1] if d_inner is None else d_inner)


def mamba_scan(p, x, collect_cb=None, d_inner=None):
    """Full-sequence selective scan.  x: (B, T, d_model) -> (B, T, d_model).

    ``collect_cb(site, activation)`` receives the inputs of ``x_proj``
    (``"mamba_x"``, the conv+silu output) and ``out_proj``
    (``"mamba_out"``) for calibration.  ``d_inner`` is the model's whole
    width when ``p`` holds a rank's channels (see the module docstring)."""
    u, z, dt, b_, c_, _ = _mamba_gates(p, x, d_inner=d_inner)
    b, _, d_in = u.shape
    h0 = torch.zeros((b, d_in, p["a_log"].shape[1]), device=x.device)
    y, _ = _scan(p, x, u, z, dt, b_, c_, h0)
    if collect_cb is not None:
        collect_cb("mamba_x", u)
        collect_cb("mamba_out", y)
    return _mamba_out(p, y, d_inner)


def mamba_scan_final(p, x, state, d_inner=None):
    """:func:`mamba_scan` seeded with ``state`` (dict h, conv), returning
    (out, the final state) (prefill)."""
    u, z, dt, b_, c_, conv_state = _mamba_gates(
        p, x, conv_state=state["conv"], d_inner=d_inner)
    y, h = _scan(p, x, u, z, dt, b_, c_, state["h"])
    return _mamba_out(p, y, d_inner), {"h": h, "conv": conv_state}


def mamba_step(p, x, state, d_inner=None):
    """Single decode step.  x: (B, 1, d_model); state dict(h, conv).
    Returns (out (B, 1, d_model), the new state)."""
    return mamba_scan_final(p, x, state, d_inner)


def mamba_state_init(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype, device) -> dict:
    return {"h": torch.zeros((batch, d_inner, d_state), device=device),
            "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory), chunked parallel form
# ---------------------------------------------------------------------------

# time steps per chunk of the parallel form
MLSTM_CHUNK = 64
# the mLSTM output norm's epsilon (the rms_norm default, as the reference's)
NORM_EPS = 1e-6


def mlstm_axes() -> dict:
    """Logical axes of :func:`mlstm_init`'s leaves: the reference's, with
    ``up_proj`` and ``down_proj`` whole (the reference cuts their ``ff``
    dimension): only the heads (``wq`` / ``wk`` / ``wv``'s columns, the
    state) are cut; see the module docstring."""
    return {"up_proj": (None, "fsdp", None),
            "wq": (None, "fsdp", "ff"), "wk": (None, "fsdp", "ff"),
            "wv": (None, "fsdp", "ff"), "w_gates": (None, None, None),
            "gate_bias": (None, None), "out_norm": (None, None),
            "down_proj": (None, None, "fsdp")}


def mlstm_init(gen: torch.Generator, n_layers: int, d_model: int,
               d_inner: int, n_heads: int, dtype, device) -> dict:
    """The mLSTM block of ``n_layers`` layers, leaves stacked (L, ...), in
    the reference's ``mlstm_init`` layout: linears normal with std
    ``1/sqrt(n_in)`` (``w_gates`` 0.01), ``gate_bias`` 3.0 on the forget
    half and 0 on the input half, ``out_norm`` 1."""
    def dense(n_in, n_out, scale=None):
        return dense_init(gen, n_in, n_out, dtype, device, scale=scale,
                          stack=n_layers)

    bias = torch.cat([torch.full((n_heads,), 3.0), torch.zeros(n_heads)])
    return {
        "up_proj": dense(d_model, 2 * d_inner),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        "w_gates": dense(d_inner, 2 * n_heads, scale=0.01),
        "gate_bias": bias.to(dtype=dtype, device=device).expand(
            n_layers, 2 * n_heads).clone(),
        "out_norm": torch.ones((n_layers, d_inner), dtype=dtype,
                               device=device),
        "down_proj": dense(d_inner, d_model),
    }


def _mlstm_qkvg(p, x, n_heads: int):
    """Projections and gates.  x: (B, T, d_model).  Returns q, k, v (B, T,
    h, hd), logf and logi (B, T, h) f32, z (B, T, d_inner) and xi (the
    input of wq / wk / wv), where h is this rank's heads: all ``n_heads``,
    or a block of them when ``wq`` holds a rank's columns."""
    xi, z = qlinear(x, p["up_proj"]).chunk(2, dim=-1)
    d_inner = in_width(p["wq"])
    # a rank's heads are its part of the work: under autograd xi (the
    # replicated input of wq / wk / wv's columns and of the gates) and the
    # whole gate weights, used for the rank's heads only, pass copy_to
    part = out_width(p["wq"]) < d_inner
    xi_in = for_part(xi, part)
    q = qlinear(xi_in, p["wq"])
    k = qlinear(xi_in, p["wk"])
    v = qlinear(xi_in, p["wv"])
    gates = (_float_linear(xi_in, for_part(p["w_gates"], part))
             + for_part(p["gate_bias"], part).to(xi.dtype)).float()
    fgate, igate = gates.chunk(2, dim=-1)                   # (B, T, H)
    hd = d_inner // n_heads
    h = out_width(p["wq"]) // hd
    if h < n_heads:
        first = axis_index("model") * h
        fgate, igate = fgate[..., first:first + h], igate[..., first:first + h]
    logf = F.logsigmoid(fgate)
    logi = torch.clamp(igate, -10.0, 10.0)
    b, t, _ = x.shape
    shp = (b, t, h, hd)
    return (q.reshape(shp), k.reshape(shp), v.reshape(shp), logf, logi, z,
            xi)


def mlstm_chunked(p, x, n_heads: int, chunk: int = MLSTM_CHUNK,
                  collect_cb=None, state=None, return_state: bool = False):
    """Exact chunked mLSTM.  x: (B, T, d_model) -> (B, T, d_model), in
    chunks of ``chunk`` steps on every device (the reference takes
    ``min(chunk, T)``; a shorter prompt is padded to one chunk, which
    keeps the products' shapes, and so cuBLAS's choice of f32 kernels,
    the same for a rank's heads as for all of them).

    Optionally seeds from ``state`` (dict C (B, H, hd, hd), n (B, H, hd),
    f32) and returns (out, the final state) with ``return_state`` (prefill).
    The tail is padded with ``logf = 0`` and ``logi = -1e9``, so the state
    carried out of a padded prompt is exact.  ``collect_cb(site,
    activation)`` receives the input of wq / wk / wv (``"mlstm_in"``) and of
    ``down_proj`` (``"mlstm_out"``) for calibration."""
    q, k, v, logf, logi, z, xi = _mlstm_qkvg(p, x, n_heads)
    if collect_cb is not None:
        collect_cb("mlstm_in", xi)
    b, t, h, hd = q.shape
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e9)
    nc = (t + pad) // chunk
    qc = q.reshape(b, nc, chunk, h, hd).float() * hd ** -0.5
    kc = k.reshape(b, nc, chunk, h, hd).float()
    vc = v.reshape(b, nc, chunk, h, hd).float()
    lfc = logf.reshape(b, nc, chunk, h)
    lic = logi.reshape(b, nc, chunk, h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    if state is None:
        C = torch.zeros((b, h, hd, hd), device=x.device)
        n = torch.zeros((b, h, hd), device=x.device)
    else:
        C, n = state["C"], state["n"]
    hs = []
    for c in range(nc):
        qw, kw, vw, lf, li = qc[:, c], kc[:, c], vc[:, c], lfc[:, c], lic[:, c]
        clf = torch.cumsum(lf, dim=1)                       # (B, W, H)
        # intra-chunk: D[t, s] = exp(clf_t - clf_s + li_s) for s <= t; the
        # masked entries are -inf clipped to -60, exp(-60), as the reference
        dmat = clf[:, :, None, :] - clf[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(tri, dmat, -torch.inf)
        dexp = torch.exp(torch.clamp(dmat, -60.0, 30.0))    # (B, W, W, H)
        scores = torch.einsum("bthd,bshd->btsh", qw, kw) * dexp
        intra = torch.einsum("btsh,bshd->bthd", scores, vw)
        intra_n = torch.einsum("btsh,bshd->bthd", dexp, kw)
        # inter-chunk, from the carried (C, n)
        decay_t = torch.exp(clf)
        inter = torch.einsum("bthd,bhde->bthe", qw, C) * decay_t[..., None]
        inter_n = torch.einsum("bthd,bhd->bth", qw, n) * decay_t
        num = intra + inter
        den = torch.abs(torch.einsum("bthd,bthd->bth", qw, intra_n)
                        + inter_n)
        hs.append(num / torch.clamp(den, min=1.0)[..., None])
        tot = clf[:, -1]                                    # (B, H)
        rdec = torch.exp(torch.clamp(tot[:, None] - clf + li, -60.0, 30.0))
        C = C * torch.exp(tot)[..., None, None] + torch.einsum(
            "bshd,bshe,bsh->bhde", kw, vw, rdec)
        n = n * torch.exp(tot)[..., None] + torch.einsum(
            "bshd,bsh->bhd", kw, rdec)
    hs = torch.stack(hs, dim=1).reshape(b, t + pad, h * hd)[:, :t]
    y = _mlstm_out(p, hs, z, x.dtype, n_heads * hd, collect_cb)
    if return_state:
        return y, {"C": C, "n": n}
    return y


def _mlstm_out(p, hs, z, dtype, d_inner, collect_cb=None):
    """f32 ``hs`` normalised against ``out_norm`` (the rms_norm kernel on
    the card, in f32), gated by silu(z), cast, then ``down_proj``.  When
    ``hs`` holds a rank's heads (fewer than ``d_inner`` columns), the whole
    row is put together first, exactly (each rank's heads in their place,
    zeros elsewhere, one all_reduce over ``model``), so that the norm, the
    gate and ``down_proj`` run on every rank with the single-device
    bits."""
    h32 = hs.float()
    d_in = h32.shape[-1]
    if d_in < d_inner:
        first = axis_index("model") * d_in
        whole = h32.new_zeros(h32.shape[:-1] + (d_inner,))
        whole[..., first:first + d_in] = h32
        h32 = all_reduce(whole, "model")
    y = rms_norm(h32, p["out_norm"].float(), NORM_EPS)
    y = (y * F.silu(z.float())).to(dtype)
    if collect_cb is not None:
        collect_cb("mlstm_out", y)
    return qlinear(y, p["down_proj"])


def _per_slot(fn, *xs):
    """``fn(*xs)`` for a ``fn`` that maps batch rows (axis 0)
    independently: on the card one call per row, so each row has the bits
    of a batch-1 call whatever the batch; on the CPU one call."""
    if not xs[0].is_cuda or xs[0].shape[0] == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


def _readout(q, C):
    return torch.einsum("bhd,bhde->bhe", q, C)


def _normaliser(q, n):
    return torch.einsum("bhd,bhd->bh", q, n)


def mlstm_step(p, x, state, n_heads: int):
    """One decode step from the carried (C, n).  x: (B, 1, d_model).
    Returns (out (B, 1, d_model), the new state)."""
    q, k, v, logf, logi, z, _ = _mlstm_qkvg(p, x, n_heads)
    b, _, h, hd = q.shape
    qw = q[:, 0].float() * hd ** -0.5
    kw = k[:, 0].float()
    vw = v[:, 0].float()
    f = torch.exp(logf[:, 0])[..., None, None]              # (B, H, 1, 1)
    i = torch.exp(torch.clamp(logi[:, 0], -60.0, 30.0))[..., None, None]
    C = state["C"] * f + i * (kw[..., :, None] * vw[..., None, :])
    n = state["n"] * f[..., 0] + i[..., 0] * kw
    num = _per_slot(_readout, qw, C)
    den = torch.abs(_per_slot(_normaliser, qw, n))
    hout = (num / torch.clamp(den, min=1.0)[..., None]).reshape(b, 1, h * hd)
    return _mlstm_out(p, hout, z, x.dtype, n_heads * hd), {"C": C, "n": n}


def mlstm_state_init(batch: int, n_heads: int, head_dim: int,
                     device) -> dict:
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim),
                             device=device),
            "n": torch.zeros((batch, n_heads, head_dim), device=device)}


# ---------------------------------------------------------------------------
# sLSTM: exponential-gated scalar LSTM with head-wise memory mixing
# ---------------------------------------------------------------------------

# the stabilizer state m starts here (the reference's -1e9)
SLSTM_M0 = -1e9


def slstm_axes() -> dict:
    """Logical axes of :func:`slstm_init`'s leaves (the reference's): no
    cut while serving, so the sLSTM runs whole on every rank."""
    return {"w_in": (None, "fsdp", None), "r": (None, None, None, None, None),
            "bias": (None, None), "out_norm": (None, None),
            "out_proj": (None, "fsdp", None)}


def slstm_init(gen: torch.Generator, n_layers: int, d_model: int,
               n_heads: int, dtype, device) -> dict:
    """The sLSTM block of ``n_layers`` layers, leaves stacked (L, ...), in
    the reference's ``slstm_init`` layout: ``w_in`` (d, 4d) and
    ``out_proj`` normal with std ``1/sqrt(n_in)``, the recurrent ``r`` (4,
    H, hd, hd) with std ``hd^-0.5``, ``bias`` 0, ``out_norm`` 1."""
    hd = d_model // n_heads
    return {
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype, device,
                           stack=n_layers),
        "r": normal_init(gen, (4, n_heads, hd, hd), hd ** -0.5, dtype,
                         device, n_layers),
        "bias": torch.zeros((n_layers, 4 * d_model), dtype=dtype,
                            device=device),
        "out_norm": torch.ones((n_layers, d_model), dtype=dtype,
                               device=device),
        "out_proj": dense_init(gen, d_model, d_model, dtype, device,
                               stack=n_layers),
    }


def _recurrence(h, r):
    """``einsum("bhd,ghde->bghe")`` of the hidden state (B, H, hd) and the
    f32 recurrent weights: on the card in fixed-size row blocks (bits
    independent of the batch)."""
    fn = lambda rows: torch.einsum("bhd,ghde->bghe", rows, r)
    return _fixed_rows(fn, h) if h.is_cuda else fn(h)


def _slstm_cell(r, gx, state):
    """One step.  r: the f32 recurrent weights (4, H, hd, hd); gx: (B, 4,
    H, hd) f32 input pre-activations; state (h, c, n, m), each (B, H,
    hd)."""
    h, c, n, m = state
    zt, it, ft, ot = (gx + _recurrence(h, r)).unbind(1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_act = torch.exp(it - m_new)
    f_act = torch.exp(logf + m - m_new)
    c_new = f_act * c + i_act * torch.tanh(zt)
    n_new = f_act * n + i_act
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
    return (h_new, c_new, n_new, m_new)


def slstm_scan_final(p, x, n_heads: int, state, collect_cb=None):
    """The sLSTM over x (B, T, d_model) from ``state`` (a sequence h, c, n,
    m of (B, H, hd) f32), sequential over T.  Returns (out (B, T,
    d_model), the final state as a list).  ``collect_cb`` receives the
    input of ``out_proj`` (``"slstm_out"``)."""
    b, t, d = x.shape
    hd = d // n_heads
    gx = (qlinear(x, p["w_in"]) + p["bias"].to(x.dtype)).float()
    gx = gx.reshape(b, t, 4, n_heads, hd)
    r = p["r"].float()
    state = tuple(state)
    hs = []
    for i in range(t):
        state = _slstm_cell(r, gx[:, i], state)
        hs.append(state[0])
    hs = torch.stack(hs, dim=1).reshape(b, t, d)
    y = rms_norm(hs, p["out_norm"].float()).to(x.dtype)
    if collect_cb is not None:
        collect_cb("slstm_out", y)
    return qlinear(y, p["out_proj"]), list(state)


def slstm_scan(p, x, n_heads: int, collect_cb=None):
    """:func:`slstm_scan_final` from the zero state; returns the output."""
    b, _, d = x.shape
    state = slstm_state_init(b, n_heads, d // n_heads, x.device)
    return slstm_scan_final(p, x, n_heads, state, collect_cb)[0]


def slstm_step(p, x, state, n_heads: int):
    """One decode step.  x: (B, 1, d_model).  Returns (out, the new
    state as a list)."""
    return slstm_scan_final(p, x, n_heads, state)


def slstm_state_init(batch: int, n_heads: int, head_dim: int,
                     device) -> list:
    z = lambda: torch.zeros((batch, n_heads, head_dim), device=device)
    return [z(), z(), z(), torch.full((batch, n_heads, head_dim), SLSTM_M0,
                                      device=device)]
