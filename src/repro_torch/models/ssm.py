"""Sequence-mixing primitives for the sub-quadratic families: the Mamba
(selective SSM) half of the reference's ``repro/models/ssm.py``, used by
hymba's parallel branch (a scan over time for train / prefill, an O(1)
state step for decode).  xLSTM's mLSTM / sLSTM half arrives with its
family.

The weights FAQ quantizes (``in_proj``, ``x_proj``, ``out_proj``) are
plain (n_in, n_out) matrices routed through ``qlinear``; the recurrent and
gate parameters stay float (``dt_proj`` among them, as in the reference).
The scan is a loop over T in plain PyTorch (the reference's ``lax.scan``
is plain jnp too); the discretized terms are formed a chunk of steps at a
time, so the (B, T, d_in, S) tensor is never materialized.

Two products are written so that a row's bits do not depend on how many
rows come with it (a decode step of any batch gives batch-1's bits):
``dt_proj`` on the card multiplies fixed-size row blocks
(:func:`~repro_torch.models.common._fixed_rows_matmul`), and the state's
read-out ``einsum("bds,bs->bd")`` is an elementwise product summed over S.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import _fixed_rows_matmul, qlinear


def mamba_init(gen: torch.Generator, n_layers: int, d_model: int,
               d_inner: int, d_state: int, dt_rank: int, d_conv: int, dtype,
               device) -> dict:
    """The Mamba branch of ``n_layers`` layers, leaves stacked (L, ...), in
    the reference's ``mamba_init`` layout: linears normal with std
    ``1/sqrt(n_in)``, ``conv_w`` with std 0.1, ``dt_bias`` 0, ``a_log`` =
    log(1..S) per channel, ``d_skip`` 1.  Each layer is drawn from ``gen``
    in f32 and cast."""
    def normal(n_in, n_out, scale=None):
        scale = (1.0 / n_in) ** 0.5 if scale is None else scale
        out = torch.empty((n_layers, n_in, n_out), dtype=dtype, device=device)
        for view in out:
            view.copy_(torch.randn((n_in, n_out), generator=gen,
                                   device=device) * scale)
        return out

    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": normal(d_model, 2 * d_inner),
        "conv_w": normal(d_conv, d_inner, scale=0.1),
        "x_proj": normal(d_inner, dt_rank + 2 * d_state),
        "dt_proj": normal(dt_rank, d_inner),
        "dt_bias": torch.zeros((n_layers, d_inner), dtype=dtype,
                               device=device),
        "a_log": a_log.expand(n_layers, d_inner, d_state).to(dtype).clone(),
        "d_skip": torch.ones((n_layers, d_inner), dtype=dtype, device=device),
        "out_proj": normal(d_inner, d_model),
    }


def _dt_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float ``dt_proj``: on the card in fixed-size row blocks (bits
    independent of the row count), on the CPU the reference's ``x @ w``."""
    if x.is_cuda:
        return _fixed_rows_matmul(x, w)
    return x @ w.to(x.dtype)


def _mamba_gates(p, x, conv_state=None):
    """Shared front: projections + causal depthwise conv.

    x: (B, T, d_model).  Returns (u, z, dt, B_, C_, new_conv_state) where u
    is the conv+silu'd SSM input (B, T, d_in)."""
    d_state = p["a_log"].shape[1]
    xz = qlinear(x, p["in_proj"])
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
    proj = qlinear(u, p["x_proj"])
    dt_rank = proj.shape[-1] - 2 * d_state
    dt_low, b_, c_ = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(_dt_linear(dt_low, p["dt_proj"])
                    + p["dt_bias"].to(x.dtype))
    return u, z, dt, b_, c_, new_conv_state


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


def mamba_scan(p, x, collect_cb=None):
    """Full-sequence selective scan.  x: (B, T, d_model) -> (B, T, d_model).

    ``collect_cb(site, activation)`` receives the inputs of ``x_proj``
    (``"mamba_x"``, the conv+silu output) and ``out_proj``
    (``"mamba_out"``) for calibration."""
    u, z, dt, b_, c_, _ = _mamba_gates(p, x)
    b, _, d_in = u.shape
    h0 = torch.zeros((b, d_in, p["a_log"].shape[1]), device=x.device)
    y, _ = _scan(p, x, u, z, dt, b_, c_, h0)
    if collect_cb is not None:
        collect_cb("mamba_x", u)
        collect_cb("mamba_out", y)
    return qlinear(y, p["out_proj"])


def mamba_scan_final(p, x, state):
    """:func:`mamba_scan` seeded with ``state`` (dict h, conv), returning
    (out, the final state) (prefill)."""
    u, z, dt, b_, c_, conv_state = _mamba_gates(p, x,
                                                conv_state=state["conv"])
    y, h = _scan(p, x, u, z, dt, b_, c_, state["h"])
    return qlinear(y, p["out_proj"]), {"h": h, "conv": conv_state}


def mamba_step(p, x, state):
    """Single decode step.  x: (B, 1, d_model); state dict(h, conv).
    Returns (out (B, 1, d_model), the new state)."""
    return mamba_scan_final(p, x, state)


def mamba_state_init(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype, device) -> dict:
    return {"h": torch.zeros((batch, d_inner, d_state), device=device),
            "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device)}
