"""W4A16 grouped dequant-GEMM: ``x @ ((nibble - zero) * scale)``.

Wrapper of ``csrc/quant_matmul.cu``, the port of
``repro/kernels/quant_matmul.py::quant_matmul_pallas``.  A CPU tensor
takes the plain version :func:`quant_matmul_ref`; a CUDA tensor launches
the kernel or raises: bf16 the tensor-core route (one launch for any m),
f32 the CUDA-core route.  ``out_dtype=torch.float32`` with bf16 x takes
the tensor-core route's f32 sums before their rounding (a row-parallel
partial product, summed over ranks and rounded once by the caller).

The bf16 kernel's choices are made here, in Python, so that the CPU tests
can hold them: :func:`plan` picks the tile and whether k is split across
blocks, :func:`chunk_rows` fixes the fold order from k and g alone, and
:func:`padded` brings shapes the kernel's 16-byte copies cannot describe
to ones they can.  ``zero`` is taken to hold integers (the quantizer
rounds it): the kernel subtracts it from the codes in bf16, exactly.

:func:`quant_matmul_experts` is the MoE form: E independent products
``x[e] @ dequant(codes[e])`` stacked on a leading axis.  bf16 runs them as
one launch of the same kernel (:data:`KERNEL_EXPERTS`, its own counter);
f32 loops the f32 launch over the experts; a CPU tensor takes the plain
version expert by expert.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ._build import INT, PLAIN_DEVICES, PTR, Kernel
from .ref import dequant_ref, quant_matmul_ref

__all__ = ["KERNEL", "KERNEL_EXPERTS", "quant_matmul",
           "quant_matmul_experts", "quant_matmul_ref", "dequant_ref", "plan",
           "chunk_rows", "padded"]

KERNEL = Kernel("quant_matmul.cu", "quant_matmul_launch",
                [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                 INT, INT, INT, INT, INT, PTR])
# every expert of a stack in one launch (bf16)
KERNEL_EXPERTS = Kernel("quant_matmul.cu", "quant_matmul_experts_launch",
                        [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                         INT, INT, INT, INT, INT, INT, PTR])

# The kernel's geometry; the first launch checks it against the library's.
BLOCK_N = (128, 128, 128, 256)  # output columns per block, config 0..3
TILE_M = (8, 16, 32, 64)        # x rows per block, config 0..3
GROUP_ALIGN = 64                # groups of whole 64-row k steps: fast path
MAX_CHUNKS = 16                 # k is folded in at most this many chunks
SPLIT_MAX_BYTES = 32 << 20      # largest f32 chunk scratch a split may use
SPLIT_BLOCKS_PER_SM = 8         # a split aims at this many blocks per SM

# per (device, stream): the split's f32 chunk scratch and its tile counters
_scratch: Dict[tuple, torch.Tensor] = {}
_counters: Dict[tuple, torch.Tensor] = {}
_sms: Dict[torch.device, int] = {}       # multiprocessors per device


class Plan(NamedTuple):
    cfg: int          # kernel config: x tile of TILE_M[cfg] rows
    chunk: int        # k rows per fold chunk
    n_chunks: int
    cpb: int          # split: chunks per block (the tile's last block folds
    #                   every chunk's sum); 0 = each block takes all of k
    tiles: int        # output tiles (m tiles x n tiles)


def chunk_rows(k: int, g: int) -> int:
    """The fold's chunk: whole groups when g % 64 == 0 (each group's sum is
    scaled, then added into its chunk), else whole 16-row k steps; at most
    MAX_CHUNKS chunks.  Depends on k and g only, never on m."""
    if g % GROUP_ALIGN == 0:
        n_groups = k // g
        return g * -(-n_groups // MAX_CHUNKS)
    steps = -(-k // 16)
    return 16 * -(-steps // MAX_CHUNKS)


def plan(m: int, k: int, n: int, g: int, sms: int, experts: int = 1) -> Plan:
    """Tile and split for ``experts`` (m, k) x (k, n) products (one launch)
    with groups of g on a card of ``sms`` multiprocessors; ``tiles`` counts
    every expert's.  The bits do not depend on either choice: every tile
    folds the same chunks in the same order."""
    cfg = 0 if m <= 8 else 1 if m <= 16 else 2 if m <= 64 else 3
    chunk = chunk_rows(k, g)
    n_chunks = -(-k // chunk)
    tiles = experts * -(-m // TILE_M[cfg]) * -(-n // BLOCK_N[cfg])
    split = (n_chunks > 1 and tiles < 2 * sms
             and experts * n_chunks * m * n * 4 <= SPLIT_MAX_BYTES)
    cpb = 0
    if split:
        cpb = max(1, round(n_chunks * tiles / (SPLIT_BLOCKS_PER_SM * sms)))
        cpb = -(-n_chunks // -(-n_chunks // cpb))   # even the blocks out
    return Plan(cfg, chunk, n_chunks, cpb, tiles)


def padded(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
           zero: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands zero-padded to n % 16 == 0 and k % 8 == 0 (what the
    kernel's 16-byte copies need), and fresh, aligned copies where a tensor
    does not start on 16 bytes.  Padded columns carry scale = zero = 0 and
    padded k rows zero codes against zero x, so the padded product, cut
    back to (m, n), equals the original.  Leading (expert) axes are kept:
    each expert is padded alike."""
    k = x.shape[-1]
    n = codes.shape[-1]
    kp, n_pad = -(-k // 8) * 8, -(-n // 16) * 16
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, codes, scale, zero))
    if kp == k and n_pad == n and aligned:
        return x, codes, scale, zero
    xp = x.new_zeros(x.shape[:-1] + (kp,))
    xp[..., :k] = x
    cp = codes.new_zeros(codes.shape[:-2] + (kp // 2, n_pad))
    cp[..., :k // 2, :n] = codes
    sp = scale.new_zeros(scale.shape[:-1] + (n_pad,))
    zp = zero.new_zeros(zero.shape[:-1] + (n_pad,))
    sp[..., :n] = scale
    zp[..., :n] = zero
    return xp, cp, sp, zp


def _check(x, codes, scale, zero):
    if x.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"x must be (m, k) and codes (k//2, n); got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    m, k = x.shape
    n = codes.shape[1]
    if codes.shape[0] * 2 != k or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 (k//2, n) for k={k}; got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    n_groups = scale.shape[0]
    if (scale.shape != (n_groups, n) or zero.shape != scale.shape
            or n_groups == 0 or k % n_groups):
        raise ValueError(f"scale/zero must be (k//g, n); got "
                         f"{tuple(scale.shape)} / {tuple(zero.shape)}")
    return m, k, n, k // n_groups


def _multiprocessors(device: torch.device) -> int:
    """The device's multiprocessor count; on the first call, also that the
    library was built with this module's geometry (the counters and the
    chunk scratch are sized from it)."""
    sms = _sms.get(device)
    if sms is None:
        geo = (ctypes.c_int * 10)()
        KERNEL.lib().quant_matmul_geometry(geo)
        ours = [v for bm_bn in zip(TILE_M, BLOCK_N) for v in bm_bn]
        if list(geo) != ours + [MAX_CHUNKS, GROUP_ALIGN]:
            raise RuntimeError(f"quant_matmul.cu's geometry {list(geo)} is "
                               f"not the wrapper's")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device] = sms
    return sms


def _cached(store: dict, key, numel: int, dtype, device) -> torch.Tensor:
    """A buffer of >= numel elements kept per (device, stream); counters are
    created zeroed and every launch leaves them zeroed."""
    buf = store.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1024), dtype=dtype, device=device)
        store[key] = buf
    return buf


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (m, k) bf16/f32; codes: (k//2, n) packed uint8; scale/zero:
    (k//g, n) f32.  Returns (m, n) in ``out_dtype`` (default x's dtype;
    f32 from bf16 x: the f32 accumulation unrounded)."""
    m, k, n, g = _check(x, codes, scale, zero)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"quant_matmul returns {x.dtype} or float32, not "
                         f"{out_dtype}")
    if x.device.type in PLAIN_DEVICES:
        return quant_matmul_ref(x, codes, scale, zero, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu, meta or cuda, not "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul takes f32 or bf16 x, not {x.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError("scale and zero must be float32")
    for t in (codes, scale, zero):
        if t.device != x.device:
            raise ValueError("x, codes, scale and zero must share a device")
    x, codes = x.contiguous(), codes.contiguous()
    scale, zero = scale.contiguous(), zero.contiguous()
    if x.dtype == torch.bfloat16:
        return _launch_tc(x, codes, scale, zero, None,
                          out_f32=out_dtype == torch.float32)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = KERNEL.lib()
    partial = None
    if m <= lib.quant_matmul_skinny_max_m():
        kc = lib.quant_matmul_kchunk()
        partial = torch.empty((-(-k // kc)) * m * n, dtype=torch.float32,
                              device=x.device)
    KERNEL.launch(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                  zero.data_ptr(), out.data_ptr(),
                  None if partial is None else partial.data_ptr(), None,
                  m, k, n, g, 0, 0, 0, 0, 0, 0,
                  torch.cuda.current_stream(x.device).cuda_stream,
                  route=f"f32 k{k} n{n}")
    return out


def scratch_sizes(p: Plan, m: int, n: int, experts: int = 1):
    """(f32 chunk-scratch elements, tile counters) a split launch of plan
    ``p`` needs for ``experts`` (m, n) outputs; (0, 0) when k is not
    split."""
    if not p.cpb:
        return 0, 0
    return experts * p.n_chunks * m * n, p.tiles


def _launch_tc(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor, experts: Optional[int],
               out_f32: bool = False) -> torch.Tensor:
    """One launch of the tensor-core kernel on contiguous CUDA operands
    (x bf16): a single product (``experts`` None, x (m, k)) or a stack of
    ``experts`` (x (E, m, k)); ``out_f32`` (a single product): the f32
    sums, unrounded."""
    n = codes.shape[-1]
    m = x.shape[-2]
    e = 1 if experts is None else experts
    dtype = torch.float32 if out_f32 else x.dtype
    if m == 0 or e == 0:
        return x.new_empty(x.shape[:-1] + (n,), dtype=dtype)
    g = x.shape[-1] // scale.shape[-2]
    xp, cp, sp, zp = padded(x, codes, scale, zero)
    kp, n_pad = xp.shape[-1], cp.shape[-1]
    p = plan(m, kp, n_pad, g, _multiprocessors(x.device), experts=e)
    out = torch.empty(x.shape[:-1] + (n_pad,), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = counters = None
    n_scratch, n_counters = scratch_sizes(p, m, n_pad, e)
    if p.cpb:
        key = (x.device, stream)
        partial = _cached(_scratch, key, n_scratch, torch.float32,
                          x.device).data_ptr()
        counters = _cached(_counters, key, n_counters, torch.int32,
                           x.device).data_ptr()
    ptrs = (xp.data_ptr(), cp.data_ptr(), sp.data_ptr(), zp.data_ptr(),
            out.data_ptr(), partial, counters)
    shape = (m, kp, n_pad, g, sp.shape[-2], p.chunk, p.cfg, p.cpb)
    route = f"k{x.shape[-1]} n{n}"
    if experts is None:
        KERNEL.launch(*ptrs, *shape, 1, 1 if out_f32 else 0, stream,
                      route=f"f32out {route}" if out_f32 else route)
    else:
        KERNEL_EXPERTS.launch(*ptrs, e, *shape, stream,
                              route=f"E{e} {route}")
    return out if n_pad == n else out[..., :n].contiguous()


def quant_matmul_experts(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor,
                         zero: torch.Tensor) -> torch.Tensor:
    """x: (E, m, k) bf16/f32 (already divided by any act_scale); codes:
    (E, k//2, n) packed uint8; scale/zero: (E, k//g, n) f32.  Returns (E,
    m, n) in x's dtype, expert e's rows the bits of
    ``quant_matmul(x[e], codes[e], scale[e], zero[e])``.  bf16 on the card:
    one launch of the tensor-core kernel for all E; f32: the f32 launch per
    expert; CPU: the plain version per expert."""
    if x.dim() != 3 or codes.dim() != 3 or scale.dim() != 3 \
            or zero.dim() != 3 or not (x.shape[0] == codes.shape[0]
                                       == scale.shape[0] == zero.shape[0]):
        raise ValueError(f"x must be (E, m, k) and codes (E, k//2, n) with "
                         f"scale / zero (E, k//g, n); got {tuple(x.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(zero.shape)}")
    n_exp = x.shape[0]
    if n_exp == 0:
        return x.new_empty(x.shape[:-1] + (codes.shape[-1],))
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        return torch.stack([quant_matmul(x[e], codes[e], scale[e], zero[e])
                            for e in range(n_exp)])
    _check(x[0], codes[0], scale[0], zero[0])
    for t in (codes, scale, zero):
        if t.device != x.device:
            raise ValueError("x, codes, scale and zero must share a device")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError("scale and zero must be float32")
    return _launch_tc(x.contiguous(), codes.contiguous(), scale.contiguous(),
                      zero.contiguous(), n_exp)
