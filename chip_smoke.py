#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device   — the card, its power limit, torch and CUDA versions;
2. build    — ``nvcc`` builds every kernel in ``src/repro_torch/csrc``
              (one process per source, all started together);
3. kernels  — each of the seven ported kernels, the four verify (T-query)
              launches of the decode kernel and rms_norm against its plain
              PyTorch
              version on the same inputs, at the main path's shapes (bf16)
              and at odd shapes (f32; bf16 too for flash_attention: T
              37/150/200, G 1 and 4, hd 64/128 and 36, causal and not; and
              for quant_matmul: m 1/3/9/130 at hymba's widths); quant_matmul
              rows bit for bit across m = 1..2048;
              the paged decode kernels bit for bit against the dense ones
              on the same logical cache (page 0, where unused table entries
              point, is NaN); every decode variant's slot alone bit for bit
              against the same slot in a batch of 4 other lengths; then
              each kernel's time, the plain version's, one library call's
              where one computes the same function, and its bound
              (quant_matmul also at its other decode shapes, m = 64 and
              m = 2048, beside a cuBLAS yardstick on the bf16 weight;
              quant_error at all 7 projections of a llama3-8b layer, and
              its issue-rate floor from the SASS of its g = 64 loop; each
              verify variant at T 4 with each row bit for bit against the
              single-position launch at base + t + 1, timed beside those
              4 launches and, dense, one masked scaled_dot_product_attention;
              rms_norm at 4 and 16 rows of 4096 beside
              ``torch.nn.functional.rms_norm``);
4. reference — a tiny llama3-8b on the card (kernels) against the same
              model on the CPU (plain versions): logits and greedy tokens;
5. main path — llama3-8b at full width and depth (d_model 4096, 32 heads,
              8 KV heads, d_ff 14336, vocab 128256, 32 layers), random
              bf16 weights from a seed: calibrate on 16 x 512 tokens (the
              flash-attention path), FAQ alpha search, int4 pack (g = 64),
              then a 4-slot engine serves 8 greedy requests of 12..700
              prompt tokens (bucketed and chunked prefill) for 32 tokens
              each.  Request 0 is served again alone through the same
              engine and must match bit for bit (slot isolation: the
              same kernel shapes run); it is also regenerated with the
              batch-1 ``generate``, and both outputs must be greedy
              decodes of a teacher-forced exact-length forward up to
              ``TIE_TOL`` (bf16 logits of a batch-4 bucket-padded and a
              batch-1 exact-length prefill may round differently at a
              tie: the plain chunked attention of bucket-padded prefill
              picks its summation order by shape; decode rows are
              batch-invariant, checked below).  Then, on the same packed weights: the
              paged engine serves the same requests and must give the
              dense engine's tokens bit for bit; 8 requests sharing a
              256-token prefix are served twice (prefix hits, the second
              serve all hits, no page leaked); a 115-page pool (of 257)
              preempts and resumes; the int8 KV cache serves dense and
              paged with equal tokens; layer 0's alpha search runs through
              the fused quant-error kernel and must reproduce the plain
              search's losses (rel 1e-5) and choices (its 7 launches are
              then timed as one sum).  Then speculative decoding on the
              same weights: decode logits per slot at B = 1 / 2 / 4 bit for
              bit, ``verify_step`` over a 4-token burst == 4 sequential
              ``decode_step`` calls bit for bit (bf16, int8, paged); the
              FAQ int8 self-draft built from the packed weights and the
              calibration statistics; spec serving (k 3) of 4 requests
              admitted in one prefill batch, dense and paged, bf16 and
              int8 KV, equal to plain serving bit for bit; the 8 mixed
              requests greedy up to ties; an independent 2-layer
              llama3-8b-width draft with random weights, equal to plain
              serving bit for bit.  The launch counters are zeroed just
              before each of these paths and read just after it;
6. profile  — torch.profiler over one short serve: device busy time
              against wall time, device operations per engine step, and
              the top kernels.

The one reduction of the main path: prompt and calibration token ids
come from a synthetic vocabulary capped at 4096 ids (the generator's
dense (v, v) transition matrix cannot be built at 128256); the model
keeps its full 128256-entry embedding and head.

Tolerances (max abs error, kernel vs plain version on the same inputs):
bf16 ``1e-2 * max|plain|`` (outputs round to bf16; bf16 flash_attention
also rounds P to bf16 before P.V, 2^-9 relative per term, where the plain
version keeps f32); f32 ``1e-4 * max(1, max|plain|)`` — the kernels sum in
another order than the plain version's library calls; quant_error ``1e-5 *
max|plain|`` (one sum of k * n terms per candidate; each term is the plain
version's bit for bit, its divisions and rounding done without a division
instruction but equal to IEEE's, so only the order of the sum differs).
bf16 flash_attention and bf16 quant_matmul are also held to ``||got -
plain|| <= 1e-2 * ||plain||``: a causal row averages up to T values, so its outputs are far
smaller than max|plain| (row 0's, one V row), and a norm catches an error
spread over them that the max-abs limit would pass.  bf16 quant_matmul
subtracts the zero from the codes exactly and scales each group's f32 sum,
so at g % 64 == 0 (the main path's g = 64) it differs from the plain
version by summation order only and is held to ``||got - plain|| <= 5e-4
* ||plain||``: a kernel that rounded its weights to bf16, or lost a group's
scale, reads 2.4e-3 or more.  At groups not a multiple of 64 rows (g =
100) it rounds each weight to bf16 once (2^-9 relative) and is held to
the 1e-2 limit.  Its rows must not depend on m (``torch.equal`` against
the same rows of an m = 2048 call).

Output: per-phase lines, then the card's ``nvidia-smi`` name and power
limit, then one ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present or the repository's sources are missing.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # f32 outside the tensor cores
LAYERS = 32                        # llama3-8b's full depth (no cut)
PROMPT_LENS = (12, 40, 100, 200, 300, 450, 600, 700)
NEW_TOKENS = 32
# bf16 logits of magnitude < 8 are spaced 2**-5 apart; a token within four
# such steps of the reference's top logit is a numerical tie, not an error
TIE_TOL = 4 * 2.0 ** -5
# limit on ||kernel - plain|| / ||plain|| for bf16 flash_attention and
# bf16 quant_matmul with rounded weights (groups not a multiple of 64 rows)
BF16_REL_TOL = 1e-2
# the same for bf16 quant_matmul at g % 64 == 0, which differs from the
# plain version by f32 summation order only (readings up to 6.6e-5 on the
# H100); rounding every weight to bf16 reads 2.4e-3 and more
EXACT_REL_TOL = 5e-4


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """[(kernel, "registers, static shared memory, spills")] for every entry
    function in an ``nvcc -Xptxas -v`` log.  The kernel is named by its
    identifier and its mangled template arguments."""
    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", m.group(1))
            name = m.group(1)
            if k:
                rest = k.group(2)[int(k.group(1)):]
                name = k.group(2)[:int(k.group(1))] + rest[:rest.find("Ev")]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = f"spills {m.group(1)} B stored / {m.group(2)} B loaded"
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append((name, f"{m.group(1)} registers, "
                              f"{smem.group(1) if smem else 0} B static smem, "
                              f"{spills}"))
            name = None
    return out


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` calls
    ``fn(i)``, timed with CUDA events.  A device-side sleep queued first
    lets the host enqueue all ``inner`` calls before they start, so host
    launch overhead is not in the number."""
    fn(0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for i in range(inner):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return float((got.float() - ref.float()).abs().max())


def tolerance(ref) -> float:
    peak = float(ref.float().abs().max())
    return 1e-2 * peak if ref.dtype == torch.bfloat16 else 1e-4 * max(1.0, peak)


def held(name, got, ref, tol=None, rel_tol=None) -> float:
    """Max abs error of ``got`` against ``ref``, checked against ``tol``
    (default :func:`tolerance`) and, where ``rel_tol`` is given, the
    error's norm against ``rel_tol * ||ref||``."""
    torch.cuda.synchronize()
    err = max_err(got, ref)
    tol = tolerance(ref) if tol is None else tol
    line = f"  {name}: max_abs_err={err:.3e} (tol {tol:.3e})"
    rel = 0.0
    if rel_tol is not None:
        diff = (got.float() - ref.float()).norm()
        rel = float(diff / ref.float().norm())
        line += f", rel_err={rel:.3e} (tol {rel_tol:.0e})"
    print(line, flush=True)
    check(err <= tol and (rel_tol is None or rel <= rel_tol),
          f"{name}: kernel disagrees with its plain version")
    return err


def same_bits(name, got, ref):
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    print(f"  {name}: bit for bit {same}", flush=True)
    check(same, f"{name}: not bit for bit")


def q8_cache(cache):
    """(B, KH, S, hd) -> int8 codes and (B, KH, S, 1) f32 scales, by the
    model's own quantize_kv."""
    from repro_torch.models.common import quantize_kv
    codes, scale = quantize_kv(cache.transpose(1, 2))
    return (codes.transpose(1, 2).contiguous(),
            scale.transpose(1, 2).contiguous())


def paged_table(lens, s, ps, gen, dev):
    """A seeded permutation of physical pages 1..B*S/ps as (B, NP) table,
    (logical page i of slot b at perm[b, i]), with the entries past each
    slot's length pointing at page 0."""
    b, n_logical = len(lens), s // ps
    perm = (torch.randperm(b * n_logical, generator=gen, device=dev) + 1) \
        .reshape(b, n_logical).to(torch.int32)
    cl = torch.as_tensor(lens, device=dev)
    live = torch.arange(n_logical, device=dev)[None] * ps < cl[:, None]
    return perm, torch.where(live, perm, torch.zeros_like(perm))


def paged_store(cache, ps, perm):
    """The same logical cache (B, KH, S, d) as a page store (1 + B*S/ps,
    KH, ps, d) behind ``perm``; page 0 is NaN (-128 for int8 codes), so a
    stray read of an unmapped page shows."""
    b, kh, s, d = cache.shape
    pages = cache.reshape(b, kh, s // ps, ps, d).permute(0, 2, 1, 3, 4) \
        .reshape(b * (s // ps), kh, ps, d)
    store = torch.empty((1 + pages.shape[0], kh, ps, d), dtype=cache.dtype,
                        device=cache.device)
    store[0] = -128 if cache.dtype == torch.int8 else float("nan")
    store[perm.reshape(-1).long()] = pages
    return store


# ---------------------------------------------------------------------------
# Phase 3: kernels
# ---------------------------------------------------------------------------

def kernel_phase(dev):
    from repro_torch.core import QuantSpec, quantize_groupwise
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def packed(k, n, g):
        qt = quantize_groupwise(randn(k, n, dtype=torch.float32),
                                QuantSpec(bits=4, group_size=g), pack=True)
        return qt.codes, qt.scale, qt.zero

    rows = []

    # -- quant_matmul ------------------------------------------------------
    phase("kernel quant_matmul")
    bf16 = torch.bfloat16
    odd_bf16 = [(m, k, n, g, bf16) for m in (1, 3, 9, 130)
                for k, n, g in [(1600, 1600, 100), (1600, 100, 100),
                                (320, 100, 64), (128, 1600, 64)]]
    for m, k, n, g, dt in [(4, 4096, 4096, 64, bf16),
                           (4, 4096, 1024, 64, bf16),
                           (4, 4096, 14336, 64, bf16),
                           (4, 14336, 4096, 64, bf16),
                           (2048, 4096, 14336, 64, bf16),
                           *odd_bf16,
                           (1, 128, 1600, 64, torch.float32),
                           (3, 1600, 128, 100, torch.float32),
                           (130, 1600, 1600, 100, torch.float32),
                           (192, 128, 1600, 64, torch.float32),
                           (130, 320, 100, 64, torch.float32)]:
        codes, scale, zero = packed(k, n, g)
        x = randn(m, k, dtype=dt)
        held(f"m={m} k={k} n={n} g={g} {str(dt)[6:]}",
             qm.quant_matmul(x, codes, scale, zero),
             qm.quant_matmul_ref(x, codes, scale, zero),
             rel_tol=(None if dt != bf16 else EXACT_REL_TOL if g % 64 == 0
                      else BF16_REL_TOL))
    m, k, n, g = 4, 4096, 14336, 64
    sets = [packed(k, n, g) for _ in range(4)]     # > L2: each call cold
    xp = randn(2048, k)
    # a row's bits do not depend on m (decode and prefill tiles, split or not)
    full = qm.quant_matmul(xp, *sets[0])
    for mm in (1, 4, 8, 9, 16, 64, 2048):
        same_bits(f"rows of m={mm} == the same rows of m=2048",
                  qm.quant_matmul(xp[:mm].contiguous(), *sets[0]), full[:mm])

    def qmm_bytes(mm, kk, nn):
        return mm * kk * 2 + kk * nn // 2 + 2 * (kk // g) * nn * 4 + mm * nn * 2

    # timed at decode's gate/up projection: 4 slots, 4096 -> 14336
    x = randn(m, k)
    err = held("timed shape", qm.quant_matmul(x, *sets[0]),
               qm.quant_matmul_ref(x, *sets[0]), rel_tol=EXACT_REL_TOL)
    ms = time_ms(lambda i: qm.quant_matmul(x, *sets[i % 4]))
    plain = time_ms(lambda i: qm.quant_matmul_ref(x, *sets[i % 4]), reps=5)
    b_ms, b_by = bound(qmm_bytes(m, k, n), 2 * m * k * n)
    # the other decode projections, and prefill at m = 64 and 2048
    for kk, nn in [(4096, 4096), (4096, 1024), (14336, 4096)]:
        ss = [packed(kk, nn, g) for _ in range(4)]
        xx = randn(m, kk)
        t = time_ms(lambda i: qm.quant_matmul(xx, *ss[i % 4]))
        bt, bb = bound(qmm_bytes(m, kk, nn), 2 * m * kk * nn)
        print(f"  decode m=4 {kk}->{nn}: {t:.4f} ms (bound {bt:.4f} by {bb})",
              flush=True)
        del ss
    x64 = xp[:64].contiguous()
    ms_64 = time_ms(lambda i: qm.quant_matmul(x64, *sets[i % 4]))
    b64_ms, b64_by = bound(qmm_bytes(64, k, n), 2 * 64 * k * n)
    ms_p = time_ms(lambda i: qm.quant_matmul(xp, *sets[i % 4]), reps=5,
                   inner=3)
    bp_ms, bp_by = bound(qmm_bytes(2048, k, n), 2 * 2048 * k * n)
    plain_p = time_ms(lambda i: qm.quant_matmul_ref(xp, *sets[i % 4]),
                      reps=3, inner=1)
    # yardstick, not the same function: cuBLAS on the weight dequantized
    # to bf16 beforehand, which reads 3.2x the bytes of the int4 layout
    w16 = qm.dequant_ref(*sets[0], k).to(bf16)
    dense = time_ms(lambda i: x @ w16)
    dense_p = time_ms(lambda i: xp @ w16, reps=5, inner=3)
    del w16
    print(f"  decode m=4 4096->14336: {ms:.4f} ms (plain {plain:.4f}, bound "
          f"{b_ms:.4f} by {b_by}); m=64: {ms_64:.4f} ms (bound {b64_ms:.4f} "
          f"by {b64_by}); m=2048: {ms_p:.4f} ms (plain {plain_p:.4f}, bound "
          f"{bp_ms:.4f} by {bp_by})", flush=True)
    print(f"  yardstick (torch.matmul on the pre-dequantized bf16 weight, "
          f"not the same function): m=4 {dense:.4f} ms, m=2048 "
          f"{dense_p:.4f} ms", flush=True)
    rows.append(dict(name="quant_matmul", route="cuda",
                     source="src/repro_torch/csrc/quant_matmul.cu",
                     replaces="src/repro/kernels/quant_matmul.py:56",
                     shape=f"x ({m},{k}) bf16, codes ({k // 2},{n}), g={g}",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     library_note="none: no single PyTorch call takes this "
                                  "int4 layout",
                     m64_ms=ms_64, m64_bound_ms=b64_ms, prefill_ms=ms_p,
                     prefill_bound_ms=bp_ms, prefill_plain_ms=plain_p,
                     dense_bf16_ms=dense,
                     dense_bf16_prefill_ms=dense_p))
    del sets, xp, full

    # -- flash_decode ------------------------------------------------------
    phase("kernel flash_decode")
    for b, h, kh, s, hd, lens, win, dt in [
            (4, 32, 8, 1024, 128, [0, 1, 1024, 517], None, torch.bfloat16),
            (4, 32, 8, 1024, 128, [44, 140, 332, 732], None, torch.bfloat16),
            (4, 32, 8, 1024, 128, [700, 512, 256, 44], 64, torch.bfloat16),
            (3, 4, 2, 200, 32, [0, 1, 200], None, torch.float32),
            (2, 4, 2, 64, 32, [5, 64], 16, torch.float32)]:
        q = randn(b, 1, h, hd, dtype=dt)
        kc, vc = randn(b, kh, s, hd, dtype=dt), randn(b, kh, s, hd, dtype=dt)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        held(f"B={b} H={h} KH={kh} S={s} lens={lens} window={win} "
             f"{str(dt)[6:]}",
             fd.flash_decode(q, kc, vc, cl, window=win),
             fd.decode_attention_ref(q, kc, vc, cl, window=win))
    b, h, kh, s, hd = 4, 32, 8, 1024, 128
    lens = [44, 140, 332, 732]          # prompts 12/100/300/700 + 32 tokens
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn(b, 1, h, hd)
    caches = [(randn(b, kh, s, hd), randn(b, kh, s, hd)) for _ in range(8)]
    err = held("timed shape", fd.flash_decode(q, *caches[0], cl),
               fd.decode_attention_ref(q, *caches[0], cl))
    ms = time_ms(lambda i: fd.flash_decode(q, *caches[i % 8], cl))
    plain = time_ms(lambda i: fd.decode_attention_ref(q, *caches[i % 8], cl))
    keep = torch.arange(s, device=dev)[None, :] < cl[:, None]
    mask = keep[:, None, None, :]                  # (B, 1, 1, S)

    def sdpa(i):
        kc, vc = caches[i % 8]
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kc, vc, attn_mask=mask, enable_gqa=True)

    held("library call (sdpa)", sdpa(0).transpose(1, 2),
         fd.decode_attention_ref(q, *caches[0], cl))
    lib = time_ms(sdpa)
    live = sum(lens)
    b_ms, b_by = bound(2 * b * h * hd * 2 + b * 4 + live * kh * hd * 2 * 2,
                       4 * live * h * hd)
    rows.append(dict(name="flash_decode", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode.py:216",
                     shape=f"q ({b},1,{h},{hd}) bf16, cache ({b},{kh},{s},"
                           f"{hd}), lens {lens}",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))

    rows += decode_variant_rows(dev, gen, randn)

    # -- flash_attention ---------------------------------------------------
    phase("kernel flash_attention")
    odd = [(3, g, t, hd, c, torch.bfloat16) for t in (37, 150, 200)
           for g in (1, 4) for hd in (64, 128) for c in (True, False)]
    for bkh, g, t, hd, causal, dt in [
            (64, 4, 512, 128, True, torch.bfloat16),
            *odd,
            (3, 4, 150, 36, True, torch.bfloat16),     # rows padded to 40
            (4, 2, 128, 32, True, torch.float32),
            (4, 2, 200, 32, True, torch.float32),
            (3, 1, 37, 64, True, torch.float32),
            (3, 1, 150, 64, True, torch.float32),
            (3, 1, 150, 64, False, torch.float32)]:
        q = randn(bkh, g, t, hd, dtype=dt)
        k_, v_ = randn(bkh, t, hd, dtype=dt), randn(bkh, t, hd, dtype=dt)
        held(f"BKH={bkh} G={g} T={t} hd={hd} causal={causal} {str(dt)[6:]}",
             fa.flash_attention(q, k_, v_, causal=causal),
             fa.flash_attention_ref(q, k_, v_, causal=causal),
             rel_tol=BF16_REL_TOL if dt == torch.bfloat16 else None)
    bkh, g, t, hd = 64, 4, 512, 128     # calibration batch: 8 x 8 KV heads
    sets = [(randn(bkh, g, t, hd), randn(bkh, t, hd), randn(bkh, t, hd))
            for _ in range(2)]
    err = held("timed shape", fa.flash_attention(*sets[0]),
               fa.flash_attention_ref(*sets[0]), rel_tol=BF16_REL_TOL)
    ms = time_ms(lambda i: fa.flash_attention(*sets[i % 2]))
    plain = time_ms(lambda i: fa.flash_attention_ref(*sets[i % 2]), reps=5)

    def sdpa_causal(i):
        q_, k_, v_ = sets[i % 2]
        return torch.nn.functional.scaled_dot_product_attention(
            q_.reshape(8, 8 * g, t, hd), k_.reshape(8, 8, t, hd),
            v_.reshape(8, 8, t, hd), is_causal=True, enable_gqa=True)

    held("library call (sdpa)", sdpa_causal(0).reshape(bkh, g, t, hd),
         fa.flash_attention_ref(*sets[0]))
    lib = time_ms(sdpa_causal)
    b_ms, b_by = bound((2 * bkh * g * t * hd + 2 * bkh * t * hd) * 2,
                       4 * bkh * g * hd * t * (t + 1) / 2)
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:92",
                     shape=f"q ({bkh},{g},{t},{hd}) bf16, k/v ({bkh},{t},"
                           f"{hd}), causal",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    rows.append(quant_error_row(dev, gen, randn))
    rows += verify_rows(dev, gen, randn)
    rows.append(rms_norm_row(dev, gen, randn))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}", flush=True)
    return rows


def decode_variant_rows(dev, gen, randn):
    """flash_decode_q8, flash_decode_paged and flash_decode_paged_q8: each
    against its plain version (bf16 at the main path's shapes, f32 at odd
    ones), the paged kernels bit for bit against the dense kernels on the
    same logical cache, then timed at the main path's decode shape."""
    from repro_torch.kernels import flash_decode as fd

    phase("kernel flash_decode_q8 / flash_decode_paged / "
          "flash_decode_paged_q8")
    for b, h, kh, s, hd, lens, win, ps, dt in [
            (4, 32, 8, 1024, 128, [44, 140, 332, 732], None, 16,
             torch.bfloat16),
            (4, 32, 8, 1024, 128, [0, 1, 1024, 517], 48, 16, torch.bfloat16),
            (3, 4, 4, 200, 32, [0, 1, 197], None, 8, torch.float32),
            (3, 8, 2, 200, 32, [0, 13, 200], 48, 8, torch.float32),
            (2, 8, 2, 64, 64, [5, 64], 48, 8, torch.float32)]:
        q = randn(b, 1, h, hd, dtype=dt)
        k, v = randn(b, kh, s, hd, dtype=dt), randn(b, kh, s, hd, dtype=dt)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        (kc, ks), (vc, vs) = q8_cache(k), q8_cache(v)
        perm, table = paged_table(lens, s, ps, gen, dev)
        st = [paged_store(x, ps, perm) for x in (k, v)]
        st8 = [paged_store(x, ps, perm) for x in (kc, ks, vc, vs)]
        tag = (f"B={b} H={h} KH={kh} S={s} lens={lens} window={win} ps={ps} "
               f"{str(dt)[6:]}")
        dense = fd.flash_decode(q, k, v, cl, window=win)
        dense8 = fd.flash_decode_q8(q, kc, ks, vc, vs, cl, window=win)
        paged = fd.flash_decode_paged(q, *st, table, cl, window=win)
        paged8 = fd.flash_decode_paged_q8(q, *st8, table, cl, window=win)
        held(f"q8 {tag}", dense8, fd.decode_attention_q8_ref(
            q, kc, ks, vc, vs, cl, window=win))
        held(f"paged {tag}", paged, fd.paged_decode_attention_ref(
            q, *st, table, cl, window=win))
        held(f"paged q8 {tag}", paged8, fd.paged_decode_attention_q8_ref(
            q, *st8, table, cl, window=win))
        same_bits(f"paged == dense {tag}", paged, dense)
        same_bits(f"paged q8 == dense q8 {tag}", paged8, dense8)
        if dt == torch.bfloat16:
            # a slot's bits do not depend on the rest of the batch
            for name, got, fn, args in [
                    ("dense", dense, fd.flash_decode, (k, v)),
                    ("q8", dense8, fd.flash_decode_q8, (kc, ks, vc, vs)),
                    ("paged", paged, fd.flash_decode_paged, (*st, table)),
                    ("paged q8", paged8, fd.flash_decode_paged_q8,
                     (*st8, table))]:
                paged_args = name.startswith("paged")
                alone = torch.cat([fn(q[i:i + 1], *(
                    [*args[:-1], args[-1][i:i + 1]] if paged_args else
                    [a[i:i + 1] for a in args]), cl[i:i + 1], window=win)
                    for i in range(b)])
                same_bits(f"{name} slot alone == in the batch {tag}", alone,
                          got)

    b, h, kh, s, hd, ps = 4, 32, 8, 1024, 128, 16
    lens = [44, 140, 332, 732]          # prompts 12/100/300/700 + 32 tokens
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = randn(b, 1, h, hd)
    sets = []                            # 8 sets: > L2, so each call is cold
    for _ in range(8):
        k, v = randn(b, kh, s, hd), randn(b, kh, s, hd)
        perm, table = paged_table(lens, s, ps, gen, dev)
        q8 = (*q8_cache(k), *q8_cache(v))
        sets.append(dict(
            q8=q8, paged=(paged_store(k, ps, perm), paged_store(v, ps, perm),
                          table),
            paged_q8=(*(paged_store(x, ps, perm) for x in q8), table)))
    live = sum(lens)
    qo_bytes = 2 * b * h * hd * 2 + b * 4
    table_bytes = b * (s // ps) * 4
    bf16_rows = live * kh * hd * 2 * 2
    q8_rows = live * kh * (hd + 4) * 2
    flops = 4 * live * h * hd
    variants = [
        ("flash_decode_q8", fd.flash_decode_q8, fd.decode_attention_q8_ref,
         "q8", qo_bytes + q8_rows, "src/repro/kernels/flash_decode.py:250",
         "codes (4,8,1024,128) int8 + f32 scales"),
        ("flash_decode_paged", fd.flash_decode_paged,
         fd.paged_decode_attention_ref, "paged",
         qo_bytes + bf16_rows + table_bytes,
         "src/repro/kernels/flash_decode.py:286",
         "stores (257,8,16,128) bf16, table (4,64)"),
        ("flash_decode_paged_q8", fd.flash_decode_paged_q8,
         fd.paged_decode_attention_q8_ref, "paged_q8",
         qo_bytes + q8_rows + table_bytes,
         "src/repro/kernels/flash_decode.py:323",
         "code stores (257,8,16,128) int8 + f32 scale stores, table (4,64)"),
    ]
    rows = []
    for name, kern, plain_fn, key, bytes_moved, replaces, shape in variants:
        args0 = sets[0][key]
        err = held(f"{name} timed shape", kern(q, *args0, cl),
                   plain_fn(q, *args0, cl))
        ms = time_ms(lambda i: kern(q, *sets[i % 8][key], cl))
        plain = time_ms(lambda i: plain_fn(q, *sets[i % 8][key], cl))
        b_ms, b_by = bound(bytes_moved, flops)
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
            replaces=replaces,
            shape=f"q ({b},1,{h},{hd}) bf16, {shape}, lens {lens}",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            library_note="none: no single PyTorch call reads int8 codes with "
                         "folded scales or a paged store"))
    return rows


def verify_rows(dev, gen, randn):
    """The T-query verify launch of each decode variant at the main path's
    decode shape with T = 4 (k = 3): against its plain version, each row t
    bit for bit against the single-position kernel at base + t + 1, then
    timed beside the 4 single-position launches it replaces and, for the
    dense bf16 cache, one masked scaled_dot_product_attention call."""
    from repro_torch.kernels import flash_decode as fd

    phase("kernel flash_verify (T-query launch of the decode kernel), all "
          "four variants")
    b, t, h, kh, s, hd, ps = 4, 4, 32, 8, 1024, 128, 16
    bases = [44, 140, 332, 732]     # bursts cross no, a page, a split, a page
    base = torch.tensor(bases, dtype=torch.int32, device=dev)
    q = randn(b, t, h, hd)
    sets = []                        # 8 sets: > L2, so each call is cold
    for _ in range(8):
        k, v = randn(b, kh, s, hd), randn(b, kh, s, hd)
        perm, _ = paged_table([s] * b, s, ps, gen, dev)
        q8 = (*q8_cache(k), *q8_cache(v))
        sets.append(dict(
            dense=(k, v), q8=q8,
            paged=(paged_store(k, ps, perm), paged_store(v, ps, perm), perm),
            paged_q8=(*(paged_store(x, ps, perm) for x in q8), perm)))
    live = sum(x + t for x in bases)
    qo_bytes = 2 * b * t * h * hd * 2 + b * 4
    table_bytes = b * (s // ps) * 4
    flops = 4 * h * hd * sum(x + i + 1 for x in bases for i in range(t))
    variants = [
        ("flash_verify", fd.flash_verify, fd.flash_decode,
         fd.verify_attention_ref, "dense", live * kh * hd * 2 * 2,
         "src/repro/kernels/flash_decode.py:216", "cache (4,8,1024,128) bf16"),
        ("flash_verify_q8", fd.flash_verify_q8, fd.flash_decode_q8,
         fd.verify_attention_q8_ref, "q8", live * kh * (hd + 4) * 2,
         "src/repro/kernels/flash_decode.py:250",
         "codes (4,8,1024,128) int8 + f32 scales"),
        ("flash_verify_paged", fd.flash_verify_paged, fd.flash_decode_paged,
         fd.paged_verify_attention_ref, "paged",
         live * kh * hd * 2 * 2 + table_bytes,
         "src/repro/kernels/flash_decode.py:286",
         "stores (257,8,16,128) bf16, table (4,64)"),
        ("flash_verify_paged_q8", fd.flash_verify_paged_q8,
         fd.flash_decode_paged_q8, fd.paged_verify_attention_q8_ref,
         "paged_q8", live * kh * (hd + 4) * 2 + table_bytes,
         "src/repro/kernels/flash_decode.py:323",
         "code stores (257,8,16,128) int8 + f32 scale stores, table (4,64)"),
    ]
    qs = [q[:, i:i + 1].contiguous() for i in range(t)]
    lens = [base + i + 1 for i in range(t)]    # made once, outside the timing
    rows = []
    for name, kern, single, plain_fn, key, kv_bytes, replaces, shape in \
            variants:
        args0 = sets[0][key]
        got = kern(q, *args0, base)
        err = held(f"{name} B={b} T={t} bases={bases}", got,
                   plain_fn(q, *args0, base))
        for i in range(t):
            same_bits(f"{name} row {i} == single-position launch at "
                      f"base + {i + 1}", got[:, i:i + 1],
                      single(qs[i], *args0, lens[i]))
        ms = time_ms(lambda j: kern(q, *sets[j % 8][key], base))
        ms_t1 = time_ms(lambda j: [single(qs[i], *sets[j % 8][key], lens[i])
                                   for i in range(t)])
        plain = time_ms(lambda j: plain_fn(q, *sets[j % 8][key], base),
                        reps=5)
        b_ms, b_by = bound(qo_bytes + kv_bytes, flops)
        lib = None
        if key == "dense":
            kpos = torch.arange(s, device=dev)
            seen = base[:, None] + 1 + torch.arange(t, device=dev)
            mask = (kpos[None, None, :] < seen[..., None])[:, None]

            def sdpa(j):
                kc, vc = sets[j % 8]["dense"]
                return torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), kc, vc, attn_mask=mask,
                    enable_gqa=True)

            held("library call (sdpa, (B,1,T,S) mask)",
                 sdpa(0).transpose(1, 2), plain_fn(q, *args0, base))
            lib = time_ms(sdpa)
        print(f"  {name}: {ms:.4f} ms for the burst, {ms_t1:.4f} ms for "
              f"{t} single-position launches", flush=True)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_decode.cu", replaces=replaces,
            shape=f"q ({b},{t},{h},{hd}) bf16, {shape}, bases {bases}",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib, t1x4_ms=ms_t1,
            library_note=None if lib is not None else
            "none: no single PyTorch call reads int8 codes with folded "
            "scales or a paged store"))
    return rows


def rms_norm_row(dev, gen, randn):
    """rms_norm at the decode step's (4, 4096) and a verify pass's
    (16, 4096) rows, bf16: against its plain version, rows bit for bit
    whatever rows come with them, then timed beside the plain version and
    ``torch.nn.functional.rms_norm``."""
    from repro_torch.kernels import rms_norm as rn

    phase("kernel rms_norm")
    d, eps = 4096, 1e-5
    w = randn(d)
    out = {}
    for rows_n in (4, 16):
        xs = [randn(rows_n, d) * 3 for _ in range(8)]
        err = held(f"rows={rows_n} d={d} bf16", rn.rms_norm(xs[0], w, eps),
                   rn.rms_norm_ref(xs[0], w, eps))
        full = rn.rms_norm(xs[0], w, eps)
        same_bits(f"rows={rows_n}: each row alone == in the batch",
                  torch.cat([rn.rms_norm(xs[0][i:i + 1], w, eps)
                             for i in range(rows_n)]), full)
        lib_fn = getattr(torch.nn.functional, "rms_norm", None)
        out[rows_n] = dict(
            err=err, ms=time_ms(lambda i: rn.rms_norm(xs[i % 8], w, eps)),
            plain=time_ms(lambda i: rn.rms_norm_ref(xs[i % 8], w, eps)),
            lib=None if lib_fn is None else time_ms(
                lambda i: lib_fn(xs[i % 8], (d,), w, eps)),
            bound=bound(2 * rows_n * d * 2 + d * 2, 4 * rows_n * d,
                        F32_FLOPS_PER_S))
        print(f"  rows={rows_n}: {out[rows_n]['ms']:.4f} ms (plain "
              f"{out[rows_n]['plain']:.4f}, F.rms_norm {out[rows_n]['lib']}, "
              f"bound {out[rows_n]['bound'][0]:.6f} by "
              f"{out[rows_n]['bound'][1]})", flush=True)
    r4, r16 = out[4], out[16]
    return dict(name="rms_norm", route="cuda",
                source="src/repro_torch/csrc/rms_norm.cu",
                replaces="none: a kernel of the port only (repro's rms_norm "
                         "is plain jnp, src/repro/models/common.py:54)",
                shape=f"x (4,{d}) bf16, w ({d},)", max_abs_err=r4["err"],
                ms=r4["ms"], plain_ms=r4["plain"], bound_ms=r4["bound"][0],
                bound_by=r4["bound"][1], library_ms=r4["lib"],
                rows16_ms=r16["ms"], rows16_plain_ms=r16["plain"],
                rows16_library_ms=r16["lib"], rows16_bound_ms=r16["bound"][0])


# the projections of one llama3-8b layer, (k, n); w_gate is the timed row
LLAMA_PROJ = {"w_gate": (4096, 14336), "wq": (4096, 4096), "wk": (4096, 1024),
              "wv": (4096, 1024), "wo": (4096, 4096), "w_up": (4096, 14336),
              "w_down": (14336, 4096)}


def quant_error_bound(k, n, a):
    """quant_error's bound: bf16 w, (a, k) scales and (k,) mean_sq read once,
    (a,) written; 16 f32 operations per element and candidate (the plain
    version's arithmetic) at the f32 peak outside the tensor cores."""
    return bound(k * n * 2 + a * k * 4 + k * 4 + a * 4, 16 * k * n * a,
                 F32_FLOPS_PER_S)


def sass_loop(lib, kernel_key):
    """(instructions, opcode counts) in the longest loop of the kernel whose
    mangled name matches the regular expression ``kernel_key`` (the
    candidate loop: its g elements unrolled and the candidate's own work),
    read from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    from collections import Counter
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        if not re.search(kernel_key, func.split("\n", 1)[0]):
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;", func)]

        def opcode(text):
            return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]

        best = []
        for addr, text in code:
            m = re.search(r"BRA 0x([0-9a-f]+)", text)
            target = int(m.group(1), 16) if m else addr
            if target < addr:               # a loop: its body's instructions
                body = [t for a_, t in code if target <= a_ <= addr]
                best = max(best, body, key=len)
        ops = Counter(opcode(t).split(".")[0] for t in best)
        ops.pop("NOP", None)
        return sum(ops.values()), ops
    return None


def quant_error_row(dev, gen, randn):
    """quant_error against its plain version (odd shapes in f32, the
    projections of one llama3-8b layer in bf16), then timed at each
    projection; the SASS of its g = 64 instantiation gives its issue-rate
    floor."""
    from repro_torch.core import QuantSpec
    from repro_torch.core.methods import DEFAULT_ALPHA_GRID, candidate_scale
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_error as qe

    phase("kernel quant_error")

    def rel_held(name, got, ref):
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 * float(ref.abs().max())
        print(f"  {name}: max_abs_err={err:.3e} (tol {tol:.3e}, 1e-5 of the "
              f"largest loss)", flush=True)
        check(err <= tol, f"{name}: kernel disagrees with its plain version")
        return err

    for k, n, g, sym, dt in [(300, 100, 100, True, torch.float32),
                             (256, 130, 64, False, torch.float32),
                             (320, 33, 64, True, torch.float32),
                             (128, 1600, 128, False, torch.float32)]:
        w = randn(k, n, dtype=dt)
        scales = torch.rand(5, k, generator=gen, device=dev) + 0.5
        msq = torch.rand(k, generator=gen, device=dev)
        spec = QuantSpec(4, g, symmetric=sym)
        rel_held(f"k={k} n={n} g={g} sym={sym} {str(dt)[6:]}",
                 qe.quant_error(w, scales, msq, spec),
                 qe.quant_error_ref(w, scales, msq, spec))
    # 21 alpha candidates + the ones, g = 64, per projection of one layer
    g = 64
    spec = QuantSpec(4, g)
    row = {}
    for proj, (k, n) in LLAMA_PROJ.items():
        ws = [randn(k, n) * 0.02 for _ in range(2)]
        a_stat = torch.rand(k, generator=gen, device=dev) + 0.1
        scales = torch.stack([candidate_scale(a_stat, a) for a in
                              DEFAULT_ALPHA_GRID] +
                             [torch.ones(k, device=dev)])
        msq = torch.rand(k, generator=gen, device=dev)
        a = scales.shape[0]
        err = rel_held(f"{proj} ({k}->{n}) bf16, {a} candidates",
                       qe.quant_error(ws[0], scales, msq, spec),
                       qe.quant_error_ref(ws[0], scales, msq, spec))
        ms = time_ms(lambda i: qe.quant_error(ws[i % 2], scales, msq, spec),
                     reps=5, inner=2)
        b_ms, b_by = quant_error_bound(k, n, a)
        print(f"  {proj} {k}->{n}: {ms:.4f} ms (bound {b_ms:.4f} by {b_by})",
              flush=True)
        if proj != "w_gate":
            row.update({f"{proj}_ms": ms, f"{proj}_bound_ms": b_ms})
            continue
        plain = time_ms(lambda i: qe.quant_error_ref(ws[i % 2], scales, msq,
                                                     spec), reps=3, inner=1)
        row.update(name="quant_error", route="cuda",
                   source="src/repro_torch/csrc/quant_error.cu",
                   replaces="src/repro/kernels/quant_error.py:66",
                   shape=f"w ({k},{n}) bf16, {a} candidate scales, g={g} "
                         f"asym", max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library_note="none: no single PyTorch call quantizes "
                                "group-wise and sums the weighted error")
        gate = (k, n, a)
        del ws
    # issue-rate floor: SASS instructions per element and candidate in the
    # g = 64 bf16 candidate loop, over 4 warp instructions per clock per SM
    counted_sass = sass_loop(_build.library_path("quant_error.cu"),
                             r"qe_rowsILi64E.*13__nv_bfloat16")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split("\n")[0].split(",")
    mhz_max, mhz_now = (float(c) for c in clocks)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if counted_sass is None:
        print("  SASS: no cuobjdump in this toolkit; floor not measured",
              flush=True)
        row.update(sass_per_element=None, issue_floor_ms=None)
    else:
        total, ops = counted_sass
        per = total / g
        k, n, a = gate
        floor = per * k * n * a / (sms * 128 * mhz_max * 1e6) * 1e3
        print(f"  SASS qe_rows<64, bf16>: candidate loop {total} "
              f"instructions = {per:.2f} per element and candidate "
              f"({', '.join(f'{o} {c}' for o, c in ops.most_common(10))}); "
              f"issue-rate floor at w_gate {floor:.4f} ms ({sms} SMs x 128 "
              f"lanes x {mhz_max:.0f} MHz max SM clock; {mhz_now:.0f} MHz "
              f"now)", flush=True)
        row.update(sass_per_element=per, issue_floor_ms=floor,
                   sm_clock_max_mhz=mhz_max)
    return row


# ---------------------------------------------------------------------------
# Phase 4: tiny model, card against CPU
# ---------------------------------------------------------------------------

def reference_phase(dev):
    from repro_torch.bridge import tree_to
    from repro_torch.configs import ARCHS
    from repro_torch.core import QuantSpec, quantize_model, run_calibration
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ARCHS["llama3-8b"].tiny()
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = {cpu: model.init(0, device=cpu)}
    params[dev] = tree_to(params[cpu], dev)
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 128))
              .astype(np.int32)}]
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 40)]
    logits, alphas = {}, {}
    for device in (dev, cpu):
        logits[device] = model.forward(
            params[device],
            {"tokens": torch.as_tensor(calib[0]["tokens"], device=device)}
        )[0].float().cpu()
        stats = run_calibration(model.forward, params[device], calib)
        qp, report = quantize_model(params[device], model.quant_site_map(),
                                    stats, method="faq",
                                    spec=QuantSpec(bits=4, group_size=64),
                                    mode="packed")
        alphas[device] = {p: r["alpha"].cpu() for p, r in report.items()}
    err = float((logits[dev] - logits[cpu]).abs().max())
    print(f"  tiny forward (flash-attention path): card vs cpu logits "
          f"max_abs_err={err:.3e}", flush=True)
    check(err <= 1e-4 * max(1.0, float(logits[cpu].abs().max())),
          "tiny forward on the card disagrees with the CPU")
    same_alpha = all(torch.equal(alphas[dev][p], alphas[cpu][p])
                     for p in alphas[cpu])
    print(f"  FAQ alpha per site identical card vs cpu: {same_alpha}",
          flush=True)
    # serve the CPU-quantized weights on both devices: same codes in, the
    # same greedy tokens out
    served = {}
    for device in (dev, cpu):
        eng = ServeEngine(model, tree_to(qp, device), n_slots=2, max_len=64,
                          device=device)
        served[device] = eng.serve([Request(rid=i, prompt=p,
                                            max_new_tokens=6)
                                    for i, p in enumerate(prompts)])
    same = all(np.array_equal(served[dev][i], served[cpu][i])
               for i in served[cpu])
    print(f"  greedy serve tokens identical card vs cpu: {same}", flush=True)
    check(same, "tiny serve on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------

def main_path_phase(dev, kernels):
    from repro_torch.configs import ARCHS
    from repro_torch.core import (QuantSpec, quantize_model, report_summary,
                                  run_calibration)
    from repro_torch.core.methods import site_stat_for_method
    from repro_torch.data.synthetic import calibration_batches
    from repro_torch.launch.serve import data_for
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    full = ARCHS["llama3-8b"]
    cfg = full.scaled(n_layers=min(full.n_layers, LAYERS))
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}; depth "
          f"{cfg.n_layers} of {full.n_layers} layers", flush=True)
    model = build_model(cfg)
    data = data_for(cfg)
    print(f"  reduction: synthetic token ids capped at "
          f"{data.cfg.vocab_size} of {cfg.vocab_size} (model vocabulary "
          f"kept)", flush=True)
    times = {}
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0

    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    times["init"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    calib = calibration_batches(data, 16, 512, batch_size=8)
    stats = run_calibration(model.forward, params, calib)
    torch.cuda.synchronize()
    times["calibrate"] = time.perf_counter() - t0
    for site, st in stats.items():
        for key, v in st.items():
            check(bool(torch.isfinite(v).all()), f"stat {site}/{key} not finite")

    t0 = time.perf_counter()
    qparams, report = quantize_model(params, model.quant_site_map(), stats,
                                     method="faq",
                                     spec=QuantSpec(bits=4, group_size=64),
                                     mode="packed")
    summary = report_summary(report)
    times["faq_pack"] = time.perf_counter() - t0
    # layer 0's weights and its diagonal-loss statistics, kept for the alpha
    # search through the fused quant-error kernel after serving
    layer0 = {"spec": QuantSpec(bits=4, group_size=64), "sites": {
        "/".join(path): (params["blocks"][path[1]][0].clone(),
                         site_stat_for_method("faq", stats[site]["mean_abs"])
                         [0].clone(),
                         stats[site]["mean_sq"][0].clone())
        for path, site in model.quant_site_map().items()}}
    for path, rep in report.items():
        # alpha = 0 (no smoothing) is in the grid, so FAQ never loses to RTN
        check(bool((rep["loss"] <= rep["rtn_loss"] * (1 + 1e-5)).all()),
              f"{path}: searched loss above the RTN loss")
    for path, s in summary.items():
        print(f"  {path}: mean alpha {s['mean_alpha']:.3f}, loss "
              f"{s['mean_loss']:.4e} vs RTN {s['mean_rtn_loss']:.4e} "
              f"({100 * s['improvement_vs_rtn']:.1f}% better)", flush=True)
    del params
    torch.cuda.empty_cache()

    eng = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev)
    reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, n),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    times["serve"] = time.perf_counter() - t0
    m = eng.metrics()
    check(sorted(results) == list(range(len(reqs))), "missing results")
    for rid, toks in results.items():
        check(len(toks) == NEW_TOKENS, f"req {rid}: {len(toks)} tokens")
        check(bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"req {rid}: token outside the vocabulary")
    check(m["chunked_admissions"] > 0, "no chunked admission happened")
    # slot isolation: request 0 served alone through the same 4-slot
    # engine runs the same kernel shapes, so its tokens must match the
    # mixed run bit for bit whatever the other slots held
    solo = eng.serve([Request(rid=0, prompt=reqs[0].prompt,
                              max_new_tokens=NEW_TOKENS)])[0]
    check(np.array_equal(solo, results[0]),
          f"request 0: mixed batch {results[0].tolist()} != alone "
          f"{solo.tolist()}")
    t0 = time.perf_counter()
    alone = eng.generate(Request(rid=100, prompt=reqs[0].prompt,
                                 max_new_tokens=NEW_TOKENS))
    times["generate"] = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    first_diff = next((j for j in range(NEW_TOKENS)
                       if alone[j] != results[0][j]), None)
    print(f"  request 0 engine:   {results[0].tolist()}\n"
          f"  request 0 generate: {alone.tolist()}\n"
          f"  first difference at token {first_diff}", flush=True)
    # both must be greedy decodes of a teacher-forced exact-length
    # forward: each chosen token within TIE_TOL of that position's top
    for name, toks in (("engine", results[0]), ("generate", alone)):
        margin, gap = teacher_forced(model, qparams, reqs[0].prompt, toks,
                                     dev)
        print(f"  {name}: max margin to the reference top logit "
              f"{margin.max():.4f} (token {int(margin.argmax())}); top-2 gap "
              f"there {gap[int(margin.argmax())]:.4f}; reference argmax "
              f"agrees at {int((margin == 0).sum())}/{NEW_TOKENS}",
              flush=True)
        check(float(margin.max()) <= TIE_TOL,
              f"request 0 ({name}): token off the reference argmax by "
              f"{margin.max():.4f} > {TIE_TOL}")
    print(f"  serve: {m['tokens_generated']} tokens in {times['serve']:.2f} "
          f"s = {m['tokens_generated'] / times['serve']:.1f} tok/s, "
          f"{m['decode_steps']} decode steps, {m['prefill_batches']} prefill "
          f"batches, {m['chunked_admissions']} chunked admissions, "
          f"{m['fill_steps']} fill steps", flush=True)
    print(f"  generate (1 slot): {NEW_TOKENS} tokens in "
          f"{times['generate']:.2f} s = "
          f"{NEW_TOKENS / times['generate']:.1f} tok/s", flush=True)
    print(f"  phase seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in times.items()))
    print(f"  max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    counts_by_path, qe_keys = slice2_paths(dev, kernels, cfg, model, qparams,
                                           data, reqs, results, layer0)
    counts_by_path.update(spec_paths(dev, kernels, cfg, model, qparams,
                                     stats, data, reqs, results,
                                     times["serve"]))
    for path, counts in counts_by_path.items():
        print(f"  launches on the {path} path: {counts}", flush=True)
        for sym, n in counts.items():
            launches[sym] += n
    print(f"  max_memory_allocated over all paths: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_phase(eng, data, Request)
    return launches, {"quant_error": qe_keys}


def teacher_forced(model, qparams, prompt, toks, dev):
    """Per generated token: how far its logit lies below the top logit of
    a teacher-forced exact-length forward over prompt + tokens (0 where it
    is the argmax), and that position's top-2 gap."""
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)
    logits = model.forward(qparams, {"tokens": torch.as_tensor(
        seq, device=dev)[None]})[0][0, len(prompt) - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    chosen = logits.gather(1, torch.as_tensor(
        toks, device=dev, dtype=torch.long)[:, None])[:, 0]
    return ((top2[:, 0] - chosen).cpu().numpy(),
            (top2[:, 0] - top2[:, 1]).cpu().numpy())


def check_teacher_forced(name, model, qparams, reqs, results, dev):
    """Every request's tokens are greedy up to TIE_TOL."""
    worst = 0.0
    for r in reqs:
        margin, _ = teacher_forced(model, qparams, r.prompt, results[r.rid],
                                   dev)
        worst = max(worst, float(margin.max()))
        check(float(margin.max()) <= TIE_TOL,
              f"{name} request {r.rid}: token off the reference argmax by "
              f"{margin.max():.4f} > {TIE_TOL}")
    print(f"  {name}: every request greedy up to ties (worst margin "
          f"{worst:.4f} <= {TIE_TOL})", flush=True)


def counted(kernels, fn):
    """Run ``fn`` with every launch counter set to 0 just before it; returns
    (its result, the counts read just after)."""
    for kern in kernels:
        kern.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.symbol: k.launches for k in kernels}


_CUMULATIVE = ("tokens_generated", "decode_steps", "prefill_batches",
               "prefix_hits", "prefix_hit_tokens", "cow_copies", "preempted",
               "resumed", "pressure_events")


def report_serve(name, before, m, seconds):
    """Print one serve's numbers: the engine's cumulative counters as
    deltas over this serve (``before`` -> ``m``); returns those deltas
    (with the pool's peak so far).  ``pages_peak`` is the peak so far."""
    m = dict(m, **{k: m[k] - before.get(k, 0) for k in _CUMULATIVE
                   if k in m})
    line = (f"  {name}: {m['tokens_generated']} tokens in {seconds:.2f} s = "
            f"{m['tokens_generated'] / seconds:.1f} tok/s, "
            f"{m['decode_steps']} decode steps, {m['prefill_batches']} "
            f"prefill batches")
    if m["paged"]:
        line += (f", prefix hits {m['prefix_hits']} ({m['prefix_hit_tokens']}"
                 f" tokens), COW copies {m['cow_copies']}, pages_peak "
                 f"{m['pages_peak']}/{m['pages_total']}, peak_cache_bytes "
                 f"{m['peak_cache_bytes']}, preempted {m['preempted']}, "
                 f"resumed {m['resumed']}, pressure events "
                 f"{m['pressure_events']}")
    print(line, flush=True)
    return m


def fresh(rs):
    """New Request objects with the same prompts and budgets."""
    from repro_torch.serve.engine import Request
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in rs]


def timed_serve(name, eng, rs):
    """Serve fresh copies of ``rs``, print the serve's numbers, check every
    request got its budget; returns (results, counter deltas, seconds)."""
    before = eng.metrics()
    t0 = time.perf_counter()
    out = eng.serve(fresh(rs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = report_serve(name, before, eng.metrics(), seconds)
    check(sorted(out) == sorted(r.rid for r in rs), f"{name}: results")
    for r in rs:
        check(len(out[r.rid]) == r.max_new_tokens,
              f"{name} request {r.rid}: {len(out[r.rid])} tokens")
    return out, m, seconds


def slice2_paths(dev, kernels, cfg, model, qparams, data, reqs, results,
                 layer0):
    """The paged and int8 KV paths and the alpha search through the fused
    quant-error kernel, each with the launch counters zeroed just before
    it and read just after.  Returns {path: launch counts} and the alpha
    search's time as keys of quant_error's kernel row."""
    from repro_torch.core.methods import (DEFAULT_ALPHA_GRID,
                                          candidate_scale, quant_error,
                                          search_alpha)
    from repro_torch.kernels.ops import quant_error_batch
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    counts = {}
    kw = dict(n_slots=4, max_len=1024, device=dev)

    def serve(name, eng, rs):
        return timed_serve(name, eng, rs)[:2]

    # 1. paged bf16: the same requests, the dense engine's bits
    phase("main path: paged KV cache (bf16), the same 8 requests")
    eng_p = ServeEngine(model, qparams, paged=True, page_size=16, **kw)
    (paged, _), counts["paged bf16 serve"] = counted(
        kernels, lambda: serve("paged serve", eng_p, reqs))
    same = [np.array_equal(paged[r.rid], results[r.rid]) for r in reqs]
    print(f"  paged tokens equal the dense engine's bit for bit: "
          f"{sum(same)}/{len(reqs)} requests", flush=True)
    check(all(same), "paged serve tokens differ from the dense engine's")
    del eng_p

    # 2. shared prefix: 256 tokens (16 pages) + tails of 20..200, twice
    phase("main path: shared 256-token prefix, 8 requests served twice")
    prefix = data.sequence(42_000_000, 256)
    tails = np.linspace(20, 200, 8).astype(int)
    shared = [Request(rid=200 + i, prompt=np.concatenate(
                  [prefix, data.sequence(42_000_001 + i, int(n))]),
                      max_new_tokens=NEW_TOKENS)
              for i, n in enumerate(tails)]
    eng_s = ServeEngine(model, qparams, paged=True, page_size=16, **kw)

    def shared_twice():
        out1, m1 = serve("shared-prefix serve 1", eng_s, shared)
        check(m1["prefix_hits"] > 0, "no prefix hit in the first serve")
        check(eng_s.pool.pages_in_use() == len(eng_s.pool.index),
              "pages leaked after the first shared-prefix serve")
        out2, m2 = serve("shared-prefix serve 2", eng_s, shared)
        check(m2["prefix_hits"] == len(shared),
              f"second serve: {m2['prefix_hits']} of {len(shared)} "
              f"requests admitted by a prefix hit")
        check(eng_s.pool.pages_in_use() == len(eng_s.pool.index),
              "pages leaked after the second shared-prefix serve")
        return out1, out2

    (out1, out2), counts["shared-prefix serves"] = counted(kernels,
                                                          shared_twice)
    print(f"  pages in use after both serves = index blocks = "
          f"{len(eng_s.pool.index)}; second serve tokens equal the first's "
          f"for {sum(np.array_equal(out1[r.rid], out2[r.rid]) for r in shared)}"
          f"/{len(shared)} requests", flush=True)
    check_teacher_forced("shared-prefix serve 1", model, qparams, shared,
                         out1, dev)
    check_teacher_forced("shared-prefix serve 2", model, qparams, shared,
                         out2, dev)
    del eng_s

    # 3. pressure: a pool of 115 pages (the default is 257) preempts and
    # resumes; 80 pages would livelock, in the reference's protocol too
    # (tests/test_torch_pages.py holds both)
    phase("main path: paged engine with 115 of 257 pages (pressure)")
    eng_x = ServeEngine(model, qparams, paged=True, page_size=16,
                        n_pages=115, **kw)
    (pressed, m_x), counts["pressure serve"] = counted(
        kernels, lambda: serve("pressure serve", eng_x, reqs))
    check(m_x["pressure_events"] > 0 and m_x["preempted"] > 0,
          "the small pool saw no pressure")
    check(m_x["resumed"] == m_x["preempted"],
          f"resumed {m_x['resumed']} != preempted {m_x['preempted']}")
    agree = sum(int((pressed[r.rid] == results[r.rid]).sum()) for r in reqs)
    print(f"  tokens equal to the unpressured run: {agree}/"
          f"{len(reqs) * NEW_TOKENS}", flush=True)
    check_teacher_forced("pressure serve", model, qparams, reqs, pressed,
                         dev)
    del eng_x

    # 4. int8 KV: dense and paged, bit for bit
    phase("main path: int8 KV cache, dense and paged")
    model8 = build_model(cfg.scaled(kv_cache_bits=8))

    def int8_serves():
        out_d, _ = serve("int8 dense serve",
                         ServeEngine(model8, qparams, **kw), reqs)
        out_p, _ = serve("int8 paged serve",
                         ServeEngine(model8, qparams, paged=True,
                                     page_size=16, **kw), reqs)
        return out_d, out_p

    (q8_dense, q8_paged), counts["int8 serves"] = counted(kernels,
                                                         int8_serves)
    same = [np.array_equal(q8_dense[r.rid], q8_paged[r.rid]) for r in reqs]
    print(f"  int8 dense == int8 paged bit for bit: {sum(same)}/{len(reqs)} "
          f"requests", flush=True)
    check(all(same), "int8 dense and paged tokens differ")
    agree = sum(int((q8_dense[r.rid] == results[r.rid]).sum()) for r in reqs)
    print(f"  int8 tokens equal to the bf16 run: {agree}/"
          f"{len(reqs) * NEW_TOKENS} (int8 KV is lossy; not asserted)",
          flush=True)

    # 5. the alpha search of layer 0 through the fused quant-error kernel
    phase("main path: layer-0 alpha search through quant_error_batch")
    spec = layer0["spec"]

    def alpha_search():
        rows = []
        for path, (w, a_stat, msq) in layer0["sites"].items():
            scales = torch.stack(
                [candidate_scale(a_stat, a) for a in DEFAULT_ALPHA_GRID]
                + [torch.ones_like(a_stat)])
            rows.append((path, w, a_stat, msq, scales,
                         quant_error_batch(w, scales, msq, spec)))
        return rows

    rows, counts["alpha search"] = counted(kernels, alpha_search)
    # the search's 7 launches timed as one sum (after the count was read)
    search_ms = time_ms(lambda i: [quant_error_batch(w, sc, msq, spec)
                                   for _, w, _, msq, sc, _ in rows],
                        reps=5, inner=1)
    search_bound = sum(quant_error_bound(*w.shape, sc.shape[0])[0]
                       for _, w, _, _, sc, _ in rows)
    print(f"  layer-0 alpha search: {len(rows)} quant_error launches in "
          f"{search_ms:.4f} ms (sum of their bounds {search_bound:.4f} ms)",
          flush=True)
    for path, w, a_stat, msq, _, got in rows:
        plain = torch.stack(
            [quant_error(w, spec, candidate_scale(a_stat, a), mean_sq=msq)
             for a in DEFAULT_ALPHA_GRID] +
            [quant_error(w, spec, None, mean_sq=msq)])
        res = search_alpha(w, a_stat, spec, DEFAULT_ALPHA_GRID, mean_sq=msq)
        rel = float(((got - plain).abs() / plain.abs()).max())
        pick = int(torch.argmin(got[:-1]))
        want = int(torch.argmin(plain[:-1]))
        tie = abs(float(got[pick] - got[want])) <= 1e-6 * float(got[want])
        print(f"  {path}: kernel vs search losses max rel diff {rel:.2e}; "
              f"alpha {DEFAULT_ALPHA_GRID[pick]:.2f} (search "
              f"{float(res.alpha):.2f}), loss {float(got[pick]):.6e} vs RTN "
              f"{float(got[-1]):.6e}", flush=True)
        check(rel <= 1e-5, f"{path}: quant_error_batch losses differ from "
                           f"the search's by {rel:.2e}")
        check(float(res.alpha) == DEFAULT_ALPHA_GRID[want],
              f"{path}: the plain losses' argmin is not search_alpha's")
        check(pick == want or tie, f"{path}: kernel picks alpha "
                                   f"{DEFAULT_ALPHA_GRID[pick]}, the search "
                                   f"{DEFAULT_ALPHA_GRID[want]}")
    return counts, {"layer0_alpha_search_ms": search_ms,
                    "layer0_alpha_search_bound_ms": search_bound}


# prompts of the spec phases: one bucket (512), under the 512-token chunk,
# so the 4 requests are admitted in one prefill batch in every run
FOUR_LENS = (300, 340, 400, 450)


def _prefill_four(model, qparams, data, dev, seed):
    """Bucket-padded batched prefill of 4 prompts (FOUR_LENS) into a
    (4, 512) cache; returns (cache, the greedy next tokens)."""
    tokens = np.zeros((4, 512), np.int32)
    for i, n in enumerate(FOUR_LENS):
        tokens[i, :n] = data.sequence(seed + i, n)
    plen = torch.tensor(FOUR_LENS, dtype=torch.int32, device=dev)
    logits, cache = model.prefill(qparams, torch.as_tensor(tokens, device=dev),
                                  model.init_cache(4, 512, device=dev), plen)
    return cache, logits[:, 0].argmax(-1).to(torch.int32)


def _pages_of(cache, ps):
    """The dense cache's (L, B, KH, S, d) leaves as page stores (layer by
    layer, :func:`paged_store`) behind a table mapping slot b's logical
    page j to page 1 + b * NP + j."""
    b, s = cache["k"].shape[1], cache["k"].shape[3]
    table = (1 + torch.arange(b * (s // ps), device=cache["k"].device)) \
        .reshape(b, -1).to(torch.int32)
    return {key: torch.stack([paged_store(layer, ps, table)
                              for layer in leaf])
            for key, leaf in cache.items() if key != "len"}, table


def invariance_checks(cfg, model, qparams, data, dev):
    """Decode logits per slot at B = 1 / 2 / 4 bit for bit; then a 4-token
    burst through verify_step against 4 sequential decode_steps from the
    same cache state, bit for bit, for the bf16, int8 and paged caches."""
    from repro_torch.models.registry import build_model

    cache, nxt = _prefill_four(model, qparams, data, dev, 45_000_000)
    logits = {}
    for b in (4, 2, 1):
        sub = {k: (v[:b].clone() if k == "len" else v[:, :b].clone())
               for k, v in cache.items()}
        logits[b], _ = model.decode_step(qparams, sub, nxt[:b, None])
    for b in (2, 1):
        same_bits(f"decode logits of slots 0..{b - 1} at B={b} == at B=4",
                  logits[b], logits[4][:b])
    burst = torch.cat([nxt[:, None], torch.as_tensor(np.stack(
        [data.sequence(46_000_000 + i, 3) for i in range(4)]),
        device=dev)], dim=1).to(torch.int32)
    clone = lambda c: {k: v.clone() for k, v in c.items()}
    model8 = build_model(cfg.scaled(kv_cache_bits=8))
    cache8, _ = _prefill_four(model8, qparams, data, dev, 45_000_000)
    for name, mdl, c0 in (("bf16", model, cache), ("int8", model8, cache8)):
        got, _ = mdl.verify_step(qparams, clone(c0), burst)
        steps, c = [], clone(c0)
        for i in range(4):
            lg, c = mdl.decode_step(qparams, c, burst[:, i:i + 1])
            steps.append(lg)
        same_bits(f"{name}: verify_step logits == 4 sequential decode_steps "
                  f"(bases {FOUR_LENS})", got, torch.cat(steps, dim=1))
    store, table = _pages_of(cache, 16)
    got, _ = model.verify_step_paged(qparams, clone(store), burst, table,
                                     cache["len"])
    steps = []
    for i in range(4):
        lg, store = model.decode_step_paged(qparams, store, burst[:, i:i + 1],
                                            table, cache["len"] + i)
        steps.append(lg)
    same_bits("paged: verify_step_paged logits == 4 sequential "
              "decode_step_paged", got, torch.cat(steps, dim=1))


def spec_paths(dev, kernels, cfg, model, qparams, stats, data, reqs,
               results, serve_s):
    """Speculative decoding on the main path's packed weights: the
    invariance checks, the FAQ int8 self-draft (built from the packed
    weights and the calibration statistics), spec serving against plain
    serving on dense, paged and int8 caches, and an independent 2-layer
    draft.  Each path with the launch counters zeroed just before it and
    read just after.  Returns {path: launch counts}."""
    from repro_torch.models.registry import build_model
    from repro_torch.serve.draft import ModelDraft, self_int8_draft
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    counts = {}
    kw = dict(n_slots=4, max_len=1024, device=dev)

    phase("main path: decode logits per slot at B = 1 / 2 / 4; verify_step "
          "== 4 decode_steps (bf16, int8, paged)")
    _, counts["invariance checks"] = counted(
        kernels, lambda: invariance_checks(cfg, model, qparams, data, dev))

    phase("main path: FAQ int8 self-draft from the packed weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    draft = self_int8_draft(model, qparams, stats)
    torch.cuda.synchronize()
    draft_s = time.perf_counter() - t0
    draft_bytes = sum(draft.params["blocks"][name].nbytes
                      for _, name in model.quant_site_map())
    print(f"  built in {draft_s:.2f} s; {draft_bytes / 1e9:.2f} GB of bf16 "
          f"blocks; peak while building "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del stats

    def spec_report(name, m, seconds, plain_s):
        print(f"  {name}: accept_rate {m['accept_rate']:.3f}, draft_share "
              f"{m['draft_share']:.3f}, tokens_per_step (all slots) "
              f"{m['tokens_generated'] / max(m['decode_steps'], 1):.2f}, "
              f"spec cycles {m['spec_cycles']}, {seconds:.2f} s against the "
              f"plain run's {plain_s:.2f} s", flush=True)

    def spec_eng(mdl, d, **extra):
        return ServeEngine(mdl, qparams, spec=SpecConfig(k=3, draft=d),
                           **kw, **extra)

    four = [Request(rid=500 + i, prompt=data.sequence(43_000_000 + i, n),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(FOUR_LENS)]
    phase("main path: spec serve (self-int8 draft, k 3), 4 requests in one "
          "prefill batch, dense and paged")
    plain4, _, plain4_s = timed_serve("plain serve, 4 requests",
                                      ServeEngine(model, qparams, **kw), four)
    for paged in (False, True):
        name = f"spec serve {'paged' if paged else 'dense'}, 4 requests"
        eng = spec_eng(model, draft, paged=paged, page_size=16)
        (out, _, sec), counts[name] = counted(
            kernels, lambda: timed_serve(name, eng, four))
        m = eng.metrics()
        spec_report(name, m, sec, plain4_s)
        same = [np.array_equal(out[r.rid], plain4[r.rid]) for r in four]
        print(f"  {name}: tokens equal the plain serve's bit for bit: "
              f"{sum(same)}/{len(four)}", flush=True)
        check(all(same), f"{name}: tokens differ from the plain serve's")
        check(m["spec_cycles"] > 0, f"{name}: no spec cycle ran")
        del eng

    phase("main path: spec serve, the 8 mixed requests of the dense run")
    eng = spec_eng(model, draft)
    name = "spec serve dense, 8 mixed requests"
    (out8, _, sec8), counts[name] = counted(
        kernels, lambda: timed_serve(name, eng, reqs))
    spec_report(name, eng.metrics(), sec8, serve_s)
    agree = sum(int((out8[r.rid] == results[r.rid]).sum()) for r in reqs)
    print(f"  tokens equal to the plain dense run: {agree}/"
          f"{len(reqs) * NEW_TOKENS}", flush=True)
    check_teacher_forced(name, model, qparams, reqs, out8, dev)
    del eng
    print(f"  max_memory_allocated since the draft build: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    phase("main path: int8 KV spec serve, 4 requests, dense and paged")
    model8 = build_model(cfg.scaled(kv_cache_bits=8))
    plain8, _, plain8_s = timed_serve("int8 plain serve, 4 requests",
                                      ServeEngine(model8, qparams, **kw),
                                      four)
    for paged in (False, True):
        name = f"int8 spec serve {'paged' if paged else 'dense'}, 4 requests"
        eng = spec_eng(model8, draft, paged=paged, page_size=16)
        (out, _, sec), counts[name] = counted(
            kernels, lambda: timed_serve(name, eng, four))
        spec_report(name, eng.metrics(), sec, plain8_s)
        same = [np.array_equal(out[r.rid], plain8[r.rid]) for r in four]
        print(f"  {name}: tokens equal the int8 plain serve's bit for bit: "
              f"{sum(same)}/{len(four)}", flush=True)
        check(all(same), f"{name}: tokens differ from the plain serve's")
        del eng
    del draft

    phase("main path: independent draft (llama3-8b width, 2 layers, random "
          "weights), 4 short requests")
    short = [Request(rid=600 + i, prompt=data.sequence(44_000_000 + i, 12),
                     max_new_tokens=16) for i in range(4)]
    plain_s, _, plain_s_s = timed_serve("plain serve, 4 short requests",
                                        ServeEngine(model, qparams, **kw),
                                        short)
    dmodel = build_model(cfg.scaled(n_layers=2))
    indep = ModelDraft(model=dmodel, params=dmodel.init(1, device=dev))
    eng = spec_eng(model, indep)
    name = "spec serve, independent draft"
    (out, _, sec), counts[name] = counted(
        kernels, lambda: timed_serve(name, eng, short))
    m = eng.metrics()
    spec_report(name, m, sec, plain_s_s)
    check(m["draft_kind"] == "model", "the independent draft is not a model")
    same = [np.array_equal(out[r.rid], plain_s[r.rid]) for r in short]
    print(f"  {name}: tokens equal the plain serve's bit for bit: "
          f"{sum(same)}/{len(short)}", flush=True)
    check(all(same), f"{name}: tokens differ from the plain serve's")
    del eng, indep, dmodel
    torch.cuda.empty_cache()
    return counts


def profile_phase(eng, data, Request):
    """Where a serving step's time goes: torch.profiler over one short
    serve (4 requests of 12 tokens: one bucketed prefill + 8 decode steps
    at 4 slots), device time by kernel against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [Request(rid=300 + i, prompt=data.sequence(41_000_000 + i, 12),
                    max_new_tokens=9) for i in range(4)]
    eng.serve(reqs)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy_ms = sum(r[1] for r in rows)
    on_device = sum(1 for e in prof.events()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
    phase("profile: 4 x 12-token requests, 1 prefill + 8 decode steps")
    print(f"  wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall; "
          f"{on_device} device operations = {on_device / 9:.0f} per engine "
          f"step (1 prefill + 8 decode steps)", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key[:90]}", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_error as qe
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rms_norm as rn

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # bf16 library GEMMs (the unquantized lm_head, calibration linears)
    # reduce in f32; f32 GEMMs stay full f32 (no TF32)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("device")
    smi = nvidia_smi()
    print(f"  {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"capability {torch.cuda.get_device_capability(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  nvcc: {', '.join(f'{s} {t:.1f}s' for s, t in built.items())} "
          f"(all in {time.perf_counter() - t0:.1f} s, parallel)", flush=True)
    for src_name, log in _build.build_logs.items():
        for kernel, report in ptxas_report(log):
            print(f"  {src_name} {kernel}: {report}", flush=True)

    # every kernel, in the order of the TPU kernel table (PERF.md)
    by_name = {"quant_matmul": qm.KERNEL, "flash_decode": fd.KERNEL,
               "flash_decode_q8": fd.KERNEL_Q8, "flash_attention": fa.KERNEL,
               "flash_decode_paged": fd.KERNEL_PAGED,
               "flash_decode_paged_q8": fd.KERNEL_PAGED_Q8,
               "quant_error": qe.KERNEL, "flash_verify": fd.VERIFY,
               "flash_verify_q8": fd.VERIFY_Q8,
               "flash_verify_paged": fd.VERIFY_PAGED,
               "flash_verify_paged_q8": fd.VERIFY_PAGED_Q8,
               "rms_norm": rn.KERNEL}
    kernels = tuple(by_name.values())
    rows = {r["name"]: r for r in kernel_phase(dev)}
    check(sorted(rows) == sorted(by_name), f"kernel rows {sorted(rows)}")
    rows = [rows[name] for name in by_name]
    phase("reference: tiny model, card against CPU")
    reference_phase(dev)
    phase("main path: llama3-8b calibrate -> FAQ -> int4 pack -> serve")
    launches, row_keys = main_path_phase(dev, kernels)
    for row, kern in zip(rows, kernels):
        row.update(row_keys.get(row["name"], {}))
        row["launches"] = launches[kern.symbol]
        check(row["launches"] > 0,
              f"{row['name']} was not launched on the main path")
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
