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
              ``torch.nn.functional.rms_norm``; flash_attention also with
              a key length per row, 4 prompts of 300..450 tokens padded to
              512, each prompt's rows bit for bit against the prompt alone
              at its exact length, timed beside a masked
              scaled_dot_product_attention); the two backward kernels
              (flash_attention at q (32, 4, 512, 128), bf16 and f32,
              beside the backward of scaled_dot_product_attention;
              rms_norm at (2048, 4096) beside ``F.rms_norm``'s), each
              against its plain version and bit for bit on a second run;
4. reference — a tiny llama3-8b on the card (kernels) against the same
              model on the CPU (plain versions): logits and greedy tokens;
   train    — llama3-8b at full width cut to 2 layers: step 1's gradients
              (every leaf non-zero, held per leaf against the plain
              versions' step), 20 AdamW steps of 4 x 512 tokens, a
              save_async of {params, opt} after step 10 restored bit for
              bit and resumed to the same loss bits, and the trained
              params' checkpoint served through launch/serve.py's restore
              with the in-memory params' tokens;
5. main path — llama3-8b at full width and depth (d_model 4096, 32 heads,
              8 KV heads, d_ff 14336, vocab 128256, 32 layers), random
              bf16 weights from a seed: calibrate on 16 x 512 tokens (the
              flash-attention path), FAQ alpha search, int4 pack (g = 64),
              then a 4-slot engine serves 8 greedy requests of 12..700
              prompt tokens (bucketed and chunked prefill) for 32 tokens
              each; between FAQ and serving, full_search_faq (paper Eq.
              8) over the 32 layers' 7 sites through quant_error, its
              choices held against the plain search's.  After serving,
              the packed tree is saved by launch/quantize, restored, and
              must serve the same tokens bit for bit.  Request 0 is
              served again alone through the same
              engine and must match bit for bit; every request admitted
              whole (prompt within the 512-token chunk) is regenerated
              with the batch-1 ``generate`` and must match the engine bit
              for bit (bucket-padded prefill runs the length-masked
              flash-attention kernel, whose rows do not depend on the
              bucket or the batch; decode rows are batch-invariant); the
              two chunked requests, whose prompt tails go through decode
              steps by design, must be greedy decodes of a teacher-forced
              exact-length forward up to ``TIE_TOL``.  Then, on the same
              packed weights: the
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
              serving bit for bit.  Then the serving layers above the
              engine: 12 Poisson requests (12..700-token prompts) through
              ``Scheduler.run_traffic`` at half the closed-loop rate, dense
              and paged, equal to a closed-loop serve bit for bit, with
              TTFT, queue-delay and per-token percentiles; the same trace
              at twice the rate under SLO admission (two tenants, quotas,
              deadlines): every request reaches one terminal outcome and
              some shed is retried; a paged serve with vetoed page
              allocations, a forced preemption and a stall, whose
              survivors equal the fault-free run bit for bit; a traced
              serve whose trace validates and nests, its tok/s beside an
              untraced one and its host ms per decode step by span.  The
              launch counters are zeroed just before each of these paths
              and read just after it;
6. profile  — ``repro_torch.obs.profile_session`` (torch.profiler) over
              one short serve: device busy time against wall time, device
              operations per engine step, and the top kernels.

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

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
                     bound_by=b_by, library_ms=lib,
                     masked=masked_flash_attention(dev, gen, randn)))
    rows.append(quant_error_row(dev, gen, randn))
    rows += verify_rows(dev, gen, randn)
    rows.append(rms_norm_row(dev, gen, randn))
    rows.append(flash_attention_bwd_row(dev, gen, randn))
    rows.append(rms_norm_bwd_row(dev, gen, randn))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}", flush=True)
    return rows


MASKED_LENS = (300, 340, 400, 450)


def masked_flash_attention(dev, gen, randn):
    """flash_attention with a key length per batch row, as bucket-padded
    prefill runs it: 4 prompts of 300..450 tokens padded to the 512 bucket
    (llama3-8b: 8 KV heads, G 4, hd 128, bf16).  Held against the plain
    version with the same lengths; each prompt's valid rows bit for bit
    against the prompt run alone at its exact length (B 1); kv_lens = T
    bit for bit against no mask; then timed beside the plain version and
    one masked scaled_dot_product_attention.  Returns the row's second
    shape."""
    from repro_torch.kernels import flash_attention as fa
    b, kh, g, t, hd = len(MASKED_LENS), 8, 4, 512, 128
    sets = [(randn(b * kh, g, t, hd), randn(b * kh, t, hd),
             randn(b * kh, t, hd)) for _ in range(2)]
    lens = torch.tensor(MASKED_LENS, dtype=torch.int32, device=dev)
    q, k, v = sets[0]
    got = fa.flash_attention(q, k, v, kv_lens=lens)
    err = held("masked B=4 T=512 lens 300/340/400/450", got,
               fa.flash_attention_ref(q, k, v, kv_lens=lens),
               rel_tol=BF16_REL_TOL)
    for i, n in enumerate(MASKED_LENS):
        rows = slice(kh * i, kh * (i + 1))
        same_bits(f"masked rows of prompt {i} ({n} tokens) == the prompt "
                  f"alone at T {n}", got[rows, :, :n],
                  fa.flash_attention(q[rows, :, :n].contiguous(),
                                     k[rows, :n].contiguous(),
                                     v[rows, :n].contiguous()))
    same_bits("kv_lens = T == no mask",
              fa.flash_attention(q, k, v, kv_lens=torch.full_like(lens, t)),
              fa.flash_attention(q, k, v))
    ms = time_ms(lambda i: fa.flash_attention(*sets[i % 2], kv_lens=lens))
    plain = time_ms(lambda i: fa.flash_attention_ref(*sets[i % 2],
                                                     kv_lens=lens), reps=5)
    key = torch.arange(t, device=dev)
    mask = (torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))[None]
            & (key < lens[:, None])[:, None, :])[:, None]   # (B, 1, T, T)

    def sdpa_masked(i):
        q_, k_, v_ = sets[i % 2]
        return torch.nn.functional.scaled_dot_product_attention(
            q_.reshape(b, kh * g, t, hd), k_.reshape(b, kh, t, hd),
            v_.reshape(b, kh, t, hd), attn_mask=mask, enable_gqa=True)

    lib_out = sdpa_masked(0).reshape(b * kh, g, t, hd)
    ref = fa.flash_attention_ref(q, k, v, kv_lens=lens)
    for i, n in enumerate(MASKED_LENS):
        valid = slice(kh * i, kh * (i + 1))
        held(f"library call (masked sdpa), prompt {i}",
             lib_out[valid, :, :n], ref[valid, :, :n])
    lib = time_ms(sdpa_masked)
    # bytes of q, k, v and out at the valid lengths; the products' work
    # over the valid causal triangles
    n_tok = sum(MASKED_LENS)
    b_ms, b_by = bound((2 * kh * g + 2 * kh) * n_tok * hd * 2,
                       sum(4 * kh * g * hd * n * (n + 1) / 2
                           for n in MASKED_LENS))
    print(f"  flash_attention, length-masked: {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library (masked sdpa) {lib:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}", flush=True)
    return dict(shape=f"q ({b * kh},{g},{t},{hd}) bf16, kv_lens "
                      f"{'/'.join(map(str, MASKED_LENS))}, causal",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


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


def flash_attention_bwd_row(dev, gen, randn):
    """flash_attention's backward kernel at the train path's attention
    shape (B 4, T 512, 32 heads on 8 KV heads, hd 128: q (32, 4, 512,
    128)), bf16 and f32: dq, dk, dv against flash_attention_bwd_ref with
    the forward's tolerances, the same bits on a second run (no atomics),
    then (bf16) timed beside the plain version and the backward of
    scaled_dot_product_attention (GQA) under autograd."""
    from repro_torch.kernels import flash_attention as fa

    phase("kernel flash_attention_bwd")
    bkh, g, t, hd = 32, 4, 512, 128
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        q, do = randn(bkh, g, t, hd, dtype=dt), randn(bkh, g, t, hd, dtype=dt)
        k_, v_ = randn(bkh, t, hd, dtype=dt), randn(bkh, t, hd, dtype=dt)
        o, lse = fa._forward(q, k_, v_, True, None, with_lse=True)
        got = fa.flash_attention_bwd(q, k_, v_, o, lse, do)
        want = fa.flash_attention_bwd_ref(q, k_, v_, do)
        bf16 = dt == torch.bfloat16
        errs[dt] = max(held(f"{name} q ({bkh},{g},{t},{hd}) {str(dt)[6:]}", a,
                            b, rel_tol=BF16_REL_TOL if bf16 else None)
                       for name, a, b in zip(("dq", "dk", "dv"), got, want))
        again = fa.flash_attention_bwd(q, k_, v_, o, lse, do)
        same_bits(f"{str(dt)[6:]}: a second backward",
                  torch.cat([x.flatten() for x in again]),
                  torch.cat([x.flatten() for x in got]))
        if bf16:
            sets = (q, k_, v_, o, lse, do)
    q, k_, v_, o, lse, do = sets
    ms = time_ms(lambda i: fa.flash_attention_bwd(q, k_, v_, o, lse, do),
                 reps=10, inner=3)
    plain = time_ms(lambda i: fa.flash_attention_bwd_ref(q, k_, v_, do),
                    reps=3, inner=2)
    leaves = [x.reshape(shape).detach().requires_grad_() for x, shape in
              ((q, (4, 8 * g, t, hd)), (k_, (4, 8, t, hd)),
               (v_, (4, 8, t, hd)))]
    sd = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True)
    do_r = do.reshape(4, 8 * g, t, hd)

    def sdpa_bwd(i):
        return torch.autograd.grad(sd, leaves, do_r, retain_graph=True)

    held("library call (sdpa backward) dq", sdpa_bwd(0)[0].reshape(q.shape),
         fa.flash_attention_bwd_ref(q, k_, v_, do)[0], rel_tol=BF16_REL_TOL)
    lib = time_ms(sdpa_bwd, reps=10, inner=3)
    e = 2
    b_ms, b_by = bound((3 * bkh * g * t * hd + 2 * bkh * t * hd) * e
                       + bkh * g * t * 4
                       + (bkh * g * t * hd + 2 * bkh * t * hd) * e,
                       10 * hd * bkh * g * t * (t + 1) / 2)
    print(f"  bf16: {ms:.4f} ms, plain {plain:.4f} ms, library (sdpa "
          f"backward) {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}",
          flush=True)
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="none: a kernel of the port only (repro has no "
                         "backward kernel and trains through its jnp "
                         "attention; forward src/repro/kernels/"
                         "flash_attention.py:92)",
                shape=f"q/o/dO ({bkh},{g},{t},{hd}) bf16, k/v ({bkh},{t},"
                      f"{hd}), lse f32, causal",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                f32_max_abs_err=errs[torch.float32])


def rms_norm_bwd_row(dev, gen, randn):
    """rms_norm's backward kernel at the train path's (2048, 4096) rows,
    bf16 and f32: dx and dw against rms_norm_bwd_ref, the same bits on a
    second run (dw from per-block partials in a fixed order), then (bf16)
    timed beside the plain version and the backward of
    ``torch.nn.functional.rms_norm`` under autograd."""
    from repro_torch.kernels import rms_norm as rn

    phase("kernel rms_norm_bwd")
    rows_n, d, eps = 2048, 4096, 1e-5
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        x, dy = randn(rows_n, d, dtype=dt) * 3, randn(rows_n, d, dtype=dt)
        w = randn(d, dtype=dt)
        got = rn.rms_norm_bwd(x, w, dy, eps)
        want = rn.rms_norm_bwd_ref(x, w, dy, eps)
        bf16 = dt == torch.bfloat16
        errs[dt] = max(held(f"{name} ({rows_n},{d}) {str(dt)[6:]}", a, b,
                            rel_tol=BF16_REL_TOL if bf16 else None)
                       for name, a, b in zip(("dx", "dw"), got, want))
        again = rn.rms_norm_bwd(x, w, dy, eps)
        same_bits(f"{str(dt)[6:]}: a second backward",
                  torch.cat([a.flatten() for a in again]),
                  torch.cat([a.flatten() for a in got]))
        if bf16:
            sets = (x, w, dy)
    x, w, dy = sets
    ms = time_ms(lambda i: rn.rms_norm_bwd(x, w, dy, eps))
    plain = time_ms(lambda i: rn.rms_norm_bwd_ref(x, w, dy, eps))
    lib = None
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    if lib_fn is not None:
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = lib_fn(xl, (d,), wl, eps)
        lib = time_ms(lambda i: torch.autograd.grad(out, (xl, wl), dy,
                                                    retain_graph=True))
    b_ms, b_by = bound((3 * rows_n * d + 2 * d) * 2, 10 * rows_n * d,
                       F32_FLOPS_PER_S)
    print(f"  bf16: {ms:.4f} ms, plain {plain:.4f} ms, library (F.rms_norm "
          f"backward) {lib}, bound {b_ms:.4f} ms by {b_by}", flush=True)
    return dict(name="rms_norm_bwd", route="cuda",
                source="src/repro_torch/csrc/rms_norm.cu",
                replaces="none: a kernel of the port only (repro's rms_norm "
                         "is plain jnp, differentiated by jax.grad, "
                         "src/repro/models/common.py:54)",
                shape=f"x/dy ({rows_n},{d}) bf16, w ({d},)",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                f32_max_abs_err=errs[torch.float32])


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
# Phase 5a: training at full width, its checkpoint, serving from it
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 2                   # the train path's one cut (see train_paths)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 4, 512
RESUME_AT = 10
# limit on ||grad - plain grad|| / ||plain grad|| per leaf of one bf16 train
# step: the forward's bf16 roundings (P before P.V, the attention and norm
# outputs) differ between the kernels and the plain versions, 2^-9
# relative each, and reach every gradient through the backward
TRAIN_GRAD_TOL = 5e-2


@contextlib.contextmanager
def plain_kernels():
    """The models' flash_attention and rms_norm swapped for their plain
    versions (autograd through plain PyTorch: the yardstick of the train
    path's gradients) inside the with-block."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import common, dense

    saved = common.flash_attention, common.rms_norm, dense.rms_norm
    common.flash_attention = (
        lambda q, k, v, causal=True, kv_lens=None:
        fa.flash_attention_ref(q, k, v, causal=causal, kv_lens=kv_lens))
    common.rms_norm = dense.rms_norm = rn.rms_norm_ref
    try:
        yield
    finally:
        common.flash_attention, common.rms_norm, dense.rms_norm = saved


def disk_of(path) -> str:
    """The filesystem ``path`` is on: device, type, mount point, free GB."""
    real = os.path.realpath(path)
    best = ("?", "?", "/")
    with open("/proc/mounts") as f:
        for line in f:
            dev_, mnt, fstype = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[2]):
                best = (dev_, fstype, mnt)
    free = shutil.disk_usage(real).free / 1e9
    return (f"{real} on {best[0]} ({best[1]}, mounted at {best[2]}, "
            f"{free:.0f} GB free)")


def same_trees(a, b) -> bool:
    from repro_torch.dist._tree import leaves_with_keys
    la, lb = leaves_with_keys(a), leaves_with_keys(b)
    return len(la) == len(lb) and all(
        ka == kb and x.dtype == y.dtype and torch.equal(x, y)
        for (ka, x), (kb, y) in zip(la, lb))


def train_paths(dev, kernels):
    """Training on the card: llama3-8b at full width (d_model 4096, 32 / 8
    heads, d_ff 14336, vocab 128256), bf16, cut to 2 layers (bf16 params and
    grads plus f32 AdamW moments take 12 B per parameter: 2.6 GB per layer
    and 12.6 GB for the embedding and head, ~96 GB at 32 layers, more than
    the card), 20 AdamW steps of 4 x 512 tokens.  Step 1's gradients: every
    leaf non-zero, and held per leaf against the same step through the
    plain versions of both kernels.  A save_async of {params, opt} after
    step 10, restored bit for bit, and steps 11..20 from it give the
    uninterrupted run's loss bits.  A checkpoint of the trained params is
    served through launch/serve.py's restore (calibrate -> FAQ -> int4 pack ->
    4 requests), token for token as the in-memory params.  Returns
    {path: launch counts}."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import (QuantSpec, quantize_model, report_summary,
                                  run_calibration)
    from repro_torch.data.synthetic import calibration_batches
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.launch.serve import data_for, load_params
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.trainer import (TrainConfig, make_loss_fn,
                                           make_train_step, value_and_grad)

    full = ARCHS["llama3-8b"]
    cfg = full.scaled(n_layers=TRAIN_LAYERS)
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"dtype={cfg.dtype}; depth {cfg.n_layers} of {full.n_layers} "
          f"layers (the one cut: 12 B per parameter of params, grads and "
          f"f32 moments); token ids capped at 4096", flush=True)
    model = build_model(cfg)
    data = data_for(cfg)
    tcfg = TrainConfig(lr=1e-3, warmup=5, total_steps=TRAIN_STEPS)
    step_fn, opt = make_train_step(model, tcfg)
    batches = [data.batch(s, TRAIN_BATCH, TRAIN_SEQ)
               for s in range(TRAIN_STEPS)]
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=dev)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for _, p in leaves_with_keys(params))

    phase("main path: train, step 1's gradients, kernels against plain")
    loss_fn = make_loss_fn(model, tcfg.moe_aux_coef)
    b0 = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    (loss_k, _), grads = value_and_grad(loss_fn, params, b0)
    with plain_kernels():
        (loss_p, _), plain = value_and_grad(loss_fn, params, b0)
    plain = dict(leaves_with_keys(plain))
    worst = 0.0
    for key, g in leaves_with_keys(grads):
        check(bool(torch.isfinite(g).all()), f"grad {key} not finite")
        check(bool((g != 0).any()), f"grad {key} is zero after step 1")
        rel = float((g.float() - plain[key].float()).norm()
                    / plain[key].float().norm())
        print(f"  {key}: non-zero, ||grad - plain|| / ||plain|| = "
              f"{rel:.3e}", flush=True)
        worst = max(worst, rel)
    print(f"  every one of {len(plain)} leaves has a non-zero gradient; "
          f"loss {float(loss_k):.6f} (plain {float(loss_p):.6f}); worst "
          f"relative norm {worst:.3e} (limit {TRAIN_GRAD_TOL})", flush=True)
    check(worst <= TRAIN_GRAD_TOL, "step 1's gradients differ from the "
                                   "plain versions' step")
    del grads, plain
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    print(f"  checkpoints under {disk_of(tmp)}", flush=True)
    try:
        phase(f"main path: train {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens ({n_params / 1e9:.2f} B parameters)")
        run = {}

        def train():
            nonlocal params, opt_state
            losses, t_save = [], 0.0
            t0 = time.perf_counter()
            for s in range(TRAIN_STEPS):
                params, opt_state, met = step_fn(params, opt_state,
                                                 batches[s])
                losses.append(float(met["loss"]))
                if s + 1 == RESUME_AT:
                    t1 = time.perf_counter()
                    ckpt.save_async(tmp, RESUME_AT,
                                    {"params": params, "opt": opt_state})
                    run["snapshot_s"] = time.perf_counter() - t1
                    ckpt.wait_pending()
                    run["save_s"] = time.perf_counter() - t1
                    run["state10"] = {"params": params, "opt": opt_state}
                    t_save = run["save_s"]
            torch.cuda.synchronize()
            run["train_s"] = time.perf_counter() - t0 - t_save
            return losses

        losses, counts["train"] = counted(kernels, train)
        tok = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
        print(f"  loss step 1 {losses[0]:.4f} -> step {TRAIN_STEPS} "
              f"{losses[-1]:.4f}; {tok} tokens in {run['train_s']:.2f} s = "
              f"{tok / run['train_s']:.0f} tokens/s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(all(np.isfinite(losses)), "a training loss is not finite")
        check(losses[-1] < losses[0], "the loss did not fall in 20 steps")

        phase(f"main path: checkpoint at step {RESUME_AT}, restore, resume")
        nbytes = os.path.getsize(os.path.join(tmp, f"step_{RESUME_AT:08d}",
                                              "data.bin"))
        t0 = time.perf_counter()
        restored = ckpt.restore(tmp, RESUME_AT,
                                {"params": params, "opt": opt_state},
                                device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        print(f"  {nbytes / 1e9:.2f} GB: save_async {run['snapshot_s']:.2f} "
              f"s to snapshot, {run['save_s']:.2f} s written (wait_pending), "
              f"restore {read_s:.2f} s", flush=True)
        same = same_trees(restored, run.pop("state10"))
        print(f"  restored == the step-{RESUME_AT} state bit for bit: {same}",
              flush=True)
        check(same, "the restored checkpoint differs from the saved state")

        def resume():
            p, o = restored.pop("params"), restored.pop("opt")
            out = []
            for s in range(RESUME_AT, TRAIN_STEPS):
                p, o, met = step_fn(p, o, batches[s])
                out.append(float(met["loss"]))
            return out, p, o

        (resumed, p, o), counts["checkpoint resume"] = counted(kernels,
                                                               resume)
        del restored
        same = resumed == losses[RESUME_AT:]
        print(f"  steps {RESUME_AT + 1}..{TRAIN_STEPS} from the checkpoint: "
              f"loss bits equal the uninterrupted run's: {same}; final "
              f"params and moments bit for bit: "
              f"{same_trees({'p': p, 'o': o}, {'p': params, 'o': opt_state})}",
              flush=True)
        check(same, f"resumed losses {resumed} != {losses[RESUME_AT:]}")
        check(same_trees({"p": p, "o": o}, {"p": params, "o": opt_state}),
              "the resumed run ends on other params or moments")
        del p, o

        phase("main path: serve from the trained checkpoint")
        # the trained params alone (serving reads no optimizer state), and
        # one checkpoint on disk at a time
        shutil.rmtree(os.path.join(tmp, f"step_{RESUME_AT:08d}"))
        ckpt.save(tmp, TRAIN_STEPS, {"params": params})
        del opt_state
        torch.cuda.empty_cache()
        spec = QuantSpec(bits=4, group_size=64)
        reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, 12),
                        max_new_tokens=12) for i in range(4)]

        def pipeline(weights):
            stats = run_calibration(model.forward, weights,
                                    calibration_batches(data, 16, 64))
            qp, report = quantize_model(weights, model.quant_site_map(), stats,
                                        method="faq", spec=spec,
                                        mode="packed")
            eng = ServeEngine(model, qp, n_slots=4, max_len=128, device=dev)
            return eng.serve(fresh(reqs)), report_summary(report)

        def from_ckpt():
            return pipeline(load_params(tmp, model.init(1, device=dev)))

        (served, summary), counts["serve from checkpoint"] = counted(
            kernels, from_ckpt)
        in_memory, _ = pipeline(params)
        same = [np.array_equal(served[r.rid], in_memory[r.rid]) for r in reqs]
        print(f"  tokens equal to the in-memory trained params': "
              f"{sum(same)}/{len(reqs)} requests", flush=True)
        check(all(same), "serving the checkpoint differs from in-memory")
        for path, st in summary.items():
            print(f"  FAQ vs RTN on weights after {TRAIN_STEPS} training "
                  f"steps only: {path}: improvement_vs_rtn "
                  f"{100 * st['improvement_vs_rtn']:.2f}% (mean alpha "
                  f"{st['mean_alpha']:.3f})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    return counts


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
    fs_counts, fs_keys = full_search_path(kernels, model, params, stats)
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
    # engine == generate bit for bit for every request admitted whole:
    # bucket-padded batched prefill gives each prompt the bits of its
    # exact-length batch-1 prefill (length-masked flash attention), and
    # decode rows do not depend on the batch
    whole = [r for r in reqs if len(r.prompt) <= eng.prefill_chunk]
    t0 = time.perf_counter()
    alone = {r.rid: eng.generate(Request(rid=100 + r.rid, prompt=r.prompt,
                                         max_new_tokens=NEW_TOKENS))
             for r in whole}
    times["generate"] = (time.perf_counter() - t0) / len(whole)
    launches = {k.symbol: k.launches for k in kernels}
    for r in whole:
        first_diff = next((j for j in range(NEW_TOKENS)
                           if alone[r.rid][j] != results[r.rid][j]), None)
        print(f"  request {r.rid} ({len(r.prompt)} tokens): engine == "
              f"generate bit for bit: {first_diff is None}"
              + ("" if first_diff is None
                 else f" (first difference at token {first_diff})"),
              flush=True)
        check(first_diff is None,
              f"request {r.rid}: engine {results[r.rid].tolist()} != "
              f"generate {alone[r.rid].tolist()}")
    # chunked admissions write their prompt tail through decode steps, so
    # their bits differ from generate's exact-length prefill by design:
    # greedy up to TIE_TOL of a teacher-forced exact-length forward
    check_teacher_forced("chunked requests (engine)", model, qparams,
                         [r for r in reqs if r not in whole], results, dev)
    print(f"  serve: {m['tokens_generated']} tokens in {times['serve']:.2f} "
          f"s = {m['tokens_generated'] / times['serve']:.1f} tok/s, "
          f"{m['decode_steps']} decode steps, {m['prefill_batches']} prefill "
          f"batches, {m['chunked_admissions']} chunked admissions, "
          f"{m['fill_steps']} fill steps", flush=True)
    print(f"  generate (1 slot): {NEW_TOKENS} tokens in "
          f"{times['generate']:.2f} s = "
          f"{NEW_TOKENS / times['generate']:.1f} tok/s (mean of "
          f"{len(whole)} requests)", flush=True)
    print(f"  phase seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in times.items()))
    print(f"  max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    pk_counts = packed_checkpoint_path(dev, kernels, model, qparams, reqs,
                                       results)
    counts_by_path, qe_keys = slice2_paths(dev, kernels, cfg, model, qparams,
                                           data, reqs, results, layer0)
    counts_by_path["full_search_faq"] = fs_counts
    counts_by_path["packed checkpoint serve"] = pk_counts
    qe_keys.update(fs_keys)
    counts_by_path.update(spec_paths(dev, kernels, cfg, model, qparams,
                                     stats, data, reqs, results,
                                     times["serve"]))
    counts_by_path.update(traffic_paths(dev, kernels, model, qparams, data,
                                        times["serve"]))
    for path, counts in counts_by_path.items():
        print(f"  launches on the {path} path: {counts}", flush=True)
        for sym, n in counts.items():
            launches[sym] += n
    print(f"  max_memory_allocated over all paths: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_phase(eng, data, Request)
    return launches, {"quant_error": qe_keys}


# candidates whose kernel loss lies within this of the kernel's minimum are
# scored by the plain version too (see full_search_path)
SCREEN = 3e-5


def full_search_path(kernels, model, params, stats):
    """full_search_faq (paper Eq. 8) over the main path's 32 layers and 7
    sites on the calibration statistics, the diagonal loss: one
    quant_error_batch launch per ((γ, j), layer, site), counted.  Then the
    plain search's choice per (layer, site): the kernel's losses of every
    candidate are recomputed (outside the count); the plain version scores
    every candidate of layers 0 and 31, and elsewhere those within SCREEN
    of the kernel's minimum.  Every plain loss must be within 1e-5 of the
    kernel's (the kernel's terms are the plain version's bits, only their
    sum's order differs), so a candidate outside the screen lies above
    the plain minimum and the plain argmin over the screened candidates,
    first (γ, j) then first α on ties, is the full plain search's.  The
    kernel's choice must be that one or lose at most 1e-5 relative to
    it, and each layer's loss must be at most the presearched (γ 0.85,
    j 3) loss.  Returns (counts, keys for quant_error's kernel row)."""
    from repro_torch.core import QuantSpec
    from repro_torch.core.methods import (FULL_SEARCH_GAMMAS,
                                          FULL_SEARCH_WINDOWS,
                                          full_search_faq)

    phase("main path: full_search_faq (paper Eq. 8), 32 layers x 7 sites")
    spec = QuantSpec(bits=4, group_size=64)
    sites = model.quant_site_map()

    def search():
        return {"/".join(path): full_search_faq(
            params[path[0]][path[1]], stats[site]["mean_abs"], spec,
            mean_sq=stats[site]["mean_sq"]) for path, site in sites.items()}

    t0 = time.perf_counter()
    best, counts = counted(kernels, search)
    seconds = time.perf_counter() - t0
    combos = [(g, j) for g in FULL_SEARCH_GAMMAS for j in FULL_SEARCH_WINDOWS]
    as_f32 = [(float(np.float32(g)), j) for g, j in combos]   # as reported
    n_layers = next(iter(best.values()))["loss"].shape[0]
    launches = counts["quant_error_launch"]
    print(f"  {seconds:.2f} s, {launches} quant_error launches ({len(sites)} "
          f"sites x {n_layers} layers x {len(combos)} (gamma, j))", flush=True)
    check(launches == len(sites) * n_layers * len(combos),
          "full_search_faq: not one launch per (combination, layer, site)")
    out = {}
    # the check's own launches (the kernel's losses of every candidate) are
    # counted apart and dropped: only the search above is the main path
    counted(kernels, lambda: out.update(verify_full_search(
        best, params, stats, sites, spec, combos, as_f32)))
    agree, total, plain_evals, worst = (out[k] for k in (
        "agree", "total", "plain_evals", "worst"))
    print(f"  (gamma, j, alpha) equal to the plain search's in {agree}/"
          f"{total} (layer, site) pairs; {plain_evals} plain losses scored "
          f"(max rel diff to the kernel {worst:.2e}); every layer no worse "
          f"than the presearched (0.85, 3)", flush=True)
    return counts, {"full_search_s": seconds,
                    "full_search_launches": launches,
                    "full_search_agree": f"{agree}/{total}"}


def verify_full_search(best, params, stats, sites, spec, combos, as_f32):
    """full_search_path's check of the kernel's choices against the plain
    search's (see there)."""
    from repro_torch.core.methods import (DEFAULT_ALPHA_GRID,
                                          candidate_scale, fuse_stats,
                                          quant_error)
    from repro_torch.kernels.ops import quant_error_batch

    grid = DEFAULT_ALPHA_GRID
    n_layers = next(iter(best.values()))["loss"].shape[0]
    agree, plain_evals, worst = 0, 0, 0.0
    for path, site in sites.items():
        key = "/".join(path)
        w = params[path[0]][path[1]]
        msq = stats[site]["mean_sq"]
        fused = [fuse_stats(stats[site]["mean_abs"], *c) for c in combos]
        pre = combos.index((0.85, 3))
        for l in range(n_layers):
            scales = [torch.stack([candidate_scale(f[l], a) for a in grid]
                                  + [torch.ones_like(f[l])]) for f in fused]
            kl = torch.stack([quant_error_batch(w[l], sc, msq[l], spec)[:-1]
                              for sc in scales]).cpu()         # (24, 21)
            ci, ai = (as_f32.index((float(best[key]["gamma"][l]),
                                    int(best[key]["window"][l]))),
                      grid.index(float(best[key]["alpha"][l])))
            kmin = float(kl.min())
            check(float(kl[ci, ai]) == kmin == float(best[key]["loss"][l]),
                  f"{key} layer {l}: full_search_faq's loss is not the "
                  f"minimum of its candidates")
            check(kmin <= float(kl[pre].min()),
                  f"{key} layer {l}: loss above the presearched (0.85, 3)")
            every = l in (0, n_layers - 1)
            chosen = [(c, a) for c in range(len(combos))
                      for a in range(len(grid))
                      if every or float(kl[c, a]) <= kmin * (1 + SCREEN)]
            plain = {}
            for c, a in chosen:
                plain[c, a] = float(quant_error(
                    w[l], spec, scales[c][a], mean_sq=msq[l]))
                rel = abs(plain[c, a] - float(kl[c, a])) / plain[c, a]
                worst = max(worst, rel)
                check(rel <= 1e-5, f"{key} layer {l}: kernel loss differs "
                                   f"from the plain version's by {rel:.2e}")
            plain_evals += len(chosen)
            want = min(plain, key=lambda ca: (plain[ca], ca))
            if (ci, ai) == want:
                agree += 1
            else:
                gap = (plain[ci, ai] - plain[want]) / plain[want]
                print(f"  {key} layer {l}: kernel picks (gamma, j, alpha) "
                      f"{combos[ci]} {grid[ai]:.2f}, the plain search "
                      f"{combos[want[0]]} {grid[want[1]]:.2f}; plain loss "
                      f"{gap:.2e} relative above the plain minimum",
                      flush=True)
                check(gap <= 1e-5, f"{key} layer {l}: the kernel's choice "
                                   f"loses {gap:.2e} to the plain search's")
    return dict(agree=agree, total=len(sites) * n_layers,
                plain_evals=plain_evals, worst=worst)


def packed_checkpoint_path(dev, kernels, model, qparams, reqs, results):
    """launch/quantize's save of the main path's packed tree, restored and
    served: the 8 requests' tokens must be the in-memory packed model's
    (``results``) bit for bit.  Returns launch counts."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch.quantize import save_packed
    from repro_torch.serve.engine import ServeEngine

    phase("main path: packed checkpoint (launch/quantize's save), restored, "
          "served")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_packed_")
    try:
        print(f"  under {disk_of(tmp)}", flush=True)
        t0 = time.perf_counter()
        path = save_packed(tmp, qparams)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "data.bin"))
        t0 = time.perf_counter()
        restored = ckpt.restore(tmp, 0, {"qparams": qparams},
                                device=dev)["qparams"]
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = same_trees(restored, qparams)
        print(f"  {nbytes / 1e9:.2f} GB written in {write_s:.2f} s, restored "
              f"in {read_s:.2f} s; bit for bit: {same}", flush=True)
        check(same, "the restored packed tree differs")
        eng = ServeEngine(model, restored, n_slots=4, max_len=1024,
                          device=dev)
        (out, _, _), counts = counted(
            kernels, lambda: timed_serve("serve of the restored packed tree",
                                         eng, reqs))
        same = [np.array_equal(out[r.rid], results[r.rid]) for r in reqs]
        print(f"  tokens equal to the in-memory packed model's bit for bit: "
              f"{sum(same)}/{len(reqs)} requests", flush=True)
        check(all(same), "the restored packed model serves other tokens")
        del eng, restored
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


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
    (its result, the counts read just after).  The counters are then put
    back as they were, so a path counted inside another leaves the outer
    path's counts alone."""
    outer = [k.launches for k in kernels]
    for kern in kernels:
        kern.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    for kern, n in zip(kernels, outer):
        kern.launches = n
    return out, counts


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
                                          search_alpha_plain)
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
        res = search_alpha_plain(w, a_stat, spec, DEFAULT_ALPHA_GRID,
                                 mean_sq=msq)
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


# prompt lengths of the fault run: multiples of the 16-token page, so a
# preempted request's registered full blocks cover its whole prompt and
# the resume recomputes only positions that decode steps wrote the first
# time (the bits of the fault-free run); 592 and 688 are chunked
FAULT_LENS = (16, 48, 96, 208, 304, 448, 592, 688)


def span_ms(events, steps):
    """Host ms per engine step of each step-span name in a trace, and the
    count of each page event."""
    total, pages = {}, {}
    for e in events:
        if e.get("cat") == "step" and e["ph"] == "X":
            total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] / 1e3
        elif e.get("cat") == "pages" and e["ph"] == "i":
            pages[e["name"]] = pages.get(e["name"], 0) + 1
    return {k: v / max(steps, 1) for k, v in sorted(total.items())}, pages


def check_trace(name, tracer):
    from repro_torch.obs import check_span_nesting, validate_trace
    obj = tracer.to_json()
    problems = validate_trace(obj) + check_span_nesting(obj["traceEvents"])
    print(f"  {name}: {len(obj['traceEvents'])} events ({tracer.dropped} "
          f"dropped); schema valid and spans nested: {not problems}",
          flush=True)
    check(not problems and tracer.dropped == 0,
          f"{name}: trace problems {problems[:3]}, {tracer.dropped} dropped")


def traffic_paths(dev, kernels, model, qparams, data, serve_s):
    """Open-loop traffic through the EDF scheduler (dense and paged), SLO
    admission with two tenants and quotas, injected faults on the paged
    engine, and a traced serve, each with the launch counters zeroed just
    before it and read just after.  Returns {path: launch counts}."""
    from repro_torch.launch.serve import DATA_VOCAB_CAP
    from repro_torch.obs import Tracer
    from repro_torch.serve import (FaultConfig, FaultInjector, Request,
                                   Scheduler, ServeEngine, SLOConfig,
                                   TrafficConfig, make_trace)

    counts = {}
    kw = dict(n_slots=4, max_len=1024, device=dev)
    closed_rps = len(PROMPT_LENS) / serve_s
    tkw = dict(n_requests=12, prompt_len_median=200, prompt_len_sigma=0.9,
               prompt_len_max=700, shared_prefix_frac=0.0,
               max_new_tokens=NEW_TOKENS, vocab_size=DATA_VOCAB_CAP, seed=0)

    def trace_at(rate):
        return make_trace(TrafficConfig(rate=rate, **tkw))

    phase(f"main path: open-loop traffic, 12 Poisson requests at 0.5 x the "
          f"closed-loop rate ({0.5 * closed_rps:.3f} requests/s), dense and "
          f"paged")
    base = trace_at(0.5 * closed_rps)
    lens = [len(r.prompt) for _, r in base]
    print(f"  prompt lengths {lens}; arrivals at "
          f"{[round(t, 2) for t, _ in base]} s", flush=True)
    check(min(lens) >= 12 and max(lens) <= 700, "prompt lengths off range")
    eng_d = ServeEngine(model, qparams, **kw)
    closed, _, _ = timed_serve("closed-loop serve, the 12 requests", eng_d,
                               [r for _, r in base])

    def traffic_report(name, res):
        t = res.traffic
        print(f"  {name}: {res.summary['tokens_generated']} tokens, "
              f"{t['tokens_per_s']:.1f} tok/s over {t['duration_s']:.2f} s; "
              f"outcomes {t['outcomes']}; TTFT ms p50/p95/p99 "
              f"{t['ttft_ms']['p50']:.1f}/{t['ttft_ms']['p95']:.1f}/"
              f"{t['ttft_ms']['p99']:.1f}; queue delay ms "
              f"{t['queue_delay_ms']['p50']:.1f}/"
              f"{t['queue_delay_ms']['p95']:.1f}/"
              f"{t['queue_delay_ms']['p99']:.1f}; per-token ms "
              f"{t['per_token_ms']['p50']:.1f}/"
              f"{t['per_token_ms']['p95']:.1f}/"
              f"{t['per_token_ms']['p99']:.1f}", flush=True)

    for paged in (False, True):
        name = f"open-loop {'paged' if paged else 'dense'}"
        eng = (ServeEngine(model, qparams, paged=True, page_size=16, **kw)
               if paged else eng_d)
        res, counts[name] = counted(
            kernels, lambda: Scheduler(eng).run_traffic(
                trace_at(0.5 * closed_rps)))
        traffic_report(name, res)
        check(res.summary["completed"] == 12, f"{name}: not all completed")
        same = [np.array_equal(res[r.rid], closed[r.rid]) for _, r in base]
        print(f"  {name}: tokens equal the closed-loop dense serve's bit for "
              f"bit: {sum(same)}/12", flush=True)
        check(all(same), f"{name}: tokens differ from the closed-loop serve")
        del eng

    # deadlines in units of the closed-loop serve time: tenant a's loose,
    # tenant b's a fraction of one request's time in a slot (b's requests
    # cannot complete: 32 tokens take ~1.5 s).  In-flight token quotas keep
    # a slot free most of the time, so a waiting request is checked at
    # every step; a's behind its chunked prompts wait on the quota, which
    # drives the queue-delay estimate (p90 of the waits) up, and b's that
    # arrive then are shed (and retried) because the estimate says their
    # deadline cannot be met.  At serve_s / 16 (0.9 s) one run admitted
    # every b request before the estimate reached it (6 truncated, no
    # shed), so b's deadline is serve_s / 64: the gate bites once the
    # estimate passes ~0.2 s
    rel = {"a": 20 * serve_s, "b": serve_s / 64}
    quotas = {"a": 1000, "b": 740}
    phase(f"main path: SLO admission at 2 x that rate, tenants a (deadline "
          f"{rel['a']:.2f} s, quota {quotas['a']} tokens in flight) and b "
          f"(deadline {rel['b']:.2f} s, quota {quotas['b']})")
    eng_slo = ServeEngine(model, qparams,
                          slo=SLOConfig(seed=0, quotas=quotas), **kw)
    trace = trace_at(2 * closed_rps)
    for i, (_, r) in enumerate(trace):
        r.tenant = "ab"[i % 2]
        r.rel_deadline = rel[r.tenant]
    res, counts["SLO open-loop"] = counted(
        kernels, lambda: Scheduler(eng_slo).run_traffic(trace))
    traffic_report("SLO open-loop", res)
    s = res.summary
    terminal = s["completed"] + s["expired"] + s["truncated"] + s["shed"]
    print(f"  completed {s['completed']} + expired {s['expired']} + "
          f"truncated {s['truncated']} + shed {s['shed']} = {terminal} of "
          f"{s['requests']}; shed_retried {s['shed_retried']}; queue-delay "
          f"estimate {eng_slo.slo.estimate():.3f} s", flush=True)
    check(terminal == s["requests"] == 12, "SLO run: outcomes do not sum")
    check(s["shed_retried"] >= 1, "SLO run: no shed was retried")
    done = [r.rid for _, r in trace if r.outcome == "completed"]
    check(all(np.array_equal(res[rid], closed[rid]) for rid in done),
          "SLO run: a completed request's tokens differ from closed loop")
    print(f"  completed requests equal their closed-loop tokens: "
          f"{len(done)}/{len(done)}", flush=True)
    del eng_slo

    phase("main path: injected faults on the paged engine (page "
          "allocations vetoed, a forced preemption, a stall), 8 requests")
    fault_reqs = [Request(rid=700 + i,
                          prompt=data.sequence(45_000_000 + i, n),
                          max_new_tokens=NEW_TOKENS)
                  for i, n in enumerate(FAULT_LENS)]
    ref, _, ref_s = timed_serve("fault-free paged serve",
                                ServeEngine(model, qparams, paged=True,
                                            page_size=16, **kw), fault_reqs)
    inj = FaultInjector(FaultConfig(alloc_fail_at=(3, 30, 90),
                                    preempt_at=(40,), stall_at=(20,),
                                    stall_s=0.05))
    eng_f = ServeEngine(model, qparams, paged=True, page_size=16, faults=inj,
                        tracer=Tracer(capacity=65536), **kw)
    (out, m_f, sec), counts["faulted paged serve"] = counted(
        kernels, lambda: timed_serve("faulted paged serve", eng_f,
                                     fault_reqs))
    f = eng_f.metrics()["faults"]
    print(f"  faults {f}; preempted {m_f['preempted']}, resumed "
          f"{m_f['resumed']}, pressure events {m_f['pressure_events']}, "
          f"{sec:.2f} s against {ref_s:.2f} s fault-free", flush=True)
    check(f["alloc_failures"] == 3 and f["forced_preempts"] == 1
          and f["stalls"] == 1, f"faults not all injected: {f}")
    check(m_f["preempted"] >= 1 and m_f["resumed"] == m_f["preempted"],
          "faulted run: preemptions not all resumed")
    same = [np.array_equal(out[r.rid], ref[r.rid]) for r in fault_reqs]
    print(f"  survivors ({len(out)}/{len(fault_reqs)}, all completed) equal "
          f"the fault-free run bit for bit: {sum(same)}/{len(same)}",
          flush=True)
    check(all(same), "faulted run: survivors differ from the fault-free run")
    check_trace("faulted paged serve trace", eng_f.tracer)
    per_step, pages = span_ms(eng_f.tracer.events(), m_f["decode_steps"])
    print(f"  page events over the run: {pages}", flush=True)
    del eng_f

    phase("main path: the 12 requests closed loop without and with a tracer "
          "(two dense engines of one configuration, back to back)")
    _, _, plain_s = timed_serve("untraced serve", eng_d,
                                [r for _, r in base])
    tracer = Tracer(capacity=65536)
    eng_t = ServeEngine(model, qparams, tracer=tracer, **kw)
    (traced, m_t, traced_s), counts["traced serve"] = counted(
        kernels, lambda: timed_serve("traced serve", eng_t,
                                     [r for _, r in base]))
    check(all(np.array_equal(traced[r.rid], closed[r.rid])
              for _, r in base), "traced serve: tokens differ")
    check_trace("traced serve trace", tracer)
    tokens = m_t["tokens_generated"]
    print(f"  serve tok/s without / with the tracer: "
          f"{tokens / plain_s:.2f} / {tokens / traced_s:.2f}", flush=True)
    per_step, _ = span_ms(tracer.events(), m_t["decode_steps"])
    print(f"  host ms per decode step by span ({m_t['decode_steps']} decode "
          f"steps): " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in per_step.items()), flush=True)
    del eng_t, eng_d
    torch.cuda.empty_cache()
    return counts


def profile_phase(eng, data, Request):
    """Where a serving step's time goes: torch.profiler (through the
    port's ``profile_session``, its Chrome trace written under the
    git-ignored build directory) over one short serve (4 requests of 12
    tokens: one bucketed prefill + 8 decode steps at 4 slots), device time
    by kernel against the wall time."""
    from repro_torch.obs import profile_session

    reqs = [Request(rid=300 + i, prompt=data.sequence(41_000_000 + i, 12),
                    max_new_tokens=9) for i in range(4)]
    eng.serve(reqs)                                   # warm
    torch.cuda.synchronize()
    logdir = Path(__file__).resolve().parent / "src" / "repro_torch" \
        / "build" / "profile"
    with profile_session(logdir) as prof:
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
               "rms_norm": rn.KERNEL, "flash_attention_bwd": fa.KERNEL_BWD,
               "rms_norm_bwd": rn.KERNEL_BWD}
    kernels = tuple(by_name.values())
    rows = {r["name"]: r for r in kernel_phase(dev)}
    check(sorted(rows) == sorted(by_name), f"kernel rows {sorted(rows)}")
    rows = [rows[name] for name in by_name]
    phase("reference: tiny model, card against CPU")
    reference_phase(dev)
    phase("main path: train llama3-8b width on the card")
    train_counts = train_paths(dev, kernels)
    phase("main path: llama3-8b calibrate -> FAQ -> int4 pack -> serve")
    launches, row_keys = main_path_phase(dev, kernels)
    for path, counts in train_counts.items():
        print(f"  launches on the {path} path: {counts}", flush=True)
        for sym, n in counts.items():
            launches[sym] += n
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
