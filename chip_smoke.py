#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device   — the card, its power limit, torch and CUDA versions;
2. build    — ``nvcc`` builds every kernel in ``src/repro_torch/csrc``
              (one process per source, all started together);
3. kernels  — each of the seven ported kernels, quant_matmul_experts'
              grouped launch (E 64 at C 1 and 683, each expert's rows bit
              for bit against its single launch, timed beside 64 single
              launches), the four verify (T-query)
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
              rms_norm at 4, 16, 2048 and 8192 rows of 4096 beside
              ``torch.nn.functional.rms_norm`` (its block and warp
              routes); flash_attention also with
              a key length per row, 4 prompts of 300..450 tokens padded to
              512, each prompt's rows bit for bit against the prompt alone
              at its exact length, timed beside a masked
              scaled_dot_product_attention); the two backward kernels
              (flash_attention at q (32, 4, 512, 128), bf16 on the tensor
              cores and f32 on the CUDA cores, and bf16 at the
              reference's training length q (8, 4, 4096, 128), each
              beside the backward of scaled_dot_product_attention;
              rms_norm at (2048, 4096) beside ``F.rms_norm``'s), each
              against its plain version (at T 4096 against SDPA) and bit
              for bit on a second run; the build phase fails on a
              register spill in the redesigned backward kernels and in
              rms_norm's warp route;
4. reference — a tiny llama3-8b on the card (kernels) against the same
              model on the CPU (plain versions): logits and greedy tokens;
              the card's forward twice (bit for bit) and both beside an
              f64 CPU forward of the same weights, so that a failure
              names the side that moved;
   train    — llama3-8b at full width cut to 2 layers: step 1's gradients
              (every leaf non-zero, held per leaf against the plain
              versions' step), 20 AdamW steps of 4 x 512 tokens, a
              save_async of {params, opt} after step 10 restored bit for
              bit and resumed to the same loss bits (the first resumed
              step under torch.profiler: device busy share and the top
              device operations of a train step; the step's TFLOP/s from
              the dry-run's model_flops), and the trained
              params' checkpoint served through launch/serve.py's restore
              with the in-memory params' tokens;
   families — qwen2-vl-2b, hymba-1.5b, xlstm-350m, whisper-small and
              qwen2-moe-a2.7b trained at full width on one device (2
              layers; xlstm 4, whisper 2 + 2; 4 rows of 256 or 512
              tokens, the VLM's 256 patches and whisper's 1536 frames
              beside them; seed-0 bf16 weights, xlstm's in f32): step
              1's gradients against the plain versions' (MoE on the same
              expert choices; xlstm to f32 summation order), 2 steps after
              which the loss has fallen, each family's kernels launched;
              the kernel routes (flash_attention_bwd at G 6 and G 1, hd
              128 / 64, causal or not; rms_norm at d 1536 / 1600 / 1024 /
              2048) held and timed in phase 3;
   mesh     — the same 2 layers trained on a (data, model) mesh of 2
              ranks that share the card over gloo, at (1, 2) (tensor
              parallel) and (2, 1) (FSDP + data parallel), and on the
              (pod, data, model) mesh (2, 1, 1), 3 steps each on the train
              phase's batches: step 1's loss, grad_norm and gathered
              gradients against the single-device step's, the losses
              against its losses, collectives per step against the tests'
              formula, each rank's state bytes against the dry-run's
              prediction, (2, 1, 1) bit for bit with (2, 1), a one-writer
              mesh save read back bit for bit; the two backward routes (flash_attention_bwd on one
              rank's 4 of 8 KV heads, rms_norm_bwd on a data rank's 1024
              rows) are held and timed in phase 3; then, in the same
              spawn, each family at (1, 2) and (2, 1) (MoE (1, 2); xlstm
              in f32) for 2 steps against its one-device run: step 1's
              gathered gradients, the losses and grad_norms, the
              collectives per step against the model's
              train_collectives, GiB per rank and each step's seconds;
5. main path — llama3-8b at full width (d_model 4096, 32 heads, 8 KV
              heads, d_ff 14336, vocab 128256), ``LAYERS`` of its 32
              layers (the depth the time limit leaves), random
              bf16 weights from a seed: calibrate on 16 x 512 tokens (the
              flash-attention path), FAQ alpha search, int4 pack (g = 64),
              then a 4-slot engine serves 8 greedy requests of 12..700
              prompt tokens (bucketed and chunked prefill) for 32 tokens
              each; between FAQ and serving, full_search_faq (paper Eq.
              8) over the layers' 7 sites through quant_error, its
              choices held against the plain search's.  After serving,
              the packed tree is saved by launch/quantize, restored, and
              must serve the same tokens bit for bit.  Then tensor
              parallelism (``tp_paths``): 2 ranks sharing the card over
              gloo (NCCL refuses two ranks on one device; gloo stages
              CUDA tensors through the host) restore that save, cut their
              shards (16 / 4 heads, column / row shards, vocab halves)
              and serve the first 4 of the 8 requests on 2 slots (each
              slot admitted twice) dense and paged, with the bf16 and
              the int8 KV cache: every request's tokens equal to
              single-device on 2 slots or parting first at a tie
              (single-device teacher-forced top-2 gap <= ``TIE_TOL``);
              one logits all_gather per engine step, activation-sized
              all_reduces, no all_to_all; MoE expert parallelism on
              qwen2-moe's 2-layer cut (capacity factor 16) against the
              local path; a 1 x 1 NCCL mesh against ``mesh=None`` bit
              for bit; an open-loop run of the 4 requests through the
              paged engine with ``slo=`` and the fault schedule of the
              faults run below (both ranks must report the same outcomes,
              counters and fault counts; every request == the fault-free
              single-device tokens or parting at a tie).  Its tok/s is 2
              ranks on one card, not a TP
              speed; its routes are the ``*_tp2`` / ``*_ep2`` rows of
              phase 3, whose launches are rank 0's.  Request 0 is
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
              engine: the first 8 of 12 Poisson requests (12..700-token
              prompts) through ``Scheduler.run_traffic`` at half the
              closed-loop rate, dense and paged, equal to a closed-loop
              serve bit for bit, with TTFT, queue-delay and per-token
              percentiles; the 12-request trace at twice the rate under
              SLO admission (two tenants, quotas,
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
              operations per engine step, and the top kernels;
7. MoE      — qwen2-moe-a2.7b at full width: a 2-layer cut's logits
              against the plain versions (each layer's routes replayed:
              a bf16 router near a tie flips on another rounding), then
              all 24 layers: calibrate on 16 x 512 tokens, FAQ per
              (layer, expert), int4 pack, the FAQ int8 self-draft, one
              slot serving 4 requests plain and speculative (k 3), bit
              for bit, four slots serving the 8 requests of the dense run,
              and ``paged=True`` serving from the dense cache.  Its
              launches are counted path by path like the others;
8. families — qwen2-vl-2b and hymba-1.5b at full width and half depth
              (``FAMILY_SERVE_DEPTH``)
              (``families_paths``): calibrate, FAQ, pack, 4-slot serving
              == batch-1 ``generate``, patches, a wrapped ring;
9. ssm/audio — xlstm-350m and whisper-small at full width and half depth
              (``ssm_audio_paths``): calibrate (16 x 512 tokens; 16 x
              (1536 seed-made frames + 256 tokens)), FAQ, pack, layer 0's
              alpha search through quant_error against the plain search;
              xlstm's 8 requests at 4 slots == ``generate`` bit for bit
              (``spec=`` and ``paged=True`` declined, same tokens) and one
              request's prefill + 32 decode steps against a teacher-forced
              forward (greedy up to ties with f32 activations; in bf16
              the prefill's token greedy, and the decode's rounding noise
              against the f32 run within XLSTM_BF16_NOISE_RATIO of the
              bf16 forward's);
              whisper's 4 requests prefilled with their frames
              and decoded 32 steps, each against a teacher-forced forward.
              Their kernel routes (flash_attention not causal at G 1 / hd
              64, flash_decode at G 1 over the self and the 1536-key cross
              cache, quant_matmul at the seven new widths) are held and
              timed in phase 3; each route row's launches are those of
              its own route (the wrappers count launches by route).
              Each of the four packed trees is saved as its phase ends;
10. families TP — (``family_tp_paths``) 2 ranks sharing the card over
              gloo restore the four trees in one spawn: qwen2-vl-2b,
              hymba-1.5b (attention whole on each rank: 25 / 5 heads do
              not divide 2; MLP and Mamba cut) and xlstm-350m (2 of 4
              mLSTM heads a rank) serve the dense run's first 4 requests
              on 2 slots with ``ServeEngine(mesh=)``; whisper-small's
              4 x 100-token prefill(frames=) over 1536 frames + 31
              decode steps run on an engine's shards under its mesh.
              Every request == single-device or parting first at a tie
              (the single-device top-2 gap there <= ``TIE_TOL``), both
              ranks agree, and each engine step runs one logits
              all_gather and the model's ``tp_all_reduces``
              all_reduces (qwen2-vl 57, hymba 97, xlstm 19; whisper 37 a
              decode step, 61 in its prefill).  Its
              routes are the ``*_families_*`` / ``*_vlm_tp2`` /
              ``*_whisper_tp2`` / ``*_cross_tp2`` rows of phase 3.
   The tensor-parallel routes (phase 3, after the families'): each
              rank's column and row shards of quant_matmul, decode and
              prefill attention on its 16 / 4 heads (all four decode
              variants), quant_matmul_experts on its 32 experts over both
              ranks' rows; for the families, quant_matmul on their column
              shards (two-part projections among them) and row shards,
              flash_attention at G 6 on 1 of 2 KV heads and not causal on
              6 of whisper's 12 heads, flash_decode at H 6 / KH 1 and over
              whisper's cross cache on 6 heads; each held against the
              plain versions and bit for bit against its part of the
              single-device launch.

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
# llama3-8b's main path: 10 of its 32 layers (cut so that the script, with
# every family, their tensor-parallel phase and their training, stays
# ~100 s inside its time limit on a slow host; every layer has the same
# shapes).  24 layers read 1,094.5 s of script before the families' TP
# phase; with it 14 layers read 1,007.2 s; with the families' training 12
# layers read 1,034.5 s on a fast host and 1,119.9 s on a host like the
# 14-layer call's (~18-20 s a layer), 10 layers 1,234.2 s on a slow host
# with the families' serving paths at full depth (FAMILY_SERVE_DEPTH)
LAYERS = 10
PROMPT_LENS = (12, 40, 100, 200, 300, 450, 600, 700)
NEW_TOKENS = 32
# bf16 logits of magnitude < 8 are spaced 2**-5 apart; a token within four
# such steps of the reference's top logit is a numerical tie, not an error
TIE_TOL = 4 * 2.0 ** -5
# the open-loop runs serve the first 8 requests of the 12-request trace
# (their arrivals span 20 of its 72 s; all 12 read 149-167 s of phase at
# 24 layers on an H100 80GB HBM3, 700 W); the SLO and tracer runs keep all
# 12
OPEN_LOOP_REQUESTS = 8
# limit on ||kernel - plain|| / ||plain|| for bf16 flash_attention and
# bf16 quant_matmul with rounded weights (groups not a multiple of 64 rows)
BF16_REL_TOL = 1e-2
# the same for bf16 quant_matmul at g % 64 == 0, which differs from the
# plain version by f32 summation order only (readings up to 6.6e-5 on the
# H100); rounding every weight to bf16 reads 2.4e-3 and more
EXACT_REL_TOL = 5e-4
# kernels whose every instantiation must compile without a register spill
NO_SPILL = ("fa_bwd_dkdv_tc", "fa_bwd_dq_tc", "fa_bwd_prep",
            "rms_norm_bwd_rows", "rms_norm_dw", "rms_norm_warp_rows")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


_PHASE = []     # [name, start] of the phase that is running


def phase(name=None):
    """Close the running phase (print its wall seconds on a line of its
    own) and, given a name, start the next one."""
    if _PHASE:
        print(f"  -- phase seconds: {time.perf_counter() - _PHASE[1]:.2f} "
              f"({_PHASE[0]})", flush=True)
        _PHASE.clear()
    if name is not None:
        print(f"== {name}", flush=True)
        _PHASE.extend([name, time.perf_counter()])


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
    rows.append(quant_matmul_experts_row(dev, gen, randn))
    rows.append(rms_norm_row(dev, gen, randn))
    rows.append(flash_attention_bwd_row(dev, gen, randn))
    rows.append(rms_norm_bwd_row(dev, gen, randn))
    rows += family_route_rows(dev, gen, randn)
    rows += ssm_audio_route_rows(dev, gen, randn)
    rows += tp_route_rows(dev, gen, randn)
    rows += family_tp_route_rows(dev, gen, randn)
    rows += mesh_train_route_rows(dev, gen, randn)
    rows += family_train_route_rows(dev, gen, randn)
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


# the families' new routes through the dense kernels (qwen2-vl-2b: 12/2
# heads of 128; hymba-1.5b: 25/5 heads of 64 over a ring of 1024 slots)
VLM_CAL_BATCH, VLM_PATCHES, VLM_TOKENS = 16, 256, 256
RING = 1024
RING_LENS = (1024, 1024, 332, 44)   # two slots wrapped: valid = min(len, W)


def _sdpa_decode(q, kc, vc, cl):
    """One masked scaled_dot_product_attention over a (B, KH, S, hd) cache
    at lengths ``cl``, GQA: the library call for a decode step."""
    keep = torch.arange(kc.shape[2], device=kc.device)[None, :] < cl[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kc, vc, attn_mask=keep[:, None, None, :],
        enable_gqa=True).transpose(1, 2)


# ---------------------------------------------------------------------------
# Phase 3: the sharded routes of tensor-parallel serving
# ---------------------------------------------------------------------------

TP_RANKS = 2
# (k, n) of one rank's column shards at model 2 (wq, wk / wv, gate / up)
# and row shards (wo, down)
TP_COLUMN = ((4096, 2048), (4096, 512), (4096, 7168))
TP_ROW = ((2048, 4096), (7168, 4096))
TP_HEADS = (16, 4)                 # llama3-8b's 32 / 8 heads over 2 ranks
MOE_EP_CAP = 5                     # capacity of 4 decode tokens at factor 16


def _shard_rows(name, kernel_fn, plain_fn, whole, local_args, cut, **tols):
    """Hold each rank's launch on its shard against the plain version and,
    bit for bit, against its part of the single-device launch
    (``cut(whole, r)``); returns the largest error."""
    err = 0.0
    for r in range(TP_RANKS):
        args = local_args(r)
        got = kernel_fn(*args)
        err = max(err, held(f"{name} rank {r}", got, plain_fn(*args), **tols))
        same_bits(f"{name} rank {r}: == its part of the single-device launch",
                  got, cut(whole, r))
    return err


def tp_route_rows(dev, gen, randn):
    """The routes a rank of tensor-parallel serving launches at model 2
    (llama3-8b's local heads and column / row shards; qwen2-moe's 32 local
    experts over 2 ranks' rows): each held against its plain version and,
    bit for bit, against its part of the single-device launch (a row
    shard's two partial products, summed, against the whole product), then
    timed beside the plain version and, where one computes the same
    function, a library call."""
    from repro_torch.core import QuantSpec, quantize_groupwise
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ops import quant_matmul_experts
    from repro_torch.kernels.ref import quant_matmul_experts_ref

    phase("kernel routes of tensor-parallel serving (model 2: column / row "
          "shards, local heads, 32 local experts)")
    g, m, rows = 64, 4, []

    def packed(k, n):
        qt = quantize_groupwise(randn(k, n, dtype=torch.float32),
                                QuantSpec(4, g), pack=True)
        return qt.codes, qt.scale, qt.zero

    def qmm_bytes(mm, kk, nn):
        return (mm * kk * 2 + kk * nn // 2 + 2 * (kk // g) * nn * 4
                + mm * nn * 2)

    def cols(t, r, n):
        return t[:, r * n:(r + 1) * n].contiguous()

    timed = {}
    for k, n in TP_COLUMN:
        whole_c, x = packed(k, TP_RANKS * n), randn(m, k)
        err = _shard_rows(
            f"quant_matmul column shard m={m} {k}->{n} of {TP_RANKS * n}",
            qm.quant_matmul, qm.quant_matmul_ref,
            qm.quant_matmul(x, *whole_c),
            lambda r: (x, *(cols(t, r, n) for t in whole_c)),
            lambda w, r: w[:, r * n:(r + 1) * n], rel_tol=EXACT_REL_TOL)
        timed[("column", k, n)] = err
    for k, n in TP_ROW:
        (codes, scale, zero), x = packed(TP_RANKS * k, n), randn(
            m, TP_RANKS * k)
        parts, err = [], 0.0
        for r in range(TP_RANKS):
            args = (x[:, r * k:(r + 1) * k].contiguous(),
                    codes[r * k // 2:(r + 1) * k // 2].contiguous(),
                    scale[r * k // g:(r + 1) * k // g].contiguous(),
                    zero[r * k // g:(r + 1) * k // g].contiguous())
            got = qm.quant_matmul(*args)
            err = max(err, held(f"quant_matmul row shard rank {r} m={m} "
                                f"{k}->{n} of {TP_RANKS * k}", got,
                                qm.quant_matmul_ref(*args),
                                rel_tol=EXACT_REL_TOL))
            parts.append(got.float())
        # the two bf16 partial products summed (what the all_reduce adds)
        # against the single-device product: two roundings instead of one
        held(f"quant_matmul row shards summed {TP_RANKS * k}->{n}",
             (parts[0] + parts[1]).to(torch.bfloat16),
             qm.quant_matmul_ref(x, codes, scale, zero),
             rel_tol=BF16_REL_TOL)
        timed[("row", k, n)] = err
    for kind, (k, n) in (("column", TP_COLUMN[-1]), ("row", TP_ROW[-1])):
        sets = [packed(k, n) for _ in range(4)]
        x = randn(m, k)
        ms = time_ms(lambda i: qm.quant_matmul(x, *sets[i % 4]))
        plain = time_ms(lambda i: qm.quant_matmul_ref(x, *sets[i % 4]),
                        reps=5)
        b_ms, b_by = bound(qmm_bytes(m, k, n), 2 * m * k * n)
        shapes = TP_COLUMN if kind == "column" else TP_ROW
        rows.append(dict(
            name=f"quant_matmul_tp2_{kind}", route="cuda",
            source="src/repro_torch/csrc/quant_matmul.cu",
            replaces="src/repro/kernels/quant_matmul.py:56",
            shape=f"x ({m},{k}) bf16, codes ({k // 2},{n}), g={g}; one "
                  f"rank's {kind} shards at model 2: "
                  + ", ".join(f"{kk}->{nn}" for kk, nn in shapes),
            max_abs_err=max(v for (kd, *_), v in timed.items() if kd == kind),
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            library_note="none: no single PyTorch call takes this int4 "
                         "layout"))
        del sets

    # decode attention on a rank's 16 query / 4 KV heads
    h, kh = TP_HEADS
    b, s, hd, ps = 4, 1024, 128, 16
    lens = [44, 140, 332, 732]
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    qw = randn(b, 1, TP_RANKS * h, hd)
    kw, vw = (randn(b, TP_RANKS * kh, s, hd) for _ in range(2))
    perm, table = paged_table(lens, s, ps, gen, dev)

    def heads(r):
        q = qw[:, :, r * h:(r + 1) * h].contiguous()
        k = kw[:, r * kh:(r + 1) * kh].contiguous()
        v = vw[:, r * kh:(r + 1) * kh].contiguous()
        return q, k, v

    def q_heads(w, r):
        return w[:, :, r * h:(r + 1) * h]

    kc8, vc8 = q8_cache(kw), q8_cache(vw)

    def dense_args(r):
        q, k, v = heads(r)
        return q, k, v, cl

    def q8_args(r):
        q = heads(r)[0]
        return (q, *(t[:, r * kh:(r + 1) * kh].contiguous()
                     for t in (*kc8, *vc8)), cl)

    def paged_args(r):
        q, k, v = heads(r)
        return (q, paged_store(k, ps, perm), paged_store(v, ps, perm), table,
                cl)

    def paged_q8_args(r):
        q = heads(r)[0]
        return (q, *(paged_store(t[:, r * kh:(r + 1) * kh].contiguous(), ps,
                                 perm) for t in (*kc8, *vc8)), table, cl)

    pw = [paged_store(t, ps, perm) for t in (kw, vw)]
    pw8 = [paged_store(t, ps, perm) for t in (*kc8, *vc8)]
    variants = [
        ("flash_decode_tp2", "src/repro/kernels/flash_decode.py:216",
         fd.flash_decode, fd.decode_attention_ref, dense_args,
         fd.flash_decode(qw, kw, vw, cl), 2),
        ("flash_decode_q8_tp2", "src/repro/kernels/flash_decode.py:250",
         fd.flash_decode_q8, fd.decode_attention_q8_ref, q8_args,
         fd.flash_decode_q8(qw, *kc8, *vc8, cl), 1),
        ("flash_decode_paged_tp2", "src/repro/kernels/flash_decode.py:286",
         fd.flash_decode_paged, fd.paged_decode_attention_ref, paged_args,
         fd.flash_decode_paged(qw, *pw, table, cl), 2),
        ("flash_decode_paged_q8_tp2", "src/repro/kernels/flash_decode.py:323",
         fd.flash_decode_paged_q8, fd.paged_decode_attention_q8_ref,
         paged_q8_args, fd.flash_decode_paged_q8(qw, *pw8[:2], *pw8[2:],
                                                 table, cl), 1)]
    live = sum(lens)
    keep = (torch.arange(s, device=dev)[None, :] < cl[:, None])[:, None,
                                                                None, :]
    for name, replaces, kern, plain_fn, args_of, whole, elem in variants:
        err = _shard_rows(f"{name} B={b} H={h} KH={kh} lens={lens}", kern,
                          plain_fn, whole, args_of, q_heads)
        args = args_of(0)
        ms = time_ms(lambda i: kern(*args))
        plain = time_ms(lambda i: plain_fn(*args), reps=5)
        # K and V rows read once (int8 codes + an f32 scale per row), q
        # read and out written once, lengths (and the page table)
        kv_row = hd * elem + (4 if elem == 1 else 0)
        nbytes = (2 * b * h * hd * 2 + b * 4 + live * kh * kv_row * 2
                  + (table.numel() * 4 if "paged" in name else 0))
        b_ms, b_by = bound(nbytes, 4 * live * h * hd)
        lib = None
        if name == "flash_decode_tp2":
            q, k, v, _ = args

            def sdpa(i):
                return torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=keep, enable_gqa=True)

            held(f"{name}: library call (sdpa)", sdpa(0).transpose(1, 2),
                 plain_fn(*args))
            lib = time_ms(sdpa)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_decode.cu", replaces=replaces,
            shape=f"q ({b},1,{h},{hd}) bf16, one rank's {kh} of "
                  f"{TP_RANKS * kh} KV heads, S {s}, lens {lens}"
                  + (f", pages of {ps}" if "paged" in name else ""),
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib,
            **({} if lib is not None else {
                "library_note": "none: no PyTorch attention call reads "
                                "int8 codes or a page table"})))

    # prefill attention on a rank's KV heads: 4 slots x 4 KV heads, G 4
    bkh, gq, t = b * kh, h // kh, 512
    qf = randn(b * TP_RANKS * kh, gq, t, hd)
    kf, vf = (randn(b * TP_RANKS * kh, t, hd) for _ in range(2))
    whole = fa.flash_attention(qf, kf, vf, causal=True)

    def kv_heads(w, r):
        return w.reshape(b, TP_RANKS * kh, *w.shape[1:])[
            :, r * kh:(r + 1) * kh].reshape(bkh, *w.shape[1:])

    err = _shard_rows(f"flash_attention BKH={bkh} G={gq} T={t} causal",
                      lambda *a: fa.flash_attention(*a, causal=True),
                      lambda *a: fa.flash_attention_ref(*a, causal=True),
                      whole, lambda r: tuple(kv_heads(w, r).contiguous()
                                             for w in (qf, kf, vf)),
                      kv_heads, rel_tol=BF16_REL_TOL)
    q, k, v = (kv_heads(w, 0).contiguous() for w in (qf, kf, vf))
    ms = time_ms(lambda i: fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda i: fa.flash_attention_ref(q, k, v, causal=True),
                    reps=5)

    def sdpa_causal(i):
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(b, kh * gq, t, hd), k.reshape(b, kh, t, hd),
            v.reshape(b, kh, t, hd), is_causal=True, enable_gqa=True)

    held("flash_attention_tp2: library call (sdpa)",
         sdpa_causal(0).reshape(bkh, gq, t, hd),
         fa.flash_attention_ref(q, k, v, causal=True))
    lib = time_ms(sdpa_causal)
    b_ms, b_by = bound((2 * bkh * gq * t * hd + 2 * bkh * t * hd) * 2,
                       4 * bkh * gq * hd * t * (t + 1) / 2)
    rows.append(dict(name="flash_attention_tp2", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:92",
                     shape=f"q ({bkh},{gq},{t},{hd}) bf16: 4 slots x one "
                           f"rank's {kh} of {TP_RANKS * kh} KV heads, causal",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    del qf, kf, vf, whole, q, k, v

    # expert parallelism: a rank's 32 experts over both ranks' rows (at
    # decode every rank routes the same 4 tokens: capacity 5 rows each)
    e, c, k, n = MOE_EXPERTS, MOE_EP_CAP, 2048, 1408
    el = e // TP_RANKS
    qt = quantize_groupwise(randn(e, k, n, dtype=torch.float32) / k ** 0.5,
                            QuantSpec(4, g), pack=True,
                            act_scale=torch.rand((e, k), generator=gen,
                                                 device=dev) + 0.5)
    xw = randn(e, c, k) / 4
    whole = quant_matmul_experts(xw, qt)

    def ep_args(r):
        sl = slice(r * el, (r + 1) * el)
        x = torch.cat([xw[sl]] * TP_RANKS, dim=1)
        return x, qt[sl]

    def ep_cut(w, r):
        return torch.cat([w[r * el:(r + 1) * el]] * TP_RANKS, dim=1)

    err = _shard_rows(f"quant_matmul_experts E={el} rows "
                      f"{TP_RANKS}x{c} {k}->{n}", quant_matmul_experts,
                      quant_matmul_experts_ref, whole, ep_args, ep_cut,
                      rel_tol=EXACT_REL_TOL)
    x, q_loc = ep_args(0)
    ms = time_ms(lambda i: quant_matmul_experts(x, q_loc))
    plain = time_ms(lambda i: quant_matmul_experts_ref(x, q_loc), reps=5,
                    inner=2)
    cr = TP_RANKS * c
    b_ms, b_by = bound(el * (cr * k * 2 + k * n // 2 + 2 * (k // g) * n * 4
                             + cr * n * 2 + k * 4), 2 * el * cr * k * n)
    rows.append(dict(name="quant_matmul_experts_ep2", route="cuda",
                     source="src/repro_torch/csrc/quant_matmul.cu",
                     replaces="src/repro/kernels/ops.py:78",
                     shape=f"x ({el},{cr},{k}) bf16: one rank's {el} of {e} "
                           f"experts, {TP_RANKS} ranks x capacity {c} rows, "
                           f"codes ({el},{k // 2},{n}), g={g}",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     library_note="none: no single PyTorch call takes this "
                                  "int4 layout"))
    return rows


# one rank's shards of the vlm / hybrid / ssm / audio families at model 2:
# (k, n) of the column shards -- Mamba in_proj (its u and z halves'
# blocks), mLSTM wq / wk / wv, whisper w1 -- and of the row shards: whisper
# w2 (bf16 partials, as the dense family's), and hymba's Mamba x_proj and
# out_proj and its w_down, whose partials are the tensor-core route's f32
# sums before their rounding (quant_matmul's out_dtype float32), summed in
# f32 and rounded once (models.common.row_parallel_f32).  The whole
# product of a column shard has TP_RANKS x n columns (in_proj: 2 x 2
# blocks)
FAMILY_TP_COLUMN = ((1600, 3200), (2048, 1024), (768, 1536))
FAMILY_TP_ROW = ((1536, 768),)
FAMILY_TP_ROW_F32 = ((1600, 132), (1600, 1600), (2752, 1600))
# the shapes the launch counts take, per family run of the TP phase and
# row: the bf16 ones no whole product there shares (quant_matmul's route
# "k.. n.."), and hymba's f32-output row shards (route "f32out k.. n..")
FAMILY_TP_COUNTED = {
    "qwen2-vl-2b": {"column": ((1536, 768), (1536, 128), (1536, 4480)),
                    "row": ((768, 1536), (4480, 1536)), "row_f32": ()},
    "hymba-1.5b": {"column": ((1600, 3200), (1600, 2752)), "row": (),
                   "row_f32": FAMILY_TP_ROW_F32},
    "xlstm-350m": {"column": ((2048, 1024),), "row": (), "row_f32": ()},
    "whisper-small": {"column": ((768, 1536), (768, 384)),
                      "row": ((1536, 768), (384, 768)), "row_f32": ()}}


def family_tp_route_rows(dev, gen, randn):
    """The routes a rank of the families' tensor-parallel serving launches
    at model 2 (:func:`family_tp_paths`): quant_matmul on the new column
    shards (each == its columns of the whole product, bit for bit; Mamba
    in_proj's columns are its two halves' blocks), on the bf16 row shards
    (the two partial products, summed, against the whole product) and on
    hymba's row shards with f32 output (each f32 partial against the
    plain version and, rounded, bit for bit the bf16 launch; their f32
    sum, rounded once, against the single-device bf16 product);
    flash_attention at qwen2-vl's G 6 on 1 of 2 KV heads
    and not causal on whisper's 6 of 12 heads at T 1536; flash_decode at
    qwen2-vl's H 6 / KH 1 and over whisper's cross cache on 6 heads, each
    bit for bit with its heads of the whole launch; timed beside the plain
    version and SDPA."""
    from repro_torch.core import QuantSpec, quantize_groupwise
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm

    phase("kernel routes of the families' tensor-parallel serving (model 2: "
          "two-part column shards, bf16 and f32-output row shards, G 6 on 1 "
          "KV head, 6 of 12 whisper heads)")
    g, m, rows = 64, 4, []

    def packed(k, n):
        qt = quantize_groupwise(randn(k, n, dtype=torch.float32),
                                QuantSpec(4, g), pack=True)
        return qt.codes, qt.scale, qt.zero

    def column_ids(k, n, r):
        """The whole product's columns that rank r's shard of width n
        holds, and the whole width."""
        if (k, n) == (1600, 3200):          # in_proj: u and z blocks
            half = n // 2
            return (list(range(r * half, (r + 1) * half))
                    + list(range(2 * half + r * half,
                                 2 * half + (r + 1) * half))), 4 * half
        return list(range(r * n, (r + 1) * n)), TP_RANKS * n

    def row_args(x, codes, scale, zero, k, r):
        return (x[:, r * k:(r + 1) * k].contiguous(),
                codes[r * k // 2:(r + 1) * k // 2].contiguous(),
                scale[r * k // g:(r + 1) * k // g].contiguous(),
                zero[r * k // g:(r + 1) * k // g].contiguous())

    errs = {"column": 0.0, "row": 0.0, "row_f32": 0.0}
    for k, n in FAMILY_TP_COLUMN:
        x = randn(m, k)
        ids, width = column_ids(k, n, 0)
        whole_c = packed(k, width)
        whole = qm.quant_matmul(x, *whole_c)
        for r in range(TP_RANKS):
            ids, _ = column_ids(k, n, r)
            sel = torch.tensor(ids, device=dev)
            args = (x, *(t[:, sel].contiguous() for t in whole_c))
            got = qm.quant_matmul(*args)
            errs["column"] = max(errs["column"], held(
                f"quant_matmul family column shard rank {r} m={m} {k}->{n} "
                f"of {width}", got, qm.quant_matmul_ref(*args),
                rel_tol=EXACT_REL_TOL))
            same_bits(f"quant_matmul family column shard rank {r} {k}->{n}: "
                      f"== its columns of the whole launch", got,
                      whole[:, sel])
    for k, n in FAMILY_TP_ROW:
        (codes, scale, zero), x = packed(TP_RANKS * k, n), randn(
            m, TP_RANKS * k)
        parts = []
        for r in range(TP_RANKS):
            args = row_args(x, codes, scale, zero, k, r)
            got = qm.quant_matmul(*args)
            errs["row"] = max(errs["row"], held(
                f"quant_matmul family row shard rank {r} m={m} {k}->{n} of "
                f"{TP_RANKS * k}", got, qm.quant_matmul_ref(*args),
                rel_tol=EXACT_REL_TOL))
            parts.append(got.float())
        held(f"quant_matmul family row shards summed {TP_RANKS * k}->{n}",
             (parts[0] + parts[1]).to(torch.bfloat16),
             qm.quant_matmul_ref(x, codes, scale, zero),
             rel_tol=BF16_REL_TOL)
    for k, n in FAMILY_TP_ROW_F32:
        (codes, scale, zero), x = packed(TP_RANKS * k, n), randn(
            m, TP_RANKS * k)
        total = 0
        for r in range(TP_RANKS):
            args = row_args(x, codes, scale, zero, k, r)
            got = qm.quant_matmul(*args, out_dtype=torch.float32)
            errs["row_f32"] = max(errs["row_f32"], held(
                f"quant_matmul family f32-output row shard rank {r} m={m} "
                f"{k}->{n} of {TP_RANKS * k}", got,
                qm.quant_matmul_ref(*args, out_dtype=torch.float32),
                rel_tol=EXACT_REL_TOL))
            same_bits(f"quant_matmul family f32-output row shard rank {r} "
                      f"{k}->{n}: rounded == the bf16 launch",
                      got.to(torch.bfloat16), qm.quant_matmul(*args))
            total = total + got
        held(f"quant_matmul family f32-output row shards summed "
             f"{TP_RANKS * k}->{n}", total,
             qm.quant_matmul_ref(x, codes, scale, zero,
                                 out_dtype=torch.float32),
             rel_tol=EXACT_REL_TOL)
        single = qm.quant_matmul(x, codes, scale, zero)
        rounded = total.to(torch.bfloat16)
        held(f"quant_matmul family f32 row shards summed and rounded once "
             f"{TP_RANKS * k}->{n}: the single-device bf16 product", rounded,
             single, rel_tol=EXACT_REL_TOL)
        print(f"  {TP_RANKS * k}->{n}: rounded f32 sum == the single-device "
              f"bf16 product in {float((rounded == single).float().mean()):.6f}"
              f" of its elements", flush=True)
    for kind, (k, n), shapes in (
            ("column", FAMILY_TP_COLUMN[0], FAMILY_TP_COLUMN),
            ("row", FAMILY_TP_ROW[0], FAMILY_TP_ROW),
            ("row_f32", FAMILY_TP_ROW_F32[1], FAMILY_TP_ROW_F32)):
        sets = [packed(k, n) for _ in range(4)]
        x = randn(m, k)
        out = torch.float32 if kind == "row_f32" else torch.bfloat16
        ms = time_ms(lambda i: qm.quant_matmul(x, *sets[i % 4],
                                               out_dtype=out))
        plain = time_ms(lambda i: qm.quant_matmul_ref(x, *sets[i % 4],
                                                      out_dtype=out),
                        reps=5)
        b_ms, b_by = bound(m * k * 2 + k * n // 2 + 2 * (k // g) * n * 4
                           + m * n * (4 if kind == "row_f32" else 2),
                           2 * m * k * n)
        rows.append(dict(
            name=f"quant_matmul_tp2_families_{kind}", route="cuda",
            source="src/repro_torch/csrc/quant_matmul.cu",
            replaces="src/repro/kernels/quant_matmul.py:56",
            shape=f"x ({m},{k}) bf16, codes ({k // 2},{n}), g={g}"
                  + (", f32 output" if kind == "row_f32" else "")
                  + f"; one rank's {kind.replace('_f32', '')} shards of the "
                  f"families at model 2: "
                  + ", ".join(f"{kk}->{nn}" for kk, nn in shapes),
            max_abs_err=errs[kind], ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            library_note="none: no single PyTorch call takes this int4 "
                         "layout"))
        del sets

    # prefill attention on a rank's heads: qwen2-vl's 1 of 2 KV heads (G 6,
    # causal) and whisper's encoder, 6 of 12 heads (G 1, not causal)
    for name, b, kh_all, gq, t, hd, causal, what in [
            ("flash_attention_vlm_tp2", 4, 2, 6, 512, 128, True,
             "4 slots x one rank's 1 of 2 KV heads (qwen2-vl), causal"),
            ("flash_attention_whisper_tp2", 4, WHISPER_HEADS, 1,
             WHISPER_FRAMES, 64, False,
             f"4 requests x one rank's {WHISPER_HEADS // TP_RANKS} of "
             f"{WHISPER_HEADS} heads (whisper's encoder), not causal")]:
        kh = kh_all // TP_RANKS
        bkh = b * kh
        qf = randn(b * kh_all, gq, t, hd)
        kf, vf = (randn(b * kh_all, t, hd) for _ in range(2))
        whole = fa.flash_attention(qf, kf, vf, causal=causal)

        def kv_heads(w, r, kh=kh, kh_all=kh_all, b=b):
            return w.reshape(b, kh_all, *w.shape[1:])[
                :, r * kh:(r + 1) * kh].reshape(b * kh, *w.shape[1:])

        err = _shard_rows(f"{name} BKH={bkh} G={gq} T={t} hd={hd}",
                          lambda *a, c=causal: fa.flash_attention(*a,
                                                                  causal=c),
                          lambda *a, c=causal: fa.flash_attention_ref(
                              *a, causal=c),
                          whole, lambda r: tuple(kv_heads(w, r).contiguous()
                                                 for w in (qf, kf, vf)),
                          kv_heads, rel_tol=BF16_REL_TOL)
        q, k, v = (kv_heads(w, 0).contiguous() for w in (qf, kf, vf))
        ms = time_ms(lambda i: fa.flash_attention(q, k, v, causal=causal))
        plain = time_ms(lambda i: fa.flash_attention_ref(q, k, v,
                                                         causal=causal),
                        reps=5)

        def sdpa(i, q=q, k=k, v=v, b=b, kh=kh, gq=gq, t=t, hd=hd,
                 causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(b, kh * gq, t, hd), k.reshape(b, kh, t, hd),
                v.reshape(b, kh, t, hd), is_causal=causal,
                enable_gqa=gq > 1)

        held(f"{name}: library call (sdpa)",
             sdpa(0).reshape(bkh, gq, t, hd),
             fa.flash_attention_ref(q, k, v, causal=causal))
        lib = time_ms(sdpa)
        pairs = t * (t + 1) / 2 if causal else t * t
        b_ms, b_by = bound((2 * bkh * gq * t * hd + 2 * bkh * t * hd) * 2,
                           4 * bkh * gq * hd * pairs)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:92",
                         shape=f"q ({bkh},{gq},{t},{hd}) bf16: {what}",
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del qf, kf, vf, whole, q, k, v

    # decode attention on a rank's heads: qwen2-vl's 6 query heads on 1 KV
    # head, whisper's cross attention on 6 of 12 heads over 1536 keys
    for name, h_all, kh_all, s_len, hd, lens, what in [
            ("flash_decode_vlm_tp2", 12, 2, 1024, 128, [44, 140, 332, 732],
             "qwen2-vl decode, one rank's 6 / 1 of 12 / 2 heads"),
            ("flash_decode_cross_tp2", WHISPER_HEADS, WHISPER_HEADS,
             WHISPER_FRAMES, 64, [WHISPER_FRAMES] * 4,
             "whisper cross-attention, one rank's 6 of 12 heads")]:
        b = 4
        h, kh = h_all // TP_RANKS, kh_all // TP_RANKS
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        qw = randn(b, 1, h_all, hd)
        kw, vw = (randn(b, kh_all, s_len, hd) for _ in range(2))

        def args_of(r, qw=qw, kw=kw, vw=vw, h=h, kh=kh, cl=cl):
            return (qw[:, :, r * h:(r + 1) * h].contiguous(),
                    kw[:, r * kh:(r + 1) * kh].contiguous(),
                    vw[:, r * kh:(r + 1) * kh].contiguous(), cl)

        err = _shard_rows(f"{name} B={b} H={h} KH={kh} S={s_len}",
                          fd.flash_decode, fd.decode_attention_ref,
                          fd.flash_decode(qw, kw, vw, cl), args_of,
                          lambda w, r, h=h: w[:, :, r * h:(r + 1) * h])
        sets = [args_of(0)] + [
            (args_of(0)[0], randn(b, kh, s_len, hd), randn(b, kh, s_len, hd),
             cl) for _ in range(7)]
        ms = time_ms(lambda i: fd.flash_decode(*sets[i % 8]))
        plain = time_ms(lambda i: fd.decode_attention_ref(*sets[i % 8]))
        held(f"{name}: library call (sdpa)", _sdpa_decode(*sets[0]),
             fd.decode_attention_ref(*sets[0]))
        lib = time_ms(lambda i: _sdpa_decode(*sets[i % 8]))
        live = sum(lens)
        b_ms, b_by = bound(2 * b * h * hd * 2 + b * 4 + live * kh * hd * 2 * 2,
                           4 * live * h * hd)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/flash_decode.py:216",
                         shape=f"q ({b},1,{h},{hd}) bf16, cache ({b},{kh},"
                               f"{s_len},{hd}), lens {lens} ({what})",
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del sets, qw, kw, vw
    return rows


def family_route_rows(dev, gen, randn):
    """The routes the VLM and hybrid families add to the dense kernels,
    each against its plain version, then timed beside SDPA with its bound:
    flash_attention at G 6 / hd 128 (qwen2-vl's calibration, 16 x (256
    patches + 256 tokens), and odd T), flash_decode at G 6 / hd 128 and at
    G 5 / hd 64 over a wrapped ring cache; quant_matmul at hymba's x_proj
    width (n 132, padded to 144), k 3200, for m 1 / 16 / 8192, rows bit
    for bit across m.  Returns the three attention rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.core import QuantSpec, quantize_groupwise

    phase("kernel routes of the VLM and hybrid families (G 6, G 5 ring, "
          "n 132)")
    qt = quantize_groupwise(randn(3200, 132, dtype=torch.float32),
                            QuantSpec(bits=4, group_size=64), pack=True)
    xq = randn(8192, 3200)
    full = qm.quant_matmul(xq, qt.codes, qt.scale, qt.zero)
    held("quant_matmul m=8192 k=3200 n=132 g=64 bf16", full,
         qm.quant_matmul_ref(xq, qt.codes, qt.scale, qt.zero),
         rel_tol=EXACT_REL_TOL)
    for m in (1, 16):
        x = xq[:m].contiguous()
        held(f"quant_matmul m={m} k=3200 n=132 g=64 bf16",
             qm.quant_matmul(x, qt.codes, qt.scale, qt.zero),
             qm.quant_matmul_ref(x, qt.codes, qt.scale, qt.zero),
             rel_tol=EXACT_REL_TOL)
        same_bits(f"quant_matmul n=132 rows of m={m} == the same rows of "
                  f"m=8192", qm.quant_matmul(x, qt.codes, qt.scale, qt.zero),
                  full[:m])
    del xq, full

    for bkh, g, t, hd, dt in [(4, 6, 37, 128, torch.bfloat16),
                              (4, 6, 371, 128, torch.bfloat16),
                              (4, 6, 513, 128, torch.bfloat16),
                              (4, 6, 150, 128, torch.float32)]:
        q = randn(bkh, g, t, hd, dtype=dt)
        k_, v_ = randn(bkh, t, hd, dtype=dt), randn(bkh, t, hd, dtype=dt)
        held(f"flash_attention BKH={bkh} G={g} T={t} hd={hd} {str(dt)[6:]}",
             fa.flash_attention(q, k_, v_), fa.flash_attention_ref(q, k_, v_),
             rel_tol=BF16_REL_TOL if dt == torch.bfloat16 else None)
    bkh, g, t, hd = VLM_CAL_BATCH * 2, 6, VLM_PATCHES + VLM_TOKENS, 128
    sets = [(randn(bkh, g, t, hd), randn(bkh, t, hd), randn(bkh, t, hd))
            for _ in range(2)]
    err = held("flash_attention G 6 timed shape", fa.flash_attention(*sets[0]),
               fa.flash_attention_ref(*sets[0]), rel_tol=BF16_REL_TOL)
    ms = time_ms(lambda i: fa.flash_attention(*sets[i % 2]))
    plain = time_ms(lambda i: fa.flash_attention_ref(*sets[i % 2]), reps=5)
    nb = bkh // 2

    def sdpa_causal(i):
        q_, k_, v_ = sets[i % 2]
        return torch.nn.functional.scaled_dot_product_attention(
            q_.reshape(nb, 2 * g, t, hd), k_.reshape(nb, 2, t, hd),
            v_.reshape(nb, 2, t, hd), is_causal=True, enable_gqa=True)

    held("flash_attention G 6 library call (sdpa)",
         sdpa_causal(0).reshape(bkh, g, t, hd),
         fa.flash_attention_ref(*sets[0]))
    lib = time_ms(sdpa_causal)
    b_ms, b_by = bound((2 * bkh * g * t * hd + 2 * bkh * t * hd) * 2,
                       4 * bkh * g * hd * t * (t + 1) / 2)
    rows = [dict(name="flash_attention_g6", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:92",
                 shape=f"q ({bkh},{g},{t},{hd}) bf16, k/v ({bkh},{t},{hd}), "
                       f"causal (qwen2-vl calibration)",
                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib)]
    del sets

    for b, h, kh, s, hd, lens, dt in [
            (4, 12, 2, 1024, 128, [0, 1, 1024, 517], torch.bfloat16),
            (4, 25, 5, RING, 64, list(RING_LENS), torch.bfloat16),
            (4, 25, 5, RING, 64, [1024, 1, 0, 700], torch.bfloat16),
            (3, 25, 5, 200, 64, [200, 13, 1], torch.float32),
            (3, 12, 2, 200, 128, [200, 13, 1], torch.float32)]:
        q = randn(b, 1, h, hd, dtype=dt)
        kc, vc = randn(b, kh, s, hd, dtype=dt), randn(b, kh, s, hd, dtype=dt)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        tag = f"B={b} H={h} KH={kh} S={s} hd={hd} lens={lens} {str(dt)[6:]}"
        got = fd.flash_decode(q, kc, vc, cl)
        held(f"flash_decode {tag}", got, fd.decode_attention_ref(q, kc, vc,
                                                                 cl))
        if dt == torch.bfloat16:
            alone = torch.cat([fd.flash_decode(q[i:i + 1], kc[i:i + 1],
                                               vc[i:i + 1], cl[i:i + 1])
                               for i in range(b)])
            same_bits(f"flash_decode slot alone == in the batch {tag}",
                      alone, got)
    for name, h, kh, hd, lens, what in [
            ("flash_decode_g6", 12, 2, 128, [44, 140, 332, 732],
             "qwen2-vl decode, prompts 12/100/300/700 + 32"),
            ("flash_decode_ring_g5", 25, 5, 64, list(RING_LENS),
             "hymba decode over its 1024-slot ring, two slots wrapped")]:
        b, s = 4, 1024
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(b, 1, h, hd)
        caches = [(randn(b, kh, s, hd), randn(b, kh, s, hd))
                  for _ in range(8)]
        err = held(f"{name} timed shape", fd.flash_decode(q, *caches[0], cl),
                   fd.decode_attention_ref(q, *caches[0], cl))
        ms = time_ms(lambda i: fd.flash_decode(q, *caches[i % 8], cl))
        plain = time_ms(lambda i: fd.decode_attention_ref(q, *caches[i % 8],
                                                          cl))
        held(f"{name} library call (sdpa)", _sdpa_decode(q, *caches[0], cl),
             fd.decode_attention_ref(q, *caches[0], cl))
        lib = time_ms(lambda i: _sdpa_decode(q, *caches[i % 8], cl))
        live = sum(lens)
        b_ms, b_by = bound(2 * b * h * hd * 2 + b * 4 + live * kh * hd * 2 * 2,
                           4 * live * h * hd)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/flash_decode.py:216",
                         shape=f"q ({b},1,{h},{hd}) bf16, cache ({b},{kh},"
                               f"{s},{hd}), lens {lens} ({what})",
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del caches
    return rows


# whisper-small's shapes: 12 heads (MHA) of 64, 1536 encoder frames; the
# smoke's decoder prompts and cache (WHISPER_PROMPT + NEW_TOKENS positions)
WHISPER_HEADS, WHISPER_FRAMES, WHISPER_PROMPT = 12, 1536, 100
WHISPER_CAL_BATCH, WHISPER_CAL_TOKENS = 16, 256
# the seven (k, n) site widths of the ssm and audio families: xlstm's
# up_proj / w_in, wq / wk / wv, down_proj, out_proj; whisper's attention,
# w1, w2
SSM_AUDIO_WIDTHS = ((1024, 4096), (2048, 2048), (2048, 1024), (1024, 1024),
                    (768, 768), (768, 3072), (3072, 768))


def ssm_audio_route_rows(dev, gen, randn):
    """The routes the ssm and audio families add to the kernels, each
    against its plain version, then timed beside SDPA with its bound:
    flash_attention not causal at G 1 / hd 64 (whisper's encoder: T 37 /
    512 / 1536 held, q (192, 1, 1536, 64) timed, its calibration's 16 x
    12 heads), flash_decode at G 1 / hd 64 over the decoder's self cache
    and over the full 1536-key cross cache (a slot's bits whatever the
    batch); quant_matmul at the seven new site widths for m 1 / 4 and the
    calibration's 8192 rows, rows bit for bit across m; rms_norm in f32 at
    xLSTM's widths (the mLSTM's out_norm at 2048, the sLSTM's at 1024).
    Returns the three attention rows."""
    from repro_torch.core import QuantSpec, quantize_groupwise
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rms_norm as rn

    phase("kernel routes of the ssm and audio families (non-causal G 1, "
          "decode G 1 self and cross, seven quant_matmul widths)")
    for k, n in SSM_AUDIO_WIDTHS:
        qt = quantize_groupwise(randn(k, n, dtype=torch.float32),
                                QuantSpec(bits=4, group_size=64), pack=True)
        xq = randn(8192, k)
        full = qm.quant_matmul(xq, qt.codes, qt.scale, qt.zero)
        held(f"quant_matmul m=8192 k={k} n={n} g=64 bf16", full,
             qm.quant_matmul_ref(xq, qt.codes, qt.scale, qt.zero),
             rel_tol=EXACT_REL_TOL)
        for m in (1, 4):
            x = xq[:m].contiguous()
            got = qm.quant_matmul(x, qt.codes, qt.scale, qt.zero)
            held(f"quant_matmul m={m} k={k} n={n} g=64 bf16", got,
                 qm.quant_matmul_ref(x, qt.codes, qt.scale, qt.zero),
                 rel_tol=EXACT_REL_TOL)
            same_bits(f"quant_matmul k={k} n={n} rows of m={m} == the same "
                      f"rows of m=8192", got, full[:m])
        del xq, full
    for rows_, d in ((4, 2048), (8192, 2048), (4, 1024), (8192, 1024)):
        x, w = randn(rows_, d, dtype=torch.float32), randn(d)
        got = rn.rms_norm(x, w.float())
        held(f"rms_norm f32 ({rows_}, {d})", got,
             rn.rms_norm_ref(x, w.float()))
        same_bits(f"rms_norm f32 ({rows_}, {d}) row 0 alone",
                  rn.rms_norm(x[:1].clone(), w.float()), got[:1])

    for bkh, t, dt in [(6, 37, torch.bfloat16), (6, 512, torch.bfloat16),
                       (6, 1536, torch.bfloat16), (6, 150, torch.float32)]:
        q = randn(bkh, 1, t, 64, dtype=dt)
        k_, v_ = randn(bkh, t, 64, dtype=dt), randn(bkh, t, 64, dtype=dt)
        got = fa.flash_attention(q, k_, v_, causal=False)
        held(f"flash_attention BKH={bkh} G=1 T={t} hd=64 not causal "
             f"{str(dt)[6:]}", got,
             fa.flash_attention_ref(q, k_, v_, causal=False),
             rel_tol=BF16_REL_TOL if dt == torch.bfloat16 else None)
        same_bits(f"flash_attention G=1 T={t} not causal, twice",
                  fa.flash_attention(q, k_, v_, causal=False), got)
    bkh, t, hd = WHISPER_CAL_BATCH * WHISPER_HEADS, WHISPER_FRAMES, 64
    sets = [(randn(bkh, 1, t, hd), randn(bkh, t, hd), randn(bkh, t, hd))
            for _ in range(2)]
    attend = lambda i: fa.flash_attention(*sets[i % 2], causal=False)
    err = held("flash_attention_noncausal_g1 timed shape", attend(0),
               fa.flash_attention_ref(*sets[0], causal=False),
               rel_tol=BF16_REL_TOL)
    ms = time_ms(attend)
    plain = time_ms(lambda i: fa.flash_attention_ref(*sets[i % 2],
                                                     causal=False), reps=5)
    nb = bkh // WHISPER_HEADS

    def sdpa(i):
        q_, k_, v_ = sets[i % 2]
        return torch.nn.functional.scaled_dot_product_attention(
            q_.reshape(nb, WHISPER_HEADS, t, hd),
            k_.reshape(nb, WHISPER_HEADS, t, hd),
            v_.reshape(nb, WHISPER_HEADS, t, hd))

    held("flash_attention_noncausal_g1 library call (sdpa)",
         sdpa(0).reshape(bkh, 1, t, hd),
         fa.flash_attention_ref(*sets[0], causal=False))
    lib = time_ms(sdpa)
    b_ms, b_by = bound(4 * bkh * t * hd * 2, 4 * bkh * t * t * hd)
    rows = [dict(name="flash_attention_noncausal_g1", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:92",
                 shape=f"q ({bkh},1,{t},{hd}) bf16, k/v ({bkh},{t},{hd}), "
                       f"not causal (whisper's encoder in calibration)",
                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib)]
    del sets

    self_len = WHISPER_PROMPT + NEW_TOKENS
    for s_len, lens, dt in [(self_len, [13, 100, self_len - 1, 1],
                             torch.bfloat16),
                            (WHISPER_FRAMES, [WHISPER_FRAMES] * 4,
                             torch.bfloat16),
                            (200, [200, 13, 1, 77], torch.float32)]:
        h = WHISPER_HEADS
        q = randn(4, 1, h, 64, dtype=dt)
        kc, vc = randn(4, h, s_len, 64, dtype=dt), randn(4, h, s_len, 64,
                                                          dtype=dt)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        tag = f"B=4 H={h} KH={h} S={s_len} hd=64 lens={lens} {str(dt)[6:]}"
        got = fd.flash_decode(q, kc, vc, cl)
        held(f"flash_decode {tag}", got, fd.decode_attention_ref(q, kc, vc,
                                                                 cl))
        same_bits(f"flash_decode {tag}, twice", fd.flash_decode(q, kc, vc, cl),
                  got)
        alone = torch.cat([fd.flash_decode(q[i:i + 1], kc[i:i + 1],
                                           vc[i:i + 1], cl[i:i + 1])
                           for i in range(4)])
        same_bits(f"flash_decode slot alone == in the batch {tag}", alone,
                  got)
    for name, s_len, lens, what in [
            ("flash_decode_g1", self_len, [self_len - 1] * 4,
             f"whisper self-attention, the last of {NEW_TOKENS - 1} decode "
             f"steps after {WHISPER_PROMPT}-token prompts"),
            ("flash_decode_cross_g1", WHISPER_FRAMES, [WHISPER_FRAMES] * 4,
             "whisper cross-attention over the 1536 encoder keys")]:
        b, h = 4, WHISPER_HEADS
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(b, 1, h, 64)
        caches = [(randn(b, h, s_len, 64), randn(b, h, s_len, 64))
                  for _ in range(8)]
        err = held(f"{name} timed shape", fd.flash_decode(q, *caches[0], cl),
                   fd.decode_attention_ref(q, *caches[0], cl))
        ms = time_ms(lambda i: fd.flash_decode(q, *caches[i % 8], cl))
        plain = time_ms(lambda i: fd.decode_attention_ref(q, *caches[i % 8],
                                                          cl))
        held(f"{name} library call (sdpa)", _sdpa_decode(q, *caches[0], cl),
             fd.decode_attention_ref(q, *caches[0], cl))
        lib = time_ms(lambda i: _sdpa_decode(q, *caches[i % 8], cl))
        live = sum(lens)
        b_ms, b_by = bound(2 * b * h * 64 * 2 + b * 4 + live * h * 64 * 2 * 2,
                           4 * live * h * 64)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/flash_decode.py:216",
                         shape=f"q ({b},1,{h},64) bf16, cache ({b},{h},"
                               f"{s_len},64), lens {lens} ({what})",
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del caches
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


MOE_EXPERTS = 64                   # qwen2-moe's 60 routed experts, padded
MOE_CAL_CAP = 683                  # capacity of 16 x 512 calibration tokens


def quant_matmul_experts_row(dev, gen, randn):
    """The grouped launch at qwen2-moe's expert shapes (E 64, g 64): C 1
    (decode) and C 683 (calibration), 2048 -> 1408 (gate / up) and 1408 ->
    2048 (down), each held against the plain version, each expert's rows
    bit for bit against the single-expert launch, the same bits on a
    second call.  Timed at decode's gate projection beside 64 single-
    expert launches, the plain version and, as a yardstick that is not
    the same function (it reads the weights dequantized to bf16, 3.2x the
    bytes), torch.bmm."""
    from repro_torch.core import QuantSpec, quantize_groupwise
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ops import quant_matmul_experts
    from repro_torch.kernels.ref import quant_matmul_experts_ref

    phase("kernel quant_matmul_experts (grouped launch)")
    for src_name, log in _build.build_logs.items():
        for kernel, report in ptxas_report(log):
            if kernel.startswith("qmm_tc"):
                print(f"  {src_name} {kernel}: {report}", flush=True)
    e, g = MOE_EXPERTS, 64

    def stack(k, n, act=True):
        a = (torch.rand((e, k), generator=gen, device=dev) + 0.5
             if act else None)
        return quantize_groupwise(randn(e, k, n, dtype=torch.float32)
                                  / k ** 0.5, QuantSpec(4, g), act_scale=a,
                                  pack=True)

    def qmm_bytes(c, k, n):
        return (e * (c * k * 2 + k * n // 2 + 2 * (k // g) * n * 4
                     + c * n * 2 + k * 4))

    out = {}
    for c in (1, MOE_CAL_CAP):
        for k, n in ((2048, 1408), (1408, 2048)):
            qt = stack(k, n)
            x = randn(e, c, k) / 4
            got = quant_matmul_experts(x, qt)
            err = held(f"E={e} C={c} {k}->{n} bf16", got,
                       quant_matmul_experts_ref(x, qt),
                       rel_tol=EXACT_REL_TOL)
            same_bits(f"E={e} C={c} {k}->{n}: a second call",
                      quant_matmul_experts(x, qt), got)
            xs = x / qt.act_scale[:, None, :].to(x.dtype)
            singles = torch.stack([qm.quant_matmul(xs[i].contiguous(),
                                                   qt.codes[i], qt.scale[i],
                                                   qt.zero[i])
                                   for i in range(e)])
            same_bits(f"E={e} C={c} {k}->{n}: each expert == its single "
                      f"launch", got, singles)
            out[(c, k, n)] = (qt, x, err)
    for (c, k, n), (qt, x, err) in out.items():
        sets = [qt, stack(k, n)]        # 2 x 92 MB of codes at 2048 x 1408
        ms = time_ms(lambda i: quant_matmul_experts(x, sets[i % 2]))
        xs = x / qt.act_scale[:, None, :].to(x.dtype)
        loop = time_ms(lambda i: [qm.quant_matmul(xs[j], sets[i % 2].codes[j],
                                                  sets[i % 2].scale[j],
                                                  sets[i % 2].zero[j])
                                  for j in range(e)], reps=5, inner=2)
        w16 = torch.stack([qm.dequant_ref(qt.codes[j], qt.scale[j],
                                          qt.zero[j], k) for j in range(e)]
                          ).to(torch.bfloat16)
        bmm = time_ms(lambda i: torch.bmm(xs, w16), reps=10, inner=5)
        del w16
        b_ms, b_by = bound(qmm_bytes(c, k, n), 2 * e * c * k * n)
        print(f"  E={e} C={c} {k}->{n}: grouped {ms:.4f} ms, 64 single "
              f"launches {loop:.4f} ms, bound {b_ms:.4f} by {b_by}, "
              f"yardstick torch.bmm on bf16-dequantized weights "
              f"{bmm:.4f} ms (not the same function)", flush=True)
        out[(c, k, n)] = dict(ms=ms, loop_ms=loop, bmm_ms=bmm, bound_ms=b_ms,
                              bound_by=b_by, err=err)
    dec = out[(1, 2048, 1408)]
    qt, x = stack(2048, 1408), randn(e, 1, 2048) / 4
    plain = time_ms(lambda i: quant_matmul_experts_ref(x, qt), reps=5,
                    inner=2)
    cal = {f"c{c}_{k}x{n}": v for (c, k, n), v in out.items()}
    return dict(name="quant_matmul_experts", route="cuda",
                source="src/repro_torch/csrc/quant_matmul.cu",
                replaces="src/repro/kernels/ops.py:78",
                shape=f"x ({e},1,2048) bf16, codes ({e},1024,1408), g={g}",
                max_abs_err=max(v["err"] for v in out.values()),
                ms=dec["ms"], plain_ms=plain, bound_ms=dec["bound_ms"],
                bound_by=dec["bound_by"], library_ms=None,
                library_note="none: no single PyTorch call takes this int4 "
                             "layout; torch.bmm on bf16-dequantized weights "
                             "is the yardstick (bmm_ms)",
                single_launch_loop_ms=dec["loop_ms"], bmm_ms=dec["bmm_ms"],
                shapes={kk: {f: v[f] for f in ("ms", "loop_ms", "bmm_ms",
                                                 "bound_ms")}
                        for kk, v in cal.items()})


def rms_norm_row(dev, gen, randn):
    """rms_norm at the decode step's (4, 4096) and a verify pass's
    (16, 4096) rows, and at the train step's (2048, 4096) and
    calibration's (8192, 4096), bf16: against its plain version, rows bit
    for bit whatever rows come with them, then timed beside the plain
    version and ``torch.nn.functional.rms_norm`` (inputs rotated past L2
    at 2048 rows and more)."""
    from repro_torch.kernels import rms_norm as rn

    phase("kernel rms_norm")
    d, eps = 4096, 1e-5
    w = randn(d)
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    out = {}
    for rows_n in RMS_NORM_ROWS:
        xs = (_rotated(lambda: randn(rows_n, d) * 3, rows_n * d * 2)
              if rows_n >= 2048 else [randn(rows_n, d) * 3 for _ in range(8)])
        n = len(xs)
        full = rn.rms_norm(xs[0], w, eps)
        err = held(f"rows={rows_n} d={d} bf16", full,
                   rn.rms_norm_ref(xs[0], w, eps))
        alone = list(range(rows_n)) if rows_n <= 16 else \
            [0, 1, 777, rows_n - 1]
        same_bits(f"rows={rows_n}: "
                  f"{'each row' if rows_n <= 16 else f'rows {alone}'} alone "
                  f"== in the batch",
                  torch.cat([rn.rms_norm(xs[0][i:i + 1], w, eps)
                             for i in alone]), full[alone])
        out[rows_n] = dict(
            err=err, ms=time_ms(lambda i: rn.rms_norm(xs[i % n], w, eps)),
            plain=time_ms(lambda i: rn.rms_norm_ref(xs[i % n], w, eps)),
            lib=None if lib_fn is None else time_ms(
                lambda i: lib_fn(xs[i % n], (d,), w, eps)),
            bound=bound(2 * rows_n * d * 2 + d * 2, 4 * rows_n * d,
                        F32_FLOPS_PER_S))
        print(f"  rows={rows_n}: {out[rows_n]['ms']:.4f} ms (plain "
              f"{out[rows_n]['plain']:.4f}, F.rms_norm {out[rows_n]['lib']}, "
              f"bound {out[rows_n]['bound'][0]:.6f} by "
              f"{out[rows_n]['bound'][1]})", flush=True)
        del xs, full
    torch.cuda.empty_cache()
    r4 = out[4]
    more = {}
    for rows_n in RMS_NORM_ROWS[1:]:
        o = out[rows_n]
        more.update({f"rows{rows_n}_ms": o["ms"],
                     f"rows{rows_n}_plain_ms": o["plain"],
                     f"rows{rows_n}_library_ms": o["lib"],
                     f"rows{rows_n}_bound_ms": o["bound"][0],
                     f"rows{rows_n}_max_abs_err": o["err"]})
    return dict(name="rms_norm", route="cuda",
                source="src/repro_torch/csrc/rms_norm.cu",
                replaces="none: a kernel of the port only (repro's rms_norm "
                         "is plain jnp, src/repro/models/common.py:54)",
                shape=f"x (4,{d}) bf16, w ({d},)", max_abs_err=r4["err"],
                ms=r4["ms"], plain_ms=r4["plain"], bound_ms=r4["bound"][0],
                bound_by=r4["bound"][1], library_ms=r4["lib"], **more)


def flash_attention_bwd_row(dev, gen, randn):
    """flash_attention's backward kernels at the train path's attention
    shape (B 4, T 512, 32 heads on 8 KV heads, hd 128: q (32, 4, 512,
    128)), bf16 (the tensor-core route) and f32 (the CUDA-core route), and
    at the reference's training length (B 1, T 4096: q (8, 4, 4096, 128)),
    bf16: at T 512 dq, dk, dv against flash_attention_bwd_ref with the
    forward's tolerances, at both lengths the same bits on a second run (no
    atomics), then (bf16) timed beside the backward of
    scaled_dot_product_attention (GQA) under autograd, whose dq is held to
    the kernel's, and at T 512 beside the plain version."""
    from repro_torch.kernels import flash_attention as fa

    phase("kernel flash_attention_bwd")
    g, hd = 4, 128

    def case(bkh, t, dt):
        """(max abs error against the plain version at T 512, else None;
        the inputs) of one shape, held and repeated"""
        q, do = randn(bkh, g, t, hd, dtype=dt), randn(bkh, g, t, hd, dtype=dt)
        k_, v_ = randn(bkh, t, hd, dtype=dt), randn(bkh, t, hd, dtype=dt)
        o, lse = fa._forward(q, k_, v_, True, None, with_lse=True)
        got = fa.flash_attention_bwd(q, k_, v_, o, lse, do)
        err = None
        if t == 512:
            want = fa.flash_attention_bwd_ref(q, k_, v_, do)
            bf16 = dt == torch.bfloat16
            err = max(held(f"{name} q ({bkh},{g},{t},{hd}) {str(dt)[6:]}", a,
                           b, rel_tol=BF16_REL_TOL if bf16 else None)
                      for name, a, b in zip(("dq", "dk", "dv"), got, want))
            del want
        again = fa.flash_attention_bwd(q, k_, v_, o, lse, do)
        same_bits(f"({bkh},{g},{t},{hd}) {str(dt)[6:]}: a second backward",
                  torch.cat([x.flatten() for x in again]),
                  torch.cat([x.flatten() for x in got]))
        return err, (q, k_, v_, o, lse, do)

    def timed(bkh, t, sets):
        """kernel ms, SDPA backward ms (dq held to the kernel's), bound"""
        q, k_, v_, o, lse, do = sets
        ms = time_ms(lambda i: fa.flash_attention_bwd(q, k_, v_, o, lse, do),
                     reps=10, inner=3)
        b, kh = bkh // 8, 8
        leaves = [x.reshape(shape).detach().requires_grad_() for x, shape in
                  ((q, (b, kh * g, t, hd)), (k_, (b, kh, t, hd)),
                   (v_, (b, kh, t, hd)))]
        sd = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True)
        do_r = do.reshape(b, kh * g, t, hd)

        def sdpa_bwd(i):
            return torch.autograd.grad(sd, leaves, do_r, retain_graph=True)

        held(f"library call (sdpa backward) dq, T {t}, against the kernel's",
             sdpa_bwd(0)[0].reshape(q.shape),
             fa.flash_attention_bwd(q, k_, v_, o, lse, do)[0],
             rel_tol=BF16_REL_TOL)
        lib = time_ms(sdpa_bwd, reps=10, inner=3)
        # the function's bytes (q, k, v, o, dO, lse read; dq, dk, dv
        # written) and its five products over the causal triangle
        e = 2
        b_ms, b_by = bound((3 * bkh * g * t * hd + 2 * bkh * t * hd) * e
                           + bkh * g * t * 4
                           + (bkh * g * t * hd + 2 * bkh * t * hd) * e,
                           10 * hd * bkh * g * t * (t + 1) / 2)
        print(f"  bf16 T {t}: {ms:.4f} ms, library (sdpa backward) "
              f"{lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}", flush=True)
        return ms, lib, b_ms, b_by

    err, sets = case(32, 512, torch.bfloat16)
    f32_err, _ = case(32, 512, torch.float32)
    ms, lib, b_ms, b_by = timed(32, 512, sets)
    q, k_, v_, _, _, do = sets
    plain = time_ms(lambda i: fa.flash_attention_bwd_ref(q, k_, v_, do),
                    reps=3, inner=2)
    print(f"  bf16 T 512: plain {plain:.4f} ms", flush=True)
    del sets, q, k_, v_, do
    _, sets = case(8, 4096, torch.bfloat16)
    ms4k, lib4k, b4k, _ = timed(8, 4096, sets)
    del sets
    torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="none: a kernel of the port only (repro has no "
                         "backward kernel and trains through its jnp "
                         "attention; forward src/repro/kernels/"
                         "flash_attention.py:92)",
                shape=f"q/o/dO (32,{g},512,{hd}) bf16, k/v (32,512,"
                      f"{hd}), lse f32, causal",
                max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                f32_max_abs_err=f32_err, t4096_ms=ms4k, t4096_library_ms=lib4k, t4096_bound_ms=b4k)


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


def mesh_train_route_rows(dev, gen, randn):
    """The backward routes a rank of mesh training launches (llama3-8b at B
    4, T 512): flash_attention_bwd on one rank's 4 of 8 KV heads at model
    2 (q (16, 4, 512, 128), causal, bf16), each rank's launch, after its own
    forward, held against the plain version and, bit for bit, against its
    heads of the whole launch; rms_norm_bwd on a data rank's 1024 of the
    2048 rows at data 2, bf16, dx and dw held against the plain version and
    dx bit for bit against its rows of the whole launch (dw sums the rank's
    rows only).  Each timed beside the plain version and the backward of
    the library call (``scaled_dot_product_attention`` with GQA,
    ``F.rms_norm``) under autograd."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn

    phase("kernel routes of mesh training (model 2: 4 of 8 KV heads; data "
          "2: 1024 of 2048 rows)")
    rows = []
    b, kh, g, t, hd = 4, 8 // TP_RANKS, 4, 512, 128
    bkh = b * kh
    qf, dof = (randn(b * TP_RANKS * kh, g, t, hd) for _ in range(2))
    kf, vf = (randn(b * TP_RANKS * kh, t, hd) for _ in range(2))
    of, lsef = fa._forward(qf, kf, vf, True, None, with_lse=True)
    whole = fa.flash_attention_bwd(qf, kf, vf, of, lsef, dof)

    def heads(w, r):
        return w.reshape(b, TP_RANKS * kh, *w.shape[1:])[
            :, r * kh:(r + 1) * kh].reshape(bkh, *w.shape[1:]).contiguous()

    err = 0.0
    for r in range(TP_RANKS):
        q, k, v, do = (heads(w, r) for w in (qf, kf, vf, dof))
        o, lse = fa._forward(q, k, v, True, None, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        want = fa.flash_attention_bwd_ref(q, k, v, do)
        for name, a, w_, full in zip(("dq", "dk", "dv"), got, want, whole):
            err = max(err, held(f"flash_attention_bwd_tp2 {name} q ({bkh},"
                                f"{g},{t},{hd}) rank {r}", a, w_,
                                rel_tol=BF16_REL_TOL))
            same_bits(f"flash_attention_bwd_tp2 {name} rank {r}: == its "
                      f"heads of the whole launch", a, heads(full, r))
        if r == 0:
            sets = (q, k, v, o, lse, do)
        del got, want
    del qf, kf, vf, of, lsef, dof, whole
    q, k, v, o, lse, do = sets
    ms = time_ms(lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do),
                 reps=10, inner=3)
    plain = time_ms(lambda i: fa.flash_attention_bwd_ref(q, k, v, do),
                    reps=3, inner=2)
    leaves = [x.reshape(shape).detach().requires_grad_() for x, shape in
              ((q, (b, kh * g, t, hd)), (k, (b, kh, t, hd)),
               (v, (b, kh, t, hd)))]
    sd = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True)
    do_r = do.reshape(b, kh * g, t, hd)

    def sdpa_bwd(i):
        return torch.autograd.grad(sd, leaves, do_r, retain_graph=True)

    held("flash_attention_bwd_tp2: library call (sdpa backward) dq against "
         "the kernel's", sdpa_bwd(0)[0].reshape(q.shape),
         fa.flash_attention_bwd(q, k, v, o, lse, do)[0],
         rel_tol=BF16_REL_TOL)
    lib = time_ms(sdpa_bwd, reps=10, inner=3)
    b_ms, b_by = bound((3 * bkh * g * t * hd + 2 * bkh * t * hd) * 2
                       + bkh * g * t * 4
                       + (bkh * g * t * hd + 2 * bkh * t * hd) * 2,
                       10 * hd * bkh * g * t * (t + 1) / 2)
    rows.append(dict(name="flash_attention_bwd_tp2", route="cuda",
                     source="src/repro_torch/csrc/flash_attention_bwd.cu",
                     replaces="none: a kernel of the port only (repro has "
                              "no backward kernel; forward src/repro/"
                              "kernels/flash_attention.py:92)",
                     shape=f"q/o/dO ({bkh},{g},{t},{hd}) bf16: 4 slots x "
                           f"one rank's {kh} of {TP_RANKS * kh} KV heads, "
                           f"k/v ({bkh},{t},{hd}), lse f32, causal",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    del sets, q, k, v, o, lse, do, leaves, sd

    n_rows, d, eps = 2048, 4096, 1e-5
    part = n_rows // TP_RANKS
    xf, dyf = randn(n_rows, d) * 3, randn(n_rows, d)
    w = randn(d)
    dx_whole, _ = rn.rms_norm_bwd(xf, w, dyf, eps)
    err = 0.0
    for r in range(TP_RANKS):
        x, dy = (a[r * part:(r + 1) * part].contiguous() for a in (xf, dyf))
        got = rn.rms_norm_bwd(x, w, dy, eps)
        want = rn.rms_norm_bwd_ref(x, w, dy, eps)
        err = max(err, max(held(f"rms_norm_bwd_dp2 {name} ({part},{d}) "
                                f"rank {r}", a, w_, rel_tol=BF16_REL_TOL)
                           for name, a, w_ in zip(("dx", "dw"), got, want)))
        same_bits(f"rms_norm_bwd_dp2 dx rank {r}: == its rows of the whole "
                  f"launch", got[0], dx_whole[r * part:(r + 1) * part])
    x, dy = xf[:part].contiguous(), dyf[:part].contiguous()
    ms = time_ms(lambda i: rn.rms_norm_bwd(x, w, dy, eps))
    plain = time_ms(lambda i: rn.rms_norm_bwd_ref(x, w, dy, eps))
    lib = None
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    if lib_fn is not None:
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = lib_fn(xl, (d,), wl, eps)
        lib = time_ms(lambda i: torch.autograd.grad(out, (xl, wl), dy,
                                                    retain_graph=True))
    b_ms, b_by = bound((3 * part * d + 2 * d) * 2, 10 * part * d,
                       F32_FLOPS_PER_S)
    rows.append(dict(name="rms_norm_bwd_dp2", route="cuda",
                     source="src/repro_torch/csrc/rms_norm.cu",
                     replaces="none: a kernel of the port only (repro's "
                              "rms_norm is plain jnp, src/repro/models/"
                              "common.py:54)",
                     shape=f"x/dy ({part},{d}) bf16: a data rank's rows of "
                           f"{n_rows}, w ({d},)",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    return rows


# the families' training routes of the backward kernels (B 4 at full
# width): (row, family, KV heads, G, T, hd, causal)
FAMILY_BWD_ATTN = (
    ("flash_attention_bwd_vlm_g6", "qwen2-vl-2b", 2, 6, 512, 128, True),
    ("flash_attention_bwd_whisper_g1", "whisper-small", 12, 1, 256, 64,
     True),
    ("flash_attention_bwd_whisper_noncausal_g1", "whisper-small", 12, 1,
     1536, 64, False),
    ("flash_attention_bwd_moe_g1", "qwen2-moe-a2.7b", 16, 1, 512, 128,
     True))
# rms_norm's forward and backward at the families' widths, 4 x 512 rows,
# in the dtype of the family's train cell (xlstm's is f32: FAMILY_TRAIN):
# (row, family, d, dtype)
FAMILY_NORMS = (("rms_norm_bwd_d1536", "qwen2-vl-2b", 1536, "bfloat16"),
                ("rms_norm_bwd_d1600", "hymba-1.5b", 1600, "bfloat16"),
                ("rms_norm_bwd_d1024", "xlstm-350m", 1024, "float32"),
                ("rms_norm_bwd_d2048", "qwen2-moe-a2.7b", 2048, "bfloat16"))
# rms_norm's timed rows at 4096: the decode step, a verify pass, the train
# step (and 4 x 512 prefill rows), calibration's 16 x 512
RMS_NORM_ROWS = (4, 16, 2048, 8192)
# bytes of input sets a timed call rotates through (past the 50 MB L2)
ROTATE_BYTES = 128 * 2**20


def _rotated(make, nbytes):
    """Enough input sets from ``make()`` (each ``nbytes``) that a timed
    loop reading set ``i % n`` finds none of them in L2."""
    return [make() for _ in range(max(2, -(-ROTATE_BYTES // nbytes)))]


def family_train_route_rows(dev, gen, randn):
    """The routes the families' training adds to the backward kernels (B
    4, full width, bf16): flash_attention_bwd at qwen2-vl's G 6 / hd 128,
    whisper's G 1 / hd 64 causal (decoder, T 256) and not causal (encoder,
    T 1536) and qwen2-moe's G 1 / hd 128 (T 512); each against its plain
    version, a second run bit for bit, and each rank's launch on its half
    of the KV heads (model 2, after its own forward) bit for bit against
    its heads of the whole launch.  rms_norm forward and backward at the
    families' widths 1536 / 1600 / 2048 (bf16) and 1024 (f32, xlstm's
    train cell) over 2048 rows, against the plain versions.  Each timed with CUDA events over inputs rotated past
    L2, beside the plain version and the library call under autograd
    (``scaled_dot_product_attention``'s backward, ``F.rms_norm``'s)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn

    phase("kernel routes of the families' training (flash_attention_bwd G 6 "
          "/ G 1, hd 128 / 64, causal or not; rms_norm d 1536 / 1600 / 2048 "
          "bf16, d 1024 f32)")
    rows, b = [], 4
    for name, family, kh, g, t, hd, causal in FAMILY_BWD_ATTN:
        bkh = b * kh

        def make():
            q, do = randn(bkh, g, t, hd), randn(bkh, g, t, hd)
            k_, v_ = randn(bkh, t, hd), randn(bkh, t, hd)
            o, lse = fa._forward(q, k_, v_, causal, None, with_lse=True)
            return q, k_, v_, o, lse, do

        sets = _rotated(make, (4 * bkh * g * t * hd + 2 * bkh * t * hd) * 2
                        + bkh * g * t * 4)
        q, k_, v_, o, lse, do = sets[0]
        got = fa.flash_attention_bwd(q, k_, v_, o, lse, do, causal=causal)
        want = fa.flash_attention_bwd_ref(q, k_, v_, do, causal=causal)
        err = max(held(f"{name} {n} q ({bkh},{g},{t},{hd})", a, w_,
                       rel_tol=BF16_REL_TOL)
                  for n, a, w_ in zip(("dq", "dk", "dv"), got, want))
        del want
        same_bits(f"{name}: a second backward", torch.cat(
            [x.flatten() for x in fa.flash_attention_bwd(
                q, k_, v_, o, lse, do, causal=causal)]),
            torch.cat([x.flatten() for x in got]))
        half = kh // TP_RANKS

        def heads(w, r):
            return w.reshape(b, kh, *w.shape[1:])[
                :, r * half:(r + 1) * half].reshape(
                    b * half, *w.shape[1:]).contiguous()

        for r in range(TP_RANKS):
            qr, kr, vr, dor = (heads(w, r) for w in (q, k_, v_, do))
            o_r, lse_r = fa._forward(qr, kr, vr, causal, None,
                                     with_lse=True)
            part = fa.flash_attention_bwd(qr, kr, vr, o_r, lse_r, dor,
                                          causal=causal)
            for n, a, full in zip(("dq", "dk", "dv"), part, got):
                same_bits(f"{name} {n} rank {r} of {TP_RANKS}: == its "
                          f"{half} of {kh} KV heads of the whole launch", a,
                          heads(full, r))
        del got, part
        ms = time_ms(lambda i: fa.flash_attention_bwd(
            *sets[i % len(sets)], causal=causal), reps=10, inner=3)
        plain = time_ms(lambda i: fa.flash_attention_bwd_ref(
            *(sets[i % len(sets)][j] for j in (0, 1, 2, 5)), causal=causal),
            reps=3, inner=2)
        lib_sets = []
        for q, k_, v_, o, lse, do in sets:
            leaves = [x.reshape(shape).detach().requires_grad_() for x, shape
                      in ((q, (b, kh * g, t, hd)), (k_, (b, kh, t, hd)),
                          (v_, (b, kh, t, hd)))]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=g > 1)
            lib_sets.append((out, leaves, do.reshape(b, kh * g, t, hd)))

        def sdpa_bwd(i):
            out, leaves, do_r = lib_sets[i % len(lib_sets)]
            return torch.autograd.grad(out, leaves, do_r, retain_graph=True)

        lib = time_ms(sdpa_bwd, reps=10, inner=3)
        pairs = t * (t + 1) / 2 if causal else t * t
        b_ms, b_by = bound((3 * bkh * g * t * hd + 2 * bkh * t * hd) * 2
                           + bkh * g * t * 4
                           + (bkh * g * t * hd + 2 * bkh * t * hd) * 2,
                           10 * hd * bkh * g * pairs)
        print(f"  {name}: {ms:.4f} ms, plain {plain:.4f} ms, library (sdpa "
              f"backward) {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}",
              flush=True)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/flash_attention_bwd.cu",
                         replaces="none: a kernel of the port only (repro "
                                  "has no backward kernel; forward src/repro/"
                                  "kernels/flash_attention.py:92)",
                         shape=f"q/o/dO ({bkh},{g},{t},{hd}) bf16 ({family}: "
                               f"{b} rows x {kh} KV heads), k/v ({bkh},{t},"
                               f"{hd}), lse f32, "
                               f"{'' if causal else 'not '}causal",
                         family=family, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib))
        del sets, lib_sets
        torch.cuda.empty_cache()

    n_rows, eps = b * 512, 1e-5
    lib_fn = getattr(torch.nn.functional, "rms_norm", None)
    for name, family, d, dt in FAMILY_NORMS:
        dtype = getattr(torch, dt)
        size = torch.finfo(dtype).bits // 8
        rel_tol = BF16_REL_TOL if dtype == torch.bfloat16 else None
        w = randn(d, dtype=dtype)
        sets = _rotated(lambda: (randn(n_rows, d, dtype=dtype) * 3,
                                 randn(n_rows, d, dtype=dtype)),
                        2 * n_rows * d * size)
        x, dy = sets[0]
        err = held(f"{name} forward ({n_rows},{d}) {dt}",
                   rn.rms_norm(x, w, eps), rn.rms_norm_ref(x, w, eps))
        got = rn.rms_norm_bwd(x, w, dy, eps)
        err = max([err] + [held(f"{name} {n} ({n_rows},{d})", a, w_,
                                rel_tol=rel_tol) for n, a, w_ in zip(
                                    ("dx", "dw"), got,
                                    rn.rms_norm_bwd_ref(x, w, dy, eps))])
        same_bits(f"{name}: a second backward", torch.cat(
            [a.flatten() for a in rn.rms_norm_bwd(x, w, dy, eps)]),
            torch.cat([a.flatten() for a in got]))
        fwd = time_ms(lambda i: rn.rms_norm(sets[i % len(sets)][0], w, eps))
        fwd_plain = time_ms(lambda i: rn.rms_norm_ref(
            sets[i % len(sets)][0], w, eps))
        ms = time_ms(lambda i: rn.rms_norm_bwd(
            sets[i % len(sets)][0], w, sets[i % len(sets)][1], eps))
        plain = time_ms(lambda i: rn.rms_norm_bwd_ref(
            sets[i % len(sets)][0], w, sets[i % len(sets)][1], eps))
        fwd_lib = lib = None
        if lib_fn is not None:
            fwd_lib = time_ms(lambda i: lib_fn(sets[i % len(sets)][0], (d,),
                                               w, eps))
            graphs = []
            for x, dy in sets:
                xl, wl = x.detach().requires_grad_(), \
                    w.detach().requires_grad_()
                graphs.append((lib_fn(xl, (d,), wl, eps), (xl, wl), dy))
            lib = time_ms(lambda i: torch.autograd.grad(
                graphs[i % len(graphs)][0], graphs[i % len(graphs)][1],
                graphs[i % len(graphs)][2], retain_graph=True))
            del graphs
        b_ms, b_by = bound((3 * n_rows * d + 2 * d) * size, 10 * n_rows * d,
                           F32_FLOPS_PER_S)
        f_ms, _ = bound((2 * n_rows * d + d) * size, 4 * n_rows * d,
                        F32_FLOPS_PER_S)
        print(f"  {name}: backward {ms:.4f} ms (plain {plain:.4f}, "
              f"F.rms_norm backward {lib}, bound {b_ms:.4f} by {b_by}); "
              f"forward {fwd:.4f} ms (plain {fwd_plain:.4f}, F.rms_norm "
              f"{fwd_lib}, bound {f_ms:.4f})", flush=True)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/rms_norm.cu",
                         replaces="none: a kernel of the port only (repro's "
                                  "rms_norm is plain jnp, src/repro/models/"
                                  "common.py:54)",
                         shape=f"x/dy ({n_rows},{d}) {dt} ({family}), w "
                               f"({d},)",
                         family=family, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, fwd_ms=fwd, fwd_plain_ms=fwd_plain,
                         fwd_library_ms=fwd_lib, fwd_bound_ms=f_ms))
        del sets
    torch.cuda.empty_cache()
    return rows


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
    import torch.utils._pytree as pytree

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
    tokens = calib[0]["tokens"]

    def forward(mdl, p, device):
        return mdl.forward(p, {"tokens": torch.as_tensor(tokens, device=device)}
                           )[0].cpu()

    logits, alphas = {}, {}
    for device in (dev, cpu):
        logits[device] = forward(model, params[device], device).float()
        stats = run_calibration(model.forward, params[device], calib)
        qp, report = quantize_model(params[device], model.quant_site_map(),
                                    stats, method="faq",
                                    spec=QuantSpec(bits=4, group_size=64),
                                    mode="packed")
        alphas[device] = {p: r["alpha"].cpu() for p, r in report.items()}
    # the one-off this phase once read (a card-vs-cpu distance 100x its
    # usual): a second card run and an f64 forward of the same weights say
    # which side moved
    again = forward(model, params[dev], dev).float()
    f64 = forward(build_model(cfg.scaled(dtype="float64")), pytree.tree_map(
        lambda t: t.double() if t.is_floating_point() else t, params[cpu]),
        cpu)
    err = float((logits[dev] - logits[cpu]).abs().max())
    card_f64 = float((logits[dev].double() - f64).abs().max())
    cpu_f64 = float((logits[cpu].double() - f64).abs().max())
    repeat = torch.equal(again, logits[dev])
    print(f"  tiny forward (flash-attention path): card vs cpu logits "
          f"max_abs_err={err:.3e}; card vs f64 {card_f64:.3e}, cpu vs f64 "
          f"{cpu_f64:.3e}; a second card run bit for bit {repeat}",
          flush=True)
    check(repeat, "tiny forward: two runs on the card differ (the card "
                  f"moved: {float((again - logits[dev]).abs().max()):.3e})")
    moved = "the card" if card_f64 > cpu_f64 else "the CPU"
    check(err <= 1e-4 * max(1.0, float(logits[cpu].abs().max())),
          f"tiny forward on the card disagrees with the CPU: {moved} moved "
          f"(card vs f64 {card_f64:.3e}, cpu vs f64 {cpu_f64:.3e})")
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
# one H100's dense bf16 peak (NVIDIA's data sheet, SXM part, at 700 W)
BF16_PEAK_TFLOPS = 989
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 4, 512
RESUME_AT = 10
# limit on ||grad - plain grad|| / ||plain grad|| per leaf of one bf16 train
# step: the forward's bf16 roundings (P before P.V, the attention and norm
# outputs) differ between the kernels and the plain versions, 2^-9
# relative each, and reach every gradient through the backward
TRAIN_GRAD_TOL = 5e-2
# the same limit for an f32 train step (xlstm's family cell): the kernels
# and the plain versions differ by f32 summation order, as in the card
# tests' f32 family steps (tests/test_torch_cuda.py)
TRAIN_GRAD_TOL_F32 = 1e-4


@contextlib.contextmanager
def plain_kernels():
    """The models' flash_attention and rms_norm swapped for their plain
    versions (autograd through plain PyTorch: the yardstick of the train
    path's gradients) inside the with-block: in every model module that
    imported rms_norm."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import (common, dense, hymba, moe, ssm, vlm,
                                    xlstm)

    mods = [m for m in (common, dense, hymba, moe, ssm, vlm, xlstm)
            if hasattr(m, "rms_norm")]
    saved = common.flash_attention, [m.rms_norm for m in mods]
    common.flash_attention = (
        lambda q, k, v, causal=True, kv_lens=None:
        fa.flash_attention_ref(q, k, v, causal=causal, kv_lens=kv_lens))
    for m in mods:
        m.rms_norm = rn.rms_norm_ref
    try:
        yield
    finally:
        common.flash_attention = saved[0]
        for m, fn in zip(mods, saved[1]):
            m.rms_norm = fn


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
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import data_for, load_params
    from repro_torch.models.registry import build_model
    from repro_torch.obs import profile_session
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
    # step 1's gradients, the mesh phase's yardstick, on the disk the
    # ranks read
    ref = {"dir": tempfile.mkdtemp(prefix="chip_smoke_mesh_ref_"),
           "loss1": float(loss_k)}
    ckpt.save(ref["dir"], 1, {"grads": grads})
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
                if s < MESH_STEPS:
                    ref.setdefault("grad_norms", []).append(
                        float(met["grad_norm"]))
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
        ref["losses"] = losses[:MESH_STEPS]
        # the step's work from the dry-run (FlopCounterMode over the
        # port's forward and backward on the meta device), over its time
        flops = dryrun.model_flops(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
        step_s = run["train_s"] / TRAIN_STEPS
        rate = flops / step_s / 1e12
        print(f"  dry-run model_flops of one step ({TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens, {cfg.n_layers} layers): {flops} = "
              f"{flops / 1e12:.4f} TFLOP; measured {step_s * 1e3:.2f} ms a "
              f"step (the mean of {TRAIN_STEPS}) = {rate:.2f} TFLOP/s = "
              f"{100 * rate / BF16_PEAK_TFLOPS:.2f}% of "
              f"{BF16_PEAK_TFLOPS} TFLOP/s bf16 on {nvidia_smi()}",
              flush=True)
        check(flops > 0, "the dry-run counted no work in a train step")

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
                if s > RESUME_AT:
                    p, o, met = step_fn(p, o, batches[s])
                    out.append(float(met["loss"]))
                    continue
                # where a train step's time goes: the first resumed step
                # under torch.profiler (the same step, the same bits)
                torch.cuda.synchronize()
                with profile_session(logdir) as prof:
                    t0 = time.perf_counter()
                    p, o, met = step_fn(p, o, batches[s])
                    out.append(float(met["loss"]))
                    torch.cuda.synchronize()
                    run["profile"] = (prof, (time.perf_counter() - t0) * 1e3)
            return out, p, o

        logdir = Path(__file__).resolve().parent / "src" / "repro_torch" \
            / "build" / "profile_train"
        (resumed, p, o), counts["checkpoint resume"] = counted(kernels,
                                                               resume)
        del restored
        phase(f"profile: train step {RESUME_AT + 1} (resumed), {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens")
        report_profile(*run.pop("profile"), 1, "train step", top=14)
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
    return counts, ref


# the families trained on the card, at full width cut in depth only:
# (arch, config overrides, tokens per row); 4 rows (TRAIN_BATCH) a step,
# qwen2-vl-2b's with 256 stub patches before its tokens and whisper-small's
# beside 1536 stub frames
FAMILY_TRAIN = (("qwen2-vl-2b", dict(n_layers=2), 256),
                ("hymba-1.5b", dict(n_layers=2), 512),
                # 4 layers: layer 3 is the sLSTM block (slstm_every 4).  In
                # f32: the mLSTM's normaliser max(|q . n|, 1) has a kink, so
                # the model's gradient is not continuous in its inputs, and
                # a bf16 rounding that moves a normaliser across 1 moves
                # the gradient by percents (the reference's bf16 step lies
                # 15-27% from its f32 step on the CPU, as the port's);
                # tests/test_torch_mesh_train_families.py holds the port's
                # bf16 gradients to the reference's block by block
                ("xlstm-350m", dict(n_layers=4, dtype="float32"), 512),
                ("whisper-small", dict(n_layers=2, n_encoder_layers=2), 256),
                # capacity factor 16: nothing drops, on one device or a mesh
                ("qwen2-moe-a2.7b", dict(n_layers=2, moe_capacity_factor=16.0),
                 512))
FAMILY_STEPS = 2
FAMILY_TRAIN_OVER = {arch: over for arch, over, _ in FAMILY_TRAIN}
# the kernels each family's train step runs: hymba's windowed attention
# and whisper's cross attention run plain PyTorch, whisper normalises with
# layer_norm, xlstm has no attention
FAMILY_KERNELS = {
    "qwen2-vl-2b": ("flash_attention", "flash_attention_bwd", "rms_norm",
                    "rms_norm_bwd"),
    "hymba-1.5b": ("rms_norm", "rms_norm_bwd"),
    "xlstm-350m": ("rms_norm", "rms_norm_bwd"),
    "whisper-small": ("flash_attention", "flash_attention_bwd"),
    "qwen2-moe-a2.7b": ("flash_attention", "flash_attention_bwd",
                        "rms_norm", "rms_norm_bwd")}


def family_cfg(arch, over):
    from repro_torch.configs import ARCHS
    return ARCHS[arch].scaled(**over)


def family_batch(cfg, step, t, dev, mesh=None):
    """Global batch ``step`` of a family's train cell: data hosts 0 and 1's
    rows of ``t`` tokens end to end, with the VLM's patches and whisper's
    frames (seeded normal draws on the card, bf16); on a ``mesh`` the rows
    of its data coordinate."""
    from repro_torch.launch.serve import data_for

    data = data_for(cfg)
    halves = [data.batch(step, TRAIN_BATCH // 2, t, host=h, n_hosts=2)
              for h in (0, 1)]
    out = {k: torch.as_tensor(np.concatenate([h[k] for h in halves]),
                              device=dev) for k in halves[0]}
    gen = torch.Generator(device=dev).manual_seed(7000 + step)
    extra = {"vlm": ("patches", cfg.patch_len),
             "audio": ("frames", cfg.encoder_len)}.get(cfg.family)
    if extra is not None:
        out[extra[0]] = torch.randn((TRAIN_BATCH, extra[1], cfg.d_model),
                                    generator=gen, device=dev).to(
                                        torch.bfloat16)
    if mesh is not None:
        n = TRAIN_BATCH // mesh.size("data")
        d = mesh.index("data")
        out = {k: v[d * n:(d + 1) * n] for k, v in out.items()}
    return out


@contextlib.contextmanager
def blocked_aux(n_data, n_model):
    """The MoE FFN on one device with its aux loss as a mesh takes it: the
    mean of ``_route``'s aux over the (data rows, model tokens) blocks of an
    (n_data, n_model) mesh, each rank's own; the output is the local
    path's.  The single-device yardstick of MoE mesh training (its loss,
    gradients and aux)."""
    from repro_torch.models import moe

    local, route = moe.moe_ffn, moe._route

    def ffn(x, router_w, wg, wu, wd, cfg, collect=False):
        y, _, stats = moe.moe_ffn_local(x, router_w, wg, wu, wd, cfg,
                                        collect)
        b, t = x.shape[0] // n_data, x.shape[1] // n_model
        aux = [route(x[i * b:(i + 1) * b, j * t:(j + 1) * t]
                          .reshape(-1, x.shape[-1]), router_w,
                          cfg.n_experts, cfg.experts_per_token)[2]
               for i in range(n_data) for j in range(n_model)]
        return y, torch.stack(aux).mean(), stats

    moe.moe_ffn = ffn
    try:
        yield
    finally:
        moe.moe_ffn = local


def family_mesh_shapes(cfg):
    """The meshes a family trains on in the mesh phase: (1, 2) and (2, 1);
    MoE at (1, 2) only (its (2, 1) gathers ~0.55 G expert parameters a layer
    over gloo through the host each way; tests/test_torch_mesh_train_
    families.py holds it on the CPU)."""
    return MESH_SHAPES[:1] if cfg.family == "moe" else MESH_SHAPES


def family_train_paths(dev, kernels):
    """Training of the vlm, hybrid, ssm, audio and MoE families on the card,
    one device (:data:`FAMILY_TRAIN`: full width, 2 layers, xlstm 4,
    whisper 2 + 2; seed-0 weights, bf16, xlstm's f32; batches of 4 rows):
    step 1's gradients with the kernels held per leaf against the same
    step through the plain versions (``plain_kernels``; TRAIN_GRAD_TOL,
    TRAIN_GRAD_TOL_F32 in f32), every leaf
    non-zero; FAMILY_STEPS AdamW steps, after which batch 1's loss has
    fallen; the launches of flash_attention / _bwd and rms_norm / _bwd,
    each > 0 where :data:`FAMILY_KERNELS` says the family runs it.  The
    mesh phase's yardstick is written to the disk the ranks read: step 1's
    gradients and the steps' losses and grad_norms (MoE's with the aux
    over the (1, 2) mesh's token halves, :func:`blocked_aux`).  Returns
    ({path: launch counts}, {arch: yardstick})."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import (TrainConfig, make_loss_fn,
                                           make_train_step, value_and_grad)

    counts, refs = {}, {}
    for arch, over, t in FAMILY_TRAIN:
        cfg = family_cfg(arch, over)
        phase(f"families: train {arch} on one device ({cfg.n_layers} layers"
              f"{', ' + str(cfg.n_encoder_layers) + ' encoder' if cfg.n_encoder_layers else ''}"
              f", {TRAIN_BATCH} x {t} tokens)")
        model = build_model(cfg)
        tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=TRAIN_STEPS)
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, device=dev)
        n_params = sum(p.numel() for _, p in leaves_with_keys(params))
        loss_fn = make_loss_fn(model, tcfg.moe_aux_coef)
        batches = [family_batch(cfg, s, t, dev) for s in range(FAMILY_STEPS)]
        run = {}

        routes = []

        def train():
            t0 = time.perf_counter()
            with routing(record=routes):
                (loss, _), grads = value_and_grad(loss_fn, params,
                                                  batches[0])
            torch.cuda.synchronize()
            run["grad_s"] = time.perf_counter() - t0
            step_fn, opt = make_train_step(model, tcfg)
            p, st, mets = params, opt.init(params), []
            for s in range(FAMILY_STEPS):
                t0 = time.perf_counter()
                p, st, met = step_fn(p, st, batches[s])
                mets.append({k: float(met[k]) for k in
                             ("loss", "grad_norm", "moe_aux")})
                torch.cuda.synchronize()
                run.setdefault("step_s", []).append(
                    time.perf_counter() - t0)
            with torch.no_grad():
                after = float(loss_fn(p, batches[0])[0])
            return float(loss), grads, mets, after

        (loss_k, grads, mets, after), counts[arch] = counted(kernels, train)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the plain run takes the kernel run's expert choices (a bf16 router
        # near a tie picks another expert for another rounding)
        with plain_kernels(), routing(replay=list(routes)):
            (loss_p, _), plain = value_and_grad(loss_fn, params, batches[0])
        plain = dict(leaves_with_keys(plain))
        rels = {}
        for key, g in leaves_with_keys(grads):
            check(bool(torch.isfinite(g).all()), f"{arch}: grad {key} not "
                                                 f"finite")
            check(bool((g != 0).any()), f"{arch}: grad {key} is zero")
            rels[key] = float((g.float() - plain[key].float()).norm()
                              / plain[key].float().norm())
        worst = max(rels, key=rels.get)
        tol = TRAIN_GRAD_TOL_F32 if cfg.dtype == "float32" else TRAIN_GRAD_TOL
        del plain
        launches = {n: counts[arch].get(k.symbol, 0)
                    for n, k in train_kernels().items()}
        tokens = FAMILY_STEPS * TRAIN_BATCH * t
        print(f"  {n_params / 1e9:.3f} B parameters; step 1 loss "
              f"{loss_k:.5f} (plain {float(loss_p):.5f}); {len(rels)} "
              f"gradient leaves non-zero, worst ||grad - plain|| / ||plain|| "
              f"{rels[worst]:.3e} ({worst}; limit {tol}, {cfg.dtype}); all "
              f"{ {k: round(v, 5) for k, v in rels.items()} }", flush=True)
        print(f"  {FAMILY_STEPS} steps: losses "
              f"{[m['loss'] for m in mets]}, grad_norms "
              f"{[m['grad_norm'] for m in mets]}, moe_aux "
              f"{[m['moe_aux'] for m in mets]}; batch 1's loss after them "
              f"{after:.5f}; value_and_grad {run['grad_s']:.3f} s, steps "
              f"{[round(x, 3) for x in run['step_s']]} s ({tokens} tokens); "
              f"peak {peak:.2f} GiB; launches {launches}", flush=True)
        check(rels[worst] <= tol, f"{arch}: step 1's gradients differ from "
                                  f"the plain versions'")
        check(after < loss_k, f"{arch}: the loss did not fall in "
                              f"{FAMILY_STEPS} steps")
        for name in FAMILY_KERNELS[arch]:
            check(launches[name] > 0, f"{arch}: {name} not launched")
        ref = {"dir": tempfile.mkdtemp(prefix="chip_smoke_family_ref_"),
               "loss1": loss_k, "metrics": mets, "dtype": cfg.dtype}
        if cfg.family == "moe":
            # the (1, 2) mesh's aux: each rank's over its token half; the
            # expert choices of step 1, which the ranks replay (their bf16
            # router inputs differ by roundings, and a choice near a tie
            # flips)
            moe_routes = []
            with blocked_aux(1, TP_RANKS), routing(record=moe_routes):
                (loss_b, _), grads = value_and_grad(loss_fn, params,
                                                    batches[0])
            ref["routes"] = [r.cpu() for r in moe_routes]
            with blocked_aux(1, TP_RANKS):
                step_fn, opt = make_train_step(model, tcfg)
                p, st, mets = params, opt.init(params), []
                for s in range(FAMILY_STEPS):
                    p, st, met = step_fn(p, st, batches[s])
                    mets.append({k: float(met[k]) for k in
                                 ("loss", "grad_norm", "moe_aux")})
                del p, st
            ref.update(loss1=float(loss_b), metrics=mets)
            print(f"  the (1, {TP_RANKS}) mesh's yardstick (aux over each "
                  f"rank's token half): step 1 loss {float(loss_b):.5f}, "
                  f"losses {[m['loss'] for m in mets]}, moe_aux "
                  f"{[m['moe_aux'] for m in mets]}", flush=True)
        t0 = time.perf_counter()
        ckpt.save(ref["dir"], 1, {"grads": grads})
        print(f"  step 1's gradients saved for the mesh ranks in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        refs[arch] = ref
        del params, grads, batches
        gc_collect()
    return counts, refs


# limit on a later step's |mesh - single| / |single| grad_norm for these
# families (step 1's and every loss keep MESH_LOSS_TOL): AdamW's first
# step moves each weight by about lr whatever its gradient's size, so the
# f32 roundings that flip a near-zero gradient's sign put the mesh and one
# device at other weights for step 2, and xlstm's gates turn that into
# 6.6e-4 (1, 2) and 5.4e-4 (2, 1) of grad_norm on its f32 seed-0 weights
# (1.57e-3 and 1.6e-4 on the bf16 ones cast to f32; the card) while its
# loss agrees to 3e-6.  The control, a step 2 that reports step 1's
# grad_norm (an update that moved nothing), misses every family's limit:
# xlstm's reads 7.8e-2
LATER_NORM_TOL = {"xlstm-350m": 4e-3}


def train_kernels() -> dict:
    """The kernels of a train step, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as rn
    return {"flash_attention": fa.KERNEL, "flash_attention_bwd":
            fa.KERNEL_BWD, "rms_norm": rn.KERNEL,
            "rms_norm_bwd": rn.KERNEL_BWD}


def gc_collect():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5b: training on a mesh (2 ranks sharing the card over gloo)
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, TP_RANKS), (TP_RANKS, 1))     # (data, model)
# (pod, data, model): the same 2 ranks as (TP_RANKS, 1)'s data group, so
# the same rows, collectives and bits
POD_SHAPE = (TP_RANKS, 1, 1)
MESH_STEPS = 3
MESH_TIMEOUT = 600
# limit on |mesh - single-device| / |single-device| of each step's loss
# and grad_norm: the mesh sums partial products and gradients rounded to
# bf16 (a row-parallel product's partial sums, the data ranks' gradients)
# where one device rounds once, which read at most 2.5e-5 on the H100.  A
# mesh whose AdamW step changed nothing would miss it: the single-device
# losses move 3e-3 and 9e-3 from step 1 by step 2 and 3, and a gradient
# taken at step-1 weights gives another grad_norm
MESH_LOSS_TOL = 1e-3


def rank_routes(routes, mesh, t):
    """This rank's block of each MoE layer's recorded expert choices
    (``routes``: (TRAIN_BATCH * t, k) each, one device's), in the order
    the rank routes them: its data coordinate's rows, and on ``model``
    its part of the sequence (:func:`~repro_torch.models.moe.moe_ffn`)."""
    n, p = TRAIN_BATCH // mesh.size("data"), t // mesh.size("model")
    d, i = mesh.index("data"), mesh.index("model")
    return [r.reshape(TRAIN_BATCH, t, -1)[d * n:(d + 1) * n,
                                          i * p:(i + 1) * p]
            .reshape(n * p, -1).to(mesh.device) for r in routes]


def family_mesh_rank(mesh, refs):
    """The families' part of the mesh phase on this rank (after the dense
    checks, in the same spawn): for each family of :data:`FAMILY_TRAIN` and
    each of its :func:`family_mesh_shapes`, seed-0 params cut to this
    rank's shards and FAMILY_STEPS steps on this rank's rows of the
    single-device phase's batches, step 1 as its two halves
    (``make_grad_fn``, then ``opt.update``; MoE on the yardstick's expert
    choices, :func:`rank_routes`), its gradients gathered to rank
    0 and held per leaf against the single-device step's (read from the
    disk); losses, grad_norms and aux, collectives per step, kernel
    launches, GiB per rank (the state after set-up, each part's peak) and
    each step's seconds.  Rank 0's numbers."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import collectives
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import meta_tree
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                           make_train_step, param_specs,
                                           shard_params)

    def gib(n):
        return n / 2**30

    dev = mesh.device
    kernels = train_kernels()
    out = {}
    for arch, over, t in FAMILY_TRAIN:
        cfg = family_cfg(arch, over)
        model = build_model(cfg)
        tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=TRAIN_STEPS)
        lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
        want = None
        if mesh.rank == 0:
            t0 = time.perf_counter()
            want = dict(leaves_with_keys(ckpt.restore(
                refs[arch]["dir"], 1, {"grads": meta_tree(model)},
                device="cpu")["grads"]))
            read_s = time.perf_counter() - t0
        for shape in family_mesh_shapes(cfg):
            m = (mesh if shape == tuple(mesh.shape.values())
                 else make_local_mesh(*shape, device=dev))
            gc_collect()
            torch.cuda.reset_peak_memory_stats()
            run = {"ref_read_s": read_s} if mesh.rank == 0 else {}
            t_run = t0 = time.perf_counter()
            params = shard_params(model, model.init(0, device=dev), m)
            step_fn, opt = make_train_step(model, tcfg, mesh=m)
            opt_state = opt.init(params)
            specs = param_specs(model, m)
            batches = [family_batch(cfg, s, t, dev, mesh=m)
                       for s in range(FAMILY_STEPS)]
            torch.cuda.synchronize()
            run["setup_s"] = time.perf_counter() - t0
            mem = {"state": gib(torch.cuda.memory_allocated()),
                   "setup_peak": gib(torch.cuda.max_memory_allocated())}
            for k in kernels.values():
                k.launches = 0
            collectives.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with routing(replay=rank_routes(refs[arch].get("routes", []),
                                            m, t)):
                grads, met = make_grad_fn(model, tcfg, m)(params,
                                                          batches[0])
            torch.cuda.synchronize()
            mem["grad_peak"] = gib(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            params, opt_state, gnorm = opt.update(
                grads, opt_state, params, lr_fn(opt_state.step + 1), mesh=m,
                specs=specs)
            torch.cuda.synchronize()
            mem["update_peak"] = gib(torch.cuda.max_memory_allocated())
            step_s = [time.perf_counter() - t0]
            mets = [{"loss": float(met["loss"]), "grad_norm": float(gnorm),
                     "moe_aux": float(met["moe_aux"])}]
            counts = [{k: c["calls"] for k, c in
                       collectives.counts().items()}]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            host = ckpt.gather_to_host(grads, m, specs)
            if host is not None:
                run["grad_rel"] = {}
                for key, g in leaves_with_keys(host):
                    w_ = want[key].to(dev).float()
                    g = g.to(dev).float()
                    check(bool((g != 0).any()), f"{arch} {shape}: grad "
                                                f"{key} is zero")
                    run["grad_rel"][key] = float((g - w_).norm()
                                                 / w_.norm())
            run["gather_s"] = time.perf_counter() - t0
            mem["gather_peak"] = gib(torch.cuda.max_memory_allocated())
            del host, grads
            torch.cuda.reset_peak_memory_stats()
            for s in range(1, FAMILY_STEPS):
                collectives.reset_counts()
                t0 = time.perf_counter()
                params, opt_state, met = step_fn(params, opt_state,
                                                 batches[s])
                mets.append({k: float(met[k]) for k in
                             ("loss", "grad_norm", "moe_aux")})
                step_s.append(time.perf_counter() - t0)
                counts.append({k: c["calls"] for k, c in
                               collectives.counts().items()})
            mem["steps_peak"] = gib(torch.cuda.max_memory_allocated())
            peaks = [None] * mesh.n_ranks
            torch.distributed.all_gather_object(peaks, mem)
            run.update(metrics=mets, counts=counts, step_s=step_s,
                       launches={n: k.launches for n, k in kernels.items()},
                       mem_gib=peaks, wall_s=time.perf_counter() - t_run)
            out[(arch, shape)] = run
            del params, opt_state, batches
        del want
    return out


def mesh_train_rank(mesh, cfg, tcfg, ref_dir, ckpt_root, family_refs):
    """One rank of the mesh phase: for each of MESH_SHAPES and POD_SHAPE
    over the same 2 ranks, seed-0 params cut to this rank's shards and
    MESH_STEPS steps on this rank's rows of the train phase's batches
    (losses, grad_norm, collectives per step, kernel launches, memory: the
    state after set-up, its bytes beside the dry-run's prediction, and the
    peak of each part of a step).  Step 1 runs as
    the train step's two halves (``make_grad_fn``, then ``opt.update`` at
    the schedule's first lr), so its gradient can be read: every leaf
    gathered on rank 0 and held against the single-device step's by
    relative norm.  At (1, 2) the gather is ``gather_to_host``; at (2, 1)
    it is the mesh save of the gradient (``save_async``: the gather in this
    thread, rank 0's write behind steps 2..3), read back after the steps
    whole on rank 0's card (its cut == rank 0's shards bit for bit) and
    with the mesh's specs on the other rank (== its shards).  At POD_SHAPE
    the gather is ``gather_to_host`` again, and rank 0 also holds it bit
    for bit against (2, 1)'s.  Rank 0's numbers are the phase's."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import collectives
    from repro_torch.dist._tree import leaves_with_keys
    from repro_torch.dist.sharding import cut_tensor
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import data_for
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.trainer import (data_rank, make_grad_fn,
                                           make_train_step, param_specs,
                                           shard_params)

    def gib(n):
        return n / 2**30

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    model = build_model(cfg)
    data = data_for(cfg)
    lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    kernels = train_kernels()
    want = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        want = ckpt.restore(ref_dir, 1,
                            {"grads": model.init(device="meta")},
                            device="cpu")["grads"]
        want = dict(leaves_with_keys(want))
        ref_read_s = time.perf_counter() - t0

    def against_single(host):
        """{leaf: ||mesh - single|| / ||single||} of gathered gradients"""
        rels = {}
        for key, g in leaves_with_keys(host):
            w_ = want[key].to(dev).float()
            g = g.to(dev).float()
            check(bool((g != 0).any()), f"grad {key} is zero")
            rels[key] = float((g - w_).norm() / w_.norm())
        return rels

    out, grads_dp = {}, None
    for shape in MESH_SHAPES + (POD_SHAPE,):
        if shape == tuple(mesh.shape.values()):
            m = mesh
        elif shape == POD_SHAPE:
            m = make_local_mesh(*shape[1:], device=dev, pod=shape[0])
        else:
            m = make_local_mesh(*shape, device=dev)
        saved = shape == (TP_RANKS, 1)
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        run = {"ref_read_s": ref_read_s} if mesh.rank == 0 else {}
        t0 = time.perf_counter()
        params = shard_params(model, model.init(0, device=dev), m)
        step_fn, opt = make_train_step(model, tcfg, mesh=m)
        opt_state = opt.init(params)
        specs = param_specs(model, m)
        g_specs = {f"['grads']{k}": v for k, v in specs.items()}
        d, n_data = data_rank(m)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                    data.batch(s, TRAIN_BATCH // n_data, TRAIN_SEQ, host=d,
                               n_hosts=n_data).items()}
                   for s in range(MESH_STEPS)]
        torch.cuda.synchronize()
        run["setup_s"] = time.perf_counter() - t0
        mem = {"state": gib(torch.cuda.memory_allocated()),
               "setup_peak": gib(torch.cuda.max_memory_allocated())}
        # this rank's state against the dry-run's prediction (a meta run
        # of the step on rank 0's shards: the ranks' shards are alike)
        t0 = time.perf_counter()
        want_mem = dryrun.train_record(
            cfg, shape, TRAIN_BATCH, TRAIN_SEQ,
            moment_dtype=tcfg.moment_dtype, remat=cfg.remat)["memory"]
        run["state_bytes"] = dryrun.tree_bytes({"params": params,
                                                "opt": opt_state})
        run["dryrun_state_bytes"] = want_mem["params"] + want_mem["opt"]
        run["dryrun_s"] = time.perf_counter() - t0
        check(run["state_bytes"] == run["dryrun_state_bytes"],
              f"mesh {shape} rank {mesh.rank}: state of "
              f"{run['state_bytes']} bytes, the dry-run predicts "
              f"{run['dryrun_state_bytes']}")
        for k in kernels.values():
            k.launches = 0
        collectives.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads, met = make_grad_fn(model, tcfg, m)(params, batches[0])
        torch.cuda.synchronize()
        mem["grad_peak"] = gib(torch.cuda.max_memory_allocated())
        mem["with_grads"] = gib(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, gnorm = opt.update(
            grads, opt_state, params, lr_fn(opt_state.step + 1), mesh=m,
            specs=specs)
        losses, norms = [float(met["loss"])], [float(gnorm)]
        step_s = [time.perf_counter() - t0]
        mem["update_peak"] = gib(torch.cuda.max_memory_allocated())
        step1 = collectives.counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if saved:
            ckpt.save_async(ckpt_root, 1, {"grads": grads}, mesh=m,
                            specs=g_specs)
        else:
            host = ckpt.gather_to_host(grads, m, specs)
            if host is not None:
                run["grad_rel"] = against_single(host)
                if shape == POD_SHAPE:
                    run["grads_equal_dp"] = all(
                        torch.equal(g, grads_dp[k])
                        for k, g in leaves_with_keys(host))
            del host
        run["gather_s"] = time.perf_counter() - t0
        mem["gather_peak"] = gib(torch.cuda.max_memory_allocated())
        collectives.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        for s in range(1, MESH_STEPS):
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, batches[s])
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
        mem["steps_peak"] = gib(torch.cuda.max_memory_allocated())
        peaks = [None] * mesh.n_ranks
        torch.distributed.all_gather_object(peaks, mem)
        run.update(train_s=sum(step_s), step_s=step_s, losses=losses,
                   grad_norms=norms, step1_collectives=step1,
                   collectives=collectives.counts(),
                   launches={n: k.launches for n, k in kernels.items()},
                   mem_gib=peaks)
        if saved:
            t0 = time.perf_counter()
            ckpt.wait_pending()
            torch.distributed.barrier()
            run["save_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if mesh.rank == 0:
                whole = ckpt.restore(ckpt_root, 1, {"grads": grads},
                                     device=dev)
                run["restored_bits"] = all(
                    torch.equal(cut_tensor(a, g_specs.get(k), m), b)
                    for (k, a), (_, b) in zip(leaves_with_keys(whole),
                                              leaves_with_keys(
                                                  {"grads": grads})))
                run["restore_s"] = time.perf_counter() - t0
                run["grad_rel"] = against_single(whole["grads"])
                run["ckpt_gb"] = os.path.getsize(os.path.join(
                    ckpt_root, "step_00000001", "data.bin")) / 1e9
                # the pod mesh's gathered gradients are held to these
                grads_dp = {k: g.to("cpu") for k, g in
                            leaves_with_keys(whole["grads"])}
                del whole
            else:
                back = ckpt.restore(ckpt_root, 1, {"grads": grads},
                                    device=dev, mesh=m, specs=g_specs)
                check(all(torch.equal(a, b) for (_, a), (_, b) in zip(
                    leaves_with_keys(back), leaves_with_keys(
                        {"grads": grads}))),
                      f"rank {mesh.rank}: the mesh save restored with the "
                      f"mesh's specs differs from its shards")
                del back
        del params, opt_state, batches, grads
        out[shape] = run
    del grads_dp
    out["families"] = family_mesh_rank(mesh, family_refs)
    return out


def mesh_train_paths(dev, ref, family_refs):
    """Training on a mesh at llama3-8b width (the train phase's 2 layers,
    seed-0 weights, its first MESH_STEPS batches of 4 x 512 tokens) over 2
    ranks that share the card over gloo: mesh (1, 2) (tensor parallel),
    (2, 1) (FSDP + data parallel) and the pod mesh (2, 1, 1) (batch and
    FSDP over pod x data) in one spawn.  The pod mesh's losses, grad_norms
    and step 1's gathered gradients equal (2, 1)'s bit for bit (its data
    group has the same 2 ranks in the same order).  On every mesh, each
    rank's state (params + moments) has exactly the bytes the dry-run
    predicts (``dryrun.train_record``).  Each of the MESH_STEPS
    losses and grad_norms against the single-device run's (MESH_LOSS_TOL),
    step 1's gathered gradients per leaf against the single-device step's
    (TRAIN_GRAD_TOL), a loss that falls over the steps, collectives per
    step against ``step_collectives`` (the formula the tests hold), a mesh
    save (rank 0 writes) restored bit for bit (:func:`mesh_train_rank`).
    The tokens/s is that of 2 ranks on one card with host-staged
    collectives, not a TP or DP speed.  Returns {row name: launches} for
    the mesh route rows."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import spawn
    from repro_torch.train.trainer import TrainConfig, step_collectives

    phase(f"main path: training on a mesh, (1, {TP_RANKS}), "
          f"({TP_RANKS}, 1) and (pod, data, model) {POD_SHAPE} (2 ranks "
          f"sharing the card over gloo)")
    cfg = ARCHS["llama3-8b"].scaled(n_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(lr=1e-3, warmup=5, total_steps=TRAIN_STEPS)
    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        t0 = time.perf_counter()
        got = spawn(mesh_train_rank, (1, TP_RANKS), "gloo", store, cfg, tcfg,
                    ref["dir"], ckpt_root, family_refs, device="cuda",
                    timeout=MESH_TIMEOUT)
        spawn_s = time.perf_counter() - t0
    finally:
        for path in [store, ckpt_root, ref["dir"]] + [
                r["dir"] for r in family_refs.values()]:
            shutil.rmtree(path, ignore_errors=True)
    print(f"  2 ranks on {torch.cuda.get_device_name(0)}: spawn to exit "
          f"{spawn_s:.2f} s; rank 0 read the single-device step-1 gradients "
          f"in {got[MESH_SHAPES[0]]['ref_read_s']:.2f} s", flush=True)
    tokens = MESH_STEPS * TRAIN_BATCH * TRAIN_SEQ

    def rel(a, b):
        return abs(a - b) / abs(b)

    for shape in MESH_SHAPES + (POD_SHAPE,):
        run = got[shape]
        worst = max(run["grad_rel"].values())
        key = max(run["grad_rel"], key=run["grad_rel"].get)
        run["loss_rel"] = [rel(a, b) for a, b in zip(run["losses"],
                                                     ref["losses"])]
        run["norm_rel"] = [rel(a, b) for a, b in zip(run["grad_norms"],
                                                     ref["grad_norms"])]
        print(f"  mesh {shape}: losses {run['losses']} (single "
              f"{ref['losses']}; step 1's value_and_grad {ref['loss1']}), "
              f"rel {[f'{x:.3e}' for x in run['loss_rel']]}; grad_norms "
              f"{run['grad_norms']} (single {ref['grad_norms']}), rel "
              f"{[f'{x:.3e}' for x in run['norm_rel']]}; limit "
              f"{MESH_LOSS_TOL}", flush=True)
        print(f"    step 1's {len(run['grad_rel'])} gathered gradient leaves "
              f"against single-device: worst ||mesh - single|| / ||single|| "
              f"{worst:.3e} ({key}; limit {TRAIN_GRAD_TOL}); all: "
              f"{ {k: round(v, 5) for k, v in run['grad_rel'].items()} }",
              flush=True)
        mem = run["mem_gib"]
        print(f"    {tokens} tokens in "
              f"{run['train_s']:.2f} s = {tokens / run['train_s']:.0f} "
              f"tokens/s (2 ranks on one card, host-staged collectives: not "
              f"a TP or DP speed; steps "
              f"{[round(x, 2) for x in run['step_s']]} s); setup "
              f"{run['setup_s']:.2f} s, step 1's gradient gathered to rank 0 "
              f"in {run['gather_s']:.2f} s", flush=True)
        print(f"    GiB per rank: state after set-up (params + AdamW "
              f"moments) {[round(x['state'], 2) for x in mem]}; peak of "
              f"set-up {[round(x['setup_peak'], 2) for x in mem]}, of step "
              f"1's forward + backward {[round(x['grad_peak'], 2) for x in mem]}"
              f" (then {[round(x['with_grads'], 2) for x in mem]} held with "
              f"the gradients), of its AdamW update "
              f"{[round(x['update_peak'], 2) for x in mem]}, of the gradient "
              f"gather {[round(x['gather_peak'], 2) for x in mem]}, of steps "
              f"2..{MESH_STEPS} {[round(x['steps_peak'], 2) for x in mem]}; "
              f"peak {[round(max(v for v in x.values()), 2) for x in mem]}",
              flush=True)
        print(f"    rank 0's state: {run['state_bytes']} bytes of params + "
              f"AdamW moments, the dry-run's prediction "
              f"{run['dryrun_state_bytes']} bytes (dryrun.train_record, a "
              f"meta run of {run['dryrun_s']:.2f} s; every rank checked "
              f"its own); torch.cuda.memory_allocated after set-up "
              f"{round(mem[0]['state'] * 2**30)} bytes", flush=True)
        # steps 2..MESH_STEPS through train_step, step 1 through its halves
        later = MESH_STEPS - 1
        run["per_step"] = {k: c["calls"] / later
                           for k, c in run["collectives"].items()}
        run["per_step_1"] = {k: float(c["calls"])
                             for k, c in run["step1_collectives"].items()}
        elements = {k: c["elements"] // later
                    for k, c in run["collectives"].items()}
        print(f"    collectives per step {run['per_step']} (the tests' "
              f"formula {step_collectives(cfg.n_layers, shape)}); elements "
              f"per step {elements}; rank 0's launches {run['launches']}",
              flush=True)
    last = got[(TP_RANKS, 1)]
    print(f"  mesh {(TP_RANKS, 1)} save_async of step 1's gradients "
          f"({last['ckpt_gb']:.2f} GB): the gather {last['gather_s']:.2f} s "
          f"in the caller's thread, rank 0's write then "
          f"{last['save_wait_s']:.2f} s past steps 2..{MESH_STEPS}; "
          f"restored whole on rank 0's card in "
          f"{last['restore_s']:.2f} s and cut, bit for bit with rank 0's "
          f"shards {last['restored_bits']} (rank 1: with the mesh's specs, "
          f"checked in the rank)", flush=True)
    pod, dp = got[POD_SHAPE], got[(TP_RANKS, 1)]
    print(f"  pod mesh {POD_SHAPE} against {(TP_RANKS, 1)}: losses equal "
          f"bit for bit {pod['losses'] == dp['losses']}, grad_norms "
          f"{pod['grad_norms'] == dp['grad_norms']}, step 1's "
          f"{len(pod['grad_rel'])} gathered gradient leaves "
          f"{pod['grads_equal_dp']}", flush=True)
    check(pod["losses"] == dp["losses"]
          and pod["grad_norms"] == dp["grad_norms"],
          f"pod mesh {POD_SHAPE}: losses / grad_norms differ from "
          f"{(TP_RANKS, 1)}'s")
    check(pod["grads_equal_dp"], f"pod mesh {POD_SHAPE}: step 1's "
          f"gradients differ from {(TP_RANKS, 1)}'s")
    for shape in MESH_SHAPES + (POD_SHAPE,):
        run = got[shape]
        check(run["state_bytes"] == run["dryrun_state_bytes"],
              f"mesh {shape}: rank 0's state bytes differ from the "
              f"dry-run's")
        check(len(run["loss_rel"]) == len(run["norm_rel"]) == MESH_STEPS
              and max(run["loss_rel"] + run["norm_rel"]) <= MESH_LOSS_TOL,
              f"mesh {shape}: a loss or grad_norm differs from "
              f"single-device")
        check(rel(run["losses"][0], ref["loss1"]) <= MESH_LOSS_TOL,
              f"mesh {shape}: step 1's loss differs from single-device's "
              f"value_and_grad")
        check(max(run["grad_rel"].values()) <= TRAIN_GRAD_TOL,
              f"mesh {shape}: step 1's gradients differ from single-device")
        check(run["losses"][-1] < run["losses"][0],
              f"mesh {shape}: the loss did not fall in {MESH_STEPS} steps")
        formula = {k: float(v) for k, v in step_collectives(
            cfg.n_layers, shape).items()}
        check(run["per_step"] == formula == run["per_step_1"],
              f"mesh {shape}: collectives per step {run['per_step']}, "
              f"step 1 {run['per_step_1']}")
        for name in ("flash_attention", "flash_attention_bwd", "rms_norm",
                     "rms_norm_bwd"):
            check(run["launches"][name] > 0,
                  f"mesh {shape}: {name} not launched")
    check(last["restored_bits"], "the mesh checkpoint differs from the "
                                 "shards")
    family_mesh_report(got["families"], family_refs)
    return {"flash_attention_bwd_tp2":
            got[(1, TP_RANKS)]["launches"]["flash_attention_bwd"],
            "rms_norm_bwd_dp2": got[(TP_RANKS, 1)]["launches"]["rms_norm_bwd"]}


def family_mesh_report(got, refs):
    """The families' mesh runs (:func:`family_mesh_rank`) against their
    single-device yardsticks: each step's loss and grad_norm within
    MESH_LOSS_TOL, step 1's gathered gradients within TRAIN_GRAD_TOL per
    leaf, the collectives of each step equal to the model's
    ``train_collectives``, the kernels of :data:`FAMILY_KERNELS` launched;
    GiB per rank and seconds printed."""
    from repro_torch.models.registry import build_model

    phase(f"main path: the families trained on a mesh, (1, {TP_RANKS}) and "
          f"({TP_RANKS}, 1) (MoE (1, {TP_RANKS})), in the mesh phase's spawn")
    tokens = {arch: TRAIN_BATCH * t for arch, _, t in FAMILY_TRAIN}
    for (arch, shape), run in got.items():
        cfg = family_cfg(arch, FAMILY_TRAIN_OVER[arch])
        want = refs[arch]["metrics"]
        loss_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                    for g, w in zip(run["metrics"], want)]
        norm_rel = [abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                    for g, w in zip(run["metrics"], want)]
        worst = max(run["grad_rel"], key=run["grad_rel"].get)
        formula = build_model(cfg).train_collectives(shape)
        mem = run["mem_gib"]
        print(f"  {arch} {shape} ({refs[arch]['dtype']}): losses "
              f"{[m['loss'] for m in run['metrics']]} (single "
              f"{[m['loss'] for m in want]}), rel "
              f"{[f'{x:.3e}' for x in loss_rel]}; grad_norms rel "
              f"{[f'{x:.3e}' for x in norm_rel]} (limits {MESH_LOSS_TOL}, "
              f"later steps' grad_norms "
              f"{LATER_NORM_TOL.get(arch, MESH_LOSS_TOL)}); "
              f"moe_aux {[m['moe_aux'] for m in run['metrics']]} (single "
              f"{[m['moe_aux'] for m in want]})", flush=True)
        print(f"    step 1's {len(run['grad_rel'])} gathered gradient leaves: "
              f"worst ||mesh - single|| / ||single|| "
              f"{run['grad_rel'][worst]:.3e} ({worst}; limit "
              f"{TRAIN_GRAD_TOL}); gathered to rank 0 in "
              f"{run['gather_s']:.2f} s", flush=True)
        print(f"    collectives per step {run['counts']} (the model's "
              f"train_collectives {formula}); rank 0's launches "
              f"{run['launches']}", flush=True)
        print(f"    {run['wall_s']:.2f} s in all (rank 0 read the "
              f"yardstick in {run['ref_read_s']:.2f} s); steps "
              f"{[round(x, 3) for x in run['step_s']]} s for "
              f"{tokens[arch]} tokens each (2 ranks on one card, host-staged "
              f"collectives); setup {run['setup_s']:.2f} s; GiB per rank: "
              f"state {[round(x['state'], 2) for x in mem]}, peaks of "
              f"set-up {[round(x['setup_peak'], 2) for x in mem]}, step 1's "
              f"forward + backward {[round(x['grad_peak'], 2) for x in mem]},"
              f" its update {[round(x['update_peak'], 2) for x in mem]}, the "
              f"gradient gather {[round(x['gather_peak'], 2) for x in mem]},"
              f" step 2 {[round(x['steps_peak'], 2) for x in mem]}",
              flush=True)
        later = LATER_NORM_TOL.get(arch, MESH_LOSS_TOL)
        control = abs(want[0]["grad_norm"] - want[1]["grad_norm"]) / abs(
            want[1]["grad_norm"])
        print(f"    control: a step 2 reporting step 1's grad_norm would "
              f"read {control:.3e} (limit {later})", flush=True)
        check(control > later, f"{arch}: the later steps' grad_norm limit "
                               f"does not tell step 2 from step 1")
        check(len(loss_rel) == FAMILY_STEPS
              and max(loss_rel + norm_rel[:1]) <= MESH_LOSS_TOL
              and max(norm_rel[1:]) <= later,
              f"{arch} {shape}: a loss or grad_norm differs from "
              f"single-device")
        check(run["grad_rel"][worst] <= TRAIN_GRAD_TOL,
              f"{arch} {shape}: step 1's gradients differ from "
              f"single-device")
        check(run["counts"] == [formula] * FAMILY_STEPS,
              f"{arch} {shape}: collectives per step {run['counts']}")
        for name in FAMILY_KERNELS[arch]:
            check(run["launches"][name] > 0,
                  f"{arch} {shape}: {name} not launched")


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
    pk_counts, tp_launches = packed_checkpoint_path(dev, kernels, model,
                                                    qparams, reqs, results)
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
            if sym in launches:
                launches[sym] += n
    print(f"  max_memory_allocated over all paths: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_phase(eng, data, Request)
    return launches, {"quant_error": qe_keys, "tp": tp_launches}


# ---------------------------------------------------------------------------
# Phase 5c: the MoE family, qwen2-moe-a2.7b at full width and depth
# ---------------------------------------------------------------------------

MOE_PROMPTS = (12, 60, 150, 300)   # the one-slot plain vs spec serve


@contextlib.contextmanager
def swapped(*names):
    """Set each (module, attribute, value) inside the with-block."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in names]
    for mod, attr, value in names:
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def _experts_f64(x, qt):
    """quant_matmul_experts_ref with the products accumulated in f64 (no
    act_scale: the forward check's weights are RTN)."""
    from repro_torch.kernels.ref import dequant_ref
    return torch.stack([(x[e].double() @ dequant_ref(
        qt.codes[e], qt.scale[e], qt.zero[e], x.shape[-1]).double()
    ).to(x.dtype) for e in range(qt.codes.shape[0])])


def plain_expert_products(f64=False):
    """The MoE blocks' expert products on their plain version (in f64
    with ``f64``)."""
    from repro_torch.kernels.ref import quant_matmul_experts_ref
    from repro_torch.models import moe
    return swapped((moe, "quant_matmul_experts",
                    _experts_f64 if f64 else quant_matmul_experts_ref))


@contextlib.contextmanager
def plain_moe_kernels():
    """:func:`plain_kernels`, and also the MoE blocks' rms_norm, every
    packed linear (quant_matmul) and the expert products
    (quant_matmul_experts) swapped for their plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models import moe

    with plain_kernels(), plain_expert_products(), swapped(
            (moe, "rms_norm", rn.rms_norm_ref),
            (ops, "_quant_matmul_kernel", qm.quant_matmul_ref)):
        yield


def routing(record=None, replay=None):
    """Record each MoE layer's expert choice (``record``), or replay the
    recorded ones in order (``replay``), with the gates recomputed from
    this run's own router logits at those experts.  A bf16 router near a
    tie picks another expert for a different rounding of its input; the
    replay holds two runs to the same routes, so they compare the
    arithmetic."""
    from repro_torch.models import moe

    plain_route = moe._route

    def route(x_flat, router_w, n_real, k):
        probs, topi, aux = plain_route(x_flat, router_w, n_real, k)
        if record is not None:
            record.append(topi)
        if replay is not None:
            topi = replay.pop(0)
            logits = (x_flat @ router_w.to(x_flat.dtype)).float()
            probs = torch.softmax(logits.gather(1, topi), dim=-1)
        return probs, topi, aux

    return swapped((moe, "_route", route))


def tree_gb(tree) -> float:
    from repro_torch.dist._tree import leaves_with_keys
    return sum(v.numel() * v.element_size()
               for _, v in leaves_with_keys(tree)) / 1e9


def moe_paths(dev, kernels):
    """qwen2-moe-a2.7b at full width and depth on the card (24 layers, d
    2048, 16 heads of 128, 60 experts padded to 64, top-4, d_ff 1408, one
    shared expert of 5632, vocab 151936, bf16), random weights from seed
    0: a 2-layer cut's forward held against the plain versions; then
    calibrate on 16 x 512 tokens (one batch: capacity 683), FAQ (γ 0.85,
    window 3) per (layer, expert), int4 pack (g = 64); the FAQ int8 self-
    draft; one slot serving 4 requests plain and speculative (k 3), bit
    for bit; four slots serving the 8 requests of the dense run; and
    ``paged=True`` serving from the dense cache.  Returns {path: launch
    counts}."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.core import (DEFAULT_ALPHA_GRID, QuantSpec,
                                  quantize_model, report_summary,
                                  run_calibration)
    from repro_torch.data.synthetic import calibration_batches
    from repro_torch.launch.serve import data_for
    from repro_torch.models.registry import build_model
    from repro_torch.serve.draft import self_int8_draft
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = ARCHS["qwen2-moe-a2.7b"]
    spec = QuantSpec(bits=4, group_size=64)
    data = data_for(full)
    print(f"  config: {full.name} d_model={full.d_model} heads={full.n_heads}"
          f" kv_heads={full.n_kv_heads} head_dim={full.head_dim_} experts="
          f"{full.n_experts} (padded to {MOE_EXPERTS}) top-"
          f"{full.experts_per_token} d_ff={full.d_ff} shared="
          f"{full.shared_expert_ff} vocab={full.vocab_size} layers="
          f"{full.n_layers} dtype={full.dtype}; token ids capped at "
          f"{data.cfg.vocab_size}; memory allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    counts, times = {}, {}

    phase("MoE: 2-layer cut at full width, kernels against plain versions")
    cfg2 = full.scaled(n_layers=2)
    m2 = build_model(cfg2)
    p2 = m2.init(0, device=dev)
    q2, _ = quantize_model(p2, m2.quant_site_map(), None, method="rtn",
                           spec=spec, mode="packed")
    del p2
    toks = torch.as_tensor(np.stack([data.sequence(50_000_000 + i, 512)
                                     for i in range(4)]), device=dev)
    v = full.vocab_size
    routes = []
    with routing(record=routes):
        got, got_aux = m2.forward(q2, {"tokens": toks})
    got = got[..., :v].float()
    check(bool(torch.isfinite(got).all()), "MoE logits are not finite")
    # Every kernel swapped for its plain version: each bf16 kernel is held
    # to BF16_REL_TOL against its plain version, and their differences add
    # up over the cut's layers.  The expert products alone: the grouped
    # launch differs from its plain version by f32 summation order, which
    # the bf16 chain of two layers amplifies; the same plain version
    # accumulating in f64 (another exact order, no kernel) shows by how
    # much, and the limit is BF16_REL_TOL.
    readings = {}
    for name, plain, tol in (
            ("every kernel plain", plain_moe_kernels,
             BF16_REL_TOL * cfg2.n_layers),
            ("quant_matmul_experts plain", plain_expert_products,
             BF16_REL_TOL),
            ("quant_matmul_experts plain in f64",
             lambda: plain_expert_products(f64=True), None)):
        replay = list(routes)
        with plain(), routing(replay=replay):
            want, want_aux = m2.forward(q2, {"tokens": toks})
        check(not replay, "the plain forward did not replay every route")
        want = readings[name] = want[..., :v].float()
        if tol is None:     # the f64 plain version against the f32 one
            ref32 = readings["quant_matmul_experts plain"]
            rel = float((want - ref32).norm() / ref32.norm())
            print(f"  logits: the plain expert products accumulated in f64 "
                  f"against f32: rel_err {rel:.3e} (the bf16 chain's "
                  f"response to another exact summation order)",
                  flush=True)
            continue
        rel = float((got - want).norm() / want.norm())
        print(f"  logits (4 x 512 tokens) against {name}: rel_err "
              f"{rel:.3e} (tol {tol:.0e}), max_abs_err "
              f"{float((got - want).abs().max()):.3e}; moe_aux "
              f"{float(got_aux['moe_aux']):.6f} vs "
              f"{float(want_aux['moe_aux']):.6f}", flush=True)
        check(rel <= tol, f"MoE forward disagrees with {name}")
    del m2, q2, got, want, routes, readings
    gc.collect()
    torch.cuda.empty_cache()

    phase("MoE main path: qwen2-moe-a2.7b calibrate -> FAQ -> int4 pack -> "
          "serve")
    model = build_model(full)
    reqs1 = [Request(rid=i, prompt=data.sequence(60_000_000 + i, n),
                     max_new_tokens=NEW_TOKENS)
             for i, n in enumerate(MOE_PROMPTS)]
    reqs8 = [Request(rid=i, prompt=data.sequence(40_000_000 + i, n),
                     max_new_tokens=NEW_TOKENS)
             for i, n in enumerate(PROMPT_LENS)]

    def quantize_path():
        t0 = time.perf_counter()
        params = model.init(0, device=dev)
        torch.cuda.synchronize()
        times["init"] = time.perf_counter() - t0
        print(f"  float weights {tree_gb(params):.2f} GB", flush=True)
        t0 = time.perf_counter()
        stats = run_calibration(model.forward, params, calibration_batches(
            data, 16, 512, batch_size=16))
        torch.cuda.synchronize()
        times["calibrate"] = time.perf_counter() - t0
        for site, st in stats.items():
            for key, val in st.items():
                check(bool(torch.isfinite(val).all()),
                      f"MoE stat {site}/{key} not finite")
        t0 = time.perf_counter()
        qparams, report = quantize_model(params, model.quant_site_map(),
                                         stats, method="faq", spec=spec,
                                         mode="packed")
        torch.cuda.synchronize()
        times["faq_pack"] = time.perf_counter() - t0
        del params
        return stats, qparams, report

    (stats, qparams, report), counts["MoE calibrate + FAQ + pack"] = \
        counted(kernels, quantize_path)
    gc.collect()
    torch.cuda.empty_cache()
    grid = torch.tensor(DEFAULT_ALPHA_GRID)
    n_l = full.n_layers
    for path, rep in report.items():
        alpha = rep["alpha"].cpu()
        check(bool(torch.isin(alpha, grid).all()), f"{path}: alpha off grid")
        check(bool((rep["loss"] <= rep["rtn_loss"] * (1 + 1e-5)).all()),
              f"{path}: searched loss above the RTN loss")
        if path.endswith("_exp"):
            check(tuple(alpha.shape) == (n_l, MOE_EXPERTS),
                  f"{path}: alpha {tuple(alpha.shape)}")
            leaf = qparams["blocks"][path.split("/")[1]]
            check(tuple(leaf.codes.shape[:2]) == (n_l, MOE_EXPERTS)
                  and tuple(leaf.act_scale.shape[:2]) == (n_l, MOE_EXPERTS),
                  f"{path}: packed leaf {tuple(leaf.codes.shape)}")
    for path, s in report_summary(report).items():
        print(f"  {path}: mean alpha {s['mean_alpha']:.3f}, loss "
              f"{s['mean_loss']:.4e} vs RTN {s['mean_rtn_loss']:.4e} "
              f"({100 * s['improvement_vs_rtn']:.1f}% better)", flush=True)
    print(f"  packed tree {tree_gb(qparams):.2f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    draft = self_int8_draft(model, qparams, stats)
    torch.cuda.synchronize()
    times["draft"] = time.perf_counter() - t0
    del stats

    phase("MoE main path: one slot, 4 requests, plain vs spec (self-int8, "
          "k 3)")
    plain_eng = ServeEngine(model, qparams, n_slots=1, max_len=512,
                            device=dev)
    (plain1, _, plain_s), counts["MoE plain serve, 1 slot"] = counted(
        kernels, lambda: timed_serve("MoE plain serve, 1 slot", plain_eng,
                                     reqs1))
    spec_eng = ServeEngine(model, qparams, n_slots=1, max_len=512, device=dev,
                           spec=SpecConfig(k=3, draft=draft))
    (spec1, _, spec_s), counts["MoE spec serve, 1 slot"] = counted(
        kernels, lambda: timed_serve("MoE spec serve, 1 slot", spec_eng,
                                     reqs1))
    m = spec_eng.metrics()
    same = [np.array_equal(spec1[r.rid], plain1[r.rid]) for r in reqs1]
    print(f"  spec: accept_rate {m['accept_rate']:.3f}, spec cycles "
          f"{m['spec_cycles']}, {spec_s:.2f} s against the plain run's "
          f"{plain_s:.2f} s; tokens equal the plain serve's bit for bit: "
          f"{sum(same)}/{len(reqs1)}", flush=True)
    check(all(same), "MoE spec serve differs from the plain serve")
    check(m["spec_cycles"] > 0, "MoE: no spec cycle ran")
    del spec_eng, draft, plain_eng
    gc.collect()
    torch.cuda.empty_cache()

    phase("MoE main path: four slots, the 8 requests of the dense run")
    eng4 = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev)
    (out4, m4, sec4), counts["MoE serve, 4 slots"] = counted(
        kernels, lambda: timed_serve("MoE serve, 4 slots", eng4, reqs8))
    for rid, toks_ in out4.items():
        check(bool((toks_ >= 0).all() and (toks_ < full.vocab_size).all()),
              f"MoE req {rid}: token outside the vocabulary")
    paged = ServeEngine(model, qparams, n_slots=1, max_len=512, device=dev,
                        paged=True)
    print(f"  paged=True: engine.paged {paged.paged} (serves from the dense "
          f"cache, as the reference's MoE)", flush=True)
    check(not paged.paged and not model.supports_paged(),
          "MoE paged=True did not fall back to the dense stepper")
    print(f"  MoE phase seconds: " + ", ".join(f"{k} {v:.2f}"
                                               for k, v in times.items()))
    print(f"  MoE max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 5d: the VLM and hybrid families at full width and half depth
# ---------------------------------------------------------------------------

HYMBA_LONG, HYMBA_LONG_MAX = 2200, 2304   # the ring wraps; T > 2 x window
# the families' serving paths (calibrate -> FAQ -> pack -> serve, and their
# tensor-parallel phase) at full width and half their depth: at full
# depth, with the families' training, the script read 1,234.2 s at
# LAYERS 10 on a slow host (~350 s of it these paths, host-bound per
# layer); every layer of a family has the same shapes (xlstm keeps its
# sLSTM every 4th layer)
FAMILY_SERVE_DEPTH = {"qwen2-vl-2b": dict(n_layers=14),
                      "hymba-1.5b": dict(n_layers=16),
                      "xlstm-350m": dict(n_layers=12),
                      "whisper-small": dict(n_layers=6, n_encoder_layers=6)}


def family_serve_cfg(arch):
    """The config of a family's serving paths (:data:`FAMILY_SERVE_DEPTH`)."""
    from repro_torch.configs import ARCHS
    return ARCHS[arch].scaled(**FAMILY_SERVE_DEPTH[arch])


def quantize_family(model, dev, batches, times, spec):
    """init -> calibrate on ``batches`` -> FAQ (γ 0.85, window 3) -> int4
    pack, with each step's seconds in ``times``; checks the statistics,
    that every α is on the grid and no searched loss is above RTN's.
    Returns (qparams, report, the float params, the stats)."""
    from repro_torch.core import (DEFAULT_ALPHA_GRID, quantize_model,
                                  report_summary, run_calibration)

    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    times["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = run_calibration(model.forward, params, batches)
    torch.cuda.synchronize()
    times["calibrate"] = time.perf_counter() - t0
    for site, st in stats.items():
        for key, val in st.items():
            check(bool(torch.isfinite(val).all()),
                  f"{model.cfg.name} stat {site}/{key} not finite")
    t0 = time.perf_counter()
    qparams, report = quantize_model(params, model.quant_site_map(), stats,
                                     method="faq", spec=spec, mode="packed")
    torch.cuda.synchronize()
    times["faq_pack"] = time.perf_counter() - t0
    grid = torch.tensor(DEFAULT_ALPHA_GRID)
    check(sorted(report) == sorted("/".join(p) for p in
                                   model.quant_site_map()),
          f"{model.cfg.name}: report sites {sorted(report)}")
    for path, rep in report.items():
        check(bool(torch.isin(rep["alpha"].cpu(), grid).all()),
              f"{path}: alpha off grid")
        check(bool((rep["loss"] <= rep["rtn_loss"] * (1 + 1e-5)).all()),
              f"{path}: searched loss above the RTN loss")
    for path, sm in report_summary(report).items():
        print(f"  {path}: mean alpha {sm['mean_alpha']:.3f}, loss "
              f"{sm['mean_loss']:.4e} vs RTN {sm['mean_rtn_loss']:.4e} "
              f"({100 * sm['improvement_vs_rtn']:.1f}% better)", flush=True)
    print(f"  float weights {tree_gb(params):.2f} GB, packed tree "
          f"{tree_gb(qparams):.2f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return qparams, report, params, stats


def engine_equals_generate(name, eng, reqs, results, times):
    """Every request's engine tokens equal batch-1 ``generate`` bit for
    bit (exact-length admission, batch-invariant decode)."""
    from repro_torch.serve.engine import Request
    t0 = time.perf_counter()
    for r in reqs:
        alone = eng.generate(Request(rid=100 + r.rid, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens))
        first = next((j for j in range(len(alone))
                      if alone[j] != results[r.rid][j]), None)
        check(first is None, f"{name} request {r.rid} ({len(r.prompt)} "
                             f"tokens): engine != generate from token {first}")
    torch.cuda.synchronize()
    times["generate"] = time.perf_counter() - t0
    print(f"  {name}: engine == generate bit for bit for all {len(reqs)} "
          f"requests ({times['generate'] / len(reqs):.2f} s per generate)",
          flush=True)


def serve_exact(dev, kernels, counts, name, model, qparams, data,
                fam_times, **kw):
    """The dense run's 8 requests at 4 slots through the exact-length
    admission, then each against batch-1 ``generate`` bit for bit; the
    launch counts of both go to ``counts``.  Returns (engine, requests,
    results)."""
    from repro_torch.serve.engine import Request, ServeEngine
    reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, n),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]
    eng = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev,
                      **kw)
    check(type(eng._admission.strategies[0]).__name__
          == "SingleAdmission", f"{name}: not the exact-length admission")
    (out, _, sec), counts[f"{name} serve, 4 slots"] = counted(
        kernels, lambda: timed_serve(f"{name} serve, 4 slots", eng, reqs))
    fam_times["serve"] = sec
    _, counts[f"{name} generate"] = counted(
        kernels, lambda: engine_equals_generate(name, eng, reqs, out,
                                                fam_times))
    return eng, reqs, out


def families_paths(dev, kernels, held):
    """qwen2-vl-2b (14 of 28 layers, d 1536, 12/2 heads of 128, d_ff 8960,
    vocab 151936, M-RoPE) and hymba-1.5b (16 of 32 layers, d 1600, 25/5 heads of
    64, d_ff 5504, Mamba state 16, window 1024, vocab 32001) at full width
    and half depth, bf16, random weights from seed 0, ids capped at 4096:
    calibrate -> FAQ -> int4 pack -> serve through the exact-length
    admission at 4 slots, every request == batch-1 ``generate``; the VLM
    also with patches (prefill + 16 decode steps against a teacher-forced
    forward) and with ``spec=`` declined; hymba also a 2,200-token request
    whose ring wraps (against a teacher-forced forward through the
    block-local attention) and ``paged=True`` declined.  Each packed tree
    is saved for the families' TP phase (:func:`hold_for_tp`) with the
    dense run's first 4 requests and their single-device tokens.  Returns
    {path: launch counts} (paths prefixed "VLM" / "hymba")."""
    import gc

    from repro_torch.core import QuantSpec
    from repro_torch.data.synthetic import calibration_batches
    from repro_torch.launch.serve import data_for
    from repro_torch.models.registry import build_model
    from repro_torch.serve.draft import self_int8_draft
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    spec = QuantSpec(bits=4, group_size=64)
    counts = {}

    # -- qwen2-vl-2b ------------------------------------------------------
    phase("families: qwen2-vl-2b calibrate (16 x (256 patches + 256 "
          "tokens)) -> FAQ -> int4 pack")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = family_serve_cfg("qwen2-vl-2b")
    model = build_model(cfg)
    data = data_for(cfg)
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} mrope="
          f"{cfg.mrope_sections} dtype={cfg.dtype}; token ids capped at "
          f"{data.cfg.vocab_size}", flush=True)
    prng = np.random.default_rng(0)
    batches = [dict(b, patches=(prng.standard_normal(
        (VLM_CAL_BATCH, VLM_PATCHES, cfg.d_model)) * 0.1).astype(np.float32))
        for b in calibration_batches(data, VLM_CAL_BATCH, VLM_TOKENS,
                                     batch_size=VLM_CAL_BATCH)]
    vt = {}
    (qparams, *_), counts["VLM calibrate + FAQ + pack"] = counted(
        kernels, lambda: quantize_family(model, dev, batches, vt, spec))
    del batches
    gc.collect()
    hold_for_tp(held, cfg.name, qparams)

    phase("families: qwen2-vl-2b prefill(patches) + 16 decode steps against "
          "a teacher-forced forward")
    prompt = data.sequence(70_000_000, 100)
    patches = torch.as_tensor((prng.standard_normal(
        (1, VLM_PATCHES, cfg.d_model)) * 0.1).astype(np.float32), device=dev)

    def patch_decode():
        cache = model.init_cache(1, VLM_PATCHES + 100 + 16, device=dev)
        logits, cache = model.prefill(qparams, torch.as_tensor(
            prompt, device=dev)[None], cache, patches=patches)
        toks = [int(logits[0, 0, :cfg.vocab_size].argmax())]
        for _ in range(15):
            logits, cache = model.decode_step(qparams, cache, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=dev))
            toks.append(int(logits[0, 0, :cfg.vocab_size].argmax()))
        return np.asarray(toks, np.int32)

    toks, counts["VLM prefill(patches) + decode"] = counted(kernels,
                                                            patch_decode)
    margin, _ = teacher_forced(model, qparams, prompt, toks, dev,
                               extra={"patches": patches})
    print(f"  16 tokens after 256 patches + 100 prompt tokens: worst margin "
          f"{float(margin.max()):.4f} (tol {TIE_TOL})", flush=True)
    check(float(margin.max()) <= TIE_TOL,
          "VLM decode with patches off the teacher-forced argmax")

    phase("families: qwen2-vl-2b serve, 4 slots, the dense run's 8 requests")
    _, reqs, out = serve_exact(dev, kernels, counts, "VLM", model, qparams,
                               data, vt)
    hold_requests(held[cfg.name], reqs, out)
    draft = self_int8_draft(model, qparams)
    eng = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev,
                      spec=SpecConfig(k=3, draft=draft))
    check(eng._spec is None, "VLM: spec= was not declined")
    (spec_out, _, _), counts["VLM serve, spec= declined"] = counted(
        kernels, lambda: timed_serve("VLM serve, spec= declined", eng, reqs))
    same = [np.array_equal(spec_out[r.rid], out[r.rid]) for r in reqs]
    print(f"  spec=: declined ({eng.metrics()['spec']}), tokens equal the "
          f"plain serve's: {sum(same)}/{len(reqs)}", flush=True)
    check(all(same), "VLM: the spec= engine served other tokens")
    print(f"  VLM seconds: " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in vt.items()), flush=True)
    print(f"  VLM max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, qparams, eng, draft
    gc.collect()
    torch.cuda.empty_cache()

    # -- hymba-1.5b -------------------------------------------------------
    phase("families: hymba-1.5b calibrate (16 x 512 tokens) -> FAQ -> int4 "
          "pack")
    torch.cuda.reset_peak_memory_stats()
    cfg = family_serve_cfg("hymba-1.5b")
    model = build_model(cfg)
    data = data_for(cfg)
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} d_ff="
          f"{cfg.d_ff} d_inner={cfg.ssm_expand * cfg.d_model} ssm_state="
          f"{cfg.ssm_state} dt_rank={cfg.dt_rank} window="
          f"{cfg.sliding_window} vocab={cfg.vocab_size} layers="
          f"{cfg.n_layers} dtype={cfg.dtype}; token ids capped at "
          f"{data.cfg.vocab_size}", flush=True)
    ht = {}
    (qparams, report, *_), counts["hymba calibrate + FAQ + pack"] = counted(
        kernels, lambda: quantize_family(
            model, dev, calibration_batches(data, 16, 512, batch_size=16),
            ht, spec))
    check(all(p in report for p in ("blocks/mamba/x_proj",
                                    "blocks/mamba/out_proj")),
          "hymba: the Mamba sites were not quantized")
    gc.collect()
    hold_for_tp(held, cfg.name, qparams)

    phase("families: hymba-1.5b serve, 4 slots, the dense run's 8 requests")
    eng, reqs, out = serve_exact(dev, kernels, counts, "hymba", model,
                                 qparams, data, ht)
    hold_requests(held[cfg.name], reqs, out)
    paged = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev,
                        paged=True)
    print(f"  paged=True: engine.paged {paged.paged} (serves from the dense "
          f"ring cache, as the reference's hymba)", flush=True)
    check(not paged.paged and not model.supports_paged(),
          "hymba paged=True did not fall back to the dense stepper")
    del eng, paged

    phase(f"families: hymba-1.5b, one {HYMBA_LONG}-token request (the ring "
          f"wraps), {NEW_TOKENS} new tokens")
    long_req = Request(rid=0, prompt=data.sequence(80_000_000, HYMBA_LONG),
                       max_new_tokens=NEW_TOKENS)
    eng = ServeEngine(model, qparams, n_slots=1, max_len=HYMBA_LONG_MAX,
                      device=dev)
    (long_out, _, ht["long"]), counts["hymba long request"] = counted(
        kernels, lambda: timed_serve("hymba long request", eng, [long_req]))
    check_teacher_forced("hymba long request (block-local forward)", model,
                         qparams, [long_req], long_out, dev)
    print(f"  hymba seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in ht.items()),
          flush=True)
    print(f"  hymba max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, qparams, eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


XLSTM_PROMPT = 200                 # the teacher-forced xlstm request
# the bf16 decode's rounding noise (RMS of its logits less the f32 run's)
# over the bf16 forward's: 0.99-1.05 in repro and 1.00 in the port on the
# CPU (tests/test_torch_xlstm.py::test_bf16_decode_drift_is_the_references)
XLSTM_BF16_NOISE_RATIO = 1.25


def layer0_alpha_search(name, model, params, stats, spec, kernels):
    """Layer 0's α search of every site of ``model`` with the diagonal loss
    (``search_alpha`` on the card: one quant_error_batch launch per site,
    counted) against ``search_alpha_plain`` (plain PyTorch): the chosen
    and RTN losses within rel 1e-5, the α equal up to such a tie.
    Returns the launch counts."""
    from repro_torch.core.apply import _get_path
    from repro_torch.core.methods import (search_alpha, search_alpha_plain,
                                          site_stat_for_method)

    sites = {}
    for path, site in model.quant_site_map().items():
        stat = stats[site]
        sites["/".join(path)] = (
            _get_path(params, path)[0],
            site_stat_for_method("faq", stat["mean_abs"])[0],
            stat["mean_sq"][0])
    res, counts = counted(kernels, lambda: {
        p: search_alpha(w, a, spec, mean_sq=msq)
        for p, (w, a, msq) in sites.items()})
    same = 0
    for path, (w, a, msq) in sites.items():
        want = search_alpha_plain(w, a, spec, mean_sq=msq)
        got = res[path]
        for what, x, y in (("loss", got.loss, want.loss),
                           ("RTN loss", got.rtn_loss, want.rtn_loss)):
            rel = abs(float(x) - float(y)) / float(y)
            check(rel <= 1e-5, f"{name} {path}: {what} of the kernel's "
                               f"search off the plain search's by {rel:.2e}")
        same += int(float(got.alpha) == float(want.alpha))
    print(f"  {name} layer-0 alpha search through quant_error_batch: "
          f"{len(sites)} sites, losses within rel 1e-5 of the plain "
          f"search's, alpha equal at {same}/{len(sites)} (the rest ties)",
          flush=True)
    return counts


def ssm_audio_paths(dev, kernels, held):
    """xlstm-350m (12 of 24 layers, d 1024, 4 heads, d_inner 2048: mLSTM heads of
    512, sLSTM heads of 256, an sLSTM block every 4th layer, vocab 50304)
    and whisper-small (6 of 12 encoder + 6 of 12 decoder layers, d 768, 12
    heads of 64, d_ff 3072, 1536 frames, vocab 51865) at full width,
    bf16, random weights from seed 0, ids capped at 4096, frames seed-made:
    calibrate -> FAQ -> int4 pack, layer 0's α search through quant_error;
    xlstm then serves the dense run's 8 requests at 4 slots (each ==
    batch-1 ``generate``; ``spec=`` and ``paged=True`` declined with the
    same tokens) and one request through prefill + 32 decode steps against
    a teacher-forced forward (the prefill's token greedy in bf16; every
    token greedy up to ties with f32 activations on the same packed
    weights, where the recurrent step and the chunked forward agree to f32
    rounding; the bf16 decode's noise against f32 within
    XLSTM_BF16_NOISE_RATIO of the bf16 forward's; bf16's drift printed);
    whisper prefills 4 requests with their
    frames together and decodes 32 greedy steps, each request against a
    teacher-forced forward over the same frames (no engine run: the
    engine passes no frames, neither does the reference's).  Each packed
    tree is saved for the families' TP phase (:func:`hold_for_tp`) with
    its single-device tokens.  Returns {path: launch counts} (paths
    prefixed "xlstm" / "whisper")."""
    import gc

    from repro_torch.core import QuantSpec
    from repro_torch.data.synthetic import calibration_batches
    from repro_torch.dist._tree import map_with_keys
    from repro_torch.launch.serve import data_for
    from repro_torch.models.registry import build_model
    from repro_torch.serve.draft import self_int8_draft
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.spec import SpecConfig

    spec = QuantSpec(bits=4, group_size=64)
    counts = {}

    # -- xlstm-350m -------------------------------------------------------
    phase("ssm/audio: xlstm-350m calibrate (16 x 512 tokens) -> FAQ -> "
          "int4 pack, layer-0 alpha search")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = family_serve_cfg("xlstm-350m")
    model = build_model(cfg)
    data = data_for(cfg)
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"d_inner={model._d_inner} (mLSTM head "
          f"{model._d_inner // cfg.n_heads}, sLSTM head "
          f"{cfg.d_model // cfg.n_heads}) slstm_every={cfg.slstm_every} "
          f"vocab={cfg.vocab_size} layers={cfg.n_layers} dtype={cfg.dtype}; "
          f"token ids capped at {data.cfg.vocab_size}", flush=True)
    xt = {}
    (qparams, _, params, stats), counts["xlstm calibrate + FAQ + pack"] = \
        counted(kernels, lambda: quantize_family(
            model, dev, calibration_batches(data, 16, 512, batch_size=16),
            xt, spec))
    counts["xlstm layer-0 alpha search"] = layer0_alpha_search(
        "xlstm", model, params, stats, spec, kernels)
    del params, stats
    gc.collect()
    hold_for_tp(held, cfg.name, qparams)

    phase("ssm/audio: xlstm-350m serve, 4 slots, the dense run's 8 requests; "
          "spec= and paged=True declined")
    _, reqs, out = serve_exact(dev, kernels, counts, "xlstm", model, qparams,
                               data, xt)
    hold_requests(held[cfg.name], reqs, out)
    eng = ServeEngine(model, qparams, n_slots=4, max_len=1024, device=dev,
                      paged=True, spec=SpecConfig(
                          k=3, draft=self_int8_draft(model, qparams)))
    check(eng._spec is None and not eng.paged,
          "xlstm: spec= or paged=True was not declined")
    (other, _, _), counts["xlstm serve, spec= and paged=True declined"] = \
        counted(kernels, lambda: timed_serve(
            "xlstm serve, spec= and paged=True declined", eng, reqs))
    same = [np.array_equal(other[r.rid], out[r.rid]) for r in reqs]
    print(f"  spec= / paged=True: declined, tokens equal the plain serve's: "
          f"{sum(same)}/{len(reqs)}", flush=True)
    check(all(same), "xlstm: the declining engine served other tokens")
    del eng

    phase(f"ssm/audio: xlstm-350m one {XLSTM_PROMPT}-token request, prefill "
          f"+ {NEW_TOKENS} decode steps against a teacher-forced forward, "
          f"bf16 and f32 activations")
    prompt = data.sequence(90_000_000, XLSTM_PROMPT)

    def recurrent_decode(mdl, params, fed=None):
        """Prefill + decode steps, greedy or fed the tokens ``fed``: (the
        greedy tokens, the logits (N, V))."""
        cache = mdl.init_cache(1, XLSTM_PROMPT + NEW_TOKENS, device=dev)
        logits, cache = mdl.prefill(params, torch.as_tensor(
            prompt, device=dev)[None], cache)
        rows = [logits[0, 0, :cfg.vocab_size].float()]
        toks = [int(rows[-1].argmax())]
        for j in range(NEW_TOKENS - 1):
            nxt = toks[-1] if fed is None else int(fed[j])
            logits, cache = mdl.decode_step(params, cache, torch.tensor(
                [[nxt]], dtype=torch.int32, device=dev))
            rows.append(logits[0, 0, :cfg.vocab_size].float())
            toks.append(int(rows[-1].argmax()))
        torch.cuda.synchronize()
        return np.asarray(toks, np.int32), torch.stack(rows)

    def against_forward(mdl, params, toks, rows):
        """Per token: |decode logits - forward logits| at most, and the
        margin of the token under the teacher-forced forward; and the
        forward's logits (N, V)."""
        seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)
        full = mdl.forward(params, {"tokens": torch.as_tensor(
            seq, device=dev)[None]})[0][0, XLSTM_PROMPT - 1:,
                                        :cfg.vocab_size].float()
        chosen = full.gather(1, torch.as_tensor(
            toks, device=dev, dtype=torch.long)[:, None])[:, 0]
        return ((rows - full).abs().amax(-1).cpu().numpy(),
                (full.amax(-1) - chosen).cpu().numpy(), full)

    t0 = time.perf_counter()
    (toks, rows), counts["xlstm prefill + decode"] = counted(
        kernels, lambda: recurrent_decode(model, qparams))
    xt["one request"] = time.perf_counter() - t0
    drift, margin, _ = against_forward(model, qparams, toks, rows)
    print(f"  bf16: {NEW_TOKENS} tokens after a {XLSTM_PROMPT}-token prompt "
          f"in {xt['one request']:.2f} s; the prefill's token margin "
          f"{float(margin[0]):.4f} (tol {TIE_TOL}); decode vs forward "
          f"logits max |diff| every 8 steps "
          f"{[round(float(d), 4) for d in drift[::8]]}, worst margin "
          f"{float(margin.max()):.4f} (not held to TIE_TOL: the reference's "
          f"own bf16 decode and forward part by more)", flush=True)
    check(float(margin[0]) <= TIE_TOL,
          "xlstm prefill's token off the teacher-forced argmax")
    # the same packed weights with f32 activations: the two formulations
    # agree to f32 rounding, so every token must be greedy up to ties
    model32 = build_model(cfg.scaled(dtype="float32"))
    params32 = map_with_keys(
        lambda _, t: t.float() if t.is_floating_point() else t, qparams)
    toks32, rows32 = recurrent_decode(model32, params32)
    drift32, margin32, full32 = against_forward(model32, params32, toks32,
                                                rows32)
    print(f"  f32 activations: decode vs forward logits max |diff| "
          f"{float(drift32.max()):.3e}, worst margin "
          f"{float(margin32.max()):.4f} (tol {TIE_TOL}); tokens equal to "
          f"bf16's: {int((toks32 == toks).sum())}/{NEW_TOKENS}", flush=True)
    check(float(margin32.max()) <= TIE_TOL,
          "xlstm f32 decode off the teacher-forced argmax")
    # bf16 against f32, both fed the f32 run's tokens: the served decode's
    # rounding noise may not exceed the forward's by more than the
    # reference's own spread
    _, rows16 = recurrent_decode(model, qparams, fed=toks32)
    _, _, full16 = against_forward(model, qparams, toks32, rows16)
    rms = lambda a, b: float((a - b).pow(2).mean().sqrt())
    noise_dec, noise_fwd = rms(rows16, rows32), rms(full16, full32)
    print(f"  bf16 rounding noise (RMS of bf16 - f32 logits): decode "
          f"{noise_dec:.4f}, forward {noise_fwd:.4f}, ratio "
          f"{noise_dec / noise_fwd:.4f} (limit {XLSTM_BF16_NOISE_RATIO})",
          flush=True)
    check(noise_dec <= XLSTM_BF16_NOISE_RATIO * noise_fwd,
          "xlstm bf16 decode noisier than the bf16 forward")
    del model32, params32, rows16, full16, full32
    print(f"  xlstm seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in xt.items()),
          flush=True)
    print(f"  xlstm max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, qparams
    gc.collect()
    torch.cuda.empty_cache()

    # -- whisper-small ----------------------------------------------------
    phase(f"ssm/audio: whisper-small calibrate ({WHISPER_CAL_BATCH} x "
          f"({WHISPER_FRAMES} frames + {WHISPER_CAL_TOKENS} tokens)) -> FAQ "
          f"-> int4 pack, layer-0 alpha search")
    torch.cuda.reset_peak_memory_stats()
    cfg = family_serve_cfg("whisper-small")
    model = build_model(cfg)
    data = data_for(cfg)
    print(f"  config: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim_} d_ff="
          f"{cfg.d_ff} encoder layers={cfg.n_encoder_layers} frames="
          f"{cfg.encoder_len} decoder layers={cfg.n_layers} vocab="
          f"{cfg.vocab_size} dtype={cfg.dtype}; token ids capped at "
          f"{data.cfg.vocab_size}", flush=True)
    frng = np.random.default_rng(0)
    frames_of = lambda b: (frng.standard_normal(
        (b, cfg.encoder_len, cfg.d_model)) * 0.1).astype(np.float32)
    batches = [dict(b, frames=frames_of(WHISPER_CAL_BATCH))
               for b in calibration_batches(data, WHISPER_CAL_BATCH,
                                            WHISPER_CAL_TOKENS,
                                            batch_size=WHISPER_CAL_BATCH)]
    wt = {}
    (qparams, _, params, stats), counts["whisper calibrate + FAQ + pack"] = \
        counted(kernels, lambda: quantize_family(model, dev, batches, wt,
                                                 spec))
    counts["whisper layer-0 alpha search"] = layer0_alpha_search(
        "whisper", model, params, stats, spec, kernels)
    del params, stats, batches
    gc.collect()

    phase(f"ssm/audio: whisper-small prefill(frames) of 4 x "
          f"{WHISPER_PROMPT}-token requests + {NEW_TOKENS} greedy steps "
          f"against teacher-forced forwards")
    prompts = np.stack([data.sequence(95_000_000 + i, WHISPER_PROMPT)
                        for i in range(4)]).astype(np.int32)
    frames = torch.as_tensor(frames_of(4), device=dev)

    def encode_decode():
        cache = model.init_cache(4, WHISPER_PROMPT + NEW_TOKENS, device=dev)
        logits, cache = model.prefill(qparams, torch.as_tensor(
            prompts, device=dev), cache, frames=frames)
        toks = [logits[:, 0, :cfg.vocab_size].argmax(-1).int()]
        t0 = time.perf_counter()
        for _ in range(NEW_TOKENS - 1):
            logits, cache = model.decode_step(qparams, cache, toks[-1][:, None])
            toks.append(logits[:, 0, :cfg.vocab_size].argmax(-1).int())
        torch.cuda.synchronize()
        wt["decode"] = time.perf_counter() - t0
        return torch.stack(toks, 1).cpu().numpy()

    t0 = time.perf_counter()
    toks, counts["whisper prefill(frames) + decode"] = counted(kernels,
                                                               encode_decode)
    wt["prefill + decode"] = time.perf_counter() - t0
    print(f"  4 requests: prefill + {NEW_TOKENS} tokens each in "
          f"{wt['prefill + decode']:.2f} s; {NEW_TOKENS - 1} decode steps at "
          f"B 4: {4 * (NEW_TOKENS - 1) / wt['decode']:.1f} tok/s", flush=True)
    worst = 0.0
    for i in range(4):
        margin, _ = teacher_forced(model, qparams, prompts[i], toks[i], dev,
                                   extra={"frames": frames[i:i + 1]})
        worst = max(worst, float(margin.max()))
    print(f"  every request greedy up to ties against a teacher-forced "
          f"forward over its frames: worst margin {worst:.4f} (tol "
          f"{TIE_TOL})", flush=True)
    check(worst <= TIE_TOL, "whisper decode off the teacher-forced argmax")
    hold_for_tp(held, cfg.name, qparams, prompts=prompts,
                frames=frames.cpu().numpy(), tokens=toks)
    print(f"  whisper seconds: " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in wt.items()),
          flush=True)
    print(f"  whisper max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# candidates whose kernel loss lies within this of the kernel's minimum are
# scored by the plain version too (see full_search_path)
SCREEN = 3e-5


def full_search_path(kernels, model, params, stats):
    """full_search_faq (paper Eq. 8) over the main path's layers and 7
    sites on the calibration statistics, the diagonal loss: one
    quant_error_batch launch per ((γ, j), layer, site), counted.  Then the
    plain search's choice per (layer, site): the kernel's losses of every
    candidate are recomputed (outside the count); the plain version scores
    every candidate of the first and last layer, and elsewhere those
    within SCREEN of the kernel's minimum.  Every plain loss must be
    within 1e-5 of the kernel's (the kernel's terms are the plain
    version's bits, only their sum's order differs), so a candidate
    outside the screen lies above
    the plain minimum and the plain argmin over the screened candidates,
    first (γ, j) then first α on ties, is the full plain search's.  The
    kernel's choice must be that one or lose at most 1e-5 relative to
    it, and each layer's loss must be at most the presearched (γ 0.85,
    j 3) loss.  Returns (counts, keys for quant_error's kernel row)."""
    from repro_torch.core import QuantSpec
    from repro_torch.core.methods import (FULL_SEARCH_GAMMAS,
                                          FULL_SEARCH_WINDOWS,
                                          full_search_faq)

    phase(f"main path: full_search_faq (paper Eq. 8), {LAYERS} layers x 7 "
          f"sites")
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
    (``results``) bit for bit; then the tensor-parallel phase's ranks
    restore the same save (:func:`tp_paths`).  Returns (launch counts,
    the TP route rows' launches)."""
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
        tp_launches = tp_paths(dev, model, qparams, reqs, results, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, tp_launches


# ---------------------------------------------------------------------------
# Phase 5a: tensor-parallel serving, 2 ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# the TP phase's requests: the dense run's first 4, on 2 slots, so each
# slot is retired and admitted again under the mesh.  All 8 at 4 slots
# read 164 s of phase and 1,046.8 s of script on the H100, near the
# limit's margin, so the phase serves 4, bf16 and int8 KV alike
TP_REQUESTS = 4
TP_SLOTS = 2
TP_TIMEOUT = 600


def _tp_kernels():
    """The kernels a rank of the TP phase launches, by row name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qm
    return {"quant_matmul": qm.KERNEL,
            "quant_matmul_experts": qm.KERNEL_EXPERTS,
            "flash_decode": fd.KERNEL, "flash_decode_q8": fd.KERNEL_Q8,
            "flash_decode_paged": fd.KERNEL_PAGED,
            "flash_decode_paged_q8": fd.KERNEL_PAGED_Q8,
            "flash_attention": fa.KERNEL}


def _rank_counted(fn):
    """``fn()`` with this rank's launch and collective counters zeroed
    just before it; returns (its result, {kernel: launches}, {kernel:
    {route: launches}}, collective counts)."""
    from repro_torch.dist import collectives
    kernels = _tp_kernels()
    for k in kernels.values():
        k.launches = 0
        k.routes.clear()
    collectives.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, {n: k.launches for n, k in kernels.items()},
            {n: dict(k.routes) for n, k in kernels.items()},
            collectives.counts())


def tp_rank_serve(mesh, ckpt_dir, skeleton, cfg, reqs, moe_cfg, late_s):
    """One rank of the TP phase: restore the packed tree saved by the phase
    before (on the host), serve the requests dense and paged with the bf16
    and the int8 KV cache, each engine cutting its own shards, then open
    loop (:func:`_tp_rank_open_loop`); then MoE expert parallelism on the
    2-layer cut.  Rank 0's numbers are the phase's."""
    import gc

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    whole = ckpt.restore(ckpt_dir, 0, {"qparams": skeleton},
                         device="cpu")["qparams"]
    out = {"restore_s": time.perf_counter() - t0}
    model = build_model(cfg)
    model8 = build_model(cfg.scaled(kv_cache_bits=8))
    for name, mdl, rs, paged in (("dense", model, reqs, False),
                                 ("paged", model, reqs, True),
                                 ("int8 dense", model8, reqs, False),
                                 ("int8 paged", model8, reqs, True)):
        t0 = time.perf_counter()
        eng = ServeEngine(mdl, whole, n_slots=TP_SLOTS, max_len=1024,
                          paged=paged, mesh=mesh, device=mesh.device)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, launches, routes, coll = _rank_counted(lambda: eng.serve([
            Request(rid=r, prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for r, p, n in rs]))
        m = eng.metrics()
        out[name] = dict(
            tokens={r: res[r].tolist() for r in res}, place_s=place_s,
            serve_s=time.perf_counter() - t0, launches=launches,
            routes=routes, collectives=coll, mesh=m["mesh"],
            decode_steps=m["decode_steps"],
            prefill_batches=m["prefill_batches"],
            tokens_generated=m["tokens_generated"],
            cache_shape=tuple((eng._store if paged else eng._stepper.cache)
                              ["k"].shape))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["open loop"] = _tp_rank_open_loop(mesh, model, whole, reqs, late_s)
    del whole
    gc.collect()
    out["moe"] = _tp_rank_moe(mesh, moe_cfg)
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


# the TP open-loop run: loose deadlines (nothing sheds; the SLO layer
# observes, charges and releases), the main path's fault schedule
TP_DEADLINE_S = 600.0
TP_FAULTS = dict(alloc_fail_at=(3, 30, 90), preempt_at=(40,), stall_at=(20,),
                 stall_s=0.05)


def _tp_rank_open_loop(mesh, model, whole, reqs, late_s):
    """An open-loop run of the TP requests through the paged engine on the
    mesh with ``slo=`` and ``faults=`` (the main path's fault schedule):
    the first two arrive at once, the other two ``late_s`` later.  Every
    rank runs the same loop on rank 0's clock; each reports its outcomes,
    counters and fault counts, whose digests are gathered."""
    from repro_torch.serve import (FaultConfig, FaultInjector, Request,
                                   Scheduler, ServeEngine, SLOConfig)

    eng = ServeEngine(model, whole, n_slots=TP_SLOTS, max_len=1024,
                      paged=True, page_size=16, mesh=mesh,
                      device=mesh.device, slo=SLOConfig(seed=0),
                      faults=FaultInjector(FaultConfig(**TP_FAULTS)))
    trace = [(0.0 if i < 2 else late_s,
              Request(rid=r, prompt=np.asarray(p, np.int32), max_new_tokens=n,
                      rel_deadline=TP_DEADLINE_S))
             for i, (r, p, n) in enumerate(reqs)]
    t0 = time.perf_counter()
    res, launches, routes, coll = _rank_counted(
        lambda: Scheduler(eng).run_traffic(trace))
    seconds = time.perf_counter() - t0
    m = eng.metrics()
    decided = dict(
        tokens={r: res[r].tolist() for r in res},
        outcomes={r.rid: r.outcome for _, r in trace},
        summary={k: v for k, v in res.summary.items()
                 if k not in ("tokens_per_s", "spec")},
        faults=m["faults"],
        counters={k: m[k] for k in ("decode_steps", "prefill_batches",
                                    "preempted", "resumed", "shed",
                                    "shed_retried", "pressure_events")})
    out = dict(decided, seconds=seconds, traffic=res.traffic,
               launches=launches, collectives=coll,
               agree=_agree(mesh, decided))
    del eng
    return out


def _tp_rank_moe(mesh, cfg):
    """MoE expert parallelism on this rank: layer 0 of the 2-layer cut
    (random weights from seed 0, RTN int4 packed alike on every rank), at
    decode (4 tokens, every rank routing all of them) against the local
    path on the same input, and at prefill (4 x 512 tokens, each rank
    routing its 256 sequence positions) against the local path on each
    rank's positions."""
    from repro_torch.core import QuantSpec, quantize_model
    from repro_torch.dist.sharding import (axis_rules, serving_rules,
                                           shard_leaf)
    from repro_torch.models.moe import moe_ffn, moe_ffn_local
    from repro_torch.models.registry import build_model

    dev = mesh.device
    model = build_model(cfg)
    params = model.init(0, device=dev)
    qp, _ = quantize_model(params, model.quant_site_map(), None, method="rtn",
                           spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    del params
    blocks = qp["blocks"]
    router = blocks["router"][0]
    experts = [blocks[key][0] for key in ("wg_exp", "wu_exp", "wd_exp")]
    rules = serving_rules(cfg, mesh)
    local = [shard_leaf(w, ("experts", None, None), mesh, rules)
             for w in experts]
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"experts": int(local[0].codes.shape[0])}
    for name, shape in (("decode", (4, 1, cfg.d_model)),
                        ("prefill", (4, 512, cfg.d_model))):
        h = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        t = shape[1]
        if t % mesh.size("model"):
            want = moe_ffn_local(h, router, *experts, cfg)[0]
        else:
            # the local path on each rank's positions (capacity follows the
            # routed token count, so this is the same routing problem)
            part = t // mesh.size("model")
            want = torch.cat([moe_ffn_local(h[:, i * part:(i + 1) * part],
                                            router, *experts, cfg)[0]
                              for i in range(mesh.size("model"))], dim=1)
        with axis_rules(mesh, rules):
            got, launches, _, coll = _rank_counted(
                lambda: moe_ffn(h, router, *local, cfg)[0])
        out[name] = dict(
            bits=bool(torch.equal(got, want)),
            rel_err=float((got.float() - want.float()).norm()
                          / want.float().norm()),
            finite=bool(torch.isfinite(got).all()),
            launches=launches["quant_matmul_experts"],
            all_to_all=coll["all_to_all"]["calls"])
    del qp, local, experts
    return out


def tp_rank_nccl(mesh):
    """The 1 x 1 NCCL mesh: a tiny model served with ``mesh=`` and without
    (same tokens bit for bit), and each collective once on the 1-rank
    group."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import QuantSpec, quantize_model
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import axis_rules
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = mesh.device
    cfg = ARCHS["llama3-8b"].tiny()
    model = build_model(cfg)
    qp, _ = quantize_model(model.init(0, device=dev), model.quant_site_map(),
                           None, method="rtn",
                           spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    prompts = [np.arange(3 + 5 * i, 20 + 9 * i, dtype=np.int32) % 500
               for i in range(3)]

    def serve(**kw):
        eng = ServeEngine(model, qp, n_slots=2, max_len=64, device=dev, **kw)
        res = eng.serve([Request(rid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)])
        return {r: res[r].tolist() for r in res}

    alone, meshed = serve(), serve(mesh=mesh)
    x = torch.arange(6, dtype=torch.float32, device=dev)
    with axis_rules(mesh):
        back = [collectives.all_reduce(x), collectives.all_gather(x, dim=0),
                collectives.all_to_all(x.reshape(1, 6)).reshape(6),
                collectives.broadcast(x)]
    return dict(backend=mesh.backend, equal=alone == meshed, tokens=meshed,
                collectives=all(bool(torch.equal(y, x)) for y in back))


def _tie_or_equal(name, model, qparams, reqs, want, got, dev):
    """Per request: bit for bit, or parting first at a numerical tie of the
    single-device model (its teacher-forced top-2 gap at that token <=
    TIE_TOL).  Returns (equal, at a tie)."""
    equal = ties = 0
    for r in reqs:
        a, b = np.asarray(want[r.rid]), np.asarray(got[r.rid])
        check(len(b) == len(a), f"{name} request {r.rid}: {len(b)} tokens")
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            equal += 1
            continue
        j = int(diff[0])
        _, gap = teacher_forced(model, qparams, r.prompt, a, dev)
        print(f"  {name} request {r.rid}: parts from single-device at token "
              f"{j}, where the single-device top-2 gap is {gap[j]:.4f}",
              flush=True)
        check(gap[j] <= TIE_TOL, f"{name} request {r.rid}: parts from "
              f"single-device at token {j}, not a tie ({gap[j]:.4f} > "
              f"{TIE_TOL})")
        ties += 1
    return equal, ties


def _skeleton(tree):
    """``tree``'s structure with empty host tensors at the leaves (what
    ``checkpoint.restore`` reads the saved tree's shape from)."""
    from repro_torch.dist import _tree
    return _tree.tree_map(lambda leaf: torch.empty(0), tree)


def tp_paths(dev, model, qparams, reqs, results, ckpt_dir):
    """Tensor-parallel serving at full llama3-8b width over 2 ranks that
    share the card over gloo (NCCL refuses two ranks on one device): the
    ranks restore the packed tree the phase before saved and cut their
    shards; the dense run's first 4 requests served on 2 slots (each slot
    admitted twice) dense and paged, with the bf16 and the int8 KV cache,
    each request's tokens equal to single-device on the same slots or
    parting first at a tie; the collectives per decode step; MoE expert
    parallelism on the 2-layer cut against the local path; a 1 x 1 NCCL
    mesh against ``mesh=None``.  The tok/s is that of 2 ranks on one card
    with host-staged collectives, not a tensor-parallel speed.  Returns
    {row name: launches} for the sharded route rows."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    phase("main path: tensor-parallel serving (2 ranks sharing the card "
          "over gloo)")
    cfg = model.cfg
    tp_reqs = reqs[:TP_REQUESTS]
    # single-device references on the TP runs' schedule: TP_SLOTS slots
    eng2 = ServeEngine(model, qparams, n_slots=TP_SLOTS, max_len=1024,
                       device=dev)
    t0 = time.perf_counter()
    res2 = eng2.serve(fresh(tp_reqs))
    torch.cuda.synchronize()
    serve2_s = time.perf_counter() - t0
    same = sum(np.array_equal(res2[r.rid], results[r.rid]) for r in tp_reqs)
    print(f"  single-device on {TP_SLOTS} slots: {same}/{len(tp_reqs)} "
          f"requests bit for bit with the 4-slot dense run", flush=True)
    model8 = build_model(cfg.scaled(kv_cache_bits=8))
    eng8 = ServeEngine(model8, qparams, n_slots=TP_SLOTS, max_len=1024,
                       device=dev)
    res8 = eng8.serve(fresh(tp_reqs))
    del eng2, eng8
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"(the packed tree) before the ranks start", flush=True)
    moe_cfg = ARCHS["qwen2-moe-a2.7b"].scaled(n_layers=2,
                                              moe_capacity_factor=16.0)
    store = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        tp = spawn(tp_rank_serve, (1, TP_RANKS), "gloo", store, ckpt_dir,
                   _skeleton(qparams), cfg,
                   [(r.rid, np.asarray(r.prompt).tolist(), r.max_new_tokens)
                    for r in tp_reqs], moe_cfg, serve2_s,
                   device="cuda", timeout=TP_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = spawn(tp_rank_nccl, (1, 1), "nccl", store, device="cuda",
                     timeout=TP_TIMEOUT)
        nccl_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    print(f"  2 ranks on {torch.cuda.get_device_name(0)}: restore "
          f"{tp['restore_s']:.2f} s on the host; every rank's spawn to exit "
          f"{ranks_s:.2f} s; max_memory_allocated on rank 0 "
          f"{tp['max_memory_allocated_gib']:.2f} GiB", flush=True)
    for name, want, rs in (("dense", res2, tp_reqs),
                           ("paged", res2, tp_reqs),
                           ("int8 dense", res8, tp_reqs),
                           ("int8 paged", res8, tp_reqs)):
        run = tp[name]
        check(run["mesh"] == {"data": 1, "model": TP_RANKS},
              f"{name}: mesh {run['mesh']}")
        equal, ties = _tie_or_equal(f"TP {name}", model, qparams, rs, want,
                                    run["tokens"], dev)
        steps = run["decode_steps"] + run["prefill_batches"]
        check(run["prefill_batches"] >= len(rs) // TP_SLOTS,
              f"{name}: {run['prefill_batches']} prefill batches, no slot "
              f"admitted again")
        coll = run["collectives"]
        print(f"  TP {name} (KV cache {run['cache_shape']} per rank): "
              f"{equal}/{len(rs)} requests bit for bit with single-device, "
              f"{ties} parting at a tie; {run['tokens_generated']} tokens in "
              f"{run['serve_s']:.2f} s = "
              f"{run['tokens_generated'] / run['serve_s']:.1f} tok/s (2 "
              f"ranks on one card, not a TP speed); weights cut and placed "
              f"in {run['place_s']:.2f} s", flush=True)
        print(f"    collectives per engine step ({run['decode_steps']} decode "
              f"steps + {run['prefill_batches']} prefill batches): all_reduce "
              f"{coll['all_reduce']['calls'] / steps:.1f} (at most "
              f"{coll['all_reduce']['max_elements']} elements), all_gather "
              f"{coll['all_gather']['calls'] / steps:.2f} (the logits, "
              f"{coll['all_gather']['last_shape']}), all_to_all "
              f"{coll['all_to_all']['calls']}, broadcast (the clock) "
              f"{coll['broadcast']['calls'] / steps:.2f}", flush=True)
        check(coll["all_gather"]["calls"] == steps,
              f"{name}: {coll['all_gather']['calls']} all_gathers in "
              f"{steps} steps")
        check(coll["all_to_all"]["calls"] == 0, f"{name}: an all_to_all")
        check(coll["all_reduce"]["max_elements"] <= 4 * 512 * cfg.d_model,
              f"{name}: an all_reduce beyond the activations")
        print(f"    launches on rank 0: {run['launches']}", flush=True)
    ol = tp["open loop"]
    s_ = ol["summary"]
    f = ol["faults"]
    print(f"  TP open loop (paged, slo=, faults=; requests 0 and 1 at once, "
          f"2 and 3 {serve2_s:.2f} s later): outcomes {ol['outcomes']}; {f}; "
          f"preempted {ol['counters']['preempted']}, resumed "
          f"{ol['counters']['resumed']}; {ol['counters']['decode_steps']} "
          f"decode steps + {ol['counters']['prefill_batches']} prefills in "
          f"{f['loop_iters']} loop iterations; {ol['seconds']:.2f} s; TTFT "
          f"ms p50/p95 {ol['traffic']['ttft_ms']['p50']:.1f}/"
          f"{ol['traffic']['ttft_ms']['p95']:.1f}; the ranks' digests "
          f"{ol['agree']}", flush=True)
    check(len(set(ol["agree"])) == 1, "TP open loop: the ranks decided "
          "differently")
    check(s_["completed"] == len(tp_reqs), f"TP open loop: {s_}")
    check(f["forced_preempts"] == 1 and f["stalls"] == 1
          and f["alloc_failures"] >= 1, f"TP open loop: faults {f}")
    check(ol["counters"]["preempted"] >= 1 and ol["counters"]["resumed"]
          == ol["counters"]["preempted"], "TP open loop: preemptions not "
          "all resumed")
    check(ol["collectives"]["all_to_all"]["calls"] == 0,
          "TP open loop: an all_to_all")
    equal, ties = _tie_or_equal("TP open loop", model, qparams, tp_reqs, res2,
                                {int(r): t for r, t in ol["tokens"].items()},
                                dev)
    print(f"  TP open loop: {equal}/{len(tp_reqs)} completed requests bit "
          f"for bit with the fault-free single-device serve, {ties} parting "
          f"at a tie", flush=True)
    for name in ("decode", "prefill"):
        moe = tp["moe"][name]
        print(f"  MoE EP ({tp['moe']['experts']} of {MOE_EXPERTS} experts "
              f"per rank, capacity factor 16) {name}: bit for bit with the "
              f"local path {moe['bits']} (rel_err {moe['rel_err']:.3e}, "
              f"limit {EXACT_REL_TOL:.0e}); {moe['launches']} grouped "
              f"launches, {moe['all_to_all']} all_to_alls", flush=True)
        check(moe["finite"] and (moe["bits"]
                                 or moe["rel_err"] <= EXACT_REL_TOL),
              f"MoE EP {name} disagrees with the local path")
        check(moe["all_to_all"] == 2, f"MoE EP {name}: not expert-parallel")
    print(f"  NCCL 1 x 1 mesh ({nccl['backend']}): tokens equal to "
          f"mesh=None bit for bit {nccl['equal']}; all_reduce / all_gather / "
          f"all_to_all / broadcast on the 1-rank group "
          f"{nccl['collectives']}; {nccl_s:.2f} s", flush=True)
    check(nccl["backend"] == "nccl" and nccl["equal"]
          and nccl["collectives"], "the NCCL 1 x 1 mesh")

    def routes(name, take):
        return sum(n for run in ("dense", "paged", "int8 dense",
                                 "int8 paged")
                   for route, n in tp[run]["routes"][name].items()
                   if take(route))

    def launched(kernel, *runs):
        return sum(tp[run]["launches"][kernel] for run in runs)

    column = {f"k{k} n{n}" for k, n in TP_COLUMN}
    row = {f"k{k} n{n}" for k, n in TP_ROW}
    return {"quant_matmul_tp2_column": routes("quant_matmul",
                                              column.__contains__),
            "quant_matmul_tp2_row": routes("quant_matmul", row.__contains__),
            "flash_decode_tp2": launched("flash_decode", "dense"),
            "flash_decode_q8_tp2": launched("flash_decode_q8", "int8 dense"),
            "flash_attention_tp2": launched("flash_attention", "dense",
                                            "paged", "int8 dense",
                                            "int8 paged"),
            "flash_decode_paged_tp2": launched("flash_decode_paged",
                                               "paged"),
            "flash_decode_paged_q8_tp2": launched("flash_decode_paged_q8",
                                                  "int8 paged"),
            "quant_matmul_experts_ep2": sum(tp["moe"][n]["launches"]
                                            for n in ("decode", "prefill"))}


# ---------------------------------------------------------------------------
# Phase 5e: tensor-parallel serving of the vlm, hybrid, ssm and audio
# families, 2 ranks sharing the card over gloo
# ---------------------------------------------------------------------------

FAMILY_TP_ENGINES = ("qwen2-vl-2b", "hymba-1.5b", "xlstm-350m")
FAMILY_TP_TIMEOUT = 900


def hold_for_tp(held, name, qparams, **extra):
    """Save ``qparams`` (a family's packed tree) for the families' TP phase
    under ``held["dir"]``, with its skeleton and ``extra``."""
    from repro_torch.dist import checkpoint as ckpt
    path = os.path.join(held["dir"], name)
    t0 = time.perf_counter()
    ckpt.save(path, 0, {"qparams": qparams})
    print(f"  packed tree saved for the families' TP phase in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    held[name] = dict(extra, dir=path, skeleton=_skeleton(qparams))


def hold_requests(job, reqs, out):
    """The TP phase's requests (the dense run's first TP_REQUESTS) and
    their single-device tokens: the 4-slot serve's, which are a 2-slot
    engine's too (each == batch-1 ``generate`` bit for bit)."""
    job["reqs"] = [(r.rid, np.asarray(r.prompt).tolist(), r.max_new_tokens)
                   for r in reqs[:TP_REQUESTS]]
    job["tokens"] = {r.rid: np.asarray(out[r.rid]).tolist()
                     for r in reqs[:TP_REQUESTS]}


def _agree(mesh, obj) -> list:
    """Every rank's digest of ``obj`` (json), gathered: equal only where
    the ranks hold the same ``obj``."""
    import hashlib

    import torch.distributed as tdist
    text = json.dumps(obj, sort_keys=True, default=str)
    mine = torch.tensor([float(int(hashlib.sha256(text.encode())
                                   .hexdigest()[:12], 16))],
                        dtype=torch.float64)
    every = [torch.zeros_like(mine) for _ in range(mesh.n_ranks)]
    tdist.all_gather(every, mine)
    return [float(t) for t in every]


def family_tp_rank(mesh, jobs, whisper):
    """One rank of the families' TP phase: each engine family's packed tree
    restored on the host and cut by a 2-slot ``ServeEngine(mesh=)``, which
    serves the dense run's first 4 requests; whisper's tree placed by an
    engine and driven through ``prefill(frames=)`` + decode steps under the
    engine's mesh context.  Rank 0's numbers are the phase's; every run
    carries the ranks' digests."""
    import gc

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def restore(job):
        t0 = time.perf_counter()
        whole = ckpt.restore(job["dir"], 0, {"qparams": job["skeleton"]},
                             device="cpu")["qparams"]
        return whole, time.perf_counter() - t0

    def placed(model, whole, **kw):
        t0 = time.perf_counter()
        eng = ServeEngine(model, whole, mesh=mesh, device=mesh.device, **kw)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    for arch, job in jobs.items():
        whole, restore_s = restore(job)
        model = build_model(family_serve_cfg(arch))
        eng, place_s = placed(model, whole, n_slots=TP_SLOTS, max_len=1024)
        del whole
        t0 = time.perf_counter()
        res, launches, routes, coll = _rank_counted(lambda: eng.serve([
            Request(rid=r, prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for r, p, n in job["reqs"]]))
        serve_s = time.perf_counter() - t0
        m = eng.metrics()
        tokens = {r: res[r].tolist() for r in res}
        out[arch] = dict(
            tokens=tokens, restore_s=restore_s, place_s=place_s,
            serve_s=serve_s, launches=launches, routes=routes,
            collectives=coll, mesh=m["mesh"], decode_steps=m["decode_steps"],
            prefill_batches=m["prefill_batches"],
            tokens_generated=m["tokens_generated"],
            per_step=model.tp_all_reduces(mesh), agree=_agree(mesh, tokens))
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    whole, restore_s = restore(whisper)
    cfg = family_serve_cfg("whisper-small")
    model = build_model(cfg)
    b, steps = whisper["prompts"].shape[0], whisper["steps"]
    eng, place_s = placed(model, whole, n_slots=b,
                          max_len=WHISPER_PROMPT + NEW_TOKENS)
    del whole
    v = cfg.vocab_size
    with eng._mesh_ctx():
        cache = eng.new_cache(model, b, WHISPER_PROMPT + NEW_TOKENS)
        prompts = torch.as_tensor(whisper["prompts"], device=mesh.device)
        frames = torch.as_tensor(whisper["frames"], device=mesh.device)
        t0 = time.perf_counter()
        (logits, cache), pre_l, pre_r, pre_c = _rank_counted(
            lambda: model.prefill(eng.params, prompts, cache, frames=frames))
        toks = [logits[:, 0, :v].argmax(-1).int()]
        prefill_s = time.perf_counter() - t0

        def decode():
            nonlocal cache
            for _ in range(steps):
                logits, cache = model.decode_step(eng.params, cache,
                                                  toks[-1][:, None])
                toks.append(logits[:, 0, :v].argmax(-1).int())

        t0 = time.perf_counter()
        _, dec_l, dec_r, dec_c = _rank_counted(decode)
        decode_s = time.perf_counter() - t0
    tokens = torch.stack(toks, 1).cpu().tolist()
    out["whisper-small"] = dict(
        tokens=tokens, restore_s=restore_s, place_s=place_s,
        prefill_s=prefill_s, decode_s=decode_s, decode_steps=steps,
        prefill=dict(launches=pre_l, routes=pre_r, collectives=pre_c),
        decode=dict(launches=dec_l, routes=dec_r, collectives=dec_c),
        per_step={"prefill": model.tp_all_reduces(mesh, prefill=True),
                  "decode": model.tp_all_reduces(mesh)},
        agree=_agree(mesh, tokens))
    del eng, cache
    gc.collect()
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _family_gaps(dev, arch, job, rows, toks):
    """The single-device top-2 logit gap at every token of ``toks`` (the
    single-device tokens of request ``rows``), the family's tree restored
    on the card: an engine family's batch-1 prefill + decode steps fed
    those tokens (its engine == ``generate`` bit for bit, so these are
    the engine's logits); whisper's 4-row prefill(frames=) + decode steps,
    as its single-device run.  Returns {row: gaps}."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models.registry import build_model

    cfg = family_serve_cfg(arch)
    model = build_model(cfg)
    qp = ckpt.restore(job["dir"], 0, {"qparams": job["skeleton"]},
                      device=dev)["qparams"]
    v = cfg.vocab_size

    def gap(logits):
        top = logits[:, 0, :v].float().topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).cpu().numpy()

    out = {}
    if arch == "whisper-small":
        cache = model.init_cache(len(toks), WHISPER_PROMPT + NEW_TOKENS,
                                 device=dev)
        logits, cache = model.prefill(
            qp, torch.as_tensor(job["prompts"], device=dev), cache,
            frames=torch.as_tensor(job["frames"], device=dev))
        g = [gap(logits)]
        fed = torch.as_tensor(np.stack([np.asarray(toks[r])
                                        for r in sorted(toks)]),
                              dtype=torch.int32, device=dev)
        for j in range(fed.shape[1] - 1):
            logits, cache = model.decode_step(qp, cache, fed[:, j:j + 1])
            g.append(gap(logits))
        g = np.stack(g, 1)
        return {r: g[r] for r in rows}
    for r in rows:
        prompt = job["reqs"][r][1]
        seq = toks[r]
        cache = model.init_cache(1, len(prompt) + len(seq), device=dev)
        logits, cache = model.prefill(qp, torch.as_tensor(
            np.asarray(prompt, np.int32), device=dev)[None], cache)
        g = [gap(logits)[0]]
        for t in seq[:-1]:
            logits, cache = model.decode_step(qp, cache, torch.tensor(
                [[t]], dtype=torch.int32, device=dev))
            g.append(gap(logits)[0])
        out[r] = np.asarray(g)
    del qp
    torch.cuda.empty_cache()
    return out


def family_tp_paths(dev, held):
    """Tensor-parallel serving of the vlm, hybrid, ssm and audio families
    at full width and half depth over 2 ranks that share the card over gloo, in
    one spawn: qwen2-vl-2b (6 query heads on 1 KV head a rank), hymba-1.5b
    (25 / 5 heads replicated, MLP and Mamba cut) and xlstm-350m (2 of 4
    mLSTM heads a rank, the sLSTM whole) serve the dense run's first 4
    requests on 2 slots, whisper-small prefills 4 x 100 tokens over 1536
    frames and decodes 31 steps on 6 of 12 heads a rank; each request's
    tokens equal single-device or part first at a tie (the single-device
    top-2 gap there <= TIE_TOL), the ranks agree, and the collectives per
    engine step are the model's ``tp_all_reduces`` (the tests' formula)
    with one logits all_gather.  Returns {route row: rank 0's
    launches}."""
    from repro_torch.launch.mesh import spawn

    phase("families: tensor-parallel serving (2 ranks sharing the card over "
          "gloo): qwen2-vl-2b, hymba-1.5b, xlstm-350m 4 requests on 2 "
          "slots; whisper-small prefill(frames) + decode")
    jobs = {arch: dict(dir=held[arch]["dir"], skeleton=held[arch]["skeleton"],
                       reqs=held[arch]["reqs"])
            for arch in FAMILY_TP_ENGINES}
    w = held["whisper-small"]
    whisper = dict(dir=w["dir"], skeleton=w["skeleton"], prompts=w["prompts"],
                   frames=w["frames"], steps=w["tokens"].shape[1] - 1)
    store = tempfile.mkdtemp(prefix="chip_smoke_family_tp_")
    try:
        t0 = time.perf_counter()
        tp = spawn(family_tp_rank, (1, TP_RANKS), "gloo", store, jobs,
                   whisper, device="cuda", timeout=FAMILY_TP_TIMEOUT)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    print(f"  2 ranks on {torch.cuda.get_device_name(0)}: spawn to exit "
          f"{ranks_s:.2f} s; max_memory_allocated on rank 0 "
          f"{tp['max_memory_allocated_gib']:.2f} GiB", flush=True)

    def held_to_single(name, arch, want, got, rows):
        """Per request: equal, or parting first at a single-device tie."""
        equal, parted = 0, {}
        for r in rows:
            a, b = np.asarray(want[r]), np.asarray(got[r])
            check(len(b) == len(a), f"{name} request {r}: {len(b)} tokens")
            diff = np.nonzero(a != b)[0]
            if len(diff):
                parted[r] = int(diff[0])
            else:
                equal += 1
        if parted:
            gaps = _family_gaps(dev, arch, held[arch], list(parted), want)
            for r, j in parted.items():
                print(f"  {name} request {r}: parts from single-device at "
                      f"token {j}, where the single-device top-2 gap is "
                      f"{gaps[r][j]:.4f}", flush=True)
                check(gaps[r][j] <= TIE_TOL, f"{name} request {r}: parts "
                      f"from single-device at token {j}, not a tie "
                      f"({gaps[r][j]:.4f} > {TIE_TOL})")
        return equal, len(parted)

    launches = {f"quant_matmul_tp2_families_{kind}": 0
                for kind in ("column", "row", "row_f32")}

    def count_qmm(arch, routes):
        for kind in ("column", "row", "row_f32"):
            pre = "f32out " if kind == "row_f32" else ""
            keys = {f"{pre}k{k} n{n}"
                    for k, n in FAMILY_TP_COUNTED[arch][kind]}
            launches[f"quant_matmul_tp2_families_{kind}"] += sum(
                n for route, n in routes["quant_matmul"].items()
                if route in keys)

    for arch in FAMILY_TP_ENGINES:
        run, cfg = tp[arch], family_serve_cfg(arch)
        check(len(set(run["agree"])) == 1, f"TP {arch}: the ranks differ")
        check(run["mesh"] == {"data": 1, "model": TP_RANKS},
              f"TP {arch}: mesh {run['mesh']}")
        want = held[arch]["tokens"]
        rows = [r for r, *_ in held[arch]["reqs"]]
        equal, ties = held_to_single(f"TP {arch}", arch, want,
                                     run["tokens"], rows)
        steps = run["decode_steps"] + run["prefill_batches"]
        coll = run["collectives"]
        per = run["per_step"]
        print(f"  TP {arch}: {equal}/{len(rows)} requests bit for bit with "
              f"single-device, {ties} parting at a tie; "
              f"{run['tokens_generated']} tokens in {run['serve_s']:.2f} s = "
              f"{run['tokens_generated'] / run['serve_s']:.1f} tok/s (2 "
              f"ranks on one card, not a TP speed); restored in "
              f"{run['restore_s']:.2f} s, cut and placed in "
              f"{run['place_s']:.2f} s", flush=True)
        print(f"    collectives per engine step ({run['decode_steps']} decode "
              f"steps + {run['prefill_batches']} prefills): all_reduce "
              f"{coll['all_reduce']['calls'] / steps:.1f} (formula {per}; at "
              f"most {coll['all_reduce']['max_elements']} elements), "
              f"all_gather {coll['all_gather']['calls'] / steps:.2f} (the "
              f"logits, {coll['all_gather']['last_shape']}), all_to_all "
              f"{coll['all_to_all']['calls']}, broadcast (the clock) "
              f"{coll['broadcast']['calls'] / steps:.2f}", flush=True)
        check(coll["all_gather"]["calls"] == steps,
              f"TP {arch}: {coll['all_gather']['calls']} all_gathers in "
              f"{steps} steps")
        check(coll["all_reduce"]["calls"] == steps * per,
              f"TP {arch}: {coll['all_reduce']['calls']} all_reduces in "
              f"{steps} steps, not {per} a step")
        check(coll["all_to_all"]["calls"] == 0, f"TP {arch}: an all_to_all")
        # activations only: the widest is the mLSTM's d_inner row
        width = cfg.d_model * (cfg.ssm_expand if cfg.family == "ssm" else 1)
        check(coll["all_reduce"]["max_elements"]
              <= max(PROMPT_LENS[:TP_REQUESTS]) * width,
              f"TP {arch}: an all_reduce beyond the activations")
        print(f"    launches on rank 0: {run['launches']}", flush=True)
        count_qmm(arch, run["routes"])

    run, cfg = tp["whisper-small"], family_serve_cfg("whisper-small")
    check(len(set(run["agree"])) == 1, "TP whisper: the ranks differ")
    b = w["prompts"].shape[0]
    equal, ties = held_to_single("TP whisper-small", "whisper-small",
                                 {r: w["tokens"][r] for r in range(b)},
                                 dict(enumerate(run["tokens"])), range(b))
    pre, dec = run["prefill"]["collectives"], run["decode"]["collectives"]
    print(f"  TP whisper-small: {equal}/{b} requests bit for bit with "
          f"single-device, {ties} parting at a tie; prefill(frames) "
          f"{run['prefill_s']:.2f} s, {run['decode_steps']} decode steps at B "
          f"{b} in {run['decode_s']:.2f} s; restored in "
          f"{run['restore_s']:.2f} s, placed in {run['place_s']:.2f} s",
          flush=True)
    per = run["per_step"]
    print(f"    collectives: prefill all_reduce {pre['all_reduce']['calls']} "
          f"(formula {per['prefill']}), all_gather "
          f"{pre['all_gather']['calls']}; per decode step all_reduce "
          f"{dec['all_reduce']['calls'] / run['decode_steps']:.1f} (formula "
          f"{per['decode']}), all_gather "
          f"{dec['all_gather']['calls'] / run['decode_steps']:.2f}",
          flush=True)
    check(pre["all_reduce"]["calls"] == per["prefill"]
          and pre["all_gather"]["calls"] == 1, "TP whisper: prefill "
          "collectives off the formula")
    check(dec["all_reduce"]["calls"] == run["decode_steps"] * per["decode"]
          and dec["all_gather"]["calls"] == run["decode_steps"],
          "TP whisper: decode collectives off the formula")
    check(pre["all_reduce"]["max_elements"]
          <= b * WHISPER_FRAMES * cfg.d_model
          and dec["all_reduce"]["max_elements"] <= b * cfg.d_model,
          "TP whisper: an all_reduce beyond the activations")
    for part in ("prefill", "decode"):
        count_qmm("whisper-small", run[part]["routes"])

    vlm = tp["qwen2-vl-2b"]
    launches["flash_attention_vlm_tp2"] = vlm["launches"]["flash_attention"]
    launches["flash_decode_vlm_tp2"] = vlm["launches"]["flash_decode"]
    launches["flash_attention_whisper_tp2"] = run["prefill"]["routes"][
        "flash_attention"].get("G1 hd64 not causal", 0)
    launches["flash_decode_cross_tp2"] = run["decode"]["routes"][
        "flash_decode"].get(f"G1 hd64 S{WHISPER_FRAMES}", 0)
    print(f"  route launches on rank 0: {launches}", flush=True)
    return launches


def teacher_forced(model, qparams, prompt, toks, dev, extra=None):
    """Per generated token: how far its logit lies below the top logit of
    a teacher-forced exact-length forward over prompt + tokens (0 where it
    is the argmax), and that position's top-2 gap.  ``extra`` joins the
    forward's batch: a VLM's ``patches`` (1, P, d), whisper's ``frames``
    (1, T_enc, d)."""
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)
    batch = dict(extra or {}, tokens=torch.as_tensor(seq, device=dev)[None])
    logits = model.forward(qparams, batch)[0][0, len(prompt) - 1:].float()
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
    (its result, the counts read just after: {symbol: n} and, for the
    routes the wrappers name, {(symbol, route): n}).  The counters are then
    put back as they were, so a path counted inside another leaves the
    outer path's counts alone."""
    outer = [(k.launches, k.routes.copy()) for k in kernels]
    for kern in kernels:
        kern.launches = 0
        kern.routes.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    counts.update({(k.symbol, route): n for k in kernels
                   for route, n in k.routes.items()})
    for kern, (n, routes) in zip(kernels, outer):
        kern.launches, kern.routes = n, routes
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

    phase(f"main path: open-loop traffic, the first {OPEN_LOOP_REQUESTS} of "
          f"12 Poisson requests at 0.5 x the closed-loop rate "
          f"({0.5 * closed_rps:.3f} requests/s), dense and paged")
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
                trace_at(0.5 * closed_rps)[:OPEN_LOOP_REQUESTS]))
        traffic_report(name, res)
        check(res.summary["completed"] == OPEN_LOOP_REQUESTS,
              f"{name}: not all completed")
        same = [np.array_equal(res[r.rid], closed[r.rid])
                for _, r in base[:OPEN_LOOP_REQUESTS]]
        print(f"  {name}: tokens equal the closed-loop dense serve's bit for "
              f"bit: {sum(same)}/{len(same)}", flush=True)
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
    phase("profile: 4 x 12-token requests, 1 prefill + 8 decode steps")
    report_profile(prof, wall_ms, 9, "engine step (1 prefill + 8 decode "
                                     "steps)", top=8)


def on_device(e) -> bool:
    """A profiler event (or average) that ran on the card: a kernel, copy
    or fill, not the host-side op that launched it."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def report_profile(prof, wall_ms, steps, step_name, top):
    """Device busy time against ``wall_ms``, device operations per step
    and the ``top`` device operations by time, from a finished
    ``torch.profiler`` session.  Only device events count: a host op's
    self device time is its kernels' time again."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if on_device(e)]
    rows = [r for r in rows if r[1] > 0]
    busy_ms = sum(r[1] for r in rows)
    n_ops = sum(1 for e in prof.events() if on_device(e))
    print(f"  wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall; "
          f"{n_ops} device operations = {n_ops / steps:.0f} per "
          f"{step_name}", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
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
    redesigned = []
    for src_name, log in _build.build_logs.items():
        for kernel, report in ptxas_report(log):
            print(f"  {src_name} {kernel}: {report}", flush=True)
            if kernel.startswith(NO_SPILL):
                redesigned.append((kernel, report))
    if redesigned:
        spilled = [k for k, r in redesigned if "spills 0 B stored / 0 B" not in r]
        print(f"  spills in the {len(redesigned)} instantiations of "
              f"{', '.join(NO_SPILL)}: {spilled or 'none'}", flush=True)
        check(not spilled, f"ptxas spills in {spilled}")
    else:
        print("  (kernels were built by an earlier process: no ptxas report)",
              flush=True)

    # every kernel, in the order of the TPU kernel table (PERF.md)
    by_name = {"quant_matmul": qm.KERNEL,
               "quant_matmul_experts": qm.KERNEL_EXPERTS,
               "flash_decode": fd.KERNEL,
               "flash_decode_q8": fd.KERNEL_Q8, "flash_attention": fa.KERNEL,
               "flash_decode_paged": fd.KERNEL_PAGED,
               "flash_decode_paged_q8": fd.KERNEL_PAGED_Q8,
               "quant_error": qe.KERNEL, "flash_verify": fd.VERIFY,
               "flash_verify_q8": fd.VERIFY_Q8,
               "flash_verify_paged": fd.VERIFY_PAGED,
               "flash_verify_paged_q8": fd.VERIFY_PAGED_Q8,
               "rms_norm": rn.KERNEL, "flash_attention_bwd": fa.KERNEL_BWD,
               "rms_norm_bwd": rn.KERNEL_BWD}
    # the families' routes: (row, kernel, the family whose paths launch it,
    # the routes the wrapper names that the row counts)
    routes = [("flash_attention_g6", fa.KERNEL, "VLM",
               lambda r: r.startswith("G6 ")),
              ("flash_decode_g6", fd.KERNEL, "VLM",
               lambda r: r.startswith("G6 ")),
              ("flash_decode_ring_g5", fd.KERNEL, "hymba",    # its cache
               lambda r: r.startswith("G5 ")),                 # is the ring
              ("flash_attention_noncausal_g1", fa.KERNEL, "whisper",
               lambda r: r == "G1 hd64 not causal"),
              ("flash_decode_g1", fd.KERNEL, "whisper",
               lambda r: r == f"G1 hd64 S{WHISPER_PROMPT + NEW_TOKENS}"),
              ("flash_decode_cross_g1", fd.KERNEL, "whisper",
               lambda r: r == f"G1 hd64 S{WHISPER_FRAMES}")]
    # the sharded routes of tensor-parallel serving (their launches are
    # rank 0's in the TP phase)
    tp_rows = ["quant_matmul_tp2_column", "quant_matmul_tp2_row",
               "quant_matmul_experts_ep2", "flash_decode_tp2",
               "flash_decode_q8_tp2", "flash_attention_tp2",
               "flash_decode_paged_tp2", "flash_decode_paged_q8_tp2"]
    # the sharded routes of the families' tensor-parallel serving (rank 0's
    # launches in the families' TP phase)
    family_tp_rows = ["quant_matmul_tp2_families_column",
                      "quant_matmul_tp2_families_row",
                      "quant_matmul_tp2_families_row_f32",
                      "flash_attention_vlm_tp2",
                      "flash_attention_whisper_tp2", "flash_decode_vlm_tp2",
                      "flash_decode_cross_tp2"]
    # the backward routes of mesh training (rank 0's launches in the mesh
    # phase)
    mesh_rows = ["flash_attention_bwd_tp2", "rms_norm_bwd_dp2"]
    # the families' training routes (their single-device train paths'
    # launches): row -> (arch, kernel, the route the wrapper names)
    family_train_rows = dict(
        [(name, (arch, fa.KERNEL_BWD,
                 f"G{g} hd{hd} {'' if causal else 'not '}causal"))
         for name, arch, _, g, _, hd, causal in FAMILY_BWD_ATTN]
        + [(name, (arch, rn.KERNEL_BWD, f"d{d} {dt}"))
           for name, arch, d, dt in FAMILY_NORMS])
    kernels = tuple(by_name.values())
    rows = {r["name"]: r for r in kernel_phase(dev)}
    names = (list(by_name) + [name for name, *_ in routes] + tp_rows
             + family_tp_rows + mesh_rows + list(family_train_rows))
    check(sorted(rows) == sorted(names), f"kernel rows {sorted(rows)}")
    rows = [rows[name] for name in names]
    phase("reference: tiny model, card against CPU")
    reference_phase(dev)
    phase("main path: train llama3-8b width on the card")
    train_counts, mesh_ref = train_paths(dev, kernels)
    family_train_counts, family_refs = family_train_paths(dev, kernels)
    mesh_launches = mesh_train_paths(dev, mesh_ref, family_refs)
    phase("main path: llama3-8b calibrate -> FAQ -> int4 pack -> serve")
    launches, row_keys = main_path_phase(dev, kernels)
    phase("main path: the MoE family (qwen2-moe-a2.7b)")
    train_counts.update(moe_paths(dev, kernels))
    held = {"dir": tempfile.mkdtemp(prefix="chip_smoke_family_trees_")}
    try:
        phase("main path: the VLM and hybrid families (qwen2-vl-2b, "
              "hymba-1.5b)")
        family_counts = families_paths(dev, kernels, held)
        phase("main path: the ssm and audio families (xlstm-350m, "
              "whisper-small)")
        family_counts.update(ssm_audio_paths(dev, kernels, held))
        family_tp_launches = family_tp_paths(dev, held)
    finally:
        shutil.rmtree(held["dir"], ignore_errors=True)
    train_counts.update(family_counts)
    train_counts.update({f"train {arch}": c
                         for arch, c in family_train_counts.items()})
    for path, counts in train_counts.items():
        print(f"  launches on the {path} path: {counts}", flush=True)
        for sym, n in counts.items():
            if sym in launches:
                launches[sym] += n
    for row, kern in zip(rows, kernels):
        row.update(row_keys.get(row["name"], {}))
        row["launches"] = launches[kern.symbol]
    for row in rows[len(kernels) + len(routes):]:
        if row["name"] in family_train_rows:
            arch, kern, route = family_train_rows[row["name"]]
            row["launches"] = family_train_counts[arch].get(
                (kern.symbol, route), 0)
            continue
        row["launches"] = dict(row_keys["tp"], **family_tp_launches,
                               **mesh_launches)[row["name"]]
    for row, (_, kern, family, takes) in zip(rows[len(kernels):], routes):
        row["launches"] = sum(
            n for path, counts in family_counts.items()
            if path.startswith(family) for key, n in counts.items()
            if isinstance(key, tuple) and key[0] == kern.symbol
            and takes(key[1]))
    for row in rows:
        check(row["launches"] > 0,
              f"{row['name']} was not launched on the main path")
    phase()
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
