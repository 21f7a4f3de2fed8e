#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device   — the card, its power limit, torch and CUDA versions;
2. build    — ``nvcc`` builds every kernel in ``src/repro_torch/csrc``
              (one process per source, all started together);
3. kernels  — each kernel against its plain PyTorch version on the same
              inputs, at the main path's shapes (bf16) and at the odd
              shapes the reference's own kernel tests pin (f32); then its
              time, the plain version's, one library call's where one
              computes the same function, and its bound;
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
              batch-1 exact-length run may round differently at a tie:
              torch's row reductions and cuBLAS pick their summation
              order by shape).  The launch counters are zeroed just
              before this phase and read just after it;
6. profile  — torch.profiler over one short serve: device busy time
              against wall time, and the top kernels.

The one reduction of the main path: prompt and calibration token ids
come from a synthetic vocabulary capped at 4096 ids (the generator's
dense (v, v) transition matrix cannot be built at 128256); the model
keeps its full 128256-entry embedding and head.

Tolerances (max abs error, kernel vs plain version on the same inputs):
bf16 ``1e-2 * max|plain|``; f32 ``1e-4 * max(1, max|plain|)`` — the
kernels sum in another order than the plain version's library calls.

Output: per-phase lines, then the card's ``nvidia-smi`` name and power
limit, then one ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present or the repository's sources are missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
LAYERS = 32                        # llama3-8b's full depth (no cut)
PROMPT_LENS = (12, 40, 100, 200, 300, 450, 600, 700)
NEW_TOKENS = 32
# bf16 logits of magnitude < 8 are spaced 2**-5 apart; a token within four
# such steps of the reference's top logit is a numerical tie, not an error
TIE_TOL = 4 * 2.0 ** -5


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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return float((got.float() - ref.float()).abs().max())


def tolerance(ref) -> float:
    peak = float(ref.float().abs().max())
    return 1e-2 * peak if ref.dtype == torch.bfloat16 else 1e-4 * max(1.0, peak)


def held(name, got, ref) -> float:
    torch.cuda.synchronize()
    err, tol = max_err(got, ref), tolerance(ref)
    print(f"  {name}: max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    check(err <= tol, f"{name}: kernel disagrees with its plain version")
    return err


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
    for m, k, n, g, dt in [(4, 4096, 4096, 64, torch.bfloat16),
                           (4, 4096, 1024, 64, torch.bfloat16),
                           (4, 4096, 14336, 64, torch.bfloat16),
                           (4, 14336, 4096, 64, torch.bfloat16),
                           (2048, 4096, 14336, 64, torch.bfloat16),
                           (1, 128, 1600, 64, torch.float32),
                           (3, 1600, 128, 100, torch.float32),
                           (130, 1600, 1600, 100, torch.float32),
                           (192, 128, 1600, 64, torch.float32),
                           (130, 320, 100, 64, torch.float32)]:
        codes, scale, zero = packed(k, n, g)
        x = randn(m, k, dtype=dt)
        held(f"m={m} k={k} n={n} g={g} {str(dt)[6:]}",
             qm.quant_matmul(x, codes, scale, zero),
             qm.quant_matmul_ref(x, codes, scale, zero))
    # timed at decode's gate/up projection: 4 slots, 4096 -> 14336
    m, k, n, g = 4, 4096, 14336, 64
    sets = [packed(k, n, g) for _ in range(4)]     # > L2: each call cold
    x = randn(m, k)
    err = held("timed shape", qm.quant_matmul(x, *sets[0]),
               qm.quant_matmul_ref(x, *sets[0]))
    ms = time_ms(lambda i: qm.quant_matmul(x, *sets[i % 4]))
    plain = time_ms(lambda i: qm.quant_matmul_ref(x, *sets[i % 4]), reps=5)
    bytes_moved = m * k * 2 + k * n // 2 + 2 * (k // g) * n * 4 + m * n * 2
    b_ms, b_by = bound(bytes_moved, 2 * m * k * n)
    rows.append(dict(name="quant_matmul", route="cuda",
                     source="src/repro_torch/csrc/quant_matmul.cu",
                     replaces="src/repro/kernels/quant_matmul.py:56",
                     shape=f"x ({m},{k}) bf16, codes ({k // 2},{n}), g={g}",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    # prefill-sized call (4 slots x 512-token bucket), reported beside it
    xp = randn(2048, k)
    ms_p = time_ms(lambda i: qm.quant_matmul(xp, *sets[i % 4]), reps=5,
                   inner=3)
    bp_ms, bp_by = bound(2048 * k * 2 + k * n // 2 + 2 * (k // g) * n * 4
                         + 2048 * n * 2, 2 * 2048 * k * n)
    print(f"  decode m=4 4096->14336: {ms:.4f} ms (plain {plain:.4f}, bound "
          f"{b_ms:.4f} by {b_by}); prefill m=2048: {ms_p:.4f} ms (bound "
          f"{bp_ms:.4f} by {bp_by})", flush=True)

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

    # -- flash_attention ---------------------------------------------------
    phase("kernel flash_attention")
    for bkh, g, t, hd, dt in [(64, 4, 512, 128, torch.bfloat16),
                              (4, 2, 128, 32, torch.float32),
                              (4, 2, 200, 32, torch.float32),
                              (3, 1, 37, 64, torch.float32),
                              (3, 1, 150, 64, torch.float32)]:
        q = randn(bkh, g, t, hd, dtype=dt)
        k_, v_ = randn(bkh, t, hd, dtype=dt), randn(bkh, t, hd, dtype=dt)
        held(f"BKH={bkh} G={g} T={t} hd={hd} {str(dt)[6:]}",
             fa.flash_attention(q, k_, v_), fa.flash_attention_ref(q, k_, v_))
    bkh, g, t, hd = 64, 4, 512, 128     # calibration batch: 8 x 8 KV heads
    sets = [(randn(bkh, g, t, hd), randn(bkh, t, hd), randn(bkh, t, hd))
            for _ in range(2)]
    err = held("timed shape", fa.flash_attention(*sets[0]),
               fa.flash_attention_ref(*sets[0]))
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
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}", flush=True)
    return rows


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
    for path, rep in report.items():
        # alpha = 0 (no smoothing) is in the grid, so FAQ never loses to RTN
        check(bool((rep["loss"] <= rep["rtn_loss"] * (1 + 1e-5)).all()),
              f"{path}: searched loss above the RTN loss")
    for path, s in summary.items():
        print(f"  {path}: mean alpha {s['mean_alpha']:.3f}, loss "
              f"{s['mean_loss']:.4e} vs RTN {s['mean_rtn_loss']:.4e} "
              f"({100 * s['improvement_vs_rtn']:.1f}% better)", flush=True)
    del params, stats
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
        seq = np.concatenate([reqs[0].prompt, toks[:-1]]).astype(np.int32)
        logits = model.forward(qparams, {"tokens": torch.as_tensor(
            seq, device=dev)[None]})[0][0, len(reqs[0].prompt) - 1:].float()
        top2 = logits.topk(2, dim=-1).values
        chosen = logits.gather(1, torch.as_tensor(
            toks, device=dev, dtype=torch.long)[:, None])[:, 0]
        margin = (top2[:, 0] - chosen).cpu().numpy()
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
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
    profile_phase(eng, data, Request)
    return launches


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
    phase("profile: 4 x 12-token requests, 1 prefill + 8 decode steps")
    print(f"  wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall",
          flush=True)
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
    from repro_torch.kernels import quant_matmul as qm

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
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"  {src_name}: {'; '.join(sorted(set(regs)))}", flush=True)

    kernels = (qm.KERNEL, fd.KERNEL, fa.KERNEL)
    rows = kernel_phase(dev)
    phase("reference: tiny model, card against CPU")
    reference_phase(dev)
    phase("main path: llama3-8b calibrate -> FAQ -> int4 pack -> serve")
    launches = main_path_phase(dev, kernels)
    for row, kern in zip(rows, kernels):
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
