"""Serving entry point: load a checkpoint (or init), calibrate,
FAQ-quantize to packed int4, and serve synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --tiny --device cpu --requests 4
    # speculative decoding, FAQ int8 self-draft, 3 proposals per cycle
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --spec-k 3 --draft self-int8
    # SLO admission, injected faults and a Chrome trace of the run
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --paged --deadline-s 5 --fault-alloc-at 0,3 --fault-preempt-at 4 \
        --trace-out trace.json && python -m repro_torch.obs trace.json
    # the params of a training checkpoint (repro_torch.launch.train, or the
    # reference's: the format is shared)
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --ckpt-dir /tmp/lt
    # tensor-parallel on a (data, model) mesh of ranks this command starts
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --mesh 1,2

Runs on the card by default (``--device cuda``) and fails there is none.
``--mesh DATA,MODEL`` starts ``DATA * MODEL`` ranks itself
(:func:`repro_torch.launch.mesh.spawn`), one process each, over
``--backend`` (``nccl`` for ``--device cuda``, one card per rank;
``gloo`` for ``--device cpu``): every rank builds the same weights from
the seed, calibrates and quantizes them alike, and serves its shards
(``ServeEngine(mesh=)``); rank 0 prints.
At full width (``--no-tiny``) the synthetic data vocabulary is capped at
``DATA_VOCAB_CAP`` tokens: the data generator keeps a dense (v, v)
float64 transition matrix, which at llama3's 128256-token vocabulary
would need ~2 x 131 GB of host memory.  The model keeps its full
embedding and head; only the token ids drawn for prompts and
calibration come from the capped range.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model, run_calibration
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        calibration_batches)
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch.mesh import spawn
from repro_torch.models.registry import build_model
from repro_torch.obs import Tracer, profile_session
from repro_torch.serve.draft import registry_draft, self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.faults import FaultConfig, FaultInjector
from repro_torch.serve.overload import SLOConfig
from repro_torch.serve.spec import SpecConfig

DATA_VOCAB_CAP = 4096
# seconds the --mesh ranks have to finish before the run fails
RANK_TIMEOUT_S = 3600.0


def parse_chunk(arg):
    """'auto' | int tokens | 0/'none' to disable chunked prefill."""
    if arg == "auto":
        return "auto"
    try:
        n = int(arg)
    except ValueError:
        if arg.lower() in ("none", "off"):
            return None
        raise argparse.ArgumentTypeError(
            f"--prefill-chunk expects 'auto', an int, or 0/none, got {arg!r}")
    return n if n > 0 else None


def parse_mesh(arg):
    """'DATA,MODEL' -> (data, model), with clear errors for bad input."""
    if arg is None:
        return None
    try:
        data, model = (int(x) for x in arg.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh expects 'DATA,MODEL' (two comma-separated ints), "
            f"got {arg!r}")
    if data < 1 or model < 1:
        raise argparse.ArgumentTypeError(
            f"--mesh sizes must be >= 1, got {arg!r}")
    return data, model


def parse_at(arg):
    """Comma-separated 0-based event indices ('' = none)."""
    if not arg:
        return ()
    try:
        return tuple(int(x) for x in arg.split(",") if x.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated integers, got {arg!r}")


# the architectures the CLIs drive: every batch they make is tokens only,
# and whisper (the audio family) needs frame embeddings beside them (its
# entry points take ``frames=``; the reference's CLIs pass none either)
TOKEN_ARCHS = sorted(name for name, cfg in ARCHS.items()
                     if cfg.family != "audio")


def data_for(cfg) -> SyntheticLM:
    """The synthetic token source for ``cfg`` (vocabulary capped at
    :data:`DATA_VOCAB_CAP`)."""
    return SyntheticLM(DataConfig(vocab_size=min(cfg.vocab_size,
                                                 DATA_VOCAB_CAP)))


def load_params(ckpt_dir: str, params):
    """The ``{"params"}`` of the newest complete checkpoint in
    ``ckpt_dir`` (a training checkpoint of this package or the
    reference's), on the devices of ``params``, which gives the tree's
    structure; ``params`` itself where there is no checkpoint."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return params
    print(f"loaded checkpoint step {step}")
    return ckpt.restore(ckpt_dir, step, {"params": params})["params"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=TOKEN_ARCHS)
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the {'params'} of this checkpoint's latest "
                         "step (a training checkpoint) instead of random "
                         "weights")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--method", default="faq", choices=["rtn", "awq", "faq"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--calib-n", type=int, default=16)
    ap.add_argument("--calib-len", type=int, default=64,
                    help="calibration sequence length (a multiple of 128 "
                         "runs the flash-attention kernel on the card)")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="decode batch width (continuous-batching slots)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="per-slot KV-cache capacity (prompt + new tokens)")
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="paged KV cache with shared-prefix reuse; "
                         "--no-paged keeps the dense per-slot cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical KV page (paged mode)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool capacity; default sizes it so every "
                         "slot can hold a full max_len sequence")
    ap.add_argument("--prefill-chunk", type=parse_chunk, default="auto",
                    metavar="auto|N|0",
                    help="chunked prefill: 'auto' picks the second-largest "
                         "bucket, an int rounds up to the bucket grid, 0 "
                         "restores monolithic prefill")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft depth (tokens proposed "
                         "per cycle; 0 disables)")
    ap.add_argument("--draft", default="self-int8",
                    help="draft source for --spec-k: 'self-int8' (FAQ int8 "
                         "self-draft sharing the target's KV) or a registry "
                         "config name for an independent draft model")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="DATA,MODEL",
                    help="serve tensor-parallel on a (data, model) mesh of "
                         "DATA*MODEL ranks that this command starts, e.g. "
                         "--mesh 1,4")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of --mesh (default: nccl "
                         "with --device cuda, gloo with --device cpu)")
    # -- overload response (serve/overload.py) --
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLO relative to submission; enables "
                         "SLO-aware admission (doomed requests shed early)")
    ap.add_argument("--slo-margin", type=float, default=1.0,
                    help="shed when now + margin*queue_delay_est exceeds "
                         "the deadline")
    ap.add_argument("--quota-tokens", type=int, default=0,
                    help="per-tenant in-flight token quota (0 = off)")
    # -- deterministic fault injection (serve/faults.py) --
    ap.add_argument("--fault-alloc-at", type=parse_at, default=(),
                    metavar="I,J,...",
                    help="veto the i-th page allocations (0-based) to "
                         "exercise backpressure and preemption")
    ap.add_argument("--fault-alloc-every", type=int, default=0,
                    help="veto every Nth page allocation")
    ap.add_argument("--fault-preempt-at", type=parse_at, default=(),
                    metavar="I,J,...",
                    help="force-preempt the latest-deadline slot at the "
                         "i-th serve-loop iterations")
    ap.add_argument("--fault-stall-at", type=parse_at, default=(),
                    metavar="I,J,...",
                    help="inject a slow step at the i-th loop iterations")
    ap.add_argument("--fault-stall-s", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    # -- observability (obs/) --
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the request/step trace as Chrome/"
                         "Perfetto trace_event JSON (check it with "
                         "python -m repro_torch.obs PATH)")
    ap.add_argument("--trace-capacity", type=int, default=8192,
                    help="trace ring-buffer size (oldest events drop "
                         "beyond it)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="run the serve under torch.profiler (Chrome trace "
                         "DIR/trace.json) with every engine step in a named "
                         "region")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.mesh is None:
        return serve_main(args, device)
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    store = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        n = args.mesh[0] * args.mesh[1]
        threads = (max(1, (os.cpu_count() or 1) // n)
                   if device.type == "cpu" else None)
        return spawn(_serve_rank, args.mesh, backend, store, args,
                     device=device.type, timeout=RANK_TIMEOUT_S,
                     threads=threads)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _serve_rank(mesh, args):
    return serve_main(args, mesh.device, mesh)


def serve_main(args, device, mesh=None):
    """The CLI's run on one process: a whole engine, or this rank's part of
    a mesh (rank 0 prints, exports the trace and writes the profile)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: data={mesh.size('data')} model={mesh.size('model')} "
            f"over {mesh.n_ranks} {device.type} ranks ({mesh.backend})")
    cfg = ARCHS[args.arch].tiny() if args.tiny else ARCHS[args.arch]
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    if args.ckpt_dir:
        params = load_params(args.ckpt_dir, params)
    data = data_for(cfg)
    if data.cfg.vocab_size < cfg.vocab_size:
        say(f"data vocabulary capped at {data.cfg.vocab_size} of "
              f"{cfg.vocab_size} tokens")
    calib = calibration_batches(data, args.calib_n, args.calib_len)
    stats = run_calibration(model.forward, params, calib)
    qparams, _ = quantize_model(params, model.quant_site_map(), stats,
                                method=args.method,
                                spec=QuantSpec(bits=args.bits, group_size=64),
                                mode="packed")
    del params
    spec = None
    if args.spec_k > 0:
        # the self-draft re-quantizes the *serving* weights at int8 with the
        # same calibration statistics
        draft = (self_int8_draft(model, qparams, stats)
                 if args.draft == "self-int8"
                 else registry_draft(args.draft, tiny=args.tiny,
                                     device=device))
        spec = SpecConfig(k=args.spec_k, draft=draft)
    slo = None
    if args.deadline_s is not None or args.quota_tokens > 0:
        slo = SLOConfig(margin=args.slo_margin,
                        quota_tokens=args.quota_tokens,
                        seed=args.fault_seed)
    faults = None
    if (args.fault_alloc_at or args.fault_alloc_every
            or args.fault_preempt_at or args.fault_stall_at):
        faults = FaultInjector(FaultConfig(
            seed=args.fault_seed,
            alloc_fail_at=args.fault_alloc_at,
            alloc_fail_every=args.fault_alloc_every,
            preempt_at=args.fault_preempt_at,
            stall_at=args.fault_stall_at, stall_s=args.fault_stall_s))
    tracer = (Tracer(capacity=args.trace_capacity)
              if args.trace_out else None)
    eng = ServeEngine(model, qparams,
                      n_slots=min(args.n_slots, args.requests),
                      max_len=args.max_len, paged=args.paged,
                      page_size=args.page_size, n_pages=args.n_pages,
                      prefill_chunk=args.prefill_chunk, spec=spec,
                      device=device, slo=slo, faults=faults, tracer=tracer,
                      profile=bool(args.profile_dir), mesh=mesh)
    if args.paged and not eng.paged:
        say("note: model cache layout does not support paging; serving "
              "from the dense cache")
    reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, 12),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    if args.deadline_s is not None:
        t_sub = eng.clock()
        for r in reqs:
            r.arrival = t_sub
            r.deadline = t_sub + args.deadline_s
    t0 = time.time()
    with profile_session(args.profile_dir if lead else None):
        results = eng.serve(reqs)
    dt = time.time() - t0
    tok = sum(len(v) for v in results.values())
    for rid in sorted(results):
        say(f"req {rid}: {np.asarray(results[rid]).tolist()}")
    m = eng.metrics()
    say(f"{tok} tokens in {dt:.1f}s ({tok / dt:.1f} tok/s, "
          f"{args.method} int{args.bits} packed, {device})")
    say(f"prefill: {m['prefill_batches']} batches (buckets {m['buckets']}, "
          f"chunk {m['prefill_chunk'] or 'off'}, "
          f"{m['chunked_admissions']} chunked), "
          f"decode: {m['decode_steps']} steps")
    if m["spec"]:
        say(f"spec: k={m['spec_k']} draft={m['draft_kind']}, "
              f"{m['spec_cycles']} cycles, accept_rate "
              f"{m['accept_rate']:.3f}, draft_share {m['draft_share']:.3f}, "
              f"tokens_per_step {m['tokens_per_step']:.2f}")
    if m["paged"]:
        say(f"paged: page_size={m['page_size']}, peak {m['pages_peak']}/"
              f"{m['pages_total']} pages ({m['peak_cache_bytes'] / 1e6:.2f} "
              f"MB), prefix hits {m['prefix_hits']}, cow copies "
              f"{m['cow_copies']}, preempted {m['preempted']}")
    if slo is not None or faults is not None or m["preempted"]:
        say(f"overload: shed {m['shed']} (+{m['shed_retried']} retried), "
              f"expired {m['expired']}, truncated {m['truncated']}, "
              f"preempted {m['preempted']}, resumed {m['resumed']}, "
              f"pressure events {m['pressure_events']}")
    if m["faults"] is not None:
        say(f"faults: {m['faults']}")
    if args.trace_out and lead:
        eng.export_trace(args.trace_out)
        say(f"trace: {m['trace']['events']} events "
              f"({m['trace']['dropped']} dropped) -> {args.trace_out}")
    if args.profile_dir:
        say(f"profile: torch.profiler trace in "
              f"{args.profile_dir}/trace.json")
    return results


if __name__ == "__main__":
    main()
