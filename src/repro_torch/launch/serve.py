"""Serving entry point: init, calibrate, FAQ-quantize to packed int4, and
serve synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --tiny --device cpu --requests 4
    # speculative decoding, FAQ int8 self-draft, 3 proposals per cycle
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --spec-k 3 --draft self-int8

Runs on the card by default (``--device cuda``) and fails there is none.
At full width (``--no-tiny``) the synthetic data vocabulary is capped at
``DATA_VOCAB_CAP`` tokens: the data generator keeps a dense (v, v)
float64 transition matrix, which at llama3's 128256-token vocabulary
would need ~2 x 131 GB of host memory.  The model keeps its full
embedding and head; only the token ids drawn for prompts and
calibration come from the capped range.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model, run_calibration
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        calibration_batches)
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.draft import registry_draft, self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig

DATA_VOCAB_CAP = 4096


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


def data_for(cfg) -> SyntheticLM:
    """The synthetic token source for ``cfg`` (vocabulary capped at
    :data:`DATA_VOCAB_CAP`)."""
    return SyntheticLM(DataConfig(vocab_size=min(cfg.vocab_size,
                                                 DATA_VOCAB_CAP)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    ap.add_argument("--seed", type=int, default=0)
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].tiny() if args.tiny else ARCHS[args.arch]
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    data = data_for(cfg)
    if data.cfg.vocab_size < cfg.vocab_size:
        print(f"data vocabulary capped at {data.cfg.vocab_size} of "
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
    eng = ServeEngine(model, qparams,
                      n_slots=min(args.n_slots, args.requests),
                      max_len=args.max_len, paged=args.paged,
                      page_size=args.page_size, n_pages=args.n_pages,
                      prefill_chunk=args.prefill_chunk, spec=spec,
                      device=device)
    if args.paged and not eng.paged:
        print("note: model cache layout does not support paging; serving "
              "from the dense cache")
    reqs = [Request(rid=i, prompt=data.sequence(40_000_000 + i, 12),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    results = eng.serve(reqs)
    dt = time.time() - t0
    tok = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"req {rid}: {np.asarray(results[rid]).tolist()}")
    m = eng.metrics()
    print(f"{tok} tokens in {dt:.1f}s ({tok / dt:.1f} tok/s, "
          f"{args.method} int{args.bits} packed, {device})")
    print(f"prefill: {m['prefill_batches']} batches (buckets {m['buckets']}, "
          f"chunk {m['prefill_chunk'] or 'off'}, "
          f"{m['chunked_admissions']} chunked), "
          f"decode: {m['decode_steps']} steps")
    if m["spec"]:
        print(f"spec: k={m['spec_k']} draft={m['draft_kind']}, "
              f"{m['spec_cycles']} cycles, accept_rate "
              f"{m['accept_rate']:.3f}, draft_share {m['draft_share']:.3f}, "
              f"tokens_per_step {m['tokens_per_step']:.2f}")
    if m["paged"]:
        print(f"paged: page_size={m['page_size']}, peak {m['pages_peak']}/"
              f"{m['pages_total']} pages ({m['peak_cache_bytes'] / 1e6:.2f} "
              f"MB), prefix hits {m['prefix_hits']}, cow copies "
              f"{m['cow_copies']}, preempted {m['preempted']}")
    return results


if __name__ == "__main__":
    main()
