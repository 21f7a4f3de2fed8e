"""Dry-run of every (arch x shape cell x production mesh): what one rank
holds, moves and computes, with no compiler and no process per rank.

The port's counterpart of ``repro.launch.dryrun``.  Rank 0 of the
production mesh (16 x 16 ``(data, model)``, or 2 x 16 x 16 ``(pod, data,
model)`` with ``--multi-pod``) is a :class:`~repro_torch.dist.sharding.
MeshShape`, and the cell's step runs on meta tensors (shapes and dtypes,
nothing allocated) on rank 0's blocks:

* train cells: ``make_train_step(mesh=)`` (``remat=True``, bf16 AdamW
  moments for llama3-405b and llama4-maverick) on rank 0's shards of the
  parameters and moments (:func:`~repro_torch.dist.sharding.
  training_rules`) and its rows of the batch;
* prefill / decode cells: ``model.prefill`` / ``model.decode_step`` on the
  packed int4 tree (:func:`~repro_torch.launch.specs.
  quantized_param_specs`, groups of 128) and the cache as a serving
  engine holds them (:func:`~repro_torch.dist.sharding.serving_rules`
  over ``SERVE_PREFILL_RULES`` / ``SERVE_DECODE_RULES``: weights whole
  across the data axes, row-parallel weights' group scales cut with their
  rows; slots cut over ``(pod, data)`` where the batch divides), vlm
  caches ``patch_len`` positions longer.

Every collective on a MeshShape returns a result of the right shape
without talking, and counts its call and result-buffer bytes
(:data:`~repro_torch.dist.collectives.COUNTS`).  So each record is read off
the step's own code:

* ``memory``: rank 0's bytes, exact (block shapes x dtype sizes):
  ``params``, ``opt`` (AdamW's ``m`` / ``v`` and ``step``), ``cache``,
  ``batch``; ``argument_bytes`` (the step's inputs), ``output_bytes`` (its
  outputs: a train step's new parameters, moments and metrics, the
  update being functional; a serving step's logits and cache);
  ``temp_bytes`` is null (no compiler is asked for its buffers);
* ``collectives``: per kind, rank 0's ``calls`` and result ``bytes`` in
  one step; the calls equal the model's formula (``train_collectives``
  for a train cell, ``tp_all_reduces`` plus the logits' one all_gather for
  a serving one), which the run checks;
* ``cost``: ``model_flops``, the step's floating-point operations counted
  by ``torch.utils.flop_counter.FlopCounterMode`` over the port's own
  forward (and backward, for a train cell; no remat recompute) on one
  meta device at the cell's global batch, the layer loop at its full
  depth; ``flops_per_rank = model_flops / ranks``; ``bytes_accessed`` is
  null.  The reference records XLA's ``cost_analysis`` instead: the
  per-device operations of the compiled, partitioned program, whose layer
  loop it extrapolates from 1- and 2-layer lowerings.  The two are
  different quantities; neither is a measurement.

Records go to ``reports/dryrun_torch/<arch>__<cell>__<16x16|2x16x16>.json``
(``--out DIR`` overrides).  ``--tiny`` runs each arch's ``tiny()``
config on each cell cut by :func:`cell_for` (a sequence
:data:`TINY_SEQ_DIVISOR` times shorter, at most :data:`TINY_MAX_BATCH`
rows; its records end in ``__tiny``): seconds in all.  A cell
that :func:`~repro_torch.configs.cell_applicable` refuses is recorded as
``skipped``; a serving cell whose packed weights the port's serving engine
cannot place on the mesh (a row-parallel weight's input split that falls
neither on whole quantization groups nor inside one:
:func:`~repro_torch.dist.sharding.shard_tree` refuses it) as ``refused``,
with what is known without the step (:func:`serve_record`).  The summary
line counts each status; any ``error`` exits 1.  Nothing is set in the
environment.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --tiny \\
        --arch llama3-8b --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPE_CELLS, cell_applicable
from repro_torch.configs.base import ShapeCell
from repro_torch.core.quantizer import QuantSpec
from repro_torch.dist import collectives
from repro_torch.dist._tree import leaves, leaves_with_keys
from repro_torch.dist.sharding import (SERVE_DECODE_RULES, SERVE_PREFILL_RULES,
                                       MeshShape, axis_rules, local_shape,
                                       serving_rules, shard_tree,
                                       training_rules)
from repro_torch.launch import specs as S
from repro_torch.models.common import padded_vocab
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import (TrainConfig, make_loss_fn,
                                       make_train_step, value_and_grad)

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
MESHES = {False: (16, 16), True: (2, 16, 16)}     # make_production_mesh's
QSPEC = QuantSpec(bits=4, group_size=128)
# --tiny runs each cell's sequence this many times shorter (the Mamba and
# sLSTM scans loop over positions on the host, on the meta device too) and
# at most this many rows (the float lm_head loops over 64-row blocks): 32
# rows still split over the 2 x 16 x 16 mesh's 32 data-parallel ranks
TINY_SEQ_DIVISOR = 256
TINY_MAX_BATCH = 32


def cell_for(cell_name: str, tiny: bool = False) -> ShapeCell:
    """The shape cell ``cell_name`` (with ``tiny``: its sequence
    :data:`TINY_SEQ_DIVISOR` times shorter and at most
    :data:`TINY_MAX_BATCH` rows)."""
    cell = SHAPE_CELLS[cell_name]
    if tiny:
        cell = dataclasses.replace(
            cell, seq_len=cell.seq_len // TINY_SEQ_DIVISOR,
            global_batch=min(cell.global_batch, TINY_MAX_BATCH))
    return cell


def mesh_name(multi_pod: bool) -> str:
    return "x".join(str(s) for s in MESHES[multi_pod])


def _moment_dtype(cfg) -> str:
    """f32 AdamW moments, except the two models past 100 B parameters."""
    big = cfg.name in ("llama3-405b", "llama4-maverick-400b-a17b")
    return "bfloat16" if big else "float32"


def tree_bytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree``."""
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _rows(batch: dict, mesh, rules) -> dict:
    """Rank 0's block of each input (rows on ``batch``), as meta tensors."""
    return {k: torch.empty(local_shape(v.shape, ["batch"], mesh, rules),
                           dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def _counted(step):
    """``step()``'s result and rank 0's collectives of it: ``{kind:
    {"calls", "bytes"}}`` for every kind it ran."""
    collectives.reset_counts()
    out = step()
    calls = {k: {"calls": c["calls"], "bytes": c["bytes"]}
             for k, c in collectives.counts().items() if c["calls"]}
    return out, calls


def _check_calls(calls: dict, formula: dict, what: str):
    got = {k: c["calls"] for k, c in calls.items()}
    want = {k: n for k, n in formula.items() if n}
    if got != want:
        raise RuntimeError(f"{what}: rank 0's collectives {got} differ "
                             f"from the model's formula {want}")


def train_record(cfg, mesh_shape, batch: int, seq: int,
                 moment_dtype: str = "float32", remat: bool = True) -> dict:
    """``memory`` and ``collectives`` of one train step of ``cfg`` at a
    global ``batch x seq`` on rank 0 of a mesh of ``mesh_shape``, read off
    a meta run of ``make_train_step(mesh=)``."""
    mesh = MeshShape(mesh_shape)
    model = build_model(cfg.scaled(remat=remat))
    rules = training_rules(model.cfg, mesh)
    params = shard_tree(S.param_specs(model), model.param_axes(), mesh, rules)
    step, opt = make_train_step(
        model, TrainConfig(moment_dtype=moment_dtype), mesh=mesh)
    opt_state = opt.init(params)
    inputs = S.input_specs(cfg, ShapeCell("dryrun", seq, batch, "train"))
    rows = _rows(inputs, mesh, rules)
    (new_params, new_opt, metrics), calls = _counted(
        lambda: step(params, opt_state, rows))
    _check_calls(calls, model.train_collectives(mesh_shape, remat=remat),
                 f"{cfg.name} train on {mesh_shape}")
    memory = {"params": tree_bytes(params), "opt": tree_bytes(opt_state),
              "cache": 0, "batch": tree_bytes(rows)}
    memory["argument_bytes"] = (memory["params"] + memory["opt"]
                                + memory["batch"])
    memory["output_bytes"] = (tree_bytes(new_params) + tree_bytes(new_opt)
                              + tree_bytes(metrics))
    memory["temp_bytes"] = None
    return {"memory": memory, "collectives": calls}


def serve_record(cfg, kind: str, mesh_shape, batch: int, seq: int) -> dict:
    """``memory`` and ``collectives`` of one serving step (``kind``
    ``"prefill"`` or ``"decode"``) of the packed ``cfg`` at a global
    ``batch`` and a ``seq``-token context on rank 0 of a mesh of
    ``mesh_shape``, under the engine's serving rules.  Where the engine
    cannot place the packed weights (a row-parallel weight's input split
    falls neither on whole groups nor inside one), the record says so
    under ``refused`` and holds what is known without the step: the
    parameters' bytes under the reference's placement
    (:func:`~repro_torch.launch.specs.quantized_param_shardings`), the
    cache's and the batch's, and the formula's calls (their bytes and the
    outputs' null)."""
    mesh = MeshShape(mesh_shape)
    model = build_model(cfg)
    base = SERVE_PREFILL_RULES if kind == "prefill" else SERVE_DECODE_RULES
    rules = serving_rules(cfg, mesh, base)
    inputs = S.input_specs(cfg, ShapeCell("dryrun", seq, batch, kind))
    rows = _rows(inputs, mesh, rules)
    tokens = rows["tokens"]
    extra = {k: v for k, v in rows.items() if k != "tokens"}
    # the rank's slots: its rows of the batch, each with its whole cache
    # (a leaf's other cuts are the model axis's)
    cache_len = seq + (cfg.patch_len if cfg.family == "vlm" else 0)
    cache = shard_tree(S.cache_specs(model, tokens.shape[0], cache_len),
                       model.cache_axes(), mesh, dict(rules, batch=None))
    memory = {"params": None, "opt": 0, "cache": tree_bytes(cache),
              "batch": tree_bytes(rows), "argument_bytes": None,
              "output_bytes": None, "temp_bytes": None}
    formula = serve_collectives(model, mesh, tokens.shape[1])
    qspecs = S.quantized_param_specs(model, cfg, QSPEC)
    try:
        params = shard_tree(qspecs, model.param_axes(), mesh, rules)
    except ValueError as refusal:
        placed = S.quantized_param_shardings(mesh, model, qspecs, rules)
        dtypes = dict(leaves_with_keys(qspecs))
        memory["params"] = sum(
            math.prod(sh.local_shape) * dtypes[key].element_size()
            for key, sh in leaves_with_keys(placed))
        memory["argument_bytes"] = (memory["params"] + memory["cache"]
                                    + memory["batch"])
        return {"refused": str(refusal), "params_placement": "reference",
                "memory": memory,
                "collectives": {k: {"calls": n, "bytes": None}
                                for k, n in formula.items() if n}}

    def run():
        with torch.no_grad(), axis_rules(mesh, rules):
            if kind == "prefill":
                return model.prefill(params, tokens, cache, **extra)
            return model.decode_step(params, cache, tokens)

    (logits, new_cache), calls = _counted(run)
    _check_calls(calls, formula, f"{cfg.name} {kind} on {mesh_shape}")
    memory["params"] = tree_bytes(params)
    memory["argument_bytes"] = (memory["params"] + memory["cache"]
                                + memory["batch"])
    memory["output_bytes"] = tree_bytes(logits) + tree_bytes(new_cache)
    return {"memory": memory, "collectives": calls}


def serve_collectives(model, mesh, tokens: int) -> dict:
    """The collective calls per kind of one serving step over ``tokens``
    positions per row (a prefill's prompt, a decode step's 1) on ``mesh``:
    the model's ``tp_all_reduces`` and, where the vocabulary is cut over
    ``model``, the logits' one all_gather (the MoE family's
    ``tp_collectives``, which also counts its token exchanges).  None
    without a ``model`` axis."""
    m = mesh.size("model")
    if m == 1:
        return {}
    if model.cfg.family == "moe":
        return model.tp_collectives(mesh, tokens)
    return {"all_reduce": model.tp_all_reduces(mesh, prefill=tokens > 1),
            "all_gather": int(padded_vocab(model.cfg.vocab_size) % m == 0)}


def flops(fn) -> int:
    """The floating-point operations ``fn()`` runs, as
    ``FlopCounterMode`` counts them (matrix products and attention)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def model_flops(cfg, kind: str, batch: int, seq: int) -> int:
    """The FLOPs of one step of ``cfg`` (``kind`` ``"train"``: forward and
    backward of the loss, no remat recompute; ``"prefill"`` / ``"decode"``:
    the packed model's step over a ``seq``-token context) at a global
    ``batch``, on one meta device."""
    cfg = cfg.scaled(remat=False)
    model = build_model(cfg)
    inputs = S.input_specs(cfg, ShapeCell("dryrun", seq, batch, kind))
    if kind == "train":
        loss_fn = make_loss_fn(model, TrainConfig().moe_aux_coef)
        params = S.param_specs(model)
        return flops(lambda: value_and_grad(loss_fn, params, inputs))
    params = S.quantized_param_specs(model, cfg, QSPEC)
    cache_len = seq + (cfg.patch_len if cfg.family == "vlm" else 0)
    cache = S.cache_specs(model, batch, cache_len)
    tokens = inputs.pop("tokens")

    def step():
        with torch.no_grad():
            if kind == "prefill":
                return model.prefill(params, tokens, cache, **inputs)
            return model.decode_step(params, cache, tokens)
    return flops(step)


def run_cell(arch: str, cell_name: str, multi_pod: bool = False,
             force: bool = False, tiny: bool = False,
             out_dir: str = REPORT_DIR, _flops: dict = None) -> dict:
    """The record of one (arch, cell, mesh), read from ``out_dir`` if it
    is there (unless ``force``), else computed and written there.
    ``_flops`` caches model_flops across the two meshes of one call."""
    os.makedirs(out_dir, exist_ok=True)
    mesh = mesh_name(multi_pod)
    tag = f"{arch}__{cell_name}__{mesh}" + ("__tiny" if tiny else "")
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = ARCHS[arch].tiny() if tiny else ARCHS[arch]
    cell = cell_for(cell_name, tiny)
    record = {"arch": arch, "cell": cell_name, "mesh": mesh,
              "kind": cell.kind, "tiny": tiny}
    t0 = time.time()
    try:
        if not cell_applicable(cfg, cell):
            record["status"] = "skipped"
            record["skipped"] = ("long_500k needs sub-quadratic attention; "
                                 f"{cfg.family} is full-attention")
        else:
            shape = MESHES[multi_pod]
            b, s = cell.global_batch, cell.seq_len
            if cell.kind == "train":
                record.update(train_record(cfg, shape, b, s,
                                           _moment_dtype(cfg)))
            else:
                record.update(serve_record(cfg, cell.kind, shape, b, s))
                if "refused" in record:
                    record["status"] = "refused"
            ranks = MeshShape(shape).n_ranks
            key = (arch, cell_name, tiny)
            cache = {} if _flops is None else _flops
            if key not in cache:
                cache[key] = model_flops(cfg, cell.kind, b, s)
            record["cost"] = {"model_flops": cache[key],
                              "flops_per_rank": cache[key] / ranks,
                              "bytes_accessed": None}
            record.setdefault("status", "ok")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["seconds"] = round(time.time() - t0, 3)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[{time.strftime('%H:%M:%S')}] {tag}: {record['status']} "
          f"({record['seconds']} s){_summary(record)}", flush=True)
    return record


def _summary(record: dict) -> str:
    """A record's per-rank argument GiB and step TFLOP (its error for an
    ``error`` record)."""
    if record["status"] == "error":
        return " :: " + record["error"][:120]
    if "memory" not in record:
        return ""
    return (f" argument {record['memory']['argument_bytes'] / 2**30:.2f} "
            f"GiB a rank, {record['cost']['model_flops'] / 1e12:.4g} TFLOP "
            f"a step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--cell", default=None, choices=sorted(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true",
                    help="every arch and cell (the default without --arch "
                         "/ --cell)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 (pod, data, model) mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute records already in --out")
    ap.add_argument("--tiny", action="store_true",
                    help="each arch's tiny() config, each cell's sequence "
                         f"{TINY_SEQ_DIVISOR} times shorter, at most "
                         f"{TINY_MAX_BATCH} rows")
    ap.add_argument("--out", default=REPORT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    cells = [args.cell] if args.cell else list(SHAPE_CELLS)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_err = n_skip = n_refused = 0
    counted = {}
    for arch in archs:
        for cell in cells:
            for multi_pod in meshes:
                rec = run_cell(arch, cell, multi_pod, force=args.force,
                               tiny=args.tiny, out_dir=args.out,
                               _flops=counted)
                st = rec["status"]
                n_ok += st == "ok"
                n_err += st == "error"
                n_skip += st == "skipped"
                n_refused += st == "refused"
    print(f"done: {n_ok} ok, {n_skip} skipped-by-design, {n_refused} "
          f"refused-by-the-engine, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
