"""The port's dry-run (``repro_torch.launch.specs`` / ``dryrun``) against
the reference's specs, and its meta-device counts against real tensors.

``repro.launch.specs`` and ``repro.configs`` are imported here, never
``repro.launch.dryrun``, which sets ``XLA_FLAGS`` at import.  The
reference's shardings are ``NamedSharding`` trees on a real mesh; here its
``NamedSharding`` is replaced by the bare spec, and its mesh by a fake one
that has only axis sizes (as tests/test_sharding.py builds one), so the
spec tuples compare on the production meshes with no devices.

Differences from the reference that are there by design, pinned by name:

* ``PORT_AXES``: the leaves whose logical axes the port annotates
  otherwise (attention's K / V projections column-parallel on
  ``kv_heads``, hymba's Mamba ``in_proj`` as two ``ff`` parts, ...);
* where a row-parallel weight's input split falls inside one
  quantization group, a serving engine keeps that group's one ``scale`` /
  ``zero`` row, where the reference's ``quantized_param_shardings``
  keeps every group (ROADMAP section 3, "splits that are there by
  design"); where it falls neither on groups nor inside one, the engine
  refuses the mesh (``ENGINE_REFUSES``).

The reference's ``quantized_param_shardings`` is held as it runs: its
docstring keeps the group scales' output cut only and replicates
``act_scale``, but no child is told apart under this jax (ROADMAP
section 3), so every child takes the weight's axes.
"""
import functools
import re

import jax
import numpy as np
import pytest
import torch

import repro.dist.sharding as ref_sharding
import repro.launch.specs as RS
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import cell_applicable as ref_cell_applicable
from repro.core import QuantSpec as RefQuantSpec
from repro.core.quantizer import QuantizedTensor as RefQT
from repro.models.registry import build_model as ref_build
from repro_torch.configs import ARCHS, SHAPE_CELLS, cell_applicable
from repro_torch.core.quantizer import QuantizedTensor, QuantSpec
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.dist.sharding import (DEFAULT_RULES, SERVE_DECODE_RULES,
                                       SERVE_PREFILL_RULES, MeshShape,
                                       serving_rules, shard_tree)
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import make_loss_fn, value_and_grad

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
_KV = ("['blocks']['wk']", "['blocks']['wv']")
PORT_AXES = {
    "stablelm-12b": _KV, "llama3-405b": _KV, "llama3-8b": _KV,
    "deepseek-coder-33b": _KV, "llama4-maverick-400b-a17b": _KV,
    "qwen2-moe-a2.7b": _KV, "qwen2-vl-2b": _KV,
    "hymba-1.5b": _KV + ("['blocks']['mamba']['dt_proj']",
                         "['blocks']['mamba']['in_proj']",
                         "['blocks']['mamba']['d_skip']"),
    "xlstm-350m": ("['blocks']['mlstm']['up_proj']",
                   "['blocks']['mlstm']['down_proj']"),
    "whisper-small": tuple(f"['{s}']['{a}']['{w}']"
                           for s, a in (("enc_blocks", "attn"),
                                        ("dec_blocks", "attn"),
                                        ("dec_blocks", "cross"))
                           for w in ("wk", "wv"))
    + ("['enc_blocks']['b1']", "['dec_blocks']['b1']"),
}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


class _Spec:
    """A stand-in for the reference's NamedSharding: its spec, as a leaf."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Spec)
    monkeypatch.setattr(RS, "NamedSharding", _Spec)


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in leaves_with_keys(tree)}


def _padded(spec, ndim) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _pinned(key: str, arch: str) -> bool:
    return any(key.startswith(p) for p in PORT_AXES[arch])


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    """The reference's full-size param specs of ``arch`` (jax.eval_shape of
    its init, ~1 s each: made once for the tests that read them)."""
    return RS.param_specs(ref_build(REF_ARCHS[arch]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_applicable_equals_the_reference(arch):
    for name, cell in SHAPE_CELLS.items():
        assert cell_applicable(ARCHS[arch], cell) == ref_cell_applicable(
            REF_ARCHS[arch], REF_CELLS[name]), (arch, name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_references_leaf_for_leaf(arch):
    """At tiny(): every cell's inputs, the params, the packed tree (groups
    of 128), a 2 x 64 cache and the calibration statistics, shape and
    dtype per leaf, against jax.eval_shape of the reference's; the params
    at full size too."""
    rc, tc = REF_ARCHS[arch].tiny(), ARCHS[arch].tiny()
    rm, tm = ref_build(rc), build_model(tc)
    pairs = [(RS.param_specs(rm), S.param_specs(tm)),
             (RS.quantized_param_specs(rm, rc, RefQuantSpec(bits=4,
                                                            group_size=128)),
              S.quantized_param_specs(tm, tc, QuantSpec(bits=4,
                                                        group_size=128))),
             (RS.cache_specs(rm, 2, 64), S.cache_specs(tm, 2, 64)),
             (RS.stats_specs(rm, rc), S.stats_specs(tm, tc))]
    pairs += [(RS.input_specs(rc, REF_CELLS[c]), S.input_specs(tc, cell))
              for c, cell in SHAPE_CELLS.items()]
    pairs.append((_ref_params(arch), S.param_specs(build_model(ARCHS[arch]))))
    for ref, port in pairs:
        assert _port_leaves(port) == _ref_leaves(ref), arch


def test_llama4_maverick_parameter_count():
    n = sum(x.numel() for _, x in leaves_with_keys(
        S.param_specs(build_model(ARCHS["llama4-maverick-400b-a17b"]))))
    ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        _ref_params("llama4-maverick-400b-a17b")))
    assert n == ref and round(n / 1e9, 2) == 784.26


def _ref_qtree(port_q):
    """The port's packed meta tree as the reference's tree of
    ShapeDtypeStructs (the two are equal leaf for leaf, above)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, QuantizedTensor):
            return RefQT(codes=conv(x.codes), scale=conv(x.scale),
                         zero=conv(x.zero), spec=RefQuantSpec(
                             bits=x.spec.bits, group_size=x.spec.group_size),
                         n_in=x.n_in, packed=x.packed,
                         act_scale=conv(x.act_scale))
        return jax.ShapeDtypeStruct(tuple(x.shape), str(x.dtype).replace(
            "torch.", ""))
    return conv(port_q)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shardings_equal_the_references_specs(bare_specs, arch, mesh_name):
    """At full size on 16 x 16 and 2 x 16 x 16: the port's spec of every
    param leaf (DEFAULT_RULES) and every packed leaf (the default and both
    serving tables) equals the reference's logical_to_spec, except the
    leaves PORT_AXES pins, whose annotations differ by design; each local
    shape is the shape cut by its spec."""
    cfg = ARCHS[arch]
    tm, rm = build_model(cfg), ref_build(REF_ARCHS[arch])
    mesh, fake = MeshShape(tuple(MESHES[mesh_name].values())), \
        FakeMesh(MESHES[mesh_name])
    p = S.param_specs(tm)
    q = S.quantized_param_specs(tm, cfg, QuantSpec(bits=4, group_size=128))
    pairs = [(S.param_shardings(mesh, tm, p, DEFAULT_RULES),
              RS.param_shardings(fake, rm, _ref_params(arch)), p)]
    for rules in (DEFAULT_RULES, SERVE_PREFILL_RULES, SERVE_DECODE_RULES):
        pairs.append((S.quantized_param_shardings(mesh, tm, q, rules),
                      RS.quantized_param_shardings(fake, rm, _ref_qtree(q),
                                                   rules=rules), q))
    for port, ref, shapes in pairs:
        ref = {jax.tree_util.keystr(k): v.spec
               for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
        port = dict(leaves_with_keys(port))
        sizes = dict(leaves_with_keys(shapes))
        assert sorted(port) == sorted(ref)
        differ = set()
        for key, sh in port.items():
            shape = tuple(sizes[key].shape)
            if sh.spec != _padded(ref[key], len(shape)):
                differ.add(key)
            if not any(isinstance(e, tuple) for e in sh.spec):
                assert sh.local_shape == tuple(
                    n // (1 if e is None else mesh.size(e))
                    for n, e in zip(shape, sh.spec)), key
        assert all(_pinned(k, arch) for k in differ), sorted(differ)


# the leaf whose input split (16 ranks of model) falls neither on whole
# groups of 128 nor inside one, so that a serving engine refuses the
# production meshes (llama3-8b / -405b, llama4-maverick and xlstm place)
ENGINE_REFUSES = {
    "stablelm-12b": "['blocks']['w_down']",
    "deepseek-coder-33b": "['blocks']['w_down']",
    "qwen2-moe-a2.7b": "['blocks']['wd_sh']",
    "qwen2-vl-2b": "['blocks']['w_down']",
    "hymba-1.5b": "['blocks']['w_down']",
    "whisper-small": "['enc_blocks']['w2']",
}


def _engine_vs_reference(cfg, shape):
    """{key: (engine block shape, quantized_param_shardings' local shape)}
    of the packed leaves where the two part, under the serving rules."""
    model = build_model(cfg)
    mesh = MeshShape(shape)
    rules = serving_rules(cfg, mesh, SERVE_DECODE_RULES)
    q = S.quantized_param_specs(model, cfg, QuantSpec(bits=4,
                                                      group_size=128))
    held = dict(leaves_with_keys(shard_tree(q, model.param_axes(), mesh,
                                            rules)))
    ref = dict(leaves_with_keys(S.quantized_param_shardings(mesh, model, q,
                                                            rules)))
    return {k: (tuple(x.shape), ref[k].local_shape) for k, x in held.items()
            if tuple(x.shape) != ref[k].local_shape}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_placement_against_the_references(arch, mesh_name):
    """What a serving engine holds (shard_tree under serving_rules, the
    dry-run's bytes) against quantized_param_shardings at the production
    meshes: the same blocks where the engine places the packed tree; the
    archs of ENGINE_REFUSES refused, naming the leaf."""
    shape = tuple(MESHES[mesh_name].values())
    if arch in ENGINE_REFUSES:
        with pytest.raises(ValueError, match=re.escape(ENGINE_REFUSES[arch])
                           + ".*neither on whole groups"):
            _engine_vs_reference(ARCHS[arch], shape)
    else:
        assert _engine_vs_reference(ARCHS[arch], shape) == {}


def test_engine_keeps_one_group_row_inside_a_group():
    """Where a row split falls inside one group (tiny llama3-8b's w_down:
    256 rows in 2 groups of 128, on 4 ranks of model), the engine keeps
    that group's one scale / zero row; the reference's rule, whose 2
    groups do not split in 4, keeps both."""
    got = _engine_vs_reference(ARCHS["llama3-8b"].tiny(), (1, 4))
    assert got == {f"['blocks']['w_down'][<flat index {i}>]":
                   ((4, 1, 128), (4, 2, 128)) for i in (1, 2)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_tiny_cell_runs_or_is_skipped(tmp_path, arch):
    """run_cell --tiny for every (cell x mesh): ok where cell_applicable
    says, skipped (the reference's reason) elsewhere, no error; an ok
    record has exact memory, collectives that passed the formula check,
    and model_flops."""
    cfg, counted = ARCHS[arch], {}
    for name, cell in SHAPE_CELLS.items():
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, name, multi_pod, tiny=True,
                                  out_dir=str(tmp_path), _flops=counted)
            want = "ok" if cell_applicable(cfg, cell) else "skipped"
            assert rec["status"] == want, (arch, name, rec.get("error"))
            if want == "skipped":
                assert "sub-quadratic" in rec["skipped"]
                continue
            mem = rec["memory"]
            assert mem["argument_bytes"] == (mem["params"] + mem["opt"]
                                             + mem["cache"]
                                             + mem["batch"]) > 0
            assert mem["temp_bytes"] is None
            assert rec["cost"]["model_flops"] > 0
            assert rec["cost"]["flops_per_rank"] == \
                rec["cost"]["model_flops"] / (512 if multi_pod else 256)


def _cpu_batch(cfg, b=2, t=32):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0, b, t).items()}
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.encoder_len, cfg.d_model,
                                      generator=gen)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(b, cfg.patch_len, cfg.d_model,
                                       generator=gen)
    return batch


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-2b", "hymba-1.5b", "xlstm-350m",
                                  "whisper-small"])
def test_meta_flop_count_equals_cpu(arch):
    """FlopCounterMode over a forward on the meta device equals the same
    on CPU tensors; llama3-8b.tiny() at 2 x 32 tokens: 88,080,384.  For
    llama3-8b also a loss's forward + backward, as dryrun.model_flops
    counts a train step."""
    cfg = ARCHS[arch].tiny()
    model = build_model(cfg)
    cpu = _cpu_batch(cfg)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in cpu.items()}
    params = model.init(0, device="cpu")
    with torch.no_grad():
        fwd_cpu = dryrun.flops(lambda: model.forward(params, cpu))
        fwd_meta = dryrun.flops(lambda: model.forward(S.param_specs(model),
                                                      meta))
    assert fwd_meta == fwd_cpu > 0
    if arch != "llama3-8b":
        return
    assert fwd_cpu == 88_080_384
    loss_fn = make_loss_fn(model, 0.01)
    train_cpu = dryrun.flops(lambda: value_and_grad(loss_fn, params, cpu))
    assert dryrun.model_flops(cfg, "train", 2, 32) == train_cpu > fwd_cpu
