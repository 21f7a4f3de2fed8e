"""The port's sharding rules, mesh planning and shard cutting, against
``repro.dist`` on the same inputs (CPU, one process, no process group).

``logical_to_spec`` must give the reference's ``PartitionSpec`` entries
over a grid of axes, shapes, rule tables and mesh sizes; ``plan_mesh``
the reference's plan (or error) over a grid of chips, model and pods.
``shard_tree`` has no reference counterpart (GSPMD places the reference's
shards): each rank's cut of a packed tiny llama3-8b is held against the
whole leaf.
"""
import itertools
import logging

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model, run_calibration
from repro_torch.core.quantizer import dequantize_groupwise
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        calibration_batches)
from repro_torch.dist import elastic as t_elastic
from repro_torch.dist import sharding as ts
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.registry import build_model


class FakeMesh:
    """Axis sizes, and this rank's coordinates for shard cutting."""

    def __init__(self, shape, coords=None):
        self.shape = dict(shape)
        self.coords = dict(coords or {})

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)


AXES = [
    ["batch", None, "kv_heads", None],
    ["batch", None, "heads", None],
    [None, "batch", "kv_heads", "kv_seq", None],
    ["batch", "seq", "ff"],
    ["batch", "seq", "vocab"],
    ["vocab", "fsdp"],
    ["fsdp", "vocab"],
    [None, "experts", "fsdp", None],
    [None, "fsdp", "heads"],
    ["qin", "qout"],
    ["qgroups", "qout"],
    ["batch"],
    ["embed", "nonexistent"],
]
SHAPES = [(256, 1, 8, 128), (4, 256, 5, 4096, 128), (2, 16, 14336),
          (128256, 4096), (24, 64, 2048, 1408), (3, 7, 11, 13, 17)]
MESHES = [{"data": 16, "model": 16}, {"data": 1, "model": 2},
          {"data": 2, "model": 4}, {"pod": 2, "data": 16, "model": 16},
          {"model": 8}, {"data": 4}]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: under
    pytest-xdist several workers each spinning a full thread pool on the
    same cores made them many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_logical_to_spec_equals_the_reference():
    from repro.dist import sharding as js
    tables = [(ts.DEFAULT_RULES, js.DEFAULT_RULES),
              (ts.SERVE_PREFILL_RULES, js.SERVE_PREFILL_RULES),
              (ts.SERVE_DECODE_RULES, js.SERVE_DECODE_RULES)]
    for t_rules, j_rules in tables:
        assert t_rules == j_rules
    n = 0
    for axes, shape, sizes, (t_rules, j_rules) in itertools.product(
            AXES, SHAPES, MESHES, tables):
        ax = (list(axes) + [None] * len(shape))[:len(shape)]
        mesh = FakeMesh(sizes)
        got = ts.logical_to_spec(ax, shape=shape, mesh=mesh, rules=t_rules)
        want = js.logical_to_spec(ax, shape=shape, mesh=mesh, rules=j_rules)
        assert got == tuple(want), (ax, shape, sizes)
        n += 1
    assert n > 1000


def test_warn_once_keyed_on_the_logical_name(caplog):
    axes = ["batch", None, "kv_heads", None]
    shape = (259, 3, 13, 131)
    with caplog.at_level(logging.WARNING, logger="repro_torch.dist.sharding"):
        ts._warn_dropped(axes, shape, 2, "kv_heads", ("model",), 16)
        ts._warn_dropped(axes, shape, 2, "kv_heads", ("model",), 16)
        ts._warn_dropped(axes, shape, 2, "kv_seq", ("model",), 16)
        warns = [r for r in caplog.records if "NOT sharded" in r.message]
        assert len(warns) == 2
        assert "kv_heads" in warns[0].message
        assert "kv_seq" in warns[1].message
        # through logical_to_spec: one warning per site, none for size 1
        mesh = FakeMesh({"data": 16, "model": 16})
        for _ in range(3):
            ts.logical_to_spec(["batch", None, "kv_heads", None],
                               shape=(256, 4, 10, 129), mesh=mesh,
                               rules=ts.DEFAULT_RULES)
        ts.logical_to_spec(["batch", "kv_heads"], shape=(256, 1), mesh=mesh,
                           rules=ts.DEFAULT_RULES)
        warns = [r for r in caplog.records if "NOT sharded" in r.message]
        assert len(warns) == 3


def test_row_parallel_rebinds_qin():
    mesh = FakeMesh({"data": 1, "model": 4})
    with ts.axis_rules(mesh, ts.SERVE_DECODE_RULES):
        assert ts.active_rule("qin") is None
        with ts.row_parallel():
            assert ts.active_rule("qin") == "model"
            assert ts.active_rule("heads") == "model"
        assert ts.active_rule("qin") is None
        assert ts.axis_size("model") == 4 and ts.axis_index("model") == 0
    with ts.axis_rules(mesh, ts.DEFAULT_RULES):
        with ts.row_parallel():
            assert ts.active_rule("qin") == ts.DEFAULT_RULES["qin"]
    with ts.row_parallel():
        assert ts.active_rule("qin") == ts.DEFAULT_RULES["qin"]
    assert ts.active_mesh() is None and ts.axis_size("model") == 1


def _plan_or_error(fn, chips, model, pods, old):
    try:
        return ("ok", tuple(fn(chips, model=model, old_data=old, pods=pods)))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def test_plan_mesh_equals_the_reference():
    from repro.dist import elastic as je
    cases = list(itertools.product(range(0, 34, 3), (0, 1, 2, 4, 16),
                                   (0, 1, 2), (None, 4)))
    kinds = set()
    for chips, model, pods, old in cases:
        got = _plan_or_error(t_elastic.plan_mesh, chips, model, pods, old)
        want = _plan_or_error(je.plan_mesh, chips, model, pods, old)
        assert got == want, (chips, model, pods, old)
        kinds.add(got[0])
    assert kinds == {"ok", "ValueError", "RuntimeError"}
    plan = t_elastic.plan_mesh(12, model=4, old_data=4)
    assert (plan.data, plan.used_chips, plan.data_scale) == (3, 12, 0.75)
    plan = t_elastic.plan_mesh(2, model=2, old_data=2)
    assert (plan.data, plan.model, plan.idle_chips) == (1, 2, 0)


def test_mesh_refuses_too_few_ranks():
    with pytest.raises(ValueError, match=r"requires 16 devices but only 1 "
                                         r"are available"):
        make_local_mesh(4, 4)
    with pytest.raises(ValueError, match=r"requires 256 devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match=r"requires 512 devices"):
        make_production_mesh(multi_pod=True)
    mesh = make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.n_ranks == 1


@pytest.fixture(scope="module")
def packed_tiny():
    cfg = ARCHS["llama3-8b"].tiny().scaled(n_kv_heads=4)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    stats = run_calibration(model.forward, params,
                            calibration_batches(data, 2, 32))
    qp, _ = quantize_model(params, model.quant_site_map(), stats,
                           method="faq", spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    return cfg, model, qp


def _rank_trees(qp, model, m, rules):
    return [ts.shard_tree(qp, model.param_axes(),
                          FakeMesh({"data": 1, "model": m}, {"model": r}),
                          rules)
            for r in range(m)]


def _dense(qt, layer):
    return dequantize_groupwise(qt[layer]) / qt.act_scale[layer][:, None]


@pytest.mark.parametrize("m", [2, 4])
def test_shard_tree_cuts_packed_leaves(packed_tiny, m):
    cfg, model, qp = packed_tiny
    rules = ts.serving_rules(cfg, FakeMesh({"data": 1, "model": m}))
    assert rules["heads"] == "model" and rules["fsdp"] is None
    trees = _rank_trees(qp, model, m, rules)
    wq, wo = qp["blocks"]["wq"], qp["blocks"]["wo"]
    for r, tree in enumerate(trees):
        q, o = tree["blocks"]["wq"], tree["blocks"]["wo"]
        # wq column-parallel: codes, scale, zero split on n_out
        n_out = wq.codes.shape[-1] // m
        assert q.codes.shape == wq.codes.shape[:-1] + (n_out,)
        assert q.scale.shape == wq.scale.shape[:-1] + (n_out,)
        assert q.n_in == wq.n_in
        assert torch.equal(q.codes, wq.codes[..., r * n_out:(r + 1) * n_out])
        # wo row-parallel: codes split on packed rows
        rows = wo.n_in // m
        assert o.n_in == rows and o.codes.shape[-2] == rows // 2
        assert torch.equal(o.act_scale,
                           wo.act_scale[:, r * rows:(r + 1) * rows])
        for leaf in (q.codes, q.scale, q.zero, o.codes, o.scale, o.zero,
                     tree["embed"], tree["lm_head"]):
            assert leaf.is_contiguous()
            assert leaf.untyped_storage().data_ptr() not in {
                t.untyped_storage().data_ptr() for t in
                (wq.codes, wq.scale, wq.zero, wo.codes, wo.scale, wo.zero,
                 qp["embed"], qp["lm_head"])}
        # norms are replicated: the leaf itself
        assert tree["blocks"]["attn_norm"] is qp["blocks"]["attn_norm"]
    # the concatenated shards are the whole leaf: raw children on their
    # split dims, and the dequantized weights (wo at m = 4 splits inside
    # a group of 64 rows: its shards copy the group's scale and zero)
    for key, dim in (("wq", -1), ("wk", -1), ("wv", -1), ("w_gate", -1),
                     ("w_up", -1)):
        for child in ("codes", "scale", "zero"):
            whole = getattr(qp["blocks"][key], child)
            cat = torch.cat([getattr(t["blocks"][key], child)
                             for t in trees], dim)
            assert torch.equal(cat, whole), (key, child)
    for key in ("wo", "w_down"):
        assert torch.equal(
            torch.cat([t["blocks"][key].codes for t in trees], -2),
            qp["blocks"][key].codes)
        for layer in range(cfg.n_layers):
            cat = torch.cat([_dense(t["blocks"][key], layer) for t in trees],
                            0)
            torch.testing.assert_close(cat, _dense(qp["blocks"][key], layer),
                                       rtol=0, atol=0)
    assert torch.equal(torch.cat([t["embed"] for t in trees], 0), qp["embed"])
    assert torch.equal(torch.cat([t["lm_head"] for t in trees], 1),
                       qp["lm_head"])


def test_shard_tree_replicates_attention_that_does_not_divide(packed_tiny):
    cfg, model, qp = packed_tiny
    mesh = FakeMesh({"data": 1, "model": 8}, {"model": 3})
    rules = ts.serving_rules(cfg, mesh)      # KH 4 on model 8
    assert rules["heads"] is None and rules["kv_heads"] is None
    tree = ts.shard_tree(qp, model.param_axes(), mesh, rules)
    for key in ("wq", "wk", "wv", "wo"):
        assert tree["blocks"][key] is qp["blocks"][key]
    assert tree["blocks"]["w_gate"].codes.shape[-1] == cfg.d_ff // 8
    assert ts.local_shape((4, 2, 4, 64, 32), model.cache_axes()["k"], mesh,
                          dict(rules, batch=None)) == (4, 2, 4, 64, 32)
    mesh2 = FakeMesh({"data": 2, "model": 2})
    rules2 = ts.serving_rules(cfg, mesh2)
    assert ts.local_shape((4, 2, 4, 64, 32), model.cache_axes()["k"], mesh2,
                          rules2) == (4, 1, 2, 64, 32)
    assert ts.local_shape((4, 9, 4, 16, 32),
                          model.paged_cache_axes()["k"], mesh2,
                          rules2) == (4, 9, 2, 16, 32)


def test_shard_tree_refuses_a_split_across_groups():
    w = torch.randn(192, 8)
    from repro_torch.core.quantizer import quantize_groupwise
    qt = quantize_groupwise(w, QuantSpec(bits=4, group_size=64), pack=True)
    mesh = FakeMesh({"data": 1, "model": 2}, {"model": 1})
    with pytest.raises(ValueError, match="neither on whole groups"):
        ts.shard_leaf(qt, ("ff", None), mesh, ts.DEFAULT_RULES)
    # a split on whole groups works, and a column split has no group rule
    mesh3 = FakeMesh({"data": 1, "model": 3}, {"model": 2})
    cut = ts.shard_leaf(qt, ("ff", None), mesh3, ts.DEFAULT_RULES)
    assert cut.n_in == 64 and cut.scale.shape == (1, 8)
    assert torch.equal(cut.scale, qt.scale[2:3])
    np.testing.assert_array_equal(
        dequantize_groupwise(cut).numpy(),
        dequantize_groupwise(qt)[128:].numpy())


def test_launch_refusals(monkeypatch):
    """The serve CLI's --mesh parser and the launcher's backend rules: nccl
    takes one card per rank and refuses more ranks than cards, naming
    both counts."""
    import argparse

    from repro_torch.launch import mesh as lm
    from repro_torch.launch.serve import parse_mesh
    assert parse_mesh("1,4") == (1, 4) and parse_mesh(None) is None
    for bad, msg in (("4", "DATA,MODEL"), ("a,b", "DATA,MODEL"),
                     ("0,2", ">= 1")):
        with pytest.raises(argparse.ArgumentTypeError, match=msg):
            parse_mesh(bad)
    with pytest.raises(ValueError, match="gloo"):
        lm.check_ranks(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        lm.check_ranks(2, "mpi", "cpu")
    lm.check_ranks(4, "gloo", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks but only 1 CUDA devices"):
        lm.check_ranks(2, "nccl", "cuda")
    lm.check_ranks(2, "gloo", "cuda")      # two ranks may share a card
