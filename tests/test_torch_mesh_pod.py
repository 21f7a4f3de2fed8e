"""Training on a ``(pod, data, model)`` mesh in the port
(``make_train_step(mesh=)``: batch and FSDP cut over ``pod * data``,
tensor parallelism over ``model``), on CPU ranks over gloo.

A pod mesh's data-parallel ranks are its ``(pod, data)`` coordinates read
row-major, one process group over both axes, so ``(2, 2, 1)`` has the
members, the rows and the collectives of ``(4, 1)`` and ``(2, 1, 2)``
those of ``(2, 2)``: the two are held bit for bit (losses, grad_norms,
params and moments after 2 steps).  ``(2, 2, 1)`` is held to single-device
port training within tests/test_torch_mesh_train.py's limits (loss and
grad_norm 1e-5 relative; params 1e-3 and moments 5e-4 of each leaf's
max).  Collectives per step (``COUNTS``) equal
:func:`repro_torch.train.trainer.step_collectives`, and each rank's state
bytes and per-step collectives (calls and result bytes) equal the
dry-run's prediction for its config and mesh
(:func:`repro_torch.launch.dryrun.train_record`).  Model: tiny llama3-8b
in f32 at 2 layers (hymba-1.5b's tiny, whose Mamba ``dt_proj`` is used on
a rank's channels, for the ``(2, 1, 2)`` / ``(2, 2)`` pair), global batch
4 x 32.

One spawn of 4 ranks builds every mesh over the same ranks; the rank
function imports nothing of jax (a spawned rank imports this module).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import collectives
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import (TrainConfig, data_rank,
                                       make_train_step, shard_params,
                                       state_specs, step_collectives)

SPAWN = dict(threads=1, timeout=300)
L, B, T, STEPS = 2, 4, 32, 2
LR = 3e-3
SHAPES = ((2, 2, 1), (4, 1), (2, 1, 2), (2, 2))
PAIRS = (((2, 2, 1), (4, 1)), ((2, 1, 2), (2, 2)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch="llama3-8b"):
    return ARCHS[arch].tiny().scaled(n_layers=L)


def _tcfg():
    return TrainConfig(lr=LR, warmup=1, total_steps=10)


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in leaves_with_keys(tree)}


def _mesh(mesh, shape):
    if len(shape) == 3:
        return make_local_mesh(shape[1], shape[2], device=mesh.device,
                               pod=shape[0])
    return make_local_mesh(*shape, device=mesh.device)


def _run(m, cfg, steps, state=None, first=0):
    """``steps`` steps from seed-0 params (or ``state``) on this rank's
    shards of ``m``; returns (model, params, opt, [metrics], [counts],
    state bytes at the start)."""
    model = build_model(cfg)
    step_fn, opt = make_train_step(model, _tcfg(), mesh=m)
    if state is None:
        params = shard_params(model, model.init(0, device="cpu"), m)
        st = opt.init(params)
    else:
        params, st = state
    held = dryrun.tree_bytes({"params": params, "opt": st})
    host, n_hosts = data_rank(m)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    mets, counts = [], []
    for s in range(first, first + steps):
        collectives.reset_counts()
        params, st, met = step_fn(params, st, data.batch(
            s, B // n_hosts, T, host=host, n_hosts=n_hosts))
        counts.append({k: {"calls": c["calls"], "bytes": c["bytes"]}
                       for k, c in collectives.counts().items()
                       if c["calls"]})
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    return model, params, st, mets, counts, held


def _all_ranks(flag: bool) -> bool:
    """``flag`` held on every rank of the default group."""
    t = torch.tensor(int(flag))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def _rank_checks(mesh, ckpt_dir):
    """Every mesh of the file on this rank; rank 0's numbers come back
    (numpy), the dry-run checks as flags held on every rank."""
    out = {"llama": {}, "hymba": {}}
    for shape in SHAPES:
        m = _mesh(mesh, shape)
        model, p, st, mets, counts, held = _run(m, _cfg(), STEPS)
        host = ckpt.gather_to_host({"params": p, "opt": st}, m,
                                   state_specs(model, m))
        want = dryrun.train_record(_cfg(), shape, B, T, remat=False)
        mem = want["memory"]
        out["llama"][shape] = dict(
            metrics=mets, counts=counts,
            state=None if host is None else _np(host),
            dryrun_bytes=_all_ranks(held == mem["params"] + mem["opt"]),
            dryrun_counts=_all_ranks(
                counts == [want["collectives"]] * STEPS))
        if shape == (2, 2, 1):
            out["ckpt"] = _save_and_resume(m, model, p, st, ckpt_dir)
    for shape in PAIRS[1]:
        m = _mesh(mesh, shape)
        model, p, st, mets, _, _ = _run(m, _cfg("hymba-1.5b"), STEPS)
        host = ckpt.gather_to_host({"params": p, "opt": st}, m,
                                   state_specs(model, m))
        out["hymba"][shape] = dict(
            metrics=mets, state=None if host is None else _np(host))
    return out


def _save_and_resume(m, model, params, st, ckpt_dir):
    """The (2, 2, 1) state saved once by rank 0, restored whole and written
    again by a single-device save (byte for byte the same files); then a
    (1, 2) mesh over ranks 0 and 1 resumes it for one step."""
    a, b = os.path.join(ckpt_dir, "pod"), os.path.join(ckpt_dir, "single")
    tree = {"params": params, "opt": st}
    ckpt.save_async(a, STEPS, tree, mesh=m, specs=state_specs(model, m))
    ckpt.wait_pending()
    dist.barrier()
    out = {}
    whole = ckpt.restore(a, STEPS, tree, device="cpu")
    if m.rank == 0:
        ckpt.save(b, STEPS, whole)
        out["bytes_equal"] = {
            f: open(os.path.join(a, f"step_{STEPS:08d}", f), "rb").read()
            == open(os.path.join(b, f"step_{STEPS:08d}", f), "rb").read()
            for f in ("data.bin", "manifest.json")}
        out["listing"] = sorted(os.listdir(a))
    dist.barrier()
    small = make_local_mesh(1, 2, device=m.device)
    if small is not None:
        fresh = shard_params(model, model.init(1, device="cpu"), small)
        _, opt = make_train_step(model, _tcfg(), mesh=small)
        back = ckpt.restore(a, STEPS, {"params": fresh,
                                       "opt": opt.init(fresh)},
                            mesh=small, specs=state_specs(model, small))
        out["resumed"] = _run(small, _cfg(), 1, (back["params"], back["opt"]),
                              first=STEPS)[3]
    return out


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    return spawn(_rank_checks, (4, 1), "gloo", str(tmp / "store"),
                 str(tmp / "ckpt"), **SPAWN)


@pytest.fixture(scope="module")
def single():
    """Single-device port training: STEPS + 1 steps' metrics and the state
    after STEPS."""
    model = build_model(_cfg())
    step_fn, opt = make_train_step(model, _tcfg())
    params = model.init(0, device="cpu")
    st = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=_cfg().vocab_size))
    mets = []
    for s in range(STEPS + 1):
        params, st, met = step_fn(params, st, data.batch(s, B, T))
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        if s + 1 == STEPS:
            state = _np({"params": params, "opt": st})
    return dict(metrics=mets, state=state)


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("pod,flat", PAIRS)
def test_pod_mesh_equals_its_flat_mesh_bit_for_bit(pod_run, pod, flat):
    """(2, 2, 1) == (4, 1) and (2, 1, 2) == (2, 2): losses, grad_norms and
    the gathered params and moments after 2 steps, bit for bit."""
    got, want = pod_run["llama"][pod], pod_run["llama"][flat]
    assert got["metrics"] == want["metrics"]
    assert sorted(got["state"]) == sorted(want["state"])
    for key, x in want["state"].items():
        assert np.array_equal(got["state"][key], x), key


def test_hymba_pod_mesh_equals_its_flat_mesh_bit_for_bit(pod_run):
    """hymba-1.5b's tiny (Mamba leaves that pass copy_to on a rank's
    channels) at (2, 1, 2) == (2, 2), bit for bit."""
    got, want = pod_run["hymba"][(2, 1, 2)], pod_run["hymba"][(2, 2)]
    assert got["metrics"] == want["metrics"]
    for key, x in want["state"].items():
        assert np.array_equal(got["state"][key], x), key


def test_pod_mesh_matches_single_device(pod_run, single):
    """(2, 2, 1) against single-device training: losses and grad_norms
    1e-5 relative, params 1e-3 and moments 5e-4 of each leaf's max."""
    got = pod_run["llama"][(2, 2, 1)]
    for g, w in zip(got["metrics"], single["metrics"]):
        assert _rel(g["loss"], w["loss"]) <= 1e-5
        assert _rel(g["grad_norm"], w["grad_norm"]) <= 1e-5
    assert sorted(got["state"]) == sorted(single["state"])
    for key, w in single["state"].items():
        tol = 1e-3 if key.startswith("['params']") else 5e-4
        err = float(np.abs(got["state"][key] - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (key, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_per_step_equal_the_formula(pod_run, shape):
    """COUNTS per step == step_collectives at the mesh shape (the pod
    meshes' data-parallel sums counted once each, over the joint
    group)."""
    counts = pod_run["llama"][shape]["counts"]
    want = step_collectives(L, shape)
    assert [{k: c["calls"] for k, c in step.items()} for step in counts] \
        == [{k: n for k, n in want.items() if n}] * STEPS


@pytest.mark.parametrize("shape", SHAPES)
def test_state_bytes_and_collectives_equal_the_dryrun(pod_run, shape):
    """On every rank, the parameters' and moments' bytes and each step's
    collectives (calls and result bytes per kind) equal
    dryrun.train_record for the config and mesh (a meta run on rank 0)."""
    got = pod_run["llama"][shape]
    assert got["dryrun_bytes"] and got["dryrun_counts"]


def test_pod_mesh_checkpoint_resumes_on_another_mesh(pod_run, single):
    """The (2, 2, 1) save, written by rank 0 alone, is byte for byte a
    single-device save of the restored whole state; a (1, 2) mesh resumes
    it with the uninterrupted single-device run's next loss."""
    c = pod_run["ckpt"]
    assert c["bytes_equal"] == {"data.bin": True, "manifest.json": True}
    assert c["listing"] == [f"step_{STEPS:08d}"]
    (resumed,) = c["resumed"]
    assert _rel(resumed["loss"], single["metrics"][STEPS]["loss"]) <= 1e-5


def test_launch_train_on_a_pod_mesh(tmp_path, capfd):
    """launch.train --mesh 2,1,2 trains on 4 ranks and names its pod
    axis; its losses are the single-device run's."""
    from repro_torch.launch import train as launch_train

    argv = ["--tiny", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2"]
    single = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "s")])[3]
    capfd.readouterr()
    pod = launch_train.main(argv + ["--mesh", "2,1,2", "--backend", "gloo",
                                    "--ckpt-dir", str(tmp_path / "p")])[3]
    out = capfd.readouterr().out
    assert "on mesh pod=2 data=1 model=2 (4 cpu ranks, gloo)" in out
    assert sorted(os.listdir(tmp_path / "p")) == ["step_00000002"]
    assert len(pod) == len(single) == 2
    for got, want in zip(pod, single):
        assert abs(got - want) <= 1e-5 * abs(want)


def test_train_cli_mesh_argument():
    """--mesh takes DATA,MODEL or POD,DATA,MODEL, nothing else."""
    import argparse

    from repro_torch.launch.train import parse_train_mesh

    assert parse_train_mesh("2,2") == (2, 2)
    assert parse_train_mesh("2,1,2") == (2, 1, 2)
    for bad in ("2", "1,2,3,4", "a,b", "0,2"):
        with pytest.raises(argparse.ArgumentTypeError):
            parse_train_mesh(bad)
