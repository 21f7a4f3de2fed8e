"""Training on a ``(data, model)`` mesh in the port
(``make_train_step(mesh=)``, FSDP over ``data``, tensor parallelism over
``model``), on CPU ranks over gloo.

The reference's own sharded training fails under this jax (its launcher
raises at the vocab-sharded embedding gather, as its sharded serving
does), so mesh training is held to single-device port training, which
tests/test_torch_trainer.py holds to the reference's step.  Model: tiny
llama3-8b in f32 at 2 layers, global batch 4 x 32; a data rank draws its
share as host ``data.index`` of ``data`` (the rows interleave into the
single-device batch).

Limits, as tests/test_torch_trainer.py states them: loss and grad_norm
1e-5 relative; every gathered gradient leaf 1e-4 of the leaf's max; after
3 AdamW steps params 1e-3 and moments 5e-4 of the leaf's max; with int8
compression params within 2 lr, moments 2 / 127 (m) and 3 / 127 (v) of
the leaf's max, and the loss 1e-4 relative.

Collectives per step (``COUNTS``) are held to
:func:`repro_torch.train.trainer.step_collectives`, the formula in L (and
the mesh, ``remat``, microbatches, compression) that ``chip_smoke.py``
checks on the card too.

One spawn per mesh shape, every check inside it; the rank functions import
nothing of jax (a spawned rank imports this module).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import collectives
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.dist.sharding import cut_tensor
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models.registry import build_model
from repro_torch.train.grad_compress import ef_init
from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                       make_train_step, param_specs,
                                       shard_params, state_specs,
                                       step_collectives)

SPAWN = dict(threads=1, timeout=300)
L, B, T = 2, 4, 32
STEPS, RESUME_STEPS = 3, 2
LR = 3e-3
MODES = {"plain": {}, "microbatches": {"microbatches": 2},
         "grad_compress": {"grad_compress": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(remat=False):
    return ARCHS["llama3-8b"].tiny().scaled(n_layers=L, remat=remat)


def _tcfg(**kw):
    return TrainConfig(lr=LR, warmup=1, total_steps=10, **kw)


def _data():
    return SyntheticLM(DataConfig(vocab_size=_cfg().vocab_size))


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in leaves_with_keys(tree)}


def _run(mesh, tcfg, steps, state=None):
    """``steps`` steps from seed-0 params (or ``state``) on this rank's
    shards; returns (params, opt, ef, [metrics], [counts])."""
    model = build_model(_cfg())
    step_fn, opt = make_train_step(model, tcfg, mesh=mesh)
    if state is None:
        params = shard_params(model, model.init(0, device="cpu"), mesh)
        st, ef, first = opt.init(params), ef_init(params), 0
    else:
        params, st = state
        ef, first = ef_init(params), int(st.step)
    d, n_data = mesh.index("data"), mesh.size("data")
    data, mets, counts = _data(), [], []
    for s in range(first, first + steps):
        batch = data.batch(s, B // n_data, T, host=d, n_hosts=n_data)
        collectives.reset_counts()
        if tcfg.grad_compress:
            params, st, ef, met = step_fn(params, st, batch, ef)
        else:
            params, st, met = step_fn(params, st, batch)
        counts.append({k: c["calls"] for k, c in
                       collectives.counts().items()})
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    return params, st, ef, mets, counts


def _gathered(mesh, tree, specs):
    host = ckpt.gather_to_host(tree, mesh, specs)
    return None if host is None else _np(host)


def _rank_checks(mesh, modes, ckpt_dir=None):
    """Every check of one mesh shape on this rank; rank 0's numbers come
    back (numpy)."""
    model = build_model(_cfg())
    specs = param_specs(model, mesh)
    s_specs = state_specs(model, mesh)
    d, n_data = mesh.index("data"), mesh.size("data")
    out = {}
    # step 1's gradient, gathered
    params = shard_params(model, model.init(0, device="cpu"), mesh)
    batch = {k: torch.as_tensor(v) for k, v in
             _data().batch(0, B // n_data, T, host=d, n_hosts=n_data).items()}
    grads, met = make_grad_fn(model, _tcfg(), mesh)(params, batch)
    out["grads"] = _gathered(mesh, grads, specs)
    out["grad_loss"] = float(met["loss"])
    for name in modes:
        p, st, ef, mets, counts = _run(mesh, _tcfg(**MODES[name]), STEPS)
        out[name] = dict(metrics=mets, counts=counts,
                         state=_gathered(mesh, {"params": p, "opt": st},
                                         s_specs))
        if name == "plain":
            plain_state = (p, st)
    # one remat step: its collectives
    rmodel = build_model(_cfg(remat=True))
    step_fn, opt = make_train_step(rmodel, _tcfg(), mesh=mesh)
    collectives.reset_counts()
    step_fn(params, opt.init(params), batch)
    out["remat_counts"] = {k: c["calls"] for k, c in
                           collectives.counts().items()}
    if ckpt_dir is not None:
        out["ckpt"] = _save_and_resume(mesh, plain_state, s_specs, ckpt_dir)
    return out


def _save_and_resume(mesh, state, s_specs, ckpt_dir):
    """Save the plain run's state (save_async: the gather in this thread,
    rank 0's write in the background); on every rank, the checkpoint
    restored whole and cut equals this rank's shards bit for bit, and so
    does a restore with this mesh's specs; rank 0 writes the restored
    whole state again with a single-device save.  Then a (1, 2) mesh over
    ranks 0 and 1 resumes the checkpoint for RESUME_STEPS steps."""
    a, b = os.path.join(ckpt_dir, "mesh"), os.path.join(ckpt_dir, "single")
    if mesh.rank != 0:
        def refuse(*_, **__):
            raise AssertionError(f"rank {mesh.rank} touched a checkpoint "
                                 f"directory")
        for name in ("_write_dir", "_reclaim_stale_tmps", "_gc"):
            setattr(ckpt, name, refuse)
    tree = {"params": state[0], "opt": state[1]}
    ckpt.save_async(a, STEPS, tree, mesh=mesh, specs=s_specs)
    ckpt.wait_pending()
    torch.distributed.barrier()
    whole = ckpt.restore(a, STEPS, tree, device="cpu")
    placed = ckpt.restore(a, STEPS, tree, device="cpu", mesh=mesh,
                          specs=s_specs)
    out = {"cut_equal": all(
        torch.equal(cut_tensor(w, s_specs.get(k), mesh), x)
        for (k, w), (_, x) in zip(leaves_with_keys(whole),
                                  leaves_with_keys(tree))),
        "placed_equal": all(
            torch.equal(x, y) for (_, x), (_, y) in
            zip(leaves_with_keys(placed), leaves_with_keys(tree)))}
    if mesh.rank == 0:
        ckpt.save(b, STEPS, whole)
        out["bytes_equal"] = {
            f: open(os.path.join(a, f"step_{STEPS:08d}", f), "rb").read()
            == open(os.path.join(b, f"step_{STEPS:08d}", f), "rb").read()
            for f in ("data.bin", "manifest.json")}
        out["listing"] = sorted(os.listdir(a))
    torch.distributed.barrier()
    # elastic resume on (1, 2): ranks 2 and 3 take part in building it only
    small = make_local_mesh(1, 2, device=mesh.device)
    if small is not None:
        model = build_model(_cfg())
        params = shard_params(model, model.init(1, device="cpu"), small)
        _, opt = make_train_step(model, _tcfg(), mesh=small)
        target = {"params": params, "opt": opt.init(params)}
        back = ckpt.restore(a, STEPS, target, mesh=small,
                            specs=state_specs(model, small))
        out["resumed"] = _run(small, _tcfg(), RESUME_STEPS,
                              (back["params"], back["opt"]))[3]
    return out


@pytest.fixture(scope="module")
def single():
    """Single-device port training: step 1's gradient, and per mode the
    metrics of STEPS steps (RESUME_STEPS more for plain) and the state
    after STEPS."""
    model = build_model(_cfg())
    data = _data()
    params0 = model.init(0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0, B, T).items()}
    grads, met = make_grad_fn(model, _tcfg())(params0, batch)
    out = {"grads": _np(grads), "grad_loss": float(met["loss"])}
    for name, kw in MODES.items():
        step_fn, opt = make_train_step(model, _tcfg(**kw))
        params, st, ef = params0, opt.init(params0), ef_init(params0)
        mets = []
        for s in range(STEPS + (RESUME_STEPS if name == "plain" else 0)):
            b = data.batch(s, B, T)
            if kw.get("grad_compress"):
                params, st, ef, m = step_fn(params, st, b, ef)
            else:
                params, st, m = step_fn(params, st, b)
            mets.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            if s + 1 == STEPS:
                state = _np({"params": params, "opt": st})
        out[name] = dict(metrics=mets, state=state)
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def _close_per_leaf(got: dict, want: dict, rel, what, prefix=""):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys and sorted(k for k in got if k.startswith(prefix)) == \
        sorted(keys), what
    for key in keys:
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= rel * max(float(np.abs(want[key]).max()), 1e-30), \
            (what, key, err)


def _check_mode(got, want, name, shape):
    compress = name == "grad_compress"
    for g, w in zip(got["metrics"], want["metrics"]):
        assert _rel(g["loss"], w["loss"]) <= (1e-4 if compress else 1e-5), \
            (name, shape)
    if compress:
        lr_max = LR
        for key in want["state"]:
            if key.startswith("['params']"):
                assert float(np.abs(got["state"][key] - want["state"][key])
                             .max()) <= 2 * lr_max, (name, key)
        _close_per_leaf(got["state"], want["state"], 2 / 127, name,
                        "['opt'].m")
        _close_per_leaf(got["state"], want["state"], 3 / 127, name,
                        "['opt'].v")
    else:
        assert _rel(got["metrics"][0]["grad_norm"],
                    want["metrics"][0]["grad_norm"]) <= 1e-5, (name, shape)
        _close_per_leaf(got["state"], want["state"], 1e-3, name,
                        "['params']")
        _close_per_leaf(got["state"], want["state"], 5e-4, name, "['opt'].m")
        _close_per_leaf(got["state"], want["state"], 5e-4, name, "['opt'].v")
    assert int(got["state"]["['opt'].step"]) == STEPS
    kw = MODES[name]
    assert got["counts"] == [step_collectives(
        L, shape, microbatches=kw.get("microbatches", 1),
        grad_compress=compress)] * STEPS, (name, shape)


def _check_shape(got, single, shape, modes):
    assert _rel(got["grad_loss"], single["grad_loss"]) <= 1e-5
    _close_per_leaf(got["grads"], single["grads"], 1e-4, "grad")
    for name in modes:
        _check_mode(got[name], single[name], name, shape)
    assert got["remat_counts"] == step_collectives(L, shape, remat=True)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_mesh_step_matches_single_device(single, shape, tmp_path):
    """(1, 2) (tensor parallel) and (2, 1) (FSDP + data parallel): step 1's
    loss and gathered gradients, 3 steps' losses, grad_norm, params and
    moments as the single-device run; the collectives per step, remat off
    and on, as the formula."""
    got = spawn(_rank_checks, shape, "gloo", str(tmp_path), ("plain",),
                **SPAWN)
    _check_shape(got, single, shape, ("plain",))


def test_mesh_2x2_modes_checkpoint_and_resume(single, tmp_path):
    """(2, 2): the checks above for plain steps, microbatches=2 and
    grad_compress; the (2, 2) save written once by rank 0 (no other rank
    touches the directory), byte for byte a single-device save of the
    restored whole state, which cut to each rank's block is that rank's
    shards (and a restore with the mesh's specs gives them); a (1, 2) mesh
    resumes it with the uninterrupted single-device run's losses."""
    ckpt_dir = tmp_path / "ckpt"
    got = spawn(_rank_checks, (2, 2), "gloo", str(tmp_path / "store"),
                tuple(MODES), str(ckpt_dir), **SPAWN)
    _check_shape(got, single, (2, 2), tuple(MODES))
    c = got["ckpt"]
    assert c["cut_equal"] and c["placed_equal"]
    assert c["bytes_equal"] == {"data.bin": True, "manifest.json": True}
    assert c["listing"] == [f"step_{STEPS:08d}"]
    want = single["plain"]["metrics"][STEPS:]
    assert len(c["resumed"]) == RESUME_STEPS
    for g, w in zip(c["resumed"], want):
        assert _rel(g["loss"], w["loss"]) <= 1e-5


def _rank_collectives(mesh):
    """Each collective's forward and backward on this rank of a (2, 2)
    mesh, against what the whole-mesh computation gives."""
    from repro_torch.dist.sharding import axis_rules
    r, dm, mm = mesh.rank, mesh.index("data"), mesh.index("model")
    out = {}
    with axis_rules(mesh):
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        y = collectives.all_reduce(x, "model")
        (g,) = torch.autograd.grad((y * (r + 1)).sum(), x)
        # backward identity: this rank's own output gradient
        out["all_reduce"] = (y.tolist(), bool(torch.equal(
            g, torch.full((2, 3), float(r + 1)))))
        w = torch.arange(6.0).reshape(2, 3) + 10 * dm
        w.requires_grad_()
        full = collectives.all_gather(w, "data", dim=1, reduce_grad=True)
        (gw,) = torch.autograd.grad((full * (dm + 1)).sum(), w)
        # reduce_scatter: every data rank's gradient (d + 1) summed
        out["fsdp_gather"] = (tuple(full.shape), bool(torch.equal(
            gw, torch.full((2, 3), 3.0))))
        v = torch.arange(4.0).reshape(1, 4).requires_grad_()
        cols = collectives.all_gather(v, "model", dim=-1)
        (gv,) = torch.autograd.grad((cols * torch.arange(8.0)).sum(), v)
        out["all_gather"] = bool(torch.equal(
            gv, torch.arange(4.0)[None] + 4 * mm))
        c = torch.ones(3, requires_grad=True)
        (gc,) = torch.autograd.grad((collectives.copy_to(c, "model")
                                     * (mm + 1)).sum(), c)
        out["copy_to"] = gc.tolist()
        # all_to_all: row j of rank (d, i) goes to model rank j; the
        # whole-mesh computation: out row j = rank (d, j)'s row mm, and the
        # gradient of a loss weighting received row j by w(d, mm, j) comes
        # back to rank (d, j) as that weight
        a = (torch.arange(2.0) + 10 * mm + 100 * dm)[:, None].repeat(1, 3)
        a.requires_grad_()
        got = collectives.all_to_all(a, "model")
        weight = (torch.arange(2.0) + 2 * mm + 4 * dm + 1)[:, None]
        (ga,) = torch.autograd.grad((got * weight).sum(), a)
        out["all_to_all"] = (
            got[:, 0].tolist() == [mm + 100 * dm, 10 + mm + 100 * dm],
            ga[:, 0].tolist() == [2 * j + mm + 4 * dm + 1
                                  for j in range(2)],
            collectives.counts()["all_to_all"]["calls"])
        with torch.no_grad():
            out["max"] = float(collectives.all_reduce(
                torch.tensor(float(r)), None, op="max"))
            out["reduce_scatter"] = collectives.reduce_scatter(
                torch.arange(8.0).reshape(2, 4) * (dm + 1), "data",
                dim=1).tolist()
            collectives.reset_counts()
            plain = collectives.all_gather(torch.ones(2), "model", dim=0)
            out["no_grad"] = (plain.requires_grad,
                              collectives.counts()["all_gather"]["calls"])
    return out


def test_collectives_carry_gradients(tmp_path):
    """On (2, 2): all_reduce's backward passes the output gradient;
    all_gather hands back the rank's block, or with reduce_grad the
    block of the gradient summed over the axis; copy_to sums its gradient
    over the axis; all_to_all exchanges rows and sends each row's
    gradient back to its source rank (two calls, one each way); max over
    the mesh; reduce_scatter on dim 1; without grad a call is counted once
    and carries no graph."""
    got = spawn(_rank_collectives, (2, 2), "gloo", str(tmp_path), **SPAWN)
    assert got["all_reduce"] == ([[3.0] * 3] * 2, True)   # ranks 0 + 1
    assert got["fsdp_gather"] == ((2, 6), True)
    assert got["all_gather"] is True
    assert got["copy_to"] == [3.0, 3.0, 3.0]              # 1 + 2
    assert got["all_to_all"] == (True, True, 2)
    assert got["max"] == 3.0
    assert got["reduce_scatter"] == [[0.0, 3.0], [12.0, 15.0]]
    assert got["no_grad"] == (False, 1)
