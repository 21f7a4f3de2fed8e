"""The port's training substrate (``repro_torch.train``) on the CPU: the
reference's trainer tests (``tests/test_trainer.py``) on the port, and
parity with ``repro.train`` on the same numpy parameters and batches.

Tolerances (tiny llama3-8b, f32): loss 1e-5 relative; every gradient
leaf 1e-4 of the leaf's max (summation order of f32 products); after 3
``make_train_step`` steps, params within 1e-3 and AdamW moments within
5e-4 of the leaf's max (readings 4e-4 and 8.5e-5: Adam divides by
sqrt(v), so a gradient entry near zero that differs in its last bits
moves its parameter by up to lr).  With int8 gradient compression a
1e-6 gradient difference can move an entry across a rounding boundary,
which changes its decompressed value by one quantum (max|g| / 127) and,
at a zero code, its Adam step by lr: there params are held within 2 lr
and the moments within 2 / 127 (m) and 3 / 127 (v, where g^2 moves by
2 g q) of the leaf's max, and the loss within 1e-4 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.data.synthetic import DataConfig, SyntheticLM
from repro.models.registry import build_model as r_build
from repro.train import grad_compress as r_gc
from repro.train import trainer as r_trainer
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ARCHS
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.models.registry import build_model
from repro_torch.train.grad_compress import EFState, compress_grads, ef_init
from repro_torch.train.optimizer import AdamW, cosine_schedule, global_norm
from repro_torch.train.trainer import (TrainConfig, make_loss_fn,
                                       make_train_step, value_and_grad)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run small torch ops in
    loops, and under pytest-xdist several workers each spinning a full
    thread pool on the same cores made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    cfg = ARCHS["llama3-8b"].tiny()
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    return cfg, m, params, data


def _batch(data, step, b, t):
    return {k: torch.as_tensor(v) for k, v in data.batch(step, b, t).items()}


# -- the reference's trainer tests, on the port ------------------------------

def test_loss_decreases():
    cfg, m, params, data = _setup()
    train_step, opt = make_train_step(m, TrainConfig(lr=3e-3, warmup=5,
                                                     total_steps=40))
    opt_state = opt.init(params)
    losses = []
    for step in range(40):
        params, opt_state, metrics = train_step(params, opt_state,
                                                data.batch(step, 8, 64))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_microbatch_matches_full_batch_grad():
    """Accumulated-microbatch gradients == full-batch gradients."""
    cfg, m, params, data = _setup()
    loss_fn = make_loss_fn(m, 0.0)
    batch = _batch(data, 0, 8, 32)
    _, g_full = value_and_grad(loss_fn, params, batch)
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()}
              for i in range(2)]
    gs = [dict(leaves_with_keys(value_and_grad(loss_fn, params, h)[1]))
          for h in halves]
    for key, a in leaves_with_keys(g_full):
        torch.testing.assert_close(a, (gs[0][key] + gs[1][key]) / 2,
                                   rtol=1e-3, atol=1e-5)


def test_grad_compress_error_feedback():
    """The residual is carried: two compressed steps recover what one step
    dropped."""
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=(64, 64)),
                              dtype=torch.float32)}
    ef = ef_init(g)
    d1, ef = compress_grads(g, ef)
    d2, ef = compress_grads(g, ef)
    resid = float((d1["w"] + d2["w"] + ef.error["w"] - 2 * g["w"]).abs().max())
    assert resid < 1e-4
    assert float((d1["w"] - g["w"]).abs().max()) > 0      # lossy per step


def test_adamw_decays_only_matrices():
    opt = AdamW(weight_decay=0.5, clip_norm=None)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = opt.init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = opt.update(zero_g, state, params, torch.tensor(0.1))
    assert float((new_p["b"] - 1.0).abs().max()) < 1e-6     # no decay
    assert float(new_p["w"].max()) < 1.0                     # decayed


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1.0) < 1e-6
    assert float(lr(torch.tensor(100))) <= 0.11


def test_global_norm():
    assert abs(float(global_norm({"a": torch.ones(3) * 2.0}))
               - 12 ** 0.5) < 1e-6


# -- parity with repro.train ---------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """repro's and the port's tiny llama3-8b on the same numpy params."""
    cfg = R_ARCHS["llama3-8b"].tiny()
    r_model = r_build(cfg)
    r_params = r_model.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, r_params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    return (r_model, r_params, build_model(ARCHS["llama3-8b"].tiny()),
            np_params, data)


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_per_leaf(ours, ref, rel, what):
    ref = _ref_leaves(ref)
    mine = leaves_with_keys(ours)
    assert sorted(k for k, _ in mine) == sorted(ref)
    for key, leaf in mine:
        want = ref[key]
        err = float(np.abs(leaf.detach().float().numpy() - want).max())
        assert err <= rel * max(float(np.abs(want).max()), 1e-30), \
            (what, key, err)


def test_loss_and_grads_match_repro(pair):
    r_model, r_params, model, np_params, data = pair
    batch = data.batch(0, 4, 32)
    (r_loss, _), r_grads = jax.value_and_grad(
        r_trainer.make_loss_fn(r_model, 0.0), has_aux=True)(
            r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, aux), grads = value_and_grad(
        make_loss_fn(model, 0.0), from_numpy_tree(np_params, device=CPU),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    assert float(aux["ce"]) == float(loss)
    _close_per_leaf(grads, r_grads, 1e-4, "grad")


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2},
                                {"grad_compress": True}],
                         ids=["plain", "microbatches", "grad_compress"])
def test_three_train_steps_match_repro(pair, kw):
    r_model, r_params, model, np_params, data = pair
    r_step, r_opt = r_trainer.make_train_step(
        r_model, r_trainer.TrainConfig(lr=3e-3, warmup=1, total_steps=10,
                                       **kw))
    r_step = jax.jit(r_step)
    step_fn, opt = make_train_step(model, TrainConfig(
        lr=3e-3, warmup=1, total_steps=10, **kw))
    params = from_numpy_tree(np_params, device=CPU)
    rp, rs, st = r_params, r_opt.init(r_params), opt.init(params)
    r_ef, ef = r_gc.ef_init(r_params), ef_init(params)
    compress = kw.get("grad_compress", False)
    for step in range(3):
        batch = data.batch(step, 4, 32)
        rb = {k: jnp.asarray(v) for k, v in batch.items()}
        if compress:
            rp, rs, r_ef, r_met = r_step(rp, rs, rb, r_ef)
            params, st, ef, met = step_fn(params, st, batch, ef)
        else:
            rp, rs, r_met = r_step(rp, rs, rb)
            params, st, met = step_fn(params, st, batch)
        assert abs(float(met["loss"]) - float(r_met["loss"])) <= \
            (1e-4 if compress else 1e-5) * abs(float(r_met["loss"]))
        assert abs(float(met["lr"]) - float(r_met["lr"])) <= 1e-6 * 3e-3
    assert int(st.step) == int(rs.step) == 3
    assert st.step.dtype == torch.int32
    if compress:
        lr_max = 3e-3
        ref = _ref_leaves(rp)
        for key, leaf in leaves_with_keys(params):
            assert float(np.abs(leaf.numpy() - ref[key]).max()) <= 2 * lr_max
        _close_per_leaf(st.m, rs.m, 2 / 127, "m")
        _close_per_leaf(st.v, rs.v, 3 / 127, "v")
        assert isinstance(ef, EFState)
    else:
        _close_per_leaf(params, rp, 1e-3, "params")
        _close_per_leaf(st.m, rs.m, 5e-4, "m")
        _close_per_leaf(st.v, rs.v, 5e-4, "v")


def test_compress_grads_matches_repro():
    """One compression of the same numpy gradient and residual gives
    repro's decompressed gradient bit for bit."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(256, 64)).astype(np.float32)
    e = (rng.normal(size=(256, 64)) * 0.01).astype(np.float32)
    r_deq, r_ef = r_gc.compress_grads({"w": jnp.asarray(g)},
                                      r_gc.EFState(error={"w": jnp.asarray(e)}))
    deq, ef = compress_grads({"w": torch.as_tensor(g)},
                             EFState(error={"w": torch.as_tensor(e)}))
    assert np.array_equal(deq["w"].numpy(), np.asarray(r_deq["w"]))
    assert np.array_equal(ef.error["w"].numpy(), np.asarray(r_ef.error["w"]))


def test_remat_gives_the_same_grads():
    """cfg.remat recomputes each block in the backward
    (torch.utils.checkpoint): the same gradients bit for bit."""
    cfg = ARCHS["llama3-8b"].tiny()
    params = build_model(cfg).init(0, device=CPU)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    batch = _batch(data, 0, 2, 32)
    grads = [dict(leaves_with_keys(value_and_grad(
        make_loss_fn(build_model(cfg.scaled(remat=r)), 0.0), params,
        batch)[1])) for r in (False, True)]
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


def test_launch_train_resumes_bit_for_bit(tmp_path, capsys):
    """launch.train saves every --ckpt-every steps (async) and at the end;
    a run cut after step 4 and resumed from its checkpoint ends on the
    uninterrupted run's params and moments bit for bit."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.launch import train as launch_train

    argv = ["--tiny", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2"]
    whole = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert ckpt.latest_step(str(tmp_path / "a")) == 6
    assert sorted(os.listdir(tmp_path / "a")) == [
        "step_00000002", "step_00000004", "step_00000006"]
    os.rename(tmp_path / "a" / "step_00000004", tmp_path / "step_00000004")
    (tmp_path / "b").mkdir()
    os.rename(tmp_path / "step_00000004", tmp_path / "b" / "step_00000004")
    capsys.readouterr()
    resumed = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 4" in capsys.readouterr().out
    for a, b in ((whole[0], resumed[0]), (whole[1], resumed[1])):
        for (ka, x), (kb, y) in zip(leaves_with_keys(a), leaves_with_keys(b)):
            assert ka == kb and torch.equal(x, y), ka
    # --shape takes batch and seq from the cell (no step at --steps 0)
    capsys.readouterr()
    out = launch_train.main(argv + ["--shape", "train_4k", "--steps", "0",
                                    "--ckpt-dir", str(tmp_path / "c")])
    assert "global batch 256 x seq 4096" in capsys.readouterr().out
    assert out[3] == []


# -- launch.train on a mesh (CPU ranks over gloo) -----------------------------

MESH_ARGV = ["--tiny", "--device", "cpu", "--steps", "6", "--batch", "4",
             "--seq", "16", "--ckpt-every", "2"]


def test_launch_train_mesh_resumes_on_another_mesh(tmp_path, capfd):
    """launch.train --mesh 2,2 (--batch global) gives the single-device
    run's losses; its step-4 checkpoint, resumed by --mesh 1,2, gives the
    uninterrupted run's losses for steps 5 and 6 (rel 1e-5): the sample
    stream does not depend on the mesh."""
    from repro_torch.launch import train as launch_train

    gloo = ["--backend", "gloo"]
    single = launch_train.main(MESH_ARGV + ["--ckpt-dir",
                                            str(tmp_path / "s")])[3]
    meshed = launch_train.main(MESH_ARGV + gloo + [
        "--mesh", "2,2", "--ckpt-dir", str(tmp_path / "a")])[3]
    assert sorted(os.listdir(tmp_path / "a")) == [
        "step_00000002", "step_00000004", "step_00000006"]
    (tmp_path / "b").mkdir()
    os.rename(tmp_path / "a" / "step_00000004",
              tmp_path / "b" / "step_00000004")
    capfd.readouterr()
    resumed = launch_train.main(MESH_ARGV + gloo + [
        "--mesh", "1,2", "--ckpt-dir", str(tmp_path / "b")])[3]
    out = capfd.readouterr().out
    assert "resumed from step 4 (mesh 1x2)" in out
    assert out.count("done 2 steps") == 1            # rank 0 prints
    assert len(single) == len(meshed) == 6 and len(resumed) == 2
    for got, want in zip(meshed + resumed, single + single[4:]):
        assert abs(got - want) <= 1e-5 * abs(want)


def test_launch_train_mesh_refusals(tmp_path):
    """A global batch the data ranks do not split, and whisper (whose
    batches need frame embeddings the CLI does not make), are refused
    before any rank starts: nothing is written to --ckpt-dir."""
    from repro_torch.launch import train as launch_train

    argv = MESH_ARGV + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="does not split over 4 data"):
        launch_train.main(argv + ["--mesh", "4,1", "--batch", "6"])
    with pytest.raises(SystemExit):
        launch_train.main(argv + ["--mesh", "1,2", "--arch",
                                  "whisper-small"])
    assert not os.listdir(tmp_path)


# -- the backward kernels' plain versions against the reference's gradients ----

@pytest.mark.parametrize("t", [37, 128])
def test_flash_attention_backward_matches_reference_grad(t):
    """Autograd through the port's flash_attention on the CPU (the plain
    forward and flash_attention_bwd_ref, the backward kernel's yardstick
    on the card) against jax.vjp of repro's jnp chunked attention, the
    path repro trains through; GQA, f32, atol = rtol = 1e-5."""
    from repro.models.common import chunked_attention as j_attention
    from repro_torch.kernels import flash_attention as fa

    b, h, kh, hd = 2, 4, 2, 32
    rng = np.random.default_rng(t)
    q, do = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, t, kh, hd)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda a, b_, c: j_attention(a, b_, c, causal=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    g = h // kh
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    qr = leaves[0].reshape(b, t, kh, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b * kh, g, t, hd)
    kr, vr = (x.permute(0, 2, 1, 3).reshape(b * kh, t, hd)
              for x in leaves[1:])
    out = fa.flash_attention(qr, kr, vr).reshape(b, kh, g, t, hd) \
        .permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)
    got = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_rms_norm_backward_matches_reference_grad():
    """Autograd through the port's rms_norm on the CPU (rms_norm_bwd_ref,
    the backward kernel's yardstick) against jax.vjp of repro's jnp
    rms_norm; f32, atol = rtol = 1e-5."""
    from repro.models.common import rms_norm as j_rms_norm
    from repro_torch.kernels import rms_norm as rn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 96)) * 3).astype(np.float32)
    w, dy = rng.normal(size=96).astype(np.float32), \
        rng.normal(size=(3, 7, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_: j_rms_norm(a, b_, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.as_tensor(a).requires_grad_() for a in (x, w)]
    got = torch.autograd.grad(rn.rms_norm(*leaves, 1e-5), leaves,
                              torch.as_tensor(dy))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
