"""Training of the vlm, hybrid, ssm, audio and MoE families on a ``(data,
model)`` mesh in the port (``make_train_step(mesh=)``), on CPU ranks over
gloo, and their single-device gradients against the reference's.

The reference's sharded training fails under this jax (ROADMAP section
3), so each mesh is held to the family's single-device port training of
the same seed and batches, which the last test holds to ``jax.
value_and_grad`` of the reference's loss.  Models: each family's
``tiny()`` in f32 at 2 layers (xlstm-350m at 4, so that layer 3 is an
sLSTM block; whisper-small 2 encoder + 2 decoder layers), hymba-1.5b also
with 3 / 1 heads (``HYMBA_ODD``), whose attention no mesh axis splits, so
that it runs whole on every rank while ``ff`` and the Mamba channels are
cut, as at full width; qwen2-moe-a2.7b at capacity factor 16, where
nothing drops.  Global batch 4 x 32 tokens (the VLM's 8 patch embeddings
and whisper's 32 frames per row beside them): the rows of data hosts 0
and 1 laid end to end, so a data rank of (2, 1) takes its half.

Limits, the dense mesh test's (tests/test_torch_mesh_train.py): step 1's
gathered gradients within 1e-4 of each leaf's max; 2 steps' losses and
grad_norms within 1e-5 relative.  Collectives per step (``COUNTS``) equal
each model's ``train_collectives`` (remat off, and on for one more step).
MoE's aux loss is each rank's own on its tokens, averaged over the mesh:
its single-device yardstick takes the aux as the mean of ``_route``'s
over the mesh's (data rows, model tokens) blocks, so the losses, the
gradients and ``moe_aux`` are held alike.

One spawn of 2 ranks builds both meshes, (1, 2) and (2, 1), over the same
ranks; the rank functions import nothing of jax (a spawned rank imports
this module).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import collectives
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                       make_loss_fn, make_train_step,
                                       param_specs, shard_params,
                                       value_and_grad)

SPAWN = dict(threads=1, timeout=300)
B, T, STEPS = 4, 32, 2
LR = 3e-3
SHAPES = ((1, 2), (2, 1))
# hymba with attention that no mesh axis splits (tests/test_torch_tp_families.py)
HYMBA_ODD = dict(n_heads=3, n_kv_heads=1, head_dim=64)
FAMILIES = ("qwen2-vl-2b", "hymba-1.5b", "hymba-odd", "xlstm-350m",
            "whisper-small", "qwen2-moe-a2.7b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, remat=False):
    if name == "hymba-odd":
        cfg = ARCHS["hymba-1.5b"].tiny().scaled(**HYMBA_ODD)
    else:
        cfg = ARCHS[name].tiny()
    kw = dict(n_layers=4 if cfg.family == "ssm" else 2, remat=remat)
    if cfg.family == "moe":
        kw["moe_capacity_factor"] = 16.0
    return cfg.scaled(**kw)


def _tcfg():
    return TrainConfig(lr=LR, warmup=1, total_steps=10)


def _batch(cfg, step) -> dict:
    """The global batch of ``step`` (numpy): data hosts 0 and 1's rows end
    to end, with the VLM's patches / whisper's frames per row."""
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size))
    halves = [data.batch(step, B // 2, T, host=h, n_hosts=2) for h in (0, 1)]
    out = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    rng = np.random.default_rng(1000 + step)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.patch_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _rows(batch, mesh) -> dict:
    """This rank's rows of a global batch: its data coordinate's block."""
    n = B // mesh.size("data")
    d = mesh.index("data")
    return {k: torch.as_tensor(v[d * n:(d + 1) * n]) for k, v in
            batch.items()}


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in leaves_with_keys(tree)}


def _calls() -> dict:
    return {k: c["calls"] for k, c in collectives.counts().items()}


def _train(model, cfg, step_fn, opt, params, rows):
    """STEPS steps from ``params``: [metrics], [collective calls]."""
    st = opt.init(params)
    mets, counts = [], []
    for s in range(STEPS):
        collectives.reset_counts()
        params, st, met = step_fn(params, st, rows(_batch(cfg, s)))
        counts.append(_calls())
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm",
                                                "moe_aux")})
    return mets, counts


def _rank_family(mesh, name):
    """One family on this rank at one mesh: step 1's gradients gathered
    (rank 0), STEPS steps' metrics and collectives, and one remat step's
    collectives."""
    cfg = _cfg(name)
    model = build_model(cfg)
    params = shard_params(model, model.init(0, device="cpu"), mesh)
    b0 = _rows(_batch(cfg, 0), mesh)
    grads, met = make_grad_fn(model, _tcfg(), mesh)(params, b0)
    host = ckpt.gather_to_host(grads, mesh, param_specs(model, mesh))
    step_fn, opt = make_train_step(model, _tcfg(), mesh=mesh)
    mets, counts = _train(model, cfg, step_fn, opt, params,
                          lambda b: _rows(b, mesh))
    rmodel = build_model(_cfg(name, remat=True))
    rstep, ropt = make_train_step(rmodel, _tcfg(), mesh=mesh)
    collectives.reset_counts()
    rstep(params, ropt.init(params), b0)
    return {"grads": None if host is None else _np(host),
            "loss1": float(met["loss"]), "metrics": mets, "counts": counts,
            "remat_counts": _calls()}


def _rank_all(mesh):
    """Every family at (1, 2) (the spawn's mesh) and (2, 1) (a mesh over
    the same 2 ranks); rank 0's results."""
    other = make_local_mesh(*SHAPES[1], device=mesh.device)
    return {(name, shape): _rank_family(m, name)
            for shape, m in zip(SHAPES, (mesh, other)) for name in FAMILIES}


@contextlib.contextmanager
def _blocked_aux(n_data, n_model):
    """moe_ffn on one device with its aux loss taken as the mesh takes it:
    the mean of ``_route``'s aux over the (data rows, model tokens) blocks
    of an (n_data, n_model) mesh; the output is the local path's."""
    local = moe.moe_ffn

    def ffn(x, router_w, wg, wu, wd, cfg, collect=False):
        y, _, stats = moe.moe_ffn_local(x, router_w, wg, wu, wd, cfg,
                                        collect)
        b, t = x.shape[0] // n_data, x.shape[1] // n_model
        aux = [moe._route(x[i * b:(i + 1) * b, j * t:(j + 1) * t]
                          .reshape(-1, x.shape[-1]), router_w,
                          cfg.n_experts, cfg.experts_per_token)[2]
               for i in range(n_data) for j in range(n_model)]
        return y, torch.stack(aux).mean(), stats

    moe.moe_ffn = ffn
    try:
        yield
    finally:
        moe.moe_ffn = local


def _single(name, shape):
    """Single-device port training of the family: step 1's gradients and
    STEPS steps' metrics (MoE: its aux over ``shape``'s blocks)."""
    cfg = _cfg(name)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    blocked = (_blocked_aux(*shape) if cfg.family == "moe"
               else contextlib.nullcontext())
    with blocked:
        b0 = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
        grads, met = make_grad_fn(model, _tcfg())(params, b0)
        step_fn, opt = make_train_step(model, _tcfg())
        mets, _ = _train(model, cfg, step_fn, opt, params,
                         lambda b: {k: torch.as_tensor(v)
                                    for k, v in b.items()})
    return {"grads": _np(grads), "loss1": float(met["loss"]),
            "metrics": mets}


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    return spawn(_rank_all, SHAPES[0], "gloo",
                 str(tmp_path_factory.mktemp("store")), **SPAWN)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", FAMILIES)
def test_mesh_training_matches_single_device(meshed, name, shape):
    """Step 1's loss and gathered gradients, 2 steps' losses, grad_norms
    and aux losses as single-device training's; the collectives of each
    step (and of a remat step) as the model's train_collectives."""
    got = meshed[(name, shape)]
    want = _single(name, shape)
    assert _rel(got["loss1"], want["loss1"]) <= 1e-5
    assert sorted(got["grads"]) == sorted(want["grads"])
    for key, w in want["grads"].items():
        err = float(np.abs(got["grads"][key] - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (key, err)
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm"):
            assert _rel(g[k], w[k]) <= 1e-5, (k, g, w)
        assert abs(g["moe_aux"] - w["moe_aux"]) <= 1e-5 * max(
            abs(w["moe_aux"]), 1.0), (g, w)
    model = build_model(_cfg(name))
    assert got["counts"] == [model.train_collectives(shape)] * STEPS
    assert got["remat_counts"] == model.train_collectives(shape, remat=True)
    if name == "qwen2-moe-a2.7b":
        assert got["metrics"][0]["moe_aux"] > 0
        assert got["counts"][0]["all_to_all"] == (
            8 if shape[1] > 1 else 0)


# -- single-device gradients against the reference ---------------------------

@pytest.mark.parametrize("name", [f for f in FAMILIES if f != "hymba-odd"])
def test_family_grads_match_reference(name):
    """The port's value_and_grad of the train loss (aux coefficient 0.01)
    against jax.value_and_grad of the reference's make_loss_fn on the same
    numpy weights (the port's seed-0 init, the reference's tree) and
    batch, each leaf within 1e-4 of its max; the reference through its jnp
    paths (Pallas does not run on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as R_ARCHS
    from repro.models.registry import build_model as r_build
    from repro.train import trainer as r_trainer

    cfg = _cfg(name)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    r_model = r_build(R_ARCHS[name].tiny().scaled(
        n_layers=cfg.n_layers, moe_capacity_factor=cfg.moe_capacity_factor))
    batch = _batch(cfg, 0)
    (r_loss, r_aux), r_grads = jax.jit(jax.value_and_grad(
        r_trainer.make_loss_fn(r_model, 0.01), has_aux=True))(
            _jax_tree(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, aux), grads = value_and_grad(
        make_loss_fn(model, 0.01), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert _rel(float(loss), float(r_loss)) <= 1e-5
    assert abs(float(aux["moe_aux"]) - float(r_aux["moe_aux"])) <= 1e-5
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(r_grads)[0]}
    mine = _np(grads)
    assert sorted(mine) == sorted(want)
    for key, w in want.items():
        err = float(np.abs(mine[key] - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (key, err)


def _jax_tree(tree):
    """A port parameter tree (nested dicts of tensors) as jax arrays."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


# -- xlstm's bf16 gradients against the reference's --------------------------

def _jax_bf16(tree):
    """A port parameter tree of bf16 tensors as bf16 jax arrays."""
    import jax
    import jax.numpy as jnp

    from repro_torch.dist._tree import tree_map

    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        _jax_tree(tree_map(lambda t: t.float(), tree)))


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_bf16_block_grads_match_reference(block):
    """One xLSTM block in bf16 at tiny width (d 128, 4 heads; the mLSTM
    d_inner 256), its VJP (a seeded cotangent) against jax.vjp of the
    reference's block on the same bf16 numpy weights and input: the output
    and each gradient (every leaf and the input) within 2e-2 of the
    reference's norm (readings 3.5e-6 to 1.4e-2, ``gate_bias`` and the
    sLSTM ``bias`` the largest: sums over every token of bf16 terms).  Each
    lies up to about 1.5e-2 from its f32 VJP."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as r_ssm
    from repro_torch.models import ssm

    cfg = _cfg("xlstm-350m")
    d, h = cfg.d_model, cfg.n_heads
    gen = torch.Generator().manual_seed(0)
    if block == "mlstm":
        p = ssm.mlstm_init(gen, 1, d, cfg.ssm_expand * d, h, torch.bfloat16,
                           "cpu")
        mine, ref = ssm.mlstm_chunked, r_ssm.mlstm_chunked
    else:
        p = ssm.slstm_init(gen, 1, d, h, torch.bfloat16, "cpu")
        mine, ref = ssm.slstm_scan, r_ssm.slstm_scan
    p = {k: v[0].clone() for k, v in p.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    ct = rng.standard_normal((B, T, d)).astype(np.float32)

    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.as_tensor(x).to(torch.bfloat16).requires_grad_()
    y = mine(leaves, xt, h)
    y.backward(torch.as_tensor(ct).to(torch.bfloat16))
    got = {k: v.grad for k, v in leaves.items()}
    got.update(x=xt.grad, y=y.detach())

    @jax.jit
    def ref_vjp(pp, xx, cc):
        r_y, vjp = jax.vjp(lambda a, b: ref(a, b, h), pp, xx)
        return r_y, vjp(cc)

    r_y, (r_gp, r_gx) = ref_vjp(_jax_bf16(p), jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(ct, jnp.bfloat16))
    want = dict(r_gp, x=r_gx, y=r_y)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(got[key].float().numpy() - w)
        assert err <= 2e-2 * np.linalg.norm(w), (key, err / np.linalg.norm(w))


def test_xlstm_bf16_model_grads_match_reference():
    """The tiny xlstm-350m (3 mLSTM layers, then the sLSTM) in bf16 against
    the reference's bf16 value_and_grad on the same bf16 numpy weights and
    batch: the loss within 1e-3 relative, and the gradients of the leaves
    that the backward reaches before any mLSTM block (the sLSTM layer's,
    ``final_norm``, ``lm_head``) within 5e-2 of the reference's norm
    (readings 1.0e-2 to 2.4e-2).  The mLSTM's leaves, and every leaf behind
    an mLSTM block, are held block by block (above): the mLSTM's normaliser
    ``max(|q . n|, 1)`` has a kink, so the model's gradient is not
    continuous in the weights.  Asserted here: moving the f32 weights by
    1e-4 relative moves the f32 gradient by more than 1e-2 of its norm on
    some leaf (a gradient continuous there would move about 1e-4), while
    the loss moves less than 1e-4."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as R_ARCHS
    from repro.models.registry import build_model as r_build
    from repro.train import trainer as r_trainer
    from repro_torch.dist._tree import tree_map

    cfg = _cfg("xlstm-350m")
    model = build_model(cfg.scaled(dtype="bfloat16"))
    params = model.init(0, device="cpu")
    batch = _batch(cfg, 0)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(make_loss_fn(model, 0.01), params,
                                      tbatch)
    r_model = r_build(R_ARCHS["xlstm-350m"].tiny().scaled(
        n_layers=cfg.n_layers, dtype="bfloat16"))
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        r_trainer.make_loss_fn(r_model, 0.01), has_aux=True))(
            _jax_bf16(params), {k: jnp.asarray(v) for k, v in batch.items()})
    assert _rel(float(loss), float(r_loss)) <= 1e-3
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_flatten_with_path(r_grads)[0]}
    mine = _np(grads)
    assert sorted(mine) == sorted(want)
    before_mlstm = [k for k in want if k.startswith("['blocks']['slstm']")
                    or k in ("['final_norm']", "['lm_head']")]
    assert len(before_mlstm) == 7
    for key in before_mlstm:
        err = np.linalg.norm(mine[key] - want[key])
        assert err <= 5e-2 * np.linalg.norm(want[key]), key

    f32 = build_model(cfg)
    p32 = tree_map(lambda t: t.float(), params)
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(lambda t: t * (1 + 1e-4 * torch.randn(
        t.shape, generator=gen)), p32)
    (l0, _), g0 = value_and_grad(make_loss_fn(f32, 0.01), p32, tbatch)
    (l1, _), g1 = value_and_grad(make_loss_fn(f32, 0.01), moved, tbatch)
    g0, g1 = _np(g0), _np(g1)
    assert _rel(float(l1), float(l0)) < 1e-4
    assert max(np.linalg.norm(g1[k] - g0[k]) / np.linalg.norm(g0[k])
               for k in g0) > 1e-2
