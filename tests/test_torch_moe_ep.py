"""MoE expert parallelism in the port (``models/moe.py``'s
``_moe_body_sharded`` / ``moe_ffn``), on CPU ranks over gloo.

As the reference's ``test_moe_shard_map_equals_local``
(tests/test_sharding.py): at capacity factor 16 nothing drops, so the
expert-parallel FFN equals the local one.  x is split over ``data`` on the
batch, the experts over ``model``; each rank's rows must be within 1e-5
(f32) of the port's ``moe_ffn_local`` on the whole input, which is within
1e-5 of the reference's ``moe_ffn_local`` on the same numpy inputs.  A
tiny qwen2-moe served at (1, 2) on one slot gives the single-device
tokens.  One spawn per mesh shape; each rank runs one thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist import sharding
from repro_torch.launch.mesh import spawn
from repro_torch.models.moe import (_expert_specs, _moe_body_sharded,
                                    moe_ffn_local, padded_experts)
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

SPAWN = dict(threads=1, timeout=300)
CFG = dataclasses.replace(ARCHS["qwen2-moe-a2.7b"].tiny(),
                          moe_capacity_factor=16.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: under
    pytest-xdist several workers each spinning a full thread pool on the
    same cores made them many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m_pad=4):
    rng = np.random.default_rng(0)
    e_pad = padded_experts(CFG.n_experts, m_pad)
    d, f = CFG.d_model, CFG.d_ff
    return dict(x=rng.standard_normal((4, 8, d), np.float32),
                router=rng.standard_normal((d, e_pad), np.float32) * 0.1,
                wg=rng.standard_normal((e_pad, d, f), np.float32) * 0.05,
                wu=rng.standard_normal((e_pad, d, f), np.float32) * 0.05,
                wd=rng.standard_normal((e_pad, f, d), np.float32) * 0.05)


def _cut(w, mesh):
    """This rank's block of the expert weight ``w``, by ``_expert_specs``."""
    for dim, axis in enumerate(_expert_specs(w)):
        if axis is not None:
            n = w.shape[dim] // mesh.size(axis)
            w = w.narrow(dim, mesh.index(axis) * n, n)
    return w.contiguous()


def _body_on_rank(mesh, inp, y_local):
    """This rank's expert-parallel FFN on its batch rows; returns its max
    error against the local FFN's same rows (every rank checks its own)."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    d = mesh.size("data")
    b = t["x"].shape[0] // d
    rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    data_axes = ("data",) if d > 1 else ()
    with sharding.axis_rules(mesh):
        y, aux = _moe_body_sharded(t["x"][rows], t["router"],
                                   _cut(t["wg"], mesh), _cut(t["wu"], mesh),
                                   _cut(t["wd"], mesh), cfg=CFG,
                                   data_axes=data_axes)
    err = float((y - torch.from_numpy(y_local[rows])).abs().max())
    assert err < 1e-5, err
    assert torch.isfinite(aux)
    return err


def _moe_tree():
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=CFG.vocab_size))
    qp, _ = quantize_model(params, model.quant_site_map(), None,
                           method="rtn", spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    reqs = [Request(rid=i, prompt=data.sequence(77 + i, 9 + 7 * i),
                    max_new_tokens=6) for i in range(3)]
    return model, qp, reqs


def _serve_moe(mesh=None):
    model, qp, reqs = _moe_tree()
    eng = ServeEngine(model, qp, n_slots=1, max_len=64, mesh=mesh,
                      device="cpu")
    out = eng.serve(reqs)
    experts = eng.params["blocks"]["wg_exp"].codes.shape[1]
    return {r: out[r].tolist() for r in out}, experts


def _rank(mesh, inp, y_local, serve):
    out = {"err": _body_on_rank(mesh, inp, y_local)}
    if serve:
        out["tokens"], out["experts"] = _serve_moe(mesh)
    return out


def test_expert_parallel_equals_local(tmp_path):
    import jax.numpy as jnp

    from repro.configs import ARCHS as J_ARCHS
    from repro.models.moe import moe_ffn_local as j_moe_ffn_local

    inp = _inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    y_local, aux_local, _ = moe_ffn_local(t["x"], t["router"], t["wg"],
                                          t["wu"], t["wd"], CFG)
    jcfg = dataclasses.replace(J_ARCHS["qwen2-moe-a2.7b"].tiny(),
                               moe_capacity_factor=16.0)
    y_ref, aux_ref, _ = j_moe_ffn_local(
        *(jnp.asarray(inp[k]) for k in ("x", "router", "wg", "wu", "wd")),
        jcfg)
    np.testing.assert_allclose(y_local.numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux_local), float(aux_ref), rtol=1e-5)
    y_np = y_local.numpy()
    got = spawn(_rank, (2, 2), "gloo", str(tmp_path), inp, y_np, False,
                **SPAWN)
    assert got["err"] < 1e-5
    got = spawn(_rank, (1, 2), "gloo", str(tmp_path), inp, y_np, True,
                **SPAWN)
    assert got["err"] < 1e-5
    tokens, experts = _serve_moe()
    assert got["experts"] == experts // 2
    assert got["tokens"] == tokens
