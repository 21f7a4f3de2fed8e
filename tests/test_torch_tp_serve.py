"""Tensor-parallel serving in the port (``ServeEngine(mesh=)``), on CPU
ranks over gloo.

The reference's own sharded serving fails under this jax (its sharded
tests raise at the vocab-sharded gather), so the port is held to the bar
those tests set: sharded greedy tokens equal single-device tokens
(``tests/test_serve_sharded.py``, ``tests/test_elastic_restart.py``).  The
single-device port engine's tokens are held to the reference's
single-device ``ServeEngine`` on the same numpy weights (the port's
paged engine to the reference's dense one, which its own paged engine
equals; the speculative and int8 modes against the reference in
tests/test_torch_spec.py and tests/test_torch_pages.py).

One spawn per mesh shape, every mode inside it; each rank runs one
thread, and the rendezvous store is in ``tmp_path``.  The rank functions
import nothing of jax (a spawned rank imports this module).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.dist import collectives
from repro_torch.dist.elastic import plan_mesh, resume_batch_indices
from repro_torch.launch.mesh import spawn
from repro_torch.models.registry import build_model
from repro_torch.serve.draft import self_int8_draft
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig

SPAWN = dict(threads=1, timeout=300)
MODES = {"dense": {}, "paged": {"paged": True}, "spec": {"spec": True},
         "paged+spec": {"paged": True, "spec": True}}
N_REQ, TOTAL, PRE = 4, 10, 4          # the elastic restart's requests


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: under
    pytest-xdist several workers each spinning a full thread pool on the
    same cores made them many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(model, qp, reqs, mesh=None, spec=False, **kw):
    """The requests' tokens, and the slots this rank's dense cache holds
    (None for a paged engine)."""
    sc = (SpecConfig(k=2, draft=self_int8_draft(model, qp)) if spec
          else None)
    eng = ServeEngine(model, qp, spec=sc, mesh=mesh, device="cpu",
                      page_size=8, **kw)
    out = eng.serve([Request(rid=r, prompt=np.asarray(p, np.int32),
                             max_new_tokens=n) for r, p, n in reqs])
    rows = None if eng.paged else eng._stepper.cache["len"].shape[0]
    return {rid: out[rid].tolist() for rid in out}, rows


def _load(path):
    return torch.load(path, weights_only=False)


def _decode_invariant(mesh, cfg, path):
    """One decode step at B 2 on this rank's shards: the collectives it
    runs, the placed leaves' shapes, and a serve's gather count."""
    model = build_model(cfg)
    eng = ServeEngine(model, _load(path), n_slots=2, max_len=64, mesh=mesh,
                      device="cpu")
    blocks = eng.params["blocks"]
    out = {"wq": tuple(blocks["wq"].codes.shape),
           "wq_scale": tuple(blocks["wq"].scale.shape),
           "wo": tuple(blocks["wo"].codes.shape),
           "lm_head": tuple(eng.params["lm_head"].shape)}
    with eng._mesh_ctx():
        cache = eng.new_cache(model, 2, 64)
        out["cache_k"] = tuple(cache["k"].shape)
        cache["len"] += 5
        collectives.reset_counts()
        logits, _ = model.decode_step(eng.params, cache,
                                      torch.tensor([[3], [7]]))
        out["step"] = collectives.counts()
        out["logits"] = tuple(logits.shape)
    collectives.reset_counts()
    eng.serve([Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=6)])
    m = eng.metrics()
    out["serve"] = collectives.counts()
    out["steps"] = m["decode_steps"] + m["prefill_batches"]
    out["mesh"] = m["mesh"]
    return out


def _rank_jobs(mesh, jobs, invariant=None):
    """Serve every job (name, cfg, tree path, requests, engine kwargs) on
    this rank; with ``invariant``, the decode-step check too."""
    results = {"slot rows": {}}
    for name, cfg, path, reqs, kw in jobs:
        results[name], results["slot rows"][name] = _serve(
            build_model(cfg), _load(path), reqs, mesh=mesh, **kw)
    if invariant is not None:
        results["invariant"] = _decode_invariant(mesh, *invariant)
    return results


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The reference's tiny llama3-8b at KH 4, RTN-packed in JAX, crossed
    as numpy arrays, and the reference dense engine's tokens on it; the
    port's own FAQ-packed tiny llama3-8b at KH 2 (its ``act_scale`` cut on
    the row shards); both saved for the ranks."""
    import jax

    from repro.configs import ARCHS as J_ARCHS
    from repro.core import QuantSpec, quantize_model
    from repro.data.synthetic import DataConfig, SyntheticLM
    from repro.models.registry import build_model as j_build
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.bridge import from_numpy_tree
    from repro_torch.configs import ARCHS
    from repro_torch.core import QuantSpec as TSpec
    from repro_torch.core import quantize_model as t_quantize
    from repro_torch.core import run_calibration as t_calibrate
    from repro_torch.data.synthetic import DataConfig as TData
    from repro_torch.data.synthetic import SyntheticLM as TSynthetic
    from repro_torch.data.synthetic import calibration_batches as t_batches

    def t_data(vocab):
        return TSynthetic(TData(vocab_size=vocab))

    d = tmp_path_factory.mktemp("tp_trees")
    out = {"dir": d}
    jcfg = dataclasses.replace(J_ARCHS["llama3-8b"].tiny(), n_kv_heads=4)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    data = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size))
    qp, _ = quantize_model(jp, jm.quant_site_map(), None, method="rtn",
                           spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    path = d / "kv4.pt"
    torch.save(from_numpy_tree(jax.tree_util.tree_map(np.asarray, qp),
                               "cpu"), path)
    reqs = [(i, data.sequence(77 + i, 9 + i).tolist(), 8) for i in range(3)]
    out["kv4"] = (dataclasses.replace(ARCHS["llama3-8b"].tiny(),
                                      n_kv_heads=4), path, reqs)
    res = JServeEngine(jm, qp, n_slots=2, max_len=64).serve(
        [JRequest(rid=r, prompt=np.asarray(p), max_new_tokens=n)
         for r, p, n in reqs])
    out["jax_dense"] = {r: np.asarray(res[r]).tolist() for r in res}
    # KH 2 (the tiny config's own), quantized by the port
    cfg = ARCHS["llama3-8b"].tiny()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    t_stats = t_calibrate(model.forward, params,
                          t_batches(t_data(cfg.vocab_size), 4, 32))
    qp2, _ = t_quantize(params, model.quant_site_map(), t_stats,
                        method="faq", spec=TSpec(bits=4, group_size=64),
                        mode="packed")
    path = d / "kv2.pt"
    torch.save(qp2, path)
    out["kv2"] = (cfg, path, reqs)
    out["restart_prompts"] = [data.sequence(500 + i, 8 + i).tolist()
                              for i in range(N_REQ)]
    return out


def _single(cfg, path, reqs, **kw):
    return _serve(build_model(cfg), _load(path), reqs, **kw)[0]


def _jobs(trees, slots=2):
    cfg, path, reqs = trees["kv4"]
    return [(mode, cfg, path, reqs, dict(kw, n_slots=slots, max_len=64))
            for mode, kw in MODES.items()]


def test_identity_matrix_model_4(trees, tmp_path):
    """(1, 4): dense, paged, spec and paged + spec equal the single-device
    port engine, which equals the reference's; KH 2 on model 4 replicates
    attention (its cache unsharded) and equals too."""
    jobs = _jobs(trees)
    cfg2, path2, reqs2 = trees["kv2"]
    jobs.append(("kh2", cfg2, path2, reqs2, dict(n_slots=2, max_len=64)))
    got = spawn(_rank_jobs, (1, 4), "gloo", str(tmp_path), jobs, **SPAWN)
    for name, cfg, path, reqs, kw in jobs:
        ref = _single(cfg, path, reqs, **kw)
        if name in ("dense", "paged"):
            assert ref == trees["jax_dense"], name
        assert got[name] == ref, name


def test_elastic_restart_and_model_2(trees, tmp_path):
    """A (2, 2) mesh (the dense engine's 4 slots cut 2 per data row)
    serves 4 requests for 4 tokens and loses its second data row;
    ``plan_mesh`` replans to (1, 2), whose ranks resume every
    request with prompt + emitted tokens: the stitched tokens equal the
    uninterrupted single-device serve.  The (1, 2) spawn also runs the
    identity matrix, int8 KV dense and paged, and the decode-step
    collective invariant."""
    cfg, path, _ = trees["kv2"]
    prompts = trees["restart_prompts"]
    ref = _single(cfg, path, [(i, prompts[i], TOTAL) for i in range(N_REQ)],
                  n_slots=N_REQ, max_len=64)
    phase1 = [("partial", cfg, path, [(i, prompts[i], PRE)
                                      for i in range(N_REQ)],
               dict(n_slots=N_REQ, max_len=64))]
    got = spawn(_rank_jobs, (2, 2), "gloo", str(tmp_path), phase1, **SPAWN)
    partial = got["partial"]
    assert all(len(partial[i]) == PRE for i in range(N_REQ))
    # the dense engine cuts its slots over data: rank 0 holds 2 of the 4
    assert got["slot rows"]["partial"] == N_REQ // 2

    plan = plan_mesh(2, model=2, old_data=2)
    assert (plan.data, plan.model, plan.used_chips) == (1, 2, 2)
    hosts = [resume_batch_indices(0, N_REQ // plan.data, h, plan.data)
             for h in range(plan.data)]
    assert sorted(i for h in hosts for i in h) == list(range(N_REQ))
    jobs = _jobs(trees)
    kv8 = dataclasses.replace(trees["kv4"][0], kv_cache_bits=8)
    for mode in ("dense", "paged"):
        jobs.append((f"int8 {mode}", kv8, trees["kv4"][1], trees["kv4"][2],
                     dict(MODES[mode], n_slots=2, max_len=64)))
    for h, idx in enumerate(hosts):
        jobs.append((f"resume {h}", cfg, path,
                     [(i, prompts[i] + partial[i], TOTAL - PRE) for i in idx],
                     dict(n_slots=len(idx), max_len=64)))
    got = spawn(_rank_jobs, (1, 2), "gloo", str(tmp_path), jobs,
                (cfg, path), **SPAWN)

    for h, idx in enumerate(hosts):
        for i in idx:
            assert partial[i] + got[f"resume {h}"][i] == ref[i], i
    for name, c, p, reqs, kw in jobs:
        if not name.startswith("resume"):
            assert got[name] == _single(c, p, reqs, **kw), name

    inv = got["invariant"]
    b, d, v_pad = 2, cfg.d_model, 512
    hd = cfg.head_dim_
    assert inv["mesh"] == {"data": 1, "model": 2}
    # wq column-parallel (codes and scale split n_out), wo row-parallel,
    # head-sharded KV cache, vocab-sharded head
    assert inv["wq"] == (cfg.n_layers, d // 2, cfg.n_heads * hd // 2)
    assert inv["wq_scale"][-1] == cfg.n_heads * hd // 2
    assert inv["wo"] == (cfg.n_layers, cfg.n_heads * hd // 4, d)
    assert inv["cache_k"] == (cfg.n_layers, 2, cfg.n_kv_heads // 2, 64, hd)
    assert inv["lm_head"] == (d, v_pad // 2)
    step = inv["step"]
    assert inv["logits"] == (b, 1, v_pad)
    # exactly one all_gather per decode step: the logits, to the padded
    # vocab; activation-sized all_reduces only; no all_to_all
    assert step["all_gather"]["calls"] == 1
    assert step["all_gather"]["last_shape"] == (b, 1, v_pad)
    assert step["all_reduce"]["calls"] == 1 + 2 * cfg.n_layers
    assert step["all_reduce"]["max_elements"] <= b * d
    assert step["all_to_all"]["calls"] == 0
    assert step["broadcast"]["calls"] == 0
    cache_elems = 2 * (cfg.n_kv_heads // 2) * 64 * hd
    for kind in collectives.KINDS:
        assert step[kind]["max_elements"] < cache_elems
    serve = inv["serve"]
    assert serve["all_gather"]["calls"] == inv["steps"]
    assert serve["all_to_all"]["calls"] == 0

