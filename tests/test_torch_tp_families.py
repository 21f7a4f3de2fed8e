"""Tensor-parallel serving of the vlm, hybrid, ssm and audio families in the
port (``ServeEngine(mesh=)``), and ``slo=`` / ``faults=`` / open-loop
``serve(feed=)`` under a mesh, on CPU ranks over gloo.

The reference's own mesh path fails under this jax (its sharded tests
raise at the vocab-sharded gather), so the bar is the one
tests/test_torch_tp_serve.py sets: tokens on a mesh equal the single-device
port's, and those equal the reference's single-device tokens on the same
numpy weights (the reference's engine for qwen2-vl, hymba and xlstm; its
``prefill(frames=)`` / ``decode_step`` for whisper, which no engine
drives).

The collectives of one engine step (a prefill or a decode step) at
``model`` 2 are one all_gather (the logits) and the all_reduces of
each model's ``tp_all_reduces`` (the formula the smoke holds the card to
as well); the tiny configs' numbers are written out here: qwen2-vl 9,
hymba 17 (attention cut) and 13 (3 / 1 heads: attention whole), xlstm 4
(one per mLSTM layer: its heads' outputs put together), whisper 13 a
decode step and 17 in its prefill.

One spawn per mesh shape, every family and mode inside it; each rank runs
one thread, and the rendezvous store is in ``tmp_path``.  The rank
functions import nothing of jax (a spawned rank imports this module).
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.dist import collectives
from repro_torch.dist.sharding import serving_rules
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.registry import build_model
from repro_torch.serve import (FaultConfig, FaultInjector, Scheduler,
                               SLOConfig, TrafficConfig, make_trace)
from repro_torch.serve.engine import Request, ServeEngine

SPAWN = dict(threads=1, timeout=300)
SPEC = dict(bits=4, group_size=64)
FAMILIES = ("qwen2-vl-2b", "hymba-1.5b", "xlstm-350m")
# 3 requests of 12-token prompts on 2 slots (slot 0 admitted twice);
# hymba's 16-slot ring wraps while decoding
PROMPT, NEW = 12, (8, 6, 5)
MAX_LEN = 48
WHISPER_B, WHISPER_T, WHISPER_STEPS = 2, 10, 6
# hymba with attention replicated next to a cut Mamba (3 / 1 heads of 64
# do not divide model 2, as hymba-1.5b's 25 / 5 do not)
HYMBA_ODD = dict(n_heads=3, n_kv_heads=1, head_dim=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path):
    return torch.load(path, weights_only=False)


# all_reduces of one engine step at model 2, the tiny configs (docstring)
PER_STEP = {"qwen2-vl-2b": 9, "hymba-1.5b": 17, "hymba odd heads": 13,
            "xlstm-350m": 4}
WHISPER_PER_STEP = {"prefill": 17, "decode": 13}


# -- what a rank runs ---------------------------------------------------------

def _serve(mesh, cfg, path, reqs):
    """The requests' tokens on a 2-slot engine (``mesh`` None: single
    device), the run's collectives and its engine steps."""
    eng = ServeEngine(build_model(cfg), _load(path), n_slots=2,
                      max_len=MAX_LEN, mesh=mesh, device="cpu")
    collectives.reset_counts()
    out = eng.serve([Request(rid=r, prompt=np.asarray(p, np.int32),
                             max_new_tokens=n) for r, p, n in reqs])
    m = eng.metrics()
    return dict(tokens={r: out[r].tolist() for r in out},
                collectives=collectives.counts(),
                steps=m["decode_steps"] + m["prefill_batches"],
                per_step=eng.model.tp_all_reduces(eng.mesh))


def _whisper(mesh, cfg, path, toks, frames):
    """prefill(frames=) + greedy decode steps through an engine's placed
    weights, caches and mesh context: the tokens, the prefill's
    collectives and the decode steps'."""
    model = build_model(cfg)
    eng = ServeEngine(model, _load(path), n_slots=WHISPER_B, max_len=MAX_LEN,
                      mesh=mesh, device="cpu")
    v = cfg.vocab_size
    with eng._mesh_ctx():
        cache = eng.new_cache(model, WHISPER_B, MAX_LEN)
        collectives.reset_counts()
        logits, cache = model.prefill(eng.params, torch.as_tensor(toks),
                                      cache, frames=torch.as_tensor(frames))
        pre = collectives.counts()
        out = [logits[:, 0, :v].argmax(-1)]
        collectives.reset_counts()
        for _ in range(WHISPER_STEPS):
            logits, cache = model.decode_step(eng.params, cache,
                                              out[-1][:, None].to(torch.int32))
            out.append(logits[:, 0, :v].argmax(-1))
        dec = collectives.counts()
    return dict(tokens=torch.stack(out, 1).tolist(), prefill=pre,
                decode=dec, per_step={
                    "prefill": model.tp_all_reduces(mesh, prefill=True),
                    "decode": model.tp_all_reduces(mesh)})


def _ticker(dt):
    tick = {"t": 0.0}

    def clock():
        tick["t"] += dt
        return tick["t"]
    return tick, clock


def _traffic(mesh, cfg, path):
    """An open-loop run (``Scheduler.run_traffic``) of a seeded trace
    through a paged engine with ``slo=`` and ``faults=`` on a fake clock
    that ticks per read (the stalls advance it): per-request records,
    the summary, the registry's deltas and the injector's counts."""
    tick, clock = _ticker(0.001)
    inj = FaultInjector(
        FaultConfig(alloc_fail_at=(1, 4), preempt_at=(6,), stall_at=(3, 9),
                    stall_s=0.05),
        advance=lambda dt: tick.__setitem__("t", tick["t"] + dt))
    eng = ServeEngine(build_model(cfg), _load(path), n_slots=2,
                      max_len=MAX_LEN, paged=True, page_size=8, clock=clock,
                      slo=SLOConfig(seed=1, retry_base_s=0.02, quota_tokens=40),
                      faults=inj, mesh=mesh, device="cpu")
    trace = make_trace(TrafficConfig(
        n_requests=8, rate=40.0, seed=5, vocab_size=cfg.vocab_size,
        prompt_len_median=10, prompt_len_max=16, max_new_tokens=6,
        deadline_s=0.4))
    res = Scheduler(eng).run_traffic(trace)
    return dict(tokens={r: np.asarray(t).tolist() for r, t in res.items()},
                records=res.records, summary=res.summary,
                delta=res.registry_delta, faults=eng.metrics()["faults"])


def _digest(obj) -> int:
    """A number that two ranks share only if ``obj`` is the same on both."""
    text = json.dumps(obj, sort_keys=True, default=str)
    return int(hashlib.sha256(text.encode()).hexdigest()[:12], 16)


RUNS = {"serve": _serve, "whisper": _whisper, "traffic": _traffic}


def _rank_jobs(mesh, jobs):
    """Run every job on this rank; each result also carries the digests of
    every rank's (all_gathered over the mesh), so rank 0's answer says
    whether every rank decided alike."""
    out = {}
    for name, kind, args in jobs:
        res = RUNS[kind](mesh, *args)
        mine = torch.tensor([float(_digest(res))], dtype=torch.float64)
        every = [torch.zeros_like(mine) for _ in range(mesh.n_ranks)]
        torch.distributed.all_gather(every, mine)
        out[name] = dict(res, digests=[float(g) for g in every])
    return out


# -- the trees -----------------------------------------------------------------

def _packed(cfg):
    """The port's tiny ``cfg`` from seed 0, RTN int4-packed."""
    model = build_model(cfg)
    qp, _ = quantize_model(model.init(0, device="cpu"),
                           model.quant_site_map(), None, method="rtn",
                           spec=QuantSpec(**SPEC), mode="packed")
    return qp


def _to_reference(tree):
    """A port tree as the reference's: jax arrays and its QuantizedTensor
    on the same numbers."""
    import jax.numpy as jnp

    from repro.core.quantizer import QuantizedTensor as JQT
    from repro.core.quantizer import QuantSpec as JSpec
    from repro_torch.core.quantizer import QuantizedTensor

    if isinstance(tree, dict):
        return {k: _to_reference(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        arr = lambda t: None if t is None else jnp.asarray(t.numpy())
        return JQT(codes=arr(tree.codes), scale=arr(tree.scale),
                   zero=arr(tree.zero),
                   spec=JSpec(bits=tree.spec.bits,
                              group_size=tree.spec.group_size,
                              symmetric=tree.spec.symmetric),
                   n_in=tree.n_in, packed=tree.packed,
                   act_scale=arr(tree.act_scale))
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """For each family the port's tiny model from seed 0, RTN-packed and
    saved for the ranks, with the reference's single-device tokens on the
    same numbers (its engine; whisper's ``prefill(frames=)`` /
    ``decode_step``); the hymba variant with replicated attention and the
    traffic run's tiny llama3-8b, saved alike."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as J_ARCHS
    from repro.models.registry import build_model as j_build
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    d = tmp_path_factory.mktemp("tp_family_trees")
    rng = np.random.default_rng(11)
    out = {}
    for arch in FAMILIES + ("whisper-small",):
        cfg = ARCHS[arch].tiny()
        qp = _packed(cfg)
        path = d / f"{arch}.pt"
        torch.save(qp, path)
        jm, jq = j_build(J_ARCHS[arch].tiny()), _to_reference(qp)
        if arch == "whisper-small":
            toks = rng.integers(1, cfg.vocab_size, (WHISPER_B, WHISPER_T)) \
                .astype(np.int32)
            frames = (rng.standard_normal((WHISPER_B, cfg.encoder_len,
                                           cfg.d_model)) * 0.1) \
                .astype(np.float32)
            logits, cache = jax.jit(
                lambda p, x, c, f: jm.prefill(p, x, c, frames=f))(
                jq, jnp.asarray(toks), jm.init_cache(WHISPER_B, MAX_LEN),
                jnp.asarray(frames))
            step = jax.jit(jm.decode_step)
            got = [np.asarray(logits[:, 0, :cfg.vocab_size]).argmax(-1)]
            for _ in range(WHISPER_STEPS):
                logits, cache = step(jq, cache,
                                     jnp.asarray(got[-1][:, None], jnp.int32))
                got.append(np.asarray(logits[:, 0, :cfg.vocab_size])
                           .argmax(-1))
            out[arch] = (cfg, path, toks, frames)
            out["jax " + arch] = np.stack(got, 1).tolist()
            continue
        reqs = [(i, rng.integers(1, cfg.vocab_size, PROMPT).tolist(), n)
                for i, n in enumerate(NEW)]
        res = JServeEngine(jm, jq, n_slots=2, max_len=MAX_LEN).serve(
            [JRequest(rid=r, prompt=np.asarray(p, np.int32), max_new_tokens=n)
             for r, p, n in reqs])
        out[arch] = (cfg, path, reqs)
        out["jax " + arch] = {r: np.asarray(res[r]).tolist() for r in res}
    for name, cfg in (("hymba odd heads", ARCHS["hymba-1.5b"].tiny().scaled(
                          **HYMBA_ODD)),
                      ("llama3-8b", ARCHS["llama3-8b"].tiny())):
        path = d / f"{name}.pt"
        torch.save(_packed(cfg), path)
        out[name] = (cfg, path, out["hymba-1.5b"][2])
    return out


def _jobs(trees):
    jobs = [(arch, "serve", trees[arch]) for arch in FAMILIES]
    jobs.append(("hymba odd heads", "serve", trees["hymba odd heads"]))
    jobs.append(("whisper-small", "whisper", trees["whisper-small"]))
    cfg, path, _ = trees["llama3-8b"]
    jobs.append(("traffic", "traffic", (cfg, path)))
    return jobs


def test_families_and_traffic_on_model_2(trees, tmp_path):
    """(1, 2): qwen2-vl, hymba (attention cut and, with 3 / 1 heads,
    replicated) and xlstm engine tokens, whisper's ``prefill(frames=)`` +
    decode tokens, and an open-loop ``slo=`` + ``faults=`` traffic run on a
    fake clock equal single-device, which equals the reference; every rank
    returns the same result; the collectives per step follow the module
    docstring's formula."""
    jobs = _jobs(trees)
    got = spawn(_rank_jobs, (1, 2), "gloo", str(tmp_path), jobs, **SPAWN)
    for name, kind, args in jobs:
        run = got[name]
        assert len(set(run["digests"])) == 1, f"{name}: the ranks differ"
        ref = RUNS[kind](None, *args)
        cfg = args[0]
        if kind == "serve":
            assert run["tokens"] == ref["tokens"], name
            if name in FAMILIES:
                assert ref["tokens"] == trees["jax " + name], name
            coll, steps = run["collectives"], run["steps"]
            assert run["per_step"] == PER_STEP[name], name
            assert coll["all_gather"]["calls"] == steps, name
            assert coll["all_reduce"]["calls"] == steps * PER_STEP[name], name
            # activations only: the widest is the mLSTM's d_inner row
            width = cfg.d_model * (cfg.ssm_expand if cfg.family == "ssm"
                                   else 1)
            assert coll["all_reduce"]["max_elements"] <= PROMPT * width
            assert coll["all_to_all"]["calls"] == 0, name
            assert ref["collectives"]["all_reduce"]["calls"] == 0, name
        elif kind == "whisper":
            pre, dec = run["prefill"], run["decode"]
            assert run["tokens"] == ref["tokens"] == trees["jax " + name]
            assert run["per_step"] == WHISPER_PER_STEP
            assert pre["all_gather"]["calls"] == 1
            assert pre["all_reduce"]["calls"] == WHISPER_PER_STEP["prefill"]
            assert pre["all_reduce"]["max_elements"] <= \
                WHISPER_B * cfg.encoder_len * cfg.d_model
            assert dec["all_gather"]["calls"] == WHISPER_STEPS
            assert dec["all_reduce"]["calls"] == \
                WHISPER_STEPS * WHISPER_PER_STEP["decode"]
            assert dec["all_reduce"]["max_elements"] <= \
                WHISPER_B * cfg.d_model
        else:
            for key in ("tokens", "records", "summary", "delta", "faults"):
                assert run[key] == ref[key], key
            s, f = ref["summary"], ref["faults"]
            # the run exercised what it claims to: completions, retried and
            # terminal sheds, preemptions and resumes, vetoed allocations,
            # a forced preemption and stalls, and idle loop iterations
            # (more iterations than engine steps)
            assert s["completed"] >= 1 and s["shed"] >= 1, s
            assert s["shed_retried"] >= 1 and s["resumed"] >= 1, s
            assert f["alloc_failures"] == 2 and f["stalls"] == 2, f
            assert f["forced_preempts"] == 1, f
            assert f["loop_iters"] > run["delta"]["serve.decode_steps"] \
                + run["delta"]["serve.prefill_batches"], f


def test_hymba_model_4_refuses_a_split_inside_groups():
    """At ``model`` 4, hymba-1.5b's ``w_down`` input (5504 / 4 = 1376 rows,
    groups of 64) falls neither on whole groups nor inside one: the engine
    refuses the mesh up front, naming the leaf and the split.  The tiny
    model with ``d_ff`` 384 (96 rows per rank) has the same split; at
    ``model`` 2 (192 rows, whole groups) it is placed."""
    cfg = ARCHS["hymba-1.5b"].tiny().scaled(d_ff=384)
    model = build_model(cfg)
    qp, _ = quantize_model(model.init(0, device="cpu"),
                           model.quant_site_map(), None, method="rtn",
                           spec=QuantSpec(**SPEC), mode="packed")
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=r"\['blocks'\]\['w_down'\].*384 "
                                         r"rows in 4 leaves 96 rows.*groups "
                                         r"of 64"):
        ServeEngine(model, qp, mesh=Mesh({"data": 1, "model": 4}, 1, "gloo",
                                         {}, cpu), device="cpu")
    eng = ServeEngine(model, qp, mesh=Mesh({"data": 1, "model": 2}, 1,
                                           "gloo", {}, cpu), device="cpu")
    assert eng.params["blocks"]["w_down"].n_in == 192


@pytest.mark.parametrize("arch", FAMILIES + ("whisper-small",))
def test_data_axis_refused_for_the_families(arch):
    """``data > 1`` stays refused for these families, naming the ROADMAP
    item."""
    cfg = ARCHS[arch].tiny()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="data-parallel serving of "
                                                  "the non-dense families"):
        ServeEngine(model, params, mesh=Mesh({"data": 2, "model": 1}, 0,
                                             "gloo", {},
                                             torch.device("cpu")),
                    device="cpu")


def test_family_caches_are_cut_on_their_axes():
    """A rank's cache at ``model`` 2: hymba's ring on KV heads and its Mamba
    state on d_inner channels (nested dict), xlstm's mLSTM state on heads
    and its sLSTM list whole, starting where the single-device state does
    (the stabilizer at -1e9), whisper's self and cross caches on KV
    heads."""
    cpu = torch.device("cpu")
    mesh = Mesh({"data": 1, "model": 2}, 1, "gloo", {}, cpu)
    shapes = {}
    for arch in ("hymba-1.5b", "xlstm-350m", "whisper-small"):
        model = build_model(ARCHS[arch].tiny())
        eng = ServeEngine(model, model.init(0, device="cpu"), mesh=mesh,
                          device="cpu")
        cache = eng.new_cache(model, 3, MAX_LEN)
        whole = model.init_cache(3, MAX_LEN, device="meta")
        shapes[arch] = (cache, whole, model)
    cache, whole, _ = shapes["hymba-1.5b"]
    assert cache["k"].shape[2] == whole["k"].shape[2] // 2
    assert cache["mamba"]["h"].shape[2] == whole["mamba"]["h"].shape[2] // 2
    assert cache["mamba"]["conv"].shape[3] == \
        whole["mamba"]["conv"].shape[3] // 2
    cache, whole, model = shapes["xlstm-350m"]
    assert cache["mlstm"]["C"].shape[2] == whole["mlstm"]["C"].shape[2] // 2
    assert cache["mlstm"]["n"].shape[2] == whole["mlstm"]["n"].shape[2] // 2
    assert [s.shape for s in cache["slstm"]] == \
        [s.shape for s in whole["slstm"]]
    # each leaf starts where the single-device cache does (the sLSTM
    # stabilizer at -1e9, the rest at 0)
    for mine, ref in zip(cache["slstm"], model.init_cache(3, MAX_LEN,
                                                          device="cpu")
                         ["slstm"]):
        assert torch.equal(mine, ref)
    cache, whole, _ = shapes["whisper-small"]
    for key in ("k", "v", "xk", "xv"):
        assert cache[key].shape[2] == whole[key].shape[2] // 2, key


def test_parts_annotation_cuts_each_half():
    """``("ff", "ff")`` gives a rank its block of both halves of a leaf
    (a float tensor and a QuantizedTensor alike), ``(None, "ff")`` the
    first half whole and its block of the second; ``local_shape`` agrees
    and one spec cannot describe such a leaf."""
    from repro_torch.dist import sharding as ts

    cpu = torch.device("cpu")
    meshes = [Mesh({"data": 1, "model": 2}, r, "gloo", {}, cpu)
              for r in range(2)]
    rules = serving_rules(ARCHS["hymba-1.5b"].tiny(), meshes[0])
    w = torch.arange(4 * 64 * 8, dtype=torch.float32).reshape(4, 64, 8)
    qt, _ = quantize_model({"w": w}, {("w",): "s"}, None, method="rtn",
                           spec=QuantSpec(**SPEC), mode="packed")
    qt = qt["w"]
    for r, mesh in enumerate(meshes):
        cols = list(range(2 * r, 2 * r + 2)) + list(range(4 + 2 * r,
                                                          6 + 2 * r))
        got = ts.shard_leaf(w, (None, None, ("ff", "ff")), mesh, rules)
        assert torch.equal(got, w[..., cols])
        q = ts.shard_leaf(qt, (None, None, ("ff", "ff")), mesh, rules)
        assert torch.equal(q.codes, qt.codes[..., cols])
        assert torch.equal(q.scale, qt.scale[..., cols])
        keep = list(range(4)) + [4 + 2 * r, 5 + 2 * r]
        got = ts.shard_leaf(w, (None, None, (None, "ff")), mesh, rules)
        assert torch.equal(got, w[..., keep])
        assert ts.local_shape(w.shape, (None, None, (None, "ff")), mesh,
                              rules) == (4, 64, 6)
    with pytest.raises(ValueError, match="parts"):
        ts.logical_to_spec((None, ("ff", "ff")), shape=(64, 8),
                           mesh=meshes[0], rules=rules)


def test_port_axes_follow_the_reference():
    """The families' param and cache annotations are the reference's, leaf
    for leaf, except where the port's layout differs by design (named
    here): Mamba's two-part ``in_proj``, its ``d_skip`` cut with the
    channels it meets and its whole ``dt_proj``, the mLSTM's whole
    ``up_proj`` / ``down_proj``, whisper's column-parallel ``wk`` / ``wv``
    and ``b1``, and xlstm's whole sLSTM state."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.models.registry import build_model as j_build

    changed = {
        ("blocks", "mamba", "in_proj"): (None, "fsdp", ("ff", "ff")),
        ("blocks", "mamba", "dt_proj"): (None, None, None),
        ("blocks", "mamba", "d_skip"): (None, "ff"),
        ("blocks", "mlstm", "up_proj"): (None, "fsdp", None),
        ("blocks", "mlstm", "down_proj"): (None, None, "fsdp"),
        ("slstm",): [(None, "batch", None, None)] * 4,
        # DenseLM's (qwen2-vl, hymba): tests/test_torch_sharding.py
        ("blocks", "wk"): (None, "fsdp", "kv_heads"),
        ("blocks", "wv"): (None, "fsdp", "kv_heads"),
    }
    for stack in ("enc_blocks", "dec_blocks"):
        changed[(stack, "b1")] = (None, "ff")
        for att in ("attn", "cross"):
            for w in ("wk", "wv"):
                changed[(stack, att, w)] = (None, "fsdp", "kv_heads")

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, prefix + (k,)))
            return out
        return {prefix: list(tree) if isinstance(tree, list) else tree}

    for arch in FAMILIES + ("whisper-small",):
        ours = build_model(ARCHS[arch].tiny())
        ref = j_build(J_ARCHS[arch].tiny())
        for mine, theirs in ((ours.param_axes(), ref.param_axes()),
                             (ours.cache_axes(), ref.cache_axes())):
            mine, theirs = flat(mine), flat(theirs)
            assert set(mine) == set(theirs), arch
            for key, ax in mine.items():
                assert ax == changed.get(key, theirs[key]), (arch, key)


def test_serve_cli_mesh_for_hymba():
    """``launch/serve.py --mesh 1,2 --arch hymba-1.5b`` with an SLO
    deadline, a forced preemption and a stall prints the tokens of the same
    command without ``--mesh``."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "hymba-1.5b", "--tiny", "--device", "cpu",
            "--requests", "2", "--new-tokens", "4", "--calib-n", "2",
            "--calib-len", "16", "--deadline-s", "600",
            "--fault-preempt-at", "2", "--fault-stall-at", "1",
            "--fault-stall-s", "0.01"]
    alone = launch_serve.main(argv)
    meshed = launch_serve.main(argv + ["--mesh", "1,2"])
    assert sorted(meshed) == [0, 1]
    for rid in alone:
        assert np.asarray(meshed[rid]).tolist() == \
            np.asarray(alone[rid]).tolist()
