"""Speculative decoding in the port: draft sources, the T-token verify,
the accept/resample rule and rollback, against the port's own
non-speculative serving, its ``generate`` and repro's engine.

Mirrors tests/test_spec.py and the spec half of
tests/test_chunked_prefill.py on the CPU (every kernel runs its plain
version).  Weights are repro's tiny llama3-8b (4 layers, d_model 128, f32),
crossed to the port as numpy arrays.  Bars: greedy tokens identical; the
plain verify versions within atol = rtol = 1e-5 of repro's (f32 einsums in
another order); ``mode="fake"`` weights within 1e-6 of repro's, with at most
0.1% of entries one quantization step apart (a code at a rounding tie); the
accept rule's leftover distribution exactly the one the rule defines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as j_quantize_model
from repro.core import run_calibration as j_run_calibration
from repro.kernels import ref as jref
from repro.models.registry import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SpecConfig as JSpecConfig
from repro.serve import policy_probs as j_policy_probs
from repro.serve import self_int8_draft as j_self_int8_draft
from repro_torch.bridge import from_numpy_tree
from repro_torch.core import QuantSpec, quantize_model, run_calibration
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as launch_serve
from repro_torch.models.dense import DenseLM
from repro_torch.models.registry import build_model
from repro_torch.serve.cache_ops import truncate_slot
from repro_torch.serve.draft import (ModelDraft, registry_draft,
                                     self_int8_draft)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampler import policy_probs, spec_accept
from repro_torch.serve.spec import SpecConfig

CPU = dict(device="cpu")


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fp_setup():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, build_model(cfg), from_numpy_tree(_to_np(jp), "cpu"), jm, jp


@pytest.fixture(scope="module")
def kv8_setup(fp_setup):
    cfg = fp_setup[0].scaled(kv_cache_bits=8)
    return cfg, build_model(cfg), fp_setup[2]


def _mixed_requests(cfg, n, seed=0, max_new=(2, 10)):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(3, 28))),
                    max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _clone(reqs):
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, deadline=r.deadline)
            for r in reqs]


def _assert_identical(plain_eng, spec_eng, reqs):
    res_p = plain_eng.serve(_clone(reqs))
    res_s = spec_eng.serve(_clone(reqs))
    for r in reqs:
        np.testing.assert_array_equal(res_p[r.rid], res_s[r.rid])
    return spec_eng.metrics()


# -- greedy identity: the cache-kind matrix ----------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_matches_nonspec_f32(fp_setup, paged):
    """Greedy serve(spec=...) equals non-speculative serve() token for
    token, and the self-int8 draft accepts (it tracks its own target)."""
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    kw = dict(n_slots=2, max_len=64, paged=paged, page_size=8, **CPU)
    plain = ServeEngine(m, params, **kw)
    spec = ServeEngine(m, params, spec=SpecConfig(k=3, draft=draft), **kw)
    mm = _assert_identical(plain, spec, _mixed_requests(cfg, 6, seed=0))
    assert mm["spec"] and mm["spec_cycles"] > 0
    assert mm["accept_rate"] > 0.5
    assert mm["tokens_per_step"] > 1.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_matches_nonspec_kv8(kv8_setup, paged):
    """The same identity on the int8 KV cache: the draft's speculative
    writes quantize per (token, head) and the verify span overwrites
    them."""
    cfg, m, params = kv8_setup
    draft = self_int8_draft(m, params)
    kw = dict(n_slots=2, max_len=48, paged=paged, page_size=8, **CPU)
    plain = ServeEngine(m, params, **kw)
    spec = ServeEngine(m, params, spec=SpecConfig(k=2, draft=draft), **kw)
    mm = _assert_identical(plain, spec, _mixed_requests(cfg, 5, seed=1))
    assert mm["spec_cycles"] > 0


def test_spec_matches_generate_int4_packed_target(fp_setup):
    """The serving configuration: an FAQ int4-packed target and the
    self-int8 draft re-quantized from the packed codes with the same
    statistics.  Speculative output equals generate() and the draft tracks
    the target."""
    cfg, m, params = fp_setup[:3]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    stats = run_calibration(m.forward, params, [{"tokens": tokens}])
    qp, _ = quantize_model(params, m.quant_site_map(), stats, method="faq",
                           spec=QuantSpec(bits=4, group_size=64),
                           mode="packed")
    draft = self_int8_draft(m, qp, stats)
    eng = ServeEngine(m, qp, n_slots=2, max_len=64,
                      spec=SpecConfig(k=3, draft=draft), **CPU)
    reqs = _mixed_requests(cfg, 4, seed=2)
    res = eng.serve(_clone(reqs))
    mm = eng.metrics()
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid], eng.generate(r))
    assert mm["accept_rate"] > 0.7          # int8(served) ~ int4 target
    assert mm["draft_kind"] == "self-int8" and mm["spec_k"] == 3


def test_spec_identity_survives_hostile_draft(fp_setup):
    """Correctness never depends on the draft: a randomly initialized
    independent draft proposes garbage (acceptance ~0), yet greedy output
    stays the target's."""
    cfg, m, params = fp_setup[:3]
    draft = registry_draft("stablelm-12b", seed=7, **CPU)
    plain = ServeEngine(m, params, n_slots=2, max_len=64, **CPU)
    spec = ServeEngine(m, params, n_slots=2, max_len=64,
                       spec=SpecConfig(k=2, draft=draft), **CPU)
    mm = _assert_identical(plain, spec, _mixed_requests(cfg, 4, seed=3))
    assert mm["accept_rate"] < 0.5
    assert mm["draft_kind"] == "model"


def test_spec_unsupported_model_falls_back(fp_setup):
    """A model that overrides the span-write decode path declines spec and
    serves non-speculatively."""
    cfg, _, params = fp_setup[:3]

    class OwnDecode(DenseLM):
        def decode_step(self, params, cache, token):
            return DenseLM.decode_step(self, params, cache, token)

    m = OwnDecode(cfg)
    assert not m.supports_spec()
    eng = ServeEngine(m, params, n_slots=2, max_len=48, **CPU,
                      spec=SpecConfig(k=3, draft=self_int8_draft(m, params)))
    assert eng._spec is None
    res = eng.serve([Request(rid=0, prompt=np.arange(6) % cfg.vocab_size,
                             max_new_tokens=3)])
    assert res[0].shape == (3,)
    assert not eng.metrics()["spec"]


# -- budget and capacity against speculative bursts --------------------------

def test_spec_burst_overshoot_truncated_at_budget(fp_setup):
    """Budgets that are not a multiple of k+1: the last burst overshoots
    and the accepted surplus is dropped; lengths and tokens match
    non-speculative serving."""
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    plain = ServeEngine(m, params, n_slots=2, max_len=64, **CPU)
    spec = ServeEngine(m, params, n_slots=2, max_len=64,
                       spec=SpecConfig(k=3, draft=draft), **CPU)
    reqs = [Request(rid=0, prompt=np.arange(9) % cfg.vocab_size,
                    max_new_tokens=5),
            Request(rid=1, prompt=np.arange(17) % cfg.vocab_size,
                    max_new_tokens=6)]
    res_p = plain.serve(_clone(reqs))
    res_s = spec.serve(_clone(reqs))
    for r in reqs:
        assert len(res_s[r.rid]) == r.max_new_tokens
        np.testing.assert_array_equal(res_p[r.rid], res_s[r.rid])


def test_spec_capacity_truncation_matches_nonspec(fp_setup):
    """A request reaching max_len mid-burst truncates exactly where
    non-speculative serving does (the depth shrinks near capacity)."""
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    kw = dict(n_slots=2, max_len=24, buckets=(8, 24), **CPU)
    plain = ServeEngine(m, params, **kw)
    spec = ServeEngine(m, params, spec=SpecConfig(k=3, draft=draft), **kw)
    prompt = (np.arange(8) % cfg.vocab_size).astype(np.int32)
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=100)]
    res_p = plain.serve(_clone(reqs))
    res_s = spec.serve(_clone(reqs))
    np.testing.assert_array_equal(res_p[0], res_s[0])
    assert res_s[0].shape == (1 + 24 - len(prompt),)
    assert spec.metrics()["truncated"] == 1


def test_spec_deadline_mid_burst_truncates(fp_setup):
    """A deadline passing mid-decode while a burst overshoots: the request
    is truncated (not expired) and its tokens are a prefix of the
    deadline-free run (the engine clock is injected)."""
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    prompt = (np.arange(7) % cfg.vocab_size).astype(np.int32)
    ref = ServeEngine(m, params, n_slots=1, max_len=64, **CPU,
                      spec=SpecConfig(k=3, draft=draft)).serve(
        [Request(rid=9, prompt=prompt, max_new_tokens=40)])[9]
    clock = {"t": 0.0}

    def fake_time():
        clock["t"] += 1.0
        return clock["t"]

    eng = ServeEngine(m, params, n_slots=1, max_len=64, clock=fake_time,
                      spec=SpecConfig(k=3, draft=draft), **CPU)
    streamed = []
    out = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=40,
                             deadline=6.5,
                             on_token=lambda rid, t: streamed.append(t))])
    mm = eng.metrics()
    assert mm["truncated"] == 1 and mm["expired"] == 0
    assert 0 < len(out[0]) < 40
    np.testing.assert_array_equal(out[0], ref[:len(out[0])])
    assert streamed == out[0].tolist()


def test_edf_deadline_expires_mid_decode_spec_burst(fp_setup):
    """The scheduler half of the test above (the reference's
    ``test_edf_deadline_expires_mid_decode_spec_burst``): a request
    submitted through the EDF Scheduler with a deadline that passes while
    a speculative burst overshoots is truncated, streams exactly what it
    returns, and the run's summary counts the truncation."""
    from repro_torch.serve import Scheduler
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    prompt = (np.arange(7) % cfg.vocab_size).astype(np.int32)
    ref = ServeEngine(m, params, n_slots=1, max_len=64, **CPU,
                      spec=SpecConfig(k=3, draft=draft)).serve(
        [Request(rid=9, prompt=prompt, max_new_tokens=40)])[9]
    clock = {"t": 0.0}

    def fake_time():
        clock["t"] += 1.0
        return clock["t"]

    eng = ServeEngine(m, params, n_slots=1, max_len=64, clock=fake_time,
                      spec=SpecConfig(k=3, draft=draft), **CPU)
    sched = Scheduler(eng)
    streamed = []
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=40),
                 deadline=6.5, on_token=lambda rid, t: streamed.append(t))
    out = sched.run()
    assert eng.metrics()["truncated"] == 1
    assert eng.metrics()["expired"] == 0
    assert 0 < len(out[0]) < 40
    np.testing.assert_array_equal(out[0], ref[:len(out[0])])
    assert streamed == out[0].tolist()
    assert out.summary["truncated"] == 1


def test_scheduler_run_surfaces_spec_summary(fp_setup):
    from repro_torch.serve import Scheduler
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    eng = ServeEngine(m, params, n_slots=2, max_len=64, **CPU,
                      spec=SpecConfig(k=3, draft=draft))
    sched = Scheduler(eng)
    prompt = np.arange(5) % cfg.vocab_size
    for rid, budget in ((0, 12), (1, 3)):
        sched.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    out = sched.run()
    s = out.summary
    assert s["spec"] is True
    assert s["requests"] == 2 and s["completed"] == 2
    assert 0.0 <= s["accept_rate"] <= 1.0
    assert s["draft_kind"] == "self-int8" and s["spec_k"] == 3
    assert set(s["tokens_per_step_by_request"]) == {0, 1}
    # the long request rides speculative bursts: > 1 token per step
    assert s["tokens_per_step_by_request"][0] > 1.0
    assert s["tokens_per_step"] > 1.0
    assert s["tokens_generated"] == 15


def test_spec_draft_vocab_mismatch_fails_fast(fp_setup):
    """An independent draft with another vocabulary cannot feed the
    elementwise accept rule: refused when the engine is built."""
    cfg, m, params = fp_setup[:3]
    dm = build_model(dataclasses.replace(cfg, vocab_size=cfg.vocab_size // 2))
    draft = ModelDraft(model=dm, params=dm.init(1, **CPU))
    with pytest.raises(ValueError, match="vocab_size"):
        ServeEngine(m, params, n_slots=2, max_len=32,
                    spec=SpecConfig(k=2, draft=draft), **CPU)


def test_draft_share_counts_only_emitted_tokens(fp_setup):
    """Budget-cut bursts accept more proposals than they emit: draft_share
    counts the emitted ones (<= 1) while accept_rate keeps measuring the
    draft."""
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=2, max_len=64, **CPU,
                      spec=SpecConfig(k=3, draft=self_int8_draft(m, params)))
    # budget 2: one token at prefill, then a burst that emits exactly one
    reqs = [Request(rid=i, prompt=np.arange(5 + i) % cfg.vocab_size,
                    max_new_tokens=2) for i in range(4)]
    eng.serve(reqs)
    mm = eng.metrics()
    assert 0.0 <= mm["draft_share"] <= 1.0
    assert mm["emitted_draft_tokens"] <= mm["accepted_tokens"]
    assert mm["tokens_generated"] == 8


def test_independent_draft_kv_tracks_through_fill_fallback(fp_setup):
    """Plain fallback steps (paged prefix-hit slots teacher-forcing their
    prompt tail) must advance the independent draft's cache too.  The draft
    here *is* the target (same weights), so acceptance stays ~1 only if
    the tracking works."""
    cfg, m, params = fp_setup[:3]
    draft = ModelDraft(model=build_model(cfg), params=params)
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, cfg.vocab_size, size=16)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [sys_prompt, rng.integers(0, cfg.vocab_size, size=4 + 3 * i)]),
                    max_new_tokens=9) for i in range(3)]
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8, **CPU)
    plain = ServeEngine(m, params, **kw)
    spec = ServeEngine(m, params, spec=SpecConfig(k=3, draft=draft), **kw)
    mm = _assert_identical(plain, spec, reqs)
    assert mm["prefix_hits"] >= 1           # the fill path really ran
    assert mm["accept_rate"] > 0.9


def test_spec_paged_prefix_sharing_and_rollback(fp_setup):
    """Shared-prefix paged serving under speculation: prefix-hit slots fill
    through plain steps, bursts trim rejected-suffix pages without touching
    shared ones, and every slot's page refs are released at the end."""
    cfg, m, params = fp_setup[:3]
    draft = self_int8_draft(m, params)
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab_size, size=16)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [sys_prompt, rng.integers(0, cfg.vocab_size, size=3 + 5 * i)]),
                    max_new_tokens=6) for i in range(4)]
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8, **CPU)
    plain = ServeEngine(m, params, **kw)
    spec = ServeEngine(m, params, spec=SpecConfig(k=3, draft=draft), **kw)
    mm = _assert_identical(plain, spec, reqs)
    assert mm["prefix_hits"] >= 1
    pool = spec.pool
    assert all(pool.ref[p] in (0, 1) for p in range(1, pool.n_pages))
    assert pool.pages_in_use() == len(pool.index)


def test_sampled_spec_serve_emits_budget_within_vocab(fp_setup):
    """Sampling rows (temperature, top-k, top-p) run the general accept
    rule with draws from the engine's generator: every request gets its
    budget of in-vocabulary tokens."""
    cfg, m, params = fp_setup[:3]
    eng = ServeEngine(m, params, n_slots=2, max_len=64, rng_seed=3, **CPU,
                      spec=SpecConfig(k=3, draft=self_int8_draft(m, params)))
    reqs = [Request(rid=i, prompt=np.arange(4 + i) % cfg.vocab_size,
                    max_new_tokens=7, temperature=0.8, top_k=(0, 20)[i % 2],
                    top_p=(0.0, 0.9)[i // 2]) for i in range(4)]
    res = eng.serve(reqs)
    for r in reqs:
        assert len(res[r.rid]) == 7
        assert ((res[r.rid] >= 0) & (res[r.rid] < cfg.vocab_size)).all()
    assert eng.metrics()["spec_cycles"] > 0


# -- the spec half of the chunked-prefill matrix -----------------------------

def _chunk_requests(cfg, seed=0):
    # prompt lengths straddle the forced chunk (8): 5 (unchunked), and
    # 17/26/31 (chunked, crossing several bucket boundaries)
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=5)
            for i, n in enumerate([5, 17, 26, 31])]


@pytest.mark.parametrize("cache", ["f32", "kv8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_spec_serve_matches_generate(cache, paged, fp_setup,
                                             kv8_setup):
    cfg, m, params = fp_setup[:3] if cache == "f32" else kv8_setup
    kw = dict(n_slots=2, max_len=48, buckets=(8, 24), prefill_chunk=8, **CPU)
    if paged:
        kw.update(paged=True, page_size=8)
    eng = ServeEngine(m, params, spec=SpecConfig(
        k=2, draft=self_int8_draft(m, params)), **kw)
    assert eng.prefill_chunk == 8
    reqs = _chunk_requests(cfg)
    res = eng.serve(reqs)
    mm = eng.metrics()
    assert mm["chunked_admissions"] == 3
    assert mm["fill_steps"] >= (17 - 8) + (26 - 8) + (31 - 8)
    assert mm["completed"] == len(reqs) and mm["spec_cycles"] > 0
    ref = ServeEngine(m, params, n_slots=2, max_len=48, **CPU)
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid], ref.generate(Request(
            rid=100 + r.rid, prompt=r.prompt,
            max_new_tokens=r.max_new_tokens)))


# -- sampler and cache units -------------------------------------------------

def test_truncate_slot_rolls_back_len_only(fp_setup):
    m = fp_setup[1]
    cache = m.init_cache(2, 16, **CPU)
    cache = dict(cache, len=torch.tensor([9, 12], dtype=torch.int32),
                 k=torch.ones_like(cache["k"]))
    out = truncate_slot(cache, np.array([7, 12]))
    assert out["len"].tolist() == [7, 12]
    assert out["len"].dtype == torch.int32
    assert out["k"] is cache["k"] and bool((out["k"] == 1).all())
    assert cache["len"].tolist() == [9, 12]     # the input dict is kept


def test_policy_probs_greedy_is_onehot_and_matches_reference():
    logits = np.array([[0.1, 3.0, 1.0, -1e30],
                       [2.0, 0.5, 1.5, -1e30]], np.float32)
    p = policy_probs(torch.as_tensor(logits), torch.zeros(2))
    np.testing.assert_array_equal(p.numpy(), [[0, 1, 0, 0], [1, 0, 0, 0]])
    # sampling rows: a proper distribution over the unmasked support, equal
    # to repro's (top-k 2 on row 0, top-p 0.7 on row 1)
    temps = np.array([1.0, 0.7], np.float32)
    top_k = np.array([2, 0], np.int32)
    top_p = np.array([0.0, 0.7], np.float32)
    p = policy_probs(torch.as_tensor(logits), torch.as_tensor(temps),
                     torch.as_tensor(top_k), torch.as_tensor(top_p))
    want = j_policy_probs(jnp.asarray(logits), jnp.asarray(temps),
                          jnp.asarray(top_k), jnp.asarray(top_p))
    np.testing.assert_allclose(p.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(p.sum(-1).numpy(), [1.0, 1.0], rtol=1e-5)
    assert float(p[0, 0]) == 0.0 and float(p[0, 3]) == 0.0


def _target(v, *ids):
    """(1, K+1, V) logits with their argmax at ``ids``."""
    return torch.stack([torch.nn.functional.one_hot(torch.tensor(i), v)
                        .float() * 5.0 for i in ids])[None]


@pytest.mark.parametrize("draft_probs", [False, True],
                         ids=["greedy-batch", "explicit-probs"])
def test_spec_accept_greedy_semantics(draft_probs):
    """Greedy: leading proposals equal to the target argmax are kept, the
    first mismatch emits the target argmax, full acceptance emits the bonus
    argmax — by the greedy rule, and by the general rule on one-hot
    distributions (a greedy row in a batch that samples)."""
    v = 8
    onehot = lambda *ids: torch.nn.functional.one_hot(
        torch.tensor([ids]), v).float()
    gen = torch.Generator().manual_seed(0)
    temps = torch.zeros(1)
    if draft_probs:
        # a second, sampling row forces the general path; row 0 stays greedy
        temps = torch.tensor([0.0, 1.0])

    def accept(draft, target_ids):
        d = torch.tensor([draft], dtype=torch.int32)
        t = _target(v, *target_ids)
        q = onehot(*draft) if draft_probs else None
        if draft_probs:
            d, t, q = (torch.cat([x, x]) for x in (d, t, q))
        out, n = spec_accept(d, q, t, temps, None, None, gen)
        return out[0].tolist(), int(n[0])

    assert accept([3, 4], [3, 4, 6]) == ([3, 4, 6], 2)
    out, n = accept([3, 4], [5, 1, 2])
    assert n == 0 and out[0] == 5
    out, n = accept([3, 4], [3, 1, 2])
    assert n == 1 and out[:2] == [3, 1]


def test_spec_accept_leftover_distribution_statistics():
    """Sampled rows follow the leftover rule: q puts {0.5, 0.5} on tokens
    {0, 1}, p puts {0.25, 0.75} on tokens {1, 2}.  A draw of 0 always
    rejects (p(0) = 0) and resamples from norm(max(p - q, 0)) = one-hot(2);
    a draw of 1 is accepted with probability p(1)/q(1) = 0.5, else also
    resampled to 2."""
    q = torch.tensor([[0.5, 0.5, 0.0, 0.0]])[:, None]
    p_logits = torch.log(torch.tensor([[1e-9, 0.25, 0.75, 1e-9]]))[None]
    target = torch.cat([p_logits, p_logits], 1)
    gen = torch.Generator().manual_seed(0)
    seen = {0: [], 1: []}
    for _ in range(400):
        for d in (0, 1):
            out, n = spec_accept(torch.tensor([[d]], dtype=torch.int32), q,
                                 target, torch.ones(1), None, None, gen)
            seen[d].append((int(n[0]), int(out[0, 0])))
    assert set(seen[0]) == {(0, 2)}
    assert set(seen[1]) == {(1, 1), (0, 2)}
    accepted = sum(n for n, _ in seen[1]) / len(seen[1])
    assert abs(accepted - 0.5) < 0.1        # 400 draws: sd 0.025


# -- against repro ------------------------------------------------------------

def _jax_cache(c):
    """(B, KH, S, d) native -> repro ref's (B, S, KH, d)."""
    return jnp.asarray(np.ascontiguousarray(c.numpy().transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("variant", ["dense", "q8", "paged", "paged_q8"])
def test_verify_plain_versions_match_reference(variant):
    """The four plain verify versions against repro's on the same numpy
    inputs, with bursts that cross a page boundary and a window."""
    rng = np.random.default_rng(11)
    b, t, h, kh, s, hd, ps = 3, 4, 8, 2, 32, 16, 8
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, kh, s, hd)).astype(np.float32)
            for _ in range(2))
    base = np.array([0, 6, 27], np.int32)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    tb = torch.as_tensor(base)
    for window in (None, 5):
        if variant == "dense":
            got = tref.verify_attention_ref(tq, tk, tv, tb, window=window)
            want = jref.verify_attention_ref(jnp.asarray(q), _jax_cache(tk),
                                             _jax_cache(tv), jnp.asarray(base),
                                             window=window)
        elif variant == "q8":
            (kc, ks), (vc, vs) = (tref_q8(x) for x in (tk, tv))
            got = tref.verify_attention_q8_ref(tq, kc, ks, vc, vs, tb,
                                               window=window)
            want = jref.verify_attention_q8_ref(
                jnp.asarray(q), *(_jax_cache(x) for x in (kc, ks, vc, vs)),
                jnp.asarray(base), window=window)
        else:
            perm = rng.permutation(b * s // ps).reshape(b, -1) + 1
            table = torch.as_tensor(perm.astype(np.int32))
            leaves = ((tk, tv) if variant == "paged"
                      else (*tref_q8(tk), *tref_q8(tv)))
            stores = [_pages(x, ps, perm) for x in leaves]
            fn_t = (tref.paged_verify_attention_ref if variant == "paged"
                    else tref.paged_verify_attention_q8_ref)
            fn_j = (jref.paged_verify_attention_ref if variant == "paged"
                    else jref.paged_verify_attention_q8_ref)
            got = fn_t(tq, *stores, table, tb, window=window)
            want = fn_j(jnp.asarray(q), *(jnp.asarray(x.numpy())
                                          for x in stores),
                        jnp.asarray(table.numpy()), jnp.asarray(base),
                        window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def tref_q8(cache):
    """(B, KH, S, hd) f32 -> int8 codes and (B, KH, S, 1) scales."""
    from repro_torch.models.common import quantize_kv
    codes, scale = quantize_kv(cache.transpose(1, 2))
    return (codes.transpose(1, 2).contiguous(),
            scale.transpose(1, 2).contiguous())


def _pages(cache, ps, perm):
    """(B, KH, S, d) as a page store (1 + B*S/ps, KH, ps, d) behind
    ``perm``; page 0 is zero."""
    b, kh, s, d = cache.shape
    pages = cache.reshape(b, kh, s // ps, ps, d).permute(0, 2, 1, 3, 4) \
        .reshape(b * (s // ps), kh, ps, d)
    store = torch.zeros((1 + pages.shape[0], kh, ps, d), dtype=cache.dtype)
    store[torch.as_tensor(perm.reshape(-1))] = pages
    return store


def test_fake_mode_matches_reference(fp_setup):
    """quantize_model(mode="fake") at int8 FAQ against repro's on the same
    weights and statistics: the same dequantized leaves."""
    cfg, m, params, jm, jp = fp_setup
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)) \
        .astype(np.int32)
    js = j_run_calibration(jm.forward, jp, [{"tokens": jnp.asarray(tokens)}])
    ts = from_numpy_tree(_to_np(js), "cpu")
    spec = dict(bits=8, group_size=64)
    jq, _ = j_quantize_model(jp, jm.quant_site_map(), js, method="faq",
                             spec=JSpec(**spec), mode="fake")
    tq, _ = quantize_model(params, m.quant_site_map(), ts, method="faq",
                           spec=QuantSpec(**spec), mode="fake")
    for _, name in m.quant_site_map():
        got = tq["blocks"][name].numpy()
        want = np.asarray(jq["blocks"][name])
        assert got.shape == want.shape and got.dtype == want.dtype
        step = np.abs(want).max() / 127
        off = np.abs(got - want) > 1e-6
        assert off.mean() <= 1e-3, name
        assert np.abs(got - want).max() <= 1.01 * step, name
    assert tq["embed"] is params["embed"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_serve_matches_reference_engine(fp_setup, paged):
    """Greedy speculative serving with the self-int8 draft: the port's
    tokens, accepted proposals and cycle count equal repro's engine on the
    same weights and requests."""
    cfg, m, params, jm, jp = fp_setup
    kw = dict(n_slots=2, max_len=64, paged=paged, page_size=8)
    jeng = JServeEngine(jm, jp, spec=JSpecConfig(
        k=3, draft=j_self_int8_draft(jm, jp)), **kw)
    teng = ServeEngine(m, params, spec=SpecConfig(
        k=3, draft=self_int8_draft(m, params)), **kw, **CPU)
    reqs = _mixed_requests(cfg, 5, seed=9)
    jres = jeng.serve([JRequest(rid=r.rid, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens)
                       for r in reqs])
    tres = teng.serve(_clone(reqs))
    for r in reqs:
        np.testing.assert_array_equal(tres[r.rid], np.asarray(jres[r.rid]))
    jm_, tm_ = jeng.metrics(), teng.metrics()
    for key in ("spec_cycles", "accepted_tokens", "proposed_tokens",
                "emitted_draft_tokens", "tokens_generated", "decode_steps"):
        assert tm_[key] == jm_[key], key


def test_launch_serve_cli_spec_on_cpu(capsys):
    results = launch_serve.main(["--tiny", "--device", "cpu", "--requests",
                                 "2", "--new-tokens", "5", "--calib-n", "2",
                                 "--calib-len", "16", "--spec-k", "3"])
    assert sorted(results) == [0, 1]
    assert all(len(v) == 5 for v in results.values())
    assert "spec: k=3 draft=self-int8" in capsys.readouterr().out
