"""Paged KV cache in the port against the reference: the page pool and the
block hashes unit by unit, and the paged engine (prefix sharing, COW,
refcounts, capacity truncation, pressure with preemption, the int8 cache)
on a tiny llama3-8b whose weights cross from repro as numpy arrays.

Bars: hash bytes equal repro's; greedy tokens equal repro's paged engine
and the port's own dense ``generate`` exactly (float32 on the CPU); the
pool counters match repro's tests/test_pages.py expectations.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as j_quantize_model
from repro.core import run_calibration as j_run_calibration
from repro.models.registry import build_model as j_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import block_hashes as j_block_hashes
from repro_torch.bridge import from_numpy_tree
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pages import PagePool, PoolExhausted, block_hashes


# -- pool units --------------------------------------------------------------

def test_pool_alloc_free_refcount():
    pool = PagePool(5, 8)          # trash + 4 allocatable
    a = pool.alloc()
    b = pool.alloc()
    assert a != b and PagePool.TRASH not in (a, b)
    assert pool.pages_in_use() == 2
    pool.incref(a)
    pool.decref(a)
    assert pool.pages_in_use() == 2     # still one owner left
    pool.decref(a)
    assert pool.pages_in_use() == 1     # refcount 0 -> freed
    pool.alloc()
    assert pool.pages_in_use() == 2
    assert pool.in_use_peak == 2


def test_pool_exhaustion_and_eviction():
    pool = PagePool(3, 8)          # 2 allocatable pages
    a = pool.alloc()
    b = pool.alloc()
    with pytest.raises(PoolExhausted, match="exhausted"):
        pool.alloc()
    assert pool.try_alloc() is None
    # a page whose only owner is the prefix index is evictable
    pool.register(b"h", a)
    pool.decref(a)                 # slot retires; index keeps it alive
    assert pool.pages_in_use() == 2 and b"h" in pool.index
    assert pool.available() == 1
    c = pool.alloc()               # forces eviction of the index entry
    assert c == a and b"h" not in pool.index
    assert pool.evictions == 1
    pool.decref(b)
    pool.decref(c)


def test_pool_match_walks_prefix_chain():
    pool = PagePool(8, 4)
    toks = np.arange(12)
    hashes = block_hashes(toks, 4)
    assert len(hashes) == 3 and len(set(hashes)) == 3
    p0, p1 = pool.alloc(), pool.alloc()
    pool.register(hashes[0], p0)
    pool.register(hashes[1], p1)
    assert pool.match(hashes) == [p0, p1]   # third block unregistered
    assert pool.ref[p0] == 3 and pool.ref[p1] == 3  # slot+index+match
    other = block_hashes(np.concatenate([toks[:4], toks[:8]]), 4)
    assert other[0] == hashes[0] and other[1] != hashes[1]
    assert pool.lookup_blocks(other) == 1


@pytest.mark.parametrize("n,ps", [(7, 4), (3, 4), (8, 4), (40, 16)])
def test_block_hashes_full_blocks_only_and_equal_reference(n, ps):
    toks = np.random.default_rng(n).integers(0, 50000, n)
    got = block_hashes(toks, ps)
    assert len(got) == n // ps
    assert got == j_block_hashes(toks, ps)          # the same sha1 bytes
    assert got == block_hashes(list(toks), ps)      # deterministic


# -- engine integration ------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 32),
                                          0, cfg.vocab_size)}
    stats = j_run_calibration(jm.forward, jp, [batch])
    jq, _ = j_quantize_model(jp, jm.quant_site_map(), stats, method="faq",
                             spec=JSpec(bits=4, group_size=64),
                             mode="packed")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return dict(cfg=cfg, jm=jm, jq=jq, jp=jp, tm=build_model(cfg),
                tq=from_numpy_tree(to_np(jq), "cpu"),
                tp=from_numpy_tree(to_np(jp), "cpu"))


def _shared_prompts(cfg, n, prefix_len, seed, max_new=(1, 8)):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, cfg.vocab_size, size=prefix_len)
    return [(np.concatenate([sysp, rng.integers(
                0, cfg.vocab_size, size=int(rng.integers(3, 20)))])
             .astype(np.int32), int(rng.integers(*max_new)))
            for _ in range(n)]


def _serve(eng, prompts, req_cls):
    return eng.serve([req_cls(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(prompts)])


def test_paged_serve_matches_reference_and_generate(setup):
    cfg = setup["cfg"]
    prompts = _shared_prompts(cfg, 6, 16, seed=0)
    eng = ServeEngine(setup["tm"], setup["tq"], n_slots=3, max_len=64,
                      paged=True, page_size=8, device="cpu")
    assert eng.paged
    got = _serve(eng, prompts, Request)
    ref = _serve(JServeEngine(setup["jm"], setup["jq"], n_slots=3,
                              max_len=64, paged=True, page_size=8),
                 prompts, JRequest)
    for i, (p, m) in enumerate(prompts):
        np.testing.assert_array_equal(got[i], ref[i])
        np.testing.assert_array_equal(got[i], eng.generate(
            Request(rid=i, prompt=p, max_new_tokens=m)))
    mm = eng.metrics()
    assert mm["prefix_hits"] >= 1
    assert mm["pages_peak"] <= mm["pages_total"]


def test_paged_serve_kv8_matches_reference(setup):
    """The int8 cache pages its scales beside the codes; the port's paged
    kv8 engine gives repro's paged kv8 tokens and its own dense kv8
    engine's."""
    cfg = setup["cfg"].scaled(kv_cache_bits=8)
    tm, jm = build_model(cfg), j_build(cfg)
    prompts = _shared_prompts(cfg, 4, 16, seed=1)
    eng = ServeEngine(tm, setup["tp"], n_slots=2, max_len=48, paged=True,
                      page_size=8, device="cpu")
    assert eng._store["k"].dtype == torch.int8
    got = _serve(eng, prompts, Request)
    ref = _serve(JServeEngine(jm, setup["jp"], n_slots=2, max_len=48,
                              paged=True, page_size=8), prompts, JRequest)
    dense = _serve(ServeEngine(tm, setup["tp"], n_slots=2, max_len=48,
                               device="cpu"), prompts, Request)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], ref[i])
        np.testing.assert_array_equal(got[i], dense[i])
    assert eng.metrics()["prefix_hits"] >= 1


def test_prefix_sharing_refcounts_and_skipped_prefill(setup):
    cfg = setup["cfg"]
    ps = 8
    eng = ServeEngine(setup["tm"], setup["tq"], n_slots=2, max_len=64,
                      paged=True, page_size=ps, device="cpu")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, size=2 * ps)   # 2 full blocks
    pa = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=5)])
    pb = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=9)])
    hashes = block_hashes(prefix, ps)
    seen_refs = []

    def snapshot(rid, tok):
        # rid 1's first token lands after its fill completes, while rid 0
        # (bigger budget) is still resident in the other slot
        if rid == 1 and not seen_refs:
            seen_refs.append([int(eng.pool.ref[eng.pool.index[h]])
                              for h in hashes])

    ra = Request(rid=0, prompt=pa, max_new_tokens=15, on_token=snapshot)
    rb = Request(rid=1, prompt=pb, max_new_tokens=6, on_token=snapshot)
    res = eng.serve([ra, rb])
    mm = eng.metrics()
    assert mm["prefix_hits"] == 1
    assert mm["prefix_hit_tokens"] == 2 * ps
    # while both slots were resident each shared page had 3 owners: the
    # prefix index plus both slots
    assert seen_refs == [[3, 3]]
    for h in hashes:                      # after retirement: the index only
        assert int(eng.pool.ref[eng.pool.index[h]]) == 1
    for r in (ra, rb):
        np.testing.assert_array_equal(res[r.rid], eng.generate(
            Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens)))


def test_cow_on_fully_cached_prompt(setup):
    cfg = setup["cfg"]
    eng = ServeEngine(setup["tm"], setup["tq"], n_slots=2, max_len=32,
                      paged=True, page_size=8, device="cpu")
    prompt = (np.arange(16) % cfg.vocab_size).astype(np.int32)  # 2 pages
    r1 = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    r2 = eng.serve([Request(rid=1, prompt=prompt, max_new_tokens=3)])
    mm = eng.metrics()
    assert mm["cow_copies"] == 1
    assert mm["prefix_hit_tokens"] == 15          # n - 1 of 16
    np.testing.assert_array_equal(r1[0], r2[1])
    np.testing.assert_array_equal(r2[1], eng.generate(
        Request(rid=9, prompt=prompt, max_new_tokens=3)))


def test_paged_peak_memory_below_dense(setup):
    cfg = setup["cfg"]
    max_len, n_slots = 128, 4
    eng = ServeEngine(setup["tm"], setup["tq"], n_slots=n_slots,
                      max_len=max_len, paged=True, page_size=16,
                      device="cpu")
    _serve(eng, _shared_prompts(cfg, 16, 32, seed=5, max_new=(4, 12)),
           Request)
    dense = setup["tm"].init_cache(n_slots, max_len, device="cpu")
    dense_bytes = sum(t.numel() * t.element_size() for t in dense.values())
    mm = eng.metrics()
    assert mm["peak_cache_bytes"] < dense_bytes
    assert mm["prefix_hits"] >= 10


def test_paged_capacity_truncation(setup):
    cfg = setup["cfg"]
    max_len = 24
    eng = ServeEngine(setup["tm"], setup["tq"], n_slots=2, max_len=max_len,
                      buckets=(8, 24), paged=True, page_size=8, device="cpu")
    prompt = (np.arange(8) % cfg.vocab_size).astype(np.int32)
    res = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=2),
                     Request(rid=1, prompt=prompt, max_new_tokens=100)])
    assert res[0].shape == (2,)
    assert res[1].shape == (1 + max_len - len(prompt),)
    assert eng.metrics()["truncated"] == 1
    big = ServeEngine(setup["tm"], setup["tq"], n_slots=2, max_len=64,
                      device="cpu")
    ref = big.generate(Request(rid=9, prompt=prompt, max_new_tokens=100))
    np.testing.assert_array_equal(res[1], ref[:len(res[1])])
    # all transient pages returned; only index-registered blocks persist
    assert eng.pool.pages_in_use() == len(eng.pool.index)


def test_pool_pressure_preempts_resumes_and_matches_reference(setup):
    """A pool too small for the batch's growth: steps that cannot get a
    page preempt a slot, which resumes later through its registered
    blocks.  Tokens and the preemption schedule equal repro's engine with
    the same n_pages."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 20)
               for n in (10, 14, 6, 12)]
    kw = dict(n_slots=3, max_len=48, paged=True, page_size=8, n_pages=8)
    eng = ServeEngine(setup["tm"], setup["tq"], device="cpu", **kw)
    got = _serve(eng, prompts, Request)
    jeng = JServeEngine(setup["jm"], setup["jq"], **kw)
    ref = _serve(jeng, prompts, JRequest)
    mm, jmm = eng.metrics(), jeng.metrics()
    assert mm["pressure_events"] > 0 and mm["preempted"] > 0
    assert mm["resumed"] == mm["preempted"] and mm["completed"] == 4
    for key in ("preempted", "resumed", "pressure_events", "prefix_hits"):
        assert mm[key] == jmm[key], key
    dense = ServeEngine(setup["tm"], setup["tq"], n_slots=3, max_len=48,
                        device="cpu")
    for i, (p, m) in enumerate(prompts):
        np.testing.assert_array_equal(got[i], ref[i])
        np.testing.assert_array_equal(got[i], dense.generate(
            Request(rid=i, prompt=p, max_new_tokens=m)))
    assert eng.pool.pages_in_use() == len(eng.pool.index)


def test_prompt_larger_than_the_pool_is_refused(setup):
    """A prompt that needs more pages than the whole pool never binds: once
    no slot is active it is shed with an empty sequence, and the rest of
    the batch is served.  One that is admitted through a prefix hit and
    then outgrows the pool is truncated.  Outcomes, tokens and counters
    equal the reference engine's."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(7)
    prompts = [(np.arange(9, dtype=np.int32), 2),
               (rng.integers(0, cfg.vocab_size, 20).astype(np.int32), 2),
               (np.arange(20, dtype=np.int32), 2),   # hits rid 0's block
               (np.arange(5, dtype=np.int32), 3)]
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8, n_pages=3)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(prompts)]
    eng = ServeEngine(setup["tm"], setup["tq"], device="cpu", **kw)
    jeng = JServeEngine(setup["jm"], setup["jq"], **kw)
    got, ref = eng.serve(reqs), jeng.serve(jreqs)
    assert [r.outcome for r in reqs] == [r.outcome for r in jreqs] == [
        "completed", "shed", "truncated", "completed"]
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], ref[i])
    assert got[1].shape == got[2].shape == (0,)
    mm, jmm = eng.metrics(), jeng.metrics()
    for key in ("shed", "completed", "truncated", "preempted", "resumed",
                "pressure_events", "prefix_hits", "decode_steps"):
        assert mm[key] == jmm[key], key
    assert eng.pool.pages_in_use() == len(eng.pool.index)


# -- the pressure schedule of chip_smoke.py ----------------------------------

SMOKE_PROMPT_LENS = (12, 40, 100, 200, 300, 450, 600, 700)  # chip_smoke.py's
SCHEDULE = ("preempted", "resumed", "pressure_events", "prefix_hits",
            "decode_steps", "pages_peak")


class _Stuck(Exception):
    pass


def _capped_serve(eng, reqs, cap):
    """Serve with at most ``cap`` decode steps.  Returns the results (None
    when the cap is reached: how a preemption livelock shows, two requests
    whose growth cannot share the pool preempting each other forever) and
    the schedule's counters."""
    step, n = eng._plain_step, [0]

    def capped(run):
        if n[0] >= cap:
            raise _Stuck
        n[0] += 1
        step(run)

    eng._plain_step = capped
    try:
        res = eng.serve(reqs)
    except _Stuck:
        res = None
    m = eng.metrics()
    return res, {k: m[k] for k in SCHEDULE}


def _smoke_pool(setup, n_pages, cap):
    """chip_smoke.py's eight requests (32 new tokens each, 4 slots,
    max_len 1024, pages of 16) on the tiny model in the port and in the
    reference engine, each capped at ``cap`` decode steps."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32)
               for n in SMOKE_PROMPT_LENS]
    kw = dict(n_slots=4, max_len=1024, paged=True, page_size=16,
              n_pages=n_pages)
    got = _capped_serve(
        ServeEngine(setup["tm"], setup["tq"], device="cpu", **kw),
        [Request(rid=i, prompt=p, max_new_tokens=32)
         for i, p in enumerate(prompts)], cap)
    ref = _capped_serve(
        JServeEngine(setup["jm"], setup["jq"], **kw),
        [JRequest(rid=i, prompt=p, max_new_tokens=32)
         for i, p in enumerate(prompts)], cap)
    return got, ref


def test_pool_scan_reproduces_the_smoke_pressure_schedule(setup):
    """chip_smoke.py's 115-page pressure run: the port preempts, resumes
    and hits the prefix index exactly as the reference engine does on the
    same requests.  The schedule depends only on the lengths, so these are
    also the counters the full-width run on the card is held to."""
    (got, mm), (ref, jmm) = _smoke_pool(setup, 115, cap=3000)
    assert mm == jmm
    assert mm == {"preempted": 11, "resumed": 11, "pressure_events": 11,
                  "prefix_hits": 10, "decode_steps": 281, "pages_peak": 114}
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])


def test_smoke_requests_livelock_at_80_pages_in_both_engines(setup):
    """At 80 pages the reference's preemption protocol livelocks on the
    smoke's requests, and the port, which keeps that protocol, does too:
    within three times the 115-page run's steps neither finishes, and
    both have preempted tens of times more often than at 115 pages."""
    (got, mm), (ref, jmm) = _smoke_pool(setup, 80, cap=850)
    assert got is None and ref is None
    assert mm["preempted"] > 200 and jmm["preempted"] > 200
