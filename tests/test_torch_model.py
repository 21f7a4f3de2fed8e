"""DenseLM in the port against repro's DenseLM on the same weights.

The JAX tiny llama3-8b (4 layers, d_model 128, head_dim 32, f32) is
initialized once; its parameters cross to the port through
``repro_torch.bridge`` as numpy arrays — float, and FAQ-packed int4.
Tolerance: atol = rtol = 1e-4 for whole-model logits, site statistics and
KV caches (XLA and PyTorch sum in different orders over 4 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as j_quantize_model
from repro.core import run_calibration as j_run_calibration
from repro.models.registry import build_model as j_build
from repro_torch.bridge import from_numpy_tree
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.models.registry import build_model as t_build

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def models():
    cfg = ARCHS["llama3-8b"].tiny()
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 32)),
                                   jnp.int32)}
    stats = j_run_calibration(jm.forward, jp, [batch])
    jq, _ = j_quantize_model(jp, jm.quant_site_map(), stats, method="faq",
                             spec=JSpec(bits=4, group_size=64),
                             mode="packed")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return {
        "cfg": cfg, "jm": jm, "tm": t_build(cfg),
        "float": (jp, from_numpy_tree(to_np(jp), "cpu")),
        "packed": (jq, from_numpy_tree(to_np(jq), "cpu")),
    }


def test_bridge_keeps_structure_and_values(models):
    jq, tq = models["packed"]
    assert isinstance(tq["blocks"]["wq"], QuantizedTensor)
    j_leaf, t_leaf = jq["blocks"]["w_down"], tq["blocks"]["w_down"]
    np.testing.assert_array_equal(_np(t_leaf.codes), np.asarray(j_leaf.codes))
    assert t_leaf.codes.shape[0] == models["cfg"].n_layers   # (L, ...) kept
    assert t_leaf.n_in == j_leaf.n_in and t_leaf.packed
    assert t_leaf.spec.group_size == 64 and t_leaf.act_scale is not None
    jp, tp = models["float"]
    np.testing.assert_array_equal(_np(tp["embed"]), np.asarray(jp["embed"]))


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_and_stats_match(models, kind):
    jp, tp = models[kind]
    cfg = models["cfg"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)) \
        .astype(np.int32)
    jl, jaux = models["jm"].forward(jp, {"tokens": jnp.asarray(toks)},
                                    collect_stats=True)
    tl, taux = models["tm"].forward(tp, {"tokens": torch.as_tensor(toks)},
                                    collect_stats=True)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert set(taux["stats"]) == set(jaux["stats"])
    for site, st in jaux["stats"].items():
        for key, ref in st.items():
            got = taux["stats"][site][key]
            assert got.shape == ref.shape, (site, key)
            np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_and_decode_step_match(models, kind):
    jp, tp = models[kind]
    cfg, jm, tm = models["cfg"], models["jm"], models["tm"]
    rng = np.random.default_rng(2)
    b, t, s = 3, 16, 32
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    plen = np.array([16, 5, 11], np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, s),
                        prompt_len=jnp.asarray(plen))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, s, device="cpu"),
                        prompt_len=torch.as_tensor(plen))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(_np(tc["len"]), np.asarray(jc["len"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL)
    # two decode steps continue each row from its own length
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(_np(tc["len"]), np.asarray(jc["len"]))
        nxt = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL)


def test_full_length_prefill_matches(models):
    jp, tp = models["float"]
    cfg, jm, tm = models["cfg"], models["jm"], models["tm"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9)) \
        .astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(1, 16))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(1, 16, device="cpu"))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert int(tc["len"][0]) == 9


def test_unported_model_options_raise(models):
    """Sliding-window attention is ported with the hybrid family: a dense
    config with a window of 16 gives repro's logits at T 24 (the window
    mask) and T 40 (block-local), and its decode step attends the window.
    Every family builds, the ssm and audio ones included: each config of
    repro.configs gives the reference's model class and site map; an
    unknown family raises."""
    cfg = models["cfg"].scaled(sliding_window=16)
    jm, tm = j_build(cfg), t_build(cfg)
    jp, tp = models["float"]
    rng = np.random.default_rng(7)
    for t in (24, 40):
        toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
        jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
        tl, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 48))
    _, tc = tm.prefill(tp, torch.as_tensor(toks),
                       tm.init_cache(2, 48, device="cpu"))
    nxt = toks[:, :1]
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt))
    tl, _ = tm.decode_step(tp, tc, torch.as_tensor(nxt))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name, arch in sorted(ARCHS.items()):
        jm, tm = j_build(arch.tiny()), t_build(arch.tiny())
        assert type(tm).__name__ == type(jm).__name__, name
        assert tm.quant_site_map() == jm.quant_site_map(), name
    with pytest.raises(ValueError, match="unknown family"):
        t_build(models["cfg"].scaled(family="rnn"))


@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_multi_token_decode_step_matches(models, kind, kv_bits):
    """decode_step at T = 4 (the speculative verify burst) against repro's
    from the same prefilled cache: logits (B, 4, V), the written span and
    ``len`` advanced by 4; then verify_step_paged gives the same logits
    through a page table whose burst crosses a page boundary."""
    jp, tp = models[kind]
    cfg = models["cfg"].scaled(kv_cache_bits=kv_bits)
    jm, tm = j_build(cfg), t_build(cfg)
    rng = np.random.default_rng(6)
    b, t, s = 3, 12, 32
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    plen = np.array([12, 6, 9], np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, s),
                       prompt_len=jnp.asarray(plen))
    tc = {k: torch.as_tensor(np.array(v)) for k, v in jc.items()}
    burst = rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32)
    jl, jc2 = jm.decode_step(jp, jc, jnp.asarray(burst))
    tl, tc2 = tm.decode_step(tp, dict(tc), torch.as_tensor(burst))
    assert tl.shape == (b, 4, tl.shape[-1])
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(_np(tc2["len"]), plen + 4)
    keys = ("k", "v") if kv_bits == 16 else ("k_scale", "v_scale")
    for key in keys:
        np.testing.assert_allclose(_np(tc2[key]), np.asarray(jc2[key]), **TOL)
    # the same burst through pages of 8 positions (slot 1's span 6..9
    # crosses into its second page)
    ps, n_pages = 8, s // 8
    table = (1 + np.arange(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    store = tm.init_paged_cache(1 + b * n_pages, ps, device="cpu")
    for key, leaf in store.items():
        dense = torch.as_tensor(np.array(jc[key]))      # (L, B, KH, S, d)
        n_l, _, kh, _, d = dense.shape
        leaf[:, 1:] = dense.reshape(n_l, b, kh, n_pages, ps, d) \
            .permute(0, 1, 3, 2, 4, 5).reshape(n_l, b * n_pages, kh, ps, d)
    pl, _ = tm.verify_step_paged(tp, store, torch.as_tensor(burst),
                                 torch.as_tensor(table),
                                 torch.as_tensor(plen))
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_kv8_prefill_and_decode_step_match(models, kind):
    """The int8 KV cache: prefill writes codes and scales, decode folds the
    scales in the q8 attention.  XLA and PyTorch produce K/V that differ in
    the last bits, so a code at a rounding tie may land one step apart:
    prefill codes must agree except for such +-1 flips (under 0.5%), and
    the decode steps run from repro's prefill cache on both sides."""
    jp, tp = models[kind]
    cfg = models["cfg"].scaled(kv_cache_bits=8)
    jm, tm = j_build(cfg), t_build(cfg)
    rng = np.random.default_rng(4)
    b, t, s = 3, 16, 32
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    plen = jnp.asarray(np.array([16, 5, 11], np.int32))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, s),
                        prompt_len=plen)
    tl, tc = tm.prefill(tp, torch.as_tensor(toks),
                        tm.init_cache(b, s, device="cpu"),
                        prompt_len=torch.as_tensor(np.array(plen)))
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].shape[-1] == 1
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        diff = np.abs(_np(tc[key]).astype(int) - np.asarray(jc[key]))
        assert diff.max() <= 1 and (diff > 0).mean() < 5e-3, key
        np.testing.assert_allclose(_np(tc[key + "_scale"]),
                                   np.asarray(jc[key + "_scale"]), **TOL)
    tc = {k: torch.as_tensor(np.array(v)) for k, v in jc.items()}
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(_np(tc["len"]), np.asarray(jc["len"]))
        nxt = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]


def _page_table(b, n_logical, seed):
    """A shuffled (B, NP) table over physical pages 1..B*NP (page 0 is the
    trash page)."""
    perm = np.random.default_rng(seed).permutation(b * n_logical) + 1
    return perm.reshape(b, n_logical).astype(np.int32)


@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("bits", [16, 8])
def test_decode_step_paged_matches(models, kind, bits):
    """decode_step_paged against repro's on the same page store: the dense
    prefill cache cut into shuffled pages, then decode steps writing and
    reading through the table (page size 8)."""
    jp, tp = models[kind]
    cfg = models["cfg"].scaled(kv_cache_bits=bits)
    jm, tm = j_build(cfg), t_build(cfg)
    rng = np.random.default_rng(5)
    b, t, ps, n_logical = 2, 12, 8, 4
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    plen = np.array([12, 7], np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, ps *
                                                            n_logical),
                       prompt_len=jnp.asarray(plen))
    table = _page_table(b, n_logical, seed=bits)
    n_pages = 1 + b * n_logical
    keys = ("k", "k_scale", "v", "v_scale") if bits == 8 else ("k", "v")
    store = {}
    for key in keys:
        dense = np.asarray(jc[key])                  # (L, B, KH, S, d)
        n_l, _, kh, _, d = dense.shape
        pages = dense.reshape(n_l, b, kh, n_logical, ps, d) \
            .transpose(0, 1, 3, 2, 4, 5).reshape(n_l, b * n_logical, kh,
                                                 ps, d)
        st = np.zeros((n_l, n_pages, kh, ps, d), dense.dtype)
        st[:, table.reshape(-1)] = pages
        store[key] = st
    jstore = {k: jnp.asarray(v) for k, v in store.items()}
    tstore = {k: torch.as_tensor(v.copy()) for k, v in store.items()}
    lens = plen.copy()
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jstore = jm.decode_step_paged(jp, jstore, jnp.asarray(nxt),
                                          jnp.asarray(table),
                                          jnp.asarray(lens))
        tl, tstore = tm.decode_step_paged(tp, tstore, torch.as_tensor(nxt),
                                          torch.as_tensor(table),
                                          torch.as_tensor(lens))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        lens = lens + 1
        nxt = np.array(np.asarray(jl)[:, 0].argmax(-1), np.int32)[:, None]
    for key in keys:
        np.testing.assert_allclose(_np(tstore[key]).astype(np.float32),
                                   np.asarray(jstore[key]).astype(np.float32),
                                   atol=1.0 if key in ("k", "v") and bits == 8
                                   else 1e-4, rtol=1e-4)
