"""The port's checkpoints (``repro_torch.dist.checkpoint``) on the CPU:
the reference's checkpoint tests (``tests/test_checkpoint.py``) on the
port, the on-disk interchange with ``repro.dist.checkpoint`` in both
directions, bit for bit (bf16 and f32 params, the int32 step, the AdamW
NamedTuple, packed QuantizedTensors with and without act_scale), and the
reclaiming of a crashed writer's tmp.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.quantizer import QuantSpec as RSpec
from repro.core.quantizer import quantize_groupwise as r_quantize
from repro.dist import checkpoint as r_ckpt
from repro.train.optimizer import AdamW as RAdamW
from repro_torch.core.quantizer import QuantSpec, quantize_groupwise
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist._tree import leaves_with_keys
from repro_torch.train.optimizer import AdamW


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: these tests run small torch ops in
    loops, and under pytest-xdist several workers each spinning a full
    thread pool on the same cores made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "blocks": {"x": torch.ones((2, 2),
                                                  dtype=torch.bfloat16)}},
            "step": torch.tensor(7, dtype=torch.int32),
            "opt": AdamW().init({"w": torch.zeros((3, 4))})}


def test_roundtrip(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007"
    restored = ckpt.restore(str(tmp_path), 7, tree)
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["opt"].step.dtype == tree["opt"].step.dtype
    assert type(restored["opt"]) is type(tree["opt"])
    assert torch.equal(restored["params"]["blocks"]["x"],
                       tree["params"]["blocks"]["x"])


def test_no_tmp_left_behind(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_latest_and_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_async_save(tmp_path):
    tree = _tree()
    ckpt.save_async(str(tmp_path), 9, tree)
    tree["step"].fill_(8)            # the snapshot was taken before return
    ckpt.wait_pending()
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert int(ckpt.restore(str(tmp_path), 9, _tree())["step"]) == 7


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 1, _tree())


def test_async_failure_reraised_and_no_half_step(tmp_path):
    def hook():
        raise OSError("injected")
    ckpt.save_async(str(tmp_path), 3, _tree(), fault_hook=hook)
    with pytest.raises(OSError, match="injected"):
        ckpt.wait_pending()
    assert ckpt.latest_step(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


# -- interchange with repro -------------------------------------------------

def _numpy_trees(seed=0):
    """The same values as (repro tree, port tree): bf16 and f32 params, an
    int32 step, AdamW state, packed QuantizedTensors with and without
    act_scale."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(128, 16)).astype(np.float32)
    emb = rng.normal(size=(8, 4)).astype(ml_dtypes.bfloat16)
    act = (rng.random(128) + 0.5).astype(np.float32)
    spec_r, spec_t = RSpec(bits=4, group_size=64), QuantSpec(bits=4,
                                                             group_size=64)
    r = {"params": {"w": jnp.asarray(w), "embed": jnp.asarray(emb)},
         "step": jnp.asarray(11, jnp.int32),
         "opt": RAdamW().init({"w": jnp.asarray(w)})._replace(
             step=jnp.asarray(5, jnp.int32),
             m={"w": jnp.asarray(w * 0.5)}, v={"w": jnp.asarray(w * w)}),
         "qparams": {"a": r_quantize(jnp.asarray(w), spec_r,
                                     act_scale=jnp.asarray(act), pack=True),
                     "b": r_quantize(jnp.asarray(w), spec_r, pack=True)}}
    t = {"params": {"w": torch.as_tensor(w),
                    "embed": torch.as_tensor(emb.view(np.int16))
                    .view(torch.bfloat16)},
         "step": torch.tensor(11, dtype=torch.int32),
         "opt": AdamW().init({"w": torch.as_tensor(w)})._replace(
             step=torch.tensor(5, dtype=torch.int32),
             m={"w": torch.as_tensor(w * 0.5)},
             v={"w": torch.as_tensor(w * w)}),
         "qparams": {"a": quantize_groupwise(torch.as_tensor(w), spec_t,
                                             act_scale=torch.as_tensor(act),
                                             pack=True),
                     "b": quantize_groupwise(torch.as_tensor(w), spec_t,
                                             pack=True)}}
    return r, t


def _as_bits(x) -> np.ndarray:
    """A leaf's bytes as an unsigned-int array of its width (bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype != np.bool_ else x


def test_keys_are_repro_keystr():
    r, t = _numpy_trees()
    r_keys = [jax.tree_util.keystr(k)
              for k, _ in jax.tree_util.tree_flatten_with_path(r)[0]]
    assert [k for k, _ in leaves_with_keys(t)] == r_keys
    assert "['opt'].m['w']" in r_keys
    assert "['qparams']['a'][<flat index 3>]" in r_keys
    assert "['qparams']['b'][<flat index 3>]" not in r_keys


def _same_bits(t_tree, r_tree):
    r_leaves = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(r_tree)[0]}
    mine = leaves_with_keys(t_tree)
    assert len(mine) == len(r_leaves)
    for key, leaf in mine:
        want = r_leaves[key]
        assert str(want.dtype) == ckpt._DTYPES[leaf.dtype], key
        assert tuple(leaf.shape) == want.shape, key
        assert np.array_equal(_as_bits(leaf), _as_bits(want)), key


def test_repro_writes_port_restores_bit_for_bit(tmp_path):
    r, t = _numpy_trees(1)
    r_ckpt.save(str(tmp_path), 4, r)
    assert ckpt.latest_step(str(tmp_path)) == 4
    restored = ckpt.restore(str(tmp_path), 4, _numpy_trees(2)[1],
                            device="cpu")
    _same_bits(restored, r)
    assert restored["qparams"]["b"].act_scale is None
    assert restored["qparams"]["a"].spec == t["qparams"]["a"].spec


def test_port_writes_repro_restores_bit_for_bit(tmp_path):
    r, t = _numpy_trees(3)
    ckpt.save(str(tmp_path), 6, t)
    assert r_ckpt.latest_step(str(tmp_path)) == 6
    restored = r_ckpt.restore(str(tmp_path), 6, _numpy_trees(4)[0])
    _same_bits(t, restored)
    assert restored["opt"].step.dtype == jnp.int32
    with open(tmp_path / "step_00000006" / "manifest.json") as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes["['params']['embed']"] == "bfloat16"


def test_data_bin_is_byte_identical_to_repro(tmp_path):
    r, t = _numpy_trees(5)
    r_ckpt.save(str(tmp_path / "r"), 1, r)
    ckpt.save(str(tmp_path / "t"), 1, t)
    for name in ("data.bin", "manifest.json"):
        assert (tmp_path / "r" / "step_00000001" / name).read_bytes() == \
            (tmp_path / "t" / "step_00000001" / name).read_bytes(), name


def test_stale_tmp_of_a_dead_writer_is_reclaimed(tmp_path):
    """A crashed writer's tmp (this host, a pid that no longer runs) is
    swept by the next save; one holding a complete step with no final dir
    is recovered by latest_step."""
    proc = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    dead = int(proc.stdout)
    stale = tmp_path / f"step_00000002.{ckpt._HOST}-{dead}-0.tmp"
    stale.mkdir()
    (stale / "data.bin").write_bytes(b"partial")
    ckpt.save(str(tmp_path), 3, _tree())
    assert not stale.exists()
    # a complete retired copy of step 3 whose promotion crashed
    ckpt.save(str(tmp_path), 4, _tree())
    os.replace(tmp_path / "step_00000004",
               tmp_path / f"step_00000004.{ckpt._HOST}-{dead}-1.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert (tmp_path / "step_00000004" / "manifest.json").is_file()
    # another host's tmp is never touched
    other = tmp_path / f"step_00000005.otherhost_0123abcd-{dead}-0.tmp"
    other.mkdir()
    ckpt.save(str(tmp_path), 6, _tree())
    assert other.exists()
