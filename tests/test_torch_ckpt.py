"""The port's engine-native checkpoints against the JAX package's, on the
CPU: the same leaves through ``strom.ckpt.save_checkpoint`` and
``strom_torch.ckpt.save_checkpoint`` give byte-equal ``data.bin`` files and
equal manifests, each package restores the other's checkpoint exactly, and
the commit's failure modes (CRC corruption, a failed save, a replacing
save, orphans) behave as the reference's. bf16 rides ``ml_dtypes`` on the
JAX side only and ``torch.bfloat16`` on the port's."""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from strom import ckpt as jckpt
from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.models import llama as jllama
from strom_torch import ckpt as tckpt
from strom_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.models import llama as tllama


@pytest.fixture(scope="module")
def ctxs():
    t = StromContext(StromConfig(engine="python", queue_depth=8,
                                 num_buffers=16))
    j = JContext(JConfig(engine="python", queue_depth=8, num_buffers=16,
                         slab_pool_bytes=64 << 20))
    yield t, j
    t.close()
    j.close()


def _leaves(seed=0):
    """(the port's tree, the JAX package's tree) of the same values:
    f32, int32, bf16, a 0-d, an empty, a non-contiguous leaf, a Python
    int and a float, nested dicts, a list and a tuple."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    idx = rng.integers(-1000, 1000, 777).astype(np.int32)
    b16 = rng.standard_normal((33, 5)).astype(np.float32)
    nc = rng.standard_normal((40, 24)).astype(np.float32)
    port = {
        "params": {"w": torch.from_numpy(w.copy()),
                   "b16": torch.from_numpy(b16).to(torch.bfloat16),
                   "nc": torch.from_numpy(nc.copy()).t()},
        "opt": [torch.from_numpy(idx.copy()), torch.tensor(2.5),
                (np.arange(11, dtype=np.int64), 0.125)],
        "empty": torch.zeros((0, 4)),
        "step": 42,
    }
    ref = {
        "params": {"w": w.copy(),
                   "b16": b16.astype(ml_dtypes.bfloat16),
                   "nc": nc.copy().T},
        "opt": [idx.copy(), np.array(2.5, dtype=np.float32),
                (np.arange(11, dtype=np.int64), 0.125)],
        "empty": np.zeros((0, 4), dtype=np.float32),
        "step": 42,
    }
    return port, ref


def _as_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _assert_equal(got, want):
    lg, tg = tree_flatten(got)
    lw, tw = tree_flatten(want)
    assert tg == tw
    for a, b in zip(lg, lw):
        a, b = _as_np(a), _as_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_flatten_order_is_jax_tree_util():
    port, ref = _leaves()
    jl, _ = jax.tree_util.tree_flatten(ref)
    tl, treedef = tree_flatten(port)
    assert len(jl) == len(tl) == 9
    for a, b in zip(tl, jl):
        assert np.shape(_as_np(a)) == np.shape(b)
    assert tree_unflatten(treedef, tl) is not port
    nested = {"b": None, "a": [1, (2, None)], "c": {"z": 3, "y": 4}}
    assert tree_flatten(nested)[0] == jax.tree_util.tree_flatten(nested)[0]
    assert tree_unflatten(tree_flatten(nested)[1],
                          tree_flatten(nested)[0]) == nested


def test_same_bytes_and_manifest_as_the_reference(ctxs, tmp_path):
    tctx, jctx = ctxs
    port, ref = _leaves()
    tm = tckpt.save_checkpoint(tctx, str(tmp_path / "t"), port)
    jm = jckpt.save_checkpoint(jctx, str(tmp_path / "j"), ref)
    assert tm == jm
    for name in ("data.bin", "manifest.json"):
        a = open(tmp_path / "t" / name, "rb").read()
        b = open(tmp_path / "j" / name, "rb").read()
        assert a == b, name
    assert {m["dtype"] for m in tm["leaves"]} == {
        "bfloat16", "float32", "float64", "int32", "int64"}


@pytest.mark.parametrize("verify", [False, True])
def test_each_package_restores_the_others(ctxs, tmp_path, verify):
    tctx, jctx = ctxs
    port, ref = _leaves(1)
    tckpt.save_checkpoint(tctx, str(tmp_path / "t"), port)
    jckpt.save_checkpoint(jctx, str(tmp_path / "j"), ref)
    got = tckpt.restore_checkpoint(tctx, str(tmp_path / "j"), port,
                                   verify=verify)
    _assert_equal(got, port)
    assert got["step"] == 42 and isinstance(got["step"], int)
    assert got["params"]["b16"].dtype == torch.bfloat16
    back = jckpt.restore_checkpoint(jctx, str(tmp_path / "t"), ref,
                                    verify=verify)
    # as the reference's own tests compare: values, with the dtypes JAX
    # gives its arrays (int64 leaves as int32 without x64)
    lb, tb = jax.tree_util.tree_flatten(back)
    lr, tr = jax.tree_util.tree_flatten(ref)
    assert tb == tr
    for a, b in zip(lb, lr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_numpy_and_scalar_templates_come_back_as_such(ctxs, tmp_path):
    tctx, _ = ctxs
    tree = {"a": np.arange(6, dtype=np.float64).reshape(2, 3), "n": 7,
            "f": 0.5}
    tckpt.save_checkpoint(tctx, str(tmp_path / "c"), tree)
    got = tckpt.restore_checkpoint(tctx, str(tmp_path / "c"), tree)
    assert isinstance(got["a"], np.ndarray) and got["n"] == 7
    assert got["f"] == 0.5
    np.testing.assert_array_equal(got["a"], tree["a"])


def test_leaf_spans_are_aligned_and_crcs_real(ctxs, tmp_path):
    tctx, _ = ctxs
    port, _ = _leaves(2)
    d = str(tmp_path / "c")
    w0 = tctx.stats()["context"]["host2ssd_bytes"]
    m = tckpt.save_checkpoint(tctx, d, port)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f) == m
    blob = open(os.path.join(d, "data.bin"), "rb").read()
    assert len(blob) == m["total_bytes"]
    for leaf in m["leaves"]:
        assert leaf["offset"] % tckpt.checkpoint.ALIGN == 0
        span = blob[leaf["offset"]: leaf["offset"] + leaf["nbytes"]]
        assert zlib.crc32(span) & 0xFFFFFFFF == leaf["crc32"]
    assert tctx.stats()["context"]["host2ssd_bytes"] - w0 \
        >= m["payload_bytes"]


def test_corrupt_data_raises(ctxs, tmp_path):
    tctx, _ = ctxs
    port, _ = _leaves(3)
    d = str(tmp_path / "c")
    m = tckpt.save_checkpoint(tctx, d, port)
    leaf = next(lf for lf in m["leaves"] if lf["nbytes"] > 16)
    data = os.path.join(d, "data.bin")
    with open(data, "r+b") as f:
        f.seek(leaf["offset"] + 10)
        b0 = f.read(1)
        f.seek(leaf["offset"] + 10)
        f.write(bytes([b0[0] ^ 0x01]))
    tctx.invalidate_file(data)
    with pytest.raises(tckpt.CkptCorruptError):
        tckpt.restore_checkpoint(tctx, d, port, verify=True)


def test_template_mismatch_and_not_a_checkpoint(ctxs, tmp_path):
    tctx, _ = ctxs
    port, _ = _leaves()
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(tctx, d, port)
    bad = dict(port, empty=torch.zeros((0, 5)))
    with pytest.raises(tckpt.CkptError, match="shape"):
        tckpt.restore_checkpoint(tctx, d, bad)
    bad = dict(port, empty=torch.zeros((0, 4), dtype=torch.float64))
    with pytest.raises(tckpt.CkptError, match="dtype"):
        tckpt.restore_checkpoint(tctx, d, bad)
    with pytest.raises(tckpt.CkptError, match="leaves"):
        tckpt.restore_checkpoint(tctx, d, dict(port, extra=1))
    (tmp_path / "nope").mkdir()
    with pytest.raises(tckpt.CkptError):
        tckpt.restore_checkpoint(tctx, str(tmp_path / "nope"), port)


def test_failed_save_leaves_the_old_checkpoint(ctxs, tmp_path, monkeypatch):
    tctx, _ = ctxs
    port, _ = _leaves(4)
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(tctx, d, port)

    def dying(chunks, src):
        raise OSError("writer died")

    monkeypatch.setattr(tctx, "write_chunks", dying)
    with pytest.raises(OSError, match="writer died"):
        tckpt.save_checkpoint(tctx, d, dict(port, step=99))
    monkeypatch.undo()
    assert not any(n.startswith("ckpt.tmp") for n in os.listdir(tmp_path))
    got = tckpt.restore_checkpoint(tctx, d, port, verify=True)
    _assert_equal(got, port)


def test_resave_replaces_atomically(ctxs, tmp_path):
    """A second save to the directory is a new inode: the restore reads
    the new state, through no stale registration or cached byte."""
    tctx, _ = ctxs
    port, _ = _leaves(5)
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(tctx, d, port)
    tckpt.restore_checkpoint(tctx, d, port)   # registers data.bin
    port2 = dict(port, step=43,
                 params=dict(port["params"], w=port["params"]["w"] + 1))
    tckpt.save_checkpoint(tctx, d, port2)
    got = tckpt.restore_checkpoint(tctx, d, port2)
    _assert_equal(got, port2)
    assert got["step"] == 43
    assert not any(".old-" in n or ".tmp-" in n for n in os.listdir(tmp_path))


def test_last_committed_and_clean_orphans(ctxs, tmp_path):
    tctx, _ = ctxs
    port, _ = _leaves(6)
    d = str(tmp_path / "ckpt")
    assert tckpt.last_committed(d) is None
    tckpt.save_checkpoint(tctx, d, port, extra={"k": 1})
    path, m = tckpt.last_committed(d)
    assert path == os.path.abspath(d) and m["extra"] == {"k": 1}
    # a kill between the two renames of a replacing commit
    os.rename(d, d + ".old-12345")
    os.makedirs(d + ".tmp-999")
    path, m = tckpt.last_committed(d)
    assert os.path.isdir(d) and m["extra"] == {"k": 1}
    os.makedirs(d + ".old-777")
    removed = tckpt.clean_orphans(d)
    assert sorted(os.path.basename(p) for p in removed) == [
        "ckpt.old-777", "ckpt.tmp-999"]
    _assert_equal(tckpt.restore_checkpoint(tctx, d, port), port)


def test_pickle_baseline_roundtrip(tmp_path):
    port, _ = _leaves(7)
    p = str(tmp_path / "s.pkl")
    assert tckpt.save_pickle(p, port) == os.path.getsize(p) > 0
    _assert_equal(tckpt.load_pickle(p), port)


def test_fields_single_sourced():
    assert tckpt.CKPT_FIELDS == jckpt.CKPT_FIELDS
    assert tckpt.CKPT_ASYNC_FIELDS == jckpt.CKPT_ASYNC_FIELDS
    assert tckpt.RESUME_FIELDS == jckpt.RESUME_FIELDS


def _jax_params(dtype: str, seed: int):
    jcfg = jllama.LlamaConfig(**{**jllama.LlamaConfig.tiny().__dict__,
                                 "dtype": dtype})
    return jcfg, jllama.init_params(jax.random.PRNGKey(seed), jcfg)


def _template(np_params) -> dict:
    def leaf(a):
        a = np.asarray(a)
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.from_numpy(np.zeros(0, a.dtype)).dtype
        return torch.zeros(a.shape, dtype=dt)
    return jax.tree_util.tree_map(leaf, np_params)


def test_jax_llama_params_restore_into_the_port(ctxs, tmp_path):
    """Llama params at LlamaConfig.tiny() (f32) saved by the JAX package,
    restored by the port and loaded through params_from_jax: the port's
    loss equals the JAX model's within test_torch_llama's 1e-5."""
    tctx, jctx = ctxs
    jcfg, jparams = _jax_params("float32", 1)
    d = str(tmp_path / "llama")
    jckpt.save_checkpoint(jctx, d, jparams)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    got = tckpt.restore_checkpoint(tctx, d, _template(np_params))
    model = tllama.Llama(tllama.LlamaConfig(**jcfg.__dict__), device="cpu")
    model.load_state_dict(tllama.params_from_jax(
        jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64),
                                               dtype=np.int32)
    want = float(jllama.next_token_loss(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        loss = float(tllama.next_token_loss(model, torch.from_numpy(tokens)))
    assert abs(loss - want) < 1e-5, (loss, want)


def test_jax_bf16_llama_params_restore_bit_exact(ctxs, tmp_path):
    tctx, jctx = ctxs
    _, jparams = _jax_params("bfloat16", 2)
    d = str(tmp_path / "llama16")
    jckpt.save_checkpoint(jctx, d, jparams)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    got = tckpt.restore_checkpoint(tctx, d, _template(np_params))
    want = tllama.params_from_jax(np_params)
    flat = dict(got)
    flat.update(flat.pop("layers"))
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and torch.equal(flat[k], v), k
