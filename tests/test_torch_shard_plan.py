"""Sharded read planning through both packages (the reference's
``tests/test_shard_plan.py`` cases) on the conftest's 8 CPU devices.

JAX plans every device its process addresses; the port plans one rank's
card, so its side is run once per mesh position (the rank patched), and
the plans of all positions are held against JAX's, device id for rank.
``TorchSharding``'s index maps, shard shapes and errors equal
``NamedSharding``'s for every mesh and spec listed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from strom.delivery import shard as jshard
from strom.models import llama as jllama
from strom.parallel import sharding as jsharding
from strom_torch.delivery import shard as tshard
from strom_torch.models import llama as tllama
from strom_torch.parallel import sharding as tsharding
from strom_torch.parallel.mesh import make_mesh
from strom_torch.parallel.sharding import P, TorchSharding


def _pair(sizes, names, spec):
    """(NamedSharding, TorchSharding) of *spec* over the first prod(sizes)
    devices, device i ≙ rank i."""
    n = int(np.prod(sizes))
    jm = Mesh(np.array(jax.devices()[:n]).reshape(sizes), names)
    tm = make_mesh(dict(zip(names, sizes)), devices=list(range(n)))
    return NamedSharding(jm, JP(*spec)), TorchSharding(tm, P(*spec))


def _bounds(index, shape):
    return tuple(sl.indices(dim)[:2] for sl, dim in zip(index, shape))


def _port_plans(ts, shape, dtype, monkeypatch):
    """{rank: DevicePlan} of the port's planner at every mesh position."""
    out = {}
    for r in range(ts.mesh.size):
        monkeypatch.setattr(tsharding, "_rank", lambda r=r: r)
        (plan,) = tshard.plan_sharded_read(shape, dtype, ts)
        out[r] = plan
    return out


def _plans_equal(jplans, tplans):
    assert len(jplans) == len(tplans)
    for jp in jplans:
        tp = tplans[jp.device.id]
        assert tp.local_shape == jp.local_shape
        assert tp.nbytes == jp.nbytes
        assert [dataclasses.astuple(s) for s in tp.segments] == \
            [dataclasses.astuple(s) for s in jp.segments]


def segments_equal_numpy(mod, shape, dtype, index):
    """Golden check: reading the planned segments out of the raw bytes must
    equal numpy's fancy-indexed sub-block."""
    arr = np.arange(np.prod(shape), dtype=dtype).reshape(shape)
    raw = arr.tobytes()
    segs = list(mod.contiguous_segments(shape, np.dtype(dtype).itemsize,
                                        index))
    sub = arr[index]
    out = bytearray(sub.nbytes)
    for s in segs:
        out[s.dest_offset:s.dest_offset + s.length] = \
            raw[s.file_offset:s.file_offset + s.length]
    np.testing.assert_array_equal(
        np.frombuffer(bytes(out), dtype=dtype).reshape(sub.shape), sub)
    return [dataclasses.astuple(s) for s in segs]


@pytest.mark.parametrize("shape,index,max_segs", [
    ((8, 4), (slice(0, 4), slice(None)), 1),
    ((8, 4), (slice(2, 6), slice(None)), 1),
    ((8, 4), (slice(None), slice(0, 2)), 8),
    ((4, 4, 4), (slice(1, 3), slice(None), slice(None)), 1),
    ((4, 4, 4), (slice(None), slice(1, 3), slice(None)), 4),
    ((4, 4, 4), (slice(0, 2), slice(0, 2), slice(None)), 4),
    ((16,), (slice(4, 12),), 1),
])
def test_contiguous_segments_golden(shape, index, max_segs):
    t = segments_equal_numpy(tshard, shape, np.int32, index)
    assert t == segments_equal_numpy(jshard, shape, np.int32, index)
    assert len(t) <= max_segs


@pytest.mark.parametrize("sizes,names,spec,shape,dtype,nseg", [
    ((8,), ("dp",), ("dp",), (16, 128), np.float32, 1),       # batch axis
    ((4, 2), ("dp", "tp"), ("dp", "tp"), (8, 64), np.int8, 2),  # 2-d
    ((2, 4), ("dp", "sp"), ("dp", "sp"), (4, 4096), np.int32, 2),  # sequence
    ((4,), ("dp",), ("dp", None), (8, 2049), np.int32, 1),    # the loader's
], ids=["batch_axis", "2d", "sequence_dim", "llama_loader"])
def test_plan_sharded_read_matches_reference(sizes, names, spec, shape, dtype,
                                             nseg, monkeypatch):
    js, ts = _pair(sizes, names, spec)
    jplans = jshard.plan_sharded_read(shape, dtype, js)
    tplans = _port_plans(ts, shape, dtype, monkeypatch)
    _plans_equal(jplans, tplans)
    assert all(len(p.segments) == nseg for p in tplans.values())
    # the positions' byte ranges tile the array exactly once
    cover = sorted((s.file_offset, s.length) for p in tplans.values()
                   for s in p.segments)
    assert sum(n for _, n in cover) == int(np.prod(shape)) * \
        np.dtype(dtype).itemsize
    assert all(a + n <= b for (a, n), (b, _) in zip(cover, cover[1:]))


def test_replicated_shards_deduped(monkeypatch):
    js, ts = _pair((8,), ("dp",), (None,))
    jgroups = jshard.dedupe_plans(jshard.plan_sharded_read((4, 4),
                                                           np.float32, js))
    tplans = _port_plans(ts, (4, 4), np.float32, monkeypatch)
    tgroups = tshard.dedupe_plans(list(tplans.values()))
    assert len(tgroups) == len(jgroups) == 1   # one read for 8 positions
    (tsegs, tgroup), = tgroups.items()
    (jsegs, jgroup), = jgroups.items()
    assert len(tgroup) == len(jgroup) == 8
    assert [dataclasses.astuple(s) for s in tsegs] == \
        [dataclasses.astuple(s) for s in jsegs]


def test_this_rank_addresses_one_device():
    """Without a group the process is rank 0: one addressable device (the
    CPU, as the mesh has no card), holding rank 0's block."""
    _, ts = _pair((4,), ("dp",), ("dp", None))
    amap = ts.addressable_devices_indices_map((8, 3))
    assert list(amap) == [torch.device("cpu")]
    assert _bounds(amap[torch.device("cpu")], (8, 3)) == ((0, 2), (0, 3))


MESHES = [((4,), ("dp",)), ((2, 2), ("dp", "sp")), ((1, 4), ("dp", "sp"))]
SPECS = [("dp",), ("dp", None), (None, "sp"), ("dp", "sp"), (("dp", "sp"),),
         ()]


@pytest.mark.parametrize("sizes,names", MESHES, ids=["4", "2x2", "1x4"])
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("shape", [(8, 16), (4, 4, 2)], ids=str)
def test_devices_indices_map_matches_named_sharding(sizes, names, spec,
                                                    shape):
    """Every position's block, the shard shape and the placements: equal
    to JAX's, or both refuse the spec (an axis the mesh lacks)."""
    try:
        js, ts = _pair(sizes, names, spec)
    except ValueError:
        with pytest.raises(ValueError):
            TorchSharding(make_mesh(dict(zip(names, sizes)),
                                    devices=range(int(np.prod(sizes)))),
                          P(*spec))
        with pytest.raises(ValueError):
            NamedSharding(Mesh(np.array(jax.devices()[:int(np.prod(sizes))])
                               .reshape(sizes), names), JP(*spec))
        return
    jmap = {d.id: _bounds(i, shape)
            for d, i in js.devices_indices_map(shape).items()}
    tmap = {r: _bounds(i, shape)
            for r, i in ts.devices_indices_map(shape).items()}
    assert tmap == jmap
    assert ts.shard_shape(shape) == js.shard_shape(shape)
    assert ts.device_set == {d.id for d in js.device_set}
    assert len(ts.placements) == len(sizes)


@pytest.mark.parametrize("sizes,names,spec,shape", [
    ((4,), ("dp",), ("dp",), (10, 5)),
    ((1, 4), ("dp", "sp"), (None, "sp"), (8, 6)),
    ((2, 2), ("dp", "sp"), (("dp", "sp"),), (6, 4)),
    ((2, 2), ("dp", "sp"), ("dp", "sp"), (4, 3)),
], ids=["dp4_rows10", "sp4_cols6", "dpsp_rows6", "sp2_cols3"])
def test_uneven_shapes_raise_in_both(sizes, names, spec, shape):
    js, ts = _pair(sizes, names, spec)
    for fn in ("devices_indices_map", "addressable_devices_indices_map",
               "shard_shape"):
        with pytest.raises(ValueError, match="partitioned"):
            getattr(js, fn)(shape)
        with pytest.raises(ValueError, match="partitioned"):
            getattr(ts, fn)(shape)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    _, ts = _pair((2, 2), ("dp", "sp"), ("dp", None))
    assert ts.placements == (Shard(0), Replicate())
    _, ts = _pair((2, 2), ("dp", "sp"), (("dp", "sp"),))
    assert ts.placements == (Shard(0), Shard(0))
    _, ts = _pair((2, 2), ("dp", "sp"), (None, "sp"))
    assert ts.placements == (Replicate(), Shard(1))
    _, ts = _pair((2, 2), ("dp", "sp"), (("sp", "dp"),))
    with pytest.raises(NotImplementedError, match="axis order"):
        ts.placements


def test_llama_param_specs_match_reference():
    """The rules as data: each parameter's spec equals the reference's for
    the same leaf, and param_shardings drops the axes a mesh lacks."""
    jcfg = jllama.LlamaConfig.tiny()
    jspecs = jsharding.param_specs(jllama.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = dict(tllama.Llama(tcfg, device="cpu").named_parameters())
    tspecs = tsharding.param_specs(params)
    for name, spec in tspecs.items():
        want = jspecs[name] if name in jspecs else jspecs["layers"][name]
        assert tuple(spec) == tuple(want), name
    mesh = make_mesh({"dp": 2, "tp": 2}, devices=range(4))
    shardings = tsharding.param_shardings(params, mesh)
    assert tuple(shardings["wq"].spec) == (None, None, "tp")
    assert tuple(shardings["embed"].spec) == (None, "tp")
    assert tsharding.batch_spec() == P("dp")
    assert tsharding.batch_spec(sp=True) == P("dp", "sp")
