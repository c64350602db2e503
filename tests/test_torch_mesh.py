"""The port's meshes against the JAX package's (``strom/parallel/mesh.py``)
on the conftest's 8 CPU devices: ``make_mesh`` gives the same axes, sizes
and device order (ranks where JAX has devices, row-major either way),
including the -1 axis and every error; ``factor_mesh`` the same
factorisations. Without a process group a mesh is planning data only."""

import numpy as np
import pytest

import jax

from strom.parallel import mesh as jmesh
from strom_torch.parallel import mesh as tmesh

CASES = [(None, 8), (None, 4), ({"dp": 8}, 8), ({"dp": 2, "tp": 4}, 8),
         ({"dp": -1, "tp": 2}, 8), ({"dp": -1, "tp": 2}, 4),
         ({"dp": 2, "sp": -1}, 8), ({"dp": 1, "sp": 4, "tp": 2}, 8),
         ({"pp": 2, "dp": -1}, 4), ({"dp": 2, "sp": 2}, 4),
         ({"dp": 1, "sp": 4}, 4), ({"dp": 4}, 4)]


@pytest.mark.parametrize("axes,n", CASES, ids=str)
def test_make_mesh_matches_jax(axes, n):
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    tm = tmesh.make_mesh(axes, devices=list(range(n)))
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert tm.size == jm.size
    np.testing.assert_array_equal(
        tm.devices, np.vectorize(lambda d: d.id)(jm.devices))


@pytest.mark.parametrize("axes,n", [
    ({"dp": -1, "tp": -1}, 8),      # two -1 axes
    ({"dp": -1, "tp": 3}, 8),       # -1 with a remainder
    ({"dp": 2, "tp": 2}, 8),        # too few positions
    ({"dp": 16}, 8),                # too many
], ids=["two_minus_one", "remainder", "too_few", "too_many"])
def test_make_mesh_errors_match_jax(axes, n):
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(axes, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as te:
        tmesh.make_mesh(axes, devices=list(range(n)))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 64])
@pytest.mark.parametrize("want_tp", [0, 2, 3, 4, 5])
def test_factor_mesh_matches_jax(n, want_tp):
    assert tmesh.factor_mesh(n, want_tp=want_tp) == \
        jmesh.factor_mesh(n, want_tp=want_tp)


def test_mesh_without_a_group_is_planning_only():
    """No process group: world 1, rank 0, a one-rank default mesh, and no
    DeviceMesh to build a DTensor on."""
    assert not tmesh.is_initialized()
    assert (tmesh.world_size(), tmesh.rank()) == (1, 0)
    m = tmesh.make_mesh()
    assert m.shape == {"dp": 1} and m.device_type == "cpu"
    assert m.coords(0) == (0,) and m.coords(1) is None
    with pytest.raises(RuntimeError, match="init_distributed"):
        m.device_mesh
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.host_group()
    tmesh.shutdown()   # nothing to leave


def test_world_of_one_over_a_local_store():
    """init_distributed() with no launcher: a world of 1 over an in-memory
    store, gloo on the CPU, its DeviceMesh and host groups; shutdown
    leaves it."""
    tmesh.init_distributed("cpu")
    try:
        assert tmesh.is_initialized() and tmesh.world_size() == 1
        m = tmesh.make_mesh({"dp": -1})
        assert m.device_mesh.mesh_dim_names == ("dp",)
        assert m.device_mesh.size() == 1
        tmesh.init_distributed("cpu")   # a second call does nothing
        assert tmesh.host_group() is not None
        assert tmesh.epoch_group() is not None
    finally:
        tmesh.shutdown()
    assert not tmesh.is_initialized()
