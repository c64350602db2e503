"""Ring quarantine and recovery of the port's multi-ring engine, held to the
JAX package's (``tests/test_faults.py::TestMultiRingQuarantine`` and
``tests/test_multiring.py::test_ring_recovery_reregisters_dest_buffers``):
the same faults quarantine the same ring, the same files route to the same
survivors, the same errnos are exempt, and a rebuilt ring carries the live
dest registrations and serves them exactly. Skipped where io_uring is
absent, as the JAX package's tests are."""

import errno
import json
import time

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.engine import make_engine as j_make_engine
from strom.engine.base import DeadlineExceeded as JDeadline
from strom.engine.base import EngineError as JError
from strom.engine.base import EngineStallError as JStall
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.engine import make_engine
from strom_torch.engine.base import DeadlineExceeded, EngineError
from strom_torch.engine.base import EngineStallError
from strom_torch.engine.uring_engine import uring_available
from strom_torch.faults import FaultPlan, FaultyEngine


@pytest.fixture(autouse=True)
def _needs_io_uring():
    if not uring_available():
        pytest.skip("io_uring unavailable")


# both packages: (config, make_engine, EngineError, DeadlineExceeded,
# EngineStallError)
PKGS = {"jax": (JConfig, j_make_engine, JError, JDeadline, JStall),
        "torch": (StromConfig, make_engine, EngineError, DeadlineExceeded,
                  EngineStallError)}

# (errno, error kind) sequences fed to ring 0 then ring 1
SEQUENCES = {
    "eio": [(errno.EIO, "plain")] * 3,
    "eagain": [(errno.EAGAIN, "plain")] * 3,
    "enodata": [(errno.ENODATA, "plain")] * 3,
    "ebadf": [(errno.EBADF, "plain")] * 3,
    "deadline_etimedout": [(errno.ETIMEDOUT, "plain")] * 3,
    "stall_etimedout": [(errno.ETIMEDOUT, "stall")] * 3,
    "deadline": [(errno.ETIMEDOUT, "deadline")] * 3,
}


def _err(pkg: str, e: int, kind: str):
    _, _, Err, Deadline, Stall = PKGS[pkg]
    if kind == "stall":
        err = Stall(1.0, [], "test")
        err.errno = e
        return err
    if kind == "deadline":
        return Deadline("test")
    return Err(e, "injected")


def _trace(pkg: str, seq) -> list:
    """Feed *seq* to ring 0 and then ring 1 of a 3-ring engine; record the
    healthy set, the stats' quarantine view and the routes after each."""
    Cfg, make, *_ = PKGS[pkg]
    eng = make(Cfg(engine="uring", engine_rings=3, breaker_min_events=2))
    out = []
    try:
        for ring in (0, 1):
            for e, kind in seq:
                eng._note_ring_error(ring, _err(pkg, e, kind))
                s = eng.stats()
                healthy = eng._healthy_rings()
                out.append((healthy, s["quarantined_rings"],
                            list(s["ring_errors"]),
                            [eng._route(fi, healthy) for fi in range(6)]))
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_quarantine_decisions_match_reference(name):
    assert _trace("torch", SEQUENCES[name]) == _trace("jax", SEQUENCES[name])


def test_transient_errors_quarantine_a_ring():
    eng = make_engine(StromConfig(engine="uring", engine_rings=2,
                                  breaker_min_events=2))
    try:
        e = EngineError(errno.EIO, "injected")
        eng._note_ring_error(0, e)
        assert eng._healthy_rings() == [0, 1]
        eng._note_ring_error(0, e)
        assert eng._healthy_rings() == [1]
        s = eng.stats()
        assert s["quarantined_rings"] == [0] and s["ring_errors"][0] == 2
        assert eng._route(1, eng._healthy_rings()) == 1
        assert eng._route(0, eng._healthy_rings()) == 1
        # the last healthy ring is never quarantined; exempt errnos never
        # count
        for err in (EngineError(errno.ENODATA, "eof"),
                    EngineError(errno.EBADF, "x"),
                    EngineError(errno.EIO, "x"),
                    EngineError(errno.EIO, "x")):
            eng._note_ring_error(1, err)
        assert eng._healthy_rings() == [1]
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ring_recovery_reregisters_dest_buffers(pkg, tmp_path):
    """After a quarantined ring is rebuilt, every live dest slab is
    registered on the new ring, which serves it by READ_FIXED, exactly."""
    Cfg, make, Err, *_ = PKGS[pkg]
    data = np.random.default_rng(7).integers(0, 256, size=512 * 1024,
                                             dtype=np.uint8)
    path = tmp_path / "f.bin"
    data.tofile(path)
    eng = make(Cfg(engine="uring", engine_rings=2, breaker_min_events=2,
                   ring_recovery_s=0.05, residency_hybrid=False))
    try:
        if not eng.stats().get("fixed_buffers"):
            pytest.skip("kernel lacks fixed buffers")
        dest = alloc_aligned(len(data))
        assert eng.register_dest(dest) == 0
        sick = eng._children[0]
        eng._note_ring_error(0, Err(errno.EIO, "injected"))
        eng._note_ring_error(0, Err(errno.EIO, "injected"))
        assert eng.stats()["quarantined_rings"] == [0]
        time.sleep(0.08)
        eng._maybe_recover_rings()
        s = eng.stats()
        assert s["quarantined_rings"] == [] and s["ring_recoveries"] == 1
        child = eng._children[0]
        assert child is not sick
        assert child.stats()["ext_buffers"] == 1
        fi = eng.register_file(str(path), o_direct=True)
        assert eng.read_vectored([(fi, 0, 0, len(data))], dest) == len(data)
        np.testing.assert_array_equal(dest, data)
        assert eng.stats()["engine_fixed_buf_ratio"] == 1.0
    finally:
        eng.close()


def test_failing_ring_quarantined_by_gathers_then_recovered(tmp_path):
    """End to end on the port: ring 0 fails every read with EIO (a fault
    plan on that ring), so two-file gathers fail until ring 0 is
    quarantined; then file 0 routes to ring 1 and the gather is exact;
    after ring_recovery_s the ring is rebuilt and serves again."""
    rng = np.random.default_rng(3)
    files = []
    for i in range(2):
        d = rng.integers(0, 256, size=256 * 1024, dtype=np.uint8)
        p = tmp_path / f"m{i}.bin"
        d.tofile(p)
        files.append((str(p), d))
    eng = make_engine(StromConfig(engine="uring", engine_rings=2,
                                  breaker_min_events=2, ring_recovery_s=0.3,
                                  io_retries=0))
    plan = FaultPlan.from_spec(json.dumps(
        {"seed": 0, "rules": [{"kind": "errno", "op": "read"}]}))
    eng._children[0] = FaultyEngine(eng._children[0], plan)
    try:
        fis = [eng.register_file(p, o_direct=False) for p, _ in files]
        n = 256 * 1024
        chunks = [(fis[0], 0, 0, n), (fis[1], 0, n, n)]
        want = np.concatenate([d for _, d in files])
        dest = alloc_aligned(2 * n)
        for _ in range(2):
            with pytest.raises(EngineError) as ei:
                eng.read_vectored(chunks, dest)
            assert ei.value.errno == errno.EIO
        assert eng.stats()["quarantined_rings"] == [0]
        assert eng.read_vectored(chunks, dest) == 2 * n
        np.testing.assert_array_equal(dest, want)
        time.sleep(0.35)
        dest[:] = 0
        assert eng.read_vectored(chunks, dest) == 2 * n
        np.testing.assert_array_equal(dest, want)
        s = eng.stats()
        assert s["ring_recoveries"] == 1 and s["quarantined_rings"] == []
        assert s["ring_stats"][0]["ops_submitted"] > 0
    finally:
        eng.close()
