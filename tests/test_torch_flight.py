"""The port's flight recorder (``strom_torch/obs/flight.py``), each case run
against the JAX package's recorder as well: the watchdog samples the
flight fields, a slow but advancing run never dumps, a wedged one dumps
once an episode; bundles are atomic and load back; SIGTERM and the
excepthook dump and chain the previous handlers, and a recorder left by
one case does not change the next. The context runs a recorder when
``flight_dir`` is set, dumps a bundle on a breaker trip and closes it."""

import glob
import importlib
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("strom", "strom_torch")


def _mods(pkg: str):
    return (importlib.import_module(f"{pkg}.obs.flight"),
            importlib.import_module(f"{pkg}.obs.events"))


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def mk_recorder(pkg, path, **kw):
    flight, _ = _mods(pkg)
    kw.setdefault("install_signal", False)
    kw.setdefault("install_excepthook", False)
    kw.setdefault("interval_s", 0.05)
    return flight.FlightRecorder(str(path / "fl"), **kw)


def bundles(path):
    return sorted(glob.glob(str(path / "fl" / "flight-*")))


def test_flight_fields_match_reference_but_the_bytes_counter():
    from strom.obs.flight import FLIGHT_FIELDS as J_FIELDS
    from strom_torch.obs.flight import FLIGHT_FIELDS

    assert FLIGHT_FIELDS == tuple("ssd2gpu_bytes" if f == "ssd2tpu_bytes"
                                  else f for f in J_FIELDS)


class TestWatchdog:
    def test_samples_accumulate_with_flight_fields(self, pkg, tmp_path):
        flight, _ = _mods(pkg)
        with mk_recorder(pkg, tmp_path) as rec:
            time.sleep(0.3)
            samples = rec.samples()
        assert samples and set(samples[0]) == set(flight.FLIGHT_FIELDS)

    def test_sample_ring_bounded(self, pkg, tmp_path):
        with mk_recorder(pkg, tmp_path, max_samples=8,
                         interval_s=0.01) as rec:
            time.sleep(0.4)
            assert len(rec.samples()) <= 8

    def test_no_false_positive_while_progressing(self, pkg, tmp_path):
        val = [0]
        with mk_recorder(pkg, tmp_path, stall_s=0.3,
                         progress_fn=lambda: val[0]) as rec:
            for _ in range(8):
                time.sleep(0.15)
                val[0] += 1
            assert rec._dumps == 0
        assert bundles(tmp_path) == []

    def test_stall_dumps_once_per_episode(self, pkg, tmp_path):
        val = [0]
        with mk_recorder(pkg, tmp_path, stall_s=0.2,
                         progress_fn=lambda: val[0]) as rec:
            deadline = time.monotonic() + 5.0
            while rec._dumps == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert rec._dumps == 1
            time.sleep(0.5)
            assert rec._dumps == 1
            val[0] += 1
            time.sleep(0.3)
            while time.monotonic() < deadline and rec._dumps < 2:
                time.sleep(0.05)
            assert rec._dumps == 2
        bs = bundles(tmp_path)
        assert len(bs) == 2 and all("stall" in b for b in bs)

    def test_stall_disabled_at_zero(self, pkg, tmp_path):
        with mk_recorder(pkg, tmp_path, stall_s=0.0,
                         progress_fn=lambda: 7) as rec:
            time.sleep(0.3)
            assert rec._dumps == 0


class TestBundle:
    def test_dump_round_trip(self, pkg, tmp_path):
        flight, events = _mods(pkg)
        store = importlib.import_module(f"{pkg}.obs.exemplars").store
        Request = importlib.import_module(f"{pkg}.obs.request").Request
        store.clear()
        req = Request("gather", "flight-t0")
        req.note_queue_wait(123.0, throttled=True)
        req.finish()
        ring = events.EventRing(capacity=64)
        ring.complete(0.0, 5.0, "read", "t.read", {"bytes": 3})
        with mk_recorder(pkg, tmp_path, ring=ring) as rec:
            p = rec.dump("test", note="hello")
        b = flight.load_bundle(p)
        m = b["manifest"]
        assert (m["reason"], m["note"]) == ("test", "hello")
        assert m["fields"] == list(flight.FLIGHT_FIELDS)
        assert m["samples"] and m["peer_addrs"] == []
        assert any(ev.get("name") == "t.read"
                   for ev in b["trace"]["traceEvents"])
        assert "global" in b["stats"] and "scopes" in b["stats"]
        assert "thread" in b["stacks"]
        exs = b["exemplars"]["tenants"]["flight-t0"]
        assert any(e["req"] == req.id and e["throttled"] for e in exs)
        assert all("exemplars_retained" in s for s in m["samples"])
        store.clear()

    def test_dump_atomic_no_tmp_left(self, pkg, tmp_path):
        with mk_recorder(pkg, tmp_path) as rec:
            rec.dump("a")
            rec.dump("a")
        assert not glob.glob(str(tmp_path / "fl" / ".tmp-*"))
        assert len(bundles(tmp_path)) == 2

    def test_capture_doc_without_recorder(self, pkg):
        flight, _ = _mods(pkg)
        doc = flight.capture_doc()
        assert doc["reason"] == "on_demand"
        assert {"stacks", "trace", "exemplars"} <= set(doc)
        assert doc["fields"] == list(flight.FLIGHT_FIELDS)

    def test_dump_capture_writes_a_bundle(self, pkg, tmp_path):
        flight, _ = _mods(pkg)
        p = flight.dump_capture(str(tmp_path / "adhoc"), reason="probe",
                                note="n")
        assert flight.load_bundle(p)["manifest"]["reason"] == "probe"

    def test_thread_stacks_sees_this_test(self, pkg):
        flight, _ = _mods(pkg)
        assert "test_thread_stacks_sees_this_test" in flight.thread_stacks()


def _child(tmp_path, pkg: str, body: str) -> str:
    child = tmp_path / "child.py"
    child.write_text(f"import os, signal, sys, time\n"
                     f"sys.path.insert(0, {ROOT!r})\n" + body.format(
                         pkg=pkg, fdir=str(tmp_path / "fl")))
    return str(child)


class TestTriggers:
    def test_sigterm_dumps_and_chains(self, pkg, tmp_path):
        flight, _ = _mods(pkg)
        child = _child(tmp_path, pkg, """
def prev(signum, frame):
    os.write(1, b"PREV\\n")
    os._exit(0)

signal.signal(signal.SIGTERM, prev)
from {pkg}.obs.flight import FlightRecorder
FlightRecorder({fdir!r}, stall_s=0.0, interval_s=0.05)
os.write(1, b"READY\\n")
time.sleep(30)
""")
        p = subprocess.Popen([sys.executable, child], stdout=subprocess.PIPE)
        try:
            assert p.stdout.readline().strip() == b"READY"
            time.sleep(0.2)
            p.send_signal(signal.SIGTERM)
            out, _ = p.communicate(timeout=15)
        finally:
            if p.poll() is None:
                p.kill()
        assert b"PREV" in out and p.returncode == 0
        bs = sorted(glob.glob(str(tmp_path / "fl" / "flight-*")))
        assert len(bs) == 1
        assert flight.load_bundle(bs[0])["manifest"]["reason"] == "sigterm"

    def test_sigterm_default_reraises(self, pkg, tmp_path):
        child = _child(tmp_path, pkg, """
from {pkg}.obs.flight import FlightRecorder
FlightRecorder({fdir!r}, stall_s=0.0, interval_s=0.05)
os.write(1, b"READY\\n")
time.sleep(30)
""")
        p = subprocess.Popen([sys.executable, child], stdout=subprocess.PIPE)
        try:
            assert p.stdout.readline().strip() == b"READY"
            time.sleep(0.2)
            p.send_signal(signal.SIGTERM)
            p.communicate(timeout=15)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == -signal.SIGTERM
        assert glob.glob(str(tmp_path / "fl" / "flight-*-sigterm-*"))

    def test_sigterm_sig_ign_stays_ignored(self, pkg, tmp_path):
        child = _child(tmp_path, pkg, """
signal.signal(signal.SIGTERM, signal.SIG_IGN)
from {pkg}.obs.flight import FlightRecorder
FlightRecorder({fdir!r}, stall_s=0.0, interval_s=0.05)
os.write(1, b"READY\\n")
time.sleep(2)
os.write(1, b"SURVIVED\\n")
""")
        p = subprocess.Popen([sys.executable, child], stdout=subprocess.PIPE)
        try:
            assert p.stdout.readline().strip() == b"READY"
            time.sleep(0.2)
            p.send_signal(signal.SIGTERM)
            out, _ = p.communicate(timeout=15)
        finally:
            if p.poll() is None:
                p.kill()
        assert b"SURVIVED" in out and p.returncode == 0
        assert glob.glob(str(tmp_path / "fl" / "flight-*-sigterm-*"))

    def test_close_does_not_clobber_chained_recorder(self, pkg, tmp_path):
        prev_hook = sys.excepthook
        a = mk_recorder(pkg, tmp_path / "a", install_excepthook=True)
        b = mk_recorder(pkg, tmp_path / "b", install_excepthook=True)
        try:
            assert sys.excepthook is b._installed_excepthook
            a.close()
            assert sys.excepthook is b._installed_excepthook
        finally:
            b.close()
        assert sys.excepthook is a._installed_excepthook
        sys.excepthook = prev_hook

    def test_close_restores_the_previous_hooks(self, pkg, tmp_path):
        """A recorder closed in order leaves the excepthook and the SIGTERM
        handler exactly as it found them."""
        prev_hook = sys.excepthook
        prev_term = signal.getsignal(signal.SIGTERM)
        rec = mk_recorder(pkg, tmp_path, install_excepthook=True,
                          install_signal=True)
        assert sys.excepthook is not prev_hook
        assert signal.getsignal(signal.SIGTERM) is not prev_term
        rec.close()
        assert sys.excepthook is prev_hook
        assert signal.getsignal(signal.SIGTERM) is prev_term

    def test_excepthook_dumps_and_chains(self, pkg, tmp_path):
        flight, _ = _mods(pkg)
        child = _child(tmp_path, pkg, """
from {pkg}.obs.flight import FlightRecorder
FlightRecorder({fdir!r}, stall_s=0.0, install_signal=False)
raise RuntimeError("boom-42")
""")
        p = subprocess.run([sys.executable, child], capture_output=True,
                           timeout=60)
        assert p.returncode == 1 and b"boom-42" in p.stderr
        bs = glob.glob(str(tmp_path / "fl" / "flight-*-exception-*"))
        assert len(bs) == 1
        assert "boom-42" in flight.load_bundle(bs[0])["manifest"]["note"]


class TestContext:
    def test_context_starts_and_closes_recorder(self, tmp_path):
        from strom_torch.config import StromConfig
        from strom_torch.delivery.core import StromContext
        from strom_torch.obs.flight import load_bundle

        prev_hook = sys.excepthook
        prev_term = signal.getsignal(signal.SIGTERM)
        ctx = StromContext(StromConfig(engine="python", slab_pool_bytes=0,
                                       flight_dir=str(tmp_path / "fl"),
                                       flight_stall_s=0.0))
        try:
            rec = ctx.flight_recorder
            assert rec is not None
            b = load_bundle(rec.dump("ctx"))
            assert "engine" in b["stats"]["sections"]
            assert "steps" in b["stats"]["sections"]
            s = rec.sample()
            assert s["slab_in_use_bytes"] == 0
        finally:
            ctx.close()
        assert rec._closed.is_set()
        assert sys.excepthook is prev_hook
        assert signal.getsignal(signal.SIGTERM) is prev_term

    def test_no_recorder_without_flight_dir(self):
        from strom_torch.config import StromConfig
        from strom_torch.delivery.core import StromContext

        with StromContext(StromConfig(engine="python")) as ctx:
            assert ctx.flight_recorder is None

    def test_breaker_trip_dumps_a_bundle(self, tmp_path):
        from strom_torch.config import StromConfig
        from strom_torch.delivery.core import StromContext

        ctx = StromContext(StromConfig(engine="python", slab_pool_bytes=0,
                                       flight_dir=str(tmp_path / "fl"),
                                       flight_stall_s=0.0,
                                       breaker_min_events=2))
        try:
            br = ctx.resilience.breaker
            for _ in range(4):
                br.record_failure()
            assert glob.glob(str(tmp_path / "fl" / "flight-*-breaker_trip-*"))
        finally:
            ctx.close()

    def test_failed_async_commit_dumps_a_bundle(self, tmp_path,
                                                monkeypatch):
        import torch

        from strom_torch.ckpt import AsyncCheckpointer, CkptAsyncError
        from strom_torch.config import StromConfig
        from strom_torch.delivery.core import StromContext
        from strom_torch.obs.flight import load_bundle

        ctx = StromContext(StromConfig(engine="python", slab_pool_bytes=0,
                                       flight_dir=str(tmp_path / "fl"),
                                       flight_stall_s=0.0))
        try:
            def dying(chunks, src):
                raise OSError("injected writer death")

            monkeypatch.setattr(ctx, "write_chunks", dying)
            cp = AsyncCheckpointer(ctx, str(tmp_path / "ckpt"))
            cp.save({"w": torch.arange(4096, dtype=torch.float32)})
            with pytest.raises(CkptAsyncError):
                cp.wait()
            cp.close(wait=False)
            bs = glob.glob(str(tmp_path / "fl" / "flight-*-ckpt_commit_"
                               "failed-*"))
            assert len(bs) == 1
            assert "injected writer death" in \
                load_bundle(bs[0])["manifest"]["note"]
        finally:
            ctx.close()
