"""The port's stress harness (``python -m strom_torch.engine.stress``) in a
subprocess: the plain build and the lock-order witness on the CPU, and the
native engine's TSAN and ASAN builds under concurrent submitters, as the
JAX package's ``tests/test_sanitizers.py`` runs its own. The sanitized
library is loaded into a stock python, so the runtime is preloaded;
sanitizer reports flip the exit code through TSAN_OPTIONS/ASAN_OPTIONS."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runtime(name: str) -> "str | None":
    try:
        out = subprocess.run(["g++", f"-print-file-name={name}"],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        return None
    return out if out and os.path.isabs(out) and os.path.exists(out) else None


def _run(*args: str, env_extra: "dict | None" = None,
         timeout: int = 600) -> subprocess.CompletedProcess:
    env = os.environ.copy()
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "strom_torch.engine.stress", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("env", [{}, {"STROM_DEBUG_LOCKS": "1"}],
                         ids=["plain", "witness"])
def test_stress_plain_build_ok(env):
    proc = _run("--seconds", "0.5", env_extra=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "stress ok" in proc.stdout
    assert "LockOrderError" not in proc.stderr


def test_variant_without_io_uring_has_nothing_to_stress(monkeypatch, capsys):
    import strom_torch.engine.uring_engine as ue
    from strom_torch.engine.stress import run_stress

    monkeypatch.setattr(ue, "uring_available", lambda: False)
    assert run_stress("tsan", seconds=0.1) == 0
    assert "io_uring unavailable; nothing to stress" in capsys.readouterr().err


def test_unknown_variant_refused():
    from strom_torch._core.build import lib_path

    with pytest.raises(ValueError, match="variant"):
        lib_path(variant="msan")


def test_variants_build_to_their_own_names():
    from strom_torch._core.build import lib_path

    names = {os.path.basename(lib_path(variant=v)) for v in
             ("", "tsan", "asan")}
    assert len(names) == 3
    assert any("_tsan-" in n for n in names) and any("_asan-" in n
                                                     for n in names)


def _sanitized(variant: str, runtime: str, options: dict, *args: str):
    from strom_torch.engine.uring_engine import uring_available

    if not uring_available():
        pytest.skip("io_uring unavailable")
    rt = _runtime(runtime)
    if rt is None:
        pytest.skip(f"{runtime} runtime not found")
    return _run("--variant", variant, "--seconds", "2", *args,
                env_extra={"LD_PRELOAD": rt, **options})


TSAN = {"TSAN_OPTIONS": "exitcode=66 report_bugs=1 history_size=2"}


@pytest.mark.slow
def test_tsan_stress_clean():
    proc = _sanitized("tsan", "libtsan.so", TSAN)
    assert "ThreadSanitizer" not in proc.stderr, proc.stderr[-4000:]
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    assert "stress ok" in proc.stdout


@pytest.mark.slow
def test_asan_stress_clean():
    # python itself "leaks" interned objects: leak detection off, the
    # memory-error detectors stay on
    proc = _sanitized("asan", "libasan.so",
                      {"ASAN_OPTIONS": "detect_leaks=0 exitcode=67"})
    assert "AddressSanitizer" not in proc.stderr, proc.stderr[-4000:]
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    assert "stress ok" in proc.stdout


@pytest.mark.slow
def test_tsan_stress_sqpoll_clean():
    from strom_torch.config import StromConfig
    from strom_torch.engine import make_engine
    from strom_torch.engine.uring_engine import uring_available

    if not uring_available():
        pytest.skip("io_uring unavailable")
    probe = make_engine(StromConfig(sqpoll=True, queue_depth=8,
                                    num_buffers=8))
    try:
        if not probe.stats().get("sqpoll"):
            pytest.skip("kernel refuses IORING_SETUP_SQPOLL here")
    finally:
        probe.close()
    proc = _sanitized("tsan", "libtsan.so", TSAN, "--sqpoll")
    assert "ThreadSanitizer" not in proc.stderr, proc.stderr[-4000:]
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    assert "sqpoll=True" in proc.stdout, proc.stdout


@pytest.mark.slow
def test_tsan_multiring_stress_clean():
    proc = _sanitized("tsan", "libtsan.so", TSAN, "--rings", "2")
    assert "ThreadSanitizer" not in proc.stderr, proc.stderr[-4000:]
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    assert "stress ok" in proc.stdout
