"""Concurrency stress (the port's copy of ``strom/engine/stress.py``): many
threads hammer one StromContext while others poll stats and churn the
engine's dest-buffer table — run plain, or under the TSAN/ASAN builds of
the native engine.

Usage:
    python -m strom_torch.engine.stress --seconds 3
    STROM_DEBUG_LOCKS=1 python -m strom_torch.engine.stress --seconds 3
    LD_PRELOAD=$(g++ -print-file-name=libtsan.so) \
        python -m strom_torch.engine.stress --variant tsan

Prints ``stress ok: ...`` and exits 0 when every read matched; a variant
without io_uring prints "io_uring unavailable; nothing to stress" and
exits 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np


def run_stress(variant: str = "", *, seconds: float = 3.0,
               readers: int = 3, size: int = 8 * 1024 * 1024,
               sqpoll: bool = False, rings: int = 1) -> int:
    """Hammer one context for *seconds*: *readers* threads pread random
    ranges and check them, a poller reads stats, a registrar churns the
    dest-buffer table with raw gathers into registered slabs. 0 when
    every read matched, 1 otherwise. Under the lock-order witness
    (``STROM_DEBUG_LOCKS=1``, or ``utils.locks.enable_witness()`` first)
    a lock-order cycle fails the run."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.engine.uring_engine import UringEngine, uring_available

    cfg = StromConfig(queue_depth=16, num_buffers=32, sqpoll=sqpoll,
                      engine_rings=rings)
    if variant:
        if not uring_available():
            print("io_uring unavailable; nothing to stress", file=sys.stderr)
            return 0
        if rings > 1:
            from strom_torch.engine.multi import MultiRingEngine

            engine = MultiRingEngine(cfg, variant=variant)
        else:
            engine = UringEngine(cfg, variant=variant)
    else:
        engine = None  # auto
    ctx = StromContext(cfg, engine=engine)
    sqpoll_active = ctx.engine.stats().get("sqpoll", False)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "stress.bin")
        golden = np.random.default_rng(0).integers(0, 256, size, dtype=np.uint8)
        golden.tofile(path)

        stop = threading.Event()
        errors: list[BaseException] = []

        def reader(tid: int) -> None:
            rng = np.random.default_rng(tid)
            try:
                while not stop.is_set():
                    off = int(rng.integers(0, size // 2)) & ~4095
                    ln = int(rng.integers(1, 16)) * 128 * 1024
                    ln = min(ln, size - off)
                    got = ctx.pread(path, off, ln)
                    if not np.array_equal(got, golden[off: off + ln]):
                        raise AssertionError(f"data mismatch at {off}+{ln}")
            except BaseException as e:  # noqa: BLE001 - surfaced to main
                errors.append(e)
                stop.set()

        def poller() -> None:
            try:
                while not stop.is_set():
                    ctx.stats()
                    ctx.buffer_info()
                    ctx.engine.in_flight()
                    time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                stop.set()

        def registrar() -> None:
            # churn the sparse dest-buffer table (register/read/unregister)
            # against concurrent gathers and stats: the engine's dest
            # registration paths under the sanitizers. The gather holds an
            # exclusive grant (read_vectored owns the engine's tag space);
            # register/unregister stay outside it, racing the other
            # threads' reads, which is the point.
            from strom_torch.delivery.buffers import alloc_aligned

            rng = np.random.default_rng(99)
            try:
                while not stop.is_set():
                    slab = alloc_aligned(int(rng.integers(1, 9)) * 128 * 1024)
                    idx = ctx.engine.register_dest(slab)
                    try:
                        off = int(rng.integers(0, size - slab.nbytes)) & ~4095
                        fi = ctx.file_index(path)
                        # a scheduler grant (the engine lock without the
                        # scheduler): this raw gather never interleaves
                        # with a delivery transfer's tag space
                        with ctx.engine_exclusive(slab.nbytes):
                            n = ctx.engine.read_vectored(
                                [(fi, off, 0, slab.nbytes)], slab)
                        if n != slab.nbytes or not np.array_equal(
                                slab, golden[off: off + slab.nbytes]):
                            raise AssertionError(
                                f"registered-dest mismatch at {off}")
                    finally:
                        # the slab must outlive its registration even on the
                        # error path (register_dest's documented contract)
                        if idx >= 0:
                            ctx.engine.unregister_dest(slab)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                stop.set()

        # daemon: the leak-and-report path below must be able to EXIT with a
        # wedged thread still alive; non-daemon threads would hang the
        # interpreter in threading._shutdown and eat the diagnostic exit code
        threads = [threading.Thread(target=reader, args=(i,), daemon=True,
                                    name=f"strom-stress-reader-{i}")
                   for i in range(readers)]
        threads.append(threading.Thread(target=poller, daemon=True,
                                        name="strom-stress-poller"))
        threads.append(threading.Thread(target=registrar, daemon=True,
                                        name="strom-stress-registrar"))
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            # closing under a live thread destroys the engine out from
            # under it (a use-after-free): report and leak instead
            errors.append(RuntimeError(f"threads failed to stop: {alive}"))
        else:
            ctx.close()
        if errors:
            print(f"stress FAILED: {errors[0]!r}", file=sys.stderr)
            return 1
        print(f"stress ok: engine={ctx.engine.name} "
              f"variant={variant or 'default'} sqpoll={sqpoll_active}")
        return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="", choices=["", "tsan", "asan"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--readers", type=int, default=3)
    ap.add_argument("--sqpoll", action="store_true",
                    help="stress an IORING_SETUP_SQPOLL ring (covers the "
                         "need-wakeup fence under the sanitizers)")
    ap.add_argument("--rings", type=int, default=1,
                    help="multi-ring engine: concurrent gathers interleave "
                         "across N rings with NO delivery-layer lock — the "
                         "per-ring locking is what's under test")
    args = ap.parse_args()
    return run_stress(args.variant, seconds=args.seconds,
                      readers=args.readers, sqpoll=args.sqpoll,
                      rings=args.rings)


if __name__ == "__main__":
    sys.exit(main())
