"""Build and load the port's native io_uring engine (``strom_core.cpp``).

``ensure_built()`` compiles the source with ``g++`` at first use into
``strom_torch/_core/build/`` (listed in ``.gitignore``). The library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.

Safe across processes: the compile runs under an ``flock`` on a lock file
beside the library, into a temporary file that is ``rename()``d into place,
so a concurrent ``dlopen`` never sees a half-written object and six test
workers starting together build it once. A failed compile raises
``RuntimeError`` with the compiler's output. Nothing is built at import
time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "strom_core.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
build_seconds: float | None = None   # this process's compile time; None: cached


def lib_path(build_dir: str = BUILD_DIR) -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(build_dir, f"libstrom_core-{digest[:12]}.so")


def ensure_built(build_dir: str = BUILD_DIR) -> str:
    """Path of the built library, compiling it first if it is missing."""
    global build_seconds
    so = lib_path(build_dir)
    with _lock:
        if os.path.exists(so):
            return so
        os.makedirs(build_dir, exist_ok=True)
        with open(so + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if os.path.exists(so):
                    return so   # another process built it while we waited
                tmp = f"{so}.tmp.{os.getpid()}"
                cmd = ["g++", *CXX_FLAGS, "-o", tmp, SRC]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise RuntimeError(f"failed to build strom_core "
                                       f"({' '.join(cmd)}):\n{proc.stderr}")
                os.rename(tmp, so)
                build_seconds = time.perf_counter() - t0
                return so
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)
