"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``strom_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded with
``ctypes``. A build happens at first use, into ``strom_torch/csrc/build/``
(listed in ``.gitignore``); the library's name carries a hash of its source,
so an edited source is rebuilt and a stale library is never loaded.
Several sources build in parallel, one ``nvcc`` process each. A build
holds an ``flock`` on a lock file beside its library, so of several
processes that want it at once (one a card) one compiles and the rest
wait and load its result.

Nothing here runs at import time: this module is imported on machines with
no ``nvcc`` (the CPU tests), where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # source name -> nvcc's output (ptxas -v)
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built on this machine")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name.rsplit('.', 1)[0]}-{digest[:12]}.so")


def _compile(name: str) -> str:
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # another process may be building
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               os.path.join(CSRC, name)],
                              capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{build_logs[name]}")
        os.replace(tmp, out)
    return out


def build_all() -> dict[str, str]:
    """Compile every source under csrc/ in parallel; {source: library}."""
    names = sorted(n for n in os.listdir(CSRC) if n.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(_compile, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>`` (built if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_compile(name))
        return lib
