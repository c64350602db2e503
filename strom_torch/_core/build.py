"""Build and load the port's native library (``strom_core.cpp``): the
io_uring engine, and the libjpeg-turbo decoder where the host has one.

``ensure_built()`` compiles the source with ``g++`` at first use into
``strom_torch/_core/build/`` (listed in ``.gitignore``). The library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.

The libjpeg-turbo decoder is probed once per process: when a small program
using ``jpeglib.h`` with the turbo partial-decode API (``jpeg_crop_scanline``
/ ``jpeg_skip_scanlines``) compiles and links with ``-ljpeg``, the library
is built with ``-DSTROM_HAVE_JPEG -ljpeg`` and ``sc_jpeg_decode`` goes live;
otherwise it is built without, and ``sc_jpeg_available()`` reports 0. The
probe's answer is part of the flags, so the name changes with it: a host
that gains or loses the headers gets a rebuild. A ``.jpeg`` marker beside
the library records the answer it was built with. ``STROM_JPEG_CFLAGS``
prepends compiler flags to the probe and the build (tests poison the
include path through it to exercise the build without the decoder).

``variant`` (``"tsan"`` or ``"asan"``) builds the sanitizer variant of the
library, ``-O1 -g -fsanitize=thread|address``, into its own library name
(the variant is part of the name and the hash) for the stress harness
(:mod:`strom_torch.engine.stress`); ``""`` is the plain build.

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
import tempfile
import time

from strom_torch.utils.locks import make_lock

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "strom_core.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]
VARIANTS = ("", "tsan", "asan")
_SANITIZER = {"tsan": "thread", "asan": "address"}


def _cxx_flags(variant: str) -> list[str]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown build variant {variant!r} "
                         f"(one of {VARIANTS})")
    if not variant:
        return CXX_FLAGS
    return ["-O1", "-g", "-std=c++17", "-fPIC", "-pthread", "-shared",
            f"-fsanitize={_SANITIZER[variant]}"]

# exactly the API surface sc_jpeg_decode needs: plain (non-turbo) libjpeg
# has jpeglib.h but not the partial-decode entry points, so either the
# whole decode path compiles or none of it does
_JPEG_PROBE_SRC = """
#include <cstdio>
#include <jpeglib.h>
int main() {
  struct jpeg_decompress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c);
  (void)&jpeg_mem_src;
  (void)&jpeg_crop_scanline;
  (void)&jpeg_skip_scanlines;
  jpeg_destroy_decompress(&c);
  return 0;
}
"""

_lock = make_lock("app.core_build")
build_seconds: float | None = None   # this process's compile time; None: cached
# probe answer memoized per STROM_JPEG_CFLAGS value
_jpeg_probe: dict[tuple[str, ...], bool] = {}


def _jpeg_extra_cflags() -> list[str]:
    return os.environ.get("STROM_JPEG_CFLAGS", "").split()


def jpeg_probe() -> bool:
    """True when this host can compile and link the libjpeg-turbo decode
    path (memoized per process)."""
    extra = tuple(_jpeg_extra_cflags())
    if extra not in _jpeg_probe:
        with tempfile.TemporaryDirectory(prefix="strom_jpeg_probe_") as td:
            src = os.path.join(td, "probe.cpp")
            with open(src, "w") as f:
                f.write(_JPEG_PROBE_SRC)
            cmd = ["g++", *extra, src, "-o", os.path.join(td, "probe"),
                   "-ljpeg"]
            try:
                proc = subprocess.run(cmd, capture_output=True, timeout=120)
                ok = proc.returncode == 0
            except (OSError, subprocess.TimeoutExpired):
                ok = False   # no compiler: no native decoder
        _jpeg_probe[extra] = ok
    return _jpeg_probe[extra]


def _build_cmd(out: str, variant: str = "") -> list[str]:
    flags = _cxx_flags(variant)
    if jpeg_probe():
        return ["g++", *_jpeg_extra_cflags(), *flags, "-DSTROM_HAVE_JPEG",
                "-o", out, SRC, "-ljpeg"]
    return ["g++", *flags, "-o", out, SRC]


def lib_path(build_dir: str = BUILD_DIR, variant: str = "") -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join(_build_cmd("", variant)).encode()
        ).hexdigest()
    suffix = f"_{variant}" if variant else ""
    return os.path.join(build_dir,
                        f"libstrom_core{suffix}-{digest[:12]}.so")


def built_with_jpeg(so: str) -> bool | None:
    """The probe answer *so* was built with (None: no marker)."""
    try:
        with open(so + ".jpeg") as f:
            return f.read().strip() == "1"
    except OSError:
        return None


def ensure_built(build_dir: str = BUILD_DIR, variant: str = "") -> str:
    """Path of the built library (of the sanitizer *variant*), compiling
    it first if it is missing."""
    global build_seconds
    so = lib_path(build_dir, variant)
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
                cmd = _build_cmd(tmp, variant)
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise RuntimeError(f"failed to build strom_core "
                                       f"({' '.join(cmd)}):\n{proc.stderr}")
                # the marker lands before the library it describes
                with open(f"{so}.jpeg.tmp.{os.getpid()}", "w") as mf:
                    mf.write("1" if "-DSTROM_HAVE_JPEG" in cmd else "0")
                os.rename(f"{so}.jpeg.tmp.{os.getpid()}", so + ".jpeg")
                os.rename(tmp, so)
                build_seconds = time.perf_counter() - t0
                return so
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)
