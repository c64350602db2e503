"""Device-to-SSD checkpoints through the engine's write path (the port's
copy of ``strom/ckpt/checkpoint.py``).

A train state, any nest of dicts, lists and tuples whose leaves are
tensors, numpy arrays or Python scalars, is flattened in the order
``jax.tree_util.tree_flatten`` uses (dict keys sorted, sequences in order,
``None`` an empty node), so a state of the same nesting gives the same
leaf table in both packages. Its leaves become one flat ``data.bin`` of
4096-aligned spans, written through ``submit_vectored(op="write")`` from
O_DIRECT-aligned staging slabs. Restore delivers each leaf with
``memcpy_ssd2gpu``, the path the training data takes, onto the device of
the template's leaf.

Layout (one checkpoint is one directory)::

    <dir>/manifest.json   # format tag, leaf table (shape, dtype, offset,
                          # nbytes, crc32), total_bytes
    <dir>/data.bin        # leaf bytes, each span 4096-aligned (gaps zero)

Dtypes are named as numpy names them (``"bfloat16"`` included), so either
package reads the other's manifests. numpy has no bfloat16 without
``ml_dtypes``, which the port does not import: such a leaf travels as the
bytes of an int16 view and comes back as ``.view(torch.bfloat16)``.

Crash safety: everything lands in ``<dir>.tmp-<pid>`` first, data and
manifest are fsynced, and the directory rename is the commit; a crash
before it leaves the previous checkpoint (or nothing) and a ``.tmp-*``
orphan that never loads as a checkpoint. Every leaf carries a CRC32, which
``restore_checkpoint(verify=True)`` checks (:class:`CkptCorruptError`).

Torch tensors are not immutable, and a captured train step rewrites its
state in place. A blocking save returns only once its bytes are written,
and copies each device leaf straight into its pinned staging slabs; the
async save (``async_save.py``) first copies every leaf to host memory it
owns (:func:`_host_leaves`), then returns.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import glob
import json
import os
import pickle
import shutil
import time
import zlib
from typing import Any

import numpy as np
import torch

from strom_torch.delivery.buffers import (alloc_aligned, host_register,
                                          host_unregister)

ALIGN = 4096          # leaf-span alignment: O_DIRECT offset granularity
FORMAT = "strom-ckpt-v1"
_STAGE_BYTES = 32 << 20   # staging slab per write flush

# the numbers a checkpoint measurement reports (chip_smoke's [ckpt] lines)
CKPT_FIELDS = (
    "ckpt_bytes",
    "ckpt_leaves",
    "ckpt_save_mb_per_s",
    "ckpt_restore_mb_per_s",
    "ckpt_pickle_save_mb_per_s",
    "ckpt_save_vs_pickle",
    "ckpt_roundtrip_ok",
)


class CkptError(RuntimeError):
    pass


class CkptCorruptError(CkptError):
    """A leaf's bytes on media do not match its manifest CRC."""


def _aligned(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


# -- dtypes: numpy's names, torch's types ------------------------------------
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
# dtypes numpy lacks: carried as the bytes of an integer view of their size
_NO_NUMPY = {"bfloat16": np.int16}


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        if dt not in _DTYPE_NAMES:
            raise CkptError(f"no checkpoint dtype for {dt}")
        return _DTYPE_NAMES[dt]
    return np.dtype(dt).name


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as: its own, or an integer
    of its size where numpy has none."""
    return np.dtype(_NO_NUMPY.get(name, name))


# -- the tree: jax.tree_util's flatten order ----------------------------------
def tree_flatten(tree: Any) -> tuple[list, Any]:
    """Leaves of *tree* in ``jax.tree_util.tree_flatten``'s order, and the
    structure :func:`tree_unflatten` rebuilds it from."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(c) for c in node])
        if node is None:
            return (None, None, [])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        if kind is None:
            return None
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if hasattr(kind, "_fields"):   # a namedtuple
            return kind(*built)
        return kind(built)

    return build(treedef)


@dataclasses.dataclass
class _Leaf:
    """One leaf of a save: *obj* a host tensor or array the save owns (or,
    in a blocking save, the caller's device tensor), *data* its bytes
    (flat uint8: numpy on the host, a tensor on the device)."""

    obj: Any
    data: Any
    shape: tuple[int, ...]
    dtype: str
    nbytes: int


def _leaf(leaf: Any, snapshot: bool, keep_device: bool) -> _Leaf:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _dtype_name(t.dtype)
        if t.device.type != "cpu" and keep_device:
            # a blocking save stages it straight into the pinned slabs
            data = t.contiguous().reshape(-1).view(torch.uint8)
            return _Leaf(t, data, tuple(t.shape), name, data.numel())
        if t.device.type != "cpu":
            # a blocking copy, ordered after the work queued on the current
            # stream (a step that updates the leaf): the host owns the bytes
            t = t.to("cpu", memory_format=torch.contiguous_format)
        else:
            c = t.contiguous()
            t = c.clone() if snapshot and c.data_ptr() == t.data_ptr() \
                and c.numel() else c
        data = t.reshape(-1).view(torch.uint8).numpy()
        return _Leaf(t, data, tuple(t.shape), name, data.nbytes)
    a = np.asarray(leaf)
    if not a.flags["C_CONTIGUOUS"]:
        # unconditional ascontiguousarray would also make 0-d arrays (1,)
        a = np.ascontiguousarray(a)
    elif snapshot and isinstance(leaf, np.ndarray):
        a = a.copy()
    data = a.reshape(-1).view(np.uint8)
    return _Leaf(a, data, tuple(a.shape), a.dtype.name, data.nbytes)


class _PinnedArena:
    """A page-aligned host buffer, page-locked and registered with CUDA,
    that successive snapshots reuse (it grows when a state does): the
    device leaves' copies into it are DMAs, queued together and waited on
    once."""

    def __init__(self):
        self._buf: np.ndarray | None = None

    def get(self, nbytes: int) -> np.ndarray:
        if self._buf is None or self._buf.nbytes < nbytes:
            self.close()
            buf = alloc_aligned(nbytes, populate=True)
            host_register(buf)
            self._buf = buf
        return self._buf

    def close(self) -> None:
        if self._buf is not None:
            host_unregister(self._buf)
            self._buf = None


def _is_device(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"


def _snapshot_into(arena: _PinnedArena, leaves: list) -> list[_Leaf]:
    """Host copies of *leaves*: the device ones in *arena*, copied on
    their devices' current streams (after the work queued there), then
    waited on; the rest as ``_leaf(snapshot=True)``."""
    need = sum(_aligned(t.numel() * t.element_size())
               for t in leaves if _is_device(t))
    buf = arena.get(need) if need else None
    out, off, streams = [], 0, set()
    for leaf in leaves:
        if not _is_device(leaf):
            out.append(_leaf(leaf, True, False))
            continue
        t = leaf.detach()
        n = t.numel() * t.element_size()
        data = buf[off: off + n]
        torch.from_numpy(data).copy_(
            t.contiguous().reshape(-1).view(torch.uint8), non_blocking=True)
        streams.add(torch.cuda.current_stream(t.device))
        host = torch.from_numpy(data).view(t.dtype).reshape(t.shape)
        out.append(_Leaf(host, data, tuple(t.shape), _dtype_name(t.dtype),
                         n))
        off += _aligned(n)
    for s in streams:
        s.synchronize()
    return out


def _host_leaves(state: Any, *, snapshot: bool = False,
                 keep_device: bool = False,
                 arena: "_PinnedArena | None" = None
                 ) -> tuple[list[_Leaf], Any]:
    """Flatten *state* and bring every leaf to host memory, contiguous.
    ``snapshot=True`` (the async save) copies host leaves too: the caller
    may change them once the save returns, and the commit reads them
    later; with an *arena* the device leaves land in its pinned memory.
    ``keep_device=True`` (a blocking save, which returns only once the
    bytes are written) leaves device leaves where they are: the stager
    copies them into its pinned slabs, with no pageable copy between."""
    leaves, treedef = tree_flatten(state)
    if snapshot and arena is not None:
        return _snapshot_into(arena, leaves), treedef
    return [_leaf(leaf, snapshot, keep_device) for leaf in leaves], treedef


class _Stager:
    """Double-buffered staging for the write stream: leaf bytes are copied
    into one of two O_DIRECT-aligned slabs, the CRC32 computed in the same
    pass, while the other slab's engine write drains on a writer thread,
    so a save takes about max(copy, write), not their sum. The slabs come
    from the context's pinned pool where it serves the card."""

    def __init__(self, ctx, fi: int):
        self._ctx = ctx
        self._fi = fi
        self._dev = torch.device("cuda" if torch.cuda.is_available()
                                 else "cpu")
        self._bufs = [ctx.host_batch((_STAGE_BYTES,), self._dev)
                      for _ in range(2)]
        self._futs: list = [None, None]
        self._cur = 0
        self._used = 0
        self._chunks: list[tuple[int, int, int, int]] = []
        self.d2h_s = 0.0
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="strom-ckpt-write")

    def _flush_swap(self) -> None:
        """Hand the current slab to the writer and make the other one,
        its previous write drained, current."""
        if not self._chunks:
            return
        i = self._cur
        self._futs[i] = self._exec.submit(self._ctx.write_chunks,
                                          self._chunks, self._bufs[i])
        self._chunks = []
        self._used = 0
        self._cur = 1 - i
        f = self._futs[self._cur]
        if f is not None:
            self._futs[self._cur] = None
            f.result()   # the slab about to be filled must be retired

    def add(self, file_off: int, leaf: _Leaf) -> int:
        """Stage one leaf's bytes; returns their CRC32. A device leaf is
        copied straight into the slab (``d2h_s`` counts that time). The
        leaf's tail is padded with zeros to its span's end (the bytes the
        file holds there anyway), so every piece, in the slab and in the
        file, is 4096-aligned and can take the O_DIRECT fd."""
        crc = 0
        pos = 0
        data, n = leaf.data, leaf.nbytes
        on_device = isinstance(data, torch.Tensor)
        while pos < n:
            free = _STAGE_BYTES - self._used
            if free == 0:
                self._flush_swap()
                free = _STAGE_BYTES
            buf = self._bufs[self._cur]
            take = min(free, n - pos)
            if on_device:
                t0 = time.perf_counter()
                torch.from_numpy(buf[self._used: self._used + take]).copy_(
                    data[pos: pos + take])
                self.d2h_s += time.perf_counter() - t0
                piece = buf[self._used: self._used + take]
            else:
                piece = data[pos: pos + take]
                buf[self._used: self._used + take] = piece
            crc = zlib.crc32(piece, crc)
            span = _aligned(take)
            buf[self._used + take: self._used + span] = 0
            self._chunks.append((self._fi, file_off + pos, self._used, span))
            self._used += span
            pos += take
        return crc & 0xFFFFFFFF

    def finish(self) -> None:
        """Drain every write, the last one included; the first writer
        failure raises here, before the manifest commits."""
        self._flush_swap()
        for i, f in enumerate(self._futs):
            if f is not None:
                self._futs[i] = None
                f.result()

    def close(self) -> None:
        self._exec.shutdown(wait=True)
        for b in self._bufs:
            self._ctx.release_host_batch(b, self._dev)
        self._bufs = []


def _build_manifest(leaves: list[_Leaf], extra: "dict | None" = None
                    ) -> dict:
    """Leaf table and span layout of a flattened state. *extra* is the
    caller's payload, committed by the same rename as the data (the resume
    layer puts its StepToken there, ``strom_torch/ckpt/jobstate.py``)."""
    metas = []
    off = 0
    for i, a in enumerate(leaves):
        metas.append({
            "index": i,
            "shape": list(a.shape),
            "dtype": a.dtype,
            "offset": off,
            "nbytes": int(a.nbytes),
            "crc32": 0,  # filled during staging
        })
        off += _aligned(max(a.nbytes, 1))
    return {"format": FORMAT, "total_bytes": off,
            "payload_bytes": int(sum(m["nbytes"] for m in metas)),
            "extra": extra or {},
            "leaves": metas}


def save_checkpoint(ctx, directory: str, state: Any, *,
                    extra: "dict | None" = None) -> dict:
    """Write *state* to *directory* through the engine's write path and
    return the manifest (``total_bytes`` is what a rate is taken over).
    The rename is the commit: an existing checkpoint at *directory* is
    replaced atomically. *extra* rides the manifest."""
    leaves, _ = _host_leaves(state, keep_device=True)
    return _commit_checkpoint(ctx, directory, leaves,
                              _build_manifest(leaves, extra))


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit_checkpoint(ctx, directory: str, leaves: list[_Leaf],
                       manifest: dict) -> dict:
    """The commit half of a save, shared by the blocking save and the
    async checkpointer's writer thread: stage and write the host leaves
    into ``<dir>.tmp-<pid>``, fsync, rename."""
    metas = manifest["leaves"]
    total = manifest["total_bytes"]
    directory = os.path.abspath(directory)
    tmp = f"{directory}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        data_path = os.path.join(tmp, "data.bin")
        fd = os.open(data_path, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, total)  # gaps between spans read as zeros
        finally:
            os.close(fd)
        if total:
            # registered with the engine directly, not through the
            # context's path-keyed table: the tmp path is reused by every
            # save of this process, and a cached fd would write into the
            # inode the previous save renamed into place
            fi = ctx.engine.register_file(data_path,
                                          o_direct=ctx.config.o_direct,
                                          writable=True)
            try:
                st = _Stager(ctx, fi)
                try:
                    for meta, a in zip(metas, leaves):
                        if meta["nbytes"]:
                            meta["crc32"] = st.add(meta["offset"], a)
                    st.finish()
                finally:
                    st.close()
                ctx._count(ckpt_d2h_us=int(st.d2h_s * 1e6))
            finally:
                ctx.engine.unregister_file(fi)
        # durable before the rename: data, manifest, the directory entries
        _fsync_path(data_path)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        _fsync_path(os.path.join(tmp, "manifest.json"))
        _fsync_path(tmp)
        # the commit. Replacing a checkpoint keeps the old one live until
        # the new one is durable; a failed second rename rolls the old one
        # back. A hard crash between the two renames leaves it at
        # <dir>.old-<pid>, which last_committed() puts back
        if os.path.exists(directory):
            old = f"{directory}.old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(directory, old)
            try:
                os.rename(tmp, directory)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.rename(old, directory)
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_path(os.path.dirname(directory) or ".")
    # the committed path names a new inode: the context's fds and cached
    # bytes of an earlier checkpoint there must not serve a restore
    ctx.invalidate_file(os.path.join(directory, "data.bin"))
    return manifest


def load_manifest(directory: str) -> dict:
    p = os.path.join(directory, "manifest.json")
    try:
        with open(p) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CkptError(f"not a checkpoint: {p}: {e}") from None
    if manifest.get("format") != FORMAT:
        raise CkptError(f"unknown checkpoint format "
                        f"{manifest.get('format')!r} at {directory}")
    return manifest


def last_committed(directory: str) -> "tuple[str, dict] | None":
    """The committed checkpoint at *directory* as ``(path, manifest)``, or
    None. A restarted job calls this first: where a hard kill fell between
    the two renames of a replacing commit, *directory* is absent and the
    previous checkpoint sits at ``<dir>.old-<pid>``; it is renamed back."""
    directory = os.path.abspath(directory)
    try:
        return directory, load_manifest(directory)
    except CkptError:
        pass
    if not os.path.exists(directory):
        for old in sorted(glob.glob(f"{directory}.old-*")):
            try:
                manifest = load_manifest(old)
            except CkptError:
                continue
            os.rename(old, directory)
            return directory, manifest
    return None


def clean_orphans(directory: str) -> list[str]:
    """Remove the ``<dir>.tmp-*`` orphans of killed saves, and ``.old-*``
    copies a committed checkpoint makes redundant; returns the paths.
    Call it after :func:`last_committed`, which may need an ``.old-*``."""
    directory = os.path.abspath(directory)
    removed = []
    for p in sorted(glob.glob(f"{directory}.tmp-*")):
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    if os.path.isdir(directory):
        for p in sorted(glob.glob(f"{directory}.old-*")):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed


def _template_meta(t_leaf: Any) -> tuple[tuple[int, ...], str | None]:
    if isinstance(t_leaf, torch.Tensor):
        return tuple(t_leaf.shape), _dtype_name(t_leaf.dtype)
    if isinstance(t_leaf, (np.ndarray, np.generic)):
        return tuple(t_leaf.shape), t_leaf.dtype.name
    return tuple(np.shape(t_leaf)), None   # a Python scalar


def restore_checkpoint(ctx, directory: str, template: Any, *,
                       verify: bool = False) -> Any:
    """The tree saved at *directory*, shaped like *template*: its nesting
    and leaf shapes and dtypes, checked against the manifest. A tensor
    leaf is delivered by ``memcpy_ssd2gpu`` onto the template leaf's
    device (the card, unless the template's leaf is on the CPU); a numpy
    leaf by ``memcpy_ssd2host``; a Python scalar comes back as one.
    ``verify=True`` reads each leaf to the host first and checks its CRC32
    (:class:`CkptCorruptError`) before the bytes go to the device."""
    manifest = load_manifest(directory)
    t_leaves, treedef = tree_flatten(template)
    metas = manifest["leaves"]
    if len(t_leaves) != len(metas):
        raise CkptError(f"template has {len(t_leaves)} leaves, checkpoint "
                        f"has {len(metas)}")
    data_path = os.path.join(directory, "data.bin")
    out = []
    for meta, t_leaf in zip(metas, t_leaves):
        shape = tuple(meta["shape"])
        t_shape, t_dtype = _template_meta(t_leaf)
        if t_shape != shape:
            raise CkptError(f"leaf {meta['index']}: template shape "
                            f"{t_shape} != checkpoint {shape}")
        if t_dtype is not None and t_dtype != meta["dtype"]:
            raise CkptError(f"leaf {meta['index']}: template dtype "
                            f"{t_dtype} != checkpoint {meta['dtype']}")
        out.append(_restore_leaf(ctx, data_path, meta, t_leaf, verify))
    return tree_unflatten(treedef, out)


def _restore_leaf(ctx, data_path: str, meta: dict, t_leaf: Any,
                  verify: bool) -> Any:
    shape = tuple(meta["shape"])
    store = _storage_dtype(meta["dtype"])
    tensor = isinstance(t_leaf, torch.Tensor)
    if meta["nbytes"] == 0:
        host = np.empty(shape, dtype=store)
    elif verify:
        host = ctx.pread(data_path, offset=meta["offset"],
                         length=meta["nbytes"])
        crc = zlib.crc32(host) & 0xFFFFFFFF
        if crc != meta["crc32"]:
            raise CkptCorruptError(
                f"leaf {meta['index']} CRC mismatch at {data_path}"
                f"+{meta['offset']}: {crc:#010x} != {meta['crc32']:#010x}")
        host = host.view(store).reshape(shape)
    elif tensor:
        t = ctx.memcpy_ssd2gpu(data_path, offset=meta["offset"], shape=shape,
                               dtype=store, device=t_leaf.device)
        return t.view(_TORCH_DTYPES[meta["dtype"]])
    else:
        host = ctx.memcpy_ssd2host(data_path, offset=meta["offset"],
                                   shape=shape, dtype=store)
    if tensor:
        return torch.from_numpy(host).view(
            _TORCH_DTYPES[meta["dtype"]]).to(t_leaf.device)
    if isinstance(t_leaf, (np.ndarray, np.generic)):
        return host.view(t_leaf.dtype)
    # a Python scalar in the template (a step counter): the same kind back
    return host.reshape(()).item() if host.size else host


# -- the baseline a save is measured against ----------------------------------
def save_pickle(path: str, state: Any) -> int:
    """The pickle baseline: every leaf to the host (tensors as CPU
    tensors), ``pickle.dump`` through the page cache and fsync, the same
    durability. Returns bytes written."""
    leaves, treedef = _host_leaves(state)
    host = tree_unflatten(treedef, [leaf.obj for leaf in leaves])
    with open(path, "wb") as f:
        pickle.dump(host, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
