"""Pre-decoded image shards: decode once offline, train decode-free (the
port's copy of ``strom/formats/predecoded.py``).

A shard is a flat array of ``HxWx3`` uint8 records plus a small labels
sidecar, so the training loader is a pure engine gather and one
host-to-device copy per batch, the mechanics of the packed-token Llama
loader, with no JPEG decoder on the training host at all.

On-disk layout for ``foo.pdec``:
  foo.pdec             packed records, record = image_size*image_size*3 bytes
  foo.pdec.labels.npy  int32 [n] labels, loaded whole at pipeline build
  foo.pdec.meta.json   {"image_size": S, "n": N} (checked at load)
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Sequence

import numpy as np

from strom_torch.delivery.extents import ExtentList
from strom_torch.formats.rawbin import TokenShardSet

LABELS_SUFFIX = ".labels.npy"
META_SUFFIX = ".meta.json"


def predecode_wds(ctx, tar_paths: Sequence[str], out_path: str, *,
                  image_size: int,
                  image_ext: str = "jpg",
                  label_ext: str = "cls",
                  decode_workers: int = 8) -> str:
    """Decode every sample of the WebDataset *tar_paths* once, resize to
    ``image_size`` (center crop: deterministic, augmentation belongs to
    training) and write the packed shard at *out_path*. Reads go through
    the engine (striped aliases included). Returns *out_path*."""
    from strom_torch.formats.jpeg import (DecodePool, center_crop_resize,
                                          decode_jpeg)
    from strom_torch.formats.wds import WdsShardSet

    ss = WdsShardSet(tar_paths, ctx=ctx)
    record_bytes = image_size * image_size * 3
    labels = np.zeros(len(ss), dtype=np.int32)

    def decode_one(blob: np.ndarray) -> np.ndarray:
        return center_crop_resize(decode_jpeg(blob), image_size)

    with DecodePool(decode_workers) as pool, open(out_path + ".tmp", "wb") as f:
        batch = 64
        for lo in range(0, len(ss), batch):
            idxs = list(range(lo, min(lo + batch, len(ss))))
            buf = ctx.pread(ss.batch_extents(idxs, [image_ext, label_ext]))
            blobs, pos = [], 0
            for i in idxs:
                s = ss.samples[i]
                isz = s.members[image_ext].size
                lsz = s.members[label_ext].size
                blobs.append(buf[pos: pos + isz])
                labels[i] = int(buf[pos + isz: pos + isz + lsz].tobytes()
                                or b"0")
                pos += isz + lsz
            for img in pool.map(decode_one, blobs):
                if img.nbytes != record_bytes:
                    raise ValueError(f"decoded record of {img.nbytes} bytes, "
                                     f"expected {record_bytes}")
                f.write(np.ascontiguousarray(img).tobytes())
    # The sidecars are staged under .tmp names and renamed only after the
    # records (records first): a crash anywhere leaves either the complete
    # old triple, or new records with old sidecars, never old records with
    # new labels. The loader catches the second case whenever the record
    # count changed (its per-shard labels-length check).
    np.save(out_path + LABELS_SUFFIX + ".tmp.npy", labels)
    with open(out_path + META_SUFFIX + ".tmp", "w") as f:
        json.dump({"image_size": image_size, "n": len(ss)}, f)
    os.replace(out_path + ".tmp", out_path)
    os.replace(out_path + LABELS_SUFFIX + ".tmp.npy", out_path + LABELS_SUFFIX)
    os.replace(out_path + META_SUFFIX + ".tmp", out_path + META_SUFFIX)
    return out_path


def stage_striped_predecoded(ctx, pdec: str, members: Sequence[str],
                             chunk: int, virt: str | None = None, *,
                             stripe: bool = True) -> str:
    """Stripe the packed shard *pdec* over *members* RAID0-style (skip with
    ``stripe=False`` when the members are already fresh), register the
    alias, and copy the sidecars to alias names so
    :class:`PredecodedShardSet` finds them. Returns the alias path."""
    from strom_torch.engine.raid0 import stripe_file

    virt = virt or pdec + ".raid0"
    if stripe:
        stripe_file(pdec, list(members), chunk)
    ctx.register_striped(virt, list(members), chunk,
                         size=os.path.getsize(pdec))
    for sfx in (LABELS_SUFFIX, META_SUFFIX):
        shutil.copyfile(pdec + sfx, virt + sfx)
    return virt


@dataclasses.dataclass(frozen=True)
class PredecodedShardSet:
    """Pre-decoded image shards addressed as one global record array.

    Record addressing and gather planning are the packed-token layout's
    (:class:`TokenShardSet` with uint8 pixel records); labels live on the
    host. *paths* may be striped-set aliases: pass ``shard_sizes`` with the
    logical sizes and keep the sidecars at the alias names."""

    paths: tuple[str, ...]
    image_size: int
    shard_sizes: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "paths", tuple(self.paths))
        for p in self.paths:
            meta = None
            try:
                with open(p + META_SUFFIX) as f:
                    meta = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass  # the meta sidecar is advisory; record math is the contract
            if meta is not None and meta.get("image_size") != self.image_size:
                raise ValueError(
                    f"{p}: predecoded at image_size {meta.get('image_size')},"
                    f" loader wants {self.image_size}")
        inner = TokenShardSet(self.paths, record_tokens=self.record_bytes,
                              dtype=np.dtype(np.uint8),
                              shard_sizes=self.shard_sizes)
        object.__setattr__(self, "_inner", inner)
        labels = []
        for i, p in enumerate(self.paths):
            lp = p + LABELS_SUFFIX
            if not os.path.exists(lp):
                # refusing beats silently training against label 0
                raise FileNotFoundError(
                    f"{p}: labels sidecar {lp} is missing — re-run "
                    f"predecode_wds (records and labels are written together)")
            arr = np.load(lp).astype(np.int32)
            n_records = inner.records_in_shard(i)
            if len(arr) != n_records:
                # a predecode cut between the records rename and the
                # sidecar renames: new records, stale labels
                raise ValueError(
                    f"{p}: labels sidecar has {len(arr)} entries but the "
                    f"records file holds {n_records} records — sidecars are "
                    f"stale; re-run predecode_wds")
            labels.append(arr)
        object.__setattr__(self, "_labels", np.concatenate(labels)
                           if labels else np.zeros(0, np.int32))

    @property
    def record_bytes(self) -> int:
        return self.image_size * self.image_size * 3

    @property
    def num_records(self) -> int:
        return self._inner.num_records  # type: ignore[attr-defined]

    def labels(self, records: Sequence[int]) -> np.ndarray:
        return self._labels[np.asarray(records, dtype=np.int64)]  # type: ignore[attr-defined]

    def extents(self, records: Sequence[int]) -> ExtentList:
        return self._inner.extents(records)  # type: ignore[attr-defined]
