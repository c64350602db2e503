"""The distributed data plane (the port's counterpart of ``strom/dist``).

- :mod:`strom_torch.dist.peers`: the peer extent service. Each host runs
  a small threaded TCP server exporting its hot-cache and spill extents by
  their host-stable ``(path, physical offset)`` keys, and the delivery
  consult gains a peer tier probed after local RAM and spill and before
  the engine: a host that holds an extent hot serves it to its peers over
  the socket instead of every host reading it from the SSD again. The
  wire is the reference's, byte for byte.
- :mod:`strom_torch.dist.directory`: the consistent-hash owner map, with
  membership epochs that re-own a dead host's keys.
- :mod:`strom_torch.dist.launch`: the launcher and the worker: N
  processes, each owning a deterministic shard of the dataset and a
  context of its own, assembling its slice of every global batch in host
  memory (host mode) or on its card through ``memcpy_ssd2gpu(sharding=)``
  over ``torch.distributed`` (mesh mode).
"""

from strom_torch.dist.directory import ExtentDirectory, HashRing
from strom_torch.dist.peers import (DIST_BENCH_FIELDS, DIST_FIELDS, PeerServer,
                                    PeerTier)

__all__ = ["DIST_FIELDS", "DIST_BENCH_FIELDS", "ExtentDirectory",
           "HashRing", "PeerServer", "PeerTier"]
