"""Multi-tenant I/O scheduler (the port's copy of ``strom/sched/``).

One engine, many consumers: per-tenant queues with priority classes,
weighted fair drain at slice granularity, byte/IOPS budgets and slab-pool
admission control. :mod:`strom_torch.sched.scheduler` is the arbiter,
:mod:`strom_torch.sched.budget` the enforcement primitives and
:mod:`strom_torch.sched.tenant` the tenant handle.
"""

from strom_torch.sched.budget import AdmissionGate, TokenBucket
from strom_torch.sched.scheduler import SCHED_FIELDS, IoScheduler
from strom_torch.sched.tenant import PRIORITIES, Tenant

__all__ = ["AdmissionGate", "IoScheduler", "PRIORITIES", "SCHED_FIELDS",
           "Tenant", "TokenBucket"]
