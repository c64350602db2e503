"""Closed-loop knob autotuner (the port's copy of ``strom/tune/``).

An :class:`Autotuner` runs coordinate descent over live knob surfaces
(prefetch depth, the scheduler's slice bytes, the hot-cache budget, the
decode pool's run target, the readahead window) against an objective
(goodput, items/s), with a guarded revert and a hold while any tenant's SLO
burns. A :class:`Profile` keeps the converged values as JSON so the next
run starts there.
"""

from strom_torch.tune.autotuner import (TUNE_BENCH_FIELDS, TUNE_FIELDS,
                                        Autotuner, Profile,
                                        stall_weighted_metrics)
from strom_torch.tune.knobs import Knob, prefetcher_knob, standard_knobs

__all__ = ["Autotuner", "Knob", "Profile", "TUNE_BENCH_FIELDS",
           "TUNE_FIELDS", "prefetcher_knob", "stall_weighted_metrics",
           "standard_knobs"]
