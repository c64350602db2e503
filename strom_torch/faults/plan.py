"""Seeded, rule-based fault plans (the port's copy of
``strom/faults/plan.py``): what fails, and when.

A :class:`FaultPlan` owns an ordered rule list and one seeded RNG. Every
submitted engine op is presented to :meth:`FaultPlan.decide` in
submission order; the first matching rule wins and returns a
:class:`Fault` describing the injection. All randomness (probability
draws, bit-flip positions) comes from the plan's RNG in op order, so the
same seed over the same op sequence injects the same fault sequence.

Plans load from three spellings (:meth:`FaultPlan.from_spec`,
``StromConfig.fault_plan``): a JSON file path, an inline JSON object
string, or a named preset ``"chaos[:seed]"`` (transient EIO, short reads
and latency spikes), ``"chaos_writes[:seed]"`` or ``"chaos_net[:seed]"``.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import json
import os
import random
from typing import Sequence
from strom_torch.utils.locks import make_lock

FAULT_KINDS = ("errno", "short_read", "bit_flip", "latency", "stuck",
               "engine_death", "hangup")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One matcher → injection rule.

    Matchers (all optional; unset = match everything):

    - ``path``: substring of the op's registered file path
    - ``tenant``: the active traced request's tenant
    - ``op``: ``"read"`` / ``"write"`` / ``"peer"`` — the op's kind (a
      direction-less rule matches everything, which is usually wrong for
      presets tuned against read traffic). ``bit_flip`` rules never match
      writes regardless: flipping the caller's source buffer would corrupt
      live training state, not the op. ``"peer"`` ops are the network
      fetches of the peer tier (``strom_torch/dist/peers.py``):
      ``errno`` reads as a refused connect, ``hangup`` as a mid-stream
      drop, ``short_read`` as a truncated frame and ``latency`` as a
      latency spike, all applied on the client's side, so the real outcome
      (a counted failure, the breaker fed, the engine's read) happens
      without damaging a live socket
    - ``offset_lo`` / ``offset_hi``: op byte range must OVERLAP [lo, hi)
    - ``op_lo`` / ``op_hi``: plan-global op-index window [lo, hi)
    - ``every``: inject on every Nth op that passes the matchers (0 = all)
    - ``p``: injection probability per matching op (plan RNG)
    - ``times``: cap on total injections from this rule

    Action parameters by ``kind``:

    - ``errno``: complete with ``-err`` (name like "EIO" or an int)
    - ``short_read``: deliver ``int(length * short_frac)`` bytes
    - ``bit_flip``: flip one RNG-chosen bit in the landed data
    - ``latency``: delay the (successful) completion by ``latency_s``
    - ``stuck``: swallow the completion — forever, or until ``release_s``
    - ``engine_death``: latch the whole engine dead; this and every later
      op completes ``-err`` instantly
    """

    kind: str
    path: "str | None" = None
    tenant: "str | None" = None
    op: "str | None" = None
    offset_lo: int = 0
    offset_hi: "int | None" = None
    op_lo: int = 0
    op_hi: "int | None" = None
    every: int = 0
    p: float = 1.0
    times: "int | None" = None
    err: int = _errno.EIO
    short_frac: float = 0.5
    latency_s: float = 0.05
    release_s: "float | None" = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.op not in (None, "read", "write", "peer"):
            raise ValueError(f"op matcher must be 'read', 'write', 'peer' "
                             f"or None, got {self.op!r}")
        if isinstance(self.err, str):
            object.__setattr__(self, "err",
                               getattr(_errno, self.err.upper()))
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        if not 0.0 <= self.short_frac < 1.0:
            raise ValueError("short_frac must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One decided injection (what the proxy applies to one op)."""

    kind: str
    rule_index: int
    err: int = _errno.EIO
    keep_bytes: int = 0          # short_read: bytes reported delivered
    flip_offset: int = 0         # bit_flip: byte offset within the op
    flip_mask: int = 1           # bit_flip: XOR mask
    latency_s: float = 0.0
    release_s: "float | None" = None


class FaultPlan:
    """Ordered rules + one seeded RNG; thread-safe, deterministic in op
    order. ``decide`` is the single choke point the proxy calls per
    submitted op."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = make_lock("faults.plan")
        self._op_index = 0
        self._matches = [0] * len(self.rules)
        self._injected = [0] * len(self.rules)
        self._by_kind: dict[str, int] = {}
        self.injected_total = 0
        self.dead = False          # engine_death latched
        self.dead_err = _errno.EIO

    # -- the decision point --------------------------------------------------
    def decide(self, *, path: "str | None", offset: int, length: int,
               tenant: "str | None" = None, op: str = "read"
               ) -> "Fault | None":
        with self._lock:
            idx = self._op_index
            self._op_index += 1
            if self.dead:
                self._count_locked(-1, "engine_death")
                return Fault("engine_death", -1, err=self.dead_err)
            for ri, r in enumerate(self.rules):
                if r.path is not None and (path is None
                                           or r.path not in path):
                    continue
                if r.tenant is not None and tenant != r.tenant:
                    continue
                # direction matcher: a read-scoped rule must not fire on
                # (or consume RNG draws for) write traffic. A bit_flip can
                # never apply to a write: the flip would land in the
                # caller's source buffer (live training state).
                if r.op is not None and r.op != op:
                    continue
                if r.kind == "bit_flip" and op == "write":
                    continue
                if idx < r.op_lo or (r.op_hi is not None and idx >= r.op_hi):
                    continue
                hi = r.offset_hi
                if offset + length <= r.offset_lo \
                        or (hi is not None and offset >= hi):
                    continue
                self._matches[ri] += 1
                if r.every > 0 and self._matches[ri] % r.every != 0:
                    continue
                if r.times is not None and self._injected[ri] >= r.times:
                    continue
                # the draw happens for every p<1 rule evaluation that got
                # this far — in op order, from the plan RNG, so the whole
                # injected sequence is a pure function of (seed, op stream)
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                return self._build_locked(ri, r, offset, length)
            return None

    def _build_locked(self, ri: int, r: FaultRule, offset: int,
                      length: int) -> Fault:
        self._injected[ri] += 1
        self._count_locked(ri, r.kind)
        if r.kind == "engine_death":
            self.dead = True
            self.dead_err = r.err
            return Fault("engine_death", ri, err=r.err)
        if r.kind == "errno":
            return Fault("errno", ri, err=r.err)
        if r.kind == "short_read":
            # at least 1 byte short, never the full length
            keep = min(int(length * r.short_frac), max(length - 1, 0))
            return Fault("short_read", ri, keep_bytes=keep)
        if r.kind == "bit_flip":
            return Fault("bit_flip", ri,
                         flip_offset=self._rng.randrange(max(length, 1)),
                         flip_mask=1 << self._rng.randrange(8))
        if r.kind == "latency":
            return Fault("latency", ri, latency_s=r.latency_s)
        if r.kind == "hangup":
            # peer-op kind: the connection drops mid-stream.
            # Presented to an ENGINE op (a direction-less rule) it
            # degrades to a plain transient errno — engines have no
            # stream to hang up.
            return Fault("hangup", ri, err=r.err)
        return Fault("stuck", ri, release_s=r.release_s)

    def _count_locked(self, ri: int, kind: str) -> None:
        self.injected_total += 1
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1

    def unwind(self, fault: Fault) -> None:
        """Roll back one decided injection whose op never reached the
        engine (a queue-full partial accept, faults/proxy.py): the
        rule's times-cap and the injected tallies un-count it, so the
        caller's replay of that op re-decides against an unspent budget
        and the stats report only faults actually applied. RNG draws are
        not rewound — a queue-full replay shifts the op stream itself,
        which the determinism contract scopes out."""
        with self._lock:
            if 0 <= fault.rule_index < len(self._injected):
                self._injected[fault.rule_index] -= 1
            self.injected_total -= 1
            if self._by_kind.get(fault.kind):
                self._by_kind[fault.kind] -= 1
            if fault.kind == "engine_death":
                self.dead = False

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "ops_seen": self._op_index,
                    "faults_injected": self.injected_total,
                    "engine_dead": self.dead,
                    "by_kind": dict(self._by_kind),
                    "per_rule": list(self._injected)}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_doc(cls, doc: dict) -> "FaultPlan":
        rules = [FaultRule(**r) for r in doc.get("rules", ())]
        return cls(rules, seed=int(doc.get("seed", 0)))

    @classmethod
    def chaos(cls, seed: int = 0) -> "FaultPlan":
        """The chaos bench arm's preset: transient EIO + short reads +
        latency spikes at rates the retry/hedge machinery must absorb
        with bit-identical output and bounded slowdown. No engine_death
        or stuck rules — those are for targeted tests, not a throughput
        arm. Rules are pinned ``op="read"``: the preset's
        rates were tuned against read streams, and an unpinned rule
        would silently double-count the moment write traffic (checkpoint
        saves, cache spill) shares the engine. Chaos the write path with
        :meth:`chaos_writes` or an explicit plan."""
        return cls([
            FaultRule("errno", op="read", p=0.02, err=_errno.EIO),
            FaultRule("short_read", op="read", p=0.01, short_frac=0.5),
            FaultRule("latency", op="read", p=0.02, latency_s=0.005),
        ], seed=seed)

    @classmethod
    def chaos_writes(cls, seed: int = 0) -> "FaultPlan":
        """Write-path chaos: transient EIO + short writes at
        rates the write retry machinery must absorb with bit-identical
        on-disk bytes (read-back verified by the tests/bench). No
        bit_flip — it can never apply to writes (see FaultRule)."""
        return cls([
            FaultRule("errno", op="write", p=0.02, err=_errno.EIO),
            FaultRule("short_read", op="write", p=0.02, short_frac=0.5),
        ], seed=seed)

    @classmethod
    def chaos_net(cls, seed: int = 0) -> "FaultPlan":
        """Network chaos for the distributed data plane (kept for parity:
        the port has no peer tier yet): refused connects, mid-stream
        hangups, latency spikes
        and truncated frames on the PEER fetch stream, at rates the peer
        tier must absorb with bit-identical batches — every injected
        failure falls back to the local engine read, so the only visible
        cost is rate. Rules are pinned ``op="peer"``: engine read/write
        traffic sharing the plan consumes no draws from (and is never hit
        by) the network rules, the same isolation the ``chaos`` preset's
        ``op="read"`` pin provides."""
        return cls([
            FaultRule("errno", op="peer", p=0.05, err=_errno.ECONNREFUSED),
            FaultRule("hangup", op="peer", p=0.03),
            FaultRule("latency", op="peer", p=0.05, latency_s=0.005),
            FaultRule("short_read", op="peer", p=0.03, short_frac=0.5),
        ], seed=seed)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """``StromConfig.fault_plan`` resolver: a JSON
        file path, an inline JSON object, or a named preset —
        ``chaos[:seed]`` / ``chaos_writes[:seed]`` / ``chaos_net[:seed]``."""
        spec = spec.strip()
        if not spec:
            raise ValueError("empty fault-plan spec")
        if spec == "chaos" or spec.startswith("chaos:"):
            seed = int(spec.split(":", 1)[1]) if ":" in spec else 0
            return cls.chaos(seed)
        if spec == "chaos_writes" or spec.startswith("chaos_writes:"):
            seed = int(spec.split(":", 1)[1]) if ":" in spec else 0
            return cls.chaos_writes(seed)
        if spec == "chaos_net" or spec.startswith("chaos_net:"):
            seed = int(spec.split(":", 1)[1]) if ":" in spec else 0
            return cls.chaos_net(seed)
        if spec.lstrip().startswith("{"):
            return cls.from_doc(json.loads(spec))
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_doc(json.load(f))
        raise ValueError(f"fault plan {spec!r}: not a preset, inline JSON, "
                         "or readable file")
