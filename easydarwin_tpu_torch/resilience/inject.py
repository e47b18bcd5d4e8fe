"""Deterministic fault injection — chaos as a regression test.

A :class:`FaultPlan` is a small, seeded description of *which* faults to
provoke and *how often*; the process-wide :data:`INJECTOR` executes it at
the sites the relay hot path exposes:

==================  ====================================================
site                where it bites
==================  ====================================================
``ingest_drop``     ``RelayStream.push_rtp`` discards the packet
``ingest_reorder``  push_rtp holds one packet and releases it after the
                    next (adjacent swap — the classic UDP reorder)
``ingest_corrupt``  one payload byte (never the 12-byte header) flipped
``egress_native``   ``csrc`` ``ed_fault_*`` knobs: every Nth native send
                    call fails EAGAIN / ENOBUFS, or sleeps a latency
                    spike before the syscall
``device_dispatch`` the engine/megabatch device query raises
                    :class:`InjectedFault` (a transient device error)
``stale_params``    the engine's cached affine params / megabatch
                    override are invalidated, forcing the slow path
``slow_subscriber`` a Python-path output write reports WOULD_BLOCK
                    (bookmark replay backpressure)
==================  ====================================================

**Determinism.**  Probability sites draw from per-site
``random.Random(seed ^ crc32(site))`` streams, so the decision sequence
for one site depends only on the plan seed and that site's call count —
never on how calls to *other* sites interleave.  Every-N sites are plain
counters.  ``tests/test_torch_resilience.py`` pins same-seed → same-schedule.

**Observability.**  Every injection counts into
``fault_injected_total{site}`` and emits a rate-limited ``fault.injected``
event (one per site per second, carrying the count accumulated since the
last emit) — so a flight-recorder dump shows the cause next to the
effect without the event ring drowning in per-packet records.  The
native-egress injections are counted by the C side into
``ed_stats.fault_injections`` and mirrored by the scrape collector.

The same plan and seed give the same fires at every site as the
reference package's injector (the streams, counters and draws are the
same), so a chaos schedule replays across the two.  Sites with no call
site yet in this package (``lease_loss``, ``redis_partition``,
``pull_stall``, ``capacity_spoof``, ``overload_spoof``: the cluster tier
and the admission gate) keep their own streams, so they shift no other
site's schedule.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass, fields, replace

from .. import obs

#: the closed injection-site vocabulary (the ``site`` label of
#: ``fault_injected_total``; ``egress_native`` is counted by csrc).
#: The cluster sites: ``lease_loss`` deletes this node's own
#: Redis lease mid-heartbeat (a simulated TTL expiry — peers adopt its
#: streams), ``redis_partition`` makes a cluster tick's Redis access
#: time out, ``pull_stall`` freezes a cross-server pull's read loop so
#: the retry/backoff envelope must recover it.
#: The receiver-side sites: ``egress_drop`` silently loses a
#: Python-path delivered packet AFTER the send accounting (the wire ate
#: it — the reliability tier must notice via RR/NACK, never the
#: sender's counters), and ``rr_loss_spoof`` replaces the
#: ``fraction_lost`` of every inbound receiver report so the closed-
#: loop FEC controller can be driven without a lossy wire.
#: The control-plane sites: ``capacity_spoof`` replaces the
#: capacity score a node believes in and publishes (lie low → the node
#: over-reports utilization, burns, and the rebalancer/admission paths
#: fire; lie high → it hoards keyspace on the weighted ring), and
#: ``overload_spoof`` forces an admission check to read past the
#: high-water mark (seeded probability stream) so the 453/redirect
#: paths are chaos-testable without real load.
SITES = ("ingest_drop", "ingest_reorder", "ingest_corrupt",
         "egress_native", "device_dispatch", "stale_params",
         "slow_subscriber", "lease_loss", "redis_partition",
         "pull_stall", "egress_drop", "rr_loss_spoof",
         "capacity_spoof", "overload_spoof")

#: minimum seconds between ``fault.injected`` events per site
EMIT_INTERVAL_S = 1.0


class InjectedFault(RuntimeError):
    """A deliberately provoked transient failure (device dispatch)."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, config-driven fault schedule.

    Zero means "site disabled".  Parse from the ``resilience_fault_plan``
    config key / ``--chaos`` spec with :meth:`parse` (``k=v`` pairs,
    comma-separated): ``"seed=7,ingest_drop=0.05,egress_enobufs_every=300"``.
    """

    seed: int = 0
    # -- ingest (probability per packet) ---------------------------------
    ingest_drop: float = 0.0
    ingest_reorder: float = 0.0
    ingest_corrupt: float = 0.0
    # -- native egress (deterministic every-N send calls; csrc knobs) ----
    egress_eagain_every: int = 0
    egress_enobufs_every: int = 0
    egress_latency_every: int = 0
    egress_latency_us: int = 0
    # -- device tier -----------------------------------------------------
    device_error_every: int = 0        # every Nth device dispatch raises
    device_error_period_s: float = 0.0  # … or at most one per period
    stale_params_every: int = 0
    # -- subscriber backpressure (deterministic: every Nth python-path
    # write reports WOULD_BLOCK; 0.05 is NOT a probability — it coerces
    # to 0 and disables the site) ----------------------------------------
    slow_sub_every: int = 0
    # -- cluster tier (deterministic every-N; see SITES above) -----------
    lease_loss_every: int = 0          # Nth heartbeat finds the lease gone
    redis_partition_every: int = 0     # Nth cluster tick's Redis times out
    pull_stall_every: int = 0          # Nth pull liveness probe stalls
    # -- receiver-side loss: probability a delivered Python-
    # path packet is silently lost after send accounting; the spoofed
    # fraction_lost (0..1) stamped onto every inbound RR while armed ---
    egress_drop: float = 0.0
    rr_loss_spoof: float = 0.0
    # -- control plane: the capacity score this node believes
    # in and publishes is REPLACED by this value when > 0 (deterministic
    # — the skewed soak forces a heterogeneous cluster with it); the
    # probability an admission check reads "past the high-water mark"
    # regardless of real utilization -------------------------------------
    capacity_spoof: float = 0.0
    overload_spoof: float = 0.0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``k=v,k=v`` → FaultPlan; unknown keys raise (a typo'd chaos
        plan that silently injects nothing is worse than an error)."""
        plan = cls()
        if not spec.strip():
            return plan
        types = {f.name: f.type for f in fields(cls)}
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in types:
                raise ValueError(f"unknown fault-plan key {k!r} "
                                 f"(known: {sorted(types)})")
            kw[k] = float(v) if types[k] == "float" else int(float(v))
        return replace(plan, **kw)

    def to_spec(self) -> str:
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            if v:
                out.append(f"{f.name}={v}")
        return ",".join(out)

    def any_active(self) -> bool:
        return any(getattr(self, f.name) for f in fields(self)
                   if f.name != "seed")


class FaultInjector:
    """Executes one :class:`FaultPlan`; disabled (``active=False``) by
    default so the hot-path hooks cost one attribute check."""

    def __init__(self, *, events=None, counter=None, clock=time.monotonic):
        self.plan: FaultPlan | None = None
        self.active = False
        self._clock = clock
        self._events = events if events is not None else obs.EVENTS
        self._counter = counter if counter is not None \
            else obs.FAULT_INJECTED
        self._rng: dict[str, random.Random] = {}
        self._count: dict[str, int] = {}
        self._last_emit: dict[str, float] = {}
        self._pending: dict[str, int] = {}     # injections since last emit
        #: None = the period timer starts EXPIRED (the first dispatch
        #: after arming fires, then one per period — "one failure per
        #: minute" means the minute starts with one, not after one)
        self._last_device_error: float | None = None

    # -- lifecycle --------------------------------------------------------
    def arm(self, plan: FaultPlan) -> None:
        """Install a plan and reset every deterministic stream — arming
        the same seed twice replays the identical schedule."""
        self.plan = plan
        self._rng = {s: random.Random((plan.seed << 16)
                                      ^ zlib.crc32(s.encode()))
                     for s in SITES}
        self._count = {s: 0 for s in SITES}
        self._pending = {}
        self._last_emit = {}
        self._last_device_error = None
        self._push_native(plan)
        self.active = plan.any_active()

    def disarm(self) -> None:
        self.plan = None
        self.active = False
        self._push_native(None)

    @staticmethod
    def _push_native(plan: FaultPlan | None) -> None:
        """Mirror the egress knobs into the egress core
        (``ed_fault_set``/``ed_fault_clear``).  A plan that actually uses
        them FORCE-LOADS the library (arming chaos is an explicit
        operator action, and the server arms before anything else has
        touched native — a loaded()-only check would silently leave the
        egress fault-free for the whole run); plans without egress knobs
        and disarms never trigger a load/build."""
        from .. import native
        if plan is not None and (plan.egress_eagain_every
                                 or plan.egress_enobufs_every
                                 or plan.egress_latency_every):
            if not native.available():
                return                 # no native core: knobs can't bite
            native.fault_set(plan.egress_eagain_every,
                             plan.egress_enobufs_every,
                             plan.egress_latency_every,
                             plan.egress_latency_us)
            return
        if native.loaded():
            native.fault_clear()

    # -- accounting -------------------------------------------------------
    def _note(self, site: str, n: int = 1) -> None:
        self._count[site] = self._count.get(site, 0) + n
        self._counter.inc(n, site=site)
        self._pending[site] = self._pending.get(site, 0) + n
        now = self._clock()
        if now - self._last_emit.get(site, 0.0) >= EMIT_INTERVAL_S:
            self._last_emit[site] = now
            self._events.emit("fault.injected", site=site,
                              count=self._pending.pop(site, 0))

    def counts(self) -> dict[str, int]:
        """Injections per site (the ``_<site>_calls`` attempt counters
        the every-N streams keep are internal and excluded)."""
        return {k: v for k, v in self._count.items()
                if not k.startswith("_")}

    # -- decision streams -------------------------------------------------
    def _fire(self, site: str, prob: float) -> bool:
        if prob <= 0.0:
            return False
        return self._rng[site].random() < prob

    def _every(self, site: str, n: int) -> bool:
        if n <= 0:
            return False
        c = self._count.get(f"_{site}_calls", 0) + 1
        self._count[f"_{site}_calls"] = c
        return c % n == 0

    # -- sites ------------------------------------------------------------
    def ingest(self, packet: bytes, hold: list) -> list[bytes]:
        """The ingest gauntlet: returns the packets to actually push
        (possibly empty for a drop/hold, possibly two for a release).

        ``hold`` is the CALLER-owned one-slot reorder buffer (the stream
        passes its own) — a held packet must die with its stream, never
        sit in an injector-side map where a recycled ``id()`` could
        release it into an unrelated stream's ring (the same id-reuse
        hazard the megabatch cursor pruning guards against)."""
        p = self.plan
        if p is None:
            return [packet]
        if self._fire("ingest_drop", p.ingest_drop):
            self._note("ingest_drop")
            return []
        if p.ingest_corrupt and len(packet) > 12 \
                and self._fire("ingest_corrupt", p.ingest_corrupt):
            rng = self._rng["ingest_corrupt"]
            off = 12 + rng.randrange(len(packet) - 12)
            mut = bytearray(packet)
            mut[off] ^= 0xFF
            self._note("ingest_corrupt")
            packet = bytes(mut)
        if p.ingest_reorder:
            if hold:
                return [packet, hold.pop()]    # adjacent swap completes
            if self._fire("ingest_reorder", p.ingest_reorder):
                self._note("ingest_reorder")
                hold.append(packet)            # held for the next push
                return []
        return [packet]

    def ingest_ring(self, ring, start: int, stop: int) -> None:
        """The ingest gauntlet for natively-drained packets (recvmmsg
        lands them straight in ring slots, so faults mutate in place):
        a drop zeroes the slot's length+flags — downstream treats it as
        a runt and never relays it; corruption flips one payload byte.
        Reorder only exists on the push path (slots are already
        sequenced by the time the drain returns).  Draws from the SAME
        per-site streams as the push path."""
        p = self.plan
        if p is None or not (p.ingest_drop or p.ingest_corrupt):
            return
        for pid in range(start, stop):
            s = ring.slot(pid)
            if self._fire("ingest_drop", p.ingest_drop):
                ring.length[s] = 0
                ring.flags[s] = 0
                self._note("ingest_drop")
                continue
            n = int(ring.length[s])
            if n > 12 and self._fire("ingest_corrupt", p.ingest_corrupt):
                off = 12 + self._rng["ingest_corrupt"].randrange(n - 12)
                ring.data[s, off] ^= 0xFF
                self._note("ingest_corrupt")

    def device_dispatch(self, where: str) -> None:
        """Raises :class:`InjectedFault` when a device-dispatch failure
        is due (count-based ``device_error_every`` OR at most one per
        ``device_error_period_s``)."""
        p = self.plan
        if p is None:
            return
        due = self._every("device_dispatch", p.device_error_every)
        if not due and p.device_error_period_s > 0:
            now = self._clock()
            if (self._last_device_error is None
                    or now - self._last_device_error
                    >= p.device_error_period_s):
                self._last_device_error = now
                due = True
        if due:
            self._note("device_dispatch")
            raise InjectedFault(f"injected device-dispatch failure "
                                f"at {where}")

    def stale_params(self) -> bool:
        p = self.plan
        if p is None or not self._every("stale_params",
                                        p.stale_params_every):
            return False
        self._note("stale_params")
        return True

    def slow_subscriber(self) -> bool:
        p = self.plan
        if p is None or not self._every("slow_subscriber",
                                        p.slow_sub_every):
            return False
        self._note("slow_subscriber")
        return True

    def egress_drop(self) -> bool:
        """True when a delivered Python-path packet should be silently
        lost (receiver-side loss synthesized without touching the wire;
        the seeded per-site stream makes one seed = one loss schedule).
        Consumed by ``RelayOutput.write_rtp``/``send_rewritten`` AND by
        harness-side receivers (the lossy soak player) — each caller
        owns its own armed injector, so schedules never interleave."""
        p = self.plan
        if p is None or not self._fire("egress_drop", p.egress_drop):
            return False
        self._note("egress_drop")
        return True

    def rr_loss_spoof(self) -> float | None:
        """The spoofed ``fraction_lost`` (0..1) to stamp onto an inbound
        receiver report, or None when the site is disarmed — drives the
        closed-loop FEC controller without a lossy wire."""
        p = self.plan
        if p is None or p.rr_loss_spoof <= 0.0:
            return None
        self._note("rr_loss_spoof")
        return min(p.rr_loss_spoof, 1.0)

    def capacity_spoof(self) -> float | None:
        """The lying capacity score (pps) to believe in and publish, or
        None when the site is disarmed.  Counted once per application
        (one per load sample — the heartbeat cadence)."""
        p = self.plan
        if p is None or p.capacity_spoof <= 0.0:
            return None
        self._note("capacity_spoof")
        return float(p.capacity_spoof)

    def overload_spoof(self) -> bool:
        """True when this admission check should read the node as past
        its high-water mark (seeded per-site probability stream — one
        seed = one refusal schedule)."""
        p = self.plan
        if p is None or not self._fire("overload_spoof", p.overload_spoof):
            return False
        self._note("overload_spoof")
        return True

    # -- cluster sites ----------------------------------------------------
    def lease_loss(self) -> bool:
        """True when this heartbeat should find its lease gone (the
        caller deletes its own lease key — indistinguishable from a TTL
        expiry to every peer)."""
        p = self.plan
        if p is None or not self._every("lease_loss", p.lease_loss_every):
            return False
        self._note("lease_loss")
        return True

    def redis_partition(self) -> bool:
        """True when this cluster tick's Redis access should time out."""
        p = self.plan
        if p is None or not self._every("redis_partition",
                                        p.redis_partition_every):
            return False
        self._note("redis_partition")
        return True

    def pull_stall(self) -> bool:
        """True when a cross-server pull's liveness probe should treat
        the upstream as stalled (forcing the retry envelope)."""
        p = self.plan
        if p is None or not self._every("pull_stall", p.pull_stall_every):
            return False
        self._note("pull_stall")
        return True


#: process-wide injector; ``active`` stays False until a plan is armed,
#: so the relay hot-path hooks cost one attribute check per call
INJECTOR = FaultInjector()
