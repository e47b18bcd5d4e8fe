"""Cross-server pull relay with a full retry/timeout/backoff envelope.

A subscriber that lands on a non-owner node is served locally from a
pull session against the stream's owner (``relay/pull.py`` — the node
acts as an RTSP player toward the owner and re-publishes under the same
path).  The bare ``PullRelay`` dies with its upstream; this module wraps
it in the envelope cluster service needs:

* **connect/read timeouts** — a wedged upstream TCP connect or a feed
  that stops producing packets (``read_timeout_sec`` with no packet
  growth) is detected and the attempt abandoned;
* **capped exponential backoff with jitter** — every restart waits
  ``backoff_ms * 2^attempt`` (capped), multiplied by a seeded ±jitter so
  N nodes re-pulling one recovered owner don't stampede in lockstep;
* **circuit breaker** — ``breaker_failures`` consecutive failures open
  the breaker for ``breaker_open_sec`` (no connect attempts at all),
  then a half-open probe either closes it or re-opens;
* **owner re-resolution** — every attempt re-resolves the owner URL
  against Redis placement, so a migrated stream is re-pulled from its
  NEW owner without operator action;
* **failure hook** — each failure reports through ``on_failure(path,
  injected)``, ``injected`` True for an injected ``pull_stall`` (the
  app counts every one and charges only an injected one to the
  degradation ladder's ``pull_errors``: a network failure is not device
  health); the envelope re-owns the relay session so an upstream EOF
  never tears down the local subscribers.

Counted: ``cluster_pull_retries_total``,
``cluster_pull_breaker_open_total``; events ``cluster.pull_retry`` /
``cluster.breaker_open`` / ``cluster.breaker_close``.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass

from .. import obs


@dataclass(frozen=True)
class PullConfig:
    """Mirrored 1:1 from the ``cluster_pull_*`` ServerConfig keys."""

    connect_timeout_sec: float = 5.0
    read_timeout_sec: float = 5.0     # no upstream packet for this = stall
    backoff_ms: float = 200.0         # first retry backoff (doubles, capped)
    backoff_cap_ms: float = 5000.0
    jitter_frac: float = 0.25         # ± fraction applied to each delay
    breaker_failures: int = 5         # consecutive failures → open
    breaker_open_sec: float = 10.0    # open window before half-open probe


class Backoff:
    """Capped exponential backoff with seeded ± jitter (deterministic
    schedule per seed — pinned by tests)."""

    def __init__(self, config: PullConfig, seed: int = 0):
        self.config = config
        self.attempt = 0
        self._rng = random.Random(seed)

    def next_delay(self) -> float:
        cfg = self.config
        # exponent clamped: an hours-long outage must not overflow the
        # float multiply and kill the restart loop it paces
        base = min(cfg.backoff_ms * (2 ** min(self.attempt, 32)),
                   cfg.backoff_cap_ms) / 1000.0
        self.attempt += 1
        if cfg.jitter_frac > 0:
            base *= 1.0 + self._rng.uniform(-cfg.jitter_frac,
                                            cfg.jitter_frac)
        return max(base, 0.0)

    def reset(self) -> None:
        self.attempt = 0


class CircuitBreaker:
    """closed → (N consecutive failures) → open → (open window) →
    half-open probe → closed | open."""

    def __init__(self, failures: int, open_sec: float, *,
                 clock=time.monotonic):
        self.threshold = max(1, failures)
        self.open_sec = open_sec
        self._clock = clock
        self.failures = 0
        self.state = "closed"
        self.opened = 0              # open transitions (mirrors counter)
        self._open_until = 0.0

    def allow(self, now: float | None = None) -> bool:
        if self.state != "open":
            return True
        now = self._clock() if now is None else now
        if now >= self._open_until:
            self.state = "half_open"    # one probe in flight
            return True
        return False

    def success(self) -> None:
        self.failures = 0
        self.state = "closed"

    def failure(self, now: float | None = None) -> bool:
        """Record one failure; True when this failure OPENED (or
        re-opened) the breaker."""
        now = self._clock() if now is None else now
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self._open_until = now + self.open_sec
            self.failures = 0
            self.opened += 1
            return True
        return False


class RemotePull:
    """One locally-served remote stream: owns the restart loop around
    ``PullRelayManager`` for one path."""

    #: seconds between upstream freshness polls (GET_PARAMETER
    #: x-freshness on the live pull connection) — the chain feeds
    #: relay_e2e_freshness_seconds{hops} and the fleet rollup
    FRESHNESS_POLL_SEC = 1.0

    def __init__(self, path: str, resolve_url, manager,
                 config: PullConfig | None = None, *, seed: int = 0,
                 on_failure=None, events=None,
                 peer_headers: dict | None = None):
        self.path = path
        self.resolve_url = resolve_url        # async () -> str | None
        self.manager = manager                # relay.pull.PullRelayManager
        self.config = config or PullConfig()
        self.on_failure = on_failure
        #: cluster-peer identity headers forwarded to every pull's RTSP
        #: requests (the upstream trace-acceptance gate)
        self.peer_headers = dict(peer_headers or {})
        self._events = events if events is not None else obs.EVENTS
        self.backoff = Backoff(self.config, seed)
        self.breaker = CircuitBreaker(self.config.breaker_failures,
                                      self.config.breaker_open_sec)
        self.retries = 0
        #: the stall ``_monitor`` just returned was injected
        self.stall_injected = False
        self.url: str | None = None
        self._task: asyncio.Task | None = None
        #: the PullRelay THIS envelope last started — teardown compares
        #: identity so it can never retire a replacement registered
        #: under the same path key by a newer envelope
        self._pull = None
        #: consecutive audience-less ticks, maintained by the cluster
        #: service's sweep (declared here so the coupling is visible)
        self.idle_strikes = 0
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(),
                                         name=f"cluster-pull:{self.path}")

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        await self._retire_own_pull()

    async def _retire_own_pull(self) -> None:
        """Stop the manager's pull for this path ONLY when it is the one
        this envelope started — a newer envelope may have registered a
        healthy replacement under the same key."""
        cur = self.manager.pulls.get(self.path)
        if cur is None or cur is not self._pull:
            return
        try:
            await self.manager.stop_pull(self.path)
        except KeyError:
            pass

    @property
    def alive(self) -> bool:
        pull = self.manager.pulls.get(self.path)
        return pull is not None and pull.alive

    @property
    def upstream_chain(self) -> list:
        """The envelope re-owns the relay session, so the freshness
        reader (obs.fleet.freshness_chain) finds the chain through the
        session's owner — delegate to the live pull's polled copy."""
        pull = self._pull
        return getattr(pull, "upstream_chain", None) or []

    # -- the restart loop --------------------------------------------------
    async def _run(self) -> None:
        while not self._stopped:
            if not self.breaker.allow():
                await asyncio.sleep(
                    min(self.config.breaker_open_sec / 4, 1.0))
                continue
            url = None
            try:
                url = await self.resolve_url()
            except Exception:
                pass
            if not url:
                self._failure(url or self.url or "?")
                await asyncio.sleep(self.backoff.next_delay())
                continue
            self.url = url
            try:
                pull = await asyncio.wait_for(
                    self.manager.start_pull(self.path, url, adopt=True,
                                            peer_headers=self.peer_headers),
                    self.config.connect_timeout_sec)
            except Exception:
                self._failure(url)
                await asyncio.sleep(self.backoff.next_delay())
                continue
            self._pull = pull
            # re-own the session: an upstream EOF must degrade, never
            # tear down the local subscribers (PullRelay removes the
            # session only when it is still the owner)
            if pull.session is not None:
                pull.session.owner = self
            stalled = await self._monitor(pull)
            if self._stopped:
                return
            self._failure(url, stalled=stalled)
            await self._retire_own_pull()
            await asyncio.sleep(self.backoff.next_delay())

    async def _monitor(self, pull) -> bool:
        """Watch a live pull; returns True on a read stall (no upstream
        packet growth for ``read_timeout_sec``, or an injected
        ``pull_stall``, which sets ``stall_injected``), False on upstream
        EOF.
        First packet progress closes the breaker and resets backoff."""
        cfg = self.config
        poll = max(min(cfg.read_timeout_sec / 4, 1.0), 0.05)
        last_n = -1
        last_progress = time.monotonic()
        last_fresh = 0.0
        settled = False
        from ..resilience import INJECTOR
        while pull.alive and not self._stopped:
            await asyncio.sleep(poll)
            n = pull.client.stats.packets
            if INJECTOR.active and INJECTOR.pull_stall():
                self.stall_injected = True
                return True
            now_f = time.monotonic()
            if settled and now_f - last_fresh >= self.FRESHNESS_POLL_SEC:
                last_fresh = now_f
                await self._poll_freshness(pull)
            if n != last_n:
                last_n = n
                last_progress = time.monotonic()
                if n > 0 and not settled:
                    settled = True
                    if self.breaker.state != "closed":
                        self._events.emit("cluster.breaker_close",
                                          stream=self.path, url=self.url)
                    self.breaker.success()
                    self.backoff.reset()
            elif time.monotonic() - last_progress >= cfg.read_timeout_sec:
                return True
        return False

    async def _poll_freshness(self, pull) -> None:
        """Fetch the upstream's per-stream freshness chain (RTSP
        GET_PARAMETER ``x-freshness`` on the live pull connection) —
        the hop-stamp transport.  Each answer is the origin's
        chain for this path; the local session appends its own ingest
        stamp on read (obs.fleet.freshness_chain).  Failures are
        silent: freshness is telemetry, never pull health."""
        import json
        try:
            r = await pull.client.request(
                "GET_PARAMETER", self.url or pull.url,
                {"content-type": "text/parameters"},
                b"x-freshness", timeout=2.0)
        except Exception:
            return
        if r.status != 200 or not r.body:
            return
        try:
            chain = json.loads(r.body)
        except ValueError:
            return
        if isinstance(chain, list):
            pull.upstream_chain = [h for h in chain
                                   if isinstance(h, dict)][:8]

    def _failure(self, url: str, *, stalled: bool = False) -> None:
        injected, self.stall_injected = self.stall_injected, False
        self.retries += 1
        obs.CLUSTER_PULL_RETRIES.inc()
        self._events.emit("cluster.pull_retry", level="warn",
                          stream=self.path, url=url,
                          attempt=self.retries, stalled=stalled)
        if self.breaker.failure():
            obs.CLUSTER_PULL_BREAKER_OPEN.inc()
            self._events.emit("cluster.breaker_open", level="warn",
                              stream=self.path, url=url,
                              failures=self.breaker.threshold)
        if self.on_failure is not None:
            try:
                self.on_failure(self.path, injected)
            except Exception:
                pass
