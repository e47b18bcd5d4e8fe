"""Node capacity scoring + live utilization — the control plane's eyes.

A bare hash ring places streams by key, blind to load: a 1-chip
GSO-only node gets the same share as an 8-chip io_uring peer, and the
weakest node melts first.  This module gives placement something to
weigh:

* :func:`self_bench` — a boot-time self-benchmark of the scalar relay
  fan-out path (a real ``RelayStream`` + outputs stepped back-to-back,
  the same capacity semantics as ``bench.py server_engine_rate`` scaled
  down to ~0.1 s), cached per boot.  The score's unit is *relayed
  packets per second*, the same unit the utilization tracker measures —
  so ``util = rate / capacity`` is a dimensionless ratio every node
  computes identically.
* :func:`quantize` — published scores are snapped to powers of two.
  Same-hardware peers land on EQUAL published capacities (the weighted
  ring then reproduces the unweighted one byte-for-byte — no placement
  churn from benchmark noise), while real heterogeneity (1-chip vs
  8-chip, ≥ ~1.5×) lands in different buckets and engages the weights.
* :class:`LoadTracker` — folds the capacity score with the live rates
  the obs stack already computes (every delivered packet observes
  ``relay_ingest_to_wire_seconds``; the SLO watchdog's budget state) into
  the ``{cap, util, burn, subs}`` record each heartbeat publishes into
  the node's fenced ``Node:`` lease.  The ``capacity_spoof`` fault site
  replaces the capacity here — a lying node lies to its OWN admission
  and rebalance decisions too, which is exactly what makes the skewed
  soak deterministic.
"""

from __future__ import annotations

import math
import time

from .. import obs

#: per-boot self-bench cache: the score must be constant for the process
#: lifetime or the published lease records (and therefore every peer's
#: ring) would wobble with scheduler noise
_BOOT: dict[str, float] = {}


def quantize(score: float) -> float:
    """Snap a capacity score to the nearest power of two (in pps).
    Published capacities are quantized so benchmark jitter between
    same-hardware peers cannot produce unequal ring weights."""
    if score <= 0:
        return 0.0
    return float(2 ** round(math.log2(max(score, 1.0))))


def self_bench(seconds: float = 0.12, *, cache: bool = True) -> float:
    """Measured capacity of the scalar relay fan-out path in relayed
    packets/second (raw, unquantized), cached per boot.

    A real ``RelayStream`` with 8 collecting outputs over a 64-packet
    window, bookmarks rewound each pass — the ``server_engine_rate``
    capacity semantics without sockets or device dispatch, cheap enough
    (~0.1 s) to run once at cluster start."""
    if cache and "score" in _BOOT:
        return _BOOT["score"]
    from ..protocol import sdp
    from ..relay.output import CollectingOutput
    from ..relay.stream import RelayStream, StreamSettings

    sdp_txt = ("v=0\r\ns=cap\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    st = RelayStream(sdp.parse(sdp_txt).streams[0],
                     StreamSettings(bucket_delay_ms=0, ring_capacity=256))
    outs = []
    for i in range(8):
        o = CollectingOutput(ssrc=0x10000 + i, out_seq_start=i * 131)
        st.add_output(o)
        outs.append(o)
    pkt = bytes([0x80, 96]) + bytes(10) + bytes(188)
    for i in range(64):
        st.push_rtp(pkt[:2] + i.to_bytes(2, "big") + pkt[4:], 0)
    units = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for o in outs:                  # rewind: same window again
            o.bookmark = st.rtp_ring.tail
            o.rtp_packets.clear()       # score the relay, not list growth
        units += st.reflect(10_000)
    score = units / max(time.perf_counter() - t0, 1e-9)
    if cache:
        _BOOT["score"] = score
    return score


class LoadTracker:
    """Per-node load accounting for the control plane.

    ``sample()`` is called once per cluster heartbeat: it differences the
    delivered-packet count (the ingest→wire histogram observes every
    packet on all three egress paths), EWMA-smooths the rate, and folds
    in the SLO watchdog's live budget state.  The returned record is what
    the lease publishes; ``last_util`` is what the admission gate reads
    synchronously between heartbeats."""

    #: EWMA smoothing factor per sample (heartbeat cadence ~0.5-1 s:
    #: ~3-6 s to settle — fast enough to catch a flash crowd, slow
    #: enough that one bursty wake doesn't flap the admission gate)
    ALPHA = 0.4

    def __init__(self, capacity_pps: float, *, slo=None, subscribers=None,
                 clock=time.monotonic, source=None):
        self.capacity_pps = max(float(capacity_pps), 1.0)
        self._slo = slo                      # SloWatchdog | None
        self._subscribers = subscribers      # () -> int | None
        self._clock = clock
        #: delivered-packet source: () -> cumulative count
        self._source = source if source is not None \
            else obs.RELAY_INGEST_TO_WIRE.total_count
        self._last_t: float | None = None
        self._last_n = 0
        self.rate_pps = 0.0
        self.last_util = 0.0
        self.last_burn = False

    def _effective_capacity(self) -> float:
        """The capacity this node believes in — the ``capacity_spoof``
        fault site replaces it HERE so the lie poisons the published
        record, the utilization ratio, the admission gate and the
        rebalancer coherently (a node that lies about its capacity
        behaves like a node that has it)."""
        from ..resilience import INJECTOR
        if INJECTOR.active:
            spoof = INJECTOR.capacity_spoof()
            if spoof is not None and spoof > 0:
                return float(spoof)
        return self.capacity_pps

    def sample(self) -> dict:
        """One load sample: ``{cap, util, burn, subs}`` (cap quantized —
        the value peers weigh the ring with)."""
        now = self._clock()
        n = int(self._source())
        if self._last_t is not None:
            dt = max(now - self._last_t, 1e-3)
            inst = max(n - self._last_n, 0) / dt
            self.rate_pps += self.ALPHA * (inst - self.rate_pps)
        self._last_t, self._last_n = now, n
        cap = self._effective_capacity()
        self.last_util = self.rate_pps / cap
        burn = False
        if self._slo is not None:
            try:
                st = self._slo.status()
                burn = any(
                    o.get("in_violation")
                    or (isinstance(o.get("budget_remaining"), (int, float))
                        and o["budget_remaining"] <= 0)
                    for o in st.get("objectives", {}).values())
            except Exception:
                burn = False
        self.last_burn = burn
        subs = 0
        if self._subscribers is not None:
            try:
                subs = int(self._subscribers())
            except Exception:
                subs = 0
        pub_cap = quantize(cap)
        obs.CLUSTER_CAPACITY_SCORE.set(pub_cap)
        obs.CLUSTER_UTILIZATION_RATIO.set(round(self.last_util, 6))
        return {"cap": pub_cap, "util": round(self.last_util, 4),
                "burn": burn, "subs": subs}
