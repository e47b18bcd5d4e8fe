"""Session checkpoint / hot-restore — relay state that survives a crash.

Every piece of relay bookkeeping is a plain integer
(absolute ring ids, affine rewrite 5-tuples, RR accounting), exactly so
it could be shipped anywhere — including to disk.  This module
serializes that bookkeeping for every live relay session to
``<log_folder>/ckpt/relay.json`` (atomic tmp+rename, one compact JSON
document) and restores it on startup, so a supervisor-restarted server
resumes live relays **without re-SETUP**:

* **ring cursors** — ``head`` is restored (``tail = head``: the packet
  *bytes* died with the process, but absolute ids keep counting, so
  every bookmark/keyframe invariant survives);
* **subscriber rewrite state** — the affine 5-tuple per output plus the
  sent counters.  The rewrite is a pure function of that state, so the
  first packet after restore carries exactly the seq/ts/ssrc an
  uninterrupted run would have produced — byte-identical, and
  differential-tested that way (``tests/test_torch_resilience.py``,
  against the reference package's document and wire bytes);
* **RR accounting + reporter identity** — upstream receiver reports
  continue on the same extended-seq timeline;
* **keyframe index** — restored as an id; ``ring.valid()`` guards the
  (gone) bytes, so late joiners simply fast-start from the next GOP.

UDP subscribers restore transparently (``kind="udp"``: the shared-
egress address pair is the whole transport — the client never learns
the server died).  Interleaved-TCP subscribers (``kind="tcp"``)
record their channel ids + RTSP session id; their connections died
with the process, so the records PARK on the server and are adopted
when the same player re-attaches (an interleaved SETUP carrying the old
``Session`` id) — same ssrc, framed seq continuing gapless.  Records no
player reclaims within the RTSP timeout are discarded, counted as
``resilience_checkpoint_tcp_orphans_total`` with a ``ckpt.tcp_orphan``
event.  Time-domain fields (arrival clocks,
SR cadence, wall anchors) are deliberately NOT restored — the monotonic
clock restarts with the process, so they re-latch on first use.

The document is the reference package's, key for key, for the same relay
state: the port's outputs and streams carry the reference's field names
(``rewrite``, ``packets_sent``, ``payload_octets``, ``native_addr``,
``rtp_channel``, ``_rr_*``), so the snapshot reads them as they are.

Versioned (``CKPT_VERSION``); a version mismatch or a checkpoint older
than ``max_age_sec`` is ignored (a stale file must not resurrect last
week's sessions).  Families: ``resilience_checkpoint_writes_total``,
``…_bytes_total``, ``…_restores_total``, ``…_errors_total``; events
``ckpt.save`` / ``ckpt.restore``.
"""

from __future__ import annotations

import json
import math
import os
import time

from .. import obs

#: checkpoint document format version; readers reject anything else
CKPT_VERSION = 1
#: file name inside the ``ckpt/`` directory
CKPT_FILE = "relay.json"


# -- snapshot ------------------------------------------------------------
def _snapshot_output(out, bucket_idx: int) -> dict:
    rw = out.rewrite
    if getattr(out, "native_addr", None) is not None:
        kind = "udp"
    elif getattr(out, "interleave_chan", None) is not None:
        kind = "tcp"
    else:
        kind = "opaque"
    rec = {
        "kind": kind,
        "bucket": bucket_idx,
        "rewrite": [rw.ssrc, rw.base_src_seq, rw.base_src_ts,
                    rw.out_seq_start, rw.out_ts_start],
        "packets_sent": out.packets_sent,
        "bytes_sent": out.bytes_sent,
        "payload_octets": out.payload_octets,
    }
    if kind == "udp":
        rec["rtp_addr"] = list(out.native_addr)
        rtcp = getattr(out, "rtcp_addr", None)
        rec["rtcp_addr"] = list(rtcp) if rtcp else None
    elif kind == "tcp":
        # interleaved outputs CAN restore: the rewrite state
        # is set-once ints, so when the same player re-attaches (its
        # old Session id on a fresh interleaved SETUP) the framed seq
        # space continues gapless.  The connection itself died with the
        # process — the record parks until the re-attach or the orphan
        # sweep.
        rec["channels"] = [out.rtp_channel, out.rtcp_channel]
        rec["session_id"] = getattr(out, "session_id", None)
    return rec


def _snapshot_stream(st) -> dict:
    return {
        "track": st.info.track_id,
        "head": st.rtp_ring.head,
        "keyframe_id": st.keyframe_id,
        "reporter_ssrc": st.reporter_ssrc,
        "rr": [st._rr_base_seq if st._rr_base_seq is not None else -1,
               st._rr_max_seq, st._rr_cycles, st._rr_received,
               st._rr_prev_expected, st._rr_prev_received],
        "packets_in": st.stats.packets_in,
        "packets_out": st.stats.packets_out,
        "outputs": [_snapshot_output(o, b)
                    for b, bucket in enumerate(st.buckets)
                    for o in bucket],
    }


def snapshot_session(registry, path: str, *,
                     node_id: str | None = None) -> dict | None:
    """One session's serializable record (the cluster tier publishes
    these per-stream to Redis for migration); None when the session is
    missing or not restorable (no cached SDP).

    Trace lineage: the record carries the stream's trace id
    and the node ids it has lived on (``node_id`` appended when given),
    so an adoption/hot-restore keeps correlating under the SAME trace —
    a stitched multi-hop trace spans the migration instead of breaking
    at it."""
    sess = registry.find(path)
    if sess is None:
        return None
    sdp = registry.sdp_cache.get(sess.path)
    if sdp is None:
        return None
    lineage = list(getattr(sess, "trace_nodes", ()) or ())
    if node_id is None:
        node_id = obs.NODE["id"]
    if node_id and (not lineage or lineage[-1] != node_id):
        lineage.append(str(node_id))
    return {
        "path": sess.path,
        "sdp": sdp,
        "trace": sess.trace_id,
        "trace_nodes": lineage,
        "streams": [_snapshot_stream(st) for st in sess.streams.values()],
    }


def snapshot_registry(registry) -> dict:
    """One serializable document for every live relay session (pure
    reads — safe from the pump's maintenance block)."""
    sessions = [doc for sess in registry.sessions.values()
                if (doc := snapshot_session(registry, sess.path))
                is not None]
    # truncate, never round: round() can stamp up to 0.5 ms in the
    # FUTURE, and a load() inside that window computes a negative age
    # and rejects the checkpoint it just wrote
    return {"version": CKPT_VERSION,
            "saved_wall": math.floor(time.time() * 1000) / 1000.0,
            "sessions": sessions}


# -- restore -------------------------------------------------------------
def _restore_stream(st, rec: dict, output_factory, *, path: str = "",
                    tcp_sink=None) -> int:
    ring = st.rtp_ring
    head = int(rec.get("head", 0))
    # the bytes are gone; the id space continues — every bookmark and
    # eviction invariant holds with an empty [head, head) window
    ring.head = ring.tail = head
    # merging into a LIVE session (cluster migration onto a node that
    # was pull-serving this path): pre-existing subscribers' bookmarks
    # live in the old local id space — one ahead of the restored head
    # would stall silently until new ids caught up.  Resume them at the
    # next ingested packet, exactly like the restored outputs below.
    for out in st.outputs:
        if out.bookmark is not None and out.bookmark > head:
            out.bookmark = head
    kf = rec.get("keyframe_id")
    st.keyframe_id = int(kf) if kf is not None else None
    st.reporter_ssrc = int(rec.get("reporter_ssrc", st.reporter_ssrc))
    rr = rec.get("rr") or [-1, 0, 0, 0, 0, 0]
    st._rr_base_seq = None if rr[0] < 0 else int(rr[0])
    st._rr_max_seq, st._rr_cycles, st._rr_received = \
        int(rr[1]), int(rr[2]), int(rr[3])
    st._rr_prev_expected, st._rr_prev_received = int(rr[4]), int(rr[5])
    st.stats.packets_in = int(rec.get("packets_in", 0))
    st.stats.packets_out = int(rec.get("packets_out", 0))
    restored = 0
    for orec in rec.get("outputs", ()):
        if orec.get("kind") == "tcp":
            # the connection died with the process; park the record for
            # the re-attach path (rtsp SETUP with the old Session id)
            # instead of dropping it
            if tcp_sink is not None:
                tcp_sink(path, rec.get("track"), orec)
            continue
        out = output_factory(orec) if output_factory is not None else None
        if out is None:
            continue
        rw = orec.get("rewrite") or [0, -1, -1, 0, 0]
        out.rewrite.ssrc = int(rw[0])
        out.rewrite.base_src_seq = int(rw[1])
        out.rewrite.base_src_ts = int(rw[2])
        out.rewrite.out_seq_start = int(rw[3])
        out.rewrite.out_ts_start = int(rw[4])
        out.packets_sent = int(orec.get("packets_sent", 0))
        out.bytes_sent = int(orec.get("bytes_sent", 0))
        out.payload_octets = int(orec.get("payload_octets", 0))
        # resume at the next ingested packet: everything earlier either
        # reached the wire before the crash or died with the ring
        out.bookmark = head
        # the recorded bucket index pins the delay-stagger tier the
        # subscriber was serving in (first-fit would repack over holes)
        st.add_output(out, bucket=int(orec.get("bucket", 0)))
        restored += 1
    return restored


def restore_registry(registry, doc: dict, *, output_factory=None,
                     tcp_sink=None) -> tuple[int, int]:
    """Rebuild sessions/streams/outputs from a checkpoint document into
    ``registry``.  ``output_factory(record) -> RelayOutput | None``
    builds the transport for each recorded output (None skips it — the
    default, since only the server knows its egress).
    ``tcp_sink(path, track_id, record)`` receives each ``kind=tcp``
    record — interleaved outputs have no transport until their player
    re-connects, so the server parks them for the SETUP re-attach path.
    Returns ``(sessions, outputs)`` restored (parked TCP records are
    not counted until they re-attach)."""
    n_out = 0
    n_sess = 0
    for srec in doc.get("sessions", ()):
        path, sdp = srec.get("path"), srec.get("sdp")
        if not path or not sdp:
            continue
        try:
            sess = registry.find_or_create(path, sdp)
        except Exception:
            obs.RESILIENCE_CKPT_ERRORS.inc()
            continue
        n_sess += 1
        # trace lineage survives the restore: the stream keeps the trace
        # id it was born with, so spans/events recorded on the previous
        # owner and on this node stitch under ONE id
        trace = srec.get("trace")
        if trace:
            sess.set_trace(str(trace))
            sess.trace_nodes = [str(n) for n in
                                (srec.get("trace_nodes") or ())]
        by_track = {s.get("track"): s for s in srec.get("streams", ())}
        for tid, st in sess.streams.items():
            rec = by_track.get(tid)
            if rec is not None:
                n_out += _restore_stream(st, rec, output_factory,
                                         path=path, tcp_sink=tcp_sink)
    return n_sess, n_out


class CheckpointManager:
    """Periodic writer + startup restorer for one server's relay state."""

    def __init__(self, ckpt_dir: str, *, interval_sec: float = 5.0,
                 max_age_sec: float = 60.0, clock=time.monotonic):
        self.ckpt_dir = ckpt_dir
        self.path = os.path.join(ckpt_dir, CKPT_FILE)
        self.interval_sec = interval_sec
        self.max_age_sec = max_age_sec
        self._clock = clock
        self._last_write: float | None = None  # None = write immediately
        self.writes = 0
        self.restores = 0

    # -- write side -------------------------------------------------------
    def maybe_write(self, registry, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        if (self._last_write is not None
                and now - self._last_write < self.interval_sec):
            return False
        self._last_write = now
        return self.write(registry)

    def write(self, registry) -> bool:
        """Atomic snapshot write; failures count, never raise — a full
        disk must not take the pump down."""
        doc = snapshot_registry(registry)
        blob = json.dumps(doc, separators=(",", ":"))
        try:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(blob)
            os.replace(tmp, self.path)
        except OSError:
            obs.RESILIENCE_CKPT_ERRORS.inc()
            return False
        self.writes += 1
        obs.RESILIENCE_CKPT_WRITES.inc()
        obs.RESILIENCE_CKPT_BYTES.inc(len(blob))
        obs.EVENTS.emit("ckpt.save", level="debug",
                        sessions=len(doc["sessions"]), bytes=len(blob))
        return True

    # -- restore side -----------------------------------------------------
    def load(self) -> dict | None:
        """The checkpoint document, or None when missing, unreadable,
        version-mismatched or older than ``max_age_sec`` (stale files
        must not resurrect long-dead sessions)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("version") != CKPT_VERSION:
            obs.RESILIENCE_CKPT_ERRORS.inc()
            return None
        age = time.time() - float(doc.get("saved_wall", 0))
        # -1 s tolerance: a small NTP step between write and load must
        # not make a just-written checkpoint look future-dated; a file
        # from a genuinely wrong clock is still rejected
        if not -1.0 <= age <= self.max_age_sec:
            return None
        return doc

    def restore(self, registry, *, output_factory=None,
                tcp_sink=None) -> tuple[int, int]:
        """Load + rebuild; returns ``(sessions, outputs)`` restored
        (``(0, 0)`` when there is nothing usable)."""
        doc = self.load()
        if doc is None:
            return (0, 0)
        n_sess, n_out = restore_registry(registry, doc,
                                         output_factory=output_factory,
                                         tcp_sink=tcp_sink)
        if n_sess:
            self.restores += 1
            obs.RESILIENCE_CKPT_RESTORES.inc()
            obs.EVENTS.emit("ckpt.restore", sessions=n_sess,
                            outputs=n_out)
        return n_sess, n_out
