"""DVR manager: the arm / spill / finalize lifecycle and time-shift
serving.

A copy of the reference's ``dvr/service.py``.  Its ``obs`` sites are the
reference's: the ``dvr.arm``, ``dvr.finalize`` and ``dvr.bootstrap``
events and the ``dvr_spill_bytes`` gauge (set after a tick that spilled,
and at finalize).  Errors the reference logs and swallows are counted here
(``finalize_errors``; the server counts a failed spill tick in
``spill_errors``) and their tracebacks go to stderr; a recording still
finalizes.

RECORD (or REST ``startrecord``) arms a ``WindowSpiller`` a stream
writing under ``<root>/<path>/track<id>/``; the pump's wake drives the
spillers (``tick``); stopping, explicitly or by the pusher leaving,
finalizes the asset: ``index.json`` flips ``complete`` and nothing is
re-encoded, so the asset replays at once as ``<path>.dvr``.  A finalized
asset is handed to ``on_finalize`` (the storage tier's store), and
``restorer`` is the spill read chain's last resort (a reconstruct from
erasure shards).

Serving: ``open_timeshift`` builds a ``TimeShiftSession`` over an armed
asset (live pause and rewind) or a finalized one (replay) and hands it
to the shared VOD pacer.

The cluster wire: ``advertise`` names the spilled-window spans of the
armed paths (carried in the node's ``Own:`` records), ``window_blob``
and ``meta_doc`` answer a peer's REST ``dvrwindow`` and ``dvrmeta``, and
``materialize`` writes a peer's ``meta_doc`` as a local skeleton whose
every window read goes to ``fetcher`` (the peer fill); ``meta_sync``
is the ``.dvr`` DESCRIBE's bootstrap of an asset with no local copy.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import traceback

from .. import obs
from ..obs import EVENTS
from ..protocol.sdp import _norm
from ..utils.paths import confined_subpath
from .spill import SpilledTrack, SpillError, SpillWriter, WindowSpiller
from .timeshift import TimeShiftSession, new_counters

#: finalized and armed DVR assets are addressed as ``<live path>.dvr``
DVR_SUFFIX = ".dvr"
#: per-track records of the newest finalized assets ``stats`` keeps
FINALIZED_KEPT = 16


class _Armed:
    __slots__ = ("session", "spillers", "dir", "sdp", "gen")

    def __init__(self, session, spillers, dir_path, sdp, gen):
        self.session = session
        self.spillers = spillers         # track_id -> WindowSpiller
        self.dir = dir_path
        self.sdp = sdp
        self.gen = gen                   # recording generation


class DvrAsset:
    """Read handle over one asset directory: its spilled tracks and
    identity.  ``asset_key`` keys the segment cache's entries; ``close``
    is the pacer's retire hook."""

    def __init__(self, path: str, dir_path: str,
                 tracks: dict[int, SpilledTrack], *, sdp: str = "",
                 complete: bool = False, gen: int = 0):
        self.path = path
        self.dir = dir_path
        self.tracks = tracks
        self.sdp = sdp
        self.complete = complete
        #: the recording generation rides the cache key: a re-armed
        #: path restarts window ids, and the previous asset's windows
        #: still in the LRU must never serve the new one
        self.asset_key = ("dvr", dir_path, int(gen))

    def duration_sec(self) -> float:
        return max((sp.duration_sec() for sp in self.tracks.values()),
                   default=0.0)

    def close(self) -> None:
        for sp in self.tracks.values():
            sp.close()


class DvrManager:
    """Window-spill recorder, on-disk asset tree and time-shift opens."""

    def __init__(self, root: str, cache, pacer, registry, *,
                 window_pkts: int = 64,
                 retention_bytes: int = 64 << 20,
                 retention_sec: float = 300.0):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.cache = cache
        self.pacer = pacer
        self.registry = registry
        self.window_pkts = int(window_pkts)
        self.retention_bytes = int(retention_bytes)
        self.retention_sec = float(retention_sec)
        self._armed: dict[str, _Armed] = {}
        #: peer-fill hook: (path, track_id, win) -> blob | b"" | None
        self.fetcher = None
        #: remote-asset bootstrap hook: ``async (path) -> bool``
        self.meta_sync = None
        #: storage hooks: ``on_finalize(result)`` stores the finished
        #: asset; ``restorer(path, track_id, win) -> blob | b"" | None``
        #: is the spill read chain's last resort
        self.on_finalize = None
        self.restorer = None
        self.finalized_count = 0
        #: spill flushes and ``on_finalize`` calls that raised at a
        #: finalize (the asset still finalized), and failed spill ticks
        #: (counted by the server's pump)
        self.finalize_errors = 0
        self.spill_errors = 0
        #: time-shift counters shared by every session opened here
        self.shift = new_counters()
        self.ticks = 0
        self.spill_ticks = 0
        self.tick_ns = 0
        #: host ns the finalized recordings' spillers spent (the armed
        #: ones are summed live)
        self._done_spill_ns = 0
        #: the newest finalized assets: per track windows, bytes, host
        #: ns; and the finalize's host ms
        self.finalized: list[dict] = []

    # ------------------------------------------------------------ geometry
    def _dir_for(self, path: str) -> str | None:
        return confined_subpath(self.root, _norm(path))

    @staticmethod
    def is_dvr_path(path: str) -> bool:
        return _norm(path).endswith(DVR_SUFFIX)

    @staticmethod
    def live_path_of(path: str) -> str:
        p = _norm(path)
        return p[:-len(DVR_SUFFIX)] if p.endswith(DVR_SUFFIX) else p

    # ----------------------------------------------------------------- arm
    def arm(self, session, sdp_text: str = "") -> bool:
        """Attach spillers to every stream of a live relay session.  A
        second arm of an armed path does nothing; re-arming after a
        finalize starts a fresh asset (each track's spill file is
        truncated and the recording generation goes up)."""
        path = session.path
        if path in self._armed:
            return False
        dir_path = self._dir_for(path)
        if dir_path is None:
            return False
        gen = self._read_gen(dir_path) + 1
        spillers: dict[int, WindowSpiller] = {}
        for tid, stream in session.streams.items():
            w = SpillWriter(
                os.path.join(dir_path, f"track{tid}"), stream.info,
                window_pkts=self.window_pkts,
                retention_bytes=self.retention_bytes,
                retention_sec=self.retention_sec, gen=gen)
            spillers[tid] = WindowSpiller(stream, w)
        self._write_meta(dir_path, path, sdp_text, complete=False,
                         gen=gen)
        self._armed[path] = _Armed(session, spillers, dir_path, sdp_text,
                                   gen)
        EVENTS.emit("dvr.arm", stream=path, trace_id=session.trace_id,
                    path=path, tracks=len(spillers))
        return True

    @staticmethod
    def _read_gen(dir_path: str) -> int:
        try:
            with open(os.path.join(dir_path, "meta.json"),
                      encoding="utf-8") as fh:
                return int(json.load(fh).get("gen", 0))
        except (OSError, ValueError, TypeError):
            return 0

    def _write_meta(self, dir_path: str, path: str, sdp_text: str, *,
                    complete: bool, gen: int) -> None:
        os.makedirs(dir_path, exist_ok=True)
        tmp = os.path.join(dir_path, "meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"path": path, "sdp": sdp_text,
                       "complete": complete, "gen": int(gen)}, fh)
        os.replace(tmp, os.path.join(dir_path, "meta.json"))

    def armed(self, path: str) -> bool:
        return _norm(path) in self._armed

    # ---------------------------------------------------------------- tick
    def tick(self, now_ms: int) -> int:
        """A pump wake: run every armed spiller (an integer compare when
        no window completed) and finalize assets whose session is
        gone."""
        t0 = time.perf_counter_ns()
        spilled = 0
        for path, a in list(self._armed.items()):
            if self.registry.find(path) is not a.session:
                # the pusher left or the session was replaced: the
                # recording ends
                self.finalize(path)
                continue
            for sp in a.spillers.values():
                spilled += sp.tick(now_ms)
        self.ticks += 1
        self.tick_ns += time.perf_counter_ns() - t0
        if spilled:
            self.spill_ticks += 1
            self._update_bytes_gauge()
        return spilled

    def _update_bytes_gauge(self) -> None:
        total = sum(sp.writer.live_bytes
                    for a in self._armed.values()
                    for sp in a.spillers.values())
        obs.DVR_SPILL_BYTES.set(total)

    # ------------------------------------------------------------ finalize
    def _count_error(self) -> None:
        self.finalize_errors += 1
        traceback.print_exc(file=sys.stderr)

    def finalize(self, path: str) -> dict | None:
        """Stop spilling ``path`` and mark its asset complete (servable
        at once).  Every window completed since the last tick is flushed
        first, past the per-wake cap."""
        a = self._armed.pop(_norm(path), None)
        if a is None:
            return None
        t0 = time.perf_counter_ns()
        windows = 0
        tracks = {}
        for tid, sp in a.spillers.items():
            try:
                while sp.tick(1 << 62):
                    pass
            except Exception:
                self._count_error()
            windows += sp.writer.finalize()
            tracks[tid] = {"windows": len(sp.writer.windows),
                           "spilled": sp.spilled, "skipped": sp.skipped,
                           "bytes": sp.writer.live_bytes,
                           "evictions": sp.writer.evictions,
                           "spill_ns": sp.spill_ns}
            self._done_spill_ns += sp.spill_ns
        self._write_meta(a.dir, a.session.path, a.sdp, complete=True,
                         gen=a.gen)
        self.finalized_count += 1
        self._update_bytes_gauge()
        EVENTS.emit("dvr.finalize", stream=a.session.path,
                    trace_id=a.session.trace_id, path=a.session.path,
                    windows=windows)
        result = {"path": a.session.path, "dir": a.dir,
                  "windows": windows}
        if self.on_finalize is not None and windows:
            try:
                self.on_finalize(result)
            except Exception:
                self._count_error()
        self.finalized.append({
            "path": a.session.path, "tracks": tracks,
            "finalize_ms": (time.perf_counter_ns() - t0) / 1e6})
        del self.finalized[:-FINALIZED_KEPT]
        return result

    def close(self) -> None:
        for path in list(self._armed):
            self.finalize(path)

    # ------------------------------------------------------------- serving
    def open_asset(self, path: str) -> DvrAsset | None:
        """Read handle over an armed or finalized asset of ``path`` (the
        live path, with or without the .dvr suffix)."""
        key = self.live_path_of(path)
        dir_path = self._dir_for(key)
        if dir_path is None or not os.path.isdir(dir_path):
            return None
        try:
            with open(os.path.join(dir_path, "meta.json"),
                      encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            meta = {}
        tracks: dict[int, SpilledTrack] = {}
        for name in sorted(os.listdir(dir_path)):
            if not name.startswith("track"):
                continue
            try:
                tid = int(name[5:])
            except ValueError:
                continue
            fetch = None
            if self.fetcher is not None:
                fetch = (lambda win, p=key, t=tid:
                         self.fetcher(p, t, win))
            restore = None
            if self.restorer is not None:
                restore = (lambda win, p=key, t=tid:
                           self.restorer(p, t, win))
            try:
                tracks[tid] = SpilledTrack(
                    os.path.join(dir_path, name), fetch=fetch,
                    restore=restore)
            except SpillError:
                continue
        if not tracks:
            return None
        try:
            gen = int(meta.get("gen", 0))
        except (TypeError, ValueError):
            gen = 0
        return DvrAsset(key, dir_path, tracks,
                        sdp=meta.get("sdp", ""),
                        complete=bool(meta.get("complete")), gen=gen)

    async def describe(self, path: str) -> str | None:
        """The stored push SDP for a ``<path>.dvr`` DESCRIBE (track ids
        match the spilled tracks by construction).  A path with no local
        asset tries the ``meta_sync`` hook once."""
        if not self.is_dvr_path(path):
            return None
        asset = self.open_asset(path)
        if asset is None and self.meta_sync is not None:
            if await self.meta_sync(self.live_path_of(path)):
                asset = self.open_asset(path)
        if asset is None or not asset.sdp:
            return None
        try:
            return asset.sdp
        finally:
            asset.close()

    def open_timeshift(self, path: str, outputs: dict[int, object], *,
                       start_npt: float | None = None,
                       start_ids: dict[int, int] | None = None,
                       speed: float = 1.0,
                       now_ms: int | None = None) -> TimeShiftSession | None:
        """Build and adopt a time-shift session.  On a live path the
        session's streams are the hot tail and the catch-up target; on a
        ``.dvr`` path it is a replay."""
        live_key = self.live_path_of(path)
        asset = self.open_asset(live_key)
        if asset is None:
            return None
        live_session = None
        if not self.is_dvr_path(path):
            live_session = self.registry.find(live_key)
        sess = TimeShiftSession(
            self.pacer, asset, outputs, live_session=live_session,
            start_npt=start_npt, start_ids=start_ids, speed=speed,
            path=live_key, now_ms=now_ms, counters=self.shift)
        self.pacer.adopt(sess)
        return sess

    def window_blob(self, path: str, track_id: int,
                    win: int) -> bytes | None:
        """Raw spill blob of one window: an armed asset's from its live
        writer, a finalized one's from its directory (crc-checked)."""
        key = self.live_path_of(path)
        a = self._armed.get(key)
        if a is not None:
            sp = a.spillers.get(int(track_id))
            if sp is not None:
                rec = next((r for r in sp.writer.windows
                            if r["win"] == int(win)), None)
                if rec is not None:
                    sp.writer._f.flush()
                    with open(sp.writer.bin_path, "rb") as fh:
                        fh.seek(rec["off"])
                        return fh.read(rec["nbytes"])
        asset = self.open_asset(key)
        if asset is None:
            return None
        try:
            sp = asset.tracks.get(int(track_id))
            return sp.window_blob(int(win)) if sp is not None else None
        finally:
            asset.close()

    def meta_doc(self, path: str) -> dict | None:
        """The asset's meta and per-track index documents (what the
        storage tier's manifest carries): an armed asset's from its live
        writers, a finalized one's from its files."""
        key = self.live_path_of(path)
        a = self._armed.get(key)
        if a is not None:
            return {"path": key,
                    "meta": {"path": key, "sdp": a.sdp,
                             "complete": False, "gen": a.gen},
                    "tracks": {str(tid): sp.writer._doc()
                               for tid, sp in a.spillers.items()}}
        dir_path = self._dir_for(key)
        if dir_path is None or not os.path.isdir(dir_path):
            return None
        try:
            with open(os.path.join(dir_path, "meta.json"),
                      encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            return None
        tracks: dict[str, dict] = {}
        for name in sorted(os.listdir(dir_path)):
            if not name.startswith("track"):
                continue
            try:
                with open(os.path.join(dir_path, name, "index.json"),
                          encoding="utf-8") as fh:
                    tracks[name[5:]] = json.load(fh)
            except (OSError, ValueError):
                continue
        if not tracks:
            return None
        return {"path": key, "meta": meta, "tracks": tracks}

    # ------------------------------------------------------- cluster wire
    def materialize(self, path: str, doc: dict) -> bool:
        """Write a peer's ``meta_doc`` as a local asset skeleton: the real
        index records (seek, duration and keyframes work off them) over
        an empty spill file, so every window read misses locally and
        goes to the ``fetcher``.  Refused for an armed path, a path
        outside the root, an asset that is not ``complete`` (a recording
        peer's asset is peer-filled through its ``Own:`` advertisement,
        never frozen here) and a path with a local asset.  Track
        directories without ``meta.json`` (a write torn between the
        tracks and the meta, which is written last) are scrubbed and
        rebuilt; a failed write scrubs what it wrote."""
        key = self.live_path_of(path)
        if key in self._armed:
            return False
        dir_path = self._dir_for(key)
        if dir_path is None:
            return False
        meta = doc.get("meta")
        tracks = doc.get("tracks")
        if not isinstance(meta, dict) or not isinstance(tracks, dict) \
                or not tracks or not meta.get("complete"):
            return False
        if os.path.isdir(dir_path) and any(
                n.startswith("track") for n in os.listdir(dir_path)):
            if os.path.isfile(os.path.join(dir_path, "meta.json")):
                return False            # a local asset: never clobbered
            for n in os.listdir(dir_path):
                if n.startswith("track"):
                    shutil.rmtree(os.path.join(dir_path, n),
                                  ignore_errors=True)
        wrote = 0
        try:
            for tid, idx in tracks.items():
                if not isinstance(idx, dict) or not str(tid).isdigit():
                    continue
                tdir = os.path.join(dir_path, f"track{int(tid)}")
                os.makedirs(tdir, exist_ok=True)
                with open(os.path.join(tdir, "spill.bin"), "wb"):
                    pass                 # empty: every read → fetcher
                tmp = os.path.join(tdir, "index.json.tmp")
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(idx, fh, separators=(",", ":"))
                os.replace(tmp, os.path.join(tdir, "index.json"))
                wrote += 1
            if not wrote:
                return False
            try:
                gen = int(meta.get("gen", 0))
            except (TypeError, ValueError):
                gen = 0
            self._write_meta(dir_path, key, str(meta.get("sdp", "")),
                             complete=True, gen=gen)
        except OSError:
            for tid in tracks:
                if str(tid).isdigit():
                    shutil.rmtree(
                        os.path.join(dir_path, f"track{int(tid)}"),
                        ignore_errors=True)
            try:
                os.unlink(os.path.join(dir_path, "meta.json"))
            except OSError:
                pass
            return False
        EVENTS.emit("dvr.bootstrap", stream=key, path=key, tracks=wrote)
        return True

    def advertise(self) -> dict:
        """The spilled-window span ``[first, last]`` of each track of each
        armed path, folded into this node's fenced ``Own:`` records (a
        finalized asset's advertisement ends with its record's TTL;
        ``window_blob`` still serves it to a peer that asks)."""
        out: dict[str, dict] = {}
        for path, a in self._armed.items():
            spans = {}
            for tid, sp in a.spillers.items():
                if sp.writer.windows:
                    spans[str(tid)] = [sp.writer.windows[0]["win"],
                                       sp.writer.windows[-1]["win"]]
            if spans:
                out[path] = spans
        return out

    # ---------------------------------------------------------------- misc
    def stats(self) -> dict:
        live = [sp for a in self._armed.values()
                for sp in a.spillers.values()]
        return {
            "armed": len(self._armed),
            "finalized": self.finalized_count,
            "spilled_windows": sum(sp.spilled for sp in live),
            "spill_bytes": sum(sp.writer.live_bytes for sp in live),
            "evictions": sum(sp.writer.evictions for sp in live),
            "finalize_errors": self.finalize_errors,
            "spill_errors": self.spill_errors,
            "ticks": self.ticks,
            "spill_ticks": self.spill_ticks,
            "tick_ms_per_tick": self.tick_ns / max(self.ticks, 1) / 1e6,
            "spill_ms_per_spill_tick": (
                (self._done_spill_ns + sum(sp.spill_ns for sp in live))
                / max(self.spill_ticks, 1) / 1e6),
            **self.shift,
            "finalized_assets": list(self.finalized),
        }


__all__ = ["DvrManager", "DvrAsset", "DVR_SUFFIX"]
